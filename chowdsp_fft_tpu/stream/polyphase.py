"""Polyphase FIR decimation / interpolation.

Part of the streaming SDR chain (BASELINE.json configs 3-5). The reference
library has no resampler — this is new surface area around the FFT core.
Each output sample is a dot product of tap phases, expressed below through
`lax.conv_general_dilated` (cuDNN on a GPU).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["polyphase_decimate", "polyphase_interpolate", "design_lowpass"]


def design_lowpass(taps: int, cutoff: float, window: str = "hamming") -> jnp.ndarray:
    """Windowed-sinc low-pass FIR design (cutoff in normalized Nyquist
    units, 0..1). Minimal, dependency-free equivalent of
    scipy.signal.firwin for the chain's internal filters."""
    import numpy as np

    n = np.arange(taps, dtype=np.float64) - (taps - 1) / 2.0
    h = np.sinc(cutoff * n) * cutoff
    if window == "hamming":
        w = 0.54 - 0.46 * np.cos(2 * np.pi * np.arange(taps) / (taps - 1))
    elif window == "blackman":
        w = (
            0.42
            - 0.5 * np.cos(2 * np.pi * np.arange(taps) / (taps - 1))
            + 0.08 * np.cos(4 * np.pi * np.arange(taps) / (taps - 1))
        )
    else:
        w = np.ones(taps)
    h = h * w
    h = h / h.sum()
    return jnp.asarray(h, jnp.float32)


def _conv_valid(x: jax.Array, h: jax.Array, stride: int) -> jax.Array:
    """Strided valid convolution of (B, T) with (taps,) -> (B, T_out).

    precision=HIGHEST keeps the convolution float32: a GPU may otherwise
    run fp32 convolutions in TF32 (about three decimal digits), far outside
    this library's 2e-7*N bound.
    """
    lhs = x[:, None, :]  # (B, C=1, T)
    rhs = jnp.flip(h, -1)[None, None, :]  # (O=1, I=1, taps) conv kernel
    out = jax.lax.conv_general_dilated(
        lhs,
        rhs,
        window_strides=(stride,),
        padding="VALID",
        dimension_numbers=("NCH", "OIH", "NCH"),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    return out[:, 0, :]


def polyphase_decimate(
    x: jax.Array, h: jax.Array, factor: int, block: int = 4096
) -> jax.Array:
    """Decimate (..., T) by `factor` after FIR anti-alias filtering.

    Equivalent to scipy.signal.upfirdn(h, x, 1, factor) restricted to the
    first T//factor full-history outputs (zero-padded warmup at the left
    edge, matching lfilter-then-downsample semantics).

    Long streams are internally framed into overlapped `block`-sample rows
    (gather-free, stream/ols framing) so the convolution runs with a large
    batch dimension instead of as one (1, 1, T) row.
    """
    from .ols import _frame_overlap  # local import: avoid a module cycle

    x = jnp.asarray(x, jnp.float32)
    h = jnp.asarray(h, jnp.float32)
    taps = h.shape[-1]
    batch_shape = x.shape[:-1]
    t = x.shape[-1]
    xb = x.reshape(-1, t)
    b = xb.shape[0]
    if t <= 2 * block:
        xb = jnp.pad(xb, ((0, 0), (taps - 1, 0)))  # zero initial state
        y = _conv_valid(xb, h, stride=factor)[..., : t // factor]
        return y.reshape(*batch_shape, -1)
    blk = block - block % factor  # frame starts stay phase-aligned
    frames = _frame_overlap(xb, blk, taps - 1)  # (B, nb, taps-1+blk)
    nb = frames.shape[-2]
    y = _conv_valid(frames.reshape(b * nb, -1), h, stride=factor)
    y = y.reshape(b, nb * (blk // factor))[..., : t // factor]
    return y.reshape(*batch_shape, -1)


def _interp_rows(xb: jax.Array, h: jax.Array, factor: int) -> jax.Array:
    """Zero-state interpolation of (B, L) rows -> (B, L*factor):
    y[n] = factor * sum_k h[k] * u[n-k] with u the zero-stuffed rows."""
    taps = h.shape[-1]
    l = xb.shape[-1]
    lhs = xb[:, None, :]
    rhs = jnp.flip(h, -1)[None, None, :] * factor
    out = jax.lax.conv_general_dilated(
        lhs,
        rhs,
        window_strides=(1,),
        padding=[(taps - 1, taps - 1 + factor - 1)],
        lhs_dilation=(factor,),
        dimension_numbers=("NCH", "OIH", "NCH"),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    return out[:, 0, : l * factor]


def polyphase_interpolate(
    x: jax.Array, h: jax.Array, factor: int, block: int = 4096
) -> jax.Array:
    """Upsample (..., T) by `factor` (zero-stuff + FIR). Output gain
    `factor` is applied so passband amplitude is preserved.

    Zero-state alignment: y[n] = factor * sum_k h[k] * u[n-k], matching
    scipy.signal.upfirdn(h*factor, x, factor, 1)[:T*factor] — the mirror
    convention of :func:`polyphase_decimate`, so interpolate(f) followed
    by decimate(f) round-trips without a time shift. Long streams are
    framed into overlapped rows (see polyphase_decimate).
    """
    x = jnp.asarray(x, jnp.float32)
    h = jnp.asarray(h, jnp.float32)
    taps = h.shape[-1]
    batch_shape = x.shape[:-1]
    t = x.shape[-1]
    xb = x.reshape(-1, t)
    b = xb.shape[0]
    if t <= 2 * block:
        y = _interp_rows(xb, h, factor)
        return y.reshape(*batch_shape, -1)
    from .ols import _frame_overlap  # local import: avoid a module cycle

    halo = -(-(taps - 1) // factor)  # input samples of real left context
    frames = _frame_overlap(xb, block, halo)  # (B, nb, halo + block)
    nb = frames.shape[-2]
    y = _interp_rows(frames.reshape(b * nb, halo + block), h, factor)
    # Drop the halo's outputs: frame i's output j maps to global
    # i*block*factor + j - halo*factor.
    y = y.reshape(b, nb, (halo + block) * factor)[..., halo * factor :]
    y = y.reshape(b, nb * block * factor)[..., : t * factor]
    return y.reshape(*batch_shape, -1)
