"""Short-time Fourier transform / inverse (spectral analysis-synthesis).

Natural surface for an FFT framework (the reference stops at single
transforms; its users build exactly this on top). Construction:

- frames come from the gather-free slice+concat framing (ols._frame_overlap
  family) — never an XLA gather;
- the batched frame FFT is one api rfft over (frames, n_fft);
- synthesis uses weighted overlap-add with the COLA normalization computed
  host-side; the overlap-add scatter is expressed as two aligned
  adds of reshaped halves (for the standard hop = n_fft/2 case) or a
  strided pad+add tree, all layout-friendly.

Conventions: scaled like scipy.signal.stft with boundary=None,
padded=False is NOT matched exactly — this module keeps the framework's
unscaled-transform convention: ``istft(stft(x)) == x`` (the 1/N and
window normalization are folded into synthesis).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from .. import api
from .ols import _frame_overlap

__all__ = ["hann_window", "stft", "istft", "spectrogram"]


def hann_window(n: int) -> np.ndarray:
    """Periodic Hann window (COLA at hop = n/2, n/4, ...). Returned as a
    host-side numpy array: istft folds the window into a host-computed
    COLA normalization table, so windows must be trace-time constants."""
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)).astype(np.float32)


def stft(
    x: jax.Array,
    n_fft: int = 1024,
    hop: int | None = None,
    window: jax.Array | None = None,
    engine: str = "auto",
) -> jax.Array:
    """(..., T) real -> (..., frames, n_fft//2+1) complex spectra.

    Frame f covers x[f*hop : f*hop + n_fft] (left/right zero padding of
    n_fft - hop so every sample appears in the same number of frames).
    """
    hop = hop or n_fft // 2
    if n_fft % hop:
        raise ValueError("hop must divide n_fft")
    # stft only multiplies by the window, so traced (jit-argument) windows
    # are fine here; istft needs a host-side constant for its COLA table.
    window = jnp.asarray(hann_window(n_fft) if window is None else window, jnp.float32)
    x = jnp.asarray(x, jnp.float32)
    pad = n_fft - hop
    # Right-pad so every input sample (including the tail) appears in
    # exactly n_fft/hop frames; _frame_overlap's own `overlap` left pad is
    # the matching left boundary. Frame f then covers
    # x[f*hop - pad : f*hop - pad + n_fft] (zeros outside).
    xp = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, pad)])
    frames = _frame_overlap(xp, hop, pad) * window
    plan = api.cached_plan(n_fft, api.FFT_REAL)
    return api.rfft(frames, plan=plan, engine=engine)


def istft(
    spec: jax.Array,
    hop: int | None = None,
    window: jax.Array | None = None,
    length: int | None = None,
    engine: str = "auto",
) -> jax.Array:
    """Inverse of :func:`stft` (weighted overlap-add, COLA-normalized)."""
    n_fft = 2 * (spec.shape[-1] - 1)
    hop = hop or n_fft // 2
    if n_fft % hop:
        raise ValueError("hop must divide n_fft")
    # Window must be a host-side constant: the COLA normalization table is
    # computed in numpy at trace time.
    window = hann_window(n_fft) if window is None else np.asarray(window, np.float32)
    plan = api.cached_plan(n_fft, api.FFT_REAL)
    frames = api.irfft(spec, plan=plan, engine=engine) * (1.0 / n_fft)
    frames = frames * jnp.asarray(window)  # weighted OLA (window applied twice)

    nf = frames.shape[-2]
    k = n_fft // hop
    t_pad = (nf - 1) * hop + n_fft
    # Overlap-add as k aligned dense adds: split each frame into k hop-size
    # chunks; chunk j of frame f lands at offset (f + j) * hop.
    chunks = frames.reshape(*frames.shape[:-1], k, hop)
    out = jnp.zeros((*frames.shape[:-2], t_pad), jnp.float32)
    for j in range(k):
        part = chunks[..., :, j, :].reshape(*frames.shape[:-2], nf * hop)
        out = out.at[..., j * hop : j * hop + nf * hop].add(part)

    # COLA normalization: sum of squared windows at each output phase.
    w2 = np.asarray(window, np.float64) ** 2
    cola = np.zeros(hop, np.float64)
    for j in range(k):
        cola += w2[j * hop : (j + 1) * hop]
    if cola.min() <= 1e-12:
        raise ValueError("window does not satisfy COLA at this hop")
    norm = jnp.asarray(np.tile(1.0 / cola, t_pad // hop), jnp.float32)
    out = out * norm

    pad = n_fft - hop
    out = out[..., pad : t_pad - pad]
    if length is not None:
        out = out[..., :length]
    return out


def spectrogram(
    x: jax.Array, n_fft: int = 1024, hop: int | None = None, engine: str = "auto"
) -> jax.Array:
    """Power spectrogram |STFT|^2 -> (..., frames, n_fft//2+1) float32."""
    s = stft(x, n_fft=n_fft, hop=hop, engine=engine)
    return (jnp.real(s) ** 2 + jnp.imag(s) ** 2).astype(jnp.float32)
