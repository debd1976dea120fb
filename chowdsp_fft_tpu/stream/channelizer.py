"""Polyphase FFT channelizer (critically sampled analysis filter bank).

SDR-chain stage (BASELINE.json config 5). Splits a wideband stream into C
uniformly spaced baseband channels, each decimated by C:

  1. commutate the stream into C polyphase branches;
  2. FIR each branch with the matching polyphase component of a prototype
     low-pass (one grouped XLA convolution over branches/channels);
  3. DFT across the branch axis per output step — this uses the
     framework's own complex FFT engine over a batch of T/C vectors,
     the "many small batched FFTs" shape.

No reference counterpart (chowdsp_fft stops at the transform layer); this
is the capability the BASELINE north star adds on top.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .. import api
from .polyphase import design_lowpass

__all__ = ["Channelizer", "channelize"]


class Channelizer:
    """C-channel critically-sampled polyphase channelizer.

    Args:
      channels: number of channels C (must be a supported FFT size).
      taps_per_branch: prototype filter length is C * taps_per_branch.
      engine: FFT engine selector passed through to the api layer.
    """

    def __init__(self, channels: int, taps_per_branch: int = 8, engine: str = "auto"):
        if not api.is_valid_size(channels, api.FFT_COMPLEX):
            raise api.InvalidSizeError(f"channel count {channels} unsupported")
        self.channels = channels
        self.taps_per_branch = taps_per_branch
        self.engine = engine
        proto = design_lowpass(channels * taps_per_branch, 1.0 / channels)
        self.proto = proto  # (C * K,) prototype low-pass
        # Polyphase components: branch p gets proto[p::C], newest-first.
        self.hpoly = jnp.flip(
            proto.reshape(taps_per_branch, channels).T, axis=-1
        )  # (C, K)
        self.plan = api.cached_plan(channels, api.FFT_COMPLEX)

    def __call__(self, x: jax.Array) -> jax.Array:
        """(..., T) real or complex wideband -> (..., C, T//C) complex
        channel streams (channel c centered at f = c/C of the input rate)."""
        c, k = self.channels, self.taps_per_branch
        t = x.shape[-1]
        steps = t // c
        x = x[..., : steps * c]
        batch_shape = x.shape[:-1]

        # Branch p at step m sees x[m*C + (C-1-p) - k'*C]: commutator runs
        # backwards through each block. Build (steps, C) frames then FIR
        # along steps with the (C, K) polyphase taps.
        frames = x.reshape(*batch_shape, steps, c)
        branches = jnp.flip(frames, axis=-1)  # (..., steps, C)
        branches = jnp.moveaxis(branches, -1, -2)  # (..., C, steps)

        def fir_branches(real_part):
            xb = real_part.reshape(-1, c, steps)
            # hpoly is already stored newest-first (flipped once at
            # construction): conv_general_dilated computes a CORRELATION,
            # so the effective branch filter is rhs reversed — exactly
            # proto[j*C + p] as the filter bank requires. (A second flip
            # here delay-reversed every branch; caught by the differential
            # polyphase test.)
            rhs = self.hpoly.reshape(c, 1, k)
            # One grouped conv: each branch with its own taps. HIGHEST
            # precision keeps it float32: a GPU may otherwise run fp32
            # convolutions in TF32 (about three decimal digits).
            out = jax.lax.conv_general_dilated(
                xb,
                rhs,
                window_strides=(1,),
                padding=[(k - 1, 0)],
                dimension_numbers=("NCH", "OIH", "NCH"),
                feature_group_count=c,
                preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.HIGHEST,
            )
            return out.reshape(*batch_shape, c, steps)

        if jnp.iscomplexobj(x):
            filt = jax.lax.complex(
                fir_branches(jnp.real(branches).astype(jnp.float32)),
                fir_branches(jnp.imag(branches).astype(jnp.float32)),
            )
        else:
            filt = fir_branches(branches.astype(jnp.float32))

        # DFT across the branch axis for every step: batch = (..., steps).
        v = jnp.moveaxis(filt, -2, -1)  # (..., steps, C)
        spec = api.ifft(v.astype(jnp.complex64), plan=self.plan, engine=self.engine)
        # ifft here is the unscaled backward transform (synthesis phase
        # rotation convention); 1/C normalizes channel gain.
        spec = spec * (1.0 / c)
        return jnp.moveaxis(spec, -1, -2)  # (..., C, steps)


def channelize(x: jax.Array, channels: int, taps_per_branch: int = 8, engine: str = "auto") -> jax.Array:
    return Channelizer(channels, taps_per_branch, engine=engine)(x)
