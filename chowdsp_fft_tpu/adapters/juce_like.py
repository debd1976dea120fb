"""juce::dsp::FFT-style adapter.

Functional re-creation of the reference's JUCE engine adapter
(/root/reference/chowdsp_fft_juce/chowdsp_fft_juce.cpp): power-of-two
order, complex `perform` with 1/N scaling on the inverse (:44-45), and the
real-only transforms with JUCE's (N/2+1)-complex-in-N+2-floats layout,
including the DC/Nyquist fix-ups the reference does when converting
between pffft packing and JUCE packing (:48-86).

Like the original (order >= 5 check at :18-30), sizes below 2^5 are
delegated — here to the Stockham engine, which handles anything.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .. import api
from ..ops import layout

__all__ = ["JuceStyleFFT"]


class JuceStyleFFT:
    """Drop-in behavioral match for juce::dsp::FFT backed by this
    framework's engines. All methods are jit-friendly and batched over
    leading axes."""

    PRIORITY = 7  # the reference registers itself at priority 7 (:16)

    def __init__(self, order: int, engine: str = "auto"):
        if order < 0:
            raise ValueError("order must be >= 0")
        self.order = order
        self.size = 1 << order
        self.engine = engine
        # Self-jit the transform methods: callers use this adapter eagerly
        # (JUCE style), and op-by-op dispatch of the complex ops costs one
        # launch each. jit also caches per input shape, like the reference
        # adapter's persistent setups (:97-110).
        import jax as _jax

        self.perform = _jax.jit(self.perform, static_argnames=("inverse",))
        self.perform_real_only_forward_transform = _jax.jit(
            self.perform_real_only_forward_transform
        )
        self.perform_real_only_inverse_transform = _jax.jit(
            self.perform_real_only_inverse_transform
        )
        self.perform_frequency_only_forward_transform = _jax.jit(
            self.perform_frequency_only_forward_transform
        )

    def get_size(self) -> int:
        return self.size

    # -- complex ---------------------------------------------------------

    def perform(self, z: jax.Array, inverse: bool = False) -> jax.Array:
        """(..., size) complex -> (..., size) complex. Inverse applies
        1/size scaling (JUCE convention; the reference multiplies by
        1/2^order after the unscaled backward transform, :44-45)."""
        z = jnp.asarray(z, jnp.complex64)
        if inverse:
            return api.ifft(z, engine=self.engine) * (1.0 / self.size)
        return api.fft(z, engine=self.engine)

    # -- real ------------------------------------------------------------

    def perform_real_only_forward_transform(self, x: jax.Array) -> jax.Array:
        """(..., size) float -> (..., size + 2) floats holding size/2 + 1
        interleaved complex bins (JUCE real layout; the reference builds it
        by unpacking pffft's packed Nyquist, :58-61)."""
        spec = api.rfft(jnp.asarray(x, jnp.float32), engine=self.engine)
        return layout.interleave_complex(spec)

    def perform_real_only_inverse_transform(self, buf: jax.Array) -> jax.Array:
        """(..., size + 2) floats (JUCE layout) -> (..., size) float with
        1/size scaling, mirroring :63-86."""
        spec = layout.deinterleave_complex(jnp.asarray(buf, jnp.float32))
        out = api.irfft(spec, engine=self.engine)
        return out * (1.0 / self.size)

    def perform_frequency_only_forward_transform(self, x: jax.Array) -> jax.Array:
        """Magnitude spectrum, zero-padded to size floats (JUCE's
        performFrequencyOnlyForwardTransform semantics)."""
        spec = api.rfft(jnp.asarray(x, jnp.float32), engine=self.engine)
        mags = jnp.abs(spec)
        pad = self.size - mags.shape[-1]
        if pad > 0:
            mags = jnp.pad(mags, [(0, 0)] * (mags.ndim - 1) + [(0, pad)])
        return mags.astype(jnp.float32)
