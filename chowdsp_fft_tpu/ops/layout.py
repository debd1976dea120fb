"""Spectrum layout converters.

This framework's canonical real-transform spectrum is numpy-style:
N//2 + 1 complex bins (DC and Nyquist are separate, purely-real bins).
The reference instead emits N packed floats with the Nyquist real part
stored in slot 1 next to DC (pffft layout; the JUCE adapter's unpacking at
/root/reference/chowdsp_fft_juce/chowdsp_fft_juce.cpp:48-86 documents it).
These converters exist for (a) bit-level differential tests against
reference-generated vectors and (b) users migrating buffers from the C
library.

Complex-transform spectra: the reference interleaves re/im floats
(/root/reference/chowdsp_fft.h:124-127); here they are complex64 arrays.
``interleave``/``deinterleave`` convert.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = [
    "to_packed_real_spectrum",
    "from_packed_real_spectrum",
    "spectrum_to_packed_planes",
    "packed_planes_to_spectrum",
    "interleave_complex",
    "deinterleave_complex",
]


def spectrum_to_packed_planes(spec: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Canonical (..., N//2+1) complex spectrum -> SoA packed planes
    ((..., N/2) f32 re, (..., N/2) f32 im) with Nyquist stored in im[0].

    This is the plane-separated rendition of the pffft packed layout (the
    interleaved original is :func:`to_packed_real_spectrum`); it is the
    format of :func:`chowdsp_fft_tpu.rfft_packed`."""
    re = spec[..., :-1].real.astype(jnp.float32)
    nyq = spec[..., -1:].real.astype(jnp.float32)
    im = jnp.concatenate([nyq, spec[..., 1:-1].imag.astype(jnp.float32)], axis=-1)
    return re, im


def packed_planes_to_spectrum(re: jax.Array, im: jax.Array) -> jax.Array:
    """Inverse of :func:`spectrum_to_packed_planes`."""
    nyq = im[..., :1]
    zeros = jnp.zeros_like(nyq)
    main = jax.lax.complex(re, jnp.concatenate([zeros, im[..., 1:]], axis=-1))
    return jnp.concatenate([main, jax.lax.complex(nyq, zeros)], axis=-1).astype(jnp.complex64)


def to_packed_real_spectrum(spec: jax.Array) -> jax.Array:
    """Canonical (..., N//2+1) complex spectrum -> pffft-style packed
    (..., N) float32: [DC, Nyquist, re1, im1, re2, im2, ...]."""
    n = 2 * (spec.shape[-1] - 1)
    dc = spec[..., :1].real
    nyq = spec[..., -1:].real
    mids = spec[..., 1:-1]  # bins 1 .. N/2-1
    inter = jnp.stack([mids.real, mids.imag], axis=-1).reshape(*spec.shape[:-1], n - 2)
    return jnp.concatenate([dc, nyq, inter], axis=-1).astype(jnp.float32)


def from_packed_real_spectrum(packed: jax.Array) -> jax.Array:
    """Inverse of :func:`to_packed_real_spectrum`."""
    n = packed.shape[-1]
    dc = packed[..., 0:1]
    nyq = packed[..., 1:2]
    mids = packed[..., 2:].reshape(*packed.shape[:-1], n // 2 - 1, 2)
    zeros = jnp.zeros_like(dc)
    main = jnp.concatenate(
        [
            jax.lax.complex(dc, zeros),
            jax.lax.complex(mids[..., 0], mids[..., 1]),
            jax.lax.complex(nyq, zeros),
        ],
        axis=-1,
    )
    return main.astype(jnp.complex64)


def interleave_complex(z: jax.Array) -> jax.Array:
    """(..., N) complex -> (..., 2N) float32 interleaved re/im (the
    reference's in-memory complex format, /root/reference/chowdsp_fft.h:124-127)."""
    out = jnp.stack([z.real, z.imag], axis=-1)
    return out.reshape(*z.shape[:-1], 2 * z.shape[-1]).astype(jnp.float32)


def deinterleave_complex(x: jax.Array) -> jax.Array:
    """(..., 2N) float32 interleaved -> (..., N) complex64."""
    v = x.reshape(*x.shape[:-1], x.shape[-1] // 2, 2)
    return jax.lax.complex(v[..., 0], v[..., 1]).astype(jnp.complex64)
