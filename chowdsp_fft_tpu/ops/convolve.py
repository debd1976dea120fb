"""Frequency-domain convolution helpers.

Equivalents of the reference's convolution primitives:
- ``convolve_accumulate`` <-> ``fft_convolve_unordered`` /
  ``pffft_convolve_internal`` (/root/reference/chowdsp_fft.cpp:398-432,
  simd/chowdsp_fft_impl_sse.cpp:1603-1645): ab += a * b * scaling on
  frequency-domain data.
- ``accumulate`` <-> ``fft_accumulate`` / ``fft_accumulate_internal``
  (/root/reference/chowdsp_fft.cpp:434-452, sse:1647-1660): ab = a + b.

Because this framework's spectra are canonical complex arrays (DC and
Nyquist are their own bins), no scalar patch-up of a packed DC/Nyquist
element is needed — the reference needs one because pffft's real layout
packs Nyquist into the DC slot (sse:1640-1644). The ops are plain
elementwise math: under jit XLA fuses them into neighboring kernels, which
is the analog of the reference's hand-unrolled SIMD loops.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = [
    "convolve_accumulate",
    "convolve_accumulate_packed",
    "multiply_spectra",
    "accumulate",
]


def convolve_accumulate_packed(
    a: tuple[jax.Array, jax.Array],
    b: tuple[jax.Array, jax.Array],
    ab: tuple[jax.Array, jax.Array] | None = None,
    scaling: float | jax.Array = 1.0,
) -> tuple[jax.Array, jax.Array]:
    """``ab += a * b * scaling`` on packed SoA real-spectrum planes.

    Bin 0 packs two purely-real bins (DC in re[0], Nyquist in im[0]), so
    the complex product there degenerates to two real products — the exact
    packed-layout patch-up the reference does scalar-wise at
    /root/reference/simd/chowdsp_fft_impl_sse.cpp:1640-1644. Works in
    either ordered or engine-internal bin order (bin 0 is index 0 in both),
    which is what makes the unordered fast-convolution chain
    (rfft_packed_unordered -> this -> irfft_packed_unordered) legal."""
    a_re, a_im = a
    b_re, b_im = b
    pr = a_re * b_re - a_im * b_im
    pi = a_re * b_im + a_im * b_re
    col = jax.lax.broadcasted_iota(jnp.int32, pr.shape, pr.ndim - 1)
    pr = jnp.where(col == 0, a_re * b_re, pr)  # DC * DC
    pi = jnp.where(col == 0, a_im * b_im, pi)  # Nyq * Nyq
    # Only skip the multiply for static Python scalars: `scaling != 1.0`
    # on a traced jax.Array raises TracerBoolConversionError.
    if not (isinstance(scaling, (int, float)) and scaling == 1.0):
        s = jnp.asarray(scaling, jnp.float32)
        pr, pi = pr * s, pi * s
    if ab is None:
        return pr, pi
    return ab[0] + pr, ab[1] + pi


def convolve_accumulate(
    a: jax.Array,
    b: jax.Array,
    ab: jax.Array | None = None,
    scaling: float | jax.Array = 1.0,
) -> jax.Array:
    """Return ``ab + a * b * scaling`` over frequency-domain arrays.

    ``a``/``b`` are spectra from a forward transform (ordered or unordered —
    the op is order-independent, which is exactly why the reference pairs it
    with its unordered transforms, /root/reference/chowdsp_fft.h:140-154).
    ``ab=None`` means accumulate into zero (plain scaled product). The
    functional return replaces the reference's in-place += (aliasing
    pointers); under jit XLA buffer-donates this to the same thing.
    """
    prod = a * b
    if not (isinstance(scaling, (int, float)) and scaling == 1.0):
        prod = prod * jnp.asarray(scaling, dtype=prod.dtype if not jnp.iscomplexobj(prod) else jnp.float32)
    if ab is None:
        return prod
    return ab + prod


def multiply_spectra(a: jax.Array, b: jax.Array, scaling: float | jax.Array = 1.0) -> jax.Array:
    """Scaled spectral product (convolve_accumulate with zero accumulator)."""
    return convolve_accumulate(a, b, ab=None, scaling=scaling)


def accumulate(a: jax.Array, b: jax.Array) -> jax.Array:
    """Elementwise sum of two signals (``fft_accumulate``,
    /root/reference/chowdsp_fft.h:156-160). The reference restricts N to a
    multiple of the SIMD width (sse:1647-1660); no such restriction exists
    here — XLA handles any shape."""
    return a + b
