"""The ``xla`` transform engine: ``jnp.fft`` left to XLA.

XLA lowers its FFT op to the vendor library of the backend it compiles
for: cuFFT on an NVIDIA GPU, ducc on the CPU. This engine adapts that op
to the library's contract and adds nothing else:

- **Unscaled both ways.** ``backward(forward(x)) == N * x``
  (reference chowdsp_fft.h:128). The complex backward transform is
  ``conj(fft(conj(x)))``: XLA's inverse FFT applies 1/N as a library
  scaling pass (cuBLAS on the GPU) that nothing can fuse, and undoing it
  costs a ×N pass; the two conjugations are elementwise and fuse into
  the neighbouring operations of a chain. The real backward transform
  has no such identity and uses ``irfft`` with ``norm="forward"``.
- **Unordered means ordered.** The output is in natural bin order, which
  is a legal choice of engine-private layout (api.py's adapters serve
  the ``*_unordered`` and packed-plane entries from these three
  transforms).
- **Gradients** come from JAX's own transpose rules for the FFT op.
- **No plan tables.** The plan is checked for its length and kind only;
  the twiddle tables it carries serve the Stockham engine.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..plans import FFT_COMPLEX, FFT_FORWARD, FFT_REAL, FFTPlan

__all__ = ["cfft", "rfft", "irfft"]


def _check(plan: FFTPlan | None, kind: str, n: int) -> None:
    if plan is not None and (plan.kind != kind or plan.n != n):
        raise ValueError(f"plan mismatch: plan=({plan.kind}, {plan.n}), input ({kind}, {n})")


def cfft(x: jax.Array, plan: FFTPlan | None = None, direction: str = FFT_FORWARD) -> jax.Array:
    """Complex FFT over the last axis, unscaled in both directions."""
    _check(plan, FFT_COMPLEX, x.shape[-1])
    x = jnp.asarray(x).astype(jnp.complex64)
    if direction == FFT_FORWARD:
        return jnp.fft.fft(x, axis=-1)
    return jnp.conj(jnp.fft.fft(jnp.conj(x), axis=-1))


def rfft(x: jax.Array, plan: FFTPlan | None = None) -> jax.Array:
    """Real forward FFT -> canonical (..., N//2+1) complex64 spectrum."""
    _check(plan, FFT_REAL, x.shape[-1])
    return jnp.fft.rfft(jnp.asarray(x).astype(jnp.float32), axis=-1)


def irfft(spec: jax.Array, plan: FFTPlan | None = None) -> jax.Array:
    """Unscaled real backward FFT: irfft(rfft(x)) == N * x -> (..., N) f32."""
    n = 2 * (spec.shape[-1] - 1)
    _check(plan, FFT_REAL, n)
    spec = jnp.asarray(spec).astype(jnp.complex64)
    return jnp.fft.irfft(spec, n=n, axis=-1, norm="forward").astype(jnp.float32)
