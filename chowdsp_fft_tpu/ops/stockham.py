"""Mixed-radix Stockham autosort FFT engine in pure JAX.

This is the JAX re-derivation of the reference's mixed-radix pass kernels
(passf2/3/4/5 and radf/radb 2..5, /root/reference/simd/chowdsp_fft_impl_sse.cpp:148-370,
552-786, 1081-1356). Design differences, deliberate:

- **Stockham autosort** instead of the pffft in-place + reorder scheme: every
  stage reads/writes contiguous blocks, so no separate ``pffft_zreorder``
  pass (/root/reference/simd/chowdsp_fft_impl_sse.cpp:1466-1515) is ever
  needed — ordered output is a property of the dataflow, not an extra copy.
- **No "internal layout"**: the reference runs w interleaved sub-FFTs in
  SIMD lanes and merges them with register transposes
  (pffft_cplx_finalize, sse:434-496). Under XLA every elementwise op is
  already vectorized across the batch; the batch axis *is* the
  SIMD axis, so the engine is written batched and vmap-compatible.
- Real transforms use the half-length complex FFT + split ("half-complex")
  algorithm rather than FFTPACK's radf/radb real passes — fewer, more
  regular stages, and the split step is pure elementwise + flip.
- Transforms are **unscaled**: backward(forward(x)) == N * x, matching the
  reference contract (/root/reference/chowdsp_fft.h:128).

All control flow is static (plan radices are Python ints), so everything
jits to a single fused XLA computation with no dynamic shapes.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..plans import (
    FFT_BACKWARD,
    FFT_COMPLEX,
    FFT_FORWARD,
    FFT_REAL,
    FFTPlan,
    cached_plan,
)

__all__ = [
    "cfft",
    "rfft",
    "irfft",
]


def _butterfly(parts: list[jax.Array], sign: int) -> list[jax.Array]:
    """Radix-r DFT across a list of r arrays (the butterfly proper).

    Specialized for r in {2, 4} to avoid multiplies by +-1/+-i (mirroring
    why the reference prefers radix-4: "passf4" is its hot pass,
    /root/reference/simd/chowdsp_fft_impl_sse.cpp:221-296); generic small-DFT
    fallback for r in {3, 5}. ``sign`` is -1 for forward, +1 for backward.
    """
    r = len(parts)
    if r == 1:
        return parts
    if r == 2:
        a, b = parts
        return [a + b, a - b]
    if r == 4:
        a, b, c, d = parts
        t0 = a + c
        t1 = a - c
        t2 = b + d
        t3 = (b - d) * (1j * sign)
        return [t0 + t2, t1 + t3, t0 - t2, t1 - t3]
    # Generic radix (3, 5): dense r-point DFT, unrolled at trace time.
    w = np.exp(sign * 2j * np.pi * np.outer(np.arange(r), np.arange(r)) / r)
    out = []
    for j in range(r):
        acc = parts[0]
        for k in range(1, r):
            acc = acc + parts[k] * complex(w[j, k])
        out.append(acc)
    return out


def cfft(x: jax.Array, plan: FFTPlan | None = None, direction: str = FFT_FORWARD) -> jax.Array:
    """Complex FFT over the last axis. Unscaled in both directions.

    Equivalent capability: ``fft_transform`` with FFT_COMPLEX
    (/root/reference/chowdsp_fft.cpp:318-356 -> cfftf1_ps, sse:372-432).

    Args:
      x: (..., N) complex64 (real input is promoted).
      plan: optional FFTPlan for a *complex* transform of size N.
      direction: "forward" (e^-i) or "backward" (e^+i, result = N * ifft).
    """
    n = x.shape[-1]
    if plan is None:
        plan = cached_plan(n, FFT_COMPLEX)
    if plan.kind == FFT_COMPLEX and plan.n != n:
        raise ValueError(f"plan is for N={plan.n}, input has N={n}")
    x = x.astype(jnp.complex64)
    if n == 1:
        return x

    sign = -1 if direction == FFT_FORWARD else 1
    batch_shape = x.shape[:-1]
    bsz = int(np.prod(batch_shape, dtype=np.int64)) if batch_shape else 1
    X = x.reshape(bsz, n, 1)

    stages = plan.stages if plan.kind == FFT_COMPLEX else _complex_stages_of(plan)
    for st in stages:
        r, m, s = st.radix, st.m, st.s
        Xv = X.reshape(bsz, r, m, s)
        parts = [Xv[:, k] for k in range(r)]
        Z = _butterfly(parts, sign)
        # Tables store forward-sign twiddles exp(-2i*pi*j*p/n); backward
        # (sign=+1) conjugates them for free at trace time.
        w = jax.lax.complex(st.tw_re, -sign * st.tw_im)
        # j == 0 twiddle is identically 1 — skip the multiply.
        Zt = [Z[0]] + [Z[j] * w[j][None, :, None] for j in range(1, r)]
        X = jnp.stack(Zt, axis=2).reshape(bsz, m, r * s)

    return X.reshape(*batch_shape, n)


def _complex_stages_of(plan: FFTPlan):
    if plan.kind != FFT_REAL:
        raise ValueError("expected a real-transform plan")
    return plan.stages


def rfft(x: jax.Array, plan: FFTPlan | None = None) -> jax.Array:
    """Real forward FFT -> canonical half spectrum of N//2 + 1 complex bins.

    Equivalent capability: ``fft_transform`` with FFT_REAL / FFT_FORWARD
    (/root/reference/chowdsp_fft.cpp:318-356 -> rfftf1_ps, sse:788-846 +
    pffft_real_finalize, sse:909-966). The canonical (numpy-style) bin
    layout replaces pffft's packed layout (Nyquist stashed in slot 1 —
    see ops/layout.py for converters).

    Algorithm: pack adjacent sample pairs into N/2 complex points, run the
    half-length complex FFT, then split even/odd spectra with the
    exp(-2i*pi*k/N) twiddles from the plan.
    """
    n = x.shape[-1]
    if plan is None:
        plan = cached_plan(n, FFT_REAL)
    if plan.kind != FFT_REAL or plan.n != n:
        raise ValueError(f"plan mismatch: plan=({plan.kind}, {plan.n}), input N={n}")
    x = x.astype(jnp.float32)
    m = n // 2

    z = jax.lax.complex(x[..., 0::2], x[..., 1::2])  # (..., M)
    Z = cfft(z, plan=_as_complex_view(plan), direction=FFT_FORWARD) if m > 1 else z.astype(jnp.complex64)

    # Zc[k] = conj(Z[(M-k) % M])
    Zc = jnp.conj(jnp.roll(jnp.flip(Z, axis=-1), 1, axis=-1))
    E = 0.5 * (Z + Zc)
    O = -0.5j * (Z - Zc)
    w = jax.lax.complex(plan.rfft_tw_re, plan.rfft_tw_im)  # (M,)
    main = E + w * O  # bins 0..M-1
    nyq = (E[..., :1] - O[..., :1]).real.astype(jnp.float32)  # bin M is real
    return jnp.concatenate([main, jax.lax.complex(nyq, jnp.zeros_like(nyq))], axis=-1)


def irfft(spec: jax.Array, plan: FFTPlan | None = None) -> jax.Array:
    """Unscaled inverse real FFT: irfft(rfft(x)) == N * x.

    Equivalent capability: ``fft_transform`` with FFT_REAL / FFT_BACKWARD
    (/root/reference/chowdsp_fft.cpp:318-356 -> pffft_real_preprocess
    sse:969-1078 + rfftb1_ps sse:1358-1416). Input: (..., N//2+1) complex
    canonical spectrum. Output: (..., N) float32.
    """
    bins = spec.shape[-1]
    n = 2 * (bins - 1)
    if plan is None:
        plan = cached_plan(n, FFT_REAL)
    if plan.kind != FFT_REAL or plan.n != n:
        raise ValueError(f"plan mismatch: plan=({plan.kind}, {plan.n}), spectrum bins={bins}")
    spec = spec.astype(jnp.complex64)
    m = n // 2

    Xmain = spec[..., :m]  # bins 0..M-1
    # Xr[k] = conj(X[M - k]) for k = 0..M-1 (uses bins 1..M).
    Xr = jnp.conj(jnp.flip(spec[..., 1:], axis=-1))
    E = 0.5 * (Xmain + Xr)
    wb = jax.lax.complex(plan.rfft_tw_re, -plan.rfft_tw_im)  # exp(+2i*pi*k/N)
    O = 0.5 * wb * (Xmain - Xr)
    Z = E + 1j * O

    zt = cfft(Z, plan=_as_complex_view(plan), direction=FFT_BACKWARD) if m > 1 else Z
    # zt == M * (x_even + i x_odd); want N*x = 2M*x.
    even = 2.0 * zt.real
    odd = 2.0 * zt.imag
    out = jnp.stack([even, odd], axis=-1).reshape(*spec.shape[:-1], n)
    return out.astype(jnp.float32)


def _as_complex_view(plan: FFTPlan) -> FFTPlan:
    """View a real plan as the complex plan of its half-length transform."""
    return FFTPlan(
        n=plan.cfft_n,
        kind=FFT_COMPLEX,
        radices=plan.radices,
        stages=plan.stages,
        rfft_tw_re=None,
        rfft_tw_im=None,
    )
