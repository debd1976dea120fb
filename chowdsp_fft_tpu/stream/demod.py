"""Demodulation stages for the SDR chain (BASELINE.json config 5).

New surface (no reference counterpart): pure elementwise math, fused by
XLA into neighboring stages.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["fm_demod", "am_demod", "dc_block"]


def fm_demod(z: jax.Array, gain: float = 1.0) -> jax.Array:
    """Quadrature FM discriminator over complex baseband (..., T).

    y[n] = gain * angle(z[n] * conj(z[n-1])), computed with atan2;
    y[0] = 0 (zero phase history).
    """
    zr, zi = jnp.real(z), jnp.imag(z)
    pr = jnp.pad(zr[..., :-1], [(0, 0)] * (zr.ndim - 1) + [(1, 0)])
    pi = jnp.pad(zi[..., :-1], [(0, 0)] * (zi.ndim - 1) + [(1, 0)])
    # z[n] * conj(z[n-1])
    dr = zr * pr + zi * pi
    di = zi * pr - zr * pi
    # y[0] is set, not computed: atan2 of the signed zeros the padding
    # gives (e.g. atan2(+0, -0) = pi) would be +-pi.
    first = jnp.arange(z.shape[-1]) == 0
    return jnp.where(first, 0.0, gain * jnp.arctan2(di, dr)).astype(jnp.float32)


def am_demod(z: jax.Array) -> jax.Array:
    """Envelope detector: |z| (AM demodulation before DC block)."""
    return jnp.abs(z).astype(jnp.float32)


def dc_block(x: jax.Array, alpha: float = 0.995) -> jax.Array:
    """Single-pole DC blocker y[n] = x[n] - x[n-1] + alpha*y[n-1],
    vectorized as an associative scan (log-depth instead of a
    sequential IIR loop)."""
    d = x - jnp.pad(x[..., :-1], [(0, 0)] * (x.ndim - 1) + [(1, 0)])

    def combine(a, b):
        # pairs (A, B) represent y = A*y_prev + B
        a1, b1 = a
        a2, b2 = b
        return a1 * a2, a2 * b1 + b2

    coeffs = jnp.full_like(d, alpha)
    _, y = jax.lax.associative_scan(combine, (coeffs, d), axis=x.ndim - 1)
    return y.astype(jnp.float32)
