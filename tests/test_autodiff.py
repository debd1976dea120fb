"""Autodiff through the xla engine.

JAX differentiates ``jnp.fft`` through its own transpose rules, and the
packed-plane adapters around it are plain jnp. The differential reference
is the pure-jnp Stockham engine, which JAX differentiates natively — grads
must agree to fp32 tolerance, with the library's unscaled convention.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import chowdsp_fft_tpu as cf


@pytest.fixture
def x(rng):
    return jnp.asarray(rng.standard_normal((3, 512)), jnp.float32)


def _grad_match(make_loss, arg, rtol=1e-4):
    gp = np.asarray(jax.grad(make_loss("xla"))(arg))
    gs = np.asarray(jax.grad(make_loss("stockham"))(arg))
    assert np.abs(gp - gs).max() / max(np.abs(gs).max(), 1e-9) < rtol


def test_grad_rfft_canonical(x):
    _grad_match(lambda e: (lambda v: jnp.sum(jnp.abs(cf.rfft(v, engine=e)) ** 2)), x)


def test_grad_rfft_packed(x):
    def mk(e):
        def loss(v):
            re, im = cf.rfft_packed(v, engine=e)
            return jnp.sum(re**2) + jnp.sum(im**3)

        return loss

    _grad_match(mk, x)


def test_grad_roundtrip_nonlinear(x):
    def mk(e):
        return lambda v: jnp.sum(jnp.tanh(cf.irfft(cf.rfft(v, engine=e), engine=e) / 512.0))

    _grad_match(mk, x)


def test_grad_cfft_complex(rng):
    z = jnp.asarray(
        rng.standard_normal((2, 256)) + 1j * rng.standard_normal((2, 256)), jnp.complex64
    )
    _grad_match(lambda e: (lambda v: jnp.sum(jnp.abs(cf.fft(v, engine=e)) ** 2)), z)


def test_grad_unordered_packed_chain(x):
    def mk(e):
        def loss(v):
            re, im = cf.rfft_packed_unordered(v, engine=e)
            y = cf.irfft_packed_unordered(re * 2.0, im * 2.0, engine=e)
            return jnp.sum(jnp.sin(y / 512.0))

        return loss

    _grad_match(mk, x)


@pytest.mark.parametrize("engine", ["xla", "stockham"])
def test_grad_largeN_adjoint(engine, rng):
    """Adjoint consistency <J v, u> == <v, J^T u> of the packed real
    transforms at N=2^18."""
    n = 1 << 18
    x = jnp.asarray(rng.standard_normal((1, n)), jnp.float32)
    u_re = jnp.asarray(rng.standard_normal((1, n // 2)), jnp.float32)
    u_im = jnp.asarray(rng.standard_normal((1, n // 2)), jnp.float32)

    f = lambda v: cf.rfft_packed(v, engine=engine)
    (y_re, y_im), vjp = jax.vjp(f, x)
    (ct,) = vjp((u_re, u_im))
    # J is real-linear: <f(x), u> == <x, J^T u> for linear f. The inner
    # products of random vectors are near-zero in expectation, so
    # normalize by the operand norms (|lhs| in the denominator flaked).
    lhs = float(jnp.vdot(y_re, u_re) + jnp.vdot(y_im, u_im))
    rhs = float(jnp.vdot(x, ct))
    scale = float(
        jnp.sqrt(jnp.sum(y_re**2) + jnp.sum(y_im**2))
        * jnp.sqrt(jnp.sum(u_re**2) + jnp.sum(u_im**2))
    )
    assert abs(lhs - rhs) / scale < 1e-6

    # Inverse path too.
    g = lambda re, im: cf.irfft_packed(re, im, engine=engine)
    yt, vjp_i = jax.vjp(g, y_re, y_im)
    w = jnp.asarray(rng.standard_normal(yt.shape), jnp.float32)
    ct_re, ct_im = vjp_i(w)
    lhs_i = float(jnp.vdot(yt, w))
    rhs_i = float(jnp.vdot(y_re, ct_re) + jnp.vdot(y_im, ct_im))
    scale_i = float(jnp.linalg.norm(yt.reshape(-1)) * jnp.linalg.norm(w.reshape(-1)))
    assert abs(lhs_i - rhs_i) / scale_i < 1e-6


def test_grad_stream_fir(rng):
    """The streaming layer differentiates end-to-end (filter design /
    learned-IR use cases)."""
    from chowdsp_fft_tpu.stream import fir_filter_ols

    x = jnp.asarray(rng.standard_normal((2, 2048)), jnp.float32)
    h0 = jnp.asarray(rng.standard_normal(63) / 8, jnp.float32)

    def loss(h):
        y = fir_filter_ols(x, h, block=512)
        return jnp.sum(y**2)

    g = np.asarray(jax.grad(loss)(h0))
    # Exact gradient in float64: y = lfilter(h, x), so
    # dloss/dh_k = 2 * sum_t y[t] * x[t - k]. (A float32 finite
    # difference of a loss ~4e3 resolves only ~1e-3 and flaked with the
    # random draw.)
    import scipy.signal as sig

    xd = np.asarray(x, np.float64)
    y = sig.lfilter(np.asarray(h0, np.float64), [1.0], xd, axis=-1)
    t = xd.shape[-1]
    exact = np.array(
        [2.0 * np.sum(y[:, k:] * xd[:, : t - k]) for k in range(h0.shape[0])]
    )
    np.testing.assert_allclose(g, exact, atol=1e-4 * np.abs(exact).max(), rtol=0)
