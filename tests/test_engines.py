"""Transform-engine tests, run on every engine (``xla`` and ``stockham``).

Same differential scheme as test_fft_core.py, plus the unordered-layout
contracts: unordered round trips and convolution compose — the behavior
the reference guarantees for fft_transform_unordered +
fft_convolve_unordered (reference chowdsp_fft.h:140-154,
test.cpp:131-232). Both engines emit natural bin order, so "unordered"
equals ordered here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chowdsp_fft_tpu as cf

ENGINES = ("xla", "stockham")
C_SIZES = [256, 512, 1024, 4096]
R_SIZES = [512, 1024, 4096, 8192]

engines = pytest.mark.parametrize("engine", ENGINES)


def tol(n):
    return 2.0e-7 * n


def rand_complex(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def circ_conv(x, h):
    return np.real(
        np.fft.ifft(
            np.fft.fft(x.astype(np.float64), axis=-1) * np.fft.fft(h.astype(np.float64), axis=-1),
            axis=-1,
        )
    )


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------


def test_auto_selects_xla_for_every_valid_size():
    """engine="auto" takes the xla engine for every valid size up to 4096,
    complex and real, on every backend."""
    assert cf.available_engines() == ("xla", "stockham")
    for n in range(2, 4097):
        if cf.is_valid_size(n, cf.FFT_COMPLEX):
            assert cf.engine_for(n, cf.FFT_COMPLEX) == "xla", n
        if cf.is_valid_size(n, cf.FFT_REAL):
            assert cf.engine_for(n, cf.FFT_REAL) == "xla", n
    assert cf.engine_for(3 << 18, cf.FFT_REAL) == "xla"
    assert cf.engine_supports("stockham", 960, cf.FFT_COMPLEX)


@pytest.mark.parametrize("name", ["pallas", "bogus"])
def test_unknown_engine_raises(name, rng):
    x = rng.standard_normal((2, 256)).astype(np.float32)
    with pytest.raises(ValueError, match="unknown engine"):
        cf.rfft(x, engine=name)
    with pytest.raises(ValueError, match="unknown engine"):
        cf.engine_supports(name, 256)


@engines
def test_plan_mismatch_raises(engine, rng):
    x = rng.standard_normal((2, 256)).astype(np.float32)
    with pytest.raises(ValueError, match="plan"):
        cf.rfft(x, plan=cf.make_plan(512, cf.FFT_REAL), engine=engine)


# ---------------------------------------------------------------------------
# Complex and canonical real transforms
# ---------------------------------------------------------------------------


@engines
@pytest.mark.parametrize("n", C_SIZES)
def test_cfft_vs_numpy(n, engine, rng):
    x = rand_complex(rng, (5, n))
    got = np.asarray(cf.fft(x, engine=engine))
    ref = np.fft.fft(x.astype(np.complex128), axis=-1)
    np.testing.assert_allclose(got, ref, atol=tol(n), rtol=0)


@engines
@pytest.mark.parametrize("n", C_SIZES)
def test_cfft_backward(n, engine, rng):
    x = rand_complex(rng, (3, n))
    back = np.asarray(cf.ifft(cf.fft(x, engine=engine), engine=engine)) / n
    np.testing.assert_allclose(back, x, atol=tol(n), rtol=0)
    # Ordered backward alone vs numpy (unscaled: N * ifft)
    got = np.asarray(cf.ifft(x, engine=engine))
    ref = np.fft.ifft(x.astype(np.complex128), axis=-1) * n
    np.testing.assert_allclose(got, ref, atol=tol(n), rtol=0)


@engines
@pytest.mark.parametrize("n", C_SIZES)
def test_unordered_equals_ordered(n, engine, rng):
    """Both engines' engine-private "unordered" layout is natural order."""
    x = rand_complex(rng, (2, n))
    ordered = np.asarray(cf.fft(x, engine=engine))
    unordered = np.asarray(cf.fft_unordered(x, engine=engine))
    np.testing.assert_allclose(unordered, ordered, atol=1e-4, rtol=0)


@engines
@pytest.mark.parametrize("n", C_SIZES)
def test_unordered_roundtrip(n, engine, rng):
    x = rand_complex(rng, (2, n))
    back = np.asarray(cf.ifft_unordered(cf.fft_unordered(x, engine=engine), engine=engine)) / n
    np.testing.assert_allclose(back, x, atol=tol(n), rtol=0)


@engines
@pytest.mark.parametrize("n", R_SIZES)
def test_rfft_vs_numpy(n, engine, rng):
    x = rng.standard_normal((4, n)).astype(np.float32)
    got = np.asarray(cf.rfft(x, engine=engine))
    ref = np.fft.rfft(x.astype(np.float64), axis=-1)
    np.testing.assert_allclose(got, ref, atol=tol(n), rtol=0)


@engines
@pytest.mark.parametrize("n", R_SIZES)
def test_rfft_roundtrip(n, engine, rng):
    x = rng.standard_normal((3, n)).astype(np.float32)
    back = np.asarray(cf.irfft(cf.rfft(x, engine=engine), engine=engine)) / n
    np.testing.assert_allclose(back, x, atol=tol(n), rtol=0)


@engines
def test_conv_e2e(engine, rng):
    n = 4096
    a = rng.standard_normal((n,)).astype(np.float32)
    b = rng.standard_normal((n,)).astype(np.float32)
    A = cf.rfft_unordered(a, engine=engine)
    B = cf.rfft_unordered(b, engine=engine)
    y = np.asarray(cf.irfft_unordered(cf.convolve_accumulate(A, B), engine=engine)) / n
    ref = np.fft.irfft(np.fft.rfft(a.astype(np.float64)) * np.fft.rfft(b.astype(np.float64)))
    np.testing.assert_allclose(y, ref, atol=tol(n) * np.sqrt(n), rtol=0)


@engines
def test_complex_unordered_conv_e2e(engine, rng):
    n = 1024
    a = rand_complex(rng, (n,))
    b = rand_complex(rng, (n,))
    A = cf.fft_unordered(a, engine=engine)
    B = cf.fft_unordered(b, engine=engine)
    y = np.asarray(cf.ifft_unordered(cf.convolve_accumulate(A, B), engine=engine)) / n
    ref = np.fft.ifft(np.fft.fft(a.astype(np.complex128)) * np.fft.fft(b.astype(np.complex128)))
    np.testing.assert_allclose(y, ref, atol=tol(n) * np.sqrt(n), rtol=0)


@engines
def test_rfft_unordered_layout(engine, rng):
    """rfft_unordered carries the engine's bin order (natural here) and
    composes with its inverse."""
    n = 1024
    x = rng.standard_normal((3, n)).astype(np.float32)
    ordered = np.asarray(cf.rfft(x, engine=engine))
    unord = np.asarray(cf.rfft_unordered(x, engine=engine))
    np.testing.assert_allclose(unord, ordered, atol=1e-4, rtol=0)
    back = np.asarray(cf.irfft_unordered(jnp.asarray(unord), engine=engine)) / n
    assert np.abs(back - x).max() < tol(n)


@engines
def test_odd_batch_padding(engine, rng):
    n = 256
    x = rand_complex(rng, (13, n))  # odd batch
    got = np.asarray(cf.fft(x, engine=engine))
    ref = np.fft.fft(x.astype(np.complex128), axis=-1)
    np.testing.assert_allclose(got, ref, atol=tol(n), rtol=0)
    # single vector, no batch dim
    y = rand_complex(rng, (n,))
    got1 = np.asarray(cf.fft(y, engine=engine))
    np.testing.assert_allclose(got1, np.fft.fft(y.astype(np.complex128)), atol=tol(n), rtol=0)


# ---------------------------------------------------------------------------
# Packed-plane real transforms
# ---------------------------------------------------------------------------


@engines
@pytest.mark.parametrize("n", [256, 1024, 4096])
def test_rfft_packed_vs_numpy(n, engine, rng):
    x = rng.standard_normal((5, n)).astype(np.float32)
    re, im = map(np.asarray, cf.rfft_packed(x, engine=engine))
    ref = np.fft.rfft(x.astype(np.float64), axis=-1)
    assert np.abs(re[:, 1:] - ref[:, 1 : n // 2].real).max() < tol(n)
    assert np.abs(im[:, 1:] - ref[:, 1 : n // 2].imag).max() < tol(n)
    assert np.abs(re[:, 0] - ref[:, 0].real).max() < tol(n)  # DC
    assert np.abs(im[:, 0] - ref[:, -1].real).max() < tol(n)  # Nyquist in im[0]


@engines
@pytest.mark.parametrize("n", [256, 4096])
def test_rfft_packed_roundtrip(n, engine, rng):
    x = rng.standard_normal((3, n)).astype(np.float32)
    re, im = cf.rfft_packed(x, engine=engine)
    back = np.asarray(cf.irfft_packed(re, im, engine=engine)) / n
    assert np.abs(back - x).max() < tol(n)


@engines
@pytest.mark.parametrize("n", [256, 4096])
def test_rfft_packed_unordered_roundtrip(n, engine, rng):
    x = rng.standard_normal((3, n)).astype(np.float32)
    re, im = cf.rfft_packed_unordered(x, engine=engine)
    back = np.asarray(cf.irfft_packed_unordered(re, im, engine=engine)) / n
    assert np.abs(back - x).max() < tol(n)


@engines
def test_packed_matches_spectrum_converter(engine, rng):
    """Ordered packed planes agree with spectrum_to_packed_planes(rfft)."""
    n = 1024
    x = rng.standard_normal((2, n)).astype(np.float32)
    re, im = map(np.asarray, cf.rfft_packed(x, engine=engine))
    re2, im2 = map(np.asarray, cf.spectrum_to_packed_planes(cf.rfft(x, engine="stockham")))
    assert np.abs(re - re2).max() < tol(n)
    assert np.abs(im - im2).max() < tol(n)


@engines
def test_packed_unordered_conv_e2e(engine, rng):
    """rfft_packed_unordered -> convolve_accumulate_packed ->
    irfft_packed_unordered == circular convolution (the reference's
    fast-convolution pipeline, test.cpp:131-232, in packed planes)."""
    n = 2048
    x = rng.standard_normal((3, n)).astype(np.float32)
    h = rng.standard_normal((3, n)).astype(np.float32)
    a = cf.rfft_packed_unordered(x, engine=engine)
    b = cf.rfft_packed_unordered(h, engine=engine)
    pr, pi = cf.convolve_accumulate_packed(a, b, scaling=1.0 / n)
    y = np.asarray(cf.irfft_packed_unordered(pr, pi, engine=engine))
    ref = np.fft.irfft(np.fft.rfft(x.astype(np.float64)) * np.fft.rfft(h.astype(np.float64)))
    assert np.abs(y - ref).max() < 20 * tol(n)  # conv values scale ~sqrt(n)


def test_convolve_accumulate_packed_accumulates(rng):
    n = 512
    x = rng.standard_normal((2, n // 2)).astype(np.float32)
    a = (x, x * 2)
    b = (x * 3, x * 0.5)
    base_r, base_i = cf.convolve_accumulate_packed(a, b)
    acc_r, acc_i = cf.convolve_accumulate_packed(a, b, ab=(base_r, base_i))
    assert np.allclose(np.asarray(acc_r), 2 * np.asarray(base_r))
    assert np.allclose(np.asarray(acc_i), 2 * np.asarray(base_i))


# ---------------------------------------------------------------------------
# Large and smooth non-pow2 sizes
# ---------------------------------------------------------------------------


@engines
def test_large_cfft_roundtrip(engine, rng):
    """N=65536: differential + round trip through the public API."""
    n = 65536
    x = rand_complex(rng, (2, n))
    got = np.asarray(cf.fft(x, engine=engine))
    ref = np.fft.fft(x.astype(np.complex128), axis=-1)
    assert np.abs(got - ref).max() < tol(n)
    back = np.asarray(cf.ifft(got.astype(np.complex64), engine=engine)) / n
    assert np.abs(back - x).max() < tol(n)


@engines
def test_large_planes_roundtrip(engine, rng):
    """N=65536 on SoA planes, ordered: differential + unscaled round trip."""
    n = 65536
    x = rand_complex(rng, (2, n))
    yr, yi = cf.fft_planes(x.real, x.imag, engine=engine)
    got = np.asarray(yr) + 1j * np.asarray(yi)
    ref = np.fft.fft(x.astype(np.complex128), axis=-1)
    assert np.abs(got - ref).max() < tol(n)
    br, bi = cf.ifft_planes(yr, yi, engine=engine)
    back = (np.asarray(br) + 1j * np.asarray(bi)) / n
    assert np.abs(back - x).max() < tol(n)


@engines
def test_large_planes_unordered_roundtrip(engine, rng):
    n = 65536
    x = rand_complex(rng, (2, n))
    ur, ui = cf.fft_planes_unordered(x.real, x.imag, engine=engine)
    br, bi = cf.ifft_planes_unordered(ur, ui, engine=engine)
    back = (np.asarray(br) + 1j * np.asarray(bi)) / n
    assert np.abs(back - x).max() < tol(n)


@engines
def test_smooth_nonpow2_large(engine, rng):
    """A {2,3,5}-smooth N above 2^16 (98304 = 3 * 2^15): the reference's
    full size domain (reference simd/chowdsp_fft_impl_common.hpp:216-225)."""
    n = 384 * 256
    x = rand_complex(rng, (2, n))
    got = np.asarray(cf.fft(x, engine=engine))
    ref = np.fft.fft(x.astype(np.complex128), axis=-1)
    assert np.abs(got - ref).max() < tol(n)
    back = np.asarray(cf.ifft(jnp.asarray(got.astype(np.complex64)), engine=engine)) / n
    assert np.abs(back - x).max() < tol(n)


@engines
def test_smooth_real_3x2e18(engine, rng):
    """N = 3*2^18, the parity case the reference serves: packed real
    forward vs numpy and the unscaled round trip."""
    n = 3 * (1 << 18)
    x = rng.standard_normal((1, n)).astype(np.float32)
    re, im = map(np.asarray, cf.rfft_packed(x, engine=engine))
    ref = np.fft.rfft(x.astype(np.float64), axis=-1)
    assert np.abs(re[:, 1:] - ref[:, 1 : n // 2].real).max() < tol(n)
    assert np.abs(im[:, 0] - ref[:, -1].real).max() < tol(n)
    back = np.asarray(cf.irfft_packed(jnp.asarray(re), jnp.asarray(im), engine=engine)) / n
    assert np.abs(back - x).max() < tol(n)


@engines
@pytest.mark.parametrize("n", [576, 720, 960, 1440])
def test_medium_smooth_sizes(n, engine, rng):
    """Medium smooth non-multiples of 128 — the reference serves them from
    its SIMD tier (impl_common.hpp:165-177). Differential vs numpy f64,
    complex + real, ordered + unordered, plus the packed-convolve pairing
    contract."""
    assert cf.engine_for(n, cf.FFT_COMPLEX) == "xla"
    z = rand_complex(rng, (3, n))
    got = np.asarray(cf.fft(z, engine=engine))
    ref = np.fft.fft(z.astype(np.complex128), axis=-1)
    np.testing.assert_allclose(got, ref, atol=tol(n), rtol=0)
    back = np.asarray(cf.ifft(jnp.asarray(got), engine=engine)) / n
    np.testing.assert_allclose(back, z, atol=tol(n), rtol=0)

    zu = cf.fft_unordered(z, engine=engine)
    zb = np.asarray(cf.ifft_unordered(zu, engine=engine)) / n
    np.testing.assert_allclose(zb, z, atol=tol(n), rtol=0)

    x = rng.standard_normal((3, n)).astype(np.float32)
    re, im = map(np.asarray, cf.rfft_packed(x, engine=engine))
    rref = np.fft.rfft(x.astype(np.float64), axis=-1)
    assert np.abs(re[:, 0] - rref[:, 0].real).max() < tol(n)
    assert np.abs(im[:, 0] - rref[:, -1].real).max() < tol(n)
    assert np.abs((re[:, 1:] + 1j * im[:, 1:]) - rref[:, 1 : n // 2]).max() < tol(n)
    xb = np.asarray(cf.irfft_packed(re, im, engine=engine)) / n
    np.testing.assert_allclose(xb, x, atol=tol(n), rtol=0)

    h = rng.standard_normal((1, n)).astype(np.float32)
    ar, ai = cf.rfft_packed_unordered(x, engine=engine)
    br, bi = cf.rfft_packed_unordered(h, engine=engine)
    pr, pi = cf.convolve_accumulate_packed((ar, ai), (br, bi))
    y = np.asarray(cf.irfft_packed_unordered(pr, pi, engine=engine)) / n
    np.testing.assert_allclose(y, circ_conv(x, h), atol=10 * tol(n), rtol=0)


@engines
def test_medium_smooth_grad(engine, rng):
    """Autodiff through a medium smooth size, against the analytic
    gradient."""
    n = 576
    x = rng.standard_normal((2, n)).astype(np.float32)

    def loss(v):
        re, im = cf.rfft_packed(v, engine=engine)
        return jnp.sum(re**2) + jnp.sum(im**2)

    g = np.asarray(jax.grad(loss)(jnp.asarray(x)))
    # The packed half-spectrum holds DC and Nyquist once and bins
    # 1..N/2-1 once each, so by Parseval
    #   loss = (N*sum x^2 + X_0^2 + X_{N/2}^2) / 2
    #   dloss/dx_j = N*x_j + X_0 + (-1)^j * X_{N/2}.
    X = np.fft.rfft(x.astype(np.float64), axis=1)
    signs = ((-1.0) ** np.arange(n))[None, :]
    expect = n * x + X[:, :1].real + signs * X[:, -1:].real
    # The gradient IS the backward transform of the cotangent 2*(re, im);
    # the 2e-7*N bound (reference test.cpp:9-14) is relative to that
    # transform's input scale, max 2|X|.
    atol = 2e-7 * n * 2.0 * float(np.abs(X).max())
    np.testing.assert_allclose(g, expect, atol=atol, rtol=0)


@engines
def test_convolve_irfft_packed_composition(engine, rng):
    """convolve_irfft_packed == irfft_packed(convolve_accumulate_packed(..)),
    checked vs the f64 circular convolution for a shared (1, N/2) filter, a
    batched filter, ordered and unordered layouts, a traced scaling, and
    under vmap."""
    n = 1024
    b = 4
    x = rng.standard_normal((b, n)).astype(np.float32)
    h = rng.standard_normal((1, n)).astype(np.float32)
    ref = circ_conv(x, h)
    for ordered in (True, False):
        fwd = cf.rfft_packed if ordered else cf.rfft_packed_unordered
        are, aim = fwd(x, engine=engine)
        bre, bim = fwd(h, engine=engine)
        y = np.asarray(
            cf.convolve_irfft_packed(
                are, aim, bre, bim, scaling=1.0 / n, engine=engine, ordered=ordered
            )
        )
        assert np.abs(y - ref).max() < tol(n), f"ordered={ordered}"
        pr, pi = cf.convolve_accumulate_packed((are, aim), (bre, bim), scaling=1.0 / n)
        inv = cf.irfft_packed if ordered else cf.irfft_packed_unordered
        y2 = np.asarray(inv(pr, pi, engine=engine))
        assert np.abs(y - y2).max() < tol(n)
    # batched filter (B matches A's batch)
    hb = rng.standard_normal((b, n)).astype(np.float32)
    are, aim = cf.rfft_packed(x, engine=engine)
    bre, bim = cf.rfft_packed(hb, engine=engine)
    refb = circ_conv(x, hb)
    yb = np.asarray(cf.convolve_irfft_packed(are, aim, bre, bim, scaling=1.0 / n, engine=engine))
    assert np.abs(yb - refb).max() < tol(n)
    # traced scaling
    yt = np.asarray(
        jax.jit(
            lambda s: cf.convolve_irfft_packed(are, aim, bre, bim, scaling=s, engine=engine)
        )(jnp.float32(1.0 / n))
    )
    assert np.abs(yt - refb).max() < tol(n)
    # vmap over a leading axis
    xv = rng.standard_normal((3, 2, n)).astype(np.float32)
    hv = rng.standard_normal((2, n)).astype(np.float32)

    def one(xi, hi):
        ar, ai = cf.rfft_packed(xi, engine=engine)
        br, bi = cf.rfft_packed(hi, engine=engine)
        return cf.convolve_irfft_packed(ar, ai, br, bi, scaling=1.0 / n, engine=engine)

    yv = np.asarray(jax.vmap(one, in_axes=(0, None))(jnp.asarray(xv), jnp.asarray(hv)))
    assert np.abs(yv - circ_conv(xv, hv)).max() < tol(n)


@engines
def test_convolve_irfft_packed_grad(engine, rng):
    """The op's gradient matches the stockham engine's autodiff of the
    same composition."""
    n = 256
    x = rng.standard_normal((2, n)).astype(np.float32)
    h = rng.standard_normal((1, n)).astype(np.float32)
    are, aim = map(np.asarray, cf.rfft_packed(x, engine=engine))
    bre, bim = map(np.asarray, cf.rfft_packed(h, engine=engine))
    w = rng.standard_normal((2, n)).astype(np.float32)

    def loss_op(ar, ai, br, bi):
        y = cf.convolve_irfft_packed(ar, ai, br, bi, scaling=1.0 / n, engine=engine)
        return jnp.sum(y * w)

    def loss_ref(ar, ai, br, bi):
        pr, pi = cf.convolve_accumulate_packed((ar, ai), (br, bi), scaling=1.0 / n)
        return jnp.sum(cf.irfft_packed(pr, pi, engine="stockham") * w)

    g1 = jax.grad(loss_op, argnums=(0, 1, 2, 3))(are, aim, bre, bim)
    g2 = jax.grad(loss_ref, argnums=(0, 1, 2, 3))(are, aim, bre, bim)
    for a, b in zip(g1, g2):
        assert np.abs(np.asarray(a) - np.asarray(b)).max() < tol(n)


@engines
def test_unordered_layout_batch_independent(engine, rng):
    """A plan's unordered bin order is contractual per PLAN (the reference
    convolves z-domain data across calls of one setup): a batch of 5 and a
    batch of 1 at N = 196608 emit the same order, so their spectra
    convolve together."""
    n = 196608  # 512 x 384
    x = rand_complex(rng, (5, n))
    h = rand_complex(rng, (1, n))
    xr, xi = cf.fft_planes_unordered(x.real, x.imag, engine=engine)
    hr, hi = cf.fft_planes_unordered(h.real, h.imag, engine=engine)
    ref_x = np.fft.fft(x.astype(np.complex128), axis=-1)
    ref_h = np.fft.fft(h.astype(np.complex128), axis=-1)
    assert np.abs((np.asarray(xr) + 1j * np.asarray(xi)) - ref_x).max() < tol(n)
    assert np.abs((np.asarray(hr) + 1j * np.asarray(hi)) - ref_h).max() < tol(n)
    pr = xr * hr - xi * hi
    pi = xr * hi + xi * hr
    br, bi = map(np.asarray, cf.ifft_planes_unordered(pr, pi, engine=engine))
    got = (br + 1j * bi) / n
    ref = np.fft.ifft(ref_x * ref_h, axis=-1)
    assert np.abs(got - ref).max() < tol(n) * np.sqrt(n)


@engines
def test_fft_planes_matches_complex(engine, rng):
    n = 1024
    z = rand_complex(rng, (3, n))
    yr, yi = map(np.asarray, cf.fft_planes(z.real, z.imag, engine=engine))
    ref = np.fft.fft(z.astype(np.complex128), axis=-1)
    assert np.abs(yr - ref.real).max() < tol(n)
    assert np.abs(yi - ref.imag).max() < tol(n)
    br, bi = map(np.asarray, cf.ifft_planes(yr, yi, engine=engine))
    assert np.abs(br / n - z.real).max() < tol(n)
    assert np.abs(bi / n - z.imag).max() < tol(n)


@engines
def test_fft_planes_unordered_roundtrip(engine, rng):
    n = 512
    z = rand_complex(rng, (2, n))
    ur, ui = cf.fft_planes_unordered(z.real, z.imag, engine=engine)
    br, bi = map(np.asarray, cf.ifft_planes_unordered(ur, ui, engine=engine))
    assert np.abs(br / n - z.real).max() < tol(n)
    assert np.abs(bi / n - z.imag).max() < tol(n)


@engines
def test_vmap_over_rfft_packed(engine, rng):
    """vmap over a leading axis matches the flat batch."""
    n = 512
    x = rng.standard_normal((3, 4, n)).astype(np.float32)
    direct_re, direct_im = cf.rfft_packed(x.reshape(12, n), engine=engine)
    vm = jax.vmap(lambda v: cf.rfft_packed(v, engine=engine))
    vre, vim = vm(jnp.asarray(x))
    assert np.abs(np.asarray(vre).reshape(12, -1) - np.asarray(direct_re)).max() < tol(n)
    assert np.abs(np.asarray(vim).reshape(12, -1) - np.asarray(direct_im)).max() < tol(n)


@engines
@pytest.mark.parametrize("n,batch", [(131072, 1), (262144, 3), (256, 1)])
def test_boundary_sizes(n, batch, engine, rng):
    """Large sizes with odd/unit batches, and the smallest pow2 size."""
    x = rng.standard_normal((batch, n)).astype(np.float32)
    re, im = map(np.asarray, cf.rfft_packed(x, engine=engine))
    ref = np.fft.rfft(x.astype(np.float64), axis=-1)
    assert np.abs(re[:, 1:] - ref[:, 1 : n // 2].real).max() < tol(n)
    assert np.abs(im[:, 0] - ref[:, -1].real).max() < tol(n)
    back = np.asarray(cf.irfft_packed(re, im, engine=engine)) / n
    assert np.abs(back - x).max() < tol(n)


@engines
def test_fuzz_random_sizes_and_batches(engine, rng):
    """Property fuzz across the size domain: random valid sizes x odd
    batch shapes — differential vs numpy f64 and unscaled round trip."""
    valid = [n for n in range(8, 3000) if cf.is_valid_size(n, cf.FFT_REAL)]
    picks = rng.choice(len(valid), size=10, replace=False)
    for idx in picks:
        n = valid[idx]
        b = int(rng.integers(1, 7))
        x = rng.standard_normal((b, n)).astype(np.float32)
        re, im = map(np.asarray, cf.rfft_packed(x, engine=engine))
        ref = np.fft.rfft(x.astype(np.float64), axis=-1)
        assert np.abs(re[:, 0] - ref[:, 0].real).max() < tol(n), n
        assert np.abs(im[:, 0] - ref[:, -1].real).max() < tol(n), n
        if n > 2:
            assert np.abs(re[:, 1:] - ref[:, 1 : n // 2].real).max() < tol(n), n
        back = np.asarray(cf.irfft_packed(re, im, engine=engine)) / n
        assert np.abs(back - x).max() < tol(n), n


# ---------------------------------------------------------------------------
# Small N: the reference's coverage down to N=32
# (reference test/test.cpp:270-277, size rule common.hpp:165-177).
# ---------------------------------------------------------------------------


@engines
@pytest.mark.parametrize("n", [32, 64, 96, 128, 160, 240, 256, 320, 480])
def test_small_n_cfft_vs_numpy(n, engine, rng):
    assert cf.engine_for(n, cf.FFT_COMPLEX) == "xla"
    z = rand_complex(rng, (7, n))
    got = np.asarray(cf.fft(z, engine=engine))
    ref = np.fft.fft(z.astype(np.complex128), axis=-1)
    np.testing.assert_allclose(got, ref, atol=tol(n), rtol=0)
    back = np.asarray(cf.ifft(got.astype(np.complex64), engine=engine)) / n
    np.testing.assert_allclose(back, z, atol=tol(n), rtol=0)


@engines
@pytest.mark.parametrize("n", [32, 64, 96, 128, 192, 256, 480])
def test_small_n_rfft_packed_and_canonical(n, engine, rng):
    assert cf.engine_for(n, cf.FFT_REAL) == "xla"
    x = rng.standard_normal((5, n)).astype(np.float32)
    re, im = map(np.asarray, cf.rfft_packed(x, engine=engine))
    ref = np.fft.rfft(x.astype(np.float64), axis=-1)
    assert np.abs(re[:, 1:] - ref[:, 1 : n // 2].real).max() < tol(n)
    assert np.abs(im[:, 1:] - ref[:, 1 : n // 2].imag).max() < tol(n)
    assert np.abs(re[:, 0] - ref[:, 0].real).max() < tol(n)  # DC
    assert np.abs(im[:, 0] - ref[:, -1].real).max() < tol(n)  # Nyquist in im[0]
    back = np.asarray(cf.irfft_packed(re, im, engine=engine)) / n
    assert np.abs(back - x).max() < tol(n)
    spec = np.asarray(cf.rfft(x, engine=engine))
    np.testing.assert_allclose(spec, ref, atol=tol(n), rtol=0)


@engines
def test_small_n_conv_e2e(engine, rng):
    """The reference's convolution pipeline at its smallest tested size
    (test.cpp:270: 2^5)."""
    n = 32
    x = rng.standard_normal((4, n)).astype(np.float32)
    h = rng.standard_normal((4, n)).astype(np.float32)
    a = cf.rfft_packed_unordered(x, engine=engine)
    b = cf.rfft_packed_unordered(h, engine=engine)
    pr, pi = cf.convolve_accumulate_packed(a, b, scaling=1.0 / n)
    y = np.asarray(cf.irfft_packed_unordered(pr, pi, engine=engine))
    ref = np.fft.irfft(np.fft.rfft(x.astype(np.float64)) * np.fft.rfft(h.astype(np.float64)))
    assert np.abs(y - ref).max() < 20 * tol(n)


@engines
def test_small_n_grad(engine, rng):
    """An engine's gradient of a nonlinear loss of the packed planes
    matches the stockham engine's."""
    x = jnp.asarray(rng.standard_normal((3, 64)), jnp.float32)

    def loss(e):
        def f(v):
            re, im = cf.rfft_packed(v, engine=e)
            return jnp.sum(re**2) + jnp.sum(im**3)

        return f

    gp = np.asarray(jax.grad(loss(engine))(x))
    gs = np.asarray(jax.grad(loss("stockham"))(x))
    assert np.abs(gp - gs).max() / max(np.abs(gs).max(), 1e-9) < 1e-4


@engines
@pytest.mark.parametrize("n", [384, 768, 1920, 9216])
def test_mixed_radix_sizes(n, engine, rng):
    """Non-pow2 {2,3,5}-smooth sizes (the passf3/passf5 + radf3/radf5
    parity, reference simd/chowdsp_fft_impl_sse.cpp:182-219,298-370).
    9216 is one of the reference's own non-pow2 test sizes (test.cpp:279)."""
    z = rand_complex(rng, (2, n))
    got = np.asarray(cf.fft(z, engine=engine))
    ref = np.fft.fft(z.astype(np.complex128), axis=-1)
    assert np.abs(got - ref).max() < tol(n)
    back = np.asarray(cf.ifft(got.astype(np.complex64), engine=engine)) / n
    assert np.abs(back - z).max() < tol(n)
    x = rng.standard_normal((2, n)).astype(np.float32)
    re, im = cf.rfft_packed(x, engine=engine)
    xr = np.asarray(cf.irfft_packed(re, im, engine=engine)) / n
    assert np.abs(xr - x).max() < tol(n)
