"""Differential + property tests for the core FFT engines.

Mirrors the reference test strategy (/root/reference/test/test.cpp:9-304):
- differential against a trusted implementation (numpy float64 here; the
  reference uses upstream pffft) with elementwise tolerance 2.0e-7 * N
  (test.cpp:9-14);
- forward, then backward normalized by 1/N, compared again (round trip);
- size sweeps: powers of two (test.cpp:270-277) and the non-pow2 set
  {96,192,384,480,640,768,9216} (test.cpp:279-285);
- convolution end-to-end through the unordered path (test.cpp:131-232).
"""

import numpy as np
import pytest

import chowdsp_fft_tpu as cf

POW2_SIZES = [32, 64, 128, 256, 512, 1024, 4096, 16384, 131072]
NON_POW2_SIZES = [96, 192, 384, 480, 640, 768, 9216]  # test.cpp:279-285
ALL_SIZES = POW2_SIZES + NON_POW2_SIZES


def tol(n):
    # Reference C++ bound: 2.0e-7 * N (test.cpp:11).
    return 2.0e-7 * n


def rand_complex(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


# ---------------------------------------------------------------------------
# Plans
# ---------------------------------------------------------------------------


def test_factorize():
    assert cf.factorize(4096) == (4,) * 6
    assert cf.factorize(32) == (4, 4, 2)
    assert np.prod(cf.factorize(9216)) == 9216
    assert np.prod(cf.factorize(480)) == 480
    with pytest.raises(cf.InvalidSizeError):
        cf.factorize(7 * 32)


def test_invalid_size_raises():
    # Reference returns nullptr for bad N (test.c:45 asserts non-null).
    with pytest.raises(cf.InvalidSizeError):
        cf.make_plan(7, cf.FFT_COMPLEX)
    assert not cf.is_valid_size(14, cf.FFT_REAL)  # 7 factor
    assert cf.is_valid_size(480, cf.FFT_REAL)


def test_plan_bytes_positive():
    assert cf.plan_bytes(4096, cf.FFT_REAL) > 0
    assert cf.vector_width_bytes() == 128  # one warp: 32 float32 lanes


# ---------------------------------------------------------------------------
# Complex transforms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", ALL_SIZES)
def test_cfft_forward_vs_numpy(n, rng):
    x = rand_complex(rng, (3, n))
    got = np.asarray(cf.fft(x))
    ref = np.fft.fft(x.astype(np.complex128), axis=-1)
    np.testing.assert_allclose(got, ref, atol=tol(n), rtol=0)


@pytest.mark.parametrize("n", ALL_SIZES)
def test_cfft_roundtrip_unscaled(n, rng):
    # BACKWARD(FORWARD(x)) == N * x (chowdsp_fft.h:128).
    x = rand_complex(rng, (2, n))
    back = np.asarray(cf.ifft(cf.fft(x))) / n
    np.testing.assert_allclose(back, x, atol=tol(n), rtol=0)


def test_cfft_backward_vs_numpy(rng):
    n = 1024
    x = rand_complex(rng, (n,))
    got = np.asarray(cf.ifft(x))
    ref = np.fft.ifft(x.astype(np.complex128)) * n
    np.testing.assert_allclose(got, ref, atol=tol(n), rtol=0)


# ---------------------------------------------------------------------------
# Real transforms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", ALL_SIZES)
def test_rfft_vs_numpy(n, rng):
    x = rng.standard_normal((4, n)).astype(np.float32)
    got = np.asarray(cf.rfft(x))
    ref = np.fft.rfft(x.astype(np.float64), axis=-1)
    np.testing.assert_allclose(got, ref, atol=tol(n), rtol=0)


@pytest.mark.parametrize("n", ALL_SIZES)
def test_rfft_roundtrip_unscaled(n, rng):
    x = rng.standard_normal((2, n)).astype(np.float32)
    back = np.asarray(cf.irfft(cf.rfft(x))) / n
    np.testing.assert_allclose(back, x, atol=tol(n), rtol=0)


def test_rfft_tiny_n2(rng):
    x = rng.standard_normal((5, 4)).astype(np.float32)
    got = np.asarray(cf.rfft(x))
    ref = np.fft.rfft(x.astype(np.float64), axis=-1)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_linearity(rng):
    n = 512
    x = rng.standard_normal((n,)).astype(np.float32)
    y = rng.standard_normal((n,)).astype(np.float32)
    lhs = np.asarray(cf.rfft(2.0 * x + 3.0 * y))
    rhs = 2.0 * np.asarray(cf.rfft(x)) + 3.0 * np.asarray(cf.rfft(y))
    # both sides are float32 computations: allow 2x the differential bound
    np.testing.assert_allclose(lhs, rhs, atol=2 * tol(n), rtol=0)


# ---------------------------------------------------------------------------
# Packed-layout converters (reference pffft layout parity)
# ---------------------------------------------------------------------------


def test_packed_real_spectrum_roundtrip(rng):
    n = 256
    x = rng.standard_normal((3, n)).astype(np.float32)
    spec = cf.rfft(x)
    packed = cf.ops.layout.to_packed_real_spectrum(spec)
    assert packed.shape == (3, n)
    unpacked = cf.ops.layout.from_packed_real_spectrum(packed)
    np.testing.assert_allclose(np.asarray(unpacked), np.asarray(spec), atol=1e-6)
    # Slot 0 = DC, slot 1 = Nyquist (chowdsp_fft_juce.cpp:58-61 layout).
    ref = np.fft.rfft(x.astype(np.float64), axis=-1)
    np.testing.assert_allclose(np.asarray(packed[:, 0]), ref[:, 0].real, atol=tol(n))
    np.testing.assert_allclose(np.asarray(packed[:, 1]), ref[:, -1].real, atol=tol(n))


def test_interleave_roundtrip(rng):
    z = rand_complex(rng, (2, 64))
    inter = cf.ops.layout.interleave_complex(z)
    assert inter.shape == (2, 128)
    back = np.asarray(cf.ops.layout.deinterleave_complex(inter))
    np.testing.assert_allclose(back, z, atol=0)


# ---------------------------------------------------------------------------
# Convolution end-to-end (test.cpp:131-232 analog)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [64, 1024, 4096])
def test_real_convolution_e2e(n, rng):
    a = rng.standard_normal((n,)).astype(np.float32)
    b = rng.standard_normal((n,)).astype(np.float32)
    scale = 1.0 / n
    A = cf.rfft_unordered(a)
    B = cf.rfft_unordered(b)
    AB = cf.convolve_accumulate(A, B, scaling=scale)
    y = np.asarray(cf.irfft_unordered(AB)) * (1.0 / n)
    # Circular convolution reference.
    ref = np.fft.irfft(np.fft.rfft(a.astype(np.float64)) * np.fft.rfft(b.astype(np.float64)))
    np.testing.assert_allclose(y * n, ref, atol=tol(n) * np.sqrt(n), rtol=0)


@pytest.mark.parametrize("n", [64, 1024])
def test_complex_convolution_e2e(n, rng):
    a = rand_complex(rng, (n,))
    b = rand_complex(rng, (n,))
    A = cf.fft_unordered(a)
    B = cf.fft_unordered(b)
    AB = cf.convolve_accumulate(A, B, scaling=1.0)
    y = np.asarray(cf.ifft_unordered(AB)) / n
    ref = np.fft.ifft(np.fft.fft(a.astype(np.complex128)) * np.fft.fft(b.astype(np.complex128))) * n / n
    np.testing.assert_allclose(y, ref, atol=tol(n) * np.sqrt(n), rtol=0)


def test_convolve_accumulate_accumulates(rng):
    A = rand_complex(rng, (33,))
    B = rand_complex(rng, (33,))
    C = rand_complex(rng, (33,))
    out = np.asarray(cf.convolve_accumulate(A, B, ab=C, scaling=0.5))
    np.testing.assert_allclose(out, C + 0.5 * A * B, atol=1e-6)


def test_accumulate(rng):
    a = rng.standard_normal((128,)).astype(np.float32)
    b = rng.standard_normal((128,)).astype(np.float32)
    np.testing.assert_allclose(np.asarray(cf.accumulate(a, b)), a + b, atol=0)


# ---------------------------------------------------------------------------
# Batch / vmap / jit compatibility
# ---------------------------------------------------------------------------


def test_vmap_matches_batch(rng):
    import jax

    n = 256
    x = rng.standard_normal((8, n)).astype(np.float32)
    direct = np.asarray(cf.rfft(x))
    vmapped = np.asarray(jax.vmap(cf.rfft)(x))
    np.testing.assert_allclose(vmapped, direct, atol=1e-6)


def test_jit_and_grad(rng):
    import jax
    import jax.numpy as jnp

    n = 128
    x = rng.standard_normal((n,)).astype(np.float32)

    @jax.jit
    def energy(v):
        s = cf.rfft(v)
        return jnp.sum(jnp.abs(s) ** 2)

    g = jax.grad(energy)(x)
    # Parseval: d/dx sum|X|^2 has a closed form ~ 2*N*x for real FFT
    # (DC/Nyquist excluded from doubling); just check finiteness + shape.
    assert g.shape == x.shape
    assert np.all(np.isfinite(np.asarray(g)))


def test_plan_save_load_roundtrip(tmp_path, rng):
    """Checkpoint/resume of plans: bit-exact .npz round trip (the
    analog of the reference's caller-owned preallocated setups,
    /root/reference/chowdsp_fft.h:98-118)."""
    from chowdsp_fft_tpu import plans as plans_mod

    p = cf.make_plan(768, cf.FFT_REAL)
    path = str(tmp_path / "plan.npz")
    plans_mod.save_plan(p, path)
    q = plans_mod.load_plan(path)
    assert q.n == p.n and q.kind == p.kind and q.radices == p.radices
    for a, b in zip(
        __import__("jax").tree_util.tree_leaves(p),
        __import__("jax").tree_util.tree_leaves(q),
    ):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    # a loaded plan drives a transform
    x = rng.standard_normal((3, 768)).astype(np.float32)
    got = np.asarray(cf.rfft(x, plan=q))
    ref = np.fft.rfft(x.astype(np.float64), axis=-1)
    assert np.abs(got - ref).max() < tol(768)


def test_plan_save_load_without_npz_suffix(tmp_path):
    """Regression (ADVICE r1): np.savez appends '.npz' when the suffix is
    missing; load_plan must open the same file save_plan wrote."""
    from chowdsp_fft_tpu import plans as plans_mod

    p = cf.make_plan(512, cf.FFT_COMPLEX)
    path = str(tmp_path / "plan_no_suffix")
    plans_mod.save_plan(p, path)
    q = plans_mod.load_plan(path)
    assert q.n == p.n and q.kind == p.kind


def test_traced_scaling(rng):
    """scaling may be a traced jax.Array (per-frame gains, learned scales)."""
    import jax
    import jax.numpy as jnp

    a = rand_complex(rng, (2, 64))
    b = rand_complex(rng, (2, 64))
    f = jax.jit(lambda s: cf.multiply_spectra(jnp.asarray(a), jnp.asarray(b), scaling=s))
    got = np.asarray(f(jnp.float32(2.0)))
    np.testing.assert_allclose(got, 2.0 * a * b, rtol=1e-5)
    fp = jax.jit(
        lambda s: cf.convolve_accumulate_packed((jnp.abs(a), jnp.abs(b)), (jnp.abs(b), jnp.abs(a)), scaling=s)
    )
    fp(jnp.float32(0.5))  # must trace without TracerBoolConversionError


def test_real_n2_degenerate(rng):
    assert cf.is_valid_size(2, cf.FFT_REAL)
    x = rng.standard_normal((3, 2)).astype(np.float32)
    got = np.asarray(cf.rfft(x, engine="stockham"))
    ref = np.fft.rfft(x.astype(np.float64))
    assert np.abs(got - ref).max() < 1e-5
