"""Native C++ planner: build, bind, and agree with numpy float64."""

import numpy as np
import pytest

from chowdsp_fft_tpu.utils import native
from chowdsp_fft_tpu import plans


@pytest.fixture(scope="module")
def lib():
    lb = native.get_lib()
    if lb is None:
        pytest.skip("native toolchain unavailable")
    return lb


def test_native_factorize(lib):
    assert native.factorize(4096) == (4,) * 6
    assert native.factorize(480) == plans.factorize(480)
    assert native.factorize(7) is None


@pytest.mark.parametrize("n", [32, 96, 1024, 4096, 1 << 20])
def test_native_stage_twiddles_match_numpy(n, lib):
    tables = native.stage_twiddles(n)
    radices = plans.factorize(n)
    assert len(tables) == len(radices)
    sub = n
    for (re, im), r in zip(tables, radices):
        m = sub // r
        j = np.arange(r)[:, None]
        p = np.arange(m)[None, :]
        ang = -2 * np.pi * (j * p % sub) / sub
        np.testing.assert_allclose(re, np.cos(ang), atol=1e-14)
        np.testing.assert_allclose(im, np.sin(ang), atol=1e-14)
        sub = m


def test_native_rfft_twiddles(lib):
    n = 8192
    re, im = native.rfft_twiddles(n)
    k = np.arange(n // 2)
    np.testing.assert_allclose(re, np.cos(-2 * np.pi * k / n), atol=1e-14)
    np.testing.assert_allclose(im, np.sin(-2 * np.pi * k / n), atol=1e-14)


def test_plans_use_native_when_available(lib):
    # A plan built while the native planner is available must still produce
    # a correct FFT (integration through plans._plan_tables_np).
    import chowdsp_fft_tpu as cf

    plans._plan_tables_np.cache_clear()
    x = np.random.default_rng(0).standard_normal((2, 1024)).astype(np.float32)
    got = np.asarray(cf.rfft(x, engine="stockham"))
    ref = np.fft.rfft(x.astype(np.float64), axis=-1)
    np.testing.assert_allclose(got, ref, atol=2e-7 * 1024, rtol=0)


@pytest.mark.parametrize("n", [1024, 4096])
def test_plans_use_numpy_tables_without_native(n, monkeypatch):
    """With the native planner unavailable the plan tables come from numpy
    float64 and the transform still meets the reference bound."""
    import chowdsp_fft_tpu as cf

    monkeypatch.setattr(native, "available", lambda: False)
    plans._plan_tables_np.cache_clear()
    plans._rfft_tw_np.cache_clear()
    try:
        plan = plans.make_plan(n, plans.FFT_REAL)
        x = np.random.default_rng(1).standard_normal((2, n)).astype(np.float32)
        got = np.asarray(cf.rfft(x, plan=plan, engine="stockham"))
        ref = np.fft.rfft(x.astype(np.float64), axis=-1)
        np.testing.assert_allclose(got, ref, atol=2e-7 * n, rtol=0)
    finally:
        plans._plan_tables_np.cache_clear()
        plans._rfft_tw_np.cache_clear()
