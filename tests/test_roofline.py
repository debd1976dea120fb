"""The bytes-and-flops model and the peak table are the single denominator
for every roofline share the benchmark reports, so their invariants are
pinned here."""

import math

import pytest

from chowdsp_fft_tpu.utils.roofline import PEAKS, conv_cost, fft_cost, peak_for

H100 = "NVIDIA H100 80GB HBM3"


def test_rfft_bytes_and_flops_from_shape():
    c = fft_cost(4096, 1024, "real")
    # read N float32, write N/2+1 complex64, per row
    assert c.bytes == 1024 * (4096 * 4 + 2049 * 8)
    assert math.isclose(c.flops, 1024 * 2.5 * 4096 * 12)
    assert c.samples == 4096 * 1024


def test_cfft_bytes_and_flops_from_shape():
    c = fft_cost(1 << 20, 64, "complex")
    assert c.bytes == 64 * 2 * (1 << 20) * 8
    assert math.isclose(c.flops, 64 * 5.0 * (1 << 20) * 20)
    with pytest.raises(ValueError, match="kind"):
        fft_cost(256, 1, "hermitian")


def test_conv_cost_is_two_transforms_plus_product():
    n, b = 2048, 64
    c = conv_cost(n, b)
    f = fft_cost(n, b, "real")
    assert c.bytes == 2 * f.bytes + b * 3 * (n // 2 + 1) * 8
    assert math.isclose(c.flops, 2 * f.flops + b * 6 * (n // 2 + 1))
    assert c.samples == n * b


def test_h100_peaks_carry_their_source():
    p = peak_for(H100)
    assert p.bytes_per_s == 3.35e12
    assert p.f32_flops == 67e12
    assert "data sheet" in p.source
    assert all(v.source for v in PEAKS.values())


@pytest.mark.parametrize("kind", ["NVIDIA A100-SXM4-80GB", "cpu", "NVIDIA H100"])
def test_unknown_device_kind_raises(kind):
    with pytest.raises(ValueError, match="no peak table entry"):
        peak_for(kind)


@pytest.mark.parametrize("n", [256, 4096, 1 << 20])
def test_fft_is_memory_bound_on_h100(n):
    """A float32 FFT does ~2.5-6 flop/byte, below the H100's ridge of
    67e12 / 3.35e12 = 20: its least time is bytes over bandwidth, and a
    time at that bound is a share of 1."""
    p = peak_for(H100)
    for kind in ("real", "complex"):
        c = fft_cost(n, 64, kind)
        assert c.flops / c.bytes < p.f32_flops / p.bytes_per_s
        assert c.bound(p) == "memory"
        t = c.bytes / p.bytes_per_s
        assert math.isclose(c.seconds(p), t)
        assert math.isclose(c.share(2 * t, p), 0.5)


def test_bench_uses_the_model():
    import bench

    assert math.isclose(
        bench.bound_seconds(H100), fft_cost(bench.N, bench.BATCH, "real").bytes / 3.35e12
    )
    with pytest.raises(ValueError):
        bench.bound_seconds("cpu")
