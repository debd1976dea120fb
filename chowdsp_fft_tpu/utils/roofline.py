"""Bytes-and-flops model of the library's transforms, and the peak table.

A float32 FFT does about 2.5-6 flop per byte it moves, far below a GPU's
float32 ridge (about 20 on an H100), so its least time is bytes over
memory bandwidth. The model counts, from shapes alone, the bytes a
transform must read and write once and the flops of a radix-2 count
(5 N log2 N for a complex transform, half that for a real one). Dividing
by a device's published peaks gives the least time; a measured time
divided into that is the roofline share.

Peaks are keyed by the exact ``jax.Device.device_kind`` string. A device
that is not in the table is an error, not a default.
"""

from __future__ import annotations

import dataclasses
import math

__all__ = ["Peak", "PEAKS", "peak_for", "Cost", "fft_cost", "conv_cost"]


@dataclasses.dataclass(frozen=True)
class Peak:
    bytes_per_s: float  # device memory bandwidth
    f32_flops: float  # float32 FLOP/s outside the tensor cores
    source: str


PEAKS: dict[str, Peak] = {
    "NVIDIA H100 80GB HBM3": Peak(
        bytes_per_s=3.35e12,
        f32_flops=67e12,
        source="NVIDIA H100 Tensor Core GPU data sheet, SXM part, at its 700 W limit",
    ),
}


def peak_for(device_kind: str) -> Peak:
    """The published peaks of ``device_kind``; raises for an unknown one."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no peak table entry for device kind {device_kind!r}; have {sorted(PEAKS)}"
        ) from None


@dataclasses.dataclass(frozen=True)
class Cost:
    bytes: float
    flops: float
    samples: int

    def seconds(self, peak: Peak) -> float:
        """Least time on ``peak``: the larger of the two bounds."""
        return max(self.bytes / peak.bytes_per_s, self.flops / peak.f32_flops)

    def bound(self, peak: Peak) -> str:
        return "memory" if self.bytes / peak.bytes_per_s >= self.flops / peak.f32_flops else "compute"

    def share(self, measured_s: float, peak: Peak) -> float:
        """Roofline share of a measured time: least time / measured."""
        return self.seconds(peak) / measured_s

    def __add__(self, other: "Cost") -> "Cost":
        return Cost(self.bytes + other.bytes, self.flops + other.flops, self.samples)


def _log2(n: int) -> float:
    return math.log2(n) if n > 1 else 0.0


def fft_cost(n: int, batch: int, kind: str = "real") -> Cost:
    """One batched transform of length ``n``: input read once, output
    written once. Real: N float32 in, N/2+1 complex64 out (either way).
    Complex: N complex64 in and out."""
    if kind == "real":
        io = n * 4 + (n // 2 + 1) * 8
        flops = 2.5 * n * _log2(n)
    elif kind == "complex":
        io = 2 * n * 8
        flops = 5.0 * n * _log2(n)
    else:
        raise ValueError(f"unknown transform kind {kind!r}")
    return Cost(bytes=float(batch * io), flops=float(batch * flops), samples=batch * n)


def conv_cost(n_fft: int, batch_blocks: int) -> Cost:
    """One overlap-save round per block: real forward, spectral product
    (reads the block's and the filter's spectra, writes the product) and
    real inverse."""
    bins = n_fft // 2 + 1
    product = Cost(bytes=float(batch_blocks * 3 * bins * 8), flops=float(batch_blocks * 6 * bins), samples=0)
    fwd = fft_cost(n_fft, batch_blocks, "real")
    return fwd + product + fwd
