"""Headline benchmark: rfft N=4096 batch=1024 on one GPU.

Prints the platform, device kind, device count and the card's
``nvidia-smi`` name and power limit, then ONE JSON line:
{"metric", "value", "unit", "median_s", "min_s", "max_s", "bytes_bound_share", ...}.

Each time is the host clock around one jitted call that ends in
``block_until_ready``, after warm-up calls that compile it. The bytes
bound is the bytes the transform must move once (utils/roofline.fft_cost)
over the device's memory bandwidth from the peak table; an unknown device
kind is an error. Without a GPU the script exits non-zero.
"""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np

N = 4096
BATCH = 1024
REPEATS = 50


def bound_seconds(device_kind: str) -> float:
    """Least time of the headline transform on ``device_kind``."""
    from chowdsp_fft_tpu.utils.roofline import fft_cost, peak_for

    return fft_cost(N, BATCH, "real").seconds(peak_for(device_kind))


def nvidia_smi_line() -> str:
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
        return r.stdout.strip() or r.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"


def main() -> int:
    import jax

    from chowdsp_fft_tpu.utils import compile_cache, profiling

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py needs a GPU; JAX found {dev.platform!r}", file=sys.stderr)
        return 1
    compile_cache.enable()
    import chowdsp_fft_tpu as cf

    print(f"platform={dev.platform} kind={dev.device_kind} count={len(jax.devices())}")
    print(f"nvidia-smi: {nvidia_smi_line()}")

    rng = np.random.default_rng(0)
    x = jax.device_put(rng.standard_normal((BATCH, N)).astype(np.float32))
    fn = jax.jit(cf.rfft_packed)
    stats = profiling.summarize(profiling.time_call(fn, x, warmup=3, repeats=REPEATS))
    med = stats["median_s"]
    print(json.dumps({
        "metric": f"rfft_packed N={N} batch={BATCH} throughput (1 GPU)",
        "value": BATCH * N / med / 1e6,
        "unit": "Msamples/s",
        **stats,
        "bytes_bound_share": bound_seconds(dev.device_kind) / med,
        "device_kind": dev.device_kind,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
