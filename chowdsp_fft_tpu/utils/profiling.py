"""Timing and trace helpers.

- :func:`time_call` takes the host clock around a call that ends in
  ``block_until_ready``, after warm-up calls that compile it.
- :func:`trace` captures a ``jax.profiler`` trace of the device.
- :func:`device_kernel_seconds` reduces such a trace to the device time
  of each kernel, and :func:`device_busy_seconds` to the time in which any
  kernel ran (busy share = busy / window).
"""

from __future__ import annotations

import contextlib
import glob
import os
import statistics
import time
from typing import Callable

import jax

__all__ = [
    "time_call",
    "summarize",
    "trace",
    "device_kernel_seconds",
    "device_busy_seconds",
]


def time_call(fn: Callable, *args, warmup: int = 2, repeats: int = 10) -> list[float]:
    """Seconds of each of ``repeats`` calls of ``fn(*args)``, host clock
    around ``block_until_ready``, after ``warmup`` untimed calls."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    out = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        out.append(time.perf_counter() - t0)
    return out


def summarize(seconds: list[float]) -> dict:
    """Median and spread (min, max) of a list of times."""
    return {
        "median_s": statistics.median(seconds),
        "min_s": min(seconds),
        "max_s": max(seconds),
        "n": len(seconds),
    }


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a JAX profiler trace into ``log_dir``::

        with profiling.trace(out_dir):
            jax.block_until_ready(step(x))
    """
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def _device_events(log_dir: str):
    """(name, start_ns, duration_ns) of every kernel on the GPU planes of
    the newest trace under ``log_dir``. Only the per-stream lines are
    read; the derived "XLA Ops"/"XLA Modules" lines repeat the same time."""
    from jax.profiler import ProfileData

    paths = sorted(glob.glob(os.path.join(log_dir, "plugins", "profile", "*", "*.xplane.pb")))
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb under {log_dir}")
    data = ProfileData.from_file(paths[-1])
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if not line.name.startswith("Stream"):
                continue
            for ev in line.events:
                yield ev.name, ev.start_ns, ev.duration_ns


def device_kernel_seconds(log_dir: str) -> dict[str, float]:
    """Total device seconds per kernel name, largest first."""
    tot: dict[str, float] = {}
    for name, _, dur in _device_events(log_dir):
        tot[name] = tot.get(name, 0.0) + dur * 1e-9
    return dict(sorted(tot.items(), key=lambda kv: -kv[1]))


def device_busy_seconds(log_dir: str) -> tuple[float, float]:
    """(busy, window) seconds: the union of kernel intervals on the device,
    and the span from the first kernel's start to the last one's end."""
    iv = sorted((s, s + d) for _, s, d in _device_events(log_dir))
    if not iv:
        return 0.0, 0.0
    busy, cur_s, cur_e = 0.0, iv[0][0], iv[0][1]
    for s, e in iv[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    return busy * 1e-9, (max(e for _, e in iv) - iv[0][0]) * 1e-9
