"""GPU probes behind the bring-up findings, in one process.

    python benchmarks/probe.py [--out DIR] [engines] [fir-trace] [inverse-trace]

- ``engines``: the ``xla`` engine (cuFFT) against the ``stockham`` engine,
  real packed forward and complex forward, at N in {256, 4096, 65536,
  2^20, 960, 3600}, each with a 256 MB float32 input (>= 4x the H100's
  50 MB L2). Host clock around ``block_until_ready`` after warm-up;
  achieved bytes/s (utils/roofline.fft_cost) over the peak-table bandwidth.
- ``fir-trace``: a ``jax.profiler`` trace of ``fir_filter_ols`` at
  64 streams x 2^20 samples, 4096 taps: device time per kernel, the FFT
  library's share and the spectral product's share.
- ``inverse-trace``: the kernels of the unscaled inverse transforms, to
  see whether XLA's 1/N and the x N cost passes of their own.

Writes ``probe_*.json`` and the traces into ``--out`` (default
``probe_out/`` in the checkout) and prints a summary. Needs a GPU.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys

import numpy as np

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
OUT = REPO / "probe_out"


def smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e})"


def engines(dev):
    import jax
    import chowdsp_fft_tpu as cf
    from chowdsp_fft_tpu.utils import profiling, roofline

    try:
        peak = roofline.peak_for(dev.device_kind)
    except ValueError as e:  # times are still worth keeping; shares are not computed
        print(f"engines: {e}", flush=True)
        peak = None
    rows_out = []
    for n in (256, 4096, 65536, 1 << 20, 960, 3600):
        rows = max(1, (256 << 20) // (4 * n))
        x = jax.random.normal(jax.random.key(0), (rows, n), "float32")
        y = jax.random.normal(jax.random.key(1), (rows, n), "float32")
        z = jax.lax.complex(x, y)
        for kind, arg in (("real", x), ("complex", z)):
            cost = roofline.fft_cost(n, rows, kind)
            rec = {"n": n, "batch": rows, "kind": kind, "bytes": cost.bytes}
            for eng in ("xla", "stockham"):
                if kind == "real":
                    fn = jax.jit(lambda v, e=eng: cf.rfft_packed(v, engine=e))
                else:
                    fn = jax.jit(lambda v, e=eng: cf.fft(v, engine=e))
                t = profiling.summarize(profiling.time_call(fn, arg, warmup=2, repeats=10))
                rec[eng] = {**t, "bytes_per_s": cost.bytes / t["median_s"],
                            "share_of_peak_bw": cost.seconds(peak) / t["median_s"] if peak else float("nan")}
            rec["stockham_over_xla"] = rec["stockham"]["median_s"] / rec["xla"]["median_s"]
            rows_out.append(rec)
            print(f"engines n={n:>8} b={rows:>7} {kind:7} xla {rec['xla']['median_s']*1e3:9.3f} ms "
                  f"({rec['xla']['share_of_peak_bw']:.3f} of peak bw)  stockham "
                  f"{rec['stockham']['median_s']*1e3:9.3f} ms ({rec['stockham']['share_of_peak_bw']:.3f})  "
                  f"ratio {rec['stockham_over_xla']:.2f}", flush=True)
        del x, y, z
    return rows_out


def _kernels(log_dir, top=25):
    from chowdsp_fft_tpu.utils import profiling

    ks = profiling.device_kernel_seconds(log_dir)
    busy, window = profiling.device_busy_seconds(log_dir)
    total = sum(ks.values())
    is_fft = lambda k: any(s in k.lower() for s in ("fft", "radix", "r2c", "c2r", "c2c"))
    fft_s = sum(v for k, v in ks.items() if is_fft(k))
    return {
        "kernel_total_s": total, "busy_s": busy, "window_s": window,
        "fft_library_s": fft_s, "fft_library_share": fft_s / total if total else None,
        "top": [[k, v, v / total] for k, v in list(ks.items())[:top]],
    }


def _planes(log_dir):
    """Plane and line names with event counts: how the trace is laid out."""
    import glob

    from jax.profiler import ProfileData

    path = sorted(glob.glob(f"{log_dir}/plugins/profile/*/*.xplane.pb"))[-1]
    return [[p.name, [[ln.name, len(list(ln.events))] for ln in p.lines]]
            for p in ProfileData.from_file(path).planes]


def fir_trace(dev):
    import jax
    from chowdsp_fft_tpu import stream
    from chowdsp_fft_tpu.utils import profiling

    taps = 4096
    h = (np.random.default_rng(0).standard_normal(taps) / 64).astype(np.float32)
    x = jax.random.normal(jax.random.key(0), (64, 1 << 20), "float32")
    fn = jax.jit(lambda v: stream.fir_filter_ols(v, h))
    t = profiling.summarize(profiling.time_call(fn, x, warmup=2, repeats=10))
    (OUT / "fir_hlo.txt").write_text(fn.lower(x).compile().as_text())
    d = str(OUT / "trace_fir")
    with profiling.trace(d):
        for _ in range(3):
            jax.block_until_ready(fn(x))
    rec = {"timing": t, **_kernels(d), "planes": _planes(d)}
    # the product pass: XLA fusions other than the FFT library's kernels,
    # listed for attribution by hand
    print(f"fir-trace median {t['median_s']*1e3:.3f} ms; fft library share "
          f"{rec['fft_library_share']:.3f}; busy {rec['busy_s']:.4f}/{rec['window_s']:.4f} s", flush=True)
    for k, v, share in rec["top"][:12]:
        print(f"   {share:6.3f} {v*1e3/3:9.3f} ms/call  {k[:110]}")
    return rec


def inverse_trace(dev):
    import jax
    import jax.numpy as jnp
    import chowdsp_fft_tpu as cf
    from chowdsp_fft_tpu.utils import profiling

    n, rows = 4096, 16384
    x = jax.random.normal(jax.random.key(0), (rows, n), "float32")
    z = jax.lax.complex(x, x[::-1])
    spec = jax.jit(cf.rfft)(x)
    cases = {
        "ifft_conj_trick": (jax.jit(cf.ifft), z),
        "ifft_norm_forward": (jax.jit(lambda v: jnp.fft.ifft(v, norm="forward")), z),
        "irfft_norm_forward": (jax.jit(cf.irfft), spec),
        "rfft": (jax.jit(cf.rfft), x),
        "fft": (jax.jit(cf.fft), z),
    }
    out = {}
    for name, (fn, arg) in cases.items():
        t = profiling.summarize(profiling.time_call(fn, arg, warmup=2, repeats=10))
        d = str(OUT / f"trace_inv_{name}")
        with profiling.trace(d):
            jax.block_until_ready(fn(arg))
        out[name] = {"timing": t, **_kernels(d, top=8)}
        print(f"inverse-trace {name:20} median {t['median_s']*1e3:8.3f} ms; kernels: "
              + "; ".join(f"{k[:60]} {v*1e3:.3f}ms" for k, v, _ in out[name]["top"]), flush=True)
    return out


def main(argv) -> int:
    global OUT
    if argv[:1] == ["--out"]:
        OUT, argv = pathlib.Path(argv[1]).resolve(), argv[2:]
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"probe.py needs a GPU; JAX found {dev.platform!r}", file=sys.stderr)
        return 1
    from chowdsp_fft_tpu.utils import compile_cache

    compile_cache.enable()
    what = argv or ["engines", "fir-trace", "inverse-trace"]
    OUT.mkdir(exist_ok=True)
    head = {"nvidia_smi": smi(), "device_kind": dev.device_kind, "jax": jax.__version__}
    print(json.dumps(head), flush=True)
    fns = {"engines": engines, "fir-trace": fir_trace, "inverse-trace": inverse_trace}
    for w in what:
        res = fns[w](dev)
        (OUT / f"probe_{w}.json").write_text(json.dumps({**head, "result": res}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
