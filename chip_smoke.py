"""Chip smoke test: every public path of the library, once, on the GPU.

    python chip_smoke.py            # one GPU, all single-card phases
    python chip_smoke.py --four     # four GPUs: the sharded paths only
    python chip_smoke.py --rehearse [--four]   # tiny sizes on the CPU

Each phase runs a public entry point (api, stream, models, parallel) at
the size its users run, compares the result with a plain numpy/scipy
float64 reference on sampled rows, and prints one JSON line per case:
phase, shapes, device kind, max error, tolerance and its reason, and the
first-call (compile included) and warm wall times (host clock around
``block_until_ready``). Any failed phase makes the script exit non-zero;
a phase's exception is printed with its traceback and fails the run.

Without a GPU the script exits non-zero and prints no result (unless
``--rehearse``). It sets no global matmul precision, so any float32 op
that lands on TF32 shows up as an error. The last line of a successful
run is exactly ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np

FULL = dict(
    rows=16384, big_n=1 << 20, big_rows=64, sample=256,
    fir_streams=64, fir_len=1 << 20, fir_taps=4096, ref_streams=4,
    cv_ch=64, cv_len=480000, cv_taps=48000, cv_k=8, cv_calls=8, ref_ch=4,
    sdr_ch=256, sdr_len=1 << 25,
    stft_clips=256, stft_len=480000, grad_rows=1024,
    dist_n=1 << 26, dist_conv_n=1 << 22,
)
REHEARSE = dict(
    rows=64, big_n=1 << 14, big_rows=4, sample=16,
    fir_streams=4, fir_len=1 << 15, fir_taps=256, ref_streams=2,
    cv_ch=4, cv_len=24000, cv_taps=2400, cv_k=4, cv_calls=4, ref_ch=2,
    sdr_ch=16, sdr_len=1 << 16,
    stft_clips=4, stft_len=16000, grad_rows=16,
    dist_n=1 << 16, dist_conv_n=1 << 14,
)


def nvidia_smi_line() -> str:
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
        return (r.stdout.strip() or r.stderr.strip()).replace("\n", " | ")
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e})"


class Smoke:
    def __init__(self, kind: str, sizes: dict):
        self.kind = kind
        self.s = sizes
        self.failed: list[str] = []
        self.rng = np.random.default_rng(20261016)

    def report(self, phase: str, shapes, err: float, tol: float, reason: str, first_s, warm_s, **extra):
        ok = bool(np.isfinite(err) and err <= tol)
        if not ok:
            self.failed.append(phase)
        print(json.dumps({
            "phase": phase, "shapes": shapes, "device_kind": self.kind, "ok": ok,
            "max_err": float(err), "tol": float(tol), "tol_reason": reason,
            "first_s": first_s, "warm_s": warm_s, **extra,
        }), flush=True)

    def run(self, name: str, fn) -> None:
        try:
            fn()
        except Exception:  # printed in full and fails the run
            traceback.print_exc()
            self.failed.append(name)
            print(json.dumps({"phase": name, "ok": False, "error": traceback.format_exc(limit=3)}), flush=True)

    def sample(self, rows: int) -> np.ndarray:
        k = min(rows, self.s["sample"])
        return np.sort(self.rng.choice(rows, size=k, replace=False))


def timed(fn, *args, repeats: int = 3):
    """(output, first-call seconds, median warm seconds)."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    warm = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        warm.append(time.perf_counter() - t0)
    return out, first, statistics.median(warm)


def host(a, idx=None) -> np.ndarray:
    """Fetch (sampled rows of) a device array as float64/complex128."""
    v = np.asarray(a if idx is None else a[idx])
    return v.astype(np.complex128 if np.iscomplexobj(v) else np.float64)


def randn(key: int, shape):
    import jax

    return jax.jit(lambda k: jax.random.normal(k, shape, "float32"))(jax.random.key(key))


def rel_rms_tol(ref: np.ndarray, n_fft: int, parts: int = 1) -> float:
    return 2e-7 * n_fft * math.sqrt(parts) * float(np.sqrt(np.mean(np.abs(ref) ** 2)))


# ---------------------------------------------------------------------------
# single-card phases
# ---------------------------------------------------------------------------


def phase_transforms(sm: Smoke):
    import jax
    import chowdsp_fft_tpu as cf

    rp = jax.jit(cf.rfft_packed)
    irp = jax.jit(cf.irfft_packed)
    rf = jax.jit(cf.rfft)
    irf = jax.jit(cf.irfft)
    cfw = jax.jit(cf.fft)
    cbw = jax.jit(cf.ifft)
    pl = jax.jit(cf.fft_planes)
    s = sm.s
    for n, rows in ((4096, s["rows"]), (s["big_n"], s["big_rows"]), (960, s["rows"]), (3600, s["rows"])):
        x = randn(1, (rows, n))
        y = randn(2, (rows, n))
        idx = sm.sample(rows)
        xh, yh = host(x, idx), host(y, idx)
        zh = xh + 1j * yh
        R = np.fft.rfft(xh, axis=-1)
        Z = np.fft.fft(zh, axis=-1)
        errs, firsts, warms = {}, {}, {}
        (re, im), firsts["rfft_packed"], warms["rfft_packed"] = timed(rp, x)
        errs["rfft_packed"] = max(
            np.abs(host(re, idx)[:, 1:] + 1j * host(im, idx)[:, 1:] - R[:, 1 : n // 2]).max(),
            np.abs(host(re, idx)[:, 0] - R[:, 0].real).max(),
            np.abs(host(im, idx)[:, 0] - R[:, -1].real).max(),
        )
        back, firsts["irfft_packed"], warms["irfft_packed"] = timed(irp, re, im)
        errs["irfft_packed_roundtrip"] = np.abs(host(back, idx) / n - xh).max()
        del re, im, back
        spec, firsts["rfft"], warms["rfft"] = timed(rf, x)
        errs["rfft"] = np.abs(host(spec, idx) - R).max()
        back, firsts["irfft"], warms["irfft"] = timed(irf, spec)
        errs["irfft_roundtrip"] = np.abs(host(back, idx) / n - xh).max()
        del spec, back
        z = jax.lax.complex(x, y)
        zs, firsts["fft"], warms["fft"] = timed(cfw, z)
        errs["fft"] = np.abs(host(zs, idx) - Z).max()
        back, firsts["ifft"], warms["ifft"] = timed(cbw, zs)
        errs["ifft_roundtrip"] = np.abs(host(back, idx) / n - zh).max()
        del zs, back, z
        (pr, pi), firsts["fft_planes"], warms["fft_planes"] = timed(pl, x, y)
        errs["fft_planes"] = np.abs(host(pr, idx) + 1j * host(pi, idx) - Z).max()
        del pr, pi, x, y
        sm.report(
            "transforms", {"n": n, "batch": rows, "sampled_rows": len(idx)},
            max(errs.values()), 2e-7 * n,
            "reference bound 2e-7*N on unit-variance inputs (tests' differential bound); "
            "round trips compare irfft(rfft(x))/N with x",
            firsts, warms, errors={k: float(v) for k, v in errs.items()},
        )


def phase_convolve(sm: Smoke):
    import jax
    import chowdsp_fft_tpu as cf

    n, rows = 4096, sm.s["rows"]

    @jax.jit
    def unordered(x, h):
        a = cf.rfft_packed_unordered(x)
        b = cf.rfft_packed_unordered(h)
        pr, pi = cf.convolve_accumulate_packed(a, b, scaling=1.0 / n)
        return cf.irfft_packed_unordered(pr, pi)

    @jax.jit
    def composed(x, h):
        are, aim = cf.rfft_packed(x)
        bre, bim = cf.rfft_packed(h)
        return cf.convolve_irfft_packed(are, aim, bre, bim, scaling=1.0 / n)

    x, h = randn(3, (rows, n)), randn(4, (rows, n))
    idx = sm.sample(rows)
    ref = np.fft.irfft(np.fft.rfft(host(x, idx)) * np.fft.rfft(host(h, idx)), n)
    y1, f1, w1 = timed(unordered, x, h)
    y2, f2, w2 = timed(composed, x, h)
    e1 = np.abs(host(y1, idx) - ref).max()
    e2 = np.abs(host(y2, idx) - ref).max()
    sm.report(
        "convolve", {"n": n, "batch": rows, "sampled_rows": len(idx)}, max(e1, e2), 20 * 2e-7 * n,
        "20 x 2e-7*N: circular-convolution outputs of unit-variance signals scale ~sqrt(N) "
        "(the tests' packed-convolution bound)",
        {"unordered_chain": f1, "convolve_irfft_packed": f2},
        {"unordered_chain": w1, "convolve_irfft_packed": w2},
        errors={"unordered_chain": float(e1), "convolve_irfft_packed": float(e2)},
    )


def phase_fir(sm: Smoke):
    import jax
    from chowdsp_fft_tpu import stream
    from chowdsp_fft_tpu.utils import reference

    s = sm.s
    taps = s["fir_taps"]
    h = (sm.rng.standard_normal(taps) / math.sqrt(taps)).astype(np.float32)
    x = randn(5, (s["fir_streams"], s["fir_len"]))
    fn = jax.jit(lambda v: stream.fir_filter_ols(v, h))
    y, first, warm = timed(fn, x)
    idx = np.sort(sm.rng.choice(s["fir_streams"], size=s["ref_streams"], replace=False))
    ref = reference.fir_truncated(host(x, idx), h)
    err = np.abs(host(y, idx) - ref).max()
    n_fft = stream.next_fft_size(max(256, stream.next_fft_size(4 * taps) // 2) + taps - 1)
    sm.report(
        "fir", {"streams": s["fir_streams"], "samples": s["fir_len"], "taps": taps,
                "n_fft": n_fft, "sampled_streams": len(idx)},
        err, rel_rms_tol(ref, n_fft),
        "2e-7*N at the overlap-save FFT size, times the output RMS (scipy float64 reference)",
        first, warm, samples_per_s=s["fir_streams"] * s["fir_len"] / warm,
    )


def phase_convolver(sm: Smoke):
    import jax
    from chowdsp_fft_tpu.models import ConvolverConfig, MultichannelConvolver
    from chowdsp_fft_tpu.utils import reference

    s = sm.s
    ch, taps = s["cv_ch"], s["cv_taps"]
    ir = (sm.rng.standard_normal((ch, taps)) / math.sqrt(taps)).astype(np.float32)
    cfg = ConvolverConfig(channels=ch)
    t0 = time.perf_counter()
    conv = MultichannelConvolver(ir, cfg)
    setup_s = time.perf_counter() - t0
    x = randn(6, (ch, s["cv_len"]))
    off, first, warm = timed(jax.jit(conv.apply), x)
    idx = np.sort(sm.rng.choice(ch, size=s["ref_ch"], replace=False))
    ref = reference.fir_truncated(host(x, idx), ir[idx])
    n_fft, parts = conv.fir.n, conv.fir.partitions
    err = np.abs(host(off, idx) - ref).max()
    tol = rel_rms_tol(ref, n_fft, parts)
    reason = ("2e-7*N at N=2*block, times sqrt(partitions) for the accumulated partition "
              "products, times the output RMS")
    sm.report("convolver_offline", {"channels": ch, "samples": s["cv_len"], "taps": taps,
                                    "partitions": parts}, err, tol, reason, first, warm,
              ir_setup_s=setup_s, samples_per_s=ch * s["cv_len"] / warm)

    # streaming: cv_calls calls of step_k with K blocks each, vs offline
    k, b = s["cv_k"], cfg.block
    step = jax.jit(conv.fir.step_k)
    state = conv.init_state()
    outs, firsts, warms = [], [], []
    for i in range(s["cv_calls"]):
        xk = x[:, i * k * b : (i + 1) * k * b].reshape(ch, k, b)
        t0 = time.perf_counter()
        state, yk = jax.block_until_ready(step(state, xk))
        (firsts if i == 0 else warms).append(time.perf_counter() - t0)
        outs.append(yk.reshape(ch, k * b))
    got = np.asarray(jax.numpy.concatenate(outs, axis=-1), np.float64)
    span = got.shape[-1]
    offh = np.asarray(off[:, :span], np.float64)
    err_s = np.abs(got - offh).max()
    sm.report("convolver_streaming", {"channels": ch, "blocks": s["cv_calls"] * k, "k": k,
                                      "block": b}, err_s, rel_rms_tol(offh, n_fft, parts),
              "streaming == offline within the offline bound (same math, another summation order)",
              firsts[0], statistics.median(warms), block_latency_s=statistics.median(warms) / k)


def phase_sdr(sm: Smoke):
    import jax
    from chowdsp_fft_tpu.models import SDRChain, SDRChainConfig
    from chowdsp_fft_tpu.utils import reference

    s = sm.s
    c = s["sdr_ch"]
    cfg = SDRChainConfig(channels=c)
    chain = SDRChain(cfg)
    carriers = (3, c // 4, c - c // 8)
    chans = (0, 3, c // 4, c // 2 + 1, c - c // 8)
    t0 = time.perf_counter()
    iq_h = reference.fm_test_signal(s["sdr_len"], c, cfg.decimation, cfg.audio_decimation, carriers, seed=7)
    data_s = time.perf_counter() - t0
    iq = jax.device_put(iq_h)
    sel = np.asarray(chans)

    @jax.jit
    def run(v):
        z = chain.channelizer(chain.front_end(v))
        return z[sel], chain.back_end(z)

    (z, audio), first, warm = timed(run, iq)
    z_ref, a_ref = reference.sdr_chain(
        iq_h, np.asarray(chain.front_lp), np.asarray(chain.channelizer.proto),
        np.asarray(chain.audio_lp), c, cfg.decimation, cfg.audio_decimation, cfg.fm_gain, chans,
    )
    zg = host(z)
    err_z = float((np.abs(zg - z_ref).max(axis=-1) / np.abs(z_ref).max(axis=-1)).max())
    valid = reference.audio_valid(z_ref, cfg.audio_taps, cfg.audio_decimation)
    ag = host(audio, sel)
    car = [i for i, chn in enumerate(chans) if chn in carriers]
    err_a = max(float(np.abs(ag[i] - a_ref[i])[valid[i]].max()) for i in car)
    coverage = min(float(valid[i].mean()) for i in car)
    sm.report("sdr_channels", {"iq_samples": s["sdr_len"], "channels": c, "sampled": list(chans)},
              err_z, 1e-4,
              "relative to each channel's peak: float32 FIR + FFT stack vs the float64 "
              "mixer-definition channelizer (the tests' bound)",
              first, warm, data_setup_s=data_s, iq_samples_per_s=s["sdr_len"] / warm)
    sm.report("sdr_audio", {"carrier_channels": list(carriers), "valid_share": coverage},
              err_a if coverage > 0.9 else float("inf"), 1e-4,
              "radians, on carrier channels where |z| stays above half its median (the "
              "discriminator's error is |dz|/|z|; start-up transient excluded)",
              first, warm)


def phase_stft(sm: Smoke):
    import jax
    from chowdsp_fft_tpu import stream

    s = sm.s
    n_fft, hop, t = 512, 128, s["stft_len"]
    x = randn(8, (s["stft_clips"], t))
    fwd = jax.jit(lambda v: stream.stft(v, n_fft=n_fft, hop=hop))
    inv = jax.jit(lambda sp: stream.istft(sp, hop=hop, length=t))
    spec, f1, w1 = timed(fwd, x)
    back, f2, w2 = timed(inv, spec)
    clips = sm.sample(s["stft_clips"])[:8]
    frames = np.sort(sm.rng.choice(spec.shape[1], size=32, replace=False))
    w = np.asarray(stream.hann_window(n_fft), np.float64)
    pad = n_fft - hop
    xh = host(x, clips)
    xp = np.pad(xh, ((0, 0), (pad, n_fft)))
    ref = np.stack([np.fft.rfft(xp[:, f * hop : f * hop + n_fft] * w, axis=-1) for f in frames], 1)
    got = host(spec[clips][:, frames])
    err = np.abs(got - ref).max()
    err_rt = np.abs(host(back, clips) - xh).max()
    sm.report("stft", {"clips": s["stft_clips"], "samples": t, "n_fft": n_fft, "hop": hop,
                       "frames": int(spec.shape[1])},
              err, 4 * 2e-7 * n_fft,
              "4 x 2e-7*n_fft on windowed unit-variance frames (the tests' framed-FFT bound)",
              f1, w1, frames_per_s=s["stft_clips"] * spec.shape[1] / w1)
    sm.report("istft_roundtrip", {"clips": s["stft_clips"], "samples": t}, err_rt, 1e-4,
              "istft(stft(x)) == x: float32 COLA normalisation over n_fft/hop = 4 frames (the tests' bound)",
              f2, w2)
    return fwd, x


def phase_grad(sm: Smoke):
    import jax
    import jax.numpy as jnp
    import chowdsp_fft_tpu as cf

    n, rows = 4096, sm.s["grad_rows"]
    x = randn(9, (rows, n))
    wr, wi, w2 = randn(10, (rows, n // 2)), randn(11, (rows, n // 2)), randn(12, (rows, n))

    def loss_fwd(v):
        re, im = cf.rfft_packed(v)
        return jnp.sum(wr * re) + jnp.sum(wi * im)

    def loss_rt(v):
        return jnp.sum(w2 * cf.irfft_packed(*cf.rfft_packed(v)))

    g1, f1, t1 = timed(jax.jit(jax.grad(loss_fwd)), x)
    g2, f2, t2 = timed(jax.jit(jax.grad(loss_rt)), x)
    idx = sm.sample(rows)
    # analytic adjoint of the packed forward: sum_k wr cos - wi sin over
    # k < N/2 (wi[0] is the Nyquist weight, applied as (-1)^n)
    wrh, wih = host(wr, idx), host(wi, idx)
    c = np.zeros((len(idx), n), np.complex128)
    c[:, : n // 2] = wrh + 1j * np.concatenate([np.zeros((len(idx), 1)), wih[:, 1:]], 1)
    expect1 = np.real(np.fft.ifft(c, axis=-1) * n) + wih[:, :1] * (-1.0) ** np.arange(n)
    e1 = np.abs(host(g1, idx) - expect1).max()
    # the round trip is N * identity, so its adjoint is N * w2 (compared
    # after /N, like the round trips)
    e2 = np.abs(host(g2, idx) / n - host(w2, idx)).max()
    sm.report("grad", {"n": n, "batch": rows, "sampled_rows": len(idx)}, max(e1, e2), 2e-7 * n,
              "2e-7*N relative to the unit-scale cotangent (the backward transform's input)",
              {"rfft_packed": f1, "roundtrip": f2}, {"rfft_packed": t1, "roundtrip": t2},
              errors={"rfft_packed_adjoint": float(e1), "roundtrip_adjoint": float(e2)})


# ---------------------------------------------------------------------------
# four-card phases: each sharded path against the same work on one card
# ---------------------------------------------------------------------------


def four_phases(sm: Smoke):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    import chowdsp_fft_tpu as cf
    from chowdsp_fft_tpu import parallel, stream
    from chowdsp_fft_tpu.models import ConvolverConfig, MultichannelConvolver, SDRChain, SDRChainConfig
    from chowdsp_fft_tpu.parallel import dist_fft
    from chowdsp_fft_tpu.utils import reference

    s = sm.s
    nd = len(jax.devices())
    mesh = parallel.dsp_mesh(nd, axis=parallel.TIME_AXIS)
    tspec = lambda nd_: NamedSharding(mesh, P(*([None] * (nd_ - 1)), parallel.TIME_AXIS))
    one = jax.devices()[0]

    def devs(a):
        return len(a.sharding.device_set)

    def time_fir():
        ch, taps, t = s["cv_ch"], s["cv_taps"], s["cv_len"]
        h = (sm.rng.standard_normal(taps) / math.sqrt(taps)).astype(np.float32)
        x1 = jax.device_put(randn(20, (ch, t)), one)
        single, fs, ws = timed(jax.jit(lambda v: stream.partitioned_fir_apply(v, h)), x1)
        xs = jax.device_put(x1, tspec(2))
        shard, f4, w4 = timed(jax.jit(lambda v: parallel.sharded_partitioned_fir(v, h, mesh)), xs)
        ref = host(single)
        err = np.abs(host(shard) - ref).max()
        parts = -(-taps // 1024)
        sm.report("four_sharded_partitioned_fir", {"channels": ch, "samples": t, "taps": taps},
                  err, rel_rms_tol(ref, 2048, parts),
                  "vs the same filter on one card; the convolver's bound", {"one": fs, "four": f4},
                  {"one": ws, "four": w4}, out_devices=devs(shard))

    def dist():
        n = s["dist_n"]
        re1 = jax.device_put(randn(21, (n,)), one)
        im1 = jax.device_put(randn(22, (n,)), one)
        t0 = time.perf_counter()
        dist_fft._dist_twiddle(n, dist_fft._dist_split(n, nd)[0], True)
        plan_s = time.perf_counter() - t0
        single, fs, ws = timed(jax.jit(lambda r, i: cf.fft(jax.lax.complex(r, i))), re1, im1)
        rs, is_ = jax.device_put(re1, tspec(1)), jax.device_put(im1, tspec(1))
        fwd = jax.jit(lambda r, i: dist_fft.sharded_fft_planes(r, i, mesh))
        inv = jax.jit(lambda r, i: dist_fft.sharded_ifft_planes(r, i, mesh))
        (sr, si), f4, w4 = timed(fwd, rs, is_)
        (br, bi), fi, wi = timed(inv, sr, si)
        perm = dist_fft.spectrum_order(n, nd)
        x64 = host(re1) + 1j * host(im1)
        ref = np.fft.fft(x64)
        one_h = host(single)
        four_h = host(sr) + 1j * host(si)
        rel = lambda a, b: float(np.linalg.norm(a - b) / np.linalg.norm(b))
        err_one = np.abs(one_h - ref).max()
        err_four = np.abs(four_h - ref[perm]).max()
        err_rt = np.abs((host(br) + 1j * host(bi)) / n - x64).max()
        sm.report("four_dist_fft", {"n": n}, max(err_one, err_four, err_rt), 2e-7 * n,
                  "reference bound 2e-7*N (max abs, unit-variance input); round trip /N vs x",
                  {"one": fs, "four_fwd": f4, "four_inv": fi}, {"one": ws, "four_fwd": w4, "four_inv": wi},
                  errors={"one_vs_numpy": float(err_one), "four_vs_numpy": float(err_four),
                          "four_roundtrip": float(err_rt)},
                  rel_l2={"one_vs_numpy": rel(one_h, ref), "four_vs_numpy": rel(four_h, ref[perm]),
                          "four_vs_one": rel(four_h, one_h[perm])},
                  twiddle_setup_s=plan_s, out_devices=devs(sr))

    def dist_conv():
        n = s["dist_conv_n"]
        x1 = jax.device_put(randn(23, (4, n)), one)
        h1 = jax.device_put(randn(24, (4, n)), one)

        def single_fn(x, h):
            pr, pi = cf.convolve_accumulate_packed(cf.rfft_packed(x), cf.rfft_packed(h), scaling=1.0 / n)
            return cf.irfft_packed(pr, pi)

        single, fs, ws = timed(jax.jit(single_fn), x1, h1)
        xs, hs = jax.device_put(x1, tspec(2)), jax.device_put(h1, tspec(2))
        four, f4, w4 = timed(jax.jit(lambda x, h: dist_fft.sharded_rfft_convolve(x, h, mesh)), xs, hs)
        ref = host(single)
        err = np.abs(host(four) - ref).max()
        sm.report("four_sharded_rfft_convolve", {"batch": 4, "n": n}, err, 4e-6 * np.abs(ref).max(),
                  "4e-6 of the peak output (the tests' distributed-convolution bound)",
                  {"one": fs, "four": f4}, {"one": ws, "four": w4}, out_devices=devs(four))

    def sdr():
        c = s["sdr_ch"]
        cfg = SDRChainConfig(channels=c)
        chain = SDRChain(cfg)
        carriers = (3, c // 4, c - c // 8)
        iq_h = reference.fm_test_signal(s["sdr_len"], c, cfg.decimation, cfg.audio_decimation, carriers, seed=7)
        iq1 = jax.device_put(iq_h, one)
        run1 = jax.jit(lambda v: (chain.channelizer(chain.front_end(v)), chain(v)))
        (z1, single), fs, ws = timed(run1, iq1)
        step = chain.sharded_step(mesh)
        with mesh:
            four, f4, w4 = timed(step, jax.device_put(iq_h, tspec(1)))
        sel = np.asarray(carriers)
        zc = host(z1, sel)
        valid = reference.audio_valid(zc, cfg.audio_taps, cfg.audio_decimation)
        a1, a4 = host(single, sel), host(four, sel)
        err = max(float(np.abs(a4[i] - a1[i])[valid[i]].max()) for i in range(len(sel)))
        sm.report("four_sdr_sharded_step", {"iq_samples": s["sdr_len"], "channels": c}, err, 1e-4,
                  "radians on carrier channels, transient excluded (the single-card audio bound)",
                  {"one": fs, "four": f4}, {"one": ws, "four": w4}, out_devices=devs(four))

    def chan_conv():
        ch, taps, t = s["cv_ch"], s["cv_taps"], s["cv_len"]
        ir = (sm.rng.standard_normal((ch, taps)) / math.sqrt(taps)).astype(np.float32)
        conv = MultichannelConvolver(ir, ConvolverConfig(channels=ch))
        x1 = jax.device_put(randn(25, (ch, t)), one)
        single, fs, ws = timed(jax.jit(conv.apply), x1)
        cmesh = parallel.dsp_mesh(nd, axis=parallel.CHANNEL_AXIS)
        xs = parallel.shard_channels(x1, cmesh)
        four, f4, w4 = timed(conv.channel_sharded_apply(cmesh), xs)
        ref = host(single)
        err = np.abs(host(four) - ref).max()
        sm.report("four_channel_sharded_convolver", {"channels": ch, "samples": t, "taps": taps},
                  err, rel_rms_tol(ref, conv.fir.n, conv.fir.partitions),
                  "vs the same convolver on one card; the convolver's bound",
                  {"one": fs, "four": f4}, {"one": ws, "four": w4}, out_devices=devs(four))

    for name, fn in (("four_sharded_partitioned_fir", time_fir), ("four_dist_fft", dist),
                     ("four_sharded_rfft_convolve", dist_conv), ("four_sdr_sharded_step", sdr),
                     ("four_channel_sharded_convolver", chan_conv)):
        sm.run(name, fn)
        jnp.zeros(1).block_until_ready()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true", help="run only the sharded paths, on 4 devices")
    ap.add_argument("--rehearse", action="store_true", help="tiny sizes; allow the CPU backend")
    args = ap.parse_args()

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu" and not args.rehearse:
        print(f"chip_smoke.py needs a GPU; JAX found {dev.platform!r}", file=sys.stderr)
        return 1
    if args.four and len(jax.devices()) < 4:
        print(f"--four needs 4 devices; JAX found {len(jax.devices())}", file=sys.stderr)
        return 1

    t_setup = time.perf_counter()
    from chowdsp_fft_tpu.utils import compile_cache, native

    cache = compile_cache.enable()
    import chowdsp_fft_tpu as cf

    sizes = REHEARSE if args.rehearse else FULL
    print(f"nvidia-smi: {nvidia_smi_line()}")
    print(f"jax {jax.__version__}; platform={dev.platform} kind={dev.device_kind} "
          f"count={len(jax.devices())}; compile cache: {cache}")
    t0 = time.perf_counter()
    native_ok = native.available()
    for n in (4096, sizes["big_n"], 960, 3600, 512, 2048, 16384):
        cf.cached_plan(n, cf.FFT_REAL)
        cf.cached_plan(n, cf.FFT_COMPLEX)
    print(f"setup: native planner {'built' if native_ok else 'unavailable, numpy float64 tables'}; "
          f"plan tables {time.perf_counter() - t0:.3f} s; import+setup "
          f"{time.perf_counter() - t_setup:.3f} s (compile time is each phase's first_s)")

    sm = Smoke(dev.device_kind, sizes)
    if args.four:
        four_phases(sm)
    else:
        for name, fn in (("transforms", phase_transforms), ("convolve", phase_convolve),
                         ("fir", phase_fir), ("convolver", phase_convolver), ("sdr", phase_sdr),
                         ("stft", phase_stft), ("grad", phase_grad)):
            sm.run(name, lambda fn=fn: fn(sm))
        # the largest step: the STFT forward over every clip
        from chowdsp_fft_tpu import stream

        x = randn(8, (sizes["stft_clips"], sizes["stft_len"]))
        compiled = jax.jit(lambda v: stream.stft(v, n_fft=512, hop=128)).lower(x).compile()
        print(f"memory_analysis(stft step): {compiled.memory_analysis()}")
    stats = dev.memory_stats() or {}
    print(f"peak_bytes_in_use: {stats.get('peak_bytes_in_use', 'not reported')}")
    if sm.failed:
        print(f"FAILED phases: {sm.failed}", file=sys.stderr)
        return 1
    if args.rehearse:
        print(f"rehearsal OK on {dev.platform}")
        return 0
    print(json.dumps({"ok": True, "device": {"platform": dev.platform, "kind": dev.device_kind,
                                             "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
