"""Overlap-save (OLS) FFT convolution: single-FFT and partitioned forms.

This is the streaming layer the reference's convolution primitives exist to
serve: its test fixture runs unordered-forward x2 -> convolve-accumulate ->
unordered-backward (/root/reference/test/test.cpp:131-232), which is one
block of exactly this algorithm. Here it is scaled to long streams and
batches of channels:

- blocks are framed with static shapes and processed as one batched FFT
  (the batch axis is the FFT batch);
- the frequency-domain work uses the *unordered* transforms +
  convolve_accumulate, so no reorder pass is ever paid — the same
  order-independence trick the reference's API encodes
  (/root/reference/chowdsp_fft.h:140-154);
- partitioned convolution keeps a frequency-domain delay line (FDL) and
  accumulates partitions with convolve_accumulate, the standard
  low-latency long-FIR structure built from the reference's
  "ab += a*b*scaling" primitive (sse:1603-1645).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .. import api

__all__ = [
    "next_fft_size",
    "fir_filter_ols",
    "PartitionedFIR",
    "partitioned_fir_apply",
]


def next_fft_size(n: int) -> int:
    """Smallest power-of-two FFT size >= n. A {2,3,5}-smooth size would be
    up to ~1.6x smaller; whether that pays on the GPU is not measured yet,
    so the stream layer keeps powers of two."""
    p = 1
    while p < n:
        p <<= 1
    return p


def _frame_overlap(x: jax.Array, block: int, overlap: int) -> jax.Array:
    """(..., T) -> (..., num_blocks, overlap + block) frames, stride =
    block, left-padded with `overlap` zeros (and right-padded to whole
    blocks). Static shapes throughout — jit/XLA friendly.

    Built from whole-row reshapes + contiguous slices + one concat: frame i
    = rows[i] ++ rows[i+1][:rem] ... — no XLA gather (fancy-indexed
    windows)."""
    t = x.shape[-1]
    nblocks = -(-t // block)
    frame_len = overlap + block
    k = -(-frame_len // block)  # rows each frame spans
    target_len = (nblocks - 1 + k) * block  # whole rows, covers the last frame
    x = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(overlap, target_len - overlap - t)])
    rows = x.reshape(*x.shape[:-1], nblocks - 1 + k, block)
    parts = []
    for j in range(k):
        take = min(block, frame_len - j * block)
        parts.append(rows[..., j : j + nblocks, :take])
    return jnp.concatenate(parts, axis=-1)


def fir_filter_ols(
    x: jax.Array,
    h: jax.Array,
    block: int | None = None,
    engine: str = "auto",
) -> jax.Array:
    """Linear FIR filtering of (..., T) streams by (taps,) or broadcastable
    (..., taps) filters via single-partition overlap-save.

    Returns the same-length (truncated to T) filtered stream, matching
    scipy.signal.lfilter(h, 1, x) semantics (zero initial state).
    """
    x = jnp.asarray(x, jnp.float32)
    h = jnp.asarray(h, jnp.float32)
    taps = h.shape[-1]
    t = x.shape[-1]
    if block is None:
        block = max(256, next_fft_size(4 * taps) // 2)
    n = next_fft_size(block + taps - 1)
    block = n - (taps - 1)

    plan = api.cached_plan(n, api.FFT_REAL)
    hpad = jnp.pad(h, [(0, 0)] * (h.ndim - 1) + [(0, n - taps)])
    # Packed-plane pipeline throughout (fft_transform_unordered +
    # pffft-packed layout, as the reference's convolution loop uses).
    hre, him = api.rfft_packed_unordered(hpad, plan=plan, engine=engine)
    if h.ndim > 1:
        # Filters with batch dims broadcast against the stream's batch
        # dims, not the frames axis — insert the frames axis.
        hre, him = hre[..., None, :], him[..., None, :]

    frames = _frame_overlap(x, block, taps - 1)  # (..., nb, n)
    xre, xim = api.rfft_packed_unordered(frames, plan=plan, engine=engine)
    if h.ndim == 1:
        # Shared filter: one spectral product broadcast over all frames.
        yblocks = api.convolve_irfft_packed(
            xre, xim, hre, him, scaling=1.0 / n, plan=plan, engine=engine,
            ordered=False,
        )
    else:
        yre, yim = api.convolve_accumulate_packed(
            (xre, xim), (hre, him), scaling=1.0 / n
        )
        yblocks = api.irfft_packed_unordered(yre, yim, plan=plan, engine=engine)
    # Overlap-save: the first taps-1 samples of each block are circularly
    # corrupted; keep the last `block` samples.
    y = yblocks[..., taps - 1 :]
    y = y.reshape(*y.shape[:-2], -1)
    return y[..., :t]


class PartitionedFIR:
    """Uniformly partitioned overlap-save convolution (frequency-domain
    delay line). The long impulse response is split into P partitions of
    `block` taps; each incoming block costs one rfft + P
    convolve_accumulates + one irfft — the structure that makes the
    reference's fused "ab += a*b*scaling" primitive the hot op
    (/root/reference/simd/chowdsp_fft_impl_sse.cpp:1603-1645).

    Functional style: `init_state()` returns the FDL pytree; `step()` maps
    (state, block) -> (state, filtered block). Use `partitioned_fir_apply`
    for whole (batched) streams via lax.scan.
    """

    def __init__(self, h: jax.Array, block: int = 1024, engine: str = "auto"):
        h = jnp.asarray(h, jnp.float32)
        self.block = int(block)
        self.n = 2 * self.block  # 50% overlap-save
        self.engine = engine
        self.plan = api.cached_plan(self.n, api.FFT_REAL)
        taps = h.shape[-1]
        self.partitions = -(-taps // self.block)
        hpad = jnp.pad(
            h, [(0, 0)] * (h.ndim - 1) + [(0, self.partitions * self.block - taps)]
        )
        hparts = hpad.reshape(*h.shape[:-1], self.partitions, self.block)
        hparts = jnp.pad(
            hparts, [(0, 0)] * (h.ndim) + [(0, self.n - self.block)]
        )
        # (..., P, N/2) packed-plane frequency-domain partitions — the
        # packed layout keeps the whole FDL in two f32 planes (exactly the
        # reference's working format for its convolve loop,
        # /root/reference/simd/chowdsp_fft_impl_sse.cpp:1603-1645).
        self.h_re, self.h_im = api.rfft_packed_unordered(
            hparts, plan=self.plan, engine=self.engine
        )

    def init_state(self, batch_shape: tuple[int, ...] = ()) -> dict:
        m = self.n // 2
        return {
            "fdl_re": jnp.zeros((*batch_shape, self.partitions, m), jnp.float32),
            "fdl_im": jnp.zeros((*batch_shape, self.partitions, m), jnp.float32),
            "prev": jnp.zeros((*batch_shape, self.block), jnp.float32),
        }

    def apply_offline(self, x: jax.Array) -> jax.Array:
        """Filter whole (..., T) streams: all block spectra from ONE batched
        rfft, the FDL as a causal shift-and-accumulate along the (major)
        block axis — identical math to scanning :meth:`step`, without a
        sequential scan."""
        x = jnp.asarray(x, jnp.float32)
        t = x.shape[-1]
        nb = -(-t // self.block)
        frames = _frame_overlap(x, self.block, self.block)[..., :nb, :]
        xre, xim = api.rfft_packed_unordered(frames, plan=self.plan, engine=self.engine)
        acc = None
        pad_cfg = [(0, 0)] * (xre.ndim - 2)
        for p in range(self.partitions):
            if p >= nb:
                # IR longer than the signal: partitions with no source block
                # contribute nothing (p=0 always runs since nb >= 1).
                break
            if p == 0:
                xr_p, xi_p = xre, xim
            else:
                xr_p = jnp.pad(xre[..., : nb - p, :], pad_cfg + [(p, 0), (0, 0)])
                xi_p = jnp.pad(xim[..., : nb - p, :], pad_cfg + [(p, 0), (0, 0)])
            hr = self.h_re[..., p, :]
            hi = self.h_im[..., p, :]
            if hr.ndim > 1:  # per-stream filters broadcast below the block axis
                hr, hi = hr[..., None, :], hi[..., None, :]
            acc = api.convolve_accumulate_packed(
                (xr_p, xi_p), (hr, hi), ab=acc, scaling=1.0 / self.n
            )
        yfull = api.irfft_packed_unordered(
            acc[0], acc[1], plan=self.plan, engine=self.engine
        )
        y = yfull[..., self.block :].reshape(*x.shape[:-1], nb * self.block)
        return y[..., :t]

    def step_k(self, state: dict, xk: jax.Array) -> tuple[dict, jax.Array]:
        """Process K blocks at once: (..., K, block) -> (..., K, block).

        The latency/throughput knob between :meth:`step` (K=1, one set of
        kernel launches per block) and :meth:`apply_offline` (whole
        stream): a caller
        with a K-block latency budget gets all K spectra from ONE batched
        rfft and the FDL becomes K contiguous-slice accumulates against
        the carried spectrum history. Identical math to K sequential
        :meth:`step` calls (pinned by test).
        """
        k = xk.shape[-2]
        # frames: frame j = [block_{j-1} | block_j], with block_{-1} = prev
        blocks_all = jnp.concatenate(
            [state["prev"][..., None, :], jnp.asarray(xk, jnp.float32)], axis=-2
        )
        frames = jnp.concatenate(
            [blocks_all[..., :-1, :], blocks_all[..., 1:, :]], axis=-1
        )  # (..., K, n)
        xre, xim = api.rfft_packed_unordered(frames, plan=self.plan, engine=self.engine)
        # E rows: spectra of steps t-P .. t+K-1 (ascending)
        e_re = jnp.concatenate([jnp.flip(state["fdl_re"], axis=-2), xre], axis=-2)
        e_im = jnp.concatenate([jnp.flip(state["fdl_im"], axis=-2), xim], axis=-2)
        p_total = self.partitions
        acc = None
        for p in range(p_total):
            hr = self.h_re[..., p, :]
            hi = self.h_im[..., p, :]
            if hr.ndim > 1:  # per-stream filters broadcast below the block axis
                hr, hi = hr[..., None, :], hi[..., None, :]
            acc = api.convolve_accumulate_packed(
                (
                    e_re[..., p_total - p : p_total - p + k, :],
                    e_im[..., p_total - p : p_total - p + k, :],
                ),
                (hr, hi),
                ab=acc,
                scaling=1.0 / self.n,
            )
        yfull = api.irfft_packed_unordered(
            acc[0], acc[1], plan=self.plan, engine=self.engine
        )
        new_state = {
            "fdl_re": jnp.flip(e_re[..., k : k + p_total, :], axis=-2),
            "fdl_im": jnp.flip(e_im[..., k : k + p_total, :], axis=-2),
            "prev": jnp.asarray(xk, jnp.float32)[..., -1, :],
        }
        return new_state, yfull[..., self.block :]

    def step(self, state: dict, xblock: jax.Array) -> tuple[dict, jax.Array]:
        """Process one (..., block) input block -> (..., block) output."""
        frame = jnp.concatenate([state["prev"], xblock], axis=-1)  # (..., n)
        xre, xim = api.rfft_packed_unordered(frame, plan=self.plan, engine=self.engine)
        fdl_re = jnp.roll(state["fdl_re"], 1, axis=-2)
        fdl_im = jnp.roll(state["fdl_im"], 1, axis=-2)
        fdl_re = fdl_re.at[..., 0, :].set(xre)
        fdl_im = fdl_im.at[..., 0, :].set(xim)
        # y = sum_p fdl[p] * h[p]  — P fused packed convolve-accumulates.
        acc = None
        for p in range(self.partitions):
            acc = api.convolve_accumulate_packed(
                (fdl_re[..., p, :], fdl_im[..., p, :]),
                (self.h_re[..., p, :], self.h_im[..., p, :]),
                ab=acc,
                scaling=1.0 / self.n,
            )
        yfull = api.irfft_packed_unordered(
            acc[0], acc[1], plan=self.plan, engine=self.engine
        )
        y = yfull[..., self.block :]  # valid half (overlap-save)
        return {"fdl_re": fdl_re, "fdl_im": fdl_im, "prev": xblock}, y


def partitioned_fir_apply(
    x: jax.Array,
    h: jax.Array,
    block: int = 1024,
    engine: str = "auto",
    streaming: bool = False,
    chunk: int = 1,
) -> jax.Array:
    """Filter (..., T) streams with a long FIR `h` through the uniformly
    partitioned FDL. Returns (..., T) (zero-state, truncated).

    ``streaming=False`` (default, offline): ALL block spectra come from one
    batched rfft and the FDL becomes a shift-and-accumulate along the block
    axis — no lax.scan. ``streaming=True`` runs the
    block-sequential scan (identical math; the real-time state semantics);
    ``chunk=K`` (with streaming) scans over K-block :meth:`PartitionedFIR.step_k`
    calls instead — the latency/throughput knob (K blocks of latency buys
    ~K-fold fewer sequential kernel launches)."""
    fir = PartitionedFIR(h, block=block, engine=engine)
    t = x.shape[-1]
    nb = -(-t // fir.block)

    if streaming:
        k = max(1, min(chunk, nb))
        nchunks = -(-nb // k)
        pad_t = nchunks * k * fir.block - t
        xp = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, pad_t)])
        blocks = xp.reshape(*x.shape[:-1], nchunks, k, fir.block)
        blocks = jnp.moveaxis(blocks, -3, 0)  # (nchunks, ..., K, block)
        state = fir.init_state(x.shape[:-1])

        if k == 1:
            def body(st, xb):
                return fir.step(st, xb[..., 0, :])
        else:
            def body(st, xb):
                return fir.step_k(st, xb)

        _, ys = jax.lax.scan(body, state, blocks)
        # ys: (nchunks, ..., [K,] block) -> (..., T)
        ys = jnp.moveaxis(ys, 0, -2 if k == 1 else -3)
        y = ys.reshape(*x.shape[:-1], nchunks * k * fir.block)
        return y[..., :t]

    return fir.apply_offline(x)
