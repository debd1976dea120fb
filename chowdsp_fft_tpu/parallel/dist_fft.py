"""Distributed FFT: one transform sharded across a device mesh.

The reference never leaves a single core; this is the multi-device
capability its decomposition was always pointing at (SURVEY.md §2 row 9:
blockwise decomposition + boundary merge). The composite four-step
factorization N = A * C maps onto a mesh holding the signal
time-contiguously (rows j of the row-major (A, C) view, n = j*C + k):

    X[q + A*t] = sum_k W_C^{±tk} * W_N^{±kq} * [ sum_j x[j*C+k] W_A^{±qj} ]

    step 1  all_to_all transpose: each device gets C/D full columns
    step 2  length-A FFTs along the now-local j axis      (api engine rows)
    step 3  twiddle W_N^{±kq}                             (local, table slab)
    step 4  all_to_all transpose back
    step 5  length-C FFTs along the local k axis          (api engine rows)

Each all_to_all moves every element once (N/D per device) — the standard
block-distributed 1-D FFT communication pattern, as plain collectives over
the mesh axis (NCCL between GPUs). The local row transforms are the public
api's planes transforms, so they run on whichever engine ``engine="auto"``
picks.

The result is returned in the transform's **distributed bin order**: the
device owning output block f holds X[(f*A/D + q_loc) + A*t] at local
position q_loc*C + t. Like the single-device engines' "unordered" layouts
(the `fft_transform_unordered` capability, /root/reference/chowdsp_fft.h:
140-145), this order is engine-private: frequency-domain elementwise work
(convolution!) is order-independent, and :func:`sharded_ifft_planes`
consumes it directly, returning natural time order. `spectrum_order`
exposes the bin permutation for tests and spectral post-processing.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from .. import api
from ..plans import FFT_COMPLEX, FFT_FORWARD, FFT_BACKWARD, is_valid_size
from .mesh import TIME_AXIS

__all__ = [
    "sharded_fft_planes",
    "sharded_ifft_planes",
    "sharded_fft_convolve",
    "sharded_rfft_planes",
    "sharded_irfft_planes",
    "sharded_rfft_convolve",
    "spectrum_order",
    "rspectrum_order",
]

@functools.lru_cache(maxsize=64)
def _dist_split(n: int, n_dev: int, real: bool = False) -> tuple[int, int]:
    """n = A * C, both factors valid plan lengths ({2,3,5}-smooth) and
    divisible by n_dev; the most balanced such split.
    Any {2,3,5}-smooth n (the reference's full size domain,
    /root/reference/simd/chowdsp_fft_impl_common.hpp:216-225) with big
    enough factors shards; pow2 is the common case, not a requirement.
    With ``real`` the level-1 factor A must be even: the local transforms
    are packed real FFTs of length A (half_a = A//2 planes, DC/Nyquist
    rows) — an odd A would silently corrupt the spectrum."""
    err = ValueError(
        f"cannot shard N={n} over {n_dev} devices (need A*C with both "
        f"factors {{2,3,5}}-smooth and divisible by {n_dev}"
        f"{', A even for the real transform' if real else ''})"
    )
    if n <= 0:
        raise err
    # enumerate divisors of the {2,3,5}-smooth part
    m, pows = n, []
    for p in (2, 3, 5):
        e = 0
        while m % p == 0:
            m //= p
            e += 1
        pows.append((p, e))
    if m != 1:
        raise err
    best = None
    for e2 in range(pows[0][1] + 1):
        for e3 in range(pows[1][1] + 1):
            for e5 in range(pows[2][1] + 1):
                a = (2**e2) * (3**e3) * (5**e5)
                c = n // a
                if a < c:
                    continue
                if real and a % 2:
                    continue
                if a % n_dev or c % n_dev:
                    continue
                if not (is_valid_size(a, FFT_COMPLEX) and is_valid_size(c, FFT_COMPLEX)):
                    continue
                if best is None or a / c < best[0] / best[1]:
                    best = (a, c)
    if best is None:
        raise err
    return best


def _pipeline_chunks_call(fn, arrays, n_chunks: int):
    """Software pipeline for batched distributed transforms: split the
    leading batch axis into ``n_chunks`` pieces and run the full
    all_to_all -> local-FFT -> all_to_all chain per piece. The chunks
    share no dataflow edge, so XLA's latency-hiding scheduler is free to
    fly chunk i+1's collective while chunk i's local FFTs occupy the
    device — the standard comm/compute-overlap recipe for
    collective-bound programs. (The unchunked transform is a strict a2a->fft->a2a->fft
    dependency chain with nothing to overlap; tests assert the chunked
    jaxpr really contains n_chunks independent collective pairs.)"""
    b = arrays[0].shape[0]
    edges = [round(i * b / n_chunks) for i in range(n_chunks + 1)]
    outs = [
        fn(*(a[s:e] for a in arrays)) for s, e in zip(edges, edges[1:]) if e > s
    ]
    if isinstance(outs[0], tuple):
        return tuple(jnp.concatenate(parts, axis=0) for parts in zip(*outs))
    return jnp.concatenate(outs, axis=0)


def _check_pipelineable(ndim: int, n_chunks: int) -> None:
    if n_chunks < 1:
        raise ValueError(f"pipeline_chunks must be >= 1, got {n_chunks}")
    if n_chunks > 1 and ndim < 2:
        raise ValueError(
            "pipeline_chunks > 1 requires a leading batch axis to split "
            "(a single unbatched transform is one strict dependency chain)"
        )


@functools.lru_cache(maxsize=16)
def _dist_twiddle(n: int, a: int, forward: bool):
    """(C, A) table W_N^(sgn * k * q) — rows k (sharded at apply time)."""
    c = n // a
    sgn = -1.0 if forward else 1.0
    k = np.arange(c, dtype=np.float64)[:, None]
    q = np.arange(a, dtype=np.float64)[None, :]
    ang = sgn * 2.0 * np.pi * (k * q) / float(n)
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def spectrum_order(n: int, n_dev: int, transform_chunks: int = 1) -> np.ndarray:
    """perm with perm[p] = the bin stored at flat position p of the
    distributed spectrum: p = q_row*C + t_col -> bin q_row + A * t_col.
    ``transform_chunks`` must match the value the forward ran with (its
    chunked second transpose relabels the stored rows — _chunk_rowmap)."""
    a, c = _dist_split(n, n_dev)
    p = np.arange(n, dtype=np.int64)
    rows = p // c
    if transform_chunks > 1:
        rows = _chunk_rowmap(a, n_dev, transform_chunks)[rows]
    return rows + a * (p % c)


def _a2a_transpose(v, axis_name, n_dev):
    """Distributed matrix transpose inside shard_map (batched).

    Local view (..., rows_loc, cols) of a row-sharded global (R, cols)
    matrix -> local (..., cols/D, R) rows of the transposed matrix: split
    the columns into D contiguous groups, all_to_all swaps the group index
    with the device axis (each element moves once), then one
    local 2D transpose. Leading batch axes ride along unsharded."""
    *lead, r_loc, cols_total = v.shape
    nb = len(lead)
    g = v.reshape(*lead, r_loc, n_dev, cols_total // n_dev)
    g = jax.lax.all_to_all(
        g, axis_name, split_axis=nb + 1, concat_axis=nb, tiled=True
    )
    # g: (..., D*rows_loc, cols/D) = all global rows x this device's column group
    g = g.reshape(*lead, n_dev * r_loc, cols_total // n_dev)
    return jnp.swapaxes(g, -1, -2)


def _a2a_transpose_chunked(v, axis_name, n_dev, chunks):
    """Forward chunked distributed transpose: slab the COLUMN axis into
    ``chunks`` contiguous groups and all_to_all each slab independently,
    concatenating results along the row axis. Each slab's collective has
    its own dataflow chain, so XLA can fly slab g+1's all_to_all while
    slab g's downstream FFT rows compute — comm/compute overlap WITHIN a
    single distributed transform (the in-transform analog of
    _pipeline_chunks_call). The price is a row relabeling: device d's
    output row (g, t) holds global column g*(cols/chunks) +
    d*(cols/(chunks*n_dev)) + t instead of d*(cols/n_dev) + t; callers
    fold the relabeling into the spectrum order (_chunk_rowmap), and
    :func:`_a2a_transpose_chunked_rev` with the SAME ``chunks`` inverts
    it exactly (its per-slab outputs concatenate back in natural column
    order)."""
    if chunks == 1:
        return _a2a_transpose(v, axis_name, n_dev)
    cols = v.shape[-1]
    if cols % (chunks * n_dev):
        raise ValueError(
            f"transform_chunks={chunks}: column count {cols} must divide "
            f"by chunks*devices ({chunks * n_dev})"
        )
    w = cols // chunks
    outs = [
        _a2a_transpose(v[..., g * w : (g + 1) * w], axis_name, n_dev)
        for g in range(chunks)
    ]
    return jnp.concatenate(outs, axis=-2)


def _a2a_transpose_chunked_rev(v, axis_name, n_dev, chunks):
    """Inverse of :func:`_a2a_transpose_chunked`: slab the ROW axis into
    ``chunks`` groups (matching the forward's row relabeling), all_to_all
    each, and concatenate along the column axis — which lands in natural
    column order (the g/d digit swap cancels)."""
    if chunks == 1:
        return _a2a_transpose(v, axis_name, n_dev)
    rows = v.shape[-2]
    if rows % chunks:
        raise ValueError(
            f"transform_chunks={chunks}: local row count {rows} must "
            f"divide by chunks"
        )
    w = rows // chunks
    outs = [
        _a2a_transpose(v[..., g * w : (g + 1) * w, :], axis_name, n_dev)
        for g in range(chunks)
    ]
    return jnp.concatenate(outs, axis=-1)


def _chunk_rowmap(rows_total: int, n_dev: int, chunks: int) -> np.ndarray:
    """rowmap[stored_global_row] = semantic row index under the chunked
    second transpose: stored row (d, g, t) holds semantic row
    g*(rows_total/chunks) + d*(rows_total/(chunks*n_dev)) + t."""
    i = np.arange(rows_total, dtype=np.int64)
    per_dev = rows_total // n_dev
    per_chunk_dev = per_dev // chunks
    d, rem = i // per_dev, i % per_dev
    g, t = rem // per_chunk_dev, rem % per_chunk_dev
    return g * (rows_total // chunks) + d * per_chunk_dev + t


def _lead_spec(ndim: int, axis_name: str) -> P:
    """PartitionSpec sharding only the last axis; leading batch axes ride
    along replicated (shard batch separately with shard_channels if
    desired)."""
    return P(*([None] * (ndim - 1) + [axis_name]))


def sharded_fft_planes(
    re: jax.Array,
    im: jax.Array,
    mesh: Mesh,
    axis_name: str = TIME_AXIS,
    pipeline_chunks: int = 1,
    transform_chunks: int = 1,
) -> tuple[jax.Array, jax.Array]:
    """Forward complex FFTs of length N distributed over the mesh, batched.

    ``re``/``im``: (..., N) float32 planes, the last axis time-contiguous
    and sharded over ``axis_name`` (leading batch axes replicated).
    Returns (..., N) spectrum planes in the distributed bin order
    (:func:`spectrum_order`), sharded over the same axis. Unscaled.
    ``pipeline_chunks`` > 1 splits the leading batch axis into that many
    independent pipeline chunks so the all_to_all of one chunk can
    overlap the local FFTs of another (see _pipeline_chunks_call).
    ``transform_chunks`` > 1 chunks the SECOND all_to_all inside each
    transform (works unbatched too): slab g+1's collective can overlap
    slab g's level-2 FFT rows. Changes the stored bin order — pass the
    same value to :func:`spectrum_order` / :func:`sharded_ifft_planes`.
    """
    _check_pipelineable(re.ndim, pipeline_chunks)
    if pipeline_chunks > 1:
        return _pipeline_chunks_call(
            lambda r, i: sharded_fft_planes(
                r, i, mesh, axis_name, transform_chunks=transform_chunks
            ),
            [re, im],
            pipeline_chunks,
        )
    n = re.shape[-1]
    n_dev = mesh.shape[axis_name]
    a, c = _dist_split(n, n_dev)
    twr_h, twi_h = _dist_twiddle(n, a, True)
    rows_loc = a // n_dev
    lead = re.shape[:-1]
    spec = _lead_spec(re.ndim, axis_name)
    tw_spec = P(axis_name, None)

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(spec, spec, tw_spec, tw_spec),
        out_specs=(spec, spec),
    )
    def run(re_loc, im_loc, twr, twi):
        xr = re_loc.reshape(*lead, rows_loc, c)
        xi = im_loc.reshape(*lead, rows_loc, c)
        # step 1: (A, C) -> each device holds C/D columns as rows (C/D, A)
        gr = _a2a_transpose(xr, axis_name, n_dev)
        gi = _a2a_transpose(xi, axis_name, n_dev)
        # step 2: length-A FFTs along the local j axis
        fr, fi = api.fft_planes(gr, gi, direction=FFT_FORWARD)
        # step 3: twiddle W_N^{-kq}; twr arrives as this device's (C/D, A) slab
        fr, fi = fr * twr - fi * twi, fr * twi + fi * twr
        # step 4: transpose back -> (A/D, C) rows (chunked: slab g+1's
        # all_to_all overlaps slab g's step-5 FFT rows; row relabeling is
        # folded into spectrum_order)
        hr = _a2a_transpose_chunked(fr, axis_name, n_dev, transform_chunks)
        hi = _a2a_transpose_chunked(fi, axis_name, n_dev, transform_chunks)
        # step 5: length-C FFTs along the local k axis:
        # position [q_row, t_col] holds X[q_row + A*t_col]
        yr, yi = api.fft_planes(hr, hi, direction=FFT_FORWARD)
        return yr.reshape(*lead, -1), yi.reshape(*lead, -1)

    return run(re, im, jnp.asarray(twr_h), jnp.asarray(twi_h))


def sharded_ifft_planes(
    re: jax.Array,
    im: jax.Array,
    mesh: Mesh,
    axis_name: str = TIME_AXIS,
    pipeline_chunks: int = 1,
    transform_chunks: int = 1,
) -> tuple[jax.Array, jax.Array]:
    """Unscaled inverse consuming the distributed bin order of
    :func:`sharded_fft_planes`; returns time-contiguous (..., N) planes
    (ifft(fft(x)) == N * x). ``transform_chunks`` must MATCH the
    forward's value (the chunked reverse transpose inverts the forward's
    row relabeling exactly)."""
    _check_pipelineable(re.ndim, pipeline_chunks)
    if pipeline_chunks > 1:
        return _pipeline_chunks_call(
            lambda r, i: sharded_ifft_planes(
                r, i, mesh, axis_name, transform_chunks=transform_chunks
            ),
            [re, im],
            pipeline_chunks,
        )
    n = re.shape[-1]
    n_dev = mesh.shape[axis_name]
    a, c = _dist_split(n, n_dev)
    twr_h, twi_h = _dist_twiddle(n, a, False)
    lead = re.shape[:-1]
    spec = _lead_spec(re.ndim, axis_name)
    tw_spec = P(axis_name, None)

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(spec, spec, tw_spec, tw_spec),
        out_specs=(spec, spec),
    )
    def run(re_loc, im_loc, twr, twi):
        yr = re_loc.reshape(*lead, a // n_dev, c)
        yi = im_loc.reshape(*lead, a // n_dev, c)
        # mirror of the forward
        hr, hi = api.fft_planes(yr, yi, direction=FFT_BACKWARD)
        fr = _a2a_transpose_chunked_rev(hr, axis_name, n_dev, transform_chunks)
        fi = _a2a_transpose_chunked_rev(hi, axis_name, n_dev, transform_chunks)
        fr, fi = fr * twr - fi * twi, fr * twi + fi * twr
        gr, gi = api.fft_planes(fr, fi, direction=FFT_BACKWARD)
        xr = _a2a_transpose(gr, axis_name, n_dev)
        xi = _a2a_transpose(gi, axis_name, n_dev)
        return xr.reshape(*lead, -1), xi.reshape(*lead, -1)

    return run(re, im, jnp.asarray(twr_h), jnp.asarray(twi_h))


# ---------------------------------------------------------------------------
# Distributed REAL transform: the reference's convolution surface is
# real-first (reference chowdsp_fft.h:147-154); this is its
# multi-device rendition. Same two-level factorization as the complex path,
# but level 1 runs the LOCAL packed rfft (half the compute and local
# traffic of a complex level 1), and only the A/2+1 Hermitian-independent
# spectral rows travel through the second all_to_all.
#
# Distributed packed real spectrum (engine-private, like every "unordered"
# layout here): planes (..., rows_p * C) sharded over the axis, viewed as
# (rows_p, C) with rows_p = A/2+1 zero-padded up to a device-divisible
# count. Row r <= A/2 at column t holds X[r + A*t] of the FULL
# length-N spectrum (rows 0 and A/2 therefore carry their entire
# Hermitian-redundant line; padding rows are zero). DC = (0,0); the global
# Nyquist X[N/2] sits in row A/2 at column C/2. The
# layout multiplies elementwise with NO DC/Nyquist patch-ups — conjugate
# redundancy is preserved by real-signal products — which is what
# sharded_rfft_convolve relies on.
# ---------------------------------------------------------------------------


def _rdist_rows(a: int, n_dev: int, chunks: int = 1) -> int:
    """A/2+1 spectral rows padded up to a multiple of the device count
    (times the transform-chunk count, so chunked second transposes slab
    evenly — the padding rows are zero either way)."""
    r = a // 2 + 1
    q = n_dev * chunks
    return -(-r // q) * q


@functools.lru_cache(maxsize=16)
def _rdist_tables(n: int, a: int):
    """(C, A/2-1) level-2 twiddles W_N^{-k1 c} for k1 in [1, A/2) and the
    (C, 1) Nyquist half-bin modulation W_2C^{-c} (float64 -> f32)."""
    c = n // a
    cc = np.arange(c, dtype=np.float64)[:, None]
    k1 = np.arange(1, a // 2, dtype=np.float64)[None, :]
    ang = -2.0 * np.pi * (cc * k1) / float(n)
    ang_ny = -np.pi * cc / float(c)
    return (
        np.cos(ang).astype(np.float32),
        np.sin(ang).astype(np.float32),
        np.cos(ang_ny).astype(np.float32),
        np.sin(ang_ny).astype(np.float32),
    )


def rspectrum_order(n: int, n_dev: int, transform_chunks: int = 1) -> np.ndarray:
    """perm[p] = index into the FULL length-N spectrum of the bin stored at
    flat position p of the distributed packed real spectrum (-1 for the
    zero padding rows). Rows 0 and A/2 hold their whole Hermitian line, so
    values > N/2 appear there (stored values equal conj(X[N - perm[p]]) ==
    X[perm[p]] for real input)."""
    a, c = _dist_split(n, n_dev, real=True)
    rows_p = _rdist_rows(a, n_dev, transform_chunks)
    pc = np.arange(c, dtype=np.int64)
    out = np.full(rows_p * c, -1, dtype=np.int64)
    rowmap = (
        _chunk_rowmap(rows_p, n_dev, transform_chunks)
        if transform_chunks > 1
        else np.arange(rows_p, dtype=np.int64)
    )
    for stored in range(rows_p):
        r = rowmap[stored]
        if r <= a // 2:
            out[stored * c : (stored + 1) * c] = r + a * pc
    return out


def sharded_rfft_planes(
    x: jax.Array,
    mesh: Mesh,
    axis_name: str = TIME_AXIS,
    pipeline_chunks: int = 1,
    transform_chunks: int = 1,
) -> tuple[jax.Array, jax.Array]:
    """Distributed real forward FFT, batched: (..., N) real float32 with
    the last axis time-sharded -> distributed packed real spectrum planes
    (..., rows_p * C), sharded over the same axis. Unscaled.
    ``pipeline_chunks`` / ``transform_chunks``: see
    :func:`sharded_fft_planes` (the chunked row order is exposed by
    ``rspectrum_order(n, n_dev, transform_chunks)``)."""
    _check_pipelineable(x.ndim, pipeline_chunks)
    if pipeline_chunks > 1:
        return _pipeline_chunks_call(
            lambda v: sharded_rfft_planes(
                v, mesh, axis_name, transform_chunks=transform_chunks
            ),
            [x],
            pipeline_chunks,
        )
    n = x.shape[-1]
    n_dev = mesh.shape[axis_name]
    a, c = _dist_split(n, n_dev, real=True)
    half_a = a // 2
    rows_p = _rdist_rows(a, n_dev, transform_chunks)
    twr_h, twi_h, nytr_h, nyti_h = _rdist_tables(n, a)
    rows_loc = a // n_dev
    lead = x.shape[:-1]
    spec = _lead_spec(x.ndim, axis_name)
    tw_spec = P(axis_name, None)

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(spec, tw_spec, tw_spec, tw_spec, tw_spec),
        out_specs=(spec, spec),
    )
    def run(x_loc, twr, twi, nytr, nyti):
        xr = x_loc.reshape(*lead, rows_loc, c)
        # step 1: transpose -> each device holds C/D stride-C subsequences
        g = _a2a_transpose(xr, axis_name, n_dev)  # (..., C/D, A) real
        # step 2: local packed rfft of length A per subsequence
        pre, pim = api.rfft_packed(g)
        # step 3: build the A/2+1 level-2 rows per column: DC (real),
        # twiddled k1 = 1..A/2-1, Nyquist pre-modulated by W_2C^{-c} (its
        # half-bin-shifted transform becomes a plain C-FFT)
        dc = pre[..., :1]
        ny = pim[..., :1]
        mid_re = pre[..., 1:] * twr - pim[..., 1:] * twi
        mid_im = pre[..., 1:] * twi + pim[..., 1:] * twr
        pad = rows_p - (half_a + 1)
        z = jnp.zeros((*dc.shape[:-1], pad), jnp.float32)
        lvl_re = jnp.concatenate([dc, mid_re, ny * nytr, z], axis=-1)
        lvl_im = jnp.concatenate([jnp.zeros_like(dc), mid_im, ny * nyti, z], axis=-1)
        # step 4: transpose back -> (..., rows_p/D, C) spectral rows
        # (chunked: see sharded_fft_planes step 4)
        hr = _a2a_transpose_chunked(lvl_re, axis_name, n_dev, transform_chunks)
        hi = _a2a_transpose_chunked(lvl_im, axis_name, n_dev, transform_chunks)
        # step 5: length-C FFTs along the local row
        yr, yi = api.fft_planes(hr, hi, direction=FFT_FORWARD)
        return yr.reshape(*lead, -1), yi.reshape(*lead, -1)

    return run(
        jnp.asarray(x, jnp.float32),
        jnp.asarray(twr_h),
        jnp.asarray(twi_h),
        jnp.asarray(nytr_h),
        jnp.asarray(nyti_h),
    )


def sharded_irfft_planes(
    re: jax.Array,
    im: jax.Array,
    mesh: Mesh,
    n: int,
    axis_name: str = TIME_AXIS,
    pipeline_chunks: int = 1,
    transform_chunks: int = 1,
) -> jax.Array:
    """Unscaled inverse of :func:`sharded_rfft_planes`: distributed packed
    real spectrum planes -> time-sharded (..., N) real float32
    (irfft(rfft(x)) == N * x). ``n`` is the signal length (the padded
    spectrum planes do not determine it).
    ``pipeline_chunks`` / ``transform_chunks`` (must match the forward's):
    see :func:`sharded_fft_planes`."""
    _check_pipelineable(re.ndim, pipeline_chunks)
    if pipeline_chunks > 1:
        return _pipeline_chunks_call(
            lambda r, i: sharded_irfft_planes(
                r, i, mesh, n, axis_name, transform_chunks=transform_chunks
            ),
            [re, im],
            pipeline_chunks,
        )
    n_dev = mesh.shape[axis_name]
    a, c = _dist_split(n, n_dev, real=True)
    half_a = a // 2
    rows_p = _rdist_rows(a, n_dev, transform_chunks)
    twr_h, twi_h, nytr_h, nyti_h = _rdist_tables(n, a)
    lead = re.shape[:-1]
    spec = _lead_spec(re.ndim, axis_name)
    tw_spec = P(axis_name, None)

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(spec, spec, tw_spec, tw_spec, tw_spec, tw_spec),
        out_specs=spec,
    )
    def run(re_loc, im_loc, twr, twi, nytr, nyti):
        yr = re_loc.reshape(*lead, rows_p // n_dev, c)
        yi = im_loc.reshape(*lead, rows_p // n_dev, c)
        # mirror of forward step 5: backward C-FFTs
        hr, hi = api.fft_planes(yr, yi, direction=FFT_BACKWARD)
        # transpose -> (..., C/D, rows_p) in natural row order (the chunked
        # reverse inverts the forward's relabeling); slice padding rows
        ur = _a2a_transpose_chunked_rev(hr, axis_name, n_dev, transform_chunks)[
            ..., : half_a + 1
        ]
        ui = _a2a_transpose_chunked_rev(hi, axis_name, n_dev, transform_chunks)[
            ..., : half_a + 1
        ]
        # un-twiddle and rebuild the local packed level-1 planes (the
        # backward C-FFT carries a factor C; imag parts of DC/Nyquist rows
        # cancel analytically)
        dc = ur[..., :1]
        mid_re = ur[..., 1:half_a] * twr + ui[..., 1:half_a] * twi
        mid_im = -ur[..., 1:half_a] * twi + ui[..., 1:half_a] * twr
        ny = ur[..., half_a:] * nytr + ui[..., half_a:] * nyti
        pre = jnp.concatenate([dc, mid_re], axis=-1)
        pim = jnp.concatenate([ny, mid_im], axis=-1)
        # local packed irfft of length A (unscaled: factor A)
        g = api.irfft_packed(pre, pim)
        # transpose back to time-contiguous rows
        xr = _a2a_transpose(g, axis_name, n_dev)
        return xr.reshape(*lead, -1)

    return run(
        jnp.asarray(re, jnp.float32),
        jnp.asarray(im, jnp.float32),
        jnp.asarray(twr_h),
        jnp.asarray(twi_h),
        jnp.asarray(nytr_h),
        jnp.asarray(nyti_h),
    )


def sharded_rfft_convolve(
    x: jax.Array,
    h: jax.Array,
    mesh: Mesh,
    axis_name: str = TIME_AXIS,
    scaling: float | jax.Array | None = None,
    pipeline_chunks: int = 1,
    transform_chunks: int = 1,
) -> jax.Array:
    """Circular convolution of real length-N signals, fully distributed
    and batched: two distributed real forwards, an elementwise spectral
    product on the distributed packed layout (no DC/Nyquist patch-ups
    needed — see the layout note above), one distributed real inverse.
    The multi-device, real-first rendition of the reference's raison d'être
    (/root/reference/chowdsp_fft.h:147-154). ``scaling`` defaults to 1/N.
    ``pipeline_chunks``: see :func:`sharded_fft_planes`.
    """
    n = x.shape[-1]
    s = (1.0 / n) if scaling is None else scaling
    ar, ai = sharded_rfft_planes(
        x, mesh, axis_name, pipeline_chunks, transform_chunks
    )
    br, bi = sharded_rfft_planes(
        h, mesh, axis_name, pipeline_chunks if h.ndim > 1 else 1, transform_chunks
    )
    pr = (ar * br - ai * bi) * s
    pi = (ar * bi + ai * br) * s
    return sharded_irfft_planes(
        pr, pi, mesh, n, axis_name, pipeline_chunks, transform_chunks
    )


def sharded_fft_convolve(
    x_re: jax.Array,
    x_im: jax.Array,
    h_re: jax.Array,
    h_im: jax.Array,
    mesh: Mesh,
    axis_name: str = TIME_AXIS,
    scaling: float | jax.Array | None = None,
    pipeline_chunks: int = 1,
    transform_chunks: int = 1,
) -> tuple[jax.Array, jax.Array]:
    """Circular convolution of two length-N complex signals, everything
    distributed: two sharded forward FFTs, an elementwise spectral product
    (order-independent, so the distributed bin order never matters — the
    multi-device rendition of the reference's unordered convolve pipeline,
    /root/reference/test/test.cpp:131-232), one sharded inverse.

    ``scaling`` defaults to 1/N, returning the true circular convolution.
    ``pipeline_chunks``: see :func:`sharded_fft_planes`.
    """
    n = x_re.shape[-1]
    s = (1.0 / n) if scaling is None else scaling
    ar, ai = sharded_fft_planes(
        x_re, x_im, mesh, axis_name, pipeline_chunks, transform_chunks
    )
    br, bi = sharded_fft_planes(
        h_re, h_im, mesh, axis_name,
        pipeline_chunks if h_re.ndim > 1 else 1, transform_chunks,
    )
    pr = (ar * br - ai * bi) * s
    pi = (ar * bi + ai * br) * s
    return sharded_ifft_planes(
        pr, pi, mesh, axis_name, pipeline_chunks, transform_chunks
    )
