"""FFT plan construction: radix factorization + twiddle tables.

Replacement for the reference's shared planning layer
(/root/reference/simd/chowdsp_fft_impl_common.hpp:51-228): `decompose()`
factorizes N over radices {2,3,4,5}; `rffti1_ps`/`cffti1_ps` build FFTPACK
twiddle tables; `fft_new_setup<...>` validates N and lays the tables out in
memory. Here a plan is simply a pytree of arrays (twiddles computed in
float64 and cast to float32 — higher accuracy than the reference, which
computes twiddles in float32), so "preallocated setups"
(/root/reference/chowdsp_fft.h:98-118) dissolve into ordinary array
ownership, and checkpoint/resume of a plan is trivial serialization.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Literal

import jax
import numpy as np

# Transform kinds, mirroring fft_transform_t (/root/reference/chowdsp_fft.h:70-75).
FFT_REAL: str = "real"
FFT_COMPLEX: str = "complex"

# Directions, mirroring fft_direction_t (/root/reference/chowdsp_fft.h:63-68).
FFT_FORWARD: str = "forward"
FFT_BACKWARD: str = "backward"

TransformKind = Literal["real", "complex"]

_ALLOWED_RADICES = (5, 4, 3, 2)


class InvalidSizeError(ValueError):
    """Raised when N cannot be handled (reference returns nullptr instead;
    /root/reference/simd/chowdsp_fft_impl_common.hpp:216-225)."""


def factorize(n: int) -> tuple[int, ...]:
    """Factorize ``n`` into radices drawn from {2,3,4,5}.

    Semantics mirror ``common::decompose``
    (/root/reference/simd/chowdsp_fft_impl_common.hpp:51-82): greedily pull
    out factors, preferring radix-4 (two radix-2 stages fused), then 2, 3, 5.
    Raises InvalidSizeError if a prime factor other than {2,3,5} remains.
    """
    if n < 2:
        raise InvalidSizeError(f"FFT size must be >= 2, got {n}")
    radices: list[int] = []
    m = n
    while m % 4 == 0:
        radices.append(4)
        m //= 4
    if m % 2 == 0:
        radices.append(2)
        m //= 2
    while m % 3 == 0:
        radices.append(3)
        m //= 3
    while m % 5 == 0:
        radices.append(5)
        m //= 5
    if m != 1:
        raise InvalidSizeError(
            f"FFT size {n} has prime factor(s) other than 2/3/5 (leftover {m})"
        )
    return tuple(radices)


def is_valid_size(n: int, kind: TransformKind = FFT_COMPLEX) -> bool:
    """True if ``n`` is supported for the given transform kind.

    Real transforms need N even (half-complex algorithm); both need N to
    factor over {2,3,5}. This is deliberately *looser* than the reference's
    per-backend constraints (N % 2w^2 == 0 for real, N % w^2 == 0 for
    complex, /root/reference/simd/chowdsp_fft_impl_common.hpp:165-177): the
    SIMD-width divisibility was a CPU register-layout artifact with no
    analog here.
    """
    try:
        factorize(n)
    except InvalidSizeError:
        return False
    if kind == FFT_REAL:
        # N == 2 is the degenerate length-1 "complex FFT" (identity) that
        # make_plan handles explicitly; the JUCE adapter needs it for
        # order-1 real transforms.
        return n % 2 == 0 and n >= 2
    return n >= 2


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class StagePlan:
    """One mixed-radix Stockham stage.

    At this stage the working array is viewed as (batch, r, m, s) with
    n = r*m the current sub-problem length and s the stride accumulated by
    earlier stages (n * s == N always). ``twiddle`` holds
    W_n^(j*p) = exp(-2i*pi*j*p/n) for j in [0, r), p in [0, m) as separate
    float32 real/imag planes (forward sign; backward conjugates for free at
    trace time).
    """

    radix: int  # static
    m: int  # static: n // radix
    s: int  # static: stride (product of earlier radices)
    tw_re: jax.Array  # (radix, m) float32
    tw_im: jax.Array  # (radix, m) float32

    def tree_flatten(self):
        return (self.tw_re, self.tw_im), (self.radix, self.m, self.s)

    @classmethod
    def tree_unflatten(cls, aux, children):
        radix, m, s = aux
        tw_re, tw_im = children
        return cls(radix=radix, m=m, s=s, tw_re=tw_re, tw_im=tw_im)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class FFTPlan:
    """Complete plan for a size-N transform (analog of ``FFT_Setup``,
    /root/reference/simd/chowdsp_fft_impl_sse.cpp:56-65).

    A plan is read-only and freely shareable — the same thread-safety
    contract the reference documents for its setups
    (/root/reference/chowdsp_fft.h:88-91), obtained for free from JAX's
    functional purity.

    For kind == "real", the stages describe the half-length (N//2) complex
    transform used by the half-complex real FFT algorithm, and
    ``rfft_tw_re/im`` hold the split twiddles exp(-2i*pi*k/N), k in [0, N/2).
    """

    n: int  # static: logical FFT length
    kind: str  # static: "real" | "complex"
    radices: tuple[int, ...]  # static
    stages: tuple[StagePlan, ...]
    rfft_tw_re: jax.Array | None
    rfft_tw_im: jax.Array | None

    @property
    def cfft_n(self) -> int:
        """Length of the underlying complex transform."""
        return self.n // 2 if self.kind == FFT_REAL else self.n

    @property
    def spectrum_bins(self) -> int:
        """Number of canonical frequency bins produced by a forward
        transform: N//2 + 1 for real input, N for complex."""
        return self.n // 2 + 1 if self.kind == FFT_REAL else self.n

    def tree_flatten(self):
        return (self.stages, self.rfft_tw_re, self.rfft_tw_im), (
            self.n,
            self.kind,
            self.radices,
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        n, kind, radices = aux
        stages, rfft_tw_re, rfft_tw_im = children
        return cls(
            n=n,
            kind=kind,
            radices=radices,
            stages=tuple(stages),
            rfft_tw_re=rfft_tw_re,
            rfft_tw_im=rfft_tw_im,
        )


def _stage_twiddle_np(n: int, r: int) -> tuple[np.ndarray, np.ndarray]:
    """Float64-computed twiddle table for one stage, cast to float32."""
    m = n // r
    j = np.arange(r, dtype=np.float64)[:, None]
    p = np.arange(m, dtype=np.float64)[None, :]
    ang = -2.0 * np.pi * (j * p) / float(n)
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@functools.lru_cache(maxsize=256)
def _plan_tables_np(cfft_n: int) -> tuple[tuple, ...]:
    """Cached twiddle construction for a complex transform of length
    cfft_n. Returns ((radix, m, s, tw_re, tw_im), ...) per stage.

    Prefers the native C++ planner (long-double argument-reduced tables,
    utils/native.py) and falls back to numpy float64; both are cast to
    float32 for the engines."""
    radices = factorize(cfft_n)
    native_tables = _native_stage_tables(cfft_n)
    out = []
    n, s = cfft_n, 1
    for i, r in enumerate(radices):
        m = n // r
        if native_tables is not None:
            re64, im64 = native_tables[i]
            tw_re = re64.astype(np.float32)
            tw_im = im64.astype(np.float32)
        else:
            tw_re, tw_im = _stage_twiddle_np(n, r)
        out.append((r, m, s, tw_re, tw_im))
        n, s = m, r * s
    assert n == 1
    return tuple(out)


def _native_stage_tables(cfft_n: int):
    try:
        from .utils import native
    except ImportError:  # pragma: no cover
        return None
    return native.stage_twiddles(cfft_n) if native.available() else None


@functools.lru_cache(maxsize=256)
def _rfft_tw_np(n: int) -> tuple[np.ndarray, np.ndarray]:
    try:
        from .utils import native
    except ImportError:  # pragma: no cover
        native = None
    if native is not None and native.available():
        tw = native.rfft_twiddles(n)
        if tw is not None:
            return tw[0].astype(np.float32), tw[1].astype(np.float32)
    k = np.arange(n // 2, dtype=np.float64)
    ang = -2.0 * np.pi * k / float(n)
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def make_plan(n: int, kind: TransformKind = FFT_COMPLEX) -> FFTPlan:
    """Build a plan (analog of ``fft_new_setup``,
    /root/reference/chowdsp_fft.cpp:252-256).

    Raises InvalidSizeError for unsupported N — the reference signals this by
    returning nullptr (/root/reference/simd/chowdsp_fft_impl_common.hpp:216-225);
    an exception is the idiomatic Python equivalent.
    """
    if kind not in (FFT_REAL, FFT_COMPLEX):
        raise ValueError(f"unknown transform kind: {kind!r}")
    if not is_valid_size(n, kind):
        raise InvalidSizeError(f"unsupported FFT size {n} for kind={kind}")

    cn = n // 2 if kind == FFT_REAL else n
    if cn == 1:
        # Degenerate: real N == 2 -> length-1 "complex FFT" (identity).
        stages: tuple[StagePlan, ...] = ()
        radices: tuple[int, ...] = ()
    else:
        tables = _plan_tables_np(cn)
        radices = tuple(t[0] for t in tables)
        stages = tuple(
            StagePlan(
                radix=r,
                m=m,
                s=s,
                tw_re=np.asarray(tw_re),
                tw_im=np.asarray(tw_im),
            )
            for (r, m, s, tw_re, tw_im) in tables
        )

    rfft_tw_re = rfft_tw_im = None
    if kind == FFT_REAL:
        re, im = _rfft_tw_np(n)
        rfft_tw_re, rfft_tw_im = np.asarray(re), np.asarray(im)

    return FFTPlan(
        n=n,
        kind=kind,
        radices=radices,
        stages=stages,
        rfft_tw_re=rfft_tw_re,
        rfft_tw_im=rfft_tw_im,
    )


@functools.lru_cache(maxsize=256)
def cached_plan(n: int, kind: TransformKind = FFT_COMPLEX) -> FFTPlan:
    """Memoized make_plan — used by the high-level API when no explicit plan
    is passed."""
    return make_plan(n, kind)


def save_plan(plan: FFTPlan, path: str) -> None:
    """Serialize a plan to an .npz file.

    The checkpoint/resume story (SURVEY.md section 5): the reference's
    nearest concept is caller-owned setup memory
    (``fft_new_setup_preallocated``, /root/reference/chowdsp_fft.h:98-118);
    here a plan is a pytree of arrays, so persistence is plain numpy I/O.
    """
    if not str(path).endswith(".npz"):
        path = f"{path}.npz"  # np.savez appends it; keep load_plan symmetric
    leaves, _ = jax.tree_util.tree_flatten(plan)
    np.savez(
        path,
        n=plan.n,
        kind=plan.kind,
        **{f"leaf{i}": np.asarray(leaf) for i, leaf in enumerate(leaves)},
    )


def load_plan(path: str) -> FFTPlan:
    """Inverse of :func:`save_plan`. The twiddle tables are restored
    bit-exactly (no recomputation)."""
    if not str(path).endswith(".npz"):
        path = f"{path}.npz"
    with np.load(path, allow_pickle=False) as z:
        n = int(z["n"])
        kind = str(z["kind"])
        template = make_plan(n, kind)
        treedef = jax.tree_util.tree_structure(template)
        num = len(jax.tree_util.tree_leaves(template))
        leaves = [z[f"leaf{i}"] for i in range(num)]
    return jax.tree_util.tree_unflatten(treedef, leaves)
