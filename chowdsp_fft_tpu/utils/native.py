"""ctypes bindings for the native C++ planner (libchowplan.so).

The native planner is the C++ runtime tier of this framework — the analog
of the reference's C++ planning layer (SURVEY.md section 2 row 5). Python
falls back to numpy transparently when the library is absent; build it
with `cmake -S native -B native/build && cmake --build native/build` or
just let `ensure_built()` invoke g++ once (cached).
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
import threading

import numpy as np

_REPO = pathlib.Path(__file__).resolve().parents[2]
_SRC = _REPO / "native" / "planner.cpp"
_LIB_CANDIDATES = [
    _REPO / "native" / "build" / "libchowplan.so",
    _REPO / "native" / "libchowplan.so",
]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False


def _configure(lib: ctypes.CDLL) -> ctypes.CDLL:
    i32, i64 = ctypes.c_int, ctypes.c_int64
    dptr = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")
    iptr = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
    lib.chow_factorize.restype = i32
    lib.chow_factorize.argtypes = [i32, iptr, i32]
    lib.chow_stage_table_size.restype = i64
    lib.chow_stage_table_size.argtypes = [i32]
    lib.chow_fill_stage_twiddles.restype = i32
    lib.chow_fill_stage_twiddles.argtypes = [i32, dptr]
    lib.chow_fill_rfft_twiddles.restype = i32
    lib.chow_fill_rfft_twiddles.argtypes = [i32, dptr]
    return lib


def ensure_built(force: bool = False) -> pathlib.Path | None:
    """Build libchowplan.so with g++ if missing. Returns the path or None."""
    for cand in _LIB_CANDIDATES:
        if cand.exists() and not force:
            return cand
    out = _LIB_CANDIDATES[1]
    try:
        subprocess.run(
            [
                "g++",
                "-O2",
                "-shared",
                "-fPIC",
                "-std=c++17",
                str(_SRC),
                "-o",
                str(out),
            ],
            check=True,
            capture_output=True,
            timeout=120,
        )
        return out
    except Exception:  # noqa: BLE001 - toolchain absent: numpy fallback
        return None


def get_lib() -> ctypes.CDLL | None:
    """Load (building if needed) the native planner; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = ensure_built()
        if path is None:
            return None
        try:
            _lib = _configure(ctypes.CDLL(str(path)))
        except OSError:
            _lib = None
        return _lib


def available() -> bool:
    return get_lib() is not None


# ---------------------------------------------------------------------------
# High-level wrappers (numpy in/out, float64)
# ---------------------------------------------------------------------------


def factorize(n: int) -> tuple[int, ...] | None:
    lib = get_lib()
    if lib is None:
        return None
    buf = np.zeros(64, np.int32)
    cnt = lib.chow_factorize(n, buf, 64)
    if cnt < 0:
        return None
    return tuple(int(r) for r in buf[:cnt])


def stage_twiddles(n: int) -> list[tuple[np.ndarray, np.ndarray]] | None:
    """Per-stage (re, im) float64 tables for the Stockham plan of length n,
    each shaped (r, m)."""
    lib = get_lib()
    if lib is None:
        return None
    total = lib.chow_stage_table_size(n)
    if total < 0:
        return None
    buf = np.zeros(int(total), np.float64)
    cnt = lib.chow_fill_stage_twiddles(n, buf)
    if cnt < 0:
        return None
    rad = factorize(n)
    out = []
    off = 0
    sub = n
    for r in rad:
        m = sub // r
        re = buf[off : off + r * m].reshape(r, m).copy()
        im = buf[off + r * m : off + 2 * r * m].reshape(r, m).copy()
        out.append((re, im))
        off += 2 * r * m
        sub = m
    return out


def rfft_twiddles(n: int) -> tuple[np.ndarray, np.ndarray] | None:
    lib = get_lib()
    if lib is None:
        return None
    m = n // 2
    buf = np.zeros(2 * m, np.float64)
    if lib.chow_fill_rfft_twiddles(n, buf) < 0:
        return None
    return buf[:m].copy(), buf[m:].copy()

