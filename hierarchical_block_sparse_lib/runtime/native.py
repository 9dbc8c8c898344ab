"""Host-side symbolic planning — C++ fast path with numpy fallback.

The reference's quadtree walk is host C++; this design keeps a (much
smaller) host-side role: exact symbolic sizing of SpGEMM (pair and output
block counts), add-union and COO-block counting, used to pick static
capacities before tracing.  The hot path is `csrc/libhbsm_host.so`
(built by `make -C csrc`; built on first use, and rebuilt when its
sources are newer, if a toolchain is present), loaded via ctypes;
vectorized numpy fallbacks keep the library dependency-free.
`have_native()` says which one runs.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess

import numpy as np

_SENTINEL = np.int32(np.iinfo(np.int32).max)

_log = logging.getLogger(__name__)

_LIB = None
_LIB_TRIED = False


def _csrc_dir() -> str:
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(os.path.dirname(pkg), "csrc")


def _stale(so: str) -> bool:
    """The library is missing or older than a source it is built from."""
    if not os.path.exists(so):
        return True
    built = os.path.getmtime(so)
    return any(
        os.path.getmtime(os.path.join(_csrc_dir(), src)) > built
        for src in ("hbsm_host.cc", "Makefile")
        if os.path.exists(os.path.join(_csrc_dir(), src))
    )


def _load_lib():
    global _LIB, _LIB_TRIED
    if _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    so = os.path.join(_csrc_dir(), "libhbsm_host.so")
    if _stale(so) and os.environ.get("HBSM_NO_NATIVE_BUILD") != "1":
        # One build attempt per process; on failure the numpy fallback
        # runs and the reason is logged once.
        try:
            subprocess.run(
                ["make", "-C", _csrc_dir(), "-B", "libhbsm_host.so"],
                check=True,
                capture_output=True,
                text=True,
                timeout=120,
            )
        except (OSError, subprocess.SubprocessError) as e:
            detail = getattr(e, "stderr", None) or e
            _log.warning(
                "native planner build failed; using the numpy fallback: %s",
                detail,
            )
    if not os.path.exists(so):
        return None
    try:
        lib = ctypes.CDLL(so)
    except OSError as e:
        _log.warning("native planner load failed (%s); numpy fallback", e)
        return None
    i32p = ctypes.POINTER(ctypes.c_int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32, i64, f64 = ctypes.c_int32, ctypes.c_int64, ctypes.c_double
    lib.hbsm_plan_spgemm.restype = None
    lib.hbsm_plan_spgemm.argtypes = [i32p, i64, i32p, i64, i32, i32, i32, i64p]
    lib.hbsm_plan_spgemm_ex.restype = None
    lib.hbsm_plan_spgemm_ex.argtypes = [
        i32p, i64, i32p, i64, i32, i32, i32, i64p,
    ]
    lib.hbsm_plan_spamm.restype = None
    lib.hbsm_plan_spamm.argtypes = [
        i32p, f32p, i64, i32p, f32p, i64, i32, i32, i32, f64, i64p,
    ]
    lib.hbsm_plan_add.restype = i64
    lib.hbsm_plan_add.argtypes = [i32p, i64, i32p, i64]
    lib.hbsm_count_coo_blocks.restype = i64
    lib.hbsm_count_coo_blocks.argtypes = [i32p, i32p, i64, i32, i32]
    lib.hbsm_symbolic_spgemm.restype = i64
    lib.hbsm_symbolic_spgemm.argtypes = [
        i32p, i64, i32p, i64, i32, i32, i64, i32p, i32p, i32p,
    ]
    _LIB = lib
    return _LIB


def have_native() -> bool:
    return _load_lib() is not None


def _c32(a):
    return np.ascontiguousarray(np.asarray(a, np.int32))


def _ptr32(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


# --------------------------------------------------------------------------
# plan_spgemm
# --------------------------------------------------------------------------


def plan_spgemm_numpy(a_ids, b_ids, a_nbc, b_nbr, b_nbc):
    """Exact (n_pairs, n_out_blocks) for C = A @ B, numpy host path."""
    del b_nbr
    a_ids = np.asarray(a_ids, np.int64)
    b_ids = np.asarray(b_ids, np.int64)
    a_ids = a_ids[a_ids != _SENTINEL]
    b_ids = b_ids[b_ids != _SENTINEL]
    a_row, a_col = a_ids // a_nbc, a_ids % a_nbc
    b_row, b_col = b_ids // b_nbc, b_ids % b_nbc
    lo = np.searchsorted(b_row, a_col, side="left")
    hi = np.searchsorted(b_row, a_col, side="right")
    cnt = hi - lo
    n_pairs = int(cnt.sum())
    out_ids = set()
    offs = np.concatenate([[0], np.cumsum(cnt)])
    CHUNK = 1 << 22
    for s in range(0, n_pairs, CHUNK):
        p = np.arange(s, min(s + CHUNK, n_pairs))
        e = np.searchsorted(offs, p, side="right") - 1
        t = p - offs[e]
        cid = a_row[e] * b_nbc + b_col[lo[e] + t]
        out_ids.update(np.unique(cid).tolist())
    return n_pairs, len(out_ids)


def plan_spgemm(a_ids, b_ids, a_nbc, b_nbr, b_nbc):
    """Exact (n_pairs, n_out_blocks); C++ fast path when available."""
    lib = _load_lib()
    a_ids = _c32(a_ids)
    b_ids = _c32(b_ids)
    if lib is not None:
        out = np.zeros(2, np.int64)
        lib.hbsm_plan_spgemm(
            _ptr32(a_ids), a_ids.size, _ptr32(b_ids), b_ids.size,
            np.int32(a_nbc), np.int32(b_nbr), np.int32(b_nbc),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
        return int(out[0]), int(out[1])
    return plan_spgemm_numpy(a_ids, b_ids, a_nbc, b_nbr, b_nbc)


def plan_spgemm_ex_numpy(a_ids, b_ids, a_nbc, b_nbc):
    """(n_pairs, n_out, max_b_row, max_c_row) — numpy fallback."""
    a_ids = np.asarray(a_ids, np.int64)
    b_ids = np.asarray(b_ids, np.int64)
    a_ids = a_ids[a_ids != _SENTINEL]
    b_ids = b_ids[b_ids != _SENTINEL]
    a_row, a_col = a_ids // a_nbc, a_ids % a_nbc
    b_row, b_col = b_ids // b_nbc, b_ids % b_nbc
    max_b_row = int(np.bincount(b_row).max()) if b_ids.size else 0
    lo = np.searchsorted(b_row, a_col, side="left")
    hi = np.searchsorted(b_row, a_col, side="right")
    cnt = hi - lo
    n_pairs = int(cnt.sum())
    offs = np.concatenate([[0], np.cumsum(cnt)])
    out_ids = set()
    CHUNK = 1 << 22
    for s in range(0, n_pairs, CHUNK):
        p = np.arange(s, min(s + CHUNK, n_pairs))
        e = np.searchsorted(offs, p, side="right") - 1
        t = p - offs[e]
        cid = a_row[e] * b_nbc + b_col[lo[e] + t]
        out_ids.update(np.unique(cid).tolist())
    if out_ids:
        oid = np.fromiter(out_ids, np.int64)
        max_c_row = int(np.bincount(oid // b_nbc).max())
    else:
        max_c_row = 0
    return n_pairs, len(out_ids), max_b_row, max_c_row


def plan_spgemm_ex(a_ids, b_ids, a_nbc, b_nbr, b_nbc):
    """Exact (n_pairs, n_out, max_b_row, max_c_row): pair and output
    counts plus the largest B and C block-row."""
    lib = _load_lib()
    a_ids = _c32(a_ids)
    b_ids = _c32(b_ids)
    if lib is not None:
        out = np.zeros(4, np.int64)
        lib.hbsm_plan_spgemm_ex(
            _ptr32(a_ids), a_ids.size, _ptr32(b_ids), b_ids.size,
            np.int32(a_nbc), np.int32(b_nbr), np.int32(b_nbc),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
        return tuple(int(v) for v in out)
    return plan_spgemm_ex_numpy(a_ids, b_ids, a_nbc, b_nbc)


# --------------------------------------------------------------------------
# plan_spamm — norm-filtered pairs (error-controlled multiply)
# --------------------------------------------------------------------------


def plan_spamm_numpy(a_ids, a_norms, b_ids, b_norms, a_nbc, b_nbc, tau):
    a_ids = np.asarray(a_ids, np.int64)
    b_ids = np.asarray(b_ids, np.int64)
    a_norms = np.asarray(a_norms, np.float64)
    b_norms = np.asarray(b_norms, np.float64)
    av = a_ids != _SENTINEL
    bv = b_ids != _SENTINEL
    a_ids, a_norms = a_ids[av], a_norms[av]
    b_ids, b_norms = b_ids[bv], b_norms[bv]
    a_row, a_col = a_ids // a_nbc, a_ids % a_nbc
    b_row, b_col = b_ids // b_nbc, b_ids % b_nbc
    lo = np.searchsorted(b_row, a_col, side="left")
    hi = np.searchsorted(b_row, a_col, side="right")
    cnt = hi - lo
    offs = np.concatenate([[0], np.cumsum(cnt)])
    n_all = int(cnt.sum())
    n_pairs = 0
    out_ids = set()
    CHUNK = 1 << 22
    for s in range(0, n_all, CHUNK):
        p = np.arange(s, min(s + CHUNK, n_all))
        e = np.searchsorted(offs, p, side="right") - 1
        t = p - offs[e]
        j = lo[e] + t
        keep = a_norms[e] * b_norms[j] > tau
        n_pairs += int(keep.sum())
        cid = (a_row[e] * b_nbc + b_col[j])[keep]
        out_ids.update(np.unique(cid).tolist())
    return n_pairs, len(out_ids)


def spamm_error_bound(a_ids, a_norms, b_ids, b_norms, a_nbc, b_nbc, tau):
    """Sum of ||A_ik||*||B_kj|| over SKIPPED pairs — the a-priori
    Frobenius bound on ||C_exact - C_spamm|| for the given tau
    (triangle inequality over dropped block products)."""
    a_ids = np.asarray(a_ids, np.int64)
    b_ids = np.asarray(b_ids, np.int64)
    a_norms = np.asarray(a_norms, np.float64)
    b_norms = np.asarray(b_norms, np.float64)
    av = a_ids != _SENTINEL
    bv = b_ids != _SENTINEL
    a_ids, a_norms = a_ids[av], a_norms[av]
    b_ids, b_norms = b_ids[bv], b_norms[bv]
    a_col = a_ids % a_nbc
    b_row = b_ids // b_nbc
    lo = np.searchsorted(b_row, a_col, side="left")
    hi = np.searchsorted(b_row, a_col, side="right")
    cnt = hi - lo
    offs = np.concatenate([[0], np.cumsum(cnt)])
    n_all = int(cnt.sum())
    bound = 0.0
    CHUNK = 1 << 22
    for s0 in range(0, n_all, CHUNK):
        p = np.arange(s0, min(s0 + CHUNK, n_all))
        e = np.searchsorted(offs, p, side="right") - 1
        t = p - offs[e]
        prod = a_norms[e] * b_norms[lo[e] + t]
        bound += float(prod[prod <= tau].sum())
    return bound


def plan_spamm(a_ids, a_norms, b_ids, b_norms, a_nbc, b_nbr, b_nbc, tau):
    """Exact (n_pairs, n_out) when products with
    ||A_ik||*||B_kj|| <= tau are skipped (SpAMM error control)."""
    lib = _load_lib()
    a_ids = _c32(a_ids)
    b_ids = _c32(b_ids)
    a_norms = np.ascontiguousarray(np.asarray(a_norms, np.float32))
    b_norms = np.ascontiguousarray(np.asarray(b_norms, np.float32))
    if lib is not None:
        out = np.zeros(2, np.int64)
        lib.hbsm_plan_spamm(
            _ptr32(a_ids),
            a_norms.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            a_ids.size,
            _ptr32(b_ids),
            b_norms.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            b_ids.size,
            np.int32(a_nbc), np.int32(b_nbr), np.int32(b_nbc),
            float(tau),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
        return int(out[0]), int(out[1])
    return plan_spamm_numpy(a_ids, a_norms, b_ids, b_norms, a_nbc, b_nbc, tau)


# --------------------------------------------------------------------------
# plan_add / count_coo_blocks
# --------------------------------------------------------------------------


def plan_add(a_ids, b_ids) -> int:
    """|union| of two sorted id lists — exact capacity for add."""
    lib = _load_lib()
    a_ids = _c32(a_ids)
    b_ids = _c32(b_ids)
    if lib is not None:
        return int(
            lib.hbsm_plan_add(_ptr32(a_ids), a_ids.size, _ptr32(b_ids), b_ids.size)
        )
    a = np.asarray(a_ids)
    b = np.asarray(b_ids)
    u = np.union1d(a[a != _SENTINEL], b[b != _SENTINEL])
    return int(u.size)


def count_coo_blocks(rows, cols, block_size: int, nb_cols: int) -> int:
    """Distinct blocks touched by COO triplets — exact from_coo capacity."""
    lib = _load_lib()
    rows = _c32(rows)
    cols = _c32(cols)
    if lib is not None:
        return int(
            lib.hbsm_count_coo_blocks(
                _ptr32(rows), _ptr32(cols), rows.size,
                np.int32(block_size), np.int32(nb_cols),
            )
        )
    bid = (np.asarray(rows) // block_size).astype(np.int64) * nb_cols + (
        np.asarray(cols) // block_size
    )
    return int(np.unique(bid).size)


# --------------------------------------------------------------------------
# symbolic_spgemm — full host pair lists
# --------------------------------------------------------------------------


def symbolic_spgemm(a_ids, b_ids, a_nbc, b_nbc, pair_cap: int):
    """Host-side full symbolic phase: (a_idx, b_idx, c_id, total) with the
    first min(total, pair_cap) entries filled, sorted by c_id.  Unfilled
    tail is SENTINEL.  C++ only (numpy callers use spgemm_symbolic on
    device instead)."""
    lib = _load_lib()
    a_ids = _c32(a_ids)
    b_ids = _c32(b_ids)
    a_idx = np.full(pair_cap, 0, np.int32)
    b_idx = np.full(pair_cap, 0, np.int32)
    c_id = np.full(pair_cap, _SENTINEL, np.int32)
    if lib is None:
        raise RuntimeError("native library unavailable; build csrc first")
    total = lib.hbsm_symbolic_spgemm(
        _ptr32(a_ids), a_ids.size, _ptr32(b_ids), b_ids.size,
        np.int32(a_nbc), np.int32(b_nbc), np.int64(pair_cap),
        _ptr32(a_idx), _ptr32(b_idx), _ptr32(c_id),
    )
    return a_idx, b_idx, c_id, int(total)
