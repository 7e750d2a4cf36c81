"""Native (C++) host components, loaded via ctypes.

Counterpart of omp_bowtie2_prime_tpu/native.py: SA-IS suffix sorting,
the BWT pass and the inverse BWT for index construction and .bt2 import,
and the batched CIGAR/MD/stats finisher (csrc/btcore.cpp); the blockwise
build's difference-cover ranking and bucket sort (csrc/blockwise.cpp).
This is host code, not a kernel of the card. The shared library is
compiled with g++ from both sources at first use into ``_build/`` beside
the package (git-ignored), under a name that carries a hash of the
sources, so an edit to either rebuilds. Without a compiler the functions
here return None and the callers take their numpy / Python paths, except
``inverse_bwt`` and the blockwise sort, which have none and raise.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_PKG = os.path.dirname(os.path.abspath(__file__))
_SRCS = [os.path.join(_PKG, "csrc", name)
         for name in ("btcore.cpp", "blockwise.cpp")]
_BUILD_DIR = os.path.join(_PKG, "_build")

_lock = threading.Lock()
_lib = None
_tried = False
FINISH_CALLS = 0  # batches finished by the native library
_calls_lock = threading.Lock()  # align workers finish batches at once


def _build() -> str | None:
    if not all(os.path.exists(src) for src in _SRCS):
        return None
    h = hashlib.sha256()
    for src in _SRCS:
        with open(src, "rb") as f:
            h.update(f.read())
    tag = h.hexdigest()[:16]
    path = os.path.join(_BUILD_DIR, f"libbtcore_{tag}.so")
    if os.path.exists(path):
        return path
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-o", tmp, *_SRCS]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
    except (subprocess.SubprocessError, FileNotFoundError):
        return None
    os.replace(tmp, path)
    return path


def get_lib():
    """The btcore shared library, or None if unavailable."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        path = _build()
        if path is None:
            return None
        lib = ctypes.CDLL(path)
        P = ctypes.c_void_p
        lib.bt_sais_u8_i32.restype = ctypes.c_int
        lib.bt_sais_u8_i32.argtypes = [P, P, ctypes.c_int32, ctypes.c_int32]
        lib.bt_sais_u8_i64.restype = ctypes.c_int
        lib.bt_sais_u8_i64.argtypes = [P, P, ctypes.c_int64, ctypes.c_int64]
        lib.bt_bwt_from_sa_i32.restype = ctypes.c_int32
        lib.bt_bwt_from_sa_i32.argtypes = [P] * 3 + [ctypes.c_int32]
        lib.bt_bwt_from_sa_i64.restype = ctypes.c_int64
        lib.bt_bwt_from_sa_i64.argtypes = [P] * 3 + [ctypes.c_int64]
        lib.bt_ibwt_i32.restype = ctypes.c_int
        lib.bt_ibwt_i32.argtypes = [P, P, ctypes.c_int32, ctypes.c_int32,
                                    ctypes.c_int]
        lib.bt_ibwt_i64.restype = ctypes.c_int
        lib.bt_ibwt_i64.argtypes = [P, P, ctypes.c_int64, ctypes.c_int64,
                                    ctypes.c_int]
        lib.bt_dc_ranks_i64.restype = ctypes.c_int
        lib.bt_dc_ranks_i64.argtypes = [
            P, ctypes.c_int64, ctypes.c_int64, P, ctypes.c_int32,
            P, ctypes.c_int64, P,
        ]
        lib.bt_dc_sort_i64.restype = ctypes.c_int
        lib.bt_dc_sort_i64.argtypes = [
            P, ctypes.c_int64, ctypes.c_int64, P, ctypes.c_int32,
            P, ctypes.c_int64, P, P, ctypes.c_int64,
        ]
        lib.bt_finish_batch.restype = ctypes.c_int64
        lib.bt_finish_batch.argtypes = [
            P, ctypes.c_int64, ctypes.c_int64, P, P,
            P, ctypes.c_int64, P,
            P, ctypes.c_int64,
            P, ctypes.c_int64,
            P, ctypes.c_int64, P,
            P, P,
        ]
        _lib = lib
        return _lib


def finish_batch(ops_mat, start_cols, wstarts, reads_mat, srcs, text,
                 cig_slot: int = 64, md_slot: int = 384,
                 row_los=None, clip_his=None):
    """Native CIGAR/MD/stats for a batch of backtraced alignments. Returns
    (cig_buf [n, cig_slot] bytes-2d holding ready ASCII CIGAR strings,
    md_buf bytes-2d, stats [n, 9] int64 = {nm,xm,xo,xg,xn,span,ciglen,
    mdlen,ns}) or None if the library is unavailable. Records with
    stats[k, 6] == -1 overflowed their slot (the caller finishes them in
    Python). row_los/clip_his (local mode): leading/trailing soft-clip
    char counts per record: the replay starts at read index row_los[k]
    and xS runs wrap the CIGAR."""
    global FINISH_CALLS
    lib = get_lib()
    if lib is None:
        return None
    with _calls_lock:
        FINISH_CALLS += 1
    ops_mat = np.ascontiguousarray(ops_mat, np.uint8)
    start_cols = np.ascontiguousarray(start_cols, np.int32)
    wstarts = np.ascontiguousarray(wstarts, np.int64)
    srcs = np.ascontiguousarray(srcs, np.int64)
    reads_mat = np.ascontiguousarray(reads_mat, np.int8)
    text = np.ascontiguousarray(text, np.int8)
    if row_los is not None:
        row_los = np.ascontiguousarray(row_los, np.int32)
        clip_his = np.ascontiguousarray(clip_his, np.int32)
    n = len(ops_mat)
    cig_buf = np.zeros((n, cig_slot), np.uint8)
    md_buf = np.zeros((n, md_slot), np.uint8)
    stats = np.zeros((n, 9), np.int64)
    lib.bt_finish_batch(
        ops_mat.ctypes.data, np.int64(ops_mat.shape[1]), np.int64(n),
        start_cols.ctypes.data, wstarts.ctypes.data,
        reads_mat.ctypes.data, np.int64(reads_mat.shape[1]), srcs.ctypes.data,
        text.ctypes.data, np.int64(len(text)),
        cig_buf.ctypes.data, np.int64(cig_slot),
        md_buf.ctypes.data, np.int64(md_slot),
        stats.ctypes.data,
        row_los.ctypes.data if row_los is not None else None,
        clip_his.ctypes.data if clip_his is not None else None,
    )
    return cig_buf, md_buf, stats


def bwt_from_sa_native(text: np.ndarray, sa: np.ndarray):
    """(bwt, zoff) via the fused prefetched pass, or None without the lib.
    text: int8/uint8 codes; sa: int32/int64 [len(text)+1]."""
    lib = get_lib()
    if lib is None:
        return None
    t = np.ascontiguousarray(text.view(np.uint8) if text.dtype == np.int8
                             else text, np.uint8)
    n = len(sa)
    out = np.empty(n, np.int8)
    if sa.dtype == np.int32:
        zoff = lib.bt_bwt_from_sa_i32(out.ctypes.data, t.ctypes.data,
                                      sa.ctypes.data, np.int32(n))
    else:
        sa = np.ascontiguousarray(sa, np.int64)
        zoff = lib.bt_bwt_from_sa_i64(out.ctypes.data, t.ctypes.data,
                                      sa.ctypes.data, np.int64(n))
    if zoff < 0:
        return None
    return out, int(zoff)


def suffix_array_sais(text: np.ndarray) -> np.ndarray | None:
    """SA of text (codes 0..3) + implicit sentinel, via native SA-IS.
    Matches utils.suffix_array.suffix_array's contract: returns int32
    (int64 for >=2^31-1 rows) [len(text)+1] with SA[0] == len(text).
    None if the library is absent."""
    lib = get_lib()
    if lib is None:
        return None
    t = np.asarray(text)
    n = len(t) + 1
    s = np.empty(n, np.uint8)
    s[: n - 1] = t + 1  # shift codes to 1..4; sentinel 0
    s[n - 1] = 0
    if n < (1 << 31):
        sa = np.empty(n, np.int32)
        rc = lib.bt_sais_u8_i32(
            s.ctypes.data, sa.ctypes.data, np.int32(n), np.int32(5)
        )
    else:
        sa = np.empty(n, np.int64)
        rc = lib.bt_sais_u8_i64(
            s.ctypes.data, sa.ctypes.data, np.int64(n), np.int64(5)
        )
    if rc != 0:
        return None
    return sa  # native dtype; upconverting 8B/row doubles build RAM traffic


def inverse_bwt(bwt: np.ndarray, zoff: int,
                sentinel_last: bool = False) -> np.ndarray:
    """The text of BWT codes (the sentinel's slot at zoff stored as 0).
    sentinel_last selects bowtie2's $-sorts-last row convention (see
    csrc/btcore.cpp ibwt_core). Raises if the native library is
    unavailable or the BWT is invalid."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native btcore unavailable for inverse BWT")
    bwt = np.ascontiguousarray(bwt, np.uint8)
    n_rows = len(bwt)
    conv = 1 if sentinel_last else 0
    text = np.empty(n_rows - 1, np.uint8)
    if n_rows < (1 << 31):
        rc = lib.bt_ibwt_i32(bwt.ctypes.data, text.ctypes.data,
                             np.int32(n_rows), np.int32(zoff), conv)
    else:
        rc = lib.bt_ibwt_i64(bwt.ctypes.data, text.ctypes.data,
                             np.int64(n_rows), np.int64(zoff), conv)
    if rc != 0:
        raise ValueError(f"inverse BWT failed (code {rc})")
    return text
