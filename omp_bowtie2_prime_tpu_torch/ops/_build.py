"""Build the package's CUDA kernels with nvcc at first use.

Every ``csrc/*.cu`` source is compiled for ``sm_90a`` (one nvcc per
source, all started together) and linked into one shared library with a
plain C interface, under ``_build/`` beside the package (git-ignored).
The library's name carries a hash of the sources, the headers they share
(``csrc/*.cuh``) and the flags, so an edit triggers a rebuild; ptxas'
report of registers, shared memory and spills is kept beside it
(``.log``). A failed build raises with nvcc's stderr: there is no
fallback. Every function takes the directory of the sources and defaults
to the package's ``csrc``: a timing tool may build and load a copy of it
beside the package's own (scripts/torch_dp_variants.py).
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}  # by source directory


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin)")


def sources(csrc: str = CSRC) -> list[str]:
    return sorted(glob.glob(os.path.join(csrc, "*.cu")))


def library_path(csrc: str = CSRC) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sources(csrc) + sorted(glob.glob(os.path.join(csrc, "*.cuh"))):
        with open(s, "rb") as f:
            h.update(os.path.basename(s).encode() + f.read())
    return os.path.join(BUILD_DIR, f"libbt2kernels_{h.hexdigest()[:16]}.so")


def build(csrc: str = CSRC) -> str:
    """Compile the kernels unless a library for these sources exists."""
    path = library_path(csrc)
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    tmp = f"{path}.{os.getpid()}"
    jobs = []
    for src in sources(csrc):
        obj = f"{tmp}.{os.path.basename(src)}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", src, "-o", obj]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    report = []
    failed = None
    for cmd, _obj, proc in jobs:  # wait for all, so none outlives a failure
        _out, err = proc.communicate()
        report.append(err)
        if proc.returncode != 0 and failed is None:
            failed = (proc.returncode, cmd, err)
    objs = [obj for _cmd, obj, _proc in jobs]
    try:
        if failed is None:
            cmd = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", f"{tmp}.so",
                   *objs]
            r = subprocess.run(cmd, capture_output=True, text=True)
            if r.returncode != 0:
                failed = (r.returncode, cmd, r.stderr)
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    if failed is not None:
        rc, cmd, err = failed
        raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{err}")
    with open(f"{path}.log", "w") as f:
        f.write("".join(report))
    os.replace(f"{tmp}.so", path)
    return path


def get_lib(csrc: str = CSRC) -> ctypes.CDLL:
    """The kernel library, built on first call, with argtypes set."""
    with _lock:
        if csrc not in _libs:
            lib = ctypes.CDLL(build(csrc))
            P, I, Z = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
            # inputs, (B, L, W), penalties, out, ops, nops_bytes, trace
            # scratch and its size, stream
            lib.sw_e2e_backtrace_launch.restype = I
            lib.sw_e2e_backtrace_launch.argtypes = (
                [P] * 5 + [I] * 3 + [I] * 6 + [P, P, I, P, Z, P]
            )
            lib.sw_local_backtrace_launch.restype = I
            lib.sw_local_backtrace_launch.argtypes = (
                [P] * 5 + [I] * 3 + [I] * 7 + [P, P, I, P, Z, P]
            )
            # the FM kernels (csrc/fm_search.cu); a copy of csrc/ without
            # that source (scripts/torch_dp_variants.py) builds the DPs only
            LL = ctypes.c_longlong
            if hasattr(lib, "fm_search_launch"):
                # seeds, seed bytes, valid, (B, L), blocks, nblocks, fchr,
                # ftab, nftab, zoff, nrows, ftab_k, sub_ftab, top, bot,
                # stream
                lib.fm_search_launch.restype = I
                lib.fm_search_launch.argtypes = (
                    [P, I, P, I, I, P, LL, P, P, LL, LL, LL, I, I, P, P, P])
                # rows, valid, R, blocks, nblocks, fchr, sa, nsa, zoff,
                # srate, out, stream
                lib.fm_walk_launch.restype = I
                lib.fm_walk_launch.argtypes = (
                    [P, P, I, P, LL, P, P, LL, LL, I, P, P])
            _libs[csrc] = lib
        return _libs[csrc]
