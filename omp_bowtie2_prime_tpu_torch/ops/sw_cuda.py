"""Wrapper of the hand-written Hopper DP kernel (csrc/sw_e2e.cu).

``sw_e2e_backtrace`` returns what the JAX package's
``sw.sw_e2e_backtrace_batch`` returns: (best, bestcol, packed ops,
start col). On CUDA tensors it launches the kernel on the current stream
(or raises); on CPU tensors it runs the plain version in ops/sw.py.
``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import torch

from . import sw

LAUNCHES = 0
L_MAX = 160  # longest read the kernel takes (the aligner's l_max)
C_MAX = 257  # widest DP (window + column 0) the main path sends


def _check(name, t, dtype, shape):
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def sw_e2e_backtrace(reads, pens, rdlens, refs, wlens, p: sw.SWParams):
    """reads int8 [B, L], pens int32 [B, L], rdlens int32 [B], refs int8
    [B, W], wlens int32 [B] -> (best int32 [B], bestcol int32 [B], ops
    uint8 [B, ceil((L+W+1)/4)], start_col int32 [B])."""
    global LAUNCHES
    B, L = reads.shape
    W = refs.shape[1]
    _check("reads", reads, torch.int8, (B, L))
    _check("pens", pens, torch.int32, (B, L))
    _check("rdlens", rdlens, torch.int32, (B,))
    _check("refs", refs, torch.int8, (B, W))
    _check("wlens", wlens, torch.int32, (B,))
    if L > L_MAX or W + 1 > C_MAX:
        raise ValueError(
            f"DP shape L={L}, C={W + 1} exceeds the kernel's L<={L_MAX}, "
            f"C<={C_MAX}"
        )
    devs = {t.device for t in (reads, pens, rdlens, refs, wlens)}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")
    dev = reads.device
    if dev.type == "cpu":
        return sw.sw_e2e_backtrace_plain(reads, pens, rdlens, refs, wlens, p)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    from ._build import get_lib

    nops = -(-(L + W + 1) // 4)
    best = torch.empty(B, dtype=torch.int32, device=dev)
    bestcol = torch.empty(B, dtype=torch.int32, device=dev)
    ops = torch.empty((B, nops), dtype=torch.uint8, device=dev)
    startcol = torch.empty(B, dtype=torch.int32, device=dev)
    if B == 0:
        return best, bestcol, ops, startcol
    lib = get_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.sw_e2e_backtrace_launch(
            reads.data_ptr(), pens.data_ptr(), rdlens.data_ptr(),
            refs.data_ptr(), wlens.data_ptr(), B, L, W,
            p.rdg_open, p.rdg_ext, p.rfg_open, p.rfg_ext, p.npen, p.gbar,
            best.data_ptr(), bestcol.data_ptr(), ops.data_ptr(),
            startcol.data_ptr(), nops, stream,
        )
    if err != 0:
        raise RuntimeError(f"sw_e2e kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return best, bestcol, ops, startcol
