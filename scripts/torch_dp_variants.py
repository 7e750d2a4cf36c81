#!/usr/bin/env python3
"""Times the port's two DP kernels as built from several source trees, in
one process on one card, so that variants of a kernel are compared under
the same clocks and on the same problems.

    python3 scripts/torch_dp_variants.py \
        [--csrc NAME=DIR ...] [--shape LABEL=B,L,W[,ragged] ...] [--reps N]

Each ``--csrc`` names a directory that holds a copy of
``omp_bowtie2_prime_tpu_torch/csrc`` (``sw_e2e.cu``, ``sw_local.cu``,
``sw_dp.cuh``), edited or not; without any, the package's own sources are
timed under the name ``tree``. Every tree is built by the package's
``ops/_build.py`` (nvcc, sm_90a; ``get_lib(csrc)``) and its library's two
launch functions are called as ``ops/sw_cuda.py`` calls them, with a
scratch 16 bytes a row larger than the package's ``trace_bytes``, since a
tree of another revision may size its scratch otherwise, on problems made
as ``chip_smoke.py`` makes them
(``dp_problems``: reads of 900 to 1,024 bases, or of 1 to L with
``ragged``, which also sows N runs and empty lanes as the bridge's
launches have them). The trees are timed in turns, ``--reps`` rounds of
one timing each, and the least time of a tree at a shape is reported
beside the shape's bound (``chip_smoke.dp_bound``). A variant may compute
wrong results (a kernel with a part taken out, for its time alone): unless
``--check`` is given nothing is compared. With ``--check`` every tree's
outputs must equal those of the first tree.

Prints the card's name and power limit, one line a (tree, kernel, shape)
and, last, one JSON object with all of them. Needs a CUDA device.
"""

import argparse
import functools
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from omp_bowtie2_prime_tpu_torch.ops import _build, sw_cuda  # noqa: E402

DEFAULT_SHAPES = ["B64=64,1024,1056", "B256=256,1024,1056",
                  "B512=512,1024,1056", "B1024=1024,1024,1056",
                  "B2048=2048,1024,1056", "bridge=256,1024,1088,ragged"]


def load_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def parse_args(argv=None):
    """The trees as (name, directory) and the shapes as (label, B, L, W,
    ragged), beside the other options."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--csrc", action="append", default=[])
    ap.add_argument("--shape", action="append", default=[])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--check", action="store_true")
    a = ap.parse_args(argv)
    trees = [s.split("=", 1) for s in a.csrc] or [["tree", _build.CSRC]]
    a.trees = [(n, os.path.abspath(d)) for n, d in trees]
    a.shapes = []
    for spec in a.shape or DEFAULT_SHAPES:
        label, dims = spec.split("=")
        dims = dims.split(",")
        if len(dims) not in (3, 4) or dims[3:] not in ([], ["ragged"]):
            ap.error(f"--shape {spec}: expected LABEL=B,L,W[,ragged]")
        a.shapes.append((label, *map(int, dims[:3]), dims[3:] == ["ragged"]))
    return a


def launch(lib, local, args, p):
    """One launch of a tree's kernel on the current stream: the int32
    results [3 or 5, B] and the packed ops."""
    reads, pens, rdlens, refs, wlens = args
    B, L = reads.shape
    W = refs.shape[1]
    nops = -(-(L + W + 1) // 4)
    out = torch.empty((5 if local else 3, B), dtype=torch.int32,
                      device=reads.device)
    ops = torch.empty((B, nops), dtype=torch.uint8, device=reads.device)
    nbytes = sw_cuda.trace_bytes(B, L, W + 1, local) + 16 * B * L
    trace = torch.empty(nbytes, dtype=torch.uint8, device=reads.device)
    pen = (p.rdg_open, p.rdg_ext, p.rfg_open, p.rfg_ext, p.npen, p.gbar)
    fn = lib.sw_local_backtrace_launch if local else lib.sw_e2e_backtrace_launch
    err = fn(*(t.data_ptr() for t in args), B, L, W, *pen,
             *((p.ma,) if local else ()), out.data_ptr(), ops.data_ptr(), nops,
             trace.data_ptr(), nbytes,
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"launch failed: cudaError {err}")
    return out, ops


def main():
    a = parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_dp_variants: no CUDA device")
    smoke = load_smoke()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    trees, rows = a.trees, []
    for label, B, L, W, ragged in a.shapes:
        kw = (dict(ragged=True, degenerate=True, n_inside=True) if ragged
              else dict(lens=(900, 1000, 1024) if L > 512 else
                        (max(1, L - 60), max(1, L - 10))))
        for tag in ("K1", "K2"):
            k = smoke.KERNELS[tag]
            rng = np.random.default_rng(smoke.SEED + B + L + W)
            args = smoke.dp_problems(rng, B, L, W, flanks=tag == "K2", **kw)
            bound, _by = smoke.dp_bound(args, k["nout"] - 1, k["ops_per_cell"])
            best, first = {}, None
            for rep in range(a.reps):
                order = trees if rep % 2 == 0 else trees[::-1]
                for name, csrc in order:
                    run = functools.partial(launch, _build.get_lib(csrc),
                                            tag == "K2", args, k["params"])
                    if a.check and rep == 0:
                        got = run()
                        torch.cuda.synchronize()
                        if first is None:
                            first = got
                        elif not all(torch.equal(g, w)
                                     for g, w in zip(got, first)):
                            raise SystemExit(
                                f"{name} differs from {trees[0][0]} at "
                                f"{tag} {label}")
                    ms = smoke.time_ms(run, 10)
                    best[name] = min(best.get(name, ms), ms)
            for name, _csrc in trees:
                rows.append(dict(tree=name, kernel=tag, label=label, B=B, L=L,
                                 C=W + 1, ms=best[name], bound_ms=bound))
                print(f"{name:12s} {tag} {label:8s} B={B} L={L} C={W + 1} "
                      f"{best[name]:.3f} ms, bound {bound:.3f} ms, "
                      f"{best[name] / bound:.1f}x", flush=True)
    print(json.dumps({"card": smi, "rows": rows}))


if __name__ == "__main__":
    main()
