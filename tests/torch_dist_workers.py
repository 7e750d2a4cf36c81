"""Ranks of the port's multi-process tests (tests/test_torch_parallel.py,
test_torch_tp_index.py, test_torch_multihost.py, test_torch_import.py).

    python tests/torch_dist_workers.py TASK RANK WORLD PORT DIR

Each rank is a fresh interpreter that runs with jax, flax and the JAX
package blocked (importing any of them raises), joins a gloo world on
the CPU at tcp://127.0.0.1:PORT through the port's ``init_distributed``,
reads its inputs from DIR/inputs.pkl and writes what it found to
DIR/TASK.RANK.pkl. ``run_world`` starts a world and collects it; the
parent process (which may import jax) imports this module only for that.
"""

import sys

if __name__ == "__main__":
    for _m in ("jax", "jaxlib", "flax", "omp_bowtie2_prime_tpu"):
        sys.modules[_m] = None

import os
import pickle
import socket
import subprocess

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# a rank's collectives wait at most distributed.TIMEOUT (60 s); a world
# that has not ended by this is killed
JOIN_TIMEOUT = 240


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def start_world(task: str, world: int, wd: str):
    """Starts ``task`` on ``world`` ranks (fresh processes) over the
    inputs in wd/inputs.pkl; ``collect`` waits for them."""
    port = free_port()
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), task, str(r), str(world),
         str(port), wd], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(world)]
    return task, wd, procs


def collect(handle) -> list:
    """Each rank's result of a ``start_world``. Raises with a rank's
    output if one fails or the world does not end in JOIN_TIMEOUT s."""
    task, wd, procs = handle
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=JOIN_TIMEOUT)
            outs.append(out.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"{task} rank {r} of {len(procs)} exited "
                                 f"{p.returncode}:\n{out[-3000:]}")
    res = []
    for r in range(len(procs)):
        with open(os.path.join(wd, f"{task}.{r}.pkl"), "rb") as f:
            res.append(pickle.load(f))
    return res


def run_world(task: str, world: int, wd: str) -> list:
    """``collect(start_world(task, world, wd))``."""
    return collect(start_world(task, world, wd))


def res_tuple(r):
    return (r.status, r.fw, r.refid, r.refoff, r.score, r.secbest, r.mapq,
            tuple(r.cigar))


def local_config(pkg):
    """(Scoring, AlignOpts) of --local with the sensitive-local preset,
    from ``pkg``'s own modules (the port's or the JAX package's)."""
    import importlib

    presets = importlib.import_module(f"{pkg}.utils.presets")
    scoring = importlib.import_module(f"{pkg}.utils.scoring")
    aligner = importlib.import_module(f"{pkg}.models.aligner")
    pl = presets.PRESETS_LOCAL["sensitive-local"]
    return (scoring.Scoring(match_bonus=2,
                            score_min=scoring.SimpleFunc.parse("G,20,8")),
            aligner.AlignOpts(local=True, seed_len=pl.seed_len, ival=pl.ival,
                              nrounds=pl.nrounds, dps=pl.dps))


def _reads(spec):
    from omp_bowtie2_prime_tpu_torch.io.fastq import Read

    return [Read(i, name, seq, qual)
            for i, (name, seq, qual) in enumerate(spec)]


def _jax_blocked() -> bool:
    return all(sys.modules.get(m, 0) is None
               for m in ("jax", "flax", "omp_bowtie2_prime_tpu"))


def task_data(inp, rank, world):
    """A data mesh over the world: this rank's block, and the batch's
    results as align_batch returns them on this rank."""
    from omp_bowtie2_prime_tpu_torch.models.aligner import TorchAligner
    from omp_bowtie2_prime_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(world, device_type="cpu")
    al = TorchAligner(inp["fm"], device="cpu", mesh=mesh)
    reads = _reads(inp["reads"])
    blk = al.placer.block(len(reads))
    return dict(block=(blk.start, blk.stop),
                results=[res_tuple(r) for r in al.align_batch(reads)])


def task_tp(inp, rank, world):
    """A model=4 mesh: the shard's rows, the sharded search + resolve and
    its reduces; then a (data=2, model=2) mesh: the search with the lanes
    cut over data, and an aligner end to end and --local (sharing its
    index) on the reads."""
    import torch

    from omp_bowtie2_prime_tpu_torch.models.aligner import TorchAligner
    from omp_bowtie2_prime_tpu_torch.ops import rank as rank_ops
    from omp_bowtie2_prime_tpu_torch.parallel.tp_index import (
        make_tp_mesh, shard_index, tp_hbm_per_device, tp_search_resolve_fn)

    fm = inp["fm"]
    seeds, valid, lseed = (torch.from_numpy(inp[k]) for k in
                           ("seeds", "valid", "lseed"))
    out = {}
    mesh = make_tp_mesh(4, device_type="cpu")
    idx = shard_index(fm, mesh)
    out["rows"] = (idx.blocks.shape[0], idx.sa_sample.shape[0],
                   idx.tp.rank, idx.tp.size)
    out["hbm"] = tp_hbm_per_device(fm, 4)
    out["bytes"] = sum(getattr(idx, k).numel() * 8 for k in
                       ("blocks", "sa_sample", "ftab", "ref_words", "fchr"))
    rank_ops.REDUCES = 0
    res = tp_search_resolve_fn(idx, mesh, 16, 2)(idx, seeds, valid, lseed)
    out["reduces"] = rank_ops.REDUCES
    out["search"] = [t.numpy() for t in res]

    mesh22 = make_tp_mesh(2, n_data=2, device_type="cpu")
    al = TorchAligner(fm, device="cpu", mesh=mesh22)
    res = tp_search_resolve_fn(al.idx, mesh22, 16, 2, data_axis="data")(
        al.idx, seeds, valid, lseed)
    blk = al.placer.block(len(seeds))
    out["search_data"] = ((blk.start, blk.stop), [t.numpy() for t in res])
    reads = _reads(inp["reads"])
    out["e2e"] = [res_tuple(r) for r in al.align_batch(reads)]
    sc, opts = local_config("omp_bowtie2_prime_tpu_torch")
    loc = TorchAligner(fm, sc, opts, device="cpu", share=al)
    out["local"] = [res_tuple(r) for r in loc.align_batch(_reads(
        inp["local_reads"]))]
    out["tpReduce"] = al.timers.calls.get("tpReduce", 0)
    return out


def task_shard(inp, rank, world):
    """Multi-host: this process's host_shard of the FASTQ aligned on one
    device and written as a SAM shard (DIR/shardRANK.sam)."""
    from omp_bowtie2_prime_tpu_torch.index.format import FMIndex
    from omp_bowtie2_prime_tpu_torch.io.fastq import read_fastq
    from omp_bowtie2_prime_tpu_torch.models.aligner import TorchAligner
    from omp_bowtie2_prime_tpu_torch.parallel.distributed import host_shard

    fm = FMIndex.load(inp["index"])
    reads = list(host_shard(read_fastq(inp["fastq"]), rank, world,
                            block=inp["block"]))
    path = os.path.join(inp["dir"], f"shard{rank}.sam")
    write_sam(path, fm, reads, TorchAligner(fm, device="cpu").align_batch(
        reads), "omp_bowtie2_prime_tpu_torch")
    return dict(n=len(reads), path=path)


def write_sam(path, fm, reads, results, pkg):
    """Header and records of ``results`` with ``pkg``'s SamWriter, as the
    JAX package's multi-host test writes them."""
    import importlib

    sam = importlib.import_module(f"{pkg}.io.sam")
    cigar = importlib.import_module(f"{pkg}.utils.cigar")
    with open(path, "w") as out:
        w = sam.SamWriter(out, fm.refmap.refnames, fm.refmap.reflens)
        w.write_header()
        for rd, res in zip(reads, results):
            if res.status == "aligned":
                w.write_aligned(rd, res.fw, w.refnames[res.refid],
                                res.refoff, res.mapq,
                                cigar.cigar_string(res.cigar), res.score,
                                res.secbest, res.stats)
            else:
                w.write_unaligned(rd)


def task_blocked(inp, rank, world):
    """A tiny sharded index over the world: occ and the SA sample through
    the reduces equal the unsharded index's; and whether the JAX package
    was blocked in this rank."""
    import torch

    from omp_bowtie2_prime_tpu_torch.index.format import GpuIndex
    from omp_bowtie2_prime_tpu_torch.ops import rank as rank_ops
    from omp_bowtie2_prime_tpu_torch.parallel.tp_index import (
        make_tp_mesh, shard_index)

    fm = inp["fm"]
    mesh = make_tp_mesh(world, device_type="cpu")
    whole = GpuIndex.from_host(fm, "cpu")
    idx = shard_index(whole, mesh)
    rows = torch.arange(0, fm.nrows, 7)
    same = all(torch.equal(rank_ops.occ(idx, torch.full_like(rows, c), rows),
                           rank_ops.occ(whole, torch.full_like(rows, c), rows))
               for c in range(4))
    r = torch.arange(0, len(fm.sa_sample))
    same &= torch.equal(rank_ops.sa_lookup(idx, r),
                        rank_ops.sa_lookup(whole, r))
    return dict(same=bool(same), blocked=_jax_blocked(),
                modules=sorted(m for m in sys.modules
                               if m.split(".")[0] in ("jax", "flax")
                               and sys.modules[m] is not None))


def task_tp_cuda(inp, rank, world):
    """Ranks sharing one GPU through gloo: a model=WORLD mesh on the card,
    the reads aligned end to end; the reduces and K1's launches."""
    from omp_bowtie2_prime_tpu_torch.models.aligner import TorchAligner
    from omp_bowtie2_prime_tpu_torch.ops import rank as rank_ops
    from omp_bowtie2_prime_tpu_torch.ops import sw_cuda
    from omp_bowtie2_prime_tpu_torch.parallel.tp_index import make_tp_mesh

    al = TorchAligner(inp["fm"], device="cuda",
                      mesh=make_tp_mesh(world, device_type="cuda"))
    rank_ops.REDUCES = sw_cuda.LAUNCHES = 0
    res = [res_tuple(r) for r in al.align_batch(_reads(inp["reads"]))]
    return dict(results=res, reduces=rank_ops.REDUCES,
                launches=sw_cuda.LAUNCHES, rows=al.idx.blocks.shape[0],
                device=str(al.idx.blocks.device))


TASKS = dict(data=task_data, tp=task_tp, shard=task_shard,
             blocked=task_blocked, tp_cuda=task_tp_cuda)


def main():
    task, rank, world, port, wd = sys.argv[1:6]
    rank, world = int(rank), int(world)
    import torch

    torch.set_num_threads(1)
    from omp_bowtie2_prime_tpu_torch.parallel.distributed import (
        init_distributed)

    with open(os.path.join(wd, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    got = init_distributed(f"127.0.0.1:{port}", world, rank,
                           device=inp.get("device", "cpu"),
                           backend=inp.get("backend"))
    assert got == (rank, world), got
    out = TASKS[task](inp, rank, world)
    out["jax_blocked"] = _jax_blocked()
    with open(os.path.join(wd, f"{task}.{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    import torch.distributed as dist

    dist.destroy_process_group()


if __name__ == "__main__":
    main()
