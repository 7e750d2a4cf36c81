"""Ranks of the port's multi-process tests (tests/test_torch_parallel.py,
test_torch_tp_index.py, test_torch_multihost.py, test_torch_import.py,
test_torch_paired_mesh.py) and of scripts/torch_multichip_bench.py and
scripts/torch_tp_scale_check.py.

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


def collect(handle, timeout: float = JOIN_TIMEOUT) -> list:
    """Each rank's result of a ``start_world``. Raises with a rank's
    output if one fails or the world does not end in ``timeout`` s."""
    task, wd, procs = handle
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
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


def run_world(task: str, world: int, wd: str,
              timeout: float = JOIN_TIMEOUT) -> list:
    """``collect(start_world(task, world, wd), timeout)``."""
    return collect(start_world(task, world, wd), timeout)


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
    the reads aligned end to end; the reduces, K1's launches and the FM
    kernels' (none: a sharded index takes the plain FM ops)."""
    from omp_bowtie2_prime_tpu_torch.models.aligner import TorchAligner
    from omp_bowtie2_prime_tpu_torch.ops import fm_cuda
    from omp_bowtie2_prime_tpu_torch.ops import rank as rank_ops
    from omp_bowtie2_prime_tpu_torch.ops import sw_cuda
    from omp_bowtie2_prime_tpu_torch.parallel.tp_index import make_tp_mesh

    al = TorchAligner(inp["fm"], device="cuda",
                      mesh=make_tp_mesh(world, device_type="cuda"))
    rank_ops.REDUCES = sw_cuda.LAUNCHES = 0
    fm_cuda.LAUNCHES_SEARCH = fm_cuda.LAUNCHES_WALK = 0
    res = [res_tuple(r) for r in al.align_batch(_reads(inp["reads"]))]
    return dict(results=res, reduces=rank_ops.REDUCES,
                launches=sw_cuda.LAUNCHES, rows=al.idx.blocks.shape[0],
                device=str(al.idx.blocks.device),
                fm_launches=fm_cuda.LAUNCHES_SEARCH + fm_cuda.LAUNCHES_WALK)


def pair_reads(spec, cls):
    """(mate 1, mate 2) Reads of ``cls`` from (name, seq1, qual1, seq2,
    qual2) tuples."""
    return [(cls(i, name, s1, q1.copy()), cls(i, name, s2, q2.copy()))
            for i, (name, s1, q1, s2, q2) in enumerate(spec)]


def pair_sam(pkg, fm, pairs, results) -> str:
    """The records (no header) of paired ``results`` as ``pkg``'s
    SamWriter writes them, secondary pairings included."""
    import importlib
    import io

    sam = importlib.import_module(f"{pkg}.io.sam")
    out = io.StringIO()
    w = sam.SamWriter(out, fm.refmap.refnames, fm.refmap.reflens)
    for (rd1, rd2), p in zip(pairs, results):
        w.write_pair(rd1, rd2, p.m1, p.m2, p.cat, p.tlen1, p.tlen2,
                     unique=not p.extras)
        for e1, e2, t1, t2 in p.extras:
            w.write_pair(rd1, rd2, e1, e2, p.cat, t1, t2, secondary=True)
    return out.getvalue()


# seconds a pipeline run of task_pairs holds back every other batch
SKEW = 0.3


def _pipeline_runs(fns, batches, reps, rank):
    """Each of ``reps`` runs of run_pipeline over ``batches`` with one
    worker a callable of ``fns``: the results, in input order, of every
    run. In run k a rank holds back batch j for SKEW s before its align
    call when j + rank + k is even, so that two ranks next to each other
    would start their batches in opposite orders if nothing ordered
    them."""
    import time

    from omp_bowtie2_prime_tpu_torch.models.pipeline import run_pipeline

    def held(fn, k):
        def call(b):
            j = next(i for i, x in enumerate(batches) if x is b)
            if (j + rank + k) % 2 == 0:
                time.sleep(SKEW)
            return fn(b)
        return call

    runs = []
    for k in range(reps):
        got = []
        run_pipeline(iter(batches), None,
                     lambda b, res: got.extend(res),
                     align_fns=[held(fn, k) for fn in fns])
        runs.append(got)
    return runs


def task_pairs(inp, rank, world):
    """PairedAligner on a mesh ("data": data=WORLD; "tp": data=WORLD/2,
    model=2): the pairs end to end and --local (a sharer with the local
    configuration), one pair (a batch smaller than the data axis) and one
    read through align_batch; then two sharers of the placer as the two
    workers of run_pipeline (``_pipeline_runs``: neighbouring ranks start
    their batches in opposite orders), repeated, for align_pairs and for
    align_batch (the mates as single reads), on the first ``inp["pipe"]``
    pairs in batches of ``inp["batch"]``. Records as SAM text."""
    from omp_bowtie2_prime_tpu_torch.io.fastq import Read
    from omp_bowtie2_prime_tpu_torch.models.aligner import TorchAligner
    from omp_bowtie2_prime_tpu_torch.models.paired import PairedAligner
    from omp_bowtie2_prime_tpu_torch.parallel.mesh import make_mesh
    from omp_bowtie2_prime_tpu_torch.parallel.tp_index import make_tp_mesh

    fm = inp["fm"]
    pkg = "omp_bowtie2_prime_tpu_torch"
    mesh = (make_mesh(world, device_type="cpu") if inp["mesh"] == "data"
            else make_tp_mesh(2, n_data=world // 2, device_type="cpu"))
    al = TorchAligner(fm, device="cpu", mesh=mesh)
    sc, opts = local_config(pkg)
    loc = TorchAligner(fm, sc, opts, device="cpu", share=al)
    pairs = pair_reads(inp["pairs"], Read)
    blk = al.placer.block(len(pairs))
    out = dict(block=(blk.start, blk.stop), sharded=al.idx.tp is not None)
    res = PairedAligner(al).align_pairs(pairs)
    out["e2e"] = pair_sam(pkg, fm, pairs, res)
    out["reads_counted"] = al.metrics.reads
    out["gather_timed"] = al.timers.calls.get("dataGather", 0)
    out["local"] = pair_sam(pkg, fm, pairs,
                            PairedAligner(loc).align_pairs(pairs))
    out["small"] = pair_sam(pkg, fm, pairs[:1],
                            PairedAligner(al).align_pairs(pairs[:1]))
    out["small_read"] = [res_tuple(r) for r in al.align_batch(
        [pairs[0][0]])]
    al2 = TorchAligner(fm, device="cpu", share=al)
    nb = inp["batch"]
    pairs = pairs[: inp["pipe"]]
    batches = [pairs[i : i + nb] for i in range(0, len(pairs), nb)]
    out["pipe_pairs"] = [pair_sam(pkg, fm, pairs, got) for got in
                         _pipeline_runs([PairedAligner(a).align_pairs
                                         for a in (al, al2)], batches,
                                        inp["reps"], rank)]
    reads = [rd for p in pairs for rd in p]
    batches = [reads[i : i + 2 * nb] for i in range(0, len(reads), 2 * nb)]
    out["pipe_reads"] = [[res_tuple(r) for r in got] for got in
                         _pipeline_runs([al.align_batch, al2.align_batch],
                                        batches, inp["reps"], rank)]
    return out


def rank_backend(device: str, backend, world: int, who: str):
    """(backend, the ranks' device) of a script's ranks on ``device``
    ("cuda" or "cpu"): NCCL one rank a card by default on the cards, gloo
    on the CPU; gloo on the cards puts every rank on cuda:0. Exits with
    a message where that cannot run."""
    import torch

    backend = backend or ("nccl" if device == "cuda" else "gloo")
    if device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit(f"{who}: no CUDA device (--device cpu runs "
                             "gloo ranks on the CPU)")
        cards = torch.cuda.device_count()
        if backend == "nccl" and world > cards:
            raise SystemExit(f"{who}: NCCL takes one rank a card: {world} "
                             f"ranks, {cards} cards (--backend gloo shares "
                             "cuda:0)")
        print(f"{cards} x {torch.cuda.get_device_name(0)}")
        return backend, "cuda:0" if backend == "gloo" else "cuda"
    if backend == "nccl":
        raise SystemExit(f"{who}: nccl needs --device cuda")
    return backend, "cpu"


def sync_device(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def task_bench(inp, rank, world):
    """scripts/torch_multichip_bench.py: the reads (or pairs) through
    ``align_batch`` (``align_pairs``) in batches of ``inp["batch"]`` on a
    data mesh (data=WORLD) or a tp mesh (model=WORLD) on this rank's
    device: the index load (the aligner's construction) and a warm-up on
    the first batch apart from the timed loop. Returns the records, the
    seconds and the counters."""
    import time

    from omp_bowtie2_prime_tpu_torch.io.fastq import Read
    from omp_bowtie2_prime_tpu_torch.models.aligner import TorchAligner
    from omp_bowtie2_prime_tpu_torch.models.paired import PairedAligner
    from omp_bowtie2_prime_tpu_torch.ops import rank as rank_ops
    from omp_bowtie2_prime_tpu_torch.parallel.mesh import (make_mesh,
                                                           mesh_device)
    from omp_bowtie2_prime_tpu_torch.parallel.tp_index import make_tp_mesh

    dtype = "cuda" if inp["device"].startswith("cuda") else "cpu"
    mesh = (make_mesh(world, device_type=dtype) if inp["mesh"] == "data"
            else make_tp_mesh(world, device_type=dtype))
    device = mesh_device(mesh)
    pkg = "omp_bowtie2_prime_tpu_torch"
    t0 = time.perf_counter()
    al = TorchAligner(inp["fm"], device=device, mesh=mesh)
    sync_device(device)
    load_s = time.perf_counter() - t0
    if inp["pairs"]:
        items = pair_reads(inp["items"], Read)
        fn = PairedAligner(al).align_pairs
    else:
        items = _reads(inp["items"])
        fn = al.align_batch
    nb = inp["batch"]
    batches = [items[i : i + nb] for i in range(0, len(items), nb)]
    fn(batches[0])  # warm-up
    al.timers.reset()
    rank_ops.REDUCES = 0
    sync_device(device)
    t0 = time.perf_counter()
    res = [r for b in batches for r in fn(b)]
    sync_device(device)
    align_s = time.perf_counter() - t0
    recs = (pair_sam(pkg, inp["fm"], items, res) if inp["pairs"]
            else [res_tuple(r) for r in res])
    return dict(records=recs, load_s=load_s, align_s=align_s,
                device=str(device), reduces=rank_ops.REDUCES,
                gather_s=al.timers.acc.get("dataGather", 0.0),
                reduce_s=al.timers.acc.get("tpReduce", 0.0))


def task_tp_scale(inp, rank, world):
    """scripts/torch_tp_scale_check.py: the index sharded over a model
    axis of WORLD on this rank's device: the shard's resident bytes,
    ``shard_index``'s seconds, and one search + resolve of the lanes
    through the reduces (their count and seconds)."""
    import time

    import torch

    from omp_bowtie2_prime_tpu_torch.index.closed_form import (
        homopolymer_index)
    from omp_bowtie2_prime_tpu_torch.index.format import FMIndex
    from omp_bowtie2_prime_tpu_torch.ops import rank as rank_ops
    from omp_bowtie2_prime_tpu_torch.parallel.mesh import mesh_device
    from omp_bowtie2_prime_tpu_torch.parallel.tp_index import (
        make_tp_mesh, shard_index, tp_hbm_per_device, tp_search_resolve_fn)

    fm = (FMIndex.load(inp["idx"]) if inp["idx"] else
          homopolymer_index(inp["n"]))
    dtype = "cuda" if inp["device"].startswith("cuda") else "cpu"
    mesh = make_tp_mesh(world, device_type=dtype)
    device = mesh_device(mesh)
    hbm = tp_hbm_per_device(fm, world)
    sync_device(device)
    before = (torch.cuda.memory_allocated(device) if dtype == "cuda"
              else 0)
    t0 = time.perf_counter()
    idx = shard_index(fm, mesh)
    sync_device(device)
    shard_s = time.perf_counter() - t0
    del fm
    alloc = (torch.cuda.memory_allocated(device) - before if dtype == "cuda"
             else None)
    fields = ("blocks", "sa_sample", "ftab", "ref_words", "fchr")
    seeds, valid, lseed = (torch.from_numpy(inp[k]).to(device)
                           for k in ("seeds", "valid", "lseed"))
    fn = tp_search_resolve_fn(idx, mesh, 16, 4)
    rank_ops.REDUCES = 0
    sync_device(device)
    t0 = time.perf_counter()
    out = fn(idx, seeds, valid, lseed)
    sync_device(device)
    search_s = time.perf_counter() - t0
    return dict(hbm=hbm, bytes=sum(getattr(idx, f).numel() * 8
                                   for f in fields),
                allocated=alloc, shard_s=shard_s, search_s=search_s,
                reduces=rank_ops.REDUCES, rows=(idx.blocks.shape[0],
                                                idx.sa_sample.shape[0]),
                out=[t.cpu().numpy() for t in out], device=str(device))


TASKS = dict(data=task_data, tp=task_tp, shard=task_shard,
             blocked=task_blocked, tp_cuda=task_tp_cuda, pairs=task_pairs,
             bench=task_bench, tp_scale=task_tp_scale)


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
