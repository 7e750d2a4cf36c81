"""Multi-process scale-out: process-group initialisation and
deterministic read sharding.

Counterpart of omp_bowtie2_prime_tpu/parallel/distributed.py. One process
per GPU under torch.distributed (the JAX package's jax.distributed): the
FM index is loaded by every process, the FASTQ stream is sharded per
process by contiguous read-id blocks, and the per-process SAM shards
merge by an rdid-ordered interleave (the reference's OutputQueue contract,
outq.h:31-45). ``host_shard``, ``_ShardReader`` and ``merge_sam_shards``
are the JAX module's, line for line.
"""

from __future__ import annotations

import datetime

import torch
import torch.distributed as dist

# every process group of the port: a rank that waits longer on a
# collective than this raises instead of hanging
TIMEOUT = datetime.timedelta(seconds=60)


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None, *, device="cuda",
                     backend: str | None = None) -> tuple[int, int]:
    """Joins the process group at ``tcp://{coordinator}`` (host:port) as
    rank ``process_id`` of ``num_processes``; returns (rank, world size).
    Without a coordinator: the running group's (rank, size), or (0, 1).

    device: this process's device. A CUDA device becomes the current one
    (without an index: GPU ``process_id % device_count``, one rank a GPU).
    backend: ``nccl`` on a CUDA device and ``gloo`` on the CPU unless
    named; gloo on a CUDA device (ranks sharing a GPU, which NCCL refuses)
    only when named. NCCL on the CPU raises."""
    if coordinator is None:
        if dist.is_initialized():
            return dist.get_rank(), dist.get_world_size()
        return 0, 1
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"the nccl backend needs a CUDA device, not {device}")
    if device.type == "cuda":
        torch.cuda.set_device(device.index if device.index is not None
                              else process_id % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id,
                            timeout=TIMEOUT)
    return dist.get_rank(), dist.get_world_size()


def host_shard(reads_iter, process_id: int, num_processes: int,
               block: int = 4096):
    """Deterministic per-host read sharding: contiguous blocks of `block`
    reads round-robin across hosts. Yields this host's reads; rdids are
    preserved so per-host SAM shards merge in input order."""
    buf = []
    blk_idx = 0
    for rd in reads_iter:
        buf.append(rd)
        if len(buf) == block:
            if blk_idx % num_processes == process_id:
                yield from buf
            buf = []
            blk_idx += 1
    if buf and blk_idx % num_processes == process_id:
        yield from buf


class _ShardReader:
    """Streaming read-unit cursor over one SAM shard: yields blocks of
    consecutive-QNAME units without ever holding more than one block."""

    def __init__(self, path: str, want_headers: bool):
        self.f = open(path)
        self.headers: list[str] = []
        self.pending: str | None = None
        for line in self.f:
            if line.startswith("@"):
                if want_headers:
                    self.headers.append(line)
                continue
            self.pending = line
            break

    def take_units(self, n_units: int, out) -> int:
        """Write up to n_units read units (consecutive records sharing a
        QNAME — mates and secondaries stay together) to `out`; returns
        the number of units written (0 = exhausted)."""
        done = 0
        while done < n_units and self.pending is not None:
            name = self.pending.split("\t", 1)[0]
            out.write(self.pending)
            self.pending = None
            for line in self.f:
                if line.split("\t", 1)[0] != name:
                    self.pending = line
                    break
                out.write(line)
            done += 1
        if self.pending is None:
            self.f.close()
        return done


def merge_sam_shards(shard_paths: list[str], out_path: str,
                     block: int = 4096) -> None:
    """rdid-ordered merge of per-host SAM shards produced with host_shard
    (the OutputQueue reorder contract, outq.h:31-45): headers come from
    shard 0; record "read units" interleave block-round-robin, undoing
    host_shard's block assignment.  Fully streaming — memory stays
    constant regardless of shard size (the 100M-read multi-host configs
    this exists for cannot be slurped)."""
    readers = [_ShardReader(p, want_headers=(i == 0))
               for i, p in enumerate(shard_paths)]
    n = len(readers)
    live = [True] * n
    with open(out_path, "w") as out:
        out.writelines(readers[0].headers)
        src = 0
        while any(live):
            if live[src]:
                live[src] = readers[src].take_units(block, out) > 0
            src = (src + 1) % n
