"""Data-parallel sharding over a device mesh.

Counterpart of omp_bowtie2_prime_tpu/parallel/mesh.py. The reference's
parallelism is OpenMP data-parallel over a resident read batch
(bt2_search.cpp:2302-2304). Here a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over one process a GPU: on a
``data`` axis each rank aligns a contiguous block of the batch against
its own copy of the index, and the blocks' results are gathered back in
input order; a ``model`` axis shards the index itself
(parallel/tp_index.py). Every group of a mesh made here carries the
``distributed.TIMEOUT`` of its collectives.
"""

from __future__ import annotations

import math
import threading

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .distributed import TIMEOUT


def _new_mesh(shape: tuple, names: tuple, device_type: str) -> DeviceMesh:
    """A DeviceMesh of ``shape`` over ranks 0..prod(shape) - 1 in row-major
    order (rank = d * n_model + m on a (data, model) mesh), one process
    group per line of each axis, each with TIMEOUT, on ``device_type``
    ("cuda": the process's current GPU, as init_distributed set it; or
    "cpu"). Every rank of the world calls it alike; the world must be the
    mesh."""
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs a process group: init_distributed")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"a mesh of {shape} over a world of {world} ranks")
    ranks = torch.arange(world).reshape(shape)
    me = dist.get_rank()
    backend = dist.get_backend()
    groups = []
    for d in range(len(shape)):
        mine = None
        for line in ranks.movedim(d, -1).reshape(-1, shape[d]).tolist():
            g = dist.new_group(line, timeout=TIMEOUT, backend=backend)
            if me in line:
                mine = g
        groups.append(mine)
    return DeviceMesh.from_group(groups if len(groups) > 1 else groups[0],
                                 device_type, mesh=ranks,
                                 mesh_dim_names=names)


def make_mesh(n_devices: int | None = None, device_type: str = "cuda"
              ) -> DeviceMesh:
    """A 1-D ("data",) mesh over the whole world (n_devices, if given,
    must be its size), on the GPUs unless ``device_type`` is "cpu"."""
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs a process group: init_distributed")
    if n_devices is not None and n_devices != dist.get_world_size():
        raise ValueError(f"make_mesh({n_devices}) in a world of "
                         f"{dist.get_world_size()} ranks")
    return _new_mesh((dist.get_world_size(),), ("data",), device_type)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device on ``mesh``: its current GPU (init_distributed
    set it) or the CPU."""
    return (torch.device("cuda", torch.cuda.current_device())
            if mesh.device_type == "cuda" else torch.device("cpu"))


class MeshPlacer:
    """Places what a rank works on: the index replicated on this rank's
    device, or, when the mesh has a 'model' axis, sharded row-wise
    across it (parallel/tp_index.py); a batch cut over
    'data' (when present) into contiguous blocks, as ``P("data")`` cuts
    one in the JAX package. ``lock`` serialises the collectives of the
    aligners that share this placer inside one process (``align_batch``
    and ``PairedAligner.align_pairs`` hold it for a whole batch): their
    calls must come in the same order on every rank, which
    ``models.pipeline.run_pipeline`` ensures for its workers
    (``BatchTurns``: a batch takes the lock in its turn)."""

    def __init__(self, mesh: DeviceMesh):
        self.mesh = mesh
        names = mesh.mesh_dim_names
        self.data_axis = "data" if "data" in names else None
        # a model axis shards the index even at one rank (the JAX
        # package replicates it there): one shard, reduces of one
        self.model_axis = "model" if "model" in names else None
        self.n_data = axis_size(mesh, "data") if self.data_axis else 1
        self.data_rank = (mesh.get_local_rank("data") if self.data_axis
                          else 0)
        self.device = mesh_device(mesh)
        self.lock = threading.Lock()

    def put_index(self, fm):
        """The FMIndex ``fm`` on this rank's device: whole, or this rank's
        shard on a model axis (only that slice is uploaded)."""
        if self.model_axis is not None:
            from .tp_index import shard_index

            return shard_index(fm, self.mesh, self.model_axis)
        from ..index.format import GpuIndex

        return GpuIndex.from_host(fm, self.device)

    def block(self, n: int) -> slice:
        """This rank's block of n items on the data axis: ceil(n / D) a
        block, the last ones shorter (or empty)."""
        q = -(-n // self.n_data)
        lo = min(self.data_rank * q, n)
        return slice(lo, min(lo + q, n))

    def put_batch(self, a):
        """This rank's block of the leading axis of ``a`` (a list, array
        or tensor)."""
        return a[self.block(len(a))]

    def gather_batch(self, part: list) -> list:
        """Every data rank's ``part`` (picklable items), concatenated in
        data-rank order: the whole batch in input order, on every rank."""
        if self.n_data == 1:
            return list(part)
        parts = [None] * self.n_data
        dist.all_gather_object(parts, list(part),
                               group=self.mesh.get_group("data"))
        return [x for p in parts for x in p]


def full_align_step(idx, seeds, seed_valid, reads, pens, rdlens, refs,
                    wlens, swp, range_cap: int = 16):
    """The full device step (fused search + resolve, then the DP with its
    backtrace: K1 on a CUDA tensor, its plain version on the CPU) as one
    function, as the JAX package's multi-chip dry run takes it; the
    aligner calls the two phases separately because their batch sizes
    differ."""
    from ..ops.seed_search import search_resolve_seeds
    from ..ops.sw_cuda import sw_e2e_backtrace

    top, bot, starts, offs = search_resolve_seeds(
        idx, seeds, seed_valid, range_cap
    )
    best, bestcol, ops, startcol = sw_e2e_backtrace(
        reads, pens, rdlens, refs, wlens, swp
    )
    return top, bot, starts, offs, best, bestcol, ops, startcol
