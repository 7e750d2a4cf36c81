"""Tensor-parallel FM index: shard the index itself across GPUs.

Counterpart of omp_bowtie2_prime_tpu/parallel/tp_index.py. The two large
index arrays (the 1024-row block records and the SA sample) are cut
row-wise across a mesh axis, so the genome's ceiling becomes the cards'
combined memory rather than one card's. Queries stay lockstep-replicated
on the ranks of a model group. Each LF step of the search and the walk
is counted by the owner of its row's record, where the record lies, and
one all_reduce over the group sums the owners' answers, 16 B a lane, and
8 B a lane of the walk's offsets, SA word and steps (ops/seed_search.
tp_search_loop, ops/walk.tp_walk_loop: a
kernel launch a step on the card, ops/fm_cuda.py); the JAX package sums
the 512 B record itself, which the record-level ops of ops/rank.py
(``_owner_gather``) still do. Compute is replicated, memory divided by
the axis size. Every host decision that leads to a collective (live-lane
counts, the walk's tiles, the grid's overflow test, the DP's launch cuts)
is made from replicated values, so the ranks issue the same reduces.

Composes with data parallelism: a ('data', 'model') mesh cuts the seed
lanes (the reads) over 'data' while each data replica's index is sharded
over 'model'.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..index.format import DEV_BLOCK_U32, DEV_FTAB_PER_ROW, DEV_SA_PER_ROW, \
    FMIndex, GpuIndex, TpShard
from .mesh import _new_mesh, axis_size, mesh_device


def make_tp_mesh(n_model: int, n_data: int = 1, device_type: str = "cuda"):
    """A ("data", "model") DeviceMesh of n_data x n_model ranks (the
    world): rank = d * n_model + m; on the GPUs unless ``device_type`` is
    "cpu"."""
    return _new_mesh((n_data, n_model), ("data", "model"), device_type)


def _pad_rows(a, n: int):
    """The first rows of ``a`` (numpy or torch), zero rows appended up to
    n. The JAX package pads the whole array to a multiple of the axis
    size before cutting it; each rank padding its own slice gives the same
    records without a copy of the whole."""
    pad = n - a.shape[0]
    if pad == 0:
        return a
    if isinstance(a, torch.Tensor):
        return torch.cat([a, a.new_zeros((pad,) + tuple(a.shape[1:]))])
    return np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)])


def _rows_of(a, rank: int, d: int):
    """(rank's slice of a cut into d equal, zero-padded parts, its rows)."""
    nloc = -(-a.shape[0] // d)
    return _pad_rows(a[rank * nloc : (rank + 1) * nloc], nloc), nloc


def shard_index(fm_or_idx, mesh, axis: str = "model"):
    """This rank's GpuIndex of a row-sharded index: its slice of the block
    records and of the SA sample (each cut into ``axis``-size parts,
    padded with zero records), the rest whole, and the ``tp`` descriptor
    set. From an FMIndex only the slice goes up, to this rank's device on
    the mesh; from a GpuIndex the slice is copied out of it on its own
    device."""
    group = mesh.get_group(axis)
    d = axis_size(mesh, axis)
    r = mesh.get_local_rank(axis)
    if isinstance(fm_or_idx, FMIndex):
        fm = fm_or_idx
        device = mesh_device(mesh)
        arrs = GpuIndex.host_layout(fm)
        blocks, nblk = _rows_of(arrs.pop("blocks"), r, d)
        sa, nsa = _rows_of(arrs.pop("sa_sample"), r, d)
        up = {k: GpuIndex.upload(k, a, device) for k, a in arrs.items()}
        scal = dict(zoff=int(fm.zoff), nrows=int(fm.nrows),
                    ftab_k=int(fm.ftab_k), srate=int(fm.srate))
        blocks = GpuIndex.upload("blocks", blocks, device)
        sa = GpuIndex.upload("sa_sample", sa, device)
    else:
        idx = fm_or_idx
        if idx.tp is not None:
            raise ValueError("the index is already sharded")
        blocks, nblk = _rows_of(idx.blocks, r, d)
        sa, nsa = _rows_of(idx.sa_sample, r, d)
        blocks, sa = blocks.clone(), sa.clone()
        up = dict(fchr=idx.fchr, ftab=idx.ftab, ref_words=idx.ref_words)
        scal = dict(zoff=idx.zoff, nrows=idx.nrows, ftab_k=idx.ftab_k,
                    srate=idx.srate)
    return GpuIndex(blocks=blocks, sa_sample=sa, **up, **scal,
                    tp=TpShard(group=group, rank=r, size=d, nblk_loc=nblk,
                               nsa_loc=nsa))


def shard_views(idx, d: int) -> list:
    """The ``d`` in-process shards of a whole GpuIndex, as ``shard_index``
    cuts it over d ranks: each a GpuIndex whose block records and SA
    sample are views of its rows of the whole (no copy: the last shards'
    rows stop at the whole's end, and the step loops read the rest of a
    slice as its zero padding), the other tables shared, and a TpShard
    with no group. fm_cuda.tp_search_seeds and tp_resolve_rows take the
    list and sum the shards' partials in process: the kernels are held to
    the plain steps at several D without a process group."""
    if idx.tp is not None:
        raise ValueError("the index is already sharded")
    nblk = -(-idx.blocks.shape[0] // d)
    nsa = -(-idx.sa_sample.shape[0] // d)
    return [dataclasses.replace(
        idx, blocks=idx.blocks[r * nblk : (r + 1) * nblk],
        sa_sample=idx.sa_sample[r * nsa : (r + 1) * nsa],
        tp=TpShard(group=None, rank=r, size=d, nblk_loc=nblk, nsa_loc=nsa))
        for r in range(d)]


def tp_search_resolve_fn(idx, mesh, range_cap: int, expand: float,
                         axis: str = "model", data_axis: str | None = None,
                         sample_seed: int = 0, sub_ftab: bool = False):
    """ops/seed_search.search_resolve_seeds over a sharded index as one
    callable ``fn(idx, seeds, valid, lane_seed)``. The lanes are the same
    on every rank of the model group (``axis``, the index's own). With a
    ``data_axis`` of more than one rank, each rank searches only its
    contiguous block of the lanes and returns that block's results (its
    ``starts`` index its own ``offs``, as each data shard's do in the JAX
    package); without one the results are bitwise those of the unsharded
    index."""
    from ..ops.seed_search import search_resolve_seeds

    if idx.tp is None:
        raise ValueError("the index is not sharded (shard_index)")
    cut = None
    if data_axis is not None and axis_size(mesh, data_axis) > 1:
        from .mesh import MeshPlacer

        cut = MeshPlacer(mesh)

    def fn(idx_, seeds, valid, lane_seed):
        if cut is not None:
            seeds, valid, lane_seed = (cut.put_batch(t) for t in
                                       (seeds, valid, lane_seed))
        return search_resolve_seeds(
            idx_, seeds, valid, range_cap, expand, sample_seed, sub_ftab,
            lane_seed=lane_seed,
        )

    return fn


# bytes of a 128-word row of each device array: the block records are
# uint32 words in int32 (512 B), the other tables int64
ROW_BYTES = dict(blocks=DEV_BLOCK_U32 * 4, sa_sample=DEV_BLOCK_U32 * 8,
                 ftab=DEV_BLOCK_U32 * 8, ref_words=DEV_BLOCK_U32 * 8,
                 fchr=DEV_BLOCK_U32 * 8)


def _layout_rows(idx) -> dict:
    """Rows of 128 words of each device array of an FMIndex's or an
    unsharded GpuIndex's device layout."""
    if isinstance(idx, FMIndex):
        return dict(blocks=(idx.nblocks + 7) // 8,
                    sa_sample=-(-len(idx.sa_sample) // DEV_SA_PER_ROW),
                    ftab=-(-len(idx.ftab_top) // DEV_FTAB_PER_ROW),
                    ref_words=(len(idx.ref_words) + 128) / DEV_BLOCK_U32,
                    fchr=5 / DEV_BLOCK_U32)
    if idx.tp is not None:
        raise ValueError("tp_hbm_per_device takes the whole index")
    return {k: getattr(idx, k).numel() / DEV_BLOCK_U32 for k in
            ("blocks", "sa_sample", "ftab", "ref_words", "fchr")}


def tp_hbm_per_device(idx, n_model: int) -> dict:
    """Device bytes a rank holds, replicated against sharded over n_model
    ranks (``ROW_BYTES`` a row: 512 B a block record, 8 bytes a word of
    the int64 tables), of an FMIndex or an unsharded GpuIndex: the
    capacity the sharding buys."""
    rows = _layout_rows(idx)
    rest = round(sum(rows[k] * ROW_BYTES[k]
                     for k in ("ftab", "ref_words", "fchr")))
    whole = (rows["blocks"] * ROW_BYTES["blocks"]
             + rows["sa_sample"] * ROW_BYTES["sa_sample"])
    per = (-(-rows["blocks"] // n_model) * ROW_BYTES["blocks"]
           + -(-rows["sa_sample"] // n_model) * ROW_BYTES["sa_sample"])
    return {
        "replicated": whole + rest,
        "tp_sharded": per + rest,
        "n_model": n_model,
    }
