"""FM-index containers: host (numpy) and device (torch) layouts.

Counterpart of omp_bowtie2_prime_tpu/index/format.py. ``FMIndex`` reads
and writes the same ``.npz`` container; ``GpuIndex.from_host`` builds the
same arrays as the JAX package's ``DeviceIndex.from_host`` (the 1024-row
block record, the 64-per-row ftab and the 128-per-row SA sample), so the
two compare one to one. torch has no unsigned 32-bit arithmetic worth the
name (no logical right shift, no popcount), so every uint32 word is held
as a non-negative int64 on the device.
"""

from __future__ import annotations

import dataclasses
import pickle

import numpy as np
import torch

OCC_BLOCK = 128  # BWT rows per occ checkpoint block (host format)
WORD_BASES = 16  # 2-bit bases per uint32 word
WORDS_PER_BLOCK = OCC_BLOCK // WORD_BASES  # 8
MARK_WORDS_PER_BLOCK = OCC_BLOCK // 32  # 4

# device block record: 1024 BWT rows in 128 words
DEV_OCC_BLOCK = 1024
DEV_BWT_WORDS = DEV_OCC_BLOCK // WORD_BASES  # 64
DEV_MARK_WORDS = DEV_OCC_BLOCK // 32  # 32
DEV_BWT = 0  # [0:64)   2-bit BWT words
DEV_OCC = DEV_BWT_WORDS  # [64:68)  absolute occ counts at block start
DEV_MARK = DEV_OCC + 4  # [68:100) SA-mark bitmap words
DEV_MARKCP = DEV_MARK + DEV_MARK_WORDS  # [100] marked-row rank at start
DEV_BLOCK_U32 = 128
DEV_FTAB_PER_ROW = 64  # ftab row q//64: top(q) at lane q%64, bot at 64+q%64
DEV_SA_PER_ROW = 128

# rows at or past this need the int64 (.bt2l-scale) path
INT32_ROW_LIMIT = (1 << 31) - 2


@dataclasses.dataclass
class FMIndex:
    """Host-side FM index (numpy arrays); same fields as the JAX package's."""

    n: int  # joined text length
    nrows: int  # n + 1 (includes sentinel row)
    zoff: int  # row where SA == 0 (dummy BWT char stored there)
    fchr: np.ndarray  # [5] int64 C array
    bwt_words: np.ndarray  # [nblocks * WORDS_PER_BLOCK] uint32
    occ_cp: np.ndarray  # [nblocks, 4] int64 abs counts at block start
    ftab_k: int
    ftab_top: np.ndarray  # [4^k] uint32
    ftab_bot: np.ndarray  # [4^k] uint32
    srate: int  # SA sample rate (text positions)
    mark_words: np.ndarray  # [nblocks * MARK_WORDS_PER_BLOCK] uint32 bitmap
    mark_cp: np.ndarray  # [nblocks] int64 marked-row count before block
    sa_sample: np.ndarray  # [nmarked] uint32 SA values of marked rows
    ref_words: np.ndarray  # joined text 2-bit packed, uint32
    refmap: object  # ReferenceMap (host only)

    @property
    def nblocks(self) -> int:
        return self.occ_cp.shape[0]

    def save(self, path: str) -> None:
        arrs = {
            f.name: getattr(self, f.name)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), np.ndarray)
        }
        scalars = {
            f.name: getattr(self, f.name)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), int)
        }
        np.savez_compressed(
            path,
            __scalars__=np.frombuffer(pickle.dumps(scalars), dtype=np.uint8),
            __refmap__=np.frombuffer(pickle.dumps(self.refmap), dtype=np.uint8),
            **arrs,
        )

    @classmethod
    def load(cls, path: str) -> "FMIndex":
        z = np.load(path, allow_pickle=False)
        scalars = pickle.loads(z["__scalars__"].tobytes())
        refmap = _RefmapUnpickler(z["__refmap__"].tobytes()).load()
        arrs = {k: z[k] for k in z.files if not k.startswith("__")}
        return cls(refmap=refmap, **scalars, **arrs)


class _RefmapUnpickler(pickle.Unpickler):
    """Loads a refmap pickled by either package into this package's
    ReferenceMap: the JAX package pickles it under its own class path,
    whose import pulls in flax."""

    def __init__(self, data: bytes):
        import io

        super().__init__(io.BytesIO(data))

    def find_class(self, module, name):
        if name == "ReferenceMap" and module in (
            "omp_bowtie2_prime_tpu.index.fasta",
            "omp_bowtie2_prime_tpu_torch.index.fasta",
        ):
            from .fasta import ReferenceMap

            return ReferenceMap
        return super().find_class(module, name)


def _wide_rows(a: np.ndarray, per_row: int) -> np.ndarray:
    n = (len(a) + per_row - 1) // per_row
    out = np.zeros(n * per_row, np.uint32)
    out[: len(a)] = a
    return out.reshape(-1, per_row)


@dataclasses.dataclass
class GpuIndex:
    """Device-resident FM index: the arrays of the JAX DeviceIndex as
    int64 tensors (uint32 bit patterns, all non-negative)."""

    blocks: torch.Tensor  # [nbd, 128] 1024-row block records
    fchr: torch.Tensor  # [5]
    ftab: torch.Tensor  # [ceil(4^k/64), 128] top | bot interleaved
    sa_sample: torch.Tensor  # [ceil(nmarked/128), 128]
    ref_words: torch.Tensor  # [nrefwords + 128] (zero tail padding)
    zoff: int
    nrows: int
    ftab_k: int
    srate: int

    @classmethod
    def from_host(cls, fm: FMIndex, device) -> "GpuIndex":
        if fm.nrows >= INT32_ROW_LIMIT:
            raise NotImplementedError(
                "indexes of 2^31-2 rows or more need the int64 row path "
                "(ROADMAP.md, port queue: int64-scale indexes)"
            )
        device = torch.device(device)
        # 8 host 128-row blocks per 1024-row device record; checkpoints
        # at a record start are the host checkpoints of its first block
        nbh = fm.nblocks
        nbd = (nbh + 7) // 8
        blocks = np.zeros((nbd, DEV_BLOCK_U32), dtype=np.uint32)
        bw = np.zeros(nbd * DEV_BWT_WORDS, np.uint32)
        bw[: nbh * WORDS_PER_BLOCK] = fm.bwt_words
        blocks[:, DEV_BWT : DEV_BWT + DEV_BWT_WORDS] = bw.reshape(
            nbd, DEV_BWT_WORDS
        )
        blocks[:, DEV_OCC : DEV_OCC + 4] = fm.occ_cp[::8].astype(np.uint32)
        mw = np.zeros(nbd * DEV_MARK_WORDS, np.uint32)
        mw[: nbh * MARK_WORDS_PER_BLOCK] = fm.mark_words
        blocks[:, DEV_MARK : DEV_MARK + DEV_MARK_WORDS] = mw.reshape(
            nbd, DEV_MARK_WORDS
        )
        blocks[:, DEV_MARKCP] = fm.mark_cp[::8].astype(np.uint32)

        F = len(fm.ftab_top)
        nfr = (F + DEV_FTAB_PER_ROW - 1) // DEV_FTAB_PER_ROW
        ftab = np.zeros((nfr, DEV_BLOCK_U32), np.uint32)
        ftab[:, :DEV_FTAB_PER_ROW] = _wide_rows(fm.ftab_top, DEV_FTAB_PER_ROW)
        ftab[:, DEV_FTAB_PER_ROW:] = _wide_rows(fm.ftab_bot, DEV_FTAB_PER_ROW)
        # +128 zero words so the DP window gather's word slices
        # (ops/sw.py gather_ref_windows) never clamp at the text end
        ref_words = np.concatenate(
            [fm.ref_words.astype(np.uint32), np.zeros(128, np.uint32)]
        )

        def put(a):
            return torch.from_numpy(a.astype(np.int64)).to(device)

        return cls(
            blocks=put(blocks),
            fchr=put(np.asarray(fm.fchr)),
            ftab=put(ftab),
            sa_sample=put(_wide_rows(fm.sa_sample, DEV_SA_PER_ROW)),
            ref_words=put(ref_words),
            zoff=int(fm.zoff),
            nrows=int(fm.nrows),
            ftab_k=int(fm.ftab_k),
            srate=int(fm.srate),
        )
