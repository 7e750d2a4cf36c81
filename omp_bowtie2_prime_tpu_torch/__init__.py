"""omp_bowtie2_prime_tpu_torch — the aligner ported to PyTorch and CUDA.

A port of omp_bowtie2_prime_tpu (JAX on a TPU), which stays beside it as
the reference the port is held against. The port imports nothing of that
package. Same layout, same module names:

    index/     host index builder, .npz container, device repack
    ops/       FM rank/LF, seed search, SA walk, rank/frame, DP; the two
               DP kernels are hand-written CUDA (csrc/sw_e2e.cu,
               csrc/sw_local.cu, wrappers in ops/sw_cuda.py)
    models/    TorchAligner: the unpaired pipeline, end to end and local
    utils/     DNA codes, CIGAR/MD, scoring, presets, MAPQ, the RNG,
               timers, suffix array (host, numpy)
    io/        FASTQ/FASTA readers, the SAM writer
    native.py  the g++-built host library (csrc/btcore.cpp): SA-IS, BWT
               pass, batched CIGAR/MD finisher
    cli.py     build / align
"""

__version__ = "0.1.0"
