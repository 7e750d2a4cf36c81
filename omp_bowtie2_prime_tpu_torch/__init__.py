"""omp_bowtie2_prime_tpu_torch — the aligner ported to PyTorch and CUDA.

A port of omp_bowtie2_prime_tpu (JAX on a TPU), which stays beside it as
the reference the port is held against. Same layout:

    index/     host index builder, .npz container, device repack
    ops/       FM rank/LF, seed search, SA walk, rank/frame, DP; the DP
               kernel is hand-written CUDA (csrc/sw_e2e.cu, ops/sw_cuda.py)
    models/    TorchAligner: the unpaired end-to-end pipeline
    cli.py     build / align

FASTQ/SAM I/O, scoring, MAPQ, the RNG and the native finisher are
imported from the JAX package's jax-free modules.
"""

__version__ = "0.1.0"
