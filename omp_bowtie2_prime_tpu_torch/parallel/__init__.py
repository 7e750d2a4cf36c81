"""Multi-GPU work: one process per GPU under torch.distributed.

Counterpart of omp_bowtie2_prime_tpu/parallel/: ``mesh`` (data parallel,
the index replicated), ``tp_index`` (the index sharded by row, one
all_reduce per LF step) and ``distributed`` (process groups, per-host
read shards and their ordered merge). NCCL between GPUs, gloo on the CPU.
"""
