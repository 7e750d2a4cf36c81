from .fastq import Read, read_fastq, read_fasta_reads, batch_iterator
from .sam import SamWriter, AlnSummary

__all__ = [
    "Read",
    "read_fastq",
    "read_fasta_reads",
    "batch_iterator",
    "SamWriter",
    "AlnSummary",
]
