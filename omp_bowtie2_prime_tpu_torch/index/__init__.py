from .builder import build_index, build_index_from_text
from .fasta import ReferenceMap, join_references, parse_fasta
from .format import FMIndex, GpuIndex

__all__ = ["FMIndex", "GpuIndex", "build_index", "build_index_from_text",
           "parse_fasta", "join_references", "ReferenceMap"]
