from .core import Aligner, AlignParams
from .index import KmerIndex, build_index
from .pairing import PairTable, build_pair_table

__all__ = [
    "KmerIndex",
    "build_index",
    "Aligner",
    "AlignParams",
    "PairTable",
    "build_pair_table",
]
