from .fasta import Fasta, fasta_from_strings, read_fasta, write_fasta
from .fastq import ReadBatch, read_fastq, write_fastq
from .sam import read_sam_pairs, write_sam

__all__ = [
    "Fasta",
    "read_fasta",
    "write_fasta",
    "fasta_from_strings",
    "ReadBatch",
    "read_fastq",
    "write_fastq",
    "read_sam_pairs",
    "write_sam",
]
