from .fasta import Fasta, fasta_from_strings, read_fasta, write_fasta
from .fastq import ReadBatch, read_fastq, write_fastq

__all__ = ["Fasta", "read_fasta", "write_fasta", "fasta_from_strings",
           "ReadBatch", "read_fastq", "write_fastq"]
