"""FASTA reading/writing.

Replaces the ad-hoc FASTA readers duplicated across the reference
(Figbird.cpp:6986-7058, FillGaps.cpp:716-788, Preprocess.cpp:2009-2086) and the
60-column re-wrapper ``reference.py`` (reference.py:1-29).

Sequences are returned as int8 code arrays (see :mod:`figbird_tpu_torch.dtypes`);
contig names keep only the first whitespace-delimited token, matching
``strtok(contigName," \\t\\n")`` in the reference readers.
"""

from __future__ import annotations

import io
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterable

import numpy as np

from ..dtypes import decode, encode


@dataclass
class Fasta:
    names: list[str] = field(default_factory=list)
    seqs: list[np.ndarray] = field(default_factory=list)  # int8 code arrays

    def __len__(self) -> int:
        return len(self.names)

    def total_length(self) -> int:
        return int(sum(len(s) for s in self.seqs))


def read_fasta(path: str | Path | io.IOBase) -> Fasta:
    """Parse a FASTA file into encoded contigs (uppercased implicitly by encoding)."""
    if hasattr(path, "read"):
        data = path.read()
        if isinstance(data, str):
            data = data.encode("ascii")
    else:
        data = Path(path).read_bytes()

    names: list[str] = []
    seqs: list[np.ndarray] = []
    chunks: list[bytes] = []

    for line in data.split(b"\n"):
        if not line:
            continue
        if line.startswith(b";"):
            continue
        if line.startswith(b">"):
            if names:
                seqs.append(encode(b"".join(chunks)))
                chunks = []
            names.append(line[1:].split()[0].decode("ascii") if len(line) > 1 else "")
        else:
            chunks.append(line.strip())
    if names:
        seqs.append(encode(b"".join(chunks)))
    return Fasta(names, seqs)


def write_fasta(path: str | Path, fasta: Fasta, width: int = 60) -> None:
    """Write contigs wrapped at ``width`` columns (reference.py:1-29 uses 60)."""
    with open(path, "w") as fh:
        for name, seq in zip(fasta.names, fasta.seqs):
            fh.write(f">{name}\n")
            s = decode(seq)
            for i in range(0, len(s), width):
                fh.write(s[i : i + width])
                fh.write("\n")


def fasta_from_strings(named_seqs: Iterable[tuple[str, str]]) -> Fasta:
    f = Fasta()
    for name, seq in named_seqs:
        f.names.append(name)
        f.seqs.append(encode(seq))
    return f
