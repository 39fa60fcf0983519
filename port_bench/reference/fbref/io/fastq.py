"""FASTQ reading into dense read batches.

Replaces the per-record C stdio parsing scattered through the reference
(Reverse.cpp:42-120, Preprocess.cpp read streaming).  Reads come back as a
:class:`ReadBatch`: a dense ``(n, max_len)`` int8 matrix padded with N plus a
length vector — the layout every downstream device kernel consumes.

Copy of ``figbird_tpu/io/fastq.py``.  A native C++ fast path
(``native/figbird_native.cpp``, through :mod:`.native`) is used when the
shared library builds; the numpy fallback gives the same batch.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np

from ..dtypes import COMPLEMENT, GAP_CODE, _CHAR_TO_CODE


@dataclass
class ReadBatch:
    """Dense batch of reads: ``seq[i, :length[i]]`` are code values, tail is N-padded."""

    seq: np.ndarray  # (n, max_len) int8
    length: np.ndarray  # (n,) int32
    qual: np.ndarray | None = None  # (n, max_len) uint8 phred+33, 0-padded

    def __len__(self) -> int:
        return self.seq.shape[0]

    @property
    def max_len(self) -> int:
        return self.seq.shape[1]

    def take(self, idx: np.ndarray) -> "ReadBatch":
        """Row subset (boolean mask or integer indices) — the in-memory form
        of the reference's read reduction (Preprocess.cpp reWriteReadset
        1696-1731 writing ``*_reduced.fastq``)."""
        return ReadBatch(self.seq[idx], self.length[idx],
                         None if self.qual is None else self.qual[idx])

    def revcomp(self) -> "ReadBatch":
        """Reverse-complement every read in place of its own length.

        Matches Reverse.cpp:14-39 semantics (per-read RC, qualities reversed).
        """
        n, L = self.seq.shape
        comp = COMPLEMENT[self.seq]
        if n == 0 or np.all(self.length == L):
            # uniform-length fast path (the overwhelmingly common case):
            # a full-row reverse, no per-row gather
            out = comp[:, ::-1].copy()
            outq = None if self.qual is None else self.qual[:, ::-1].copy()
            return ReadBatch(out, self.length.copy(), outq)
        # vectorised per-length reversal: build gather indices length-1-j clipped
        j = np.arange(L, dtype=np.int32)[None, :]
        src = self.length.astype(np.int32)[:, None] - 1 - j  # (n, L)
        valid = src >= 0
        src_c = np.clip(src, 0, L - 1)
        rows = np.arange(n, dtype=np.int32)[:, None]
        out = np.where(valid, comp[rows, src_c], GAP_CODE).astype(np.int8)
        outq = None
        if self.qual is not None:
            outq = np.where(valid, self.qual[rows, src_c], 0).astype(self.qual.dtype)
        return ReadBatch(out, self.length.copy(), outq)


def read_fastq(path: str | Path, max_len: int | None = None, with_qual: bool = True,
               limit: int | None = None) -> ReadBatch:
    """Parse a FASTQ file (4-line records) into a ReadBatch.

    The numpy parser (the port's native C++ parser is not copied).
    """
    data = Path(path).read_bytes()
    lines = data.split(b"\n")
    # records: id, seq, +, qual
    nrec = len(lines) // 4
    if limit is not None:
        nrec = min(nrec, limit)
    seqs = [lines[4 * i + 1] for i in range(nrec)]
    lens = np.fromiter((len(s) for s in seqs), dtype=np.int32, count=nrec)
    L = int(max_len if max_len is not None else (lens.max() if nrec else 0))
    seq = np.full((nrec, L), GAP_CODE, dtype=np.int8)
    qual = np.zeros((nrec, L), dtype=np.uint8) if with_qual else None
    for i in range(nrec):
        s = np.frombuffer(seqs[i], dtype=np.uint8)[:L]
        seq[i, : len(s)] = _CHAR_TO_CODE[s]
        if with_qual:
            q = np.frombuffer(lines[4 * i + 3], dtype=np.uint8)[:L]
            qual[i, : len(q)] = q
    lens = np.minimum(lens, L)
    return ReadBatch(seq, lens, qual)


def write_fastq(path: str | Path, batch: ReadBatch, prefix: str = "r") -> None:
    from ..dtypes import decode

    with open(path, "w") as fh:
        for i in range(len(batch)):
            L = int(batch.length[i])
            s = decode(batch.seq[i, :L])
            q = (
                batch.qual[i, :L].tobytes().decode("ascii")
                if batch.qual is not None
                else "I" * L
            )
            fh.write(f"@{prefix}{i}\n{s}\n+\n{q}\n")
