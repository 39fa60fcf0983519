"""Genome container and host-side sequence transforms.

Covers the reference's genome-handling layer:

* gap discovery  — Preprocess.cpp:2098-2154 (``gapInfo.txt`` records)
* scaffold splice/rewrite with negative-gap skip counts — FillGaps.cpp:708-926
* flank trimming — FlankTrim.cpp:21-233
* gapped-scaffold reduction — Reduce_SCF.cpp:14-152

Contigs are stored as int8 code arrays.  For device work the genome is
flattened into one concatenated array plus per-contig offsets so positions are
single integers (``flat_pos = offsets[contig] + pos``).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .dtypes import GAP_CODE, N
from .io.fasta import Fasta


@dataclass
class GapInfo:
    """One gap record == one line of gapInfo.txt (Preprocess.cpp:2144)."""

    contig: int
    start: int  # 0-based index of first N
    length: int  # number of Ns


@dataclass
class Genome:
    names: list[str]
    contigs: list[np.ndarray]  # int8 code arrays

    @classmethod
    def from_fasta(cls, fasta: Fasta) -> "Genome":
        return cls(list(fasta.names), [np.asarray(s, dtype=np.int8) for s in fasta.seqs])

    def to_fasta(self) -> Fasta:
        return Fasta(list(self.names), [s.copy() for s in self.contigs])

    @property
    def n_contigs(self) -> int:
        return len(self.contigs)

    @property
    def lengths(self) -> np.ndarray:
        return np.fromiter((len(c) for c in self.contigs), dtype=np.int64,
                           count=len(self.contigs))

    def total_length(self) -> int:
        return int(self.lengths.sum())

    def flatten(self) -> tuple[np.ndarray, np.ndarray]:
        """Concatenate contigs; returns (flat int8 array, offsets[n_contigs+1])."""
        lens = self.lengths
        offsets = np.zeros(len(lens) + 1, dtype=np.int64)
        np.cumsum(lens, out=offsets[1:])
        flat = (
            np.concatenate(self.contigs)
            if self.contigs
            else np.zeros(0, dtype=np.int8)
        )
        return flat, offsets

    # ------------------------------------------------------------------
    def find_gaps(self, min_len: int = 1) -> list[GapInfo]:
        """Discover N-runs per contig (Preprocess.cpp:2098-2154).

        Note the reference only closes a gap when a non-N character follows, so
        a trailing run of Ns at the very end of a contig is NOT reported — we
        replicate that to keep gap numbering identical.
        """
        gaps: list[GapInfo] = []
        for ci, contig in enumerate(self.contigs):
            is_n = contig == N
            if not is_n.any():
                continue
            d = np.diff(is_n.astype(np.int8))
            starts = np.flatnonzero(d == 1) + 1
            ends = np.flatnonzero(d == -1) + 1  # exclusive
            if is_n[0]:
                starts = np.concatenate([[0], starts])
            # trailing-N run intentionally dropped (no closing non-N char)
            if is_n[-1]:
                starts = starts[: len(ends)]
            for s, e in zip(starts, ends):
                if e - s >= min_len:
                    gaps.append(GapInfo(ci, int(s), int(e - s)))
        return gaps

    # ------------------------------------------------------------------
    def splice_gaps(
        self,
        gaps: list[GapInfo],
        fills: list[np.ndarray | None],
        skip_after: list[int] | None = None,
    ) -> "Genome":
        """Rewrite scaffolds substituting each gap with its fill string.

        Mirrors the FillGaps.cpp:820-915 reconstruction:

        * ``fills[i]`` replaces the N-run of ``gaps[i]`` (may be shorter,
          longer, or empty);
        * ``skip_after[i] > 0`` drops that many reference characters
          immediately after the gap — the negative-gap overlap merge
          (``gaptofill`` counts, FillGaps.cpp:900-909).
        """
        if skip_after is None:
            skip_after = [0] * len(gaps)
        by_contig: dict[int, list[tuple[GapInfo, np.ndarray | None, int]]] = {}
        for g, f, sk in zip(gaps, fills, skip_after):
            by_contig.setdefault(g.contig, []).append((g, f, sk))

        new_contigs: list[np.ndarray] = []
        for ci, contig in enumerate(self.contigs):
            items = sorted(by_contig.get(ci, []), key=lambda t: t[0].start)
            if not items:
                new_contigs.append(contig.copy())
                continue
            parts: list[np.ndarray] = []
            cursor = 0
            for g, fill, sk in items:
                parts.append(contig[cursor : g.start])
                if fill is not None and len(fill) > 0:
                    parts.append(np.asarray(fill, dtype=np.int8))
                cursor = g.start + g.length + max(0, int(sk))
            parts.append(contig[cursor:])
            new_contigs.append(np.concatenate(parts))
        return Genome(list(self.names), new_contigs)

    # ------------------------------------------------------------------
    def flank_trim(self, trim_len: int, read_len: int) -> "Genome":
        """Mask ``trim_len`` bases on each side of qualifying gaps to N.

        Replicates FlankTrim.cpp:175-209: a gap qualifies iff

        * it has >= 2 Ns,
        * its length is < ``read_len``,
        * the ``trim_len`` flanking bases on both sides are N-free,
        * it is at least ``trim_len`` away from both contig ends.
        """
        if trim_len <= 0:
            return self
        out = [c.copy() for c in self.contigs]
        for g in self.find_gaps():
            c = out[g.contig]
            if g.length < 2 or g.length >= read_len:
                continue
            ls, le = g.start - trim_len, g.start
            rs, re = g.start + g.length, g.start + g.length + trim_len
            if ls < 0 or re > len(c):
                continue
            if (c[ls:le] == N).any() or (c[rs:re] == N).any():
                continue
            c[ls:le] = GAP_CODE
            c[rs:re] = GAP_CODE
        return Genome(list(self.names), out)

    # ------------------------------------------------------------------
    def reduce_to_gapped(self) -> tuple["Genome", np.ndarray]:
        """Keep only scaffolds still containing >= 1 N (Reduce_SCF.cpp:14-152).

        Returns the reduced genome and the mapping ``orig_index[i]`` giving the
        original contig index of reduced contig ``i`` (the reference preserves
        this mapping through ``contignums`` in Preprocess.cpp:2134-2142 so
        gapInfo keeps original contig numbers).
        """
        keep = [i for i, c in enumerate(self.contigs) if (c == N).any()]
        g = Genome([self.names[i] for i in keep], [self.contigs[i] for i in keep])
        return g, np.asarray(keep, dtype=np.int64)

    def count_n(self) -> int:
        return int(sum(int((c == N).sum()) for c in self.contigs))
