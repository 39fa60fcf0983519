"""Cross-iteration gap-string combination.

Replaces CombineGaps.cpp: per original gap, keep the resolved left/right
fragments from earlier iterations and splice each later iteration's fill into
the remaining N-region (combine 65-124 using checkComplete 32-63).  Later
iterations only carry records for gaps that are not yet fully closed, so the
record streams are aligned by skipping closed gaps (main 231-266).

Outputs the ``Individual_gaps.txt`` table
(``GapNo  Original_Length  Filled_Length  seq``, 291-305).
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np

from .dtypes import N, decode


@dataclass
class CombinedGap:
    original_len: int
    seq: np.ndarray  # int8; may contain an interior N region
    fully_closed: bool


def _n_region(s: np.ndarray) -> tuple[int, int, int]:
    """checkComplete: (#N-runs, first N index, last N index)."""
    isn = np.flatnonzero(s == N)
    if isn.size == 0:
        return 0, -1, -1
    runs = 1 + int(np.sum(np.diff(isn) > 1))
    return runs, int(isn[0]), int(isn[-1])


def combine_gap_history(history: list) -> list[CombinedGap]:
    """history: per-iteration (gaps, strings, skips) from PipelineResult."""
    if not history:
        return []
    gaps0, strings0, _ = history[0]
    out: list[CombinedGap] = []
    for g, s in zip(gaps0, strings0):
        s = np.asarray(s, np.int8)
        rc, _, _ = _n_region(s)
        out.append(CombinedGap(g.length, s.copy(), rc == 0))

    for gaps_i, strings_i, _ in history[1:]:
        it = iter(zip(gaps_i, strings_i))
        for cg in out:
            if cg.fully_closed:
                continue
            try:
                g, s = next(it)
            except StopIteration:
                break
            s = np.asarray(s, np.int8)
            rc, first_n, last_n = _n_region(cg.seq)
            if rc == 0:
                cg.fully_closed = True
                continue
            new = np.concatenate([cg.seq[:first_n], s, cg.seq[last_n + 1 :]])
            cg.seq = new
            rc2, _, _ = _n_region(new)
            cg.fully_closed = rc2 == 0
    return out


def write_individual_gaps(path: str | Path, combined: list[CombinedGap]) -> None:
    with open(path, "w") as fh:
        fh.write("GapNo\tOriginal_Length\tFilled_Length\tseq\n\n")
        for i, cg in enumerate(combined):
            fh.write(f"{i}\t{cg.original_len}\t{len(cg.seq)}\t{decode(cg.seq)}\n")
