"""Per-gap read-placement visualisation.

Replaces the reference's ``draw<tid>.txt`` / ``alignment_<itr>.txt`` artifact
(draw_read, Figbird.cpp:2385-2428; merged in FillGaps.cpp:690-692;
Manual.pdf p.5-6): for every filled gap, the final consensus line with each
accepted read rendered at its placement offset — the de-facto trace of the
EM placement.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..dtypes import decode
from ..genome import GapInfo


def render_gap(gap_no: int, gap: GapInfo, consensus: np.ndarray,
               placements: list[tuple[int, int, np.ndarray]],
               left_flank: np.ndarray, right_flank: np.ndarray,
               max_reads: int = 200) -> str:
    """One gap's drawing: flanked consensus + one line per placed read.

    ``placements``: (read_index, gap_relative_pos, oriented_seq).
    """
    lf = decode(left_flank).lower()
    rf = decode(right_flank).lower()
    pad = len(left_flank)
    lines = [
        f">gap {gap_no}  contig {gap.contig}  start {gap.start}  "
        f"origLen {gap.length}  filledLen {len(consensus)}  "
        f"reads {len(placements)}",
        lf + decode(consensus) + rf,
    ]
    for ridx, pos, seq in placements[:max_reads]:
        off = pad + pos
        s = decode(seq)
        if off < 0:
            s = s[-off:]
            off = 0
        lines.append(" " * off + s + f"  <{ridx}>")
    return "\n".join(lines) + "\n"


def write_draw_file(path: str | Path, records: list[str]) -> None:
    with open(path, "w") as fh:
        for r in records:
            fh.write(r)
            fh.write("\n")
