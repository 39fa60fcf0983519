"""Paired-end reconciliation.

Computes what bowtie2's pairing logic + SAM flags gave the reference:
concordance (flag&2, Preprocess.cpp:2447-2593 streaming), fragment/insert
size (TLEN), and per-pair classification:

* ``concordant`` — FR orientation, same contig, insert in (0, max_insert]
* ``model`` — CONCORDANT pairs: the ``myout.sam`` set.  Preprocess routes
  records without SAM flag 0x2 to mixedReads/printMixedVectors (gap
  harvesting, Preprocess.cpp:2458-2516); flag-0x2 groups reach printVectors
  (641-855), which writes every such pair — clipped and non-unique included
  — and overwrites IH with the group size (one record per mate => always
  1), so Figbird's ``nh==1`` filter (processMapping, 846-921) passes for
  all of them.
* ``one_anchored`` — exactly one mate aligned (the unmapped-fill candidates,
  printMixedVectors case 2, Preprocess.cpp:1202)

Coordinates: alignments arrive in padded-flat coords (see index.py) and are
converted here to (contig, 1-based SAM-style pos) for everything downstream,
matching the reference's SAM-derived arithmetic.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .index import KmerIndex


@dataclass
class PairTable:
    """Vectorised per-pair classification (n = number of read pairs)."""

    # per-mate (contig-local) alignment info; pos is 1-based leftmost ALIGNED base
    contig: np.ndarray      # (n, 2) int32, -1 if unaligned
    pos: np.ndarray         # (n, 2) int64 1-based SAM pos (window_start+clip_start)
    strand: np.ndarray      # (n, 2) int8
    aligned: np.ndarray     # (n, 2) bool
    unique: np.ndarray      # (n, 2) bool
    clip_start: np.ndarray  # (n, 2) int32
    clip_end: np.ndarray    # (n, 2) int32
    score: np.ndarray       # (n, 2) int32
    n_mis: np.ndarray       # (n, 2) int32
    window_start: np.ndarray  # (n, 2) int64 padded-flat window start (read char 0)

    concordant: np.ndarray  # (n,) bool
    insert: np.ndarray      # (n,) int64 outer fragment length (0 if not concordant)
    model: np.ndarray       # (n,) bool  — feeds model learning
    one_anchored: np.ndarray  # (n,) int8: -1 none, 0 mate1 anchored, 1 mate2 anchored


def build_pair_table(
    index: KmerIndex,
    a1: dict[str, np.ndarray],
    a2: dict[str, np.ndarray],
    lengths1: np.ndarray,
    lengths2: np.ndarray,
    max_insert: int,
    max_model_clip: int = 0,
) -> PairTable:
    n = len(lengths1)

    def mate(a, lens):
        win = a["pos"].astype(np.int64)
        ref_start_flat = win + a["clip_start"]
        ci, local = index.flat_to_contig(ref_start_flat)
        pos = local + 1  # 1-based SAM pos
        ci = np.where(a["aligned"], ci, -1).astype(np.int32)
        return ci, pos, ref_start_flat

    c1, p1, f1 = mate(a1, lengths1)
    c2, p2, f2 = mate(a2, lengths2)

    contig = np.stack([c1, c2], 1)
    pos = np.stack([p1, p2], 1)
    strand = np.stack([a1["strand"], a2["strand"]], 1)
    aligned = np.stack([a1["aligned"], a2["aligned"]], 1)
    unique = np.stack([a1["unique"], a2["unique"]], 1)
    clip_s = np.stack([a1["clip_start"], a2["clip_start"]], 1)
    clip_e = np.stack([a1["clip_end"], a2["clip_end"]], 1)
    score = np.stack([a1["score"], a2["score"]], 1)
    n_mis = np.stack([a1["n_mis"], a2["n_mis"]], 1)
    win = np.stack([a1["pos"].astype(np.int64), a2["pos"].astype(np.int64)], 1)

    # aligned segment ends (flat coords, exclusive)
    end1 = f1 + a1["alen"]
    end2 = f2 + a2["alen"]

    both = aligned[:, 0] & aligned[:, 1]
    same_contig = both & (c1 == c2)
    opp = strand[:, 0] != strand[:, 1]
    # FR geometry: forward mate leftmost
    fwd_is_1 = strand[:, 0] == 0
    left_start = np.where(fwd_is_1, f1, f2)
    right_end = np.where(fwd_is_1, end2, end1)
    fwd_first = left_start <= np.where(fwd_is_1, f2, f1)
    insert = right_end - left_start
    concordant = same_contig & opp & fwd_first & (insert > 0) & (insert <= max_insert)
    insert = np.where(concordant, insert, 0)

    # the myout.sam set (see module docstring): CONCORDANT pairs — records
    # without SAM flag 0x2 go to mixedReads/printMixedVectors (gap
    # harvesting), never myout (Preprocess.cpp:2458-2516); within myout the
    # reference applies NO uniqueness or full-length requirement (IH is
    # overwritten with the group size = 1), so clipped and non-unique
    # concordant pairs all feed the model
    model = concordant.copy()

    one_anchored = np.full(n, -1, dtype=np.int8)
    one_anchored[aligned[:, 0] & ~aligned[:, 1]] = 0
    one_anchored[aligned[:, 1] & ~aligned[:, 0]] = 1

    return PairTable(
        contig=contig, pos=pos, strand=strand, aligned=aligned, unique=unique,
        clip_start=clip_s, clip_end=clip_e, score=score, n_mis=n_mis,
        window_start=win, concordant=concordant, insert=insert, model=model,
        one_anchored=one_anchored,
    )
