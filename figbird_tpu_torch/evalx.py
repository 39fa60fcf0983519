"""Assembly evaluation.

The reference evaluates with vendored QUAST 2.3 + correct_quast.py
(RunFigbird.sh:794-830), emitting six metrics: misassemblies, erroneous
length, unaligned length, NGA50, #gaps, total gap length
(correct_quast.py:405-409).  QUAST itself is a missing archive in the
reference repo; here we compute the directly-computable subset natively plus
truth-based metrics for simulated data:

* gap statistics (#gaps, total gap length) — correct_quast.py:352-365;
* N50 of the assembly;
* against a known truth genome: filled-base identity at original gap
  positions and the gap-closure set.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .dtypes import N
from .genome import GapInfo, Genome


@dataclass
class AssemblyStats:
    n_contigs: int
    total_length: int
    n50: int
    n_gaps: int
    total_gap_length: int


def assembly_stats(genome: Genome) -> AssemblyStats:
    lens = np.sort(genome.lengths)[::-1]
    total = int(lens.sum())
    c = np.cumsum(lens)
    n50 = int(lens[np.searchsorted(c, total / 2)]) if total else 0
    gaps = genome.find_gaps()
    return AssemblyStats(
        n_contigs=genome.n_contigs,
        total_length=total,
        n50=n50,
        n_gaps=len(gaps),
        total_gap_length=int(sum(g.length for g in gaps)),
    )


@dataclass
class FillAccuracy:
    n_gaps: int
    closed: int            # gaps with no N left (same-length fills)
    filled_bases: int
    correct_bases: int
    total_gap_bases: int

    @property
    def identity(self) -> float:
        return self.correct_bases / max(self.filled_bases, 1)

    @property
    def fill_rate(self) -> float:
        return self.filled_bases / max(self.total_gap_bases, 1)


@dataclass
class EvalReport:
    """The reference's six-metric tuple (correct_quast.py:405-409)."""

    misassemblies: int
    erroneous_length: int
    unaligned_length: int
    nga50: int
    n_gaps: int
    total_gap_length: int

    def as_table(self) -> str:
        return ("Misassemblies\tErroneous_length\tUnaligned_length\tNGA50\t"
                "Num_gaps\tTotal_gap_length\n"
                f"{self.misassemblies}\t{self.erroneous_length}\t"
                f"{self.unaligned_length}\t{self.nga50}\t{self.n_gaps}\t"
                f"{self.total_gap_length}\n")


def _ref_kmer_table(ref: Genome, k: int):
    """Sorted (code, flat_pos) k-mer table over the reference (both strands
    handled by looking up the block's own RC)."""
    flat, offsets = ref.flatten()
    codes_l, pos_l = [], []
    v = flat.astype(np.int64)
    valid = v < 4
    code = np.zeros(len(v) - k + 1, np.int64)
    ok = np.ones(len(v) - k + 1, bool)
    for j in range(k):
        w = v[j : j + len(code)]
        code = code * 4 + np.minimum(w, 3)
        ok &= valid[j : j + len(code)]
    codes_l, pos_l = code[ok], np.flatnonzero(ok)
    order = np.argsort(codes_l, kind="stable")
    return codes_l[order], pos_l[order].astype(np.int64), flat


def _block_diagonals(block: np.ndarray, codes, pos, k: int, stride: int):
    """Anchor k-mers of a block against the table; return (qpos, rpos) hits."""
    if len(block) < k:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    starts = np.arange(0, len(block) - k + 1, stride)
    v = block.astype(np.int64)
    ok = np.ones(len(starts), bool)
    code = np.zeros(len(starts), np.int64)
    for j in range(k):
        w = v[starts + j]
        code = code * 4 + np.minimum(w, 3)
        ok &= w < 4
    starts, code = starts[ok], code[ok]
    lo = np.searchsorted(codes, code, side="left")
    hi = np.searchsorted(codes, code, side="right")
    cnt = hi - lo
    uniq = cnt == 1  # unique anchors only (repeat-proof)
    return starts[uniq], pos[lo[uniq]]


def _anchor_both_strands(block, codes, pos, k, stride):
    """Unique anchors on both strands: (q, r, strand) sorted by q.

    Reverse-strand anchors are mapped back to forward block coordinates
    (q = block position of the k-mer start); their consistency invariant is
    the ANTI-diagonal r + q."""
    from .dtypes import revcomp

    qf, rf = _block_diagonals(block, codes, pos, k, stride)
    qr_rev, rr = _block_diagonals(revcomp(block), codes, pos, k, stride)
    qr = len(block) - k - qr_rev  # forward coords of the RC k-mer
    q = np.concatenate([qf, qr])
    r = np.concatenate([rf, rr])
    st = np.concatenate([np.zeros(len(qf), np.int8),
                         np.ones(len(qr), np.int8)])
    order = np.argsort(q, kind="stable")
    return q[order], r[order], st[order]


def evaluate_against_reference(asm: Genome, ref: Genome, k: int = 21,
                               stride: int = 20,
                               local_misassembly_max: int = 1000,
                               indel_tol: int = 5,
                               reclass_n: int = 4000,
                               min_block: int = 100) -> EvalReport:
    """Reference-based evaluation replacing QUAST 2.3 + correct_quast.py.

    Mirrors the quantities of RunFigbird.sh:794-830 / correct_quast.py:405-409:

    * contigs split at remaining N-runs into blocks; blocks anchored to the
      reference by unique k-mers on BOTH strands; anchors chained into
      alignment segments.  A |diagonal| jump > ``local_misassembly_max``, a
      strand flip, or a reference-contig change is an *extensive misassembly*
      breakpoint (QUAST's relocation/inversion/translocation classes); jumps
      in (indel_tol, local_misassembly_max] are *local* misassemblies whose
      inconsistency feeds erroneous length (get_sum_local_misassemblies,
      correct_quast.py:244-253); jumps <= indel_tol are indels
      (get_sum_indels).
    * correct_quast reclassification (get_sum_large_misassemblies --N,
      correct_quast.py:197-241): an extensive breakpoint whose shorter
      flanking segment is <= ``reclass_n`` is downgraded to local — it is not
      counted as a misassembly and its length feeds erroneous length instead.
    * erroneous length = mismatches within segments + indel lengths + local
      inconsistencies + reclassified segment lengths (correct_quast.py:408).
    * NGA50 over segments broken at every misassembly (--strict-NA,
      RunFigbird.sh:813) vs the reference genome size; unaligned = block
      bases outside any segment.
    """
    codes, pos, ref_flat = _ref_kmer_table(ref, k)
    ref_total = int(ref.total_length())

    seg_lengths: list[int] = []
    misassemblies = 0
    unaligned = 0
    mismatch_len = 0
    indel_len = 0
    local_len = 0
    reclass_len = 0

    def seg_mismatches(block, q0, q1, r0, strand):
        """Mismatch count comparing the segment at its leading diagonal."""
        from .dtypes import revcomp

        n = q1 - q0
        a = block[q0:q1] if strand == 0 else revcomp(block[q0:q1])
        b = ref_flat[r0 : r0 + n]
        n = min(len(a), len(b))
        return int((a[:n] != b[:n]).sum())

    for contig in asm.contigs:
        isn = contig == N
        bounds = np.flatnonzero(np.diff(np.concatenate(
            [[True], isn, [True]]).astype(np.int8)))
        for bi in range(0, len(bounds) - 1):
            s, e = int(bounds[bi]), int(bounds[bi + 1])
            if isn[s] if s < len(isn) else True:
                continue
            block = contig[s:e]
            if len(block) < min_block:
                continue
            q, r, st = _anchor_both_strands(block, codes, pos, k, stride)
            if len(q) == 0:
                unaligned += len(block)
                continue
            # consistency invariant per strand: r - q (fwd), r + q (rev)
            inv = np.where(st == 0, r - q, r + q)
            segs = []  # (i0, i1) inclusive anchor index ranges
            i0 = 0
            for i in range(1, len(q)):
                jump = abs(int(inv[i]) - int(inv[i - 1]))
                flip = st[i] != st[i - 1]
                if flip or jump > local_misassembly_max:
                    segs.append((i0, i - 1))  # extensive boundary
                    i0 = i
                elif jump > indel_tol:
                    local_len += jump
                    segs.append((i0, i - 1))  # --strict-NA: break at local
                    i0 = i
                elif jump:
                    indel_len += jump
            segs.append((i0, len(q) - 1))
            # anchor spans; block edges within one stride of the terminal
            # anchors are part of the terminal alignments (anchor resolution,
            # not divergence)
            spans = [[int(q[a]), int(q[b]) + k] for a, b in segs]
            if spans and spans[0][0] <= stride + k:
                spans[0][0] = 0
            if spans and len(block) - spans[-1][1] <= stride + k:
                spans[-1][1] = len(block)
            for q0, q1 in spans:
                if q1 - q0 >= min_block:
                    seg_lengths.append(q1 - q0)
            # classify each boundary; apply correct_quast reclassification
            for si in range(1, len(segs)):
                b_prev = segs[si - 1][1]
                a_cur = segs[si][0]
                jump = abs(int(inv[a_cur]) - int(inv[b_prev]))
                flip = st[a_cur] != st[b_prev]
                if not flip and jump <= local_misassembly_max:
                    continue  # local boundary, already in local_len
                left_len = int(q[b_prev]) + k - int(q[segs[si - 1][0]])
                right_len = int(q[segs[si][1]]) + k - int(q[a_cur])
                shorter = min(left_len, right_len)
                if shorter <= reclass_n:
                    reclass_len += shorter  # extensive -> local downgrade
                else:
                    misassemblies += 1
            for (a, b), (q0, q1) in zip(segs, spans):
                if q1 - q0 >= min_block:
                    # leading diagonal from the first anchor, shifted to the
                    # (possibly extended) span start
                    if st[a] == 0:
                        r0 = int(r[a]) - (int(q[a]) - q0)
                    else:
                        r0 = int(r[b]) - (q1 - (int(q[b]) + k))
                    mismatch_len += seg_mismatches(block, q0, q1,
                                                   max(r0, 0), int(st[a]))
            covered = sum(q1 - q0 for q0, q1 in spans)
            unaligned += max(len(block) - covered, 0)

    seg_lengths.sort(reverse=True)
    nga50 = 0
    cum = 0
    for L in seg_lengths:
        cum += L
        if cum >= ref_total / 2:
            nga50 = L
            break

    st_all = assembly_stats(asm)
    return EvalReport(
        misassemblies=misassemblies,
        erroneous_length=int(mismatch_len + indel_len + local_len
                             + reclass_len),
        unaligned_length=int(unaligned),
        nga50=int(nga50),
        n_gaps=st_all.n_gaps,
        total_gap_length=st_all.total_gap_length,
    )


def fill_accuracy_vs_truth(truth: Genome, gaps: list[GapInfo],
                           strings: list[np.ndarray]) -> FillAccuracy:
    """Per-gap identity of same-length fills against the truth genome."""
    closed = filled = correct = total = 0
    for g, s in zip(gaps, strings):
        tr = truth.contigs[g.contig][g.start : g.start + g.length]
        total += g.length
        if len(s) != g.length:
            continue  # resized gap: identity needs alignment; count as open
        m = s != N
        filled += int(m.sum())
        correct += int((s[m] == tr[m]).sum())
        if m.all():
            closed += 1
    return FillAccuracy(len(gaps), closed, filled, correct, total)
