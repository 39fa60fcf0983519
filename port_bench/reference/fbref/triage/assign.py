"""Read -> gap assignment (the Preprocess.cpp triage layer).

Builds per-gap read bundles from alignment pair tables:

* **unmapped bundles** — one-end-anchored pairs whose free mate is dropped
  into a gap by anchor geometry ``checkPos`` (Preprocess.cpp:536-614):
  frag libs (maxDistance<=250): anchor within maxDistance upstream (fwd) /
  downstream (rev) of the gap; jump libs: insert-geometry pick closest to the
  library mean with a +/-1000 admission window and a 0.4*mean floor.
  The free mate is stored genome-oriented per the anchor strand with the
  ``is_reverse`` cycle flag, replicating Preprocess case-2 + parseUnmapped
  (Preprocess.cpp:1202-1343, Figbird.cpp:5727-5736).

* **partial bundles** — clipped reads overhanging gap edges, assigned by
  ``checkPos2`` (Preprocess.cpp:616-639) and encoded like writePartialSam
  (Preprocess.cpp:425-502): oriented seq, clipped_index, 4-way match code
  (1=left-fwd, 2=right-fwd, 3=right-rev, 4=left-rev), SAM pos, mate ref pos.

  The reference only harvests *left-anchored* overhangs (match 1/4) plus
  deletion-spanning right reads; left-clipped reads anchored on the right
  flank are discarded ("Only S--M, so discard", Preprocess.cpp:458-461).
  We additionally admit those as match 2/3 (``use_right_clipped=True``,
  a capability superset; set False for reference parity).

Caps (3000/gap) and first-come order match the reference; dedup is exact
sequence hashing (the reference's jump-mode substring check is approximated
by also hashing the 2-char-trimmed middle, Preprocess.cpp:362-402).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..dtypes import GAP_CODE, PARTIAL_LIMIT, UNMAPPED_LIMIT, revcomp
from ..genome import GapInfo
from ..align.index import KmerIndex
from ..align.pairing import PairTable
from ..io.fastq import ReadBatch


@dataclass
class GapBundle:
    """Per-gap read sets, ragged (host side)."""

    gap: GapInfo
    # unmapped-mode reads
    u_seq: list = field(default_factory=list)       # genome-oriented int8 arrays
    u_pos: list = field(default_factory=list)       # anchor SAM pos (1-based)
    u_rev: list = field(default_factory=list)       # is_reverse cycle flag
    # partial-mode reads
    p_seq: list = field(default_factory=list)       # oriented int8 arrays
    p_clip: list = field(default_factory=list)      # clipped_index
    p_match: list = field(default_factory=list)     # 1..4
    p_pos: list = field(default_factory=list)       # read SAM pos (1-based)
    p_refpos: list = field(default_factory=list)    # mate SAM pos or -1
    p_qual: list = field(default_factory=list)      # per-base error prob arrays
    mim_flag: int = 0   # checkMIM (Preprocess.cpp:885-925): xMyIzM spanner seen
    mim_len: int = 0    # implied gap length (i_len + 1)
    _u_hashes: set = field(default_factory=set)
    _p_hashes: set = field(default_factory=set)

    @property
    def n_unmapped(self) -> int:
        return len(self.u_seq)

    @property
    def n_partial(self) -> int:
        return len(self.p_seq)


def _gap_lookup_frag(gaps: list[GapInfo], contig: int, pos1: int, strand: int,
                     max_distance: int) -> int:
    """checkPos fast path for maxDistance<=250 (Preprocess.cpp:552-556)."""
    for i, g in enumerate(gaps):
        if g.contig != contig:
            if g.contig > contig:
                break
            continue
        if strand == 0 and g.start - max_distance < pos1 < g.start:
            return i
        ge = g.start + g.length
        if strand == 1 and ge < pos1 < ge + max_distance:
            return i
    return -1


def _gap_lookup_jump(gaps: list[GapInfo], contig: int, pos1: int, strand: int,
                     readlen: int, max_distance: int, read_mean: float) -> int:
    """checkPos insert-geometry path for jump libs (Preprocess.cpp:557-613)."""
    best_i, best_abs = -1, 1 << 30
    n_match, last_i = 0, -1
    chosen_ins: dict[int, int] = {}
    for i, g in enumerate(gaps):
        if g.contig != contig:
            if g.contig > contig:
                break
            continue
        ge = g.start + g.length
        in_window = (strand == 0 and g.start - max_distance < pos1 < g.start) or (
            strand == 1 and ge < pos1 < ge + max_distance
        )
        if not in_window:
            continue
        if pos1 < g.start:
            v0 = ge - pos1 + readlen
            v1 = g.start - pos1 + 1
        else:
            v0 = pos1 - g.start + 2 * readlen - 1
            v1 = pos1 - ge + readlen + 1
        lo, hi = read_mean - 1000, read_mean + 1000
        in_range = (lo < v0 < hi) or (lo < v1 < hi) or (
            (v0 < lo and v1 > hi) or (v1 < lo and v0 > hi)
        )
        ins = 0
        if in_range:
            ins = v0 if abs(read_mean - v0) < abs(read_mean - v1) else v1
        if ins != 0:
            n_match += 1
            last_i = i
        chosen_ins[i] = ins
        a = abs(read_mean - ins)
        if a < best_abs:
            best_abs, best_i = a, i
    if n_match == 0:
        return -1
    ci = last_i if n_match == 1 else best_i
    if chosen_ins.get(ci, 0) < read_mean - read_mean * 0.6:
        return -1
    return ci


def _checkpos2(gaps: list[GapInfo], contig: int, pos1: int, readlen: int) -> int:
    """checkPos2 left-overhang test (Preprocess.cpp:616-639), no-deletion case."""
    for i, g in enumerate(gaps):
        if g.contig != contig:
            continue
        if g.start - readlen + 1 < pos1 <= g.start:
            return i
    return -1


def _seq_ok(seq: np.ndarray, frac: float = 0.8) -> bool:
    """Reject reads that are mostly N (Preprocess ncount 80% filter)."""
    return (seq == GAP_CODE).mean() < frac


class Triage:
    """Builds GapBundles for one library pass."""

    def __init__(self, gaps: list[GapInfo], max_distance: int, read_mean: float,
                 is_jump: bool, use_right_clipped: bool = True,
                 partial_limit: int = PARTIAL_LIMIT,
                 unmapped_limit: int = UNMAPPED_LIMIT):
        self.gaps = gaps
        self.max_distance = max_distance
        self.read_mean = read_mean
        self.is_jump = is_jump
        self.use_right_clipped = use_right_clipped
        self.partial_limit = partial_limit
        self.unmapped_limit = unmapped_limit
        self.bundles = [GapBundle(g) for g in gaps]
        # index gaps by contig for fast lookup
        self._by_contig: dict[int, list[tuple[int, GapInfo]]] = {}
        for i, g in enumerate(gaps):
            self._by_contig.setdefault(g.contig, []).append((i, g))
        # vectorised lookup keys: gaps are (contig, start)-sorted already
        BIG = np.int64(1) << 40
        self._BIG = BIG
        self._gs_key = np.array([g.contig * BIG + g.start for g in gaps],
                                np.int64)
        self._ge_key = np.array(
            [g.contig * BIG + g.start + g.length for g in gaps], np.int64)

    def _checkpos2_vec(self, contig: np.ndarray, pos1: np.ndarray,
                       rl: np.ndarray) -> np.ndarray:
        """Vectorised _checkpos2: first gap with pos1 <= start < pos1+rl-1."""
        if len(self._gs_key) == 0:
            return np.full(len(contig), -1, np.int64)
        key = contig.astype(np.int64) * self._BIG + pos1
        idx = np.searchsorted(self._gs_key, key, side="left")
        idxc = np.clip(idx, 0, len(self._gs_key) - 1)
        ok = idx < len(self._gs_key)
        start_key = self._gs_key[idxc]
        ok = ok & (start_key - (rl - 1) < key) & (start_key // self._BIG ==
                                                  contig)
        return np.where(ok, idxc, -1)

    def _checkpos_frag_vec(self, contig: np.ndarray, pos1: np.ndarray,
                           strand: np.ndarray) -> np.ndarray:
        """Vectorised _gap_lookup_frag (first matching gap in scan order)."""
        key = contig.astype(np.int64) * self._BIG + pos1
        md = self.max_distance
        n = len(self._gs_key)
        out = np.full(len(key), -1, np.int64)
        if n == 0:
            return out
        # strand 0: first gap with start > pos1 and start < pos1 + md
        i0 = np.searchsorted(self._gs_key, key, side="right")
        i0c = np.clip(i0, 0, n - 1)
        ok0 = (i0 < n) & (self._gs_key[i0c] < key + md) & \
              (self._gs_key[i0c] // self._BIG == contig)
        # strand 1: first gap with end > pos1 - md and end < pos1
        i1 = np.searchsorted(self._ge_key, key - md, side="right")
        i1c = np.clip(i1, 0, n - 1)
        ok1 = (i1 < n) & (self._ge_key[i1c] < key) & \
              (self._ge_key[i1c] // self._BIG == contig)
        out = np.where(strand == 0, np.where(ok0, i0c, -1),
                       np.where(ok1, i1c, -1))
        return out

    def _checkpos_jump_vec(self, contig: np.ndarray, pos1: np.ndarray,
                           strand: np.ndarray, readlen: np.ndarray,
                           max_neighbors: int = 16) -> np.ndarray:
        """Vectorised jump-path checkPos (Preprocess.cpp:536-614).

        For every candidate anchor, enumerate up to ``max_neighbors`` gaps
        whose position window contains the anchor, apply the insert-geometry
        admission (checkRange/checkInsert) and pick per the reference's
        flag/min-|mean-ins| rule.  Replaces the per-candidate Python loop —
        the chr14/human-scale wall.
        """
        n = len(contig)
        out = np.full(n, -1, np.int64)
        ng = len(self._gs_key)
        if ng == 0 or n == 0:
            return out
        md = self.max_distance
        mean = self.read_mean
        key = contig.astype(np.int64) * self._BIG + pos1
        # first gap that could match: strand 0 windows need start > pos1
        # (>= pos1+1); strand 1 windows need end < pos1 but end > pos1-md
        lo0 = np.searchsorted(self._gs_key, key, side="right")
        lo1 = np.searchsorted(self._ge_key, key - md, side="right")
        first = np.where(strand == 0, lo0, lo1)
        glen_all = (self._ge_key - self._gs_key).astype(np.int64)

        flag_cnt = np.zeros(n, np.int64)
        last_i = np.full(n, -1, np.int64)
        last_ins = np.zeros(n, np.int64)
        best_abs = np.full(n, 1 << 30, np.float64)
        best_i = np.full(n, -1, np.int64)
        best_ins = np.zeros(n, np.int64)
        for off in range(max_neighbors):
            gi = np.clip(first + off, 0, ng - 1)
            ok = (first + off < ng) & (self._gs_key[gi] // self._BIG == contig)
            gs = self._gs_key[gi] - contig.astype(np.int64) * self._BIG
            ge = gs + glen_all[gi]
            in_win = np.where(
                strand == 0,
                (pos1 > gs - md) & (pos1 < gs),
                (pos1 > ge) & (pos1 < ge + md))
            ok &= in_win
            v0 = np.where(pos1 < gs, ge - pos1 + readlen,
                          pos1 - gs + 2 * readlen - 1)
            v1 = np.where(pos1 < gs, gs - pos1 + 1,
                          pos1 - ge + readlen + 1)
            lo, hi = mean - 1000, mean + 1000
            in_range = ((lo < v0) & (v0 < hi)) | ((lo < v1) & (v1 < hi)) | \
                (((v0 < lo) & (v1 > hi)) | ((v1 < lo) & (v0 > hi)))
            ins = np.where(
                ok & in_range,
                np.where(np.abs(mean - v0) < np.abs(mean - v1), v0, v1), 0)
            nz = ok & (ins != 0)
            flag_cnt += nz
            last_i = np.where(nz, gi, last_i)
            last_ins = np.where(nz, ins, last_ins)
            a = np.abs(mean - ins)
            upd = ok & (a < best_abs)
            best_abs = np.where(upd, a, best_abs)
            best_i = np.where(upd, gi, best_i)
            best_ins = np.where(upd, ins, best_ins)
        ci = np.where(flag_cnt == 1, last_i, best_i)
        ci_ins = np.where(flag_cnt == 1, last_ins, best_ins)
        min_thresh = int(mean - mean * 0.6)  # C int truncation
        sel = (flag_cnt > 0) & (ci_ins >= min_thresh) & (ci >= 0)
        return np.where(sel, ci, -1)

    # -------------------------------------------------------------- unmapped
    def _check_pos(self, contig: int, pos1: int, strand: int, readlen: int) -> int:
        items = self._by_contig.get(contig, [])
        sub = [g for _, g in items]
        if self.max_distance <= 250:
            j = _gap_lookup_frag(sub, contig, pos1, strand, self.max_distance)
        else:
            j = _gap_lookup_jump(sub, contig, pos1, strand, readlen,
                                 self.max_distance, self.read_mean)
        return items[j][0] if j >= 0 else -1

    def _add_unmapped(self, gi: int, anchor_pos1: int, anchor_strand: int,
                      mate_fastq: np.ndarray) -> None:
        b = self.bundles[gi]
        if b.n_unmapped >= self.unmapped_limit:
            return
        # genome orientation per anchor strand (parseUnmapped, Figbird.cpp:5727)
        if anchor_strand == 0:
            seq = revcomp(mate_fastq)
            rev = 1
        else:
            seq = mate_fastq.copy()
            rev = 0
        h = seq.tobytes()
        hm = seq[2:-2].tobytes() if self.is_jump and len(seq) > 4 else h
        if h in b._u_hashes or (self.is_jump and hm in b._u_hashes):
            return
        b._u_hashes.add(h)
        if self.is_jump:
            b._u_hashes.add(hm)
        b.u_seq.append(seq)
        b.u_pos.append(int(anchor_pos1))
        b.u_rev.append(rev)

    def collect_unmapped(self, pt: PairTable, reads1: ReadBatch, reads2: ReadBatch
                         ) -> None:
        """Unmapped pass (samflag==2): one-anchored pairs -> gaps_<g> bundles.

        Only pairs whose MATE1 is mapped and MATE2 unmapped are harvested —
        the mirrored case 3 (mate1 unmapped) is commented out in the
        reference (Preprocess.cpp:1380-1463), so those pairs are dropped.
        For jump libs (maxDistance>250) both-mapped discordant pairs are also
        used in both anchor directions (Preprocess.cpp:1202-1343).
        """
        if not self.gaps:  # fully-filled genome: nothing to harvest
            return
        reads = (reads1, reads2)
        oa = np.asarray(pt.one_anchored)
        both = np.asarray(pt.aligned[:, 0]) & np.asarray(pt.aligned[:, 1])
        conc = np.asarray(pt.concordant)

        if self.max_distance <= 250:
            # frag path, fully vectorised prefilter: mate1-anchored pairs
            sel = np.flatnonzero(oa == 0)
            if len(sel) == 0:
                return
            am = oa[sel]
            contig = np.asarray(pt.contig)[sel, am]
            pos1 = np.asarray(pt.pos)[sel, am]
            strand = np.asarray(pt.strand)[sel, am]
            gi = self._checkpos_frag_vec(contig, pos1, strand)
            gi = np.where(contig >= 0, gi, -1)
            for t in np.flatnonzero(gi >= 0):
                i = int(sel[t])
                c_m = 1 - int(am[t])
                clen = int(reads[c_m].length[i])
                seq = reads[c_m].seq[i, :clen]
                if _seq_ok(seq):
                    self._add_unmapped(int(gi[t]), int(pos1[t]),
                                       int(strand[t]), seq)
            return

        # jump path: vectorised insert-geometry checkPos over the candidate
        # subset; insertion order (pair row, then anchor direction) matches
        # the reference stream so dedup/caps stay reproducible
        sel = np.flatnonzero((oa == 0) | (both & ~conc))
        if len(sel) == 0:
            return
        cand = []  # (row, anchor_mate, free_mate)
        for i in sel:
            o = int(oa[i])
            anchors = [(o, 1 - o)] if o >= 0 else [(0, 1), (1, 0)]
            for a_m, c_m in anchors:
                if int(pt.contig[i, a_m]) >= 0:
                    cand.append((int(i), a_m, c_m))
        if not cand:
            return
        rows = np.array([c[0] for c in cand])
        a_ms = np.array([c[1] for c in cand])
        c_ms = np.array([c[2] for c in cand])
        contig = np.asarray(pt.contig)[rows, a_ms]
        pos1 = np.asarray(pt.pos)[rows, a_ms]
        strand = np.asarray(pt.strand)[rows, a_ms]
        rl = np.where(c_ms == 0, reads[0].length[rows], reads[1].length[rows])
        gi_v = self._checkpos_jump_vec(contig, pos1, strand,
                                       rl.astype(np.int64))
        for t in np.flatnonzero(gi_v >= 0):
            i, c_m = int(rows[t]), int(c_ms[t])
            clen = int(reads[c_m].length[i])
            seq = reads[c_m].seq[i, :clen]
            if _seq_ok(seq):
                self._add_unmapped(int(gi_v[t]), int(pos1[t]),
                                   int(strand[t]), seq)

    # -------------------------------------------------------------- partial
    def _add_partial(self, gi: int, seq_oriented: np.ndarray, clipped_index: int,
                     match: int, pos1: int, ref_pos: int,
                     qual_err: np.ndarray | None) -> None:
        b = self.bundles[gi]
        if b.n_partial >= self.partial_limit:
            return
        h = seq_oriented.tobytes()
        if h in b._p_hashes:
            return
        b._p_hashes.add(h)
        b.p_seq.append(seq_oriented)
        b.p_clip.append(int(clipped_index))
        b.p_match.append(int(match))
        b.p_pos.append(int(pos1))
        b.p_refpos.append(int(ref_pos))
        b.p_qual.append(
            qual_err if qual_err is not None
            else np.full(len(seq_oriented), 1e-3, np.float32)
        )

    def collect_partial(self, pt: PairTable, reads1: ReadBatch, reads2: ReadBatch,
                        oriented1: np.ndarray | None = None,
                        oriented2: np.ndarray | None = None,
                        align1: dict | None = None,
                        align2: dict | None = None) -> None:
        """Partial pass (samflag==1): clipped/overhanging mates -> partial bundles.

        ``oriented{1,2}`` are the reads in reference orientation (RC'd when the
        alignment is on the reverse strand) — the SAM SEQ field equivalent.
        When omitted, candidate rows (a small subset) are oriented on the fly,
        which avoids materialising full-batch RC copies.

        ``align{1,2}`` (aligner output dicts) enable the indel path: reads the
        banded tier aligned with I/D ops count as non-perfect (CIGAR != xM)
        and xMyIzM single-insertion spanners set the per-gap MIM perfect-read
        flag natively (checkMIM, Preprocess.cpp:885-925) instead of the
        brute-force flank rescan fallback.
        """
        from ..dtypes import phred_to_error_prob

        if not self.gaps:  # fully-filled genome: nothing to harvest
            return
        oriented = (oriented1, oriented2)
        reads = (reads1, reads2)
        aligns = (align1, align2)
        conc_v = np.asarray(pt.concordant)
        oa_v = np.asarray(pt.one_anchored)
        imperfect = (np.asarray(pt.clip_start).max(axis=1) > 0) | \
                    (np.asarray(pt.clip_end).max(axis=1) > 0)
        for a in aligns:
            if a is not None and "indel" in a:
                imperfect = imperfect | a["indel"]
        aligned_v = np.asarray(pt.aligned)
        contig_v = np.asarray(pt.contig)
        pos_v = np.asarray(pt.pos)

        # vectorised prefilter: per (pair, mate) candidacy, then the two gap
        # lookups (left overhang / right-clipped) — Python only touches hits
        cand_rows = []
        for m in range(2):
            # mixed (non-concordant) pairs: only the MAPPED MATE1 records
            # reach checkPos2 — the mate2-mapped mirror is the commented-out
            # case 3 (Preprocess.cpp:1346-1367 vs 1380-1463).  Both-mapped
            # discordant pairs enter case 2 as well when maxDistance > 250.
            if m == 0:
                both_v = aligned_v[:, 0] & aligned_v[:, 1]
                mixed_ok = (oa_v == 0) | (
                    both_v & ~conc_v & (self.max_distance > 250))
            else:
                mixed_ok = np.zeros(len(oa_v), bool)
            mask = aligned_v[:, m] & np.where(conc_v, imperfect, mixed_ok)
            sel = np.flatnonzero(mask)
            if len(sel) == 0:
                continue
            rl_v = reads[m].length[sel].astype(np.int64)
            gi_left = self._checkpos2_vec(contig_v[sel, m], pos_v[sel, m],
                                          rl_v)
            keep = gi_left >= 0
            if self.use_right_clipped:
                # checkPos2's right clause (Preprocess.cpp:616-639): SAM pos
                # (1-based) > gapEnd, a leading clip del>0, and
                # pos - del <= gapEnd — i.e. gapEnd in [pos0-del+1, pos0]
                # (0-based pos0 = pos-1).  Take the FIRST such gap.
                cs_v = np.asarray(pt.clip_start)[sel, m].astype(np.int64)
                pos0 = pos_v[sel, m] - 1
                ckey = contig_v[sel, m].astype(np.int64) * self._BIG
                ng = len(self._ge_key)
                lo_key = ckey + pos0 - cs_v + 1
                i_lo = np.searchsorted(self._ge_key, lo_key, side="left")
                i_loc = np.clip(i_lo, 0, max(ng - 1, 0))
                okr = (ng > 0) & (cs_v > 0) & (i_lo < ng) & \
                      (self._ge_key[i_loc] <= ckey + pos0) & \
                      (self._ge_key[i_loc] // self._BIG == contig_v[sel, m])
                gi_right = np.where(okr, i_loc, -1)
                keep = keep | (gi_right >= 0)
            else:
                gi_right = np.full(len(sel), -1)
            for t in np.flatnonzero(keep):
                cand_rows.append((int(sel[t]), m, int(gi_left[t]),
                                  int(gi_right[t])))
        cand_rows.sort()  # reference scan order: by pair row, then mate

        for i, m, gi, gi2 in cand_rows:
            conc = bool(conc_v[i])
            pos1 = int(pt.pos[i, m])
            strand = int(pt.strand[i, m])
            rl = int(reads[m].length[i])
            ref_pos = int(pt.pos[i, 1 - m]) if conc else -1
            if oriented[m] is not None:
                seq = oriented[m][i, :rl]
            else:
                raw = reads[m].seq[i, :rl]
                seq = revcomp(raw) if strand == 1 else raw
            if not _seq_ok(seq):
                continue
            qual = reads[m].qual
            if qual is not None:
                q = qual[i, :rl]
                if strand == 1:
                    q = q[::-1]
                qerr = phred_to_error_prob(q)
            else:
                qerr = None
            # checkPos2 returns the FIRST gap satisfying either clause, so
            # when both match, the smaller gap index wins
            if gi >= 0 and gi2 >= 0 and gi2 < gi:
                gi = -1
            if gi >= 0:
                g = self.gaps[gi]
                a_m = aligns[m]
                if a_m is not None and i in a_m.get("indel_detail", {}):
                    tb = a_m["indel_detail"][i]
                    ops = tb["ops"]
                    # checkMIM: exactly M I M, no clips (S) or deletions
                    if (tb["read_start"] == 0 and tb["read_end"] == rl
                            and len(ops) == 3
                            and [c for c, _ in ops] == ["M", "I", "M"]):
                        b = self.bundles[gi]
                        b.mim_flag = 1
                        b.mim_len = ops[1][1] + 1
                # left-anchored overhang (writePartialSam pos<gap_s branch)
                cs, ce = int(pt.clip_start[i, m]), int(pt.clip_end[i, m])
                if cs > 0 and ce > 0:
                    clipped_index = rl - ce - 1  # S-M-S
                elif cs > 0:
                    continue  # "Only S--M, so discard" (ref parity)
                else:
                    clipped_index = g.start - pos1  # M... (1-based pos)
                match = 1 if strand == 0 else 4
                self._add_partial(gi, seq, clipped_index, match, pos1,
                                  ref_pos, qerr)
            elif gi2 >= 0:
                # capability superset: left-clipped read anchored at right flank
                cs = int(pt.clip_start[i, m])
                g = self.gaps[gi2]
                ge = g.start + g.length
                clipped_index = cs - ((pos1 - 1) - ge)
                match = 2 if strand == 0 else 3
                self._add_partial(gi2, seq, clipped_index, match, pos1,
                                  ref_pos, qerr)
