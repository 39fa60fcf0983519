"""Host orchestration of the gap-fill EM (``figbird_tpu/fill/driver.py``).

1. host pre-analysis per gap (flanks, repeats, negative-gap merge, findFrac
   length ranges) — the numpy helpers are copied from the reference, whose
   module imports JAX;
2. in unmapped mode, the read-count probe of small gaps (checkGapReads);
3. a batched device scan over candidate gap lengths whose sequential
   early-exit heuristics are replayed on the host (fillGap 6298-6482); the
   unmapped EM runs staged (8 iterations, then the full cap, then the
   reference's 200 for lanes still unconverged);
4. the winner re-run, a finalize pass against the best string, and the host
   guard battery.

The soft counts run at the production default (the exact 6-level cascade,
kernel K1) or at one of the precision tiers of ``fill_gaps``.
"""

from __future__ import annotations

import logging
import time as _time
from dataclasses import dataclass, field, replace
from functools import partial

import numpy as np
import torch

from ..dtypes import GAP_CODE, N
from ..genome import GapInfo
from ..ops import canonical_device, entry_device
from ..parallel.sharded import sharded_fill
from .em import (_CASCADE_GROUP, SCAN_COLS, FillConfig,
                 fill_batch_full_packed, fill_batch_scan,
                 finalize_batch_packed, finalize_packed_layout,
                 full_packed_layout, partial_stack_full)

logger = logging.getLogger("figbird_tpu_torch.fill")

SIDE_LIMIT = 30
GAPTHRESH = 400          # FillGaps.cpp:22 (mid_limitu)
PARTIAL_SAME = 4         # fillGap 6258
JUMP_SAME = 50
PARTIAL_THRESHOLD = 2    # setParameters
GAP_BUCKETS = (128, 512, 1024, 2048, 4096, 8192)
COUNT_BUCKETS = (128, 1024, 3072)
STAGE_ITERS = 8          # first stage of the unmapped scan
REF_EM_ITERS = 200       # the reference's num_itr (Figbird.cpp:6225)
EM_ITERS_UNMAPPED = 48   # the unmapped EM's default iteration count


@dataclass
class GapPlan:
    gap: GapInfo
    bundle: object
    left_flank: np.ndarray   # up to side_limit chars
    right_flank: np.ndarray
    side_limit: int
    skip: bool = False       # repeat/empty -> leave as N
    neg_merge: int = 0       # >0: close gap, skip this many chars after
    lengths: list = field(default_factory=list)
    side_flag: bool = False
    large_gap: bool = False
    perfect_flag: int = 0    # checkMIM equivalent
    perfect_len: int = 0
    # unmapped small-gap probe failed (checkGapReads): the reference then
    # finalizes with saved_reads all zero, so nothing is accepted and the
    # gap stays N
    less_read: bool = False


@dataclass
class FillResult:
    gap_strings: list       # np.int8 arrays (the filled gap content)
    gaptofill: np.ndarray   # per-gap skip counts
    stats: dict
    placements: list = None  # per-gap [(read_idx, gap_pos, seq)]
    second_best: list = None
    mim: np.ndarray = None


# ---------------------------------------------------------------- analysis

def _count_nonoverlap_hits(reads: np.ndarray, lens: np.ndarray,
                           pat: np.ndarray) -> np.ndarray:
    """Per read: does ``pat`` occur >= 2 times (non-overlapping)?"""
    P, L = reads.shape
    m = len(pat)
    if m == 0 or m > L:
        return np.zeros(P, bool)
    nw = L - m + 1
    w = np.lib.stride_tricks.sliding_window_view(reads, m, axis=1)
    hit = (w == pat[None, None, :]).all(axis=2)  # (P, nw)
    hit &= np.arange(nw)[None, :] + m <= lens[:, None]
    out = np.zeros(P, bool)
    for r in np.flatnonzero(hit.sum(axis=1) >= 2):
        posns = np.flatnonzero(hit[r])
        cnt, nxt = 0, -1
        for p in posns:
            if p >= nxt:
                cnt += 1
                nxt = p + m
        out[r] = cnt >= 2
    return out


def _find_repeats(plan: GapPlan) -> tuple[bool, bool]:
    """findRepeat (1799-1911): (two_sided, one_sided) flank repeats inside
    a partial read (testing the shortest candidate substring suffices)."""
    n_min = 20
    if not plan.bundle.p_seq:
        return False, False
    L = max(len(s) for s in plan.bundle.p_seq)
    reads, lens = _pad_reads(plan.bundle.p_seq, L, len(plan.bundle.p_seq),
                             fill=-1)
    fl = np.zeros(len(reads), bool)
    fr = np.zeros(len(reads), bool)
    if len(plan.left_flank) > n_min:
        fl = _count_nonoverlap_hits(reads, lens,
                                    plan.left_flank[-(n_min + 1):])
    if len(plan.right_flank) > n_min:
        fr = _count_nonoverlap_hits(reads, lens,
                                    plan.right_flank[: n_min + 1])
    return bool((fl & fr).any()), bool((fl | fr).any())


def _neg_gap_merge(plan: GapPlan, neg_overlap: int) -> int:
    """find_contig_match (2176-2267): flank overlap verified by a partial
    read; returns the overlap length or 0."""
    if plan.gap.length > neg_overlap:
        return 0
    s1, s2 = plan.left_flank, plan.right_flank
    err_thresh = 2
    for i in range(max(plan.side_limit - 3, 0)):
        s3 = s1[i:]
        s4 = s2[: len(s2) - i]
        if len(s4) == 0 or len(s3) < len(s4):
            continue
        if s3.tobytes().find(s4.tobytes()) < 0:
            continue
        rem = s2[len(s4):]
        for seq in plan.bundle.p_seq:
            if len(seq) <= len(s1):
                continue
            best_match, best_pos = -1, -1
            for j in range(len(seq) - len(s1)):
                match = len(s1) - int((seq[j : j + len(s1)] != s1).sum())
                if match > best_match:
                    best_match, best_pos = match, j
            if len(s1) - best_match <= err_thresh:
                newpos = best_pos + len(s1)
                if len(rem) == 0:
                    return len(s4)
                tail = seq[newpos : newpos + len(rem)]
                if len(tail) == len(rem) and \
                        (tail != rem).sum() <= err_thresh:
                    return len(s4)
    return 0


def _find_perfect_mim(plan: GapPlan, max_orig: int = 20,
                      mism_tol: int = 1) -> tuple[int, int]:
    """checkMIM equivalent: a read holding a left-flank suffix, then
    ``ilen`` inserted bases, then the right-flank prefix -> (1, ilen+1)."""
    if plan.gap.length > max_orig:
        return 0, 0
    lf, rf = plan.left_flank, plan.right_flank
    a = min(len(lf), 15)
    if a < 10 or len(rf) < 8:
        return 0, 0
    la = lf[-a:]
    nr = len(rf)
    for s in plan.bundle.p_seq:
        n = len(s)
        if n <= a + 8:
            continue
        wl = np.lib.stride_tricks.sliding_window_view(s, a)
        cand_p = np.flatnonzero(
            (wl[: n - a - 8] != la[None, :]).sum(axis=1) <= mism_tol)
        if not cand_p.size:
            continue
        nw = n - 8 + 1
        wr = np.lib.stride_tricks.sliding_window_view(
            np.concatenate([s, np.full(nr, -1, s.dtype)]), nr)[:nw]
        D = np.concatenate(
            [np.zeros((nw, 1), np.int32),
             np.cumsum(wr != rf[None, :], axis=1, dtype=np.int32)], axis=1)
        for p in cand_p:
            end_l = int(p) + a
            hi = min(n - end_l - 7, 3 * max_orig)
            for ilen in range(1, hi):
                q = end_l + ilen
                b = min(nr, n - q)
                if b < 8:
                    break
                if D[q, b] <= mism_tol:
                    return 1, ilen + 1
    return 0, 0


def _find_frac(orig: int, partial_mode: bool,
               partial_len: int) -> tuple[float, float, bool]:
    """findFrac (6879-6906): length-range fractions + large-gap flag."""
    factor = 3 * partial_len
    mid_limitp = 2 * partial_len
    if partial_mode:
        if orig <= mid_limitp // 2:
            return 1e-5, factor / max(orig, 1), False
        if orig <= mid_limitp:
            return 1e-5, 5.0, False
        return 1.0, 1.0, False
    if orig <= GAPTHRESH // 3:
        return 0.3, factor / max(orig, 1), False
    if orig <= GAPTHRESH:
        return 0.5, 2.5, False
    return 1.0, 1.0, True


def plan_gaps(genome, gaps, bundles, partial_mode: bool, partial_len: int,
              neg_overlap: int, max_scan_lengths: int = 160
              ) -> list[GapPlan]:
    plans = []
    for g, b in zip(gaps, bundles):
        contig = genome.contigs[g.contig]
        rroom = len(contig) - (g.start + g.length)
        sl = min(SIDE_LIMIT, g.start, rroom)
        lf = contig[max(g.start - sl, 0) : g.start]
        rf = contig[g.start + g.length : g.start + g.length + sl]
        plan = GapPlan(g, b, lf, rf, sl)

        if b.n_partial == 0 and b.n_unmapped == 0:
            plan.skip = True
            plans.append(plan)
            continue
        two, one = _find_repeats(plan)
        if partial_mode and (two or (one and g.length > 6 * partial_len)):
            plan.skip = True
            plans.append(plan)
            continue
        if sl > 0 and not one:
            plan.neg_merge = _neg_gap_merge(plan, neg_overlap)
            if plan.neg_merge > 0:
                plans.append(plan)
                continue
        if partial_mode and b.n_partial:
            if getattr(b, "mim_flag", 0):
                # native MIM from the banded aligner tier
                plan.perfect_flag, plan.perfect_len = b.mim_flag, b.mim_len
            else:
                plan.perfect_flag, plan.perfect_len = _find_perfect_mim(plan)
        if sl < 10:
            plan.side_flag = True
            plan.lengths = [g.length]
            plans.append(plan)
            continue
        f1, f2, plan.large_gap = _find_frac(g.length, partial_mode,
                                            partial_len)
        lengths = list(range(int(g.length * f1), int(g.length * f2) + 1))
        if g.length not in lengths:
            lengths.append(g.length)
        if max_scan_lengths and len(lengths) > max_scan_lengths:
            # stride-sampled scan plus the original length
            stride = -(-len(lengths) // max_scan_lengths)
            lengths = sorted(set(lengths[::stride]) | {g.length})
        plan.lengths = lengths
        plans.append(plan)
    return plans


# ---------------------------------------------------------------- batching

def model_arrays(model, L: int) -> dict:
    """Per-cycle model arrays of the EM (numpy, f32)."""
    e = np.asarray(model.error_pos_dist, np.float32)
    ip = np.asarray(model.in_pos_dist, np.float32)
    dp = np.asarray(model.del_pos_dist, np.float32)

    def at(v, idx):
        return v[np.clip(idx, 0, len(v) - 1)]

    j = np.arange(L)
    jr = L - 1 - j
    e_fwd = at(e, j)
    e_rev = at(e, jr)
    et = np.asarray(model.error_type_probs, np.float32)
    return dict(
        e_fwd=e_fwd, e_rev=e_rev,
        a_fwd=np.log(np.maximum(1 - at(e, j) - at(ip, j) - at(dp, j), 1e-30)),
        a_rev=np.log(np.maximum(1 - at(e, jr) - at(ip, jr) - at(dp, jr),
                                1e-30)),
        b_fwd=np.log(np.maximum(e_fwd, 1e-30)),
        b_rev=np.log(np.maximum(e_rev, 1e-30)),
        et=et, ln_et=np.log(np.maximum(et, 1e-30)),
        ln_ins=np.log(np.maximum(np.asarray(model.insert_dist_smoothed,
                                            np.float64), 1e-300)
                      ).astype(np.float32))


def _pad_reads(seqs, L, n_pad, fill=GAP_CODE):
    out = np.full((n_pad, L), fill, np.int8)
    lens = np.zeros(n_pad, np.int32)
    for i, s in enumerate(seqs[:n_pad]):
        k = min(len(s), L)
        out[i, :k] = s[:k]
        lens[i] = k
    return out, lens


def _replay_scan(lengths, lik, valid, orig, partial_mode, extras=None):
    """Replay fillGap's sequential plateau/early-exit logic (6398-6478).
    Returns (best_index, evaluated_count, used_read_varied, exited,
    second_best_index); ``exited`` is True when a break fired.  The unmapped
    mode's ``extras`` (per-candidate ``edge`` and ``discont`` flags) drive
    its further exits."""
    same_thresh = PARTIAL_SAME if partial_mode else JUMP_SAME
    best_i, second, second_i = 0, -np.inf, -1
    best_lik = -np.inf
    same = 0
    sec_same = sec_same2 = stuck = 0
    prev_lik = 0.0
    prev_best = -1
    prev_u = -1
    n_eval = 0
    exited = False
    for j, (le, lk, vc) in enumerate(zip(lengths, lik, valid)):
        n_eval = j + 1
        if lk > best_lik:
            second = best_lik
            second_i = best_i if np.isfinite(best_lik) else -1
            best_lik = lk
            best_i = j
            prev_u = vc
        elif lk > second:
            second = lk
            second_i = j
        same = same + 1 if abs(prev_lik - lk) <= 0.9 else 0
        prev_lik = lk
        if same == same_thresh:
            exited = True
            break
        if not partial_mode and extras is not None:
            if best_i == prev_best and abs(vc - prev_u) <= 2:
                sec_same += 1
            else:
                prev_best = best_i
                sec_same = 0
            if sec_same >= 2 * same_thresh:
                exited = True
                break
            if orig <= 30:
                sec_same2 = 0 if extras["edge"][j] else sec_same2 + 1
                if sec_same2 >= int(1.5 * same_thresh):
                    exited = True
                    break
            if extras["discont"][j] and vc < 5:
                stuck += 1
            else:
                stuck = 0
            if stuck > 3 * same_thresh:
                exited = True
                break
    used = np.asarray(valid[:n_eval])
    varied = bool(len(used) > 1 and np.any(used != used[0]))
    return best_i, n_eval, varied, exited, second_i


# ---------------------------------------------------------------- guards

def _host_consensus(counts: np.ndarray, gap_len: int) -> np.ndarray:
    """computeSequence(1,0) on the gap zone counts -> codes with N."""
    c = counts[:gap_len]
    mx = c.max(axis=1)
    return np.where(mx > 0, c.argmax(axis=1), N).astype(np.int8)


def _find_region(cons: np.ndarray) -> list[tuple[int, int]]:
    """findRegion (4594-4621): maximal N runs as (start, end) inclusive."""
    isn = cons == N
    if not isn.any():
        return []
    d = np.diff(isn.astype(np.int8))
    starts = list(np.flatnonzero(d == 1) + 1)
    ends = list(np.flatnonzero(d == -1))
    if isn[0]:
        starts = [0] + starts
    if isn[-1]:
        ends = ends + [len(cons) - 1]
    return list(zip(starts, ends))


def _find_discontinuous(pos: np.ndarray, lens: np.ndarray, accept: np.ndarray
                        ) -> list[int]:
    """findDiscontinous (4623-4666): adjacent overlap in [0, 2] -> N
    position."""
    order = np.argsort(np.where(accept, pos, -200))
    sp = np.where(accept, pos, -200)[order]
    sl = lens[order]
    out = []
    for i in range(len(sp) - 1):
        if sp[i] == -200:
            continue
        diff = sp[i] + sl[i] - sp[i + 1]
        if 0 <= diff <= 2:  # match_count_discont/2
            out.append(int(sp[i] + sl[i]))
    return out


def _recheck_sequence(cons, pos, lens, accept, orig_gap, region_perct) -> int:
    """recheck_sequence (4668-4743): N-out discontinuities and erode around
    unfilled regions.  Mutates ``cons``; returns 1 => full reset."""
    gl = len(cons)
    for dp in _find_discontinuous(pos, lens, accept):
        if 0 <= dp < gl:
            cons[dp] = N
    regions = _find_region(cons)
    flag = len(_find_discontinuous(pos, lens, accept))
    if orig_gap < 400:
        red = 1.0
    elif orig_gap < 1200:
        red = 1.5
    else:
        red = 2.0
    readchar = 30
    if len(regions) <= 1:
        if len(regions) == 1:
            if region_perct < 0.75 or flag > 0:
                r0, r1 = regions[0]
                i = r0 - 1
                while i >= max(r0 - int(red * readchar), 0):
                    cons[i] = N
                    i -= 1
                j = r1 + 1
                while j < min(r1 + 1 + int(red * readchar), gl):
                    cons[j] = N
                    j += 1
                if i < 0 and j == gl:
                    return 1
    else:
        start = regions[0][0]
        end = regions[-1][1]
        cons[start:end] = N
        i = start - 1
        while i > start - 1 - int(red * readchar) and i >= 0:
            cons[i] = N
            i -= 1
        j = end + 1
        while j < end + 1 + int(red * readchar) and j < gl:
            cons[j] = N
            j += 1
        if i < 0 and j == gl:
            return 1
    return 0


def _detect_overlap_host(plan: GapPlan, accept, pos, gap_len
                         ) -> tuple[int, int]:
    """Host detect_overlap_gapestimate for the finalize pass: (ret0, ret1)
    = (300, 0) perfect; (max_overlap, 0); (0, 0); (0, -1) false overlap."""
    seqs = plan.bundle.p_seq
    matches = plan.bundle.p_match
    P = len(seqs)
    sl = plan.side_limit
    lf, rf = plan.left_flank, plan.right_flank
    l_max, r_min = -1 << 20, 1 << 20
    for k in range(P):
        if not accept[k]:
            continue
        p = int(pos[k])
        reach = min(p + len(seqs[k]), gap_len) - 1
        if matches[k] in (1, 4) or p < 0:
            l_max = max(l_max, reach)
        elif p < gap_len:
            r_min = min(r_min, max(p, 0))
    if l_max == -1 << 20:
        l_max = -1
    if r_min == 1 << 20:
        r_min = gap_len

    def _lflank_ok(k, thresh, min_len):
        p, s = int(pos[k]), seqs[k]
        f = min(-p, sl)
        if f < min_len or len(lf) < f:
            return False
        frag = s[-p - f : -p]
        if len(frag) != f:
            return False
        frac = (lf[-f:] != frag).mean()
        return frac <= thresh if min_len == 8 else frac < thresh

    def _rflank_ok(k, thresh, min_len):
        p, s = int(pos[k]), seqs[k]
        startr = gap_len - p
        if startr < 0 or startr > len(s):
            return False
        f = min(sl, len(s) - startr)
        if f < min_len or len(rf) < f:
            return False
        frac = (rf[:f] != s[startr : startr + f]).mean()
        return frac <= thresh if min_len == 8 else frac < thresh

    for k in range(P):
        if not accept[k]:
            continue
        p, s = int(pos[k]), seqs[k]
        if p < 0 and p + len(s) > gap_len:
            if _lflank_ok(k, 0.08, 8) and _rflank_ok(k, 0.08, 8):
                return 300, 0
    if (plan.perfect_flag == 1 and plan.gap.length <= 20
            and gap_len == plan.perfect_len):
        return 300, 0

    if r_min > l_max:
        return 0, 0
    left_cross = [k for k in range(P) if accept[k] and pos[k] < 0
                  and min(pos[k] + len(seqs[k]), gap_len) - 1 >= r_min
                  and pos[k] + len(seqs[k]) <= gap_len][:1000]
    right_cross = [(k, False) for k in range(P)
                   if accept[k] and 0 < pos[k] <= l_max]
    right_cross += [(k, True) for k in range(P)
                    if accept[k] and pos[k] < 0
                    and pos[k] + len(seqs[k]) > gap_len
                    and matches[k] in (2, 3)]
    right_cross = sorted(right_cross)[:1000]
    max_ov, false_flag = 0, 0
    for i in left_cross:
        for j, sm in right_cross:
            if i == j:
                continue
            p1, l1 = int(pos[i]), len(seqs[i])
            p2, l2 = int(pos[j]), len(seqs[j])
            dg = max(p1 + l1 - gap_len, 0)
            ov = (p1 + l1 - 1) - p2 + 1 - dg
            if ov < 5:
                continue
            if not (_lflank_ok(i, 0.2, 4) and _rflank_ok(j, 0.2, 4)):
                continue
            xabs = -p2 if sm else 0
            cmp_len = ov - xabs
            a1s = l1 - ov + xabs - dg
            if cmp_len <= 0 or a1s < 0 or xabs + cmp_len > l2:
                continue
            frac = (seqs[i][a1s : a1s + cmp_len]
                    != seqs[j][xabs : xabs + cmp_len]).mean()
            if frac <= 0.1:
                max_ov = max(max_ov, cmp_len)
            else:
                false_flag = -1
    if (false_flag == 0 and max_ov >= 5) or (false_flag == -1
                                             and max_ov >= 10):
        return max_ov, 0
    if false_flag == -1 or max_ov < 5:
        return 0, -1
    return 0, 0


def _check_update(cnt_row, qual_row) -> int:
    """check_update (4535-4581): ambiguous-column resolution by quality."""
    order = np.argsort(-cnt_row[:4], kind="stable")
    maxp, sec_p = int(order[0]), int(order[1])
    mx, sec = cnt_row[maxp], cnt_row[sec_p]
    if mx - sec >= PARTIAL_THRESHOLD:
        if mx > 3 and sec > 3:
            return maxp if qual_row[maxp] <= qual_row[sec_p] else sec_p
        return 50
    if mx >= 1 and sec >= 1:
        return maxp if qual_row[maxp] <= qual_row[sec_p] else sec_p
    return -1


def _quant(x: int, buckets) -> int:
    for b in buckets:
        if x <= b:
            return b
    return x


def _build_gap_arrays(genome, plans_sub: list[GapPlan], cfg: FillConfig,
                      device) -> dict:
    """Per-GAP padded arrays (built and uploaded once per bucket) plus the
    per-gap partial-stack halves (computed once on the device)."""
    G = len(plans_sub)
    L = cfg.L
    RW = cfg.max_gap_len + L
    arr = dict(
        orig_gap=np.zeros(G, np.int32), gap_start=np.zeros(G, np.int32),
        side_limit=np.zeros(G, np.int32),
        perfect_gap=np.zeros(G, np.int32),
        perfect_gaplen=np.zeros(G, np.int32),
        left_win=np.full((G, cfg.WL), 5, np.int8),
        right_win=np.full((G, RW), 5, np.int8),
        pr=np.full((G, cfg.P, L), GAP_CODE, np.int8),
        p_len=np.zeros((G, cfg.P), np.int32),
        p_clip=np.zeros((G, cfg.P), np.int32),
        p_match=np.ones((G, cfg.P), np.int32),
        p_pos=np.zeros((G, cfg.P), np.int32),
        p_refpos=np.full((G, cfg.P), -1, np.int32),
        p_valid=np.zeros((G, cfg.P), bool),
        p_qerr=np.zeros((G, cfg.P, L), np.float32),
        ur=np.full((G, cfg.R, L), GAP_CODE, np.int8),
        u_len=np.zeros((G, cfg.R), np.int32),
        u_pos=np.zeros((G, cfg.R), np.int32),
        u_rev=np.zeros((G, cfg.R), np.int8),
        u_valid=np.zeros((G, cfg.R), bool),
    )
    for i, plan in enumerate(plans_sub):
        g = plan.gap
        contig = genome.contigs[g.contig]
        arr["orig_gap"][i] = g.length
        arr["gap_start"][i] = g.start
        arr["side_limit"][i] = plan.side_limit
        arr["perfect_gap"][i] = plan.perfect_flag
        arr["perfect_gaplen"][i] = plan.perfect_len
        lchars = contig[max(g.start - cfg.WL, 0) : g.start]
        arr["left_win"][i, cfg.WL - len(lchars):] = lchars
        rs = g.start + g.length
        rchars = contig[rs : rs + RW]
        arr["right_win"][i, : len(rchars)] = rchars
        b = plan.bundle
        if cfg.unmapped_mode and b.n_unmapped:
            seq, lens = _pad_reads(b.u_seq, L, cfg.R)
            n = min(b.n_unmapped, cfg.R)
            arr["ur"][i] = seq
            arr["u_len"][i] = lens
            arr["u_pos"][i, :n] = np.asarray(b.u_pos[:n], np.int32)
            arr["u_rev"][i, :n] = np.asarray(b.u_rev[:n], np.int8)
            arr["u_valid"][i, :n] = True
        if b.n_partial:
            seq, lens = _pad_reads(b.p_seq, L, cfg.P)
            n = min(b.n_partial, cfg.P)
            arr["pr"][i] = seq
            arr["p_len"][i] = lens
            arr["p_clip"][i, :n] = np.asarray(b.p_clip[:n], np.int32)
            arr["p_match"][i, :n] = np.asarray(b.p_match[:n], np.int32)
            arr["p_pos"][i, :n] = np.asarray(b.p_pos[:n], np.int32)
            arr["p_refpos"][i, :n] = np.asarray(b.p_refpos[:n], np.int32)
            arr["p_valid"][i, :n] = True
            for k in range(n):
                q = b.p_qual[k]
                arr["p_qerr"][i, k, : min(len(q), L)] = q[:L]
    out = {k: torch.as_tensor(v, device=device) for k, v in arr.items()}
    sl_, sr_, bm_, cm_ = partial_stack_full(
        out["pr"], out["p_clip"], out["p_match"], out["p_len"],
        out["p_valid"], cfg.L)
    out["stackL"], out["stackR"] = sl_, sr_
    out["stack_base_max"], out["stack_clip_max"] = bm_, cm_
    return out


def _probe_lengths(orig: int) -> list[int]:
    """checkGapReads probe grid (Figbird.cpp:6121-6153)."""
    if orig < 30:
        step = 10 if orig < 15 else 20
        return list(range(0, 80, step))
    return [orig // 2, orig, 2 * orig, 3 * orig]


# ---------------------------------------------------------------- main entry

def fill_gaps(genome, gaps, bundles, model, partial_mode: bool,
              partial_len: int, neg_overlap: int = 30,
              read_len: int | None = None,
              instance_batch: int | None = None,
              max_scan_lengths: int | None = None, scan_block: int = 64,
              reference_exact: bool = False,
              exact_soft: bool | str | None = None,
              soft_levels: int | None = None, device=None,
              mesh=None) -> FillResult:
    """Fill all gaps for one iteration on ``device``: partial mode
    (``partial_mode=True``) or unmapped mode.

    ``max_scan_lengths`` (default 96 in partial mode, uncapped in unmapped
    mode) caps the candidate-length scan by stride sampling.
    ``reference_exact=True`` turns off every cap that could diverge from the
    reference's exhaustive behaviour: the scan cap, the overlap-bonus pair
    cap (``bonus_cap`` = the partial read bucket) and the staged unmapped
    scan, and runs the unmapped EM to the reference's 200 iterations.

    ``exact_soft``: ``None``/``True`` (production default) = the full
    6-level double-range cascade on every dispatch, which reproduces the
    reference's C-double soft accumulation.  ``"hybrid"`` (experimental) =
    a ``soft_levels``-deep mini-cascade in the length-scan dispatches, the
    exact cascade in every output-producing dispatch (winner/orig/second
    re-runs, finalize); scan-precision knife-edges can flip a candidate
    length, so it is not precision-equal in general.  ``"auto"`` = the
    mini-cascade everywhere plus underflow detection, and exact re-runs of
    the flagged instances.  ``False`` = plain f32 only, no detection (a
    precision-attribution trial).  ``soft_levels`` defaults to 3 (1 with
    ``exact_soft=False``).  ``device=None`` is the card (an error where
    there is none); ``device="cpu"`` asks for the CPU.  ``mesh``: every
    dispatched chunk of instances splits over the mesh's reads shards, each
    part on its row's device (the gap arrays and the model put once on each
    device), the outputs concatenated in order; ``device`` is then the
    mesh's first device.
    """
    if exact_soft is None:
        exact_soft = True
    if exact_soft not in (True, False, "auto", "hybrid"):
        raise ValueError(f"exact_soft={exact_soft!r}: expected None, True, "
                         "False, 'auto' or 'hybrid'")
    prec_escalate = exact_soft == "auto"
    scan_fast = exact_soft == "hybrid"
    if soft_levels is None:
        soft_levels = 1 if exact_soft is False else 3
    if mesh is not None:
        if device is not None and canonical_device(device) != mesh.first:
            raise ValueError(f"device {device} is not the mesh's first "
                             f"device {mesh.first}")
        device = mesh.first
    device = entry_device(device)
    n_rd = mesh.shape["reads"] if mesh is not None else 1
    row_devs = [mesh.device(r, 0) for r in range(n_rd)] \
        if mesh is not None else [device]
    if max_scan_lengths is None:
        max_scan_lengths = 96 if partial_mode else 0
    em_iters_unmapped = EM_ITERS_UNMAPPED
    if reference_exact:
        max_scan_lengths = 0
        em_iters_unmapped = REF_EM_ITERS
    if instance_batch is None:
        # the reference's TPU batch on the card; small batches on the CPU
        instance_batch = 768 if device.type == "cuda" else 64
    n_gaps = len(gaps)
    out_strings: list = [None] * n_gaps
    gaptofill = np.zeros(n_gaps, np.int64)
    placements: list = [[] for _ in range(n_gaps)]
    second_best: list = [None] * n_gaps
    stats = {"skipped": 0, "neg_merged": 0, "filled": 0,
             "scan_instances": 0, "buckets": 0}

    _t0 = _time.time()
    plans = plan_gaps(genome, gaps, bundles, partial_mode, partial_len,
                      neg_overlap, max_scan_lengths)
    stats["t_plan"] = round(_time.time() - _t0, 3)
    mim = np.asarray([(p.perfect_flag, p.perfect_len) for p in plans],
                     np.int64).reshape(n_gaps, 2)

    active: list[int] = []
    for gi, plan in enumerate(plans):
        if plan.skip:
            out_strings[gi] = np.full(plan.gap.length, N, np.int8)
            stats["skipped"] += 1
        elif plan.neg_merge > 0:
            out_strings[gi] = np.zeros(0, np.int8)
            gaptofill[gi] = plan.neg_merge
            stats["neg_merged"] += 1
        else:
            active.append(gi)
    if not active:
        return FillResult(out_strings, gaptofill, stats, mim=mim)

    L = int(read_len or max(
        max((len(s) for p in (plans[i] for i in active)
             for s in (p.bundle.p_seq + p.bundle.u_seq)), default=100), 50))

    def bucket_key(gi):
        plan = plans[gi]
        need_g = max(max(plan.lengths, default=plan.gap.length),
                     plan.gap.length,
                     max(_probe_lengths(plan.gap.length))
                     if (not partial_mode and not plan.large_gap
                         and plan.gap.length <= GAPTHRESH) else 0)
        rb = 1 if partial_mode else _quant(max(plan.bundle.n_unmapped, 1),
                                           COUNT_BUCKETS)
        return (_quant(need_g, GAP_BUCKETS),
                _quant(max(plan.bundle.n_partial, 1), COUNT_BUCKETS), rb,
                plan.large_gap)

    buckets: dict[tuple, list[int]] = {}
    for gi in active:
        buckets.setdefault(bucket_key(gi), []).append(gi)
    stats["buckets"] = len(buckets)
    stats["bucket_shapes"] = {str(k): len(v) for k, v in buckets.items()}
    logger.info("fill buckets: %s", stats["bucket_shapes"])

    marr = {k: torch.as_tensor(v, device=device)
            for k, v in model_arrays(model, L).items()}
    marr_on = {d: {k: v.to(d) for k, v in marr.items()}
               for d in dict.fromkeys(row_devs)}
    for (gb, pb, rb, large), gids in sorted(buckets.items()):
        cfg = FillConfig(
            W=L + gb + L, Wp=L + gb, L=L, WL=L, max_gap_len=gb, R=rb, P=pb,
            partial_mode=partial_mode, unmapped_mode=not partial_mode,
            em_iters=3 if partial_mode else em_iters_unmapped,
            gap_prob_cutoff=float(model.gap_prob_cutoff),
            insert_tmin=int(model.insert_threshold_min),
            insert_tmax=int(model.insert_threshold_max),
            bonus_cap=pb if reference_exact else 24,
            exact_soft=exact_soft in (True, "hybrid"),
            detect_prec=prec_escalate, soft_levels=soft_levels)
        # memory-capped instance batch (the reference's ~1.5 GB cap)
        per_inst = max(pb, rb) * (5 * cfg.L + (1 + _CASCADE_GROUP)
                                  * cfg.Wp) * 8
        ib = max(4, min(instance_batch, int(1.5e9) // max(per_inst, 1)))
        ib = -(-ib // n_rd) * n_rd  # the instance axis divides over reads
        _fill_bucket(genome, plans, gids, cfg, marr_on, ib, scan_block,
                     out_strings, placements, stats, second_best, row_devs,
                     large, staged_scan=not reference_exact,
                     prec_escalate=prec_escalate, scan_fast=scan_fast)
    logger.info("fill timers: %s scan_instances=%d",
                {k: v for k, v in stats.items() if k.startswith("t_")},
                stats.get("scan_instances", 0))
    return FillResult(out_strings, gaptofill, stats, placements, second_best,
                      mim=mim)


def _chunk_sizes(m: int, batch: int) -> list[int]:
    """Full ``batch`` chunks plus one tail rounded up a fixed ladder."""
    ladder = [s for s in (64, 128, 256) if s < batch]
    out = []
    while m > 0:
        if m >= batch:
            out.append(batch)
            m -= batch
        else:
            out.append(next((s for s in ladder if m <= s), batch))
            m = 0
    return out


def _fill_bucket(genome, plans, gids, cfg, marr_on, instance_batch,
                 scan_block, out_strings, placements, stats, second_best,
                 row_devs, large_flag=False, staged_scan=True,
                 prec_escalate=False, scan_fast=False):
    """Probe (unmapped small gaps), length scan, winner re-run, finalize and
    guards for one bucket.

    ``staged_scan``: unmapped instances run an 8-iteration EM first; lanes
    that bail re-run from scratch at the full cap, and lanes still bailed at
    the reference's 200 (identical trajectories, so a converged lane's
    outputs equal a single full-cap pass).  ``prec_escalate``: lanes whose
    fast soft-count pass flagged underflow risk (the packed ``prec`` column)
    re-run with the exact cascade.  ``scan_fast``: the length scan runs
    ``cfg.soft_levels`` cascade levels; re-runs and finalize run ``cfg``.
    ``large_flag``: the bucket's gaps take the large-gap EM (finalize extras
    and the region break in every pass).  ``row_devs``: the device of each
    reads shard (one without a mesh); ``marr_on``: the model's arrays on
    each of them."""
    partial_mode = cfg.partial_mode
    _t0 = _time.time()
    gap_arrays = _build_gap_arrays(genome, [plans[g] for g in gids], cfg,
                                   row_devs[0])
    ga_on = {d: gap_arrays if d == row_devs[0]
             else {k: v.to(d) for k, v in gap_arrays.items()}
             for d in dict.fromkeys(row_devs)}
    shards = [(d, ga_on[d], marr_on[d]) for d in row_devs]
    stats["t_build"] = stats.get("t_build", 0) + round(_time.time() - _t0, 3)
    row_of = {gi: r for r, gi in enumerate(gids)}
    staged = not partial_mode and staged_scan and cfg.em_iters > STAGE_ITERS

    # precision tiers: "full" scans (the mini-cascade under scan_fast),
    # "x..." re-runs and finalizes at cfg — the scan only selects lengths
    # and replay scalars, the re-run produces every output string —
    # "exact..." is the escalation target of prec-flagged lanes; "fast" and
    # "xfast" are the staged scan's first stage, a "200" suffix its last
    scan_base = replace(cfg, exact_soft=False, detect_prec=False) \
        if scan_fast else cfg
    tiers = {"full": scan_base, "xfull": cfg}
    if staged:
        tiers["fast"] = replace(scan_base, em_iters=STAGE_ITERS)
        tiers["xfast"] = replace(cfg, em_iters=STAGE_ITERS)
    tier0, rtier0 = ("fast", "xfast") if staged else ("full", "xfull")

    def cfg_tier(tier: str) -> FillConfig:
        if tier not in tiers:
            if tier.startswith("exact"):
                base = replace(cfg, exact_soft=True, detect_prec=False)
            else:
                base = cfg if tier.startswith("x") else scan_base
            tiers[tier] = replace(base, em_iters=REF_EM_ITERS
                                  if tier.endswith("200") else cfg.em_iters)
        return tiers[tier]

    # width classes: an instance of length glen <= w runs bit-identically
    # in a config resized to max_gap_len = w (every legal placement lies in
    # [WL-L, WL+glen+L)), so each dispatch runs at its tightest class
    w_classes = sorted({w for w in GAP_BUCKETS if w < cfg.max_gap_len}
                       | {cfg.max_gap_len})
    cfgs: dict[tuple, FillConfig] = {}

    def cfg_for(tier: str, width: int) -> FillConfig:
        if (tier, width) not in cfgs:
            base = cfg_tier(tier)
            cfgs[tier, width] = base if width == cfg.max_gap_len else replace(
                base, max_gap_len=width, W=cfg.L + width + cfg.L,
                Wp=cfg.L + width)
        return cfgs[tier, width]

    def wclass(ln: int) -> int:
        return next((w for w in w_classes if ln <= w), cfg.max_gap_len)

    nb = instance_batch
    run_scan = partial(fill_batch_scan, finalize_flag=large_flag)
    # checkGapReads probes run with the finalize extras on but no large-gap
    # break (run(i,fp,g,1,1), Figbird.cpp:6097)
    run_probe = partial(fill_batch_scan, finalize_flag=True,
                        large_break=False)
    run_full = partial(fill_batch_full_packed, finalize_flag=large_flag)

    def idx_arrays(rows, lens, size):
        pad = size - len(rows)
        return (np.asarray(list(rows) + [0] * pad, np.int32),
                np.asarray(list(lens) + [1] * pad, np.int32))

    def fetch(parts) -> np.ndarray:
        """A chunk's outputs, its parts over the reads shards in order."""
        return np.concatenate([d.cpu().numpy() for _, d in parts])

    def dispatch_rows(fn, rows, lens, tier, batch, width=None):
        """Run (row, len) instances at a tier; the packed host matrix in
        input order.  ``width=None`` groups them by their tightest width
        class (scan programs: identical results at any width >= the
        candidate length); else all run at ``width``."""
        n = len(rows)
        if width is None and len(w_classes) > 1:
            cls = np.asarray([wclass(l) for l in lens])
            groups = [(w, np.flatnonzero(cls == w)) for w in w_classes
                      if int(np.sum(cls == w))]
        else:
            groups = [(width or cfg.max_gap_len, np.arange(n))]
        parts = []
        for w, idx in groups:
            c0 = 0
            for sz in _chunk_sizes(len(idx), batch):
                sel = idx[c0 : c0 + sz]
                c0 += sz
                gi_, gl_ = idx_arrays([rows[i] for i in sel],
                                      [lens[i] for i in sel], sz)
                parts.append((sel, sharded_fill(shards, fn, cfg_for(tier, w),
                                                gi_, gl_)))
        out = None
        for sel, dev_out in parts:
            h = fetch(dev_out)
            if out is None:
                out = np.zeros((n, h.shape[1]), h.dtype)
            out[sel] = h[: len(sel)]
        return out

    def escalate(fn, rows, lens, host, bail_col, prec_col, batch, label,
                 xtier=False, width=None):
        """The escalation chain, in place on ``host``: bailed lanes ->
        full cap -> 200; prec-flagged lanes -> exact (-> exact 200).
        ``xtier``: the re-run tier family."""
        pre = "x" if xtier else ""

        def rerun(sel, tier, counter):
            if not sel.size:
                return
            _te = _time.time()
            host[sel] = dispatch_rows(fn, [rows[i] for i in sel],
                                      [lens[i] for i in sel], tier, batch,
                                      width)
            stats[counter] = stats.get(counter, 0) + int(sel.size)
            stats["t_scan_esc"] = stats.get("t_scan_esc", 0) + round(
                _time.time() - _te, 3)

        if staged:
            rerun(np.flatnonzero(host[:, bail_col] != 0), pre + "full",
                  f"esc_full_{label}")
            rerun(np.flatnonzero(host[:, bail_col] != 0), pre + "full200",
                  f"esc_200_{label}")
        if prec_escalate:
            rerun(np.flatnonzero(host[:, prec_col] != 0), "exact",
                  f"esc_exact_{label}")
            if not partial_mode:
                rerun(np.flatnonzero(host[:, bail_col] != 0), "exact200",
                      f"esc_exact200_{label}")
        left = int(np.sum(host[:, bail_col] != 0))
        if left and (staged or prec_escalate):
            logger.warning("%s: %d lanes still unconverged at the reference "
                           "200-iteration cap (accepted, as num_itr=200)",
                           label, left)

    def scan_wave(rows, lens, probe=False):
        fn = run_probe if probe else run_scan
        host = dispatch_rows(fn, rows, lens, tier0, nb)
        stats["scan_instances"] += len(rows)
        escalate(fn, rows, lens, host, SCAN_COLS - 2, SCAN_COLS - 1, nb,
                 "probe" if probe else "scan")
        return host

    _ts = _time.time()
    # ---- read-count probe for small unmapped gaps (checkGapReads) --------
    if not partial_mode:
        probe_rows, probe_lens, probe_owner = [], [], []
        for gi in gids:
            plan = plans[gi]
            if plan.large_gap or plan.gap.length > GAPTHRESH \
                    or plan.side_flag:
                continue
            pls = _probe_lengths(plan.gap.length)
            probe_rows += [row_of[gi]] * len(pls)
            probe_lens += pls
            probe_owner += [gi] * len(pls)
        if probe_rows:
            hostp = scan_wave(probe_rows, probe_lens, probe=True)
            probe_acc: dict[int, list] = {}
            for t, gi in enumerate(probe_owner):
                probe_acc.setdefault(gi, []).append(int(hostp[t, 1]))
            for gi, counts in probe_acc.items():
                strict_gt = plans[gi].gap.length < 30
                if not any((c > 3) if strict_gt else (c >= 3)
                           for c in counts):
                    # less_read_flag: finalize at the original length with
                    # zero saved flags (no reads accepted)
                    plans[gi].lengths = [plans[gi].gap.length]
                    plans[gi].less_read = True

    # ---- block-lazy length scan (packed scalars only) --------------------
    acc = {gi: [] for gi in gids}
    evl = {gi: [] for gi in gids}
    nxt = {gi: 0 for gi in gids}
    replayed = {}

    def replay(gi):
        a = np.asarray(acc[gi])
        extras = None if partial_mode else {
            "edge": (a[:, 3] != 0) | (a[:, 4] != 0) | (a[:, 5] != 0),
            "discont": a[:, 2] != 0}
        return _replay_scan(plans[gi].lengths[: len(a)], a[:, 0],
                            a[:, 1].astype(np.int64), plans[gi].gap.length,
                            partial_mode, extras)

    while True:
        rows, lens, owners = [], [], []
        for gi in gids:
            if gi in replayed:
                continue
            block = plans[gi].lengths[nxt[gi] : nxt[gi] + scan_block]
            rows += [row_of[gi]] * len(block)
            lens += block
            owners += [gi] * len(block)
            nxt[gi] += len(block)
        if not rows:
            break
        host = scan_wave(rows, lens)
        for t, gi in enumerate(owners):
            acc[gi].append(host[t])
            evl[gi].append(lens[t])
        for gi in dict.fromkeys(owners):
            res = replay(gi)
            if res[3] or nxt[gi] >= len(plans[gi].lengths):
                replayed[gi] = res

    # the original length is needed whenever a guard falls back to it
    orig_eval_j = {}
    extra = []
    for gi in gids:
        oj = plans[gi].lengths.index(plans[gi].gap.length)
        if oj < len(acc[gi]):
            orig_eval_j[gi] = oj
        else:
            extra.append(gi)
    if extra:
        lens = [plans[gi].gap.length for gi in extra]
        host = scan_wave([row_of[gi] for gi in extra], lens)
        for t, gi in enumerate(extra):
            acc[gi].append(host[t])
            evl[gi].append(lens[t])
            orig_eval_j[gi] = len(acc[gi]) - 1
    stats["t_scan"] = stats.get("t_scan", 0) + round(_time.time() - _ts, 3)

    # ---- per-gap decision ------------------------------------------------
    chosen = {}
    for gi in gids:
        valid = np.asarray(acc[gi])[:, 1].astype(np.int64)
        best_j, _, varied, _, second_j = replayed[gi]
        if partial_mode:
            if valid[best_j] == 0:
                best_j = orig_eval_j[gi]
        elif not varied and not plans[gi].side_flag:
            best_j = orig_eval_j[gi]  # check_change == 0 -> original (6533)
        chosen[gi] = (best_j, orig_eval_j[gi], second_j)

    # ---- winner + original (+ second) re-run, width-classed per gap ------
    _tr = _time.time()
    cls_of, rr_need = {}, {}
    for gi in gids:
        best_j, orig_j, second_j = chosen[gi]
        need = {("best", evl[gi][best_j]), ("orig", evl[gi][orig_j])}
        if 0 <= second_j < len(evl[gi]):
            need.add(("second", evl[gi][second_j]))
        rr_need[gi] = sorted(need)
        cls_of[gi] = wclass(max(ln for _, ln in need))
    rr = {}
    for wcls in w_classes:
        gsub = [gi for gi in gids if cls_of[gi] == wcls]
        if not gsub:
            continue
        rr_rows, rr_lens, rr_key = [], [], []
        for gi in gsub:
            for tag, ln in rr_need[gi]:
                rr_rows.append(row_of[gi])
                rr_lens.append(ln)
                rr_key.append((gi, tag, ln))
        lay = full_packed_layout(cfg_for("xfull", wcls))
        nbr = min(nb, 256)  # 2-3 instances per gap: a small fixed batch
        rr_host = dispatch_rows(run_full, rr_rows, rr_lens, rtier0, nbr,
                                wcls)
        escalate(run_full, rr_rows, rr_lens, rr_host, lay["bailed"][0],
                 lay["prec"][0], nbr, "rerun", xtier=True, width=wcls)
        pad_c = cfg.max_gap_len - wcls
        for t, (gi, tag, ln) in enumerate(rr_key):
            row = rr_host[t]

            def col(name):
                s, e = lay[name]
                return row[s:e]

            cons = col("consensus").astype(np.int8)
            if pad_c:
                cons = np.concatenate([cons, np.full(pad_c, 4, np.int8)])
            rr[(gi, tag)] = dict(
                consensus=cons, accept=col("accept") > 0.5,
                pos=col("pos").astype(np.int32),
                saved_l=int(col("saved_l")[0]),
                saved_r=int(col("saved_r")[0]),
                region_perct=float(col("region_perct")[0]), length=ln)
    for gi in gids:
        if (gi, "second") in rr:
            sb = rr[(gi, "second")]
            second_best[gi] = (sb["length"], sb["consensus"].copy())
    stats["t_rerun"] = stats.get("t_rerun", 0) + round(_time.time() - _tr, 3)

    # ---- finalize (packed), width-classed like the re-runs ---------------
    _tf = _time.time()
    fin_parsed = {}
    nr = cfg.P if partial_mode else cfg.R
    for wcls in w_classes:
        gsub = [gi for gi in gids if cls_of[gi] == wcls]
        if not gsub:
            continue
        cfg_f = cfg_for("xfull", wcls)
        flay = finalize_packed_layout(cfg_f)
        fin_lens = [rr[(gi, "best")]["length"] for gi in gsub]

        def saved(gi):
            b = rr[(gi, "best")]
            if not partial_mode and (plans[gi].less_read
                                     or plans[gi].side_flag):
                # saved_reads never set (Figbird.cpp:1709 vs 6369): no
                # accepts
                return np.zeros(nr, np.int8)
            return b["accept"].astype(np.int8)

        fin_host, c0 = [], 0
        for nbf in _chunk_sizes(len(gsub), nb):
            sub = gsub[c0 : c0 + nbf]
            gi_, gl_ = idx_arrays([row_of[gi] for gi in sub],
                                  fin_lens[c0 : c0 + nbf], nbf)
            c0 += nbf
            pad = nbf - len(sub)
            best = np.stack([rr[(gi, "best")]["consensus"][:wcls]
                             for gi in sub]
                            + [np.full(wcls, 4, np.int8)] * pad)
            sv = np.stack([saved(gi) for gi in sub]
                          + [np.zeros(nr, np.int8)] * pad)
            svl = np.asarray([rr[(gi, "best")]["saved_l"] for gi in sub]
                             + [-1] * pad, np.int32)
            svr = np.asarray([rr[(gi, "best")]["saved_r"] for gi in sub]
                             + [-1] * pad, np.int32)
            fin_host.append(fetch(sharded_fill(
                shards, finalize_batch_packed, cfg_f, gi_, gl_, best, sv,
                svl, svr)))
        fin_host = np.concatenate(fin_host)[: len(gsub)]
        gpad = cfg.max_gap_len - wcls
        for t, gi in enumerate(gsub):
            row = fin_host[t]

            def fcol(name):
                s, e = flay[name]
                return row[s:e]

            def zone(name):
                z = fcol(name).reshape(wcls, 5).copy()
                return np.concatenate([z, np.zeros((gpad, 5), z.dtype)]) \
                    if gpad else z

            fin = dict(counts=zone("counts"), accept=fcol("accept") > 0.5,
                       pos=fcol("pos").astype(np.int32),
                       used=int(fcol("used")[0]))
            if partial_mode:
                fin["qual"] = zone("qual")
            else:
                fin["left_right_check"] = fcol("left_right_check") > 0.5
                fin["umax_left"] = int(fcol("umax_left")[0])
                fin["umax_right"] = int(fcol("umax_right")[0])
                fin["left_start_zero"] = bool(fcol("left_start_zero")[0])
                fin["right_fin_glen"] = bool(fcol("right_fin_glen")[0])
            fin_parsed[gi] = (fin, fin_lens[t])
    stats["t_finalize"] = stats.get("t_finalize", 0) + round(
        _time.time() - _tf, 3)

    # ---- host guard battery ---------------------------------------------
    _tg = _time.time()
    for gi in gids:
        plan = plans[gi]
        fin, best_len = fin_parsed[gi]
        o = rr[(gi, "orig")]
        if partial_mode:
            out_strings[gi] = _finish_partial(plan, best_len, cfg, fin,
                                              o["accept"], o["pos"])
        else:
            out_strings[gi] = _finish_unmapped(
                plan, best_len, cfg, fin, o["accept"], o["pos"],
                rr[(gi, "best")]["region_perct"])
        stats["filled"] += 1
        seqs = plan.bundle.p_seq if partial_mode else plan.bundle.u_seq
        placements[gi] = [(int(k), int(fin["pos"][k]), seqs[k])
                          for k in range(len(seqs)) if fin["accept"][k]]
    stats["t_guard"] = stats.get("t_guard", 0) + round(_time.time() - _tg, 3)


def _finish_unmapped(plan, best_len, cfg, fin, orig_accept, orig_pos,
                     region_perct):
    """finalize guard battery, unmapped (5415-5507 + 5619-5641)."""
    g = plan.gap
    counts = fin["counts"].copy()
    accept = fin["accept"]
    pos = fin["pos"]
    lens = np.array([len(s) for s in plan.bundle.u_seq]
                    + [0] * (accept.shape[0] - plan.bundle.n_unmapped))
    used = int(fin["used"])
    lr = fin["left_right_check"]
    umax_l, umax_r = int(fin["umax_left"]), int(fin["umax_right"])
    lsz, rfg = bool(fin["left_start_zero"]), bool(fin["right_fin_glen"])
    thresh = 4
    nflag = [False, False]
    lflag = [False, False]
    gap_len = best_len

    if ((0 < umax_l < 2 * thresh) or (0 < umax_r < 2 * thresh)) and \
            region_perct > 0.75:
        used = 0
    if (0 < umax_l < thresh) or (0 < umax_r < thresh):
        cons = _host_consensus(counts, gap_len)
        if len(_find_region(cons)) >= 1:
            if 0 < umax_l < thresh:
                lflag[0] = True
            if 0 < umax_r < thresh:
                lflag[1] = True
        else:
            used = 0
            umax_l = umax_r = -1
    if not lr[0] and not lr[1] and used != 0:
        used = 0
        umax_l = umax_r = -1
    if (not lr[0] and lsz) or (not lr[1] and rfg):
        cons = _host_consensus(counts, gap_len)
        if len(_find_region(cons)) >= 1:
            nflag[0] = not lr[0]
            nflag[1] = not lr[1]

    recompute = False
    if used == 0 or not (lr[0] and lr[1]):
        gap_len = g.length
        counts = np.zeros((cfg.max_gap_len, 5), np.float32)
        # recompute2 from original-length placements (5495-5506)
        if ((not lr[0] and lr[1] and umax_r >= thresh)
                or (lr[0] and not lr[1] and umax_l >= thresh)):
            recompute = True
            for k in range(plan.bundle.n_unmapped):
                if orig_accept[k]:
                    p = int(orig_pos[k])
                    s = plan.bundle.u_seq[k]
                    for j in range(len(s)):
                        if 0 <= p + j < gap_len and s[j] < 4:
                            counts[p + j, s[j]] += 1

    cons = _host_consensus(counts, gap_len)
    if lr[0] or lr[1] or used != 0:
        if nflag[0] or lflag[0]:
            cons[0] = N
        if (nflag[1] or lflag[1]) and gap_len > 0:
            cons[gap_len - 1] = N
        src_accept = orig_accept if recompute else accept
        src_pos = orig_pos if recompute else pos
        clear = _recheck_sequence(cons, src_pos[: len(lens)], lens,
                                  src_accept[: len(lens)], g.length,
                                  region_perct)
        if clear:
            return np.full(g.length, N, np.int8)
    return cons[:gap_len]


def _finish_partial(plan, best_len, cfg, fin, orig_accept, orig_pos):
    """finalize guard battery, partial (5512-5609)."""
    g = plan.gap
    counts = fin["counts"].copy()
    qual = fin["qual"]
    gap_len = best_len

    ret0, ret1 = _detect_overlap_host(plan, fin["accept"], fin["pos"],
                                      gap_len)
    dg = g.length - gap_len
    if dg > 0:
        case = 1 if ret0 > 0 else 2
    elif dg < 0:
        case = 3 if ret0 > 0 else 4
    else:
        case = 5

    u_flag = 1
    if fin["used"] < PARTIAL_THRESHOLD or case in (2, 4):
        gap_len = g.length
        counts = np.zeros((cfg.max_gap_len, 5), np.float32)
        if fin["used"] < PARTIAL_THRESHOLD or case == 4:
            u_flag = 0
        else:  # case 2: recompute from original-length placements
            for k in range(plan.bundle.n_partial):
                if orig_accept[k]:
                    p = int(orig_pos[k])
                    s = plan.bundle.p_seq[k]
                    for j in range(len(s)):
                        if 0 <= p + j < gap_len and s[j] < 4:
                            counts[p + j, s[j]] += 1
            ret0, ret1 = _detect_overlap_host(plan, orig_accept, orig_pos,
                                              gap_len)
            if ret1 == -1:
                counts[:] = 0
                u_flag = 0

    if u_flag == 1 and ret0 == 0 and ret1 == 0:
        # ambiguous-column resolution (5585-5609)
        for j in range(gap_len):
            row = counts[j]
            if (row[:4] > 0).any():
                uf = _check_update(row, qual[j])
                if uf != -1:
                    if uf != 50:
                        counts[j, uf] += 10
                else:
                    counts[j, :4] = 0
    return _host_consensus(counts, gap_len)[:gap_len]
