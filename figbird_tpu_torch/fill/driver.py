"""Host orchestration of the partial-mode gap-fill EM
(``figbird_tpu/fill/driver.py``).

1. host pre-analysis per gap (flanks, repeats, negative-gap merge, findFrac
   length ranges) — the numpy helpers are copied from the reference, whose
   module imports JAX;
2. a batched device scan over candidate gap lengths whose sequential
   early-exit heuristics are replayed on the host (fillGap 6298-6482);
3. the winner re-run, a finalize pass against the best string, and the host
   guard battery.

The soft counts run at the production default (the exact 6-level cascade,
kernel K1) or at one of the precision tiers of ``fill_gaps``.  Unmapped mode
is a later slice of the port and raises ``NotImplementedError``.
"""

from __future__ import annotations

import logging
import time as _time
from dataclasses import dataclass, field, replace

import numpy as np
import torch

from ..dtypes import GAP_CODE, N
from ..genome import GapInfo
from ..ops import entry_device
from .em import (_CASCADE_GROUP, _NEXT_SLICE, SCAN_COLS, FillConfig,
                 fill_batch_full_packed, fill_batch_scan,
                 finalize_batch_packed, finalize_packed_layout,
                 full_packed_layout, partial_stack_full)

logger = logging.getLogger("figbird_tpu_torch.fill")

SIDE_LIMIT = 30
PARTIAL_SAME = 4         # fillGap 6258
PARTIAL_THRESHOLD = 2    # setParameters
GAP_BUCKETS = (128, 512, 1024, 2048, 4096, 8192)
COUNT_BUCKETS = (128, 1024, 3072)


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


def _find_frac(orig: int, partial_len: int) -> tuple[float, float]:
    """findFrac (6879-6906), partial mode: length-range fractions."""
    factor = 3 * partial_len
    mid_limitp = 2 * partial_len
    if orig <= mid_limitp // 2:
        return 1e-5, factor / max(orig, 1)
    if orig <= mid_limitp:
        return 1e-5, 5.0
    return 1.0, 1.0


def plan_gaps(genome, gaps, bundles, partial_len: int, neg_overlap: int,
              max_scan_lengths: int = 96) -> list[GapPlan]:
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
        if two or (one and g.length > 6 * partial_len):
            plan.skip = True
            plans.append(plan)
            continue
        if sl > 0 and not one:
            plan.neg_merge = _neg_gap_merge(plan, neg_overlap)
            if plan.neg_merge > 0:
                plans.append(plan)
                continue
        if b.n_partial:
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
        f1, f2 = _find_frac(g.length, partial_len)
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


def _replay_scan(lengths, lik, valid):
    """Replay fillGap's sequential plateau/early-exit logic, partial mode.
    Returns (best_index, evaluated_count, used_read_varied, exited,
    second_best_index)."""
    best_i, second, second_i = 0, -np.inf, -1
    best_lik = -np.inf
    same = 0
    prev_lik = 0.0
    n_eval = 0
    exited = False
    for j, (le, lk, vc) in enumerate(zip(lengths, lik, valid)):
        n_eval = j + 1
        if lk > best_lik:
            second = best_lik
            second_i = best_i if np.isfinite(best_lik) else -1
            best_lik = lk
            best_i = j
        elif lk > second:
            second = lk
            second_i = j
        same = same + 1 if abs(prev_lik - lk) <= 0.9 else 0
        prev_lik = lk
        if same == PARTIAL_SAME:
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


# ---------------------------------------------------------------- main entry

def fill_gaps(genome, gaps, bundles, model, partial_mode: bool,
              partial_len: int, neg_overlap: int = 30,
              read_len: int | None = None, instance_batch: int | None = None,
              max_scan_lengths: int | None = None, scan_block: int = 64,
              exact_soft: bool | str | None = None,
              soft_levels: int | None = None, device=None) -> FillResult:
    """Fill all gaps for one partial-mode iteration on ``device``.

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
    ``exact_soft=False``).  Unmapped mode raises ``NotImplementedError``.
    ``device=None`` is the card (an error where there is none);
    ``device="cpu"`` asks for the CPU.
    """
    if not partial_mode:
        raise NotImplementedError(_NEXT_SLICE)
    if exact_soft is None:
        exact_soft = True
    if exact_soft not in (True, False, "auto", "hybrid"):
        raise ValueError(f"exact_soft={exact_soft!r}: expected None, True, "
                         "False, 'auto' or 'hybrid'")
    prec_escalate = exact_soft == "auto"
    scan_fast = exact_soft == "hybrid"
    if soft_levels is None:
        soft_levels = 1 if exact_soft is False else 3
    device = entry_device(device)
    if max_scan_lengths is None:
        max_scan_lengths = 96
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
    plans = plan_gaps(genome, gaps, bundles, partial_len, neg_overlap,
                      max_scan_lengths)
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

    buckets: dict[tuple, list[int]] = {}
    for gi in active:
        plan = plans[gi]
        need_g = max(max(plan.lengths, default=plan.gap.length),
                     plan.gap.length)
        key = (_quant(need_g, GAP_BUCKETS),
               _quant(max(plan.bundle.n_partial, 1), COUNT_BUCKETS))
        buckets.setdefault(key, []).append(gi)
    stats["buckets"] = len(buckets)
    stats["bucket_shapes"] = {str((gb, pb, 1, False)): len(v)
                              for (gb, pb), v in buckets.items()}
    logger.info("fill buckets: %s", stats["bucket_shapes"])

    marr = {k: torch.as_tensor(v, device=device)
            for k, v in model_arrays(model, L).items()}
    for (gb, pb), gids in sorted(buckets.items()):
        cfg = FillConfig(
            W=L + gb + L, Wp=L + gb, L=L, WL=L, max_gap_len=gb, R=1, P=pb,
            partial_mode=True, unmapped_mode=False, em_iters=3,
            gap_prob_cutoff=float(model.gap_prob_cutoff),
            insert_tmin=int(model.insert_threshold_min),
            insert_tmax=int(model.insert_threshold_max),
            bonus_cap=24, exact_soft=exact_soft in (True, "hybrid"),
            detect_prec=prec_escalate, soft_levels=soft_levels)
        # memory-capped instance batch (the reference's ~1.5 GB cap)
        per_inst = pb * (5 * cfg.L + (1 + _CASCADE_GROUP) * cfg.Wp) * 8
        ib = max(4, min(instance_batch, int(1.5e9) // max(per_inst, 1)))
        _fill_bucket(genome, plans, gids, cfg, marr, ib, scan_block,
                     out_strings, placements, stats, second_best, device,
                     prec_escalate, scan_fast)
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


def _fill_bucket(genome, plans, gids, cfg, marr, instance_batch, scan_block,
                 out_strings, placements, stats, second_best, device,
                 prec_escalate=False, scan_fast=False):
    """Length scan + winner re-run + finalize + guards for one bucket.

    ``prec_escalate``: lanes whose fast soft-count pass flagged underflow
    risk (the packed ``prec`` column) re-run with the exact cascade.
    ``scan_fast``: the length scan runs ``cfg.soft_levels`` cascade levels;
    re-runs and finalize run ``cfg`` (exact)."""
    _t0 = _time.time()
    gap_arrays = _build_gap_arrays(genome, [plans[g] for g in gids], cfg,
                                   device)
    stats["t_build"] = stats.get("t_build", 0) + round(_time.time() - _t0, 3)
    row_of = {gi: r for r, gi in enumerate(gids)}

    # width classes: an instance of length glen <= w runs bit-identically
    # in a config resized to max_gap_len = w (every legal placement lies in
    # [WL-L, WL+glen+L)), so each dispatch runs at its tightest class
    w_classes = sorted({w for w in GAP_BUCKETS if w < cfg.max_gap_len}
                       | {cfg.max_gap_len})
    # precision tiers: "full" scans (the mini-cascade under scan_fast),
    # "xfull" re-runs and finalizes at cfg — the scan only selects lengths
    # and replay scalars, the re-run produces every output string — and
    # "exact" is the escalation target of prec-flagged lanes
    tiers = {
        "full": replace(cfg, exact_soft=False, detect_prec=False)
        if scan_fast else cfg,
        "xfull": cfg,
        "exact": replace(cfg, exact_soft=True, detect_prec=False)}
    cfgs: dict[tuple, FillConfig] = {}

    def cfg_for(tier: str, width: int) -> FillConfig:
        if (tier, width) not in cfgs:
            base = tiers[tier]
            cfgs[tier, width] = base if width == cfg.max_gap_len else replace(
                base, max_gap_len=width, W=cfg.L + width + cfg.L,
                Wp=cfg.L + width)
        return cfgs[tier, width]

    def wclass(ln: int) -> int:
        return next((w for w in w_classes if ln <= w), cfg.max_gap_len)

    nb = instance_batch

    def idx_tensors(rows, lens, size):
        pad = size - len(rows)
        gi_ = torch.as_tensor(np.asarray(list(rows) + [0] * pad, np.int32),
                              device=device)
        gl_ = torch.as_tensor(np.asarray(list(lens) + [1] * pad, np.int32),
                              device=device)
        return gi_, gl_

    def dispatch_rows(fn, rows, lens, tier, batch, width=None):
        """Run (row, len) instances at a precision tier; the packed host
        matrix in input order.  ``width=None`` groups them by their tightest
        width class (scan programs: identical results at any width >= the
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
                gi_, gl_ = idx_tensors([rows[i] for i in sel],
                                       [lens[i] for i in sel], sz)
                parts.append((sel, fn(cfg_for(tier, w), gap_arrays, gi_,
                                      gl_, marr)))
        out = None
        for sel, dev_out in parts:
            h = dev_out.cpu().numpy()
            if out is None:
                out = np.zeros((n, h.shape[1]), h.dtype)
            out[sel] = h[: len(sel)]
        return out

    def escalate(fn, rows, lens, host, prec_col, batch, label, width=None):
        """Re-run the prec-flagged lanes of ``host`` with the exact
        cascade, in place."""
        if not prec_escalate:
            return
        sel = np.flatnonzero(host[:, prec_col] != 0)
        if not sel.size:
            return
        _te = _time.time()
        host[sel] = dispatch_rows(fn, [rows[i] for i in sel],
                                  [lens[i] for i in sel], "exact", batch,
                                  width)
        stats[f"esc_exact_{label}"] = stats.get(f"esc_exact_{label}", 0) \
            + int(sel.size)
        stats["t_scan_esc"] = stats.get("t_scan_esc", 0) + round(
            _time.time() - _te, 3)

    def scan_wave(rows, lens):
        host = dispatch_rows(fill_batch_scan, rows, lens, "full", nb)
        stats["scan_instances"] += len(rows)
        escalate(fill_batch_scan, rows, lens, host, SCAN_COLS - 1, nb,
                 "scan")
        return host

    # ---- block-lazy length scan (packed scalars only) --------------------
    acc = {gi: [] for gi in gids}
    evl = {gi: [] for gi in gids}
    nxt = {gi: 0 for gi in gids}
    replayed = {}
    _ts = _time.time()
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
            a = np.asarray(acc[gi])
            res = _replay_scan(plans[gi].lengths[: len(a)], a[:, 0],
                               a[:, 1].astype(np.int64))
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
        best_j, _, _, _, second_j = replayed[gi]
        if valid[best_j] == 0:
            best_j = orig_eval_j[gi]
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
        rr_host = dispatch_rows(fill_batch_full_packed, rr_rows, rr_lens,
                                "xfull", nbr, wcls)
        escalate(fill_batch_full_packed, rr_rows, rr_lens, rr_host,
                 lay["prec"][0], nbr, "rerun", wcls)
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
                saved_r=int(col("saved_r")[0]), length=ln)
    for gi in gids:
        if (gi, "second") in rr:
            sb = rr[(gi, "second")]
            second_best[gi] = (sb["length"], sb["consensus"].copy())
    stats["t_rerun"] = stats.get("t_rerun", 0) + round(_time.time() - _tr, 3)

    # ---- finalize (packed), width-classed like the re-runs ---------------
    _tf = _time.time()
    fin_parsed = {}
    for wcls in w_classes:
        gsub = [gi for gi in gids if cls_of[gi] == wcls]
        if not gsub:
            continue
        cfg_f = cfg_for("xfull", wcls)
        flay = finalize_packed_layout(cfg_f)
        fin_lens = [rr[(gi, "best")]["length"] for gi in gsub]
        fin_host, c0 = [], 0
        for nbf in _chunk_sizes(len(gsub), nb):
            sub = gsub[c0 : c0 + nbf]
            gi_, gl_ = idx_tensors([row_of[gi] for gi in sub],
                                   fin_lens[c0 : c0 + nbf], nbf)
            c0 += nbf
            pad = nbf - len(sub)
            best = np.stack([rr[(gi, "best")]["consensus"][:wcls]
                             for gi in sub]
                            + [np.full(wcls, 4, np.int8)] * pad)
            svl = np.asarray([rr[(gi, "best")]["saved_l"] for gi in sub]
                             + [-1] * pad, np.int32)
            svr = np.asarray([rr[(gi, "best")]["saved_r"] for gi in sub]
                             + [-1] * pad, np.int32)
            fin_host.append(finalize_batch_packed(
                cfg_f, gap_arrays, gi_, gl_, marr,
                torch.as_tensor(best, device=device),
                torch.as_tensor(svl, device=device),
                torch.as_tensor(svr, device=device)).cpu().numpy())
        fin_host = np.concatenate(fin_host)[: len(gsub)]
        gpad = cfg.max_gap_len - wcls
        for t, gi in enumerate(gsub):
            row = fin_host[t]

            def fcol(name):
                s, e = flay[name]
                return row[s:e]

            counts = fcol("counts").reshape(wcls, 5).copy()
            qual = fcol("qual").reshape(wcls, 5)
            if gpad:
                counts = np.concatenate([counts,
                                         np.zeros((gpad, 5), counts.dtype)])
                qual = np.concatenate([qual, np.zeros((gpad, 5), qual.dtype)])
            fin_parsed[gi] = (dict(counts=counts, qual=qual,
                                   accept=fcol("accept") > 0.5,
                                   pos=fcol("pos").astype(np.int32),
                                   used=int(fcol("used")[0])), fin_lens[t])
    stats["t_finalize"] = stats.get("t_finalize", 0) + round(
        _time.time() - _tf, 3)

    # ---- host guard battery ---------------------------------------------
    _tg = _time.time()
    for gi in gids:
        plan = plans[gi]
        fin, best_len = fin_parsed[gi]
        o = rr[(gi, "orig")]
        out_strings[gi] = _finish_partial(plan, best_len, cfg, fin,
                                          o["accept"], o["pos"])
        stats["filled"] += 1
        seqs = plan.bundle.p_seq
        placements[gi] = [(int(k), int(fin["pos"][k]), seqs[k])
                          for k in range(len(seqs)) if fin["accept"][k]]
    stats["t_guard"] = stats.get("t_guard", 0) + round(_time.time() - _tg, 3)


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
