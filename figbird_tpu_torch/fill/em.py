"""Batched GapFiller EM, partial mode (``figbird_tpu/fill/em.py``).

The reference ``vmap``s each per-instance function over a leading instance
axis; here that axis is written out: every tensor of an instance batch
carries a leading dimension I.  The banded partial placement runs on three
kernels (``ops.band``): the fused soft score (K2), the hard score against
the consensus (K3), the soft-count cascade (K1: the exact 6-level cascade
of the production default, or a ``soft_levels``-deep mini-cascade) and the
raw-weight count fold (K4: the plain-f32 soft accumulate of ``soft_levels ==
1`` and the finalize counts).  The unmapped mode raises
``NotImplementedError``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops.band import CASCADE_GROUP as _CASCADE_GROUP
from ..ops.band import (MASKED, band_score_hard, band_score_soft,
                        cascade_counts, fold_counts, level_weight)

LN10 = float(np.log(10.0))
NEG = -1e30
_BIG = 1 << 20

# Cascade constants (reference em.py:636-646).  Invariant: a row NOT selected
# at level k (total_k <= TAU = e^(CUT-SHIFT)) has every contribution below
# e^(CUT-SHIFT), so level k+1's overflow zeroing never drops a contribution
# of a level-(k+1)-selected row.  CUT=78 keeps level sums below f32 max; 6
# levels of 140 nats span past the 745-nat subnormal double underflow point.
_CASCADE_SHIFT = 140.0
_CASCADE_CUT = 78.0
_CASCADE_TAU = float(np.exp(_CASCADE_CUT - _CASCADE_SHIFT))  # e^-62
_CASCADE_LEVELS = 6
# weights below this natural-log value vanish at every cascade level
_MIN_LOGW_REP = -(5.0 * 140.0 + 103.0)

_NEXT_SLICE = ("not ported yet: the unmapped mode is a later slice of the "
               "port (ROADMAP.md, queue 1 item 8); the port runs partial-"
               "mode fills")


@dataclass(frozen=True)
class FillConfig:
    """Static shape/mode config for one bucket (same fields as the
    reference's ``FillConfig``)."""

    W: int          # full window length  (WL + max_gap_len + L)
    Wp: int         # candidate-position count (WL + max_gap_len)
    L: int          # bucket read length
    WL: int         # gap-zone start (== L)
    max_gap_len: int
    R: int          # padded unmapped read count
    P: int          # padded partial read count
    partial_mode: bool
    unmapped_mode: bool
    clip_thresh: int = 2
    em_iters: int = 3
    comp_stable: int = 5
    coverage_threshold1: int = 0
    coverage_threshold2: int = 1
    gap_prob_cutoff: float = 5.0
    insert_tmin: int = 0
    insert_tmax: int = 1 << 30
    bonus_cap: int = 24
    # double-range soft-count accumulation (see _accumulate_logw): the full
    # 6-level cascade when exact_soft, else the first soft_levels levels
    # (1 = plain f32); detect_prec flags instances the fast path may get
    # wrong, for fill_gaps' "auto" tier to re-run exactly
    exact_soft: bool = False
    detect_prec: bool = True
    soft_levels: int = 1


def _soft_m(cfg: FillConfig) -> int:
    return _CASCADE_LEVELS if cfg.exact_soft else max(1, cfg.soft_levels)


def check_supported(cfg: FillConfig) -> None:
    if not cfg.partial_mode or cfg.unmapped_mode:
        raise NotImplementedError(_NEXT_SLICE)


def _csum(x: torch.Tensor) -> torch.Tensor:
    """Near-double-precision sum over the last axis of an f32 tensor
    (TwoSum pairwise tree, op for op as the reference's ``_csum``)."""
    x = x.to(torch.float32)
    n = int(x.shape[-1])
    m = 1
    while m < max(n, 1):
        m *= 2
    if m != n:
        x = torch.cat([x, torch.zeros(x.shape[:-1] + (m - n,),
                                      dtype=x.dtype, device=x.device)], -1)
    err = torch.zeros_like(x)
    while m > 1:
        a, b = x[..., 0::2], x[..., 1::2]
        s = a + b
        bv = s - a
        t = (a - (s - bv)) + (b - bv)  # exact rounding error of a+b
        err = err[..., 0::2] + err[..., 1::2] + t
        x = s
        m //= 2
    return (x + err)[..., 0]


def _take(x: torch.Tensor, start: torch.Tensor, size: int) -> torch.Tensor:
    """x[i, start[i] : start[i] + size] along dim 1 for every instance i."""
    idx = start.long()[:, None] + torch.arange(size, device=x.device)
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


def shift_left(x: torch.Tensor, off: torch.Tensor, fill) -> torch.Tensor:
    """out[..., j] = x[..., j + off] (``fill`` beyond the last column)."""
    L = x.shape[-1]
    xp = torch.cat([x, torch.full(x.shape[:-1] + (L + 1,), fill,
                                  dtype=x.dtype, device=x.device)], -1)
    idx = off.long()[..., None] + torch.arange(L, device=x.device)
    return xp.gather(-1, idx)


def compute_probs_gap(counts: torch.Tensor) -> torch.Tensor:
    """computeProbsGap: counts (..., W, 5) -> probs (..., W, 5)."""
    total = counts.sum(dim=-1, keepdim=True)
    ncol = counts[..., 4:5]
    probs4 = torch.where(total > 0, (counts[..., :4] + ncol / 4) / total,
                         0.25)
    return torch.cat([probs4, torch.zeros_like(ncol)], dim=-1)


def compute_error_probs_gap(probs: torch.Tensor, et: torch.Tensor):
    """computeErrorProbsGap: B[w,j] = sum_{k<4,k!=j} A[w,k]*ET[k,j]."""
    b = probs[..., :4] @ et[:4, :]
    diag = torch.cat([torch.diagonal(et)[:4],
                      torch.zeros(1, dtype=et.dtype, device=et.device)])
    return b - probs * diag


def consensus_from_counts(counts, gap_zone, check: int, cov_thresh):
    """computeSequence restricted to the gap zone -> (codes int8, max)."""
    mx = counts.max(dim=-1).values
    arg = counts.argmax(dim=-1).to(torch.int8)
    cons = torch.where(mx > 0, arg, 4).to(torch.int8)
    if check:
        cons = torch.where(mx <= cov_thresh, 4, cons).to(torch.int8)
    return torch.where(gap_zone, cons, 4).to(torch.int8), mx


# ---------------------------------------------------------------------------
# partial-read stack initialisation
# ---------------------------------------------------------------------------

def partial_stack_full(pr, p_clip, p_match, p_len, p_valid, L: int):
    """Gap-length-independent half of the partial stack, per instance:
    (cntL (I,L,4), cntR_rev (I,L,4), base_max (I,), clip_max (I,))."""
    Lr = pr.shape[-1]
    t = torch.arange(L, device=pr.device)

    def _counts4(mask, ch):
        return torch.stack(
            [torch.where(mask & ((ch == c) | (ch == 4)), 1.0, 0.0).sum(dim=1)
             for c in range(4)], dim=-1)

    left = (p_match == 1) | (p_match == 4)
    base = p_len - p_clip - 1  # left reach (chars into the gap)
    ch_l = shift_left(pr, torch.clamp(p_clip + 1, 0, Lr), 4)[..., :L]
    m_l = (t < base[..., None]) & left[..., None] & p_valid[..., None]
    cntL = _counts4(m_l, ch_l)

    right = (p_match == 2) | (p_match == 3)
    ch_r = shift_left(pr.flip(-1), torch.clamp(Lr - p_clip, 0, Lr),
                      4)[..., :L]
    m_r = (t < p_clip[..., None]) & right[..., None] & p_valid[..., None]
    cntR_rev = _counts4(m_r, ch_r)

    base_max = torch.where(left & p_valid, base, -_BIG).max(dim=1).values
    clip_max = torch.where(right & p_valid, p_clip, -_BIG).max(dim=1).values
    return cntL, cntR_rev, base_max, clip_max


def partial_stack_from_full(cntL, cntR_rev, base_max, clip_max,
                            max_gap_len: int, gap_len):
    """Apply each instance's candidate gap length to the stack halves:
    (counts4 (I,maxG,4) with +1 pseudo-counts, left_max, right_min)."""
    I, L, _ = cntL.shape
    G1 = min(L, max_gap_len)
    t1 = torch.arange(G1, device=cntL.device)[None, :, None]
    gl = gap_len[:, None, None]

    def _padG(x):
        if G1 == max_gap_len:
            return x
        return torch.cat([x, torch.zeros((I, max_gap_len - G1, 4),
                                         dtype=x.dtype, device=x.device)], 1)

    cnt_l = _padG(torch.where(t1 < gl, cntL[:, :G1], 0.0))
    cnt_r_rev = _padG(torch.where(t1 < gl, cntR_rev[:, :G1], 0.0))
    rev = torch.cat([cnt_r_rev.flip(1), torch.zeros_like(cnt_r_rev)], 1)
    off = torch.clamp(max_gap_len - gap_len, 0, max_gap_len)
    cnt_r = _take(rev, off, max_gap_len)
    counts4 = 1.0 + cnt_l + cnt_r
    left_max = torch.where(base_max == -_BIG, -_BIG,
                           torch.minimum(base_max, gap_len) - 1)
    right_min = torch.where(clip_max == -_BIG, _BIG,
                            gap_len - torch.minimum(clip_max, gap_len))
    return counts4, left_max, right_min


def _stack_for(inst, cfg: FillConfig):
    if "stackL" in inst:
        halves = (inst["stackL"], inst["stackR"], inst["stack_base_max"],
                  inst["stack_clip_max"])
    else:
        halves = partial_stack_full(inst["pr"], inst["p_clip"],
                                    inst["p_match"], inst["p_len"],
                                    inst["p_valid"], cfg.L)
    return partial_stack_from_full(*halves, cfg.max_gap_len, inst["gap_len"])


# ---------------------------------------------------------------------------
# banded partial placement: every legal partial position lies within L of a
# gap edge, so the Wp-wide position axis collapses exactly to two band_w-wide
# bands — a static left band at the gap start and a per-instance right band
# at the candidate gap end (band-1 positions strictly precede band-2's).
# ---------------------------------------------------------------------------

def _band_w(cfg: FillConfig) -> int:
    return -(-cfg.L // 128) * 128


def _band_starts(cfg: FillConfig, gap_len):
    bw = _band_w(cfg)
    if cfg.W < bw + cfg.L:
        raise ValueError(f"banded partial path needs W >= band_w + L "
                         f"({cfg.W} < {bw + cfg.L})")
    p0r = cfg.WL + torch.clamp_min(gap_len - cfg.L + 1, 0)
    p0r = torch.clamp_max(p0r, cfg.W - (bw + cfg.L))
    return torch.zeros_like(p0r), p0r


def _legal_partial_band(cfg: FillConfig, inst, p0, own_left: bool):
    """Legality (I, P, band_w) over band positions [p0, p0+band_w)."""
    p = p0[:, None, None] + torch.arange(_band_w(cfg), device=p0.device)
    gs = inst["gap_start"][:, None, None]
    cpos = gs - cfg.WL + p
    plen = inst["p_len"][..., None]
    left = ((inst["p_match"] == 1) | (inst["p_match"] == 4))[..., None]
    ge = gs + inst["gap_len"][:, None, None]
    rng_left = (cpos >= gs - plen + 1) & (cpos < gs)
    rng_right = (cpos >= ge - plen + 1) & (cpos < ge)
    rng = torch.where(left, rng_left, rng_right)
    refp = inst["p_refpos"][..., None]
    refp_r = refp + (inst["gap_len"] - inst["orig_gap"])[:, None, None]
    t_ins = torch.where(left, cpos - refp + plen, refp_r - cpos + plen)
    ins_ok = (refp == -1) | ((t_ins >= cfg.insert_tmin)
                             & (t_ins <= cfg.insert_tmax))
    own = (p < cfg.WL) if own_left else (p >= cfg.WL)
    return rng & ins_ok & inst["p_valid"][..., None] & own


def _assemble_bands(fold1, fold2, p0r, cfg: FillConfig):
    """Add the two band folds (I, band_w+L, C) into (I, W, C)."""
    I, n, C = fold1.shape
    out = torch.zeros((I, cfg.W, C), dtype=fold1.dtype, device=fold1.device)
    out[:, :n] = fold1
    idx = p0r.long()[:, None] + torch.arange(n, device=p0r.device)
    ar = torch.arange(I, device=p0r.device)[:, None]
    out[ar, idx] = out[ar, idx] + fold2
    return out


def _level_weight(logw, legal, k: int):
    return level_weight(torch.where(legal, logw, MASKED), k, _CASCADE_SHIFT,
                        _CASCADE_CUT)


def _accumulate_levels(logw, legal, codes, cvals, W: int,
                       m: int = _CASCADE_LEVELS):
    """First ``m`` cascade levels' folded counts (I, m, W, 5), by K1."""
    return cascade_counts(torch.where(legal, logw, MASKED), codes, cvals, W,
                          m, _CASCADE_SHIFT, _CASCADE_CUT)


def _select_levels(counts_k):
    """Per output row: the SHALLOWEST level whose total exceeds TAU, else
    the deepest computed.  counts_k (I, m, W, 5) -> (I, W, 5)."""
    totals = counts_k.sum(dim=-1)                          # (I, m, W)
    chosen = counts_k[:, -1]
    for k in reversed(range(counts_k.shape[1] - 1)):
        chosen = torch.where((totals[:, k] > _CASCADE_TAU)[..., None],
                             counts_k[:, k], chosen)
    return chosen


def _accumulate_logw(logw, legal, codes, cvals, cfg: FillConfig):
    """Full-width soft-count accumulation from natural-log weights with
    double range: logw/legal (I, N, Wp) -> (counts (I, W, 5), deepest-level
    row totals (I, W)).

    Level k accumulates exp(logw + k*SHIFT) with overflowing contributions
    zeroed, and each output row takes the shallowest level whose row total
    exceeds TAU.  Downstream consumers (computeProbsGap normalisation,
    consensus argmax) are per-row scale-invariant, so per-row mixed scaling
    reproduces the reference's C-double ratios.  The totals feed the
    precision-risk flag."""
    m = _soft_m(cfg)
    if m == 1:
        w = torch.where(legal, torch.exp(torch.clamp_min(logw, -700.0)), 0.0)
        counts = fold_counts(w, codes, cvals, cfg.W)
        return counts, counts.sum(dim=-1)
    counts_k = _accumulate_levels(logw, legal, codes, cvals, cfg.W, m)
    return _select_levels(counts_k), counts_k[:, -1].sum(dim=-1)


def _soft_counts_banded(logw1, legal1, logw2, legal2, p0r, codes, cvals,
                        cfg: FillConfig):
    """Banded soft counts with the depth modes of ``_accumulate_logw``; the
    cascade level is selected per assembled ROW, after both bands'
    contributions combine.  Returns (counts (I,W,5), deepest-level row
    totals (I,W))."""
    n = _band_w(cfg) + cfg.L
    m = _soft_m(cfg)
    if m == 1:
        w1 = torch.where(legal1, torch.exp(torch.clamp_min(logw1, -700.0)),
                         0.0)
        w2 = torch.where(legal2, torch.exp(torch.clamp_min(logw2, -700.0)),
                         0.0)
        counts = _assemble_bands(fold_counts(w1, codes, cvals, n),
                                 fold_counts(w2, codes, cvals, n), p0r, cfg)
        return counts, counts.sum(dim=-1)
    ck1 = _accumulate_levels(logw1, legal1, codes, cvals, n, m)
    ck2 = _accumulate_levels(logw2, legal2, codes, cvals, n, m)
    # select-then-assemble: the level choice needs ASSEMBLED row totals
    # (cheap), and the (W, 5) assemble then runs once on band-locally
    # selected counts (each level's contribution to a row is selected as a
    # whole, and assemble is a plain add of the two bands)
    I = ck1.shape[0]
    t1, t2 = ck1.sum(dim=-1), ck2.sum(dim=-1)              # (I, m, n)
    tot = _assemble_bands(t1.transpose(1, 2), t2.transpose(1, 2), p0r, cfg)
    ok = tot > _CASCADE_TAU                                # (I, W, m)
    kstar = torch.where(ok.any(dim=-1), ok.to(torch.int8).argmax(dim=-1),
                        m - 1)                             # (I, W)
    k1 = kstar[:, :n]
    k2 = _take(kstar, p0r, n)

    def _pick(ck, kv):
        idx = kv[:, None, :, None].expand(I, 1, n, 5)
        return ck.gather(1, idx)[:, 0]

    counts = _assemble_bands(_pick(ck1, k1), _pick(ck2, k2), p0r, cfg)
    return counts, tot[..., m - 1]


def _score_soft_band(codes, valid, probs, eprobs, e_pos, p0, cfg):
    n = _band_w(cfg) + cfg.L
    return band_score_soft(codes, valid, _take(probs, p0, n),
                           _take(eprobs, p0, n), e_pos, _band_w(cfg))


def _score_hard_band(codes, valid, gap_string, model, p0, cfg):
    n = _band_w(cfg) + cfg.L
    return band_score_hard(codes, valid, _take(gap_string, p0, n),
                           model["a_fwd"], model["b_fwd"], model["ln_et"],
                           _band_w(cfg))


def _combine_bands_max(s1, s2, p0r):
    """Per-read (max, argmax position) over both bands, scan order."""
    m1, a1 = s1.max(dim=-1).values, s1.argmax(dim=-1).to(torch.int32)
    m2 = s2.max(dim=-1).values
    a2 = s2.argmax(dim=-1).to(torch.int32) + p0r[:, None].to(torch.int32)
    use1 = m1 >= m2
    return torch.where(use1, m1, m2), torch.where(use1, a1, a2)


def _coverage_band(cfg: FillConfig, leg, lens, p0):
    """(I, W) rows covered by any placement of one band."""
    bw = _band_w(cfg)
    dev = leg.device
    ml = torch.where(leg, lens[..., None], 0).max(dim=1).values     # (I,bw)
    creach = torch.cummax(torch.arange(bw, device=dev) + ml, dim=1).values
    ext = torch.cat([creach, creach[:, -1:].expand(-1, cfg.L)], 1)
    loc = ext > torch.arange(bw + cfg.L, device=dev)
    out = torch.zeros((leg.shape[0], cfg.W), dtype=torch.bool, device=dev)
    idx = p0.long()[:, None] + torch.arange(bw + cfg.L, device=dev)
    out[torch.arange(leg.shape[0], device=dev)[:, None], idx] = loc
    return out


def _extract_rows(x, start, L: int):
    """x (I, N) rows padded with 5; returns x[i, start[i, r] + t] (I, R, L)."""
    I, N = x.shape
    xp = torch.cat([x, torch.full((I, L), 5, dtype=x.dtype,
                                  device=x.device)], 1)
    idx = start.long()[..., None] + torch.arange(L, device=x.device)
    return xp.gather(1, idx.reshape(I, -1)).reshape(idx.shape)


def _detect_overlap_partial(cfg: FillConfig, inst, accept, pos_gap):
    """detect_overlap_gapestimate, batched: (bonus (I,), saved_l, saved_r).

    +300 perfect spanning read; +30*max_overlap verified left x right read
    overlap; -100 false overlap (see the reference for the fine print).
    """
    bonus_cap = min(cfg.bonus_cap, cfg.P)
    pr, p_len, p_match = inst["pr"], inst["p_len"], inst["p_match"]
    gl = inst["gap_len"][:, None]
    sl = inst["side_limit"][:, None]
    I, P, L = pr.shape
    dev = pr.device
    acc = accept & inst["p_valid"]

    reach = torch.minimum(pos_gap + p_len, gl) - 1
    leftish = (p_match == 1) | (p_match == 4) | (pos_gap < 0)
    l_max = torch.where(acc & leftish, reach, -_BIG).max(dim=1).values
    start = torch.clamp_min(pos_gap, 0)
    r_min = torch.where(acc & ~leftish, start, _BIG).min(dim=1).values
    l_max = torch.where(l_max == -_BIG, -1, l_max)
    r_min = torch.where(r_min == _BIG, inst["gap_len"], r_min)

    tmpl = inst["tmpl"]
    u = torch.arange(L, device=dev)

    def _flank_frac(f, rch, tch, thresh):
        inwin = u < f[..., None]
        mis = (inwin & (rch != tch)).sum(dim=-1)
        return mis <= thresh * f

    # left-flank fragment: read chars at gap coords [-f, 0) vs the flank
    f_l = torch.minimum(torch.clamp_min(-pos_gap, 0), sl)
    rch_l = shift_left(pr, torch.clamp(-f_l - pos_gap, 0, L), -1)
    tch_l = _extract_rows(tmpl, torch.clamp(cfg.WL - f_l, 0, cfg.W - 1), L)
    ok_l4 = (f_l >= 4) & _flank_frac(f_l, rch_l, tch_l, 0.2 - 1e-9)
    ok_l8 = (f_l >= 8) & _flank_frac(f_l, rch_l, tch_l, 0.08)
    # right-flank fragment from read coord gl - p vs the flank prefix
    startr = gl - pos_gap
    f_r = torch.clamp(torch.minimum(sl, p_len - startr), 0, L)
    rch_r = shift_left(pr, torch.clamp(startr, 0, L), -1)
    tch_r = _extract_rows(
        tmpl, torch.clamp(cfg.WL + gl, 0, cfg.W - 1).expand(I, P), L)
    startr_ok = (startr >= 0) & (startr <= p_len)
    ok_r4 = (f_r >= 4) & startr_ok & _flank_frac(f_r, rch_r, tch_r,
                                                 0.2 - 1e-9)
    ok_r8 = (f_r >= 8) & startr_ok & _flank_frac(f_r, rch_r, tch_r, 0.08)

    # perfect spanning read
    spans = acc & (pos_gap < 0) & (pos_gap + p_len > gl)
    perfect = (spans & ok_l8 & ok_r8).any(dim=1)

    # left x right overlap verification
    lc = acc & (pos_gap < 0) & (reach >= r_min[:, None]) \
        & (pos_gap + p_len <= gl)
    rc_n = acc & (pos_gap > 0) & (pos_gap <= l_max[:, None])
    rc_sm = acc & (pos_gap < 0) & (pos_gap + p_len > gl) \
        & ((p_match == 2) | (p_match == 3))
    rc = rc_n | rc_sm
    if bonus_cap >= P:  # read-order enumeration (reference scan order)
        li = ri = torch.arange(P, device=dev).expand(I, P)
        lval, rval = lc, rc
    else:
        lkey = torch.where(lc, reach, -_BIG)
        rkey = torch.where(rc, -torch.where(rc_sm, pos_gap + (1 << 10),
                                            start), -_BIG)
        li = torch.argsort(-lkey, dim=1, stable=True)[:, :bonus_cap]
        ri = torch.argsort(-rkey, dim=1, stable=True)[:, :bonus_cap]
        lval, rval = lc.gather(1, li), rc.gather(1, ri)
    cap_l, cap_r = li.shape[1], ri.shape[1]
    p1 = pos_gap.gather(1, li)[:, :, None]
    l1 = p_len.gather(1, li)[:, :, None]
    p2 = pos_gap.gather(1, ri)[:, None, :]
    l2 = p_len.gather(1, ri)[:, None, :]
    sm2 = rc_sm.gather(1, ri)[:, None, :]
    glb = gl[:, :, None]
    diff_gap = torch.clamp_min(p1 + l1 - glb, 0)
    ov = (p1 + l1 - 1) - p2 + 1 - diff_gap
    pair_ok = lval[:, :, None] & rval[:, None, :] \
        & (li[:, :, None] != ri[:, None, :]) & (ov >= 5)

    xabs = torch.where(sm2, -p2, 0)
    cmp_len = ov - xabs
    a1s = l1 - ov + xabs - diff_gap
    a2s = xabs
    len_ok = (cmp_len > 0) & (a1s >= 0) & (a2s + cmp_len <= l2)
    flank_ok = ok_l4.gather(1, li)[:, :, None] & ok_r4.gather(1, ri)[:, None, :]

    rows_l = pr.gather(1, li[..., None].expand(I, cap_l, L))   # (I, cl, L)
    rows_r = pr.gather(1, ri[..., None].expand(I, cap_r, L))   # (I, cr, L)
    c1 = shift_left(rows_l[:, :, None, :].expand(I, cap_l, cap_r, L),
                    torch.clamp(a1s, 0, L), -1)
    c2 = shift_left(rows_r, torch.clamp(a2s[:, 0, :], 0, L), -2)
    inwin = u < cmp_len[..., None]
    mism = (inwin & (c1 != c2[:, None])).sum(dim=-1)
    cand = pair_ok & flank_ok & len_ok
    thr = 0.1 * torch.clamp_min(cmp_len, 1)
    good = cand & (mism <= thr)
    bad = cand & (mism > thr)
    max_ov = torch.where(good, cmp_len, 0).reshape(I, -1).max(dim=1).values
    any_false = bad.reshape(I, -1).any(dim=1)

    has_rm = r_min <= l_max
    bonus = torch.where(
        perfect | ((inst["perfect_gap"] == 1) & (inst["orig_gap"] <= 20)
                   & (inst["gap_len"] == inst["perfect_gaplen"])),
        300.0,
        torch.where(
            has_rm & ((~any_false & (max_ov >= 5))
                      | (any_false & (max_ov >= 10))),
            30.0 * max_ov,
            torch.where(has_rm & (any_false | (max_ov < 5)), -100.0, 0.0)))
    # saved pair: FIRST strict maximum in scan order
    flat_arg = torch.where(good, cmp_len, -1).reshape(I, -1).argmax(dim=1)
    gi, gj = flat_arg // cap_r, flat_arg % cap_r
    has = good.reshape(I, -1).any(dim=1)
    saved_l = torch.where(has, li.gather(1, gi[:, None])[:, 0], -1)
    saved_r = torch.where(has, ri.gather(1, gj[:, None])[:, 0], -1)
    return bonus.to(torch.float32), saved_l.to(torch.int32), \
        saved_r.to(torch.int32)


def _counts_flank(inst):
    """Flank one-hots outside the gap zone: (I, W, 5)."""
    tmpl = inst["tmpl"]
    base = torch.where((tmpl >= 0) & (tmpl <= 4), torch.clamp_max(tmpl, 4),
                       4).long()
    c = torch.nn.functional.one_hot(base, 5).to(torch.float32)
    return torch.where((tmpl >= 5)[..., None], 0.0, c)


def _gap_zone(inst, cfg: FillConfig):
    w = torch.arange(cfg.W, device=inst["gap_len"].device)
    return (w >= cfg.WL) & (w < cfg.WL + inst["gap_len"][:, None])


def _read_masks(inst, cfg: FillConfig):
    """(count mask, score mask) per read base: the score mask drops
    clip_thresh bases at the anchored end."""
    L = inst["pr"].shape[-1]
    j = torch.arange(L, device=inst["pr"].device)
    plen = inst["p_len"][..., None]
    left = ((inst["p_match"] == 1) | (inst["p_match"] == 4))[..., None]
    jv_count = j < plen
    jv_score = jv_count & torch.where(left, j >= cfg.clip_thresh,
                                      j < plen - cfg.clip_thresh)
    return jv_count, jv_score


def _place_partial(cfg: FillConfig, inst, model, probs, eprobs):
    pr = inst["pr"]
    jv_count, jv_score = _read_masks(inst, cfg)
    cvals = jv_count.to(torch.float32)
    gap_zone = _gap_zone(inst, cfg)
    p0l, p0r = _band_starts(cfg, inst["gap_len"])
    leg1 = _legal_partial_band(cfg, inst, p0l, True)
    leg2 = _legal_partial_band(cfg, inst, p0r, False)

    ln1 = torch.where(leg1, _score_soft_band(
        pr, jv_score, probs, eprobs, model["e_fwd"], p0l, cfg), NEG)
    ln2 = torch.where(leg2, _score_soft_band(
        pr, jv_score, probs, eprobs, model["e_fwd"], p0r, cfg), NEG)
    soft, deep_total = _soft_counts_banded(LN10 * ln1, leg1, LN10 * ln2,
                                           leg2, p0r, pr, cvals, cfg)
    counts = torch.where(gap_zone[..., None], soft, _counts_flank(inst))
    if cfg.detect_prec and not cfg.exact_soft:
        eff1 = leg1 & (LN10 * ln1 >= _MIN_LOGW_REP)
        eff2 = leg2 & (LN10 * ln2 >= _MIN_LOGW_REP)
        cov = _coverage_band(cfg, eff1, inst["p_len"], p0l) \
            | _coverage_band(cfg, eff2, inst["p_len"], p0r)
        prec = (gap_zone & cov & (deep_total <= _CASCADE_TAU)).any(dim=1)
    else:
        prec = torch.zeros(pr.shape[0], dtype=torch.bool, device=pr.device)

    mx, _ = _combine_bands_max(ln1, ln2, p0r)
    has = mx > NEG / 2
    ml_soft = _csum(torch.where(has & inst["p_valid"], mx, 0.0))

    cons0, _ = consensus_from_counts(counts, gap_zone, 0, 0)
    gap_string = torch.where(gap_zone, cons0, inst["tmpl"])
    sh1 = torch.where(leg1, _score_hard_band(pr, jv_score, gap_string, model,
                                             p0l, cfg), NEG)
    sh2 = torch.where(leg2, _score_hard_band(pr, jv_score, gap_string, model,
                                             p0r, cfg), NEG)
    mh, arg_h = _combine_bands_max(sh1, sh2, p0r)
    pos_h = arg_h - cfg.WL
    accept = (mh > NEG / 2) & (-mh / LN10 < cfg.gap_prob_cutoff) \
        & inst["p_valid"]
    valid = accept.sum(dim=1)

    bonus, saved_l, saved_r = _detect_overlap_partial(cfg, inst, accept,
                                                      pos_h)
    return dict(counts=counts, likelihood=ml_soft + bonus, accept=accept,
                pos=pos_h, valid=valid, saved_l=saved_l, saved_r=saved_r,
                prec=prec)


def em_partial_instance(cfg: FillConfig, inst, model) -> dict:
    """3-iteration partial EM over an instance batch (fillGap partial
    branch)."""
    check_supported(cfg)
    gap_zone = _gap_zone(inst, cfg)
    counts0 = _counts_flank(inst)
    counts0[..., 4] += torch.where(gap_zone, 1.0, 0.0)
    probs = compute_probs_gap(counts0)
    st4, left_max, right_min = _stack_for(inst, cfg)
    tot = st4.sum(dim=-1, keepdim=True)
    stp = torch.cat([st4 / tot, torch.zeros_like(tot)], dim=-1)
    stp_w = torch.zeros_like(probs)
    stp_w[:, cfg.WL : cfg.WL + cfg.max_gap_len] = stp
    probs = torch.where(gap_zone[..., None], stp_w, probs)
    eprobs = compute_error_probs_gap(probs, model["et"])

    out = None
    prec = torch.zeros_like(inst["gap_len"], dtype=torch.bool)
    for _ in range(3):  # the partial EM always runs 3 passes
        out = _place_partial(cfg, inst, model, probs, eprobs)
        prec = prec | out["prec"]
        probs = compute_probs_gap(out["counts"])
        eprobs = compute_error_probs_gap(probs, model["et"])

    cons, _ = consensus_from_counts(out["counts"], gap_zone, 0, 0)
    return dict(
        likelihood=out["likelihood"],
        consensus=cons[:, cfg.WL : cfg.WL + cfg.max_gap_len],
        valid=out["valid"], accept=out["accept"], pos=out["pos"],
        saved_l=out["saved_l"], saved_r=out["saved_r"], counts=out["counts"],
        left_max=left_max, right_min=right_min, prec=prec)


def fill_batch(cfg: FillConfig, insts: dict, model: dict) -> dict:
    """EM over the instance batch (leading axis of every ``insts`` array);
    ``model``: e_fwd/e_rev/a_fwd/a_rev/b_fwd/b_rev (L,), et/ln_et (5,5),
    ln_ins (M,)."""
    return em_partial_instance(cfg, insts, model)


# ---------------------------------------------------------------------------
# gathered entry points: per-GAP arrays live on the device once; a dispatch
# passes only (gap_idx, gap_len) vectors
# ---------------------------------------------------------------------------

def build_tmpl(left_win, right_win, gap_len, cfg: FillConfig):
    """Window templates (I, W): left flank, 4 in the gap zone, right flank
    (5 beyond the contig)."""
    w = torch.arange(cfg.W, device=left_win.device)
    gl = gap_len[:, None]
    ridx = torch.clamp(w - cfg.WL - gl, 0, right_win.shape[1] - 1)
    out = torch.where(w < cfg.WL + gl, 4, right_win.gather(1, ridx))
    left = torch.cat([left_win, torch.full(
        (left_win.shape[0], cfg.W - cfg.WL), 5, dtype=left_win.dtype,
        device=left_win.device)], 1)
    return torch.where(w < cfg.WL, left, out).to(torch.int8)


def _gather_inst(cfg: FillConfig, gap_arrays, gap_idx, gap_len):
    gi = gap_idx.long()
    inst = {k: v[gi] for k, v in gap_arrays.items()
            if k not in ("left_win", "right_win")}
    inst["gap_len"] = gap_len
    inst["tmpl"] = build_tmpl(gap_arrays["left_win"][gi],
                              gap_arrays["right_win"][gi], gap_len, cfg)
    return inst


def fill_batch_gathered(cfg, gap_arrays, gap_idx, gap_len, model) -> dict:
    return em_partial_instance(cfg, _gather_inst(cfg, gap_arrays, gap_idx,
                                                 gap_len), model)


def finalize_partial_instance(cfg: FillConfig, inst, model, best_string,
                              saved_l, saved_r) -> dict:
    """Finalize placement against the chosen string (batched): hard
    re-placement, acceptance, hard counts and quality-weighted counts."""
    check_supported(cfg)
    pr = inst["pr"]
    I, P, L = pr.shape
    gap_zone = _gap_zone(inst, cfg)
    bws = torch.full((I, cfg.W), 4, dtype=torch.int8, device=pr.device)
    bws[:, cfg.WL : cfg.WL + cfg.max_gap_len] = best_string
    gap_string = torch.where(gap_zone, bws, inst["tmpl"])
    jv_count, jv_score = _read_masks(inst, cfg)
    p0l, p0r = _band_starts(cfg, inst["gap_len"])
    leg1 = _legal_partial_band(cfg, inst, p0l, True)
    leg2 = _legal_partial_band(cfg, inst, p0r, False)
    sh1 = torch.where(leg1, _score_hard_band(pr, jv_score, gap_string, model,
                                             p0l, cfg), NEG)
    sh2 = torch.where(leg2, _score_hard_band(pr, jv_score, gap_string, model,
                                             p0r, cfg), NEG)
    mh, arg_h = _combine_bands_max(sh1, sh2, p0r)
    mh10 = mh / LN10
    pos = arg_h - cfg.WL
    r = torch.arange(P, device=pr.device)
    accept = (((mh10 > NEG / 2) & (-mh10 < cfg.gap_prob_cutoff))
              | (r == saved_l[:, None]) | (r == saved_r[:, None])) \
        & inst["p_valid"]
    band = torch.arange(_band_w(cfg), device=pr.device)
    a = arg_h[..., None]
    wh1 = (accept[..., None] & (a < cfg.WL) & (band == a)).to(torch.float32)
    wh2 = (accept[..., None] & (a >= cfg.WL)
           & (p0r[:, None, None] + band == a)).to(torch.float32)
    n = _band_w(cfg) + cfg.L
    cvals = jv_count.to(torch.float32)
    counts = _assemble_bands(fold_counts(wh1, pr, cvals, n),
                             fold_counts(wh2, pr, cvals, n), p0r, cfg)
    counts = torch.where(gap_zone[..., None], counts, 0.0)
    # quality-weighted counts for check_update
    qvals = cvals * inst["p_qerr"]
    qual = _assemble_bands(fold_counts(wh1, pr, qvals, n),
                           fold_counts(wh2, pr, qvals, n), p0r, cfg)
    qual = torch.where(gap_zone[..., None], qual, 0.0)
    return dict(counts=counts, qual=qual, accept=accept, pos=pos,
                used=accept.sum(dim=1))


def finalize_batch_gathered(cfg, gap_arrays, gap_idx, gap_len, model,
                            best_strings, saved_l, saved_r) -> dict:
    return finalize_partial_instance(
        cfg, _gather_inst(cfg, gap_arrays, gap_idx, gap_len), model,
        best_strings, saved_l, saved_r)


# ---------------------------------------------------------------------------
# packed entry points: one f32 matrix per dispatch, one host copy each
# ---------------------------------------------------------------------------

SCAN_COLS = 9  # lik, valid, discont, ucoverf, umaxleftf, umaxrightf,
               # region_perct, bailed, prec


def fill_batch_scan(cfg, gap_arrays, gap_idx, gap_len, model):
    """Scan instances -> packed (IB, SCAN_COLS) f32 replay scalars."""
    out = fill_batch_gathered(cfg, gap_arrays, gap_idx, gap_len, model)
    z = torch.zeros_like(out["likelihood"])
    cols = [out["likelihood"], out["valid"].to(torch.float32)] + [z] * 6 \
        + [out["prec"].to(torch.float32)]
    return torch.stack(cols, dim=1)


def fill_batch_full_packed(cfg, gap_arrays, gap_idx, gap_len, model):
    """Winner/original-length re-run -> packed [consensus (maxG), accept
    (P), pos (P), saved_l, saved_r, region_perct, bailed, prec]."""
    out = fill_batch_gathered(cfg, gap_arrays, gap_idx, gap_len, model)
    z = torch.zeros_like(out["likelihood"])[:, None]
    return torch.cat([out["consensus"].to(torch.float32),
                      out["accept"].to(torch.float32),
                      out["pos"].to(torch.float32),
                      out["saved_l"].to(torch.float32)[:, None],
                      out["saved_r"].to(torch.float32)[:, None], z, z,
                      out["prec"].to(torch.float32)[:, None]], dim=1)


def full_packed_layout(cfg: FillConfig) -> dict:
    o, at = {}, 0
    for name, width in (("consensus", cfg.max_gap_len), ("accept", cfg.P),
                        ("pos", cfg.P), ("saved_l", 1), ("saved_r", 1),
                        ("region_perct", 1), ("bailed", 1), ("prec", 1)):
        o[name] = (at, at + width)
        at += width
    o["_total"] = at
    return o


def finalize_batch_packed(cfg, gap_arrays, gap_idx, gap_len, model,
                          best_strings, saved_l, saved_r):
    """Finalize pass -> packed [counts gap-zone (maxG*5), qual gap-zone
    (maxG*5), accept (P), pos (P), used]."""
    out = finalize_batch_gathered(cfg, gap_arrays, gap_idx, gap_len, model,
                                  best_strings, saved_l, saved_r)
    ib = gap_idx.shape[0]
    zone = slice(cfg.WL, cfg.WL + cfg.max_gap_len)
    return torch.cat([out["counts"][:, zone].reshape(ib, -1),
                      out["qual"][:, zone].reshape(ib, -1),
                      out["accept"].to(torch.float32),
                      out["pos"].to(torch.float32),
                      out["used"].to(torch.float32)[:, None]], dim=1)


def finalize_packed_layout(cfg: FillConfig) -> dict:
    o, at = {}, 0
    for name, width in (("counts", cfg.max_gap_len * 5),
                        ("qual", cfg.max_gap_len * 5), ("accept", cfg.P),
                        ("pos", cfg.P), ("used", 1)):
        o[name] = (at, at + width)
        at += width
    o["_total"] = at
    return o
