"""Batched GapFiller EM, partial and unmapped modes
(``figbird_tpu/fill/em.py``).

The reference ``vmap``s each per-instance function over a leading instance
axis; here that axis is written out: every tensor of an instance batch
carries a leading dimension I.  Both placements run on four kernels
(``ops.band``): the fused soft score (K2), the hard score against the
consensus (K3), the soft-count cascade (K1: the exact 6-level cascade of the
production default, or a ``soft_levels``-deep mini-cascade) and the
raw-weight count fold (K4: the plain-f32 soft accumulate of ``soft_levels ==
1``, the unmapped hard counts and the finalize counts); the partial mode's
overlap bonus is one more kernel (``ops.overlap``).  The partial mode
places reads in two read-length bands at the gap edges; the unmapped mode
scores every read at every position of the window, both strands' factors,
and iterates until its consensus is stable (the reference's ``while_loop``,
here a per-lane live mask: finished lanes are frozen by ``torch.where``, and
the loop ends when no lane is live).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops.band import CASCADE_GROUP as _CASCADE_GROUP
from ..ops.band import (MASKED, band_score_hard, band_score_soft,
                        cascade_counts, fold_counts, level_weight)
from ..ops.overlap import _BIG, overlap_bonus, shift_left

LN10 = float(np.log(10.0))
NEG = -1e30

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
    if cfg.partial_mode == cfg.unmapped_mode:
        raise ValueError("FillConfig: exactly one of partial_mode and "
                         "unmapped_mode must be set")


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

    # the overlap bonus: one kernel launch on the card (ops.overlap)
    bonus, saved_l, saved_r = overlap_bonus(cfg, inst, accept, pos_h)
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


# ---------------------------------------------------------------------------
# unmapped placement: every read is scored at every candidate position of
# the window, with the strand's cycle-indexed error rates; candidate
# legality is the read's reach into the gap plus the insert-size bounds
# ---------------------------------------------------------------------------

def _legal_unmapped(cfg: FillConfig, inst, model):
    """Candidate legality and the insert-prior index of every (read,
    position): (legal (I,R,Wp) bool, t_ins (I,R,Wp) clipped)."""
    dev = inst["ur"].device
    p = torch.arange(cfg.Wp, device=dev)
    gs = inst["gap_start"][:, None, None]
    cpos = gs - cfg.WL + p
    rlen = inst["u_len"][..., None]
    ge = gs + inst["gap_len"][:, None, None]
    rng = (cpos >= gs - rlen + 1) & (cpos < ge)
    pos1 = inst["u_pos"][..., None]
    left = pos1 < gs
    pos1_r = pos1 + (inst["gap_len"] - inst["orig_gap"])[:, None, None]
    t_ins = torch.where(left, cpos - pos1 + rlen, pos1_r - cpos + rlen)
    ins_ok = (t_ins >= cfg.insert_tmin) & (t_ins <= cfg.insert_tmax)
    tc = torch.clamp(t_ins, 0, model["ln_ins"].shape[0] - 1)
    return rng & ins_ok & inst["u_valid"][..., None], tc


def _coverage_full(cfg: FillConfig, legal, lens):
    """(I, W) rows covered by any legal full-width placement."""
    dev = legal.device
    ml = torch.where(legal, lens[..., None], 0).max(dim=1).values  # (I,Wp)
    creach = torch.cummax(torch.arange(cfg.Wp, device=dev) + ml,
                          dim=1).values
    ext = torch.cat([creach, creach[:, -1:].expand(-1, cfg.W - cfg.Wp)], 1)
    return ext > torch.arange(cfg.W, device=dev)


def _unmapped_prep(cfg: FillConfig, inst, model) -> dict:
    """Loop-invariant tensors of the unmapped EM: base masks, legality, the
    insert prior, the strand selector and the flank counts."""
    L = inst["ur"].shape[-1]
    jv = torch.arange(L, device=inst["ur"].device) < inst["u_len"][..., None]
    legal, t_ins = _legal_unmapped(cfg, inst, model)
    return dict(jv=jv, cvals=jv.to(torch.float32), legal=legal,
                prior=model["ln_ins"][t_ins.long()],
                rev=(inst["u_rev"] == 1)[..., None],
                flank=_counts_flank(inst))


def _hard_score_unmapped(cfg: FillConfig, inst, model, prep, gap_string):
    """Hard scores (I,R,Wp) against ``gap_string``: K3 with both strands'
    factors, the read's own strand selected, illegal positions NEG."""
    ur, jv = inst["ur"], prep["jv"]
    sh_f = band_score_hard(ur, jv, gap_string, model["a_fwd"],
                           model["b_fwd"], model["ln_et"], cfg.Wp)
    sh_r = band_score_hard(ur, jv, gap_string, model["a_rev"],
                           model["b_rev"], model["ln_et"], cfg.Wp)
    sh = torch.where(prep["rev"], sh_r, sh_f)
    return torch.where(prep["legal"], sh, NEG)


def _low_regions(cfg: FillConfig, gap_cov, gap_len):
    """Low-coverage runs of >= 11 rows (Figbird.cpp:3935-3977): (first row,
    last row, any) of the qualifying rows per instance."""
    dev = gap_cov.device
    t = torch.arange(cfg.max_gap_len, device=dev)
    gl = gap_len[:, None]
    in_gap = t < gl
    low = (gap_cov < cfg.coverage_threshold2) & in_gap
    not_low_idx = torch.where(~low & in_gap, t, -1)
    run_start = torch.cummax(not_low_idx, dim=1).values + 1
    nxt = torch.where(~low & in_gap, t, _BIG)
    next_not_low = torch.cummin(nxt.flip(1), dim=1).values.flip(1)
    run_end = torch.where(next_not_low < _BIG, next_not_low - 1, gl - 1)
    qualif = low & (run_end - run_start + 1 >= 11)
    first_q = torch.where(qualif, t, _BIG).min(dim=1).values
    last_q = torch.where(qualif, t, -_BIG).max(dim=1).values
    return first_q, last_q, qualif.any(dim=1)


def _find_overlap_unmapped(cfg: FillConfig, inst, accept, pos_gap, lens):
    """findOverlapUnmapped (2945-3019), batched: chain discontinuity
    penalties.  Returns (value (I,), new_accept (I,R), discont (I,))."""
    R = accept.shape[1]
    dev = accept.device
    key = torch.where(accept, pos_gap, -200)
    order = torch.argsort(key, dim=1, stable=True)
    sp = key.gather(1, order)
    sl = lens.gather(1, order)
    real = sp != -200
    diff = sp + sl - torch.roll(sp, -1, dims=1)
    pairable = real & (torch.arange(R, device=dev) < R - 1)
    discont = pairable & (diff >= 0) & (diff < 4)  # match_count_discont
    gap_pen = pairable & (diff < 0)
    value = torch.where(discont, -250.0, 0.0).sum(dim=1) \
        + torch.where(gap_pen, -200.0, 0.0).sum(dim=1)
    # unmark both reads of gap-separated pairs (both index maps permute)
    unmark = torch.zeros_like(accept).scatter(1, order, gap_pen) \
        | torch.zeros_like(accept).scatter(1, torch.roll(order, -1, dims=1),
                                           gap_pen)
    new_accept = accept & ~unmark
    # edge-crossing advantages (+50), counted on the pre-unmark set
    gl = inst["gap_len"][:, None]
    lr1 = accept & (pos_gap < 0) & (-pos_gap >= 3) & (pos_gap + lens > 0)
    lr2 = accept & (pos_gap < gl) & (pos_gap + lens - gl >= 3)
    value = value + 50.0 * (lr1.sum(dim=1) + lr2.sum(dim=1))
    return value, new_accept, discont.any(dim=1)


def _update_reanchor(cfg: FillConfig, inst, counts, gc, accept, has_place,
                     pl_major, left_max):
    """The "update" re-anchoring step (Figbird.cpp:4030-4376), batched.

    Unplaced-but-placeable reads are re-anchored by exact suffix/prefix
    match (> 25% of the read length) onto the consensus edges around the
    unfilled N region; matching reads vote (weight = match length) into the
    region, and rows with votes replace the counts with frequencies.  With
    no left anchor, the partial-read majority string votes instead
    (4310-4321; its flag is the LAST eligible read's insert flag, the
    reference's loop-variable reuse).  The right-side fallback (4322-4331)
    is dead code in the reference and is not replicated.  Returns the
    counts (I, W, 5); the N column is untouched."""
    ur, rl = inst["ur"], inst["u_len"]
    I, R, L = ur.shape
    mgl = cfg.max_gap_len
    dev = ur.device
    MS = max(int(L * 0.67), 2)
    thresh = int(L * 0.25)
    min_gap = L // 2 + 1
    gap_len = inst["gap_len"]
    gl = gap_len[:, None]
    gs = inst["gap_start"]
    t = torch.arange(mgl, device=dev)
    in_gap = t < gl
    isn = (gc == 4) & in_gap

    # long-N-run endpoints (index_pair[0/1], 4058-4093); runs < min_gap_len
    # are ignored
    run_start = torch.cummax(torch.where(~isn & in_gap, t, -1),
                             dim=1).values + 1
    nxt = torch.where(~isn & in_gap, t, _BIG)
    next_non = torch.cummin(nxt.flip(1), dim=1).values.flip(1)
    run_end = torch.where(next_non < _BIG, next_non - 1, gl - 1)
    qual = isn & (run_end - run_start + 1 >= min_gap)
    any_q = qual.any(dim=1)
    s0 = torch.where(qual, run_start, _BIG).min(dim=1).values
    e1 = torch.where(qual, run_end, -_BIG).max(dim=1).values
    index0 = torch.clamp_min(s0 - 1, 0)
    index1 = torch.minimum(e1 + 1, gap_len - 1)

    # left text segment: up to MS chars ending at index0, N-truncated (4110)
    jj = torch.arange(MS, device=dev)
    TLpos = torch.clamp_min(index0 - MS + 1, 0)[:, None] + jj
    TL = gc.gather(1, torch.clamp(TLpos, 0, mgl - 1))
    badl = (TL == 4) | (TLpos >= gl)
    VL = torch.where(badl.any(dim=1), badl.to(torch.int8).argmax(dim=1), MS)
    # right segment: MS chars from index1, N kept verbatim (4123-4129)
    TR_len = torch.clamp_max(gap_len - index1, MS)
    TR = gc.gather(1, torch.clamp(index1[:, None] + jj, 0, mgl - 1))
    TRrev = TR.gather(1, torch.clamp(TR_len[:, None] - 1 - jj, 0, MS - 1))

    elig = ~accept & has_place & inst["u_valid"]
    upos = inst["u_pos"]

    def ins_ok(idx):  # per-read insert gating at an anchor (4177-4197)
        placed = (gs + idx)[:, None]
        ins = torch.where(upos < gs[:, None], placed + rl - upos,
                          upos - placed + rl)
        return (ins >= cfg.insert_tmin + 100) & (ins <= cfg.insert_tmax - 100)

    ok0, ok1 = ins_ok(index0), ins_ok(index1)

    def first_match(seg, seg_len, read_k):
        """Smallest offset j with seg[j:seg_len] == read[:seg_len-j]
        exactly and match length > thresh: (found, match_len), (I, R)."""
        m_len = seg_len[:, None] - jj                            # (I, MS)
        at = torch.clamp(jj[:, None] + jj[None, :], 0, MS - 1)   # (j, k)
        seg_at = seg[:, at.reshape(-1)].reshape(I, 1, MS, MS)
        miss = (seg_at != read_k[:, :, None, :]) \
            | (jj >= rl[..., None, None])                        # (I,R,j,k)
        need = jj < m_len[:, None, :, None]
        okk = ~(miss & need).any(dim=-1)                         # (I, R, j)
        ok = okk & ((m_len > thresh) & (jj < seg_len[:, None]))[:, None, :]
        jstar = ok.to(torch.int8).argmax(dim=-1)
        return ok.any(dim=-1), seg_len[:, None] - jstar

    has_l, match_l = first_match(TL, VL, ur[..., :MS])
    # the right side matches the reversed read against the reversed segment
    # (4250-4262)
    rev_all = shift_left(ur.flip(-1), torch.clamp(L - rl, 0, L), 4)
    has_r, match_r = first_match(TRrev, TR_len, rev_all[..., :MS])
    has_l = has_l & elig & ok0 & any_q[:, None]
    has_r = has_r & elig & ok1 & any_q[:, None]

    ri = torch.arange(L, device=dev)
    in_read = ri < rl[..., None]
    i0, i1 = index0[:, None, None], index1[:, None, None]
    # left votes: read char ri lands at index0 - match + 1 + ri (4224-4238)
    pos_l = i0 - match_l[..., None] + 1 + ri
    val_l = has_l[..., None] & (pos_l > i0) & (pos_l < gl[..., None]) \
        & in_read
    w_l = torch.where(val_l, match_l[..., None], 0).to(torch.float32)
    # right votes: reversed char ri lands at index1 + match - 1 - ri
    # (4283-4299)
    pos_r = i1 + match_r[..., None] - 1 - ri
    val_r = has_r[..., None] & (pos_r < i1) & (pos_r >= 0) & in_read
    w_r = torch.where(val_r, match_r[..., None], 0).to(torch.float32)
    idx_l = torch.clamp(pos_l, 0, mgl - 1).reshape(I, -1)
    idx_r = torch.clamp(pos_r, 0, mgl - 1).reshape(I, -1)
    cols = []
    for c in range(4):  # read-N spreads over ACGT
        wl_c = torch.where((ur == c) | (ur == 4), w_l, 0.0).reshape(I, -1)
        wr_c = torch.where((rev_all == c) | (rev_all == 4), w_r,
                           0.0).reshape(I, -1)
        col = torch.zeros((I, mgl), dtype=torch.float32, device=dev)
        cols.append(col.scatter_add(1, idx_l, wl_c).scatter_add(1, idx_r,
                                                                wr_c))
    cp = torch.stack(cols, dim=-1)                               # (I,mgl,4)

    # left partial-majority fallback (4310-4321)
    last_elig = torch.where(elig, torch.arange(R, device=dev), -1).max(
        dim=1).values
    ok0_last = ok0.gather(1, torch.clamp(last_elig, 0, R - 1)[:, None])[:, 0]
    flag1_last = torch.where(last_elig >= 0, ok0_last, True) & any_q
    len_pl = torch.clamp_min(left_max - 4 + 1 - 1, 0)
    fb = flag1_last & (has_l.sum(dim=1) == 0) & (index0 < len_pl)
    fb_pos = fb[:, None] & (t > index0[:, None]) & (t < len_pl[:, None])
    plm = torch.clamp_max(pl_major, 4)
    fb4 = torch.stack([((plm == c) | (plm == 4)).to(torch.float32)
                       for c in range(4)], dim=-1)
    cp = cp + torch.where(fb_pos[..., None], fb4, 0.0)

    # replace the gap rows that got votes with frequencies (4334-4352)
    tot = cp.sum(dim=-1)
    gidx = torch.arange(cfg.W, device=dev) - cfg.WL
    gcl = torch.clamp(gidx, 0, mgl - 1)
    cp_w, tot_w = cp[:, gcl], tot[:, gcl]
    repl = (tot_w > 0) & (gidx >= 0) & (gidx < gl) & any_q[:, None]
    new4 = torch.where(repl[..., None],
                       cp_w / torch.clamp_min(tot_w, 1e-9)[..., None],
                       counts[..., :4])
    return torch.cat([new4, counts[..., 4:]], dim=-1)


def _place_unmapped(cfg: FillConfig, inst, model, probs, eprobs,
                    finalize_flag: bool, prep: dict) -> dict:
    """One unmapped EM pass (placeReads, unmapped branch): soft scores of
    both strands (K2 twice), the soft counts (K1, or K4 at ``soft_levels ==
    1``), the hard pass against the soft consensus (K3 twice), hard counts
    at the argmax positions (K4); with ``finalize_flag`` the low-coverage
    region, the interior-read drop and the chain discontinuity penalties."""
    ur, u_len, u_valid = inst["ur"], inst["u_len"], inst["u_valid"]
    legal = prep["legal"]
    gap_zone = _gap_zone(inst, cfg)

    # soft pass: two strand groups for the cycle-indexed error rate
    ln_f = band_score_soft(ur, prep["jv"], probs, eprobs, model["e_fwd"],
                           cfg.Wp)
    ln_r = band_score_soft(ur, prep["jv"], probs, eprobs, model["e_rev"],
                           cfg.Wp)
    lnP = torch.where(prep["rev"], ln_r, ln_f) + prep["prior"]
    lnP = torch.where(legal, lnP, NEG)
    logw_u = 0.5 * lnP / LN10
    soft, deep_total = _accumulate_logw(logw_u, legal, ur, prep["cvals"], cfg)
    counts = torch.where(gap_zone[..., None], soft, prep["flank"])
    if cfg.detect_prec and not cfg.exact_soft:
        eff = legal & (logw_u >= _MIN_LOGW_REP)
        cov = _coverage_full(cfg, eff, u_len)
        prec = (gap_zone & cov & (deep_total <= _CASCADE_TAU)).any(dim=1)
    else:
        prec = torch.zeros(ur.shape[0], dtype=torch.bool, device=ur.device)
    mx10 = lnP.max(dim=-1).values / LN10

    # hard pass against the current consensus
    cons0, _ = consensus_from_counts(counts, gap_zone, 0, 0)
    sh = _hard_score_unmapped(cfg, inst, model, prep,
                              torch.where(gap_zone, cons0, inst["tmpl"]))
    mh10 = sh.max(dim=-1).values / LN10
    pos_h = sh.argmax(dim=-1).to(torch.int32) - cfg.WL
    accept = (mh10 > NEG / 2) & (-mh10 < cfg.gap_prob_cutoff) & u_valid
    likelihood = _csum(torch.where(u_valid, torch.where(accept, mh10, -50.0),
                                   0.0))
    valid = accept.sum(dim=1)

    # hard counts at the max positions only (3868-3879)
    w_hard = (accept[..., None]
              & (torch.arange(cfg.Wp, device=ur.device)
                 == (pos_h + cfg.WL)[..., None])).to(torch.float32)
    new_counts = fold_counts(w_hard, ur, prep["cvals"], cfg.W)
    new_counts = torch.where(gap_zone[..., None], new_counts, 0.0)
    cons2, cov2 = consensus_from_counts(new_counts, gap_zone, 1,
                                        cfg.coverage_threshold1)
    gap_cov = cov2[:, cfg.WL : cfg.WL + cfg.max_gap_len]

    I = ur.shape[0]
    region_perct = torch.zeros(I, dtype=torch.float32, device=ur.device)
    discont = torch.zeros(I, dtype=torch.bool, device=ur.device)
    if finalize_flag:
        gap_len = inst["gap_len"]
        first_q, last_q, any_q = _low_regions(cfg, gap_cov, gap_len)
        region_perct = torch.where(
            any_q, (last_q - first_q).to(torch.float32)
            / torch.clamp_min(gap_len, 1), 0.0)
        # discard interior-only reads (3993-4013)
        interior = accept & (pos_h >= first_q[:, None]) \
            & (pos_h + u_len - 1 < last_q[:, None]) & any_q[:, None]
        likelihood = likelihood - 50.0 * interior.sum(dim=1)
        accept = accept & ~interior
        valid = valid - interior.sum(dim=1)
        ov_val, accept, discont = _find_overlap_unmapped(cfg, inst, accept,
                                                         pos_h, u_len)
        likelihood = likelihood + ov_val
    return dict(counts=counts, likelihood=likelihood, accept=accept,
                pos=pos_h, valid=valid, cons2=cons2,
                region_perct=region_perct, discont=discont, mx10=mx10,
                prec=prec)


def em_unmapped_instance(cfg: FillConfig, inst, model, finalize_flag: bool,
                         large_break: bool | None = None) -> dict:
    """Unmapped EM over an instance batch: each lane iterates until its
    consensus is stable ``comp_stable`` times or it reaches the iteration
    cap (fillGap, unmapped branch).  Small gaps run the loop with the
    finalize extras off and one finalize pass at the end; ``large_break``
    (default: ``finalize_flag``) adds the large-gap region break.  A lane's
    outputs do not depend on its batch-mates: the staged scan re-runs
    bailed lanes from scratch and relies on that."""
    check_supported(cfg)
    if large_break is None:
        large_break = finalize_flag
    I = inst["gap_len"].shape[0]
    R = inst["ur"].shape[1]
    dev = inst["ur"].device
    gap_zone = _gap_zone(inst, cfg)
    counts0 = _counts_flank(inst)
    counts0[..., 4] += torch.where(gap_zone, 1.0, 0.0)
    probs0 = compute_probs_gap(counts0)
    # the partial-stack initialisation runs in unmapped mode too
    st4, left_max, _ = _stack_for(inst, cfg)
    pl_major = st4.argmax(dim=-1).to(torch.int8)  # partial_left chars
    tot = st4.sum(dim=-1, keepdim=True)
    stp_w = torch.zeros_like(probs0)
    stp_w[:, cfg.WL : cfg.WL + cfg.max_gap_len] = torch.cat(
        [st4 / tot, torch.zeros_like(tot)], dim=-1)
    probs0 = torch.where(gap_zone[..., None], stp_w, probs0)
    prep = _unmapped_prep(cfg, inst, model)

    def zeros(*shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    s = dict(it=zeros(I, dtype=torch.int32), comp=zeros(I, dtype=torch.int32),
             done=zeros(I, dtype=torch.bool), probs=probs0,
             eprobs=compute_error_probs_gap(probs0, model["et"]),
             counts=counts0, likelihood=zeros(I, dtype=torch.float32),
             accept=zeros(I, R, dtype=torch.bool),
             pos=zeros(I, R, dtype=torch.int32),
             valid=zeros(I, dtype=torch.int64),
             prev=torch.full((I, cfg.max_gap_len), -1, dtype=torch.int8,
                             device=dev),
             region_perct=zeros(I, dtype=torch.float32),
             discont=zeros(I, dtype=torch.bool),
             prec=zeros(I, dtype=torch.bool))
    while True:
        live = ~s["done"] & (s["it"] < cfg.em_iters)
        if not bool(live.any()):  # one host sync per trip
            break
        out = _place_unmapped(cfg, inst, model, s["probs"], s["eprobs"],
                              finalize_flag, prep)
        gc = out["cons2"][:, cfg.WL : cfg.WL + cfg.max_gap_len]
        comp = torch.where((gc == s["prev"]).all(dim=1), s["comp"] + 1, 0)
        counts = out["counts"]
        if finalize_flag:
            # "update" re-anchoring of unplaced reads onto the consensus
            # edges (4029: comp_count >= 1, region_perct != 0, not the last
            # EM iteration)
            upd = _update_reanchor(cfg, inst, counts, gc, out["accept"],
                                   out["mx10"] > NEG / 2, pl_major, left_max)
            cnd = (comp >= 1) & (out["region_perct"] != 0.0) \
                & (s["it"] != cfg.em_iters - 1)
            counts = torch.where(cnd[:, None, None], upd, counts)
        probs = compute_probs_gap(counts)
        done = comp >= cfg.comp_stable
        if large_break:  # large-gap early break (6338)
            done = done | (out["region_perct"]
                           * inst["gap_len"].to(torch.float32) < 2.0 * cfg.L)
        new = dict(it=s["it"] + 1, comp=comp, done=done, probs=probs,
                   eprobs=compute_error_probs_gap(probs, model["et"]),
                   counts=out["counts"], likelihood=out["likelihood"],
                   accept=out["accept"], pos=out["pos"], valid=out["valid"],
                   prev=gc, region_perct=out["region_perct"],
                   discont=out["discont"], prec=s["prec"] | out["prec"])
        s = {k: torch.where(live.reshape((I,) + (1,) * (v.dim() - 1)),
                            new[k], v).to(v.dtype)
             for k, v in s.items()}

    if not finalize_flag:
        # one finalize-mode placeReads after convergence (6348-6352)
        out = _place_unmapped(cfg, inst, model, s["probs"], s["eprobs"], True,
                              prep)
        s.update({k: out[k] for k in ("likelihood", "accept", "pos", "valid",
                                      "counts", "region_perct", "discont")})
        s["prec"] = s["prec"] | out["prec"]

    cons, _ = consensus_from_counts(s["counts"], gap_zone, 0, 0)
    # edge flags for the small-gap scan heuristics (3894-3911)
    pos, acc, u_len = s["pos"], s["accept"], inst["u_len"]
    gl = inst["gap_len"][:, None]
    val = pos + u_len - gl
    ucoverf = (acc & (pos < 0) & (val > 0) & (-pos > 3) & (val > 3)).any(1)
    umaxleftf = (acc & (pos < 0) & (pos + u_len > 0) & (-pos > 3)).any(1)
    umaxrightf = (acc & (pos > 0) & (pos < gl) & (val > 0) & (val > 3)).any(1)
    return dict(
        likelihood=s["likelihood"],
        consensus=cons[:, cfg.WL : cfg.WL + cfg.max_gap_len],
        valid=s["valid"], accept=acc, pos=pos, counts=s["counts"],
        region_perct=s["region_perct"], discont=s["discont"],
        ucoverf=ucoverf, umaxleftf=umaxleftf, umaxrightf=umaxrightf,
        iters=s["it"], prec=s["prec"],
        # hit the cap unconverged: the staged scan re-runs these lanes at a
        # deeper cap
        bailed=~s["done"] & (s["it"] >= cfg.em_iters))


def fill_batch(cfg: FillConfig, insts: dict, model: dict,
               finalize_flag: bool = True,
               large_break: bool | None = None) -> dict:
    """EM over the instance batch (leading axis of every ``insts`` array);
    ``model``: e_fwd/e_rev/a_fwd/a_rev/b_fwd/b_rev (L,), et/ln_et (5,5),
    ln_ins (M,).  ``finalize_flag``/``large_break`` apply to the unmapped
    mode."""
    if cfg.partial_mode:
        return em_partial_instance(cfg, insts, model)
    return em_unmapped_instance(cfg, insts, model, finalize_flag, large_break)


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


def fill_batch_gathered(cfg, gap_arrays, gap_idx, gap_len, model,
                        finalize_flag: bool = True,
                        large_break: bool | None = None) -> dict:
    return fill_batch(cfg, _gather_inst(cfg, gap_arrays, gap_idx, gap_len),
                      model, finalize_flag, large_break)


# ---------------------------------------------------------------------------
# finalize passes: deterministic re-placement against the chosen string, no
# insert prior (partial) / the insert legality (unmapped)
# ---------------------------------------------------------------------------

def _best_gap_string(cfg: FillConfig, inst, best_string, gap_zone):
    bws = torch.full((best_string.shape[0], cfg.W), 4, dtype=torch.int8,
                     device=best_string.device)
    bws[:, cfg.WL : cfg.WL + cfg.max_gap_len] = best_string
    return torch.where(gap_zone, bws, inst["tmpl"])


def finalize_unmapped_instance(cfg: FillConfig, inst, model, best_string,
                               saved) -> dict:
    """Finalize placement of the unmapped reads against the chosen string
    (batched): hard re-placement (K3, both strands), acceptance gated by the
    winning scan instance's saved-read flags, hard counts (K4) and the edge
    statistics of the guard battery."""
    check_supported(cfg)
    gap_zone = _gap_zone(inst, cfg)
    gap_string = _best_gap_string(cfg, inst, best_string, gap_zone)
    prep = _unmapped_prep(cfg, inst, model)
    sh = _hard_score_unmapped(cfg, inst, model, prep, gap_string)
    mh10 = sh.max(dim=-1).values / LN10
    pos = sh.argmax(dim=-1).to(torch.int32) - cfg.WL
    accept = ((mh10 > NEG / 2) & (-mh10 < cfg.gap_prob_cutoff)
              & (saved == 1) & inst["u_valid"])
    w_hard = (accept[..., None]
              & (torch.arange(cfg.Wp, device=pos.device)
                 == (pos + cfg.WL)[..., None])).to(torch.float32)
    counts = fold_counts(w_hard, inst["ur"], prep["cvals"], cfg.W)
    counts = torch.where(gap_zone[..., None], counts, 0.0)

    gl = inst["gap_len"][:, None]
    end = pos + inst["u_len"]
    lrc0 = accept & (pos < 0) & (end > 0)
    lrc1 = accept & (pos < gl) & (end - gl > 0)
    return dict(counts=counts, accept=accept, pos=pos,
                left_right_check=torch.stack([lrc0.any(1), lrc1.any(1)], 1),
                umax_left=torch.where(lrc0, -pos, 0).max(dim=1).values,
                umax_right=torch.where(lrc1, end - gl, 0).max(dim=1).values,
                left_start_zero=(accept & (pos == 0)).any(1),
                right_fin_glen=(accept & (end == gl)).any(1),
                total=inst["u_valid"].sum(1), used=accept.sum(1))


def finalize_partial_instance(cfg: FillConfig, inst, model, best_string,
                              saved_l, saved_r) -> dict:
    """Finalize placement against the chosen string (batched): hard
    re-placement, acceptance, hard counts and quality-weighted counts."""
    check_supported(cfg)
    pr = inst["pr"]
    I, P, L = pr.shape
    gap_zone = _gap_zone(inst, cfg)
    gap_string = _best_gap_string(cfg, inst, best_string, gap_zone)
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
    gl = inst["gap_len"][:, None]
    end = pos + inst["p_len"]
    left = accept & (pos < 0)
    return dict(counts=counts, qual=qual, accept=accept, pos=pos,
                leftcount=left.sum(dim=1),
                rightcount=(accept & (pos >= 0)).sum(dim=1),
                spanning=(left & (end >= gl) & (-pos >= 3)
                          & (end - gl >= 3)).any(dim=1),
                total=inst["p_valid"].sum(dim=1), used=accept.sum(dim=1))


def finalize_batch(cfg: FillConfig, insts: dict, model: dict, best_strings,
                   saved, saved_l=None, saved_r=None) -> dict:
    """Finalize over the instance batch (leading axis of every ``insts``
    array): ``saved`` (I, R) is the unmapped mode's saved-read flags,
    ``saved_l``/``saved_r`` (I,) the partial mode's saved overlap pair."""
    if cfg.partial_mode:
        return finalize_partial_instance(cfg, insts, model, best_strings,
                                         saved_l, saved_r)
    return finalize_unmapped_instance(cfg, insts, model, best_strings, saved)


def finalize_batch_gathered(cfg, gap_arrays, gap_idx, gap_len, model,
                            best_strings, saved, saved_l, saved_r) -> dict:
    """:func:`finalize_batch` over gathered instances."""
    inst = _gather_inst(cfg, gap_arrays, gap_idx, gap_len)
    return finalize_batch(cfg, inst, model, best_strings, saved, saved_l,
                          saved_r)


# ---------------------------------------------------------------------------
# packed entry points: one f32 matrix per dispatch, one host copy each
# ---------------------------------------------------------------------------

SCAN_COLS = 9  # lik, valid, discont, ucoverf, umaxleftf, umaxrightf,
               # region_perct, bailed, prec


def fill_batch_scan(cfg, gap_arrays, gap_idx, gap_len, model,
                    finalize_flag: bool = True,
                    large_break: bool | None = None):
    """Scan instances -> packed (IB, SCAN_COLS) f32 replay scalars."""
    out = fill_batch_gathered(cfg, gap_arrays, gap_idx, gap_len, model,
                              finalize_flag, large_break)
    z = torch.zeros_like(out["likelihood"])
    cols = [out["likelihood"]] + [
        out[k].to(torch.float32) if k in out else z
        for k in ("valid", "discont", "ucoverf", "umaxleftf", "umaxrightf",
                  "region_perct", "bailed", "prec")]
    return torch.stack(cols, dim=1)


def fill_batch_full_packed(cfg, gap_arrays, gap_idx, gap_len, model,
                           finalize_flag: bool = True,
                           large_break: bool | None = None):
    """Winner/original-length re-run -> packed [consensus (maxG), accept
    (NR), pos (NR), saved_l, saved_r, region_perct, bailed, prec], NR = P
    (partial) or R (unmapped)."""
    out = fill_batch_gathered(cfg, gap_arrays, gap_idx, gap_len, model,
                              finalize_flag, large_break)
    z = torch.zeros_like(out["likelihood"])
    cols = [out[k].to(torch.float32) if k in out else z
            for k in ("saved_l", "saved_r", "region_perct", "bailed",
                      "prec")]
    return torch.cat([out["consensus"].to(torch.float32),
                      out["accept"].to(torch.float32),
                      out["pos"].to(torch.float32),
                      torch.stack(cols, dim=1)], dim=1)


def _layout(fields) -> dict:
    o, at = {}, 0
    for name, width in fields:
        o[name] = (at, at + width)
        at += width
    o["_total"] = at
    return o


def full_packed_layout(cfg: FillConfig) -> dict:
    """Column offsets of ``fill_batch_full_packed``'s output."""
    nr = cfg.P if cfg.partial_mode else cfg.R
    return _layout((("consensus", cfg.max_gap_len), ("accept", nr),
                    ("pos", nr), ("saved_l", 1), ("saved_r", 1),
                    ("region_perct", 1), ("bailed", 1), ("prec", 1)))


def finalize_batch_packed(cfg, gap_arrays, gap_idx, gap_len, model,
                          best_strings, saved, saved_l, saved_r):
    """Finalize pass -> packed [counts gap-zone (maxG*5), qual gap-zone
    (maxG*5, partial only), accept (NR), pos (NR), scalars]."""
    out = finalize_batch_gathered(cfg, gap_arrays, gap_idx, gap_len, model,
                                  best_strings, saved, saved_l, saved_r)
    ib = gap_idx.shape[0]
    zone = slice(cfg.WL, cfg.WL + cfg.max_gap_len)
    parts = [out["counts"][:, zone].reshape(ib, -1)]
    if cfg.partial_mode:
        parts.append(out["qual"][:, zone].reshape(ib, -1))
    parts += [out["accept"].to(torch.float32), out["pos"].to(torch.float32)]
    if not cfg.partial_mode:
        parts.append(out["left_right_check"].to(torch.float32))
        parts += [out[k].to(torch.float32)[:, None]
                  for k in ("umax_left", "umax_right", "left_start_zero",
                            "right_fin_glen")]
    parts.append(out["used"].to(torch.float32)[:, None])
    return torch.cat(parts, dim=1)


def finalize_packed_layout(cfg: FillConfig) -> dict:
    nr = cfg.P if cfg.partial_mode else cfg.R
    fields = [("counts", cfg.max_gap_len * 5)]
    if cfg.partial_mode:
        fields.append(("qual", cfg.max_gap_len * 5))
    fields += [("accept", nr), ("pos", nr)]
    if not cfg.partial_mode:
        fields += [("left_right_check", 2), ("umax_left", 1),
                   ("umax_right", 1), ("left_start_zero", 1),
                   ("right_fin_glen", 1)]
    return _layout(fields + [("used", 1)])
