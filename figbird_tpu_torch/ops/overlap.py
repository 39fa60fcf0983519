"""The partial EM's overlap bonus (``detect_overlap_gapestimate``, batched).

``overlap_bonus`` runs the CUDA kernel ``csrc/overlap.cu`` on CUDA tensors
and ``overlap_bonus_plain`` on CPU tensors.  The plain version is the JAX
package's jnp code ``figbird_tpu/fill/em.py::_detect_overlap_partial``
written in PyTorch; on the card it is about 247 kernel launches a pass,
which the kernel makes one.  Both give the same bits.
"""

from __future__ import annotations

import torch

from . import LAUNCHES, LAUNCHES_BY_SHAPE, launch_device, require_cuda
from ._build import check, launcher, stream

_BIG = 1 << 20  # beyond every position and key of a window


def shift_left(x: torch.Tensor, off: torch.Tensor, fill) -> torch.Tensor:
    """out[..., j] = x[..., j + off] (``fill`` beyond the last column)."""
    L = x.shape[-1]
    xp = torch.cat([x, torch.full(x.shape[:-1] + (L + 1,), fill,
                                  dtype=x.dtype, device=x.device)], -1)
    idx = off.long()[..., None] + torch.arange(L, device=x.device)
    return xp.gather(-1, idx)


def _extract_rows(x, start, L: int):
    """x (I, N) rows padded with 5; returns x[i, start[i, r] + t] (I, R, L)."""
    I, N = x.shape
    xp = torch.cat([x, torch.full((I, L), 5, dtype=x.dtype,
                                  device=x.device)], 1)
    idx = start.long()[..., None] + torch.arange(L, device=x.device)
    return xp.gather(1, idx.reshape(I, -1)).reshape(idx.shape)


def overlap_bonus_plain(cfg, inst, accept, pos_gap):
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


# the instance fields the kernel reads, and their types there
_READS = (("pr", torch.int8), ("p_len", torch.int32),
          ("p_match", torch.int32), ("p_valid", torch.bool))
_SCALARS = ("gap_len", "side_limit", "perfect_gap", "orig_gap",
            "perfect_gaplen")


def overlap_bonus(cfg, inst, accept, pos_gap):
    """The overlap bonus of one partial EM pass: (bonus (I,) f32, saved_l
    (I,) int32, saved_r (I,) int32), as ``overlap_bonus_plain`` gives it.

    ``cfg``: the EM's ``FillConfig`` (``bonus_cap``, ``P``, ``WL``, ``W``);
    ``inst``: the instance batch (``pr`` (I, P, L) codes; ``p_len``,
    ``p_match``, ``p_valid`` (I, P); ``tmpl`` (I, W); ``gap_len``,
    ``side_limit``, ``perfect_gap``, ``orig_gap``, ``perfect_gaplen``
    (I,)); ``accept`` (I, P) bool; ``pos_gap`` (I, P) placements in gap
    coordinates."""
    pr = inst["pr"]
    dev = launch_device("overlap_bonus", accept, pos_gap, inst["tmpl"],
                        *(inst[k] for k, _ in _READS),
                        *(inst[k] for k in _SCALARS))
    if dev.type == "cpu":
        return overlap_bonus_plain(cfg, inst, accept, pos_gap)
    require_cuda(pr, "overlap_bonus")
    if pr.dim() != 3:
        raise ValueError("overlap_bonus: pr must be (I, P, L)")
    I, P, L = pr.shape
    cap = min(cfg.bonus_cap, cfg.P)
    reads = [inst[k].to(t).contiguous() for k, t in _READS]
    reads += [accept.to(torch.bool).contiguous(),
              pos_gap.to(torch.int32).contiguous()]
    tmpl = inst["tmpl"].to(torch.int8).contiguous()
    scalars = [inst[k].to(torch.int32).contiguous() for k in _SCALARS]
    if any(x.shape != (I, P) for x in reads[1:]) \
            or tmpl.shape != (I, cfg.W) \
            or any(x.shape != (I,) for x in scalars) or cap < 1:
        raise ValueError("overlap_bonus: p_len, p_match, p_valid, accept and "
                         "pos_gap must be (I, P), tmpl (I, W), the gap "
                         "scalars (I,), and bonus_cap at least 1")
    with torch.cuda.device(dev):
        bonus = torch.empty(I, dtype=torch.float32, device=dev)
        saved_l = torch.empty(I, dtype=torch.int32, device=dev)
        saved_r = torch.empty(I, dtype=torch.int32, device=dev)
        err = launcher("overlap")(
            *(x.data_ptr() for x in reads), tmpl.data_ptr(),
            *(x.data_ptr() for x in scalars), bonus.data_ptr(),
            saved_l.data_ptr(), saved_r.data_ptr(), I, P, L, cfg.W, cfg.WL,
            cap, stream(dev))
    check(err, "overlap_bonus")
    LAUNCHES["overlap"] += 1
    LAUNCHES_BY_SHAPE["overlap", P, cap] += 1
    return bonus, saved_l, saved_r
