"""K1-K4: the banded scoring and count kernels of the partial EM.

Each wrapper takes the instance-batched tensors the EM holds (the JAX
package ``vmap``s over instances; here the instance axis I leads):

* ``band_score_soft`` (K2, ``csrc/band_soft.cu``) — the fused soft-pass
  score from the (R, 5) probability slabs; replaces
  ``figbird_tpu/ops/band.py::_band_soft_kernel``.  Plain version: the
  ``_soft_K`` factor tensor + ``band_score_reference`` skew matmul.
* ``band_score`` (K3, ``csrc/band_hard.cu``) — the banded score from a
  precomputed log-factor tensor K; replaces ``_band_kernel``.  Plain
  version: ``band_score_reference``.
* ``band_score_hard`` (K3's second entry point, the one the EM calls) —
  the same score with K's entries built inside the kernel from the gap
  string (``hard_K``), so K never reaches device memory; bit-equal to
  ``band_score`` on ``hard_K``'s output.  Plain version: ``hard_K`` +
  ``band_score_plain``.
* ``fold_counts`` (K4, ``csrc/fold.cu``) — weights x count one-hot with
  the diagonal fold; replaces ``_fold_kernel``.  Plain version: the
  c-major one-hot matmul + ``_fold_counts_T`` skew fold of
  ``figbird_tpu/fill/em.py:528-531``.

* ``cascade_counts`` (K1, ``csrc/cascade.cu``) — the first m levels of the
  double-range soft-count cascade: level weights from masked log-weights,
  count product and diagonal fold in one pass; replaces ``_cascade_kernel``.
  Plain version: ``level_weight`` per level, levels stacked
  ``CASCADE_GROUP`` to one batched matmul against the c-major count one-hot,
  ``fold_T`` per level (the XLA branch of ``em.py::_accumulate_levels``).

K4 and K1 are two thin kernels over one device function,
``csrc/count_core.cuh``: the count product and the diagonal fold in f32.
K2 and K3 are thin kernels over another, ``csrc/band_core.cuh``: the banded
gather-sum of log factors staged in shared memory.

The kernels take the reads as codes plus a per-base mask (K2, K3) or a
per-base count value (K1, K4) and build no one-hot; the plain versions build
the one-hots the JAX package's CPU path uses.
"""

from __future__ import annotations

import torch

from . import LAUNCHES, LAUNCHES_BY_SHAPE, launch_device, require_cuda
from ._build import check, launcher, stream


def oh_flat_j(codes: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Flat j-major one-hot (..., L*5): column j*5+c == (code[j] == c)."""
    c = torch.arange(5, dtype=codes.dtype, device=codes.device)
    oh = (codes[..., None] == c) & valid[..., None]
    return oh.reshape(codes.shape[:-1] + (-1,)).to(torch.float32)


def oh_flat_c(codes: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Flat c-major count one-hot (..., 5*L): column c*L+j ==
    (code[j] == c) * vals[j]."""
    c = torch.arange(5, dtype=codes.dtype, device=codes.device)
    oh = (codes[..., None, :] == c[:, None]).to(torch.float32) \
        * vals[..., None, :]
    return oh.reshape(codes.shape[:-1] + (-1,))


def soft_K(probs: torch.Tensor, eprobs: torch.Tensor,
           e_pos: torch.Tensor) -> torch.Tensor:
    """Soft-pass log factors, flat j-major (..., R, L*5): column j*5+c =
    log(max(A[w,c](1-e_j) + e_j B[w,c], 1e-30)) (em.py ``_soft_K``)."""
    L = e_pos.shape[0]
    shape = probs.shape[:-1] + (L, 5)
    A5 = probs[..., None, :].expand(shape).reshape(probs.shape[:-1] + (-1,))
    B5 = eprobs[..., None, :].expand(shape).reshape(probs.shape[:-1] + (-1,))
    e5 = e_pos.repeat_interleave(5)
    F = A5 * (1.0 - e5) + e5 * B5
    return torch.log(torch.clamp_min(F, 1e-30))


def hard_K(gap_string: torch.Tensor, e_match, e_mis, ln_et) -> torch.Tensor:
    """Log factors vs a fixed consensus, flat j-major (I, R, L*5):
    column j*5+c = a_j if c == g[w] else b_j + lnET[g[w], c]; 0 where the
    window runs outside the contig (g >= 5)."""
    L = e_match.shape[0]
    gs = torch.clamp_max(gap_string, 4).long()                  # (I, R)
    shape = gs.shape + (L, 5)
    lnrow5 = ln_et.to(torch.float32)[gs][..., None, :].expand(shape)
    c = torch.arange(5, device=gs.device)
    ismatch5 = (gs[..., None] == c)[..., None, :].expand(shape)
    a5 = e_match[:, None].expand(L, 5)
    b5 = e_mis[:, None].expand(L, 5)
    K = torch.where(ismatch5, a5, b5 + lnrow5).reshape(gs.shape + (-1,))
    return torch.where((gap_string >= 5)[..., None], 0.0, K)


def band_score_plain(codes: torch.Tensor, valid: torch.Tensor,
                     K: torch.Tensor, Wp: int) -> torch.Tensor:
    """score[i, r, p] = sum_j K[i, p+j, 5j + codes[i, r, j]] over valid j:
    the skew-materialised banded Kw and one batched matmul
    (``band_score_reference``).  codes/valid (I, P, L), K (I, R, 5L)."""
    return band_score_onehot(oh_flat_j(codes, valid), K, Wp)


def band_score_onehot(oh: torch.Tensor, K: torch.Tensor,
                      Wp: int) -> torch.Tensor:
    """``band_score_plain`` from the reads' flat j-major one-hot (I, P, 5L)."""
    I, R, LC = K.shape
    L = LC // 5
    Kt = K.reshape(I, R, L, 5).transpose(1, 2).reshape(I, L * R, 5)
    pad = torch.zeros((I, L, 5), dtype=K.dtype, device=K.device)
    skew = torch.cat([Kt, pad], dim=1)[:, : L * (R + 1)].reshape(
        I, L, R + 1, 5)
    Kw = skew[:, :, :Wp].transpose(1, 2).reshape(I, Wp, LC)
    return torch.bmm(oh, Kw.transpose(1, 2))


def band_score_soft_plain(codes, valid, A, B, e_pos, Wp: int):
    return band_score_plain(codes, valid, soft_K(A, B, e_pos), Wp)


def band_score_hard_plain(codes, valid, gap_string, a, b, ln_et, Wp: int):
    return band_score_plain(codes, valid, hard_K(gap_string, a, b, ln_et), Wp)


def fold_T(cwT: torch.Tensor, L: int, W: int) -> torch.Tensor:
    """(I, 5L, Pw) transposed c-major counts -> (I, W, 5) with
    counts[p+j, c] += cwT[c*L+j, p] (em.py ``_fold_counts_T``)."""
    I, _, Pw = cwT.shape
    ct = cwT.reshape(I, 5, L, Pw)
    RL = Pw + L + 1
    z = torch.zeros((I, 5, L, L + 1), dtype=cwT.dtype, device=cwT.device)
    Ap = torch.cat([ct, z], dim=3).reshape(I, 5, L * RL)
    skew = Ap[:, :, : L * (RL - 1)].reshape(I, 5, L, RL - 1)
    return skew[..., :W].sum(dim=2).transpose(1, 2)


def fold_counts_plain(weights: torch.Tensor, codes: torch.Tensor,
                      vals: torch.Tensor, W: int) -> torch.Tensor:
    L = codes.shape[-1]
    cwT = torch.bmm(oh_flat_c(codes, vals).transpose(1, 2), weights)
    return fold_T(cwT, L, W)


CASCADE_GROUP = 3   # levels stacked per matmul in the plain cascade
MASKED = -1e30      # log-weight of an illegal placement: 0 at every level


def level_weight(lw: torch.Tensor, k: int, shift: float,
                 cut: float) -> torch.Tensor:
    """Level k's weights from masked natural-log weights: exp(lw + k*shift)
    where that exponent is <= cut, else 0 (overflow zeroing); the exponent
    is clamped at -745, so ``MASKED`` entries give exactly 0."""
    lk = lw + k * shift
    return torch.where(lk <= cut, torch.exp(torch.clamp(lk, -745.0, cut)),
                       0.0)


def cascade_counts_plain(lw: torch.Tensor, codes: torch.Tensor,
                         vals: torch.Tensor, W: int, m: int, shift: float,
                         cut: float) -> torch.Tensor:
    I, P, Pw = lw.shape
    L = codes.shape[-1]
    ohT = oh_flat_c(codes, vals).transpose(1, 2)
    outs = []
    for g0 in range(0, m, CASCADE_GROUP):
        ks = range(g0, min(g0 + CASCADE_GROUP, m))
        wk = torch.cat([level_weight(lw, k, shift, cut) for k in ks], dim=2)
        cwT = torch.bmm(ohT, wk)                    # (I, 5L, len(ks) * Pw)
        outs += [fold_T(cwT[:, :, i * Pw : (i + 1) * Pw], L, W)
                 for i in range(len(ks))]
    return torch.stack(outs, dim=1)


def _check_rows(codes, valid, what):
    if codes.dtype != torch.int8 or valid.dtype != torch.bool:
        raise TypeError(f"{what}: codes int8 and valid bool expected")
    if codes.shape != valid.shape or codes.dim() != 3:
        raise ValueError(f"{what}: codes/valid must both be (I, P, L)")


def band_score_soft(codes: torch.Tensor, valid: torch.Tensor,
                    A: torch.Tensor, B: torch.Tensor, e_pos: torch.Tensor,
                    Wp: int) -> torch.Tensor:
    """Soft-pass score (I, P, Wp): sum over valid j of
    log(max(A[p+j, c](1 - e_j) + e_j B[p+j, c], 1e-30)), c = read base j.
    codes/valid (I, P, L); A, B (I, R, 5) f32 with R >= Wp + L - 1."""
    dev = launch_device("band_score_soft", codes, valid, A, B, e_pos)
    if dev.type == "cpu":
        return band_score_soft_plain(codes, valid, A, B, e_pos, Wp)
    require_cuda(codes, "band_score_soft")
    _check_rows(codes, valid, "band_score_soft")
    I, P, L = codes.shape
    R = A.shape[1]
    if A.shape != (I, R, 5) or B.shape != A.shape or R < Wp + L - 1 \
            or e_pos.shape != (L,):
        raise ValueError("band_score_soft: A/B must be (I, R>=Wp+L-1, 5) "
                         "and e_pos (L,)")
    codes, valid = codes.contiguous(), valid.contiguous()
    A = A.to(torch.float32).contiguous()
    B = B.to(torch.float32).contiguous()
    e_pos = e_pos.to(torch.float32).contiguous()
    with torch.cuda.device(dev):
        out = torch.empty((I, P, Wp), dtype=torch.float32, device=dev)
        err = launcher("band_soft")(
            codes.data_ptr(), valid.data_ptr(), A.data_ptr(), B.data_ptr(),
            e_pos.data_ptr(), out.data_ptr(), I, P, L, R, Wp, stream(dev))
    check(err, "band_score_soft")
    LAUNCHES["band_soft"] += 1
    LAUNCHES_BY_SHAPE["band_soft", P, Wp] += 1
    return out


def band_score(codes: torch.Tensor, valid: torch.Tensor, K: torch.Tensor,
               Wp: int) -> torch.Tensor:
    """Banded score (I, P, Wp) from K (I, R, 5L), R >= Wp + L - 1."""
    dev = launch_device("band_score", codes, valid, K)
    if dev.type == "cpu":
        return band_score_plain(codes, valid, K, Wp)
    require_cuda(codes, "band_score")
    _check_rows(codes, valid, "band_score")
    I, P, L = codes.shape
    R = K.shape[1]
    if K.shape != (I, R, 5 * L) or R < Wp + L - 1:
        raise ValueError("band_score: K must be (I, R>=Wp+L-1, 5L)")
    codes, valid = codes.contiguous(), valid.contiguous()
    K = K.to(torch.float32).contiguous()
    with torch.cuda.device(dev):
        out = torch.empty((I, P, Wp), dtype=torch.float32, device=dev)
        err = launcher("band_hard")(
            codes.data_ptr(), valid.data_ptr(), K.data_ptr(), out.data_ptr(),
            I, P, L, R, Wp, stream(dev))
    check(err, "band_score")
    LAUNCHES["band_hard"] += 1
    LAUNCHES_BY_SHAPE["band_hard", P, Wp] += 1
    return out


def band_score_hard(codes: torch.Tensor, valid: torch.Tensor,
                    gap_string: torch.Tensor, a: torch.Tensor,
                    b: torch.Tensor, ln_et: torch.Tensor,
                    Wp: int) -> torch.Tensor:
    """Hard-pass score (I, P, Wp): ``band_score`` on ``hard_K(gap_string, a,
    b, ln_et)``, K's entries built inside the kernel.  gap_string (I, R)
    int8 codes 0..5 with R >= Wp + L - 1; a, b (L,); ln_et (5, 5)."""
    dev = launch_device("band_score_hard", codes, valid, gap_string, a, b,
                        ln_et)
    if dev.type == "cpu":
        return band_score_hard_plain(codes, valid, gap_string, a, b, ln_et,
                                     Wp)
    require_cuda(codes, "band_score_hard")
    _check_rows(codes, valid, "band_score_hard")
    I, P, L = codes.shape
    R = gap_string.shape[1]
    if gap_string.dtype != torch.int8 or gap_string.shape != (I, R) \
            or R < Wp + L - 1 or a.shape != (L,) or b.shape != (L,) \
            or ln_et.shape != (5, 5):
        raise ValueError("band_score_hard: gap_string int8 (I, R>=Wp+L-1), "
                         "a and b (L,), ln_et (5, 5)")
    codes, valid = codes.contiguous(), valid.contiguous()
    gap_string = gap_string.contiguous()
    a, b, ln_et = (x.to(torch.float32).contiguous() for x in (a, b, ln_et))
    with torch.cuda.device(dev):
        out = torch.empty((I, P, Wp), dtype=torch.float32, device=dev)
        err = launcher("band_hard_gap")(
            codes.data_ptr(), valid.data_ptr(), gap_string.data_ptr(),
            a.data_ptr(), b.data_ptr(), ln_et.data_ptr(), out.data_ptr(), I,
            P, L, R, Wp, stream(dev))
    check(err, "band_score_hard")
    LAUNCHES["band_hard"] += 1
    LAUNCHES_BY_SHAPE["band_hard", P, Wp] += 1
    return out


def fold_counts(weights: torch.Tensor, codes: torch.Tensor,
                vals: torch.Tensor, W: int) -> torch.Tensor:
    """counts (I, W, 5): counts[w, c] = sum_r sum_j weights[r, w-j] *
    vals[r, j] * (codes[r, j] == c).  weights (I, P, Pw); codes (I, P, L)
    int8; vals (I, P, L) f32; Pw + L - 1 <= W <= Pw + L."""
    I, P, Pw = weights.shape
    L = codes.shape[-1]
    if codes.dtype != torch.int8 or codes.shape != (I, P, L) \
            or vals.shape != codes.shape or not Pw + L - 1 <= W <= Pw + L:
        raise ValueError("fold_counts: codes int8 (I, P, L), vals like "
                         "codes, Pw + L - 1 <= W <= Pw + L")
    dev = launch_device("fold_counts", weights, codes, vals)
    if dev.type == "cpu":
        return fold_counts_plain(weights, codes, vals, W)
    require_cuda(weights, "fold_counts")
    weights = weights.to(torch.float32).contiguous()
    codes = codes.contiguous()
    vals = vals.to(torch.float32).contiguous()
    with torch.cuda.device(dev):
        out = torch.empty((I, W, 5), dtype=torch.float32, device=dev)
        err = launcher("fold")(
            weights.data_ptr(), codes.data_ptr(), vals.data_ptr(),
            out.data_ptr(), I, P, L, Pw, W, stream(dev))
    check(err, "fold_counts")
    LAUNCHES["fold"] += 1
    LAUNCHES_BY_SHAPE["fold", P, Pw] += 1
    return out


def cascade_counts(lw: torch.Tensor, codes: torch.Tensor, vals: torch.Tensor,
                   W: int, m: int, shift: float, cut: float) -> torch.Tensor:
    """First ``m`` cascade levels' folded counts (I, m, W, 5):
    counts[k, w, c] = sum_r sum_j level_weight(lw, k)[r, w-j] * vals[r, j] *
    (codes[r, j] == c).  lw (I, P, Pw) natural-log weights with illegal
    entries at ``MASKED``; codes (I, P, L) int8; vals (I, P, L) f32;
    Pw + L - 1 <= W <= Pw + L; 1 <= m <= 6."""
    I, P, Pw = lw.shape
    L = codes.shape[-1]
    if codes.dtype != torch.int8 or codes.shape != (I, P, L) \
            or vals.shape != codes.shape or not Pw + L - 1 <= W <= Pw + L \
            or not 1 <= m <= 6:
        raise ValueError("cascade_counts: codes int8 (I, P, L), vals like "
                         "codes, Pw + L - 1 <= W <= Pw + L, 1 <= m <= 6")
    dev = launch_device("cascade_counts", lw, codes, vals)
    if dev.type == "cpu":
        return cascade_counts_plain(lw, codes, vals, W, m, shift, cut)
    require_cuda(lw, "cascade_counts")
    lw = lw.to(torch.float32).contiguous()
    codes = codes.contiguous()
    vals = vals.to(torch.float32).contiguous()
    with torch.cuda.device(dev):
        out = torch.empty((I, m, W, 5), dtype=torch.float32, device=dev)
        err = launcher("cascade")(
            lw.data_ptr(), codes.data_ptr(), vals.data_ptr(), out.data_ptr(),
            I, P, L, Pw, W, m, shift, cut, stream(dev))
    check(err, "cascade_counts")
    LAUNCHES["cascade"] += 1
    LAUNCHES_BY_SHAPE["cascade", P, Pw] += 1
    return out
