"""K1-K4 of the partial EM as plain PyTorch: a frozen copy of the plain versions
of ``figbird_tpu_torch/ops/band.py``.  The entry points keep the port's
names and arguments and run the plain version on every device; no CUDA
kernel is built or launched.
"""

from __future__ import annotations

import torch



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


def band_score_soft(codes, valid, A, B, e_pos, Wp: int) -> torch.Tensor:
    return band_score_soft_plain(codes, valid, A, B, e_pos, Wp)


def band_score(codes, valid, K, Wp: int) -> torch.Tensor:
    return band_score_plain(codes, valid, K, Wp)


def band_score_hard(codes, valid, gap_string, a, b, ln_et,
                    Wp: int) -> torch.Tensor:
    return band_score_hard_plain(codes, valid, gap_string, a, b, ln_et, Wp)


def fold_counts(weights, codes, vals, W: int) -> torch.Tensor:
    return fold_counts_plain(weights, codes, vals, W)


def cascade_counts(lw, codes, vals, W: int, m: int, shift: float,
                   cut: float) -> torch.Tensor:
    return cascade_counts_plain(lw, codes, vals, W, m, shift, cut)
