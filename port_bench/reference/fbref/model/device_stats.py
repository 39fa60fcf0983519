"""Device model sufficient statistics + per-alignment error scoring
(``figbird_tpu/model/device_stats.py``).

Two passes over the aligner's resident read batches: ``stats_batch``
(processErrorTypes substitution statistics) and ``err_log10_batch``
(computeErrorProb for gapless alignments).  Indel-tier rows are masked out
by the caller and accounted for on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ..dtypes import GAP_CODE
from ..align.core import (extract_span, revcomp_batch, shift_left_batch,
                          to_cycle_batch)


def _aligned_view(flat, seq, lengths, win_pos, strand):
    B, L = seq.shape
    rc = revcomp_batch(seq, lengths)
    oriented = torch.where((strand == 1)[:, None], rc, seq)
    win = extract_span(flat, win_pos, L)
    jmask = torch.arange(L, device=seq.device)[None, :] < lengths[:, None]
    rv = (oriented != GAP_CODE) & jmask
    m = (win == oriented) & (win != GAP_CODE)
    return oriented, win, jmask, rv & ~m


def _region(lengths, clip_s, clip_e, L):
    j = torch.arange(L, device=lengths.device)[None, :]
    return (j >= clip_s[:, None]) & (j < (lengths - clip_e)[:, None])


def stats_batch(flat, seq, lengths, win_pos, strand, mask, clip_s, clip_e):
    """Sufficient statistics over one batch (masked rows only), packed as
    one f32 vector [error_pos (L), error_types (25), base_counts (5), n]."""
    B, L = seq.shape
    oriented, win, jmask, mism = _aligned_view(flat, seq, lengths, win_pos,
                                               strand)
    mism = mism & _region(lengths, clip_s, clip_e, L)
    mk = mask[:, None]
    mism8 = (mism & mk).to(torch.int8)
    mism_cyc = torch.where((strand == 1)[:, None],
                           to_cycle_batch(mism8, lengths, 0), mism8)
    error_pos = mism_cyc.to(torch.int64).sum(dim=0)
    mm = (mism & mk).reshape(-1)
    frm = torch.clamp(win, 0, 4).long().reshape(-1)
    to = torch.clamp(oriented, 0, 4).long().reshape(-1)
    error_types = torch.bincount((frm * 5 + to)[mm], minlength=25)
    base_counts = torch.bincount(to[(jmask & mk).reshape(-1)], minlength=5)
    return torch.cat([error_pos, error_types, base_counts,
                      mask.sum().reshape(1)]).to(torch.float32)


def unpack_stats(vec, L: int) -> dict:
    vec = np.asarray(vec)
    return dict(
        error_pos=vec[:L].astype(np.int64),
        error_types=vec[L : L + 25].reshape(5, 5).astype(np.int64),
        base_counts=vec[L + 25 : L + 30].astype(np.int64),
        n=int(vec[L + 30]))


def err_log10_batch(flat, seq, lengths, win_pos, strand, mask, clip_s,
                    clip_e, t_cyc, lbe, let, noerr_log10):
    """log10 computeErrorProb per read (gapless alignments); rows outside
    ``mask`` return 0.  Clipped reads keep computeErrorProb's clip quirk: a
    mismatch at read position j is charged at cycle j - clip_start with the
    'to' char read[j - clip_start] (see the reference docstring)."""
    B, L = seq.shape
    oriented, win, jmask, mism = _aligned_view(flat, seq, lengths, win_pos,
                                               strand)
    mism = mism & _region(lengths, clip_s, clip_e, L)
    mm8 = shift_left_batch(mism.to(torch.int8), clip_s, 0)
    mism_cyc = torch.where((strand == 1)[:, None],
                           to_cycle_batch(mm8, lengths, 0), mm8)
    cyc_term = (mism_cyc.to(torch.float32) * t_cyc[None, :]).sum(dim=1)
    to_sh = shift_left_batch(oriented.flip(1), clip_s, GAP_CODE).flip(1)
    wi = torch.clamp(win, 0, 4).long()
    sub = lbe[wi] + let[wi, torch.clamp(to_sh, 0, 4).long()]
    sub_term = torch.where(mism & (win != to_sh), sub, 0.0).sum(dim=1)
    base = noerr_log10[torch.clamp(lengths - 1, 0,
                                   noerr_log10.shape[0] - 1).long()]
    return torch.where(mask, base + cyc_term + sub_term, 0.0)


def model_log10_arrays(model):
    """Host constant arrays for err_log10_batch, from an ErrorModel."""
    denom = 1.0 - model.error_pos_dist - model.in_pos_dist - model.del_pos_dist
    t_cyc = (np.log10(np.maximum(model.error_pos_dist, 1e-300))
             - np.log10(np.maximum(denom, 1e-300)))
    lbe = np.log10(np.maximum(model.base_error_rates, 1e-300))
    let = np.log10(np.maximum(model.error_type_probs, 1e-300))
    noe = np.log10(np.maximum(model.no_error_probs, 1e-300))
    return tuple(np.asarray(a, np.float32) for a in (t_cyc, lbe, let, noe))
