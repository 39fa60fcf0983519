"""K5 as plain PyTorch: a frozen copy of the plain version of
``figbird_tpu_torch/ops/align_score.py``, run on every device."""

from __future__ import annotations

import torch


_KEYS = ("local", "e2e", "start", "end", "n_mis")


def score_candidates_plain(flat: torch.Tensor, reads: torch.Tensor,
                           cand: torch.Tensor, match: int, mismatch: int,
                           gap_code: int) -> dict:
    """flat (G,) int8 padded genome; reads (B, L) int8; cand (B, C) int32
    window starts.  Returns dict(local, e2e, start, end, n_mis), each (B, C)
    int32."""
    B, L = reads.shape
    ar = torch.arange(L, device=reads.device)
    windows = flat[cand.long()[..., None] + ar]                # (B, C, L)
    rv = (reads != gap_code)[:, None, :]
    m = (windows == reads[:, None, :]) & rv & (windows != gap_code)
    s = torch.where(rv, torch.where(m, match, mismatch), 0).to(torch.int32)
    p = torch.cumsum(s, dim=-1, dtype=torch.int32)
    zero = torch.zeros(p.shape[:-1] + (1,), dtype=torch.int32,
                       device=p.device)
    pre = torch.cat([zero, p], dim=-1)
    runmin = torch.cummin(pre, dim=-1).values
    bev = p - runmin[..., :-1]                 # best interval ending at j
    local = bev.max(dim=-1).values
    end = bev.argmax(dim=-1)                   # first max
    ar1 = torch.arange(L + 1, device=reads.device)
    start = torch.where(ar1 <= end[..., None], pre, 2**30).argmin(dim=-1)
    mism = (rv & ~m).to(torch.int32)
    cm0 = torch.cat([zero, torch.cumsum(mism, dim=-1, dtype=torch.int32)],
                    dim=-1)
    n_mis = (cm0.gather(-1, (end + 1)[..., None])
             - cm0.gather(-1, start[..., None]))[..., 0]
    return dict(local=local, e2e=p[..., -1], start=start.to(torch.int32),
                end=end.to(torch.int32), n_mis=n_mis)


def score_candidates(flat, reads, cand, match: int, mismatch: int,
                     gap_code: int) -> dict:
    return score_candidates_plain(flat, reads, cand, match, mismatch,
                                  gap_code)
