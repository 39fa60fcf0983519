"""K5: candidate scoring of the aligner's extend step.

CUDA kernel ``csrc/align_score.cu`` (replaces the Pallas kernel
``figbird_tpu/ops/align_score.py::_kernel``) beside its plain PyTorch
version, which mirrors the XLA path ``figbird_tpu.align.core.
_score_candidates``.  Both are integer-exact and bit-equal.
"""

from __future__ import annotations

from collections import Counter

import torch

from . import LAUNCHES, launch_device, require_cuda
from ._build import check, launcher, stream

_KEYS = ("local", "e2e", "start", "end", "n_mis")
# the kernel's launches by candidates per read (the aligner's cheap pass
# sends C = 8, its full pass C = 32), beside LAUNCHES["align_score"]
LAUNCHES_BY_C: Counter = Counter()


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


def score_candidates(flat: torch.Tensor, reads: torch.Tensor,
                     cand: torch.Tensor, match: int, mismatch: int,
                     gap_code: int) -> dict:
    """Candidate scoring: the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors (same signature and outputs).  Every window
    ``flat[cand : cand + L]`` must lie inside ``flat`` (the aligner clamps
    ``cand`` to ``[0, len(genome) - L - 1]`` of a padded genome); the kernel
    reads no byte of ``flat`` outside it."""
    dev = launch_device("score_candidates", flat, reads, cand)
    if dev.type == "cpu":
        return score_candidates_plain(flat, reads, cand, match, mismatch,
                                      gap_code)
    require_cuda(flat, "score_candidates")
    if flat.dtype != torch.int8 or reads.dtype != torch.int8 \
            or cand.dtype != torch.int32:
        raise TypeError("score_candidates: flat/reads int8, cand int32")
    if flat.dim() != 1 or reads.dim() != 2 or cand.dim() != 2 \
            or cand.shape[0] != reads.shape[0]:
        raise ValueError("score_candidates: flat (G,), reads (B, L), "
                         "cand (B, C)")
    B, L = reads.shape
    C = cand.shape[1]
    with torch.cuda.device(dev):
        flat = flat.contiguous()
        if flat.data_ptr() % 4:            # the kernel loads 4-byte words
            flat = flat.clone()
        reads = reads.contiguous()
        cand = cand.contiguous()
        # five planes, so each output is a contiguous (B, C) view
        out = torch.empty((5, B * C), dtype=torch.int32, device=dev)
        if B * C:
            err = launcher("align_score")(
                flat.data_ptr(), reads.data_ptr(), cand.data_ptr(),
                out.data_ptr(), B * C, flat.numel(), C, L, match, mismatch,
                gap_code, stream(dev))
            check(err, "score_candidates")
            LAUNCHES["align_score"] += 1
            LAUNCHES_BY_C[C] += 1
    return {k: out[i].view(B, C) for i, k in enumerate(_KEYS)}
