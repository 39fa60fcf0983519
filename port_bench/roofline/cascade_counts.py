"""K1, ``cascade_counts(lw, codes, vals, W, m, shift, cut)``: the first m
levels of the soft-count cascade, (I, m, W, 5) f32.

Bytes: the log-weights (f32), the codes (int8) and the count values (f32)
read once, the counts written once.  Operations: what these inputs need:
each level's non-zero weights (``exp(lw + k * shift)`` where that is at
most ``cut``, so the cut at 78 is counted) meet every counted base of their
read, a multiply and an add each, and one exponential a weight and level.
"""

import torch


def count(lw, codes, vals, W, m, shift, cut):
    I, P, Pw = lw.shape
    n_bytes = I * P * Pw * 4 + codes.numel() + vals.numel() * 4 \
        + I * m * W * 5 * 4
    lw = lw.to(torch.float32)
    n_val = (vals != 0).sum(-1)
    ops = 0
    for k in range(m):
        lk = lw + k * shift
        w = torch.where(lk <= cut, torch.exp(torch.clamp(lk, -745.0, cut)),
                        0.0)
        nz = (w != 0).sum(-1)
        ops = ops + 2 * (nz * n_val).sum() + nz.sum()
    return n_bytes, ops
