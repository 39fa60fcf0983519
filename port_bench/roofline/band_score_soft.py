"""K2, ``band_score_soft(codes, valid, A, B, e_pos, Wp)``: the soft pass's
banded score, (I, P, Wp) f32.

Bytes: the codes (int8), the mask (bool), both probability slabs (I, R, 5)
f32 and the per-cycle factors read once, the scores written once.
Operations: one log factor (four operations) per slab row, read cycle and
channel, and one add per scored cell (a valid base at each of Wp
placements).
"""


def count(codes, valid, A, B, e_pos, Wp):
    I, P, L = codes.shape
    R = A.shape[1]
    n_bytes = codes.numel() + valid.numel() + (A.numel() + B.numel()
                                               + e_pos.numel()) * 4 \
        + I * P * Wp * 4
    ops = (valid & (codes < 5)).sum() * Wp + 4 * I * R * L * 5
    return n_bytes, ops
