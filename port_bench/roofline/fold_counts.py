"""K4, ``fold_counts(weights, codes, vals, W)``: weights times the count
one-hot with the diagonal fold, (I, W, 5) f32.

Bytes: the weights (f32), the codes (int8) and the count values (f32) read
once, the counts written once.  Operations: each non-zero weight meets
every counted base of its read, a multiply and an add.
"""


def count(weights, codes, vals, W):
    I, P, Pw = weights.shape
    n_bytes = weights.numel() * 4 + codes.numel() + vals.numel() * 4 \
        + I * W * 5 * 4
    ops = 2 * ((weights != 0).sum(-1) * (vals != 0).sum(-1)).sum()
    return n_bytes, ops
