"""K3, ``band_score_hard(codes, valid, gap_string, a, b, ln_et, Wp)``: the
hard pass's banded score from the gap string, (I, P, Wp) f32.

Bytes: the codes (int8), the mask (bool), the gap string (int8) and the
model's factors (f32) read once, the scores written once.  Operations: one
add per entry of the factor tensor K (I, R, 5L) the kernel builds, and one
per scored cell.
"""


def count(codes, valid, gap_string, a, b, ln_et, Wp):
    I, P, L = codes.shape
    R = gap_string.shape[1]
    n_bytes = codes.numel() + valid.numel() + gap_string.numel() \
        + (a.numel() + b.numel() + ln_et.numel()) * 4 + I * P * Wp * 4
    ops = (valid & (codes < 5)).sum() * Wp + I * R * L * 5
    return n_bytes, ops
