"""The plain reference, written from Figbird's definitions as direct NumPy
loops: it imports nothing but NumPy and shares no code with the port.

Each function works out one step of the timed path again from that step's
inputs, in float64 (integers where the step is integer):

- ``soft_scores``: the EM's soft score of each read at each band offset,
  the sum over the read's valid bases j of
  ``log(max(A[p+j, c] (1 - e_j) + e_j B[p+j, c], 1e-30))``, c the base;
- ``hard_scores``: the score against a fixed consensus g: per base
  ``a_j`` where c matches ``g[p+j]``, else ``b_j + lnET[g[p+j], c]``, and 0
  where the window runs off the contig (g >= 5);
- ``fold_counts``: the counts ``counts[p+j, c] += w[r, p] vals[r, j]``
  over reads r whose base j is c;
- ``cascade_counts``: the same for each level k of the double-range
  cascade, with weights ``exp(lw + k shift)`` where that exponent is at
  most ``cut`` (else 0);
- ``score_candidates``: a read against each candidate window of the
  genome: +match where the bases agree, -mismatch where they do not,
  nothing where the read has a gap code; the best local interval (its
  score, first end, first start), the whole read's score and the
  mismatches inside the interval;
- ``consensus``: the gap zone's base with the most count (the first on a
  tie), N where nothing was counted or, with ``check``, where the most is
  at or under ``cov_thresh``;
- ``splice``: each N-run of a draft contig (a run at the contig's very end
  is not a gap) replaced by its fill, ``skip`` more bases dropped after it;
- ``substitutions``: a read's bases that differ from the truth where the
  simulation drew it;
- ``placed_off_truth``: reads placed elsewhere than where the simulation
  drew them from.

With ``tf32=True`` the scores and counts are computed as a TF32 matmul
computes them (each factor rounded to 10 mantissa bits, float32 sums): the
control, the next precision below the float32 that the port states.
"""

from __future__ import annotations

import numpy as np

N_CODE = 4


def tf32(x: np.ndarray) -> np.ndarray:
    """``x`` as float32 rounded to TF32's 10 mantissa bits (to nearest)."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    r = (u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)
    return np.where(np.isfinite(x), r.view(np.float32), x).astype(np.float32)


def _acc(tf: bool):
    return np.float32 if tf else np.float64


def soft_scores(codes, valid, A, B, e_pos, Wp: int, tf: bool = False):
    """(P, Wp) soft scores of one instance: codes/valid (P, L), A/B (R, 5),
    e_pos (L,)."""
    P, L = codes.shape
    dt = _acc(tf)
    out = np.zeros((P, Wp), dt)
    A = np.asarray(A, np.float64)
    B = np.asarray(B, np.float64)
    rows = np.arange(P)
    for j in range(L):
        e = float(np.float32(e_pos[j]))
        f = A[j : j + Wp] * (1.0 - e) + e * B[j : j + Wp]      # (Wp, 5)
        logf = np.log(np.maximum(f, 1e-30))
        if tf:
            logf = tf32(logf)
        c = np.clip(codes[:, j], 0, 4)
        term = logf[:, c].T.astype(dt)                          # (P, Wp)
        out += np.where(valid[rows, j][:, None], term, dt(0))
    return out


def hard_scores(codes, valid, g, a, b, ln_et, Wp: int, tf: bool = False):
    """(P, Wp) hard scores of one instance against the consensus ``g``
    (R,) codes 0..5."""
    P, L = codes.shape
    dt = _acc(tf)
    out = np.zeros((P, Wp), dt)
    ln_et = np.asarray(ln_et, np.float64)
    for j in range(L):
        gw = g[j : j + Wp].astype(np.int64)                     # (Wp,)
        gs = np.minimum(gw, 4)
        c = np.clip(codes[:, j], 0, 4).astype(np.int64)         # (P,)
        same = c[:, None] == gs[None, :]
        k = np.where(same, float(a[j]), float(b[j]) + ln_et[gs[None, :],
                                                            c[:, None]])
        k = np.where(gw[None, :] >= 5, 0.0, k)
        if tf:
            k = tf32(k)
        out += np.where(valid[:, j][:, None], k.astype(dt), dt(0))
    return out


def _fold(weights, codes, vals, W: int, tf: bool):
    P, Pw = weights.shape
    L = codes.shape[1]
    dt = _acc(tf)
    out = np.zeros((W, 5), dt)
    w = tf32(weights) if tf else np.asarray(weights, np.float64)
    for j in range(L):
        oh = (codes[:, j, None] == np.arange(5)[None, :]) \
            * np.asarray(vals[:, j, None], np.float64)          # (P, 5)
        if tf:
            oh = tf32(oh)
        out[j : j + Pw] += (w.T.astype(dt) @ oh.astype(dt))
    return out


def fold_counts(weights, codes, vals, W: int, tf: bool = False):
    """(W, 5) counts of one instance: weights (P, Pw), codes/vals (P, L)."""
    return _fold(weights, codes, vals, W, tf)


def level_weights(lw, k: int, shift: float, cut: float) -> np.ndarray:
    """Level k's weights: the exponent ``lw + k shift`` taken in float32
    (one rounding, the multiply-add of the float32 inputs), its exp where it
    is at most ``cut``, else 0."""
    s32 = float(np.float32(shift))
    lk = (np.asarray(lw, np.float64) + k * s32).astype(np.float32)
    c32 = np.float32(cut)
    return np.where(lk <= c32,
                    np.exp(np.clip(lk.astype(np.float64), -745.0,
                                   float(c32))), 0.0)


def cascade_counts(lw, codes, vals, W: int, m: int, shift: float,
                   cut: float, tf: bool = False):
    """(m, W, 5) cascade counts of one instance: lw (P, Pw)."""
    return np.stack([_fold(level_weights(lw, k, shift, cut), codes, vals, W,
                           tf) for k in range(m)])


def score_candidates(windows, reads, match: int, mismatch: int,
                     gap_code: int) -> dict:
    """windows (B, C, L) int8, the genome under each candidate; reads (B,
    L).  Returns local, e2e, start, end, n_mis, each (B, C) int64."""
    B, C, L = windows.shape
    r = np.broadcast_to(reads[:, None, :], windows.shape)
    real = r != gap_code
    agree = (windows == r) & real & (windows != gap_code)
    s = np.where(real, np.where(agree, match, mismatch), 0).astype(np.int64)
    mis = (real & ~agree).astype(np.int64)
    shape = (B, C)
    pre = np.zeros(shape, np.int64)            # sum of s[.., :j]
    low = np.zeros(shape, np.int64)            # least prefix so far
    low_at = np.zeros(shape, np.int64)         # its first index
    best = np.full(shape, np.iinfo(np.int64).min)
    start = np.zeros(shape, np.int64)
    end = np.zeros(shape, np.int64)
    for j in range(L):
        lower = pre < low
        low = np.where(lower, pre, low)
        low_at = np.where(lower, j, low_at)
        pre = pre + s[..., j]
        here = pre - low
        better = here > best
        best = np.where(better, here, best)
        end = np.where(better, j, end)
        start = np.where(better, low_at, start)
    n_mis = np.zeros(shape, np.int64)
    for j in range(L):
        inside = (start <= j) & (j <= end)
        n_mis += np.where(inside, mis[..., j], 0)
    return dict(local=best, e2e=pre, start=start, end=end, n_mis=n_mis)


def consensus(counts, zone, check: int, cov_thresh) -> tuple:
    """(codes int8 (W,), most (W,)) of one instance's counts (W, 5)."""
    W = counts.shape[0]
    most = counts.max(axis=1)
    first = np.zeros(W, np.int8)
    for c in range(4, -1, -1):                 # the lowest base of the most
        first = np.where(counts[:, c] == most, np.int8(c), first)
    cons = np.where(most > 0, first, np.int8(N_CODE))
    if check:
        cons = np.where(most <= cov_thresh, np.int8(N_CODE), cons)
    return np.where(zone, cons, np.int8(N_CODE)).astype(np.int8), most


def n_runs(contig) -> list:
    """(start, length) of each N-run closed by a base (a run at the
    contig's end is not a gap)."""
    is_n = np.asarray(contig) == N_CODE
    edges = np.flatnonzero(np.diff(np.r_[0, is_n.astype(np.int8), 0]))
    runs = [(int(a), int(b - a)) for a, b in zip(edges[::2], edges[1::2])]
    return [(a, n) for a, n in runs if a + n < len(is_n)]


def splice(contigs, fills, skips) -> list:
    """The draft's contigs with gap i (in contig order, then position)
    replaced by ``fills[i]`` and ``skips[i]`` bases after it dropped."""
    out, i = [], 0
    for contig in contigs:
        parts, cursor = [], 0
        for a, n in n_runs(contig):
            parts.append(contig[cursor:a])
            if fills[i] is not None and len(fills[i]):
                parts.append(np.asarray(fills[i], np.int8))
            cursor = a + n + max(0, int(skips[i]))
            i += 1
        parts.append(contig[cursor:])
        out.append(np.concatenate(parts).astype(np.int8))
    if i != len(fills):
        raise ValueError(f"{len(fills)} fills for {i} gaps")
    return out


def clean_spans(truth, draft, contig, start, length: int,
                margin: int) -> np.ndarray:
    """Whether the draft holds the truth unchanged at each read's span,
    ``margin`` bases around it included (no gap near it, no shift)."""
    ok = np.zeros(len(start), bool)
    for i, (c, s) in enumerate(zip(contig, start)):
        a, b = int(s) - margin, int(s) + length + margin
        t, d = truth[c], draft[c]
        if a < 0 or b > len(t) or b > len(d):
            continue
        ok[i] = np.array_equal(t[a:b], d[a:b])
    return ok


def substitutions(truth, contig, start, reads, reverse: bool) -> np.ndarray:
    """Bases of each read that differ from the truth where it was drawn,
    ``truth[contig][start : start + L]`` (the read reverse-complemented
    first where it was drawn from the reverse strand)."""
    comp = np.array([3, 2, 1, 0, N_CODE], np.int8)
    L = reads.shape[1]
    out = np.zeros(len(start), np.int64)
    for i, (c, s) in enumerate(zip(contig, start)):
        r = comp[reads[i]][::-1] if reverse else reads[i]
        out[i] = int((r != truth[c][int(s) : int(s) + L]).sum())
    return out


def placed_off_truth(offsets, contig, start, strand_want, aligned, pos,
                     strand) -> int:
    """Reads not aligned, or aligned elsewhere or on the other strand, than
    the window of the flat draft (``offsets[contig] + start``) they were
    drawn from."""
    want = np.asarray(offsets, np.int64)[contig] + start
    return int((~aligned | (pos != want) | (strand != strand_want)).sum())
