"""Banded affine-gap Smith-Waterman indel tier (``figbird_tpu/align/banded.py``).

Device: batched banded DP scores over the escalation set, a Python loop of
torch ops over read positions with a (B, K) band carry, K = 2*band+1 (the
reference's ``lax.scan``; not a Pallas kernel).  Within-row deletion chains
use the exact lazy-E formulation (valid for gap_open <= gap_extend).
Host: the vectorised traceback for the winners, copied from the reference
(its module imports JAX).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..dtypes import GAP_CODE

NEG = -(2 ** 30)


@dataclass(frozen=True)
class BandedParams:
    band: int = 8           # max indel drift either way
    match: int = 2          # bowtie2 --local --ma
    mismatch: int = -6      # --mp max
    gap_open: int = -5      # --rdg/--rfg default "5,3"
    gap_extend: int = -3
    end_to_end: bool = False


def banded_scores_device(flat: torch.Tensor, starts: torch.Tensor,
                         reads: torch.Tensor, lengths: torch.Tensor,
                         params: BandedParams) -> dict:
    """Banded affine-gap DP scores for a batch: local, or glocal with
    ``params.end_to_end`` (the whole read aligns: no zero floor, the score
    read where the full read ends; the genome-side start stays free).

    flat: padded genome (1-D int8); starts (B,) window starts of each read's
    gapless candidate (the band allows +-band drift).  Returns dict(score,
    end_i, end_k) of (B,) int32 — the best-scoring cell.
    """
    e2e = params.end_to_end
    B, L = reads.shape
    bd = params.band
    K = 2 * bd + 1
    dev = reads.device
    s0 = torch.clamp_min(starts.long() - bd, 0)
    win = flat[s0[:, None] + torch.arange(L + 2 * bd, device=dev)]
    op, ex = params.gap_open, params.gap_extend
    mt, ms = params.match, params.mismatch
    kk = torch.arange(K, device=dev, dtype=torch.int32)[None, :]
    neg_col = torch.full((B, 1), NEG, dtype=torch.int32, device=dev)

    H = torch.zeros((B, K), dtype=torch.int32, device=dev)
    F = torch.full((B, K), NEG, dtype=torch.int32, device=dev)
    best = torch.full((B,), NEG if e2e else 0, dtype=torch.int32, device=dev)
    bi = torch.zeros(B, dtype=torch.int32, device=dev)
    bk = torch.zeros(B, dtype=torch.int32, device=dev)
    for i in range(L):
        wch = win[:, i : i + K]
        rch = reads[:, i : i + 1]
        valid_r = (i < lengths)[:, None]
        # genome N scores as a plain mismatch (GAP_CODE == N)
        sub = torch.where((wch == rch) & (wch != GAP_CODE), mt, ms)
        diag = H + sub.to(torch.int32)
        H_up = torch.cat([H[:, 1:], neg_col], dim=1)
        F_up = torch.cat([F[:, 1:], neg_col], dim=1)
        F = torch.maximum(H_up + op, F_up + ex)
        F = torch.where(valid_r, F, NEG)
        H_noE = torch.maximum(diag, F)
        if not e2e:
            H_noE = torch.clamp_min(H_noE, 0)  # local: restart anywhere
        g = H_noE - ex * kk
        m = torch.cummax(g, dim=1).values
        m_shift = torch.cat([neg_col, m[:, :-1]], dim=1)
        E = m_shift + op + ex * (kk - 1)
        Hn = torch.maximum(H_noE, E)
        if not e2e:
            Hn = torch.clamp_min(Hn, 0)
        H = torch.where(valid_r, Hn, H).to(torch.int32)
        row_best = H.max(dim=1).values
        row_k = H.argmax(dim=1).to(torch.int32)
        upd = row_best > best
        if e2e:  # score the read only where the full read ends
            upd = upd & (i == lengths - 1)
        best = torch.where(upd, row_best, best)
        bi = torch.where(upd, i, bi).to(torch.int32)
        bk = torch.where(upd, row_k, bk)
    return dict(score=best, end_i=bi, end_k=bk)


def host_traceback_batch(reads: np.ndarray, windows: np.ndarray,
                         rlens: np.ndarray, params: BandedParams):
    """Vectorised banded DP + traceback for a winner batch (copied from the
    reference).

    reads (W, L) aligned-orientation; windows (W, L+2*band); rlens (W,).
    Returns a list of per-read dicts (score, ops, read_start, read_end,
    g_off, n_mis, mism, ins_events, del_events) or None.
    """
    Wn, L = reads.shape
    bd = params.band
    K = 2 * bd + 1
    op_, ex = params.gap_open, params.gap_extend
    mt, ms = params.match, params.mismatch
    kk = np.arange(K)

    H = np.zeros((Wn, K), np.int64)
    F = np.full((Wn, K), NEG, np.int64)
    ptr = np.zeros((L + 1, Wn, K), np.int8)   # 0 stop 1 diag 2 F 3 E
    eksrc = np.zeros((L + 1, Wn, K), np.int8)  # E jump target k'
    fopen = np.zeros((L + 1, Wn, K), bool)     # F opened (vs extended)
    best = np.full(Wn, NEG if params.end_to_end else 0, np.int64)
    bi = np.zeros(Wn, np.int64)
    bk = np.zeros(Wn, np.int64)
    live_max = int(rlens.max()) if Wn else 0
    for i in range(live_max):
        rch = reads[:, i : i + 1]
        wrow = windows[:, i : i + K]
        sub = np.where((wrow == rch) & (wrow != GAP_CODE), mt, ms)
        diag = H + sub
        H_up = np.concatenate([H[:, 1:], np.full((Wn, 1), NEG)], axis=1)
        F_up = np.concatenate([F[:, 1:], np.full((Wn, 1), NEG)], axis=1)
        f_open = H_up + op_ >= F_up + ex
        Fn = np.where(f_open, H_up + op_, F_up + ex)
        fopen[i + 1] = f_open
        H_noE = np.maximum(diag, Fn)
        if not params.end_to_end:
            H_noE = np.maximum(H_noE, 0)
        # lazy-E with argmax tracking
        g = H_noE - ex * kk[None, :]
        m = np.maximum.accumulate(g, axis=1)
        marg = np.where(g == m, kk[None, :], 0)
        marg = np.maximum.accumulate(marg, axis=1)  # argmax of running max
        m_shift = np.concatenate([np.full((Wn, 1), NEG), m[:, :-1]], axis=1)
        ks_shift = np.concatenate([np.zeros((Wn, 1), np.int64),
                                   marg[:, :-1]], axis=1)
        E = m_shift + op_ + ex * (kk[None, :] - 1)
        Hn = np.maximum(H_noE, E)
        if not params.end_to_end:
            Hn = np.maximum(Hn, 0)
        # ptr encodes the H_noE source (0 stop, 1 diag, 2 F) in bits 0-1 and
        # "E wins over H_noE" (a deletion run ending here) in bit 2
        p = np.zeros((Wn, K), np.int8)
        p[diag == H_noE] = 1
        p[Fn == H_noE] = 2
        if not params.end_to_end:  # local: 0 marks an alignment start
            p[H_noE == 0] = 0
        p |= (E > H_noE).astype(np.int8) << 2
        ptr[i + 1] = p
        eksrc[i + 1] = ks_shift.astype(np.int8)
        live = i < rlens
        H = np.where(live[:, None], Hn, H)
        F = np.where(live[:, None], Fn, F)
        row_best = H.max(axis=1)
        if params.end_to_end:
            upd = (i == rlens - 1) & (row_best > best)
        else:
            upd = live & (row_best > best)
        best = np.where(upd, row_best, best)
        bi = np.where(upd, i + 1, bi)
        bk = np.where(upd, H.argmax(axis=1), bk)

    out = []
    for w in range(Wn):
        rlen = int(rlens[w])
        if best[w] <= (NEG // 2 if params.end_to_end else 0):
            out.append(None)
            continue
        i, k = int(bi[w]), int(bk[w])
        ops_rev = []
        mism = np.zeros(L, bool)
        n_mis = 0
        state = "H"
        while i > 0:
            if state == "H":
                p = int(ptr[i, w, k])
                if p & 4:  # deletion run ending here: one E jump k -> k'
                    kp = int(eksrc[i, w, k])
                    ops_rev.append(("D", k - kp))
                    k = kp
                    p = int(ptr[i, w, k])
                d = p & 3
                if d == 0:
                    break
                if d == 1:
                    wch = windows[w, i - 1 + k]
                    if wch != reads[w, i - 1]:
                        mism[i - 1] = True
                        n_mis += 1
                    ops_rev.append(("M", 1))
                    i -= 1
                else:
                    state = "F"
            else:  # F: insertion step (i-1, k+1) -> (i, k)
                ops_rev.append(("I", 1))
                opened = fopen[i, w, k]
                i -= 1
                k += 1
                if opened:
                    state = "H"
        ops_rev.reverse()
        ops = []
        for c, n in ops_rev:
            if ops and ops[-1][0] == c:
                ops[-1][1] += n
            else:
                ops.append([c, n])
        read_start = i
        read_end = read_start + sum(n for c, n in ops if c in "MI")
        g_off = -bd + k
        ins_events, del_events = [], []
        cyc = read_start
        for c, n in ops:
            if c == "M":
                cyc += n
            elif c == "I":
                ins_events.append((cyc, n))
                cyc += n
            else:
                del_events.append((cyc, n))
        out.append(dict(score=int(best[w]), ops=[(c, n) for c, n in ops],
                        read_start=int(read_start), read_end=int(read_end),
                        g_off=int(g_off), n_mis=int(n_mis), mism=mism[:rlen],
                        ins_events=ins_events, del_events=del_events))
    return out
