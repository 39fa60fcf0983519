"""Device seed-and-extend alignment (``figbird_tpu/align/core.py``), one device.

1. **Seed**: S k-mers per read at evenly spaced offsets, looked up in the
   direct-addressed prefix buckets of the sorted k-mer table, up to H hits
   each, for the read and its reverse complement.
2. **Extend**: every candidate window gets a gapless local score — the K5
   kernel (``ops.align_score``), bowtie2 ``--local`` soft-clip semantics.
3. **Select**: best candidate per strand (first max), best strand, runner-up
   at a distinct position for uniqueness.

Two-tier escalation (cheap seeding pass, then the full pass for reads it
could not settle), the banded indel tier and the device model-statistics
passes follow the reference.  The mesh and genome-sharded branches are not
ported.
"""

from __future__ import annotations

import gc
import logging
import time as _time
from dataclasses import dataclass, replace

import numpy as np
import torch

from ..dtypes import COMPLEMENT, GAP_CODE
from ..ops import entry_device
from ..ops.align_score import score_candidates
from .index import KmerIndex, build_device_tables, host_tables

logger = logging.getLogger("figbird_tpu_torch.align")

NEG = -(2 ** 30)


@dataclass(frozen=True)
class AlignParams:
    n_seeds: int = 4
    hits_per_seed: int = 8
    repeat_limit: int = 128  # ignore k-mers occurring more often than this
    match: int = 2           # bowtie2 --local --ma default
    mismatch: int = -6       # bowtie2 --mp max default
    min_score_const: float = 20.0   # bowtie2 --score-min G,20,8
    min_score_log: float = 8.0
    end_to_end: bool = False
    e2e_min_per_base: float = 1.2
    e2e_min_const: float = -0.8
    want_mism: bool = True


def shift_left_batch(x: torch.Tensor, off: torch.Tensor, fill) -> torch.Tensor:
    """out[:, j] = x[:, j + off] per row (``fill`` beyond column L);
    ``off`` in [0, L]."""
    B, L = x.shape
    xp = torch.cat([x, torch.full((B, L + 1), fill, dtype=x.dtype,
                                  device=x.device)], dim=1)
    idx = off.long()[:, None] + torch.arange(L, device=x.device)
    return xp.gather(1, idx)


def to_cycle_batch(x: torch.Tensor, lengths: torch.Tensor, fill):
    """Aligned-orientation column j -> sequencing cycle len-1-j."""
    return shift_left_batch(x.flip(1), x.shape[1] - lengths, fill)


def revcomp_batch(reads: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Per-read reverse complement honouring lengths (pad stays N)."""
    comp = torch.where(reads < 4, 3 - reads, reads).to(torch.int8)
    return shift_left_batch(comp.flip(1), reads.shape[1] - lengths, GAP_CODE)


def extract_span(table: torch.Tensor, start: torch.Tensor, S: int):
    """``table[start : start + S]`` for a batch of starts (padded table)."""
    return table[start.long()[..., None]
                 + torch.arange(S, device=table.device)]


def as_rows(flat: np.ndarray, fill=None) -> np.ndarray:
    """Pad a flat array to (rows+2)*128 entries (span reads stay in range)."""
    flat = np.asarray(flat)
    if fill is None:
        fill = GAP_CODE if flat.dtype == np.int8 else 0
    nrow = (len(flat) + 127) // 128 + 2
    out = np.full(nrow * 128, fill, flat.dtype)
    out[: len(flat)] = flat
    return out


def _seed_fracs(n: int, device) -> torch.Tensor:
    """The f32 values of ``jnp.linspace(0, 1, n)``: i/(n-1), then 1."""
    if n == 1:
        return torch.zeros(1, dtype=torch.float32, device=device)
    steps = torch.arange(n - 1, dtype=torch.float32, device=device) / (n - 1)
    return torch.cat([steps, torch.ones(1, dtype=torch.float32,
                                        device=device)])


def _seed_codes(reads, lengths, k: int, n_seeds: int):
    """K-mer codes at n_seeds evenly spaced offsets: (codes, valid, offs),
    each (B, S)."""
    B, L = reads.shape
    dev = reads.device
    x = torch.clamp_max(reads, 3).to(torch.int32)
    valid_n = (reads < 4).to(torch.int32)
    codes_all = torch.zeros((B, L), dtype=torch.int32, device=dev)
    vall = torch.ones((B, L), dtype=torch.int32, device=dev)
    for i in range(k):
        shx = torch.cat([x[:, i:], torch.zeros((B, i), dtype=torch.int32,
                                               device=dev)], dim=1)
        codes_all = codes_all + shx * (4 ** (k - 1 - i))
        shv = torch.cat([valid_n[:, i:], torch.ones((B, i), dtype=torch.int32,
                                                    device=dev)], dim=1)
        vall = vall * shv
    j = torch.arange(L, device=dev)[None, :]
    vall = vall * (j <= (lengths[:, None] - k))
    span = torch.clamp_min(lengths - k, 0).to(torch.float32)
    offs = torch.floor(span[:, None] * _seed_fracs(n_seeds, dev)[None, :]
                       ).to(torch.int64)
    codes = codes_all.gather(1, offs)
    valid = (vall.gather(1, offs) > 0) & (lengths[:, None] >= k)
    return codes, valid, offs.to(torch.int32)


def _seed_hits(tables: dict, codes, valid, H: int, repeat_limit: int,
               prefix_shift: int):
    """Prefix-bucket seed lookup: (hit_pos (B,S,H), hmask, overflow (B,S))."""
    dev = codes.device
    prefix = (codes >> prefix_shift).long()
    lo = tables["starts"][prefix]
    hi = tables["starts"][prefix + 1]
    bcnt = hi - lo
    ok = valid[..., None] & (bcnt[..., None] <= repeat_limit)
    hh = torch.arange(H, device=dev)
    if prefix_shift == 0:  # exact buckets: entries == the queried code
        hit_pos = extract_span(tables["pos"], lo, H)
        overflow = valid & (bcnt > H) & (bcnt <= repeat_limit)
        return hit_pos, (hh < bcnt[..., None]) & ok, overflow
    SCAN = max(2 * H, 16)
    ec = extract_span(tables["codes"], lo, SCAN)
    epos = extract_span(tables["pos"], lo, SCAN)
    within = torch.arange(SCAN, device=dev) < bcnt[..., None]
    m = within & (ec == codes[..., None])
    anym = m.any(dim=-1)
    fo = m.to(torch.int32).argmax(dim=-1)  # matches are contiguous
    cnt = m.sum(dim=-1)
    eposp = torch.cat([epos, torch.zeros(epos.shape[:-1] + (H,),
                                         dtype=epos.dtype, device=dev)], -1)
    hit_pos = eposp.gather(-1, fo[..., None] + hh)
    hmask = (hh < cnt[..., None]) & anym[..., None] & ok
    # a bucket denser than the SCAN window may hide matches beyond it
    overflow = valid & (bcnt <= repeat_limit) & (
        (cnt > H) | ((bcnt > SCAN) & (fo + cnt >= SCAN)))
    return hit_pos, hmask, overflow


def _align_one_strand(flat, flatlen: int, tables, reads, lengths, k: int,
                      p: AlignParams, prefix_shift: int) -> dict:
    B, L = reads.shape
    codes, valid, offs = _seed_codes(reads, lengths, k, p.n_seeds)
    H = p.hits_per_seed
    hit_pos, hmask, overflow = _seed_hits(tables, codes, valid, H,
                                          p.repeat_limit, prefix_shift)
    cand = hit_pos - offs[:, :, None]
    cand = torch.clamp(cand, 0, flatlen - L - 1).to(torch.int32)
    C = p.n_seeds * H
    cand = cand.reshape(B, C)
    hmask = hmask.reshape(B, C)
    sc = score_candidates(flat, reads, cand, p.match, p.mismatch, GAP_CODE)
    sel = torch.where(hmask, sc["local"], NEG)
    bi = sel.argmax(dim=-1)

    def take(x):
        return x.gather(1, bi[:, None])[:, 0]

    best = dict(score=take(sel), e2e=take(sc["e2e"]), start=take(sc["start"]),
                end=take(sc["end"]), n_mis=take(sc["n_mis"]), pos=take(cand),
                cand_i=bi.to(torch.int32),
                hit_overflow=overflow.any(dim=-1))
    # second best at a distinct genome position
    others = torch.where(cand != best["pos"][:, None], sel, NEG)
    best["second"] = others.max(dim=-1).values
    return best


PACK_KEYS = ("score", "n_mis", "pos", "cand_i", "hit_overflow", "strand",
             "second", "aligned", "unique", "alen", "clip_start", "clip_end")


def _pack_out(out: dict, read_len: int) -> torch.Tensor:
    """The reference's bit-packed (B, 4) int32 layout (``_pack_out``):
    w0 pos; w1 score(i16)<<16 | second(i16); w2 n_mis | cand_i<<8 |
    flags<<16; w3 alen | clip_start<<16 | clip_end<<24.  Reads longer than
    255 use the wide 12-column layout."""
    if read_len > 255:
        return torch.stack([out[k].to(torch.int32) for k in PACK_KEYS], 1)

    def u8(x):
        return x.long().clamp(0, 255)

    def i16(x):
        return x.long().clamp(-32768, 32767) & 0xFFFF

    flags = (out["hit_overflow"].long() | (out["aligned"].long() << 1)
             | (out["unique"].long() << 2) | (out["strand"].long() << 3))
    w = torch.stack([
        out["pos"].long(),
        (i16(out["score"]) << 16) | i16(out["second"]),
        u8(out["n_mis"]) | (u8(out["cand_i"]) << 8) | (flags << 16),
        out["alen"].long().clamp(0, 65535) | (u8(out["clip_start"]) << 16)
        | (u8(out["clip_end"]) << 24)], dim=1)
    return torch.where(w >= 2 ** 31, w - 2 ** 32, w).to(torch.int32)


def unpack_out(packed: np.ndarray) -> dict:
    """Host unpack of :func:`_pack_out` (copied from the reference)."""
    if packed.shape[1] != 4:  # wide layout
        out = {}
        for i, k in enumerate(PACK_KEYS):
            v = packed[:, i]
            if k in ("hit_overflow", "aligned", "unique"):
                v = v.astype(bool)
            elif k == "strand":
                v = v.astype(np.int8)
            out[k] = v
        return out
    pu = packed.astype(np.uint32)

    def s16(v):
        return ((v & 0xFFFF).astype(np.int32) ^ 0x8000) - 0x8000

    flags = (pu[:, 2] >> 16) & 0xFF
    return dict(
        shard=((pu[:, 2] >> 24) & 0xFF).astype(np.int32),
        pos=packed[:, 0].astype(np.int32),
        score=s16(pu[:, 1] >> 16),
        second=s16(pu[:, 1]),
        n_mis=(pu[:, 2] & 0xFF).astype(np.int32),
        cand_i=((pu[:, 2] >> 8) & 0xFF).astype(np.int32),
        hit_overflow=(flags & 1).astype(bool),
        aligned=(flags & 2).astype(bool),
        unique=(flags & 4).astype(bool),
        strand=((flags >> 3) & 1).astype(np.int8),
        alen=(pu[:, 3] & 0xFFFF).astype(np.int32),
        clip_start=((pu[:, 3] >> 16) & 0xFF).astype(np.int32),
        clip_end=((pu[:, 3] >> 24) & 0xFF).astype(np.int32),
    )


def align_batch(flat, flatlen: int, tables, reads, lengths, k: int,
                params: AlignParams, prefix_shift: int) -> dict:
    """Align a batch against both strands; returns the packed per-read best
    alignment (and the mismatch mask when ``params.want_mism``)."""
    if params.end_to_end:
        raise NotImplementedError(
            "end-to-end alignment (unmapped mode) is not ported yet; see "
            "ROADMAP.md, queue 1 item 8")
    fwd = _align_one_strand(flat, flatlen, tables, reads, lengths, k, params,
                            prefix_shift)
    rc_reads = revcomp_batch(reads, lengths)
    rev = _align_one_strand(flat, flatlen, tables, rc_reads, lengths, k,
                            params, prefix_shift)
    use_rev = rev["score"] > fwd["score"]

    def pick(key):
        return torch.where(use_rev, rev[key], fwd[key])

    out = {key: pick(key) for key in ("score", "n_mis", "pos", "cand_i")}
    out["hit_overflow"] = fwd["hit_overflow"] | rev["hit_overflow"]
    if params.want_mism:
        reads_o = torch.where(use_rev[:, None], rc_reads, reads)
        win = extract_span(flat, out["pos"], reads.shape[1])
        rv = reads_o != GAP_CODE
        m = (win == reads_o) & rv & (win != GAP_CODE)
        out["mism"] = rv & ~m
    out["strand"] = use_rev.to(torch.int8)
    start, end = pick("start"), pick("end")
    out["second"] = torch.maximum(
        torch.where(use_rev, rev["second"], fwd["second"]),
        torch.where(use_rev, fwd["score"], rev["score"]))
    min_score = (params.min_score_const + params.min_score_log
                 * torch.log(torch.clamp_min(lengths, 2).to(torch.float32)))
    out["aligned"] = out["score"].to(torch.float32) >= min_score
    out["unique"] = out["aligned"] & (out["score"] > out["second"])
    out["alen"] = end - start + 1
    out["clip_start"] = start
    out["clip_end"] = torch.clamp_min(lengths - 1 - end, 0)
    out["packed"] = _pack_out(out, reads.shape[1])
    return out


class Aligner:
    """Host-facing aligner: device copies of the genome and the k-mer table,
    reads aligned in batches.  ``two_tier=True`` runs a cheap seeding pass
    first and re-aligns with the full params only the reads it could not
    settle (see the reference's class docstring).  ``device=None`` is the
    card (an error where there is none); ``device="cpu"`` asks for the CPU."""

    def __init__(self, index: KmerIndex, params: AlignParams = AlignParams(),
                 batch_size: int = 32768, two_tier: bool = True,
                 cheap_params: AlignParams | None = None,
                 indel_tier: bool = True, indel_min_clip: int = 4,
                 indel_win_margin: int = 4, banded_params=None, device=None):
        from .banded import BandedParams

        self.device = entry_device(device)
        self.index = index
        self.params = params
        self.indel_tier = indel_tier
        self.indel_min_clip = indel_min_clip
        self.indel_win_margin = indel_win_margin
        self.banded_params = banded_params or BandedParams()
        self.batch_size = batch_size
        self.two_tier = two_tier
        if cheap_params is None:
            cheap_params = replace(params, n_seeds=min(2, params.n_seeds),
                                   hits_per_seed=min(4, params.hits_per_seed))
        self.cheap_params = cheap_params
        if index.k > 15:
            raise ValueError("device aligner requires k <= 15 (int32 codes)")
        if len(index.flat) >= 2 ** 31:
            raise ValueError("flat genome exceeds int32 positions (genome "
                             "sharding is not ported)")
        self._flat = torch.as_tensor(as_rows(index.flat), device=self.device)
        self._flatlen = len(index.flat)
        if index.sorted_codes is None:
            self._prefix_shift = 2 * (index.k - index.prefix_bases)
            self._tables, _ = build_device_tables(
                index.flat, index.k, index.prefix_bases, self.device)
        else:
            self._tables = host_tables(index, self.device)
            self._prefix_shift = 2 * (index.k - index.prefix_bases)

    # ------------------------------------------------------------------
    def _dispatch_pass(self, seq: np.ndarray, lengths: np.ndarray,
                       params: AlignParams):
        """Upload the read set once (padded to a batch multiple) and align
        it batch by batch.  Returns (per-batch output dicts, (chunk, lens)
        device handles for the statistics passes)."""
        n, L = seq.shape
        bs = self.batch_size
        n_pad = -(-max(n, 1) // bs) * bs
        if n_pad != n:
            seq = np.concatenate(
                [seq, np.full((n_pad - n, L), GAP_CODE, dtype=np.int8)])
            lengths = np.concatenate(
                [lengths, np.zeros(n_pad - n, dtype=lengths.dtype)])
        dev_all = torch.as_tensor(seq, device=self.device)
        lens_all = torch.as_tensor(lengths.astype(np.int32),
                                   device=self.device)
        outs, handle = [], []
        for i in range(0, n_pad, bs):
            chunk, lens = dev_all[i : i + bs], lens_all[i : i + bs]
            handle.append((chunk, lens))
            outs.append(align_batch(self._flat, self._flatlen, self._tables,
                                    chunk, lens, self.index.k, params,
                                    self._prefix_shift))
        return outs, handle

    @staticmethod
    def _fetch(outs: list) -> dict:
        """One host copy per output kind for the whole pass."""
        if not outs:
            return {}
        return {kk: torch.cat([o[kk] for o in outs]).cpu().numpy()
                for kk in ("packed", "mism") if kk in outs[0]}

    @staticmethod
    def _collect(host: dict, n: int) -> dict:
        if not host:
            return {}
        out = unpack_out(host["packed"][:n])
        if "mism" in host:
            out["mism"] = host["mism"][:n]
        return out

    def align(self, seq: np.ndarray, lengths: np.ndarray,
              keep_stats: bool = False) -> dict:
        return self.align_many([(seq, lengths)], keep_stats=keep_stats)[0]

    def align_many(self, jobs: list, keep_stats: bool = False) -> list:
        """Align several read sets with OOM backoff: a device out-of-memory
        error retries with a halved batch size, up to twice."""
        for attempt in range(3):
            try:
                return self._align_many_impl(jobs, keep_stats)
            except torch.cuda.OutOfMemoryError:
                if attempt == 2:
                    raise
                self.batch_size = max(self.batch_size // 2, 4096)
                logger.warning("align pass out of device memory (attempt "
                               "%d); retrying with batch_size=%d",
                               attempt + 1, self.batch_size)
                gc.collect()
                torch.cuda.empty_cache()

    def _align_many_impl(self, jobs: list, keep_stats: bool = False) -> list:
        p = self.params
        single = (not self.two_tier
                  or (self.cheap_params.n_seeds >= p.n_seeds
                      and self.cheap_params.hits_per_seed >= p.hits_per_seed))
        params0 = p if single else self.cheap_params

        _t = _time.time()
        outs, handles = [], []
        for seq, lengths in jobs:
            d, h = self._dispatch_pass(seq, lengths, params0)
            outs.append(self._collect(self._fetch(d), seq.shape[0]))
            handles.append(h)
        logger.info("align pass1: %.2fs", _time.time() - _t)

        if not single:
            # confident = unique UNCLIPPED full-length alignment with <= 1
            # mismatch whose seed buckets were fully enumerated; everything
            # else gets the full pass (the <= 1 bar is provably sound: a
            # rival placement would need >= 2 mismatches inside the seeds)
            _t2 = _time.time()
            slack = 1 * (p.match - p.mismatch)
            for out, (seq, lengths) in zip(outs, jobs):
                if not out:
                    continue
                confident = (
                    out["aligned"] & out["unique"] & ~out["hit_overflow"]
                    & (out["clip_start"] == 0) & (out["clip_end"] == 0)
                    & (out["score"] >= p.match * lengths.astype(np.int64)
                       - slack))
                rows = np.flatnonzero(~confident)
                if not rows.size:
                    continue
                d, _ = self._dispatch_pass(seq[rows], lengths[rows], p)
                full = self._collect(self._fetch(d), rows.size)
                for kk, v in full.items():
                    out[kk][rows] = v
            logger.info("align pass2: %.2fs", _time.time() - _t2)

        if self.indel_tier:
            _t3 = _time.time()
            for out, (seq, lengths) in zip(outs, jobs):
                rows, oriented, scores = self._banded_dispatch(seq, lengths,
                                                               out)
                if rows.size:
                    self._banded_finish(seq, lengths, out, rows, oriented,
                                        scores)
            logger.info("align banded: %.2fs", _time.time() - _t3)

        if keep_stats:
            for out, h in zip(outs, handles):
                out["stats_handle"] = h
        return outs

    # ------------------------------------------------------------------
    def _stats_dispatch(self, fn, handle, per_read_args, extra=()):
        """Run a per-batch statistics pass over the retained device chunks;
        returns the per-batch outputs concatenated on the host."""
        bs = self.batch_size
        outs = []
        for bi, (chunk, lens) in enumerate(handle):
            i0 = bi * bs
            args = []
            for a in per_read_args:
                v = np.zeros(bs, a.dtype)
                sl = a[i0 : i0 + bs]
                v[: len(sl)] = sl
                args.append(torch.as_tensor(v, device=self.device))
            outs.append(fn(self._flat, chunk, lens, *args, *extra))
        return torch.cat(outs).cpu().numpy()

    def model_stats_pair(self, jobs) -> list:
        """Device sufficient statistics for both mates: list of dicts
        (error_pos, error_types, base_counts, n).  ``jobs``: (handle, pos,
        strand, mask, clip_s, clip_e) per mate."""
        from ..model.device_stats import stats_batch, unpack_stats

        outs = []
        for handle, pos, strand, mask, clip_s, clip_e in jobs:
            vecs = self._stats_dispatch(
                stats_batch, handle,
                (pos.astype(np.int32), strand.astype(np.int8),
                 mask.astype(bool), clip_s.astype(np.int32),
                 clip_e.astype(np.int32)))
            L = int(handle[0][0].shape[-1])
            outs.append(unpack_stats(vecs.reshape(-1, L + 31).sum(axis=0),
                                     L))
        return outs

    def model_err_log10(self, handle, pos, strand, mask, model,
                        clip_s=None, clip_e=None) -> np.ndarray:
        """Device computeErrorProb log10 per masked row (gapless)."""
        from ..model.device_stats import err_log10_batch, model_log10_arrays

        L = int(handle[0][0].shape[-1])
        if clip_s is None:
            clip_s = np.zeros(len(pos), np.int32)
        if clip_e is None:
            clip_e = np.zeros(len(pos), np.int32)

        def fit(v):
            v = np.asarray(v)
            if len(v) < L:
                v = np.concatenate([v, np.full(L - len(v), v[-1], v.dtype)])
            return v[:L]

        t_cyc, lbe, let, noe = model_log10_arrays(model)
        extra = tuple(torch.as_tensor(a, device=self.device)
                      for a in (fit(t_cyc), lbe, let, fit(noe)))
        vals = self._stats_dispatch(
            err_log10_batch, handle,
            (pos.astype(np.int32), strand.astype(np.int8), mask.astype(bool),
             clip_s.astype(np.int32), clip_e.astype(np.int32)), extra=extra)
        return vals[: len(pos)]

    # ------------------------------------------------------------------
    def _banded_dispatch(self, seq, lengths, out):
        """Indel-tier candidates, oriented on the host, and their banded DP
        scores.  Returns (rows, oriented, scores)."""
        from .banded import banded_scores_device

        if not out:
            return np.zeros(0, np.int64), None, None
        out["indel"] = np.zeros(len(lengths), bool)
        out["indel_detail"] = {}
        cl = out["clip_start"] + out["clip_end"]
        cand = (out["aligned"] & (cl >= self.indel_min_clip)) | (
            ~out["aligned"] & (out["score"] > 0))
        rows = np.flatnonzero(cand)
        if not rows.size:
            return rows, None, None
        L = seq.shape[1]
        rc_needed = np.flatnonzero(out["strand"][rows] == 1)
        oriented = seq[rows].copy()
        if rc_needed.size:
            sub = oriented[rc_needed]
            lens_s = lengths[rows][rc_needed]
            comp = np.asarray(COMPLEMENT, np.int8)[sub]
            src_i = lens_s[:, None] - 1 - np.arange(L)[None, :]
            rc = np.where(src_i >= 0,
                          np.take_along_axis(comp, np.clip(src_i, 0, L - 1),
                                             axis=1),
                          GAP_CODE).astype(np.int8)
            oriented[rc_needed] = rc
        bs = self.batch_size
        scores = []
        for i in range(0, rows.size, bs):
            sl = slice(i, min(i + bs, rows.size))
            res = banded_scores_device(
                self._flat,
                torch.as_tensor(out["pos"][rows[sl]].astype(np.int32),
                                device=self.device),
                torch.as_tensor(oriented[sl], device=self.device),
                torch.as_tensor(lengths[rows[sl]].astype(np.int32),
                                device=self.device),
                self.banded_params)
            scores.append(res["score"])
        return rows, oriented, torch.cat(scores).cpu().numpy()

    def _banded_finish(self, seq, lengths, out, rows, oriented, scores):
        """Host traceback of the banded winners; mutates ``out`` in place
        and records ``indel`` / ``indel_detail``."""
        from .banded import host_traceback_batch

        bp = self.banded_params
        p = self.params
        L = seq.shape[1]
        min_score = (p.min_score_const + p.min_score_log * np.log(
            np.maximum(lengths[rows], 2).astype(np.float64)))
        # margin: a banded "win" below the margin over the gapless score is
        # noise (a spurious 1bp gap recovering a clipped mismatch)
        win_mask = (scores > out["score"][rows] + self.indel_win_margin) & \
            (scores >= min_score)
        flat = self.index.flat
        win_ri = np.flatnonzero(win_mask)
        bd = bp.band
        for c0 in range(0, win_ri.size, 4096):
            wr = win_ri[c0 : c0 + 4096]
            pos_w = out["pos"][rows[wr]].astype(np.int64)
            lens_w = lengths[rows[wr]].astype(np.int64)
            okb = (pos_w - bd >= 0) & (pos_w - bd + L + 2 * bd <= len(flat))
            wr = wr[okb]
            if not wr.size:
                continue
            pos_w, lens_w = pos_w[okb], lens_w[okb]
            widx = (pos_w - bd)[:, None] + np.arange(L + 2 * bd)[None, :]
            tbs = host_traceback_batch(oriented[wr], flat[widx], lens_w, bp)
            for j, tb in enumerate(tbs):
                ri = int(wr[j])
                row = int(rows[ri])
                ln = int(lens_w[j])
                if tb is None or tb["score"] != int(scores[ri]):
                    continue  # band-edge disagreement: keep gapless result
                has_indel = bool(tb["ins_events"] or tb["del_events"])
                galen = ((tb["read_end"] - tb["read_start"])
                         + sum(n for _, n in tb["del_events"])
                         - sum(n for _, n in tb["ins_events"]))
                out["score"][row] = tb["score"]
                out["pos"][row] = int(pos_w[j]) + tb["g_off"]
                out["clip_start"][row] = tb["read_start"]
                out["clip_end"][row] = ln - tb["read_end"]
                out["n_mis"][row] = tb["n_mis"]
                if "mism" in out:
                    out["mism"][row, :] = False
                    out["mism"][row, : len(tb["mism"])] = tb["mism"]
                out["alen"][row] = galen
                out["aligned"][row] = True
                out["unique"][row] = tb["score"] > int(out["second"][row])
                out["indel"][row] = has_indel
                if has_indel:
                    out["indel_detail"][row] = tb
