"""Sharded execution of the device stages (``figbird_tpu/parallel/
sharded.py``).

* ``make_genome_sharded_align`` / ``make_contig_sharded_align`` — the
  (reads x genome) aligners: every genome shard of a reads row aligns the
  row's batch against its k-mer table (code ranges) or flat-genome slice
  (contig ranges) on its own device; the per-shard bests are gathered onto
  the row's first device and combined with the replicated aligner's exact
  tie-break order.
* ``sharded_fill`` — gap instances split over the ``reads`` axis (no
  cross-instance communication).
* ``psum_stats`` — model sufficient statistics summed over ``reads``.

Where the reference ends a combine with a ``psum`` of rank 0's copy over
``genome`` (which only makes the replication provable to ``shard_map``),
one process already holds the one combined result, so that step has no
counterpart here.
"""

from __future__ import annotations

import numpy as np
import torch

from ..dtypes import GAP_CODE


def sharded_fill(shards: list, fn, cfg, gap_idx: np.ndarray,
                 gap_len: np.ndarray, *rest: np.ndarray) -> list:
    """Split the instance axis over the reads shards and run ``fn(cfg,
    gap_arrays, gap_idx, gap_len, model, *rest)`` for each part on its
    shard's device.  ``shards``: one (device, gap_arrays, model) per reads
    shard, the arrays already on that device; the per-instance host arrays
    split into contiguous parts, in order.  Returns (rows, device output)
    per non-empty part, in instance order, every part dispatched before the
    caller fetches any."""
    n = len(gap_idx)
    bounds = [n * i // len(shards) for i in range(len(shards) + 1)]
    out = []
    for (dev, gap_arrays, model), a, b in zip(shards, bounds[:-1],
                                              bounds[1:]):
        if a == b:
            continue
        args = [torch.as_tensor(x[a:b], device=dev)
                for x in (gap_idx, gap_len, *rest)]
        out.append((slice(a, b), fn(cfg, gap_arrays, args[0], args[1],
                                    model, *args[2:])))
    return out


def psum_stats(mesh, per_shard_hist: torch.Tensor) -> torch.Tensor:
    """Sum model sufficient statistics over the reads axis.

    ``per_shard_hist`` stacks one block per reads shard along its first
    axis.  The genome axis holds replicas of each reads shard's statistics,
    so only the reads axis sums (a second sum over genome would multiply
    the totals by the shard count)."""
    n_rd = mesh.shape["reads"]
    x = per_shard_hist
    return x.reshape((n_rd, x.shape[0] // n_rd) + tuple(x.shape[1:])).sum(0)


def split_index_by_code(sorted_codes, sorted_pos, n_shards: int):
    """Split a sorted k-mer table into equal-size shards (binary search stays
    valid per shard since each shard is itself sorted).

    Split points snap to CODE boundaries (all occurrences of a k-mer live in
    one shard), then every shard pads to the common width with sentinel max
    codes — required for hit-set equality with the unsharded table: per-shard
    ``searchsorted`` then enumerates exactly the owner shard's first-H hits.
    """
    m = len(sorted_codes)
    per = -(-m // n_shards)
    bounds = [0]
    for s in range(1, n_shards):
        b = min(s * per, m)
        # advance to the next code boundary
        while b < m and b > 0 and sorted_codes[b] == sorted_codes[b - 1]:
            b += 1
        bounds.append(max(b, bounds[-1]))
    bounds.append(m)
    width = max(bounds[i + 1] - bounds[i] for i in range(n_shards))
    width = max(width, 1)
    sent = np.iinfo(sorted_codes.dtype).max
    codes = np.full(n_shards * width, sent, sorted_codes.dtype)
    pos = np.zeros(n_shards * width, sorted_pos.dtype)
    for i in range(n_shards):
        lo, hi = bounds[i], bounds[i + 1]
        codes[i * width : i * width + hi - lo] = sorted_codes[lo:hi]
        pos[i * width : i * width + hi - lo] = sorted_pos[lo:hi]
    return codes, pos


def split_index_by_contig(index, n_shards: int):
    """Split a genome into contig-range shards for indexes past one card.

    Each shard holds a SLICE of the padded global flat genome covering a
    contiguous contig range (with the inter-contig pad as leading/trailing
    margin, so windows never span shards) plus its own k-mer table with
    LOCAL int32 positions — the path for genomes beyond one device's memory
    or beyond int32 flat positions.  :func:`build_contig_shards` on the
    CPU, in the reference's host layout.

    Returns dict(flat2d (ns*rows,128) int8, flatlen (ns,) int32,
    codes (ns*M,) int32, pos (ns*M,) int32, base (ns,) int64) — every
    per-shard block padded to the common width; ``base[s] + local`` is the
    global flat position.
    """
    cs = build_contig_shards(index, [torch.device("cpu")] * n_shards)
    return dict(flat2d=torch.cat(cs["flat"]).numpy().reshape(-1, 128),
                flatlen=cs["flatlen"], codes=torch.cat(cs["codes"]).numpy(),
                pos=torch.cat(cs["pos"]).numpy(), base=cs["base"],
                rows=cs["rows"], M=cs["M"])


def build_contig_shards(index, devices: list) -> dict:
    """The contig-range shards of :func:`split_index_by_contig`, one on
    each of ``devices`` in turn: contig ranges balanced by flat length, an
    empty range (a pad-only stub) where contigs run out; each shard's flat
    slice is uploaded and its table sorted on its device
    (``align.index.sorted_kmers``, the sentinel tail cut), its temporaries
    freed before the next.  A shard whose slice reaches 2^31 positions
    raises: its local positions would wrap.

    Returns dict(flat, codes, pos: one 1-D tensor per shard on its device,
    padded to the common width (``flat`` to ``rows`` x 128 bases of N,
    ``codes`` to ``M`` with the sentinel, ``pos`` with 0); flatlen (ns,)
    int32, base (ns,) int64, rows, M)."""
    from ..align.index import SENT, sorted_kmers

    ns = len(devices)
    offsets, pad, flat_len = index.offsets, index.pad, len(index.flat)
    n_contigs = len(offsets)
    # balance contig ranges by flat length
    ends = np.concatenate([offsets[1:] - pad, [flat_len]])
    sizes = ends - (offsets - pad)
    target = sizes.sum() / ns
    bounds = [0]
    acc = 0.0
    for ci in range(n_contigs):
        acc += sizes[ci]
        if acc >= target * len(bounds) and len(bounds) < ns:
            bounds.append(ci + 1)
    while len(bounds) < ns:
        bounds.append(n_contigs)
    bounds.append(n_contigs)

    flats, tables, bases = [], [], []
    for s, dev in enumerate(devices):
        lo_c, hi_c = bounds[s], bounds[s + 1]
        if lo_c >= hi_c:  # empty shard: a pad-only stub
            fl = torch.full((pad,), GAP_CODE, dtype=torch.int8, device=dev)
            empty = torch.zeros(0, dtype=torch.int32, device=dev)
            flats.append(fl)
            tables.append((empty, empty))
            bases.append(0)
            continue
        base = int(offsets[lo_c]) - pad
        end = min(int(ends[hi_c - 1]) + pad, flat_len)
        if end - base >= 2**31:
            raise ValueError(
                f"contig-range shard {s} spans {end - base} flat positions, "
                f"past int32 local positions; use more genome shards")
        fl = torch.as_tensor(index.flat[base:end]).to(dev)
        codes, pos, n_valid = sorted_kmers(fl, index.k)
        flats.append(fl)
        tables.append((codes[:n_valid], pos[:n_valid]))
        bases.append(base)
    rows = max((f.shape[0] + 127) // 128 + 2 for f in flats)
    M = max(max(len(c) for c, _ in tables), 1)
    out = dict(flat=[], codes=[], pos=[],
               flatlen=np.asarray([f.shape[0] for f in flats], np.int32),
               base=np.asarray(bases, np.int64), rows=rows, M=M)
    for s in range(ns):  # each unpadded shard freed once padded
        fl, (c, p) = flats[s], tables[s]
        flats[s] = tables[s] = None
        dev, n = fl.device, len(c)
        out["flat"].append(torch.cat([fl, torch.full(
            (rows * 128 - fl.shape[0],), GAP_CODE, dtype=torch.int8,
            device=dev)]))
        out["codes"].append(torch.cat([c, torch.full(
            (M - n,), SENT, dtype=torch.int32, device=dev)]))
        out["pos"].append(torch.cat([p, torch.zeros(
            M - n, dtype=torch.int32, device=dev)]))
    return out


# ---------------------------------------------------------------- combine

_BIG = 1 << 30


def _take_shard(v: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """v (ns, B, ...) at shard ``win[b]`` for every read b."""
    idx = win.reshape((1, -1) + (1,) * (v.dim() - 2)).expand(
        (1,) + tuple(v.shape[1:]))
    return v.gather(0, idx)[0]


def _winner(st: dict) -> torch.Tensor:
    """Winning shard per read, in the replicated aligner's tie-break order:
    max score, then forward strand, then lowest (global) candidate slot."""
    mx = st["score"].max(0).values
    elig = st["score"] == mx
    strand = st["strand"].to(torch.int32)
    mnst = torch.where(elig, strand, 2).min(0).values
    elig = elig & (strand == mnst)
    mnci = torch.where(elig, st["cand_i"], _BIG).min(0).values
    return (elig & (st["cand_i"] == mnci)).to(torch.uint8).argmax(0)


def _gather(outs: list, dev) -> dict:
    """Per-shard output dicts stacked on ``dev`` (the all-gather)."""
    return {kk: torch.stack([o[kk].to(dev) for o in outs])
            for kk in outs[0]}


def make_genome_sharded_align(mesh, k: int, params):
    """Code-range genome-sharded aligner: ``fn(r, shards, reads, lengths)``
    with ``shards[g] = (flat, flatlen, tables)`` on ``mesh.device(r, g)``
    (the genome replicated, the searchsorted table's g-th code range) and
    the reads on ``mesh.device(r, 0)``.

    Each shard runs the full per-read aligner (``align_batch``) against its
    shard of the table; the per-shard bests combine on the reads row's first
    device: winner by score, runner-up across shards for uniqueness,
    overflow OR-ed.  With code-boundary-aligned shards
    (:func:`split_index_by_code`) the hit enumeration per k-mer is the
    unsharded searchsorted table's, so results equal a replicated
    ``Aligner(use_buckets=False)``."""
    from ..align.core import _pack_out, align_batch

    def fn(r, shards, reads, lengths):
        dev0 = reads.device
        outs = []
        for flat, flatlen, tables in shards:
            d = flat.device
            out = align_batch(flat, flatlen, tables, reads.to(d),
                              lengths.to(d), k, params, None)
            out.pop("packed")
            outs.append(out)
        st = _gather(outs, dev0)
        win = _winner(st)
        res = {kk: _take_shard(v, win) for kk, v in st.items()}
        # runner-up at a DISTINCT GENOME POSITION from the winner (the
        # replicated uniqueness rule): a shard whose best sits at the
        # winning position contributes its own runner-up instead
        masked = torch.where(st["pos"] == res["pos"][None], st["second"],
                             st["score"])
        res["second"] = masked.max(0).values
        res["hit_overflow"] = st["hit_overflow"].any(0)
        res["unique"] = res["aligned"] & (res["score"] > res["second"])
        res["packed"] = _pack_out(res, reads.shape[1])
        return res

    return fn


def make_contig_sharded_align(mesh, k: int, params):
    """Contig-range genome-sharded aligner: ``fn(r, shards, reads,
    lengths)`` with ``shards[g] = (flat, flatlen, codes, pos)`` on
    ``mesh.device(r, g)``: the g-th contig range of the flat genome and its
    own table of LOCAL positions.

    Equality with the replicated aligner requires its GLOBAL hit
    enumeration: for each seed k-mer, the replicated table enumerates the
    first H hits in ascending global position.  Shards are position-ordered,
    so the global first-H are the per-shard hits whose global rank (the
    exclusive prefix of the per-shard hit counts, gathered across shards)
    is < H; the candidate slot used for tie-breaks is the global rank, and
    overflow/repeat masks use the global count.  Positions stay LOCAL int32
    on the devices (plus the shard id, packed with them); the host
    globalizes them with the int64 shard bases."""
    from ..align.core import (NEG, _pack_out, _seed_codes, extract_span,
                              revcomp_batch)
    from ..ops.align_score import score_candidates

    H = params.hits_per_seed
    S = params.n_seeds
    C = S * H
    SLOT_CAP = 1 << 20

    def strand_bests(shards, sreads, slens, dev0):
        """One strand on every shard: per-shard best (global slot order for
        ties) and runner-up at a distinct position."""
        seeds, cnts = [], []
        for (flat, flatlen, codes, pos), rd, ln in zip(shards, sreads,
                                                        slens):
            scodes, valid, offs = _seed_codes(rd, ln, k, S)
            lo = torch.searchsorted(codes, scodes, side="left")
            hi = torch.searchsorted(codes, scodes, side="right")
            seeds.append((valid, offs, lo))
            cnts.append((hi - lo).to(dev0))
        cnts = torch.stack(cnts)                        # (ns, B, S)
        total = cnts.sum(0)
        bests = []
        h = torch.arange(H, device=dev0)
        for gi, ((flat, flatlen, codes, pos), rd, (valid, offs, lo)) in \
                enumerate(zip(shards, sreads, seeds)):
            d = flat.device
            B, L = rd.shape
            cnt = cnts[gi].to(d)
            before = cnts[:gi].sum(0).to(d)
            tot = total.to(d)
            hh = h.to(d)
            hmask = ((hh < cnt[..., None]) & (before[..., None] + hh < H)
                     & valid[..., None]
                     & (tot[..., None] <= params.repeat_limit))
            M = codes.shape[0]
            hit_idx = torch.clamp(lo[..., None] + hh, 0, M - 1)
            hit_pos = pos[hit_idx]
            overflow = valid & (tot > H) & (tot <= params.repeat_limit)
            gslot = (torch.arange(S, device=d)[None, :, None] * H
                     + before[..., None] + hh)        # global candidate slot
            cand = hit_pos - offs[:, :, None]
            cand = torch.clamp(cand, 0, flatlen - L - 1).to(torch.int32)
            cand = cand.reshape(B, C)
            hmask_f = hmask.reshape(B, C)
            gslot = torch.clamp(gslot, 0, SLOT_CAP).reshape(B, C)
            sc = score_candidates(flat, rd, cand, params.match,
                                  params.mismatch, GAP_CODE)
            sel = torch.where(hmask_f, sc["e2e" if params.end_to_end
                                         else "local"], NEG)
            # per-shard best with GLOBAL slot order for ties
            best_sel = sel.max(-1).values
            tie = sel == best_sel[:, None]
            best_slot = torch.where(tie, gslot, SLOT_CAP).min(-1).values
            bi = (tie & (gslot == best_slot[:, None])).to(
                torch.uint8).argmax(-1)

            def take(x):
                return x.gather(1, bi[:, None])[:, 0]

            best = dict(score=take(sel), e2e=take(sc["e2e"]),
                        start=take(sc["start"]), end=take(sc["end"]),
                        n_mis=take(sc["n_mis"]), pos=take(cand),
                        cand_i=best_slot.to(torch.int32),
                        hit_overflow=overflow.any(-1))
            others = torch.where(cand != best["pos"][:, None], sel, NEG)
            best["second"] = others.max(-1).values
            bests.append(best)
        return bests

    def fn(r, shards, reads, lengths):
        dev0 = reads.device
        B, L = reads.shape
        fwd_r = [reads.to(s[0].device) for s in shards]
        lens = [lengths.to(s[0].device) for s in shards]
        rc_r = [revcomp_batch(x, ln) for x, ln in zip(fwd_r, lens)]
        fwd = strand_bests(shards, fwd_r, lens, dev0)
        rev = strand_bests(shards, rc_r, lens, dev0)
        outs = []
        for gi, (f, v) in enumerate(zip(fwd, rev)):
            use_rev = v["score"] > f["score"]
            out = {kk: torch.where(use_rev, v[kk], f[kk])
                   for kk in ("score", "e2e", "start", "end", "n_mis", "pos",
                              "cand_i")}
            out["hit_overflow"] = f["hit_overflow"] | v["hit_overflow"]
            out["strand"] = use_rev.to(torch.int8)
            out["second"] = torch.maximum(
                torch.where(use_rev, v["second"], f["second"]),
                torch.where(use_rev, f["score"], v["score"]))
            out["shard"] = torch.full_like(out["score"], gi)
            outs.append(out)

        # cross-shard combine: winner by (score desc, strand fwd-first,
        # global slot asc) — the replicated argmax order
        st = _gather(outs, dev0)
        win = _winner(st)
        res = {kk: _take_shard(v, win) for kk, v in st.items()}
        # runner-up at a distinct (shard, pos) — distinct global position
        same_place = (st["pos"] == res["pos"][None]) & \
            (st["shard"] == res["shard"][None])
        res["second"] = torch.where(same_place, st["second"],
                                    st["score"]).max(0).values

        # the winner's genome window, fetched from its owning shard
        win_chars = torch.zeros((B, L), dtype=torch.int32, device=dev0)
        for gi, (flat, *_) in enumerate(shards):
            d = flat.device
            mine = (res["shard"] == gi).to(d)
            w = extract_span(flat, torch.where(mine, res["pos"].to(d), 0), L)
            win_chars += torch.where(mine[:, None], w.to(torch.int32),
                                     0).to(dev0)
        reads_o = torch.where(res["strand"][:, None] == 1,
                              revcomp_batch(reads, lengths), reads)
        rv = reads_o != GAP_CODE
        m = (win_chars == reads_o) & rv & (win_chars != GAP_CODE)
        if params.end_to_end:
            min_score = (params.e2e_min_const + params.e2e_min_per_base
                         * lengths.to(torch.float32))
            res["n_mis"] = (rv & ~m).sum(dim=1)
            res["aligned"] = res["score"].to(torch.float32) >= min_score
            res["alen"] = lengths
            res["clip_start"] = torch.zeros_like(lengths)
            res["clip_end"] = torch.zeros_like(lengths)
        else:
            min_score = (params.min_score_const + params.min_score_log
                         * torch.log(torch.clamp_min(lengths, 2).to(
                             torch.float32)))
            res["aligned"] = res["score"].to(torch.float32) >= min_score
            res["alen"] = res["end"] - res["start"] + 1
            res["clip_start"] = res["start"]
            res["clip_end"] = torch.clamp_min(lengths - 1 - res["end"], 0)
        res["unique"] = res["aligned"] & (res["score"] > res["second"])
        if params.want_mism:
            res["mism"] = rv & ~m
        res["packed"] = _pack_out(res, L)
        return res

    return fn
