"""K-mer index over the (gapped) genome (``figbird_tpu/align/index.py``).

The genome is flattened with an N-run pad between contigs so alignment
windows can never silently span a contig boundary (N never scores as a
match).  Positions stored in the table are padded-flat coordinates; helpers
convert to (contig, local_pos).

Host part (numpy): ``KmerIndex`` and ``build_index``, copied from the
reference with its optional native k-mer sorter (:mod:`..io.native`; the
numpy path gives the same table).  Device part: the sorted k-mer table and the prefix buckets,
built on the device (reference ``index.py:181-237``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..dtypes import GAP_CODE
from ..genome import Genome


@dataclass
class KmerIndex:
    k: int
    flat: np.ndarray          # (Gpad,) int8 padded genome
    offsets: np.ndarray       # (n_contigs,) int64 start of each contig in flat
    contig_lengths: np.ndarray  # (n_contigs,) int64
    sorted_codes: np.ndarray  # (M,) int64 k-mer codes, ascending
    sorted_pos: np.ndarray    # (M,) int64 padded-flat position of each k-mer
    pad: int
    prefix_bases: int = 0         # p: bucket = first p bases of the code
    bucket_starts: np.ndarray = None  # (4^p + 1,) int32 offsets into the table

    def build_buckets(self) -> None:
        """Direct-addressed prefix-bucket table over the sorted code array.

        Binary search on device costs ~23 serial gather steps; a bucket
        lookup is 2 row gathers.  p is sized for ~0.5 load factor, capped at
        13 bases (a 268 MB table) — beyond that the in-bucket suffix scan
        (core._seed_hits) caps recall per bucket, which repeat_limit would
        mostly skip anyway.
        """
        m = max(len(self.sorted_codes), 1)
        p = _prefix_bases_for(m, self.k)
        nb = 4 ** p
        prefix = (self.sorted_codes >> (2 * (self.k - p))).astype(np.int64)
        counts = np.bincount(prefix, minlength=nb)
        starts = np.zeros(nb + 1, np.int64)
        np.cumsum(counts, out=starts[1:])
        self.prefix_bases = p
        self.bucket_starts = starts.astype(np.int32)

    @property
    def n_contigs(self) -> int:
        return len(self.offsets)

    def flat_to_contig(self, flat_pos: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Convert padded-flat positions to (contig_index, local_pos).

        Positions inside inter-contig padding clamp into the nearest preceding
        contig (callers mask those out via alignment validity).
        """
        flat_pos = np.asarray(flat_pos)
        ci = np.searchsorted(self.offsets, flat_pos, side="right") - 1
        ci = np.clip(ci, 0, self.n_contigs - 1)
        return ci, flat_pos - self.offsets[ci]

    def contig_to_flat(self, contig: np.ndarray, pos: np.ndarray) -> np.ndarray:
        return self.offsets[np.asarray(contig)] + np.asarray(pos)


def _rolling_codes(seq: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Vectorised k-mer codes: ``code[i] = sum_j seq[i+j] * 4**(k-1-j)``.

    Returns (codes int64 (n-k+1,), valid bool) where valid means the window
    contains no N.
    """
    n = len(seq)
    if n < k:
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=bool)
    m = n - k + 1
    codes = np.zeros(m, dtype=np.int64)
    valid = np.ones(m, dtype=bool)
    s = seq.astype(np.int64)
    for j in range(k):
        w = s[j : j + m]
        codes = codes * 4 + np.minimum(w, 3)
        valid &= w < 4
    return codes, valid


def _prefix_bases_for(m: int, k: int) -> int:
    """Bucket prefix length for ~0.5 load factor (see build_buckets)."""
    p = int(np.ceil(np.log(max(2.0 * m, 4.0)) / np.log(4.0)))
    return min(max(p, 6), 13, k)


def build_index(genome: Genome, k: int = 15, pad: int = 256,
                device_tables: bool = False) -> KmerIndex:
    """Build the sorted k-mer table over all contigs.

    Windows containing N are excluded (the draft's gaps are N-runs, so gap
    interiors are never seed targets — seeds land on flanks, exactly the
    behaviour needed for gap-spanning partial reads).

    ``device_tables=True`` defers the sort + bucket build to the device
    (:func:`build_device_tables`, done lazily by the Aligner): only the flat
    genome is uploaded, and the host pays no argsort.  Host ``sorted_codes``
    stay None in that mode (the golden/SAM and genome-sharded paths need the
    host arrays and use the default).
    """
    lens = genome.lengths
    offsets = np.zeros(len(lens), dtype=np.int64)
    cursor = pad
    parts = [np.full(pad, GAP_CODE, dtype=np.int8)]
    for i, c in enumerate(genome.contigs):
        offsets[i] = cursor
        parts.append(np.asarray(c, dtype=np.int8))
        parts.append(np.full(pad, GAP_CODE, dtype=np.int8))
        cursor += len(c) + pad
    flat = np.concatenate(parts) if parts else np.zeros(0, dtype=np.int8)

    if device_tables:
        # valid (N-free) window count for bucket sizing: non-N runs of
        # length r contribute r-k+1 windows each (run enumeration is ~50x
        # cheaper than a windowed cumsum compare at genome scale)
        good = flat < 4
        d = np.diff(good.astype(np.int8))
        starts = np.flatnonzero(d == 1) + 1
        ends = np.flatnonzero(d == -1) + 1
        if good[:1].any():
            starts = np.concatenate([[0], starts])
        if good[-1:].any():
            ends = np.concatenate([ends, [len(flat)]])
        runs = ends - starts
        n_valid = int(np.maximum(runs - k + 1, 0).sum())
        idx = KmerIndex(
            k=k, flat=flat, offsets=offsets, contig_lengths=lens,
            sorted_codes=None, sorted_pos=None, pad=pad,
            prefix_bases=_prefix_bases_for(n_valid, k))
        return idx

    code_chunks: list[np.ndarray] = []
    pos_chunks: list[np.ndarray] = []
    for i, c in enumerate(genome.contigs):
        codes, valid = _rolling_codes(np.asarray(c, dtype=np.int8), k)
        idx = np.flatnonzero(valid)
        code_chunks.append(codes[idx])
        pos_chunks.append(idx.astype(np.int64) + offsets[i])

    codes = np.concatenate(code_chunks) if code_chunks else np.zeros(0, np.int64)
    pos = np.concatenate(pos_chunks) if pos_chunks else np.zeros(0, np.int64)
    order = np.argsort(codes, kind="stable")
    return KmerIndex(
        k=k,
        flat=flat,
        offsets=offsets,
        contig_lengths=lens,
        sorted_codes=codes[order],
        sorted_pos=pos[order],
        pad=pad,
    )


SENT = 1 << 30  # >= 4**15: windows holding an N sort after every real k-mer
SORT_PREFIX_BASES = 2  # sorted_kmers' bucket: the code's first bases


def sorted_kmers(fl: torch.Tensor, k: int):
    """Every k-mer window of the int8 sequence ``fl`` (one per position)
    stably sorted by code, on ``fl``'s device.

    codes[i] from k shifted adds, in place; windows with an N (or running
    off the end) get ``SENT`` and go to the tail in position order; the
    valid ones keep position order within a code (the host build's order).
    The sort runs one prefix bucket (the code's first p =
    ``SORT_PREFIX_BASES`` bases, at most 3: a bucket id is a byte) at a
    time: each bucket's positions ascend as ``nonzero`` gives them and a
    stable sort of their codes keeps that order, so the table is one
    stable sort's, with about 1/4^p of its temporaries (a genome
    shard's single sort needs several times its table beside it).  Returns
    (codes int32, positions int32, n_valid)."""
    m = fl.shape[0]
    codes = torch.zeros(m, dtype=torch.int32, device=fl.device)
    ok = torch.ones(m, dtype=torch.bool, device=fl.device)
    for j in range(k):
        codes.mul_(4)
        codes[: m - j] += torch.clamp_max(fl[j:], 3)
        ok[: m - j] &= fl[j:] < 4
        ok[m - j :] = False
    codes.masked_fill_(~ok, SENT)
    del ok
    p = min(SORT_PREFIX_BASES, k)
    # SENT's prefix is 4^(15-k+p) and more; clamped to 4^p, past every
    # bucket, before it is cut to a byte
    pre = torch.clamp_max(codes >> (2 * (k - p)), 4**p).to(torch.uint8)
    out_c = torch.full((m,), SENT, dtype=torch.int32, device=fl.device)
    out_p = torch.empty(m, dtype=torch.int32, device=fl.device)
    o = 0
    for b in range(4 ** p):
        idx = torch.nonzero(pre == b).squeeze(1)
        c, order = torch.sort(codes[idx], stable=True)
        out_c[o : o + len(idx)] = c
        out_p[o : o + len(idx)] = idx[order]
        o += len(idx)
    out_p[o:] = torch.nonzero(codes == SENT).squeeze(1)
    return out_c, out_p, o


def build_device_tables(flat: np.ndarray, k: int, prefix_bases: int,
                        device) -> tuple[dict, int]:
    """Sorted k-mer table + prefix buckets on ``device``: ``sorted_kmers``
    over the padded flat, bucket starts by bincount + cumsum.
    Returns (dict(starts, codes, pos) of 1-D int32 tensors padded like
    ``as_rows``, n_valid).
    """
    n = len(flat)
    rows = (n + 127) // 128 + 2
    flat_p = np.full(rows * 128, GAP_CODE, np.int8)
    flat_p[:n] = flat
    nb = 4 ** prefix_bases
    shift = 2 * (k - prefix_bases)

    fl = torch.as_tensor(flat_p, device=device)
    scodes, pos, n_valid = sorted_kmers(fl, k)
    prefix = torch.where(scodes < SENT, scodes >> shift, nb).long()
    counts = torch.bincount(prefix, minlength=nb + 1)
    starts = torch.cat([torch.zeros(1, dtype=torch.int64, device=device),
                        torch.cumsum(counts[:nb], dim=0)]).to(torch.int32)
    tables = dict(starts=_as_rows(starts), codes=_as_rows(scodes),
                  pos=_as_rows(pos))
    return tables, n_valid


def host_tables(index: KmerIndex, device) -> dict:
    """The same table layout from a host-built index (``sorted_codes``)."""
    if index.bucket_starts is None:
        index.build_buckets()

    def up(a):
        return _as_rows(torch.as_tensor(np.asarray(a, np.int32),
                                        device=device))

    return dict(starts=up(index.bucket_starts), codes=up(index.sorted_codes),
                pos=up(index.sorted_pos))


def _as_rows(a: torch.Tensor) -> torch.Tensor:
    """Zero-pad a 1-D table like ``as_rows`` (two spare 128-rows), so span
    reads past the end stay in bounds."""
    ln = a.shape[0]
    r = (ln + 127) // 128 + 2
    return torch.cat([a, torch.zeros(r * 128 - ln, dtype=a.dtype,
                                     device=a.device)])
