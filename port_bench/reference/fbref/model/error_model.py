"""Insert-size / read-error model learning.

Replicates the reference's global model learning (Figbird.cpp):

* sufficient statistics  — processMapping/processErrorTypes (846-921, 291-487)
* distribution finalise  — computeProbabilites (497-844)
* per-alignment error probability — computeErrorProb (952-1153)
* acceptance cutoff      — gapProbs histogram 80th percentile
  (computeLikelihood side effect 1312-1322 + main 7155-7178)
* placement insert bounds — mean -/+ 3*one-sided SD, widened by partial read
  length in partial mode (main 7188-7200)

Design: statistics are plain arrays forming a commutative monoid, so they can
be accumulated per device shard and ``psum``-ed across a mesh (replacing the
reference's redundant per-worker re-learning of the same model).  The
finalisation scans are tiny (20k bins) and run on host, identical to the
reference's serial logic.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..dtypes import MAX_INSERT_SIZE_FLOOR, N_BASES


@dataclass
class ModelStats:
    """Commutative sufficient statistics (raw counts, no smoothing)."""

    max_read_length: int
    max_insert_size: int = MAX_INSERT_SIZE_FLOOR
    insert_counts: np.ndarray = None  # (M,) int64
    discarded: int = 0
    error_pos: np.ndarray = None      # (L,) substitutions per cycle
    in_pos: np.ndarray = None
    in_lengths: np.ndarray = None
    del_pos: np.ndarray = None
    del_lengths: np.ndarray = None
    error_types: np.ndarray = None    # (5,5) from->to substitution counts
    base_counts: np.ndarray = None    # (5,)
    read_lengths: np.ndarray = None   # (L,) histogram by (length-1)
    unique_mapped: int = 0

    def __post_init__(self):
        L, M = self.max_read_length, self.max_insert_size
        if self.insert_counts is None:
            self.insert_counts = np.zeros(M, dtype=np.int64)
        for name in ("error_pos", "in_pos", "in_lengths", "del_pos", "del_lengths",
                     "read_lengths"):
            if getattr(self, name) is None:
                setattr(self, name, np.zeros(L, dtype=np.int64))
        if self.error_types is None:
            self.error_types = np.zeros((N_BASES, N_BASES), dtype=np.int64)
        if self.base_counts is None:
            self.base_counts = np.zeros(N_BASES, dtype=np.int64)

    def merge(self, other: "ModelStats") -> "ModelStats":
        assert self.max_read_length == other.max_read_length
        out = ModelStats(self.max_read_length, self.max_insert_size)
        for name in ("insert_counts", "error_pos", "in_pos", "in_lengths",
                     "del_pos", "del_lengths", "error_types", "base_counts",
                     "read_lengths"):
            setattr(out, name, getattr(self, name) + getattr(other, name))
        out.discarded = self.discarded + other.discarded
        out.unique_mapped = self.unique_mapped + other.unique_mapped
        return out


def add_clip_events(st: ModelStats, clip_start: np.ndarray,
                    clip_end: np.ndarray, strand: np.ndarray,
                    lengths: np.ndarray) -> None:
    """Soft clips as insertion events (processErrorTypes tokenises "IDMS^",
    Figbird.cpp:326-353, so 'S' ops count like 'I'): leading clip sits at
    CIGAR index 0 -> cycle 0 (fwd) / len-1 (rev); trailing clip at index
    len-ce -> cycle len-ce (fwd) / ce-1 (rev); length histogram at len-1."""
    Lmax = st.max_read_length
    n = len(clip_start)
    clip_start = np.asarray(clip_start, np.int64)
    clip_end = np.asarray(clip_end, np.int64)
    lengths = np.asarray(lengths, np.int64)
    for sel_clip, cyc_fwd, cyc_rev in (
            (clip_start > 0, np.zeros(n, np.int64), lengths - 1),
            (clip_end > 0, lengths - clip_end, clip_end - 1)):
        if not sel_clip.any():
            continue
        cyc = np.where(strand == 0, cyc_fwd, cyc_rev)[sel_clip]
        st.in_pos += np.bincount(np.clip(cyc, 0, Lmax - 1),
                                 minlength=Lmax)[:Lmax]
    for clip in (clip_start, clip_end):
        cl = clip[clip > 0]
        if cl.size:
            st.in_lengths += np.bincount(np.clip(cl - 1, 0, Lmax - 1),
                                         minlength=Lmax)[:Lmax]


def collect_stats(
    flat_genome: np.ndarray,
    reads_oriented: np.ndarray,  # (n, L) int8, orientation as aligned
    lengths: np.ndarray,
    window_start: np.ndarray,    # (n,) padded-flat window start
    strand: np.ndarray,
    mism: np.ndarray,            # (n, L) bool mismatch mask (oriented coords)
    inserts: np.ndarray,         # (n_pairs,) one per pair (0 => skip)
    contig_len_of_read: np.ndarray | None = None,
    input_mean: float = 0.0,
    max_read_length: int | None = None,
    chunk: int = 65536,
    indel_events: tuple[np.ndarray, np.ndarray] | None = None,
    clip_start: np.ndarray | None = None,
    clip_end: np.ndarray | None = None,
) -> ModelStats:
    """Build sufficient statistics from model-set alignments.

    Mirrors processMapping + processErrorTypes.  ``indel_events``, when
    given, is (ins, del) — each an (E, 3) int array of
    (cycle, length, strand) per I/D event from the banded aligner tier
    (already restricted to model-set reads); they populate
    inPos/inLengths/delPos/delLengths per processErrorTypes
    (Figbird.cpp:339-372: cycle flipped to original-read orientation on the
    reverse strand, length histogram at length-1).  Cycles arrive in
    aligned-read orientation; ``rlen`` for the flip is taken per event as
    column 3 when present, else max_read_length.

    ``clip_start``/``clip_end``: per-read soft-clip lengths.  The reference's
    CIGAR walk treats ``S`` ops exactly like insertions
    (processErrorTypes:339-353 tokenises "IDMS^"), so each clip contributes
    an inPos/inLengths event, and substitution counting is restricted to the
    matched region (MD only covers it).
    """
    n, L = reads_oriented.shape
    Lmax = int(max_read_length or L)
    st = ModelStats(Lmax)
    if clip_start is None:
        clip_start = np.zeros(n, np.int64)
    if clip_end is None:
        clip_end = np.zeros(n, np.int64)
    clip_start = np.asarray(clip_start, np.int64)
    clip_end = np.asarray(clip_end, np.int64)

    add_clip_events(st, clip_start, clip_end, strand, lengths)

    # insert histogram (one entry per pair, contig-length filtered upstream)
    ins = inserts[inserts > 0]
    if contig_len_of_read is not None:
        ins = inserts[(inserts > 0) & (contig_len_of_read > input_mean)]
    st.discarded += int((ins > st.max_insert_size).sum())
    ins = ins[ins <= st.max_insert_size]
    st.insert_counts += np.bincount(
        np.minimum(ins, st.max_insert_size - 1),
        minlength=st.max_insert_size)[: st.max_insert_size]

    st.unique_mapped += n
    st.read_lengths += np.bincount(
        np.clip(lengths - 1, 0, Lmax - 1), minlength=Lmax)[:Lmax]

    if indel_events is not None:
        for ev, pos_hist, len_hist in (
                (indel_events[0], st.in_pos, st.in_lengths),
                (indel_events[1], st.del_pos, st.del_lengths)):
            ev = np.asarray(ev, np.int64).reshape(-1, 4)
            if not len(ev):
                continue
            cyc, ln, ev_strand, rlen = ev.T
            cyc = np.where(ev_strand == 0, cyc, rlen - cyc - 1)
            pos_hist += np.bincount(np.clip(cyc, 0, Lmax - 1),
                                    minlength=Lmax)[:Lmax]
            len_hist += np.bincount(np.clip(ln - 1, 0, Lmax - 1),
                                    minlength=Lmax)[:Lmax]

    for i0 in range(0, n, chunk):
        sl = slice(i0, min(i0 + chunk, n))
        r = reads_oriented[sl]
        lens = lengths[sl]
        # base composition over aligned seq (getLength, Figbird.cpp:255-275):
        # count everything, then remove the N-padding tails (pad code == N)
        # per-code count_nonzero: np.bincount casts the int8 block to intp
        # element-by-element (~140ns/elt); five vectorised compares are ~30x
        bc = np.array([np.count_nonzero(r == c) for c in range(N_BASES)],
                      dtype=np.int64)
        bc[4] -= int((L - lens).sum())
        st.base_counts += bc
        # mismatches are sparse: extract coordinates once; restricted to the
        # matched region [clip_start, len-clip_end) — MD only covers it
        mm_i, mm_j = np.nonzero(mism[sl])
        cs_sl, ce_sl = clip_start[sl], clip_end[sl]
        keep = (mm_j < lens[mm_i] - ce_sl[mm_i]) & (mm_j >= cs_sl[mm_i])
        mm_i, mm_j = mm_i[keep], mm_j[keep]
        # substitution cycle: oriented j for fwd, length-1-j for rev
        cyc = np.where(strand[sl][mm_i] == 0, mm_j, lens[mm_i] - 1 - mm_j)
        cyc = np.clip(cyc, 0, Lmax - 1)
        st.error_pos += np.bincount(cyc, minlength=Lmax)[:Lmax]
        # from (genome) -> to (read) codes at mismatches
        win = flat_genome[window_start[sl][mm_i] + mm_j]
        st.error_types += np.bincount(
            win.astype(np.int64) * N_BASES + r[mm_i, mm_j],
            minlength=N_BASES * N_BASES).reshape(N_BASES, N_BASES)
    return st


@dataclass
class ErrorModel:
    max_read_length: int
    max_insert_size: int
    error_pos_dist: np.ndarray
    in_pos_dist: np.ndarray
    in_length_dist: np.ndarray
    del_pos_dist: np.ndarray
    del_length_dist: np.ndarray
    error_type_probs: np.ndarray  # (5,5) row-normalised
    base_error_rates: np.ndarray  # (5,)
    no_error_probs: np.ndarray    # cumulative P(no event up to cycle i)
    insert_dist: np.ndarray
    insert_dist_smoothed: np.ndarray
    insert_mean: float
    insert_sd: float
    left_sd: float
    right_sd: float
    insert_threshold_min: int
    insert_threshold_max: int
    insert_cutoff_min: int
    insert_cutoff_max: int
    is_conservative: bool
    gap_prob_cutoff: int = 0
    contig_lengths: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))

    def effective_length(self, insert: int) -> int:
        """getEffectiveLength (Figbird.cpp:923-950)."""
        if insert < 0:
            return int(self.contig_lengths.sum())
        d = self.contig_lengths - insert + 1
        return int(d[d > 0].sum())


def _scan_consecutive(counts, start, direction, thresh, need):
    """Find position after `need` consecutive bins <= thresh (reference scans)."""
    run = 0
    i = start
    M = len(counts)
    while 0 <= i < M:
        if counts[i] <= thresh:
            run += 1
            if run == need:
                return i
        else:
            run = 0
        i += direction
    return 0 if direction < 0 else M - 1


def finalize_model(
    st: ModelStats,
    contig_lengths: np.ndarray,
    partial_flag: bool = False,
    partial_len: int = 0,
    window: int = 12,
    sd_coeff: float = 3.0,
) -> ErrorModel:
    """computeProbabilites (Figbird.cpp:497-844) + main thresholds (7188-7200)."""
    L, M = st.max_read_length, st.max_insert_size
    # add-one smoothing exactly as initInsertCounts/initErrorTypes
    counts = st.insert_counts + 1
    et = st.error_types + 1
    bc = st.base_counts + 1
    ep = st.error_pos + 1
    ip = st.in_pos + 1
    il = st.in_lengths + 1
    dp = st.del_pos + 1
    dl = st.del_lengths + 1

    row = et.sum(1)
    error_type_probs = et / row[:, None]
    base_error_rates = row / bc
    s4 = base_error_rates[:4].sum()
    base_error_rates = base_error_rates.astype(np.float64)
    base_error_rates[:4] = 4 * base_error_rates[:4] / s4
    base_error_rates[4] = 1.0

    # reads covering cycle i = suffix sum of length histogram
    covering = np.cumsum(st.read_lengths[::-1])[::-1]
    covering = np.maximum(covering, 1)
    error_pos_dist = ep / covering
    in_pos_dist = ip / covering
    del_pos_dist = dp / covering
    in_length_dist = il / il.sum()
    del_length_dist = dl / dl.sum()

    ins_count = st.discarded + (counts - 1).sum()
    ins_count = max(ins_count, 1)
    idx = np.arange(M, dtype=np.float64)
    insert_mean = float((idx * (counts - 1)).sum() / ins_count)
    insert_dist = counts / ins_count
    insert_var = float((((insert_mean - idx) ** 2) * (counts - 1)).sum() / ins_count)
    insert_sd = float(np.sqrt(insert_var))

    no_error = np.cumprod(1.0 - error_pos_dist - in_pos_dist - del_pos_dist)

    # window-smoothed pmf with floor (Figbird.cpp:646-677)
    sm = insert_dist.copy()
    kernel = np.ones(2 * window + 1) / (2 * window + 1)
    conv = np.convolve(insert_dist, kernel, mode="same")
    sm[window : M - window] = conv[window : M - window]
    sm = sm - 1.0 / ins_count + (1.0 / M) / (ins_count + 1)

    mean_i = int(insert_mean)
    cutoff_max = _scan_consecutive(counts, mean_i, +1, 1, 10)
    cutoff_min = _scan_consecutive(counts, mean_i, -1, 1, 10)
    count_max = int(counts.max())
    thr = max(count_max // 1000, 2)
    threshold_max = _scan_consecutive(counts, mean_i, +1, thr, 2)
    threshold_min = _scan_consecutive(counts, mean_i, -1, thr, 2)

    # one-sided SDs (Figbird.cpp:785-802)
    right = np.arange(mean_i + 1, M)
    cnt_r = (counts[mean_i + 1 :] - 1).astype(np.float64)
    right_sd = float(
        np.sqrt(((right - insert_mean) ** 2 * cnt_r).sum() / max(cnt_r.sum(), 1))
    )
    # reference loop bound is the FLOAT mean (i < insertSizeMean,
    # Figbird.cpp:797), so bin int(mean) itself is included unless the mean
    # is exactly integral
    hi_l = mean_i + 1 if insert_mean > mean_i else mean_i
    lo = max(int(insert_mean - 10 * right_sd), 0)
    left = np.arange(lo, hi_l)
    cnt_l = (counts[lo:hi_l] - 1).astype(np.float64)
    left_sd = float(
        np.sqrt(((insert_mean - left) ** 2 * cnt_l).sum() / max(cnt_l.sum(), 1))
    )
    conservative = right_sd > 1000 or left_sd > 1000

    # final placement bounds (main, Figbird.cpp:7188-7200)
    tmin = max(int(insert_mean - sd_coeff * left_sd), 1)
    tmax = min(int(insert_mean + sd_coeff * right_sd), M)
    if partial_flag:
        tmin -= partial_len
        tmax += partial_len

    return ErrorModel(
        max_read_length=L,
        max_insert_size=M,
        error_pos_dist=error_pos_dist,
        in_pos_dist=in_pos_dist,
        in_length_dist=in_length_dist,
        del_pos_dist=del_pos_dist,
        del_length_dist=del_length_dist,
        error_type_probs=error_type_probs,
        base_error_rates=base_error_rates,
        no_error_probs=no_error,
        insert_dist=insert_dist,
        insert_dist_smoothed=sm,
        insert_mean=insert_mean,
        insert_sd=insert_sd,
        left_sd=left_sd,
        right_sd=right_sd,
        insert_threshold_min=tmin,
        insert_threshold_max=tmax,
        insert_cutoff_min=threshold_min,  # 838-839: cutoffs := thresholds
        insert_cutoff_max=threshold_max,
        is_conservative=conservative,
        contig_lengths=np.asarray(contig_lengths, dtype=np.int64),
    )


def alignment_error_log10(
    model: ErrorModel,
    reads_oriented: np.ndarray,
    lengths: np.ndarray,
    strand: np.ndarray,
    mism: np.ndarray,
    from_codes: np.ndarray,  # (n, L) genome base at each read position
    clip_start: np.ndarray | None = None,
    clip_end: np.ndarray | None = None,
) -> np.ndarray:
    """log10 of computeErrorProb (Figbird.cpp:952-1153) for gapless alignments.

    errorProb = noErrorProbs[len-1] * prod_mismatch[
        errorPosDist[c]/(1-e_c-in_c-del_c) * baseErrorRates[f] * errorTypeProbs[f,t] ]
    where c is the sequencing cycle of the mismatch.

    Clipped reads replicate a reference quirk: computeErrorProb's CIGAR
    tokeniser omits 'S' (1192 — unlike processErrorTypes's), so the clip
    offset never enters its MD position mapping.  A mismatch at read
    position j is evaluated at the UNCLIPPED cycle j-clip_start, with the
    'to' character read[j-clip_start] (the wrong position), and the
    baseErrorRates*errorTypeProbs factor applies only when that shifted
    character differs from the genome base (1104-1143).
    """
    n, L = reads_oriented.shape
    if clip_start is None:
        clip_start = np.zeros(n, np.int64)
    if clip_end is None:
        clip_end = np.zeros(n, np.int64)
    clip_start = np.asarray(clip_start, np.int64)
    clip_end = np.asarray(clip_end, np.int64)
    base = np.log10(
        np.maximum(model.no_error_probs[np.clip(lengths - 1, 0, model.max_read_length - 1)], 1e-300)
    )
    # mismatches are sparse (<1% of positions): evaluate the per-event term
    # only at (read, pos) mismatch coordinates instead of densely over (n, L)
    ii, jj = np.nonzero(mism)
    keep = (jj < lengths[ii] - clip_end[ii]) & (jj >= clip_start[ii])
    ii, jj = ii[keep], jj[keep]
    jp = jj - clip_start[ii]  # MD-relative position (no clip offset)
    cyc = np.where(strand[ii] == 0, jp, lengths[ii] - 1 - jp)
    cyc = np.clip(cyc, 0, model.max_read_length - 1)
    fc = from_codes[ii, jj]
    tc = reads_oriented[ii, jp]  # shifted 'to' char (reference quirk)
    denom = 1.0 - model.error_pos_dist - model.in_pos_dist - model.del_pos_dist
    term = (
        np.log10(model.error_pos_dist[cyc])
        - np.log10(np.maximum(denom[cyc], 1e-300))
        + np.where(
            fc != tc,
            np.log10(model.base_error_rates[fc])
            + np.log10(np.maximum(model.error_type_probs[fc, tc], 1e-300)),
            0.0,
        )
    )
    out = base.astype(np.float64)
    np.add.at(out, ii, term)
    return out


def gap_prob_hist(log10_err2: np.ndarray) -> np.ndarray:
    """gapProbs histogram (Figbird.cpp:1312-1322): gapIndex = int(-log10 p)+1,
    clipped to [0, 999].  Pure counts — summable across hosts."""
    gi = np.floor(-log10_err2).astype(np.int64) + 1
    gi = np.where((gi >= 0) & (gi < 1000), gi, 999)
    return np.bincount(gi, minlength=1000)


def compute_gap_prob_cutoff(
    model: ErrorModel,
    log10_err2: np.ndarray | None = None,
    quantile: float = 0.8,
    hist: np.ndarray | None = None,
) -> int:
    """80th-percentile cutoff from the gapProbs histogram (main 7155-7178).

    ``log10_err2`` is the log10 error probability of each pair's *second*
    mate; pass ``hist`` instead when the histogram was already (all-)reduced.
    """
    if hist is None:
        hist = gap_prob_hist(log10_err2)
    total = hist.sum()
    if total == 0:
        return 4  # conservative default for empty model sets
    csum = np.cumsum(hist)
    cutoff = int(np.argmax(csum >= quantile * total))
    return cutoff
