"""The pipeline (``figbird_tpu/pipeline.py``), on one device.

One iteration = local-align the minimum-insert library against the current
genome, pair, learn the insert/error model on the device, triage clipped
reads into partial bundles, run the batched gap-fill EM and splice.  An
unmapped ('u') iteration also aligns its library end to end against the
gap-bearing scaffolds, relearns the model from that pass's pairs and fills
from the one-anchored pairs' free mates.  ``Pipeline.run`` is the iteration
schedule (RunFigbird.sh:534-775) gated on the remaining-N count, and with a
``workdir`` every iteration writes the reference's artifacts
(``Temp/gapInfo.txt``, ``Individual_gaps/gapout_<n>.txt``,
``Filled_Scaffolds/<n>filledContigs.fa``, ...).  ``mesh`` runs the aligner
and the fill over a device mesh (``parallel.mesh``), ``distributed`` over
several processes (``parallel.distributed``); both give the single-device
results.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field, replace
from pathlib import Path

import numpy as np
import torch

from . import dtypes
from .align import pairing
from .align.core import Aligner, AlignParams, e2e_params, host_flat_ok
from .align.index import build_index
from .combine import combine_gap_history, write_individual_gaps
from .config import INSERT_FRAC
from .fill.draw import render_gap, write_draw_file
from .fill.driver import fill_gaps
from .genome import Genome
from .io.fasta import read_fasta, write_fasta
from .io.fastq import read_fastq
from .model import error_model
from .ops import canonical_device, entry_device
from .parallel import distributed as dist
from .triage import assign
from .utils import trace


@dataclass
class IterationStats:
    itr: int
    mode: str
    lib: int
    n_pairs: int
    n_model: int
    gaps: int
    filled: int
    n_before: int
    n_after: int
    seconds: float
    reads_per_sec: float = 0.0


@dataclass
class PipelineResult:
    genome: object
    iterations: list = field(default_factory=list)
    gap_history: list = field(default_factory=list)  # per itr (gaps, strings, skips)
    combined: list = field(default_factory=list)  # CombinedGap per orig gap

    @property
    def fillmore(self) -> bool:
        return self.iterations[-1].n_after not in (0, self.iterations[-1].n_before) \
            if self.iterations else True


def _oriented_rows(batch, align: dict, rows: np.ndarray) -> np.ndarray:
    """Reference-oriented sequences for a row subset (an index array):
    reverse-strand rows reverse-complemented within their length, the pad
    left N.  A full-length row's is its flipped complement; only shorter
    rows gather by position."""
    seq = batch.seq[rows]
    L = seq.shape[1]
    rev = np.flatnonzero(align["strand"][rows] == 1)
    comp = np.asarray(dtypes.COMPLEMENT, np.int8)
    rc = comp[seq[rev, ::-1]]
    lens = batch.length[rows][rev]
    short = np.flatnonzero(lens < L)
    if short.size:
        src = lens[short, None] - 1 - np.arange(L)[None, :]
        rc[short] = np.where(
            src >= 0, np.take_along_axis(comp[seq[rev[short]]],
                                         np.clip(src, 0, L - 1), axis=1),
            dtypes.GAP_CODE)
    seq[rev] = rc
    return seq


def _flat_windows(flat: np.ndarray, starts: np.ndarray, L: int) -> np.ndarray:
    """``flat[start : start + L]`` for every start, (n, L) int8: rows of a
    strided view of ``flat``, with no (n, L) index array."""
    return np.lib.stride_tricks.sliding_window_view(flat, L)[
        np.asarray(starts, np.int64)]


def _model_indel_events(m, a1, a2, r1, r2):
    """Indel events from the banded tier for model-set reads."""
    ins_ev, del_ev = [], []
    for a, rb in ((a1, r1), (a2, r2)):
        for row, tb in a.get("indel_detail", {}).items():
            if not m[row]:
                continue
            sr, rl = int(a["strand"][row]), int(rb.length[row])
            ins_ev += [(c, n, sr, rl) for c, n in tb["ins_events"]]
            del_ev += [(c, n, sr, rl) for c, n in tb["del_events"]]
    return (np.array(ins_ev, np.int64).reshape(-1, 4),
            np.array(del_ev, np.int64).reshape(-1, 4))


def _learn_model_host(idx, pt, a1, a2, r1, r2, contig_lengths, partial_flag,
                      partial_len, input_mean=0.0, holds_end=True):
    """Host model learning from the alignments' mismatch masks: the path
    of a contig-sharded aligner past ``host_flat_ok``, which has no device
    statistics.  Returns (model, n_model)."""
    m = pt.model
    n_model = int(m.sum())
    rows = np.flatnonzero(m)
    o1m, o2m = _oriented_rows(r1, a1, rows), _oriented_rows(r2, a2, rows)
    reads = np.concatenate([o1m, o2m])
    lens = np.concatenate([r1.length[m], r2.length[m]])
    wins = np.concatenate([a1["pos"][m], a2["pos"][m]]).astype(np.int64)
    strands = np.concatenate([a1["strand"][m], a2["strand"][m]])
    mism = np.concatenate([a1["mism"][m], a2["mism"][m]])
    clips_s = np.concatenate([a1["clip_start"][m], a2["clip_start"][m]])
    clips_e = np.concatenate([a1["clip_end"][m], a2["clip_end"][m]])
    clr = contig_lengths[np.concatenate([pt.contig[m, 0], pt.contig[m, 1]])]
    st = error_model.collect_stats(
        idx.flat, reads, lens, wins, strands, mism,
        inserts=np.concatenate([pt.insert[m], np.zeros(n_model, np.int64)]),
        contig_len_of_read=np.concatenate([clr[:n_model],
                                           np.zeros(n_model)]),
        input_mean=input_mean,
        max_read_length=int(max(r1.seq.shape[1], r2.seq.shape[1])),
        indel_events=_model_indel_events(m, a1, a2, r1, r2),
        clip_start=clips_s, clip_end=clips_e)
    model = error_model.finalize_model(st, contig_lengths,
                                       partial_flag=partial_flag,
                                       partial_len=partial_len)
    # gapProbs histogram from mate-2 error probabilities; the reference's
    # per-pair flush never counts the LAST model pair (Figbird.cpp:1303-1338)
    L2 = r2.seq.shape[1]
    win2 = a2["pos"][m].astype(np.int64)
    from2 = _flat_windows(idx.flat, win2, L2)
    lg2 = error_model.alignment_error_log10(
        model, o2m, r2.length[m], a2["strand"][m], a2["mism"][m], from2,
        clip_start=a2["clip_start"][m], clip_end=a2["clip_end"][m])
    if holds_end and len(lg2):
        lg2 = lg2[:-1]
    hist = error_model.gap_prob_hist(lg2)
    model.gap_prob_cutoff = error_model.compute_gap_prob_cutoff(model,
                                                                hist=hist)
    model.snapshot = (st, hist)
    return model, n_model


def _indel_mism_rows(a: dict, rows: np.ndarray, L: int) -> np.ndarray:
    """Mismatch masks for indel-tier rows from their banded tracebacks."""
    if "mism" in a:
        return a["mism"][rows]
    out = np.zeros((len(rows), L), bool)
    det = a.get("indel_detail", {})
    for i, row in enumerate(rows):
        tb = det.get(int(row))
        if tb is not None:
            mm = np.asarray(tb["mism"], bool)
            n = min(len(mm), L)
            out[i, :n] = mm[:n]
    return out


def _learn_model(idx, pt, a1, a2, r1, r2, contig_lengths, partial_flag,
                 partial_len, aligner=None, input_mean=0.0, holds_end=True):
    """The model from this iteration's alignments: on the device where the
    aligner kept its read batches (``stats_handle``), else on the host.
    ``holds_end``: this process holds the global last read pair (the one
    the gap-prob histogram leaves out).  Returns (model, n_model)."""
    if int(np.asarray(pt.model).sum()) == 0:
        return None, 0
    if aligner is not None and "stats_handle" in a1 \
            and "stats_handle" in a2:
        return _learn_model_device(idx, pt, a1, a2, r1, r2, contig_lengths,
                                   partial_flag, partial_len, aligner,
                                   input_mean, holds_end)
    return _learn_model_host(idx, pt, a1, a2, r1, r2, contig_lengths,
                             partial_flag, partial_len, input_mean, holds_end)


def _learn_model_device(idx, pt, a1, a2, r1, r2, contig_lengths,
                        partial_flag, partial_len, aligner, input_mean=0.0,
                        holds_end=True):
    """Device-side model learning over the aligner's resident read batches
    (sufficient statistics as masked device sums; the rare indel-tier rows
    go through the host ``collect_stats``), the statistics all-reduced
    across processes.  Returns (model, n_model)."""
    m = np.asarray(pt.model)
    n_model = int(m.sum())
    Lmax = int(max(r1.seq.shape[1], r2.seq.shape[1]))
    st = error_model.ModelStats(Lmax)

    ins = np.asarray(pt.insert)[m]
    clr = contig_lengths[np.asarray(pt.contig)[m, 0]]
    insv = ins[(ins > 0) & (clr > input_mean)]
    st.discarded += int((insv > st.max_insert_size).sum())
    insv = insv[insv <= st.max_insert_size]
    st.insert_counts += np.bincount(
        np.minimum(insv, st.max_insert_size - 1),
        minlength=st.max_insert_size)[: st.max_insert_size]

    zero = np.zeros(len(m), bool)
    jobs = []
    for a in (a1, a2):
        indel = np.asarray(a.get("indel", zero))
        jobs.append((a["stats_handle"], a["pos"], a["strand"], m & ~indel,
                     a["clip_start"], a["clip_end"]))
    dsums = aligner.model_stats_pair(jobs)
    for (a, rb), dsum in zip(((a1, r1), (a2, r2)), dsums):
        indel = np.asarray(a.get("indel", zero))
        dev_mask = m & ~indel
        L = rb.seq.shape[1]
        st.error_pos[:L] += np.asarray(dsum["error_pos"], np.int64)[:L]
        st.error_types += np.asarray(dsum["error_types"], np.int64)
        st.base_counts += np.asarray(dsum["base_counts"], np.int64)
        st.unique_mapped += int(dsum["n"])
        st.read_lengths += np.bincount(
            np.clip(rb.length[dev_mask] - 1, 0, Lmax - 1),
            minlength=Lmax)[:Lmax]
        error_model.add_clip_events(st, a["clip_start"][dev_mask],
                                    a["clip_end"][dev_mask],
                                    a["strand"][dev_mask],
                                    rb.length[dev_mask])
        rows = np.flatnonzero(m & indel)
        if rows.size:  # indel rows: host stats from the banded tracebacks
            sti = error_model.collect_stats(
                idx.flat, _oriented_rows(rb, a, rows), rb.length[rows],
                a["pos"][rows].astype(np.int64), a["strand"][rows],
                _indel_mism_rows(a, rows, L),
                inserts=np.zeros(rows.size, np.int64),
                max_read_length=Lmax,
                clip_start=a["clip_start"][rows],
                clip_end=a["clip_end"][rows])
            st = st.merge(sti)

    ins_ev, del_ev = _model_indel_events(m, a1, a2, r1, r2)
    for ev, pos_hist, len_hist in ((ins_ev, st.in_pos, st.in_lengths),
                                   (del_ev, st.del_pos, st.del_lengths)):
        if not len(ev):
            continue
        cyc, ln, ev_strand, rlen = ev.T
        cyc = np.where(ev_strand == 0, cyc, rlen - cyc - 1)
        pos_hist += np.bincount(np.clip(cyc, 0, Lmax - 1),
                                minlength=Lmax)[:Lmax]
        len_hist += np.bincount(np.clip(ln - 1, 0, Lmax - 1),
                                minlength=Lmax)[:Lmax]
    # merge point #1: the statistics all-reduced across processes before
    # finalisation, so the model is learned once, globally
    st = dist.allreduce_stats(st)
    if dist.is_distributed():
        n_model = int(sum(dist.allgather_obj(n_model)))
    model = error_model.finalize_model(st, contig_lengths,
                                       partial_flag=partial_flag,
                                       partial_len=partial_len)

    # gapProbs histogram from mate-2 error probabilities; the reference's
    # per-pair flush never counts the LAST model pair (Figbird.cpp:1303-
    # 1338): the process holding the global end of the read set drops it
    indel2 = np.asarray(a2.get("indel", zero))
    m_hist = m
    if holds_end and m.any():
        m_hist = m.copy()
        m_hist[np.flatnonzero(m)[-1]] = False
    lg = aligner.model_err_log10(a2["stats_handle"], a2["pos"], a2["strand"],
                                 m & ~indel2, model, clip_s=a2["clip_start"],
                                 clip_e=a2["clip_end"])
    vals = lg[m_hist & ~indel2]
    rows2 = np.flatnonzero(m_hist & indel2)
    if rows2.size:
        L2 = r2.seq.shape[1]
        from2 = _flat_windows(idx.flat, a2["pos"][rows2], L2)
        vals = np.concatenate([vals, error_model.alignment_error_log10(
            model, _oriented_rows(r2, a2, rows2), r2.length[rows2],
            a2["strand"][rows2], _indel_mism_rows(a2, rows2, L2), from2,
            clip_start=a2["clip_start"][rows2],
            clip_end=a2["clip_end"][rows2])])
    hist = error_model.gap_prob_hist(vals)
    if dist.is_distributed():
        hist = np.sum(dist.allgather_obj(hist), axis=0)
    model.gap_prob_cutoff = error_model.compute_gap_prob_cutoff(model,
                                                                hist=hist)
    model.snapshot = (st, hist)
    return model, n_model


class Pipeline:
    """Stateful pipeline over an in-memory genome + read libraries.
    ``device=None`` is the card, and an error where there is none;
    ``device="cpu"`` asks for the CPU, where the kernels' plain versions
    run.  ``workdir``: where each iteration writes its artifacts and
    ``run`` the combined gaps and the final assembly (the output tree of
    RunFigbird.sh).

    ``mesh`` (``parallel.make_mesh``): alignment batches and fill instances
    split over its reads axis; a genome axis above 1 shards the index
    (``aligner_kwargs["genome_shard"]``).  ``device`` is then the mesh's
    first device.  ``distributed``: each process keeps a contiguous shard
    of every read library, learns the model through an all-reduce of the
    statistics, unions the per-gap bundles, fills a strided gap subset and
    all-gathers the strings (default: on when a process group of more than
    one process is initialised).  Either gives the single-device results
    bit for bit."""

    def __init__(self, cfg, genome, libs, align_params: AlignParams =
                 AlignParams(), min_model_pairs: int = 500,
                 use_read_reduction: bool = True,
                 fill_kwargs: dict | None = None,
                 aligner_kwargs: dict | None = None, device=None,
                 workdir=None, mesh=None, distributed: bool | None = None):
        cfg.validate()
        self.cfg = cfg
        if mesh is not None:
            if device is not None and canonical_device(device) != mesh.first:
                raise ValueError(f"device {device} is not the mesh's first "
                                 f"device {mesh.first}")
            device = mesh.first
        self.device = entry_device(device)
        self.mesh = mesh
        self.dist = dist.is_distributed() if distributed is None \
            else distributed
        self.genome = genome
        self.libs = []
        self._holds_end: list[bool] = []  # owns the global last read pair
        for lib, (r1, r2) in zip(cfg.read_pairs, libs):
            if lib.is_reverse:  # RC both files of RF libraries
                r1, r2 = r1.revcomp(), r2.revcomp()
            holds_end = True
            if self.dist:  # host-level read decomposition
                n_total = len(r1)
                sl = dist.shard_reads(n_total)
                holds_end = sl.stop == n_total and sl.start < n_total
                keep = np.arange(sl.start, sl.stop)
                r1, r2 = r1.take(keep), r2.take(keep)
            self.libs.append((r1, r2))
            self._holds_end.append(holds_end)
        self.workdir = Path(workdir) if workdir else None
        if self.workdir:
            for d in ("Filled_Scaffolds", "Individual_gaps", "Temp"):
                (self.workdir / d).mkdir(parents=True, exist_ok=True)
        self.align_params = align_params
        self.min_model_pairs = min_model_pairs
        self.fill_kwargs = fill_kwargs or {}
        self.aligner_kwargs = aligner_kwargs or {}
        self.use_read_reduction = use_read_reduction
        self._reduced: set[int] = set()
        self.itr = 0
        self.saved_model = None
        self.saved_n_model = 0
        self.result = PipelineResult(genome)
        self._aligned_reads = 0
        self._align_seconds = 0.0
        self.timer = trace.StageTimer()

    def _align_lib(self, genome, lib_i: int, max_insert: int,
                   end_to_end: bool = False):
        """``end_to_end=True`` is the unmapped-pass preset: default (not
        local) bowtie2 semantics with the maxD2 insert bound — no soft
        clips, so the pass's model set excludes clipped reads."""
        r1, r2 = self.libs[lib_i]
        t0 = time.time()
        gshard = self.mesh is not None and self.mesh.shape["genome"] > 1
        # contig-range shards build their local tables from the flat alone:
        # no host sort of the global table (code-range shards need it)
        total_bases = sum(int(n) for n in genome.lengths)
        contig_big = gshard and (
            self.aligner_kwargs.get("genome_shard") == "contig"
            or not host_flat_ok(total_bases))
        idx = build_index(genome, k=15,
                          device_tables=(not gshard) or contig_big)
        self.timer.add("index_build", time.time() - t0)
        params = e2e_params(self.align_params) if end_to_end \
            else self.align_params
        # model learning runs on the device: no mismatch-mask copy, unless
        # the genome is past the replicated flat's budget (host learning)
        if host_flat_ok(total_bases):
            params = replace(params, want_mism=False)
        t0 = time.time()
        al = Aligner(idx, params, device=self.device, mesh=self.mesh,
                     **self.aligner_kwargs)
        self.timer.add("aligner_init", time.time() - t0)
        t0 = time.time()
        a1, a2 = al.align_many([(r1.seq, r1.length), (r2.seq, r2.length)],
                               keep_stats=True)
        self._align_seconds += time.time() - t0
        self._aligned_reads += 2 * len(r1)
        t0 = time.time()
        pt = pairing.build_pair_table(idx, a1, a2, r1.length, r2.length,
                                      max_insert)
        self.timer.add("pair_table", time.time() - t0)
        return idx, a1, a2, pt, al

    @staticmethod
    def _refinalize(model, genome, partial_flag: bool, partial_len: int):
        """Re-derive a model from its saved snapshot under this
        iteration's flags."""
        st, hist = getattr(model, "snapshot", (None, None))
        if st is None:
            return model
        out = error_model.finalize_model(st, genome.lengths,
                                         partial_flag=partial_flag,
                                         partial_len=partial_len)
        out.gap_prob_cutoff = error_model.compute_gap_prob_cutoff(out,
                                                                  hist=hist)
        out.snapshot = (st, hist)
        return out

    @staticmethod
    def _reduction_keep(pt) -> np.ndarray:
        """Read-reduction keep mask: later iterations drop perfect-cigar
        concordant pairs."""
        clipped = (pt.clip_start > 0) | (pt.clip_end > 0)
        return ~(pt.concordant & ~clipped[:, 0] & ~clipped[:, 1])

    def _unmapped_pass(self, genome, gaps, bundles, lib_i: int, model,
                       partial_len: int):
        """The 'u' iteration's second pass: align library ``lib_i`` end to
        end (against the gap-bearing scaffolds only, unless it is a jump
        library), relearn the model from that pass's own pairs (else fall
        back to iteration 1's snapshot), and add the one-anchored pairs'
        free mates to ``bundles`` in place.  Returns (model, pair table)."""
        cfgp = self.cfg.parameters
        t_lib = self.cfg.read_pairs[lib_i]
        maxD2 = int(t_lib.avg_insert_size * INSERT_FRAC)
        genome2, gaps2, remap = genome, gaps, None
        if not t_lib.is_jump:
            genome2, remap = genome.reduce_to_gapped()
            gaps2 = genome2.find_gaps()
        with self.timer.stage("align_e2e", 2 * len(self.libs[lib_i][0])):
            idx2, b1, b2, pt2, al2 = self._align_lib(
                genome2, lib_i, maxD2, end_to_end=True)
        self.last_alignments_e2e = (b1, b2)
        with self.timer.stage("model_e2e"):
            # the model relearn from the end-to-end pass's own pairs; its
            # measured insert mean drives the triage's insert geometry
            read_mean = float(t_lib.avg_insert_size)
            m2, nm2 = _learn_model(
                idx2, pt2, b1, b2, *self.libs[lib_i], genome2.lengths,
                partial_flag=False, partial_len=partial_len, aligner=al2,
                input_mean=(t_lib.avg_insert_size if cfgp.set_inputmean
                            else 0.0), holds_end=self._holds_end[lib_i])
            if m2 is not None and nm2 >= self.min_model_pairs:
                model = m2
                if maxD2 > 250:
                    read_mean = float(m2.insert_mean)
            elif self.saved_model is not None:
                # too few pairs: iteration 1's snapshot
                model = self._refinalize(self.saved_model, genome, False,
                                         partial_len)
        with self.timer.stage("triage_e2e"):
            tri2 = assign.Triage(gaps2, max_distance=maxD2,
                                 read_mean=read_mean, is_jump=t_lib.is_jump)
            tri2.collect_unmapped(pt2, *self.libs[lib_i])
        u_bundles = tri2.bundles
        if self.dist:  # merge point #2a: the processes' bundles unioned
            u_bundles = dist.merge_bundles(u_bundles)
        # the reduced genome keeps whole gap-bearing contigs in order, so
        # its gap list is the full one with contigs renumbered: check that
        if remap is not None:
            if len(gaps2) != len(gaps):
                raise RuntimeError(f"reduced genome gap count {len(gaps2)} "
                                   f"!= full genome {len(gaps)}")
            for g2, g in zip(gaps2, gaps):
                if (int(remap[g2.contig]) != g.contig or g2.start != g.start
                        or g2.length != g.length):
                    raise RuntimeError(
                        "reduced<->full gap correspondence broken: reduced "
                        f"({g2.contig},{g2.start},{g2.length}) -> contig "
                        f"{int(remap[g2.contig])} vs full ({g.contig},"
                        f"{g.start},{g.length})")
        for bu, b in zip(u_bundles, bundles):
            b.u_seq, b.u_pos, b.u_rev = bu.u_seq, bu.u_pos, bu.u_rev
        return model, pt2

    def run_iteration(self, mode: str, lib_i: int) -> IterationStats:
        """One filling iteration; mode 'p' (partial) or 'u' (unmapped, on
        library ``lib_i``)."""
        if mode not in ("p", "u"):
            raise ValueError(f"mode {mode!r}: expected 'p' or 'u'")
        self.itr += 1
        t0 = time.time()
        cfgp = self.cfg.parameters
        genome = self.genome
        if self.itr == 1 and cfgp.trim_len > 0:
            genome = genome.flank_trim(
                cfgp.trim_len, self.cfg.read_pairs[lib_i].max_read_length)
        n_before = genome.count_n()
        gaps = genome.find_gaps()

        mi = self.cfg.min_isz_index
        m_lib = self.cfg.read_pairs[mi]
        maxD1 = m_lib.avg_insert_size
        with self.timer.stage("align", 2 * len(self.libs[mi][0])):
            idx, a1, a2, pt, al = self._align_lib(genome, mi, maxD1)
        partial_len = m_lib.max_read_length
        r1, r2 = self.libs[mi]
        with self.timer.stage("model"):
            if self.itr > 1 and self.saved_model is not None:
                # iterations > 1 use iteration 1's snapshot (the reduced
                # read set would starve the model); unmapped iterations
                # replace it with the end-to-end pass's model below
                model = self._refinalize(self.saved_model, genome,
                                         mode == "p", partial_len)
                n_model = self.saved_n_model
            else:
                model, n_model = _learn_model(
                    idx, pt, a1, a2, r1, r2, genome.lengths,
                    partial_flag=(mode == "p"), partial_len=partial_len,
                    aligner=al, input_mean=(m_lib.avg_insert_size
                                            if cfgp.set_inputmean else 0.0),
                    holds_end=self._holds_end[mi])
                if model is None or n_model < self.min_model_pairs:
                    model = self.saved_model
                    if model is None:
                        raise RuntimeError(
                            "no model could be learned (too few pairs)")
                    model = self._refinalize(model, genome, mode == "p",
                                             partial_len)
                    n_model = self.saved_n_model
                elif self.saved_model is None:
                    self.saved_model = model  # the iteration-1 snapshot
                    self.saved_n_model = n_model
        # the aligner's device copies go before the unmapped pass builds its
        # own (a human-scale contig-sharded index holds about 20 GB)
        del al

        with self.timer.stage("triage"):
            tri = assign.Triage(gaps, max_distance=maxD1,
                                read_mean=m_lib.avg_insert_size,
                                is_jump=False)
            tri.collect_partial(pt, r1, r2, align1=a1, align2=a2)
        bundles = tri.bundles
        if self.dist:  # merge point #2a: the processes' bundles unioned
            bundles = dist.merge_bundles(bundles)
        n_pairs = len(r1)
        reductions = {}
        if self.use_read_reduction and mi not in self._reduced:
            reductions[mi] = self._reduction_keep(pt)
        self.last_alignments = (a1, a2)

        if mode == "u":
            model, pt2 = self._unmapped_pass(genome, gaps, bundles, lib_i,
                                             model, partial_len)
            n_pairs += len(self.libs[lib_i][0])
            if (self.use_read_reduction and lib_i != mi
                    and lib_i not in self._reduced):
                reductions[lib_i] = self._reduction_keep(pt2)
        self.last_model = model

        with self.timer.stage("fill", len(gaps)):
            fill_kw = dict(partial_mode=(mode == "p"),
                           partial_len=partial_len,
                           neg_overlap=cfgp.gaplen_negative_overlap,
                           device=self.device, mesh=self.mesh,
                           **self.fill_kwargs)
            if self.dist and len(gaps):
                # merge point #2b: each process fills a strided gap subset
                # and the strings are all-gathered
                sub = dist.my_gap_subset(len(gaps))
                res = fill_gaps(genome, [gaps[i] for i in sub],
                                [bundles[i] for i in sub], model, **fill_kw)
                mine = {int(gi): (res.gap_strings[k], int(res.gaptofill[k]))
                        for k, gi in enumerate(sub)}
                allv = dist.allgather_gap_strings(len(gaps), mine)
                res.gap_strings = [v[0] for v in allv]
                res.gaptofill = np.asarray([v[1] for v in allv], np.int64)
                res.placements = None  # per-process partial; not meaningful
                res.mim = None
            else:
                res = fill_gaps(genome, gaps, bundles, model, **fill_kw)
        with self.timer.stage("splice"):
            new_genome = genome.splice_gaps(gaps, res.gap_strings,
                                            list(res.gaptofill))
        n_after = new_genome.count_n()
        self.genome = new_genome
        self.result.genome = new_genome
        self.result.gap_history.append((gaps, res.gap_strings, res.gaptofill))
        self.last_fill_stats = res.stats

        for i, keep in reductions.items():
            ra, rb = self.libs[i]
            self.libs[i] = (ra.take(keep), rb.take(keep))
            self._reduced.add(i)

        if self.workdir:
            self._write_artifacts(gaps, res, new_genome, genome)

        stats = IterationStats(
            itr=self.itr, mode=mode, lib=lib_i, n_pairs=n_pairs,
            n_model=n_model, gaps=len(gaps), filled=res.stats["filled"],
            n_before=n_before, n_after=n_after, seconds=time.time() - t0)
        self.result.iterations.append(stats)
        return stats

    def _write_artifacts(self, gaps, res, new_genome, old_genome):
        wd = self.workdir
        with open(wd / "Temp" / "gapInfo.txt", "w") as fh:
            for g in gaps:
                fh.write(f"{g.contig}\t{g.start}\t{g.length}\n")
        # interop stat files (Preprocess.cpp:2624-2629; FillGaps gaploads):
        # totalCount unCount maxReadLength MAX_FRAGMENT_SIZE; per-gap
        # gaptofill/perfect-read flags; the bucket assignment replaces the
        # thread loads
        mlib = self.cfg.read_pairs[self.cfg.min_isz_index]
        n_reads = 2 * sum(len(a) for a, _ in self.libs)
        (wd / "Temp" / "stat.txt").write_text(
            f"{n_reads} 0 {mlib.max_read_length} "
            f"{max(20000, 2 * mlib.avg_insert_size + 1)}")
        # gaptofill, perfectread_gap, perfectread_gaplen (Preprocess.cpp:
        # 2626-2629) — the MIM flags from plan_gaps/the banded tier
        mim = res.mim if res.mim is not None else np.zeros((len(gaps), 2),
                                                           np.int64)
        with open(wd / "Temp" / "stat2.txt", "w") as fh:
            for i, g in enumerate(gaps):
                fh.write(f"{int(res.gaptofill[i])}\t{int(mim[i, 0])}\t"
                         f"{int(mim[i, 1])}\n")
        with open(wd / "Temp" / "gaploads.txt", "w") as fh:
            shapes = res.stats.get("bucket_shapes", {})
            fh.write(f"{len(shapes)}\n")
            for key, cnt in shapes.items():
                fh.write(f"{key}\t{cnt}\n")
        if res.placements is not None:
            recs = []
            for i, (g, s) in enumerate(zip(gaps, res.gap_strings)):
                pl = res.placements[i]
                if not pl:
                    continue
                contig = old_genome.contigs[g.contig]
                lf = contig[max(g.start - 30, 0) : g.start]
                rf = contig[g.start + g.length : g.start + g.length + 30]
                recs.append(render_gap(i, g, s, pl, lf, rf))
            write_draw_file(
                wd / "Individual_gaps" / f"alignment_{self.itr}.txt", recs)
        with open(wd / "Individual_gaps" / f"gapout_{self.itr}.txt", "w") as fh:
            for i, (g, s) in enumerate(zip(gaps, res.gap_strings)):
                seq = dtypes.decode(s) if len(s) else ""
                fh.write(f"{i}\t{g.contig}\t{g.start}\t{g.length}\t{len(s)}\t{seq}\n")
        write_fasta(wd / "Filled_Scaffolds" / f"{self.itr}filledContigs.fa",
                    new_genome.to_fasta())
        fillmore = 0 if new_genome.count_n() == 0 else 1
        (wd / "Temp" / "Ncount.txt").write_text(str(fillmore))

    def run(self, max_iterations: int | None = None) -> PipelineResult:
        """Full schedule (RunFigbird.sh:534-775)."""
        cfg = self.cfg
        libs = cfg.read_pairs
        done = 0
        budget = max_iterations or 16

        def do(mode, lib_i) -> bool:
            nonlocal done
            if done >= budget:
                return False
            self.run_iteration(mode, lib_i)
            done += 1
            return self.result.fillmore

        if cfg.parameters.default == 1:
            frag = [i for i, l in enumerate(libs) if not l.is_jump]
            jump = [i for i, l in enumerate(libs) if l.is_jump]
            if len(libs) == 2 and len(frag) == 1 and len(jump) == 1:
                # two-lib special case (534-595): 1p, 2u, 1p, 1u, 3p
                seq = ([("p", frag[0])] + [("u", jump[0])] * 2
                       + [("p", frag[0])] + [("u", jump[0])]
                       + [("p", frag[0])] * 3)
            else:
                p_libs = frag if frag else jump
                seq = []
                for i in jump:
                    seq += [("u", i)] * 2
                for i in p_libs:
                    seq += [("p", i)] * 2
                for i in jump:
                    seq += [("u", i)]
                for i in p_libs:
                    seq += [("p", i)] * 3
        else:
            order = sorted(range(len(libs)), key=lambda i: libs[i].serial_num)
            seq = []
            for i in order:
                for o in libs[i].order:
                    n = (libs[i].num_itr_partial if o == "p"
                         else libs[i].num_itr_unmapped)
                    seq += [(o, i)] * n

        for mode, lib_i in seq:
            if not do(mode, lib_i):
                break

        # final combine + copy (RunFigbird.sh:777-781, CombineGaps.cpp)
        self.result.combined = combine_gap_history(self.result.gap_history)
        if self.workdir:
            write_individual_gaps(self.workdir / "Individual_gaps.txt",
                                  self.result.combined)
            with open(self.workdir / "Temp" / "combined_gapstring.txt", "w") as fh:
                for i, cg in enumerate(self.result.combined):
                    fh.write(f"{i}\t{len(cg.seq)}\t{dtypes.decode(cg.seq)}\n")
            write_fasta(self.workdir / "FilledScaffolds_final.fa",
                        self.genome.to_fasta())
        return self.result


def run_from_config(cfg, workdir: str | Path | None = None,
                    **kwargs) -> PipelineResult:
    """Read the config's draft and libraries and run the whole schedule;
    ``kwargs`` (``device``, ``fill_kwargs``, ...) go to :class:`Pipeline`."""
    genome = Genome.from_fasta(read_fasta(cfg.draft_genome))
    libs = [(read_fastq(l.path_1), read_fastq(l.path_2)) for l in cfg.read_pairs]
    pipe = Pipeline(cfg, genome, libs, workdir=workdir, **kwargs)
    return pipe.run()
