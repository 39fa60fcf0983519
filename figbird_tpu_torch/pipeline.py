"""Partial-mode pipeline iteration (``figbird_tpu/pipeline.py``).

One iteration = local-align the minimum-insert library against the current
genome, pair, learn the insert/error model on the device, triage clipped
reads into partial bundles, run the batched gap-fill EM and splice.  The
unmapped mode, the iteration schedule, the mesh and multi-host options are
later slices of the port and raise ``NotImplementedError``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field, replace

import numpy as np
import torch

from . import dtypes
from .align import pairing
from .align.core import Aligner, AlignParams
from .align.index import build_index
from .fill.driver import fill_gaps
from .model import error_model
from .ops import entry_device
from .triage import assign
from .utils import trace

_LATER = ("is not ported yet; see ROADMAP.md, queue 1 (the port runs "
          "partial-mode iterations on one device)")


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


def _oriented_rows(batch, align: dict, rows: np.ndarray) -> np.ndarray:
    """Reference-oriented sequences for a row subset."""
    seq = batch.seq[rows]
    lens = batch.length[rows]
    st = align["strand"][rows]
    n, L = seq.shape
    comp = np.asarray(dtypes.COMPLEMENT, np.int8)[seq]
    src = lens[:, None] - 1 - np.arange(L)[None, :]
    rc = np.where(src >= 0,
                  np.take_along_axis(comp, np.clip(src, 0, L - 1), axis=1),
                  dtypes.GAP_CODE).astype(np.int8)
    return np.where(st[:, None] == 1, rc, seq)


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
                 partial_len, aligner, input_mean=0.0):
    """Device-side model learning over the aligner's resident read batches
    (sufficient statistics as masked device sums; the rare indel-tier rows
    go through the host ``collect_stats``).  Returns (model, n_model)."""
    m = np.asarray(pt.model)
    n_model = int(m.sum())
    if n_model == 0:
        return None, 0
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
    model = error_model.finalize_model(st, contig_lengths,
                                       partial_flag=partial_flag,
                                       partial_len=partial_len)

    # gapProbs histogram from mate-2 error probabilities; the reference's
    # per-pair flush never counts the LAST model pair (Figbird.cpp:1303-1338)
    indel2 = np.asarray(a2.get("indel", zero))
    m_hist = m.copy()
    m_hist[np.flatnonzero(m)[-1]] = False
    lg = aligner.model_err_log10(a2["stats_handle"], a2["pos"], a2["strand"],
                                 m & ~indel2, model, clip_s=a2["clip_start"],
                                 clip_e=a2["clip_end"])
    vals = lg[m_hist & ~indel2]
    rows2 = np.flatnonzero(m_hist & indel2)
    if rows2.size:
        L2 = r2.seq.shape[1]
        from2 = idx.flat[a2["pos"][rows2].astype(np.int64)[:, None]
                         + np.arange(L2)[None, :]]
        vals = np.concatenate([vals, error_model.alignment_error_log10(
            model, _oriented_rows(r2, a2, rows2), r2.length[rows2],
            a2["strand"][rows2], _indel_mism_rows(a2, rows2, L2), from2,
            clip_start=a2["clip_start"][rows2],
            clip_end=a2["clip_end"][rows2])])
    hist = error_model.gap_prob_hist(vals)
    model.gap_prob_cutoff = error_model.compute_gap_prob_cutoff(model,
                                                                hist=hist)
    model.snapshot = (st, hist)
    return model, n_model


class Pipeline:
    """Stateful pipeline over an in-memory genome + read libraries, on one
    device.  ``device=None`` is the card, and an error where there is none;
    ``device="cpu"`` asks for the CPU, where the kernels' plain versions
    run."""

    def __init__(self, cfg, genome, libs, align_params: AlignParams =
                 AlignParams(), min_model_pairs: int = 500,
                 use_read_reduction: bool = True,
                 fill_kwargs: dict | None = None,
                 aligner_kwargs: dict | None = None, device=None,
                 workdir=None, mesh=None, distributed: bool | None = None):
        if workdir is not None or mesh is not None or distributed:
            raise NotImplementedError(
                "artifacts, mesh and multi-host execution " + _LATER)
        cfg.validate()
        self.cfg = cfg
        self.device = entry_device(device)
        self.genome = genome
        self.libs = []
        for lib, (r1, r2) in zip(cfg.read_pairs, libs):
            if lib.is_reverse:  # RC both files of RF libraries
                r1, r2 = r1.revcomp(), r2.revcomp()
            self.libs.append((r1, r2))
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

    def _align_lib(self, genome, lib_i: int, max_insert: int):
        r1, r2 = self.libs[lib_i]
        t0 = time.time()
        idx = build_index(genome, k=15, device_tables=True)
        self.timer.add("index_build", time.time() - t0)
        # model learning runs on the device: no mismatch-mask copy
        params = replace(self.align_params, want_mism=False)
        t0 = time.time()
        al = Aligner(idx, params, device=self.device, **self.aligner_kwargs)
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

    def run_iteration(self, mode: str, lib_i: int) -> IterationStats:
        """One partial-mode ('p') filling iteration."""
        if mode != "p":
            raise NotImplementedError(f"mode {mode!r} " + _LATER)
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
                model = self._refinalize(self.saved_model, genome, True,
                                         partial_len)
                n_model = self.saved_n_model
            else:
                model, n_model = _learn_model(
                    idx, pt, a1, a2, r1, r2, genome.lengths,
                    partial_flag=True, partial_len=partial_len, aligner=al,
                    input_mean=(m_lib.avg_insert_size
                                if cfgp.set_inputmean else 0.0))
                if model is None or n_model < self.min_model_pairs:
                    model = self.saved_model
                    if model is None:
                        raise RuntimeError(
                            "no model could be learned (too few pairs)")
                    model = self._refinalize(model, genome, True,
                                             partial_len)
                    n_model = self.saved_n_model
                elif self.saved_model is None:
                    self.saved_model = model  # the iteration-1 snapshot
                    self.saved_n_model = n_model
        self.last_model = model

        with self.timer.stage("triage"):
            tri = assign.Triage(gaps, max_distance=maxD1,
                                read_mean=m_lib.avg_insert_size,
                                is_jump=False)
            tri.collect_partial(pt, r1, r2, align1=a1, align2=a2)
        reductions = {}
        if self.use_read_reduction and mi not in self._reduced:
            reductions[mi] = self._reduction_keep(pt)

        with self.timer.stage("fill", len(gaps)):
            res = fill_gaps(genome, gaps, tri.bundles, model,
                            partial_mode=True, partial_len=partial_len,
                            neg_overlap=cfgp.gaplen_negative_overlap,
                            device=self.device, **self.fill_kwargs)
        with self.timer.stage("splice"):
            new_genome = genome.splice_gaps(gaps, res.gap_strings,
                                            list(res.gaptofill))
        n_after = new_genome.count_n()
        self.genome = new_genome
        self.result.genome = new_genome
        self.result.gap_history.append((gaps, res.gap_strings, res.gaptofill))
        self.last_fill_stats = res.stats
        self.last_alignments = (a1, a2)

        for i, keep in reductions.items():
            ra, rb = self.libs[i]
            self.libs[i] = (ra.take(keep), rb.take(keep))
            self._reduced.add(i)

        stats = IterationStats(
            itr=self.itr, mode=mode, lib=lib_i, n_pairs=len(r1),
            n_model=n_model, gaps=len(gaps), filled=res.stats["filled"],
            n_before=n_before, n_after=n_after, seconds=time.time() - t0)
        self.result.iterations.append(stats)
        return stats
