"""The port's own copies of the numpy host modules against the originals in
figbird_tpu, on seeded inputs: every result must be equal, entry for entry.
The alignments that the pair table, the triage and the model statistics are
fed come from the port's aligner on the CPU (held against the reference's in
test_torch_align.py), so no XLA program is compiled here.  The run's host
modules (gap combination, placement drawings, checkpoints, evaluation) and
the native C++ data path are held the same way."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import figbird_tpu.combine as r_combine
import figbird_tpu.evalx as r_evalx
import figbird_tpu.simulate as r_sim
import figbird_tpu.utils.checkpoint as r_ckpt
import figbird_tpu_torch.combine as t_combine
import figbird_tpu_torch.evalx as t_evalx
import figbird_tpu_torch.simulate as t_sim
import figbird_tpu_torch.utils.checkpoint as t_ckpt
from figbird_tpu.align.index import build_index as r_build_index
from figbird_tpu.align.pairing import build_pair_table as r_build_pair_table
from figbird_tpu.fill import draw as r_draw
from figbird_tpu.genome import GapInfo as r_GapInfo
from figbird_tpu.genome import Genome as r_Genome
from figbird_tpu.io import read_fasta as r_read_fasta
from figbird_tpu.io import read_fastq as r_read_fastq
from figbird_tpu.io import write_fasta, write_fastq
from figbird_tpu.model import error_model as r_model
from figbird_tpu.triage.assign import Triage as r_Triage
from figbird_tpu_torch import convert
from figbird_tpu_torch.align.core import Aligner, AlignParams
from figbird_tpu_torch.align.index import build_index as t_build_index
from figbird_tpu_torch.align.pairing import build_pair_table \
    as t_build_pair_table
from figbird_tpu_torch.fill import draw as t_draw
from figbird_tpu_torch.io import native as t_native
from figbird_tpu_torch.io.fasta import read_fasta as t_read_fasta
from figbird_tpu_torch.io.fastq import read_fastq as t_read_fastq
from figbird_tpu_torch.model import error_model as t_model
from figbird_tpu_torch.triage.assign import Triage as t_Triage

torch.set_num_threads(2)

SIMS = {
    "plain": dict(genome_len=20_000, n_contigs=2, n_gaps=4, read_len=101,
                  insert_mean=200, insert_sd=20, coverage=8, indel_rate=0.03,
                  seed=7),
    "neg_gaps_repeats_tail": dict(
        genome_len=30_000, n_contigs=3, n_gaps=5, read_len=80, coverage=3,
        neg_gap_count=2, gap_len_tail=0.3, repeat_count=1, repeat_len=300,
        seed=8),
}


def _equal(a, b, what=""):
    """Deep equality of dataclasses, containers and arrays."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, what
        for f in dataclasses.fields(a):
            _equal(getattr(a, f.name), getattr(b, f.name),
                   f"{what}.{f.name}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{what}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert np.asarray(a).dtype == np.asarray(b).dtype, what
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert a == b, what


@pytest.fixture(scope="module")
def aligned():
    """One simulation in both packages' classes, and the port aligner's
    outputs for both mates against the gapped draft."""
    ref = r_sim.simulate(r_sim.SimConfig(**SIMS["plain"]))
    got = t_sim.simulate(t_sim.SimConfig(**SIMS["plain"]))
    idx = t_build_index(got.draft, k=15, device_tables=True)
    al = Aligner(idx, AlignParams(want_mism=True), batch_size=2048,
                 device="cpu")
    a1, a2 = al.align_many([(got.reads1.seq, got.reads1.length),
                            (got.reads2.seq, got.reads2.length)])
    return ref, got, a1, a2


@pytest.mark.parametrize("name", list(SIMS))
def test_simulate_equal(name):
    """Same seed, same arrays: truth, draft, both read batches (bases,
    lengths, qualities) and the true placements."""
    ref = r_sim.simulate(r_sim.SimConfig(**SIMS[name]))
    got = t_sim.simulate(t_sim.SimConfig(**SIMS[name]))
    _equal(got, ref, "sim")
    _equal(got, convert.sim_data(ref), "converted")
    assert ref.draft.count_n() > 0 and len(ref.reads1) > 100


def test_genome_ops_equal(aligned):
    ref, got, _, _ = aligned
    g_ref, g_got = ref.draft.find_gaps(), got.draft.find_gaps()
    _equal(g_got, g_ref, "gaps")
    assert len(g_ref) == 4
    rng = np.random.default_rng(0)
    strings = [rng.integers(0, 4, n).astype(np.int8)
               for n in (g.length + d for g, d in zip(g_ref, (0, 3, -2, 1)))]
    skips = [0, 0, 2, 0]
    _equal(got.draft.splice_gaps(g_got, strings, skips),
           ref.draft.splice_gaps(g_ref, strings, skips), "splice")
    _equal(got.draft.flank_trim(10, 101), ref.draft.flank_trim(10, 101),
           "flank_trim")
    _equal(got.draft.reduce_to_gapped(), ref.draft.reduce_to_gapped(),
           "reduce")
    _equal(got.draft.flatten(), ref.draft.flatten(), "flatten")


def test_fasta_fastq_equal(aligned, tmp_path):
    """Files written by the reference read back equal through both
    parsers."""
    ref, _, _, _ = aligned
    write_fasta(tmp_path / "d.fa", ref.draft.to_fasta())
    write_fastq(tmp_path / "r.fq", ref.reads1.take(np.arange(200)))
    _equal(t_read_fasta(tmp_path / "d.fa"), r_read_fasta(tmp_path / "d.fa"),
           "fasta")
    _equal(t_read_fastq(tmp_path / "r.fq"), r_read_fastq(tmp_path / "r.fq"),
           "fastq")
    _equal(t_read_fastq(tmp_path / "r.fq", max_len=60, limit=50),
           r_read_fastq(tmp_path / "r.fq", max_len=60, limit=50), "fastq cut")


@pytest.mark.parametrize("device_tables", [False, True])
def test_build_index_equal(aligned, device_tables):
    ref, got, _, _ = aligned
    i_ref = r_build_index(ref.draft, k=15, device_tables=device_tables)
    i_got = t_build_index(got.draft, k=15, device_tables=device_tables)
    if not device_tables:
        i_ref.build_buckets()
        i_got.build_buckets()
        assert len(i_ref.sorted_codes) > 10_000
    _equal(i_got, i_ref, "index")
    _equal(i_got, convert.kmer_index(i_ref), "converted")
    pos = np.array([0, 300, 9_000, 15_000, 20_400])
    _equal(i_got.flat_to_contig(pos), i_ref.flat_to_contig(pos), "to_contig")


def test_pair_table_and_triage_equal(aligned):
    ref, got, a1, a2 = aligned
    i_ref = r_build_index(ref.draft, k=15, device_tables=True)
    i_got = t_build_index(got.draft, k=15, device_tables=True)
    pt_ref = r_build_pair_table(i_ref, a1, a2, ref.reads1.length,
                                ref.reads2.length, 200)
    pt_got = t_build_pair_table(i_got, a1, a2, got.reads1.length,
                                got.reads2.length, 200)
    _equal(pt_got, pt_ref, "pair table")
    assert pt_ref.concordant.sum() > 100
    tris = []
    for Triage, gaps, pt, sim in (
            (r_Triage, ref.draft.find_gaps(), pt_ref, ref),
            (t_Triage, got.draft.find_gaps(), pt_got, got)):
        tri = Triage(gaps, max_distance=200, read_mean=200, is_jump=False)
        tri.collect_partial(pt, sim.reads1, sim.reads2, align1=a1, align2=a2)
        tri.collect_unmapped(pt, sim.reads1, sim.reads2)
        tris.append(tri)
    b_ref, b_got = tris[0].bundles, tris[1].bundles
    assert sum(b.n_partial for b in b_ref) > 0
    for x, y in zip(b_got, b_ref):
        for f in dataclasses.fields(y):
            if not f.name.startswith("_"):
                _equal(getattr(x, f.name), getattr(y, f.name), f.name)


def test_error_model_equal(aligned):
    """collect_stats -> finalize_model -> the gap-probability cut-off, and
    the per-alignment error probability, from the same alignments."""
    ref, got, a1, _ = aligned
    idx = t_build_index(got.draft, k=15, device_tables=True)
    rows = np.flatnonzero(a1["aligned"] & a1["unique"]
                          & ~np.asarray(a1.get("indel", False)))
    assert rows.size > 200
    seq, lens = got.reads1.seq[rows], got.reads1.length[rows]
    comp = np.array([3, 2, 1, 0, 4], np.int8)[seq]
    oriented = np.where(a1["strand"][rows, None] == 1, comp[:, ::-1], seq)
    rng = np.random.default_rng(1)
    args = (idx.flat, oriented, lens, a1["pos"][rows].astype(np.int64),
            a1["strand"][rows], a1["mism"][rows])
    kw = dict(inserts=rng.normal(200, 20, rows.size).astype(np.int64),
              max_read_length=101, clip_start=a1["clip_start"][rows],
              clip_end=a1["clip_end"][rows])
    st_ref = r_model.collect_stats(*args, **kw)
    st_got = t_model.collect_stats(*args, **kw)
    _equal(st_got, st_ref, "stats")
    _equal(st_got, convert.model_stats(st_ref), "converted stats")
    assert st_ref.error_pos.sum() > 0
    frm = idx.flat[a1["pos"][rows].astype(np.int64)[:, None]
                   + np.arange(101)[None, :]]
    for partial in (False, True):
        m_ref = r_model.finalize_model(st_ref, ref.draft.lengths,
                                       partial_flag=partial, partial_len=101)
        m_got = t_model.finalize_model(st_got, got.draft.lengths,
                                       partial_flag=partial, partial_len=101)
        _equal(m_got, m_ref, "model")
        _equal(m_got, convert.error_model(m_ref), "converted model")
        e_ref = r_model.alignment_error_log10(
            m_ref, oriented, lens, a1["strand"][rows], a1["mism"][rows], frm,
            clip_start=kw["clip_start"], clip_end=kw["clip_end"])
        e_got = t_model.alignment_error_log10(
            m_got, oriented, lens, a1["strand"][rows], a1["mism"][rows], frm,
            clip_start=kw["clip_start"], clip_end=kw["clip_end"])
        _equal(e_got, e_ref, "error log10")
        assert t_model.compute_gap_prob_cutoff(m_got, log10_err2=e_got) \
            == r_model.compute_gap_prob_cutoff(m_ref, log10_err2=e_ref)


def _seq(rng, n):
    return rng.integers(0, 4, n).astype(np.int8)


def _with_ns(rng, left, n_run, right):
    return np.concatenate([_seq(rng, left), np.full(n_run, 4, np.int8),
                           _seq(rng, right)])


def test_combine_equal(tmp_path):
    """combine_gap_history over three iterations: an early full closure, a
    negative (merged, empty) gap, an unfilled gap, partly closed gaps that
    close later, and a last iteration with fewer records than open gaps;
    then write_individual_gaps, byte for byte."""
    rng = np.random.default_rng(11)
    gaps = [r_GapInfo(0, 100 * i + 50, n)
            for i, n in enumerate((20, 30, 15, 40, 25))]
    history = [
        (gaps, [_seq(rng, 21), _with_ns(rng, 5, 10, 6), np.zeros(0, np.int8),
                np.full(40, 4, np.int8), _with_ns(rng, 3, 20, 0)],
         np.array([0, 0, 12, 0, 0])),
        (gaps[1::2] + gaps[4:], [_seq(rng, 9), _with_ns(rng, 10, 12, 11),
                                 _with_ns(rng, 2, 5, 4)], np.zeros(3)),
        (gaps[3:4], [_seq(rng, 13)], np.zeros(1)),
    ]
    c_ref = r_combine.combine_gap_history(history)
    c_got = t_combine.combine_gap_history(history)
    _equal(c_got, c_ref, "combined")
    assert [c.fully_closed for c in c_ref] == [True, True, True, True, False]
    assert t_combine.combine_gap_history([]) == []
    r_combine.write_individual_gaps(tmp_path / "ref.txt", c_ref)
    t_combine.write_individual_gaps(tmp_path / "got.txt", c_got)
    assert (tmp_path / "got.txt").read_bytes() \
        == (tmp_path / "ref.txt").read_bytes()


def test_draw_equal(tmp_path):
    """render_gap (a read past the left flank, the max_reads cut) and
    write_draw_file, byte for byte."""
    rng = np.random.default_rng(12)
    gap = r_GapInfo(1, 400, 20)
    cons = _with_ns(rng, 8, 3, 11)
    pl = [(i, int(p), _seq(rng, 30))
          for i, p in enumerate((-40, -12, 0, 5, 17))]
    lf, rf = _seq(rng, 30), _seq(rng, 25)
    recs = []
    for mod in (r_draw, t_draw):
        recs.append([mod.render_gap(3, gap, cons, pl, lf, rf),
                     mod.render_gap(4, convert.gap_info(gap), cons, pl, lf,
                                    rf, max_reads=2)])
        mod.write_draw_file(tmp_path / f"{mod.__name__}.txt", recs[-1])
    assert recs[1] == recs[0]
    assert (tmp_path / "figbird_tpu_torch.fill.draw.txt").read_bytes() \
        == (tmp_path / "figbird_tpu.fill.draw.txt").read_bytes()


def _misassembled(rng):
    """A 40 kb truth and an assembly with a relocation, an inversion, a
    gap, a short block and a few substitutions."""
    truth = _seq(rng, 40_000)
    asm = np.concatenate([truth[:10_000], truth[25_000:35_000],
                          (3 - truth[12_000:20_000])[::-1],
                          np.full(50, 4, np.int8), truth[36_000:36_400],
                          np.full(10, 4, np.int8), truth[36_500:36_560]])
    asm[[500, 12_345, 22_222]] = (asm[[500, 12_345, 22_222]] + 1) % 4
    return (r_Genome(["ref"], [truth]),
            r_Genome(["a", "b"], [asm, truth[20_000:24_000].copy()]))


def test_evalx_equal():
    """assembly_stats, evaluate_against_reference (a relocation and an
    inversion counted as misassemblies, substitutions as erroneous length)
    and fill_accuracy_vs_truth against the originals."""
    ref, asm = _misassembled(np.random.default_rng(13))
    t_ref, t_asm = convert.genome(ref), convert.genome(asm)
    _equal(t_evalx.assembly_stats(t_asm), r_evalx.assembly_stats(asm), "st")
    rep = r_evalx.evaluate_against_reference(asm, ref)
    _equal(t_evalx.evaluate_against_reference(t_asm, t_ref), rep, "eval")
    assert rep.misassemblies >= 2 and rep.erroneous_length >= 3, rep
    assert t_evalx.EvalReport(**dataclasses.asdict(rep)).as_table() \
        == rep.as_table()
    rng = np.random.default_rng(14)
    gaps = [r_GapInfo(0, s, n) for s, n in ((100, 30), (900, 12), (5000, 8))]
    truth0 = ref.contigs[0]
    strings = [truth0[100:130].copy(), _seq(rng, 15), truth0[5000:5008].copy()]
    strings[0][[3, 4]] = 4
    strings[2][0] = (strings[2][0] + 2) % 4
    acc_ref = r_evalx.fill_accuracy_vs_truth(ref, gaps, strings)
    acc_got = t_evalx.fill_accuracy_vs_truth(
        t_ref, [convert.gap_info(g) for g in gaps], strings)
    _equal(acc_got, acc_ref, "accuracy")
    assert (acc_got.identity, acc_got.fill_rate) \
        == (acc_ref.identity, acc_ref.fill_rate)
    assert (acc_ref.closed, acc_ref.filled_bases) == (1, 36)


def test_checkpoint_equal(tmp_path):
    """A model saved by either package loads equal in the other, and
    latest_iteration picks the same newest assembly."""
    rng = np.random.default_rng(15)
    st = r_model.ModelStats(24)
    np.add.at(st.insert_counts, rng.normal(300, 30, 4000).astype(int), 1)
    st.error_pos += 5
    st.read_lengths[23] = 1000
    st.error_types += 1
    st.base_counts += 6000
    m_ref = r_model.finalize_model(st, np.array([60_000]))
    m_ref.gap_prob_cutoff = 6
    r_ckpt.save_model(tmp_path / "ref.npz", m_ref)
    t_ckpt.save_model(tmp_path / "got.npz", convert.error_model(m_ref))
    _equal(t_ckpt.load_model(tmp_path / "ref.npz"), m_ref, "ref -> port")
    _equal(r_ckpt.load_model(tmp_path / "got.npz"), m_ref, "port -> ref")
    wd = tmp_path / "wd"
    assert t_ckpt.latest_iteration(wd) == r_ckpt.latest_iteration(wd) \
        == (0, None)
    (wd / "Filled_Scaffolds").mkdir(parents=True)
    for name in ("1filledContigs.fa", "12filledContigs.fa",
                 "3filledContigs.fa", "x12filledContigs.fa", "notes.txt"):
        (wd / "Filled_Scaffolds" / name).write_text(">c\nA\n")
    assert t_ckpt.latest_iteration(wd) == r_ckpt.latest_iteration(wd) \
        == (12, wd / "Filled_Scaffolds" / "12filledContigs.fa")


def test_native_paths_equal(aligned, tmp_path, monkeypatch):
    """The native C++ FASTQ parser and k-mer table (built from native/ into
    the port's _build/) equal the numpy paths and the reference's."""
    ref, got, _, _ = aligned
    assert t_native.get_lib() is not None
    assert os.path.dirname(t_native._target()).endswith(
        os.path.join("figbird_tpu_torch", "_build"))
    write_fastq(tmp_path / "r.fq", ref.reads2.take(np.arange(300)))
    for kw in ({}, {"max_len": 60}, {"with_qual": False}):
        nat = t_read_fastq(tmp_path / "r.fq", **kw)
        numpy_path = t_read_fastq(tmp_path / "r.fq", limit=10 ** 9, **kw)
        _equal(nat, numpy_path, f"native vs numpy {kw}")
        _equal(nat, r_read_fastq(tmp_path / "r.fq", **kw), f"ref {kw}")
    i_nat = t_build_index(got.draft, k=15, device_tables=False)
    with monkeypatch.context() as mp:
        mp.setattr(t_native, "get_lib", lambda: None)
        i_np = t_build_index(got.draft, k=15, device_tables=False)
    _equal(i_nat, i_np, "native vs numpy index")
    _equal(i_nat, r_build_index(ref.draft, k=15, device_tables=False),
           "ref index")


def test_trace_context(tmp_path):
    """trace_context writes a Chrome trace of its span into ``logdir``, does
    nothing without one, and on an exception stops the profiler and writes
    none."""
    from figbird_tpu_torch.utils import trace_context

    with trace_context(None):
        torch.ones(4).sum()
    with trace_context(str(tmp_path / "ok")):
        torch.ones(4).sum()
    assert (tmp_path / "ok" / "trace.json").stat().st_size > 0
    with pytest.raises(ValueError):
        with trace_context(str(tmp_path / "bad")):
            raise ValueError("stop")
    assert not torch.autograd.profiler._is_profiler_enabled
    assert not (tmp_path / "bad").exists()
