"""The unmapped ('u') iteration of the port against figbird_tpu on the same
inputs: the unmapped EM (``fill_batch`` with the re-anchoring step and the
low-coverage region code), its two discrete helpers, the host helpers of
the unmapped ``fill_gaps``, the end-to-end aligner with its glocal banded
tier, and whole 'u' iterations (``slow``: the reference compiles a dozen
unmapped XLA programs for them)."""

import dataclasses
from dataclasses import replace

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import figbird_tpu.pipeline as r_pipeline
import figbird_tpu_torch.pipeline as t_pipeline
from figbird_tpu.align import Aligner, AlignParams, build_index
from figbird_tpu.align.banded import BandedParams as RBandedParams
from figbird_tpu.align.banded import banded_scores_device as r_banded
from figbird_tpu.align.core import as_rows, e2e_params
from figbird_tpu.config import FigbirdConfig, Parameters, ReadLibrary
from figbird_tpu.fill import driver as r_drv
from figbird_tpu.fill import em as r_em
from figbird_tpu.genome import GapInfo, Genome
from figbird_tpu.model.error_model import ModelStats, finalize_model
from figbird_tpu.simulate import SimConfig, simulate
from figbird_tpu.triage.assign import GapBundle
from figbird_tpu_torch import convert
from figbird_tpu_torch.align import banded as t_banded
from figbird_tpu_torch.align import core as t_core
from figbird_tpu_torch.fill import driver as t_drv
from figbird_tpu_torch.fill import em as t_em
from test_torch_pipeline import SMALL, _Spy

torch.set_num_threads(2)

L = 24          # read length of the EM cases
INSERT = 300    # insert mean of their model (sd 60: tmax - tmin > 200, so
                # the re-anchoring's insert gate admits reads)


@pytest.fixture(scope="module")
def em_setup():
    """Two gaps of one contig with unmapped reads cut from the truth (a
    third with one substituted base), anchors at the model's insert: the
    first gap (110 bp) is covered only 25-50 bp in from each edge, so its
    consensus keeps a long N run, the region code and the large-gap break
    see it and the re-anchoring step votes into it; the second (40 bp) is
    tiled.  A few left partial reads feed the stack initialisation."""
    rng = np.random.default_rng(5)
    truth = rng.integers(0, 4, size=1000, dtype=np.int8)
    gaps = [GapInfo(0, 300, 110), GapInfo(0, 700, 40)]
    draft = truth.copy()
    for g in gaps:
        draft[g.start : g.start + g.length] = 4
    genome = Genome(["c"], [draft])
    st = ModelStats(L)
    ins = rng.normal(INSERT, 60, size=20000).astype(int)
    np.add.at(st.insert_counts, np.clip(ins, 1, st.max_insert_size - 1), 1)
    st.error_pos += 5
    st.read_lengths[L - 1] = 1000
    st.error_types += 1
    st.base_counts += 1000 * L // 4
    model = finalize_model(st, np.array([len(truth)]))
    model.gap_prob_cutoff = 6
    plans = []
    for gi, g in enumerate(gaps):
        b = GapBundle(g)
        ge = g.start + g.length
        starts = (list(range(g.start - 20, g.start + 26, 3))
                  + list(range(ge - 50, ge - 4, 3))) if gi == 0 \
            else list(range(g.start - 20, ge, 2))
        for s in starts:
            seq = truth[s : s + L].copy()
            if rng.random() < 0.3:
                seq[rng.integers(0, L)] = rng.integers(0, 4)
            b.u_seq.append(seq)
            left = rng.random() < 0.5
            b.u_pos.append(int(s - INSERT + L if left else s + INSERT - L)
                           + int(rng.integers(-20, 20)))
            b.u_rev.append(int(rng.random() < 0.5))
        for s in range(g.start - 22, g.start - 4, 3):
            b.p_seq.append(truth[s : s + L].copy())
            b.p_clip.append(g.start - (s + 1))
            b.p_match.append(1)
            b.p_pos.append(s + 1)
            b.p_refpos.append(-1)
            b.p_qual.append(np.full(L, 1e-3, np.float32))
        contig = genome.contigs[0]
        plans.append(r_drv.GapPlan(
            g, b, contig[g.start - 30 : g.start],
            contig[g.start + g.length : g.start + g.length + 30], 30))
    return genome, gaps, plans, model


def _em_cfg(model):
    """The smallest unmapped bucket: gb 128, R 128, an 8-iteration cap."""
    return r_em.FillConfig(
        W=L + 128 + L, Wp=L + 128, L=L, WL=L, max_gap_len=128, R=128, P=8,
        partial_mode=False, unmapped_mode=True, em_iters=8,
        gap_prob_cutoff=float(model.gap_prob_cutoff),
        insert_tmin=int(model.insert_threshold_min),
        insert_tmax=int(model.insert_threshold_max), exact_soft=True,
        detect_prec=False)


def test_unmapped_em_matches_reference(em_setup):
    """``fill_batch_gathered`` of both packages on the per-gap arrays of the
    reference's ``_build_gap_arrays``, five candidate lengths, the finalize
    extras and the large-gap break on.  Discrete outputs are equal, read
    positions where the read was accepted; a rejected read's position may
    differ only where its hard score ties at two positions (XLA's dot
    breaks the tie in the last bit, the port's sums keep it and take the
    first).  The likelihood within rtol 1e-6 (the hard score's f32 sums run
    in another order than XLA's dot); the counts, iterated over up to 8 EM
    passes whose soft scores differ from XLA's in the last bit (exp turns
    an ulp of a log-weight near -50 into a few 1e-6 relative; 1.8e-6
    measured), within rtol 5e-6 with zeros in the same places."""
    genome, _, plans, model = em_setup
    cfg = _em_cfg(model)
    ga = r_drv._build_gap_arrays(genome, plans, cfg)
    marr = r_drv._model_arrays(model, L)
    gidx = np.array([0, 0, 0, 1, 1], np.int32)
    glen = np.array([100, 110, 120, 38, 40], np.int32)
    ref = r_em.fill_batch_gathered(cfg, ga, jnp.asarray(gidx),
                                   jnp.asarray(glen), marr,
                                   finalize_flag=True, large_break=True)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    torch.set_flush_denormal(True)
    try:
        got = t_em.fill_batch_gathered(
            convert.fill_config(cfg), convert.to_tensors(ga),
            torch.as_tensor(gidx), torch.as_tensor(glen),
            convert.to_tensors(marr), True, True)
    finally:
        torch.set_flush_denormal(False)
    got = {k: v.numpy() for k, v in got.items()}
    assert sorted(got) == sorted(ref)
    for k in ("consensus", "accept", "valid", "region_perct", "discont",
              "iters", "bailed", "prec", "ucoverf", "umaxleftf",
              "umaxrightf"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    np.testing.assert_array_equal(np.where(ref["accept"], got["pos"], 0),
                                  np.where(ref["accept"], ref["pos"], 0))
    # a position that differs is a rejected read's, and a tie: the port's
    # hard score against the last pass's template is as high at the
    # reference's position as at its own first maximum
    tcfg, tmarr = convert.fill_config(cfg), convert.to_tensors(marr)
    inst = t_em._gather_inst(tcfg, convert.to_tensors(ga),
                             torch.as_tensor(gidx), torch.as_tensor(glen))
    tmpl = t_em._best_gap_string(tcfg, inst,
                                 torch.as_tensor(got["consensus"]),
                                 t_em._gap_zone(inst, tcfg))
    sh = t_em._hard_score_unmapped(
        tcfg, inst, tmarr, t_em._unmapped_prep(tcfg, inst, tmarr),
        tmpl).numpy()
    for i, r in zip(*np.nonzero(got["pos"] != ref["pos"])):
        assert not ref["accept"][i, r] and not got["accept"][i, r]
        assert sh[i, r].argmax() == got["pos"][i, r] + L
        np.testing.assert_allclose(sh[i, r, ref["pos"][i, r] + L],
                                   sh[i, r].max(), rtol=1e-6)
    np.testing.assert_allclose(got["likelihood"], ref["likelihood"],
                               rtol=1e-6)
    np.testing.assert_allclose(got["counts"], ref["counts"], rtol=5e-6,
                               atol=0)
    np.testing.assert_array_equal(got["counts"] == 0, ref["counts"] == 0)
    # the case reaches the code it is meant to hold: long runs, regions
    assert (ref["iters"] > 1).any() and (ref["region_perct"][:3] > 0).any()
    assert ref["accept"].any()


def _overlap_inputs(seed, R=24):
    rng = np.random.default_rng(seed)
    gl = int(rng.integers(20, 90))
    accept = rng.random(R) < 0.7
    # positions on a coarse grid, so equal positions (sort ties) occur
    pos = (rng.integers(-20, gl, R) // 3 * 3).astype(np.int32)
    lens = rng.integers(10, 25, R).astype(np.int32)
    return gl, accept, pos, lens


@pytest.mark.parametrize("seed", range(4))
def test_find_overlap_unmapped_matches_reference(seed):
    """Chain penalties, the unmarking of gap-separated pairs and the edge
    bonuses on seeded accept/position sets with ties in position."""
    R = 24
    cfg = replace(_em_cfg_plain(), R=R)
    gl, accept, pos, lens = _overlap_inputs(seed, R)
    v, acc, disc = r_em._find_overlap_unmapped(
        cfg, {"gap_len": jnp.int32(gl)}, jnp.asarray(accept),
        jnp.asarray(pos), jnp.asarray(lens))
    tv, tacc, tdisc = t_em._find_overlap_unmapped(
        convert.fill_config(cfg), {"gap_len": torch.tensor([gl])},
        torch.as_tensor(accept)[None], torch.as_tensor(pos)[None],
        torch.as_tensor(lens)[None])
    assert float(tv[0]) == float(v)
    np.testing.assert_array_equal(tacc[0].numpy(), np.asarray(acc))
    assert bool(tdisc[0]) == bool(disc)


def _em_cfg_plain():
    return r_em.FillConfig(
        W=L + 128 + L, Wp=L + 128, L=L, WL=L, max_gap_len=128, R=16, P=8,
        partial_mode=False, unmapped_mode=True, em_iters=8,
        insert_tmin=100, insert_tmax=500)


# N runs in the gap consensus: none, one shorter than L/2 + 1 (ignored), one
# at least that long, and a long one next to a short one
N_RUNS = {"none": [], "short": [(30, 8)], "long": [(25, 30)],
          "long_and_short": [(10, 5), (40, 40)]}


@pytest.mark.parametrize("runs", list(N_RUNS))
def test_update_reanchor_matches_reference(runs):
    """The re-anchoring step on a consensus with N runs of length 0, below
    L/2 + 1 and at least L/2 + 1; half of the reads are cut from the
    consensus around the run's edges (exact suffix/prefix matches), the
    rest random; the partial-majority fallback gets a stack string."""
    rng = np.random.default_rng(len(runs) + 17)
    cfg = _em_cfg_plain()
    R, mgl, gl, gs = cfg.R, cfg.max_gap_len, 90, 500
    truth = rng.integers(0, 4, mgl).astype(np.int8)
    gc = truth.copy()
    gc[gl:] = 4
    for a, n in N_RUNS[runs]:
        gc[a : a + n] = 4
    ur = rng.integers(0, 4, (R, L)).astype(np.int8)
    # reads cut from the truth across the edges of the long runs: a prefix
    # on the consensus left of them, or a suffix on it right of them
    longs = [(a, n) for a, n in N_RUNS[runs] if n >= L // 2 + 1] \
        or [(40, 20)]
    a0, e0 = min(a for a, _ in longs), max(a + n - 1 for a, n in longs)
    for r in range(R):
        m = int(rng.integers(7, L - 2))
        s = (a0 - m, e0 + 1 + m - L, int(rng.integers(0, gl - L)), None)[r % 4]
        if s is not None:
            ur[r] = truth[s : s + L]
    u_len = rng.integers(L - 4, L + 1, R).astype(np.int32)
    ur[np.arange(L)[None, :] >= u_len[:, None]] = 4
    inst = dict(ur=ur, u_len=u_len,
                u_pos=(gs - rng.integers(100, 300, R)).astype(np.int32),
                u_valid=rng.random(R) < 0.9, gap_len=np.int32(gl),
                gap_start=np.int32(gs))
    counts = rng.random((cfg.W, 5)).astype(np.float32)
    accept = rng.random(R) < 0.3
    has_place = rng.random(R) < 0.9
    pl_major = rng.integers(0, 4, mgl).astype(np.int8)
    left_max = np.int32(60)
    want = r_em._update_reanchor(
        cfg, {k: jnp.asarray(v) for k, v in inst.items()}, jnp.asarray(counts),
        jnp.asarray(gc), jnp.asarray(accept), jnp.asarray(has_place),
        jnp.asarray(pl_major), jnp.asarray(left_max))
    tinst = {k: torch.as_tensor(np.asarray(v))[None] for k, v in inst.items()}
    got = t_em._update_reanchor(
        convert.fill_config(cfg), tinst, torch.as_tensor(counts)[None],
        torch.as_tensor(gc)[None], torch.as_tensor(accept)[None],
        torch.as_tensor(has_place)[None], torch.as_tensor(pl_major)[None],
        torch.tensor([left_max]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))
    changed = not np.array_equal(np.asarray(want), counts)
    assert changed == (runs in ("long", "long_and_short"))


def test_host_helpers_equal(em_setup):
    """The host copies of the unmapped ``fill_gaps``: gap planning
    (large-gap flag and findFrac ranges, no repeat skip), the replay with
    its unmapped exits, the probe grid and recheck_sequence."""
    genome, gaps, plans, _ = em_setup
    rng = np.random.default_rng(3)
    tgen = convert.genome(genome)
    tb = [convert.gap_bundle(p.bundle) for p in plans]
    # a third, large gap (> GAPTHRESH) for the large-gap flag
    big = GapInfo(0, 100, 450)
    for partial_mode in (False, True):
        want = r_drv.plan_gaps(genome, gaps + [big],
                               [p.bundle for p in plans] + [plans[0].bundle],
                               partial_mode, L, 30, 16)
        got = t_drv.plan_gaps(tgen, [convert.gap_info(g)
                                     for g in gaps + [big]],
                              tb + [tb[0]], partial_mode, L, 30, 16)
        for w, g in zip(want, got):
            for f in ("skip", "neg_merge", "lengths", "side_flag",
                      "large_gap", "perfect_flag", "perfect_len"):
                assert getattr(g, f) == getattr(w, f), f
        assert want[-1].large_gap == (not partial_mode)
    for orig in (5, 14, 25, 31, 400):
        assert t_drv._probe_lengths(orig) == r_drv._probe_lengths(orig)
    for trial in range(40):
        n = int(rng.integers(1, 160))
        lik = np.round(rng.normal(0, 3, n).cumsum(), 1)
        valid = rng.integers(0, 9, n)
        extras = {"edge": rng.random(n) < 0.2, "discont": rng.random(n) < 0.5}
        orig = int(rng.choice([20, 80]))
        for pm in (False, True):
            ex = None if pm else extras
            assert t_drv._replay_scan(range(n), lik, valid, orig, pm, ex) \
                == r_drv._replay_scan(range(n), lik, valid, orig, pm, ex)
        gl = int(rng.integers(10, 120))
        cons = rng.integers(0, 4, gl).astype(np.int8)
        for a in rng.integers(0, gl, int(rng.integers(0, 3))):
            cons[a : a + int(rng.integers(1, 15))] = 4
        R = 20
        pos = rng.integers(-20, gl, R)
        lens = rng.integers(10, 30, R)
        acc = rng.random(R) < 0.6
        for og in (gl, 500, 1500):
            c1, c2 = cons.copy(), cons.copy()
            rp = float(rng.random())
            assert t_drv._recheck_sequence(c1, pos, lens, acc, og, rp) \
                == r_drv._recheck_sequence(c2, pos, lens, acc, og, rp)
            np.testing.assert_array_equal(c1, c2)


@pytest.fixture(scope="module")
def align_sim():
    # the inputs of test_torch_align.py: gap-edge reads and 1-3 bp indels
    return simulate(SimConfig(genome_len=30_000, n_contigs=2, n_gaps=4,
                              read_len=101, coverage=6, indel_rate=0.05,
                              seed=11))


@pytest.fixture(scope="module")
def e2e_alignments(align_sim):
    idx = build_index(align_sim.draft, k=15, device_tables=True)
    p = e2e_params(AlignParams(want_mism=False))
    r1 = align_sim.reads1
    seq, lens = r1.seq[:1200], r1.length[:1200]
    ref = Aligner(idx, p, batch_size=512).align(seq, lens)
    got = t_core.Aligner(convert.kmer_index(idx), convert.align_params(p),
                         batch_size=512, device="cpu").align(seq, lens)
    return idx, seq, lens, ref, got


def test_e2e_aligner_matches_reference(e2e_alignments):
    """The end-to-end preset: candidates ranked by K5's full-read plane, the
    linear minimum score, no clips, the full-read mismatch count, and the
    glocal banded tier over every unaligned read."""
    _, _, lens, ref, got = e2e_alignments
    for k in ("score", "pos", "strand", "clip_start", "clip_end", "aligned",
              "unique", "n_mis", "second", "alen", "hit_overflow", "indel"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert sorted(got["indel_detail"]) == sorted(ref["indel_detail"])
    assert ref["indel"].any() and not ref["aligned"].all()
    gapless = ~ref["indel"]
    assert (ref["clip_start"][gapless] == 0).all()
    assert (ref["alen"][gapless] == lens[gapless]).all()


def test_e2e_banded_scores_match_reference(e2e_alignments):
    """The glocal banded DP alone: score and end cell, at the windows of the
    reads the end-to-end pass left unaligned (as oriented there) and at
    random windows."""
    idx, seq, lens, ref, _ = e2e_alignments
    flat = idx.flat
    rng = np.random.default_rng(4)
    rows = np.flatnonzero(~ref["aligned"])[:200]
    starts = np.concatenate([ref["pos"][rows], rng.integers(
        0, len(flat) - 200, 56)]).astype(np.int32)
    rows = np.concatenate([rows, rng.integers(0, len(seq), 56)])
    reads, rl = seq[rows], lens[rows].astype(np.int32)
    bp = RBandedParams(end_to_end=True)
    want = r_banded(jnp.asarray(as_rows(flat)), jnp.asarray(starts),
                    jnp.asarray(reads), jnp.asarray(rl), bp)
    got = t_banded.banded_scores_device(
        torch.as_tensor(t_core.as_rows(flat)), torch.as_tensor(starts),
        torch.as_tensor(reads), torch.as_tensor(rl),
        convert.banded_params(bp))
    for k in ("score", "end_i", "end_k"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    assert (np.asarray(want["score"]) > -(2 ** 29)).any()


# ---------------------------------------------------------------- slow
def _cfg(*libs):
    return FigbirdConfig(
        draft_genome="", output_folder="",
        read_pairs=[ReadLibrary("", "", avg_insert_size=i,
                                max_read_length=101) for i in libs],
        parameters=Parameters(trim_len=0))


def _run_u(cfg, sim_draft, libs, lib_i, fill_kwargs, **pipe_kwargs):
    """One 'u' iteration of library ``lib_i`` in both packages."""
    tlibs = [(convert.read_batch(a), convert.read_batch(b)) for a, b in libs]
    ref = r_pipeline.Pipeline(cfg, sim_draft, libs, fill_kwargs=fill_kwargs,
                              aligner_kwargs={"batch_size": 4096},
                              **pipe_kwargs)
    st_ref = ref.run_iteration("u", lib_i)
    got = t_pipeline.Pipeline(
        convert.figbird_config(cfg), convert.genome(sim_draft), tlibs,
        fill_kwargs=fill_kwargs, aligner_kwargs={"batch_size": 4096},
        device="cpu", **pipe_kwargs)
    st_got = got.run_iteration("u", lib_i)
    return ref, st_ref, got, st_got


def _assert_iterations_equal(ref, st_ref, got, st_got):
    (g_ref, s_ref, f_ref), = ref.result.gap_history
    (g_got, s_got, f_got), = got.result.gap_history
    assert [dataclasses.astuple(g) for g in g_got] \
        == [dataclasses.astuple(g) for g in g_ref]
    assert len(s_got) == len(s_ref)
    for a, b in zip(s_got, s_ref):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(f_got, f_ref)
    for a, b in zip(got.genome.contigs, ref.genome.contigs):
        np.testing.assert_array_equal(a, b)
    assert (st_got.n_before, st_got.n_after, st_got.n_pairs,
            st_got.n_model) == (st_ref.n_before, st_ref.n_after,
                                st_ref.n_pairs, st_ref.n_model)


@pytest.mark.slow
@pytest.mark.parametrize("fill", ["default", "reference_exact"])
def test_unmapped_iteration_equal(fill):
    """``run_iteration("u", 0)`` on test_torch_pipeline.py's simulation: the
    same gap strings, skips and filled genome, and the same relearned model
    (the end-to-end pass's) going into the fill."""
    sim = simulate(SimConfig(
        genome_len=60_000, n_contigs=1, n_gaps=6, gap_len_range=(8, 60),
        read_len=101, insert_mean=200, insert_sd=20, coverage=15,
        error_rate=0.005, seed=3))
    kw = SMALL if fill == "default" else {"reference_exact": True}
    with _Spy(r_pipeline) as r_spy, _Spy(t_pipeline) as t_spy:
        ref, st_ref, got, st_got = _run_u(
            _cfg(200), sim.draft, [(sim.reads1, sim.reads2)], 0, kw)
    _assert_iterations_equal(ref, st_ref, got, st_got)
    assert st_ref.n_after < st_ref.n_before
    m_ref, m_got = r_spy.args[3], t_spy.args[3]
    assert m_got.gap_prob_cutoff == m_ref.gap_prob_cutoff
    for f in dataclasses.fields(m_ref):
        if f.name != "snapshot":
            np.testing.assert_array_equal(
                np.asarray(getattr(m_got, f.name)),
                np.asarray(getattr(m_ref, f.name)), err_msg=f.name)
    assert sum(b.n_unmapped for b in r_spy.args[2]) > 0


@pytest.mark.slow
def test_jump_library_iteration_equal():
    """A jump library (insert 3000: ``is_jump``, so no genome reduction, and
    the measured insert mean drives the triage) on test_golden_jump.py's
    simulation parameters: ``run_iteration("u", 1)`` of both packages."""
    sim = simulate(SimConfig(
        genome_len=160_000, n_contigs=2, n_gaps=6, gap_len_range=(8, 60),
        read_len=101, insert_mean=200, insert_sd=20, coverage=12.0,
        error_rate=0.003, seed=23))
    simj = simulate(SimConfig(
        genome_len=160_000, n_contigs=2, n_gaps=6, gap_len_range=(8, 60),
        read_len=101, insert_mean=3000, insert_sd=200, coverage=12.0,
        error_rate=0.003, seed=24), truth=sim.truth)
    cfg = _cfg(200, 3000)
    assert cfg.read_pairs[1].is_jump
    ref, st_ref, got, st_got = _run_u(
        cfg, sim.draft, [(sim.reads1, sim.reads2), (simj.reads1, simj.reads2)],
        1, SMALL)
    _assert_iterations_equal(ref, st_ref, got, st_got)


@pytest.mark.slow
def test_large_gap_count_bucket_fill_equal():
    """``fill_gaps(partial_mode=False)`` of both packages, with small caps,
    on an unmapped set-up at 60x with gaps of 420-500 bp: past GAPTHRESH
    (400), so ``_find_frac`` gives them the large-gap EM, and deep enough
    that a gap holds more than 128 unmapped reads (the 1,024-read count
    bucket).  The bundles and the model come from the port's aligner on
    the CPU (local and end-to-end passes), each package's own pair table,
    host model and triage; equal gap strings, gaptofill and fill stats."""
    from figbird_tpu.align import build_pair_table as r_pair_table
    from figbird_tpu.triage import Triage as r_Triage
    from figbird_tpu_torch.align import build_pair_table as t_pair_table
    from figbird_tpu_torch.align import build_index as t_build_index
    from figbird_tpu_torch.triage import Triage as t_Triage

    insert, maxd2 = 600, int(600 * 1.15)
    sim = convert.sim_data(simulate(SimConfig(
        genome_len=40_000, n_contigs=1, n_gaps=2, gap_len_range=(420, 500),
        read_len=101, insert_mean=insert, insert_sd=50, coverage=60.0,
        error_rate=0.003, seed=13)))
    idx = t_build_index(sim.draft, k=15)
    r1, r2 = sim.reads1, sim.reads2
    passes = [t_core.Aligner(idx, p, batch_size=4096, device="cpu").align_many(
        [(r1.seq, r1.length), (r2.seq, r2.length)])
        for p in (t_core.AlignParams(), e2e_params(t_core.AlignParams()))]
    gaps = sim.draft.find_gaps()
    assert len(gaps) == 2 and min(g.length for g in gaps) > r_drv.GAPTHRESH
    kw = dict(partial_mode=False, partial_len=101, max_scan_lengths=4,
              instance_batch=16)
    out = []
    for pair_table, pipe, Triage, drv, extra in (
            (r_pair_table, r_pipeline, r_Triage, r_drv, {}),
            (t_pair_table, t_pipeline, t_Triage, t_drv, dict(device="cpu"))):
        (a1, a2), (b1, b2) = passes
        pt = pair_table(idx, a1, a2, r1.length, r2.length, insert)
        ept = pair_table(idx, b1, b2, r1.length, r2.length, maxd2)
        model, _ = pipe._learn_model(idx, ept, b1, b2, r1, r2,
                                     sim.draft.lengths, partial_flag=False,
                                     partial_len=101)
        tri = Triage(gaps, max_distance=insert, read_mean=insert,
                     is_jump=False)
        tri.collect_partial(pt, r1, r2)
        tri2 = Triage(gaps, max_distance=maxd2,
                      read_mean=float(model.insert_mean), is_jump=False)
        tri2.collect_unmapped(ept, r1, r2)
        for bu, bp in zip(tri2.bundles, tri.bundles):
            bp.u_seq, bp.u_pos, bp.u_rev = bu.u_seq, bu.u_pos, bu.u_rev
        plans = drv.plan_gaps(sim.draft, gaps, tri.bundles, False, 101, 30)
        res = drv.fill_gaps(sim.draft, gaps, tri.bundles, model, **kw,
                            **extra)
        out.append((plans, tri.bundles, res))
    (plans, bundles, want), (_, _, got) = out
    assert all(p.large_gap for p in plans)
    assert max(b.n_unmapped for b in bundles) > 128
    assert len(got.gap_strings) == len(want.gap_strings) == 2
    for a, b in zip(got.gap_strings, want.gap_strings):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got.gaptofill, want.gaptofill)
    def counters(stats):  # the timers ("t_*") aside
        return {k: v for k, v in stats.items() if not k.startswith("t_")}

    assert counters(got.stats) == counters(want.stats)
    assert any((s != 4).any() for s in want.gap_strings)
