"""The multi-device layer of the port on the CPU: the mesh, the two genome
splits, the binary-search seed lookup and the statistics sum against
``figbird_tpu``'s; both genome-sharded aligners against the replicated
aligner; the host model learning against the reference's on the same
alignments; and whole iterations on meshes of repeated CPU devices (the
port's stand-in for the reference's 8 virtual devices) against the port on
one device and (``slow``) against the reference's mesh run.  Every
comparison is bit-equal: no tolerance."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import figbird_tpu.pipeline as r_pipeline
from figbird_tpu.align import core as r_core
from figbird_tpu.align.index import build_index as r_build_index
from figbird_tpu.align.pairing import build_pair_table as r_pair_table
from figbird_tpu.config import FigbirdConfig, Parameters, ReadLibrary
from figbird_tpu.parallel import make_mesh as r_make_mesh
from figbird_tpu.parallel import psum_stats as r_psum_stats
from figbird_tpu.parallel import sharded as r_sharded
from figbird_tpu.simulate import SimConfig, simulate
import figbird_tpu_torch.pipeline as t_pipeline
from figbird_tpu_torch import convert
from figbird_tpu_torch.align import core
from figbird_tpu_torch.align.pairing import build_pair_table
from figbird_tpu_torch.parallel import make_mesh, psum_stats, sharded

torch.set_num_threads(2)

CPU = torch.device("cpu")
# the capped scan of test_torch_schedule.py's CLI case, on every side
SMALL = {"max_scan_lengths": 16, "instance_batch": 16}


def cpu_mesh(n, genome_shards=1):
    return make_mesh(n, genome_shards, devices=[CPU] * n)


def test_make_mesh(monkeypatch):
    """Shapes as the reference's, a grid of devices; a count not divisible
    by the genome axis and more devices than there are raise; by default
    the visible cards."""
    for n, g in ((8, 1), (8, 2), (8, 4), (6, 3)):
        m = cpu_mesh(n, g)
        assert m.shape == dict(r_make_mesh(n, g).shape) \
            == {"reads": n // g, "genome": g}
        assert m.devices.shape == (n // g, g) and m.first == CPU
        assert m.distinct() == [CPU]
    with pytest.raises(ValueError, match="not divisible"):
        cpu_mesh(8, 3)
    with pytest.raises(ValueError, match="3 devices asked for, 2"):
        make_mesh(3, devices=["cpu", "cpu"])
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    m = make_mesh(genome_shards=2)
    assert m.shape == {"reads": 1, "genome": 2}
    assert list(m.devices[0]) == [torch.device("cuda", 0),
                                  torch.device("cuda", 1)]
    assert m.distinct() == list(m.devices[0])
    with pytest.raises(ValueError, match="4 devices asked for, 2"):
        make_mesh(4)


def test_wrappers_refuse_mixed_devices():
    """Each kernel wrapper given arguments on two devices (here the CPU and
    ``meta``) raises ``ValueError`` before it runs anything: the device it
    launches under is the one all its tensors lie on."""
    from figbird_tpu_torch.ops import align_score, band

    def t(shape, dtype=torch.float32, device="cpu"):
        return torch.zeros(shape, dtype=dtype, device=device)

    codes, valid = t((1, 4, 8), torch.int8), t((1, 4, 8), torch.bool)
    ab, w = t((1, 12, 5)), t((1, 4, 12))
    calls = (
        lambda: band.band_score_soft(codes, valid, ab, ab, t(8, device="meta"),
                                     4),
        lambda: band.band_score(codes, valid.to("meta"), t((1, 12, 40)), 4),
        lambda: band.band_score_hard(codes, valid, t((1, 12), torch.int8),
                                     t(8), t(8), t((5, 5), device="meta"), 4),
        lambda: band.fold_counts(w.to("meta"), codes, t((1, 4, 8)), 19),
        lambda: band.cascade_counts(w, codes, t((1, 4, 8), device="meta"), 19,
                                    2, 140.0, 78.0),
        lambda: align_score.score_candidates(
            t(300, torch.int8), codes[0].to("meta"), t((4, 2), torch.int32),
            2, -6, 4))
    for call in calls:
        with pytest.raises(ValueError, match="more than one device"):
            call()


@pytest.fixture(scope="module")
def sims():
    """test_parallel.py's 80 kb simulations: 2 contigs (code-range case),
    6 contigs (contig-range case); and each one's reference index."""
    out = {}
    for n_contigs, seed in ((2, 13), (6, 17)):
        sim = simulate(SimConfig(genome_len=80_000, n_contigs=n_contigs,
                                 n_gaps=4, read_len=76, insert_mean=250,
                                 insert_sd=20, coverage=3.0,
                                 error_rate=0.004, seed=seed))
        out[n_contigs] = (sim, r_build_index(sim.draft, k=15))
    return out


@pytest.mark.parametrize("n_shards", [1, 2, 3, 4])
def test_split_index_by_code_equal(sims, n_shards):
    """Code-boundary shards padded with sentinel codes, as the
    reference's."""
    _, idx = sims[6]
    args = (idx.sorted_codes.astype(np.int32),
            idx.sorted_pos.astype(np.int32), n_shards)
    got, want = sharded.split_index_by_code(*args), \
        r_sharded.split_index_by_code(*args)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("k", [15, 11])
@pytest.mark.parametrize("n_contigs,n_shards", [(6, 1), (6, 2), (6, 3),
                                                (6, 4), (2, 4)])
def test_split_index_by_contig_equal(sims, n_contigs, n_shards, k):
    """Contig-range shards (flat slices, local tables, int64 bases; the
    tables sorted by ``build_contig_shards`` on the CPU) as the
    reference's, at k = 15 and at k = 11 (where the N windows' sentinel
    has a bucket id past a byte); two contigs over four shards leave shards empty
    (pad-only stubs)."""
    sim, idx = sims[n_contigs]
    if k != idx.k:
        idx = r_build_index(sim.draft, k=k)
    got = sharded.split_index_by_contig(convert.kmer_index(idx), n_shards)
    want = r_sharded.split_index_by_contig(idx, n_shards)
    assert sorted(got) == sorted(want)
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    if n_contigs < n_shards:
        assert (want["flatlen"] == idx.pad).any()


def test_seed_hits_searchsorted_equal():
    """The binary-search seed lookup (``prefix_shift=None``) on one batch
    of seed codes against the reference's, jitted: codes present once, in
    runs past H and past the repeat limit, absent, and invalid seeds."""
    rng = np.random.default_rng(3)
    runs = np.concatenate([rng.integers(1, 4, 300), [9, 40, 128, 129, 200]])
    codes_sorted = np.repeat(np.sort(rng.choice(4 ** 15, len(runs),
                                                replace=False)), runs)
    table = dict(sorted_codes=codes_sorted.astype(np.int32),
                 sorted_pos=rng.permutation(len(codes_sorted)).astype(
                     np.int32))
    B, S, H, RL = 64, 4, 8, 128
    present = np.unique(codes_sorted)
    codes = np.where(rng.random((B, S)) < 0.8,
                     rng.choice(present, (B, S)),
                     rng.integers(0, 4 ** 15, (B, S))).astype(np.int32)
    codes[:5, 0] = present[-5:]          # the long runs
    valid = rng.random((B, S)) < 0.9
    fn = jax.jit(lambda t, c, v: r_core._seed_hits(t, c, v, H, RL, None))
    want = fn({k: jnp.asarray(v) for k, v in table.items()},
              jnp.asarray(codes), jnp.asarray(valid))
    got = core._seed_hits({k: torch.as_tensor(v) for k, v in table.items()},
                          torch.as_tensor(codes), torch.as_tensor(valid), H,
                          RL, None)
    for g, w, name in zip(got, want, ("hit_pos", "hmask", "overflow")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert np.asarray(want[2]).any() and not np.asarray(want[1]).all()


def test_psum_stats_reduces():
    """The statistics sum runs over the reads axis only: a (4, 2) mesh's
    result equals the reference's on ``make_mesh(8, 2)`` and the explicit
    sum of the four reads shards' blocks."""
    per = np.arange(4 * 16, dtype=np.float32).reshape(16, 4)
    got = psum_stats(cpu_mesh(8, 2), torch.as_tensor(per)).numpy()
    want = np.asarray(r_psum_stats(r_make_mesh(8, 2), jnp.asarray(per)))
    assert got.shape == (4, 4)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, per.reshape(4, 4, 4).sum(axis=0))


@pytest.mark.parametrize("path,e2e", [("code", False), ("code", True),
                                      ("contig", False), ("contig", True)])
def test_genome_sharded_aligner_equal(sims, path, e2e):
    """Both genome-sharded aligners on a mesh of 8 CPU devices with 4
    genome shards (the contig path forced by a threshold of 1), local and
    end-to-end presets, against the replicated ``use_buckets=False``
    aligner: score, aligned, unique, second for every read, the placement
    fields and the mismatch mask for every read with a candidate."""
    sim, idx = sims[2 if path == "code" else 6]
    tidx, r = convert.kmer_index(idx), convert.read_batch(sim.reads1)
    p = core.AlignParams(want_mism=True)
    p = core.e2e_params(p) if e2e else p
    kw = dict(batch_size=1024, two_tier=False, indel_tier=False)
    al_sh = core.Aligner(tidx, p, mesh=cpu_mesh(8, 4), genome_shard=path,
                         contig_shard_threshold=1, **kw)
    assert al_sh._genome_sharded
    assert al_sh._contig_sharded == (path == "contig")
    out_sh = al_sh.align(r.seq, r.length)
    out_ref = core.Aligner(tidx, p, use_buckets=False, device="cpu",
                           **kw).align(r.seq, r.length)
    for kk in ("score", "aligned", "unique", "second"):
        np.testing.assert_array_equal(out_sh[kk], out_ref[kk], err_msg=kk)
    # candidate-less reads carry the (clamped) NEG sentinel score; their
    # placement fields are meaningless by design
    al = out_ref["aligned"] | (out_ref["score"] > -32000)
    assert al.sum() > 500
    for kk in ("pos", "strand", "clip_start", "clip_end", "n_mis", "alen",
               "mism"):
        np.testing.assert_array_equal(out_sh[kk][al], out_ref[kk][al],
                                      err_msg=kk)


@pytest.fixture(scope="module")
def host_learning_inputs():
    """A 30 kb simulation with indels, its reference index and the port's
    alignments of both mates (mismatch masks and the banded tier's indel
    tracebacks)."""
    sim = simulate(SimConfig(genome_len=30_000, n_contigs=2, n_gaps=4,
                             read_len=76, insert_mean=250, insert_sd=20,
                             coverage=8.0, error_rate=0.004,
                             indel_rate=0.02, seed=7))
    idx = r_build_index(sim.draft, k=15)
    r1, r2 = sim.reads1, sim.reads2
    al = core.Aligner(convert.kmer_index(idx), core.AlignParams(),
                      batch_size=2048, device="cpu")
    a1, a2 = al.align_many([(r1.seq, r1.length), (r2.seq, r2.length)])
    return sim, idx, a1, a2


@pytest.mark.parametrize("holds_end", [True, False])
def test_learn_model_host_equal(host_learning_inputs, holds_end):
    """The host model learning (the contig path past ``host_flat_ok``) on
    the same alignments, with and without the global last pair, against
    the reference's: the statistics, the gap-prob histogram and cutoff."""
    sim, idx, a1, a2 = host_learning_inputs
    tidx = convert.kmer_index(idx)
    r1, r2 = sim.reads1, sim.reads2
    assert a1["indel"].any() or a2["indel"].any()
    pt_ref = r_pair_table(idx, a1, a2, r1.length, r2.length, 250)
    pt = build_pair_table(tidx, a1, a2, r1.length, r2.length, 250)
    lens = sim.draft.lengths
    m_ref, n_ref = r_pipeline._learn_model_host(
        idx, pt_ref, a1, a2, r1, r2, lens, True, 76, 250.0, holds_end)
    m_got, n_got = t_pipeline._learn_model_host(
        tidx, pt, a1, a2, convert.read_batch(r1), convert.read_batch(r2),
        lens, True, 76, 250.0, holds_end)
    assert n_got == n_ref > 500
    assert m_got.gap_prob_cutoff == m_ref.gap_prob_cutoff
    (st_got, h_got), (st_ref, h_ref) = m_got.snapshot, m_ref.snapshot
    np.testing.assert_array_equal(h_got, h_ref)
    for f in dataclasses.fields(st_ref):
        np.testing.assert_array_equal(getattr(st_got, f.name),
                                      getattr(st_ref, f.name),
                                      err_msg=f.name)
    for f in dataclasses.fields(m_ref):
        np.testing.assert_array_equal(getattr(m_got, f.name),
                                      getattr(m_ref, f.name), err_msg=f.name)


def _sim40():
    """test_parallel.py's 40 kb simulation and configuration."""
    sim = simulate(SimConfig(
        genome_len=40_000, n_contigs=2, n_gaps=6, gap_len_range=(6, 40),
        read_len=60, insert_mean=180, insert_sd=18, coverage=12.0,
        error_rate=0.004, seed=11))
    cfg = FigbirdConfig(
        draft_genome="", output_folder="",
        read_pairs=[ReadLibrary("", "", avg_insert_size=180,
                                max_read_length=60)],
        parameters=Parameters(trim_len=0))
    return sim, cfg


def _port_run(mode, mesh, fill_kwargs, batch_size):
    sim, cfg = _sim40()
    tsim = convert.sim_data(sim)
    pipe = t_pipeline.Pipeline(
        convert.figbird_config(cfg), tsim.draft, [(tsim.reads1, tsim.reads2)],
        aligner_kwargs={"batch_size": batch_size}, fill_kwargs=fill_kwargs,
        device="cpu", mesh=mesh)
    return pipe, pipe.run_iteration(mode, 0)


def _assert_runs_equal(a, b):
    (pa, sa), (pb, sb) = a, b
    assert (sa.n_before, sa.n_after, sa.n_model, sa.gaps) \
        == (sb.n_before, sb.n_after, sb.n_model, sb.gaps)
    (_, s_a, f_a), = pa.result.gap_history
    (_, s_b, f_b), = pb.result.gap_history
    assert len(s_a) == len(s_b)
    for x, y in zip(s_a, s_b):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(f_a, f_b)
    for x, y in zip(pa.genome.contigs, pb.genome.contigs):
        np.testing.assert_array_equal(x, y)


@pytest.fixture(scope="module")
def one_device_p():
    return _port_run("p", None, SMALL, 512)


@pytest.mark.parametrize("n,genome_shards", [(8, 1), (8, 4)])
def test_mesh_p_iteration_equal(one_device_p, n, genome_shards):
    """A p-iteration on meshes (8, 1) and (2, 4) of CPU devices equals the
    port's on one device: gap strings, gaptofill, contigs, N and the
    model's pair count (the capped scan on both sides; the (2, 4) mesh
    takes the code-range aligner)."""
    got = _port_run("p", cpu_mesh(n, genome_shards), SMALL, 512)
    _assert_runs_equal(got, one_device_p)
    assert got[1].n_after < got[1].n_before


@pytest.mark.slow
def test_mesh_p_iteration_equal_reference():
    """The port's (8, 1) mesh p-iteration against the reference's
    ``test_parallel.py::_run(make_mesh(8))``, at the default settings."""
    from test_parallel import _run

    sim, ref, st_ref = _run(r_make_mesh(8))
    pipe, st = _port_run("p", cpu_mesh(8), None, 2048)
    assert (st.n_before, st.n_after, st.n_model) \
        == (st_ref.n_before, st_ref.n_after, st_ref.n_model)
    assert st.n_after < st.n_before
    for x, y in zip(pipe.genome.contigs, ref.genome.contigs):
        np.testing.assert_array_equal(x, y)


@pytest.mark.slow
def test_mesh_u_iteration_equal():
    """A u-iteration on a (2, 4) mesh equals the port's on one device (the
    capped scan on both sides)."""
    _assert_runs_equal(_port_run("u", cpu_mesh(8, 4), SMALL, 512),
                       _port_run("u", None, SMALL, 512))
