"""``scripts/full_human_torch.py``, the port's full-human run, and the
contig-sharded path past 2^31 positions on the CPU: the script's
configuration is ``scripts/full_human.py``'s; the bucketed sort the
aligner builds its shard tables with is one stable argsort, at k = 11 to
15; a shard past int32 positions raises; positions whose shard bases
lie past 2^31 come out of the aligner's collect and the pair table exact,
as the reference's; a p-iteration on a (reads 1, genome 2) mesh past the
replicated flat's budget equals one device's and (``slow``) the
reference's mesh run, as does (``slow``) a u-iteration."""

import ast
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from figbird_tpu.align import core as r_core
from figbird_tpu.align.index import KmerIndex as RKmerIndex
from figbird_tpu.align.pairing import build_pair_table as r_pair_table
from figbird_tpu_torch import convert
from figbird_tpu_torch import pipeline as t_pipeline
from figbird_tpu_torch.align import core
from figbird_tpu_torch.align.index import KmerIndex
from figbird_tpu_torch.align.pairing import build_pair_table
from figbird_tpu_torch.parallel import make_mesh, sharded

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
sys.path.insert(0, os.path.join(REPO, "tests"))
import full_human_torch as fh  # noqa: E402
from test_torch_parallel import SMALL, _assert_runs_equal, _sim40  # noqa: E402

torch.set_num_threads(2)

CPU = torch.device("cpu")
BIG = 2 ** 31


def _reference_script():
    src = open(os.path.join(REPO, "scripts", "full_human.py")).read()
    return ast.parse(src)


def _call(tree, name):
    return next(n for n in ast.walk(tree) if isinstance(n, ast.Call)
                and getattr(n.func, "id", None) == name)


def _kwargs(call, names) -> dict:
    return {kw.arg: eval(compile(ast.Expression(kw.value), "<cfg>", "eval"),
                         {"int": int}, names) for kw in call.keywords}


def test_configuration_is_the_reference_scripts():
    """The SimConfig, ReadLibrary and Parameters of
    ``scripts/full_human.py`` (read from its source: it runs JAX when
    imported) at its default genome and coverage are the port script's."""
    tree = _reference_script()
    names = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and getattr(node.targets[0], "id", None) in (
                    "GENOME_GB", "COVERAGE", "N_CONTIGS", "N_GAPS"):
            v = node.value
            names[node.targets[0].id] = ast.literal_eval(
                v.orelse if isinstance(v, ast.IfExp) else v)
    assert (names["GENOME_GB"], names["COVERAGE"]) == (fh.DEFAULT_GB,
                                                       fh.DEFAULT_COVERAGE)
    want = _kwargs(_call(tree, "SimConfig"), names)
    got = dataclasses.asdict(fh.sim_config())
    assert {k: got[k] for k in want} == want
    assert fh.sim_config(2.2, 1.0).genome_len == 2_200_000_000
    cfg = fh.fh_config()
    lib = _kwargs(_call(tree, "ReadLibrary"), {})
    assert {k: getattr(cfg.read_pairs[0], k) for k in lib} == lib
    params = _kwargs(_call(tree, "Parameters"), {})
    assert {k: getattr(cfg.parameters, k) for k in params} == params
    assert params["genome_shard"] == "contig"


@pytest.mark.parametrize("k", [15, 13, 11])
@pytest.mark.parametrize("prefix_bases", [1, 2, 3])
def test_bucketed_sort_is_the_stable_sort(monkeypatch, prefix_bases, k):
    """``sorted_kmers`` (one prefix bucket at a time) gives one stable
    argsort of the window codes, the N windows last in position order, on
    a sequence with N runs, repeats and a tail shorter than k; below k =
    14 the N windows' sentinel has a bucket id past a byte."""
    from figbird_tpu_torch.align import index
    from figbird_tpu_torch.align.index import SENT, sorted_kmers

    monkeypatch.setattr(index, "SORT_PREFIX_BASES", prefix_bases)
    rng = np.random.default_rng(prefix_bases)
    seq = rng.integers(0, 4, 20_000).astype(np.int8)
    seq[rng.integers(0, 20_000, 60)] = 4
    seq[5_000:5_400] = seq[9_000:9_400]
    win = np.lib.stride_tricks.sliding_window_view(
        np.concatenate([seq, np.full(k - 1, 4, np.int8)]), k)
    codes = np.where((win < 4).all(1),
                     (np.minimum(win, 3).astype(np.int64)
                      * 4 ** np.arange(k - 1, -1, -1)).sum(1), SENT)
    order = np.argsort(codes, kind="stable")
    got_c, got_p, n_valid = sorted_kmers(torch.as_tensor(seq), k)
    assert n_valid == int((codes < SENT).sum()) > 0
    assert (codes == SENT).sum() > k
    np.testing.assert_array_equal(got_c.numpy(), codes[order])
    np.testing.assert_array_equal(got_p.numpy(), order)


def test_contig_shard_past_int32_raises():
    """A contig-range shard whose slice reaches 2^31 positions raises
    before anything is uploaded (its local positions would wrap); the flat
    genome is a zero-stride view, no 2 GB allocation."""
    n = BIG + 1000
    idx = KmerIndex(flat=np.broadcast_to(np.int8(4), (n + 2 * 256,)), k=15,
                    offsets=np.array([256], np.int64),
                    contig_lengths=np.array([n], np.int64),
                    sorted_codes=None, sorted_pos=None, pad=256)
    with pytest.raises(ValueError, match="past int32"):
        sharded.build_contig_shards(idx, [CPU])


def test_host_orientation_and_windows_equal_reference():
    """The host model learning's two gathers at scale: ``_oriented_rows``
    (full-length reverse rows flipped, shorter ones gathered) equals the
    reference's on reads of mixed lengths and strands, N pads included,
    and ``_flat_windows`` equals the index-array gather."""
    import figbird_tpu.pipeline as r_pipeline
    from figbird_tpu.io.fastq import ReadBatch as RReadBatch
    from figbird_tpu_torch.io.fastq import ReadBatch

    rng = np.random.default_rng(11)
    n, L = 3000, 101
    seq = rng.integers(0, 5, (n, L)).astype(np.int8)
    lens = np.where(rng.random(n) < 0.3, rng.integers(30, L, n), L)
    seq[np.arange(L)[None, :] >= lens[:, None]] = 4
    align = dict(strand=(rng.random(n) < 0.5).astype(np.int8))
    rows = np.sort(rng.choice(n, 2000, replace=False))
    got = t_pipeline._oriented_rows(ReadBatch(seq, lens.astype(np.int32)),
                                    align, rows)
    want = r_pipeline._oriented_rows(RReadBatch(seq, lens.astype(np.int32)),
                                     align, rows)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    flat = rng.integers(0, 5, 50_000).astype(np.int8)
    starts = rng.integers(0, 50_000 - L, 500)
    np.testing.assert_array_equal(
        t_pipeline._flat_windows(flat, starts, L),
        flat[starts[:, None] + np.arange(L)[None, :]])


@pytest.mark.parametrize("read_len", [101, 300])
def test_positions_past_2_31_through_collect_and_pair_table(read_len):
    """Shard-local positions packed with their shard id (the 4-word and
    the wide layout), globalized by ``Aligner._collect`` with int64 shard
    bases at and past 2^31, then paired on an index whose contigs start
    past 2^31: equal to the reference's ``_collect_pass`` and
    ``build_pair_table`` on the same arrays, every position exact."""
    rng = np.random.default_rng(5)
    n, pad = 2000, 256
    lens = np.array([300_000, 250_000, 400_000], np.int64)
    offsets = BIG + pad + np.concatenate(
        [[0], np.cumsum(lens[:-1] + pad)]).astype(np.int64)
    base = offsets - pad        # one contig a shard, the first at 2^31
    # first mates forward, second mates reverse a fragment on, some
    # unaligned
    contig = rng.integers(0, 3, n)
    local1 = rng.integers(1_000, 200_000, n)
    frag = read_len + rng.integers(0, 150, n)
    outs = []
    for m in range(2):
        loc = local1 + (frag - read_len if m else 0)
        out = dict(pos=torch.as_tensor(loc + pad, dtype=torch.int32),
                   shard=torch.as_tensor(contig, dtype=torch.int32))
        for k, lo, hi in (("score", 50, 200), ("second", -40, 50),
                          ("n_mis", 0, 4), ("cand_i", 0, 32),
                          ("clip_start", 0, 3), ("clip_end", 0, 3)):
            out[k] = torch.as_tensor(rng.integers(lo, hi, n), dtype=torch.int32)
        out["alen"] = read_len - out["clip_start"] - out["clip_end"]
        out["hit_overflow"] = torch.as_tensor(rng.random(n) < 0.1)
        out["aligned"] = torch.as_tensor(rng.random(n) < 0.9)
        out["unique"] = out["aligned"] & torch.as_tensor(rng.random(n) < 0.9)
        out["strand"] = torch.full((n,), m, dtype=torch.int8)
        outs.append(core._pack_out(out, read_len).numpy())

    al = core.Aligner.__new__(core.Aligner)
    al._contig_sharded, al._cs_base = True, base
    r_al = r_core.Aligner.__new__(r_core.Aligner)
    r_al._contig_sharded, r_al._cs_base = True, base
    got = [al._collect({"packed": p}, n) for p in outs]
    want = [r_al._collect_pass([{"packed": p}], (n, read_len)) for p in outs]
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    np.testing.assert_array_equal(got[0]["pos"], base[contig] + local1 + pad)
    assert got[0]["pos"].dtype == np.int64 and got[0]["pos"].min() >= BIG

    kw = dict(flat=np.zeros(0, np.int8), offsets=offsets,
              contig_lengths=lens, sorted_codes=None, sorted_pos=None,
              pad=pad)
    lengths = np.full(n, read_len, np.int32)
    pt = build_pair_table(KmerIndex(k=15, **kw), *got, lengths, lengths,
                          read_len + 120)
    ref = r_pair_table(RKmerIndex(k=15, **kw), *want, lengths, lengths,
                       read_len + 120)
    for f in dataclasses.fields(ref):
        a, b = getattr(pt, f.name), getattr(ref, f.name)
        assert a.dtype == b.dtype, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)
    assert pt.concordant.sum() > n // 2 and pt.window_start.min() >= BIG
    np.testing.assert_array_equal(pt.pos[:, 0], local1 + got[0]["clip_start"]
                                  + 1)


def _past_budget(monkeypatch, mode="p"):
    """``_sim40``'s iteration on a (reads 1, genome 2) CPU mesh, contig
    shards, the replicated flat's budget below the genome."""
    sim, cfg = _sim40()
    tsim = convert.sim_data(sim)
    monkeypatch.setattr(core, "HOST_FLAT_BUDGET",
                        sim.draft.total_length() - 1)
    pipe = t_pipeline.Pipeline(
        convert.figbird_config(cfg), tsim.draft, [(tsim.reads1, tsim.reads2)],
        aligner_kwargs={"batch_size": 512, "genome_shard": "contig"},
        fill_kwargs=SMALL, mesh=make_mesh(2, 2, devices=[CPU] * 2))
    with fh.Captured(t_pipeline, "_learn_model_host") as host:
        st = pipe.run_iteration(mode, 0)
    assert host.calls, "the model was not learned on the host"
    return pipe, st


def test_contig_mesh_past_budget_equals_one_device(monkeypatch):
    """The p-iteration past the budget (no device statistics: the model
    learned on the host, the aligner's tables built on the devices) equals
    the port's on one device: N, n_model, gap strings, gaptofill and
    contigs."""
    got = _past_budget(monkeypatch)
    sim, cfg = _sim40()
    tsim = convert.sim_data(sim)
    one = t_pipeline.Pipeline(
        convert.figbird_config(cfg), tsim.draft, [(tsim.reads1, tsim.reads2)],
        aligner_kwargs={"batch_size": 512}, fill_kwargs=SMALL, device="cpu")
    _assert_runs_equal(got, (one, one.run_iteration("p", 0)))
    assert got[1].n_after < got[1].n_before


def _reference_past_budget(monkeypatch, mode):
    import figbird_tpu.pipeline as r_pipeline
    from figbird_tpu.parallel import make_mesh as r_make_mesh

    sim, cfg = _sim40()
    monkeypatch.setenv("FIGBIRD_HOST_FLAT_BUDGET",
                       str(sim.draft.total_length() - 1))
    ref = r_pipeline.Pipeline(
        cfg, sim.draft, [(sim.reads1, sim.reads2)],
        aligner_kwargs={"batch_size": 512, "genome_shard": "contig"},
        fill_kwargs=SMALL, mesh=r_make_mesh(2, genome_shards=2))
    return ref, ref.run_iteration(mode, 0)


@pytest.mark.slow
@pytest.mark.parametrize("mode", ["p", "u"])
def test_contig_mesh_past_budget_equals_reference(monkeypatch, mode):
    """The iteration past the budget on the port's (1, 2) CPU mesh against
    the reference's on ``make_mesh(2, genome_shards=2)`` with
    ``FIGBIRD_HOST_FLAT_BUDGET`` below the genome."""
    _assert_runs_equal(_past_budget(monkeypatch, mode),
                       _reference_past_budget(monkeypatch, mode))


def test_run_needs_a_card_unless_asked(monkeypatch):
    """``device=None`` is the card: without one the flow raises before it
    simulates anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(fh, "simulate", None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fh.run(0.001, 1.0)


@pytest.mark.slow
def test_flow_on_cpu():
    """The script's flow at a tiny size on the CPU, the truth share and the
    sample gaps split at a position inside the second shard: N down, the
    sample gaps equal on both sides (here both the CPU), part 2 equal, the
    truth share on both sides of the split."""
    out = fh.run(0.001, 6.0, device="cpu", n_gaps=10, split_at=300_000,
                 fill_kwargs={"max_scan_lengths": 4, "instance_batch": 4},
                 aligner_kwargs={"batch_size": 1024})
    assert out["p"]["n_after"] < out["p"]["n_before"] == out["n_sim"]
    assert out["samples"]["equal"] and len(out["samples"]["gaps"]) == 3
    assert out["part2"]["equal"]
    for side in ("below", "past"):
        assert out["truth_share"][side]["share"] > 0.99
    assert out["accuracy_p"]["identity"] >= 0.95
