"""``scripts/chr14_scale_torch.py``, the port's chr14-scale run: its
simulation keeps ``scripts/chr14_scale.py``'s widths at every cut and
scales the gaps and repeat families at chr14's density; its accuracy
measure reads each gap's truth at the gap's own truth position (the
simulator can shift a contig's coordinates); its flow runs on the CPU at a
tiny chr14-shaped genome; and (``slow``) one p-iteration of that tiny
simulation is the same through ``figbird_tpu`` and the port."""

import ast
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

import figbird_tpu.pipeline as r_pipeline
from figbird_tpu.config import FigbirdConfig, Parameters, ReadLibrary
from figbird_tpu.simulate import SimConfig as RSimConfig
from figbird_tpu.simulate import simulate as r_simulate
from figbird_tpu_torch import convert, evalx
from figbird_tpu_torch import pipeline as t_pipeline
from figbird_tpu_torch.simulate import SimConfig, simulate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import chr14_scale_torch as chr14  # noqa: E402

torch.set_num_threads(2)

# the tiny chr14-shaped run: 90 kb (5 gaps, 8 scaffolds of 11 kb), few
# candidate lengths, small instance and aligner batches (the CPU runs the
# kernels' plain versions)
TINY_MB = 0.09
TINY_FILL = {"max_scan_lengths": 4, "instance_batch": 4}
TINY_ALIGN = {"batch_size": 256}


def _reference_simconfig() -> dict:
    """The keyword arguments of ``scripts/chr14_scale.py``'s ``SimConfig``
    call at its defaults (5,000 gaps, 88 Mb), read from its source (the
    script runs JAX when imported)."""
    src = open(os.path.join(REPO, "scripts", "chr14_scale.py")).read()
    call = next(n for n in ast.walk(ast.parse(src))
                if isinstance(n, ast.Call)
                and getattr(n.func, "id", None) == "SimConfig")
    names = {"N_GAPS": 5000, "GENOME_MB": 88.0}
    out = {}
    for kw in call.keywords:
        out[kw.arg] = eval(compile(ast.Expression(kw.value), "<cfg>", "eval"),
                           {"int": int}, names)
    return out


@pytest.mark.parametrize("genome_mb", [88.0, 44.0, 11.0, 0.09])
def test_sim_config_keeps_chr14_widths(genome_mb):
    """Every field of the reference script's SimConfig but the genome's
    length, the gaps and the repeat families is kept at every cut; those
    two scale at 5,000 and 150 per 88 Mb, and at 88 Mb the configuration is
    the reference's."""
    want = _reference_simconfig()
    got = dataclasses.asdict(chr14.sim_config(genome_mb))
    share = genome_mb / 88.0
    assert got["genome_len"] == int(genome_mb * 1e6)
    assert got["n_gaps"] == max(1, round(5000 * share))
    assert got["repeat_count"] == round(150 * share)
    for k, v in want.items():
        if k not in ("genome_len", "n_gaps", "repeat_count"):
            assert got[k] == v, k
    if genome_mb == 88.0:
        assert {k: got[k] for k in want} == want
    assert chr14.sim_config(genome_mb, 7).n_gaps == 7


def test_accuracy_reads_the_truth_at_shifted_coordinates():
    """A simulation where a long gap landed over an earlier one: the draft
    contig is longer than its truth, so the gaps after it sit at shifted
    truth positions.  Strings cut from the truth at the gaps' truth
    positions are all right by ``fill_accuracy``; the draft-coordinate
    measure (``evalx.fill_accuracy_vs_truth``) calls many of them wrong."""
    sim = simulate(SimConfig(genome_len=2_000_000, n_contigs=2, n_gaps=300,
                             gap_len_tail=0.5, coverage=0.01, seed=2))
    longer = [len(d) - len(t)
              for d, t in zip(sim.draft.contigs, sim.truth.contigs)]
    assert longer[0] > 0 and longer[1] == 0, longer
    gaps = sim.draft.find_gaps()
    starts = chr14.truth_starts(sim, gaps)
    assert sum(t is None for t in starts) == 1
    shifted = [t is not None and t != g.start for g, t in zip(gaps, starts)]
    assert sum(shifted) > 50
    strings = [sim.truth.contigs[g.contig][t : t + g.length] if t is not None
               else np.full(g.length, 4, np.int8)
               for g, t in zip(gaps, starts)]
    acc = chr14.fill_accuracy(sim, gaps, strings)
    assert acc["identity"] == 1.0
    assert acc["closed"] == len(gaps) - 1
    old = evalx.fill_accuracy_vs_truth(sim.truth, gaps, strings)
    assert old.identity < 0.9


def test_flow_on_cpu():
    """The script's flow on the CPU at a tiny chr14-shaped genome: N down
    in the p- and the u-iteration, the warm rerun equal (asserted inside),
    the sample gaps equal, and every key of the JSON line."""
    out = chr14.run(TINY_MB, device="cpu", fill_kwargs=TINY_FILL,
                    aligner_kwargs=TINY_ALIGN)
    for key in ("genome_len", "n_reads", "n_gaps", "n_sim", "p", "p_warm",
                "u", "wall_p_cold_s", "wall_p_warm_s", "wall_u_s",
                "accuracy_p", "accuracy_p_u", "samples", "peak_device_bytes",
                "peak_host_rss_bytes", "nvidia_smi"):
        assert key in out, key
    for mode in ("p", "u"):
        rec = out[mode]
        assert rec["n_after"] < rec["n_before"]
        for key in ("stages", "fill_stats", "launches", "launches_by_shape"):
            assert key in rec, (mode, key)
    assert out["p"]["n_before"] == out["n_sim"]
    assert out["n_gaps"] == 5 and out["genome_len"] == 90_000
    assert out["samples"] and all(s["equal"] for s in out["samples"].values())
    assert out["accuracy_p"]["identity"] >= 0.95
    assert out["device"] == "cpu" and out["peak_device_bytes"] is None


def test_flow_needs_a_card_unless_asked(monkeypatch):
    """``device=None`` is the card: without one the flow raises before it
    simulates anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(chr14, "simulate", None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        chr14.run(TINY_MB)


@pytest.mark.slow
def test_tiny_p_iteration_equal_reference():
    """The tiny chr14-shaped simulation through ``figbird_tpu``'s and the
    port's ``run_iteration("p", 0)`` on the CPU: N, gap strings, gaptofill
    and contigs equal."""
    sim = r_simulate(RSimConfig(**dataclasses.asdict(
        chr14.sim_config(0.15))))
    tsim = convert.sim_data(sim)
    cfg = FigbirdConfig(
        draft_genome="", output_folder="",
        read_pairs=[ReadLibrary("", "", avg_insert_size=200,
                                max_read_length=101)],
        parameters=Parameters(trim_len=0))
    kw = dict(fill_kwargs={"max_scan_lengths": 16, "instance_batch": 16},
              aligner_kwargs={"batch_size": 4096})
    ref = r_pipeline.Pipeline(cfg, sim.draft, [(sim.reads1, sim.reads2)],
                              **kw)
    st_ref = ref.run_iteration("p", 0)
    got = t_pipeline.Pipeline(convert.figbird_config(cfg), tsim.draft,
                              [(tsim.reads1, tsim.reads2)], device="cpu",
                              **kw)
    st_got = got.run_iteration("p", 0)
    assert (st_got.n_before, st_got.n_after) == (st_ref.n_before,
                                                 st_ref.n_after)
    assert st_got.n_after < st_got.n_before
    (_, s_ref, f_ref), = ref.result.gap_history
    (_, s_got, f_got), = got.result.gap_history
    assert len(s_got) == len(s_ref) == 9
    for a, b in zip(s_got, s_ref):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(np.asarray(f_got), np.asarray(f_ref))
    for a, b in zip(got.genome.contigs, ref.genome.contigs):
        np.testing.assert_array_equal(a, b)
