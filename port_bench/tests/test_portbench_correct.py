"""``correct`` on the CPU at a test size: the harness's whole run of a cell
but the look for a card (the port and the reference on ``device="cpu"``,
which runs the kernels' plain versions), held true on the port as it is and
false with the timed path broken underneath it, once for each fault an
iteration or a run can have:

- a step that returns its state unchanged (the splice hands back the draft
  it was given);
- half of the batch left out (the model learned from half the pairs);
- an answer altered where it is produced (one base of one filled gap; a
  read placed one base off; each op's output off by a part in a thousand,
  or by one in an integer output).

A configuration of two libraries (the fragment library and an RF jump
library) is held the same way through a p-iteration, a u-iteration on the
jump library and a whole run, and false with a jump mate placed one base
off or the jump library's ``is_reverse`` ignored.

The exchange between chips is not among them: every cell takes one chip.
The controls are read on the card, at the cells' own sizes, by
``port_bench/readings.py``.
"""

import dataclasses
import functools
import json
import time
from pathlib import Path

import numpy as np
import pytest

from port_bench.harness import capture, inputs, registry, tracing
from port_bench.harness import cell as cellmod

PB = Path(__file__).resolve().parents[1]
SMALL = {"fill_kwargs": {"max_scan_lengths": 16, "instance_batch": 16},
         "aligner_kwargs": {"batch_size": 4096}}


def tiny_cell(traffic: str, limits_of: str) -> registry.Cell:
    """A cell of the E. coli configuration at a test size (the unmapped
    EM's plain versions are slow on the CPU: one contig and two gaps there)."""
    cfg = json.loads((PB / "configs" / "ecoli_k12_frag.json").read_text())
    cfg["simulation"].update(genome_len=40_000, n_contigs=2, n_gaps=5)
    cfg["pipeline"] = SMALL
    if traffic == "u_iter":
        cfg["simulation"].update(genome_len=40_000, n_contigs=1, n_gaps=2)
    tr = json.loads((PB / "traffic" / f"{traffic}.json").read_text())
    limits = json.loads((PB / "workloads" / f"{limits_of}.json")
                        .read_text())["limits"]
    return registry.Cell(
        name=f"tiny.{tr['mode']}", chips=1, config_name="tiny", config=cfg,
        traffic_name=traffic, traffic=tr, limits=limits,
        end_to_end=[{"name": "setup_s", "unit": "s"},
                    {"name": tr["metric"], "unit": "s"}])


# an RF jump library, its insert scaled to the test's 40 kb genome
JUMP = {"simulation": {"read_len": 101, "insert_mean": 1500,
                       "insert_sd": 150, "coverage": 10.0,
                       "error_rate": 0.005, "orientation": "RF"},
        "library": {"avg_insert_size": 1500, "max_read_length": 101,
                    "is_reverse": 1}}


def two_library_cell(traffic: str, limits_of: str) -> registry.Cell:
    """The test-size cell with the jump library after the fragment one; its
    u-iteration on the jump library (``"lib": 1``)."""
    cell = tiny_cell(traffic, limits_of)
    cell.config["further_libraries"] = [JUMP]
    if traffic == "u_iter":
        cell.traffic["lib"] = 1
    return dataclasses.replace(cell, name=f"tiny2.{cell.traffic['mode']}")


def run_iteration(traffic="p_iter", seed=123456789012, cell=None):
    cell = cell or tiny_cell(traffic, "ecoli.p")
    return cellmod.run_cell(cell, seed, 0.0, False, device="cpu")


def unchanged(monkeypatch):
    from figbird_tpu_torch import genome

    monkeypatch.setattr(genome.Genome, "splice_gaps",
                        lambda self, *a, **k: self)


def half_batch(monkeypatch):
    from figbird_tpu_torch import pipeline

    learn = pipeline._learn_model

    def half(idx, pt, *args, **kwargs):
        m = np.asarray(pt.model).copy()
        m[len(m) // 2 :] = False
        return learn(idx, dataclasses.replace(pt, model=m), *args, **kwargs)

    monkeypatch.setattr(pipeline, "_learn_model", half)


def altered(monkeypatch):
    from figbird_tpu_torch import pipeline

    fill = pipeline.fill_gaps

    def wrong(*args, **kwargs):
        res = fill(*args, **kwargs)
        i = next(i for i, s in enumerate(res.gap_strings) if len(s))
        s = np.array(res.gap_strings[i], np.int8)
        s[0] = (s[0] + 1) % 4
        res.gap_strings[i] = s
        return res

    monkeypatch.setattr(pipeline, "fill_gaps", wrong)


def misplaced(monkeypatch):
    from figbird_tpu_torch.align import core

    unpack = core.unpack_out

    def off(packed):
        out = unpack(packed)
        out["pos"] = out["pos"] + 1
        return out

    monkeypatch.setattr(core, "unpack_out", off)


def jump_misplaced(monkeypatch):
    """The aligner places the jump library's mates one base off."""
    from figbird_tpu_torch import pipeline
    from figbird_tpu_torch.align import core

    align, unpack = pipeline.Pipeline._align_lib, core.unpack_out

    def off(packed):
        out = unpack(packed)
        out["pos"] = out["pos"] + 1
        return out

    def jump_off(self, genome, lib_i, *args, **kwargs):
        if not self.cfg.read_pairs[lib_i].is_jump:
            return align(self, genome, lib_i, *args, **kwargs)
        core.unpack_out = off
        try:
            return align(self, genome, lib_i, *args, **kwargs)
        finally:
            core.unpack_out = unpack

    monkeypatch.setattr(pipeline.Pipeline, "_align_lib", jump_off)


def not_reversed(monkeypatch):
    """The pipeline keeps an ``is_reverse`` library as it was read."""
    from figbird_tpu_torch import pipeline

    init = pipeline.Pipeline.__init__

    def as_read(self, cfg, genome, libs, *args, **kwargs):
        init(self, cfg, genome, libs, *args, **kwargs)
        self.libs = [pair if lib.is_reverse else own for own, pair, lib in
                     zip(self.libs, libs, cfg.read_pairs)]

    monkeypatch.setattr(pipeline.Pipeline, "__init__", as_read)


def op_off(name: str, how):
    """A fault in one op: its output altered by ``how`` wherever the port's
    modules call it."""
    def fault(monkeypatch):
        import sys

        from port_bench.harness import tracing

        orig = getattr(tracing.find_op(name), name)

        @functools.wraps(orig)
        def wrong(*args, **kwargs):
            return how(orig(*args, **kwargs))

        for mod in tracing._bindings(orig):
            monkeypatch.setattr(sys.modules[mod.__name__], name, wrong)
    fault.__name__ = f"{name}_off"
    return fault


def _starts_off(out):
    return {k: v + (k == "start") for k, v in out.items()}


def _one_base(out):
    cons = out[0].clone()
    cons.view(-1)[(cons.view(-1) < 4).nonzero()[0]] += 1
    return cons % 4, out[1]


OP_FAULTS = [
    (op_off("band_score_soft", lambda s: s * 1.001), "soft_score_err"),
    (op_off("band_score_hard", lambda s: s * 1.001), "hard_score_err"),
    (op_off("cascade_counts", lambda c: c * 1.001), "counts_err"),
    (op_off("fold_counts", lambda c: c * 1.001), "counts_err"),
    (op_off("score_candidates", _starts_off), "candidate_scores_off"),
    (op_off("consensus_from_counts", _one_base), "consensus_off")]


@pytest.mark.parametrize("traffic", ["p_iter", "u_iter"])
def test_the_port_as_it_is_is_correct(traffic):
    res = run_iteration(traffic)
    assert res["correct"] is True, res["checks"]
    assert res["failed"] == 0 and res["attempted"] == 1
    assert set(res["checks"]) == set(ITERATION_CHECKS)
    assert res["checks"]["placed_off_truth"]["value"] == 0
    assert list(res)[-1] == "checks"


ITERATION_CHECKS = ("align_rows", "model_fields", "triage_gaps",
                    "fill_gaps_pct", "placed_gaps", "spliced_contigs",
                    "placed_off_truth", "soft_score_err", "hard_score_err",
                    "counts_err", "candidate_scores_off", "consensus_off")


@pytest.mark.parametrize("traffic", ["p_iter", "u_iter"])
@pytest.mark.parametrize("fault,number", [
    (unchanged, "spliced_contigs"), (half_batch, "model_fields"),
    (altered, "fill_gaps_pct"), (misplaced, "placed_off_truth")],
    ids=lambda x: getattr(x, "__name__", x))
def test_a_broken_iteration_is_not_correct(monkeypatch, fault, number,
                                           traffic):
    fault(monkeypatch)
    res = run_iteration(traffic)
    assert res["correct"] is False
    assert res["checks"][number]["value"] > res["checks"][number]["limit"]
    assert res["failed"] == res["attempted"] == 1


@pytest.mark.parametrize("fault,number", OP_FAULTS,
                         ids=lambda x: getattr(x, "__name__", x))
def test_a_wrong_op_is_caught_by_the_plain_reference(monkeypatch, fault,
                                                     number):
    fault(monkeypatch)
    res = run_iteration("p_iter")
    assert res["correct"] is False
    assert res["checks"][number]["value"] > res["checks"][number]["limit"]


@pytest.fixture
def small_cli(monkeypatch):
    """The command line's ``Pipeline`` at the tests' small batch and scan
    (the reference gets the same from the configuration's ``pipeline``)."""
    from figbird_tpu_torch import pipeline

    init = pipeline.Pipeline.__init__

    def small(self, *args, **kwargs):
        kwargs.update(SMALL)
        init(self, *args, **kwargs)

    monkeypatch.setattr(pipeline.Pipeline, "__init__", small)


@pytest.mark.parametrize("fault", [None, unchanged, altered],
                         ids=lambda f: getattr(f, "__name__", "as_it_is"))
def test_a_whole_run(small_cli, monkeypatch, fault):
    if fault is not None:
        fault(monkeypatch)
    res = cellmod.run_cell(tiny_cell("cli_run", "ecoli.run"), 77, 0.0, False,
                           device="cpu")
    assert set(res["checks"]) == {
        "final_contigs_pct", "combined_gaps_pct", "iterations_off",
        "soft_score_err", "hard_score_err", "counts_err",
        "candidate_scores_off", "consensus_off"}
    assert res["correct"] is (fault is None), res["checks"]


@pytest.mark.parametrize("traffic", ["p_iter", "u_iter"])
def test_two_libraries_as_they_are_are_correct(traffic):
    res = run_iteration(cell=two_library_cell(traffic, "ecoli.p"))
    assert res["correct"] is True, res["checks"]
    assert set(res["checks"]) == set(ITERATION_CHECKS)


@pytest.mark.parametrize("fault", [jump_misplaced, not_reversed],
                         ids=lambda f: f.__name__)
def test_a_broken_jump_library_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    res = run_iteration(cell=two_library_cell("u_iter", "ecoli.p"))
    assert res["correct"] is False
    off = res["checks"]["placed_off_truth"]
    assert off["value"] > off["limit"]


@pytest.mark.parametrize("fault", [None, jump_misplaced, not_reversed],
                         ids=lambda f: getattr(f, "__name__", "as_it_is"))
def test_two_libraries_in_a_whole_run(small_cli, monkeypatch, fault):
    if fault is not None:
        fault(monkeypatch)
    res = cellmod.run_cell(two_library_cell("cli_run", "ecoli.run"), 78,
                           0.0, False, device="cpu")
    assert res["correct"] is (fault is None), res["checks"]


# stages the pipeline adds to its timer inside its align stages
NESTED = {"index_build", "aligner_init", "pair_table"}


def test_a_run_record_holds_stage_seconds_by_mode(small_cli, tmp_path):
    cell = two_library_cell("cli_run", "ecoli.run")
    unit = capture.RunUnit(cell, inputs.simulate(cell.config, 79), tmp_path,
                           device="cpu")
    t0 = time.perf_counter()
    rec = unit()
    wall = time.perf_counter() - t0
    modes = {k.split(":")[0] for k in rec.stages}
    assert modes == {"p", "u"}, rec.stages
    assert sum(v for k, v in rec.stages.items()
               if k.split(":")[1] not in NESTED) <= wall
    trace = tracing.Trace("run", stages=[rec.stages])
    assert trace.stage_mean("run", "u:fill") > 0
    assert trace.stage_mean("run", "p:align") > 0
