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

The exchange between chips is not among them: every cell takes one chip.
The controls are read on the card, at the cells' own sizes, by
``port_bench/readings.py``.
"""

import dataclasses
import functools
import json
from pathlib import Path

import numpy as np
import pytest

from port_bench.harness import cell as cellmod
from port_bench.harness import registry

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


def run_iteration(traffic="p_iter", seed=123456789012):
    return cellmod.run_cell(tiny_cell(traffic, "ecoli.p"), seed, 0.0, False,
                            device="cpu")


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
