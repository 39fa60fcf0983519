"""The harness is driven by files: a cell, a configuration, a traffic mix
and a per-layer metric are added by adding files, and nothing is edited
but ``BENCHMARK.json``'s new entries."""

import json
import shutil
from pathlib import Path

import pytest

from port_bench.harness import registry, tracing

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_every_cell_loads_with_its_metrics():
    for w in BENCH["workloads"]:
        cell = registry.load_cell(w["name"])
        names = {m["name"] for m in cell.end_to_end}
        assert names == {"setup_s", cell.unit_metric}
        assert cell.per_layer, cell.name
        assert set(cell.limits) >= {"fill_gaps_pct"} or set(cell.limits) >= {
            "final_contigs_pct"}


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_each_metric_has_a_reader_that_reads_its_cells_mode(m):
    """Layer, unit and ``moves`` are ``BENCHMARK.json``'s alone; the reader
    reads the trace of its cells' traffic and nothing else."""
    spec = json.loads((ROOT / "port_bench" / "metrics" / f"{m['name']}.json")
                      .read_text())
    assert not set(spec) - {"about", "read", "args"}
    reader = registry.metric_reader(m["name"])
    modes = {registry.load_cell(w).traffic["mode"] for w in m["workloads"]}
    assert len(modes) == 1
    mode, = modes
    full = tracing.Trace(mode=mode, stages=[{s: 1.0 for s in (
        "align", "model", "triage", "fill")}], parse_s=[1.0],
        ops={"all": [1, 2.0, 1.0]}, busy_s=1.0, window_s=4.0,
        peak_bytes=2**30)
    assert reader.read(full) is not None
    # a reader that finds nothing returns nothing
    assert reader.read(tracing.Trace(mode="none")) is None


def test_a_new_cell_config_traffic_and_metric_are_files(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "port_bench", root / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    pb = root / "port_bench"
    cfg = json.loads((pb / "configs" / "ecoli_k12_frag.json").read_text())
    cfg["simulation"]["n_gaps"] = 80
    (pb / "configs" / "ecoli_more_gaps.json").write_text(json.dumps(cfg))
    (pb / "traffic" / "p_iter_again.json").write_text(json.dumps(
        {"unit": "iteration", "mode": "p", "metric": "p_iter_s",
         "profile_units": 1}))
    (pb / "workloads" / "more.p.json").write_text(
        (pb / "workloads" / "ecoli.p.json").read_text())
    (pb / "metrics" / "pair_s.p.json").write_text(json.dumps(
        {"read": "stage_mean", "args": ["p", "pair_table"]}))
    (pb / "metrics" / "stages_n.p.py").write_text(
        "def read(trace):\n    return float(len(trace.stages))\n")
    bench["configs"].append({"name": "ecoli_more_gaps", "source": "x",
                             "file": "port_bench/configs/ecoli_more_gaps.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "more.p", "config": "ecoli_more_gaps",
                               "traffic": "p_iter_again", "chips": 1,
                               "why": "x"})
    bench["end_to_end"][1]["workloads"].append("more.p")
    for name in ("pair_s.p", "stages_n.p"):
        bench["per_layer"].append({"name": name, "unit": "s",
                                   "better": "lower",
                                   "source": "program_span", "layer": "align",
                                   "moves": "p_iter_s",
                                   "workloads": ["more.p"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = registry.load_cell("more.p", root)
    assert cell.config["simulation"]["n_gaps"] == 80
    assert cell.traffic["profile_units"] == 1
    assert [m["name"] for m in cell.per_layer] == ["pair_s.p", "stages_n.p"]
    tr = tracing.Trace(mode="p", stages=[{"pair_table": 1.0},
                                         {"pair_table": 3.0}])
    assert registry.metric_reader("pair_s.p", root).read(tr) == 2.0
    assert registry.metric_reader("stages_n.p", root).read(tr) == 2.0
    # the cells already there are as they were
    assert registry.load_cell("ecoli.p", root).per_layer == \
        registry.load_cell("ecoli.p").per_layer
    # and an op's roofline file is found by its name
    (pb / "roofline" / "new_op.py").write_text(
        "def count(x):\n    return 1, 1\n")
    assert "new_op" in registry.roofline_ops(root)


def nested_ranges(rng, a: int, b: int, depth: int, out: list) -> list:
    """Ranges of one thread in [a, b): one after another, each holding
    more down to ``depth``; ends may touch the next start."""
    t = a
    while depth and t < b - 2:
        s = rng.randint(t, min(b - 2, t + (b - a) // 6))
        e = rng.randint(s + 1, min(b, s + (b - a) // 3 + 1))
        out.append((f"r{len(out)}", s, e))
        nested_ranges(rng, s, e, depth - 1, out)
        t = e + rng.randint(0, 3)
    return out


@pytest.mark.parametrize("closed", [True, False])
def test_the_innermost_range_is_the_one_a_full_scan_finds(closed):
    """``_Ranges.at`` against the scan of every range (the least long one
    holding the time)."""
    import random

    rng = random.Random(5)
    ranges = nested_ranges(rng, 0, 10_000, 4, [])
    found = tracing._Ranges(ranges)
    assert len(ranges) > 100
    for t in range(-5, 10_010, 7):
        inner = [(b - a, n) for n, a, b in ranges
                 if a <= t < b or (closed and t == b)]
        assert found.at(t, closed) == (min(inner)[1] if inner else None)
