"""Finds a cell's pieces by name, so that a cell, a configuration, a traffic
mix, a per-layer metric or an op's roofline is added by adding files.

- ``BENCHMARK.json`` at the checkout's root: the cells, configurations and
  metrics;
- ``port_bench/configs/<config>.json``: a configuration (named by the
  ``file`` of its entry): the truth and draft with library 0
  (``simulation``, ``library``), and any further libraries on the same
  truth (``further_libraries``: each its own ``simulation`` of the reads,
  with an ``orientation`` ``FR`` or ``RF``, and its own ``library``);
- ``port_bench/traffic/<traffic>.json``: a traffic mix (an iteration's
  ``mode`` and the library ``lib`` of a u-iteration, default 0, or whole
  runs);
- ``port_bench/workloads/<cell>.json``: the cell's limits for ``correct``;
- ``port_bench/metrics/<metric>.json``: a per-layer metric's reader, as
  data: the ``Trace`` method that reads it and that method's arguments,
  such as ``stage_mean`` of ``["p", "fill"]`` or, in a run cell, of
  ``["run", "u:fill"]`` (a run's stage seconds by the iteration's mode)
  (``<metric>.py`` with a ``read(trace)`` where a metric needs code); its
  layer, unit and ``moves`` are ``BENCHMARK.json``'s alone;
- ``port_bench/roofline/<op>.py``: the bytes and operations of one call of
  the port's op ``<op>`` (files starting with ``_`` are helpers).
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[2]
BENCH = "port_bench"


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    limits: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)
    root: Path = ROOT

    @property
    def unit_metric(self) -> str:
        """The end-to-end metric of the window's unit (``setup_s`` aside)."""
        return self.traffic["metric"]


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _by_name(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} (have: "
                   f"{', '.join(e['name'] for e in entries)})")


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = load_benchmark(root)
    w = _by_name(bench["workloads"], name, "workload")
    c = _by_name(bench["configs"], w["config"], "configuration")
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in e2e_names)]
    limits = json.loads((root / BENCH / "workloads" / f"{name}.json")
                        .read_text())["limits"]
    return Cell(
        name=name, chips=int(w["chips"]), config_name=c["name"],
        config=json.loads((root / c["file"]).read_text()),
        traffic_name=w["traffic"],
        traffic=json.loads((root / BENCH / "traffic" / f"{w['traffic']}.json")
                           .read_text()),
        limits=limits, end_to_end=e2e, per_layer=per_layer, root=root)


def _load_file(path: Path, modname: str):
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, root: Path = ROOT):
    """An object with ``read(trace) -> float | None``: from
    ``port_bench/metrics/<name>.json`` (``{"read": <Trace method>, "args":
    [...]}``), else the module ``port_bench/metrics/<name>.py``."""
    path = root / BENCH / "metrics" / f"{name}.json"
    if path.exists():
        spec = json.loads(path.read_text())
        return SimpleNamespace(read=lambda trace: getattr(
            trace, spec["read"])(*spec["args"]))
    return _load_file(root / BENCH / "metrics" / f"{name}.py",
                      f"port_bench_metric_{name.replace('.', '_')}")


def roofline_ops(root: Path = ROOT) -> dict:
    """Op name -> module with ``count(*args, **kwargs) -> (bytes,
    operations)`` for every ``port_bench/roofline/<op>.py``."""
    out = {}
    for path in sorted((root / BENCH / "roofline").glob("*.py")):
        if not path.name.startswith("_"):
            out[path.stem] = _load_file(path, f"port_bench_roofline_"
                                              f"{path.stem}")
    return out
