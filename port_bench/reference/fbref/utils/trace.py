"""Tracing / profiling.

The reference's observability is wall-clock prints per fill step
(FillGaps.cpp:935-938), per gap (Figbird.cpp:7422-7424) and per run
(RunFigbird.sh:3,783-785), plus the draw_read placement visualisation.
Here (``figbird_tpu/utils/trace.py``): a stage timer with reads/s counters
and an optional ``torch.profiler`` trace around any pipeline span.
"""

from __future__ import annotations

import contextlib
import json
import sys
import time
from dataclasses import dataclass, field


@dataclass
class StageTimer:
    """Accumulates per-stage wall time + item counts; prints a summary."""

    stages: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def stage(self, name: str, items: int = 0):
        t0 = time.time()
        try:
            yield
        finally:
            dt = time.time() - t0
            s = self.stages.setdefault(name, {"seconds": 0.0, "items": 0,
                                              "calls": 0})
            s["seconds"] += dt
            s["items"] += items
            s["calls"] += 1

    def add(self, name: str, seconds: float, items: int = 0):
        s = self.stages.setdefault(name, {"seconds": 0.0, "items": 0,
                                          "calls": 0})
        s["seconds"] += seconds
        s["items"] += items
        s["calls"] += 1

    def report(self, fh=sys.stderr) -> dict:
        out = {}
        for name, s in self.stages.items():
            rate = s["items"] / s["seconds"] if s["seconds"] > 0 else 0.0
            out[name] = dict(s, items_per_sec=round(rate, 1))
            print(f"# {name}: {s['seconds']:.2f}s  "
                  f"{s['items']} items  {rate:.0f}/s", file=fh)
        return out

    def dump_json(self, path):
        with open(path, "w") as fh:
            json.dump(self.report(fh=_Null()), fh, indent=1)


class _Null:
    def write(self, *_):
        pass


@contextlib.contextmanager
def trace_context(logdir: str | None):
    """Wrap a span in a ``torch.profiler`` trace (host and, where PyTorch
    was built with it, CUDA activity) when ``logdir`` is set; the Chrome
    trace lands in ``logdir/trace.json``.  On an exception the profiler is
    stopped and no trace is written."""
    if not logdir:
        yield
        return
    from pathlib import Path

    from torch.profiler import ProfilerActivity, profile, supported_activities

    acts = [a for a in (ProfilerActivity.CPU, ProfilerActivity.CUDA)
            if a in supported_activities()]
    prof = profile(activities=acts)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
    Path(logdir).mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(Path(logdir) / "trace.json"))
