"""What a traced run records, from the benchmark's own files.

- ``OpCalls``: every call of each op that ``port_bench/roofline/`` has a
  file for, labelled for the profiler, with that call's least time (its
  bytes over the memory rate or its operations over the f32 rate, from the
  call's arguments).
- ``stage_labels``: ``StageTimer.stage`` of the port wrapped in
  ``torch.profiler.record_function("stage:<name>")``, so the profile knows
  which stage the host was in.
- ``timed_calls``: host seconds in named functions (the run's parsers).
- ``profile_summary``: the device's busy time (the union of the CUDA
  activity's intervals, as ``chip_smoke.py::busy_share`` takes it), the
  device ops that took most time, the idle time by host stage, how far
  device work ran past each stage's end, and each op's device seconds: the
  kernels and copies launched inside its ``op:<name>`` range, found by the
  profiler's correlation of each device event with its launch.
"""

from __future__ import annotations

import bisect
import contextlib
import importlib
import itertools
import sys
import time
from collections import Counter
from dataclasses import dataclass, field

from port_bench.roofline import _peaks

PORT = "figbird_tpu_torch"
# the record_function range around the profiled units
WINDOW = "port_bench:window"


def _bindings(fn):
    """(module, attribute) of every loaded module of the port that holds
    ``fn`` under its name (callers import ops by name)."""
    out = []
    for name, mod in list(sys.modules.items()):
        if mod is None or name.split(".")[0] != PORT:
            continue
        if getattr(mod, fn.__name__, None) is fn:
            out.append(mod)
    return out


@contextlib.contextmanager
def rebind(fn_owner_module, name: str, make_wrapper):
    """Replace the port's function ``name`` of ``fn_owner_module`` by
    ``make_wrapper(fn)`` wherever the port's modules hold it."""
    fn = getattr(fn_owner_module, name)
    wrapped = make_wrapper(fn)
    mods = _bindings(fn)
    for m in mods:
        setattr(m, name, wrapped)
    try:
        yield
    finally:
        for m in mods:
            setattr(m, name, fn)


def find_op(name: str):
    """The port module that defines the op ``name`` (the port's pipeline
    loaded first, and with it every module that holds an op)."""
    importlib.import_module(f"{PORT}.pipeline")
    for mod_name, mod in list(sys.modules.items()):
        if mod is None or mod_name.split(".")[0] != PORT:
            continue
        fn = getattr(mod, name, None)
        if callable(fn) and getattr(fn, "__module__", None) == mod_name:
            return mod
    raise LookupError(f"the port defines no op {name!r}")


@dataclass
class OpCalls:
    """Every call of each op that ``port_bench/roofline/`` has a file for,
    inside a ``record_function("op:<name>")`` range so that the profile can
    tell its kernels and copies, with that call's least time (its bytes
    over the memory rate or its operations over the f32 rate, from the
    call's arguments)."""
    counters: dict                      # op -> roofline module
    least: dict = field(default_factory=dict)     # op -> [calls, seconds]
    # launches by (op, first argument's shape past the batch axis, last
    # argument where it is an int: the band ops' Wp, the fold's W)
    shapes: Counter = field(default_factory=Counter)

    @contextlib.contextmanager
    def active(self):
        import torch

        with contextlib.ExitStack() as stack:
            for op, counter in self.counters.items():
                def make(fn, op=op, counter=counter):
                    def wrapper(*args, **kwargs):
                        with torch.profiler.record_function(f"op:{op}"):
                            out = fn(*args, **kwargs)
                        n_b, n_o = counter.count(*args, **kwargs)
                        s = self.least.setdefault(op, [0, 0.0])
                        s[0] += 1
                        s[1] += max(float(n_b) / _peaks.BYTES_S,
                                    float(n_o) / _peaks.OPS_S)
                        last = args[-1] if isinstance(args[-1], int) else None
                        self.shapes[op, tuple(args[0].shape[1:]), last] += 1
                        return out
                    return wrapper
                stack.enter_context(rebind(find_op(op), op, make))
            yield

    def summary(self, device_s: dict) -> dict:
        """op -> [calls, device seconds, least seconds]; and "all"."""
        out = {op: [n, device_s.get(op, 0.0), least]
               for op, (n, least) in self.least.items()}
        if out:
            out["all"] = [sum(v[i] for v in out.values()) for i in range(3)]
        return out


@contextlib.contextmanager
def stage_labels():
    import torch

    from figbird_tpu_torch.utils import trace

    orig = trace.StageTimer.stage

    @contextlib.contextmanager
    def labelled(self, name, items=0):
        with torch.profiler.record_function(f"stage:{name}"):
            with orig(self, name, items):
                yield

    trace.StageTimer.stage = labelled
    try:
        yield
    finally:
        trace.StageTimer.stage = orig


@contextlib.contextmanager
def timed_calls(module, name: str, seconds: list, label: str | None = None):
    """Add each call's host seconds of ``module.name`` to ``seconds``
    (labelled ``stage:<label>`` for the profiler where given)."""
    import torch

    fn = getattr(module, name)

    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            if label is None:
                return fn(*args, **kwargs)
            with torch.profiler.record_function(f"stage:{label}"):
                return fn(*args, **kwargs)
        finally:
            seconds.append(time.perf_counter() - t0)

    setattr(module, name, wrapper)
    try:
        yield
    finally:
        setattr(module, name, fn)


class _Ranges:
    """Named host ranges ``(name, start, end)``, which nest or follow one
    another (one thread's ``record_function`` ranges), for finding the
    innermost one that holds a time, as a scan of every range finds it: a
    bisection and a walk back over the ranges still open then, so reading a
    profile grows with its events, not with its events times its ranges."""

    def __init__(self, ranges):
        self.ranges = sorted(ranges, key=lambda r: (r[1], -r[2]))
        self.starts = [a for _, a, _ in self.ranges]
        # the latest end of the ranges that start up to each one
        self.reach = list(itertools.accumulate(
            (b for _, _, b in self.ranges), max))

    def at(self, t, closed: bool):
        """The least long range holding ``t`` (its end included where
        ``closed``), or None."""
        best = None
        j = bisect.bisect_right(self.starts, t) - 1
        while j >= 0 and self.reach[j] >= t:
            name, a, b = self.ranges[j]
            if t < b or (closed and t == b):
                best = min(best or (b - a, name), (b - a, name))
            j -= 1
        return None if best is None else best[1]


def _union(spans):
    """Merged intervals of ``spans`` (start, end), sorted."""
    merged = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1][1] = b
        else:
            merged.append([a, b])
    return merged


def profile_summary(prof) -> dict:
    """The profiled window's seconds (the ``WINDOW`` range), its busy
    seconds, the ten device ops with most time, idle seconds by the host
    stage they fell in, and each stage's longest run of device work past
    its end (ms).  Read from the profiler's raw events; the device's are its
    kernels, copies and sets (user annotations mirrored on the device are
    left out)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    dev, stages, window, ops = [], [], None, []
    launch_at, cpu_at = {}, {}          # correlation id -> CPU start
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == cuda:
            if not (e.is_user_annotation() or name.startswith("stage:")
                    or name.startswith("op:") or name == WINDOW):
                dev.append((name, e.start_ns(), e.end_ns(),
                            e.correlation_id(), e.linked_correlation_id()))
            continue
        if e.correlation_id():
            (launch_at if name.startswith("cu") else cpu_at)[
                e.correlation_id()] = e.start_ns()
        if name == WINDOW:
            window = (e.start_ns(), e.end_ns())
        elif name.startswith("stage:"):
            stages.append((name[6:], e.start_ns(), e.end_ns()))
        elif name.startswith("op:"):
            ops.append((name[3:], e.start_ns(), e.end_ns()))
    busy = _union([(a, b) for _, a, b, _, _ in dev])
    busy_s = sum(b - a for a, b in busy) / 1e9
    by_op: dict = {}
    op_s: dict = {}
    op_ranges = _Ranges(ops)
    for name, a, b, corr, linked in dev:
        by_op[name] = by_op.get(name, 0.0) + (b - a) / 1e9
        t = launch_at.get(corr, cpu_at.get(linked))
        if t is None:
            continue
        op = op_ranges.at(t, closed=True)
        if op is not None:
            op_s[op] = op_s.get(op, 0.0) + (b - a) / 1e9
    top = sorted(by_op.items(), key=lambda x: -x[1])[:10]

    stage_ranges = _Ranges(stages)
    idle: dict = {}
    edges = [window[0]] + [x for iv in busy for x in iv] + [window[1]]
    for i in range(0, len(edges), 2):
        a, b = edges[i], edges[i + 1]
        if b > a:
            label = stage_ranges.at((a + b) / 2, closed=False) \
                or "outside any stage"
            idle[label] = idle.get(label, 0.0) + (b - a) / 1e9
    spill: dict = {}
    busy_starts = [a for a, _ in busy]
    for name, a, b in stages:
        k = bisect.bisect_right(busy_starts, b) - 1
        past = busy[k][1] - b if k >= 0 and b < busy[k][1] else 0.0
        spill[name] = max(spill.get(name, 0.0), past / 1e6)
    return {"busy_s": busy_s, "window_s": (window[1] - window[0]) / 1e9,
            "device_ops": [[n, s] for n, s in top],
            "idle_gaps": [[f"idle in {n}", s] for n, s in
                          sorted(idle.items(), key=lambda x: -x[1])[:10]],
            "spill_ms": spill, "op_s": op_s}


@dataclass
class Trace:
    """What a traced run hands the per-layer metrics' readers."""
    mode: str                       # "p", "u" or "run"
    stages: list = field(default_factory=list)    # per window unit
    parse_s: list = field(default_factory=list)   # per window run
    ops: dict = field(default_factory=dict)       # OpCalls.summary()
    busy_s: float | None = None
    window_s: float | None = None
    peak_bytes: int | None = None

    def stage_mean(self, mode: str, *names: str):
        """Seconds in the named stages per unit of the window, or None in
        another mode.  An iteration's stages are the ``StageTimer``'s
        names (``"fill"``); a run's are summed over its iterations by their
        mode (``"u:fill"``)."""
        if self.mode != mode or not self.stages:
            return None
        return sum(sum(st.get(n, 0.0) for n in names)
                   for st in self.stages) / len(self.stages)

    def roofline_percent(self, mode: str):
        if self.mode != mode or "all" not in self.ops:
            return None
        _, seconds, least = self.ops["all"]
        return 100.0 * least / seconds if seconds > 0 else None

    def idle_percent(self, mode: str):
        if self.mode != mode or not self.window_s:
            return None
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def peak_gib(self, mode: str):
        if self.mode != mode or self.peak_bytes is None:
            return None
        return self.peak_bytes / 2**30

    def parse_mean(self, mode: str):
        if self.mode != mode or not self.parse_s:
            return None
        return sum(self.parse_s) / len(self.parse_s)
