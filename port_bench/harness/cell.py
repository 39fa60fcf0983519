"""One run of one cell: set-up, the measured window, the traced passes,
the comparison with the reference, and the result line."""

from __future__ import annotations

import contextlib
import gc
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from port_bench.harness import (calls, capture, compare, inputs, registry,
                                tracing)

FORBIDDEN = ("jax", "jaxlib", "flax", "figbird_tpu")


def log(msg: str) -> None:
    print(f"# port_bench: {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _sync(device) -> None:
    import torch

    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def _peak(device, reset=False) -> int | None:
    import torch

    if not str(device).startswith("cuda"):
        return None
    peak = torch.cuda.max_memory_allocated()
    if reset:
        torch.cuda.reset_peak_memory_stats()
    return peak


@contextlib.contextmanager
def _parse_timers(on: bool, seconds: list, label: str | None = None):
    """The run's FASTA and FASTQ parsers timed (when ``on``)."""
    if not on:
        yield
        return
    from figbird_tpu_torch.io import fasta, fastq

    with tracing.timed_calls(fasta, "read_fasta", seconds, label), \
            tracing.timed_calls(fastq, "read_fastq", seconds, label):
        yield


def _steal_s() -> float | None:
    """Seconds the hypervisor took from this machine's CPUs (all of them),
    from ``/proc/stat``."""
    try:
        f = Path("/proc/stat").read_text().split("\n", 1)[0].split()
        return int(f[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None


def run_cell(cell: registry.Cell, seed: int, seconds: float, trace: bool,
             device="cuda", t_start: float | None = None) -> dict:
    """The result line's object."""
    t_start = time.time() if t_start is None else t_start
    mode = cell.traffic["mode"]
    log(f"cell {cell.name}: {cell.config_name} x {cell.traffic_name}, "
        f"seed {seed}, {seconds} s, trace {int(trace)}")
    scratch = Path(tempfile.mkdtemp(prefix="port_bench_"))
    try:
        t0 = time.time()
        sim = inputs.simulate(cell.config, seed)
        libs = sim.libraries()
        log(f"simulated {sum(map(len, sim.truth))} bp, "
            f"{sum(2 * len(r.seq1) for r in libs)} reads of {len(libs)} "
            f"librar{'y' if len(libs) == 1 else 'ies'} in "
            f"{time.time() - t0:.2f} s")
        if cell.traffic["unit"] == "iteration":
            unit = capture.IterationUnit(capture.package(capture.PORT), cell,
                                         sim, device)
        else:
            unit = capture.RunUnit(cell, sim, scratch / "runs", device)
        full = [unit()]                              # the warm unit
        _sync(device)
        setup_s = time.time() - t_start
        peak_setup = _peak(device, reset=True)
        log(f"set-up {setup_s:.3f} s (warm {unit.kind} included)")

        # window units kept whole: two drawn from the seed, and the last;
        # the others as their gap strings, so the heap stays as it is
        whole_at = set(np.random.default_rng([int(seed), 0xF011]).choice(
            np.arange(1, 9), 2, replace=False).tolist())
        parse_calls: list = []
        per_run_parse: list = []
        window: list = []
        cpu: list = []
        steal0 = _steal_s()
        with _parse_timers(trace and mode == "run", parse_calls):
            w0 = time.perf_counter()
            ends = []
            while True:
                k = len(parse_calls)
                c0 = time.process_time()
                rec = unit()
                _sync(device)
                cpu.append(time.process_time() - c0)
                per_run_parse.append(sum(parse_calls[k:]))
                ends.append(time.perf_counter() - w0)
                last = ends[-1] >= seconds
                window.append(rec if last or len(ends) in whole_at
                              else rec.light())
                del rec
                if last:
                    break
            n, window_s = len(ends), ends[-1]
        steal1 = _steal_s()
        peak_window = _peak(device)
        log(f"window: {n} {unit.kind}s in {window_s:.3f} s; each: "
            f"{[round(b - a, 3) for a, b in zip([0.0] + ends, ends)]}")
        log(f"window: process CPU seconds each: "
            f"{[round(c, 3) for c in cpu]}; steal "
            f"{None if steal0 is None else round(steal1 - steal0, 2)} s")
        metrics, breakdown = {}, None
        device_info = _device(device, None if peak_window is None
                              else max(peak_setup, peak_window))
        if not trace:
            for m in cell.end_to_end:
                if m["name"] == "setup_s":
                    v = setup_s
                elif m["name"] == cell.unit_metric:
                    v = window_s / n
                else:
                    raise KeyError(f"no end-to-end metric {m['name']!r} in a "
                                   f"{cell.traffic_name} cell")
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        else:
            tr = tracing.Trace(
                mode, stages=[r.stages for r in window],
                parse_s=per_run_parse, peak_bytes=peak_window)
            prof = _profile(cell, unit, full, device, tr)
            breakdown = {"device_ops": prof["device_ops"],
                         "idle_gaps": prof["idle_gaps"]}
            log(f"ops (calls, device s, least s): {tr.ops}")
            log(f"device work past each stage's end (ms): "
                f"{prof['spill_ms']}")
            for m in cell.per_layer:
                v = registry.metric_reader(m["name"], cell.root).read(tr)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
            device_info.update(busy_s=tr.busy_s, window_s=tr.window_s)

        # one more unit, its calls to the ops sampled for the reference
        sample = calls.CallSample(seed)
        with sample.active():
            cap = unit()
        _sync(device)
        log(f"calls (made, kept): {calls.calls_made(sample)}")
        units = [(r, False, None) for r in full] + [(cap, False, sample)] \
            + [(r, True, None) for r in window
               if not isinstance(r, capture.Light)]
        lights = [r for r in window if isinstance(r, capture.Light)]
        t0 = time.time()
        own, digests, in_window = [], [], []
        for r, w, smp in units:
            x = compare.direct_numbers(r, sim, cell.config, seed) \
                if r.kind == "iteration" else {}
            if smp is not None:
                x.update(calls.numbers(smp))
            own.append(x)
            digests.append(compare.digest(r))
            in_window.append(w)
        log(f"plain reference: {time.time() - t0:.2f} s")
        del units, cap, full, sample
        log(f"bytes written by the units: {_tree_bytes(scratch)}")
        unit.close()
        del window, unit
        gc.collect()
        if str(device).startswith("cuda"):
            import torch

            torch.cuda.empty_cache()
        t0 = time.time()
        ref = compare.digest(capture.reference_record(cell, sim, device))
        log(f"reference: {time.time() - t0:.2f} s; "
            f"{len({d.key for d in digests})} distinct output set(s) of the "
            f"port")
        witness: dict = {}
        judged = []
        for d, extra, w in zip(digests, own, in_window):
            if d.key not in witness:
                witness[d.key] = compare.count(d, ref)
            judged.append((w, compare.judge({**witness[d.key], **extra},
                                            cell.limits)))
        judged += [(True, compare.judge(compare.strings_only(r.strings, ref),
                                        cell.limits)) for r in lights]
        worst: dict = {}
        for _, j in judged:
            for name, c in j.items():
                if name not in worst or c["value"] > worst[name]["value"]:
                    worst[name] = c
        failed = sum(in_window and not all(c["ok"] for c in j.values())
                     for in_window, j in judged)
        correct = all(c["ok"] for c in worst.values())
        result = {"correct": correct, "attempted": n, "failed": failed,
                  "metrics": metrics, "device": device_info}
        if breakdown is not None:
            result["breakdown"] = breakdown
        result["checks"] = {k: {"value": c["value"], "limit": c["limit"]}
                            for k, c in worst.items()}
        return result
    finally:
        shutil.rmtree(scratch, ignore_errors=True)


def _tree_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def _profile(cell, unit, records, device, tr) -> dict:
    """Profile the traffic's ``profile_units`` units with the stages and the
    ops labelled; fills ``tr.busy_s``, ``tr.window_s`` and ``tr.ops``."""
    from torch.profiler import ProfilerActivity, profile, record_function

    parse_calls: list = []
    ops = tracing.OpCalls(registry.roofline_ops(cell.root))
    t0 = time.time()
    with tracing.stage_labels(), ops.active(), \
            _parse_timers(cell.traffic["mode"] == "run", parse_calls,
                          "parse"), \
            profile(activities=[ProfilerActivity.CPU,
                                ProfilerActivity.CUDA]) as prof:
        with record_function(tracing.WINDOW):
            for _ in range(int(cell.traffic["profile_units"])):
                records.append(unit())
            _sync(device)
    log(f"profiled {cell.traffic['profile_units']} {unit.kind}(s) in "
        f"{time.time() - t0:.2f} s, the profiler's stop included")
    t0 = time.time()
    out = tracing.profile_summary(prof)
    log(f"profile read in {time.time() - t0:.2f} s: busy {out['busy_s']:.4f}"
        f" s of {out['window_s']:.4f} s")
    tr.busy_s, tr.window_s = out.pop("busy_s"), out.pop("window_s")
    tr.ops = ops.summary(out.pop("op_s"))
    log(f"op calls by shape: {dict(ops.shapes)}")
    return out


def _device(device, peak) -> dict:
    import torch

    if not str(device).startswith("cuda"):
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1, "memory_peak_bytes": int(peak)}


def process_start() -> float:
    """This process's start on the wall clock (from /proc), else now."""
    try:
        ticks = os.sysconf("SC_CLK_TCK")
        start = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1]
                    .split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return time.time() - (uptime - start / ticks)
    except (OSError, ValueError, IndexError):
        return time.time()
