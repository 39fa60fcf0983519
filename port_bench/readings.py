"""Readings for the limits of ``correct``: on each seed, the numbers that
``correct`` compares for one unit of the port as the cell runs it (the
sound side) and, with ``--control``, for the control in the port's place.

    python3 port_bench/readings.py --workload <cell> --seeds 1,2,3 \\
        [--control tf32_direct] [--control exact_soft_false]

Three controls.  ``tf32_direct``: the plain reference's scores and counts
computed as a TF32 matmul computes them, in place of the port's outputs of
the sampled calls (the next precision below the f32, TF32 off, that the
port states).  ``exact_soft_false``: the port with its own lower-precision
path switched on, ``fill_gaps(exact_soft=False)``, plain f32 soft counts in
place of the configuration's exact double-range cascade.
``reference_tf32``: the frozen copy of the engine with TF32 on, in the
port's place.  Prints one JSON line per seed and side.  The benchmark's own
runs never run it.
"""

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

CONTROLS = {"tf32_direct": "calls", "exact_soft_false":
            {"fill_kwargs": {"exact_soft": False}}, "reference_tf32": "tf32"}


def read(cell, seed: int, controls: dict, device="cuda") -> tuple:
    """[(side, numbers, seconds)] on one seed: the sound side first, then
    each control; and the witness's seconds."""
    from port_bench.harness import calls, capture, compare, inputs

    sim = inputs.simulate(cell.config, seed)
    t0 = time.time()
    ref = compare.digest(capture.reference_record(cell, sim, device))
    t_ref = time.time() - t0
    t0 = time.time()
    sample = calls.CallSample(seed)
    if cell.traffic["unit"] == "run":
        unit = capture.RunUnit(cell, sim, Path(tempfile.mkdtemp(
            prefix="readings_")), device)
    else:
        unit = capture.IterationUnit(capture.package(capture.PORT), cell,
                                     sim, device)
    with sample.active():
        rec = unit()
    numbers = compare.count(compare.digest(rec), ref)
    if rec.kind == "iteration":
        numbers.update(compare.direct_numbers(rec, sim, cell.config, seed))
    numbers.update(calls.numbers(sample))
    unit.close()
    out = [("sound", numbers, time.time() - t0)]
    for side, kw in controls.items():
        t0 = time.time()
        if kw == "calls":
            numbers = calls.numbers(sample, control=True)
        elif kw == "tf32":
            import torch

            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
            try:
                numbers = compare.count(compare.digest(
                    capture.reference_record(cell, sim, device)), ref)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
                torch.backends.cudnn.allow_tf32 = False
        else:
            numbers = compare.count(compare.digest(capture.reference_record(
                cell, sim, device, kw, capture.PORT)), ref)
        out.append((side, numbers, time.time() - t0))
    return out, t_ref


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", choices=sorted(CONTROLS), action="append",
                    default=[])
    args = ap.parse_args(argv)

    import torch

    from port_bench.harness import registry

    if not torch.cuda.is_available():
        print("# readings: no CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = registry.load_cell(args.workload, ROOT)
    for seed in (int(s) for s in args.seeds.split(",")):
        sides, t_ref = read(cell, seed, {c: CONTROLS[c]
                                         for c in args.control})
        for side, numbers, secs in sides:
            print(json.dumps({"cell": cell.name, "seed": seed, "side": side,
                              "numbers": numbers, "seconds": round(secs, 3),
                              "reference_s": round(t_ref, 3)}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
