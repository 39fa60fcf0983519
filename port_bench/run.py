"""The benchmark of figbird_tpu_torch on one NVIDIA GPU: runs one cell once.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout.  The cell (``BENCHMARK.json``) names a
configuration (``port_bench/configs/``), a traffic mix
(``port_bench/traffic/``) and its limits (``port_bench/workloads/``).  The
inputs are simulated from ``--seed``; set-up runs one unit (an iteration or
a whole run) to build and warm everything; then units go back to back until
``--seconds`` have passed.  With ``--trace 1`` the per-layer metrics are
read from the window's stage clocks and one or two profiled units, with the
stages and the port's ops labelled.  After the window
one more unit runs with a sample of its calls to the port's ops copied;
the plain reference (``port_bench/reference/direct.py``) works those calls,
the splice and the reads' placement out again, and the frozen copy of the
engine (``port_bench/reference/fbref/``) runs once on the same inputs as a
witness of every unit's outputs.  The last line of standard output is the
result, as JSON; the last lines of standard error are the numbers compared,
each beside its limit.  Without a CUDA device, or with JAX or the JAX
package loaded, it exits with 2 or 3 and prints no result.
"""

import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# the host's math libraries on a fixed few threads, before they load: the
# port's host stages then load the shared cores alike from run to run
THREADS = 2
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = str(THREADS)
# every cache of the program's toolchain inside the checkout, at fixed paths
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = str(ROOT / ".port_bench_cache" / sub)
sys.path.insert(0, str(ROOT))

from port_bench.harness.cell import process_start  # noqa: E402

T_START = process_start()

import argparse  # noqa: E402
import json  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from port_bench.harness import cell as cellmod
    from port_bench.harness import registry

    cell = registry.load_cell(args.workload, ROOT)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        cellmod.log(f"{cell.name} needs {cell.chips} CUDA device(s); "
                    f"found {torch.cuda.device_count()}: no result")
        return 2
    torch.set_num_threads(THREADS)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = cellmod.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), device="cuda",
                              t_start=T_START)
    bad = cellmod.forbidden_modules()
    if bad:
        cellmod.log(f"loaded after the window: {', '.join(bad)}: no result")
        return 3
    for name, c in result["checks"].items():
        ok = "ok" if c["value"] <= c["limit"] else "OVER"
        print(f"# check {name}: {c['value']} (limit {c['limit']}) {ok}",
              file=sys.stderr)
    print(f"# correct: {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
