#!/usr/bin/env python3
"""Time the two count kernels, K1 (cascade) and K4 (fold), against their
plain versions at several shapes, on one CUDA card.

    python3 time_counts.py [variant.cu ...]

The committed kernels (figbird_tpu_torch/csrc/cascade.cu and fold.cu) are
always timed.  Each further argument is a CUDA source with the C entry point
of one of them (``cascade_launch`` or ``fold_launch``; the library says
which): a design under trial, for instance two lines that set a source's
tile shape (rows per thread, warps per block, blocks per SM) and include it,

    #define FOLD_TILE 4, 8, 2
    #include "fold.cu"

Every source is built with the port's compiler flags (``csrc/`` is on the
include path), checked against the plain version (rtol 2e-6, atol 0; K1 also
zeros in the same places) and timed with CUDA events (``cuda_ms``), twice,
the second round in reverse order; K4 also beside its library chain (one
batched matmul against a prebuilt one-hot, and the fold).  Shapes: the banded
scan shape of the main path (K1 at m = 6 and m = 3) and its smaller instance
batches (256, 128, 64), the unmapped mode's full-width shape, and a
1,024-read bucket.  Prints the card's name and power limit first.
"""

import ctypes
import re
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

if not torch.cuda.is_available():
    sys.exit("time_counts: no CUDA device; this script runs only on a GPU")

from figbird_tpu_torch.fill import em  # noqa: E402
from figbird_tpu_torch.ops import _build, band  # noqa: E402

DEV = torch.device("cuda", 0)
SHIFT, CUT = em._CASCADE_SHIFT, em._CASCADE_CUT
# (instances, reads, read length, positions, levels); K4 runs the shapes with
# m = 6 as its own (it has one level).  The first five are the instance
# batches the main path sends both kernels; then the unmapped mode's
# full-width shape and a 1,024-read bucket.
SHAPES = ((495, 128, 101, 128, 6), (495, 128, 101, 128, 3),
          (256, 128, 101, 128, 6), (128, 128, 101, 128, 6),
          (64, 128, 101, 128, 6),
          (123, 512, 101, 613, 6), (64, 1024, 101, 128, 6))


def cuda_ms(fn, reps: int = 10, batch: int = 10) -> float:
    """Device time of one call of ``fn`` in ms: the median over ``reps``
    CUDA-event timings of ``batch`` calls in a row, each divided by
    ``batch`` (after 3 warm-up calls).  The calls queue behind each other,
    so the host's cost of a launch is hidden wherever the device is busier
    than the host."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(batch):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / batch)
    return statistics.median(times)


def build(sources, out_dir: Path, kernels=("cascade", "fold")) -> dict:
    """One nvcc per source, all at once; kernel -> {source: typed launcher}
    for each of ``kernels`` (keys of ``_build.ENTRY``) a source exports,
    each with the source's ``<name>_stage_bytes`` report (None without)."""
    jobs = []
    for i, src in enumerate(sources):
        lib = out_dir / f"lib{i}_{src.stem}.so"
        jobs.append((src, lib, subprocess.Popen(
            [_build._nvcc(), *_build.FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    fns = {kernel: {} for kernel in kernels}
    for src, lib, proc in jobs:
        label = f"{src.parent.name}/{src.name}"
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{log}")
        for ln in log.splitlines():
            if "registers" in ln or re.search(r"\b[1-9]\d* bytes spill", ln):
                print(f"# built {label}: {ln.split(':')[-1].strip()}",
                      flush=True)
        cdll = ctypes.CDLL(str(lib))
        for kernel in kernels:
            source, entry, argtypes = _build.ENTRY[kernel]
            if hasattr(cdll, entry):
                fn = getattr(cdll, entry)
                fn.argtypes, fn.restype = argtypes, ctypes.c_int
                fn.stage_bytes = getattr(cdll, f"{source}_stage_bytes", None)
                fns[kernel][label] = fn
    return fns


def time_shape(kernel, fns, what, args, tail, want, plain, library=None):
    """Check every launcher of ``kernel`` against ``want`` and time it, in
    two rounds of opposite order, beside the plain version (and the library
    chain, where given); with each, the dynamic shared memory its blocks ask
    for at this shape."""
    plain_ms = cuda_ms(plain)
    lib = "" if library is None else f", library {cuda_ms(library):.3f} ms"
    print(f"# {kernel} {what}: plain {plain_ms:.3f} ms{lib}", flush=True)
    out = torch.empty(want.shape, dtype=torch.float32, device=DEV)
    stream = torch.cuda.current_stream(DEV).cuda_stream
    ptrs = [a.data_ptr() for a in args]
    res = {}
    for order in (list(fns), list(fns)[::-1]):
        for name in order:
            def run(fn=fns[name]):
                err = fn(*ptrs, out.data_ptr(), *tail, stream)
                if err != 0:
                    raise RuntimeError(f"{name}: CUDA error {err}")
            out.fill_(-1.0)
            run()
            torch.cuda.synchronize()
            err = (out.double() - want.double()).abs()
            bad = int((err > 2e-6 * want.double().abs()).sum())
            zeros = kernel == "fold" or torch.equal(out == 0, want == 0)
            if bad or not zeros:
                raise AssertionError(
                    f"{name} disagrees with the plain version: {bad} cells "
                    f"outside rtol 2e-6, max abs err {float(err.max()):.3g}, "
                    f"zero pattern equal {zeros}")
            res.setdefault(name, []).append(cuda_ms(run))
    _, P, L, _, _, *m = tail
    for name, ts in res.items():
        smem = fns[name].stage_bytes(P, L, *m[:1])
        print(f"#   {name}: " + ", ".join(f"{t:.3f}" for t in ts)
              + f" ms ({smem} B of shared memory a block)", flush=True)


def main():
    print("# card: " + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    sources = [_build.CSRC / "cascade.cu", _build.CSRC / "fold.cu"] \
        + [Path(a) for a in sys.argv[1:]]
    with tempfile.TemporaryDirectory() as tmp:
        fns = build(sources, Path(tmp))
        g = torch.Generator(device=DEV).manual_seed(0)

        def rand(*shape):
            return torch.rand(*shape, generator=g, device=DEV)

        for I, P, L, Pw, m in SHAPES:
            W = Pw + L
            what = (f"{I} instances x {P} reads x {Pw} positions, L = {L}")
            codes = torch.randint(0, 4, (I, P, L), generator=g, device=DEV,
                                  dtype=torch.int8)
            plen = torch.randint(40, L + 1, (I, P, 1), generator=g,
                                 device=DEV)
            vals = (torch.arange(L, device=DEV) < plen).to(
                torch.float32).contiguous()
            lw = rand(I, P, Pw) * -900.0
            lw[rand(I, P, Pw) < 0.3] = band.MASKED
            time_shape(
                "cascade", fns["cascade"], f"{what}, m = {m}",
                (lw, codes, vals), (I, P, L, Pw, W, m, SHIFT, CUT),
                band.cascade_counts_plain(lw, codes, vals, W, m, SHIFT, CUT),
                lambda: band.cascade_counts_plain(lw, codes, vals, W, m,
                                                  SHIFT, CUT))
            if m != 6:
                continue
            del lw
            weights = torch.where(rand(I, P, Pw) < 0.5, 0.0, rand(I, P, Pw))
            # the library chain: one batched matmul against a prebuilt
            # one-hot, and the fold
            ohT = band.oh_flat_c(codes, vals).transpose(1, 2).contiguous()
            time_shape(
                "fold", fns["fold"], what, (weights, codes, vals),
                (I, P, L, Pw, W),
                band.fold_counts_plain(weights, codes, vals, W),
                lambda: band.fold_counts_plain(weights, codes, vals, W),
                lambda: band.fold_T(torch.bmm(ohT, weights), L, W))
            del weights, ohT
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
