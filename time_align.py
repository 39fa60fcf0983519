#!/usr/bin/env python3
"""Time the aligner's candidate scorer K5 (align_score) against its plain
version at the main path's shapes and at longer reads, on one CUDA card.

    python3 time_align.py [variant.cu ...] [--unchecked variant.cu ...]

The committed kernel (figbird_tpu_torch/csrc/align_score.cu) is always
timed.  Each further argument is a CUDA source with its C entry point
``score_candidates_launch``: a design under trial, for instance two lines
that set the source's tile shape (warps per block, blocks per SM) and
include it,

    #define ALIGN_SCORE_TILE 4, 8
    #include "align_score.cu"

or an earlier version, such as the one-thread-per-pair kernel taken with
``git show 14eee40:figbird_tpu_torch/csrc/align_score.cu``.  A source that
exports no ``align_score_stage_bytes`` is taken to have that earlier entry
point: no buffer length, and one row of five int32 per pair instead of five
planes.

Every source is built with the port's compiler flags (``csrc/`` is on the
include path), held bit for bit against the plain version in all five
outputs (the sources after ``--unchecked``, parts of a kernel switched
off to see where its time goes, only report a disagreement), and timed with
CUDA events (``time_counts.cuda_ms``), twice, the
second round in reverse order, beside the plain version and the least time
the card could take (``bound_ms``: the genome bytes the windows cover, the
reads, the candidates and the outputs over 3.35 TB/s, or three operations a
base over 67 T/s, whichever is larger).  Shapes: the aligner's batch of
32,768 reads at its two candidate counts (C = 8, the cheap pass; C = 32,
the full pass) at L = 101, first with the candidates the main path itself
sends (the first launch at each C when the aligner maps the first mates of
bench.py's dataset, with how many distinct windows a read has), then with
synthetic ones (``align_inputs``: the main path's mix, and scattered); and
L = 151 and 250 at C = 32, scattered.  Prints the card's name and power
limit first.
"""

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

if not torch.cuda.is_available():
    sys.exit("time_align: no CUDA device; this script runs only on a GPU")

from figbird_tpu_torch import dtypes  # noqa: E402
from figbird_tpu_torch.ops import _build, align_score  # noqa: E402
from time_counts import build, cuda_ms  # noqa: E402

DEV = torch.device("cuda", 0)
GENOME = 4_600_000
BATCH = 32768     # the Aligner's reads a batch
# (reads, candidates, read length, mix): the main path's batch at both
# candidate counts, then longer reads
SHAPES = ((32768, 8, 101, "main"), (32768, 8, 101, "scattered"),
          (32768, 32, 101, "main"), (32768, 32, 101, "scattered"),
          (32768, 32, 151, "scattered"), (32768, 32, 250, "scattered"))
MATCH, MISMATCH = 2, -6
PEAK_BYTES_S, PEAK_OPS_S = 3.35e12, 67e12
# the earlier entry point: no buffer length
OLD_ARGTYPES = (ctypes.c_void_p,) * 4 + (ctypes.c_longlong,) \
    + (ctypes.c_int,) * 5 + (ctypes.c_void_p,)


def align_inputs(g, G, B, C, L, mix):
    """A genome of G bases (1 in 230 an N) padded as the Aligner pads it
    (256 bytes and more of gap code), B reads copied from it with 2%
    substitutions, every 7th with its last 11 bases padded, and C
    candidates a read.  ``mix="main"``, as the main path's are: the first
    hit of each of the two seeds at the read's true start (candidates 0 and
    C / 2), one in eight of the others at 0 (hits past a bucket's end), the
    rest anywhere (the masked hits of a bucket hold other k-mers'
    positions); ``"scattered"``: the first at the true start, the rest
    anywhere."""
    gap = dtypes.GAP_CODE
    flat = torch.full(((G + 127) // 128 * 128 + 256,), gap, dtype=torch.int8,
                      device=DEV)
    flat[:G] = torch.randint(0, 4, (G,), generator=g, device=DEV,
                             dtype=torch.int8)
    flat[torch.randint(0, G, (G // 230,), generator=g, device=DEV)] = gap
    starts = torch.randint(0, G - L - 1, (B,), generator=g, device=DEV)
    reads = flat[starts[:, None] + torch.arange(L, device=DEV)].clone()
    subst = torch.rand(B, L, generator=g, device=DEV) < 0.02
    reads[subst] = 1
    reads[::7, L - 11 :] = gap
    cand = torch.randint(0, G - L - 1, (B, C), generator=g, device=DEV,
                         dtype=torch.int32)
    if mix == "main":
        cand[torch.rand(B, C, generator=g, device=DEV) < 0.125] = 0
        cand[:, C // 2] = starts.to(torch.int32)
    cand[:, 0] = starts.to(torch.int32)
    return flat, reads, cand


def align_bound(flat, reads, cand):
    """(bound_ms, by, bytes, operations) of one call: the genome bytes the
    windows cover (each read once), the reads, the candidates and the five
    int32 outputs a pair; three operations (compare, add, minimum) a base."""
    B, L = reads.shape
    u = torch.unique(cand)
    covered = int(torch.diff(u).clamp(max=L).sum()) + L
    n_bytes = covered + reads.numel() + cand.numel() * 4 * (1 + 5)
    n_ops = 3 * cand.numel() * L
    t_b, t_o = n_bytes / PEAK_BYTES_S * 1e3, n_ops / PEAK_OPS_S * 1e3
    return (*((t_b, "bytes") if t_b >= t_o else (t_o, "operations")),
            n_bytes, n_ops)


def main_path_inputs():
    """The first launch at each C of the aligner mapping the first mates of
    bench.py's dataset (4.6 Mb, 2 x 101 bp, 10x, seed 1) on the card: C ->
    (flat, reads, cand), and a line on its candidates."""
    from figbird_tpu_torch import simulate
    from figbird_tpu_torch.align import core
    from figbird_tpu_torch.align.index import build_index

    sim = simulate.simulate(simulate.SimConfig(
        genome_len=GENOME, n_contigs=4, n_gaps=50, gap_len_range=(10, 120),
        read_len=101, insert_mean=200, insert_sd=20, coverage=10.0,
        error_rate=0.005, seed=1))
    seen, launches = {}, {}
    score = core.score_candidates

    def spy(flat, reads, cand, *rest):
        C = cand.shape[1]
        launches[C] = launches.get(C, 0) + 1
        if C not in seen and reads.shape[0] == BATCH:
            seen[C] = (flat, reads.clone(), cand.clone())
        return score(flat, reads, cand, *rest)
    core.score_candidates = spy
    try:
        al = core.Aligner(build_index(sim.draft, k=15, device_tables=True),
                          batch_size=BATCH, device=DEV)
        al.align_many([(sim.reads1.seq, sim.reads1.length)])
    finally:
        core.score_candidates = score
    for C, (_, _, cand) in sorted(seen.items()):
        s = cand.sort(dim=1).values
        distinct = 1 + (s[:, 1:] != s[:, :-1]).sum(1).double()
        print(f"# main path, first mates: {launches[C]} launches at C = {C}; "
              f"the first: {float(distinct.mean()):.2f} distinct windows a "
              f"read, {float((cand == 0).double().mean()):.3f} of the "
              f"candidates at 0", flush=True)
    return seen


def main():
    print("# card: " + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    args = sys.argv[1:]
    cut = args.index("--unchecked") if "--unchecked" in args else len(args)
    sources = [_build.CSRC / "align_score.cu"] \
        + [Path(a) for a in args[:cut] + args[cut + 1:]]
    unchecked = {f"{p.parent.name}/{p.name}" for p in map(Path,
                                                          args[cut + 1:])}
    with tempfile.TemporaryDirectory() as tmp:
        fns = build(sources, Path(tmp), ("align_score",))["align_score"]
        for fn in fns.values():
            if fn.stage_bytes is None:
                fn.argtypes = OLD_ARGTYPES
        g = torch.Generator(device=DEV).manual_seed(0)
        stream = torch.cuda.current_stream(DEV).cuda_stream
        real = [(*x[1].shape, x[2].shape[1], "main path's own", x)
                for _, x in sorted(main_path_inputs().items())]
        for B, L, C, mix, *given in real + [(B, L, C, mix) for B, C, L, mix
                                            in SHAPES]:
            flat, reads, cand = given[0] if given else align_inputs(
                g, GENOME, B, C, L, mix)
            n = B * C
            what = f"{B} reads x {C} candidates, L = {L}, {mix} candidates"

            def plain():
                return align_score.score_candidates_plain(
                    flat, reads, cand, MATCH, MISMATCH, dtypes.GAP_CODE)
            want = torch.stack(list(plain().values()))
            b_ms, by, n_b, n_o = align_bound(flat, reads, cand)
            print(f"# align_score {what}: plain {cuda_ms(plain):.3f} ms, "
                  f"bound {b_ms:.4f} ms by {by} ({n_b / 1e6:.1f} MB, "
                  f"{n_o / 1e9:.3f} G operations)", flush=True)
            res = {}
            for order in (list(fns), list(fns)[::-1]):
                for name in order:
                    fn = fns[name]
                    new = fn.stage_bytes is not None
                    out = torch.full((5, n) if new else (n, 5), -7,
                                     dtype=torch.int32, device=DEV)
                    call = (flat.data_ptr(), reads.data_ptr(),
                            cand.data_ptr(), out.data_ptr(), n) \
                        + ((flat.numel(),) if new else ()) \
                        + (C, L, MATCH, MISMATCH, dtypes.GAP_CODE, stream)

                    def run(fn=fn, call=call, name=name):
                        err = fn(*call)
                        if err != 0:
                            raise RuntimeError(f"{name}: CUDA error {err}")
                    run()
                    torch.cuda.synchronize()
                    got = (out if new else out.T).reshape(5, B, C)
                    if not torch.equal(got, want) and name in unchecked:
                        print(f"#   {name}: unchecked, "
                              f"{int((got != want).sum())} outputs differ",
                              flush=True)
                    elif not torch.equal(got, want):
                        bad = int((got != want).sum())
                        raise AssertionError(
                            f"{name} disagrees with the plain version at "
                            f"{what}: {bad} outputs differ")
                    res.setdefault(name, []).append(cuda_ms(run))
            for name, ts in res.items():
                sb = fns[name].stage_bytes
                smem = "" if sb is None else \
                    f" ({sb(C, L)} B of shared memory a block)"
                print(f"#   {name}: " + ", ".join(f"{t:.4f}" for t in ts)
                      + f" ms{smem}", flush=True)
            del flat, reads, cand, want
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
