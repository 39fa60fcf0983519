#!/usr/bin/env python3
"""Time the two banded-score kernels, K2 (band_soft) and K3 (band_hard, its
K form and its gap-string form), against their plain versions and library
chains at several shapes, on one CUDA card.

    python3 time_bands.py [variant.cu ...] [--unchecked variant.cu ...]

The committed kernels (figbird_tpu_torch/csrc/band_soft.cu and
band_hard.cu) are always timed.  Each further argument is a CUDA source
with the C entry points of one of them (``band_soft_launch``;
``band_hard_launch`` and, where it has it, ``band_hard_gap_launch``): an
earlier version of a kernel, or a design under trial, for instance two lines
that set a source's tile shape (positions per lane, reads per warp at a
time, warps per block, blocks per SM) and include it,

    #define BAND_HARD_TILE 1, 4, 8, 2
    #include "band_hard.cu"

Every source is built with the port's compiler flags (``csrc/`` is on the
include path; a source's own directory comes first, so a directory that
holds altered copies of a kernel and of its core times the alteration),
checked against the plain version (K2 rtol 1e-5, atol 1e-3; K3 rtol 1e-5,
atol 1e-4; the committed gap-string form also bit-equal to the committed K
form) and timed with CUDA events (``time_counts.cuda_ms``), twice, the
second round in reverse order, beside the plain version and the library
chain (``soft_K`` or ``hard_K``, the skew and one ``torch.bmm`` against a
prebuilt one-hot). The sources after ``--unchecked`` (parts of a kernel
switched off, to see where its time goes) are timed and their disagreement
only reported. Shapes: the banded scan shape of the main path and its
smaller instance batches (256, 128, 64), and the unmapped mode's full-width
shape. Prints the card's name and power limit first.
"""

import subprocess
import sys
import tempfile
from pathlib import Path

import torch

if not torch.cuda.is_available():
    sys.exit("time_bands: no CUDA device; this script runs only on a GPU")

from figbird_tpu_torch.ops import _build, band  # noqa: E402
from time_counts import build, cuda_ms  # noqa: E402

DEV = torch.device("cuda", 0)
KERNELS = ("band_soft", "band_hard", "band_hard_gap")
# (instances, reads, read length, positions): the instance batches the main
# path sends both kernels, then the unmapped mode's full-width shape
SHAPES = ((495, 128, 101, 128), (256, 128, 101, 128), (128, 128, 101, 128),
          (64, 128, 101, 128), (123, 512, 101, 613))


def band_inputs(g, I, P, L, Wp):
    """The kernels phase's reads (bases 2 .. plen - 1 scored, plen in
    40..L, 1% N), probability slabs, and a gap string with Ns and positions
    past the contig with the model's log factors."""
    R = Wp + L - 1

    def rand(*shape):
        return torch.rand(*shape, generator=g, device=DEV)

    codes = torch.randint(0, 4, (I, P, L), generator=g, device=DEV,
                          dtype=torch.int8)
    codes[rand(I, P, L) < 0.01] = 4
    plen = torch.randint(40, L + 1, (I, P, 1), generator=g, device=DEV)
    j = torch.arange(L, device=DEV)
    valid = (j < plen) & (j >= 2)
    probs = rand(I, R, 5)
    probs[..., 4] = 0
    probs = probs / probs.sum(-1, keepdim=True)
    eprobs = rand(I, R, 5) * 1e-2
    e_pos = rand(L) * 1e-2
    gap = torch.randint(0, 4, (I, R), generator=g, device=DEV,
                        dtype=torch.int8)
    u = rand(I, R)
    gap[u < 0.05] = 4
    gap[u < 0.02] = 5
    a = -rand(L) * 0.1
    b = -2.0 - 4.0 * rand(L)
    ln_et = -3.0 * rand(5, 5)
    return codes, valid, probs, eprobs, e_pos, gap, a, b, ln_et


def time_kernel(kernel, fns, what, args, tail, want, rtol, atol, plain,
                library, unchecked=()):
    """Check every launcher of ``kernel`` against ``want`` and time it, in
    two rounds of opposite order, beside the plain version and the library
    chain; returns each launcher's output of its last check."""
    print(f"# {kernel} {what}: plain {cuda_ms(plain):.3f} ms, library "
          f"{cuda_ms(library):.3f} ms", flush=True)
    stream = torch.cuda.current_stream(DEV).cuda_stream
    ptrs = [a.data_ptr() for a in args]
    res, outs = {}, {}
    for order in (list(fns), list(fns)[::-1]):
        for name in order:
            out = torch.full(want.shape, -1.0, device=DEV)

            def run(fn=fns[name], out=out):
                err = fn(*ptrs, out.data_ptr(), *tail, stream)
                if err != 0:
                    raise RuntimeError(f"{name}: CUDA error {err}")
            run()
            torch.cuda.synchronize()
            err = (out.double() - want.double()).abs()
            bad = int((err > atol + rtol * want.double().abs()).sum())
            if bad and name in unchecked:
                print(f"#   {name}: unchecked, {bad} cells disagree",
                      flush=True)
            elif bad:
                raise AssertionError(
                    f"{name} disagrees with the plain version: {bad} cells "
                    f"outside rtol {rtol}, atol {atol}, max abs err "
                    f"{float(err.max()):.3g}")
            res.setdefault(name, []).append(cuda_ms(run))
            outs[name] = out
    L = tail[2]
    for name, ts in res.items():
        sb = fns[name].stage_bytes
        smem = "" if sb is None else f" ({sb(L)} B of shared memory a block)"
        print(f"#   {name}: " + ", ".join(f"{t:.3f}" for t in ts) + " ms"
              + smem, flush=True)
    return outs


def main():
    print("# card: " + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    args = sys.argv[1:]
    cut = args.index("--unchecked") if "--unchecked" in args else len(args)
    sources = [_build.CSRC / "band_soft.cu", _build.CSRC / "band_hard.cu"] \
        + [Path(a) for a in args[:cut] + args[cut + 1:]]
    unchecked = {f"{p.parent.name}/{p.name}" for p in map(Path,
                                                          args[cut + 1:])}
    with tempfile.TemporaryDirectory() as tmp:
        fns = build(sources, Path(tmp), KERNELS)
        g = torch.Generator(device=DEV).manual_seed(0)
        for I, P, L, Wp in SHAPES:
            what = f"{I} instances x {P} reads x {Wp} positions, L = {L}"
            codes, valid, probs, eprobs, e_pos, gap, a, b, ln_et = \
                band_inputs(g, I, P, L, Wp)
            R = gap.shape[1]
            oh = band.oh_flat_j(codes, valid)
            time_kernel(
                "band_soft", fns["band_soft"], what,
                (codes, valid, probs, eprobs, e_pos), (I, P, L, R, Wp),
                band.band_score_soft_plain(codes, valid, probs, eprobs,
                                           e_pos, Wp), 1e-5, 1e-3,
                lambda: band.band_score_soft_plain(codes, valid, probs,
                                                   eprobs, e_pos, Wp),
                lambda: band.band_score_onehot(
                    oh, band.soft_K(probs, eprobs, e_pos), Wp), unchecked)
            K = band.hard_K(gap, a, b, ln_et)
            want = band.band_score_plain(codes, valid, K, Wp)
            k_outs = time_kernel(
                "band_hard (K form)", fns["band_hard"], what,
                (codes, valid, K), (I, P, L, R, Wp), want, 1e-5, 1e-4,
                lambda: band.band_score_plain(codes, valid, K, Wp),
                lambda: band.band_score_onehot(oh, K, Wp), unchecked)
            del K
            g_outs = time_kernel(
                "band_hard (gap-string form)", fns["band_hard_gap"], what,
                (codes, valid, gap, a, b, ln_et), (I, P, L, R, Wp), want,
                1e-5, 1e-4,
                lambda: band.band_score_hard_plain(codes, valid, gap, a, b,
                                                   ln_et, Wp),
                lambda: band.band_score_onehot(
                    oh, band.hard_K(gap, a, b, ln_et), Wp), unchecked)
            ours = "csrc/band_hard.cu"
            if not torch.equal(g_outs[ours], k_outs[ours]):
                raise AssertionError("the gap-string form is not bit-equal "
                                     "to the K form")
            del oh, want, k_outs, g_outs
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
