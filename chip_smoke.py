#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (figbird_tpu_torch) on one card.

    python3 chip_smoke.py [--profile]

Phases (every one must pass; none is caught):

1. device  — refuse to run without CUDA; print the card's name and power
   limit; TF32 off; build every kernel from csrc/ with nvcc (in parallel).
2. kernels — each of K1-K5 against its plain PyTorch version at the main
   path's shapes, within its stated tolerance (K1 also: zeros in the same
   places, two launches bit-equal, and untimed checks at the full-width
   shape and at m = 3; K4 at the finalize's instance batch, which is all the
   default path sends it, and also checked and timed at the larger batches
   of exact_soft=False, and checked, untimed, with quality-weighted count
   values and at the full-width shape, two launches bit-equal; K2 and both
   forms of K3, the gap-string form the main path launches and the K form,
   checked and timed at every instance batch the main path sends them (495,
   256, 128, 64) and at the full-width shape, two launches bit-equal, the
   gap-string form bit-equal to the K form); CUDA-event times
   (``time_counts.cuda_ms``: per call, over batches of 10 calls in a row)
   of the kernel, of the plain version and of the library chain (one
   batched matmul against a prebuilt one-hot: for K1 and K4 plus the fold,
   for K2 and K3 after soft_K or hard_K and the skew; K5 has none); the
   least time the card could take for the same work (``bound_ms``).  K5 at
   the aligner's two shapes, its cheap pass (32,768 reads x 8 candidates,
   mixed as the main path's are) and its full pass (x 32, scattered), all
   five outputs bit-equal and two launches bit-equal.
   The unmapped mode's shapes (every read at every position of the
   window): the u main path's own bucket, 128 reads x gap bucket 512, at
   both its width classes (Wp 613 and 229), and the full-width buckets of
   1,024 reads x 512 and 3,072 reads x 128; K1 (m = 6), K4, K2 and both
   K3 forms (reverse strand's factors) at each, each
   at the instance batch that fill_gaps' memory cap gives that bucket:
   checked and timed the same way.  On the kernels line each is a row of
   its own (``shape``) carrying the u-iteration's launches at its (reads,
   positions); a row whose shape the u-iteration did not launch sits under
   ``not_on_main_path`` of its kernel's row.
3. parity  — the port's p-iteration on CUDA vs the same on the CPU (plain
   versions) on the 120 kb simulation of tests/test_pipeline.py, at the
   production default, at exact_soft=False and at the "auto" and "hybrid"
   tiers: aligner outputs must be equal; equal gap strings are reported for
   each configuration ("auto": its escalated lanes too).  Then a
   u-iteration (``run_iteration("u", 0)``) on the same simulation, card
   and CPU, at the default: the end-to-end pass's aligner outputs and the
   gap strings must be equal.  The CPU side runs in a process of its own
   (``CpuJob``) from the script's start, beside the card phases, and is
   compared when the card phases are done.
4. main path — bench.py's E. coli-scale dataset (4.6 Mb, 50 gaps, 2x101 bp,
   insert 200, 10x) through Pipeline.run_iteration("p", 0) on the card, at
   the production default (default fill_kwargs: all five kernels launched)
   and at exact_soft=False (the four kernels of that path launched), each
   with the launch counts set to 0 just before and read just after (K5's
   also by candidates a read): N
   reduced, filled-base accuracy vs the truth >= 0.95; wall time, reads/s
   and the stage split; then each once more, warm, for the wall ratio.
   ``--profile`` adds one default iteration under torch.profiler and prints
   the device's busy share.
5. main path, unmapped — the same dataset through a fresh Pipeline's
   ``run_iteration("u", 0)`` at the default (bench.py's u-trial), the
   launch counts set to 0 just before and read just after: all five
   kernels launched, N reduced, filled-base accuracy >= 0.95; wall, fill
   stats and launches (also by shape) printed; then one
   ``reference_exact`` u-iteration, held to the same checks, and the
   number of its gap strings equal to the default's.  ``--profile`` adds
   the default u-iteration under torch.profiler.
6. schedule — the whole run through the port's CLI on the card: bench.py's
   frag library and a jump library on the same truth (insert 600 +- 50, 5x,
   seed 2; scripts/schedule_e2e.py's two-library dataset) written to
   FASTA/FASTQ with a reference-schema Config.json (default schedule,
   evaluation on), then ``figbird_tpu_torch.__main__.main([cfg])`` in this
   process, the launch counts set to 0 just before and read just after:
   exit 0, the iterations a prefix of the two-library schedule cut only
   where the N count stopped moving, all five kernels launched, N reduced,
   filled-base accuracy of the combined gaps (Individual_gaps.txt) >= 0.95,
   the reference CLI's whole output tree, the final assembly equal to the
   last iteration's, Result.txt written; walls, stage times, launches by
   shape, the FASTQ parse and evaluation times printed.  Each row of the
   kernels line for the p main path also carries the schedule's launches
   (``schedule_launches``).
7. mesh — on bench.py's dataset, meshes over ``cuda:i % device_count``
   (on one card, that card repeated: the shards run one after another
   there, which drives every sharded path and its kernels but says nothing
   of scaling).  (a) The code-range and contig-range genome-sharded
   aligners on a (reads 2, genome 4) mesh, local and end-to-end presets,
   both mates, against the replicated ``use_buckets=False`` aligner: score,
   aligned, unique and second equal for every read, the placement fields
   for every read with a candidate; each pass's wall and K5's launches by
   genome shard.  (b) ``run_iteration("p", 0)`` and a fresh Pipeline's
   ``run_iteration("u", 0)`` on a (reads 2, genome 2) mesh, code-range
   shards, the launch counts set to 0 just before and read just after: all
   five kernels launched; gap strings, gaptofill and contigs equal to
   phases 4 and 5's single-device default iterations; walls and launches
   by kernel and by shape.
8. two processes — two workers on the card, each joined by
   ``parallel.distributed.init_from_env`` (gloo on 127.0.0.1) and holding
   half the read pairs, run the p-iteration; each one's N, gap strings,
   gaptofill and contigs must equal phase 4's.  Each worker has a timeout;
   one that fails or outlives it fails the script.  Per-process walls
   and launches (every kernel launched in each).
   On the kernels line each p row also carries the mesh p-iteration's
   launches (``mesh_launches``) and the two processes' together
   (``two_process_launches``), each u row the mesh u-iteration's at its
   shape (``mesh_launches``), and K5's row the sharded aligners' launches
   of phase 7a (``mesh_aligner_launches``).
9. SAM — the SAM-injected fills (``io.write_sam`` -> ``io.read_sam_pairs``
   -> pair table -> host model -> triage -> ``fill_gaps(reference_exact=
   True)``).  (a) tests/test_golden.py's simulation: both mates aligned on
   the card (K5), written and read back (the aligned flags, and on the
   aligned records strand, pos, clips and unique, equal to the aligner's),
   the p fill on the card and on the CPU: gap strings, gaptofill and
   spliced contigs equal, K1-K4 launched on the card.  (b)
   tests/test_golden_unmapped.py's flow (insert 600, maxD2 690): a local
   and an end-to-end SAM, the model from the latter, partial and unmapped
   triage merged, the u fill on the card: N reduced, filled-base accuracy
   >= 0.95, K1-K4 launched.  (c) bench.py's dataset (455,444 records)
   through a SAM: write and read seconds printed, the p fill on the card
   at accuracy >= 0.95 with N reduced, and the number of its gap strings
   equal to the same stages fed the aligner's outputs directly (not
   asserted: MD tags cannot carry mismatches on soft-clipped tails).
10. large gaps — one library with a gap-length tail (1 Mb, 40 gaps from
   the simulator's lognormal, insert 600, 80x): ``run_iteration("p", 0)``
   then ``run_iteration("u", 0)`` on the card, the launch counts set to 0
   just before each and read just after: all five kernels launched in the
   u-iteration, N reduced, at least 4 of its gap plans with the large-gap
   flag and K1 launched at 1,024 reads; walls, stages, fill stats,
   launches by shape and accuracy on the large gaps and the rest printed,
   and the number of gap strings equal to ``reference_exact=True`` on the
   u-iteration's own fill inputs (not asserted).  (b) The large gap with
   the most unmapped reads above 128, alone through ``fill_gaps`` with the
   u-iteration's model and ``max_scan_lengths=4``, on the card and on the
   CPU: gap string, gaptofill and fill stats equal.
   On the kernels line every unmapped row carries the u-iteration's
   launches at its shape (``large_gap_launches``), and each row above 128
   reads those at its read count by positions
   (``large_gap_launches_by_positions``).

11. chr14 — scripts/chr14_scale_torch.py's flow on the card at
   ``CHR14_MB`` (88 Mb: the reference's chr14-scale configuration, 8.7 M
   reads, 5,000 gaps): simulate, a cold and a warm p-iteration (equal N and
   gap strings), a u-iteration, three sample gaps on the card and the CPU
   (equal); N before as simulated (466,755), N reduced in each iteration,
   accuracy >= 0.95 against the truth, all five kernels launched.
12. the paths no earlier phase reaches, each printed with its wall.  (a)
   exact_soft="auto" and "hybrid" on bench.py's dataset: N reduced,
   accuracy >= 0.95, all five kernels launched, the gap strings equal to
   the default's counted ("auto": its escalated lanes).  (b) Phase 6's
   dataset under ``default: 0`` (serial numbers reversed, num_itr_* set):
   the ``# itr`` lines equal USER_SCHEDULE, the tree complete, N reduced.
   (c) ``--resume --max-iterations 1`` on phase 6's output: the resume line
   names its last filled assembly, the resumed iteration starts from its
   final N, the tree is written.  (d) The 3,072-read bucket: a 100 kb
   genome with 3 gaps of 500-1,500 bp at 1,000x, p- then u-iteration: K1-K4
   launched at 3,072 reads, N reduced, accuracy >= 0.95; one gap at 3,072
   reads through ``fill_gaps`` on the card and (a CpuJob) the CPU, the scan
   capped at BUCKET_SCAN lengths on both: equal.  (e) The contig-range
   path past the replicated budget: a (reads 1, genome 2) mesh of the card
   repeated, ``HOST_FLAT_BUDGET`` below the genome's length: no device
   statistics, the model learned on the host, all five kernels launched,
   the p-iteration equal to phase 4's.  (d) runs before phase 11, so that
   its CPU side overlaps phase 11.
   On the kernels line every row carries the chr14 and 3,072-bucket runs'
   launches (``chr14_launches``, ``bucket_3072_launches``: by iteration;
   a p row the kernel's, an unmapped row those at its shape).
13. full human — scripts/full_human_torch.py's flow on the card at
   ``FH_GB`` and ``FH_COVERAGE`` (BASELINE.json config 5 cut to 2.2 Gb:
   26 contigs, 400 gaps, a padded flat genome past 2^31 positions) on a
   (reads 1, genome 2) mesh of the card repeated, the contig shards built
   on the card: a p- and then a u-iteration, the first two contigs
   contig-sharded against replicated (gap strings equal), the per-read
   truth share below and past 2^31 (within 0.5 points), up to three gaps
   past 2^31 on the card and (a CpuJob) the CPU (equal); N reduced in p,
   accuracy >= 0.95, K5 launched on both shards in each iteration and
   K1-K4 launched.  On the kernels line every row carries its launches
   (``config5_launches``, by iteration; an unmapped row those at its
   shape) and K5's row also by shard (``config5_launches_by_shard``).

Before the last line come the kernels JSON and the card's ``nvidia-smi``
name/power-limit line; the last line is the device JSON.
"""

import contextlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is "
             "False); this script runs only on a GPU")

from figbird_tpu_torch import config, dtypes, ops, simulate  # noqa: E402
from figbird_tpu_torch.fill import em  # noqa: E402
from figbird_tpu_torch.ops import _build  # noqa: E402
from figbird_tpu_torch.ops import band, align_score  # noqa: E402
from figbird_tpu_torch.pipeline import Pipeline  # noqa: E402
from time_align import align_bound, align_inputs  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent / "scripts"))
import chr14_scale_torch as chr14  # noqa: E402
import full_human_torch as full_human  # noqa: E402
from chr14_scale_torch import Captured  # noqa: E402
from time_bands import band_inputs  # noqa: E402
from time_counts import cuda_ms  # noqa: E402

DEV = torch.device("cuda", 0)
ALIGN_KEYS = ("score", "pos", "strand", "clip_start", "clip_end", "aligned",
              "unique", "n_mis", "second", "alen", "hit_overflow", "indel")
# published peaks of one H100 SXM: device memory rate, and f32 outside the
# tensor cores (also taken for K5's integer compares and adds)
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12
SHIFT, CUT = em._CASCADE_SHIFT, em._CASCADE_CUT
# the main path's shapes: the scan batch of the (512, 128) bucket (instances,
# reads, read length, band width); the instance batch of its finalize, the
# only one K4 sees at the default, and the other batches below the scan's
# that K4 sees at exact_soft=False; the aligner's extend step on the bench
# genome's size, its cheap pass and its full pass (reads, candidates,
# time_align.align_inputs' mix); the unmapped mode's 512-read bucket (reads,
# gap bucket)
SCAN_SHAPE = (495, 128, 101, 128)
FINALIZE_BATCH = 64
PARTIAL_BATCHES = (128, 256)
ALIGN_GENOME = 4_600_000
ALIGN_SHAPES = ((32768, 8, "main"), (32768, 32, "scattered"))
FULL_WIDTH = (512, 512)
# the unmapped mode's shapes for K1-K4: (reads, gap bucket, width class):
# the u main path's 128-read bucket at gap 512 at both its width classes,
# then the full-width buckets of 1,024 and 3,072 reads
U_SHAPES = ((128, 512, 512), (128, 512, 128), (1024, 512, 512),
            (3072, 128, 128))


def log(msg):
    print(f"# {msg}", flush=True)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def close(got, want, rtol, atol):
    """max |got - want| and whether |got - want| <= atol + rtol |want|."""
    got, want = got.double(), want.double()
    err = (got - want).abs()
    ok = bool((err <= atol + rtol * want.abs()).all())
    return float(err.max()), ok


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: float, n_ops: float):
    """The least time (ms) the card could take: bytes over the memory rate
    or operations over the f32 rate, whichever is larger, and which."""
    t_b, t_o = n_bytes / PEAK_BYTES_S * 1e3, n_ops / PEAK_OPS_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


# ---------------------------------------------------------------- phase 1
def phase_device():
    line = smi()
    log(f"card: {line}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    secs = _build.build()
    log(f"kernels built in {secs:.1f}s ({', '.join(_build.SOURCES)})")
    for name in _build.ENTRY:
        _build.launcher(name)
    for name in _build.SOURCES:
        log_path = _build.target(name).with_suffix(".log")
        for ln in log_path.read_text().splitlines():
            if "registers" in ln or "bytes stack frame" in ln:
                log(f"ptxas {name}: {ln.strip()}")
    return line


# ---------------------------------------------------------------- phase 2
def cascade_inputs(g, I, P, L, Pw):
    """Masked log-weights over [-900, 0] with ~30% illegal (every level
    holds overflow-zeroed, normal, denormal and underflowed weights), reads
    with a few Ns and 0/1 count values."""
    lw = torch.rand(I, P, Pw, generator=g, device=DEV) * -900.0
    lw[torch.rand(I, P, Pw, generator=g, device=DEV) < 0.3] = band.MASKED
    codes = torch.randint(0, 4, (I, P, L), generator=g, device=DEV,
                          dtype=torch.int8)
    codes[torch.rand(I, P, L, generator=g, device=DEV) < 0.01] = 4
    plen = torch.randint(40, L + 1, (I, P, 1), generator=g, device=DEV)
    vals = (torch.arange(L, device=DEV) < plen).to(torch.float32)
    return lw, codes, vals.contiguous()


def check_cascade(lw, codes, vals, W, m, what):
    """K1 against its plain version: rtol 2e-6 (the sum order differs),
    atol 0, zeros in the same places, two launches bit-equal."""
    got = band.cascade_counts(lw, codes, vals, W, m, SHIFT, CUT)
    want = band.cascade_counts_plain(lw, codes, vals, W, m, SHIFT, CUT)
    again = band.cascade_counts(lw, codes, vals, W, m, SHIFT, CUT)
    torch.cuda.synchronize()
    err, ok = close(got, want, 2e-6, 0.0)
    rel = float(((got.double() - want.double()).abs()
                 / want.double().abs().clamp_min(1e-300)).max())
    zeros = torch.equal(got == 0, want == 0)
    repeat = torch.equal(got, again)
    tiny = torch.finfo(torch.float32).tiny
    log(f"cascade {what}: shape {tuple(got.shape)}, max_abs_err {err:.3g} "
        f"on counts up to {float(want.max()):.3g}, max_rel_err {rel:.3g} "
        f"(rtol 2e-6, atol 0), zero pattern equal {zeros} "
        f"({int((want == 0).sum())} zeros, "
        f"{int(((want != 0) & (want < tiny)).sum())} denormal counts), "
        f"repeat bit-equal {repeat}")
    if not (ok and zeros and repeat):
        raise AssertionError(f"cascade {what} disagrees with its plain "
                             f"version (max abs err {err}, zeros {zeros}, "
                             f"repeat {repeat})")
    return err


def check_fold(weights, codes, vals, W, what):
    """K4 against its plain version: rtol 2e-6 (the sum order differs),
    atol 0, two launches bit-equal."""
    got = band.fold_counts(weights, codes, vals, W)
    want = band.fold_counts_plain(weights, codes, vals, W)
    again = band.fold_counts(weights, codes, vals, W)
    torch.cuda.synchronize()
    err, ok = close(got, want, 2e-6, 0.0)
    repeat = torch.equal(got, again)
    log(f"fold {what}: shape {tuple(got.shape)}, max_abs_err {err:.3g} on "
        f"counts up to {float(want.max()):.3g} (rtol 2e-6, atol 0), repeat "
        f"bit-equal {repeat}")
    if not (ok and repeat):
        raise AssertionError(f"fold {what} disagrees with its plain version "
                             f"(max abs err {err}, repeat {repeat})")
    return err


def timed(kern, plain, lib):
    """CUDA-event ms of the kernel, its plain version and its library chain
    in the order library, plain, kernel, kernel, plain, library: both
    orders inside one call, the better of each pair."""
    l1, p1, k1, k2, p2, l2 = (cuda_ms(f) for f in (lib, plain, kern, kern,
                                                   plain, lib))
    return min(k1, k2), min(p1, p2), min(l1, l2)


def check_bands(b_in, Wp, what, time_forms=("K2", "K form", "gap form")):
    """K2 and both forms of K3 against their plain versions (K2 rtol 1e-5,
    atol 1e-3; K3 rtol 1e-5, atol 1e-4), two launches bit-equal, the
    gap-string form bit-equal to the K form on hard_K's output; the forms
    in ``time_forms`` timed beside their plain versions and library
    chains."""
    codes, valid, probs, eprobs, e_pos, gap, a, b, ln_et = b_in
    K = band.hard_K(gap, a, b, ln_et)
    oh = band.oh_flat_j(codes, valid)
    forms = {
        "K2": (1e-3,
               lambda: band.band_score_soft(codes, valid, probs, eprobs,
                                            e_pos, Wp),
               lambda: band.band_score_soft_plain(codes, valid, probs,
                                                  eprobs, e_pos, Wp),
               lambda: band.band_score_onehot(
                   oh, band.soft_K(probs, eprobs, e_pos), Wp)),
        "K form": (1e-4,
                   lambda: band.band_score(codes, valid, K, Wp),
                   lambda: band.band_score_plain(codes, valid, K, Wp),
                   lambda: band.band_score_onehot(oh, K, Wp)),
        "gap form": (1e-4,
                     lambda: band.band_score_hard(codes, valid, gap, a, b,
                                                  ln_et, Wp),
                     lambda: band.band_score_hard_plain(codes, valid, gap, a,
                                                        b, ln_et, Wp),
                     lambda: band.band_score_onehot(
                         oh, band.hard_K(gap, a, b, ln_et), Wp)),
    }
    outs, times = {}, {}
    for form, (atol, kern, plain, lib) in forms.items():
        got, again, want = kern(), kern(), plain()
        torch.cuda.synchronize()
        err, ok = close(got, want, 1e-5, atol)
        repeat = torch.equal(got, again)
        msg = (f"{form} {what}: shape {tuple(got.shape)}, max_abs_err "
               f"{err:.3g} (rtol 1e-5, atol {atol}), repeat bit-equal "
               f"{repeat}")
        if form in time_forms:
            ms, plain_ms, lib_ms = timed(kern, plain, lib)
            times[form] = (err, ms, plain_ms, lib_ms)
            msg += (f"; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
                    f"library {lib_ms:.3f} ms")
        log(msg)
        if not (ok and repeat):
            raise AssertionError(f"{form} {what} disagrees with its plain "
                                 f"version (max abs err {err}, repeat "
                                 f"{repeat})")
        outs[form] = got
        del again, want
    same = torch.equal(outs["gap form"], outs["K form"])
    log(f"K3 {what}: gap-string form bit-equal to the K form {same}")
    if not same:
        raise AssertionError(f"K3 {what}: the gap-string form differs from "
                             f"the K form")
    return times


def check_align(g):
    """K5 at the aligner's two main-path shapes on the bench genome's size:
    its cheap pass (C = 8, candidates mixed as the main path's are) and its
    full pass (C = 32, scattered).  All five outputs bit-equal to the plain
    version, two launches bit-equal; timed in the order plain, kernel,
    wrapper, wrapper, kernel, plain: the kernel through its C launcher (the
    row's time), the wrapper's whole call (at C = 8 the host's cost of a
    call is about the kernel's time), the plain version.  No one PyTorch call
    gathers candidate windows and scores them, so there is no library
    time.  The row of the kernels line is the cheap pass's, the shape of
    most of the main path's launches."""
    rows = []
    for B, C, mix in ALIGN_SHAPES:
        flat, reads, cand = align_inputs(g, ALIGN_GENOME, B, C, 101, mix)
        args = (flat, reads, cand, 2, -6, dtypes.GAP_CODE)

        def wrapper():
            return align_score.score_candidates(*args)

        def plain():
            return align_score.score_candidates_plain(*args)

        out = torch.empty((5, B * C), dtype=torch.int32, device=DEV)
        call = (flat.data_ptr(), reads.data_ptr(), cand.data_ptr(),
                out.data_ptr(), B * C, flat.numel(), C, 101, 2, -6,
                dtypes.GAP_CODE, torch.cuda.current_stream(DEV).cuda_stream)

        def kernel():
            _build.check(_build.launcher("align_score")(*call), "align_score")

        def planes(res):
            return torch.stack(list(res.values()))
        got, again, want = planes(wrapper()), planes(wrapper()), \
            planes(plain())
        torch.cuda.synchronize()
        equal, repeat = torch.equal(got, want), torch.equal(got, again)
        err = float((got - want).abs().max())
        p1, k1, w1, w2, k2, p2 = (cuda_ms(f) for f in (
            plain, kernel, wrapper, wrapper, kernel, plain))
        ms, wrapper_ms, plain_ms = min(k1, k2), min(w1, w2), min(p1, p2)
        bound_ms, bound_by, n_b, n_o = align_bound(flat, reads, cand)
        log(f"align_score {B} reads x {C} candidates, {mix} candidates: "
            f"bit-equal {equal}, repeat bit-equal {repeat}, kernel "
            f"{ms:.4f} ms (the wrapper's call {wrapper_ms:.4f} ms), plain "
            f"{plain_ms:.3f} ms, library none, bound "
            f"{bound_ms:.4f} ms by {bound_by} ({n_b / 1e6:.1f} MB, "
            f"{n_o / 1e9:.3f} G operations)")
        if not (equal and repeat):
            raise AssertionError(f"align_score at C = {C} disagrees with its "
                                 f"plain version (max abs err {err}, repeat "
                                 f"{repeat})")
        rows.append(dict(name="align_score", route="cuda",
                         source="figbird_tpu_torch/csrc/align_score.cu",
                         replaces="figbird_tpu/ops/align_score.py:40",
                         launches=0, max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=None))
        del flat, reads, cand, got, again, want, out
    torch.cuda.empty_cache()
    return rows[0]


def phase_kernels():
    """Each kernel vs its plain version at the main path's shapes."""
    g = torch.Generator(device=DEV).manual_seed(0)
    I, P, L, bw = SCAN_SHAPE
    R = bw + L

    def rand(*shape):
        return torch.rand(*shape, generator=g, device=DEV)

    codes = torch.randint(0, 4, (I, P, L), generator=g, device=DEV,
                          dtype=torch.int8)
    codes[rand(I, P, L) < 0.01] = 4
    plen = torch.randint(40, L + 1, (I, P, 1), generator=g, device=DEV)
    j = torch.arange(L, device=DEV)
    weights = torch.where(rand(I, P, bw) < 0.5, 0.0, rand(I, P, bw))
    vals = (j < plen).to(torch.float32).expand(I, P, L).contiguous()
    n_val = (vals != 0).sum(-1)                      # counted bases per read

    # K2, K3: reads, probability slabs, a gap string with Ns and positions
    # past the contig, and the model's log factors; R = bw + L - 1
    b_in = band_inputs(g, I, P, L, bw)
    b_codes, b_valid, probs, eprobs, e_pos, gap, a_f, b_f, ln_et = b_in
    b_R = gap.shape[1]
    b_oh = band.oh_flat_j(b_codes, b_valid)
    n_cells = int((b_valid & (b_codes < 5)).sum()) * bw  # scored cells
    out_f32 = I * P * bw * 4

    # K1: the banded soft accumulate of the exact cascade, m = 6
    lw, c_codes, c_vals = cascade_inputs(g, I, P, L, bw)
    c_nval = (c_vals != 0).sum(-1)
    # multiply-adds this run's data needs: every non-zero level weight
    # meets every counted base of its read; one expf per weight and level
    c_nnz = [(band.level_weight(lw, k, SHIFT, CUT) != 0).sum(-1)
             for k in range(6)]
    c_ops = sum(2 * int((nz * c_nval).sum()) + int(nz.sum()) for nz in c_nnz)
    c_ohT = band.oh_flat_c(c_codes, c_vals).transpose(1, 2).contiguous()

    def cascade_library():
        outs = []
        for g0 in (0, 3):
            wk = torch.cat([band.level_weight(lw, k, SHIFT, CUT)
                            for k in range(g0, g0 + 3)], dim=2)
            cwT = torch.bmm(c_ohT, wk)
            outs += [band.fold_T(cwT[:, :, i * bw : (i + 1) * bw], L, R)
                     for i in range(3)]
        return torch.stack(outs, dim=1)

    # K4 at the finalize's batch: the first instances of the scan's arrays
    n_f = FINALIZE_BATCH
    f_w, f_codes, f_vals = weights[:n_f], codes[:n_f], vals[:n_f]
    f_ohT = band.oh_flat_c(f_codes, f_vals).transpose(1, 2).contiguous()
    f_ops = 2 * int(((f_w != 0).sum(-1) * n_val[:n_f]).sum())

    # (name, source, TPU kernel, rtol, atol, kernel, plain, library chain,
    #  bytes in + out, operations)
    specs = [
        ("cascade", "figbird_tpu_torch/csrc/cascade.cu",
         "figbird_tpu/ops/band.py:242", 2e-6, 0.0,
         lambda: band.cascade_counts(lw, c_codes, c_vals, R, 6, SHIFT, CUT),
         lambda: band.cascade_counts_plain(lw, c_codes, c_vals, R, 6, SHIFT,
                                           CUT),
         cascade_library,
         nbytes(lw, c_codes, c_vals) + I * 6 * R * 5 * 4, c_ops),
        # one log factor (4 operations) per (row, base, channel) of the
        # slabs, one add per scored cell; library: soft_K, the skew and one
        # bmm against a prebuilt one-hot
        ("band_soft", "figbird_tpu_torch/csrc/band_soft.cu",
         "figbird_tpu/ops/band.py:144", 1e-5, 1e-3,
         lambda: band.band_score_soft(b_codes, b_valid, probs, eprobs, e_pos,
                                      bw),
         lambda: band.band_score_soft_plain(b_codes, b_valid, probs, eprobs,
                                            e_pos, bw),
         lambda: band.band_score_onehot(
             b_oh, band.soft_K(probs, eprobs, e_pos), bw),
         nbytes(b_codes, b_valid, probs, eprobs, e_pos) + out_f32,
         n_cells + 4 * I * b_R * L * 5),
        # the gap-string form the main path launches: one add per entry of
        # K (I, R, 5L) and per scored cell; library: hard_K, the skew and
        # one bmm against a prebuilt one-hot
        ("band_hard", "figbird_tpu_torch/csrc/band_hard.cu",
         "figbird_tpu/ops/band.py:63", 1e-5, 1e-4,
         lambda: band.band_score_hard(b_codes, b_valid, gap, a_f, b_f, ln_et,
                                      bw),
         lambda: band.band_score_hard_plain(b_codes, b_valid, gap, a_f, b_f,
                                            ln_et, bw),
         lambda: band.band_score_onehot(
             b_oh, band.hard_K(gap, a_f, b_f, ln_et), bw),
         nbytes(b_codes, b_valid, gap, a_f, b_f, ln_et) + out_f32,
         n_cells + I * b_R * L * 5),
        ("fold", "figbird_tpu_torch/csrc/fold.cu",
         "figbird_tpu/ops/band.py:320", 2e-6, 0.0,
         lambda: band.fold_counts(f_w, f_codes, f_vals, R),
         lambda: band.fold_counts_plain(f_w, f_codes, f_vals, R),
         lambda: band.fold_T(torch.bmm(f_ohT, f_w), L, R),
         nbytes(f_w, f_codes, f_vals) + n_f * R * 5 * 4, f_ops),
    ]
    rows = []
    for name, src, repl, rtol, atol, kern, plain, lib, n_b, n_o in specs:
        if name == "cascade":
            err = check_cascade(lw, c_codes, c_vals, R, 6, "banded, m = 6")
        else:
            got = kern()
            want = plain()
            torch.cuda.synchronize()
            err, ok = close(got, want, rtol, atol)
            if not ok:
                raise AssertionError(f"{name} disagrees with its plain "
                                     f"version (max abs err {err})")
            del got, want
        ms, plain_ms, library_ms = timed(kern, plain, lib)
        bound_ms, bound_by = bound(n_b, n_o)
        log(f"{name}: max_abs_err {err:.3g} (rtol {rtol}, atol {atol}) "
            f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, library "
            f"{'none' if library_ms is None else f'{library_ms:.3f} ms'}, "
            f"bound {bound_ms:.4f} ms by {bound_by} ({n_b / 1e6:.1f} MB, "
            f"{n_o / 1e9:.3f} G operations)")
        rows.append(dict(name=name, route="cuda", source=src, replaces=repl,
                         launches=0, max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=library_ms))
    rows.append(check_align(g))
    # K2 and K3 at every instance batch the main path sends them, and K3's
    # K form beside its gap-string form (timed at the scan's batch too)
    check_bands(b_in, bw, f"banded, {I} instances", ("K form",))
    for n in (256, 128, FINALIZE_BATCH):
        check_bands([x[:n] if x.dim() > 1 and x.shape[0] == I else x
                     for x in b_in], bw, f"banded, {n} instances")
    del b_in, b_codes, b_valid, probs, eprobs, gap, b_oh
    # K4 at the larger batches exact_soft=False sends it, up to the scan's
    for n in (*PARTIAL_BATCHES, I):
        w_n, c_n, v_n = weights[:n], codes[:n], vals[:n]
        check_fold(w_n, c_n, v_n, R, f"banded, {n} instances")
        ohT = band.oh_flat_c(c_n, v_n).transpose(1, 2).contiguous()
        log(f"fold banded, {n} instances: kernel "
            f"{cuda_ms(lambda: band.fold_counts(w_n, c_n, v_n, R)):.3f} ms, "
            f"plain "
            f"{cuda_ms(lambda: band.fold_counts_plain(w_n, c_n, v_n, R)):.3f}"
            f" ms, library "
            f"{cuda_ms(lambda: band.fold_T(torch.bmm(ohT, w_n), L, R)):.3f}"
            f" ms")
        del ohT
    # K4, untimed: quality-error weights as count values (the finalize's
    # quality sums), not 0/1
    check_fold(f_w, f_codes, f_vals * rand(n_f, P, L) * 1e-2, R,
               f"banded, {n_f} instances, quality-weighted values")
    check_fold(weights, codes, vals * rand(I, P, L) * 1e-2, R,
               "banded, quality-weighted values")
    del lw, c_codes, c_vals, c_ohT, f_ohT, weights, f_w
    torch.cuda.empty_cache()

    # K1, untimed: the mini-cascade depth, and the full-width shape of the
    # unmapped mode (512 reads, Wp = L + 512; the instance batch the fill
    # driver's memory cap gives that bucket)
    check_cascade(*cascade_inputs(g, min(I, 64), P, L, bw), R, 3,
                  "banded, m = 3")
    n_u, gb = FULL_WIDTH
    Wp = L + gb
    ib = min(I, int(1.5e9) // (n_u * (5 * L + 4 * Wp) * 8))
    lw, c_codes, c_vals = cascade_inputs(g, ib, n_u, L, Wp)
    check_cascade(lw, c_codes, c_vals, Wp + L, 6,
                  f"full width, {n_u} reads, m = 6")
    # K4 at the same shape: the core both kernels share will serve that mode
    del lw
    weights = torch.where(rand(ib, n_u, Wp) < 0.5, 0.0, rand(ib, n_u, Wp))
    check_fold(weights, c_codes, c_vals, Wp + L,
               f"full width, {n_u} reads")
    del weights, c_codes, c_vals
    torch.cuda.empty_cache()
    # K2 and K3 at the same shape, checked and timed
    check_bands(band_inputs(g, ib, n_u, L, Wp), Wp,
                f"full width, {ib} instances x {n_u} reads")
    torch.cuda.empty_cache()
    return rows


def u_batch(n_reads: int, gb: int, L: int = 101) -> int:
    """The instance batch of an unmapped bucket: fill_gaps' memory cap on
    the card's instance batch of 768."""
    Wp = L + gb
    return max(4, min(768, int(1.5e9) // (n_reads * (5 * L + 4 * Wp) * 8)))


def u_row(name, src, repl, key, shape, err, times, n_b, n_o):
    ms, plain_ms, library_ms = times
    bound_ms, bound_by = bound(n_b, n_o)
    log(f"{name} {shape}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"library {library_ms:.3f} ms, bound {bound_ms:.4f} ms by {bound_by} "
        f"({n_b / 1e6:.1f} MB, {n_o / 1e9:.3f} G operations)")
    return dict(name=name, route="cuda", source=src, replaces=repl,
                shape=shape, launches=0, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms, key=key)


def phase_kernels_unmapped():
    """K1-K4 at the unmapped mode's shapes: every read at every position of
    the window, each at the instance batch that fill_gaps' memory cap gives
    its bucket.  K1 (m = 6) and K4 at every U_SHAPES entry, K4 with the
    hard counts' weights (one 1 per accepted read); K2 and both K3 forms,
    with the reverse strand's factors, at every entry too.
    Checked as in phase 2 and timed beside the plain versions, library
    chains and bounds."""
    g = torch.Generator(device=DEV).manual_seed(1)
    L = 101
    rows = []
    for n, gb, width in U_SHAPES:
        ib = u_batch(n, gb)
        Wp = L + width
        W = Wp + L
        shape = f"unmapped {ib} x {n} reads x Wp {Wp}"
        lw, codes, vals = cascade_inputs(g, ib, n, L, Wp)
        err = check_cascade(lw, codes, vals, W, 6, shape + ", m = 6")
        nval = (vals != 0).sum(-1)
        ops = 0
        for k in range(6):
            nz = (band.level_weight(lw, k, SHIFT, CUT) != 0).sum(-1)
            ops += 2 * int((nz * nval).sum()) + int(nz.sum())
        ohT = band.oh_flat_c(codes, vals).transpose(1, 2).contiguous()

        def cascade_library():
            outs = []
            for g0 in (0, 3):
                wk = torch.cat([band.level_weight(lw, k, SHIFT, CUT)
                                for k in range(g0, g0 + 3)], dim=2)
                cwT = torch.bmm(ohT, wk)
                outs += [band.fold_T(cwT[:, :, i * Wp : (i + 1) * Wp], L, W)
                         for i in range(3)]
            return torch.stack(outs, dim=1)

        times = timed(
            lambda: band.cascade_counts(lw, codes, vals, W, 6, SHIFT, CUT),
            lambda: band.cascade_counts_plain(lw, codes, vals, W, 6, SHIFT,
                                              CUT), cascade_library)
        rows.append(u_row("cascade", "figbird_tpu_torch/csrc/cascade.cu",
                          "figbird_tpu/ops/band.py:242", (n, Wp), shape, err,
                          times,
                          nbytes(lw, codes, vals) + ib * 6 * W * 5 * 4, ops))
        del lw, cascade_library
        torch.cuda.empty_cache()
        # K4: the hard counts, one weight 1 at each accepted read's argmax
        acc = torch.rand(ib, n, generator=g, device=DEV) < 0.8
        at = torch.randint(0, Wp, (ib, n, 1), generator=g, device=DEV)
        weights = (acc[..., None] & (torch.arange(Wp, device=DEV) == at)
                   ).to(torch.float32)
        err = check_fold(weights, codes, vals, W, shape + ", hard counts")
        times = timed(lambda: band.fold_counts(weights, codes, vals, W),
                      lambda: band.fold_counts_plain(weights, codes, vals, W),
                      lambda: band.fold_T(torch.bmm(ohT, weights), L, W))
        ops = 2 * int(((weights != 0).sum(-1) * nval).sum())
        rows.append(u_row("fold", "figbird_tpu_torch/csrc/fold.cu",
                          "figbird_tpu/ops/band.py:320", (n, Wp), shape, err,
                          times,
                          nbytes(weights, codes, vals) + ib * W * 5 * 4, ops))
        del weights, codes, vals, ohT
        torch.cuda.empty_cache()
        # K2 and K3 with the reverse strand's factors
        bshape = shape + ", reverse strand"
        codes, valid, probs, eprobs, e_pos, gap, a, b, ln_et = band_inputs(
            g, ib, n, L, Wp)
        b_in = (codes, valid, probs, eprobs, e_pos.flip(0), gap, a.flip(0),
                b.flip(0), ln_et)
        times = check_bands(b_in, Wp, bshape, ("K2", "gap form"))
        n_cells = int((valid & (codes < 5)).sum()) * Wp
        R = gap.shape[1]
        out_f32 = ib * n * Wp * 4
        rows.append(u_row("band_soft", "figbird_tpu_torch/csrc/band_soft.cu",
                          "figbird_tpu/ops/band.py:144", (n, Wp), bshape,
                          times["K2"][0], times["K2"][1:],
                          nbytes(codes, valid, probs, eprobs, e_pos)
                          + out_f32, n_cells + 4 * ib * R * L * 5))
        rows.append(u_row("band_hard", "figbird_tpu_torch/csrc/band_hard.cu",
                          "figbird_tpu/ops/band.py:63", (n, Wp), bshape,
                          times["gap form"][0], times["gap form"][1:],
                          nbytes(codes, valid, gap, a, b, ln_et) + out_f32,
                          n_cells + ib * R * L * 5))
        del b_in, codes, valid, probs, eprobs, gap
        torch.cuda.empty_cache()
    return rows


def u_rows_with_launches(u_rows, by_shape, mesh_by_shape):
    """The kernels line's unmapped rows: each row at a (reads, positions)
    shape the u-iteration launched its kernel at carries those launches,
    and the mesh u-iteration's at that shape (``mesh_launches``); a row at
    a shape it did not launch (the full-width buckets above 128 reads,
    which bench.py's dataset never fills) goes under the key
    ``not_on_main_path`` of its kernel's first row that did."""
    top, rest = [], []
    for r in u_rows:
        key = (r["name"],) + r.pop("key")
        r["launches"] = by_shape.get(key, 0)
        r["mesh_launches"] = mesh_by_shape.get(key, 0)
        (top if r["launches"] else rest).append(r)
    for r in rest:
        host = next((t for t in top if t["name"] == r["name"]), None)
        assert host is not None, f"{r['name']}: no u row on the main path"
        host.setdefault("not_on_main_path", []).append(r)
    return top


# ---------------------------------------------------------------- phase 3
def _cfg(insert, read_len):
    return config.FigbirdConfig(
        draft_genome="", output_folder="",
        read_pairs=[config.ReadLibrary("", "", avg_insert_size=insert,
                                       max_read_length=read_len)],
        parameters=config.Parameters(trim_len=0, evaluation=0))


# tests/test_pipeline.py's 120 kb simulation; the precision tiers of the
# p-iteration (the production default first)
PARITY_SIM = dict(genome_len=120_000, n_contigs=1, n_gaps=8,
                  gap_len_range=(8, 60), insert_mean=250, insert_sd=20,
                  coverage=25, error_rate=0.004, seed=42)
FILLS = (("default", {}), ("exact_soft=False", {"exact_soft": False}),
         ("exact_soft='auto'", {"exact_soft": "auto"}),
         ("exact_soft='hybrid'", {"exact_soft": "hybrid"}))
U_PARITY = "u default"


def parity_side(dev) -> dict:
    """Phase 3's iterations on ``dev``: the p-iteration at every tier of
    FILLS, then a fresh Pipeline's u-iteration at the default.  For each:
    the aligner outputs (the u-iteration's end-to-end pass), gap strings,
    N, wall and the fill's escalation counts."""
    sim = simulate.simulate(simulate.SimConfig(**PARITY_SIM))
    cfg = _cfg(250, 100)
    out = {}
    for what, fill_kwargs, mode in ([(w, kw, "p") for w, kw in FILLS]
                                    + [(U_PARITY, {}, "u")]):
        p = Pipeline(cfg, sim.draft, [(sim.reads1, sim.reads2)],
                     fill_kwargs=fill_kwargs, device=dev)
        t0 = time.time()
        st = p.run_iteration(mode, 0)
        wall = time.time() - t0
        aligns = p.last_alignments if mode == "p" else p.last_alignments_e2e
        out[what] = dict(
            wall=wall, n=(st.n_before, st.n_after),
            align=[{k: a[k] for k in ALIGN_KEYS} for a in aligns],
            strings=p.result.gap_history[0][1],
            esc={k: v for k, v in p.last_fill_stats.items()
                 if k.startswith("esc_")})
        log(f"parity {what} {dev}: {wall:.1f}s N {st.n_before} -> "
            f"{st.n_after}")
    return out


def parity_compare(card: dict, cpu: dict) -> None:
    """Phase 3's checks: the aligner outputs of every iteration equal on the
    card and the CPU, the number of equal gap strings printed for each p
    tier, and the u-iteration's gap strings all equal."""
    for what in [w for w, _ in FILLS] + [U_PARITY]:
        g, c = card[what], cpu[what]
        for a_gpu, a_cpu in zip(g["align"], c["align"]):
            for k in ALIGN_KEYS:
                np.testing.assert_array_equal(a_gpu[k], a_cpu[k],
                                              err_msg=f"{what}: {k}")
        n_eq = sum(np.array_equal(x, y)
                   for x, y in zip(g["strings"], c["strings"]))
        esc = f"; lanes escalated card {g['esc']}, CPU {c['esc']}" \
            if g["esc"] or c["esc"] else ""
        log(f"parity {what}: aligner outputs equal; gap strings equal "
            f"{n_eq}/{len(g['strings'])}; card {g['wall']:.1f}s, CPU "
            f"{c['wall']:.1f}s{esc}")
        if what == U_PARITY:
            assert n_eq == len(g["strings"]) == len(c["strings"]), \
                "u gap strings differ"


# ---------------------------------------------------------------- phase 4
# the single-device default iterations of phases 4 and 5, by mode: what
# the mesh and the two processes of phases 7 and 8 must give
SINGLE = {}


def run_record(pipe, st) -> dict:
    (_, strings, skips), = pipe.result.gap_history
    return dict(n_before=st.n_before, n_after=st.n_after, strings=strings,
                gaptofill=np.asarray(skips), contigs=pipe.genome.contigs)


def assert_runs_equal(got, want, what):
    assert got["n_after"] == want["n_after"], (what, got["n_after"],
                                               want["n_after"])
    assert len(got["strings"]) == len(want["strings"]), what
    for i, (a, b) in enumerate(zip(got["strings"], want["strings"])):
        assert np.array_equal(a, b), f"{what}: gap string {i} differs"
    assert np.array_equal(got["gaptofill"], want["gaptofill"]), what
    for i, (a, b) in enumerate(zip(got["contigs"], want["contigs"])):
        assert np.array_equal(a, b), f"{what}: contig {i} differs"


def run_main(sim, what, fill_kwargs, expect, mode="p", min_acc=0.95,
             keep=False):
    """One iteration (``mode``) at full scale with the launch counts set to
    0 just before and read just after; the kernels in ``expect`` must have
    been launched.  ``keep``: the run's outputs go to ``SINGLE[mode]``.
    Returns the launches, the wall, the gap strings and the fill stats."""
    n_reads = 2 * len(sim.reads1)
    pipe = Pipeline(_cfg(200, 101), sim.draft, [(sim.reads1, sim.reads2)],
                    fill_kwargs=fill_kwargs, device=DEV)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.time()
    st = pipe.run_iteration(mode, 0)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(ops.LAUNCHES)
    by_c = dict(sorted(align_score.LAUNCHES_BY_C.items()))
    gaps, strings, _ = pipe.result.gap_history[0]
    fa = chr14.fill_accuracy(sim, gaps, strings)
    acc = fa["identity"]
    log(f"main path {what}: wall {wall:.2f}s, {n_reads / wall:.0f} reads/s, "
        f"N {st.n_before} -> {st.n_after}, filled-base accuracy {acc:.4f} "
        f"({fa['filled']}/{fa['total']} bases filled), launches {launches}, "
        f"align_score launches by candidates a read {by_c}")
    pipe.timer.report(sys.stdout)
    log(f"fill stats {what}: {pipe.last_fill_stats}")
    missing = [k for k in expect if launches[k] == 0]
    assert not missing, f"kernels not launched on the {what} path: {missing}"
    assert st.n_after < st.n_before, "N not reduced"
    if min_acc is not None:
        assert acc >= min_acc, f"filled-base accuracy {acc:.4f} < {min_acc}"
    if keep:
        SINGLE[mode] = run_record(pipe, st)
    return launches, wall, strings, pipe.last_fill_stats


def busy_share(sim, wall_plain, mode="p"):
    """One default iteration under torch.profiler: the union of the device
    activity's intervals, over the iteration's wall with the profiler on
    and over ``wall_plain``, the same iteration's wall without it."""
    from torch.profiler import ProfilerActivity, profile

    pipe = Pipeline(_cfg(200, 101), sim.draft, [(sim.reads1, sim.reads2)],
                    device=DEV)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        pipe.run_iteration(mode, 0)
        torch.cuda.synchronize()
        wall = time.time() - t0
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, -1.0
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            t, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (t + e.time_range.elapsed_us(), n + 1)
    log(f"profile default {mode}: wall {wall:.3f}s with the profiler on, "
        f"device busy {busy / 1e3:.1f} ms over {len(spans)} device events, "
        f"busy "
        f"share {busy / 1e6 / wall:.3f} of that wall, "
        f"{busy / 1e6 / wall_plain:.3f} of the warm wall without the "
        f"profiler ({wall_plain:.3f}s)")
    ranked = sorted(by_name.items(), key=lambda x: -x[1][0])
    # the eight largest, then every hand-written kernel below them
    ours = ("band_core::kernel", "cascade_kernel", "fold_kernel",
            "align_score::kernel")
    for i, (name, (t, n)) in enumerate(ranked):
        if i < 8 or any(k in name for k in ours):
            log(f"profile default {mode}:   {t / 1e3:8.1f} ms {n:6d} x "
                f"{name[:90]}")


def bench_sim(genome_len=4_600_000):
    """bench.py's dataset (scale 1.0): 4.6 Mb, 50 gaps of 10-120 bp, 2x101 bp
    reads, insert 200 +- 20, 10x."""
    t0 = time.time()
    sim = simulate.simulate(simulate.SimConfig(
        genome_len=genome_len, n_contigs=4, n_gaps=50,
        gap_len_range=(10, 120), read_len=101, insert_mean=200, insert_sd=20,
        coverage=10.0, error_rate=0.005, seed=1))
    log(f"main path dataset: {sim.truth.total_length()} bp, "
        f"{2 * len(sim.reads1)} reads, {len(sim.draft.find_gaps())} gaps "
        f"(simulated in {time.time() - t0:.1f}s)")
    return sim


def phase_main(sim, profile_run: bool):
    all5 = tuple(ops.LAUNCHES)
    four = tuple(k for k in all5 if k != "cascade")
    launches, _, s_def, _ = run_main(sim, "default", {}, all5, keep=True)
    _, _, s_f32, _ = run_main(sim, "exact_soft=False", {"exact_soft": False},
                           four)
    n_diff = sum(not np.array_equal(a, b) for a, b in zip(s_def, s_f32))
    log(f"main path: {n_diff}/{len(s_def)} gap strings differ between the "
        f"default and exact_soft=False")
    # once more each, warm: the cost of the exact cascade end to end
    _, w_def, _, _ = run_main(sim, "default (warm)", {}, all5)
    _, w_f32, _, _ = run_main(sim, "exact_soft=False (warm)",
                           {"exact_soft": False}, four)
    log(f"main path warm walls: default {w_def:.3f}s, exact_soft=False "
        f"{w_f32:.3f}s, ratio {w_def / w_f32:.3f}")
    if profile_run:
        busy_share(sim, w_def)
    return launches


def phase_main_unmapped(sim, profile_run: bool):
    """bench.py's u-trial: a fresh Pipeline's u-iteration at the default,
    all five kernels launched, N reduced; then one reference_exact
    u-iteration and its gap strings against the default's."""
    all5 = tuple(ops.LAUNCHES)
    _, wall, s_def, _ = run_main(sim, "u default", {}, all5, "u",
                                 keep=True)
    by_shape = dict(ops.LAUNCHES_BY_SHAPE)
    log("main path u default: launches by (kernel, reads, positions) "
        + str(dict(sorted(by_shape.items()))))
    _, _, s_x, _ = run_main(sim, "u reference_exact",
                            {"reference_exact": True}, all5, "u")
    n_eq = sum(np.array_equal(a, b) for a, b in zip(s_def, s_x))
    log(f"main path u: default vs reference_exact gap strings equal "
        f"{n_eq}/{len(s_def)}")
    if profile_run:
        busy_share(sim, wall, "u")
    return by_shape


# ---------------------------------------------------------------- phase 6
# the two-library schedule (RunFigbird.sh:534-595): frag library 0, jump 1
TWO_LIB_SCHEDULE = [("p", 0), ("u", 1), ("u", 1), ("p", 0), ("u", 1),
                    ("p", 0), ("p", 0), ("p", 0)]
# the reference CLI's progress line of an iteration: (mode, library)
ITR_LINE = re.compile(r"^# itr \d+ \[([pu]) lib(\d+)\]: \d+ gaps, \d+ "
                      r"filled, N \d+->\d+ \([\d.]+s\)$")


class _Tee:
    """stderr that also keeps what was written (the CLI's progress
    lines)."""

    def __init__(self, stream):
        self.stream, self.parts = stream, []

    def write(self, text):
        self.parts.append(text)
        return self.stream.write(text)

    def flush(self):
        self.stream.flush()


@contextlib.contextmanager
def _timed_calls(module, name, seconds: list):
    """Replace ``module.name`` by a wrapper that adds each call's seconds to
    ``seconds`` (the CLI imports it from the module when it runs)."""
    fn = getattr(module, name)

    def wrapper(*args, **kwargs):
        t0 = time.time()
        try:
            return fn(*args, **kwargs)
        finally:
            seconds.append(time.time() - t0)

    setattr(module, name, wrapper)
    try:
        yield
    finally:
        setattr(module, name, fn)


def schedule_dataset(sim, out: Path) -> Path:
    """scripts/schedule_e2e.py's two-library dataset on disk: the frag
    library is bench.py's, the jump library (insert 600 +- 50, 5x, 0.5%
    errors, seed 2) is simulated on the same truth; a reference-schema
    Config.json (default schedule, no flank trim, evaluation against the
    truth)."""
    from figbird_tpu_torch.io.fasta import write_fasta
    from figbird_tpu_torch.io.fastq import write_fastq

    t0 = time.time()
    simj = simulate.simulate(simulate.SimConfig(
        genome_len=4_600_000, n_contigs=4, n_gaps=50, read_len=101,
        insert_mean=600, insert_sd=50, coverage=5.0, error_rate=0.005,
        seed=2), truth=sim.truth)
    write_fasta(out / "draft.fa", sim.draft.to_fasta(), width=60)
    write_fasta(out / "truth.fa", sim.truth.to_fasta(), width=60)
    pairs = []
    for tag, s, insert in (("f", sim, 200), ("j", simj, 600)):
        for m, rb in ((1, s.reads1), (2, s.reads2)):
            write_fastq(out / f"{tag}{m}.fq", rb)
        pairs.append({"path_1": str(out / f"{tag}1.fq"),
                      "path_2": str(out / f"{tag}2.fq"),
                      "avg_insert_size": insert, "max_read_length": 101})
    cfg = out / "Config.json"
    cfg.write_text(json.dumps({
        "Directory": {"Draft_Genome": str(out / "draft.fa"),
                      "Output_Folder": str(out),
                      "Reference_Genome": str(out / "truth.fa")},
        "Read_Pairs": pairs,
        "Parameters": {"numthreads": 8, "evaluation": 1, "default": 1,
                       "trim_len": 0}}, indent=1))
    log(f"schedule dataset: frag {2 * len(sim.reads1)} + jump "
        f"{2 * len(simj.reads1)} reads written with the draft, truth and "
        f"Config.json in {time.time() - t0:.1f}s")
    return cfg


def expected_tree(n_itr: int) -> set:
    """Every file the reference CLI writes for ``n_itr`` iterations with
    evaluation on (``figbird_tpu/__main__.py``, ``pipeline.py``)."""
    files = {"FilledScaffolds_final.fa", "Individual_gaps.txt",
             "combined_gapstring.txt", "Result.txt", "Temp/gapInfo.txt",
             "Temp/stat.txt", "Temp/stat2.txt", "Temp/gaploads.txt",
             "Temp/Ncount.txt", "Temp/combined_gapstring.txt"}
    for i in range(1, n_itr + 1):
        files |= {f"Filled_Scaffolds/{i}filledContigs.fa",
                  f"Individual_gaps/gapout_{i}.txt",
                  f"Individual_gaps/alignment_{i}.txt"}
    return files


def phase_schedule(sim, out: Path):
    """The whole run through the port's CLI on the card (module docstring,
    phase 6), its files in ``out``.  Returns the run's launches by kernel
    and what phase 12c resumes from: the Config.json, the output tree, the
    number of iterations and the final N."""
    from figbird_tpu_torch import __main__ as cli
    from figbird_tpu_torch import evalx, pipeline
    from figbird_tpu_torch.genome import Genome
    from figbird_tpu_torch.io import fastq, native
    from figbird_tpu_torch.io.fasta import read_fasta

    cfg = schedule_dataset(sim, out)
    seen = []

    class Seen(pipeline.Pipeline):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            seen.append(self)

    parse_s, eval_s = [], []
    tee = _Tee(sys.stderr)
    real = pipeline.Pipeline
    pipeline.Pipeline = Seen
    try:
        with _timed_calls(fastq, "read_fastq", parse_s), \
                _timed_calls(evalx, "evaluate_against_reference",
                             eval_s), contextlib.redirect_stderr(tee):
            torch.cuda.synchronize()
            ops.reset_launches()
            t0 = time.time()
            rc = cli.main([str(cfg)])
            torch.cuda.synchronize()
            wall = time.time() - t0
    finally:
        pipeline.Pipeline = real
    launches = dict(ops.LAUNCHES)
    by_shape = dict(ops.LAUNCHES_BY_SHAPE)
    by_c = dict(sorted(align_score.LAUNCHES_BY_C.items()))
    assert rc == 0, f"the CLI exited with {rc}"
    ran = [(m[1], int(m[2])) for m in map(
        ITR_LINE.match, "".join(tee.parts).splitlines()) if m]
    pipe, = seen
    log(f"schedule: CLI wall {wall:.2f}s for {len(ran)} iterations "
        f"{ran}, FASTQ parse {sum(parse_s):.2f}s over {len(parse_s)} "
        f"files (native parser {native.get_lib() is not None}), "
        f"evaluate_against_reference {sum(eval_s):.2f}s")
    for st in pipe.result.iterations:
        log(f"schedule itr {st.itr} [{st.mode} lib{st.lib}]: wall "
            f"{st.seconds:.3f}s, N {st.n_before} -> {st.n_after}, "
            f"{st.gaps} gaps, {st.filled} filled, {st.n_pairs} pairs")
    pipe.timer.report(sys.stdout)
    log(f"schedule launches {launches}; by (kernel, reads, positions) "
        f"{dict(sorted(by_shape.items()))}; align_score by candidates a "
        f"read {by_c}")
    assert ran and ran == TWO_LIB_SCHEDULE[:len(ran)], ran
    last = pipe.result.iterations[-1]
    assert len(ran) == len(TWO_LIB_SCHEDULE) \
        or last.n_after in (0, last.n_before), \
        f"the schedule stopped after {len(ran)} iterations while N moved"
    missing = [k for k, n in launches.items() if n == 0]
    assert not missing, f"kernels not launched by the schedule: {missing}"

    wd = out / "Figbird"
    draft = Genome.from_fasta(read_fasta(out / "draft.fa"))
    final = Genome.from_fasta(read_fasta(wd / "FilledScaffolds_final.fa"))
    assert final.count_n() < draft.count_n(), "N not reduced"
    rows = (wd / "Individual_gaps.txt").read_text().splitlines()[2:]
    strings = [dtypes.encode(r.split("\t")[3]) for r in rows]
    acc = evalx.fill_accuracy_vs_truth(sim.truth, draft.find_gaps(),
                                       strings)
    tree = {str(p.relative_to(wd)) for p in wd.rglob("*") if p.is_file()}
    missing = expected_tree(len(ran)) - tree
    result = (wd / "Result.txt").read_text().splitlines()
    log(f"schedule: N {draft.count_n()} -> {final.count_n()}, filled-base "
        f"accuracy of the combined gaps {acc.identity:.4f} "
        f"({acc.filled_bases}/{acc.total_gap_bases} bases filled, "
        f"{acc.closed}/{acc.n_gaps} gaps closed at their length), "
        f"{len(tree)} files in the output tree; Result.txt "
        f"{dict(zip(result[0].split(), result[1].split()))}")
    assert acc.identity >= 0.95, f"filled-base accuracy {acc.identity}"
    assert not missing, f"output tree lacks {sorted(missing)}"
    assert (wd / "FilledScaffolds_final.fa").read_bytes() == (
        wd / "Filled_Scaffolds" / f"{len(ran)}filledContigs.fa"
    ).read_bytes(), "the final assembly differs from the last iteration's"
    return launches, dict(cfg=cfg, wd=wd, n_itr=len(ran),
                          n_final=final.count_n())


# ---------------------------------------------------------------- phase 7
def mesh_devices(n: int) -> list:
    """``cuda:i % device_count`` for i < n: n devices of the mesh on the
    cards there are (on one card, that card n times)."""
    return [torch.device("cuda", i % torch.cuda.device_count())
            for i in range(n)]


ALIGN_CMP = ("score", "aligned", "unique", "second")
PLACE_CMP = ("pos", "strand", "clip_start", "clip_end", "n_mis", "alen")


def phase_mesh_aligners(sim):
    """(a) The code-range and contig-range aligners on a (reads 2, genome 4)
    mesh against the replicated ``use_buckets=False`` aligner, local and
    end-to-end presets, both mates; the reference's test compares score,
    aligned, unique and second for every read and the placement fields
    for every read with a candidate."""
    from figbird_tpu_torch.align import core
    from figbird_tpu_torch.align.index import build_index
    from figbird_tpu_torch.parallel import make_mesh

    t0 = time.time()
    idx = build_index(sim.draft, k=15)
    log(f"mesh aligners: host index of {len(idx.flat)} flat bases in "
        f"{time.time() - t0:.2f}s")
    mesh = make_mesh(8, 4, devices=mesh_devices(8))
    jobs = [(r.seq, r.length) for r in (sim.reads1, sim.reads2)]
    kw = dict(two_tier=False, indel_tier=False)
    n_k5_all = 0
    for preset, p in (("local", core.AlignParams(want_mism=False)),
                      ("e2e", core.e2e_params(
                          core.AlignParams(want_mism=False)))):
        al = core.Aligner(idx, p, use_buckets=False, device=DEV, **kw)
        torch.cuda.synchronize()
        t0 = time.time()
        want = al.align_many(jobs)
        torch.cuda.synchronize()
        log(f"mesh aligners {preset}: replicated use_buckets=False "
            f"{time.time() - t0:.2f}s for {2 * len(sim.reads1)} reads")
        for path in ("code", "contig"):
            with chr14.K5ByShard() as k5:
                t0 = time.time()
                al = core.Aligner(idx, p, mesh=mesh, genome_shard=path,
                                  contig_shard_threshold=1, **kw)
                t_init = time.time() - t0
                torch.cuda.synchronize()
                ops.reset_launches()
                t0 = time.time()
                got = al.align_many(jobs)
                torch.cuda.synchronize()
                wall = time.time() - t0
            by_shard = k5.counts
            n_k5 = ops.LAUNCHES["align_score"]
            n_k5_all += n_k5
            for mate, (g, w) in enumerate(zip(got, want)):
                for k in ALIGN_CMP:
                    assert np.array_equal(g[k], w[k]), (path, preset, mate, k)
                has = w["aligned"] | (w["score"] > -32000)
                for k in PLACE_CMP:
                    assert np.array_equal(g[k][has], w[k][has]), (
                        path, preset, mate, k)
            assert sum(by_shard.values()) == n_k5 > 0
            assert sorted(by_shard) == [0, 1, 2, 3], by_shard
            log(f"mesh aligners {preset} {path}-range on {mesh.shape}: "
                f"equal to the replicated aligner for both mates "
                f"({int(has.sum())} reads of mate 2 with a candidate); "
                f"init {t_init:.2f}s, pass {wall:.2f}s, K5 launches "
                f"{n_k5}, by genome shard {dict(sorted(by_shard.items()))}")
    return n_k5_all


def phase_mesh_iterations(sim):
    """(b) The p-iteration and a fresh Pipeline's u-iteration on a
    (reads 2, genome 2) mesh, code-range shards, each with the launch
    counts set to 0 just before and read just after: all five kernels
    launched; gap strings, gaptofill and contigs equal to phases 4 and 5's
    single-device default iterations.  Returns the launches by kernel of
    the p-iteration and by (kernel, reads, positions) of the u-iteration."""
    from figbird_tpu_torch.parallel import make_mesh

    mesh = make_mesh(4, 2, devices=mesh_devices(4))
    out = {}
    for mode in ("p", "u"):
        pipe = Pipeline(_cfg(200, 101), sim.draft,
                        [(sim.reads1, sim.reads2)], mesh=mesh,
                        aligner_kwargs={"genome_shard": "code"})
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.time()
        st = pipe.run_iteration(mode, 0)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(ops.LAUNCHES)
        by_shape = dict(sorted(ops.LAUNCHES_BY_SHAPE.items()))
        by_c = dict(sorted(align_score.LAUNCHES_BY_C.items()))
        assert_runs_equal(run_record(pipe, st), SINGLE[mode],
                          f"mesh {mode}-iteration")
        missing = [k for k, n in launches.items() if n == 0]
        assert not missing, f"kernels not launched on the mesh: {missing}"
        log(f"mesh {mode}-iteration on {mesh.shape} (code-range): wall "
            f"{wall:.2f}s, N {st.n_before} -> {st.n_after}, "
            f"{len(SINGLE[mode]['strings'])} gap strings, gaptofill and "
            f"contigs equal to the single-device iteration; launches "
            f"{launches}; by (kernel, reads, positions) {by_shape}; K5 by "
            f"candidates a read {by_c}")
        pipe.timer.report(sys.stdout)
        out[mode] = launches if mode == "p" else by_shape
    return out


# ---------------------------------------------------------------- phase 8
WORKER = """
import os, sys, time
import numpy as np
import torch

sys.path.insert(0, os.environ["FIGBIRD_ROOT"])
from figbird_tpu_torch.parallel.distributed import (init_from_env,
                                                     process_index)

assert init_from_env(), "no process group"
from figbird_tpu_torch import config, ops
from figbird_tpu_torch.genome import Genome
from figbird_tpu_torch.io.fastq import ReadBatch
from figbird_tpu_torch.pipeline import Pipeline

z = np.load(os.environ["FIGBIRD_DATA"])
draft = Genome([str(n) for n in z["names"]],
               [z[f"c{i}"] for i in range(len(z["names"]))])
libs = [tuple(ReadBatch(z[f"seq{m}"], z[f"len{m}"], z[f"qual{m}"])
              for m in (1, 2))]
cfg = config.FigbirdConfig(
    draft_genome="", output_folder="",
    read_pairs=[config.ReadLibrary("", "", avg_insert_size=200,
                                   max_read_length=101)],
    parameters=config.Parameters(trim_len=0, evaluation=0))
pipe = Pipeline(cfg, draft, libs)
assert pipe.dist
n_pairs = len(pipe.libs[0][0])
torch.cuda.synchronize()
ops.reset_launches()
t0 = time.time()
st = pipe.run_iteration("p", 0)
torch.cuda.synchronize()
wall = time.time() - t0
launches = [ops.LAUNCHES[k] for k in sorted(ops.LAUNCHES)]
(_, strings, skips), = pipe.result.gap_history
np.savez(os.environ["FIGBIRD_OUT"] + f".{process_index()}", wall=wall,
         n_pairs=n_pairs, launches=launches, n_before=st.n_before,
         n_after=st.n_after, gaptofill=np.asarray(skips),
         **{f"s{i}": s for i, s in enumerate(strings)},
         **{f"c{i}": c for i, c in enumerate(pipe.genome.contigs)})
"""


def phase_two_processes(sim, timeout=300):
    """Two processes on the card, joined by gloo on 127.0.0.1
    (``init_from_env``), each holding half the read pairs, run the
    p-iteration; each one's N, gap strings, gaptofill and contigs must equal
    phase 4's single-process iteration.  A worker that fails or outlives
    its timeout fails the phase.  Returns the launches by kernel of both
    processes' iterations together."""
    import socket

    with tempfile.TemporaryDirectory(prefix="figbird_two_") as tmp:
        tmp = Path(tmp)
        r1, r2 = sim.reads1, sim.reads2
        np.savez(tmp / "data.npz", names=np.asarray(sim.draft.names),
                 **{f"c{i}": c for i, c in enumerate(sim.draft.contigs)},
                 seq1=r1.seq, len1=r1.length, qual1=r1.qual, seq2=r2.seq,
                 len2=r2.length, qual2=r2.qual)
        (tmp / "worker.py").write_text(WORKER)
        with socket.socket() as sk:
            sk.bind(("127.0.0.1", 0))
            port = sk.getsockname()[1]
        procs = []
        t0 = time.time()
        for rank in range(2):
            env = dict(os.environ, FIGBIRD_ROOT=str(Path(__file__).parent),
                       FIGBIRD_COORD=f"127.0.0.1:{port}", FIGBIRD_NPROCS="2",
                       FIGBIRD_PROC=str(rank),
                       FIGBIRD_DATA=str(tmp / "data.npz"),
                       FIGBIRD_OUT=str(tmp / "out"))
            procs.append(subprocess.Popen(
                [sys.executable, str(tmp / "worker.py")], env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=timeout)[0])
        finally:
            for p in procs:
                p.kill()
                p.wait()
        for rank, (p, lg) in enumerate(zip(procs, logs)):
            assert p.returncode == 0, f"worker {rank}:\n{lg[-3000:]}"
        log(f"two processes: both done {time.time() - t0:.1f}s after the "
            f"start (process start, data load and the iteration)")
        launches = dict.fromkeys(ops.LAUNCHES, 0)
        for rank in range(2):
            z = np.load(tmp / f"out.{rank}.npz")
            mine = dict(zip(sorted(ops.LAUNCHES), map(int, z["launches"])))
            n = len(SINGLE["p"]["strings"])
            got = dict(n_after=int(z["n_after"]), gaptofill=z["gaptofill"],
                       strings=[z[f"s{i}"] for i in range(n)],
                       contigs=[z[f"c{i}"]
                                for i in range(len(sim.draft.contigs))])
            assert_runs_equal(got, SINGLE["p"], f"process {rank}")
            missing = [k for k, n in mine.items() if n == 0]
            assert not missing, f"process {rank} did not launch {missing}"
            for k, n in mine.items():
                launches[k] += n
            log(f"two processes: process {rank} held {int(z['n_pairs'])} "
                f"pairs, p-iteration wall {float(z['wall']):.2f}s, N "
                f"{int(z['n_before'])} -> {int(z['n_after'])}, gap strings, "
                f"gaptofill and contigs equal to the single process's; "
                f"launches {mine}")
    return launches


# ---------------------------------------------------------------- phase 9
# tests/test_golden.py's simulation; tests/test_golden_unmapped.py's insert
GOLDEN_SIM = dict(genome_len=60_000, n_contigs=2, n_gaps=6,
                  gap_len_range=(8, 60), read_len=101, insert_mean=300,
                  insert_sd=25, coverage=15.0, error_rate=0.003, seed=7)
GOLDEN_U_SIM = dict(GOLDEN_SIM, insert_mean=600, insert_sd=40)
ROUND_TRIP = ("aligned", "strand", "pos", "clip_start", "clip_end", "unique")


def sam_round_trip(sim, idx, params, max_d, path, what, check=True):
    """Align both mates on the card, write the SAM with the pair table's
    fields, read it back.  ``check``: the records read back carry the
    aligner's aligned flags everywhere and its placement on the aligned rows
    (tests/test_sam.py's round trip).  Returns the aligner's dicts, what was
    read back, and the write and read seconds."""
    from figbird_tpu_torch.align import Aligner, build_pair_table
    from figbird_tpu_torch.io import read_sam_pairs, write_sam

    r1, r2 = sim.reads1, sim.reads2
    a1, a2 = Aligner(idx, params, device=DEV).align_many(
        [(r1.seq, r1.length), (r2.seq, r2.length)])
    pt = build_pair_table(idx, a1, a2, r1.length, r2.length, max_d)
    t0 = time.time()
    n = write_sam(path, idx, sim.draft.names, r1, r2, a1, a2, pt=pt)
    t_write = time.time() - t0
    t0 = time.time()
    back = read_sam_pairs(path, idx, sim.draft.names)
    t_read = time.time() - t0
    same = {}
    for a, b in ((a1, back[2]), (a2, back[3])):
        m = a["aligned"]
        same["aligned"] = same.get("aligned", 0) + int(
            (a["aligned"] == b["aligned"]).sum())
        for k in ROUND_TRIP[1:]:
            same[k] = same.get(k, 0) + int((a[k][m] == b[k][m]).sum())
    n_al = int(a1["aligned"].sum() + a2["aligned"].sum())
    log(f"sam {what}: {n} records ({Path(path).stat().st_size / 1e6:.1f} MB) "
        f"written in {t_write:.2f}s, read back in {t_read:.2f}s; fields "
        f"equal to the aligner's on its {n_al} aligned records {same} "
        f"(aligned: of all {2 * len(r1)})")
    if check:
        assert same["aligned"] == 2 * len(r1), f"{what}: aligned flags differ"
        bad = [k for k in ROUND_TRIP[1:] if same[k] != n_al]
        assert not bad, f"{what}: fields read back differ: {bad}"
    return (a1, a2), back, t_write, t_read


def sam_bundles(idx, draft, back, insert, partial_len=101, e2e=None):
    """tests/test_golden.py's post-alignment stages from what a SAM read
    back: pair table, host model (``_learn_model`` without an aligner) and
    partial triage.  ``e2e`` (the unmapped flow): the end-to-end SAM's read
    back, whose pairs give the model and the unmapped mates (merged into
    the partial bundles).  Returns the gaps, bundles and model."""
    from figbird_tpu_torch.align import build_pair_table
    from figbird_tpu_torch.pipeline import _learn_model
    from figbird_tpu_torch.triage import Triage

    r1, r2, a1, a2 = back
    pt = build_pair_table(idx, a1, a2, r1.length, r2.length, insert)
    gaps = draft.find_gaps()
    tri = Triage(gaps, max_distance=insert, read_mean=insert, is_jump=False)
    tri.collect_partial(pt, r1, r2)
    if e2e is None:
        model, _ = _learn_model(idx, pt, a1, a2, r1, r2, draft.lengths,
                                partial_flag=True, partial_len=partial_len)
        return gaps, tri.bundles, model
    maxd2 = int(insert * config.INSERT_FRAC)
    er1, er2, ea1, ea2 = e2e
    ept = build_pair_table(idx, ea1, ea2, er1.length, er2.length, maxd2)
    model, _ = _learn_model(idx, ept, ea1, ea2, er1, er2, draft.lengths,
                            partial_flag=False, partial_len=partial_len)
    tri2 = Triage(gaps, max_distance=maxd2,
                  read_mean=float(model.insert_mean), is_jump=True)
    tri2.collect_unmapped(ept, er1, er2)
    for bu, bp in zip(tri2.bundles, tri.bundles):
        bp.u_seq, bp.u_pos, bp.u_rev = bu.u_seq, bu.u_pos, bu.u_rev
    return gaps, tri.bundles, model


def fill_on(device, draft, gaps, bundles, model, what, **kw):
    """``fill_gaps`` on ``device`` with the launch counts set to 0 just
    before and read just after.  Returns the result, the spliced draft, the
    launches, the launches by shape and the run's record for
    ``assert_runs_equal``."""
    from figbird_tpu_torch.fill import fill_gaps

    if device != "cpu":
        torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.time()
    res = fill_gaps(draft, gaps, bundles, model, device=device, **kw)
    if device != "cpu":
        torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(ops.LAUNCHES)
    by_shape = dict(sorted(ops.LAUNCHES_BY_SHAPE.items()))
    out = draft.splice_gaps(gaps, res.gap_strings, list(res.gaptofill))
    log(f"{what} on {device}: fill {wall:.2f}s, N {draft.count_n()} -> "
        f"{out.count_n()}, stats {res.stats}, launches {launches}")
    record = dict(n_after=out.count_n(), strings=res.gap_strings,
                  gaptofill=np.asarray(res.gaptofill), contigs=out.contigs)
    return res, out, launches, by_shape, record


def check_filled(sim, gaps, res, out, what, min_acc=0.95):
    from figbird_tpu_torch import evalx

    acc = evalx.fill_accuracy_vs_truth(sim.truth, gaps, res.gap_strings)
    log(f"{what}: N {sim.draft.count_n()} -> {out.count_n()}, filled-base "
        f"accuracy {acc.identity:.4f} ({acc.filled_bases}/"
        f"{acc.total_gap_bases} bases filled, {acc.closed}/{acc.n_gaps} "
        f"gaps closed)")
    if min_acc is not None:
        assert out.count_n() < sim.draft.count_n(), f"{what}: N not reduced"
        assert acc.identity >= min_acc, f"{what}: accuracy {acc.identity:.4f}"


FILL_K = ("cascade", "band_soft", "band_hard", "fold")


def phase_sam(bench):
    """The SAM-injected fills (module docstring, phase 9)."""
    from figbird_tpu_torch.align import AlignParams, build_index
    from figbird_tpu_torch.align.core import e2e_params

    tmp = Path(tempfile.mkdtemp(prefix="figbird_sam_"))
    try:
        # (a) tests/test_golden.py's flow, the fill on the card and the CPU
        t0 = time.time()
        sim = simulate.simulate(simulate.SimConfig(**GOLDEN_SIM))
        idx = build_index(sim.draft, k=15)
        ops.reset_launches()
        _, back, _, _ = sam_round_trip(sim, idx, AlignParams(), 300,
                                       tmp / "injected.sam", "9a")
        assert ops.LAUNCHES["align_score"] > 0, "the aligner ran no K5"
        gaps, bundles, model = sam_bundles(idx, sim.draft, back, 300)
        kw = dict(partial_mode=True, partial_len=101, reference_exact=True)
        fills = {dev: fill_on(dev, sim.draft, gaps, bundles, model,
                              "sam 9a p fill", **kw) for dev in (DEV, "cpu")}
        assert_runs_equal(fills[DEV][4], fills["cpu"][4], "sam 9a")
        missing = [k for k in FILL_K if fills[DEV][2][k] == 0]
        assert not missing, f"sam 9a: not launched on the card: {missing}"
        check_filled(sim, gaps, *fills[DEV][:2], "sam 9a card", None)
        log(f"sam 9a: card and CPU fills equal ({len(gaps)} gap strings, "
            f"gaptofill, contigs); {time.time() - t0:.1f}s")

        # (b) tests/test_golden_unmapped.py's flow on the card
        t0 = time.time()
        sim = simulate.simulate(simulate.SimConfig(**GOLDEN_U_SIM))
        idx = build_index(sim.draft, k=15)
        _, back, _, _ = sam_round_trip(sim, idx, AlignParams(), 600,
                                       tmp / "result1.sam", "9b local")
        _, e2e, _, _ = sam_round_trip(sim, idx, e2e_params(AlignParams()),
                                      int(600 * config.INSERT_FRAC),
                                      tmp / "result2.sam", "9b end-to-end")
        gaps, bundles, model = sam_bundles(idx, sim.draft, back, 600,
                                           e2e=e2e)
        res, out, launches, _, _ = fill_on(
            DEV, sim.draft, gaps, bundles, model, "sam 9b u fill",
            partial_mode=False, partial_len=101, reference_exact=True)
        missing = [k for k in FILL_K if launches[k] == 0]
        assert not missing, f"sam 9b: not launched on the card: {missing}"
        check_filled(sim, gaps, res, out, "sam 9b card")
        log(f"sam 9b: {sum(b.n_unmapped for b in bundles)} unmapped mates; "
            f"{time.time() - t0:.1f}s")

        # (c) bench.py's dataset through a SAM, against the in-memory path
        t0 = time.time()
        idx = build_index(bench.draft, k=15)
        (a1, a2), back, t_w, t_r = sam_round_trip(
            bench, idx, AlignParams(), 200, tmp / "bench.sam", "9c",
            check=False)
        (tmp / "bench.sam").unlink()
        kw = dict(partial_mode=True, partial_len=101, reference_exact=True)
        gaps, bundles, model = sam_bundles(idx, bench.draft, back, 200)
        res, out, _, _, _ = fill_on(DEV, bench.draft, gaps, bundles, model,
                                    "sam 9c p fill", **kw)
        check_filled(bench, gaps, res, out, "sam 9c card")
        mem = (bench.reads1, bench.reads2, a1, a2)
        gaps_m, bundles_m, model_m = sam_bundles(idx, bench.draft, mem, 200)
        res_m = fill_on(DEV, bench.draft, gaps_m, bundles_m, model_m,
                        "sam 9c in-memory p fill", **kw)[0]
        n_eq = sum(np.array_equal(a, b) for a, b in
                   zip(res.gap_strings, res_m.gap_strings))
        log(f"sam 9c: write_sam {t_w:.2f}s, read_sam_pairs {t_r:.2f}s; gap "
            f"strings equal to the in-memory path's {n_eq}/{len(gaps)}; "
            f"{time.time() - t0:.1f}s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------- phase 10
# one library with a gap-length tail: every gap drawn from simulate's
# lognormal (median 150, capped at 1,500), so several pass GAPTHRESH; 80x,
# so a large gap's one-anchored free mates pass 128
LARGE_SIM = dict(genome_len=1_000_000, n_contigs=4, n_gaps=40,
                 gap_len_range=(10, 120), gap_len_tail=1.0,
                 gap_len_tail_max=1500, read_len=101, insert_mean=600,
                 insert_sd=50, coverage=80.0, error_rate=0.005, seed=5)


def split_accuracy(sim, history):
    """Filled-base accuracy of the combined gaps (the iterations' strings
    mapped back to the draft's gaps) past GAPTHRESH and of the rest:
    (identity, filled bases, gap bases, gaps)."""
    from figbird_tpu_torch import evalx
    from figbird_tpu_torch.combine import combine_gap_history
    from figbird_tpu_torch.fill.driver import GAPTHRESH

    gaps = sim.draft.find_gaps()
    strings = [cg.seq for cg in combine_gap_history(history)]
    out = {}
    for what, keep in (("large", lambda g: g.length > GAPTHRESH),
                       ("rest", lambda g: g.length <= GAPTHRESH)):
        sel = [i for i, g in enumerate(gaps) if keep(g)]
        acc = evalx.fill_accuracy_vs_truth(
            sim.truth, [gaps[i] for i in sel], [strings[i] for i in sel])
        out[what] = (round(acc.identity, 4), acc.filled_bases,
                     acc.total_gap_bases, len(sel))
    return out


def phase_large_gap():
    """The large-gap EM and the 1,024-read bucket in a pipeline run
    (module docstring, phase 10).  Returns the u-iteration's launches by
    (kernel, reads, positions)."""
    from figbird_tpu_torch import pipeline
    from figbird_tpu_torch.fill import driver

    t_all = time.time()
    sim = simulate.simulate(simulate.SimConfig(**LARGE_SIM))
    gaps0 = sim.draft.find_gaps()
    log(f"large-gap dataset: {sim.truth.total_length()} bp, "
        f"{2 * len(sim.reads1)} reads, {len(gaps0)} gaps, "
        f"{sum(g.length > driver.GAPTHRESH for g in gaps0)} past "
        f"GAPTHRESH (lengths {sorted(g.length for g in gaps0)[-8:]} ...)")
    pipe = Pipeline(_cfg(600, 101), sim.draft, [(sim.reads1, sim.reads2)],
                    device=DEV)
    out = {}
    for mode in ("p", "u"):
        with Captured(pipeline, "fill_gaps") as fills, \
                Captured(driver, "plan_gaps") as plans:
            torch.cuda.synchronize()
            ops.reset_launches()
            t0 = time.time()
            st = pipe.run_iteration(mode, 0)
            torch.cuda.synchronize()
            wall = time.time() - t0
        launches = dict(ops.LAUNCHES)
        by_shape = dict(sorted(ops.LAUNCHES_BY_SHAPE.items()))
        log(f"large-gap {mode}-iteration: wall {wall:.2f}s, N {st.n_before}"
            f" -> {st.n_after}, accuracy of the combined gaps by size "
            f"{split_accuracy(sim, pipe.result.gap_history)}, launches "
            f"{launches}; "
            f"by (kernel, reads, positions) {by_shape}")
        pipe.timer.report(sys.stdout)
        log(f"large-gap {mode} fill stats: {pipe.last_fill_stats}")
        out[mode] = (st, launches, by_shape, fills.calls[0], plans.calls[0])
    st, launches, by_shape, (f_args, f_kw, _), (_, _, u_plans) = out["u"]
    n_large = sum(p.large_gap for p in u_plans)
    at_1024 = {k: n for k, n in by_shape.items() if k[1] == 1024}
    at_3072 = {k: n for k, n in by_shape.items() if k[1] == 3072}
    log(f"large-gap u: {n_large} plans with the large-gap flag; launches at "
        f"1,024 reads {at_1024}; at 3,072 reads {at_3072 or 'none'}")
    missing = [k for k, n in launches.items() if n == 0]
    assert not missing, f"large-gap u: kernels not launched: {missing}"
    assert st.n_after < st.n_before, "large-gap u: N not reduced"
    assert n_large >= 4, f"large-gap u: {n_large} large-gap plans"
    assert any(k[0] == "cascade" for k in at_1024), \
        "large-gap u: no K1 launch at 1,024 reads"

    # the staged scan against the reference's 200-iteration EM, on the
    # u-iteration's own fill inputs (not asserted)
    genome, gaps, bundles, model = f_args
    kw = {k: v for k, v in f_kw.items() if k != "device"}
    t0 = time.time()
    res_x = fill_on(DEV, genome, gaps, bundles, model,
                    "large-gap u reference_exact",
                    **dict(kw, reference_exact=True))[0]
    n_eq = sum(np.array_equal(a, b) for a, b in
               zip(pipe.result.gap_history[-1][1], res_x.gap_strings))
    log(f"large-gap u: gap strings equal to reference_exact's on the same "
        f"inputs {n_eq}/{len(gaps)} ({time.time() - t0:.1f}s)")

    # (b) one large gap at 1,024 reads: the card against the CPU
    big = [i for i, p in enumerate(u_plans)
           if p.large_gap and p.bundle.n_unmapped > 128]
    assert big, "large-gap u: no large gap with more than 128 unmapped reads"
    gi = max(big, key=lambda i: u_plans[i].bundle.n_unmapped)
    one = ([gaps[gi]], [bundles[gi]])
    kw = dict(kw, max_scan_lengths=4)
    got, stats = {}, {}  # the stats without their timers ("t_*")
    for dev in (DEV, "cpu"):
        t0 = time.time()
        res, _, _, b_shape, got[dev] = fill_on(dev, genome, *one, model,
                                               f"large gap {gi}", **kw)
        stats[dev] = {k: v for k, v in res.stats.items()
                      if not k.startswith("t_")}
        log(f"large gap {gi} ({gaps[gi].length} bp, "
            f"{bundles[gi].n_unmapped} unmapped reads) on {dev}: "
            f"{time.time() - t0:.1f}s; launches by shape {b_shape}")
    assert_runs_equal(got[DEV], got["cpu"], f"large gap {gi}")
    assert stats[DEV] == stats["cpu"], f"large gap {gi}: fill stats differ"
    log(f"large gap {gi}: card and CPU equal (gap string, gaptofill, fill "
        f"stats); phase {time.time() - t_all:.1f}s")
    return by_shape


# ---------------------------------------------------------------- phase 11
# the chr14 phase's genome (Mb): scripts/chr14_scale_torch.py at full size
CHR14_MB = 88.0


def phase_chr14() -> dict:
    """scripts/chr14_scale_torch.py's flow on the card at ``CHR14_MB``
    (module docstring, phase 11); its record."""
    t0 = time.time()
    out = chr14.run(CHR14_MB, device=DEV)
    keep = ("genome_len", "n_reads", "n_gaps", "gaps_past_gapthresh",
            "wall_p_cold_s", "wall_p_warm_s", "wall_u_s", "accuracy_p",
            "accuracy_p_u", "samples", "n_after_minus_reference",
            "peak_device_bytes", "peak_host_rss_bytes")
    log(f"chr14 {CHR14_MB} Mb: {json.dumps({k: out[k] for k in keep})}")
    for mode in ("p", "u"):
        r = out[mode]
        stats = {k: v for k, v in r["fill_stats"].items()
                 if k != "bucket_shapes"}
        log(f"chr14 {mode}-iteration: N {r['n_before']} -> {r['n_after']}, "
            f"stages {r['stages']}, fill stats {stats}, launches "
            f"{r['launches']}, by shape {r['launches_by_shape']}")
    log(f"chr14 phase {time.time() - t0:.1f}s")
    return out


def by_shape_of(record: dict) -> dict:
    """A chr14 iteration's ``launches_by_shape`` keyed as
    ``ops.LAUNCHES_BY_SHAPE`` is: (kernel, reads, positions)."""
    out = {}
    for key, n in record["launches_by_shape"].items():
        name, reads, wp = key.split("/")
        out[name, int(reads), int(wp)] = n
    return out


# ---------------------------------------------------------------- phase 12
def phase_tiers(sim) -> None:
    """(a) ``exact_soft="auto"`` and ``"hybrid"`` on bench.py's dataset on
    the card: all five kernels launched, N reduced, accuracy >= 0.95, and
    the number of gap strings equal to the default's (phase 4) printed;
    ``"auto"``'s escalated lanes printed."""
    all5 = tuple(ops.LAUNCHES)
    for tier in ("auto", "hybrid"):
        _, wall, strings, stats = run_main(sim, f"exact_soft={tier!r}",
                                           {"exact_soft": tier}, all5)
        n_eq = sum(np.array_equal(a, b)
                   for a, b in zip(strings, SINGLE["p"]["strings"]))
        esc = {k: v for k, v in stats.items() if k.startswith("esc_")}
        log(f"phase 12a exact_soft={tier!r}: wall {wall:.2f}s, gap strings "
            f"equal to the default's {n_eq}/{len(strings)}"
            + (f", lanes escalated to the exact cascade {esc}"
               if tier == "auto" else ""))


ITR_N = re.compile(r"^# itr (\d+) \[([pu]) lib(\d+)\]: \d+ gaps, \d+ "
                   r"filled, N (\d+)->(\d+) \([\d.]+s\)$", re.M)


def cli_run(args) -> tuple:
    """``figbird_tpu_torch.__main__.main(args)`` on the card in this process,
    the launch counts set to 0 just before and read just after.  Returns
    the exit code, what it wrote to stderr, the wall and the launches."""
    from figbird_tpu_torch import __main__ as cli

    tee = _Tee(sys.stderr)
    with contextlib.redirect_stderr(tee):
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.time()
        rc = cli.main([str(a) for a in args])
        torch.cuda.synchronize()
        wall = time.time() - t0
    return rc, "".join(tee.parts), wall, dict(ops.LAUNCHES)


# phase 6's libraries (0: frag, 1: jump) under ``default: 0``, their serial
# numbers reversed, and the schedule Pipeline.run gives them, written out:
# serial 1 (the jump library: u once, no p), then serial 2 (frag: p, u)
USER_LIBS = ({"serial_num": 2, "order": ["p", "u"], "num_itr_partial": 1,
              "num_itr_unmapped": 1},
             {"serial_num": 1, "order": ["u", "p"], "num_itr_partial": 0,
              "num_itr_unmapped": 1})
USER_SCHEDULE = [("u", 1), ("p", 0), ("u", 0)]


def phase_user_schedule(sim, state: dict) -> None:
    """(b) Phase 6's dataset under ``default: 0`` (``USER_LIBS``) through the
    CLI on the card: the ``# itr`` lines are ``USER_SCHEDULE``, the output
    tree is complete and N goes down."""
    from figbird_tpu_torch.genome import Genome
    from figbird_tpu_torch.io.fasta import read_fasta

    src = json.loads(Path(state["cfg"]).read_text())
    out = Path(state["cfg"]).parent / "user"
    out.mkdir()
    src["Directory"]["Output_Folder"] = str(out)
    src["Parameters"]["default"] = 0
    for lib, extra in zip(src["Read_Pairs"], USER_LIBS):
        lib.update(extra)
    cfg = out / "Config.json"
    cfg.write_text(json.dumps(src, indent=1))
    rc, err, wall, launches = cli_run([cfg])
    assert rc == 0, f"the CLI exited with {rc}"
    ran = [(m[2], int(m[3])) for m in ITR_N.finditer(err)]
    wd = out / "Figbird"
    tree = {str(p.relative_to(wd)) for p in wd.rglob("*") if p.is_file()}
    draft = Genome.from_fasta(read_fasta(src["Directory"]["Draft_Genome"]))
    final = Genome.from_fasta(read_fasta(wd / "FilledScaffolds_final.fa"))
    log(f"phase 12b default: 0: wall {wall:.2f}s, iterations {ran} "
        f"(expected {USER_SCHEDULE}), N {draft.count_n()} -> "
        f"{final.count_n()}, {len(tree)} files, launches {launches}")
    assert ran == USER_SCHEDULE, ran
    missing = expected_tree(len(ran)) - tree
    assert not missing, f"output tree lacks {sorted(missing)}"
    assert final.count_n() < draft.count_n(), "N not reduced"


def phase_resume(state: dict) -> None:
    """(c) ``--resume --max-iterations 1`` on phase 6's output: the resume
    line names phase 6's last filled assembly, the resumed iteration starts
    from phase 6's final N, and the tree is written."""
    wd = Path(state["wd"])
    last = wd / "Filled_Scaffolds" / f"{state['n_itr']}filledContigs.fa"
    rc, err, wall, launches = cli_run([state["cfg"], "--resume",
                                       "--max-iterations", "1"])
    assert rc == 0, f"the CLI exited with {rc}"
    m = re.search(r"^# resuming from iteration (\d+): (.+)$", err, re.M)
    itr = [m_[0] for m_ in ITR_N.finditer(err)]
    log(f"phase 12c --resume: wall {wall:.2f}s, "
        f"{m[0] if m else 'no resume line'}; {itr}; launches {launches}")
    assert m and int(m[1]) == state["n_itr"] and Path(m[2]) == last, m
    first = next(ITR_N.finditer(err))
    assert len(itr) == 1 and int(first[4]) == state["n_final"], \
        (itr, state["n_final"])
    tree = {str(p.relative_to(wd)) for p in wd.rglob("*") if p.is_file()}
    missing = expected_tree(state["n_itr"]) - tree
    assert not missing, f"output tree lacks {sorted(missing)}"
    assert (wd / "FilledScaffolds_final.fa").read_bytes() == (
        wd / "Filled_Scaffolds" / "1filledContigs.fa").read_bytes(), \
        "the final assembly differs from the resumed iteration's"


# (d) the 3,072-read bucket: a 100 kb genome, 3 gaps of 500-1,500 bp,
# insert 600, about 1,000x: a large gap's one-anchored free mates grow with
# the depth, not with the gap's length
BUCKET_SIM = dict(genome_len=100_000, n_contigs=2, n_gaps=3,
                  gap_len_range=(500, 1500), read_len=101, insert_mean=600,
                  insert_sd=50, coverage=1000.0, error_rate=0.005, seed=7)
# the one gap's scan cap on both sides: the CPU's plain versions at 3,072
# reads cost about three times the 1,024 bucket's
BUCKET_SCAN = 2


def phase_bucket_3072() -> tuple:
    """(d) ``BUCKET_SIM``'s p- then u-iteration on the card, the launch
    counts set to 0 just before each and read just after: K1-K4 launched at
    3,072 reads, N reduced in each, accuracy of the combined gaps >= 0.95.
    One gap at 3,072 reads alone through ``fill_gaps`` on the card, and on
    the CPU in a CpuJob (compared in ``bucket_compare``).  Returns the
    launches by kernel and by shape of both iterations, and the job with
    the card's result."""
    from figbird_tpu_torch import pipeline
    from figbird_tpu_torch.combine import combine_gap_history
    from figbird_tpu_torch.fill import driver

    t_all = time.time()
    sim = simulate.simulate(simulate.SimConfig(**BUCKET_SIM))
    gaps0 = sim.draft.find_gaps()
    log(f"phase 12d dataset: {sim.truth.total_length()} bp, "
        f"{2 * len(sim.reads1)} reads, gaps {[g.length for g in gaps0]} "
        f"(simulated in {time.time() - t_all:.1f}s)")
    pipe = Pipeline(_cfg(600, 101), sim.draft, [(sim.reads1, sim.reads2)],
                    device=DEV)
    by_shape, runs = {}, {}
    for mode in ("p", "u"):
        with Captured(pipeline, "fill_gaps") as fills, \
                Captured(driver, "plan_gaps") as plans:
            torch.cuda.synchronize()
            ops.reset_launches()
            t0 = time.time()
            st = pipe.run_iteration(mode, 0)
            torch.cuda.synchronize()
            wall = time.time() - t0
        shape = dict(sorted(ops.LAUNCHES_BY_SHAPE.items()))
        by_shape[mode] = (dict(ops.LAUNCHES), shape)
        runs[mode] = (fills.calls[0], plans.calls[0][2])
        log(f"phase 12d {mode}-iteration: wall {wall:.2f}s, N {st.n_before}"
            f" -> {st.n_after}, launches {dict(ops.LAUNCHES)}, by (kernel, "
            f"reads, positions) {shape}; fill stats {pipe.last_fill_stats}")
        assert st.n_after < st.n_before, f"phase 12d {mode}: N not reduced"
    at_3072 = {k for _, m in by_shape.values() for k in m if k[1] == 3072}
    missing = [k for k in FILL_K if not any(x[0] == k for x in at_3072)]
    acc = chr14.fill_accuracy(sim, gaps0, [
        cg.seq for cg in combine_gap_history(pipe.result.gap_history)])
    log(f"phase 12d: kernels at 3,072 reads {sorted(at_3072)}; accuracy of "
        f"the combined gaps {acc}")
    assert not missing, f"phase 12d: not launched at 3,072 reads: {missing}"
    assert acc["identity"] >= 0.95, f"phase 12d: accuracy {acc}"

    # one gap at 3,072 reads: the u-iteration's own fill inputs
    (f_args, f_kw, _), u_plans = runs["u"]
    genome, gaps, bundles, model = f_args
    big = [i for i, p in enumerate(u_plans)
           if not p.skip and p.bundle.n_unmapped > 1024]
    assert big, "phase 12d: no gap with more than 1,024 unmapped reads"
    # the bucket pads every gap's reads to 3,072: the shortest gap has the
    # narrowest window, the cheapest for the CPU side
    gi = min(big, key=lambda i: (gaps[i].length, i))
    kw = {k: v for k, v in f_kw.items() if k != "device"}
    kw["max_scan_lengths"] = BUCKET_SCAN
    one = (genome, [gaps[gi]], [bundles[gi]], model)
    job = chr14.CpuJob(chr14.cpu_fill, *one, kw)
    res, _, _, b_shape, rec = fill_on(DEV, *one, f"phase 12d gap {gi}", **kw)
    stats = {k: v for k, v in res.stats.items() if not k.startswith("t_")}
    log(f"phase 12d gap {gi} ({gaps[gi].length} bp, "
        f"{bundles[gi].n_unmapped} unmapped reads, scan cap {BUCKET_SCAN}) on"
        f" the card: launches by shape {b_shape}; phase "
        f"{time.time() - t_all:.1f}s (its CPU side runs beside)")
    assert any(k[1] == 3072 for k in b_shape), b_shape
    return by_shape, (job, gi, rec, stats)


def bucket_compare(pending) -> None:
    """Phase 12d's one gap: the card's result against the CpuJob's."""
    job, gi, rec, stats = pending
    cpu_rec, cpu_stats = job.result()
    assert_runs_equal(rec, cpu_rec, f"phase 12d gap {gi}")
    assert stats == cpu_stats, f"phase 12d gap {gi}: fill stats differ"
    log(f"phase 12d gap {gi}: card and CPU equal (gap string, gaptofill, "
        f"fill stats)")


def phase_flat_budget(sim) -> None:
    """(e) The contig-range path past the replicated budget: a (reads 1,
    genome 2) mesh of ``cuda:0`` repeated, ``align.core.HOST_FLAT_BUDGET``
    below bench.py's genome length: the aligner keeps no replicated flat
    (``supports_device_stats`` False), the model is learned on the host,
    all five kernels launch, and the p-iteration's gap strings, gaptofill
    and contigs equal phase 4's single-device iteration."""
    from figbird_tpu_torch import pipeline
    from figbird_tpu_torch.align import core
    from figbird_tpu_torch.parallel import make_mesh

    mesh = make_mesh(2, 2, devices=mesh_devices(2))
    old = core.HOST_FLAT_BUDGET
    core.HOST_FLAT_BUDGET = sim.draft.total_length() - 1
    try:
        pipe = Pipeline(_cfg(200, 101), sim.draft,
                        [(sim.reads1, sim.reads2)], mesh=mesh,
                        aligner_kwargs={"genome_shard": "contig"})
        with Captured(pipeline, "Aligner") as als, \
                Captured(pipeline, "_learn_model_host") as host:
            torch.cuda.synchronize()
            ops.reset_launches()
            t0 = time.time()
            st = pipe.run_iteration("p", 0)
            torch.cuda.synchronize()
            wall = time.time() - t0
    finally:
        core.HOST_FLAT_BUDGET = old
    launches = dict(ops.LAUNCHES)
    al = als.calls[0][2]
    log(f"phase 12e contig-range past the budget on {mesh.shape}: wall "
        f"{wall:.2f}s, N {st.n_before} -> {st.n_after}, contig-sharded "
        f"{al._contig_sharded}, supports_device_stats "
        f"{al.supports_device_stats}, host model learning calls "
        f"{len(host.calls)}, launches {launches}")
    assert al._contig_sharded and al.supports_device_stats is False
    assert host.calls, "the model was not learned on the host"
    missing = [k for k, n in launches.items() if n == 0]
    assert not missing, f"phase 12e: kernels not launched: {missing}"
    assert_runs_equal(run_record(pipe, st), SINGLE["p"],
                      "contig-range past the budget")
    log("phase 12e: gap strings, gaptofill and contigs equal to phase 4's")


# ---------------------------------------------------------------- phase 13
# the full-human phase: scripts/full_human_torch.py at 2.2 Gb and FH_COVERAGE
FH_GB, FH_COVERAGE = 2.2, 1.0


def phase_full_human() -> dict:
    """scripts/full_human_torch.py's flow on the card at ``FH_GB`` and
    ``FH_COVERAGE`` (module docstring, phase 13; its assertions are the
    script's); its record."""
    t0 = time.time()
    out = full_human.run(FH_GB, FH_COVERAGE, device=DEV)
    keep = ("genome_len", "flat", "n_reads", "n_gaps", "gaps_past",
            "accuracy_p", "accuracy_p_u", "truth_share", "part2", "samples",
            "simulate", "peak_host_rss_bytes")
    log(f"full human {FH_GB} Gb at {FH_COVERAGE}x: "
        f"{json.dumps({k: out[k] for k in keep})}")
    for mode in ("p", "u"):
        r = out[mode]
        log(f"full human {mode}-iteration: wall {r['wall_s']}s, N "
            f"{r['n_before']} -> {r['n_after']}, stages {r['stages']}, peak "
            f"device {r['peak_device_bytes']} B, peak host RSS "
            f"{r['peak_host_rss_bytes']} B, launches {r['launches']}, K5 by "
            f"shard {r['k5_by_shard']}, by shape {r['launches_by_shape']}")
    log(f"full human phase {time.time() - t0:.1f}s")
    return out


def launches_at(record: dict, name: str, key=None) -> dict:
    """A p- and u-iteration's launches of kernel ``name`` for the kernels
    line: ``record`` maps mode to (launches by kernel, launches by (kernel,
    reads, positions)); ``key`` (reads, positions) picks one shape."""
    return {mode: (by_k[name] if key is None else by_s.get((name,) + key, 0))
            for mode, (by_k, by_s) in record.items()}


def main():
    if sys.argv[1:2] == ["--cpu-job"]:
        chr14.cpu_job_main(sys.argv[2:], globals())
        return
    t_all = time.time()
    # phase 3's CPU side runs beside the card phases from the start
    parity_job = chr14.CpuJob(parity_side, "cpu",
                        threads=max(1, (os.cpu_count() or 2) - 2))
    sched_dir = Path(tempfile.mkdtemp(prefix="figbird_schedule_"))
    pending = None
    try:
        card = phase_device()
        rows = phase_kernels()
        u_rows = phase_kernels_unmapped()
        parity_card = parity_side(DEV)
        profile_run = "--profile" in sys.argv[1:]
        sim = bench_sim()
        launches = phase_main(sim, profile_run)
        u_by_shape = phase_main_unmapped(sim, profile_run)
        sched, sched_state = phase_schedule(sim, sched_dir)
        t0 = time.time()
        k5_mesh_aligners = phase_mesh_aligners(sim)
        mesh = phase_mesh_iterations(sim)
        log(f"mesh phase {time.time() - t0:.1f}s")
        t0 = time.time()
        two = phase_two_processes(sim)
        log(f"two-process phase {time.time() - t0:.1f}s")
        t0 = time.time()
        phase_sam(sim)
        log(f"sam phase {time.time() - t0:.1f}s")
        t0 = time.time()
        large = phase_large_gap()
        log(f"large-gap phase {time.time() - t0:.1f}s")
        # 12d first: its one gap's CPU side runs beside phase 11
        t0 = time.time()
        bucket, pending = phase_bucket_3072()
        log(f"phase 12d {time.time() - t0:.1f}s (card side)")
        chr14_run = phase_chr14()
        t0 = time.time()
        phase_tiers(sim)
        log(f"phase 12a {time.time() - t0:.1f}s")
        t0 = time.time()
        phase_user_schedule(sim, sched_state)
        log(f"phase 12b {time.time() - t0:.1f}s")
        t0 = time.time()
        phase_resume(sched_state)
        log(f"phase 12c {time.time() - t0:.1f}s")
        t0 = time.time()
        phase_flat_budget(sim)
        log(f"phase 12e {time.time() - t0:.1f}s")
        config5 = phase_full_human()
        t0 = time.time()
        parity_compare(parity_card, parity_job.result())
        bucket_compare(pending)
        log(f"waited {time.time() - t0:.1f}s for the CPU jobs")
    finally:
        parity_job.stop()
        if pending is not None:
            pending[0].stop()
        shutil.rmtree(sched_dir, ignore_errors=True)
    chr14_rec = {m: (chr14_run[m]["launches"], by_shape_of(chr14_run[m]))
                 for m in ("p", "u")}
    config5_rec = {m: (config5[m]["launches"], by_shape_of(config5[m]))
                   for m in ("p", "u")}
    for r in rows:
        r["launches"] = launches[r["name"]]
        r["schedule_launches"] = sched[r["name"]]
        r["mesh_launches"] = mesh["p"][r["name"]]
        r["two_process_launches"] = two[r["name"]]
        r["chr14_launches"] = launches_at(chr14_rec, r["name"])
        r["bucket_3072_launches"] = launches_at(bucket, r["name"])
        r["config5_launches"] = launches_at(config5_rec, r["name"])
        if r["name"] == "align_score":
            r["mesh_aligner_launches"] = k5_mesh_aligners
            r["config5_launches_by_shard"] = {
                m: config5[m]["k5_by_shard"] for m in ("p", "u")}
    for r in u_rows:
        name, (reads, wp) = r["name"], r["key"]
        r["large_gap_launches"] = large.get((name, reads, wp), 0)
        r["chr14_launches"] = launches_at(chr14_rec, name, (reads, wp))
        r["bucket_3072_launches"] = launches_at(bucket, name, (reads, wp))
        r["config5_launches"] = launches_at(config5_rec, name, (reads, wp))
        if reads > 128:
            r["large_gap_launches_by_positions"] = {
                str(k[2]): n for k, n in large.items()
                if k[:2] == (name, reads)}
            r["bucket_3072_launches_by_positions"] = {
                mode: {str(k[2]): n for k, n in by_s.items()
                       if k[:2] == (name, reads)}
                for mode, (_, by_s) in bucket.items()}
    rows += u_rows_with_launches(u_rows, u_by_shape, mesh["u"])
    log(f"total {time.time() - t_all:.1f}s")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
