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
   least time the card could take for the same work (``bound_ms``).
3. parity  — the port's p-iteration on CUDA vs the same on the CPU (plain
   versions) on the 120 kb simulation of tests/test_pipeline.py, at the
   production default and at exact_soft=False: aligner outputs must be
   equal; equal gap strings are reported for each configuration.
4. main path — bench.py's E. coli-scale dataset (4.6 Mb, 50 gaps, 2x101 bp,
   insert 200, 10x) through Pipeline.run_iteration("p", 0) on the card, at
   the production default (default fill_kwargs: all five kernels launched)
   and at exact_soft=False (the four kernels of that path launched), each
   with the launch counts set to 0 just before and read just after: N
   reduced, filled-base accuracy vs the truth >= 0.95; wall time, reads/s
   and the stage split; then each once more, warm, for the wall ratio.
   ``--profile`` adds one default iteration under torch.profiler and prints
   the device's busy share.

Before the last line come the kernels JSON and the card's ``nvidia-smi``
name/power-limit line; the last line is the device JSON.
"""

import json
import subprocess
import sys
import time

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
# that K4 sees at exact_soft=False; the aligner's extend step (genome, reads,
# candidates); the unmapped mode's 512-read bucket (reads, gap bucket)
SCAN_SHAPE = (495, 128, 101, 128)
FINALIZE_BATCH = 64
PARTIAL_BATCHES = (128, 256)
ALIGN_SHAPE = (4_600_000, 32768, 32)
FULL_WIDTH = (512, 512)


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
    outs = {}
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

    # K5: reads x candidates at read length L on the bench genome's size
    G, B, C = ALIGN_SHAPE
    flat = torch.randint(0, 4, (G + 512,), generator=g, device=DEV,
                         dtype=torch.int8)
    flat[torch.randint(0, G, (G // 230,), generator=g, device=DEV)] = 4
    starts = torch.randint(0, G - L - 1, (B,), generator=g, device=DEV)
    reads = flat[starts[:, None] + j].clone()
    reads[rand(B, L) < 0.02] = 1
    reads[::7, 90:] = 4
    cand = torch.randint(0, G - L - 1, (B, C), generator=g, device=DEV,
                         dtype=torch.int32)
    cand[:, 0] = starts.to(torch.int32)

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
        # a compare, a score add and a running-minimum update per base
        ("align_score", "figbird_tpu_torch/csrc/align_score.cu",
         "figbird_tpu/ops/align_score.py:40", 0.0, 0.0,
         lambda: torch.stack(list(align_score.score_candidates(
             flat, reads, cand, 2, -6, dtypes.GAP_CODE).values())),
         lambda: torch.stack(list(align_score.score_candidates_plain(
             flat, reads, cand, 2, -6, dtypes.GAP_CODE).values())),
         None, nbytes(flat, reads, cand) + 5 * B * C * 4, 3 * B * C * L),
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
        if lib is not None:
            ms, plain_ms, library_ms = timed(kern, plain, lib)
        else:
            ms, plain_ms, library_ms = min(cuda_ms(kern), cuda_ms(kern)), \
                min(cuda_ms(plain), cuda_ms(plain)), None
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


# ---------------------------------------------------------------- phase 3
def _cfg(insert, read_len):
    return config.FigbirdConfig(
        draft_genome="", output_folder="",
        read_pairs=[config.ReadLibrary("", "", avg_insert_size=insert,
                                       max_read_length=read_len)],
        parameters=config.Parameters(trim_len=0, evaluation=0))


FILLS = (("default", {}), ("exact_soft=False", {"exact_soft": False}))


def phase_parity():
    sim = simulate.simulate(simulate.SimConfig(
        genome_len=120_000, n_contigs=1, n_gaps=8, gap_len_range=(8, 60),
        insert_mean=250, insert_sd=20, coverage=25, error_rate=0.004,
        seed=42))
    cfg = _cfg(250, 100)
    for what, fill_kwargs in FILLS:
        pipes = {}
        for dev in ("cuda", "cpu"):
            p = Pipeline(cfg, sim.draft, [(sim.reads1, sim.reads2)],
                         fill_kwargs=fill_kwargs, device=dev)
            t0 = time.time()
            st = p.run_iteration("p", 0)
            log(f"parity {what} {dev}: {time.time() - t0:.1f}s N "
                f"{st.n_before} -> {st.n_after}")
            pipes[dev] = p
        for a_gpu, a_cpu in zip(pipes["cuda"].last_alignments,
                                pipes["cpu"].last_alignments):
            for k in ALIGN_KEYS:
                np.testing.assert_array_equal(a_gpu[k], a_cpu[k], err_msg=k)
        s_gpu = pipes["cuda"].result.gap_history[0][1]
        s_cpu = pipes["cpu"].result.gap_history[0][1]
        n_eq = sum(np.array_equal(x, y) for x, y in zip(s_gpu, s_cpu))
        log(f"parity {what}: aligner outputs equal; gap strings equal "
            f"{n_eq}/{len(s_gpu)}")


# ---------------------------------------------------------------- phase 4
def filled_accuracy(sim, gap_history):
    total = correct = filled = 0
    for gaps_i, strings, _ in gap_history[:1]:
        for gp, s in zip(gaps_i, strings):
            tr = sim.truth.contigs[gp.contig][gp.start : gp.start + gp.length]
            if len(s) == gp.length:
                m = s != dtypes.N
                total += gp.length
                filled += int(m.sum())
                correct += int((s[m] == tr[m]).sum())
    return correct / max(filled, 1), filled, total


def run_main(sim, what, fill_kwargs, expect):
    """One p-iteration at full scale with the launch counts set to 0 just
    before and read just after; the kernels in ``expect`` must have been
    launched."""
    n_reads = 2 * len(sim.reads1)
    pipe = Pipeline(_cfg(200, 101), sim.draft, [(sim.reads1, sim.reads2)],
                    fill_kwargs=fill_kwargs, device=DEV)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.time()
    st = pipe.run_iteration("p", 0)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(ops.LAUNCHES)
    acc, filled, total = filled_accuracy(sim, pipe.result.gap_history)
    log(f"main path {what}: wall {wall:.2f}s, {n_reads / wall:.0f} reads/s, "
        f"N {st.n_before} -> {st.n_after}, filled-base accuracy {acc:.4f} "
        f"({filled}/{total} bases filled), launches {launches}")
    pipe.timer.report(sys.stdout)
    log(f"fill stats {what}: {pipe.last_fill_stats}")
    missing = [k for k in expect if launches[k] == 0]
    assert not missing, f"kernels not launched on the {what} path: {missing}"
    assert st.n_after < st.n_before, "N not reduced"
    assert acc >= 0.95, f"filled-base accuracy {acc:.4f} < 0.95"
    return launches, wall, pipe.result.gap_history[0][1]


def busy_share(sim, wall_plain):
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
        pipe.run_iteration("p", 0)
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
    log(f"profile default: wall {wall:.3f}s with the profiler on, device "
        f"busy {busy / 1e3:.1f} ms over {len(spans)} device events, busy "
        f"share {busy / 1e6 / wall:.3f} of that wall, "
        f"{busy / 1e6 / wall_plain:.3f} of the warm wall without the "
        f"profiler ({wall_plain:.3f}s)")
    ranked = sorted(by_name.items(), key=lambda x: -x[1][0])
    # the eight largest, then every hand-written kernel below them
    ours = ("band_core::kernel", "cascade_kernel", "fold_kernel",
            "score_candidates_kernel")
    for i, (name, (t, n)) in enumerate(ranked):
        if i < 8 or any(k in name for k in ours):
            log(f"profile default:   {t / 1e3:8.1f} ms {n:6d} x "
                f"{name[:90]}")


def phase_main(profile_run: bool):
    t0 = time.time()
    sim = simulate.simulate(simulate.SimConfig(
        genome_len=4_600_000, n_contigs=4, n_gaps=50, gap_len_range=(10, 120),
        read_len=101, insert_mean=200, insert_sd=20, coverage=10.0,
        error_rate=0.005, seed=1))
    log(f"main path dataset: {sim.truth.total_length()} bp, "
        f"{2 * len(sim.reads1)} reads, {len(sim.draft.find_gaps())} gaps "
        f"(simulated in {time.time() - t0:.1f}s)")
    all5 = tuple(ops.LAUNCHES)
    four = tuple(k for k in all5 if k != "cascade")
    launches, _, s_def = run_main(sim, "default", {}, all5)
    _, _, s_f32 = run_main(sim, "exact_soft=False", {"exact_soft": False},
                           four)
    n_diff = sum(not np.array_equal(a, b) for a, b in zip(s_def, s_f32))
    log(f"main path: {n_diff}/{len(s_def)} gap strings differ between the "
        f"default and exact_soft=False")
    # once more each, warm: the cost of the exact cascade end to end
    _, w_def, _ = run_main(sim, "default (warm)", {}, all5)
    _, w_f32, _ = run_main(sim, "exact_soft=False (warm)",
                           {"exact_soft": False}, four)
    log(f"main path warm walls: default {w_def:.3f}s, exact_soft=False "
        f"{w_f32:.3f}s, ratio {w_def / w_f32:.3f}")
    if profile_run:
        busy_share(sim, w_def)
    return launches


def main():
    t_all = time.time()
    card = phase_device()
    rows = phase_kernels()
    phase_parity()
    launches = phase_main("--profile" in sys.argv[1:])
    for r in rows:
        r["launches"] = launches[r["name"]]
    log(f"total {time.time() - t_all:.1f}s")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
