"""The partial EM's overlap bonus (``ops.overlap``) on the CPU: the plain
version on hand-built instances whose bonus and saved pair follow from the
definition, the wrapper's device rule, and the CUDA kernel's body
(``csrc/overlap.cu``) built with the host compiler and held bit for bit to
the plain version.  ``overlap_batch`` and ``threshold_batch`` make the
instances ``tests/test_torch_cuda.py`` holds the kernel to on the card.
Imports nothing of JAX."""

import shutil
import subprocess
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from figbird_tpu_torch import ops
from figbird_tpu_torch.ops import overlap

PAD = 4  # a padded read's codes and the template's gap zone (fill/driver.py)


def _empty(I, P, L, W):
    return dict(pr=np.full((I, P, L), PAD, np.int8),
                p_len=np.zeros((I, P), np.int32),
                p_match=np.ones((I, P), np.int32),
                p_valid=np.zeros((I, P), bool),
                accept=np.zeros((I, P), bool),
                pos_gap=np.zeros((I, P), np.int32),
                tmpl=np.full((I, W), 5, np.int8),
                gap_len=np.zeros(I, np.int32),
                side_limit=np.zeros(I, np.int32),
                perfect_gap=np.zeros(I, np.int32),
                orig_gap=np.full(I, 100, np.int32),
                perfect_gaplen=np.full(I, -1, np.int32))


def _split(a, WL, cap, device):
    """(cfg, inst, accept, pos_gap) as the EM holds them, on ``device``;
    cfg holds the fields of the EM's ``FillConfig`` that the bonus reads."""
    t = {k: torch.as_tensor(v, device=device) for k, v in a.items()}
    accept, pos_gap = t.pop("accept"), t.pop("pos_gap")
    cfg = SimpleNamespace(P=a["pr"].shape[1], WL=WL, W=a["tmpl"].shape[1],
                          bonus_cap=cap)
    return cfg, t, accept, pos_gap


def _place(a, i, r, truth, WL, pos, n, match, rng=None, err=0.0):
    """Read r of instance i: truth[WL + pos : WL + pos + n], each base
    changed with probability ``err``."""
    codes = truth[WL + pos: WL + pos + n].copy()
    if rng is not None and err > 0:
        hit = rng.random(n) < err
        codes[hit] = (codes[hit] + rng.integers(1, 4, hit.sum())) % 4
    a["pr"][i, r, :n] = codes
    a["p_len"][i, r] = n
    a["p_match"][i, r] = match
    a["p_valid"][i, r] = True
    a["accept"][i, r] = True
    a["pos_gap"][i, r] = pos


def overlap_batch(seed, I, P, L, cap, device="cpu", ties=False):
    """I instances of P read lanes, each a gap of 1 to 2L bases in a
    template drawn from a truth, with reads cut from that truth: left reads
    ending in the gap, right reads starting in it (match 2 or 3; some
    soft-clipped ones spanning it), spanning reads, reads with many
    errors, rejected reads, padded lanes with stray placements, side
    limits of 3, 4, 7, 8 and more, contig ends in the right flank and the
    perfect-gap flag.  ``ties``: placements from a few values, so keys tie
    in the candidate lists.  Returns (cfg, inst, accept, pos_gap)."""
    rng = np.random.default_rng(seed)
    maxg = 2 * L
    WL, W = L, 2 * L + maxg
    a = _empty(I, P, L, W)
    for i in range(I):
        gl = int(rng.integers(1, maxg + 1))
        truth = rng.integers(0, 4, W + 2 * L).astype(np.int8)
        t = truth[:W].copy()
        t[WL: WL + gl] = PAD
        if rng.random() < 0.3:  # the contig ends in the right flank
            t[WL + gl + int(rng.integers(0, L)):] = 5
        a["tmpl"][i] = t
        a["gap_len"][i] = gl
        a["side_limit"][i] = rng.choice([3, 4, 7, 8, L // 2, L, L + 5])
        a["perfect_gap"][i] = rng.integers(0, 2)
        a["orig_gap"][i] = rng.integers(5, 30)
        a["perfect_gaplen"][i] = gl + rng.integers(0, 2)
        n = int(rng.integers(1, P + 1))
        choices = {k: rng.integers(-L, maxg, 3)
                   for k in ("left", "right", "span", "clip")}
        for r in range(n):
            kind = rng.choice(["left", "right", "span", "clip"],
                              p=[0.4, 0.35, 0.1, 0.15])
            m = int(rng.integers(max(L // 2, 1), L + 1))
            if kind == "span" or kind == "clip":
                m = L
                if m <= gl + 1:
                    kind = "left"
            if kind == "left":
                lo, hi = -(m - 1), min(-1, gl - m)
                match = int(rng.choice([1, 4]))
            elif kind == "right":
                lo, hi = 1, gl
                match = int(rng.choice([2, 3]))
            else:
                lo, hi = -(m - gl - 1), -1
                match = int(rng.choice([2, 3])) if kind == "clip" \
                    else int(rng.integers(1, 5))
            if hi < lo:
                continue
            pos = int(rng.integers(lo, hi + 1))
            if ties:
                near = [c for c in choices[kind] if lo <= c <= hi]
                pos = int(near[0]) if near else pos
            err = 0.3 if rng.random() < 0.1 else 0.02
            _place(a, i, r, truth, WL, pos, m, match, rng, err)
            a["accept"][i, r] = rng.random() < 0.85
        # padded lanes: placements as an argmax over no legal position
        # leaves them, some marked accepted
        a["pos_gap"][i, n:] = rng.integers(-L, maxg, P - n)
        a["accept"][i, n:] = rng.random(P - n) < 0.2
    return _split(a, WL, cap, device)


def threshold_batch(device="cpu"):
    """A left and a right read an instance (L 101) that overlap by cmp_len
    10, 20, 30 and 70 with exactly 0.1 cmp_len mismatches (a verified
    overlap) and with one more (a false one).  The right read starts in
    the gap, or is soft-clipped: it spans the gap from 5 bases into the
    left flank (too few for a perfect read), and a third read, ending 3
    bases into the right flank (too few for its flank check), puts r_min
    inside the gap."""
    L, maxg = 101, 202
    WL, W = L, 2 * L + maxg
    rng = np.random.default_rng(5)
    cases = [(c, k, clip) for c in (10, 20, 30, 70)
             for k in (c // 10, c // 10 + 1) for clip in (False, True)]
    a = _empty(len(cases), 3, L, W)
    for i, (c, k, clip) in enumerate(cases):
        truth = rng.integers(0, 4, W + 2 * L).astype(np.int8)
        gl = 90 if not clip else c + 10
        t = truth[:W].copy()
        t[WL: WL + gl] = PAD
        a["tmpl"][i], a["gap_len"][i], a["side_limit"][i] = t, gl, 30
        if not clip:
            # the left read ends at gap coordinate 80, the right one starts
            # at 80 - c: c bases in common, inside the gap
            _place(a, i, 0, truth, WL, 80 - 100, 100, 1)
            _place(a, i, 1, truth, WL, 80 - c, 100, 2)
            j = (100 - c) + np.sort(rng.choice(c, k, replace=False))
            row = 0
        else:
            # the left read ends at gap coordinate c; the clipped read
            # holds gap coordinates [0, c) at its bases 5 to 5 + c
            _place(a, i, 0, truth, WL, c - 90, 90, 4)
            _place(a, i, 1, truth, WL, -5, 101, 3)
            _place(a, i, 2, truth, WL, c // 2, gl + 3 - c // 2, 2)
            j = 5 + np.sort(rng.choice(c, k, replace=False))
            row = 1
        a["pr"][i, row, j] = (a["pr"][i, row, j] + 1) % 4
    return _split(a, WL, 24, device)


def _plain(batch):
    return [x.cpu() for x in overlap.overlap_bonus_plain(*batch)]


def test_plain_version_gives_the_definition():
    """Hand-built instances: a verified overlap of 20 bases gives 30 x 20
    and saves its pair; 3 mismatches in it make it false (-100), as do 10
    in an overlap of 10; no reads give 0, and so does a read spanning the
    gap with a flank of 5 bases; with flanks of 10 and 8 bases it is a
    perfect read (300).  At the thresholds: 0.1 cmp_len mismatches verify,
    one more is false."""
    L, maxg = 101, 202
    WL, W = L, 2 * L + maxg
    rng = np.random.default_rng(1)
    a = _empty(5, 3, L, W)
    for i in range(5):
        truth = rng.integers(0, 4, W + 2 * L).astype(np.int8)
        gl = 90
        t = truth[:W].copy()
        t[WL: WL + gl] = PAD
        a["tmpl"][i], a["gap_len"][i], a["side_limit"][i] = t, gl, 30
        if i in (0, 1):
            _place(a, i, 1, truth, WL, -20, 100, 1)   # ends at 80
            _place(a, i, 2, truth, WL, 60, 100, 2)    # 20 in common
        if i == 1:
            a["pr"][i, 2, [3, 9, 15]] ^= 1
        if i == 2:
            _place(a, i, 0, truth, WL, -60, 100, 1)   # ends at 40
            _place(a, i, 2, truth, WL, 30, 100, 3)    # 10 in common,
            a["pr"][i, 2, :10] = (a["pr"][i, 2, :10] + 1) % 4  # all off
        if i == 4:
            _place(a, i, 0, truth, WL, -5, 101, 2)    # spans 90 + 6
    batch = _split(a, WL, 24, "cpu")
    bonus, sl, sr = _plain(batch)
    assert bonus.tolist() == [600.0, -100.0, -100.0, 0.0, 0.0]
    assert sl.tolist() == [1, -1, -1, -1, -1]
    assert sr.tolist() == [2, -1, -1, -1, -1]
    # the spanning read: flanks of 5 and 6 bases, under 8: not perfect;
    # with a longer read reaching 8 into the right flank it is
    a = _empty(1, 1, L, W)
    truth = rng.integers(0, 4, W + 2 * L).astype(np.int8)
    t = truth[:W].copy()
    t[WL: WL + 80] = PAD
    a["tmpl"][0], a["gap_len"][0], a["side_limit"][0] = t, 80, 30
    _place(a, 0, 0, truth, WL, -10, 98, 1)
    assert _plain(_split(a, WL, 24, "cpu"))[0].tolist() == [300.0]

    bonus, sl, sr = _plain(threshold_batch())
    c = np.repeat([10, 20, 30, 70], 4)
    verified = np.tile([True, True, False, False], 4)
    np.testing.assert_array_equal(bonus.numpy(),
                                  np.where(verified, 30.0 * c, -100.0))
    np.testing.assert_array_equal(sl.numpy(), np.where(verified, 0, -1))
    np.testing.assert_array_equal(sr.numpy(), np.where(verified, 1, -1))


def test_device_rule():
    """CPU tensors: the plain version, no launch counted.  Tensors on a
    device without a kernel raise; tensors on two devices raise before
    anything runs."""
    before = dict(ops.LAUNCHES)
    cfg, inst, accept, pos_gap = overlap_batch(7, 3, 16, 24, 4)
    got = overlap.overlap_bonus(cfg, inst, accept, pos_gap)
    want = overlap.overlap_bonus_plain(cfg, inst, accept, pos_gap)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert [x.dtype for x in got] == [torch.float32, torch.int32,
                                      torch.int32]
    assert dict(ops.LAUNCHES) == before
    meta = {k: v.to("meta") for k, v in inst.items()}
    with pytest.raises(RuntimeError, match="no kernel"):
        overlap.overlap_bonus(cfg, meta, accept.to("meta"),
                              pos_gap.to("meta"))
    with pytest.raises(ValueError, match="more than one device"):
        overlap.overlap_bonus(cfg, inst, accept.to("meta"), pos_gap)


def _dump(path, batch):
    cfg, inst, accept, pos_gap = batch
    I, P, L = inst["pr"].shape
    cap = min(cfg.bonus_cap, cfg.P)
    with open(path, "wb") as f:
        np.asarray([I, P, L, cfg.W, cfg.WL, cap], np.int32).tofile(f)
        for x, t in ((inst["pr"], np.int8), (inst["p_len"], np.int32),
                     (inst["p_match"], np.int32), (inst["p_valid"], np.uint8),
                     (accept, np.uint8), (pos_gap, np.int32),
                     (inst["tmpl"], np.int8)) + tuple(
                         (inst[k], np.int32) for k in overlap._SCALARS):
            x.cpu().numpy().astype(t).tofile(f)


def emulate(exe, tmp, batch):
    """The kernel body's outputs on ``batch``, run by the emulator."""
    I = batch[1]["pr"].shape[0]
    _dump(tmp / "in.bin", batch)
    subprocess.run([str(exe), str(tmp / "in.bin"), str(tmp / "out.bin")],
                   check=True, timeout=120)
    out = np.fromfile(tmp / "out.bin", np.int32)
    return [torch.from_numpy(out[:I].view(np.float32).copy()),
            torch.from_numpy(out[I: 2 * I].copy()),
            torch.from_numpy(out[2 * I:].copy())]


def build_emulator(out: Path) -> Path:
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a C++20 host compiler")
    here = Path(__file__).resolve().parent
    exe = out / "overlap_emu"
    subprocess.run(
        [cxx, "-std=c++20", "-O1", "-fno-strict-aliasing", "-pthread",
         "-Wno-unknown-pragmas", "-I", str(here / "count_core_emu"),
         "-I", str(here.parent / "figbird_tpu_torch" / "csrc"),
         str(here / "count_core_emu" / "overlap_emu.cpp"), "-o", str(exe)],
        check=True, capture_output=True, text=True, timeout=300)
    return exe


def test_overlap_kernel_emulated_on_the_cpu(tmp_path):
    """``csrc/overlap.cu``'s body built with the host compiler against a
    stand-in runtime header (one host thread per CUDA thread; ballots and
    barriers) and held bit for bit to the plain version: the thresholds'
    instances, random batches with and without ties in the keys, the
    capped lists (cap 4 and 24 < P) and read-order enumeration (cap = P)."""
    exe = build_emulator(tmp_path)
    batches = [threshold_batch(),
               overlap_batch(11, 4, 40, 24, 4, ties=True),
               overlap_batch(12, 4, 40, 24, 40),
               overlap_batch(13, 2, 128, 101, 24)]
    for b in batches:
        got, want = emulate(exe, tmp_path, b), _plain(b)
        for g, w in zip(got, want):
            assert torch.equal(g, w), (g, w)
