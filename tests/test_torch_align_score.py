"""The port's candidate scorer K5 (``ops.align_score``) against its
definition: the plain version on the CPU, and the CUDA kernel itself
emulated on the CPU.  Nothing here compiles a JAX program.

The definition, per (read, candidate) pair, with w the window
``flat[cand : cand + L]`` and r the read:

    s_j = 0 where r_j is the gap code, +match where w_j == r_j (w_j not the
    gap code), else +mismatch;  p = inclusive prefix sums, pre[j] = p[j-1],
    pre[0] = 0;  local = max_j (p[j] - min(pre[0..j])), end = the first j
    attaining it, start = the first i <= end with pre[i] = min(pre[0..end]),
    n_mis = the mismatches in [start, end], e2e = p[L-1].
"""

import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from figbird_tpu_torch.ops import align_score

torch.set_num_threads(2)
KEYS = ("local", "e2e", "start", "end", "n_mis")


def definition(flat, reads, cand, match, mismatch, gap):
    """The direct loop over every pair: dict of (B, C) int arrays."""
    B, L = reads.shape
    out = {k: np.zeros(cand.shape, np.int64) for k in KEYS}
    for b in range(B):
        r = reads[b].astype(np.int64)
        for c in range(cand.shape[1]):
            w = flat[cand[b, c] : cand[b, c] + L].astype(np.int64)
            rv = r != gap
            m = rv & (w == r) & (w != gap)
            p = np.cumsum(np.where(rv, np.where(m, match, mismatch), 0))
            pre = np.concatenate([[0], p])
            pmin = np.minimum.accumulate(pre)[:L]
            end = int(np.argmax(p - pmin))
            start = int(np.flatnonzero(pre[: end + 1] == pmin[end])[0])
            vals = (p[end] - pmin[end], p[-1], start, end,
                    int((rv & ~m)[start : end + 1].sum()))
            for k, v in zip(KEYS, vals):
                out[k][b, c] = v
    return out


@pytest.mark.parametrize("B,C,L,match,mismatch", [
    (9, 1, 1, 2, -6), (13, 5, 7, 2, -6), (6, 8, 77, 2, -6),
    (5, 8, 33, 1, -1)])
def test_score_candidates_plain_is_the_definition(B, C, L, match, mismatch):
    """The plain version on the CPU, at ragged shapes: N runs in the
    genome, ragged and all-gap reads, duplicate candidates (ties), windows
    at 0 and at the last legal start before the 256 bytes of padding."""
    rng = np.random.default_rng(L + C)
    G = 2000
    flat = np.full(G + 256, 4, np.int8)
    flat[:G] = rng.integers(0, 4, G)
    flat[rng.integers(0, G, 20)] = 4
    flat[700:740] = 4
    starts = rng.integers(0, G - L - 1, B)
    reads = np.stack([flat[s : s + L] for s in starts]).astype(np.int8)
    reads[rng.random((B, L)) < 0.05] = 2
    reads[1::3, L - L // 3 :] = 4
    reads[B - 1] = 4
    cand = rng.integers(0, G - L - 1, (B, C)).astype(np.int32)
    cand[:, 0] = starts
    cand[:, C // 2] = starts
    cand[0, -1] = 0
    cand[-1, -1] = G - L - 1
    cand[1, -1] = 690
    got = align_score.score_candidates(
        *(torch.as_tensor(x) for x in (flat, reads, cand)), match, mismatch,
        4)
    want = definition(flat, reads, cand, match, mismatch, 4)
    for k in KEYS:
        assert got[k].dtype == torch.int32 and got[k].shape == (B, C), k
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


def test_score_candidates_refuses_other_devices():
    """K5's wrapper runs its plain version only for CPU tensors."""
    m = dict(device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        align_score.score_candidates(
            torch.zeros(512, dtype=torch.int8, **m),
            torch.zeros((2, 7), dtype=torch.int8, **m),
            torch.zeros((2, 3), dtype=torch.int32, **m), 2, -6, 4)


def test_align_score_kernel_emulated_on_the_cpu(tmp_path):
    """``csrc/align_score.cu``'s kernel body built with the host compiler
    against a stand-in runtime header (one host thread per CUDA thread; the
    warp's shuffles, byte compares, funnel shifts and byte permutes with
    CUDA's semantics) and held bit for bit, in all five outputs, to a C++
    transcription of the definition: L 1 to 250, C 1, 5, 8 and 32, ties,
    the 64-bit state, another gap code, windows at the end of a buffer
    without padding; a second launch bit-equal."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a C++20 host compiler")
    here = Path(__file__).resolve().parent
    exe = tmp_path / "align_emu"
    subprocess.run(
        [cxx, "-std=c++20", "-O1", "-fno-strict-aliasing", "-pthread",
         "-Wno-unknown-pragmas", "-I", str(here / "count_core_emu"),
         "-I", str(here.parent / "figbird_tpu_torch" / "csrc"),
         str(here / "count_core_emu" / "align_emu.cpp"), "-o", str(exe)],
        check=True, capture_output=True, text=True, timeout=300)
    r = subprocess.run([str(exe)], capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0 and r.stdout.strip().endswith("ALL OK"), \
        r.stdout[-3000:] + r.stderr[-1000:]
