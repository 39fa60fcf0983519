"""The two banded-score functions of the port (K2 ``band_score_soft``, K3
``band_score`` and ``band_score_hard``) against the definition, their CUDA
core emulated on the CPU, and the TF32 rule of the entry points.  Nothing
here compiles a JAX program.

The definition, per instance, in float64:

    score[r, p] = sum_{j, valid[r, j], 0 <= codes[r, j] < 5}
                  K[p + j, 5 j + codes[r, j]]

with K from ``hard_K`` (the hard pass) or ``soft_K`` (the soft pass).
"""

import itertools
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from figbird_tpu_torch.ops import band, entry_device

torch.set_num_threads(2)

# one read and 37; 5 and 70 positions; L 7 and 50
SHAPES = list(itertools.product((1, 37), (5, 70), (7, 50)))


def hard_inputs(seed, I, P, L, Wp):
    """Codes 0-5, ~20% masked bases; a gap string (I, Wp + L - 1) with Ns
    (4) and positions past the contig (5); log factors as the model's."""
    rng = np.random.default_rng(seed)
    R = Wp + L - 1
    codes = rng.integers(0, 6, (I, P, L)).astype(np.int8)
    valid = rng.random((I, P, L)) < 0.8
    g = rng.integers(0, 4, (I, R)).astype(np.int8)
    u = rng.random((I, R))
    g[u < 0.2] = 4
    g[u < 0.1] = 5
    a = -rng.random(L).astype(np.float32) * 0.1
    b = (-2.0 - 4.0 * rng.random(L)).astype(np.float32)
    ln_et = -3.0 * rng.random((5, 5)).astype(np.float32)
    return codes, valid, g, a, b, ln_et


def definition(K, codes, valid, Wp):
    """The direct loop in float64: K (I, R, 5L) -> (I, P, Wp)."""
    I, P, L = codes.shape
    out = np.zeros((I, P, Wp))
    K = K.astype(np.float64)
    for i, r, j in itertools.product(range(I), range(P), range(L)):
        c = int(codes[i, r, j])
        if valid[i, r, j] and c < 5:
            out[i, r] += K[i, j : j + Wp, 5 * j + c]
    return out


def hard_K_definition(g, a, b, ln_et):
    """K[w, 5j + c]: 0 where g[w] >= 5, a_j where c == g[w], else
    b_j + lnET[g[w], c], in f32 as the kernel forms it."""
    I, R = g.shape
    L = a.shape[0]
    K = np.zeros((I, R, L, 5), np.float32)
    for i, w in itertools.product(range(I), range(R)):
        gw = int(g[i, w])
        if gw < 5:
            K[i, w] = b[:, None] + ln_et[gw][None, :]
            K[i, w, :, gw] = a
    return K.reshape(I, R, 5 * L)


@pytest.mark.parametrize("P,Wp,L", SHAPES)
def test_band_score_hard_plain_is_the_definition(P, Wp, L):
    """K3's gap-string form on the CPU: ``hard_K`` entries exactly as the
    kernel builds them, and the score within rtol 1e-5, atol 1e-4 of the
    float64 loop; equal to the K form on ``hard_K``'s output."""
    codes, valid, g, a, b, ln_et = hard_inputs(41, 2, P, L, Wp)
    K = band.hard_K(torch.as_tensor(g), torch.as_tensor(a),
                    torch.as_tensor(b), torch.as_tensor(ln_et))
    np.testing.assert_array_equal(K.numpy(), hard_K_definition(g, a, b,
                                                               ln_et))
    args = [torch.as_tensor(x) for x in (codes, valid)]
    got = band.band_score_hard(*args, torch.as_tensor(g), torch.as_tensor(a),
                               torch.as_tensor(b), torch.as_tensor(ln_et), Wp)
    assert got.shape == (2, P, Wp)
    np.testing.assert_allclose(got.numpy(), definition(K.numpy(), codes,
                                                       valid, Wp),
                               rtol=1e-5, atol=1e-4)
    assert torch.equal(got, band.band_score(*args, K, Wp))


@pytest.mark.parametrize("P,Wp,L", SHAPES[::3])
def test_band_score_soft_plain_is_the_definition(P, Wp, L):
    """K2 on the CPU against the float64 loop over ``soft_K``, with factors
    of exactly 0 (the 1e-30 clamp)."""
    rng = np.random.default_rng(42)
    I, R = 2, Wp + L - 1
    codes, valid = hard_inputs(43, I, P, L, Wp)[:2]
    A = rng.random((I, R, 5)).astype(np.float32)
    A[:, ::4] = 0.0
    B = rng.random((I, R, 5)).astype(np.float32) * 1e-2
    e = rng.random(L).astype(np.float32) * 1e-2
    e[:2] = 0.0
    K = band.soft_K(*(torch.as_tensor(x) for x in (A, B, e))).numpy()
    got = band.band_score_soft(*(torch.as_tensor(x) for x in (codes, valid,
                                                              A, B, e)), Wp)
    np.testing.assert_allclose(got.numpy(), definition(K, codes, valid, Wp),
                               rtol=1e-5, atol=1e-3)


def test_entry_device_refuses_tf32():
    """With TF32 on, an entry point refuses the card (the port's f32
    matmuls would round to 10 bits) and names the flag; the CPU runs."""
    flag = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        with pytest.raises(RuntimeError, match="allow_tf32"):
            entry_device("cuda")
        assert entry_device("cpu").type == "cpu"
        torch.backends.cuda.matmul.allow_tf32 = False
        assert entry_device("cuda").type == "cuda"
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag


def test_wrapper_refuses_other_devices():
    """K3's gap-string form runs its plain version only for CPU tensors."""
    m = dict(device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        band.band_score_hard(
            torch.zeros((1, 2, 3), dtype=torch.int8, **m),
            torch.ones((1, 2, 3), dtype=torch.bool, **m),
            torch.zeros((1, 8), dtype=torch.int8, **m), torch.zeros(3, **m),
            torch.zeros(3, **m), torch.zeros((5, 5), **m), 4)


def test_band_core_emulated_on_the_cpu(tmp_path):
    """``csrc/band_core.cuh``, the core of the CUDA kernels K2 and K3, with
    their tile functors from ``band_soft.cu`` and ``band_hard.cu``, built
    with the host compiler against a stand-in runtime header (one host
    thread per CUDA thread, barriers for ``__syncthreads``, ``__syncwarp``
    and ``__ballot_sync``) and held at ragged shapes to the f32 sum in
    ascending j bit for bit, to the float64 sum, and K3's gap-string form
    to its K form bit for bit: its staging, compaction, passes and sum
    order, where no CUDA compiler exists."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a C++20 host compiler")
    here = Path(__file__).resolve().parent
    exe = tmp_path / "band_emu"
    subprocess.run(
        [cxx, "-std=c++20", "-O1", "-fno-strict-aliasing", "-pthread",
         "-Wno-unknown-pragmas", "-I", str(here / "count_core_emu"),
         "-I", str(here.parent / "figbird_tpu_torch" / "csrc"),
         str(here / "count_core_emu" / "band_emu.cpp"), "-o", str(exe)],
        check=True, capture_output=True, text=True, timeout=300)
    r = subprocess.run([str(exe)], capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0 and r.stdout.strip().endswith("ALL OK"), \
        r.stdout[-3000:] + r.stderr[-1000:]
