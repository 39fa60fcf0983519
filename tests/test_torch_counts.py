"""The two count functions of the port (K4 ``fold_counts``, K1
``cascade_counts``) against the definition, and the device rule of the
port's entry points.  Nothing here compiles a JAX program.

The definition, per instance, in float64:

    counts[k, w, c] = sum_r sum_j w_k[r, w - j] * vals[r, j]
                                  * (codes[r, j] == c),   0 <= w - j < Pw

The plain versions held to it here are what the CUDA kernels are held to on
the card (``tests/test_torch_cuda.py`` takes its inputs from this module).
"""

import itertools

import numpy as np
import pytest
import torch

from figbird_tpu_torch import config, simulate
from figbird_tpu_torch.align.core import Aligner
from figbird_tpu_torch.align.index import build_index
from figbird_tpu_torch.fill.driver import fill_gaps
from figbird_tpu_torch.ops import band
from figbird_tpu_torch.pipeline import Pipeline

torch.set_num_threads(2)

SHIFT, CUT = 140.0, 78.0
# ragged: one read and a last chunk that is not full, bands narrower and wider
# than a row tile, reads shorter than a tile, W = Pw + L - 1 and Pw + L
SHAPES = [(P, Pw, L, Pw + L - 1 + extra)
          for (P, Pw, L), extra in itertools.product(
              [(1, 5, 7), (33, 40, 36), (33, 5, 36), (1, 40, 7)], (0, 1))]


def count_inputs(seed, I, P, Pw, L, fractional, levels):
    """codes 0-5 (4 is N, 5 pads), ~10% uncounted bases, count values 0/1 or
    quality-like fractions; and either raw weights, half of them 0
    (``levels`` false), or masked log-weights.  With 0/1 values the
    log-weights spread over [-900, 0], so every level holds overflow-zeroed,
    normal, denormal and underflowed weights; with fractional values each
    entry sits in one level's normal range (a product with a denormal has no
    relative precision to compare at)."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 6, (I, P, L)).astype(np.int8)
    vals = (rng.random((I, P, L)) < 0.9).astype(np.float32)
    if fractional:
        vals *= rng.random((I, P, L)).astype(np.float32) * 1e-2
    if not levels:
        x = rng.random((I, P, Pw)).astype(np.float32)
        x[rng.random((I, P, Pw)) < 0.5] = 0.0
    else:
        if fractional:
            x = -(140.0 * rng.integers(0, 6, (I, P, Pw))
                  + rng.uniform(0.0, 80.0, (I, P, Pw))).astype(np.float32)
        else:
            x = rng.uniform(-900.0, 0.0, (I, P, Pw)).astype(np.float32)
        x[rng.random((I, P, Pw)) < 0.3] = band.MASKED
    return x, codes, vals


def definition(wk, codes, vals, W):
    """The direct loop in float64: wk (I, m, P, Pw) level weights ->
    (I, m, W, 5)."""
    I, m, P, Pw = wk.shape
    L = codes.shape[-1]
    out = np.zeros((I, m, W, 5))
    wk = wk.astype(np.float64)
    for i, r, j in itertools.product(range(I), range(P), range(L)):
        c = codes[i, r, j]
        if c < 5:
            out[i, :, j : j + Pw, c] += wk[i, :, r] * float(vals[i, r, j])
    return out


@pytest.mark.parametrize("fractional", [False, True])
@pytest.mark.parametrize("P,Pw,L,W", SHAPES)
def test_fold_plain_is_the_definition(P, Pw, L, W, fractional):
    x, codes, vals = count_inputs(21, 2, P, Pw, L, fractional, False)
    got = band.fold_counts(torch.as_tensor(x), torch.as_tensor(codes),
                           torch.as_tensor(vals), W).numpy()
    want = definition(x[:, None], codes, vals, W)[:, 0]
    assert got.shape == (2, W, 5)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert (want > 0).any()


@pytest.mark.parametrize("m,fractional", [(1, False), (3, False), (6, False),
                                          (6, True)])
@pytest.mark.parametrize("P,Pw,L,W", SHAPES)
def test_cascade_plain_is_the_definition(P, Pw, L, W, m, fractional):
    """The level weights are the port's own f32 ``level_weight`` (its
    denormals included); the count product and the fold are the
    definition's."""
    x, codes, vals = count_inputs(22, 2, P, Pw, L, fractional, True)
    lw = torch.as_tensor(x)
    got = band.cascade_counts(lw, torch.as_tensor(codes),
                              torch.as_tensor(vals), W, m, SHIFT, CUT).numpy()
    wk = np.stack([band.level_weight(lw, k, SHIFT, CUT).numpy()
                   for k in range(m)], axis=1)
    want = definition(wk, codes, vals, W)
    assert got.shape == (2, m, W, 5)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(got == 0, want == 0)


def test_level_weight_ranges():
    """exp(lw + k * shift) where that is <= cut, else 0; masked entries and
    deep underflow give exactly 0."""
    lw = torch.tensor([0.0, -50.0, -139.0, -141.0, -300.0, band.MASKED])
    for k in range(3):
        lk = lw.double().numpy() + k * SHIFT
        want = np.where(lk <= CUT, np.exp(np.maximum(lk, -745.0)), 0.0)
        got = band.level_weight(lw, k, SHIFT, CUT).numpy()
        normal = want > 1e-37
        np.testing.assert_allclose(got[normal], want[normal], rtol=1e-6)
        assert (got[want < 1e-46] == 0).all() and got[-1] == 0
        assert (got[lk > CUT] == 0).all()


# ------------------------------------------------------------ device rule

def _tiny():
    sim = simulate.simulate(simulate.SimConfig(
        genome_len=4000, n_contigs=1, n_gaps=1, coverage=2, seed=5))
    cfg = config.FigbirdConfig(
        draft_genome="", output_folder="",
        read_pairs=[config.ReadLibrary("", "", avg_insert_size=200,
                                       max_read_length=101)],
        parameters=config.Parameters(trim_len=0))
    return sim, cfg


def _pipeline(**kw):
    sim, cfg = _tiny()
    return Pipeline(cfg, sim.draft, [(sim.reads1, sim.reads2)], **kw).device


def _aligner(**kw):
    sim, _ = _tiny()
    return Aligner(build_index(sim.draft, k=15, device_tables=True),
                   **kw).device


def _fill_gaps(**kw):
    sim, _ = _tiny()
    res = fill_gaps(sim.draft, [], [], None, True, 30, **kw)
    assert res.gap_strings == []
    return torch.device("cpu")


@pytest.mark.parametrize("entry", [_pipeline, _aligner, _fill_gaps],
                         ids=["Pipeline", "Aligner", "fill_gaps"])
def test_entry_points_never_fall_back_to_the_cpu(entry):
    """Without a card, an entry point that was not given a device raises and
    names ``device="cpu"``; asked for the CPU, it runs there."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None is the card")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        entry()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        entry(device=None)
    assert entry(device="cpu").type == "cpu"


# ------------------------------------------------- the CUDA core on the CPU

def test_count_core_emulated_on_the_cpu(tmp_path):
    """``csrc/count_core.cuh``, the core of the CUDA kernels K4 and K1, built
    with the host compiler against a stand-in runtime header (one host
    thread per CUDA thread, a barrier for ``__syncthreads``) and held
    against the definition in float64 at ragged shapes: its index
    arithmetic, tiling and sum order, where no CUDA compiler exists."""
    import shutil
    import subprocess
    from pathlib import Path

    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a C++20 host compiler")
    here = Path(__file__).resolve().parent
    exe = tmp_path / "count_core_emu"
    subprocess.run(
        [cxx, "-std=c++20", "-O1", "-pthread", "-Wno-unknown-pragmas",
         "-I", str(here / "count_core_emu"),
         "-I", str(here.parent / "figbird_tpu_torch" / "csrc"),
         str(here / "count_core_emu" / "emu.cpp"), "-o", str(exe)],
        check=True, capture_output=True, text=True, timeout=300)
    r = subprocess.run([str(exe)], capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0 and r.stdout.strip().endswith("ALL OK"), \
        r.stdout[-3000:] + r.stderr[-1000:]
