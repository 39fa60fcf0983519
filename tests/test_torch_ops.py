"""The port's kernel wrappers (their plain versions on the CPU) against the
JAX package's XLA paths and its Pallas kernels in interpret mode."""

import contextlib

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from figbird_tpu.align.core import _score_candidates, as_rows
from figbird_tpu.fill.em import (_CASCADE_CUT, _CASCADE_SHIFT,
                                 _accumulate_levels, _fold_counts_T,
                                 _hard_K, _oh_flat_c, _oh_flat_j, _soft_K)
from figbird_tpu.ops.align_score import score_candidates_scan
from figbird_tpu.ops.band import (_band_score_pallas, _band_score_soft_pallas,
                                  band_score_reference)
from figbird_tpu.ops.band import cascade_counts as cascade_counts_pallas
from figbird_tpu.ops.band import fold_counts as fold_counts_pallas
from figbird_tpu_torch.ops import align_score as t_align
from figbird_tpu_torch.ops import band as t_band

torch.set_num_threads(2)


@contextlib.contextmanager
def xla_cpu_float_mode():
    """XLA's CPU runtime computes with flush-to-zero and denormals-are-zero
    set, so its ``exp`` returns 0 where the f32 result would be a denormal
    (below e^-87.34).  PyTorch keeps IEEE denormals unless told otherwise.
    Inside this block PyTorch's CPU ops run in XLA's mode, so that zero
    patterns compare like with like."""
    if not torch.set_flush_denormal(True):
        pytest.skip("this CPU cannot flush denormals")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the mode is the calling thread's own
    try:
        yield
    finally:
        torch.set_num_threads(threads)
        torch.set_flush_denormal(False)


def _reads(rng, I, R, L):
    codes = rng.integers(0, 5, (I, R, L)).astype(np.int8)
    valid = rng.random((I, R, L)) < 0.8
    return codes, valid


@pytest.mark.parametrize("I,R,W,L", [(1, 8, 160, 12), (2, 30, 200, 33)])
def test_band_score_hard(I, R, W, L):
    """K3: score[r, p] = sum_j K[p+j, 5j + read_rj]."""
    rng = np.random.default_rng(1)
    Wp = W - L
    K = rng.normal(size=(I, W, L * 5)).astype(np.float32)
    codes, valid = _reads(rng, I, R, L)
    got = t_band.band_score(torch.as_tensor(codes), torch.as_tensor(valid),
                            torch.as_tensor(K), Wp).numpy()
    for i in range(I):
        oh = _oh_flat_j(jnp.asarray(codes[i]), jnp.asarray(valid[i]))
        xla = np.asarray(band_score_reference(oh, jnp.asarray(K[i]), Wp))
        pallas = np.asarray(_band_score_pallas(oh, jnp.asarray(K[i]), Wp))
        np.testing.assert_allclose(got[i], xla, rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(got[i], pallas, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("I,R,W,L", [(1, 8, 160, 12), (2, 30, 200, 33)])
def test_band_score_hard_from_gap_string(I, R, W, L):
    """K3's gap-string form (the hard pass's call) against the reference's
    ``_hard_K`` and ``band_score_reference``, at ``test_band_score_hard``'s
    shapes: gap strings with Ns (4) and positions past the contig (5)."""
    rng = np.random.default_rng(2)
    Wp = W - L
    g = rng.integers(0, 6, (I, W)).astype(np.int8)
    a = -rng.random(L).astype(np.float32) * 0.1
    b = (-2.0 - 4.0 * rng.random(L)).astype(np.float32)
    ln_et = -3.0 * rng.random((5, 5)).astype(np.float32)
    codes, valid = _reads(rng, I, R, L)
    got = t_band.band_score_hard(
        *(torch.as_tensor(x) for x in (codes, valid, g, a, b, ln_et)),
        Wp).numpy()
    for i in range(I):
        oh = _oh_flat_j(jnp.asarray(codes[i]), jnp.asarray(valid[i]))
        K = _hard_K(jnp.asarray(g[i]), jnp.asarray(a), jnp.asarray(b),
                    jnp.asarray(ln_et))
        xla = np.asarray(band_score_reference(oh, K, Wp))
        np.testing.assert_allclose(got[i], xla, rtol=1e-5, atol=1e-4)


def test_band_score_soft_clamp():
    """K2, including factors that are exactly zero (the 1e-30 clamp)."""
    rng = np.random.default_rng(3)
    W, L, R = 200, 20, 16
    Wp = W - L
    probs = rng.random((W, 5)).astype(np.float32)
    probs[:, 4] = 0.0
    probs[50:60] = 0.0
    probs[50:60, 0] = 1.0
    e_pos = np.full(L, 1e-3, np.float32)
    e_pos[:4] = 0.0
    eprobs = rng.random((W, 5)).astype(np.float32) * 1e-2
    codes, valid = _reads(rng, 1, R, L)
    oh = _oh_flat_j(jnp.asarray(codes[0]), jnp.asarray(valid[0]))
    K = _soft_K(jnp.asarray(probs), jnp.asarray(eprobs), jnp.asarray(e_pos),
                W)
    xla = np.asarray(band_score_reference(oh, K, Wp))
    pallas = np.asarray(_band_score_soft_pallas(
        oh, jnp.asarray(probs), jnp.asarray(eprobs), jnp.asarray(e_pos), Wp))
    got = t_band.band_score_soft(
        torch.as_tensor(codes), torch.as_tensor(valid),
        torch.as_tensor(probs)[None], torch.as_tensor(eprobs)[None],
        torch.as_tensor(e_pos), Wp).numpy()[0]
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, xla, rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("quality", [False, True])
def test_fold_counts(quality):
    """K4: weights x count one-hot with the diagonal fold; 0/1 one-hots and
    quality-weighted ones (the finalize pass's check_update sums)."""
    rng = np.random.default_rng(5)
    N, L, Pw = 24, 19, 90
    W = Pw + L
    w = rng.random((N, Pw)).astype(np.float32)
    codes, valid = _reads(rng, 1, N, L)
    qerr = rng.random((N, L)).astype(np.float32) * 1e-2
    oh_c = _oh_flat_c(jnp.asarray(codes[0]), jnp.asarray(valid[0]))
    oh_j = _oh_flat_j(jnp.asarray(codes[0]), jnp.asarray(valid[0]))
    vals = valid[0].astype(np.float32)
    if quality:
        oh_c = oh_c * jnp.tile(jnp.asarray(qerr), (1, 5))
        oh_j = oh_j * jnp.repeat(jnp.asarray(qerr), 5, axis=1)
        vals = vals * qerr
    cwT = jax.lax.dot_general(oh_c, jnp.asarray(w), (((0,), (0,)), ((), ())),
                              preferred_element_type=jnp.float32)
    xla = np.asarray(_fold_counts_T(cwT, L, W))
    pallas = np.asarray(fold_counts_pallas(jnp.asarray(w), oh_j, L, W))
    got = t_band.fold_counts(torch.as_tensor(w)[None], torch.as_tensor(codes),
                             torch.as_tensor(vals)[None], W).numpy()[0]
    assert got.shape == (W, 5)
    np.testing.assert_allclose(got, xla, rtol=2e-6, atol=0)
    np.testing.assert_allclose(got, pallas, rtol=2e-6, atol=0)


@pytest.mark.parametrize("m", [6, 3])
def test_cascade_counts(m):
    """K1: the first m cascade levels' folded counts from log-weights over
    [-900, 0] with ~30% illegal, against the Pallas kernel (interpret mode)
    and the XLA branch of ``_accumulate_levels``: rtol 2e-6 (the sum order
    differs), and exact zeros (the legal mask, exp underflow, overflow-
    zeroed levels) in the same places."""
    rng = np.random.default_rng(5)
    N, L, Pw = 24, 19, 90
    W = Pw + L
    logw = rng.uniform(-900.0, 0.0, (N, Pw)).astype(np.float32)
    legal = rng.random((N, Pw)) < 0.7
    codes, valid = _reads(rng, 1, N, L)
    oh_c = _oh_flat_c(jnp.asarray(codes[0]), jnp.asarray(valid[0]))
    oh_j = _oh_flat_j(jnp.asarray(codes[0]), jnp.asarray(valid[0]))
    lw = np.where(legal, logw, np.float32(-1e30))
    xla = np.asarray(_accumulate_levels(jnp.asarray(logw), jnp.asarray(legal),
                                        oh_c, L, W, m))
    pallas = np.asarray(cascade_counts_pallas(
        jnp.asarray(lw), oh_j, L, W, m, _CASCADE_SHIFT, _CASCADE_CUT))
    args = (torch.as_tensor(lw)[None], torch.as_tensor(codes),
            torch.as_tensor(valid.astype(np.float32)), W, m, _CASCADE_SHIFT,
            _CASCADE_CUT)
    with xla_cpu_float_mode():
        got = t_band.cascade_counts(*args).numpy()[0]
    assert got.shape == (m, W, 5)
    for want in (xla, pallas):
        np.testing.assert_allclose(got, want, rtol=2e-6, atol=0)
        np.testing.assert_array_equal(got == 0.0, want == 0.0)
    assert (got == 0.0).any() and (got[m - 1] > 0.0).any()
    # in IEEE mode (the port's own) the weights below e^-87.34 stay
    # denormals: mass XLA's CPU mode drops, at most one smallest normal per
    # term, and nothing else differs
    ieee = t_band.cascade_counts(*args).numpy()[0]
    kept = (ieee != 0.0) & (xla == 0.0)
    assert kept.any() and not ((ieee == 0.0) & (xla != 0.0)).any()
    tiny = np.finfo(np.float32).tiny
    np.testing.assert_allclose(ieee, xla, rtol=2e-6, atol=N * L * tiny)


def test_score_candidates_bit_equal():
    """K5 at L=101 with N-padded reads and genome Ns: all five outputs
    bit-equal to the XLA path and to the Pallas kernel."""
    rng = np.random.default_rng(7)
    G, B, C, L = 20_000, 40, 8, 101
    flat = rng.integers(0, 4, G).astype(np.int8)
    flat[rng.integers(0, G, 200)] = 4
    flat[5000:5030] = 4
    starts = rng.integers(0, G - L - 1, B)
    reads = np.stack([flat[s : s + L] for s in starts]).astype(np.int8)
    mut = rng.random((B, L)) < 0.05
    reads[mut] = rng.integers(0, 4, int(mut.sum()))
    for b in range(0, B, 5):  # N-padded shorter reads
        reads[b, L - 1 - rng.integers(0, 30):] = 4
    cand = rng.integers(0, G - L - 1, (B, C)).astype(np.int32)
    cand[:, 0] = starts
    cand[::3, 1] = starts[::3] + 2
    cand[:2, 2] = 4990  # windows over the genome N-run
    flat2d = jnp.asarray(as_rows(flat))
    xla = _score_candidates(flat2d, jnp.asarray(reads), jnp.asarray(cand),
                            jnp.ones((B, C), bool), 2, -6)
    pallas = score_candidates_scan(flat2d, jnp.asarray(reads),
                                   jnp.asarray(cand), 2, -6, 4,
                                   interpret=True)
    got = t_align.score_candidates(
        torch.as_tensor(as_rows(flat).reshape(-1)), torch.as_tensor(reads),
        torch.as_tensor(cand), 2, -6, 4)
    for k in ("local", "e2e", "start", "end", "n_mis"):
        g = got[k].numpy()
        np.testing.assert_array_equal(g, np.asarray(xla[k]), err_msg=k)
        np.testing.assert_array_equal(g, np.asarray(pallas[k]), err_msg=k)


def test_wrappers_refuse_other_devices():
    """A wrapper runs its plain version only for CPU tensors; any other
    device gets the kernel or an error, never a silent fallback."""
    codes = torch.zeros((1, 2, 3), dtype=torch.int8, device="meta")
    valid = torch.ones((1, 2, 3), dtype=torch.bool, device="meta")
    K = torch.zeros((1, 8, 15), device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        t_band.band_score(codes, valid, K, 4)
    with pytest.raises(RuntimeError, match="no kernel"):
        t_band.fold_counts(torch.zeros((1, 2, 4), device="meta"), codes,
                           valid.float(), 7)
    with pytest.raises(RuntimeError, match="no kernel"):
        t_band.cascade_counts(torch.zeros((1, 2, 4), device="meta"), codes,
                              valid.float(), 7, 6, 140.0, 78.0)
