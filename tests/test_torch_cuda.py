"""The port's CUDA kernels against their plain versions on the card, at
ragged shapes off the main path's (partial tiles, N and pad codes, masked
bases, quality-weighted counts).  Each test skips without a CUDA device.
On a machine with one (and without JAX, which the suite's conftest
imports):

    python -m pytest --noconftest -o markers=cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from figbird_tpu_torch import ops
from figbird_tpu_torch.ops import align_score, band
from test_torch_counts import CUT, SHAPES, SHIFT, count_inputs

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _launched(name, fn):
    """fn() and whether it launched kernel ``name`` exactly once."""
    before = ops.LAUNCHES[name]
    out = fn()
    torch.cuda.synchronize()
    return out, ops.LAUNCHES[name] - before == 1


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=rtol, atol=atol)


def _band_inputs(dev, seed, I, P, L, Wp):
    """Codes 0-5 (5 pads rows past a window), masked bases; probability
    slabs with rows of 0 (the 1e-30 clamp); K; a gap string with Ns (4) and
    positions past the contig (5), and the model's log factors."""
    rng = np.random.default_rng(seed)
    R = Wp + L + 3
    codes = rng.integers(0, 6, (I, P, L)).astype(np.int8)
    valid = rng.random((I, P, L)) < 0.8
    probs = rng.random((I, R, 5)).astype(np.float32)
    probs[..., 4] = 0.0
    probs[:, 5:9] = 0.0
    probs = probs / np.maximum(probs.sum(-1, keepdims=True), 1e-9)
    eprobs = rng.random((I, R, 5)).astype(np.float32) * 1e-2
    e_pos = rng.random(L).astype(np.float32) * 1e-2
    K = -8 * rng.random((I, R, 5 * L)).astype(np.float32)
    g = rng.integers(0, 6, (I, R)).astype(np.int8)
    a = -rng.random(L).astype(np.float32) * 0.1
    b = (-2.0 - 4.0 * rng.random(L)).astype(np.float32)
    ln_et = -3.0 * rng.random((5, 5)).astype(np.float32)
    return [torch.as_tensor(x, device=dev) for x in (
        codes, valid, probs, eprobs, e_pos, K, g, a, b, ln_et)]


def _check_bands(dev, seed, I, P, L, Wp):
    """K2, K3's K form and K3's gap-string form against their plain
    versions (K2 rtol 1e-5, atol 1e-3; K3 rtol 1e-5, atol 1e-4), one launch
    each, a second launch bit-equal, and the gap-string form bit-equal to
    the K form on ``hard_K``'s output."""
    codes, valid, probs, eprobs, e_pos, K, g, a, b, ln_et = _band_inputs(
        dev, seed, I, P, L, Wp)
    soft = lambda: band.band_score_soft(  # noqa: E731
        codes, valid, probs, eprobs, e_pos, Wp)
    hard_k = lambda: band.band_score(codes, valid, K, Wp)  # noqa: E731
    hard_g = lambda: band.band_score_hard(  # noqa: E731
        codes, valid, g, a, b, ln_et, Wp)
    got, once = _launched("band_soft", soft)
    assert once and got.shape == (I, P, Wp)
    _close(got, band.band_score_soft_plain(codes, valid, probs, eprobs,
                                           e_pos, Wp), 1e-5, 1e-3)
    assert torch.equal(got, soft())
    got, once = _launched("band_hard", hard_k)
    assert once
    _close(got, band.band_score_plain(codes, valid, K, Wp), 1e-5, 1e-4)
    assert torch.equal(got, hard_k())
    got, once = _launched("band_hard", hard_g)
    assert once
    _close(got, band.band_score_hard_plain(codes, valid, g, a, b, ln_et, Wp),
           1e-5, 1e-4)
    assert torch.equal(got, hard_g())
    assert torch.equal(got, band.band_score(
        codes, valid, band.hard_K(g, a, b, ln_et), Wp))


@pytest.mark.parametrize("I,P,L,Wp", [(3, 37, 50, 70), (1, 8, 101, 128),
                                      (2, 1, 7, 5), (1, 37, 7, 70)])
def test_band_scores_match_plain(dev, I, P, L, Wp):
    """K2 and both forms of K3: codes 0-5, masked bases, gap strings with
    Ns and positions past the contig; repeats bit-equal."""
    _check_bands(dev, 11, I, P, L, Wp)


@pytest.mark.parametrize("L", [151, 250])
def test_bands_long_reads_right_or_refused(dev, L):
    """Reads longer than a pass of the core holds: the kernels score them in
    several passes and are right, or their wrappers raise."""
    try:
        _check_bands(dev, 15, 2, 37, L, 140)
    except RuntimeError as e:
        assert "launch failed" in str(e)


def test_bands_many_instances(dev):
    """70,000 tiny instances: more than a grid's second dimension holds."""
    _check_bands(dev, 16, 70_000, 2, 7, 5)


@pytest.mark.parametrize("quality", [False, True])
def test_fold_matches_plain(dev, quality):
    """K4 at a ragged shape, with 0/1 or quality-weighted count values; two
    runs are bit-equal (fixed sum order, no atomics)."""
    rng = np.random.default_rng(12)
    I, P, L, Pw = 2, 45, 37, 50
    W = Pw + L
    codes = torch.as_tensor(rng.integers(0, 6, (I, P, L)).astype(np.int8),
                            device=dev)
    vals = (rng.random((I, P, L)) < 0.9).astype(np.float32)
    if quality:
        vals *= rng.random((I, P, L)).astype(np.float32) * 1e-2
    vals = torch.as_tensor(vals, device=dev)
    w = rng.random((I, P, Pw)).astype(np.float32)
    w[rng.random((I, P, Pw)) < 0.5] = 0.0
    w = torch.as_tensor(w, device=dev)
    got, once = _launched("fold", lambda: band.fold_counts(w, codes, vals, W))
    assert once and got.shape == (I, W, 5)
    _close(got, band.fold_counts_plain(w, codes, vals, W), 2e-6, 0.0)
    assert torch.equal(got, band.fold_counts(w, codes, vals, W))


@pytest.mark.parametrize("I,P,L,Pw,m", [(2, 45, 37, 50, 6),
                                        (1, 70, 101, 128, 3),
                                        (1, 33, 24, 200, 1)])
def test_cascade_matches_plain(dev, I, P, L, Pw, m):
    """K1 at ragged shapes (partial row tiles, a last read chunk that is
    not full, W = Pw + L and Pw + L - 1): log-weights over [-900, 0] with
    ~30% masked, so every level holds overflow-zeroed, normal, denormal and
    underflowed weights.  Within rtol 2e-6 of the plain version, zeros in
    the same places, and two runs bit-equal (fixed sum order, no atomics)."""
    rng = np.random.default_rng(14)
    W = Pw + L - (m == 3)
    lw = rng.uniform(-900.0, 0.0, (I, P, Pw)).astype(np.float32)
    lw[rng.random((I, P, Pw)) < 0.3] = band.MASKED
    lw = torch.as_tensor(lw, device=dev)
    codes = torch.as_tensor(rng.integers(0, 6, (I, P, L)).astype(np.int8),
                            device=dev)
    vals = torch.as_tensor((rng.random((I, P, L)) < 0.9).astype(np.float32),
                           device=dev)
    got, once = _launched("cascade", lambda: band.cascade_counts(
        lw, codes, vals, W, m, 140.0, 78.0))
    assert once and got.shape == (I, m, W, 5)
    want = band.cascade_counts_plain(lw, codes, vals, W, m, 140.0, 78.0)
    _close(got, want, 2e-6, 0.0)
    assert torch.equal(got == 0, want == 0)
    assert (got == 0).any() and (got[:, m - 1] > 0).any()
    assert torch.equal(got, band.cascade_counts(lw, codes, vals, W, m, 140.0,
                                                78.0))


def _counts_on_card(dev, seed, I, P, Pw, L, W, m, fractional):
    """K4 (``m`` None) or K1 on the card against its plain version there:
    rtol 2e-6, atol 0, K1 with zeros in the same places; one launch; a
    second launch bit-equal."""
    x, codes, vals = (torch.as_tensor(a, device=dev) for a in count_inputs(
        seed, I, P, Pw, L, fractional, m is not None))
    if m is None:
        name, shape = "fold", (I, W, 5)
        kern = lambda: band.fold_counts(x, codes, vals, W)  # noqa: E731
        want = band.fold_counts_plain(x, codes, vals, W)
    else:
        name, shape = "cascade", (I, m, W, 5)
        kern = lambda: band.cascade_counts(  # noqa: E731
            x, codes, vals, W, m, SHIFT, CUT)
        want = band.cascade_counts_plain(x, codes, vals, W, m, SHIFT, CUT)
    got, once = _launched(name, kern)
    assert once and got.shape == shape
    _close(got, want, 2e-6, 0.0)
    if m is not None:
        assert torch.equal(got == 0, want == 0)
    assert (want > 0).any()
    assert torch.equal(got, kern())


@pytest.mark.parametrize("m,fractional", [
    (None, False), (None, True), (1, False), (3, False), (6, False),
    (6, True)])
@pytest.mark.parametrize("P,Pw,L,W", SHAPES)
def test_counts_match_plain_at_ragged_shapes(dev, P, Pw, L, W, m, fractional):
    """K4 and K1 where nothing divides: one read, a last chunk that is not
    full, bands narrower than a row tile, both widths W."""
    _counts_on_card(dev, 31, 3, P, Pw, L, W, m, fractional)


@pytest.mark.parametrize("m", [None, 6])
@pytest.mark.parametrize("L", [151, 250])
def test_counts_long_reads_right_or_refused(dev, L, m):
    """Reads longer than the main path's: the stage holds fewer of them per
    chunk.  The kernel is either right or its wrapper raises; it never
    returns a wrong answer."""
    try:
        _counts_on_card(dev, 32, 2, 37, 140, L, 140 + L, m, False)
    except RuntimeError as e:
        assert "launch failed" in str(e)


def test_fold_many_instances(dev):
    """70,000 tiny instances: more than a grid's second dimension holds."""
    _counts_on_card(dev, 33, 70_000, 2, 5, 7, 12, None, False)


def test_score_candidates_bit_equal_to_plain(dev):
    """K5 at L = 77 with N-padded reads, genome N runs and duplicate
    candidates (tie rules): all five outputs bit-equal."""
    rng = np.random.default_rng(13)
    G, B, C, L = 30_000, 100, 5, 77
    flat = rng.integers(0, 4, G + 256).astype(np.int8)
    flat[rng.integers(0, G, 300)] = 4
    flat[9000:9040] = 4
    starts = rng.integers(0, G - L - 1, B)
    reads = np.stack([flat[s : s + L] for s in starts])
    reads[rng.random((B, L)) < 0.05] = 2
    reads[::4, 60:] = 4
    cand = rng.integers(0, G - L - 1, (B, C)).astype(np.int32)
    cand[:, 0] = starts
    cand[:, 1] = starts
    cand[:3, 2] = 8990
    args = (torch.as_tensor(flat, device=dev),
            torch.as_tensor(reads, device=dev),
            torch.as_tensor(cand, device=dev), 2, -6, 4)
    got, once = _launched("align_score",
                          lambda: align_score.score_candidates(*args))
    assert once
    want = align_score.score_candidates_plain(*args)
    for k in ("local", "e2e", "start", "end", "n_mis"):
        assert torch.equal(got[k], want[k]), k
