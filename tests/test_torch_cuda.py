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
from figbird_tpu_torch.ops import align_score, band, overlap
from test_torch_counts import CUT, SHAPES, SHIFT, count_inputs
from test_torch_overlap import overlap_batch, threshold_batch

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


@pytest.mark.parametrize("C", [8, 32])
@pytest.mark.parametrize("L", [101, 151, 250])
def test_score_candidates_main_path_counts_bit_equal(dev, C, L):
    """K5 at the aligner's two candidate counts and three read lengths, on a
    genome padded as the Aligner pads it (``as_rows``): candidates mostly
    at the read's true start (ties), the rest anywhere, at 0 and at the last
    legal start; ragged, N-carrying and all-gap reads; B not a multiple of
    a warp's reads.  All five outputs bit-equal to the plain version, one
    launch, a second launch bit-equal."""
    from figbird_tpu_torch.align.core import as_rows

    rng = np.random.default_rng(L + C)
    G, B = 50_003, 1_001
    genome = rng.integers(0, 4, G).astype(np.int8)
    genome[rng.integers(0, G, 250)] = 4
    genome[20_000:20_070] = 4
    flat = as_rows(genome)
    starts = rng.integers(0, G - L - 1, B)
    reads = np.stack([flat[s : s + L] for s in starts])
    reads[rng.random((B, L)) < 0.01] = 1
    reads[rng.random((B, L)) < 0.005] = 4
    reads[::5, L - 20 :] = 4
    reads[7] = 4
    cand = rng.integers(0, G - L - 1, (B, C)).astype(np.int32)
    near = rng.random((B, C)) < 0.75
    cand[near] = np.broadcast_to(starts[:, None], (B, C))[near]
    cand[:, -1] = G - L - 1
    cand[::3, -2] = 0
    cand[:5, 1] = 19_990
    args = (torch.as_tensor(flat, device=dev),
            torch.as_tensor(reads, device=dev),
            torch.as_tensor(cand, device=dev), 2, -6, 4)
    got, once = _launched("align_score",
                          lambda: align_score.score_candidates(*args))
    assert once
    again = align_score.score_candidates(*args)
    want = align_score.score_candidates_plain(*args)
    for k in ("local", "e2e", "start", "end", "n_mis"):
        assert got[k].shape == (B, C) and got[k].is_contiguous(), k
        assert torch.equal(got[k], want[k]), k
        assert torch.equal(got[k], again[k]), k


def test_score_candidates_wide_state_bit_equal(dev):
    """Scores too large for the kernel's 32-bit packed state (match 20000,
    mismatch -30000) take its 64-bit form: all five outputs bit-equal."""
    rng = np.random.default_rng(17)
    G, B, C, L = 20_000, 300, 8, 101
    flat = np.full(G + 256, 4, np.int8)
    flat[:G] = rng.integers(0, 4, G)
    starts = rng.integers(0, G - L - 1, B)
    reads = np.stack([flat[s : s + L] for s in starts])
    reads[rng.random((B, L)) < 0.03] = 0
    cand = rng.integers(0, G - L - 1, (B, C)).astype(np.int32)
    cand[:, ::3] = starts[:, None]
    args = (torch.as_tensor(flat, device=dev),
            torch.as_tensor(reads, device=dev),
            torch.as_tensor(cand, device=dev), 20000, -30000, 4)
    got, once = _launched("align_score",
                          lambda: align_score.score_candidates(*args))
    assert once
    want = align_score.score_candidates_plain(*args)
    for k in ("local", "e2e", "start", "end", "n_mis"):
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("m", [None, 6])
@pytest.mark.parametrize("R", [1024, 3072])
def test_counts_unmapped_full_width(dev, R, m):
    """K4 and K1 at the unmapped mode's full width: R reads (the 1,024 and
    3,072 read buckets) at every position of W = L + 512 + L; zeros equal,
    repeats bit-equal."""
    L = 101
    _counts_on_card(dev, 34, 2, R, L + 512, L, 2 * L + 512, m, False)


def test_band_hard_reverse_strand_full_width(dev):
    """K3's gap-string form with the reverse strand's factors (the unmapped
    hard pass scores every read with both strands' factors) at full width,
    bit-equal to the K form, and K2 beside it."""
    L, Wp = 101, 101 + 512
    codes, valid, probs, eprobs, e_pos, _, g, a, b, ln_et = _band_inputs(
        dev, 17, 2, 1024, L, Wp)
    a, b, e_pos = a.flip(0), b.flip(0), e_pos.flip(0)
    got, once = _launched("band_hard", lambda: band.band_score_hard(
        codes, valid, g, a, b, ln_et, Wp))
    assert once
    assert torch.equal(got, band.band_score(
        codes, valid, band.hard_K(g, a, b, ln_et), Wp))
    _close(got, band.band_score_hard_plain(codes, valid, g, a, b, ln_et, Wp),
           1e-5, 1e-4)
    got, once = _launched("band_soft", lambda: band.band_score_soft(
        codes, valid, probs, eprobs, e_pos, Wp))
    assert once
    _close(got, band.band_score_soft_plain(codes, valid, probs, eprobs,
                                           e_pos, Wp), 1e-5, 1e-3)


def test_e2e_align_batch_card_equals_cpu(dev):
    """The end-to-end preset's ``align_batch`` on the card equals the same
    on the CPU: every output and the packed words."""
    from figbird_tpu_torch.align import core
    from figbird_tpu_torch.align.index import build_device_tables, \
        build_index
    from figbird_tpu_torch.simulate import SimConfig, simulate

    sim = simulate(SimConfig(genome_len=30_000, n_contigs=2, n_gaps=4,
                             read_len=101, coverage=6, indel_rate=0.05,
                             seed=11))
    idx = build_index(sim.draft, k=15, device_tables=True)
    p = core.e2e_params(core.AlignParams(want_mism=True))
    reads, lens = sim.reads1.seq[:2048], sim.reads1.length[:2048]
    outs = []
    for d in (dev, torch.device("cpu")):
        tables, _ = build_device_tables(idx.flat, idx.k, idx.prefix_bases, d)
        out = core.align_batch(
            torch.as_tensor(core.as_rows(idx.flat), device=d),
            len(idx.flat), tables, torch.as_tensor(reads, device=d),
            torch.as_tensor(lens.astype(np.int32), device=d), idx.k, p,
            2 * (idx.k - idx.prefix_bases))
        outs.append({k: v.cpu() for k, v in out.items()})
    gpu, cpu = outs
    assert sorted(gpu) == sorted(cpu)
    for k in cpu:
        assert torch.equal(gpu[k], cpu[k]), k
    assert not cpu["aligned"].all() and cpu["aligned"].any()


def _bonus_saved(out):
    """The overlap bonus's three outputs as one f32 tensor (3, I)."""
    bonus, saved_l, saved_r = out
    return torch.stack([bonus, saved_l.float(), saved_r.float()])


def _overlap_equal(batch):
    """The kernel (one launch, outputs on the batch's device, their types)
    bit-equal to the plain version on the same tensors; a second launch
    bit-equal to the first."""
    got, once = _launched("overlap", lambda: overlap.overlap_bonus(*batch))
    assert once
    want = overlap.overlap_bonus_plain(*batch)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.device == w.device
        assert torch.equal(g, w), (g, w)
    again = overlap.overlap_bonus(*batch)
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    return want


# (I, P, L, bonus_cap): the main path's instance batch (495 x 128 x 101,
# cap 24) and its short-read and read-order (cap = P) forms, one instance,
# the 1,024-read bucket capped and in read order
OVERLAP_SHAPES = [(495, 128, 101, 24), (495, 128, 24, 24),
                  (495, 128, 101, 128), (1, 128, 101, 24), (1, 128, 24, 128),
                  (8, 1024, 101, 24), (1, 1024, 101, 1024),
                  (1, 1024, 24, 24)]


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("I,P,L,cap", OVERLAP_SHAPES)
def test_overlap_bit_equal_to_plain(dev, I, P, L, cap, ties):
    """The overlap-bonus kernel bit-equal to its plain version on random
    batches (test_torch_overlap.overlap_batch: left, right, spanning and
    soft-clipped reads, reads with many errors, rejected reads, padded
    lanes, side limits 3, 4, 7, 8 and more, contig ends), with and without
    ties in the candidate lists' keys."""
    _overlap_equal(overlap_batch(31 + P + L + cap, I, P, L, cap, device=dev,
                                 ties=ties))


def test_overlap_at_the_thresholds(dev):
    """Mismatches exactly at 0.1 cmp_len (cmp_len 10, 20, 30, 70) and one
    past it, with plain and soft-clipped right reads, flank lengths of 3:
    the kernel's f32 comparisons are the plain version's."""
    bonus, _, _ = _overlap_equal(threshold_batch(dev))
    assert (bonus > 0).sum() == 8 and (bonus == -100).sum() == 8


@pytest.mark.parametrize("fill_kwargs", [{}, {"reference_exact": True}])
def test_overlap_on_a_partial_pass(dev, monkeypatch, fill_kwargs):
    """Every instance batch a p-iteration of a small simulated draft hands
    the overlap bonus: the kernel bit-equal to the plain version on it.
    At the default (the exact cascade), the kernel launches once a pass,
    and K1 twice: half of K1's launches."""
    from figbird_tpu_torch import config, simulate
    from figbird_tpu_torch.fill import em
    from figbird_tpu_torch.pipeline import Pipeline

    sim = simulate.simulate(simulate.SimConfig(
        genome_len=60_000, n_contigs=1, n_gaps=6, gap_len_range=(8, 60),
        read_len=101, insert_mean=200, insert_sd=20, coverage=15,
        error_rate=0.005, seed=3))
    cfg = config.FigbirdConfig(
        draft_genome="", output_folder="",
        read_pairs=[config.ReadLibrary("", "", avg_insert_size=200,
                                       max_read_length=101)],
        parameters=config.Parameters(trim_len=0))
    seen = []

    def checked(*batch):
        seen.append(batch[1]["pr"].shape)
        return _overlap_equal(batch)

    monkeypatch.setattr(em, "overlap_bonus", checked)
    ops.reset_launches()
    st = Pipeline(cfg, sim.draft, [(sim.reads1, sim.reads2)],
                  fill_kwargs=fill_kwargs, aligner_kwargs={"batch_size": 4096},
                  device=dev).run_iteration("p", 0)
    assert seen and st.n_after < st.n_before
    # _overlap_equal launches twice a call
    assert ops.LAUNCHES["overlap"] == 2 * len(seen)
    if not fill_kwargs:
        assert 2 * len(seen) == ops.LAUNCHES["cascade"]


def _each_kernel(dev):
    """Every wrapper once on ``dev`` at a small shape: (name, kernel
    output, plain version's output)."""
    codes, valid, probs, eprobs, e_pos, K, g, a, b, ln_et = _band_inputs(
        dev, 21, 2, 9, 12, 16)
    lw, ccodes, vals = (torch.as_tensor(t, device=dev) for t in count_inputs(
        22, 2, 9, 16, 12, False, True))
    x = torch.as_tensor(count_inputs(22, 2, 9, 16, 12, False, False)[0],
                        device=dev)
    W = 16 + 12
    rng = np.random.default_rng(23)
    flat = torch.as_tensor(rng.integers(0, 5, 4000).astype(np.int8),
                           device=dev)
    reads = torch.as_tensor(rng.integers(0, 5, (10, 30)).astype(np.int8),
                            device=dev)
    cand = torch.as_tensor(rng.integers(0, 3900, (10, 4)).astype(np.int32),
                           device=dev)
    ov = overlap_batch(25, 3, 16, 24, 4, device=dev)
    return [
        ("band_soft", band.band_score_soft(codes, valid, probs, eprobs, e_pos,
                                           16),
         band.band_score_soft_plain(codes, valid, probs, eprobs, e_pos, 16)),
        ("band_hard", band.band_score_hard(codes, valid, g, a, b, ln_et, 16),
         band.band_score_hard_plain(codes, valid, g, a, b, ln_et, 16)),
        ("fold", band.fold_counts(x, ccodes, vals, W),
         band.fold_counts_plain(x, ccodes, vals, W)),
        ("cascade", band.cascade_counts(lw, ccodes, vals, W, 6, SHIFT, CUT),
         band.cascade_counts_plain(lw, ccodes, vals, W, 6, SHIFT, CUT)),
        ("align_score",
         align_score.score_candidates(flat, reads, cand, 2, -6, 4)["local"],
         align_score.score_candidates_plain(flat, reads, cand, 2, -6,
                                            4)["local"]),
        ("overlap", _bonus_saved(overlap.overlap_bonus(*ov)),
         _bonus_saved(overlap.overlap_bonus_plain(*ov))),
    ]


def test_kernels_launch_on_the_tensors_device():
    """Each kernel on the last card while the first is current: it launches
    there (under ``torch.cuda.device`` of its tensors: the launcher's
    attributes and stream belong to that card), agrees with its plain
    version, and leaves the current device as it was.  Needs two cards."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    dev = torch.device("cuda", torch.cuda.device_count() - 1)
    torch.cuda.set_device(0)
    before = dict(ops.LAUNCHES)
    tol = {"band_soft": (1e-5, 1e-3), "band_hard": (1e-5, 1e-4),
           "fold": (2e-6, 0.0), "cascade": (2e-6, 0.0),
           "align_score": (0.0, 0.0), "overlap": (0.0, 0.0)}
    for name, got, want in _each_kernel(dev):
        torch.cuda.synchronize(dev)
        assert got.device == dev, name
        _close(got, want, *tol[name])
    assert {k: ops.LAUNCHES[k] - before[k] for k in before} == {
        k: 1 for k in before}
    assert torch.cuda.current_device() == 0


def test_wrappers_refuse_mixed_devices(dev):
    """A wrapper given tensors on the card and on the CPU raises
    ``ValueError`` before it launches anything."""
    before = dict(ops.LAUNCHES)
    codes, valid, probs, eprobs, e_pos, K, g, a, b, ln_et = _band_inputs(
        dev, 24, 1, 4, 8, 8)
    cfg, inst, accept, pos_gap = overlap_batch(26, 2, 8, 24, 4, device=dev)
    for call in (
            lambda: band.band_score_soft(codes, valid.cpu(), probs, eprobs,
                                         e_pos, 8),
            lambda: band.band_score(codes, valid, K.cpu(), 8),
            lambda: band.band_score_hard(codes, valid, g, a, b, ln_et.cpu(),
                                         8),
            lambda: band.fold_counts(K[:, :4, :12].cpu(), codes, valid.float(),
                                     19),
            lambda: band.cascade_counts(K[:, :4, :12], codes.cpu(),
                                        valid.float(), 19, 2, SHIFT, CUT),
            lambda: align_score.score_candidates(
                torch.zeros(300, dtype=torch.int8, device=dev),
                codes[0].cpu(), torch.zeros((4, 2), dtype=torch.int32,
                                            device=dev), 2, -6, 4),
            lambda: overlap.overlap_bonus(cfg, inst, accept.cpu(), pos_gap)):
        with pytest.raises(ValueError, match="more than one device"):
            call()
    assert dict(ops.LAUNCHES) == before


@pytest.mark.parametrize("path", ["code", "contig"])
def test_sharded_aligners_on_repeated_card(dev, path):
    """Both genome-sharded aligners on a mesh of 8 x ``cuda:0`` (reads 2,
    genome 4; the shards run one after another on the card) equal the
    replicated ``use_buckets=False`` aligner on the card, local and
    end-to-end; K5 launched for every shard and strand."""
    from figbird_tpu_torch.align import core
    from figbird_tpu_torch.align.index import build_index
    from figbird_tpu_torch.parallel import make_mesh
    from figbird_tpu_torch.simulate import SimConfig, simulate

    sim = simulate(SimConfig(genome_len=80_000, n_contigs=6, n_gaps=4,
                             read_len=76, insert_mean=250, insert_sd=20,
                             coverage=3.0, error_rate=0.004, seed=17))
    idx = build_index(sim.draft, k=15)
    r = sim.reads1
    mesh = make_mesh(8, 4, devices=[dev] * 8)
    for p in (core.AlignParams(), core.e2e_params(core.AlignParams())):
        kw = dict(batch_size=1024, two_tier=False, indel_tier=False)
        before = ops.LAUNCHES["align_score"]
        out_sh = core.Aligner(idx, p, mesh=mesh, genome_shard=path,
                              contig_shard_threshold=1, **kw).align(
            r.seq, r.length)
        # one batch of two reads shards, four genome shards, two strands
        assert ops.LAUNCHES["align_score"] - before == 2 * 4 * 2
        out_ref = core.Aligner(idx, p, use_buckets=False, device=dev,
                               **kw).align(r.seq, r.length)
        for k in ("score", "aligned", "unique", "second"):
            np.testing.assert_array_equal(out_sh[k], out_ref[k], err_msg=k)
        al = out_ref["aligned"] | (out_ref["score"] > -32000)
        for k in ("pos", "strand", "clip_start", "clip_end", "n_mis", "alen",
                  "mism"):
            np.testing.assert_array_equal(out_sh[k][al], out_ref[k][al],
                                          err_msg=k)
