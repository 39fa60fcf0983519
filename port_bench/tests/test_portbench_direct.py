"""The plain reference (``port_bench/reference/direct.py``) against the
port's own plain versions of the same steps, at small random shapes: the
two agree (float64 loops against the port's float32 matmuls) to rounding,
and the TF32 control is further off than any limit the cells set."""

import numpy as np
import pytest
import torch

from port_bench.reference import direct

I, P, L, Wp = 3, 16, 21, 24
R = Wp + L - 1


@pytest.fixture
def g():
    return torch.Generator().manual_seed(11)


def rel(got, want, floor):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float((np.abs(got - want) / np.maximum(np.abs(want), floor)).max())


def reads(g):
    codes = torch.randint(0, 5, (I, P, L), generator=g, dtype=torch.int8)
    valid = torch.rand(I, P, L, generator=g) < 0.9
    return codes, valid


def test_soft_scores(g):
    from figbird_tpu_torch.ops.band import band_score_soft_plain

    codes, valid = reads(g)
    A = torch.softmax(torch.randn(I, R, 5, generator=g), -1)
    A[..., 4] = 0
    B = torch.rand(I, R, 5, generator=g) * 0.01
    e = torch.rand(L, generator=g) * 0.05
    port = band_score_soft_plain(codes, valid, A, B, e, Wp)
    for i in range(I):
        args = (codes[i].numpy(), valid[i].numpy(), A[i].numpy(),
                B[i].numpy(), e.numpy(), Wp)
        assert rel(port[i], direct.soft_scores(*args), 1.0) < 1e-5
        assert rel(direct.soft_scores(*args, tf=True),
                   direct.soft_scores(*args), 1.0) > 1e-4


def test_hard_scores(g):
    from figbird_tpu_torch.ops.band import band_score_hard_plain

    codes, valid = reads(g)
    gs = torch.randint(0, 6, (I, R), generator=g, dtype=torch.int8)
    a = -torch.rand(L, generator=g) * 0.01
    b = -3 - torch.rand(L, generator=g)
    ln_et = torch.log(torch.rand(5, 5, generator=g) + 0.01)
    port = band_score_hard_plain(codes, valid, gs, a, b, ln_et, Wp)
    for i in range(I):
        args = (codes[i].numpy(), valid[i].numpy(), gs[i].numpy(), a.numpy(),
                b.numpy(), ln_et.numpy(), Wp)
        assert rel(port[i], direct.hard_scores(*args), 1.0) < 1e-5
        assert rel(direct.hard_scores(*args, tf=True),
                   direct.hard_scores(*args), 1.0) > 1e-4


def test_fold_and_cascade_counts(g):
    from figbird_tpu_torch.ops.band import (MASKED, cascade_counts_plain,
                                            fold_counts_plain)

    codes, _ = reads(g)
    vals = torch.rand(I, P, L, generator=g)
    W = Wp + L - 1
    w = torch.rand(I, P, Wp, generator=g)
    port = fold_counts_plain(w, codes, vals, W)
    lw = torch.randn(I, P, Wp, generator=g) * 60 - 100
    lw[torch.rand(I, P, Wp, generator=g) < 0.2] = MASKED
    cas = cascade_counts_plain(lw, codes, vals, W, 6, 40.0, 78.0)
    for i in range(I):
        f = (codes[i].numpy(), vals[i].numpy(), W)
        want = direct.fold_counts(w[i].numpy(), *f)
        assert rel(port[i], want, 1e-30) < 1e-5
        assert rel(direct.fold_counts(w[i].numpy(), *f, tf=True), want,
                   1e-30) > 1e-4
        want = direct.cascade_counts(lw[i].numpy(), *f, 6, 40.0, 78.0)
        assert rel(cas[i], want, 1e-30) < 1e-5
        # what the reference zeroes (masked, or past the cut) the port does
        assert (np.asarray(cas[i])[want == 0] == 0).all()


def test_score_candidates_exact(g):
    from figbird_tpu_torch.ops.align_score import score_candidates_plain

    flat = torch.randint(0, 6, (4000,), generator=g, dtype=torch.int8)
    rd = torch.randint(0, 5, (40, 101), generator=g, dtype=torch.int8)
    rd[:, -3:] = 5
    cand = torch.randint(0, 4000 - 102, (40, 8), generator=g,
                         dtype=torch.int32)
    cand[:5, 0] = 7
    rd[:5] = flat[7:108]
    port = score_candidates_plain(flat, rd, cand, 2, -6, 5)
    win = flat[cand.long()[..., None] + torch.arange(101)].numpy()
    want = direct.score_candidates(win, rd.numpy(), 2, -6, 5)
    for k, v in want.items():
        assert np.array_equal(np.asarray(port[k], np.int64), v), k


def test_consensus_exact(g):
    from figbird_tpu_torch.fill.em import consensus_from_counts

    counts = torch.randint(0, 3, (I, 30, 5), generator=g).float()
    zone = torch.rand(I, 30, generator=g) < 0.8
    for check, cov in ((0, 0.0), (1, 1.0)):
        cons, _ = consensus_from_counts(counts, zone, check, cov)
        for i in range(I):
            want, _ = direct.consensus(counts[i].numpy(), zone[i].numpy(),
                                       check, cov)
            assert np.array_equal(cons[i].numpy(), want)


def test_splice_exact():
    from figbird_tpu_torch.genome import Genome

    rng = np.random.default_rng(3)
    contigs = []
    for n in (300, 200):
        c = rng.integers(0, 4, n).astype(np.int8)
        c[20:30] = 4
        c[100:101] = 4
        c[-5:] = 4                                   # not a gap
        contigs.append(c)
    g = Genome(["a", "b"], contigs)
    gaps = g.find_gaps()
    fills = [rng.integers(0, 5, int(rng.integers(0, 15))).astype(np.int8)
             for _ in gaps]
    skips = [0, 2, 0, 1]
    want = g.splice_gaps(gaps, fills, skips).contigs
    got = direct.splice(contigs, fills, skips)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))


def test_tf32_rounds_to_ten_bits():
    x = np.array([1.0 + 2**-11, 1.0 + 2**-10 + 2**-12, 3.0], np.float32)
    assert direct.tf32(x).tolist() == [1.0 + 2**-10, 1.0 + 2**-10, 3.0]
