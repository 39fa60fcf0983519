"""The roofline functions against PERF.md's kernel table (its "Bound ms"
column, from ``chip_smoke.py``'s kernels phase), at the table's shapes and on
inputs drawn as that phase draws them (here on the CPU, so the
data-dependent operation counts agree to the table's rounding, not the
digit)."""

import pytest
import torch

from port_bench.harness import registry
from port_bench.roofline import _peaks

OPS = registry.roofline_ops()
I, P, L, BW = 495, 128, 101, 128          # the scan batch of the 128 bucket
SHIFT, CUT = 140.0, 78.0          # fill.em._CASCADE_SHIFT, _CASCADE_CUT


def bound_ms(n_bytes, n_ops):
    return max(float(n_bytes) / _peaks.BYTES_S,
               float(n_ops) / _peaks.OPS_S) * 1e3


@pytest.fixture(scope="module")
def g():
    return torch.Generator().manual_seed(0)


def rand(g, *shape):
    return torch.rand(*shape, generator=g)


def reads(g, n):
    codes = torch.randint(0, 4, (n, P, L), generator=g, dtype=torch.int8)
    codes[rand(g, n, P, L) < 0.01] = 4
    plen = torch.randint(40, L + 1, (n, P, 1), generator=g)
    return codes, plen


def test_every_op_of_the_port_has_a_file():
    assert set(OPS) == {"cascade_counts", "band_score_soft",
                        "band_score_hard", "fold_counts", "score_candidates"}


def test_k1_cascade(g):
    from figbird_tpu_torch.fill import em

    assert (em._CASCADE_SHIFT, em._CASCADE_CUT) == (SHIFT, CUT)
    lw = rand(g, I, P, BW) * -900.0
    lw[rand(g, I, P, BW) < 0.3] = -1e30
    codes, plen = reads(g, I)
    vals = (torch.arange(L) < plen).to(torch.float32)
    n_b, n_o = OPS["cascade_counts"].count(lw, codes, vals, BW + L, 6,
                                           SHIFT, CUT)
    assert round(n_b / 1e6, 1) == 78.0
    assert round(float(n_o) / 1e9, 2) == pytest.approx(0.91)
    assert round(bound_ms(n_b, n_o), 4) == 0.0233


def band_inputs(g):
    R = BW + L - 1
    codes, plen = reads(g, I)
    j = torch.arange(L)
    valid = (j < plen) & (j >= 2)
    probs = rand(g, I, R, 5)
    eprobs = rand(g, I, R, 5) * 1e-2
    gap = torch.randint(0, 4, (I, R), generator=g, dtype=torch.int8)
    return codes, valid, probs, eprobs, rand(g, L) * 1e-2, gap


def test_k2_k3_bands(g):
    codes, valid, probs, eprobs, e_pos, gap = band_inputs(g)
    n_b, n_o = OPS["band_score_soft"].count(codes, valid, probs, eprobs,
                                            e_pos, BW)
    assert round(n_b / 1e6, 1) == 49.8
    assert round(float(n_o) / 1e9, 2) == pytest.approx(0.78, abs=0.011)
    assert round(bound_ms(n_b, n_o), 4) == 0.0149
    a, b, ln_et = -rand(g, L) * 0.1, -2.0 - 4.0 * rand(g, L), rand(g, 5, 5)
    n_b, n_o = OPS["band_score_hard"].count(codes, valid, gap, a, b, ln_et,
                                            BW)
    assert round(n_b / 1e6, 1) == 45.4
    assert round(float(n_o) / 1e9, 2) == pytest.approx(0.61, abs=0.011)
    assert round(bound_ms(n_b, n_o), 4) == 0.0135


def test_k4_fold_at_the_finalize_batch(g):
    n = 64
    codes, plen = reads(g, n)
    vals = (torch.arange(L) < plen).to(torch.float32)
    w = torch.where(rand(g, n, P, BW) < 0.5, 0.0, rand(g, n, P, BW))
    n_b, n_o = OPS["fold_counts"].count(w, codes, vals, BW + L)
    assert round(n_b / 1e6, 1) == 8.6
    assert round(float(n_o) / 1e9, 3) == pytest.approx(0.074, abs=0.0011)
    assert round(bound_ms(n_b, n_o), 4) == 0.0026


@pytest.mark.parametrize("C,mb,gops,ms", [(8, 14.2, 0.079, 0.0042),
                                          (32, 33.1, 0.318, 0.0099)])
def test_k5_candidates(g, C, mb, gops, ms):
    """``time_align.align_inputs``' genome (4.6 Mb, 1 in 230 an N) and
    candidates: at C = 8 the main path's mix, at C = 32 scattered."""
    G, B = 4_600_000, 32768
    flat = torch.full(((G + 127) // 128 * 128 + 256,), 4, dtype=torch.int8)
    flat[:G] = torch.randint(0, 4, (G,), generator=g, dtype=torch.int8)
    starts = torch.randint(0, G - L - 1, (B,), generator=g)
    rd = flat[starts[:, None] + torch.arange(L)].clone()
    cand = torch.randint(0, G - L - 1, (B, C), generator=g,
                         dtype=torch.int32)
    if C == 8:
        cand[rand(g, B, C) < 0.125] = 0
        cand[:, C // 2] = starts.to(torch.int32)
    cand[:, 0] = starts.to(torch.int32)
    n_b, n_o = OPS["score_candidates"].count(flat, rd, cand, 2, -6, 4)
    assert float(n_b) / 1e6 == pytest.approx(mb, abs=0.06)
    assert round(n_o / 1e9, 3) == gops
    assert round(bound_ms(n_b, n_o), 4) == ms
