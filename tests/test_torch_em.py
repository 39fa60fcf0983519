"""The port's batched partial EM against figbird_tpu.fill.em on the same
instances, at each soft-count depth: plain f32 (``exact_soft=False``), the
exact 6-level cascade (``exact_soft=True``, the production default) and the
3-level mini-cascade (``soft_levels=3``)."""

import contextlib
from dataclasses import replace

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from __graft_entry__ import _tiny_fill_setup
from figbird_tpu.fill import em as r_em
from figbird_tpu_torch import convert
from figbird_tpu_torch.fill import em as t_em

torch.set_num_threads(2)

DEPTHS = {"plain_f32": dict(exact_soft=False),
          "exact": dict(exact_soft=True),
          "mini3": dict(soft_levels=3)}


@contextlib.contextmanager
def xla_cpu_float_mode():
    """XLA's CPU runtime flushes f32 denormals to zero (its ``exp`` returns
    0 below e^-87.34); inside this block PyTorch's CPU ops do the same, so
    the cascade's deep levels compare like with like."""
    if not torch.set_flush_denormal(True):
        pytest.skip("this CPU cannot flush denormals")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the mode is the calling thread's own
    try:
        yield
    finally:
        torch.set_num_threads(threads)
        torch.set_flush_denormal(False)


@pytest.fixture(scope="module")
def setup():
    return _tiny_fill_setup()


@pytest.fixture(scope="module", params=list(DEPTHS))
def both(request, setup):
    cfg, insts, marr = setup
    cfg = replace(cfg, **DEPTHS[request.param])
    ref = {k: np.array(v)
           for k, v in r_em.fill_batch(cfg, insts, marr).items()}
    tcfg = convert.fill_config(cfg)
    tinsts = convert.to_tensors(insts)
    tmarr = convert.to_tensors(marr)
    with xla_cpu_float_mode():
        got = {k: v.numpy() for k, v in t_em.fill_batch(tcfg, tinsts,
                                                        tmarr).items()}
    return cfg, insts, marr, ref, got, tcfg, tinsts, tmarr


def test_fill_batch_matches_reference(both):
    _, _, _, ref, got, _, _, _ = both
    for k in ("consensus", "accept", "pos", "valid", "saved_l", "saved_r",
              "left_max", "right_min", "prec"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    np.testing.assert_allclose(got["counts"], ref["counts"], rtol=2e-6,
                               atol=0)
    np.testing.assert_allclose(got["likelihood"], ref["likelihood"],
                               rtol=1e-6)
    assert ref["accept"].any()


def test_finalize_matches_reference(both):
    """Finalize against the EM consensus: hard placement (K3), hard counts
    and quality-weighted counts (K4)."""
    cfg, insts, marr, ref, _, tcfg, tinsts, tmarr = both
    saved = np.zeros((len(ref["consensus"]), cfg.R), np.int8)
    fin = r_em.finalize_batch(cfg, insts, marr, ref["consensus"], saved,
                              ref["saved_l"], ref["saved_r"])
    got = t_em.finalize_partial_instance(
        tcfg, tinsts, tmarr, torch.as_tensor(ref["consensus"]),
        torch.as_tensor(ref["saved_l"]), torch.as_tensor(ref["saved_r"]))
    for k in ("accept", "pos", "used"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(fin[k]),
                                      err_msg=k)
    for k in ("counts", "qual"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(fin[k]),
                                   rtol=2e-6, atol=0, err_msg=k)


def test_finalize_batch_matches_reference(both):
    """The public ``fill.finalize_batch`` (the reference's signature) in
    partial mode against the reference's: every output."""
    from figbird_tpu_torch.fill import finalize_batch

    cfg, insts, marr, ref, _, tcfg, tinsts, tmarr = both
    saved = np.zeros((len(ref["consensus"]), cfg.R), np.int8)
    fin = r_em.finalize_batch(cfg, insts, marr, ref["consensus"], saved,
                              ref["saved_l"], ref["saved_r"])
    got = finalize_batch(tcfg, tinsts, tmarr,
                         *map(torch.as_tensor, (ref["consensus"], saved,
                                                ref["saved_l"],
                                                ref["saved_r"])))
    assert sorted(got) == sorted(fin)
    for k in fin:
        if k in ("counts", "qual"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(fin[k]),
                                       rtol=2e-6, atol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(fin[k]),
                                          err_msg=k)
    assert np.asarray(fin["leftcount"]).any() and np.asarray(fin["used"]).any()


@pytest.mark.parametrize("depth", list(DEPTHS))
def test_accumulate_logw_full_width(setup, depth):
    """The full-width soft accumulate (the unmapped mode's form): level
    weights, per-row level selection and the deepest level's row totals,
    with log-weights that reach every cascade level."""
    cfg = replace(setup[0], **DEPTHS[depth])
    rng = np.random.default_rng(9)
    N = 12
    logw = rng.uniform(-900.0, 0.0, (N, cfg.Wp)).astype(np.float32)
    logw[:, ::3] -= 400.0  # columns only the deep levels see
    legal = rng.random((N, cfg.Wp)) < 0.7
    codes = rng.integers(0, 5, (N, cfg.L)).astype(np.int8)
    jv = rng.random((N, cfg.L)) < 0.9
    oh_c = r_em._oh_flat_c(jnp.asarray(codes), jnp.asarray(jv))
    want, want_deep = r_em._accumulate_logw(
        jnp.asarray(logw), jnp.asarray(legal), oh_c, cfg)
    tiny = np.finfo(np.float32).tiny
    for k in range(r_em._soft_m(cfg)):
        wk = np.asarray(r_em._level_weight(jnp.asarray(logw),
                                           jnp.asarray(legal), k))
        got_k = t_em._level_weight(torch.as_tensor(logw),
                                   torch.as_tensor(legal), k).numpy()
        # equal where XLA's CPU exp gives a normal number; where it flushed
        # a denormal to 0 the port keeps the denormal
        np.testing.assert_allclose(got_k[wk != 0], wk[wk != 0], rtol=2e-7,
                                   atol=0)
        assert (got_k[wk == 0] < tiny).all()
    with xla_cpu_float_mode():
        got, got_deep = t_em._accumulate_logw(
            torch.as_tensor(logw)[None], torch.as_tensor(legal)[None],
            torch.as_tensor(codes)[None],
            torch.as_tensor(jv.astype(np.float32))[None],
            convert.fill_config(cfg))
    np.testing.assert_allclose(got.numpy()[0], np.asarray(want), rtol=2e-6,
                               atol=0)
    np.testing.assert_allclose(got_deep.numpy()[0], np.asarray(want_deep),
                               rtol=2e-6, atol=0)
    np.testing.assert_array_equal(got.numpy()[0] == 0.0,
                                  np.asarray(want) == 0.0)


@pytest.mark.parametrize("depth", ["exact", "mini3"])
def test_soft_counts_banded_select_levels(setup, depth):
    """The banded cascade: the level is chosen per ASSEMBLED row (both
    bands' totals added first), then the band-locally picked counts are
    assembled once.  Log-weights over [-900, 0] make rows pick every
    level; the right band overlaps the left one."""
    cfg = replace(setup[0], **DEPTHS[depth])
    rng = np.random.default_rng(10)
    I, N, bw = 3, 10, 128
    logw = rng.uniform(-900.0, 0.0, (2, I, N, bw)).astype(np.float32)
    logw[:, :, :, ::2] -= 300.0
    legal = rng.random((2, I, N, bw)) < 0.6
    p0r = np.array([0, 7, cfg.W - (bw + cfg.L)], np.int32)
    codes = rng.integers(0, 5, (I, N, cfg.L)).astype(np.int8)
    jv = rng.random((I, N, cfg.L)) < 0.9
    with xla_cpu_float_mode():
        got, got_deep = t_em._soft_counts_banded(
            torch.as_tensor(logw[0]), torch.as_tensor(legal[0]),
            torch.as_tensor(logw[1]), torch.as_tensor(legal[1]),
            torch.as_tensor(p0r), torch.as_tensor(codes),
            torch.as_tensor(jv.astype(np.float32)), convert.fill_config(cfg))
    cfg1 = replace(cfg, exact_soft=False, soft_levels=1)
    shallow = deeper = 0
    for i in range(I):
        oh_c = r_em._oh_flat_c(jnp.asarray(codes[i]), jnp.asarray(jv[i]))
        want, want_deep = r_em._soft_counts_banded(
            jnp.asarray(logw[0, i]), jnp.asarray(legal[0, i]),
            jnp.asarray(logw[1, i]), jnp.asarray(legal[1, i]),
            jnp.int32(p0r[i]), oh_c, cfg)
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want),
                                   rtol=2e-6, atol=0)
        np.testing.assert_allclose(got_deep[i].numpy(),
                                   np.asarray(want_deep), rtol=2e-6, atol=0)
        np.testing.assert_array_equal(got[i].numpy() == 0.0,
                                      np.asarray(want) == 0.0)
        _, tot0 = r_em._soft_counts_banded(
            jnp.asarray(logw[0, i]), jnp.asarray(legal[0, i]),
            jnp.asarray(logw[1, i]), jnp.asarray(legal[1, i]),
            jnp.int32(p0r[i]), oh_c, cfg1)
        covered = np.asarray(want).sum(-1) > 0
        shallow += int((np.asarray(tot0)[covered] > r_em._CASCADE_TAU).sum())
        deeper += int((np.asarray(tot0)[covered] <= r_em._CASCADE_TAU).sum())
    assert shallow and deeper  # rows took level 0 and rows took deeper ones


def test_unported_configs_raise(setup):
    """Both modes are ported; a configuration that sets both mode flags, or
    neither, is refused."""
    cfg, insts, marr = setup
    for partial, unmapped in ((True, True), (False, False)):
        bad = replace(convert.fill_config(cfg), partial_mode=partial,
                      unmapped_mode=unmapped)
        with pytest.raises(ValueError, match="exactly one"):
            t_em.fill_batch(bad, convert.to_tensors(insts),
                            convert.to_tensors(marr))
