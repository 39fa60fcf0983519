"""The generator: each configuration's simulation repeats per seed, differs
across seeds, keeps one set of gap lengths for every seed, and without
``size_seed`` is the port's simulator draw for draw."""

import json
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest

from port_bench.traffic import sim as simmod

CONFIGS = sorted((Path(__file__).resolve().parents[1] / "configs")
                 .glob("*.json"))


def small(path: Path, seed: int) -> simmod.SimConfig:
    """The configuration at a hundredth of its genome (gaps and repeats
    scaled alike), every width as it is."""
    cfg = simmod.sim_config(json.loads(path.read_text()), seed)
    return replace(cfg, genome_len=cfg.genome_len // 100,
                   n_gaps=max(1, cfg.n_gaps // 100),
                   repeat_count=cfg.repeat_count // 100)


def gap_lengths(s) -> list:
    return sorted(int(n) for c in s.draft
                  for n in np.diff(np.flatnonzero(np.diff(np.r_[0, c == 4, 0])))[::2])


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.stem)
def test_generator_repeats_per_seed_and_differs_across_seeds(path):
    a, b = simmod.simulate(small(path, 7)), simmod.simulate(small(path, 7))
    c = simmod.simulate(small(path, 2**31 + 5))
    for x, y in ((a.seq1, b.seq1), (a.seq2, b.seq2), (a.true_pos, b.true_pos)):
        assert np.array_equal(x, y)
    assert all(np.array_equal(x, y) for x, y in zip(a.draft, b.draft))
    assert not np.array_equal(a.seq1, c.seq1)
    assert not all(np.array_equal(x, y) for x, y in zip(a.truth, c.truth))
    assert a.seq1.shape == c.seq1.shape


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.stem)
def test_every_seed_gets_the_same_layout(path):
    """``size_seed`` fixes the gap lengths and where gaps and repeats lie;
    the seed draws the bases and the reads."""
    cfg = small(path, 3)
    size_rng = np.random.default_rng(cfg.size_seed)
    want = [simmod._gap_length(size_rng, cfg) for _ in range(cfg.n_gaps)]
    first = simmod.simulate(cfg)
    assert sum(int((c == 4).sum()) for c in first.draft) == sum(want)
    for seed in (4, 123456789012):
        s = simmod.simulate(replace(cfg, seed=seed))
        assert all(np.array_equal(a == 4, b == 4)
                   for a, b in zip(first.draft, s.draft))
        assert gap_lengths(s) == gap_lengths(first)
        assert not np.array_equal(s.truth[0], first.truth[0])


def test_without_size_seed_it_is_the_ports_simulator():
    from figbird_tpu_torch import simulate as port

    cfg = simmod.SimConfig(genome_len=30_000, n_contigs=2, n_gaps=6,
                           gap_len_range=(10, 120), gap_len_tail=0.3,
                           repeat_count=2, read_len=101, insert_mean=200,
                           insert_sd=20, coverage=4.0, seed=11)
    got = simmod.simulate(cfg)
    want = port.simulate(port.SimConfig(**{
        k: v for k, v in vars(cfg).items() if k != "size_seed"}))
    assert all(np.array_equal(x, y) for x, y in
               zip(got.draft, want.draft.contigs))
    assert all(np.array_equal(x, y) for x, y in
               zip(got.truth, want.truth.contigs))
    assert np.array_equal(got.seq1, want.reads1.seq)
    assert np.array_equal(got.seq2, want.reads2.seq)
    assert np.array_equal(got.qual, want.reads1.qual)
    assert np.array_equal(got.true_pos, want.true_pos)
