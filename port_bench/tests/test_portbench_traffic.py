"""The generator: each configuration's simulation repeats per seed, differs
across seeds, keeps one set of gap lengths for every seed, and without
``size_seed`` is the port's simulator draw for draw.  Further libraries
leave library 0 as it was, draw from generators of their own, and an RF
library reversed is an FR one at its drawn insert.  The E. coli cells'
inputs are pinned by a digest."""

import hashlib
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


ECOLI = Path(__file__).resolve().parents[1] / "configs" / "ecoli_k12_frag.json"
FIELDS = ("truth", "draft", "seq1", "seq2", "length", "qual", "true_pos",
          "true_contig", "true_insert")
# the E. coli configuration's arrays at the cells' own size, digested from
# the generator before configurations could hold further libraries
ECOLI_DIGESTS = {1: "4d3d954a398148bae91c5f6de88daa0d",
                 2**31 + 12345: "de1d48eb2002a06c2d57a45713e5f925"}


def sim_digest(sim) -> str:
    h = hashlib.blake2b(digest_size=16)
    h.update(repr(list(sim.names)).encode())
    for f in FIELDS:
        v = getattr(sim, f)
        for a in (v if isinstance(v, list) else [v]):
            a = np.ascontiguousarray(a)
            h.update(f"{f}{a.dtype.str}{a.shape};".encode())
            h.update(a.tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("seed", sorted(ECOLI_DIGESTS))
def test_the_ecoli_inputs_are_as_they_were(seed):
    from port_bench.harness import inputs

    sim = inputs.simulate(json.loads(ECOLI.read_text()), seed)
    assert sim.more == []
    assert sim_digest(sim) == ECOLI_DIGESTS[seed]


JUMP = {"read_len": 101, "insert_mean": 1500, "insert_sd": 150,
        "coverage": 4.0, "error_rate": 0.0, "orientation": "RF"}


def two_libraries(seed: int, **jump):
    cfg = json.loads(ECOLI.read_text())
    cfg["simulation"].update(genome_len=40_000, n_contigs=2, n_gaps=5)
    cfg["further_libraries"] = [{"simulation": {**JUMP, **jump},
                                 "library": {"avg_insert_size": 1500,
                                             "is_reverse": 1}}]
    return cfg


def test_further_libraries_leave_library_0_as_it_is():
    from port_bench.harness import inputs

    cfg = two_libraries(7)
    one = json.loads(json.dumps(cfg))
    del one["further_libraries"]
    a, b = inputs.simulate(cfg, 7), inputs.simulate(one, 7)
    assert sim_digest(a) == sim_digest(b)
    assert len(a.libraries()) == 2 and len(b.libraries()) == 1


def test_a_further_library_has_a_generator_of_its_own():
    from port_bench.harness import inputs

    a = inputs.simulate(two_libraries(7), 7).more[0]
    b = inputs.simulate(two_libraries(7), 7).more[0]
    c = inputs.simulate(two_libraries(8), 8).more[0]
    want = np.random.default_rng([7, 1]).integers(0, 2, size=len(a.seq1))
    assert np.array_equal(a.true_contig, want)
    assert np.array_equal(a.seq1, b.seq1) and np.array_equal(a.seq2, b.seq2)
    assert not np.array_equal(a.true_pos, c.true_pos)


@pytest.mark.parametrize("orientation", ["FR", "RF"])
def test_a_library_reversed_as_its_orientation_says_is_fr(orientation):
    """Mate 1 forward at the fragment's start and mate 2 reverse at its end,
    once an RF library's files are both reverse-complemented."""
    from figbird_tpu_torch.io.fastq import ReadBatch
    from port_bench.harness import inputs

    sim = inputs.simulate(two_libraries(9, orientation=orientation), 9)
    r = sim.more[0]
    m1 = ReadBatch(r.seq1, r.length, r.qual)
    m2 = ReadBatch(r.seq2, r.length, r.qual)
    if orientation == "RF":
        m1, m2 = m1.revcomp(), m2.revcomp()
    L = r.seq1.shape[1]
    for i in range(0, len(r.seq1), 97):
        c = sim.truth[r.true_contig[i]]
        s, e = int(r.true_pos[i]), int(r.true_pos[i] + r.true_insert[i])
        assert np.array_equal(m1.seq[i], c[s : s + L])
        assert np.array_equal(m2.seq[i], simmod.COMPLEMENT[c[e - L : e]][::-1])


@pytest.mark.parametrize("orientation", ["FR", "RF"])
def test_placement_is_judged_on_mates_within_the_aligners_reach(orientation):
    """``placed_off_truth`` judges the mates of at most
    ``MAX_SUBSTITUTIONS`` substitutions, each at its own truth: a library
    placed where it was drawn reads 0, and 0 still with every mate of more
    substitutions left unaligned, but not with the others left so."""
    import inspect

    from figbird_tpu_torch.align.index import build_index
    from port_bench.harness import compare, inputs

    sim = inputs.simulate(two_libraries(9, orientation=orientation,
                                        error_rate=0.04), 9)
    r = sim.more[0]
    pad = inspect.signature(build_index).parameters["pad"].default
    lens = [len(c) for c in sim.draft]
    offsets = np.r_[0, np.cumsum(lens)] + pad * np.arange(1, len(lens) + 2)
    L = r.seq1.shape[1]
    starts = (r.true_pos, r.true_pos + r.true_insert - L)
    rev = (orientation == "RF", orientation == "FR")
    subs = [np.array([int((((simmod.COMPLEMENT[s][::-1]) if rv else s)
                            != sim.truth[c][p : p + L]).sum())
                      for s, c, p in zip(seq, r.true_contig, st)])
            for seq, st, rv in zip((r.seq1, r.seq2), starts, rev)]
    far = [n > compare.MAX_SUBSTITUTIONS for n in subs]
    assert 0.2 < far[0].mean() < 0.8

    def off(unaligned):
        mates = [{"aligned": ~u, "pos": offsets[r.true_contig] + st,
                  "strand": np.full(len(st), strand, np.int8)}
                 for u, st, strand in zip(unaligned, starts, (0, 1))]
        return compare._placed_off(sim, r, {"is_reverse": int(rev[0])}, 1,
                                   True, mates, 9, pad, 2000, 32)

    assert off([np.zeros_like(f) for f in far]) == 0
    assert off(far) == 0
    assert off([~f for f in far]) > 0
