"""The benchmark's generator: a frozen numpy copy of the port's simulator
(``figbird_tpu_torch/simulate.py``, itself the reference's).

It makes a truth genome, punches N-gaps into a draft copy and samples
paired-end reads from the truth, and returns plain arrays; the harness turns
them into the port's ``Genome`` and ``ReadBatch`` (and the reference into its
own), so both sides get the same inputs.

One change from the port's simulator, so that every seed of a configuration
gives the same work: with ``size_seed`` set, the layout is drawn from a
generator of its own, seeded by ``size_seed``: the gap lengths (all drawn
first; the placement loop takes them in order, and a gap whose spot
collides is tried at another spot with the same length), the gap and repeat
positions.  The bases of the truth, fragments and errors come from ``seed``.
Without ``size_seed`` the draws are the port's, one generator throughout.
The stacked-gap quirk is kept: a new gap's distance to the gaps already
placed is checked against their lengths, not its own, so a long gap can
land over an earlier one.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

N = 4
COMPLEMENT = np.array([3, 2, 1, 0, 4], dtype=np.int8)


@dataclass
class SimConfig:
    genome_len: int = 200_000
    n_contigs: int = 2
    n_gaps: int = 20
    gap_len_range: tuple = (5, 120)
    read_len: int = 100
    insert_mean: float = 300.0
    insert_sd: float = 30.0
    coverage: float = 30.0
    error_rate: float = 0.005
    seed: int = 0
    gap_len_tail: float = 0.0
    gap_len_tail_max: int = 2000
    repeat_count: int = 0
    repeat_len: int = 500
    repeat_copies: int = 4
    size_seed: int | None = None


@dataclass
class SimArrays:
    names: list
    truth: list = field(default_factory=list)   # int8 code arrays
    draft: list = field(default_factory=list)
    seq1: np.ndarray = None                      # (n_pairs, L) int8
    seq2: np.ndarray = None
    length: np.ndarray = None                    # (n_pairs,) int32
    qual: np.ndarray = None                      # (n_pairs, L) uint8
    true_pos: np.ndarray = None
    true_contig: np.ndarray = None
    true_insert: np.ndarray = None


def _gap_length(rng, cfg: SimConfig) -> int:
    if cfg.gap_len_tail > 0 and rng.random() < cfg.gap_len_tail:
        glen = int(min(rng.lognormal(np.log(150.0), 1.0),
                       cfg.gap_len_tail_max))
        return max(glen, cfg.gap_len_range[0])
    return int(rng.integers(cfg.gap_len_range[0], cfg.gap_len_range[1] + 1))


def simulate(cfg: SimConfig) -> SimArrays:
    rng = np.random.default_rng(cfg.seed)
    # the layout's draws: their own generator with size_seed, else rng's
    lay = rng if cfg.size_seed is None \
        else np.random.default_rng(cfg.size_seed)

    # --- truth genome, with dispersed repeat families ----------------------
    lens = np.full(cfg.n_contigs, cfg.genome_len // cfg.n_contigs,
                   dtype=np.int64)
    contigs = [rng.integers(0, 4, size=int(L), dtype=np.int8) for L in lens]
    for _ in range(cfg.repeat_count):
        src_c = int(lay.integers(0, cfg.n_contigs))
        if len(contigs[src_c]) < 4 * cfg.repeat_len:
            continue
        s0 = int(lay.integers(0, len(contigs[src_c]) - cfg.repeat_len))
        seg = contigs[src_c][s0 : s0 + cfg.repeat_len].copy()
        for _ in range(cfg.repeat_copies - 1):
            dc = int(lay.integers(0, cfg.n_contigs))
            if len(contigs[dc]) < 4 * cfg.repeat_len:
                continue
            d0 = int(lay.integers(0, len(contigs[dc]) - cfg.repeat_len))
            contigs[dc][d0 : d0 + cfg.repeat_len] = seg

    # --- draft with gaps (truth coordinates: start, N-run, consumed) -------
    sizes = None
    if cfg.size_seed is not None:
        sizes = [_gap_length(lay, cfg) for _ in range(cfg.n_gaps)]
    margin = int(cfg.insert_mean * 2)
    min_sep = 2 * cfg.read_len + 50
    specs = {i: [] for i in range(cfg.n_contigs)}
    placed = attempts = 0
    while placed < cfg.n_gaps and attempts < cfg.n_gaps * 50:
        attempts += 1
        ci = int(lay.integers(0, cfg.n_contigs))
        glen = sizes[placed] if sizes is not None else _gap_length(lay, cfg)
        L = len(contigs[ci])
        if L < 2 * margin + glen:
            continue
        start = int(lay.integers(margin, L - margin - glen))
        if any(abs(start - s) < min_sep + gl + 32 for s, gl, _ in specs[ci]):
            continue
        specs[ci].append((start, glen, glen))
        placed += 1
    draft = []
    for i, c in enumerate(contigs):
        pieces, prev = [], 0
        for s, glen, consumed in sorted(specs[i]):
            pieces.append(c[prev:s])
            pieces.append(np.full(glen, N, np.int8))
            prev = s + consumed
        pieces.append(c[prev:])
        draft.append(np.concatenate(pieces))

    # --- paired reads from the truth (FR: mate 2 reverse-complemented) ----
    total = int(lens.sum())
    n_pairs = int(cfg.coverage * total / (2 * cfg.read_len))
    ci = rng.integers(0, cfg.n_contigs, size=n_pairs)
    inserts = np.maximum(
        rng.normal(cfg.insert_mean, cfg.insert_sd,
                   size=n_pairs).astype(np.int64), cfg.read_len + 2)
    starts = np.zeros(n_pairs, dtype=np.int64)
    for k in range(cfg.n_contigs):
        m = ci == k
        hi = len(contigs[k]) - inserts[m] - 1
        starts[m] = (rng.random(m.sum()) * np.maximum(hi, 1)).astype(np.int64)
    L = cfg.read_len
    seq1 = np.zeros((n_pairs, L), dtype=np.int8)
    seq2 = np.zeros((n_pairs, L), dtype=np.int8)
    for k in range(cfg.n_contigs):
        m = np.flatnonzero(ci == k)
        if m.size == 0:
            continue
        c = contigs[k]
        idx1 = starts[m][:, None] + np.arange(L)[None, :]
        seq1[m] = c[np.clip(idx1, 0, len(c) - 1)]
        ends = starts[m] + inserts[m]
        idx2 = ends[:, None] - 1 - np.arange(L)[None, :]
        seq2[m] = COMPLEMENT[c[np.clip(idx2, 0, len(c) - 1)]]
    for seq in (seq1, seq2):
        errs = rng.random(seq.shape) < cfg.error_rate
        if errs.any():
            shift = rng.integers(1, 4, size=int(errs.sum()), dtype=np.int8)
            seq[errs] = (seq[errs] + shift) % 4
    return SimArrays(
        names=[f"scaf{i}" for i in range(cfg.n_contigs)], truth=contigs,
        draft=draft, seq1=seq1, seq2=seq2,
        length=np.full(n_pairs, L, dtype=np.int32),
        qual=np.full((n_pairs, L), ord("I"), dtype=np.uint8),
        true_pos=starts, true_contig=ci.astype(np.int32),
        true_insert=inserts)


def sim_config(cfg: dict, seed: int) -> SimConfig:
    """A configuration file's ``simulation`` block as a ``SimConfig`` for
    ``seed``: lists become tuples, unknown keys are refused."""
    sim = {k: tuple(v) if isinstance(v, list) else v
           for k, v in cfg["simulation"].items()}
    return SimConfig(seed=seed, **sim)
