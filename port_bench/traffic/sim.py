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

A configuration may add further libraries on the same truth
(``further_libraries``, each with a ``simulation`` block of ``ReadSim``'s
keys).  Each draws from a generator of its own, seeded by ``(seed, k)`` for
library k, after the truth, the draft and library 0 are drawn as above.  An
``RF`` library is read as a mate-pair library is: its mates face outward at
the drawn insert (mate 1 reverse at the fragment's start, mate 2 forward at
its end), so that reversing both files gives an ``FR`` pair at that insert.
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
class ReadSim:
    """One library's read simulation (a further library's ``simulation``
    block)."""
    read_len: int
    insert_mean: float
    insert_sd: float
    coverage: float
    error_rate: float
    orientation: str = "FR"                      # "FR" or "RF"


@dataclass
class Reads:
    """One library's pairs, where the simulation drew them: the fragment
    ``[true_pos, true_pos + true_insert)`` of contig ``true_contig``."""
    seq1: np.ndarray                             # (n_pairs, L) int8
    seq2: np.ndarray
    length: np.ndarray                           # (n_pairs,) int32
    qual: np.ndarray                             # (n_pairs, L) uint8
    true_pos: np.ndarray
    true_contig: np.ndarray
    true_insert: np.ndarray
    orientation: str = "FR"


@dataclass
class SimArrays:
    """The truth, the draft and library 0's pairs (``Reads``' fields); the
    further libraries in ``more``."""
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
    more: list = field(default_factory=list)     # Reads of libraries 1..

    def libraries(self) -> list:
        """Every library's ``Reads``, library 0 first."""
        return [Reads(self.seq1, self.seq2, self.length, self.qual,
                      self.true_pos, self.true_contig, self.true_insert),
                *self.more]


def _gap_length(rng, cfg: SimConfig) -> int:
    if cfg.gap_len_tail > 0 and rng.random() < cfg.gap_len_tail:
        glen = int(min(rng.lognormal(np.log(150.0), 1.0),
                       cfg.gap_len_tail_max))
        return max(glen, cfg.gap_len_range[0])
    return int(rng.integers(cfg.gap_len_range[0], cfg.gap_len_range[1] + 1))


def simulate(cfg: SimConfig, further: list = ()) -> SimArrays:
    """The truth, the draft, library 0 from ``cfg`` and a library for
    each ``ReadSim`` of ``further``."""
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

    # --- paired reads from the truth --------------------------------------
    lib0 = _reads(rng, contigs, ReadSim(cfg.read_len, cfg.insert_mean,
                                        cfg.insert_sd, cfg.coverage,
                                        cfg.error_rate))
    more = [_reads(np.random.default_rng([int(cfg.seed), k]), contigs, r)
            for k, r in enumerate(further, start=1)]
    return SimArrays(
        names=[f"scaf{i}" for i in range(cfg.n_contigs)], truth=contigs,
        draft=draft, seq1=lib0.seq1, seq2=lib0.seq2, length=lib0.length,
        qual=lib0.qual, true_pos=lib0.true_pos,
        true_contig=lib0.true_contig, true_insert=lib0.true_insert,
        more=more)


def _reads(rng, contigs: list, r: ReadSim) -> Reads:
    """Pairs drawn from the truth ``contigs``: FR, mate 2
    reverse-complemented at the fragment's end; RF, mate 1
    reverse-complemented at its start and mate 2 forward at its end."""
    if r.orientation not in ("FR", "RF"):
        raise ValueError(f"orientation {r.orientation!r}: FR or RF")
    n_contigs = len(contigs)
    total = sum(len(c) for c in contigs)
    n_pairs = int(r.coverage * total / (2 * r.read_len))
    ci = rng.integers(0, n_contigs, size=n_pairs)
    inserts = np.maximum(
        rng.normal(r.insert_mean, r.insert_sd,
                   size=n_pairs).astype(np.int64), r.read_len + 2)
    starts = np.zeros(n_pairs, dtype=np.int64)
    for k in range(n_contigs):
        m = ci == k
        hi = len(contigs[k]) - inserts[m] - 1
        starts[m] = (rng.random(m.sum()) * np.maximum(hi, 1)).astype(np.int64)
    L = r.read_len
    seq1 = np.zeros((n_pairs, L), dtype=np.int8)
    seq2 = np.zeros((n_pairs, L), dtype=np.int8)
    fwd = np.arange(L)[None, :]
    for k in range(n_contigs):
        m = np.flatnonzero(ci == k)
        if m.size == 0:
            continue
        c = contigs[k]
        ends = starts[m] + inserts[m]
        if r.orientation == "FR":
            idx1 = starts[m][:, None] + fwd
            seq1[m] = c[np.clip(idx1, 0, len(c) - 1)]
            idx2 = ends[:, None] - 1 - fwd
            seq2[m] = COMPLEMENT[c[np.clip(idx2, 0, len(c) - 1)]]
        else:
            idx1 = starts[m][:, None] + L - 1 - fwd
            seq1[m] = COMPLEMENT[c[np.clip(idx1, 0, len(c) - 1)]]
            idx2 = ends[:, None] - L + fwd
            seq2[m] = c[np.clip(idx2, 0, len(c) - 1)]
    for seq in (seq1, seq2):
        errs = rng.random(seq.shape) < r.error_rate
        if errs.any():
            shift = rng.integers(1, 4, size=int(errs.sum()), dtype=np.int8)
            seq[errs] = (seq[errs] + shift) % 4
    return Reads(seq1, seq2, np.full(n_pairs, L, dtype=np.int32),
                 np.full((n_pairs, L), ord("I"), dtype=np.uint8), starts,
                 ci.astype(np.int32), inserts, r.orientation)


def sim_config(cfg: dict, seed: int) -> SimConfig:
    """A configuration file's ``simulation`` block as a ``SimConfig`` for
    ``seed``: lists become tuples, unknown keys are refused."""
    sim = {k: tuple(v) if isinstance(v, list) else v
           for k, v in cfg["simulation"].items()}
    return SimConfig(seed=seed, **sim)


def further_libraries(cfg: dict) -> list:
    """A configuration file's further libraries' ``simulation`` blocks as
    ``ReadSim``s (unknown keys are refused)."""
    return [ReadSim(**lib["simulation"])
            for lib in cfg.get("further_libraries", [])]
