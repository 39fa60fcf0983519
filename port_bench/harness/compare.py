"""What ``correct`` compares: a unit's outputs against the reference's, as
counts of the items that differ, each against the cell's limit.

An iteration's numbers, one per layer it runs:

- ``align_rows``: read rows (both mates, and the unmapped pass's in a
  u-iteration) where any field of the aligner's output differs;
- ``model_fields``: fields of the learned model that differ;
- ``triage_gaps``: gaps whose read bundle (the reads triage sent to them,
  with positions, clips and qualities) differs;
- ``fill_gaps_pct``: the share of gaps (%) whose filled string or
  ``gaptofill`` differs;
- ``placed_gaps``: gaps filled alike whose placed reads differ;
These compare with the frozen copy of the port's engine
(``port_bench/reference/fbref/``), a witness that catches any later change
of what the port computes.  The plain reference
(``port_bench/reference/direct.py``), written apart from the port, judges
each full unit's outputs by ``direct_numbers``:

- ``spliced_contigs``: contigs of the port's spliced draft that differ from
  the draft spliced, by a direct loop, with the port's own gap strings (the
  splice judged apart from the fill);
- ``placed_off_truth``: of a sample of read pairs drawn from the seed whose
  mates lie where the draft holds the truth unchanged and carry at most
  ``MAX_SUBSTITUTIONS`` substitutions each, mates that the aligner leaves
  unaligned or places elsewhere, or on the other strand, than where the
  simulation drew them (mate 1 forward at the fragment's start, mate 2
  reverse at its end less a read, once an RF library is reversed); of
  every library whose alignments the unit returns: the minimum-insert
  library's partial pass and, in a u-iteration, the unmapped pass's library
  end to end, each against its own truth;

and a sample of the calls of one unit to the EM's and the aligner's ops
(``harness/calls.py``).

A whole run's: ``final_contigs_pct`` (the share of contigs of
``FilledScaffolds_final.fa`` that differ), ``combined_gaps_pct`` (the share
of ``combined_gapstring.txt``'s gaps) and ``iterations_off`` (how many more
or fewer iterations it ran).  Shares, so that a limit set at a cell's size
(room for one gap that the kernels' rounding flips) still catches one wrong
answer at a test's size.
"""

from __future__ import annotations

import dataclasses
import hashlib
import inspect
from dataclasses import dataclass, field

import numpy as np

from port_bench.harness import inputs
from port_bench.reference import direct

def _feed(h, x) -> None:
    if x is None:
        h.update(b"N;")
    elif isinstance(x, np.ndarray):
        h.update(f"a{x.dtype.str}{x.shape};".encode())
        h.update(np.ascontiguousarray(x).tobytes())
    elif isinstance(x, (bytes, str, bool, int, float, np.generic)):
        h.update(f"{type(x).__name__}:{x!r};".encode())
    elif isinstance(x, (list, tuple)):
        h.update(f"l{len(x)}[".encode())
        for v in x:
            _feed(h, v)
        h.update(b"]")
    elif isinstance(x, dict):
        h.update(f"d{len(x)}{{".encode())
        for k in sorted(x, key=str):
            _feed(h, str(k))
            _feed(h, x[k])
        h.update(b"}")
    elif isinstance(x, (set, frozenset)):
        _feed(h, sorted(hash_of(v) for v in x))
    elif hasattr(x, "detach") and hasattr(x, "cpu"):      # a tensor
        _feed(h, x.detach().cpu().numpy())
    elif dataclasses.is_dataclass(x) or hasattr(x, "__dict__"):
        h.update(f"o{type(x).__name__}(".encode())
        _feed(h, fields_of(x))
        h.update(b")")
    else:
        raise TypeError(f"cannot digest {type(x).__name__}")


def hash_of(x) -> bytes:
    h = hashlib.blake2b(digest_size=16)
    _feed(h, x)
    return h.digest()


def fields_of(x) -> dict:
    """An object's public attributes (a model's ``snapshot`` included)."""
    return {k: v for k, v in vars(x).items() if not k.startswith("_")}


@dataclass
class Digest:
    kind: str
    align: list = field(default_factory=list)     # dicts of arrays
    model: dict = field(default_factory=dict)     # field -> hash
    bundles: list = field(default_factory=list)   # per gap: hash
    strings: list = field(default_factory=list)   # per gap: (bytes, skip)
    placements: list = field(default_factory=list)
    contigs: list = field(default_factory=list)   # per contig: hash
    combined: list = field(default_factory=list)  # per gap: bytes
    n_iterations: int = 0
    key: bytes = b""


def digest(rec) -> Digest:
    """A unit's record as the comparable outputs (a run's tree is read from
    disk)."""
    if rec.kind == "iteration":
        res = rec.fill
        d = Digest(
            "iteration", align=rec.alignments,
            model={k: hash_of(v) for k, v in fields_of(rec.model).items()},
            bundles=[hash_of(fields_of(b)) for b in rec.bundles],
            strings=[(inputs.decode(np.asarray(s)), int(t))
                     for s, t in zip(res.gap_strings, res.gaptofill)],
            placements=[hash_of(p) for p in (res.placements or [])],
            contigs=[hash_of((n, np.asarray(c, np.int8))) for n, c in
                     zip(rec.genome.names, rec.genome.contigs)])
    elif rec.folder is not None:          # the port's run: its files
        names, seqs = inputs.read_fasta(rec.folder
                                        / "FilledScaffolds_final.fa")
        lines = (rec.folder / "combined_gapstring.txt").read_bytes()
        d = Digest("run", contigs=[hash_of((n, s)) for n, s in
                                   zip(names, seqs)],
                   combined=lines.split(b"\n")[:-1],
                   n_iterations=len(list(
                       (rec.folder / "Filled_Scaffolds").glob(
                           "*filledContigs.fa"))))
    else:                                 # the reference's run: in memory
        names, contigs = rec.final
        d = Digest("run", contigs=[hash_of((n, inputs.decode(c)))
                                   for n, c in zip(names, contigs)],
                   combined=[inputs.decode(np.asarray(s))
                             for s in rec.combined],
                   n_iterations=rec.n_iterations)
    d.key = hash_of([d.kind, [hash_of(a) for a in d.align], d.model,
                     d.bundles, d.strings, d.placements, d.contigs,
                     d.combined, d.n_iterations])
    return d


def _list_diff(a: list, b: list) -> int:
    return sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))


def _align_rows(got: list, want: list) -> int:
    n_diff = 0
    for g, w in zip(got, want):
        n = max((len(v) for v in w.values()), default=0)
        diff = np.zeros(n, bool)
        for k in set(g) | set(w):
            x, y = g.get(k), w.get(k)
            if x is None or y is None or x.shape != y.shape \
                    or x.shape[:1] != (n,):
                diff[:] = True
                break
            diff |= (x.reshape(n, -1) != y.reshape(n, -1)).any(axis=1)
        n_diff += int(diff.sum())
    for extra in (got[len(want):] or want[len(got):]):
        n_diff += max((len(v) for v in extra.values()), default=0)
    return n_diff


def count(got: Digest, want: Digest) -> dict:
    """The numbers compared, for one unit's outputs against the
    reference's."""
    if got.kind != want.kind:
        raise ValueError(f"{got.kind} outputs against {want.kind} ones")
    if got.kind == "run":
        return {"final_contigs_pct": 100.0 * _list_diff(got.contigs,
                                                        want.contigs)
                / max(len(want.contigs), 1),
                "combined_gaps_pct": 100.0 * _list_diff(got.combined,
                                                        want.combined)
                / max(len(want.combined), 1),
                "iterations_off": abs(got.n_iterations - want.n_iterations)}
    same = [a == b for a, b in zip(got.strings, want.strings)]
    n_gaps = max(len(want.strings), 1)
    return {
        "align_rows": _align_rows(got.align, want.align),
        "model_fields": sum(got.model.get(k) != v
                            for k, v in want.model.items())
        + len(set(got.model) - set(want.model)),
        "triage_gaps": _list_diff(got.bundles, want.bundles),
        "fill_gaps_pct": 100.0 * _list_diff(got.strings, want.strings)
        / n_gaps,
        "placed_gaps": sum(ok and a != b for ok, a, b in
                           zip(same, got.placements, want.placements))
        + abs(len(got.placements) - len(want.placements)),
    }


def strings_only(strings: list, want: Digest) -> dict:
    """A window unit kept as its gap strings alone: its fill against the
    reference's."""
    return {"fill_gaps_pct": 100.0 * _list_diff(strings, want.strings)
            / max(len(want.strings), 1)}


def direct_numbers(rec, sim, config: dict, seed: int, n_pairs: int = 2000,
                   margin: int = 32) -> dict:
    """A full iteration unit's outputs judged by the plain reference."""
    spliced = direct.splice(
        [np.asarray(c, np.int8) for c in rec.draft.contigs],
        [np.asarray(s, np.int8) for s in rec.fill.gap_strings],
        [int(t) for t in rec.fill.gaptofill])
    got = [np.asarray(c, np.int8) for c in rec.genome.contigs]
    n_off = sum(not np.array_equal(a, b) for a, b in zip(got, spliced)) \
        + abs(len(got) - len(spliced))
    # the aligner's positions are in its padded flat draft: ``pad`` gap
    # codes before each contig (the index's layout, not derived from data)
    from figbird_tpu_torch.align.index import build_index

    pad = inspect.signature(build_index).parameters["pad"].default
    libs, blocks = sim.libraries(), inputs.library_blocks(config)
    off = 0
    for i, (k, whole) in enumerate(rec.aligned):
        off += _placed_off(sim, libs[k], blocks[k], k, whole,
                           rec.alignments[2 * i : 2 * i + 2], seed, pad,
                           n_pairs, margin)
    return {"spliced_contigs": int(n_off), "placed_off_truth": off}


# the most substitutions a judged mate carries: the aligner seeds from 4
# k-mers of 15 bases at fixed offsets (as the JAX package's does), so a
# read with an error in each is left unaligned by design, never misplaced
MAX_SUBSTITUTIONS = 3


def _placed_off(sim, reads, block: dict, k: int, whole: bool, mates: list,
                seed: int, pad: int, n_pairs: int, margin: int) -> int:
    """Of a sample of library ``k``'s pairs drawn from the seed whose mates
    lie where the draft holds the truth, on a contig the pass aligned
    against (the whole draft, else the contigs that hold a gap), and carry
    at most ``MAX_SUBSTITUTIONS`` each, mates placed off where the
    simulation drew them: mate 1 at the fragment's start and mate 2 at its
    end less a read, on the strands the library's orientation gives once
    reversed as its ``is_reverse`` says (FR: mate 1 forward, mate 2
    reverse)."""
    L = reads.seq1.shape[1]
    rng = np.random.default_rng([int(seed), 0x9A7] + ([k] if k else []))
    pick = np.sort(rng.choice(len(reads.true_pos),
                              min(n_pairs, len(reads.true_pos)),
                              replace=False))
    ci, s1 = reads.true_contig[pick], reads.true_pos[pick]
    s2 = s1 + reads.true_insert[pick] - L
    held = np.array([whole or bool((c == direct.N_CODE).any())
                     for c in sim.draft])
    rf = reads.orientation == "RF"          # mate 1 drawn reverse
    keep = held[ci] \
        & direct.clean_spans(sim.truth, sim.draft, ci, s1, L, margin) \
        & direct.clean_spans(sim.truth, sim.draft, ci, s2, L, margin) \
        & (direct.substitutions(sim.truth, ci, s1, reads.seq1[pick], rf)
           <= MAX_SUBSTITUTIONS) \
        & (direct.substitutions(sim.truth, ci, s2, reads.seq2[pick], not rf)
           <= MAX_SUBSTITUTIONS)
    pick, ci, s1, s2 = pick[keep], ci[keep], s1[keep], s2[keep]
    lens = [len(c) for c, h in zip(sim.draft, held) if h]
    offsets = np.r_[0, np.cumsum(lens)] + pad * np.arange(1, len(lens) + 2)
    at = (np.cumsum(held) - 1)[ci]          # the contig in the pass's draft
    rf_read = rf != bool(block.get("is_reverse", 0))
    off = 0
    for a, start, strand in zip(mates, (s1, s2),
                                (1, 0) if rf_read else (0, 1)):
        off += direct.placed_off_truth(
            offsets, at, start, strand, a["aligned"][pick], a["pos"][pick],
            a["strand"][pick])
    return off


def judge(numbers: dict, limits: dict) -> dict:
    """name -> {"value", "limit", "ok"}; a number without a limit is an
    error in the cell's file."""
    missing = sorted(set(numbers) - set(limits))
    if missing:
        raise KeyError(f"no limit for {', '.join(missing)} in the cell's "
                       f"workloads file")
    return {k: {"value": v, "limit": limits[k], "ok": v <= limits[k]}
            for k, v in numbers.items()}
