"""The port's SAM interop (``figbird_tpu_torch/io/sam.py``) and its public
names against figbird_tpu: the CIGAR and MD walks, the bytes ``write_sam``
writes, what ``read_sam_pairs`` reads back, and the post-alignment chain
(pair table -> model -> triage) run from the same SAM in both packages,
tests/test_sam.py's hand-written injected SAM included.  Every name of the
reference's public ``__all__`` imports from the port's matching subpackage,
but for the JAX-only ones listed here."""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

import figbird_tpu.io.sam as r_sam
import figbird_tpu.pipeline as r_pipeline
import figbird_tpu_torch.io.sam as t_sam
import figbird_tpu_torch.pipeline as t_pipeline
from figbird_tpu.align import build_index as r_build_index
from figbird_tpu.align import build_pair_table as r_build_pair_table
from figbird_tpu.dtypes import decode, encode
from figbird_tpu.genome import Genome as r_Genome
from figbird_tpu.simulate import SimConfig, simulate
from figbird_tpu.triage import Triage as r_Triage
from figbird_tpu_torch import convert
from figbird_tpu_torch.align import Aligner, AlignParams
from figbird_tpu_torch.align import build_index as t_build_index
from figbird_tpu_torch.align import build_pair_table as t_build_pair_table
from figbird_tpu_torch.genome import Genome as t_Genome
from figbird_tpu_torch.triage import Triage as t_Triage
from test_torch_host import _equal

torch.set_num_threads(2)

# names of the reference's __all__ the port leaves out on purpose: the
# port batches inside Aligner (no align_batch_device); its ops take codes,
# not a one-hot, and have no Pallas switch; a torch Mesh has no XLA
# sharding objects
NOT_PORTED = {"align": {"align_batch_device"},
              "ops": {"band_score", "band_score_reference", "use_pallas"},
              "parallel": {"reads_sharding", "replicated"}}
INSERT = 250


@pytest.mark.parametrize("sub", ["", "align", "fill", "io", "model",
                                 "triage"])
def test_public_names(sub):
    """Every name of the reference subpackage's ``__all__`` imports from
    the port's matching subpackage and is in its ``__all__``."""
    ref = importlib.import_module("figbird_tpu" + (f".{sub}" if sub else ""))
    got = importlib.import_module("figbird_tpu_torch"
                                  + (f".{sub}" if sub else ""))
    want = set(ref.__all__) - NOT_PORTED.get(sub, set())
    assert want and want <= set(got.__all__)
    for name in sorted(want):
        obj = getattr(got, name)
        assert obj.__module__.startswith("figbird_tpu_torch."), name
    if not sub:
        assert got.__version__


CIGARS = [b"5S90M5S", b"100M", b"3S40M2I3D55M", b"2S8M", b"4M1I4M",
          b"4M2D4M", b"2H3S20M", b"10=2X8=1S"]
MDS = [(b"2S8M", b"3A4", 10), (b"4M1I4M", b"5G2", 9),
       (b"4M2D4M", b"4^AC2T1", 8)]


def _random_alignment(rng):
    """A CIGAR of M/I/D/=/X runs between optional S (and H) clips, and an
    MD string of runs, substitutions and ``^`` deletions over its aligned
    bases."""
    ops = []
    if rng.random() < 0.3:
        ops.append(f"{rng.integers(1, 4)}H")
    if rng.random() < 0.6:
        ops.append(f"{rng.integers(1, 9)}S")
    n_aln, md = 0, []
    for _ in range(rng.integers(1, 5)):
        op = rng.choice(list("MID=X"))
        ln = int(rng.integers(1, 30))
        ops.append(f"{ln}{op}")
        if op in "M=X":
            n_aln += ln
            k = 0
            while k < ln:
                run = int(rng.integers(0, ln - k + 1))
                md.append(str(run))
                k += run
                if k < ln:
                    md.append(rng.choice(list("ACGT")))
                    k += 1
        elif op == "D":
            md.append("0^" + "".join(rng.choice(list("ACGT"), ln)))
    md.append("0")
    if rng.random() < 0.6:
        ops.append(f"{rng.integers(1, 9)}S")
    cig = "".join(ops).encode()
    L = sum(int(ln) for ln, op in r_sam._CIGAR_RE.findall(cig)
            if op in b"MI=XS") + int(rng.integers(0, 5))
    return cig, "".join(md).encode(), L


def test_cigar_and_md_walks_equal():
    """``_parse_cigar`` and ``_mism_from_md`` of both packages on
    tests/test_sam.py's cases and 200 alignments made from a seed."""
    rng = np.random.default_rng(11)
    cases = [(c, None, None) for c in CIGARS] + MDS \
        + [_random_alignment(rng) for _ in range(200)]
    n_mis = 0
    for cig, md, L in cases:
        want = r_sam._parse_cigar(cig)
        got = t_sam._parse_cigar(cig)
        assert got == want, cig
        if md is None:
            continue
        m_want, nm_want = r_sam._mism_from_md(md, want[3], want[0], L)
        m_got, nm_got = t_sam._mism_from_md(md, got[3], got[0], L)
        np.testing.assert_array_equal(m_got, m_want, err_msg=str((cig, md)))
        assert nm_got == nm_want
        n_mis += nm_want
    assert n_mis > 100
    assert r_sam._parse_cigar(b"3S40M2I3D55M")[:3] == (3, 0, 97)


@pytest.fixture(scope="module")
def aligned():
    """tests/test_sam.py's simulation; the port's aligner on the CPU, and
    the same alignments, reads and pair table in both packages' classes."""
    sim = simulate(SimConfig(genome_len=60_000, n_contigs=2, n_gaps=6,
                             gap_len_range=(10, 40), read_len=70,
                             insert_mean=180, insert_sd=15, coverage=4.0,
                             error_rate=0.004, seed=7))
    tsim = convert.sim_data(sim)
    t_idx = t_build_index(tsim.draft, k=15)
    r_idx = r_build_index(sim.draft, k=15)
    al = Aligner(t_idx, AlignParams(), batch_size=2048, device="cpu")
    r1, r2 = tsim.reads1, tsim.reads2
    a1, a2 = al.align_many([(r1.seq, r1.length), (r2.seq, r2.length)])
    pt = t_build_pair_table(t_idx, a1, a2, r1.length, r2.length, INSERT)
    assert a1["aligned"].sum() > 1000 and (a2["strand"] == 1).any()
    return sim, tsim, r_idx, t_idx, a1, a2, pt


def _write_both(aligned, tmp_path, **kw):
    sim, tsim, r_idx, t_idx, a1, a2, pt = aligned
    paths = tmp_path / "ref.sam", tmp_path / "got.sam"
    n_ref = r_sam.write_sam(paths[0], r_idx, sim.draft.names, sim.reads1,
                            sim.reads2, a1, a2, **kw)
    n_got = t_sam.write_sam(paths[1], t_idx, tsim.draft.names, tsim.reads1,
                            tsim.reads2, a1, a2, **kw)
    assert n_got == n_ref
    return paths, n_ref


@pytest.mark.parametrize("how", ["pair_table", "no_pair_table",
                                 "model_only"])
def test_write_sam_bytes_equal(aligned, tmp_path, how):
    pt = aligned[-1]
    kw = {"pair_table": dict(pt=pt), "no_pair_table": {},
          "model_only": dict(pt=pt, model_only=True)}[how]
    (ref, got), n = _write_both(aligned, tmp_path, **kw)
    assert got.read_bytes() == ref.read_bytes()
    want_n = 2 * int(pt.model.sum()) if how == "model_only" \
        else 2 * len(aligned[0].reads1)
    assert n == want_n > 0


@pytest.fixture(scope="module")
def read_back(aligned, tmp_path_factory):
    """The SAM with the pair table's fields, read by both packages."""
    sim, tsim, r_idx, t_idx, a1, a2, pt = aligned
    (path, _), _ = _write_both(aligned, tmp_path_factory.mktemp("sam"),
                               pt=pt)
    return (r_sam.read_sam_pairs(path, r_idx, sim.draft.names),
            t_sam.read_sam_pairs(path, t_idx, tsim.draft.names))


def test_read_sam_pairs_equal(aligned, read_back):
    """Both readers give equal read batches and align dicts, key by key;
    the aligned records carry the aligner's placement back (as
    tests/test_sam.py's round trip asserts)."""
    want, got = read_back
    for m in (0, 1):
        _equal(got[m], want[m], f"reads{m + 1}")
        assert sorted(got[2 + m]) == sorted(want[2 + m])
        for k in want[2 + m]:
            _equal(got[2 + m][k], want[2 + m][k], f"align{m + 1}.{k}")
    a1 = aligned[4]
    m = a1["aligned"]
    for k in ("aligned", "strand", "pos", "clip_start", "clip_end",
              "unique"):
        np.testing.assert_array_equal(got[2][k][m], a1[k][m], err_msg=k)


def test_sam_chain_equal(aligned, read_back):
    """From the same SAM: the pair table, the host model (``_learn_model``
    without an aligner takes ``_learn_model_host``) and the partial and
    unmapped triage bundles are equal in both packages."""
    sim, tsim, r_idx, t_idx, _, _, _ = aligned
    (rr1, rr2, ra1, ra2), (tr1, tr2, ta1, ta2) = read_back
    pt_ref = r_build_pair_table(r_idx, ra1, ra2, rr1.length, rr2.length,
                                INSERT)
    pt_got = t_build_pair_table(t_idx, ta1, ta2, tr1.length, tr2.length,
                                INSERT)
    _equal(pt_got, pt_ref, "pair table")
    assert pt_ref.model.sum() > 500
    m_ref, n_ref = r_pipeline._learn_model(
        r_idx, pt_ref, ra1, ra2, rr1, rr2, sim.draft.lengths,
        partial_flag=True, partial_len=70)
    m_got, n_got = t_pipeline._learn_model(
        t_idx, pt_got, ta1, ta2, tr1, tr2, tsim.draft.lengths,
        partial_flag=True, partial_len=70)
    assert n_got == n_ref
    for f in dataclasses.fields(m_ref):
        _equal(getattr(m_got, f.name), getattr(m_ref, f.name), f.name)
    _equal(m_got.snapshot, m_ref.snapshot, "snapshot")
    bundles = []
    for Triage, draft, pt, r1, r2 in (
            (r_Triage, sim.draft, pt_ref, rr1, rr2),
            (t_Triage, tsim.draft, pt_got, tr1, tr2)):
        tri = Triage(draft.find_gaps(), max_distance=INSERT,
                     read_mean=INSERT, is_jump=False)
        tri.collect_partial(pt, r1, r2)
        tri.collect_unmapped(pt, r1, r2)
        bundles.append(tri.bundles)
    assert sum(b.n_partial for b in bundles[0]) > 0
    assert sum(b.n_unmapped for b in bundles[0]) > 0
    for x, y in zip(bundles[1], bundles[0]):
        for f in dataclasses.fields(y):
            if not f.name.startswith("_"):
                _equal(getattr(x, f.name), getattr(y, f.name), f.name)


def test_injected_sam_drives_triage_equal(tmp_path):
    """tests/test_sam.py's hand-written SAM of an external aligner (a read
    overhanging the gap's left edge, clipped, and its mate): both packages
    read it into the same pair table and partial bundle."""
    contig = np.concatenate([
        encode("ACGTACGTGGATCCAGTCAAGGTCCATGCA"),
        np.full(8, 4, np.int8),
        encode("TTGACCGGTTAACCGGATATGCGCATTGCA"),
    ])
    read = np.concatenate([contig[20:30], encode("ACGTACGTAC")])
    sam = "\n".join([
        "@SQ\tSN:c0\tLN:68",
        f"r0\t99\tc0\t21\t42\t10M10S\t=\t40\t30\t{decode(read)}\t{'I' * 20}"
        "\tAS:i:20\tNM:i:0\tMD:Z:10\tIH:i:1",
        f"r0\t147\tc0\t40\t42\t20M\t=\t21\t-30\t{decode(contig[39:59])}\t"
        f"{'I' * 20}\tAS:i:40\tNM:i:0\tMD:Z:20\tIH:i:1",
    ])
    p = tmp_path / "inj.sam"
    p.write_text(sam + "\n")
    out = []
    for mod, Genome, build_index, build_pair_table, Triage in (
            (r_sam, r_Genome, r_build_index, r_build_pair_table, r_Triage),
            (t_sam, t_Genome, t_build_index, t_build_pair_table, t_Triage)):
        genome = Genome(["c0"], [contig])
        idx = build_index(genome, k=15)
        r1, r2, a1, a2 = mod.read_sam_pairs(p, idx, genome.names)
        pt = build_pair_table(idx, a1, a2, r1.length, r2.length, 250)
        tri = Triage(genome.find_gaps(), max_distance=250, read_mean=30,
                     is_jump=False)
        tri.collect_partial(pt, r1, r2, r1.seq, r2.seq)
        out.append((r1, r2, a1, a2, pt, tri.bundles))
    want, got = out
    for i, what in enumerate(("reads1", "reads2")):
        _equal(got[i], want[i], what)
    for i in (2, 3):
        for k in want[i]:
            _equal(got[i][k], want[i][k], k)
    _equal(got[4], want[4], "pair table")
    b_want, = want[5]
    b_got, = got[5]
    assert b_want.n_partial == 1 and b_want.p_clip[0] == 9
    for f in dataclasses.fields(b_want):
        if not f.name.startswith("_"):
            _equal(getattr(b_got, f.name), getattr(b_want, f.name), f.name)
