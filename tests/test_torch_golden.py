"""The port's golden harness (``figbird_tpu_torch/golden.py``) against
figbird_tpu's, and the golden flows: an injected SAM -> pair table -> model
-> triage -> ``fill_gaps(reference_exact=True)``.

Tier-1: the harness's API, ``reference_available`` and its four artifact
readers, equal in both packages.  ``slow``: the flows of tests/test_golden.py
(partial) and tests/test_golden_unmapped.py (unmapped) with the port's
stages on the CPU, held against the compiled C++ reference where
``FIGBIRD_REF`` holds its sources (skipped elsewhere, as the reference's own
golden tests are), and against figbird_tpu's stages from the same SAM."""

import inspect
import shutil

import numpy as np
import pytest
import torch

import figbird_tpu.golden as r_golden
import figbird_tpu_torch.golden as t_golden
from figbird_tpu.simulate import SimConfig, simulate
from figbird_tpu_torch import convert

torch.set_num_threads(2)


def test_reference_available(monkeypatch, tmp_path):
    """False for a directory without the four C++ sources, in both
    packages; with them, True exactly where ``g++`` is on the path."""
    for mod in (r_golden, t_golden):
        monkeypatch.setattr(mod, "REF_DIR", tmp_path)
    assert t_golden.reference_available() is False
    assert r_golden.reference_available() is False
    assert t_golden._SOURCES == r_golden._SOURCES
    for s in t_golden._SOURCES[:-1]:
        (tmp_path / s).write_text("")
    assert t_golden.reference_available() is False
    (tmp_path / t_golden._SOURCES[-1]).write_text("")
    have_gpp = shutil.which("g++") is not None
    assert t_golden.reference_available() is r_golden.reference_available() \
        is have_gpp


def test_harness_api_equal():
    """``ReferenceHarness`` has the reference's methods with the same
    signatures and the same work-directory layout."""
    names = {n for n, _ in inspect.getmembers(r_golden.ReferenceHarness,
                                              inspect.isfunction)}
    assert {"build", "run_preprocess", "run_fillgaps",
            "figbird_compile_seconds", "read_gap_info", "read_gapout",
            "read_filled_fasta", "read_ncount"} <= names
    for n in sorted(names):
        want = inspect.signature(getattr(r_golden.ReferenceHarness, n))
        got = inspect.signature(getattr(t_golden.ReferenceHarness, n))
        assert [(p.name, p.default) for p in got.parameters.values()
                if p.name != "ref_dir"] == \
            [(p.name, p.default) for p in want.parameters.values()
             if p.name != "ref_dir"], n
    h_ref = r_golden.ReferenceHarness("w", optimize=False)
    h_got = t_golden.ReferenceHarness("w", optimize=False)
    for k in ("work", "gaps_dir", "temp_dir", "optimize", "timings",
              "_built"):
        assert getattr(h_got, k) == getattr(h_ref, k), k


def test_readers_equal(tmp_path):
    """The four artifact readers of both packages on files written here:
    ``gapInfo.txt``, ``gapout.txt`` (an unfilled gap's row has no string),
    ``filledContigs.fa`` (wrapped lines, a description after the name) and
    ``Ncount.txt``; and ``read_ncount`` of an empty file."""
    temp = tmp_path / "Temp"
    temp.mkdir()
    rng = np.random.default_rng(3)
    (temp / "gapInfo.txt").write_text(
        "".join(f"{c} {s} {n}\n" for c, s, n in
                zip(rng.integers(0, 3, 6), rng.integers(0, 9000, 6),
                    rng.integers(5, 400, 6))) + "short line\n")
    rows = []
    for g in range(5):
        s = "".join(rng.choice(list("ACGTN"), int(rng.integers(0, 40))))
        rows.append(f"{g} {g % 2} {100 * g} {len(s) + 3} {len(s)} {s}".rstrip())
    (temp / "gapout.txt").write_text("\n".join(rows + ["3 1 7 0 0"]) + "\n")
    fa = []
    for i in range(3):
        seq = "".join(rng.choice(list("ACGTN"), int(rng.integers(50, 200))))
        fa.append(f">contig{i} len={len(seq)}")
        fa += [seq[j : j + 60] for j in range(0, len(seq), 60)]
    (temp / "filledContigs.fa").write_text("\n".join(fa) + "\n")
    (temp / "Ncount.txt").write_text("1234\n")
    h_ref = r_golden.ReferenceHarness(tmp_path)
    h_got = t_golden.ReferenceHarness(tmp_path)
    for reader in ("read_gap_info", "read_gapout", "read_filled_fasta",
                   "read_ncount"):
        want = getattr(h_ref, reader)()
        assert getattr(h_got, reader)() == want, reader
        assert want, reader
    assert h_got.read_gapout()[-1][5] == ""
    (temp / "Ncount.txt").write_text("")
    assert h_got.read_ncount() == h_ref.read_ncount() == -1


# ---------------------------------------------------------------- slow
P_SIM = dict(genome_len=60_000, n_contigs=2, n_gaps=6, gap_len_range=(8, 60),
             read_len=101, insert_mean=300, insert_sd=25, coverage=15.0,
             error_rate=0.003, seed=7)
U_SIM = dict(P_SIM, insert_mean=600, insert_sd=40)
RL = 101


def sim_insert(unmapped):
    return (U_SIM if unmapped else P_SIM)["insert_mean"]


def _pkg(name):
    """The stages of one package, by the reference's public names."""
    import importlib

    m = {k: importlib.import_module(f"{name}.{k}")
         for k in ("align", "io.sam", "pipeline", "triage", "fill")}
    return dict(build_index=m["align"].build_index,
                build_pair_table=m["align"].build_pair_table,
                read_sam_pairs=m["io.sam"].read_sam_pairs,
                learn_model=m["pipeline"]._learn_model,
                Triage=m["triage"].Triage, fill_gaps=m["fill"].fill_gaps)


def _write_sams(sim, work, unmapped):
    """The port's aligner on the CPU writes the local SAM (and the
    end-to-end one for the unmapped flow) with the port's ``write_sam``."""
    from figbird_tpu_torch.align import (Aligner, AlignParams, build_index,
                                         build_pair_table)
    from figbird_tpu_torch.align.core import e2e_params
    from figbird_tpu_torch.io.sam import write_sam

    insert = sim_insert(unmapped)
    idx = build_index(sim.draft, k=15)
    r1, r2 = sim.reads1, sim.reads2
    sams = []
    presets = [(AlignParams(), insert)]
    if unmapped:
        presets.append((e2e_params(AlignParams()), int(insert * 1.15)))
    for i, (params, max_d) in enumerate(presets, 1):
        al = Aligner(idx, params, batch_size=4096, device="cpu")
        a1, a2 = al.align_many([(r1.seq, r1.length), (r2.seq, r2.length)])
        pt = build_pair_table(idx, a1, a2, r1.length, r2.length, max_d)
        path = f"{work}/result{i}.sam"
        write_sam(path, idx, sim.draft.names, r1, r2, a1, a2, pt=pt)
        sams.append(path)
    return sams


def _flow(pkg, draft, sams, unmapped, **fill_kw):
    """tests/test_golden.py's (or test_golden_unmapped.py's) Python side of
    one package from the SAMs: gaps, the fill result and the spliced
    draft."""
    s = _pkg(pkg)
    insert = sim_insert(unmapped)
    maxd2 = int(insert * 1.15)
    idx = s["build_index"](draft, k=15)
    rr1, rr2, ra1, ra2 = s["read_sam_pairs"](sams[0], idx, draft.names)
    rpt = s["build_pair_table"](idx, ra1, ra2, rr1.length, rr2.length,
                                insert)
    gaps = draft.find_gaps()
    tri = s["Triage"](gaps, max_distance=insert, read_mean=insert,
                      is_jump=False)
    tri.collect_partial(rpt, rr1, rr2)
    if not unmapped:
        model, _ = s["learn_model"](idx, rpt, ra1, ra2, rr1, rr2,
                                    draft.lengths, partial_flag=True,
                                    partial_len=RL)
    else:
        er1, er2, ea1, ea2 = s["read_sam_pairs"](sams[1], idx, draft.names)
        ept = s["build_pair_table"](idx, ea1, ea2, er1.length, er2.length,
                                    maxd2)
        model, _ = s["learn_model"](idx, ept, ea1, ea2, er1, er2,
                                    draft.lengths, partial_flag=False,
                                    partial_len=RL)
        tri2 = s["Triage"](gaps, max_distance=maxd2,
                           read_mean=float(model.insert_mean), is_jump=True)
        tri2.collect_unmapped(ept, er1, er2)
        for bu, bp in zip(tri2.bundles, tri.bundles):
            bp.u_seq, bp.u_pos, bp.u_rev = bu.u_seq, bu.u_pos, bu.u_rev
    res = s["fill_gaps"](draft, gaps, tri.bundles, model,
                         partial_mode=not unmapped, partial_len=RL,
                         reference_exact=True, **fill_kw)
    ours = draft.splice_gaps(gaps, res.gap_strings, list(res.gaptofill))
    return gaps, res, ours


@pytest.fixture(scope="module", params=["partial", "unmapped"])
def flows(request, tmp_path_factory):
    """Both flows' SAMs from one simulation, and the port's fill from
    them on the CPU."""
    unmapped = request.param == "unmapped"
    work = tmp_path_factory.mktemp(f"golden_{request.param}")
    sim = simulate(SimConfig(**(U_SIM if unmapped else P_SIM)))
    tsim = convert.sim_data(sim)
    sams = _write_sams(tsim, work, unmapped)
    got = _flow("figbird_tpu_torch", tsim.draft, sams, unmapped,
                device="cpu")
    return sim, tsim, work, sams, unmapped, got


@pytest.mark.slow
def test_golden_flow_equals_jax_package(flows):
    """The same SAMs through figbird_tpu's stages: equal gap strings,
    gaptofill and spliced contigs, and the draft's N count reduced."""
    sim, _, _, sams, unmapped, (gaps, res, ours) = flows
    _, want, want_g = _flow("figbird_tpu", sim.draft, sams, unmapped)
    assert len(res.gap_strings) == len(want.gap_strings) == len(gaps) > 0
    for a, b in zip(res.gap_strings, want.gap_strings):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(res.gaptofill, want.gaptofill)
    for a, b in zip(ours.contigs, want_g.contigs):
        np.testing.assert_array_equal(a, b)
    assert ours.count_n() < sim.draft.count_n()


@pytest.mark.slow
@pytest.mark.skipif(not t_golden.reference_available(),
                    reason="reference sources/g++ unavailable")
def test_golden_flow_equals_cpp_reference(flows):
    """tests/test_golden.py / test_golden_unmapped.py with the port's
    stages: the compiled reference's gapInfo, gapout strings and filled
    FASTA from the same SAMs."""
    from figbird_tpu_torch.dtypes import decode
    from figbird_tpu_torch.io.fasta import write_fasta

    _, tsim, work, sams, unmapped, (gaps, res, ours) = flows
    insert = sim_insert(unmapped)
    draft_fa = f"{work}/draft.fa"
    write_fasta(draft_fa, tsim.draft.to_fasta(), width=60)
    h = t_golden.ReferenceHarness(work)
    h.build()
    h.run_preprocess(draft_fa, sams[0], max_distance=insert, samflag=1)
    if unmapped:
        h.run_preprocess(draft_fa, sams[1], max_distance=int(insert * 1.15),
                         samflag=2)
    h.run_fillgaps(draft_fa, max_distance=int(insert * 1.15) if unmapped
                   else insert, max_read_len=RL, itr=1,
                   partial_flag=0 if unmapped else 1,
                   unmapped=1 if unmapped else 0, threads=1, neg_overlap=30,
                   partial_readlen=RL, insert_mean=insert)
    assert [(g.contig, g.start, g.length) for g in gaps] == h.read_gap_info()
    rows = h.read_gapout()
    assert len(rows) == len(gaps)
    for gi, _, _, _, _, seq in rows:
        s = res.gap_strings[gi]
        assert (decode(s) if len(s) else "") == seq, gi
    ref_fa = h.read_filled_fasta()
    assert {nm: decode(c) for nm, c in zip(ours.names, ours.contigs)} \
        == ref_fa
