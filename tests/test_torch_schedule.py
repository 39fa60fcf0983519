"""The whole run: the iteration schedule of ``Pipeline.run`` and its gating,
held against ``figbird_tpu`` with the iterations replaced by a recorder (no
iteration runs, no XLA program is compiled); the port's CLI on a small
simulation written to disk, in a process where neither ``jax`` nor
``figbird_tpu`` can be imported; and (``slow``) both CLIs on a frag + jump
configuration, every file of the two output trees byte-equal."""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import figbird_tpu.pipeline as r_pipeline
import figbird_tpu_torch.pipeline as t_pipeline
from figbird_tpu.config import FigbirdConfig, Parameters, ReadLibrary
from figbird_tpu.genome import GapInfo, Genome
from figbird_tpu.io.fastq import ReadBatch
from figbird_tpu_torch import __main__ as t_main
from figbird_tpu_torch import convert

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N0 = 1000  # the draft's N count the scripted iterations start from


def _lib(insert, **kw):
    return ReadLibrary("", "", avg_insert_size=insert, **kw)


FRAG_JUMP = [_lib(200), _lib(600)]
USER = [_lib(200, serial_num=3, num_itr_partial=2, num_itr_unmapped=1),
        _lib(600, serial_num=1, order=("u", "p"), num_itr_partial=1,
             num_itr_unmapped=2),
        _lib(180, serial_num=2, order=("u", "p"), num_itr_unmapped=1)]
# (libraries, Parameters.default, scripted n_after per iteration (None:
# N0 - 10 per iteration, never 0 and never stalled), max_iterations,
# the expected schedule)
CASES = {
    "frag": ([_lib(200)], 1, None, None, "p0 " * 5),
    "jump": ([_lib(600)], 1, None, None, "u0 u0 p0 p0 u0 p0 p0 p0"),
    "frag_jump": (FRAG_JUMP, 1, None, None, "p0 u1 u1 p0 u1 p0 p0 p0"),
    "2frag_jump": ([_lib(200), _lib(180), _lib(600)], 1, None, None,
                   "u2 u2 p0 p0 p1 p1 u2 p0 p0 p0 p1 p1 p1"),
    "frag_2jump": ([_lib(600), _lib(200), _lib(3000)], 1, None, None,
                   "u0 u0 u2 u2 p1 p1 u0 u2 p1 p1 p1"),
    "rf_jump": ([_lib(200), _lib(2500, is_reverse=1)], 1, None, None,
                "p0 u1 u1 p0 u1 p0 p0 p0"),
    "user": (USER, 0, None, None, "u1 u1 p1 u2 p0 p0 u0"),
    "user_budget_16": ([_lib(200, num_itr_partial=10, num_itr_unmapped=9)],
                       0, None, None, "p0 " * 10 + "u0 " * 6),
    "gate_no_n_left": (FRAG_JUMP, 1, [900, 500, 0], None, "p0 u1 u1"),
    "gate_n_unchanged": (FRAG_JUMP, 1, [900, 900], None, "p0 u1"),
    "gate_max_iterations": (USER, 0, None, 3, "u1 u1 p1"),
}


def _history(n_iter=16, seed=0):
    """Per-iteration (gaps, strings, skips) as fill_gaps reports them: one
    record for every gap still open; a gap closes when its string has no
    N left, some strings keep an N run, one is a merged (empty) gap."""
    rng = np.random.default_rng(seed)
    gaps = [GapInfo(0, 200 * i + 100, n)
            for i, n in enumerate((30, 12, 45, 20, 60, 25))]
    open_, out = list(range(len(gaps))), []
    for k in range(n_iter):
        strings = []
        for gi in open_:
            if k == 0 and gi == 1:
                strings.append(np.zeros(0, np.int8))
                continue
            s = rng.integers(0, 4, gaps[gi].length + int(rng.integers(-3, 4)))
            if rng.random() < 0.6:
                s[2 : 2 + int(rng.integers(1, 8))] = 4
            strings.append(s.astype(np.int8))
        out.append(([gaps[gi] for gi in open_], strings,
                     np.zeros(len(open_), np.int64)))
        open_ = [gi for gi, s in zip(open_, strings) if (s == 4).any()]
    return out


HISTORY = _history()


def _reads(seed, n=6, L=12):
    rng = np.random.default_rng(seed)
    seq = rng.integers(0, 4, (n, L)).astype(np.int8)
    length = rng.integers(8, L + 1, n).astype(np.int32)
    seq[np.arange(L)[None, :] >= length[:, None]] = 4
    return ReadBatch(seq, length, np.full((n, L), 73, np.uint8))


def _recorded_run(pipeline_mod, pipe, n_after, max_iterations):
    """``pipe.run`` with ``run_iteration`` replaced on the instance by a
    recorder: it appends the scripted IterationStats and gap history entry
    and returns."""
    calls = []

    def run_iteration(mode, lib_i):
        k = len(calls)
        pipe.itr += 1
        n_before = pipe.result.iterations[-1].n_after if k else N0
        gaps, strings, skips = HISTORY[k]
        st = pipeline_mod.IterationStats(
            itr=pipe.itr, mode=mode, lib=lib_i, n_pairs=0, n_model=0,
            gaps=len(gaps), filled=len(strings), n_before=n_before,
            n_after=N0 - 10 * (k + 1) if n_after is None else n_after[k],
            seconds=0.0)
        pipe.result.iterations.append(st)
        pipe.result.gap_history.append((gaps, strings, skips))
        calls.append(f"{mode}{lib_i}")
        return st

    pipe.run_iteration = run_iteration
    return calls, pipe.run(max_iterations=max_iterations)


@pytest.mark.parametrize("case", list(CASES))
def test_schedule_equal(case, tmp_path):
    """The (mode, library) sequence, the fillmore flag, the combined gaps
    and the files ``run`` writes at its end equal the reference's."""
    libs, default, n_after, max_it, want = CASES[case]
    cfg = FigbirdConfig("", "", [dataclasses.replace(l) for l in libs],
                        Parameters(default=default, trim_len=0))
    draft = Genome(["c"], [np.random.default_rng(1).integers(
        0, 5, 1500).astype(np.int8)])
    reads = [(_reads(2 * i), _reads(2 * i + 1)) for i in range(len(libs))]
    ref = r_pipeline.Pipeline(cfg, draft, reads, workdir=tmp_path / "ref")
    got = t_pipeline.Pipeline(
        convert.figbird_config(cfg), convert.genome(draft),
        [tuple(convert.read_batch(r) for r in rr) for rr in reads],
        workdir=tmp_path / "got", device="cpu")
    for (a1, a2), (b1, b2) in zip(got.libs, ref.libs):  # RF: both RC'd
        np.testing.assert_array_equal(a1.seq, b1.seq)
        np.testing.assert_array_equal(a2.seq, b2.seq)
    calls_ref, res_ref = _recorded_run(r_pipeline, ref, n_after, max_it)
    calls_got, res_got = _recorded_run(t_pipeline, got, n_after, max_it)
    assert calls_got == calls_ref == want.split()
    assert res_got.fillmore == res_ref.fillmore \
        == (n_after is None or n_after[-1] not in (0, n_after[-2]))
    assert len(res_ref.combined) == 6
    for a, b in zip(res_got.combined, res_ref.combined):
        assert (a.original_len, a.fully_closed) \
            == (b.original_len, b.fully_closed)
        np.testing.assert_array_equal(a.seq, b.seq)
    files = sorted(p.relative_to(tmp_path / "ref")
                   for p in (tmp_path / "ref").rglob("*") if p.is_file())
    assert [str(f) for f in files] == [
        "FilledScaffolds_final.fa", "Individual_gaps.txt",
        os.path.join("Temp", "combined_gapstring.txt")]
    for f in files:
        assert (tmp_path / "got" / f).read_bytes() \
            == (tmp_path / "ref" / f).read_bytes(), f


def test_cli_device_and_mesh_options(tmp_path, monkeypatch, capsys):
    """The CLI raises without a card unless ``--device cpu`` asks for the
    CPU, and for a mesh of more cards than are visible; ``--device cpu
    --mesh-devices 4 --genome-shards 2`` runs an iteration through
    ``main`` on the CLI case's 20 kb dataset, over a (2, 2) mesh of CPU
    devices (code-range shards), with ``Pipeline(distributed=True)`` and no
    process group: one process."""
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_main.main([str(tmp_path / "Config.json")])
    cfg = _write_dataset(tmp_path, jump=False, genome_len=20_000,
                         n_contigs=1, n_gaps=4, gap_len_range=(8, 40), seed=5)
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: True)
        m.setattr(torch.cuda, "device_count", lambda: 1)
        with pytest.raises(ValueError, match="2 devices asked for, 1 avail"):
            t_main.main([str(cfg), "--mesh-devices", "2"])
    seen = []

    class Small(t_pipeline.Pipeline):
        """The CLI case's small batch and capped scan, as one process of a
        multi-process run."""

        def __init__(self, *args, **kw):
            kw["aligner_kwargs"] = {**kw["aligner_kwargs"],
                                    "batch_size": 1024}
            super().__init__(*args, fill_kwargs={"max_scan_lengths": 16,
                                                 "instance_batch": 16},
                             distributed=True, **kw)
            seen.append(self)

    monkeypatch.setattr(t_pipeline, "Pipeline", Small)
    assert t_main.main([str(cfg), "--device", "cpu", "--mesh-devices", "4",
                        "--genome-shards", "2", "--max-iterations", "1"]) == 0
    err = capsys.readouterr().err
    assert "# mesh: {'reads': 2, 'genome': 2} genome_shard=auto" in err
    assert "# itr 1 [p lib0]: 4 gaps" in err
    pipe, = seen
    assert pipe.mesh.shape == {"reads": 2, "genome": 2}
    assert pipe.aligner_kwargs["genome_shard"] == "auto"
    assert pipe.dist and pipe._holds_end == [True]
    st, = pipe.result.iterations
    assert 0 < st.n_after < st.n_before
    # a multi-process run keeps no per-read placements: no alignment_1.txt
    assert _tree(tmp_path / "Figbird") == [
        str(Path(f)) for f in TREE_1 if f != "Individual_gaps/alignment_1.txt"]


def _write_dataset(out: Path, jump: bool, **sim_kw) -> Path:
    """A simulated draft, its truth and a frag library (insert 200 +- 20,
    10x), with ``jump`` also a jump library on the same truth (insert 600
    +- 50, 5x, seed 2), written to disk, and a reference-schema Config.json
    (default schedule, evaluation on) naming them."""
    from figbird_tpu_torch.io.fasta import write_fasta
    from figbird_tpu_torch.io.fastq import write_fastq
    from figbird_tpu_torch.simulate import SimConfig, simulate

    sim = simulate(SimConfig(read_len=101, insert_mean=200, insert_sd=20,
                             coverage=10, error_rate=0.005, **sim_kw))
    write_fasta(out / "draft.fa", sim.draft.to_fasta())
    write_fasta(out / "truth.fa", sim.truth.to_fasta())
    libs = [("f", sim, 200)]
    if jump:
        libs.append(("j", simulate(SimConfig(
            genome_len=sim_kw["genome_len"], read_len=101, insert_mean=600,
            insert_sd=50, coverage=5, error_rate=0.005, seed=2),
            truth=sim.truth), 600))
    pairs = []
    for tag, s, insert in libs:
        write_fastq(out / f"{tag}1.fq", s.reads1)
        write_fastq(out / f"{tag}2.fq", s.reads2)
        pairs.append({"path_1": str(out / f"{tag}1.fq"),
                      "path_2": str(out / f"{tag}2.fq"),
                      "avg_insert_size": insert, "max_read_length": 101})
    cfg = out / "Config.json"
    cfg.write_text(json.dumps({
        "Directory": {"Draft_Genome": str(out / "draft.fa"),
                      "Output_Folder": str(out),
                      "Reference_Genome": str(out / "truth.fa")},
        "Read_Pairs": pairs,
        "Parameters": {"evaluation": 1, "default": 1, "trim_len": 0}}))
    return cfg


def _tree(root: Path) -> list[str]:
    return sorted(str(p.relative_to(root)) for p in root.rglob("*")
                  if p.is_file())


# what the reference CLI writes for one iteration with evaluation on
TREE_1 = sorted([
    "FilledScaffolds_final.fa", "Filled_Scaffolds/1filledContigs.fa",
    "Individual_gaps.txt", "Individual_gaps/alignment_1.txt",
    "Individual_gaps/gapout_1.txt", "Result.txt", "Temp/Ncount.txt",
    "Temp/combined_gapstring.txt", "Temp/gapInfo.txt", "Temp/gaploads.txt",
    "Temp/stat.txt", "Temp/stat2.txt", "combined_gapstring.txt"])

# the port's CLI in a process where jax, jaxlib and figbird_tpu cannot be
# imported; the default aligner batch (32,768 reads, padded) and the
# uncapped length scan cost the CPU tens of seconds even on a 20 kb
# simulation, so this run's Pipeline takes a 2,048-read batch and a capped
# scan (outputs of the aligner do not depend on its batch size)
_CLI = textwrap.dedent("""
    import sys

    class _Blocked:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "figbird_tpu"):
                raise ImportError(name + " is not installed here")
            return None

    sys.meta_path.insert(0, _Blocked())
    import torch

    torch.set_num_threads(2)
    import figbird_tpu_torch.pipeline as tp

    class _Small(tp.Pipeline):
        def __init__(self, *args, **kw):
            kw["aligner_kwargs"] = {**kw["aligner_kwargs"],
                                    "batch_size": 2048}
            super().__init__(*args, fill_kwargs={"max_scan_lengths": 16,
                                                 "instance_batch": 16}, **kw)

    tp.Pipeline = _Small
    from figbird_tpu_torch.__main__ import main

    rc = main(sys.argv[1:])
    bad = [m for m in sys.modules
           if m.split(".")[0] in ("jax", "jaxlib", "figbird_tpu")]
    assert not bad, bad
    sys.exit(rc)
""")


def test_cli_runs_without_jax(tmp_path):
    """``python -m figbird_tpu_torch Config.json --device cpu
    --max-iterations 1`` on a 20 kb simulation: exit 0, the reference CLI's
    output tree, the final assembly equal to the iteration's, N reduced,
    Result.txt written."""
    from figbird_tpu_torch.genome import Genome as TGenome
    from figbird_tpu_torch.io.fasta import read_fasta

    cfg = _write_dataset(tmp_path, jump=False, genome_len=20_000,
                         n_contigs=1, n_gaps=4, gap_len_range=(8, 40), seed=5)
    r = subprocess.run(
        [sys.executable, "-c", _CLI, str(cfg), "--device", "cpu",
         "--max-iterations", "1"], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    wd = tmp_path / "Figbird"
    assert _tree(wd) == [str(Path(f)) for f in TREE_1]
    final = (wd / "FilledScaffolds_final.fa").read_bytes()
    assert final == (wd / "Filled_Scaffolds" / "1filledContigs.fa").read_bytes()
    n0 = TGenome.from_fasta(read_fasta(tmp_path / "draft.fa")).count_n()
    n1 = TGenome.from_fasta(read_fasta(wd / "FilledScaffolds_final.fa"))
    assert n1.count_n() < n0
    assert (wd / "Result.txt").read_text().startswith("Misassemblies\t")
    assert "# itr 1 [p lib0]: 4 gaps" in r.stderr


@pytest.mark.slow
def test_cli_trees_equal(tmp_path):
    """Both CLIs (the reference's in its own process, so that its compile
    cache setting stays out of this one; the port's with ``--device cpu``)
    on a 40 kb frag + jump configuration at the default schedule, three
    iterations (p, u, u; every one changes the N count but the last): every
    file of the two output trees byte-equal."""
    trees = {}
    for pkg, extra in (("figbird_tpu", []),
                       ("figbird_tpu_torch", ["--device", "cpu"])):
        out = tmp_path / pkg
        out.mkdir()
        cfg = _write_dataset(out, jump=True, genome_len=40_000, n_contigs=2,
                             n_gaps=8, gap_len_range=(10, 120), seed=1)
        r = subprocess.run(
            [sys.executable, "-m", pkg, str(cfg), "--max-iterations", "3",
             *extra], cwd=REPO,
            env=dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
                     JAX_COMPILATION_CACHE_DIR=str(tmp_path / "jax_cache"),
                     OMP_NUM_THREADS="2"),
            capture_output=True, text=True, timeout=3000)
        assert r.returncode == 0, r.stderr[-3000:]
        assert [ln.split(":")[0] for ln in r.stderr.splitlines()
                if ln.startswith("# itr")] == [
            "# itr 1 [p lib0]", "# itr 2 [u lib1]", "# itr 3 [u lib1]"]
        trees[pkg] = out / "Figbird"
    files = _tree(trees["figbird_tpu"])
    assert files == _tree(trees["figbird_tpu_torch"])
    assert "Individual_gaps/alignment_3.txt" in files
    for f in files:
        got = (trees["figbird_tpu_torch"] / f).read_bytes()
        assert got == (trees["figbird_tpu"] / f).read_bytes(), f


@pytest.mark.slow
def test_cli_resume_trees_equal(tmp_path):
    """Both CLIs (each in its own process; the port's with ``--device cpu``)
    on the CLI case's 20 kb dataset: ``--max-iterations 1``, then
    ``--resume --max-iterations 1`` from that iteration's filled assembly;
    the resume line names it, and every file of the two output trees is
    byte-equal."""
    trees = {}
    for pkg, extra in (("figbird_tpu", []),
                       ("figbird_tpu_torch", ["--device", "cpu"])):
        out = tmp_path / pkg
        out.mkdir()
        cfg = _write_dataset(out, jump=False, genome_len=20_000,
                             n_contigs=1, n_gaps=4, gap_len_range=(8, 40),
                             seed=5)
        for resume in ([], ["--resume"]):
            r = subprocess.run(
                [sys.executable, "-m", pkg, str(cfg), "--max-iterations",
                 "1", *resume, *extra], cwd=REPO,
                env=dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
                         JAX_COMPILATION_CACHE_DIR=str(tmp_path / "jax_cache"),
                         OMP_NUM_THREADS="2"),
                capture_output=True, text=True, timeout=3000)
            assert r.returncode == 0, r.stderr[-3000:]
            said = [ln for ln in r.stderr.splitlines()
                    if ln.startswith("# resuming")]
            assert said == ([f"# resuming from iteration 1: "
                             f"{out / 'Figbird' / 'Filled_Scaffolds'}"
                             f"/1filledContigs.fa"] if resume else []), said
        trees[pkg] = out / "Figbird"
    files = _tree(trees["figbird_tpu"])
    assert files == _tree(trees["figbird_tpu_torch"]) == [
        str(Path(f)) for f in TREE_1]
    for f in files:
        got = (trees["figbird_tpu_torch"] / f).read_bytes()
        assert got == (trees["figbird_tpu"] / f).read_bytes(), f
