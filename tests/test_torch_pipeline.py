"""One partial-mode iteration through both packages on the same simulation:
the port must fill the same gaps with the same strings and learn the same
model, at the production default (the exact soft-count cascade) and at the
other precision settings; ``run_from_config`` on the same data written to
disk must write the same output tree, byte for byte; and the port must run
where neither JAX nor ``figbird_tpu`` can be imported."""

import dataclasses
import json
import os
import re
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
from figbird_tpu.io import write_fasta, write_fastq
from figbird_tpu.simulate import SimConfig, simulate
from figbird_tpu_torch import config as t_config
from figbird_tpu_torch import convert

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# default = the production default (exact_soft=None -> the 6-level cascade);
# few candidate lengths and small instance batches keep the CPU's padded
# compute down
SMALL = {"max_scan_lengths": 16, "instance_batch": 16}
FILLS = {"default": SMALL, "plain_f32": {"exact_soft": False, **SMALL}}


class _Spy:
    """Stands in for a pipeline module's ``fill_gaps``: keeps the arguments
    of the call and passes it on."""

    def __init__(self, module):
        self.module, self.fn = module, module.fill_gaps

    def __enter__(self):
        self.module.fill_gaps = self
        return self

    def __exit__(self, *exc):
        self.module.fill_gaps = self.fn

    def __call__(self, *args, **kwargs):
        self.args, self.kwargs = args, kwargs
        return self.fn(*args, **kwargs)

    def again(self, which: slice, **over):
        """The kept call on the gaps ``which`` selects, with other keyword
        arguments."""
        genome, gaps, bundles, *rest = self.args
        return self.fn(genome, gaps[which], bundles[which], *rest,
                       **{**self.kwargs, **over})


@pytest.fixture(scope="module")
def sim_cfg():
    sim = simulate(SimConfig(
        genome_len=60_000, n_contigs=1, n_gaps=6, gap_len_range=(8, 60),
        read_len=101, insert_mean=200, insert_sd=20, coverage=15,
        error_rate=0.005, seed=3))
    cfg = FigbirdConfig(
        draft_genome="", output_folder="",
        read_pairs=[ReadLibrary("", "", avg_insert_size=200,
                                max_read_length=101)],
        parameters=Parameters(trim_len=0))
    return sim, cfg


def _run_both(sim_cfg, fill_kwargs):
    sim, cfg = sim_cfg
    tsim = convert.sim_data(sim)
    with _Spy(r_pipeline) as r_spy, _Spy(t_pipeline) as t_spy:
        ref = r_pipeline.Pipeline(cfg, sim.draft, [(sim.reads1, sim.reads2)],
                                  fill_kwargs=fill_kwargs,
                                  aligner_kwargs={"batch_size": 4096})
        st_ref = ref.run_iteration("p", 0)
        got = t_pipeline.Pipeline(
            convert.figbird_config(cfg), tsim.draft,
            [(tsim.reads1, tsim.reads2)], fill_kwargs=fill_kwargs,
            aligner_kwargs={"batch_size": 4096}, device="cpu")
        st_got = got.run_iteration("p", 0)
    return ref, st_ref, got, st_got, r_spy, t_spy


@pytest.fixture(scope="module")
def default_runs(sim_cfg):
    return _run_both(sim_cfg, FILLS["default"])


@pytest.fixture(scope="module", params=list(FILLS))
def runs(request, sim_cfg):
    if request.param == "default":
        return request.getfixturevalue("default_runs")
    return _run_both(sim_cfg, FILLS[request.param])


def _assert_fills_equal(s_got, f_got, s_ref, f_ref, n=6):
    assert len(s_got) == len(s_ref) == n
    for a, b in zip(s_got, s_ref):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(f_got, f_ref)


def test_gap_strings_and_genome_equal(runs):
    ref, st_ref, got, st_got, _, _ = runs
    (g_ref, s_ref, f_ref), = ref.result.gap_history
    (g_got, s_got, f_got), = got.result.gap_history
    assert [dataclasses.astuple(g) for g in g_got] \
        == [dataclasses.astuple(g) for g in g_ref]
    _assert_fills_equal(s_got, f_got, s_ref, f_ref)
    for a, b in zip(got.genome.contigs, ref.genome.contigs):
        np.testing.assert_array_equal(a, b)
    assert st_got.n_after == st_ref.n_after < st_ref.n_before
    assert (st_got.n_pairs, st_got.n_model) == (st_ref.n_pairs,
                                                st_ref.n_model)


def test_model_equal(runs):
    ref, _, got, _, _, _ = runs
    m_ref, m_got = ref.saved_model, got.saved_model
    assert m_got.gap_prob_cutoff == m_ref.gap_prob_cutoff
    st_ref, hist_ref = m_ref.snapshot
    st_got, hist_got = m_got.snapshot
    np.testing.assert_array_equal(hist_got, hist_ref)
    for f in dataclasses.fields(st_ref):
        np.testing.assert_array_equal(getattr(st_got, f.name),
                                      getattr(st_ref, f.name),
                                      err_msg=f.name)


# "auto" compiles four more XLA programs on the reference's side (more than
# 20 s on a CPU), so it runs outside the quick suite
@pytest.mark.parametrize("tier", [
    pytest.param("auto", marks=pytest.mark.slow), "hybrid"])
def test_precision_tiers_equal(default_runs, tier):
    """``"auto"`` (mini-cascade, underflow flags, exact re-runs of flagged
    lanes) and ``"hybrid"`` (mini-cascade scan, exact re-runs and finalize)
    on the first two gaps of the default run's own fill inputs, each against
    the reference's same setting."""
    _, _, _, _, r_spy, t_spy = default_runs
    ref = r_spy.again(slice(2), exact_soft=tier)
    got = t_spy.again(slice(2), exact_soft=tier)
    _assert_fills_equal(got.gap_strings, got.gaptofill, ref.gap_strings,
                        ref.gaptofill, n=2)
    assert got.stats["scan_instances"] == ref.stats["scan_instances"] > 0
    for k in ("esc_exact_scan", "esc_exact_rerun"):
        assert got.stats.get(k, 0) == ref.stats.get(k, 0), k
        assert (got.stats.get(k, 0) > 0) == (tier == "auto"), k


def test_reference_exact_partial_equal(default_runs):
    """``reference_exact=True`` in partial mode (the uncapped length scan and
    the read-order overlap-bonus enumeration, ``bonus_cap`` = the partial
    read bucket) on the default run's own fill inputs for its last gap (the
    shortest: its uncapped scan is 128 lengths, the others' 192-256),
    against the reference's same setting."""
    _, _, _, _, r_spy, t_spy = default_runs
    ref = r_spy.again(slice(5, 6), reference_exact=True)
    got = t_spy.again(slice(5, 6), reference_exact=True)
    _assert_fills_equal(got.gap_strings, got.gaptofill, ref.gap_strings,
                        ref.gaptofill, n=1)
    # the scan is not capped: more candidates than the capped run's 16
    assert got.stats["scan_instances"] == ref.stats["scan_instances"] > 16


def test_run_from_config_trees_equal(sim_cfg, default_runs, tmp_path):
    """Both packages' ``run_from_config`` on the module's simulation written
    to disk, with a user schedule of one p-iteration (the programs the
    fixture compiled serve the reference): every file of the two output
    trees (per-iteration artifacts, combined gaps, final assembly) is
    byte-equal."""
    sim, _ = sim_cfg
    write_fasta(tmp_path / "draft.fa", sim.draft.to_fasta())
    write_fastq(tmp_path / "r1.fq", sim.reads1)
    write_fastq(tmp_path / "r2.fq", sim.reads2)
    (tmp_path / "Config.json").write_text(json.dumps({
        "Directory": {"Draft_Genome": str(tmp_path / "draft.fa"),
                      "Output_Folder": str(tmp_path)},
        "Read_Pairs": [{"path_1": str(tmp_path / "r1.fq"),
                        "path_2": str(tmp_path / "r2.fq"),
                        "avg_insert_size": 200, "max_read_length": 101,
                        "num_itr_partial": 1, "num_itr_unmapped": 0}],
        "Parameters": {"default": 0, "trim_len": 0}}))
    kw = dict(fill_kwargs=SMALL, aligner_kwargs={"batch_size": 4096})
    res_ref = r_pipeline.run_from_config(
        FigbirdConfig.from_json(tmp_path / "Config.json"), tmp_path / "ref",
        **kw)
    res_got = t_pipeline.run_from_config(
        t_config.FigbirdConfig.from_json(tmp_path / "Config.json"),
        tmp_path / "got", device="cpu", **kw)
    assert [(st.mode, st.lib, st.n_before, st.n_after)
            for st in res_got.iterations] \
        == [(st.mode, st.lib, st.n_before, st.n_after)
            for st in res_ref.iterations] \
        == [("p", 0, sim.draft.count_n(), res_ref.genome.count_n())]
    assert res_ref.genome.count_n() < sim.draft.count_n()
    trees = {}
    for name in ("ref", "got"):
        root = tmp_path / name
        trees[name] = sorted(str(p.relative_to(root)) for p in root.rglob("*")
                             if p.is_file())
    assert trees["got"] == trees["ref"]
    assert len(trees["ref"]) == 11
    for f in trees["ref"]:
        assert (tmp_path / "got" / f).read_bytes() \
            == (tmp_path / "ref" / f).read_bytes(), f


def test_port_runs_without_jax():
    """With ``jax`` and ``figbird_tpu`` unimportable (the GPU machine's
    situation), the port and its pipeline import and a tiny CPU fill batch
    runs at the default depth; nothing of ``figbird_tpu`` gets loaded."""
    code = textwrap.dedent("""
        import sys

        class _Blocked:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "figbird_tpu"):
                    raise ImportError(name + " is not installed here")
                return None

        sys.meta_path.insert(0, _Blocked())
        import numpy as np
        import torch
        import figbird_tpu_torch.pipeline
        from figbird_tpu_torch import golden, genome
        from figbird_tpu_torch.io import read_sam_pairs, sam, write_sam
        from figbird_tpu_torch.fill import fill_gaps, finalize_batch
        assert golden.reference_available() in (True, False)
        from figbird_tpu_torch.fill import driver, em
        from figbird_tpu_torch.model import error_model
        from figbird_tpu_torch.triage import assign

        rng = np.random.default_rng(0)
        L, gl = 24, 8
        truth = rng.integers(0, 4, 600).astype(np.int8)
        draft = truth.copy()
        draft[300:300 + gl] = 4
        g = genome.Genome(["c"], [draft])
        gap = genome.GapInfo(0, 300, gl)
        st = error_model.ModelStats(L)
        np.add.at(st.insert_counts, rng.normal(60, 8, 4000).astype(int), 1)
        st.error_pos += 5
        st.read_lengths[L - 1] = 1000
        st.error_types += 1
        st.base_counts += 1000 * L // 4
        model = error_model.finalize_model(st, np.array([600]))
        model.gap_prob_cutoff = 6
        b = assign.GapBundle(gap)
        for s in range(280, 296, 2):
            b.p_seq.append(truth[s:s + L].copy())
            b.p_clip.append(300 - (s + 1))
            b.p_match.append(1)
            b.p_pos.append(s + 1)
            b.p_refpos.append(-1)
            b.p_qual.append(np.full(L, 1e-3, np.float32))
        plan = driver.GapPlan(gap, b, draft[270:300], draft[308:338], 30)
        cfg = em.FillConfig(W=L + 128 + L, Wp=L + 128, L=L, WL=L,
                            max_gap_len=128, R=1, P=8, partial_mode=True,
                            unmapped_mode=False, gap_prob_cutoff=6.0,
                            exact_soft=True, detect_prec=False)
        ga = driver._build_gap_arrays(g, [plan], cfg, "cpu")
        marr = {k: torch.as_tensor(v)
                for k, v in driver.model_arrays(model, L).items()}
        out = em.fill_batch_gathered(cfg, ga, torch.zeros(3, dtype=torch.int32),
                                     torch.tensor([6, 8, 10], dtype=torch.int32),
                                     marr)
        assert out["consensus"].shape == (3, 128)
        assert torch.isfinite(out["likelihood"]).all()
        assert out["accept"].any()
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "figbird_tpu")]
        assert not bad, bad
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().endswith("ok")


def test_port_sources_import_nothing_of_the_reference():
    """No module of the port, nor its GPU scripts (the chr14-scale and
    full-human runs among them), has an import statement that names
    ``jax`` or ``figbird_tpu`` (``figbird_tpu_torch`` aside)."""
    pat = re.compile(r"^\s*(from|import)\s+(figbird_tpu|jax|jaxlib)(\.|\s|$)",
                     re.M)
    files = sorted(Path(REPO, "figbird_tpu_torch").rglob("*.py")) \
        + [Path(REPO, "chip_smoke.py"), Path(REPO, "time_counts.py"),
           Path(REPO, "scripts", "chr14_scale_torch.py"),
           Path(REPO, "scripts", "full_human_torch.py")]
    assert len(files) > 20
    assert all(f.is_file() for f in files)
    for script in ("chr14_scale_torch.py", "full_human_torch.py"):
        assert Path(REPO, "scripts", script) in files, script
    for mod in ("parallel/mesh", "parallel/sharded", "parallel/distributed",
                "io/sam", "golden"):
        assert Path(REPO, "figbird_tpu_torch", f"{mod}.py") in files, mod
    bad = [str(f.relative_to(REPO)) for f in files
           if pat.search(f.read_text())]
    assert not bad, bad
    assert not Path(REPO, "figbird_tpu_torch", "_reference.py").exists()
