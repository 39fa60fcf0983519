"""The port's multi-process layer on the CPU: two processes joined by a gloo
process group (``parallel.distributed.init_from_env`` from FIGBIRD_COORD,
FIGBIRD_NPROCS and FIGBIRD_PROC), each a subprocess with one thread and a
timeout of its own.  The merge functions against the single-process result
over all the data; a two-process p-iteration against the port's
single-process run; and (``slow``) the two processes at the default
settings against ``figbird_tpu``'s single-process run.  Bit-equal
throughout: no tolerance."""

import os
import pickle
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from figbird_tpu_torch import convert
from figbird_tpu_torch.config import FigbirdConfig, Parameters, ReadLibrary
from figbird_tpu_torch.genome import GapInfo
from figbird_tpu_torch.model.error_model import ModelStats
from figbird_tpu_torch.parallel import distributed as dist
from figbird_tpu_torch.pipeline import Pipeline
from figbird_tpu_torch.simulate import SimConfig, simulate
from figbird_tpu_torch.triage.assign import Triage

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")
LIMIT = 50    # the bundles' read caps in the merge case (both kinds)
N_GAPS = 5
# the capped scan of test_torch_schedule.py's CLI case
SMALL = {"max_scan_lengths": 16, "instance_batch": 16}

_PRELUDE = """
import os, pickle, sys
import torch

sys.path.insert(0, os.environ["FIGBIRD_TESTS"])
import test_torch_distributed as t
from figbird_tpu_torch.parallel import distributed as dist

torch.set_num_threads(1)

assert dist.init_from_env() and dist.process_count() == 2
rank = dist.process_index()
out_path = os.environ["FIGBIRD_OUT"] + f".{rank}"
"""

# the merge functions on test data (their read caps lowered to LIMIT), then
# unless FIGBIRD_FILL is empty the p-iteration with those fill_kwargs
WORKER = _PRELUDE + """
from figbird_tpu_torch import dtypes

caps = dtypes.PARTIAL_LIMIT, dtypes.UNMAPPED_LIMIT
dtypes.PARTIAL_LIMIT = dtypes.UNMAPPED_LIMIT = t.LIMIT
stats, records, strings = t.merge_data(rank)
tri = t.triage_of(records)
out = dict(
    stats=dist.allreduce_stats(stats),
    ranks=dist.allgather_obj(10 * rank + 1),
    bundles=t.bundle_fields(dist.merge_bundles(tri.bundles)),
    shard=dist.shard_reads(7), subset=dist.my_gap_subset(t.N_GAPS))
sub = out["subset"]
out["strings"] = dist.allgather_gap_strings(
    t.N_GAPS, {int(g): (strings[g], 2 * int(g)) for g in sub})
try:
    dist.allgather_gap_strings(t.N_GAPS + 1, {int(g): (strings[g], 0)
                                              for g in sub})
except RuntimeError as e:
    out["missing"] = str(e)
dtypes.PARTIAL_LIMIT, dtypes.UNMAPPED_LIMIT = caps
if os.environ["FIGBIRD_FILL"]:
    pipe, st = t.p_iteration(eval(os.environ["FIGBIRD_FILL"]))
    assert pipe.dist and len(pipe.libs[0][0]) < len(t.sim30().reads1)
    out["run"] = t.run_record(pipe, st)
pickle.dump(out, open(out_path, "wb"))
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


def run_two(tmp_path, fill_kwargs, meanwhile=None, timeout=600):
    """``WORKER`` in two processes of one gloo group (the p-iteration with
    ``fill_kwargs`` unless None), ``meanwhile()`` in this one while they
    run; (each process's pickled result, what ``meanwhile`` returned)."""
    script = tmp_path / "worker.py"
    script.write_text(textwrap.dedent(WORKER))
    port = _free_port()
    procs = []
    for pid in range(2):
        env = dict(os.environ, PYTHONPATH=REPO, FIGBIRD_TESTS=TESTS,
                   FIGBIRD_COORD=f"127.0.0.1:{port}", FIGBIRD_NPROCS="2",
                   FIGBIRD_PROC=str(pid), FIGBIRD_OUT=str(tmp_path / "out"),
                   OMP_NUM_THREADS="1",
                   FIGBIRD_FILL="" if fill_kwargs is None
                   else repr(fill_kwargs))
        procs.append(subprocess.Popen(
            [sys.executable, str(script)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT))
    logs = []
    try:
        here = meanwhile() if meanwhile else None
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0].decode())
    finally:
        for p in procs:
            p.kill()
    for p, lg in zip(procs, logs):
        assert p.returncode == 0, lg[-3000:]
    return [pickle.load(open(tmp_path / f"out.{pid}", "rb"))
            for pid in range(2)], here


# ---------------------------------------------------------------- merges

GAPS = [GapInfo(0, 100 * (i + 1), 10 + i) for i in range(N_GAPS)]


def merge_data(rank: int):
    """One process's share: model statistics, triage records and the gap
    strings.  The records' sequences come from a pool both processes draw
    from, so each bundle holds duplicates (within and across the processes)
    and fills past ``LIMIT``; each bundle's MIM flag is set by one process
    only."""
    rng = np.random.default_rng(rank)
    st = ModelStats(20)
    for name in ("insert_counts", "error_pos", "error_types", "base_counts",
                 "read_lengths", "in_pos", "del_lengths"):
        a = getattr(st, name)
        a += rng.integers(0, 50, a.shape)
    st.unique_mapped += 100 + rank
    st.discarded += rank
    pool = np.random.default_rng(99).integers(0, 4, (200, 20)).astype(
        np.int8)
    records = []
    for gi in range(N_GAPS):
        for j in rng.integers(0, len(pool), 80):
            seq = pool[j]
            if rng.random() < 0.5:
                records.append(("p", gi, seq, int(rng.integers(0, 20)),
                                int(rng.integers(1, 5)),
                                int(rng.integers(1, 999)), -1,
                                rng.random(20).astype(np.float32)))
            else:
                records.append(("u", gi, int(rng.integers(1, 999)),
                                int(rng.integers(0, 2)), seq))
        if gi % 2 == rank:
            records.append(("mim", gi, 5 + gi + rank))
    strings = [np.random.default_rng(g).integers(0, 5, 10 + g).astype(np.int8)
               for g in range(N_GAPS)]
    return st, records, strings


def triage_of(records) -> Triage:
    """The bundles the triage's own insertion steps build from
    ``records``, in order."""
    tri = Triage(GAPS, max_distance=200, read_mean=180.0, is_jump=False,
                 partial_limit=LIMIT, unmapped_limit=LIMIT)
    for rec in records:
        if rec[0] == "p":
            tri._add_partial(*rec[1:])
        elif rec[0] == "u":
            tri._add_unmapped(*rec[1:])
        else:
            b = tri.bundles[rec[1]]
            b.mim_flag, b.mim_len = 1, rec[2]
    return tri


def bundle_fields(bundles) -> list:
    return [dict(u_seq=b.u_seq, u_pos=b.u_pos, u_rev=b.u_rev, p_seq=b.p_seq,
                 p_clip=b.p_clip, p_match=b.p_match, p_pos=b.p_pos,
                 p_refpos=b.p_refpos, p_qual=b.p_qual, mim=(b.mim_flag,
                                                            b.mim_len))
            for b in bundles]


def _assert_equal(a, b, what=""):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), what
        for k in a:
            _assert_equal(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_equal(x, y, f"{what}[{i}]")
    else:
        np.testing.assert_array_equal(a, b, err_msg=what)


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    """The workers with the capped p-iteration, and meanwhile the port's
    single-process run of it here."""
    return run_two(tmp_path_factory.mktemp("two"), SMALL, lambda: run_record(
        *p_iteration(SMALL, distributed=False)), timeout=60)


def test_merges_two_processes_equal_one(two):
    """``allreduce_stats``, ``allgather_obj``, ``merge_bundles`` (dedup and
    caps in (rank, local order) order), ``shard_reads`` with ``holds_end``,
    ``my_gap_subset`` and ``allgather_gap_strings`` (and its error on a gap
    no process filled) in two processes, against one process over all the
    data; without a process group every merge is a no-op."""
    outs, _ = two
    parts = [merge_data(r) for r in range(2)]
    want_st = parts[0][0].merge(parts[1][0])
    want_bundles = bundle_fields(triage_of(parts[0][1] + parts[1][1])
                                 .bundles)
    strings = parts[0][2]
    for rank, out in enumerate(outs):
        _assert_equal(vars(out["stats"]), vars(want_st), "stats")
        assert out["ranks"] == [1, 11]
        _assert_equal(out["bundles"], want_bundles, "bundles")
        assert out["shard"] == [slice(0, 4), slice(4, 7)][rank]
        holds_end = out["shard"].stop == 7 and out["shard"].start < 7
        assert holds_end == (rank == 1)
        np.testing.assert_array_equal(out["subset"],
                                      np.arange(rank, N_GAPS, 2))
        _assert_equal(out["strings"], [(strings[g], 2 * g)
                                       for g in range(N_GAPS)], "strings")
        assert "gaps unassigned across processes: [5]" in out["missing"]
    # the data repeat reads and reach the caps: the kept reads are distinct
    recs = [r for r in parts[0][1] + parts[1][1] if r[:2] == ("p", 0)]
    assert len({r[2].tobytes() for r in recs}) < len(recs)
    for b in want_bundles:
        assert len(b["p_seq"]) == len(b["u_seq"]) == LIMIT
        assert len({x.tobytes() for x in b["p_seq"]}) == LIMIT
    assert sum(b["mim"][0] for b in want_bundles) == N_GAPS
    # one process: every merge passes its input through
    assert not dist.is_distributed() and dist.process_count() == 1
    tri = triage_of(parts[0][1])
    assert dist.merge_bundles(tri.bundles) is tri.bundles
    assert dist.allreduce_stats(want_st) is want_st
    assert dist.shard_reads(7) == slice(0, 7)
    assert dist.allgather_obj(3) == [3]


# ---------------------------------------------------------------- iteration

def sim30():
    """test_distributed.py's 30 kb simulation."""
    return simulate(SimConfig(genome_len=30_000, n_contigs=2, n_gaps=5,
                              gap_len_range=(6, 30), read_len=48,
                              insert_mean=150, insert_sd=15, coverage=12.0,
                              error_rate=0.004, seed=5))


def p_iteration(fill_kwargs, distributed=None):
    """test_distributed.py's p-iteration, in the port on the CPU."""
    sim = sim30()
    cfg = FigbirdConfig(
        draft_genome="", output_folder="",
        read_pairs=[ReadLibrary("", "", avg_insert_size=150,
                                max_read_length=48)],
        parameters=Parameters(trim_len=0))
    pipe = Pipeline(cfg, sim.draft, [(sim.reads1, sim.reads2)],
                    aligner_kwargs={"batch_size": 1024},
                    fill_kwargs=fill_kwargs, device="cpu",
                    distributed=distributed)
    return pipe, pipe.run_iteration("p", 0)


def run_record(pipe, st) -> dict:
    (_, strings, skips), = pipe.result.gap_history
    return dict(n_before=st.n_before, n_after=st.n_after, n_model=st.n_model,
                strings=strings, skips=skips, contigs=pipe.genome.contigs,
                cutoff=pipe.saved_model.gap_prob_cutoff,
                hist=pipe.saved_model.snapshot[1])


def test_two_process_p_iteration_equal_one(two):
    """The two-process p-iteration (each process half the read pairs; the
    model statistics, the bundles and the gap strings merged) equals the
    port's single-process run: N, the model's pair count, its gap-prob
    histogram and cutoff, every gap string, gaptofill and contig (the
    capped scan on both sides)."""
    outs, want = two
    assert want["n_after"] < want["n_before"]
    for out in outs:
        _assert_equal(out["run"], want, "run")


@pytest.mark.slow
def test_two_process_p_iteration_equal_reference(tmp_path):
    """The port's two processes at the default settings against
    ``figbird_tpu``'s single-process run over all the reads
    (``test_distributed.py``'s reference side)."""
    from figbird_tpu.config import FigbirdConfig as RConfig
    from figbird_tpu.config import Parameters as RParameters
    from figbird_tpu.config import ReadLibrary as RLibrary
    from figbird_tpu.pipeline import Pipeline as RPipeline
    from figbird_tpu.simulate import SimConfig as RSimConfig
    from figbird_tpu.simulate import simulate as r_simulate

    outs, _ = run_two(tmp_path, {})
    outs = [out["run"] for out in outs]
    sim = r_simulate(RSimConfig(genome_len=30_000, n_contigs=2, n_gaps=5,
                                gap_len_range=(6, 30), read_len=48,
                                insert_mean=150, insert_sd=15, coverage=12.0,
                                error_rate=0.004, seed=5))
    cfg = RConfig(draft_genome="", output_folder="",
                  read_pairs=[RLibrary("", "", avg_insert_size=150,
                                       max_read_length=48)],
                  parameters=RParameters(trim_len=0))
    ref = RPipeline(cfg, sim.draft, [(sim.reads1, sim.reads2)],
                    aligner_kwargs={"batch_size": 1024}, distributed=False)
    st = ref.run_iteration("p", 0)
    assert st.n_after < st.n_before
    (_, strings, skips), = ref.result.gap_history
    for out in outs:
        assert (out["n_after"], out["n_model"]) == (st.n_after, st.n_model)
        _assert_equal(out["strings"], strings, "strings")
        _assert_equal(out["skips"], skips, "skips")
        _assert_equal(out["contigs"], [np.asarray(c) for c in
                                       ref.genome.contigs], "contigs")
    assert convert.genome(sim.draft).count_n() == outs[0]["n_before"]
