#!/usr/bin/env python3
"""The port's chr14-scale run: ``scripts/chr14_scale.py``'s configuration
(BASELINE.json config 4) through ``figbird_tpu_torch`` on the card.

    python3 scripts/chr14_scale_torch.py [n_gaps] [genome_mb]

The simulation is chr14_scale.py's: an 88 Mb draft in 8 scaffolds, 5,000
gaps of 10-120 bp with a 15% lognormal tail, 150 repeat families, 2x101 bp
reads, insert 200 +- 20, 10x, 0.5% errors, seed 14.  A smaller
``genome_mb`` keeps every width (read length, insert, coverage, errors, the
tail and its cap, the 8 scaffolds) and scales the gaps and the repeat
families with the genome at chr14's density (5,000 and 150 per 88 Mb);
``n_gaps`` given on the command line overrides the gaps' share.

``run`` is the flow (``chip_smoke.py`` and the tests call it too):

1. simulate;
2. a cold ``Pipeline.run_iteration("p", 0)``;
3. a warm rerun on a fresh ``Pipeline``: its N and gap strings must equal
   the cold run's;
4. ``run_iteration("u", 0)`` on the cold run's ``Pipeline`` (the
   ``default: 1`` schedule follows a p-iteration with a u-iteration);
5. three of the p-iteration's own gaps (one at the 128-read bucket, one of
   middling length, one past GAPTHRESH where there is one) through
   ``fill_gaps`` on the run's device and on the CPU: gap strings and
   gaptofill must be equal.

Asserted: N before equals the simulation's (466,755 at full size), N goes
down in both iterations, the filled-base accuracy against the truth is at
least 0.95 in the p-iteration and over both, and on the card all five
kernels launched in each iteration.  The p-iteration's N after is printed
beside the reference's 265,969 (``BENCH_chr14_r05.json``), not asserted.
The last line of standard output is one JSON object; the script writes no
file.  It runs on the card and raises where there is none.

The module also holds what ``full_human_torch.py`` and ``chip_smoke.py``
share with it: ``Captured``, ``K5ByShard`` (K5's launches by genome
shard), ``CpuJob`` (a function on the CPU in a process of its own) and
``cpu_fill``.
"""

from __future__ import annotations

import inspect
import json
import os
import pickle
import resource
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from figbird_tpu_torch import config, dtypes, ops, pipeline  # noqa: E402
from figbird_tpu_torch.combine import combine_gap_history  # noqa: E402
from figbird_tpu_torch.fill import driver  # noqa: E402
from figbird_tpu_torch.simulate import SimConfig, simulate  # noqa: E402

FULL_MB, FULL_GAPS, FULL_REPEATS = 88.0, 5000, 150
# chr14_scale.py's SimConfig widths, which no cut changes
WIDTHS = dict(n_contigs=8, gap_len_range=(10, 120), gap_len_tail=0.15,
              read_len=101, insert_mean=200, insert_sd=20, coverage=10.0,
              error_rate=0.005, seed=14)
# BENCH_chr14_r05.json: the reference's N counts on the full simulation
REF_N_BEFORE, REF_N_AFTER = 466_755, 265_969
MIN_ACCURACY = 0.95
# the sample fills' scan cap, on the card and on the CPU alike: the CPU runs
# the kernels' plain versions, and a gap past GAPTHRESH at the default 96
# lengths would cost it minutes
SAMPLE_SCAN = 24


def log(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


def sim_config(genome_mb: float = FULL_MB, n_gaps: int | None = None
               ) -> SimConfig:
    """chr14_scale.py's simulation at ``genome_mb``: gaps (unless given)
    and repeat families at chr14's density, every width as it is."""
    share = genome_mb / FULL_MB
    if n_gaps is None:
        n_gaps = max(1, round(FULL_GAPS * share))
    return SimConfig(genome_len=int(genome_mb * 1e6), n_gaps=n_gaps,
                     repeat_count=round(FULL_REPEATS * share), **WIDTHS)


def chr14_config() -> config.FigbirdConfig:
    """chr14_scale.py's FigbirdConfig: one frag library, no flank trim."""
    return config.FigbirdConfig(
        draft_genome="", output_folder="",
        read_pairs=[config.ReadLibrary("", "", avg_insert_size=200,
                                       max_read_length=101)],
        parameters=config.Parameters(trim_len=0))


class Captured:
    """Stands in for ``module.name``: keeps the arguments of every call and
    passes it on."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.calls = []

    def __call__(self, *args, **kwargs):
        out = self.fn(*args, **kwargs)
        self.calls.append((args, kwargs, out))
        return out

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


class K5ByShard:
    """K5's launches by genome shard while entered, in ``counts`` (shard ->
    launches): the per-shard calls of the genome-sharded aligner built
    last (the code-range path's ``align_batch``, the contig-range path's
    ``score_candidates``), told apart by the shard tables or flat genome
    slice they are given.  Calls on no shard of that aligner are not
    counted."""

    def __init__(self):
        self.counts: dict = {}
        self._shard_of: dict = {}

    def reset(self) -> None:
        self.counts.clear()

    @staticmethod
    def _key(tensor):
        return None if tensor is None else tensor.data_ptr()

    def _counted(self, fn, key_of):
        def counted(*args, **kwargs):
            before = ops.LAUNCHES["align_score"]
            out = fn(*args, **kwargs)
            g = self._shard_of.get(key_of(args))
            if g is not None:
                self.counts[g] = (self.counts.get(g, 0)
                                  + ops.LAUNCHES["align_score"] - before)
            return out
        return counted

    def __enter__(self):
        from figbird_tpu_torch.align import core
        from figbird_tpu_torch.ops import align_score

        init = core.Aligner.__init__

        def watched(al, *args, **kwargs):
            init(al, *args, **kwargs)
            if al._genome_sharded:
                self._shard_of = {self._key(
                    cell[2]["sorted_codes"] if isinstance(cell[2], dict)
                    else cell[0]): g for (_, g), cell in al._cells.items()}

        self._saved = [(core.Aligner, "__init__", init),
                       (core, "align_batch", core.align_batch),
                       (align_score, "score_candidates",
                        align_score.score_candidates)]
        core.Aligner.__init__ = watched
        core.align_batch = self._counted(
            core.align_batch, lambda a: self._key(a[2].get("sorted_codes")))
        align_score.score_candidates = self._counted(
            align_score.score_candidates, lambda a: self._key(a[0]))
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self._saved:
            setattr(owner, name, fn)


class CpuJob:
    """``fn(*args)`` on the CPU in a process of its own, beside the card's
    work: the script that defines ``fn`` runs as ``SCRIPT --cpu-job IN OUT
    THREADS`` (its main hands that to ``cpu_job_main``).  ``result`` waits
    for it (at most ``timeout`` seconds from its start) and returns what
    it returned.  A job that fails or outlives its timeout raises;
    ``stop`` kills it if it still runs."""

    def __init__(self, fn, *args, threads: int | None = None,
                 timeout: float = 1000.0):
        self.name, self.timeout, self.t0 = fn.__name__, timeout, time.time()
        self.dir = tempfile.mkdtemp(prefix="figbird_cpu_job_")
        with open(os.path.join(self.dir, "in.pkl"), "wb") as fh:
            pickle.dump((fn.__name__, args), fh)
        threads = threads or max(1, (os.cpu_count() or 2) // 2)
        self.log = open(os.path.join(self.dir, "log"), "w+")
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(inspect.getfile(fn)),
             "--cpu-job", os.path.join(self.dir, "in.pkl"),
             os.path.join(self.dir, "out.pkl"), str(threads)],
            stdout=self.log, stderr=subprocess.STDOUT,
            env=dict(os.environ, OMP_NUM_THREADS=str(threads)))

    def result(self):
        try:
            rc = self.proc.wait(timeout=max(
                1.0, self.timeout - (time.time() - self.t0)))
            self.log.seek(0)
            text = self.log.read()
            log(f"CPU job {self.name}: exit {rc} after "
                f"{time.time() - self.t0:.1f}s; its log:")
            sys.stderr.write(text)
            assert rc == 0, f"CPU job {self.name} failed"
            with open(os.path.join(self.dir, "out.pkl"), "rb") as fh:
                return pickle.load(fh)
        finally:
            self.stop()

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.log.close()
        shutil.rmtree(self.dir, ignore_errors=True)


def cpu_job_main(argv, scope: dict) -> None:
    """The process of a ``CpuJob``: ``argv`` is IN, OUT and the thread
    count; the job's function is looked up in ``scope``, the running
    script's globals."""
    src, dst, threads = argv
    torch.set_num_threads(int(threads))
    with open(src, "rb") as fh:
        name, args = pickle.load(fh)
    out = scope[name](*args)
    with open(dst, "wb") as fh:
        pickle.dump(out, fh)


def cpu_fill(genome, gaps, bundles, model, kw) -> tuple:
    """``fill_gaps`` on the CPU (a ``CpuJob``'s work): the run's record (N
    after, gap strings, gaptofill, the spliced contigs) and the fill's
    stats without their timers."""
    t0 = time.time()
    res = driver.fill_gaps(genome, gaps, bundles, model, device="cpu", **kw)
    out = genome.splice_gaps(gaps, res.gap_strings, list(res.gaptofill))
    log(f"CPU fill of {len(gaps)} gaps: {time.time() - t0:.2f}s, N "
        f"{genome.count_n()} -> {out.count_n()}, stats {res.stats}")
    return (dict(n_after=out.count_n(), strings=res.gap_strings,
                 gaptofill=np.asarray(res.gaptofill), contigs=out.contigs),
            {k: v for k, v in res.stats.items() if not k.startswith("t_")})


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _jsonable(x):
    if isinstance(x, dict):
        return {str(k): _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, np.generic):
        return x.item()
    return x


def smi_line() -> str | None:
    """``nvidia-smi``'s name and power limit of the first card, where there
    is one."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout
    except (OSError, subprocess.CalledProcessError):
        return None
    return out.strip().splitlines()[0]


def truth_starts(sim, gaps, flank: int = 32) -> list:
    """Where each of the draft's gaps starts in its truth contig, or None
    where its N-run stands for a truth stretch of another length.

    The simulator checks a new gap's distance to the gaps already placed
    against their lengths, not its own, so a long gap can land over an
    earlier one: the draft then holds both N-runs back to back, longer than
    the truth they replaced, and every later position of that contig is
    shifted by the overlap.  The shift is read off the right flank: the
    truth bases that follow the N-run."""
    out, shift = [], {}
    for g in gaps:
        d = shift.get(g.contig, 0)
        draft = sim.draft.contigs[g.contig]
        truth = sim.truth.contigs[g.contig]
        end = g.start + g.length
        right = draft[end : end + flank]
        n = int(np.argmax(right == dtypes.N)) if (right == dtypes.N).any() \
            else len(right)
        right = right[:n]
        t_end = end - d
        e = next((e for e in range(g.length + 1)
                  if np.array_equal(truth[t_end - e : t_end - e + n], right)),
                 None)
        if e is None or n == 0:
            out.append(None)
            continue
        shift[g.contig] = d + e
        out.append(g.start - d if e == 0 else None)
    return out


def fill_accuracy(sim, gaps, strings) -> dict:
    """Filled-base accuracy of same-length strings of the draft's ``gaps``
    against the truth at each gap's own truth position (``truth_starts``;
    a gap without one counts as open, as a resized string does)."""
    filled = correct = total = closed = 0
    for g, s, t0 in zip(gaps, strings, truth_starts(sim, gaps)):
        total += g.length
        if t0 is None or len(s) != g.length:
            continue
        m = s != dtypes.N
        tr = sim.truth.contigs[g.contig][t0 : t0 + g.length]
        filled += int(m.sum())
        correct += int((s[m] == tr[m]).sum())
        closed += bool(m.all())
    return dict(identity=correct / max(filled, 1), filled=filled,
                total=total, closed=closed)


def sample_gaps(plans) -> dict:
    """Three of a p-iteration's filled gaps, by plan index: the one with the
    most partial reads inside the 128-read bucket, the one of median length,
    and the longest past GAPTHRESH where there is one."""
    active = [i for i, p in enumerate(plans)
              if not p.skip and p.neg_merge == 0 and p.bundle.n_partial]
    at_128 = [i for i in active if plans[i].bundle.n_partial <= 128]
    out = {"bucket_128": max(at_128, key=lambda i: plans[i].bundle.n_partial)}
    rest = [i for i in active if i not in out.values()]
    lens = sorted(plans[i].gap.length for i in rest)
    if lens:
        med = lens[len(lens) // 2]
        out["median_length"] = min(rest, key=lambda i: (
            abs(plans[i].gap.length - med), i))
    large = [i for i in active if plans[i].gap.length > driver.GAPTHRESH
             and i not in out.values()]
    if large:
        out["past_gapthresh"] = max(large, key=lambda i: plans[i].gap.length)
    return out


def _iteration(pipe, mode, dev):
    """One iteration with the launch counts set to 0 just before and read
    just after, the fill's inputs and plans kept."""
    with Captured(pipeline, "fill_gaps") as fills, \
            Captured(driver, "plan_gaps") as plans:
        _sync(dev)
        ops.reset_launches()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.time()
        st = pipe.run_iteration(mode, 0)
        _sync(dev)
        wall = time.time() - t0
    rec = dict(
        wall_s=wall, n_before=st.n_before, n_after=st.n_after,
        gaps=st.gaps, filled=st.filled, n_pairs=st.n_pairs,
        launches=dict(ops.LAUNCHES),
        launches_by_shape={f"{k}/{r}/{w}": n for (k, r, w), n in
                           sorted(ops.LAUNCHES_BY_SHAPE.items())},
        fill_stats={k: v for k, v in pipe.last_fill_stats.items()},
        peak_device_bytes=(torch.cuda.max_memory_allocated(dev)
                           if dev.type == "cuda" else None))
    log(f"{mode}-iteration: wall {wall:.2f}s, N {st.n_before} -> "
        f"{st.n_after}, {st.gaps} gaps, {st.filled} filled, launches "
        f"{rec['launches']}")
    return st, rec, fills.calls[0], plans.calls[0][2]


def _stage_split(timer, before: dict | None = None) -> dict:
    """``StageTimer``'s seconds by stage, less ``before``'s."""
    out = {}
    for name, s in timer.stages.items():
        sec = s["seconds"] - (before or {}).get(name, 0.0)
        if sec > 0:
            out[name] = round(sec, 3)
    return out


def run(genome_mb: float = FULL_MB, n_gaps: int | None = None, device=None,
        fill_kwargs: dict | None = None, aligner_kwargs: dict | None = None
        ) -> dict:
    """The flow of the module docstring on ``device`` (``None``: the card,
    an error where there is none).  ``fill_kwargs`` and ``aligner_kwargs``
    go to every ``Pipeline``; the sample fills take the p-iteration's fill
    arguments with the scan capped at ``SAMPLE_SCAN`` lengths on both
    sides.  Returns the result's record (the JSON line)."""
    dev = ops.canonical_device(ops.entry_device(device))
    sc = sim_config(genome_mb, n_gaps)
    t0 = time.time()
    sim = simulate(sc)
    t_sim = time.time() - t0
    gaps0 = sim.draft.find_gaps()
    n_sim = sim.draft.count_n()
    n_reads = 2 * len(sim.reads1)
    lens = [g.length for g in gaps0]
    log(f"simulated in {t_sim:.1f}s: {sim.truth.total_length()} bp, "
        f"{n_reads} reads, {len(gaps0)} gaps (median {int(np.median(lens))} "
        f"bp, longest {max(lens)}, {sum(x > driver.GAPTHRESH for x in lens)} "
        f"past GAPTHRESH), N {n_sim}, {sc.repeat_count} repeat families")
    full = (genome_mb == FULL_MB and sc.n_gaps == FULL_GAPS)
    if full:
        assert n_sim == REF_N_BEFORE, (n_sim, REF_N_BEFORE)
    cfg = chr14_config()
    libs = [(sim.reads1, sim.reads2)]
    kw = dict(fill_kwargs=fill_kwargs, aligner_kwargs=aligner_kwargs,
              device=dev)

    pipe = pipeline.Pipeline(cfg, sim.draft, libs, **kw)
    st_p, rec_p, (f_args, f_kw, _), plans = _iteration(pipe, "p", dev)
    stages_p = {k: s["seconds"] for k, s in pipe.timer.stages.items()}
    rec_p["stages"] = _stage_split(pipe.timer)
    (_, strings_p, skips_p), = pipe.result.gap_history
    acc_p = fill_accuracy(sim, gaps0, strings_p)

    warm = pipeline.Pipeline(cfg, sim.draft, libs, **kw)
    st_w, rec_w, _, _ = _iteration(warm, "p", dev)
    rec_w["stages"] = _stage_split(warm.timer)
    (_, strings_w, skips_w), = warm.result.gap_history
    assert st_w.n_after == st_p.n_after, (st_w.n_after, st_p.n_after)
    assert len(strings_w) == len(strings_p)
    for i, (a, b) in enumerate(zip(strings_w, strings_p)):
        assert np.array_equal(a, b), f"warm rerun: gap string {i} differs"
    assert np.array_equal(np.asarray(skips_w), np.asarray(skips_p))
    del warm

    st_u, rec_u, _, _ = _iteration(pipe, "u", dev)
    rec_u["stages"] = _stage_split(pipe.timer, stages_p)
    acc_all = fill_accuracy(sim, gaps0, [
        cg.seq for cg in combine_gap_history(pipe.result.gap_history)])

    # three of the p-iteration's gaps on the run's device and on the CPU
    genome, gaps, bundles, model = f_args
    s_kw = {k: v for k, v in f_kw.items() if k not in ("device", "mesh")}
    s_kw["max_scan_lengths"] = min(s_kw.get("max_scan_lengths") or SAMPLE_SCAN,
                                   SAMPLE_SCAN)
    picks = sample_gaps(plans)
    samples = {}
    for what, gi in picks.items():
        got = {}
        for d in dict.fromkeys((dev, torch.device("cpu"))):
            t1 = time.time()
            res = driver.fill_gaps(genome, [gaps[gi]], [bundles[gi]], model,
                                   device=d, **s_kw)
            _sync(d)
            got[d.type] = (res, time.time() - t1)
        (r_dev, t_dev), (r_cpu, t_cpu) = got[dev.type], got["cpu"]
        equal = (np.array_equal(r_dev.gap_strings[0], r_cpu.gap_strings[0])
                 and np.array_equal(np.asarray(r_dev.gaptofill),
                                    np.asarray(r_cpu.gaptofill)))
        samples[what] = dict(
            gap=gi, length=gaps[gi].length,
            partial_reads=bundles[gi].n_partial, equal=equal,
            same_as_iteration=bool(np.array_equal(r_dev.gap_strings[0],
                                                  strings_p[gi])),
            device_s=round(t_dev, 3), cpu_s=round(t_cpu, 3))
        log(f"sample {what}: gap {gi} ({gaps[gi].length} bp, "
            f"{bundles[gi].n_partial} partial reads) {dev.type} {t_dev:.2f}s"
            f", cpu {t_cpu:.2f}s, equal {equal}")

    out = dict(
        genome_len=int(sim.truth.total_length()), n_reads=n_reads,
        n_gaps=len(gaps0), gaps_past_gapthresh=sum(
            x > driver.GAPTHRESH for x in lens),
        repeat_count=sc.repeat_count, genome_mb=genome_mb,
        device=str(dev), simulate_s=round(t_sim, 3),
        n_sim=n_sim, p=rec_p, p_warm=rec_w, u=rec_u,
        wall_p_cold_s=rec_p["wall_s"], wall_p_warm_s=rec_w["wall_s"],
        wall_u_s=rec_u["wall_s"],
        accuracy_p=acc_p, accuracy_p_u=acc_all,
        gaps_without_truth_start=sum(
            t is None for t in truth_starts(sim, gaps0)),
        samples=samples,
        reference_n_after=REF_N_AFTER if full else None,
        n_after_minus_reference=(st_p.n_after - REF_N_AFTER) if full
        else None,
        peak_device_bytes=max((r["peak_device_bytes"] or 0)
                              for r in (rec_p, rec_w, rec_u)) or None,
        peak_host_rss_bytes=resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss * 1024,
        nvidia_smi=smi_line() if dev.type == "cuda" else None)
    if full:
        log(f"p-iteration N after {st_p.n_after}, the reference's "
            f"{REF_N_AFTER} (difference {st_p.n_after - REF_N_AFTER:+d})")

    assert st_p.n_before == n_sim, (st_p.n_before, n_sim)
    assert st_p.n_after < st_p.n_before, "p-iteration: N not reduced"
    assert st_u.n_after < st_u.n_before, "u-iteration: N not reduced"
    assert acc_p["identity"] >= MIN_ACCURACY, f"p accuracy {acc_p}"
    assert acc_all["identity"] >= MIN_ACCURACY, f"p and u accuracy {acc_all}"
    if dev.type == "cuda":
        for what, rec in (("p", rec_p), ("u", rec_u)):
            # a u-iteration runs no partial EM, so no overlap bonus
            missing = [k for k, n in rec["launches"].items()
                       if n == 0 and (what == "p" or k != "overlap")]
            assert not missing, f"{what}: kernels not launched: {missing}"
    bad = [w for w, s in samples.items() if not s["equal"]]
    assert not bad, f"sample gaps differ between {dev} and the CPU: {bad}"
    return _jsonable(out)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--cpu-job"]:
        cpu_job_main(argv[1:], globals())
        return 0
    n_gaps = int(argv[0]) if argv else None
    genome_mb = float(argv[1]) if len(argv) > 1 else FULL_MB
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if torch.cuda.is_available():
        from figbird_tpu_torch.ops import _build

        log(f"kernels built in {_build.build():.1f}s")
    out = run(genome_mb, n_gaps)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
