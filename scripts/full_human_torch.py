#!/usr/bin/env python3
"""The port's full-human run: ``scripts/full_human.py``'s configuration
(BASELINE.json config 5) through ``figbird_tpu_torch`` on one card.

    python3 scripts/full_human_torch.py [genome_gb] [coverage]

The simulation is full_human.py's: a ``genome_gb`` genome (default 3.2) in
26 contigs, 400 gaps of 10-120 bp with a 15% lognormal tail, 2x101 bp
reads, insert 300 +- 30, ``coverage`` (default 0.6), 0.3% errors, seed 5;
``Parameters(trim_len=0, genome_shard="contig")``.  The genome shards lie
on one card: a (reads 1, genome G) mesh of the card repeated, G = 2 by
default, the fewest shards whose local positions stay below 2^31 at 2.2
to 3.2 Gb (``parallel.sharded.build_contig_shards`` raises where a shard
would pass them).  Each shard's flat slice and k-mer table are built on
the card.

``run`` is the flow (``chip_smoke.py`` and the tests call it too):

1. simulate; at 2.2 Gb and more the padded flat genome must reach 2^31
   positions;
2. ``Pipeline.run_iteration("p", 0)``, then ``run_iteration("u", 0)`` on
   the same ``Pipeline`` (the ``default: 1`` schedule follows p with u;
   the reduced genome keeps every gap-bearing contig, so the u pass is the
   end-to-end contig-sharded aligner over the whole genome);
3. full_human.py's part 2: the first two contigs and their reads through a
   p-iteration contig-sharded (``contig_shard_threshold=1``) and on the
   replicated aligner: the gap strings must be equal;
4. the per-read truth check: of the pairs whose first mate the p-iteration
   aligned uniquely, the share aligned forward at its simulated contig and
   start, split by the simulated start's global flat position (below 2^31
   and past it), over the contigs whose draft is as long as their truth
   (the simulator's stacked gaps shift the others' coordinates,
   ``chr14_scale_torch.truth_starts``);
5. up to three of the p-iteration's gaps past 2^31 that received reads
   through ``fill_gaps`` on the run's device and on the CPU (on the card:
   a ``chr14_scale_torch.CpuJob`` beside the u-iteration), on their contig
   alone,
   the scan capped at ``SAMPLE_SCAN`` lengths: gap strings and gaptofill
   equal.

At 2.2 Gb and 0.1x (full_human.py's round-5 run, ``FULL_HUMAN_r05.md``)
the simulation's figures and the N counts are asserted as the reference
recorded them; from 1x on, N must go down in the p-iteration and the
filled-base accuracy (``chr14_scale_torch.fill_accuracy``) be at least
0.95, the truth share past 2^31 within 0.5 points of the share below; on
the card K5 must launch on every shard in both iterations and K1-K4 in
them.  Each stage's wall, peak device memory and peak host RSS go to
stderr; the last line of standard output is one JSON object.  The script
writes no file.  It runs on the card and raises where there is none.
"""

from __future__ import annotations

import json
import os
import resource
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chr14_scale_torch as chr14  # noqa: E402
from chr14_scale_torch import Captured, CpuJob, K5ByShard, log  # noqa: E402
from figbird_tpu_torch import config, ops, pipeline  # noqa: E402
from figbird_tpu_torch.combine import combine_gap_history  # noqa: E402
from figbird_tpu_torch.fill import driver  # noqa: E402
from figbird_tpu_torch.genome import GapInfo, Genome  # noqa: E402
from figbird_tpu_torch.parallel import make_mesh  # noqa: E402
from figbird_tpu_torch.simulate import SimConfig, simulate  # noqa: E402

DEFAULT_GB, DEFAULT_COVERAGE = 3.2, 0.6
# full_human.py's SimConfig widths, which no run changes
WIDTHS = dict(n_contigs=26, n_gaps=400, gap_len_range=(10, 120),
              gap_len_tail=0.15, read_len=101, insert_mean=300, insert_sd=30,
              error_rate=0.003, seed=5)
PAD = 256                # build_index's inter-contig pad
INT32_END = 2 ** 31
# FULL_HUMAN_r05.md: full_human.py at 2.2 Gb and 0.1x
R05 = dict(genome_gb=2.2, coverage=0.1, genome_len=2_199_999_984,
           flat=2_200_006_896, n_reads=2_178_216, n_before=38_264,
           n_after=38_264)
MIN_ACCURACY = 0.95
MAX_SHARE_GAP = 0.005    # truth share past 2^31 against below it
SAMPLE_SCAN = chr14.SAMPLE_SCAN
N_SAMPLES = 3


def sim_config(genome_gb: float = DEFAULT_GB,
               coverage: float = DEFAULT_COVERAGE,
               n_gaps: int | None = None) -> SimConfig:
    """full_human.py's simulation; ``n_gaps`` replaces its 400 gaps (a
    tiny CPU form's)."""
    widths = dict(WIDTHS) if n_gaps is None else dict(WIDTHS, n_gaps=n_gaps)
    return SimConfig(genome_len=int(genome_gb * 1e9), coverage=coverage,
                     **widths)


def fh_config() -> config.FigbirdConfig:
    """full_human.py's FigbirdConfig: one frag library, no flank trim,
    contig-range genome shards."""
    return config.FigbirdConfig(
        draft_genome="", output_folder="",
        read_pairs=[config.ReadLibrary("", "", avg_insert_size=300,
                                       max_read_length=101)],
        parameters=config.Parameters(trim_len=0, genome_shard="contig"))


def flat_offsets(genome) -> np.ndarray:
    """``build_index``'s contig starts in the padded flat genome (int64)."""
    lens = genome.lengths
    return PAD * np.arange(1, len(lens) + 1, dtype=np.int64) + np.concatenate(
        [[0], np.cumsum(lens)[:-1]]).astype(np.int64)


def rss() -> int:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def _stage(name: str, t0: float, dev, **extra) -> dict:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    rec = dict(wall_s=round(time.time() - t0, 3), peak_host_rss_bytes=rss(),
               peak_device_bytes=(torch.cuda.max_memory_allocated(dev)
                                  if dev.type == "cuda" else None), **extra)
    log(f"{name}: wall {rec['wall_s']}s, peak device "
        f"{rec['peak_device_bytes']} B, peak host RSS "
        f"{rec['peak_host_rss_bytes']} B")
    return rec


def _iteration(pipe, mode, dev, shards: K5ByShard):
    """One iteration, the launch counts set to 0 just before and read just
    after; its record and the fill's inputs and plans."""
    with Captured(pipeline, "fill_gaps") as fills, \
            Captured(driver, "plan_gaps") as plans:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launches()
        shards.reset()
        before = {k: s["seconds"] for k, s in pipe.timer.stages.items()}
        t0 = time.time()
        st = pipe.run_iteration(mode, 0)
        rec = _stage(f"{mode}-iteration", t0, dev)
    rec.update(
        n_before=st.n_before, n_after=st.n_after, n_model=st.n_model,
        gaps=st.gaps, filled=st.filled, n_pairs=st.n_pairs,
        stages=chr14._stage_split(pipe.timer, before),
        launches=dict(ops.LAUNCHES),
        launches_by_shape={f"{k}/{r}/{w}": n for (k, r, w), n in
                           sorted(ops.LAUNCHES_BY_SHAPE.items())},
        k5_by_shard={str(g): n for g, n in sorted(
            shards.counts.items(), key=lambda x: str(x[0]))},
        fill_stats={k: v for k, v in pipe.last_fill_stats.items()
                    if not k.startswith("t_")})
    log(f"{mode}-iteration: N {st.n_before} -> {st.n_after}, n_model "
        f"{st.n_model}, stages {rec['stages']}, launches {rec['launches']}, "
        f"K5 by shard {rec['k5_by_shard']}, by shape "
        f"{rec['launches_by_shape']}")
    fill_call = fills.calls[0] if fills.calls else None
    plan_out = plans.calls[0][2] if plans.calls else []
    return st, rec, fill_call, plan_out


def truth_share(sim, a1: dict, offsets: np.ndarray,
                split_at: int = INT32_END) -> dict:
    """Of the pairs whose first mate aligned uniquely, the share aligned
    forward at its simulated contig and start, below ``split_at`` and past
    it (by the simulated start's global flat position), over the contigs
    whose draft is as long as their truth."""
    same_len = np.array([len(d) == len(t) for d, t in
                         zip(sim.draft.contigs, sim.truth.contigs)])
    ci = sim.true_contig.astype(np.int64)
    want = offsets[ci] + sim.true_pos
    uniq = a1["aligned"] & a1["unique"] & same_len[ci]
    right = uniq & (a1["strand"] == 0) & (a1["pos"] == want)
    out = dict(contigs_shifted=int((~same_len).sum()))
    for name, region in (("below", want < split_at),
                         ("past", want >= split_at)):
        n = int((uniq & region).sum())
        out[name] = dict(unique=n, right=int((right & region).sum()),
                         share=float((right & region).sum() / max(n, 1)))
    return out


def pick_past(genome, gaps, bundles, plans, offsets,
              split_at: int = INT32_END) -> list:
    """Up to ``N_SAMPLES`` of the fill's gaps that start past
    ``split_at`` and received reads, not skipped: those with the most
    partial reads."""
    past = [i for i, p in enumerate(plans)
            if offsets[gaps[i].contig] + gaps[i].start >= split_at
            and not p.skip and p.neg_merge == 0
            and (bundles[i].n_partial or bundles[i].n_unmapped)]
    past.sort(key=lambda i: (-bundles[i].n_partial, i))
    return past[:N_SAMPLES]


def sample_inputs(genome, gaps, bundles, model, f_kw, picks):
    """The picked gaps on their contigs alone: (genome, gaps, bundles,
    model, fill arguments) for ``chr14_scale_torch.cpu_fill`` and the
    card."""
    contigs = sorted({gaps[i].contig for i in picks})
    sub = Genome([genome.names[c] for c in contigs],
                 [genome.contigs[c] for c in contigs])
    sub_gaps = [GapInfo(contigs.index(gaps[i].contig), gaps[i].start,
                        gaps[i].length) for i in picks]
    kw = {k: v for k, v in f_kw.items() if k not in ("device", "mesh")}
    kw["max_scan_lengths"] = min(kw.get("max_scan_lengths") or SAMPLE_SCAN,
                                 SAMPLE_SCAN)
    return sub, sub_gaps, [bundles[i] for i in picks], model, kw


def fill_record(genome, gaps, bundles, model, kw, device) -> tuple:
    """``fill_gaps`` on ``device``: (strings, gaptofill, wall)."""
    t0 = time.time()
    res = driver.fill_gaps(genome, gaps, bundles, model, device=device, **kw)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return res.gap_strings, np.asarray(res.gaptofill), time.time() - t0


def subsampled_equal(sim, cfg, dev, shards: int, fill_kwargs=None,
                     aligner_kwargs=None) -> dict:
    """full_human.py's part 2: the first two contigs and their reads through
    a p-iteration contig-sharded and replicated; gap strings equal."""
    sub_draft = Genome(list(sim.draft.names[:2]), sim.draft.contigs[:2])
    keep = np.flatnonzero(sim.true_contig < 2)
    r1, r2 = sim.reads1.take(keep), sim.reads2.take(keep)
    al_kw = dict(aligner_kwargs or {})
    strings, walls, ns = {}, {}, {}
    for label, kw in (
            ("sharded", dict(mesh=make_mesh(shards, shards,
                                            devices=[dev] * shards),
                             aligner_kwargs=dict(
                                 al_kw, genome_shard="contig",
                                 contig_shard_threshold=1))),
            ("replicated", dict(device=dev, aligner_kwargs=al_kw))):
        p = pipeline.Pipeline(cfg, sub_draft, [(r1, r2)],
                              fill_kwargs=fill_kwargs, **kw)
        t0 = time.time()
        s = p.run_iteration("p", 0)
        walls[label] = round(time.time() - t0, 3)
        strings[label] = p.result.gap_history[0][1]
        ns[label] = (s.n_before, s.n_after)
        log(f"part 2 {label}: N {s.n_before} -> {s.n_after}, "
            f"{walls[label]}s")
    eq = len(strings["sharded"]) == len(strings["replicated"]) and all(
        np.array_equal(a, b)
        for a, b in zip(strings["sharded"], strings["replicated"]))
    return dict(equal=bool(eq), reads=2 * len(keep), walls_s=walls,
                n=ns, gaps=len(strings["replicated"]))


def run(genome_gb: float = DEFAULT_GB, coverage: float = DEFAULT_COVERAGE,
        device=None, genome_shards: int = 2, fill_kwargs: dict | None = None,
        aligner_kwargs: dict | None = None, n_gaps: int | None = None,
        split_at: int = INT32_END) -> dict:
    """The flow of the module docstring on ``device`` (``None``: the card,
    an error where there is none); ``fill_kwargs`` and ``aligner_kwargs``
    go to every ``Pipeline``.  A tiny CPU form passes ``n_gaps`` (the
    simulation's gaps) and ``split_at``, the flat position the truth share
    and the sample gaps split at in place of 2^31.  Returns the result's
    record (the JSON line)."""
    dev = ops.canonical_device(ops.entry_device(device))
    cuda = dev.type == "cuda"
    t_all = time.time()
    sc = sim_config(genome_gb, coverage, n_gaps)
    t0 = time.time()
    sim = simulate(sc)
    gaps0 = sim.draft.find_gaps()
    offsets = flat_offsets(sim.draft)
    total = sim.truth.total_length()
    flat_len = total + PAD * (len(sim.draft.contigs) + 1)
    n_reads = 2 * len(sim.reads1)
    n_sim = sim.draft.count_n()
    rec_sim = _stage("simulate", t0, dev)
    past_gaps = sum(offsets[g.contig] + g.start >= split_at for g in gaps0)
    log(f"simulated {total} bp (padded flat {flat_len}), {n_reads} reads, "
        f"{len(gaps0)} gaps ({past_gaps} past {split_at}), N {n_sim}")
    if genome_gb >= 2.2:
        assert flat_len >= INT32_END, "config 5 must pass int32 positions"
    anchor = (genome_gb, coverage, n_gaps) == (R05["genome_gb"],
                                               R05["coverage"], None)
    if anchor:
        assert (total, flat_len, n_reads, n_sim) == (
            R05["genome_len"], R05["flat"], R05["n_reads"], R05["n_before"]), \
            (total, flat_len, n_reads, n_sim)

    cfg = fh_config()
    kw = dict(fill_kwargs=fill_kwargs)
    mesh = make_mesh(genome_shards, genome_shards,
                     devices=[dev] * genome_shards)
    pipe = pipeline.Pipeline(
        cfg, sim.draft, [(sim.reads1, sim.reads2)], mesh=mesh,
        aligner_kwargs={"genome_shard": "contig", **(aligner_kwargs or {})},
        **kw)
    with K5ByShard() as shards:
        st_p, rec_p, fill_p, plans_p = _iteration(pipe, "p", dev, shards)
        share = truth_share(sim, pipe.last_alignments[0], offsets,
                            split_at)
        log(f"truth share of uniquely aligned first mates: {share}")
        (_, strings_p, _), = pipe.result.gap_history
        acc_p = chr14.fill_accuracy(sim, gaps0, strings_p)
        log(f"p accuracy {acc_p}")

        # the sample gaps past 2^31: the CPU side beside the u-iteration
        samples, job = None, None
        picks = pick_past(*fill_p[0][:3], plans_p, offsets, split_at) \
            if fill_p else []
        if picks:
            one = sample_inputs(*fill_p[0], fill_p[1], picks)
            if cuda:
                job = CpuJob(chr14.cpu_fill, *one)
            s_dev, g_dev, t_dev = fill_record(*one, device=dev)
        st_u, rec_u, _, _ = _iteration(pipe, "u", dev, shards)
    acc_all = chr14.fill_accuracy(sim, gaps0, [
        cg.seq for cg in combine_gap_history(pipe.result.gap_history)])
    del pipe

    t0 = time.time()
    part2 = subsampled_equal(sim, cfg, dev, genome_shards,
                             fill_kwargs=fill_kwargs,
                             aligner_kwargs=aligner_kwargs)
    part2.update(_stage("part 2", t0, dev))

    if picks:
        t0 = time.time()
        if job is not None:
            cpu_rec, _ = job.result()
            s_cpu, g_cpu = cpu_rec["strings"], cpu_rec["gaptofill"]
        else:
            s_cpu, g_cpu, _ = fill_record(*one, device="cpu")
        equal = len(s_dev) == len(s_cpu) and all(
            np.array_equal(a, b) for a, b in zip(s_dev, s_cpu)) \
            and np.array_equal(g_dev, g_cpu)
        samples = dict(
            gaps=picks, lengths=[gaps0[i].length for i in picks],
            partial_reads=[fill_p[0][2][i].n_partial for i in picks],
            equal=bool(equal), device_s=round(t_dev, 3),
            cpu_wait_s=round(time.time() - t0, 3),
            same_as_iteration=[bool(np.array_equal(s, strings_p[i]))
                               for s, i in zip(s_dev, picks)])
        log(f"sample gaps past 2^31: {samples}")

    out = dict(
        genome_gb=genome_gb, coverage=coverage, genome_len=total,
        flat=flat_len, n_reads=n_reads, n_gaps=len(gaps0),
        split_at=split_at, gaps_past=past_gaps, n_sim=n_sim,
        genome_shards=genome_shards,
        device=str(dev), simulate=rec_sim, p=rec_p, u=rec_u,
        accuracy_p=acc_p, accuracy_p_u=acc_all, truth_share=share,
        part2=part2, samples=samples,
        reference_r05=R05 if anchor else None,
        wall_s=round(time.time() - t_all, 3), peak_host_rss_bytes=rss(),
        nvidia_smi=chr14.smi_line() if cuda else None)

    assert st_p.n_before == n_sim, (st_p.n_before, n_sim)
    assert part2["equal"], "part 2: sharded and replicated gap strings differ"
    if anchor:
        assert (st_p.n_before, st_p.n_after) == (R05["n_before"],
                                                 R05["n_after"]), \
            (st_p.n_before, st_p.n_after)
    if coverage >= 1.0:
        assert st_p.n_after < st_p.n_before, "p-iteration: N not reduced"
        assert acc_p["identity"] >= MIN_ACCURACY, f"p accuracy {acc_p}"
        below, past = share["below"], share["past"]
        if past["unique"] and below["unique"]:
            assert abs(past["share"] - below["share"]) <= MAX_SHARE_GAP, share
    if samples is not None:
        assert samples["equal"], f"sample gaps differ on {dev} and the CPU"
    if cuda:
        for mode, rec in (("p", rec_p), ("u", rec_u)):
            missing = [g for g in range(genome_shards)
                       if not rec["k5_by_shard"].get(str(g))]
            assert not missing, f"{mode}: K5 not launched on shards {missing}"
            if rec["filled"]:
                # a u-iteration runs no partial EM, so no overlap bonus
                idle = [k for k, n in rec["launches"].items()
                        if n == 0 and (mode == "p" or k != "overlap")]
                assert not idle, f"{mode}: kernels not launched: {idle}"
    return chr14._jsonable(out)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if torch.cuda.is_available():
        from figbird_tpu_torch.ops import _build

        log(f"kernels built in {_build.build():.1f}s")
    out = run(float(argv[0]) if argv else DEFAULT_GB,
              float(argv[1]) if len(argv) > 1 else DEFAULT_COVERAGE)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
