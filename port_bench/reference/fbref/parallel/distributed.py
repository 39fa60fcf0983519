"""Multi-process execution (``figbird_tpu/parallel/distributed.py``) over
``torch.distributed`` with the gloo backend.

One process per host (or per card) keeps a contiguous shard of every read
library; the genome and its index are replicated.  The processes merge at
the reference's two collective points:

1. **model sufficient statistics** — each process's sums are all-reduced,
   so the model is learned once, globally;
2. **per-gap read bundles and gap strings** — each process triages its own
   reads into per-gap bundles; the bundles are unioned in (process rank,
   local order) order, so the first-come caps and dedup stay reproducible;
   each process then fills a strided subset of the gaps and the strings
   are all-gathered, so every process splices the same assembly.

Every merge carries pickled host objects (``all_gather_object`` over gloo,
on the CPU): no CUDA tensor crosses.  Without an initialised process group
(or with one process) every merge is a no-op, so the pipeline code is the
same on one process and on N.
"""

from __future__ import annotations

import os

import numpy as np
import torch.distributed as dist


def init_from_env() -> bool:
    """Initialise the gloo process group from the FIGBIRD_* environment
    variables (a no-op without them).

    FIGBIRD_COORD=host:port  FIGBIRD_NPROCS=N  FIGBIRD_PROC=i
    Returns True when running multi-process.
    """
    coord = os.environ.get("FIGBIRD_COORD")
    if coord and not dist.is_initialized():
        dist.init_process_group(
            "gloo", init_method=f"tcp://{coord}",
            world_size=int(os.environ["FIGBIRD_NPROCS"]),
            rank=int(os.environ["FIGBIRD_PROC"]))
    return is_distributed()


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized() \
        and dist.get_world_size() > 1


def process_index() -> int:
    return dist.get_rank() if is_distributed() else 0


def process_count() -> int:
    return dist.get_world_size() if is_distributed() else 1


def shard_reads(n: int, proc: int | None = None, nprocs: int | None = None
                ) -> slice:
    """Contiguous read-pair shard for this process (host-level data split)."""
    p = process_index() if proc is None else proc
    np_ = process_count() if nprocs is None else nprocs
    per = -(-n // np_)
    return slice(p * per, min((p + 1) * per, n))


# ---------------------------------------------------------------- collectives

def allgather_obj(obj) -> list:
    """All-gather small picklable host objects, ordered by process rank."""
    if not is_distributed():
        return [obj]
    out = [None] * process_count()
    dist.all_gather_object(out, obj)
    return out


def allreduce_stats(st):
    """Merge point #1: sum ModelStats across processes."""
    if not is_distributed():
        return st
    parts = allgather_obj(st)
    out = parts[0]
    for p in parts[1:]:
        out = out.merge(p)
    return out


def merge_bundles(local_bundles: list) -> list:
    """Merge point #2a: union per-gap read bundles across processes.

    Bundles are re-inserted in (process-rank, local-order) order through the
    same dedup/cap logic, so the result is identical on every process and
    reproduces a single-process run over the full read set whose reads
    arrive grouped by shard.
    """
    if not is_distributed():
        return local_bundles
    from ..triage.assign import GapBundle

    payload = [_bundle_export(b) for b in local_bundles]
    parts = allgather_obj(payload)
    merged = [GapBundle(b.gap) for b in local_bundles]
    for proc_part in parts:
        for mb, data in zip(merged, proc_part):
            _bundle_absorb(mb, data)
    return merged


def _bundle_export(b):
    return dict(u=(b.u_seq, b.u_pos, b.u_rev),
                p=(b.p_seq, b.p_clip, b.p_match, b.p_pos, b.p_refpos,
                   b.p_qual),
                mim=(b.mim_flag, b.mim_len))


def _bundle_absorb(b, data):
    from ..dtypes import PARTIAL_LIMIT, UNMAPPED_LIMIT

    us, up, ur = data["u"]
    for s, p, r in zip(us, up, ur):
        if b.n_unmapped >= UNMAPPED_LIMIT:
            break
        h = s.tobytes()
        if h in b._u_hashes:
            continue
        b._u_hashes.add(h)
        b.u_seq.append(s)
        b.u_pos.append(p)
        b.u_rev.append(r)
    ps, pc, pm, pp, pr, pq = data["p"]
    for s, c, mt, p, r, q in zip(ps, pc, pm, pp, pr, pq):
        if b.n_partial >= PARTIAL_LIMIT:
            break
        h = s.tobytes()
        if h in b._p_hashes:
            continue
        b._p_hashes.add(h)
        b.p_seq.append(s)
        b.p_clip.append(c)
        b.p_match.append(mt)
        b.p_pos.append(p)
        b.p_refpos.append(r)
        b.p_qual.append(q)
    mf, ml = data["mim"]
    if mf and not b.mim_flag:
        b.mim_flag, b.mim_len = mf, ml


def my_gap_subset(n_gaps: int) -> np.ndarray:
    """Strided gap assignment for this process (FillGaps' balancer analogue:
    the stride interleaves small and large gaps evenly across processes)."""
    return np.arange(process_index(), n_gaps, process_count())


def allgather_gap_strings(n_gaps: int, mine: dict) -> list:
    """Merge point #2b: all-gather per-gap filled strings + skip counts.

    ``mine``: {gap_index: (np.int8 string, gaptofill_int)}.
    Returns dense list of (string, skip) for all gaps.
    """
    parts = allgather_obj(mine)
    out = [None] * n_gaps
    for part in parts:
        for gi, v in part.items():
            out[gi] = v
    missing = [i for i, v in enumerate(out) if v is None]
    if missing:
        raise RuntimeError(f"gaps unassigned across processes: {missing[:5]}")
    return out
