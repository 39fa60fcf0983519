"""A seeded sample of the calls that one unit of the timed path makes to the
port's ops, and their outputs, for the plain reference to work out again.

``CallSample.active()`` wraps the five ops (K1-K5) and the EM's consensus
wherever the port's modules hold them.  Of each op's calls it keeps
``per_op`` (a reservoir drawn from the seed); of a kept call one instance
with work in it (K1-K4, the consensus) or ``rows`` reads (K5), drawn from
the seed, copied to the host with that call's output.  It slows the unit it
watches (every kept call waits for the device), so it watches a unit after
the window.

``numbers(sample)`` are the comparisons that ``correct`` makes of them:

- ``soft_score_err``, ``hard_score_err``: the largest gap between the
  port's score and the reference's, over ``max(|reference|, 1)``;
- ``counts_err``: the largest gap between the port's count (the cascade's,
  K1, and the fold's, K4) and the reference's, over
  ``max(|reference|, 1e-30)``;
- ``candidate_scores_off``: K5's outputs (score, whole-read score, start,
  end, mismatches of each candidate) that differ;
- ``consensus_off``: consensus bases that differ.

With ``control=True`` the reference computed in TF32 stands in the port's
place (``port_bench/readings.py`` reads it; no run of the benchmark does).
"""

from __future__ import annotations

import contextlib
import inspect

import numpy as np

from port_bench.harness import tracing
from port_bench.reference import direct

OPS = ("band_score_soft", "band_score_hard", "cascade_counts", "fold_counts",
       "score_candidates", "consensus_from_counts")


def _host(x):
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class CallSample:
    def __init__(self, seed: int, per_op: int = 6, rows: int = 64):
        self.rng = np.random.default_rng([int(seed), 0x5EED])
        self.per_op, self.rows = per_op, rows
        self.kept = {op: [] for op in OPS}
        self.seen = {op: 0 for op in OPS}

    @contextlib.contextmanager
    def active(self):
        with contextlib.ExitStack() as stack:
            for op in OPS:
                def make(fn, op=op):
                    sig = inspect.signature(fn)

                    def wrapper(*args, **kwargs):
                        out = fn(*args, **kwargs)
                        slot = self._slot(op)
                        if slot is not None:
                            a = sig.bind(*args, **kwargs).arguments
                            rec = getattr(self, f"_take_{op}")(a, out)
                            if rec is not None:
                                if slot < len(self.kept[op]):
                                    self.kept[op][slot] = rec
                                else:
                                    self.kept[op].append(rec)
                        return out
                    return wrapper
                stack.enter_context(tracing.rebind(tracing.find_op(op), op,
                                                   make))
            yield self

    def _slot(self, op: str):
        """Reservoir sampling: the slot this call takes, or None."""
        n = self.seen[op]
        self.seen[op] += 1
        if n < self.per_op:
            return n
        k = int(self.rng.integers(0, n + 1))
        return k if k < self.per_op else None

    def _instance(self, busy) -> int | None:
        idx = np.flatnonzero(_host(busy).reshape(len(busy), -1).any(axis=1))
        return int(self.rng.choice(idx)) if idx.size else None

    def _take_band_score_soft(self, a, out):
        i = self._instance(a["valid"])
        if i is None:
            return None
        return dict(codes=_host(a["codes"][i]), valid=_host(a["valid"][i]),
                    A=_host(a["A"][i]), B=_host(a["B"][i]),
                    e_pos=_host(a["e_pos"]), Wp=int(a["Wp"]),
                    out=_host(out[i]))

    def _take_band_score_hard(self, a, out):
        i = self._instance(a["valid"])
        if i is None:
            return None
        return dict(codes=_host(a["codes"][i]), valid=_host(a["valid"][i]),
                    g=_host(a["gap_string"][i]), a=_host(a["a"]),
                    b=_host(a["b"]), ln_et=_host(a["ln_et"]),
                    Wp=int(a["Wp"]), out=_host(out[i]))

    def _take_fold_counts(self, a, out):
        i = self._instance(a["vals"])
        if i is None:
            return None
        return dict(weights=_host(a["weights"][i]),
                    codes=_host(a["codes"][i]), vals=_host(a["vals"][i]),
                    W=int(a["W"]), out=_host(out[i]))

    def _take_cascade_counts(self, a, out):
        i = self._instance(a["vals"])
        if i is None:
            return None
        return dict(lw=_host(a["lw"][i]), codes=_host(a["codes"][i]),
                    vals=_host(a["vals"][i]), W=int(a["W"]), m=int(a["m"]),
                    shift=float(a["shift"]), cut=float(a["cut"]),
                    out=_host(out[i]))

    def _take_score_candidates(self, a, out):
        import torch

        reads, cand = a["reads"], a["cand"]
        B, L = reads.shape
        if B == 0:
            return None
        rows = np.sort(self.rng.choice(B, min(self.rows, B), replace=False))
        r = torch.as_tensor(rows, device=reads.device)
        at = cand[r].long()[..., None] + torch.arange(L, device=cand.device)
        return dict(windows=_host(a["flat"][at]), reads=_host(reads[r]),
                    match=int(a["match"]), mismatch=int(a["mismatch"]),
                    gap_code=int(a["gap_code"]),
                    out={k: _host(v[r]) for k, v in out.items()})

    def _take_consensus_from_counts(self, a, out):
        counts = a["counts"]
        W = counts.shape[-2]
        c = counts.reshape(-1, W, 5)
        zone = a["gap_zone"].expand(counts.shape[:-1]).reshape(-1, W)
        i = self._instance(zone)
        if i is None:
            return None
        cov = a["cov_thresh"]
        return dict(counts=_host(c[i]), zone=_host(zone[i]),
                    check=int(a["check"]), cov=float(_host(cov)),
                    out=_host(out[0].reshape(-1, W)[i]))


def _gap(got, want, floor: float) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        return float("inf")
    if not got.size:
        return 0.0
    d = np.abs(got - want) / np.maximum(np.abs(want), floor)
    return float(np.nan_to_num(d, nan=np.inf).max())


def numbers(sample: CallSample, control: bool = False) -> dict:
    """The comparisons of the sampled calls with the reference (or, with
    ``control``, of the reference in TF32 with the reference)."""
    k = sample.kept
    out = {}

    def worst(op, ref, floor, name):
        v = out.get(name, 0.0)
        for c in k[op]:
            want = ref(c, False)
            got = ref(c, True) if control else c["out"]
            v = max(v, _gap(got, want, floor))
        out[name] = v

    worst("band_score_soft", lambda c, tf: direct.soft_scores(
        c["codes"], c["valid"], c["A"], c["B"], c["e_pos"], c["Wp"], tf),
        1.0, "soft_score_err")
    worst("band_score_hard", lambda c, tf: direct.hard_scores(
        c["codes"], c["valid"], c["g"], c["a"], c["b"], c["ln_et"], c["Wp"],
        tf), 1.0, "hard_score_err")
    worst("cascade_counts", lambda c, tf: direct.cascade_counts(
        c["lw"], c["codes"], c["vals"], c["W"], c["m"], c["shift"],
        c["cut"], tf), 1e-30, "counts_err")
    worst("fold_counts", lambda c, tf: direct.fold_counts(
        c["weights"], c["codes"], c["vals"], c["W"], tf), 1e-30,
        "counts_err")
    if not control:
        off = 0
        for c in k["score_candidates"]:
            want = direct.score_candidates(c["windows"], c["reads"],
                                           c["match"], c["mismatch"],
                                           c["gap_code"])
            off += sum(int((np.asarray(c["out"][f], np.int64) != v).sum())
                       for f, v in want.items())
        out["candidate_scores_off"] = off
        off = 0
        for c in k["consensus_from_counts"]:
            cons, _ = direct.consensus(c["counts"], c["zone"], c["check"],
                                       c["cov"])
            off += int((cons != c["out"]).sum())
        out["consensus_off"] = off
    return out


def calls_made(sample: CallSample) -> dict:
    """op -> (calls seen, calls kept)."""
    return {op: (sample.seen[op], len(sample.kept[op])) for op in OPS}
