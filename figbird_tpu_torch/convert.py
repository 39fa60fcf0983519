"""Carry the JAX package's state across to the port.

The port has its own ``Genome``, ``ReadBatch``, ``KmerIndex``,
``ModelStats``, ``ErrorModel`` and config classes.  The functions here turn
the reference's objects into the port's by reading their attributes:
everything crosses as numpy arrays (``np.asarray`` of a JAX array needs no
JAX import here) and plain Python values, so the same inputs can be fed to
both packages.  Nothing of ``figbird_tpu`` is imported.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import config as _config
from .align.banded import BandedParams
from .align.core import AlignParams
from .align.index import KmerIndex
from .fill.em import FillConfig
from .genome import GapInfo, Genome
from .io.fastq import ReadBatch
from .model.error_model import ErrorModel, ModelStats
from .simulate import SimData
from .triage.assign import GapBundle


def _as(cls, obj, **over):
    """``cls`` built from the same-named attributes of ``obj`` (arrays
    copied); ``over`` replaces fields that need a conversion of their own."""
    kw = {}
    for f in dataclasses.fields(cls):
        v = over[f.name] if f.name in over else getattr(obj, f.name)
        kw[f.name] = v.copy() if isinstance(v, np.ndarray) else v
    return cls(**kw)


def to_tensors(arrays: dict, device="cpu") -> dict:
    """A dict of arrays (the reference's ``_model_arrays`` dict, instance
    dicts or per-gap array dicts) as tensors on ``device``."""
    return {k: torch.as_tensor(np.array(v), device=device)
            for k, v in arrays.items()}


def fill_config(cfg) -> FillConfig:
    """The reference's ``FillConfig`` as the port's (same fields)."""
    return _as(FillConfig, cfg)


def kmer_tables(tables: dict, device="cpu") -> dict:
    """The reference aligner's prefix-bucket tables (``starts2d``,
    ``codes2d``, ``pos2d``, each (rows, 128)) in the port's flat layout."""
    return {k: torch.as_tensor(np.array(tables[k + "2d"]).reshape(-1),
                               device=device)
            for k in ("starts", "codes", "pos")}


def align_params(p) -> AlignParams:
    """The reference's ``AlignParams`` (the end-to-end preset included)."""
    return _as(AlignParams, p)


def banded_params(p) -> BandedParams:
    return _as(BandedParams, p)


def gap_info(g) -> GapInfo:
    return _as(GapInfo, g)


def gap_bundle(b) -> GapBundle:
    """A per-gap read bundle, partial and unmapped reads (``u_seq``,
    ``u_pos``, ``u_rev``) alike; the read arrays are copied."""
    out = GapBundle(gap_info(b.gap))
    for f in dataclasses.fields(GapBundle):
        if f.name == "gap" or f.name.startswith("_"):
            continue
        v = getattr(b, f.name)
        setattr(out, f.name, [x.copy() if isinstance(x, np.ndarray) else x
                              for x in v] if isinstance(v, list) else v)
    return out


def genome(g) -> Genome:
    return Genome(list(g.names), [np.array(c, np.int8) for c in g.contigs])


def read_batch(b) -> ReadBatch:
    return _as(ReadBatch, b)


def kmer_index(idx) -> KmerIndex:
    return _as(KmerIndex, idx)


def model_stats(st) -> ModelStats:
    return _as(ModelStats, st)


def error_model(model) -> ErrorModel:
    """A finished error model, with its ``(stats, histogram)`` snapshot
    where the pipeline attached one."""
    out = _as(ErrorModel, model)
    snap = getattr(model, "snapshot", None)
    if snap is not None:
        out.snapshot = (model_stats(snap[0]), np.array(snap[1]))
    return out


def figbird_config(cfg) -> _config.FigbirdConfig:
    return _as(
        _config.FigbirdConfig, cfg,
        read_pairs=[_as(_config.ReadLibrary, lib) for lib in cfg.read_pairs],
        parameters=_as(_config.Parameters, cfg.parameters))


def sim_data(sim) -> SimData:
    """A simulated dataset (truth, draft, both read batches, true
    placements)."""
    return _as(SimData, sim, truth=genome(sim.truth), draft=genome(sim.draft),
               reads1=read_batch(sim.reads1), reads2=read_batch(sim.reads2))
