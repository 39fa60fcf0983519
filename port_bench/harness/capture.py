"""The units a window repeats, on the port and on the reference, and what
each unit's outputs are kept as.

An iteration unit is ``Pipeline(cfg, draft, libraries).run_iteration(mode,
lib)`` on a fresh ``Pipeline`` over the same inputs: every library of the
configuration, in its order, and ``lib`` the traffic's ``"lib"`` (0 where
it names none).  The outputs kept are the iteration's alignments (both
mates of the minimum-insert library, and the unmapped pass's of ``lib`` in
a u-iteration), the model, the per-gap read bundles and the fill's result
as the fill was called with them, and the spliced draft.  A run unit is the
port's command line (``__main__.main``) on files written at set-up; its
outputs are the files it wrote, and the seconds of the port's own
``StageTimer`` stages summed over the run by the iteration's mode
(``"p:align"``, ``"u:fill"``).  The reference runs the same iteration, or
``Pipeline.run`` in memory.  In the window an iteration is kept whole only
where the seed drew it (and the last); the others shrink to their gap
strings (``Record.light``) as they end, so the host's heap does not grow
with the window.  ``compare`` reads them after it.
"""

from __future__ import annotations

import contextlib
import importlib
import shutil
from dataclasses import dataclass, field
from pathlib import Path
from types import SimpleNamespace

import numpy as np

from port_bench.harness import inputs

PORT = "figbird_tpu_torch"
REFERENCE = "port_bench.reference.fbref"
# the largest insert of a fragment library (RunFigbird.sh:122)
FRAG_ISZ = 250


def package(name: str) -> SimpleNamespace:
    """The modules of a package (the port or the reference) that a unit
    uses."""
    mods = {m: importlib.import_module(f"{name}.{m}")
            for m in ("config", "genome", "pipeline", "combine")}
    mods["io"] = SimpleNamespace(fastq=importlib.import_module(
        f"{name}.io.fastq"))
    return SimpleNamespace(name=name, **mods)


@dataclass
class Light:
    """A window unit kept as its gap strings alone (and its stage clocks)."""
    strings: list
    stages: dict
    kind: str = "light"


@dataclass
class Record:
    """One unit's outputs (references, read after the window)."""
    kind: str                       # "iteration" or "run"
    alignments: list = field(default_factory=list)
    # per mate pair of ``alignments``: (library, against the whole draft)
    aligned: list = field(default_factory=list)
    model: object = None
    bundles: list = None
    fill: object = None
    genome: object = None
    draft: object = None            # the iteration's input draft
    stages: dict = field(default_factory=dict)
    folder: Path = None             # a run's output tree
    final: tuple = None             # a reference run's (names, contigs)
    combined: list = None           # a reference run's combined gaps
    n_iterations: int = 0

    def light(self):
        """The gap strings and clocks of an iteration (a run: itself)."""
        if self.kind != "iteration":
            return self
        return Light([(inputs.decode(np.asarray(s)), int(t)) for s, t in
                      zip(self.fill.gap_strings, self.fill.gaptofill)],
                     self.stages)


def _arrays(a: dict) -> dict:
    """An alignment dict's numpy arrays (no device handles)."""
    return {k: v for k, v in a.items() if isinstance(v, np.ndarray)}


@contextlib.contextmanager
def fill_capture(pipeline_mod, sink: list):
    """Wrap the ``fill_gaps`` that ``pipeline_mod`` calls so each call's
    bundles, model and result land in ``sink``."""
    fn = pipeline_mod.fill_gaps

    def wrapper(genome, gaps, bundles, model, **kw):
        res = fn(genome, gaps, bundles, model, **kw)
        sink.append((bundles, model, res))
        return res

    pipeline_mod.fill_gaps = wrapper
    try:
        yield
    finally:
        pipeline_mod.fill_gaps = fn


@contextlib.contextmanager
def stages_by_mode(pipeline_mod, sink: dict):
    """Wrap ``Pipeline.run_iteration`` of ``pipeline_mod`` so that the
    seconds each iteration adds to the pipeline's own ``StageTimer`` are
    added to ``sink`` under ``<mode>:<stage>``."""
    cls = pipeline_mod.Pipeline
    fn = cls.run_iteration

    def wrapper(self, mode, lib_i):
        before = {k: v["seconds"] for k, v in self.timer.stages.items()}
        try:
            return fn(self, mode, lib_i)
        finally:
            for k, v in self.timer.stages.items():
                key = f"{mode}:{k}"
                sink[key] = sink.get(key, 0.0) + v["seconds"] \
                    - before.get(k, 0.0)

    cls.run_iteration = wrapper
    try:
        yield
    finally:
        cls.run_iteration = fn


def judged_libraries(config: dict, mode: str, lib: int) -> list:
    """The (library, against the whole draft) of each mate pair that an
    iteration's alignments hold: the minimum-insert library's partial pass,
    then in a u-iteration library ``lib``'s end-to-end pass, which a
    fragment library (insert up to ``FRAG_ISZ``) runs against the draft's
    gap-bearing contigs alone (Figbird's RunFigbird.sh and Reduce_SCF)."""
    sizes = [b["avg_insert_size"] for b in inputs.library_blocks(config)]
    out = [(min(range(len(sizes)), key=sizes.__getitem__), True)]
    if mode == "u":
        out.append((lib, sizes[lib] > FRAG_ISZ))
    return out


class IterationUnit:
    """One iteration of ``mode`` on library ``lib`` (the traffic's ``"lib"``,
    default 0) on a fresh ``Pipeline`` of ``pkg`` over every library."""

    kind = "iteration"

    def __init__(self, pkg, cell, sim, device, pipeline_kwargs=None):
        self.pkg = pkg
        self.mode = cell.traffic["mode"]
        self.lib = int(cell.traffic.get("lib", 0))
        self.cfg = inputs.figbird_config(pkg, cell.config)
        self.draft, self.libs = inputs.objects(pkg, sim)
        self.aligned = judged_libraries(cell.config, self.mode, self.lib)
        self.device = device
        # options of the Pipeline that the configuration states (a test's
        # small batches), then the caller's (a control's fill options)
        self.kwargs = {**cell.config.get("pipeline", {}),
                       **(pipeline_kwargs or {})}

    def __call__(self) -> Record:
        pipe = self.pkg.pipeline.Pipeline(
            self.cfg, self.draft, self.libs, device=self.device,
            **self.kwargs)
        sink: list = []
        with fill_capture(self.pkg.pipeline, sink):
            pipe.run_iteration(self.mode, self.lib)
        (bundles, model, res), = sink
        als = [_arrays(a) for a in pipe.last_alignments]
        if self.mode == "u":
            als += [_arrays(a) for a in pipe.last_alignments_e2e]
        return Record("iteration", alignments=als, aligned=self.aligned,
                      model=model, bundles=bundles, fill=res,
                      genome=pipe.genome, draft=self.draft,
                      stages={k: v["seconds"]
                              for k, v in pipe.timer.stages.items()})

    def close(self) -> None:
        pass


class RunUnit:
    """The port's whole run through its command line, on files written at
    set-up under ``where``; each run writes a fresh output tree there."""

    kind = "run"

    def __init__(self, cell, sim, where: Path, device="cuda"):
        self.where = where
        self.base = inputs.write_run_inputs(sim, cell.config, where / "in")
        self.cli_args = [] if str(device).startswith("cuda") \
            else ["--device", str(device)]
        self.n = 0

    def __call__(self) -> Record:
        from figbird_tpu_torch import pipeline
        from figbird_tpu_torch.__main__ import main

        self.n += 1
        out = self.where / f"run{self.n}"
        cfg = inputs.write_run_config(self.base, self.where / f"run{self.n}"
                                      ".json", out)
        stages: dict = {}
        with stages_by_mode(pipeline, stages):
            rc = main([str(cfg), *self.cli_args])
        if rc != 0:
            raise RuntimeError(f"the command line exited with {rc}")
        return Record("run", folder=out / "Figbird", stages=stages)

    def close(self) -> None:
        shutil.rmtree(self.where, ignore_errors=True)


def reference_record(cell, sim, device, pipeline_kwargs=None,
                     pkg_name: str = REFERENCE) -> Record:
    """The reference's outputs for the cell's unit on the same inputs (a
    whole run in memory, with no files).  With ``pkg_name`` the port, the
    same of the port: how the control is read."""
    pkg = package(pkg_name)
    if cell.traffic["unit"] == "iteration":
        return IterationUnit(pkg, cell, sim, device, pipeline_kwargs)()
    cfg = inputs.figbird_config(pkg, cell.config)
    draft, libs = inputs.objects(pkg, sim)
    pipe = pkg.pipeline.Pipeline(cfg, draft, libs, device=device,
                                 **{**cell.config.get("pipeline", {}),
                                    **(pipeline_kwargs or {})})
    result = pipe.run()
    combined = pkg.combine.combine_gap_history(result.gap_history)
    return Record("run", final=(list(result.genome.names),
                                list(result.genome.contigs)),
                  combined=[cg.seq for cg in combined],
                  n_iterations=len(result.iterations))
