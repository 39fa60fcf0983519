"""Checkpoint / resume.

The reference persists every iteration's filled assembly
(``Filled_Scaffolds/<n>filledContigs.fa``, RunFigbird.sh:354-360) so runs can
be manually resumed from any iteration; its model store/load exists but is
dead code (Figbird.cpp:6748-6877).  Here both are first-class: the learned
``ErrorModel`` round-trips through a single ``.npz`` and a pipeline can resume
from the newest persisted assembly in a workdir.
"""

from __future__ import annotations

import dataclasses
import re
from pathlib import Path

import numpy as np

from ..model.error_model import ErrorModel


def save_model(path: str | Path, model: ErrorModel) -> None:
    fields = dataclasses.asdict(model)
    arrays = {}
    scalars = {}
    for k, v in fields.items():
        if isinstance(v, np.ndarray):
            arrays[k] = v
        else:
            scalars[k] = v
    np.savez_compressed(path, __scalars__=np.array([repr(scalars)]), **arrays)


def load_model(path: str | Path) -> ErrorModel:
    data = np.load(path, allow_pickle=False)
    scalars = eval(str(data["__scalars__"][0]),  # noqa: S307 - our own repr
                   {"__builtins__": {}}, {"True": True, "False": False})
    kwargs = dict(scalars)
    for k in data.files:
        if k != "__scalars__":
            kwargs[k] = data[k]
    return ErrorModel(**kwargs)


def latest_iteration(workdir: str | Path) -> tuple[int, Path | None]:
    """Newest persisted assembly ``Filled_Scaffolds/<n>filledContigs.fa``."""
    d = Path(workdir) / "Filled_Scaffolds"
    best, best_path = 0, None
    if d.is_dir():
        for p in d.glob("*filledContigs.fa"):
            m = re.match(r"(\d+)filledContigs\.fa$", p.name)
            if m and int(m.group(1)) > best:
                best, best_path = int(m.group(1)), p
    return best, best_path
