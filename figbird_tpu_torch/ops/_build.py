"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` has plain C entry points (``ENTRY``; ``band_hard.cu``
has two) that take pointers and the stream as ``void*`` and return
``cudaGetLastError()``.  A source is compiled at first use for ``sm_90a``
into ``figbird_tpu_torch/_build/`` under a name that carries the hash of the
source, of every header ``csrc/*.cuh`` and of the flags, so an edited source
or header is rebuilt and an unchanged one is loaded as it is.  ``build()``
starts one ``nvcc`` per source, all at once, and waits for them together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "_build"
_P, _I, _LL, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
# each C launcher: its source, entry point and argument types (pointers and
# the stream as void*); every launcher returns cudaGetLastError() as an int
ENTRY = {
    "align_score": ("align_score", "score_candidates_launch",
                    (_P, _P, _P, _P, _LL, _LL, _I, _I, _I, _I, _I, _P)),
    "band_soft": ("band_soft", "band_soft_launch",
                  (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P)),
    "band_hard": ("band_hard", "band_hard_launch",
                  (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P)),
    "band_hard_gap": ("band_hard", "band_hard_gap_launch",
                      (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P)),
    "fold": ("fold", "fold_launch", (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P)),
    "cascade": ("cascade", "cascade_launch",
                (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _P)),
}
SOURCES = tuple(dict.fromkeys(src for src, _, _ in ENTRY.values()))
# no --use_fast_math and no -ftz=true: the soft-pass kernel needs precise
# logf, the cascade precise expf whose f32 denormals stay denormals
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v", "-I", str(CSRC))

_launchers: dict = {}
_lock = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (nvcc on PATH or /usr/local/cuda/bin)")
    return path


def target(name: str) -> Path:
    """The shared library a source builds into (content-addressed)."""
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(
        src + headers + " ".join(FLAGS).encode()).hexdigest()[:16]
    return BUILD / f"lib{name}-{digest}.so"


def build(names=SOURCES) -> float:
    """Compile every named source not yet built, in parallel; returns the
    seconds spent.  Each compiler log lands beside its library (``.log``)."""
    t0 = time.time()
    jobs = []
    for name in names:
        out = target(name)
        if out.exists():
            continue
        BUILD.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [_nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((name, proc, tmp, out))
    failed = []
    for name, proc, tmp, out in jobs:
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.time() - t0


def launcher(name: str):
    """The C launcher ``name`` of ``ENTRY``, typed (its source built and
    loaded first if needed)."""
    with _lock:
        fn = _launchers.get(name)
        if fn is None:
            src, entry, argtypes = ENTRY[name]
            build([src])
            fn = getattr(ctypes.CDLL(str(target(src))), entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _launchers[name] = fn
        return fn


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: launch failed with CUDA error {err}")


def stream(device) -> int:
    """PyTorch's current CUDA stream on ``device``, as a pointer value."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream
