"""ctypes bridge to the native C++ data path (``native/figbird_native.cpp``).

Copy of ``figbird_tpu/io/native.py``, except where the library lands: the
shared library is built from the repository's ``native/figbird_native.cpp``
on first use into ``figbird_tpu_torch/_build/`` (ignored by git), under a
name that carries the hash of the source and the flags, so the two packages
never share a build product.  Callers fall back to the numpy
implementations, which give the same outputs, when no compiler is
available.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parents[2] / "native" / "figbird_native.cpp"
_BUILD = Path(__file__).resolve().parents[1] / "_build"
# native/Makefile's flags
_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-march=native", "-Wall", "-shared")
_lib = None
_tried = False


def _target() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes()
                            + " ".join(_FLAGS).encode()).hexdigest()[:16]
    return _BUILD / f"libfigbird_native-{digest}.so"


def get_lib():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not _SRC.exists():
        return None
    path = _target()
    if not path.exists():
        _BUILD.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        try:
            subprocess.run(["g++", *_FLAGS, "-o",
                            str(tmp), str(_SRC)], check=True,
                           capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError):
            return None
        os.replace(tmp, path)
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return None
    lib.fb_count_fastq.restype = ctypes.c_int64
    lib.fb_count_fastq.argtypes = [ctypes.c_char_p]
    lib.fb_scan_fastq.restype = ctypes.c_int64
    lib.fb_scan_fastq.argtypes = [ctypes.c_char_p,
                                  ctypes.POINTER(ctypes.c_int32)]
    lib.fb_parse_fastq.restype = ctypes.c_int64
    lib.fb_parse_fastq.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.fb_build_kmer_table.restype = ctypes.c_int64
    lib.fb_build_kmer_table.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p]
    lib.fb_revcomp_batch.restype = None
    lib.fb_revcomp_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32]
    _lib = lib
    return _lib


def native_read_fastq(path: str, max_len: int | None = None):
    """Fast path for io.fastq.read_fastq; returns ReadBatch or None."""
    lib = get_lib()
    if lib is None:
        return None
    from .fastq import ReadBatch

    p = str(path).encode()
    ml = ctypes.c_int32(0)
    n = lib.fb_scan_fastq(p, ctypes.byref(ml))
    if n < 0:
        return None
    if max_len is None:
        max_len = max(int(ml.value), 1)
    seq = np.full((n, max_len), 4, np.int8)
    lens = np.zeros(n, np.int32)
    qual = np.zeros((n, max_len), np.uint8)
    got = lib.fb_parse_fastq(p, n, max_len,
                             seq.ctypes.data, lens.ctypes.data, qual.ctypes.data)
    if got < 0:
        return None
    return ReadBatch(seq[:got], lens[:got], qual[:got])


def native_kmer_table(flat: np.ndarray, k: int):
    """Fast path for align.index build; returns (codes, pos) int32 or None."""
    lib = get_lib()
    if lib is None:
        return None
    flat = np.ascontiguousarray(flat, np.int8)
    m = lib.fb_build_kmer_table(flat.ctypes.data, len(flat), k, None, None)
    codes = np.zeros(m, np.int32)
    pos = np.zeros(m, np.int32)
    got = lib.fb_build_kmer_table(flat.ctypes.data, len(flat), k,
                                  codes.ctypes.data, pos.ctypes.data)
    if got != m:
        return None
    return codes, pos
