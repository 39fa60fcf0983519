"""Base encodings and global constants.

The whole framework represents nucleotide sequences as ``int8`` arrays with the
same 5-letter code the reference uses (charCodes table, Figbird.cpp:7060-7082):

    A -> 0, C -> 1, G -> 2, T -> 3, everything else (N, ambiguity codes) -> 4

Sequences live in numpy/JAX arrays; there is no string shuttling on the hot
path.  ``GAP_CODE`` (= N) doubles as the padding value for ragged batches so a
padded tail behaves exactly like a run of Ns.
"""

from __future__ import annotations

import numpy as np

# --- nucleotide codes ------------------------------------------------------
A, C, G, T, N = 0, 1, 2, 3, 4
GAP_CODE = N
N_BASES = 5  # size of the code alphabet (incl. N)

# Lookup tables ---------------------------------------------------------------
# byte -> code (uppercase + lowercase handled; everything else -> 4)
_CHAR_TO_CODE = np.full(256, N, dtype=np.int8)
for _ch, _code in (("A", A), ("C", C), ("G", G), ("T", T)):
    _CHAR_TO_CODE[ord(_ch)] = _code
    _CHAR_TO_CODE[ord(_ch.lower())] = _code

_CODE_TO_CHAR = np.frombuffer(b"ACGTN", dtype=np.uint8)

# complement code table: A<->T, C<->G, N->N
COMPLEMENT = np.array([T, G, C, A, N], dtype=np.int8)

# Reference default limits (Figbird.cpp:114-115, Preprocess.cpp caps)
PARTIAL_LIMIT = 3000
UNMAPPED_LIMIT = 3000
MAX_INSERT_SIZE_FLOOR = 20000  # Figbird.cpp:7091
MAX_GAP = 100000  # Figbird.cpp:30


def encode(seq: str | bytes) -> np.ndarray:
    """Encode an ASCII nucleotide string into int8 codes."""
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    raw = np.frombuffer(seq, dtype=np.uint8)
    return _CHAR_TO_CODE[raw]


def decode(codes: np.ndarray) -> str:
    """Decode int8 codes back into an ACGTN string."""
    codes = np.asarray(codes)
    return _CODE_TO_CHAR[np.clip(codes, 0, 4)].tobytes().decode("ascii")


def revcomp(codes: np.ndarray) -> np.ndarray:
    """Reverse-complement an encoded sequence (matches reverse(), Reverse.cpp:14-39)."""
    return COMPLEMENT[np.asarray(codes)][::-1]


def phred_to_error_prob(qual: np.ndarray | bytes | str) -> np.ndarray:
    """Convert Phred+33 quality bytes to per-base error probabilities.

    Mirrors GapFiller::qualityFilter (Figbird.cpp:1780-1797):
    ``Q = ascii - 33; p = 10**(-Q/10)``.
    """
    if isinstance(qual, str):
        qual = qual.encode("ascii")
    if isinstance(qual, (bytes, bytearray)):
        qual = np.frombuffer(qual, dtype=np.uint8)
    q = qual.astype(np.float32) - 33.0
    return np.power(10.0, -q / 10.0).astype(np.float32)
