"""SAM import/export (``figbird_tpu/io/sam.py``).

The reference consumes bowtie2 SAM (Preprocess.cpp:2447-2593 streaming) and
re-emits the model-learning subset as ``myout.sam`` (writeSam2,
Preprocess.cpp:412-416).  This module provides the same interop surface for
the port:

* :func:`read_sam_pairs` — parse a name-paired SAM (the bowtie2 ``-1/-2``
  output layout) into ``(ReadBatch, ReadBatch, align_dict, align_dict)``
  matching :meth:`..align.Aligner.align`'s output contract, so every
  post-alignment stage (pairing, model learning, triage, fill) can run from an
  externally produced SAM — the identity-test injection gate (SURVEY §4) and
  the migration path for users with existing bowtie2 workflows.
* :func:`write_sam` — emit our aligner's results as SAM records with
  flags/POS/CIGAR/TLEN plus the AS/XS/NM/MD/IH tags the reference reads
  (Figbird.cpp:904 ``IH:i:1`` uniqueness, processErrorTypes CIGAR+MD walk).

Alignments here are gapless-with-soft-clips (the device aligner's model); the
*reader* still handles arbitrary bowtie2 CIGARs (M/I/D/S/=/X) and MD tags so
injected SAM loses no information the downstream stages consume.

Copy of the reference's module.  The one change: :func:`write_sam`
reverse-complements the reads with :func:`..align.core.revcomp_batch` on CPU
tensors, the same per-length reversal as the reference's device function;
SAM writing is host I/O, so the reads never go to the card for it.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import TYPE_CHECKING

import numpy as np

from ..dtypes import GAP_CODE, _CHAR_TO_CODE, decode
from .fastq import ReadBatch

if TYPE_CHECKING:  # avoid io <-> align circular import at runtime
    from ..align.index import KmerIndex

_CIGAR_RE = re.compile(rb"(\d+)([MIDNSHP=X])")
_MD_RE = re.compile(rb"(\d+)|(\^[A-Za-z]+)|([A-Za-z])")


def _parse_cigar(cig: bytes):
    """Returns (clip_start, clip_end, read_alen, ops) — read_alen = M+I+=/X."""
    ops = _CIGAR_RE.findall(cig)
    cs = ce = alen = 0
    n = len(ops)
    for i, (ln, op) in enumerate(ops):
        ln = int(ln)
        if op in b"S":
            if i == 0 or (i == 1 and ops[0][1] == b"H"):
                cs = ln
            elif i >= n - 2:
                ce = ln
        elif op in (b"M", b"I", b"=", b"X"):
            alen += ln
    return cs, ce, alen, ops


def _mism_from_md(md: bytes, ops, clip_start: int, L: int) -> tuple[np.ndarray, int]:
    """MD+CIGAR walk -> per-read-position mismatch mask (SAM orientation).

    Mirrors the reference's processErrorTypes parse (Figbird.cpp:291-487):
    MD runs over aligned reference bases (M/=/X consume read+ref, D consumes
    ref only, I consumes read only and is *invisible* to MD).
    """
    mask = np.zeros(L, bool)
    # read offsets of each aligned (M) base, in order, accounting for I/D
    read_pos: list[int] = []
    rp = clip_start
    for ln, op in ops:
        ln = int(ln)
        if op in (b"M", b"=", b"X"):
            read_pos.extend(range(rp, rp + ln))
            rp += ln
        elif op == b"I":
            rp += ln
        # D/N consume reference only; S/H handled via clip_start
    n_mis = 0
    ai = 0  # index into read_pos (aligned-base counter)
    for m in _MD_RE.finditer(md):
        if m.group(1) is not None:
            ai += int(m.group(1))
        elif m.group(2) is not None:
            pass  # deletion: reference-only, no read position
        else:
            if ai < len(read_pos) and read_pos[ai] < L:
                mask[read_pos[ai]] = True
                n_mis += 1
            ai += 1
    return mask, n_mis


def _tags(fields: list[bytes]) -> dict[bytes, bytes]:
    out = {}
    for f in fields:
        if len(f) > 5 and f[2:3] == b":":
            out[f[:2]] = f[5:]
    return out


def read_sam_pairs(path: str | Path, index: "KmerIndex",
                   contig_names: list[str],
                   default_score: int = 0,
                   ) -> tuple[ReadBatch, ReadBatch, dict, dict]:
    """Parse a name-paired SAM into ReadBatches + align dicts.

    Records must come mate1/mate2-interleaved per template (bowtie2's paired
    output order); secondary/supplementary records (flag 0x100/0x800) are
    skipped, like the reference's streaming pairer (Preprocess.cpp:2447-2476).
    Returned ``seq``/``qual`` are in original read orientation (SAM stores the
    reference orientation; reverse-strand records are RC'd back).
    """
    name_to_ci = {n.split()[0].encode(): i for i, n in enumerate(contig_names)}
    recs: list[list] = [[], []]  # per mate: (flag, ci, pos0, cig, md, seq, qual, tags)
    with open(path, "rb") as fh:
        for line in fh:
            if line.startswith(b"@"):
                continue
            f = line.rstrip(b"\n").split(b"\t")
            if len(f) < 11:
                continue
            flag = int(f[1])
            if flag & 0x900:
                continue
            mate = 1 if (flag & 0x80) else 0
            recs[mate].append(f)
    n = min(len(recs[0]), len(recs[1]))

    def build(rows, n):
        L = max((len(r[9]) for r in rows[:n] if r[9] != b"*"), default=0)
        seq = np.full((n, L), GAP_CODE, np.int8)
        qual = np.zeros((n, L), np.uint8)
        lens = np.zeros(n, np.int32)
        a = dict(
            pos=np.zeros(n, np.int64), strand=np.zeros(n, np.int8),
            aligned=np.zeros(n, bool), unique=np.zeros(n, bool),
            clip_start=np.zeros(n, np.int32), clip_end=np.zeros(n, np.int32),
            score=np.full(n, default_score, np.int32),
            second=np.full(n, -(2**30), np.int32),
            n_mis=np.zeros(n, np.int32), alen=np.zeros(n, np.int32),
            start=np.zeros(n, np.int32), end=np.zeros(n, np.int32),
            mism=np.zeros((n, L), bool),
        )
        for i, f in enumerate(rows[:n]):
            flag = int(f[1])
            s = f[9]
            if s != b"*":
                sl = len(s)
                lens[i] = sl
                codes = _CHAR_TO_CODE[np.frombuffer(s, np.uint8)]
                q = np.frombuffer(f[10], np.uint8) if f[10] != b"*" else \
                    np.full(sl, ord("I"), np.uint8)
                strand = 1 if (flag & 0x10) else 0
                if strand:
                    # store original read orientation
                    from ..dtypes import revcomp
                    seq[i, :sl] = revcomp(codes)
                    qual[i, :sl] = q[::-1]
                else:
                    seq[i, :sl] = codes
                    qual[i, :sl] = q[: seq.shape[1]]
                a["strand"][i] = strand
            if flag & 0x4 or f[2] == b"*":
                continue
            ci = name_to_ci.get(f[2].split()[0], -1)
            if ci < 0:
                continue
            pos0 = int(f[3]) - 1
            cs, ce, alen, ops = _parse_cigar(f[5])
            tg = _tags(f[11:])
            a["aligned"][i] = True
            a["clip_start"][i], a["clip_end"][i] = cs, ce
            a["alen"][i] = alen
            a["start"][i] = cs
            a["end"][i] = cs + alen - 1
            # window start: read char 0 in padded-flat coords
            a["pos"][i] = int(index.contig_to_flat(ci, pos0)) - cs
            if b"AS" in tg:
                a["score"][i] = int(tg[b"AS"])
            else:
                a["score"][i] = 2 * alen
            if b"XS" in tg:
                a["second"][i] = int(tg[b"XS"])
            if b"IH" in tg:
                a["unique"][i] = int(tg[b"IH"]) == 1
            elif b"NH" in tg:
                a["unique"][i] = int(tg[b"NH"]) == 1
            else:
                a["unique"][i] = a["score"][i] > a["second"][i]
            md = tg.get(b"MD")
            if md is not None:
                mask, nm = _mism_from_md(md, ops, cs, seq.shape[1])
                a["mism"][i] = mask
                a["n_mis"][i] = nm
            elif b"NM" in tg:
                a["n_mis"][i] = int(tg[b"NM"])
        return ReadBatch(seq, lens, qual), a

    r1, a1 = build(recs[0], n)
    r2, a2 = build(recs[1], n)
    # equalise mism width for downstream stacking
    return r1, r2, a1, a2


def _md_tag(read_o: np.ndarray, ref_win: np.ndarray, cs: int, alen: int) -> str:
    """MD string for a gapless alignment (run-length matches + ref bases)."""
    out = []
    run = 0
    for j in range(alen):
        r, g = read_o[cs + j], ref_win[cs + j]
        if r == g:
            run += 1
        else:
            out.append(str(run))
            out.append(decode(np.array([g], np.int8)))
            run = 0
    out.append(str(run))
    return "".join(out)


def write_sam(path: str | Path, index: "KmerIndex", contig_names: list[str],
              reads1: ReadBatch, reads2: ReadBatch,
              a1: dict, a2: dict, pt=None, name_prefix: str = "p",
              model_only: bool = False) -> int:
    """Emit paired alignments as SAM.  Returns the record count written.

    With ``model_only=True`` and a ``PairTable``, writes only the unique
    concordant model pairs — the ``myout.sam`` equivalent
    (Preprocess.cpp printVectors 641-855).
    """
    import torch

    from ..align.core import revcomp_batch

    n = len(reads1)
    sel = np.arange(n)
    if model_only and pt is not None:
        sel = np.flatnonzero(np.asarray(pt.model))
    flat = index.flat
    lines = [f"@SQ\tSN:{nm}\tLN:{ln}"
             for nm, ln in zip(contig_names, index.contig_lengths)]

    o1 = revcomp_batch(torch.as_tensor(reads1.seq),
                       torch.as_tensor(reads1.length)).numpy()
    o2 = revcomp_batch(torch.as_tensor(reads2.seq),
                       torch.as_tensor(reads2.length)).numpy()

    def emit(i, m, a, rb, rc_seq, a_mate):
        L = int(rb.length[i])
        aligned = bool(a["aligned"][i])
        m_aligned = bool(a_mate["aligned"][i])
        # bowtie2 convention: unmapped records carry the RAW read, never the
        # reverse strand bit (the aligner's best-strand guess is meaningless)
        # — Preprocess/Figbird re-orient unmapped mates from the ANCHOR's
        # strand (Figbird.cpp:5727-5736), so emitting RC here would double-RC
        strand = int(a["strand"][i]) if aligned else 0
        flag = 0x1 | (0x40 if m == 0 else 0x80)
        if not aligned:
            flag |= 0x4
        if not m_aligned:
            flag |= 0x8
        if strand:
            flag |= 0x10
        if m_aligned and int(a_mate["strand"][i]):
            flag |= 0x20
        if pt is not None and bool(np.asarray(pt.concordant)[i]):
            flag |= 0x2
        seq_o = rc_seq[i, :L] if strand else rb.seq[i, :L]
        qv = rb.qual[i, :L] if rb.qual is not None else None
        if strand and qv is not None:
            qv = qv[::-1]
        qs = qv.tobytes().decode("latin1") if qv is not None else "*"
        if not aligned:
            lines.append(f"{name_prefix}{i}\t{flag}\t*\t0\t0\t*\t*\t0\t0\t"
                         f"{decode(seq_o)}\t{qs}")
            return
        cs, ce = int(a["clip_start"][i]), int(a["clip_end"][i])
        alen = L - cs - ce
        win = int(a["pos"][i])
        ci, local = index.flat_to_contig(np.array([win + cs]))
        ci, pos0 = int(ci[0]), int(local[0])
        cig = (f"{cs}S" if cs else "") + f"{alen}M" + (f"{ce}S" if ce else "")
        ref_win = flat[win : win + L]
        md = _md_tag(seq_o, ref_win, cs, alen)
        nm = int((seq_o[cs : cs + alen] != ref_win[cs : cs + alen]).sum())
        tlen = 0
        rnext = "*"
        pnext = 0
        if m_aligned and pt is not None:
            mc = int(np.asarray(pt.contig)[i, 1 - m])
            rnext = "=" if mc == ci else contig_names[mc]
            pnext = int(np.asarray(pt.pos)[i, 1 - m])
            ins = int(np.asarray(pt.insert)[i])
            if ins and mc == ci:
                tlen = ins if pos0 + 1 <= pnext else -ins
        unique = bool(a["unique"][i])
        xs = "" if unique else f"\tXS:i:{int(a['second'][i])}"
        lines.append(
            f"{name_prefix}{i}\t{flag}\t{contig_names[ci]}\t{pos0 + 1}\t"
            f"{42 if unique else 1}\t{cig}\t{rnext}\t{pnext}\t{tlen}\t"
            f"{decode(seq_o)}\t{qs}\tAS:i:{int(a['score'][i])}{xs}"
            f"\tNM:i:{nm}\tMD:Z:{md}\tIH:i:{1 if unique else 2}")

    for i in sel:
        emit(int(i), 0, a1, reads1, o1, a2)
        emit(int(i), 1, a2, reads2, o2, a1)
    Path(path).write_text("\n".join(lines) + "\n")
    return 2 * len(sel)
