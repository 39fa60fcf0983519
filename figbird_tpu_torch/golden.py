"""Reference-parity golden harness (``figbird_tpu/golden.py``).

Compiles the reference pipeline's post-alignment stages (Preprocess.cpp,
FillGaps.cpp + its per-thread Figbird.cpp recompile, CombineGaps.cpp —
RunFigbird.sh:285,352,777) from a reference checkout and runs them on an
*injected SAM*, so the deterministic post-alignment stages can be compared
against this package bit-for-bit (SURVEY §4: given a SAM the reference has
no RNG; ties break by scan order).

Two uses:

* **golden tests** — run both pipelines from the same SAM on a tiny synthetic
  genome and diff ``gapInfo.txt`` / ``gapout.txt`` / the filled FASTA
  (tests/test_torch_golden.py);
* **measured baseline** — time the reference stages on a host (bowtie2
  itself is a missing blob in the reference repo, so alignment time is
  estimated separately).

The reference sources are read from ``FIGBIRD_REF`` (default ``~/reference``)
at *runtime only* — nothing is copied into this repository.  Binaries are
cached in the work directory across calls.  The harness is plain Python
(``subprocess`` and ``g++``); copy of the reference's module, with the
default directory taken relative to the user's home.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import time
from pathlib import Path

REF_DIR = Path(os.environ.get("FIGBIRD_REF",
                          Path.home() / "reference"))

_SOURCES = ("Preprocess.cpp", "FillGaps.cpp", "Figbird.cpp", "CombineGaps.cpp")


def reference_available() -> bool:
    return (REF_DIR.is_dir()
            and all((REF_DIR / s).exists() for s in _SOURCES)
            and shutil.which("g++") is not None)


class ReferenceHarness:
    """Builds and drives the reference post-alignment stages in a scratch dir.

    Layout mirrors RunFigbird.sh's output tree: ``work/Gaps/`` for per-gap
    SAMs, ``work/Temp/`` for gapInfo/gapout/filledContigs/Ncount.
    """

    def __init__(self, work: str | Path, ref_dir: Path = REF_DIR,
                 optimize: bool = True):
        self.work = Path(work)
        self.ref = Path(ref_dir)
        self.optimize = optimize
        self.gaps_dir = self.work / "Gaps"
        self.temp_dir = self.work / "Temp"
        self.timings: dict[str, float] = {}
        self._built = False

    # ------------------------------------------------------------------
    def build(self) -> None:
        """Copy sources and compile Preprocess/FillGaps/CombineGaps.

        Figbird.cpp is left as source: FillGaps recompiles it per thread at
        run time (FillGaps.cpp:64-66), exactly like the real pipeline.  When
        ``optimize`` the copied FillGaps is patched to compile Figbird with
        -O2 — a *stronger* baseline than the reference's plain ``g++``.
        """
        self.work.mkdir(parents=True, exist_ok=True)
        self.gaps_dir.mkdir(exist_ok=True)
        self.temp_dir.mkdir(exist_ok=True)
        for s in _SOURCES:
            shutil.copy(self.ref / s, self.work / s)
        opt = ["-O2"] if self.optimize else []
        if self.optimize:
            src = (self.work / "FillGaps.cpp").read_text()
            src = src.replace('"g++ Figbird.cpp -o "', '"g++ -O2 Figbird.cpp -o "')
            (self.work / "FillGaps.cpp").write_text(src)
        t0 = time.time()
        for src, out, extra in (
            ("Preprocess.cpp", "preprocess.out", []),
            ("FillGaps.cpp", "fillgaps.out", ["-std=c++11", "-pthread"]),
            ("CombineGaps.cpp", "combinegaps.out", []),
        ):
            subprocess.run(["g++", *opt, *extra, src, "-o", out],
                           cwd=self.work, check=True, capture_output=True)
        self.timings["compile"] = time.time() - t0
        self._built = True

    # ------------------------------------------------------------------
    def run_preprocess(self, genome_fa: str | Path, sam: str | Path,
                       max_distance: int, samflag: int = 1,
                       gapped_genome_fa: str | Path | None = None,
                       default: int = 1, genome_red: int = 0,
                       read_red: int = 0, r1: str = "r1.fastq",
                       r2: str = "r2.fastq") -> float:
        """Preprocess a.out <13 args> (RunFigbird.sh:285).  Returns seconds."""
        if not self._built:
            self.build()
        myout = self.work / "myout.sam"
        args = [
            "./preprocess.out", str(genome_fa), str(max_distance),
            str(samflag), str(sam), str(myout),
            str(gapped_genome_fa or genome_fa), r1, r2,
            f"{self.gaps_dir}/", f"{self.temp_dir}/",
            str(default), str(genome_red), str(read_red),
        ]
        t0 = time.time()
        subprocess.run(args, cwd=self.work, check=True, capture_output=True)
        dt = time.time() - t0
        self.timings["preprocess"] = dt
        return dt

    # ------------------------------------------------------------------
    def run_fillgaps(self, genome_fa: str | Path, max_distance: int,
                     max_read_len: int, itr: int, partial_flag: int,
                     unmapped: int, threads: int, neg_overlap: int,
                     partial_readlen: int, insert_mean: int,
                     trim: int = 0, set_inputmean: int = 0,
                     myout: str | Path | None = None) -> float:
        """FillGaps a.out <15 args> (RunFigbird.sh:352).  Returns seconds.

        Includes FillGaps' internal per-thread ``g++ Figbird.cpp`` recompile,
        exactly as the reference pipeline pays it every iteration.
        """
        if not self._built:
            self.build()
        args = [
            "./fillgaps.out", str(genome_fa), str(max_distance),
            str(max_read_len), str(itr), str(partial_flag), str(unmapped),
            str(threads), str(myout or self.work / "myout.sam"),
            f"{self.temp_dir}/", f"{self.gaps_dir}/",
            str(neg_overlap), str(partial_readlen), str(trim),
            str(set_inputmean), str(insert_mean),
        ]
        t0 = time.time()
        subprocess.run(args, cwd=self.work, check=True, capture_output=True)
        dt = time.time() - t0
        self.timings["fillgaps"] = dt
        return dt

    # ------------------------------------------------------------------
    def figbird_compile_seconds(self) -> float:
        """Time one bare Figbird.cpp compile (to report compile-adjusted
        fill throughput; FillGaps pays this once per thread per iteration)."""
        opt = ["-O2"] if self.optimize else []
        t0 = time.time()
        subprocess.run(["g++", *opt, "Figbird.cpp", "-o", "figbird_probe.out"],
                       cwd=self.work, check=True, capture_output=True)
        dt = time.time() - t0
        self.timings["figbird_compile"] = dt
        return dt

    # ------------------------------------------------------------------
    # artifact readers
    def read_gap_info(self) -> list[tuple[int, int, int]]:
        out = []
        for line in (self.temp_dir / "gapInfo.txt").read_text().splitlines():
            p = line.split()
            if len(p) >= 3:
                out.append((int(p[0]), int(p[1]), int(p[2])))
        return out

    def read_gapout(self) -> list[tuple[int, int, int, int, int, str]]:
        """gapout.txt rows: gapNo contigNo gapStart gapLength stringLen seq."""
        out = []
        for line in (self.temp_dir / "gapout.txt").read_text().splitlines():
            p = line.split()
            if len(p) >= 5:
                seq = p[5] if len(p) > 5 else ""
                out.append((int(p[0]), int(p[1]), int(p[2]), int(p[3]),
                            int(p[4]), seq))
        return out

    def read_filled_fasta(self) -> dict[str, str]:
        path = self.temp_dir / "filledContigs.fa"
        seqs: dict[str, list[str]] = {}
        name = None
        for line in path.read_text().splitlines():
            if line.startswith(">"):
                name = line[1:].split()[0]
                seqs[name] = []
            elif name is not None:
                seqs[name].append(line.strip())
        return {k: "".join(v) for k, v in seqs.items()}

    def read_ncount(self) -> int:
        txt = (self.temp_dir / "Ncount.txt").read_text().split()
        return int(txt[0]) if txt else -1
