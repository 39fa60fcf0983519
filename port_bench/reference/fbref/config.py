"""Configuration schema.

Mirrors Config.json (README.md:25-52) parsed by ``jq`` in RunFigbird.sh:37-85,
as Python dataclasses with the same validation rules (RunFigbird.sh:95-111).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path

MAX_ALLOWED_ISZ = 5000  # RunFigbird.sh:24
MAX_ALLOWED_READLEN = 200  # RunFigbird.sh:25
INSERT_FRAC = 1.15  # RunFigbird.sh:26 (maxD2 = isz * 1.15)
FRAG_ISZ_THRESHOLD = 250  # RunFigbird.sh:122 (isz<=250 => frag lib)


@dataclass
class ReadLibrary:
    path_1: str
    path_2: str
    avg_insert_size: int
    is_reverse: int = 0
    max_read_length: int = 101
    serial_num: int = 1
    num_itr_partial: int = 0
    num_itr_unmapped: int = 0
    order: tuple[str, str] = ("p", "u")

    @property
    def is_jump(self) -> bool:
        return self.avg_insert_size > FRAG_ISZ_THRESHOLD

    def validate(self) -> None:
        if not (0 < self.avg_insert_size <= MAX_ALLOWED_ISZ):
            raise ValueError(f"invalid insert size {self.avg_insert_size} (<= {MAX_ALLOWED_ISZ})")
        if not (0 < self.max_read_length <= MAX_ALLOWED_READLEN):
            raise ValueError(f"invalid read length {self.max_read_length} (<= {MAX_ALLOWED_READLEN})")
        if self.order[0] == self.order[1]:
            raise ValueError("order entries must differ (one 'p', one 'u')")


@dataclass
class Parameters:
    numthreads: int = 4
    evaluation: int = 0
    default: int = 1
    gaplen_negative_overlap: int = 30
    trim_len: int = 10
    set_inputmean: int = 0
    # extension (no reference analogue): genome sharding policy
    # for the aligner when the device mesh has a genome axis.  "auto" =
    # contig-range shards once the flat genome exceeds int32/HBM budgets
    # (BASELINE config 5), "contig" = force, "code" = code-range table
    # shards over a replicated genome.
    genome_shard: str = "auto"

    def validate(self) -> None:
        if not (1 <= self.numthreads <= 64):  # RunFigbird.sh:51-54
            self.numthreads = 4


@dataclass
class FigbirdConfig:
    draft_genome: str
    output_folder: str
    read_pairs: list[ReadLibrary]
    parameters: Parameters = field(default_factory=Parameters)
    reference_genome: str | None = None

    def validate(self) -> None:
        if not self.read_pairs:
            raise ValueError("at least one read library required")
        for lib in self.read_pairs:
            lib.validate()
        self.parameters.validate()

    @property
    def min_isz_index(self) -> int:
        """Index of the minimum-insert library (RunFigbird.sh:128-131) —
        used for the model/partial alignment pass."""
        return min(range(len(self.read_pairs)),
                   key=lambda i: self.read_pairs[i].avg_insert_size)

    @classmethod
    def from_json(cls, path: str | Path) -> "FigbirdConfig":
        data = json.loads(Path(path).read_text())
        d = data.get("Directory", {})
        libs = [
            ReadLibrary(
                path_1=rp["path_1"],
                path_2=rp["path_2"],
                avg_insert_size=int(rp["avg_insert_size"]),
                is_reverse=int(rp.get("is_reverse", 0)),
                max_read_length=int(rp.get("max_read_length", 101)),
                serial_num=int(rp.get("serial_num", i + 1)),
                num_itr_partial=int(rp.get("num_itr_partial", 0)),
                num_itr_unmapped=int(rp.get("num_itr_unmapped", 0)),
                order=tuple(rp.get("order", ["p", "u"])),
            )
            for i, rp in enumerate(data.get("Read_Pairs", []))
        ]
        p = data.get("Parameters", {})
        params = Parameters(
            numthreads=int(p.get("numthreads", 4)),
            evaluation=int(p.get("evaluation", 0)),
            default=int(p.get("default", 1)),
            gaplen_negative_overlap=int(p.get("gaplen_negative_overlap", 30)),
            trim_len=int(p.get("trim_len", 10)),
            set_inputmean=int(p.get("set_inputmean", 0)),
            genome_shard=str(p.get("genome_shard", "auto")),
        )
        cfg = cls(
            draft_genome=d.get("Draft_Genome", ""),
            output_folder=d.get("Output_Folder", "."),
            read_pairs=libs,
            parameters=params,
            reference_genome=d.get("Reference_Genome"),
        )
        cfg.validate()
        return cfg
