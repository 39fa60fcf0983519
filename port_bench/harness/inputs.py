"""A cell's inputs from its configuration and the seed, as one package's
objects (the port's or the reference's: both have ``genome.Genome``,
``io.fastq.ReadBatch`` and ``config``), and on disk for the whole run.

A configuration holds one library (``simulation`` and ``library``) and may
add further ones (``further_libraries``: each a ``simulation`` block of the
reads' keys and a ``library`` block of ``ReadLibrary``'s keys), in the
order the port is given them."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from port_bench.traffic import sim as simmod

_CODE_TO_CHAR = np.frombuffer(b"ACGTN", dtype=np.uint8)


def simulate(config: dict, seed: int) -> simmod.SimArrays:
    return simmod.simulate(simmod.sim_config(config, seed),
                           simmod.further_libraries(config))


def library_blocks(config: dict) -> list:
    """Every library's ``library`` block, library 0 first."""
    return [config["library"]] + [lib["library"] for lib in
                                  config.get("further_libraries", [])]


def objects(pkg, sim: simmod.SimArrays) -> tuple:
    """(draft genome, [(mates 1, mates 2) of each library]) as ``pkg``'s
    objects, each side with arrays of its own."""
    genome = pkg.genome.Genome(list(sim.names), [c.copy() for c in sim.draft])
    rb = pkg.io.fastq.ReadBatch
    return genome, [(rb(r.seq1.copy(), r.length.copy(), r.qual.copy()),
                     rb(r.seq2.copy(), r.length.copy(), r.qual.copy()))
                    for r in sim.libraries()]


def figbird_config(pkg, config: dict):
    """The configuration's libraries and parameters as ``pkg``'s
    ``FigbirdConfig`` (no files)."""
    c = pkg.config
    libs = [c.ReadLibrary("", "", **lib) for lib in library_blocks(config)]
    return c.FigbirdConfig(
        draft_genome="", output_folder="", read_pairs=libs,
        parameters=c.Parameters(**config["parameters"]))


def decode(codes: np.ndarray) -> bytes:
    return _CODE_TO_CHAR[np.clip(codes, 0, 4)].tobytes()


def write_fasta(path: Path, names, seqs, width: int = 60) -> None:
    with open(path, "wb") as fh:
        for name, s in zip(names, seqs):
            fh.write(b">" + name.encode() + b"\n")
            raw = decode(s)
            fh.write(b"\n".join(raw[i : i + width]
                                for i in range(0, len(raw), width)) + b"\n")


def read_fasta(path: Path) -> tuple[list, list]:
    """(names, sequences as bytes)."""
    names, seqs, cur = [], [], []
    for line in Path(path).read_bytes().split(b"\n"):
        if line.startswith(b">"):
            if names:
                seqs.append(b"".join(cur))
            names.append(line[1:].split()[0].decode())
            cur = []
        elif line:
            cur.append(line.strip())
    if names:
        seqs.append(b"".join(cur))
    return names, seqs


def write_fastq(path: Path, seq: np.ndarray, length: np.ndarray,
                qual: np.ndarray, mate: int) -> None:
    """Four-line records ``@r<i>/<mate>``, every read at its own length."""
    chars = _CODE_TO_CHAR[np.clip(seq, 0, 4)]
    with open(path, "wb") as fh:
        step = 65536
        for a in range(0, len(seq), step):
            parts = []
            for i in range(a, min(a + step, len(seq))):
                n = int(length[i])
                parts.append(b"@r%d/%d\n%s\n+\n%s\n" % (
                    i, mate, chars[i, :n].tobytes(), qual[i, :n].tobytes()))
            fh.write(b"".join(parts))


def write_run_inputs(sim: simmod.SimArrays, config: dict, where: Path) -> dict:
    """The draft and each library's FASTQ pair under ``where`` (library 0's
    ``r1.fq`` and ``r2.fq``, library k's ``lib<k>_r1.fq`` and
    ``lib<k>_r2.fq``); returns the ``Config.json`` content less its
    ``Output_Folder``."""
    where.mkdir(parents=True, exist_ok=True)
    write_fasta(where / "draft.fa", sim.names, sim.draft)
    pairs = []
    for k, (reads, block) in enumerate(zip(sim.libraries(),
                                           library_blocks(config))):
        stem = "" if k == 0 else f"lib{k}_"
        paths = [where / f"{stem}r{mate}.fq" for mate in (1, 2)]
        write_fastq(paths[0], reads.seq1, reads.length, reads.qual, 1)
        write_fastq(paths[1], reads.seq2, reads.length, reads.qual, 2)
        pairs.append(dict(block, path_1=str(paths[0]),
                          path_2=str(paths[1])))
    return {"Directory": {"Draft_Genome": str(where / "draft.fa")},
            "Read_Pairs": pairs, "Parameters": dict(config["parameters"])}


def write_run_config(base: dict, path: Path, output_folder: Path) -> Path:
    cfg = json.loads(json.dumps(base))
    cfg["Directory"]["Output_Folder"] = str(output_folder)
    path.write_text(json.dumps(cfg))
    return path
