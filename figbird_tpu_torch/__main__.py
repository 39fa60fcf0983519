"""Command-line entry point: ``python -m figbird_tpu_torch Config.json``.

The port of ``python -m figbird_tpu`` (``figbird_tpu/__main__.py``), which
replaces ``./RunFigbird.sh Config.json`` (RunFigbird.sh:1-831): config
parse/validation, output tree setup, the full iteration schedule, final gap
combination + filled-assembly emission, and optional evaluation.  It writes
the same files, in the same formats.  It runs on the card unless
``--device cpu`` asks for the CPU; without a card it raises.
``--mesh-devices N [--genome-shards G]`` runs over a mesh of N visible
cards (with ``--device cpu``, N repeated CPU devices); the FIGBIRD_COORD,
FIGBIRD_NPROCS and FIGBIRD_PROC variables run it as one of several
processes (``parallel.distributed``).
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path


def main(argv=None) -> int:
    # multi-process: the gloo process group from the FIGBIRD_* variables
    from .parallel.distributed import init_from_env

    init_from_env()
    ap = argparse.ArgumentParser(
        prog="figbird_tpu_torch",
        description="Iterative gap filling (Figbird-equivalent) on one GPU")
    ap.add_argument("config", help="Config.json (reference schema)")
    ap.add_argument("--max-iterations", type=int, default=None)
    ap.add_argument("--resume", action="store_true",
                    help="resume from the newest persisted assembly in the "
                         "output folder")
    ap.add_argument("--trace-dir", default=None,
                    help="write a torch.profiler trace of the run here")
    ap.add_argument("--mesh-devices", type=int, default=0,
                    help="build an N-device mesh of --device's type and run "
                         "the aligner/fill data-parallel over it (0 = off)")
    ap.add_argument("--genome-shards", type=int, default=1,
                    help="genome-axis size of the mesh; >1 shards the "
                         "genome/k-mer index across devices (policy from "
                         "Parameters.genome_shard: auto|contig|code)")
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the GPU; 'cpu' "
                         "runs the kernels' plain versions)")
    args = ap.parse_args(argv)

    from .combine import combine_gap_history, write_individual_gaps
    from .config import FigbirdConfig
    from .dtypes import decode
    from .evalx import assembly_stats, evaluate_against_reference
    from .genome import Genome
    from .io.fasta import read_fasta, write_fasta
    from .io.fastq import read_fastq
    from .ops import entry_device
    from .pipeline import Pipeline
    from .utils import latest_iteration, trace_context

    t_start = time.time()
    device = entry_device(args.device)
    cfg = FigbirdConfig.from_json(args.config)
    mesh = None
    aligner_kwargs = {}
    if args.mesh_devices:
        from .parallel import make_mesh

        # on the CPU, N devices are one device repeated (its stand-in for
        # several); on the card, N of the visible cards (more raise)
        mesh = make_mesh(args.mesh_devices,
                         genome_shards=max(args.genome_shards, 1),
                         devices=([device] * args.mesh_devices
                                  if device.type == "cpu" else None))
        if args.genome_shards > 1:
            aligner_kwargs["genome_shard"] = cfg.parameters.genome_shard
    workdir = Path(cfg.output_folder) / "Figbird"
    workdir.mkdir(parents=True, exist_ok=True)

    draft_path = cfg.draft_genome
    if args.resume:
        it0, path = latest_iteration(workdir)
        if path is not None:
            print(f"# resuming from iteration {it0}: {path}", file=sys.stderr)
            draft_path = str(path)

    genome = Genome.from_fasta(read_fasta(draft_path))
    libs = [(read_fastq(l.path_1), read_fastq(l.path_2))
            for l in cfg.read_pairs]
    n_reads = sum(2 * len(a) for a, _ in libs)
    print(f"# draft: {genome.n_contigs} contigs, {genome.total_length()} bp, "
          f"{genome.count_n()} Ns in {len(genome.find_gaps())} gaps; "
          f"{n_reads} reads in {len(libs)} libraries", file=sys.stderr)

    if mesh is not None:
        print(f"# mesh: {mesh.shape} genome_shard="
              f"{cfg.parameters.genome_shard}", file=sys.stderr)

    pipe = Pipeline(cfg, genome, libs, workdir=workdir, device=device,
                    mesh=mesh, aligner_kwargs=aligner_kwargs)
    with trace_context(args.trace_dir):
        result = pipe.run(max_iterations=args.max_iterations)

    for st in result.iterations:
        print(f"# itr {st.itr} [{st.mode} lib{st.lib}]: {st.gaps} gaps, "
              f"{st.filled} filled, N {st.n_before}->{st.n_after} "
              f"({st.seconds:.1f}s)", file=sys.stderr)

    final = workdir / "FilledScaffolds_final.fa"
    write_fasta(final, result.genome.to_fasta())
    combined = combine_gap_history(result.gap_history)
    with open(workdir / "combined_gapstring.txt", "w") as fh:
        for cg in combined:
            fh.write(decode(cg.seq) + "\n")
    write_individual_gaps(workdir / "Individual_gaps.txt", combined)

    st = assembly_stats(result.genome)
    print(f"# final: N50={st.n50} gaps={st.n_gaps} "
          f"gap_bases={st.total_gap_length}", file=sys.stderr)
    print(f"# wrote {final}", file=sys.stderr)

    if cfg.parameters.evaluation and cfg.reference_genome:
        ref = Genome.from_fasta(read_fasta(cfg.reference_genome))
        rep = evaluate_against_reference(result.genome, ref)
        with open(workdir / "Result.txt", "w") as fh:
            fh.write(rep.as_table())
        print(rep.as_table(), file=sys.stderr)

    print(f"# total wall-clock {time.time()-t_start:.1f}s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
