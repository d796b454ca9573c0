"""CLI entry point: ``python -m hic_genome_assembler_tpu_torch -part1 -part2
-part3 -part4 -config <file> [-device cuda|cpu] [-mesh auto|off|RxC]
[-trace DIR]``.

The same flags and run semantics as ``hic_genome_assembler_tpu.cli``: any
combination of parts runs in order, total wall-clock printed at the end.
Parts 1 and 2 run on the chosen torch device, or on the mesh that
``parallel.runtime.bring_up`` builds; parts 3 and 4 are host-only, the
port's copies of the JAX package's part 3 and part 4 modules.  Under ``torchrun`` (or with
``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT`` set) each
process searches its shard of part 2's chromosomes and process 0 merges
them.  ``-trace DIR`` runs the parts under ``torch.profiler`` and writes
one Chrome trace a process, ``DIR/trace_<pid>.json``: the program's stage
spans (``utils/profiling``'s timers) beside the card's kernels and copies.
"""

from __future__ import annotations

import argparse
import contextlib
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from hic_genome_assembler_tpu_torch.config import (
    ensure_all_variables_are_set,
    read_config_file_to_variables,
)


@dataclass
class RunReport:
    """What one CLI run did: wall seconds per part, where part 1's
    rank-count scans ran (``"host"`` or a torch device) and part 1's final
    cut list."""

    part_seconds: Dict[str, float] = field(default_factory=dict)
    rank_counts_on: Optional[str] = None
    cut_indices: Optional[List[int]] = None


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="hic_genome_assembler_tpu_torch",
        description=(
            "Runs the various parts of the HiC assembly pipeline in PyTorch. "
            "Each Part requires the previous Part(s) to be run beforehand. "
            "Each Part can be run independently or sequentially and any "
            "combination of Part(s)1-4 is allowed."
        ),
    )
    parser.add_argument("-part1", help="Run part1 of the pipeline", action="store_true")
    parser.add_argument("-part2", help="Run part2 of the pipeline", action="store_true")
    parser.add_argument("-part3", help="Run part3 of the pipeline", action="store_true")
    parser.add_argument("-part4", help="Run part4 of the pipeline", action="store_true")
    parser.add_argument(
        "-config",
        help=(
            "Full file path to the config file. All arguments must have a "
            "value in the config file or the program will exit"
        ),
        required=True,
        type=str,
    )
    parser.add_argument(
        "-device",
        help="Torch device for parts 1 and 2 (default: cuda; cuda without a GPU is an error)",
        choices=("cuda", "cpu"),
        default="cuda",
    )
    parser.add_argument(
        "-mesh",
        help=(
            "Device-mesh policy: 'auto' (mesh over all visible devices "
            "when more than one), 'off', or an explicit RxC (data, model) "
            "shape like '4x2'. Defaults to $HIC_MESH, then 'auto'."
        ),
        default=None,
        type=str,
    )
    parser.add_argument(
        "-trace",
        help=(
            "Directory for a torch.profiler Chrome trace of the run "
            "(trace_<pid>.json): the program's stage spans and the card's "
            "kernels and copies. Off by default."
        ),
        default=None,
        type=str,
    )
    return parser


def main(argv=None) -> RunReport:
    args = build_parser().parse_args(argv)
    start = time.time()
    from hic_genome_assembler_tpu_torch.utils import hostmem, profiling
    from hic_genome_assembler_tpu_torch.parallel import distributed, runtime

    hostmem.tune()  # warm-page reuse for the multi-GB host matrices
    var = load_config(args.config)
    parts = [p for p in ("part1", "part2", "part3", "part4") if getattr(args, p)]
    try:
        rt = runtime.bring_up(args.mesh, args.device)
        with profiling.device_trace(args.trace) if args.trace else contextlib.nullcontext():
            report = run_parts(var, parts, rt)
    finally:
        distributed.shutdown()
    print("Total run-time = " + str(time.time() - start) + " seconds")
    return report


def load_config(path: str) -> Dict[str, object]:
    """The variables of a config file, for :func:`run_parts`; exits when
    one is unset."""
    var = read_config_file_to_variables(path)
    if ensure_all_variables_are_set(var):
        sys.exit(1)
    return var


def run_parts(var: Dict[str, object], parts: Sequence[str], rt) -> RunReport:
    """Run ``parts`` (a subset of ``part1``..``part4``, in that order) of a
    read config ``var`` on the runtime context ``rt``
    (``parallel.runtime.RuntimeContext``)."""
    device, mesh = rt.device, rt.mesh
    report = RunReport()

    if "part1" in parts:
        from hic_genome_assembler_tpu_torch.models import part1_cluster as part1

        t0 = time.time()
        report.rank_counts_on, report.cut_indices = part1.run_pipeline(
            var["hicProBedFile"], var["hicProBiasFile"], var["hicProMatrixFile"],
            var["hicProScaffSizeFile"], var["dendrogramOrderFile"],
            var["avgClusterPlot"], var["avgClusterPlot_outlined"],
            var["binGroupFile"], var["assessmentFile"], var["chromosomeGroupFile"],
            var["hyperGeom"], var["hmm"], var["minSize"], var["modularity"],
            var["louvainRounds"], var["psig"], var["convergenceRounds"],
            var["lookAhead"], var["resolution"], device,
            matrix_mode=var["matrixMode"], hmm_mode=var["hmmMode"], mesh=mesh,
        )
        report.part_seconds["part1"] = time.time() - t0
    if "part2" in parts:
        from hic_genome_assembler_tpu_torch.models import part2_order as part2

        t0 = time.time()
        part2.run_pipeline(
            var["hicProBedFile"], var["hicProBiasFile"], var["hicProMatrixFile"],
            var["chromosomeGroupFile"], var["chromosomeOrderFile"],
            var["savePlotsDirectory"], var["chromosomePlotSuffix"],
            var["fullGenomePlot"], var["fullGenomePlotTitle"], var["plotOrderFile"],
            var["nScaffolds"], var["scanScaffolds"], var["resolution"], device,
            mesh=mesh, process_index=rt.process_index, process_count=rt.process_count,
        )
        report.part_seconds["part2"] = time.time() - t0
    if rt.process_count > 1 and not rt.is_primary and {"part3", "part4"} & set(parts):
        # parts 3 and 4 read the merged order file that process 0 writes
        print("- Parts 3 and 4 run on process 0 only")
        return report
    if "part3" in parts:
        from hic_genome_assembler_tpu_torch.models import part3_orient as part3

        t0 = time.time()
        part3.run_pipeline(
            var["chromosomeOrderFile"], var["hicProScaffSizeFile"],
            var["restrictionSiteFile"], var["validPairFile"],
            var["finalOrderingsFile"], var["lengthCutoff"], var["resolution"],
        )
        report.part_seconds["part3"] = time.time() - t0
    if "part4" in parts:
        from hic_genome_assembler_tpu_torch.models import part4_fasta as part4

        t0 = time.time()
        part4.run_pipeline(
            var["originalFastaFile"], var["finalOrderingsFile"],
            var["assembledFastaFile"],
        )
        report.part_seconds["part4"] = time.time() - t0
    return report


if __name__ == "__main__":
    main()
