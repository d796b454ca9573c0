"""End-to-end demo on synthetic data, on the PyTorch port
(``hic_genome_assembler_tpu_torch``).

The port's twin of ``examples/run_fixture_pipeline.py``: it generates a
synthetic genome with planted chromosome/order/orientation truth, emits
all HiC-Pro input files, writes a config, runs all four pipeline parts
through the port's CLI, on the card unless ``--device cpu`` asks for the
host, and checks the recovered chromosome groups against the planted
truth.  It imports neither jax nor the JAX package.

Usage: python examples/run_fixture_pipeline_torch.py [workdir] [--device cuda|cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from hic_genome_assembler_tpu_torch import cli  # noqa: E402
from hic_genome_assembler_tpu_torch.io import fasta, filebus  # noqa: E402
from hic_genome_assembler_tpu_torch.utils import fixtures  # noqa: E402


def main(workdir: str = "/tmp/hic_demo_torch", device: str = "cuda") -> None:
    files_dir = os.path.join(workdir, "files")
    plots_dir = os.path.join(workdir, "plots")
    os.makedirs(files_dir, exist_ok=True)
    os.makedirs(plots_dir, exist_ok=True)

    genome = fixtures.make_genome(
        chrom_scaffold_bins=((14, 12, 10, 8, 6), (12, 11, 9, 8), (10, 9, 8, 6)),
        seed=13,
        noise=0.005,
        cross_noise_frac=0.001,
    )
    paths = fixtures.write_hicpro_files(genome, os.path.join(workdir, "hicpro"))

    config_path = os.path.join(workdir, "config.txt")
    with open(config_path, "w") as cfg:
        cfg.write(
            "\n".join(
                [
                    f"resolution = {genome.resolution}",
                    f"saveFilesDirectory = {files_dir}",
                    f"savePlotsDirectory = {plots_dir}",
                    f"hicProBedFile = {paths['bed']}",
                    f"hicProBiasFile = {paths['bias']}",
                    f"hicProMatrixFile = {paths['matrix']}",
                    f"hicProScaffSizeFile = {paths['sizes']}",
                    "chromosomeGroupFile = chromgroups.txt",
                    "chromosomeOrderFile = chromorder.txt",
                    "finalOrderingsFile = final_order.txt",
                    "dendrogramOrderFile = dendro.txt",
                    "avgClusterPlot = avg_cluster.png",
                    "avgClusterPlot_outlined = avg_cluster_outlined.png",
                    "binGroupFile = bingroups.txt",
                    "assessmentFile = assessment.txt",
                    "chromosomePlotSuffix =  (fixture)",
                    "fullGenomePlot = full_genome.png",
                    "fullGenomePlotTitle = synthetic genome",
                    "plotOrderFile = plotorder.txt",
                    "nScaffolds = 4",
                    "scanScaffolds = 3",
                    "modularity = 0",
                    "lengthCutoff = 500000",
                    f"restrictionSiteFile = {paths['restriction']}",
                    f"validPairFile = {paths['validpairs']}",
                    f"originalFastaFile = {paths['fasta']}",
                    "assembledFastaFile = assembled.fasta",
                ]
            )
            + "\n"
        )

    cli.main(["-part1", "-part2", "-part3", "-part4", "-config", config_path,
              "-device", device])

    # --- check against planted truth ---------------------------------------
    groups = filebus.read_chroms_from_file(os.path.join(files_dir, "chromgroups.txt"))
    got = sorted(sorted({name for _b, name in grp}) for grp in groups)
    want = sorted(sorted(v) for v in genome.true_groups().values())
    print("\n== truth check ==")
    print("device:", device)
    print("chromosome groups match planted truth:", got == want)
    assembled = fasta.read_fasta(os.path.join(files_dir, "assembled.fasta"))
    print("assembled entries:", sorted(assembled))
    if got != want:
        raise SystemExit("fixture pipeline failed the truth check")


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("workdir", nargs="?", default="/tmp/hic_demo_torch")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="torch device of parts 1 and 2 (default: cuda)")
    args = parser.parse_args()
    main(args.workdir, args.device)
