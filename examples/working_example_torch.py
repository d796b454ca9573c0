"""One-command walkthrough of the committed working-example config, on the
PyTorch port (``hic_genome_assembler_tpu_torch``).

The port's twin of ``examples/working_example.py``: it generates the
synthetic fixture inputs at the paths that
``configs/hicAssembler_config_fixtureExample_torch.txt`` names, runs all
four pipeline parts through the port's CLI with that config, on the card
unless ``--device cpu`` asks for the host, and checks the result against
the planted truth.  It imports neither jax nor the JAX package.

Usage: python examples/working_example_torch.py [--device cuda|cpu] [--config FILE]

``--config`` takes another copy of the committed config whose directories
point elsewhere (the fixture is written where its ``hicPro*`` keys say).
"""

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from hic_genome_assembler_tpu_torch import cli  # noqa: E402
from hic_genome_assembler_tpu_torch.config import read_config_file_to_variables  # noqa: E402
from hic_genome_assembler_tpu_torch.io import fasta, filebus  # noqa: E402
from hic_genome_assembler_tpu_torch.utils import fixtures  # noqa: E402

CONFIG = os.path.join(REPO, "configs", "hicAssembler_config_fixtureExample_torch.txt")

# Must match the config's resolution = 10000 and the file names in its
# hicPro*/restriction/validPair/originalFasta keys.
GENOME_SPEC = dict(
    chrom_scaffold_bins=((14, 12, 10, 8, 6), (12, 11, 9, 8), (10, 9, 8, 6)),
    seed=13,
    noise=0.005,
    cross_noise_frac=0.001,
)
# the config key of each file write_hicpro_files makes
FIXTURE_KEYS = {"bed": "hicProBedFile", "bias": "hicProBiasFile", "matrix": "hicProMatrixFile",
                "sizes": "hicProScaffSizeFile", "restriction": "restrictionSiteFile",
                "validpairs": "validPairFile", "fasta": "originalFastaFile"}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="torch device of parts 1 and 2 (default: cuda)")
    parser.add_argument("--config", default=CONFIG, help="the working-example config")
    args = parser.parse_args(argv)

    var = read_config_file_to_variables(args.config)
    for key in ("saveFilesDirectory", "savePlotsDirectory"):
        os.makedirs(var[key], exist_ok=True)
    genome = fixtures.make_genome(**GENOME_SPEC)
    paths = fixtures.write_hicpro_files(genome, os.path.dirname(var["hicProBedFile"]))
    wrong = [key for name, key in FIXTURE_KEYS.items() if var[key] != paths[name]]
    if wrong:
        raise SystemExit(f"{args.config} does not name the fixture's files: {wrong}")

    cli.main(["-part1", "-part2", "-part3", "-part4", "-config", args.config,
              "-device", args.device])

    groups = filebus.read_chroms_from_file(var["chromosomeGroupFile"])
    got = sorted(sorted({name for _b, name in grp}) for grp in groups)
    want = sorted(sorted(v) for v in genome.true_groups().values())
    assembled = fasta.read_fasta(var["assembledFastaFile"])
    print("\n== working-example truth check ==")
    print("device:", args.device)
    print("chromosome groups match planted truth:", got == want)
    print("assembled entries:", sorted(assembled))
    if got != want:
        raise SystemExit("working example failed the truth check")


if __name__ == "__main__":
    main()
