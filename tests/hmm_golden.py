"""Write the JAX package's part-1 HMM result on the 3,715-bin genome.

    JAX_PLATFORMS=cpu python tests/hmm_golden.py [output.json]

Runs ``python -m hic_genome_assembler_tpu -part1`` (through ``cli.main``)
with ``jax_enable_x64`` on ``e2e.make_hmm_genome(8192)`` and
``e2e.HMM_SETTINGS``, and writes the cut list, the sha256 of the three
part-1 result files and of the genome's HiC-Pro matrix file to
``hic_genome_assembler_tpu_torch/utils/hmm_golden_3715.json`` (or the path
given).  The port's GPU smoke run holds its own CLI to this file.
"""

import ast
import contextlib
import hashlib
import io
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from hic_genome_assembler_tpu import cli as jax_cli  # noqa: E402
from hic_genome_assembler_tpu.utils import fixtures  # noqa: E402
from hic_genome_assembler_tpu.viz import plot as plot_mod  # noqa: E402
from hic_genome_assembler_tpu_torch.utils import e2e  # noqa: E402

N = 8192
PART1_FILES = ("binGroupings.txt", "clusterAssessment.txt", "chromosomeGroupings.txt")


def sha256(path):
    with open(path, "rb") as handle:
        return hashlib.sha256(handle.read()).hexdigest()


def cut_list(stdout):
    lines = [ln for ln in stdout.splitlines() if ln.startswith("CutIndices = ")]
    return [int(c) for c in ast.literal_eval(lines[-1].split(" = ", 1)[1])]


def main(out_path=e2e.HMM_GOLDEN):
    os.environ["HIC_JAX_CACHE"] = "off"
    plot_mod.plot_contact_map = lambda *a, **k: None  # no PNG is part of the record
    genome = e2e.make_hmm_genome(N)
    with tempfile.TemporaryDirectory(prefix="hmm_golden_") as workdir:
        paths = fixtures.write_hicpro_files(genome, os.path.join(workdir, "hicpro"))
        cfg = e2e.write_config(
            os.path.join(workdir, "c.cfg"), workdir, paths, genome.resolution, e2e.HMM_SETTINGS
        )
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            jax_cli.main(["-part1", "-config", cfg, "-mesh", "off"])
        record = {
            "command": "JAX_PLATFORMS=cpu python tests/hmm_golden.py",
            "made_by": "hic_genome_assembler_tpu.cli -part1 -mesh off, jax_enable_x64, CPU",
            "genome": f"hic_genome_assembler_tpu_torch.utils.e2e.make_hmm_genome({N})",
            "bins": genome.n_bins,
            "settings": e2e.HMM_SETTINGS,
            "matrix_sha256": sha256(paths["matrix"]),
            "cut_indices": cut_list(buf.getvalue()),
            "files_sha256": {
                name: sha256(os.path.join(workdir, "files", name)) for name in PART1_FILES
            },
        }
    with open(out_path, "w") as handle:
        json.dump(record, handle, indent=1)
        handle.write("\n")
    print(json.dumps(record))


if __name__ == "__main__":
    main(*sys.argv[1:])
