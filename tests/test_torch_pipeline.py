"""The port's CLI against the JAX package's CLI on the same fixture: every
file-bus file and the assembled FASTA byte-equal, once with the default
``_HOST_N`` (host counts) and once with ``_HOST_N = 0`` in both packages,
so that both device count paths run at a small n; then part 1's other
branches (the HMM cut search in both modes, and ``matrixMode = device``)."""

import filecmp
import hashlib
import json
import os

import pytest

from hic_genome_assembler_tpu import cli as jax_cli
from hic_genome_assembler_tpu.cluster import breakpoints as jax_bp
from hic_genome_assembler_tpu.utils import fixtures
from hic_genome_assembler_tpu.viz import plot as plot_mod
from hic_genome_assembler_tpu_torch import cli
from hic_genome_assembler_tpu_torch.cluster import breakpoints as bp
from hic_genome_assembler_tpu_torch.utils import e2e, profiling
from hic_genome_assembler_tpu_torch.viz import plot as torch_plot_mod

FILES = (
    "dendrogramOrder.txt",
    "binGroupings.txt",
    "clusterAssessment.txt",
    "chromosomeGroupings.txt",
    "chromosomeOrdering.txt",
    "plotOrder.txt",
    "finalChromosomeOrdering.txt",
    "assembled.fasta",
)
PARTS = ["-part1", "-part2", "-part3", "-part4"]
# the working example's genome and part-1/2 settings (3 chromosomes, 123 bins)
SETTINGS = {"minSize": "5", "louvainRounds": "5", "nScaffolds": "4", "scanScaffolds": "3"}


@pytest.fixture(scope="module")
def fixture_genome(tmp_path_factory):
    genome = fixtures.make_genome(
        chrom_scaffold_bins=((14, 12, 10, 8, 6), (12, 11, 9, 8), (10, 9, 8, 6)),
        seed=13, noise=0.005, cross_noise_frac=0.001,
    )
    paths = fixtures.write_hicpro_files(genome, str(tmp_path_factory.mktemp("hicpro")))
    return genome, paths


@pytest.fixture(autouse=True)
def _quiet(monkeypatch):
    # no PNGs are compared; each package plots through its own copy of this
    # function
    monkeypatch.setattr(plot_mod, "plot_contact_map", lambda *a, **k: None)
    monkeypatch.setattr(torch_plot_mod, "plot_contact_map", lambda *a, **k: None)
    monkeypatch.setenv("HIC_JAX_CACHE", "off")


@pytest.mark.parametrize("host_n", [bp._HOST_N, 0])
def test_cli_outputs_byte_equal_to_jax(fixture_genome, tmp_path, monkeypatch, host_n):
    genome, paths = fixture_genome
    monkeypatch.setattr(bp, "_HOST_N", host_n)
    monkeypatch.setattr(jax_bp, "_HOST_N", host_n)
    cfg_t = e2e.write_config(
        str(tmp_path / "torch.cfg"), str(tmp_path / "torch"), paths, genome.resolution, SETTINGS
    )
    cfg_j = e2e.write_config(
        str(tmp_path / "jax.cfg"), str(tmp_path / "jax"), paths, genome.resolution, SETTINGS
    )
    report = cli.main(PARTS + ["-config", cfg_t, "-device", "cpu"])
    jax_cli.main(PARTS + ["-config", cfg_j, "-mesh", "off"])
    assert report.rank_counts_on == ("host" if host_n else "cpu")
    assert set(report.part_seconds) == {"part1", "part2", "part3", "part4"}
    for name in FILES:
        ours = os.path.join(tmp_path, "torch", "files", name)
        theirs = os.path.join(tmp_path, "jax", "files", name)
        assert filecmp.cmp(ours, theirs, shallow=False), name
    truth = e2e.truth_checks(genome, os.path.join(tmp_path, "torch", "files"))
    assert truth["groups_match_truth"]
    assert truth["orders_recovered"] == truth["orders_checked"] == 3
    assert truth["entry_lengths_ok"] == truth["assembled_entries"] == 3


@pytest.fixture(scope="module")
def hmm_genome(tmp_path_factory):
    """``tests/test_hmm.py``'s HMM-branch genome: flat within-chromosome
    contact, 3 chromosomes, 48 bins."""
    genome = fixtures.make_genome(
        chrom_scaffold_bins=((7, 6, 4, 3), (6, 5, 5), (4, 4, 2, 2)),
        seed=5, noise=0.004, cross_noise_frac=0.001, decay_alpha=0.0,
    )
    paths = fixtures.write_hicpro_files(genome, str(tmp_path_factory.mktemp("hicpro_hmm")))
    return genome, paths


# tests/test_hmm.py's part-1 settings of the HMM branch
HMM_SETTINGS = {
    "hyperGeom": "False", "hmm": "True", "minSize": "11", "modularity": "0",
    "louvainRounds": "3", "convergenceRounds": "5", "lookAhead": ".5",
    "nScaffolds": "4", "scanScaffolds": "3",
}


def _run_both(genome, paths, tmp_path, settings):
    cfg_t = e2e.write_config(
        str(tmp_path / "torch.cfg"), str(tmp_path / "torch"), paths, genome.resolution, settings
    )
    cfg_j = e2e.write_config(
        str(tmp_path / "jax.cfg"), str(tmp_path / "jax"), paths, genome.resolution, settings
    )
    # part 1 alone first: part 2 resets the timers
    report = cli.main(PARTS[:1] + ["-config", cfg_t, "-device", "cpu"])
    timers = set(profiling.summary())
    cli.main(PARTS[1:] + ["-config", cfg_t, "-device", "cpu"])
    jax_cli.main(PARTS + ["-config", cfg_j, "-mesh", "off"])
    for name in FILES:
        ours = os.path.join(tmp_path, "torch", "files", name)
        theirs = os.path.join(tmp_path, "jax", "files", name)
        assert filecmp.cmp(ours, theirs, shallow=False), name
    return report, timers


@pytest.mark.parametrize(
    "case", ["hmm_fast", "hmm_exact", f"device_host_n_{bp._HOST_N}", "device_host_n_0"]
)
def test_other_part1_branches_byte_equal_to_jax(
    fixture_genome, hmm_genome, tmp_path, monkeypatch, case
):
    """``hmm = True`` in both ``hmmMode``s, and ``matrixMode = device`` with
    the rank tensor read back (default ``_HOST_N``) or padded where it lies
    (``_HOST_N = 0``)."""
    if case.startswith("hmm"):
        genome, paths = hmm_genome
        settings = dict(HMM_SETTINGS, hmmMode=case[4:])
    else:
        host_n = int(case.rsplit("_", 1)[1])
        monkeypatch.setattr(bp, "_HOST_N", host_n)
        monkeypatch.setattr(jax_bp, "_HOST_N", host_n)
        genome, paths = fixture_genome
        settings = dict(SETTINGS, matrixMode="device")
    report, timers = _run_both(genome, paths, tmp_path, settings)
    truth = e2e.truth_checks(genome, os.path.join(tmp_path, "torch", "files"))
    assert truth["groups_match_truth"]
    assert report.cut_indices
    if case.startswith("hmm"):
        assert report.rank_counts_on is None
        assert "part1/cut_detection_hmm" in timers
        assert "part1/cut_detection_hypergeom" not in timers
    else:
        assert report.rank_counts_on == ("host" if host_n else "cpu")
        assert "part1/cut_detection_hypergeom" in timers


def test_hmm_golden_matrix_is_what_the_genome_writes(tmp_path):
    """The golden file of the GPU smoke run was made from the genome that
    ``make_hmm_genome(8192)`` writes today."""
    with open(e2e.HMM_GOLDEN) as handle:
        golden = json.load(handle)
    genome = e2e.make_hmm_genome(8192)
    assert genome.n_bins == golden["bins"] == 3715
    paths = fixtures.write_hicpro_files(genome, str(tmp_path))
    with open(paths["matrix"], "rb") as handle:
        assert hashlib.sha256(handle.read()).hexdigest() == golden["matrix_sha256"]
    assert golden["settings"] == e2e.HMM_SETTINGS
    assert golden["cut_indices"] == sorted(golden["cut_indices"])
    assert set(golden["files_sha256"]) == {
        "binGroupings.txt", "clusterAssessment.txt", "chromosomeGroupings.txt"
    }


def test_e2e_layout_is_the_16k_fixture():
    """The smoke's genome: 25 chromosomes x 52 scaffolds, 17,162 bins."""
    layout = e2e.e2e_layout()
    assert len(layout) == 25 and all(len(c) == 52 for c in layout)
    assert sum(map(sum, layout)) == 17162
    assert e2e.e2e_layout(12) == layout[:12]
