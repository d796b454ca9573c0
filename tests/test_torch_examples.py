"""The port's twins of the examples run green, on the CPU, without jax.

``examples/working_example_torch.py`` (with the committed
``configs/hicAssembler_config_fixtureExample_torch.txt``) and
``examples/run_fixture_pipeline_torch.py`` run as subprocesses with
``--device cpu``, as a user would run them, while an import hook makes
jax, scikit-learn, matplotlib (which the GPU machines lack too) and the JAX
package unimportable; each must pass its truth check.  The working
example's files and FASTA must equal, byte for byte, the JAX CLI's on the
same config and inputs.  The twin config's settings equal the original's
but for the workdir.  The notebook twin runs under nbclient with its
device cell set to the CPU, jax and the JAX package unimportable in its
kernel.
"""

import filecmp
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from hic_genome_assembler_tpu import cli as jax_cli
from hic_genome_assembler_tpu.viz import plot as jax_plot_mod

REPO = Path(__file__).resolve().parent.parent
EXAMPLES = REPO / "examples"
CONFIGS = REPO / "configs"
TWIN_CONFIG = CONFIGS / "hicAssembler_config_fixtureExample_torch.txt"
JAX_WORKDIR, TWIN_WORKDIR = "/tmp/hic_working_example", "/tmp/hic_working_example_torch"

_BLOCK = """
import importlib.abc, runpy, sys

BLOCKED = {blocked!r}

class _NotInstalled(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ModuleNotFoundError(f"No module named {{name!r}}", name=name)
        return None

sys.meta_path.insert(0, _NotInstalled())
"""
# runs the example at argv[1] with the arguments after it
_RUN = _BLOCK.format(blocked=("jax", "jaxlib", "sklearn", "matplotlib",
                              "hic_genome_assembler_tpu")) + """
sys.argv = sys.argv[1:]
runpy.run_path(sys.argv[0], run_name="__main__")
loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
print("LOADED", loaded)
"""


def _env():
    return {k: v for k, v in os.environ.items()
            if not k.startswith(("JAX_", "XLA_")) and k not in ("HIC_MESH", "WORLD_SIZE", "RANK")}


def _run_example(script, *args, cwd):
    proc = subprocess.run(
        [sys.executable, "-c", _RUN, str(EXAMPLES / script), *args],
        capture_output=True, text=True, timeout=600, cwd=str(cwd), env=_env(),
    )
    return proc, proc.stdout + proc.stderr


def _config_in(tmp_path):
    """A copy of the twin config whose workdir lies under ``tmp_path``."""
    cfg = tmp_path / "cfg.txt"
    cfg.write_text(TWIN_CONFIG.read_text().replace(TWIN_WORKDIR, str(tmp_path / "w")))
    return cfg


def test_working_example_twin_runs_green_and_equals_the_jax_cli(tmp_path, monkeypatch):
    twin_cfg = _config_in(tmp_path)
    proc, out = _run_example("working_example_torch.py", "--device", "cpu", "--config",
                             str(twin_cfg), cwd=tmp_path)
    assert proc.returncode == 0, out[-4000:]
    assert "chromosome groups match planted truth: True" in proc.stdout
    assert "device: cpu" in proc.stdout
    assert "LOADED []" in proc.stdout

    # the JAX CLI on the same config and inputs, its outputs elsewhere
    twin_files = tmp_path / "w" / "files"
    text = twin_cfg.read_text()
    for key in ("saveFilesDirectory", "savePlotsDirectory"):
        sub = key.replace("save", "").replace("Directory", "").lower()
        text = text.replace(f"{key} = {tmp_path / 'w' / sub}", f"{key} = {tmp_path / sub}")
    (tmp_path / "files").mkdir()
    (tmp_path / "plots").mkdir()
    cfg = tmp_path / "jax.cfg"
    cfg.write_text(text)
    monkeypatch.setattr(jax_plot_mod, "plot_contact_map", lambda *a, **k: None)
    monkeypatch.setenv("HIC_JAX_CACHE", "off")
    jax_cli.main(["-part1", "-part2", "-part3", "-part4", "-config", str(cfg), "-mesh", "off"])
    names = sorted(p.name for p in (tmp_path / "files").iterdir())
    assert "fixture_assembled.fasta" in names and "fixture_chromosomeOrdering.txt" in names
    for name in names:
        assert filecmp.cmp(twin_files / name, tmp_path / "files" / name, shallow=False), name


def test_fixture_pipeline_twin_runs_green(tmp_path):
    proc, out = _run_example("run_fixture_pipeline_torch.py", str(tmp_path / "demo"), "--device",
                             "cpu", cwd=tmp_path)
    assert proc.returncode == 0, out[-4000:]
    assert "chromosome groups match planted truth: True" in proc.stdout
    assert "LOADED []" in proc.stdout
    assert (tmp_path / "demo" / "files" / "assembled.fasta").stat().st_size > 0


def test_working_example_twin_asks_for_the_card_by_default(tmp_path):
    """Without a card, the default device fails rather than running on the
    host."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default device would run")
    proc, out = _run_example("working_example_torch.py", "--config", str(_config_in(tmp_path)),
                             cwd=tmp_path)
    assert proc.returncode != 0
    assert "no CUDA device is visible" in out
    assert not (tmp_path / "w" / "files" / "fixture_chromosomeGroupings.txt").exists()


def _settings(path):
    return [line for line in path.read_text().splitlines()
            if line.strip() and not line.lstrip().startswith("#")]


def test_twin_config_differs_from_the_original_in_its_workdir_alone():
    original = _settings(CONFIGS / "hicAssembler_config_fixtureExample.txt")
    twin = _settings(TWIN_CONFIG)
    assert [line.replace(JAX_WORKDIR + "/", TWIN_WORKDIR + "/") for line in original] == twin
    assert sum(TWIN_WORKDIR in line for line in twin) == 9


def test_notebook_twin_executes_on_the_cpu(tmp_path, monkeypatch):
    nbformat = pytest.importorskip("nbformat")
    nbclient = pytest.importorskip("nbclient")

    nb = nbformat.read(EXAMPLES / "hic_assembler_notebook_torch.ipynb", as_version=4)
    (cell,) = [c for c in nb.cells if c.cell_type == "code" and c.source.startswith("device = ")]
    cell.source = 'device = "cpu"'
    # and its files under tmp_path
    (cell,) = [c for c in nb.cells if c.cell_type == "code" and "\nworkdir = " in c.source]
    cell.source = cell.source.replace('workdir = "/tmp/hic_notebook_torch"',
                                      f"workdir = {str(tmp_path / 'nb')!r}")
    assert f"workdir = {str(tmp_path / 'nb')!r}" in cell.source
    # the kernel can import neither jax nor the JAX package
    block = _BLOCK.format(blocked=("jax", "jaxlib", "sklearn", "hic_genome_assembler_tpu"))
    nb.cells.insert(0, nbformat.v4.new_code_cell(block))
    nb.cells.append(nbformat.v4.new_code_cell(
        'print("LOADED", sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED))'))
    monkeypatch.setenv("PYTHONPATH", str(REPO))  # the kernel inherits os.environ
    nbclient.NotebookClient(
        nb, timeout=600, kernel_name="python3",
        resources={"metadata": {"path": str(tmp_path)}},
    ).execute()
    outputs = [out for c in nb.cells if c.cell_type == "code" for out in c.get("outputs", [])]
    assert not [out for out in outputs if out.get("output_type") == "error"]
    text = "".join(out.get("text", "") for out in outputs)
    assert "device: cpu" in text
    assert "groups match planted truth: True" in text
    assert "LOADED []" in text
    assert (tmp_path / "nb" / "files" / "assembled.fasta").stat().st_size > 0
