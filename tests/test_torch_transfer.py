"""Part 2's copies between the host and the card (``utils/transfer``) and
the scheduler that drives them, against the JAX package's scheduler.

Scripted search coroutines go through the port's ``_run_interleaved`` and
the JAX package's at live windows 1, 6 and 64: every coroutine receives
the same values in the same order, and each pass drains once (the port's
``finish_readback`` and the JAX package's ``jax.device_get`` are counted,
with the number of readbacks each drain takes).  The port's CLI ``-part2
-device cpu`` at each window writes the JAX CLI's files byte for byte.  A
source scan keeps every copy of part 2's modules in the helper, and on the
CPU the helper never pins memory.
"""

import ast
import contextlib
import filecmp
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hic_genome_assembler_tpu import cli as jax_cli
from hic_genome_assembler_tpu.models import part2_order as jax_part2
from hic_genome_assembler_tpu_torch import cli
from hic_genome_assembler_tpu_torch.io import filebus
from hic_genome_assembler_tpu_torch.models import part2_order
from hic_genome_assembler_tpu_torch.ops import cost
from hic_genome_assembler_tpu_torch.parallel import mesh as pm
from hic_genome_assembler_tpu_torch.utils import e2e, fixtures, transfer
from hic_genome_assembler_tpu_torch.viz import plot as torch_plot_mod
from hic_genome_assembler_tpu.viz import plot as jax_plot_mod

REPO = Path(__file__).resolve().parent.parent
WINDOWS = (1, 6, 64)
PART2_FILES = ("chromosomeOrdering.txt", "plotOrder.txt")


# ---------------------------------------------------------------------------
# Scripted coroutines through both schedulers
# ---------------------------------------------------------------------------


def _scripted(i: int, steps: int, make, log: list):
    """A search coroutine: ``steps`` yields of two handles whose values
    depend on everything it received before (so a value delivered to the
    wrong coroutine or out of order changes what follows); logs what it
    receives and returns its running total."""
    total = float(i)
    for t in range(steps):
        n = 1 + (i + t) % 5
        host = yield (make(np.arange(n, dtype=np.float32) + total + t),
                      make(np.full(3, i * 1000 + t, dtype=np.int64)))
        log.append((i, t, [np.asarray(h).tolist() for h in host]))
        total += float(host[0].sum()) + int(host[1][0])
    return total


STEPS = (3, 0, 7, 1, 5, 2, 9, 4, 0, 6, 1, 8, 3)


def _run_port(window, monkeypatch):
    drains = []
    finish = transfer.finish_readback

    def counting(readbacks):
        drains.append(len(readbacks))
        return finish(readbacks)

    monkeypatch.setattr(transfer, "finish_readback", counting)
    log: list = []
    coros = [_scripted(i, s, torch.from_numpy, log) for i, s in enumerate(STEPS)]
    return part2_order._run_interleaved(coros, max_live=window), log, drains


def _run_jax(window, monkeypatch):
    drains = []
    device_get = jax.device_get

    def counting(tree):
        drains.append(len(tree))
        return device_get(tree)

    monkeypatch.setattr(jax, "device_get", counting)
    log: list = []
    coros = [_scripted(i, s, jnp.asarray, log) for i, s in enumerate(STEPS)]
    return jax_part2._run_interleaved(coros, max_live=window), log, drains


@pytest.mark.parametrize("window", WINDOWS)
def test_scheduler_delivers_the_jax_schedulers_values(window, monkeypatch):
    results, log, drains = _run_port(window, monkeypatch)
    jax_results, jax_log, jax_drains = _run_jax(window, monkeypatch)
    assert results == jax_results
    # the same values to each coroutine, in the same order
    assert sorted(log, key=lambda e: e[:2]) == sorted(jax_log, key=lambda e: e[:2])
    assert log == jax_log
    # one drain a pass, over the same live coroutines as the JAX package's
    assert drains == jax_drains
    assert sum(drains) == sum(STEPS)


def test_drive_drains_each_step_once(monkeypatch):
    drains = []
    finish = transfer.finish_readback
    monkeypatch.setattr(transfer, "finish_readback",
                        lambda rs: drains.append(len(rs)) or finish(rs))
    log: list = []
    got = part2_order._drive(_scripted(2, 6, torch.from_numpy, log))
    want = jax_part2._drive(_scripted(2, 6, jnp.asarray, []))
    assert got == want
    assert drains == [1] * 6


def test_finish_returns_each_readbacks_arrays_in_order():
    a = torch.arange(5, dtype=torch.float32)
    b = torch.tensor([7, 8], dtype=torch.int64)
    r1, r2 = transfer.start_readback([a, b]), transfer.start_readback([b])
    got = transfer.finish_readback([r1, r2])
    assert [[x.tolist() for x in r] for r in got] == [[a.tolist(), b.tolist()], [b.tolist()]]
    assert r1.events == {} and r2.events == {}
    buf = torch.empty(7)
    transfer.finish_readback([transfer.start_readback([a, b], into=[buf[:5], buf[5:]])])
    assert buf.tolist() == [0, 1, 2, 3, 4, 7, 8]


# ---------------------------------------------------------------------------
# The CLI at each window against the JAX CLI
# ---------------------------------------------------------------------------

# eight small chromosomes: more than one window of 6 live searches
WINDOW_GENOME = dict(
    chrom_scaffold_bins=((6, 5, 4, 3, 2), (5, 4, 4, 3), (6, 5, 3, 2, 2), (4, 4, 3, 3),
                         (5, 4, 3, 2, 2), (6, 4, 3, 3), (5, 5, 4, 2), (4, 3, 3, 2, 2)),
    seed=5, noise=0.005, cross_noise_frac=0.001,
)
SETTINGS = {"nScaffolds": "4", "scanScaffolds": "3"}


@pytest.fixture(scope="module")
def window_run(tmp_path_factory):
    """The fixture's HiC-Pro files, its true chromosome groups as part 1's
    file, and the JAX CLI's part 2 on them (its default window)."""
    root = tmp_path_factory.mktemp("windows")
    genome = fixtures.make_genome(**WINDOW_GENOME)
    paths = fixtures.write_hicpro_files(genome, str(root / "hicpro"))
    groups = [[(bid, name) for name in names for bid in genome.scaffold(name).bin_ids]
              for _c, names in sorted(genome.true_groups().items())]
    sizes = {s.name: s.size_bp for s in genome.scaffolds}
    groupings = str(root / "chromosomeGroupings.txt")
    filebus.write_chromosome_groupings(groups, sizes, groupings)

    def config(name):
        cfg = e2e.write_config(str(root / f"{name}.cfg"), str(root / name), paths,
                               genome.resolution, SETTINGS)
        shutil.copy(groupings, root / name / "files" / "chromosomeGroupings.txt")
        return cfg

    saved = jax_plot_mod.plot_contact_map
    jax_plot_mod.plot_contact_map = lambda *a, **k: None
    try:
        jax_cli.main(["-part2", "-config", config("jax"), "-mesh", "off"])
    finally:
        jax_plot_mod.plot_contact_map = saved
    return root, config


@pytest.mark.parametrize("window", WINDOWS)
def test_cli_part2_at_each_window_byte_equal_to_jax(window_run, window, monkeypatch):
    root, config = window_run
    monkeypatch.setattr(torch_plot_mod, "plot_contact_map", lambda *a, **k: None)
    monkeypatch.setenv("HIC_INTERLEAVE_WINDOW", str(window))
    drains = []
    finish = transfer.finish_readback
    monkeypatch.setattr(transfer, "finish_readback",
                        lambda rs: drains.append(len(rs)) or finish(rs))
    cli.main(["-part2", "-config", config(f"w{window}"), "-device", "cpu", "-mesh", "off"])
    for name in PART2_FILES:
        assert filecmp.cmp(root / f"w{window}" / "files" / name, root / "jax" / "files" / name,
                           shallow=False), name
    assert drains and max(drains) <= window


# ---------------------------------------------------------------------------
# Every copy of part 2's modules goes through the helper
# ---------------------------------------------------------------------------

SCANNED = ("hic_genome_assembler_tpu_torch/ops/cost.py",
           "hic_genome_assembler_tpu_torch/models/part2_order.py",
           "hic_genome_assembler_tpu_torch/parallel/mesh.py")


def _direct_copies(source: str) -> list:
    """``.cpu()`` calls, ``torch.from_numpy(...).to(...)`` and
    ``torch.tensor(..., device=...)`` in ``source``'s code (not its
    docstrings)."""
    found = []
    for node in ast.walk(ast.parse(source)):
        if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)):
            continue
        attr, inner = node.func.attr, node.func.value
        if attr == "cpu":
            found.append((node.lineno, ".cpu()"))
        elif (attr == "to" and isinstance(inner, ast.Call)
              and isinstance(inner.func, ast.Attribute) and inner.func.attr == "from_numpy"):
            found.append((node.lineno, "torch.from_numpy(...).to("))
        elif attr == "tensor" and any(k.arg == "device" for k in node.keywords):
            found.append((node.lineno, "torch.tensor(..., device=)"))
    return sorted(found)


@pytest.mark.parametrize("rel", SCANNED)
def test_part2_modules_copy_only_through_the_helper(rel):
    assert _direct_copies((REPO / rel).read_text()) == []


def test_the_scan_finds_direct_copies():
    src = ("def f(t, a):\n    x = t.cpu().numpy()\n    y = torch.from_numpy(a).to(dev)\n"
           "    z = torch.tensor(1.0, device=dev)\n    return x, y, z\n")
    assert [what for _line, what in _direct_copies(src)] == [
        ".cpu()", "torch.from_numpy(...).to(", "torch.tensor(..., device=)"]


# ---------------------------------------------------------------------------
# The CPU never pins
# ---------------------------------------------------------------------------


@pytest.fixture
def no_pinning(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("pinned memory requested on the CPU path")

    monkeypatch.setattr(transfer, "_pinned", refuse)
    monkeypatch.setattr(torch.Tensor, "pin_memory", refuse)


def test_cpu_copies_never_pin(no_pinning):
    a = np.arange(12, dtype=np.float64).reshape(3, 4)
    t = transfer.to_device(a, "cpu", np.float32)
    assert t.dtype == torch.float32 and t.tolist() == a.tolist()
    same = transfer.to_device(a, torch.device("cpu"))
    assert np.shares_memory(same.numpy(), a)
    dst = torch.zeros(3, 4, dtype=torch.int32)
    transfer.copy_into(dst, a)
    assert dst.tolist() == a.astype(np.int32).tolist()
    assert transfer.to_host([t])[0].tolist() == a.tolist()
    parts = [(0, 2, torch.ones(4, 3)), (2, 1, torch.full((1, 3), 2.0))]
    assert cost._drain_rows(parts, (3, 3)).tolist() == [[1.0] * 3, [1.0] * 3, [2.0] * 3]
    blocks, n = pm.put_matrix_padded(pm.make_mesh((2, 2), ["cpu"] * 4), a[:3, :3])
    assert n == 3 and blocks[1][1].tolist() == [[a[2, 2], 0.0], [0.0, 0.0]]


def test_to_device_casts_a_tensor_as_it_casts_an_array(no_pinning):
    a = np.arange(6, dtype=np.float64).reshape(2, 3)
    for dtype in (np.float32, np.int32, np.int64):
        from_array = transfer.to_device(a, "cpu", dtype)
        from_tensor = transfer.to_device(torch.from_numpy(a), "cpu", dtype)
        assert from_tensor.dtype == from_array.dtype == transfer.torch_dtype(dtype)
        assert torch.equal(from_tensor, from_array)
    assert transfer.to_device(torch.from_numpy(a), "cpu").dtype == torch.float64


def test_cpu_part2_never_pins(window_run, no_pinning, monkeypatch):
    root, config = window_run
    monkeypatch.setattr(torch_plot_mod, "plot_contact_map", lambda *a, **k: None)
    cli.main(["-part2", "-config", config("nopin"), "-device", "cpu", "-mesh", "2x2"])
    for name in PART2_FILES:
        assert filecmp.cmp(root / "nopin" / "files" / name, root / "jax" / "files" / name,
                           shallow=False), name


def test_upload_chunks_cover_the_array(monkeypatch):
    """The chunked upload's row split (run on the CPU with a fake card: the
    pinned staging and the non-blocking copy replaced by plain copies)."""
    staged = []
    monkeypatch.setattr(transfer, "CHUNK_BYTES", 40)
    monkeypatch.setattr(transfer, "_pinned",
                        lambda shape, dtype: staged.append(tuple(shape)) or torch.empty(
                            shape, dtype=dtype))

    class FakeCard:
        type = "cuda"

    class Dst:
        def __init__(self, t):
            self.t, self.device, self.dtype = t, FakeCard(), t.dtype

        def __getitem__(self, key):
            return Dst(self.t[key])

        def copy_(self, src, non_blocking=False):
            assert non_blocking
            self.t.copy_(src)
            return self

    monkeypatch.setattr(torch.cuda, "device", lambda _dev: contextlib.nullcontext())
    a = np.arange(35, dtype=np.float64).reshape(7, 5)      # 40-byte rows: one a chunk
    out = torch.zeros(7, 5, dtype=torch.float32)
    transfer.copy_into(Dst(out), a)
    assert out.tolist() == a.tolist() and staged == [(1, 5)] * 7
    staged.clear()
    monkeypatch.setattr(transfer, "CHUNK_BYTES", 100)       # two rows a chunk, 3 + 1 pieces
    out.zero_()
    transfer.copy_into(Dst(out), torch.from_numpy(a))
    assert out.tolist() == a.tolist() and staged == [(2, 5)] * 3 + [(1, 5)]
