"""Entry points of the PyTorch port, the twin of ``__graft_entry__.py``.

entry(device="cuda")  -> (fn, args): the flagship scoring step, the
                      block-factorized brute-force permutation scorer, as
                      the JAX ``entry`` (``__graft_entry__.py:23-58``)
                      builds it.  ``fn`` is ``score_kernels.block_scores``,
                      the hand-written ``block_kernel`` of
                      ``csrc/score_kernels.cu`` (the counterpart of JAX
                      ``ops/cost.py:204`` ``_block_score_kernel``), and
                      ``fn(*args)`` returns the ``[360, 64]`` float32 scores
                      of every (order, orientation) pair.  The kernel takes
                      the orientation rows themselves where the JAX function
                      took ``e_onehot``, ``pi`` and ``pj`` (the one-hot
                      selector it multiplies by); the pairs are the kernel's
                      own.  It reads the table's width from the table.  The
                      JAX ``entry`` passes ``Cp1 = C + 1`` (133) where its
                      scorer's table is ``C_pad + 1`` (257) wide, so its
                      ``fn(*args)`` reads cells of other pairs; the JAX
                      scorer itself (``BlockScorer.score_batch``) passes the
                      table's width, and those are the scores returned here.
                      On the card ``fn`` launches the kernel, on the CPU it
                      runs ``block_scores_plain``.
dryrun_multichip(n, device="cuda")
                   -> drive the real part 1 + part 2 pipeline on an
                      n-position ``(n, 1)`` mesh (``__graft_entry__.py:61-218``):
                      1. parts 1-2 with the mesh and without it on the same
                         device, the file bus byte-equal (``:86-133``);
                      2. part 2's EP shard/merge in this process
                         (``process_count=2``: rank 1, then rank 0, which
                         waits on the file-bus barrier and merges), the
                         merged order file equal to the mesh-less run's
                         (``:135-161``);
                      2b. for n >= 2, the same EP with each rank on its own
                         ``(n // 2, 1)`` submesh (``:163-190``);
                      3. the fused step of ``parallel/pipeline_step.py``,
                         then every card of the mesh synchronised
                         (``:194-202``);
                      4. the placement proof: a batch and a matrix put on
                         the mesh give one block per position, each on its
                         position's device, which together hold the whole
                         padded array (``:204-209``; the torch form of
                         ``len(x.sharding.device_set) == n``, which counts
                         positions, not distinct devices).

On ``cuda`` the n positions are the visible cards taken round-robin
(``cuda:i % k`` of k cards): a real mesh with n cards or more, else a
virtual one in which cards repeat (``parallel/mesh.py``).  On ``cpu`` they
are n positions of the CPU.  ``cuda`` without a card raises.

    python3 __graft_entry_torch__.py [n]        # n defaults to 8, on the card
    python3 -c "import __graft_entry_torch__ as g; g.dryrun_multichip(8, device='cpu')"

This file imports torch, numpy and the port only.
"""

import sys
import os

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# the files that steps 1-2b hold byte-equal
BUS_FILES = ("chromgroups.txt", "chromorder.txt", "plotorder.txt")


def entry(device="cuda"):
    import numpy as np

    from hic_genome_assembler_tpu_torch import device as device_mod
    from hic_genome_assembler_tpu_torch.ops import cost, perms, score_kernels
    from hic_genome_assembler_tpu_torch.utils import transfer

    dev = device_mod.resolve(device)
    rng = np.random.default_rng(0)
    sizes = [40, 32, 24, 16, 12, 8]
    C = sum(sizes)
    m = rng.random((C, C))
    m = (m + m.T).astype(np.float64)
    scorer = cost.BlockScorer(m, sizes, dev, dtype=np.float32)
    args = (
        scorer._F_flat,
        scorer._sizes_d,
        transfer.to_device(perms.order_batch(len(sizes)), dev, np.int32),
        transfer.to_device(perms.orient_batch(len(sizes)), dev, np.int32),
        scorer._c0_d,
    )
    return score_kernels.block_scores, args


def _mesh_of(n_devices, device):
    """The ``(n, 1)`` mesh of the dry run and the device its mesh-less runs
    use (position 0's)."""
    import torch

    from hic_genome_assembler_tpu_torch import device as device_mod
    from hic_genome_assembler_tpu_torch.parallel import mesh as pm

    if n_devices < 1:
        raise ValueError(f"need at least one mesh position, got {n_devices}")
    dev = device_mod.resolve(device)
    if dev.type == "cuda":
        k = torch.cuda.device_count()
        positions = [torch.device("cuda", i % k) for i in range(n_devices)]
    else:
        positions = [dev] * n_devices
    return pm.make_mesh((n_devices, 1), positions), positions[0]


def _dryrun_buses(n_devices, device="cuda"):
    """Steps 1-2b of :func:`dryrun_multichip`, with their checks; returns
    each run's file bus, ``{run: {file name: bytes}}`` for the runs
    ``mesh``, ``local`` (no mesh), ``ep`` and, for n >= 2, ``ep_mesh``."""
    import shutil
    import tempfile

    from hic_genome_assembler_tpu_torch.models import part1_cluster, part2_order
    from hic_genome_assembler_tpu_torch.parallel import mesh as pm
    from hic_genome_assembler_tpu_torch.utils import fixtures

    mesh, dev = _mesh_of(n_devices, device)
    g = fixtures.make_genome(chrom_scaffold_bins=((5, 4, 3, 2, 2), (4, 3, 2)), seed=11)
    work = tempfile.mkdtemp(prefix="dryrun_multichip_torch_")

    def part1(out, use_mesh):
        part1_cluster.run_pipeline(
            paths["bed"], paths["bias"], paths["matrix"], paths["sizes"],
            os.path.join(out, "dendro.txt"), "", "", os.path.join(out, "bingroups.txt"),
            os.path.join(out, "assessment.txt"), os.path.join(out, "chromgroups.txt"),
            hyper_geom=True, hmm=False, min_size=5, modularity=0,
            louvain_rounds=3, psig=0.05, convergence_rounds=5,
            look_ahead=0.2, resolution=g.resolution, device=dev, mesh=use_mesh,
        )

    def part2(groups_dir, out, use_mesh, **ep):
        part2_order.run_pipeline(
            paths["bed"], paths["bias"], paths["matrix"],
            os.path.join(groups_dir, "chromgroups.txt"), os.path.join(out, "chromorder.txt"),
            "", "", "", "dryrun", os.path.join(out, "plotorder.txt"),
            n_scaffolds=3, scan_scaffolds=2, resolution=g.resolution,
            device=dev if use_mesh is None else use_mesh.first, mesh=use_mesh, **ep,
        )

    def bus(out, names=BUS_FILES):
        result = {}
        for name in names:
            with open(os.path.join(out, name), "rb") as handle:
                result[name] = handle.read()
        return result

    try:
        paths = fixtures.write_hicpro_files(g, os.path.join(work, "data"))
        buses = {}
        # 1. parts 1-2 under the mesh and without it
        for tag, use_mesh in (("mesh", mesh), ("local", None)):
            out = os.path.join(work, tag)
            os.makedirs(out)
            part1(out, use_mesh)
            part2(out, out, use_mesh)
            buses[tag] = bus(out)
        assert buses["mesh"] == buses["local"], "mesh run diverged from the single-device run"

        # 2. part 2's EP in this process: rank 1 writes its shard and
        #    returns; rank 0 writes its own, waits on the barrier and merges
        ep_dir = os.path.join(work, "ep")
        os.makedirs(ep_dir)
        part1(ep_dir, None)
        for rank in (1, 0):
            part2(ep_dir, ep_dir, None, process_index=rank, process_count=2, shard_wait_s=60.0)
        buses["ep"] = bus(ep_dir)
        assert buses["ep"]["chromorder.txt"] == buses["local"]["chromorder.txt"], (
            "EP-merged order file diverged from the single-process run"
        )

        # 2b. EP composed with the mesh: each rank drives its own
        #     (n // 2, 1) submesh of the positions
        if n_devices >= 2:
            half = n_devices // 2
            positions = list(mesh.devices[:, 0])
            sub_meshes = {
                0: pm.make_mesh((half, 1), positions[:half]),
                1: pm.make_mesh((half, 1), positions[half : 2 * half]),
            }
            ep_mesh_dir = os.path.join(work, "ep_mesh")
            os.makedirs(ep_mesh_dir)
            for rank in (1, 0):
                part2(ep_dir, ep_mesh_dir, sub_meshes[rank], process_index=rank,
                      process_count=2, shard_wait_s=60.0)
            buses["ep_mesh"] = bus(ep_mesh_dir, BUS_FILES[1:])
            assert buses["ep_mesh"]["chromorder.txt"] == buses["local"]["chromorder.txt"], (
                "EP x mesh merged order file diverged from the single-process run"
            )
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return buses


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    import numpy as np
    import torch

    from hic_genome_assembler_tpu_torch.parallel import mesh as pm
    from hic_genome_assembler_tpu_torch.parallel import pipeline_step

    _dryrun_buses(n_devices, device)
    mesh, _dev = _mesh_of(n_devices, device)
    positions = list(mesh.devices[:, 0])
    distinct = list(dict.fromkeys(positions))

    # 3. the fused step, then every card the mesh names synchronised so
    #    that a launch fault surfaces here
    step = pipeline_step.make_fused_step(mesh)
    step(*pipeline_step.example_inputs(mesh))
    for d in distinct:
        if d.type == "cuda":
            torch.cuda.synchronize(d)

    # 4. placement proof: one block per position, on its position's device,
    #    together the whole padded array (distinct values where the JAX file
    #    puts zeros, so that a block out of place shows)
    batch = np.arange(n_devices * 4 * 8, dtype=np.int32).reshape(n_devices * 4, 8)
    matrix = np.arange((n_devices * 8) ** 2, dtype=np.float64).reshape(n_devices * 8, -1)
    batch_blocks, _ = pm.put_batch_padded(mesh, batch)
    matrix_blocks, _ = pm.put_matrix_padded(mesh, matrix)
    assert len(batch_blocks) == len(matrix_blocks) == n_devices
    for pos, b, row in zip(positions, batch_blocks, matrix_blocks):
        assert b.device == pos and len(row) == 1 and row[0].device == pos
    assert np.array_equal(torch.cat([b.cpu() for b in batch_blocks]).numpy(), batch)
    assert np.array_equal(torch.cat([row[0].cpu() for row in matrix_blocks]).numpy(), matrix)

    where = ", ".join(str(d) for d in distinct)
    unit = "card" if distinct[0].type == "cuda" else "device"
    print(
        f"dryrun_multichip OK: {n_devices} positions over {len(distinct)} {unit}"
        f"{'s' if len(distinct) > 1 else ''} ({where}) drove the real part1+part2 "
        f"pipeline (mesh-blocked counts + DP-split search; file bus identical "
        f"to the single-device run), the EP shard/merge path "
        f"(process_count=2), EP x mesh composition (2 EP ranks each "
        f"driving a {n_devices // 2}-position submesh, byte-identical merge), "
        f"and the fused TP+SP+DP step"
    )


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    dryrun_multichip(n)
