"""The port's parallel layer against the JAX package's, on the CPU.

The JAX side runs on conftest's 8 virtual CPU devices; the port side on
virtual CPU meshes of the same shapes, (8, 1) and (4, 2), whose positions
are all the one CPU device.  Integer counts must be equal, f64 scores
within rtol 1e-12 (the same terms summed in another order), and search
decisions identical.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from hic_genome_assembler_tpu.cluster import breakpoints as jax_bp
from hic_genome_assembler_tpu.io import hicpro
from hic_genome_assembler_tpu.models import part2_order as jax_part2
from hic_genome_assembler_tpu.ops import cost as jax_cost
from hic_genome_assembler_tpu.ops import oracle, perms
from hic_genome_assembler_tpu.parallel import mesh as jax_pm
from hic_genome_assembler_tpu.parallel import pipeline_step as jax_step
from hic_genome_assembler_tpu.utils import fixtures
from hic_genome_assembler_tpu_torch.cluster import breakpoints as bp
from hic_genome_assembler_tpu_torch.models import part2_order
from hic_genome_assembler_tpu_torch.ops import cost
from hic_genome_assembler_tpu_torch.ops import count_kernels as ck
from hic_genome_assembler_tpu_torch.parallel import distributed, pipeline_step, runtime
from hic_genome_assembler_tpu_torch.parallel import mesh as pm
from hic_genome_assembler_tpu_torch.utils import state

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [(8, 1), (4, 2)]
F64_RTOL = 1e-12  # f64 sums of the same terms in another order
STEP_RTOL = 1e-6  # f32 row sums and einsum, reduced in another order


def _meshes(shape):
    """(JAX mesh on the virtual CPU devices, port mesh of CPU positions)."""
    size = shape[0] * shape[1]
    return (
        jax_pm.make_mesh(shape, devices=jax.devices()[:size]),
        pm.make_mesh(shape, [CPU] * size),
    )


def _shards_by_position(jmesh, arr):
    """{(i, j): numpy data of the shard on mesh position (i, j)}."""
    out = {}
    for shard in arr.addressable_shards:
        ((i, j),) = np.argwhere(jmesh.devices == shard.device)
        out[(int(i), int(j))] = np.asarray(shard.data)
    return out


# -- (a) meshes and block placement -----------------------------------------


def test_make_mesh_shapes_and_errors():
    mesh = pm.make_mesh(devices=[CPU] * 8)
    assert mesh.devices.shape == (8, 1) and mesh.devices.dtype == object
    assert mesh.shape == {pm.DATA_AXIS: 8, pm.MODEL_AXIS: 1}
    mesh = pm.make_mesh((4, 2), [CPU] * 8)
    assert mesh.shape[pm.DATA_AXIS] == 4 and mesh.shape[pm.MODEL_AXIS] == 2
    assert mesh.first == CPU and mesh.data_devices == [CPU] * 4
    assert mesh.describe() == "mesh 4x2 cpu"
    with pytest.raises(ValueError, match="mesh shape"):
        pm.make_mesh((3, 2), [CPU] * 8)
    with pytest.raises(ValueError, match="mesh shape"):
        jax_pm.make_mesh((3, 2))
    assert pm.make_mesh().devices.size == len(pm.visible_devices())


@pytest.mark.parametrize("shape", SHAPES)
def test_put_blocks_equal_jax_shards(shape):
    jmesh, mesh = _meshes(shape)
    d, m = shape
    rng = np.random.default_rng(1)
    mat = rng.random((13, 13))
    vec = rng.random(13)
    batch = rng.integers(0, 50, (13, 5))

    blocks, n = pm.put_rows_padded(mesh, mat)
    jarr, jn = jax_pm.put_rows_padded(jmesh, mat)
    assert n == jn == 13
    for (i, j), data in _shards_by_position(jmesh, jarr).items():
        np.testing.assert_array_equal(blocks[i * m + j].numpy(), data)

    blocks, n = pm.put_vector_padded(mesh, vec)
    jarr, _ = jax_pm.put_vector_padded(jmesh, vec)
    for (i, j), data in _shards_by_position(jmesh, jarr).items():
        np.testing.assert_array_equal(blocks[i * m + j].numpy(), data)

    blocks, n = pm.put_matrix_padded(mesh, mat)
    jarr, _ = jax_pm.put_matrix_padded(jmesh, mat)
    assert len(blocks) == d and all(len(row) == m for row in blocks)
    for (i, j), data in _shards_by_position(jmesh, jarr).items():
        np.testing.assert_array_equal(blocks[i][j].numpy(), data)

    blocks, b = pm.put_batch_padded(mesh, batch)
    jarr, jb = jax_pm.put_batch_padded(jmesh, batch)
    assert b == jb == 13 and len(blocks) == d
    for (i, _j), data in _shards_by_position(jmesh, jarr).items():
        np.testing.assert_array_equal(blocks[i].numpy(), data)


def test_blocks_are_copies():
    """A block never aliases the caller's array, even on a virtual mesh."""
    mesh = pm.make_mesh((2, 2), [CPU] * 4)
    mat = np.arange(16.0).reshape(4, 4)
    blocks, _ = pm.put_matrix_padded(mesh, mat)
    blocks[0][0][0, 0] = -1.0
    assert mat[0, 0] == 0.0
    rows, _ = pm.put_rows_padded(mesh, mat)
    rows[0][0, 0] = -1.0
    assert mat[0, 0] == 0.0


# -- (b) run bring-up ---------------------------------------------------------


def test_resolve_mesh_spec(monkeypatch):
    monkeypatch.delenv("HIC_MESH", raising=False)
    assert runtime.resolve_mesh_spec(None) == "auto"
    monkeypatch.setenv("HIC_MESH", "2x2")
    assert runtime.resolve_mesh_spec(None) == "2x2"
    assert runtime.resolve_mesh_spec("off") == "off"


@pytest.mark.parametrize("spec", ["off", "auto", "4x2", "bad"])
def test_bring_up_on_cpu(spec, monkeypatch, capsys):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    if spec == "bad":
        with pytest.raises(ValueError, match="is not 'auto', 'off' or 'RxC'"):
            runtime.bring_up("4by2", "cpu")
        return
    rt = runtime.bring_up(spec, "cpu")
    assert (rt.process_index, rt.process_count, rt.device) == (0, 1, CPU)
    assert rt.is_primary
    if spec == "4x2":
        assert rt.mesh.devices.shape == (4, 2) and rt.mesh.describe() == "mesh 4x2 cpu"
        assert "- Parallel runtime: 1 devices, mesh {'data': 4, 'model': 2}, process 0/1" in (
            capsys.readouterr().out
        )
    else:
        assert rt.mesh is None


def test_bring_up_refuses_what_it_cannot_give(monkeypatch):
    """``cuda`` without a card raises; so does an RxC mesh larger than the
    visible cards (faked here: one card, asked for four)."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            runtime.bring_up("off", "cuda")
    card = torch.device("cuda", 0)
    monkeypatch.setattr(runtime.device_mod, "resolve", lambda name: card)
    monkeypatch.setattr(runtime.pm, "visible_devices", lambda: [card])
    with pytest.raises(ValueError, match="needs 4 cards, 1 visible"):
        runtime.bring_up("2x2", "cuda")
    assert runtime.bring_up("auto", "cuda").mesh is None


@pytest.mark.parametrize(
    "local_world,local_rank,want",
    [(None, 1, [1]), (4, 3, [3]), (8, 5, [1]), (2, 1, [2, 3]), (1, 0, [0, 1, 2, 3])],
)
def test_bring_up_under_ep_takes_only_its_own_cards(monkeypatch, local_world, local_rank, want):
    """Under several processes on one host (faked here: four cards, process
    ``local_rank`` of ``local_world``; no ``LOCAL_WORLD_SIZE`` means all
    ``WORLD_SIZE`` processes share the host), each process's device and
    mesh lie on its own slice of the cards, never on another's."""
    cards = [torch.device("cuda", i) for i in range(4)]
    # one process per host on two hosts when local_world is 1
    world = 4 if local_world is None else max(local_world, 2)
    monkeypatch.setattr(runtime.device_mod, "resolve", lambda name: cards[0])
    monkeypatch.setattr(runtime.pm, "visible_devices", lambda: list(cards))
    monkeypatch.setattr(runtime.distributed, "init_distributed", lambda: (local_rank, world))
    monkeypatch.setattr(runtime.torch.cuda, "set_device", lambda dev: None)
    monkeypatch.setenv("LOCAL_RANK", str(local_rank))
    if local_world is None:
        monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    else:
        monkeypatch.setenv("LOCAL_WORLD_SIZE", str(local_world))
    mine = [cards[i] for i in want]
    assert runtime.own_cards(cards, local_rank, local_world or world) == mine
    rt = runtime.bring_up("auto", "cuda")
    assert rt.device == mine[0] and rt.process_index == local_rank
    if len(mine) == 1:
        assert rt.mesh is None
        with pytest.raises(ValueError, match="needs 2 cards, 1 visible"):
            runtime.bring_up("2x1", "cuda")
    else:
        assert list(rt.mesh.devices.ravel()) == mine
        assert list(runtime.bring_up(f"1x{len(mine)}", "cuda").mesh.devices.ravel()) == mine


# -- (c) process group ----------------------------------------------------------


def test_init_distributed_single_process(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert distributed.init_distributed() == (0, 1)
    assert not torch.distributed.is_initialized()
    distributed.shutdown()


_GLOO_SCRIPT = r"""
import sys
sys.path.insert(0, sys.argv[1])
from hic_genome_assembler_tpu_torch.parallel import distributed
import torch.distributed as dist
print("RESULT", distributed.init_distributed(), dist.get_backend())
distributed.shutdown()
print("INITIALIZED", dist.is_initialized())
"""


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def test_init_distributed_two_gloo_processes(tmp_path):
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    env.update(WORLD_SIZE="2", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()))
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _GLOO_SCRIPT, REPO],
            env=dict(env, RANK=str(rank)), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, cwd=str(tmp_path),
        )
        for rank in (0, 1)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, out
        assert f"RESULT ({rank}, 2) gloo" in out
        assert "INITIALIZED False" in out


# -- (d) counts with block offsets ----------------------------------------------


@pytest.mark.parametrize("n", [17, 40])
def test_plain_block_counts_sum_to_full_counts(n):
    rng = np.random.default_rng(n)
    rank = np.argsort(rng.random((n, n)), axis=1).astype(np.int32)
    full = torch.from_numpy(rank)
    params = [[0, 0, 1], [3, 0, 1], [n - 2, 0, 1], [0, 5, 0], [4, n - 1, 0], [9, 2, 0],
              [n - 1, 0, 0]]
    want = ck.counts_many_plain(full, params)
    for k, (s, c, flag) in enumerate(params):
        host = (jax_bp._host_growing_counts(rank, s) if flag
                else jax_bp._host_fixed_counts(rank, s, c))
        np.testing.assert_array_equal(want[k].numpy(), host)
    for d, m in [(1, 1), (2, 1), (1, 3), (4, 2), (3, 3), (5, 4)]:
        t = pm.pad_to_multiple(n, np.lcm(d, m))
        mesh = pm.make_mesh((d, m), [CPU] * (d * m))
        blocks = pm.place_blocks(mesh, [full], t, t, fill=-1)
        got = ck.counts_many_blocks(blocks, params, CPU)[:, :n]
        assert got.dtype == torch.int32
        assert torch.equal(got, want), (d, m)
        # and block by block, by hand: the model-axis partials add up
        rb, cb = t // d, t // m
        by_hand = torch.cat([
            sum(ck.counts_many(blocks[i][j], params, row0=i * rb, col0=j * cb) for j in range(m))
            for i in range(d)
        ], dim=1)[:, :n]
        assert torch.equal(by_hand, want), (d, m)
    with pytest.raises(ValueError, match="offsets"):
        ck.counts_many(full, params, row0=-1)


# -- (e) RankCounts on a mesh ----------------------------------------------------


def _symmetric_rank(n, seed):
    rng = np.random.default_rng(seed)
    m = rng.random((n, n))
    m = np.triu(m, 1) + np.triu(m, 1).T + np.diag(rng.random(n))
    return np.ascontiguousarray(oracle.rank_matrix_desc(m))


@pytest.mark.parametrize("shape,n", [((8, 1), 45), ((4, 2), 37)])
def test_mesh_rank_counts_equal_local_and_jax_mesh(shape, n):
    jmesh, mesh = _meshes(shape)
    rank = _symmetric_rank(n, 7 if n == 45 else 9)
    local = bp.RankCounts(rank, CPU)
    jax_sharded = jax_bp.RankCounts(rank, mesh=jmesh)
    ours = state.rank_counts_from_numpy(np.asarray(jax_sharded._dev), n, CPU, mesh=mesh)
    assert local.where == "host" and ours.where == f"mesh {shape[0]}x{shape[1]} cpu"
    assert len(ours._blocks) == shape[0] and len(ours._blocks[0]) == shape[1]
    for start in (0, 3, 17):
        want = ours.growing(start)
        np.testing.assert_array_equal(want, local.growing(start))
        np.testing.assert_array_equal(want, jax_sharded.growing(start))
    for start, cut in ((0, 10), (5, 30), (17, n - 1)):
        want = ours.fixed(start, cut)
        np.testing.assert_array_equal(want, local.fixed(start, cut))
        np.testing.assert_array_equal(want, jax_sharded.fixed(start, cut))
    fresh = bp.RankCounts(rank, CPU, mesh=mesh)
    fresh.prefetch_fixed(2, [8, 21, n - 5])
    fresh.prefetch_growing([0, 4, 9])
    jax_fresh = jax_bp.RankCounts(rank, mesh=jmesh)
    jax_fresh.prefetch_fixed(2, [8, 21, n - 5])
    for cut in (8, 21, n - 5):
        np.testing.assert_array_equal(fresh.fixed(2, cut), local.fixed(2, cut))
        np.testing.assert_array_equal(fresh.fixed(2, cut), jax_fresh.fixed(2, cut))
    for start in (0, 4, 9):
        np.testing.assert_array_equal(fresh.growing(start), local.growing(start))


def test_mesh_rank_counts_from_row_pieces(monkeypatch):
    """Device mode hands RankCounts its per-block ranks as row pieces; they
    are re-blocked where they lie and count as the whole matrix does, on a
    mesh, as one block, and on the host."""
    n = 29
    rank = _symmetric_rank(n, 3)
    mesh = pm.make_mesh((2, 2), [CPU] * 4)
    pieces = [torch.from_numpy(rank[a:b]) for a, b in ((0, 8), (8, 16), (16, 24), (24, n))]
    ours = bp.RankCounts(pieces, CPU, mesh=mesh)
    host = bp.RankCounts(pieces, CPU)
    local = bp.RankCounts(rank, CPU)
    monkeypatch.setattr(bp, "_HOST_N", 0)
    one_block = bp.RankCounts(pieces, CPU)
    assert (ours.where, host.where, local.where, one_block.where) == (
        "mesh 2x2 cpu", "host", "host", "cpu"
    )
    for counts in (ours, host, one_block):
        for start in (0, 6):
            np.testing.assert_array_equal(counts.growing(start), local.growing(start))
        np.testing.assert_array_equal(counts.fixed(3, 20), local.fixed(3, 20))


# -- (f) the scorer on a mesh ------------------------------------------------------


def _problem(seed, sizes):
    rng = np.random.default_rng(seed)
    C = sum(sizes)
    m = rng.random((C, C))
    m = np.triu(m, 1)
    return m + m.T + np.diag(rng.random(C)), list(sizes)


def _scorers(shape, seed, sizes):
    """(port local, port mesh carried from the JAX mesh scorer, JAX mesh),
    all f64."""
    jmesh, mesh = _meshes(shape)
    m, sizes = _problem(seed, sizes)
    theirs = jax_cost.ChromosomeScorer(m, sizes, dtype=np.float64, mesh=jmesh)
    arrays = {k: np.asarray(getattr(theirs, k)) for k in (
        "_h", "_sizes_d", "sizes", "_sub", "intra_profile", "intra_total", "cross_total")}
    arrays.update({k: getattr(theirs, k) for k in ("Sp", "cmax", "L", "C_pad")})
    ours = state.chromosome_scorer_from_numpy(arrays, CPU, mesh=mesh)
    local = cost.ChromosomeScorer(m, sizes, CPU, dtype=np.float64)
    return local, ours, theirs


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=F64_RTOL, atol=0)


@pytest.mark.parametrize("shape", SHAPES)
def test_mesh_block_and_combo_scores(shape):
    local, ours, theirs = (s.full() for s in _scorers(shape, 0, (5, 4, 3, 2)))
    orders, orients = perms.order_batch(4), perms.orient_batch(4)
    dense = ours.score_batch(orders, orients)
    _close(dense, local.score_batch(orders, orients))
    _close(dense, theirs.score_batch(orders, orients))
    # combo top-k: 12 orders pad to 16 rows on the (8, 1) mesh
    idx, vals, floor = ours.score_batch_topk(orders, orients, k=16)
    idx_j, vals_j, floor_j = theirs.score_batch_topk(orders, orients, k=16)
    np.testing.assert_array_equal(idx, idx_j)
    _close(vals, vals_j)
    _close(vals, dense[idx])
    assert floor == pytest.approx(floor_j, rel=F64_RTOL)
    idx_l, vals_l, _floor_l = local.score_batch_topk(orders, orients, k=16)
    assert int(idx[np.argmax(vals)]) == int(idx_l[np.argmax(vals_l)])
    if len(orders) % shape[0] == 0:  # no mesh padding: the same groups as local
        np.testing.assert_array_equal(idx, idx_l)


@pytest.mark.parametrize("shape", SHAPES)
def test_mesh_chunked_topk_scores(shape):
    """Nine scaffolds take the chunked top-k path; 21 orders in chunks of
    8 pad the tail chunk, then each chunk to the data axis."""
    local, ours, theirs = (
        s.full() for s in _scorers(shape, 4, (5, 4, 3, 3, 2, 2, 2, 1, 1))
    )
    rng = np.random.default_rng(5)
    orders = np.stack([rng.permutation(9) for _ in range(21)])
    orients = rng.integers(0, 2, (6, 9)).astype(np.int32)
    dense = ours.score_batch(orders, orients, chunk_orders=8)
    _close(dense, local.score_batch(orders, orients, chunk_orders=8))
    _close(dense, theirs.score_batch(orders, orients, chunk_orders=8))
    idx, vals, floor = ours.score_batch_topk(orders, orients, k=12, chunk_orders=8)
    idx_j, vals_j, floor_j = theirs.score_batch_topk(orders, orients, k=12, chunk_orders=8)
    np.testing.assert_array_equal(idx, idx_j)
    _close(vals, vals_j)
    _close(vals, dense[idx])
    assert floor == pytest.approx(floor_j, rel=F64_RTOL)
    idx_l, vals_l, _ = local.score_batch_topk(orders, orients, k=12, chunk_orders=8)
    assert int(idx[np.argmax(vals)]) == int(idx_l[np.argmax(vals_l)])
    if 8 % shape[0] == 0:
        np.testing.assert_array_equal(idx, idx_l)


@pytest.mark.parametrize("shape", SHAPES)
def test_mesh_topk_groups_straddle_blocks(shape):
    """Groups that start in one data-axis block and end in the next (the
    combo path at k = 7: G = 37 or 28 candidates against blocks of 32 or 48;
    the chunked path at k = 5: G = 10 against blocks of 6 or 12): the folded
    partial triples give the JAX mesh scorer's selection."""
    local, ours, theirs = (s.full() for s in _scorers(shape, 2, (5, 4, 3, 2)))
    orders, orients = perms.order_batch(4), perms.orient_batch(4)
    idx, vals, floor = ours.score_batch_topk(orders, orients, k=7)
    idx_j, vals_j, floor_j = theirs.score_batch_topk(orders, orients, k=7)
    np.testing.assert_array_equal(idx, idx_j)
    _close(vals, vals_j)
    _close(vals, ours.score_batch(orders, orients)[idx])
    assert floor == pytest.approx(floor_j, rel=F64_RTOL)
    nine = [s.full() for s in _scorers(shape, 4, (5, 4, 3, 3, 2, 2, 2, 1, 1))]
    rng = np.random.default_rng(6)
    orders9 = np.stack([rng.permutation(9) for _ in range(13)])
    orients9 = rng.integers(0, 2, (6, 9)).astype(np.int32)
    idx, vals, floor = nine[1].score_batch_topk(orders9, orients9, k=5, chunk_orders=8)
    idx_j, vals_j, floor_j = nine[2].score_batch_topk(orders9, orients9, k=5, chunk_orders=8)
    np.testing.assert_array_equal(idx, idx_j)
    _close(vals, vals_j)
    assert floor == pytest.approx(floor_j, rel=F64_RTOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_mesh_pair_scores_batch_of_13(shape):
    local, ours, theirs = _scorers(shape, 1, (5, 4, 3, 2))
    rng = np.random.default_rng(2)
    orders = np.stack([rng.permutation(4) for _ in range(13)]).astype(np.int32)
    orients = rng.integers(0, 2, orders.shape).astype(np.int32)
    got = ours.full().score_pairs(orders, orients)
    assert got.shape == (13,)
    _close(got, local.full().score_pairs(orders, orients))
    _close(got, theirs.full().score_pairs(orders, orients))


# -- (g) a chromosome's search on a mesh --------------------------------------------


@pytest.mark.parametrize("shape", SHAPES)
def test_order_chromosome_on_mesh(shape):
    jmesh, mesh = _meshes(shape)
    g = fixtures.make_genome(
        chrom_scaffold_bins=((8, 6, 4, 3),), seed=23, noise=0.002, cross_noise_frac=0.0
    )
    bins = [hicpro.Bin(bid, s.name, 0, 0, 1.0, 0.0) for s in g.scaffolds for bid in s.bin_ids]
    group = []
    for name in g.true_groups()[0]:
        group.extend([bid, name] for bid in g.scaffold(name).bin_ids)

    def names(rec):
        return [(s.name, s.orientation) for s in rec]

    ctx_mesh = part2_order._ChromosomeContext(g.matrix, bins, CPU, mesh=mesh)
    sub = ctx_mesh.gather_device([b for b, _ in group])
    np.testing.assert_array_equal(
        sub.numpy(), ctx_mesh.gather([b for b, _ in group]).astype(np.float32)
    )
    got = names(part2_order.order_chromosome(group, ctx_mesh, 3, 3))
    local = names(part2_order.order_chromosome(
        group, part2_order._ChromosomeContext(g.matrix, bins, CPU), 3, 3))
    theirs = names(jax_part2.order_chromosome(
        group, jax_part2._ChromosomeContext(g.matrix, bins, mesh=jmesh), 3, 3))
    assert got == local == theirs


# -- (h) the fused step ---------------------------------------------------------------


@pytest.mark.parametrize("shape", SHAPES)
def test_fused_step_equals_jax(shape):
    jmesh, mesh = _meshes(shape)
    j_dist, j_counts, j_costs, j_best = jax_step.make_fused_step(jmesh)(
        *jax_step.example_inputs(jmesh)
    )
    inputs = pipeline_step.example_inputs(mesh)
    before = ck.LAUNCHES
    dist, counts, costs, best = pipeline_step.make_fused_step(mesh)(*inputs)
    assert ck.LAUNCHES == before  # CPU blocks: the plain counts, no launch
    assert len(dist) == shape[0] and len(dist[0]) == shape[1]
    dist = np.block([[b.numpy() for b in row] for row in dist])
    np.testing.assert_array_equal(counts.numpy(), np.asarray(j_counts))
    assert int(best) == int(j_best)
    np.testing.assert_allclose(dist, np.asarray(j_dist), rtol=STEP_RTOL)
    np.testing.assert_allclose(costs.numpy(), np.asarray(j_costs), rtol=STEP_RTOL)
    assert dist.dtype == costs.numpy().dtype == np.float32
