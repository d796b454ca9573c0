"""The fused multi-device pipeline step.

Counterpart of ``hic_genome_assembler_tpu/parallel/pipeline_step.py``,
the JAX package's one-jit composition proof: every dense stage of the
engine over a ``(data, model)`` mesh, with the reductions that XLA
inserted there written out here.

* the N x N contact matrix in ``(data, model)`` blocks; the distance and
  similarity row transforms run on the blocks, with each row's sum reduced
  across the model axis;
* the growing-window counts of the rank matrix at start 0, through the
  rank-count kernel on each block with its offsets (``(cols < rows) &
  (rank >= 0) & (rank <= rows)`` is exactly its growing scan at
  ``start = 0``), partials summed across the model axis;
* the candidate bin orders split over the data axis; each data position
  gathers the whole similarity matrix, scores its orders against the
  replicated weights, and the argmax is taken over the gathered costs.

The pipeline itself composes the same pieces stage by stage; this module
is not a third path of it.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import numpy as np
import torch

from hic_genome_assembler_tpu_torch.ops import count_kernels
from hic_genome_assembler_tpu_torch.parallel import mesh as pm

Blocks = List[List[torch.Tensor]]


def make_fused_step(mesh: pm.Mesh) -> Callable:
    """The step over the blocks that :func:`example_inputs` returns:
    ``step(matrix, row_sums, rank_mat, bin_orders, w2) -> (dist, counts,
    costs, best)``, with ``dist`` as ``(data, model)`` blocks and the rest
    on the mesh's first device."""
    first = mesh.first

    def step(matrix: Blocks, row_sums: List[torch.Tensor], rank_mat: Blocks,
             bin_orders: List[torch.Tensor], w2: List[torch.Tensor]):
        dist: Blocks = []
        sim_rows: List[List[torch.Tensor]] = []
        for i, row_blocks in enumerate(matrix):
            home = row_blocks[0].device
            total = sum(blk.sum(dim=1).to(home) for blk in row_blocks)
            dist_row, sim_row = [], []
            for blk in row_blocks:
                d = (1.0 - blk / total.to(blk.device)[:, None]) + 1.0
                dist_row.append(d)
                sim_row.append(row_sums[i].to(blk.device)[:, None] * (1.0 - (d - 1.0)))
            dist.append(dist_row)
            sim_rows.append(sim_row)
        counts = count_kernels.counts_many_blocks(rank_mat, [[0, 0, 1]], first)[0]
        costs = []
        for i, orders in enumerate(bin_orders):
            dev = orders.device
            sim = torch.cat([torch.cat([b.to(dev) for b in row], dim=1) for row in sim_rows])
            gathered = sim[orders[:, :, None], orders[:, None, :]]
            costs.append(0.5 * torch.einsum("bij,ij->b", gathered, w2[i]))
        costs = pm.gather(costs, first)
        return dist, counts, costs, torch.argmax(costs)

    return step


def example_inputs(mesh: pm.Mesh, n: int = 64, batch: int = 16, seed: int = 0) -> Tuple:
    """Small mesh-divisible inputs, drawn as the JAX package's
    ``example_inputs`` draws them: (matrix blocks, row-sum blocks over the
    data axis, rank blocks, order blocks over the data axis, one replica
    of the weights per data position)."""
    rng = np.random.default_rng(seed)
    d = mesh.shape[pm.DATA_AXIS]
    m_ax = mesh.shape[pm.MODEL_AXIS]
    n = pm.pad_to_multiple(pm.pad_to_multiple(n, d), m_ax)
    batch = pm.pad_to_multiple(batch, d)
    m = rng.random((n, n))
    m = (m + m.T).astype(np.float32) + np.eye(n, dtype=np.float32)
    row_sums = m.sum(axis=1)
    rank_mat = np.argsort(-m, axis=1).astype(np.int32)
    orders = np.stack([rng.permutation(n) for _ in range(batch)]).astype(np.int64)
    idx = np.abs(np.subtract.outer(np.arange(n), np.arange(n)))
    w = np.zeros(n)
    w[1:] = 1.0 / np.arange(1, n)
    w2 = torch.from_numpy(w[idx].astype(np.float32))
    return (
        pm.put_matrix_padded(mesh, m)[0],
        pm.put_batch_padded(mesh, row_sums)[0],
        pm.put_matrix_padded(mesh, rank_mat)[0],
        pm.put_batch_padded(mesh, orders)[0],
        [w2.to(dev, copy=True) for dev in mesh.data_devices],
    )
