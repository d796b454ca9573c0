"""Multi-process bring-up and chromosome-level task sharding (EP).

Counterpart of ``hic_genome_assembler_tpu/parallel/distributed.py``.
Chromosomes are independent, so each process of a multi-process part-2
run searches its round-robin shard of them, writes the orderings to a
shard file, and process 0 merges the shards over the file bus, which is
also the barrier.  No tensor crosses a process boundary.

``init_distributed`` reads the environment that ``torchrun`` sets
(``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``).  The process
group it creates only holds the rendezvous.  It uses the ``gloo`` backend:
no tensor collective runs, so NCCL would have nothing to carry, and NCCL
refuses two ranks on one card, which is how EP runs on a one-card machine.

The shard helpers are jax-free in the JAX module and are imported from
there, so shards written by either package carry the same fingerprint and
the same bytes.
"""

from __future__ import annotations

import os
from typing import Tuple

from hic_genome_assembler_tpu.parallel.distributed import (  # noqa: F401
    merge_shard_orderings,
    run_fingerprint,
    shard_chromosomes,
    shard_fingerprint,
    write_shard_orderings,
)


def init_distributed() -> Tuple[int, int]:
    """Join the process group when ``WORLD_SIZE`` > 1; return
    ``(process_index, process_count)``.  A single process returns
    ``(0, 1)`` and creates no group."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return 0, 1
    import torch.distributed as dist

    if not dist.is_initialized():
        dist.init_process_group(
            "gloo", init_method="env://", rank=int(os.environ["RANK"]), world_size=world
        )
    return dist.get_rank(), dist.get_world_size()


def shutdown() -> None:
    """Destroy the process group if this process joined one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
