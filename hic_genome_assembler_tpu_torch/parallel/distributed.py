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

The shard helpers are copies of the JAX module's, so shards written by
either package carry the same fingerprint and the same bytes.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

from hic_genome_assembler_tpu_torch.io import filebus


def init_distributed() -> Tuple[int, int]:
    """Join the process group when ``WORLD_SIZE`` > 1; return
    ``(process_index, process_count)``.  A single process returns
    ``(0, 1)`` and creates no group.

    A rank can leave ``init_process_group`` while a peer is still finishing
    gloo's full-mesh handshake; had it shut down at once, the peer's connect
    would fail ("Connection closed by peer").  The barrier returns only when
    every rank's connections are up."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return 0, 1
    import torch.distributed as dist

    if not dist.is_initialized():
        dist.init_process_group(
            "gloo", init_method="env://", rank=int(os.environ["RANK"]), world_size=world
        )
        dist.barrier()
    return dist.get_rank(), dist.get_world_size()


def shutdown() -> None:
    """Destroy the process group if this process joined one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def shard_chromosomes(
    n_chroms: int, process_index: int, process_count: int
) -> List[int]:
    """Round-robin chromosome ownership.

    Chromosome groups are size-ordered (largest first,
    writeChromosomeGroupingsToFile semantics), so round-robin balances
    the heavy early chromosomes across hosts better than contiguous
    blocks.
    """
    if process_count <= 1:
        return list(range(n_chroms))
    return [c for c in range(n_chroms) if c % process_count == process_index]


def run_fingerprint(
    chromosome_group_file: str, *params, data_files: Sequence[str] = ()
) -> str:
    """Content fingerprint binding a part-2 EP run to its inputs.

    sha256 over the chromosome-group file BYTES, the BYTES of every
    ``data_files`` entry (the Hi-C contact inputs — bed/bias/matrix —
    that shard contents also depend on), plus every search parameter:
    two runs share a fingerprint only when they would produce
    byte-identical shards (the pipeline is deterministic), so the shard
    barrier can accept a fingerprint-matched shard from disk regardless
    of WHEN it was written — a leftover from a previous run with
    identical inputs is a benign memoization, and any other leftover is
    ignored (no mtime/clock heuristics).  Omitting the contact data
    from the hash would let a stale shard computed from DIFFERENT
    matrix data (same group file + params) pass the barrier silently.
    """
    import hashlib

    h = hashlib.sha256()
    with open(chromosome_group_file, "rb") as fh:
        h.update(fh.read())
    for path in data_files:
        h.update(b"\x00file\x00")
        with open(path, "rb") as fh:
            for chunk in iter(lambda: fh.read(1 << 22), b""):
                h.update(chunk)
    h.update(repr(params).encode())
    return h.hexdigest()[:32]


def shard_fingerprint(path: str) -> Optional[str]:
    """The ``#run <fp>`` header of a shard file, or None."""
    try:
        with open(path) as fh:
            first = fh.readline().strip()
    except OSError:
        return None
    if first.startswith("#run "):
        return first.split(" ", 1)[1]
    return None


def merge_shard_orderings(
    shard_files: Sequence[str],
    n_chroms: int,
    out_path: str,
    fingerprint: Optional[str] = None,
) -> None:
    """Merge per-process partial order files into the canonical
    chromosome order file.

    Each shard file holds only its owner's chromosomes but keeps their
    GLOBAL ``### Chromosome i ###`` numbering, so the merge is a simple
    renumber-free interleave; every chromosome must appear exactly once
    across the shards.  With ``fingerprint``, every shard must carry the
    matching ``#run`` header (see :func:`run_fingerprint`).
    """
    merged: Dict[int, List[Tuple[str, str]]] = {}
    for path in shard_files:
        if fingerprint is not None and shard_fingerprint(path) != fingerprint:
            raise ValueError(
                f"shard {path} carries a different run fingerprint "
                f"({shard_fingerprint(path)!r} != {fingerprint!r})"
            )
        for global_idx, rows in _read_shard(path).items():
            if global_idx in merged:
                raise ValueError(
                    f"chromosome {global_idx} appears in multiple shards"
                )
            merged[global_idx] = rows
    missing = sorted(set(range(1, n_chroms + 1)) - set(merged))
    if missing:
        raise ValueError(f"shards missing chromosomes {missing}")
    filebus.write_scaffold_orderings(
        [merged[i] for i in sorted(merged)], out_path
    )


def write_shard_orderings(
    orderings: Dict[int, List[Tuple[str, str]]],
    out_path: str,
    fingerprint: Optional[str] = None,
) -> None:
    """Write one process's chromosomes ({global 1-based idx: [(name,
    orient), ...]}) preserving global numbering.

    Atomic (tmp + rename): shard files double as the inter-process
    barrier, so a reader polling for existence must never see a partial
    write."""
    tmp = out_path + ".tmp"
    with open(tmp, "w") as fh:
        if fingerprint is not None:
            fh.write(f"#run {fingerprint}\n")
        for idx in sorted(orderings):
            fh.write(f"### Chromosome grouping {idx} ###\n")
            for name, orientation in orderings[idx]:
                fh.write(f"{name}\t{orientation}\n")
    os.replace(tmp, out_path)


def _read_shard(path: str) -> Dict[int, List[Tuple[str, str]]]:
    out: Dict[int, List[Tuple[str, str]]] = {}
    current: Optional[int] = None
    with open(path) as fh:
        for line in fh:
            line = line.rstrip("\n")
            if not line:
                continue
            if line.startswith("#run "):
                continue
            if line.startswith("###"):
                current = int(line.split()[3])
                out[current] = []
            else:
                name, orientation = line.split("\t")
                out[current].append((name, orientation))
    return out
