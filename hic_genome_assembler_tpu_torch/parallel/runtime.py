"""Mesh and multi-process bring-up for the CLI pipeline.

Counterpart of ``hic_genome_assembler_tpu/parallel/runtime.py``: the one
place where a run acquires its parallel substrate, selected by the CLI's
``-mesh`` flag, then ``$HIC_MESH``, then ``auto``:

    auto   a mesh over every visible card when there is more than one,
           else none (always none on the CPU)
    off    never build a mesh (single-device semantics)
    RxC    an explicit (data, model) mesh over the first R*C visible
           cards, e.g. ``2x2``; an error when fewer are visible.  On the
           CPU, R*C virtual positions of the one CPU device

A multi-process run (``WORLD_SIZE`` > 1, see ``distributed``) splits each
host's cards among the processes on it (:func:`own_cards`): a process owns
a slice of them, at least one card, and its device and its mesh lie on its
own cards only.  That is the JAX package's per-process mesh over
``jax.local_devices()``, with the chromosome sharding across processes
outside it.

The JAX module's persistent XLA compile cache has no counterpart: the
port's kernels are compiled once by ``ops/_build.py`` and cached by the
hash of their sources.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional

import torch

from hic_genome_assembler_tpu_torch import device as device_mod
from hic_genome_assembler_tpu_torch.parallel import distributed
from hic_genome_assembler_tpu_torch.parallel import mesh as pm


@dataclass
class RuntimeContext:
    """What a pipeline part needs to know about the parallel substrate."""

    mesh: Optional[pm.Mesh]
    process_index: int
    process_count: int
    device: torch.device

    @property
    def is_primary(self) -> bool:
        return self.process_index == 0


def resolve_mesh_spec(mesh_spec: Optional[str] = None) -> str:
    if mesh_spec:
        return mesh_spec
    return os.environ.get("HIC_MESH", "auto")


def _parse_spec(spec: str):
    try:
        rows, cols = (int(x) for x in spec.lower().split("x"))
    except ValueError:
        raise ValueError(f"mesh spec {spec!r} is not 'auto', 'off' or 'RxC'") from None
    if rows < 1 or cols < 1:
        raise ValueError(f"mesh spec {spec!r} is not 'auto', 'off' or 'RxC'")
    return rows, cols


def own_cards(
    cards: List[torch.device], local_rank: int, local_world_size: int
) -> List[torch.device]:
    """The cards of process ``local_rank`` of ``local_world_size`` on one
    host: an equal contiguous slice of ``cards`` when there are at least as
    many cards as processes, else the one card ``local_rank mod len(cards)``
    (processes then share cards)."""
    if local_world_size >= len(cards):
        return [cards[local_rank % len(cards)]]
    per = len(cards) // local_world_size
    return cards[local_rank * per : (local_rank + 1) * per]


def bring_up(mesh_spec: Optional[str] = None, device_name: str = "cuda") -> RuntimeContext:
    """Resolve the device, join the process group when configured through
    the environment, and build the mesh that ``mesh_spec`` names (see the
    module docstring).  ``device_name`` ``cuda`` without a card raises.

    Under several processes, ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE`` (set
    by ``torchrun``) place this process among those of its host; without
    them every process is taken to share the host (``RANK`` of
    ``WORLD_SIZE``)."""
    spec = resolve_mesh_spec(mesh_spec)
    if spec not in ("auto", "off"):
        rows, cols = _parse_spec(spec)
    device = device_mod.resolve(device_name)
    process_index, process_count = distributed.init_distributed()
    cards = pm.visible_devices() if device.type == "cuda" else [device]
    if device.type == "cuda" and process_count > 1:
        cards = own_cards(
            cards,
            int(os.environ.get("LOCAL_RANK", process_index)),
            int(os.environ.get("LOCAL_WORLD_SIZE", process_count)),
        )
        device = cards[0]
        torch.cuda.set_device(device)

    if spec == "off":
        return RuntimeContext(None, process_index, process_count, device)
    if spec == "auto":
        if device.type != "cuda" or len(cards) <= 1:
            return RuntimeContext(None, process_index, process_count, device)
        mesh = pm.make_mesh((len(cards), 1), devices=cards)
    elif device.type == "cpu":
        mesh = pm.make_mesh((rows, cols), devices=[device] * (rows * cols))
    else:
        if rows * cols > len(cards):
            raise ValueError(
                f"mesh {spec} needs {rows * cols} cards, {len(cards)} visible"
            )
        mesh = pm.make_mesh((rows, cols), devices=cards[: rows * cols])
    print(
        "- Parallel runtime: {} devices, mesh {}, process {}/{}".format(
            len(cards), mesh.shape, process_index, process_count,
        )
    )
    return RuntimeContext(mesh, process_index, process_count, device)
