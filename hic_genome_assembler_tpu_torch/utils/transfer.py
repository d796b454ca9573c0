"""Copies between the host and the card, through pinned memory.

Counterpart of the JAX package's asynchronous copies in part 2
(``models/part2_order.py``: ``_host_async``, which starts every handle's
device-to-host copy as soon as a search coroutine yields it, and one
``jax.device_get`` that drains a scheduler pass).  Part 2 moves data
between the host and a card only through this module.

* Uploads (:func:`to_device`, :func:`copy_into`) stage a host array in
  pinned memory from torch's caching host allocator and copy it with
  ``non_blocking=True``: the host does not wait for the kernels queued
  before the copy, as a pageable copy of more than a few kilobytes does.
  The allocator records an event on each copy and reuses the block only
  once it has passed, so the caller may drop the source at once.  Large
  arrays go up in chunks of :data:`CHUNK_BYTES`, so no pinned block grows
  with the genome.
* Readback (:func:`start_readback`, :func:`finish_readback`) copies each
  CUDA handle into a fresh pinned host tensor without waiting and records
  one event per device and stream; the finish waits on every readback's
  events (one that has passed returns at once), and returns numpy views of
  the pinned tensors (a view keeps its tensor, and so its block, alive).

CPU tensors are never pinned and wait for nothing: ``-device cpu`` stays a
pure host run.  A failure to pin or to record an event raises.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

ArrayLike = Union[np.ndarray, torch.Tensor]

# the largest pinned staging block of one upload
CHUNK_BYTES = 16 << 20


def _pinned(shape, dtype: torch.dtype) -> torch.Tensor:
    """An empty pinned host tensor from torch's caching host allocator."""
    return torch.empty(shape, dtype=dtype, pin_memory=True)


def torch_dtype(dtype) -> torch.dtype:
    """The torch type of a numpy ``dtype``."""
    return torch.from_numpy(np.empty(0, dtype)).dtype


def _host_tensor(a: ArrayLike, dtype=None) -> torch.Tensor:
    """A contiguous host tensor of ``a``, cast to the numpy ``dtype`` where
    given, a host tensor as an array is."""
    if isinstance(a, torch.Tensor):
        if a.device.type != "cpu":
            raise ValueError(f"expected a host array, got a tensor on {a.device}")
        return (a if dtype is None else a.to(torch_dtype(dtype))).contiguous()
    return torch.from_numpy(np.require(a, dtype, ["C", "W"]))


def copy_into(dst: torch.Tensor, src: ArrayLike) -> torch.Tensor:
    """Copies ``src`` into ``dst`` and returns ``dst``.  A host ``src`` and a
    CUDA ``dst`` go through pinned chunks of at most :data:`CHUNK_BYTES`,
    cast to ``dst``'s type on the host (a cast on the card's side of the
    copy would stage it in pageable memory), without waiting for the
    stream; any other pair is ``dst.copy_(src)``."""
    if isinstance(src, np.ndarray):
        src = _host_tensor(src)
    if dst.device.type != "cuda" or src.device.type != "cpu":
        return dst.copy_(src)
    if src.dim() == 0:
        chunks = [(dst, src)]
    else:
        row_bytes = max(src[:1].numel() * src.element_size(), 1)
        step = max(1, CHUNK_BYTES // row_bytes)
        chunks = [(dst[r : r + step], src[r : r + step]) for r in range(0, src.shape[0], step)]
    with torch.cuda.device(dst.device):
        for d, s in chunks:
            staged = _pinned(s.shape, d.dtype)
            staged.copy_(s)
            d.copy_(staged, non_blocking=True)
    return dst


def to_device(a: ArrayLike, device, dtype=None) -> torch.Tensor:
    """A host array on ``device`` (cast to the numpy ``dtype`` where given):
    a new tensor uploaded through pinned memory for a CUDA device; for the
    CPU the host tensor as it stands (sharing the array's memory)."""
    t = _host_tensor(a, dtype)
    device = torch.device(device)
    if device.type != "cuda":
        return t.to(device)
    if t.nbytes <= CHUNK_BYTES:  # one staging block: the fewest host calls
        return t.pin_memory().to(device, non_blocking=True)
    return copy_into(torch.empty(t.shape, dtype=t.dtype, device=device), t)


class Readback:
    """Device-to-host copies in flight: the host tensors they write (a CPU
    handle as it stands) and one event per (device, stream) they ran on."""

    __slots__ = ("host", "events")

    def __init__(self, host: List[torch.Tensor], events: Dict[Tuple[int, int], object]):
        self.host = host
        self.events = events


def start_readback(
    handles: Sequence[torch.Tensor], into: Optional[Sequence[torch.Tensor]] = None
) -> Readback:
    """Starts copying each handle to the host without waiting: a CUDA handle
    into a fresh pinned tensor (or into its host view in ``into``, which
    must then be pinned) on its device's current stream, after which one
    event is recorded per device and stream; a CPU handle is kept as it
    stands (or copied into its view in ``into``)."""
    host: List[torch.Tensor] = []
    streams = {}
    for k, h in enumerate(handles):
        dst = None if into is None else into[k]
        if h.device.type != "cuda":
            host.append(h if dst is None else dst.copy_(h))
            continue
        if dst is None:
            dst = _pinned(h.shape, h.dtype)
        with torch.cuda.device(h.device):
            dst.copy_(h, non_blocking=True)
            stream = torch.cuda.current_stream(h.device)
        streams[(h.device.index, stream.cuda_stream)] = stream
        host.append(dst)
    return Readback(host, {key: s.record_event() for key, s in streams.items()})


def finish_readback(readbacks: Sequence[Readback]) -> List[List[np.ndarray]]:
    """Waits for every event of the readbacks (an event already passed
    returns at once, so a pass costs about one wait per device and stream),
    and returns each readback's numpy arrays."""
    for event in {id(e): e for r in readbacks for e in r.events.values()}.values():
        event.synchronize()
    return [[t.numpy() for t in r.host] for r in readbacks]


def to_host(handles: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """The numpy copies of ``handles``: one readback, started and finished."""
    return finish_readback([start_readback(handles)])[0]
