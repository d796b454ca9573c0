"""Device meshes and block placement.

Counterpart of ``hic_genome_assembler_tpu/parallel/mesh.py``.  The JAX
package places one array over many devices with a ``NamedSharding`` and
lets XLA insert the collectives.  The port keeps its model, one process
driving its local devices, in plain PyTorch:

* a :class:`Mesh` is a ``(data, model)`` array of ``torch.device``;
* the ``put_*`` helpers split a tensor into per-device blocks and return
  them as lists.  They take the place of the JAX ``*_sharding`` functions,
  which have no torch object to return;
* every reduction or gather across devices is an explicit ``.to(device)``
  followed by a sum or ``torch.cat`` in the caller's code;
* a host array goes up to a card through pinned memory without waiting
  (``utils/transfer``).

There is no NCCL, ``DTensor`` or ``DeviceMesh`` here.  A device may appear
more than once in a mesh: that is a *virtual* mesh, the counterpart of the
JAX tests' virtual CPU devices, and it runs every split, pad and reduction
on one card.  ``.to(device)`` onto the device a tensor already lies on
returns the same tensor, so replicas may alias: callers never write in
place into a tensor these helpers or a replication returned.  The blocks
themselves are always copies.

Axes: ``data`` carries batches of candidate permutations and row blocks of
the contact matrix; ``model`` carries its column blocks.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from hic_genome_assembler_tpu_torch.utils import transfer

DATA_AXIS = "data"
MODEL_AXIS = "model"

ArrayLike = Union[np.ndarray, torch.Tensor]


class Mesh:
    """A 2-D ``(data, model)`` grid of torch devices.

    ``devices`` is a numpy object array of shape ``(data, model)``;
    ``shape[DATA_AXIS]`` and ``shape[MODEL_AXIS]`` read as on a JAX mesh."""

    axis_names = (DATA_AXIS, MODEL_AXIS)

    def __init__(self, devices: np.ndarray):
        if devices.ndim != 2 or devices.size == 0:
            raise ValueError(f"mesh devices must be a non-empty 2-D array, got {devices.shape}")
        self.devices = devices

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def first(self) -> torch.device:
        """Where gathered results land: the device at position (0, 0)."""
        return self.devices[0, 0]

    @property
    def data_devices(self) -> List[torch.device]:
        """One device per data-axis position (model position 0)."""
        return list(self.devices[:, 0])

    def describe(self) -> str:
        """``"mesh 2x2 cuda:0"``: the shape and the distinct devices."""
        distinct = list(dict.fromkeys(str(d) for d in self.devices.ravel()))
        d, m = self.devices.shape
        return f"mesh {d}x{m} {','.join(distinct)}"

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.ravel()]})"


def visible_devices() -> List[torch.device]:
    """Every visible CUDA device, or the CPU when there is none."""
    if torch.cuda.is_available():
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def make_mesh(
    shape: Optional[Tuple[int, int]] = None,
    devices: Optional[Sequence[torch.device]] = None,
) -> Mesh:
    """A ``(data, model)`` mesh over ``devices`` (default: every visible
    device).  The default shape puts every device on the data axis.  A
    device may repeat (a virtual mesh)."""
    devices = [torch.device(d) for d in (visible_devices() if devices is None else devices)]
    if shape is None:
        shape = (len(devices), 1)
    if int(np.prod(shape)) != len(devices):
        raise ValueError(f"mesh shape {shape} != {len(devices)} devices")
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(shape))


def pad_to_multiple(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def _as_tensor(x: ArrayLike) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.ascontiguousarray(x))


def _split_rows(t: torch.Tensor, devices: Sequence[torch.device]) -> List[torch.Tensor]:
    per = t.shape[0] // len(devices)
    blocks = []
    for k, dev in enumerate(devices):
        rows = t[k * per : (k + 1) * per]
        blocks.append(transfer.copy_into(torch.empty_like(rows, device=dev), rows))
    return blocks


def put_rows_padded(mesh: Mesh, matrix: ArrayLike) -> Tuple[List[torch.Tensor], int]:
    """Zero-pad the row axis to divide the full device count and split the
    rows over every mesh position, in row-major (data, model) order.
    Returns (blocks, original_n); pad rows give garbage in row-wise
    transforms, which callers slice off."""
    t = _as_tensor(matrix)
    n = t.shape[0]
    rows = pad_to_multiple(n, mesh.size)
    if rows != n:
        t = torch.cat([t, t.new_zeros((rows - n,) + tuple(t.shape[1:]))])
    return _split_rows(t, list(mesh.devices.ravel())), n


def put_vector_padded(mesh: Mesh, vec: ArrayLike) -> Tuple[List[torch.Tensor], int]:
    """Companion to :func:`put_rows_padded` for per-row vectors: the same
    pad and the same split."""
    return put_rows_padded(mesh, vec)


def place_blocks(
    mesh: Mesh,
    pieces: Sequence[torch.Tensor],
    rows: int,
    cols: int,
    fill=0,
    dtype: Optional[torch.dtype] = None,
) -> List[List[torch.Tensor]]:
    """``(data, model)`` blocks of a ``rows x cols`` matrix whose top-left
    part is the row-wise concatenation of ``pieces`` (consecutive row
    pieces of equal width, each on any device) and whose other entries are
    ``fill``.  ``rows`` must divide the data axis and ``cols`` the model
    axis.  Block ``[i][j]`` lies on ``mesh.devices[i, j]``; each block is
    copied straight from the pieces onto its device, cast to ``dtype``
    (default: the pieces' own)."""
    d, m = mesh.devices.shape
    if rows % d or cols % m:
        raise ValueError(f"{rows}x{cols} does not divide the {d}x{m} mesh")
    rb, cb = rows // d, cols // m
    width = int(pieces[0].shape[1])
    dtype = pieces[0].dtype if dtype is None else dtype
    offsets = np.concatenate([[0], np.cumsum([int(p.shape[0]) for p in pieces])])
    if offsets[-1] > rows or width > cols:
        raise ValueError(f"{int(offsets[-1])}x{width} matrix exceeds {rows}x{cols}")
    blocks: List[List[torch.Tensor]] = []
    for i in range(d):
        r0, r1 = i * rb, (i + 1) * rb
        row_blocks = []
        for j in range(m):
            dev = mesh.devices[i, j]
            c0, c1 = j * cb, min((j + 1) * cb, width)
            blk = torch.full((rb, cb), fill, dtype=dtype, device=dev)
            for p, lo, hi in zip(pieces, offsets[:-1], offsets[1:]):
                a, b = max(r0, lo), min(r1, hi)
                if a < b and c0 < c1:
                    transfer.copy_into(blk[a - r0 : b - r0, : c1 - c0], p[a - lo : b - lo, c0:c1])
            row_blocks.append(blk)
        blocks.append(row_blocks)
    return blocks


def put_matrix_padded(mesh: Mesh, matrix: ArrayLike) -> Tuple[List[List[torch.Tensor]], int]:
    """Zero-pad an N x N matrix so that its rows divide the data axis and
    its columns the model axis, and place it as ``(data, model)`` blocks.
    Returns (blocks, original_n); callers slice results back to ``n``."""
    t = _as_tensor(matrix)
    n = t.shape[0]
    rows = pad_to_multiple(n, mesh.shape[DATA_AXIS])
    cols = pad_to_multiple(n, mesh.shape[MODEL_AXIS])
    return place_blocks(mesh, [t], rows, cols), n


def put_batch_padded(mesh: Mesh, batch: ArrayLike) -> Tuple[List[torch.Tensor], int]:
    """Pad a batch's leading axis to divide the data axis, repeating its
    last element so that padded work is valid and only redundant, and
    split it over the data-axis devices.  Returns (blocks, original_b)."""
    t = _as_tensor(batch)
    b = t.shape[0]
    target = pad_to_multiple(max(b, 1), mesh.shape[DATA_AXIS])
    if b and target != b:
        t = torch.cat([t, t[-1:].expand((target - b,) + tuple(t.shape[1:]))])
    return _split_rows(t, mesh.data_devices), b


def gather(parts: Sequence[torch.Tensor], device: torch.device, dim: int = 0) -> torch.Tensor:
    """Concatenate per-device results on ``device``."""
    return torch.cat([p.to(device) for p in parts], dim=dim)
