"""Device meshes and sharded fields (counterpart of
`cfd_tpu/parallel/mesh.py:27-92`).

The reference places a (nz, ny, nx) field on a ``jax.sharding.Mesh`` with
a ``PartitionSpec``: z over the mesh axis ``'z'``, y over ``'y'``, x never
(the TPU's lane dimension).  Here a :class:`Mesh` is the same grid of
devices with a shard communicator (`parallel.comm`), a spec is a tuple of
one axis name or None per field dimension, and a placed field is a
:class:`ShardedField`: the mesh plus the local slab `FlowField`s of the
shards this process holds.

* :func:`make_mesh` — 1D or (z, y) mesh (a y-only mesh, ``axes=("y",)``,
  lays its shards out as one row, so its "y" halos find their
  neighbours); the devices default to the
  visible CUDA devices, and without one it raises, like every entry point
  of the port.  A list such as ``[cuda:0] * 4`` (or ``[cpu] * 4``) gives
  four shards emulated in one process (`comm.LocalComm`); a
  `comm.ProcessGroupComm` gives one shard per rank.
* :func:`field_spec` — which axis is split, with the reference's
  drop-to-replicated rule for dimensions a shard count does not divide.
* :func:`shard_field`, :func:`gather_field`, :func:`replicate`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import resolve_device
from ..core.field import FIELD_NAMES, FlowField
from .comm import LocalComm


def factor_devices(n: int) -> Tuple[int, int]:
    """Split n devices into a near-square (z, y) grid, preferring more
    shards along y (the larger axis in typical aspect ratios)."""
    best = (1, n)
    for z in range(1, int(np.sqrt(n)) + 1):
        if n % z == 0:
            best = (z, n // z)
    return best


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """``devices``: an object array of ``torch.device`` shaped by the
    axes; ``comm``: the communicator of its shards (flat index = shard
    index in C order)."""

    devices: np.ndarray
    axis_names: Tuple[str, ...]
    comm: object

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)


def mesh_zy_sizes(mesh: Mesh):
    """(Pz, Py) when the mesh spans only 'z' and/or 'y' axes (any other
    axis of size 1), else None; Py is 1 without a 'y' axis."""
    if "z" not in mesh.axis_names:
        return None
    if any(n not in ("z", "y") and mesh.shape[n] != 1
           for n in mesh.axis_names):
        return None
    return mesh.shape["z"], mesh.shape.get("y", 1)


def mesh_y_size(mesh: Mesh):
    """The shard count along 'y' when the mesh is y-only (every other
    axis of size 1), else None (`cfd_tpu/parallel/fused.py:58-65`)."""
    if "y" not in mesh.axis_names:
        return None
    if any(n != "y" and mesh.shape[n] != 1 for n in mesh.axis_names):
        return None
    return mesh.shape["y"]


def _cuda_devices():
    resolve_device("cuda")  # raises without a CUDA device
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(devices: Optional[Sequence] = None,
              axes: Tuple[str, ...] = ("z", "y"), comm=None,
              shape: Optional[Tuple[int, int]] = None) -> Mesh:
    """A 1D or 2D mesh over ``devices`` (default: every visible CUDA
    device).  ``comm`` defaults to a `comm.LocalComm` over the devices;
    a `comm.ProcessGroupComm` must span as many ranks as there are
    devices.  The mesh lays the communicator's shards out on its (Pz,
    Py) grid (`comm.LocalComm.set_shape`; on a process group that makes
    the row and column sub-groups, collectively on every rank).  A
    communicator serves one grid: a second mesh over it with another
    grid raises, so build a communicator per grid.  A 2D
    mesh is shaped by `factor_devices` ((1, 2), (2, 2), (2, 3), (2, 4)
    for 2, 4, 6, 8 devices), or by ``shape`` — e.g. (1, 4), which the
    reference builds as a ``jax.sharding.Mesh`` by hand."""
    devices = [torch.device(d) for d in
               (devices if devices is not None else _cuda_devices())]
    n = len(devices)
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    if len(axes) != 1:
        arr = arr.reshape(factor_devices(n) if shape is None else shape)
    elif shape is not None:
        raise ValueError("shape is for a 2D mesh")
    comm = LocalComm(devices) if comm is None else comm
    if comm.size != n:
        raise ValueError(f"the communicator spans {comm.size} shards, the "
                         f"mesh {n} devices")
    mesh = Mesh(arr, tuple(axes), comm)
    # the communicator's grid: (Pz, Py) on a mesh over 'z' and / or 'y',
    # (1, n) on a y-only one (its "y" exchanges along the row), else one
    # ring over every shard
    y_only = mesh_y_size(mesh)
    comm.set_shape(mesh_zy_sizes(mesh)
                   or ((1, n) if y_only is not None else (n, 1)))
    return mesh


def field_spec(mesh: Mesh, is_3d: bool, shape=None) -> tuple:
    """(z axis, y axis, None) for a (nz, ny, nx) field on this mesh, an
    entry None where that dimension is not split (`mesh.py:56-79`).  With
    ``shape``, an axis whose shard count does not divide its dimension
    is dropped to replicated."""
    names, sizes = mesh.axis_names, mesh.shape

    def divides(axis, dim):
        return shape is None or shape[dim] % sizes[axis] == 0

    if is_3d and "z" in names and sizes.get("z", 1) > 1 \
            and divides("z", 0):
        y = "y" if "y" in names and divides("y", 1) else None
        return ("z", y, None)
    # 2D grids (and 3D grids whose z doesn't divide): rows over the 'y'
    # axis, or over the mesh's only axis whatever its name
    y_axis = "y" if "y" in names else names[0]
    if divides(y_axis, 1):
        return (None, y_axis, None)
    return (None, None, None)


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedField:
    """A FlowField placed on a mesh: ``blocks`` are the local slabs of the
    shards ``mesh.comm.shards``, in that order, each on its device;
    ``spec`` and ``shape`` are the placement and the global shape."""

    mesh: Mesh
    spec: tuple
    shape: tuple
    blocks: tuple

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks[0].dtype

    @property
    def device(self) -> torch.device:
        """The first local shard's device."""
        return self.blocks[0].device

    def with_blocks(self, blocks) -> "ShardedField":
        return dataclasses.replace(self, blocks=tuple(blocks))

    def select(self, keep: torch.Tensor, other: "ShardedField"):
        """``self`` where the 0-d bool ``keep`` is True, else ``other``,
        block by block on the device (`FlowField.select`)."""
        return self.with_blocks(a.select(keep, b) for a, b in
                                zip(self.blocks, other.blocks))

    def diagnostics(self):
        """`FlowField.diagnostics` of the whole field: each shard's, folded
        across shards with ``mesh.comm.max``; on the first local shard's
        device."""
        vmax, pmax, tmax = self.mesh.comm.max(
            [torch.stack(b.diagnostics()) for b in self.blocks])[0]
        return vmax, pmax, tmax

    def gather(self, device=None) -> FlowField:
        return gather_field(self, device)


def _slices(mesh: Mesh, spec, shape, shard: int):
    """The index of shard ``shard``'s block in a field of ``shape``."""
    coords = dict(zip(mesh.axis_names,
                      np.unravel_index(shard, mesh.devices.shape)))
    idx = []
    for dim, axis in enumerate(spec):
        if axis is None:
            idx.append(slice(None))
        else:
            m = shape[dim] // mesh.shape[axis]
            c = int(coords[axis])
            idx.append(slice(c * m, (c + 1) * m))
    return tuple(idx)


def shard_field(field: FlowField, mesh: Mesh) -> ShardedField:
    """Place a FlowField on the mesh: each local shard takes its block of
    every field (`field_spec` of the field's shape), copied to its
    device."""
    shape = tuple(field.shape)
    spec = field_spec(mesh, shape[0] > 1, shape)
    blocks = []
    for s in mesh.comm.shards:
        dev = mesh.devices.flat[s]
        idx = _slices(mesh, spec, shape, s)
        blocks.append(FlowField(*(getattr(field, n)[idx].contiguous().to(dev)
                                  for n in FIELD_NAMES)))
    return ShardedField(mesh, spec, shape, tuple(blocks))


def gather_field(sfield: ShardedField, device=None) -> FlowField:
    """The whole field from its shards, on ``device`` (default: the first
    local shard's): a collective on a process group, every rank gets it."""
    mesh = sfield.mesh
    device = sfield.device if device is None else torch.device(device)
    out = {}
    for n in FIELD_NAMES:
        parts = mesh.comm.gather([getattr(b, n) for b in sfield.blocks],
                                 device)
        full = torch.empty(sfield.shape, dtype=parts[0].dtype, device=device)
        for s, part in enumerate(parts):
            full[_slices(mesh, sfield.spec, sfield.shape, s)] = part
        out[n] = full
    return FlowField(**out)


def replicate(value, mesh: Mesh):
    """``value`` on every local shard's device: a list, one entry per
    shard of ``mesh.comm.shards`` (a tensor or FlowField moved with
    ``.to``; anything else as it is)."""
    def on(dev):
        if torch.is_tensor(value):
            return value.to(dev)
        if isinstance(value, FlowField):
            return FlowField(*(getattr(value, n).to(dev)
                               for n in FIELD_NAMES))
        return value

    return [on(mesh.devices.flat[s]) for s in mesh.comm.shards]
