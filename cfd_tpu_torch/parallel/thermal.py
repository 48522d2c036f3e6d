"""The energy post-step and the thermal faces on shard blocks (counterpart
of the reference's GSPMD ``energy_step`` + ``apply_thermal_bcs`` after its
sharded projection steps, `cfd_tpu/parallel/fused.py:626-634`, `:921-927`,
`:1073-1079`), and the face restore the decomposed explicit steps share.

The reference computes both as jnp on the whole field and lets GSPMD
partition them; here each shard computes its owned block:

1. **Halos.** T is read at the owned points ± 1 plane (z) and ± 1 row
   (y, where y is split); u, v and w only at owned points.  T lives in a
   persistent padded buffer a shard (:class:`HaloBuffers`): the owned
   block copied into its window, the halos filled in place with
   ``comm.fill_halo``, rows first and then planes, so the corners arrive
   (`comm.py`); the buffers are zeroed once and the halos past the global
   ends are never written.  A buoyant projection step fills one buffer of
   two halos for its predictor and hands it on, so the post-step reads
   the inner halo of it and exchanges nothing more.
2. **Interior.** The single-device energy step's ops (`solvers.energy.
   make_energy_step`: ``interior``, ``ddx`` … ``laplacian`` of
   `ops.stencils`, in the same order; on a stretched grid under the
   consistent scheme ``along_x``, ``along_y`` on the weight rows of
   `energy._consistent_energy_step` and ``laplacian_interior``) on the
   owned points of the padded block, then the block's global interior
   written into a copy of the owned T: the global shells keep T, exactly
   as ``set_interior`` leaves them on one device.  The consistent
   projection step runs on a z-only mesh only, so x and y are whole and
   its weight rows are the single-device ones.
3. **Faces, in the reference's order** (left, right, bottom, top, back,
   front: the face applied last owns a corner, `solvers/energy.py`
   ``apply_thermal_bcs``), in three stages: the x faces on every shard,
   then the y faces (locally where y is whole, else on the y-edge shards),
   then the z faces on the z-edge shards (:func:`restore_faces`).  A
   PERIODIC face copies plane (row) n − 2 or 1 from the opposite edge
   shard in one ``comm.edge_swap`` a side; a NEUMANN face its inner
   neighbour, which the ≥ 2 planes (rows) a shard gate keeps local; a
   DIRICHLET face its value.

Every op is the single-device post-step's elementwise op, in its order,
and the faces are copies and fills, so the new T blocks are bit-equal to
the single-device post-step's owned blocks.  No TPU kernel computes this
stage (the reference's is jnp), and the single-device port runs it as
plain torch too.

:func:`restore_faces` is also the decomposed explicit steps' face restore
(`fused_explicit`): there T rides the periodic wrap of the other fields
in one exchange, and its thermal faces are written the same way.
"""

from __future__ import annotations

import torch

from ..boundary.types import BCType, thermal_y_specs, thermal_z_specs
from ..core.grid import Grid
from ..core.status import CFDError, Status
from ..ops.stencils import (along_x, along_y, ddx, ddy, ddz, interior,
                            laplacian, laplacian_interior)
from ..solvers.energy import (make_energy_step, thermal_weight_rows,
                              validate_thermal_bc)
from ..solvers.ns.euler import as_scalar
from ..solvers.ns.params import NSParams
from .comm import AXIS_DIM

_PERIODIC = ("periodic", "periodic")


def thermal_face_specs(params: NSParams) -> dict:
    """The (low, high) thermal face specs of the y and z axes: a
    Dirichlet value, ``"neumann"`` or ``"periodic"``
    (`boundary.types.thermal_y_specs` / ``thermal_z_specs``); both
    periodic when the energy equation is off (T then wraps as any other
    field of the explicit steps)."""
    if not params.energy_enabled:
        return {"y": _PERIODIC, "z": _PERIODIC}
    return {"y": thermal_y_specs(params.thermal_bc),
            "z": thermal_z_specs(params.thermal_bc)}


def dirichlet_floor(specs: dict, axes):
    """The largest Dirichlet value among the faces of ``axes``, None
    without one: a step whose maxima skip those faces joins it to max T."""
    values = [float(v) for ax in axes for v in specs[ax]
              if not isinstance(v, str)]
    return max(values) if values else None


def restore_faces(comm, outs, edges, axis: str, n: int, spec, first: int,
                  t_row: int) -> None:
    """Restore the global faces of ``axis`` on each local shard's owned
    outputs, rewritten in place.  ``outs[i]`` stacks the shard's fields as
    rows; rows ``first .. t_row − 1`` wrap periodically, row ``t_row`` is
    T, written by its faces ``spec`` (low, high).  ``edges[i]`` is the
    shard's (first, last) along ``axis``, ``n`` its owned planes (rows)
    there.  The periodic rows take the opposite edge shard's plane (row)
    n − 2 or 1 in one ``comm.edge_swap`` a side for all of them (T with
    them on a periodic face); a Neumann T face its inner neighbour (read
    before any write); a Dirichlet one its value.  No source is a face
    this writes (a one-shard axis has n ≥ 3)."""
    dim = AXIS_DIM[axis]
    lo, hi = spec
    top = t_row + 1 if "periodic" in (lo, hi) else t_row
    if top > first:
        got = comm.edge_swap(
            [o[first:top].narrow(dim, n - 2, 1) if e[1] else None
             for o, e in zip(outs, edges)],
            [o[first:top].narrow(dim, 1, 1) if e[0] else None
             for o, e in zip(outs, edges)], axis)
    else:
        got = [(None, None)] * len(outs)
    for o, e, recv in zip(outs, edges, got):
        T, writes = o[t_row], []
        for side, at, nb, face in ((0, 0, 1, lo), (1, n - 1, n - 2, hi)):
            if not e[side]:
                continue
            end = t_row + 1 if face == "periodic" else t_row
            if end > first:
                writes.append((o[first:end].narrow(dim, at, 1),
                               recv[side][:end - first]))
            if face == "neumann":
                writes.append((T.narrow(dim, at, 1),
                               T.narrow(dim, nb, 1).clone()))
            elif face != "periodic":
                writes.append((T.narrow(dim, at, 1), float(face)))
        for dst, src in writes:
            if torch.is_tensor(src):
                dst.copy_(src)
            else:
                dst.fill_(src)


class HaloBuffers:
    """One persistent buffer a local shard for a field of owned blocks
    ``owned`` (nzl, nyl, nx): ``halo`` planes a side along z when the
    grid is 3D (nzl > 1), ``halo`` rows a side along y when y is split
    (Py > 1), zeroed once.  :meth:`fill` copies the owned blocks into the
    windows and fills the halos from the neighbours, rows first, then
    planes (the corners in two hops); the halos past the global ends stay
    zero."""

    def __init__(self, comm, owned, halo: int, dtype):
        nzl, nyl, nx = owned
        self.comm = comm
        self.hz = halo if nzl > 1 else 0        # a 2D grid: one plane
        self.hy = halo if comm.shape[1] > 1 else 0
        self.bufs = [torch.zeros((nzl + 2 * self.hz, nyl + 2 * self.hy, nx),
                                 dtype=dtype, device=torch.device(d))
                     for d in comm.devices]
        self._win = (slice(self.hz, self.hz + nzl),
                     slice(self.hy, self.hy + nyl))

    def fill(self, blocks):
        """The buffers, holding ``blocks`` (one owned tensor a local
        shard) and their neighbours' edges."""
        for buf, b in zip(self.bufs, blocks):
            buf[self._win].copy_(b)
        if self.hy:
            self.comm.fill_halo(self.bufs, self.hy, "y")
        if self.hz:
            self.comm.fill_halo(self.bufs, self.hz, "z")
        return self.bufs

    def inner(self, buf, n: int = 1):
        """The view of ``buf`` with ``n`` (≤ ``halo``) halos a side."""
        z = slice(self.hz - n, buf.shape[0] - self.hz + n) if self.hz \
            else slice(None)
        y = slice(self.hy - n, buf.shape[1] - self.hy + n) if self.hy \
            else slice(None)
        return buf[z, y]


def _x_faces(T: torch.Tensor, config) -> None:
    """The left and right thermal faces, in place (the first two of
    ``apply_thermal_bcs``'s faces)."""
    v = config.dirichlet_values
    for bc, at, nb, wrap, value in ((config.left, 0, 1, -2, v.left),
                                    (config.right, -1, -2, 1, v.right)):
        bc = BCType(bc)
        if bc == BCType.DIRICHLET:
            T[..., at] = value
        elif bc == BCType.NEUMANN:
            T[..., at] = T[..., nb]
        elif bc == BCType.PERIODIC:
            T[..., at] = T[..., wrap]


def make_sharded_thermal_post(grid: Grid, params: NSParams, comm, dtype):
    """``post(blocks, dt, temps=None) -> (T blocks, max T per shard)``,
    the energy step and the thermal faces on the local shards' blocks of
    ``grid`` laid out on ``comm``'s (Pz, Py) grid, as the module's
    docstring sets out; None when the energy equation is off (T then
    passes through).  ``blocks`` are the shards' `FlowField`s with the
    new velocities and the step-start T; ``dt`` a number or 0-d tensor,
    or a list of them one a shard; ``temps`` the caller's
    :class:`HaloBuffers` already filled with that T (a buoyant step's
    predictor buffers), else the post-step fills its own.  The maxima
    are each new block's, faces included.

    The energy step's refusals (a heat source; non-uniform dx/dy without
    the consistent scheme) and a thermal face other than PERIODIC,
    NEUMANN or DIRICHLET (``ERROR_INVALID``) raise here; so does the
    consistent scheme with y split over the mesh (its rows would need a
    shard's window)."""
    energy_step = make_energy_step(grid, params.alpha,
                                   params.heat_source_func,
                                   scheme=params.nonuniform_scheme)
    if energy_step is None:
        return None
    validate_thermal_bc(params.thermal_bc, grid)
    three_d = grid.nz > 1
    pz, py = comm.shape
    nz, ny, nx = grid.shape
    owned = (nz // pz, ny // py, nx)
    nzl, nyl = owned[:2]
    alpha = params.alpha
    inv_2dx, inv_2dy = 1.0 / (2.0 * grid.dx0), 1.0 / (2.0 * grid.dy0)
    inv_dx2, inv_dy2 = 1.0 / grid.dx0 ** 2, 1.0 / grid.dy0 ** 2
    inv_2dz = 1.0 / (2.0 * grid.dz0) if three_d else 0.0
    inv_dz2 = grid.inv_dz2 if three_d else 0.0
    stretched = not (grid.is_uniform("x") and grid.is_uniform("y"))
    if stretched and py > 1:
        raise CFDError(Status.ERROR_UNSUPPORTED,
                       "the consistent energy step on shards needs whole "
                       "y rows (a z-only mesh)")
    rows_of = thermal_weight_rows(grid) if stretched else None
    specs = thermal_face_specs(params)
    # u, v, w at the points of the padded T's interior: the owned rows
    # where y is split, else the interior rows
    rows = slice(None) if py > 1 else slice(1, -1)
    edges = {"z": [], "y": []}
    keep = []
    for s in comm.shards:
        zi, yi = comm.coords(s)
        ez, ey = (zi == 0, zi == pz - 1), (yi == 0, yi == py - 1)
        edges["z"].append(ez)
        edges["y"].append(ey)
        # the planes (rows) of the new interior inside the global one
        keep.append((slice(int(ez[0]), nzl - int(ez[1])) if three_d
                     else slice(None),
                     slice(int(ey[0]), nyl - int(ey[1])) if py > 1
                     else slice(None)))
    own = []

    def post(blocks, dt, temps=None):
        if temps is None:
            if not own:
                own.append(HaloBuffers(comm, owned, 1, dtype))
            temps = own[0]
            temps.fill([b.T for b in blocks])
        dts = dt if isinstance(dt, (list, tuple)) else [dt] * len(blocks)
        new = []
        for b, buf, d, k in zip(blocks, temps.bufs, dts, keep):
            Tp = temps.inner(buf)
            d = as_scalar(d, dtype, buf.device)
            u, v, w = (f[:, rows, 1:-1] for f in (b.u, b.v, b.w))
            if rows_of is None:
                advection = ((u * ddx(Tp, inv_2dx) + v * ddy(Tp, inv_2dy))
                             + w * ddz(Tp, inv_2dz))
                diffusion = alpha * laplacian(Tp, inv_dx2, inv_dy2,
                                              inv_dz2)
            else:
                # `energy._consistent_energy_step`'s ops, in its order
                X, Y = rows_of(Tp)
                advection = u * along_x(Tp, X[:3]) + v * along_y(Tp, Y[:3])
                if three_d:
                    advection = advection + w * ddz(Tp, inv_2dz)
                diffusion = alpha * laplacian_interior(Tp, X[3:], Y[3:],
                                                       inv_dz2)
            T_int = interior(Tp) + d * (-advection + diffusion)
            T = b.T.clone()
            T[:, rows, 1:-1][k] = T_int[k]
            _x_faces(T, params.thermal_bc)
            new.append(T)
        stack = [t[None] for t in new]
        restore_faces(comm, stack, edges["y"], "y", nyl, specs["y"], 0, 0)
        if three_d:
            restore_faces(comm, stack, edges["z"], "z", nzl, specs["z"], 0,
                          0)
        return new, [torch.amax(t) for t in new]

    return post
