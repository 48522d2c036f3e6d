"""The decomposed explicit steps: Euler, RK2 and RK4 over a z-only mesh, a
(z, y) mesh and, on a 2D grid, a y-only mesh (counterpart of
`cfd_tpu/parallel/fused.py:1091-2090`: ``make_fused_sharded_euler_step``
and ``make_fused_sharded_rk_step`` with their 2D and (z, y) variants).

Each shard owns a (nzl, nyl, nx) block at global plane ``z0`` and row
``y0``.  Its fields u, v, w, p, T, ρ become the rows of one padded
buffer: the owned blocks copied into its window, the halos filled in
place from the neighbours (`comm.fill_halo`, y first and then z, so the
z exchange carries the corners).  On that block runs the sharded mode
of the single-device kernel (`ops.kernels.euler_kernels.ShardBlock`):
one thread per owned point, the x wrap in the kernel, the outputs the
owned rows of one buffer.  The global faces whose values live on
another shard are then restored by the wrapper in the reference's order
x → y → z (later faces own the corners, `fused.py:1470-1479`), across
the edge shards of each axis (`comm.edge_swap`, the reference's
``ppermute [(n−1, 0)]`` / ``[(0, n−1)]``), one copy a side for every
periodic field:

* Euler — the global-row mode of E3 / E2 (``euler_rows_kernel``) on the
  block padded one plane a side (3D) and one row a side (a (z, y) or y
  mesh; a z-only mesh keeps whole rows, and its y-face rows are the
  wrapper's too).  The kernel passes the faces through, so the caller's
  velocity shells stay (the save/restore idiom); the wrapper wraps the
  y-face rows of p, ρ and T, T by its thermal y faces when the energy
  equation is on (`fused.py:1238-1241`), then their z-shell planes (T by
  its thermal z faces).  dt is capped at ``DT_CONSERVATIVE_LIMIT``
  (`fused.py:1270-1271`).
* RK2 / RK4 — one stage kernel a Butcher stage.  Over a z-only mesh the
  ``global_nz`` mode (whole rows, the y wrap in the kernel) on the block
  padded one plane a side; the periodic-interior z neighbours of global
  planes 1 and nz − 2 are pin planes: global planes nz − 2 and 1 of the
  stage state.  The reference builds them with one ``psum`` over 'z' a
  stage (`fused.py:1633-1648`), which reduces the masked planes of every
  shard; only the two edge shards read them, so here the edge-to-edge
  exchange carries them, four planes each way between the two edge
  shards.  Over a (z, y) mesh (``global_nz`` + ``global_ny``) and a y
  mesh (``global_ny``) the block is padded two rows a side over the
  *periodic* y ring (``fill_halo(..., wrap=True)``), and the y neighbour
  of global row 1 (ny − 2) is the row three below (above), which the
  ring makes global row ny − 2 (1): the reference's 4-row ring is the
  TPU's 8-row sublane tile, and two rows are the narrowest ring that
  gives the same arithmetic.  A mid stage writes the next state and the
  accumulator into the owned window of block-shaped buffers whose halos
  are then filled in place; the final stage writes the owned block.  RK
  wraps every variable, velocities included (`fused.py:1729-1737`): the
  y-face rows (global-row modes), then the z-shell planes; T by its
  thermal faces.  No dt cap.

Halos past the global ends are never read (face points are passed
through, the z neighbours of global planes 1 and nz − 2 are pins), so
they stay unwritten.  The step's diagnostics are the restored field's
(the reference reads them from the restored field, `fused.py:1280`),
without a pass over it: a periodic or Neumann face holds a copy of a
value off the faces, so each kernel's maxima skip the faces the wrapper
rewrites (Euler's |u|² takes its passed-through velocity faces), the
wrapper's Dirichlet T values join max T, and the shards' maxima are
folded with ``comm.max`` (NaN propagating).  Every owned point off
those faces runs the single-device kernel's arithmetic, and the faces
copy the values the single-device kernel wraps, so the step equals the
single-device kernel step.  The step scalars are made once a device
(RK: a table, one row a stage).  Float64 and ``plain=True`` run the
plain versions of the same modes.

Gates: the reference's semantic ones (nz divisible with ≥ 3 planes a
shard, ny divisible, a y-only mesh for a 2D grid, uniform z, custom
sources refused with its text, parity + stretched + energy refused), and
≥ 2 rows a shard for the row halos; its TPU gates (nx % 128, rows % 8,
≥ 24 rows a shard, VMEM) are left out.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..core.field import FlowField
from ..core.grid import Grid
from ..core.status import CFDError, Status
from ..ops.kernels.euler2d import euler2d_step
from ..ops.kernels.euler_kernels import (ShardBlock, Spacing, euler_step,
                                         euler_step_rows_plain)
from ..ops.kernels.rk2d import rk2d_stage
from ..ops.kernels.rk_kernels import rk_stage, rk_stage_shard_plain
from ..solvers.ns.common import runs_plain, step_result, stretch_gate
from ..solvers.ns.euler import as_scalar, explicit_setup
from ..solvers.ns.params import (DT_CONSERVATIVE_LIMIT, NSParams,
                                 source_amplitudes)
from ..solvers.ns.rk import _TABLEAUS
from .mesh import Mesh, ShardedField, mesh_y_size, mesh_zy_sizes
from .thermal import dirichlet_floor, restore_faces, thermal_face_specs


def _reason(kind: str, grid: Grid, params: NSParams, mesh: Mesh):
    """None when the decomposed ``kind`` ("euler" or "rk") step applies,
    else the reason (`fused.py:1091-1143`, `:1512-1570`, the TPU gates
    left out)."""
    custom = (params.source_func is not None
              or params.heat_source_func is not None)
    if grid.nz <= 2:
        n = mesh_y_size(mesh)
        if n is None:
            return (f"fused sharded 2D {kind} needs a y-only mesh "
                    f"(got axes {dict(mesh.shape)})")
        reason = stretch_gate(grid, params)[1]
        if reason is not None:
            return reason
        if grid.ny % n != 0 or grid.ny // n < 2:
            return (f"ny={grid.ny} must be divisible by {n} shards with "
                    ">= 2 rows per shard")
        return "custom source callables use the jnp path" if custom else None
    sizes = mesh_zy_sizes(mesh)
    if sizes is None:
        return (f"fused sharded {kind} needs a mesh over ('z'[, 'y']) axes "
                f"(got axes {dict(mesh.shape)})")
    pz, py = sizes
    if grid.nz % pz != 0 or grid.nz // pz < 3:
        return (f"nz={grid.nz} must be divisible by {pz} shards with >= 3 "
                "planes per shard")
    if py > 1:
        if mesh.axis_names.index("y") < mesh.axis_names.index("z"):
            return "a mesh with its 'y' axis before 'z' is not ported yet"
        if grid.ny % py != 0 or grid.ny // py < 2:
            return (f"ny={grid.ny} must be divisible by {py} y-shards with "
                    ">= 2 rows per shard")
    if not grid.is_uniform("z"):
        return "fused kernels need uniform z spacing"
    reason = stretch_gate(grid, params)[1]
    if reason is not None:
        return reason
    return "custom source callables use the jnp path" if custom else None


def fused_sharded_euler_unsupported_reason(grid: Grid, params: NSParams,
                                           mesh: Mesh):
    """None when the decomposed Euler step applies, else the reason (the
    dtype is none: float64 runs the plain versions)."""
    return _reason("euler", grid, params, mesh)


def fused_sharded_rk_unsupported_reason(grid: Grid, params: NSParams,
                                        mesh: Mesh):
    """None when the decomposed RK step applies, else the reason."""
    return _reason("rk", grid, params, mesh)


def make_fused_sharded_euler_step(grid: Grid, params: NSParams, mesh: Mesh,
                                  dtype=None, plain: bool = False):
    """Build ``step(field, dt, iter_idx) -> (field, StepResult)`` on a
    `mesh.ShardedField` (`fused.py:1147-1509`), as the module's docstring
    sets out.  ``dtype`` defaults to float32 on the card; float64 and
    ``plain=True`` run the plain versions."""
    return _make_step(grid, params, mesh, None, dtype, plain)


def make_fused_sharded_rk_step(grid: Grid, params: NSParams, mesh: Mesh,
                               order: int, dtype=None, plain: bool = False):
    """The decomposed RK2 (``order=2``) or RK4 (``order=4``) step
    (`fused.py:1573-2090`); as :func:`make_fused_sharded_euler_step`."""
    if order not in _TABLEAUS:
        raise ValueError(f"order must be 2 or 4, got {order}")
    return _make_step(grid, params, mesh, order, dtype, plain)


@dataclasses.dataclass(frozen=True)
class _Shard:
    """One local shard: its device, its edges along z and y, its block
    (`ShardBlock`), the kernel constants of its block's dims (the spacing's
    y rows cut to the block) and its rows of sin(πy)."""

    device: torch.device
    first_z: bool
    last_z: bool
    first_y: bool
    last_y: bool
    block: ShardBlock
    consts: object
    sy: torch.Tensor
    sx: torch.Tensor

    def edge(self, axis: str):
        return ((self.first_z, self.last_z) if axis == "z"
                else (self.first_y, self.last_y))


def _block_rows(a: torch.Tensor, start: int, n: int) -> torch.Tensor:
    """Columns ``start .. start + n`` of ``a`` (..., ny), zeros past its
    ends."""
    lo, hi = max(0, -start), max(0, start + n - a.shape[-1])
    return F.pad(a, (lo, hi))[..., start + lo:start + lo + n].contiguous()


def _make_step(grid: Grid, params: NSParams, mesh: Mesh, order, dtype,
               plain: bool):
    kind = "euler" if order is None else "rk"
    reason = _reason(kind, grid, params, mesh)
    if reason is not None:
        raise CFDError(Status.ERROR_UNSUPPORTED,
                       f"fused sharded {kind} unsupported: {reason}")
    comm = mesh.comm
    devices = [torch.device(d) for d in comm.devices]
    name = "explicit Euler" if order is None else f"RK{order}"
    dtype, _, consts, (sy, sx) = explicit_setup(name, grid, params, dtype,
                                                devices[0], plain)
    plain = runs_plain(dtype, plain)
    three_d = grid.nz > 1
    pz, py = mesh_zy_sizes(mesh) if three_d else (1, mesh_y_size(mesh))
    nzl, nyl, nx = grid.nz // pz, grid.ny // py, grid.nx
    hz = 1 if three_d else 0
    if order is None:
        rows, hy = True, (1 if py > 1 or not three_d else 0)
    else:
        rows = py > 1 or not three_d
        hy = 2 if rows else 0
    dims = (nzl + 2 * hz, nyl + 2 * hy, nx)     # a shard's padded block
    shards = []
    for s, dev in zip(comm.shards, devices):
        zi, yi = comm.coords(s) if three_d else (0, comm.coords(s)[1])
        z0, y0 = zi * nzl, yi * nyl
        sp = consts.spacing
        if sp is not None:
            sp = Spacing(sp.scheme, sp.xw.to(dev),
                         _block_rows(sp.yw, y0 - hy, dims[1]).to(dev))
        c = dataclasses.replace(consts, nz=dims[0], ny=dims[1], spacing=sp)
        block = ShardBlock(hz, hy, z0, grid.nz if three_d else 1, y0,
                           grid.ny, rows)
        shards.append(_Shard(dev, zi == 0, zi == pz - 1, yi == 0,
                             yi == py - 1, block, c,
                             _block_rows(sy, y0 - hy, dims[1]).to(dev),
                             sx.to(dev)))
    t_specs = thermal_face_specs(params)
    # the faces the wrapper restores; the Dirichlet T values among them
    # join the step's max T (the kernels' maxima skip those faces)
    t_floor = dirichlet_floor(t_specs, (["y"] if rows else [])
                              + (["z"] if three_d else []))

    def padded(blocks, wrap: bool):
        """Each shard's fields u, v, w, p, T, ρ as the rows of one
        block-shaped buffer: the owned blocks in its window, the halos of
        the first five filled in place from the neighbours (y first, the
        periodic ring with ``wrap``, then z).  Halos past the global ends
        are never read (the faces the wrapper rewrites are passed through,
        and the z neighbours of global planes 1 and nz − 2 are pins), so
        they stay unwritten; ρ is read at owned points only."""
        bufs = []
        for b, sh in zip(blocks, shards):
            buf = torch.empty((6, *dims), dtype=dtype, device=sh.device)
            win = buf[:, hz:hz + nzl, hy:hy + nyl]
            for k, n in enumerate(("u", "v", "w", "p", "T", "rho")):
                win[k].copy_(getattr(b, n))
            bufs.append(buf)
        fill([b[:5] for b in bufs], wrap)
        return bufs

    def fill(bufs, wrap: bool):
        if hy:
            comm.fill_halo(bufs, hy, "y", wrap)
        if three_d:
            comm.fill_halo(bufs, hz, "z")

    def fix(outs, axis: str, first: int):
        """Restore the global faces of ``axis`` on each shard's owned
        outputs (rows u, v, w, p, ρ, T of one buffer, rewritten in place):
        rows ``first`` on wrap periodically, T by its thermal faces
        (`thermal.restore_faces`)."""
        restore_faces(comm, outs, [sh.edge(axis) for sh in shards], axis,
                      nzl if axis == "z" else nyl, t_specs[axis], first, 5)

    def finish(field, outs, maxima):
        """The new field and its StepResult: the shards' maxima folded
        with ``comm.max``, the wrapper's Dirichlet T faces joined."""
        m2, pmax, pabs, tmax = comm.max(maxima)[0]
        if t_floor is not None:
            tmax = torch.clamp_min(tmax, t_floor)
        finite = torch.isfinite(m2) & torch.isfinite(pabs)
        return (field.with_blocks(FlowField(*o.unbind()) for o in outs),
                step_result(finite, torch.sqrt(m2), pmax, tmax))

    def per_device(fn):
        """``fn(device)`` once for each device of the local shards, as a
        list in shard order."""
        memo = {}
        for sh in shards:
            if sh.device not in memo:
                memo[sh.device] = fn(sh.device)
        return [memo[sh.device] for sh in shards]

    if order is None:
        if plain:
            run = euler_step_rows_plain
        else:
            run = euler_step if three_d else euler2d_step

        def step(field: ShardedField, dt, iter_idx):
            def scalars(dev):
                cdt = torch.clamp_max(as_scalar(dt, dtype, dev),
                                      DT_CONSERVATIVE_LIMIT)
                su, sv = source_amplitudes(params, iter_idx * cdt)
                return torch.stack([cdt, su, sv])

            outs, maxima = [], []
            for buf, sh, scal in zip(padded(field.blocks, False), shards,
                                     per_device(scalars)):
                o, m = run(*buf.unbind(), sh.sy, sh.sx, scal, sh.consts,
                           sh.block)
                outs.append(o)
                maxima.append(m)
            # the velocities' faces are passed through: p, ρ and T wrap
            fix(outs, "y", 3)
            if three_d:
                fix(outs, "z", 3)
            return finish(field, outs, maxima)

        return step

    if plain:
        def run(*a, pins=None):
            return rk_stage_shard_plain(*a, pins)
    elif three_d:
        run = rk_stage
    else:
        def run(*a, pins=None):
            return rk2d_stage(*a)
    tableau = _TABLEAUS[order]
    divisors = [div for div, _, _ in tableau]
    # each device's (acc_mix, weight) columns of the tableau
    table_consts = {sh.device: tuple(
        torch.tensor(col, dtype=dtype, device=sh.device)
        for col in list(zip(*tableau))[1:]) for sh in shards}

    def make_pins(states):
        """Each shard's z-wrap pins (8 block planes: u, v, w, p at global
        plane nz − 2, then at global plane 1; a half no shard reads left
        unwritten), None off the z edges."""
        if not three_d:
            return [None] * len(shards)
        far, near = hz + nzl - 2, hz + 1    # on the last / first shard
        got = comm.edge_swap(
            [st[:, far] if sh.last_z else None
             for st, sh in zip(states, shards)],
            [st[:, near] if sh.first_z else None
             for st, sh in zip(states, shards)], "z")
        pins = []
        for (from_last, from_first), sh in zip(got, shards):
            if from_last is None and from_first is None:
                pins.append(None)
                continue
            pin = torch.empty((8, *dims[1:]), dtype=dtype, device=sh.device)
            if from_last is not None:
                pin[:4].copy_(from_last)
            if from_first is not None:
                pin[4:].copy_(from_first)
            pins.append(pin)
        return pins

    def step(field: ShardedField, dt, iter_idx):
        def scalars(dev):
            """The stages' scalars, one row a stage: (dt / divisor,
            acc_mix, weight, su, sv, dt); dt / divisor as the
            single-device step forms it (a tensor over a Python number,
            which CUDA computes as a product by its reciprocal)."""
            dts = as_scalar(dt, dtype, dev)
            su, sv = source_amplitudes(params, iter_idx * dts)
            mixes, weights = table_consts[dev]
            n = len(tableau)
            factors = torch.stack([dts / div for div in divisors])
            return torch.stack([factors, mixes, weights, su.expand(n),
                                sv.expand(n), dts.expand(n)], 1)

        bufs = padded(field.blocks, rows)
        tables = per_device(scalars)
        states = [b[:4] for b in bufs]       # q0, the first stage's state
        accs = [None] * len(shards)
        for n in range(len(tableau)):
            final = n == len(tableau) - 1
            pins = make_pins(states)
            outs = [run(st.unbind(), b[:4].unbind(), b[5], b[4], acc,
                        sh.sy, sh.sx, table[n], sh.consts, final, sh.block,
                        pins=pin)
                    for st, b, acc, sh, table, pin in zip(
                        states, bufs, accs, shards, tables, pins)]
            if not final:
                fill([o[:4] for o, _ in outs], True)
                states = [o[:4] for o, _ in outs]
                accs = [tuple(o[4:].unbind()) for o, _ in outs]
        new = [o for o, _ in outs]
        if rows:
            fix(new, "y", 0)
        if three_d:
            fix(new, "z", 0)
        return finish(field, new, [m for _, m in outs])

    return step
