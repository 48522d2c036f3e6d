"""Sharded solver entry points (counterpart of
`cfd_tpu/parallel/sharded.py:66-218`).

The reference has two ways to run a step on a mesh: its fused shard_map
paths (`parallel.fused`) and, for everything else, the single-device jnp
step under GSPMD placement.  GSPMD has no torch counterpart, so here every
configuration runs the ported fused path (`fused.
make_fused_sharded_projection_step`; `fused_explicit.
make_fused_sharded_euler_step` and ``make_fused_sharded_rk_step`` for
``explicit_euler``, ``rk2`` and ``rk4``, `sharded.py:108-135`) or raises
``CFDError(ERROR_UNSUPPORTED)`` with the reason — as the reference's
``strict=True`` does; nothing falls back.

The projection step with the ``MULTIGRID`` pressure solve is the
reference's `_make_sharded_mg_projection` (`sharded.py:33-63`, dispatched
at `:146-158` before the fused step's gate): the single-device step on the
whole field, its pressure solve replaced by the decomposed multigrid
(`fused_mg.make_multigrid_sharded`) — the one stage that runs on the
shards.  2^k+1 grids do not divide over the mesh, so their placement
(`mesh.field_spec`) is replicated and the gather is a copy.
"""

from __future__ import annotations

from ..core.grid import Grid
from ..core.status import CFDError, Status
from ..solvers.ns.params import NSParams
from ..solvers.ns.projection import make_projection_step
from ..solvers.poisson.base import Method, PoissonParams, PoissonProblem
from .fused import (fused_sharded_unsupported_reason,
                    make_fused_sharded_projection_step)
from .fused_explicit import (fused_sharded_euler_unsupported_reason,
                             fused_sharded_rk_unsupported_reason,
                             make_fused_sharded_euler_step,
                             make_fused_sharded_rk_step)
from .fused_mg import (make_multigrid_sharded,
                       mg_fused_sharded_unsupported_reason)
from .mesh import (Mesh, field_spec, gather_field, mesh_zy_sizes,
                   shard_field)

_METHODS = ("explicit_euler", "rk2", "rk4", "projection")


def _make_sharded_mg_projection(grid: Grid, params: NSParams, mesh: Mesh,
                                kw, unsupported):
    """The projection step with the decomposed multigrid pressure solve
    (`sharded.py:33-63`): ``step(sfield, dt, iter_idx)`` gathers the
    `ShardedField` on the first local shard's device, runs the
    single-device MULTIGRID step there with ``poisson_solve_override`` the
    sharded solve, and places its output again.  On a process group each
    rank runs its replica of the step, the solve being the collective
    part.  ``step.poisson_solve`` is the solve, ``step.last_poisson`` the
    last step's result.  ``unsupported(reason)`` raises."""
    sizes = mesh_zy_sizes(mesh)
    if sizes is None:
        unsupported("fused sharded multigrid needs a mesh over ('z'[, "
                    f"'y']) axes (got axes {dict(mesh.shape)})")
    problem = PoissonProblem(grid.nx, grid.ny, grid.nz, grid.dx0,
                             grid.dy0, grid.dz0)
    reason = mg_fused_sharded_unsupported_reason(problem, *sizes)
    if reason is not None:
        unsupported(reason)
    extra = set(kw) - {"dtype", "poisson_method", "poisson_params",
                       "spectral_precision", "plain"}
    if extra:
        unsupported(f"keywords {sorted(extra)} do not apply to the sharded "
                    "multigrid step")
    pparams = kw.get("poisson_params") or PoissonParams()
    plain = bool(kw.get("plain", False))
    mg_solve = make_multigrid_sharded(problem, pparams, mesh, plain=plain)
    single = make_projection_step(
        grid, params, kw.get("dtype"), Method.MULTIGRID, pparams,
        device=mesh.devices.flat[mesh.comm.shards[0]],
        spectral_precision=kw.get("spectral_precision"), plain=plain,
        poisson_solve_override=mg_solve)

    def step(sfield, dt, iter_idx):
        field, result = single(gather_field(sfield), dt, iter_idx)
        step.last_poisson = single.last_poisson
        return shard_field(field, mesh), result

    step.poisson_solve, step.last_poisson = mg_solve, None
    return step


def make_sharded_raw_step(grid: Grid, params: NSParams, mesh: Mesh,
                          method: str = "projection", **kw):
    """``(raw_step, out_spec, place)``: the step on a `mesh.ShardedField`,
    the placement of its output fields (`mesh.field_spec`) and
    ``place(field)`` (`mesh.shard_field`).  The port runs its steps
    eagerly, so the raw step and the step are one function.

    Keywords: ``dtype``, ``poisson_method``, ``poisson_params``,
    ``spectral_precision`` and ``plain`` go to the builder;
    ``use_pallas=False`` asks for the reference's GSPMD jnp path, which
    has no counterpart, and raises.  The reference's other keywords are
    taken (`sharded.py:83-94`): ``strict`` (the port is always strict:
    what it cannot build raises, nothing falls back), ``use_pallas_cg``
    (as ``use_pallas``) and ``pallas_interpret`` (the Pallas interpreter
    switch, which has no meaning here)."""
    if method not in _METHODS:
        raise ValueError(f"unknown method {method!r}")
    use_pallas = kw.pop("use_pallas", None)
    use_pallas_cg = kw.pop("use_pallas_cg", None)
    kw.pop("strict", None)
    kw.pop("pallas_interpret", None)
    if use_pallas is None:
        use_pallas = use_pallas_cg

    def unsupported(reason):
        raise CFDError(Status.ERROR_UNSUPPORTED,
                       f"sharded {method} unavailable: {reason}")

    if use_pallas is False:
        unsupported("the GSPMD jnp step (use_pallas=False) has no "
                    "counterpart in the port")
    pm = kw.get("poisson_method")
    if method == "projection" and pm is not None \
            and Method(pm) == Method.MULTIGRID:
        raw = _make_sharded_mg_projection(grid, params, mesh, kw,
                                          unsupported)
        return (raw, field_spec(mesh, grid.nz > 1, grid.shape),
                lambda field: shard_field(field, mesh))
    if method == "projection":
        reason = fused_sharded_unsupported_reason(grid, params, mesh,
                                                  kw.get("poisson_method"))
    elif method == "explicit_euler":
        reason = fused_sharded_euler_unsupported_reason(grid, params, mesh)
    else:
        reason = fused_sharded_rk_unsupported_reason(grid, params, mesh)
    if reason is not None:
        unsupported(reason)
    if method == "projection":
        raw = make_fused_sharded_projection_step(grid, params, mesh, **kw)
    else:
        extra = set(kw) - {"dtype", "plain"}
        if extra:
            unsupported(f"keywords {sorted(extra)} apply to the projection "
                        "step")
        if method == "explicit_euler":
            raw = make_fused_sharded_euler_step(grid, params, mesh, **kw)
        else:
            raw = make_fused_sharded_rk_step(grid, params, mesh,
                                             int(method[2:]), **kw)
    return (raw, field_spec(mesh, grid.nz > 1, grid.shape),
            lambda field: shard_field(field, mesh))


def make_sharded_step(grid: Grid, params: NSParams, mesh: Mesh,
                      method: str = "projection", **kw):
    """``(step, place)``: ``place(field)`` shards the initial state;
    ``step(field, dt, iter)`` runs one step on it, its output sharded the
    same way.  Selection and keywords as :func:`make_sharded_raw_step`:
    the projection step on a z-only, (z, y) or (2D) y-only mesh
    (FFT_DIRECT at ``spectral_precision`` "highest", "high" or
    "default", CG, BiCGSTAB, MULTIGRID; on a stretched grid under the
    consistent scheme FFT_DIRECT on a z-only mesh), the explicit steps
    on those meshes."""
    raw, _, place = make_sharded_raw_step(grid, params, mesh, method, **kw)
    return raw, place
