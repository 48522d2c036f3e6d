"""The stationary pressure solves, Jacobi and Red-Black SOR (counterpart of
`cfd_tpu/solvers/poisson/stationary.py`: ``_common_while`` `:35-76`,
``make_jacobi`` `:84-99`, ``make_redblack_sor_fused`` `:126-185`,
``make_jacobi_vmem`` `:188-214`, ``make_redblack_sor_vmem`` `:217-250`,
``make_redblack_sor`` `:253-278`).

The reference's common solve loop (`linear_solver.c:397-485`): the
∞-norm residual of x as given, then ``check_interval`` chunks of
min(ci, max_iter − it) sweeps, each sweep followed by the Neumann mirror,
and the ∞-norm residual recomputed from x at the end of each chunk, until
it falls below max(tolerance·r₀, absolute_tolerance).  Status CONVERGED
(also when the start has converged: 0 iterations) or MAX_ITER.

* Jacobi: the double-buffered full sweep ``x = −(rhs − nb)·inv_factor``
  on the interior;
* Red-Black SOR: the two masked half-sweeps over the (i + j + k)
  checkerboard, ``x ← x + ω(gs − x)``, ω from ``params.omega`` or, when
  that is ≤ 0, the optimal one (``PoissonProblem.resolve_omega``).

Five makers, each ``make_*(problem, params, dtype, device, plain=False)``
returning ``solve(x, rhs) -> PoissonResult``:

* :func:`make_jacobi`, :func:`make_redblack_sor` — the plain twins of the
  reference's jnp loops;
* :func:`make_redblack_sor_fused` — the loop on the sweep kernel
  (`ops.kernels.rbsor_kernels`), which returns the residual of every
  sweep; the host queues the sweeps ``CHUNK`` at a time and the loop's
  state stays on the card (``solve.host_syncs`` counts the reads);
* :func:`make_redblack_sor_vmem`, :func:`make_jacobi_vmem` — the whole
  solve in one kernel launch (`ops.kernels.vmem_small`).

and SOR / Gauss-Seidel (`:286-374`): :func:`make_sor`, plain tensor
code in the C loops' order (`linear_solver_sor.c:80-130`): planes
k = 1..nz−2 in order, each with the previous plane's new values, rows
j = 1..ny−2 in order, each with the previous row's new values, and each
row's update x[i] = a·x[i−1] + c[i] as a log-depth scan over the row.
The reference runs that recurrence on ``lax.associative_scan``; torch has
none, so :func:`_linear_scan` is a Hillis–Steele scan on the same (A, B)
pairs with the reference's combine.  Gauss-Seidel is the same maker, ω
resolved as for SOR (the reference's front end does the same).  No TPU
kernel exists for it, so none is ported; the reference's front end gives
it no fused maker either (`frontend.py:80-82`).

In float32 the residual, recomputed from x, stalls at a floor of about
eps·‖A‖·‖x‖, as multigrid's does.
"""

from __future__ import annotations

import torch

from ...core.status import CFDError, Status
from ...ops.kernels import rbsor_kernels as sk
from ...ops.kernels.vmem_small import (make_jacobi_vmem_solve,
                                       make_rbsor_vmem_solve,
                                       stationary_solve_plain)
from .base import PoissonParams, PoissonProblem, PoissonResult, PoissonStatus
from .krylov import run_chunked


def _result(x, init_res, res_f, it_f, converged_f):
    """CONVERGED or MAX_ITER from the loop's converged flag (the stats of
    the whole-solve kernels already hold the already-converged rules)."""
    dev = x.device

    def code(s):
        return torch.full((), int(s), dtype=torch.int32, device=dev)

    status = torch.where(converged_f, code(PoissonStatus.CONVERGED),
                         code(PoissonStatus.MAX_ITER))
    return PoissonResult(x=x, iterations=it_f.to(torch.int32),
                         initial_residual=init_res, final_residual=res_f,
                         status=status)


def _consts(problem: PoissonProblem, params: PoissonParams, omega=1.0):
    return sk.SORConsts(*problem.shape, problem.inv_dx2, problem.inv_dy2,
                        problem.inv_dz2, problem.inv_factor, omega,
                        params.check_interval, params.max_iterations)


def _make_plain(sweep, problem, params, omega=1.0):
    c = _consts(problem, params, omega)

    def solve(x, rhs):
        return _result(*stationary_solve_plain(
            x, rhs, c, sweep, params.tolerance, params.absolute_tolerance,
            params.max_iterations))

    return solve


def make_jacobi(problem: PoissonProblem, params: PoissonParams, dtype=None,
                device=None, plain: bool = False):
    """Jacobi as plain tensor code (`stationary.py:84-99`).  It has no
    kernel of its own: ``dtype``, ``device`` and ``plain`` are accepted
    for the makers' common signature."""
    return _make_plain(sk.jacobi_sweep_plain, problem, params)


def make_redblack_sor(problem: PoissonProblem, params: PoissonParams,
                      dtype=None, device=None, plain: bool = False):
    """Red-Black SOR as plain tensor code (`stationary.py:253-278`)."""
    return _make_plain(sk.rb_sweep_plain, problem, params,
                       problem.resolve_omega(params.omega))


# ---- SOR (sequential Gauss-Seidel order) ------------------------------------

def _linear_scan(a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """y[i] = a[i]·y[i−1] + c[i] along the last axis (a[0] multiplies
    nothing): the prefix of the pairs (A, B) = (a, c) under the
    reference's combine ((A₁, B₁), (A₂, B₂)) → (A₁·A₂, A₂·B₁ + B₂)
    (`stationary.py:315-318`), as a Hillis–Steele scan — log2(n) rounds,
    each a few tensor operations over the whole row."""
    n = a.shape[-1]
    s = 1
    while s < n:
        a_r, c_r = a[..., s:], c[..., s:]
        a = torch.cat([a[..., :s], a[..., :-s] * a_r], dim=-1)
        c = torch.cat([c[..., :s], a_r * c[..., :-s] + c_r], dim=-1)
        s *= 2
    return c


def _sor_row_update(x_row, below_new, above_old, rhs_row, z_old_terms,
                    c: sk.SORConsts):
    """One row of row-major SOR (`stationary.py:286-321`,
    `linear_solver_sor.c:100-119`):

      gs[i]    = −(rhs[i] − (x_old[i+1] + x_new[i−1])·inv_dx2
                           − (below_new[i] + above_old[i])·inv_dy2
                           − z_terms[i])·inv_factor
      x_new[i] = (1 − ω)·x_old[i] + ω·gs[i] = a·x_new[i−1] + c[i],

    a = ω·inv_factor·inv_dx2, with the fixed left boundary folded into
    c[1]; a new row."""
    n = x_row.shape[-1]
    omega, inv_factor = c.omega, c.inv_factor
    a = omega * inv_factor * c.inv_dx2
    x_right = torch.roll(x_row, -1, dims=-1)          # x_old[i+1]
    cc = ((1.0 - omega) * x_row
          + omega * inv_factor * (-rhs_row
                                  + x_right * c.inv_dx2
                                  + (below_new + above_old) * c.inv_dy2
                                  + z_old_terms))
    cc[..., 1] = cc[..., 1] + a * x_row[..., 0]
    seg_c = cc[..., 1:n - 1]
    seg_a = torch.full_like(seg_c, a)
    seg_a[..., 0] = 0.0                               # y[1] = c'[1]
    out = x_row.clone()
    out[..., 1:n - 1] = _linear_scan(seg_a, seg_c)
    return out


def _sor_plane(x_plane, below_row0, rhs_plane, z_terms, c: sk.SORConsts):
    """Row-major SOR over one (ny, nx) plane: rows j = 1..ny−2 in order,
    each carrying the previous row's new values (row 0 the boundary's);
    the rows above are the old ones.  ``z_terms`` holds
    (x_old[k+1] + x_new[k−1])·inv_dz2 per point (zeros in 2D)."""
    new = x_plane.clone()
    prev = below_row0
    for j in range(1, x_plane.shape[0] - 1):
        prev = _sor_row_update(x_plane[j], prev, x_plane[j + 1],
                               rhs_plane[j], z_terms[j], c)
        new[j] = prev
    return new


def sor_sweep_plain(x, rhs, c: sk.SORConsts):
    """One SOR sweep in the C loops' order, then the Neumann mirror, a new
    tensor: in 3D the planes k = 1..nz−2 in order, each carrying the
    previous plane's new values (plane 0 the boundary's)."""
    nz = x.shape[0]
    out = x.clone()
    if nz == 1:
        out[0] = _sor_plane(x[0], x[0][0], rhs[0], torch.zeros_like(x[0]),
                            c)
        return sk.neumann_gather(out)
    prev = x[0]
    for k in range(1, nz - 1):
        z_terms = (x[k + 1] + prev) * c.inv_dz2
        prev = _sor_plane(x[k], x[k][0], rhs[k], z_terms, c)
        out[k] = prev
    return sk.neumann_gather(out)


def make_sor(problem: PoissonProblem, params: PoissonParams, dtype=None,
             device=None, plain: bool = False):
    """SOR (and Gauss-Seidel, the same maker) as plain tensor code
    (`stationary.py:323-374`): the common loop on :func:`sor_sweep_plain`,
    ω from ``params.omega`` or, when that is ≤ 0, the optimal one.  It
    has no kernel: ``dtype``, ``device`` and ``plain`` are accepted for
    the makers' common signature."""
    return _make_plain(sor_sweep_plain, problem, params,
                       problem.resolve_omega(params.omega))


def make_redblack_sor_fused(problem: PoissonProblem, params: PoissonParams,
                            dtype=None, device=None, plain: bool = False):
    """Red-Black SOR on the sweep kernel (`stationary.py:126-185`): the
    same sweeps, chunking and status rules as :func:`make_redblack_sor`,
    the residual of each chunk's last sweep from the kernel.  3D grids
    (nz ≥ 3).  On a CUDA device the sweep launches the kernels; on the
    CPU, or with ``plain=True`` on the card, its plain version runs in the
    same loop."""
    if problem.nz < 3:
        raise CFDError(Status.ERROR_INVALID,
                       "the fused Red-Black SOR sweep needs a 3D grid "
                       "(nz >= 3)")
    c = _consts(problem, params, problem.resolve_omega(params.omega))
    max_iter = int(params.max_iterations)
    abs_tol = params.absolute_tolerance

    def solve(x, rhs):
        dev = x.device
        ops = sk.SORPasses(c, dev, plain=plain)
        init_res = sk.residual_inf(x, rhs, c)
        tol = problem.tolerance_for(params, init_res)
        already = init_res < abs_tol
        abs_t = torch.full((), abs_tol, dtype=init_res.dtype, device=dev)
        st = sk.new_state(init_res, tol, abs_t, ~already)
        x = x.clone(memory_format=torch.contiguous_format)  # its own
        solve.host_syncs = run_chunked(max_iter, lambda: ops.sweep(x, rhs,
                                                                   st),
                                       st[sk.RUNNING])
        res = st[sk.RES]
        converged = already | (res < tol) | (res < abs_tol)
        it = torch.where(already, torch.zeros_like(st[sk.IT]), st[sk.IT])
        return _result(x, init_res, torch.where(already, init_res, res), it,
                       converged)

    solve.host_syncs = 0
    return solve


def _make_vmem(maker, problem, params, plain, *extra):
    fn = maker(*problem.shape, problem.inv_dx2, problem.inv_dy2,
               problem.inv_dz2, problem.inv_factor, *extra,
               params.tolerance, params.absolute_tolerance,
               params.max_iterations, params.check_interval, plain=plain)

    def solve(x, rhs):
        return _result(*fn(x, rhs))

    return solve


def make_redblack_sor_vmem(problem: PoissonProblem, params: PoissonParams,
                           dtype=None, device=None, plain: bool = False):
    """The whole Red-Black SOR solve in one kernel launch
    (`stationary.py:217-250`), 2D grids and any nz ≥ 3.  ``plain=True``
    runs its plain version on the card too."""
    return _make_vmem(make_rbsor_vmem_solve, problem, params, plain,
                      problem.resolve_omega(params.omega))


def make_jacobi_vmem(problem: PoissonProblem, params: PoissonParams,
                     dtype=None, device=None, plain: bool = False):
    """The whole Jacobi solve in one kernel launch (`stationary.py:
    188-214`), 2D grids and any nz ≥ 3.  ``plain=True`` as above."""
    return _make_vmem(make_jacobi_vmem_solve, problem, params, plain)
