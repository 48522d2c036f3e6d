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

SOR and Gauss-Seidel (`:286-374`, a row recurrence on
``lax.associative_scan``) are not ported yet: the front end raises for
them.  In float32 the residual, recomputed from x, stalls at a floor of
about eps·‖A‖·‖x‖, as multigrid's does.
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


def _make_plain(kind, problem, params, omega=1.0):
    c = _consts(problem, params, omega)

    def solve(x, rhs):
        return _result(*stationary_solve_plain(
            x, rhs, c, kind, params.tolerance, params.absolute_tolerance,
            params.max_iterations))

    return solve


def make_jacobi(problem: PoissonProblem, params: PoissonParams, dtype=None,
                device=None, plain: bool = False):
    """Jacobi as plain tensor code (`stationary.py:84-99`).  It has no
    kernel of its own: ``dtype``, ``device`` and ``plain`` are accepted
    for the makers' common signature."""
    return _make_plain("jacobi", problem, params)


def make_redblack_sor(problem: PoissonProblem, params: PoissonParams,
                      dtype=None, device=None, plain: bool = False):
    """Red-Black SOR as plain tensor code (`stationary.py:253-278`)."""
    return _make_plain("rbsor", problem, params,
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
