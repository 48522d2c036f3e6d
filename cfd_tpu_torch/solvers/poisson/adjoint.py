"""Reverse-mode-differentiable Poisson solves, the adjoint method
(counterpart of `cfd_tpu/solvers/poisson/adjoint.py`).

The iterative solves are host-driven loops with no reverse rule of their
own.  :func:`make_adjoint_poisson` wraps one in a
``torch.autograd.Function`` whose forward is the unmodified plain maker
(the same iterations and statuses) and whose backward is ONE extra solve
of the same method: the discrete operators are symmetric, so the
transpose solve is the forward solve.

* **Correction-space family** (CG, BiCGSTAB, MULTIGRID, MG-preconditioned
  CG): the solver applies the mirrored-Neumann BC to x0 once, then
  iterates corrections with zero shells, so at convergence
  x_int = lap_D⁻¹(rhs_int − B·x0_int) (``lap_D`` the Dirichlet-0 interior
  Laplacian, ``B`` the mirror's face weights on the ring of cells next to
  the shell, :func:`_mirror_diag`).  The VJP is exact up to the solver's
  tolerance: lam = lap_D⁻¹ fold(x̄) (one solve), rhs̄ = lam, x0̄ = −B·lam,
  ``fold`` the transpose of the final Neumann-shell application
  (:func:`_fold_neumann`).
* **Stationary family** (Jacobi, SOR, Gauss-Seidel, Red-Black SOR): the
  fixed point solves the singular mirrored-Neumann system, so the adjoint
  right-hand side is projected onto the compatible (interior-mean-zero)
  subspace and x0 gets no gradient; exact for gauge-invariant losses.
* **FFT_DIRECT** (matrix products, natively differentiable) and, on a
  nonuniform problem, `nonuniform.make_nonuniform_direct` are returned
  unwrapped.
* **Nonuniform** (consistent-scheme) CG / BiCGSTAB: L = D⁻¹S with S
  symmetric, so the plain-inner-product transpose of the solve is the
  volume conjugation V·L_D⁻¹·V⁻¹ — the same solver, its rhs divided by
  the cell volumes and its output multiplied back.  Other methods raise
  ``ERROR_UNSUPPORTED`` there, with the reference's message.

No method has a backward kernel, in either package: the forward is the
plain maker (plain tensor code on any device) and the backward one more
call of it, both under ``torch.no_grad()``, so their host reads of the
stop flag never sit inside a differentiated graph.
"""

from __future__ import annotations

import numpy as np
import torch

from ...core.status import CFDError, Status
from .base import Method, PoissonParams, PoissonProblem, PoissonResult

#: Methods whose one-shot solve map is x = lap_D⁻¹(rhs − B·x0).
CORRECTION_SPACE_METHODS = frozenset(
    {Method.CG, Method.BICGSTAB, Method.MULTIGRID})
#: Methods converging to the mirrored-Neumann fixed point lap_N x = rhs.
STATIONARY_METHODS = frozenset(
    {Method.JACOBI, Method.GAUSS_SEIDEL, Method.SOR, Method.REDBLACK_SOR})


def _mirror_diag(problem: PoissonProblem) -> np.ndarray:
    """The diagonal of B: per interior cell, the Laplacian's off-diagonal
    weights over the faces it shares with the shell (1/dh² on a uniform
    grid, the consistent face weights on a nonuniform problem); zero
    elsewhere (`adjoint.py:69-95`)."""
    from .nonuniform import NonuniformPoissonProblem, nonuniform_face_coeffs
    if isinstance(problem, NonuniformPoissonProblem):
        cxm, cxp, cym, cyp = nonuniform_face_coeffs(problem)
    else:
        cxm = cxp = problem.inv_dx2
        cym = cyp = problem.inv_dy2
    b = np.zeros(problem.shape)
    b[:, :, 1] += cxm
    b[:, :, -2] += cxp
    b[:, 1, :] += cym
    b[:, -2, :] += cyp
    if problem.nz > 1:
        b[1, :, :] += problem.inv_dz2
        b[-2, :, :] += problem.inv_dz2
        b[0] = b[-1] = 0.0
    b[:, 0, :] = b[:, -1, :] = 0.0
    b[:, :, 0] = b[:, :, -1] = 0.0
    return b


def _fold_neumann(problem: PoissonProblem, xbar: torch.Tensor):
    """The transpose of the final Neumann-shell application: ``neumann_bc``
    is linear, so its VJP at any point is the exact transpose (boundary
    cotangents fold back into their mirror sources)."""
    with torch.enable_grad():
        x = torch.zeros_like(xbar, requires_grad=True)
        (ybar,) = torch.autograd.grad(problem.neumann_bc(x), x, xbar)
    return ybar


class _Solve(torch.autograd.Function):
    """``(x0, rhs) -> (x, iterations, initial_residual, final_residual,
    status)``; only x carries a gradient."""

    @staticmethod
    def forward(ctx, x0, rhs, adj):
        with torch.no_grad():
            res = adj.base(x0, rhs)
        ctx.adj = adj
        extras = (res.iterations, res.initial_residual, res.final_residual,
                  res.status)
        ctx.mark_non_differentiable(*extras)
        return (res.x, *extras)

    @staticmethod
    def backward(ctx, xbar, *_):
        adj = ctx.adj
        with torch.no_grad():
            x0_bar, rhs_bar = adj.vjp(xbar)
        return x0_bar, rhs_bar, None


class _Adjoint:
    """The forward solve and its VJP for one (problem, params, method)."""

    def __init__(self, problem, base, correction, vol_np):
        self.problem, self.base = problem, base
        self.correction = correction
        self.bdiag = _mirror_diag(problem) if correction else None
        self.vol_np = vol_np
        self._tensors = {}
        if problem.nz > 1:
            self.n_interior = ((problem.nz - 2) * (problem.ny - 2)
                               * (problem.nx - 2))
        else:
            self.n_interior = (problem.ny - 2) * (problem.nx - 2)

    def _consts(self, like):
        """(B's diagonal, the volume plane) as ``like``'s dtype and
        device, made once each (None where the method needs none)."""
        key = (like.dtype, like.device)
        if key not in self._tensors:
            self._tensors[key] = tuple(
                None if a is None else torch.as_tensor(
                    a, dtype=like.dtype, device=like.device)
                for a in (self.bdiag, self.vol_np))
        return self._tensors[key]

    def vjp(self, xbar):
        """(x0̄, rhs̄) for the cotangent x̄ of the solve's x: one extra
        solve of the same method (`adjoint.py:160-189`)."""
        problem, base = self.problem, self.base
        bdiag, v = self._consts(xbar)
        ybar = problem.zero_boundary(_fold_neumann(problem, xbar))
        if not self.correction:
            # the singular mirrored-Neumann operator: project onto the
            # compatible subspace (interior mean zero)
            ybar = problem.zero_boundary(ybar - torch.sum(ybar)
                                         / self.n_interior)
        zeros = torch.zeros_like(xbar)
        if v is not None:
            adj = base(zeros, problem.zero_boundary(ybar / v))
            lam = problem.zero_boundary(adj.x * v)
        else:
            lam = problem.zero_boundary(base(zeros, ybar).x)
        x0_bar = -bdiag * lam if self.correction else zeros
        return x0_bar, lam


def make_adjoint_poisson(problem: PoissonProblem,
                         params: PoissonParams = None,
                         method: Method = Method.CG):
    """Build a reverse-differentiable ``solve(x0, rhs) -> PoissonResult``
    (`adjoint.py:117-199`).

    The forward is the unmodified plain solve of ``method`` (the front
    end's maker: the same iteration counts and statuses); the backward
    runs one extra solve of it.  Gradients flow to ``rhs`` and, for the
    correction-space family, exactly to ``x0``.  FFT_DIRECT (and the
    nonuniform direct solve) comes back unwrapped: it is differentiable as
    it is.  The solve runs on the inputs' device and dtype.
    """
    from .frontend import _MAKERS  # late import: the front end imports us
    from .nonuniform import NonuniformPoissonProblem, make_nonuniform_direct

    method = Method(method)
    params = params or PoissonParams()
    nonuniform = isinstance(problem, NonuniformPoissonProblem)
    if method == Method.FFT_DIRECT:
        if nonuniform:
            return make_nonuniform_direct(problem, params, plain=True)
        return _MAKERS[method](problem, params)
    if nonuniform and method not in (Method.CG, Method.BICGSTAB):
        raise CFDError(Status.ERROR_UNSUPPORTED,
                       "adjoint solves on a nonuniform (consistent-scheme) "
                       "problem support FFT_DIRECT/CG/BICGSTAB only")
    adj = _Adjoint(problem, _MAKERS[method](problem, params),
                   method in CORRECTION_SPACE_METHODS,
                   problem._vol_np if nonuniform else None)

    def solve(x0, rhs):
        x, iterations, init_res, final_res, status = _Solve.apply(x0, rhs,
                                                                  adj)
        return PoissonResult(x=x, iterations=iterations,
                             initial_residual=init_res,
                             final_residual=final_res, status=status)

    return solve
