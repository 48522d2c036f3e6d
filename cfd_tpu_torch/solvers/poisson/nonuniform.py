"""The variable-coefficient pressure Poisson equation of stretched grids
(counterpart of `cfd_tpu/solvers/poisson/nonuniform.py`).

The consistent scheme (``NSParams(nonuniform_scheme="consistent")``)
discretizes the pressure equation with the exact 3-point nonuniform
Laplacian (`ns.common.consistent_triples`).  Per axis that operator is
L = D⁻¹·S, D the diagonal of cell volumes and S symmetric tridiagonal, so
L is self-adjoint in the volume-weighted inner product ⟨a, b⟩_V = Σ V·a·b:
:class:`NonuniformPoissonProblem` overrides ``laplacian`` and
``dot_interior`` and the unmodified plain Krylov loops (`krylov.make_cg`,
`krylov.make_bicgstab`) solve it.  The same factoring gives a direct
solve: the generalized eigenproblem S·q = λ·D·q has a V-orthonormal basis
Q, so F = Qᵀ·D and G = Q diagonalize L per axis (:func:`nonuniform_
eigenbasis`), the sine transform of the uniform grid being the special
case.  :func:`make_nonuniform_fused_pieces` pads those factors to the
grid's dims for the 3D projection step's kernels, exactly as
`spectral.make_dst_fused_pieces` pads the sines, and
:func:`make_nonuniform_direct` is the direct solve of a (x0, rhs) pair.

z stays uniform (the solvers' rule).  :func:`make_nonuniform_fused_sharded_
pieces` are the z-decomposed twin (`nonuniform.py:262-295`): the same
factors once per device, and the z line solve over the eigenvalue sums
across the shards (`spectral._make_sharded_zsolve`), for the
z-decomposed consistent projection step (`parallel.fused`).
"""

from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np
import torch

from ...config import resolve_dtype
from ...core.status import CFDError, Status
from ...ops.kernels import rolling, tdma
from ...ops.kernels.stretch import triples
from ...ops.stencils import along_x, along_y, interior_index
from . import spectral
from .base import PoissonParams, PoissonProblem, PoissonResult, PoissonStatus


def _axis_weights(gaps):
    """(lm, lc, lp, vol): the consistent Laplacian's weights and the cell
    volumes per point, float64 (`nonuniform.py:47-57`)."""
    _, _, _, lm, lc, lp = triples(gaps)
    h = np.asarray(gaps, np.float64)
    hm = np.concatenate([h[:1], h])
    hp = np.concatenate([h, h[-1:]])
    return lm, lc, lp, (hm + hp) / 2.0


@dataclasses.dataclass(frozen=True)
class NonuniformPoissonProblem(PoissonProblem):
    """A problem with per-axis x/y gap sequences (`nonuniform.py:60-131`).
    ``dx``/``dy`` hold the first gaps; ``x_gaps``/``y_gaps`` the full
    spacing tuples."""

    x_gaps: tuple = ()
    y_gaps: tuple = ()

    @classmethod
    def from_grid(cls, grid):
        return cls(nx=grid.nx, ny=grid.ny, nz=grid.nz, dx=grid.dx0,
                   dy=grid.dy0, dz=(grid.dz0 if grid.nz > 1 else 0.0),
                   x_gaps=tuple(float(g) for g in grid.dx),
                   y_gaps=tuple(float(g) for g in grid.dy))

    @cached_property
    def _wx(self):
        return _axis_weights(self.x_gaps)

    @cached_property
    def _wy(self):
        return _axis_weights(self.y_gaps)

    @cached_property
    def _diag_np(self):
        """diag(−L) as (ny, nx) float64 (z contributes 2/dz²)."""
        return ((-self._wx[1][None, :] - self._wy[1][:, None])
                + 2.0 * self.inv_dz2)

    @cached_property
    def _vol_np(self):
        """(ny, nx) cell volumes normalized to mean 1 over the interior."""
        v = self._wy[3][:, None] * self._wx[3][None, :]
        return v / v[1:-1, 1:-1].mean()

    @property
    def inv_factor(self):
        """1 / diag(−L) per point, (ny, nx) float64 numpy."""
        return 1.0 / self._diag_np

    @cached_property
    def _tensors(self):
        """(dtype, device) -> the tensors :meth:`laplacian` and
        :meth:`dot_interior` read, made once each (a host-to-device copy
        inside an iteration would stall the Krylov loops)."""
        return {}

    def _consts(self, like):
        """((lm, lc, lp) x rows, (lm, lc, lp) y rows, the float64 interior
        volume plane) for ``like``'s dtype and device."""
        key = (like.dtype, like.device)
        if key not in self._tensors:
            def t(a, shape, dtype=like.dtype):
                return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                       device=like.device).reshape(shape)

            vol = self._vol_np[1:-1, 1:-1]
            self._tensors[key] = (
                [t(a[1:-1], (1, 1, -1)) for a in self._wx[:3]],
                [t(a[1:-1], (1, -1, 1)) for a in self._wy[:3]],
                t(vol, vol.shape, torch.float64))
        return self._tensors[key]

    def laplacian(self, x):
        """The consistent Laplacian on the interior, zero on the shell:
        per point (x[i−1]·lm + x·lc) + x[i+1]·lp, plus the same in y, plus
        ((x[k+1] − 2x) + x[k−1])/dz² in 3D (`nonuniform.py:111-125`)."""
        lx, ly, _ = self._consts(x)
        lap = along_x(x, lx) + along_y(x, ly)
        if x.shape[0] > 1:
            i, p, m = slice(1, -1), slice(2, None), slice(None, -2)
            lap = lap + ((x[p, i, i] - 2.0 * x[i, i, i])
                         + x[m, i, i]) * self.inv_dz2
        out = torch.zeros_like(x)
        out[interior_index(x)] = lap
        return out

    def dot_interior(self, a, b):
        """The volume-weighted interior dot, in which the consistent
        operator is self-adjoint; summed in float64 and rounded once to
        a's dtype (a float32 sum loses ⟨r, r⟩ on large grids)."""
        vol = self._consts(a)[2]
        return torch.sum(self.interior(a).double() * self.interior(b).double()
                         * vol).to(a.dtype)


def nonuniform_eigenbasis(gaps):
    """``(lam, F, G)`` (`nonuniform.py:134-161`): the eigenvalues of −L on
    the m = n − 2 interior points of one axis with Dirichlet-0 ends
    (ascending, > 0) and the (m, m) float64 forward and inverse factors,
    x̂ = F·x, x = G·x̂, −L·x = G·diag(lam)·F·x.  From the symmetric form:
    with C = D^½, (C⁻¹SC⁻¹)·U = U·diag(lam), F = Uᵀ·C, G = C⁻¹·U.  The
    signs and order are numpy's ``eigh``'s, as in the reference."""
    h = np.asarray(gaps, np.float64)
    vol = (h[:-1] + h[1:]) / 2.0
    inv_h = 1.0 / h
    S = (np.diag(inv_h[:-1] + inv_h[1:])
         - np.diag(inv_h[1:-1], -1)
         - np.diag(inv_h[1:-1], 1))
    c = np.sqrt(vol)
    lam, U = np.linalg.eigh(S / c[:, None] / c[None, :])
    if lam.shape != (h.size - 1,) or not lam.min() > 0.0:
        raise CFDError(Status.ERROR_INVALID,
                       "nonuniform eigenbasis: the axis operator is not SPD")
    return lam, U.T * c[None, :], U / c[:, None]


def nonuniform_face_coeffs(problem: NonuniformPoissonProblem):
    """``(cxm, cxp, cym, cyp)`` (`nonuniform.py:164-173`): the off-diagonal
    weights toward the dropped shell neighbour at i = 1, i = nx − 2,
    j = 1, j = ny − 2 — the b̃ face term (uniform: all four 1/h²)."""
    nx, ny = problem.nx, problem.ny
    return (float(problem._wx[0][1]), float(problem._wx[2][nx - 2]),
            float(problem._wy[0][1]), float(problem._wy[2][ny - 2]))


def nonuniform_fused_supported(problem: NonuniformPoissonProblem) -> bool:
    """The eigenbasis pieces apply: a genuine 3D problem.  The reference's
    gate adds its kernels' TPU shapes (`nonuniform.py:176-182`); the
    port's kernels run on every size."""
    return problem.nz >= 3 and problem.dz > 0.0


def _nonuniform_fused_mats(problem: NonuniformPoissonProblem, np_dt):
    """``(mats, mu, w)`` (`nonuniform.py:185-212`): ``mats = (FxT, Fy,
    GxT, Gy)`` padded to the grid's dims (zero rows for the shell columns,
    mirror-extended inverse rows, zero columns for the two spare modes),
    ``mu`` the float64 (ny, nx) eigenvalue-sum plane (the spare modes
    repeat the edge eigenvalue), ``w = 1/dz²``."""
    mx, my = problem.nx - 2, problem.ny - 2
    nx, ny = problem.nx, problem.ny
    lx, Fx, Gx = nonuniform_eigenbasis(problem.x_gaps)
    ly, Fy, Gy = nonuniform_eigenbasis(problem.y_gaps)
    mu = (np.pad(ly, (0, ny - my), mode="edge")[:, None]
          + np.pad(lx, (0, nx - mx), mode="edge")[None, :])
    Fxp = np.zeros((nx, nx), np_dt)
    Fxp[:mx, 1:nx - 1] = Fx
    Fyp = np.zeros((ny, ny), np_dt)
    Fyp[:my, 1:ny - 1] = Fy
    Gxp = np.zeros((nx, nx), np_dt)
    Gxp[:, :mx] = np.concatenate([Gx[:1], Gx, Gx[-1:]], axis=0)
    Gyp = np.zeros((ny, ny), np_dt)
    Gyp[:, :my] = np.concatenate([Gy[:1], Gy, Gy[-1:]], axis=0)
    mats = (np.ascontiguousarray(Fxp.T), Fyp, np.ascontiguousarray(Gxp.T),
            Gyp)
    return mats, mu, float(problem.inv_dz2)


def make_nonuniform_fused_pieces(problem: NonuniformPoissonProblem,
                                 dtype=None, device=None):
    """Pieces of the eigenbasis-fused consistent projection step
    (`nonuniform.py:215-259`), the same contract as
    `spectral.make_dst_fused_pieces` with the generalized eigenbasis in
    place of the sines: ``(mats, (mu, w))``, the reference's
    ``fuse_fwd=True`` form (the Thomas forward sweep after b̃, the back
    substitution in the corrector).  The port's kernels run on every
    size, so the reference's second choice (the whole Thomas z-stage
    after b̃) never arises and is not built."""
    if not nonuniform_fused_supported(problem):
        raise CFDError(Status.ERROR_UNSUPPORTED,
                       "the eigenbasis-fused pieces need a 3D problem")
    dt = resolve_dtype(dtype, device)
    np_dt = np.float64 if dt == torch.float64 else np.float32
    mats, mu, w = _nonuniform_fused_mats(problem, np_dt)
    mats_t = tuple(torch.as_tensor(m, dtype=dt, device=device) for m in mats)
    mu_t = torch.as_tensor(mu.astype(np_dt), dtype=dt, device=device)
    return mats_t, (mu_t, w)


def nonuniform_fused_sharded_supported(problem: NonuniformPoissonProblem,
                                       n_shards: int) -> bool:
    """The z-sharded eigenbasis pieces apply (`nonuniform.py:262-268`):
    the uniform DST-fused sharded gate, the factors having the sines'
    shapes."""
    return spectral.dst_fused_sharded_supported(problem, n_shards)


def make_nonuniform_fused_sharded_pieces(problem: NonuniformPoissonProblem,
                                         n_shards: int, comm, dtype=None,
                                         plain: bool = False):
    """z-sharded twin of :func:`make_nonuniform_fused_pieces`
    (`nonuniform.py:271-295`), the contract of
    `spectral.make_dst_fused_sharded_pieces` with the generalized
    eigenbasis in place of the sines: ``(mats, zsolve)``, ``mats`` one
    (FxT, Fy, GxT, Gy) tuple per local shard of ``comm``, on its device
    (the xy transforms stay per shard, plane-local under z
    decomposition); ``zsolve(bt_blocks) → x̂_blocks`` the y-pencil
    ``all_to_all``s around the stored Thomas solve over this shard's rows
    of the eigenvalue-sum plane, ``w = 1/dz²`` (z is uniform).
    ``plain=True`` runs the plain Thomas sweeps on a CUDA device too."""
    return spectral._sharded_pieces(_nonuniform_fused_mats, problem,
                                    n_shards, comm, dtype, plain)


def make_nonuniform_direct(problem: NonuniformPoissonProblem,
                           params: PoissonParams = None, dtype=None,
                           device=None, precision: str = "highest",
                           plain: bool = False):
    """``solve(x0, rhs) -> PoissonResult`` (`nonuniform.py:298-369`): the
    interior Dirichlet-0 system (−L_D)·x = b̃, b̃ = face_coeff·x0 − rhs,
    through the eigenbasis, Neumann shells on output, and the
    CG-convention residual inside x0's mirror shell.  3D (nz ≥ 3) adds the
    uniform-z Thomas solve over the eigenvalue sums; 2D divides by them.

    The x/y products run `ops.kernels.rolling.plane_dot` at ``precision``
    (the hand-written GEMMs on a CUDA tensor, their plain versions on a
    CPU tensor or with ``plain=True``), the Thomas sweeps
    `ops.kernels.tdma`'s kernels; the face term, the divide and the
    residual are plain tensor code, as in the reference."""
    del params
    rolling._check_precision(precision)
    lx, Fx, Gx = nonuniform_eigenbasis(problem.x_gaps)
    ly, Fy, Gy = nonuniform_eigenbasis(problem.y_gaps)
    mu64 = ly[:, None] + lx[None, :]
    w = float(problem.inv_dz2)
    nz, ny, nx = problem.shape
    fxc = np.zeros(nx)
    fxc[1], fxc[nx - 2] = problem._wx[0][1], problem._wx[2][nx - 2]
    fyc = np.zeros(ny)
    fyc[1], fyc[ny - 2] = problem._wy[0][1], problem._wy[2][ny - 2]
    fzc = np.zeros(max(nz, 1))
    if nz > 1:
        fzc[1] = fzc[nz - 2] = w
    coeff64 = fzc[:, None, None] + fyc[None, :, None] + fxc[None, None, :]
    dot = rolling.plane_dot_plain if plain else rolling.plane_dot
    fwd, bwd = ((tdma.tdma_z_fwd_reference, tdma.tdma_z_bwd_reference)
                if plain else (tdma.tdma_z_fwd, tdma.tdma_z_bwd))
    cache = {}

    def consts(x):
        key = (x.dtype, x.device)
        if key not in cache:
            np_dt = np.float64 if x.dtype == torch.float64 else np.float32

            def t(a):
                return torch.as_tensor(np.ascontiguousarray(a, np_dt),
                                       device=x.device)

            cache[key] = (t(Fx.T), t(Fy), t(Gx.T), t(Gy), t(mu64),
                          t(coeff64))
        return cache[key]

    def solve(x0, rhs):
        fxt, fy, gxt, gy, mu, coeff = consts(x0)
        bt = coeff * x0 - rhs
        zi = slice(1, -1) if nz > 1 else slice(None)
        b = bt[zi, 1:-1, 1:-1].contiguous()
        bh = dot(b, fxt, fy, precision)
        if nz > 1:
            pad = torch.zeros_like(bh[:1])
            xh = bwd(*fwd(torch.cat([pad, bh, pad]).contiguous(), mu, w))
            xh = xh[1:-1].contiguous()
        else:
            xh = bh / mu
        xi = dot(xh, gxt, gy, precision)
        x = torch.zeros_like(x0)
        x[zi, 1:-1, 1:-1] = xi
        x = problem.neumann_bc(x)
        xh0 = problem.set_interior(problem.neumann_bc(x0), x)
        r_f = problem.zero_boundary(problem.laplacian(xh0) - rhs)
        res = torch.sqrt(problem.dot_interior(r_f, r_f))
        dev = x.device
        return PoissonResult(
            x=x, iterations=torch.ones((), dtype=torch.int32, device=dev),
            initial_residual=torch.zeros((), dtype=x.dtype, device=dev),
            final_residual=res,
            status=torch.full((), int(PoissonStatus.CONVERGED),
                              dtype=torch.int32, device=dev))

    return solve

