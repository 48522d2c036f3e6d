"""Host-side factors of the DST-fused spectral pressure solves (counterpart
of `cfd_tpu/solvers/poisson/spectral.py:56-85`, `:413-496` and, for 2D,
`:119-130` and `:219-306`).

On a uniform grid the Dirichlet-0 interior Laplacian is diagonalized by
the type-I sine transform in x and y; what remains per (y, x) mode is a
tridiagonal system along z (`ops/kernels/tdma.py`).  The projection step's
two mega kernels apply the forward transform Fy·(b̃·FxT) to each b̃ plane
and the mirror-extended inverse Gy·(x̂·GxT) to each x̂ plane; these
functions make those matrices and the per-mode eigenvalue plane μ in
float64 numpy on the host.

The reference pads the mode dims to multiples of (8, 128) for the TPU's
tiles and runs only where that padding is a no-op.  Here the mode dims
always equal the grid dims: the two spare modes per axis get zero F rows
and zero G columns (their rhs is zero and they solve to zero), so the
transformed planes keep the (ny, nx) shape on every grid.  Where the
reference's gate holds (nx % 128 == 0, ny % 8 == 0) the matrices are the
reference's, entry for entry.
"""

from __future__ import annotations

import numpy as np
import torch

from ...config import resolve_dtype
from ...core.status import CFDError, Status
from ...ops.kernels import rolling, tdma
from .base import PoissonProblem


def _sine_matrix(m: int) -> np.ndarray:
    """Unnormalized DST-I matrix S[a, b] = sin(π(a+1)(b+1)/(m+1));
    S·S = ((m+1)/2)·I."""
    a = np.arange(1, m + 1, dtype=np.float64)
    return np.sin(np.pi * np.outer(a, a) / (m + 1))


def _mirror_extended_inverse(m: int, scale: float) -> np.ndarray:
    """(m+2) × m inverse-DST matrix whose first/last rows duplicate the
    adjacent interior rows: the output carries its own Neumann mirror."""
    G = _sine_matrix(m) * scale
    return np.concatenate([G[:1], G, G[-1:]], axis=0)


def _dirichlet_eigenvalues(m: int, inv_d2: float) -> np.ndarray:
    """Eigenvalues of −d²/dx² (3-point, Dirichlet-0) on m interior points."""
    i = np.arange(1, m + 1, dtype=np.float64)
    return 4.0 * inv_d2 * np.sin(np.pi * i / (2.0 * (m + 1))) ** 2


def _dst_fused_mats(problem: PoissonProblem, np_dt):
    """``(mats, mu, w)``: ``mats = (FxT, Fy, GxT, Gy)`` host numpy
    matrices (forward = Fy·(plane·FxT), inverse = Gy·(plane·GxT), the xy
    normalization folded into Gx), ``mu`` the float64 (ny, nx) per-mode
    eigenvalue plane (spare modes repeat the edge eigenvalue), and
    ``w = 1/dz²``."""
    nx, ny = problem.nx, problem.ny
    mx, my = nx - 2, ny - 2
    lx = _dirichlet_eigenvalues(mx, problem.inv_dx2)
    ly = _dirichlet_eigenvalues(my, problem.inv_dy2)
    w = float(problem.inv_dz2)
    scale = (2.0 / (mx + 1)) * (2.0 / (my + 1))
    mu = (np.pad(ly, (0, ny - my), mode="edge")[:, None]
          + np.pad(lx, (0, nx - mx), mode="edge")[None, :])

    Fx = np.zeros((nx, nx), np_dt)
    Fx[:mx, 1:nx - 1] = _sine_matrix(mx)
    Fy = np.zeros((ny, ny), np_dt)
    Fy[:my, 1:ny - 1] = _sine_matrix(my)
    Gx = np.zeros((nx, nx), np_dt)
    Gx[:, :mx] = _mirror_extended_inverse(mx, scale)
    Gy = np.zeros((ny, ny), np_dt)
    Gy[:, :my] = _mirror_extended_inverse(my, 1.0)
    mats = (np.ascontiguousarray(Fx.T), Fy, np.ascontiguousarray(Gx.T), Gy)
    return mats, mu, w


def make_dst_fused_pieces(problem: PoissonProblem, dtype=None, device=None):
    """Pieces of the DST-fused projection step with the Thomas forward
    sweep fused into the predictor (the reference's ``fuse_fwd=True``):
    ``(mats, (mu, w))`` with ``mats`` the four (FxT, Fy, GxT, Gy) tensors
    and ``mu`` the (ny, nx) eigenvalue plane on ``device`` in ``dtype``,
    ``w = 1/dz²`` a Python float.

    The reference also returns the standalone backward-substitution kernel;
    on the main path (nz ≥ 4) the reverse-march corrector replaces it, so
    the port's counterpart is `ops.kernels.tdma.tdma_z_bwd`, called by the
    corrector itself.  The emit-b̃ + full-TDMA form (``fuse_fwd=False``) is
    not ported yet.
    """
    if not (problem.nz >= 3 and problem.dz > 0.0):
        raise CFDError(Status.ERROR_UNSUPPORTED,
                       "the DST-fused pieces need a 3D problem")
    dt = resolve_dtype(dtype, device)
    np_dt = np.float64 if dt == torch.float64 else np.float32
    mats, mu, w = _dst_fused_mats(problem, np_dt)
    mats_t = tuple(torch.as_tensor(m, dtype=dt, device=device) for m in mats)
    mu_t = torch.as_tensor(mu.astype(np_dt), dtype=dt, device=device)
    return mats_t, (mu_t, w)


# ---- 2D: x-DST pair, y-line Thomas solve and dense low-mode rescue ----------

def _ceil_to(v: int, m: int) -> int:
    return -(-v // m) * m


def _tdma2d_rescue_width(mx: int, lx: np.ndarray, w: float) -> int:
    """Number of low x-modes whose y-line solve is too ill-conditioned for
    a plain f32 Thomas recurrence (the reference's rule, `spectral.py:
    119-130`): condition ≈ 4·inv_dy2/λx[m], rescued where it exceeds 256,
    rounded up to a 128-wide tile, at most mx."""
    k = int(np.searchsorted(lx, 4.0 * w / 256.0))
    return min(_ceil_to(max(k, 1), 128), mx)


def dst2d_fused_supported(problem: PoissonProblem) -> bool:
    """2D with nx, ny ≥ 3.  The reference also asks for its TPU tiles
    (nx % 1024 == 0) and a rescue narrower than mx; with mode dims equal to
    grid dims the port's one form serves every grid."""
    return problem.nz == 1 and problem.nx >= 3 and problem.ny >= 3


def make_dst2d_fused_pieces(problem: PoissonProblem, dtype=None, device=None,
                            plain: bool = False):
    """Pieces of the DST-fused 2D projection step (counterpart of
    `spectral.py:237-306`): ``(FxT, GxT, ysolve)``.

    forward = b̃·FxT and inverse = x̂·GxT (the x normalization folded into
    Gx, the inverse mirror-extended so p carries its Neumann x-shells), both
    (nx, nx) tensors — the two spare modes get zero F rows and zero G
    columns, as in 3D.  ``ysolve(bt_x) → x̂`` on (1, ny, nx)
    transform-space tensors (zero y-shell rows in, mirror-extended y-shell
    rows out): `tdma.tdma_y_2d` on every column, then the K lowest x-modes
    (:func:`_tdma2d_rescue_width`) re-solved densely through the y-DST
    pair, s = Fyp·a[:, :K], s /= (λy ⊗ 1 + 1 ⊗ λx[:K]), x[:, :K] = Gyp·s.
    Without the rescue, f32 Thomas loses about 3 digits on the smooth
    modes.  When K == mx every column is rescued and the Thomas launch is
    skipped (it would do no useful work).

    ``plain=True`` runs the plain versions on a CUDA device too (the
    reference switch of `ops.kernels.projection2d.Projection2DKernels`).
    ``ysolve.line`` = (μ, w) and ``ysolve.rescue`` = (Fyp, Gyp, K) are
    what its stages are called with.
    """
    if not dst2d_fused_supported(problem):
        raise CFDError(Status.ERROR_UNSUPPORTED,
                       "the DST-fused 2D pieces need a 2D problem with "
                       "nx, ny >= 3")
    dt = resolve_dtype(dtype, device)
    np_dt = np.float64 if dt == torch.float64 else np.float32
    nx, ny = problem.nx, problem.ny
    mx, my = nx - 2, ny - 2
    lx = _dirichlet_eigenvalues(mx, problem.inv_dx2)
    ly = _dirichlet_eigenvalues(my, problem.inv_dy2)
    w = float(problem.inv_dy2)
    K = _tdma2d_rescue_width(mx, lx, w)

    Fx = np.zeros((nx, nx), np_dt)
    Fx[:mx, 1:nx - 1] = _sine_matrix(mx)
    Gx = np.zeros((nx, nx), np_dt)
    Gx[:, :mx] = _mirror_extended_inverse(mx, 2.0 / (mx + 1))
    Fyp = np.zeros((my, ny), np_dt)
    Fyp[:, 1:ny - 1] = _sine_matrix(my)
    Gyp = _mirror_extended_inverse(my, 2.0 / (my + 1)).astype(np_dt)

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                               device=device)

    FxT, GxT, Fyp, Gyp = dev(Fx.T), dev(Gx.T), dev(Fyp), dev(Gyp)
    mu = dev(np.pad(lx, (0, nx - mx), mode="edge").astype(np_dt))
    lam = dev(ly)[:, None] + dev(lx[:K])[None, :]
    thomas = K < mx
    if plain:
        line, dot = tdma.tdma_y_2d_reference, rolling.left_dot_plain
    else:
        line, dot = tdma.tdma_y_2d, rolling.left_dot

    def ysolve(bt_x):
        a = bt_x[0]                                        # (ny, nx)
        x = line(a, mu, w) if thomas else torch.zeros_like(a)
        s = dot(Fyp, a[:, :K]) / lam                       # (my, K)
        dot(Gyp, s, out=x[:, :K])                          # (ny, K)
        return x[None]

    # what the stages are called with, for checks of each stage alone
    ysolve.line, ysolve.rescue = (mu, w), (Fyp, Gyp, K)
    return FxT, GxT, ysolve
