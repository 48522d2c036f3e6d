"""The spectral (DST-I) Poisson solve: the direct solver, its transform
pipelines, and the host-side factors of the DST-fused projection steps
(counterpart of `cfd_tpu/solvers/poisson/spectral.py`).

On a uniform grid the Dirichlet-0 interior Laplacian is diagonalized by
the type-I sine transform, so the pressure solve is direct and exact (to
rounding).  The fixed point CG converges to is (−D)⁻¹(M x₀ − rhs), D the
Dirichlet-0 Laplacian and M the Neumann mirror's face terms, so a solve
is one fused pass b̃ = face_coeff·x − rhs (zero shell), then a transform
pipeline b̃ → x_new whose inverse matrices are mirror-extended: the output
carries its own Neumann shell.

* :func:`make_fft_direct` (`:1158-1216`) — the front end's FFT_DIRECT:
  b̃, the eigen pipeline, and the CG-convention true residual;
* :func:`make_fft_btilde_solver` (`:853-899`) — the raw b̃ → x_new
  transform, ``z_mode`` "eigen" (every axis a DST product and the
  eigenvalue divide, `:771-850`), "tdma" (the last axis a Thomas
  line solve: z in 3D, `:705-768`, y in 2D with the dense low-mode
  rescue, `:133-216`) or "auto";
* :func:`make_dst_fused_pieces`, :func:`make_dst2d_fused_pieces` — the
  factors the projection steps' kernels take (`:413-496`, `:237-307`);
* :func:`make_dst_fused_sharded_pieces` — the z-decomposed step's
  factors and its cross-shard z-solve (`:499-543`, `:668-702`): two
  y-pencil ``all_to_all``s around the call-time-μ Thomas solve;
* :func:`make_dst_fused_sharded_zy_pieces` — the (z, y)-decomposed
  step's x-DST factors and its cross-shard y/z solve (`:545-665`): four
  per-axis ``all_to_all``s around the dense z stage and the y stage;
* :func:`make_dst2d_fused_sharded_pieces` — the y-decomposed 2D step's
  x-DST factors and its cross-shard y solve (`:326-395`): two
  ``all_to_all``s around the dense y-eigen solve on x-mode slabs.

The DST and z products run through `ops.kernels.rolling` at the caller's
precision, ``"highest"`` (IEEE fp32), ``"high"`` (3xTF32) or
``"default"`` (one TF32 pass): on a CUDA tensor the hand-written SGEMM
(``csrc/sgemm_fp32.cu``), 3xTF32 GEMM (``csrc/gemm_3xtf32.cu``) or
one-pass TF32 GEMM (``csrc/gemm_tf32.cu``; for each, factors with rows
off 16 bytes are stored padded, :func:`_tma_rows`), on a CPU tensor (or
with ``plain``) the plain version.  (The reference computes the pipelines'
products as jnp matmuls outside any Pallas kernel.)  The Thomas stages
run the z-line kernels of `ops.kernels.tdma`.

The reference pads the mode dims to multiples of (8, 128) — 1024 for the
2D y-stage — for the TPU's tiles, and gates its Thomas stages on those
shapes and on VMEM.  Here the mode dims always equal the grid dims: the
two spare modes per axis get zero F rows and zero G columns (their rhs is
zero and they solve to zero; their eigenvalue repeats the edge one, so
the divide stays finite), so the transformed arrays keep the grid's shape
on every grid, and only the geometric conditions gate the stages.  Where
the reference's gate holds (nx % 128 == 0, ny % 8 == 0) the fused step's
matrices are the reference's, entry for entry.  Matrices and eigenvalue
arrays are built in float64 numpy and cast once, per input dtype and
device on first use.
"""

from __future__ import annotations

import numpy as np
import torch

from ...config import resolve_dtype
from ...core.status import CFDError, Status
from ...ops.kernels import rolling, tdma
from .base import PoissonParams, PoissonProblem, PoissonResult, PoissonStatus


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


def _face_coeff(m: int, inv_d2: float) -> np.ndarray:
    """Per-index mirror coefficient along one axis: inv_d2 at the two
    interior faces (summed when m == 1), zero elsewhere."""
    c = np.zeros(m)
    c[0] += inv_d2
    c[-1] += inv_d2
    return c


def spectral_supported(problem: PoissonProblem) -> bool:
    """2D (nz == 1) or genuine 3D (nz ≥ 3 with dz > 0)."""
    return problem.nz == 1 or (problem.nz >= 3 and problem.dz > 0.0)


def tdma_z_supported(problem: PoissonProblem) -> bool:
    """The Thomas z-stage applies: a genuine 3D problem (the reference's
    lane, sublane and VMEM gates are TPU ones and are not kept)."""
    return problem.nz >= 3 and problem.dz > 0.0


def _padded_forward(m: int, n: int, np_dt) -> np.ndarray:
    """(n, n) forward DST: rows :m the sines on columns 1..n−2, zero rows
    for the two spare modes and zero boundary columns."""
    F = np.zeros((n, n), np_dt)
    F[:m, 1:n - 1] = _sine_matrix(m)
    return F


def _padded_inverse(m: int, n: int, scale: float, np_dt) -> np.ndarray:
    """(n, n) mirror-extended inverse DST, zero columns for the spare
    modes."""
    G = np.zeros((n, n), np_dt)
    G[:, :m] = _mirror_extended_inverse(m, scale)
    return G


def _edge_padded(v: np.ndarray, n: int) -> np.ndarray:
    return np.pad(v, (0, n - v.shape[0]), mode="edge")


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
    scale = (2.0 / (mx + 1)) * (2.0 / (my + 1))
    mu = _edge_padded(ly, ny)[:, None] + _edge_padded(lx, nx)[None, :]
    mats = (np.ascontiguousarray(_padded_forward(mx, nx, np_dt).T),
            _padded_forward(my, ny, np_dt),
            np.ascontiguousarray(_padded_inverse(mx, nx, scale, np_dt).T),
            _padded_inverse(my, ny, 1.0, np_dt))
    return mats, mu, float(problem.inv_dz2)


def make_dst_fused_pieces(problem: PoissonProblem, dtype=None, device=None,
                          fuse_fwd: bool = True):
    """Pieces of the DST-fused projection step, on ``device`` in ``dtype``.

    With ``fuse_fwd=True`` (the Thomas forward sweep fused into the
    predictor, the form the step runs): ``(mats, (mu, w))`` with
    ``mats`` the four (FxT, Fy, GxT, Gy) tensors, ``mu`` the (ny, nx)
    eigenvalue plane and ``w = 1/dz²`` a Python float.  The reference
    also returns the standalone back substitution; the port's is
    `ops.kernels.tdma.tdma_z_bwd` (or its analytic twin), which the
    corrector calls itself.

    With ``fuse_fwd=False`` (the emit-b̃ form, `spectral.py:477-496`):
    ``(mats, zsolve)``, ``zsolve(bxy) → x̂`` the whole Thomas z-stage
    (`ops.kernels.tdma.make_tdma_z`, stored) on (nz, ny, nx)
    transform-space tensors, mirror z-shells on output.
    """
    if not tdma_z_supported(problem):
        raise CFDError(Status.ERROR_UNSUPPORTED,
                       "the DST-fused pieces need a 3D problem")
    dt = resolve_dtype(dtype, device)
    np_dt = np.float64 if dt == torch.float64 else np.float32
    mats, mu, w = _dst_fused_mats(problem, np_dt)
    mats_t = tuple(torch.as_tensor(m, dtype=dt, device=device) for m in mats)
    if not fuse_fwd:
        return mats_t, tdma.make_tdma_z(problem.nz, problem.ny, problem.nx,
                                        mu, w, dt, device)
    mu_t = torch.as_tensor(mu.astype(np_dt), dtype=dt, device=device)
    return mats_t, (mu_t, w)


# ---- the z-decomposed DST-fused pieces ----------------------------------------

def dst_fused_sharded_supported(problem: PoissonProblem,
                                n_shards: int) -> bool:
    """The z-sharded DST-fused projection applies (counterpart of
    `spectral.py:499-511`): a 3D problem, nz and ny divisible by the shard
    count (the y-pencil transposes) and at least two planes a shard.  The
    reference's TPU gates (nx % 128, ny % 8, its Thomas kernel's shapes)
    are not kept: the port's mode dims always equal the grid dims."""
    P = int(n_shards)
    return (tdma_z_supported(problem) and P >= 1 and problem.nz % P == 0
            and problem.ny % P == 0 and problem.nz // P >= 2)


def make_dst_fused_sharded_pieces(problem: PoissonProblem, n_shards: int,
                                  comm, dtype=None, plain: bool = False):
    """z-sharded twin of :func:`make_dst_fused_pieces` (`spectral.py:
    514-543`), for the shards ``comm`` holds (`parallel.comm`): the xy
    DSTs stay per shard (plane-local under z decomposition), and the z
    line solve is the only cross-shard stage.

    Returns ``(mats, zsolve)``: ``mats`` one (FxT, Fy, GxT, Gy) tuple per
    local shard, on its device; ``zsolve(bt_blocks) → x̂_blocks`` takes
    each local shard's (nz/P, ny, nx) xy-transformed b̃ (zero global
    z-shell planes) and returns x̂ in the same layout, with the mirror
    global z-shells on the edge shards' owned planes.  ``plain=True`` runs
    the plain Thomas sweeps on a CUDA device too."""
    return _sharded_pieces(_dst_fused_mats, problem, n_shards, comm, dtype,
                           plain)


def _sharded_pieces(make_mats, problem: PoissonProblem, n_shards: int, comm,
                    dtype, plain: bool):
    """``(mats, zsolve)`` of a z-sharded transform-fused projection from
    ``make_mats(problem, np_dt) → (mats, mu, w)``: the four factors once
    per device of ``comm`` (shards on one device share them) and the
    z line solve over ``mu`` (:func:`_make_sharded_zsolve`).  Raises
    ``ERROR_UNSUPPORTED`` outside :func:`dst_fused_sharded_supported`."""
    P = int(n_shards)
    if not dst_fused_sharded_supported(problem, P):
        raise CFDError(Status.ERROR_UNSUPPORTED,
                       f"the transform-fused sharded pieces need a 3D "
                       f"problem with nz and ny divisible by {P} shards "
                       f"and >= 2 planes a shard (got nz={problem.nz}, "
                       f"ny={problem.ny})")
    devices = [torch.device(d) for d in comm.devices]
    dt = resolve_dtype(dtype, devices[0])
    np_dt = np.float64 if dt == torch.float64 else np.float32
    mats, mu, w = make_mats(problem, np_dt)
    per_device = {}
    for d in devices:
        if d not in per_device:
            per_device[d] = tuple(torch.as_tensor(m, dtype=dt, device=d)
                                  for m in mats)
    zsolve = _make_sharded_zsolve(mu.astype(np_dt), w, problem.nz,
                                  problem.ny, problem.nx, P, comm, dt,
                                  plain)
    return [per_device[d] for d in devices], zsolve


def _make_sharded_zsolve(mu_host, w, nz, ny, nx, P, comm, dtype,
                         plain: bool = False):
    """The shared z-line-solve stage of the sharded transform-fused
    projections (`spectral.py:668-702`): an ``all_to_all`` into
    (nz, ny/P, nx) y-pencils, the stored Thomas solve with this shard's
    rows of the (ny, nx) eigenvalue plane ``mu_host`` given at call time
    (`ops.kernels.tdma.make_tdma_z` with ``mu=None``; the rows cut once,
    here), and the ``all_to_all`` back."""
    nyl = ny // P
    run = tdma.make_tdma_z(nz, nyl, nx, None, w)
    mu_rows = [torch.as_tensor(mu_host[i * nyl:(i + 1) * nyl], dtype=dtype,
                               device=d)
               for i, d in zip(comm.shards, comm.devices)]

    def solve(a, mu_loc):
        if plain:
            return tdma.tdma_z_reference(a, mu_loc, w)
        return run(a, mu_loc)

    def zsolve(bt_blocks):
        a = (comm.all_to_all(bt_blocks, 1, 0) if P > 1
             else list(bt_blocks))
        x = [solve(ai, mi) for ai, mi in zip(a, mu_rows)]
        return comm.all_to_all(x, 0, 1) if P > 1 else x

    zsolve.mu_rows, zsolve.w = mu_rows, w
    return zsolve


# ---- the (z, y)-decomposed DST-fused pieces ---------------------------------

def dst_fused_sharded_zy_supported(problem: PoissonProblem, n_z: int,
                                   n_y: int) -> bool:
    """The (z, y)-mesh DST-fused projection applies (counterpart of
    `spectral.py:545-562`): a 3D problem, nz and ny divisible by the
    mesh's z and y shard counts with at least two planes and two rows a
    shard (the predictor's 2-deep halos), and nx divisible by Pz (the
    x-mode split of the y/z solve's transposes).  The reference's TPU
    gates (nx % 128, ny % 8, a multiple of 8 rows a shard) are not kept:
    the port's mode dims equal the grid dims on every grid."""
    pz, py = int(n_z), int(n_y)
    return (tdma_z_supported(problem) and pz >= 1 and py >= 1
            and problem.nz % pz == 0 and problem.ny % py == 0
            and problem.nz // pz >= 2 and problem.ny // py >= 2
            and problem.nx % pz == 0)


def make_dst_fused_sharded_zy_pieces(problem: PoissonProblem, n_z: int,
                                     n_y: int, comm, dtype=None,
                                     precision: str = "highest",
                                     plain: bool = False):
    """(z, y)-mesh twin of :func:`make_dst_fused_sharded_pieces`
    (`spectral.py:565-665`) for the shards ``comm`` holds on its (Pz, Py)
    grid.  Under y decomposition only the x DST is row-local, so only
    the x transforms stay in the shards' local stages.  Returns
    ``(mats_x, yzsolve)``:

    * ``mats_x`` — one (FxT, GxT) pair per local shard, on its device:
      forward x̃ = b̃·FxT and inverse p = x̂·GxT on every row, the whole
      xy normalization folded into GxT (the factors of
      :func:`make_dst_fused_pieces`);
    * ``yzsolve(bt_blocks) → x̂_blocks`` — the cross-shard stage on each
      shard's (nz/Pz, ny/Py, nx) x-transform-space block (zero global
      z-shell planes): four per-axis ``all_to_all``s re-pencil between
      the dense z stage (Fz, then Gz with the z normalization, the
      z modes zero-padded to mzp, a multiple of Py) and the y stage (Fy,
      ÷ λ, Gy).  The output keeps x-transform space and carries the
      global z and y mirror shells on the edge shards' owned planes and
      rows.

    The products are the GEMM wrappers' at ``precision`` (``rolling.
    left_dot``; the reference's XLA einsums at the step's precision), or
    their plain versions with ``plain``; the eigenvalue sums λ = (λz + λy)
    + λx are formed once per shard in the working dtype (the padded x
    and z modes take 1, so 0 / 1 stays 0 there).  The dense z stage
    follows the reference, not the Thomas solve of the z-only step."""
    pz, py = int(n_z), int(n_y)
    if not dst_fused_sharded_zy_supported(problem, pz, py):
        raise CFDError(Status.ERROR_UNSUPPORTED,
                       f"the DST-fused (z, y) pieces need a 3D problem with "
                       f"nz divisible by {pz} and ny by {py} (>= 2 planes "
                       f"and rows a shard) and nx by {pz} (got "
                       f"nz={problem.nz}, ny={problem.ny}, "
                       f"nx={problem.nx})")
    devices = [torch.device(d) for d in comm.devices]
    dt = resolve_dtype(dtype, devices[0])
    np_dt = np.float64 if dt == torch.float64 else np.float32
    mats, _, _ = _dst_fused_mats(problem, np_dt)
    nx, ny, nz = problem.nx, problem.ny, problem.nz
    mx, my, mz = nx - 2, ny - 2, nz - 2
    mzp = -(-mz // py) * py
    cx, cz = nx // pz, mzp // py
    lx = np.ones(nx)
    lx[:mx] = _dirichlet_eigenvalues(mx, problem.inv_dx2)
    ly = _dirichlet_eigenvalues(my, problem.inv_dy2)
    lz = np.ones(mzp)
    lz[:mz] = _dirichlet_eigenvalues(mz, problem.inv_dz2)
    host = {
        "fy": np.pad(_sine_matrix(my), ((0, 0), (1, 1))),         # (my, ny)
        "gy": _mirror_extended_inverse(my, 1.0),                   # (ny, my)
        "fz": np.pad(_sine_matrix(mz), ((0, mzp - mz), (1, 1))),  # (mzp, nz)
        "gz": np.pad(_mirror_extended_inverse(mz, 2.0 / (mz + 1)),
                     ((0, 0), (0, mzp - mz)))}                     # (nz, mzp)

    def dev(a, d):
        return torch.as_tensor(np.ascontiguousarray(a).astype(np_dt),
                               dtype=dt, device=d)

    per_device = {}
    for d in devices:
        if d not in per_device:
            per_device[d] = ({k: _tma_rows(dev(v, d), precision)
                              for k, v in host.items()},
                             (dev(mats[0], d), dev(mats[2], d)))
    lam = []
    for s, d in zip(comm.shards, devices):
        zi, yi = comm.coords(s)
        vz = dev(lz[yi * cz:(yi + 1) * cz], d)
        vx = dev(lx[zi * cx:(zi + 1) * cx], d)
        lam.append((vz[:, None, None] + dev(ly, d)[None, :, None])
                   + vx[None, None, :])
    factors = [per_device[d][0] for d in devices]
    left_dot = _products(plain)[2]

    def z_dot(m, a):
        """``m · a`` along dim 0 of a (k, ny_, nx_) block."""
        k, r, c = a.shape
        return left_dot(m, a.reshape(k, r * c),
                        precision=precision).reshape(m.shape[0], r, c)

    def a2a(blocks, axis, split, concat):
        if (pz if axis == "z" else py) == 1:
            return list(blocks)
        return comm.all_to_all(blocks, split, concat, axis)

    def yzsolve(bt_blocks):
        a = a2a(bt_blocks, "z", 2, 0)                      # (nz, nyl, cx)
        a = [z_dot(f["fz"], b) for f, b in zip(factors, a)]   # (mzp, ...)
        a = a2a(a, "y", 0, 1)                              # (cz, ny, cx)
        a = [left_dot(f["gy"], left_dot(f["fy"], b, precision=precision)
                      / lm, precision=precision)
             for f, b, lm in zip(factors, a, lam)]         # (cz, ny, cx)
        a = a2a(a, "y", 1, 0)                              # (mzp, nyl, cx)
        a = [z_dot(f["gz"], b) for f, b in zip(factors, a)]   # (nz, ...)
        return a2a(a, "z", 0, 2)                           # (nzl, nyl, nx)

    return [per_device[d][1] for d in devices], yzsolve


def _tma_rows(t: torch.Tensor, precision: str) -> torch.Tensor:
    """A 2D float32 constant of the spectral products, stored with its
    rows padded to a multiple of 4 floats (16 bytes) and returned as a
    view of its own shape, so that the GEMM of every precision (the
    SGEMM, `csrc/sgemm_fp32.cu`; the 3xTF32 GEMM, `csrc/gemm_3xtf32.cu`;
    the one-pass GEMM, `csrc/gemm_tf32.cu`) loads it by TMA: the (ny, my)
    and (nz, mz) inverse factors have rows of 2046 floats at 2048² and
    510 at 512³.  K and every value are unchanged (the plain versions
    multiply the packed copy); other dtypes take ``t`` as it is."""
    r, c = t.shape
    c4 = -(-c // 4) * 4
    if precision not in ("highest", "high", "default") \
            or t.dtype != torch.float32 or c4 == c:
        return t
    buf = t.new_zeros((r, c4))
    buf[:, :c] = t
    return buf[:, :c]


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


def tdma_y_supported(problem: PoissonProblem) -> bool:
    """The 2D Thomas y-stage applies wherever the fused 2D pieces do (the
    reference's 1024-wide mode padding and VMEM gate are not kept)."""
    return dst2d_fused_supported(problem)


def make_dst2d_fused_pieces(problem: PoissonProblem, dtype=None, device=None,
                            plain: bool = False,
                            precision: str = "highest"):
    """Pieces of the DST-fused 2D projection step (counterpart of
    `spectral.py:237-306`): ``(FxT, GxT, ysolve)``.

    forward = b̃·FxT and inverse = x̂·GxT (the x normalization folded into
    Gx, the inverse mirror-extended so p carries its Neumann x-shells), both
    (nx, nx) tensors — the two spare modes get zero F rows and zero G
    columns, as in 3D.  ``ysolve(bt_x) → x̂`` on (1, ny, nx)
    transform-space tensors (zero y-shell rows in, mirror-extended y-shell
    rows out): `tdma.tdma_y_2d` on every column (on the card with the rec
    and t planes of `tdma.tdma_y2d_planes`, built here once), then the K
    lowest x-modes (:func:`_tdma2d_rescue_width`) re-solved densely
    through the y-DST pair, s = Fyp·a[:, :K], s /= (λy ⊗ 1 + 1 ⊗ λx[:K]),
    x[:, :K] = Gyp·s,
    its two products at ``precision`` ("highest", "high" or "default";
    the reference's jnp matmuls at the step's precision) through
    `rolling.rescue_dot`, the divide fused into the first.  Without the
    rescue, f32 Thomas loses about 3 digits on the smooth modes.  When
    K == mx every column is rescued and the Thomas launch is skipped (it
    would do no useful work).

    ``plain=True`` runs the plain versions on a CUDA device too (the
    reference switch of `ops.kernels.projection2d.Projection2DKernels`).
    ``ysolve.line`` = (μ, w), ``ysolve.planes`` (the rec and t planes, or
    None), ``ysolve.rescue`` = (Fyp, Gyp, K) and ``ysolve.lam`` (λ,
    (my, K)) are what its stages are called with.
    """
    if not dst2d_fused_supported(problem):
        raise CFDError(Status.ERROR_UNSUPPORTED,
                       "the DST-fused 2D pieces need a 2D problem with "
                       "nx, ny >= 3")
    rolling._check_precision(precision)
    dt = resolve_dtype(dtype, device)
    np_dt = np.float64 if dt == torch.float64 else np.float32
    nx, ny = problem.nx, problem.ny
    mx, my = nx - 2, ny - 2
    lx = _dirichlet_eigenvalues(mx, problem.inv_dx2)
    ly = _dirichlet_eigenvalues(my, problem.inv_dy2)
    w = float(problem.inv_dy2)
    K = _tdma2d_rescue_width(mx, lx, w)

    Fyp = np.zeros((my, ny), np_dt)
    Fyp[:, 1:ny - 1] = _sine_matrix(my)
    Gyp = _mirror_extended_inverse(my, 2.0 / (my + 1)).astype(np_dt)

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                               device=device)

    FxT = dev(_padded_forward(mx, nx, np_dt).T)
    GxT = dev(_padded_inverse(mx, nx, 2.0 / (mx + 1), np_dt).T)
    Fyp, Gyp = (_tma_rows(dev(m), precision) for m in (Fyp, Gyp))
    mu = dev(_edge_padded(lx, nx).astype(np_dt))
    lam = dev(ly)[:, None] + dev(lx[:K])[None, :]
    thomas = K < mx
    # the kernel's rec and t planes, built once (they do not depend on the
    # data): the y-line kernel's forward row then carries no divide
    planes = None
    if thomas and not plain and mu.is_cuda and dt == torch.float32:
        planes = tdma.tdma_y2d_planes(mu, w, ny)
    if plain:
        line, dot = tdma.tdma_y_2d_reference, rolling.rescue_dot_plain
    else:
        line, dot = tdma.tdma_y_2d, rolling.rescue_dot

    def ysolve(bt_x):
        a = bt_x[0]                                        # (ny, nx)
        if not thomas:
            x = torch.zeros_like(a)
        elif planes is None:
            x = line(a, mu, w)
        else:
            x = line(a, mu, w, planes=planes)
        s = dot(Fyp, a[:, :K], lam, precision=precision)   # (my, K)
        dot(Gyp, s, out=x[:, :K], precision=precision)     # (ny, K)
        return x[None]

    # what the stages are called with, for checks of each stage alone
    ysolve.line, ysolve.rescue = (mu, w), (Fyp, Gyp, K)
    ysolve.planes, ysolve.lam = planes, lam
    return FxT, GxT, ysolve


# ---- 2D, y-decomposed: the x-DST pair and the slab y-eigen solve -------------

def dst2d_fused_sharded_supported(problem: PoissonProblem,
                                  n_shards: int) -> bool:
    """The y-sharded DST-fused 2D projection applies (counterpart of
    `spectral.py:309-323`): a 2D problem, ny divisible by the shard count
    with at least two rows a shard (the predictor's 2-deep halos), and nx
    divisible by it (the x-mode slabs of the y solve's transposes).  The
    reference's TPU gates (nx % 1024, a multiple of 8 and >= 24 rows a
    shard, nx/P % 128) are not kept: the port's mode dims equal the grid
    dims on every grid.  Where nx is not divisible the reference takes its
    pencil fallback, which is not ported."""
    P = int(n_shards)
    return (dst2d_fused_supported(problem) and P >= 1
            and problem.ny % P == 0 and problem.ny // P >= 2
            and problem.nx % P == 0)


def make_dst2d_fused_sharded_pieces(problem: PoissonProblem, n_shards: int,
                                    comm, dtype=None,
                                    precision: str = "highest",
                                    plain: bool = False):
    """y-sharded twin of :func:`make_dst2d_fused_pieces`
    (`spectral.py:326-395`) for the shards ``comm`` holds on its y axis.
    The x DST is row-local, so it stays in the shards' local stages; the
    y line solve is the only cross-shard stage.  Returns ``(mats_x,
    ysolve)``:

    * ``mats_x`` — one (FxT, GxT) pair per local shard, on its device
      (forward x̃ = b̃·FxT, inverse p = x̂·GxT with the x normalization
      and the mirror x-shells folded into GxT), the factors of
      :func:`make_dst2d_fused_pieces`;
    * ``ysolve(bt_blocks) → x̂_blocks`` — on each shard's (1, ny/P, nx)
      x-transformed b̃ (zero global y-shell rows): an ``all_to_all`` over
      ``"y"`` into (ny, nx/P) x-mode slabs, the dense y-eigen solve
      s = Fyp·a, s /= (λy ⊗ 1 + 1 ⊗ λx[slab]), x̂ = Gyp·s, and the
      ``all_to_all`` back; x̂ keeps x-transform space and carries the
      global mirror y-shells on the edge shards' owned rows.

    The two slab products go through ``rolling.left_dot`` at
    ``precision`` ("highest": the SGEMM, "high": 3xTF32; the reference's
    XLA matmuls at the step's precision), or their plain versions with
    ``plain``.  Unlike the single-device stage (Thomas + dense low-mode
    rescue) the slab stage is the plain eigen contraction on every
    column, as the reference's, so a sharded step equals the
    single-device step to rounding, not bit for bit.  One shard runs the
    same slab solve (the all_to_all is the identity), where the
    reference returns its single-device pieces."""
    P = int(n_shards)
    if not dst2d_fused_sharded_supported(problem, P):
        raise CFDError(Status.ERROR_UNSUPPORTED,
                       f"the DST-fused sharded 2D pieces need a 2D problem "
                       f"with ny divisible by {P} shards (>= 2 rows a "
                       f"shard) and nx by {P} (got ny={problem.ny}, "
                       f"nx={problem.nx})")
    rolling._check_precision(precision)
    devices = [torch.device(d) for d in comm.devices]
    dt = resolve_dtype(dtype, devices[0])
    np_dt = np.float64 if dt == torch.float64 else np.float32
    nx, ny = problem.nx, problem.ny
    mx, my = nx - 2, ny - 2
    nxl = nx // P
    lx = _edge_padded(_dirichlet_eigenvalues(mx, problem.inv_dx2), nx)
    ly = _dirichlet_eigenvalues(my, problem.inv_dy2)
    host = {"fxt": _padded_forward(mx, nx, np_dt).T,
            "gxt": _padded_inverse(mx, nx, 2.0 / (mx + 1), np_dt).T,
            "fy": np.pad(_sine_matrix(my), ((0, 0), (1, 1))),      # (my, ny)
            "gy": _mirror_extended_inverse(my, 2.0 / (my + 1))}    # (ny, my)

    def dev(a, d):
        return torch.as_tensor(np.ascontiguousarray(a).astype(np_dt),
                               dtype=dt, device=d)

    per_device = {}
    for d in devices:
        if d not in per_device:
            per_device[d] = {k: _tma_rows(dev(v, d), precision)
                             if k in ("fy", "gy") else dev(v, d)
                             for k, v in host.items()}
    factors = [per_device[d] for d in devices]
    lam = []
    for s_, d in zip(comm.shards, devices):
        yi = comm.coords(s_)[1]
        lam.append(dev(ly, d)[:, None]
                   + dev(lx[yi * nxl:(yi + 1) * nxl], d)[None, :])
    left_dot = _products(plain)[2]

    def ysolve(bt_blocks):
        a = (comm.all_to_all(bt_blocks, 2, 1, "y") if P > 1
             else list(bt_blocks))                       # (1, ny, nx/P)
        x = [left_dot(f["gy"], left_dot(f["fy"], b[0], precision=precision)
                      / lm, precision=precision)[None]
             for f, b, lm in zip(factors, a, lam)]       # (1, ny, nx/P)
        return comm.all_to_all(x, 1, 2, "y") if P > 1 else x

    return [(f["fxt"], f["gxt"]) for f in factors], ysolve


# ---- the transform pipelines and the direct solver ---------------------------

def _per_input(build):
    """``get(t)``: ``build(dtype, device)`` for the input tensor ``t``,
    built on first use and kept (the reference builds its matrices per
    input dtype the same way)."""
    built = {}

    def get(t):
        key = (t.dtype, t.device)
        if key not in built:
            built[key] = build(t.dtype, t.device)
        return built[key]

    return get


def _products(plain: bool):
    """The GEMM wrappers (plane_dot, right_dot, left_dot), or with
    ``plain`` their plain versions, which also run on a CUDA tensor."""
    if plain:
        return (rolling.plane_dot_plain, rolling.right_dot_plain,
                rolling.left_dot_plain)
    return rolling.plane_dot, rolling.right_dot, rolling.left_dot


def _make_btilde_pipeline(problem: PoissonProblem, precision: str,
                          plain: bool = False):
    """The eigen transform (`spectral.py:771-850`): full-shape zero-shell
    b̃ → full-shape x_new.  Every axis is a DST product — x and y through
    `rolling.plane_dot` (3D) or `right_dot` / `left_dot` (2D), z through
    `left_dot` on the (nz, ny·nx) view — then the divide by the
    eigenvalue sums, then the mirror-extended inverses in the reference's
    order (x, y, z), all 1/(m+1) normalizations folded into Gx.  With
    ``plain`` the products are the plain versions on any device."""
    plane_dot, right_dot, left_dot = _products(plain)
    is_3d = problem.nz > 1
    nx, ny, nz = problem.nx, problem.ny, problem.nz
    mx, my = nx - 2, ny - 2
    mz = nz - 2 if is_3d else 1
    lx = _dirichlet_eigenvalues(mx, problem.inv_dx2)
    ly = _dirichlet_eigenvalues(my, problem.inv_dy2)
    lz = _dirichlet_eigenvalues(mz, problem.inv_dz2) if is_3d else None
    scale = (2.0 / (mx + 1)) * (2.0 / (my + 1))
    if is_3d:
        scale *= 2.0 / (mz + 1)

    def build(dt, device):
        np_dt = np.float64 if dt == torch.float64 else np.float32

        def dev(a):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                                   device=device)

        f = {"fxt": dev(_padded_forward(mx, nx, np_dt).T),
             "fy": dev(_padded_forward(my, ny, np_dt)),
             "gxt": dev(_padded_inverse(mx, nx, scale, np_dt).T),
             "gy": dev(_padded_inverse(my, ny, 1.0, np_dt))}
        vx = dev(_edge_padded(lx, nx).astype(np_dt))
        vy = dev(_edge_padded(ly, ny).astype(np_dt))
        if is_3d:
            f["fz"] = dev(_padded_forward(mz, nz, np_dt))
            f["gz"] = dev(_padded_inverse(mz, nz, 1.0, np_dt))
            vz = dev(_edge_padded(lz, nz).astype(np_dt))
            f["lam"] = (vz[:, None, None] + vy[None, :, None]) \
                + vx[None, None, :]
        else:
            f["lam"] = vy[:, None] + vx[None, :]
        return f

    factors = _per_input(build)

    def z_dot(m, a):
        return left_dot(m, a.reshape(nz, -1),
                        precision=precision).reshape(a.shape)

    def pipeline(btilde):
        f = factors(btilde)
        if not is_3d:
            a = right_dot(btilde[0], f["fxt"], precision)
            a = left_dot(f["fy"], a, precision=precision)
            a = left_dot(f["gy"], a / f["lam"], precision=precision)
            return right_dot(a, f["gxt"], precision)[None]
        a = z_dot(f["fz"], plane_dot(btilde, f["fxt"], f["fy"], precision))
        a = plane_dot(a / f["lam"], f["gxt"], f["gy"], precision)
        return z_dot(f["gz"], a)

    return pipeline


def _make_btilde_pipeline_tdma(problem: PoissonProblem, precision: str,
                               plain: bool = False):
    """The Thomas z-stage transform (`spectral.py:705-768`): the xy DST,
    the z-line Thomas solve (`tdma_z_fwd` + `tdma_z_bwd`, stored), the
    inverse xy DST, on the factors of :func:`make_dst_fused_pieces`; with
    ``plain`` the plain products and sweeps on any device."""
    plane_dot = _products(plain)[0]

    def build(dt, device):
        return make_dst_fused_pieces(problem, dt, device)

    pieces = _per_input(build)

    def pipeline(btilde):
        (fxt, fy, gxt, gy), (mu, w) = pieces(btilde)
        bhat = plane_dot(btilde, fxt, fy, precision)
        if plain:
            x = tdma.tdma_z_reference(bhat, mu, w)
        else:
            x = tdma.tdma_z_bwd(*tdma.tdma_z_fwd(bhat, mu, w))
        return plane_dot(x, gxt, gy, precision)

    return pipeline


def _make_btilde_pipeline_tdma2d(problem: PoissonProblem, precision: str,
                                 plain: bool = False):
    """The Thomas y-stage transform (`spectral.py:133-216`): the x DST,
    the y-line Thomas solve with the dense low-mode rescue, the inverse x
    DST — the pieces of :func:`make_dst2d_fused_pieces`; with ``plain``
    their plain versions on any device."""
    right_dot = _products(plain)[1]

    def build(dt, device):
        return make_dst2d_fused_pieces(problem, dt, device, plain=plain,
                                       precision=precision)

    pieces = _per_input(build)

    def pipeline(btilde):
        fxt, gxt, ysolve = pieces(btilde)
        x = ysolve(right_dot(btilde, fxt, precision))
        return right_dot(x, gxt, precision)

    return pipeline


def make_fft_btilde_solver(problem: PoissonProblem,
                           params: PoissonParams = None,
                           precision: str = "highest",
                           z_mode: str = "eigen", plain: bool = False):
    """The raw transform ``btilde → x_new`` for fused producers
    (`spectral.py:853-899`); the reference's ``spectral_precision=DEFAULT``
    step runs it with ``z_mode="auto"`` after its emit-b̃ kernels.

    ``z_mode``: "eigen" runs every axis as DST products; "tdma" replaces
    the last axis by a Thomas line solve — z in 3D, y in 2D (with the
    dense rescue of the ill-conditioned low modes); "auto" takes the
    reference's gates (`spectral.py:871-888`): "tdma" always in 3D, and in
    2D where both of its profitability gates hold — the x pair's
    1024-wide mode padding under 2× (ceil(mx, 1024) < 2·mx: square-ish
    grids from mx > 512) and not every x-mode's y-line in the rescue
    (strongly anisotropic grids, dy ≪ dx, where the Thomas stage would
    do no useful work); "eigen" otherwise.  The port pads no mode dim,
    but the gate keeps the reference's choice of pipeline.  ``params`` is
    accepted for parity and read by nothing, as in the reference.
    ``plain`` runs the plain products and sweeps on any device.
    """
    if not spectral_supported(problem):
        raise ValueError("spectral solver needs nz==1 or (nz>=3, dz>0)")
    rolling._check_precision(precision)
    is_3d = problem.nz > 1
    if z_mode == "auto":
        if is_3d:
            sup = tdma_z_supported(problem)
        else:
            mx = problem.nx - 2
            lx = _dirichlet_eigenvalues(mx, problem.inv_dx2)
            sup = (tdma_y_supported(problem)
                   and _ceil_to(mx, 1024) < 2 * mx
                   and _tdma2d_rescue_width(
                       mx, lx, float(problem.inv_dy2)) < mx)
        z_mode = "tdma" if sup else "eigen"
    if z_mode == "tdma":
        if is_3d:
            if not tdma_z_supported(problem):
                raise ValueError("tdma z_mode unsupported for this problem")
            return _make_btilde_pipeline_tdma(problem, precision, plain)
        if not tdma_y_supported(problem):
            raise ValueError("tdma y-stage unsupported for this problem")
        return _make_btilde_pipeline_tdma2d(problem, precision, plain)
    if z_mode != "eigen":
        raise ValueError(f"unknown z_mode {z_mode!r}")
    return _make_btilde_pipeline(problem, precision, plain)


def make_fft_direct(problem: PoissonProblem, params: PoissonParams,
                    precision: str = "highest",
                    compute_residuals: bool = True, plain: bool = False):
    """The direct solve (`spectral.py:1158-1216`): ``solve(x0, rhs) →
    PoissonResult`` with ``iterations = 1``, ``initial_residual = 0`` (a
    direct method forms none) and ``status = CONVERGED`` — a drop-in for
    ``make_cg``'s solve, with the same fixed point.

    b̃ = face_coeff·x − rhs with a zero shell, then the eigen pipeline.
    With ``compute_residuals`` the final residual is CG's convention: the
    new interior inside the *initial* mirror shell (CG measures its
    recursion residual before the post-loop Neumann refresh), its
    Laplacian minus rhs, the interior L2 norm; without it, 0.
    ``precision`` is the products' ("highest", "high" or "default").
    The products go through the GEMM wrappers (the kernels on a float32
    CUDA tensor), or with ``plain`` through their plain versions on any
    device and dtype — the front end's solve for other dtypes than
    float32, and its reference switch.
    """
    if not spectral_supported(problem):
        raise ValueError("spectral solver needs nz==1 or (nz>=3, dz>0)")
    is_3d = problem.nz > 1
    pipeline = _make_btilde_pipeline(problem, precision, plain)
    fx = np.pad(_face_coeff(problem.nx - 2, problem.inv_dx2), 1)
    fy = np.pad(_face_coeff(problem.ny - 2, problem.inv_dy2), 1)
    fz = (np.pad(_face_coeff(problem.nz - 2, problem.inv_dz2), 1) if is_3d
          else np.zeros(1))

    def build(dt, device):
        def dev(a):
            return torch.as_tensor(a, dtype=dt, device=device)

        return ((dev(fz)[:, None, None] + dev(fy)[None, :, None])
                + dev(fx)[None, None, :])

    face_coeff = _per_input(build)

    def solve(x, rhs):
        x_new = pipeline(problem.zero_boundary(face_coeff(x) * x - rhs))
        if compute_residuals:
            x_hybrid = problem.set_interior(problem.neumann_bc(x), x_new)
            r_f = problem.zero_boundary(problem.laplacian(x_hybrid) - rhs)
            final_res = torch.sqrt(problem.dot_interior(r_f, r_f))
        else:
            final_res = torch.zeros((), dtype=x.dtype, device=x.device)

        def code(v):
            return torch.full((), int(v), dtype=torch.int32,
                              device=x.device)

        return PoissonResult(
            x=x_new, iterations=code(1),
            initial_residual=torch.zeros((), dtype=x.dtype,
                                         device=x.device),
            final_residual=final_res, status=code(PoissonStatus.CONVERGED))

    return solve
