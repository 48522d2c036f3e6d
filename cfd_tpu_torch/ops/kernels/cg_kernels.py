"""The CG solve's two fused passes (counterpart of
`cfd_tpu/ops/pallas/cg_kernels.py`).

One CG iteration is two passes over the field, as in the reference:

* ``lap_dot``: p′ = scale·r + β·p on the interior (zero shell),
  Ap′ = −∇²p′ (7-point, Dirichlet-0), and ⟨p′, Ap′⟩ — the TPU kernels
  ``make_lap_dot_rolling`` (`cg_kernels.py:75`) and ``make_lap_dot_fused``
  (`:249`), two forms of one function → ``cg_lap_dot_kernel`` plus a
  one-block finalize;
* ``cg_update``: x += α·p′, r −= α·Ap′ on the interior (x and r keep their
  shells bit for bit), and ⟨r′, r′⟩ — ``make_cg_update`` (`:360`) →
  ``cg_update_kernel`` plus a one-block finalize.

``scale`` is 1 for plain CG and the Jacobi diagonal ``inv_factor`` for
PCG.  Operation order is the reference's: ``((x-terms)·inv_dx2 +
(y-terms)·inv_dy2) + (z-terms)·inv_dz2`` with each second difference
``(f₊ − 2f) + f₋``, Ap = −lap.

The functional forms :func:`lap_dot` and :func:`cg_update` (and their
plain versions) serve the tests and the checks on the card.  The solver
loop (`solvers.poisson.krylov.make_cg_fused`) runs :class:`CGPasses`
instead, which works in place on the solver's own buffers and carries the
iteration's scalars in a small state tensor on the device (slots below):
the kernels read α and β from it, their finalize blocks write the rest of
the recurrence, so the host never reads a scalar inside the loop.  Once
the running flag is 0 every pass is a no-op, as the reference's
``while_loop`` would have stopped.  The CUDA source is
``cfd_tpu_torch/csrc/cg_kernels.cu``.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import stencils
from . import native

BREAKDOWN = 1e-30  # CG_BREAKDOWN_THRESHOLD (krylov.BREAKDOWN)

# slots of the solver state (the kernels' enum in cg_kernels.cu)
(RHO, BETA, ALPHA, RES, IT, RUNNING, TOL, ABS_TOL, PAP, RR,
 BD1) = range(11)
STATE_LEN = 11


@dataclasses.dataclass(frozen=True)
class CGConsts:
    """One problem's constants: (nz, ny, nx) fields, the Laplacian's
    coefficients, the preconditioner's scale and the check interval."""

    nz: int
    ny: int
    nx: int
    inv_dx2: float
    inv_dy2: float
    inv_dz2: float
    scale: float = 1.0
    check_interval: int = 1

    @property
    def shape(self):
        return (self.nz, self.ny, self.nx)


def new_state(rho, res, tol, abs_tol, running) -> torch.Tensor:
    """The state at the start of the loop, from 0-d tensors (β = 0,
    iteration 0)."""
    z = torch.zeros_like(rho)
    slots = {RHO: rho, RES: res, TOL: tol, ABS_TOL: abs_tol,
             RUNNING: running.to(rho.dtype)}
    return torch.stack([slots.get(k, z) for k in range(STATE_LEN)])


def _check(c: CGConsts, *fields):
    native.check_cuda(*fields)
    for f in fields:
        if tuple(f.shape) != c.shape:
            raise ValueError(f"expected fields of shape {c.shape}, got "
                             f"{tuple(f.shape)}")


def _partials(c: CGConsts, like: torch.Tensor) -> torch.Tensor:
    n = native.library().cfd_cg_partials(c.nz, c.ny, c.nx)
    return torch.empty(n, dtype=like.dtype, device=like.device)


def _launch_lap_dot(r, p, pn, ap, st, part, c: CGConsts):
    native.launch("cfd_cg_lap_dot", r.device, *map(native.ptr, (
        r, p, pn, ap, st, part)), c.nz, c.ny, c.nx, c.inv_dx2, c.inv_dy2,
        c.inv_dz2, c.scale)
    lap_dot.launches += 1


def _launch_update(x, r, pn, ap, st, part, c: CGConsts):
    native.launch("cfd_cg_update", x.device, *map(native.ptr, (
        x, r, pn, ap, st, part)), c.nz, c.ny, c.nx, c.scale,
        max(1, int(c.check_interval)))
    cg_update.launches += 1


def _one_shot_state(like, slot, value):
    """A running state for one pass, ``value`` in ``slot`` (β or α)."""
    st = torch.zeros(STATE_LEN, dtype=like.dtype, device=like.device)
    st[RUNNING] = 1.0
    st[slot] = value
    return st


# ---- lap_dot ----------------------------------------------------------------

def lap_dot_plain(r, p, beta, c: CGConsts):
    """(p′, Ap′, ⟨p′, Ap′⟩) with zero shells on p′ and Ap′."""
    mask = stencils.interior_mask(c.shape, torch.bool, r.device)
    pn = torch.where(mask, c.scale * r + beta * p, torch.zeros_like(r))
    ap = torch.zeros_like(r)
    ap[stencils.interior_index(ap)] = -stencils.laplacian(
        pn, c.inv_dx2, c.inv_dy2, c.inv_dz2)
    return pn, ap, torch.sum(stencils.interior(ap) * stencils.interior(pn))


def lap_dot(r, p, beta, c: CGConsts):
    """(p′, Ap′, ⟨p′, Ap′⟩) — ``cg_lap_dot_kernel`` and its finalize on
    CUDA; ``beta`` a float or a 0-d tensor."""
    if native.on_cpu(r):
        return lap_dot_plain(r, p, beta, c)
    _check(c, r, p)
    pn, ap = torch.empty_like(r), torch.empty_like(r)
    st = _one_shot_state(r, BETA, beta)
    _launch_lap_dot(r, p, pn, ap, st, _partials(c, r), c)
    return pn, ap, st[PAP]


# ---- cg_update --------------------------------------------------------------

def cg_update_plain(x, r, pn, ap, alpha, c: CGConsts):
    """(x′, r′, ⟨r′, r′⟩): the α-updates on the interior, shells kept."""
    ix = stencils.interior_index(x)
    x2, r2 = x.clone(), r.clone()
    x2[ix] = x[ix] + alpha * pn[ix]
    r2[ix] = r[ix] - alpha * ap[ix]
    return x2, r2, torch.sum(r2[ix] * r2[ix])


def cg_update(x, r, pn, ap, alpha, c: CGConsts):
    """(x′, r′, ⟨r′, r′⟩) — ``cg_update_kernel`` and its finalize on CUDA
    (on copies of x and r); ``alpha`` a float or a 0-d tensor."""
    if native.on_cpu(x):
        return cg_update_plain(x, r, pn, ap, alpha, c)
    _check(c, x, r, pn, ap)
    x2, r2 = x.clone(), r.clone()
    st = _one_shot_state(x, ALPHA, alpha)
    _launch_update(x2, r2, pn, ap, st, _partials(c, x), c)
    return x2, r2, st[RR]


lap_dot.launches = 0
cg_update.launches = 0
WRAPPERS = (lap_dot, cg_update)


# ---- the solver loop's passes ----------------------------------------------

class CGPasses:
    """K1 and K2 with their finalize blocks, in place on the solver's
    buffers and its state tensor (:func:`new_state`).

    On a CUDA device the kernels run; on the CPU, or with ``plain=True``
    (a reference switch for checks on the card), the plain versions run
    with the finalize recurrence as 0-d tensor operations, each update
    selected by the running flag so a pass after the stop changes
    nothing."""

    def __init__(self, c: CGConsts, device, plain: bool = False):
        self.c = c
        self.plain = plain or torch.device(device).type == "cpu"
        self._part = None

    def _partials(self, like):
        if self._part is None:
            self._part = _partials(self.c, like)
        return self._part

    def lap_dot(self, r, p, pn, ap, st):
        """pn ← p′, ap ← Ap′; state: ⟨p′, Ap′⟩, breakdown, α."""
        if not self.plain:
            _check(self.c, r, p, pn, ap)
            _launch_lap_dot(r, p, pn, ap, st, self._partials(r), self.c)
            return
        pn_, ap_, pap = lap_dot_plain(r, p, st[BETA], self.c)
        pn.copy_(pn_)
        ap.copy_(ap_)
        bd1 = pap.abs() < BREAKDOWN
        one, zero = torch.ones_like(pap), torch.zeros_like(pap)
        new = st.clone()
        new[PAP] = pap
        new[BD1] = bd1.to(st.dtype)
        new[ALPHA] = torch.where(bd1, zero,
                                 st[RHO] / torch.where(bd1, one, pap))
        st.copy_(torch.where(st[RUNNING] > 0, new, st))

    def update(self, x, r, pn, ap, st):
        """x, r ← the α-updates; state: ρ, β, residual, check, breakdown,
        iteration count and running flag (`krylov.py:174-182`)."""
        c = self.c
        if not self.plain:
            _check(c, x, r, pn, ap)
            _launch_update(x, r, pn, ap, st, self._partials(x), c)
            return
        run = st[RUNNING] > 0
        x2, r2, rr = cg_update_plain(x, r, pn, ap, st[ALPHA], c)
        x.copy_(torch.where(run, x2, x))
        r.copy_(torch.where(run, r2, r))
        rho = st[RHO]
        rho_new = c.scale * rr
        res_new = torch.sqrt(rr)
        check = torch.remainder(st[IT], max(1, int(c.check_interval))) == 0
        conv = check & ((res_new < st[TOL]) | (res_new < st[ABS_TOL]))
        bd1 = st[BD1] > 0
        bd2 = rho.abs() < BREAKDOWN
        stop = conv | bd1 | bd2
        new = st.clone()
        new[RR] = rr
        new[RHO] = rho_new
        new[BETA] = rho_new / torch.where(bd2, torch.ones_like(rho), rho)
        new[IT] = st[IT] + 1
        new[RES] = torch.where(bd1, st[RES], res_new)
        new[RUNNING] = (~stop).to(st.dtype)
        st.copy_(torch.where(run, new, st))
