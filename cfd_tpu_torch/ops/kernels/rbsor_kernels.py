"""The Red-Black SOR sweep (counterpart of
`cfd_tpu/ops/pallas/rbsor_kernels.py`'s ``make_rbsor_sweep`` `:53-270`),
and the plain stationary sweeps the whole solves share.

One sweep, in this order:

1. the red half, interior points with (i + j + k) even (k = 0 on a 2D
   field);
2. the black half, on the red-updated x;
3. the Neumann mirror, x faces, then y, then z;
4. the interior ∞-norm of ∇²x − rhs on the mirrored iterate.

At one colour ``gs = −(rhs − nb)·inv_factor`` and ``x ← x + ω(gs − x)``
with ``nb`` the weighted neighbour sum, in the jnp operation order of
`stationary.py:264-269`.  The mirror is a gather from the clamped index,
``x[clamp(k), clamp(j), clamp(i)]`` with each index clamped to
[1, n − 2] (:func:`neumann_gather`), the composite of the reference's face
order, bit for bit.

On Hopper (``cfd_tpu_torch/csrc/rbsor_kernels.cu``) one launch a colour
updates x in place (a colour reads only the other), a third launch writes
the mirror from the shell threads and the residual from the interior ones
through the same clamped reads, and a one-block fold takes the NaN-keeping
maximum.  The TPU's ``rbsor_supported`` gate (`:47-50`) is left out: any
(nz, ny, nx) with nz == 1 or nz ≥ 3 runs.

:func:`rbsor_sweep` is the functional form (tests, the checks on the
card); the solver loop (`solvers.poisson.stationary.
make_redblack_sor_fused`) runs :class:`SORPasses`, in place on its buffer,
with the loop's residual, count and running flag in a state tensor on the
device: the fold block drops the flag at the end of a ``check_interval``
chunk that converged, and every launch after that is a no-op.  ω crosses
to the kernel as one float32 value, the value a float32 plain version
multiplies by.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import stencils
from . import native

# slots of the sweep loop's state (the kernels' enum in rbsor_kernels.cu)
RES, IT, RUNNING, TOL, ABS_TOL = range(5)
STATE_LEN = 5


@dataclasses.dataclass(frozen=True)
class SORConsts:
    """One problem's constants: (nz, ny, nx) fields, the stencil's
    coefficients, the relaxation factor, the check interval and the sweep
    budget."""

    nz: int
    ny: int
    nx: int
    inv_dx2: float
    inv_dy2: float
    inv_dz2: float
    inv_factor: float
    omega: float = 1.0
    check_interval: int = 1
    max_iterations: int = 1

    @property
    def shape(self):
        return (self.nz, self.ny, self.nx)


def new_state(res, tol, abs_tol, running) -> torch.Tensor:
    """The state at the start of the loop, from 0-d tensors."""
    z = torch.zeros_like(res)
    slots = {RES: res, TOL: tol, ABS_TOL: abs_tol,
             RUNNING: running.to(res.dtype)}
    return torch.stack([slots.get(k, z) for k in range(STATE_LEN)])


# ---- plain versions ------------------------------------------------------------

def neumann_gather(x):
    """The Neumann mirror as a gather: every point takes x at its index
    clamped to [1, n − 2] (k only in 3D), a new tensor — bit-equal to
    ``apply_neumann_scalar``'s x → y → z faces."""
    nz, ny, nx = x.shape

    def clamped(n):
        return torch.clamp(torch.arange(n, device=x.device), 1, n - 2)

    if nz > 1:
        x = x[clamped(nz)]
    return x[:, clamped(ny)][:, :, clamped(nx)]


def residual_inf(x, rhs, c):
    """‖∇²x − rhs‖∞ over the interior (NaN if any entry is)."""
    ix = stencils.interior_index(x)
    lap = stencils.laplacian(x, c.inv_dx2, c.inv_dy2, c.inv_dz2)
    return torch.amax(torch.abs(lap - rhs[ix]))


def _colour(x, rhs, c: SORConsts, parity):
    """One colour of the SOR update, a new tensor."""
    ix = stencils.interior_index(x)
    mask = stencils.checkerboard_mask(c.shape, parity, x.device)[ix]
    nb = stencils.neighbour_sum(x, c.inv_dx2, c.inv_dy2, c.inv_dz2)
    gs = -(rhs[ix] - nb) * c.inv_factor
    xi = x[ix]
    out = x.clone()
    out[ix] = torch.where(mask, xi + c.omega * (gs - xi), xi)
    return out


def rb_sweep_plain(x, rhs, c: SORConsts):
    """Red, black, the mirror: one Red-Black SOR sweep, a new tensor."""
    return neumann_gather(_colour(_colour(x, rhs, c, 0), rhs, c, 1))


def jacobi_sweep_plain(x, rhs, c):
    """One Jacobi sweep, ``−(rhs − nb)·inv_factor`` on the interior, then
    the mirror (`stationary.py:88-94`), a new tensor."""
    ix = stencils.interior_index(x)
    nb = stencils.neighbour_sum(x, c.inv_dx2, c.inv_dy2, c.inv_dz2)
    out = x.clone()
    out[ix] = -(rhs[ix] - nb) * c.inv_factor
    return neumann_gather(out)


def rbsor_sweep_plain(x, rhs, c: SORConsts):
    """(x′, ‖∇²x′ − rhs‖∞): the sweep and the residual of its result."""
    x2 = rb_sweep_plain(x, rhs, c)
    return x2, residual_inf(x2, rhs, c)


# ---- the kernel ------------------------------------------------------------------

def _check(c: SORConsts, *fields):
    native.check_cuda(*fields)
    for f in fields:
        if tuple(f.shape) != c.shape or c.nz == 2:
            raise ValueError(f"expected fields of shape {c.shape} (nz == 1 "
                             f"or nz >= 3), got {tuple(f.shape)}")


def _partials(c: SORConsts, like):
    n = native.library().cfd_rbsor_partials(c.nz, c.ny, c.nx)
    return torch.empty(n, dtype=like.dtype, device=like.device)


def _launch(x, rhs, st, part, c: SORConsts):
    native.launch("cfd_rbsor_sweep", x.device, *map(native.ptr, (
        x, rhs, st, part)), c.nz, c.ny, c.nx, c.inv_dx2, c.inv_dy2,
        c.inv_dz2, c.inv_factor, c.omega, max(1, int(c.check_interval)),
        int(c.max_iterations))
    rbsor_sweep.launches += 1


def rbsor_sweep(x, rhs, c: SORConsts):
    """(x′, ‖∇²x′ − rhs‖∞) — the colour, mirror-and-residual and fold
    launches of ``cfd_rbsor_sweep`` on CUDA (on a copy of x)."""
    if native.on_cpu(x):
        return rbsor_sweep_plain(x, rhs, c)
    _check(c, x, rhs)
    x2 = x.clone()
    st = torch.zeros(STATE_LEN, dtype=x.dtype, device=x.device)
    st[RUNNING] = 1.0
    _launch(x2, rhs, st, _partials(c, x), c)
    return x2, st[RES]


rbsor_sweep.launches = 0
WRAPPERS = (rbsor_sweep,)


class SORPasses:
    """The sweep in place on the solver's buffer and its state tensor
    (:func:`new_state`).  On a CUDA device the kernels run; on the CPU, or
    with ``plain=True`` (a reference switch for checks on the card), the
    plain sweep runs with the fold's bookkeeping as 0-d tensor
    operations, selected by the running flag."""

    def __init__(self, c: SORConsts, device, plain: bool = False):
        self.c = c
        self.plain = plain or torch.device(device).type == "cpu"
        self._part = None

    def sweep(self, x, rhs, st):
        """x ← one sweep; state: the residual, the count, and the stop at
        the end of a converged chunk."""
        c = self.c
        if not self.plain:
            _check(c, x, rhs)
            if self._part is None:
                self._part = _partials(c, x)
            _launch(x, rhs, st, self._part, c)
            return
        run = st[RUNNING] > 0
        x2, res = rbsor_sweep_plain(x, rhs, c)
        x.copy_(torch.where(run, x2, x))
        it = st[IT] + 1
        chunk_end = ((torch.remainder(it, max(1, int(c.check_interval))) == 0)
                     | (it == int(c.max_iterations)))
        conv = chunk_end & ((res < st[TOL]) | (res < st[ABS_TOL]))
        new = st.clone()
        new[RES], new[IT] = res, it
        new[RUNNING] = torch.where(conv, torch.zeros_like(res), st[RUNNING])
        st.copy_(torch.where(run, new, st))
