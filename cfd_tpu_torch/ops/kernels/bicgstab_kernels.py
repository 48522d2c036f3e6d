"""The BiCGSTAB solve's three fused passes (counterpart of
`cfd_tpu/ops/pallas/bicgstab_kernels.py`, ``BiCGSTABKernels.pass_pv`` /
``pass_st`` / ``pass_xr`` `:147-156`, built at `:94-143`).

One iteration is three passes over the field, all in the Dirichlet-0
correction space (zero shells):

* ``pass_pv``: p′ = r + β(p − ωv) on the interior, v′ = −∇²p′ and
  ⟨r̂, v′⟩ → ``bicg_pv_kernel`` plus a one-block finalize;
* ``pass_st``: s = r − αv′, t = −∇²s, and ⟨s,s⟩, ⟨t,s⟩, ⟨t,t⟩ →
  ``bicg_st_kernel`` plus its finalize;
* ``pass_xr``: x += αp′ + ωs (x keeps its shell), r = s − ωt, and ⟨r,r⟩,
  ⟨r̂,r⟩ — the next iteration's ρ → ``bicg_xr_kernel`` plus its finalize.

Operation order is the reference's, with the Laplacian of `ops.stencils`
(``((f₊ − 2f) + f₋)`` per axis, x, then y, then z).  The functional
forms (and their plain versions) serve the tests and the checks on the
card; the solver loop (`solvers.poisson.krylov.make_bicgstab_fused`) runs
:class:`BiCGSTABPasses` instead, in place on its buffers, with the
iteration's scalars in a state tensor on the device (slots below): the
kernels read β, ω and α from it, and the finalize blocks write the rest of
the recurrence of `krylov.py:328-361`, so the host never reads a scalar
inside the loop.  Once the running flag is 0 every pass is a no-op.  The
CUDA source is ``cfd_tpu_torch/csrc/bicgstab_kernels.cu``.

The sharded ``global_nz`` mode (`:56-130`; z_base, nz_g given; the
z-decomposed BiCGSTAB of `parallel.fused_bicgstab`): ``pass_pv`` and
``pass_st`` take a shard's halo-padded blocks of ``c.nz = nzl + 2``
planes whose plane k is global plane ``z_base + k`` (r̂ owned-size), mask
their stencil outputs to the global Dirichlet-0 interior while the
work-vector combinations at the neighbours read the halo planes as they
are, and return the owned planes with their shares of the dots;
``pass_xr`` runs on the owned block (``c.nz = nzl``) and skips the global
shells only — where the reference runs its plain xr on a zero-padded
owned block (`parallel/fused_bicgstab.py:229-232`), which the one-device
kernel here would not do: it skips the block's first and last plane, two
owned planes of every shard.  The shares are float64 sums, rounded to
float once after the shards are summed.  All three count on
``global_nz_launches``; the loop runs :class:`ShardBiCGSTABPasses`, the
finalize split as in `cg_kernels.ShardCGPasses`.

The (z, y) modes (``y_base``, ``ny_g`` given too; ``BiCGSTABKernels(
global_nz, global_ny)``, `:56-90`): every tensor is a shard's block padded
one plane and one row a side (``c`` its constants, plane k and row j the
global ``z_base + k`` and ``y_base + j``, r̂, x, s and t padded too); pv
and st mask their stencil outputs to the global Dirichlet-0 interior
while the combinations read the halo rows and planes as they are, and
xr updates every owned point but the global shells — the first and last
owned rows of an inner y-shard included, which the one-device kernel on
the owned block would skip.  The outputs come back as the owned points
(the functional forms) or are written in the padded layout (the solver
loop), the dots over the owned points only.  All three count on
``global_ny_launches`` (``bicg_*_kernel<true, true>``).
``bicgstab_kernels_supported`` and its ``nx % 128`` gate are TPU gates,
left out.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import stencils
from . import native
from .cg_kernels import _owned_rows

BREAKDOWN = 1e-30  # krylov.BREAKDOWN

# slots of the solver state (the kernels' enum in bicgstab_kernels.cu)
(RHO_PREV, RHO, ALPHA, OMEGA, BETA, IT, RES, RUNNING, STAGNATED, TOL,
 ABS_TOL, BD1, RHV, ALPHA_NEW, BD, SS, TS, TT, EARLY, BD3, OMEGA_NEW,
 ALPHA_EFF, OMEGA_EFF, RR, RHAT_R) = range(25)
STATE_LEN = 25


@dataclasses.dataclass(frozen=True)
class BiCGConsts:
    """One problem's constants: (nz, ny, nx) fields, the Laplacian's
    coefficients and the check interval."""

    nz: int
    ny: int
    nx: int
    inv_dx2: float
    inv_dy2: float
    inv_dz2: float
    check_interval: int = 1

    @property
    def shape(self):
        return (self.nz, self.ny, self.nx)


def beta_of(rho, rho_prev, alpha, omega):
    """β = (ρ / ρ_prev)(α / ω), each divisor 1 on breakdown
    (`krylov.py:332-333`)."""
    one = torch.ones_like(rho)
    return ((rho / torch.where(rho.abs() < BREAKDOWN, one, rho_prev))
            * (alpha / torch.where(omega.abs() < BREAKDOWN, one, omega)))


def new_state(rho, res, tol, abs_tol, running) -> torch.Tensor:
    """The state at the start of the loop, from 0-d tensors: ρ_prev = α =
    ω = 1, ρ = ⟨r̂, r₀⟩, iteration 0 (`krylov.py:363-364`)."""
    one, z = torch.ones_like(rho), torch.zeros_like(rho)
    slots = {RHO_PREV: one, RHO: rho, ALPHA: one, OMEGA: one,
             BETA: beta_of(rho, one, one, one), RES: res, TOL: tol,
             ABS_TOL: abs_tol, RUNNING: running.to(rho.dtype)}
    return torch.stack([slots.get(k, z) for k in range(STATE_LEN)])


def _check(c: BiCGConsts, *fields):
    native.check_cuda(*fields)
    if c.nz < 3:
        raise ValueError("the BiCGSTAB passes need a 3D grid (nz >= 3)")
    for f in fields:
        if tuple(f.shape) != c.shape:
            raise ValueError(f"expected fields of shape {c.shape}, got "
                             f"{tuple(f.shape)}")


def _partials(c: BiCGConsts, like: torch.Tensor, nz=None) -> torch.Tensor:
    """Room for three float64 per-block partials of each pass (over
    ``nz`` planes, default ``c.nz``)."""
    n = native.library().cfd_bicg_partials(c.nz if nz is None else nz,
                                           c.ny, c.nx)
    return torch.empty(3 * n, dtype=torch.float64, device=like.device)


def _launch_sharded(name, wrapper, device, ptrs, c: BiCGConsts, *base,
                    derivs=True):
    """One sharded pass (the kernel and the shard's fold); ``base`` the
    block's (z_base, nz_g), or (z_base, nz_g, y_base, ny_g) for a (z, y)
    pass on padded blocks, counted on ``global_ny_launches``."""
    coef = (c.inv_dx2, c.inv_dy2, c.inv_dz2) if derivs else ()
    native.launch(name, device, *map(native.ptr, ptrs), c.nz, c.ny, c.nx,
                  *coef, *map(int, base))
    native.count_launch(wrapper, "global_ny" if len(base) == 4
                        else "global_nz")


def _rows_partials(c: BiCGConsts, like):
    """Room for a (z, y) pass's partials: its owned points of the padded
    block ``c``."""
    return _partials(dataclasses.replace(c, nz=c.nz - 2, ny=c.ny - 2), like)


def _own(t):
    """The owned points of a block padded one plane and one row a side
    (a view)."""
    return t[1:-1, 1:-1]


def _launch_pv(r, p, v, rhat, pn, vn, st, part, c: BiCGConsts):
    native.launch("cfd_bicg_pv", r.device, *map(native.ptr, (
        r, p, v, rhat, pn, vn, st, part)), c.nz, c.ny, c.nx, c.inv_dx2,
        c.inv_dy2, c.inv_dz2)
    pass_pv.launches += 1


def _launch_st(r, vn, s, t, st, part, c: BiCGConsts):
    native.launch("cfd_bicg_st", r.device, *map(native.ptr, (
        r, vn, s, t, st, part)), c.nz, c.ny, c.nx, c.inv_dx2, c.inv_dy2,
        c.inv_dz2)
    pass_st.launches += 1


def _launch_xr(x, r, pn, s, t, rhat, st, part, c: BiCGConsts):
    native.launch("cfd_bicg_xr", x.device, *map(native.ptr, (
        x, r, pn, s, t, rhat, st, part)), c.nz, c.ny, c.nx,
        max(1, int(c.check_interval)))
    pass_xr.launches += 1


def _one_shot_state(like, slots):
    """A running state for one pass, ``slots`` ({slot: value}) set."""
    st = torch.zeros(STATE_LEN, dtype=like.dtype, device=like.device)
    st[RUNNING] = 1.0
    for slot, value in slots.items():
        st[slot] = value
    return st


def dot(a, b):
    """⟨a, b⟩ over the interior, accumulated in float64 and rounded to a's
    dtype once, as the kernels' dots: in float32 sums ρ = ⟨r̂, r⟩ falls
    below the sum's rounding on large grids and the solve breaks down (see
    ``csrc/bicgstab_kernels.cu``)."""
    return torch.sum(stencils.interior(a).double()
                     * stencils.interior(b).double()).to(a.dtype)


def dot64(a, b, mask):
    """A shard's share of ⟨a, b⟩ over the points of ``mask``, in float64
    and not rounded (the shards' shares are summed first)."""
    return torch.sum(torch.where(mask, a.double() * b.double(), 0.0))


def _minus_lap_owned(f, mask, c: BiCGConsts):
    """−∇²f at the owned planes of a halo-padded block (0 outside
    ``mask``, the block's global interior)."""
    out = torch.zeros_like(f[1:-1])
    out[:, 1:-1, 1:-1] = torch.where(
        mask[stencils.interior_index(f)],
        -stencils.laplacian(f, c.inv_dx2, c.inv_dy2, c.inv_dz2), 0.0)
    return out


def _minus_lap_rows(f, mask, c: BiCGConsts):
    """−∇²f at the owned points of a block padded one plane and one row
    a side (0 elsewhere and outside ``mask``, the block's global
    interior), in the padded layout."""
    out = torch.zeros_like(f)
    ix = stencils.interior_index(f)
    out[ix] = torch.where(_owned_rows(mask)[ix], -stencils.laplacian(
        f, c.inv_dx2, c.inv_dy2, c.inv_dz2), 0.0)
    return out


def _minus_lap(f, c: BiCGConsts):
    """−∇²f on the interior, 0 on the shell."""
    out = torch.zeros_like(f)
    out[stencils.interior_index(f)] = -stencils.laplacian(
        f, c.inv_dx2, c.inv_dy2, c.inv_dz2)
    return out


# ---- pv ------------------------------------------------------------------

def pass_pv_plain(r, p, v, rhat, beta, omega, c: BiCGConsts,
                  z_base: int = 0, nz_g: int = None, y_base: int = 0,
                  ny_g: int = None):
    """(p′, v′, ⟨r̂, v′⟩) with zero shells on p′ and v′.  With ``nz_g``
    the ``global_nz`` mode: r, p, v a shard's halo-padded block, r̂ and
    the outputs its owned planes, the dot the shard's float64 share.
    With ``ny_g`` too the (z, y) mode: every tensor the block padded one
    plane and one row a side, the owned points of p′ and v′ returned."""
    if ny_g is not None:
        mask = stencils.global_interior_mask(c.shape, z_base, nz_g,
                                             r.device, y_base, ny_g)
        pn = torch.where(mask, r + beta * (p - omega * v),
                         torch.zeros_like(r))
        vn = _minus_lap_rows(pn, mask, c)
        return _own(pn), _own(vn), dot64(rhat, vn, _owned_rows(mask))
    if nz_g is not None:
        mask = stencils.global_interior_mask(c.shape, z_base, nz_g,
                                             r.device)
        pn = torch.where(mask, r + beta * (p - omega * v),
                         torch.zeros_like(r))
        vn = _minus_lap_owned(pn, mask, c)
        return pn[1:-1], vn, dot64(rhat, vn, mask[1:-1])
    mask = stencils.interior_mask(c.shape, torch.bool, r.device)
    pn = torch.where(mask, r + beta * (p - omega * v), torch.zeros_like(r))
    vn = _minus_lap(pn, c)
    return pn, vn, dot(rhat, vn)


def pass_pv(r, p, v, rhat, beta, omega, c: BiCGConsts, z_base: int = 0,
            nz_g: int = None, y_base: int = 0, ny_g: int = None):
    """(p′, v′, ⟨r̂, v′⟩) — ``bicg_pv_kernel`` and its finalize on CUDA;
    ``beta`` and ``omega`` floats or 0-d tensors.  With ``nz_g`` the
    ``global_nz`` mode of :func:`pass_pv_plain`: ``bicg_pv_kernel<true>``
    and the shard's fold; with ``ny_g`` too its (z, y) mode,
    ``bicg_pv_kernel<true, true>``."""
    if native.on_cpu(r):
        return pass_pv_plain(r, p, v, rhat, beta, omega, c, z_base, nz_g,
                             y_base, ny_g)
    st = _one_shot_state(r, {BETA: beta, OMEGA: omega, RHO: 1.0})
    if ny_g is not None:
        _check(c, r, p, v, rhat)
        pn, vn = torch.zeros_like(r), torch.zeros_like(r)
        out = torch.empty(1, dtype=torch.float64, device=r.device)
        _launch_sharded("cfd_bicg_pv_rows", pass_pv, r.device, (
            r, p, v, rhat, pn, vn, st, _rows_partials(c, r), out), c,
            z_base, nz_g, y_base, ny_g)
        return _own(pn), _own(vn), out[0]
    if nz_g is not None:
        _check(c, r, p, v)
        own = (c.nz - 2, c.ny, c.nx)
        pn, vn = r.new_empty(own), r.new_empty(own)
        out = torch.empty(1, dtype=torch.float64, device=r.device)
        _launch_sharded("cfd_bicg_pv_sharded", pass_pv, r.device, (
            r, p, v, rhat, pn, vn, st, _partials(c, r, c.nz - 2), out), c,
            z_base, nz_g)
        return pn, vn, out[0]
    _check(c, r, p, v, rhat)
    pn, vn = torch.empty_like(r), torch.empty_like(r)
    _launch_pv(r, p, v, rhat, pn, vn, st, _partials(c, r), c)
    return pn, vn, st[RHV]


# ---- st ------------------------------------------------------------------

def pass_st_plain(r, vn, alpha, c: BiCGConsts, z_base: int = 0,
                  nz_g: int = None, y_base: int = 0, ny_g: int = None):
    """(s, t, ⟨s,s⟩, ⟨t,s⟩, ⟨t,t⟩) with zero shells on s and t.  With
    ``nz_g`` the ``global_nz`` mode: r and v′ a shard's halo-padded
    block, s and t its owned planes, the dots the shard's float64
    shares.  With ``ny_g`` too the (z, y) mode: r and v′ padded one plane
    and one row a side, the owned points of s and t returned."""
    if ny_g is not None:
        mask = stencils.global_interior_mask(c.shape, z_base, nz_g,
                                             r.device, y_base, ny_g)
        s = torch.where(mask, r - alpha * vn, torch.zeros_like(r))
        t = _minus_lap_rows(s, mask, c)
        own = _owned_rows(mask)
        return (_own(s), _own(t), dot64(s, s, own), dot64(t, s, own),
                dot64(t, t, own))
    if nz_g is not None:
        mask = stencils.global_interior_mask(c.shape, z_base, nz_g,
                                             r.device)
        s = torch.where(mask, r - alpha * vn, torch.zeros_like(r))
        t = _minus_lap_owned(s, mask, c)
        s, own = s[1:-1], mask[1:-1]
        return s, t, dot64(s, s, own), dot64(t, s, own), dot64(t, t, own)
    mask = stencils.interior_mask(c.shape, torch.bool, r.device)
    s = torch.where(mask, r - alpha * vn, torch.zeros_like(r))
    t = _minus_lap(s, c)
    return s, t, dot(s, s), dot(t, s), dot(t, t)


def pass_st(r, vn, alpha, c: BiCGConsts, z_base: int = 0,
            nz_g: int = None, y_base: int = 0, ny_g: int = None):
    """(s, t, ⟨s,s⟩, ⟨t,s⟩, ⟨t,t⟩) — ``bicg_st_kernel`` and its finalize
    on CUDA.  With ``nz_g`` the ``global_nz`` mode of
    :func:`pass_st_plain`: ``bicg_st_kernel<true>`` and the shard's
    fold; with ``ny_g`` too its (z, y) mode, ``bicg_st_kernel<true,
    true>``."""
    if native.on_cpu(r):
        return pass_st_plain(r, vn, alpha, c, z_base, nz_g, y_base, ny_g)
    _check(c, r, vn)
    st = _one_shot_state(r, {ALPHA_NEW: alpha})
    if ny_g is not None:
        s, t = torch.zeros_like(r), torch.zeros_like(r)
        out = torch.empty(3, dtype=torch.float64, device=r.device)
        _launch_sharded("cfd_bicg_st_rows", pass_st, r.device, (
            r, vn, s, t, st, _rows_partials(c, r), out), c, z_base, nz_g,
            y_base, ny_g)
        return _own(s), _own(t), out[0], out[1], out[2]
    if nz_g is not None:
        own = (c.nz - 2, c.ny, c.nx)
        s, t = r.new_empty(own), r.new_empty(own)
        out = torch.empty(3, dtype=torch.float64, device=r.device)
        _launch_sharded("cfd_bicg_st_sharded", pass_st, r.device, (
            r, vn, s, t, st, _partials(c, r, c.nz - 2), out), c, z_base,
            nz_g)
        return s, t, out[0], out[1], out[2]
    s, t = torch.empty_like(r), torch.empty_like(r)
    _launch_st(r, vn, s, t, st, _partials(c, r), c)
    return s, t, st[SS], st[TS], st[TT]


# ---- xr ------------------------------------------------------------------

def pass_xr_plain(x, pn, s, t, rhat, alpha, omega, c: BiCGConsts,
                  z_base: int = 0, nz_g: int = None, y_base: int = 0,
                  ny_g: int = None):
    """(x′, r′, ⟨r′,r′⟩, ⟨r̂,r′⟩): x′ on the interior with x's shell, r′
    with a zero shell.  With ``nz_g`` the owned-block mode: every owned
    plane but the global shells, the dots the shard's float64 shares.
    With ``ny_g`` too the (z, y) mode: every tensor padded one plane and
    one row a side, every owned point updated but the global shells, the
    owned points of x′ and r′ returned."""
    if ny_g is not None:
        mask = _owned_rows(stencils.global_interior_mask(
            c.shape, z_base, nz_g, x.device, y_base, ny_g))
        x2 = torch.where(mask, (x + alpha * pn) + omega * s, x)
        r2 = torch.where(mask, s - omega * t, torch.zeros_like(s))
        return (_own(x2), _own(r2), dot64(r2, r2, mask),
                dot64(rhat, r2, mask))
    if nz_g is not None:
        mask = stencils.global_interior_mask(c.shape, z_base, nz_g,
                                             x.device)
        x2 = torch.where(mask, (x + alpha * pn) + omega * s, x)
        r2 = torch.where(mask, s - omega * t, torch.zeros_like(s))
        return x2, r2, dot64(r2, r2, mask), dot64(rhat, r2, mask)
    ix = stencils.interior_index(x)
    x2, r2 = x.clone(), torch.zeros_like(s)
    x2[ix] = x[ix] + alpha * pn[ix] + omega * s[ix]
    r2[ix] = s[ix] - omega * t[ix]
    return x2, r2, dot(r2, r2), dot(rhat, r2)


def pass_xr(x, pn, s, t, rhat, alpha, omega, c: BiCGConsts,
            z_base: int = 0, nz_g: int = None, y_base: int = 0,
            ny_g: int = None):
    """(x′, r′, ⟨r′,r′⟩, ⟨r̂,r′⟩) — ``bicg_xr_kernel`` and its finalize
    on CUDA (x′ on a copy of x).  With ``nz_g`` the owned-block mode of
    :func:`pass_xr_plain`: ``bicg_xr_kernel<true>`` and the shard's
    fold; with ``ny_g`` too its (z, y) mode, ``bicg_xr_kernel<true,
    true>``."""
    if native.on_cpu(x):
        return pass_xr_plain(x, pn, s, t, rhat, alpha, omega, c, z_base,
                             nz_g, y_base, ny_g)
    _check(c, x, pn, s, t, rhat)
    x2, r2 = x.clone(), torch.zeros_like(s)
    st = _one_shot_state(x, {ALPHA_EFF: alpha, OMEGA_EFF: omega})
    if ny_g is not None:
        out = torch.empty(2, dtype=torch.float64, device=x.device)
        _launch_sharded("cfd_bicg_xr_rows", pass_xr, x.device, (
            x2, r2, pn, s, t, rhat, st, _rows_partials(c, x), out), c,
            z_base, nz_g, y_base, ny_g, derivs=False)
        return _own(x2), _own(r2), out[0], out[1]
    if nz_g is not None:
        out = torch.empty(2, dtype=torch.float64, device=x.device)
        _launch_sharded("cfd_bicg_xr_sharded", pass_xr, x.device, (
            x2, r2, pn, s, t, rhat, st, _partials(c, x), out), c, z_base,
            nz_g, derivs=False)
        return x2, r2, out[0], out[1]
    _launch_xr(x2, r2, pn, s, t, rhat, st, _partials(c, x), c)
    return x2, r2, st[RR], st[RHAT_R]


native.reset_counts(pass_pv, pass_st, pass_xr)
WRAPPERS = (pass_pv, pass_st, pass_xr)


# ---- the solver loop's passes ----------------------------------------------

class BiCGSTABPasses:
    """B1's three passes with their finalize blocks, in place on the
    solver's buffers and its state tensor (:func:`new_state`).

    On a CUDA device the kernels run; on the CPU, or with ``plain=True``
    (a reference switch for checks on the card), the plain versions run
    with the finalize recurrence as 0-d tensor operations, x, r and the
    state selected by the running flag so a pass after the stop changes
    nothing the result reads."""

    def __init__(self, c: BiCGConsts, device, plain: bool = False):
        self.c = c
        self.plain = plain or torch.device(device).type == "cpu"
        self._part = None

    def _partials(self, like):
        if self._part is None:
            self._part = _partials(self.c, like)
        return self._part

    def pv(self, r, p, v, rhat, pn, vn, st):
        """pn ← p′, vn ← v′; state: ⟨r̂, v′⟩, breakdowns 1 and 2, α."""
        if not self.plain:
            _check(self.c, r, p, v, rhat, pn, vn)
            _launch_pv(r, p, v, rhat, pn, vn, st, self._partials(r), self.c)
            return
        pn_, vn_, rhv = pass_pv_plain(r, p, v, rhat, st[BETA], st[OMEGA],
                                      self.c)
        pn.copy_(pn_)
        vn.copy_(vn_)
        pv_recur_plain(rhv, st)

    def st(self, r, vn, s, t, st):
        """s, t ← the st pass; state: the dots, the early s-exit,
        breakdown 3, ω and the α, ω the x/r pass applies."""
        if not self.plain:
            _check(self.c, r, vn, s, t)
            _launch_st(r, vn, s, t, st, self._partials(r), self.c)
            return
        s_, t_, ss, ts, tt = pass_st_plain(r, vn, st[ALPHA_NEW], self.c)
        s.copy_(s_)
        t.copy_(t_)
        st_recur_plain(ss, ts, tt, st)

    def xr(self, x, r, pn, s, t, rhat, st):
        """x, r ← the update; state: the residual, the convergence check,
        breakdown 4, stagnation, the running flag and the carried
        scalars (`krylov.py:350-361`)."""
        c = self.c
        if not self.plain:
            _check(c, x, r, pn, s, t, rhat)
            _launch_xr(x, r, pn, s, t, rhat, st, self._partials(x), c)
            return
        run = st[RUNNING] > 0
        x2, r2, rr, rh = pass_xr_plain(x, pn, s, t, rhat, st[ALPHA_EFF],
                                       st[OMEGA_EFF], c)
        x.copy_(torch.where(run, x2, x))
        r.copy_(torch.where(run, r2, r))
        xr_recur_plain(rr, rh, st, c)


def _commit(st, new):
    st.copy_(torch.where(st[RUNNING] > 0, new, st))


def pv_recur_plain(rhv, st):
    """pv's finalize recurrence as 0-d tensor operations: ⟨r̂, v′⟩,
    breakdowns 1 and 2, α; no change once the running flag is 0."""
    bd1 = st[RHO].abs() < BREAKDOWN
    bd2 = rhv.abs() < BREAKDOWN
    new = st.clone()
    new[RHV] = rhv
    new[BD1] = bd1.to(st.dtype)
    new[ALPHA_NEW] = st[RHO] / torch.where(bd2, torch.ones_like(rhv), rhv)
    new[BD] = (bd1 | bd2).to(st.dtype)
    _commit(st, new)


def st_recur_plain(ss, ts, tt, st):
    """st's finalize recurrence: the dots, the early s-exit, breakdown 3,
    ω and the α, ω the x/r pass applies."""
    s_norm = torch.sqrt(ss)
    early = (s_norm < st[TOL]) | (s_norm < st[ABS_TOL])
    bd3 = tt.abs() < BREAKDOWN
    omega_new = ts / torch.where(bd3, torch.ones_like(tt), tt)
    bd = st[BD] > 0
    zero = torch.zeros_like(ss)
    new = st.clone()
    new[SS], new[TS], new[TT] = ss, ts, tt
    new[EARLY] = early.to(st.dtype)
    new[BD3] = bd3.to(st.dtype)
    new[OMEGA_NEW] = omega_new
    new[ALPHA_EFF] = torch.where(bd, zero, st[ALPHA_NEW])
    new[OMEGA_EFF] = torch.where(bd | early | bd3, zero, omega_new)
    _commit(st, new)


def xr_recur_plain(rr, rh, st, c: BiCGConsts):
    """xr's finalize recurrence (`krylov.py:350-361`): the residual, the
    convergence check, breakdown 4, stagnation, the running flag and the
    carried scalars."""
    bd, early, bd3 = st[BD] > 0, st[EARLY] > 0, st[BD3] > 0
    res_new = torch.where(bd, st[RES], torch.sqrt(rr))
    check = torch.remainder(st[IT], max(1, int(c.check_interval))) == 0
    conv = early | (check & ((res_new < st[TOL])
                             | (res_new < st[ABS_TOL])))
    bd4 = st[OMEGA_NEW].abs() < BREAKDOWN
    stagnated = bd | bd3 | (bd4 & ~conv)
    new = st.clone()
    new[RR], new[RHAT_R] = rr, rh
    new[RHO_PREV], new[RHO] = st[RHO], rh
    new[ALPHA], new[OMEGA] = st[ALPHA_NEW], st[OMEGA_NEW]
    new[BETA] = beta_of(rh, st[RHO], st[ALPHA_NEW], st[OMEGA_NEW])
    new[IT] = st[IT] + 1
    new[RES] = res_new
    new[STAGNATED] = stagnated.to(st.dtype)
    new[RUNNING] = (~(stagnated | conv)).to(st.dtype)
    _commit(st, new)


class ShardBiCGSTABPasses:
    """The three passes in their sharded modes for one z-shard, in place
    on the solver's buffers and the shard's copy of the state, the
    finalize split as in `cg_kernels.ShardCGPasses`: :meth:`pv`,
    :meth:`st` and :meth:`xr` return the shard's float64 shares of their
    dots (1, 3 and 2 values), the caller sums them over the shards
    (``comm.sum``, float64) and hands the sums to the ``*_recur``
    methods, which round each to float once.

    ``c`` holds the owned block's constants (``c.nz = nzl``), ``z_off``
    the shard's first global plane, ``nz_g`` the global plane count.  pv
    reads the halo-padded r, p, v and the owned r̂, st the halo-padded r
    and v′; xr updates the owned x and r.  With ``ny_g`` (and ``y_off``
    the shard's first global row) the (z, y) passes: every buffer — x,
    r̂, s and t too — is the block padded one plane and one row a side,
    and the passes write the owned points of their padded outputs.  On
    the CPU, or with ``plain=True``, the plain versions run with the
    recurrences as 0-d tensor operations."""

    def __init__(self, c: BiCGConsts, z_off: int, nz_g: int, device,
                 plain: bool = False, y_off: int = 0, ny_g: int = None):
        self.c, self.z_off, self.nz_g = c, int(z_off), int(nz_g)
        self.y_off, self.ny_g = int(y_off), ny_g
        self.rows = ny_g is not None
        self.c_pad = dataclasses.replace(
            c, nz=c.nz + 2, ny=c.ny + 2 if self.rows else c.ny)
        # the padded block's global (plane, row) bases and counts
        self.base = (self.z_off - 1, self.nz_g) + (
            (self.y_off - 1, self.ny_g) if self.rows else ())
        self.plain = plain or torch.device(device).type == "cpu"
        self._bufs = None

    def _buffers(self, like):
        """The partials and a float64 fold output for each pass."""
        if self._bufs is None:
            self._bufs = (_partials(self.c, like),) + tuple(
                torch.empty(n, dtype=torch.float64, device=like.device)
                for n in (1, 3, 2))
        return self._bufs

    def _launch(self, pass_name, wrapper, ptrs, c, base, derivs=True):
        """Pass ``pass_name``'s sharded entry point: ``cfd_bicg_*_rows``
        in the (z, y) mode, ``cfd_bicg_*_sharded`` otherwise."""
        mode = "rows" if self.rows else "sharded"
        _launch_sharded(f"cfd_bicg_{pass_name}_{mode}", wrapper,
                        ptrs[0].device, ptrs, c, *base, derivs=derivs)

    def pv(self, r, p, v, rhat, pn, vn, st):
        """pn ← p′, vn ← v′ on the owned points; the shard's
        (⟨r̂, v′⟩,)."""
        if not self.plain:
            _check(self.c_pad, r, p, v)
            _check(self.c_pad if self.rows else self.c, rhat, pn, vn)
            part, out, _, _ = self._buffers(r)
            self._launch("pv", pass_pv, (
                r, p, v, rhat, pn, vn, st, part, out), self.c_pad,
                self.base)
            return out
        pn_, vn_, rhv = pass_pv_plain(r, p, v, rhat, st[BETA], st[OMEGA],
                                      self.c_pad, *self.base)
        self._own(pn).copy_(pn_)
        self._own(vn).copy_(vn_)
        return rhv[None]

    def _own(self, t):
        """The owned points of a pass output: a padded buffer's in the
        (z, y) mode, the tensor itself (already owned-size) otherwise."""
        return _own(t) if self.rows else t

    def pv_recur(self, sums, st):
        if not self.plain:
            native.launch("cfd_bicg_pv_recur", st.device, native.ptr(sums),
                          native.ptr(st))
            return
        pv_recur_plain(sums[0].to(st.dtype), st)

    def st(self, r, vn, s, t, st):
        """s, t ← the st pass on the owned points; the shard's
        (⟨s,s⟩, ⟨t,s⟩, ⟨t,t⟩)."""
        if not self.plain:
            _check(self.c_pad, r, vn)
            _check(self.c_pad if self.rows else self.c, s, t)
            part, _, out, _ = self._buffers(r)
            self._launch("st", pass_st, (
                r, vn, s, t, st, part, out), self.c_pad, self.base)
            return out
        s_, t_, ss, ts, tt = pass_st_plain(r, vn, st[ALPHA_NEW], self.c_pad,
                                           *self.base)
        self._own(s).copy_(s_)
        self._own(t).copy_(t_)
        return torch.stack([ss, ts, tt])

    def st_recur(self, sums, st):
        if not self.plain:
            native.launch("cfd_bicg_st_recur", st.device, native.ptr(sums),
                          native.ptr(st))
            return
        ss, ts, tt = sums.to(st.dtype)
        st_recur_plain(ss, ts, tt, st)

    def xr(self, x, r, pn, s, t, rhat, st):
        """x, r ← the update on the owned points; the shard's
        (⟨r′,r′⟩, ⟨r̂,r′⟩)."""
        c, base = self.c, (self.z_off, self.nz_g)
        if self.rows:
            c, base = self.c_pad, self.base
        if not self.plain:
            _check(c, x, r, pn, s, t, rhat)
            part, _, _, out = self._buffers(x)
            self._launch("xr", pass_xr, (
                x, r, pn, s, t, rhat, st, part, out), c, base, derivs=False)
            return out
        run = st[RUNNING] > 0
        x2, r2, rr, rh = pass_xr_plain(x, pn, s, t, rhat, st[ALPHA_EFF],
                                       st[OMEGA_EFF], c, *base)
        xo, ro = self._own(x), self._own(r)
        xo.copy_(torch.where(run, x2, xo))
        ro.copy_(torch.where(run, r2, ro))
        return torch.stack([rr, rh])

    def xr_recur(self, sums, st):
        c = self.c
        if not self.plain:
            native.launch("cfd_bicg_xr_recur", st.device, native.ptr(sums),
                          native.ptr(st), max(1, int(c.check_interval)))
            return
        rr, rh = sums.to(st.dtype)
        xr_recur_plain(rr, rh, st, c)
