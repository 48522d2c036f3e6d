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

The sharded modes (``z_base``, ``nz_g`` given; the z-decomposed CG of
`parallel.fused_cg`): ``lap_dot`` is the TPU kernel
``make_lap_dot_sharded`` (`cg_kernels.py:437-510`) — it takes a shard's
halo-padded block of ``c.nz = nzl + 2`` planes whose plane k is global
plane ``z_base + k``, masks p′ to the *global* Dirichlet-0 space (so a
halo plane carries the neighbour shard's p′), zeroes Ap′ at the global
shells and returns the owned planes and their share of ⟨p′, Ap′⟩;
``cg_update`` updates a shard's owned block (``c.nz = nzl``) on every
owned plane but the global shells (the reference's jnp axpy,
`parallel/fused_cg.py:216-219`).  Both count on ``global_nz_launches``.
The solver loop runs :class:`ShardCGPasses`, whose finalize is split in
two: each shard folds its partials to one value, the communicator sums
the shards' values (``comm.sum``), and a recurrence kernel reads the sum.

The (z, y) modes (``y_base``, ``ny_g`` given too; ``make_lap_dot_
sharded``'s ``global_ny``, `cg_kernels.py:469-480`): every buffer is a
shard's block padded one plane and one row a side (``c`` its constants,
plane k and row j the global ``z_base + k`` and ``y_base + j``); K1 masks
p′ to the global Dirichlet-0 space, writes p′ and Ap′ in the padded
layout on the owned points and returns the owned points' share of the
dot; K2 updates the owned points but the global shells.  Both count on
``global_ny_launches`` (``cg_lap_dot_kernel<true, true>``,
``cg_update_kernel<true, true>``).
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


def _partials(c: CGConsts, like: torch.Tensor, nz=None) -> torch.Tensor:
    """Room for a pass's per-block partials over ``nz`` planes (default
    ``c.nz``)."""
    n = native.library().cfd_cg_partials(c.nz if nz is None else nz, c.ny,
                                         c.nx)
    return torch.empty(n, dtype=like.dtype, device=like.device)


def _launch_lap_dot(r, p, pn, ap, st, part, c: CGConsts):
    native.launch("cfd_cg_lap_dot", r.device, *map(native.ptr, (
        r, p, pn, ap, st, part)), c.nz, c.ny, c.nx, c.inv_dx2, c.inv_dy2,
        c.inv_dz2, c.scale)
    lap_dot.launches += 1


def _launch_lap_dot_sharded(r, p, pn, ap, st, part, out, c: CGConsts,
                            z_base, nz_g):
    native.launch("cfd_cg_lap_dot_sharded", r.device, *map(native.ptr, (
        r, p, pn, ap, st, part, out)), c.nz, c.ny, c.nx, c.inv_dx2,
        c.inv_dy2, c.inv_dz2, c.scale, int(z_base), int(nz_g))
    native.count_launch(lap_dot, "global_nz")


def _launch_update_sharded(x, r, pn, ap, st, part, out, c: CGConsts,
                           z_base, nz_g):
    native.launch("cfd_cg_update_sharded", x.device, *map(native.ptr, (
        x, r, pn, ap, st, part, out)), c.nz, c.ny, c.nx, int(z_base),
        int(nz_g))
    native.count_launch(cg_update, "global_nz")


def _launch_rows(name, wrapper, bufs, st, part, out, c: CGConsts, z_base,
                 nz_g, y_base, ny_g, *consts):
    """One (z, y) pass on padded blocks, ``consts`` the K1 coefficients
    (none for K2)."""
    native.launch(name, bufs[0].device, *map(native.ptr, (*bufs, st, part,
                                                         out)),
                  c.nz, c.ny, c.nx, *consts, int(z_base), int(nz_g),
                  int(y_base), int(ny_g))
    native.count_launch(wrapper, "global_ny")


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

def _owned_rows(mask):
    """``mask`` without the padded block's end planes and rows."""
    mask = mask.clone()
    mask[0] = mask[-1] = False
    mask[:, 0] = mask[:, -1] = False
    return mask


def lap_dot_plain(r, p, beta, c: CGConsts, z_base: int = 0,
                  nz_g: int = None, y_base: int = 0, ny_g: int = None):
    """(p′, Ap′, ⟨p′, Ap′⟩) with zero shells on p′ and Ap′.  With ``nz_g``
    the sharded mode: r and p are a shard's halo-padded block (plane k is
    global plane ``z_base + k``), p′ is masked to the global Dirichlet-0
    space on every plane, and the owned planes of p′ and Ap′ come back
    with their share of the dot.  With ``ny_g`` too the (z, y) mode: the
    block is padded one row a side as well (row j global ``y_base + j``)
    and the owned planes and rows come back."""
    if ny_g is not None:
        mask = stencils.global_interior_mask(c.shape, z_base, nz_g,
                                             r.device, y_base, ny_g)
        pn = torch.where(mask, c.scale * r + beta * p, torch.zeros_like(r))
        ap = torch.zeros_like(r)
        own = stencils.interior_index(ap)
        ap[own] = torch.where(_owned_rows(mask)[own], -stencils.laplacian(
            pn, c.inv_dx2, c.inv_dy2, c.inv_dz2), 0.0)
        pn, ap = pn[1:-1, 1:-1], ap[1:-1, 1:-1]
        return pn, ap, torch.sum(ap[:, :, 1:-1] * pn[:, :, 1:-1])
    if nz_g is not None:
        mask = stencils.global_interior_mask(c.shape, z_base, nz_g,
                                             r.device)
        pn = torch.where(mask, c.scale * r + beta * p, torch.zeros_like(r))
        own = stencils.interior_index(pn)
        ap = torch.zeros_like(r[1:-1])
        ap[:, 1:-1, 1:-1] = torch.where(
            mask[own], -stencils.laplacian(pn, c.inv_dx2, c.inv_dy2,
                                           c.inv_dz2), 0.0)
        pn = pn[1:-1]
        return pn, ap, torch.sum(ap[:, 1:-1, 1:-1] * pn[:, 1:-1, 1:-1])
    mask = stencils.interior_mask(c.shape, torch.bool, r.device)
    pn = torch.where(mask, c.scale * r + beta * p, torch.zeros_like(r))
    ap = torch.zeros_like(r)
    ap[stencils.interior_index(ap)] = -stencils.laplacian(
        pn, c.inv_dx2, c.inv_dy2, c.inv_dz2)
    return pn, ap, torch.sum(stencils.interior(ap) * stencils.interior(pn))


def lap_dot(r, p, beta, c: CGConsts, z_base: int = 0, nz_g: int = None,
            y_base: int = 0, ny_g: int = None):
    """(p′, Ap′, ⟨p′, Ap′⟩) — ``cg_lap_dot_kernel`` and its finalize on
    CUDA; ``beta`` a float or a 0-d tensor.  With ``nz_g`` the sharded
    mode of :func:`lap_dot_plain`: ``cg_lap_dot_kernel<true>`` and the
    shard's fold (the dot is the shard's share); with ``ny_g`` too its
    (z, y) mode, ``cg_lap_dot_kernel<true, true>`` (the owned planes and
    rows of its padded outputs returned)."""
    if native.on_cpu(r):
        return lap_dot_plain(r, p, beta, c, z_base, nz_g, y_base, ny_g)
    _check(c, r, p)
    st = _one_shot_state(r, BETA, beta)
    if ny_g is not None:
        pn, ap = torch.empty_like(r), torch.empty_like(r)
        out = r.new_empty(())
        _launch_rows("cfd_cg_lap_dot_rows", lap_dot, (r, p, pn, ap), st,
                     _rows_partials(c, r), out, c, z_base, nz_g, y_base,
                     ny_g, c.inv_dx2, c.inv_dy2, c.inv_dz2, c.scale)
        return pn[1:-1, 1:-1], ap[1:-1, 1:-1], out
    if nz_g is not None:
        pn, ap = (r.new_empty((c.nz - 2, c.ny, c.nx)) for _ in range(2))
        out = r.new_empty(())
        _launch_lap_dot_sharded(r, p, pn, ap, st,
                                _partials(c, r, c.nz - 2), out, c, z_base,
                                nz_g)
        return pn, ap, out
    pn, ap = torch.empty_like(r), torch.empty_like(r)
    _launch_lap_dot(r, p, pn, ap, st, _partials(c, r), c)
    return pn, ap, st[PAP]


# ---- cg_update --------------------------------------------------------------

def cg_update_plain(x, r, pn, ap, alpha, c: CGConsts, z_base: int = 0,
                    nz_g: int = None, y_base: int = 0, ny_g: int = None):
    """(x′, r′, ⟨r′, r′⟩): the α-updates on the interior, shells kept.
    With ``nz_g`` the sharded mode: a shard's owned block (plane k is
    global plane ``z_base + k``), every owned plane updated but the
    global shells, and the shard's share of the dot.  With ``ny_g`` too
    the (z, y) mode: every tensor the shard's block padded one plane and
    one row a side (row j global ``y_base + j``), its owned points
    updated but the global shells."""
    if ny_g is not None:
        mask = _owned_rows(stencils.global_interior_mask(
            c.shape, z_base, nz_g, x.device, y_base, ny_g))
        x2 = torch.where(mask, x + alpha * pn, x)
        r2 = torch.where(mask, r - alpha * ap, r)
        return x2, r2, torch.sum(torch.where(mask, r2 * r2, 0.0))
    if nz_g is not None:
        mask = stencils.global_interior_mask(c.shape, z_base, nz_g,
                                             x.device)
        x2 = torch.where(mask, x + alpha * pn, x)
        r2 = torch.where(mask, r - alpha * ap, r)
        return x2, r2, torch.sum(torch.where(mask, r2 * r2, 0.0))
    ix = stencils.interior_index(x)
    x2, r2 = x.clone(), r.clone()
    x2[ix] = x[ix] + alpha * pn[ix]
    r2[ix] = r[ix] - alpha * ap[ix]
    return x2, r2, torch.sum(r2[ix] * r2[ix])


def cg_update(x, r, pn, ap, alpha, c: CGConsts, z_base: int = 0,
              nz_g: int = None, y_base: int = 0, ny_g: int = None):
    """(x′, r′, ⟨r′, r′⟩) — ``cg_update_kernel`` and its finalize on CUDA
    (on copies of x and r); ``alpha`` a float or a 0-d tensor.  With
    ``nz_g`` the sharded mode of :func:`cg_update_plain`:
    ``cg_update_kernel<true>`` and the shard's fold; with ``ny_g`` too
    its (z, y) mode, ``cg_update_kernel<true, true>``."""
    if native.on_cpu(x):
        return cg_update_plain(x, r, pn, ap, alpha, c, z_base, nz_g, y_base,
                               ny_g)
    _check(c, x, r, pn, ap)
    x2, r2 = x.clone(), r.clone()
    st = _one_shot_state(x, ALPHA, alpha)
    if ny_g is not None:
        out = x.new_empty(())
        _launch_rows("cfd_cg_update_rows", cg_update, (x2, r2, pn, ap), st,
                     _rows_partials(c, x), out, c, z_base, nz_g, y_base,
                     ny_g)
        return x2, r2, out
    if nz_g is not None:
        out = x.new_empty(())
        _launch_update_sharded(x2, r2, pn, ap, st, _partials(c, x), out, c,
                               z_base, nz_g)
        return x2, r2, out
    _launch_update(x2, r2, pn, ap, st, _partials(c, x), c)
    return x2, r2, st[RR]


def _rows_partials(c: CGConsts, like):
    """Room for a (z, y) pass's partials: its owned points of the padded
    block ``c``."""
    return _partials(dataclasses.replace(c, nz=c.nz - 2, ny=c.ny - 2), like)


native.reset_counts(lap_dot, cg_update)
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
        lap_dot_recur_plain(pap, st)

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
        update_recur_plain(rr, st, c)


def lap_dot_recur_plain(pap, st):
    """K1's finalize recurrence as 0-d tensor operations: ⟨p′, Ap′⟩,
    breakdown, α; no change once the running flag is 0."""
    bd1 = pap.abs() < BREAKDOWN
    one, zero = torch.ones_like(pap), torch.zeros_like(pap)
    new = st.clone()
    new[PAP] = pap
    new[BD1] = bd1.to(st.dtype)
    new[ALPHA] = torch.where(bd1, zero, st[RHO] / torch.where(bd1, one, pap))
    st.copy_(torch.where(st[RUNNING] > 0, new, st))


def update_recur_plain(rr, st, c: CGConsts):
    """K2's finalize recurrence (`krylov.py:174-182`) as 0-d tensor
    operations: ρ, β, residual, check, breakdown, iteration count and
    running flag; no change once the running flag is 0."""
    run = st[RUNNING] > 0
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


class ShardCGPasses:
    """K1 and K2 in their sharded modes for one z-shard, in place on the
    solver's buffers and the shard's copy of the state, the finalize
    split in two: :meth:`lap_dot` and :meth:`update` return the shard's
    share of their dot (the fold, a 0-d tensor written in place on the
    card), the caller sums the shards' shares (``comm.sum``) and hands
    the sum to :meth:`lap_dot_recur` / :meth:`update_recur`.

    ``c`` holds the owned block's constants (``c.nz = nzl``), ``z_off``
    the shard's first global plane, ``nz_g`` the global plane count.
    K1 reads the halo-padded r and p (nzl + 2 planes) and writes the
    owned planes of p′ and Ap′; K2 updates the owned x and r.  With
    ``ny_g`` (and ``y_off`` the shard's first global row) the (z, y)
    passes: every buffer, x and Ap′ too, is the block padded one plane
    and one row a side, and both passes take the padded buffers.  On the
    CPU, or with ``plain=True``, the plain versions run with the
    recurrences as 0-d tensor operations."""

    def __init__(self, c: CGConsts, z_off: int, nz_g: int, device,
                 plain: bool = False, y_off: int = 0, ny_g: int = None):
        self.c, self.z_off, self.nz_g = c, int(z_off), int(nz_g)
        self.y_off, self.ny_g = int(y_off), ny_g
        self.rows = ny_g is not None
        self.c_pad = dataclasses.replace(
            c, nz=c.nz + 2, ny=c.ny + 2 if self.rows else c.ny)
        self.plain = plain or torch.device(device).type == "cpu"
        self._bufs = None

    def _buffers(self, like):
        """The partials (K1 and K2 launch over the same nzl planes) and
        one fold output a pass."""
        if self._bufs is None:
            self._bufs = (_partials(self.c, like), like.new_empty(()),
                          like.new_empty(()))
        return self._bufs

    def lap_dot(self, r, p, pn, ap, st):
        """pn ← p′, ap ← Ap′ on the owned planes; the shard's
        ⟨p′, Ap′⟩."""
        if self.rows:
            return self._lap_dot_rows(r, p, pn, ap, st)
        if not self.plain:
            _check(self.c_pad, r, p)
            _check(self.c, pn, ap)
            part, out, _ = self._buffers(r)
            _launch_lap_dot_sharded(r, p, pn, ap, st, part, out, self.c_pad,
                                    self.z_off - 1, self.nz_g)
            return out
        pn_, ap_, pap = lap_dot_plain(r, p, st[BETA], self.c_pad,
                                      self.z_off - 1, self.nz_g)
        pn.copy_(pn_)
        ap.copy_(ap_)
        return pap

    def _lap_dot_rows(self, r, p, pn, ap, st):
        if not self.plain:
            _check(self.c_pad, r, p, pn, ap)
            part, out, _ = self._buffers(r)
            _launch_rows("cfd_cg_lap_dot_rows", lap_dot, (r, p, pn, ap), st,
                         part, out, self.c_pad, self.z_off - 1, self.nz_g,
                         self.y_off - 1, self.ny_g, self.c.inv_dx2,
                         self.c.inv_dy2, self.c.inv_dz2, self.c.scale)
            return out
        pn_, ap_, pap = lap_dot_plain(r, p, st[BETA], self.c_pad,
                                      self.z_off - 1, self.nz_g,
                                      self.y_off - 1, self.ny_g)
        pn[1:-1, 1:-1] = pn_
        ap[1:-1, 1:-1] = ap_
        return pap

    def lap_dot_recur(self, pap, st):
        """The state's α from the shards' summed ⟨p′, Ap′⟩."""
        if not self.plain:
            native.launch("cfd_cg_lap_dot_recur", st.device,
                          native.ptr(pap), native.ptr(st))
            return
        lap_dot_recur_plain(pap, st)

    def update(self, x, r, pn, ap, st):
        """x, r ← the α-updates on the owned block; the shard's
        ⟨r′, r′⟩."""
        c, base = self.c, (self.z_off, self.nz_g)
        if self.rows:
            c, base = self.c_pad, (self.z_off - 1, self.nz_g,
                                   self.y_off - 1, self.ny_g)
        if not self.plain:
            _check(c, x, r, pn, ap)
            part, _, out = self._buffers(x)
            if self.rows:
                _launch_rows("cfd_cg_update_rows", cg_update,
                             (x, r, pn, ap), st, part, out, c, *base)
            else:
                _launch_update_sharded(x, r, pn, ap, st, part, out, c,
                                       *base)
            return out
        run = st[RUNNING] > 0
        x2, r2, rr = cg_update_plain(x, r, pn, ap, st[ALPHA], c, *base)
        x.copy_(torch.where(run, x2, x))
        r.copy_(torch.where(run, r2, r))
        return rr

    def update_recur(self, rr, st):
        """The rest of the iteration's recurrence from the shards' summed
        ⟨r′, r′⟩."""
        c = self.c
        if not self.plain:
            native.launch("cfd_cg_update_recur", st.device, native.ptr(rr),
                          native.ptr(st), c.scale,
                          max(1, int(c.check_interval)))
            return
        update_recur_plain(rr, st, c)
