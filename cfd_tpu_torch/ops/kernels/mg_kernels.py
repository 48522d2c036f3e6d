"""The multigrid smoother and V-cycle (counterpart of
`cfd_tpu/ops/pallas/mg_kernels.py`'s ``make_mg_rb_sweep`` `:50-337`, and
of the V-cycle pieces of `cfd_tpu/solvers/poisson/multigrid.py`:
``_rb_sweep`` `:101-118`, ``_fw_axis`` / ``_restrict`` `:121-139`,
``_interp_axis`` / ``_prolong`` `:142-169`, ``_v_cycle`` `:172-208`).

A sweep is one red-black Gauss-Seidel sweep of A x = b, A = −∇² on the
Dirichlet-0 interior: at one colour of the interior checkerboard
(red: (i + j + k) even; k = 0 on a 2D field)

    nb = (x[i+1] + x[i−1])·inv_dx2 + (x[j+1] + x[j−1])·inv_dy2
         + (x[k+1] + x[k−1])·inv_dz2
    x  = (b + nb)·inv_factor

then at the other.  Three variants, as the TPU kernel's: red-first (the
default), red-first with the post-sweep residual field r = b + ∇²x_new
(zero shell; the input the restriction needs), and black-first (the
symmetric V-cycle's post-smoothing order).

The TPU kernel streams z-planes through a VMEM ring, red one plane ahead
of black, the residual one more plane behind, all in one HBM pass.  On
Hopper the blocks run in no order, so :func:`rb_sweep` launches by colour
(``cfd_tpu_torch/csrc/mg_kernels.cu``): one launch per colour, one thread
per point of the colour, updating x IN PLACE (safe: a colour reads only
the other colour) — where the JAX function is pure — then, for the
residual variant, a third launch.  The TPU's lane padding of 2^k+1 grids
and its VMEM gate are left out: any (nz, ny, nx) with nz == 1 or nz ≥ 3
runs.  Built with -fmad=false in the plain version's operation order, so
the kernel matches :func:`rb_sweep_plain` bit for bit.

The sharded modes (the TPU kernel's ``global_nz`` and ``global_ny``,
`mg_kernels.py:50-91`): ``rb_sweep(..., z_off=, gnz=[, y_off=, gny=])``
sweeps a shard's block padded with halo planes (and rows) that hold its
neighbours' x and b — local plane k is global plane ``z_off + k`` of
``gnz``, local row j global row ``y_off + j`` of ``gny`` (without
``y_off`` the rows are whole).  A point is updated, and its residual
formed, inside the global Dirichlet-0 interior and the block's own
interior only; the checkerboard is keyed on the global index.  So on a
block with h halo planes (rows) a side the swept x is the single-device
sweep's from h ≥ 2 in, the residual from h ≥ 3 in (the kernel source
says why); `parallel.fused_mg` takes h = 4.  The z-only mode counts on
``rb_sweep.global_nz_launches``, the (z, y) one on
``global_ny_launches``; :func:`rb_sweep_inplace_plain` takes the same
keywords.

Restriction and prolongation are plain tensor code, as the reference's
jnp: full weighting and (bi/tri)linear interpolation with the same
separable operation order (z, then y, then x).  :func:`v_cycle` is the
reference's V-cycle in the form of its fused branch — the sweeps smooth
the level's iterate from zero, the pre-smoothing's last sweep emits the
residual — which is the jnp branch's arithmetic (GS is affine in (x, b),
and b + ∇²x is b − A·x exactly).
"""

from __future__ import annotations

import torch

from .. import stencils
from . import native

COARSE_SWEEPS = 40   # red-black sweeps of the coarsest solve
_PARITY = {"red": 0, "black": 1}


def _order(first: str):
    if first not in _PARITY:
        raise ValueError(f"first must be 'red' or 'black', got {first!r}")
    return ("red", "black") if first == "red" else ("black", "red")


# ---- the sweep ----------------------------------------------------------------

def _shard_masks(shape, device, z_off, gnz, y_off=None, gny=None):
    """(points a sharded sweep may update, their global parity): the
    block's interior inside the global Dirichlet-0 interior, and
    (i + jg + kg) % 2, on a shard's halo block of ``shape``."""
    nz, ny, nx = shape
    kg = z_off + torch.arange(nz, device=device)[:, None, None]
    jg = torch.arange(ny, device=device)[None, :, None]
    if y_off is not None:
        jg = jg + y_off
    else:
        gny = ny
    i = torch.arange(nx, device=device)[None, None, :]
    inside = (stencils.interior_mask(shape, torch.bool, device)
              & (kg > 0) & (kg < gnz - 1) & (jg > 0) & (jg < gny - 1))
    return inside, (i + jg + kg) % 2


def rb_sweep_plain(x, b, lv, order=("red", "black"), shard=None):
    """One red-black GS sweep as plain tensor code (``_rb_sweep``); a new
    tensor.  ``lv`` carries ``shape``, ``inv_dx2``, ``inv_dy2``,
    ``inv_dz2`` and ``inv_factor``; ``shard`` (z_off, gnz, y_off, gny)
    sweeps a shard's halo block instead (the module docstring)."""
    if shard is not None:
        inside, parity = _shard_masks(x.shape, x.device, *shard)
    for color in order:
        if shard is None:
            mask = stencils.checkerboard_mask(lv.shape, _PARITY[color],
                                              x.device)
        else:
            mask = inside & (parity == _PARITY[color])
        nb = ((stencils.sx_p(x) + stencils.sx_m(x)) * lv.inv_dx2
              + (stencils.sy_p(x) + stencils.sy_m(x)) * lv.inv_dy2)
        if x.shape[0] > 1:
            nb = nb + (stencils.sz_p(x) + stencils.sz_m(x)) * lv.inv_dz2
        # A x = b ⇔ diag·x − nb = b (diag = 1/inv_factor)
        x = torch.where(mask, (b + nb) * lv.inv_factor, x)
    return x


def residual_plain(x, b, lv, shard=None):
    """r = b − A·x on the interior (A = −∇², Dirichlet-0), zero shell;
    with ``shard``, zero outside the global interior too."""
    r = torch.zeros_like(b)
    ix = stencils.interior_index(b)
    lap = stencils.laplacian(x, lv.inv_dx2, lv.inv_dy2, lv.inv_dz2)
    if shard is None:
        r[ix] = b[ix] - (-lap)
    else:
        inside = _shard_masks(x.shape, x.device, *shard)[0]
        r[ix] = torch.where(inside[ix], b[ix] - (-lap), 0.0)
    return r


def _shard_of(z_off, gnz, y_off, gny):
    """The sharded mode's (z_off, gnz, y_off, gny), None on one device."""
    if z_off is None:
        if y_off is not None:
            raise ValueError("y_off needs z_off")
        return None
    if gnz is None or (y_off is not None and gny is None):
        raise ValueError("a sharded sweep needs gnz (and gny with y_off)")
    return (int(z_off), int(gnz), None if y_off is None else int(y_off),
            None if y_off is None else int(gny))


def rb_sweep_inplace_plain(x, b, lv, first="red", residual=None, *,
                           z_off=None, gnz=None, y_off=None, gny=None):
    """:func:`rb_sweep`'s contract with the plain version: x updated in
    place, ``residual`` (when given) filled."""
    shard = _shard_of(z_off, gnz, y_off, gny)
    x.copy_(rb_sweep_plain(x, b, lv, _order(first), shard))
    if residual is not None:
        residual.copy_(residual_plain(x, b, lv, shard))
    return x


def rb_sweep(x, b, lv, first="red", residual=None, *, z_off=None,
             gnz=None, y_off=None, gny=None):
    """One red-black sweep of A x = b, IN PLACE on x, starting with the
    ``first`` colour; with ``residual`` (a tensor like x) the post-sweep
    residual b + ∇²x is written there (zero shell).  With ``z_off`` and
    ``gnz`` (and ``y_off``, ``gny``) the sharded modes on a shard's halo
    block (the module docstring); ``lv`` then gives the coefficients, x
    the block's shape.  On CUDA the colour launches of
    ``cfd_mg_rb_sweep`` (``cfd_mg_rb_sweep_shard``); on the CPU the
    plain version."""
    shard = _shard_of(z_off, gnz, y_off, gny)
    if native.on_cpu(x):
        return rb_sweep_inplace_plain(x, b, lv, first, residual,
                                      z_off=z_off, gnz=gnz, y_off=y_off,
                                      gny=gny)
    parity = _PARITY[_order(first)[0]]
    outs = (x, b) if residual is None else (x, b, residual)
    native.check_cuda(*outs)
    shape = lv.shape if shard is None else tuple(x.shape)
    nz, ny, nx = shape
    if nz == 2 or (shard is not None and nz < 3) \
            or any(tuple(t.shape) != shape for t in outs):
        raise ValueError(f"expected fields of shape {shape} (nz == 1 or "
                         f"nz >= 3; a shard's block nz >= 3)")
    args = (native.ptr(x), native.ptr(b),
            None if residual is None else native.ptr(residual),
            nz, ny, nx, lv.inv_dx2, lv.inv_dy2, lv.inv_dz2, lv.inv_factor,
            parity)
    if shard is None:
        native.launch("cfd_mg_rb_sweep", x.device, *args)
        native.count_launch(rb_sweep)
    else:
        z0, gz, y0, gy = shard
        native.launch("cfd_mg_rb_sweep_shard", x.device, *args, z0, gz,
                      0 if y0 is None else y0, 0 if y0 is None else gy)
        native.count_launch(rb_sweep,
                            "global_nz" if y0 is None else "global_ny")
    return x


native.reset_counts(rb_sweep)
WRAPPERS = (rb_sweep,)


# ---- the inter-level transfers --------------------------------------------------

def _take(a, dim, start, stop, step=1):
    index = [slice(None)] * a.dim()
    index[dim] = slice(start, stop, step)
    return a[tuple(index)]


def fw_axis(a, dim):
    """Separable full weighting [1/4, 1/2, 1/4] onto the interior coarse
    nodes along ``dim``: coarse I ∈ [1, nc−2] gathers fine 2I−1, 2I,
    2I+1."""
    nf = a.shape[dim]
    return (0.25 * _take(a, dim, 1, nf - 3, 2)
            + 0.5 * _take(a, dim, 2, nf - 2, 2)
            + 0.25 * _take(a, dim, 3, nf - 1, 2))


def restrict(r_f, coarse_shape):
    """Full-weighting restriction to the coarse interior (zero shell):
    z, then y, then x."""
    out = torch.zeros(coarse_shape, dtype=r_f.dtype, device=r_f.device)
    if r_f.shape[0] > 1:
        out[1:-1, 1:-1, 1:-1] = fw_axis(fw_axis(fw_axis(r_f, 0), 1), 2)
    else:
        out[0, 1:-1, 1:-1] = fw_axis(fw_axis(r_f[0], 0), 1)
    return out


def interp_axis(a, dim):
    """Linear interpolation doubling ``dim``: out[2i] = a[i],
    out[2i+1] = (a[i] + a[i+1])/2, length 2·(n−1)+1."""
    n = a.shape[dim]
    shape = list(a.shape)
    shape[dim] = 2 * (n - 1) + 1
    out = a.new_empty(shape)
    index = [slice(None)] * a.dim()
    index[dim] = slice(0, None, 2)
    out[tuple(index)] = a
    index[dim] = slice(1, None, 2)
    out[tuple(index)] = 0.5 * (_take(a, dim, 0, n - 1)
                               + _take(a, dim, 1, n))
    return out


def prolong(e_c):
    """(Bi/tri)linear interpolation to the fine grid, zero shell."""
    if e_c.shape[0] > 1:
        a = interp_axis(interp_axis(interp_axis(e_c, 0), 1), 2)
    else:
        a = interp_axis(interp_axis(e_c[0], 0), 1)[None]
    return stencils.set_interior(torch.zeros_like(a), stencils.interior(a))


# ---- the V-cycle ----------------------------------------------------------------

def v_cycle(levels, lvl, b, pre, post, symmetric, sweep=rb_sweep):
    """The correction x ≈ A⁻¹b at level ``lvl`` from one V-cycle started
    at zero (``_v_cycle``'s fused branch): ``pre`` sweeps, the last one
    emitting the residual, restriction, the coarser cycle, prolongation
    added, ``post`` sweeps (black-first when ``symmetric``, keeping the
    MG-CG preconditioner SPD); the coarsest level is solved by
    ``COARSE_SWEEPS`` red-first sweeps.  ``sweep`` is :func:`rb_sweep` or
    :func:`rb_sweep_inplace_plain` (pre, post ≥ 1)."""
    lv = levels[lvl]
    x = torch.zeros_like(b)
    if lvl == len(levels) - 1:
        for _ in range(COARSE_SWEEPS):
            sweep(x, b, lv)
        return x
    r = torch.empty_like(b)
    for _ in range(pre - 1):
        sweep(x, b, lv)
    sweep(x, b, lv, residual=r)
    r_c = restrict(r, levels[lvl + 1].shape)
    del r
    e_c = v_cycle(levels, lvl + 1, r_c, pre, post, symmetric, sweep)
    x.add_(prolong(e_c))
    for _ in range(post):
        sweep(x, b, lv, first="black" if symmetric else "red")
    return x
