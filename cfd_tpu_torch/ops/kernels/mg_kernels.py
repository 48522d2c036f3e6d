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

def rb_sweep_plain(x, b, lv, order=("red", "black")):
    """One red-black GS sweep as plain tensor code (``_rb_sweep``); a new
    tensor.  ``lv`` carries ``shape``, ``inv_dx2``, ``inv_dy2``,
    ``inv_dz2`` and ``inv_factor``."""
    for color in order:
        mask = stencils.checkerboard_mask(lv.shape, _PARITY[color],
                                          x.device)
        nb = ((stencils.sx_p(x) + stencils.sx_m(x)) * lv.inv_dx2
              + (stencils.sy_p(x) + stencils.sy_m(x)) * lv.inv_dy2)
        if x.shape[0] > 1:
            nb = nb + (stencils.sz_p(x) + stencils.sz_m(x)) * lv.inv_dz2
        # A x = b ⇔ diag·x − nb = b (diag = 1/inv_factor)
        x = torch.where(mask, (b + nb) * lv.inv_factor, x)
    return x


def residual_plain(x, b, lv):
    """r = b − A·x on the interior (A = −∇², Dirichlet-0), zero shell."""
    r = torch.zeros_like(b)
    ix = stencils.interior_index(b)
    lap = stencils.laplacian(x, lv.inv_dx2, lv.inv_dy2, lv.inv_dz2)
    r[ix] = b[ix] - (-lap)
    return r


def rb_sweep_inplace_plain(x, b, lv, first="red", residual=None):
    """:func:`rb_sweep`'s contract with the plain version: x updated in
    place, ``residual`` (when given) filled."""
    x.copy_(rb_sweep_plain(x, b, lv, _order(first)))
    if residual is not None:
        residual.copy_(residual_plain(x, b, lv))
    return x


def rb_sweep(x, b, lv, first="red", residual=None):
    """One red-black sweep of A x = b, IN PLACE on x, starting with the
    ``first`` colour; with ``residual`` (a tensor like x) the post-sweep
    residual b + ∇²x is written there (zero shell).  On CUDA the colour
    launches of ``cfd_mg_rb_sweep``; on the CPU the plain version."""
    if native.on_cpu(x):
        return rb_sweep_inplace_plain(x, b, lv, first, residual)
    parity = _PARITY[_order(first)[0]]
    outs = (x, b) if residual is None else (x, b, residual)
    native.check_cuda(*outs)
    nz, ny, nx = lv.shape
    if nz == 2 or any(tuple(t.shape) != (nz, ny, nx) for t in outs):
        raise ValueError(f"expected fields of shape {lv.shape} (nz == 1 or "
                         f"nz >= 3)")
    native.launch("cfd_mg_rb_sweep", x.device, native.ptr(x),
                  native.ptr(b),
                  None if residual is None else native.ptr(residual),
                  nz, ny, nx, lv.inv_dx2, lv.inv_dy2, lv.inv_dz2,
                  lv.inv_factor, parity)
    rb_sweep.launches += 1
    return x


rb_sweep.launches = 0
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
