"""The whole-solve 2D multigrid kernel (counterpart of
`cfd_tpu/ops/pallas/vmem_mg.py`'s ``make_mg_vmem_solve``, `:114-225`).

The reference runs the entire 2D multigrid solve — the outer convergence
``while_loop``, every level's sweeps, the residuals, restriction,
prolongation and the coarsest 40 sweeps — inside one Pallas kernel with
the hierarchy in VMEM: a 129² hierarchy is under 1 MB, so a launch per
pass would be all latency.  Here it is one cooperative CUDA launch,
``mg_solve_kernel`` (``cfd_tpu_torch/csrc/mg_solve.cu``): grid-stride
passes with grid barriers between them, the level arrays in one device
buffer (L2-resident at these sizes), the coarse levels run by one block
alone, the residual norm folded in a fixed order.  The host launches once
per solve and reads nothing.

The algorithm is ``make_multigrid``'s 2D body (`multigrid.py:332-346`),
the correction form, with the reference kernel's outputs: (x, initial
residual, final residual, iterations, running) as 0-d tensors.  Left out:
the TPU's weight-matrix transfers (`vmem_mg.py:78-111`, a Mosaic
workaround; restriction and prolongation are the strided stencils of
``mg_kernels.restrict`` / ``prolong``) and the VMEM budget gate
(`mg_vmem_supported`, `:62-75`).
"""

from __future__ import annotations

import ctypes

import torch

from ...boundary.apply import apply_neumann_scalar
from .. import stencils
from . import mg_kernels as mgk
from . import native

MAX_LEVELS = 12   # the kernel's Levels capacity (multigrid._build_levels)


def mg_solve_plain(x0, rhs, levels, pre, post, tolerance, abs_tol,
                   max_iter, check_interval):
    """The kernel's algorithm as plain tensor code; reads the stop flag
    on the host once per iteration."""
    lv0 = levels[0]

    def b_minus_Ae(b, e):
        return mgk.residual_plain(e, b, lv0)

    x = apply_neumann_scalar(x0)
    ix = stencils.interior_index(x)
    b = torch.zeros_like(x)
    b[ix] = -(rhs[ix] - stencils.laplacian(x, lv0.inv_dx2, lv0.inv_dy2))
    init_res = torch.sqrt(torch.sum(b * b))
    tol = torch.clamp_min(tolerance * init_res, abs_tol)
    already = bool(init_res < abs_tol)
    e = torch.zeros_like(b)
    res, it, running = init_res, 0, not already
    ci = max(1, int(check_interval))
    while running and it < max_iter:
        r = b_minus_Ae(b, e)
        e = e + mgk.v_cycle(levels, 0, r, pre, post, False,
                            mgk.rb_sweep_inplace_plain)
        r2 = b_minus_Ae(b, e)
        res_new = torch.sqrt(torch.sum(r2 * r2))
        conv = it % ci == 0 and bool((res_new < tol) | (res_new < abs_tol))
        it, res, running = it + 1, res_new, not conv
    dev = x0.device
    return (apply_neumann_scalar(x + e), init_res, res,
            torch.tensor(it, dtype=torch.int32, device=dev),
            torch.tensor(running, device=dev))


def _work_size(levels) -> int:
    n = [lv.shape[1] * lv.shape[2] for lv in levels]
    return 2 * n[0] + 3 * sum(n)


def mg_solve(x0, rhs, levels, pre, post, tolerance, abs_tol, max_iter,
             check_interval):
    """(x, r0, res, iterations, running) — ``mg_solve_kernel``, one
    cooperative launch, on CUDA.  x0 and rhs are left as they were."""
    if native.on_cpu(x0):
        return mg_solve_plain(x0, rhs, levels, pre, post, tolerance,
                              abs_tol, max_iter, check_interval)
    native.check_cuda(x0, rhs)
    shape = levels[0].shape
    for f in (x0, rhs):
        if tuple(f.shape) != shape:
            raise ValueError(f"expected fields of shape {shape}, got "
                             f"{tuple(f.shape)}")
    n_lv = len(levels)
    dims = (ctypes.c_int * (2 * n_lv))(
        *(d for lv in levels for d in lv.shape[1:]))
    coefs = (ctypes.c_float * (3 * n_lv))(
        *(c for lv in levels for c in (lv.inv_dx2, lv.inv_dy2,
                                       lv.inv_factor)))
    dev = x0.device
    x = torch.empty_like(x0)
    work = torch.empty(_work_size(levels), dtype=x0.dtype, device=dev)
    nblk = native.library().cfd_mg_solve_blocks(1, shape[1], shape[2])
    part = torch.empty(nblk, dtype=x0.dtype, device=dev)
    stats = torch.empty(4, dtype=x0.dtype, device=dev)
    native.launch("cfd_mg_solve", dev, *map(native.ptr, (
        x0, rhs, x, work, part, stats)), n_lv, ctypes.addressof(dims),
        ctypes.addressof(coefs), tolerance, abs_tol, int(max_iter),
        max(1, int(check_interval)), int(pre), int(post))
    mg_solve.launches += 1
    return x, stats[0], stats[1], stats[2].to(torch.int32), stats[3] > 0


mg_solve.launches = 0
WRAPPERS = (mg_solve,)


def make_mg_vmem_solve(levels, pre, post, tolerance, abs_tol,
                       max_iterations, check_interval, plain: bool = False):
    """fn(x, rhs) -> (x, r0, res, iterations, running): the whole 2D
    multigrid solve on ``levels`` (`multigrid._build_levels`, shapes
    (1, ny, nx)).  ``plain=True`` runs the plain version on a CUDA device
    too (a reference switch for checks on the card)."""
    if any(lv.shape[0] != 1 for lv in levels):
        raise ValueError("the whole-solve multigrid is for 2D grids")
    if not 2 <= len(levels) <= MAX_LEVELS or pre < 1 or post < 1:
        raise ValueError("the whole-solve multigrid needs 2..12 levels and "
                         "pre, post >= 1")
    run = mg_solve_plain if plain else mg_solve

    def solve(x, rhs):
        return run(x, rhs, levels, pre, post, tolerance, abs_tol,
                   max_iterations, check_interval)

    return solve
