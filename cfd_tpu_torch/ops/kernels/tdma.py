"""Line Thomas solves of the spectral pressure paths (counterpart of
`cfd_tpu/ops/pallas/tdma.py`): z-lines in 3D, and y-lines in 2D on the
same kernels (at the end).

After the xy DST the pressure system splits into one tridiagonal per
(y, x) mode along z:

    (mu + 2w)·x_k − w·(x_{k−1} + x_{k+1}) = r_k,   k = 1..nz−2,
    x_0 = x_{nz−1} = 0,   w = 1/dz²,   mu = λx + λy > 0.

Plain versions (plain loops over z, any dtype, any device):
:func:`tdma_z_fwd_reference` (forward sweep → d′, t),
:func:`tdma_z_bwd_reference` (back substitution, the twin of the
reference's function of the same name) and :func:`tdma_z_reference`
(both, the twin of the reference's full solve).  The wrappers
:func:`tdma_z_fwd` and :func:`tdma_z_bwd` launch the CUDA kernels on a CUDA
tensor and the plain versions on a CPU tensor.

The recurrence is the reference's, operation for operation and with the
same coefficients: rec = 1/((mu + 2w) − w·t), t = w·rec,
d′ = (r + w·d′)·rec from a zero carry at k = 1, then x = d′ + t·x from a
zero carry at k = nz−2 (`projection_kernels.py:686-698`, `tdma.py:526`).

Kernel note (`tdma_fwd_kernel`, `tdma_bwd_kernel`; they replace the Thomas
carries of `ProjectionKernels.pred_bt` and `corr_bwd`): sequential in z,
independent per mode, a handful of flops per 8–12 bytes — bound by memory
bandwidth.  One thread per (y, x) mode marches every plane, so each plane
access is one coalesced row of a warp; the carry lives in registers.
"""

from __future__ import annotations

import torch

from . import native


def tdma_z_fwd_reference(r: torch.Tensor, mu: torch.Tensor, w: float):
    """Forward sweep of the (nz, ny, nx) zero-shell rhs ``r``:
    returns (d′, t), both with zero z-shell planes."""
    nz = r.shape[0]
    mu = mu.to(r.dtype)
    b = mu + 2.0 * w
    d = torch.zeros_like(r)
    t = torch.zeros_like(r)
    tc = torch.zeros_like(r[0])
    dc = torch.zeros_like(r[0])
    for k in range(1, nz - 1):
        rec = 1.0 / (b - w * tc)
        tc = w * rec
        dc = (r[k] + w * dc) * rec
        d[k] = dc
        t[k] = tc
    return d, t


def tdma_z_bwd_reference(d: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Back substitution of pre-swept (d′, t); returns x with mirror
    z-shells x[0] = x[1], x[nz−1] = x[nz−2]."""
    nz = d.shape[0]
    x = torch.empty_like(d)
    xc = torch.zeros_like(d[0])
    for k in range(nz - 2, 0, -1):
        xc = d[k] + t[k] * xc
        x[k] = xc
    x[0] = x[1]
    x[nz - 1] = x[nz - 2]
    return x


def tdma_z_reference(r: torch.Tensor, mu: torch.Tensor, w: float):
    """Full Thomas solve: x with mirror z-shells."""
    return tdma_z_bwd_reference(*tdma_z_fwd_reference(r, mu, w))


def tdma_z_fwd(r: torch.Tensor, mu: torch.Tensor, w: float):
    """Forward sweep (d′, t) — ``tdma_fwd_kernel`` on CUDA."""
    if native.on_cpu(r):
        return tdma_z_fwd_reference(r, mu, w)
    nz, ny, nx = r.shape
    native.check_cuda(r, mu)
    if tuple(mu.shape) != (ny, nx):
        raise ValueError("tdma_z_fwd: mu must be an (ny, nx) plane")
    d = torch.empty_like(r)
    t = torch.empty_like(r)
    native.launch("cfd_tdma_fwd", r.device, native.ptr(r), native.ptr(mu),
                  float(w), native.ptr(d), native.ptr(t), nz, ny * nx)
    tdma_z_fwd.launches += 1
    return d, t


def tdma_z_bwd(d: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Back substitution x̂ with mirror z-shells — ``tdma_bwd_kernel`` on
    CUDA."""
    if native.on_cpu(d):
        return tdma_z_bwd_reference(d, t)
    nz, ny, nx = d.shape
    native.check_cuda(d, t)
    if t.shape != d.shape:
        raise ValueError("tdma_z_bwd: d and t must have one shape")
    x = torch.empty_like(d)
    native.launch("cfd_tdma_bwd", d.device, native.ptr(d), native.ptr(t),
                  native.ptr(x), nz, ny * nx)
    tdma_z_bwd.launches += 1
    return x


# ---- y-lines of the 2D step --------------------------------------------------
#
# After the forward x-DST the 2D pressure system splits into one
# tridiagonal per x-mode m along y (`make_tdma_y_2d`, `tdma.py:434-523`):
#
#     (mu_m + 2w)·x_j − w·(x_{j−1} + x_{j+1}) = r_j,   j = 1..ny−2,
#     x_0 = x_{ny−1} = 0,   w = 1/dy²,   mu_m = λx_m > 0,
#
# the 3D recurrence with rows in place of planes: an (ny, nx) rhs is an
# (ny, 1, nx) stack of one-row planes, so the z-line kernels solve it.

def tdma_y_2d_reference(r: torch.Tensor, mu: torch.Tensor, w: float):
    """Both sweeps of the (ny, mx) zero-shell rhs ``r`` with ``mu`` (mx,):
    x with mirror y-shells; plain loops over rows, any dtype."""
    return tdma_z_reference(r[:, None, :], mu[None, :], w)[:, 0, :]


def tdma_y_2d(r: torch.Tensor, mu: torch.Tensor, w: float) -> torch.Tensor:
    """The y-line solve through :func:`tdma_z_fwd` and :func:`tdma_z_bwd`
    (``tdma_fwd_kernel``, ``tdma_bwd_kernel`` on CUDA, which count the
    launches)."""
    if tuple(mu.shape) != (r.shape[-1],) or r.dim() != 2 or r.shape[0] < 3:
        raise ValueError("tdma_y_2d: r must be (ny >= 3, nx) and mu (nx,)")
    return tdma_z_bwd(*tdma_z_fwd(r[:, None, :], mu[None, :], w))[:, 0, :]


tdma_z_fwd.launches = 0
tdma_z_bwd.launches = 0
