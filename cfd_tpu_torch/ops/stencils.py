"""O(h²) central differences on the interior (counterpart of
`cfd_tpu/ops/stencils.py`, restricted to what the projection steps read).

The reference forms each operator over the whole array with circular
``jnp.roll`` shifts and discards the wrapped boundary entries.  Here each
operator returns only the interior block, built from slices, so no
boundary value is read that the result does not use — the same values the
reference keeps, with no wrapped reads to mask.

Fields are ``(nz, ny, nx)``.  A single-plane field (nz == 1) is 2D: its
interior is ``[:, 1:-1, 1:-1]`` and the Laplacian has no z term — the
reference's inv_dz2 = 0 idiom, so one set of operators serves both steps.

Operation order matches the fused kernels term for term (central
difference ``(f[+1] − f[−1])·inv_2d``, second difference
``((f[+1] − 2f) + f[−1])·inv_d2``, summed x, then y, then z), so the plain
versions built on these agree with the CUDA kernels to the last bit where
no transcendental is involved.
"""

from __future__ import annotations

import torch

_I = slice(1, -1)
_P = slice(2, None)
_M = slice(None, -2)


def _zi(f: torch.Tensor) -> slice:
    """Interior z-slice: the one plane of a 2D field, planes 1..nz−2 in
    3D."""
    return slice(None) if f.shape[0] == 1 else _I


def interior(f: torch.Tensor) -> torch.Tensor:
    return f[_zi(f), _I, _I]


def ddx(f, inv_2dx):
    z = _zi(f)
    return (f[z, _I, _P] - f[z, _I, _M]) * inv_2dx


def ddy(f, inv_2dy):
    z = _zi(f)
    return (f[z, _P, _I] - f[z, _M, _I]) * inv_2dy


def ddz(f, inv_2dz):
    """Zero on a 2D field (the reference's inv_dz2 = 0 idiom)."""
    if f.shape[0] == 1:
        return torch.zeros_like(interior(f))
    return (f[_P, _I, _I] - f[_M, _I, _I]) * inv_2dz


def laplacian(f, inv_dx2, inv_dy2, inv_dz2=0.0):
    """7-point Laplacian on the interior (`stencils.h:135-176`); 5-point
    on a 2D field, where ``inv_dz2`` is not read."""
    z = _zi(f)
    c2 = 2.0 * interior(f)
    lap = (((f[z, _I, _P] - c2) + f[z, _I, _M]) * inv_dx2
           + ((f[z, _P, _I] - c2) + f[z, _M, _I]) * inv_dy2)
    if f.shape[0] == 1:
        return lap
    return lap + ((f[_P, _I, _I] - c2) + f[_M, _I, _I]) * inv_dz2


def set_interior(dst: torch.Tensor, src_interior: torch.Tensor):
    """A copy of ``dst`` whose interior is ``src_interior`` (the shell
    keeps ``dst``'s values — the reference's save/restore idiom)."""
    out = dst.clone()
    out[_zi(dst), _I, _I] = src_interior
    return out
