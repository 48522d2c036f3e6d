"""O(h²) central differences (counterpart of `cfd_tpu/ops/stencils.py`,
restricted to what the projection and explicit steps read).

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

The explicit integrators' plain bodies use the reference's full-array
form instead: circular shifts (``sx_m`` … ``sz_p``, ``torch.roll``), the
periodic-interior shifts that wrap past the ghost layer (i == 1 reads
nx − 2, i == nx − 2 reads 1; `ns_momentum_rhs_scalar.h:78-90`), and
``interior_mask``.  Their boundary entries hold wrapped values that every
caller discards.
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


def interior_index(f: torch.Tensor):
    """The index of the interior block, for assignment."""
    return _zi(f), _I, _I


def interior(f: torch.Tensor) -> torch.Tensor:
    return f[interior_index(f)]


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


# ---- full-array shifts (the explicit steps' plain bodies) -----------------
# sx_p(f)[..., i] == f[..., i+1], circular at the edge.

def sx_p(f):
    return torch.roll(f, -1, dims=-1)


def sx_m(f):
    return torch.roll(f, 1, dims=-1)


def sy_p(f):
    return torch.roll(f, -1, dims=-2)


def sy_m(f):
    return torch.roll(f, 1, dims=-2)


def sz_p(f):
    return torch.roll(f, -1, dims=-3)


def sz_m(f):
    return torch.roll(f, 1, dims=-3)


def _with(g, index, src):
    g[index] = src
    return g


def sx_m_periodic_interior(f):
    return _with(sx_m(f), (..., 1), f[..., -2])


def sx_p_periodic_interior(f):
    return _with(sx_p(f), (..., -2), f[..., 1])


def sy_m_periodic_interior(f):
    return _with(sy_m(f), (..., 1, slice(None)), f[..., -2, :])


def sy_p_periodic_interior(f):
    return _with(sy_p(f), (..., -2, slice(None)), f[..., 1, :])


def sz_m_periodic_interior(f):
    """The field itself on a 2D field (z-neighbours collapse)."""
    if f.shape[-3] <= 1:
        return f
    return _with(sz_m(f), (1,), f[-2])


def sz_p_periodic_interior(f):
    if f.shape[-3] <= 1:
        return f
    return _with(sz_p(f), (-2,), f[1])


def d2dz2(f, inv_dz2):
    """Zero on a 2D field."""
    if f.shape[-3] <= 1:
        return torch.zeros_like(f)
    return ((sz_p(f) - 2.0 * f) + sz_m(f)) * inv_dz2


def interior_mask(shape, dtype=torch.float32, device=None):
    """1 on interior points, 0 on the boundary shell (the z-shell only
    when nz > 1)."""
    nz, ny, nx = shape
    m = torch.zeros(shape, dtype=dtype, device=device)
    m[slice(1, -1) if nz > 1 else slice(None), 1:-1, 1:-1] = 1
    return m


def checkerboard_mask(shape, parity, device=None):
    """The interior points with (i + j + k) % 2 == parity (k = 0 on a 2D
    field), as a bool tensor: red is parity 0, black parity 1."""
    nz, ny, nx = shape
    k = torch.arange(nz, device=device)[:, None, None] if nz > 1 else 0
    j = torch.arange(ny, device=device)[None, :, None]
    i = torch.arange(nx, device=device)[None, None, :]
    color = ((i + j + k) % 2) == parity
    return color & interior_mask(shape, torch.bool, device)
