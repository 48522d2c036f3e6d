"""O(h²) central differences on the interior (counterpart of
`cfd_tpu/ops/stencils.py`, restricted to what the projection step reads).

The reference forms each operator over the whole array with circular
``jnp.roll`` shifts and discards the wrapped boundary entries.  Here each
operator returns only the interior ``[1:-1, 1:-1, 1:-1]`` block, built from
slices, so no boundary value is read that the result does not use — the
same values the reference keeps, with no wrapped reads to mask.

Operation order matches the fused kernels term for term (central
difference ``(f[+1] − f[−1])·inv_2d``, second difference
``((f[+1] − 2f) + f[−1])·inv_d2``), so the plain versions built on these
agree with the CUDA kernels to the last bit where no transcendental is
involved.
"""

from __future__ import annotations

import torch

_I = slice(1, -1)
_P = slice(2, None)
_M = slice(None, -2)


def interior(f: torch.Tensor) -> torch.Tensor:
    return f[_I, _I, _I]


def ddx(f, inv_2dx):
    return (f[_I, _I, _P] - f[_I, _I, _M]) * inv_2dx


def ddy(f, inv_2dy):
    return (f[_I, _P, _I] - f[_I, _M, _I]) * inv_2dy


def ddz(f, inv_2dz):
    return (f[_P, _I, _I] - f[_M, _I, _I]) * inv_2dz


def laplacian(f, inv_dx2, inv_dy2, inv_dz2):
    """7-point Laplacian on the interior (`stencils.h:135-176`)."""
    c2 = 2.0 * interior(f)
    return (((f[_I, _I, _P] - c2) + f[_I, _I, _M]) * inv_dx2
            + ((f[_I, _P, _I] - c2) + f[_I, _M, _I]) * inv_dy2
            + ((f[_P, _I, _I] - c2) + f[_M, _I, _I]) * inv_dz2)


def set_interior(dst: torch.Tensor, src_interior: torch.Tensor):
    """A copy of ``dst`` whose interior is ``src_interior`` (the shell
    keeps ``dst``'s values — the reference's save/restore idiom)."""
    out = dst.clone()
    out[_I, _I, _I] = src_interior
    return out
