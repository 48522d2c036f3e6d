"""The 2D explicit Euler step's fused kernel (counterpart of
`cfd_tpu/ops/pallas/euler2d.py`, E2 ``make_euler2d_fused``).

The TPU kernel marches y-blocks (compute `euler2d.py:101-260`) and leaves
the y-face wrap rows of p, ρ and T to the step wrapper
(`cfd_tpu/solvers/ns/euler.py:280-311`), because their sources can live in
another block.  On the card the whole step, both wraps included, is the
nz == 1 instantiation of `euler_kernels`' CUDA kernel
(``euler_kernel<false, *>``, no z terms); its plain version is
`euler_kernels.euler_step_plain` on a one-plane field.  Fields are
(1, ny, nx); velocity shells pass through, w's too (the TPU kernel's
interior mask; the reference's jnp 2D step wraps w's shells instead).
The global-row mode of a y-decomposed shard's block
(``make_euler2d_fused(global_ny=...)``) is the 2D instantiation of
`euler_kernels`' ``euler_rows_kernel``.
"""

from __future__ import annotations

from . import native
from .euler_kernels import (ExplicitConsts, ShardBlock, _rows,
                            euler_step_plain, launch_euler)


def euler2d_step(u, v, w, p, T, rho, sy, sx, scal, c: ExplicitConsts,
                 shard: ShardBlock = None):
    """E2, the whole 2D Euler step — ``euler_kernel<false, *>`` on CUDA.
    With ``shard`` (a y-decomposed shard's block) its global-row mode,
    ``euler_rows_kernel<false, *>``, counted on ``global_ny_launches``,
    which returns ``(fields, maxima)`` (`euler_step_rows_plain`)."""
    if shard is not None:
        return _rows(euler2d_step, u, v, w, p, T, rho, sy, sx, scal, c,
                     shard)
    if native.on_cpu(u):
        return euler_step_plain(u, v, w, p, T, rho, sy, sx, scal, c)
    if c.nz != 1:
        raise ValueError("euler2d_step is the 2D kernel (nz == 1)")
    out = launch_euler(c, u, v, w, p, T, rho, sy, sx, scal)
    native.count_launch(euler2d_step, c.scheme)
    return out


native.reset_counts(euler2d_step)
