"""The 2D RK stage kernel (counterpart of `cfd_tpu/ops/pallas/rk2d.py`,
RK2 ``make_rk2d_stage``).

The TPU kernel marches y-blocks (compute `rk2d.py:116-298`), takes the
periodic-interior y-wrap rows from an (8, nx) pinned input, and leaves the
final stage's y-face wrap rows to the step wrapper
(`cfd_tpu/solvers/ns/rk.py:243-246`).  On the card a stage, both wraps
included, is the nz == 1 instantiation of `rk_kernels`' CUDA kernel
(``rk_kernel<false, final, *>``, no z terms, no pins); its plain version is
`rk_kernels.rk_stage_plain` on one-plane fields.  Fields are (1, ny, nx).
"""

from __future__ import annotations

from . import native
from .euler_kernels import ExplicitConsts
from .rk_kernels import launch_rk, rk_stage_plain


def rk2d_stage(state, q0, rho, T, acc, sy, sx, scal, c: ExplicitConsts,
               final: bool):
    """RK2, one 2D stage — ``rk_kernel<false, final, *>`` on CUDA."""
    if native.on_cpu(state[0]):
        return rk_stage_plain(state, q0, rho, T, acc, sy, sx, scal, c, final)
    if c.nz != 1:
        raise ValueError("rk2d_stage is the 2D kernel (nz == 1)")
    out = launch_rk(state, q0, rho, T, acc, sy, sx, scal, c, final)
    native.count_launch(rk2d_stage, c.scheme)
    return out


native.reset_counts(rk2d_stage)
