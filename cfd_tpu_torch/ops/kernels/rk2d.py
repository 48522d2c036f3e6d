"""The 2D RK stage kernel (counterpart of `cfd_tpu/ops/pallas/rk2d.py`,
RK2 ``make_rk2d_stage``).

The TPU kernel marches y-blocks (compute `rk2d.py:116-298`), takes the
periodic-interior y-wrap rows from an (8, nx) pinned input, and leaves the
final stage's y-face wrap rows to the step wrapper
(`cfd_tpu/solvers/ns/rk.py:243-246`).  On the card a stage, both wraps
included, is the nz == 1 instantiation of `rk_kernels`' CUDA kernel
(``rk_kernel<false, final, *>``, no z terms, no pins); its plain version is
`rk_kernels.rk_stage_plain` on one-plane fields.  Fields are (1, ny, nx).
The global-row mode of a y-decomposed shard's block
(``make_rk2d_stage(global_ny=...)``) is the 2D instantiation of
`rk_kernels`' ``rk_shard_kernel`` (y neighbours by global row over a
periodic 2-row halo ring, where the TPU kernel took pin rows).
"""

from __future__ import annotations

from . import native
from .euler_kernels import ExplicitConsts, ShardBlock
from .rk_kernels import _shard_stage, launch_rk, rk_stage_plain


def rk2d_stage(state, q0, rho, T, acc, sy, sx, scal, c: ExplicitConsts,
               final: bool, shard: ShardBlock = None):
    """RK2, one 2D stage — ``rk_kernel<false, final, *>`` on CUDA.  With
    ``shard`` (a y-decomposed shard's block) its global-row mode,
    ``rk_shard_kernel<false, *, *, *, kRows>``, counted on
    ``global_ny_launches``, which returns ``(fields, maxima)``
    (`rk_kernels.rk_stage_shard_plain`)."""
    if shard is not None:
        return _shard_stage(rk2d_stage, state, q0, rho, T, acc, sy, sx, scal,
                            c, final, shard, None)
    if native.on_cpu(state[0]):
        return rk_stage_plain(state, q0, rho, T, acc, sy, sx, scal, c, final)
    if c.nz != 1:
        raise ValueError("rk2d_stage is the 2D kernel (nz == 1)")
    out = launch_rk(state, q0, rho, T, acc, sy, sx, scal, c, final)
    native.count_launch(rk2d_stage, c.scheme)
    return out


native.reset_counts(rk2d_stage)
