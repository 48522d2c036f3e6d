"""The 2D explicit kernels' global-row modes — their plain twins
(`ops.kernels.euler_kernels.euler_step_rows_plain`, `rk_kernels.
rk_stage_shard_plain` on one-plane blocks) against the reference's
``make_euler2d_fused(global_ny=)`` and ``make_rk2d_stage(global_ny=)``
in interpret mode, on the CPU.

72×128 over 3 y-shards of 24 rows (the smallest block the reference
marches, 32 rows with its halos),
the first, the middle and the last shard.  The reference's blocks carry
four halo rows a side, zeros past the global rows, and its RK takes the
y-wrap rows as an (8, nx) pin array; the port's Euler block one row a
side, its RK block two rows over the periodic ring (the y neighbours of
global rows 1 and ny − 2 three rows away).  The owned points off the
global y-face rows the step wrappers rewrite are held at 1e-12 of
max(1, |·|), float64, with buoyancy, the energy equation and mixed
thermal faces (Euler and RK's final stage) — the same arithmetic, the
reference computing sin(πy) in the kernel.  (The mid stages and float32
are held a step at a time in `test_torch_parallel_explicit_steps.py`.)
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_tpu.ops.pallas.euler2d import make_euler2d_fused
from cfd_tpu.ops.pallas.rk2d import make_rk2d_stage
from cfd_tpu_torch.ops.kernels import euler_kernels as ekm
from cfd_tpu_torch.ops.kernels import rk_kernels as rkm
from tests.test_torch_parallel_explicit_kernels import (
    DT, MU, NX, PC, POS, STAGES, SU, SV, _block, _consts, _fields, _h,
    _held, _sx, _sy, _thermal_kw)

torch.set_num_threads(min(2, torch.get_num_threads()))

TOL = 1e-12
NYL = 24                 # the marching kernel's smallest block: 32 rows
NY = 3 * NYL


def _row_block(a, y0, hy, ring):
    return _block(a, 0, y0, 1, NYL, 0, hy, ring)


@functools.lru_cache(maxsize=None)
def _ref_euler2d():
    return make_euler2d_fused(NYL + 8, NX, _h(NX), _h(NY), 0.0, 0.0, MU, PC,
                              dtype=jnp.float64, interpret=True,
                              global_ny=NY, **_thermal_kw(True))


@pytest.mark.parametrize("pos", list(POS))
def test_euler2d_global_ny_matches_reference(pos):
    y0 = POS[pos] * NYL
    f, _, _ = _fields((1, NY, NX), np.float64, 20 + POS[pos])
    ref = _ref_euler2d()(
        jnp.asarray([DT, SU, SV, y0 - 4], jnp.float64),
        *(jnp.asarray(_row_block(f[n], y0, 4, False)[0])
          for n in ("u", "v", "w", "p", "T", "rho")))
    c = _consts(1, NYL + 2, 1, torch.float64, True, NY)
    sb = ekm.ShardBlock(0, 1, 0, 1, y0, NY)
    got, _ = ekm.euler_step_rows_plain(
        *(torch.from_numpy(_row_block(f[n], y0, 1, False))
          for n in ("u", "v", "w", "p", "T", "rho")),
        _sy(torch.float64, y0, NYL + 2, 1, NY), _sx(torch.float64),
        torch.tensor([DT, SU, SV], dtype=torch.float64), c, sb)
    keep = ~sb.faces(c, "cpu").numpy()[0]
    for k, n in enumerate(("u", "v", "w", "p", "rho", "T")):
        _held(n, got[k].numpy()[0], np.asarray(ref[k])[4:-4], keep, TOL)


@functools.lru_cache(maxsize=None)
def _ref_rk2d(final):
    return make_rk2d_stage(NYL + 8, NX, _h(NX), _h(NY), 0.0, 0.0, MU, PC,
                           final, dtype=jnp.float64, interpret=True,
                           global_ny=NY, **_thermal_kw(final))


@pytest.mark.parametrize("pos", list(POS))
def test_rk2d_global_ny_matches_reference(pos):
    """The final stage (the reference's y-wrap pins against the port's
    ring; a mid stage's RHS reads the same neighbours)."""
    has_acc, final, fac, mix, wgt = STAGES["final"]
    y0 = POS[pos] * NYL
    f, st, acc = _fields((1, NY, NX), np.float64, 30 + POS[pos])

    def rb(a, halo=True):
        return jnp.asarray(_row_block(a if halo else np.where(
            np.arange(NY)[None, :, None] // NYL == POS[pos], a, 0.0), y0, 4,
            False)[0])

    pins = jnp.asarray(np.concatenate([
        np.stack([st[n][0, NY - 2] for n in "uvwp"]),
        np.stack([st[n][0, 1] for n in "uvwp"])]))
    ref = _ref_rk2d(final)(
        jnp.asarray([fac, mix, wgt, SU, SV, DT, y0 - 4], jnp.float64),
        *(rb(st[n]) for n in "uvwp"), rb(f["T"]),
        *(rb(f[n], False) for n in "uvwp"), rb(f["rho"], False),
        *(rb(acc[n], False) for n in "uvwp"), pins)
    c = _consts(1, NYL + 4, 1, torch.float64, final, NY)
    sb = ekm.ShardBlock(0, 2, 0, 1, y0, NY)

    def pb(a):
        return torch.from_numpy(_row_block(a, y0, 2, True))

    got, _ = rkm.rk_stage_shard_plain(
        tuple(pb(st[n]) for n in "uvwp"), tuple(pb(f[n]) for n in "uvwp"),
        pb(f["rho"]), pb(f["T"]), tuple(pb(acc[n]) for n in "uvwp"),
        _sy(torch.float64, y0, NYL + 4, 2, NY), _sx(torch.float64),
        torch.tensor([fac, mix, wgt, SU, SV, DT], dtype=torch.float64), c,
        final, sb)
    keep = ~sb.faces(c, "cpu").numpy()[0]
    for k, n in enumerate(("u", "v", "w", "p", "rho", "T")):
        _held(n, got[k].numpy()[0], np.asarray(ref[k])[4:-4], keep, TOL)
