"""The explicit kernels' sharded modes — their plain twins
(`ops.kernels.euler_kernels.euler_step_rows_plain`, `rk_kernels.
rk_stage_shard_plain`) against the reference's Pallas modes in interpret
mode, on the CPU: ``make_euler_fused(global_ny=)``,
``make_rk_stage(global_nz=)`` and ``(global_nz=, global_ny=)`` (the 2D
modes: `test_torch_parallel_explicit_kernels_2d.py`).

The smallest blocks the reference builds (nx = 128, 8 rows a shard):
9×24×128 over a (3, 3) mesh and 9×8×128 over 3 z-shards, at the first,
the middle and the last shard.  Each package cuts the shard's block as
its step does: the reference one halo plane and four halo rows a side
(a periodic ring; plane-only inputs zero-padded; the RK z-wrap pins as
(2, rows, nx) planes), the port one plane and one row (Euler) or two
rows over the periodic ring (RK), and (8, rows, nx) pin planes.  The
owned points off the global faces the step wrappers rewrite afterwards
(the reference's ``wrap_y_rows`` / ``wrap_z_shell``, the port's
``fused_explicit.fix``) are held in float64 at 1e-12 of max(1, |·|)
(the same arithmetic; the reference computes sin(πy) in the kernel):
Euler with buoyancy, the energy equation and mixed thermal faces; RK's
first and mid stages (z-only) and final stage ((z, y), thermal).
(float32 is held a step at a time in
`test_torch_parallel_explicit_steps.py`.)
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_tpu.boundary.types import BCType as JBC
from cfd_tpu.boundary.types import DirichletValues as JDV
from cfd_tpu.boundary.types import ThermalBCConfig as JTBC
from cfd_tpu.ops.pallas.euler_kernels import make_euler_fused
from cfd_tpu.ops.pallas.rk_kernels import make_rk_stage
from cfd_tpu_torch.ops.kernels import euler_kernels as ekm
from cfd_tpu_torch.ops.kernels import rk_kernels as rkm
from cfd_tpu_torch.solvers.ns.params import NSParams

torch.set_num_threads(min(2, torch.get_num_threads()))

NX, NZL, NYL, P = 128, 3, 8, 3
NZ, NY = NZL * P, NYL * P
MU, PC = 0.01, 0.1
DT, SU, SV = 1e-3, 0.08, 0.04
DTYPES = {"float64": (np.float64, torch.float64, jnp.float64, 1e-12)}
POS = {"first": 0, "middle": 1, "last": P - 1}
# the thermal case: buoyancy, the energy equation, every face type
THERMAL = dict(alpha=1e-3, beta=3e-3, T_ref=300.0, gravity=(0.5, -9.81, 2.0))
FACES = dict(left="DIRICHLET", right="NEUMANN", bottom="NEUMANN",
             top="DIRICHLET", back="PERIODIC", front="DIRICHLET")
VALUES = dict(left=310.0, right=290.0, bottom=305.0, top=295.0,
              back=300.0, front=290.0)


def _h(n):
    return 1.0 / (n - 1)


def _fields(shape, np_dt, seed):
    """u, v, w, p, ρ, T and a stage state and accumulator."""
    rng = np.random.default_rng(seed)

    def rnd(s):
        return rng.normal(0.0, s, shape).astype(np_dt)

    f = {n: rnd(0.3) for n in "uvwp"}
    f["rho"] = (1.0 + 0.05 * rng.random(shape)).astype(np_dt)
    f["T"] = (300.0 + rnd(1.0)).astype(np_dt)
    st = {n: (f[n] + rnd(0.01)).astype(np_dt) for n in "uvwp"}
    acc = {n: rnd(5.0) for n in "uvwp"}
    return f, st, acc


def _block(a, z0, y0, nzl, nyl, hz, hy, ring):
    """Owned (z0, y0) with hz planes (zeros past the z ends) and hy rows
    a side: the periodic ring's rows with ``ring``, else zeros."""
    if hy:
        a = (np.concatenate([a[:, -hy:], a, a[:, :hy]], 1) if ring
             else np.pad(a, ((0, 0), (hy, hy), (0, 0))))
    if hz:
        a = np.pad(a, ((hz, hz), (0, 0), (0, 0)))
    return np.ascontiguousarray(a[z0:z0 + nzl + 2 * hz,
                                  y0:y0 + nyl + 2 * hy])


def _zero_pad(a, hz, hy):
    return np.pad(a, ((hz, hz), (hy, hy), (0, 0)))


def _consts(nzb, nyb, nz_g, tdt, thermal, ny_g=NY):
    params = NSParams(**(THERMAL if thermal else {}), thermal_bc=_faces_t())
    return ekm.ExplicitConsts(
        nzb, nyb, NX, _h(NX), _h(ny_g), _h(nz_g) if nz_g > 1 else 1.0, MU,
        PC,
        ekm.ThermalConsts.from_params(params, tdt) if thermal
        else ekm.ThermalConsts())


def _faces_t():
    from cfd_tpu_torch.boundary.types import (BCType, DirichletValues,
                                              ThermalBCConfig)
    return ThermalBCConfig(**{k: BCType[v] for k, v in FACES.items()},
                           dirichlet_values=DirichletValues(**VALUES))


def _thermal_kw(thermal):
    if not thermal:
        return {}
    return dict(THERMAL, thermal_bc=JTBC(
        **{k: JBC[v] for k, v in FACES.items()},
        dirichlet_values=JDV(**VALUES)))


def _sy(tdt, y0, nyb, hy, ny_g=NY):
    """The block's rows of sin(πy), zeros past the global rows."""
    y = torch.linspace(0.0, 1.0, ny_g, dtype=torch.float64)
    sy = torch.sin(torch.pi * y).to(tdt)
    sy = torch.nn.functional.pad(sy, (hy, hy))
    return sy[y0:y0 + nyb].contiguous()


def _sx(tdt):
    x = torch.linspace(0.0, 1.0, NX, dtype=torch.float64)
    return torch.sin(2.0 * torch.pi * x).to(tdt)


def _held(name, got, ref, keep, tol):
    got, ref = np.asarray(got), np.asarray(ref)
    np.testing.assert_allclose(np.where(keep, got, 0.0),
                               np.where(keep, ref, 0.0), rtol=0,
                               atol=tol * max(1.0, np.abs(ref).max()),
                               err_msg=name)


@functools.lru_cache(maxsize=None)
def _ref_euler3d(dt_name, thermal):
    jdt = DTYPES[dt_name][2]
    return make_euler_fused(NZL + 2, NYL + 8, NX, _h(NX), _h(NY), _h(NZ),
                            0.0, 0.0, MU, PC, dtype=jdt, interpret=True,
                            global_ny=NY, **_thermal_kw(thermal))


@pytest.mark.parametrize("pos", list(POS))
def test_euler_global_ny_matches_reference(pos):
    """float64, with buoyancy, the energy equation and the faces."""
    dt_name, thermal = "float64", True
    np_dt, tdt, jdt, tol = DTYPES[dt_name]
    zi = yi = POS[pos]
    z0, y0 = zi * NZL, yi * NYL
    f, _, _ = _fields((NZ, NY, NX), np_dt, 1 + zi)
    ref = _ref_euler3d(dt_name, thermal)(
        jnp.asarray([DT, SU, SV, 0.0, y0 - 4], jdt),
        *(jnp.asarray(_block(f[n], z0, y0, NZL, NYL, 1, 4, True))
          for n in "uvwpT"),
        jnp.asarray(_zero_pad(_block(f["rho"], z0, y0, NZL, NYL, 0, 0,
                                     False), 1, 4)))
    c = _consts(NZL + 2, NYL + 2, NZ, tdt, thermal)
    sb = ekm.ShardBlock(1, 1, z0, NZ, y0, NY)
    got, _ = ekm.euler_step_rows_plain(
        *(torch.from_numpy(_block(f[n], z0, y0, NZL, NYL, 1, 1, False))
          for n in ("u", "v", "w", "p", "T", "rho")),
        _sy(tdt, y0, NYL + 2, 1), _sx(tdt),
        torch.tensor([DT, SU, SV], dtype=tdt), c, sb)
    keep = ~sb.faces(c, "cpu").numpy()
    for k, n in enumerate(("u", "v", "w", "p", "rho", "T")):
        _held(n, got[k].numpy(), np.asarray(ref[k])[1:-1, 4:-4], keep, tol)


@functools.lru_cache(maxsize=None)
def _ref_rk3d(dt_name, rows, final, thermal):
    jdt = DTYPES[dt_name][2]
    ny = NYL + 8 if rows else NYL
    return make_rk_stage(NZL + 2, ny, NX, _h(NX), _h(NY if rows else NYL),
                         _h(NZ), 0.0, 0.0,
                         MU, PC, final, global_nz=NZ,
                         global_ny=NY if rows else None, dtype=jdt,
                         interpret=True, **_thermal_kw(thermal))


# (label, accumulator, final, factor, acc_mix, weight): RK4's first and
# second stages, its final one
STAGES = {"first": (False, False, DT / 2, 0.0, 1.0),
          "mid": (True, False, DT / 2, 0.0, 2.0),
          "final": (True, True, DT / 6, 1.0, 0.0)}


@pytest.mark.parametrize("pos", list(POS))
@pytest.mark.parametrize("mesh,stage", [("z", "first"), ("z", "mid"),
                                        ("zy", "final")])
def test_rk3d_sharded_modes_match_reference(mesh, stage, pos):
    """float64: the z-only mode's first and mid stages; the (z, y) mode's
    final stage, with buoyancy, energy and the faces (its RHS reads the
    same neighbours as a mid stage's; the other stages of both modes are
    held by the steps' tests against the single-device step)."""
    np_dt, tdt, jdt, tol = DTYPES["float64"]
    rows = mesh == "zy"
    has_acc, final, fac, mix, wgt = STAGES[stage]
    thermal = final
    zi = POS[pos]
    yi = zi if rows else 0
    nyl = ny_g = NYL
    if rows:
        ny_g = NY
    shape = (NZ, ny_g, NX)
    z0, y0 = zi * NZL, yi * nyl
    f, st, acc = _fields(shape, np_dt, 10 + zi)
    hyr = 4 if rows else 0

    def rb(a, plane=False):
        if plane:
            return jnp.asarray(_zero_pad(_block(a, z0, y0, NZL, nyl, 0, 0,
                                                False), 1, hyr))
        return jnp.asarray(_block(a, z0, y0, NZL, nyl, 1, hyr, True))

    def rpin(a):
        both = np.stack([a[NZ - 2], a[1]])[:, y0:y0 + nyl]
        return jnp.asarray(np.pad(both, ((0, 0), (hyr, hyr), (0, 0))))

    zero = np.zeros(shape, np_dt)
    scal = [fac, mix, wgt, SU, SV, DT, z0 - 1] + ([y0 - 4] if rows else [])
    ref = _ref_rk3d("float64", rows, final, thermal)(
        jnp.asarray(scal, jdt), *(rb(st[n]) for n in "uvwp"), rb(f["T"]),
        *(rb(f[n], True) for n in "uvwp"), rb(f["rho"], True),
        *(rb(acc[n] if has_acc else zero, True) for n in "uvwp"),
        *(rpin(st[n]) for n in "uvwp"))
    hy = 2 if rows else 0
    c = _consts(NZL + 2, nyl + 2 * hy, NZ, tdt, thermal, ny_g)
    sb = ekm.ShardBlock(1, hy, z0, NZ, y0, ny_g, rows)

    def pb(a):
        return torch.from_numpy(_block(a, z0, y0, NZL, nyl, 1, hy, True))

    pins = None
    if zi in (0, P - 1):
        def plane(k):
            return np.stack([_block(st[n][k:k + 1], 0, y0, 1, nyl, 0, hy,
                                    True)[0] for n in "uvwp"])
        far, near = plane(NZ - 2), plane(1)
        pins = torch.from_numpy(np.concatenate([
            far if zi == 0 else np.zeros_like(far),
            near if zi == P - 1 else np.zeros_like(near)]))
    got, _ = rkm.rk_stage_shard_plain(
        tuple(pb(st[n]) for n in "uvwp"), tuple(pb(f[n]) for n in "uvwp"),
        pb(f["rho"]), pb(f["T"]),
        tuple(pb(acc[n]) for n in "uvwp") if has_acc else None,
        _sy(tdt, y0, nyl + 2 * hy, hy, ny_g), _sx(tdt),
        torch.tensor([fac, mix, wgt, SU, SV, DT], dtype=tdt), c, final,
        sb, pins)
    keep = ~sb.faces(c, "cpu").numpy()
    zs, ys = sb.window(c)
    names = (("u", "v", "w", "p", "rho", "T") if final else
             tuple(f"next {n}" for n in "uvwp")
             + tuple(f"acc {n}" for n in "uvwp"))
    for k, n in enumerate(names):
        g = got[k].numpy() if final else got[k][zs, ys].numpy()
        r = np.asarray(ref[k])[1:-1, hyr:-hyr] if rows else \
            np.asarray(ref[k])[1:-1]
        _held(n, g, r, keep, tol)
