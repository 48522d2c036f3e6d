"""The decomposed projection steps with the energy equation and buoyancy
(`cfd_tpu_torch.parallel.fused` on `LocalComm` CPU shards) against the
reference's single-device jnp step (``use_pallas=False``), one step, at
the reference's own bars for its sharded thermal steps:

* z-only, the natural-convection configuration of
  `tests/parallel/test_fused_sharded.py:340` (energy, buoyancy with a z
  component, Dirichlet sides, 128×16×16 float32 over 4 z-shards): u, v,
  w, T within 5e-6, p within 5e-5 (``assert_allclose``'s default rtol
  1e-7 on top);
* z-only, the energy coupling of `:123` (α = 0.05, no buoyancy): T
  within atol 1e-4, rtol 1e-5;
* (z, y), the Boussinesq configuration of
  `tests/parallel/test_sharded_more.py:104` (16×16×8 float64 over
  (2, 2), FFT_DIRECT on both sides, all-periodic thermal faces): every
  field within 1e-9;
* 2D over 4 y-shards, the de Vahl Davis geometry of
  `test_fused_sharded.py:587` (128×256 float32): u, v, T within 5e-6,
  p within 5e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_tpu import FlowField as JField
from cfd_tpu import Grid as JGrid
from cfd_tpu.boundary.types import BCType as JB
from cfd_tpu.boundary.types import DirichletValues as JDV
from cfd_tpu.boundary.types import ThermalBCConfig as JT
from cfd_tpu.solvers.ns import NSParams as JParams
from cfd_tpu.solvers.ns.projection import \
    make_projection_step as j_make_projection_step
from cfd_tpu.solvers.poisson.base import Method as JMethod
from cfd_tpu_torch.interop import field_from_numpy, grid_from
from cfd_tpu_torch.parallel import make_mesh, make_sharded_step
from cfd_tpu_torch.solvers.ns.params import NSParams

torch.set_num_threads(min(2, torch.get_num_threads()))

CPU = torch.device("cpu")
SIDES = JT(left=JB.DIRICHLET, right=JB.DIRICHLET, bottom=JB.NEUMANN,
           top=JB.NEUMANN, dirichlet_values=JDV(left=305.0, right=295.0))
NO_SOURCES = dict(source_amplitude_u=0.0, source_amplitude_v=0.0)


def _random(shape, seed, t_seed, dtype=np.float32, amp=0.1):
    """The reference tests' ``_random_field`` (u, v, w, p normal), ρ = 1
    and T = 300 + N(0, 1) from ``t_seed``."""
    rng = np.random.default_rng(seed)
    out = {n: rng.normal(0, amp, shape).astype(dtype) for n in "uvwp"}
    out["rho"] = np.ones(shape, dtype)
    out["T"] = np.random.default_rng(t_seed).normal(
        300.0, 1.0, shape).astype(dtype)
    return out


def _convection_2d(shape, dtype):
    """`test_fused_sharded.py:587`'s start: u and then T from one stream,
    the rest at rest."""
    rng = np.random.default_rng(43)
    out = {n: np.zeros(shape, dtype) for n in "vwp"}
    out["rho"] = np.ones(shape, dtype)
    out["u"] = rng.normal(0, 0.1, shape).astype(dtype)
    out["T"] = (300.0 + rng.normal(0, 1.0, shape)).astype(dtype)
    return out


def _boussinesq_zy():
    """`test_sharded_more.py:104`: T linear in x, quiescent start."""
    jgrid = JGrid.uniform(16, 16, 8, zmin=0.0, zmax=0.5)
    out = {n: np.zeros(jgrid.shape) for n in "uvwp"}
    out["rho"] = np.ones(jgrid.shape)
    out["T"] = np.broadcast_to(300.0 + 5.0 * np.linspace(0.0, 1.0, 16),
                               jgrid.shape).copy()
    return jgrid, out


CASES = {
    "z convection": dict(
        grid=lambda: JGrid.uniform(128, 16, 16, zmin=0.0, zmax=1.0),
        params=JParams(alpha=1e-3, beta=0.05, T_ref=300.0,
                       gravity=(0.0, -9.81, 0.05), thermal_bc=SIDES,
                       **NO_SOURCES),
        mesh=lambda: make_mesh([CPU] * 4, axes=("z",)), seeds=(19, 29),
        dtype=np.float32,
        bars={"u": 5e-6, "v": 5e-6, "w": 5e-6, "T": 5e-6, "p": 5e-5}),
    "z energy coupling": dict(
        grid=lambda: JGrid.uniform(128, 16, 16, zmin=0.0, zmax=1.0),
        params=JParams(alpha=0.05), seeds=(11, 5), dtype=np.float32,
        mesh=lambda: make_mesh([CPU] * 4, axes=("z",)),
        bars={"T": 1e-4}, rtol=1e-5),
    "zy boussinesq": dict(
        params=JParams(alpha=1e-3, beta=0.1, T_ref=300.0,
                       gravity=(0.0, -9.81, 0.0), thermal_bc=JT(),
                       **NO_SOURCES),
        mesh=lambda: make_mesh([CPU] * 4), dtype=np.float64,
        bars={n: 1e-9 for n in ("u", "v", "w", "p", "T")}, rtol=1e-9),
    "2d convection": dict(
        grid=lambda: JGrid.uniform(128, 256),
        params=JParams(alpha=1e-3, beta=0.05, T_ref=300.0,
                       gravity=(0.0, -9.81, 0.0), thermal_bc=SIDES,
                       **NO_SOURCES),
        mesh=lambda: make_mesh([CPU] * 4, axes=("y",)), dtype=np.float32,
        bars={"u": 5e-6, "v": 5e-6, "T": 5e-6, "p": 5e-5}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_thermal_step_matches_reference_jnp(case):
    spec = CASES[case]
    dtype = spec["dtype"]
    if case == "zy boussinesq":
        jgrid, arrays = _boussinesq_zy()
    elif case == "2d convection":
        jgrid = spec["grid"]()
        arrays = _convection_2d(jgrid.shape, dtype)
    else:
        jgrid = spec["grid"]()
        arrays = _random(jgrid.shape, *spec["seeds"], dtype)
    jparams = spec["params"]
    jdt = jnp.float32 if dtype == np.float32 else jnp.float64
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    jstep = jax.jit(j_make_projection_step(
        jgrid, jparams, dtype=jdt, poisson_method=JMethod.FFT_DIRECT,
        use_pallas=False))
    jf, jres = jstep(JField(**{n: jnp.asarray(a) for n, a in
                               arrays.items()}), 0.001, 0)
    step, place = make_sharded_step(grid_from(jgrid),
                                    NSParams.from_fields(jparams),
                                    spec["mesh"](), "projection",
                                    dtype=tdt)
    fs, res = step(place(field_from_numpy(arrays, "cpu", tdt)), 1e-3, 0)
    assert int(res.status) == int(jres.status) == 0
    g = fs.gather()
    for n, bar in spec["bars"].items():
        np.testing.assert_allclose(getattr(g, n).numpy(),
                                   np.asarray(getattr(jf, n)),
                                   rtol=spec.get("rtol", 1e-7), atol=bar,
                                   err_msg=n)
    np.testing.assert_allclose(float(res.max_temperature),
                               float(jres.max_temperature), rtol=1e-6)
