"""The consistent scheme's spectral projection step over several steps
and with Boussinesq buoyancy and the energy equation, against the
reference's fused interpret step, float32, 128×16×8
(`test_projection_consistent_fused.py:109-140`): 3 steps on a β = 2.0
grid within 5e-4; buoyancy + energy (the consistent energy post-step,
Neumann thermal faces) within 5e-5, T included; and two steps at
128×16×3 within 5e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_tpu import FlowField as JField
from cfd_tpu import Grid as JGrid
from cfd_tpu.boundary.types import BCType as JB
from cfd_tpu.boundary.types import ThermalBCConfig as JT
from cfd_tpu.solvers.ns import NSParams as JParams
from cfd_tpu.solvers.ns.projection import make_projection_step as j_step
from cfd_tpu.solvers.poisson.base import Method as JMethod
from cfd_tpu_torch.interop import field_from_numpy, grid_from
from cfd_tpu_torch.solvers.ns.params import NSParams
from cfd_tpu_torch.solvers.ns.projection import make_projection_step
from cfd_tpu_torch.solvers.poisson.base import Method
from tests.test_torch_consistent_projection import (NX, NY, NZ, _arrays,
                                                   assert_close)

torch.set_num_threads(min(2, torch.get_num_threads()))


def _steps(jparams, arrays, beta, n_steps, nz=NZ):
    jg = JGrid.stretched(NX, NY, nz, zmin=0.0, zmax=1.0, beta=beta,
                         stretch_axes="xy")
    jstep = jax.jit(j_step(jg, jparams, dtype=jnp.float32,
                           poisson_method=JMethod.FFT_DIRECT,
                           use_pallas=True, pallas_interpret=True))
    tstep = make_projection_step(grid_from(jg),
                                 NSParams.from_fields(jparams),
                                 dtype=torch.float32,
                                 poisson_method=Method.FFT_DIRECT,
                                 device="cpu")
    jf = JField(**{n: jnp.asarray(a) for n, a in arrays.items()})
    tf = field_from_numpy(arrays, "cpu", torch.float32)
    for i in range(n_steps):
        jf, jr = jstep(jf, 0.001, i)
        tf, tr = tstep(tf, 0.001, i)
        assert int(jr.status) == int(tr.status) == 0
    return dict(jf=jf, jr=jr, tf=tf, tr=tr)


@pytest.fixture(scope="module")
def three_steps():
    return _steps(JParams(nonuniform_scheme="consistent"), _arrays(7),
                  2.0, 3)


@pytest.fixture(scope="module")
def buoyant_energy():
    nm = JB.NEUMANN
    jparams = JParams(nonuniform_scheme="consistent", alpha=1e-3,
                      beta=0.01, T_ref=300.0, gravity=(0.0, -9.81, 0.0),
                      thermal_bc=JT(left=nm, right=nm, bottom=nm, top=nm,
                                    front=nm, back=nm))
    arrays = _arrays(5)
    rng = np.random.default_rng(5)
    arrays["T"] = (300.0 + rng.normal(0.0, 1.0, (NZ, NY, NX))).astype(
        np.float32)
    return _steps(jparams, arrays, 1.5, 1)


@pytest.fixture(scope="module")
def nz3_steps():
    rng = np.random.default_rng(13)
    arrays = {n: rng.normal(0.0, 0.1, (3, NY, NX)).astype(np.float32)
              for n in "uvwp"}
    arrays["rho"] = np.ones((3, NY, NX), np.float32)
    arrays["T"] = np.full((3, NY, NX), 300.0, np.float32)
    return _steps(JParams(nonuniform_scheme="consistent"), arrays, 1.5, 2,
                  nz=3)


def test_nz3_steps_match_fused_reference(nz3_steps):
    """nz = 3 (one interior plane, its b̃ taking the z face term from both
    mirrored shells, as the reference's kernels do): two steps within
    5e-5 of the fused step."""
    assert_close(nz3_steps)


@pytest.mark.parametrize("name", ["u", "v", "w", "p"])
def test_three_steps_match_fused_reference(three_steps, name):
    np.testing.assert_allclose(getattr(three_steps["tf"], name).numpy(),
                               np.array(getattr(three_steps["jf"], name)),
                               rtol=0, atol=5e-4)


def test_buoyant_energy_step_matches_fused_reference(buoyant_energy):
    """The buoyant consistent predictor and the stretched-grid energy
    step (`energy.py:106-139`) with Neumann faces; T (≈ 300) within
    5e-5, under two float32 ulps there."""
    assert_close(buoyant_energy, names=("u", "v", "w", "p", "T"))
    np.testing.assert_allclose(float(buoyant_energy["tr"].max_temperature),
                               float(buoyant_energy["jr"].max_temperature),
                               rtol=1e-6)
