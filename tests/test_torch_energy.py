"""The port's energy module against the reference's, float64 within 1e-12:
the energy step (3D and 2D), the buoyancy sources, the thermal BCs with
every supported type on every face (2D and 3D), the thermal dt bound, and
the validation of configurations and grids.  Both packages get the same
numpy inputs."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_tpu import Grid as JGrid
from cfd_tpu.boundary import BCType as JB
from cfd_tpu.boundary import DirichletValues as JD
from cfd_tpu.boundary import ThermalBCConfig as JT
from cfd_tpu.solvers import energy as je
from cfd_tpu_torch import CFDError, Grid, Status
from cfd_tpu_torch.boundary import BCType, DirichletValues, ThermalBCConfig
from cfd_tpu_torch.solvers import energy as te
from cfd_tpu_torch.solvers.ns import common as tcommon

torch.set_num_threads(min(2, torch.get_num_threads()))

SHAPES = {"3d": (5, 6, 7), "2d": (1, 6, 7)}
VALUES = dict(left=301.0, right=299.0, bottom=298.5, top=302.5, back=297.0,
              front=303.0)
TYPES = ("PERIODIC", "NEUMANN", "DIRICHLET")


def _grids(shape):
    nz, ny, nx = shape
    kw = dict(zmin=0.0, zmax=1.0) if nz > 1 else {}
    return JGrid.uniform(nx, ny, nz, **kw), Grid.uniform(nx, ny, nz, **kw)


def _fields(shape, seed=0):
    rng = np.random.default_rng(seed)
    T = 300.0 + rng.normal(0.0, 1.0, shape)
    return [T] + [rng.normal(0.0, 0.5, shape) for _ in range(3)]


def _configs(kind, faces):
    """(reference, port) configs with the face types ``faces``."""
    names = ("left", "right", "bottom", "top", "back", "front")
    jc = JT(**{n: JB[t] for n, t in zip(names, faces)},
            dirichlet_values=JD(**VALUES))
    tc = ThermalBCConfig(**{n: BCType[t] for n, t in zip(names, faces)},
                         dirichlet_values=DirichletValues(**VALUES))
    return jc, tc


@pytest.mark.parametrize("dim", ["3d", "2d"])
def test_energy_step_matches_reference(dim):
    shape = SHAPES[dim]
    jg, tg = _grids(shape)
    arrays = _fields(shape, 1)
    jstep = je.make_energy_step(jg, 0.02)
    tstep = te.make_energy_step(tg, 0.02)
    got = tstep(*(torch.tensor(a) for a in arrays), 1e-3)
    ref = jstep(*(jnp.asarray(a) for a in arrays), 1e-3, 0.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-12)
    assert te.make_energy_step(tg, 0.0) is None
    assert je.make_energy_step(jg, 0.0) is None


def test_energy_step_unsupported_inputs():
    _, tg = _grids(SHAPES["3d"])
    with pytest.raises(CFDError) as err:
        te.make_energy_step(tg, 0.02, heat_source=lambda X, Y, Z, t: 0.0)
    assert err.value.status == Status.ERROR_UNSUPPORTED
    x = tg.x.copy()
    x[1] += 0.3 * (x[2] - x[1])
    import dataclasses
    stretched = dataclasses.replace(tg, x=x, dx=np.diff(x))
    # the parity scheme on a stretched grid raises, as the reference's
    with pytest.raises(CFDError) as err:
        te.make_energy_step(stretched, 0.02, scheme="parity")
    assert err.value.status == Status.ERROR_UNSUPPORTED
    # the consistent scheme builds its stretched-grid step, which matches
    # the reference's (`energy.py:106-139`) within 1e-12
    jg, _ = _grids(SHAPES["3d"])
    jstretched = dataclasses.replace(jg, x=x, dx=np.diff(x))
    arrays = _fields(SHAPES["3d"], 4)
    got = te.make_energy_step(stretched, 0.02, scheme="consistent")(
        *(torch.tensor(a) for a in arrays), 1e-3)
    ref = je.make_energy_step(jstretched, 0.02, scheme="consistent")(
        *(jnp.asarray(a) for a in arrays), 1e-3, 0.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-12 * np.abs(np.asarray(ref)).max())


@pytest.mark.parametrize("gravity", [(0.0, -9.81, 0.0), (0.3, 0.0, -2.0)])
def test_buoyancy_matches_reference(gravity):
    (T,) = _fields(SHAPES["3d"], 2)[:1]
    got = te.compute_buoyancy(torch.tensor(T), 3e-3, 300.0, gravity)
    ref = je.compute_buoyancy(jnp.asarray(T), 3e-3, 300.0, gravity)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-12)
    assert te.compute_buoyancy(torch.tensor(T), 0.0, 300.0, gravity) == \
        (0.0, 0.0, 0.0)


def test_buoyancy_coefficients_round_like_the_kernels():
    """(−β)·g rounded in float32 for float32 fields, exact float64
    otherwise."""
    coefs, tref = te.buoyancy_coefficients(0.003333, (0.0, -9.81, 1.0),
                                           300.1, torch.float32)
    assert coefs[1] == float(np.float32(-np.float32(0.003333))
                             * np.float32(-9.81))
    assert tref == float(np.float32(300.1))
    coefs, tref = te.buoyancy_coefficients(0.003333, (0.0, -9.81, 1.0),
                                           300.1, torch.float64)
    assert coefs == (-0.003333 * 0.0, -0.003333 * -9.81, -0.003333)
    assert tref == 300.1


@pytest.mark.parametrize("dim", ["3d", "2d"])
@pytest.mark.parametrize("xy", list(itertools.product(TYPES, repeat=2)),
                         ids=lambda t: "-".join(t))
def test_apply_thermal_bcs_matches_reference(dim, xy):
    """Every type on the x pair and on the y pair (left/bottom take the
    first, right/top the second), and in 3D the z faces cycled through
    the three types: corners and edges included, bit for bit."""
    shape = SHAPES[dim]
    (T,) = _fields(shape, 3)[:1]
    for zpair in ((xy[1], xy[0]), ("NEUMANN", "DIRICHLET"),
                  ("DIRICHLET", "PERIODIC")):
        faces = (xy[0], xy[1], xy[0], xy[1], *zpair)
        jc, tc = _configs(dim, faces)
        got = te.apply_thermal_bcs(torch.tensor(T), tc)
        ref = je.apply_thermal_bcs(jnp.asarray(T), jc)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        if dim == "2d":
            break


def test_thermal_dt_limit_matches_reference():
    for alpha, dmin, ndim, cfl in ((0.0, 0.1, 3, 0.2), (1e-3, 0.05, 2, 0.5),
                                   (2.0, 1e-3, 3, 1.0)):
        assert te.thermal_dt_limit(alpha, dmin, ndim, cfl) == \
            je.thermal_dt_limit(alpha, dmin, ndim, cfl)
        assert tcommon.thermal_dt_limit(alpha, dmin, ndim, cfl) == \
            je.thermal_dt_limit(alpha, dmin, ndim, cfl)


@pytest.mark.parametrize("face", ["left", "right", "bottom", "top", "back",
                                  "front"])
@pytest.mark.parametrize("bad", ["NOSLIP", "INLET", "OUTLET", "SYMMETRY"])
def test_validate_thermal_bc_rejects_like_reference(face, bad):
    """A face type other than PERIODIC, NEUMANN or DIRICHLET is
    ERROR_INVALID in both packages (the z faces only in 3D)."""
    for shape in (SHAPES["3d"], SHAPES["2d"]):
        jg, tg = _grids(shape)
        jc = JT(**{face: JB[bad]})
        tc = ThermalBCConfig(**{face: BCType[bad]})
        ref_raises = True
        try:
            je.validate_thermal_bc(jc, jg)
            ref_raises = False
        except Exception as e:   # the reference's CFDError
            assert int(e.status) == int(Status.ERROR_INVALID)
        if ref_raises:
            with pytest.raises(CFDError) as err:
                te.validate_thermal_bc(tc, tg)
            assert err.value.status == Status.ERROR_INVALID
        else:
            te.validate_thermal_bc(tc, tg)
            assert shape[0] == 1 and face in ("back", "front")
