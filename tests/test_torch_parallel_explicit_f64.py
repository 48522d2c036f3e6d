"""The decomposed explicit steps in float64 against the port's
single-device plain step, their refusals, and the collectives they use,
on the CPU.

* Euler, RK2 and RK4, three steps of dt = 1e-3 from a random field, over
  4 z-shards and (2, 2) at 11×12×12 and over 4 y-shards at 11×16, on a
  uniform grid with the default sources, with Boussinesq buoyancy, the
  energy equation and every thermal face type (Dirichlet values above
  and below the field's T, so the step's max T is a face's), and on a
  tanh-stretched x/y grid in the parity and the consistent scheme (with
  the energy equation): every field and the diagnostics within 1e-12 of
  the single-device step (the same arithmetic at every point and the
  same faces; it reads 0 bit for bit);
* every configuration outside the slice raises ``ERROR_UNSUPPORTED``
  with its reason (a 2D grid off a y-only mesh, a 3D grid on one, nz
  not divisible or under 3 planes a shard, ny not divisible, non-uniform
  z, custom sources, parity + stretched + energy, a mesh with 'y' before
  'z'), and no other keyword than ``dtype`` and ``plain`` is taken;
* ``make_mesh(devices, axes=("y",))`` lays its communicator out as
  (1, n), so a "y" halo finds its neighbours;
* ``LocalComm``'s periodic ring (``halo`` / ``fill_halo`` with
  ``wrap=True``) and ``edge_swap`` on a (2, 3) grid.
"""

import numpy as np
import pytest
import torch

from cfd_tpu_torch import Grid, Status
from cfd_tpu_torch.boundary.types import (BCType, DirichletValues,
                                          ThermalBCConfig)
from cfd_tpu_torch.core.field import FlowField
from cfd_tpu_torch.core.status import CFDError
from cfd_tpu_torch.parallel import (LocalComm, make_mesh,
                                    make_sharded_step)
from cfd_tpu_torch.solvers.ns.euler import make_euler_step
from cfd_tpu_torch.solvers.ns.params import NSParams
from cfd_tpu_torch.solvers.ns.rk import make_rk2_step, make_rk4_step

torch.set_num_threads(min(2, torch.get_num_threads()))

CPU = torch.device("cpu")
NAMES = ("u", "v", "w", "p", "rho", "T")
MAKERS = {"explicit_euler": make_euler_step, "rk2": make_rk2_step,
          "rk4": make_rk4_step}
FACES = ThermalBCConfig(left=BCType.DIRICHLET, right=BCType.NEUMANN,
                        bottom=BCType.NEUMANN, top=BCType.DIRICHLET,
                        back=BCType.PERIODIC, front=BCType.DIRICHLET,
                        dirichlet_values=DirichletValues(
                            left=299.0, top=320.0, front=280.0))
THERMAL = dict(alpha=1e-3, beta=3e-3, T_ref=300.0, gravity=(0.5, -9.81, 2.0),
               thermal_bc=FACES)
VARIANTS = {
    "uniform": (False, NSParams()),
    "thermal": (False, NSParams(**THERMAL)),
    "parity": (True, NSParams()),
    "consistent": (True, NSParams(nonuniform_scheme="consistent",
                                  alpha=1e-3, thermal_bc=FACES)),
}
MESHES = {"4z": lambda: make_mesh([CPU] * 4, axes=("z",)),
          "2x2": lambda: make_mesh([CPU] * 4),
          "4y": lambda: make_mesh([CPU] * 4, axes=("y",))}


def _grid(stretched, two_d):
    nz = 1 if two_d else 12
    ny = 16 if two_d else 12
    if stretched:
        return Grid.stretched(11, ny, nz, zmin=0.0,
                              zmax=0.0 if two_d else 1.0, beta=1.5,
                              stretch_axes="xy")
    return Grid.uniform(11, ny, nz, zmin=0.0, zmax=0.0 if two_d else 1.0)


def _field(shape, seed=4):
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.tensor(a, dtype=torch.float64)

    uvwp = [t(rng.normal(0.0, 0.2, shape)) for _ in range(4)]
    uvwp[0][0, 0, 3] = 3.0          # a velocity shell above the interior
    return FlowField(*uvwp, t(1.0 + 0.05 * rng.random(shape)),
                     t(300.0 + rng.normal(0.0, 1.0, shape)))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("method", list(MAKERS))
def test_float64_steps_equal_single_device(method, variant, mesh_name):
    stretched, params = VARIANTS[variant]
    grid = _grid(stretched, mesh_name == "4y")
    single = MAKERS[method](grid, params, torch.float64, "cpu")
    step, place = make_sharded_step(grid, params, MESHES[mesh_name](),
                                    method, dtype=torch.float64)
    f = _field(grid.shape)
    fs = place(f)
    for it in range(3):
        f, res1 = single(f, 1e-3, it)
        fs, res = step(fs, 1e-3, it)
    g = fs.gather()
    for n in NAMES:
        np.testing.assert_allclose(getattr(g, n).numpy(),
                                   getattr(f, n).numpy(), rtol=0,
                                   atol=1e-12, err_msg=n)
    assert int(res.status) == int(res1.status) == 0
    for a in ("max_velocity", "max_pressure", "max_temperature"):
        assert float(getattr(res, a)) == pytest.approx(
            float(getattr(res1, a)), rel=1e-12, abs=1e-12), a


def _uniform3(nz=12, ny=12):
    return Grid.uniform(11, ny, nz, zmin=0.0, zmax=1.0)


REFUSALS = {
    "2d on a z mesh": (lambda: (Grid.uniform(11, 16), NSParams(),
                                MESHES["4z"]()), "needs a y-only mesh"),
    "2d on (2, 2)": (lambda: (Grid.uniform(11, 16), NSParams(),
                              MESHES["2x2"]()), "needs a y-only mesh"),
    "3d on a y mesh": (lambda: (_uniform3(), NSParams(), MESHES["4y"]()),
                       "needs a mesh over ('z'[, 'y']) axes"),
    "nz indivisible": (lambda: (_uniform3(nz=10), NSParams(),
                                MESHES["4z"]()), "nz=10 must be divisible"),
    "2 planes a shard": (lambda: (_uniform3(nz=8), NSParams(),
                                  MESHES["4z"]()), ">= 3 planes per shard"),
    "ny indivisible": (lambda: (_uniform3(ny=13), NSParams(),
                                MESHES["2x2"]()), "ny=13 must be divisible"),
    "2d ny indivisible": (lambda: (Grid.uniform(11, 18), NSParams(),
                                   MESHES["4y"]()),
                          "ny=18 must be divisible"),
    "stretched z": (lambda: (Grid.stretched(11, 12, 12, zmin=0.0, zmax=1.0,
                                            beta=1.5, stretch_axes="xyz"),
                             NSParams(), MESHES["4z"]()),
                    "uniform z spacing"),
    "custom source": (lambda: (_uniform3(), NSParams(
        source_func=lambda x, y, z, t: (x, y, z)), MESHES["4z"]()),
        "custom source callables use the jnp path"),
    "heat source": (lambda: (Grid.uniform(11, 16), NSParams(
        heat_source_func=lambda x, y, z, t: x), MESHES["4y"]()),
        "custom source callables use the jnp path"),
    "parity + energy": (lambda: (_grid(True, False),
                                 NSParams(alpha=1e-3, thermal_bc=FACES),
                                 MESHES["2x2"]()), "energy"),
    "y before z": (lambda: (_uniform3(), NSParams(),
                            make_mesh([CPU] * 4, axes=("y", "z"))),
                   "'y' axis before 'z'"),
}


@pytest.mark.parametrize("method", list(MAKERS))
@pytest.mark.parametrize("case", list(REFUSALS))
def test_refusals(case, method):
    build, text = REFUSALS[case]
    grid, params, mesh = build()
    with pytest.raises(CFDError) as err:
        make_sharded_step(grid, params, mesh, method, dtype=torch.float64)
    assert err.value.status == Status.ERROR_UNSUPPORTED
    assert text in str(err.value)


def test_projection_keywords_refused():
    with pytest.raises(CFDError, match="apply to the projection step"):
        make_sharded_step(_uniform3(), NSParams(), MESHES["4z"](), "rk2",
                          poisson_method=None, dtype=torch.float64)


def test_y_only_mesh_lays_out_one_row():
    mesh = make_mesh([CPU] * 4, axes=("y",))
    assert mesh.comm.shape == (1, 4)
    blocks = [torch.full((1, 2, 3), float(s)) for s in range(4)]
    (lo, hi), = mesh.comm.halo(blocks, 1, "y")[1:2]
    assert float(lo.max()) == 0.0 and float(hi.max()) == 2.0


def _ranked(comm, shape):
    """Each shard's block, its entries the shard's index."""
    return [torch.full(shape, float(s)) for s in comm.shards]


def test_local_comm_periodic_ring_and_edge_swap():
    comm = LocalComm([CPU] * 6)
    comm.set_shape((2, 3))
    blocks = [b + torch.arange(4.0).reshape(1, 4, 1)
              for b in _ranked(comm, (2, 4, 3))]
    open_ = comm.halo(blocks, 2, "y")
    bufs = [torch.nn.functional.pad(b, (0, 0, 2, 2)) for b in blocks]
    comm.fill_halo(bufs, 2, "y", wrap=True)
    for s, (b, (olo, ohi)) in enumerate(zip(bufs, open_)):
        zi, yi = comm.coords(s)
        left, right = zi * 3 + (yi - 1) % 3, zi * 3 + (yi + 1) % 3
        assert torch.equal(b[:, :2], blocks[left][:, 2:])
        assert torch.equal(b[:, -2:], blocks[right][:, :2])
        assert torch.equal(b[:, 2:-2], blocks[s])
        if yi == 0:
            assert float(olo.abs().max()) == 0.0
    to_first = [b[:, -2:-1] + 100.0 for b in blocks]
    to_last = [b[:, 1:2] + 200.0 for b in blocks]
    for axis, group in (("y", 3), ("z", 2)):
        got = comm.edge_swap(to_first, to_last, axis)
        for s, (from_last, from_first) in enumerate(got):
            first, last = comm.edges(s, axis)
            assert (from_last is None) == (s != first)
            assert (from_first is None) == (s != last)
            if s == first:
                assert torch.equal(from_last, to_first[last])
            if s == last:
                assert torch.equal(from_first, to_last[first])
