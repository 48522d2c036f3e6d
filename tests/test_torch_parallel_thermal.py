"""The energy equation and Boussinesq buoyancy on the decomposed projection
steps (`cfd_tpu_torch.parallel.thermal`, `parallel.fused`), on
`LocalComm` CPU shards, against the port's single-device step.  T is
300 + noise; the thermal faces mix Dirichlet (values above and below
the field's T, so max T is a face's), Neumann and periodic faces on every
split axis.

* the energy post-step on shard blocks (`make_sharded_thermal_post`)
  against the single-device ``thermal_post_step`` on z meshes of 2 and 4
  shards, (z, y) meshes of (2, 2) and (1, 4), and a 4-shard y mesh on a
  2D grid, in float32 and float64: every block and its max T bit-equal;
  `HaloBuffers` against the zero-padded whole field;
* the buoyant predictor's plain twin on the shards' T buffers and
  padded u, v, w blocks (z, (z, y) and y): the owned window bit-equal to
  the single-device buoyant predictor;
* three steps with energy and buoyancy: the z-only FFT_DIRECT step
  bit-equal to one device in float32 and float64, the CG, BiCGSTAB,
  (z, y) and 2D steps within 1e-10 in float64 (their solves sum in
  another order); the step's max T is the new T's;
* ``NSSolver(mesh=)`` and ``Simulation.create(..., mesh=)`` with thermal
  parameters against the single-device solver and facade.
"""

import numpy as np
import pytest
import torch

from cfd_tpu_torch import Grid
from cfd_tpu_torch.api import Simulation
from cfd_tpu_torch.boundary.types import (BCType, DirichletValues,
                                          ThermalBCConfig)
from cfd_tpu_torch.core.field import FlowField
from cfd_tpu_torch.ops.kernels import projection_kernels as pkm
from cfd_tpu_torch.parallel import (ShardedField, make_mesh,
                                    make_sharded_step, shard_field)
from cfd_tpu_torch.parallel.thermal import (HaloBuffers,
                                            make_sharded_thermal_post)
from cfd_tpu_torch.solvers.ns.params import NSParams
from cfd_tpu_torch.solvers.ns.projection import (make_projection_step,
                                                 thermal_post_step)
from cfd_tpu_torch.solvers.ns.solver import NSSolver
from cfd_tpu_torch.solvers.poisson.base import Method, PoissonParams

torch.set_num_threads(min(2, torch.get_num_threads()))

CPU = torch.device("cpu")
NAMES = ("u", "v", "w", "p", "rho", "T")
D, N, PER = BCType.DIRICHLET, BCType.NEUMANN, BCType.PERIODIC
VALUES = DirichletValues(left=299.0, right=303.5, bottom=303.0, top=297.0,
                         back=304.0, front=296.0)
# (left, right, bottom, top, back, front): every type on every axis
MIXES = {"dn": (D, N, D, N, D, N), "periodic": (PER,) * 6,
         "nd": (N, D, N, D, N, D)}
MESHES = {"2z": lambda: make_mesh([CPU] * 2, axes=("z",)),
          "4z": lambda: make_mesh([CPU] * 4, axes=("z",)),
          "2x2": lambda: make_mesh([CPU] * 4),
          "1x4": lambda: make_mesh([CPU] * 4, shape=(1, 4)),
          "4y": lambda: make_mesh([CPU] * 4, axes=("y",))}
DTYPES = {"f32": torch.float32, "f64": torch.float64}


def faces(mix):
    names = ("left", "right", "bottom", "top", "back", "front")
    return ThermalBCConfig(**dict(zip(names, MIXES[mix])),
                           dirichlet_values=VALUES)


def thermal(mix="dn", **kw):
    return NSParams(alpha=2e-3, beta=3e-3, T_ref=300.0,
                    gravity=(0.5, -9.81, 2.0), thermal_bc=faces(mix), **kw)


def grid_of(mesh_name):
    """8 planes and 8 rows over the 3D meshes (2 a shard over 4), 16 rows
    of a 2D grid over the y mesh."""
    if mesh_name == "4y":
        return Grid.uniform(12, 16)
    return Grid.uniform(12, 8, 8, zmin=0.0, zmax=1.0)


def field(shape, dtype, seed=5):
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.tensor(a, dtype=dtype)

    uvwp = [t(rng.normal(0.0, 0.3, shape)) for _ in range(4)]
    return FlowField(*uvwp, t(1.0 + 0.05 * rng.random(shape)),
                     t(300.0 + rng.normal(0.0, 1.0, shape)))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("mix", list(MIXES))
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_post_step_on_blocks_equals_single_device(mesh_name, mix, dtype):
    dtype = DTYPES[dtype]
    grid, mesh = grid_of(mesh_name), MESHES[mesh_name]()
    params = thermal(mix)
    f = field(grid.shape, dtype)
    dt = torch.full((), 1e-2, dtype=dtype)
    want = thermal_post_step(grid, params)(f, dt)
    post = make_sharded_thermal_post(grid, params, mesh.comm, dtype)
    placed = shard_field(f, mesh)
    ts, tmax = post(list(placed.blocks), dt)
    got = placed.with_blocks(b.replace(T=t) for b, t in
                             zip(placed.blocks, ts)).gather()
    assert torch.equal(got.T, want.T)
    assert not torch.equal(want.T, f.T)
    assert torch.equal(torch.stack(tmax).amax(), torch.amax(want.T))
    for t, m in zip(ts, tmax):
        assert torch.equal(m, torch.amax(t))


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_halo_buffers_hold_the_neighbours(mesh_name):
    """Two halos a side, rows then planes: each buffer is its window of
    the whole field zero-padded (the corners from the diagonal shard)."""
    grid, mesh = grid_of(mesh_name), MESHES[mesh_name]()
    f = field(grid.shape, torch.float64)
    pz, py = mesh.comm.shape
    nz, ny, nx = grid.shape
    owned = (nz // pz, ny // py, nx)
    bufs = HaloBuffers(mesh.comm, owned, 2, torch.float64)
    hz, hy = bufs.hz, bufs.hy
    padded = torch.nn.functional.pad(f.T, (0, 0, hy, hy, hz, hz))
    for s, buf in zip(mesh.comm.shards, bufs.fill(
            [b.T for b in shard_field(f, mesh).blocks])):
        zi, yi = mesh.comm.coords(s)
        z0, y0 = zi * owned[0], yi * owned[1]
        assert torch.equal(buf, padded[z0:z0 + owned[0] + 2 * hz,
                                       y0:y0 + owned[1] + 2 * hy])


@pytest.mark.parametrize("mesh_name", ["4z", "2x2", "1x4", "4y"])
def test_buoyant_predictor_twin_on_blocks(mesh_name):
    """The buoyant predictor's plain twin in its global_nz / global-row
    mode, on u, v, w padded two planes (rows) a side and the shards' T
    buffers: the owned window equals the single-device predictor's."""
    grid, mesh = grid_of(mesh_name), MESHES[mesh_name]()
    params = thermal()
    f = field(grid.shape, torch.float32)
    nz, ny, nx = grid.shape
    c = pkm.stencil_consts(nz, ny, nx, grid.dx0, grid.dy0, grid.dz0,
                           grid.xmin, grid.ymin, params.mu, True, params,
                           torch.float32)
    assert c.buoyancy is not None
    scal = torch.tensor([1e-3, 0.1, 0.05])
    whole = pkm.predictor_star_plain(f.u, f.v, f.w, scal, c, f.T)
    pz, py = mesh.comm.shape
    owned = (nz // pz, ny // py, nx)
    temps = HaloBuffers(mesh.comm, owned, 2, torch.float32)
    hz, hy = temps.hz, temps.hy
    padded = [torch.nn.functional.pad(a, (0, 0, hy, hy, hz, hz))
              for a in (f.u, f.v, f.w)]
    cb = pkm.stencil_consts(owned[0] + 2 * hz, owned[1] + 2 * hy, nx,
                            grid.dx0, grid.dy0, grid.dz0, grid.xmin,
                            grid.ymin, params.mu, True, params,
                            torch.float32)
    ts = temps.fill([b.T for b in shard_field(f, mesh).blocks])
    for s, tb in zip(mesh.comm.shards, ts):
        zi, yi = mesh.comm.coords(s)
        z0, y0 = zi * owned[0], yi * owned[1]
        blk = [a[z0:z0 + owned[0] + 2 * hz, y0:y0 + owned[1] + 2 * hy]
               for a in padded]
        if nz > 1:
            zy = (z0 - hz, nz) + ((y0 - hy, ny) if hy else ())
            out = pkm.predictor_star_plain(*blk, scal, cb, tb, *zy)
        else:
            out = pkm.predictor_star_plain(*blk, scal, cb, tb,
                                           y_base=y0 - hy, ny_g=ny)
        for got, want in zip(out, whole):
            win = got[hz:hz + owned[0], hy:hy + owned[1]]
            assert torch.equal(win, want[z0:z0 + owned[0],
                                         y0:y0 + owned[1]])


STEPS = {
    # mesh, method, dtype, bar (None: bit for bit)
    "4z fft f32": ("4z", Method.FFT_DIRECT, torch.float32, None),
    "4z fft f64": ("4z", Method.FFT_DIRECT, torch.float64, None),
    "2z fft periodic f32": ("2z", Method.FFT_DIRECT, torch.float32, None),
    "4z cg f64": ("4z", Method.CG, torch.float64, 1e-10),
    "4z bicgstab f64": ("4z", Method.BICGSTAB, torch.float64, 1e-10),
    "2x2 fft f64": ("2x2", Method.FFT_DIRECT, torch.float64, 1e-10),
    "2x2 cg f64": ("2x2", Method.CG, torch.float64, 1e-10),
    "1x4 bicgstab f64": ("1x4", Method.BICGSTAB, torch.float64, 1e-10),
    "4y fft f64": ("4y", Method.FFT_DIRECT, torch.float64, 1e-10),
}


@pytest.mark.parametrize("case", list(STEPS))
def test_steps_equal_single_device(case):
    mesh_name, method, dtype, bar = STEPS[case]
    grid = grid_of(mesh_name)
    params = thermal("periodic" if "periodic" in case else "dn",
                     source_amplitude_u=0.0, source_amplitude_v=0.0)
    pp = (None if method == Method.FFT_DIRECT
          else PoissonParams(tolerance=1e-10, max_iterations=500))
    single = make_projection_step(grid, params, dtype, method, pp,
                                  device="cpu")
    step, place = make_sharded_step(grid, params, MESHES[mesh_name](),
                                    "projection", dtype=dtype,
                                    poisson_method=method, poisson_params=pp)
    f = field(grid.shape, dtype, seed=9)
    fs = place(f)
    for it in range(3):
        f, r1 = single(f, 1e-3, it)
        fs, r = step(fs, 1e-3, it)
    g = fs.gather()
    assert int(r.status) == int(r1.status) == 0
    for n in NAMES:
        if bar is None:
            assert torch.equal(getattr(g, n), getattr(f, n)), n
        else:
            np.testing.assert_allclose(getattr(g, n).numpy(),
                                       getattr(f, n).numpy(), rtol=0,
                                       atol=bar, err_msg=n)
    # the new T's max (a Dirichlet face's value here), not the old T's
    assert torch.equal(r.max_temperature, torch.amax(g.T))
    assert torch.equal(r.max_temperature, r1.max_temperature)
    for a in ("max_velocity", "max_pressure"):
        assert float(getattr(r, a)) == pytest.approx(
            float(getattr(r1, a)), rel=1e-10, abs=1e-12), a


def test_buoyancy_alone_passes_t_through():
    """β ≠ 0 and α = 0: the predictor reads T, T itself does not change,
    and max T is the step-start T's."""
    grid = grid_of("2x2")
    params = NSParams(beta=3e-3, T_ref=300.0, gravity=(0.0, -9.81, 2.0))
    single = make_projection_step(grid, params, torch.float64,
                                  Method.FFT_DIRECT, device="cpu")
    step, place = make_sharded_step(grid, params, MESHES["2x2"](),
                                    "projection", dtype=torch.float64)
    f = field(grid.shape, torch.float64, seed=3)
    f1, r1 = single(f, 1e-3, 0)
    fs, r = step(place(f), 1e-3, 0)
    g = fs.gather()
    assert torch.equal(g.T, f.T)
    assert torch.equal(r.max_temperature, torch.amax(f.T))
    still = make_projection_step(grid, NSParams(), torch.float64,
                                 Method.FFT_DIRECT, device="cpu")(f, 1e-3, 0)
    assert float((g.v - still[0].v).abs().max()) > 1e-6    # it acts
    np.testing.assert_allclose(g.v.numpy(), f1.v.numpy(), rtol=0,
                               atol=1e-12)


def test_solver_and_facade_on_a_mesh():
    grid = grid_of("2x2")
    params = thermal(max_iter=2)
    f = field(grid.shape, torch.float64, seed=12)
    outs = {}
    for kind, mesh in (("mesh", MESHES["2x2"]()), ("single", None)):
        solver = NSSolver(name="p", method="projection",
                          poisson_method=Method.FFT_DIRECT,
                          dtype=torch.float64, device="cpu", mesh=mesh)
        solver.init(grid, params)
        g, stats = solver.solve(solver.place(f), 1e-3)
        assert int(stats.status) == 0 and stats.iterations == 2
        outs[kind] = (g.gather() if kind == "mesh" else g), stats
    for n in NAMES:
        np.testing.assert_allclose(getattr(outs["mesh"][0], n).numpy(),
                                   getattr(outs["single"][0], n).numpy(),
                                   rtol=0, atol=1e-10, err_msg=n)
    assert outs["mesh"][1].max_temperature == pytest.approx(
        outs["single"][1].max_temperature, abs=1e-12)
    sims = {}
    for kind, kw in (("mesh", {"mesh": MESHES["4y"]()}),
                     ("single", {"device": "cpu"})):
        sim = Simulation.create(12, 16, solver_type="projection_spectral",
                                params=thermal(), dtype=torch.float64, **kw)
        sim.field = sim.solver.place(field((1, 16, 12), torch.float64, 4))
        for _ in range(2):
            assert int(sim.step()) == 0
        sims[kind] = sim
    assert isinstance(sims["mesh"].field, ShardedField)
    got = sims["mesh"].field.gather()
    for n in NAMES:
        np.testing.assert_allclose(getattr(got, n).numpy(),
                                   getattr(sims["single"].field, n).numpy(),
                                   rtol=0, atol=1e-10, err_msg=n)
