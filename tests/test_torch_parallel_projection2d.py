"""The y-decomposed 2D projection step (`cfd_tpu_torch.parallel.fused`
on a y-only mesh, FFT_DIRECT, plain versions on `LocalComm` CPU shards)
against the reference's and the port's single-device step.

* Against the reference's 2D sharded step (``make_sharded_step`` on 4
  of its virtual devices, interpret mode), float32, one step from random
  u, v, p: at 128×192 (the reference takes its pencil route there, the
  same solve) and at 1024×96 (its DST-fused variant: in-kernel x DSTs and
  the slab y-eigen solve).  Bars: the reference's own against its
  one-device step (`tests/parallel/test_fused_sharded.py:448-483`): u,
  v, w within 5e-6, p within 5e-5 at 128×192.  At 1024×96 p's float32
  error is the 2D solve's conditioning: 7.5e-5 for the port's
  sharded and single-device steps alike, 6.0e-5 for the reference's,
  against a float64 step, so p is held there at 1.5× the reference's own
  error, the bar of the single-device 2D step's tests.
* ``spectral_precision="high"`` at 1024×96: p within 3e-3·max|p| of the
  reference's HIGH step and of the port's HIGHEST step, and off the
  HIGHEST step (it reached the 3xTF32 products; the reference's HIGH
  bars, `:551-564`).
* float64, three steps with the decaying sources on, at 36×24 over 4
  and 30×20 over 2 y-shards (widths that are no multiple of 128):
  within 1e-12 of the port's single-device step.
* The facade: ``Simulation.create(..., solver_type="projection_spectral",
  mesh=)`` on a 2D y mesh, three steps, against the single-device
  session in float64 (fields within 1e-12, the stats' maxima at rtol
  1e-12).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from cfd_tpu import FlowField as JField
from cfd_tpu import Grid as JGrid
from cfd_tpu.parallel import make_mesh as j_make_mesh
from cfd_tpu.parallel import make_sharded_step as j_make_sharded_step
from cfd_tpu.solvers.ns import NSParams as JParams
from cfd_tpu_torch.api import Simulation
from cfd_tpu_torch.core.grid import Grid
from cfd_tpu_torch.interop import field_from_numpy, grid_from
from cfd_tpu_torch.parallel import gather_field, make_mesh, make_sharded_step
from cfd_tpu_torch.solvers.ns.params import NSParams
from cfd_tpu_torch.solvers.ns.projection import make_projection_step
from cfd_tpu_torch.solvers.poisson.base import Method

torch.set_num_threads(min(2, torch.get_num_threads()))

CPU = torch.device("cpu")
NAMES = ("u", "v", "w", "p", "rho", "T")


def _ymesh(n):
    return make_mesh([CPU] * n, axes=("y",))


def _pair(nx, ny, precision=None, seed=41):
    """The reference's and the port's 2D sharded steps over 4 y-shards,
    and their placed starts (the reference's test's random u, v, p)."""
    jgrid = JGrid.uniform(nx, ny)
    rng = np.random.default_rng(seed)
    jf = JField.initialize(jgrid, dtype=jnp.float32)
    jf = jf.replace(**{n: jnp.asarray(rng.normal(0, 0.1, jgrid.shape),
                                      jnp.float32) for n in "uvp"})
    jstep, jplace = j_make_sharded_step(
        jgrid, JParams(), j_make_mesh(jax.devices()[:4], axes=("y",)),
        "projection", use_pallas=True, strict=True, dtype=jnp.float32,
        spectral_precision=(None if precision is None
                            else lax.Precision.HIGH))
    step, place = make_sharded_step(grid_from(jgrid), NSParams(), _ymesh(4),
                                    "projection", dtype=torch.float32,
                                    spectral_precision=precision)
    f = field_from_numpy({n: np.asarray(getattr(jf, n)) for n in NAMES},
                         "cpu", torch.float32)
    return (jstep, jplace(jf)), (step, place(f))


@pytest.mark.parametrize("shape", [(128, 192), (1024, 96)],
                         ids=["pencil", "dst_fused"])
def test_2d_step_matches_reference_sharded_step(shape):
    (jstep, jf), (step, fs) = _pair(*shape)
    jout, jres = jstep(jf, 0.001, 0)
    out, res = step(fs, 0.001, 0)
    assert int(res.status) == int(jres.status) == 0
    assert len(out.blocks) == 4
    assert tuple(out.blocks[0].u.shape) == (1, shape[1] // 4, shape[0])
    g = gather_field(out)
    for n in "uvw":
        np.testing.assert_allclose(getattr(g, n).numpy(),
                                   np.asarray(getattr(jout, n)), rtol=0,
                                   atol=5e-6, err_msg=n)
    np.testing.assert_allclose(float(res.max_velocity),
                               float(jres.max_velocity), rtol=1e-5)
    # p against the float64 step: within 1.5x the reference's own float32
    # error (7.5e-5 against 6.0e-5 at 1024x96, where the 2D solve's
    # conditioning sets both), and within 5e-5 of the reference's p at
    # 128x192
    f64 = field_from_numpy({n: np.asarray(getattr(jf, n)).astype(np.float64)
                            for n in NAMES}, "cpu", torch.float64)
    p64 = make_projection_step(Grid.uniform(*shape), NSParams(),
                               torch.float64, Method.FFT_DIRECT,
                               device="cpu")(f64, 1e-3, 0)[0].p.numpy()
    err, ref_err = (np.abs(np.asarray(p) - p64).max()
                    for p in (g.p.numpy(), jout.p))
    assert err <= 1.5 * ref_err, (err, ref_err)
    if shape == (128, 192):
        np.testing.assert_allclose(g.p.numpy(), np.asarray(jout.p), rtol=0,
                                   atol=5e-5)


def test_2d_high_matches_reference_high():
    (jstep, jf), (step, fs) = _pair(1024, 96, "high")
    jout, jres = jstep(jf, 0.001, 0)
    out, res = step(fs, 0.001, 0)
    assert int(res.status) == int(jres.status) == 0
    highest, _ = make_sharded_step(grid_from(JGrid.uniform(1024, 96)),
                                   NSParams(), fs.mesh, "projection",
                                   dtype=torch.float32)
    ref_p = gather_field(highest(fs, 0.001, 0)[0]).p.numpy()
    p = gather_field(out).p.numpy()
    pscale = float(np.abs(ref_p).max())
    assert np.abs(p - np.asarray(jout.p)).max() / pscale < 3e-3
    assert np.abs(p - ref_p).max() / pscale < 3e-3
    assert np.abs(p - ref_p).max() > 0.0


@pytest.mark.parametrize("case", [(36, 24, 4), (30, 20, 2)],
                         ids=["36x24_4y", "30x20_2y"])
def test_2d_float64_steps_match_single_device(case):
    nx, ny, n = case
    grid = Grid.uniform(nx, ny)
    params = NSParams(source_amplitude_u=1.0, source_amplitude_v=0.5)
    rng = np.random.default_rng(3)
    arrays = {k: rng.normal(0, 0.1, (1, ny, nx)) for k in "uvwp"}
    arrays.update(rho=np.ones((1, ny, nx)), T=np.full((1, ny, nx), 300.0))
    f = field_from_numpy(arrays, "cpu", torch.float64)
    ref = make_projection_step(grid, params, torch.float64,
                               Method.FFT_DIRECT, device="cpu")
    step, place = make_sharded_step(grid, params, _ymesh(n), "projection",
                                    dtype=torch.float64)
    fr, fs = f, place(f)
    for i in range(3):
        fr, rr = ref(fr, 1e-3, i)
        fs, rs = step(fs, 1e-3, i)
        assert int(rs.status) == int(rr.status) == 0
    g = gather_field(fs)
    for k in NAMES:
        np.testing.assert_allclose(getattr(g, k).numpy(),
                                   getattr(fr, k).numpy(), rtol=0,
                                   atol=1e-12, err_msg=k)
    for a in ("max_velocity", "max_pressure", "max_temperature"):
        np.testing.assert_allclose(float(getattr(rs, a)),
                                   float(getattr(rr, a)), rtol=1e-12)


def test_facade_on_2d_y_mesh_matches_single_device():
    kw = dict(solver_type="projection_spectral", dtype=torch.float64)
    sim = Simulation.create(32, 16, mesh=_ymesh(4), **kw)
    one = Simulation.create(32, 16, device="cpu", **kw)
    start = field_from_numpy(
        {k: np.random.default_rng(9).normal(0, 0.1, (1, 16, 32))
         for k in "uvp"} | {"w": np.zeros((1, 16, 32)),
                            "rho": np.ones((1, 16, 32)),
                            "T": np.full((1, 16, 32), 300.0)},
        "cpu", torch.float64)
    sim.field, one.field = sim.solver.place(start), start
    for _ in range(3):
        assert int(sim.step()) == 0
        assert int(one.step()) == 0
    assert len(sim.field.blocks) == 4
    g = sim.field.gather()
    for k in NAMES:
        np.testing.assert_allclose(getattr(g, k).numpy(),
                                   getattr(one.field, k).numpy(), rtol=0,
                                   atol=1e-12, err_msg=k)
    s, s1 = sim.get_stats(), one.get_stats()
    for a in ("max_velocity", "max_pressure", "max_temperature"):
        np.testing.assert_allclose(getattr(s, a), getattr(s1, a),
                                   rtol=1e-12, err_msg=a)
