"""The port's CG projection step (the reference's default pressure solve)
against the reference's, on the CPU.

* A1's rhs form and the non-DST ``corr_all`` (3D), and the 2D ``pred_bt``
  rhs form and non-DST ``corr``, against the reference's kernels in
  interpret mode (float32): the port's rhs kernel is its b̃ kernel with
  the emit flag set, its ``corr_all`` the spectral step's corrector on a
  physical p;
* the 3D step against the reference's fused CG step (interpret mode,
  float32, 128×16×8, 2 steps) and its jnp step (float64, 24×20×10, and
  24×20×3, which only CG runs);
* the 2D step against the reference's fused 2D step with the whole-solve
  CG (interpret mode, float32, 128×64) and its jnp step (float64,
  100×50);
* a solve that does not converge fails the step with −7 (MAX_ITER), as
  in the reference; a NaN still gives −6.

Both packages get the same numpy inputs from ``np.random.default_rng``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_tpu import FlowField as JField
from cfd_tpu import Grid as JGrid
from cfd_tpu.ops.pallas.projection2d import Projection2DKernels as JK2
from cfd_tpu.ops.pallas.projection_kernels import ProjectionKernels as JK3
from cfd_tpu.solvers.ns import NSParams as JParams
from cfd_tpu.solvers.ns.projection import \
    make_projection_step as j_make_step
from cfd_tpu.solvers.poisson.base import Method as JMethod
from cfd_tpu.solvers.poisson.base import PoissonParams as JPParams
from cfd_tpu_torch import Grid
from cfd_tpu_torch.interop import field_from_numpy
from cfd_tpu_torch.ops.kernels import projection2d as pk2m
from cfd_tpu_torch.ops.kernels import projection_kernels as pkm
from cfd_tpu_torch.solvers.ns.params import NSParams
from cfd_tpu_torch.solvers.ns.projection import make_projection_step
from cfd_tpu_torch.solvers.poisson.base import Method, PoissonParams

torch.set_num_threads(min(2, torch.get_num_threads()))

FIELDS = ("u", "v", "w", "p")
DT, NU, SU, SV, RHO = 0.001, 0.01, 0.1, 0.05, 1.0


def _random_numpy_field(shape, seed, np_dt, amp=0.1):
    rng = np.random.default_rng(seed)
    out = {n: rng.normal(0.0, amp, shape).astype(np_dt) for n in FIELDS}
    out["rho"] = np.ones(shape, np_dt)
    out["T"] = np.full(shape, 300.0, np_dt)
    return out


def _grids(shape):
    nz, ny, nx = shape
    if nz == 1:
        return Grid.uniform(nx, ny), JGrid.uniform(nx, ny)
    return (Grid.uniform(nx, ny, nz, zmin=0.0, zmax=1.0),
            JGrid.uniform(nx, ny, nz, zmin=0.0, zmax=1.0))


# ---- the kernels of the CG step ---------------------------------------------

def _s(v):
    return torch.tensor(v, dtype=torch.float32)


def test_3d_rhs_and_corr_all_match_reference():
    """u*, v*, w* and u, v, w within atol 2e-5 (the reference's
    fused-vs-plain bar), the rhs within 1e-6 of its max (the same
    operations; ρ/dt = 1000 scales u*'s rounding), the maxima within rtol
    1e-6."""
    shape = (8, 16, 128)
    nz, ny, nx = shape
    rng = np.random.default_rng(11)
    u, v, w, p = (rng.normal(0.0, 0.1, shape).astype(np.float32)
                  for _ in range(4))
    g, jg = _grids(shape)
    f32 = jnp.float32
    jk = JK3(nz, ny, nx, jg.dx0, jg.dy0, jg.dz0, jg.xmin, jg.ymin, f32,
             emit="rhs", interpret=True)
    ref = jk.predictor_poisson_input(*map(jnp.asarray, (u, v, w, p)),
                                     f32(DT), NU, f32(SU), f32(SV),
                                     f32(RHO / DT))
    ref_c = jk.corrector_diag(ref[0], ref[1], ref[2], jnp.asarray(p),
                              f32(DT / RHO))
    pk = pkm.ProjectionKernels(nz, ny, nx, g.dx0, g.dy0, g.dz0, g.xmin,
                               g.ymin, NU, emit="rhs")
    got = pk.predictor_poisson_input(*map(torch.tensor, (u, v, w, p)),
                                     _s(DT), _s(SU), _s(SV), _s(RHO / DT))
    got_c = pk.corrector_diag(*(torch.tensor(np.asarray(a))
                                for a in ref[:3]), torch.tensor(p),
                              _s(DT / RHO))
    for name, a, b in zip(("u*", "v*", "w*"), got[:3], ref[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=2e-5, err_msg=name)
    rhs_ref = np.asarray(ref[3])
    np.testing.assert_allclose(got[3].numpy(), rhs_ref, rtol=0,
                               atol=1e-6 * np.abs(rhs_ref).max())
    for name, a, b in zip(("u", "v", "w"), got_c[:3], ref_c[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=2e-5, err_msg=name)
    for name, a, b in zip(("max|u|^2", "max p", "max|p|"), got_c[3:],
                          ref_c[3:]):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-6,
                                   err_msg=name)


def test_2d_rhs_and_corr_match_reference():
    """The 2D rhs form and non-DST corr at 128×32, the bars above."""
    shape = (1, 32, 128)
    _, ny, nx = shape
    rng = np.random.default_rng(12)
    u, v, w, p = (rng.normal(0.0, 0.1, shape).astype(np.float32)
                  for _ in range(4))
    g, jg = _grids(shape)
    f32 = jnp.float32
    jk = JK2(ny, nx, jg.dx0, jg.dy0, jg.xmin, jg.ymin, f32, emit="rhs",
             interpret=True)
    ref = jk.predictor_and_poisson_input(*map(jnp.asarray, (u, v, w, p)),
                                         f32(DT), NU, f32(SU), f32(SV),
                                         f32(RHO / DT))
    ref_c = jk.corrector(ref[0], ref[1], jnp.asarray(p), f32(DT / RHO))
    pk = pk2m.Projection2DKernels(ny, nx, g.dx0, g.dy0, g.xmin, g.ymin, NU,
                                  emit="rhs")
    got = pk.predictor_and_poisson_input(*map(torch.tensor, (u, v, w, p)),
                                         _s(DT), _s(SU), _s(SV),
                                         _s(RHO / DT))
    got_c = pk.corrector(torch.tensor(np.asarray(ref[0])),
                         torch.tensor(np.asarray(ref[1])), torch.tensor(p),
                         _s(DT / RHO))
    for name, a, b in zip(("u*", "v*", "w*", "u", "v"),
                          list(got[:3]) + list(got_c),
                          list(ref[:3]) + list(ref_c)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=2e-5, err_msg=name)
    rhs_ref = np.asarray(ref[3])
    np.testing.assert_allclose(got[3].numpy(), rhs_ref, rtol=0,
                               atol=1e-6 * np.abs(rhs_ref).max())


# ---- the steps -----------------------------------------------------------------

def _run_both(shape, np_dt, jnp_kwargs, n_steps, pparams=None, seed=0):
    params = dict(source_amplitude_u=0.1, source_amplitude_v=0.05)
    arrays = _random_numpy_field(shape, seed, np_dt)
    jdt = jnp.float32 if np_dt == np.float32 else jnp.float64
    tdt = torch.float32 if np_dt == np.float32 else torch.float64
    g, jg = _grids(shape)
    jpp = None if pparams is None else JPParams(**pparams)
    tpp = None if pparams is None else PoissonParams(**pparams)
    jstep = jax.jit(j_make_step(jg, JParams(**params), dtype=jdt,
                                poisson_method=JMethod.CG,
                                poisson_params=jpp, **jnp_kwargs))
    step = make_projection_step(g, NSParams(**params), dtype=tdt,
                                poisson_params=tpp, device="cpu")
    jf = JField(**{n: jnp.asarray(a) for n, a in arrays.items()})
    tf = field_from_numpy(arrays, "cpu", tdt)
    out = []
    for i in range(n_steps):
        jf, jr = jstep(jf, DT, i)
        tf, tr = step(tf, DT, i)
        out.append((jf, jr, tf, tr))
    return out


def _assert_step_close(out, atol_uvw, p_rtol, p_atol_rel):
    for jf, jr, tf, tr in out:
        assert int(tr.status) == int(jr.status) == 0
        for n in ("u", "v", "w"):
            np.testing.assert_allclose(getattr(tf, n).numpy(),
                                       np.asarray(getattr(jf, n)), rtol=0,
                                       atol=atol_uvw, err_msg=n)
        p_ref = np.asarray(jf.p)
        np.testing.assert_allclose(tf.p.numpy(), p_ref, rtol=p_rtol,
                                   atol=p_atol_rel * np.abs(p_ref).max(),
                                   err_msg="p")
        np.testing.assert_allclose(float(tr.max_velocity),
                                   float(jr.max_velocity), rtol=1e-6)


def test_3d_step_matches_fused_reference_f32():
    """Against the reference's fused CG step (Pallas predictor, rhs,
    two-pass CG and corrector in interpret mode): u, v, w within atol
    1e-4 (the reference's fused-vs-jnp CG-projection bar,
    `tests/math/test_vmem_small.py:198-199`), p within rtol 1e-3 / atol
    1e-4·max|p| (`tests/math/test_pallas_kernels.py:119-120`)."""
    out = _run_both((8, 16, 128), np.float32,
                    dict(use_pallas=True, pallas_interpret=True), 2)
    _assert_step_close(out, 1e-4, 1e-3, 1e-4)


@pytest.mark.parametrize("shape", [(10, 20, 24), (3, 20, 24)],
                         ids=["24x20x10", "24x20x3"])
def test_3d_step_matches_jnp_reference_f64(shape):
    """Against the reference's jnp step with its jnp CG, float64, 3 steps:
    the same recursion (the port's loop is the fused one, rotated), so
    the fields agree to rounding amplified by the solve, 1e-9."""
    out = _run_both(shape, np.float64, dict(use_pallas=False), 3)
    _assert_step_close(out, 1e-9, 0.0, 1e-9)
    for _, jr, _, tr in out:
        np.testing.assert_allclose(float(tr.residual), float(jr.residual),
                                   rtol=1e-5)


def test_2d_step_matches_fused_reference_f32():
    """Against the reference's fused 2D step with the whole-solve CG
    (interpret mode) at 128×64, `PoissonParams(tolerance=1e-4,
    max_iterations=600)` as `tests/math/test_vmem_small.py:178-199`:
    u, v, w within atol 1e-4, p within rtol 1e-3 / atol 1e-4·max|p|."""
    out = _run_both((1, 64, 128), np.float32,
                    dict(use_pallas=True, pallas_interpret=True), 2,
                    pparams=dict(tolerance=1e-4, max_iterations=600))
    _assert_step_close(out, 1e-4, 1e-3, 1e-4)


def test_2d_step_matches_jnp_reference_f64():
    """Against the reference's jnp step with its jnp CG at 100×50 (the
    facade's published grid), float64, 3 steps."""
    out = _run_both((1, 50, 100), np.float64, dict(use_pallas=False), 3)
    _assert_step_close(out, 1e-9, 0.0, 1e-9)


@pytest.mark.parametrize("shape", [(8, 10, 12), (1, 10, 12)],
                         ids=["3d", "2d"])
def test_unconverged_solve_fails_the_step(shape):
    """A CG cap of 2 iterations: status −7 (MAX_ITER) with the solve's
    residual, as the reference's step."""
    pp = dict(max_iterations=2)
    out = _run_both(shape, np.float64, dict(use_pallas=False), 1,
                    pparams=pp)
    jf, jr, tf, tr = out[0]
    assert int(tr.status) == int(jr.status) == -7
    np.testing.assert_allclose(float(tr.residual), float(jr.residual),
                               rtol=1e-8)


@pytest.mark.nan_injection
@pytest.mark.parametrize("shape", [(8, 10, 12), (1, 10, 12)],
                         ids=["3d", "2d"])
def test_nan_gives_diverged(shape):
    """A NaN survives the CG solve to the diagnostics: −6 (DIVERGED)."""
    arrays = _random_numpy_field(shape, 4, np.float32)
    arrays["u"][(0, 5, 5)] = np.nan
    g, _ = _grids(shape)
    step = make_projection_step(g, NSParams(), dtype=torch.float32,
                                poisson_params=PoissonParams(
                                    max_iterations=20), device="cpu")
    _, res = step(field_from_numpy(arrays, "cpu", torch.float32), DT, 0)
    assert int(res.status) == -6


def test_step_leaves_the_callers_pressure_alone():
    """The solve starts from a copy of field.p: a step run twice from one
    field gives the same result."""
    shape = (6, 10, 12)
    g, _ = _grids(shape)
    step = make_projection_step(g, NSParams(), dtype=torch.float64,
                                poisson_method=Method.CG, device="cpu")
    f = field_from_numpy(_random_numpy_field(shape, 6, np.float64), "cpu",
                         torch.float64)
    p0 = f.p.clone()
    a, _ = step(f, DT, 0)
    b, _ = step(f, DT, 0)
    assert torch.equal(f.p, p0) and torch.equal(a.p, b.p)
