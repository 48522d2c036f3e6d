"""The port's 2D projection step against the reference's.

* the two fused kernels (plain versions, as the wrappers run them on CPU
  tensors) against the reference's `Projection2DKernels` in interpret
  mode: physical b̃ at 128×32, the DST-fused form at 1024×32;
* 3 steps against the reference's fused 2D step (interpret mode, float32,
  sources on) at 128×32 and 1024×32, and against its jnp step (float64)
  at 200×24, a grid no reference kernel gate admits;
* shell passthrough, the ±100 clamp, NaN detection, the lid cavity's BCs
  and the Ghia Re=100 gate at 33² (the bar of
  `tests/validation/test_ghia_cavity.py:26-29`).

Both packages get the same numpy inputs from ``np.random.default_rng``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_tpu import FlowField as JField
from cfd_tpu import Grid as JGrid
from cfd_tpu.boundary import DirichletValues as JDirichlet
from cfd_tpu.boundary import apply_dirichlet_scalar as j_dirichlet
from cfd_tpu.boundary import apply_neumann_scalar as j_neumann
from cfd_tpu.ops.pallas.projection2d import Projection2DKernels as JKernels
from cfd_tpu.solvers.ns import NSParams as JParams
from cfd_tpu.solvers.ns.projection import \
    make_projection_step as j_make_step
from cfd_tpu.solvers.poisson import spectral as jspec
from cfd_tpu.solvers.poisson.base import Method as JMethod
from cfd_tpu.solvers.poisson.base import PoissonProblem as JProblem
from cfd_tpu_torch import FlowField, Grid
from cfd_tpu_torch.boundary import (DirichletValues, apply_dirichlet_scalar,
                                    apply_neumann_scalar)
from cfd_tpu_torch.interop import field_from_numpy, field_to_numpy
from cfd_tpu_torch.ops.kernels import projection2d as pk2
from cfd_tpu_torch.ops.kernels.projection_kernels import StencilConsts
from cfd_tpu_torch.solvers.ns.params import NSParams
from cfd_tpu_torch.solvers.ns.projection import make_projection_step
from cfd_tpu_torch.solvers.ns.rollout import run_steps
from cfd_tpu_torch.solvers.poisson.base import PoissonProblem
from cfd_tpu_torch.solvers.poisson.spectral import make_dst2d_fused_pieces

torch.set_num_threads(min(2, torch.get_num_threads()))

FIELDS = ("u", "v", "w", "p")
DIAGS = ("max_velocity", "max_pressure", "max_temperature")
DT, NU, SU, SV, RHO = 0.001, 0.01, 0.1, 0.05, 1.0


def _random_numpy_field(shape, seed, np_dt, amp=0.1):
    rng = np.random.default_rng(seed)
    out = {n: rng.normal(0.0, amp, shape).astype(np_dt) for n in FIELDS}
    out["rho"] = np.ones(shape, np_dt)
    out["T"] = np.full(shape, 300.0, np_dt)
    return out


def _t(a):
    return torch.tensor(np.array(a))


# ---- the two fused kernels --------------------------------------------------

def _kernel_case(ny, nx, dst, seed):
    """Reference and port outputs on the same inputs: the predictor stage,
    then the corrector fed the same (random) pressure or x̂."""
    rng = np.random.default_rng(seed)
    u, v, w, p = (rng.normal(0.0, 0.1, (1, ny, nx)).astype(np.float32)
                  for _ in range(4))
    xin = rng.normal(0.0, 1.0, (1, ny, nx)).astype(np.float32)
    jg = JGrid.uniform(nx, ny)
    f32 = jnp.float32
    kw = {}
    if dst:
        fxt, gxt, _ = jspec.make_dst2d_fused_pieces(
            JProblem(nx, ny, 1, jg.dx0, jg.dy0), f32, use_kernel=False)
        kw = dict(dst_mats=(fxt, gxt))
    jk = JKernels(ny, nx, jg.dx0, jg.dy0, jg.xmin, jg.ymin, f32,
                  interpret=True, **kw)
    ref_pred = jk.predictor_and_poisson_input(
        *map(jnp.asarray, (u, v, w, p)), f32(DT), NU, f32(SU), f32(SV),
        f32(RHO / DT))
    ref_corr = jk.corrector(ref_pred[0], ref_pred[1], jnp.asarray(xin),
                            f32(DT / RHO))

    dt, su, sv, rod, s = (torch.tensor(x, dtype=torch.float32)
                          for x in (DT, SU, SV, RHO / DT, DT / RHO))
    us_in, vs_in = _t(ref_pred[0]), _t(ref_pred[1])
    if dst:
        g = Grid.uniform(nx, ny)
        mats = make_dst2d_fused_pieces(
            PoissonProblem(nx, ny, 1, g.dx0, g.dy0), torch.float32)[:2]
        kern = pk2.Projection2DKernels(ny, nx, g.dx0, g.dy0, g.xmin, g.ymin,
                                       NU, mats)
        pred = kern.predictor_and_poisson_input(
            *map(torch.tensor, (u, v, w, p)), dt, su, sv, rod)
        corr = kern.corrector(us_in, vs_in, torch.tensor(xin), s)
    else:
        c = StencilConsts(1, ny, nx, jg.dx0, jg.dy0, 0.0, jg.xmin, jg.ymin,
                          NU, True)
        stars = pk2.predictor_star_2d(*map(torch.tensor, (u, v, w)),
                                      torch.stack([dt, su, sv]), c)
        pred = stars + (pk2.poisson_input_2d(stars[0], stars[1],
                                             torch.tensor(p), rod, c),)
        corr = pk2.corrector_2d(us_in, vs_in, torch.tensor(xin), s, c)
    return ref_pred, pred, ref_corr, corr


@pytest.mark.parametrize("ny,nx,dst", [(32, 128, False), (32, 1024, True)],
                         ids=["128x32", "1024x32_dst"])
def test_kernels_match_reference(ny, nx, dst):
    """u*, v*, w* and the corrected u, v within atol 2e-5 (the reference's
    fused-vs-plain bar, `test_mega_kernels.py:57-60`; the sources' sin
    differs by ulps); b̃ within 1e-6 of max|b̃| (same operation order, the
    ρ/dt = 1000 scale amplifies u* rounding); the x-DST outputs (b̃·FxT,
    p = x̂·GxT) within 2e-5 of their max (a 1022-term fp32 sum in another
    order)."""
    ref_pred, pred, ref_corr, corr = _kernel_case(ny, nx, dst, seed=11)
    for name, a, b in zip(("u*", "v*", "w*"), pred[:3], ref_pred[:3]):
        assert tuple(a.shape) == (1, ny, nx)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=2e-5, err_msg=name)
    bt_ref = np.asarray(ref_pred[3])
    bar = (2e-5 if dst else 1e-6) * np.abs(bt_ref).max()
    np.testing.assert_allclose(pred[3].numpy(), bt_ref, rtol=0, atol=bar,
                               err_msg="b~")
    for name, a, b in zip("uv", corr[:2], ref_corr[:2]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=2e-5, err_msg=name)
    if dst:
        p_ref = np.asarray(ref_corr[2])
        np.testing.assert_allclose(corr[2].numpy(), p_ref, rtol=0,
                                   atol=2e-5 * np.abs(p_ref).max(),
                                   err_msg="p")


# ---- the step ------------------------------------------------------------------

def _run_both(shape, np_dt, jnp_kwargs, dt=DT, n_steps=3, seed=0):
    _, ny, nx = shape
    params = dict(source_amplitude_u=0.1, source_amplitude_v=0.05)
    arrays = _random_numpy_field(shape, seed, np_dt)
    jdt = jnp.float32 if np_dt == np.float32 else jnp.float64
    tdt = torch.float32 if np_dt == np.float32 else torch.float64

    jstep = jax.jit(j_make_step(JGrid.uniform(nx, ny), JParams(**params),
                                dtype=jdt, poisson_method=JMethod.FFT_DIRECT,
                                **jnp_kwargs))
    jf = JField(**{n: jnp.asarray(a) for n, a in arrays.items()})
    step = make_projection_step(Grid.uniform(nx, ny), NSParams(**params),
                                dtype=tdt, device="cpu")
    tf = field_from_numpy(arrays, "cpu", tdt)
    out = []
    for i in range(n_steps):
        jf, jr = jstep(jf, dt, i)
        tf, tr = step(tf, dt, i)
        out.append((jf, jr, tf, tr))
    return out


@pytest.fixture(scope="module")
def fused_128x32():
    return _run_both((1, 32, 128), np.float32,
                     dict(use_pallas=True, pallas_interpret=True))


@pytest.fixture(scope="module")
def fused_1024x32():
    # dt under the convective limit of the 1/1023 spacing: at 1e-3 the
    # random field runs into the ±100 clamps and the chaotic trajectory
    # magnifies f32 rounding (as `test_dst2d_fused_multi_step_buoyant`
    # notes for the reference).  The reference's float64 jnp step rides
    # along as the exact solution.
    fused = _run_both((1, 32, 1024), np.float32,
                      dict(use_pallas=True, pallas_interpret=True), dt=1e-4)
    exact = _run_both((1, 32, 1024), np.float64, dict(use_pallas=False),
                      dt=1e-4)
    return [f + (e[0],) for f, e in zip(fused, exact)]


@pytest.fixture(scope="module")
def jnp_f64():
    return _run_both((1, 24, 200), np.float64, dict(use_pallas=False))


def _assert_close(case, k, atol, rtol_diag):
    jf, jr, tf, tr = case[k]
    assert int(jr.status) == int(tr.status) == 0
    for n in FIELDS:
        np.testing.assert_allclose(getattr(tf, n).numpy(),
                                   np.array(getattr(jf, n)), rtol=0,
                                   atol=atol, err_msg=n)
    for d in DIAGS:
        np.testing.assert_allclose(float(getattr(tr, d)),
                                   float(getattr(jr, d)), rtol=rtol_diag,
                                   err_msg=d)


@pytest.mark.parametrize("k", [0, 1, 2])
def test_step_matches_fused_reference_128x32(fused_128x32, k):
    """Fields within atol 1e-5 (the bar of `test_fused2d_matches_jnp`) and
    diagnostics within rtol 1e-6 of the reference's fused 2D step after
    each of 3 steps, sources on.  The port rescues every mode here
    (K == mx): the whole y-solve is dense."""
    _assert_close(fused_128x32, k, 1e-5, 1e-6)


@pytest.mark.parametrize("k", [0, 1, 2])
def test_step_matches_fused_reference_1024x32(fused_1024x32, k):
    """Against the reference's DST-fused 2D form (in-kernel x-DSTs, Thomas
    y-lines + rescue of the 128 lowest modes): u, v, w within atol 1e-5,
    max|u| and max T within rtol 1e-6.  p cannot meet atol 1e-5 between
    two independent float32 solves here: at dx = 1/1023 the b̃ face
    coefficient is 1e6, and every float32 form (the reference's jnp and
    fused steps, and the port) lands about 1.5e-4 from the float64
    solution, in the smooth low modes.  So p is held to the reference's
    own accuracy: no further from the reference's float64 jnp step than
    1.5× the fused reference's distance, which also bounds max p."""
    jf, jr, tf, tr, exact = fused_1024x32[k]
    assert int(jr.status) == int(tr.status) == 0
    for n in ("u", "v", "w"):
        np.testing.assert_allclose(getattr(tf, n).numpy(),
                                   np.array(getattr(jf, n)), rtol=0,
                                   atol=1e-5, err_msg=n)
    for d in ("max_velocity", "max_temperature"):
        np.testing.assert_allclose(float(getattr(tr, d)),
                                   float(getattr(jr, d)), rtol=1e-6,
                                   err_msg=d)
    p64 = np.array(exact.p)
    ref_err = np.abs(np.array(jf.p) - p64).max()
    assert np.abs(tf.p.numpy() - p64).max() <= 1.5 * ref_err
    assert abs(float(tr.max_pressure) - p64.max()) <= 1.5 * ref_err


@pytest.mark.parametrize("k", [0, 1, 2])
def test_step_matches_jnp_step_f64(jnp_f64, k):
    """At 200×24 (no reference kernel gate holds; K = 128 < mx = 198) the
    port's x-DST + Thomas + rescue step matches the reference's jnp step
    with its eigen solve, float64: atol 1e-10 on the fields, rtol 1e-12 on
    the diagnostics."""
    _assert_close(jnp_f64, k, 1e-10, 1e-12)


@pytest.mark.parametrize("number,grows", [(3.3522, True), (1.885, False)],
                         ids=["2048sq_number", "1536sq_number"])
def test_taylor_green_viscous_limit_matches_jnp_step_f64(number, grows):
    """`bench.py:run_2d`'s Taylor-Green start at 160², with ν and dt scaled
    so that dt/dx and the diffusion number 8·ν·dt/dx² are those of
    `run_2d(2048)` (3.3522, past the explicit limit 2) or of
    `run_2d(1536)` (1.885, inside it).  Past the limit the reference's
    float64 jnp step grows a grid-scale mode by ~2.1× a step (the
    checkerboard factor |1 − 3.35| less the projection's damping) and the
    port grows it identically: fields within 1e-9·max|u| after 20 steps,
    where the rounding differences have been amplified ~1e6×.  Inside the
    limit neither grows."""
    n, steps = 160, 20
    dx = 1.0 / (n - 1)
    dt = 1e-5 * 2047.0 / (n - 1)
    kw = dict(source_amplitude_u=0.0, source_amplitude_v=0.0,
              mu=number * dx * dx / (8.0 * dt))
    lin = np.linspace(0.0, 1.0, n)
    u = (np.sin(2 * np.pi * lin)[None, :]
         * np.cos(2 * np.pi * lin)[:, None])[None]
    arrays = dict(u=u, v=-u, w=np.zeros_like(u), p=np.ones_like(u),
                  rho=np.ones_like(u), T=np.full_like(u, 300.0))
    jstep = jax.jit(j_make_step(JGrid.uniform(n, n), JParams(**kw),
                                dtype=jnp.float64,
                                poisson_method=JMethod.FFT_DIRECT,
                                use_pallas=False))
    jf = JField(**{k: jnp.asarray(a) for k, a in arrays.items()})
    step = make_projection_step(Grid.uniform(n, n), NSParams(**kw),
                                dtype=torch.float64, device="cpu")
    tf = field_from_numpy(arrays, "cpu", torch.float64)
    for i in range(steps):
        jf, jr = jstep(jf, dt, i)
        tf, tr = step(tf, dt, i)
    assert int(jr.status) == int(tr.status) == 0
    ju = np.asarray(jf.u)
    assert (np.abs(ju).max() > 10.0) == grows
    for k in ("u", "v", "p"):
        np.testing.assert_allclose(getattr(tf, k).numpy(),
                                   np.asarray(getattr(jf, k)), rtol=0,
                                   atol=1e-9 * np.abs(ju).max(), err_msg=k)


def _step_128x32(sources=False):
    amp = dict(source_amplitude_u=0.0, source_amplitude_v=0.0)
    return make_projection_step(Grid.uniform(128, 32),
                                NSParams(**({} if sources else amp)),
                                dtype=torch.float32, device="cpu")


def test_shell_passthrough_and_clamp():
    """Caller-set boundary values survive the step (save/restore idiom)
    and interior velocities are clamped at ±100 (as
    `test_fused2d_shell_passthrough_and_clamp` holds the reference)."""
    arrays = _random_numpy_field((1, 32, 128), 4, np.float32, amp=0.2)
    u = arrays["u"]
    u[0, 0, :], u[0, -1, :] = 7.0, -3.0
    u[0, :, 0], u[0, :, -1] = 2.5, 1.5
    u[0, 0, 0], u[0, -1, -1] = 7.0, -3.0
    arrays["v"] *= 4000.0          # huge v: the interior clamps engage
    out, res = _step_128x32()(field_from_numpy(arrays, "cpu", torch.float32),
                              0.01, 0)
    u = out.u.numpy()
    np.testing.assert_array_equal(u[0, 0, 1:-1], 7.0)
    np.testing.assert_array_equal(u[0, -1, 1:-1], -3.0)
    np.testing.assert_array_equal(u[0, 1:-1, 0], 2.5)
    np.testing.assert_array_equal(u[0, 1:-1, -1], 1.5)
    assert float(out.v[0, 1:-1, 1:-1].abs().max()) == 100.0
    assert int(res.status) == 0


@pytest.mark.nan_injection
@pytest.mark.parametrize("where", [(0, 0, 5), (0, 5, 5)],
                         ids=["shell_row", "interior"])
def test_nan_gives_diverged(where):
    """A NaN on a y-shell row or in the interior survives the clamps:
    status −6 (DIVERGED)."""
    arrays = _random_numpy_field((1, 32, 128), 6, np.float32)
    arrays["u"][where] = np.nan
    _, res = _step_128x32()(field_from_numpy(arrays, "cpu", torch.float32),
                            0.001, 0)
    assert int(res.status) == -6
    assert bool(res.diverged)


def test_w_is_predicted():
    """In 2D w is convected and diffused (`projection2d.py:176`), not
    copied: a nonzero w changes over a step and its shells pass
    through."""
    arrays = _random_numpy_field((1, 32, 128), 8, np.float32)
    f = field_from_numpy(arrays, "cpu", torch.float32)
    out, _ = _step_128x32(sources=True)(f, 0.001, 0)
    assert not torch.equal(out.w[0, 1:-1, 1:-1], f.w[0, 1:-1, 1:-1])
    assert torch.equal(out.w[0, 0], f.w[0, 0])


# ---- state, BCs and the cavity -------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_field_numpy_round_trip_2d(dtype):
    """(1, ny, nx) state crosses to numpy and back unchanged."""
    arrays = _random_numpy_field((1, 7, 9), 2, np.float64)
    f = field_from_numpy(arrays, "cpu", dtype)
    assert f.shape == (1, 7, 9) and f.dtype == dtype
    back = field_to_numpy(f)
    for n, a in arrays.items():
        assert back[n].shape == (1, 7, 9)
        np.testing.assert_array_equal(back[n], a.astype(back[n].dtype))


def test_quiescent_matches_reference():
    tf = FlowField.quiescent(9, 7, pressure=0.0, dtype=torch.float64,
                             device="cpu")
    jf = JField.quiescent(9, 7, pressure=0.0, dtype=jnp.float64)
    for n in ("u", "v", "w", "p", "rho", "T"):
        np.testing.assert_array_equal(getattr(tf, n).numpy(),
                                      np.asarray(getattr(jf, n)), err_msg=n)


@pytest.mark.parametrize("shape", [(1, 6, 7), (6, 7), (4, 5, 6)],
                         ids=["2d", "raw_2d", "3d"])
def test_scalar_bcs_match_reference(shape):
    """apply_dirichlet_scalar and apply_neumann_scalar equal the
    reference's, corners included (face order x, y, z), and leave their
    input unchanged."""
    a = np.random.default_rng(9).normal(size=shape)
    t = torch.tensor(a)
    vals = dict(left=1.0, right=2.0, top=3.0, bottom=4.0, front=5.0,
                back=6.0)
    got = apply_dirichlet_scalar(t, DirichletValues(**vals))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(j_dirichlet(jnp.asarray(a),
                                            JDirichlet(**vals))))
    np.testing.assert_array_equal(
        apply_neumann_scalar(t).numpy(),
        np.asarray(j_neumann(jnp.asarray(a))))
    assert got.shape == t.shape
    np.testing.assert_array_equal(t.numpy(), a)


def test_ghia_re100_projection():
    """Lid cavity, Re = 100 at 33², 3000 steps of dt = 5e-4 from rest,
    float32, FFT_DIRECT; each step first applies the cavity BCs (the
    loop of `tests/validation/harness.py:49-56`).  Centerline RMS against
    Ghia's table below 0.10 on u and v, the bar of
    `test_ghia_re100_projection`."""
    from tests.validation import ghia_data

    n, re, dt, steps = 33, 100, 5e-4, 3000
    grid = Grid.uniform(n, n)
    params = NSParams(dt=dt, cfl=0.5, mu=1.0 / re, k=0.0, max_iter=1,
                      source_amplitude_u=0.0, source_amplitude_v=0.0,
                      source_decay_rate=0.0)
    step = make_projection_step(grid, params, dtype=torch.float32,
                                device="cpu")
    lid, wall = DirichletValues(top=1.0), DirichletValues()
    field = FlowField.quiescent(n, n, pressure=0.0, dtype=torch.float32,
                                device="cpu")
    worst = 0
    for i in range(steps):
        field = field.replace(u=apply_dirichlet_scalar(field.u, lid),
                              v=apply_dirichlet_scalar(field.v, wall),
                              p=apply_neumann_scalar(field.p))
        field, res = step(field, dt, i)
        worst = max(worst, abs(int(res.status)))
    assert worst == 0
    u, v = field.u[0].numpy(), field.v[0].numpy()
    rms_u = ghia_data.profile_rms_error(grid.y, u[:, n // 2],
                                        ghia_data.Y_COORDS,
                                        ghia_data.U_TABLES[re])
    rms_v = ghia_data.profile_rms_error(grid.x, v[n // 2, :],
                                        ghia_data.X_COORDS,
                                        ghia_data.V_TABLES[re])
    assert rms_u < 0.10, f"u-centerline RMS {rms_u:.4f} >= 0.10"
    assert rms_v < 0.10, f"v-centerline RMS {rms_v:.4f} >= 0.10"


def test_run_steps_2d():
    """run_steps drives the 2D step like the 3D one (no host reads)."""
    step = _step_128x32(sources=True)
    f = field_from_numpy(_random_numpy_field((1, 32, 128), 5, np.float32),
                         "cpu", torch.float32)
    a, ra = run_steps(step, f, 0.001, 2, start_iter=3)
    b, _ = step(f, 0.001, 3)
    b, rb = step(b, 0.001, 4)
    for n in FIELDS:
        assert torch.equal(getattr(a, n), getattr(b, n))
    assert torch.equal(ra.max_pressure, rb.max_pressure)
