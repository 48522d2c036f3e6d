"""The 3D spectral projection step with ``bc_refresh`` against the
reference's: the reference's own case (`tests/math/
test_bc_refresh_fused.py:67-113`) — 128×16×8 with the time-dependent lid
hook, FFT_DIRECT at HIGHEST and HIGH — in float32 against the reference's
fused step (interpret mode) after two steps, at its bars (2e-5; HIGH the
reference's HIGH bars, 2e-3 on p and 1e-4 on u, v, w), and in float64
against its jnp step within 1e-9; and what the hook sees.  Both packages
get the same numpy inputs; the hook is the same function written once for
each.  The CG and nz = 3 cases are in `test_torch_bc_refresh_cg_nz3.py`,
the 2D ones in `test_torch_bc_refresh_2d.py`, on these helpers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_tpu import FlowField as JField
from cfd_tpu import Grid as JGrid
from cfd_tpu.solvers.ns import NSParams as JParams
from cfd_tpu.solvers.ns.projection import \
    make_projection_step as j_make_step
from cfd_tpu.solvers.poisson.base import Method as JMethod
from cfd_tpu_torch import Grid
from cfd_tpu_torch.interop import field_from_numpy, field_to_numpy
from cfd_tpu_torch.solvers.ns.params import NSParams
from cfd_tpu_torch.solvers.ns.projection import make_projection_step
from cfd_tpu_torch.solvers.poisson.base import Method

torch.set_num_threads(min(2, torch.get_num_threads()))

PARAMS = dict(mu=0.01, source_amplitude_u=0.0, source_amplitude_v=0.0)
DIAGS = ("max_velocity", "max_pressure", "max_temperature")


def j_lid(u, v, w, t):
    """The reference test's time-dependent driven-lid refresh."""
    lid = 0.5 + 0.1 * jnp.sin(3.0 * t)
    u = u.at[:, 0, :].set(0.0).at[:, -1, :].set(lid)
    v = v.at[:, 0, :].set(0.0).at[:, -1, :].set(0.0)
    return u, v, w


def t_lid(u, v, w, t):
    """The same hook on tensors; ``t`` is a 0-d tensor."""
    u, v = u.clone(), v.clone()
    u[:, 0, :] = 0.0
    u[:, -1, :] = 0.5 + 0.1 * torch.sin(3.0 * t)
    v[:, 0, :] = 0.0
    v[:, -1, :] = 0.0
    return u, v, w


def _arrays(shape, seed, np_dt, amp=0.1):
    rng = np.random.default_rng(seed)
    out = {n: rng.normal(0.0, amp, shape).astype(np_dt) for n in "uvwp"}
    out["rho"] = np.ones(shape, np_dt)
    out["T"] = np.full(shape, 300.0, np_dt)
    return out


def _grids(shape):
    nz, ny, nx = shape
    kw = dict(zmin=0.0, zmax=1.0) if nz > 1 else {}
    return JGrid.uniform(nx, ny, nz, **kw), Grid.uniform(nx, ny, nz, **kw)


def run_pair(shape, method, np_dt, fused, precision=None, steps=2, seed=3,
             j_hook=j_lid, t_hook=t_lid, jparams=None, tparams=None):
    """``steps`` steps of both packages from the same fields: the
    reference fused (interpret mode) or jnp, the port on the CPU."""
    jg, tg = _grids(shape)
    jdt = jnp.float32 if np_dt == np.float32 else jnp.float64
    tdt = torch.float32 if np_dt == np.float32 else torch.float64
    jkw = dict(use_pallas=True, pallas_interpret=True) if fused else dict(
        use_pallas=False)
    if precision == "high":
        jkw["spectral_precision"] = jax.lax.Precision.HIGH
    jstep = jax.jit(j_make_step(jg, jparams or JParams(**PARAMS), dtype=jdt,
                                poisson_method=JMethod[method.name],
                                bc_refresh=j_hook, **jkw))
    tstep = make_projection_step(tg, tparams or NSParams(**PARAMS),
                                 dtype=tdt, poisson_method=method,
                                 device="cpu", spectral_precision=precision,
                                 bc_refresh=t_hook)
    a = _arrays(shape, seed, np_dt)
    jf = JField(**{n: jnp.asarray(x) for n, x in a.items()})
    tf = field_from_numpy(a, "cpu", tdt)
    for i in range(steps):
        jf, jr = jstep(jf, 1e-3, i)
        tf, tr = tstep(tf, 1e-3, i)
        assert int(jr.status) == int(tr.status) == 0
    return jf, jr, tf, tr


def assert_fields(jf, tf, atol, p_atol=None, names="uvwp"):
    out = field_to_numpy(tf)
    for n in names:
        np.testing.assert_allclose(
            out[n], np.asarray(getattr(jf, n)), rtol=0,
            atol=p_atol if (n == "p" and p_atol is not None) else atol,
            err_msg=n)


FUSED = {
    "fft_highest": ((8, 16, 128), Method.FFT_DIRECT, None, 2e-5, 2e-5),
    "fft_high": ((8, 16, 128), Method.FFT_DIRECT, "high", 1e-4, 2e-3),
    "cg": ((8, 16, 128), Method.CG, None, 2e-5, 2e-5),
    "fft_nz3": ((3, 16, 128), Method.FFT_DIRECT, None, 2e-5, 2e-5),
    "2d_fft": ((1, 32, 128), Method.FFT_DIRECT, None, 2e-5, 2e-5),
    "2d_cg": ((1, 32, 128), Method.CG, None, 2e-5, 2e-5),
}


def check_fused(case, steps=2):
    """``steps`` steps with the lid hook against the reference's fused
    step: fields at the reference's fused bars (`test_bc_refresh_fused.py:
    56-63`: 2e-5; HIGH at the HIGH bars), the diagnostics within rtol
    1e-5 (1e-3 for HIGH's max p)."""
    shape, method, precision, atol, p_atol = FUSED[case]
    jf, jr, tf, tr = run_pair(shape, method, np.float32, True, precision,
                              steps=steps)
    assert_fields(jf, tf, atol, p_atol)
    for d in DIAGS:
        rtol = 1e-3 if precision == "high" and d == "max_pressure" \
            else 1e-5
        np.testing.assert_allclose(float(getattr(tr, d)),
                                   float(getattr(jr, d)), rtol=rtol,
                                   err_msg=d)


def check_jnp(shape, method, steps=2):
    """``steps`` steps against the reference's jnp step in float64:
    fields within 1e-9 (p of an iterative solve within 1e-6, its
    tolerance), the diagnostics within rtol 1e-9 (1e-6)."""
    jf, jr, tf, tr = run_pair(shape, method, np.float64, False, steps=steps)
    exact = method == Method.FFT_DIRECT
    assert_fields(jf, tf, 1e-9, 1e-9 if exact else 1e-6)
    for d in DIAGS:
        np.testing.assert_allclose(float(getattr(tr, d)),
                                   float(getattr(jr, d)),
                                   rtol=1e-9 if exact else 1e-6, err_msg=d)


@pytest.mark.parametrize("case", ["fft_highest", "fft_high"])
def test_matches_fused_reference_f32(case):
    check_fused(case)


def test_matches_jnp_reference_f64():
    check_jnp((10, 20, 24), Method.FFT_DIRECT)


def test_hook_sees_predictor_state_at_t_next():
    """The hook gets the predictor's (u*, v*, w*) and t_next = (it + 1)·dt
    as a 0-d tensor; an identity hook leaves the step bit-equal to the
    step without one."""
    _, tg = _grids((8, 16, 128))
    seen = []

    def record(u, v, w, t):
        seen.append((tuple(u.shape), t))
        return u, v, w

    a = _arrays((8, 16, 128), 4, np.float64)
    plain = make_projection_step(tg, NSParams(**PARAMS), torch.float64,
                                 Method.FFT_DIRECT, device="cpu")
    hooked = make_projection_step(tg, NSParams(**PARAMS), torch.float64,
                                  Method.FFT_DIRECT, device="cpu",
                                  bc_refresh=record)
    f0 = field_from_numpy(a, "cpu", torch.float64)
    fp, _ = plain(f0, 2e-3, 4)
    fh, _ = hooked(f0, 2e-3, 4)
    for n in ("u", "v", "w", "p", "T"):
        assert torch.equal(getattr(fp, n), getattr(fh, n)), n
    (shape, t), = seen
    assert shape == (8, 16, 128) and torch.is_tensor(t) and t.dim() == 0
    assert float(t) == pytest.approx(5 * 2e-3, rel=1e-15)


def test_hook_owns_the_shell_after_the_step():
    """What the hook writes on the shell is what the step returns there
    (the corrector passes shells through): the lid value at t_next."""
    _, _, tf, _ = run_pair((10, 20, 24), Method.FFT_DIRECT, np.float64,
                           False, steps=1)
    lid = 0.5 + 0.1 * np.sin(3.0 * 1e-3)
    np.testing.assert_allclose(tf.u[:, -1, :].numpy(), lid, rtol=1e-15)
    assert float(tf.v[:, 0, :].abs().max()) == 0.0
