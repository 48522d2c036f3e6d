"""The 2D projection step with ``bc_refresh`` against the reference's:
the reference's own cases (`tests/math/test_bc_refresh_fused.py:67-99`) —
128×32 with the time-dependent lid hook, FFT_DIRECT and CG, two steps,
and 1024×32 FFT_DIRECT, one step — in float32 against the reference's
fused split-kernel step (interpret mode), 2e-5; the same in float64
against its jnp step within 1e-9; and the pulsatile-inlet channel of
`examples/pulsatile_inlet_flow.py` (sinusoidal inlet, no-slip walls,
zero-gradient outlet, the same BCs as the hook) in float64 against the
reference's jnp step.  Helpers in `test_torch_bc_refresh.py`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cfd_tpu.boundary as jb
import cfd_tpu_torch.boundary as tb
from cfd_tpu import Grid as JGrid
from cfd_tpu.solvers.ns import NSParams as JParams
from cfd_tpu.solvers.ns.projection import make_projection_step as jmk
from cfd_tpu_torch import Grid
from cfd_tpu_torch.solvers.ns.params import NSParams
from cfd_tpu_torch.solvers.ns.projection import make_projection_step
from cfd_tpu_torch.solvers.poisson.base import Method
from tests.test_torch_bc_refresh import (assert_fields, check_fused,
                                         check_jnp, run_pair)

torch.set_num_threads(min(2, torch.get_num_threads()))


@pytest.mark.parametrize("case", ["2d_fft", "2d_cg"])
def test_matches_fused_reference_f32(case):
    check_fused(case)


def test_1024_matches_fused_reference_f32():
    """At nx = 1024 the reference's split path keeps its in-kernel DST
    (`test_bc_refresh_fused.py:84-99`); one step.  u, v, w within 2e-5.
    p cannot meet 2e-5 between two float32 solves at dx = 1/1023 (every
    float32 form lands ~1e-4 from the float64 p, `test_torch_projection2d.
    py::test_step_matches_fused_reference_1024x32`), so p is held to the
    reference's own accuracy: no further from its float64 jnp step than
    1.5× the fused reference's distance."""
    shape, method = (1, 32, 1024), Method.FFT_DIRECT
    jf, jr, tf, tr = run_pair(shape, method, np.float32, True, steps=1)
    exact = run_pair(shape, method, np.float64, False, steps=1)[0]
    assert_fields(jf, tf, 2e-5, names="uvw")
    p64 = np.asarray(exact.p)
    ref_err = np.abs(np.asarray(jf.p) - p64).max()
    assert np.abs(tf.p.numpy() - p64).max() <= 1.5 * ref_err
    assert abs(float(tr.max_pressure) - p64.max()) <= 1.5 * ref_err


@pytest.mark.parametrize("method", [Method.FFT_DIRECT, Method.CG],
                         ids=["fft", "cg"])
def test_matches_jnp_reference_f64(method):
    check_jnp((1, 24, 40), method)


def _channel_bcs(m, dt):
    """The example's BC application as a hook: no-slip walls, the
    sinusoidal inlet at t, the zero-gradient outlet."""
    inlet = m.InletConfig.time_sinusoidal(1.0, 0.0, frequency=2.0,
                                          amplitude=0.5, phase=0.0,
                                          offset=1.0)
    outlet = m.OutletConfig.zero_gradient()

    def hook(u, v, w, t):
        u, v = m.apply_noslip(u, v)
        u, v = m.apply_inlet(u, v, inlet, time=t, dt=dt)
        u, v = m.apply_outlet_velocity(u, v, outlet)
        return u, v, w

    return hook


def test_pulsatile_channel_matches_jnp_reference_f64():
    """10 steps of the 64×32 channel (ν = 0.05, dt = 1e-3) with the BCs
    applied before each step and as the hook, CG as the example: within
    1e-9 (p 1e-6, the solve's tolerance) of the reference."""
    dt = 1e-3
    params = dict(dt=dt, mu=0.05, max_iter=1, source_amplitude_u=0.0,
                  source_amplitude_v=0.0)
    jf, jr, tf, tr = run_pair(
        (1, 32, 64), Method.CG, np.float64, False, steps=1,
        j_hook=_channel_bcs(jb, dt), t_hook=_channel_bcs(tb, dt),
        jparams=JParams(**params), tparams=NSParams(**params))
    assert_fields(jf, tf, 1e-9, 1e-6)
    # then the example's loop: BCs at t = i·dt before each step
    jstep = jax.jit(jmk(JGrid.uniform(64, 32, xmin=0.0, xmax=2.0),
                        JParams(**params), dtype=jnp.float64,
                        use_pallas=False, bc_refresh=_channel_bcs(jb, dt)))
    tstep = make_projection_step(Grid.uniform(64, 32, xmin=0.0, xmax=2.0),
                                 NSParams(**params), torch.float64,
                                 device="cpu",
                                 bc_refresh=_channel_bcs(tb, dt))
    jhook, thook = _channel_bcs(jb, dt), _channel_bcs(tb, dt)
    for i in range(10):
        u, v, w = jhook(jf.u, jf.v, jf.w, i * dt)
        jf, jr = jstep(jf.replace(u=u, v=v), dt, i)
        u, v, w = thook(tf.u, tf.v, tf.w, torch.tensor(i * dt,
                                                       dtype=torch.float64))
        tf, tr = tstep(tf.replace(u=u, v=v), dt, i)
        assert int(jr.status) == int(tr.status) == 0
    assert_fields(jf, tf, 1e-9, 1e-6)
