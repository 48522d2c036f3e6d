"""The port's projection step against the reference's: 3 steps against the
fused Pallas step (interpret mode, float32, 128×16×8, sources on) and 3
steps against the jnp step (float64, 24×20×10, a grid the fused path
rejects), plus divergence detection and the shell-extremum diagnostics
(as `tests/math/test_mega_kernels.py:69-98` holds the reference to).
"""

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
from cfd_tpu_torch.entry import entry
from cfd_tpu_torch.interop import field_from_numpy, field_to_numpy
from cfd_tpu_torch.solvers.ns.common import field_status_and_diagnostics
from cfd_tpu_torch.solvers.ns.params import NSParams
from cfd_tpu_torch.solvers.ns.projection import make_projection_step
from cfd_tpu_torch.solvers.ns.rollout import run_steps

torch.set_num_threads(min(2, torch.get_num_threads()))

NAMES = ("u", "v", "w", "p", "rho", "T")
DIAGS = ("max_velocity", "max_pressure", "max_temperature")


def _random_numpy_field(shape, seed, np_dt, amp=0.1):
    rng = np.random.default_rng(seed)
    out = {n: rng.normal(0.0, amp, shape).astype(np_dt)
           for n in ("u", "v", "w", "p")}
    out["rho"] = np.ones(shape, np_dt)
    out["T"] = np.full(shape, 300.0, np_dt)
    return out


def _run_both(shape, np_dt, jnp_kwargs, n_steps=3, seed=0):
    nz, ny, nx = shape
    params = dict(source_amplitude_u=0.1, source_amplitude_v=0.05)
    arrays = _random_numpy_field(shape, seed, np_dt)
    jdt = jnp.float32 if np_dt == np.float32 else jnp.float64
    tdt = torch.float32 if np_dt == np.float32 else torch.float64

    jstep = jax.jit(j_make_step(
        JGrid.uniform(nx, ny, nz, zmin=0.0, zmax=1.0), JParams(**params),
        dtype=jdt, poisson_method=JMethod.FFT_DIRECT, **jnp_kwargs))
    jf = JField(**{n: jnp.asarray(a) for n, a in arrays.items()})
    step = make_projection_step(Grid.uniform(nx, ny, nz, zmin=0.0,
                                             zmax=1.0),
                                NSParams(**params), dtype=tdt,
                                device="cpu")
    tf = field_from_numpy(arrays, "cpu", tdt)
    out = []
    for i in range(n_steps):
        jf, jr = jstep(jf, 0.001, i)
        tf, tr = step(tf, 0.001, i)
        out.append((jf, jr, tf, tr))
    return out


@pytest.fixture(scope="module")
def fused_f32():
    return _run_both((8, 16, 128), np.float32,
                     dict(use_pallas=True, pallas_interpret=True))


@pytest.fixture(scope="module")
def jnp_f64():
    return _run_both((10, 20, 24), np.float64, dict(use_pallas=False))


@pytest.mark.parametrize("k", [0, 1, 2])
def test_step_matches_fused_reference_f32(fused_f32, k):
    """Fields within atol 2e-5 and diagnostics within rtol 1e-6 of the
    reference's fused step after each of 3 steps — the reference's own
    fused-vs-jnp bars (`test_mega_kernels.py:57-66`)."""
    jf, jr, tf, tr = fused_f32[k]
    assert int(jr.status) == int(tr.status) == 0
    for n in ("u", "v", "w", "p"):
        np.testing.assert_allclose(getattr(tf, n).numpy(),
                                   np.array(getattr(jf, n)), rtol=0,
                                   atol=2e-5, err_msg=n)
    for d in DIAGS:
        np.testing.assert_allclose(float(getattr(tr, d)),
                                   float(getattr(jr, d)), rtol=1e-6,
                                   err_msg=d)


@pytest.mark.parametrize("k", [0, 1, 2])
def test_step_matches_jnp_step_f64(jnp_f64, k):
    """At 24×20×10 (no kernel gate holds) the port's DST + Thomas step
    matches the reference's jnp step with its all-DST eigen solve, float64:
    two exact solves of one system, so agreement to rounding — atol 1e-10
    on fields of unit scale, rtol 1e-12 on the diagnostics."""
    jf, jr, tf, tr = jnp_f64[k]
    assert int(jr.status) == int(tr.status) == 0
    for n in ("u", "v", "w", "p"):
        np.testing.assert_allclose(getattr(tf, n).numpy(),
                                   np.array(getattr(jf, n)), rtol=0,
                                   atol=1e-10, err_msg=n)
    for d in DIAGS:
        np.testing.assert_allclose(float(getattr(tr, d)),
                                   float(getattr(jr, d)), rtol=1e-12,
                                   err_msg=d)


def test_fused_diagnostics_equal_full_field(jnp_f64):
    """The kernel maxima (planes 1..nz−2) plus the two z-shell faces give
    exactly the full-field diagnostics of the output field."""
    _, _, tf, tr = jnp_f64[-1]
    finite, vmax, pmax, tmax = field_status_and_diagnostics(tf)
    assert bool(finite)
    assert float(tr.max_velocity) == float(vmax)
    assert float(tr.max_pressure) == float(pmax)
    assert float(tr.max_temperature) == float(tmax)


def _default_step(shape=(8, 16, 128)):
    nz, ny, nx = shape
    grid = Grid.uniform(nx, ny, nz, zmin=0.0, zmax=1.0)
    params = NSParams(source_amplitude_u=0.0, source_amplitude_v=0.0)
    return make_projection_step(grid, params, dtype=torch.float32,
                                device="cpu")


@pytest.mark.nan_injection
@pytest.mark.parametrize("where", [(0, 5, 5), (4, 5, 5)],
                         ids=["shell_plane", "interior"])
def test_nan_gives_diverged(where):
    """A NaN on a z-shell plane or in the interior survives the clamps and
    maxima: status −6 (DIVERGED)."""
    arrays = _random_numpy_field((8, 16, 128), 4, np.float32)
    arrays["u"][where] = np.nan
    _, res = _default_step()(field_from_numpy(arrays, "cpu", torch.float32),
                             0.001, 0)
    assert int(res.status) == -6
    assert bool(res.diverged)


def test_shell_extremum_reported():
    """A velocity extremum on the z = 0 shell plane is reported (the
    kernel maxima skip shell planes; the step folds in the faces)."""
    arrays = _random_numpy_field((8, 16, 128), 3, np.float32)
    arrays["u"][0] = 9.0
    _, res = _default_step()(field_from_numpy(arrays, "cpu", torch.float32),
                             0.001, 0)
    assert int(res.status) == 0
    assert float(res.max_velocity) >= 9.0


def test_entry_runs_three_steps():
    """entry(device) builds the main path at 128×64×16; three steps on the
    CPU keep status 0 and finite fields, and the scalars stay tensors."""
    step, (field, dt, it) = entry("cpu")
    field, res = run_steps(step, field, dt, 3, start_iter=it)
    assert torch.is_tensor(res.status) and res.status.dim() == 0
    assert int(res.status) == 0 and bool(field.is_finite())
    assert field_to_numpy(field)["u"].shape == (16, 64, 128)


def test_run_steps_equals_manual_loop():
    step = _default_step()
    arrays = _random_numpy_field((8, 16, 128), 5, np.float32)
    f = field_from_numpy(arrays, "cpu", torch.float32)
    a, ra = run_steps(step, f, 0.001, 2, start_iter=3)
    b, _ = step(f, 0.001, 3)
    b, rb = step(b, 0.001, 4)
    for n in NAMES:
        assert torch.equal(getattr(a, n), getattr(b, n))
    assert torch.equal(ra.max_pressure, rb.max_pressure)
