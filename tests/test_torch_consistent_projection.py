"""The consistent scheme's spectral projection step on a stretched grid
(``nonuniform_scheme="consistent"``, FFT_DIRECT) against the reference's
eigenbasis-fused step in interpret mode, float32, at the reference's own
grid (128×16×8, tanh β = 1.5) and bars
(`tests/math/test_projection_consistent_fused.py`): fields within 5e-5
with and without sources and on an x-only stretch, the diagnostics
within rtol 1e-5, and spectral_precision="high" within 5e-3 of the
HIGHEST step.  Each reference step is built once per module."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_tpu import FlowField as JField
from cfd_tpu import Grid as JGrid
from cfd_tpu.solvers.ns import NSParams as JParams
from cfd_tpu.solvers.ns.projection import make_projection_step as j_step
from cfd_tpu.solvers.poisson.base import Method as JMethod
from cfd_tpu_torch.interop import field_from_numpy, grid_from
from cfd_tpu_torch.ops.kernels import projection_kernels as pkm
from cfd_tpu_torch.solvers.ns.params import NSParams
from cfd_tpu_torch.solvers.ns.projection import make_projection_step
from cfd_tpu_torch.solvers.poisson.base import Method

torch.set_num_threads(min(2, torch.get_num_threads()))

NZ, NY, NX = 8, 16, 128
ATOL = 5e-5
DIAGS = ("max_velocity", "max_pressure")


def _arrays(seed, amp=0.1):
    rng = np.random.default_rng(seed)
    out = {n: rng.normal(0.0, amp, (NZ, NY, NX)).astype(np.float32)
           for n in ("u", "v", "w", "p")}
    out["rho"] = np.ones((NZ, NY, NX), np.float32)
    out["T"] = np.full((NZ, NY, NX), 300.0, np.float32)
    return out


def run_pair(axes="xy", sources=True, seed=3, method=JMethod.FFT_DIRECT,
             precision=None):
    """One step of the reference's fused interpret step and of the
    port's step (CPU, float32) from the same numpy field."""
    jg = JGrid.stretched(NX, NY, NZ, zmin=0.0, zmax=1.0, beta=1.5,
                         stretch_axes=axes)
    amp = 0.5 if sources else 0.0
    kw = dict(nonuniform_scheme="consistent", source_amplitude_u=amp,
              source_amplitude_v=amp / 2)
    arrays = _arrays(seed)
    jstep = jax.jit(j_step(jg, JParams(**kw), dtype=jnp.float32,
                           poisson_method=method, use_pallas=True,
                           pallas_interpret=True))
    jf, jr = jstep(JField(**{n: jnp.asarray(a) for n, a in arrays.items()}),
                   0.001, 0)
    tstep = make_projection_step(grid_from(jg), NSParams(**kw),
                                 dtype=torch.float32,
                                 poisson_method=Method(int(method)),
                                 device="cpu")
    tf, tr = tstep(field_from_numpy(arrays, "cpu", torch.float32), 0.001,
                   0)
    return dict(jf=jf, jr=jr, tf=tf, tr=tr, grid=grid_from(jg), kw=kw,
                arrays=arrays)


def assert_close(run, names=("u", "v", "w", "p"), atol=ATOL):
    jf, jr, tf, tr = run["jf"], run["jr"], run["tf"], run["tr"]
    assert int(jr.status) == int(tr.status) == 0
    for n in names:
        np.testing.assert_allclose(getattr(tf, n).numpy(),
                                   np.array(getattr(jf, n)), rtol=0,
                                   atol=atol, err_msg=n)
    for d in DIAGS:
        np.testing.assert_allclose(float(getattr(tr, d)),
                                   float(getattr(jr, d)), rtol=1e-5,
                                   atol=atol, err_msg=d)


@pytest.fixture(scope="module")
def fft_sources():
    return run_pair(sources=True, seed=3)


@pytest.fixture(scope="module")
def fft_no_sources():
    return run_pair(sources=False, seed=4)


@pytest.fixture(scope="module")
def fft_x_only():
    return run_pair(axes="x", sources=False, seed=11)


def test_fft_step_with_sources_matches_fused_reference(fft_sources):
    """The sources from the true coordinates (weight row 6), the
    consistent stencils, the nonuniform face weights and the eigenbasis
    products: within 5e-5 of the reference's fused step."""
    assert_close(fft_sources)


def test_fft_step_without_sources_matches_fused_reference(fft_no_sources):
    assert_close(fft_no_sources)


def test_fft_step_x_only_stretch_matches_fused_reference(fft_x_only):
    """Stretched in x only: the y weights are the uniform ones, through
    the same consistent kernels."""
    assert_close(fft_x_only)


def test_fft_step_runs_the_consistent_kernels(fft_no_sources):
    """The consistent instantiations run (their counters tick only on
    CUDA, so here the step's kernel constants are checked: the wrappers
    launch their ``<true>`` instantiations, counted on
    ``consistent_launches``, for constants that carry the weight rows,
    and b̃ needs the face weights of the reference's kernels)."""
    run = fft_no_sources
    g = run["grid"]
    step = make_projection_step(g, NSParams(**run["kw"]),
                                dtype=torch.float32,
                                poisson_method=Method.FFT_DIRECT,
                                device="cpu")
    pk = pkm.ProjectionKernels(
        g.nz, g.ny, g.nx, g.dx0, g.dy0, g.dz0, g.xmin, g.ymin, 0.01,
        emit="rhs", stretch_consistent=(g.dx, g.dy, g.x, g.y))
    assert pk.consistent and pk.consts.consistent
    assert pk.consts.scheme == "consistent"
    assert [r.shape for r in pk.consts.weights] == [(7, g.nx), (7, g.ny)]
    assert pk._star is pkm.predictor_star
    assert pk._corr is pkm.corrector
    assert pk._rhs is pkm.poisson_rhs
    with pytest.raises(ValueError):   # b̃ needs the face weights
        pkm.ProjectionKernels(
            g.nz, g.ny, g.nx, g.dx0, g.dy0, g.dz0, g.xmin, g.ymin, 0.01,
            stretch_consistent=(g.dx, g.dy, g.x, g.y))
    tf, _ = step(field_from_numpy(run["arrays"], "cpu", torch.float32),
                 0.001, 0)
    assert torch.equal(tf.p, run["tf"].p)


@pytest.mark.parametrize("precision", ["high", "highest"])
def test_high_precision_step_within_bar_of_highest(fft_no_sources,
                                                   precision):
    """spectral_precision="high" (3xTF32 products, the analytic back
    substitution) within 5e-3 of the HIGHEST step, the port's and the
    reference's (`test_projection_consistent_fused.py:143-162`)."""
    run = fft_no_sources
    step = make_projection_step(run["grid"], NSParams(**run["kw"]),
                                dtype=torch.float32,
                                poisson_method=Method.FFT_DIRECT,
                                device="cpu", spectral_precision=precision)
    tf, tr = step(field_from_numpy(run["arrays"], "cpu", torch.float32),
                  0.001, 0)
    assert int(tr.status) == 0
    np.testing.assert_allclose(tf.p.numpy(), run["tf"].p.numpy(), rtol=0,
                               atol=5e-3)
    np.testing.assert_allclose(tf.p.numpy(), np.array(run["jf"].p), rtol=0,
                               atol=5e-3)
    if precision == "highest":
        assert torch.equal(tf.p, run["tf"].p)
