"""The parity scheme on a stretched grid (the reference C library's
semantics, `solver_projection.c:72-75`): the projection step runs the
uniform kernels on the first-cell spacings dx0, dy0
(`projection.py:151-152`).  Held against the reference's fused interpret
step, float32, at 128×16×8 (3D) and 128×32 (2D), β = 1.5, at the fused
steps' bar 2e-5, and against its jnp step in float64 with the sources off
within 1e-9.  With the default sources on, the reference's two paths
differ: the fused kernels build sin(πy), sin(2πx) from index-space
coordinates ymin + j·dy0, xmin + i·dx0 (`projection_kernels.py:274-281`),
the jnp body from the true ones (`projection.py:171`, `:745`).  The port
follows the fused kernels; the last test shows both numbers."""

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
from cfd_tpu_torch.solvers.ns.params import NSParams
from cfd_tpu_torch.solvers.ns.projection import make_projection_step
from cfd_tpu_torch.solvers.poisson.base import Method

torch.set_num_threads(min(2, torch.get_num_threads()))

SOURCES = dict(source_amplitude_u=0.5, source_amplitude_v=0.25)
OFF = dict(source_amplitude_u=0.0, source_amplitude_v=0.0)


def _run(shape, np_dt, fused, params, method=Method.FFT_DIRECT, steps=2,
         seed=1):
    nz, ny, nx = shape
    kw = dict(zmin=0.0, zmax=1.0) if nz > 1 else {}
    jg = JGrid.stretched(nx, ny, nz, beta=1.5, stretch_axes="xy", **kw)
    rng = np.random.default_rng(seed)
    arrays = {n: rng.normal(0.0, 0.1, shape).astype(np_dt) for n in "uvwp"}
    arrays["rho"] = np.ones(shape, np_dt)
    arrays["T"] = np.full(shape, 300.0, np_dt)
    jdt = jnp.float32 if np_dt == np.float32 else jnp.float64
    tdt = torch.float32 if np_dt == np.float32 else torch.float64
    jkw = dict(use_pallas=True, pallas_interpret=True) if fused else dict(
        use_pallas=False)
    jstep = jax.jit(j_step(jg, JParams(**params), dtype=jdt,
                           poisson_method=JMethod[method.name], **jkw))
    tstep = make_projection_step(grid_from(jg), NSParams(**params),
                                 dtype=tdt, poisson_method=method,
                                 device="cpu")
    jf = JField(**{n: jnp.asarray(a) for n, a in arrays.items()})
    tf = field_from_numpy(arrays, "cpu", tdt)
    for i in range(steps):
        jf, jr = jstep(jf, 0.001, i)
        tf, tr = tstep(tf, 0.001, i)
        assert int(jr.status) == int(tr.status) == 0
    return {n: (getattr(tf, n).numpy(), np.array(getattr(jf, n)))
            for n in "uvwp"}


def _max_diff(out, names="uvwp"):
    return max(np.abs(a - b).max() for n, (a, b) in out.items()
               if n in names)


@pytest.fixture(scope="module")
def fused_3d():
    return _run((8, 16, 128), np.float32, True, SOURCES)


@pytest.fixture(scope="module")
def fused_2d():
    return _run((1, 32, 128), np.float32, True, SOURCES)


@pytest.mark.parametrize("name", ["u", "v", "w", "p"])
def test_parity_3d_step_matches_fused_reference(fused_3d, name):
    got, ref = fused_3d[name]
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=2e-5 * max(1.0, np.abs(ref).max()))


@pytest.mark.parametrize("name", ["u", "v", "p"])
def test_parity_2d_step_matches_fused_reference(fused_2d, name):
    got, ref = fused_2d[name]
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=2e-5 * max(1.0, np.abs(ref).max()))


@pytest.mark.parametrize("shape,method", [
    ((10, 20, 24), Method.FFT_DIRECT), ((10, 20, 24), Method.CG),
    ((1, 20, 24), Method.FFT_DIRECT), ((1, 20, 24), Method.CG)],
    ids=["fft_3d", "cg_3d", "fft_2d", "cg_2d"])
def test_parity_step_matches_jnp_step_without_sources(shape, method):
    out = _run(shape, np.float64, False, OFF, method)
    assert _max_diff(out) < 1e-9 * max(1.0, max(
        np.abs(b).max() for _, b in out.values()))


def test_source_coordinates_differ_inside_the_reference(fused_3d):
    """With sources on, the port sits on the fused step (index-space
    source coordinates) and off the jnp one (true coordinates), by the
    sources' difference: 2e-5 from the first, above 1e-4 from the
    second, after two steps at dt = 1e-3."""
    to_fused = _max_diff(fused_3d)
    to_jnp = _max_diff(_run((8, 16, 128), np.float32, False, SOURCES),
                       "uvw")
    assert to_fused < 2e-5 * 7.0
    assert to_jnp > 1e-4 > to_fused
