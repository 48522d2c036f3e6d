"""The port's explicit Euler step against the reference's.

* the fused kernel's wrappers (`ops.kernels.euler_kernels.euler_step`,
  `ops.kernels.euler2d.euler2d_step`; their plain versions on CPU
  tensors) against the reference's `make_euler_fused` /
  `make_euler2d_fused` in interpret mode, float32;
* the step against the reference's fused step (interpret mode, float32,
  128×16×8 and 128×32, the reference kernels' gates) within the
  reference's bars — 2e-6 in 3D (`tests/math/test_euler_fused.py:54`),
  1e-6 in 2D — over one and four steps, with the clamps and the ρ guard
  engaged, and NaN injection giving status −6 in both;
* the step against the reference's jnp step (float64) on unaligned grids
  no kernel gate admits, within 1e-10.

Both packages get the same numpy inputs from ``np.random.default_rng``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_tpu import FlowField as JField
from cfd_tpu import Grid as JGrid
from cfd_tpu.boundary.apply import \
    apply_periodic_field as j_apply_periodic_field
from cfd_tpu.ops import stencils as j_stencils
from cfd_tpu.ops.pallas.euler2d import make_euler2d_fused
from cfd_tpu.ops.pallas.euler_kernels import make_euler_fused
from cfd_tpu.solvers.ns import NSParams as JParams
from cfd_tpu.solvers.ns.euler import make_euler_step as j_make_euler_step
from cfd_tpu_torch import Grid
from cfd_tpu_torch.boundary import apply_periodic_field
from cfd_tpu_torch.interop import field_from_numpy, field_to_numpy
from cfd_tpu_torch.ops import stencils as t_stencils
from cfd_tpu_torch.ops.kernels.euler2d import euler2d_step
from cfd_tpu_torch.ops.kernels.euler_kernels import (ExplicitConsts,
                                                     euler_step)
from cfd_tpu_torch.solvers.ns.common import source_basis
from cfd_tpu_torch.solvers.ns.euler import make_euler_step
from cfd_tpu_torch.solvers.ns.params import NSParams

torch.set_num_threads(min(2, torch.get_num_threads()))

NAMES = ("u", "v", "w", "p", "rho", "T")
DIAGS = ("max_velocity", "max_pressure", "max_temperature")
SHAPES = {"3d": (8, 16, 128), "2d": (1, 32, 128)}
BARS = {"3d": 2e-6, "2d": 1e-6}


def _grids(shape):
    nz, ny, nx = shape
    kw = dict(zmin=0.0, zmax=1.0) if nz > 1 else {}
    return JGrid.uniform(nx, ny, nz, **kw), Grid.uniform(nx, ny, nz, **kw)


def _arrays(shape, seed, np_dt, amp=0.3, w_zero=False):
    rng = np.random.default_rng(seed)
    out = {n: rng.normal(0.0, amp, shape).astype(np_dt) for n in "uvwp"}
    if w_zero:
        out["w"] = np.zeros(shape, np_dt)
    out["rho"] = np.ones(shape, np_dt)
    out["T"] = (300.0 + rng.normal(0.0, 1.0, shape)).astype(np_dt)
    return out


def _jfield(arrays):
    return JField(**{n: jnp.asarray(a) for n, a in arrays.items()})


@functools.lru_cache(maxsize=None)
def _fused_reference(dim):
    """The reference's fused step (interpret mode), jitted once."""
    jg, _ = _grids(SHAPES[dim])
    return jax.jit(j_make_euler_step(jg, JParams(), dtype=jnp.float32,
                                     use_pallas=True, pallas_interpret=True))


def _port(dim, params=None):
    _, tg = _grids(SHAPES[dim])
    return make_euler_step(tg, params or NSParams(), dtype=torch.float32,
                           device="cpu")


def _assert_close(tf, tr, jf, jr, atol, names=NAMES):
    out = field_to_numpy(tf)
    for n in names:
        np.testing.assert_allclose(out[n], np.asarray(getattr(jf, n)),
                                   rtol=0, atol=atol, err_msg=n)
    for d in DIAGS:
        np.testing.assert_allclose(float(getattr(tr, d)),
                                   float(getattr(jr, d)), rtol=1e-6,
                                   err_msg=d)
    assert int(tr.status) == int(jr.status)


# ---- stencils and the periodic wrap the plain bodies are built from ---------

STENCILS = ("sx_m", "sx_p", "sy_m", "sy_p", "sz_m", "sz_p",
            "sx_m_periodic_interior", "sx_p_periodic_interior",
            "sy_m_periodic_interior", "sy_p_periodic_interior",
            "sz_m_periodic_interior", "sz_p_periodic_interior")


@pytest.mark.parametrize("shape", [(7, 6, 5), (1, 6, 5)], ids=["3d", "2d"])
@pytest.mark.parametrize("name", STENCILS)
def test_shift_matches_reference(name, shape):
    a = np.random.default_rng(8).normal(size=shape)
    got = getattr(t_stencils, name)(torch.tensor(a))
    np.testing.assert_array_equal(got.numpy(),
                                  getattr(j_stencils, name)(jnp.asarray(a)))


@pytest.mark.parametrize("shape", [(7, 6, 5), (1, 6, 5)], ids=["3d", "2d"])
def test_d2dz2_mask_and_periodic_wrap_match_reference(shape):
    a = np.random.default_rng(9).normal(size=shape)
    np.testing.assert_array_equal(
        t_stencils.d2dz2(torch.tensor(a), 3.0).numpy(),
        j_stencils.d2dz2(jnp.asarray(a), 3.0))
    np.testing.assert_array_equal(
        t_stencils.interior_mask(shape, torch.float64).numpy(),
        j_stencils.interior_mask(shape, jnp.float64))
    arrays = {n: np.random.default_rng(k).normal(size=shape)
              for k, n in enumerate(NAMES)}
    got = field_to_numpy(apply_periodic_field(
        field_from_numpy(arrays, "cpu", torch.float64)))
    ref = j_apply_periodic_field(_jfield(arrays))
    for n in NAMES:
        np.testing.assert_array_equal(got[n], np.asarray(getattr(ref, n)),
                                      err_msg=n)


# ---- the kernel modules ------------------------------------------------------

@pytest.mark.parametrize("dim", ["3d", "2d"])
def test_kernel_matches_reference(dim):
    """The wrapper on CPU tensors against the reference's raw fused
    kernel: the six fields (in 2D the reference leaves the y-face rows of
    p, ρ and T to its step wrapper, so those rows are compared in the
    step tests) and, in 3D, the four maxima."""
    shape = SHAPES[dim]
    nz, ny, nx = shape
    jg, tg = _grids(shape)
    a = _arrays(shape, 1, np.float32)
    cdt, su, sv, t = 5e-5, 0.08, 0.04, 3 * 5e-5
    order = ("u", "v", "w", "p", "T", "rho")
    if dim == "3d":
        fn = make_euler_fused(nz, ny, nx, jg.dx0, jg.dy0, jg.dz0, jg.xmin,
                              jg.ymin, 0.01, 0.1, dtype=jnp.float32,
                              interpret=True)
        ref = fn(jnp.asarray([cdt, su, sv, t], jnp.float32),
                 *(jnp.asarray(a[n]) for n in order))
    else:
        fn = make_euler2d_fused(ny, nx, jg.dx0, jg.dy0, jg.xmin, jg.ymin,
                                0.01, 0.1, dtype=jnp.float32,
                                interpret=True)
        ref = [o[None] for o in fn(jnp.asarray([cdt, su, sv], jnp.float32),
                                   *(jnp.asarray(a[n][0]) for n in order))]
    c = ExplicitConsts(nz, ny, nx, tg.dx0, tg.dy0, tg.dz0, 0.01, 0.1)
    sy, sx = source_basis(tg, torch.float32, "cpu")
    wrapper = euler_step if dim == "3d" else euler2d_step
    got = wrapper(*(torch.tensor(a[n]) for n in order), sy, sx,
                  torch.tensor([cdt, su, sv], dtype=torch.float32), c)
    for k, name in enumerate(("u", "v", "w", "p", "rho", "T")):
        g, r = got[k].numpy(), np.asarray(ref[k])
        if dim == "2d" and name in ("p", "rho", "T"):
            g, r = g[:, 1:-1], r[:, 1:-1]
        np.testing.assert_allclose(g, r, rtol=0, atol=BARS[dim],
                                   err_msg=name)
    if dim == "3d":
        for k in range(6, 10):
            np.testing.assert_allclose(float(got[k]), float(ref[k]),
                                       rtol=1e-6)


# ---- the step ------------------------------------------------------------------

@pytest.mark.parametrize("dim", ["3d", "2d"])
@pytest.mark.parametrize("sources", [True, False])
def test_step_matches_fused_reference(dim, sources):
    """One step at iteration 3 (the source decay exercised)."""
    amp = 0.1 if sources else 0.0
    params = dict(source_amplitude_u=amp, source_amplitude_v=amp / 2)
    jg, tg = _grids(SHAPES[dim])
    jstep = (_fused_reference(dim) if sources else jax.jit(
        j_make_euler_step(jg, JParams(**params), dtype=jnp.float32,
                          use_pallas=True, pallas_interpret=True)))
    a = _arrays(SHAPES[dim], 1, np.float32)
    jf, jr = jstep(_jfield(a), 5e-5, 3)
    tf, tr = _port(dim, NSParams(**params))(
        field_from_numpy(a, "cpu", torch.float32), 5e-5, 3)
    assert int(tr.status) == 0
    _assert_close(tf, tr, jf, jr, BARS[dim])


@pytest.mark.parametrize("dim", ["3d", "2d"])
def test_multi_step_matches_fused_reference(dim):
    """Four steps at dt = 1e-4 (the cap) with the default sources, held
    at the reference's multi-step bar (`test_euler_fused.py:74`)."""
    a = _arrays(SHAPES[dim], 2, np.float32)
    jf, tf = _jfield(a), field_from_numpy(a, "cpu", torch.float32)
    jstep, step = _fused_reference(dim), _port(dim)
    for i in range(4):
        jf, jr = jstep(jf, 1e-4, i)
        tf, tr = step(tf, 1e-4, i)
    assert int(tr.status) == 0
    _assert_close(tf, tr, jf, jr, 1e-5)


@pytest.mark.parametrize("dim", ["3d", "2d"])
def test_clamps_and_rho_guard(dim):
    """A huge pressure gradient engages the derivative and update clamps;
    a ρ hole engages the per-point guard, which keeps the old values."""
    shape = SHAPES[dim]
    a = _arrays(shape, 3, np.float32)
    a["p"] = a["p"] * np.float32(1e6)
    hole = (min(4, shape[0] - 1), 8, 64)
    a["rho"][hole] = 1e-12
    jf, jr = _fused_reference(dim)(_jfield(a), 1e-4, 0)
    tf, tr = _port(dim)(field_from_numpy(a, "cpu", torch.float32), 1e-4, 0)
    assert int(tr.status) == int(jr.status)
    out = field_to_numpy(tf)
    for n in ("u", "v", "w", "p"):
        np.testing.assert_allclose(out[n], np.asarray(getattr(jf, n)),
                                   rtol=0, atol=BARS[dim], err_msg=n)
    assert out["u"][hole] == a["u"][hole]


@pytest.mark.nan_injection
@pytest.mark.parametrize("dim,where", [
    ("3d", (0, 5, 5)), ("3d", (4, 5, 5)), ("2d", (0, 5, 5)),
    ("2d", (0, 0, 5))], ids=["3d-shell-plane", "3d-interior", "2d-interior",
                             "2d-shell"])
def test_nan_gives_diverged(dim, where):
    """A NaN in u (interior, or a shell the step passes through) makes
    both packages report status −6 (ERROR_DIVERGED)."""
    a = _arrays(SHAPES[dim], 4, np.float32)
    a["u"][where] = np.nan
    _, jr = _fused_reference(dim)(_jfield(a), 1e-4, 0)
    _, tr = _port(dim)(field_from_numpy(a, "cpu", torch.float32), 1e-4, 0)
    assert int(jr.status) == int(tr.status) == -6


@pytest.mark.parametrize("shape", [(10, 20, 24), (11, 23, 37), (1, 23, 37)],
                         ids=["24x20x10", "37x23x11", "37x23"])
def test_step_matches_jnp_reference_f64(shape):
    """Three float64 steps against the reference's jnp step
    (`use_pallas=False`) on grids no kernel gate admits, within 1e-10.
    In 2D, w starts at 0 (as `FlowField.initialize` makes it): the
    reference's jnp 2D step wraps w's shells where its fused kernel, and
    the port, pass them through."""
    jg, tg = _grids(shape)
    a = _arrays(shape, 5, np.float64, w_zero=shape[0] == 1)
    jstep = jax.jit(j_make_euler_step(jg, JParams(), dtype=jnp.float64,
                                      use_pallas=False))
    step = make_euler_step(tg, NSParams(), dtype=torch.float64,
                           device="cpu")
    jf, tf = _jfield(a), field_from_numpy(a, "cpu", torch.float64)
    for i in range(3):
        jf, jr = jstep(jf, 2e-3, i)
        tf, tr = step(tf, 2e-3, i)
    assert int(tr.status) == int(jr.status) == 0
    _assert_close(tf, tr, jf, jr, 1e-10)
