"""The port's RK2 (Heun) and RK4 (classical) steps against the reference's.

* the stage kernel's wrappers (`ops.kernels.rk_kernels.rk_stage`,
  `ops.kernels.rk2d.rk2d_stage`; their plain versions on CPU tensors)
  against the reference's `make_rk_stage` / `make_rk2d_stage` in
  interpret mode, float32, a mid stage and the final stage;
* the steps against the reference's fused steps (interpret mode, float32,
  128×16×8 and 128×32, the reference kernels' gates) within the
  reference's bars — 5e-6 in 3D (`tests/math/test_rk_fused.py:50`), 1e-6
  in 2D — over one step and over four (at the reference's multi-step bar
  2e-5, `test_rk_fused.py:74`), and NaN injection giving status −6 in
  both;
* the steps and the momentum RHS against the reference's jnp versions
  (float64) on unaligned grids no kernel gate admits, within 1e-10.

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
from cfd_tpu.ops.pallas.rk2d import make_rk2d_stage
from cfd_tpu.ops.pallas.rk_kernels import make_rk_stage
from cfd_tpu.solvers.ns import NSParams as JParams
from cfd_tpu.solvers.ns import rk as jrk
from cfd_tpu_torch import Grid
from cfd_tpu_torch.interop import field_from_numpy, field_to_numpy
from cfd_tpu_torch.ops.kernels.euler_kernels import ExplicitConsts
from cfd_tpu_torch.ops.kernels.rk2d import rk2d_stage
from cfd_tpu_torch.ops.kernels.rk_kernels import rk_stage
from cfd_tpu_torch.solvers.ns import rk
from cfd_tpu_torch.solvers.ns.common import source_basis
from cfd_tpu_torch.solvers.ns.params import NSParams

torch.set_num_threads(min(2, torch.get_num_threads()))

NAMES = ("u", "v", "w", "p", "rho", "T")
DIAGS = ("max_velocity", "max_pressure", "max_temperature")
SHAPES = {"3d": (8, 16, 128), "2d": (1, 32, 128)}
BARS = {"3d": 5e-6, "2d": 1e-6}
MAKERS = {2: (jrk.make_rk2_step, rk.make_rk2_step),
          4: (jrk.make_rk4_step, rk.make_rk4_step)}


def _grids(shape):
    nz, ny, nx = shape
    kw = dict(zmin=0.0, zmax=1.0) if nz > 1 else {}
    return JGrid.uniform(nx, ny, nz, **kw), Grid.uniform(nx, ny, nz, **kw)


def _arrays(shape, seed, np_dt, amp=0.3):
    rng = np.random.default_rng(seed)
    out = {n: rng.normal(0.0, amp, shape).astype(np_dt) for n in "uvwp"}
    out["rho"] = np.ones(shape, np_dt)
    out["T"] = (300.0 + rng.normal(0.0, 1.0, shape)).astype(np_dt)
    return out


def _jfield(arrays):
    return JField(**{n: jnp.asarray(a) for n, a in arrays.items()})


@functools.lru_cache(maxsize=None)
def _fused_reference(order, dim):
    """The reference's fused step (interpret mode), jitted once."""
    jg, _ = _grids(SHAPES[dim])
    return jax.jit(MAKERS[order][0](jg, JParams(), dtype=jnp.float32,
                                    use_pallas=True, pallas_interpret=True))


def _port(order, dim, params=None):
    _, tg = _grids(SHAPES[dim])
    return MAKERS[order][1](tg, params or NSParams(), dtype=torch.float32,
                            device="cpu")


def _assert_close(tf, tr, jf, jr, atol):
    out = field_to_numpy(tf)
    for n in NAMES:
        np.testing.assert_allclose(out[n], np.asarray(getattr(jf, n)),
                                   rtol=0, atol=atol, err_msg=n)
    for d in DIAGS:
        np.testing.assert_allclose(float(getattr(tr, d)),
                                   float(getattr(jr, d)), rtol=1e-6,
                                   err_msg=d)
    assert int(tr.status) == int(jr.status)


# ---- the kernel modules ------------------------------------------------------

@pytest.mark.parametrize("dim", ["3d", "2d"])
@pytest.mark.parametrize("final", [False, True], ids=["mid", "final"])
def test_stage_kernel_matches_reference(dim, final):
    """One stage of the wrapper on CPU tensors against the reference's raw
    stage kernel (factor, acc_mix, weight as RK4's second stage, or its
    final stage).  A mid stage is compared on the interior, the only
    points the next stage's periodic-interior stencils read; the final
    stage on every point (in 2D the reference leaves the y-face rows to
    its step wrapper, so those rows are compared in the step tests)."""
    shape = SHAPES[dim]
    nz, ny, nx = shape
    jg, tg = _grids(shape)
    a = _arrays(shape, 1, np.float32)
    rng = np.random.default_rng(7)
    acc = [rng.normal(0.0, 0.5, shape).astype(np.float32) for _ in range(4)]
    q0 = [(a[n] + rng.normal(0.0, 0.01, shape)).astype(np.float32)
          for n in "uvwp"]
    st = [a[n] for n in "uvwp"]
    dt, su, sv = 5e-5, 0.08, 0.04
    factor, acc_mix, weight = ((dt / 6, 1.0, 0.0) if final
                               else (dt / 2, 0.0, 2.0))
    scal = [factor, acc_mix, weight, su, sv, dt]
    fields = [*st, a["T"], *q0, a["rho"], *acc]
    if dim == "3d":
        fn = make_rk_stage(nz, ny, nx, jg.dx0, jg.dy0, jg.dz0, jg.xmin,
                           jg.ymin, 0.01, 0.1, final=final,
                           dtype=jnp.float32, interpret=True)
        pins = [np.stack([s[nz - 2], s[1]]) for s in st]
        ref = fn(jnp.asarray(scal + [0.0], jnp.float32),
                 *(jnp.asarray(f) for f in fields + pins))
    else:
        fn = make_rk2d_stage(ny, nx, jg.dx0, jg.dy0, jg.xmin, jg.ymin, 0.01,
                             0.1, final=final, dtype=jnp.float32,
                             interpret=True)
        pins = np.concatenate([np.stack([s[0, ny - 2] for s in st]),
                               np.stack([s[0, 1] for s in st])])
        ref = [o[None] for o in fn(jnp.asarray(scal, jnp.float32),
                                   *(jnp.asarray(f[0]) for f in fields),
                                   jnp.asarray(pins))]
    c = ExplicitConsts(nz, ny, nx, tg.dx0, tg.dy0, tg.dz0, 0.01, 0.1)
    sy, sx = source_basis(tg, torch.float32, "cpu")
    wrapper = rk_stage if dim == "3d" else rk2d_stage
    got = wrapper(tuple(torch.tensor(s) for s in st),
                  tuple(torch.tensor(q) for q in q0), torch.tensor(a["rho"]),
                  torch.tensor(a["T"]), tuple(torch.tensor(x) for x in acc),
                  sy, sx, torch.tensor(scal[:5], dtype=torch.float32), c,
                  final)
    zi = slice(1, -1) if nz > 1 else slice(None)
    for k in range(6 if final else 8):
        g, r = got[k].numpy(), np.asarray(ref[k])
        if not final:
            g, r = g[zi, 1:-1, 1:-1], r[zi, 1:-1, 1:-1]
        elif dim == "2d":
            g, r = g[:, 1:-1], r[:, 1:-1]
        # the accumulators (outputs 4-7 of a mid stage) are O(100), where
        # one float32 ulp is 1.5e-5: their bar is relative to max|ref|
        scale = max(1.0, float(np.abs(r).max())) if k >= 4 else 1.0
        np.testing.assert_allclose(g, r, rtol=0, atol=BARS[dim] * scale,
                                   err_msg=f"output {k}")
    if final and dim == "3d":
        for k in range(6, 10):
            np.testing.assert_allclose(float(got[k]), float(ref[k]),
                                       rtol=1e-6)


# ---- the steps -----------------------------------------------------------------

@pytest.mark.parametrize("dim", ["3d", "2d"])
@pytest.mark.parametrize("order", [2, 4])
def test_step_matches_fused_reference(order, dim):
    """One step at iteration 2 (the source decay exercised)."""
    a = _arrays(SHAPES[dim], 1, np.float32)
    jf, jr = _fused_reference(order, dim)(_jfield(a), 5e-5, 2)
    tf, tr = _port(order, dim)(field_from_numpy(a, "cpu", torch.float32),
                               5e-5, 2)
    assert int(tr.status) == 0
    _assert_close(tf, tr, jf, jr, BARS[dim])


@pytest.mark.parametrize("dim", ["3d", "2d"])
@pytest.mark.parametrize("order", [2, 4])
def test_multi_step_matches_fused_reference(order, dim):
    """Four steps at dt = 1e-4 with the default sources."""
    a = _arrays(SHAPES[dim], 2, np.float32)
    jf, tf = _jfield(a), field_from_numpy(a, "cpu", torch.float32)
    jstep, step = _fused_reference(order, dim), _port(order, dim)
    for i in range(4):
        jf, jr = jstep(jf, 1e-4, i)
        tf, tr = step(tf, 1e-4, i)
    assert int(tr.status) == 0
    _assert_close(tf, tr, jf, jr, 2e-5)


@pytest.mark.parametrize("dim", ["3d", "2d"])
def test_clamps_and_rho_guard(dim):
    """A huge pressure gradient and a 150 spike in u engage the
    derivative clamps and the velocity clamp; a ρ hole zeroes the RHS
    there (RK4)."""
    shape = SHAPES[dim]
    a = _arrays(shape, 3, np.float32)
    a["p"] = a["p"] * np.float32(1e6)
    hole = (min(4, shape[0] - 1), 8, 64)
    a["rho"][hole] = 1e-12
    a["u"][min(4, shape[0] - 1), 10, 30] = 150.0
    jf, jr = _fused_reference(4, dim)(_jfield(a), 1e-3, 0)
    tf, tr = _port(4, dim)(field_from_numpy(a, "cpu", torch.float32), 1e-3,
                           0)
    assert int(tr.status) == int(jr.status)
    out = field_to_numpy(tf)
    assert np.abs(out["u"]).max() == 100.0      # the velocity clamp held
    for n in ("u", "v", "w"):
        np.testing.assert_allclose(out[n], np.asarray(getattr(jf, n)),
                                   rtol=0, atol=BARS[dim], err_msg=n)
    np.testing.assert_allclose(out["p"], np.asarray(jf.p), rtol=1e-6,
                               err_msg="p")


@pytest.mark.nan_injection
@pytest.mark.parametrize("dim,where", [
    ("3d", (4, 5, 5)), ("3d", (0, 5, 5)), ("2d", (0, 5, 5))],
    ids=["3d-interior", "3d-shell-plane", "2d-interior"])
def test_nan_gives_diverged(dim, where):
    """A NaN in u makes both packages report status −6 (ERROR_DIVERGED)
    (`tests/math/test_rk_fused.py:78`); on a shell plane it reaches the
    output through the final stage's periodic wrap."""
    a = _arrays(SHAPES[dim], 4, np.float32)
    a["u"][where] = np.nan
    _, jr = _fused_reference(2, dim)(_jfield(a), 1e-4, 0)
    _, tr = _port(2, dim)(field_from_numpy(a, "cpu", torch.float32), 1e-4,
                          0)
    assert int(jr.status) == int(tr.status)
    assert int(tr.status) == (0 if where[0] == 0 and dim == "3d" else -6)


UNALIGNED = [(10, 20, 24), (11, 23, 37), (1, 23, 37)]
UNALIGNED_IDS = ["24x20x10", "37x23x11", "37x23"]


@pytest.mark.parametrize("order", [2, 4])
@pytest.mark.parametrize("shape", UNALIGNED, ids=UNALIGNED_IDS)
def test_step_matches_jnp_reference_f64(shape, order):
    """Three float64 steps against the reference's jnp step
    (`use_pallas=False`) on grids no kernel gate admits, within 1e-10."""
    jg, tg = _grids(shape)
    a = _arrays(shape, 5, np.float64)
    jstep = jax.jit(MAKERS[order][0](jg, JParams(), dtype=jnp.float64,
                                     use_pallas=False))
    step = MAKERS[order][1](tg, NSParams(), dtype=torch.float64,
                            device="cpu")
    jf, tf = _jfield(a), field_from_numpy(a, "cpu", torch.float64)
    for i in range(3):
        jf, jr = jstep(jf, 2e-3, i)
        tf, tr = step(tf, 2e-3, i)
    assert int(tr.status) == int(jr.status) == 0
    _assert_close(tf, tr, jf, jr, 1e-10)


@pytest.mark.parametrize("shape", UNALIGNED, ids=UNALIGNED_IDS)
def test_momentum_rhs_matches_jnp_reference_f64(shape):
    """The semi-discrete RHS (`rk.py:52`), zero on the shell."""
    jg, tg = _grids(shape)
    a = _arrays(shape, 6, np.float64)
    a["rho"][tuple(s // 2 for s in shape)] = 1e-12   # the guard
    args = [a[n] for n in ("u", "v", "w", "p", "rho", "T")]
    ref = jrk.make_momentum_rhs(jg, JParams(), jnp.float64)(
        *(jnp.asarray(x) for x in args), 3, 2e-3)
    got = rk.make_momentum_rhs(tg, NSParams(), torch.float64, "cpu")(
        *(torch.tensor(x) for x in args), 3, 2e-3)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-10)
