"""Package-level properties of the port: it never loads JAX, every module
imports without nvcc or triton, configurations outside the ported slice
raise, and state and parameters carry across from the reference."""

import contextlib
import dataclasses
import os
import pkgutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cfd_tpu_torch
from cfd_tpu import FlowField as JField
from cfd_tpu import Grid as JGrid
from cfd_tpu.solvers.ns import NSParams as JParams
from cfd_tpu.solvers.ns.common import z_constants as j_z_constants
from cfd_tpu_torch import CFDError, FlowField, Grid, Status
from cfd_tpu_torch.api import Simulation
from cfd_tpu_torch.boundary import BCType, ThermalBCConfig
from cfd_tpu_torch.config import device_of, resolve_dtype
from cfd_tpu_torch.entry import entry
from cfd_tpu_torch.interop import field_from_numpy, field_to_numpy
from cfd_tpu_torch.solvers.ns.common import kernel_step, z_constants
from cfd_tpu_torch.solvers.ns.euler import make_euler_step
from cfd_tpu_torch.solvers.ns.params import NSParams
from cfd_tpu_torch.solvers.ns.projection import make_projection_step
from cfd_tpu_torch.solvers.ns.rk import make_rk2_step, make_rk4_step
from cfd_tpu_torch.solvers.ns.solver import NSSolver
from cfd_tpu_torch.solvers.poisson.base import Method

torch.set_num_threads(min(2, torch.get_num_threads()))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULES = sorted(m.name for m in pkgutil.walk_packages(
    cfd_tpu_torch.__path__, "cfd_tpu_torch."))


def _run_isolated(code: str) -> str:
    """Run ``code`` in a fresh interpreter with only the repo on the path."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "XLA_FLAGS")}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


def test_import_loads_no_jax():
    """Importing every module of the port, the facade and the explicit
    integrators included, loads neither JAX nor the JAX package."""
    out = _run_isolated(
        "import importlib, sys\n"
        f"for name in {MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'cfd_tpu'))\n"
        "print('LOADED', bad)\n")
    assert "LOADED []" in out
    for name in ("cfd_tpu_torch.api.simulation", "cfd_tpu_torch.entry",
                 "cfd_tpu_torch.solvers.ns.euler",
                 "cfd_tpu_torch.solvers.ns.rk",
                 "cfd_tpu_torch.solvers.ns.solver",
                 "cfd_tpu_torch.solvers.ns.hybrid",
                 "cfd_tpu_torch.solvers.ns.rollout",
                 "cfd_tpu_torch.solvers.poisson.adjoint"):
        assert name in MODULES, name


def test_differentiable_exports_match_reference():
    """The reference's differentiable API under its names:
    ``solvers.poisson.make_adjoint_poisson``, ``solvers.ns.make_rollout``
    (with ``REMAT_POLICIES``), ``solvers.ns.hybrid.pair_vjp``, and the
    same signatures as the reference's."""
    import inspect

    from cfd_tpu.solvers import ns as jns
    from cfd_tpu.solvers import poisson as jpoisson
    from cfd_tpu.solvers.ns import hybrid as jhybrid
    from cfd_tpu_torch.solvers import ns, poisson
    from cfd_tpu_torch.solvers.ns import hybrid

    for ours, theirs, name in ((poisson, jpoisson, "make_adjoint_poisson"),
                               (ns, jns, "make_rollout"),
                               (hybrid, jhybrid, "pair_vjp")):
        assert name in getattr(ours, "__all__", [name])
        assert list(inspect.signature(getattr(ours, name)).parameters) == \
            list(inspect.signature(getattr(theirs, name)).parameters), name
    assert ns.REMAT_POLICIES == (None, "none", "step", "sqrt")


def test_every_module_imports_without_nvcc_or_triton():
    """Importing every module neither starts a process (nvcc) nor loads
    triton, and leaves the CUDA library unbuilt."""
    out = _run_isolated(
        "import importlib, subprocess, sys\n"
        "def refuse(*a, **k):\n"
        "    raise AssertionError('process started during import')\n"
        "subprocess.Popen = refuse\n"
        f"for name in {MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "from cfd_tpu_torch.ops.kernels import native\n"
        "print('TRITON', 'triton' in sys.modules, 'LIB', native._lib)\n")
    assert "TRITON False LIB None" in out
    assert "cfd_tpu_torch.ops.kernels.projection_kernels" in MODULES


def _grid(nx=128, ny=16, nz=8):
    return Grid.uniform(nx, ny, nz, zmin=0.0, zmax=1.0)


def _stretched_grid():
    g = _grid()
    x = g.x.copy()
    x[1] += 0.3 * (x[2] - x[1])
    return dataclasses.replace(g, x=x, dx=np.diff(x))


SPECTRAL = dict(poisson_method=Method.FFT_DIRECT)


def _no_bcs(u, v, w, t):
    return u, v, w


def _heat(X, Y, Z, t):
    return 0.0


UNSUPPORTED = {
    # the reference's step has no SOR maker either (`projection.py:51-58`)
    "sor": dict(poisson_method=Method.SOR),
    # 128×16×8 cannot be coarsened ((n − 1) odd), as in the reference
    "multigrid": dict(poisson_method=Method.MULTIGRID),
    "2d_gauss_seidel": dict(grid=Grid.uniform(128, 16),
                            poisson_method=Method.GAUSS_SEIDEL),
    "source_func": dict(params=NSParams(
        source_func=lambda X, Y, Z, t: (0.0, 0.0, 0.0))),
    # a heat source (a callable Q) is a later slice, with source_func
    "heat_source_func": dict(params=NSParams(alpha=1e-3,
                                             heat_source_func=_heat)),
    "2d_heat_source_func": dict(grid=Grid.uniform(128, 16),
                                params=NSParams(alpha=1e-3,
                                                heat_source_func=_heat)),
    "energy_stretched": dict(grid=_stretched_grid(),
                             params=NSParams(alpha=1e-3)),
}


@pytest.mark.parametrize("case", sorted(UNSUPPORTED))
def test_unsupported_configurations_raise(case):
    kw = dict(UNSUPPORTED[case])
    grid = kw.pop("grid", _grid())
    params = kw.pop("params", NSParams())
    with pytest.raises(CFDError) as err:
        make_projection_step(grid, params, dtype=torch.float32,
                             device="cpu", **kw)
    assert err.value.status == Status.ERROR_UNSUPPORTED


EXPLICIT_UNSUPPORTED = {
    "source_func": dict(params=NSParams(
        source_func=lambda X, Y, Z, t: (0.0, 0.0, 0.0))),
    "heat_source_func": dict(params=NSParams(alpha=1e-3,
                                             heat_source_func=_heat)),
    "2d_heat_source_func": dict(grid=Grid.uniform(128, 16),
                                params=NSParams(alpha=1e-3,
                                                heat_source_func=_heat)),
}


@pytest.mark.parametrize("case", sorted(EXPLICIT_UNSUPPORTED))
@pytest.mark.parametrize("builder", [make_euler_step, make_rk2_step,
                                     make_rk4_step],
                         ids=["euler", "rk2", "rk4"])
def test_explicit_unsupported_configurations_raise(builder, case):
    """Outside the explicit integrators' slice the builders raise, before
    any device use."""
    kw = dict(EXPLICIT_UNSUPPORTED[case])
    grid = kw.pop("grid", _grid())
    params = kw.pop("params", NSParams())
    kw.setdefault("dtype", torch.float32)
    kw.setdefault("device", "cpu")
    with pytest.raises(CFDError) as err:
        builder(grid, params, **kw)
    assert err.value.status == Status.ERROR_UNSUPPORTED


# Configurations the stretched-grid slice made supported (they raised
# before it): each now builds and matches the reference's step, float64,
# one step from the same fields — the projection step's CG solve run to
# 1e-12 in both packages.
def _j_stretched_grid():
    g = JGrid.uniform(128, 16, 8, zmin=0.0, zmax=1.0)
    x = g.x.copy()
    x[1] += 0.3 * (x[2] - x[1])
    return dataclasses.replace(g, x=x, dx=np.diff(x))


NOW_SUPPORTED = {
    # sources off: on a stretched grid the reference's jnp step builds
    # them from the true coordinates and its kernels (and the port) from
    # index space (test_torch_parity_stretched.py holds both)
    "stretched": dict(grid=True, params=dict(source_amplitude_u=0.0,
                                             source_amplitude_v=0.0)),
    "consistent": dict(params=dict(nonuniform_scheme="consistent")),
    # spectral_precision="default" (one TF32 pass; the plain product in
    # float64) takes the reference's emit-b̃ route, in 3D and 2D, with
    # the bc_refresh hook too
    "precision_default": dict(step=dict(spectral_precision="default",
                                        **SPECTRAL)),
    "2d_precision_default": dict(two_d=True, step=dict(
        spectral_precision="default", **SPECTRAL)),
    "bc_refresh_precision_default": dict(step=dict(
        bc_refresh=_no_bcs, spectral_precision="default", **SPECTRAL)),
    "2d_bc_refresh_precision_default": dict(two_d=True, step=dict(
        bc_refresh=_no_bcs, spectral_precision="default", **SPECTRAL)),
    # the plain differentiable step (the adjoint CG solve), with and
    # without the hook
    "differentiable": dict(step=dict(differentiable=True)),
    "bc_refresh_differentiable": dict(step=dict(bc_refresh=_no_bcs,
                                                differentiable=True)),
}
EXPLICIT_NOW_SUPPORTED = {
    # sources off: on a stretched grid the reference's jnp step builds
    # them from the true coordinates and its kernels (and the port) from
    # index space (test_torch_parity_stretched.py holds both)
    "stretched": dict(grid=True, params=dict(source_amplitude_u=0.0,
                                             source_amplitude_v=0.0)),
    "consistent": dict(params=dict(nonuniform_scheme="consistent")),
    "energy_consistent": dict(params=dict(alpha=1e-3,
                                          nonuniform_scheme="consistent")),
    # the plain differentiable step (on the card: the hybrid)
    "differentiable": dict(step=dict(differentiable=True)),
}


def _step_both(kind, case, builder=None):
    """One float64 step of the port's and the reference's step for a
    case of NOW_SUPPORTED (kind "projection") or EXPLICIT_NOW_SUPPORTED
    (an explicit builder), from the same fields."""
    import jax
    from cfd_tpu.solvers.poisson.base import PoissonParams as JPoisson
    from cfd_tpu_torch.solvers.poisson.base import PoissonParams

    table = NOW_SUPPORTED if kind == "projection" else \
        EXPLICIT_NOW_SUPPORTED
    kw = table[case]
    if kw.get("grid"):
        jg = _j_stretched_grid()
    elif kw.get("two_d"):
        jg = JGrid.uniform(128, 16)
    else:
        jg = JGrid.uniform(128, 16, 8, zmin=0.0, zmax=1.0)
    step_kw = dict(kw.get("step", {}))
    j_step_kw = dict(step_kw)
    if step_kw.get("spectral_precision") == "default":
        from jax import lax
        j_step_kw["spectral_precision"] = lax.Precision.DEFAULT
    if "poisson_method" in step_kw:
        from cfd_tpu.solvers.poisson.base import Method as JMethod
        j_step_kw["poisson_method"] = JMethod(int(step_kw["poisson_method"]))
    tg = Grid(*(getattr(jg, f.name) for f in dataclasses.fields(jg)))
    jparams = JParams(**kw.get("params", {}))
    tparams = NSParams.from_fields(jparams)
    if kind == "projection":
        from cfd_tpu.solvers.ns.projection import make_projection_step as jm
        tight = dict(tolerance=1e-12, max_iterations=3000)
        jstep = jm(jg, jparams, jnp.float64, use_pallas=False,
                   poisson_params=JPoisson(**tight), **j_step_kw)
        tstep = make_projection_step(tg, tparams, dtype=torch.float64,
                                     device="cpu",
                                     poisson_params=PoissonParams(**tight),
                                     **step_kw)
    else:
        from cfd_tpu.solvers.ns import euler as je
        from cfd_tpu.solvers.ns import rk as jr
        jm = {"euler": je.make_euler_step, "rk2": jr.make_rk2_step,
              "rk4": jr.make_rk4_step}[builder]
        jstep = jm(jg, jparams, jnp.float64, use_pallas=False,
                   **j_step_kw)
        tstep = {"euler": make_euler_step, "rk2": make_rk2_step,
                 "rk4": make_rk4_step}[builder](tg, tparams, torch.float64,
                                                "cpu", **step_kw)
    rng = np.random.default_rng(3)
    arrays = {n: rng.normal(0.0, 0.1, jg.shape) for n in "uvw"}
    arrays.update(p=1.0 + rng.normal(0.0, 0.1, jg.shape),
                  rho=np.ones(jg.shape),
                  T=300.0 + rng.normal(0.0, 1.0, jg.shape))
    jf, jres = jax.jit(jstep)(JField(**{n: jnp.asarray(a) for n, a in
                                        arrays.items()}), 1e-3, 0)
    tf, tres = tstep(field_from_numpy(arrays, "cpu", torch.float64), 1e-3,
                     0)
    assert int(jres.status) == int(tres.status) == 0
    for n in ("u", "v", "w", "p", "T"):
        ref = np.asarray(getattr(jf, n))
        np.testing.assert_allclose(getattr(tf, n).numpy(), ref, rtol=0,
                                   atol=1e-9 * max(1.0, np.abs(ref).max()),
                                   err_msg=n)


@pytest.mark.parametrize("case", sorted(NOW_SUPPORTED))
def test_now_supported_configurations_match_reference(case):
    """The parity scheme on a stretched grid (the dx0 spacings), the
    consistent scheme on a uniform grid (the parity step),
    ``spectral_precision="default"`` and the differentiable step (with
    and without ``bc_refresh``) build and match the reference's step."""
    _step_both("projection", case)


@pytest.mark.parametrize("case", sorted(EXPLICIT_NOW_SUPPORTED))
@pytest.mark.parametrize("builder", ["euler", "rk2", "rk4"])
def test_explicit_now_supported_configurations_match_reference(builder,
                                                                case):
    """A stretched grid (parity weights), the consistent scheme on a
    uniform grid, with and without the energy equation, and the
    differentiable step build and match the reference's step."""
    _step_both("explicit", case, builder)


INVALID_THERMAL = {
    "projection_3d": lambda p: make_projection_step(
        _grid(), p, dtype=torch.float32, device="cpu"),
    "projection_2d": lambda p: make_projection_step(
        Grid.uniform(128, 16), p, dtype=torch.float32, device="cpu",
        poisson_method=Method.FFT_DIRECT),
    "euler": lambda p: make_euler_step(_grid(), p, torch.float32, "cpu"),
    "rk2": lambda p: make_rk2_step(Grid.uniform(32, 16), p, torch.float32,
                                   "cpu"),
    "rk4": lambda p: make_rk4_step(_grid(), p, torch.float32, "cpu"),
}


@pytest.mark.parametrize("builder", sorted(INVALID_THERMAL))
def test_invalid_thermal_bc_raises(builder):
    """With the energy equation on, a thermal face type other than
    PERIODIC, NEUMANN or DIRICHLET is ERROR_INVALID at build time, as the
    reference's `validate_thermal_bc` (`energy.py:67-88`); with it off the
    config is not read."""
    bad = ThermalBCConfig(top=BCType.NOSLIP)
    with pytest.raises(CFDError) as err:
        INVALID_THERMAL[builder](NSParams(alpha=1e-3, thermal_bc=bad))
    assert err.value.status == Status.ERROR_INVALID
    INVALID_THERMAL[builder](NSParams(thermal_bc=bad))


def _g2():
    return Grid.uniform(32, 16)


# every entry point called without ``device``
DEFAULT_DEVICE_CALLS = {
    "entry": lambda: entry(),
    "make_projection_step": lambda: make_projection_step(_grid(),
                                                         NSParams()),
    "make_euler_step": lambda: make_euler_step(_g2(), NSParams()),
    "make_rk2_step": lambda: make_rk2_step(_grid(), NSParams()),
    "make_rk4_step": lambda: make_rk4_step(_g2(), NSParams()),
    "NSSolver.init": lambda: NSSolver(name="rk4", method="rk4").init(
        _g2(), NSParams()),
    "Simulation.create": lambda: Simulation.create(32, 16),
    "FlowField.initialize": lambda: FlowField.initialize(_g2()),
    "FlowField.quiescent": lambda: FlowField.quiescent(8, 8),
    "field_from_numpy": lambda: field_from_numpy(
        {n: np.zeros((1, 4, 4)) for n in ("u", "v", "w", "p", "rho", "T")}),
}


@pytest.mark.parametrize("call", sorted(DEFAULT_DEVICE_CALLS))
def test_entry_points_default_to_cuda(call):
    """Without ``device`` an entry point targets the card: it builds there
    when CUDA is present, and raises (no CPU fallback) when it is not."""
    assert device_of(None) == torch.device("cuda")
    if torch.cuda.is_available():
        DEFAULT_DEVICE_CALLS[call]()
        return
    with pytest.raises(RuntimeError, match="cuda"):
        DEFAULT_DEVICE_CALLS[call]()


def test_default_poisson_method_is_cg_in_both_packages():
    """``make_projection_step`` builds the same solver in both packages
    when the caller names no method: CG, the reference C library's choice
    (`solver_projection.c:217-218`)."""
    import inspect

    from cfd_tpu.solvers.ns.projection import \
        make_projection_step as j_make_step
    from cfd_tpu.solvers.poisson.base import Method as JMethod

    ours = inspect.signature(make_projection_step).parameters
    theirs = inspect.signature(j_make_step).parameters
    assert ours["poisson_method"].default == Method.CG
    assert theirs["poisson_method"].default == JMethod.CG
    assert int(ours["poisson_method"].default) == int(
        theirs["poisson_method"].default)
    assert ours["poisson_params"].default is None
    assert theirs["poisson_params"].default is None


@pytest.mark.parametrize("builder", [make_projection_step, make_euler_step,
                                     make_rk2_step, make_rk4_step],
                         ids=["projection", "euler", "rk2", "rk4"])
def test_float64_on_cuda_builds_the_plain_step(builder):
    """Repaired fault C2 (these builders raised ``ERROR_UNSUPPORTED`` for
    float64 on CUDA): a float64 step on the card is the plain step there,
    the reference's own float32 gate on its kernels.  The step's dispatch
    says it launches no kernel, and the builder passes its dtype check and
    reaches the device — on a machine without CUDA, the device check's
    RuntimeError.  That the float64 step enters no kernel wrapper is
    `test_torch_solver_repairs.py::test_float64_step_reaches_no_kernel_
    wrapper`; its values on the card against the CPU are ``chip_smoke.py``
    phase 44."""
    assert not kernel_step(torch.float64, "cuda")
    assert kernel_step(torch.float32, "cuda")
    expect = (contextlib.nullcontext() if torch.cuda.is_available()
              else pytest.raises(RuntimeError, match="cuda"))
    with expect:
        builder(_grid(), NSParams(), dtype=torch.float64, device="cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_field_numpy_round_trip(dtype):
    rng = np.random.default_rng(2)
    arrays = {n: rng.normal(size=(4, 5, 6)) for n in
              ("u", "v", "w", "p", "rho", "T")}
    f = field_from_numpy(arrays, "cpu", dtype)
    assert f.dtype == dtype and f.shape == (4, 5, 6)
    back = field_to_numpy(f)
    for n, a in arrays.items():
        np.testing.assert_array_equal(back[n], a.astype(back[n].dtype))
    again = field_from_numpy(back, "cpu", dtype)
    for n in arrays:
        assert torch.equal(getattr(again, n), getattr(f, n))


def test_field_from_reference_arrays():
    """A reference FlowField converts through np.array (its buffers are
    read-only views under np.asarray) and matches FlowField.initialize."""
    jg = JGrid.uniform(24, 20, 10, zmin=0.0, zmax=1.0)
    jf = JField.initialize(jg, dtype=jnp.float64)
    tf = field_from_numpy({n: getattr(jf, n) for n in
                           ("u", "v", "w", "p", "rho", "T")},
                          "cpu", torch.float64)
    ref = FlowField.initialize(Grid.uniform(24, 20, 10, zmin=0.0, zmax=1.0),
                               dtype=torch.float64, device="cpu")
    for n in ("u", "v", "w", "p", "rho", "T"):
        assert torch.equal(getattr(tf, n), getattr(ref, n)), n


def test_grid_matches_reference():
    g = Grid.uniform(24, 20, 10, xmin=-1.0, xmax=2.0, zmin=0.0, zmax=0.5)
    jg = JGrid.uniform(24, 20, 10, xmin=-1.0, xmax=2.0, zmin=0.0, zmax=0.5)
    for a in ("x", "y", "z", "dx", "dy", "dz"):
        np.testing.assert_array_equal(getattr(g, a), getattr(jg, a))
    assert (g.shape, g.dx0, g.dy0, g.dz0, g.inv_dz2) == (
        jg.shape, jg.dx0, jg.dy0, jg.dz0, jg.inv_dz2)
    assert z_constants(g) == j_z_constants(jg)
    X, Y, Z = g.coordinate_arrays(torch.float64)
    jX, jY, jZ = jg.coordinate_arrays(jnp.float64)
    for a, b in ((X, jX), (Y, jY), (Z, jZ)):
        np.testing.assert_array_equal(a.numpy(), b)
    with pytest.raises(CFDError):
        Grid.uniform(8, 8, 4, zmin=1.0, zmax=1.0)


def test_params_carry_across():
    """NSParams keeps the reference's fields and defaults one for one; its
    thermal_bc is converted to the port's config, face by face and value
    by value, and defaults to the reference's all-periodic config."""
    names = [f.name for f in dataclasses.fields(NSParams)]
    assert names == [f.name for f in dataclasses.fields(JParams)]
    jp = JParams(mu=0.02, source_amplitude_u=0.3, gravity=(0.0, -9.8, 0.0))
    tp = NSParams.from_fields(jp)
    for n in names:
        if n != "thermal_bc":
            assert getattr(tp, n) == getattr(jp, n), n

    def same_thermal(t, j):
        assert isinstance(t, ThermalBCConfig)
        for face in ("left", "right", "bottom", "top", "front", "back"):
            assert int(getattr(t, face)) == int(getattr(j, face)), face
            assert getattr(t.dirichlet_values, face) == \
                getattr(j.dirichlet_values, face), face

    same_thermal(tp.thermal_bc, jp.thermal_bc)
    for n in names:
        if n == "thermal_bc":
            same_thermal(NSParams().thermal_bc, JParams().thermal_bc)
        else:
            assert getattr(NSParams(), n) == getattr(JParams(), n), n


def test_dtype_resolution():
    assert resolve_dtype(None, "cuda") == torch.float32
    assert resolve_dtype(None, "cpu") == torch.get_default_dtype()
    assert resolve_dtype("float64", "cuda") == torch.float64
    assert resolve_dtype(np.float32, "cpu") == torch.float32
