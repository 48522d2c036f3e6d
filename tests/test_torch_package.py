"""Package-level properties of the port: it never loads JAX, every module
imports without nvcc or triton, configurations outside the ported slice
raise, and state and parameters carry across from the reference."""

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
from cfd_tpu_torch.config import device_of, resolve_dtype
from cfd_tpu_torch.entry import entry
from cfd_tpu_torch.interop import field_from_numpy, field_to_numpy
from cfd_tpu_torch.solvers.ns.common import z_constants
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
                 "cfd_tpu_torch.solvers.ns.solver"):
        assert name in MODULES, name


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
UNSUPPORTED = {
    "bicgstab": dict(poisson_method=Method.BICGSTAB),
    # 128×16×8 cannot be coarsened ((n − 1) odd), as in the reference
    "multigrid": dict(poisson_method=Method.MULTIGRID),
    "nz3": dict(grid=_grid(nz=3), **SPECTRAL),
    "2d_buoyancy": dict(grid=Grid.uniform(128, 16),
                        params=NSParams(beta=0.05)),
    "2d_energy": dict(grid=Grid.uniform(128, 16),
                      params=NSParams(alpha=1e-3)),
    "2d_bc_refresh": dict(grid=Grid.uniform(128, 16),
                          bc_refresh=lambda u, v, w, t: (u, v, w)),
    "2d_redblack_sor": dict(grid=Grid.uniform(128, 16),
                            poisson_method=Method.REDBLACK_SOR),
    "2d_precision_high": dict(grid=Grid.uniform(128, 16),
                              spectral_precision="high", **SPECTRAL),
    "stretched": dict(grid=_stretched_grid()),
    "consistent": dict(params=NSParams(nonuniform_scheme="consistent")),
    "energy": dict(params=NSParams(alpha=1e-3)),
    "buoyancy": dict(params=NSParams(beta=0.05)),
    "source_func": dict(params=NSParams(
        source_func=lambda X, Y, Z, t: (0.0, 0.0, 0.0))),
    "bc_refresh": dict(bc_refresh=lambda u, v, w, t: (u, v, w)),
    "differentiable": dict(differentiable=True),
    "precision_high": dict(spectral_precision="high", **SPECTRAL),
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
    "stretched": dict(grid=_stretched_grid()),
    "consistent": dict(params=NSParams(nonuniform_scheme="consistent")),
    "energy": dict(params=NSParams(alpha=1e-3)),
    "buoyancy": dict(params=NSParams(beta=0.05)),
    "2d_energy": dict(grid=Grid.uniform(128, 16),
                      params=NSParams(alpha=1e-3)),
    "source_func": dict(params=NSParams(
        source_func=lambda X, Y, Z, t: (0.0, 0.0, 0.0))),
    "differentiable": dict(differentiable=True),
    "float64_on_cuda": dict(dtype=torch.float64, device="cuda"),
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


def test_float64_on_cuda_is_refused():
    """The kernels are float32; the check runs before any device use."""
    with pytest.raises(CFDError) as err:
        make_projection_step(_grid(), NSParams(), dtype=torch.float64,
                             device="cuda")
    assert err.value.status == Status.ERROR_UNSUPPORTED


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
    """NSParams keeps the reference's fields and defaults one for one."""
    names = [f.name for f in dataclasses.fields(NSParams)]
    assert names == [f.name for f in dataclasses.fields(JParams)]
    jp = JParams(mu=0.02, source_amplitude_u=0.3, gravity=(0.0, -9.8, 0.0))
    tp = NSParams.from_fields(jp)
    for n in names:
        if n != "thermal_bc":
            assert getattr(tp, n) == getattr(jp, n), n
    assert tp.thermal_bc is jp.thermal_bc
    for n in names:
        if n != "thermal_bc":
            assert getattr(NSParams(), n) == getattr(JParams(), n), n


def test_dtype_resolution():
    assert resolve_dtype(None, "cuda") == torch.float32
    assert resolve_dtype(None, "cpu") == torch.get_default_dtype()
    assert resolve_dtype("float64", "cuda") == torch.float64
    assert resolve_dtype(np.float32, "cpu") == torch.float32
