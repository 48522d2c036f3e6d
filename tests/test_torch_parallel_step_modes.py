"""The z-decomposed spectral step in its other modes, on `LocalComm` CPU
shards, and its refusals.

* float64 (the plain chain, `solvers.ns.common.runs_plain`): against the
  port's single-device plain FFT_DIRECT step at most 1e-12, against the
  reference's jnp FFT_DIRECT step 1e-9, over P = 1, 2, 4 and 3 steps;
* ``spectral_precision="high"`` against the reference's sharded step at
  ``lax.Precision.HIGH``, at the reference's HIGH bars, 2e-3 on p and
  1e-4 on u, v, w (`tests/math/test_mega_kernels.py:134-137`);
* every configuration outside the slice raises ``ERROR_UNSUPPORTED`` with
  its reason, through `make_sharded_step` and `make_sharded_raw_step` (the
  CG and BiCGSTAB solves are in the slice since the sharded Krylov steps;
  their cases are the preconditioners the reference's sharded solves
  refuse; a 2D grid runs on a y-only mesh, FFT_DIRECT only, with nx
  divisible by the shard count; the multigrid step takes coarsenable
  2^k+1 grids, so its case is a grid that is not; energy and buoyancy
  run, so their cases are a heat source, energy on a stretched grid in
  the parity scheme and a NOSLIP thermal face, ``ERROR_INVALID``; the
  consistent scheme and ``spectral_precision="default"`` run, so their
  cases are a consistent CG step and an unknown precision).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from cfd_tpu import FlowField as JField
from cfd_tpu import Grid as JGrid
from cfd_tpu.parallel.fused import make_fused_sharded_projection_step
from cfd_tpu.parallel.mesh import make_mesh as j_make_mesh
from cfd_tpu.solvers.ns import NSParams as JParams
from cfd_tpu.solvers.ns.projection import \
    make_projection_step as j_make_projection_step
from cfd_tpu.solvers.poisson.base import Method as JMethod
from cfd_tpu_torch import Grid, Status
from cfd_tpu_torch.boundary.types import BCType, ThermalBCConfig
from cfd_tpu_torch.core.status import CFDError
from cfd_tpu_torch.interop import field_from_numpy, grid_from
from cfd_tpu_torch.parallel import (gather_field, make_mesh,
                                    make_sharded_raw_step, make_sharded_step)
from cfd_tpu_torch.solvers.ns.params import NSParams
from cfd_tpu_torch.solvers.ns.projection import make_projection_step
from cfd_tpu_torch.solvers.poisson.base import (Method, PoissonParams,
                                                Precond)

from tests.test_torch_parallel_step import assert_close, random_arrays

torch.set_num_threads(min(2, torch.get_num_threads()))

NAMES = ("u", "v", "w", "p", "rho", "T")
CPU = torch.device("cpu")


def _zmesh(P):
    return make_mesh([CPU] * P, axes=("z",))


@pytest.mark.parametrize("P", [1, 2, 4])
def test_float64_matches_single_device_and_reference_jnp(P):
    jgrid = JGrid.uniform(40, 8 * P, 8, zmin=0.0, zmax=1.0)
    grid = grid_from(jgrid)
    arrays = random_arrays(jgrid.shape, seed=10 + P, dtype=np.float64)
    step, place = make_sharded_step(grid, NSParams(), _zmesh(P),
                                    dtype=torch.float64)
    single = make_projection_step(grid, NSParams(), torch.float64,
                                  Method.FFT_DIRECT, device="cpu")
    jstep = jax.jit(j_make_projection_step(
        jgrid, JParams(), dtype=jnp.float64,
        poisson_method=JMethod.FFT_DIRECT))
    f1 = field_from_numpy(arrays, "cpu", torch.float64)
    fs = place(f1)
    jf = JField(**{n: jnp.asarray(a) for n, a in arrays.items()})
    for it in range(3):
        fs, res = step(fs, 1e-3, it)
        f1, res1 = single(f1, 1e-3, it)
        jf, _ = jstep(jf, 0.001, it)
    g = gather_field(fs)
    for n in NAMES:
        assert float((getattr(g, n) - getattr(f1, n)).abs().max()) <= 1e-12
    for a in ("max_velocity", "max_pressure", "max_temperature"):
        assert abs(float(getattr(res, a)) - float(getattr(res1, a))) \
            <= 1e-12, a
    assert int(res.status) == 0
    assert_close(fs, jf, 1e-9, 1e-9)


def test_high_matches_reference_high_sharded():
    P = 4
    jgrid = JGrid.uniform(128, 8 * P, 16, zmin=0.0, zmax=1.0)
    arrays = random_arrays(jgrid.shape, seed=21)
    jstep = jax.jit(make_fused_sharded_projection_step(
        jgrid, JParams(), j_make_mesh(jax.devices()[:P], axes=("z",)),
        spectral_precision=lax.Precision.HIGH))
    step, place = make_sharded_step(grid_from(jgrid), NSParams(), _zmesh(P),
                                    dtype=torch.float32,
                                    spectral_precision="high")
    jf, jres = jstep(JField(**{n: jnp.asarray(a)
                               for n, a in arrays.items()}), 0.001, 0)
    fs, res = step(place(field_from_numpy(arrays, "cpu", torch.float32)),
                   1e-3, 0)
    assert int(res.status) == int(jres.status) == 0
    assert_close(fs, jf, 1e-4, 2e-3)


def _uniform(nx=40, ny=16, nz=8):
    return Grid.uniform(nx, ny, nz, zmin=0.0, zmax=1.0)


REFUSALS = {
    # a 2D grid runs on a y-only mesh, and there FFT_DIRECT only
    "2d": (lambda: (Grid.uniform(40, 16), NSParams(), _zmesh(2), {}),
           "fused sharded 2D projection needs a y-only mesh"),
    "2d cg": (lambda: (Grid.uniform(40, 16), NSParams(),
                       make_mesh([CPU] * 4, axes=("y",)),
                       {"poisson_method": Method.CG}),
              "no fused sharded 2D CG pressure solve (FFT_DIRECT only)"),
    "2d pencil": (lambda: (Grid.uniform(42, 16), NSParams(),
                           make_mesh([CPU] * 4, axes=("y",)), {}),
                  "2D pencil DST path (nx=42 not divisible by 4 shards) "
                  "is not ported yet"),
    # the energy equation and buoyancy run on every mesh
    # (tests/test_torch_parallel_thermal*.py); a heat source, a
    # stretched grid in the parity scheme and a face the energy step has
    # no rule for stay refused
    "2d energy": (lambda: (Grid.uniform(40, 16), NSParams(
        alpha=1e-3, heat_source_func=lambda *a: 0.0),
        make_mesh([CPU] * 4, axes=("y",)), {}),
        "a heat_source callable is not ported yet"),
    "2d rows": (lambda: (Grid.uniform(40, 6), NSParams(),
                         make_mesh([CPU] * 4, axes=("y",)), {}),
                "ny=6 must be divisible by 4 shards"),
    # a (z, y) mesh runs FFT_DIRECT, CG and BiCGSTAB; BiCGSTAB there
    # needs ny divisible as the others do
    "zy mesh": (lambda: (_uniform(ny=15), NSParams(),
                         make_mesh([CPU] * 4, axes=("z", "y")),
                         {"poisson_method": Method.BICGSTAB}),
                "ny=15 must be divisible by 2 y-shards"),
    "y mesh": (lambda: (_uniform(), NSParams(),
                        make_mesh([CPU] * 2, axes=("y",)), {}),
               "needs a mesh over"),
    "cg": (lambda: (_uniform(), NSParams(), _zmesh(2),
                    {"poisson_method": Method.CG,
                     "poisson_params": PoissonParams(
                         preconditioner=Precond.MULTIGRID)}),
           "CG kernel build failed"),
    "bicgstab": (lambda: (_uniform(), NSParams(), _zmesh(2),
                          {"poisson_method": Method.BICGSTAB,
                           "poisson_params": PoissonParams(
                               preconditioner=Precond.JACOBI)}),
                 "BiCGSTAB kernel build failed"),
    # the sharded multigrid step takes 2^k+1 grids (tests/test_torch_
    # parallel_mg.py); this one is not coarsenable
    "multigrid": (lambda: (_uniform(), NSParams(), _zmesh(2),
                           {"poisson_method": Method.MULTIGRID}),
                  "coarsenable"),
    # the consistent scheme runs on a z mesh, FFT_DIRECT only
    # (tests/test_torch_parallel_consistent.py)
    "consistent": (lambda: (Grid.stretched(40, 16, 8, zmin=0.0, zmax=1.0,
                                           beta=1.5),
                            NSParams(nonuniform_scheme="consistent"),
                            _zmesh(2), {"poisson_method": Method.CG}),
                   "consistent-scheme fused sharded projection supports "
                   "the FFT_DIRECT pressure solve only (got CG)"),
    "energy": (lambda: (Grid.stretched(40, 16, 8, zmin=0.0, zmax=1.0,
                                       beta=1.5, stretch_axes="xy"),
                        NSParams(alpha=1e-3), _zmesh(2), {}),
               "energy_solver: non-uniform dx/dy not supported"),
    "buoyancy": (lambda: (_uniform(), NSParams(
        alpha=1e-3, beta=3e-3, gravity=(0.0, -9.81, 0.0),
        thermal_bc=ThermalBCConfig(top=BCType.NOSLIP)), _zmesh(2), {}),
        "only PERIODIC, NEUMANN, DIRICHLET are valid", Status.ERROR_INVALID),
    # "default" runs (tests/test_torch_parallel_precision.py); a name
    # outside highest / high / default does not
    "default precision": (lambda: (_uniform(), NSParams(), _zmesh(2),
                                   {"spectral_precision": "bf16"}),
                          "unknown spectral_precision='bf16'"),
    "nz not divisible": (lambda: (_uniform(nz=9), NSParams(), _zmesh(2),
                                  {}), "nz=9 must be divisible"),
    "one plane a shard": (lambda: (_uniform(nz=8), NSParams(), _zmesh(8),
                                   {}), ">= 2 planes"),
    "pencil fallback": (lambda: (_uniform(ny=15), NSParams(), _zmesh(2),
                                 {}), "pencil-transpose"),
    # the decomposed Euler step runs on a z mesh: a 2D grid on one
    # stays outside it
    "euler": (lambda: (Grid.uniform(40, 16), NSParams(), _zmesh(2),
                       {"method": "explicit_euler"}),
              "explicit_euler unavailable: fused sharded 2D euler needs a "
              "y-only mesh"),
    "gspmd": (lambda: (_uniform(), NSParams(), _zmesh(2),
                       {"use_pallas": False}), "GSPMD"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_outside_the_slice_raises_with_its_reason(case):
    build, reason, *status = REFUSALS[case]
    grid, params, mesh, kw = build()
    method = kw.pop("method", "projection")
    for maker in (make_sharded_step, make_sharded_raw_step):
        with pytest.raises(CFDError) as err:
            maker(grid, params, mesh, method, **dict(kw))
        assert err.value.status == (status or [Status.ERROR_UNSUPPORTED])[0]
        assert reason in str(err.value)


@pytest.mark.parametrize("maker", [make_sharded_step, make_sharded_raw_step],
                         ids=["step", "raw_step"])
def test_unknown_keyword_raises(maker):
    """A keyword the sharded builders do not know is a TypeError, not
    silently dropped (the reference's ``strict``, ``use_pallas_cg`` and
    ``pallas_interpret`` are known: `tests/test_torch_parallel_cg.py`)."""
    with pytest.raises(TypeError, match="stirct"):
        maker(_uniform(), NSParams(), _zmesh(2), "projection", stirct=False)
