"""``spectral_precision="default"`` (one TF32 pass a product) on the
decomposed FFT_DIRECT steps, on `LocalComm` CPU shards, against the
reference's single-device jnp step at ``lax.Precision.DEFAULT``
(``use_pallas=False``; on a CPU its DEFAULT products are full fp32, the
port's plain products round their operands to TF32 as the card's GEMM
does):

* the z-only step over 4 z-shards, uniform and consistent (the
  eigenbasis products at DEFAULT, as the reference's sharded consistent
  step runs them, `cfd_tpu/parallel/fused.py:424-435`), the (2, 2) step
  (its x DSTs and the dense y/z stage) and the 2D step over 4 y-shards
  (its x DSTs and the slab y solve): p within ``TOL_TF32_STEP`` = 1e-2
  of max|p|, u, v, w within 2e-3 of max(1, max|·|), the bar the
  single-device DEFAULT tests hold (`tests/test_torch_precision_
  default.py` ``F32_BARS``); measured on the CPU: p 1.1e-3 to 1.4e-3
  of max|p|, u, v, w at most 2.2e-4 (HIGHEST: p below 1e-6);
* the route: every product of the z-only step is a "default" one (the
  TF32 GEMM on the card), two a shard a step;
* an unknown precision raises ``ERROR_UNSUPPORTED``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from cfd_tpu import FlowField as JField
from cfd_tpu import Grid as JGrid
from cfd_tpu.solvers.ns import NSParams as JParams
from cfd_tpu.solvers.ns.projection import \
    make_projection_step as j_make_projection_step
from cfd_tpu.solvers.poisson.base import Method as JMethod
from cfd_tpu_torch import Status
from cfd_tpu_torch.core.status import CFDError
from cfd_tpu_torch.interop import field_from_numpy, grid_from
from cfd_tpu_torch.ops.kernels import rolling
from cfd_tpu_torch.parallel import gather_field, make_mesh, make_sharded_step
from cfd_tpu_torch.solvers.ns.params import NSParams

from tests.test_torch_parallel_step import random_arrays

torch.set_num_threads(min(2, torch.get_num_threads()))

CPU = torch.device("cpu")
TOL_TF32_STEP = 1e-2
UVW_BAR = 2e-3
SOURCES = dict(source_amplitude_u=0.1, source_amplitude_v=0.05)

CASES = {
    "z uniform": (lambda: JGrid.uniform(128, 16, 16, zmin=0.0, zmax=1.0),
                  JParams(**SOURCES), ("z",)),
    "z consistent": (lambda: JGrid.stretched(128, 64, 16, zmin=0.0,
                                             zmax=1.0, beta=1.5,
                                             stretch_axes="xy"),
                     JParams(nonuniform_scheme="consistent", **SOURCES),
                     ("z",)),
    "zy 2x2": (lambda: JGrid.uniform(64, 16, 16, zmin=0.0, zmax=1.0),
               JParams(**SOURCES), ("z", "y")),
    "2d 4y": (lambda: JGrid.uniform(128, 64), JParams(), ("y",)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_default_sharded_step_matches_reference_default(case):
    make_grid, jparams, axes = CASES[case]
    jgrid = make_grid()
    arrays = random_arrays(jgrid.shape, seed=31)
    jstep = jax.jit(j_make_projection_step(
        jgrid, jparams, dtype=jnp.float32, use_pallas=False,
        poisson_method=JMethod.FFT_DIRECT,
        spectral_precision=lax.Precision.DEFAULT))
    jf, jres = jstep(JField(**{n: jnp.asarray(a) for n, a in
                               arrays.items()}), 0.001, 0)
    step, place = make_sharded_step(
        grid_from(jgrid), NSParams.from_fields(jparams),
        make_mesh([CPU] * 4, axes=axes), "projection", dtype=torch.float32,
        spectral_precision="default")
    fs, res = step(place(field_from_numpy(arrays, "cpu", torch.float32)),
                   1e-3, 0)
    assert int(res.status) == int(jres.status) == 0
    g = gather_field(fs)
    want_p = np.asarray(jf.p)
    dp = np.abs(g.p.numpy() - want_p).max() / np.abs(want_p).max()
    assert dp <= TOL_TF32_STEP, dp
    # the TF32 products ran: HIGHEST reads below 1e-6 here
    assert dp > 1e-4, dp
    for n in "uvw":
        want = np.asarray(getattr(jf, n))
        err = np.abs(getattr(g, n).numpy() - want).max()
        assert err <= UVW_BAR * max(1.0, np.abs(want).max()), n


def test_default_sharded_route(monkeypatch):
    """The z-only DEFAULT step's products: the forward and the inverse xy
    transform of each shard, each at "default"."""
    calls = []
    orig = rolling.plane_dot

    def spy(x, right, left, precision="highest"):
        calls.append(precision)
        return orig(x, right, left, precision)

    monkeypatch.setattr(rolling, "plane_dot", spy)
    jgrid = CASES["z uniform"][0]()
    step, place = make_sharded_step(
        grid_from(jgrid), NSParams(), make_mesh([CPU] * 4, axes=("z",)),
        "projection", dtype=torch.float32, spectral_precision="default")
    step(place(field_from_numpy(random_arrays(jgrid.shape, seed=2), "cpu",
                                torch.float32)), 1e-3, 0)
    assert calls == ["default"] * 8


@pytest.mark.parametrize("axes", [("z",), ("z", "y"), ("y",)])
def test_unknown_precision_raises(axes):
    jgrid = (JGrid.uniform(64, 16) if axes == ("y",)
             else JGrid.uniform(64, 16, 16, zmin=0.0, zmax=1.0))
    with pytest.raises(CFDError, match="spectral_precision='bf16'") as err:
        make_sharded_step(grid_from(jgrid), NSParams(),
                          make_mesh([CPU] * 4, axes=axes), "projection",
                          spectral_precision="bf16")
    assert err.value.status == Status.ERROR_UNSUPPORTED
