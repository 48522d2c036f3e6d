"""The z-decomposed spectral projection step (`cfd_tpu_torch.parallel.
make_sharded_step`, plain versions on `LocalComm` CPU shards) against the
reference's `make_fused_sharded_projection_step` on a z mesh of P of the
8 virtual devices, float32, its kernels in interpret mode.

At ``Grid.uniform(128, 8·P, 16)`` the reference takes its DST-fused
variant for P = 2, 4 and 8 (`dst_fused_sharded_supported`, as
`__graft_entry__.py:132-134` checks); the fields after 1 and 3 steps are
held at the reference's own sharded bars, atol 5e-6 on u, v, w and 5e-5
on p (`tests/parallel/test_fused_sharded.py:58-64`), the diagnostics at
rtol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_tpu import FlowField as JField
from cfd_tpu import Grid as JGrid
from cfd_tpu.parallel.fused import make_fused_sharded_projection_step
from cfd_tpu.parallel.mesh import make_mesh as j_make_mesh
from cfd_tpu.solvers.ns import NSParams as JParams
from cfd_tpu.solvers.poisson.base import PoissonProblem as JProblem
from cfd_tpu.solvers.poisson.spectral import \
    dst_fused_sharded_supported as j_dst_sharded
from cfd_tpu_torch.interop import field_from_numpy, grid_from
from cfd_tpu_torch.parallel import gather_field, make_mesh, make_sharded_step
from cfd_tpu_torch.solvers.ns.params import NSParams

torch.set_num_threads(min(2, torch.get_num_threads()))

NAMES = ("u", "v", "w", "p", "rho", "T")
CPU = torch.device("cpu")


def random_arrays(shape, seed, dtype=np.float32, amp=0.1):
    """FlowField.initialize's rho and T, random u, v, w, p (the
    reference's `_random_field`, `tests/parallel/test_fused_sharded.py`)."""
    rng = np.random.default_rng(seed)
    out = {n: rng.normal(0.0, amp, shape).astype(dtype) for n in "uvwp"}
    out["rho"] = np.ones(shape, dtype)
    out["T"] = np.full(shape, 300.0, dtype)
    return out


def assert_close(fs, jf, atol_uvw, atol_p):
    g = gather_field(fs)
    for n in "uvw":
        np.testing.assert_allclose(getattr(g, n).numpy(),
                                   np.asarray(getattr(jf, n)), rtol=0,
                                   atol=atol_uvw, err_msg=n)
    np.testing.assert_allclose(g.p.numpy(), np.asarray(jf.p), rtol=0,
                               atol=atol_p, err_msg="p")


@pytest.mark.parametrize("P", [2, 4, 8])
def test_sharded_step_matches_reference_fused_sharded(P):
    jgrid = JGrid.uniform(128, 8 * P, 16, zmin=0.0, zmax=1.0)
    assert j_dst_sharded(JProblem(jgrid.nx, jgrid.ny, jgrid.nz, jgrid.dx0,
                                  jgrid.dy0, jgrid.dz0), P)
    arrays = random_arrays(jgrid.shape, seed=P)
    jmesh = j_make_mesh(jax.devices()[:P], axes=("z",))
    jstep = jax.jit(make_fused_sharded_projection_step(jgrid, JParams(),
                                                       jmesh))
    step, place = make_sharded_step(grid_from(jgrid), NSParams(),
                                    make_mesh([CPU] * P, axes=("z",)),
                                    "projection", dtype=torch.float32)
    jf = JField(**{n: jnp.asarray(a) for n, a in arrays.items()})
    fs = place(field_from_numpy(arrays, "cpu", torch.float32))
    assert len(fs.blocks) == P
    for it in range(3):
        jf, jres = jstep(jf, 0.001, it)
        fs, res = step(fs, 1e-3, it)
        if it in (0, 2):
            assert int(res.status) == int(jres.status) == 0
            assert_close(fs, jf, 5e-6, 5e-5)
            for a in ("max_velocity", "max_pressure", "max_temperature"):
                np.testing.assert_allclose(float(getattr(res, a)),
                                           float(getattr(jres, a)),
                                           rtol=1e-6, err_msg=a)
