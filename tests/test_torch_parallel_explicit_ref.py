"""The decomposed explicit steps against the reference's own sharded
fused steps (``make_sharded_step(..., use_pallas=True, strict=True)`` on
its virtual devices, its kernels in interpret mode), float32, one case a
family, on the CPU:

* Euler over 4 z-shards at 128×16×24 (6 planes a shard; the reference
  runs its single-device kernel on the padded block, the port the
  global-row mode);
* RK2 over the (2, 2) mesh at 128×16×24 (12 planes, 8 rows a shard; the
  reference's 4-row y ring against the port's 2-row one).

(The 2D modes, where the reference takes y pins, are held against its
kernels in `test_torch_parallel_explicit_kernels_2d.py`.)

Random u, v, w, p, the default sources, two steps of dt = 1e-4: the
fields within 5e-6, the reference's own sharded-vs-jnp bar
(`tests/parallel/test_fused_sharded.py:222-224`), the diagnostics within
rtol 1e-6.  RK4 runs the same stage kernels as RK2, four a step (held
against the reference's jnp step in `test_torch_parallel_explicit_steps.
py`).  The port's shards are `LocalComm` CPU shards on the plain
versions of the sharded kernel modes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_tpu import FlowField as JField
from cfd_tpu import Grid as JGrid
from cfd_tpu.parallel import make_mesh as j_make_mesh
from cfd_tpu.parallel import make_sharded_step as j_make_sharded_step
from cfd_tpu.solvers.ns import NSParams as JParams
from cfd_tpu_torch.interop import field_from_numpy, grid_from
from cfd_tpu_torch.parallel import make_mesh, make_sharded_step
from cfd_tpu_torch.solvers.ns.params import NSParams

from tests.test_torch_parallel_explicit_steps import NAMES, _arrays

torch.set_num_threads(min(2, torch.get_num_threads()))

CPU = torch.device("cpu")
CASES = {
    "euler-4z": ("explicit_euler", (128, 16, 24), ("z",), None),
    "rk2-2x2": ("rk2", (128, 16, 24), ("z", "y"), (2, 2)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_explicit_step_matches_reference_sharded(case):
    method, (nx, ny, nz), axes, shape = CASES[case]
    jgrid = (JGrid.uniform(nx, ny, nz, zmin=0.0, zmax=1.0) if nz > 1
             else JGrid.uniform(nx, ny))
    arrays = _arrays(jgrid.shape, 7)
    devices = jax.devices()[:4]
    jmesh = j_make_mesh(devices, axes=axes)
    jstep, jplace = j_make_sharded_step(jgrid, JParams(), jmesh, method,
                                        use_pallas=True, strict=True,
                                        dtype=jnp.float32)
    mesh = make_mesh([CPU] * 4, axes=axes,
                     **({"shape": shape} if shape else {}))
    assert mesh.comm.shape == ((1, 4) if axes == ("y",) else
                               shape or (4, 1))
    step, place = make_sharded_step(grid_from(jgrid), NSParams(), mesh,
                                    method, dtype=torch.float32)
    jf = jplace(JField(**{n: jnp.asarray(a) for n, a in arrays.items()}))
    fs = place(field_from_numpy(arrays, "cpu", torch.float32))
    for it in range(2):
        jf, jres = jstep(jf, 1e-4, it)
        fs, res = step(fs, 1e-4, it)
    assert int(res.status) == int(jres.status) == 0
    g = fs.gather()
    for n in NAMES:
        np.testing.assert_allclose(getattr(g, n).numpy(),
                                   np.asarray(getattr(jf, n)), rtol=0,
                                   atol=5e-6, err_msg=n)
    for a in ("max_velocity", "max_pressure", "max_temperature"):
        np.testing.assert_allclose(float(getattr(res, a)),
                                   float(getattr(jres, a)), rtol=1e-6,
                                   err_msg=a)
