"""The consistent scheme's CG and BiCGSTAB projection steps on a
stretched grid against the reference's fused interpret step (its
consistent predictor and corrector around the jnp Krylov solve over the
volume-weighted problem, `projection.py:534-540`), float32, 128×16×8,
β = 1.5: the port runs its consistent kernels around the plain loops
(`krylov.make_cg` / `make_bicgstab`), as the reference does.  Fields
within 5e-5, diagnostics within rtol 1e-5
(`test_projection_consistent_fused.py:98-106`)."""

import numpy as np
import pytest
import torch

from cfd_tpu.solvers.poisson.base import Method as JMethod
from cfd_tpu_torch.interop import field_from_numpy
from cfd_tpu_torch.solvers.ns.params import NSParams
from cfd_tpu_torch.solvers.ns.projection import make_projection_step
from cfd_tpu_torch.solvers.poisson.base import Method
from tests.test_torch_consistent_projection import assert_close, run_pair

torch.set_num_threads(min(2, torch.get_num_threads()))


@pytest.fixture(scope="module")
def cg_sources():
    return run_pair(sources=True, seed=3, method=JMethod.CG)


@pytest.fixture(scope="module")
def cg_no_sources():
    return run_pair(sources=False, seed=4, method=JMethod.CG)


@pytest.fixture(scope="module")
def bicgstab_sources():
    return run_pair(sources=True, seed=3, method=JMethod.BICGSTAB)


def test_cg_step_with_sources_matches_fused_reference(cg_sources):
    assert_close(cg_sources)


def test_cg_step_without_sources_matches_fused_reference(cg_no_sources):
    assert_close(cg_no_sources)


def test_bicgstab_step_matches_fused_reference(bicgstab_sources):
    """u, v, w within 5e-5.  p within 2e-4 of max|p|: the float32 loops
    stop at another iterate (the port sums BiCGSTAB's dots in float64,
    `krylov.py`'s module note; the reference in float32), both at the
    solve's tolerance, which the stretched operator's conditioning
    carries to ~1e-3 absolute in p (|p| ≈ 6.5)."""
    run = bicgstab_sources
    assert_close(run, names=("u", "v", "w"))
    p_ref = np.array(run["jf"].p)
    np.testing.assert_allclose(run["tf"].p.numpy(), p_ref, rtol=0,
                               atol=2e-4 * np.abs(p_ref).max())


def test_krylov_steps_report_the_solve(cg_sources):
    """The step keeps the plain loop it runs and its last result, and the
    StepResult carries the solve's final residual."""
    run = cg_sources
    step = make_projection_step(run["grid"], NSParams(**run["kw"]),
                                dtype=torch.float32,
                                poisson_method=Method.CG, device="cpu")
    tf, tr = step(field_from_numpy(run["arrays"], "cpu", torch.float32),
                  0.001, 0)
    assert int(step.last_poisson.status) == 0
    assert int(step.last_poisson.iterations) > 0
    assert float(tr.residual) == float(step.last_poisson.final_residual)
    assert torch.equal(tf.p, run["tf"].p)
