"""The port's projection step with the BiCGSTAB, Red-Black SOR and Jacobi
pressure solves against the reference's (`cfd_tpu/solvers/ns/
projection.py`, ``poisson_method`` BICGSTAB, REDBLACK_SOR, JACOBI), on
the CPU.

* 3D 17×12×10 and 2D 33×24, float64, 3 steps, against the reference's jnp
  step: the same statuses and solve residuals, the fields within 1e-9;
* 3D 128×16×8 and 2D 128×16, float32, 2 steps, against the reference's
  step with ``use_pallas=True`` in interpret mode, at the CG step's bars;
* the kernel choice: the BiCGSTAB passes and the Red-Black SOR sweep in
  3D, the whole-solve wrappers in 2D, Jacobi's whole solve in both;
* a solve that does not converge fails the step with −7, as in the
  reference.

The reference's step runs its whole-solve kernels where the grid fits VMEM
and its jnp makers otherwise (Jacobi always); the port runs its kernels on
every size — the same arithmetic, so the bars are the CG step's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_tpu import FlowField as JField
from cfd_tpu import Grid as JGrid
from cfd_tpu.solvers.ns import NSParams as JParams
from cfd_tpu.solvers.ns.projection import \
    make_projection_step as j_make_step
from cfd_tpu.solvers.poisson.base import Method as JMethod
from cfd_tpu.solvers.poisson.base import PoissonParams as JPParams
from cfd_tpu_torch import Grid
from cfd_tpu_torch.interop import field_from_numpy
from cfd_tpu_torch.ops.kernels import bicgstab_kernels as bk
from cfd_tpu_torch.ops.kernels import rbsor_kernels as sk
from cfd_tpu_torch.ops.kernels import vmem_small
from cfd_tpu_torch.solvers.ns.params import NSParams
from cfd_tpu_torch.solvers.ns.projection import make_projection_step
from cfd_tpu_torch.solvers.poisson.base import Method, PoissonParams

torch.set_num_threads(min(2, torch.get_num_threads()))

FIELDS = ("u", "v", "w", "p")
DT = 0.001
METHODS = [Method.BICGSTAB, Method.REDBLACK_SOR, Method.JACOBI]
IDS = ["bicgstab", "redblack_sor", "jacobi"]


def _random_numpy_field(shape, seed, np_dt, amp=0.1):
    rng = np.random.default_rng(seed)
    out = {n: rng.normal(0.0, amp, shape).astype(np_dt) for n in FIELDS}
    out["rho"] = np.ones(shape, np_dt)
    out["T"] = np.full(shape, 300.0, np_dt)
    return out


def _grids(shape):
    nz, ny, nx = shape
    if nz == 1:
        return Grid.uniform(nx, ny), JGrid.uniform(nx, ny)
    return (Grid.uniform(nx, ny, nz, zmin=0.0, zmax=1.0),
            JGrid.uniform(nx, ny, nz, zmin=0.0, zmax=1.0))


def _run_both(method, shape, np_dt, jnp_kwargs, n_steps, pparams, seed=0):
    params = dict(source_amplitude_u=0.1, source_amplitude_v=0.05)
    arrays = _random_numpy_field(shape, seed, np_dt)
    jdt = jnp.float32 if np_dt == np.float32 else jnp.float64
    tdt = torch.float32 if np_dt == np.float32 else torch.float64
    g, jg = _grids(shape)
    jstep = jax.jit(j_make_step(jg, JParams(**params), dtype=jdt,
                                poisson_method=JMethod(int(method)),
                                poisson_params=JPParams(**pparams),
                                **jnp_kwargs))
    step = make_projection_step(g, NSParams(**params), dtype=tdt,
                                poisson_method=method,
                                poisson_params=PoissonParams(**pparams),
                                device="cpu")
    jf = JField(**{n: jnp.asarray(a) for n, a in arrays.items()})
    tf = field_from_numpy(arrays, "cpu", tdt)
    out = []
    for i in range(n_steps):
        jf, jr = jstep(jf, DT, i)
        tf, tr = step(tf, DT, i)
        out.append((jf, jr, tf, tr, int(step.last_poisson.iterations)))
    return out


def _assert_close(out, atol_uvw, p_rtol, p_atol_rel, converged=True):
    """Equal statuses (0 when ``converged``), a solve that iterated, the
    fields within the bars.  (The reference's StepResult counts steps,
    not solve iterations; its residual is the solve's.)"""
    for jf, jr, tf, tr, its in out:
        assert int(tr.status) == int(jr.status)
        if converged:
            assert int(tr.status) == 0
        assert its > 0
        for n in ("u", "v", "w"):
            np.testing.assert_allclose(getattr(tf, n).numpy(),
                                       np.asarray(getattr(jf, n)), rtol=0,
                                       atol=atol_uvw, err_msg=n)
        p_ref = np.asarray(jf.p)
        np.testing.assert_allclose(tf.p.numpy(), p_ref, rtol=p_rtol,
                                   atol=p_atol_rel * np.abs(p_ref).max(),
                                   err_msg="p")
        np.testing.assert_allclose(float(tr.max_velocity),
                                   float(jr.max_velocity), rtol=1e-6)


# Solve parameters.  BiCGSTAB's trajectory is hypersensitive to the dots'
# summation order (tests/test_torch_bicgstab.py::_rhs): float64 runs part
# after ~20 iterations of these rough fields, so the float64 steps solve
# to 1e-2; in float32 two solves converged to the default 1e-6 differ in p
# by up to 1.7× the bar (the solve's own error), to 1e-7 by 0.16×.  The
# stationary solves stall on these fields: the discrete Neumann problem's
# rhs is not compatible, in the reference's steps too (its float64 jnp
# step returns −7 from the second cavity step on), so they run a budget
# and the statuses are compared, not required to be 0.
F64_PARAMS = {Method.BICGSTAB: dict(tolerance=1e-2),
              Method.REDBLACK_SOR: dict(tolerance=1e-3, max_iterations=400),
              Method.JACOBI: dict(tolerance=1e-3, max_iterations=400)}
F32_PARAMS = {Method.BICGSTAB: dict(tolerance=1e-7),
              Method.REDBLACK_SOR: dict(tolerance=1e-3, max_iterations=400),
              Method.JACOBI: dict(tolerance=1e-3, max_iterations=400)}


@pytest.mark.parametrize("shape", [(10, 12, 17), (1, 24, 33)],
                         ids=["17x12x10", "33x24"])
@pytest.mark.parametrize("method", METHODS, ids=IDS)
def test_step_matches_jnp_reference_f64(method, shape):
    """Against the reference's jnp step, float64, 3 steps: the same
    iterations and status a step, the fields within 1e-9, the solve's
    residual within 1e-5 relative."""
    out = _run_both(method, shape, np.float64, dict(use_pallas=False), 3,
                    F64_PARAMS[method])
    _assert_close(out, 1e-9, 0.0, 1e-9, method == Method.BICGSTAB)
    for _, jr, _, tr, _ in out:
        np.testing.assert_allclose(float(tr.residual), float(jr.residual),
                                   rtol=1e-5)


@pytest.mark.parametrize("shape", [(8, 16, 128), (1, 16, 128)],
                         ids=["128x16x8", "128x16"])
@pytest.mark.parametrize("method", METHODS, ids=IDS)
def test_step_matches_fused_reference_f32(method, shape):
    """Against the reference's step with its Pallas kernels in interpret
    mode, float32, 2 steps: u, v, w within atol 1e-4 (the reference's
    fused-vs-jnp projection bar, `tests/math/test_vmem_small.py:198-199`),
    p within rtol 1e-3 / atol 1e-4·max|p|
    (`tests/math/test_pallas_kernels.py:119-120`)."""
    out = _run_both(method, shape, np.float32,
                    dict(use_pallas=True, pallas_interpret=True), 2,
                    F32_PARAMS[method])
    _assert_close(out, 1e-4, 1e-3, 1e-4, method == Method.BICGSTAB)


@pytest.mark.parametrize("shape", [(6, 10, 12), (1, 10, 12)],
                         ids=["3d", "2d"])
def test_kernel_choice(shape, monkeypatch):
    """float32 steps take their method's kernel wrappers: the BiCGSTAB
    passes and the Red-Black SOR sweep in 3D, the whole-solve wrappers in
    2D, Jacobi's whole solve in both (their plain versions on the CPU)."""
    calls = []

    def spy(module, name):
        fn = getattr(module, name)

        def wrapped(*a, **k):
            calls.append(name)
            return fn(*a, **k)

        monkeypatch.setattr(module, name, wrapped)

    for module, name in ((vmem_small, "rbsor_solve"),
                         (vmem_small, "jacobi_solve"),
                         (vmem_small, "bicgstab_solve"),
                         (sk, "rbsor_sweep_plain"),
                         (bk, "pass_pv_plain")):
        spy(module, name)
    three_d = shape[0] > 1
    expect = {Method.BICGSTAB: "pass_pv_plain" if three_d
              else "bicgstab_solve",
              Method.REDBLACK_SOR: "rbsor_sweep_plain" if three_d
              else "rbsor_solve",
              Method.JACOBI: "jacobi_solve"}
    g, _ = _grids(shape)
    f = field_from_numpy(_random_numpy_field(shape, 3, np.float32), "cpu",
                         torch.float32)
    for method, name in expect.items():
        calls.clear()
        step = make_projection_step(
            g, NSParams(), dtype=torch.float32, poisson_method=method,
            poisson_params=PoissonParams(max_iterations=5), device="cpu")
        step(f, DT, 0)
        assert set(calls) == {name}, (method, calls)


@pytest.mark.parametrize("shape", [(8, 10, 12), (1, 10, 12)],
                         ids=["3d", "2d"])
@pytest.mark.parametrize("method", METHODS, ids=IDS)
def test_unconverged_solve_fails_the_step(method, shape):
    """A cap of 2 iterations: status −7 (MAX_ITER) with the solve's
    residual, as the reference's step."""
    out = _run_both(method, shape, np.float64, dict(use_pallas=False), 1,
                    dict(max_iterations=2))
    jf, jr, tf, tr, its = out[0]
    assert int(tr.status) == int(jr.status) == -7 and its == 2
    np.testing.assert_allclose(float(tr.residual), float(jr.residual),
                               rtol=1e-8)
