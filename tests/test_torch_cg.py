"""The port's CG pressure solve against the reference's
(`cfd_tpu/solvers/poisson/krylov.py`, `ops/pallas/cg_kernels.py`,
`ops/pallas/vmem_small.py`), on the CPU.

* ``make_cg`` (the plain twin) against the reference's jnp ``make_cg`` in
  float64 at 16³ and 100×100: equal iteration counts and statuses, x
  within 1e-10 — plain CG, Jacobi PCG, ``check_interval`` 4, an
  eigenvector right-hand side (1 iteration), a zero one (0 iterations), a
  ``max_iterations`` cap (MAX_ITER) and a breakdown (STAGNATED);
* the plain ``lap_dot`` and ``cg_update`` against the TPU kernels in
  interpret mode (on the interior; x and r shells bit-exact);
* ``make_cg_fused`` and ``make_cg_vmem`` (the kernel makers, on the CPU
  their plain versions) against the reference's fused makers in interpret
  mode, float32, at the reference's own bars (±2 iterations);
* the fused loop's chunked host check: the same count, residual and x for
  chunks of 1 and 16 iterations, including frozen passes after the stop.

Both packages get the same numpy inputs from ``np.random.default_rng``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_tpu.ops.pallas.cg_kernels import (make_cg_update,
                                           make_lap_dot_fused,
                                           make_lap_dot_rolling)
from cfd_tpu.solvers.poisson import krylov as jkrylov
from cfd_tpu.solvers.poisson.base import PoissonParams as JParams
from cfd_tpu.solvers.poisson.base import PoissonProblem as JProblem
from cfd_tpu.solvers.poisson.base import Precond as JPrecond
from cfd_tpu_torch.ops.kernels import cg_kernels as cgk
from cfd_tpu_torch.ops.kernels import vmem_small
from cfd_tpu_torch.solvers.poisson import krylov
from cfd_tpu_torch.solvers.poisson.base import (PoissonParams,
                                                PoissonProblem,
                                                PoissonStatus, Precond,
                                                result_to_stats)

torch.set_num_threads(min(2, torch.get_num_threads()))


def _problems(shape):
    nz, ny, nx = shape
    h = (1.0 / (nx - 1), 1.0 / (ny - 1), 1.0 / (nz - 1) if nz > 1 else 0.0)
    return (PoissonProblem(nx, ny, nz, *h), JProblem(nx, ny, nz, *h))


def _rhs(kind, shape, seed=3, np_dt=np.float64):
    """Zero-shell right-hand sides: random, the sin·sin eigenvector (CG
    converges in one iteration), zero (converged before the loop) and a
    tiny one (⟨p, Ap⟩ below 1e-30: breakdown)."""
    nz, ny, nx = shape
    if kind == "eigen":
        y, x = np.linspace(0, 1, ny), np.linspace(0, 1, nx)
        plane = np.sin(np.pi * y)[:, None] * np.sin(np.pi * x)[None]
        out = np.broadcast_to(plane, shape).copy()
        if nz > 1:
            out *= np.sin(np.pi * np.linspace(0, 1, nz))[:, None, None]
    elif kind == "zero":
        out = np.zeros(shape)
    else:
        out = np.random.default_rng(seed).normal(size=shape)
        if kind == "tiny":
            out *= 1e-20
    sl = (slice(1, -1) if nz > 1 else slice(None), slice(1, -1),
          slice(1, -1))
    z = np.zeros(shape)
    z[sl] = out[sl]
    return z.astype(np_dt)


CASES = {
    "plain": (dict(), "random"),
    "jacobi": (dict(preconditioner=Precond.JACOBI), "random"),
    "check_interval_4": (dict(check_interval=4), "random"),
    "eigenvector": (dict(), "eigen"),
    "zero_rhs": (dict(), "zero"),
    "max_iter": (dict(max_iterations=7), "random"),
    "breakdown": (dict(absolute_tolerance=0.0), "tiny"),
}
EXPECT = {"eigenvector": (1, PoissonStatus.CONVERGED),
          "zero_rhs": (0, PoissonStatus.CONVERGED),
          "max_iter": (7, PoissonStatus.MAX_ITER),
          "breakdown": (1, PoissonStatus.STAGNATED)}


@pytest.mark.parametrize("shape", [(16, 16, 16), (1, 100, 100)],
                         ids=["16^3", "100x100"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_make_cg_matches_reference_f64(case, shape):
    kw, kind = CASES[case]
    prob, jprob = _problems(shape)
    jkw = dict(kw)
    if "preconditioner" in jkw:
        jkw["preconditioner"] = JPrecond(int(jkw["preconditioner"]))
    rhs = _rhs(kind, shape)
    x0 = np.random.default_rng(7).normal(0.0, 0.1, shape)
    if kind != "random":
        x0 = np.zeros(shape)
    res = krylov.make_cg(prob, PoissonParams(**kw))(
        torch.tensor(x0), torch.tensor(rhs))
    jres = jkrylov.make_cg(jprob, JParams(**jkw))(jnp.asarray(x0),
                                                 jnp.asarray(rhs))
    stats = result_to_stats(res)
    assert (stats.iterations, int(stats.status)) == (
        int(jres.iterations), int(jres.status))
    if case in EXPECT:
        assert (stats.iterations, stats.status) == EXPECT[case]
    np.testing.assert_allclose(res.x.numpy(), np.asarray(jres.x), rtol=0,
                               atol=1e-10)
    # a converged residual is rounding: bound it by the initial one
    np.testing.assert_allclose(
        stats.final_residual, float(jres.final_residual), rtol=1e-8,
        atol=1e-10 * float(jres.initial_residual))


def _interior(a):
    return np.asarray(a)[1:-1, 1:-1, 1:-1]


def _consts(prob, scale=1.0):
    return cgk.CGConsts(*prob.shape, prob.inv_dx2, prob.inv_dy2,
                        prob.inv_dz2, scale)


@pytest.mark.nan_shell
@pytest.mark.parametrize("form", ["fused", "rolling"])
def test_lap_dot_matches_reference_kernels(form):
    """p′ within 1e-6 (same operations), Ap′ within 1e-6 of max|Ap′| (the
    reference's roll sums in the same order; a few ulps at 1/h² ≈ 225),
    the dot within 1e-5 relative (another summation order).  Interior
    only: the reference leaves its shells unwritten (NaN in interpret
    mode); the port's are exact zeros."""
    if form == "fused":
        shape, beta, maker = (16, 16, 16), 0.5, make_lap_dot_fused
    else:
        shape, beta, maker = (8, 8, 128), 0.25, make_lap_dot_rolling
    rng = np.random.default_rng(1)
    r, p = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    prob, jprob = _problems(shape)
    ld = maker(*shape, jprob.inv_dx2, jprob.inv_dy2, jprob.inv_dz2, 1.0,
               jnp.float32, interpret=True)
    jpn, jap, jdot = ld(jnp.asarray(r), jnp.asarray(p), beta)
    pn, ap, dot = cgk.lap_dot(torch.tensor(r), torch.tensor(p),
                              torch.tensor(beta), _consts(prob))
    np.testing.assert_allclose(_interior(pn), _interior(jpn), rtol=0,
                               atol=1e-6)
    ref_ap = _interior(jap)
    np.testing.assert_allclose(_interior(ap), ref_ap, rtol=0,
                               atol=1e-6 * np.abs(ref_ap).max())
    assert abs(float(dot) - float(jdot)) <= 1e-5 * abs(float(jdot))
    # the port's shells are exact zeros
    for t in (pn, ap):
        shell = t.clone()
        shell[1:-1, 1:-1, 1:-1] = 0.0
        assert torch.equal(shell, torch.zeros_like(shell))


def test_cg_update_matches_reference_kernel():
    """x′ and r′ within 1 ulp (XLA's CPU backend may contract the
    multiply-add into one rounding, the port rounds twice), their shells
    bit-exact to the inputs', ⟨r′, r′⟩ within 1e-5 relative."""
    shape = (16, 16, 16)
    rng = np.random.default_rng(2)
    x, r, p, ap = (rng.normal(size=shape).astype(np.float32)
                   for _ in range(4))
    prob, jprob = _problems(shape)
    pm = np.asarray(jprob.zero_boundary(jnp.asarray(p)))
    apm = np.asarray(jprob.zero_boundary(jnp.asarray(ap)))
    upd = make_cg_update(*shape, jnp.float32, interpret=True)
    jx, jr, jrr = upd(*map(jnp.asarray, (x, r, pm, apm)), 0.7)
    tx, tr, rr = cgk.cg_update(*map(torch.tensor, (x, r, pm, apm)),
                               torch.tensor(0.7, dtype=torch.float32),
                               _consts(prob))
    for got, ref in ((tx, jx), (tr, jr)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=2 ** -23 * np.abs(ref).max())
    for got, inp in ((tx, x), (tr, r)):
        shell = np.ones(shape, bool)
        shell[1:-1, 1:-1, 1:-1] = False
        np.testing.assert_array_equal(got.numpy()[shell], inp[shell])
    assert abs(float(rr) - float(jrr)) <= 1e-5 * float(jrr)


@pytest.mark.nan_shell
@pytest.mark.parametrize("precond", [Precond.NONE, Precond.JACOBI],
                         ids=["cg", "jacobi"])
def test_make_cg_fused_matches_reference(precond):
    """The reference's bar (`tests/math/test_pallas_kernels.py:103-120`):
    ±2 iterations, x within rtol 1e-3 / atol 1e-4, float32, 16³."""
    shape = (16, 16, 16)
    prob, jprob = _problems(shape)
    params = dict(max_iterations=60)
    rhs = _rhs("random", shape, np_dt=np.float32)
    x0 = np.zeros(shape, np.float32)
    jres = jkrylov.make_cg_fused(
        jprob, JParams(**params, preconditioner=JPrecond(int(precond))),
        jnp.float32, interpret=True)(jnp.asarray(x0), jnp.asarray(rhs))
    res = krylov.make_cg_fused(
        prob, PoissonParams(**params, preconditioner=precond),
        torch.float32, "cpu")(torch.tensor(x0), torch.tensor(rhs))
    assert int(res.status) == int(jres.status) == 0
    assert abs(int(res.iterations) - int(jres.iterations)) <= 2
    np.testing.assert_allclose(res.x.numpy(), np.asarray(jres.x),
                               rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("shape,precond,atol", [
    ((1, 100, 100), Precond.NONE, 1e-5),
    ((12, 16, 20), Precond.NONE, 1e-4),
    ((1, 64, 96), Precond.JACOBI, 1e-4)],
    ids=["100x100", "20x16x12", "96x64_jacobi"])
def test_make_cg_vmem_matches_reference(shape, precond, atol):
    """The reference's bars (`tests/math/test_vmem_small.py:105-136`): ±2
    iterations, equal status, x within atol."""
    prob, jprob = _problems(shape)
    params = dict(tolerance=1e-5, max_iterations=1000)
    rng = np.random.default_rng(5)
    rhs = rng.normal(0.0, 1.0, shape).astype(np.float32)
    x0 = rng.normal(0.0, 0.1, shape).astype(np.float32)
    jfn = jkrylov.make_cg_vmem(
        jprob, JParams(**params, preconditioner=JPrecond(int(precond))),
        dtype=jnp.float32, interpret=True)
    jres = jax.jit(jfn)(jnp.asarray(x0), jnp.asarray(rhs))
    res = krylov.make_cg_vmem(
        prob, PoissonParams(**params, preconditioner=precond),
        torch.float32, "cpu")(torch.tensor(x0), torch.tensor(rhs))
    assert int(res.status) == int(jres.status) == 0
    assert abs(int(res.iterations) - int(jres.iterations)) <= 2
    np.testing.assert_allclose(res.x.numpy(), np.asarray(jres.x), rtol=0,
                               atol=atol)


@pytest.mark.parametrize("kind", ["random", "eigen", "zero", "tiny"])
def test_fused_loop_chunks_agree(kind, monkeypatch):
    """The host checks the running flag once per chunk; iterations queued
    past the stop are frozen no-ops, so chunks of 1 and 16 give the same
    count, status, residual and x — also when the stop comes mid-chunk,
    before the loop (zero rhs) and by breakdown (tiny rhs)."""
    shape = (12, 10, 14)
    prob, _ = _problems(shape)
    params = PoissonParams(
        max_iterations=50,
        absolute_tolerance=0.0 if kind == "tiny" else 1e-10)
    rhs = torch.tensor(_rhs(kind, shape))
    x0 = torch.zeros(shape, dtype=torch.float64)
    results = []
    for chunk in (1, 16):
        monkeypatch.setattr(krylov, "CHUNK", chunk)
        results.append(krylov.make_cg_fused(prob, params, torch.float64,
                                            "cpu")(x0, rhs))
    a, b = results
    assert int(a.iterations) == int(b.iterations) < 50
    assert int(a.status) == int(b.status)
    assert torch.equal(a.final_residual, b.final_residual)
    assert torch.equal(a.x, b.x)
    if kind in ("eigen", "zero", "tiny"):
        ref = {"eigen": EXPECT["eigenvector"], "zero": EXPECT["zero_rhs"],
               "tiny": EXPECT["breakdown"]}[kind]
        assert (int(a.iterations), int(a.status)) == ref


def test_solvers_leave_their_inputs_alone():
    """x0 (a step's field.p) and rhs come back unchanged."""
    shape = (8, 9, 10)
    prob, _ = _problems(shape)
    x0 = torch.tensor(np.random.default_rng(4).normal(size=shape))
    rhs = torch.tensor(_rhs("random", shape))
    keep = (x0.clone(), rhs.clone())
    for maker in (krylov.make_cg, krylov.make_cg_fused, krylov.make_cg_vmem):
        maker(prob, PoissonParams(max_iterations=20))(x0, rhs)
        assert torch.equal(x0, keep[0]) and torch.equal(rhs, keep[1])


def test_multigrid_preconditioner_is_unsupported():
    """The CG makers do not apply the multigrid preconditioner: with
    ``Precond.MULTIGRID`` they run unpreconditioned CG, as the
    reference's do (`krylov.py:37`, `:136-137`; its ``make_cg_vmem``
    falls back to ``make_cg``) — the iterations and x of
    ``Precond.NONE``, and ``make_cg`` those of the reference's jnp one in
    float64. Only the Poisson front end turns it into MG-CG."""
    shape = (8, 8, 8)
    prob, jprob = _problems(shape)
    rhs = _rhs("random", shape)
    x0 = np.zeros(shape)
    mg_params = PoissonParams(preconditioner=Precond.MULTIGRID,
                              max_iterations=60)
    for maker in (krylov.make_cg, krylov.make_cg_fused, krylov.make_cg_vmem):
        got = maker(prob, mg_params)(torch.tensor(x0), torch.tensor(rhs))
        ref = maker(prob, PoissonParams(max_iterations=60))(
            torch.tensor(x0), torch.tensor(rhs))
        assert int(got.iterations) == int(ref.iterations) > 0
        assert int(got.status) == int(ref.status) == PoissonStatus.CONVERGED
        assert torch.equal(got.x, ref.x)
    jres = jkrylov.make_cg(jprob, JParams(preconditioner=JPrecond.MULTIGRID,
                                          max_iterations=60))(
        jnp.asarray(x0), jnp.asarray(rhs))
    res = krylov.make_cg(prob, mg_params)(torch.tensor(x0),
                                          torch.tensor(rhs))
    assert int(res.iterations) == int(jres.iterations)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(jres.x), rtol=0,
                               atol=1e-10)


def test_vmem_solve_returns_the_reference_tuple():
    """(x, r0, res, iterations, running) as the reference kernel's, with
    the Neumann mirror on x."""
    shape = (1, 12, 20)
    prob, _ = _problems(shape)
    fn = vmem_small.make_cg_vmem_solve(
        *shape, prob.inv_dx2, prob.inv_dy2, prob.inv_dz2, 1.0, 1e-6, 1e-10,
        3, 1)
    x, r0, res, it, running = fn(torch.zeros(shape, dtype=torch.float64),
                                 torch.tensor(_rhs("random", shape)))
    assert int(it) == 3 and bool(running) and float(res) < float(r0)
    assert torch.equal(x[:, 0, :], x[:, 1, :])
    assert torch.equal(x[:, :, -1], x[:, :, -2])
