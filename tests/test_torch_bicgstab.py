"""The port's BiCGSTAB pressure solve against the reference's
(`cfd_tpu/solvers/poisson/krylov.py`, `ops/pallas/bicgstab_kernels.py`,
`ops/pallas/vmem_small.py`), on the CPU.

* the plain ``pass_pv`` / ``pass_st`` / ``pass_xr`` against the TPU
  kernels in interpret mode (float32) and against the jnp composition
  (float64);
* ``make_bicgstab`` (the plain twin) against the reference's jnp
  ``make_bicgstab`` in float64: equal iteration counts and statuses, x
  within 1e-9·max|x|;
* ``make_bicgstab_fused`` and ``make_bicgstab_vmem`` (the kernel makers,
  on the CPU their plain versions) against the reference's fused makers
  in interpret mode, float32, at the reference's own bars;
* the closing rules — a zero rhs, a two-iteration cap, a breakdown — in
  all three makers against the reference's same makers, float64;
* the fused loop's chunked host check (chunks of 1 and 16 agree).

Both packages get the same numpy inputs from ``np.random.default_rng``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_tpu.ops.pallas.bicgstab_kernels import BiCGSTABKernels
from cfd_tpu.solvers.poisson import krylov as jkrylov
from cfd_tpu.solvers.poisson.base import PoissonParams as JParams
from cfd_tpu.solvers.poisson.base import PoissonProblem as JProblem
from cfd_tpu_torch.ops.kernels import bicgstab_kernels as bk
from cfd_tpu_torch.solvers.poisson import krylov
from cfd_tpu_torch.solvers.poisson.base import (PoissonParams,
                                                PoissonProblem,
                                                PoissonStatus)

torch.set_num_threads(min(2, torch.get_num_threads()))


def _problems(shape, h=None):
    nz, ny, nx = shape
    if h is None:
        h = (1.0 / (nx - 1), 1.0 / (ny - 1),
             1.0 / (nz - 1) if nz > 1 else 0.0)
    return PoissonProblem(nx, ny, nz, *h), JProblem(nx, ny, nz, *h)


def _consts(prob):
    return bk.BiCGConsts(*prob.shape, prob.inv_dx2, prob.inv_dy2,
                         prob.inv_dz2)


def _zero_shell(a):
    out = np.zeros_like(a)
    sl = (slice(1, -1) if a.shape[0] > 1 else slice(None), slice(1, -1),
          slice(1, -1))
    out[sl] = a[sl]
    return out


def _fields(shape, n, seed, np_dt):
    rng = np.random.default_rng(seed)
    return [_zero_shell(rng.normal(size=shape)).astype(np_dt)
            for _ in range(n)]


BETA, OMEGA, ALPHA = 0.7, 0.3, 0.4


# ---- the passes ---------------------------------------------------------------

def test_passes_match_reference_kernels_f32():
    """Against the TPU passes in interpret mode at 6×16×128 (the shape of
    `tests/math/test_fused_solvers.py:28`), the reference's bars
    (`:130-165`): fields within 1e-5·max + 1e-7, dots within
    1e-4·|ref| + 1.0; the port's shells are exact zeros and x keeps its
    shell."""
    shape = (6, 16, 128)
    prob, jprob = _problems(shape, (0.1, 0.2, 0.15))
    c = _consts(prob)
    k = BiCGSTABKernels(*shape, jprob.inv_dx2, jprob.inv_dy2,
                        jprob.inv_dz2, interpret=True)
    r, p, v, rhat = _fields(shape, 4, 3, np.float32)
    x = np.random.default_rng(7).normal(size=shape).astype(np.float32)
    t = {n: torch.tensor(a) for n, a in zip("rpvh", (r, p, v, rhat))}

    def close(got, ref):
        ref = np.asarray(ref)
        np.testing.assert_allclose(
            np.asarray(got), ref, rtol=0,
            atol=1e-5 * np.abs(ref).max() + 1e-7)

    def dot_close(got, ref):
        assert abs(float(got) - float(ref)) <= 1e-4 * abs(float(ref)) + 1.0

    jpn, jvn, jrhv = k.pass_pv(*map(jnp.asarray, (r, p, v, rhat)), BETA,
                               OMEGA)
    pn, vn, rhv = bk.pass_pv(t["r"], t["p"], t["v"], t["h"], BETA, OMEGA, c)
    inner = (slice(1, -1),) * 3
    close(pn, jpn)
    close(vn.numpy()[inner], np.asarray(jvn)[inner])
    dot_close(rhv, jrhv)
    js_, jt, jss, jts, jtt = k.pass_st(jnp.asarray(r), jvn, ALPHA)
    s, tt_, ss, ts, tt = bk.pass_st(t["r"], torch.tensor(np.asarray(jvn)),
                                    ALPHA, c)
    close(s, js_)
    close(tt_.numpy()[inner], np.asarray(jt)[inner])
    for got, ref in ((ss, jss), (ts, jts), (tt, jtt)):
        dot_close(got, ref)
    jx2, jr2, jrr, jrh = k.pass_xr(jnp.asarray(x), jpn, js_, jt,
                                   jnp.asarray(rhat), ALPHA, OMEGA)
    x2, r2, rr, rh = bk.pass_xr(
        torch.tensor(x), *(torch.tensor(np.asarray(a))
                           for a in (jpn, js_, jt)), t["h"], ALPHA, OMEGA, c)
    close(x2, jx2)
    close(r2.numpy()[inner], np.asarray(jr2)[inner])
    dot_close(rr, jrr)
    dot_close(rh, jrh)
    shell = np.ones(shape, bool)
    shell[inner] = False
    for f in (pn, vn, s, tt_, r2):
        assert not f.numpy()[shell].any()
    np.testing.assert_array_equal(x2.numpy()[shell], x[shell])


def test_passes_match_jnp_composition_f64():
    """Against the jnp operations of `make_bicgstab` (`krylov.py:413-431`)
    in float64 at 37×23×11: fields within 1e-12·max, dots within 1e-12
    relative."""
    shape = (11, 23, 37)
    prob, jprob = _problems(shape)
    c = _consts(prob)
    r, p, v, rhat, x = _fields(shape, 5, 4, np.float64)
    j = dict(zip("rpvhx", map(jnp.asarray, (r, p, v, rhat, x))))

    def A(q):
        return jprob.zero_boundary(-jprob.laplacian(q))

    pn_ref = j["r"] + BETA * (j["p"] - OMEGA * j["v"])
    vn_ref = A(pn_ref)
    s_ref = j["r"] - ALPHA * vn_ref
    t_ref = A(s_ref)
    x_ref = j["x"] + ALPHA * pn_ref + OMEGA * s_ref
    r_ref = s_ref - OMEGA * t_ref
    dot = jprob.dot_interior
    pn, vn, rhv = bk.pass_pv(*map(torch.tensor, (r, p, v, rhat)), BETA,
                             OMEGA, c)
    s, t, ss, ts, tt = bk.pass_st(torch.tensor(r), vn, ALPHA, c)
    x2, r2, rr, rh = bk.pass_xr(torch.tensor(x), pn, s, t,
                                torch.tensor(rhat), ALPHA, OMEGA, c)
    for got, ref in ((pn, pn_ref), (vn, vn_ref), (s, s_ref), (t, t_ref),
                     (x2, x_ref), (r2, r_ref)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=1e-12 * np.abs(ref).max())
    for got, ref in ((rhv, dot(j["h"], vn_ref)), (ss, dot(s_ref, s_ref)),
                     (ts, dot(t_ref, s_ref)), (tt, dot(t_ref, t_ref)),
                     (rr, dot(r_ref, r_ref)), (rh, dot(j["h"], r_ref))):
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-12)


# ---- the solves ------------------------------------------------------------------

def _rhs(shape, noise=0.005, seed=3):
    """The sin·sin(·sin) eigenvector plus a little noise, zero shell.
    BiCGSTAB's trajectory is hypersensitive to the dots' summation order
    (`tests/math/test_vmem_small.py:142-145`): in float64 two orders part
    by ~1e-7 after about 30 iterations of a rough rhs.  This rhs converges
    at tolerance 1e-3 within 25 iterations, before that."""
    nz, ny, nx = shape
    y = np.linspace(0, 1, ny)[None, :, None]
    x = np.linspace(0, 1, nx)[None, None, :]
    out = np.sin(np.pi * x) * np.sin(np.pi * y) * np.ones(shape)
    if nz > 1:
        out = out * np.sin(np.pi * np.linspace(0, 1, nz))[:, None, None]
    out = out + noise * np.random.default_rng(seed).normal(size=shape)
    return _zero_shell(out)


@pytest.mark.parametrize("start", ["zero", "random"])
@pytest.mark.parametrize("ci", [1, 3])
@pytest.mark.parametrize("shape", [(11, 23, 37), (1, 33, 65)],
                         ids=["37x23x11", "65x33"])
def test_make_bicgstab_matches_reference_f64(shape, ci, start):
    prob, jprob = _problems(shape)
    kw = dict(tolerance=1e-3, max_iterations=500, check_interval=ci)
    rhs = _rhs(shape)
    x0 = (np.zeros(shape) if start == "zero"
          else np.random.default_rng(7).normal(0.0, 0.1, shape))
    res = krylov.make_bicgstab(prob, PoissonParams(**kw))(
        torch.tensor(x0), torch.tensor(rhs))
    jres = jkrylov.make_bicgstab(jprob, JParams(**kw))(jnp.asarray(x0),
                                                       jnp.asarray(rhs))
    assert int(res.iterations) == int(jres.iterations) > 1
    assert int(res.status) == int(jres.status) == PoissonStatus.CONVERGED
    ref = np.asarray(jres.x)
    np.testing.assert_allclose(res.x.numpy(), ref, rtol=0,
                               atol=1e-9 * np.abs(ref).max())
    # the converged residual is a thousandth of the initial one, so the
    # rounding in x shows there a thousandfold
    np.testing.assert_allclose(float(res.final_residual),
                               float(jres.final_residual), rtol=1e-6)


def _point_rhs(shape):
    rhs = np.zeros(shape, np.float32)
    rhs[shape[0] // 2, shape[1] // 2, 60] = 100.0
    rhs[1, 2, 20] = -40.0
    return rhs


@pytest.mark.parametrize("ci", [1, 3])
def test_make_bicgstab_fused_matches_reference_f32(ci):
    """The reference's bar (`tests/math/test_fused_solvers.py:168-186`):
    ±3 iterations, both CONVERGED, x within 1e-3·max|x|, float32, 6×16×128,
    point rhs, h = 0.05."""
    shape = (6, 16, 128)
    prob, jprob = _problems(shape, (0.05, 0.05, 0.05))
    kw = dict(tolerance=1e-5, max_iterations=300, check_interval=ci)
    rhs = _point_rhs(shape)
    x0 = np.zeros(shape, np.float32)
    jres = jkrylov.make_bicgstab_fused(jprob, JParams(**kw), jnp.float32,
                                       interpret=True)(jnp.asarray(x0),
                                                       jnp.asarray(rhs))
    res = krylov.make_bicgstab_fused(prob, PoissonParams(**kw),
                                     torch.float32, "cpu")(
        torch.tensor(x0), torch.tensor(rhs))
    assert abs(int(res.iterations) - int(jres.iterations)) <= 3
    assert int(res.status) == int(jres.status) == PoissonStatus.CONVERGED
    ref = np.asarray(jres.x)
    np.testing.assert_allclose(res.x.numpy(), ref, rtol=0,
                               atol=1e-3 * np.abs(ref).max())


@pytest.mark.parametrize("shape", [(1, 100, 100), (12, 16, 20)],
                         ids=["100x100", "20x16x12"])
def test_make_bicgstab_vmem_matches_reference_f32(shape):
    """The reference's bars (`tests/math/test_vmem_small.py:141-162`,
    `:249-265`): both CONVERGED, the recursion residual below tol·r0, x
    within 5e-4, and in 2D at most twice the reference's iterations."""
    prob, jprob = _problems(shape)
    kw = dict(tolerance=1e-5, max_iterations=1000)
    rng = np.random.default_rng(3)
    rhs = rng.normal(0.0, 1.0, shape).astype(np.float32)
    x0 = np.zeros(shape, np.float32)
    jres = jax.jit(jkrylov.make_bicgstab_vmem(
        jprob, JParams(**kw), dtype=jnp.float32, interpret=True))(
        jnp.asarray(x0), jnp.asarray(rhs))
    res = krylov.make_bicgstab_vmem(prob, PoissonParams(**kw),
                                    torch.float32, "cpu")(
        torch.tensor(x0), torch.tensor(rhs))
    assert int(res.status) == int(jres.status) == PoissonStatus.CONVERGED
    assert float(res.final_residual) < 1e-5 * float(res.initial_residual)
    if shape[0] == 1:
        assert 0 < int(res.iterations) <= 2 * int(jres.iterations)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(jres.x), rtol=0,
                               atol=5e-4)


CLOSING = {
    # converged before the loop: 0 iterations, the initial residual
    "zero_rhs": (dict(), "zero", (0, PoissonStatus.CONVERGED)),
    "max_iter": (dict(tolerance=0.0, max_iterations=2), "random",
                 (2, PoissonStatus.MAX_ITER)),
    # ρ = ⟨r̂, r⟩ below 1e-30 at once: breakdown, x unchanged
    "breakdown": (dict(absolute_tolerance=0.0), "tiny",
                  (1, PoissonStatus.STAGNATED)),
}


@pytest.mark.parametrize("maker", ["make_bicgstab", "make_bicgstab_fused",
                                   "make_bicgstab_vmem"])
@pytest.mark.parametrize("case", sorted(CLOSING))
def test_closing_rules_match_reference_f64(case, maker):
    """Iterations, status and final residual equal to the reference's same
    maker (the fused and whole-solve ones in interpret mode, float64)."""
    kw, kind, expect = CLOSING[case]
    shape = (6, 16, 128)
    prob, jprob = _problems(shape, (0.05, 0.05, 0.05))
    rhs = {"zero": np.zeros(shape),
           "random": _zero_shell(np.random.default_rng(5).normal(
               size=shape)),
           "tiny": 1e-20 * _zero_shell(np.random.default_rng(5).normal(
               size=shape))}[kind]
    x0 = np.zeros(shape)
    jmk = getattr(jkrylov, maker)
    jkw = {} if maker == "make_bicgstab" else dict(dtype=jnp.float64,
                                                   interpret=True)
    jres = jmk(jprob, JParams(**kw), **jkw)(jnp.asarray(x0),
                                            jnp.asarray(rhs))
    res = getattr(krylov, maker)(prob, PoissonParams(**kw), torch.float64,
                                 "cpu")(torch.tensor(x0), torch.tensor(rhs))
    assert (int(res.iterations), int(res.status)) == (
        int(jres.iterations), int(jres.status)) == expect
    np.testing.assert_allclose(float(res.final_residual),
                               float(jres.final_residual), rtol=1e-10)
    np.testing.assert_allclose(float(res.initial_residual),
                               float(jres.initial_residual), rtol=1e-10)


@pytest.mark.parametrize("kind", ["random", "zero", "tiny"])
def test_fused_loop_chunks_agree(kind, monkeypatch):
    """The host reads the running flag once per chunk; iterations queued
    past the stop are frozen no-ops, so chunks of 1 and 16 give the same
    count, status, residual and x."""
    shape = (12, 10, 14)
    prob, _ = _problems(shape)
    params = PoissonParams(
        tolerance=1e-6, max_iterations=50,
        absolute_tolerance=0.0 if kind == "tiny" else 1e-10)
    rhs = {"random": _rhs(shape, 0.1), "zero": np.zeros(shape),
           "tiny": 1e-20 * _rhs(shape, 0.1)}[kind]
    results = []
    for chunk in (1, 16):
        monkeypatch.setattr(krylov, "CHUNK", chunk)
        results.append(krylov.make_bicgstab_fused(prob, params,
                                                  torch.float64, "cpu")(
            torch.zeros(shape, dtype=torch.float64), torch.tensor(rhs)))
    a, b = results
    assert int(a.iterations) == int(b.iterations) < 50
    assert int(a.status) == int(b.status)
    assert torch.equal(a.final_residual, b.final_residual)
    assert torch.equal(a.x, b.x)


def test_solvers_leave_their_inputs_alone():
    """x0 (a step's field.p) and rhs come back unchanged."""
    shape = (8, 9, 10)
    prob, _ = _problems(shape)
    x0 = torch.tensor(np.random.default_rng(4).normal(size=shape))
    rhs = torch.tensor(_rhs(shape, 0.1))
    keep = (x0.clone(), rhs.clone())
    for maker in (krylov.make_bicgstab, krylov.make_bicgstab_fused,
                  krylov.make_bicgstab_vmem):
        maker(prob, PoissonParams(max_iterations=20))(x0, rhs)
        assert torch.equal(x0, keep[0]) and torch.equal(rhs, keep[1])
