"""The adjoint Poisson solve (`cfd_tpu_torch.solvers.poisson.adjoint`)
against the reference's (`cfd_tpu/solvers/poisson/adjoint.py`), on the
CPU in float64.

Both packages get the same seeded numpy inputs; the gradients of
⟨w, solve(x0, rhs).x⟩ w.r.t. rhs and x0 from ``torch.autograd`` are held
to ``jax.grad`` of the reference's ``make_adjoint_poisson`` within 10× the
solves' tolerance (1e-12 relative, ``TIGHT``): both run the same method's
forward and one extra solve backward, so only their summation orders
differ.  Also: a central finite-difference check of the correction-space
family (as `tests/solvers/test_adjoint.py:49-111`), the exports, and the
refusal of a stationary method on a nonuniform problem.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_tpu import Grid as JGrid
from cfd_tpu.solvers.poisson.adjoint import \
    make_adjoint_poisson as j_make_adjoint
from cfd_tpu.solvers.poisson.base import Method as JMethod
from cfd_tpu.solvers.poisson.base import PoissonParams as JParams
from cfd_tpu.solvers.poisson.base import PoissonProblem as JProblem
from cfd_tpu.solvers.poisson.nonuniform import \
    NonuniformPoissonProblem as JNonuniform
from cfd_tpu_torch import CFDError, Status
from cfd_tpu_torch.interop import grid_from
from cfd_tpu_torch.solvers import poisson
from cfd_tpu_torch.solvers.poisson import adjoint
from cfd_tpu_torch.solvers.poisson.base import (Method, PoissonParams,
                                                PoissonProblem)
from cfd_tpu_torch.solvers.poisson.nonuniform import NonuniformPoissonProblem

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(min(2, torch.get_num_threads()))

TIGHT = dict(tolerance=1e-12, absolute_tolerance=1e-13, max_iterations=4000)
# the stationary sweeps converge slowly: more of them, as the reference's
# test gives them (`test_adjoint.py:96-98`)
STATIONARY = dict(TIGHT, max_iterations=20000)
GRAD_RTOL = 10 * TIGHT["tolerance"]


def _problems(shape):
    nz, ny, nx = shape
    dz = 1.0 / (nz - 1) if nz > 1 else 0.0
    args = (nx, ny, nz, 1.0 / (nx - 1), 1.0 / (ny - 1), dz)
    return PoissonProblem(*args), JProblem(*args)


def _stretched():
    jg = JGrid.stretched(17, 17, beta=1.5, stretch_axes="xy")
    return (NonuniformPoissonProblem.from_grid(grid_from(jg)),
            JNonuniform.from_grid(jg))


def _interior(shape):
    return (slice(1, -1) if shape[0] > 1 else slice(None), slice(1, -1),
            slice(1, -1))


def _inputs(shape, stationary, seed=0):
    """(w, x0, rhs): a loss weight, an initial guess and a zero-shell rhs;
    for the stationary family a mean-zero weight (a gauge-invariant loss)
    and a compatible (interior-mean-zero) rhs."""
    rng = np.random.default_rng(seed)
    w, x0 = rng.standard_normal(shape), rng.standard_normal(shape)
    rhs = np.zeros(shape)
    inner = _interior(shape)
    rhs[inner] = rng.standard_normal(rhs[inner].shape)
    if stationary:
        w -= w.mean()
        rhs[inner] -= rhs[inner].mean()
    return w, x0, rhs


def _port_grads(solve, w, x0, rhs):
    a = torch.tensor(x0, requires_grad=True)
    b = torch.tensor(rhs, requires_grad=True)
    (torch.as_tensor(w) * solve(a, b).x).sum().backward()
    ga = np.zeros_like(x0) if a.grad is None else a.grad.numpy()
    return ga, b.grad.numpy()


def _ref_grads(solve, w, x0, rhs):
    def loss(a, b):
        return jnp.sum(jnp.asarray(w) * solve(a, b).x)

    ga, gb = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x0),
                                            jnp.asarray(rhs))
    return np.asarray(ga), np.asarray(gb)


def _assert_grads(got, want, tag):
    for name, g, r in zip(("x0", "rhs"), got, want):
        scale = max(np.abs(r).max(), 1e-300)
        err = np.abs(g - r).max()
        print(f"{tag} d/d{name}: max abs {err:.3e} of max {scale:.3e}")
        assert err <= GRAD_RTOL * scale, (tag, name, err, scale)


CASES = {
    "cg_2d": (Method.CG, (1, 17, 17)),
    "bicgstab_2d": (Method.BICGSTAB, (1, 17, 17)),
    "multigrid_2d": (Method.MULTIGRID, (1, 17, 17)),
    "jacobi_2d": (Method.JACOBI, (1, 17, 17)),
    "redblack_sor_2d": (Method.REDBLACK_SOR, (1, 17, 17)),
    "fft_direct_2d": (Method.FFT_DIRECT, (1, 17, 17)),
    "cg_3d": (Method.CG, (9, 9, 9)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_adjoint_grads_match_reference(case):
    """Gradients w.r.t. x0 and rhs against the reference's adjoint, every
    method family: the correction space (the −B·x0 mirror term on x0),
    the stationary one (mean-zero projection, no x0 gradient) and the
    direct solve (differentiable as it is)."""
    method, shape = CASES[case]
    stationary = method in adjoint.STATIONARY_METHODS
    kw = STATIONARY if stationary else TIGHT
    port, ref = _problems(shape)
    w, x0, rhs = _inputs(shape, stationary)
    got = _port_grads(adjoint.make_adjoint_poisson(
        port, PoissonParams(**kw), method), w, x0, rhs)
    want = _ref_grads(j_make_adjoint(ref, JParams(**kw),
                                     JMethod(int(method))), w, x0, rhs)
    _assert_grads(got, want, case)
    if stationary:
        assert np.all(got[0] == 0.0)


@pytest.mark.parametrize("method", [Method.CG, Method.BICGSTAB,
                                    Method.FFT_DIRECT],
                         ids=["cg", "bicgstab", "direct"])
def test_nonuniform_adjoint_grads_match_reference(method):
    """On a tanh-stretched (β = 1.5) 17² consistent-scheme problem: the
    volume-conjugated CG / BiCGSTAB adjoints and the eigenbasis direct
    solve against the reference's."""
    port, ref = _stretched()
    w, x0, rhs = _inputs(port.shape, False, seed=3)
    got = _port_grads(adjoint.make_adjoint_poisson(
        port, PoissonParams(**TIGHT), method), w, x0, rhs)
    want = _ref_grads(j_make_adjoint(ref, JParams(**TIGHT),
                                     JMethod(int(method))), w, x0, rhs)
    _assert_grads(got, want, f"nonuniform {method.name}")


@pytest.mark.parametrize("method", [Method.CG, Method.MULTIGRID])
def test_adjoint_matches_central_differences(method):
    """⟨grad, d⟩ against the central difference of the loss along d
    (`test_adjoint.py:32-47`), for rhs (zero-shell directions) and x0
    (any direction: x0 enters through the boundary-mirror diagonal)."""
    port, _ = _problems((1, 17, 17))
    solve = adjoint.make_adjoint_poisson(port, PoissonParams(**TIGHT),
                                         method)
    w, x0, rhs = (torch.as_tensor(a) for a in _inputs((1, 17, 17), False,
                                                      seed=5))

    def loss(a, b):
        return float((w * solve(a, b).x).sum())

    ga, gb = _port_grads(solve, w.numpy(), x0.numpy(), rhs.numpy())
    rng = np.random.default_rng(9)
    eps = 1e-6
    for g, which in ((gb, 1), (ga, 0)):
        d = torch.as_tensor(rng.standard_normal(port.shape))
        if which == 1:
            d = port.zero_boundary(d)
        args_p, args_m = [x0, rhs], [x0, rhs]
        args_p[which] = args_p[which] + eps * d
        args_m[which] = args_m[which] - eps * d
        fd = (loss(*args_p) - loss(*args_m)) / (2 * eps)
        assert float((torch.as_tensor(g) * d).sum()) == pytest.approx(
            fd, rel=2e-5, abs=1e-9)


def test_forward_is_the_plain_solve():
    """The forward pass is the unmodified plain maker: the same x,
    iterations and status as the front end's CG maker; the statuses and
    counts carry no gradient."""
    from cfd_tpu_torch.solvers.poisson.frontend import _MAKERS
    port, _ = _problems((1, 17, 17))
    _, x0, rhs = _inputs((1, 17, 17), False)
    x0, rhs = torch.as_tensor(x0), torch.as_tensor(rhs)
    params = PoissonParams(**TIGHT)
    got = adjoint.make_adjoint_poisson(port, params)(
        x0.clone().requires_grad_(), rhs)
    want = _MAKERS[Method.CG](port, params)(x0, rhs)
    assert torch.equal(got.x.detach(), want.x)
    assert int(got.iterations) == int(want.iterations) > 0
    assert int(got.status) == int(want.status) == 0
    assert got.x.requires_grad and not got.final_residual.requires_grad


def test_nonuniform_rejects_stationary_and_exports():
    """A stationary method on a nonuniform problem raises
    ``ERROR_UNSUPPORTED`` with the reference's message; the function and
    the method families are exported as the reference exports them."""
    port, _ = _stretched()
    with pytest.raises(CFDError) as err:
        adjoint.make_adjoint_poisson(port, PoissonParams(**TIGHT),
                                     Method.REDBLACK_SOR)
    assert err.value.status == Status.ERROR_UNSUPPORTED
    assert "FFT_DIRECT/CG/BICGSTAB" in str(err.value)
    assert poisson.make_adjoint_poisson is adjoint.make_adjoint_poisson
    assert "make_adjoint_poisson" in poisson.__all__
    from cfd_tpu.solvers.poisson import adjoint as jadj
    for name in ("CORRECTION_SPACE_METHODS", "STATIONARY_METHODS"):
        assert {int(m) for m in getattr(adjoint, name)} == \
            {int(m) for m in getattr(jadj, name)}
