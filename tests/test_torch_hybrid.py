"""The hybrid differentiable step (`cfd_tpu_torch.solvers.ns.hybrid.
pair_vjp`: kernel forward, autograd adjoint of the plain step) on the CPU,
against the reference's (`cfd_tpu/solvers/ns/hybrid.py`, its fused
kernels in interpret mode), mirroring `tests/solvers/test_hybrid_vjp.py`.

On the CPU the kernel wrappers run their plain versions, so the port's
hybrid is built here directly, ``pair_vjp(kernel-path step, plain
differentiable step)``, as ``differentiable=True`` builds it on the card.
Both packages get the same seeded numpy fields.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_tpu import FlowField as JField
from cfd_tpu import Grid as JGrid
from cfd_tpu.solvers.ns import NSParams as JParams
from cfd_tpu.solvers.ns import make_euler_step as j_euler
from cfd_tpu.solvers.ns.rk import make_rk2_step as j_rk2
from cfd_tpu_torch import CFDError, Grid, Status
from cfd_tpu_torch.core.field import FlowField
from cfd_tpu_torch.interop import field_from_numpy
from cfd_tpu_torch.solvers.ns import NSParams, make_rollout
from cfd_tpu_torch.solvers.ns.euler import make_euler_step
from cfd_tpu_torch.solvers.ns.hybrid import pair_vjp
from cfd_tpu_torch.solvers.ns.projection import make_projection_step
from cfd_tpu_torch.solvers.ns.rk import make_rk2_step, make_rk4_step
from cfd_tpu_torch.solvers.poisson.base import Method

torch.set_num_threads(min(2, torch.get_num_threads()))

NZ, NY, NX = 8, 16, 128     # the reference's hybrid test grid


def _arrays(seed, amp=0.3):
    """`test_hybrid_vjp.py:26-35`'s field: random u, v, w, p."""
    rng = np.random.default_rng(seed)
    shape = (NZ, NY, NX)
    out = {k: rng.normal(0, amp, shape).astype(np.float32) for k in "uvwp"}
    out.update(rho=np.ones(shape, np.float32),
               T=np.full(shape, 300.0, np.float32))
    return out


def _grids():
    return (Grid.uniform(NX, NY, NZ, zmin=0.0, zmax=1.0),
            JGrid.uniform(NX, NY, NZ, zmin=0.0, zmax=1.0))


def _hybrid(maker, grid, params):
    return pair_vjp(maker(grid, params, torch.float32, "cpu"),
                    maker(grid, params, torch.float32, "cpu",
                          differentiable=True))


def _energy(f):
    return 0.5 * (f.u ** 2 + f.v ** 2 + f.w ** 2).sum()


def test_pair_vjp_value_is_primal_gradient_is_adjoint():
    """The mechanics: the value is the primal step's (here the adjoint
    plus a constant), the gradient the adjoint step's, w.r.t. the field
    and a tensor dt; ``iter_idx`` reaches both steps undifferentiated; a
    field the primal passes through comes back as a new tensor; the
    StepResult carries no gradient."""
    grid, _ = _grids()
    params = NSParams(source_amplitude_u=0.0, source_amplitude_v=0.0)
    plain = make_euler_step(grid, params, torch.float64, "cpu")
    seen = []

    def primal(field, dt, it):
        seen.append(it)
        new, res = plain(field, dt, it)
        return new.replace(u=new.u + 1.0, rho=field.rho), res

    step = pair_vjp(primal, plain)
    f0 = field_from_numpy(_arrays(1), "cpu", torch.float64)
    u = f0.u.clone().requires_grad_()
    dt = torch.tensor(5e-5, dtype=torch.float64, requires_grad=True)
    fh, rh = step(f0.replace(u=u), dt, 7)
    want, _ = primal(f0, dt.detach(), 7)
    assert seen == [7, 7]
    assert torch.equal(fh.u.detach(), want.u)
    assert fh.rho is not f0.rho and torch.equal(fh.rho, f0.rho)
    assert not rh.status.requires_grad and not rh.max_velocity.requires_grad
    gu, gdt = torch.autograd.grad(_energy(fh), (u, dt))
    u2 = f0.u.clone().requires_grad_()
    dt2 = dt.detach().clone().requires_grad_()
    fp, _ = plain(f0.replace(u=u2), dt2, 7)
    # d(0.5 (u + 1)²)/du' = u + 1: the adjoint is linearised at the inputs
    # but receives the primal's cotangent
    ref_gu, ref_gdt = torch.autograd.grad(
        (fp.u * (fh.u.detach())).sum() + 0.5 * (fp.v ** 2 + fp.w ** 2).sum(),
        (u2, dt2))
    assert torch.allclose(gu, ref_gu, rtol=1e-12, atol=0)
    assert torch.allclose(gdt, ref_gdt, rtol=1e-12, atol=0)


@pytest.mark.parametrize("name", ["euler", "rk2"])
def test_hybrid_value_and_grad_match_reference(name):
    """The Euler / RK2 hybrid at 128×16×8 float32, iter 3, dt 5e-5
    (`test_hybrid_vjp.py:46-76`): its value bit-equal to the port's kernel
    step; the Euler value against the reference's hybrid (interpret-mode
    fused kernel) at the explicit kernels' bar (`test_torch_euler.py`:
    2e-6, float32 in another order); the gradient w.r.t. u at rtol 1e-5 /
    atol 1e-7 and w.r.t. dt at rtol 1e-5 — the reference's bars for its
    own hybrid against its jnp step (rtol 1e-6 / 1e-5), widened on u by
    the two packages' float32 operation orders — against the reference's
    hybrid for Euler and, for RK2, against its jnp step, which is its
    hybrid's adjoint by construction (its fused RK2 value is held in
    `test_torch_rk.py`; its interpret-mode hybrid costs ~30 s more)."""
    grid, jgrid = _grids()
    kw = dict(source_amplitude_u=0.1, source_amplitude_v=0.05)
    ours = {"euler": make_euler_step, "rk2": make_rk2_step}[name]
    theirs = {"euler": j_euler, "rk2": j_rk2}[name]
    hybrid = _hybrid(ours, grid, NSParams(**kw))
    jstep = (theirs(jgrid, JParams(**kw), dtype=jnp.float32,
                    use_pallas=True, pallas_interpret=True,
                    differentiable=True) if name == "euler" else
             theirs(jgrid, JParams(**kw), dtype=jnp.float32,
                    use_pallas=False))
    arrays = _arrays(1)
    f0 = field_from_numpy(arrays, "cpu", torch.float32)
    jf0 = JField(**{k: jnp.asarray(a) for k, a in arrays.items()})
    fh, rh = hybrid(f0, 5e-5, 3)
    fk, _ = ours(grid, NSParams(**kw), torch.float32, "cpu")(f0, 5e-5, 3)
    assert int(rh.status) == 0
    for k in ("u", "v", "w", "p", "rho", "T"):
        assert torch.equal(getattr(fh, k), getattr(fk, k)), k
    if name == "euler":
        jfh, jrh = jax.jit(jstep)(jf0, 5e-5, 3)
        assert int(jrh.status) == 0
        for k in ("u", "v", "w", "p", "T"):
            np.testing.assert_allclose(
                getattr(fh, k).numpy(), np.asarray(getattr(jfh, k)), rtol=0,
                atol=2e-6 * max(1.0, float(np.abs(arrays[k]).max())),
                err_msg=k)
    u = f0.u.clone().requires_grad_()
    dt = torch.tensor(5e-5, requires_grad=True)
    gu, gdt = torch.autograd.grad(_energy(hybrid(f0.replace(u=u), dt,
                                                 3)[0]), (u, dt))

    def jloss(uu, d):
        out, _ = jstep(jf0.replace(u=uu), d, 3)
        return 0.5 * jnp.sum(out.u ** 2 + out.v ** 2 + out.w ** 2)

    jgu, jgdt = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jf0.u,
                                                         jnp.float32(5e-5))
    np.testing.assert_allclose(gu.numpy(), np.asarray(jgu), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(float(gdt), float(jgdt), rtol=1e-5)


def test_hybrid_composes_with_rollout_remat():
    """A 3-step hybrid Euler rollout with remat="step": its gradient is
    the plain rollout's (`test_hybrid_vjp.py:79-101`) — bit for bit here,
    the kernels' plain versions being the adjoint step's arithmetic."""
    grid, _ = _grids()
    params = NSParams(source_amplitude_u=0.0, source_amplitude_v=0.0)
    hybrid = _hybrid(make_euler_step, grid, params)
    plain = make_euler_step(grid, params, torch.float32, "cpu",
                            differentiable=True)
    f0 = field_from_numpy(_arrays(2, amp=0.1), "cpu", torch.float32)

    def grad(step, remat):
        u = f0.u.clone().requires_grad_()
        out, _ = make_rollout(step, 3, remat=remat)(f0.replace(u=u), 5e-5)
        (g,) = torch.autograd.grad(0.5 * (out.u ** 2 + out.v ** 2).sum(), u)
        return g

    gh = grad(hybrid, "step")
    assert bool(torch.isfinite(gh).all())
    assert torch.equal(gh, grad(plain, None))
    assert torch.equal(gh, grad(hybrid, "sqrt"))


def test_plain_differentiable_step_takes_forward_mode():
    """``differentiable=True`` on the CPU is the plain step, which
    forward mode differentiates (`test_hybrid_vjp.py:130-146`): the JVP
    along a tangent equals ⟨grad, tangent⟩ from reverse mode."""
    grid, _ = _grids()
    step = make_euler_step(grid, NSParams(), torch.float64, "cpu",
                           differentiable=True)
    f0 = field_from_numpy(_arrays(3, amp=0.1), "cpu", torch.float64)

    def loss(u):
        out, _ = step(f0.replace(u=u), 5e-5, 0)
        return (out.u ** 2).sum()

    tangent = torch.ones_like(f0.u)
    _, jvp = torch.func.jvp(loss, (f0.u,), (tangent,))
    u = f0.u.clone().requires_grad_()
    (g,) = torch.autograd.grad(loss(u), u)
    assert np.isfinite(float(jvp))
    assert float(jvp) == pytest.approx(float((g * tangent).sum()),
                                       rel=1e-12)


def _grad_params():
    return NSParams(mu=torch.tensor(0.01, requires_grad=True))


@pytest.mark.parametrize("builder", ["euler", "rk2", "rk4", "projection"])
def test_hybrid_refuses_params_that_require_grad(builder):
    """On the card the kernels take the physics parameters as constants:
    a hybrid (or kernel) step whose NSParams carry a tensor that requires
    grad raises ``ERROR_UNSUPPORTED`` naming the plain differentiable
    step — before any device use, so it raises here too; the plain step
    takes the same params."""
    grid, _ = _grids()
    make = {"euler": make_euler_step, "rk2": make_rk2_step,
            "rk4": make_rk4_step,
            "projection": lambda *a, **k: make_projection_step(
                *a[:3], Method.FFT_DIRECT, **k)}[builder]
    with pytest.raises(CFDError) as err:
        make(grid, _grad_params(), torch.float32, device="cuda",
             differentiable=True)
    assert err.value.status == Status.ERROR_UNSUPPORTED
    assert "plain differentiable step" in str(err.value)
    make(grid, _grad_params(), torch.float32, device="cpu",
         differentiable=True)


def test_hybrid_projection_value_is_the_kernel_step():
    """The projection hybrid (FFT_DIRECT, the DST-fused kernels' chain):
    the value is the non-differentiable step's, bit for bit, and the
    gradient the plain differentiable step's (`test_hybrid_vjp.py:
    104-127`; here both forwards run on the same plain versions)."""
    grid, _ = _grids()
    params = NSParams(source_amplitude_u=0.0, source_amplitude_v=0.0)
    kernel = make_projection_step(grid, params, torch.float32,
                                  Method.FFT_DIRECT, device="cpu")
    plain = make_projection_step(grid, params, torch.float32,
                                 Method.FFT_DIRECT, device="cpu",
                                 differentiable=True)
    hybrid = pair_vjp(kernel, plain)
    f0 = field_from_numpy(_arrays(4, amp=0.1), "cpu", torch.float32)
    fh, rh = hybrid(f0, 1e-3, 0)
    fk, _ = kernel(f0, 1e-3, 0)
    assert int(rh.status) == 0
    for k in ("u", "v", "w", "p"):
        assert torch.equal(getattr(fh, k), getattr(fk, k)), k
    u = f0.u.clone().requires_grad_()
    (gh,) = torch.autograd.grad(_energy(hybrid(f0.replace(u=u), 1e-3,
                                               0)[0]), u)
    u2 = f0.u.clone().requires_grad_()
    (gp,) = torch.autograd.grad(_energy(plain(f0.replace(u=u2), 1e-3,
                                              0)[0]), u2)
    np.testing.assert_allclose(gh.numpy(), gp.numpy(), rtol=1e-5,
                               atol=5e-7)
    assert isinstance(fh, FlowField)
