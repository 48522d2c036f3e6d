"""Hybrid differentiable steps: kernel forward, autograd adjoint
(counterpart of `cfd_tpu/solvers/ns/hybrid.py`).

No kernel of either package has a backward kernel: the reference glues
each fused Pallas forward to XLA's adjoint of its jnp twin
(``jax.custom_vjp``).  Here :func:`pair_vjp` is a
``torch.autograd.Function`` that does the same:

* **value**: ``primal_step``, the hand-written CUDA kernels, run under
  ``no_grad`` — full kernel throughput for the loss;
* **reverse derivative**: ``torch.autograd`` of ``adjoint_step``, the
  plain differentiable step, re-run at the saved inputs during the
  backward sweep (one extra plain forward a step, the recompute that
  ``remat="step"`` implies anyway).  The plain step runs on the card by
  design: it is the counterpart of the reference's jnp adjoint and never
  stands in for a kernel's forward.

The Euler and RK kernels are bit-equal to their plain versions, so the
pairing is exact there: the gradient of the function actually evaluated.
The projection kernels' forward differs from the plain step at the
solver's tolerance, so its gradient is the linearization of the
tolerance-equal plain step — the inexact-primal / exact-adjoint trade of
adjoint CFD.

The wrapped step is reverse-mode only; use the plain differentiable step
(``device="cpu"`` or ``plain=True``) for forward mode.  It differentiates
the field and dt, not ``iter_idx`` and not the physics parameters: a
step whose ``NSParams`` carry a tensor that requires grad is refused
(:func:`check_params`) rather than given a silently missing gradient.
"""

from __future__ import annotations

import torch

from ...core.field import FlowField
from ...core.status import CFDError, Status
from .params import StepResult

_FIELDS = ("u", "v", "w", "p", "rho", "T")
_RESULTS = ("iterations", "status", "residual", "max_velocity",
            "max_pressure", "max_temperature")


def check_params(params, name: str) -> None:
    """Refuse ``params`` with a field that requires grad on a kernel
    step: the kernels take the physics parameters as constants, so no
    gradient could reach them through the kernel or the hybrid step."""
    if params.requires_grad():
        raise CFDError(
            Status.ERROR_UNSUPPORTED,
            f"{name}: the kernel and hybrid steps differentiate the field "
            f"and dt only; for a gradient w.r.t. an NSParams field build "
            f"the plain differentiable step (differentiable=True with "
            f"plain=True, or device='cpu')")


class _PairVJP(torch.autograd.Function):
    """``(dt, u, v, w, p, rho, T) -> (u', v', w', p', rho', T', six
    StepResult tensors)``; the StepResult outputs carry no gradient."""

    @staticmethod
    def forward(ctx, primal_step, adjoint_step, iter_idx, dt, *fields):
        new, res = primal_step(FlowField(*fields), dt, iter_idx)
        ctx.adjoint_step, ctx.iter_idx = adjoint_step, iter_idx
        ctx.save_for_backward(dt, *fields)
        outs = tuple(getattr(new, n) for n in _FIELDS)
        # a field the step passes through unchanged comes back as a view,
        # so that autograd sees an output distinct from the input
        outs = tuple(o.view_as(o) if any(o is f for f in fields) else o
                     for o in outs)
        extras = tuple(getattr(res, n) for n in _RESULTS)
        ctx.mark_non_differentiable(*extras)
        return (*outs, *extras)

    @staticmethod
    def backward(ctx, *grads):
        dt, *fields = ctx.saved_tensors
        wanted = ctx.needs_input_grad[3:]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(need)
                   for t, need in zip((dt, *fields), wanted)]
            new, _ = ctx.adjoint_step(FlowField(*ins[1:]), ins[0],
                                      ctx.iter_idx)
            outs, cots = [], []
            for n, g in zip(_FIELDS, grads[:len(_FIELDS)]):
                o = getattr(new, n)
                if g is not None and o.requires_grad:
                    outs.append(o)
                    cots.append(g)
            targets = [t for t in ins if t.requires_grad]
            got = (torch.autograd.grad(outs, targets, cots,
                                       allow_unused=True)
                   if outs and targets else (None,) * len(targets))
        got = iter(got)
        in_grads = [next(got) if t.requires_grad else None for t in ins]
        return (None, None, None, *in_grads)


def pair_vjp(primal_step, adjoint_step):
    """Build a ``(field, dt, iter_idx) -> (field, StepResult)`` step whose
    value is ``primal_step``'s and whose reverse-mode derivative is
    ``torch.autograd``'s of ``adjoint_step`` at the same inputs
    (`hybrid.py:44-68`).  Both follow the ``make_*_step`` contract;
    ``iter_idx`` is not differentiated (time enters through dt)."""

    def step(field: FlowField, dt, iter_idx):
        if not torch.is_tensor(dt):
            dt = torch.full((), dt, dtype=field.u.dtype,
                            device=field.u.device)
        outs = _PairVJP.apply(primal_step, adjoint_step, iter_idx, dt,
                              *(getattr(field, n) for n in _FIELDS))
        return (FlowField(*outs[:len(_FIELDS)]),
                StepResult(*outs[len(_FIELDS):]))

    return step
