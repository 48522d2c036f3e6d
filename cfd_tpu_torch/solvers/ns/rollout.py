"""Multi-step loops (counterpart of `cfd_tpu/solvers/ns/rollout.py`):
the forward ``run_steps`` and the differentiable ``make_rollout`` with
rematerialization policies.

The reference scans a step under ``lax.scan``; PyTorch runs eagerly, so a
rollout is a plain Python loop.  ``run_steps`` never reads a device value
on the host, so the kernels of consecutive steps queue back to back on
the stream; the caller synchronises when it reads the result.

``make_rollout`` is the reference's differentiable rollout: any step of
the ``make_*_step`` contract, a scalar dt or an ``(n_steps,)`` schedule
(gradients flow through either), ``torch.autograd`` end to end.  Reverse
mode keeps each step's internals for the backward pass unless a policy
trades recompute for memory (`rollout.py:14-33`):

========  ========================  =============================
policy    backward-pass memory      extra forward cost
========  ========================  =============================
None      O(n · internals)          0 — fastest, short rollouts
"step"    O(n · carry)              one step re-run per step
"sqrt"    O(√n · carry + 1 chunk)   one step re-run per step
========  ========================  =============================

``"step"`` runs each step under ``torch.utils.checkpoint.checkpoint``
(non-reentrant): only its inputs are kept and its internals are
recomputed in the backward sweep.  ``"sqrt"`` checkpoints √n-sized chunks
of step-checkpointed steps, so the carries inside a chunk are recomputed
from its start too, and runs the remainder as a step-checkpointed tail.
All policies compute identical values; they differ only in the schedule.
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from ...core.field import FlowField
from .params import StepResult

REMAT_POLICIES = (None, "none", "step", "sqrt")


def run_steps(step, field: FlowField, dt, n: int, start_iter: int = 0):
    """Apply ``step`` ``n`` times from iteration ``start_iter``; returns
    (field, StepResult of the last step)."""
    if n < 1:
        raise ValueError("n must be >= 1")
    for i in range(start_iter, start_iter + n):
        field, result = step(field, dt, i)
    return field, result


def make_rollout(step, n_steps: int, *, remat=None, collect_results=False,
                 start_iter: int = 0):
    """Build ``rollout(field, dt) -> (field_n, results)`` (`rollout.py:
    45-116`).

    ``step`` is any ``(field, dt, iter_idx) -> (field, StepResult)``
    closure.  ``dt`` is a scalar (uniform) or an ``(n_steps,)`` tensor
    (per step, e.g. an optimizable schedule: step i takes
    ``dt[i − start_iter]``).  ``results`` is the stacked per-step
    StepResults (each field an ``(n_steps,)`` tensor) with
    ``collect_results=True``, else the last step's.  ``remat`` is one of
    :data:`REMAT_POLICIES`.
    """
    if remat not in REMAT_POLICIES:
        raise ValueError(f"remat must be one of {REMAT_POLICIES}")
    if n_steps < 1:
        raise ValueError("n_steps must be >= 1")
    remat = None if remat == "none" else remat

    def body(field, dt, i):
        per_step = torch.is_tensor(dt) and dt.dim() > 0
        return step(field, dt[i - start_iter] if per_step else dt, i)

    if remat is not None:
        plain_body = body

        def body(field, dt, i):
            return checkpoint(plain_body, field, dt, i, use_reentrant=False)

    def run(field, dt, lo, hi):
        results = []
        for i in range(lo + start_iter, hi + start_iter):
            field, res = body(field, dt, i)
            results.append(res)
        return field, results

    if remat != "sqrt":
        def rollout(field: FlowField, dt):
            field, results = run(field, dt, 0, n_steps)
            return field, _select(results, collect_results)

        return rollout

    # √n-sized chunks, each checkpointed whole; n_steps = n_chunks·chunk
    # + rem, the remainder a step-checkpointed tail
    chunk = max(1, math.isqrt(n_steps))
    n_chunks, rem = divmod(n_steps, chunk)

    def chunk_run(field, dt, c):
        field, results = run(field, dt, c * chunk, (c + 1) * chunk)
        return field, _stack(results)

    def rollout(field: FlowField, dt):
        results = []
        for c in range(n_chunks):
            field, res = checkpoint(chunk_run, field, dt, c,
                                    use_reentrant=False)
            results += _unstack(res)
        if rem:
            field, tail = run(field, dt, n_chunks * chunk, n_steps)
            results += tail
        return field, _select(results, collect_results)

    return rollout


_RESULT_FIELDS = ("iterations", "status", "residual", "max_velocity",
                  "max_pressure", "max_temperature")


def _stack(results):
    """StepResults → one StepResult of (n,) tensors."""
    return StepResult(*(torch.stack([getattr(r, f) for r in results])
                        for f in _RESULT_FIELDS))


def _unstack(stacked):
    n = stacked.status.shape[0]
    return [StepResult(*(getattr(stacked, f)[k] for f in _RESULT_FIELDS))
            for k in range(n)]


def _select(results, collect_results):
    return _stack(results) if collect_results else results[-1]
