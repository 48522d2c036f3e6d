"""Multi-step loop (counterpart of `cfd_tpu/solvers/ns/rollout.py`,
forward only).

The reference scans a step under ``lax.scan``; PyTorch runs eagerly, so a
rollout is a plain Python loop.  Nothing in it reads a device value on the
host, so the kernels of consecutive steps queue back to back on the
stream; the caller synchronises when it reads the result.
"""

from __future__ import annotations

from ...core.field import FlowField


def run_steps(step, field: FlowField, dt, n: int, start_iter: int = 0):
    """Apply ``step`` ``n`` times from iteration ``start_iter``; returns
    (field, StepResult of the last step)."""
    if n < 1:
        raise ValueError("n must be >= 1")
    for i in range(start_iter, start_iter + n):
        field, result = step(field, dt, i)
    return field, result
