"""Entry point: the main-path step and example arguments (counterpart of
`__graft_entry__.entry()`).

``entry(device)`` builds the flagship configuration — the 3D spectral
projection step, float32, default ``NSParams`` (sources on) — at the same
128×64×16 grid, and returns ``(step, (field, dt, iter_idx))``.  By
default it targets the card and runs the hand-written kernels;
``device="cpu"`` runs their plain versions.
"""

from __future__ import annotations

import torch

from .core.field import FlowField
from .core.grid import Grid
from .solvers.ns.params import NSParams
from .solvers.ns.projection import make_projection_step
from .solvers.poisson.base import Method


def entry(device=None):
    grid = Grid.uniform(128, 64, 16, zmin=0.0, zmax=1.0)
    step = make_projection_step(grid, NSParams(), dtype=torch.float32,
                                poisson_method=Method.FFT_DIRECT,
                                device=device)
    field = FlowField.initialize(grid, dtype=torch.float32, device=device)
    return step, (field, 0.001, 0)
