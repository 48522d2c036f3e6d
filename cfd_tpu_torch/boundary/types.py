"""Boundary-condition configuration (counterpart of
`cfd_tpu/boundary/types.py`, restricted to what the lid cavity reads)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DirichletValues:
    """Fixed per-face values (mirrors bc_dirichlet_values_t)."""

    left: float = 0.0
    right: float = 0.0
    top: float = 0.0
    bottom: float = 0.0
    front: float = 0.0
    back: float = 0.0
