"""Backend detection (counterpart of `cfd_tpu/core/features.py`).

The reference's backend names survive so code written against the C API's
registry keeps working: SCALAR, SIMD and OMP are always available, and
CUDA means "a CUDA device is present" (`torch.cuda.is_available()`),
where the JAX package asks for any accelerator platform.
"""

from __future__ import annotations

import enum

import torch


class Backend(enum.IntEnum):
    """Mirrors ns_solver_backend_t (`navier_stokes_solver.h:172-177`)."""

    SCALAR = 0
    SIMD = 1
    OMP = 2
    CUDA = 3


def backend_is_available(backend: Backend) -> bool:
    """`cfd_backend_is_available` equivalent."""
    if Backend(backend) == Backend.CUDA:
        return torch.cuda.is_available()
    return True
