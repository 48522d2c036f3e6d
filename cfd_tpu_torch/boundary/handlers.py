"""BC error handler and backend selection (counterpart of
`cfd_tpu/boundary/handlers.py`).

Mirrors the reference's pluggable BC error handler and its backend
selectors.  The port has one implementation of each BC, plain PyTorch on
whatever device the tensors lie on, so the selectors validate and record
the choice without changing a code path, as the reference's do: AUTO,
SCALAR, OMP and SIMD always succeed, and CUDA succeeds when a CUDA device
is present (`core.features`, where the reference asks for any
accelerator).
"""

from __future__ import annotations

import enum
import logging
from typing import Callable, Optional

import torch

_log = logging.getLogger("cfd_tpu_torch.boundary")


class BCErrorCode(enum.IntEnum):
    """Mirrors bc_error_code_t (`boundary_conditions.h:371-376`)."""

    NONE = 0
    NO_SIMD_BACKEND = 1
    INTERNAL = 2
    INVALID = 3


class BCBackend(enum.IntEnum):
    """Mirrors bc_backend_t (`boundary_conditions.h:36-42`)."""

    AUTO = 0
    SCALAR = 1
    OMP = 2
    SIMD = 3
    CUDA = 4


_handler: Optional[Callable] = None
_handler_user_data = None
_backend = BCBackend.AUTO


def set_error_handler(handler: Optional[Callable], user_data=None) -> None:
    """bc_set_error_handler: ``handler(code, function, message,
    user_data)``; None restores the default (log an error)."""
    global _handler, _handler_user_data
    _handler = handler
    _handler_user_data = user_data


def get_error_handler() -> Optional[Callable]:
    return _handler


def report_error(code: BCErrorCode, function: str, message: str) -> None:
    """Dispatch a BC error through the registered handler."""
    if _handler is not None:
        _handler(BCErrorCode(code), function, message, _handler_user_data)
    else:
        _log.error("%s: %s", function, message)


def backend_available(backend: BCBackend) -> bool:
    if BCBackend(backend) == BCBackend.CUDA:
        return torch.cuda.is_available()
    return True


def set_backend(backend: BCBackend) -> bool:
    """bc_set_backend: record the selection; False when unavailable."""
    global _backend
    backend = BCBackend(backend)
    if not backend_available(backend):
        return False
    _backend = backend
    return True


def get_backend() -> BCBackend:
    return _backend


def get_backend_name() -> str:
    names = {BCBackend.AUTO: "auto", BCBackend.SCALAR: "scalar",
             BCBackend.OMP: "omp", BCBackend.SIMD: "simd (torch)",
             BCBackend.CUDA: "cuda"}
    return names[_backend]
