"""Status codes and the host-level exception (counterpart of
`cfd_tpu/core/status.py`).

The numeric values match the reference's, so a step's on-device status
tensor (0 ok, −6 diverged, −7 max-iter) reads the same in both packages.
"""

from __future__ import annotations

import enum
import threading


class Status(enum.IntEnum):
    SUCCESS = 0
    ERROR = -1
    ERROR_NOMEM = -2
    ERROR_INVALID = -3
    ERROR_IO = -4
    ERROR_UNSUPPORTED = -5
    ERROR_DIVERGED = -6
    ERROR_MAX_ITER = -7
    ERROR_LIMIT_EXCEEDED = -8
    ERROR_NOT_FOUND = -9


_STATUS_STRINGS = {
    Status.SUCCESS: "Success",
    Status.ERROR: "Generic error",
    Status.ERROR_NOMEM: "Out of memory",
    Status.ERROR_INVALID: "Invalid argument",
    Status.ERROR_IO: "I/O error",
    Status.ERROR_UNSUPPORTED: "Operation not supported",
    Status.ERROR_DIVERGED: "Solver diverged",
    Status.ERROR_MAX_ITER: "Maximum iterations reached",
    Status.ERROR_LIMIT_EXCEEDED: "Resource limit exceeded",
    Status.ERROR_NOT_FOUND: "Resource not found",
}


def get_error_string(status) -> str:
    try:
        return _STATUS_STRINGS[Status(status)]
    except (ValueError, KeyError):
        return "Unknown status"


class CFDError(Exception):
    """Host-level exception carrying a :class:`Status` code."""

    def __init__(self, status: Status, message: str = ""):
        self.status = Status(status)
        super().__init__(message or get_error_string(status))


# Thread-local last-error record (the reference's TLS error state); the
# registry sets it when it returns None for a name.
_tls = threading.local()


def set_error(status: Status, message: str) -> None:
    _tls.status = Status(status)
    _tls.message = message


def get_last_error() -> str:
    return getattr(_tls, "message", "")


def get_last_status() -> Status:
    return getattr(_tls, "status", Status.SUCCESS)
