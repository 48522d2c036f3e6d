"""Library initialization (counterpart of `cfd_tpu/core/runtime.py`,
`src/core/cfd_init.c`), as far as the facade calls it.

The reference guards one-time setup with a flag under a lock so any entry
point can initialize lazily; ``Simulation.from_grid`` calls :func:`init`.
The port's one-time setup is CUDA's: ``init`` initializes the CUDA
context when a device is present, so device discovery happens before the
first step rather than inside it.
"""

from __future__ import annotations

import threading

import torch

from .status import Status

_lock = threading.Lock()
_initialized = False


def init() -> Status:
    """Idempotent global init (cfd_init).  Safe from any thread."""
    global _initialized
    with _lock:
        if not _initialized:
            if torch.cuda.is_available():
                torch.cuda.init()
            _initialized = True
    return Status.SUCCESS
