"""Device and dtype resolution (counterpart of `cfd_tpu/config.py`).

Every entry point of the port runs on the card unless the caller asks for
the CPU: a ``device`` left at None resolves to ``"cuda"``
(:func:`default_device`), and :func:`resolve_device` raises when no CUDA
device is present.  There is no silent CPU fallback; the CPU tests pass
``device="cpu"`` and run the kernels' plain versions.

The reference resolves its default dtype from JAX's x64 mode.  Here the
default follows the (resolved) device: float32 on CUDA (the kernels'
type), and torch's own default dtype on the CPU (float32 unless the
caller set float64).  An explicit dtype always wins.
"""

from __future__ import annotations

import numpy as np
import torch


def as_torch_dtype(dtype) -> torch.dtype:
    """Accept a torch dtype, a numpy dtype or a name ("float32")."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, np.dtype(dtype).name)


def default_device() -> torch.device:
    """The device an entry point targets when the caller names none."""
    return torch.device("cuda")


def device_of(device=None) -> torch.device:
    """``device`` as a ``torch.device``, None meaning :func:`default_device`;
    checks nothing about the machine."""
    return default_device() if device is None else torch.device(device)


def resolve_device(device=None) -> torch.device:
    """:func:`device_of`, raising when it names CUDA and no CUDA device is
    present (no fallback to the CPU)."""
    dev = device_of(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested (the default when none is given) but "
            f"torch.cuda.is_available() is False; pass device='cpu' to run "
            f"the plain PyTorch versions on the CPU")
    return dev


def default_dtype(device=None) -> torch.dtype:
    if device is not None and torch.device(device).type == "cuda":
        return torch.float32
    return torch.get_default_dtype()


def resolve_dtype(dtype=None, device=None) -> torch.dtype:
    return default_dtype(device) if dtype is None else as_torch_dtype(dtype)
