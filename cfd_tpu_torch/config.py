"""Dtype resolution (counterpart of `cfd_tpu/config.py`).

The reference resolves its default dtype from JAX's x64 mode.  Here the
default follows the device: float32 on CUDA (the kernels' type), and
torch's own default dtype on the CPU (float32 unless the caller set
float64).  An explicit dtype always wins.
"""

from __future__ import annotations

import numpy as np
import torch


def as_torch_dtype(dtype) -> torch.dtype:
    """Accept a torch dtype, a numpy dtype or a name ("float32")."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, np.dtype(dtype).name)


def default_dtype(device=None) -> torch.dtype:
    if device is not None and torch.device(device).type == "cuda":
        return torch.float32
    return torch.get_default_dtype()


def resolve_dtype(dtype=None, device=None) -> torch.dtype:
    return default_dtype(device) if dtype is None else as_torch_dtype(dtype)
