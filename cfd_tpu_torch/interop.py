"""Carry state between the two packages as numpy arrays.

A test holds the port against the reference by feeding both the same
numpy inputs: ``field_from_numpy({"u": ..., ...}, device, dtype)`` builds a
:class:`FlowField`, ``field_to_numpy(field)`` reads one back.  A JAX array
should be converted with ``np.array`` (a copy), not ``np.asarray``: the
latter is a read-only view of the JAX buffer.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import resolve_device, resolve_dtype
from .core.field import FIELD_NAMES, FlowField


def field_from_numpy(arrays: dict, device=None, dtype=None) -> FlowField:
    """``arrays`` maps each of u, v, w, p, rho, T to an (nz, ny, nx)
    array; ``device`` defaults to the card."""
    device = resolve_device(device)
    dt = resolve_dtype(dtype, device)
    return FlowField(*(torch.tensor(np.array(arrays[n]), dtype=dt,
                                    device=device) for n in FIELD_NAMES))


def field_to_numpy(field: FlowField) -> dict:
    return {n: getattr(field, n).detach().cpu().numpy()
            for n in FIELD_NAMES}
