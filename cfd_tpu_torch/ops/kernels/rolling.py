"""The DST products (counterpart of `cfd_tpu/ops/pallas/rolling.py`):
the 3D xy-DST plane product, and the one-sided products of the 2D step.

The reference's manual-DMA z-marching engine (`make_rolling_stencil`) is
not ported as an engine: each kernel that rode it is a CUDA kernel of its
own (`projection_kernels.py`).  What survives here is :func:`plane_dot` —
``left · (x · right)`` on every z-plane, the DST stage pair the mega
kernels ran in-kernel on the MXU (`plane_dot_rl` riding `hp_dot_general`
at ``Precision.HIGHEST``, i.e. IEEE fp32).  On a CUDA tensor it launches
the hand-written SGEMM of ``csrc/projection_kernels.cu`` twice; on a CPU
tensor it runs the plain version.

Neither ``plane_masks`` nor the wrapped ``shift_x``/``shift_y`` semantics
are needed: the plain versions read neighbours by interior slices
(`ops/stencils.py`) and the CUDA kernels read them only at interior
points.

Kernel note (`sgemm_kernel`, replaces the in-kernel MXU dots of
`ProjectionKernels.pred_bt` / `corr_bwd`, `projection_kernels.py:226-238`):
bound by the fp32 FMA rate of the CUDA cores — 2·n⁴ flops per product at
n³, no tensor cores because TF32 would break the HIGHEST contract.  Its
128×128 block tile with an 8×8 register tile per thread keeps operands in
registers (16 shared-memory loads per 64 FMAs).  3xTF32 on the tensor
cores is the later route for ``spectral_precision=HIGH``.
"""

from __future__ import annotations

import contextlib

import torch

from . import native


@contextlib.contextmanager
def ieee_fp32_matmul():
    """Run ``torch.matmul`` in full fp32 (TF32 off) inside the block and
    restore the caller's setting after."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def plane_dot_plain(x: torch.Tensor, right: torch.Tensor,
                    left: torch.Tensor) -> torch.Tensor:
    """Plain version: ``left @ (x[k] @ right)`` for every plane k."""
    with ieee_fp32_matmul():
        return torch.matmul(left, torch.matmul(x, right))


def plane_dot(x: torch.Tensor, right: torch.Tensor,
              left: torch.Tensor) -> torch.Tensor:
    """``left · (x[k] · right)`` for every (ny, nx) plane of an
    (nz, ny, nx) tensor; ``right`` (nx, nx), ``left`` (ny, ny).
    ``plane_dot.launches`` counts SGEMM launches (two per call)."""
    if native.on_cpu(x):
        return plane_dot_plain(x, right, left)
    nz, ny, nx = x.shape
    native.check_cuda(x, right, left)
    if tuple(right.shape) != (nx, nx) or tuple(left.shape) != (ny, ny):
        raise ValueError("plane_dot: right must be (nx, nx) and left "
                         "(ny, ny)")
    t = torch.empty_like(x)
    out = torch.empty_like(x)
    # x · right as one (nz·ny, nx) × (nx, nx) product
    native.launch("cfd_sgemm_batched", x.device, nz * ny, nx, nx,
                  native.ptr(x), nx, 0, native.ptr(right), nx, 0,
                  native.ptr(t), nx, 0, 1)
    plane_dot.launches += 1
    # left · t[k] for every plane (left shared: batch stride 0)
    native.launch("cfd_sgemm_batched", x.device, ny, nx, ny,
                  native.ptr(left), ny, 0, native.ptr(t), nx, ny * nx,
                  native.ptr(out), nx, ny * nx, nz)
    plane_dot.launches += 1
    return out


# ---- one-sided products (the 2D step) ---------------------------------------
#
# The 2D step's x-DST pair is one product per field, ``x · right`` on every
# row (the reference's in-kernel `block_dot`, `projection2d.py:97-106`), and
# its dense low-mode rescue multiplies a thin column slice from the left
# (`spectral.py:299-303`, jnp matmuls at HIGHEST in the reference).  Each
# wrapper is one `sgemm_kernel` launch; `left_dot` reads and writes column
# slices in place through the SGEMM's leading dimensions.

def right_dot_plain(x: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    with ieee_fp32_matmul():
        return torch.matmul(x, right)


def right_dot(x: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """``x · right`` for the (…, k) tensor ``x`` (every row times the
    (k, n) matrix ``right``); ``right_dot.launches`` counts SGEMM
    launches."""
    if native.on_cpu(x):
        return right_dot_plain(x, right)
    native.check_cuda(x, right)
    if right.dim() != 2 or x.shape[-1] != right.shape[0]:
        raise ValueError(f"right_dot: {tuple(x.shape)} · "
                         f"{tuple(right.shape)}")
    k, n = right.shape
    out = torch.empty(x.shape[:-1] + (n,), dtype=x.dtype, device=x.device)
    native.launch("cfd_sgemm_batched", x.device, x.numel() // k, n, k,
                  native.ptr(x), k, 0, native.ptr(right), n, 0,
                  native.ptr(out), n, 0, 1)
    right_dot.launches += 1
    return out


def left_dot_plain(left: torch.Tensor, x: torch.Tensor, out=None):
    with ieee_fp32_matmul():
        res = torch.matmul(left, x)
    return res if out is None else out.copy_(res)


def left_dot(left: torch.Tensor, x: torch.Tensor, out=None) -> torch.Tensor:
    """``left · x`` for a contiguous (m, k) ``left`` and a (k, n) ``x``
    whose rows are contiguous (a column slice of a wider matrix will do);
    written into ``out`` (an (m, n) row view, in place) when given.
    ``left_dot.launches`` counts SGEMM launches."""
    if native.on_cpu(x):
        return left_dot_plain(left, x, out)
    (m, k), n = left.shape, x.shape[1]
    if out is None:
        out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    native.check_cuda(left, x, out, rows=True)
    if x.shape[0] != k or tuple(out.shape) != (m, n) \
            or not left.is_contiguous():
        raise ValueError(f"left_dot: {tuple(left.shape)} · "
                         f"{tuple(x.shape)} -> {tuple(out.shape)}")
    native.launch("cfd_sgemm_batched", x.device, m, n, k,
                  native.ptr(left), k, 0, native.ptr(x), x.stride(0), 0,
                  native.ptr(out), out.stride(0), 0, 1)
    left_dot.launches += 1
    return out


plane_dot.launches = 0
right_dot.launches = 0
left_dot.launches = 0
