"""The DST products (counterpart of `cfd_tpu/ops/pallas/rolling.py`):
the 3D xy-DST plane product, and the one-sided products of the 2D step
and of the spectral solver's eigen pipeline.

The reference's manual-DMA z-marching engine (`make_rolling_stencil`) is
not ported as an engine: each kernel that rode it is a CUDA kernel of its
own (`projection_kernels.py`).  What survives here is :func:`plane_dot` —
``left · (x · right)`` on every z-plane, the DST stage pair the mega
kernels ran in-kernel on the MXU (`plane_dot_rl` riding `hp_dot_general`)
— the one-sided :func:`right_dot` / :func:`left_dot`, and the 2D
y-solve's rescue :func:`rescue_dot` (the eigenvalue divide fused:
``csrc/rescue_gemm.cu`` at "highest" and "high", ``csrc/gemm_tf32.cu`` at
"default").  Every product takes a ``precision``, the counterpart of
`hp_dot_general`'s (`rolling.py:42-70`):

* ``"highest"`` — IEEE fp32 (``Precision.HIGHEST``): the hand-written
  SGEMM of ``csrc/sgemm_fp32.cu`` on a CUDA tensor;
* ``"high"`` — 3xTF32 (``Precision.HIGH``, bf16_3x on the TPU): the
  hand-written wgmma / TMA GEMM of ``csrc/gemm_3xtf32.cu``;
* ``"default"`` — one TF32 pass (``Precision.DEFAULT``, one bf16 pass on
  the TPU): the hand-written wgmma / TMA GEMM of ``csrc/gemm_tf32.cu``,
  which also runs the rescue's DEFAULT products.

On a CPU tensor each runs its plain version.  Each wrapper counts the
SGEMM launches in ``launches``, the 3xTF32 launches in ``high_launches``
and the one-pass TF32 launches in ``default_launches``; of each
precision's GEMM, the launches whose operands TMA cannot read (a base,
leading dimension or batch stride off 16 bytes) and which load them
through 4-byte ``cp.async`` copies instead, also in
``highest_cp_async_launches`` / ``high_cp_async_launches`` /
``default_cp_async_launches`` (``<precision>_cp_async_launches``,
:data:`CP_ASYNC_COUNTERS`).

Neither ``plane_masks`` nor the wrapped ``shift_x``/``shift_y`` semantics
are needed: the plain versions read neighbours by interior slices
(`ops/stencils.py`) and the CUDA kernels read them only at interior
points.

Kernel notes (each replaces the in-kernel MXU dots of
`ProjectionKernels.pred_bt` / `corr_bwd`, `projection_kernels.py:226-250`,
and the 2D `block_dot`, `projection2d.py:97-106`):

* ``sgemm_fp32_kernel`` (``"highest"``, ``csrc/sgemm_fp32.cu``): bound
  by the fp32 FMA rate of the CUDA cores — 2·n⁴ flops per product at
  n³, no tensor cores because TF32 would break the HIGHEST contract.
  Its sum order is a contract: every output element is one ``fmaf``
  chain over k, ascending from zero (``acc = fmaf(a[m][k], b[k][n],
  acc)``; zero-filled k past K leaves it unchanged), with no split of K,
  so the tile, the grid and the batch never move a bit.  A producer
  warp feeds a ring of 32-deep stages by TMA (4-byte ``cp.async`` for
  operands off 16 bytes); eight consumer warps issue only shared loads
  and FFMAs on 128×128 or 64×128 tiles (the smaller where it fills the
  card better, :func:`sgemm_plan`), each thread 8 or 4 rows by 8
  columns, walking tiles persistently.
* ``gemm_3xtf32_kernel`` (``"high"``, ``csrc/gemm_3xtf32.cu``): bound
  by the TF32 tensor-core rate — 3·2·n⁴ operations per product — and,
  beside it, by shared memory (``wgmma`` reads its shared operand at half
  the SM's rate).  Each fp32 operand is split once into big =
  rna_tf32(a) and small = rna_tf32(a − big): A's tile in shared memory
  by idle producer warps, B's fragments in registers (``wgmma``'s
  register operand, Cᵀ = Bᵀ·Aᵀ as the one-pass GEMM).  Its sum order is
  a function of K alone (:func:`high_sum_order`): each 32-deep stage is
  a chunk that the tensor core sums from zero, small·big and big·small
  first, then big·big (``wgmma`` m64n128k8 or m64n64k8), and one IEEE
  add takes it into the running sum (the tensor core's fp32 sums do not
  round to nearest): fp32-class accuracy, about 2⁻²² relative, at three
  tensor-core passes.  A TMA-fed ring of stages, persistent CTAs, 128×128
  or 64×128 tiles by the shape (:func:`high_plan`); 4-byte ``cp.async``
  copies for operands off 16 bytes.
* ``gemm_tf32_kernel`` (``"default"``, ``csrc/gemm_tf32.cu``): one
  tensor-core pass, ``wgmma`` m64n128k8 fed by TMA — 2·n⁴ operations,
  which at 512³ take less time at the TF32 rate than moving the planes:
  bound by device memory.  Its sum order is a function of K alone
  (:func:`tf32_sum_order`): the tensor core sums chunks of D(K) from
  zero, the chunks go into an fp32 running sum in ascending order, and a
  launch may split K across a cluster without changing a bit.
"""

from __future__ import annotations

import contextlib

import torch

from . import native

#: the spectral products' precisions, and the entry point of each
_GEMM = {"highest": "cfd_sgemm_batched", "high": "cfd_sgemm_3xtf32_batched",
         "default": "cfd_sgemm_tf32_batched"}
# the wrappers' counter of each precision's launches
_COUNTER = {"highest": "launches", "high": "high_launches",
            "default": "default_launches"}
# ... and of the launches that load through 4-byte cp.async copies (each
# GEMM's, whose operands TMA cannot read)
CP_ASYNC_COUNTERS = {p: f"{p}_cp_async_launches" for p in _GEMM}
PRECISIONS = tuple(_GEMM)

# The one-pass TF32 GEMM's sum order (`csrc/gemm_tf32.cu`, chunk_plan):
# k-stages of TF32_STAGE_K, chunks of at most TF32_MAX_CHUNK_STAGES stages,
# aiming at TF32_MAX_CHUNKS chunks.
TF32_STAGE_K = 32
TF32_MAX_CHUNKS = 8
TF32_MAX_CHUNK_STAGES = 8


def tf32_sum_order(k: int):
    """``(D, chunks)``: the order in which the one-pass TF32 GEMM sums an
    output element's ``k`` products, a function of ``k`` alone.  The k
    axis is cut into stages of 32 (the ragged tail zero-filled) and the
    stages into chunks of D = 32·q, q = min(8, ⌈stages / 8⌉): D(2048) =
    D(2046) = 256, D(512) = D(510) = 64, D(128) = D(126) = 32, at most 8
    chunks up to K = 2048; ``chunks`` are the chunks' [k0, k1) within
    [0, k), ascending.  The tensor core sums each chunk from zero in
    k-steps of 8; the chunks go into an fp32 running sum in that order,
    one IEEE add each, whichever launch computes the element (one CTA
    walking them, or a cluster of one chunk a rank)."""
    k = int(k)
    if k < 0:
        raise ValueError(f"tf32_sum_order: depth {k} < 0")
    stages = -(-k // TF32_STAGE_K)
    q = min(TF32_MAX_CHUNK_STAGES, max(1, -(-stages // TF32_MAX_CHUNKS)))
    d = q * TF32_STAGE_K
    return d, tuple((k0, min(k, k0 + d)) for k0 in range(0, k, d))


# The 3xTF32 GEMM's sum order (`csrc/gemm_3xtf32.cu`): k-stages of
# HIGH_STAGE_K, each one chunk.
HIGH_STAGE_K = 32


def high_sum_order(k: int):
    """``(D, chunks)``: the order in which the 3xTF32 GEMM sums an
    output element's ``k`` products, a function of ``k`` alone.  The k
    axis is cut into stages of 32 (the ragged tail zero-filled) and each
    stage is a chunk, D = 32 at every depth; ``chunks`` are their [k0,
    k1) within [0, k), ascending.  The tensor core sums each chunk from
    zero — its small·big and big·small terms, then its big·big terms —
    and the chunks go into an fp32 running sum in that order, one IEEE
    add each, whatever the tile, the CTAs or the load path."""
    k = int(k)
    if k < 0:
        raise ValueError(f"high_sum_order: depth {k} < 0")
    d = HIGH_STAGE_K
    return d, tuple((k0, min(k, k0 + d)) for k0 in range(0, k, d))


def _tma_operands(a: int, lda: int, sa: int, b: int, ldb: int, sb: int,
                  batch: int) -> bool:
    """Whether the GEMMs load A and B by TMA: 16-byte bases, leading
    dimensions and batch strides (`gemm_tf32.cu`, run_gemm;
    `sgemm_fp32.cu`, cfd_sgemm_batched; `gemm_3xtf32.cu`,
    cfd_sgemm_3xtf32_batched)."""
    return (a % 16 == 0 and lda % 4 == 0 and b % 16 == 0 and ldb % 4 == 0
            and (batch == 1 or (sa % 4 == 0 and sb % 4 == 0)))


def tf32_plan(m: int, n: int, k: int, batch: int = 1) -> dict:
    """The one-pass GEMM's plan for an ``m``×``n``×``k`` launch over
    ``batch`` on the current CUDA device (`cfd_gemm_tf32_plan`): D(K),
    the cluster size (1, or one chunk a rank), the CTAs and the
    chunks."""
    import ctypes

    out = (ctypes.c_int * 4)()
    rc = native.library().cfd_gemm_tf32_plan(m, n, k, batch, out)
    if rc != 0:
        raise RuntimeError(f"cfd_gemm_tf32_plan: CUDA error {rc}")
    return {"D": out[0], "cluster": out[1], "ctas": out[2],
            "chunks": out[3]}


def sgemm_plan(m: int, n: int, k: int, batch: int = 1) -> dict:
    """The SGEMM's plan for an ``m``×``n``×``k`` launch over ``batch`` on
    the current CUDA device (`cfd_sgemm_plan`): the output tile (rows,
    columns), the persistent CTAs and the tiles they walk.  Its sum
    order does not depend on the plan."""
    import ctypes

    out = (ctypes.c_int * 4)()
    rc = native.library().cfd_sgemm_plan(m, n, k, batch, out)
    if rc != 0:
        raise RuntimeError(f"cfd_sgemm_plan: CUDA error {rc}")
    return {"tile": (out[0], out[1]), "ctas": out[2], "tiles": out[3]}


def high_plan(m: int, n: int, k: int, batch: int = 1) -> dict:
    """The 3xTF32 GEMM's plan for an ``m``×``n``×``k`` launch over
    ``batch`` on the current CUDA device (`cfd_sgemm_3xtf32_plan`): the
    output tile (rows, columns), the persistent CTAs, the tiles they walk
    and D(K).  Its sum order does not depend on the plan."""
    import ctypes

    out = (ctypes.c_int * 5)()
    rc = native.library().cfd_sgemm_3xtf32_plan(m, n, k, batch, out)
    if rc != 0:
        raise RuntimeError(f"cfd_sgemm_3xtf32_plan: CUDA error {rc}")
    return {"tile": (out[0], out[1]), "ctas": out[2], "tiles": out[3],
            "D": out[4]}


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


def _check_precision(precision: str) -> None:
    if precision not in _GEMM:
        raise ValueError(f"precision must be one of {PRECISIONS}, got "
                         f"{precision!r}")


class _RoundTF32(torch.autograd.Function):
    """The TF32 rounding, its derivative taken as the identity (reverse
    and forward mode): a differentiable plain step at "default" or
    "high" differentiates its products as if unrounded."""

    @staticmethod
    def forward(x):
        bits = x.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, grad):
        return grad

    @staticmethod
    def jvp(ctx, tangent):
        return tangent


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 (10 mantissa bits), to nearest with
    ties away from zero — ``cvt.rna.tf32.f32``: half a TF32 ulp added to
    the magnitude bits, the 13 low bits cleared."""
    return _RoundTF32.apply(x)


def matmul_plain(a: torch.Tensor, b: torch.Tensor,
                 precision: str = "highest") -> torch.Tensor:
    """Plain version of one product at ``precision``: IEEE fp32 for
    ``"highest"``; for ``"high"`` the 3xTF32 split of the kernel, its
    three products in IEEE fp32 summed as (small·big + big·small) +
    big·big; for ``"default"`` the one TF32 pass, tf32(a)·tf32(b) in
    IEEE fp32 (a product of two TF32 values is exact in fp32, so only the
    order of the sum differs from the kernel's).  The rounding is fp32's:
    other dtypes take the plain product."""
    _check_precision(precision)
    with ieee_fp32_matmul():
        if precision == "highest" or a.dtype != torch.float32:
            return torch.matmul(a, b)
        if precision == "default":
            return torch.matmul(tf32_rna(a), tf32_rna(b))
        a_big, b_big = tf32_rna(a), tf32_rna(b)
        a_small, b_small = tf32_rna(a - a_big), tf32_rna(b - b_big)
        return ((torch.matmul(a_small, b_big)
                 + torch.matmul(a_big, b_small))
                + torch.matmul(a_big, b_big))


def _count(wrapper, precision, tma=True) -> None:
    name = _COUNTER[precision]
    setattr(wrapper, name, getattr(wrapper, name) + 1)
    if not tma:
        name = CP_ASYNC_COUNTERS[precision]
        setattr(wrapper, name, getattr(wrapper, name) + 1)


def _gemm(wrapper, precision, device, *args) -> None:
    """Launch the GEMM of ``precision`` and count it on ``wrapper``
    (args: M, N, K, A, lda, sA, B, ldb, sB, C, ldc, sC, batch)."""
    native.launch(_GEMM[precision], device, *args)
    _count(wrapper, precision, _tma_operands(*args[3:9], args[12]))


def plane_dot_plain(x: torch.Tensor, right: torch.Tensor,
                    left: torch.Tensor,
                    precision: str = "highest") -> torch.Tensor:
    """Plain version: ``left @ (x[k] @ right)`` for every plane k."""
    return matmul_plain(left, matmul_plain(x, right, precision), precision)


def plane_dot(x: torch.Tensor, right: torch.Tensor, left: torch.Tensor,
              precision: str = "highest") -> torch.Tensor:
    """``left · (x[k] · right)`` for every (ny, nx) plane of an
    (nz, ny, nx) tensor; ``right`` (nx, nx), ``left`` (ny, ny).  Two GEMM
    launches a call."""
    _check_precision(precision)
    if native.on_cpu(x):
        return plane_dot_plain(x, right, left, precision)
    nz, ny, nx = x.shape
    native.check_cuda(x, right, left)
    if tuple(right.shape) != (nx, nx) or tuple(left.shape) != (ny, ny):
        raise ValueError("plane_dot: right must be (nx, nx) and left "
                         "(ny, ny)")
    t = torch.empty_like(x)
    out = torch.empty_like(x)
    # x · right as one (nz·ny, nx) × (nx, nx) product
    _gemm(plane_dot, precision, x.device, nz * ny, nx, nx,
          native.ptr(x), nx, 0, native.ptr(right), nx, 0,
          native.ptr(t), nx, 0, 1)
    # left · t[k] for every plane (left shared: batch stride 0)
    _gemm(plane_dot, precision, x.device, ny, nx, ny,
          native.ptr(left), ny, 0, native.ptr(t), nx, ny * nx,
          native.ptr(out), nx, ny * nx, nz)
    return out


# ---- one-sided products ------------------------------------------------------
#
# The 2D step's x-DST pair is one product per field, ``x · right`` on every
# row (the reference's in-kernel `block_dot`, `projection2d.py:97-106`);
# the eigen pipeline's y and z products and the decomposed steps' slab
# products are ``left · x`` (the z one on the (nz, ny·nx) view).  Each
# wrapper is one GEMM launch; `left_dot` reads and writes column slices in
# place through the GEMM's leading dimensions.

def right_dot_plain(x: torch.Tensor, right: torch.Tensor,
                    precision: str = "highest") -> torch.Tensor:
    return matmul_plain(x, right, precision)


def right_dot(x: torch.Tensor, right: torch.Tensor,
              precision: str = "highest") -> torch.Tensor:
    """``x · right`` for the (…, k) tensor ``x`` (every row times the
    (k, n) matrix ``right``)."""
    _check_precision(precision)
    if native.on_cpu(x):
        return right_dot_plain(x, right, precision)
    native.check_cuda(x, right)
    if right.dim() != 2 or x.shape[-1] != right.shape[0]:
        raise ValueError(f"right_dot: {tuple(x.shape)} · "
                         f"{tuple(right.shape)}")
    k, n = right.shape
    out = torch.empty(x.shape[:-1] + (n,), dtype=x.dtype, device=x.device)
    _gemm(right_dot, precision, x.device, x.numel() // k, n, k,
          native.ptr(x), k, 0, native.ptr(right), n, 0,
          native.ptr(out), n, 0, 1)
    return out


def left_dot_plain(left: torch.Tensor, x: torch.Tensor, out=None,
                   precision: str = "highest"):
    # (a constant stored with padded rows multiplies as its packed copy)
    res = matmul_plain(left.contiguous(), x, precision)
    return res if out is None else out.copy_(res)


def left_dot(left: torch.Tensor, x: torch.Tensor, out=None,
             precision: str = "highest") -> torch.Tensor:
    """``left · x`` for an (m, k) ``left`` and a (k, n) ``x`` whose rows
    are contiguous (a column slice of a wider matrix will do, and a
    constant stored with its rows padded); written into ``out`` (an (m,
    n) row view, in place) when given.  A contiguous (b, k, n) ``x`` is a
    batch: ``left · x[q]`` for every q into a new (b, m, n) tensor, one
    launch (``left`` shared, as `plane_dot`'s second product)."""
    _check_precision(precision)
    if native.on_cpu(x):
        return left_dot_plain(left, x, out, precision)
    if x.dim() == 3:
        (m, k), (b, _, n) = left.shape, x.shape
        native.check_cuda(left, x, rows=True)
        if x.shape[1] != k or out is not None:
            raise ValueError(f"left_dot: {tuple(left.shape)} · "
                             f"{tuple(x.shape)}")
        out = x.new_empty((b, m, n))
        _gemm(left_dot, precision, x.device, m, n, k,
              native.ptr(left), left.stride(0), 0, native.ptr(x), n, k * n,
              native.ptr(out), n, m * n, b)
        return out
    (m, k), n = left.shape, x.shape[1]
    if out is None:
        out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    native.check_cuda(left, x, out, rows=True)
    if x.shape[0] != k or tuple(out.shape) != (m, n):
        raise ValueError(f"left_dot: {tuple(left.shape)} · "
                         f"{tuple(x.shape)} -> {tuple(out.shape)}")
    _gemm(left_dot, precision, x.device, m, n, k,
          native.ptr(left), left.stride(0), 0, native.ptr(x), x.stride(0),
          0, native.ptr(out), out.stride(0), 0, 1)
    return out


# ---- the 2D y-solve's low-mode rescue ------------------------------------
#
# The two products of the dense rescue (`spectral.py:299-303`): s = Fyp ·
# a[:, :K] / λ, then x̂[:, :K] = Gyp · s in place.  Thin shapes (K ≤ 128
# columns, ~n rows, depth n), for which 128×128 output tiles alone fill
# 16 of 132 SMs at 2048²: the depth is split across a thread-block
# cluster and the divide by λ is in the epilogue, one launch a product —
# ``csrc/rescue_gemm.cu`` at "highest" and "high", the one-pass GEMM at
# "default", whose split leaves the sum order, and so every bit, as
# `left_dot`'s (`tf32_sum_order`).

_RESCUE = {"highest": "cfd_rescue_sgemm", "high": "cfd_rescue_3xtf32",
           "default": "cfd_rescue_tf32"}


def rescue_dot_plain(left: torch.Tensor, x: torch.Tensor, lam=None,
                     out=None, precision: str = "highest"):
    """Plain version: ``matmul_plain(left, x) / lam`` (no divide without
    ``lam``), copied into ``out`` when given."""
    res = matmul_plain(left.contiguous(), x, precision)
    if lam is not None:
        res = res / lam
    return res if out is None else out.copy_(res)


def rescue_dot(left: torch.Tensor, x: torch.Tensor, lam=None, out=None,
               precision: str = "highest") -> torch.Tensor:
    """``(left · x) / lam`` for an (m, k) ``left``, a (k, n) ``x`` and an
    (m, n) ``lam`` whose rows are contiguous (column slices will do, and a
    constant stored with its rows padded); no divide without ``lam``.
    Written into ``out`` (an (m, n) row view, in place, not overlapping
    the inputs) when given.  One launch a call, the divide IEEE ``/`` in
    its epilogue: the rescue GEMM (``csrc/rescue_gemm.cu``, its K split
    across a cluster) at "highest" and "high", the one-pass GEMM
    (``csrc/gemm_tf32.cu``) at "default"; counted in ``launches`` /
    ``high_launches`` / ``default_launches`` (and
    ``default_cp_async_launches``).  The shapes are checked on every
    device, the dtype, device and layout on CUDA."""
    _check_precision(precision)
    if left.dim() != 2 or x.dim() != 2 or x.shape[0] != left.shape[1] \
            or (lam is not None and lam.shape != (left.shape[0],
                                                  x.shape[1])) \
            or (out is not None and out.shape != (left.shape[0],
                                                  x.shape[1])):
        raise ValueError(
            f"rescue_dot: {tuple(left.shape)} · {tuple(x.shape)} / "
            f"{None if lam is None else tuple(lam.shape)} -> "
            f"{None if out is None else tuple(out.shape)}")
    if native.on_cpu(x):
        return rescue_dot_plain(left, x, lam, out, precision)
    (m, k), n = left.shape, x.shape[1]
    if out is None:
        out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    native.check_cuda(left, x, out, *(() if lam is None else (lam,)),
                      rows=True)
    native.launch(_RESCUE[precision], x.device, m, n, k, native.ptr(left),
                  left.stride(0), native.ptr(x), x.stride(0),
                  native.ptr(out), out.stride(0),
                  0 if lam is None else native.ptr(lam),
                  0 if lam is None else lam.stride(0))
    _count(rescue_dot, precision, precision != "default" or _tma_operands(
        native.ptr(left), left.stride(0), 0, native.ptr(x), x.stride(0), 0,
        1))
    return out


WRAPPERS = (plane_dot, right_dot, left_dot, rescue_dot)


def reset_launch_counts() -> None:
    for fn in WRAPPERS:
        for name in (*_COUNTER.values(), *CP_ASYNC_COUNTERS.values()):
            setattr(fn, name, 0)


reset_launch_counts()
