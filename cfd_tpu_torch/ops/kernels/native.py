"""Build, load and launch the hand-written CUDA kernels.

The sources under ``cfd_tpu_torch/csrc/`` are compiled with ``nvcc`` for
Hopper (``sm_90a``), one ``nvcc`` process per source, all started
together, and linked into one shared library with a plain C interface, at
first use, into ``cfd_tpu_torch/_build/`` (listed in ``.gitignore``).  The
library is loaded with ``ctypes``; every entry point takes raw device
pointers and the current CUDA stream and returns ``cudaGetLastError()``,
which :func:`launch` turns into an exception.  Nothing here runs at import:
``nvcc`` is looked up and the library loaded only when a kernel is first
launched, so the package imports on machines without either.

Compiler flags: ``-fmad=false`` keeps every multiply and add a separately
rounded IEEE operation, as in the plain PyTorch versions (the GEMM writes
its fused multiply-adds explicitly), so the stencil and Thomas kernels
reproduce their plain versions' operation order.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-fmad=false", "-Xptxas", "-v",
              "-Xcompiler", "-fPIC"]

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float

# argument types of each C entry point, stream last
SIGNATURES = {
    # projection_kernels.cu (3D step)
    # (the predictor and b~ take the global plane base and plane count
    # of a z-decomposed shard's block last: 0 and nz on one device)
    "cfd_pred_star": [_P] * 8 + [_I] * 3 + [_F] * 11 + [_I] + [_F] * 4
    + [_I] * 3 + [_P],
    "cfd_poisson_input": [_P] * 6 + [_I] * 3 + [_F] * 6 + [_I] * 3 + [_P],
    "cfd_tdma_fwd": [_P, _P, _F, _P, _P, _I, _L, _I, _P],
    "cfd_tdma_bwd": [_P, _P, _P, _I, _L, _P],
    "cfd_tdma_bwd_analytic": [_P, _P, _P, _I, _L, _P],
    "cfd_corrector": [_P] * 10 + [_I] * 3 + [_F] * 3 + [_P],
    # tdma_lines.cu (the 2D step's y-line Thomas solve, one launch: r, w,
    # the rec and t planes, x, ny, nx, d' in shared memory or not, 16-byte
    # copies or 4-byte ones), and its dependent-chain probe (mu, w, rows,
    # int64[4] out, sink)
    "cfd_tdma_y2d": [_P, _F, _P, _P, _P, _I, _I, _I, _I, _P],
    "cfd_tdma_y2d_chain": [_P, _F, _I, _P, _P, _P],
    # ... their global-row instantiations (a (z, y)-decomposed shard's
    # block: its global row base and row count after the plane ones; b~'s
    # window depth h; the corrector's owned p out and u*'s padding hs)
    "cfd_pred_star_rows": [_P] * 8 + [_I] * 3 + [_F] * 11 + [_I]
    + [_F] * 4 + [_I] * 5 + [_P],
    "cfd_poisson_input_rows": [_P] * 6 + [_I] * 3 + [_F] * 6 + [_I] * 6
    + [_P],
    "cfd_corrector_rows": [_P] * 11 + [_I] * 3 + [_F] * 3 + [_I] * 5
    + [_P],
    # ... their consistent-scheme instantiations (weight rows xw, yw)
    "cfd_pred_star_cons": [_P] * 10 + [_I] * 3 + [_F] * 3 + [_I]
    + [_F] * 4 + [_I] * 3 + [_P],
    "cfd_poisson_input_cons": [_P] * 8 + [_I] * 3 + [_F] * 6 + [_I] * 3
    + [_P],
    "cfd_corrector_cons": [_P] * 12 + [_I] * 3 + [_F, _P],
    # sgemm_fp32.cu (every DST product at spectral_precision="highest",
    # the 3D and 2D steps' and the decomposed and eigen pipelines'), and
    # a launch's plan (M, N, K, batch, int[4] out; no stream: a query)
    "cfd_sgemm_batched": [_I] * 3 + [_P, _L, _L, _P, _L, _L, _P, _L, _L]
    + [_I, _P],
    "cfd_sgemm_plan": [_I] * 4 + [_P],
    # gemm_3xtf32.cu (every DST product at spectral_precision="high"),
    # and a launch's plan (M, N, K, batch, int[5] out; no stream: a query)
    "cfd_sgemm_3xtf32_batched": [_I] * 3 + [_P, _L, _L, _P, _L, _L, _P, _L,
                                            _L] + [_I, _P],
    "cfd_sgemm_3xtf32_plan": [_I] * 4 + [_P],
    # gemm_tf32.cu (every product at spectral_precision="default": the
    # batched GEMM, the 2D rescue's A·B [/ lam], lam null for no divide)
    "cfd_sgemm_tf32_batched": [_I] * 3 + [_P, _L, _L, _P, _L, _L, _P, _L,
                                          _L] + [_I, _P],
    "cfd_rescue_tf32": [_I] * 3 + [_P, _L] * 4 + [_P],
    # ... and a launch's plan (M, N, K, batch, int[4] out; no stream: a
    # query)
    "cfd_gemm_tf32_plan": [_I] * 4 + [_P],
    # rescue_gemm.cu (the 2D y-solve's low-mode rescue at HIGHEST and
    # HIGH: A·B [/ lam]; lam null for no divide)
    "cfd_rescue_sgemm": [_I] * 3 + [_P, _L] * 4 + [_P],
    "cfd_rescue_3xtf32": [_I] * 3 + [_P, _L] * 4 + [_P],
    # ... and the cluster size it takes (passes 0 or 3; M, N, K; no
    # stream: a query)
    "cfd_rescue_cluster": [_I] * 4,
    # projection2d_kernels.cu (2D step)
    "cfd_pred_star_2d": [_P] * 8 + [_I] * 2 + [_F] * 9 + [_I] + [_F] * 4
    + [_I, _P],
    "cfd_poisson_input_2d": [_P] * 5 + [_I] * 2 + [_F] * 4 + [_I, _P],
    "cfd_corrector_2d": [_P] * 6 + [_I] * 2 + [_F] * 2 + [_P],
    "cfd_pred_star_2d_cons": [_P] * 10 + [_I] * 2 + [_F, _I] + [_F] * 4
    + [_I, _P],
    "cfd_poisson_input_2d_cons": [_P] * 7 + [_I] * 2 + [_F] * 4 + [_I, _P],
    "cfd_corrector_2d_cons": [_P] * 8 + [_I] * 2 + [_P],
    # ... their global-row instantiations (a y-decomposed shard's rows:
    # the global row base and row count; b~'s window depth h; the
    # corrector's owned p out and u*'s padding hs)
    "cfd_pred_star_2d_rows": [_P] * 8 + [_I] * 2 + [_F] * 9 + [_I]
    + [_F] * 4 + [_I] * 3 + [_P],
    "cfd_poisson_input_2d_rows": [_P] * 5 + [_I] * 2 + [_F] * 4 + [_I] * 4
    + [_P],
    "cfd_corrector_2d_rows": [_P] * 7 + [_I] * 2 + [_F] * 2 + [_I] * 3
    + [_P],
    # euler_kernels.cu, rk_kernels.cu (explicit steps, 3D and 2D)
    # (the spacing's weight rows and kind before the stream)
    "cfd_euler_step": [_P] * 17 + [_I] * 3 + [_F] * 8 + [_P, _P]
    + [_P, _P, _I, _P],
    "cfd_rk_stage": [_P] * 4 + [_I] * 3 + [_F] * 8 + [_I, _P, _P]
    + [_P, _P, _I, _P],
    # ... their sharded modes (a decomposed shard's block: halo planes and
    # rows, global plane base and count, global row base and count)
    "cfd_euler_step_rows": [_P] * 17 + [_I] * 3 + [_F] * 8 + [_P, _P]
    + [_P, _P, _I] + [_I] * 6 + [_P],
    "cfd_rk_stage_shard": [_P] * 4 + [_I] * 3 + [_F] * 8 + [_I, _P, _P]
    + [_P, _P, _I] + [_I] * 6 + [_P],
    # cg_kernels.cu (the CG pressure solve)
    "cfd_cg_lap_dot": [_P] * 6 + [_I] * 3 + [_F] * 4 + [_P],
    "cfd_cg_update": [_P] * 6 + [_I] * 3 + [_F, _I, _P],
    "cfd_cg_solve": [_P] * 8 + [_I] * 3 + [_F] * 6 + [_I] * 2 + [_P],
    # ... the whole solve in one cluster (x0, rhs, x, the planes of the
    # vectors not resident, stats; ny, nx; the coefficients, scale and
    # tolerances; max_iter, ci; the plan: cluster size, threads, rows a
    # rank, the resident vectors' mask), and the barrier probe (grid,
    # cluster or dot, blocks, threads, barriers, int64[3] out)
    "cfd_cg_solve_cluster": [_P] * 5 + [_I] * 2 + [_F] * 5 + [_I] * 2
    + [_I] * 4 + [_P],
    "cfd_barrier_probe": [_I] * 4 + [_P, _P],
    # ... the sharded passes (a fold output, then the block's global
    # plane base and count) and the recurrences on the shards' sums
    "cfd_cg_lap_dot_sharded": [_P] * 7 + [_I] * 3 + [_F] * 4 + [_I] * 2
    + [_P],
    "cfd_cg_update_sharded": [_P] * 7 + [_I] * 5 + [_P],
    # ... the (z, y) passes (padded blocks; global row base and count too)
    "cfd_cg_lap_dot_rows": [_P] * 7 + [_I] * 3 + [_F] * 4 + [_I] * 4
    + [_P],
    "cfd_cg_update_rows": [_P] * 7 + [_I] * 7 + [_P],
    "cfd_cg_lap_dot_recur": [_P] * 3,
    "cfd_cg_update_recur": [_P] * 2 + [_F, _I, _P],
    # mg_kernels.cu, mg_solve.cu (the multigrid pressure solve; the
    # level dims and coefficients of cfd_mg_solve are host arrays)
    "cfd_mg_rb_sweep": [_P] * 3 + [_I] * 3 + [_F] * 4 + [_I, _P],
    # ... its sharded modes (a shard's halo block: the global plane base
    # and count, the global row base and count, 0 rows for whole rows)
    "cfd_mg_rb_sweep_shard": [_P] * 3 + [_I] * 3 + [_F] * 4 + [_I] * 5
    + [_P],
    "cfd_mg_solve": [_P] * 6 + [_I, _P, _P] + [_F] * 2 + [_I] * 4 + [_P],
    # bicgstab_kernels.cu (the BiCGSTAB pressure solve)
    "cfd_bicg_pv": [_P] * 8 + [_I] * 3 + [_F] * 3 + [_P],
    "cfd_bicg_st": [_P] * 6 + [_I] * 3 + [_F] * 3 + [_P],
    "cfd_bicg_xr": [_P] * 8 + [_I] * 4 + [_P],
    "cfd_bicg_solve": [_P] * 11 + [_I] * 3 + [_F] * 5 + [_I] * 2 + [_P],
    "cfd_bicg_solve_cluster": [_P] * 5 + [_I] * 2 + [_F] * 4 + [_I] * 2
    + [_I] * 4 + [_P],
    "cfd_bicg_pv_sharded": [_P] * 9 + [_I] * 3 + [_F] * 3 + [_I] * 2
    + [_P],
    "cfd_bicg_st_sharded": [_P] * 7 + [_I] * 3 + [_F] * 3 + [_I] * 2
    + [_P],
    "cfd_bicg_xr_sharded": [_P] * 9 + [_I] * 5 + [_P],
    # ... the (z, y) passes (padded blocks; global row base and count too)
    "cfd_bicg_pv_rows": [_P] * 9 + [_I] * 3 + [_F] * 3 + [_I] * 4 + [_P],
    "cfd_bicg_st_rows": [_P] * 7 + [_I] * 3 + [_F] * 3 + [_I] * 4 + [_P],
    "cfd_bicg_xr_rows": [_P] * 9 + [_I] * 7 + [_P],
    "cfd_bicg_pv_recur": [_P] * 3,
    "cfd_bicg_st_recur": [_P] * 3,
    "cfd_bicg_xr_recur": [_P] * 2 + [_I, _P],
    # rbsor_kernels.cu (the Red-Black SOR and Jacobi pressure solves)
    "cfd_rbsor_sweep": [_P] * 4 + [_I] * 3 + [_F] * 5 + [_I] * 2 + [_P],
    "cfd_stationary_solve": [_P] * 6 + [_I] * 3 + [_F] * 7 + [_I] * 3
    + [_P],
}

# block-count queries: (nz, ny, nx) -> long long
COUNTS = ("cfd_corrector_partials", "cfd_explicit_partials",
          "cfd_cg_partials", "cfd_cg_solve_blocks", "cfd_mg_solve_blocks",
          "cfd_bicg_partials", "cfd_bicg_solve_blocks", "cfd_rbsor_partials",
          "cfd_stationary_solve_blocks")

_lib = None


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([str(Path(home) / "bin" / "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME)")


def library_path() -> Path:
    """Build target, keyed by a hash of the sources and flags so a stale
    library is never loaded after a source change."""
    h = hashlib.sha256(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libcfd_tpu_torch_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources if the keyed library is missing: one ``nvcc -c``
    per source, all running at once, then one link.  The commands and
    nvcc's output (ptxas' register and spill report) go to
    ``_build/build.log``."""
    target = library_path()
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{os.getpid()}.tmp"
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-c", "-o", str(obj),
               str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, failed = [], []
    for cmd, _, proc in jobs:
        out, _ = proc.communicate()
        log += [" ".join(cmd), out]
        if proc.returncode != 0:
            failed.append(f"{Path(cmd[-1]).name} ({proc.returncode})")
    tmp = target.with_suffix(f".{tag}")
    if not failed:
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
               *(str(obj) for _, obj, _ in jobs)]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        log += [" ".join(cmd), proc.stdout]
        if proc.returncode != 0:
            failed.append(f"link ({proc.returncode})")
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    text = "\n".join(log)
    (BUILD_DIR / "build.log").write_text(text)
    if failed:
        raise RuntimeError(f"nvcc failed: {', '.join(failed)}\n{text}")
    os.replace(tmp, target)
    return target


def library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, args in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        lib.cfd_error_string.argtypes = [ctypes.c_int]
        lib.cfd_error_string.restype = ctypes.c_char_p
        for name in COUNTS:
            getattr(lib, name).argtypes = [_I] * 3
            getattr(lib, name).restype = ctypes.c_longlong
        _lib = lib
    return _lib


def launch(name: str, device: torch.device, *args) -> None:
    """Call entry point ``name`` on ``device``'s current stream; raise if
    the launch was refused or an earlier asynchronous fault surfaced."""
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, name)(*args, stream)
    if rc != 0:
        msg = lib.cfd_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def count_launch(wrapper, scheme=None) -> None:
    """One launch on ``wrapper``'s counter of a spacing scheme:
    ``launches`` (a uniform grid, and the parity projection on its
    first-cell spacings), ``parity_launches`` or ``consistent_launches``
    (the stretched instantiations), or of a mode: ``global_nz_launches``
    (a z-decomposed shard's block) or ``global_ny_launches`` (the
    global-row instantiations, a (z, y)-decomposed shard's block)."""
    name = "launches" if scheme is None else f"{scheme}_launches"
    setattr(wrapper, name, getattr(wrapper, name) + 1)


def reset_counts(*wrappers) -> None:
    for w in wrappers:
        w.launches = w.parity_launches = w.consistent_launches = 0
        w.global_nz_launches = w.global_ny_launches = 0


def on_cpu(t: torch.Tensor) -> bool:
    """True for a CPU tensor (the wrapper runs the plain version), False
    for a CUDA tensor (it launches the kernel); any other device raises —
    there is no fallback."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type == "cpu"


def check_cuda(*tensors: torch.Tensor, rows: bool = False) -> None:
    """The kernels take contiguous float32 tensors on one CUDA device.
    ``rows=True`` also admits a 2D view whose rows are contiguous (unit
    column stride, any row stride ≥ its width): the SGEMM reads such a
    matrix through its leading dimension."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError("kernel inputs must share one CUDA device")
        if t.dtype != torch.float32:
            raise TypeError(f"kernel inputs must be float32, got {t.dtype}")
        if rows and t.dim() == 2 and t.stride(1) == 1 \
                and t.stride(0) >= t.shape[1]:
            continue
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
