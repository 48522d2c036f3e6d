#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels of ``cfd_tpu_torch`` from the
sources in the checkout and holds every kernel against its plain PyTorch
version on the card: the 3D kernels at the entry grid 128×64×16 and at
512³, the 2D kernels at 128×32 and 2048².  Then it drives both main
paths on the kernel path and the plain path:

* 3D: ``cfd_tpu_torch.entry.entry(device="cuda")`` for 3 steps, and the
  512³ Taylor-Green projection step (``bench.py:run_3d``'s configuration)
  for 5 warm-up and 5 timed steps;
* 2D: the 2048² Taylor-Green projection step (``bench.py:run_2d(2048)``'s
  configuration) for 20 warm-up and 20 timed steps;

and the lid-driven cavity at Re = 100 on 128² for 20000 steps on the
kernel path, graded against Ghia's table (``bench.py:905-907``: RMS of u
and v on the centerlines below 0.10).  Then the explicit integrators:

* phase 9: the fused Euler kernel (3D and 2D) and the RK stage kernel
  (3D and 2D; first, mid and final stage) against their plain versions
  at 37×23×11 / 37×23 and at 256³ / 2048², with the clamps and the ρ
  guard engaged;
* phase 10: ``bench.py``'s explicit configurations on the kernel path
  and the plain path — Euler at 256³ (10 steps) and 2048² (20 steps),
  RK2 and RK4 at 256³ and 2048² (10 steps each), each run once to warm
  up and once timed with CUDA events;
* phase 11: ``Simulation.create(100, 50)`` with the default solver for
  2000 ``step()``s on the card, against the same steps on the plain path.

It checks status, finiteness, launch counters (set to 0 just before each
main path and read just after) and kernel-vs-plain agreement; any
failure exits non-zero.  The line before the last is a JSON object
describing each kernel (its time, its plain version's, the bound from
this run's bytes and operations, and a library call's time where one
PyTorch call computes the same function); the last line is
``{"ok": true, "device": {...}}``.  It imports nothing of JAX.

    python3 chip_smoke.py --profile

adds phase 5: 3 more kernel-path steps of the 512³ and 2048² projection
steps and of each phase-10 configuration under ``torch.profiler``,
printing the device time per kernel, the device busy time against the
CUDA-event span and host wall time of those steps (the device's idle
share).

    python3 chip_smoke.py --ghia1000

adds phase 8: the north-star cavity of ``bench.py:919-923``, Re = 1000 on
512², dt = 4e-4, 150000 steps, graded at RMS < 0.01 (about 130 s on an
H100: the loop is bound by the host's launches).
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

SEED = 0
N_BIG = 512            # the 3D benchmark grid, 512³
N_2D = 2048            # the 2D benchmark grid, 2048²
TIMED_STEPS = 5
TIMED_STEPS_2D = 20    # bench.py:run_2d times 4 × TIMED_STEPS
SRC = "cfd_tpu_torch/csrc/projection_kernels.cu"
SRC_2D = "cfd_tpu_torch/csrc/projection2d_kernels.cu"
A1 = "cfd_tpu/ops/pallas/projection_kernels.py:572"   # pred_bt_compute
A2 = "cfd_tpu/ops/pallas/projection_kernels.py:381"   # corr_bwd_compute
DOT = "cfd_tpu/ops/pallas/projection_kernels.py:226"  # plane_dot_rl
P2 = "cfd_tpu/ops/pallas/projection2d.py:200"         # pred_bt_compute
C2 = "cfd_tpu/ops/pallas/projection2d.py:252"         # corr_compute
DOT2 = "cfd_tpu/ops/pallas/projection2d.py:97"        # block_dot
TDMA2 = "cfd_tpu/ops/pallas/tdma.py:434"              # make_tdma_y_2d
RESCUE = "cfd_tpu/solvers/poisson/spectral.py:299"    # rescue matmuls
SRC_E = "cfd_tpu_torch/csrc/euler_kernels.cu"
SRC_RK = "cfd_tpu_torch/csrc/rk_kernels.cu"
E3 = "cfd_tpu/ops/pallas/euler_kernels.py:67"         # make_euler_fused
E2 = "cfd_tpu/ops/pallas/euler2d.py:46"               # make_euler2d_fused
RK3 = "cfd_tpu/ops/pallas/rk_kernels.py:61"           # make_rk_stage
RK2 = "cfd_tpu/ops/pallas/rk2d.py:56"                 # make_rk2d_stage
GHIA = Path(__file__).resolve().parent / "tests/validation/ghia_data.py"
N_EXPL = 256           # bench.py:run_euler_3d / run_rk_3d, 256³
EXPL_DT = 1e-5         # bench.py's explicit configurations
FACADE_STEPS = 2000

# The card's peaks for a kernel's bound (H100 SXM data sheet, at 700 W):
# device memory 3.35 TB/s, float32 outside the tensor cores 67 TFLOP/s.
# A bound is the larger of (bytes in + bytes out) / rate and flops / peak.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
# float32 operations per grid point, counted from the kernels' sources
# (adds, multiplies, divides and compares of one point's update)
FLOPS_PER_POINT = {"predictor_star": 90, "poisson_input": 12,
                   "corrector": 20, "tdma_fwd": 7, "tdma_bwd": 2,
                   "euler": 130, "rk_stage": 150}

# Tolerances, kernel against plain version on identical inputs, float32:
#  * fields (u*, v*, w*, u, v, w): atol 2e-5, the reference's own
#    fused-vs-plain bar (tests/math/test_mega_kernels.py:57-60);
#  * stencil and Thomas outputs (b̃, d′, t, x̂): same operation order in
#    kernel and plain version (-fmad=false), so expected exact; bound at
#    1e-6 of the output's max magnitude;
#  * DST products and everything downstream of them (p, transformed
#    planes, the rescue columns, max p, max|p|): the SGEMM sums K terms in
#    another order than cuBLAS, so the bound scales with the magnitude —
#    2e-5 of max|ref| (≈ sqrt(512) ulps of headroom over a 512-term fp32
#    sum);
#  * max|u|²: rtol 1e-6 (tests/math/test_mega_kernels.py:63-66);
#  * the explicit kernels (Euler step, RK stage): same operation order,
#    -fmad=false and the same source vectors, so expected bit-equal; held
#    at TOL_EXACT of max|ref| (the fields and their maxima alike).
TOL_FIELD = 2e-5
TOL_EXACT = 1e-6
TOL_GEMM = 2e-5
TOL_DIAG = 1e-6


PROFILED_STEPS = 3


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def profile_steps(torch, label, run, n_steps):
    """Run ``run()`` (``n_steps`` steps) under torch.profiler; print each
    device kernel's ms per step, and the device busy time against the
    CUDA-event span and the host wall time of the run."""
    from torch.profiler import ProfilerActivity, profile

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        start.record()
        run()
        end.record()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    span_ms = start.elapsed_time(end)
    per_kernel = {}
    for ev in prof.events():
        if ev.device_type.name != "CUDA":
            continue
        name = ev.name[:60]
        per_kernel[name] = (per_kernel.get(name, 0.0)
                            + ev.time_range.elapsed_us() / 1e3)
    if not per_kernel:
        fail("profile: the profiler saw no device events")
    busy_ms = sum(per_kernel.values())
    for name, ms in sorted(per_kernel.items(), key=lambda kv: -kv[1]):
        print(f"  profile {ms / n_steps:9.4f} ms/step  {name}", flush=True)
    print(f"{label} profile over {n_steps} steps: device busy "
          f"{busy_ms:.3f} ms, CUDA-event span {span_ms:.3f} ms, host wall "
          f"{wall_ms:.3f} ms; idle share {1 - busy_ms / span_ms:.4f} of the "
          f"span, {1 - busy_ms / wall_ms:.4f} of the wall", flush=True)


def main() -> int:
    import torch

    args = sys.argv[1:]
    do_profile = "--profile" in args
    do_ghia1000 = "--ghia1000" in args

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script needs a CUDA device", file=sys.stderr)
        return 2

    from cfd_tpu_torch import FlowField, Grid
    from cfd_tpu_torch.api import Simulation
    from cfd_tpu_torch.boundary import (DirichletValues,
                                        apply_dirichlet_scalar,
                                        apply_neumann_scalar)
    from cfd_tpu_torch.entry import entry
    from cfd_tpu_torch.ops.kernels import euler2d as e2m
    from cfd_tpu_torch.ops.kernels import euler_kernels as ekm
    from cfd_tpu_torch.ops.kernels import native
    from cfd_tpu_torch.ops.kernels import projection2d as pk2m
    from cfd_tpu_torch.ops.kernels import projection_kernels as pkm
    from cfd_tpu_torch.ops.kernels import rk2d as rk2m
    from cfd_tpu_torch.ops.kernels import rk_kernels as rkm
    from cfd_tpu_torch.ops.kernels import rolling, tdma
    from cfd_tpu_torch.solvers.ns.common import (field_status_and_diagnostics,
                                                 source_basis)
    from cfd_tpu_torch.solvers.ns.euler import make_euler_step
    from cfd_tpu_torch.solvers.ns.params import NSParams
    from cfd_tpu_torch.solvers.ns.projection import make_projection_step
    from cfd_tpu_torch.solvers.ns.rk import make_rk2_step, make_rk4_step
    from cfd_tpu_torch.solvers.ns.rollout import run_steps
    from cfd_tpu_torch.solvers.poisson.base import Method, PoissonProblem
    from cfd_tpu_torch.solvers.poisson.spectral import (
        make_dst2d_fused_pieces, make_dst_fused_pieces)

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- phase 1: the card -------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        "nvidia-smi unavailable"
    print(card, flush=True)
    print(f"phase 1 card: {torch.cuda.get_device_name(0)} | torch "
          f"{torch.__version__} | CUDA {torch.version.cuda} | "
          f"{torch.cuda.device_count()} device(s)", flush=True)

    # ---- phase 2: build ----------------------------------------------------
    t0 = time.perf_counter()
    native.library()
    print(f"phase 2 build: {native.library_path().name} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for line in (native.BUILD_DIR / "build.log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}", flush=True)

    # ---- helpers -------------------------------------------------------------
    def sync():
        torch.cuda.synchronize(dev)

    def cuda_ms(fn, reps=3):
        fn()
        sync()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        sync()
        return start.elapsed_time(end) / reps

    # (path, wrapper name) -> dict of numbers (512³ / 2048² where measured)
    records = {}

    def compare(tag, name, got, ref, tol, scaled):
        """max abs error, and error relative to max|ref|; fail beyond.
        Returns both."""
        got, ref = got.double(), ref.double()
        if not torch.isfinite(got).all() or not torch.isfinite(ref).all():
            fail(f"{tag} {name}: non-finite output")
        err = float((got - ref).abs().max())
        scale = max(float(ref.abs().max()), 1e-30)
        rel = err / scale
        bound = tol * scale if scaled else tol
        print(f"  {tag} {name}: max_abs={err:.3e} max_rel={rel:.3e} "
              f"bound={bound:.3e}", flush=True)
        if not err <= bound:
            fail(f"{tag} {name}: error {err:.3e} above bound {bound:.3e}")
        return err, rel

    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts
                   if torch.is_tensor(t))

    def bound(n_bytes, flops):
        """(ms, "bytes" or "operations"): the least time the card could
        take to move ``n_bytes`` and do ``flops`` float32 operations."""
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / FP32_FLOPS * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else \
            (t_ops, "operations")

    def check(path, tag, timed, wrapper, replaces, source, kernel, plain,
              outs, tols, work=None, library=None):
        """Run ``kernel`` (the wrapper) and ``plain`` on the same inputs,
        compare each output; time both when ``timed``.  ``path`` names the
        main path whose launch count the record takes (the Thomas and
        SGEMM wrappers serve "3d" and "2d").  ``work`` = (input tensors,
        flops) gives the bound, with every input read once and every
        output written once; ``library`` is one PyTorch call computing the
        same function, timed beside the kernel (the port never calls
        it)."""
        name = wrapper.__name__
        got = kernel()
        ref = plain()
        sync()
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        rec = records.setdefault((path, name), {
            "replaces": replaces, "source": source, "max_abs_err": 0.0,
            "max_rel_err": 0.0})
        for o, gk, rk, (tol, scaled) in zip(outs, got, ref, tols):
            err, rel = compare(tag, f"{name}.{o}", gk, rk, tol, scaled)
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            rec["max_rel_err"] = max(rec["max_rel_err"], rel)
        if timed:
            rec["ms"] = cuda_ms(kernel)
            rec["plain_ms"] = cuda_ms(plain)
            rec["library_ms"] = None if library is None else \
                cuda_ms(library)
            ins, flops = work
            rec["bound_ms"], rec["bound_by"] = bound(
                nbytes(ins) + nbytes(got), flops)
            print(f"  {tag} {name}: kernel {rec['ms']:.3f} ms, plain "
                  f"{rec['plain_ms']:.3f} ms, library "
                  f"{rec['library_ms']} ms, bound {rec['bound_ms']:.3f} "
                  f"ms ({rec['bound_by']})", flush=True)
        return ref

    def gemm_flops(m, n, k, batch=1):
        return 2.0 * m * n * k * batch

    def ieee_matmul(fn):
        """``fn`` run with TF32 off (IEEE fp32, as the SGEMM)."""
        def run():
            with rolling.ieee_fp32_matmul():
                return fn()
        return run

    fld = (TOL_FIELD, False)
    exact = (TOL_EXACT, True)
    gemm = (TOL_GEMM, True)

    def noisy(f, gen_seed):
        g = torch.Generator(device=dev).manual_seed(gen_seed)

        def noise(t):
            return t + 0.1 * torch.randn(t.shape, generator=g, device=dev)

        return f.replace(u=noise(f.u), v=noise(f.v), w=noise(f.w),
                         p=noise(f.p))

    def make_inputs(n_grid, gen_seed):
        nz, ny, nx = n_grid
        grid = Grid.uniform(nx, ny, nz, zmin=0.0, zmax=1.0)
        f = noisy(FlowField.initialize(grid, dtype=torch.float32,
                                       device=dev), gen_seed)
        problem = PoissonProblem(nx, ny, nz, grid.dx0, grid.dy0, grid.dz0)
        mats, (mu, w) = make_dst_fused_pieces(problem, torch.float32, dev)
        c = pkm.StencilConsts(nz, ny, nx, grid.dx0, grid.dy0, grid.dz0,
                              grid.xmin, grid.ymin, NSParams().mu, True)
        return f, mats, mu, w, c

    # ---- phase 3: each kernel against its plain version ----------------------
    for shape in ((16, 64, 128), (N_BIG, N_BIG, N_BIG)):
        big = shape[0] == N_BIG
        tag = "x".join(map(str, shape[::-1]))
        print(f"phase 3 kernels vs plain at {tag} (nx×ny×nz)", flush=True)
        f, (fxt, fy, gxt, gy), mu, w, c = make_inputs(shape, SEED)
        dt = torch.full((), 1e-3, device=dev)
        scal = torch.stack([dt, torch.full((), 0.1, device=dev),
                            torch.full((), 0.05, device=dev)])
        rod = 1.0 / dt
        s = dt / 1.0
        cells = f.u.numel()
        nz_, ny_, nx_ = shape

        def dot_work(x, right, left):
            return ((x, right, left),
                    gemm_flops(nz_ * ny_, nx_, nx_)
                    + gemm_flops(ny_, nx_, ny_, nz_))

        def dot_library(x, right, left):
            # one call: left · x[k] · right on every plane
            return ieee_matmul(lambda: torch.einsum("ij,kjl,lm->kim", left,
                                                    x, right))

        us, vs, ws = check(
            "3d", tag, big, pkm.predictor_star, A1, SRC,
            lambda: pkm.predictor_star(f.u, f.v, f.w, scal, c),
            lambda: pkm.predictor_star_plain(f.u, f.v, f.w, scal, c),
            ("u*", "v*", "w*"), (fld,) * 3,
            work=((f.u, f.v, f.w, scal),
                  FLOPS_PER_POINT["predictor_star"] * cells))
        bt = check(
            "3d", tag, big, pkm.poisson_input, A1, SRC,
            lambda: pkm.poisson_input(us, vs, ws, f.p, rod, c),
            lambda: pkm.poisson_input_plain(us, vs, ws, f.p, rod, c),
            ("b~",), (exact,),
            work=((us, vs, ws, f.p), FLOPS_PER_POINT["poisson_input"]
                  * cells))[0]
        bhat = check(
            "3d", tag, big, rolling.plane_dot, DOT, SRC,
            lambda: rolling.plane_dot(bt, fxt, fy),
            lambda: rolling.plane_dot_plain(bt, fxt, fy),
            ("forward",), (gemm,), work=dot_work(bt, fxt, fy),
            library=dot_library(bt, fxt, fy))[0]
        d, t = check(
            "3d", tag, big, tdma.tdma_z_fwd, A1, SRC,
            lambda: tdma.tdma_z_fwd(bhat, mu, w),
            lambda: tdma.tdma_z_fwd_reference(bhat, mu, w),
            ("d'", "t"), (exact, exact),
            work=((bhat, mu), FLOPS_PER_POINT["tdma_fwd"] * cells))
        xhat = check(
            "3d", tag, big, tdma.tdma_z_bwd, A2, SRC,
            lambda: tdma.tdma_z_bwd(d, t),
            lambda: tdma.tdma_z_bwd_reference(d, t),
            ("x^",), (exact,),
            work=((d, t), FLOPS_PER_POINT["tdma_bwd"] * cells))[0]
        p = check(
            "3d", tag, big, rolling.plane_dot, DOT, SRC,
            lambda: rolling.plane_dot(xhat, gxt, gy),
            lambda: rolling.plane_dot_plain(xhat, gxt, gy),
            ("inverse",), (gemm,), work=dot_work(xhat, gxt, gy),
            library=dot_library(xhat, gxt, gy))[0]
        check("3d", tag, big, pkm.corrector, A2, SRC,
              lambda: pkm.corrector(us, vs, ws, p, s, c),
              lambda: pkm.corrector_plain(us, vs, ws, p, s, c),
              ("u", "v", "w", "max|u|^2", "max p", "max|p|"),
              (fld,) * 3 + ((TOL_DIAG, True), gemm, gemm),
              work=((us, vs, ws, p), FLOPS_PER_POINT["corrector"] * cells))

        # the two mega kernels as the step calls them
        kern = pkm.ProjectionKernels(*shape, c.dx, c.dy, c.dz, c.xmin,
                                     c.ymin, c.nu, (fxt, fy, gxt, gy),
                                     (mu, w))
        ref = pkm.ProjectionKernels(*shape, c.dx, c.dy, c.dz, c.xmin,
                                    c.ymin, c.nu, (fxt, fy, gxt, gy),
                                    (mu, w), plain=True)
        su, sv = scal[1], scal[2]
        a1k = kern.predictor_poisson_input(f.u, f.v, f.w, f.p, dt, su, sv,
                                           rod)
        a1p = ref.predictor_poisson_input(f.u, f.v, f.w, f.p, dt, su, sv,
                                          rod)
        sync()
        for o, gk, rk, tl in zip(("u*", "v*", "w*", "d'", "t"), a1k, a1p,
                                 (fld,) * 3 + (gemm, exact)):
            compare(tag, f"A1.{o}", gk, rk, *tl)
        a2k = kern.corrector_bwd_diag(*a1p, s)
        a2p = ref.corrector_bwd_diag(*a1p, s)
        sync()
        for o, gk, rk, tl in zip(
                ("u", "v", "w", "p", "max|u|^2", "max p", "max|p|"), a2k,
                a2p, (fld,) * 3 + (gemm, (TOL_DIAG, True), gemm, gemm)):
            compare(tag, f"A2.{o}", gk, rk, *tl)
        del f, us, vs, ws, bt, bhat, d, t, xhat, p, a1k, a1p, a2k, a2p
        torch.cuda.empty_cache()

    # ---- phase 3 (2D): each 2D kernel against its plain version -------------
    for ny, nx in ((32, 128), (N_2D, N_2D)):
        big = nx == N_2D
        tag = f"{nx}x{ny}"
        print(f"phase 3 2D kernels vs plain at {tag} (nx×ny)", flush=True)
        grid = Grid.uniform(nx, ny)
        f = noisy(FlowField.initialize(grid, dtype=torch.float32,
                                       device=dev), SEED)
        problem = PoissonProblem(nx, ny, 1, grid.dx0, grid.dy0)
        fxt, gxt, ysolve = make_dst2d_fused_pieces(problem, torch.float32,
                                                   dev)
        ysolve_plain = make_dst2d_fused_pieces(problem, torch.float32, dev,
                                               plain=True)[2]
        (mu, w), (fyp, gyp, k_res) = ysolve.line, ysolve.rescue
        c = pkm.StencilConsts(1, ny, nx, grid.dx0, grid.dy0, 0.0,
                              grid.xmin, grid.ymin, NSParams().mu, True)
        dt = torch.full((), 1e-3, device=dev)
        scal = torch.stack([dt, torch.full((), 0.1, device=dev),
                            torch.full((), 0.05, device=dev)])
        rod, s = 1.0 / dt, dt / 1.0
        cells = f.u.numel()

        us, vs, ws = check(
            "2d", tag, big, pk2m.predictor_star_2d, P2, SRC_2D,
            lambda: pk2m.predictor_star_2d(f.u, f.v, f.w, scal, c),
            lambda: pkm.predictor_star_plain(f.u, f.v, f.w, scal, c),
            ("u*", "v*", "w*"), (fld,) * 3,
            work=((f.u, f.v, f.w, scal),
                  FLOPS_PER_POINT["predictor_star"] * cells))
        bt = check(
            "2d", tag, big, pk2m.poisson_input_2d, P2, SRC_2D,
            lambda: pk2m.poisson_input_2d(us, vs, f.p, rod, c),
            lambda: pk2m.poisson_input_2d_plain(us, vs, f.p, rod, c),
            ("b~",), (exact,),
            work=((us, vs, f.p), FLOPS_PER_POINT["poisson_input"]
                  * cells))[0]
        bhat = check(
            "2d", tag, big, rolling.right_dot, DOT2, SRC,
            lambda: rolling.right_dot(bt, fxt),
            lambda: rolling.right_dot_plain(bt, fxt),
            ("forward",), (gemm,),
            work=((bt, fxt), gemm_flops(ny, fxt.shape[1], nx)),
            library=ieee_matmul(lambda: torch.matmul(bt, fxt)))[0]
        a = bhat[0]
        # the y-lines as one-row planes: (ny, 1, nx), μ (1, nx)
        d, t = check(
            "2d", tag, big, tdma.tdma_z_fwd, TDMA2, SRC,
            lambda: tdma.tdma_z_fwd(a[:, None, :], mu[None, :], w),
            lambda: tdma.tdma_z_fwd_reference(a[:, None, :], mu[None, :],
                                              w),
            ("d'", "t"), (exact, exact),
            work=((a, mu), FLOPS_PER_POINT["tdma_fwd"] * a.numel()))
        xline = check(
            "2d", tag, big, tdma.tdma_z_bwd, TDMA2, SRC,
            lambda: tdma.tdma_z_bwd(d, t),
            lambda: tdma.tdma_z_bwd_reference(d, t),
            ("x^",), (exact,),
            work=((d, t), FLOPS_PER_POINT["tdma_bwd"] * d.numel()))[0][
                :, 0, :]
        srhs = check(
            "2d", tag, big, rolling.left_dot, RESCUE, SRC,
            lambda: rolling.left_dot(fyp, a[:, :k_res]),
            lambda: rolling.left_dot_plain(fyp, a[:, :k_res]),
            ("Fy·a[:, :K]",), (gemm,),
            work=((fyp, a[:, :k_res]),
                  gemm_flops(fyp.shape[0], k_res, fyp.shape[1])),
            library=ieee_matmul(lambda: torch.matmul(fyp, a[:, :k_res])))[0]
        # the second rescue product writes x^'s first K columns in place
        outk, outp = xline.clone(), xline.clone()
        check("2d", tag, big, rolling.left_dot, RESCUE, SRC,
              lambda: rolling.left_dot(gyp, srhs, out=outk[:, :k_res]),
              lambda: rolling.left_dot_plain(gyp, srhs,
                                             out=outp[:, :k_res]),
              ("Gy·s",), (gemm,),
              work=((gyp, srhs),
                    gemm_flops(gyp.shape[0], k_res, gyp.shape[1])),
              library=ieee_matmul(lambda: torch.matmul(gyp, srhs)))
        compare(tag, "left_dot.untouched columns", outk[:, k_res:],
                outp[:, k_res:], *exact)
        xk = ysolve(bhat)
        xp = ysolve_plain(bhat)
        sync()
        compare(tag, "ysolve.x^", xk, xp, *gemm)
        p = check(
            "2d", tag, big, rolling.right_dot, DOT2, SRC,
            lambda: rolling.right_dot(xp, gxt),
            lambda: rolling.right_dot_plain(xp, gxt),
            ("inverse",), (gemm,),
            work=((xp, gxt), gemm_flops(ny, gxt.shape[1], gxt.shape[0])),
            library=ieee_matmul(lambda: torch.matmul(xp, gxt)))[0]
        check("2d", tag, big, pk2m.corrector_2d, C2, SRC_2D,
              lambda: pk2m.corrector_2d(us, vs, p, s, c),
              lambda: pk2m.corrector_2d_plain(us, vs, p, s, c),
              ("u", "v"), (fld,) * 2,
              work=((us, vs, p), FLOPS_PER_POINT["corrector"] * cells))

        # the two fused kernels as the step calls them
        kern = pk2m.Projection2DKernels(ny, nx, c.dx, c.dy, c.xmin, c.ymin,
                                        c.nu, (fxt, gxt))
        ref = pk2m.Projection2DKernels(ny, nx, c.dx, c.dy, c.xmin, c.ymin,
                                       c.nu, (fxt, gxt), plain=True)
        su, sv = scal[1], scal[2]
        pk = kern.predictor_and_poisson_input(f.u, f.v, f.w, f.p, dt, su,
                                              sv, rod)
        pp = ref.predictor_and_poisson_input(f.u, f.v, f.w, f.p, dt, su,
                                             sv, rod)
        ck = kern.corrector(pp[0], pp[1], xp, s)
        cp = ref.corrector(pp[0], pp[1], xp, s)
        sync()
        for o, gk, rk, tl in zip(("u*", "v*", "w*", "b~FxT"), pk, pp,
                                 (fld,) * 3 + (gemm,)):
            compare(tag, f"pred_bt.{o}", gk, rk, *tl)
        for o, gk, rk, tl in zip(("u", "v", "p"), ck, cp, (fld,) * 2
                                 + (gemm,)):
            compare(tag, f"corr.{o}", gk, rk, *tl)
        del f, us, vs, ws, bt, bhat, a, d, t, xline, srhs, outk, outp, xk
        del xp, p
        del pk, pp, ck, cp
        torch.cuda.empty_cache()

    # ---- phase 4: the 3D main path -----------------------------------------
    pkm.reset_launch_counts()
    step, (field, dt0, it0) = entry(device="cuda")
    field3, res3 = run_steps(step, field, dt0, 3, start_iter=it0)
    sync()
    print(f"phase 4 entry(device='cuda') 3 steps: status "
          f"{int(res3.status)}, max|u| {float(res3.max_velocity):.6f}, "
          f"max p {float(res3.max_pressure):.6f}", flush=True)
    if int(res3.status) != 0 or not bool(field3.is_finite()):
        fail("entry steps: nonzero status or non-finite fields")
    grid_e = Grid.uniform(128, 64, 16, zmin=0.0, zmax=1.0)
    plain_e = make_projection_step(grid_e, NSParams(), torch.float32,
                                   Method.FFT_DIRECT, device=dev, plain=True)
    field3p, res3p = run_steps(plain_e, field, dt0, 3, start_iter=it0)
    sync()
    for name in "uvw":
        compare("entry 3 steps", name, getattr(field3, name),
                getattr(field3p, name), TOL_FIELD, False)
    compare("entry 3 steps", "p", field3.p, field3p.p, TOL_GEMM, True)

    n = N_BIG
    grid = Grid.uniform(n, n, n, zmin=0.0, zmax=1.0)
    params = NSParams(source_amplitude_u=0.0, source_amplitude_v=0.0,
                      mu=0.01)

    def tg_field(shape):
        """bench.py:41-60 — Taylor-Green-like velocity, p = 1, rho = 1,
        T = 300, on an (nz, ny, nx) grid (nz = 1 in 2D)."""
        nz, ny, nx = shape
        two_pi = 2.0 * torch.pi

        def lin(m):
            return torch.linspace(0.0, 1.0, m, dtype=torch.float32,
                                  device=dev)

        uu = (torch.sin(two_pi * lin(nx))[None, None, :]
              * torch.cos(two_pi * lin(ny))[None, :, None])
        if nz > 1:
            uu = uu * torch.cos(two_pi * lin(nz))[:, None, None]
        uu = uu.expand(shape).contiguous()
        return FlowField(u=uu, v=-uu, w=torch.zeros(shape, device=dev),
                         p=torch.ones(shape, device=dev),
                         rho=torch.ones(shape, device=dev),
                         T=torch.full(shape, 300.0, device=dev))

    def timed_paths(phase, size, grid, params, shape, dt, n_steps,
                    wrappers, first_step_only=False):
        """Kernel path, then plain path: the first ``n_steps`` steps from
        the start field, as ``bench.py:_time_steps`` times them, once to
        warm up and once timed.  Both runs have one call pattern (the
        caller holds the start field), so the caching allocator already
        holds every block the timed steps need — a cudaMalloc inside the
        timed window costs tens of ms at 512³.  Kernel and plain are held
        against each other after the timed steps, or with
        ``first_step_only`` after one step.  Returns (ms/step, launch
        counts)."""
        label = f"phase {phase} {size}"
        finals, firsts, ms, counts = {}, {}, {}, {}
        cells = 1
        for m in shape:
            cells *= m
        for path in ("kernel", "plain"):
            stepf = make_projection_step(grid, params, torch.float32,
                                         Method.FFT_DIRECT, device=dev,
                                         plain=path == "plain")
            if first_step_only:
                firsts[path] = stepf(tg_field(shape), dt, 0)[0]
            f0 = tg_field(shape)
            run_steps(stepf, f0, dt, n_steps)
            sync()
            torch.cuda.reset_peak_memory_stats(dev)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            f2, r2 = run_steps(stepf, f0, dt, n_steps)
            end.record()
            sync()
            ms[path] = start.elapsed_time(end) / n_steps
            peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30
            mlups = cells / (ms[path] * 1e-3) / 1e6
            finite, vmax, pmax, _ = field_status_and_diagnostics(f2)
            print(f"{label} {path} path: {ms[path]:.3f} ms/step, "
                  f"{mlups:.1f} MLUPS, peak device memory "
                  f"{peak_gib:.2f} GiB, status {int(r2.status)}, "
                  f"max|u| {float(r2.max_velocity):.6f} (full-field "
                  f"{float(vmax):.6f}), max p {float(r2.max_pressure):.6f} "
                  f"(full-field {float(pmax):.6f})", flush=True)
            if int(r2.status) != 0 or not bool(finite):
                fail(f"{label} {path} path: nonzero status or non-finite "
                     f"fields")
            if path == "kernel":
                counts = {fn.__name__: fn.launches for fn in wrappers}
                print(f"{label} launch counts over the main path: "
                      f"{counts}", flush=True)
                missing = [k for k, v in counts.items() if v <= 0]
                if missing:
                    fail(f"kernels not launched on the main path: "
                         f"{missing}")
            finals[path] = f2
            del f0
            if path == "kernel" and do_profile:
                # same call pattern as the timed run: the caller holds
                # the start field, so the allocator already has every
                # block
                profile_steps(torch, f"phase 5 {size}",
                              lambda: run_steps(stepf, f2, dt,
                                                PROFILED_STEPS,
                                                start_iter=n_steps),
                              PROFILED_STEPS)
        if not first_step_only:
            tag = f"{label} {n_steps} steps"
            for name in "uvw":
                compare(tag, name, getattr(finals["kernel"], name),
                        getattr(finals["plain"], name), TOL_FIELD, False)
            compare(tag, "p", finals["kernel"].p, finals["plain"].p,
                    TOL_GEMM, True)
            return ms, counts
        # u = u* − (dt/ρ)(p₊ − p₋)·inv_2dx passes a p difference within
        # the SGEMM bar on to u and v, at most 2·dt·inv_2dx·TOL_GEMM·max|p|
        # (ρ = 1); w is not corrected in 2D
        fk, fp = firsts["kernel"], firsts["plain"]
        inv_2dx = 1.0 / (2.0 * grid.dx0)
        tol_uv = TOL_FIELD + (2.0 * dt * inv_2dx * TOL_GEMM
                              * float(fp.p.abs().max()))
        tag = f"{label} first step"
        for name, tol in (("u", tol_uv), ("v", tol_uv), ("w", TOL_FIELD)):
            compare(tag, name, getattr(fk, name), getattr(fp, name), tol,
                    False)
        compare(tag, "p", fk.p, fp.p, TOL_GEMM, True)
        return ms, counts

    # the counters were set to 0 before the entry steps above
    ms3, counts3 = timed_paths(4, f"{n}^3", grid, params, (n, n, n), 1e-4,
                               TIMED_STEPS, pkm.WRAPPERS)
    torch.cuda.empty_cache()

    # ---- phase 6: the 2D main path (bench.py:run_2d(2048)) ------------------
    # This configuration is unstable: its diffusion number 8·ν·dt/dx² is
    # 3.35, past the explicit limit 2, so a grid-scale mode grows ~2.1× a
    # step (in the reference's float64 jnp step too) and meets the ±100
    # clamps near step 24.  The 20 timed steps come before the clamps;
    # kernel and plain are held against each other one step from the
    # start, before the growth amplifies their rounding differences.
    n2 = N_2D
    pk2m.reset_launch_counts()
    ms2, counts2 = timed_paths(6, f"{n2}^2", Grid.uniform(n2, n2), params,
                               (1, n2, n2), 1e-5, TIMED_STEPS_2D,
                               pk2m.WRAPPERS, first_step_only=True)

    # ---- phase 7 (and 8): the lid-driven cavity against Ghia's table -------
    spec = importlib.util.spec_from_file_location("ghia_data", GHIA)
    ghia = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ghia)           # numpy only

    def ghia_gate(label, nc, re, dt, steps, bar):
        """bench.py:615-702 on the kernel path: quiescent start, p = 0;
        each step first applies the lid (u = 1 on top), no-slip v and a
        Neumann p, then one projection step.  Status must be 0 on every
        step (folded on the device, read once)."""
        gridc = Grid.uniform(nc, nc)
        stepc = make_projection_step(
            gridc, NSParams(source_amplitude_u=0.0, source_amplitude_v=0.0,
                            mu=1.0 / re),
            torch.float32, Method.FFT_DIRECT, device=dev)
        lid, wall = DirichletValues(top=1.0), DirichletValues()
        fc = FlowField.quiescent(nc, nc, pressure=0.0, dtype=torch.float32,
                                 device=dev)
        worst = torch.zeros((), dtype=torch.int32, device=dev)
        sync()
        t0 = time.perf_counter()
        for i in range(steps):
            fc = fc.replace(u=apply_dirichlet_scalar(fc.u, lid),
                            v=apply_dirichlet_scalar(fc.v, wall),
                            p=apply_neumann_scalar(fc.p))
            fc, rc = stepc(fc, dt, i)
            worst = torch.maximum(worst, rc.status.abs())
        sync()
        ms_step = (time.perf_counter() - t0) * 1e3 / steps
        u = fc.u[0].double().cpu().numpy()
        v = fc.v[0].double().cpu().numpy()
        h = nc // 2
        if nc % 2 == 0:
            u_prof = 0.5 * (u[:, h - 1] + u[:, h])
            v_prof = 0.5 * (v[h - 1, :] + v[h, :])
        else:
            u_prof, v_prof = u[:, h], v[h, :]
        rms_u = ghia.profile_rms_error(gridc.y, u_prof, ghia.Y_COORDS,
                                       ghia.U_TABLES[re])
        rms_v = ghia.profile_rms_error(gridc.x, v_prof, ghia.X_COORDS,
                                       ghia.V_TABLES[re])
        print(f"{label} Ghia Re={re} {nc}^2 dt={dt} {steps} steps: "
              f"rms_u {rms_u:.5f} rms_v {rms_v:.5f} (bar {bar}), worst "
              f"status {int(worst)}, {ms_step:.4f} ms/step host wall",
              flush=True)
        if int(worst) != 0:
            fail(f"Ghia Re={re}: a step returned a nonzero status")
        if not (rms_u < bar and rms_v < bar):
            fail(f"Ghia Re={re}: centerline RMS above {bar}")

    ghia_gate("phase 7", 128, 100, 5e-4, 20000, 0.10)
    if do_ghia1000:
        ghia_gate("phase 8", 512, 1000, 4e-4, 150000, 0.01)

    # ---- phase 9: the explicit kernels against their plain versions --------
    names6 = ("u", "v", "w", "p", "rho", "T")
    maxima4 = ("max|u|^2", "max p", "max|p|", "max T")

    def uniform_grid(shape):
        nz, ny, nx = shape
        if nz > 1:
            return Grid.uniform(nx, ny, nz, zmin=0.0, zmax=1.0)
        return Grid.uniform(nx, ny)

    for shape in ((11, 23, 37), (N_EXPL,) * 3, (1, 23, 37), (1, N_2D, N_2D)):
        nz, ny, nx = shape
        three_d = nz > 1
        big = nx in (N_EXPL, N_2D)
        tag = "x".join(map(str, shape[::-1] if three_d else shape[:0:-1]))
        print(f"phase 9 explicit kernels vs plain at {tag}", flush=True)
        grid = uniform_grid(shape)
        gen = torch.Generator(device=dev).manual_seed(SEED)

        def rnd(scale, shape=shape, gen=gen):
            return scale * torch.randn(shape, generator=gen, device=dev)

        f = FlowField.initialize(grid, dtype=torch.float32, device=dev)
        u = f.u + rnd(0.3)
        u[nz // 2, ny // 3, nx // 3] = 150.0     # the clamps
        rho = f.rho + rnd(0.01)
        rho[nz // 2, ny // 2, nx // 2] = 1e-12   # the per-point ρ guard
        f = FlowField(u=u, v=f.v + rnd(0.3), w=rnd(0.3), p=f.p + rnd(0.3),
                      rho=rho, T=f.T + rnd(1.0))
        c = ekm.ExplicitConsts(nz, ny, nx, grid.dx0, grid.dy0, grid.dz0,
                               0.01, 0.1)
        sy, sx = source_basis(grid, torch.float32, dev)
        cells = f.u.numel()

        ew = ekm.euler_step if three_d else e2m.euler2d_step
        ins = (f.u, f.v, f.w, f.p, f.T, f.rho, sy, sx,
               torch.tensor([1e-4, 0.08, 0.04], device=dev))
        check("euler3d" if three_d else "euler2d", tag, big, ew,
              E3 if three_d else E2, SRC_E, lambda: ew(*ins, c),
              lambda: ekm.euler_step_plain(*ins, c), names6 + maxima4,
              (exact,) * 10, work=(ins, FLOPS_PER_POINT["euler"] * cells))

        sw = rkm.rk_stage if three_d else rk2m.rk2d_stage
        q0 = (f.u, f.v, f.w, f.p)
        st = tuple(x + rnd(0.01) for x in q0)
        acc = tuple(rnd(5.0) for _ in range(4))
        # (stage, accumulator, final, factor, acc_mix, weight): RK4's
        # first and second stages and its final stage
        for label, a, final, fac, mix, wgt in (
                ("first", None, False, 5e-5, 0.0, 1.0),
                ("mid", acc, False, 5e-5, 0.0, 2.0),
                ("final", acc, True, 1e-4 / 6.0, 1.0, 0.0)):
            sc = torch.tensor([fac, mix, wgt, 0.08, 0.04], device=dev)
            read = (*st, *q0, f.rho, *(a or ()), sy, sx, sc) + (
                (f.T,) if final else ())
            outs = (names6 + maxima4 if final else
                    tuple(f"next {n}" for n in "uvwp")
                    + tuple(f"acc {n}" for n in "uvwp"))
            check("rk3d" if three_d else "rk2d", f"{tag} {label}",
                  big and label == "mid", sw, RK3 if three_d else RK2,
                  SRC_RK,
                  lambda: sw(st, q0, f.rho, f.T, a, sy, sx, sc, c, final),
                  lambda: rkm.rk_stage_plain(st, q0, f.rho, f.T, a, sy, sx,
                                             sc, c, final),
                  outs, (exact,) * len(outs),
                  work=(read, FLOPS_PER_POINT["rk_stage"] * cells))
        del f, u, rho, ins, q0, st, acc
        torch.cuda.empty_cache()

    # ---- phase 10: the explicit main paths (bench.py's configurations) ----
    makers = {"euler": make_euler_step, "rk2": make_rk2_step,
              "rk4": make_rk4_step}
    launch_counts = {"3d": counts3, "2d": counts2}
    explicit_ms = {}

    def explicit_path(method, shape, n_steps, path_key, wrapper):
        """bench.py:run_euler_3d / run_euler_2d / run_rk_3d / run_rk_2d:
        the Taylor-Green field, sources off, ν = 0.01, dt = 1e-5, on the
        kernel path and the plain path — one step from the start, then
        ``n_steps`` once to warm up and once timed with CUDA events.
        Kernel and plain are held against each other after the first
        step and after the timed steps.  The launch counter is set to 0
        just before the kernel path and read just after it."""
        nz, ny, nx = shape
        grid = uniform_grid(shape)
        params = NSParams(source_amplitude_u=0.0, source_amplitude_v=0.0,
                          mu=0.01)
        size = f"{nx}^3" if nz > 1 else f"{nx}^2"
        label = f"phase 10 {method} {size}"
        cells = nx * ny * nz
        firsts, finals, ms = {}, {}, {}
        for path in ("kernel", "plain"):
            if path == "kernel":
                wrapper.launches = 0
            stepf = makers[method](grid, params, torch.float32, dev,
                                   plain=path == "plain")
            firsts[path] = stepf(tg_field(shape), EXPL_DT, 0)[0]
            f0 = tg_field(shape)
            run_steps(stepf, f0, EXPL_DT, n_steps)
            sync()
            torch.cuda.reset_peak_memory_stats(dev)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            f2, r2 = run_steps(stepf, f0, EXPL_DT, n_steps)
            end.record()
            sync()
            ms[path] = start.elapsed_time(end) / n_steps
            peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30
            print(f"{label} {path} path: {ms[path]:.4f} ms/step, "
                  f"{cells / (ms[path] * 1e-3) / 1e6:.1f} MLUPS, peak "
                  f"device memory {peak_gib:.2f} GiB, status "
                  f"{int(r2.status)}, max|u| {float(r2.max_velocity):.6f}, "
                  f"max p {float(r2.max_pressure):.6f}", flush=True)
            if int(r2.status) != 0 or not bool(f2.is_finite()):
                fail(f"{label} {path} path: nonzero status or non-finite "
                     f"fields")
            if not float(r2.max_velocity) < 100.0:
                fail(f"{label} {path} path: max|u| reached the clamp")
            if path == "kernel":
                n_launch = wrapper.launches
                print(f"{label} launch counts over the main path: "
                      f"{{'{wrapper.__name__}': {n_launch}}} "
                      f"({n_launch / (2 * n_steps + 1):g} a step)",
                      flush=True)
                if n_launch <= 0:
                    fail(f"{wrapper.__name__} not launched on the main path")
                counts = launch_counts.setdefault(path_key, {})
                counts[wrapper.__name__] = (counts.get(wrapper.__name__, 0)
                                            + n_launch)
                if do_profile:
                    profile_steps(torch, f"phase 5 {method} {size}",
                                  lambda: run_steps(stepf, f2, EXPL_DT,
                                                    PROFILED_STEPS,
                                                    start_iter=n_steps),
                                  PROFILED_STEPS)
            finals[path] = f2
            del f0
        for name in names6:
            compare(f"{label} first step", name,
                    getattr(firsts["kernel"], name),
                    getattr(firsts["plain"], name), TOL_EXACT, True)
        # 2048² is past the explicit viscous limit (8·ν·dt/dx² = 3.35): a
        # grid-scale mode grows until the ±1000 second-derivative clamps
        # hold it, and it would amplify any rounding difference, so after
        # the timed steps the bar there is looser (1e-3 of max|ref|)
        tol_n = TOL_EXACT if nz > 1 else 1e-3
        for name in names6:
            compare(f"{label} {n_steps + 1} steps", name,
                    getattr(finals["kernel"], name),
                    getattr(finals["plain"], name), tol_n, True)
        explicit_ms[f"{method} {size}"] = ms

    n3, n2e = (N_EXPL,) * 3, (1, N_2D, N_2D)
    explicit_path("euler", n3, 10, "euler3d", ekm.euler_step)
    explicit_path("euler", n2e, 20, "euler2d", e2m.euler2d_step)
    for order in ("rk2", "rk4"):
        explicit_path(order, n3, 10, "rk3d", rkm.rk_stage)
        explicit_path(order, n2e, 10, "rk2d", rk2m.rk2d_stage)
    torch.cuda.empty_cache()

    # ---- phase 11: the facade (Simulation.create, default solver) ---------
    e2m.euler2d_step.launches = 0
    sim = Simulation.create(100, 50, device=dev)
    start_field = sim.field
    sync()
    t0 = time.perf_counter()
    for _ in range(FACADE_STEPS):
        status = sim.step()
        if status != 0:
            fail(f"phase 11 facade: step returned status {int(status)}")
    wall_ms = (time.perf_counter() - t0) * 1e3
    n_launch = e2m.euler2d_step.launches
    stats = sim.get_stats()
    print(f"phase 11 Simulation.create(100, 50) solver "
          f"{sim.solver.name}: {FACADE_STEPS} step()s in {wall_ms:.1f} ms "
          f"host wall ({wall_ms / FACADE_STEPS:.4f} ms a step, each "
          f"waiting for the card), time {sim.current_time:.4f}, max|u| "
          f"{stats.max_velocity:.6f}, max p {stats.max_pressure:.6f}, "
          f"euler2d_step launches {n_launch}", flush=True)
    if sim.solver.name != "explicit_euler" or n_launch != FACADE_STEPS:
        fail("phase 11 facade: not the fused Euler kernel once a step")
    launch_counts["facade"] = {"euler2d_step": n_launch}
    plain_step = make_euler_step(sim.grid, sim.params, torch.float32, dev,
                                 plain=True)
    fp = start_field
    for _ in range(FACADE_STEPS):
        fp, rp = plain_step(fp, 0.005, 0)      # Simulation.step's dt, iter
    sync()
    for name in names6:
        compare(f"phase 11 facade {FACADE_STEPS} steps", name,
                getattr(sim.field, name), getattr(fp, name), TOL_EXACT,
                True)

    kernels = []
    for (path, name), rec in records.items():
        launches = launch_counts.get(path, {}).get(name)
        if launches is None:
            fail(f"{name}: no main path of {path} counted its launches")
        kernels.append({
            "name": name, "path": path, "route": "cuda",
            "source": rec["source"], "replaces": rec["replaces"],
            "launches": launches, "max_abs_err": rec["max_abs_err"],
            "max_rel_err": rec["max_rel_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"]})
    print(json.dumps({"kernels": kernels, "step_ms": ms3,
                      "grid": f"{n}x{n}x{n}", "step_ms_2d": ms2,
                      "grid_2d": f"{n2}x{n2}", "explicit_step_ms":
                      explicit_ms, "card": card}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
