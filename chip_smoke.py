#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels of ``cfd_tpu_torch`` from the
sources in the checkout, holds every kernel against its plain PyTorch
version on the card (at the entry grid 128×64×16 and at 512³), drives the
main path — ``cfd_tpu_torch.entry.entry(device="cuda")`` for 3 steps and
the 512³ Taylor-Green projection step (``bench.py:run_3d``'s
configuration) for 5 warm-up and 5 timed steps on both the kernel path
and the plain path — and checks status, finiteness, launch counters and
kernel-vs-plain agreement.  Any failure exits non-zero.  The line before
the last is a JSON object describing each kernel; the last line is
``{"ok": true, "device": {...}}``.  It imports nothing of JAX.

    python3 chip_smoke.py --profile

adds phase 5: 3 more 512³ kernel-path steps under ``torch.profiler``,
printing the device time per kernel, the device busy time against the
CUDA-event span and host wall time of those steps (the device's idle
share), and the peak device memory of the step.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

SEED = 0
N_BIG = 512            # the benchmark grid, 512³
TIMED_STEPS = 5
SRC = "cfd_tpu_torch/csrc/projection_kernels.cu"
A1 = "cfd_tpu/ops/pallas/projection_kernels.py:572"   # pred_bt_compute
A2 = "cfd_tpu/ops/pallas/projection_kernels.py:381"   # corr_bwd_compute
DOT = "cfd_tpu/ops/pallas/projection_kernels.py:226"  # plane_dot_rl

# Tolerances, kernel against plain version on identical inputs, float32:
#  * fields (u*, v*, w*, u, v, w): atol 2e-5, the reference's own
#    fused-vs-plain bar (tests/math/test_mega_kernels.py:57-60);
#  * stencil and Thomas outputs (b̃, d′, t, x̂): same operation order in
#    kernel and plain version (-fmad=false), so expected exact; bound at
#    1e-6 of the output's max magnitude;
#  * DST products and everything downstream of them (p, transformed
#    planes, max p, max|p|): the SGEMM sums K terms in another order than
#    cuBLAS, so the bound scales with the magnitude — 2e-5 of max|ref|
#    (≈ sqrt(512) ulps of headroom over a 512-term fp32 sum);
#  * max|u|²: rtol 1e-6 (tests/math/test_mega_kernels.py:63-66).
TOL_FIELD = 2e-5
TOL_EXACT = 1e-6
TOL_GEMM = 2e-5
TOL_DIAG = 1e-6


PROFILED_STEPS = 3


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def profile_steps(torch, run, n_steps):
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
    print(f"phase 5 profile over {n_steps} steps: device busy "
          f"{busy_ms:.3f} ms, CUDA-event span {span_ms:.3f} ms, host wall "
          f"{wall_ms:.3f} ms; idle share {1 - busy_ms / span_ms:.4f} of the "
          f"span, {1 - busy_ms / wall_ms:.4f} of the wall", flush=True)


def main() -> int:
    import torch

    do_profile = "--profile" in sys.argv[1:]

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script needs a CUDA device", file=sys.stderr)
        return 2

    from cfd_tpu_torch import FlowField, Grid
    from cfd_tpu_torch.entry import entry
    from cfd_tpu_torch.ops.kernels import native
    from cfd_tpu_torch.ops.kernels import projection_kernels as pkm
    from cfd_tpu_torch.ops.kernels import rolling, tdma
    from cfd_tpu_torch.solvers.ns.common import field_status_and_diagnostics
    from cfd_tpu_torch.solvers.ns.params import NSParams
    from cfd_tpu_torch.solvers.ns.projection import make_projection_step
    from cfd_tpu_torch.solvers.ns.rollout import run_steps
    from cfd_tpu_torch.solvers.poisson.base import Method, PoissonProblem
    from cfd_tpu_torch.solvers.poisson.spectral import make_dst_fused_pieces

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

    records = {}   # wrapper name -> dict of numbers (512³ where measured)

    def compare(tag, name, got, ref, tol, scaled):
        """max abs error, and error relative to max|ref|; fail beyond."""
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
        return err

    def make_inputs(n_grid, gen_seed):
        nz, ny, nx = n_grid
        grid = Grid.uniform(nx, ny, nz, zmin=0.0, zmax=1.0)
        f = FlowField.initialize(grid, dtype=torch.float32, device=dev)
        g = torch.Generator(device=dev).manual_seed(gen_seed)

        def noise(t):
            return t + 0.1 * torch.randn(t.shape, generator=g, device=dev)

        f = f.replace(u=noise(f.u), v=noise(f.v), w=noise(f.w), p=noise(f.p))
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

        def check(wrapper, replaces, kernel, plain, outs, tols):
            name = wrapper.__name__
            got = kernel()
            ref = plain()
            sync()
            got = got if isinstance(got, tuple) else (got,)
            ref = ref if isinstance(ref, tuple) else (ref,)
            err = 0.0
            for o, gk, rk, (tol, scaled) in zip(outs, got, ref, tols):
                err = max(err, compare(tag, f"{name}.{o}", gk, rk, tol,
                                       scaled))
            rec = records.setdefault(name, {"replaces": replaces,
                                            "max_abs_err": 0.0})
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            if big:
                rec["ms"] = cuda_ms(kernel)
                rec["plain_ms"] = cuda_ms(plain)
                print(f"  {tag} {name}: kernel {rec['ms']:.3f} ms, plain "
                      f"{rec['plain_ms']:.3f} ms", flush=True)
            return ref

        fld = (TOL_FIELD, False)
        exact = (TOL_EXACT, True)
        gemm = (TOL_GEMM, True)
        us, vs, ws = check(
            pkm.predictor_star, A1,
            lambda: pkm.predictor_star(f.u, f.v, f.w, scal, c),
            lambda: pkm.predictor_star_plain(f.u, f.v, f.w, scal, c),
            ("u*", "v*", "w*"), (fld,) * 3)
        bt = check(
            pkm.poisson_input, A1,
            lambda: pkm.poisson_input(us, vs, ws, f.p, rod, c),
            lambda: pkm.poisson_input_plain(us, vs, ws, f.p, rod, c),
            ("b~",), (exact,))[0]
        bhat = check(
            rolling.plane_dot, DOT,
            lambda: rolling.plane_dot(bt, fxt, fy),
            lambda: rolling.plane_dot_plain(bt, fxt, fy),
            ("forward",), (gemm,))[0]
        d, t = check(
            tdma.tdma_z_fwd, A1,
            lambda: tdma.tdma_z_fwd(bhat, mu, w),
            lambda: tdma.tdma_z_fwd_reference(bhat, mu, w),
            ("d'", "t"), (exact, exact))
        xhat = check(
            tdma.tdma_z_bwd, A2,
            lambda: tdma.tdma_z_bwd(d, t),
            lambda: tdma.tdma_z_bwd_reference(d, t),
            ("x^",), (exact,))[0]
        p = check(
            rolling.plane_dot, DOT,
            lambda: rolling.plane_dot(xhat, gxt, gy),
            lambda: rolling.plane_dot_plain(xhat, gxt, gy),
            ("inverse",), (gemm,))[0]
        check(pkm.corrector, A2,
              lambda: pkm.corrector(us, vs, ws, p, s, c),
              lambda: pkm.corrector_plain(us, vs, ws, p, s, c),
              ("u", "v", "w", "max|u|^2", "max p", "max|p|"),
              (fld,) * 3 + ((TOL_DIAG, True), gemm, gemm))

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

    # ---- phase 4: the main path --------------------------------------------
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

    def tg_field():
        """bench.py:41-60 — Taylor-Green-like velocity, p = 1, rho = 1,
        T = 300."""
        lin = torch.linspace(0.0, 1.0, n, dtype=torch.float32, device=dev)
        two_pi = 2.0 * torch.pi
        uu = (torch.sin(two_pi * lin)[None, None, :]
              * torch.cos(two_pi * lin)[None, :, None]
              * torch.cos(two_pi * lin)[:, None, None]).contiguous()
        shape = (n, n, n)
        return FlowField(u=uu, v=-uu, w=torch.zeros(shape, device=dev),
                         p=torch.ones(shape, device=dev),
                         rho=torch.ones(shape, device=dev),
                         T=torch.full(shape, 300.0, device=dev))

    finals, ms = {}, {}
    for path in ("kernel", "plain"):
        stepf = make_projection_step(grid, params, torch.float32,
                                     Method.FFT_DIRECT, device=dev,
                                     plain=path == "plain")
        # Warm-up with the same call pattern as the timed run (the caller
        # holds the start field), so the caching allocator already holds
        # every block the timed steps need: a cudaMalloc of a 512 MiB
        # block inside the timed window costs tens of ms.
        f0 = tg_field()
        f1, _ = run_steps(stepf, f0, 1e-4, TIMED_STEPS)
        del f0
        sync()
        torch.cuda.reset_peak_memory_stats(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        f2, r2 = run_steps(stepf, f1, 1e-4, TIMED_STEPS,
                           start_iter=TIMED_STEPS)
        end.record()
        sync()
        ms[path] = start.elapsed_time(end) / TIMED_STEPS
        peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        mlups = n ** 3 / (ms[path] * 1e-3) / 1e6
        finite, vmax, pmax, _ = field_status_and_diagnostics(f2)
        print(f"phase 4 {n}^3 {path} path: {ms[path]:.3f} ms/step, "
              f"{mlups:.1f} MLUPS, peak device memory {peak_gib:.2f} GiB, "
              f"status {int(r2.status)}, "
              f"max|u| {float(r2.max_velocity):.6f} (full-field "
              f"{float(vmax):.6f}), max p {float(r2.max_pressure):.6f} "
              f"(full-field {float(pmax):.6f})", flush=True)
        if int(r2.status) != 0 or not bool(finite):
            fail(f"{n}^3 {path} path: nonzero status or non-finite fields")
        if path == "kernel":
            counts = {fn.__name__: fn.launches for fn in pkm.WRAPPERS}
            print(f"phase 4 launch counts over the main path: {counts}",
                  flush=True)
            missing = [k for k, v in counts.items() if v <= 0]
            if missing:
                fail(f"kernels not launched on the main path: {missing}")
        finals[path] = f2
        del f1
        if path == "kernel" and do_profile:
            # same call pattern as the timed run: the caller holds the
            # start field, so the allocator already has every block
            profile_steps(torch, lambda: run_steps(
                stepf, f2, 1e-4, PROFILED_STEPS,
                start_iter=2 * TIMED_STEPS), PROFILED_STEPS)
    tag = f"{n}^3 {2 * TIMED_STEPS} steps"
    for name in "uvw":
        compare(tag, name,
                getattr(finals["kernel"], name),
                getattr(finals["plain"], name), TOL_FIELD, False)
    compare(tag, "p", finals["kernel"].p,
            finals["plain"].p, TOL_GEMM, True)

    kernels = [{"name": name, "route": "cuda", "source": SRC,
                "replaces": rec["replaces"], "launches": counts[name],
                "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                "plain_ms": rec["plain_ms"]}
               for name, rec in records.items()]
    print(json.dumps({"kernels": kernels, "step_ms": ms,
                      "grid": f"{n}x{n}x{n}", "card": card}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
