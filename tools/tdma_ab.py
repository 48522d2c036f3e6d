"""Time the 2D step's y-line Thomas solve, and the 2048² step around it, of
one or more checkouts of this repository on the card, in turns.

    python3 tools/tdma_ab.py --root OLD --root . --root . --root OLD \\
        [--check] [--out FILE]

Each ``--root`` is a checkout (a parent commit unpacked with ``git
archive`` into a directory that ``.gitignore`` lists will do), run in a
process of its own that imports that checkout's ``cfd_tpu_torch`` and
builds its kernels there; the roots run in the order given, so parent,
change, change, parent compares two versions on one card.  Each shape is
one call of ``tdma.tdma_y_2d`` as the step calls it (with the rec and t
planes where the checkout builds them), on a rhs made on the card from a
seed, with the 2D pieces' μ and w; where the plan keeps d′ in shared
memory, the kernel's global-d′ instantiation is also launched at that
shape through its C entry, for the choice between them.  A call's device
ms come from CUDA events around ten calls queued behind a device-side
sleep.  Then ``bench.py:run_2d(2048)``'s step on the kernel path at each
spectral precision: ms a step over 20 steps after 20 warm-up steps (CUDA
events, no profiler), and over 5 more steps under ``torch.profiler`` the
device's busy ms a step (the sum of its kernels' and copies' times) and
the y-line solve's; the idle share is 1 − busy/ms, against the
unprofiled ms (the profiler stretches the span it runs in).
``--check`` also holds each call against ``tdma_y_2d_reference`` bit for
bit.  One JSON line a root, with the card's name and power limit and its
SM clock (``nvidia-smi``); ``--out`` appends them to a file.  It needs a
CUDA device and imports nothing of JAX; the process a root, the timer and
the command line are ``tools/ab.py``'s.
"""

from __future__ import annotations

import os
import sys
import time

import ab

# (ny, nx): the 2048² step's y-lines, the 1024×512 channel's, a ragged one
# (the 4-byte copies), and a column too tall for shared memory
SHAPES = ((2048, 2048), (512, 1024), (23, 37), (4096, 256))
N_STEP = 2048
STEPS = 20
PROFILED = 5


def run_root(root: str, check: bool, reps: int = 10) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from cfd_tpu_torch import FlowField, Grid
    from cfd_tpu_torch.ops.kernels import native, tdma
    from cfd_tpu_torch.solvers.ns.params import NSParams
    from cfd_tpu_torch.solvers.ns.projection import make_projection_step
    from cfd_tpu_torch.solvers.ns.rollout import run_steps
    from cfd_tpu_torch.solvers.poisson import spectral
    from cfd_tpu_torch.solvers.poisson.base import Method, PoissonProblem

    if not torch.cuda.is_available():
        raise SystemExit("tdma_ab: no CUDA device")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    native.library()
    build_s = time.perf_counter() - t0
    device_ms = ab.device_timer(reps, "tdma_ab")

    def global_d(r, w, planes):
        """The kernel's global-d′ instantiation (d′ parked in x) at a
        shape where the plan keeps d′ in shared memory."""
        x = torch.empty_like(r)
        vec = r.shape[1] % 4 == 0
        native.launch("cfd_tdma_y2d", r.device, native.ptr(r), float(w),
                      *map(native.ptr, planes), native.ptr(x), *r.shape,
                      0, int(vec))
        return x

    lines = {}
    for ny, nx in SHAPES:
        prob = PoissonProblem(nx, ny, 1, 1.0 / (nx - 1), 1.0 / (ny - 1))
        lx = spectral._dirichlet_eigenvalues(nx - 2, prob.inv_dx2)
        mu = torch.tensor(spectral._edge_padded(lx, nx).astype(np.float32),
                          device=dev)
        w = float(prob.inv_dy2)
        gen = torch.Generator(device=dev)
        gen.manual_seed(23)
        r = torch.randn(ny, nx, generator=gen, device=dev)
        r[0] = 0.0
        r[-1] = 0.0
        calls = {"step": lambda: tdma.tdma_y_2d(r, mu, w)}
        row = {}
        if hasattr(tdma, "tdma_y2d_planes"):
            planes = tdma.tdma_y2d_planes(mu, w, ny)
            calls["step"] = lambda: tdma.tdma_y_2d(r, mu, w, planes=planes)
            plan = tdma.tdma_y2d_plan(ny, nx)
            row["plan"] = plan
            if plan["variant"] == "smem":
                calls["global"] = lambda: global_d(r, w, planes)
        ref = tdma.tdma_y_2d_reference(r, mu, w) if check else None
        for key, fn in calls.items():
            row[f"{key}_ms"] = device_ms(fn)
            if check:
                got = fn()
                torch.cuda.synchronize()
                row[f"{key}_bit_equal"] = bool(torch.equal(got, ref))
        lines[f"{nx}x{ny}"] = row
        print(f"  {root} {nx}x{ny}: {row}", file=sys.stderr, flush=True)
        torch.cuda.empty_cache()

    shape = (1, N_STEP, N_STEP)
    params = NSParams(source_amplitude_u=0.0, source_amplitude_v=0.0,
                      mu=0.01)

    def tg():
        lin = torch.linspace(0.0, 1.0, N_STEP, dtype=torch.float32,
                             device=dev)
        uu = (torch.sin(2.0 * torch.pi * lin)[None, None, :]
              * torch.cos(2.0 * torch.pi * lin)[None, :, None])
        uu = uu.expand(shape).contiguous()
        return FlowField(u=uu, v=-uu, w=torch.zeros(shape, device=dev),
                         p=torch.ones(shape, device=dev),
                         rho=torch.ones(shape, device=dev),
                         T=torch.full(shape, 300.0, device=dev))

    steps = {}
    for prec in ("highest", "high", "default"):
        stepf = make_projection_step(Grid.uniform(N_STEP, N_STEP), params,
                                     torch.float32, Method.FFT_DIRECT,
                                     device=dev, spectral_precision=prec)
        f0 = tg()
        run_steps(stepf, f0, 1e-5, STEPS)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        _, res = run_steps(stepf, f0, 1e-5, STEPS)
        end.record()
        torch.cuda.synchronize()
        steps[prec] = {"ms": start.elapsed_time(end) / STEPS,
                       "status": int(res.status)}
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run_steps(stepf, f0, 1e-5, PROFILED)
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if e.device_type.name == "CUDA"]
        busy = sum(e.time_range.elapsed_us() for e in events) / 1e3
        lines_ms = sum(e.time_range.elapsed_us() for e in events
                       if "tdma" in e.name) / 1e3
        steps[prec].update(busy_ms=busy / PROFILED,
                           idle_share=1.0 - busy / PROFILED
                           / steps[prec]["ms"],
                           y_lines_ms=lines_ms / PROFILED)
        print(f"  {root} 2048^2 {prec}: {steps[prec]}", file=sys.stderr,
              flush=True)
    return {"root": root, "card": ab.smi("name,power.limit"),
            "clocks_sm": ab.smi("clocks.sm"),
            "device": torch.cuda.get_device_name(0), "build_s": build_s,
            "lines": lines, "step_2048": steps}


if __name__ == "__main__":
    sys.exit(ab.main(__doc__, os.path.abspath(__file__), run_root))
