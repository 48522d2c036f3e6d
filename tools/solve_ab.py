"""Time the whole-solve CG and BiCGSTAB kernels, and the 128² Ghia cavity
steps around them, of one or more checkouts of this repository on the
card, in turns.

    python3 tools/solve_ab.py --root OLD --root . --root . --root OLD \\
        [--check] [--out FILE]

Each ``--root`` is a checkout (a parent commit unpacked with ``git
archive`` into a directory that ``.gitignore`` lists will do), run in a
process of its own that imports that checkout's ``cfd_tpu_torch`` and
builds its kernels there; the roots run in the order given, so parent,
change, change, parent compares two versions on one card.  Each solve is
one call of ``vmem_small.cg_solve`` / ``bicgstab_solve`` on a 2D plane, in
the form the checkout gives it (``krylov_cluster_plan`` where it has one),
on a right-hand side made from a seed: CG on a normal rhs from the card's
generator at tolerance 1e-5 (``chip_smoke.py`` phase 12's input), BiCGSTAB
on ``bench.py:run_poisson_iters``' rhs (numpy's normal draws from seed 0,
mean removed) for 150 iterations at tolerance 0 (phase 23's input).  A
call's device ms come from CUDA events around five calls queued behind a
device-side sleep.  Then the lid-driven cavity at 128², Re = 100, dt 5e-4
(``chip_smoke.py``'s ``ghia_gate`` loop) with the CG and the BiCGSTAB
pressure solves: host wall ms a step over 400 steps after 100 warm-up
steps, and over 40 more steps under ``torch.profiler`` the device's busy
ms a step (its kernels' and copies' times) and the solve's; the idle share
is 1 − busy/ms, against the unprofiled ms.  ``--check`` also holds each
cluster-form call bit for bit against its order model
(``cg_solve_cluster_ordered`` / ``bicgstab_solve_cluster_ordered``) where
the checkout has one.  One JSON line a root, with the card's name and
power limit (``nvidia-smi``); ``--out`` appends them to a file.  It needs
a CUDA device and imports nothing of JAX; the process a root, the timer
and the command line are ``tools/ab.py``'s.
"""

from __future__ import annotations

import os
import sys
import time

import ab

# (kind, (nz, ny, nx)): the solves of PERF.md's rows K3 and B2
SOLVES = (("cg", (1, 100, 100)), ("cg", (1, 128, 128)),
          ("cg", (1, 512, 512)), ("bicgstab", (1, 100, 100)),
          ("bicgstab", (1, 128, 128)))
BICG_ITERS = 150
N_CAVITY = 128
WARM, STEPS, PROFILED = 100, 400, 40


def run_root(root: str, check: bool, reps: int = 5) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from cfd_tpu_torch import FlowField, Grid
    from cfd_tpu_torch.boundary import (DirichletValues,
                                        apply_dirichlet_scalar,
                                        apply_neumann_scalar)
    from cfd_tpu_torch.ops.kernels import native, vmem_small
    from cfd_tpu_torch.ops.kernels.bicgstab_kernels import BiCGConsts
    from cfd_tpu_torch.ops.kernels.cg_kernels import CGConsts
    from cfd_tpu_torch.solvers.ns.params import NSParams
    from cfd_tpu_torch.solvers.ns.projection import make_projection_step
    from cfd_tpu_torch.solvers.poisson.base import Method

    if not torch.cuda.is_available():
        raise SystemExit("solve_ab: no CUDA device")
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    native.library()
    build_s = time.perf_counter() - t0
    device_ms = ab.device_timer(reps, "solve_ab")
    has_plan = hasattr(vmem_small, "krylov_cluster_plan")

    solves = {}
    for kind, shape in SOLVES:
        nz, ny, nx = shape
        coef = ((nx - 1) ** 2, (ny - 1) ** 2, 0.0)
        if kind == "cg":
            gen = torch.Generator(device=dev).manual_seed(0)
            rhs = torch.randn(shape, generator=gen, device=dev)
            args = (CGConsts(*shape, *coef), 1e-5, 0.0, 2000)
            wrap = vmem_small.cg_solve
        else:
            rng = np.random.default_rng(0)
            rhs = torch.tensor(rng.normal(0.0, 1.0, shape),
                               dtype=torch.float32, device=dev)
            rhs = rhs - rhs.mean()
            args = (BiCGConsts(*shape, *coef, BICG_ITERS), 0.0, 0.0,
                    BICG_ITERS)
            wrap = vmem_small.bicgstab_solve
        x0 = torch.zeros_like(rhs)

        def call():
            return wrap(x0, rhs, *args)

        got = call()
        n_it = int(got[3])
        row = {"iterations": n_it, "ms": device_ms(call)}
        row["us_per_iteration"] = row["ms"] / max(n_it, 1) * 1e3
        plan = vmem_small.krylov_cluster_plan(*shape, kind) if has_plan \
            else {"form": "grid"}
        row["form"] = plan["form"]
        if plan["form"] == "cluster":
            row["plan"] = {k: plan[k] for k in ("cluster", "threads",
                                                "rows", "resident")}
            if check:
                model = getattr(vmem_small, f"{kind}_solve_cluster_ordered")
                ref = model(x0, rhs, *args)
                torch.cuda.synchronize()
                row["bit_equal_to_model"] = all(
                    bool(torch.equal(a, b)) for a, b in zip(got, ref))
        solves[f"{kind} {nx}x{ny}"] = row
        print(f"  {root} {kind} {nx}x{ny}: {row}", file=sys.stderr,
              flush=True)
        torch.cuda.empty_cache()

    cavity = {}
    for method in (Method.CG, Method.BICGSTAB):
        n = N_CAVITY
        stepc = make_projection_step(
            Grid.uniform(n, n), NSParams(source_amplitude_u=0.0,
                                         source_amplitude_v=0.0,
                                         mu=1.0 / 100),
            torch.float32, method, device=dev)
        lid, wall = DirichletValues(top=1.0), DirichletValues()
        state = {"f": FlowField.quiescent(n, n, pressure=0.0,
                                          dtype=torch.float32, device=dev),
                 "i": 0, "worst": 0}

        def steps(k):
            for _ in range(k):
                f = state["f"]
                f = f.replace(u=apply_dirichlet_scalar(f.u, lid),
                              v=apply_dirichlet_scalar(f.v, wall),
                              p=apply_neumann_scalar(f.p))
                state["f"], res = stepc(f, 5e-4, state["i"])
                state["i"] += 1
            state["worst"] = max(state["worst"], abs(int(res.status)))

        steps(WARM)
        torch.cuda.synchronize()
        t = time.perf_counter()
        steps(STEPS)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3 / STEPS
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            steps(PROFILED)
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type.name == "CUDA"]
        busy = sum(e.time_range.elapsed_us() for e in events) / 1e3
        solve = sum(e.time_range.elapsed_us() for e in events
                    if "solve" in e.name) / 1e3
        row = {"ms": ms, "busy_ms": busy / PROFILED,
               "solve_ms": solve / PROFILED,
               "idle_share": 1.0 - busy / PROFILED / ms,
               "worst_status": state["worst"]}
        cavity[method.name] = row
        print(f"  {root} cavity {n}^2 {method.name}: {row}",
              file=sys.stderr, flush=True)
    return {"root": root, "card": ab.smi("name,power.limit"),
            "clocks_sm": ab.smi("clocks.sm"),
            "device": torch.cuda.get_device_name(0), "build_s": build_s,
            "solves": solves, "cavity_128": cavity}


if __name__ == "__main__":
    sys.exit(ab.main(__doc__, os.path.abspath(__file__), run_root))
