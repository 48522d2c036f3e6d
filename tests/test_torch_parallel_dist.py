"""The sharded step across processes: `ProcessGroupComm` over a gloo group
of two CPU processes (``torch.multiprocessing.spawn``, ``file://`` init)
runs the plain z-decomposed step at 128×16×8 in float64 — the spectral
step, and the CG step, whose solve takes its dots through
``ProcessGroupComm.sum`` and its halo planes through ``fill_halo`` — and
the field both ranks gather equals the one-process `LocalComm` run bit
for bit, its diagnostics too.  The workers check that nothing imported JAX (this
module imports none), and that the group's max keeps a NaN one rank
holds (gloo's max alone drops it).  The spawn joins with a 60 s deadline
and is terminated past it, so it cannot hang the run.
"""

import sys
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

CPU = torch.device("cpu")
WORLD = 2
SHAPE = (8, 16, 128)       # (nz, ny, nx)
STEPS = 3
DEADLINE_S = 60.0


def _run(mesh, method=None):
    """3 plain float64 steps of the sharded step on ``mesh`` (the spectral
    one, or the ``method`` pressure solve's); (gathered field, last
    StepResult).  One intra-op thread in every process: the CPU GEMMs'
    blocking, and so their last bits, follow the thread count."""
    from cfd_tpu_torch import FlowField, Grid
    from cfd_tpu_torch.parallel import gather_field, make_sharded_step
    from cfd_tpu_torch.solvers.ns.params import NSParams
    from cfd_tpu_torch.solvers.poisson.base import Method

    nz, ny, nx = SHAPE
    grid = Grid.uniform(nx, ny, nz, zmin=0.0, zmax=1.0)
    rng = np.random.default_rng(7)
    f = FlowField.initialize(grid, dtype=torch.float64, device="cpu")
    f = f.replace(**{n: torch.from_numpy(rng.normal(0.0, 0.1, SHAPE))
                     for n in "uvwp"})
    step, place = make_sharded_step(
        grid, NSParams(), mesh, dtype=torch.float64,
        poisson_method=None if method is None else Method[method])
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        fs = place(f)
        for it in range(STEPS):
            fs, res = step(fs, 1e-3, it)
        return gather_field(fs), res
    finally:
        torch.set_num_threads(threads)


def _worker(rank, init_file, out_prefix, method=None):
    import torch.distributed as dist

    from cfd_tpu_torch.parallel import ProcessGroupComm, make_mesh

    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=WORLD, rank=rank)
    try:
        comm = ProcessGroupComm()
        nan_max = comm.max([torch.tensor(
            [float(rank), float("nan") if rank == 1 else 0.0])])[0]
        g, res = _run(make_mesh([CPU] * WORLD, axes=("z",), comm=comm),
                      method)
        torch.save({"field": {n: getattr(g, n) for n in "uvwp"},
                    "diag": torch.stack([res.max_velocity,
                                         res.max_pressure]),
                    "status": int(res.status), "nan_max": nan_max,
                    "jax": "jax" in sys.modules},
                   f"{out_prefix}{rank}.pt")
    finally:
        dist.destroy_process_group()


def _spawn_and_compare(tmp_path, method=None):
    from cfd_tpu_torch.parallel import make_mesh

    ctx = mp.spawn(_worker, args=(str(tmp_path / "init"),
                                  str(tmp_path / "rank"), method),
                   nprocs=WORLD, join=False)
    deadline = time.monotonic() + DEADLINE_S
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                p.terminate()
            pytest.fail(f"gloo workers still running after {DEADLINE_S} s")
    ref, res = _run(make_mesh([CPU] * WORLD, axes=("z",)), method)
    for rank in range(WORLD):
        out = torch.load(tmp_path / f"rank{rank}.pt")
        assert not out["jax"], "a worker imported JAX"
        assert out["status"] == int(res.status) == 0
        assert out["nan_max"][0] == 1.0 and torch.isnan(out["nan_max"][1])
        for n in "uvwp":
            assert torch.equal(out["field"][n], getattr(ref, n)), n
        assert torch.equal(out["diag"], torch.stack([res.max_velocity,
                                                     res.max_pressure]))


def test_gloo_ranks_equal_local_comm(tmp_path):
    _spawn_and_compare(tmp_path)


def test_gloo_ranks_cg_step_equal_local_comm(tmp_path):
    """The CG step: its dots summed by ``all_reduce(SUM)`` and its halo
    planes sent into the ranks' buffers equal ``LocalComm``'s."""
    _spawn_and_compare(tmp_path, "CG")
