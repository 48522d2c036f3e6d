"""The collectives of the decomposed explicit steps over four gloo
processes (`ProcessGroupComm` on a (2, 2) mesh, spawned as in
`test_torch_parallel_comm_zy.py`, a 60 s deadline) against `LocalComm`,
bit for bit, on the CPU:

* the periodic ring — ``fill_halo(·, 2, axis, wrap=True)`` along y and
  z, on stacks of fields (n, nz, ny, nx); on an axis of two shards both
  neighbours are one rank, so the two messages between a pair pair up
  in order;
* ``edge_swap`` along y and z (the last shard's ``to_first`` to the
  first, the first's ``to_last`` to the last; None elsewhere);
* one (2, 2) RK2 step, float64 plain versions (no sums, so exact), and
  one Euler step.

This module imports no JAX: the workers import it.
"""

import sys
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from cfd_tpu_torch.parallel import ProcessGroupComm, make_mesh

CPU = torch.device("cpu")
WORLD, SHAPE = 4, (2, 2)
NZL, NYL, NX = 3, 4, 5
STEP_SHAPE = (12, 8, 11)          # (nz, ny, nx): 6 planes, 4 rows a shard
DEADLINE_S = 60.0


def _blocks(shards):
    """Each shard's (2, NZL, NYL, NX) stack of two fields."""
    rng = np.random.default_rng(5)
    a = rng.normal(size=(2, SHAPE[0] * NZL, SHAPE[1] * NYL, NX))
    out = []
    for s in shards:
        zi, yi = divmod(s, SHAPE[1])
        out.append(torch.from_numpy(np.ascontiguousarray(
            a[:, zi * NZL:(zi + 1) * NZL, yi * NYL:(yi + 1) * NYL])))
    return out


def _collectives(comm, shards):
    blocks = _blocks(shards)
    out = {}
    for axis, dim in (("y", -2), ("z", -3)):
        bufs = [torch.nn.functional.pad(
            b, (0, 0, 2, 2) if axis == "y" else (0, 0, 0, 0, 2, 2),
            value=7.0) for b in blocks]
        comm.fill_halo(bufs, 2, axis, wrap=True)
        out[f"fill_{axis}"] = bufs
        first_last = [comm.edges(s, axis) for s in shards]
        n = blocks[0].shape[dim]
        got = comm.edge_swap(
            [b.narrow(dim, n - 2, 1) + 100.0 if s == fl[1] else None
             for b, s, fl in zip(blocks, shards, first_last)],
            [b.narrow(dim, 1, 1) + 200.0 if s == fl[0] else None
             for b, s, fl in zip(blocks, shards, first_last)], axis)
        out[f"swap_{axis}"] = [
            torch.cat([x.reshape(-1) for x in pair if x is not None])
            for pair in got]
    return out


def _steps(mesh):
    """One plain float64 RK2 step and one Euler step from a seeded field:
    {method: gathered fields}."""
    from cfd_tpu_torch import FlowField, Grid
    from cfd_tpu_torch.parallel import make_sharded_step
    from cfd_tpu_torch.solvers.ns.params import NSParams

    nz, ny, nx = STEP_SHAPE
    grid = Grid.uniform(nx, ny, nz, zmin=0.0, zmax=1.0)
    rng = np.random.default_rng(12)
    f = FlowField.initialize(grid, dtype=torch.float64, device="cpu")
    f = f.replace(**{n: torch.from_numpy(rng.normal(0.0, 0.1, STEP_SHAPE))
                     for n in "uvwp"})
    out = {}
    for method in ("rk2", "explicit_euler"):
        step, place = make_sharded_step(grid, NSParams(), mesh, method,
                                        dtype=torch.float64)
        fs, res = step(place(f), 1e-3, 0)
        g = fs.gather()
        out[method] = {n: getattr(g, n) for n in
                       ("u", "v", "w", "p", "rho", "T")}
        out[method]["status"] = int(res.status)
        out[method]["max_velocity"] = float(res.max_velocity)
    return out


def _worker(rank, init_file, out_prefix):
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=WORLD, rank=rank)
    try:
        comm = ProcessGroupComm()
        mesh = make_mesh([CPU] * WORLD, shape=SHAPE, comm=comm)
        torch.save({"coll": _collectives(comm, comm.shards),
                    "steps": _steps(mesh), "jax": "jax" in sys.modules},
                   f"{out_prefix}{rank}.pt")
    finally:
        dist.destroy_process_group()


def test_gloo_ranks_explicit_collectives_equal_local_comm(tmp_path):
    ctx = mp.spawn(_worker, args=(str(tmp_path / "init"),
                                  str(tmp_path / "rank")),
                   nprocs=WORLD, join=False)
    deadline = time.monotonic() + DEADLINE_S
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                p.terminate()
            pytest.fail(f"gloo workers still running after {DEADLINE_S} s")
    mesh = make_mesh([CPU] * WORLD, shape=SHAPE)
    ref = _collectives(mesh.comm, mesh.comm.shards)
    ref_steps = _steps(mesh)
    for rank in range(WORLD):
        out = torch.load(tmp_path / f"rank{rank}.pt")
        assert not out["jax"], "a worker imported JAX"
        for key, vals in out["coll"].items():
            (got,) = vals
            assert torch.equal(got, ref[key][rank]), (rank, key)
        for method, fields in out["steps"].items():
            want = ref_steps[method]
            assert fields["status"] == want["status"] == 0
            assert fields["max_velocity"] == want["max_velocity"]
            for n in ("u", "v", "w", "p", "rho", "T"):
                assert torch.equal(fields[n], want[n]), (rank, method, n)
