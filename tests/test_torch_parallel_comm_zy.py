"""The communicators' collectives along one axis of a (Pz, Py) mesh
(`cfd_tpu_torch.parallel.comm`), against a numpy model, on the CPU.

* ``halo(·, n, "y")`` then ``halo(·, n, "z")`` on the y-padded blocks
  gives every shard its block of the whole field zero-padded by n planes
  and n rows — the corners included, from the diagonal shard in two hops
  (the reference's ``hpad(ypad(·))``, `cfd_tpu/parallel/fused.py:759-786`);
* ``fill_halo`` along y, then z, writes the same into persistent buffers
  and leaves the outer halo of an edge shard as it was;
* ``all_to_all(·, split, concat, axis)`` runs within the shards that share
  the other coordinate: the shard at position j of its group receives
  the j-th chunk of every member's block, in group order;
* over (2, 4), (4, 2), (2, 2) and (1, 2) on `LocalComm`, exactly; and
  `ProcessGroupComm` over four gloo processes on a (2, 2) mesh (spawned
  as in `test_torch_parallel_dist.py`, a 60 s deadline): the same
  collectives and the plain float64 (z, y) FFT_DIRECT step equal
  `LocalComm`'s bit for bit, the CG step within 1e-12 (gloo adds the
  four dot shares in its own order).  This module imports no JAX: the
  workers import it.
"""

import sys
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from cfd_tpu_torch.parallel import LocalComm, ProcessGroupComm, make_mesh

CPU = torch.device("cpu")
MESHES = [(2, 4), (4, 2), (2, 2), (1, 2)]
NZL, NYL, NX = 3, 4, 5
DEADLINE_S = 60.0


def _global(pz, py, seed=0):
    rng = np.random.default_rng(seed + 10 * pz + py)
    return rng.normal(size=(pz * NZL, py * NYL, NX))


def _blocks(a, pz, py):
    """The owned blocks in shard (C) order."""
    return [torch.from_numpy(np.ascontiguousarray(
        a[zi * NZL:(zi + 1) * NZL, yi * NYL:(yi + 1) * NYL]))
        for zi in range(pz) for yi in range(py)]


def _padded_model(a, pz, py, n, fill=0.0):
    """Each shard's block of ``a`` padded n planes and n rows a side with
    ``fill`` past the global ends."""
    ap = np.pad(a, ((n, n), (n, n), (0, 0)), constant_values=fill)
    return [ap[zi * NZL:zi * NZL + NZL + 2 * n,
               yi * NYL:yi * NYL + NYL + 2 * n]
            for zi in range(pz) for yi in range(py)]


def _pad(comm, blocks, n):
    ys = [torch.cat([lo, b, hi], 1) for b, (lo, hi) in
          zip(blocks, comm.halo(blocks, n, "y"))]
    return [torch.cat([lo, b, hi]) for b, (lo, hi) in
            zip(ys, comm.halo(ys, n, "z"))]


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_halo_y_then_z_pads_with_corners(shape, n):
    pz, py = shape
    a = _global(pz, py)
    comm = make_mesh([CPU] * (pz * py), shape=shape).comm
    for got, ref in zip(_pad(comm, _blocks(a, pz, py), n),
                        _padded_model(a, pz, py, n)):
        np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_fill_halo_y_then_z_into_buffers(shape):
    pz, py = shape
    a = _global(pz, py, seed=1)
    comm = make_mesh([CPU] * (pz * py), shape=shape).comm
    bufs = []
    for b in _blocks(a, pz, py):
        buf = torch.full((NZL + 2, NYL + 2, NX), 7.0, dtype=b.dtype)
        buf[1:-1, 1:-1] = b
        bufs.append(buf)
    comm.fill_halo(bufs, 1, "y")
    comm.fill_halo(bufs, 1, "z")
    for got, ref in zip(bufs, _padded_model(a, pz, py, 1, fill=7.0)):
        np.testing.assert_array_equal(got.numpy(), ref)


def _a2a_model(blocks, pz, py, split, concat, axis):
    out = []
    for s in range(pz * py):
        zi, yi = divmod(s, py)
        group = ([z * py + yi for z in range(pz)] if axis == "z"
                 else [zi * py + y for y in range(py)])
        j = group.index(s)
        out.append(np.concatenate(
            [np.array_split(blocks[g].numpy(), len(group), axis=split)[j]
             for g in group], axis=concat))
    return out


@pytest.mark.parametrize("axis,split,concat",
                         [("z", 2, 0), ("z", 0, 2), ("y", 0, 1),
                          ("y", 1, 0)])
@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_all_to_all_within_each_axis_group(shape, axis, split, concat):
    pz, py = shape
    rng = np.random.default_rng(pz + 7 * py)
    dims = [pz * py * 2, pz * py * 2, pz * py * 2]
    blocks = [torch.from_numpy(rng.normal(size=dims))
              for _ in range(pz * py)]
    comm = make_mesh([CPU] * (pz * py), shape=shape).comm
    got = comm.all_to_all(blocks, split, concat, axis)
    for g, r in zip(got, _a2a_model(blocks, pz, py, split, concat, axis)):
        np.testing.assert_array_equal(g.numpy(), r)


def test_mesh_lays_out_the_grid_and_coords():
    mesh = make_mesh([CPU] * 8, axes=("z", "y"))
    assert mesh.comm.shape == (2, 4)
    assert [mesh.comm.coords(s) for s in (0, 3, 4, 7)] == [
        (0, 0), (0, 3), (1, 0), (1, 3)]
    assert make_mesh([CPU] * 4, shape=(1, 4)).comm.shape == (1, 4)
    assert make_mesh([CPU] * 4, axes=("z",)).comm.shape == (4, 1)
    with pytest.raises(ValueError, match="grid of shards"):
        LocalComm([CPU] * 8).set_shape((3, 3))


def test_a_communicator_serves_one_grid():
    comm = LocalComm([CPU] * 4)
    assert comm.shape == (4, 1)           # one z ring until a grid is set
    make_mesh([CPU] * 4, shape=(2, 2), comm=comm)
    make_mesh([CPU] * 4, shape=(2, 2), comm=comm)   # the same grid: fine
    assert comm.shape == (2, 2)
    for kw in ({"shape": (1, 4)}, {"axes": ("z",)}):
        with pytest.raises(ValueError, match="laid out as"):
            make_mesh([CPU] * 4, comm=comm, **kw)
    assert comm.shape == (2, 2)


def test_process_group_grid_with_sub_groups_needs_the_world():
    """Row and column groups come from ``dist.new_group``, which every
    rank of the world enters: a communicator over part of the world
    refuses a grid that needs them (checked before any group is made)."""
    class World:
        @staticmethod
        def get_world_size():
            return 8

        @staticmethod
        def new_group(ranks):
            raise AssertionError("no group may be made")

    comm = ProcessGroupComm.__new__(ProcessGroupComm)
    comm._dist, comm.group, comm.rank, comm.size = World, object(), 0, 4
    with pytest.raises(ValueError, match="span the world"):
        comm.set_shape((2, 2))
    assert comm.shape == (4, 1)           # left unshaped


# ---- ProcessGroupComm over four gloo processes -------------------------------

WORLD, PG_SHAPE = 4, (2, 2)
STEP_SHAPE = (8, 16, 24)          # (nz, ny, nx)


def _collectives(comm, shards):
    """Every collective of the (z, y) steps on this process's shards."""
    pz, py = comm.shape
    a = _global(pz, py, seed=3)
    blocks = [_blocks(a, pz, py)[s] for s in shards]
    out = {"pad2": _pad(comm, blocks, 2)}
    bufs = []
    for b in blocks:
        buf = torch.full((NZL + 2, NYL + 2, NX), 7.0, dtype=b.dtype)
        buf[1:-1, 1:-1] = b
        bufs.append(buf)
    comm.fill_halo(bufs, 1, "y")
    comm.fill_halo(bufs, 1, "z")
    out["fill"] = bufs
    cube = [torch.arange(64, dtype=torch.float64).reshape(4, 4, 4) + 100 * s
            for s in shards]
    for axis, split, concat in (("z", 2, 0), ("y", 0, 1)):
        out[f"a2a_{axis}"] = comm.all_to_all(cube, split, concat, axis)
    return out


def _steps(mesh):
    """Two plain float64 steps of the (z, y) FFT_DIRECT and CG steps from
    one seeded field: {method: (gathered u, v, w, p)}.  One intra-op
    thread (the CPU GEMMs' last bits follow the thread count)."""
    from cfd_tpu_torch import FlowField, Grid
    from cfd_tpu_torch.parallel import gather_field, make_sharded_step
    from cfd_tpu_torch.solvers.ns.params import NSParams
    from cfd_tpu_torch.solvers.poisson.base import Method

    nz, ny, nx = STEP_SHAPE
    grid = Grid.uniform(nx, ny, nz, zmin=0.0, zmax=1.0)
    rng = np.random.default_rng(11)
    f = FlowField.initialize(grid, dtype=torch.float64, device="cpu")
    f = f.replace(**{n: torch.from_numpy(rng.normal(0.0, 0.1, STEP_SHAPE))
                     for n in "uvwp"})
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    out = {}
    try:
        for method in ("FFT_DIRECT", "CG"):
            step, place = make_sharded_step(grid, NSParams(), mesh,
                                            dtype=torch.float64,
                                            poisson_method=Method[method])
            fs = place(f)
            for it in range(2):
                fs, res = step(fs, 1e-3, it)
            g = gather_field(fs)
            out[method] = {n: getattr(g, n) for n in "uvwp"}
            out[method]["status"] = int(res.status)
    finally:
        torch.set_num_threads(threads)
    return out


def _worker(rank, init_file, out_prefix):
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=WORLD, rank=rank)
    try:
        comm = ProcessGroupComm()
        mesh = make_mesh([CPU] * WORLD, axes=("z", "y"), comm=comm)
        try:  # raises before any collective, on every rank
            make_mesh([CPU] * WORLD, shape=(1, WORLD), comm=comm)
            reshaped = True
        except ValueError:
            reshaped = False
        torch.save({"coll": _collectives(comm, comm.shards),
                    "reshaped": reshaped,
                    "steps": _steps(mesh), "shape": comm.shape,
                    "jax": "jax" in sys.modules},
                   f"{out_prefix}{rank}.pt")
    finally:
        dist.destroy_process_group()


def test_gloo_ranks_on_a_zy_mesh_equal_local_comm(tmp_path):
    ctx = mp.spawn(_worker, args=(str(tmp_path / "init"),
                                  str(tmp_path / "rank")),
                   nprocs=WORLD, join=False)
    deadline = time.monotonic() + DEADLINE_S
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                p.terminate()
            pytest.fail(f"gloo workers still running after {DEADLINE_S} s")
    mesh = make_mesh([CPU] * WORLD, axes=("z", "y"))
    assert mesh.comm.shape == PG_SHAPE
    ref = _collectives(mesh.comm, mesh.comm.shards)
    ref_steps = _steps(mesh)
    for rank in range(WORLD):
        out = torch.load(tmp_path / f"rank{rank}.pt")
        assert not out["jax"], "a worker imported JAX"
        assert out["shape"] == PG_SHAPE
        assert not out["reshaped"], "a second grid over one communicator"
        for key, vals in out["coll"].items():
            (got,) = vals
            assert torch.equal(got, ref[key][rank]), (rank, key)
        for method, fields in out["steps"].items():
            assert fields["status"] == ref_steps[method]["status"] == 0
            for n in "uvwp":
                got, want = fields[n], ref_steps[method][n]
                if method == "FFT_DIRECT":
                    assert torch.equal(got, want), (rank, method, n)
                else:
                    # gloo adds the four ranks' dot shares in its own
                    # order, LocalComm in shard order: the CG iterates
                    # part in the last bits
                    np.testing.assert_allclose(
                        got.numpy(), want.numpy(), rtol=0, atol=1e-12,
                        err_msg=f"rank {rank} {method} {n}")
