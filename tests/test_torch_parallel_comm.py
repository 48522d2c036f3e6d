"""The shard communicator and the mesh helpers (`cfd_tpu_torch.parallel.
comm`, `.mesh`) against the reference's `jax.shard_map` collectives and
`cfd_tpu.parallel.mesh`, on the CPU.

* `LocalComm.halo` against the ring ``lax.ppermute`` pairs of the
  reference's ``hpad`` / ``hpad2`` (`cfd_tpu/parallel/fused.py:488-512`),
  `LocalComm.all_to_all` against ``lax.all_to_all(tiled=True)`` (the
  sharded z-solve's two transposes), inside ``shard_map`` on P = 2, 4, 8
  of the 8 virtual devices: exact.
* `LocalComm.max` keeps NaN, as ``torch.maximum``; `LocalComm.sum` adds
  in shard order and keeps NaN and the dtype; `LocalComm.fill_halo` writes
  ``halo``'s planes into persistent padded buffers.
* `factor_devices` and `field_spec` equal the reference's; the
  `shard_field` → `gather_field` round trip is exact; `make_mesh` without
  devices takes the CUDA devices and raises without one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import PartitionSpec as JP

from cfd_tpu.parallel.mesh import factor_devices as j_factor_devices
from cfd_tpu.parallel.mesh import field_spec as j_field_spec
from cfd_tpu.parallel.mesh import make_mesh as j_make_mesh
from cfd_tpu_torch import FlowField
from cfd_tpu_torch.parallel import (LocalComm, factor_devices, field_spec,
                                    gather_field, make_mesh, replicate,
                                    shard_field)

CPU = torch.device("cpu")
SHARDS = (2, 4, 8)


def _blocks(a, P):
    return list(torch.from_numpy(a).chunk(P, dim=0))


def _zmesh(P):
    return j_make_mesh(jax.devices()[:P], axes=("z",))


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("P", SHARDS)
def test_halo_matches_ring_ppermute(P, n):
    rng = np.random.default_rng(P + 10 * n)
    a = rng.normal(size=(4 * P, 3, 5))
    fwd = [(i, i + 1) for i in range(P - 1)]
    bwd = [(i + 1, i) for i in range(P - 1)]

    def pad(x):
        lo = lax.ppermute(x[-n:], "z", fwd)
        hi = lax.ppermute(x[:n], "z", bwd)
        return jnp.concatenate([lo, x, hi], axis=0)

    ref = np.asarray(jax.shard_map(pad, mesh=_zmesh(P), in_specs=JP("z"),
                                   out_specs=JP("z"))(jnp.asarray(a)))
    comm = LocalComm([CPU] * P)
    blocks = _blocks(a, P)
    got = torch.cat([torch.cat([lo, b, hi]) for b, (lo, hi) in
                     zip(blocks, comm.halo(blocks, n))]).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("axes", [(1, 0), (0, 1)], ids=["y-to-z", "z-to-y"])
@pytest.mark.parametrize("P", SHARDS)
def test_all_to_all_matches_tiled_all_to_all(P, axes):
    split, concat = axes
    rng = np.random.default_rng(P)
    a = rng.normal(size=(P * P, 3 * P, 5))

    def t(x):
        return lax.all_to_all(x, "z", split_axis=split, concat_axis=concat,
                              tiled=True)

    ref = np.asarray(jax.shard_map(t, mesh=_zmesh(P), in_specs=JP("z"),
                                   out_specs=JP("z"))(jnp.asarray(a)))
    comm = LocalComm([CPU] * P)
    got = torch.cat(comm.all_to_all(_blocks(a, P), split, concat)).numpy()
    np.testing.assert_array_equal(got, ref)


def test_max_keeps_nan_and_spans_the_shards():
    comm = LocalComm([CPU] * 3)
    vals = [torch.tensor([1.0, -2.0]), torch.tensor([0.5, 7.0]),
            torch.tensor([3.0, float("nan")])]
    out = comm.max(vals)
    assert len(out) == 3
    for o in out:
        assert o[0] == 3.0 and torch.isnan(o[1])


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("P", SHARDS)
def test_fill_halo_matches_halo_into_buffers(P, n):
    """``fill_halo`` writes the ``halo`` planes into persistent padded
    buffers; an edge shard's outer halo planes keep what they held."""
    rng = np.random.default_rng(P + 10 * n)
    a = rng.normal(size=(4 * P, 3, 5))
    comm = LocalComm([CPU] * P)
    blocks = _blocks(a, P)
    bufs = [torch.cat([torch.full_like(b[:n], 7.0), b,
                       torch.full_like(b[:n], 7.0)]) for b in blocks]
    comm.fill_halo(bufs, n)
    for s, (buf, b, (lo, hi)) in enumerate(zip(bufs, blocks,
                                               comm.halo(blocks, n))):
        assert torch.equal(buf[n:-n], b)
        assert torch.equal(buf[:n], torch.full_like(lo, 7.0) if s == 0
                           else lo)
        assert torch.equal(buf[-n:], torch.full_like(hi, 7.0)
                           if s == P - 1 else hi)


def test_sum_adds_in_shard_order_and_keeps_the_dtype():
    """``sum`` adds the shards' values in shard order (the reference's
    ``lax.psum`` of per-shard sums), keeps NaN and the values' dtype
    (the BiCGSTAB shares stay float64)."""
    comm = LocalComm([CPU] * 3)
    vals = [torch.tensor([1e16, 1.0], dtype=torch.float64),
            torch.tensor([1.0, 2.0], dtype=torch.float64),
            torch.tensor([-1e16, float("nan")], dtype=torch.float64)]
    out = comm.sum(vals)
    assert len(out) == 3
    for o in out:
        assert o.dtype == torch.float64
        assert o[0] == (1e16 + 1.0) + -1e16 and torch.isnan(o[1])


@pytest.mark.parametrize("n", range(1, 17))
def test_factor_devices_matches_reference(n):
    assert factor_devices(n) == j_factor_devices(n)


def _jspec(spec):
    return tuple(spec) + (None,) * (3 - len(tuple(spec)))


@pytest.mark.parametrize("n,axes,shape", [
    (4, ("z",), (16, 8, 6)), (8, ("z",), (12, 8, 6)),
    (4, ("z", "y"), (16, 8, 6)), (8, ("z", "y"), (16, 9, 6)),
    (2, ("y",), (1, 8, 6)), (4, ("z",), (1, 8, 6)),
    (4, ("z",), (1, 6, 6))])
def test_field_spec_matches_reference(n, axes, shape):
    mesh = make_mesh([CPU] * n, axes=axes)
    jmesh = j_make_mesh(jax.devices()[:n], axes=axes)
    is_3d = shape[0] > 1
    assert mesh.shape == dict(jmesh.shape)
    assert field_spec(mesh, is_3d, shape) == _jspec(
        j_field_spec(jmesh, is_3d, shape))
    assert field_spec(mesh, is_3d) == _jspec(j_field_spec(jmesh, is_3d))


@pytest.mark.parametrize("n,axes,shape", [
    (4, ("z",), (16, 8, 6)), (4, ("z", "y"), (8, 10, 6)),
    (2, ("y",), (1, 8, 6)), (4, ("z",), (6, 8, 6))])
def test_shard_gather_round_trip(n, axes, shape):
    rng = np.random.default_rng(3)
    f = FlowField(*(torch.from_numpy(rng.normal(size=shape))
                    for _ in range(6)))
    mesh = make_mesh([CPU] * n, axes=axes)
    sf = shard_field(f, mesh)
    assert len(sf.blocks) == n and sf.shape == shape
    back = gather_field(sf)
    for name in ("u", "v", "w", "p", "rho", "T"):
        assert torch.equal(getattr(back, name), getattr(f, name))
    assert all(torch.equal(r, f.u) for r in replicate(f.u, mesh))


def test_make_mesh_defaults_to_the_cuda_devices():
    """Like every entry point of the port: the card, or a raise."""
    if torch.cuda.is_available():
        mesh = make_mesh(axes=("z",))
        assert all(d.type == "cuda" for d in mesh.devices.flat)
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            make_mesh(axes=("z",))
