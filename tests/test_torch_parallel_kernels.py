"""The ``global_nz`` mode of the predictor and b̃ kernels' plain versions
and the call-time-μ Thomas solve (the sharded step's kernels, queue-B rows
A1 / A5 ``btilde_k`` in ``global_nz`` mode and A4 ``make_tdma_z(mu=None)``),
on the CPU.

* On the first, a middle and the last shard's halo-padded block, each
  equals the single-device plain function's slab bit for bit in float64:
  the predictor on its 2-halo block (``z_base = z_off − 2``) at the owned
  planes and the ±1 planes b̃ reads, b̃ on its 1-halo block
  (``z_base = z_off − 1``), the Thomas solve on a shard's y-pencil with
  its rows of μ.
* Against the reference's ``ProjectionKernels(..., global_nz=nz,
  dst_mats=…).predictor_poisson_input(z_offset=)`` (interpret mode,
  float32, 128×32×16 over P = 4): u*, v*, w* at the mega-kernel bar atol
  2e-5 (`tests/math/test_mega_kernels.py:58-65`), the xy-transformed b̂
  at 2e-5 of its max (a transform-space sum of ~nx·ny terms, as the
  GEMMs are held on the card).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_tpu.ops.pallas.projection_kernels import \
    ProjectionKernels as JKernels
from cfd_tpu.solvers.poisson.base import PoissonProblem as JProblem
from cfd_tpu.solvers.poisson.spectral import _dst_fused_mats as j_mats
from cfd_tpu_torch.ops.kernels import projection_kernels as pkm
from cfd_tpu_torch.ops.kernels import rolling, tdma
from cfd_tpu_torch.solvers.ns.params import NSParams
from cfd_tpu_torch.solvers.poisson.base import PoissonProblem
from cfd_tpu_torch.solvers.poisson.spectral import _dst_fused_mats

NZ, NY, NX, P = 16, 12, 20, 4
NZL = NZ // P
SHARDS = (0, 1, P - 1)          # the first, a middle and the last


def _consts(nz, ny=NY, nx=NX, dtype=torch.float64):
    h = (1.0 / (nx - 1), 1.0 / (ny - 1), 1.0 / (NZ - 1))
    return pkm.stencil_consts(nz, ny, nx, *h, 0.0, 0.0, NSParams().mu, True,
                              None, dtype)


def _fields(seed, shape=(NZ, NY, NX), dtype=torch.float64):
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.normal(0.0, 0.1, shape), dtype=dtype)
            for _ in range(4)]


def _pad(x, n):
    z = torch.zeros_like(x[:n])
    return torch.cat([z, x, z])


SCAL = torch.tensor([1e-3, 0.1, 0.05], dtype=torch.float64)


@pytest.mark.parametrize("shard", SHARDS)
def test_global_nz_predictor_is_the_single_device_slab(shard):
    u, v, w, _ = _fields(1)
    full = pkm.predictor_star_plain(u, v, w, SCAL, _consts(NZ))
    z_off = shard * NZL
    blk = [_pad(f, 2)[z_off:z_off + NZL + 4] for f in (u, v, w)]
    got = pkm.predictor_star_plain(*blk, SCAL, _consts(NZL + 4), None,
                                   z_off - 2, NZ)
    # valid: the owned planes and the in-domain planes ±1 of them
    lo, hi = max(z_off - 1, 0), min(z_off + NZL + 1, NZ)
    for g, f in zip(got, full):
        assert torch.equal(g[lo - z_off + 2:hi - z_off + 2], f[lo:hi])
    # the halo planes past the global shells pass through (zeros)
    if shard == 0:
        assert all(torch.equal(g[:2], torch.zeros_like(g[:2])) for g in got)


@pytest.mark.parametrize("shard", SHARDS)
def test_global_nz_btilde_is_the_single_device_slab(shard):
    us, vs, ws, p = _fields(2)
    rod = torch.tensor(1e3, dtype=torch.float64)
    full = pkm.poisson_input_plain(us, vs, ws, p, rod, _consts(NZ))
    z_off = shard * NZL
    blk = [_pad(f, 1)[z_off:z_off + NZL + 2] for f in (us, vs, ws, p)]
    got = pkm.poisson_input_plain(*blk, rod, _consts(NZL + 2), z_off - 1,
                                  NZ)
    assert torch.equal(got[1:-1], full[z_off:z_off + NZL])


@pytest.mark.parametrize("shard", SHARDS)
def test_call_time_mu_thomas_is_the_single_device_pencil(shard):
    problem = PoissonProblem(NX, NY, NZ, 1.0 / (NX - 1), 1.0 / (NY - 1),
                             1.0 / (NZ - 1))
    _, mu, w = _dst_fused_mats(problem, np.float64)
    mu_t = torch.as_tensor(mu)
    r = _fields(3)[0]
    r[0] = r[-1] = 0.0
    full = tdma.tdma_z_reference(r, mu_t, w)
    nyl = NY // P
    rows = slice(shard * nyl, (shard + 1) * nyl)
    run = tdma.make_tdma_z(NZ, nyl, NX, None, w)
    got = run(r[:, rows].contiguous(), mu_t[rows].contiguous())
    assert torch.equal(got, full[:, rows])
    with pytest.raises(ValueError, match="stored"):
        tdma.make_tdma_z(NZ, nyl, NX, None, w, variant="analytic")


@pytest.fixture(scope="module")
def reference_blocks():
    """The reference's global_nz mega predictor on each checked shard's
    2-halo block, 128×32×16 over 4 shards, float32 in interpret mode."""
    nz, ny, nx = 16, 32, 128
    nzl = nz // P
    h = (1.0 / (nx - 1), 1.0 / (ny - 1), 1.0 / (nz - 1))
    mats, _, _ = j_mats(JProblem(nx, ny, nz, *h), np.float32)
    jk = JKernels(nzl + 2, ny, nx, *h, 0.0, 0.0, jnp.float32,
                  interpret=True, global_nz=nz, dst_mats=mats)
    u, v, w, p = (f.numpy() for f in _fields(4, (nz, ny, nx),
                                              torch.float32))
    prm = NSParams()
    out = {}
    for shard in SHARDS:
        z_off = shard * nzl
        blk = [np.pad(f, ((2, 2), (0, 0), (0, 0)))[z_off:z_off + nzl + 4]
               for f in (u, v, w, p)]
        res = jk.predictor_poisson_input(
            *map(jnp.asarray, blk), jnp.float32(1e-3), jnp.float32(prm.mu),
            jnp.float32(0.1), jnp.float32(0.05), jnp.float32(1e3),
            z_offset=z_off)
        res = [np.array(o)[2:-2] for o in res]
        # the reference's wrapper zeroes the global z-shell b̂ planes
        # (`parallel/fused.py:544-547`); the port's kernel writes them 0
        if shard == 0:
            res[3][0] = 0.0
        if shard == P - 1:
            res[3][-1] = 0.0
        out[shard] = (blk, res)
    return (nz, ny, nx, h), out


@pytest.mark.parametrize("shard", SHARDS)
def test_global_nz_chain_matches_reference_mega_predictor(reference_blocks,
                                                          shard):
    (nz, ny, nx, h), out = reference_blocks
    nzl = nz // P
    blk, ref = out[shard]
    c_pred = pkm.stencil_consts(nzl + 4, ny, nx, *h, 0.0, 0.0,
                                NSParams().mu, True, None, torch.float32)
    c_bt = pkm.stencil_consts(nzl + 2, ny, nx, *h, 0.0, 0.0, NSParams().mu,
                              True, None, torch.float32)
    u, v, w, p = (torch.from_numpy(b) for b in blk)
    z_off = shard * nzl
    scal = torch.tensor([1e-3, 0.1, 0.05], dtype=torch.float32)
    us, vs, ws = pkm.predictor_star(u, v, w, scal, c_pred, None, z_off - 2,
                                    nz)
    bt = pkm.poisson_input(us[1:-1], vs[1:-1], ws[1:-1], p[1:-1],
                           torch.tensor(1e3), c_bt, z_off - 1, nz)
    fxt, fy = (torch.from_numpy(m) for m in
               _dst_fused_mats(PoissonProblem(nx, ny, nz, *h),
                               np.float32)[0][:2])
    bhat = rolling.plane_dot(bt[1:-1], fxt, fy)
    for name, got, r in zip(("u*", "v*", "w*"), (us, vs, ws), ref):
        np.testing.assert_allclose(got[2:-2].numpy(), r, rtol=0, atol=2e-5,
                                   err_msg=name)
    np.testing.assert_allclose(bhat.numpy(), ref[3], rtol=0,
                               atol=2e-5 * np.abs(ref[3]).max(),
                               err_msg="b^")
