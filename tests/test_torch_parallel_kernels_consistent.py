"""The consistent scheme's stencil twins in ``global_nz`` mode (queue-B
row B3: the consistent ``pred_bt`` and ``btilde_k`` on a z-decomposed
shard's block), on the CPU, on every block of 4 z-shards of a 16×64×128
grid stretched in x and y (tanh β = 1.5).

* Against the reference's consistent mega predictor in interpret mode,
  ``ProjectionKernels(nzl + 2, …, global_nz=nz, dst_mats=…,
  stretch_consistent=…, face_coeffs=…).predictor_poisson_input(...,
  z_offset=)`` (float32), built once with buoyancy: the reference builds
  no per-component ``pred_u`` / ``btilde_k`` on the consistent scheme
  (`projection_kernels.py:335-338`, `:507`), so its one-sweep predictor
  and transformed b̃ are the reference here.  u*, v*, w* within the
  mega-kernel bar atol 2e-5 (`tests/math/test_mega_kernels.py:58-65`),
  the transformed b̂ within 2e-5 of its max (a transform-space sum of
  nx·ny terms); the buoyant twin on a noisy T, the twin without
  buoyancy on T = T_ref, where the reference's buoyancy term is zero.
* Each block's owned window against the single-device consistent twin on
  the whole field, bit for bit, float32 and float64: the predictor ± T
  on the 2-halo block (the owned planes and the in-domain planes ± 1
  that b̃ reads), b̃ on the 1-halo block, and the consistent corrector on
  the block the step gives it (an edge shard's starts or ends at its
  global shell).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_tpu import Grid as JGrid
from cfd_tpu.ops.pallas.projection_kernels import \
    ProjectionKernels as JKernels
from cfd_tpu.solvers.poisson.nonuniform import \
    NonuniformPoissonProblem as JProblem
from cfd_tpu.solvers.poisson.nonuniform import \
    _nonuniform_fused_mats as j_mats
from cfd_tpu.solvers.poisson.nonuniform import \
    nonuniform_face_coeffs as j_face
from cfd_tpu_torch.interop import grid_from
from cfd_tpu_torch.ops.kernels import projection_kernels as pkm
from cfd_tpu_torch.ops.kernels import rolling
from cfd_tpu_torch.solvers.ns.params import NSParams
from cfd_tpu_torch.solvers.poisson.nonuniform import (
    NonuniformPoissonProblem, _nonuniform_fused_mats, nonuniform_face_coeffs)

torch.set_num_threads(min(2, torch.get_num_threads()))

NZ, NY, NX, P = 16, 64, 128, 4
NZL = NZ // P
SHARDS = tuple(range(P))
BUOY = dict(beta=0.05, T_ref=300.0, gravity=(0.5, -9.81, 2.0))
SU, SV, DT, ROD = 0.1, 0.05, 1e-3, 1e3
JGRID = JGrid.stretched(NX, NY, NZ, zmin=0.0, zmax=1.0, beta=1.5,
                        stretch_axes="xy")
GRID = grid_from(JGRID)
PROBLEM = NonuniformPoissonProblem.from_grid(GRID)


def _consts(nz, dtype, buoyant):
    weights = pkm.consistent_weights(GRID.dx, GRID.dy, GRID.x, GRID.y,
                                     dtype, "cpu")
    params = NSParams(**BUOY) if buoyant else None
    return pkm.stencil_consts(nz, NY, NX, GRID.dx0, GRID.dy0, GRID.dz0,
                              GRID.xmin, GRID.ymin, NSParams().mu, True,
                              params, dtype, weights,
                              nonuniform_face_coeffs(PROBLEM))


def _fields(seed, dtype):
    """u, v, w, p normal(0, 0.1) and T = 300 + N(0, 1), numpy."""
    rng = np.random.default_rng(seed)
    out = [rng.normal(0.0, 0.1, (NZ, NY, NX)).astype(dtype)
           for _ in range(4)]
    return out + [(300.0 + rng.normal(0.0, 1.0, (NZ, NY, NX)))
                  .astype(dtype)]


def _zpad(x, n):
    return np.pad(x, ((n, n), (0, 0), (0, 0)))


@pytest.fixture(scope="module")
def reference_blocks():
    """The reference's buoyant consistent global_nz mega predictor on
    every shard's 2-halo block, with the noisy T and with T = T_ref."""
    mats, _, _ = j_mats(JProblem.from_grid(JGRID), np.float32)
    jk = JKernels(NZL + 2, NY, NX, JGRID.dx0, JGRID.dy0, JGRID.dz0,
                  JGRID.xmin, JGRID.ymin, jnp.float32, interpret=True,
                  global_nz=NZ, dst_mats=mats,
                  stretch_consistent=(JGRID.dx, JGRID.dy, JGRID.x, JGRID.y),
                  face_coeffs=j_face(JProblem.from_grid(JGRID)), **BUOY)
    assert jk.mega_ok and jk.buoyant
    fields = _fields(3, np.float32)
    out = {}
    for buoyant in (True, False):
        T = fields[4] if buoyant else np.full_like(fields[4], 300.0)
        for shard in SHARDS:
            z_off = shard * NZL
            blk = [_zpad(f, 2)[z_off:z_off + NZL + 4]
                   for f in (*fields[:4], T)]
            res = jk.predictor_poisson_input(
                *map(jnp.asarray, blk[:4]), jnp.float32(DT),
                jnp.float32(NSParams().mu), jnp.float32(SU),
                jnp.float32(SV), jnp.float32(ROD),
                T=jnp.asarray(blk[4]), z_offset=z_off)
            res = [np.array(o)[2:-2] for o in res]
            # the reference's wrapper zeroes the global z-shell b̂ planes
            # (`parallel/fused.py:544-547`); the port's twin writes them 0
            if shard == 0:
                res[3][0] = 0.0
            if shard == P - 1:
                res[3][-1] = 0.0
            out[buoyant, shard] = (blk, res)
    return out


@pytest.mark.parametrize("buoyant", [True, False], ids=["T", "no_T"])
@pytest.mark.parametrize("shard", SHARDS)
def test_consistent_global_nz_twins_match_reference_mega_predictor(
        reference_blocks, shard, buoyant):
    blk, ref = reference_blocks[buoyant, shard]
    u, v, w, p, T = (torch.from_numpy(b) for b in blk)
    z_off = shard * NZL
    scal = torch.tensor([DT, SU, SV], dtype=torch.float32)
    c_pred = _consts(NZL + 4, torch.float32, buoyant)
    assert c_pred.consistent and (c_pred.buoyancy is not None) == buoyant
    us, vs, ws = pkm.predictor_star_plain(u, v, w, scal, c_pred,
                                          T if buoyant else None,
                                          z_off - 2, NZ)
    bt = pkm.poisson_input_plain(us[1:-1], vs[1:-1], ws[1:-1], p[1:-1],
                                 torch.tensor(ROD),
                                 _consts(NZL + 2, torch.float32, False),
                                 z_off - 1, NZ)
    fxt, fy = (torch.from_numpy(m) for m in
               _nonuniform_fused_mats(PROBLEM, np.float32)[0][:2])
    bhat = rolling.plane_dot_plain(bt[1:-1], fxt, fy)
    for name, got, r in zip(("u*", "v*", "w*"), (us, vs, ws), ref):
        np.testing.assert_allclose(got[2:-2].numpy(), r, rtol=0, atol=2e-5,
                                   err_msg=name)
    np.testing.assert_allclose(bhat.numpy(), ref[3], rtol=0,
                               atol=2e-5 * np.abs(ref[3]).max(),
                               err_msg="b^")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("shard", SHARDS)
def test_consistent_global_nz_twins_are_the_single_device_slab(shard,
                                                               dtype):
    np_dt = np.float32 if dtype == torch.float32 else np.float64
    u, v, w, p, T = (torch.from_numpy(f) for f in _fields(11, np_dt))
    scal = torch.tensor([DT, SU, SV], dtype=dtype)
    rod, s = torch.tensor(ROD, dtype=dtype), torch.tensor(DT, dtype=dtype)
    z_off = shard * NZL
    lo, hi = max(z_off - 1, 0), min(z_off + NZL + 1, NZ)

    def pad(x, n):
        return torch.from_numpy(_zpad(x.numpy(), n))

    for buoyant in (False, True):
        Tb = T if buoyant else None
        full = pkm.predictor_star_plain(u, v, w, scal,
                                        _consts(NZ, dtype, buoyant), Tb)
        blk = [pad(f, 2)[z_off:z_off + NZL + 4] for f in (u, v, w, T)]
        got = pkm.predictor_star_plain(*blk[:3], scal,
                                       _consts(NZL + 4, dtype, buoyant),
                                       blk[3] if buoyant else None,
                                       z_off - 2, NZ)
        for g, f in zip(got, full):
            assert torch.equal(g[lo - z_off + 2:hi - z_off + 2], f[lo:hi])
    us, vs, ws = full
    c_full = _consts(NZ, dtype, False)
    bt_full = pkm.poisson_input_plain(us, vs, ws, p, rod, c_full)
    blk = [pad(f, 1)[z_off:z_off + NZL + 2] for f in (us, vs, ws, p)]
    bt = pkm.poisson_input_plain(*blk, rod, _consts(NZL + 2, dtype, False),
                                 z_off - 1, NZ)
    assert torch.equal(bt[1:-1], bt_full[z_off:z_off + NZL])
    # the consistent corrector on the step's 1-halo block
    a, e = int(shard > 0), int(shard < P - 1)
    sl = slice(z_off - a, z_off + NZL + e)
    corr_full = pkm.corrector_plain(us, vs, ws, p, s, c_full)
    corr = pkm.corrector_plain(us[sl], vs[sl], ws[sl], p[sl], s,
                               _consts(NZL + a + e, dtype, False))
    for g, f in zip(corr[:3], corr_full[:3]):
        assert torch.equal(g[a:a + NZL], f[z_off:z_off + NZL])
