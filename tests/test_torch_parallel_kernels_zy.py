"""The global-row (z, y) modes of the projection and CG kernels' plain
versions against the reference's ``ProjectionKernels(global_nz=,
global_ny=)`` per-component kernels and ``make_lap_dot_sharded(...,
global_ny=)`` in interpret mode, on the CPU.

A 12×32×128 field over a (3, 4) mesh, each checked shard's block cut as
each package's step cuts it: the reference's (nzl+2, nyl+8, 128) block
(one halo plane, four halo rows a side, ``y_off`` the global row of its
row 0) and the port's (nzl+4, nyl+4) predictor block, (nzl+2, nyl+2)
corrector and CG blocks.  The shards are the first, a middle and the last
of each axis.  The reference's wrapper restores the global z-shells
afterwards (``fix_shell``, `cfd_tpu/parallel/fused.py:766-771`); the
port's kernels pass them through themselves.  Bars on the owned window:
float32 2e-5 (the mega-kernel bar, `tests/math/test_mega_kernels.py:
58-65`), float64 1e-12 (the same arithmetic in another order); the dot
share float32 at 1e-5 of its size.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_tpu.ops.pallas.cg_kernels import make_lap_dot_sharded
from cfd_tpu.ops.pallas.projection_kernels import \
    ProjectionKernels as JKernels
from cfd_tpu_torch.ops.kernels import cg_kernels as cgk
from cfd_tpu_torch.ops.kernels import projection_kernels as pkm
from cfd_tpu_torch.solvers.ns.params import NSParams

NZ, NY, NX = 12, 32, 128
PZ, PY = 3, 4
NZL, NYL = NZ // PZ, NY // PY
H = (1.0 / (NX - 1), 1.0 / (NY - 1), 1.0 / (NZ - 1))
SHARDS = [(0, 0), (1, 1), (PZ - 1, PY - 1)]   # first, middle, last
DT, SU, SV, ROD, S = 1e-3, 0.1, 0.05, 1e3, 1e-3
MU = NSParams().mu
DTYPES = {"float32": (np.float32, torch.float32, jnp.float32, 2e-5),
          "float64": (np.float64, torch.float64, jnp.float64, 1e-12)}


def _fields(np_dt, seed=5, n=4):
    rng = np.random.default_rng(seed)
    return [rng.normal(0.0, 0.1, (NZ, NY, NX)).astype(np_dt)
            for _ in range(n)]


def _block(a, zi, yi, hz, hy):
    """Shard (zi, yi)'s owned block with ``hz`` planes and ``hy`` rows a
    side from its neighbours, zeros past the global ends."""
    ap = np.pad(a, ((hz, hz), (hy, hy), (0, 0)))
    z0, y0 = zi * NZL, yi * NYL
    return np.ascontiguousarray(ap[z0:z0 + NZL + 2 * hz,
                                   y0:y0 + NYL + 2 * hy])


def _zero_planes(b):
    """The reference's ``zpad``: inputs read at owned planes only."""
    b = b.copy()
    b[0] = b[-1] = 0.0
    return b


def _ref_owned(o, zi, src):
    """The reference's ``unpad`` and ``fix_shell`` of an output."""
    o = np.array(o)[1:-1, 4:-4]
    if zi == 0:
        o[0] = src[0]
    if zi == PZ - 1:
        o[-1] = src[-1]
    return o


def _jk(jdt):
    return JKernels(NZL + 2, NYL + 8, NX, *H, 0.0, 0.0, jdt, interpret=True,
                    global_nz=NZ, global_ny=NY)


def _consts(nz, ny, tdt):
    return pkm.stencil_consts(nz, ny, NX, *H, 0.0, 0.0, MU, True, None, tdt)


def _t(a):
    return torch.from_numpy(a)


@pytest.mark.parametrize("dt_name", list(DTYPES))
@pytest.mark.parametrize("shard", SHARDS, ids=["first", "middle", "last"])
def test_global_row_predictor_matches_reference(shard, dt_name):
    np_dt, tdt, jdt, tol = DTYPES[dt_name]
    zi, yi = shard
    u, v, w, _ = _fields(np_dt)
    jk = _jk(jdt)
    scal = jnp.asarray([DT, MU, SU, SV, yi * NYL - 4], jdt)
    halo = {n: jnp.asarray(_block(f, zi, yi, 1, 4))
            for n, f in zip("uvw", (u, v, w))}
    plane = {n: jnp.asarray(_zero_planes(_block(f, zi, yi, 1, 4)))
             for n, f in zip("uvw", (u, v, w))}
    # each component on its own z-halo block, the others read in-plane
    # (the reference step's pred_u/v/w calls, `parallel/fused.py:859-864`)
    ref = [jk.pred_u(scal, halo["u"], plane["v"], plane["w"])[0],
           jk.pred_v(scal, halo["v"], plane["u"], plane["w"])[0],
           jk.pred_w(scal, halo["w"], plane["u"], plane["v"])[0]]
    got = pkm.predictor_star_plain(
        *(_t(_block(f, zi, yi, 2, 2)) for f in (u, v, w)),
        torch.tensor([DT, SU, SV], dtype=tdt), _consts(NZL + 4, NYL + 4, tdt),
        None, zi * NZL - 2, NZ, yi * NYL - 2, NY)
    for name, g, r, f in zip("uvw", got, ref, (u, v, w)):
        own = _block(f, zi, yi, 0, 0)
        np.testing.assert_allclose(g[2:-2, 2:-2].numpy(),
                                   _ref_owned(r, zi, own), rtol=0,
                                   atol=tol, err_msg=f"{name}*")


@pytest.mark.parametrize("dt_name", list(DTYPES))
@pytest.mark.parametrize("shard", SHARDS, ids=["first", "middle", "last"])
def test_global_row_btilde_and_rhs_match_reference(shard, dt_name):
    np_dt, tdt, jdt, tol = DTYPES[dt_name]
    zi, yi = shard
    us, vs, ws, p = _fields(np_dt, seed=6)
    jk, y_off = _jk(jdt), yi * NYL - 4
    zb = [jnp.asarray(_zero_planes(_block(f, zi, yi, 1, 4)))
          for f in (us, vs, p)]
    wb = jnp.asarray(_block(ws, zi, yi, 1, 4))
    zero = np.zeros((NZL, NYL, NX), np_dt)
    ref_bt = _ref_owned(jk.btilde(zb[0], zb[1], wb, zb[2], jdt(ROD),
                                  z_offset=zi * NZL, y_offset=y_off),
                        zi, zero)
    ref_rhs = _ref_owned(jk.rhs(zb[0], zb[1], wb, jdt(ROD), y_offset=y_off),
                         zi, zero)
    star = [_t(_block(f, zi, yi, 2, 2)) for f in (us, vs, ws)]
    c = _consts(NZL + 4, NYL + 4, tdt)
    base = (zi * NZL - 2, NZ, yi * NYL - 2, NY, 2)
    rod = torch.tensor(ROD, dtype=tdt)
    bt = pkm.poisson_input_plain(*star, _t(_block(p, zi, yi, 0, 0)), rod, c,
                                 *base)
    rhs = pkm.poisson_rhs_plain(*star, rod, c, *base)
    assert tuple(bt.shape) == tuple(rhs.shape) == (NZL, NYL, NX)
    scale = max(np.abs(ref_bt).max(), 1.0)
    np.testing.assert_allclose(bt.numpy(), ref_bt, rtol=0,
                               atol=tol * scale, err_msg="b~")
    np.testing.assert_allclose(rhs.numpy(), ref_rhs, rtol=0,
                               atol=tol * scale, err_msg="rhs")


@pytest.mark.parametrize("dt_name", list(DTYPES))
@pytest.mark.parametrize("shard", SHARDS, ids=["first", "middle", "last"])
def test_global_row_corrector_matches_reference(shard, dt_name):
    np_dt, tdt, jdt, tol = DTYPES[dt_name]
    zi, yi = shard
    us, vs, ws, p = _fields(np_dt, seed=7)
    p = p * 100.0
    ref = _jk(jdt).corrector(
        jnp.asarray(_zero_planes(_block(us, zi, yi, 1, 4))),
        jnp.asarray(_zero_planes(_block(vs, zi, yi, 1, 4))),
        jnp.asarray(_zero_planes(_block(ws, zi, yi, 1, 4))),
        jnp.asarray(_block(p, zi, yi, 1, 4)), jdt(S), y_offset=yi * NYL - 4)
    got = pkm.corrector_rows_plain(
        *(_t(_block(f, zi, yi, 2, 2)) for f in (us, vs, ws)),
        _t(_block(p, zi, yi, 1, 1)), torch.tensor(S, dtype=tdt),
        _consts(NZL + 2, NYL + 2, tdt), zi * NZL - 1, NZ, yi * NYL - 1, NY)
    for name, g, r, f in zip("uvw", got, ref, (us, vs, ws)):
        np.testing.assert_allclose(
            g.numpy(), _ref_owned(r, zi, _block(f, zi, yi, 0, 0)), rtol=0,
            atol=tol, err_msg=name)
    own = _block(p, zi, yi, 0, 0)
    assert np.array_equal(got[3].numpy(), own)
    m2 = max(float((got[0] ** 2 + got[1] ** 2 + got[2] ** 2).max()), 0.0)
    assert float(got[4]) == pytest.approx(m2, rel=1e-6)
    assert float(got[5]) == own.max() and float(got[6]) == np.abs(own).max()


@pytest.mark.parametrize("shard", SHARDS, ids=["first", "middle", "last"])
def test_global_row_lap_dot_matches_reference(shard):
    """K1's (z, y) mode (``make_lap_dot_sharded(global_ny=)``): p′ and Ap′
    on the owned window, and the shard's share of ⟨p′, Ap′⟩, float32."""
    zi, yi = shard
    r, p = _fields(np.float32, seed=8, n=2)
    inv = tuple(1.0 / h ** 2 for h in H)
    lap_dot = make_lap_dot_sharded(NZL + 2, NYL + 8, NX, *inv, 1.0,
                                   global_nz=NZ, global_ny=NY,
                                   dtype=jnp.float32, interpret=True)
    scal = jnp.asarray([0.37, zi * NZL - 1, yi * NYL - 4], jnp.float32)
    pn_r, ap_r, pap_r = lap_dot(scal, jnp.asarray(_block(r, zi, yi, 1, 4)),
                                jnp.asarray(_block(p, zi, yi, 1, 4)))
    c = cgk.CGConsts(NZL + 2, NYL + 2, NX, *inv)
    pn, ap, pap = cgk.lap_dot_plain(
        _t(_block(r, zi, yi, 1, 1)), _t(_block(p, zi, yi, 1, 1)),
        torch.tensor(0.37), c, zi * NZL - 1, NZ, yi * NYL - 1, NY)
    np.testing.assert_allclose(pn.numpy(), np.array(pn_r)[1:-1, 4:-4],
                               rtol=0, atol=2e-5, err_msg="p'")
    ap_ref = np.array(ap_r)[1:-1, 4:-4]
    np.testing.assert_allclose(ap.numpy(), ap_ref, rtol=0,
                               atol=2e-5 * np.abs(ap_ref).max(),
                               err_msg="Ap'")
    assert float(pap) == pytest.approx(float(pap_r), rel=1e-5)


@pytest.mark.parametrize("shard", SHARDS, ids=["first", "middle", "last"])
def test_global_row_update_is_the_single_device_update(shard):
    """K2's (z, y) mode on the padded block: the owned points of the
    single-device update, the halo untouched, the share of ⟨r′, r′⟩."""
    zi, yi = shard
    x, r, pn, ap = (torch.from_numpy(a) for a in _fields(np.float64, 9))
    c = cgk.CGConsts(NZ, NY, NX, 1.0, 1.0, 1.0)
    x1, r1, _ = cgk.cg_update_plain(x, r, pn, ap, 0.61, c)
    blk = [_t(_block(a.numpy(), zi, yi, 1, 1)) for a in (x, r, pn, ap)]
    cb = cgk.CGConsts(NZL + 2, NYL + 2, NX, 1.0, 1.0, 1.0)
    x2, r2, rr = cgk.cg_update_plain(*blk, 0.61, cb, zi * NZL - 1, NZ,
                                     yi * NYL - 1, NY)
    for got, full, b in ((x2, x1, blk[0]), (r2, r1, blk[1])):
        assert torch.equal(got[1:-1, 1:-1],
                           _t(_block(full.numpy(), zi, yi, 0, 0)))
        assert torch.equal(got[0], b[0]) and torch.equal(got[:, 0], b[:, 0])
    own = r2[1:-1, 1:-1]
    mask = torch.zeros_like(own, dtype=torch.bool)
    zg = zi * NZL + torch.arange(NZL)
    yg = yi * NYL + torch.arange(NYL)
    mask[:, :, 1:-1] = (((zg > 0) & (zg < NZ - 1))[:, None]
                        & ((yg > 0) & (yg < NY - 1))[None, :])[:, :, None]
    assert float(rr) == pytest.approx(float((own[mask] ** 2).sum()),
                                      rel=1e-12)


def test_global_row_modes_refuse_the_consistent_scheme():
    c = pkm.stencil_consts(NZL + 4, NYL + 4, NX, *H, 0.0, 0.0, MU, True,
                           None, torch.float32,
                           weights=(torch.zeros(7, NX),
                                    torch.zeros(7, NYL + 4)))
    blk = [torch.zeros((NZL + 4, NYL + 4, NX)) for _ in range(3)]
    with pytest.raises(ValueError, match="global_ny"):
        pkm.predictor_star_plain(*blk, torch.zeros(3), c, None, 0, NZ, 0, NY)
