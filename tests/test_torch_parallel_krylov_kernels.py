"""The sharded Krylov passes (`cfd_tpu_torch.ops.kernels.cg_kernels` and
`bicgstab_kernels` with ``z_base`` / ``nz_g``; their plain versions on the
CPU) against the reference's ``make_lap_dot_sharded`` and
``BiCGSTABKernels(global_nz=…)`` in interpret mode, block by block on the
first, a middle and the last of 4 z-shards at 128×16×16 float32: fields
within 1e-6 of their magnitude, the shards' shares of the dots at rtol
1e-5.

The inputs are a solve's: work vectors zero outside the global Dirichlet-0
interior, halo planes the neighbours' owned planes (zero past the global
ends).  K1 and the pv / st passes take the (nzl + 2)-plane halo-padded
block (its plane 0 is global plane ``z_off − 1``); K2 and xr the owned
block, xr against the reference's plain xr on the zero-padded owned block
(`parallel/fused_bicgstab.py:229-232`).  The ``global_nz`` rhs is held
against the single-device rhs's slab, and the plain passes of a shard
against the single-device passes' slab.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_tpu.ops.pallas.bicgstab_kernels import BiCGSTABKernels
from cfd_tpu.ops.pallas.cg_kernels import make_lap_dot_sharded
from cfd_tpu_torch.ops import stencils
from cfd_tpu_torch.ops.kernels import bicgstab_kernels as bk
from cfd_tpu_torch.ops.kernels import cg_kernels as cgk
from cfd_tpu_torch.ops.kernels import projection_kernels as pkm
from cfd_tpu_torch.parallel import LocalComm

NZ, NY, NX, P = 16, 16, 128, 4
NZL = NZ // P
SHARDS = (0, 1, P - 1)          # the first, a middle and the last
H = (1.0 / (NX - 1), 1.0 / (NY - 1), 1.0 / (NZ - 1))
INV = tuple(1.0 / (h * h) for h in H)
SCALE = 1.0 / (2.0 * sum(INV))  # the Jacobi scale, inv_factor
BETA, ALPHA, OMEGA = 0.37, 0.61, 0.23


def _space(seed, dtype=np.float32):
    """A whole field zero outside the global interior."""
    rng = np.random.default_rng(seed)
    a = np.zeros((NZ, NY, NX), dtype)
    a[1:-1, 1:-1, 1:-1] = rng.normal(0.0, 1.0, (NZ - 2, NY - 2, NX - 2))
    return a


def _padded(a, shard):
    """Shard ``shard``'s halo-padded block of a whole field."""
    z_off = shard * NZL
    return np.pad(a, ((1, 1), (0, 0), (0, 0)))[z_off:z_off + NZL + 2]


def _owned(a, shard):
    return a[shard * NZL:(shard + 1) * NZL]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, ref, name):
    """Within 1e-6 of the field's magnitude: the Laplacians' second
    differences round in another order than the reference's
    ((f₊ − 2f) + f₋ against its shifted sum), ~1 ulp of values up to
    ~1e5 here."""
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0,
                               atol=1e-6 * max(1.0, np.abs(ref).max()),
                               err_msg=name)


def _dot_close(got, ref, name):
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5,
                               err_msg=name)


@pytest.fixture(scope="module")
def ref_lap_dot():
    return make_lap_dot_sharded(NZL + 2, NY, NX, *INV, SCALE, global_nz=NZ,
                                dtype=jnp.float32, interpret=True)


@pytest.fixture(scope="module")
def ref_bicg():
    return (BiCGSTABKernels(NZL + 2, NY, NX, *INV, jnp.float32, True,
                            global_nz=NZ),
            BiCGSTABKernels(NZL + 2, NY, NX, *INV, jnp.float32, True))


@pytest.mark.parametrize("shard", SHARDS)
def test_lap_dot_sharded_matches_reference(ref_lap_dot, shard):
    r, p = _space(1), _space(2)
    rb, pb = _padded(r, shard), _padded(p, shard)
    c = cgk.CGConsts(NZL + 2, NY, NX, *INV, SCALE)
    pn, ap, pap = cgk.lap_dot(_t(rb), _t(pb), BETA, c, shard * NZL - 1, NZ)
    scal = jnp.asarray([BETA, shard * NZL - 1.0], jnp.float32)
    jpn, jap, jpap = ref_lap_dot(scal, jnp.asarray(rb), jnp.asarray(pb))
    _close(pn, np.asarray(jpn)[1:-1], "p'")
    _close(ap, np.asarray(jap)[1:-1], "Ap'")
    _dot_close(pap, jpap, "<p',Ap'>")


@pytest.mark.parametrize("shard", SHARDS)
def test_cg_update_owned_block_matches_reference_axpy(shard):
    """K2 on the owned block against the reference's jnp update
    (`parallel/fused_cg.py:216-219`): x + αp′, r − αAp′ and ⟨r, r⟩."""
    rng = np.random.default_rng(3 + shard)
    x = rng.normal(0.0, 1.0, (NZL, NY, NX)).astype(np.float32)
    r, pn, ap = (_owned(_space(s), shard) for s in (4, 5, 6))
    c = cgk.CGConsts(NZL, NY, NX, *INV, SCALE)
    x2, r2, rr = cgk.cg_update(_t(x), _t(r), _t(pn), _t(ap), ALPHA, c,
                               shard * NZL, NZ)
    jx = jnp.asarray(x) + ALPHA * jnp.asarray(pn)
    jr = jnp.asarray(r) - ALPHA * jnp.asarray(ap)
    _close(x2, jx, "x")
    _close(r2, jr, "r")
    _dot_close(rr, jnp.sum(jr * jr), "<r,r>")


@pytest.mark.parametrize("shard", SHARDS)
def test_bicgstab_passes_match_reference_global_nz(ref_bicg, shard):
    kz, kplain = ref_bicg
    r, p, v, rhat = (_space(s) for s in (7, 8, 9, 10))
    rb, pb, vb = (_padded(a, shard) for a in (r, p, v))
    rh = _owned(rhat, shard)
    z_base = shard * NZL - 1
    cp = bk.BiCGConsts(NZL + 2, NY, NX, *INV)
    co = bk.BiCGConsts(NZL, NY, NX, *INV)
    # pv
    pn, vn, rhv = bk.pass_pv(_t(rb), _t(pb), _t(vb), _t(rh), BETA, OMEGA,
                             cp, z_base, NZ)
    jpn, jvn, jrhv = kz.pv(jnp.asarray([BETA, OMEGA, z_base], jnp.float32),
                           *map(jnp.asarray, (rb, pb, vb)),
                           jnp.asarray(np.pad(rh, ((1, 1), (0, 0), (0, 0)))))
    _close(pn, np.asarray(jpn)[1:-1], "p'")
    _close(vn, np.asarray(jvn)[1:-1], "v'")
    _dot_close(rhv, jrhv, "<rhat,v'>")
    # st, on the whole v' the shards' pv give (its halo planes the
    # neighbours' v')
    v_all = np.concatenate([bk.pass_pv_plain(
        _t(_padded(r, s)), _t(_padded(p, s)), _t(_padded(v, s)),
        _t(_owned(rhat, s)), BETA, OMEGA, cp, s * NZL - 1, NZ)[1].numpy()
        for s in range(P)])
    vnb = _padded(v_all, shard)
    s, t, ss, ts, tt = bk.pass_st(_t(rb), _t(vnb), ALPHA, cp, z_base, NZ)
    js, jt, jss, jts, jtt = kz.st(jnp.asarray([ALPHA, z_base], jnp.float32),
                                  jnp.asarray(rb), jnp.asarray(vnb))
    _close(s, np.asarray(js)[1:-1], "s")
    _close(t, np.asarray(jt)[1:-1], "t")
    for name, got, ref in (("<s,s>", ss, jss), ("<t,s>", ts, jts),
                           ("<t,t>", tt, jtt)):
        _dot_close(got, ref, name)
    # xr on the owned block against the plain xr on the zero-padded block
    rng = np.random.default_rng(11 + shard)
    x = rng.normal(0.0, 1.0, (NZL, NY, NX)).astype(np.float32)
    x2, r2, rr, rhr = bk.pass_xr(_t(x), pn, s, t, _t(rh), ALPHA, OMEGA, co,
                                 shard * NZL, NZ)

    def zp(a):
        return jnp.pad(jnp.asarray(np.asarray(a)), ((1, 1), (0, 0), (0, 0)))

    jx, jr, jrr, jrhr = kplain.xr(jnp.asarray([ALPHA, OMEGA], jnp.float32),
                                  zp(x), zp(pn), zp(s), zp(t), zp(rh))
    _close(x2, np.asarray(jx)[1:-1], "x")
    _close(r2, np.asarray(jr)[1:-1], "r")
    _dot_close(rr, jrr, "<r,r>")
    _dot_close(rhr, jrhr, "<rhat,r>")


@pytest.mark.parametrize("shard", SHARDS)
def test_sharded_plain_passes_are_the_single_device_slab(shard):
    """In float64 a shard's K1 / K2 / pv / st / xr equal the single-device
    passes' owned planes bit for bit, and the shards' shares sum to the
    single-device dots."""
    r, p, v, rhat = (torch.from_numpy(_space(s, np.float64))
                     for s in (12, 13, 14, 15))
    x = torch.from_numpy(np.random.default_rng(16).normal(
        0.0, 1.0, (NZ, NY, NX)))
    own = slice(shard * NZL, (shard + 1) * NZL)

    def pad(a):
        return torch.from_numpy(_padded(a.numpy(), shard))

    cg_full = cgk.CGConsts(NZ, NY, NX, *INV, SCALE)
    pn, ap, _ = cgk.lap_dot_plain(r, p, BETA, cg_full)
    spn, sap, _ = cgk.lap_dot_plain(pad(r), pad(p), BETA,
                                    cgk.CGConsts(NZL + 2, NY, NX, *INV,
                                                 SCALE), shard * NZL - 1, NZ)
    assert torch.equal(spn, pn[own]) and torch.equal(sap, ap[own])
    x2, r2, _ = cgk.cg_update_plain(x, r, pn, ap, ALPHA, cg_full)
    sx2, sr2, _ = cgk.cg_update_plain(x[own], r[own], pn[own], ap[own],
                                      ALPHA, cgk.CGConsts(NZL, NY, NX, *INV),
                                      shard * NZL, NZ)
    assert torch.equal(sx2, x2[own]) and torch.equal(sr2, r2[own])
    b_full = bk.BiCGConsts(NZ, NY, NX, *INV)
    b_pad = bk.BiCGConsts(NZL + 2, NY, NX, *INV)
    pn, vn, _ = bk.pass_pv_plain(r, p, v, rhat, BETA, OMEGA, b_full)
    spn, svn, _ = bk.pass_pv_plain(pad(r), pad(p), pad(v), rhat[own], BETA,
                                   OMEGA, b_pad, shard * NZL - 1, NZ)
    assert torch.equal(spn, pn[own]) and torch.equal(svn, vn[own])
    s, t, _, _, _ = bk.pass_st_plain(r, vn, ALPHA, b_full)
    ss, st, *_ = bk.pass_st_plain(pad(r), pad(vn), ALPHA, b_pad,
                                  shard * NZL - 1, NZ)
    assert torch.equal(ss, s[own]) and torch.equal(st, t[own])
    x2, r2, _, _ = bk.pass_xr_plain(x, pn, s, t, rhat, ALPHA, OMEGA, b_full)
    sx2, sr2, _, _ = bk.pass_xr_plain(x[own], pn[own], s[own], t[own],
                                      rhat[own], ALPHA, OMEGA,
                                      bk.BiCGConsts(NZL, NY, NX, *INV),
                                      shard * NZL, NZ)
    assert torch.equal(sx2, x2[own]) and torch.equal(sr2, r2[own])


def test_shares_sum_to_the_single_device_dots():
    """The shards' shares of ⟨p′, Ap′⟩ (float32) and of ⟨r̂, v′⟩ (float64,
    unrounded), summed by ``LocalComm.sum``, give the single-device
    dots."""
    r, p, v, rhat = (torch.from_numpy(_space(s)) for s in (17, 18, 19, 20))
    comm = LocalComm(["cpu"] * P)

    def blocks(a):
        return [torch.from_numpy(_padded(a.numpy(), s)) for s in range(P)]

    rb, pb, vb = blocks(r), blocks(p), blocks(v)
    cp = cgk.CGConsts(NZL + 2, NY, NX, *INV, SCALE)
    total = comm.sum([cgk.lap_dot_plain(rb[s], pb[s], BETA, cp,
                                        s * NZL - 1, NZ)[2]
                      for s in range(P)])
    assert len(total) == P
    _, _, pap = cgk.lap_dot_plain(r, p, BETA, cgk.CGConsts(NZ, NY, NX, *INV,
                                                           SCALE))
    _dot_close(total[0], pap, "<p',Ap'>")
    b_pad = bk.BiCGConsts(NZL + 2, NY, NX, *INV)
    shares = [bk.pass_pv_plain(rb[s], pb[s], vb[s],
                               rhat[s * NZL:(s + 1) * NZL], BETA, OMEGA,
                               b_pad, s * NZL - 1, NZ)[2] for s in range(P)]
    assert all(sh.dtype == torch.float64 for sh in shares)
    _, _, rhv = bk.pass_pv_plain(r, p, v, rhat, BETA, OMEGA,
                                 bk.BiCGConsts(NZ, NY, NX, *INV))
    _dot_close(comm.sum(shares)[0], rhv, "<rhat,v'>")


@pytest.mark.parametrize("shard", SHARDS)
def test_global_nz_rhs_is_the_single_device_slab(shard):
    """A5's ``divergence`` in ``global_nz`` mode on the 1-halo block: the
    single-device rhs's owned planes bit for bit (zero global shells)."""
    rng = np.random.default_rng(21)
    us, vs, ws = (torch.from_numpy(rng.normal(0.0, 0.1, (NZ, NY, NX)))
                  for _ in range(3))
    c = pkm.stencil_consts(NZ, NY, NX, *H, 0.0, 0.0, 0.01, False)
    rod = torch.tensor(1e3, dtype=torch.float64)
    full = pkm.poisson_rhs_plain(us, vs, ws, rod, c)
    blk = [torch.from_numpy(_padded(a.numpy(), shard)) for a in (us, vs, ws)]
    c_blk = pkm.stencil_consts(NZL + 2, NY, NX, *H, 0.0, 0.0, 0.01, False)
    got = pkm.poisson_rhs(*blk, rod, c_blk, shard * NZL - 1, NZ)
    assert torch.equal(got[1:-1], full[shard * NZL:(shard + 1) * NZL])
    mask = stencils.global_interior_mask(got.shape, shard * NZL - 1, NZ)
    assert torch.equal(got[~mask], torch.zeros_like(got[~mask]))
