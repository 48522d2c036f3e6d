"""The (z, y) modes of the BiCGSTAB passes (`cfd_tpu_torch.ops.kernels.
bicgstab_kernels` with ``y_base`` / ``ny_g``; their plain versions on the
CPU) against the reference's ``BiCGSTABKernels(global_nz=…, global_ny=…)``
in interpret mode, block by block on the first, a middle and the last
shard of a (3, 4) mesh at 12×32×128 float32 — the middle one an inner
y-shard, whose first and last owned rows the one-device xr kernel on the
owned block would skip.

Each block is cut from the same whole fields as each package's solve
cuts it: the reference's (nzl + 2, nyl + 8) block (one halo plane and
its 4-row y ring, ``y_off`` the global row of its row 0) and the port's
(nzl + 2, nyl + 2) block.  The inputs are a solve's: work vectors zero
outside the global Dirichlet-0 interior, halos the neighbours' points
(zero past the global ends).  xr is held against the reference's plain
xr on the zero-padded owned block (`parallel/fused_bicgstab.py:229-232`).
Bars: the fields within 1e-6 of their magnitude (float32 rounding: the
Laplacian's second differences round in another order than the
reference's shifted sums); the shards' dot shares (float64 sums) within
1e-6 of Σ|aᵢbᵢ| of the reference's float32 sums (relative to the sum
itself the bar would not hold where the terms cancel: ⟨r̂, v′⟩ differs by
1.9e-6 of its value, 4e-9 of Σ|aᵢbᵢ|; the other shares by at most
1.7e-7 of either).  In float64 a shard's plain
passes equal the single-device passes at its owned points bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_tpu.ops.pallas.bicgstab_kernels import BiCGSTABKernels
from cfd_tpu_torch.ops.kernels import bicgstab_kernels as bk

NZ, NY, NX = 12, 32, 128
PZ, PY = 3, 4
NZL, NYL = NZ // PZ, NY // PY
SHARDS = [(0, 0), (1, 1), (PZ - 1, PY - 1)]   # first, middle, last
H = (1.0 / (NX - 1), 1.0 / (NY - 1), 1.0 / (NZ - 1))
INV = tuple(1.0 / (h * h) for h in H)
BETA, ALPHA, OMEGA = 0.37, 0.61, 0.23


def _space(seed, dtype=np.float32):
    """A whole field zero outside the global interior."""
    rng = np.random.default_rng(seed)
    a = np.zeros((NZ, NY, NX), dtype)
    a[1:-1, 1:-1, 1:-1] = rng.normal(0.0, 1.0, (NZ - 2, NY - 2, NX - 2))
    return a


def _block(a, zi, yi, hz, hy):
    """Shard (zi, yi)'s owned block with ``hz`` planes and ``hy`` rows a
    side from its neighbours, zeros past the global ends."""
    ap = np.pad(a, ((hz, hz), (hy, hy), (0, 0)))
    z0, y0 = zi * NZL, yi * NYL
    return np.ascontiguousarray(ap[z0:z0 + NZL + 2 * hz,
                                   y0:y0 + NYL + 2 * hy])


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, ref, name):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0,
                               atol=1e-6 * max(1.0, np.abs(ref).max()),
                               err_msg=name)


def _dot_close(got, ref, a, b, name):
    """A share against the reference's (its float32 sum, over the owned
    points of its fields ``a`` and ``b``): within 1e-6 of Σ|a·b|, the
    scale of the terms the two sums add in another order and precision."""
    prod = np.asarray(a, np.float64) * np.asarray(b, np.float64)
    np.testing.assert_allclose(float(got), float(ref), rtol=0,
                               atol=1e-6 * np.sum(np.abs(prod)),
                               err_msg=name)


def _ref_own(o):
    """The reference's ``unpad``: the owned points of its block."""
    return np.asarray(o)[1:-1, 4:-4]


@pytest.fixture(scope="module")
def ref_kernels():
    """The reference's (z, y) pv / st and its plain xr, built once."""
    return (BiCGSTABKernels(NZL + 2, NYL + 8, NX, *INV, jnp.float32, True,
                            global_nz=NZ, global_ny=NY),
            BiCGSTABKernels(NZL + 2, NYL, NX, *INV, jnp.float32, True))


@pytest.mark.parametrize("shard", SHARDS, ids=["first", "middle", "last"])
def test_bicgstab_passes_match_reference_global_ny(ref_kernels, shard):
    kzy, kplain = ref_kernels
    zi, yi = shard
    extra = [zi * NZL - 1.0, yi * NYL - 4.0]
    base = (zi * NZL - 1, NZ, yi * NYL - 1, NY)
    cp = bk.BiCGConsts(NZL + 2, NYL + 2, NX, *INV)
    r, p, v, rhat, vn = (_space(s) for s in (7, 8, 9, 10, 11))

    # pv: r̂ is read pointwise (the reference's zpad(ypad(r̂)))
    pn, vv, rhv = bk.pass_pv(*(_t(_block(a, zi, yi, 1, 1))
                               for a in (r, p, v, rhat)), BETA, OMEGA, cp,
                             *base)
    jpn, jvn, jrhv = kzy.pv(jnp.asarray([BETA, OMEGA] + extra, jnp.float32),
                            *(jnp.asarray(_block(a, zi, yi, 1, 4))
                              for a in (r, p, v)),
                            jnp.asarray(np.pad(_block(rhat, zi, yi, 0, 4),
                                               ((1, 1), (0, 0), (0, 0)))))
    _close(pn, _ref_own(jpn), "p'")
    _close(vv, _ref_own(jvn), "v'")
    _dot_close(rhv, jrhv, _block(rhat, zi, yi, 0, 0), _ref_own(jvn),
               "<rhat,v'>")

    # st on a v' of the Dirichlet-0 space, its halos the neighbours'
    s, t, ss, ts, tt = bk.pass_st(_t(_block(r, zi, yi, 1, 1)),
                                  _t(_block(vn, zi, yi, 1, 1)), ALPHA, cp,
                                  *base)
    js, jt, jss, jts, jtt = kzy.st(jnp.asarray([ALPHA] + extra, jnp.float32),
                                   jnp.asarray(_block(r, zi, yi, 1, 4)),
                                   jnp.asarray(_block(vn, zi, yi, 1, 4)))
    _close(s, _ref_own(js), "s")
    _close(t, _ref_own(jt), "t")
    js_o, jt_o = _ref_own(js), _ref_own(jt)
    for name, got, ref, a, b in (("<s,s>", ss, jss, js_o, js_o),
                                 ("<t,s>", ts, jts, jt_o, js_o),
                                 ("<t,t>", tt, jtt, jt_o, jt_o)):
        _dot_close(got, ref, a, b, name)

    # xr: every owned point but the global shells, against the plain xr
    # on the zero-padded owned block
    x = np.random.default_rng(12 + zi + yi).normal(
        0.0, 1.0, (NZ, NY, NX)).astype(np.float32)
    pn_w, s_w, t_w = (_space(q) for q in (13, 14, 15))
    x2, r2, rr, rhr = bk.pass_xr(*(_t(_block(a, zi, yi, 1, 1)) for a in (
        x, pn_w, s_w, t_w, rhat)), ALPHA, OMEGA, cp, *base)

    def zp(a):
        return jnp.asarray(np.pad(_block(a, zi, yi, 0, 0),
                                  ((1, 1), (0, 0), (0, 0))))

    jx, jr, jrr, jrhr = kplain.xr(jnp.asarray([ALPHA, OMEGA], jnp.float32),
                                  *(zp(a) for a in (x, pn_w, s_w, t_w,
                                                    rhat)))
    _close(x2, np.asarray(jx)[1:-1], "x")
    _close(r2, np.asarray(jr)[1:-1], "r")
    jr_o = np.asarray(jr)[1:-1]
    _dot_close(rr, jrr, jr_o, jr_o, "<r,r>")
    _dot_close(rhr, jrhr, _block(rhat, zi, yi, 0, 0), jr_o, "<rhat,r>")
    if shard == (1, 1):
        # the inner shard's first and last owned rows moved
        own_x = _block(x, zi, yi, 0, 0)
        for row in (0, -1):
            assert not np.array_equal(x2.numpy()[1:-1, row],
                                      own_x[1:-1, row])


@pytest.mark.parametrize("shard", SHARDS, ids=["first", "middle", "last"])
def test_global_ny_plain_passes_are_the_single_device_points(shard):
    """float64: a shard's (z, y) pv / st / xr give the single-device
    passes' values at its owned points, and their shares are the
    single-device dots restricted to its owned points."""
    zi, yi = shard
    r, p, v, rhat = (torch.from_numpy(_space(s, np.float64))
                     for s in (16, 17, 18, 19))
    x = torch.from_numpy(np.random.default_rng(20).normal(
        0.0, 1.0, (NZ, NY, NX)))
    own = (slice(zi * NZL, (zi + 1) * NZL), slice(yi * NYL, (yi + 1) * NYL))
    base = (zi * NZL - 1, NZ, yi * NYL - 1, NY)
    cp = bk.BiCGConsts(NZL + 2, NYL + 2, NX, *INV)
    full = bk.BiCGConsts(NZ, NY, NX, *INV)

    def pad(a):
        return torch.from_numpy(_block(a.numpy(), zi, yi, 1, 1))

    pn, vn, _ = bk.pass_pv_plain(r, p, v, rhat, BETA, OMEGA, full)
    spn, svn, _ = bk.pass_pv_plain(pad(r), pad(p), pad(v), pad(rhat), BETA,
                                   OMEGA, cp, *base)
    assert torch.equal(spn, pn[own]) and torch.equal(svn, vn[own])
    s, t, _, _, _ = bk.pass_st_plain(r, vn, ALPHA, full)
    ss_, st_, _, _, _ = bk.pass_st_plain(pad(r), pad(vn), ALPHA, cp, *base)
    assert torch.equal(ss_, s[own]) and torch.equal(st_, t[own])
    x2, r2, _, _ = bk.pass_xr_plain(x, pn, s, t, rhat, ALPHA, OMEGA, full)
    sx2, sr2, rr, _ = bk.pass_xr_plain(pad(x), pad(pn), pad(s), pad(t),
                                       pad(rhat), ALPHA, OMEGA, cp, *base)
    assert torch.equal(sx2, x2[own]) and torch.equal(sr2, r2[own])
    np.testing.assert_allclose(float(rr), float(torch.sum(r2[own] ** 2)),
                               rtol=1e-13)
