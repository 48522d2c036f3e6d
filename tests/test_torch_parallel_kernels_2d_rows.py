"""The global-row modes of the 2D projection kernels (`cfd_tpu_torch.ops.
kernels.projection2d` with ``y_base`` / ``ny_g``; their plain versions on
the CPU) against the reference's ``Projection2DKernels(global_ny=…)``
``pred_bt`` and ``corr`` in interpret mode, at 128×96 over 4 y-shards,
on the first, an inner and the last shard, float32, with the decaying
sources on.

Each block is cut from the same whole fields as each package's step cuts
it: the reference's rows padded four a side (its ``hpad4``, ``y_off`` the
global row of its row 0) and the port's two a side for the predictor and
b̃, one of the pressure for the corrector.  Bars on the owned rows: the
fields within 2e-6 of their magnitude (float32 rounding; the sin(πy)
source and the second differences round in another order than the
reference's rolled sums).  In float64 a shard's plain modes give the
single-device plain kernels' values at its owned rows bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_tpu.ops.pallas.projection2d import \
    Projection2DKernels as JKernels2D
from cfd_tpu_torch.ops.kernels import projection2d as p2d
from cfd_tpu_torch.ops.kernels import projection_kernels as pkm
from cfd_tpu_torch.solvers.ns.params import NSParams

NX, NY, P = 128, 96, 4
NYL = NY // P
DX, DY = 1.0 / (NX - 1), 1.0 / (NY - 1)
SHARDS = [0, 1, P - 1]
DT, SU, SV, ROD, S = 1e-3, 0.8, 0.4, 1e3, 1e-3
MU = NSParams().mu


def _fields(dtype, seed, n):
    rng = np.random.default_rng(seed)
    return [rng.normal(0.0, 0.1, (1, NY, NX)).astype(dtype)
            for _ in range(n)]


def _rows(a, yi, h):
    """Shard ``yi``'s owned rows with ``h`` rows a side from its
    neighbours, zeros past the global ends."""
    ap = np.pad(a, ((0, 0), (h, h), (0, 0)))
    return np.ascontiguousarray(ap[:, yi * NYL:yi * NYL + NYL + 2 * h])


def _consts(ny, tdt):
    return pkm.stencil_consts(1, ny, NX, DX, DY, 0.0, 0.0, 0.0, MU, True,
                              None, tdt)


def _t(a):
    return torch.from_numpy(a)


def _close(got, ref, name):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0,
                               atol=2e-6 * max(1.0, np.abs(ref).max()),
                               err_msg=name)


@pytest.fixture(scope="module")
def ref_kernels():
    return JKernels2D(NYL + 8, NX, DX, DY, 0.0, 0.0, jnp.float32,
                      emit="btilde", with_sources=True, interpret=True,
                      global_ny=NY)


@pytest.mark.parametrize("yi", SHARDS, ids=["first", "inner", "last"])
def test_global_row_pred_bt_matches_reference(ref_kernels, yi):
    u, v, w, p = _fields(np.float32, 5, 4)
    jus, jvs, jws, jbt = ref_kernels.predictor_and_poisson_input(
        *(jnp.asarray(_rows(f, yi, 4)) for f in (u, v, w, p)),
        DT, MU, SU, SV, ROD, y_offset=yi * NYL - 4)
    c = _consts(NYL + 4, torch.float32)
    star = p2d.predictor_star_2d(
        *(_t(_rows(f, yi, 2)) for f in (u, v, w)),
        torch.tensor([DT, SU, SV]), c, y_base=yi * NYL - 2, ny_g=NY)
    for name, g, r in zip(("u*", "v*", "w*"), star, (jus, jvs, jws)):
        _close(g[:, 2:-2], np.asarray(r)[:, 4:-4], name)
    bt = p2d.poisson_input_2d(star[0], star[1], _t(_rows(p, yi, 0)),
                              torch.tensor(ROD), c, yi * NYL - 2, NY, 2)
    assert tuple(bt.shape) == (1, NYL, NX)
    _close(bt, np.asarray(jbt)[:, 4:-4], "b~")


@pytest.mark.parametrize("yi", SHARDS, ids=["first", "inner", "last"])
def test_global_row_corrector_matches_reference(ref_kernels, yi):
    us, vs, p = _fields(np.float32, 6, 3)
    ju, jv = ref_kernels.corrector(
        *(jnp.asarray(_rows(f, yi, 4)) for f in (us, vs, p)), S,
        y_offset=yi * NYL - 4)
    u, v, po = p2d.corrector_2d_rows(
        _t(_rows(us, yi, 2)), _t(_rows(vs, yi, 2)), _t(_rows(p, yi, 1)),
        torch.tensor(S), _consts(NYL + 2, torch.float32), yi * NYL - 1, NY)
    _close(u, np.asarray(ju)[:, 4:-4], "u")
    _close(v, np.asarray(jv)[:, 4:-4], "v")
    np.testing.assert_array_equal(po.numpy(), _rows(p, yi, 0))


@pytest.mark.parametrize("yi", SHARDS, ids=["first", "inner", "last"])
def test_global_row_plain_modes_are_the_single_device_rows(yi):
    """float64: the predictor, b̃ and the corrector of a shard give the
    single-device plain kernels' values at its owned rows."""
    u, v, w, p = (_t(a) for a in _fields(np.float64, 7, 4))
    own = slice(yi * NYL, (yi + 1) * NYL)
    scal = torch.tensor([DT, SU, SV], dtype=torch.float64)
    rod, s = (torch.tensor(x, dtype=torch.float64) for x in (ROD, S))
    full = _consts(NY, torch.float64)
    us, vs, ws = pkm.predictor_star_plain(u, v, w, scal, full)
    bt = p2d.poisson_input_2d_plain(us, vs, p, rod, full)
    uc, vc = p2d.corrector_2d_plain(us, vs, p, s, full)

    def rows(a, h):
        return _t(_rows(a.numpy(), yi, h))

    c_pred = _consts(NYL + 4, torch.float64)
    sus, svs, sws = pkm.predictor_star_plain(
        rows(u, 2), rows(v, 2), rows(w, 2), scal, c_pred, y_base=yi * NYL - 2,
        ny_g=NY)
    for got, ref in ((sus, us), (svs, vs), (sws, ws)):
        assert torch.equal(got[:, 2:-2], ref[:, own])
    sbt = p2d.poisson_input_2d_plain(rows(us, 2), rows(vs, 2), rows(p, 0),
                                     rod, c_pred, yi * NYL - 2, NY, 2)
    assert torch.equal(sbt, bt[:, own])
    su_, sv_, sp = p2d.corrector_2d_rows_plain(
        rows(us, 2), rows(vs, 2), rows(p, 1), s, _consts(NYL + 2,
                                                          torch.float64),
        yi * NYL - 1, NY)
    assert torch.equal(su_, uc[:, own]) and torch.equal(sv_, vc[:, own])
    assert torch.equal(sp, p[:, own])
