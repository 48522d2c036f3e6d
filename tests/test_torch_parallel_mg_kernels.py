"""The red-black sweep's sharded modes (``rb_sweep(..., z_off, gnz[, y_off,
gny])``), on the CPU through their plain twin.

* On every shard's block of 2 and 4 z-shards and of a (2, 2) (z, y) mesh
  of a 17³ and a 33×17×17 field — each global axis padded to an even
  share a shard, the block four halo planes (and rows) a side — red-first
  with the residual, red-first and black-first leave x on the owned
  planes and rows bit-equal to the single-device sweep of the whole
  field, and the residual bit-equal on them and on the one plane (row)
  past them, in float32 and float64;
* with three halo planes (an odd depth: the checkerboard is keyed on the
  global index) x and the residual are still the single-device ones on
  the owned planes;
* the points outside the global Dirichlet-0 interior and on the block's
  edge keep x and get a zero residual;
* on the CPU the wrapper counts no launch, and a row offset without a
  plane offset raises.

The kernels themselves run only on the card: ``chip_smoke.py`` phase 62
holds them against these twins bit for bit.
"""

import numpy as np
import pytest
import torch

from cfd_tpu_torch.ops.kernels import mg_kernels as mgk
from cfd_tpu_torch.solvers.poisson import multigrid as mgs
from cfd_tpu_torch.solvers.poisson.base import PoissonProblem

torch.set_num_threads(min(2, torch.get_num_threads()))

VARIANTS = {"red+r": ("red", True), "red": ("red", False),
            "black": ("black", False)}
MESHES = {"z2": (2, 1), "z4": (4, 1), "zy22": (2, 2)}
SHAPES = {"17^3": (17, 17, 17), "17x17x33": (33, 17, 17)}
DTYPES = {"f32": (torch.float32, np.float32),
          "f64": (torch.float64, np.float64)}


def _share(n, shards):
    return -(-n // (2 * shards)) * 2


def _system(shape, np_dt, seed=0):
    nz, ny, nx = shape
    prob = PoissonProblem(nx, ny, nz, 1.0 / (nx - 1), 1.0 / (ny - 1),
                          1.0 / (nz - 1))
    rng = np.random.default_rng(seed)
    x = prob.zero_boundary(torch.tensor(rng.normal(0, 1, shape)
                                        .astype(np_dt)))
    b = torch.tensor(rng.normal(0, 1, shape).astype(np_dt))
    return mgs._build_levels(prob)[0], x, b


def _blocks(a, pz, py, h):
    """Each shard's (g0, g0y, block): its owned planes (rows) of ``a``
    padded to even shares, with ``h`` halo planes (and, for py > 1, rows)
    a side, zeros past the global ends."""
    nz, ny, nx = a.shape
    nzl = _share(nz, pz)
    nyl, hy = (_share(ny, py), h) if py > 1 else (ny, 0)
    ap = a.new_zeros((nzl * pz + 2 * h, nyl * py + 2 * hy, nx))
    ap[h:h + nz, hy:hy + ny] = a
    return [(zi * nzl, yi * nyl,
             ap[zi * nzl:(zi + 1) * nzl + 2 * h,
                yi * nyl:(yi + 1) * nyl + 2 * hy].clone())
            for zi in range(pz) for yi in range(py)], nzl, nyl, hy


def _sweep_blocks(shape, dtypes, mesh, variant, h):
    """The single-device sweep of the whole field and every shard's
    swept block: (x, r, [(g0, g0y, xb, rb)], nzl, nyl, hy)."""
    (tdt, ndt), (pz, py) = dtypes, mesh
    first, emit = VARIANTS[variant]
    lv, x, b = _system(shape, ndt)
    xs, rs = x.clone(), torch.empty_like(x) if emit else None
    mgk.rb_sweep(xs, b, lv, first, rs)
    xbl, nzl, nyl, hy = _blocks(x, pz, py, h)
    bbl = _blocks(b, pz, py, h)[0]
    out = []
    for (g0, g0y, xb), (_, _, bb) in zip(xbl, bbl):
        rb = torch.full_like(xb, float("nan")) if emit else None
        mode = dict(z_off=g0 - h, gnz=shape[0])
        if py > 1:
            mode.update(y_off=g0y - hy, gny=shape[1])
        mgk.rb_sweep(xb, bb, lv, first, rb, **mode)
        out.append((g0, g0y, xb, rb))
    return xs, rs, out, nzl, nyl, hy


def _window(a, g0, g0y, h, hy, z1, z2, y1, y2):
    """Global planes z1..z2−1, rows y1..y2−1 of a shard's block."""
    return a[z1 - g0 + h:z2 - g0 + h, y1 - g0y + hy:y2 - g0y + hy]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_owned_planes_equal_the_single_device_sweep(shape, mesh, variant,
                                                    dtype):
    shape, (pz, py) = SHAPES[shape], MESHES[mesh]
    nz, ny, _ = shape
    xs, rs, blocks, nzl, nyl, hy = _sweep_blocks(shape, DTYPES[dtype],
                                                 (pz, py), variant, 4)
    for g0, g0y, xb, rb in blocks:
        z1, z2 = g0, min(g0 + nzl, nz)
        y1, y2 = (g0y, min(g0y + nyl, ny)) if py > 1 else (0, ny)
        if z1 >= z2:
            continue            # a shard of padding planes only
        got = _window(xb, g0, g0y, 4, hy, z1, z2, y1, y2)
        assert torch.equal(got, xs[z1:z2, y1:y2]), (g0, g0y)
        if rb is not None:
            # the residual one plane (row) past the owned ones too
            z1, z2 = max(z1 - 1, 0), min(z2 + 1, nz)
            if py > 1:
                y1, y2 = max(y1 - 1, 0), min(y2 + 1, ny)
            got = _window(rb, g0, g0y, 4, hy, z1, z2, y1, y2)
            assert torch.equal(got, rs[z1:z2, y1:y2]), (g0, g0y)


@pytest.mark.parametrize("mesh", ["z4", "zy22"])
def test_odd_halo_depth_keeps_the_global_colouring(mesh):
    """Three halo planes (rows): x and the residual on the owned planes
    are still the single-device sweep's."""
    shape, (pz, py) = SHAPES["17^3"], MESHES[mesh]
    nz, ny, _ = shape
    xs, rs, blocks, nzl, nyl, hy = _sweep_blocks(
        shape, DTYPES["f32"], (pz, py), "red+r", 3)
    for g0, g0y, xb, rb in blocks:
        z1, z2 = g0, min(g0 + nzl, nz)
        y1, y2 = (g0y, min(g0y + nyl, ny)) if py > 1 else (0, ny)
        if z1 >= z2:
            continue
        for got, ref in ((xb, xs), (rb, rs)):
            assert torch.equal(_window(got, g0, g0y, 3, hy, z1, z2, y1, y2),
                               ref[z1:z2, y1:y2]), (g0, g0y)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_outside_the_masks_x_stays_and_the_residual_is_zero(mesh):
    shape, (pz, py) = SHAPES["17^3"], MESHES[mesh]
    lv, x, b = _system(shape, np.float32, seed=4)
    xbl, nzl, nyl, hy = _blocks(x + 1.0, pz, py, 4)   # a non-zero shell
    bbl = _blocks(b, pz, py, 4)[0]
    for (g0, g0y, xb), (_, _, bb) in zip(xbl, bbl):
        before, rb = xb.clone(), torch.full_like(xb, float("nan"))
        mode = dict(z_off=g0 - 4, gnz=shape[0])
        if py > 1:
            mode.update(y_off=g0y - hy, gny=shape[1])
        mgk.rb_sweep(xb, bb, lv, "red", rb, **mode)
        inside = mgk._shard_masks(xb.shape, None, *mgk._shard_of(
            mode["z_off"], mode["gnz"], mode.get("y_off"),
            mode.get("gny")))[0]
        assert torch.equal(xb[~inside], before[~inside])
        assert torch.equal(rb[~inside], torch.zeros_like(rb[~inside]))
        assert bool(torch.isfinite(rb).all())


def test_wrapper_counts_nothing_on_the_cpu_and_checks_its_modes():
    lv, x, b = _system((17, 17, 17), np.float32)
    counts = (mgk.rb_sweep.launches, mgk.rb_sweep.global_nz_launches,
              mgk.rb_sweep.global_ny_launches)
    mgk.rb_sweep(x.clone(), b, lv, z_off=0, gnz=17)
    mgk.rb_sweep(x.clone(), b, lv, z_off=0, gnz=17, y_off=0, gny=17)
    assert (mgk.rb_sweep.launches, mgk.rb_sweep.global_nz_launches,
            mgk.rb_sweep.global_ny_launches) == counts
    with pytest.raises(ValueError):
        mgk.rb_sweep(x.clone(), b, lv, y_off=0, gny=17)
    with pytest.raises(ValueError):
        mgk.rb_sweep(x.clone(), b, lv, z_off=0)
