"""The port's stretched grid and its spacing helpers against the
reference's: ``Grid.stretched`` and ``interop.grid_from`` bit for bit, the
spacing arrays, the consistent triples and the spacing operators in
float64 within 1e-15, the explicit gate, and the kernels' per-axis weight
vectors against the rows and columns of the reference's pinned planes bit
for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_tpu import Grid as JGrid
from cfd_tpu.ops.pallas import stretch as jstretch
from cfd_tpu.solvers.ns import NSParams as JParams
from cfd_tpu.solvers.ns import common as jcommon
from cfd_tpu_torch import CFDError, Grid
from cfd_tpu_torch.interop import grid_from
from cfd_tpu_torch.ops.kernels import stretch
from cfd_tpu_torch.solvers.ns import common
from cfd_tpu_torch.solvers.ns.params import NSParams

torch.set_num_threads(min(2, torch.get_num_threads()))

ATTRS = ("x", "y", "z", "dx", "dy", "dz")
CASES = {
    "3d_xy": dict(nx=24, ny=20, nz=10, zmin=0.0, zmax=1.0, beta=1.5,
                  stretch_axes="xy"),
    "3d_xyz": dict(nx=24, ny=20, nz=10, xmin=-1.0, xmax=2.0, zmin=0.0,
                   zmax=0.5, beta=2.0),
    "3d_x": dict(nx=128, ny=16, nz=8, zmin=0.0, zmax=1.0, beta=1.5,
                 stretch_axes="x"),
    "2d_y": dict(nx=40, ny=32, xmax=4.0, beta=1.5, stretch_axes="y"),
    "2d_xy": dict(nx=37, ny=23, beta=1.5),
    "beta_0": dict(nx=24, ny=20, nz=10, zmin=0.0, zmax=1.0, beta=0.0),
    "beta_tiny": dict(nx=24, ny=20, beta=1e-12, stretch_axes="x"),
}


def _same_grid(g, jg):
    for a in ATTRS:
        ref = getattr(jg, a)
        got = getattr(g, a)
        if ref is None:
            assert got is None, a
        else:
            np.testing.assert_array_equal(got, ref, err_msg=a)
    assert (g.shape, g.dx0, g.dy0, g.dz0, g.inv_dz2) == (
        jg.shape, jg.dx0, jg.dy0, jg.dz0, jg.inv_dz2)
    for axis in ("x", "y", "z", "all"):
        assert g.is_uniform(axis) == jg.is_uniform(axis), axis


@pytest.mark.parametrize("case", sorted(CASES))
def test_stretched_grid_matches_reference(case):
    """The tanh formula, β≈0 → uniform, the stretched axes and inv_dz2
    from the smallest dz, bit for bit; ``grid_from`` carries the
    reference's grid across unchanged."""
    g = Grid.stretched(**CASES[case])
    jg = JGrid.stretched(**CASES[case])
    _same_grid(g, jg)
    _same_grid(grid_from(jg), jg)
    assert grid_from(g) is g


@pytest.mark.parametrize("axes", ["", "xw", "abc"])
def test_bad_stretch_axes_raise_in_both(axes):
    with pytest.raises(ValueError):
        Grid.stretched(8, 8, beta=1.0, stretch_axes=axes)
    with pytest.raises(ValueError):
        JGrid.stretched(8, 8, beta=1.0, stretch_axes=axes)


def test_stretched_grid_bounds_validated():
    with pytest.raises(CFDError):
        Grid.stretched(8, 8, 4, zmin=1.0, zmax=1.0, beta=1.0)


def _xy_grids():
    kw = CASES["3d_xy"]
    return Grid.stretched(**kw), JGrid.stretched(**kw)


def test_spacing_arrays_match_reference():
    g, jg = _xy_grids()
    got = common.spacing_arrays(g, torch.float64)
    ref = jcommon.spacing_arrays(jg, jnp.float64)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-15,
                                   atol=0)


@pytest.mark.parametrize("axis", ["dx", "dy"])
def test_consistent_triples_match_reference(axis):
    g, jg = _xy_grids()
    for a, b in zip(common.consistent_triples(getattr(g, axis)),
                    jcommon.consistent_triples(getattr(jg, axis))):
        np.testing.assert_allclose(a, b, rtol=1e-15, atol=0)


@pytest.mark.parametrize("scheme", ["parity", "consistent"])
@pytest.mark.parametrize("uniform", [False, True], ids=["stretched",
                                                        "uniform"])
def test_spacing_operators_match_reference(scheme, uniform):
    """The four derivative operators on one random field, float64 within
    1e-15 of the reference's (relative to the result), and the validity
    mask; on a uniform grid both schemes are the parity operators."""
    if uniform:
        g = Grid.uniform(24, 20, 10, zmin=0.0, zmax=1.0)
        jg = JGrid.uniform(24, 20, 10, zmin=0.0, zmax=1.0)
    else:
        g, jg = _xy_grids()
    f = np.random.default_rng(3).normal(size=g.shape)
    tf, jf = torch.tensor(f), jnp.asarray(f)
    ours = common.spacing_operators(g, torch.float64, scheme)
    theirs = jcommon.spacing_operators(jg, jnp.float64, scheme)
    for axis, (op, jop) in enumerate(zip(ours[:4], theirs[:4])):
        dim = -1 if axis % 2 == 0 else -2
        views = (torch.roll(tf, 1, dim), tf, torch.roll(tf, -1, dim))
        jviews = (jnp.roll(jf, 1, dim), jf, jnp.roll(jf, -1, dim))
        got, ref = op(*views).numpy(), np.asarray(jop(*jviews))
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-15 * np.abs(ref).max())
    np.testing.assert_array_equal(ours[4].numpy(), np.asarray(theirs[4]))
    with pytest.raises(CFDError):
        common.spacing_operators(g, torch.float64, "upwind")


def test_stretch_gate_matches_reference():
    """The explicit kernels' gate: (dx, dy, x, y) on a stretched grid,
    None on a uniform one, the parity + energy refusal and the pin
    counts, as the reference's."""
    g, jg = _xy_grids()
    gu = Grid.uniform(24, 20, 10, zmin=0.0, zmax=1.0)
    jgu = JGrid.uniform(24, 20, 10, zmin=0.0, zmax=1.0)
    for kw in (dict(), dict(nonuniform_scheme="consistent"),
               dict(alpha=1e-3), dict(alpha=1e-3,
                                      nonuniform_scheme="consistent")):
        for grid, jgrid in ((g, jg), (gu, jgu)):
            s, reason = common.stretch_gate(grid, NSParams(**kw))
            js, jreason = jcommon.stretch_gate(jgrid, JParams(**kw))
            assert reason == jreason
            assert (s is None) == (js is None)
            if s is not None:
                for a, b in zip(s, js):
                    np.testing.assert_array_equal(a, b)
            assert common.stretch_mode(grid, NSParams(**kw))[1] == \
                jcommon.stretch_mode(jgrid, JParams(**kw))[1]
            assert common.stretch_pin_count(grid, NSParams(**kw)) == \
                jcommon.stretch_pin_count(jgrid, JParams(**kw))


@pytest.mark.parametrize("np_dtype", [np.float32, np.float64])
def test_weight_vectors_equal_reference_pins(np_dtype):
    """Each row of the port's x weights equals every row of the
    reference's x-pin plane, each row of its y weights every column of
    the y-pin plane, bit for bit: parity (3 pins), consistent (7), the
    corrector's gradient (3) and the 2D inputs."""
    g, _ = _xy_grids()
    ny, nx = g.ny, g.nx
    args = (g.dx, g.dy, g.x, g.y)

    def rows_equal(vec, plane):
        np.testing.assert_array_equal(
            np.broadcast_to(vec[None, :], plane.shape), plane)

    def cols_equal(vec, plane):
        np.testing.assert_array_equal(
            np.broadcast_to(vec[:, None], plane.shape), plane)

    xw, yw = stretch.stretch_pins(*args, np_dtype)
    cx, cy, src = jstretch.stretch_pins(ny, nx, *args, np_dtype)
    rows_equal(xw[0], cx[0]), rows_equal(xw[1], cx[1])
    cols_equal(yw[0], cy[0]), cols_equal(yw[1], cy[1])
    cols_equal(yw[2], src[0]), rows_equal(xw[2], src[1])
    assert xw.dtype == yw.dtype == np_dtype

    xw, yw = stretch.stretch_pins_consistent(*args, np_dtype)
    pins = jstretch.stretch_pins_consistent(ny, nx, *args, np_dtype)
    for (r0, r1), pin in zip(((0, 2), (1, 4), (3, 5)), pins[:3]):
        rows_equal(xw[r0], pin[0]), rows_equal(xw[r1], pin[1])
    for (r0, r1), pin in zip(((0, 2), (1, 4), (3, 5)), pins[3:6]):
        cols_equal(yw[r0], pin[0]), cols_equal(yw[r1], pin[1])
    cols_equal(yw[6], pins[6][0]), rows_equal(xw[6], pins[6][1])

    gx, gy = stretch.stretch_pins_grad(g.dx, g.dy, np_dtype)
    (gxm_p, gxc_gyc, gym_p) = jstretch.stretch_pins_grad(ny, nx, g.dx, g.dy,
                                                         np_dtype)
    rows_equal(gx[0], gxm_p[0]), rows_equal(gx[2], gxm_p[1])
    rows_equal(gx[1], gxc_gyc[0]), cols_equal(gy[1], gxc_gyc[1])
    cols_equal(gy[0], gym_p[0]), cols_equal(gy[2], gym_p[1])
    np.testing.assert_array_equal(gx, xw[:3])
    np.testing.assert_array_equal(gy, yw[:3])

    for scheme in ("parity", "consistent"):
        xrows, yplanes = jstretch.stretch_inputs_2d(ny, nx, *args, scheme,
                                                    np_dtype)
        mk = (stretch.stretch_pins_consistent if scheme == "consistent"
              else stretch.stretch_pins)
        xw, yw = mk(*args, np_dtype)
        np.testing.assert_array_equal(xrows[:len(xw)], xw)
        for r, plane in enumerate(yplanes):
            cols_equal(yw[r], plane)


def test_spacing_ok_matches_reference():
    g, _ = _xy_grids()
    assert stretch.stretch_spacing_ok(g.dx, g.dy) is True
    bad = g.dx.copy()
    bad[3] = 1e-12
    assert stretch.stretch_spacing_ok(bad, g.dy) == \
        jstretch.stretch_spacing_ok(bad, g.dy) is False


@pytest.mark.parametrize("scheme", [None, "parity", "consistent"])
def test_launch_counters_by_scheme(scheme):
    """`native.count_launch` ticks one counter, the one of its spacing
    scheme (uniform grids on ``launches``); `native.reset_counts` zeroes
    all three."""
    from cfd_tpu_torch.ops.kernels import native

    def wrapper():
        pass

    native.reset_counts(wrapper)
    native.count_launch(wrapper, scheme)
    native.count_launch(wrapper, scheme)
    names = {None: "launches", "parity": "parity_launches",
             "consistent": "consistent_launches"}
    assert {n: getattr(wrapper, n) for n in names.values()} == {
        n: 2 if k == scheme else 0 for k, n in names.items()}
    native.reset_counts(wrapper)
    assert wrapper.launches == wrapper.parity_launches == 0
    assert wrapper.consistent_launches == 0
