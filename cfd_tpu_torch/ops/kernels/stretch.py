"""Per-axis spacing weights for the kernels on stretched grids (counterpart
of `cfd_tpu/ops/pallas/stretch.py`).

The reference hands its Pallas kernels the per-point stretched-grid
coefficients as (2, ny, nx) planes pinned in VMEM, because a Pallas kernel
cannot capture array constants (`stretch.py:1-25`).  The coefficients
depend on x alone or on y alone, so here they are per-axis vectors: an
x-weight array of shape (rows, nx) and a y-weight array of shape
(rows, ny).  A thread at (j, i) reads column i of the x rows (a warp's
reads are coalesced) and column j of the y rows (one broadcast per warp),
and both stay in L1 for the whole z-march.  The values are those of the
reference's planes: float64 numpy, cast once to the field's dtype.

Row layouts:

* parity (:func:`stretch_pins`, the reference's ``stretch_pins`` and the
  parity ``stretch_inputs_2d``): ``[1/(2h), 1/h², src]`` with h the forward
  spacing padded by its last entry;
* consistent (:func:`stretch_pins_consistent`, ``stretch_pins_consistent``
  and the consistent ``stretch_inputs_2d``): ``[wm, wc, wp, lm, lc, lp,
  src]``, the exact 3-point nonuniform first- and second-derivative
  weights (`solvers.ns.common.consistent_triples`);
* the consistent corrector's gradient (:func:`stretch_pins_grad`,
  ``stretch_pins_grad``): ``[wm, wc, wp]``, the first three rows above;

with src = sin(2πx_i) on the x array and sin(πy_j) on the y array, the
default source basis at the true coordinates.
The plain versions apply these rows with `ops.stencils.weighted` and its
interior forms.
"""

from __future__ import annotations

import numpy as np


def _padded(spacing):
    """Entry i = forward spacing i → i+1, the last entry repeated."""
    spacing = np.asarray(spacing, np.float64)
    return np.concatenate([spacing, spacing[-1:]])


def stretch_spacing_ok(dx_arr, dy_arr) -> bool:
    """Every |spacing| above the 1e-10 validity guard (host-side twin of
    the per-point guards)."""
    return (float(np.min(np.abs(dx_arr))) > 1e-10
            and float(np.min(np.abs(dy_arr))) > 1e-10)


def triples(spacing):
    """(wm, wc, wp, lm, lc, lp): the exact 3-point nonuniform first- and
    second-derivative weights at each point, float64 (the reference's
    `stretch._triples` / `common.consistent_triples`)."""
    h = np.asarray(spacing, np.float64)
    hm = np.concatenate([h[:1], h])
    hp = np.concatenate([h, h[-1:]])
    s = hm + hp
    return (-hp / (hm * s), (hp - hm) / (hm * hp), hm / (hp * s),
            2.0 / (hm * s), -2.0 / (hm * hp), 2.0 / (hp * s))


def _sources(x_coords, y_coords):
    return (np.sin(2.0 * np.pi * np.asarray(x_coords, np.float64)),
            np.sin(np.pi * np.asarray(y_coords, np.float64)))


def _rows(rows, np_dtype):
    return np.ascontiguousarray(np.stack(rows).astype(np_dtype))


def stretch_pins(dx_arr, dy_arr, x_coords, y_coords, np_dtype=np.float32):
    """Parity weights: x rows ``[1/(2dx_i), 1/dx_i², sin(2πx_i)]`` (3, nx)
    and y rows ``[1/(2dy_j), 1/dy_j², sin(πy_j)]`` (3, ny)."""
    dx, dy = _padded(dx_arr), _padded(dy_arr)
    sx2, sy = _sources(x_coords, y_coords)
    return (_rows([1.0 / (2.0 * dx), 1.0 / (dx * dx), sx2], np_dtype),
            _rows([1.0 / (2.0 * dy), 1.0 / (dy * dy), sy], np_dtype))


def stretch_pins_consistent(dx_arr, dy_arr, x_coords, y_coords,
                            np_dtype=np.float32):
    """Consistent weights: x rows ``[wxm, wxc, wxp, lxm, lxc, lxp,
    sin(2πx)]`` (7, nx) and y rows ``[wym, wyc, wyp, lym, lyc, lyp,
    sin(πy)]`` (7, ny)."""
    sx2, sy = _sources(x_coords, y_coords)
    return (_rows([*triples(dx_arr), sx2], np_dtype),
            _rows([*triples(dy_arr), sy], np_dtype))


def stretch_pins_grad(dx_arr, dy_arr, np_dtype=np.float32):
    """The consistent gradient's weights: x rows ``[wxm, wxc, wxp]``
    (3, nx) and y rows ``[wym, wyc, wyp]`` (3, ny)."""
    return (_rows(triples(dx_arr)[:3], np_dtype),
            _rows(triples(dy_arr)[:3], np_dtype))

