"""The explicit steps on stretched grids against the reference's jnp
steps in float64 within 1e-12 (relative to each field's scale), over two
steps (one for the 2D Euler step): Euler, RK2 and RK4, 3D (24×20×10) and 2D (24×20), parity and
consistent, with sources, with buoyancy, and the consistent scheme with
the energy equation; and parity + stretched + energy raising in both
packages (`tests/math/test_stretched_fused.py:119-127`)."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_tpu import Grid as JGrid
from cfd_tpu.core.status import CFDError as JError
from cfd_tpu.solvers.ns import NSParams as JParams
from cfd_tpu_torch import CFDError, Status
from cfd_tpu_torch.interop import grid_from
from cfd_tpu_torch.solvers.ns.params import NSParams
from tests.test_torch_stretched_explicit import (MAKERS, NAMES, SOURCES,
                                                 THERMAL, run_both)

torch.set_num_threads(min(2, torch.get_num_threads()))

SHAPES = {"3d": (10, 20, 24), "2d": (1, 20, 24)}
EXTRAS = {"sources": SOURCES,
          "buoyant": dict(SOURCES, beta=3e-3, T_ref=300.0,
                          gravity=(0.0, -9.81, 0.5))}
# both schemes with sources; buoyancy on the consistent scheme (the
# parity scheme's is held against the fused steps); the consistent
# scheme with the energy equation
CASES = [(m, d, s, "sources") for m, d, s in itertools.product(
    sorted(MAKERS), sorted(SHAPES), ("parity", "consistent"))] + [
    (m, d, "consistent", e) for m, d, e in itertools.product(
        sorted(MAKERS), sorted(SHAPES), ("buoyant", "thermal"))]


@pytest.mark.parametrize("method,dim,scheme,extra", CASES,
                         ids=["-".join(c) for c in CASES])
def test_stretched_step_matches_jnp_step_f64(method, dim, scheme, extra):
    extras = dict(EXTRAS, thermal=dict(SOURCES, **THERMAL))[extra]
    # the reference's jnp 2D Euler step wraps w's shells, where its fused
    # kernel and the port pass them through: one step there, w held on
    # the interior (a second step would carry the shells inward)
    w_shells = dim == "2d" and method == "euler"
    ref, got = run_both(method, SHAPES[dim], scheme, extras, np.float64,
                        fused=False, steps=1 if w_shells else 2, seed=1)
    for n in NAMES:
        r, g = ref[n], got[n]
        if n == "w" and w_shells:
            r, g = r[:, 1:-1, 1:-1], g[:, 1:-1, 1:-1]
        np.testing.assert_allclose(g, r, rtol=0,
                                   atol=1e-12 * max(1.0, np.abs(r).max()),
                                   err_msg=n)


@pytest.mark.parametrize("method", sorted(MAKERS))
@pytest.mark.parametrize("dim", sorted(SHAPES))
def test_parity_stretched_energy_raises_in_both(method, dim):
    nz, ny, nx = SHAPES[dim]
    kw = dict(zmin=0.0, zmax=1.0) if nz > 1 else {}
    jg = JGrid.stretched(nx, ny, nz, beta=1.5, stretch_axes="xy", **kw)
    jmk, tmk = MAKERS[method]
    with pytest.raises(CFDError) as err:
        tmk(grid_from(jg), NSParams(alpha=1e-3), torch.float64, "cpu")
    assert err.value.status == Status.ERROR_UNSUPPORTED
    with pytest.raises(JError):
        jmk(jg, JParams(alpha=1e-3), jnp.float64, use_pallas=False)
