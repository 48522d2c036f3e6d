"""The explicit steps on a stretched 2D grid (128×32, β = 1.5 in x and y)
against the reference's fused interpret kernels, float32, at its bars
(`tests/math/test_stretched2d_fused.py`): Euler within 2e-5, RK within
5e-5, over several steps at dt = 5e-5 — the consistent scheme with
sources and with the energy equation, the parity scheme with buoyancy."""

import pytest
import torch

from tests.test_torch_stretched_explicit import (SOURCES, THERMAL,
                                                 assert_fields, run_both)

torch.set_num_threads(min(2, torch.get_num_threads()))

SHAPE = (1, 32, 128)
BUOY = dict(beta=3e-3, T_ref=300.0, gravity=(0.0, -9.81, 0.0))
CASES = {
    "euler_consistent": ("euler", "consistent", SOURCES, 3, 2e-5),
    "euler_parity_buoyant": ("euler", "parity", dict(SOURCES, **BUOY), 3,
                             2e-5),
    "rk2_consistent_energy": ("rk2", "consistent",
                              dict(SOURCES, **THERMAL), 2, 5e-5),
    "rk4_parity": ("rk4", "parity", SOURCES, 2, 5e-5),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_2d_stretched_step_matches_fused_reference(case):
    method, scheme, extra, steps, atol = CASES[case]
    out = run_both(method, SHAPE, scheme, extra, steps=steps, dt=5e-5,
                   seed=4)
    assert_fields(out, atol)
