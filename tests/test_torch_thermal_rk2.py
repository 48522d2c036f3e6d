"""The RK2 step with the energy equation, Boussinesq buoyancy and
mixed thermal faces against the reference's fused step (interpret mode,
float32, 128×16×8 and 128×32), two steps, at the reference's fused bars
(the helpers and the float64 comparisons are in
`test_torch_thermal_explicit.py`)."""

import pytest
import torch

from tests.test_torch_thermal_explicit import check_fused

torch.set_num_threads(min(2, torch.get_num_threads()))


@pytest.mark.parametrize("dim", ["3d", "2d"])
def test_matches_fused_reference_f32(dim):
    check_fused("rk2", dim)
