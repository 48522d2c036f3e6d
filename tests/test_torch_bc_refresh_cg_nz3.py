"""The 3D projection step with ``bc_refresh`` against the reference's,
the CG step and the nz = 3 spectral step: 128×16×8 and 128×16×3 with the
time-dependent lid hook in float32 against the reference's fused step
(interpret mode) after two steps, 2e-5; 24×20×10 and 24×20×3 in float64
against its jnp step (the helpers of `test_torch_bc_refresh.py`)."""

import pytest
import torch

from cfd_tpu_torch.solvers.poisson.base import Method
from tests.test_torch_bc_refresh import check_fused, check_jnp

torch.set_num_threads(min(2, torch.get_num_threads()))


@pytest.mark.parametrize("case", ["cg", "fft_nz3"])
def test_matches_fused_reference_f32(case):
    check_fused(case)


@pytest.mark.parametrize("shape,method", [
    ((10, 20, 24), Method.CG), ((3, 20, 24), Method.FFT_DIRECT)],
    ids=["cg", "fft_nz3"])
def test_matches_jnp_reference_f64(shape, method):
    check_jnp(shape, method)
