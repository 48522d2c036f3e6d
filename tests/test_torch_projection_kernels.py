"""The port's two mega kernels (plain versions, as the wrappers run them on
CPU tensors) against the reference's Pallas kernels in interpret mode, at
the reference's own tier-1 kernel shape 128×16×8, float32.

A1 ``predictor_poisson_input`` is compared on all five outputs, A2
``corrector_bwd_diag`` on the four fields and three maxima.  Both packages
get the same numpy inputs from ``np.random.default_rng``; the reference's
kernels run once per module (they take seconds in interpret mode).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_tpu import Grid as JGrid
from cfd_tpu.ops.pallas.projection_kernels import \
    ProjectionKernels as JKernels
from cfd_tpu.solvers.poisson.base import PoissonProblem as JProblem
from cfd_tpu.solvers.poisson.spectral import \
    make_dst_fused_pieces as j_pieces
from cfd_tpu_torch import Grid
from cfd_tpu_torch.ops.kernels.projection_kernels import ProjectionKernels
from cfd_tpu_torch.solvers.poisson.base import PoissonProblem
from cfd_tpu_torch.solvers.poisson.spectral import make_dst_fused_pieces

torch.set_num_threads(min(2, torch.get_num_threads()))

SHAPE = (8, 16, 128)
DT, NU, SU, SV, RHO = 0.001, 0.01, 0.1, 0.05, 1.0


def _f32(x):
    return torch.tensor(np.array(x), dtype=torch.float32)


@pytest.fixture(scope="module")
def case():
    nz, ny, nx = SHAPE
    rng = np.random.default_rng(11)
    fields = [rng.normal(0.0, 0.1, SHAPE).astype(np.float32)
              for _ in range(4)]

    jg = JGrid.uniform(nx, ny, nz, zmin=0.0, zmax=1.0)
    mats, tfwd, _ = j_pieces(JProblem(nx, ny, nz, jg.dx0, jg.dy0, jg.dz0),
                             jnp.float32, use_kernel=False, fuse_fwd=True)
    jk = JKernels(nz, ny, nx, jg.dx0, jg.dy0, jg.dz0, jg.xmin, jg.ymin,
                  jnp.float32, interpret=True, dst_mats=mats,
                  tdma_fwd=tfwd)
    f32 = jnp.float32
    a1 = jk.predictor_poisson_input(*map(jnp.asarray, fields), f32(DT), NU,
                                    f32(SU), f32(SV), f32(RHO / DT))
    a2 = jk.corrector_bwd_diag(*a1, f32(DT / RHO))

    g = Grid.uniform(nx, ny, nz, zmin=0.0, zmax=1.0)
    tm, tt = make_dst_fused_pieces(
        PoissonProblem(nx, ny, nz, g.dx0, g.dy0, g.dz0), torch.float32)
    pk = ProjectionKernels(nz, ny, nx, g.dx0, g.dy0, g.dz0, g.xmin, g.ymin,
                           NU, tm, tt)

    def s(v):
        return torch.tensor(v, dtype=torch.float32)

    p1 = pk.predictor_poisson_input(*map(_f32, fields), s(DT), s(SU), s(SV),
                                    s(RHO) / s(DT))
    # A2 gets the reference's A1 outputs, so it is judged on its own
    p2 = pk.corrector_bwd_diag(*map(_f32, a1), s(DT) / s(RHO))
    return {"a1": [np.array(x) for x in a1], "p1": [x.numpy() for x in p1],
            "a2": [np.array(x) for x in a2], "p2": [x.numpy() for x in p2]}


# Tolerances: u*, v*, w* and the corrected fields use the reference's own
# fused-vs-jnp bar, atol 2e-5 (tests/math/test_mega_kernels.py:57-60).
# d′ and p come out of fp32 DST products whose summation order differs
# between XLA's dot and torch's matmul, so they are bounded relative to
# their largest magnitude (2e-6 of max|ref|, a few ulps of a 128-term sum);
# t depends only on the host μ plane, so it agrees to 1 ulp (rtol 1e-6).
# The maxima use the reference's rtol 1e-6, except max p and max|p|, which
# inherit p's magnitude-relative bound.

@pytest.mark.parametrize("i,name", list(enumerate(
    ["u*", "v*", "w*", "d'", "t"])))
def test_predictor_poisson_input_matches_reference(case, i, name):
    got, ref = case["p1"][i], case["a1"][i]
    assert got.shape == ref.shape == SHAPE
    if name == "d'":
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=2e-6 * np.abs(ref).max())
    elif name == "t":
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)
    else:
        np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5)


@pytest.mark.parametrize("i,name", list(enumerate(
    ["u", "v", "w", "p", "max|u|^2", "max p", "max|p|"])))
def test_corrector_bwd_diag_matches_reference(case, i, name):
    got, ref = case["p2"][i], case["a2"][i]
    assert got.shape == ref.shape
    if name in ("p", "max p", "max|p|"):
        scale = np.abs(case["a2"][3]).max()
        np.testing.assert_allclose(got, ref, rtol=0, atol=2e-6 * scale)
    elif name == "max|u|^2":
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)
    else:
        np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5)


def test_wrappers_refuse_unknown_devices():
    """A wrapper runs its plain version only for a CPU tensor; any other
    non-CUDA device raises instead of falling back."""
    from cfd_tpu_torch.ops.kernels import projection_kernels as pkm
    from cfd_tpu_torch.ops.kernels import rolling, tdma

    m = torch.empty(SHAPE, device="meta")
    c = pkm.StencilConsts(*SHAPE, 0.1, 0.1, 0.1, 0.0, 0.0, NU)
    s = torch.empty((), device="meta")
    calls = [lambda: pkm.predictor_star(m, m, m, s, c),
             lambda: pkm.poisson_input(m, m, m, m, s, c),
             lambda: pkm.corrector(m, m, m, m, s, c),
             lambda: rolling.plane_dot(m, m[0], m[0]),
             lambda: tdma.tdma_z_fwd(m, m[0], 1.0),
             lambda: tdma.tdma_z_bwd(m, m)]
    for call in calls:
        with pytest.raises(ValueError):
            call()
