"""The consistent scheme's z-decomposed spectral projection step
(`cfd_tpu_torch.parallel.fused` on a stretched grid with
``nonuniform_scheme="consistent"``, FFT_DIRECT) on four `LocalComm` CPU
z-shards, at the reference's grid (128×64×16, tanh β = 1.5 in x and y,
`tests/parallel/test_fused_sharded.py:1643-1649`).

* one float32 step against the reference's single-device jnp consistent
  step (``use_pallas=False``), at the reference's bars (`:1674-1698`):
  u, v, w within 5e-5, p within 5e-4;
* three buoyant and energy steps with Dirichlet sides (`:1701-1737`):
  u, v, w, T within 3e-4, p within 3e-3 — the energy post-step on the
  shards must take the consistent x/y stencils here;
* float64 against the port's single-device plain consistent step within
  1e-10 (the same arithmetic: the sharded step is that step's on every
  point);
* HIGH against HIGHEST at the HIGH bars (2e-3 of max(1, max|p|) on p,
  1e-4 on u, v, w plus what Δp passes on through the corrector);
* the selection (`:1655`): the eigenbasis pieces are built for the
  consistent scheme, the sine pieces for the parity scheme;
* the refusals (`:1740-1758`), ``CFDError(ERROR_UNSUPPORTED)`` with the
  reference's words, and the shards' consistent energy post-step on a
  (z, y) communicator.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_tpu import FlowField as JField
from cfd_tpu import Grid as JGrid
from cfd_tpu.boundary.types import BCType as JB
from cfd_tpu.boundary.types import DirichletValues as JDV
from cfd_tpu.boundary.types import ThermalBCConfig as JT
from cfd_tpu.solvers.ns import NSParams as JParams
from cfd_tpu.solvers.ns.projection import \
    make_projection_step as j_make_projection_step
from cfd_tpu.solvers.poisson.base import Method as JMethod
from cfd_tpu_torch import Grid, Status
from cfd_tpu_torch.core.status import CFDError
from cfd_tpu_torch.interop import field_from_numpy, grid_from
from cfd_tpu_torch.parallel import fused as fused_mod
from cfd_tpu_torch.parallel import (gather_field, make_mesh,
                                    make_sharded_step,
                                    make_sharded_thermal_post)
from cfd_tpu_torch.parallel.fused import (fused_sharded_unsupported_reason,
                                          make_fused_sharded_projection_step)
from cfd_tpu_torch.solvers.ns.params import NSParams
from cfd_tpu_torch.solvers.ns.projection import make_projection_step
from cfd_tpu_torch.solvers.poisson.base import Method
from cfd_tpu_torch.solvers.poisson.nonuniform import (
    NonuniformPoissonProblem, make_nonuniform_fused_sharded_pieces,
    nonuniform_fused_sharded_supported)
from cfd_tpu_torch.solvers.poisson.spectral import \
    make_dst_fused_sharded_pieces

torch.set_num_threads(min(2, torch.get_num_threads()))

CPU = torch.device("cpu")
P = 4
SIDES = JT(left=JB.DIRICHLET, right=JB.DIRICHLET, bottom=JB.NEUMANN,
           top=JB.NEUMANN, dirichlet_values=JDV(left=305.0, right=295.0))
BUOYANT = dict(source_amplitude_u=0.0, source_amplitude_v=0.0, alpha=1e-3,
               beta=0.05, T_ref=300.0, gravity=(0.0, -9.81, 0.05),
               thermal_bc=SIDES)
# the HIGH bars of the single-device steps (chip_smoke.py HIGH_P, HIGH_U;
# tests/math/test_mega_kernels.py:134-137)
HIGH_P, HIGH_U = 2e-3, 1e-4


def _jgrid():
    return JGrid.stretched(128, 64, 16, zmin=0.0, zmax=1.0, beta=1.5,
                           stretch_axes="xy")


def _zmesh():
    return make_mesh([CPU] * P, axes=("z",))


def _arrays(shape, seed, t_seed=None, dtype=np.float32, amp=0.1):
    """The reference's ``_random_field`` (u, v, w, p normal, ρ = 1), T =
    300, or 300 + N(0, 1) from ``t_seed``."""
    rng = np.random.default_rng(seed)
    out = {n: rng.normal(0, amp, shape).astype(dtype) for n in "uvwp"}
    out["rho"] = np.ones(shape, dtype)
    out["T"] = (np.full(shape, 300.0, dtype) if t_seed is None else
                np.random.default_rng(t_seed).normal(300.0, 1.0, shape)
                .astype(dtype))
    return out


def _reference(jgrid, jparams, arrays, n_steps):
    jstep = jax.jit(j_make_projection_step(
        jgrid, jparams, dtype=jnp.float32, use_pallas=False,
        poisson_method=JMethod.FFT_DIRECT))
    jf = JField(**{n: jnp.asarray(a) for n, a in arrays.items()})
    for i in range(n_steps):
        jf, jres = jstep(jf, 0.001, i)
    assert int(jres.status) == 0
    return jf


def _sharded(grid, params, arrays, n_steps, dtype=torch.float32, **kw):
    step, place = make_sharded_step(grid, params, _zmesh(), "projection",
                                    dtype=dtype, **kw)
    fs = place(field_from_numpy(arrays, "cpu", dtype))
    for i in range(n_steps):
        fs, res = step(fs, 1e-3, i)
    assert int(res.status) == 0
    return gather_field(fs), res


def _held(got, jf, bars):
    for n, bar in bars.items():
        np.testing.assert_allclose(getattr(got, n).numpy(),
                                   np.asarray(getattr(jf, n)), rtol=0,
                                   atol=bar, err_msg=n)


def test_consistent_sharded_matches_reference_jnp():
    jgrid = _jgrid()
    jparams = JParams(nonuniform_scheme="consistent")
    arrays = _arrays(jgrid.shape, 41)
    got, _ = _sharded(grid_from(jgrid), NSParams.from_fields(jparams),
                      arrays, 1)
    _held(got, _reference(jgrid, jparams, arrays, 1),
          {"u": 5e-5, "v": 5e-5, "w": 5e-5, "p": 5e-4})


def test_consistent_sharded_buoyant_energy_matches_reference_jnp():
    """Three buoyant steps with the energy equation: T needs the
    consistent x/y stencils in the shards' energy post-step."""
    jgrid = _jgrid()
    jparams = JParams(nonuniform_scheme="consistent", **BUOYANT)
    arrays = _arrays(jgrid.shape, 43, t_seed=47)
    got, res = _sharded(grid_from(jgrid), NSParams.from_fields(jparams),
                        arrays, 3)
    assert torch.equal(res.max_temperature, torch.amax(got.T))
    _held(got, _reference(jgrid, jparams, arrays, 3),
          {"u": 3e-4, "v": 3e-4, "w": 3e-4, "T": 3e-4, "p": 3e-3})


@pytest.mark.parametrize("buoyant", [False, True], ids=["plain", "energy"])
def test_consistent_sharded_float64_is_the_single_device_step(buoyant):
    jgrid = _jgrid()
    grid = grid_from(jgrid)
    params = NSParams.from_fields(JParams(
        nonuniform_scheme="consistent", **(BUOYANT if buoyant else {})))
    arrays = _arrays(jgrid.shape, 5, t_seed=6 if buoyant else None,
                     dtype=np.float64)
    got, res = _sharded(grid, params, arrays, 2, torch.float64)
    single = make_projection_step(grid, params, torch.float64,
                                  Method.FFT_DIRECT, device="cpu")
    f = field_from_numpy(arrays, "cpu", torch.float64)
    for i in range(2):
        f, res1 = single(f, 1e-3, i)
    for n in ("u", "v", "w", "p", "T"):
        assert float((getattr(got, n) - getattr(f, n)).abs().max()) \
            <= 1e-10, n
    for a in ("max_velocity", "max_pressure", "max_temperature"):
        assert abs(float(getattr(res, a)) - float(getattr(res1, a))) \
            <= 1e-10, a


def test_consistent_sharded_high_within_the_high_bars():
    jgrid = _jgrid()
    grid = grid_from(jgrid)
    params = NSParams(nonuniform_scheme="consistent")
    arrays = _arrays(jgrid.shape, 7)
    hi, _ = _sharded(grid, params, arrays, 1, spectral_precision="high")
    ref, _ = _sharded(grid, params, arrays, 1)
    dp = float((hi.p - ref.p).abs().max())
    assert dp <= HIGH_P * max(1.0, float(ref.p.abs().max()))
    assert dp > 0.0                 # the 3xTF32 products ran
    # u, v, w: the HIGH bar plus dt·Δp over the smallest spacing
    passed = 1e-3 * dp / min(float(np.min(grid.dx)), float(np.min(grid.dy)),
                             grid.dz0)
    for n in "uvw":
        bar = HIGH_U * max(1.0, float(getattr(ref, n).abs().max())) + passed
        assert float((getattr(hi, n) - getattr(ref, n)).abs().max()) <= bar


@pytest.mark.parametrize("scheme", ["consistent", "parity"])
def test_consistent_sharded_selected(monkeypatch, scheme):
    """The eigenbasis pieces are built once for the consistent scheme on a
    z mesh; the parity scheme keeps the sine pieces (`:1655-1671`)."""
    calls = []
    for name in ("make_nonuniform_fused_sharded_pieces",
                 "make_dst_fused_sharded_pieces"):
        orig = getattr(fused_mod, name)

        def spy(*a, _name=name, _orig=orig, **k):
            calls.append(_name)
            return _orig(*a, **k)

        monkeypatch.setattr(fused_mod, name, spy)
    make_fused_sharded_projection_step(grid_from(_jgrid()),
                                       NSParams(nonuniform_scheme=scheme),
                                       _zmesh())
    assert calls == [("make_nonuniform_fused_sharded_pieces"
                      if scheme == "consistent"
                      else "make_dst_fused_sharded_pieces")]


def test_consistent_sharded_pieces_gate():
    """The eigenbasis pieces' gate (`nonuniform.py:262-268`) is the sine
    pieces' one, and both makers refuse outside it with
    ``ERROR_UNSUPPORTED``: 16 planes take 4 and 8 shards (two planes a
    shard), not 16; ny = 64 does not split over 3."""
    prob = NonuniformPoissonProblem.from_grid(_stretched())
    assert nonuniform_fused_sharded_supported(prob, 4)
    assert nonuniform_fused_sharded_supported(prob, 8)
    assert not nonuniform_fused_sharded_supported(prob, 16)
    assert not nonuniform_fused_sharded_supported(
        NonuniformPoissonProblem.from_grid(_stretched(nz=15)), 3)
    for maker in (make_nonuniform_fused_sharded_pieces,
                  make_dst_fused_sharded_pieces):
        with pytest.raises(CFDError, match="16 shards") as err:
            maker(prob, 16, make_mesh([CPU] * 16, axes=("z",)).comm)
        assert err.value.status == Status.ERROR_UNSUPPORTED


def _cons():
    return NSParams(nonuniform_scheme="consistent")


def _stretched(nx=128, ny=64, nz=16):
    if nz == 1:
        return Grid.stretched(nx, ny, beta=1.5, stretch_axes="xy")
    return Grid.stretched(nx, ny, nz, zmin=0.0, zmax=1.0, beta=1.5,
                          stretch_axes="xy")


@pytest.mark.parametrize("method", [Method.CG, Method.BICGSTAB,
                                    Method.MULTIGRID])
def test_consistent_sharded_krylov_refused(method):
    """The builder refuses every solve but FFT_DIRECT on the consistent
    scheme (`fused.py:414-417`); through `make_sharded_step` the
    multigrid step refuses it on a coarsenable grid with the
    single-device step's words (`projection.py:249-253`)."""
    with pytest.raises(CFDError, match="FFT_DIRECT") as err:
        make_fused_sharded_projection_step(_stretched(), _cons(), _zmesh(),
                                           poisson_method=method)
    assert err.value.status == Status.ERROR_UNSUPPORTED
    grid = (_stretched(17, 17, 17) if method == Method.MULTIGRID
            else _stretched())
    with pytest.raises(CFDError, match="FFT_DIRECT") as err:
        make_sharded_step(grid, _cons(), _zmesh(), "projection",
                          poisson_method=method)
    assert err.value.status == Status.ERROR_UNSUPPORTED


REFUSALS = {
    "zy mesh": (lambda: (_stretched(), make_mesh([CPU] * 4)),
                "consistent-scheme fused sharded projection needs a "
                "z-only mesh"),
    "2d": (lambda: (_stretched(nz=1), make_mesh([CPU] * 4, axes=("y",))),
           "no fused sharded 2D consistent-scheme projection (the 2D "
           "marching kernels are uniform-only)"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_consistent_sharded_unsupported_reasons(case):
    build, reason = REFUSALS[case]
    grid, mesh = build()
    assert fused_sharded_unsupported_reason(grid, _cons(), mesh) == reason
    with pytest.raises(CFDError) as err:
        make_sharded_step(grid, _cons(), mesh, "projection")
    assert err.value.status == Status.ERROR_UNSUPPORTED
    assert reason in str(err.value)
    # the z-only mesh takes it
    assert fused_sharded_unsupported_reason(_stretched(), _cons(),
                                            _zmesh()) is None


def test_consistent_energy_post_step_needs_whole_rows():
    """The shards' consistent energy stencils read the single-device
    weight rows, so y must be whole: on a (z, y) communicator the
    post-step refuses rather than read another shard's rows."""
    params = NSParams(nonuniform_scheme="consistent", alpha=1e-3)
    with pytest.raises(CFDError, match="whole y rows") as err:
        make_sharded_thermal_post(_stretched(), params,
                                  make_mesh([CPU] * 4).comm, torch.float32)
    assert err.value.status == Status.ERROR_UNSUPPORTED
    assert make_sharded_thermal_post(_stretched(), params, _zmesh().comm,
                                     torch.float32) is not None
