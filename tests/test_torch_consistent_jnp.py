"""The consistent scheme's projection steps against the reference's jnp
step (`projection.py:719-812`), on grids its kernels' gates reject:
24×20×10 and 24×20×3 stretched (β = 1.5), 3D and 2D, float64 within 1e-9
over two steps — FFT_DIRECT (the eigenbasis pieces through the port's
kernels' plain versions), CG and BiCGSTAB (converged to 1e-12, where both
loops sit on the solution), buoyancy with the energy equation, and the
``bc_refresh`` hook, which the port keeps on its kernels where the
reference falls back to jnp (`projection.py:484`).  The 2D consistent
step, jnp-only in the reference, also in float32 within 5e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_tpu import FlowField as JField
from cfd_tpu import Grid as JGrid
from cfd_tpu.boundary.types import BCType as JB
from cfd_tpu.boundary.types import ThermalBCConfig as JT
from cfd_tpu.solvers.ns import NSParams as JParams
from cfd_tpu.solvers.ns.projection import make_projection_step as j_step
from cfd_tpu.solvers.poisson.base import Method as JMethod
from cfd_tpu.solvers.poisson.base import PoissonParams as JPoisson
from cfd_tpu_torch import CFDError, Status
from cfd_tpu_torch.interop import field_from_numpy, grid_from
from cfd_tpu_torch.solvers.ns.params import NSParams
from cfd_tpu_torch.solvers.ns.projection import make_projection_step
from cfd_tpu_torch.solvers.poisson.base import Method, PoissonParams
from tests.test_torch_bc_refresh import j_lid, t_lid

torch.set_num_threads(min(2, torch.get_num_threads()))

NAMES = ("u", "v", "w", "p", "T")
DIAGS = ("max_velocity", "max_pressure", "max_temperature")
TIGHT = dict(tolerance=1e-12, max_iterations=2000)


def _run(shape, method, np_dt=np.float64, sources=True, jkw=None,
         hooks=None, steps=2, tight=False, seed=0, zero_p=False):
    nz, ny, nx = shape
    kw = dict(zmin=0.0, zmax=1.0) if nz > 1 else {}
    jg = JGrid.stretched(nx, ny, nz, beta=1.5, stretch_axes="xy", **kw)
    pk = dict(nonuniform_scheme="consistent",
              source_amplitude_u=0.1 if sources else 0.0,
              source_amplitude_v=0.05 if sources else 0.0, **(jkw or {}))
    jparams = JParams(**pk)
    rng = np.random.default_rng(seed)
    arrays = {n: rng.normal(0.0, 0.1, shape).astype(np_dt) for n in "uvwp"}
    arrays["rho"] = np.ones(shape, np_dt)
    arrays["T"] = (300.0 + rng.normal(0.0, 1.0, shape)).astype(np_dt)
    if zero_p:
        arrays["p"][:] = 0.0
    jdt = jnp.float64 if np_dt == np.float64 else jnp.float32
    tdt = torch.float64 if np_dt == np.float64 else torch.float32
    j_hook, t_hook = hooks or (None, None)
    jstep = jax.jit(j_step(jg, jparams, dtype=jdt,
                           poisson_method=JMethod[method.name],
                           use_pallas=False, bc_refresh=j_hook,
                           poisson_params=JPoisson(**TIGHT) if tight
                           else None))
    tstep = make_projection_step(grid_from(jg),
                                 NSParams.from_fields(jparams), dtype=tdt,
                                 poisson_method=method, device="cpu",
                                 bc_refresh=t_hook,
                                 poisson_params=PoissonParams(**TIGHT)
                                 if tight else None)
    jf = JField(**{n: jnp.asarray(a) for n, a in arrays.items()})
    tf = field_from_numpy(arrays, "cpu", tdt)
    for i in range(steps):
        jf, jr = jstep(jf, 0.001, i)
        tf, tr = tstep(tf, 0.001, i)
        assert int(jr.status) == int(tr.status) == 0
    return jf, jr, tf, tr


def _assert(out, atol, rtol_diag):
    jf, jr, tf, tr = out
    for n in NAMES:
        ref = np.array(getattr(jf, n))
        np.testing.assert_allclose(getattr(tf, n).numpy(), ref, rtol=0,
                                   atol=atol * max(1.0, np.abs(ref).max()),
                                   err_msg=n)
    for d in DIAGS:
        np.testing.assert_allclose(float(getattr(tr, d)),
                                   float(getattr(jr, d)), rtol=rtol_diag,
                                   err_msg=d)


THERMAL = dict(alpha=1e-3, beta=3e-3, T_ref=300.0,
               gravity=(0.0, -9.81, 0.5),
               thermal_bc=JT(left=JB.DIRICHLET, right=JB.NEUMANN,
                             bottom=JB.NEUMANN, top=JB.DIRICHLET,
                             back=JB.NEUMANN, front=JB.NEUMANN))
CASES = {
    "fft_3d": ((10, 20, 24), Method.FFT_DIRECT, {}),
    "fft_3d_no_sources": ((10, 20, 24), Method.FFT_DIRECT,
                          dict(sources=False)),
    # one step from p = 0: at nz = 3 the reference's jnp solve takes the
    # z face term once where its kernels take it twice (see
    # test_nz3_face_term_is_the_kernels'), which p = 0 leaves out
    "fft_nz3": ((3, 20, 24), Method.FFT_DIRECT,
                dict(zero_p=True, steps=1)),
    "fft_3d_buoyant_energy": ((10, 20, 24), Method.FFT_DIRECT,
                              dict(jkw=THERMAL)),
    "fft_3d_bc_refresh": ((10, 20, 24), Method.FFT_DIRECT,
                          dict(hooks=(j_lid, t_lid))),
    "cg_3d": ((10, 20, 24), Method.CG, dict(tight=True)),
    "bicgstab_3d": ((10, 20, 24), Method.BICGSTAB, dict(tight=True)),
    "cg_3d_bc_refresh": ((10, 20, 24), Method.CG,
                         dict(tight=True, hooks=(j_lid, t_lid))),
    "fft_2d": ((1, 20, 24), Method.FFT_DIRECT, {}),
    "fft_2d_buoyant_energy": ((1, 20, 24), Method.FFT_DIRECT,
                              dict(jkw=THERMAL)),
    "fft_2d_bc_refresh": ((1, 20, 24), Method.FFT_DIRECT,
                          dict(hooks=(j_lid, t_lid))),
    "cg_2d": ((1, 20, 24), Method.CG, dict(tight=True)),
    "bicgstab_2d": ((1, 20, 24), Method.BICGSTAB, dict(tight=True)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_consistent_step_matches_jnp_step_f64(case):
    shape, method, kw = CASES[case]
    _assert(_run(shape, method, **kw), 1e-9, 1e-9)


def test_2d_consistent_step_matches_jnp_step_f32():
    """The 2D consistent kernels (`projection2d.py`'s ``*_2d_cons``) and
    the eigenbasis direct solve in float32 against the reference's jnp
    float32 step, 128×32, within 5e-5."""
    _assert(_run((1, 32, 128), Method.FFT_DIRECT, np.float32, seed=2),
            5e-5, 1e-5)


@pytest.mark.parametrize("method", [Method.REDBLACK_SOR, Method.JACOBI,
                                    Method.MULTIGRID])
def test_other_methods_raise_as_the_reference(method):
    """The consistent scheme solves only by FFT_DIRECT, CG or BiCGSTAB;
    the others raise ERROR_UNSUPPORTED with the reference's message
    (`projection.py:249-253`), as the reference does."""
    jg = JGrid.stretched(24, 20, 10, zmin=0.0, zmax=1.0, beta=1.5,
                         stretch_axes="xy")
    with pytest.raises(CFDError) as err:
        make_projection_step(grid_from(jg),
                             NSParams(nonuniform_scheme="consistent"),
                             torch.float64, method, device="cpu")
    assert err.value.status == Status.ERROR_UNSUPPORTED
    from cfd_tpu.core.status import CFDError as JError
    with pytest.raises(JError) as jerr:
        j_step(jg, JParams(nonuniform_scheme="consistent"), jnp.float64,
               JMethod[method.name], use_pallas=False)
    assert str(err.value).split(": ", 1)[-1] in str(jerr.value)


def test_nz3_face_term_is_the_kernels():
    """At nz = 3 both z-shells of the one interior plane mirror it, so b̃
    takes 2/dz² there: the reference's consistent kernel
    (`projection_kernels.py:674-677`, (k == 1) + (k == nz − 2)) and its
    uniform spectral solve do; its jnp nonuniform direct solve writes the
    coefficient once (`nonuniform.py:331-333`, fzc[1] = fzc[nz−2] = w).
    The port's step follows the kernels (held against the fused step in
    `test_torch_consistent_steps.py`), its ``make_nonuniform_direct`` the
    jnp solve; from p ≠ 0 the two steps differ."""
    from cfd_tpu_torch.ops.kernels import projection_kernels as pkm
    c = pkm.stencil_consts(3, 20, 24, 0.1, 0.1, 0.5, 0.0, 0.0, 0.01, False,
                           weights=(torch.zeros(7, 24), torch.zeros(7, 20)),
                           face=(0.0, 0.0, 0.0, 0.0))
    coeff = pkm.face_coeff(c, torch.float64, "cpu")
    assert float(coeff[1, 5, 5]) == 2.0 / 0.25
    jf, _, tf, _ = _run((3, 20, 24), Method.FFT_DIRECT, steps=1)
    assert np.abs(tf.p.numpy() - np.array(jf.p)).max() > 1e-6


@pytest.mark.parametrize("solver_type", ["projection", "explicit_euler",
                                         "rk2"])
def test_simulation_from_stretched_grid_matches_reference(solver_type):
    """``Simulation.from_grid`` with a stretched grid and the consistent
    scheme, the reference's documented use (`api/simulation.py:70-80`):
    it initializes and steps, and three steps match the reference's
    session in float64 (its projection solver is CG at 1e-6, so the
    fields are held at 1e-7 there, 1e-12 for the explicit ones)."""
    from cfd_tpu.api import Simulation as JSimulation
    from cfd_tpu_torch.api import Simulation

    jg = JGrid.stretched(32, 24, beta=1.5, stretch_axes="xy")
    kw = dict(dt=0.001, cfl=0.2, mu=0.01, max_iter=1,
              nonuniform_scheme="consistent")
    jsim = JSimulation.from_grid(jg, solver_type, JParams(**kw))
    sim = Simulation.from_grid(grid_from(jg), solver_type, NSParams(**kw),
                               device="cpu", dtype=torch.float64)
    for _ in range(3):
        assert int(sim.step()) == int(jsim.step()) == 0
    tol = 1e-7 if solver_type == "projection" else 1e-12
    for n in ("u", "v", "p"):
        ref = np.array(getattr(jsim.field, n))
        np.testing.assert_allclose(getattr(sim.field, n).numpy(), ref,
                                   rtol=0, atol=tol * np.abs(ref).max(),
                                   err_msg=n)
