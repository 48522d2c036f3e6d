"""``spectral_precision="default"`` (one TF32 pass a product) in
`cfd_tpu_torch`, against the reference's ``lax.Precision.DEFAULT`` on the
CPU.

The reference's DEFAULT products are XLA matmuls, full fp32 on the CPU;
the port's plain version rounds every operand to TF32 (10 mantissa bits,
``cvt.rna``), as its GEMM kernel does on the card.  So float32 results
differ from the reference's at TF32's rounding — bars measured here and
stated case by case — while float64 runs the plain product in both and
checks the route itself (the same pipeline: the emit-b̃ kernels, the
Thomas z-stage in 3D, the reference's 2D gates) at float64 rounding.

* `rolling.matmul_plain` at "default": tf32(a)·tf32(b) in IEEE fp32,
  within the TF32 rounding bound of float64, and the plain product in
  float64;
* `make_fft_btilde_solver` (``z_mode="auto"``) and `make_fft_direct` at
  "default", 3D and 2D, against the reference's at DEFAULT;
* the DEFAULT projection step (nz ≥ 4, nz = 3, 2D, the consistent
  scheme) against the reference's step at DEFAULT;
* the route: the physical b̃, the TF32 products (4 a step), the Thomas
  sweeps and the corrector on p, no DST-fused product.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from cfd_tpu import FlowField as JField
from cfd_tpu import Grid as JGrid
from cfd_tpu.solvers.ns import NSParams as JParams
from cfd_tpu.solvers.ns.projection import \
    make_projection_step as j_make_step
from cfd_tpu.solvers.poisson import spectral as jspec
from cfd_tpu.solvers.poisson.base import Method as JMethod
from cfd_tpu.solvers.poisson.base import PoissonParams as JPoisson
from cfd_tpu.solvers.poisson.base import PoissonProblem as JProblem
from cfd_tpu_torch.interop import field_from_numpy, grid_from
from cfd_tpu_torch.ops.kernels import projection_kernels as pkm
from cfd_tpu_torch.ops.kernels import rolling, tdma
from cfd_tpu_torch.solvers.ns.params import NSParams
from cfd_tpu_torch.solvers.ns.projection import make_projection_step
from cfd_tpu_torch.solvers.poisson import spectral
from cfd_tpu_torch.solvers.poisson.base import (Method, PoissonParams,
                                                PoissonProblem)

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(min(2, torch.get_num_threads()))

NAMES = ("u", "v", "w", "p")
DEFAULT = lax.Precision.DEFAULT


def test_matmul_plain_default_is_one_tf32_pass():
    """tf32(a)·tf32(b) exactly (each product of two TF32 values is exact
    in fp32), within the TF32 rounding bound of the float64 product:
    |Δ| ≤ (2·2⁻¹¹ + 2⁻²²)·(|a|·|b|) + k·2⁻²⁴·(|a|·|b|); float64 operands
    take the plain product, and an unknown precision raises."""
    rng = np.random.default_rng(0)
    a = torch.as_tensor(rng.standard_normal((37, 130)).astype(np.float32))
    b = torch.as_tensor(rng.standard_normal((130, 23)).astype(np.float32))
    got = rolling.matmul_plain(a, b, "default")
    with rolling.ieee_fp32_matmul():
        want = torch.matmul(rolling.tf32_rna(a), rolling.tf32_rna(b))
    assert torch.equal(got, want)
    exact = a.double() @ b.double()
    bound = ((2 * 2.0 ** -11 + 2.0 ** -22 + 130 * 2.0 ** -24)
             * (a.double().abs() @ b.double().abs()))
    assert bool(((got.double() - exact).abs() <= bound).all())
    err = float((got.double() - exact).abs().max() / exact.abs().max())
    print(f"TF32 one pass vs float64: {err:.3e} of max")
    assert err > 1e-5      # not fp32-class: the operands were rounded
    assert torch.equal(rolling.matmul_plain(a.double(), b.double(),
                                            "default"), exact)
    # a differentiable plain step differentiates the rounding as the
    # identity, in reverse and forward mode
    a_grad = a.clone().requires_grad_()
    (g,) = torch.autograd.grad(rolling.matmul_plain(a_grad, b,
                                                    "default").sum(), a_grad)
    assert torch.allclose(g, torch.ones(37, 23) @ rolling.tf32_rna(b).T)
    _, tangent = torch.func.jvp(
        lambda x: rolling.matmul_plain(x, b, "default"), (a,),
        (torch.ones_like(a),))
    assert torch.allclose(tangent, torch.ones_like(a) @ rolling.tf32_rna(b),
                          rtol=1e-6)
    with pytest.raises(ValueError):
        rolling.matmul_plain(a, b, "fastest")


def _btilde(shape, np_dt, seed=7):
    rng = np.random.default_rng(seed)
    bt = np.zeros(shape, np_dt)
    inner = (slice(1, -1) if shape[0] > 1 else slice(None), slice(1, -1),
             slice(1, -1))
    bt[inner] = rng.standard_normal(bt[inner].shape).astype(np_dt)
    return bt


def _problems(shape, spacing):
    nz, ny, nx = shape
    dx, dy, dz = spacing
    return (PoissonProblem(nx, ny, nz, dx, dy, dz),
            JProblem(nx, ny, nz, dx, dy, dz))


# (shape, spacing): 3D (the Thomas z-stage), a 2D grid under the
# reference's padding gate (eigen: ceil(mx, 1024) ≥ 2·mx) and one above
# it (the y-line Thomas with its rescue)
SOLVER_CASES = {"3d": ((16, 10, 130), (0.05, 0.03, 0.07)),
                "2d_eigen": ((1, 34, 130), (0.05, 0.03, 0.0)),
                "2d_tdma": ((1, 20, 1030), (1 / 1029, 1 / 19, 0.0))}
# float32 against the reference's fp32 DEFAULT: the TF32 rounding of the
# operands, measured here at 6e-4–9e-4 of max|x| (random zero-shell b̃):
# held at 2e-3
TF32_SOLVE_BAR = 2e-3


@pytest.mark.parametrize("case", sorted(SOLVER_CASES))
def test_btilde_solver_and_direct_solve_match_reference(case):
    """`make_fft_btilde_solver(z_mode="auto")` and `make_fft_direct` at
    "default" against the reference's at DEFAULT: float64 within
    1e-12·max|x| (the same route, the same arithmetic), float32 within
    TF32_SOLVE_BAR; "auto" takes the reference's pipeline (eigen below
    the 2D padding gate, the Thomas stage above it)."""
    shape, spacing = SOLVER_CASES[case]
    port, ref = _problems(shape, spacing)
    fn = spectral.make_fft_btilde_solver(port, precision="default",
                                         z_mode="auto")
    jfn = jspec.make_fft_btilde_solver(ref, precision=DEFAULT,
                                       z_mode="auto", interpret=True)
    for np_dt, tol in ((np.float64, 1e-12), (np.float32, TF32_SOLVE_BAR)):
        bt = _btilde(shape, np_dt)
        want = np.asarray(jfn(jnp.asarray(bt)))
        got = fn(torch.as_tensor(bt)).numpy()
        err = np.abs(got - want).max() / np.abs(want).max()
        print(f"{case} {np_dt.__name__} b̃ solver: {err:.3e} of max")
        assert err <= tol
    direct = spectral.make_fft_direct(port, PoissonParams(), "default")
    jdirect = jspec.make_fft_direct(ref, JPoisson(), precision=DEFAULT)
    rng = np.random.default_rng(3)
    x0 = rng.standard_normal(shape)
    rhs = _btilde(shape, np.float64, seed=4)
    got = direct(torch.as_tensor(x0), torch.as_tensor(rhs)).x.numpy()
    want = np.asarray(jdirect(jnp.asarray(x0), jnp.asarray(rhs)).x)
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


def _numpy_field(shape, seed, np_dt):
    rng = np.random.default_rng(seed)
    out = {n: rng.normal(0.0, 0.1, shape).astype(np_dt) for n in NAMES}
    out["rho"] = np.ones(shape, np_dt)
    out["T"] = np.full(shape, 300.0, np_dt)
    return out


def _jgrid(shape, stretched=False):
    nz, ny, nx = shape
    if stretched:
        return JGrid.stretched(nx, ny, nz, zmin=0.0, zmax=1.0, beta=1.5,
                               stretch_axes="xy")
    if nz == 1:
        return JGrid.uniform(nx, ny)
    return JGrid.uniform(nx, ny, nz, zmin=0.0, zmax=1.0)


def _port_step(shape, np_dt, params, stretched=False, precision="default"):
    jgrid = _jgrid(shape, stretched)
    tdt = torch.float32 if np_dt == np.float32 else torch.float64
    step = make_projection_step(grid_from(jgrid), NSParams(**params), tdt,
                                Method.FFT_DIRECT, device="cpu",
                                spectral_precision=precision)
    out, res = step(field_from_numpy(_numpy_field(shape, 11, np_dt), "cpu",
                                     tdt), 1e-3, 0)
    assert int(res.status) == 0
    return {n: getattr(out, n).numpy() for n in NAMES}


def _ref_step(shape, np_dt, params, fused=False, stretched=False):
    jgrid = _jgrid(shape, stretched)
    jdt = jnp.float32 if np_dt == np.float32 else jnp.float64
    kw = dict(use_pallas=True, pallas_interpret=True) if fused else \
        dict(use_pallas=False)
    jstep = jax.jit(j_make_step(jgrid, JParams(**params), dtype=jdt,
                                poisson_method=JMethod.FFT_DIRECT,
                                spectral_precision=DEFAULT, **kw))
    arrays = _numpy_field(shape, 11, np_dt)
    jout, jres = jstep(JField(**{n: jnp.asarray(a)
                                 for n, a in arrays.items()}), 1e-3, 0)
    assert int(jres.status) == 0
    return {n: np.asarray(getattr(jout, n)) for n in NAMES}


def _assert_rel(got, want, bars, tag):
    for n in NAMES:
        scale = max(1.0, np.abs(want[n]).max())
        err = np.abs(got[n] - want[n]).max() / scale
        print(f"{tag} {n}: {err:.3e} of max(1, max|{n}|) (bar {bars[n]})")
        assert err <= bars[n], (tag, n)


SOURCES = dict(source_amplitude_u=0.1, source_amplitude_v=0.05)
STEP_CASES = {"3d": ((8, 16, 128), SOURCES, False),
              "nz3": ((3, 16, 128), SOURCES, False),
              "2d": ((1, 32, 128), dict(source_amplitude_u=0.0,
                                        source_amplitude_v=0.0), False),
              "consistent": ((8, 17, 17), dict(nonuniform_scheme=
                                                "consistent"), True)}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_default_step_matches_reference_f64(case):
    """The DEFAULT step in float64 against the reference's jnp step at
    DEFAULT (nz ≥ 4, nz = 3, 2D, and the consistent scheme on a
    tanh-stretched grid, which takes `make_nonuniform_direct`): the same
    route in both, 1e-12 of max(1, max|·|) — the reference's jnp step
    solves through its all-DST eigen pipeline, the port through the
    Thomas z-stage, two exact solves of one system."""
    shape, params, stretched = STEP_CASES[case]
    got = _port_step(shape, np.float64, params, stretched)
    want = _ref_step(shape, np.float64, params, stretched=stretched)
    _assert_rel(got, want, dict.fromkeys(NAMES, 1e-12), f"{case} f64")


# float32 against the reference's fused DEFAULT step (interpret mode, its
# DEFAULT products full fp32 on the CPU): measured p 1.3e-3 / 1.5e-3 of
# max|p| (3D / 2D) and u, v, w below 6e-4 — one TF32 pass against fp32;
# held at 4e-3 (p) and 2e-3 (u, v, w), about four TF32 ulps of 2⁻¹⁰
F32_BARS = dict(u=2e-3, v=2e-3, w=2e-3, p=4e-3)


@pytest.mark.parametrize("case", ["3d", "2d"])
def test_default_step_matches_reference_f32(case):
    """The float32 DEFAULT step against the reference's fused DEFAULT
    step (its emit-b̃ kernels in interpret mode and its transform
    pipeline at DEFAULT) at the TF32 bars above; and against the port's
    own HIGHEST step at the same bars."""
    shape, params, _ = STEP_CASES[case]
    got = _port_step(shape, np.float32, params)
    _assert_rel(got, _ref_step(shape, np.float32, params, fused=True),
                F32_BARS, f"{case} f32 vs reference")
    _assert_rel(got, _port_step(shape, np.float32, params, precision=None),
                F32_BARS, f"{case} f32 vs HIGHEST")


def _spy(monkeypatch, module, name, calls, key=None):
    fn = getattr(module, name)

    def wrapped(*a, **k):
        calls.append(key(a, k) if key else name)
        return fn(*a, **k)

    monkeypatch.setattr(module, name, wrapped)


@pytest.mark.parametrize("shape", [(8, 16, 128), (3, 16, 128)],
                         ids=["3d", "nz3"])
def test_default_route_calls(monkeypatch, shape):
    """The 3D DEFAULT step's route, by the wrappers it calls in one step:
    the predictor, the physical b̃ (`poisson_input`), the forward and the
    inverse xy DST as `plane_dot` at "default" (4 TF32 launches on the
    card), one Thomas forward sweep and one back substitution, the
    corrector on p; no other precision's product, no analytic back
    substitution."""
    calls = []
    for name in ("predictor_star", "poisson_input", "corrector"):
        _spy(monkeypatch, pkm, name, calls)
    for name in ("tdma_z_fwd", "tdma_z_bwd", "tdma_z_fwd_d",
                 "tdma_z_bwd_analytic"):
        _spy(monkeypatch, tdma, name, calls)
    _spy(monkeypatch, rolling, "plane_dot", calls,
         key=lambda a, k: ("plane_dot", a[3] if len(a) > 3
                           else k.get("precision", "highest")))
    for name in ("right_dot", "left_dot"):
        _spy(monkeypatch, rolling, name, calls)
    jgrid = _jgrid(shape)
    step = make_projection_step(grid_from(jgrid), NSParams(**SOURCES),
                                torch.float32, Method.FFT_DIRECT,
                                device="cpu", spectral_precision="default")
    step(field_from_numpy(_numpy_field(shape, 1, np.float32), "cpu",
                          torch.float32), 1e-3, 0)
    assert sorted(map(str, calls)) == sorted(map(str, [
        "predictor_star", "poisson_input", ("plane_dot", "default"),
        "tdma_z_fwd", "tdma_z_bwd", ("plane_dot", "default"),
        "corrector"]))


def _tg_field(shape):
    """`bench.py:41-60`'s Taylor-Green start (p = 1, ρ = 1, T = 300), as
    `chip_smoke.py` makes it."""
    nz, ny, nx = shape
    two_pi = 2.0 * np.pi
    uu = (np.sin(two_pi * np.linspace(0, 1, nx))[None, None, :]
          * np.cos(two_pi * np.linspace(0, 1, ny))[None, :, None])
    if nz > 1:
        uu = uu * np.cos(two_pi * np.linspace(0, 1, nz))[:, None, None]
    uu = np.broadcast_to(uu, shape).astype(np.float32)
    return dict(u=uu, v=-uu, w=np.zeros(shape, np.float32),
                p=np.ones(shape, np.float32), rho=np.ones(shape, np.float32),
                T=np.full(shape, 300.0, np.float32))


@pytest.mark.parametrize("shape,dt", [((64, 64, 64), 1e-4),
                                      ((1, 256, 256), 1e-5)],
                         ids=["64^3", "256^2"])
def test_default_vs_highest_taylor_green(shape, dt):
    """The float32 DEFAULT step against the HIGHEST one after one step
    from `bench.py:run_3d` / `run_2d`'s Taylor-Green start, on the plain
    versions (the chip run holds the kernels at 512³ and 2048² the same
    way, `chip_smoke.py` phase 38): p within ``TOL_TF32_STEP`` = 1e-2 of
    max|p| (printed: about 1e-3 here)."""
    jgrid = _jgrid(shape)
    grid = grid_from(jgrid)
    params = NSParams(source_amplitude_u=0.0, source_amplitude_v=0.0,
                      mu=0.01)
    out = {}
    for prec in ("default", None):
        step = make_projection_step(grid, params, torch.float32,
                                    Method.FFT_DIRECT, device="cpu",
                                    spectral_precision=prec)
        out[prec] = step(field_from_numpy(_tg_field(shape), "cpu",
                                          torch.float32), dt, 0)[0]
    pmax = float(out[None].p.abs().max())
    p_rel = float((out["default"].p - out[None].p).abs().max()) / pmax
    u_abs = max(float((getattr(out["default"], k) - getattr(out[None], k))
                      .abs().max()) for k in "uvw")
    print(f"{shape} DEFAULT vs HIGHEST after one step: p {p_rel:.3e} of "
          f"max|p| ({pmax:.4g}), max|Δu| {u_abs:.3e}")
    assert p_rel <= 1e-2
