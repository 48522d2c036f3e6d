"""``spectral_precision="high"``, the A4 Thomas builders and the nz = 3
spectral step, against the reference (`cfd_tpu/ops/pallas/rolling.py`
``hp_dot_general``, `ops/pallas/tdma.py`, `ops/pallas/projection_kernels.py`,
`solvers/ns/projection.py`), on the CPU.

* the 3xTF32 plain version: the TF32 rounding of ``cvt.rna.tf32.f32`` on
  ties and near-ties, and products within 1e-6·max|out| of IEEE fp32;
* `tdma.make_tdma_z`, stored and analytic, at the reference's own bars
  (`tests/solvers/test_tdma.py:55-81`), `make_tdma_z_bwd` against the
  full solve (`:84-121`), and the coefficient planes equal to the
  reference's;
* the 3D HIGH step against the reference's fused HIGH step (interpret
  mode) and the port's HIGHEST step, the 2D HIGH step likewise, at the
  reference's HIGH bars (`tests/math/test_mega_kernels.py:100-137`,
  `tests/math/test_pallas2d.py:131-147`);
* the nz = 3 step against the reference's fused step (float32) and its
  jnp step (float64).

Both packages get the same numpy inputs from ``np.random.default_rng``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from cfd_tpu import FlowField as JField
from cfd_tpu import Grid as JGrid
from cfd_tpu.ops.pallas import tdma as jtdma
from cfd_tpu.solvers.ns import NSParams as JParams
from cfd_tpu.solvers.ns.projection import \
    make_projection_step as j_make_step
from cfd_tpu.solvers.poisson.base import Method as JMethod
from cfd_tpu_torch import CFDError, Grid, Status
from cfd_tpu_torch.interop import field_from_numpy
from cfd_tpu_torch.ops.kernels import projection_kernels as pkm
from cfd_tpu_torch.ops.kernels import rolling, tdma
from cfd_tpu_torch.solvers.ns.params import NSParams
from cfd_tpu_torch.solvers.ns.projection import make_projection_step
from cfd_tpu_torch.solvers.poisson.base import Method, PoissonProblem
from cfd_tpu_torch.solvers.poisson.spectral import make_dst_fused_pieces

torch.set_num_threads(min(2, torch.get_num_threads()))

NAMES = ("u", "v", "w", "p")
SOURCES = dict(source_amplitude_u=0.1, source_amplitude_v=0.05)


# ---- the 3xTF32 split ----------------------------------------------------------

def test_tf32_rna_rounds_to_nearest_ties_away():
    """10 mantissa bits, ties away from zero, as ``cvt.rna.tf32.f32``:
    1 + 2⁻¹¹ is a tie (up to 1 + 2⁻¹⁰), a hair below it rounds down, and
    the sign does not change the magnitude's rounding."""
    vals = np.array([1 + 2.0 ** -11, 1 + 2.0 ** -11 - 2.0 ** -23,
                     -(1 + 2.0 ** -11), 3.0 * (1 + 2.0 ** -12), 0.0],
                    np.float32)
    want = np.array([1 + 2.0 ** -10, 1.0, -(1 + 2.0 ** -10), 3.0, 0.0],
                    np.float32)
    got = rolling.tf32_rna(torch.as_tensor(vals)).numpy()
    np.testing.assert_array_equal(got, want)
    rng = np.random.default_rng(0)
    x = rng.standard_normal(1000).astype(np.float32)
    big = rolling.tf32_rna(torch.as_tensor(x)).numpy()
    assert not (big.view(np.int32) & 0x1FFF).any()
    assert np.all(np.abs(big - x) <= np.abs(x) * 2.0 ** -11)


@pytest.fixture(scope="module")
def planes():
    """Random 37×23×11 planes and the two square factors of a plane
    product."""
    rng = np.random.default_rng(37)
    x = rng.standard_normal((11, 23, 37)).astype(np.float32)
    right = rng.standard_normal((37, 37)).astype(np.float32)
    left = rng.standard_normal((23, 23)).astype(np.float32)
    return tuple(torch.as_tensor(a) for a in (x, right, left))


def test_3xtf32_plain_is_fp32_class(planes):
    """``plane_dot`` at "high" on the CPU (the kernel's plain version)
    within 1e-6·max|out| of the IEEE fp32 product — 3xTF32 is fp32-class,
    where one TF32 pass is not (its error is printed beside)."""
    x, right, left = planes
    hi = rolling.plane_dot(x, right, left, precision="high")
    ref = rolling.plane_dot(x, right, left)
    scale = float(ref.abs().max())
    err = float((hi - ref).abs().max())
    one = torch.matmul(rolling.tf32_rna(left), rolling.tf32_rna(
        torch.matmul(rolling.tf32_rna(x), rolling.tf32_rna(right))))
    print(f"3xTF32 vs fp32 {err / scale:.3e} of max; one TF32 pass "
          f"{float((one - ref).abs().max()) / scale:.3e}")
    assert err <= 1e-6 * scale
    for a, b in ((rolling.right_dot(x, right, "high"),
                  rolling.right_dot(x, right)),
                 (rolling.left_dot(left, x[0], precision="high"),
                  rolling.left_dot(left, x[0]))):
        assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())


def test_3xtf32_plain_is_the_kernels_sum(planes):
    """The plain version is the split's three IEEE products summed as
    (small·big + big·small) + big·big; in float64 "high" is the plain
    product (the split is fp32's); a precision the products do not know
    raises."""
    x, right, _ = planes
    a = x.reshape(-1, 37)
    ab, bb = rolling.tf32_rna(a), rolling.tf32_rna(right)
    a_s, b_s = rolling.tf32_rna(a - ab), rolling.tf32_rna(right - bb)
    want = (a_s @ bb + ab @ b_s) + ab @ bb
    assert torch.equal(rolling.matmul_plain(a, right, "high"), want)
    x64, r64 = a.double(), right.double()
    assert torch.equal(rolling.matmul_plain(x64, r64, "high"), x64 @ r64)
    with pytest.raises(ValueError):
        rolling.plane_dot(x, right, right, precision="fastest")


# ---- A4: make_tdma_z, make_tdma_z_bwd --------------------------------------------

def _tdma_case(nz, my=16, mx=128):
    rng = np.random.default_rng(nz)
    r = np.zeros((nz, my, mx), np.float32)
    r[1:-1] = rng.standard_normal((nz - 2, my, mx)).astype(np.float32)
    mu = np.exp(rng.uniform(np.log(1e-2), np.log(1e3), (my, mx)))
    return r, mu, 123.4


def test_coeff_planes_equal_reference():
    """[e^{−φ}, 2φ] from the float64 μ plane, rounded once: the
    reference's (2·my, mx) rows exactly."""
    _, mu, w = _tdma_case(9)
    got = tdma._bwd_coeff_planes(mu, w)
    want = jtdma._bwd_coeff_planes(mu, w, np.dtype(np.float32))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.reshape(want.shape), want)


@pytest.mark.parametrize("variant", ["stored", "analytic"])
@pytest.mark.parametrize("nz", [3, 4, 9, 34])
def test_make_tdma_z_matches_reference(nz, variant):
    """Within 5e-6·max|x| of the reference's f32 scan and 2e-5·max|x| of
    its float64 scan (the reference's kernel bars); the stored variant is
    the scan's arithmetic, bit for bit on the port's plain loops."""
    r, mu, w = _tdma_case(nz)
    fn = tdma.make_tdma_z(nz, 16, 128, mu, w, torch.float32, "cpu",
                          variant=variant)
    got = fn(torch.as_tensor(r)).numpy()
    f32ref = np.asarray(jtdma.tdma_z_reference(
        jnp.asarray(r), jnp.asarray(mu, jnp.float32), np.float32(w)))
    scale = np.abs(f32ref).max()
    np.testing.assert_allclose(got, f32ref, rtol=0, atol=5e-6 * scale)
    truth = np.asarray(jtdma.tdma_z_reference(
        jnp.asarray(r, jnp.float64), jnp.asarray(mu, jnp.float64),
        float(w)))
    np.testing.assert_allclose(got, truth, rtol=0, atol=2e-5 * scale)
    if variant == "stored":
        plain = tdma.tdma_z_reference(torch.as_tensor(r), torch.as_tensor(
            mu.astype(np.float32)), w)
        assert torch.equal(torch.as_tensor(got), plain)


@pytest.mark.parametrize("variant", ["stored", "analytic"])
@pytest.mark.parametrize("nz", [3, 9, 34])
def test_bwd_only_matches_full_solve(nz, variant):
    """``make_tdma_z_bwd`` on pre-swept (d′, t) planes in the
    fused-predictor layout reproduces ``make_tdma_z`` (5e-6·max|x|), and
    the reference's jnp back substitution agrees."""
    r, mu, w = _tdma_case(nz)
    want = tdma.make_tdma_z(nz, 16, 128, mu, w, torch.float32, "cpu",
                            variant=variant)(torch.as_tensor(r)).numpy()
    d, t = tdma.tdma_z_fwd(torch.as_tensor(r), torch.as_tensor(
        mu.astype(np.float32)), w)
    bwd = tdma.make_tdma_z_bwd(nz, 16, 128, mu, w, torch.float32, "cpu",
                               variant=variant)
    got = (bwd(d, t) if variant == "stored" else bwd(d)).numpy()
    scale = max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-6 * scale)
    ref = np.asarray(jtdma.tdma_z_bwd_reference(jnp.asarray(d.numpy()),
                                                jnp.asarray(t.numpy())))
    np.testing.assert_allclose(ref, want, rtol=0, atol=5e-6 * scale)


def test_tdma_builders_guard():
    assert tdma.make_tdma_z(2, 8, 128, np.ones((8, 128)), 1.0) is None
    assert tdma.make_tdma_z_bwd(2, 8, 128, np.ones((8, 128)), 1.0) is None
    with pytest.raises(ValueError):
        tdma.make_tdma_z(8, 8, 128, np.ones((8, 128)), 1.0,
                         variant="other")


# ---- the HIGH steps ------------------------------------------------------------

def _numpy_field(shape, seed, np_dt=np.float32, amp=0.1):
    rng = np.random.default_rng(seed)
    out = {n: rng.normal(0.0, amp, shape).astype(np_dt) for n in NAMES}
    out["rho"] = np.ones(shape, np_dt)
    out["T"] = np.full(shape, 300.0, np_dt)
    return out


def _grids(shape):
    nz, ny, nx = shape
    if nz == 1:
        return JGrid.uniform(nx, ny), Grid.uniform(nx, ny)
    return (JGrid.uniform(nx, ny, nz, zmin=0.0, zmax=1.0),
            Grid.uniform(nx, ny, nz, zmin=0.0, zmax=1.0))


def _ref_step(shape, arrays, np_dt=np.float32, precision=None,
              fused=True, params=SOURCES):
    jgrid, _ = _grids(shape)
    jdt = jnp.float32 if np_dt == np.float32 else jnp.float64
    kw = dict(use_pallas=True, pallas_interpret=True) if fused else \
        dict(use_pallas=False)
    step = jax.jit(j_make_step(
        jgrid, JParams(**params), dtype=jdt,
        poisson_method=JMethod.FFT_DIRECT, spectral_precision=precision,
        **kw))
    jf = JField(**{n: jnp.asarray(a) for n, a in arrays.items()})
    out, res = step(jf, 0.001, 0)
    return {n: np.asarray(getattr(out, n)) for n in NAMES}, int(res.status)


def _port_step(shape, arrays, np_dt=np.float32, precision=None,
               params=SOURCES):
    _, grid = _grids(shape)
    tdt = torch.float32 if np_dt == np.float32 else torch.float64
    step = make_projection_step(grid, NSParams(**params), dtype=tdt,
                                poisson_method=Method.FFT_DIRECT,
                                device="cpu", spectral_precision=precision)
    out, res = step(field_from_numpy(arrays, "cpu", tdt), 0.001, 0)
    return {n: getattr(out, n).numpy() for n in NAMES}, int(res.status)


def _assert_close(got, ref, atol_p, atol_uvw, tag):
    for n in NAMES:
        atol = atol_p if n == "p" else atol_uvw
        err = np.abs(got[n] - ref[n]).max()
        print(f"{tag} {n}: max abs deviation {err:.3e} (bar {atol:g})")
        np.testing.assert_allclose(got[n], ref[n], rtol=0, atol=atol,
                                   err_msg=f"{tag} {n}")


def test_step_high_3d_matches_reference():
    """The 3D HIGH step (3xTF32 products, analytic t) against the
    reference's fused HIGH step (interpret mode: bf16_3x dots, its
    analytic t) and the port's HIGHEST step, 128×16×8 float32, at the
    reference's HIGH bars: p atol 2e-3, u, v, w atol 1e-4."""
    shape = (8, 16, 128)
    arrays = _numpy_field(shape, 11)
    port, st = _port_step(shape, arrays, precision="high")
    ref, jst = _ref_step(shape, arrays, precision=lax.Precision.HIGH)
    assert st == jst == 0
    _assert_close(port, ref, 2e-3, 1e-4, "HIGH vs reference HIGH")
    highest, _ = _port_step(shape, arrays)
    _assert_close(port, highest, 2e-3, 1e-4, "HIGH vs port HIGHEST")


def test_step_high_2d_matches_reference():
    """The 2D HIGH step (3xTF32 x-DSTs and rescue products) against the
    reference's fused 2D HIGH step and the port's HIGHEST step, 128×32
    float32: p atol 2e-3, u, v, w atol 1e-5 (`test_pallas2d.py:145-147`)."""
    shape = (1, 32, 128)
    arrays = _numpy_field(shape, 5)
    params = dict(source_amplitude_u=0.0, source_amplitude_v=0.0)
    port, st = _port_step(shape, arrays, precision="high", params=params)
    ref, jst = _ref_step(shape, arrays, precision=lax.Precision.HIGH,
                         params=params)
    assert st == jst == 0
    _assert_close(port, ref, 2e-3, 1e-5, "2D HIGH vs reference HIGH")
    highest, _ = _port_step(shape, arrays, params=params)
    _assert_close(port, highest, 2e-3, 1e-5, "2D HIGH vs port HIGHEST")


def test_high_kernels_drop_t_and_count_3xtf32():
    """At HIGH the predictor emits (u*, v*, w*, d′, None) — no t — and
    the DST products are the 3xTF32 ones; at nz = 3 the back substitution
    stays stored (the reference demotes it there), so t comes back."""
    shape = (8, 16, 128)
    problem = PoissonProblem(128, 16, 8, 1 / 127, 1 / 15, 1 / 7)
    mats, fwd = make_dst_fused_pieces(problem, torch.float32, "cpu")
    pk = pkm.ProjectionKernels(*shape, 1 / 127, 1 / 15, 1 / 7, 0.0, 0.0,
                               0.01, mats, fwd, dst_precision="high",
                               tdma_bwd="analytic")
    assert pk.bwd_analytic and pk.coef.shape == (2, 16, 128)
    f = field_from_numpy(_numpy_field(shape, 1), "cpu", torch.float32)
    z = torch.zeros(())
    outs = pk.predictor_poisson_input(f.u, f.v, f.w, f.p, z + 1e-3, z, z,
                                      z + 1e3)
    assert len(outs) == 5 and outs[4] is None
    assert len(pk.corrector_bwd_diag(*outs, z + 1e-3)) == 7
    p3 = PoissonProblem(128, 16, 3, 1 / 127, 1 / 15, 0.5)
    mats3, fwd3 = make_dst_fused_pieces(p3, torch.float32, "cpu")
    pk3 = pkm.ProjectionKernels(3, 16, 128, 1 / 127, 1 / 15, 0.5, 0.0,
                                0.0, 0.01, mats3, fwd3,
                                dst_precision="high", tdma_bwd="analytic")
    assert not pk3.bwd_analytic


def test_precision_default_builds_and_unknown_raises():
    """"default" (one TF32 pass) is ported now, in 3D and 2D: the step
    builds (`tests/test_torch_precision_default.py` holds it against the
    reference); a precision the port does not know still raises
    unsupported."""
    for grid in (Grid.uniform(128, 16, 8, zmin=0.0, zmax=1.0),
                 Grid.uniform(128, 16)):
        make_projection_step(grid, NSParams(), torch.float32,
                             Method.FFT_DIRECT, device="cpu",
                             spectral_precision="default")
        with pytest.raises(CFDError) as err:
            make_projection_step(grid, NSParams(), torch.float32,
                                 Method.FFT_DIRECT, device="cpu",
                                 spectral_precision="fastest")
        assert err.value.status == Status.ERROR_UNSUPPORTED


# ---- the nz = 3 step ----------------------------------------------------------

@pytest.mark.parametrize("precision", [None, "high"])
def test_step_nz3_matches_fused_reference_f32(precision):
    """nz = 3 (one interior plane): the reference's step runs its
    standalone back substitution and ``corr_all``'s DST form; the port's
    chain is the same.  128×16×3 float32 against the fused reference:
    p atol 3e-6 and u, v, w atol 1e-7 plus what the p bar passes on
    through the corrector, u − (dt/ρ)(p₊ − p₋)/(2dx): 2·dt/(2dx)·3e-6
    (HIGHEST); at HIGH the reference's HIGH bars."""
    shape = (3, 16, 128)
    arrays = _numpy_field(shape, 0)
    lax_prec = lax.Precision.HIGH if precision else None
    port, st = _port_step(shape, arrays, precision=precision)
    ref, jst = _ref_step(shape, arrays, precision=lax_prec)
    assert st == jst == 0
    if precision is None:
        atol_p = 3e-6
        _assert_close(port, ref, atol_p,
                      1e-7 + 2 * 0.001 * (127 / 2) * atol_p,
                      "nz=3 vs reference")
    else:
        _assert_close(port, ref, 2e-3, 1e-4, "nz=3 HIGH vs reference")


def test_step_nz3_matches_jnp_step_f64():
    """24×20×3 float64 against the reference's jnp step (its all-DST
    eigen solve): atol 1e-12."""
    shape = (3, 20, 24)
    arrays = _numpy_field(shape, 2, np.float64)
    port, st = _port_step(shape, arrays, np.float64)
    ref, jst = _ref_step(shape, arrays, np.float64, fused=False)
    assert st == jst == 0
    _assert_close(port, ref, 1e-12, 1e-12, "nz=3 f64 vs jnp")


def test_simulation_projection_spectral_takes_high():
    """The facade's ``projection_spectral`` solver with
    ``spectral_precision="high"`` steps within the HIGH bars of the same
    session at HIGHEST (float32, 33², ten steps), and with "default" (one
    TF32 pass) too, within its one-step bars of
    `test_torch_precision_default.py` (p 4e-3, u, v, w 2e-3 of max(1,
    max|·|)) after ten steps; a precision the port does not know raises at
    ``init``."""
    from cfd_tpu_torch.api import Simulation

    sims = {}
    for prec in (None, "high", "default"):
        sim = Simulation.create(33, 33, solver_type="projection_spectral",
                                device="cpu", dtype=torch.float32)
        solver = sim.registry.create("projection_spectral")
        solver.spectral_precision = prec
        sim.set_solver(solver)
        for _ in range(10):
            assert sim.step() == Status.SUCCESS
        sims[prec] = {n: getattr(sim.field, n).numpy() for n in NAMES}
    _assert_close(sims["high"], sims[None], 2e-3, 1e-5,
                  "facade HIGH vs HIGHEST")
    scale = {n: max(1.0, float(np.abs(sims[None][n]).max())) for n in NAMES}
    for n in NAMES:
        bar = (4e-3 if n == "p" else 2e-3) * scale[n]
        np.testing.assert_allclose(sims["default"][n], sims[None][n],
                                   rtol=0, atol=bar, err_msg=n)
    solver = Simulation.create(
        33, 33, device="cpu", dtype=torch.float32).registry.create(
        "projection_spectral")
    solver.spectral_precision = "fastest"
    with pytest.raises(CFDError) as err:
        solver.init(Grid.uniform(33, 33), NSParams())
    assert err.value.status == Status.ERROR_UNSUPPORTED


def test_high_deviation_splits_into_gemm_and_analytic_t():
    """Where HIGH's distance from HIGHEST comes from, on the Taylor-Green
    start of `bench.py:run_3d` at 96³ (float32, one step's p): the 3xTF32
    products alone (stored t) stay within 3e-6·max|p|; the analytic t,
    which meets a forward sweep run with the recurrence's own rounded t,
    adds more in the ill-conditioned smooth modes (it grows with n; both
    printed), still far inside the HIGH bar 2e-3."""
    n = 96
    grid = Grid.uniform(n, n, n, zmin=0.0, zmax=1.0)
    lin = torch.linspace(0.0, 1.0, n)
    uu = (torch.sin(2 * torch.pi * lin)[None, None, :]
          * torch.cos(2 * torch.pi * lin)[None, :, None]
          * torch.cos(2 * torch.pi * lin)[:, None, None]).expand(
        n, n, n).contiguous()
    problem = PoissonProblem(n, n, n, grid.dx0, grid.dy0, grid.dz0)
    mats, fwd = make_dst_fused_pieces(problem, torch.float32, "cpu")
    dt, zero = torch.tensor(1e-4), torch.tensor(0.0)
    p = {}
    for prec, bwd in (("highest", "stored"), ("high", "stored"),
                      ("high", "analytic")):
        pk = pkm.ProjectionKernels(n, n, n, grid.dx0, grid.dy0, grid.dz0,
                                   grid.xmin, grid.ymin, 0.01, mats, fwd,
                                   with_sources=False, dst_precision=prec,
                                   tdma_bwd=bwd)
        outs = pk.predictor_poisson_input(
            uu, -uu, torch.zeros_like(uu), torch.ones_like(uu), dt, zero,
            zero, 1.0 / dt)
        p[prec, bwd] = pk.corrector_bwd_diag(*outs, dt)[3]
    ref = p["highest", "stored"]
    scale = float(ref.abs().max())
    gemm = float((p["high", "stored"] - ref).abs().max()) / scale
    analytic = float((p["high", "analytic"] - ref).abs().max()) / scale
    print(f"HIGH vs HIGHEST at {n}^3, of max|p|: 3xTF32 alone {gemm:.3e}, "
          f"with the analytic t {analytic:.3e}")
    assert gemm <= 3e-6 and analytic <= 2e-3
