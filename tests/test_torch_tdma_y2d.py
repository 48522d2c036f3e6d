"""The 2D step's y-line Thomas kernel (`csrc/tdma_lines.cu`) as far as the
CPU can see it: its launch plan (every column once, shared memory within
a CTA's 227 KB, the variant by height), the source's constants against
the plan's, its C entry in the signature table, and the plain versions
the wrapper runs on a CPU tensor — the plane-driven recurrence and the
build-time rec/t planes bit for bit against the plain sweep, and both
against the reference's `tdma_z_reference` scan and its Pallas kernel in
interpret mode.

Inputs come from ``np.random.default_rng``; both packages get the same
numpy arrays.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_tpu.ops.pallas import tdma as jtdma
from cfd_tpu_torch.ops.kernels import native, projection2d, tdma
from cfd_tpu_torch.solvers.poisson import spectral
from cfd_tpu_torch.solvers.poisson.base import PoissonProblem

torch.set_num_threads(min(2, torch.get_num_threads()))

SOURCE = native.CSRC / "tdma_lines.cu"
# (ny, nx): the 2048² step, the 1024×512 channel's (ny, nx) = (512, 1024),
# ragged and smallest shapes, and a column too tall for shared memory
SHAPES = [(2048, 2048), (512, 1024), (23, 37), (3, 5), (4096, 256)]


def _line_system(ny, nx, seed, np_dt):
    """A zero-shell (ny, nx) rhs, the per-mode μ (λx padded with its edge
    value) and w = 1/dy², as `make_dst2d_fused_pieces` builds them."""
    p = PoissonProblem(nx, ny, 1, 1.0 / (nx - 1), 1.0 / (ny - 1))
    mx = nx - 2
    lx = spectral._dirichlet_eigenvalues(mx, p.inv_dx2)
    mu = np.pad(lx, (0, nx - mx), mode="edge").astype(np_dt)
    r = np.random.default_rng(seed).normal(0.0, 1.0, (ny, nx))
    r[0] = r[-1] = 0.0
    return r.astype(np_dt), mu, float(p.inv_dy2)


def _code():
    return re.sub(r"//[^\n]*", "", SOURCE.read_text())


@pytest.mark.parametrize("shape", SHAPES + [(3122, 64), (3123, 64),
                                            (2048, 2047), (1026, 4)])
def test_plan_covers_every_column_once(shape):
    """CTA i owns columns i·cols … i·cols + cols − 1 below nx (the
    kernel's blockIdx.x·kCols + threadIdx.x): each column exactly once,
    the CTA's shared memory within 227 KB, d′ in it where its ny − 2 rows
    and the two rings fit."""
    ny, nx = shape
    fits = (ny - 2 + 2 * 256) * 16 * 4 <= 232448
    plan = tdma.tdma_y2d_plan(ny, nx)
    seen = np.zeros(nx, np.int64)
    for i in range(plan["ctas"]):
        cols = np.arange(i * plan["cols"], (i + 1) * plan["cols"])
        seen[cols[cols < nx]] += 1
    assert (seen == 1).all()
    assert (plan["ctas"] - 1) * plan["cols"] < nx
    assert 0 < plan["smem_bytes"] <= 232448
    assert plan["variant"] == ("smem" if fits else "global")
    assert plan["copy"] == (16 if nx % 4 == 0 else 4)


def test_plan_takes_shared_memory_at_2048_and_global_when_tall():
    """d′ in shared memory at the 2048² step (16 columns a CTA: 128 CTAs,
    one an SM, 160 KB each); a 4096-row column takes the global-d′
    instantiation (32 columns a CTA, the two rings' 64 KB)."""
    p = tdma.tdma_y2d_plan(2048, 2048)
    assert (p["variant"], p["cols"], p["ctas"]) == ("smem", 16, 128)
    assert p["smem_bytes"] == (2046 + 512) * 16 * 4
    q = tdma.tdma_y2d_plan(4096, 256)
    assert (q["variant"], q["cols"], q["ctas"]) == ("global", 32, 8)
    assert q["smem_bytes"] == 512 * 32 * 4
    assert tdma.tdma_y2d_plan(3122, 64)["variant"] == "smem"
    assert tdma.tdma_y2d_plan(3123, 64)["variant"] == "global"
    for bad in ((2, 8), (8, 0)):
        with pytest.raises(ValueError):
            tdma.tdma_y2d_plan(*bad)


def test_source_constants_match_the_plan():
    """The plan mirrors the kernel's ring and CTA widths."""
    code = _code()
    for name, value in (("kStageRows", tdma.Y2D_STAGE_ROWS),
                        ("kStages", tdma.Y2D_STAGES),
                        ("kSmemCols", tdma.Y2D_COLS["smem"]),
                        ("kGlobalCols", tdma.Y2D_COLS["global"]),
                        ("kMaxSmem", tdma.Y2D_MAX_SMEM)):
        assert re.search(rf"constexpr int {name} = {value};", code), name


def test_entry_points_are_declared():
    """`cfd_tdma_y2d` and its chain probe are in the signature table and
    have extern "C" definitions; the kernel keeps the reference's
    operation order, loads its rows by cp.async, and is one launch."""
    assert native.SIGNATURES["cfd_tdma_y2d"] == [
        native._P, native._F, native._P, native._P, native._P, native._I,
        native._I, native._I, native._I, native._P]
    assert native.SIGNATURES["cfd_tdma_y2d_chain"][-1] == native._P
    code = _code()
    extern = code[code.index('extern "C"'):]
    assert re.search(r"int cfd_tdma_y2d\(", extern)
    assert re.search(r"int cfd_tdma_y2d_chain\(", extern)
    assert SOURCE in native._sources()
    assert "dc = (rv[u] + w * dc) * cv[u];" in code   # cv: rec's plane
    assert "xc = dv[u] + tv[u] * xc;" in code
    assert "1.0f /" not in code[:code.index("tdma_chain_probe_kernel")]
    assert "cp_async4(" in code and "cp.async.wait_group" in code
    assert "cp.async.cg.shared.global [%0], [%1], 16, %2;" in code
    assert code.count("<<<") == 2   # the kernel and the probe
    assert "-fmad=false" in native.NVCC_FLAGS


def test_2d_main_path_wrappers():
    """Every 2D main-path list names the one-launch wrapper, and none the
    z-line pair."""
    for wrappers in (projection2d.WRAPPERS, projection2d.WRAPPERS_HIGH):
        assert tdma.tdma_y_2d in wrappers
        assert tdma.tdma_z_fwd not in wrappers
        assert tdma.tdma_z_bwd not in wrappers


@pytest.mark.parametrize("np_dt", [np.float32, np.float64])
@pytest.mark.parametrize("shape", [(23, 37), (3, 5), (64, 48)])
def test_planes_equal_the_forward_sweep(shape, np_dt):
    """The build-time planes are the forward sweep's per-row rec and t bit
    for bit (the sweep's t from `tdma_z_fwd_reference`, its rec from the
    same recurrence in numpy scalars), and the plane-driven recurrence
    gives `tdma_y_2d_reference`'s x bit for bit."""
    ny, nx = shape
    r, mu, w = _line_system(ny, nx, 3, np_dt)
    rt, mut = torch.tensor(r), torch.tensor(mu)
    rec, t = tdma.tdma_y2d_planes(mut, w, ny)
    assert rec.dtype == t.dtype == rt.dtype
    assert rec.shape == t.shape == (ny, nx)
    _, t_sweep = tdma.tdma_z_fwd_reference(rt[:, None, :], mut[None, :], w)
    assert torch.equal(t, t_sweep[:, 0, :])
    wd = np_dt(w)
    b = mu + np_dt(2.0) * wd
    tc = np.zeros(nx, np_dt)
    for j in range(1, ny - 1):
        rj = np_dt(1.0) / (b - wd * tc)
        tc = wd * rj
        np.testing.assert_array_equal(rec[j].numpy(), rj)
    assert not rec[0].any() and not rec[-1].any()
    x = tdma.tdma_y_2d_planes_reference(rt, rec, t, w)
    assert torch.equal(x, tdma.tdma_y_2d_reference(rt, mut, w))
    assert torch.equal(tdma.tdma_y_2d(rt, mut, w, planes=(rec, t)), x)


@pytest.mark.parametrize("planes", [False, True])
@pytest.mark.parametrize("shape", [(23, 37), (3, 5), (130, 33)])
def test_wrapper_on_cpu_matches_scan_reference(shape, planes):
    """float64: the wrapper on a CPU tensor (the plain version, with or
    without the planes) against the reference's `tdma_z_reference` on
    the same lines, rtol 1e-12; mirror shells; no launch counted."""
    ny, nx = shape
    r, mu, w = _line_system(ny, nx, 4, np.float64)
    x_ref = np.asarray(jtdma.tdma_z_reference(
        jnp.asarray(r)[:, None, :], jnp.asarray(mu)[None, :], w))[:, 0, :]
    before = tdma.tdma_y_2d.launches
    rt, mut = torch.tensor(r), torch.tensor(mu)
    pl = tdma.tdma_y2d_planes(mut, w, ny) if planes else None
    x = tdma.tdma_y_2d(rt, mut, w, planes=pl)
    assert tdma.tdma_y_2d.launches == before
    np.testing.assert_allclose(x.numpy(), x_ref, rtol=1e-12, atol=0)
    np.testing.assert_array_equal(x[0].numpy(), x[1].numpy())
    np.testing.assert_array_equal(x[-1].numpy(), x[-2].numpy())


def test_plane_driven_solve_matches_pallas_kernel():
    """float32 at ny = 24, Mx = 1024: the plane-driven recurrence against
    `make_tdma_y_2d` in interpret mode, the tolerance of
    `test_torch_tdma2d.py` (rtol 1e-6, floor 1e-6·max|x|)."""
    r, mu, w = _line_system(24, 1024, 5, np.float32)
    fn = jtdma.make_tdma_y_2d(24, 1024, mu, w, jnp.float32, interpret=True)
    assert fn is not None
    x_ref = np.asarray(fn(jnp.asarray(r)))
    rt, mut = torch.tensor(r), torch.tensor(mu)
    x = tdma.tdma_y_2d(rt, mut, w, planes=tdma.tdma_y2d_planes(mut, w, 24))
    np.testing.assert_allclose(x.numpy(), x_ref, rtol=1e-6,
                               atol=1e-6 * np.abs(x_ref).max())


@pytest.mark.parametrize("case", ["rank", "mu", "short", "planes", "meta"])
def test_wrapper_refuses(case):
    """Shapes the kernel does not take, and a device other than the CPU or
    CUDA, raise instead of falling back."""
    r, mu, planes = torch.zeros(8, 6), torch.ones(6), None
    if case == "rank":
        r = torch.zeros(1, 8, 6)
    elif case == "mu":
        mu = torch.ones(5)
    elif case == "short":
        r = torch.zeros(2, 6)
    elif case == "planes":
        planes = (torch.ones(8, 6), torch.ones(7, 6))
    else:
        r, mu = r.to("meta"), mu.to("meta")
    with pytest.raises(ValueError):
        tdma.tdma_y_2d(r, mu, 1.0, planes=planes)
