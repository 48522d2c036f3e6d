"""The 2D y-solve's dense low-mode rescue through `rolling.rescue_dot`
(the GEMM with the eigenvalue divide fused, `csrc/rescue_gemm.cu`),
against the reference.

On the CPU `rescue_dot` runs its plain version, ``matmul_plain(left, x)
/ lam``; the CUDA kernel is held against that plain version on the card
by `chip_smoke.py`.  The reference's y-solve runs its jnp pieces
(`make_dst2d_fused_pieces(..., use_kernel=False)`: the Thomas scan, no
interpret-mode build).  Inputs come from ``np.random.default_rng``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from cfd_tpu.solvers.poisson import spectral as jspec
from cfd_tpu.solvers.poisson.base import PoissonProblem as JProblem
from cfd_tpu_torch.ops.kernels import rolling, tdma
from cfd_tpu_torch.solvers.poisson import spectral
from cfd_tpu_torch.solvers.poisson.base import PoissonProblem

torch.set_num_threads(min(2, torch.get_num_threads()))

NY, NX = 32, 1024       # K = 128 < mx = 1022: Thomas and the rescue
# float64: two exact products of the same factors, agreement to rounding;
# float32: the bar of test_torch_tdma2d.py::test_ysolve_matches_reference
# (the rescue columns sum 30-32 terms in another order)
TOLS = {np.float64: 1e-12, np.float32: 1e-6}
DTYPES = [np.float64, np.float32]


def _problems(ny, nx):
    h = (1.0 / (nx - 1), 1.0 / (ny - 1))
    return PoissonProblem(nx, ny, 1, *h), JProblem(nx, ny, 1, *h)


def _rhs(ny, nx, seed, np_dt):
    """An x-transformed b̃: zero y-shell rows, zero spare-mode columns."""
    r = np.random.default_rng(seed).normal(0.0, 1.0, (ny, nx))
    r[0] = r[-1] = 0.0
    r[:, nx - 2:] = 0.0
    return r.astype(np_dt)


def _torch_dtype(np_dt):
    return torch.float64 if np_dt == np.float64 else torch.float32


@pytest.mark.parametrize("np_dt", DTYPES, ids=["f64", "f32"])
def test_rescue_matches_reference(np_dt):
    """The two rescue products through `rescue_dot_plain` (the divide by
    λ fused into the first, the second into x̂'s first K columns in
    place) against the reference's rescue, `spectral.py:299-303`, on its
    own factors: s = Fyp·a[:, :K] / λ, x[:, :K] = Gyp·s."""
    port, _ = _problems(NY, NX)
    _, _, ysolve = spectral.make_dst2d_fused_pieces(
        port, _torch_dtype(np_dt), "cpu")
    fyp, gyp, k = ysolve.rescue
    my = NY - 2
    r_fyp = np.zeros((my, NY), np_dt)
    r_fyp[:, 1:NY - 1] = jspec._sine_matrix(my)
    r_gyp = np.asarray(jspec._mirror_extended_inverse(my, 2.0 / (my + 1)),
                       np_dt)
    ly = jspec._dirichlet_eigenvalues(my, float(port.inv_dy2))
    lx = jspec._dirichlet_eigenvalues(NX - 2, float(port.inv_dx2))
    a = _rhs(NY, NX, 3, np_dt)
    hi = lax.Precision.HIGHEST
    s_ref = jnp.matmul(jnp.asarray(r_fyp), jnp.asarray(a[:, :k]),
                       precision=hi)
    s_ref = s_ref / (jnp.asarray(ly, np_dt)[:, None]
                     + jnp.asarray(lx[:k], np_dt)[None, :])
    x_ref = np.asarray(jnp.matmul(jnp.asarray(r_gyp), s_ref, precision=hi))

    at = torch.tensor(a)
    s = rolling.rescue_dot_plain(fyp, at[:, :k], ysolve.lam)
    x = torch.full((NY, NX), 7.0, dtype=at.dtype)
    rolling.rescue_dot_plain(gyp, s, out=x[:, :k])
    tol = TOLS[np_dt]
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), rtol=0,
                               atol=tol * np.abs(np.asarray(s_ref)).max())
    np.testing.assert_allclose(x[:, :k].numpy(), x_ref, rtol=0,
                               atol=tol * np.abs(x_ref).max())
    assert bool((x[:, k:] == 7.0).all())


@pytest.mark.parametrize("np_dt", DTYPES, ids=["f64", "f32"])
def test_ysolve_through_rescue_dot_matches_reference(np_dt):
    """The whole y-solve (Thomas on every column, then the rescue of the
    128 lowest modes through `rescue_dot`) against the reference's jnp
    y-solve at 1024×32."""
    port, ref = _problems(NY, NX)
    assert jspec.dst2d_fused_supported(ref)
    jdt = jnp.float64 if np_dt == np.float64 else jnp.float32
    rysolve = jspec.make_dst2d_fused_pieces(ref, jdt, use_kernel=False)[2]
    _, _, ysolve = spectral.make_dst2d_fused_pieces(
        port, _torch_dtype(np_dt), "cpu")
    r = _rhs(NY, NX, 2, np_dt)
    x_ref = np.asarray(rysolve(jnp.asarray(r)[None]))
    x = ysolve(torch.tensor(r)[None])
    assert x.shape == (1, NY, NX) and x.dtype == _torch_dtype(np_dt)
    np.testing.assert_allclose(x.numpy(), x_ref, rtol=0,
                               atol=TOLS[np_dt] * np.abs(x_ref).max())


@pytest.mark.parametrize("precision", rolling.PRECISIONS)
def test_fused_divide_is_the_divide_after_the_product(precision):
    """`rescue_dot` with λ equals, bit for bit, its product without λ
    divided by λ after it (IEEE ``/``, no reciprocal product); ``out=``
    writes the column slice in place and leaves the other columns as
    they were."""
    rng = np.random.default_rng(4)
    left = torch.tensor(rng.normal(size=(30, 32)), dtype=torch.float32)
    x = torch.tensor(rng.normal(size=(32, 40)), dtype=torch.float32)
    lam = torch.tensor(rng.uniform(1.0, 1e4, size=(30, 24)),
                       dtype=torch.float32)
    fused = rolling.rescue_dot(left, x[:, :24], lam, precision=precision)
    after = rolling.rescue_dot(left, x[:, :24],
                               precision=precision) / lam
    assert torch.equal(fused, after)
    assert torch.equal(fused, rolling.matmul_plain(left, x[:, :24],
                                                   precision) / lam)
    out = torch.full((30, 40), -3.0)
    got = rolling.rescue_dot(left, x[:, :24], lam, out=out[:, :24],
                             precision=precision)
    assert got.data_ptr() == out.data_ptr()
    assert torch.equal(out[:, :24], fused)
    assert bool((out[:, 24:] == -3.0).all())


@pytest.mark.parametrize("plain", [False, True], ids=["wrapper", "plain"])
@pytest.mark.parametrize("precision", rolling.PRECISIONS)
def test_ysolve_route(monkeypatch, precision, plain):
    """One y-solve calls the rescue wrapper twice at its precision (λ with
    the first product, ``out=`` with the second) and `left_dot` never;
    with ``plain`` the plain version instead.  On the card that is two
    rescue-GEMM launches and no separate divide."""
    calls = []

    def spy(name):
        fn = getattr(rolling, name)

        def wrapper(*args, **kwargs):
            calls.append((name, kwargs.get("precision"),
                          len(args) > 2 and args[2] is not None,
                          kwargs.get("out") is not None))
            return fn(*args, **kwargs)
        monkeypatch.setattr(rolling, name, wrapper)

    for name in ("rescue_dot", "rescue_dot_plain", "left_dot",
                 "left_dot_plain"):
        spy(name)
    port, _ = _problems(NY, 128)
    _, _, ysolve = spectral.make_dst2d_fused_pieces(
        port, torch.float32, "cpu", plain=plain, precision=precision)
    ysolve(torch.tensor(_rhs(NY, 128, 5, np.float32))[None])
    name = "rescue_dot_plain" if plain else "rescue_dot"
    # (on the CPU the wrapper runs its plain version, recorded after it)
    assert [c for c in calls if c[0] == name] == [
        (name, precision, True, False), (name, precision, False, True)]
    assert not [c for c in calls if c[0].startswith("left_dot")
                or (plain and c[0] == "rescue_dot")]


def test_rescue_every_mode_matches_eigen_pipeline(monkeypatch):
    """At 128² (the Ghia cavity's grid) the rescue covers every mode, K ==
    mx = 126, and the Thomas launch is skipped: x-DST → y-solve →
    inverse x-DST in float64 against the reference's all-DST 2D eigen
    pipeline, two exact direct solves of one system (atol 1e-10 on a
    unit-scale rhs)."""
    n = 128
    port, ref = _problems(n, n)
    thomas = []
    monkeypatch.setattr(tdma, "tdma_y_2d",
                        lambda *a, **k: thomas.append(1))
    fxt, gxt, ysolve = spectral.make_dst2d_fused_pieces(port, torch.float64,
                                                        "cpu")
    assert ysolve.rescue[2] == n - 2
    b = np.random.default_rng(6).normal(0.0, 1.0, (1, n, n))
    b[:, 0] = b[:, -1] = 0.0
    b[:, :, 0] = b[:, :, -1] = 0.0
    x_ref = np.asarray(jspec._make_btilde_pipeline(
        ref, lax.Precision.HIGHEST)(jnp.asarray(b)))
    x = rolling.right_dot(ysolve(rolling.right_dot(torch.tensor(b), fxt)),
                          gxt)
    assert not thomas
    np.testing.assert_allclose(x.numpy(), x_ref, atol=1e-10, rtol=0)


@pytest.mark.parametrize("case", ["rank", "depth", "lam", "out", "device",
                                  "precision"])
def test_rescue_dot_refuses(case):
    """Shapes that do not chain, a λ or ``out`` of another shape, a device
    other than the CPU or CUDA, an unknown precision: each raises."""
    left, x = torch.ones(6, 4), torch.ones(4, 3)
    kw = {}
    if case == "rank":
        x = torch.ones(2, 4, 3)
    elif case == "depth":
        x = torch.ones(5, 3)
    elif case == "lam":
        kw["lam"] = torch.ones(6, 4)
    elif case == "out":
        kw["out"] = torch.ones(3, 6)
    elif case == "device":
        left, x = left.to("meta"), x.to("meta")
    else:
        kw["precision"] = "bf16"
    with pytest.raises(ValueError):
        rolling.rescue_dot(left, x, **kw)
