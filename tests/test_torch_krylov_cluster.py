"""The whole-solve CG and BiCGSTAB kernels that keep a 2D plane resident in
one thread-block cluster (`csrc/cluster_band.cuh`, ``cg_solve_cluster_
kernel``, ``bicg_solve_cluster_kernel``) as far as the CPU can see them:
the plan by shape (every interior row in one band, at most 16 CTAs and
227 KB of shared memory a CTA, the grid-wide form for 3D volumes and
planes too large), the source's constants and entry points against it,
the dot-order model against a literal simulation of the kernels' sums,
and the order models :func:`cg_solve_cluster_ordered` and
:func:`bicgstab_solve_cluster_ordered` against the plain loops and the
reference's whole-solve kernels in interpret mode.

Inputs come from ``np.random.default_rng``; both packages get the same
numpy arrays.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_tpu.ops.pallas import vmem_small as jvmem
from cfd_tpu_torch.ops.kernels import native, vmem_small
from cfd_tpu_torch.ops.kernels.bicgstab_kernels import BiCGConsts
from cfd_tpu_torch.ops.kernels.cg_kernels import CGConsts

torch.set_num_threads(min(2, torch.get_num_threads()))

ENGINE = native.CSRC / "cluster_band.cuh"
# (nz, ny, nx): the facade's 100×50, the Ghia cavities, run_poisson_iters'
# 100², the MG cavity's 129², phase 12's 512², the smallest plane, a
# ragged one, one past the cluster's shared memory and a 3D volume
CLUSTER_SHAPES = [(1, 5, 3), (1, 23, 37), (1, 50, 100), (1, 100, 100),
                  (1, 128, 128), (1, 129, 129), (1, 512, 512)]
GRID_SHAPES = [(1, 700, 700), (5, 20, 30)]
KINDS = ("cg", "bicgstab")


def _code(path):
    return re.sub(r"//[^\n]*", "", path.read_text())


def _consts(kind, shape, np_dt=np.float32):
    nz, ny, nx = shape
    coef = ((nx - 1) ** 2, (ny - 1) ** 2, 0.0)
    if kind == "cg":
        return CGConsts(nz, ny, nx, *coef)
    return BiCGConsts(nz, ny, nx, *coef)


def _inputs(shape, np_dt, seed=11):
    rng = np.random.default_rng(seed)
    rhs = rng.normal(0.0, 1.0, shape).astype(np_dt)
    x0 = rng.normal(0.0, 0.1, shape).astype(np_dt)
    return x0, rhs


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", CLUSTER_SHAPES + GRID_SHAPES,
                         ids=lambda s: "x".join(map(str, s[::-1])))
def test_plan_covers_every_row_once(shape, kind):
    """A cluster plan gives every interior row to exactly one band (the
    kernels' band_rows: contiguous, the first my % cs ranks one row more),
    each rank at least one row, at most 16 CTAs of at most 1024 threads
    (whole warps) and 227 KB of shared memory a CTA, the stencil vectors
    resident; the grid form for a 3D volume and a plane too large."""
    nz, ny, nx = shape
    plan = vmem_small.krylov_cluster_plan(nz, ny, nx, kind)
    if shape in GRID_SHAPES:
        assert plan["form"] == "grid"
        return
    assert plan["form"] == "cluster"
    cs, rows = plan["cluster"], plan["rows_of"]
    assert 1 <= cs <= vmem_small.CLUSTER_MAX == 16
    assert len(rows) == cs and min(rows) >= 1 and sum(rows) == ny - 2
    assert max(rows) - min(rows) <= 1 and list(rows) == sorted(rows)[::-1]
    assert plan["rows"] == max(rows)
    seen = np.zeros(ny, np.int64)
    start = 0
    for n in rows:
        seen[1 + start:1 + start + n] += 1
        start += n
    assert seen[1:-1].tolist() == [1] * (ny - 2) and seen[[0, -1]].sum() == 0
    assert plan["threads"] % 32 == 0 and plan["threads"] <= 1024
    vectors = vmem_small.CLUSTER_VECTORS[kind]
    n_res = len(plan["resident"])
    assert plan["resident"] + plan["device"] == vectors
    assert n_res >= vmem_small.CLUSTER_STENCIL
    assert plan["mask"] == (1 << n_res) - 1
    assert plan["shared_bytes"] == (
        vmem_small.CLUSTER_HEADER + 8 * nx * vmem_small.CLUSTER_HALO[kind]
        + 4 * n_res * plan["rows"] * nx) <= vmem_small.CLUSTER_SMEM == 232448
    # the next vector would not have fitted
    if plan["device"]:
        assert plan["shared_bytes"] + 4 * plan["rows"] * nx \
            > vmem_small.CLUSTER_SMEM


def test_plan_sizes():
    """The cluster aims at a point a thread of 512-thread CTAs (16 CTAs
    at most, 1024 threads for a band of more than 4 points a thread); the
    main paths' planes keep every vector resident, 512² its stencil
    vectors."""
    plan = vmem_small.krylov_cluster_plan
    for shape, cs, threads in (((1, 128, 128), 16, 512),
                               ((1, 100, 100), 16, 512),
                               ((1, 50, 100), 10, 512),
                               ((1, 23, 37), 2, 416),
                               ((1, 512, 512), 16, 1024)):
        for kind in KINDS:
            got = plan(*shape, kind)
            assert (got["cluster"], got["threads"]) == (cs, threads), shape
    for kind in KINDS:
        assert plan(1, 128, 128, kind)["device"] == ()
        big = plan(1, 512, 512, kind)
        assert big["rows"] == 32
        assert big["resident"][:2] == vmem_small.CLUSTER_VECTORS[kind][:2]
        assert plan(1, 3, 5, kind)["cluster"] == 1
    assert plan(1, 128, 128, "cg")["dots"] == 2
    assert plan(1, 128, 128, "bicgstab")["dots"] == 3


def test_source_constants_match_the_plan():
    """The engine's limits and the kernels' vector orders are the
    plan's."""
    code = _code(ENGINE)
    for name, value in (("kBandMaxCluster", vmem_small.CLUSTER_MAX),
                        ("kBandMaxThreads", vmem_small.CLUSTER_THREADS),
                        ("kBandHeader", vmem_small.CLUSTER_HEADER),
                        ("kBandMaxSmem", vmem_small.CLUSTER_SMEM)):
        assert re.search(rf"constexpr int {name} = {value};", code), name
    cg_code = _code(native.CSRC / "cg_kernels.cu")
    assert "enum { kVecP = 0, kVecR, kVecAp, kVecX, kCgVecs };" in cg_code
    assert vmem_small.CLUSTER_VECTORS["cg"] == ("p", "r", "ap", "x")
    bi_code = _code(native.CSRC / "bicgstab_kernels.cu")
    assert ("enum { kVecP = 0, kVecS, kVecR, kVecV, kVecRhat, kVecX, kVecT, "
            "kBicgVecs };") in bi_code
    assert vmem_small.CLUSTER_VECTORS["bicgstab"] == (
        "p", "s", "r", "v", "rhat", "x", "t")
    assert ("enum { kHaloR = 0, kHaloP, kHaloV, kHaloVNew, kBicgHalo };"
            in bi_code)
    assert "constexpr int kCgHalo = 2;" in cg_code
    assert vmem_small.CLUSTER_HALO == {"cg": 2, "bicgstab": 4}


def test_entry_points_are_declared():
    """The C entries are in the signature table with extern "C"
    definitions; a cluster launch is checked by the occupancy API and
    refused, never replaced; the dots fold without atomics."""
    P, I, F = native._P, native._I, native._F
    assert native.SIGNATURES["cfd_cg_solve_cluster"] == (
        [P] * 5 + [I] * 2 + [F] * 5 + [I] * 6 + [P])
    assert native.SIGNATURES["cfd_bicg_solve_cluster"] == (
        [P] * 5 + [I] * 2 + [F] * 4 + [I] * 6 + [P])
    assert native.SIGNATURES["cfd_barrier_probe"] == [I] * 4 + [P, P]
    for src, names in (("cg_kernels.cu", ("cfd_cg_solve_cluster",
                                          "cfd_barrier_probe")),
                       ("bicgstab_kernels.cu", ("cfd_bicg_solve_cluster",))):
        code = _code(native.CSRC / src)
        extern = code[code.index('extern "C"'):]
        for name in names:
            assert re.search(rf"int {name}\(", extern), name
    engine = _code(ENGINE)
    assert ENGINE in native._sources()
    assert "cudaOccupancyMaxActiveClusters" in engine
    assert "cudaFuncAttributeNonPortableClusterSizeAllowed" in engine
    assert "cudaLaunchKernelEx" in engine
    # a dot is pushes counted on the receiver's mbarrier, no barrier
    assert ("st.async.shared::cluster.mbarrier::complete_tx::bytes"
            in engine)
    assert "mbarrier.try_wait.parity.acquire.cluster" in engine
    for path in (ENGINE, native.CSRC / "cg_kernels.cu",
                 native.CSRC / "bicgstab_kernels.cu"):
        assert "atomicAdd" not in _code(path)


def _literal_dot(a, b, plan, wide):
    """The kernels' dot written out point by point in numpy: rank q's
    thread t sums its band points m = t, t + T, ... in order, each warp
    folds by the shuffle tree, warp 0 folds the 32 warp sums (zeros past
    the CTA's warps), then the ranks' partials in rank order."""
    dt = np.float64 if wide else np.float32
    prod = (a[0, 1:-1, 1:-1].astype(np.float64)
            * b[0, 1:-1, 1:-1].astype(np.float64)) if wide else \
        (a[0, 1:-1, 1:-1] * b[0, 1:-1, 1:-1])
    flat, mx = prod.reshape(-1), a.shape[2] - 2
    T = plan["threads"]

    def tree(v):
        v = list(v)
        for off in (16, 8, 4, 2, 1):
            for lane in range(off):
                v[lane] = dt(v[lane] + v[lane + off])
        return v[0]

    parts, start = [], 0
    for n in plan["rows_of"]:
        sums = []
        for t in range(T):
            acc = dt(0.0)
            for m in range(t, n * mx, T):
                acc = dt(acc + flat[start * mx + m])
            sums.append(acc)
        warps = [tree(sums[w * 32:(w + 1) * 32]) for w in range(T // 32)]
        parts.append(tree(warps + [dt(0.0)] * (32 - len(warps))))
        start += n
    total = parts[0]
    for p in parts[1:]:
        total = dt(total + p)
    return np.float32(total)


@pytest.mark.parametrize("wide", [False, True], ids=["float32", "float64"])
@pytest.mark.parametrize("shape", [(1, 9, 70), (1, 23, 37), (1, 20, 300)])
def test_cluster_dot_is_the_kernels_order(shape, wide):
    """cluster_dot equals the literal simulation bit for bit (one rank;
    two; eleven with bands of unequal rows and threads past a band's
    points)."""
    kind = "bicgstab" if wide else "cg"
    plan = vmem_small.krylov_cluster_plan(*shape, kind)
    rng = np.random.default_rng(2)
    a = rng.normal(0.0, 1.0, shape).astype(np.float32)
    b = rng.normal(0.0, 1.0, shape).astype(np.float32)
    dot = vmem_small.cluster_dot(plan, shape[1], shape[2], "cpu", wide)
    got = dot(torch.tensor(a), torch.tensor(b))
    assert got.dtype == torch.float32
    assert float(got) == _literal_dot(a, b, plan, wide)


@pytest.mark.parametrize("np_dt", [np.float32, np.float64],
                         ids=["float32", "float64"])
@pytest.mark.parametrize("shape", [(1, 23, 37), (1, 50, 100)],
                         ids=["37x23", "100x50"])
def test_cg_order_model_matches_plain(shape, np_dt):
    """The same iteration count and status as cg_solve_plain, x within
    phase 12's TOL_DOT (1e-5 of max|x|) in float32, 1e-12 in float64."""
    c = _consts("cg", shape)
    x0, rhs = (torch.tensor(f) for f in _inputs(shape, np_dt))
    args = (x0, rhs, c, 1e-5, 0.0, 1000)
    ref = vmem_small.cg_solve_plain(*args)
    got = vmem_small.cg_solve_cluster_ordered(*args)
    assert int(got[3]) == int(ref[3]) > 0
    assert bool(got[4]) == bool(ref[4]) is False
    tol = 1e-5 if np_dt == np.float32 else 1e-12
    scale = float(ref[0].abs().max())
    assert float((got[0] - ref[0]).abs().max()) <= tol * scale
    assert got[0].dtype == x0.dtype


@pytest.mark.parametrize("np_dt", [np.float32, np.float64],
                         ids=["float32", "float64"])
@pytest.mark.parametrize("case", ["smooth", "normal"])
@pytest.mark.parametrize("shape", [(1, 23, 37), (1, 50, 100)],
                         ids=["37x23", "100x50"])
def test_bicgstab_order_model_matches_plain(shape, case, np_dt):
    """B2's plain-path bars (phase 22): on sin·sin plus a little noise at
    tolerance 1e-2 from zero, ±3 iterations and x within 1e-3 of max|x|;
    on a normal rhs at 1e-5, both converged below tol·r0 within twice the
    plain loop's iterations and x within 5e-4."""
    c = _consts("bicgstab", shape)
    x0, rhs = _inputs(shape, np_dt)
    tol = 1e-5
    if case == "smooth":
        y = np.linspace(0.0, 1.0, shape[1])[:, None]
        x = np.linspace(0.0, 1.0, shape[2])[None, :]
        rhs = (np.sin(np.pi * y) * np.sin(np.pi * x))[None].astype(np_dt) \
            + np_dt(0.005) * rhs
        x0, tol = np.zeros(shape, np_dt), 1e-2
    args = (torch.tensor(x0), torch.tensor(rhs), c, tol, 0.0, 1000)
    ref = vmem_small.bicgstab_solve_plain(*args)
    got = vmem_small.bicgstab_solve_cluster_ordered(*args)
    it, it_ref = int(got[3]), int(ref[3])
    assert bool(got[4]) == bool(ref[4]) is False
    err = float((got[0] - ref[0]).abs().max())
    if case == "smooth":
        assert abs(it - it_ref) <= 3 and it_ref > 0
        assert err <= 1e-3 * float(ref[0].abs().max())
    else:
        assert 0 < it <= 2 * it_ref
        assert float(got[2]) < tol * float(got[1])
        assert err <= 5e-4
    assert got[0].dtype == args[0].dtype


REF_SHAPE = (1, 23, 37)
REF_KW = dict(tolerance=1e-5, abs_tol=0.0, max_iterations=1000,
              check_interval=1)


@pytest.fixture(scope="module")
def reference_solves():
    """The reference's whole-solve kernels in interpret mode, float32, on
    one input, built and run once."""
    nz, ny, nx = REF_SHAPE
    c = _consts("cg", REF_SHAPE)
    x0, rhs = _inputs(REF_SHAPE, np.float32)
    coef = (c.inv_dx2, c.inv_dy2, c.inv_dz2)
    out = {}
    cg = jvmem.make_cg_vmem_solve(nz, ny, nx, *coef, 1.0, *REF_KW.values(),
                                  dtype=jnp.float32, interpret=True)
    bi = jvmem.make_bicgstab_vmem_solve(nz, ny, nx, *coef, *REF_KW.values(),
                                        dtype=jnp.float32, interpret=True)
    for kind, fn in (("cg", cg), ("bicgstab", bi)):
        res = jax.jit(fn)(jnp.asarray(x0), jnp.asarray(rhs))
        out[kind] = [np.asarray(v) for v in res]
    return out, x0, rhs


@pytest.mark.parametrize("kind", KINDS)
def test_order_models_match_reference_kernels(kind, reference_solves):
    """Against the reference's make_cg_vmem_solve / make_bicgstab_vmem_
    solve in interpret mode (float32, 37×23): CG ±2 iterations and x
    within 1e-5 (the reference's own vmem bars, tests/math/test_vmem_
    small.py:105-136), BiCGSTAB at most twice its iterations and x within
    5e-4 (:141-162); the same running / stagnated flag."""
    ref, x0, rhs = reference_solves
    ref = ref[kind]
    c = _consts(kind, REF_SHAPE)
    model = vmem_small.cg_solve_cluster_ordered if kind == "cg" else \
        vmem_small.bicgstab_solve_cluster_ordered
    got = model(torch.tensor(x0), torch.tensor(rhs), c, REF_KW["tolerance"],
                REF_KW["abs_tol"], REF_KW["max_iterations"])
    it, it_ref = int(got[3]), int(ref[3])
    if kind == "cg":
        assert abs(it - it_ref) <= 2
        atol = 1e-5
    else:
        assert 0 < it <= 2 * it_ref
        atol = 5e-4
    assert bool(got[4]) == bool(ref[4])
    np.testing.assert_allclose(got[0].numpy(), ref[0], rtol=0, atol=atol)
    np.testing.assert_allclose(float(got[1]), float(ref[1]), rtol=1e-5)


@pytest.mark.parametrize("kind", KINDS)
def test_wrappers_run_plain_on_cpu(kind):
    """On a CPU tensor the wrappers run the plain loops (bit for bit) and
    count no launch; the cluster entry refuses a shape its plan sends to
    the grid-wide kernel, before any device is touched."""
    shape = (1, 23, 37)
    c = _consts(kind, shape)
    x0, rhs = (torch.tensor(f) for f in _inputs(shape, np.float32))
    wrap = vmem_small.cg_solve if kind == "cg" else vmem_small.bicgstab_solve
    plain = vmem_small.cg_solve_plain if kind == "cg" else \
        vmem_small.bicgstab_solve_plain
    before = (wrap.launches, wrap.cluster_launches)
    got = wrap(x0, rhs, c, 1e-5, 0.0, 50)
    ref = plain(x0, rhs, c, 1e-5, 0.0, 50)
    for a, b in zip(got, ref):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
    assert (wrap.launches, wrap.cluster_launches) == before
    solid = (5, 20, 30)
    c3 = _consts(kind, solid)
    z = torch.zeros(solid)
    cluster = vmem_small.cg_solve_cluster if kind == "cg" else \
        vmem_small.bicgstab_solve_cluster
    model = vmem_small.cg_solve_cluster_ordered if kind == "cg" else \
        vmem_small.bicgstab_solve_cluster_ordered
    for fn in (cluster, model):
        with pytest.raises(ValueError, match="a 3D volume"):
            fn(z, z, c3, 1e-5, 0.0, 10)
