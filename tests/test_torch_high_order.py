"""The 3xTF32 GEMM's surroundings on the CPU (`csrc/gemm_3xtf32.cu`).

The CUDA kernel sums each output element's products in an order that is
a function of K alone (`rolling.high_sum_order`): 32-deep chunks summed
from zero by the tensor core, one IEEE add each into the running sum;
`chip_smoke.py` holds on the card that row slices, plane blocks, column
slices and the two load paths give the same bits.  Here, on the CPU: the
helper's chunks and the C source's constants and formula, the HIGH
factors stored with rows padded to 16 bytes (so that the kernel loads them
by TMA) leaving the plain HIGH steps bit-equal, the 3xTF32 route's TMA
predicate and its counters.  Inputs come from ``np.random.default_rng``;
nothing is built.
"""

import inspect
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from cfd_tpu_torch import FlowField, Grid
from cfd_tpu_torch.ops.kernels import native, rolling
from cfd_tpu_torch.parallel import make_mesh
from cfd_tpu_torch.solvers.ns.params import NSParams
from cfd_tpu_torch.solvers.ns.projection import make_projection_step
from cfd_tpu_torch.solvers.poisson import spectral
from cfd_tpu_torch.solvers.poisson.base import Method

torch.set_num_threads(min(2, torch.get_num_threads()))

SRC = native.CSRC / "gemm_3xtf32.cu"
# the depths of the HIGH products in use (the 2048² and 512³ transforms,
# their inverse factors, the 128² cavity, the small shapes)
DEPTHS = (2048, 2046, 512, 510, 128, 126, 37, 23, 11)


def _code():
    return re.sub(r"//[^\n]*", "", Path(SRC).read_text())


@pytest.mark.parametrize("k", [0, 1, 7, 8, 31, 32, 33, 126, 128, 510,
                               512, 1000, 2046, 2048, 2049])
def test_high_sum_order_tiles_k_in_ascending_chunks(k):
    """The chunks tile [0, K) in ascending order, each D = 32 deep but
    the last (the ragged tail of a stage)."""
    d, chunks = rolling.high_sum_order(k)
    assert d == rolling.HIGH_STAGE_K == 32
    assert [c[0] for c in chunks] == list(range(0, k, d))
    assert [c[1] for c in chunks] == [min(k, c0 + d)
                                      for c0 in range(0, k, d)]
    assert (chunks[-1][1] if chunks else 0) == k
    assert all(0 < c1 - c0 <= d for c0, c1 in chunks)


def test_high_sum_order_is_a_function_of_k_alone():
    """The helper takes the depth and nothing else, gives the same answer
    for the same K whatever was asked before, and refuses a negative
    depth."""
    assert list(inspect.signature(rolling.high_sum_order).parameters) == [
        "k"]
    first = {k: rolling.high_sum_order(k) for k in DEPTHS}
    for k in reversed(DEPTHS):
        assert rolling.high_sum_order(k) == first[k]
    with pytest.raises(ValueError):
        rolling.high_sum_order(-1)


@pytest.mark.parametrize("k", DEPTHS)
def test_high_sum_order_is_the_c_formula(k):
    """At every HIGH depth in use the helper's D and chunk count are the
    C source's: stages of ``kStageK`` (its constant read from the
    source), each one chunk (``kChunkK = kStageK``), the stage count
    ``(K + kStageK - 1) / kStageK``, the chunk summed from zero
    (``scale_d`` 0 on its first wgmma) and added into the running sum
    once a stage."""
    code = _code()
    stage = int(re.search(r"constexpr int kStageK = (\d+);", code)[1])
    assert stage == rolling.HIGH_STAGE_K
    assert "constexpr int kChunkK = kStageK;" in code
    assert "const int n_st = (p.K + kStageK - 1) / kStageK;" in code
    assert "wgmma_k8(acc, fs[j], d_big + 2 * j, j == 0 ? 0 : 1);" in code
    assert "for (int i = 0; i < kAcc; ++i) run[i] += acc[i];" in code
    d, chunks = rolling.high_sum_order(k)
    assert (d, len(chunks)) == (stage, -(-k // stage))


def test_high_source_is_wgmma_on_tma_stages():
    """The mainloop issues tf32 wgmma on stages that TMA fills, its CTAs
    walk the tiles persistently (steps of the grid), and nothing in it is
    a library GEMM, an atomic or the old mma.sync."""
    code = _code()
    assert '#include "wgmma_tf32.cuh"' in code
    helpers = re.sub(r"//[^\n]*", "",
                     (native.CSRC / "wgmma_tf32.cuh").read_text())
    assert "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32" in helpers
    assert "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32" in helpers
    assert "wgmma_k8(acc, fb[j], d_big + 2 * j, 1);" in code
    assert "tma_load(a_st + s * T::kAFloats, &map_a, &full[s]," in code
    assert "tile += tile_step" in code
    assert "const int tile_step = static_cast<int>(gridDim.x);" in code
    for banned in ("mma.sync", "atomicAdd", "cublas", "cutlass::gemm"):
        assert banned not in code + helpers, banned
    assert "cfd_sgemm_3xtf32_batched" in code
    assert "cfd_sgemm_3xtf32_plan" in code
    assert native.SIGNATURES["cfd_sgemm_3xtf32_plan"] == \
        native.SIGNATURES["cfd_sgemm_plan"]


@pytest.mark.parametrize("cols,padded", [(2046, True), (510, True),
                                         (37, True), (512, False)])
def test_tma_rows_pads_high_factors(cols, padded):
    """`_tma_rows` at "high" stores a float32 factor with rows padded to a
    multiple of 4 floats and returns a view of its own shape and values
    (the 2048² and 512³ inverse factors have rows of 2046 and 510)."""
    rng = np.random.default_rng(41)
    t = torch.tensor(rng.normal(size=(5, cols)), dtype=torch.float32)
    got = spectral._tma_rows(t, "high")
    assert got.shape == t.shape and torch.equal(got, t)
    assert (got is t) is not padded
    assert got.stride() == (-(-cols // 4) * 4, 1)


def _tg(grid, seed):
    f = FlowField.initialize(grid, dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(seed)

    def noise(t):
        return t + torch.tensor(0.1 * rng.normal(size=tuple(t.shape)),
                                dtype=t.dtype)

    return f.replace(u=noise(f.u), v=noise(f.v), w=noise(f.w), p=noise(f.p))


def _high_step(grid, monkeypatch, pad, mesh):
    """One plain-path HIGH FFT_DIRECT step (on ``mesh`` when given), with
    or without the padded factors."""
    if not pad:
        monkeypatch.setattr(spectral, "_tma_rows", lambda t, precision: t)
    params = NSParams(source_amplitude_u=0.0, source_amplitude_v=0.0,
                      mu=0.01)
    f0 = _tg(grid, 42)
    if mesh is None:
        step = make_projection_step(grid, params, torch.float32,
                                    Method.FFT_DIRECT, device="cpu",
                                    spectral_precision="high")
        out = step(f0, 1e-4, 0)[0]
    else:
        from cfd_tpu_torch.parallel import gather_field, make_sharded_step
        step, place = make_sharded_step(grid, params, mesh, "projection",
                                        spectral_precision="high")
        out = gather_field(step(place(f0), 1e-4, 0)[0])
    monkeypatch.undo()
    return out


@pytest.mark.parametrize("case", ["3d", "nz3", "2d", "4y", "2x2"])
def test_padding_leaves_high_steps_bit_equal(monkeypatch, case):
    """The plain HIGH step with the padded-row factors equals, bit for
    bit, the step with contiguous factors: the 3D step and the nz = 3
    step (square factors), the 2D step (its rescue's (ny, my) Gyp), the
    2D step over 4 y-shards (the slab solve's gy) and the 3D step over a
    (2, 2) mesh (gz and gy), the last three with a factor whose rows are
    not a multiple of 4 floats."""
    cpu = torch.device("cpu")
    mesh = None
    if case == "3d":
        grid = Grid.uniform(16, 12, 10, zmin=0.0, zmax=1.0)
    elif case == "nz3":
        grid = Grid.uniform(16, 12, 3, zmin=0.0, zmax=1.0)
    elif case == "2d":
        grid = Grid.uniform(1024, 36)
    elif case == "4y":
        grid = Grid.uniform(64, 36)
        mesh = make_mesh([cpu] * 4, axes=("y",))
    else:
        grid = Grid.uniform(16, 8, 8, zmin=0.0, zmax=1.0)
        mesh = make_mesh([cpu] * 4)
    padded = _high_step(grid, monkeypatch, True, mesh)
    plain = _high_step(grid, monkeypatch, False, mesh)
    for name in "uvwp":
        assert torch.equal(getattr(padded, name), getattr(plain, name)), name


@pytest.mark.parametrize("args,tma", [
    ((0, 2048, 0, 4096, 512, 0, 1), True),        # the padded gy · slab
    ((0, 2046, 0, 4096, 512, 0, 1), False),       # gy packed
    ((0, 510, 0, 4096, 65536, 0, 1), False),      # gz packed
    ((0, 512, 0, 4096, 65536, 0, 1), True),       # gz padded
    ((16, 512, 0, 4096, 512, 512 * 512, 512), True),  # plane_dot's 2nd
    ((0, 37, 0, 4096, 37, 23 * 37, 11), False),   # 37×23×11
    ((8, 512, 0, 4096, 512, 0, 1), False),        # A's base off 16 bytes
])
def test_high_route_counts_by_the_tma_predicate(monkeypatch, args, tma):
    """A 3xTF32 launch is counted on ``high_launches`` and, where its
    operands are off 16 bytes, on ``high_cp_async_launches``: the route's
    predicate is `_tma_operands`, the one ``cfd_sgemm_3xtf32_batched``
    applies (its text read from the source)."""
    calls = []
    monkeypatch.setattr(native, "launch",
                        lambda name, device, *a: calls.append((name, a)))
    rolling.reset_launch_counts()
    a, lda, sa, b, ldb, sb, batch = args
    rolling._gemm(rolling.left_dot, "high", "cuda", 64, 64, 64, a, lda, sa,
                  b, ldb, sb, 0, 64, 0, batch)
    assert calls and calls[0][0] == "cfd_sgemm_3xtf32_batched"
    assert rolling._tma_operands(*args) is tma
    assert rolling.left_dot.high_launches == 1
    assert rolling.left_dot.high_cp_async_launches == (0 if tma else 1)
    assert rolling.left_dot.launches == 0
    code = _code()
    assert ("const bool tma = aligned16(A) && lda % 4 == 0 && aligned16(B) &&"
            in code)
    assert "(batch == 1 || (sA % 4 == 0 && sB % 4 == 0));" in code
    rolling.reset_launch_counts()
    assert rolling.left_dot.high_cp_async_launches == 0


def test_high_wrappers_count_nothing_on_the_cpu():
    """On the CPU the HIGH wrappers run the plain products (the 3xTF32
    split summed in IEEE fp32) and the rescue at "high" too, and count
    nothing; `reset_launch_counts` zeroes ``high_cp_async_launches``."""
    rng = np.random.default_rng(43)
    x = torch.tensor(rng.normal(size=(3, 5, 7)), dtype=torch.float32)
    r = torch.tensor(rng.normal(size=(7, 7)), dtype=torch.float32)
    lft = torch.tensor(rng.normal(size=(5, 5)), dtype=torch.float32)
    rolling.reset_launch_counts()
    got = rolling.plane_dot(x, r, lft, "high")
    assert torch.equal(got, rolling.plane_dot_plain(x, r, lft, "high"))
    assert torch.equal(rolling.right_dot(x, r, "high"),
                       rolling.matmul_plain(x, r, "high"))
    rolling.left_dot(lft, x, precision="high")
    rolling.rescue_dot(lft, x[0], precision="high")
    for fn in rolling.WRAPPERS:
        assert fn.high_launches == fn.high_cp_async_launches == 0
    rolling.plane_dot.high_cp_async_launches = 3
    rolling.reset_launch_counts()
    for fn in rolling.WRAPPERS:
        assert fn.high_launches == fn.high_cp_async_launches == 0
