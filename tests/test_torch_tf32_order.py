"""The one-pass TF32 GEMM's sum order (`rolling.tf32_sum_order`, the
formula of ``csrc/gemm_tf32.cu``) and the DEFAULT pieces' factors.

The CUDA kernel sums each output element's products in an order that is a
function of K alone, so a launch may split K across a cluster without
changing a bit; `chip_smoke.py` holds that on the card.  Here, on the CPU:
the helper's chunks, the C source's formula at the depths in use, the
plain rescue as columns of the plain full-width product, the padded-row
factors leaving the plain DEFAULT steps bit-equal, and the refusals.
Inputs come from ``np.random.default_rng``; nothing is built.
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
from cfd_tpu_torch.solvers.poisson.base import Method, PoissonProblem

torch.set_num_threads(min(2, torch.get_num_threads()))

SRC = native.CSRC / "gemm_tf32.cu"
# the depths of the DEFAULT products and D(K) at each
DEPTHS = {2048: 256, 2046: 256, 512: 64, 510: 64, 128: 32, 126: 32}


def _c_chunks(k: int, consts: dict):
    """``chunk_plan`` of the C source, on its own constants: (D, count)."""
    stages = -(-k // consts["kStageK"]) if k > 0 else 0
    q = -(-stages // consts["kMaxChunks"])
    q = max(1, min(consts["kMaxChunkStages"], q))
    return q * consts["kStageK"], -(-stages // q)


def _c_consts():
    text = Path(SRC).read_text()
    consts = {name: int(v) for name, v in re.findall(
        r"constexpr int (kStageK|kMaxChunks|kMaxChunkStages) = (\d+);",
        text)}
    assert set(consts) == {"kStageK", "kMaxChunks", "kMaxChunkStages"}
    # the formula the helper mirrors, as the source writes it
    assert "int depth = (stages + kMaxChunks - 1) / kMaxChunks;" in text
    return consts


@pytest.mark.parametrize("k", [0, 1, 7, 8, 31, 32, 33, 126, 128, 255, 256,
                               510, 512, 1000, 2046, 2048, 2049, 4096])
def test_sum_order_covers_k_in_chunks(k):
    """The chunks tile [0, K) in ascending order, each D deep but the
    last; D is a whole number of 32-deep stages; at most 8 chunks up to
    K = 2048 (a portable cluster can split them one a rank)."""
    d, chunks = rolling.tf32_sum_order(k)
    assert d % rolling.TF32_STAGE_K == 0 and 32 <= d <= 256
    assert [c[0] for c in chunks] == list(range(0, k, d))
    ends = [c[1] for c in chunks]
    assert ends == [min(k, c0 + d) for c0 in range(0, k, d)]
    assert (ends[-1] if chunks else 0) == k
    if k <= 2048:
        assert len(chunks) <= 8


def test_sum_order_is_a_function_of_k_alone():
    """The helper takes the depth and nothing else, and gives the same
    answer for the same K whatever was asked before."""
    assert list(inspect.signature(rolling.tf32_sum_order).parameters) == ["k"]
    first = {k: rolling.tf32_sum_order(k) for k in DEPTHS}
    for k in reversed(list(DEPTHS)):
        assert rolling.tf32_sum_order(k) == first[k]
    with pytest.raises(ValueError):
        rolling.tf32_sum_order(-1)


@pytest.mark.parametrize("k", sorted(DEPTHS))
def test_sum_order_is_the_c_formula(k):
    """At every DEFAULT depth in use the helper's D and chunk count are
    those of ``chunk_plan`` in ``csrc/gemm_tf32.cu`` (its constants read
    from the source): D(2048) = D(2046) = 256, D(512) = D(510) = 64,
    D(128) = D(126) = 32."""
    consts = _c_consts()
    assert (consts["kStageK"], consts["kMaxChunks"],
            consts["kMaxChunkStages"]) == (
        rolling.TF32_STAGE_K, rolling.TF32_MAX_CHUNKS,
        rolling.TF32_MAX_CHUNK_STAGES)
    d, chunks = rolling.tf32_sum_order(k)
    assert (d, len(chunks)) == _c_chunks(k, consts)
    assert d == DEPTHS[k]


@pytest.mark.parametrize("shape", [(30, 32, 1024, 128), (126, 128, 128, 126),
                                   (34, 36, 64, 32)],
                         ids=["1024x32", "128x128", "64x36"])
def test_rescue_plain_is_left_dot_columns(shape):
    """The plain rescue at "default" equals, bit for bit, the first K
    columns of the plain full-width product divided by λ after it (the
    relation the kernels hold on the card, chip_smoke.py's check (a))."""
    m, k, n, kk = shape
    rng = np.random.default_rng(20)
    left = torch.tensor(rng.normal(size=(m, k)), dtype=torch.float32)
    x = torch.tensor(rng.normal(size=(k, n)), dtype=torch.float32)
    lam = torch.tensor(rng.uniform(1.0, 1e3, size=(m, kk)),
                       dtype=torch.float32)
    got = rolling.rescue_dot_plain(left, x[:, :kk], lam, precision="default")
    full = rolling.left_dot_plain(left, x, precision="default")
    assert torch.equal(got, full[:, :kk] / lam)
    assert torch.equal(rolling.rescue_dot(left, x[:, :kk], lam,
                                          precision="default"), got)


def _no_padding(monkeypatch):
    monkeypatch.setattr(spectral, "_tma_rows", lambda t, precision: t)


def _ysolve_out(problem, precision, rhs):
    _, _, ysolve = spectral.make_dst2d_fused_pieces(
        problem, torch.float32, "cpu", precision=precision)
    return ysolve, ysolve(rhs)


def test_padded_factors_are_views_of_the_same_values(monkeypatch):
    """At "default" (as at "highest" and "high") the 2D rescue's (ny,
    my) inverse factor is stored with rows of a multiple of 4 floats
    (TMA's 16 bytes), a view of the same values."""
    ny, nx = 36, 64
    h = (1.0 / (nx - 1), 1.0 / (ny - 1))
    prob = PoissonProblem(nx, ny, 1, *h)
    rhs = torch.tensor(np.random.default_rng(21).normal(size=(1, ny, nx)),
                       dtype=torch.float32)
    ys, x = _ysolve_out(prob, "default", rhs)
    _, gyp, _ = ys.rescue
    assert gyp.shape == (ny, ny - 2) and gyp.stride() == (36, 1)
    assert _ysolve_out(prob, "high", rhs)[0].rescue[1].stride() == (36, 1)
    assert _ysolve_out(prob, "highest", rhs)[0].rescue[1].stride() == (36, 1)
    _no_padding(monkeypatch)
    ys0, x0 = _ysolve_out(prob, "default", rhs)
    assert ys0.rescue[1].is_contiguous()
    assert torch.equal(ys0.rescue[1], gyp)
    assert torch.equal(x0, x)


def _tg(grid, seed):
    f = FlowField.initialize(grid, dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(seed)

    def noise(t):
        return t + torch.tensor(0.1 * rng.normal(size=tuple(t.shape)),
                                dtype=t.dtype)

    return f.replace(u=noise(f.u), v=noise(f.v), w=noise(f.w), p=noise(f.p))


def _step_fields(grid, monkeypatch, pad, mesh=None):
    """One plain-path DEFAULT FFT_DIRECT step (on ``mesh`` when given),
    with or without the padded factors."""
    if not pad:
        _no_padding(monkeypatch)
    params = NSParams(source_amplitude_u=0.0, source_amplitude_v=0.0,
                      mu=0.01)
    f0 = _tg(grid, 22)
    if mesh is None:
        step = make_projection_step(grid, params, torch.float32,
                                    Method.FFT_DIRECT, device="cpu",
                                    spectral_precision="default")
        out = step(f0, 1e-4, 0)[0]
    else:
        from cfd_tpu_torch.parallel import gather_field, make_sharded_step
        step, place = make_sharded_step(grid, params, mesh, "projection",
                                        spectral_precision="default")
        out = gather_field(step(place(f0), 1e-4, 0)[0])
    monkeypatch.undo()
    return out


@pytest.mark.parametrize("case", ["2d", "4y", "2x2"])
def test_padding_leaves_default_steps_bit_equal(monkeypatch, case):
    """The DEFAULT step with the padded-row factors equals, bit for bit,
    the step with contiguous factors (what it gave before the padding):
    the single-device 2D step (Thomas + the rescue of the 128 lowest
    modes), the 2D step over 4
    y-shards (the slab solve's fy, gy) and the 3D step over a (2, 2)
    mesh (the dense z stage's fz, gz and the y stage's fy, gy), each with
    a (·, m) factor whose rows are not a multiple of 4 floats."""
    cpu = torch.device("cpu")
    if case == "2d":
        # 1024 wide: Thomas on every column and the dense rescue of 128
        grid, mesh = Grid.uniform(1024, 36), None
    elif case == "4y":
        grid = Grid.uniform(64, 36)
        mesh = make_mesh([cpu] * 4, axes=("y",))
    else:
        grid = Grid.uniform(16, 8, 8, zmin=0.0, zmax=1.0)
        mesh = make_mesh([cpu] * 4)
    padded = _step_fields(grid, monkeypatch, True, mesh)
    plain = _step_fields(grid, monkeypatch, False, mesh)
    for name in "uvwp":
        assert torch.equal(getattr(padded, name), getattr(plain, name)), name


@pytest.mark.parametrize("case", ["depth", "lam", "out", "rank"])
def test_default_rescue_refuses_with_padded_left(case):
    """A row-padded ``left`` is taken (the same bits as its contiguous
    copy); shapes that do not chain are refused as before."""
    rng = np.random.default_rng(23)
    buf = torch.tensor(rng.normal(size=(6, 8)), dtype=torch.float32)
    left = buf[:, :6]
    x = torch.tensor(rng.normal(size=(6, 3)), dtype=torch.float32)
    assert torch.equal(rolling.rescue_dot(left, x, precision="default"),
                       rolling.rescue_dot(left.contiguous(), x,
                                          precision="default"))
    kw = {}
    if case == "depth":
        x = torch.ones(5, 3)
    elif case == "lam":
        kw["lam"] = torch.ones(6, 4)
    elif case == "out":
        kw["out"] = torch.ones(3, 6)
    else:
        x = torch.ones(2, 6, 3)
    with pytest.raises(ValueError):
        rolling.rescue_dot(left, x, precision="default", **kw)


@pytest.mark.parametrize("args,tma", [
    ((0, 2048, 0, 4096, 2048, 0, 1), True),
    ((0, 2046, 0, 4096, 2048, 0, 1), False),      # A's rows off 16 bytes
    ((8, 2048, 0, 4096, 2048, 0, 1), False),      # A's base off 16 bytes
    ((0, 512, 0, 4096, 512, 512 * 512, 130), True),
    ((0, 512, 0, 4096, 512, 512 * 37, 3), True),  # a stride of 4 floats
    ((0, 512, 0, 4096, 512, 37, 3), False),       # B's batch stride
    ((0, 512, 0, 4096, 512, 37, 1), True),        # unbatched: unused
])
def test_tma_route_predicate(args, tma):
    """Which launches the wrappers count on ``default_cp_async_launches``:
    TMA needs 16-byte bases, leading dimensions and (batched) strides,
    as ``run_gemm`` in ``csrc/gemm_tf32.cu`` decides."""
    assert rolling._tma_operands(*args) is tma
    text = Path(SRC).read_text()
    assert ("const bool tma = aligned16(A) && lda % 4 == 0 && aligned16(B) &&"
            in text)
