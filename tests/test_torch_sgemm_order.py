"""The IEEE fp32 SGEMM's surroundings on the CPU (`csrc/sgemm_fp32.cu`).

The CUDA kernel sums every output element as one ``fmaf`` chain over k,
ascending from zero, whatever the tile, the grid or the batch;
`chip_smoke.py` holds that on the card bit for bit.  Here, on the CPU:
the HIGHEST factors stored with rows padded to 16 bytes (so that the
kernel loads them by TMA) keep their values and leave the plain HIGHEST
steps bit-equal, the wrappers' load-path counters, and the C source's
TMA predicate and sum order against the wrappers'.  Inputs come from
``np.random.default_rng``; nothing is built.
"""

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

SRC = native.CSRC / "sgemm_fp32.cu"


@pytest.mark.parametrize("precision,dtype,cols,padded", [
    ("highest", torch.float32, 2046, True),     # the 2048² (·, my) factors
    ("highest", torch.float32, 510, True),      # the 512³ (·, mz) factors
    ("highest", torch.float32, 37, True),
    ("highest", torch.float32, 512, False),     # rows already 16 bytes
    ("highest", torch.float64, 2046, False),    # float64: the plain chain
    ("default", torch.float32, 2046, True),
    ("high", torch.float32, 2046, True),        # 3xTF32: TMA loads too
])
def test_tma_rows_pads_highest_factors(precision, dtype, cols, padded):
    """`_tma_rows` at "highest" (as at "high" and "default") stores a
    float32 factor with rows padded to a multiple of 4 floats and returns
    a view of its own shape and values; float64 keeps the tensor
    itself."""
    rng = np.random.default_rng(31)
    t = torch.tensor(rng.normal(size=(6, cols)), dtype=dtype)
    got = spectral._tma_rows(t, precision)
    assert got.shape == t.shape and got.dtype == t.dtype
    assert torch.equal(got, t)
    assert (got is t) is not padded
    assert got.stride() == ((-(-cols // 4) * 4 if padded else cols), 1)


def _tg(grid, seed):
    f = FlowField.initialize(grid, dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(seed)

    def noise(t):
        return t + torch.tensor(0.1 * rng.normal(size=tuple(t.shape)),
                                dtype=t.dtype)

    return f.replace(u=noise(f.u), v=noise(f.v), w=noise(f.w), p=noise(f.p))


def _highest_step(grid, monkeypatch, pad, mesh):
    """One plain-path HIGHEST FFT_DIRECT step (on ``mesh`` when given),
    with or without the padded factors."""
    if not pad:
        monkeypatch.setattr(spectral, "_tma_rows", lambda t, precision: t)
    params = NSParams(source_amplitude_u=0.0, source_amplitude_v=0.0,
                      mu=0.01)
    f0 = _tg(grid, 32)
    if mesh is None:
        step = make_projection_step(grid, params, torch.float32,
                                    Method.FFT_DIRECT, device="cpu")
        out = step(f0, 1e-4, 0)[0]
    else:
        from cfd_tpu_torch.parallel import gather_field, make_sharded_step
        step, place = make_sharded_step(grid, params, mesh, "projection")
        out = gather_field(step(place(f0), 1e-4, 0)[0])
    monkeypatch.undo()
    return out


@pytest.mark.parametrize("case", ["2d", "4y", "2x2"])
def test_padding_leaves_highest_steps_bit_equal(monkeypatch, case):
    """The HIGHEST step (the default precision) with the padded-row
    factors equals, bit for bit, the step with contiguous factors: the
    single-device 2D step (its rescue's Gyp), the 2D step over 4 y-shards
    (the slab solve's gy) and the 3D step over a (2, 2) mesh (gz and gy),
    each with a (·, m) factor whose rows are not a multiple of 4
    floats."""
    cpu = torch.device("cpu")
    if case == "2d":
        grid, mesh = Grid.uniform(1024, 36), None
    elif case == "4y":
        grid = Grid.uniform(64, 36)
        mesh = make_mesh([cpu] * 4, axes=("y",))
    else:
        grid = Grid.uniform(16, 8, 8, zmin=0.0, zmax=1.0)
        mesh = make_mesh([cpu] * 4)
    padded = _highest_step(grid, monkeypatch, True, mesh)
    plain = _highest_step(grid, monkeypatch, False, mesh)
    for name in "uvwp":
        assert torch.equal(getattr(padded, name), getattr(plain, name)), name


@pytest.mark.parametrize("precision", ["highest", "high", "default"])
def test_cp_async_counters_cpu_and_reset(precision):
    """On the CPU the wrappers run the plain products and count nothing,
    the load-path counters included; `reset_launch_counts` zeroes every
    counter of every precision."""
    rolling.reset_launch_counts()
    rng = np.random.default_rng(33)
    x = torch.tensor(rng.normal(size=(3, 5, 7)), dtype=torch.float32)
    r = torch.tensor(rng.normal(size=(7, 7)), dtype=torch.float32)
    lft = torch.tensor(rng.normal(size=(5, 5)), dtype=torch.float32)
    rolling.plane_dot(x, r, lft, precision)
    rolling.right_dot(x, r, precision)
    rolling.left_dot(lft, x, precision=precision)
    names = ("launches", "high_launches", "default_launches",
             "highest_cp_async_launches", "high_cp_async_launches",
             "default_cp_async_launches")
    for fn in rolling.WRAPPERS:
        assert all(getattr(fn, n) == 0 for n in names), fn.__name__
    rolling._count(rolling.right_dot, precision, tma=False)
    cp = rolling.CP_ASYNC_COUNTERS[precision]
    assert getattr(rolling.right_dot, cp) == 1
    assert getattr(rolling.right_dot, rolling._COUNTER[precision]) == 1
    rolling.reset_launch_counts()
    for fn in rolling.WRAPPERS:
        assert all(getattr(fn, n) == 0 for n in names), fn.__name__


def test_counter_names_follow_one_scheme():
    """One name a precision and path: ``<precision>_cp_async_launches``
    for the SGEMM, the 3xTF32 GEMM and the one-pass GEMM."""
    assert rolling.CP_ASYNC_COUNTERS == {
        p: f"{p}_cp_async_launches" for p in ("highest", "high", "default")}
    rolling._count(rolling.left_dot, "high", tma=True)
    assert rolling.left_dot.high_launches == 1
    assert rolling.left_dot.high_cp_async_launches == 0
    rolling.reset_launch_counts()


@pytest.mark.parametrize("args,tma", [
    ((0, 2048, 0, 4096, 512, 0, 1), True),        # the padded gy · slab
    ((0, 2046, 0, 4096, 512, 0, 1), False),       # gy packed: off 16 bytes
    ((0, 510, 0, 4096, 65536, 0, 1), False),      # gz packed
    ((16, 512, 0, 4096, 512, 512 * 512, 512), True),  # plane_dot's 2nd
    ((0, 37, 0, 4096, 37, 23 * 37, 11), False),   # 37×23×11
])
def test_sgemm_tma_predicate_is_the_sources(args, tma):
    """The launches counted on ``highest_cp_async_launches`` are those
    that `cfd_sgemm_batched` sends through the 4-byte copies: the same
    16-byte predicate as the one-pass GEMM's (bases, leading dimensions,
    batched strides)."""
    assert rolling._tma_operands(*args) is tma
    text = Path(SRC).read_text()
    assert ("const bool tma = aligned16(A) && lda % 4 == 0 && aligned16(B) &&"
            in text)
    assert "(batch == 1 || (sA % 4 == 0 && sB % 4 == 0));" in text


def test_sgemm_source_sums_one_fmaf_chain():
    """The source's mainloop is one fmaf an output element a k-step,
    accumulated in place from zero; no atomics, no split of K, no tensor
    core instruction."""
    text = Path(SRC).read_text()
    code = re.sub(r"//[^\n]*", "", text)
    assert "acc[i][j] = fmaf(av, b[j], acc[i][j]);" in code
    assert "acc[i][j] = 0.0f;" in code
    for banned in ("atomicAdd", "wgmma", "mma.sync"):
        assert banned not in code, banned
    assert "cfd_sgemm_batched" in code and "cfd_sgemm_plan" in code
    assert "sgemm_kernel" not in (native.CSRC
                                  / "projection_kernels.cu").read_text()
