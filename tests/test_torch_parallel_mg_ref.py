"""The red-black sweep's sharded modes against the reference's TPU kernel
in interpret mode, on the CPU.

``make_mg_rb_sweep(..., emit_residual=True, global_nz=…[, global_ny=…],
interpret=True)`` (`cfd_tpu/ops/pallas/mg_kernels.py:50-91`) on the halo
blocks it is built for — two halo planes a side, and on a (z, y) mesh four
halo rows, of a 17³ field padded to even shares (`cfd_tpu/parallel/
fused_mg.py:115-126`, `:322-343`) — against the port's plain twin
(``rb_sweep_inplace_plain(..., z_off, gnz[, y_off, gny])``) on the same
blocks, red-first with the residual, float32, at the reference-kernel bar
of ``tests/test_torch_multigrid.py`` (1e-6·max): x on every owned plane
and row, the residual on the owned planes but each shard's first and last
(the planes the reference patches after the kernel, its docstring
`:71-83`).  Two interpret builds, each made once a module: 2 z-shards, and
(2, 2).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_tpu.ops.pallas.mg_kernels import make_mg_rb_sweep, pad_dims
from cfd_tpu.solvers.poisson import multigrid as jmg
from cfd_tpu.solvers.poisson.base import PoissonProblem as JProblem
from cfd_tpu_torch.ops.kernels import mg_kernels as mgk
from cfd_tpu_torch.solvers.poisson import multigrid as mgs
from cfd_tpu_torch.solvers.poisson.base import PoissonProblem

torch.set_num_threads(min(2, torch.get_num_threads()))

N = 17
MESHES = {"z2": (2, 1), "zy22": (2, 2)}


def _share(n, shards):
    return -(-n // (2 * shards)) * 2


def _layout(mesh):
    """(pz, py, nzl, nyl, halo rows): the reference's block layout."""
    pz, py = MESHES[mesh]
    return (pz, py, _share(N, pz), _share(N, py) if py > 1 else N,
            4 if py > 1 else 0)


@functools.lru_cache(maxsize=None)
def _reference_sweep(mesh):
    """The reference's sharded sweep of this mesh's blocks, built once."""
    pz, py, nzl, nyl, hy = _layout(mesh)
    h = 1.0 / (N - 1)
    jlv = jmg._build_levels(JProblem(N, N, N, h, h, h))[0]
    kern = make_mg_rb_sweep(
        nzl + 4, nyl + 2 * hy, N, jlv.inv_dx2, jlv.inv_dy2, jlv.inv_dz2,
        jlv.inv_factor, True, jnp.float32, True, global_nz=N,
        **({"global_ny": N} if py > 1 else {}))
    assert kern is not None
    return jax.jit(kern)


def _system():
    h = 1.0 / (N - 1)
    prob = PoissonProblem(N, N, N, h, h, h)
    rng = np.random.default_rng(62)
    x = prob.zero_boundary(torch.tensor(
        rng.normal(0, 1, (N, N, N)).astype(np.float32)))
    b = torch.tensor(rng.normal(0, 1, (N, N, N)).astype(np.float32))
    return mgs._build_levels(prob)[0], x, b


def _block(a, mesh, shard):
    """Shard ``shard``'s block of ``a``: two halo planes a side (and four
    halo rows on a (z, y) mesh), zeros past the global ends."""
    pz, py, nzl, nyl, hy = _layout(mesh)
    ap = a.new_zeros((nzl * pz + 4, nyl * py + 2 * hy, N))
    ap[2:2 + N, hy:hy + N] = a
    zi, yi = divmod(shard, py)
    return ap[zi * nzl:(zi + 1) * nzl + 4,
              yi * nyl:(yi + 1) * nyl + 2 * hy].clone(), zi * nzl, yi * nyl


@pytest.mark.parametrize("mesh,shard", [("z2", 0), ("z2", 1),
                                        ("zy22", 0), ("zy22", 1),
                                        ("zy22", 2), ("zy22", 3)])
def test_sweep_modes_match_the_reference_kernel(mesh, shard):
    pz, py, nzl, nyl, hy = _layout(mesh)
    lv, x, b = _system()
    xb, g0, g0y = _block(x, mesh, shard)
    bb = _block(b, mesh, shard)[0]
    nyk = xb.shape[1]
    nyp, nxp = pad_dims(nyk, N)

    def pad(a):
        return jnp.pad(jnp.asarray(a.numpy()),
                       ((0, 0), (0, nyp - nyk), (0, nxp - N)))

    offs = (g0 - 2,) + ((g0y - hy,) if py > 1 else ())
    jx, jr = _reference_sweep(mesh)(pad(xb), pad(bb), *offs)
    jx = np.asarray(jx)[:, :nyk, :N]
    jr = np.asarray(jr)[:, :nyk, :N]
    rb = torch.empty_like(xb)
    mode = dict(z_off=g0 - 2, gnz=N)
    if py > 1:
        mode.update(y_off=g0y - hy, gny=N)
    mgk.rb_sweep_inplace_plain(xb, bb, lv, "red", rb, **mode)
    rows = slice(hy, hy + nyl)
    for name, got, ref, planes in (("x", xb, jx, slice(2, 2 + nzl)),
                                   ("r", rb, jr, slice(3, 1 + nzl))):
        ref = ref[planes, rows]
        np.testing.assert_allclose(got[planes, rows].numpy(), ref, rtol=0,
                                   atol=1e-6 * np.abs(ref).max(),
                                   err_msg=name)
