"""cfd_tpu_torch — the PyTorch and CUDA port of cfd_tpu.

The JAX package ``cfd_tpu`` stays the reference; this package mirrors its
module paths (``cfd_tpu/ops/pallas/X.py`` → ``cfd_tpu_torch/ops/kernels/X.py``)
so each counterpart is easy to find.  It imports torch and numpy only —
never jax or cfd_tpu.

Ported so far: the Chorin projection step
(`solvers.ns.projection.make_projection_step`) on uniform 3D (nz ≥ 3)
and 2D grids with the reference's default CG pressure solve, BiCGSTAB,
Red-Black SOR, Jacobi, multigrid, or the exact spectral one at
``spectral_precision`` "highest" (IEEE fp32) or "high" (3xTF32), with the
lid cavity's boundary conditions (`boundary`); every Poisson method
through the front end (`solvers.poisson`: ``create_solver``,
``poisson_solve``), the spectral solver API (`solvers.poisson.spectral`);
the explicit integrators; the solver registry and the `Simulation`
facade; domain decomposition (`parallel`: meshes, shard communicators
in one process or over ``torch.distributed``, and the z-decomposed
spectral projection step, also through ``NSSolver(mesh=...)``).  Its
kernels (``csrc/``) run as hand-written CUDA for Hopper on a CUDA tensor
and as plain PyTorch on the CPU.

Every constructor takes an explicit ``device``; there is no global device
state.  CUDA kernels are compiled with ``nvcc`` at first use, never at
import, so every module imports on a machine without a GPU or a compiler.
"""

from . import config
from .core import CFDError, FlowField, Grid, Status

__version__ = "0.1.0"

__all__ = ["config", "CFDError", "FlowField", "Grid", "Status",
           "__version__"]
