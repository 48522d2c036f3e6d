"""Domain decomposition (counterpart of `cfd_tpu/parallel/`): meshes,
shard communicators, the z-decomposed projection steps (spectral, CG,
BiCGSTAB), the (z, y)-decomposed ones (spectral, CG, BiCGSTAB), the
y-decomposed 2D spectral step, all of them with the energy equation and
buoyancy (the energy post-step on shard blocks, `thermal`), the
decomposed explicit steps (Euler, RK2, RK4 over z, (z, y) and 2D y
meshes), the projection step with the decomposed multigrid pressure
solve (z and (z, y) meshes), and the sharded Krylov and multigrid
solves."""

from .comm import LocalComm, ProcessGroupComm
from .fused_bicgstab import (bicgstab_fused_sharded_unsupported_reason,
                             make_bicgstab_fused_sharded,
                             make_bicgstab_fused_sharded_local)
from .fused_cg import (cg_fused_sharded_unsupported_reason,
                       make_cg_fused_sharded, make_cg_fused_sharded_local)
from .fused_explicit import (fused_sharded_euler_unsupported_reason,
                             fused_sharded_rk_unsupported_reason,
                             make_fused_sharded_euler_step,
                             make_fused_sharded_rk_step)
from .fused_mg import (make_multigrid_sharded,
                       mg_fused_sharded_unsupported_reason)
from .mesh import (Mesh, ShardedField, factor_devices, field_spec,
                   gather_field, make_mesh, mesh_y_size, mesh_zy_sizes,
                   replicate, shard_field)
from .sharded import make_sharded_raw_step, make_sharded_step
from .thermal import make_sharded_thermal_post

__all__ = ["factor_devices", "field_spec", "make_mesh", "replicate",
           "shard_field", "gather_field", "make_sharded_raw_step",
           "make_sharded_step", "Mesh", "ShardedField", "LocalComm",
           "ProcessGroupComm", "cg_fused_sharded_unsupported_reason",
           "make_cg_fused_sharded", "make_cg_fused_sharded_local",
           "bicgstab_fused_sharded_unsupported_reason",
           "make_bicgstab_fused_sharded",
           "make_bicgstab_fused_sharded_local",
           "fused_sharded_euler_unsupported_reason",
           "fused_sharded_rk_unsupported_reason",
           "make_fused_sharded_euler_step", "make_fused_sharded_rk_step",
           "mesh_y_size", "mesh_zy_sizes", "make_multigrid_sharded",
           "mg_fused_sharded_unsupported_reason",
           "make_sharded_thermal_post"]
