"""Domain decomposition (counterpart of `cfd_tpu/parallel/`): meshes,
shard communicators and the z-decomposed spectral projection step."""

from .comm import LocalComm, ProcessGroupComm
from .mesh import (Mesh, ShardedField, factor_devices, field_spec,
                   gather_field, make_mesh, replicate, shard_field)
from .sharded import make_sharded_raw_step, make_sharded_step

__all__ = ["factor_devices", "field_spec", "make_mesh", "replicate",
           "shard_field", "gather_field", "make_sharded_raw_step",
           "make_sharded_step", "Mesh", "ShardedField", "LocalComm",
           "ProcessGroupComm"]
