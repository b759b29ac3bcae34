"""Scale-out over ``torch.distributed`` (port of ``dynmm_tpu/parallel``):
the (data, model) mesh and its sharding rules (``mesh``), the collectives
with their gradients (``collectives``), starting the ranks (``launch``)
and device-local routed serving (``routing``)."""

from dynmm_tpu_torch.parallel.mesh import (
    MODEL_SHARDING_RULES,
    Mesh,
    ProcessShard,
    make_global_batch,
    make_mesh,
    param_spec,
    replicate,
    shard_batch,
    shard_params,
)

__all__ = [
    "make_mesh",
    "shard_batch",
    "make_global_batch",
    "ProcessShard",
    "shard_params",
    "param_spec",
    "replicate",
    "Mesh",
    "MODEL_SHARDING_RULES",
]
