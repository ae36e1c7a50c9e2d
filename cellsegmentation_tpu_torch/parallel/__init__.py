"""Multi-process data parallelism over ``torch.distributed`` (one process
per card): the bootstrap and sweep sharding (``multihost``), the mesh
handle (``mesh``) and the train steps' collectives (``sharding``)."""

from cellsegmentation_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    local_mesh_shape,
    make_mesh,
)
from cellsegmentation_tpu_torch.parallel.sharding import (
    replicate_tree,
    shard_batch,
    spec_for,
)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "Mesh",
    "local_mesh_shape",
    "make_mesh",
    "replicate_tree",
    "shard_batch",
    "spec_for",
]
