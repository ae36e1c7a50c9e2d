"""The ('data', 'model') mesh over the ranks of the process group.

The JAX package builds a 2-D device mesh: ``data`` shards the batch (and
the tile axis), ``model`` splits the image heads' wide Dense kernels. The
port runs one process per card, and its mesh is a small handle on the
process group the train steps reduce over.

The model axis is not executed. Splitting a 0.5 MB head across processes
would change no number (tensor parallelism splits a product's reduction),
so the port splits the batch over every rank: ``make_mesh`` checks the
JAX rule's shape against the ranks and returns a mesh over all of them,
and the trainers round their global batches up to the number of ranks
(the JAX rule's batch quantum, lcm(data axis, ranks), is that number).
The tensor-parallel rule itself is ported (parallel/sharding.py
``spec_for``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch.distributed as dist

from cellsegmentation_tpu_torch.parallel.multihost import process_count

DATA_AXIS = "data"
MODEL_AXIS = "model"


def local_mesh_shape(n_devices: int) -> tuple[int, int]:
    """The JAX package's (data, model) shape for ``n_devices``: a model axis
    of 2 once there are at least 4 (and an even count), else all data."""
    if n_devices >= 4 and n_devices % 2 == 0:
        return (n_devices // 2, 2)
    return (n_devices, 1)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks of ``group`` (None: the default group), which a train step
    reduces over. A mesh is a handle on the process's group, so copying a
    model that refers to it (BatchNorm's ``sync_mesh``) keeps the same
    mesh."""

    group: Optional[object] = None

    @property
    def size(self) -> int:
        return dist.get_world_size(self.group) if dist.is_initialized() else 1

    @property
    def rank(self) -> int:
        """This process's rank in ``group``."""
        return dist.get_rank(self.group) if dist.is_initialized() else 0

    def __deepcopy__(self, memo):
        return self


def make_mesh(data: Optional[int] = None, model: Optional[int] = None) -> Mesh:
    """The mesh over every rank of the process group (one rank without
    one). A (``data``, ``model``) shape that does not cover the ranks
    raises, as in the JAX package; one that does is data parallel over
    them all (module docstring)."""
    n = process_count()
    if data is None and model is None:
        data, model = local_mesh_shape(n)
    elif data is None:
        data = n // model
    elif model is None:
        model = n // data
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} processes")
    return Mesh()


def distributed(mesh: Optional[Mesh]) -> bool:
    """Whether ``mesh`` spans more than one rank (the steps' collectives run)."""
    return mesh is not None and mesh.size > 1
