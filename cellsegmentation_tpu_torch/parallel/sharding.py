"""The tensor-parallel rule, batch transfer and the collectives of a
data-parallel train step.

The JAX package hands GSPMD shardings to XLA, which inserts the
collectives: batches split over the ``data`` axis, the image heads' wide
Dense kernels over ``model``. Here each rank runs its local rows, and a
train step's collectives are explicit (train/steps.py): the global valid
count, the gradient all-reduce before the optimizer, the logged metrics,
and train-mode BatchNorm over the global batch (models/common.py).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from cellsegmentation_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh, distributed

# Linear weights at least this wide on the input dim split over 'model'
_MIN_TP_FAN_IN = 512


def spec_for(name: str, shape, model_size: int) -> tuple:
    """The JAX package's tensor-parallel rule on the port's names: a Linear
    ``weight`` ([fan_out, fan_in]; a flax kernel is [fan_in, fan_out])
    whose fan_in is at least 512 and divides by the model axis splits along
    fan_in, ``(None, "model")``; everything else is replicated, ``()``.
    The image heads' 2048-wide pooled feature is that split: each shard
    computes a partial product and a reduction sums them. The rule is not
    executed (parallel/mesh.py)."""
    shape = tuple(shape)
    if (model_size > 1 and name.endswith(".weight") and len(shape) == 2
            and shape[1] >= _MIN_TP_FAN_IN and shape[1] % model_size == 0):
        return (None, MODEL_AXIS)
    return ()


def shard_batch(batch: dict, device) -> dict:
    """This rank's local rows of a batch (from a process-sharded
    ``BatchIterator``), each array moved to ``device``. The global batch
    is the ranks' local batches in rank order; the steps reduce over it."""
    return {k: (v if torch.is_tensor(v) else torch.as_tensor(np.asarray(v))).to(device)
            for k, v in batch.items()}


def replicate_tree(mesh: Optional[Mesh], model: torch.nn.Module) -> torch.nn.Module:
    """Rank 0's parameters and buffers broadcast to every rank of ``mesh``,
    in place, so that every rank starts from the same weights and
    statistics. A no-op on one rank."""
    if distributed(mesh):
        with torch.no_grad():
            for t in (*model.parameters(), *model.buffers()):
                dist.broadcast(t.data, src=0, group=mesh.group)
    return model


def all_reduce_grads(mesh: Optional[Mesh], params) -> None:
    """Sum the gradients of ``params`` over ``mesh``'s ranks, in one
    flattened buffer. Each rank's loss is its local sum over the global
    count, so the sum is the global batch's gradient."""
    if not distributed(mesh):
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=mesh.group)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def all_reduce_sum(mesh: Optional[Mesh], values: dict) -> dict:
    """A dict of device scalars summed over ``mesh``'s ranks (one
    collective): each rank's share of a global mean becomes the mean."""
    if not distributed(mesh):
        return values
    stacked = torch.stack([v.detach().float() for v in values.values()])
    dist.all_reduce(stacked, group=mesh.group)
    return dict(zip(values, stacked.unbind()))


def global_count(mesh: Optional[Mesh], valid: torch.Tensor) -> torch.Tensor:
    """The number of valid rows of the global batch (f32 scalar, no grad)."""
    count = valid.detach().to(torch.float32).sum()
    if distributed(mesh):
        dist.all_reduce(count, group=mesh.group)
    return count


def global_rows(mesh: Optional[Mesh], n_local: int) -> tuple[int, slice]:
    """(global batch size, this rank's rows in it): the ranks' local batches
    are equal in size and lie in rank order."""
    if not distributed(mesh):
        return n_local, slice(0, n_local)
    return n_local * mesh.size, slice(mesh.rank * n_local, (mesh.rank + 1) * n_local)
