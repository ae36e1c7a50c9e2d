"""Checkpoints in torch format, with partition-filtered stage handoff.

The payload is the JAX package's (and the reference's): a dict of
``mode``, ``epoch``, ``encoder``, ``step``, ``state_dict``, ``optimizer``
and ``extra``, written with ``torch.save`` as plain dicts of tensors.
``state_dict`` is the model's, filtered to the stage's partitions by key
prefix:

- saving "image" (pt1) keeps {encoder, fc_image_cls, fc_image_reg};
- saving "tile" (pt2) adds fc_tile; "segment" (pt3) adds seg_decoder;
- loading merges whatever entries the file has into the target state dict
  (the reference's ``strict=False``) and never fails on missing heads;
  ``restore_into`` merges only the named partitions (the stage-1 -> stage-2
  handoff, and the count CLI's load).

``optimizer`` is ``optimizer.state_dict()``. Schedules are pure functions
of the step, so only the step counter is stored. The port reads and writes
its own files only, not the JAX package's msgpack ones.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import torch

from cellsegmentation_tpu_torch.models.milnet import (
    ENCODER_KEY,
    IMAGE_CLS_KEY,
    IMAGE_REG_KEY,
    SEG_KEY,
    TILE_KEY,
)
from torch import nn

STAGE_SAVE_PARTITIONS = {
    "image": (ENCODER_KEY, IMAGE_CLS_KEY, IMAGE_REG_KEY),  # pt1
    "tile": (ENCODER_KEY, IMAGE_CLS_KEY, IMAGE_REG_KEY, TILE_KEY),  # pt2
    "segment": (ENCODER_KEY, IMAGE_CLS_KEY, IMAGE_REG_KEY, TILE_KEY, SEG_KEY),  # pt3
}
STAGE_PREFIX = {"image": "pt1", "tile": "pt2", "segment": "pt3"}


def _host(obj):
    """A copy of a nested state dict with every tensor moved to the CPU."""
    if torch.is_tensor(obj):
        return obj.detach().cpu().clone()
    if isinstance(obj, dict):
        return {k: _host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host(v) for v in obj)
    return obj


def save_checkpoint(path_or_dir: str, mode: str, epoch: int, encoder: str,
                    state_dict: dict, optimizer_state: Optional[dict] = None,
                    step: int = 0, extra: Optional[dict] = None,
                    prefix: Optional[str] = None) -> str:
    """Write ``<dir>/<prefix>_<epoch>epochs.ckpt`` (or the exact ``.ckpt``
    path given); ``prefix`` defaults to the stage's ptN name."""
    parts = STAGE_SAVE_PARTITIONS[mode]
    payload = {
        "mode": mode,
        "epoch": epoch,
        "encoder": encoder,
        "step": step,
        "state_dict": _host({k: v for k, v in state_dict.items()
                             if k.split(".", 1)[0] in parts}),
        "optimizer": _host(optimizer_state),
        "extra": extra or {},
    }
    if os.path.isdir(path_or_dir) or not path_or_dir.endswith(".ckpt"):
        os.makedirs(path_or_dir, exist_ok=True)
        path = os.path.join(
            path_or_dir, f"{prefix or STAGE_PREFIX[mode]}_{epoch}epochs.ckpt"
        )
    else:
        path = path_or_dir
    torch.save(payload, path)
    return path


def load_checkpoint(path: str) -> dict:
    """A checkpoint's payload, every tensor on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


def merge_loaded(target: dict, loaded: dict) -> dict:
    """``strict=False``: a copy of the ``target`` state dict with every entry
    the file also has replaced by the file's; entries only in the file are
    dropped."""
    return {k: loaded.get(k, v) for k, v in target.items()}


def restore_into(model: nn.Module, ckpt: dict,
                 partitions: Optional[Sequence[str]] = None) -> nn.Module:
    """Copy a checkpoint payload's ``state_dict`` into ``model`` in place,
    only the entries of ``partitions`` (top-level module names) when given,
    every entry the file has otherwise; the model keeps its own values
    elsewhere. Returns the model."""
    loaded = ckpt["state_dict"]
    if partitions is not None:
        loaded = {k: v for k, v in loaded.items()
                  if k.split(".", 1)[0] in partitions}
    model.load_state_dict(merge_loaded(model.state_dict(), loaded))
    return model
