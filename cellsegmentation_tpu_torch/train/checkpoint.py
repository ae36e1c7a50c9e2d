"""Checkpoints: the port writes torch files and reads those and the JAX
package's flax msgpack ones, with partition-filtered stage handoff.

The payload is the JAX package's (and the reference's): a dict of
``mode``, ``epoch``, ``encoder``, ``step``, ``state_dict``, ``optimizer``
and ``extra``, written with ``torch.save`` as plain dicts of tensors.
``state_dict`` is the model's, filtered to the stage's partitions by key
prefix:

- saving "image" (pt1) keeps {encoder, fc_image_cls, fc_image_reg};
- saving "tile" (pt2) adds fc_tile; "segment" (pt3) adds seg_decoder;
- loading merges the file's entries into the target state dict and keeps
  the model's own values where the file has none (the reference's
  ``strict=False``: missing heads never fail); ``restore_into`` merges only
  the named partitions (the stage-1 -> stage-2 handoff, and the count
  CLI's load). A file in the reference's flat layout (``conv1.weight``,
  ``layer1.*``, ``upconv<k>.*``) is mapped onto the port's ``encoder.`` /
  ``seg_decoder.`` names first (utils/torch_convert.py). An entry that
  lands on no model entry, or a named partition the file fills no entry
  of, raises: a load never drops weights silently.

``optimizer`` is ``optimizer.state_dict()``. Schedules are pure functions
of the step, so only the step counter is stored.

``load_checkpoint`` tells the two formats apart by content (both packages
name their files ``.ckpt``): a torch file is a zip, a JAX one a msgpack
map (utils/flax_msgpack.py). A JAX file comes back as the port's payload:
``state_dict`` in the port's names (utils/jax_weights.py, an
EfficientNet's blocks placed by its registry entry's stage depths), the
other fields as written, and ``optimizer`` as a ``JaxOptimizerState``,
which the trainers convert to their torch optimizer's state where the
model and stage are known. A JAX subtree the port has no counterpart of, a
truncated file or a file of neither format raises. ``save_jax_checkpoint``
writes the JAX package's file of a port model and optimizer.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence

import torch

from cellsegmentation_tpu_torch.models import encoder_stage_depths
from cellsegmentation_tpu_torch.models.milnet import (
    ENCODER_KEY,
    IMAGE_CLS_KEY,
    IMAGE_REG_KEY,
    SEG_KEY,
    TILE_KEY,
)
from cellsegmentation_tpu_torch.utils.flax_msgpack import packb, unpackb
from cellsegmentation_tpu_torch.utils.jax_weights import (
    jax_to_state_dict,
    state_dict_to_jax,
    torch_to_optax,
)
from cellsegmentation_tpu_torch.utils.torch_convert import (
    is_reference_layout,
    reference_to_port,
)
from torch import nn

STAGE_SAVE_PARTITIONS = {
    "image": (ENCODER_KEY, IMAGE_CLS_KEY, IMAGE_REG_KEY),  # pt1
    "tile": (ENCODER_KEY, IMAGE_CLS_KEY, IMAGE_REG_KEY, TILE_KEY),  # pt2
    "segment": (ENCODER_KEY, IMAGE_CLS_KEY, IMAGE_REG_KEY, TILE_KEY, SEG_KEY),  # pt3
}
STAGE_PREFIX = {"image": "pt1", "tile": "pt2", "segment": "pt3"}
JAX_FIELDS = ("mode", "epoch", "encoder", "step", "state_dict", "optimizer", "extra")


@dataclasses.dataclass
class JaxOptimizerState:
    """A JAX checkpoint's optimizer: ``flax.serialization.to_state_dict`` of
    its optax state, nested dicts of numpy leaves
    (``utils.jax_weights.optax_to_torch`` converts it)."""

    tree: dict


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
    path = _ckpt_path(path_or_dir, mode, epoch, prefix)
    torch.save(payload, path)
    return path


def _ckpt_path(path_or_dir: str, mode: str, epoch: int, prefix: Optional[str]) -> str:
    if os.path.isdir(path_or_dir) or not path_or_dir.endswith(".ckpt"):
        os.makedirs(path_or_dir, exist_ok=True)
        return os.path.join(
            path_or_dir, f"{prefix or STAGE_PREFIX[mode]}_{epoch}epochs.ckpt"
        )
    return path_or_dir


def save_jax_checkpoint(path_or_dir: str, mode: str, epoch: int, encoder: str,
                        model: nn.Module, optimizer=None, step: int = 0,
                        extra: Optional[dict] = None,
                        prefix: Optional[str] = None) -> str:
    """Write the file the JAX package's ``save_checkpoint`` writes for the
    same state: ``model``'s stage partitions in the JAX layout and
    ``optimizer`` (an Adam or SGD over ``model``'s trainable parameters) as
    its optax state, flax msgpack. Paths as ``save_checkpoint``'s."""
    payload = {
        "mode": mode,
        "epoch": epoch,
        "encoder": encoder,
        "step": step,
        "state_dict": state_dict_to_jax(model, STAGE_SAVE_PARTITIONS[mode]),
        "optimizer": None if optimizer is None else torch_to_optax(optimizer, model),
        "extra": extra or {},
    }
    path = _ckpt_path(path_or_dir, mode, epoch, prefix)
    with open(path, "wb") as f:
        f.write(packb(payload))
    return path


def _is_msgpack_map(head: bytes) -> bool:
    return bool(head) and (0x80 <= head[0] <= 0x8F or head[0] in (0xDE, 0xDF))


def load_checkpoint(path: str) -> dict:
    """A checkpoint's payload, every tensor on the CPU: a torch file as
    written, a JAX one converted (module docstring)."""
    with open(path, "rb") as f:
        head = f.read(4)
    if head == b"PK\x03\x04":
        return torch.load(path, map_location="cpu", weights_only=True)
    if not _is_msgpack_map(head):
        raise ValueError(f"{path} is neither a torch checkpoint (a zip) nor a JAX "
                         f"one (a msgpack map): it opens with {head!r}")
    with open(path, "rb") as f:
        raw = unpackb(f.read())
    missing = [k for k in JAX_FIELDS if k not in raw]
    if missing:
        raise ValueError(f"{path}: a msgpack file without the JAX checkpoint's {missing}")
    sd, skipped = jax_to_state_dict(raw["state_dict"], encoder_stage_depths(raw["encoder"]))
    if skipped:
        raise ValueError(f"{path}: the JAX subtree(s) {skipped} have no counterpart "
                         "in the port's model")
    opt = raw["optimizer"]
    return {**{k: raw[k] for k in JAX_FIELDS}, "state_dict": sd,
            "optimizer": None if opt is None else JaxOptimizerState(opt)}


def merge_loaded(target: dict, loaded: dict) -> dict:
    """``strict=False``: a copy of the ``target`` state dict with every entry
    the file also has replaced by the file's, and the file's other entries
    added (a load hook may consume them: ``UpConv``'s conv bias)."""
    return {**target, **loaded}


def _stray_entries(model: nn.Module, loaded: dict) -> list:
    """The file entries that land on no entry of ``model``: neither one of
    its state-dict names nor a key a module's load consumes
    (``FOLDED_KEYS``)."""
    known = set(model.state_dict())
    known |= {f"{name}.{key}" for name, m in model.named_modules()
              for key in getattr(m, "FOLDED_KEYS", ())}
    return sorted(k for k in loaded if k not in known)


def restore_into(model: nn.Module, ckpt: dict,
                 partitions: Optional[Sequence[str]] = None) -> nn.Module:
    """Copy a checkpoint payload's ``state_dict`` into ``model`` in place,
    only the entries of ``partitions`` (top-level module names) when given,
    every entry the file has otherwise; the model keeps its own values
    where the file has none. A reference-layout file is mapped onto the
    port's names first. Raises, listing them, on file entries that land on
    no model entry, and on a named partition the file fills no entry of.
    Returns the model."""
    loaded = ckpt["state_dict"]
    if is_reference_layout(loaded):
        loaded = reference_to_port(loaded)
    stray = _stray_entries(model, loaded)
    if stray:
        raise ValueError(
            f"{len(stray)} checkpoint entr{'y lands' if len(stray) == 1 else 'ies land'} "
            f"on no entry of the {type(model).__name__}: " + ", ".join(stray[:8])
            + ("..." if len(stray) > 8 else ""))
    if partitions is not None:
        loaded = {k: v for k, v in loaded.items()
                  if k.split(".", 1)[0] in partitions}
        empty = [p for p in partitions
                 if not any(k.split(".", 1)[0] == p for k in loaded)]
        if empty:
            raise ValueError(f"the checkpoint fills no entry of partition(s) {empty}")
    model.load_state_dict(merge_loaded(model.state_dict(), loaded))
    return model
