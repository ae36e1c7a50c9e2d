"""The MIL model: one encoder plus task heads, mode-switched forward.

This slice carries the encoder and the tile head (``mode="tile"``); the
image heads and the seg decoder come with the stage-1 and stage-3 slices of
the port. Parameter names mirror the reference's torch model
(``encoder.*`` holds torchvision's names, ``fc_tile.1.*`` the Linear), so
the JAX weight bridge (utils/jax_weights.py) and reference checkpoints map
onto them by name.
"""

from __future__ import annotations

import torch
from torch import nn

from cellsegmentation_tpu_torch.core.dtypes import DEFAULT_POLICY, Policy
from cellsegmentation_tpu_torch.models.common import TileHead, init_weights

MODES = ("image", "tile", "segment")

# Parameter partitions, the top-level module names (the JAX package's
# param-tree keys and the reference's state-dict prefixes)
ENCODER_KEY = "encoder"
TILE_KEY = "fc_tile"
IMAGE_CLS_KEY = "fc_image_cls"
IMAGE_REG_KEY = "fc_image_reg"
SEG_KEY = "seg_decoder"
PARTITIONS = (ENCODER_KEY, TILE_KEY, IMAGE_CLS_KEY, IMAGE_REG_KEY, SEG_KEY)
_LATER = {
    "image": "the stage-1 slice (image heads)",
    "segment": "the stage-3 slice (seg decoder)",
}


class MILNet(nn.Module):
    """Encoder + tile head. ``forward(x, mode="tile")``: NHWC normalized
    tiles [N, H, W, 3] -> f32 tile logits [N, 2]."""

    def __init__(self, encoder: nn.Module, num_tile_classes: int = 2,
                 policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.encoder = encoder
        self.policy = policy
        self.fc_tile = TileHead(encoder.out_channels, num_tile_classes, policy)

    def forward(self, x: torch.Tensor, mode: str = "tile") -> torch.Tensor:
        if mode not in MODES:
            raise ValueError(f"invalid mode {mode!r}; expected one of {MODES}")
        if mode != "tile":
            raise NotImplementedError(
                f"mode={mode!r} is not ported yet; it comes with {_LATER[mode]}"
            )
        x4 = self.encoder(x)[0]
        return self.fc_tile(x4)

    def set_trainable(self, partitions) -> None:
        """``requires_grad`` on for the named partitions' parameters, off for
        every other's. BatchNorm is untouched: the encoder runs on its
        running statistics in every mode this slice has."""
        missing = set(partitions) - {n for n, _ in self.named_children()}
        if missing:
            raise NotImplementedError(
                f"partitions {sorted(missing)} are not ported yet")
        for name, child in self.named_children():
            child.requires_grad_(name in partitions)


def init_milnet(model: MILNet, seed: int = 0) -> MILNet:
    """Seeded initialization from a ``torch.Generator`` (on the CPU, so the
    weights do not depend on the device the model later moves to)."""
    gen = torch.Generator().manual_seed(seed)
    init_weights(model, gen)
    return model.eval()
