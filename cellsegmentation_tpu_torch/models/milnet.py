"""The MIL model: one encoder plus task heads, mode-switched forward.

The encoder, the tile head (``mode="tile"``), the two image-count heads
(``mode="image"``) and the seg decoder (``mode="segment"``). Parameter
names mirror the reference's torch model (``encoder.*`` holds
torchvision's names, ``fc_tile.1.*`` the Linear, ``fc_image_*.1/.4/.5/.7``
the image MLPs, ``seg_decoder.*`` the reference's top-level ``upconv1..8``
and ``seg_out_conv``), so the JAX weight bridge (utils/jax_weights.py) and
reference checkpoints map onto them by name.

BatchNorm per stage, as in the JAX package: stage 1 runs everything in
train mode (``train=True``: batch statistics, running ones updated);
stage 2 runs the encoder on its running statistics
(``freeze_encoder_stats=True``, or the tile step's no-grad encoder call);
stage 3 runs encoder and decoder in train mode, the encoder's parameters
frozen but its statistics moving, as the reference trains in
``module.train()`` mode.
"""

from __future__ import annotations

import torch
from torch import nn

from cellsegmentation_tpu_torch.core.dtypes import DEFAULT_POLICY, Policy
from cellsegmentation_tpu_torch.models.common import (
    ImageHeadMLP,
    SegDecoder,
    TileHead,
    init_weights,
)
from cellsegmentation_tpu_torch.ops.pooling import global_avg_max_pool

MODES = ("image", "tile", "segment")

# Parameter partitions, the top-level module names (the JAX package's
# param-tree keys and the reference's state-dict prefixes)
ENCODER_KEY = "encoder"
TILE_KEY = "fc_tile"
IMAGE_CLS_KEY = "fc_image_cls"
IMAGE_REG_KEY = "fc_image_reg"
SEG_KEY = "seg_decoder"
PARTITIONS = (ENCODER_KEY, TILE_KEY, IMAGE_CLS_KEY, IMAGE_REG_KEY, SEG_KEY)
IMAGE_HEADS = (IMAGE_CLS_KEY, IMAGE_REG_KEY)


class MILNet(nn.Module):
    """Encoder + tile head + image-count heads + seg decoder.

    ``forward(x, mode, train=False, freeze_encoder_stats=False)`` on NHWC
    normalized images [N, H, W, 3]:

    - ``mode="tile"``    -> f32 tile logits [N, 2];
    - ``mode="image"``   -> (f32 class logits [N, 7], f32 counts [N, 1]);
    - ``mode="segment"`` -> f32 seg logits [N, H, W, 2].

    The decoder's widths scale by the encoder block's expansion (4 for
    Bottleneck, 1 for BasicBlock), as the JAX package's registry sets its
    ``decoder_expansion``.

    ``train`` puts every BatchNorm in train mode and turns dropout on, the
    encoder's BatchNorm unless ``freeze_encoder_stats``. ``dropout_masks``
    (``{head name: (mask0, mask1)}``) fixes the image heads' dropout; else
    each head draws its masks from ``generator``, the class head first."""

    def __init__(self, encoder: nn.Module, num_tile_classes: int = 2,
                 num_image_classes: int = 7, policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.encoder = encoder
        self.policy = policy
        c = encoder.out_channels
        self.fc_tile = TileHead(c, num_tile_classes, policy)
        self.fc_image_cls = ImageHeadMLP(c, num_image_classes, policy=policy)
        self.fc_image_reg = ImageHeadMLP(c, 1, relu_out=True, policy=policy)
        self.seg_decoder = SegDecoder(encoder.stage_channels,
                                      encoder.block_cls.expansion, policy)

    def forward(self, x: torch.Tensor, mode: str = "tile", train: bool = False,
                freeze_encoder_stats: bool = False, dropout_masks=None,
                generator=None):
        if mode not in MODES:
            raise ValueError(f"invalid mode {mode!r}; expected one of {MODES}")
        feats = self.encoder(x, train=train and not freeze_encoder_stats)
        x4 = feats[0]
        if mode == "tile":
            return self.fc_tile(x4)
        if mode == "segment":
            return self.seg_decoder(feats, out_hw=(x.shape[1], x.shape[2]),
                                    train=train)
        pooled = global_avg_max_pool(x4)
        masks = dropout_masks or {}
        return tuple(
            getattr(self, k)(pooled, train, masks.get(k), generator)
            for k in IMAGE_HEADS
        )

    def set_trainable(self, partitions) -> None:
        """``requires_grad`` on for the named partitions' parameters, off for
        every other's. BatchNorm statistics are not parameters: a frozen
        partition run in train mode still updates them, as in the JAX
        package."""
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
