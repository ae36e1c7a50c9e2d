"""The MIL model: one encoder plus task heads, mode-switched forward.

The encoder, the tile head (``mode="tile"``), the two image-count heads
(``mode="image"``) and the seg decoder (``mode="segment"``). Parameter
names mirror the reference's torch model (``encoder.*`` holds
torchvision's names, ``fc_tile.1.*`` the Linear, ``fc_image_*.1/.4/.5/.7``
the image MLPs or ``fc_image_*.2`` EfficientNet's single-Dense heads,
``seg_decoder.*`` the reference's top-level ``upconv1..8`` and
``seg_out_conv``), so the JAX weight bridge (utils/jax_weights.py) and
reference checkpoints map onto them by name. EfficientNet has no seg
decoder (the reference's segment mode is a dead ``pass`` there): its
segment mode raises, as the JAX package's does.

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
    BN_MOMENTUM,
    ImageHeadMLP,
    ImageHeadSimple,
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

    ``image_head_style`` picks the image heads: ``"mlp"`` (the ResNets')
    or ``"simple"`` (EfficientNet's). With ``supports_segment`` the model
    has a seg decoder, whose widths scale by the encoder block's expansion
    (4 for Bottleneck, 1 for BasicBlock), as the JAX package's registry
    sets its ``decoder_expansion``; without, segment mode raises.

    ``train`` puts every BatchNorm in train mode and turns dropout on, the
    encoder's BatchNorm (and EfficientNet's stochastic depth) unless
    ``freeze_encoder_stats``. ``dropout_masks`` (``{head name: masks}``,
    ``draw_masks``' tuples) fixes the image heads' dropout and
    ``sd_masks`` the encoder's stochastic depth; else the encoder draws
    its masks from ``generator`` first, then each head, the class head
    first."""

    def __init__(self, encoder: nn.Module, num_tile_classes: int = 2,
                 num_image_classes: int = 7, policy: Policy = DEFAULT_POLICY,
                 image_head_style: str = "mlp", supports_segment: bool = True):
        super().__init__()
        self.encoder = encoder
        self.policy = policy
        self.supports_segment = supports_segment
        c = encoder.out_channels
        head = {"mlp": ImageHeadMLP, "simple": ImageHeadSimple}[image_head_style]
        self.fc_tile = TileHead(c, num_tile_classes, policy)
        self.fc_image_cls = head(c, num_image_classes, policy=policy)
        self.fc_image_reg = head(c, 1, relu_out=True, policy=policy)
        if supports_segment:
            self.seg_decoder = SegDecoder(encoder.stage_channels,
                                          encoder.block_cls.expansion, policy)

    def _no_decoder(self) -> NotImplementedError:
        return NotImplementedError(
            f"{type(self.encoder).__name__} has no segmentation decoder")

    def forward(self, x: torch.Tensor, mode: str = "tile", train: bool = False,
                freeze_encoder_stats: bool = False, dropout_masks=None,
                generator=None, sd_masks=None):
        if mode not in MODES:
            raise ValueError(f"invalid mode {mode!r}; expected one of {MODES}")
        if mode == "segment" and not self.supports_segment:
            raise self._no_decoder()
        enc_train = train and not freeze_encoder_stats
        if enc_train and hasattr(self.encoder, "sd_blocks"):
            feats = self.encoder(x, train=True, sd_masks=sd_masks,
                                 generator=generator)
        else:
            feats = self.encoder(x, train=enc_train)
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
        package. Naming the seg decoder of a model without one raises, as
        its segment mode does."""
        if SEG_KEY in partitions and not self.supports_segment:
            raise self._no_decoder()
        missing = set(partitions) - {n for n, _ in self.named_children()}
        if missing:
            raise KeyError(f"unknown partitions {sorted(missing)}")
        for name, child in self.named_children():
            child.requires_grad_(name in partitions)


def init_milnet(model: MILNet, seed: int = 0) -> MILNet:
    """Seeded initialization from a ``torch.Generator`` (on the CPU, so the
    weights do not depend on the device the model later moves to)."""
    gen = torch.Generator().manual_seed(seed)
    init_weights(model, gen)
    return model.eval()


@torch.no_grad()
def settle_batch_stats(model: MILNet, x: torch.Tensor) -> MILNet:
    """Test and benchmark fixture utility: set every BatchNorm's running
    statistics to its batch statistics on one train-mode image forward of
    ``x`` (normalized NHWC images), dropout and stochastic depth keeping
    every row. A randomly initialized encoder's eval-mode activations then
    keep their scale through its depth: at EfficientNet's init (kaiming
    fan_out, as torchvision's) they shrink to ~1e-14 over B0's blocks,
    where no engine or device comparison reads anything. (Train mode
    normalizes by the batch alone, so zeroed running statistics come out
    of flax's update as (1 - momentum) x the batch's.)"""
    n, dev = x.shape[0], x.device
    gen = torch.Generator(device=dev)
    keep = {k: tuple(torch.ones_like(m) for m in getattr(model, k).draw_masks(n, gen, dev))
            for k in IMAGE_HEADS}
    sd = [torch.ones(n, dtype=torch.bool, device=dev)
          for _ in getattr(model.encoder, "sd_blocks", ())]
    bns = [m for m in model.modules() if isinstance(m, (nn.BatchNorm1d, nn.BatchNorm2d))]
    for bn in bns:
        bn.running_mean.zero_()
        bn.running_var.zero_()
    model(x, mode="image", train=True, dropout_masks=keep, sd_masks=sd)
    for bn in bns:
        bn.running_mean.div_(1 - BN_MOMENTUM)
        bn.running_var.div_(1 - BN_MOMENTUM)
    return model
