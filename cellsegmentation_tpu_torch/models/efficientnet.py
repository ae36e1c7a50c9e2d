"""EfficientNet-B0/B2 encoders: a stem conv, seven stages of MBConv blocks
(expand 1x1, depthwise kxk, squeeze-excite, project 1x1) with row-wise
stochastic depth, and a widening 1x1 to 4x the last stage's width.

``forward(x, train=False, sd_masks=None, generator=None)`` on NHWC input
returns (x4, x3, x2, x1), NHWC: the widened map at 1/32, and the outputs of
stages 5, 3 and 2 (1/16, 1/8, 1/4). BatchNorm runs on its running
statistics, or with ``train=True`` on the batch's, updating the running
ones (models/common.py ``batch_norm``). Convs run in the compute dtype,
BatchNorm and SiLU in f32 (the JAX package's ``_ConvNormSiLU``).

Module names follow torchvision's EfficientNet, which the reference model
embeds: ``features.0`` the stem, ``features.<s>.<j>.block.<k>`` block j of
stage s (``block`` holds the expand unit when there is one, then the
depthwise unit, ``SqueezeExcitation`` with ``fc1`` / ``fc2``, and the
project unit), ``features.8`` the widening 1x1. The reference's model file
is not in this repository, so these names are unchecked against a real
reference ``.pth``.

Stochastic depth (train mode only): each block with a residual whose drop
probability ``0.2 * block_id / total_blocks`` is above 0 scales its branch
by ``mask / keep``, one keep mask per row of the batch. The masks are
``sd_masks`` when given (one [N] mask per ``sd_blocks`` entry, in forward
order), else drawn from ``generator`` before the first conv.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from cellsegmentation_tpu_torch.core.dtypes import DEFAULT_POLICY, Policy
from cellsegmentation_tpu_torch.models.common import DenseConv2d, batch_norm

# (expand_ratio, kernel, stride, in_ch, out_ch, num_layers): the B0 table
STAGE_TABLE = (
    (1, 3, 1, 32, 16, 1),
    (6, 3, 2, 16, 24, 2),
    (6, 5, 2, 24, 40, 2),
    (6, 3, 2, 40, 80, 3),
    (6, 5, 1, 80, 112, 3),
    (6, 5, 2, 112, 192, 4),
    (6, 3, 1, 192, 320, 1),
)
# drop probability of the last block (torchvision's stochastic_depth_prob)
SD_PROB = 0.2


def _make_divisible(v: float, divisor: int = 8) -> int:
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def adjust_channels(channels: int, width_mult: float) -> int:
    return _make_divisible(channels * width_mult)


def adjust_depth(num_layers: int, depth_mult: float) -> int:
    return int(math.ceil(num_layers * depth_mult))


def stage_depths(depth_mult: float) -> tuple:
    """The MBConv blocks of each of the seven stages at ``depth_mult``."""
    return tuple(adjust_depth(row[5], depth_mult) for row in STAGE_TABLE)


class ConvNormSiLU(nn.Sequential):
    """Conv (no bias) + BatchNorm [+ SiLU]; keys ``0.weight`` / ``1.*`` as
    in torchvision's ``Conv2dNormActivation``. ``forward`` takes and
    returns an NCHW view in the compute dtype."""

    def __init__(self, c_in: int, c_out: int, kernel: int = 3, stride: int = 1,
                 groups: int = 1, act: bool = True,
                 policy: Policy = DEFAULT_POLICY):
        super().__init__(
            nn.Conv2d(c_in, c_out, kernel, stride, (kernel - 1) // 2,
                      groups=groups, bias=False),
            nn.BatchNorm2d(c_out, eps=1e-5),
        )
        self.act = act
        self.policy = policy

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        dt = self.policy.compute_dtype
        conv = self[0]
        y = F.conv2d(x.to(dt), conv.weight.to(dt), None, conv.stride,
                     conv.padding, 1, conv.groups)
        y = batch_norm(y.float(), self[1], train)
        if self.act:
            y = F.silu(y)
        return y.to(dt)


def _dense_1x1(x: torch.Tensor, conv: nn.Conv2d, dt: torch.dtype) -> torch.Tensor:
    """flax's biased 1x1 ``Conv(dtype=dt)`` on a pooled [N, C] vector:
    operands, kernel and bias in ``dt``."""
    w = conv.weight.to(dt).flatten(1)
    return F.linear(x.to(dt), w) + conv.bias.to(dt)


class SqueezeExcitation(nn.Module):
    """Spatial mean -> 1x1 (``fc1``, bias) -> SiLU -> 1x1 (``fc2``, bias) ->
    sigmoid, the gate multiplied into the map, all in the compute dtype
    (the mean summed in f32 and rounded, as ``jnp.mean`` of a bf16 map)."""

    def __init__(self, channels: int, squeeze: int,
                 policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.fc1 = DenseConv2d(channels, squeeze, 1)
        self.fc2 = DenseConv2d(squeeze, channels, 1)
        self.policy = policy

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.policy.compute_dtype
        s = x.float().mean(dim=(2, 3)).to(dt)
        s = F.silu(_dense_1x1(s, self.fc1, dt))
        s = torch.sigmoid(_dense_1x1(s, self.fc2, dt))
        return x * s[:, :, None, None]


def stochastic_depth(x: torch.Tensor, mask: torch.Tensor, prob: float) -> torch.Tensor:
    """Row-wise stochastic depth: ``x / keep * mask`` in ``x``'s dtype, the
    keep probability rounded to it first (a Python scalar takes the array's
    dtype in JAX)."""
    keep = torch.tensor(1.0 - prob, dtype=x.dtype, device=x.device)
    return x / keep * mask.to(x.dtype).view(-1, *([1] * (x.dim() - 1)))


class MBConv(nn.Module):
    """Expand 1x1 (when the expanded width differs from the input's) ->
    depthwise kxk (stride s) -> squeeze-excite (to ``in // 4``) -> project
    1x1 without activation [+ the input, where stride is 1 and the widths
    match]."""

    def __init__(self, expand_ratio: int, kernel: int, stride: int, c_in: int,
                 c_out: int, sd_prob: float, policy: Policy = DEFAULT_POLICY):
        super().__init__()
        expanded = adjust_channels(c_in, expand_ratio)
        layers = []
        if expanded != c_in:
            layers.append(ConvNormSiLU(c_in, expanded, 1, policy=policy))
        layers += [
            ConvNormSiLU(expanded, expanded, kernel, stride, groups=expanded,
                         policy=policy),
            SqueezeExcitation(expanded, max(1, c_in // 4), policy),
            ConvNormSiLU(expanded, c_out, 1, act=False, policy=policy),
        ]
        self.block = nn.Sequential(*layers)
        self.use_res = stride == 1 and c_in == c_out
        self.sd_prob = sd_prob
        self.kernel, self.stride, self.expanded = kernel, stride, expanded

    def forward(self, x: torch.Tensor, train: bool = False,
                sd_mask=None) -> torch.Tensor:
        inp = x
        for layer in self.block:
            x = layer(x) if isinstance(layer, SqueezeExcitation) else layer(x, train)
        if sd_mask is not None:
            x = stochastic_depth(x, sd_mask, self.sd_prob)
        return x + inp if self.use_res else x


class EfficientNetEncoder(nn.Module):
    """Stem 3x3 s2 -> seven MBConv stages -> widening 1x1 to
    ``feature_dim = 4 x`` the last stage's width; NHWC in, (x4, x3, x2, x1)
    NHWC out."""

    def __init__(self, width_mult: float = 1.0, depth_mult: float = 1.0,
                 policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.width_mult, self.depth_mult = width_mult, depth_mult
        self.policy = policy
        depths = stage_depths(depth_mult)
        self.stage_depths = depths
        total = sum(depths)
        stem = adjust_channels(STAGE_TABLE[0][3], width_mult)
        features = [ConvNormSiLU(3, stem, 3, 2, policy=policy)]
        block_id = 0
        for (t, k, s, c_in, c_out, _), n in zip(STAGE_TABLE, depths):
            c_in = adjust_channels(c_in, width_mult)
            c_out = adjust_channels(c_out, width_mult)
            stage = []
            for b in range(n):
                stage.append(MBConv(t, k, s if b == 0 else 1,
                                    c_in if b == 0 else c_out, c_out,
                                    SD_PROB * block_id / total, policy))
                block_id += 1
            features.append(nn.Sequential(*stage))
        self.feature_dim = 4 * adjust_channels(STAGE_TABLE[-1][4], width_mult)
        features.append(ConvNormSiLU(features[-1][-1].block[-1][0].out_channels,
                                     self.feature_dim, 1, policy=policy))
        self.features = nn.Sequential(*features)
        self.out_channels = self.feature_dim
        # the blocks in forward order, and the indices of those that drop
        self.blocks = [blk for stage in self.features[1:-1] for blk in stage]
        self.sd_blocks = tuple(i for i, blk in enumerate(self.blocks)
                               if blk.use_res and blk.sd_prob > 0)

    def draw_sd_masks(self, n: int, generator=None, device=None):
        """Keep masks [N] (bool) of the ``sd_blocks``, in forward order,
        drawn from ``generator`` (or the global generator of ``device``):
        ``floor(keep + U[0, 1))``, i.e. ``U >= prob``."""
        dev = device or self.features[0][0].weight.device
        return [torch.rand((n,), generator=generator, device=dev)
                >= self.blocks[i].sd_prob for i in self.sd_blocks]

    def block_masks(self, n: int, train: bool, sd_masks=None, generator=None,
                    device=None) -> list:
        """Each block's keep mask for a batch of ``n``, None where stochastic
        depth does not act: every block outside train mode, and every block
        outside ``sd_blocks``."""
        masks = [None] * len(self.blocks)
        if train:
            drawn = (self.draw_sd_masks(n, generator, device)
                     if sd_masks is None else sd_masks)
            for i, m in zip(self.sd_blocks, drawn, strict=True):
                masks[i] = m
        return masks

    def forward(self, x: torch.Tensor, train: bool = False, sd_masks=None,
                generator=None):
        dt = self.policy.compute_dtype
        x = x.to(dt).permute(0, 3, 1, 2)  # NHWC -> NCHW view (channels_last)
        masks = iter(self.block_masks(x.shape[0], train, sd_masks, generator,
                                      x.device))
        x = self.features[0](x, train)
        skips = []
        for stage in self.features[1:-1]:
            for blk in stage:
                x = blk(x, train, next(masks))
            skips.append(x)
        x = self.features[-1](x, train)
        # stage 2 ends at 1/4, stage 3 at 1/8, stage 5 at 1/16, x4 at 1/32
        return tuple(t.permute(0, 2, 3, 1) for t in (x, skips[4], skips[2], skips[1]))
