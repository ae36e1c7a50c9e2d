"""ResNet encoders. ``forward(x, train=False)``: BatchNorm on its running
statistics, or with ``train=True`` on the batch's, updating the running ones
(models/common.py ``batch_norm``).

Geometry: a 299x299 input -> conv1(7x7,s2,p3) 150 -> maxpool(3x3,s2,p1) 75 ->
layer1 75 -> layer2 38 -> layer3 19 -> layer4 10; a 32x32 tile ->
16/8/8/4/2/1. Module names follow torchvision (``conv1``, ``bn1``,
``layer3.0.conv2``, ``layer3.0.downsample.0/1``), so reference weights load
by name.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from cellsegmentation_tpu_torch.core.dtypes import DEFAULT_POLICY, Policy
from cellsegmentation_tpu_torch.models.common import ConvBNAct, conv_bn_act


def _conv(c_in, c_out, k, stride=1, groups=1):
    return nn.Conv2d(c_in, c_out, k, stride, k // 2, bias=False, groups=groups)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 policy: Policy = DEFAULT_POLICY, groups: int = 1,
                 base_width: int = 64):
        super().__init__()
        self.policy = policy
        self.conv1 = _conv(inplanes, planes, 3, stride)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = _conv(planes, planes, 3)
        self.bn2 = nn.BatchNorm2d(planes)
        self.downsample = None
        if stride != 1 or inplanes != planes:
            self.downsample = ConvBNAct(inplanes, planes, 1, stride, 0,
                                        use_relu=False, policy=policy)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        dt = self.policy.compute_dtype
        out = conv_bn_act(x, self.conv1, self.bn1, True, dt, train)
        out = conv_bn_act(out, self.conv2, self.bn2, False, dt, train)
        res = x if self.downsample is None else self.downsample(x, train)
        return F.relu(out + res)


class Bottleneck(nn.Module):
    """1x1 reduce -> 3x3 (grouped for ResNeXt) -> 1x1 expand x4."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 policy: Policy = DEFAULT_POLICY, groups: int = 1,
                 base_width: int = 64):
        super().__init__()
        self.policy = policy
        width = int(planes * (base_width / 64.0)) * groups
        out_ch = planes * self.expansion
        self.conv1 = _conv(inplanes, width, 1)
        self.bn1 = nn.BatchNorm2d(width)
        self.conv2 = _conv(width, width, 3, stride, groups)
        self.bn2 = nn.BatchNorm2d(width)
        self.conv3 = _conv(width, out_ch, 1)
        self.bn3 = nn.BatchNorm2d(out_ch)
        self.downsample = None
        if stride != 1 or inplanes != out_ch:
            self.downsample = ConvBNAct(inplanes, out_ch, 1, stride, 0,
                                        use_relu=False, policy=policy)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        dt = self.policy.compute_dtype
        out = conv_bn_act(x, self.conv1, self.bn1, True, dt, train)
        out = conv_bn_act(out, self.conv2, self.bn2, True, dt, train)
        out = conv_bn_act(out, self.conv3, self.bn3, False, dt, train)
        res = x if self.downsample is None else self.downsample(x, train)
        return F.relu(out + res)


class ResNetEncoder(nn.Module):
    """Stem + 4 stages on NHWC input; returns (x4, x3, x2, x1), NHWC."""

    def __init__(self, block_cls: type, stage_sizes: Sequence[int],
                 policy: Policy = DEFAULT_POLICY, groups: int = 1,
                 base_width: int = 64):
        super().__init__()
        self.block_cls = block_cls
        self.stage_sizes = tuple(stage_sizes)
        self.policy = policy
        self.groups = groups
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        inplanes = 64
        for stage, (planes, blocks) in enumerate(
            zip((64, 128, 256, 512), self.stage_sizes)
        ):
            layer = []
            for b in range(blocks):
                stride = 2 if (stage > 0 and b == 0) else 1
                layer.append(block_cls(inplanes, planes, stride, policy,
                                       groups, base_width))
                inplanes = planes * block_cls.expansion
            self.add_module(f"layer{stage + 1}", nn.Sequential(*layer))
        # channels of x1..x4, the seg decoder's skips
        self.stage_channels = tuple(p * block_cls.expansion
                                    for p in (64, 128, 256, 512))
        self.out_channels = inplanes

    def forward(self, x: torch.Tensor, train: bool = False):
        dt = self.policy.compute_dtype
        x = x.to(dt).permute(0, 3, 1, 2)  # NHWC -> NCHW view (channels_last)
        x = conv_bn_act(x, self.conv1, self.bn1, True, dt, train)
        x = F.max_pool2d(x, 3, 2, 1)
        feats = []
        for i in range(4):
            for block in getattr(self, f"layer{i + 1}"):
                x = block(x, train)
            feats.append(x.permute(0, 2, 3, 1))
        x1, x2, x3, x4 = feats
        return x4, x3, x2, x1
