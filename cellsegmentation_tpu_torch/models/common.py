"""Shared model building blocks: the conv+BN(+ReLU) unit, the tile head,
the image-count heads (the MLP heads of the ResNets, the single-Dense heads
of EfficientNet) and the U-Net-style seg decoder.

Activations are NHWC at module boundaries (the JAX package's layout); a
module permutes to NCHW views internally, which for an NHWC-contiguous
tensor is PyTorch's ``channels_last`` format and costs no copy. Convs and
Dense layers run in the policy's compute dtype and BatchNorm in f32, as in
the JAX package.

BatchNorm in train mode (``train=True``) follows flax's ``BatchNorm(
momentum=0.9)``: it normalizes with the batch's own biased statistics and
moves the running ones by ``ra = 0.9 * ra + 0.1 * batch``, the variance
biased too (``F.batch_norm``'s own update would use the unbiased one and
the complement of the momentum, so the update is computed here).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from cellsegmentation_tpu_torch.core.dtypes import DEFAULT_POLICY, Policy
from cellsegmentation_tpu_torch.ops.pooling import global_avg_max_pool
from cellsegmentation_tpu_torch.ops.resize import resize_bilinear_align_corners


# flax's BatchNorm momentum: the share of the running statistics an update keeps
BN_MOMENTUM = 0.9


def batch_norm(x: torch.Tensor, bn: nn.Module, train: bool) -> torch.Tensor:
    """f32 BatchNorm over every axis but 1: on the running statistics, or in
    train mode on the batch's, updating the running ones in place."""
    if not train:
        return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight,
                            bn.bias, False, 0.0, bn.eps)
    # momentum 1 makes F.batch_norm write the batch's mean and unbiased
    # variance into these buffers; the flax update is made from them below
    mean = torch.zeros_like(bn.running_mean)
    var = torch.ones_like(bn.running_var)
    y = F.batch_norm(x, mean, var, bn.weight, bn.bias, True, 1.0, bn.eps)
    n = x.numel() // x.shape[1]
    with torch.no_grad():
        bn.running_mean.mul_(BN_MOMENTUM).add_(mean, alpha=1 - BN_MOMENTUM)
        bn.running_var.mul_(BN_MOMENTUM).add_(var * ((n - 1) / n),
                                              alpha=1 - BN_MOMENTUM)
    return y


def conv_bn_act(x: torch.Tensor, conv: nn.Conv2d, bn: nn.BatchNorm2d,
                relu: bool, dtype: torch.dtype, train: bool = False) -> torch.Tensor:
    """Conv (compute dtype, no bias) -> BatchNorm (f32; running stats, or
    the batch's in train mode) -> optional ReLU -> compute dtype. ``x`` is
    an NCHW view."""
    y = F.conv2d(x.to(dtype), conv.weight.to(dtype), None, conv.stride,
                 conv.padding, conv.dilation, conv.groups)
    y = batch_norm(y.float(), bn, train)
    if relu:
        y = F.relu(y)
    return y.to(dtype)


class ConvBNAct(nn.Sequential):
    """Conv(no bias) + BatchNorm + optional ReLU; the state-dict keys are
    ``0.weight`` / ``1.*`` as in torchvision's ``downsample`` Sequential."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 1, use_relu: bool = True,
                 groups: int = 1, policy: Policy = DEFAULT_POLICY):
        super().__init__(
            nn.Conv2d(c_in, c_out, kernel_size, stride, padding, bias=False,
                      groups=groups),
            nn.BatchNorm2d(c_out, eps=1e-5),
        )
        self.use_relu = use_relu
        self.policy = policy

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return conv_bn_act(x, self[0], self[1], self.use_relu,
                           self.policy.compute_dtype, train)


class TileHead(nn.Sequential):
    """avg+max pool -> Linear(2); keys ``1.weight`` / ``1.bias`` as in the
    reference's ``fc_tile = Sequential(Flatten, Linear)``."""

    def __init__(self, in_features: int, num_classes: int = 2,
                 policy: Policy = DEFAULT_POLICY):
        super().__init__(nn.Flatten(), nn.Linear(in_features, num_classes))
        self.policy = policy

    def forward(self, x4: torch.Tensor) -> torch.Tensor:
        """NHWC [N, h, w, C] features -> f32 logits [N, num_classes]."""
        dt = self.policy.compute_dtype
        pooled = global_avg_max_pool(x4).to(dt)
        lin = self[1]
        return (F.linear(pooled, lin.weight.to(dt)) + lin.bias.to(dt)).float()


def _dense(x: torch.Tensor, lin: nn.Linear, dt: torch.dtype) -> torch.Tensor:
    """flax ``Dense(dtype=dt)``: input, f32 kernel and bias cast to ``dt``."""
    return F.linear(x.to(dt), lin.weight.to(dt)) + lin.bias.to(dt)


class ImageHeadMLP(nn.Sequential):
    """BN1d -> Dropout(.25) -> ReLU -> Dense(64) -> BN1d -> Dropout(.5) ->
    Dense(out) [-> ReLU], on pooled features [N, C] -> f32 [N, out].

    The layers sit at the reference's ``Sequential(Flatten, BN1d, Dropout,
    ReLU, Linear, BN1d, Dropout, Linear[, ReLU])`` indices, so state-dict
    keys are ``.1`` / ``.4`` / ``.5`` / ``.7``. BatchNorm, dropout and ReLU
    run in f32, the Dense layers in the compute dtype.

    Dropout is ``where(keep_mask, x / keep, 0)`` as in flax. In train mode
    the keep masks are ``dropout_masks`` when given (a pair, [N, C] and
    [N, 64] bool), else drawn by ``draw_masks`` from ``generator``."""

    RATES = (0.25, 0.5)

    def __init__(self, in_features: int, out_features: int,
                 relu_out: bool = False, policy: Policy = DEFAULT_POLICY):
        layers = [nn.Flatten(), nn.BatchNorm1d(in_features, eps=1e-5),
                  nn.Dropout(self.RATES[0]), nn.ReLU(),
                  nn.Linear(in_features, 64), nn.BatchNorm1d(64, eps=1e-5),
                  nn.Dropout(self.RATES[1]), nn.Linear(64, out_features)]
        if relu_out:
            layers.append(nn.ReLU())
        super().__init__(*layers)
        self.relu_out = relu_out
        self.policy = policy

    def draw_masks(self, n: int, generator=None, device=None):
        """Keep masks of the two dropouts for a batch of ``n``, drawn in
        order from ``generator`` (or the global generator of ``device``)."""
        dev = device or self[4].weight.device
        widths = (self[1].num_features, self[5].num_features)
        return tuple(
            torch.rand((n, c), generator=generator, device=dev) >= rate
            for c, rate in zip(widths, self.RATES)
        )

    def forward(self, pooled: torch.Tensor, train: bool = False,
                dropout_masks=None, generator=None) -> torch.Tensor:
        dt = self.policy.compute_dtype
        x = batch_norm(pooled.float(), self[1], train)
        if train:
            masks = dropout_masks or self.draw_masks(x.shape[0], generator,
                                                     x.device)
            x = torch.where(masks[0], x / (1 - self.RATES[0]), 0.0)
        x = F.relu(x)
        x = batch_norm(_dense(x, self[4], dt).float(), self[5], train)
        if train:
            x = torch.where(masks[1], x / (1 - self.RATES[1]), 0.0)
        x = _dense(x, self[7], dt).float()
        return F.relu(x) if self.relu_out else x


class ImageHeadSimple(nn.Sequential):
    """Dropout(.3) -> Dense(out) [-> ReLU] on pooled features [N, C] -> f32
    [N, out]: EfficientNet's image heads.

    The layers sit at ``Sequential(Flatten, Dropout, Linear[, ReLU])``
    indices, ImageHeadMLP's convention with the Flatten at 0, so the
    state-dict keys are ``.2.weight`` / ``.2.bias``. Dropout runs in the
    features' dtype as ``where(keep_mask, x / keep, 0)`` (the keep rate
    rounded to that dtype, as flax's weak-typed scalar is), the Dense in
    the compute dtype. In train mode the keep mask is ``dropout_masks``
    when given (a 1-tuple, [N, C] bool), else drawn by ``draw_masks`` from
    ``generator``."""

    RATES = (0.3,)

    def __init__(self, in_features: int, out_features: int,
                 relu_out: bool = False, policy: Policy = DEFAULT_POLICY):
        layers = [nn.Flatten(), nn.Dropout(self.RATES[0]),
                  nn.Linear(in_features, out_features)]
        if relu_out:
            layers.append(nn.ReLU())
        super().__init__(*layers)
        self.relu_out = relu_out
        self.policy = policy

    def draw_masks(self, n: int, generator=None, device=None):
        """The dropout's keep mask for a batch of ``n``, as a 1-tuple, drawn
        from ``generator`` (or the global generator of ``device``)."""
        dev = device or self[2].weight.device
        return (torch.rand((n, self[2].in_features), generator=generator,
                           device=dev) >= self.RATES[0],)

    def forward(self, pooled: torch.Tensor, train: bool = False,
                dropout_masks=None, generator=None) -> torch.Tensor:
        x = pooled
        if train:
            (mask,) = dropout_masks or self.draw_masks(x.shape[0], generator,
                                                       x.device)
            keep = torch.tensor(1 - self.RATES[0], dtype=x.dtype, device=x.device)
            x = torch.where(mask, x / keep, 0.0)
        x = _dense(x, self[2], self.policy.compute_dtype).float()
        return F.relu(x) if self.relu_out else x


class DenseConv2d(nn.Conv2d):
    """A biased conv initialized as a Dense layer (``init_weights``): flax's
    default conv init, where the encoder's other convs take the
    kaiming one (the squeeze-excite 1x1s)."""


class UpConv(ConvBNAct):
    """A decoder ConvBNAct. The reference's ``upconv<k>`` is
    ``Sequential(Conv2d(bias=True), BN2d, ReLU)``; this conv has no bias
    (as in the JAX package: in train-mode BatchNorm its gradient is
    rounding noise), so a state dict that carries ``0.bias`` has it folded
    into the running mean as it loads: BN(conv + b) == BN'(conv) with
    mean' = mean - b, in both BatchNorm modes."""

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        bias = state_dict.pop(prefix + "0.bias", None)
        mean = prefix + "1.running_mean"
        if bias is not None and mean in state_dict:
            state_dict[mean] = state_dict[mean] - bias
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)


class SegDecoder(nn.Module):
    """Expanding path on the encoder's NHWC features (x4, x3, x2, x1): four
    align-corners bilinear upsamples (the first three to the skips' sizes,
    the fourth to twice x1's) interleaved with eight ``upconv`` units and
    three skip concats, a final upsample to the input size, then the
    2-channel 1x1 ``seg_out_conv`` with bias -> f32 logits [N, H, W, 2].

    Widths are the reference's ``base * expansion``, base (256, 256, 128,
    128, 64, 64, up7, 64) with ``up7 = 64 if expansion == 1 else 32 *
    expansion``; ``skip_channels`` are x1..x4's. Sizes come from the skips,
    so a 299^2 input upsamples 10 -> 19 -> 38 -> 75 -> 150 -> 299. Module
    names are the reference's ``upconv1..8`` and ``seg_out_conv``. Convs,
    resizes and concats run in the compute dtype, BatchNorm in f32."""

    def __init__(self, skip_channels, expansion: int = 1,
                 policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.policy = policy
        e = expansion
        c1, c2, c3, c4 = skip_channels
        up7 = 64 if e == 1 else 32 * e
        ins = (c4, 256 * e + c3, 256 * e, 128 * e + c2, 128 * e, 64 * e + c1,
               64 * e, up7)
        outs = (256 * e, 256 * e, 128 * e, 128 * e, 64 * e, 64 * e, up7, 64)
        for k, (ci, co) in enumerate(zip(ins, outs), 1):
            self.add_module(f"upconv{k}", UpConv(ci, co, policy=policy))
        self.seg_out_conv = nn.Conv2d(64, 2, 1)

    def _up(self, k: int, x: torch.Tensor, train: bool) -> torch.Tensor:
        """upconv<k> on an NHWC tensor (its NCHW view goes through)."""
        conv = getattr(self, f"upconv{k}")
        return conv(x.permute(0, 3, 1, 2), train).permute(0, 2, 3, 1)

    def forward(self, feats, out_hw, train: bool = False) -> torch.Tensor:
        x4, x3, x2, x1 = feats
        dt = self.policy.compute_dtype
        x = x4.to(dt)
        for k, skip in ((1, x3), (3, x2), (5, x1)):
            x = resize_bilinear_align_corners(x, skip.shape[1], skip.shape[2])
            x = self._up(k, x, train)
            x = self._up(k + 1, torch.cat([x, skip.to(dt)], dim=-1), train)
        x = resize_bilinear_align_corners(x, 2 * x1.shape[1], 2 * x1.shape[2])
        x = self._up(8, self._up(7, x, train), train)
        x = resize_bilinear_align_corners(x, out_hw[0], out_hw[1])
        conv = self.seg_out_conv
        y = F.conv2d(x.permute(0, 3, 1, 2), conv.weight.to(dt))
        y = y + conv.bias.to(dt).view(1, -1, 1, 1)
        return y.permute(0, 2, 3, 1).float()


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded initialization: convs kaiming-normal (fan_out, ReLU gain) with
    zero bias, BatchNorm identity (scale 1, bias 0, running stats 0/1),
    Linear weights and ``DenseConv2d`` kernels normal with std
    1/sqrt(fan_in) and zero bias."""
    for m in module.modules():
        if isinstance(m, DenseConv2d):
            fan_in = m.weight[0].numel()
            nn.init.normal_(m.weight, 0.0, fan_in ** -0.5, generator=generator)
            nn.init.zeros_(m.bias)
        elif isinstance(m, nn.Conv2d):
            nn.init.kaiming_normal_(m.weight, mode="fan_out",
                                    nonlinearity="relu", generator=generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, (nn.BatchNorm2d, nn.BatchNorm1d)):
            m.reset_parameters()
        elif isinstance(m, nn.Linear):
            nn.init.normal_(m.weight, 0.0, m.in_features ** -0.5,
                            generator=generator)
            nn.init.zeros_(m.bias)
