"""The per-tile q8 engine of the EfficientNet encoders: the MBConv trunk
with every conv+BN folded, bf16 convs, and one int8 sandwich per block
output.

- every conv+BN pair folded once per build (valid while the encoder is
  frozen: the whole stage-2 cycle and the stage-3 draw);
- every conv emits bf16, and its folded bias is cast to bf16 before the
  add;
- each block's output is quantized to int8 with a per-tensor scale
  calibrated on a pilot batch and dequantized by the next block (no
  sandwich inside a block);
- the squeeze-excite gate (two biased 1x1s on the pooled vector, then a
  sigmoid multiply) stays bf16, its weights rounded to bf16 and its biases
  kept in f32 until the add.

Numerics: the JAX package's ``ops/effnet_engine.py`` op for op, modulo
bf16 rounding placement and +-1 LSB int8 flips where a bf16 value sits on
a quantization boundary. The engine reaches no hand-written kernel: every
conv is ``F.conv2d`` (cuDNN on the card), as the JAX package's runs in
XLA.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from cellsegmentation_tpu_torch.models.efficientnet import EfficientNetEncoder
from cellsegmentation_tpu_torch.ops.infer_engine import (
    _absmax_scale,
    _bf16_round,
    _fold,
    _head_logits,
    _np,
    _sandwich,
)


@dataclasses.dataclass(frozen=True)
class EffBlockMeta:
    kernel: int
    stride: int
    expanded: int  # the depthwise width (its groups); c_in without an expand
    use_res: bool


@dataclasses.dataclass
class EffFoldedTrunk:
    """Folded host weights (HWIO f32, bf16-rounded; f32 biases): ``stem``
    and ``widen`` as (w, b), ``blocks`` as dicts of ``expand`` (when
    present), ``dw``, ``proj`` (w, b) and ``se`` (w1, b1, w2, b2)."""

    stem: tuple
    blocks: List[dict]
    metas: List[EffBlockMeta]
    widen: tuple


def effnet_block_metas(encoder: EfficientNetEncoder) -> List[EffBlockMeta]:
    """Each block's static config, in forward order."""
    return [EffBlockMeta(kernel=b.kernel, stride=b.stride, expanded=b.expanded,
                         use_res=b.use_res) for b in encoder.blocks]


def fold_effnet_trunk(model) -> Optional[EffFoldedTrunk]:
    """Fold an EfficientNet encoder; None for any other encoder."""
    enc = model.encoder
    if not isinstance(enc, EfficientNetEncoder):
        return None
    blocks = []
    for blk in enc.blocks:
        units = list(blk.block)
        se = units[-2]
        folded = {"dw": _fold(*units[-3]), "proj": _fold(*units[-1])}
        if len(units) == 4:
            folded["expand"] = _fold(*units[0])
        # 1x1 [out, in, 1, 1] -> HWIO [1, 1, in, out]
        folded["se"] = tuple(
            a for fc in (se.fc1, se.fc2)
            for a in (_bf16_round(np.transpose(_np(fc.weight), (2, 3, 1, 0))),
                      _np(fc.bias)))
        blocks.append(folded)
    return EffFoldedTrunk(stem=_fold(*enc.features[0]), blocks=blocks,
                          metas=effnet_block_metas(enc), widen=_fold(*enc.features[-1]))


def _silu(x):
    return x * torch.sigmoid(x)


def _conv(v, w, b, stride: int = 1, groups: int = 1):
    """conv (NCHW view, OIHW weight, pad (k-1)/2) + bias, in ``v``'s dtype."""
    k = w.shape[-1]
    return F.conv2d(v, w, None, stride, (k - 1) // 2, 1, groups) + b


def _se(x, se):
    """The squeeze-excite gate on an NCHW map: mean (f32 sum, rounded to the
    map's dtype) -> 1x1 + b -> SiLU -> 1x1 + b -> sigmoid -> x * gate."""
    w1, b1, w2, b2 = se
    pooled = x.float().mean(dim=(2, 3), keepdim=True).to(x.dtype)
    gate = _silu(_conv(pooled, w1, b1))
    return x * torch.sigmoid(_conv(gate, w2, b2))


def _block(x, blk, meta):
    """One folded MBConv on an NCHW map, before its sandwich."""
    inp = x
    if "expand" in blk:
        x = _silu(_conv(x, *blk["expand"]))
    x = _silu(_conv(x, *blk["dw"], meta.stride, meta.expanded))
    x = _conv(_se(x, blk["se"]), *blk["proj"])
    return x + inp if meta.use_res else x


def effnet_forward(tree, metas, x: torch.Tensor, scales=None) -> torch.Tensor:
    """Normalized NHWC tiles [N, ts, ts, 3] -> the widened NHWC feature map,
    in the dtype of ``tree``'s weights (bf16 on the engine's path, f32 for
    calibration). ``tree`` is ``(stem, blocks, widen)`` with each conv as
    an (OIHW weight, [C, 1, 1] bias) pair; ``scales`` one int8 sandwich
    scale (or None) per block output."""
    stem, blocks, widen = tree
    x = _silu(_conv(x.to(stem[0].dtype).permute(0, 3, 1, 2), *stem, 2))
    for i, (blk, meta) in enumerate(zip(blocks, metas)):
        x = _block(x, blk, meta)
        if scales is not None:
            x = _sandwich(x, scales[i])
    return _silu(_conv(x, *widen)).permute(0, 2, 3, 1)


def effnet_tree(trunk: EffFoldedTrunk, device, dtype=torch.bfloat16):
    """The folded trunk as ``effnet_forward``'s tree on ``device``: OIHW
    weights and [C, 1, 1] biases, both in ``dtype`` (the engine casts its
    biases to bf16 before the add, as the JAX package's does)."""
    def conv(wb):
        w, b = wb
        wt = torch.from_numpy(np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1))))
        bt = torch.from_numpy(np.asarray(b, np.float32)).view(-1, 1, 1)
        return wt.to(device, dtype), bt.to(device, dtype)

    blocks = []
    for blk in trunk.blocks:
        dev_blk = {k: conv(blk[k]) for k in ("expand", "dw", "proj") if k in blk}
        w1, b1, w2, b2 = blk["se"]
        dev_blk["se"] = (*conv((w1, b1)), *conv((w2, b2)))
        blocks.append(dev_blk)
    return conv(trunk.stem), blocks, conv(trunk.widen)


def calibrate_effnet(trunk: EffFoldedTrunk, calib_tiles: np.ndarray) -> List[float]:
    """Absmax int8 scales of every block output from a pilot batch: an f32
    forward of the folded trunk on the host CPU."""
    stem, blocks, _ = effnet_tree(trunk, "cpu", torch.float32)
    scales = []
    with torch.no_grad():
        x = torch.from_numpy(np.array(calib_tiles, np.float32)).permute(0, 3, 1, 2)
        x = _silu(_conv(x, *stem, 2))
        for blk, meta in zip(blocks, trunk.metas):
            x = _block(x, blk, meta)
            scales.append(_absmax_scale(x.numpy()))
    return scales


class EffTrunkLogits:
    """The EfficientNet per-tile q8 engine: normalized bf16 NHWC tiles
    [N, ts, ts, 3] -> f32 tile logits [N, 2] on the model's device. The
    folded MBConv trunk with its block-output sandwiches, then the tile
    head with bf16 pooling. ``fc_tile`` is read from the model at every
    call; ``scales`` (one per block) may be replaced between calls."""

    def __init__(self, model, trunk: EffFoldedTrunk, scales: List[float]):
        dev = next(model.parameters()).device
        self.model = model
        self.metas = trunk.metas
        self.scales = list(scales)
        self.tree = effnet_tree(trunk, dev)

    @torch.no_grad()
    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        x4 = effnet_forward(self.tree, self.metas, x, self.scales)
        return _head_logits(self.model.fc_tile, x4)
