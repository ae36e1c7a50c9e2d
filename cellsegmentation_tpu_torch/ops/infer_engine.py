"""Serving engines for the tile sweeps, the JAX package's four:

- q8dg, the dense shared-stem chain: stem and layer1 once per image, then
  per tile layer2 as the folded-BN conv trunk with int8 activation
  sandwiches and layers 3-4 as the int8 GEMM trunk of ops/q8_trunk.py
  (the default split; the JAX engine's others move the conv/GEMM seam,
  (1, 0) through the hybrid entry);
- q8d, the same dense front with layers 2-4 all in conv-land;
- q8, per tile: the whole folded conv trunk over every tile;
- q8g, per tile: stem and layer1 in conv-land, layers 2-4 as int8 GEMMs
  from the tile's /4 map.

An EfficientNet encoder folds through its own MBConv walk
(ops/effnet_engine.py): every per-tile request builds that conv engine,
and the dense engines do not apply, as in the JAX package.

- BatchNorm is folded into the conv weights once per build (the encoder is
  frozen during stage 2 and the stage-3 draw, so folding stays valid);
- conv-land runs as bf16 convs with bf16 outputs (``F.conv2d``, cuDNN on
  the card): q8dg's stem and layer1 once per image and layer2 per tile,
  per-tile q8's whole trunk per tile;
- activations crossing memory between and inside blocks are quantized to
  int8 with per-tensor scales calibrated on a pilot batch and dequantized
  by their consumer: in GEMM-land at every point, in conv-land after every
  block and around the 3x3s of the first ``INTRA_STAGES`` stages;
- q8dg and q8g run their GEMM-land as one hand-written int8 GEMM per conv.
  Only a Bottleneck trunk has a GEMM-land: for a BasicBlock encoder both
  take their conv-land form (q8d and q8), as in the JAX package. A grouped
  (ResNeXt) trunk runs its 3x3s as grouped convs in conv-land and as their
  block-diagonal expansion (ops/q8_trunk.py) in GEMM-land; q8g always
  takes its GEMM-land, q8dg only when ``grouped_gemm`` asks for it (else it
  runs the dense conv chain under its own name), as the JAX package's
  engines do.

Numerics: the JAX package's op order, modulo bf16 rounding placement and
+-1 LSB int8 flips where a bf16 value sits on a quantization boundary.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from cellsegmentation_tpu_torch.data.batches import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    normalize_images,
)
from cellsegmentation_tpu_torch.models.milnet import MILNet
from cellsegmentation_tpu_torch.models.resnet import (
    BasicBlock,
    Bottleneck,
    ResNetEncoder,
)
from cellsegmentation_tpu_torch.ops.dense_frontend import (
    dense_grid_meta,
    frontend_patches,
    unpermute_probs,
)
from cellsegmentation_tpu_torch.ops.q8_trunk import (
    build_q8_backend,
    q8_backend_forward,
    upload_q8_params,
)

# q8dg's conv/GEMM split: the (stage, block) where GEMM-land starts, the JAX
# engine's default (layer2 in conv-land, layers 3-4 as int8 GEMMs)
GEMM_FIRST_STAGE, GEMM_FIRST_BLOCK = 2, 0
# per-tile q8's sandwich depths (the JAX package's conv backend): block
# outputs in the first SANDWICH_STAGES stages, h1/h2 around the 3x3 in the
# first INTRA_STAGES
SANDWICH_STAGES = 4
INTRA_STAGES = 2
# tiles per pass of the per-tile engines and the exact graph: bounds the
# bf16 activations and their f32 quantize temporaries of a 128-image batch
# on the 16/5 grid (430k tiles) or the 32/5 grid (387k); each tile's result
# does not depend on the split
Q8_TILE_CHUNK = 32768


def _bf16_round(a: np.ndarray) -> np.ndarray:
    """f32 -> nearest bf16 (round half to even), held in an f32 array."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        torch.bfloat16).float().numpy()


def fold_conv_bn(kernel, scale, bias, mean, var, eps: float = 1e-5):
    """conv(x, w) -> BN  ==  conv(x, w*g) + (b - m*g), g = gamma/sqrt(var+eps).

    ``kernel`` is HWIO. Returns host arrays (w rounded to bf16, held in f32;
    b in f32), the same values the JAX package's fold produces."""
    g = np.asarray(scale) / np.sqrt(np.asarray(var) + eps)
    w = (np.asarray(kernel) * g).astype(np.float32)
    b = (np.asarray(bias) - np.asarray(mean) * g).astype(np.float32)
    return _bf16_round(w), b


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().float().numpy()


def _fold(conv, bn):
    return fold_conv_bn(
        np.transpose(_np(conv.weight), (2, 3, 1, 0)),  # OIHW -> HWIO
        _np(bn.weight), _np(bn.bias), _np(bn.running_mean),
        _np(bn.running_var), bn.eps,
    )


@dataclasses.dataclass
class FoldedTrunk:
    """Folded host weights (HWIO), grouped per stage: [(block0 weights),
    (block1), ...] with (w1, b1, w2, b2, w3, b3[, wp, bp]) per Bottleneck
    (``kind="bottleneck"``) or (w1, b1, w2, b2[, wp, bp]) per BasicBlock
    (``kind="basic"``). A grouped Bottleneck's w2 is ``[3, 3, C/g, C]``."""

    stem_w: np.ndarray
    stem_b: np.ndarray
    stages: list
    strides: list  # per-stage stride of block 0
    kind: str = "bottleneck"
    groups: int = 1  # the 3x3s' groups (ResNeXt)


def fold_tile_trunk(model: MILNet) -> Optional[FoldedTrunk]:
    """Fold a ResNet encoder: Bottleneck (grouped for ResNeXt) or ungrouped
    BasicBlock; None for any other encoder (the caller falls back to the
    model's own graph)."""
    enc = model.encoder
    if not isinstance(enc, ResNetEncoder):
        return None
    if enc.block_cls is Bottleneck:
        kind, n_convs = "bottleneck", 3
    elif enc.block_cls is BasicBlock and enc.groups == 1:
        kind, n_convs = "basic", 2
    else:
        return None
    stem_w, stem_b = _fold(enc.conv1, enc.bn1)
    stages, strides = [], []
    for s in range(len(enc.stage_sizes)):
        stage = []
        for blk in getattr(enc, f"layer{s + 1}"):
            ws = []
            for ci in range(1, n_convs + 1):
                ws.extend(_fold(getattr(blk, f"conv{ci}"), getattr(blk, f"bn{ci}")))
            if blk.downsample is not None:
                ws.extend(_fold(blk.downsample[0], blk.downsample[1]))
            stage.append(tuple(ws))
        stages.append(stage)
        strides.append(1 if s == 0 else 2)
    return FoldedTrunk(stem_w=stem_w, stem_b=stem_b, stages=stages,
                       strides=strides, kind=kind, groups=int(enc.groups))


# ---------------------------------------------------------------------------
# conv-land forward (NCHW views of NHWC-contiguous tensors)
# ---------------------------------------------------------------------------


def _f32(v: float, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=device)


def _q8(x: torch.Tensor, scale: float) -> torch.Tensor:
    """bf16 -> int8: clip(round(x * f32(1/scale)), -127, 127)."""
    y = torch.round(x.float() * _f32(1.0 / scale, x.device))
    return torch.clamp(y, -127, 127).to(torch.int8)


def _dq(xq: torch.Tensor, scale: float) -> torch.Tensor:
    return xq.to(torch.bfloat16) * torch.tensor(scale, dtype=torch.bfloat16,
                                                device=xq.device)


def _sandwich(x: torch.Tensor, scale: Optional[float]) -> torch.Tensor:
    if scale is None:
        return x
    return _dq(_q8(x, scale), scale)


def _cv(v, w, stride: int, pad: int, groups: int = 1):
    return F.conv2d(v, w, None, stride, pad, 1, groups)


def _conv_bias_relu(x, w, b, stride: int, pad: int):
    return F.relu(_cv(x, w, stride, pad) + b)


def _conv_bottleneck(x, ws, stride: int, s_h1=None, s_h2=None, groups: int = 1):
    """One folded Bottleneck, bf16 convs, optional intra-block sandwiches;
    the 3x3 is grouped for ResNeXt."""
    w1, b1, w2, b2, w3, b3 = ws[:6]
    h = F.relu(_cv(x, w1, 1, 0) + b1)
    h = _sandwich(h, s_h1)
    h = F.relu(_cv(h, w2, stride, 1, groups) + b2)
    h = _sandwich(h, s_h2)
    out = _cv(h, w3, 1, 0) + b3
    res = _cv(x, ws[6], stride, 0) + ws[7] if len(ws) == 8 else x
    return F.relu(out + res)


def _conv_basic(x, ws, stride: int, s_h1=None, s_h2=None, groups: int = 1):
    """One folded BasicBlock (3x3 s, 3x3), bf16 convs, an optional
    sandwich between the two 3x3s (``s_h2`` is unused: it has no h2;
    ``groups`` is always 1, as ``fold_tile_trunk`` folds no grouped one)."""
    w1, b1, w2, b2 = ws[:4]
    h = F.relu(_cv(x, w1, stride, 1) + b1)
    h = _sandwich(h, s_h1)
    out = _cv(h, w2, 1, 1) + b2
    res = _cv(x, ws[4], stride, 0) + ws[5] if len(ws) == 6 else x
    return F.relu(out + res)


@dataclasses.dataclass
class TrunkScales:
    """Per-tensor activation scales at every sandwich point:
    block_out[si][bi], h1[si][bi], h2[si][bi], and proj[si][bi] (the
    projection output of a block's residual branch, None without one)."""

    block_out: List[List[Optional[float]]]
    h1: List[List[Optional[float]]]
    h2: List[List[Optional[float]]]
    proj: Optional[List[List[Optional[float]]]] = None


def _device_conv(w: np.ndarray, b: np.ndarray, device, scale=None):
    """Host HWIO f32 weight + bias -> (OIHW bf16, bf16 [C,1,1]) on device;
    ``scale`` folds a dequant scale into the weight first (in f32)."""
    w = np.asarray(w, np.float32)
    if scale is not None:
        w = w * np.float32(scale)
    wt = torch.from_numpy(np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1))))
    bt = torch.from_numpy(np.asarray(b, np.float32)).view(-1, 1, 1)
    return wt.to(device, torch.bfloat16), bt.to(device, torch.bfloat16)


def trunk_forward(tree, strides, x: torch.Tensor, scales: TrunkScales,
                  n_stages: Optional[int] = None,
                  kind: str = "bottleneck", groups: int = 1) -> torch.Tensor:
    """Normalized bf16 NHWC images -> the NHWC output of the first
    ``n_stages`` stages of ``tree`` (all by default): stem, maxpool, blocks
    with their sandwiches. A walk given ``n_stages`` ends at a seam and
    leaves its last block's output unquantized for the caller; the full
    walk sandwiches every block output, the last one included."""
    stem_w, stem_b, stages = tree
    seam = n_stages is not None
    n_stages = len(stages) if n_stages is None else n_stages
    x = _conv_bias_relu(x.permute(0, 3, 1, 2), stem_w, stem_b, 2, 3)
    x = F.max_pool2d(x, 3, 2, 1)
    plan = [(si, bi) for si in range(n_stages) for bi in range(len(stages[si]))]
    x = _blocks_forward(x, stages, strides, plan, scales, kind, seam, groups)
    return x.permute(0, 2, 3, 1)


def _blocks_forward(x, stages, strides, plan, scales: TrunkScales, kind: str,
                    seam: bool, groups: int = 1):
    """Run the blocks (stage, block) of ``plan`` on an NCHW map with their
    sandwiches; with ``seam`` the last block's output is left unquantized."""
    block = _conv_basic if kind == "basic" else _conv_bottleneck
    for pi, (si, bi) in enumerate(plan):
        x = block(x, stages[si][bi], strides[si] if bi == 0 else 1,
                  s_h1=scales.h1[si][bi], s_h2=scales.h2[si][bi], groups=groups)
        if not (seam and pi == len(plan) - 1):
            x = _sandwich(x, scales.block_out[si][bi])
    return x


# ---------------------------------------------------------------------------
# calibration (host CPU, f32)
# ---------------------------------------------------------------------------


def _absmax_scale(x) -> float:
    # 5% headroom: a small pilot's absmax under-covers outlier images, and
    # out-of-range activations clip at +-127 and distort the top-k ranking
    s = 1.05 * float(np.abs(np.asarray(x, np.float32)).max()) / 127.0
    return s if s > 0 else 1.0


def pick_calib_images(images, n: int = 4, seed: int = 0) -> np.ndarray:
    """Seeded random calibration pilot spread across the source."""
    images = np.asarray(images)
    if len(images) <= n:
        return images
    idx = np.sort(
        np.random.default_rng(seed).choice(len(images), size=n, replace=False)
    )
    return images[idx]


def calib_tiles_from_images(
    images_u8: np.ndarray, coords: np.ndarray, tile_size: int,
    n_max: int = 512, seed: int = 0,
) -> np.ndarray:
    """Host pilot batch: tiles sliced off uint8 images, ImageNet-normalized
    in numpy (f32 NHWC)."""
    images_u8 = np.asarray(images_u8)
    rng = np.random.default_rng(seed)
    out = []
    per_img = max(1, n_max // max(len(images_u8), 1))
    for img in images_u8:
        sel = rng.choice(
            len(coords), size=min(per_img, len(coords)), replace=False
        )
        for x0, y0 in np.asarray(coords)[sel]:
            out.append(img[x0 : x0 + tile_size, y0 : y0 + tile_size])
        if len(out) >= n_max:
            break
    tiles = np.stack(out[:n_max]).astype(np.float32) / 255.0
    return (tiles - IMAGENET_MEAN) / IMAGENET_STD


def _np_conv3(a: np.ndarray, k: np.ndarray, stride: int,
              groups: int = 1) -> np.ndarray:
    """f32 3x3 pad-1 conv on the host: NHWC activations, HWIO kernel
    (``[3, 3, C/g, C']`` when grouped)."""
    y = F.conv2d(
        torch.from_numpy(np.ascontiguousarray(a, np.float32)).permute(0, 3, 1, 2),
        torch.from_numpy(np.ascontiguousarray(np.transpose(k, (3, 2, 0, 1)))),
        None, stride, 1, 1, groups,
    )
    return y.permute(0, 2, 3, 1).contiguous().numpy()


def _instrumented_block_np(x, ws, stride, kind="bottleneck", groups=1):
    """f32 forward of one folded block on the host, returning
    (y, h1, h2, res); res is the pre-add residual branch. A BasicBlock has
    no h2: its h1 comes back in both slots."""
    n, h, w, cin = x.shape
    flat = x.reshape(-1, cin)
    if kind == "basic":
        w1, b1, w2, b2 = [np.asarray(a, np.float32) for a in ws[:4]]
        h1 = np.maximum(_np_conv3(x, w1, stride) + b1, 0.0)
        out = _np_conv3(h1, w2, 1) + b2
        ho, wo = out.shape[1], out.shape[2]
        if len(ws) == 6:
            xs = x[:, ::stride, ::stride, :] if stride > 1 else x
            res = (xs.reshape(-1, cin) @ np.asarray(ws[4], np.float32)[0, 0]
                   + np.asarray(ws[5], np.float32))
        else:
            res = flat
        y = np.maximum(out.reshape(-1, out.shape[-1]) + res, 0.0)
        h1f = h1.reshape(-1, h1.shape[-1])
        return y.reshape(n, ho, wo, -1), h1f, h1f, res
    has_proj = len(ws) == 8
    w1, b1, w2, b2, w3, b3 = [np.asarray(a, np.float32) for a in ws[:6]]
    h1 = np.maximum(flat @ w1[0, 0] + b1, 0.0)
    h2 = _np_conv3(h1.reshape(n, h, w, -1), w2, stride, groups)
    h2 = np.maximum(h2 + b2, 0.0)
    ho, wo = h2.shape[1], h2.shape[2]
    out = h2.reshape(-1, h2.shape[-1]) @ w3[0, 0] + b3
    if has_proj:
        wd = np.asarray(ws[6], np.float32)
        bd = np.asarray(ws[7], np.float32)
        xs = x[:, ::stride, ::stride, :] if stride > 1 else x
        res = xs.reshape(-1, cin) @ wd[0, 0] + bd
    else:
        res = flat
    y = np.maximum(out + res, 0.0).reshape(n, ho, wo, -1)
    return y, h1, h2.reshape(-1, h2.shape[-1]), res


def calibrate_trunk(folded: FoldedTrunk, calib_tiles: np.ndarray) -> TrunkScales:
    """Absmax activation scales at every sandwich point of every block
    (h1, h2, block_out, and the Bottleneck projection outputs) from a pilot
    batch: a bf16 stem on the host CPU, then an f32 forward of the folded
    blocks. These are the JAX package's ``deep=True`` scales; the per-tile
    engine keeps only its own depths of them (``conv_trunk_scales``), the
    same values its ``deep=False`` calibration gives."""
    with torch.no_grad():
        w, b = _device_conv(folded.stem_w, folded.stem_b, "cpu")
        v = torch.from_numpy(np.asarray(calib_tiles, np.float32))
        v = _conv_bias_relu(v.to(torch.bfloat16).permute(0, 3, 1, 2), w, b, 2, 3)
        v = F.max_pool2d(v, 3, 2, 1)
        x = v.permute(0, 2, 3, 1).float().contiguous().numpy()

        block_out, h1s, h2s, projs = [], [], [], []
        for stage, stride in zip(folded.stages, folded.strides):
            bo, b1, b2, pr = [], [], [], []
            for bi, ws in enumerate(stage):
                y, h1, h2, res = _instrumented_block_np(
                    x, ws, stride if bi == 0 else 1, folded.kind, folded.groups
                )
                b1.append(_absmax_scale(h1))
                b2.append(_absmax_scale(h2))
                bo.append(_absmax_scale(y))
                has_proj = folded.kind == "bottleneck" and len(ws) == 8
                pr.append(_absmax_scale(res) if has_proj else None)
                x = y
            block_out.append(bo)
            h1s.append(b1)
            h2s.append(b2)
            projs.append(pr)
    return TrunkScales(block_out=block_out, h1=h1s, h2=h2s, proj=projs)


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------


def _head_logits_flat(fc_tile, feats: torch.Tensor, px: int) -> torch.Tensor:
    """avg+max pool over the whole-tile [N, px*C] layout's C-wide column
    slices, then the tile Linear on bf16 operands with f32 accumulation."""
    c = feats.shape[1] // px
    cols = [feats[:, i * c : (i + 1) * c].float() for i in range(px)]
    acc_s, acc_m = cols[0], cols[0]
    for col in cols[1:]:
        acc_s = acc_s + col
        acc_m = torch.maximum(acc_m, col)
    pooled = acc_s * _f32(1.0 / px, feats.device) + acc_m
    lin = fc_tile[1]
    w = lin.weight.to(torch.bfloat16).float()
    return F.linear(pooled.to(torch.bfloat16).float(), w) + lin.bias.float()


def _device_stages(folded: FoldedTrunk, n_stages: int, device, fold_scale=None):
    """The first ``n_stages`` stages of ``folded`` as device conv tuples
    (OIHW bf16 weight, bf16 bias per conv). ``fold_scale`` folds a dequant
    scale into layer2 block0's input convs (c1 and the projection), so int8
    patches enter it as plain bf16 converts."""
    proj = 6 if folded.kind == "bottleneck" else 4
    stages = []
    for si, stage in enumerate(folded.stages[:n_stages]):
        blocks = []
        for bi, ws in enumerate(stage):
            fold0 = fold_scale is not None and si == 1 and bi == 0
            convs = []
            for j in range(0, len(ws), 2):
                scale = fold_scale if fold0 and j in (0, proj) else None
                convs.extend(_device_conv(ws[j], ws[j + 1], device, scale))
            blocks.append(tuple(convs))
        stages.append(blocks)
    return stages


def _gemm_land(folded: FoldedTrunk, scales: TrunkScales, span: int,
               first_stage: int, first_block: int, w2_impl: str, device):
    """(device params, metas) of the int8 GEMM trunk from block
    (``first_stage``, ``first_block``) on a ``span`` x ``span`` map."""
    host_params, metas = build_q8_backend(folded, scales, span, span,
                                          first_stage=first_stage,
                                          first_block=first_block,
                                          w2_impl=w2_impl)
    return upload_q8_params(host_params, device), metas


class DenseTileProbs:
    """The dense shared-stem sweep: ``(images u8 [G, hw, hw, 3], flip [G]
    or None) -> probs [G, T]`` in reference tile order, on the model's
    device.

    Stem + layer1 run once per image (ops/dense_frontend.py); each tile's
    /4 patch then runs the rest of the trunk. ``backend="gemm"`` (q8dg):
    the blocks before (``gemm_first_stage``, ``gemm_first_block``) as bf16
    convs with int8 sandwiches (conv-land), the rest as int8 GEMMs
    (GEMM-land, ops/q8_trunk.py); the split (1, 0) is the hybrid entry,
    which runs layer2 block 0's c1 and projection as convs on the
    dequantized patches and enters GEMM-land after them.
    ``backend="conv"`` (q8d): layers 2-4 as bf16 convs with the conv-land
    sandwiches, pooled in bf16. ``fc_tile`` is read from the model at every
    call, since stage 2 retrains the head between sweeps."""

    def __init__(self, model: MILNet, folded: FoldedTrunk, meta,
                 scales: TrunkScales, backend: str = "gemm",
                 w2_impl: str = "auto", gemm_first_stage: int = GEMM_FIRST_STAGE,
                 gemm_first_block: int = GEMM_FIRST_BLOCK):
        dev = next(model.parameters()).device
        self.model = model
        self.meta = meta
        self.kind = folded.kind
        self.groups = folded.groups
        self.backend = backend
        self.strides = tuple(folded.strides)
        self.s0 = float(scales.block_out[0][-1])
        # conv-land's sandwiches: intra-block ones stop at INTRA_STAGES
        self.conv_scales = conv_trunk_scales(scales)
        stages = folded.stages
        fs, fb = gemm_first_stage, gemm_first_block
        self.hybrid = False
        if backend == "gemm":
            # block len(stages[fs]) of stage fs is block 0 of the next one
            if (not (1 <= fs < len(stages) and 0 <= fb <= len(stages[fs]))
                    or (fs, fb) == (len(stages) - 1, len(stages[-1]))):
                raise ValueError(f"no GEMM split at stage {fs}, block {fb} of a "
                                 f"{[len(st) for st in stages]}-block trunk")
            self.scales = scales
            self.hybrid = (fs, fb) == (1, 0)
            # conv-land: every block of stages 1..fs-1, then blocks 0..fb-1
            # of stage fs; each stage's block 0 halves the /4 span (stride 2)
            self.plan = ([(si, bi) for si in range(1, fs) for bi in range(len(stages[si]))]
                         + [(fs, bi) for bi in range(fb)])
            span = meta.tile_size // 4
            for _ in range((fs - 1) + (1 if fb else 0)):
                span = (span + 1) // 2
            self.qparams, self.metas = _gemm_land(folded, scales, span, fs, fb,
                                                  w2_impl, dev)
            n_conv = max(2, fs + (1 if fb else 0))
        else:
            self.scales = self.conv_scales
            self.plan = [(si, bi) for si in range(1, len(stages))
                         for bi in range(len(stages[si]))]
            n_conv = len(stages)
        # the patches' dequant scale folds into layer2 block 0's c1 and
        # projection, except at the hybrid entry, which dequantizes them
        self.tree = (*_device_conv(folded.stem_w, folded.stem_b, dev),
                     _device_stages(folded, n_conv, dev,
                                    fold_scale=None if self.hybrid else self.s0))

    def _stem0(self, u8: torch.Tensor) -> torch.Tensor:
        flip0 = torch.zeros((u8.shape[0],), dtype=torch.int32, device=u8.device)
        x = normalize_images(u8, flip0, dtype=torch.bfloat16)
        x1 = trunk_forward(self.tree, self.strides, x, self.conv_scales, n_stages=1,
                           kind=self.kind, groups=self.groups)
        return _q8(x1, self.s0)

    def _hybrid_entry(self, patches: torch.Tensor, m0: int):
        """Layer2 block 0's c1 (ReLU, int8 at its h1 scale) and projection
        (int8 at its proj scale) as convs on the dequantized patches, each
        flattened NHWC into the whole-tile [m0, px*C] layout."""
        blk = self.tree[2][1][0]
        x = _dq(patches, self.s0).permute(0, 3, 1, 2)
        h1 = F.relu(_cv(x, blk[0], 1, 0) + blk[1])
        # the projection's bias add stays in f32 into its quantize, as XLA
        # fuses it in the JAX engine (a bf16 rounding between them flips
        # ~6% of the int8 residual's LSBs against it)
        pr = _cv(x, blk[6], self.strides[1], 0).float() + blk[7].float()
        h1q = _q8(h1, self.scales.h1[1][0]).permute(0, 2, 3, 1).reshape(m0, -1)
        prq = _q8(pr, self.scales.proj[1][0]).permute(0, 2, 3, 1).reshape(m0, -1)
        return h1q, prq

    def gemm_entry(self, patches: torch.Tensor) -> dict:
        """q8dg's conv-land from the int8 patches [M, span, span, C] to
        GEMM-land's entry, as ``q8_backend_forward``'s keywords: the int8
        seam rows ``xq`` [M, px*C] (the plan's last block output quantized
        and flattened NHWC into the whole-tile layout), or the hybrid
        entry's ``first_h1`` / ``first_res``."""
        m0 = patches.shape[0]
        stages = self.tree[2]
        if self.hybrid:
            h1q, prq = self._hybrid_entry(patches, m0)
            return dict(xq=None, first_h1=h1q, first_res=prq)
        x = _blocks_forward(patches.to(torch.bfloat16).permute(0, 3, 1, 2),
                            stages, self.strides, self.plan, self.conv_scales,
                            self.kind, seam=True, groups=self.groups)
        si, bi = self.plan[-1]
        xq = _q8(x, self.scales.block_out[si][bi]).permute(0, 2, 3, 1)
        return dict(xq=xq.reshape(m0, -1))

    @torch.no_grad()
    def __call__(self, images: torch.Tensor, flip: Optional[torch.Tensor]):
        g = images.shape[0]
        patches = frontend_patches(self.meta, self._stem0, images, flip)
        if self.backend == "gemm":
            feats = q8_backend_forward(self.qparams, self.metas,
                                       **self.gemm_entry(patches))
            last = self.metas[-1]
            logits = _head_logits_flat(self.model.fc_tile, feats,
                                       last.h_out * last.w_out)
        else:
            x = _blocks_forward(patches.to(torch.bfloat16).permute(0, 3, 1, 2),
                                self.tree[2], self.strides, self.plan, self.scales,
                                self.kind, seam=False, groups=self.groups)
            logits = _head_logits(self.model.fc_tile, x.permute(0, 2, 3, 1))
        probs = torch.softmax(logits.float(), dim=-1)[:, 1]
        return unpermute_probs(self.meta, probs.reshape(g, -1), flip)


def make_dense_tile_probs(
    model: MILNet, tile_size: int, interval: int, hw: int,
    calib_tiles: np.ndarray, scales: Optional[TrunkScales] = None,
    w2_impl: str = "auto", backend: str = "gemm",
    grouped_gemm: bool = False, gemm_first_stage: int = GEMM_FIRST_STAGE,
    gemm_first_block: int = GEMM_FIRST_BLOCK,
) -> Optional[DenseTileProbs]:
    """Build the dense shared-stem sweep: ``backend="gemm"`` is q8dg, for a
    Bottleneck ResNet (a grouped one only with ``grouped_gemm``, the JAX
    package's ``CST_GROUPED_GEMM``); ``backend="conv"`` is q8d, for any
    ResNet that folds. None when the arch or the grid does not qualify.
    ``scales`` replaces the calibration (a test feeds the JAX package's
    TrunkScales through it); ``w2_impl`` picks the GEMM trunk's 3x3 form
    (ops/q8_trunk.py ``W2_IMPLS``).

    q8dg's conv/GEMM split is the JAX package's ``gemm_first_stage`` /
    ``gemm_first_block`` arguments, with its defaults (``DenseTileProbs``
    says what each split runs); a split the trunk has not raises
    ``ValueError``."""
    folded = fold_tile_trunk(model)
    meta = dense_grid_meta(hw, tile_size, interval)
    if folded is None or meta is None or (backend == "gemm" and (
            folded.kind != "bottleneck" or (folded.groups > 1 and not grouped_gemm))):
        return None
    if scales is None:
        scales = calibrate_trunk(folded, np.asarray(calib_tiles, np.float32))
    return DenseTileProbs(model, folded, meta, scales, backend, w2_impl,
                          gemm_first_stage, gemm_first_block)


# ---------------------------------------------------------------------------
# the per-tile engines: q8 (conv-land) and q8g (GEMM-land from layer2)
# ---------------------------------------------------------------------------


def conv_trunk_scales(scales: TrunkScales) -> TrunkScales:
    """The conv-land engines' sandwich points of ``scales``: block outputs
    in the first SANDWICH_STAGES stages, h1/h2 in the first INTRA_STAGES,
    no projection scales (the JAX package's ``calibrate_trunk(deep=False)``)."""
    def keep(rows, depth):
        return [[v if si < depth else None for v in row]
                for si, row in enumerate(rows)]

    return TrunkScales(block_out=keep(scales.block_out, SANDWICH_STAGES),
                       h1=keep(scales.h1, INTRA_STAGES),
                       h2=keep(scales.h2, INTRA_STAGES))


def _head_logits(fc_tile, x4: torch.Tensor) -> torch.Tensor:
    """avg+max pool of bf16 NHWC features in bf16 (the mean summed in f32
    and rounded, as ``jnp.mean`` of a bf16 map; the two pools added in
    bf16), then the tile Linear on bf16 operands with f32 accumulation."""
    mean = x4.float().mean(dim=(1, 2)).to(torch.bfloat16)
    pooled = mean + x4.amax(dim=(1, 2))
    lin = fc_tile[1]
    w = lin.weight.to(torch.bfloat16).float()
    return F.linear(pooled.float(), w) + lin.bias.float()


class TileTrunkLogits:
    """The per-tile q8 engine: normalized bf16 NHWC tiles [N, ts, ts, 3] ->
    f32 tile logits [N, 2] on the model's device. The whole folded trunk
    runs as bf16 convs with the conv backend's int8 sandwiches (every block
    output, the last one included, and h1/h2 in the first INTRA_STAGES
    stages), then the head pools in bf16. ``fc_tile`` is read from the
    model at every call."""

    def __init__(self, model: MILNet, folded: FoldedTrunk, scales: TrunkScales):
        dev = next(model.parameters()).device
        self.model = model
        self.kind = folded.kind
        self.groups = folded.groups
        self.strides = tuple(folded.strides)
        self.scales = scales
        self.tree = (*_device_conv(folded.stem_w, folded.stem_b, dev),
                     _device_stages(folded, len(folded.stages), dev))

    @torch.no_grad()
    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        x4 = trunk_forward(self.tree, self.strides, x, self.scales,
                           kind=self.kind, groups=self.groups)
        return _head_logits(self.model.fc_tile, x4)


class TileGemmLogits:
    """The per-tile q8g engine: normalized bf16 NHWC tiles [N, ts, ts, 3] ->
    f32 tile logits [N, 2] on the model's device. Stem and layer1 run as
    bf16 convs with their sandwiches; layer1's output is quantized at the
    seam into the whole-tile [N, px*C] layout, and layers 2-4 run as int8
    GEMMs (ops/q8_trunk.py) from the tile's /4 map. ``fc_tile`` is read
    from the model at every call."""

    def __init__(self, model: MILNet, folded: FoldedTrunk, scales: TrunkScales,
                 tile_size: int, w2_impl: str = "auto"):
        dev = next(model.parameters()).device
        self.model = model
        self.groups = folded.groups
        self.strides = tuple(folded.strides)
        self.scales = scales
        self.s0 = float(scales.block_out[0][-1])
        self.tree = (*_device_conv(folded.stem_w, folded.stem_b, dev),
                     _device_stages(folded, 1, dev))
        span = tile_size // 4  # stem s2 + maxpool s2
        self.qparams, self.metas = _gemm_land(folded, scales, span, 1, 0, w2_impl, dev)

    @torch.no_grad()
    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        x1 = trunk_forward(self.tree, self.strides, x, self.scales, n_stages=1,
                           groups=self.groups)
        xq = _q8(x1, self.s0).reshape(x1.shape[0], -1)
        feats = q8_backend_forward(self.qparams, self.metas, xq)
        last = self.metas[-1]
        return _head_logits_flat(self.model.fc_tile, feats, last.h_out * last.w_out)


def make_fast_tile_logits(
    model: MILNet, calib_tiles: Optional[np.ndarray] = None,
    scales: Optional[TrunkScales] = None, backend: str = "conv",
    tile_size: Optional[int] = None, w2_impl: str = "auto",
):
    """Build a per-tile engine (the JAX package's ``make_fast_tile_logits``):
    ``backend="conv"`` is q8 (``TileTrunkLogits``), ``backend="gemm"`` q8g
    (``TileGemmLogits``, for ``tile_size`` tiles; a BasicBlock trunk takes
    the conv backend, as in the JAX package). None for an encoder that does
    not fold. The scales come from ``calib_tiles`` (normalized f32 pilot
    tiles) or are given as ``scales``: q8 keeps its own points of any
    calibration, q8g needs every point (the projections' too). An
    EfficientNet builds its MBConv engine (``EffTrunkLogits``) under either
    backend, its ``scales`` one per block."""
    folded = fold_tile_trunk(model)
    if folded is None:
        return _effnet_tile_logits(model, calib_tiles, scales)
    if scales is None:
        if calib_tiles is None:
            raise ValueError("the per-tile engines need calib_tiles or scales")
        scales = calibrate_trunk(folded, np.asarray(calib_tiles, np.float32))
    if backend == "gemm" and folded.kind == "bottleneck":
        if scales.proj is None:
            raise ValueError("the q8g engine needs every calibration point "
                             "(TrunkScales with proj)")
        return TileGemmLogits(model, folded, scales, tile_size, w2_impl)
    return TileTrunkLogits(model, folded, conv_trunk_scales(scales))


def _effnet_tile_logits(model: MILNet, calib_tiles, scales):
    """The EfficientNet branch of ``make_fast_tile_logits``; None for an
    encoder that folds through neither walk."""
    from cellsegmentation_tpu_torch.ops.effnet_engine import (
        EffTrunkLogits,
        calibrate_effnet,
        fold_effnet_trunk,
    )

    trunk = fold_effnet_trunk(model)
    if trunk is None:
        return None
    if scales is None:
        if calib_tiles is None:
            raise ValueError("the per-tile engines need calib_tiles or scales")
        scales = calibrate_effnet(trunk, np.asarray(calib_tiles, np.float32))
    return EffTrunkLogits(model, trunk, scales)
