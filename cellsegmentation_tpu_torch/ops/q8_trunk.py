"""Stage-2 serving trunk (GEMM-land: layers 3-4 on q8dg's default split,
layers 2-4 on q8g's and q8dg's (1, *) splits) as per-conv int8 GEMMs on the
whole-tile layout.

At the 32x32-tile geometry layers 2-4 run on tiny maps (8/4/2/1 px a side).
Every activation is an int8 ``[N, px*C]`` row-major matrix (column
``(h*w_in + w)*C + c``); 1x1 convs are per-pixel GEMMs (``q8_matmul_px``),
the strided projection reads a static pixel map, residual adds ride the
expand's epilogue, and 3x3s take one of three forms:

- the tap-accumulating conv (``q8_conv3_tap``): 9 shifted [M, C] x [C, C']
  dots per output pixel;
- one whole-tile Toeplitz GEMM (``q8_matmul``): for a conv on an [h, w, C]
  map the dense weight W'[(hi,wi,ci), (ho,wo,co)] = K[dy,dx,ci,co] makes the
  whole conv, zero padding included, one GEMM;
- the row-Toeplitz conv (``q8_conv3_rowtap``): per output row, one
  [M, w*C] x [w*C, w'*C'] dot per in-range input row against the dy-th
  plane of a weight whose (wi, wo) band holds K[dy, wi - stride*wo + 1].

The three forms quantize the same kernel with the same per-channel scales
and accumulate the same int32 products, so they are bit-identical: the
choice (``w2_impl``) is a speed switch only.

A grouped (ResNeXt) 3x3 runs as its kernel expanded block-diagonally to a
dense ``[3, 3, C, C']`` one (zeros off the group diagonal) through the
ungrouped forms above, unchanged: g times the grouped conv's MACs, the JAX
package's ``"blockdiag"`` form. (Its other form, ``"gdot"``, a batched
per-group dot outside any Pallas kernel, is bit-identical to it, a speed
alternative only, and is not ported: PyTorch has no batched int8 product
on CUDA.)

The host packing below is the JAX package's, verbatim (numpy), so the
packed int8 weights are byte-identical to it. The kernels read each weight
transposed (``[N, K]``); ``upload_q8_params`` transposes once per build.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from cellsegmentation_tpu_torch.kernels.q8_gemm import (
    q8_conv3_rowtap,
    q8_conv3_tap,
    q8_matmul,
    q8_matmul_px,
)

# the 3x3 formulations a trunk can be built with: two of the JAX package's
# W2_IMPL values (its forced "tap"/"wholetile" forms have no caller here)
W2_IMPLS = ("auto", "rowtap")


def _w2_impl(h: int, w: int, w2_impl: str) -> str:
    """The 3x3 formulation of a block. ``"auto"``: the tap-accumulating conv
    when the block's input map has more than 9 pixels (the Toeplitz GEMM
    re-multiplies px_in/9 redundant K-columns per output pixel), else the
    whole-tile Toeplitz GEMM; ``"rowtap"`` forces the row-Toeplitz form."""
    if w2_impl == "rowtap":
        return w2_impl
    return "tap" if h * w > 9 else "wholetile"


def _per_channel_scale(k: np.ndarray) -> np.ndarray:
    """absmax scale per output channel (last axis) of a folded kernel."""
    s = np.abs(k).reshape(-1, k.shape[-1]).max(axis=0) / 127.0
    return np.where(s > 0, s, 1.0).astype(np.float32)


def _quant_w(k: np.ndarray, scale: np.ndarray) -> np.ndarray:
    return np.clip(np.round(k / scale), -127, 127).astype(np.int8)


def _expand_grouped(k2: np.ndarray, groups: int) -> np.ndarray:
    """Grouped HWIO kernel [kh, kw, C/g, C'] -> dense block-diagonal
    [kh, kw, C, C'] (zeros off the group diagonal), so the grouped 3x3 runs
    through the ungrouped forms unchanged."""
    kh, kw, cing, cout = k2.shape
    coutg = cout // groups
    big = np.zeros((kh, kw, cing * groups, cout), k2.dtype)
    for gi in range(groups):
        big[:, :, gi * cing : (gi + 1) * cing,
            gi * coutg : (gi + 1) * coutg] = (
            k2[:, :, :, gi * coutg : (gi + 1) * coutg]
        )
    return big


def _wholetile_weight(k2: np.ndarray, h: int, w: int, stride: int):
    """[3,3,C,C'] folded conv kernel -> dense whole-tile GEMM weight.

    Returns (W' [h*w*C, h'*w'*C'] f32, h', w'). Entry layout matches the
    row-major [N, h, w, C] <-> [N, h*w*C] reshape on both sides, so the
    GEMM is exactly the pad-1 stride-s conv on the tile.
    """
    kh, kw, c_in, c_out = k2.shape
    ho = (h + 2 - kh) // stride + 1
    wo = (w + 2 - kw) // stride + 1
    big = np.zeros((h * w * c_in, ho * wo * c_out), dtype=np.float32)
    for oy in range(ho):
        for ox in range(wo):
            for dy in range(kh):
                for dx in range(kw):
                    hi = stride * oy + dy - 1
                    wi = stride * ox + dx - 1
                    if 0 <= hi < h and 0 <= wi < w:
                        r = (hi * w + wi) * c_in
                        c = (oy * wo + ox) * c_out
                        big[r : r + c_in, c : c + c_out] = k2[dy, dx]
    return big, ho, wo


def _rowtap_weight(k2: np.ndarray, w_in: int, stride: int):
    """[3,3,C,C'] folded conv kernel -> dy-major row-Toeplitz GEMM weight.

    Returns (W [3*w_in*C, w_out*C'] f32, w_out). Plane dy holds, at band
    (wi, wo), K[dy, wi - stride*wo + 1]: one whole-input-row dot per
    (output row, dy) covers every dx tap at once (q8_conv3_rowtap).
    """
    _, kw, c_in, c_out = k2.shape
    w_out = (w_in - 1) // stride + 1
    big = np.zeros((3 * w_in * c_in, w_out * c_out), dtype=np.float32)
    for dy in range(3):
        for wo in range(w_out):
            for dx in range(kw):
                wi = stride * wo + dx - 1
                if 0 <= wi < w_in:
                    r = (dy * w_in + wi) * c_in
                    c = wo * c_out
                    big[r : r + c_in, c : c + c_out] = k2[dy, dx]
    return big, w_out


@dataclasses.dataclass(frozen=True)
class QBlockMeta:
    """Static per-block config."""

    h_in: int
    w_in: int
    h_out: int
    w_out: int
    c_in: int
    c_mid: int
    c_out: int
    stride: int
    s_in: float
    s_h1: float
    s_h2: float
    s_res: float  # residual scale: s_in (identity) or the proj-out scale
    s_out: Optional[float]  # None -> final block, bf16 out
    has_proj: bool
    w2_impl: str = "wholetile"  # "wholetile" | "tap" | "rowtap"
    groups: int = 1  # > 1 only in the JAX package's gdot form (not ported)


def build_q8_backend(folded, scales, h_in: int, w_in: int,
                     first_stage: int = 1, first_block: int = 0,
                     w2_impl: str = "auto"):
    """(FoldedTrunk, deep TrunkScales, input spatial size of block
    (first_stage, first_block)) -> (host params [dict], [QBlockMeta]) for
    the blocks from (first_stage, first_block) to the end of the trunk.

    ``scales`` must be calibrated with deep=True (h1/h2 at every stage plus
    proj and block_out). ``w2_impl`` (one of ``W2_IMPLS``) picks every
    block's 3x3 form, as the JAX package's ``W2_IMPL`` does; a grouped
    trunk's 3x3s run in it as their block-diagonal expansion."""
    if w2_impl not in W2_IMPLS:
        raise ValueError(f"w2_impl must be one of {W2_IMPLS}, got {w2_impl!r}")
    params: List[dict] = []
    metas: List[QBlockMeta] = []
    h, w = h_in, w_in
    n_stages = len(folded.stages)
    for si in range(first_stage, n_stages):
        stride = folded.strides[si]
        for bi, ws in enumerate(folded.stages[si]):
            if si == first_stage and bi < first_block:
                continue
            blk_stride = stride if bi == 0 else 1
            w1, b1, w2, b2, w3, b3 = [np.asarray(a, np.float32) for a in ws[:6]]
            if folded.groups > 1:
                w2 = _expand_grouped(w2, folded.groups)
            has_proj = len(ws) == 8
            c_in = w1.shape[2]
            c_mid = w1.shape[3]
            c_out = w3.shape[3]

            s1 = _per_channel_scale(w1[0, 0])
            s2c = _per_channel_scale(w2)  # per co
            impl = _w2_impl(h, w, w2_impl)
            if impl == "tap":
                # tap-major [9*c_mid, c_mid] rows (dy*3+dx)*c_mid + ci —
                # the row-major reshape of the HWIO kernel
                ho = (h - 1) // blk_stride + 1
                wo = (w - 1) // blk_stride + 1
                w2q = _quant_w(w2.reshape(9 * c_mid, c_mid), s2c)
                b2q, s2q = b2, s2c
            elif impl == "rowtap":
                big2, wo = _rowtap_weight(w2, w, blk_stride)
                ho = (h - 1) // blk_stride + 1
                w2q = _quant_w(big2, np.tile(s2c, wo))
                b2q, s2q = np.tile(b2, wo), np.tile(s2c, wo)
            else:
                big2, ho, wo = _wholetile_weight(w2, h, w, blk_stride)
                w2q = _quant_w(big2, np.tile(s2c, ho * wo))
                b2q, s2q = np.tile(b2, ho * wo), np.tile(s2c, ho * wo)
            s3 = _per_channel_scale(w3[0, 0])

            p = {
                "w1": _quant_w(w1[0, 0], s1),
                "b1": b1,
                "s1": s1,
                "w2": w2q,
                "b2": np.asarray(b2q, np.float32),
                "s2": np.asarray(s2q, np.float32),
                "w3": _quant_w(w3[0, 0], s3),
                "b3": b3,
                "s3": s3,
            }
            if has_proj:
                wd, bd = np.asarray(ws[6], np.float32), np.asarray(ws[7], np.float32)
                sp = _per_channel_scale(wd[0, 0])
                p.update(
                    wp=_quant_w(wd[0, 0], sp),
                    bp=bd,
                    sp=sp,
                )

            is_final = si == n_stages - 1 and bi == len(folded.stages[si]) - 1
            s_in = float(
                scales.block_out[si - 1][-1] if bi == 0
                else scales.block_out[si][bi - 1]
            )
            s_res = float(scales.proj[si][bi]) if has_proj else s_in
            metas.append(
                QBlockMeta(
                    h_in=h, w_in=w, h_out=ho, w_out=wo,
                    c_in=c_in, c_mid=c_mid, c_out=c_out, stride=blk_stride,
                    s_in=s_in,
                    s_h1=float(scales.h1[si][bi]),
                    s_h2=float(scales.h2[si][bi]),
                    s_res=s_res,
                    s_out=None if is_final else float(scales.block_out[si][bi]),
                    has_proj=has_proj,
                    w2_impl=impl,
                )
            )
            params.append(p)
            h, w = ho, wo
    return params, metas


def upload_q8_params(params: List[dict], device) -> List[dict]:
    """Host params -> device tensors, int8 weights transposed to [N, K]."""
    out = []
    for p in params:
        q = {}
        for k, v in p.items():
            if k in ("w1", "w2", "w3", "wp"):
                v = np.ascontiguousarray(v.T)
            q[k] = torch.from_numpy(np.asarray(v)).to(device)
        out.append(q)
    return out


def q8_backend_forward(params: List[dict], metas: List[QBlockMeta],
                       xq: Optional[torch.Tensor], first_h1=None,
                       first_res=None) -> torch.Tensor:
    """int8 block-input patches [N, px*C] in whole-tile layout (quantized
    with the entry scale) -> bf16 final features [N, pxf*Cf].

    ``first_h1`` / ``first_res`` (the hybrid entry, given together): the
    first block's 1x1 reduce and projection outputs computed outside
    GEMM-land, int8 at its ``s_h1`` / ``s_res`` in the whole-tile layout.
    The first block must have a projection; it then runs neither GEMM, and
    ``xq`` may be None."""
    if (first_h1 is None) != (first_res is None):
        raise ValueError("first_h1 and first_res go together")
    if first_h1 is not None and not metas[0].has_proj:
        raise ValueError("the hybrid entry needs a first block with a projection")
    if xq is None and first_h1 is None:
        raise ValueError("q8_backend_forward needs xq or first_h1/first_res")
    for i, (p, m) in enumerate(zip(params, metas)):
        px_in = m.h_in * m.w_in
        px_out = m.h_out * m.w_out
        if i == 0 and first_h1 is not None:
            h1, res = first_h1, first_res
        else:
            h1 = q8_matmul_px(
                xq, p["w1"], p["b1"], p["s1"], px=px_in, c_in=m.c_in,
                in_scale=m.s_in, out_scale=m.s_h1,
            )
            if m.has_proj:
                res = q8_matmul_px(
                    xq, p["wp"], p["bp"], p["sp"], px=px_out, c_in=m.c_in,
                    px_map=(m.stride, m.w_in, m.w_out),
                    in_scale=m.s_in, out_scale=m.s_res, relu=False,
                )
            else:
                res = xq
        if m.w2_impl == "tap":
            h2 = q8_conv3_tap(
                h1, p["w2"], p["b2"], p["s2"],
                h_in=m.h_in, w_in=m.w_in, stride=m.stride, c_in=m.c_mid,
                in_scale=m.s_h1, out_scale=m.s_h2,
            )
        elif m.w2_impl == "rowtap":
            h2 = q8_conv3_rowtap(
                h1, p["w2"], p["b2"], p["s2"],
                h_in=m.h_in, w_in=m.w_in, stride=m.stride, c_in=m.c_mid,
                in_scale=m.s_h1, out_scale=m.s_h2,
            )
        else:
            h2 = q8_matmul(
                h1, p["w2"], p["b2"], p["s2"],
                out_kind="int8", in_scale=m.s_h1, out_scale=m.s_h2,
            )
        xq = q8_matmul_px(
            h2, p["w3"], p["b3"], p["s3"], residual=res, px=px_out,
            c_in=m.c_mid, res_scale=m.s_res,
            out_kind="bf16" if m.s_out is None else "int8",
            in_scale=m.s_h2,
            out_scale=1.0 if m.s_out is None else m.s_out,
        )
    return xq
