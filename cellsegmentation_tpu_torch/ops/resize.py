"""Bilinear resize with align_corners=True semantics, as the JAX package
builds it: two separable gathers with static indices and weights, the H
axis first, each lerp ``lo * (1 - w) + hi * w`` in the input's dtype (bf16
in the seg decoder, every op rounded there). ``F.interpolate(mode=
"bilinear", align_corners=True)`` computes the same sampling but
interpolates in f32 and rounds once, which moves bf16 outputs by an ulp
(tests/test_torch_port_stage3.py measures both against the JAX lerp).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _lerp_coeffs(in_size: int, out_size: int):
    """Static (low_idx, high_idx, high_weight) for align-corners sampling."""
    if out_size == 1 or in_size == 1:
        coords = np.zeros(out_size)
    else:
        coords = np.arange(out_size) * (in_size - 1) / (out_size - 1)
    low = np.clip(np.floor(coords).astype(np.int64), 0, in_size - 1)
    high = np.minimum(low + 1, in_size - 1)
    w = (coords - low).astype(np.float32)
    return low, high, w


def _resize_axis(x: torch.Tensor, axis: int, out_size: int) -> torch.Tensor:
    in_size = x.shape[axis]
    if in_size == out_size:
        return x
    low, high, w = _lerp_coeffs(in_size, out_size)
    lo = x.index_select(axis, torch.from_numpy(low).to(x.device))
    hi = x.index_select(axis, torch.from_numpy(high).to(x.device))
    shape = [1] * x.ndim
    shape[axis] = out_size
    w = torch.from_numpy(w).to(x.device, x.dtype).view(shape)
    return lo * (1 - w) + hi * w


def resize_bilinear_align_corners(x: torch.Tensor, out_h: int,
                                  out_w: int) -> torch.Tensor:
    """Resize NHWC (or HWC) images to (out_h, out_w), align_corners=True."""
    x = _resize_axis(x, x.ndim - 3, out_h)
    return _resize_axis(x, x.ndim - 2, out_w)
