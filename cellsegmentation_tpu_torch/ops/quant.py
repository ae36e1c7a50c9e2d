"""Symmetric int8 quantization primitives: per-output-channel absmax
weights, per-tensor absmax activations, and the int8 product with its
dequantizing epilogue,

    y = (x_q . w_q) * (s_x * s_w) + b      x_q, w_q int8, accumulated in int32.

The weights are quantized by GEMM-land's packing helpers
(ops/q8_trunk.py) and the product is dequantized by the kernels' plain
epilogue (kernels/q8_gemm.py); these are the reference compositions that
pin the numerics. Activations are divided by their scale here, as in the
JAX package's module; the engines' sandwiches multiply by its reciprocal.
"""

from __future__ import annotations

import numpy as np
import torch

from cellsegmentation_tpu_torch.kernels.q8_gemm import dequantize_plain, int_matmul
from cellsegmentation_tpu_torch.ops.q8_trunk import _per_channel_scale, _quant_w


def quantize_weights(w, axis: int = -1):
    """Per-output-channel int8 quantization of ``w`` [..., Cout] along
    ``axis``: (w_q int8 tensor, scale f32 tensor [Cout]), on the host."""
    w = np.moveaxis(np.asarray(w, np.float32), axis, -1)
    scale = _per_channel_scale(w)
    w_q = np.moveaxis(_quant_w(w, scale), -1, axis)
    return torch.from_numpy(np.ascontiguousarray(w_q)), torch.from_numpy(scale)


def calibrate_activation_scale(x) -> float:
    """Per-tensor absmax activation scale of a pilot batch (1.0 for an
    all-zero one)."""
    return float(np.abs(np.asarray(x, np.float32)).max() / 127.0) or 1.0


def quantize_activations(x: torch.Tensor, scale: float) -> torch.Tensor:
    """clip(round(x / scale), -127, 127) as int8, computed in f32."""
    q = torch.round(x.to(torch.float32) / torch.tensor(scale, dtype=torch.float32,
                                                        device=x.device))
    return torch.clamp(q, -127, 127).to(torch.int8)


def int8_gemm(x_q: torch.Tensor, w_q: torch.Tensor, x_scale: float,
              w_scale: torch.Tensor, bias: torch.Tensor | None = None) -> torch.Tensor:
    """int8 [M, K] x int8 [K, N] -> the dequantized f32 [M, N]: the exact
    int32 product (a plain one, not the serving kernels), scaled by
    x_scale * w_scale, plus ``bias``."""
    return dequantize_plain(int_matmul(x_q, w_q.t()), w_scale, bias, x_scale)


def quantized_dense_forward(x: torch.Tensor, w, bias, x_scale: float) -> torch.Tensor:
    """A Dense layer through the int8 path: ``w`` [K, N] quantized per
    output channel, ``x`` quantized at ``x_scale``, the int8 product
    dequantized, plus ``bias``."""
    w_q, w_scale = quantize_weights(np.asarray(w), axis=-1)
    x_q = quantize_activations(x, x_scale)
    return int8_gemm(x_q, w_q.to(x.device), x_scale, w_scale.to(x.device), bias)
