"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: without a card these tests skip (the kernels have no CPU
mode). This file imports no JAX, so it runs on a machine with the card:

    python -m pytest tests/test_torch_port_cuda.py -q
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from cellsegmentation_tpu_torch.kernels import q8_gemm as tq

SCALES = dict(in_scale=0.0123, res_scale=0.037, out_scale=0.91)


def _ints(rng, shape):
    return torch.from_numpy(rng.integers(-127, 128, size=shape).astype(np.int8))


def _epi_args(rng, n):
    bias = torch.from_numpy(rng.normal(0, 2.0, n).astype(np.float32))
    ws = torch.from_numpy((rng.random(n) * 0.02 + 1e-3).astype(np.float32))
    return bias, ws


@pytest.mark.cuda
def test_cuda_kernels_match_plain():
    """On the card: every wrapper launches its kernel (counted) and agrees
    with its plain version bit for bit at a trunk-like shape."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    rng = np.random.default_rng(5)
    dev = torch.device("cuda")
    m, c, n = 450, 256, 256
    x = _ints(rng, (m, 16 * c)).to(dev)
    wt_px = _ints(rng, (n, c)).to(dev)
    wt_tap = _ints(rng, (n, 9 * c)).to(dev)
    wt_mm = _ints(rng, (n, 16 * c)).to(dev)
    # rowtap at layer3 block0's geometry: 4x4 px, stride 2 -> N = 2*c
    wt_row = _ints(rng, (2 * c, 3 * 4 * c)).to(dev)
    b_row, ws_row = (a.to(dev) for a in _epi_args(rng, 2 * c))
    b, ws = (a.to(dev) for a in _epi_args(rng, n))
    r = _ints(rng, (m, 4 * n)).to(dev)
    tq.reset_launch_counts()
    cases = [
        (tq.q8_matmul, (x, wt_mm, b, ws), dict(out_kind="int32")),
        (tq.q8_matmul, (x, wt_mm, b, ws), dict(**SCALES)),
        (tq.q8_matmul_px, (x, wt_px, b, ws),
         dict(residual=r, px=4, c_in=c, px_map=(2, 4, 2), **SCALES)),
        (tq.q8_conv3_tap, (x, wt_tap, b, ws),
         dict(h_in=4, w_in=4, stride=2, c_in=c, out_kind="bf16")),
        (tq.q8_conv3_rowtap, (x, wt_row, b_row, ws_row),
         dict(h_in=4, w_in=4, stride=2, c_in=c, **{k: SCALES[k] for k in
                                                   ("in_scale", "out_scale")})),
        (tq.q8_conv3_rowtap, (x, wt_row, b_row, ws_row),
         dict(h_in=4, w_in=4, stride=1, c_in=c, out_kind="bf16")),
    ]
    for fn, args, kw in cases:
        got = fn(*args, **kw)
        want = tq.PLAIN[fn](*args, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, want), fn.__name__
    assert [f.launches for f in tq.KERNELS] == [2, 1, 1, 2]
