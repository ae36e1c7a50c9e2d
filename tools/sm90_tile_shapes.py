#!/usr/bin/env python3
"""Time every GEMM-land call shape of the ResNet-50 sweep step (M = 7,200
tile rows), the 3x3 convs of both forms included, on the wgmma/TMA core at
each candidate tile shape: BN = 256 or 128 columns, each with the longest
ring that fits. Prints one line per (shape, candidate) with its device time
(warm operands, 50 calls in one CUDA graph) and marks the candidate that
``kernels.q8_gemm.sm90_config`` picks.

Needs one CUDA card:  python3 tools/sm90_tile_shapes.py
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from cellsegmentation_tpu_torch.kernels import q8_gemm as tq  # noqa: E402

M = 7200
# (name, N', segment table, x columns, wt columns, residual, out_kind, relu)
SHAPES = [
    ("layer3.0 reduce", 256, tq.px_segments(16, 512), 8192, 512, False, "int8", 1),
    ("layer3.0 projection", 1024, tq.px_segments(4, 512, (2, 4, 2)), 8192, 512, False,
     "int8", 0),
    ("layer3.0 3x3 tap", 256, tq.tap_segments(4, 4, 2, 256), 4096, 2304, False, "int8", 1),
    ("layer3.0 3x3 rowtap", 512, tq.rowtap_segments(4, 4, 2, 256), 4096, 3072, False,
     "int8", 1),
    ("layer3 expand + residual", 1024, tq.px_segments(4, 256), 1024, 256, True, "int8", 1),
    ("layer3.1-5 reduce", 256, tq.px_segments(4, 1024), 4096, 1024, False, "int8", 1),
    ("layer3.1-5 3x3 matmul", 1024, tq.matmul_segments(1024), 1024, 1024, False, "int8", 1),
    ("layer3.1-5 3x3 rowtap", 512, tq.rowtap_segments(2, 2, 1, 256), 1024, 1536, False,
     "int8", 1),
    ("layer4.0 reduce", 512, tq.px_segments(4, 1024), 4096, 1024, False, "int8", 1),
    ("layer4.0 projection", 2048, tq.px_segments(1, 1024, (2, 2, 1)), 4096, 1024, False,
     "int8", 0),
    ("layer4.0 3x3 matmul", 512, tq.matmul_segments(2048), 2048, 2048, False, "int8", 1),
    ("layer4.0 3x3 rowtap", 512, tq.rowtap_segments(2, 2, 2, 512), 2048, 3072, False,
     "int8", 1),
    ("layer4 expand + residual", 2048, tq.px_segments(1, 512), 512, 512, True, "int8", 1),
    ("layer4.1-2 reduce", 512, tq.px_segments(1, 2048), 2048, 2048, False, "int8", 1),
    ("layer4.1-2 3x3 matmul", 512, tq.matmul_segments(512), 512, 512, False, "int8", 1),
    ("layer4.1-2 3x3 rowtap", 512, tq.rowtap_segments(1, 1, 1, 512), 512, 1536, False,
     "int8", 1),
    ("final expand + residual, bf16", 2048, tq.px_segments(1, 512), 512, 512, True, "bf16",
     1),
]


def candidates(n, out_kind, has_res):
    """Every (BN, ring stages) the core takes for this call: each BN with the
    longest ring that fits."""
    for bn in (256, 128):
        stages = tq.sm90_stages(bn, has_res, out_kind)
        if n % bn == 0 and stages and not (bn == 256 and out_kind == "int32"):
            yield bn, stages


def time_call(bn, stages, n, segs, cols, k_cols, has_res, out_kind, relu, iters=50):
    gen = torch.Generator().manual_seed(0)

    def ints(*shape):
        return torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8).cuda()

    x, wt = ints(M, cols), ints(n, k_cols)
    bias = torch.randn(n, generator=gen).cuda()
    ws = (torch.rand(n, generator=gen) * 0.02 + 1e-3).cuda()
    res = ints(M, segs.px * n) if has_res else None
    out = torch.empty((M, segs.px * n), dtype=tq._OUT_KINDS[out_kind][1], device="cuda")

    def call():
        err = tq._sm90_run(x, wt, bias, ws, res, out, segs, out_kind, 0.01, 0.02,
                           1 / 1.1, relu, bn, stages)
        if err:
            raise RuntimeError(f"launch failed: {err}")

    call()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            call()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("sm90_tile_shapes: needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    for name, n, segs, cols, k_cols, has_res, out_kind, relu in SHAPES:
        pick = tq.sm90_config(M, n, segs, out_kind, has_res)
        for bn, stages in candidates(n, out_kind, has_res):
            us = 1e3 * time_call(bn, stages, n, segs, cols, k_cols, has_res, out_kind, relu)
            mark = "  <- sm90_config" if (bn, stages) == (pick.bn, pick.stages) else ""
            tiles = pick.m_tiles * segs.px * (n // bn)
            print(f"{name:30s} BN {bn} stages {stages} tiles {tiles}: {us:8.2f} us{mark}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
