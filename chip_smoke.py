#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (cellsegmentation_tpu_torch).

Drives the port's stage-1, stage-2 and stage-3 paths and its serving
CLIs' paths on one CUDA card, at the full width of ResNet-50 MILNet (and
ResNeXt-50/101's grouped trunks, the ensemble CLIs' path, and
EfficientNet-B0/B2 through stages 1 and 2) on 299^2 images (stage 2: 32-px tiles, interval 20, 225 tiles per image;
stage 3's draw: 16-px tiles, interval 5, 3,364 tiles per image;
test_tile: 32-px tiles, interval 5, 3,025 tiles per image; detection:
1,200x1,600-px ROIs in 299-px patches), with seeded random weights and
seeded synthetic LYSTO images:

1. device: the card's name and power limit, the TF32 flags;
2. build: csrc/q8_gemm_sm90.cu, the wgmma/TMA core of all four kernels,
   with the ptxas report;
3. kernels: every int8 GEMM call of one sweep step, captured at its real
   shape and data (the auto-form engine's, and the 9 row-Toeplitz 3x3s of
   an engine built with ``w2_impl="rowtap"``), run through its CUDA kernel
   and its plain PyTorch version (int8/int32 exact, bf16 within 1 ulp).
   Each call timed in CUDA graphs with cold operands (copies rotated past
   twice L2) and warm, beside ``torch._int_mm`` on the same GEMM (and
   cuDNN's bf16 conv for the 3x3s) and the card's bound for the work, which
   no time may beat; each 3x3 of the auto form beside its rowtap form;
   then the q8g engine's calls of one sweep step (GEMM-land from the
   tile's 8x8 map: 29 q8_matmul_px, 5 q8_conv3_tap, 8 q8_matmul; the
   64-group layer2 reduce among them) and its row-Toeplitz form's layer-2
   3x3s, checked and timed alike; then the GEMM-land seam
   (``q8_backend_forward``) on one captured entry tensor in both 3x3
   forms, bit-identical, timed in turns;
4. slice: ``make_tile_infer_step(engine="auto")`` must resolve to q8dg;
   ``inference_tiles`` over flip-free and flipped image batches and
   ``sample_topk``, with launch counts of 1 tap, 8 q8_matmul and 20
   q8_matmul_px per image batch; a small batch on the card agrees with the
   same batch through the port on the CPU;
5. rowtap: a sweep with the rowtap engine launches 9 q8_conv3_rowtap and
   20 q8_matmul_px per image batch (no q8_matmul, no q8_conv3_tap) and
   gives the auto sweep's probs;
5a. variants: q8dg's conv/GEMM splits on the [slice] model, source and
   calibration, built with ``make_dense_tile_probs``'s split keywords:
   (2, 0), (1, 1) and (1, 0) ((1, 0) through the hybrid entry); each sweep
   counted (1 / 8 / 20, 4 / 8 / 26 and 5 / 8 / 27 q8_conv3_tap / q8_matmul
   / q8_matmul_px per batch), timed in turns with its peak memory, against
   the CPU under q8dg's limits, and against (2, 0) on the card and the
   exact graph under the split gates, which see a fault the card shares
   with the CPU; every kernel call of one (1, 0) and one (1, 1) step
   against its plain version, timed as in [kernels]; two planted faults
   ((1, 0) on the folded pair, (1, 1)'s seam at twice its scale) that the
   split gates alone must reject;
6. train: ``train_stage2``, 2 epochs of the MIL cycle, once per 3x3 form:
   the same selections and the same ``fc_tile``; the train step timed at
   the CLI's 40,960-tile batch; one train step on the card against the
   same step through the port on the CPU, and two planted faults (wrong
   flips, a transposed gather) that this gate must reject;
7. stage1: ``train_stage1`` for 2 epochs at the CLI's defaults (batch 48,
   Adam, lr 5e-4) on 232 augmented samples, which launches no hand-written
   kernel; the train step's images/s, peak memory and MFU at batch 48;
   ``inference_image`` images/s at batch 128 with ``cls_limit``; one f32
   image train step on the card against the CPU under injected dropout
   masks, and three planted faults (an unbiased running variance, dropout
   scaled by keep, flips dropped) that this gate must reject; the pt1
   checkpoint loaded into a fresh model (equal state, bit-equal counts)
   and a q8dg sweep batch on its encoder; a profile of one train step;
7a. jaxckpt: the [stage1] model and its Adam state written as the JAX
   package's checkpoints (flax msgpack, by the port's own writer) with
   their file sizes and read/convert seconds: the pt2 loaded as test_tile
   loads it and swept with engine auto on 64 samples, counted (1 / 8 / 20
   q8_conv3_tap / q8_matmul / q8_matmul_px a batch), its state and probs
   bit-equal to the in-memory model's; one stage-1 step resumed from the
   JAX-format pt1 bit-equal to one resumed from the port's own pt1 of the
   same state (deterministic algorithms); three planted faults (a conv
   kernel without the HWIO transpose, an Adam nu leaf dropped, a truncated
   file) that these gates must reject;
7b. alternative: ``make_alternative_train_step`` on ResNet-50 (a tile CE
   update, then an image CE + MSE update, on one model), 3 steps on the
   card, then one f32 step card vs CPU on the stage-1 gate's images and 64
   of their tiles, and a planted fault (the image half reading the
   parameters from before the tile update) that this gate must reject;
8. stage3: ``draw_pseudo_masks`` as the ``train_seg`` CLI calls it (engine
   "auto", which must resolve to per-tile q8 on the 16/5 grid; image batch
   128; threshold 0.95) on 128 images, counted: no hand-written kernel is
   launched; its images/s, tiles kept and peak memory. The per-tile q8
   log-odds against the exact graph on the card and against the CPU.
   ``train_stage3`` for 2 epochs at the CLI's defaults (batch 32, Adam, lr
   5e-5) on the drawn masks, augmented, under torch's deterministic
   algorithms (the same pt3 weights every run), which launches no
   hand-written kernel; the seg step's images/s, MFU and peak memory at batch 32; one
   f32 seg step on the card against the CPU, and three planted faults
   (align_corners=False, masks left unflipped, encoder statistics frozen)
   that this gate must reject; the pt3 file into a fresh model, whose seg
   probabilities are bit-equal to the trained model's; profiles of one
   draw batch and one seg step;
9. serve: the q8g and q8d sweeps at 299/32/20, counted (q8g: the launches
   above per image batch; q8d: none), timed in turns with q8dg, each
   against the port on the CPU and against the exact graph; then
   ``test_tile``'s path at its defaults (32/5 grid, threshold 0.95, image
   batch 128) on 64 images with the flax, q8 and q8g engines, where q8dg
   and auto must resolve to q8g and q8;
10. detect: with ``cv2`` and ``sklearn`` unimportable, ``cell_detect`` as
   ``test_seg --detect`` runs it (batch 8) on the [stage3] pt3 model over
   four 1,200x1,600 ROI arrays (30 patches each), with and without the dot
   images: the CSV rows are each stitched mask's top-count centres, the
   mask PNGs decode to the masks stitched from the seg step's own outputs,
   the counts are the sums of the patches' rounded counts, no hand-written
   kernel runs; host time of the localization by part, the device's busy
   share; one patch batch's seg probs card vs CPU, and two planted faults
   (one decoder BatchNorm on its initial statistics) that this gate must
   reject; the localization alone
   on planted cells (each found within 2 px, F1 1); ``test_seg``'s point
   evaluation on 16 images;
11. kernels-resnext: each ResNeXt's (resnext50_32x4d, resnext101_32x8d)
   q8g engine at full width on one step of 32 images, counted (29 / 5 / 8
   and 63 / 5 / 25 q8_matmul_px / q8_conv3_tap / q8_matmul), every distinct
   call against its plain version and timed as in [kernels] (the 101's
   repeated blocks once, weighted by their count); each grouped 3x3's
   block-diagonal kernel beside the grouped conv's own bound and cuDNN's
   bf16 grouped conv;
12. resnext: ResNeXt-50's sweeps on the [slice] source with auto (q8dg,
   the dense conv chain: no kernel), per-tile q8 (no kernel), q8g and q8dg
   with the grouped dense GEMM, counted, timed in turns with their peak
   memory; each against the port on the CPU and the exact graph under
   ResNeXt's own limits, each card-vs-CPU gate against planted faults
   (groups ignored in the expansion, the wrong group's scales and bias,
   the wrong group's kernel);
13. ensemble: ``train_ensemble``'s folds (3, 1 epoch, batch 48) on
   ResNeXt-50 from arrays, no hand-written kernel; each checkpoint
   reloaded; each fold's count head rewritten to spread its counts over
   the test images, then ``test_ensemble``'s counts against round(mean) of
   the folds' own, which is neither a fold's count nor the median; the f32 card-vs-CPU image step gate on ResNeXt-50 with [stage1]'s
   planted faults, its images/s, MFU and peak memory;
14. effnet: EfficientNet-B0 and B2 at full width, every BatchNorm's
   statistics set from the 1,800 tiles of 8 images (``settle_batch_stats``):
   the sweep at
   299/32/20 with auto (which must resolve to per-tile q8, the MBConv
   engine) and flax in turns, counted (no hand-written kernel), with peak
   memory; card vs CPU and engine vs exact graph under the limits below,
   against three planted faults (the squeeze-excite gate left out, a
   block's sandwich scale taken from its neighbour, stochastic depth at
   inference); each one's stage-1 step at batch 48 (images/s, MFU, peak
   memory) and B0's f32 card-vs-CPU gate under injected dropout and
   stochastic-depth masks, against two planted faults (no 1/keep rescale,
   stochastic depth on a non-residual block); ``train_stage1`` and
   ``train_stage2`` one epoch each, their pt1/pt2 files reloaded exactly,
   ``draw_pseudo_masks`` for one batch at 16/5 (auto -> q8; the statistics
   set from its tiles, the heads pinned as in [stage3]),
   ``train_stage3`` refused; profiles of the sweep step and the stage-1
   step with depthwise convs and the squeeze-excite apart;
14a. multiproc: the port's ``parallel/``: one world-size-1 group through
   ``maybe_initialize`` on the card (NCCL); then two ranks of this script
   (``--mp-rank``), spawned with a timeout, share the card over gloo: each
   sweeps its contiguous slice of every image batch of ``train_stage2``'s
   split sweep (engine auto, q8dg) on the [slice] source's first 64
   samples, counted per rank (1 / 8 / 20 tap / q8_matmul / q8_matmul_px per
   call); the merged sweep bit-equal to this process's sweep at the
   per-rank batch and inside [slice]'s gate against the full batch, its
   images/s beside the 1-process sweep's; a 1-epoch ``train_stage2`` over
   both ranks (the same selections and fc_tile on each); one f32 stage-1
   step at global batch 16 against the 1-rank step on the concatenated
   batch, and three planted faults (local BatchNorm statistics, the loss
   over the local count, the gradients averaged over the ranks) that this
   gate must reject;
14b. bench: both cells of the port's benchmark (``BENCHMARK.json``)
   through its own functions at a short window: ``r50-sweep-b192`` with
   one timed sweep of 1,536 samples at image batch 192, and
   ``r50-stage1-b48`` with two timed epochs (its gate takes one more step
   of ``train_stage1``'s own step on the train state the last leaves), the
   host recorded and not controlled; each result line
   printed, each cell's gates passing, then the sweep gates against two
   planted faults (layer4.2's residual dropped from its ``q8_matmul_px``
   epilogue, the flip codes ignored) and the stage-1 gate against
   [stage1]'s three planted faults and two in Adam (its moments dropped,
   its step count restarted), each of which its gates must reject;
15. profile: device time by kernel over one sweep step: 29 launches of the
   wgmma kernel under its own name and no other hand-written kernel;
16. one JSON line with every kernel's launches and times (the q8g path's,
   the JAX-format pt2's sweep's, q8dg's (1, 0) and (1, 1) splits' and each
   ResNeXt's kernels as entries of their own, ``"path"``);
17. last line: {"ok": true, "device": {...}}.

Run from the repository root: ``python3 chip_smoke.py`` (one card). Exits
non-zero, printing no result, when a phase fails or no card is present.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

from cellsegmentation_tpu_torch.bench import stage1 as bench_stage1
from cellsegmentation_tpu_torch.bench import sweep as bench_sweep
from cellsegmentation_tpu_torch.bench.common import (
    BF16_PEAK_FLOPS,
    HEAD_SCALE,
    BenchError as PhaseError,
    batch_of,
    check,
    quiet_head,
    step_flops,
)
from cellsegmentation_tpu_torch.bench.faults import planted_stage1_fault
from cellsegmentation_tpu_torch.bench.gates import (
    CHECK_LR as S1_CHECK_LR,
    logodds,
    stat_scale,
    step_gap,
    within,
)
from cellsegmentation_tpu_torch.bench.gates import step_reading as stage1_step_reading
from cellsegmentation_tpu_torch.bench.roofline import (
    PEAK_BYTES,
    PEAK_INT8_OPS,
    call_work,
    capture_calls,
    graph_ms,
    measure_calls,
    print_stats,
)
from cellsegmentation_tpu_torch.bench.sweep import sweep_once, warm_flips
from cellsegmentation_tpu_torch.bench.tracing import profile_rows

SOURCES = {
    "q8_matmul": "cellsegmentation_tpu_torch/csrc/q8_gemm_sm90.cu",
    "q8_matmul_px": "cellsegmentation_tpu_torch/csrc/q8_gemm_sm90.cu",
    "q8_conv3_tap": "cellsegmentation_tpu_torch/csrc/q8_gemm_sm90.cu",
    "q8_conv3_rowtap": "cellsegmentation_tpu_torch/csrc/q8_gemm_sm90.cu",
}
REPLACES = {
    "q8_matmul": "cellsegmentation_tpu/ops/q8_gemm.py:128",
    "q8_matmul_px": "cellsegmentation_tpu/ops/q8_gemm.py:542",
    "q8_conv3_tap": "cellsegmentation_tpu/ops/q8_gemm.py:259",
    "q8_conv3_rowtap": "cellsegmentation_tpu/ops/q8_gemm.py:407",
}
# The random tile head's kernel is scaled by HEAD_SCALE (bench/common.py; as
# the CPU test of the full-width sweep does), so the log-odds of the tile
# probs stay near 0 instead of saturating at -20..-10; log-odds are linear
# in that kernel, so every difference below is HEAD_SCALE times the
# unscaled one.
# Card vs CPU, q8dg log-odds. The same Python runs on both devices and the
# GEMM-land kernels are bit-exact (phase 3); what differs is conv-land:
# cuDNN and oneDNN round bf16 convs in other places, and the int8
# sandwiches turn some of those roundings into 1-LSB flips. Unscaled, two
# card runs read max 1.71-1.76, mean 0.100-0.115 here, against max 0.41,
# mean 0.106 for the exact bf16 graph between the same devices; scaled,
# that is max ~0.018, mean ~0.0012. The limits leave ~3x and ~4x of room.
CARD_CPU_MAX, CARD_CPU_MEAN = 0.05, 0.005
# q8dg against the exact per-tile graph on the card: the engine's own
# approximation. The same distance on the CPU (where the port matches the
# JAX engine, tested) is measured in the same run; the card may add at most
# the card-vs-CPU mean limit to it, and it stays under an absolute mean of
# Q8DG_EXACT_MEAN (unscaled, two card runs read 4.47-4.49: ~0.045 scaled).
Q8DG_EXACT_MEAN = 0.1
# a wrong tile order or flip would break the per-image rank correlation
MIN_RANK_CORR = 0.8
# uncounted sweeps timed after the counted one; images/s is their median
SWEEP_REPEATS = 4
# q8g's hand-written kernel calls per sweep step (image batch): layers 3-4
# as q8dg's (8 / 20 / 1), layer 2 from the tile's 8x8 map (9 q8_matmul_px,
# 4 q8_conv3_tap), as the JAX package's q8g makes them (counted on the CPU,
# tests/test_torch_port_serve.py)
Q8G_LAUNCHES = {"q8_matmul": 8, "q8_matmul_px": 29, "q8_conv3_tap": 5,
                "q8_conv3_rowtap": 0}
# [variants]: q8dg's conv/GEMM splits (make_dense_tile_probs keywords),
# each with its launches per sweep step as (q8_conv3_tap, q8_matmul,
# q8_matmul_px), the JAX package's counts (tests/test_torch_port_dense_variants.py):
# the (1, 1) and (1, 0) splits move layer 2's blocks into GEMM-land
VARIANTS = {
    "2,0": ({}, (1, 8, 20)),
    "1,1": (dict(gemm_first_stage=1, gemm_first_block=1), (4, 8, 26)),
    "1,0": (dict(gemm_first_stage=1, gemm_first_block=0), (5, 8, 27)),
}
# the split gates, which see a plan error that the card shares with the CPU
# port: each split's log-odds against (2, 0)'s on the card (the same
# weights and scales, int8 points moved; max, mean, per-image rank
# correlation) and against the exact graph's (mean). Set from the splits'
# first card readings (vs (2, 0) max 0.0217-0.0226, mean 0.0060-0.0062,
# rank 0.673-0.683; vs exact 0.0458-0.0461): a doubled gap fails the mean
SPLIT_VS_20_MAX, SPLIT_VS_20_MEAN, SPLIT_VS_20_RANK = 0.04, 0.01, 0.5
SPLIT_EXACT_MEAN = 0.06
# [alternative]: make_alternative_train_step on ResNet-50, ALT_STEPS steps on
# the card (Adam), then one f32 SGD step card vs CPU on the stage-1 gate's 8
# images and ALT_TILES tiles of them, under the S1_* limits (the fc_tile
# update held like the encoder's)
ALT_STEPS, ALT_TILES = 3, 64
# [kernels-resnext], [resnext], [ensemble]: the two ResNeXts, 32 groups
RESNEXTS = ("resnext50_32x4d", "resnext101_32x8d")
RESNEXT_GROUPS = 32
# q8g's calls per sweep step on each (the JAX package's q8g counted on the
# CPU, tests/test_torch_port_resnext.py): ResNeXt-50's are ResNet-50's,
# ResNeXt-101's layer 3 has 23 blocks
RESNEXT_Q8G_LAUNCHES = {
    "resnext50_32x4d": Q8G_LAUNCHES,
    "resnext101_32x8d": {"q8_matmul": 25, "q8_matmul_px": 63, "q8_conv3_tap": 5,
                         "q8_conv3_rowtap": 0},
}
# q8dg with the grouped dense GEMM: layers 3-4 as ResNet-50's q8dg
RESNEXT_Q8DG_LAUNCHES = {"q8_matmul": 8, "q8_matmul_px": 20, "q8_conv3_tap": 1}
# [resnext]'s own log-odds limits (HEAD_SCALE applies): ResNeXt-50's sound
# engines read card vs CPU max 0.00016-0.00033, mean 0.000002-0.000019, and
# card vs the exact graph mean 0.000094-0.000235 (three card runs, NVIDIA
# H100 80GB HBM3, 700 W); its planted faults read card vs CPU max
# 0.00056-0.00588, mean 0.000191-0.004059. ResNet-50's limits (CARD_CPU_*,
# Q8DG_EXACT_MEAN) sit 150-1000x above these readings and would pass a
# fault that keeps the tiles' order.
RESNEXT_CARD_CPU_MAX, RESNEXT_CARD_CPU_MEAN, RESNEXT_EXACT_MEAN = 1e-3, 1e-4, 1e-3
# [ensemble]: train_ensemble's folds on synthetic images from arrays, and
# test_ensemble on a test source; each fold's counts before the head's ReLU
# are then spread to these means and standard deviations over the images
ENSEMBLE_IMAGES, ENSEMBLE_K, ENSEMBLE_EPOCHS, ENSEMBLE_TEST_IMAGES = 144, 3, 1, 64
ENSEMBLE_COUNT_MEANS, ENSEMBLE_COUNT_STDS = (5.0, 7.0, 10.0), (2.0, 3.0, 4.0)
# [serve]: test_tile's defaults (32/5 grid, threshold 0.95, image batch 128)
# on SERVE_TILE_IMAGES synthetic images, with these engines
SERVE_TILE_IMAGES, SERVE_TILE_BATCH = 64, 128
SERVE_TILE_ENGINES = ("flax", "q8", "q8g")
# [detect]: test_seg --detect's batch on DETECT_IMAGES ROI arrays of
# DETECT_HW px (30 patches of 299 px each)
DETECT_IMAGES, DETECT_HW, DETECT_BATCH = 4, (1200, 1600), 8
# The seg probs of one patch batch, card vs CPU: the same bf16 model on
# both, cuDNN and oneDNN rounding bf16 convs in other places through the
# encoder and the decoder's 16 convs. Set before the first chip run at
# 0.05 / 0.005. The pt3 model comes from [stage3]'s training, which moved
# between runs while it ran with atomic index_add in the resizes' backward
# (seven runs on NVIDIA H100 80GB HBM3, 700 W read max 0.0366-0.0507, mean
# 0.0026-0.0027), so [stage3] trains under torch's deterministic
# algorithms: two runs of it in one process gave bit-equal pt3 files, and
# the gate read max 0.041482 mean 0.0027341 on them. The planted faults
# each leave one decoder BatchNorm on its initial statistics (mean 0,
# variance 1) in the CPU model; they read max 0.906 / 0.869, mean 0.442 /
# 0.138 (upconv1 / upconv8; NVIDIA H100 80GB HBM3, 700 W).
DETECT_CARD_CPU_MAX, DETECT_CARD_CPU_MEAN = 0.05, 0.005
DETECT_FAULT_BNS = ("upconv1", "upconv8")
# planted cells for the localization alone: every centre within this many
# px of a kept one
PLANTED_TOL_PX = 2
# test_seg's point evaluation on this many images
POINT_EVAL_IMAGES = 16
# One train step on the card against the same step through the port on the
# CPU, same weights and tiles. The encoder runs bf16 convs on both (cuDNN
# and oneDNN round in other places: with HEAD_SCALE the exact graph's
# log-odds differ by mean ~0.001 between the devices, measured in [slice]).
# The first 256 selected tiles read loss 1.99e-5 relative and fc_tile
# gradient cosine 0.999999 card vs CPU, but a planted wrong flip read only
# 4.77e-4 and 0.999997: most tiles are flat background and noise, and with
# the head scaled the gradient is dominated by the tiles' common features.
# So the check step takes the 256 selected tiles with the most pixel
# variance. There (H100 run): card vs CPU loss 5.73e-7 relative, 1 - cos
# 1.3e-6, gradient max gap over max magnitude 3.45e-3; the planted faults
# (every tile flipped wrongly; x and y swapped in the gather, both planted
# by this phase in every run, which fails unless the gate rejects them)
# read loss 2.83e-3 / 3.81e-4, 1 - cos 2.5e-4 / 2.6e-4, gap 2.07e-2 /
# 2.76e-2. Each limit sits between the two, with room on both sides: loss
# 35x / 19x, 1 - cos 15x / 12x, gap 2.9x / 2.1x.
# [multiproc]: MP_RANKS ranks share the one card over gloo, spawned by this
# script; the split sweep on the [slice] source's first MP_SAMPLES samples,
# MP_SWEEPS times, each rank's slice of every image batch; a stage-1 step
# at global batch MP_STAGE1_BATCH (f32, TF32 off) against the 1-rank step on
# the concatenated batch, which differs from it in summation order alone.
# Set before the first card run at the CPU test's limits widened 10x (loss
# 1e-4, cosine 0.9999, statistics 1e-4), the cosine failed there: the first
# card run read loss rel 0, cosine 0.999805, statistics 9.17e-6 (NVIDIA H100
# 80GB HBM3, 700 W). Train-mode BatchNorm over 8-16 rows amplifies f32
# rounding into the gradient ([stage1]'s card-vs-CPU step reads cosine
# 0.999813), and on the CPU the 1-rank step on its rows reversed, the same
# sums in another order, sits further from the step in order (1 - cos
# 4.7e-5) than the 2-rank step does (5.7e-7): the phase prints that floor
# beside the gate. The cosine limit is [stage1]'s, S1_GRAD_MIN_COS; the
# planted faults read on the CPU loss rel 0.05 / 1, far outside. A cosine
# cannot see a gradient's size, so the gradient norm ratio is gated too
# (|norm / 1-rank norm - 1|): set before its first card run at 1e-2, with
# the clean reading expected near 1 - cos (about 2e-4) and the planted
# "gradients averaged over the ranks" reading 0.5 by construction. The
# card read 1.07e-3 clean (the floors beside it 8.3e-4 / 1.0e-3) and 0.501
# planted.
MP_RANKS, MP_SAMPLES, MP_SWEEPS, MP_STAGE1_BATCH = 2, 64, 3, 16
MP_TIMEOUT_S = 600
MP_LOSS_RTOL, MP_GRAD_MIN_COS, MP_STAT_RTOL = 1e-4, 0.9995, 1e-4
MP_GRAD_NORM_RTOL = 1e-2
MP_FAULTS = ("local BatchNorm", "loss over the local count",
             "gradients averaged over the ranks")
TRAIN_LOSS_RTOL = 2e-5
TRAIN_GRAD_MIN_COS = 0.99998
TRAIN_GRAD_MAX_GAP = 1e-2
# tiles per card-vs-CPU train step (the CPU runs the full-width encoder)
TRAIN_CHECK_TILES = 256
# the CLI's stage-2 tile batch, and the timed train steps at that width
TILE_BATCH = 40960
TRAIN_RATE_STEPS = 5
# [stage1]: the CLI's defaults, 2 epochs on 64 base images (kfold 10: 58
# train x 4 flips = 232 samples, 6 validation images)
STAGE1_BATCH, STAGE1_LR, STAGE1_EPOCHS = 48, 5e-4, 2
# The stage-1 card-vs-CPU gate: one image train step of the full-width
# model in f32 (TF32 off, phase 1) on 8 images, the same weights and the
# same injected dropout masks on both devices, SGD at lr 5e-4 so an
# update is lr x the gradient. Readings: the loss's relative gap, the
# cosine of all trainable gradients, the largest gap of a running
# statistic over its tensor's largest value, and the largest gap of an
# updated weight over the largest update. Train-mode BatchNorm over 8
# images amplifies rounding (the heads' BatchNorm1d normalizes each
# feature by 8 values), so even in f32 the card and the CPU part by loss
# 2.07e-5, cosine 0.999813, statistics 4.19e-5 and update 1.94e-2 (two H100
# runs alike). The planted faults read loss 4.33e-2 / 4.10e-2 (dropout
# scaled by keep / flips dropped) and statistics 0.107 (the unbiased
# running variance, which moves no loss). The clean step passes each limit
# with 2.7x (cosine) to 24x (statistics) of room, and each fault fails one
# by 100x or more:
S1_LOSS_RTOL = 2e-4
S1_GRAD_MIN_COS = 0.9995
S1_STAT_RTOL = 1e-3
S1_WEIGHT_RTOL = 0.1
S1_CHECK_IMAGES = 8
# [stage3]: the train_seg CLI's draw (16/5 grid, image batch 128, threshold
# 0.95) on STAGE3_IMAGES synthetic images, then train_stage3 at its defaults
STAGE3_IMAGES, STAGE3_TILE, STAGE3_INTERVAL = 128, 16, 5
STAGE3_DRAW_BATCH, STAGE3_THRESHOLD = 128, 0.95
STAGE3_BATCH, STAGE3_LR, STAGE3_EPOCHS = 32, 5e-5, 2
# With HEAD_SCALE no tile's log-odds reach the threshold's 2.944; the tile
# head's bias is set so that this share of the first two images' tiles
# pass it (the share over all images is printed beside it).
STAGE3_PASS_SHARE = 0.02
# Per-tile q8 log-odds (head x HEAD_SCALE), card vs CPU on 2 images: the
# same Python on both, cuDNN and oneDNN round bf16 convs in other places and
# the int8 sandwiches turn some of those into 1-LSB flips, as for q8dg
# (whose card-vs-CPU reading was max 0.018, mean 0.0012): the q8dg limits.
Q8_CARD_CPU_MAX, Q8_CARD_CPU_MEAN = 0.05, 0.005
# per-tile q8 against the exact per-tile graph on the card: mean at most
# Q8_EXACT_MEAN, and at most the same distance on the CPU + Q8_CARD_CPU_MEAN
# (on the CPU, before the first chip run: mean 0.00095 on one image of
# another seed, 0.0059 on this phase's two)
Q8_EXACT_MEAN = 0.02
# The stage-3 card-vs-CPU gate: one seg step of the full-width f32 model
# (TF32 off) on S3_CHECK_IMAGES images (flip codes 0-3, masks flipped with
# them), the same seeded weights on both devices. Readings: the loss's
# relative gap, the cosine of the decoder's gradients, and the largest gap
# of an encoder or a decoder running statistic over its tensor's largest
# value. Set before the first chip run, from the stage-1 gate's f32
# readings (loss 2.07e-5, cosine 0.999813, statistics 4.19e-5).
S3_LOSS_RTOL = 2e-4
S3_GRAD_MIN_COS = 0.9995
S3_STAT_RTOL = 1e-3
S3_CHECK_IMAGES = 4
# [effnet]: EfficientNet-B0 and B2 at full width. At their kaiming fan_out
# init the eval-mode activations shrink to ~1e-14 over the blocks, so every
# BatchNorm's statistics are set first from the sweep's own 32-px tiles of
# EFFNET_SETTLE_IMAGES images. (Set from 32 whole images, the tile
# log-odds spread over a std of 0.00004-0.00012 only, below the card-vs-CPU
# noise of the sweep, and rank correlation read nothing.)
EFFNETS = ("efficientnet_b0", "efficientnet_b2")
EFFNET_SETTLE_IMAGES = 8
# Sweep log-odds (head x HEAD_SCALE) on 2 images, card vs CPU: (max, mean,
# per-image rank correlation) limits per model and engine (auto: the MBConv
# q8 engine). First reading (NVIDIA H100 80GB HBM3, 700 W): B0 auto max
# 0.0063 mean 0.000047 rank 0.992, flax 0.0062 / 0.00011 / 0.987; B2 auto
# 0.032 / 0.00063 / 0.826 (23 int8 sandwiches, each LSB 0.13-0.37 of an
# O(1) activation: the card's bf16 roundings flip more of them), flax
# 0.0099 / 0.000089 / 0.999. B0's planted faults read: the squeeze-excite
# gate left out 0.90 / 0.24 / 0.05; a block's scale from its neighbour
# 0.028 / 0.0012 / 0.65; stochastic depth at inference 0.29 / 0.0045 /
# 0.51. B0's limits sit 3-6x above its clean readings and 1.4-800x below
# each fault's; B2's, 3x above its clean readings, are a sanity gate (its
# faults are not planted).
EFFNET_LIMITS = {
    "efficientnet_b0": {"auto": (0.02, 3e-4, 0.8), "flax": (0.02, 5e-4, 0.8)},
    "efficientnet_b2": {"auto": (0.1, 2e-3, 0.6), "flax": (0.03, 3e-4, 0.8)},
}
# q8 against the exact graph on the card: mean at most EFFNET_EXACT_MEAN and
# at most the CPU's own distance + EFFNET_EXACT_SLACK (first reading: card
# 0.0023 / 0.0017, CPU 0.0024 / 0.0018, B0 / B2)
EFFNET_EXACT_MEAN, EFFNET_EXACT_SLACK = 0.01, 1e-3
# stage 1 on B0: the [stage1] batch, one epoch of train_stage1 and of
# train_stage2, and the draw of one image batch on the 16/5 grid
EFFNET_DRAW_BATCH = 32


@contextlib.contextmanager
def deterministic_algorithms():
    """torch's deterministic algorithms for a block (index_add_ without
    atomics in the resizes' backward, deterministic cuDNN convolutions), so
    a training run on the card gives the same weights every time."""
    import torch

    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "unknown"
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
          f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    return card


def phase_build():
    from cellsegmentation_tpu_torch.kernels import build, q8_gemm

    t0 = time.perf_counter()
    paths = build.build_all(["q8_gemm_sm90.cu"])
    q8_gemm._lib_sm90()
    print(f"[build] {time.perf_counter() - t0:.1f} s")
    for source, path in paths.items():
        print(f"[build] {source} -> {path.name} in "
              f"{build.build_secs.get(source, 0.0):.1f} s")
        for ln in build.build_logs.get(source, "").splitlines():
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln:
                print(f"[build]   {ln.strip()}")


def _in_turns(fns, args, kw, cold=True):
    """Graph times of several versions of one call in turns (a, b, b, a):
    the mean of each version's two readings."""
    order = list(fns) + list(reversed(fns))
    ms = {f: 0.0 for f in fns}
    for f in order:
        ms[f] += graph_ms(f, args, kw, cold=cold) / 2
    return ms


def phase_kernels(calls):
    """Each kernel against its plain version at the main path's shapes,
    timed cold and warm beside its bound and library yardsticks."""
    from cellsegmentation_tpu_torch.kernels import q8_gemm as tq

    stats, three = measure_calls(calls, "kernels")
    blocks = [f"layer3.{i}" for i in range(6)] + [f"layer4.{i}" for i in range(3)]
    auto = [(fn, ms) for fn, ms in three if fn is not tq.q8_conv3_rowtap]
    row = [ms for fn, ms in three if fn is tq.q8_conv3_rowtap]
    check(len(auto) == len(row) == len(blocks), f"3x3 calls {len(auto)} / {len(row)}")
    for name, (fn, a_ms), r_ms in zip(blocks, auto, row):
        form = "tap" if fn is tq.q8_conv3_tap else "whole-tile matmul"
        print(f"[kernels] 3x3 of {name}: auto form ({form}) {a_ms:.5f} ms, rowtap "
              f"{r_ms:.5f} ms cold ({r_ms / a_ms:.2f}x)")
    print(f"[kernels] 3x3 convs of one step: auto form {sum(m for _, m in auto):.4f} ms, "
          f"rowtap form {sum(row):.4f} ms cold")
    for fn, s in stats.items():
        check(s["calls"] > 0, f"{fn.__name__}: no call on the main path")
    print_stats(stats, "kernels")
    return stats


def phase_kernels_q8g(calls, calls_row):
    """The q8g engine's GEMM-land, from the 8x8 layer1 map of a 32-px tile:
    every call of one sweep step (layer2's are shapes no other engine
    sends: the 64-group 1x1 reduce, the stride-2 tap from 8x8, the 4x4
    taps) and the row-Toeplitz form's layer-2 3x3s, each against its plain
    version and timed as [kernels] times them."""
    from cellsegmentation_tpu_torch.kernels import q8_gemm as tq

    kinds = {fn.__name__: sum(c[0] is fn for c in calls) for fn in tq.KERNELS}
    check(kinds == Q8G_LAUNCHES, f"q8g step calls {kinds}, want {Q8G_LAUNCHES}")
    first = calls[0]
    check(first[0] is tq.q8_matmul_px and first[2]["px"] == tq.SM90_MAX_GROUPS,
          f"q8g's first call {first[0].__name__} {first[2].get('px')}")
    row_l2 = [c for c in calls_row if c[0] is tq.q8_conv3_rowtap][:4]
    check([c[2]["h_in"] for c in row_l2] == [8, 4, 4, 4],
          f"rowtap layer-2 inputs {[c[2]['h_in'] for c in row_l2]}")
    stats, _ = measure_calls(calls, "kernels-q8g")
    row_stats, _ = measure_calls(row_l2, "kernels-q8g")
    stats[tq.q8_conv3_rowtap] = row_stats[tq.q8_conv3_rowtap]
    print_stats(stats, "kernels-q8g",
                 "per image batch (rowtap: layer 2's 4 in the rowtap form)")
    return stats


def phase_seam(step, step_row, entry):
    """The GEMM-land seam, ``q8_backend_forward`` on one captured entry
    tensor, in the auto and row-Toeplitz 3x3 forms: bit-identical features,
    then both timed in CUDA graphs, in turns."""
    import torch

    from cellsegmentation_tpu_torch.ops.q8_trunk import q8_backend_forward

    forms = [m.w2_impl for m in step_row.engine.metas]
    check(forms == ["rowtap"] * 9, f"rowtap engine forms {forms}")

    def auto(x):
        return q8_backend_forward(step.engine.qparams, step.engine.metas, x)

    def rowtap(x):
        return q8_backend_forward(step_row.engine.qparams, step_row.engine.metas, x)

    with torch.no_grad():
        f_auto, f_row = auto(entry), rowtap(entry)
        torch.cuda.synchronize()
        d = float((f_auto.float() - f_row.float()).abs().max())
        check(torch.equal(f_auto, f_row), f"rowtap and auto trunk features differ by {d}")
        ms = _in_turns((auto, rowtap), (entry,), {}, cold=False)
    print(f"[seam] q8_backend_forward, entry {tuple(entry.shape)} int8 -> bf16 features "
          f"{tuple(f_auto.shape)}, CUDA graph: auto form {ms[auto]:.4f} ms, rowtap form "
          f"{ms[rowtap]:.4f} ms ({ms[rowtap] / ms[auto]:.2f}x), in turns; max |diff| {d}")


def _gate(lg, lc, max_lim=CARD_CPU_MAX, mean_lim=CARD_CPU_MEAN, rank_lim=MIN_RANK_CORR):
    """The card-vs-CPU gate on tile log-odds [images, tiles]: (max |diff|,
    mean |diff|, each image's rank correlation, passes): within both limits
    and every image's tiles ranked alike (a wrong tile order or flip)."""
    import numpy as np

    d = np.abs(lg - lc)
    rank = [float(np.corrcoef(_ranks(lg[i]), _ranks(lc[i]))[0, 1]) for i in range(len(lg))]
    ok = d.max() <= max_lim and d.mean() <= mean_lim and min(rank) >= rank_lim
    return float(d.max()), float(d.mean()), rank, ok


def phase_slice(args, card, model, step, src):
    """The main path, counted, then its checks."""
    import numpy as np
    import torch

    from cellsegmentation_tpu_torch import infer
    from cellsegmentation_tpu_torch.kernels import q8_gemm as tq
    from cellsegmentation_tpu_torch.models import build_model
    from cellsegmentation_tpu_torch.train.steps import make_tile_infer_step

    n_batches = math.ceil(len(src) / args.image_batch)
    warm_flips(step, src, args.image_batch)
    tq.reset_launch_counts()
    probs, secs = _sweep(src, step, args)
    launches = {fn.__name__: fn.launches for fn in tq.KERNELS}
    passes = [secs] + [_sweep(src, step, args)[1] for _ in range(SWEEP_REPEATS)]
    print(f"[slice] launches over {n_batches} image batches: {launches}")
    want = {"q8_matmul": 8, "q8_matmul_px": 20, "q8_conv3_tap": 1,
            "q8_conv3_rowtap": 0}
    for name, per in want.items():
        check(launches[name] == per * n_batches,
              f"{name}: {launches[name]} launches, want {per} x {n_batches}")
    check(probs.shape == (len(src), 225), f"probs shape {probs.shape}")
    check(bool(np.isfinite(probs).all()), "non-finite probs")
    check(bool(((probs >= 0) & (probs <= 1)).all()), "probs outside [0, 1]")
    ips = len(src) / float(np.median(passes))
    print(f"[slice] {len(src)} images x 225 tiles per sweep, "
          f"{len(passes)} sweeps in {[round(s, 4) for s in passes]} s: median "
          f"{ips:.1f} images/s ({ips * 225:.0f} tiles/s) on {card}; "
          f"flip codes {sorted(set(src.flip_code.tolist()))}")
    # without ratio pruning the sampler keeps exactly k tiles per sample
    sel = infer.sample_topk(src, probs, args.tile, args.interval,
                            tiles_per_pos=2, topk_neg=4)
    k = np.where(src.labels > 0, src.labels * 2, 4).clip(0, 225)
    check(len(sel["label"]) == int(k.sum()),
          f"sample_topk kept {len(sel['label'])} tiles, want {int(k.sum())}")
    sel = infer.sample_topk(src, probs, args.tile, args.interval,
                            tiles_per_pos=2, topk_neg=4, pos_neg_ratio=0.5)
    print(f"[slice] sample_topk: {int(k.sum())} tiles selected; after the "
          f"0.5 pos/neg ratio {sel['n_pos']} pos / {sel['n_neg']} neg")

    # a small batch on the card against the same batch through the port on
    # the CPU, same weights and the same calibration scales
    imgs = src.images[:2]
    flip = np.asarray([0, 3], np.int32)
    p_gpu = step(imgs, flip).cpu().numpy()
    cpu_model = quiet_head(build_model("resnet50", device="cpu", seed=args.seed))
    cpu_step = make_tile_infer_step(
        cpu_model, args.tile, _coords(args), engine="q8dg",
        device="cpu", scales=step.engine.scales,
    )
    p_cpu = cpu_step(imgs, flip).numpy()
    lo_g, lo_c = logodds(p_gpu), logodds(p_cpu)
    mx, mean, rank, ok = _gate(lo_g, lo_c)
    # the noise floor: the exact per-tile bf16 graph (no int8 step) between
    # the same two devices, on the same images
    exact_g = make_tile_infer_step(model, args.tile, _coords(args),
                                   engine="flax", device="cuda")
    exact_c = make_tile_infer_step(cpu_model, args.tile, _coords(args),
                                   engine="flax", device="cpu")
    lf_g = logodds(exact_g(imgs, flip).cpu().numpy())
    lf_c = logodds(exact_c(imgs, flip).numpy())
    d_f = np.abs(lf_g - lf_c)
    print(f"[slice] card vs CPU, q8dg log-odds: max {mx:.5f} mean "
          f"{mean:.6f} (limits {CARD_CPU_MAX} / {CARD_CPU_MEAN}), rank "
          f"corr per image {[round(r, 4) for r in rank]}; exact per-tile graph "
          f"card vs CPU: max {d_f.max():.5f} mean {d_f.mean():.6f}; card "
          f"log-odds {lo_g.min():.4f}..{lo_g.max():.4f} (std {lo_g.std():.5f})")
    check(ok, f"card and CPU q8dg differ by max {mx:.5f} mean {mean:.6f}, rank corr "
          f"{min(rank):.3f}")
    # the engine's approximation: q8dg against the exact graph, per device
    e_g, e_c = np.abs(lf_g - lo_g), np.abs(lf_c - lo_c)
    print(f"[slice] q8dg vs the exact per-tile graph, log-odds: card max "
          f"{e_g.max():.5f} mean {e_g.mean():.6f}; CPU max {e_c.max():.5f} "
          f"mean {e_c.mean():.6f} (limits: card mean <= {Q8DG_EXACT_MEAN} and "
          f"<= CPU mean + {CARD_CPU_MEAN})")
    check(e_g.mean() <= Q8DG_EXACT_MEAN and e_g.mean() <= e_c.mean() + CARD_CPU_MEAN,
          f"q8dg sits {e_g.mean():.5f} from the exact graph on the card "
          f"(CPU: {e_c.mean():.5f})")
    ref = {"images": imgs, "flip": flip, "exact_card": lf_g, "exact_cpu": lf_c,
           "cpu_model": cpu_model}
    return launches, probs, ips, float(e_g.mean()), ref


def _sweep(src, step, args):
    return sweep_once(src, step, args.tile, args.interval, args.image_batch)


def phase_rowtap(args, card, step, step_row, src, probs_auto, auto_ips):
    """The row-Toeplitz 3x3 form's sweep, counted, against the auto form's."""
    import numpy as np

    from cellsegmentation_tpu_torch.kernels import q8_gemm as tq

    n_batches = math.ceil(len(src) / args.image_batch)
    warm_flips(step_row, src, args.image_batch)
    tq.reset_launch_counts()
    probs, _ = _sweep(src, step_row, args)
    launches = {fn.__name__: fn.launches for fn in tq.KERNELS}
    print(f"[rowtap] launches over {n_batches} image batches: {launches}")
    want = {"q8_matmul": 0, "q8_matmul_px": 20, "q8_conv3_tap": 0,
            "q8_conv3_rowtap": 9}
    for name, per in want.items():
        check(launches[name] == per * n_batches,
              f"{name}: {launches[name]} launches, want {per} x {n_batches}")
    # the two forms' sweeps in turns (auto, rowtap, rowtap, auto, ...), so
    # the host clock's drift falls on both alike
    passes = {"auto": [], "rowtap": []}
    for i in range(SWEEP_REPEATS):
        order = ("auto", "rowtap") if i % 2 == 0 else ("rowtap", "auto")
        for form in order:
            passes[form].append(
                _sweep(src, step if form == "auto" else step_row, args)[1])
    ips = {f: len(src) / float(np.median(p)) for f, p in passes.items()}
    dp = float(np.abs(probs - probs_auto).max())
    rounded = {f: [round(x, 4) for x in p] for f, p in passes.items()}
    print(f"[rowtap] sweeps in turns, s: {rounded}; median images/s: rowtap "
          f"{ips['rowtap']:.1f}, auto {ips['auto']:.1f} "
          f"({ips['rowtap'] / ips['auto']:.3f}x; the [slice] sweep read "
          f"{auto_ips:.1f}) on {card}; probs vs the auto sweep max |diff| {dp}")
    check(np.array_equal(probs, probs_auto), f"rowtap sweep probs differ by {dp}")
    return launches


def _dense_step(engine, dev):
    """A DenseTileProbs as a sweep step: ``(images u8, flip) -> probs``,
    flip-free batches without selects, as make_tile_infer_step wraps it."""
    import numpy as np
    import torch

    @torch.no_grad()
    def infer(images, flip):
        f = np.asarray(flip)
        imgs = torch.as_tensor(np.asarray(images)).to(dev)
        return engine(imgs, torch.as_tensor(f).to(dev) if f.any() else None)

    return infer


@contextlib.contextmanager
def _planted_split_fault(fault, engines):
    """``"(1, 0) on the folded pair"`` (the hybrid entry's c1 and
    projection with the patches' dequant scale folded in, which it applies
    again: (2, 0)'s conv-land tree) or ``"(1, 1) seam at twice its
    scale"`` (the conv/GEMM seam quantized at 2 x block_out[1][0], which
    GEMM-land dequantizes at the calibrated scale)."""
    import dataclasses

    if fault.startswith("(1, 0)"):
        eng, attr = engines["1,0"], "tree"
        planted = engines["2,0"].tree
    else:
        eng, attr = engines["1,1"], "scales"
        block_out = [list(b) for b in eng.scales.block_out]
        block_out[1][0] *= 2.0
        planted = dataclasses.replace(eng.scales, block_out=block_out)
    orig = getattr(eng, attr)
    setattr(eng, attr, planted)
    try:
        yield
    finally:
        setattr(eng, attr, orig)


def phase_variants(args, card, model, step, src, ref):
    """q8dg's conv/GEMM splits on the [slice] model, source and
    calibration: (2, 0), (1, 1) and (1, 0). Each sweep counted, timed in
    turns, with its peak memory, against the CPU, (2, 0) and the exact
    graph; every kernel call of one (1, 0) and one (1, 1) step against its
    plain version, timed; two planted faults."""
    import numpy as np
    import torch

    from cellsegmentation_tpu_torch.kernels import q8_gemm as tq
    from cellsegmentation_tpu_torch.ops.infer_engine import make_dense_tile_probs

    t_phase = time.perf_counter()
    n_batches = math.ceil(len(src) / args.image_batch)
    scales = step.engine.scales

    def build(mdl, kw):
        return make_dense_tile_probs(mdl, args.tile, args.interval, args.hw, None,
                                     scales=scales, **kw)

    engines = {name: build(model, kw) for name, (kw, _) in VARIANTS.items()}
    check(engines["1,0"].hybrid, "the hybrid entry did not engage")
    steps = {name: _dense_step(e, "cuda") for name, e in engines.items()}
    launches, peak, probs = {}, {}, {}
    for name, (_, want) in VARIANTS.items():
        warm_flips(steps[name], src, args.image_batch)
        tq.reset_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        probs[name], _ = _sweep(src, steps[name], args)
        peak[name] = torch.cuda.max_memory_allocated()
        launches[name] = {fn.__name__: fn.launches for fn in tq.KERNELS}
        got = tuple(launches[name][k] for k in ("q8_conv3_tap", "q8_matmul", "q8_matmul_px"))
        check(got == tuple(n_batches * w for w in want) and not launches[name]["q8_conv3_rowtap"],
              f"{name}: launches {launches[name]}, want {want} x {n_batches}")
        check(probs[name].shape == (len(src), 225) and bool(np.isfinite(probs[name]).all()),
              f"{name} probs {probs[name].shape}")
    passes = {name: [] for name in VARIANTS}
    for i in range(SWEEP_REPEATS):
        for name in (list(passes) if i % 2 == 0 else list(reversed(passes))):
            passes[name].append(_sweep(src, steps[name], args)[1])
    ips = {k: len(src) / float(np.median(v)) for k, v in passes.items()}
    for name in VARIANTS:
        print(f"[variants] q8dg {name}: {ips[name]:.1f} images/s (median of "
              f"{[round(x, 4) for x in passes[name]]} s), peak memory "
              f"{peak[name] / 2**30:.2f} GiB, launches over {n_batches} image batches "
              f"{launches[name]}")
    print(f"[variants] sweeps at 299/32/20, image batch {args.image_batch}, in turns on "
          f"{card}; fastest: {max(ips, key=ips.get)}")

    # each split against the port on the CPU (q8dg's limits) and, in the
    # split gates, against (2, 0) on the card and the exact graph; then the
    # planted faults, which the split gates alone must reject
    imgs, flip = ref["images"], ref["flip"]
    cpu_lo = {name: logodds(_dense_step(build(ref["cpu_model"], kw), "cpu")(imgs, flip)
                             .numpy()) for name, (kw, _) in VARIANTS.items()}
    base_lo = logodds(steps["2,0"](imgs, flip).cpu().numpy())

    def gates(name, lg):
        mx, mean, rank, ok_cpu = _gate(lg, cpu_lo[name])
        e_g, e_c = np.abs(ref["exact_card"] - lg), np.abs(ref["exact_cpu"] - cpu_lo[name])
        ok_cpu = (ok_cpu and e_g.mean() <= Q8DG_EXACT_MEAN
                  and e_g.mean() <= e_c.mean() + CARD_CPU_MEAN)
        b_mx, b_mean, b_rank, ok_split = _gate(lg, base_lo, SPLIT_VS_20_MAX,
                                               SPLIT_VS_20_MEAN, SPLIT_VS_20_RANK)
        ok_split = ok_split and e_g.mean() <= SPLIT_EXACT_MEAN
        text = (f"card vs CPU max {mx:.5f} mean {mean:.6f} rank {min(rank):.4f}; vs exact "
                f"card mean {e_g.mean():.6f} (CPU {e_c.mean():.6f}); vs (2,0) max "
                f"{b_mx:.5f} mean {b_mean:.6f} rank {min(b_rank):.4f}")
        return ok_cpu, ok_split, text

    limits = (f"limits vs CPU {CARD_CPU_MAX} / {CARD_CPU_MEAN} / {MIN_RANK_CORR}, exact "
              f"mean <= {Q8DG_EXACT_MEAN} and <= CPU + {CARD_CPU_MEAN}; split gates vs "
              f"(2,0) {SPLIT_VS_20_MAX} / {SPLIT_VS_20_MEAN} / {SPLIT_VS_20_RANK}, exact "
              f"mean <= {SPLIT_EXACT_MEAN}")
    for name in VARIANTS:
        ok_cpu, ok_split, text = gates(name, logodds(steps[name](imgs, flip).cpu().numpy()))
        print(f"[variants] q8dg {name} log-odds: {text} ({limits})")
        check(ok_cpu and ok_split, f"q8dg {name} fails its gates: {text}")
    for fault, name in (("(1, 0) on the folded pair", "1,0"),
                        ("(1, 1) seam at twice its scale", "1,1")):
        with _planted_split_fault(fault, engines):
            ok_cpu, ok_split, text = gates(name, logodds(steps[name](imgs, flip)
                                                          .cpu().numpy()))
        print(f"[variants] planted fault ({fault}): {text}: vs CPU "
              f"{'passes' if ok_cpu else 'rejected'}, split gates "
              f"{'pass' if ok_split else 'reject'}")
        check(not ok_split, f"the split gates pass a planted fault: {fault}")

    # every kernel call of one (1, 0) and one (1, 1) step: each against its
    # plain version, each distinct call timed once, weighted by its count
    batch = torch.as_tensor(src.images[: args.image_batch]).cuda()
    stats = {}
    for name in ("1,0", "1,1"):
        calls = capture_calls(lambda: engines[name](batch, None))
        want = VARIANTS[name][1]
        got = tuple(sum(c[0] is fn for c in calls)
                    for fn in (tq.q8_conv3_tap, tq.q8_matmul, tq.q8_matmul_px))
        check(got == want, f"{name} step calls {got}, want {want}")
        for fn, a, kw in calls:
            check(torch.equal(fn(*a, **kw), tq.PLAIN[fn](*a, **kw)),
                  f"{name}: {fn.__name__} differs from its plain version")
        distinct, counts, _ = _distinct_calls(calls)
        stats[name], _ = measure_calls(distinct, f"variants {name}", repeat=counts)
        print_stats(stats[name], f"variants {name}")
    print(f"[variants] phase {time.perf_counter() - t_phase:.1f} s")
    return stats, launches


def _alt_batch(train, pick, rng):
    """The stage-1 batch of ``pick`` and ALT_TILES tiles of those images
    (indices into the batch's own images), every flip code, both labels."""
    import numpy as np

    b = batch_of(train, pick)
    hw = b["images"].shape[1]
    b.update(img_idx=rng.integers(0, len(pick), ALT_TILES).astype(np.int32),
             xs=rng.integers(0, hw - 32 + 1, ALT_TILES).astype(np.int32),
             ys=rng.integers(0, hw - 32 + 1, ALT_TILES).astype(np.int32),
             tflip=(np.arange(ALT_TILES) % 4).astype(np.int32),
             tlabel=(np.arange(ALT_TILES) % 2).astype(np.int32),
             tvalid=np.ones(ALT_TILES, bool))
    return b


def alt_step_reading(model, batch, masks, dev, fault=False):
    """One make_alternative_train_step update (SGD at S1_CHECK_LR on both
    partitions) under the injected dropout ``masks``: (image loss, running
    statistics, fc_tile's update, the other parameters' update), f64 CPU.
    ``fault`` plants the image half reading the parameters as they were
    before the tile update."""
    import torch

    from cellsegmentation_tpu_torch.train import steps
    from cellsegmentation_tpu_torch.train.schedules import make_schedule
    from cellsegmentation_tpu_torch.train.state import create_train_state

    sched = make_schedule(None, S1_CHECK_LR, 1, 1)
    tile_state = create_train_state(model, "tile", sched, use_sgd=True, device=dev)
    image_state = create_train_state(model, "image", sched, use_sgd=True, device=dev)
    snapshot = copy.deepcopy(model.state_dict())
    orig = steps.make_image_train_step
    if fault:
        def stale(mdl, **kw):
            inner = orig(mdl, **kw)

            def image_step(state, b, dropout_masks=None, sd_masks=None):
                mdl.load_state_dict(snapshot)
                return inner(state, b, dropout_masks, sd_masks)
            return image_step

        steps.make_image_train_step = stale
    try:
        step = steps.make_alternative_train_step(model, 32, device=dev)
    finally:
        steps.make_image_train_step = orig
    masks = {k: tuple(m.to(dev) for m in v) for k, v in masks.items()}
    images_dev = torch.as_tensor(batch["images"]).to(dev)
    _, _, metrics = step(tile_state, image_state, images_dev, batch, dropout_masks=masks)
    after = model.state_dict()
    stats = {k: v.double().cpu() for k, v in after.items() if "running_" in k}

    def update(keep):
        return torch.cat([(after[k].double() - snapshot[k].double()).cpu().flatten()
                          for k, p in model.named_parameters() if keep(k)])

    return (float(metrics["loss"]), stats, update(lambda k: k.startswith("fc_tile")),
            update(lambda k: k.split(".")[0] in ("encoder", "fc_image_cls", "fc_image_reg")))


def alt_step_gap(got, want):
    """(loss rel, statistics gap, fc_tile update gap, the rest's update gap,
    within the S1_* limits) of an alt_step_reading against the reference."""
    (lg, sg, tg, ug), (lc, sc, tc, uc) = got, want
    rel = abs(lg - lc) / abs(lc)
    stat = max(float((sg[k] - sc[k]).abs().max()) / stat_scale(sc, k) for k in sc)
    tile = float((tg - tc).abs().max() / tc.abs().max())
    rest = float((ug - uc).abs().max() / uc.abs().max())
    ok = (rel <= S1_LOSS_RTOL and stat <= S1_STAT_RTOL and tile <= S1_WEIGHT_RTOL
          and rest <= S1_WEIGHT_RTOL)
    return rel, stat, tile, rest, ok


def phase_alternative(args, card):
    """make_alternative_train_step on ResNet-50: ALT_STEPS steps on the
    card, then one f32 step card vs CPU and its planted fault."""
    import numpy as np
    import torch

    from cellsegmentation_tpu_torch.core.dtypes import F32_POLICY
    from cellsegmentation_tpu_torch.models import build_model
    from cellsegmentation_tpu_torch.train.schedules import make_schedule
    from cellsegmentation_tpu_torch.train.state import create_train_state
    from cellsegmentation_tpu_torch.train.steps import make_alternative_train_step

    t_phase = time.perf_counter()
    train, _ = _stage1_sources(args)
    pick = np.asarray([0, 58, 116, 174, 1, 59, 117, 175])[:S1_CHECK_IMAGES]
    batch = _alt_batch(train, pick, np.random.default_rng(args.seed))
    model = build_model("resnet50", device="cuda", seed=args.seed)
    sched = make_schedule(None, STAGE1_LR, 1, 1)
    tile_state = create_train_state(model, "tile", sched, device="cuda")
    image_state = create_train_state(model, "image", sched, device="cuda")
    step = make_alternative_train_step(model, 32, seed=args.seed, device="cuda")
    images_dev = torch.as_tensor(batch["images"]).cuda()
    fc0 = model.fc_tile[1].weight.detach().clone()
    enc0 = model.encoder.conv1.weight.detach().clone()
    secs, losses = [], []
    for _ in range(ALT_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tile_state, image_state, m = step(tile_state, image_state, images_dev, batch)
        losses.append(float(m["loss"]))
        secs.append(time.perf_counter() - t0)
    check(all(math.isfinite(x) for x in losses), f"alternative step losses {losses}")
    check(tile_state.step == image_state.step == ALT_STEPS, "alternative step counts")
    check(not torch.equal(model.fc_tile[1].weight, fc0)
          and not torch.equal(model.encoder.conv1.weight, enc0),
          "the alternation left fc_tile or the encoder unchanged")
    print(f"[alternative] {ALT_STEPS} steps (Adam, {len(pick)} images + {ALT_TILES} tiles) "
          f"on {card}: losses {[round(x, 4) for x in losses]}, "
          f"{[round(s, 4) for s in secs]} s")

    cpu_model = build_model("resnet50", policy=F32_POLICY, device="cpu", seed=args.seed)
    gen = torch.Generator().manual_seed(args.seed)
    masks = {k: getattr(cpu_model, k).draw_masks(len(pick), gen)
             for k in ("fc_image_cls", "fc_image_reg")}
    t0 = time.perf_counter()
    cpu = alt_step_reading(cpu_model, batch, masks, "cpu")
    cpu_s = time.perf_counter() - t0
    readings = {}
    for fault in (False, True):
        m = build_model("resnet50", policy=F32_POLICY, device="cuda", seed=args.seed)
        readings[fault] = alt_step_gap(alt_step_reading(m, batch, masks, "cuda", fault), cpu)
    rel, stat, tile, rest, ok = readings[False]
    limits = (f"limits rel {S1_LOSS_RTOL}, stat {S1_STAT_RTOL}, updates {S1_WEIGHT_RTOL}")
    print(f"[alternative] one f32 step card vs CPU ({cpu_s:.1f} s on the CPU): image loss "
          f"{cpu[0]:.6f}, rel {rel:.2e}; statistics {stat:.2e}; fc_tile update gap "
          f"{tile:.2e}; encoder and image heads update gap {rest:.2e} ({limits})")
    rel, stat, tile, rest, bad_ok = readings[True]
    print(f"[alternative] planted fault (the image half reads the parameters from before "
          f"the tile update): rel {rel:.2e}, statistics {stat:.2e}, fc_tile {tile:.2e}, "
          f"rest {rest:.2e}: {'passes' if bad_ok else 'rejected'}")
    check(ok, "the alternative step card vs CPU is outside the limits")
    check(not bad_ok, "the alternative-step gate passes its planted fault")
    print(f"[alternative] phase {time.perf_counter() - t_phase:.1f} s")


def _train_step_on(model, src, batch, dev):
    """(loss, fc_tile weight gradient) of one tile train step's loss."""
    import torch

    from cellsegmentation_tpu_torch.train.steps import make_tile_train_step

    images = torch.as_tensor(src.images).to(dev)
    step = make_tile_train_step(model, 32, device=dev)
    model.set_trainable(("fc_tile",))
    model.zero_grad(set_to_none=True)
    loss = step.loss_fn(images, batch)
    loss.backward()
    grad = model.fc_tile[1].weight.grad.detach().double().cpu().flatten()
    return float(loss.detach()), grad


def _train_gap(got, want):
    """(loss rel, gradient cosine, gradient max gap / max magnitude) of a
    (loss, grad) reading against the reference one."""
    (loss_g, grad_g), (loss_c, grad_c) = got, want
    rel = abs(loss_g - loss_c) / abs(loss_c)
    cos = float(grad_g @ grad_c / (grad_g.norm() * grad_c.norm()))
    gap = float((grad_g - grad_c).abs().max() / grad_c.abs().max())
    ok = (rel <= TRAIN_LOSS_RTOL and cos >= TRAIN_GRAD_MIN_COS
          and gap <= TRAIN_GRAD_MAX_GAP)
    return rel, cos, gap, ok


def _train_rate(model, src, sel, args):
    """Host seconds of TRAIN_RATE_STEPS train steps (after one untimed) at
    the CLI's tile batch, the epoch's selection repeated to fill it; each
    step as train_stage2 runs it (host batch in, optimizer update), ended by
    reading its loss."""
    import numpy as np
    import torch

    from cellsegmentation_tpu_torch.train.schedules import make_schedule
    from cellsegmentation_tpu_torch.train.state import create_train_state
    from cellsegmentation_tpu_torch.train.steps import make_tile_train_step

    images = torch.as_tensor(src.images).cuda()
    idx = np.resize(np.arange(len(sel["label"])), TILE_BATCH)
    batch = {k: sel[k][idx] for k in ("img_idx", "xs", "ys", "flip", "label")}
    batch["valid"] = np.ones(TILE_BATCH, bool)
    state = create_train_state(model, "tile", make_schedule(None, 5e-5, 1, 1),
                               device="cuda")
    step = make_tile_train_step(model, args.tile, device="cuda")
    secs = []
    for _ in range(TRAIN_RATE_STEPS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, images, batch)
        check(math.isfinite(float(metrics["loss"])), "non-finite train loss")
        secs.append(time.perf_counter() - t0)
    return secs[1:]


def phase_train(args, card, base, src):
    """train_stage2 on the full-width model, once per 3x3 form, counted;
    then one train step on the card against the CPU."""
    import numpy as np
    import torch

    from cellsegmentation_tpu_torch.data import LystoDataSource, make_synthetic_arrays
    from cellsegmentation_tpu_torch.kernels import q8_gemm as tq
    from cellsegmentation_tpu_torch.models import build_model
    from cellsegmentation_tpu_torch.train.trainers import train_stage2
    from cellsegmentation_tpu_torch.utils.logging import RunLogger

    arrays = make_synthetic_arrays(args.val_images, args.hw, 30, seed=args.seed + 1)
    val = LystoDataSource.from_arrays(arrays["images"], arrays["organs"],
                                      arrays["counts"], train=False, kfold=None)
    n_batches = args.epochs * (math.ceil(len(src) / args.image_batch)
                               + math.ceil(len(val) / args.image_batch))
    want = {"auto": {"q8_matmul": 8, "q8_matmul_px": 20, "q8_conv3_tap": 1,
                     "q8_conv3_rowtap": 0},
            "rowtap": {"q8_matmul": 0, "q8_matmul_px": 20, "q8_conv3_tap": 0,
                       "q8_conv3_rowtap": 9}}
    runs = {}
    with tempfile.TemporaryDirectory() as logdir:
        for impl in ("auto", "rowtap"):
            model = copy.deepcopy(base)
            tq.reset_launch_counts()
            t0 = time.perf_counter()
            res = train_stage2(
                model, src, val, epochs=args.epochs, tile_batch_size=40960,
                image_batch=args.image_batch, tile_size=args.tile,
                interval=args.interval, tiles_per_pos=1, topk_neg=30,
                pos_neg_ratio=0.5, lr=5e-5, seed=args.seed,
                logger=RunLogger(logdir, run_name=impl, tensorboard=False),
                infer_engine="auto", record_selection=True, w2_impl=impl,
                device="cuda",
            )
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {fn.__name__: fn.launches for fn in tq.KERNELS}
            print(f"[train] w2_impl={impl}: {args.epochs} epochs in {wall:.1f} s "
                  f"(engine build included); launches over {n_batches} image "
                  f"batches: {launches}")
            for name, per in want[impl].items():
                check(launches[name] == per * n_batches,
                      f"{impl}: {name} {launches[name]} launches, want {per} x "
                      f"{n_batches}")
            for e, st in enumerate(res.epoch_stats, 1):
                check(math.isfinite(st["loss"]), f"{impl}: epoch {e} loss {st['loss']}")
                print(f"[train] w2_impl={impl} epoch {e}: sweep {st['sweep']:.4f} s, "
                      f"selection {st['select']:.4f} s, train steps "
                      f"{st['train']:.4f} s ({st['train_tiles']} tiles, "
                      f"{st['train_tiles'] / st['train']:.0f} tiles/s), validation "
                      f"{st['val']:.4f} s; loss {st['loss']:.6f}; on {card}")
            print(f"[train] w2_impl={impl}: validation (err, fpr, fnr) "
                  f"{res.last_metrics}")
            runs[impl] = (model, res)
    (m_a, r_a), (m_r, r_r) = runs["auto"], runs["rowtap"]
    for e, (sa, sr) in enumerate(zip(r_a.selections, r_r.selections), 1):
        same = all(np.array_equal(sa[k], sr[k]) for k in sa)
        print(f"[train] epoch {e}: {len(sa['label'])} tiles selected "
              f"({int(sa['label'].sum())} pos); auto and rowtap selections "
              f"identical: {same}")
        check(same, f"epoch {e}: the two forms selected different tiles")
    w_a, w_r = m_a.fc_tile[1].weight, m_r.fc_tile[1].weight
    check(torch.equal(w_a, w_r) and torch.equal(m_a.fc_tile[1].bias, m_r.fc_tile[1].bias),
          f"fc_tile differs between the forms by {float((w_a - w_r).detach().abs().max())}")
    check(not torch.equal(w_a, base.fc_tile[1].weight), "fc_tile did not train")
    print("[train] final fc_tile identical between the forms: True")

    secs = _train_rate(copy.deepcopy(m_a), src, r_a.selections[-1], args)
    med = float(np.median(secs))
    print(f"[train] train step at the CLI's {TILE_BATCH}-tile batch (the "
          f"epoch-2 selection repeated), {len(secs)} steps in "
          f"{[round(x, 4) for x in secs]} s: median {med:.4f} s, "
          f"{TILE_BATCH / med:.0f} tiles/s on {card}")

    # one train step on the card against the CPU, from the initial weights,
    # on the selected tiles with the most content: most tiles are flat
    # background and noise, which a flip or a transposed gather leaves
    # statistically alike
    sel = r_a.selections[0]
    t = args.tile
    std = np.asarray([src.images[i, x:x + t, y:y + t].std() for i, x, y in
                      zip(sel["img_idx"], sel["xs"], sel["ys"])])
    pick = np.sort(np.argsort(-std, kind="stable")[:TRAIN_CHECK_TILES])
    n = len(pick)
    batch = {k: sel[k][pick] for k in ("img_idx", "xs", "ys", "flip", "label")}
    batch["valid"] = np.ones(n, bool)
    card_step = _train_step_on(copy.deepcopy(base), src, batch, "cuda")
    cpu_model = quiet_head(build_model("resnet50", device="cpu", seed=args.seed))
    cpu_step = _train_step_on(cpu_model, src, batch, "cpu")
    rel, cos, gap, ok = _train_gap(card_step, cpu_step)
    limits = (f"limits rel {TRAIN_LOSS_RTOL}, cos {TRAIN_GRAD_MIN_COS}, gap "
              f"{TRAIN_GRAD_MAX_GAP}")
    print(f"[train] one step of {n} tiles ({int(batch['label'].sum())} pos; "
          f"pixel std {std[pick].min():.1f}..{std[pick].max():.1f}, all "
          f"selected tiles from {std.min():.1f}), card vs CPU: loss {card_step[0]:.6f} "
          f"vs {cpu_step[0]:.6f} (rel {rel:.2e}); fc_tile gradient cosine "
          f"{cos:.7f}, max gap / max |grad| {gap:.2e} ({limits})")
    check(ok, "train step card vs CPU outside the limits")
    # the gate must reject a wrong step: planted faults on the card
    planted = {"every tile's flip wrong": dict(batch, flip=batch["flip"] ^ 1),
               "x and y swapped in the gather": dict(batch, xs=batch["ys"],
                                                     ys=batch["xs"])}
    for fault, bad in planted.items():
        rel, cos, gap, ok = _train_gap(
            _train_step_on(copy.deepcopy(base), src, bad, "cuda"), cpu_step)
        print(f"[train] planted fault ({fault}) vs CPU: loss rel {rel:.2e}, "
              f"gradient cosine {cos:.7f}, gap {gap:.2e}: "
              f"{'passes' if ok else 'rejected'}")
        check(not ok, f"the train-step gate passes a planted fault: {fault}")


def stage1_gap(got, want):
    """(loss rel, gradient cosine, statistic gap, update gap, within the
    S1_* limits) of a stage1_step_reading against the reference one."""
    r = step_gap(got, want)
    ok = within(r, {"loss_rel": S1_LOSS_RTOL, "grad_cos": S1_GRAD_MIN_COS,
                    "stat": S1_STAT_RTOL, "update": S1_WEIGHT_RTOL})
    return r["loss_rel"], r["grad_cos"], r["stat"], r["update"], ok


def _stage1_sources(args):
    from cellsegmentation_tpu_torch.data import LystoDataSource, make_synthetic_arrays

    a = make_synthetic_arrays(args.images, args.hw, 30, seed=args.seed + 2)
    train = LystoDataSource.from_arrays(a["images"], a["organs"], a["counts"],
                                        kfold=10, augment=True, seed=args.seed)
    val = LystoDataSource.from_arrays(a["images"], a["organs"], a["counts"],
                                      train=False, kfold=10)
    return train, val


def _stage1_rate(model, train, args, card, tag):
    """The image train step at STAGE1_BATCH on a copy of ``model``: median
    seconds of TRAIN_RATE_STEPS steps after 2 warm-up, images/s, peak
    memory, MFU. Returns the images/s."""
    import numpy as np
    import torch

    from cellsegmentation_tpu_torch.train.schedules import make_schedule
    from cellsegmentation_tpu_torch.train.state import create_train_state
    from cellsegmentation_tpu_torch.train.steps import make_image_train_step

    rate_model = copy.deepcopy(model)
    state = create_train_state(rate_model, "image", make_schedule(None, STAGE1_LR, 1, 1),
                               device="cuda")
    step = make_image_train_step(rate_model, seed=args.seed, device="cuda")
    batch = batch_of(train, np.arange(STAGE1_BATCH))
    flops = step_flops(rate_model, batch)
    for _ in range(2):
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    secs = []
    for _ in range(TRAIN_RATE_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        check(math.isfinite(float(metrics["loss"])), f"non-finite {tag} loss")
        secs.append(time.perf_counter() - t0)
    med = float(np.median(secs))
    peak = torch.cuda.max_memory_allocated()
    print(f"[{tag}] train step at batch {STAGE1_BATCH}, {len(secs)} steps after 2 warm-up "
          f"in {[round(x, 4) for x in secs]} s: median {med:.4f} s, "
          f"{STAGE1_BATCH / med:.1f} images/s; peak memory {peak / 2**30:.2f} GiB; "
          f"{flops / 1e12:.3f} TFLOP a step (3 x the forward's conv and Dense FLOPs): "
          f"MFU {100 * flops / med / BF16_PEAK_FLOPS:.2f}% of {BF16_PEAK_FLOPS / 1e12:.0f} "
          f"TFLOP/s bf16, on {card}")
    return STAGE1_BATCH / med


def _stage1_gate(args, train, name, tag, faults=None):
    """One f32 image train step of a fresh ``name`` model, card against
    CPU, and the planted faults this gate must reject: ``faults`` (names of
    ``planted_stage1_fault``'s) or the ResNet set. An EfficientNet's
    stochastic-depth masks are injected too, each dropping one row."""
    import numpy as np
    import torch

    from cellsegmentation_tpu_torch.core.dtypes import F32_POLICY
    from cellsegmentation_tpu_torch.models import build_model

    pick = np.asarray([0, 58, 116, 174, 1, 59, 117, 175])[:S1_CHECK_IMAGES]
    check(sorted(set(train.flip_code[pick].tolist())) == [0, 1, 2, 3], "check flips")
    batch = batch_of(train, pick)
    cpu_model = build_model(name, policy=F32_POLICY, device="cpu", seed=args.seed)
    gen = torch.Generator().manual_seed(args.seed)
    masks = {k: getattr(cpu_model, k).draw_masks(len(pick), gen)
             for k in ("fc_image_cls", "fc_image_reg")}
    sd = None
    if hasattr(cpu_model.encoder, "sd_blocks"):
        rows = torch.arange(len(pick))
        sd = [rows != j % len(pick) for j in range(len(cpu_model.encoder.sd_blocks))]
    t0 = time.perf_counter()
    cpu = stage1_step_reading(cpu_model, batch, masks, "cpu", sd)
    cpu_s = time.perf_counter() - t0

    def card_reading(b=batch, fault=None):
        m = build_model(name, policy=F32_POLICY, device="cuda", seed=args.seed)
        if fault is None:
            return stage1_step_reading(m, b, masks, "cuda", sd)
        with planted_stage1_fault(fault, m):
            return stage1_step_reading(m, b, masks, "cuda", sd)

    limits = (f"limits rel {S1_LOSS_RTOL}, cos {S1_GRAD_MIN_COS}, stat {S1_STAT_RTOL}, "
              f"update {S1_WEIGHT_RTOL}")
    # every reading first, then the verdicts, so one run shows them all
    if faults is None:
        planted = {"unbiased running variance": (batch, "unbiased running variance"),
                   "dropout scaled by keep": (batch, "dropout scaled by keep"),
                   "flipped images fed unflipped": (
                       dict(batch, flip=np.zeros_like(batch["flip"])), None)}
    else:
        planted = {f: (batch, f) for f in faults}
    gaps = {None: stage1_gap(card_reading(), cpu)}
    gaps.update({fault: stage1_gap(card_reading(b, planted_as), cpu)
                 for fault, (b, planted_as) in planted.items()})
    rel, cos, stat, weight, ok = gaps[None]
    print(f"[{tag}] one f32 step of {name} on {len(pick)} images (flips "
          f"{train.flip_code[pick].tolist()}), card vs CPU ({cpu_s:.1f} s on the CPU): "
          f"loss {cpu[0]:.6f}, rel {rel:.2e}; gradient cosine {cos:.9f}; running "
          f"statistics gap {stat:.2e}; updated weights' gap over the largest update "
          f"{weight:.2e} ({limits})")
    for fault in planted:
        rel, cos, stat, weight, bad_ok = gaps[fault]
        print(f"[{tag}] planted fault ({fault}) vs CPU: loss rel {rel:.2e}, cosine "
              f"{cos:.9f}, statistics {stat:.2e}, update {weight:.2e}: "
              f"{'passes' if bad_ok else 'rejected'}")
    check(ok, f"{name}: stage-1 step card vs CPU outside the limits")
    for fault in planted:
        check(not gaps[fault][-1], f"the stage-1 gate passes a planted fault: {fault}")

def phase_stage1(args, card, src, slice_gap):
    """Stage 1 on the card: train_stage1, the step's rate, inference_image,
    the card-vs-CPU step gate with its planted faults, the pt1 handoff."""
    import numpy as np
    import torch

    from cellsegmentation_tpu_torch import infer
    from cellsegmentation_tpu_torch.kernels import q8_gemm as tq
    from cellsegmentation_tpu_torch.models import build_model
    from cellsegmentation_tpu_torch.ops.infer_engine import pick_calib_images
    from cellsegmentation_tpu_torch.train import checkpoint as ckpt_mod
    from cellsegmentation_tpu_torch.train.schedules import make_schedule
    from cellsegmentation_tpu_torch.train.state import create_train_state
    from cellsegmentation_tpu_torch.train.steps import (
        make_image_infer_step,
        make_image_train_step,
        make_tile_infer_step,
    )
    from cellsegmentation_tpu_torch.train.trainers import train_stage1
    from cellsegmentation_tpu_torch.utils.logging import RunLogger

    train, val = _stage1_sources(args)
    n_steps = math.ceil(len(train) / STAGE1_BATCH)
    check(len(train) == 232 and len(val) == 6, f"sources {len(train)} / {len(val)}")
    model = build_model("resnet50", device="cuda", seed=args.seed)
    with tempfile.TemporaryDirectory() as out:
        # 1) train_stage1, counted: stage 1 reaches no hand-written kernel
        tq.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = train_stage1(model, train, val, epochs=STAGE1_EPOCHS,
                           batch_size=STAGE1_BATCH, lr=STAGE1_LR, seed=args.seed,
                           output_dir=out, device="cuda",
                           logger=RunLogger(out, run_name="stage1", tensorboard=False))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in tq.KERNELS}
        check(not any(launches.values()), f"stage 1 launched {launches}")
        print(f"[stage1] train_stage1: {STAGE1_EPOCHS} epochs of {n_steps} steps "
              f"(batch {STAGE1_BATCH}, {len(train)} samples; the last batch "
              f"{len(train) - (n_steps - 1) * STAGE1_BATCH} valid rows) in {wall:.1f} s "
              f"on {card}; hand-written kernel launches {launches}")
        for e, st in enumerate(res.epoch_stats, 1):
            check(all(math.isfinite(st[k]) for k in ("loss_cls", "loss_reg", "loss")),
                  f"epoch {e} losses {st}")
            check(st["steps"] == n_steps, f"epoch {e}: {st['steps']} steps")
            print(f"[stage1] epoch {e}: loss_cls {st['loss_cls']:.6f} loss_reg "
                  f"{st['loss_reg']:.6f} loss {st['loss']:.6f}; train {st['train']:.4f} s "
                  f"({st['steps'] * STAGE1_BATCH / st['train']:.1f} images/s), "
                  f"validation {st['val']:.4f} s")
        check(res.last_metrics is not None and all(math.isfinite(m) for m in res.last_metrics),
              f"validation {res.last_metrics}")
        print(f"[stage1] validation (mAP, MSE, QWK) {res.last_metrics}")
        ckpt_path = f"{out}/pt1_{STAGE1_EPOCHS}epochs.ckpt"
        ck = ckpt_mod.load_checkpoint(ckpt_path)
        check(ck["mode"] == "image" and ck["epoch"] == STAGE1_EPOCHS,
              f"checkpoint {ck['mode']} epoch {ck['epoch']}")
        print(f"[stage1] wrote {ckpt_path.rsplit('/', 1)[-1]} ({len(ck['state_dict'])} "
              f"entries, step {ck['step']})")

    # 2) the train step's rate at batch 48, on a copy of the trained model
    _stage1_rate(model, train, args, card, "stage1")

    # 3) inference_image over the [setup] source's 256 samples at batch 128
    infer_fn = make_image_infer_step(model, device="cuda")
    infer.inference_image(src, infer_fn, batch_size=128, cls_limit=True)
    torch.cuda.synchronize()
    secs = []
    for _ in range(3):
        t0 = time.perf_counter()
        cats, counts = infer.inference_image(src, infer_fn, batch_size=128, cls_limit=True)
        secs.append(time.perf_counter() - t0)
    check(cats.shape == counts.shape == (len(src),), f"inference_image {cats.shape}")
    check(bool(((cats >= 0) & (cats < 7)).all() and (counts >= 0).all()), "bad counts")
    ips = len(src) / float(np.median(secs))
    print(f"[stage1] inference_image, {len(src)} samples at batch 128, cls_limit: "
          f"{[round(x, 4) for x in secs]} s, median {ips:.1f} images/s on {card}; "
          f"counts {int(counts.min())}..{int(counts.max())}, classes {sorted(set(cats.tolist()))}")

    # 4) one f32 train step, card against CPU, and the planted faults
    _stage1_gate(args, train, "resnet50", "stage1")

    # 5) the pt1 handoff: a fresh model from the file, then a q8dg batch
    fresh = build_model("resnet50", device="cuda", seed=args.seed)
    check(not torch.equal(fresh.encoder.conv1.weight, model.encoder.conv1.weight),
          "stage 1 did not move the encoder")
    ckpt_mod.restore_into(fresh, ck, ckpt_mod.STAGE_SAVE_PARTITIONS["image"])
    sd_t, sd_f = model.state_dict(), fresh.state_dict()
    check(sd_t.keys() == sd_f.keys() and all(torch.equal(sd_t[k], sd_f[k]) for k in sd_t),
          "the loaded pt1 model's state differs from the trained one")
    got = infer.inference_image(src, make_image_infer_step(fresh, device="cuda"),
                                batch_size=128, cls_limit=True)
    check(np.array_equal(got[0], cats) and np.array_equal(got[1], counts),
          "inference_image differs between the trained and the loaded model")
    quiet_head(fresh)
    images = src.images[: args.image_batch]
    sweep = make_tile_infer_step(fresh, args.tile, _coords(args), engine="auto",
                                 calib_images=pick_calib_images(train.images), device="cuda")
    exact = make_tile_infer_step(fresh, args.tile, _coords(args), engine="flax",
                                 device="cuda")
    check(sweep.resolved_engine == "q8dg", f"handoff engine {sweep.resolved_engine}")
    flip = np.zeros(len(images), np.int32)
    tq.reset_launch_counts()
    p_q = sweep(images, flip).cpu().numpy()
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in tq.KERNELS}
    check(launches == {"q8_matmul": 8, "q8_matmul_px": 20, "q8_conv3_tap": 1,
                       "q8_conv3_rowtap": 0}, f"handoff sweep launches {launches}")
    e = np.abs(logodds(p_q) - logodds(exact(images, flip).cpu().numpy()))
    check(bool(np.isfinite(p_q).all()), "non-finite handoff probs")
    print(f"[stage1] pt1 into a fresh model: state equal, inference_image bit-equal; "
          f"q8dg sweep of {len(images)} images on the stage-1 encoder (head x "
          f"{HEAD_SCALE}), launches {launches}; q8dg vs the exact per-tile graph, "
          f"log-odds: max {e.max():.5f} mean {e.mean():.6f} (random-init weights in "
          f"[slice]: mean {slice_gap:.6f})")

    # 6) the profile of one stage-1 train step
    prof_model = copy.deepcopy(model)
    state = create_train_state(prof_model, "image", make_schedule(None, STAGE1_LR, 1, 1),
                               device="cuda")
    step = make_image_train_step(prof_model, seed=args.seed, device="cuda")
    batch = batch_of(train, np.arange(STAGE1_BATCH))
    state, _ = step(state, batch)
    torch.cuda.synchronize()
    profile_rows("stage1", f"one train step of {STAGE1_BATCH} images",
                  lambda: step(state, batch), top=12)
    return model, res.state, train


# [jaxckpt]: the [stage1] model and Adam state written as the JAX package's
# pt1 and pt2 (flax msgpack, by the port's writer: the card's machine has no
# JAX), read back through the CLIs' load_stage_checkpoint; the pt2 swept on
# the [slice] source's first JAXCKPT_SAMPLES samples, the pt1 resumed for one
# stage-1 step beside the port's own pt1 of the same state. Tolerance 0: the
# layouts move bits only, so the loaded state, the sweep's probs and the
# resumed step must be bit-equal.
JAXCKPT_SAMPLES = 64


def _cli_args():
    """The CLIs' arguments load_stage_checkpoint reads: card 0, bf16."""
    return argparse.Namespace(device=0, f32=False)


def _pt2_verdict(path, args, sub, ref_step, ref_state, ref_probs):
    """The pt2 at ``path`` loaded as test_tile loads it and swept with engine
    auto (the reference step's calibration): None when its state, its
    launches (1 / 8 / 20 tap / q8_matmul / q8_matmul_px a batch) and its
    probs are the in-memory model's, else what differs. Returns (verdict,
    launches, load seconds)."""
    import numpy as np
    import torch

    from cellsegmentation_tpu_torch.bench.sweep import counted
    from cellsegmentation_tpu_torch.cli import common
    from cellsegmentation_tpu_torch.kernels import q8_gemm as tq
    from cellsegmentation_tpu_torch.train.checkpoint import STAGE_SAVE_PARTITIONS
    from cellsegmentation_tpu_torch.train.steps import make_tile_infer_step

    t0 = time.perf_counter()
    try:
        model, _ = common.load_stage_checkpoint(path, _cli_args(),
                                                partitions=STAGE_SAVE_PARTITIONS["tile"])
    except (ValueError, RuntimeError) as e:
        return f"load raised {type(e).__name__}: {' '.join(str(e).split())[:200]}", {}, 0.0
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    sd = model.state_dict()
    differ = [k for k in ref_state if not torch.equal(sd[k], ref_state[k])]
    step = make_tile_infer_step(model, args.tile, _coords(args), engine="auto",
                                device="cuda", scales=ref_step.engine.scales)
    per = []
    tq.reset_launch_counts()
    probs, _ = _sweep(sub, counted(step, per), args)
    launches = {fn.__name__: fn.launches for fn in tq.KERNELS}
    want = {"q8_matmul": 8, "q8_matmul_px": 20, "q8_conv3_tap": 1, "q8_conv3_rowtap": 0}
    if differ:
        return f"{len(differ)} state entries differ, first {differ[0]}", launches, load_s
    if step.resolved_engine != "q8dg" or any(b != want for b in per):
        return f"engine {step.resolved_engine}, launches a batch {per}", launches, load_s
    if not np.array_equal(probs, ref_probs):
        return (f"probs differ, max {np.abs(probs - ref_probs).max():.3g}", launches,
                load_s)
    return None, launches, load_s


def _resume_reading(path, args, batch, n_steps):
    """One stage-1 step after resuming from the pt1 at ``path`` as
    ``train_image -r`` does (load_stage_checkpoint, the file's step, its
    optimizer state), under deterministic algorithms: (state dict, loss,
    warnings, seconds to convert and load the optimizer state)."""
    import warnings

    import torch

    from cellsegmentation_tpu_torch.cli import common
    from cellsegmentation_tpu_torch.train.schedules import make_schedule
    from cellsegmentation_tpu_torch.train.state import create_train_state
    from cellsegmentation_tpu_torch.train.steps import make_image_train_step
    from cellsegmentation_tpu_torch.train.trainers import _restore_optimizer

    model, ck = common.load_stage_checkpoint(path, _cli_args())
    state = create_train_state(model, "image", make_schedule(None, STAGE1_LR, STAGE1_EPOCHS,
                                                             n_steps), device="cuda")
    state.step = ck["step"]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t0 = time.perf_counter()
        _restore_optimizer(state, ck["optimizer"])
        torch.cuda.synchronize()
        opt_s = time.perf_counter() - t0
    step = make_image_train_step(model, seed=args.seed, device="cuda")
    with deterministic_algorithms():
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
    sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
    return sd, float(metrics["loss"]), [str(w.message)[:160] for w in caught], opt_s


def _resume_verdict(got, want):
    """None when the resumed step (a _resume_reading) is the reference's bit
    for bit, with no warning, else what differs."""
    import torch

    sd, loss, warned, _ = got
    if warned:
        return f"warned: {warned[0]}"
    differ = [k for k in want[0] if not torch.equal(sd[k], want[0][k])]
    if differ or loss != want[1]:
        return f"{len(differ)} entries differ (first {differ[:1]}), loss {loss} vs {want[1]}"
    return None


def _rewritten(path, out, edit):
    """A copy of the JAX file at ``path`` with ``edit`` applied to its tree."""
    from cellsegmentation_tpu_torch.utils.flax_msgpack import packb, unpackb

    with open(path, "rb") as f:
        raw = unpackb(f.read())
    edit(raw)
    with open(out, "wb") as f:
        f.write(packb(raw))
    return out


def phase_jaxckpt(args, card, model, s1_state, train, src):
    """The JAX package's checkpoint format on the card: [stage1]'s model and
    Adam state as JAX-format pt1 and pt2, the pt2's sweep and the pt1's
    resumed step against the in-memory model's and the port-format pt1's,
    and three planted faults that must be rejected. Returns the counted
    sweep's launches."""
    import numpy as np
    import torch

    from cellsegmentation_tpu_torch.data.lysto import SubsetSource
    from cellsegmentation_tpu_torch.ops.infer_engine import pick_calib_images
    from cellsegmentation_tpu_torch.train import checkpoint as ckpt_mod
    from cellsegmentation_tpu_torch.train.schedules import make_schedule
    from cellsegmentation_tpu_torch.train.state import create_train_state
    from cellsegmentation_tpu_torch.train.steps import make_tile_infer_step
    from cellsegmentation_tpu_torch.utils.flax_msgpack import unpackb

    t_phase = time.perf_counter()
    sub = SubsetSource(src, np.arange(JAXCKPT_SAMPLES))
    n_batches = math.ceil(JAXCKPT_SAMPLES / args.image_batch)
    n_steps = math.ceil(len(train) / STAGE1_BATCH)
    # the pt2: the stage-1 model with the tile head quieted, a fresh tile Adam
    pt2_model = quiet_head(copy.deepcopy(model))
    tile_state = create_train_state(pt2_model, "tile", make_schedule(None, 1e-3, 1, 1),
                                    device="cuda")
    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        pt1 = ckpt_mod.save_jax_checkpoint(f"{out}/pt1_{STAGE1_EPOCHS}epochs.ckpt", "image",
                                           STAGE1_EPOCHS, "resnet50", model,
                                           s1_state.optimizer, step=s1_state.step)
        pt1_s = time.perf_counter() - t0
        pt2 = ckpt_mod.save_jax_checkpoint(f"{out}/pt2_1epochs.ckpt", "tile", 1, "resnet50",
                                           pt2_model, tile_state.optimizer, step=0)
        port_pt1 = ckpt_mod.save_checkpoint(f"{out}/port_pt1.ckpt", "image", STAGE1_EPOCHS,
                                            "resnet50", model.state_dict(),
                                            s1_state.optimizer.state_dict(),
                                            step=s1_state.step)
        for name, path in (("pt1", pt1), ("pt2", pt2)):
            t0 = time.perf_counter()
            with open(path, "rb") as f:
                unpackb(f.read())
            read_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            ck = ckpt_mod.load_checkpoint(path)
            both_s = time.perf_counter() - t0
            check(isinstance(ck["optimizer"], ckpt_mod.JaxOptimizerState),
                  f"{name}: the optimizer is not the JAX form")
            print(f"[jaxckpt] JAX-format {name}: {os.path.getsize(path)} bytes "
                  f"({len(ck['state_dict'])} entries); read and decode {read_s:.3f} s, "
                  f"read, decode and convert to the port's state dict {both_s:.3f} s"
                  + (f"; written in {pt1_s:.3f} s" if name == "pt1" else ""))

        # the stage-2 handoff and serving: the pt2 through test_tile's load
        ref_step = make_tile_infer_step(pt2_model, args.tile, _coords(args), engine="auto",
                                        calib_images=pick_calib_images(src.images),
                                        device="cuda")
        check(ref_step.resolved_engine == "q8dg", f"engine {ref_step.resolved_engine}")
        warm_flips(ref_step, sub, args.image_batch)
        ref_probs, _ = _sweep(sub, ref_step, args)
        parts = ckpt_mod.STAGE_SAVE_PARTITIONS["tile"]
        ref_state = {k: v for k, v in pt2_model.state_dict().items()
                     if k.split(".", 1)[0] in parts}
        verdict, launches, load_s = _pt2_verdict(pt2, args, sub, ref_step, ref_state,
                                                 ref_probs)
        print(f"[jaxckpt] pt2 through load_stage_checkpoint on the card in {load_s:.3f} s "
              f"(read, convert, build, restore); q8dg sweep of {JAXCKPT_SAMPLES} samples, "
              f"launches over {n_batches} image batches {launches}; state and probs "
              f"against the in-memory model: {verdict or 'bit-equal'}")
        check(verdict is None, f"the JAX-format pt2: {verdict}")

        # resume: one stage-1 step from the JAX-format pt1 and from the port's
        batch = batch_of(train, np.arange(STAGE1_BATCH))
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        want = _resume_reading(port_pt1, args, batch, n_steps)
        got = _resume_reading(pt1, args, batch, n_steps)
        verdict = _resume_verdict(got, want)
        print(f"[jaxckpt] one stage-1 step (batch {STAGE1_BATCH}, deterministic algorithms) "
              f"resumed from the JAX-format pt1 (Adam state converted and loaded in "
              f"{got[3]:.3f} s) against the port-format pt1's: loss {got[1]:.6f} vs "
              f"{want[1]:.6f}; {verdict or 'bit-equal (tolerance 0)'}")
        check(verdict is None, f"the resumed step from the JAX-format pt1: {verdict}")

        # planted faults, each of which a gate must reject
        def hwio_dropped(raw):
            conv = raw["state_dict"]["params"]["encoder"]["layer1_0"]["ConvBNAct_1"]["Conv_0"]
            conv["kernel"] = np.ascontiguousarray(np.transpose(conv["kernel"], (3, 2, 0, 1)))

        def nu_leaf_dropped(raw):
            core = raw["optimizer"]["inner_states"]["train"]["inner_state"]["1"]["0"]
            del core["nu"]["encoder"]["layer1_0"]["ConvBNAct_0"]["Conv_0"]["kernel"]

        cut = f"{out}/pt2_cut.ckpt"
        with open(pt2, "rb") as f, open(cut, "wb") as g:
            g.write(f.read()[: os.path.getsize(pt2) // 2])
        faults = {
            "a conv kernel written without the HWIO transpose": _pt2_verdict(
                _rewritten(pt2, f"{out}/pt2_oihw.ckpt", hwio_dropped), args, sub, ref_step,
                ref_state, ref_probs)[0],
            "an Adam nu leaf dropped": _resume_verdict(_resume_reading(
                _rewritten(pt1, f"{out}/pt1_nu.ckpt", nu_leaf_dropped), args, batch,
                n_steps), want),
            "a truncated pt2": _pt2_verdict(cut, args, sub, ref_step, ref_state,
                                            ref_probs)[0],
        }
    for fault, verdict in faults.items():
        print(f"[jaxckpt] planted fault ({fault}): "
              f"{'passes' if verdict is None else 'rejected: ' + verdict}")
    for fault, verdict in faults.items():
        check(verdict is not None, f"a planted JAX-checkpoint fault passes: {fault}")
    print(f"[jaxckpt] phase {time.perf_counter() - t_phase:.1f} s on {card}")
    return launches


class _KeepLog:
    """A RunLogger that keeps its info lines."""

    def __init__(self, out, run_name):
        from cellsegmentation_tpu_torch.utils.logging import RunLogger

        self.log = RunLogger(out, run_name=run_name, tensorboard=False)
        self.lines = []

    def info(self, msg):
        self.lines.append(msg)
        self.log.info(msg)

    def __getattr__(self, name):
        return getattr(self.log, name)


def _seg_batch(src, rows, flips):
    """A seg batch of ``src`` rows, each mask flipped with its image."""
    import numpy as np

    from cellsegmentation_tpu_torch.train.trainers import flip_masks

    return {"images": src.images[rows], "flip": flips,
            "mask": flip_masks(src.masks[rows], flips),
            "valid": np.ones(len(rows), bool)}


def _seg_step_flops(model, batch):
    """Model FLOPs of one seg train step: the encoder's forward (no
    gradient: its parameters are frozen) plus 3 x the decoder's forward
    (forward, input and weight gradients), the convs' FLOPs counted by
    torch.utils.flop_counter (2 per multiply-add)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from cellsegmentation_tpu_torch.data.batches import normalize_images

    dev = next(model.parameters()).device
    x = normalize_images(torch.as_tensor(batch["images"]).to(dev),
                         torch.as_tensor(batch["flip"]).to(dev))
    probe = copy.deepcopy(model)  # the forwards move BatchNorm statistics
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        probe.encoder(x, train=True)
    enc = fc.get_total_flops()
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        probe(x, mode="segment", train=True)
    return enc + 3 * (fc.get_total_flops() - enc)


def seg_step_reading(model, batch, dev):
    """One seg step's forward and backward on ``model`` (train mode, the
    decoder trainable): (loss, the decoder's gradients as one f64 CPU
    vector, every running statistic as f64 CPU tensors)."""
    import torch

    from cellsegmentation_tpu_torch.train.steps import make_seg_train_step

    model.set_trainable(("seg_decoder",))
    model.zero_grad(set_to_none=True)
    dice, _ = make_seg_train_step(model, device=dev).loss_fn(batch)
    dice.backward()
    grads = torch.cat([p.grad.detach().double().cpu().flatten()
                       for p in model.seg_decoder.parameters()])
    stats = {k: v.detach().double().cpu() for k, v in model.state_dict().items()
             if "running_" in k}
    return float(dice.detach()), grads, stats


def seg_step_gap(got, want):
    """(loss rel, gradient cosine, encoder statistic gap, decoder statistic
    gap, within the S3_* limits) of a seg_step_reading against the
    reference one."""
    (lg, gg, sg), (lc, gc, sc) = got, want
    rel = abs(lg - lc) / abs(lc)
    cos = float(gg @ gc / (gg.norm() * gc.norm()))

    def stat(prefix):
        return max(float((sg[k] - sc[k]).abs().max() / sc[k].abs().max())
                   for k in sc if k.startswith(prefix))

    enc, dec = stat("encoder."), stat("seg_decoder.")
    ok = (rel <= S3_LOSS_RTOL and cos >= S3_GRAD_MIN_COS and enc <= S3_STAT_RTOL
          and dec <= S3_STAT_RTOL)
    return rel, cos, enc, dec, ok


@contextlib.contextmanager
def planted_stage3_fault(fault, model):
    """A fault planted in the port's stage-3 path for the gate to reject:
    ``"align_corners=False"`` (the decoder's upsamples sample half-pixel
    centers) or ``"encoder statistics frozen"`` (the encoder's BatchNorm on
    running statistics in the seg step)."""
    import functools

    import torch.nn.functional as F

    from cellsegmentation_tpu_torch.models import common

    if fault == "align_corners=False":
        orig = common.resize_bilinear_align_corners

        def half_pixel(x, h, w):
            y = F.interpolate(x.permute(0, 3, 1, 2).float(), size=(h, w),
                              mode="bilinear", align_corners=False)
            return y.to(x.dtype).permute(0, 2, 3, 1)

        common.resize_bilinear_align_corners = half_pixel
        try:
            yield
        finally:
            common.resize_bilinear_align_corners = orig
    else:
        model.forward = functools.partial(type(model).forward, model,
                                          freeze_encoder_stats=True)
        try:
            yield
        finally:
            del model.forward


def phase_stage3(args, card):
    """Stage 3 on the card: the draw as the train_seg CLI runs it (counted),
    the per-tile q8 gates, train_stage3 (counted), the seg step's rate, the
    card-vs-CPU seg-step gate with its planted faults, the pt3 handoff and
    the profiles."""
    import numpy as np
    import torch

    from cellsegmentation_tpu_torch.core.dtypes import F32_POLICY
    from cellsegmentation_tpu_torch.data import (
        LystoDataSource,
        MaskDataSource,
        make_synthetic_arrays,
    )
    from cellsegmentation_tpu_torch.kernels import q8_gemm as tq
    from cellsegmentation_tpu_torch.models import build_model
    from cellsegmentation_tpu_torch.ops.infer_engine import pick_calib_images
    from cellsegmentation_tpu_torch.ops.tiles import tile_grid
    from cellsegmentation_tpu_torch.train import checkpoint as ckpt_mod
    from cellsegmentation_tpu_torch.train.schedules import make_schedule
    from cellsegmentation_tpu_torch.train.state import create_train_state
    from cellsegmentation_tpu_torch.train.steps import (
        make_seg_infer_step,
        make_seg_train_step,
        make_tile_infer_step,
    )
    from cellsegmentation_tpu_torch.train.trainers import draw_pseudo_masks, train_stage3
    from cellsegmentation_tpu_torch.utils.logging import RunLogger

    t_phase = time.perf_counter()
    hw, ts, iv = args.hw, STAGE3_TILE, STAGE3_INTERVAL
    a = make_synthetic_arrays(STAGE3_IMAGES, hw, 30, seed=args.seed + 3)
    src = LystoDataSource.from_arrays(a["images"], a["organs"], a["counts"], kfold=None)
    coords = tile_grid(hw, hw, ts, iv)
    n_t = len(coords)
    check(n_t == 3364, f"{n_t} tiles an image on the {ts}/{iv} grid")
    model = quiet_head(build_model("resnet50", device="cuda", seed=args.seed))
    with torch.no_grad():  # a count head pinned at 5, or clearing drops every tile
        model.fc_image_reg[7].weight.zero_()
        model.fc_image_reg[7].bias.fill_(5.0)

    # 1) the draw's engine, built as draw_pseudo_masks builds it
    t0 = time.perf_counter()
    step = make_tile_infer_step(model, ts, coords, engine="auto",
                                calib_images=pick_calib_images(src.images), device="cuda")
    build_s = time.perf_counter() - t0
    check(step.resolved_engine == "q8", f"auto resolved to {step.resolved_engine}, want q8")
    imgs2 = src.images[:2]
    lo0 = logodds(step(imgs2, np.zeros(2, np.int32)).cpu().numpy())
    bias = math.log(STAGE3_THRESHOLD / (1 - STAGE3_THRESHOLD)) - float(
        np.quantile(lo0, 1 - STAGE3_PASS_SHARE))
    with torch.no_grad():
        model.fc_tile[1].bias.copy_(torch.tensor([0.0, bias]))
    print(f"[stage3] per-tile q8 engine build (fold, calibrate) {build_s:.1f} s; "
          f"tile head bias {bias:.4f} so that {STAGE3_PASS_SHARE} of 2 images' tiles "
          f"pass {STAGE3_THRESHOLD}")

    # 2) per-tile q8 log-odds: card vs the exact graph, card vs the CPU
    flip = np.asarray([0, 3], np.int32)
    lq = logodds(step(imgs2, flip).cpu().numpy())
    le = logodds(make_tile_infer_step(model, ts, coords, engine="flax",
                                       device="cuda")(imgs2, flip).cpu().numpy())
    cpu_model = copy.deepcopy(model).cpu()
    lc = logodds(make_tile_infer_step(cpu_model, ts, coords, engine="q8",
                                       scales=step.engine.scales,
                                       device="cpu")(imgs2, flip).numpy())
    lce = logodds(make_tile_infer_step(cpu_model, ts, coords, engine="flax",
                                        device="cpu")(imgs2, flip).numpy())
    del cpu_model
    mx, mean, rank, ok = _gate(lq, lc, Q8_CARD_CPU_MAX, Q8_CARD_CPU_MEAN)
    e_g, e_c = np.abs(lq - le), np.abs(lc - lce)
    print(f"[stage3] per-tile q8 log-odds on 2 images x {n_t} tiles (flips 0, 3): card "
          f"vs CPU max {mx:.5f} mean {mean:.6f} (limits {Q8_CARD_CPU_MAX} / "
          f"{Q8_CARD_CPU_MEAN}), rank corr {[round(r, 4) for r in rank]}; q8 vs the "
          f"exact graph: card max {e_g.max():.5f} mean {e_g.mean():.6f}, CPU max "
          f"{e_c.max():.5f} mean {e_c.mean():.6f} (limit: card mean <= {Q8_EXACT_MEAN} "
          f"and <= CPU mean + {Q8_CARD_CPU_MEAN})")
    check(ok, f"card and CPU per-tile q8 differ by max {mx:.5f} mean {mean:.6f}, rank "
          f"corr {rank}")
    check(e_g.mean() <= Q8_EXACT_MEAN and e_g.mean() <= e_c.mean() + Q8_CARD_CPU_MEAN,
          f"per-tile q8 sits {e_g.mean():.5f} from the exact graph on the card "
          f"(CPU: {e_c.mean():.5f})")

    with tempfile.TemporaryDirectory() as out:
        # 3) the draw, counted: draw_pseudo_masks as train_seg calls it (the
        # default engine build included); then the steady draw timed apart
        step(src.images[:STAGE3_DRAW_BATCH], np.zeros(STAGE3_DRAW_BATCH, np.int32))
        log = _KeepLog(out, "draw")
        tq.reset_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        masks = draw_pseudo_masks(model, src, tile_size=ts, interval=iv,
                                  threshold=STAGE3_THRESHOLD,
                                  image_batch=STAGE3_DRAW_BATCH, logger=log,
                                  device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = {fn.__name__: fn.launches for fn in tq.KERNELS}
        check(not any(launches.values()), f"the draw launched {launches}")
        (line,) = [ln for ln in log.lines if ln.startswith("pseudo-masks:")]
        check(line.endswith("(tile engine q8)"), f"the draw ran {line}")
        kept = int(line.split()[1])
        check(0 < kept < len(src) * n_t, f"{kept} tiles kept")
        check(masks.shape == (len(src), hw, hw) and masks.any(), "no mask drawn")
        secs = []
        for _ in range(2):
            t0 = time.perf_counter()
            again = draw_pseudo_masks(model, src, tile_size=ts, interval=iv,
                                      threshold=STAGE3_THRESHOLD,
                                      image_batch=STAGE3_DRAW_BATCH, logger=log,
                                      device="cuda", infer_tiles_fn=step)
            secs.append(time.perf_counter() - t0)
        check(np.array_equal(again, masks), "the steady draw drew other masks")
        print(f"[stage3] draw_pseudo_masks ({len(src)} images x {n_t} tiles, image batch "
              f"{STAGE3_DRAW_BATCH}, threshold {STAGE3_THRESHOLD}, engine auto -> q8): "
              f"{wall:.2f} s with the engine build ({len(src) / wall:.1f} images/s); "
              f"{kept} tiles kept ({100 * kept / (len(src) * n_t):.2f}%), "
              f"{int((masks.reshape(len(src), -1).max(1) > 0).sum())}/{len(src)} images "
              f"with a mask, {100 * masks.mean():.2f}% of pixels; hand-written kernel "
              f"launches {launches}; peak memory {peak / 2**30:.2f} GiB; steady draw "
              f"(engine built) {[round(x, 4) for x in secs]} s, median "
              f"{len(src) / float(np.median(secs)):.1f} images/s "
              f"({len(src) * n_t / float(np.median(secs)):.0f} tiles/s) on {card}")

        # 4) train_stage3 on the drawn masks, counted
        msrc = MaskDataSource.from_arrays(src.images, masks, augment=True)
        n_steps = math.ceil(len(msrc) / STAGE3_BATCH)
        tq.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with deterministic_algorithms():
            res = train_stage3(model, msrc, epochs=STAGE3_EPOCHS, batch_size=STAGE3_BATCH,
                               lr=STAGE3_LR, weight_decay=1e-4, seed=args.seed,
                               output_dir=out, device="cuda",
                               logger=RunLogger(out, run_name="stage3", tensorboard=False))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in tq.KERNELS}
        check(not any(launches.values()), f"train_stage3 launched {launches}")
        print(f"[stage3] train_stage3: {STAGE3_EPOCHS} epochs of {n_steps} steps (batch "
              f"{STAGE3_BATCH}, Adam lr {STAGE3_LR}, {len(msrc)} augmented samples) in "
              f"{wall:.1f} s on {card}; hand-written kernel launches {launches}")
        for e, st in enumerate(res.epoch_stats, 1):
            check(all(math.isfinite(st[k]) for k in ("loss_ce", "loss_dice", "loss")),
                  f"epoch {e} losses {st}")
            check(st["steps"] == n_steps, f"epoch {e}: {st['steps']} steps")
            print(f"[stage3] epoch {e}: loss_dice {st['loss_dice']:.6f} loss_ce "
                  f"{st['loss_ce']:.6f}; train {st['train']:.4f} s "
                  f"({len(msrc) / st['train']:.1f} images/s)")
        ck = ckpt_mod.load_checkpoint(f"{out}/pt3_{STAGE3_EPOCHS}epochs.ckpt")
        check(ck["mode"] == "segment" and ck["step"] == STAGE3_EPOCHS * n_steps,
              f"checkpoint {ck['mode']} step {ck['step']}")

    # 5) the seg step's rate at batch 32, on a copy of the trained model
    rate_model = copy.deepcopy(model)
    state = create_train_state(rate_model, "segment",
                               make_schedule(None, STAGE3_LR, 1, 1), device="cuda")
    seg_step = make_seg_train_step(rate_model, device="cuda")
    flips = (np.arange(STAGE3_BATCH) % 4).astype(np.int32)
    batch = _seg_batch(msrc, np.arange(STAGE3_BATCH), flips)
    flops = _seg_step_flops(rate_model, batch)
    for _ in range(2):
        state, _ = seg_step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    secs = []
    for _ in range(TRAIN_RATE_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = seg_step(state, batch)
        check(math.isfinite(float(metrics["loss"])), "non-finite seg loss")
        secs.append(time.perf_counter() - t0)
    med = float(np.median(secs))
    peak = torch.cuda.max_memory_allocated()
    print(f"[stage3] seg train step at batch {STAGE3_BATCH}, {len(secs)} steps after 2 "
          f"warm-up in {[round(x, 4) for x in secs]} s: median {med:.4f} s, "
          f"{STAGE3_BATCH / med:.1f} images/s; peak memory {peak / 2**30:.2f} GiB; "
          f"{flops / 1e12:.3f} TFLOP a step (the encoder's forward + 3 x the decoder's): "
          f"MFU {100 * flops / med / BF16_PEAK_FLOPS:.2f}% of "
          f"{BF16_PEAK_FLOPS / 1e12:.0f} TFLOP/s bf16, on {card}")
    profile_step = lambda b=batch: seg_step(state, b)  # noqa: E731

    # 6) one f32 seg step, card against CPU, and the planted faults
    pick = np.arange(S3_CHECK_IMAGES)
    fl = (pick % 4).astype(np.int32)
    batch = _seg_batch(msrc, pick, fl)
    t0 = time.perf_counter()
    cpu = seg_step_reading(build_model("resnet50", policy=F32_POLICY, device="cpu",
                                       seed=args.seed), batch, "cpu")
    cpu_s = time.perf_counter() - t0

    def card_reading(b=batch, fault=None):
        m = build_model("resnet50", policy=F32_POLICY, device="cuda", seed=args.seed)
        if fault is None:
            return seg_step_reading(m, b, "cuda")
        with planted_stage3_fault(fault, m):
            return seg_step_reading(m, b, "cuda")

    planted = {"align_corners=False": (batch, "align_corners=False"),
               "masks left unflipped": (dict(batch, mask=msrc.masks[pick]), None),
               "encoder statistics frozen": (batch, "encoder statistics frozen")}
    gaps = {None: seg_step_gap(card_reading(), cpu)}
    gaps.update({name: seg_step_gap(card_reading(b, fault), cpu)
                 for name, (b, fault) in planted.items()})
    rel, cos, enc, dec, ok = gaps[None]
    limits = (f"limits rel {S3_LOSS_RTOL}, cos {S3_GRAD_MIN_COS}, statistics "
              f"{S3_STAT_RTOL}")
    print(f"[stage3] one f32 seg step of {len(pick)} images (flips {fl.tolist()}), card "
          f"vs CPU ({cpu_s:.1f} s on the CPU): loss {cpu[0]:.6f}, rel {rel:.2e}; decoder "
          f"gradient cosine {cos:.9f}; running statistics gap: encoder {enc:.2e}, "
          f"decoder {dec:.2e} ({limits})")
    for name in planted:
        rel, cos, enc, dec, bad_ok = gaps[name]
        print(f"[stage3] planted fault ({name}) vs CPU: loss rel {rel:.2e}, cosine "
              f"{cos:.9f}, statistics {enc:.2e} / {dec:.2e}: "
              f"{'passes' if bad_ok else 'rejected'}")
    check(ok, "seg step card vs CPU outside the limits")
    for name in planted:
        check(not gaps[name][-1], f"the stage-3 gate passes a planted fault: {name}")

    # 7) the pt3 handoff: the file into a fresh model, bit-equal seg probs
    fresh = build_model("resnet50", device="cuda", seed=args.seed)
    ckpt_mod.restore_into(fresh, ck)
    sd_t, sd_f = model.state_dict(), fresh.state_dict()
    check(sd_t.keys() == sd_f.keys() and all(torch.equal(sd_t[k], sd_f[k]) for k in sd_t),
          "the loaded pt3 model's state differs from the trained one")
    n = min(8, len(msrc))
    imgs, fl = msrc.images[:n], (np.arange(n) % 4).astype(np.int32)
    p_mem = make_seg_infer_step(model, device="cuda")(imgs, fl)
    p_file = make_seg_infer_step(fresh, device="cuda")(imgs, fl)
    check(torch.equal(p_mem, p_file), "seg probs differ between the trained and the "
          "loaded model")
    check(p_mem.shape == (n, hw, hw) and bool(torch.isfinite(p_mem).all()),
          f"seg probs {tuple(p_mem.shape)}")
    print(f"[stage3] pt3 into a fresh model: state equal; make_seg_infer_step on {n} "
          f"images bit-equal, P(positive) {float(p_mem.min()):.4f}..{float(p_mem.max()):.4f}")

    # 8) profiles: one draw batch of 32 images, one seg step
    rows, _ = profile_rows("stage3", f"one per-tile q8 draw batch of 32 images x {n_t} tiles",
                            lambda: step(src.images[:32], np.zeros(32, np.int32)), top=10)
    check(not any("q8_wgmma" in key for _, _, key in rows),
          "the draw's profile shows a hand-written kernel")
    profile_rows("stage3", f"one seg train step of {STAGE3_BATCH} images", profile_step,
                  top=12)
    print(f"[stage3] phase {time.perf_counter() - t_phase:.1f} s")
    return ck


def phase_serve(args, card, model, steps, src, ref):
    """The other serving engines on the 32/20 grid (q8g and q8d sweeps,
    counted, timed in turns with q8dg; each against the CPU and the exact
    graph), then test_tile's path at its defaults with three engines."""
    import os

    import numpy as np
    import torch

    from cellsegmentation_tpu_torch.cli import test_tile
    from cellsegmentation_tpu_torch.data import LystoTestSource, make_synthetic_arrays
    from cellsegmentation_tpu_torch.kernels import q8_gemm as tq
    from cellsegmentation_tpu_torch.ops.tiles import tile_grid
    from cellsegmentation_tpu_torch.train.steps import make_tile_infer_step

    t_phase = time.perf_counter()
    n_batches = math.ceil(len(src) / args.image_batch)
    check(steps["q8g"].resolved_engine == "q8g" and steps["q8d"].resolved_engine == "q8d",
          f"engines {steps['q8g'].resolved_engine} / {steps['q8d'].resolved_engine}")
    launches = {}
    for name in ("q8g", "q8d"):
        warm_flips(steps[name], src, args.image_batch)
        tq.reset_launch_counts()
        probs, _ = _sweep(src, steps[name], args)
        launches[name] = {fn.__name__: fn.launches for fn in tq.KERNELS}
        want = Q8G_LAUNCHES if name == "q8g" else dict.fromkeys(Q8G_LAUNCHES, 0)
        for k, per in want.items():
            check(launches[name][k] == per * n_batches,
                  f"{name}: {k} {launches[name][k]} launches, want {per} x {n_batches}")
        check(probs.shape == (len(src), 225) and bool(np.isfinite(probs).all()),
              f"{name} probs {probs.shape}")
        print(f"[serve] {name} sweep launches over {n_batches} image batches: "
              f"{launches[name]}")
    passes = {"q8dg": [], "q8g": [], "q8d": []}
    for i in range(SWEEP_REPEATS):
        for name in (list(passes) if i % 2 == 0 else list(reversed(passes))):
            passes[name].append(_sweep(src, steps[name], args)[1])
    ips = {k: len(src) / float(np.median(v)) for k, v in passes.items()}
    print(f"[serve] sweeps at 299/32/20, image batch {args.image_batch}, in turns, s: "
          f"{ {k: [round(x, 4) for x in v] for k, v in passes.items()} }; median "
          f"images/s: " + ", ".join(f"{k} {v:.1f}" for k, v in ips.items())
          + f" on {card}")

    # each engine on the card against the port on the CPU (the same scales)
    # and against the exact graph on each device
    imgs, flip = ref["images"], ref["flip"]
    for name in ("q8g", "q8d"):
        cpu_step = make_tile_infer_step(ref["cpu_model"], args.tile, _coords(args),
                                        engine=name, scales=steps[name].engine.scales,
                                        device="cpu")
        check(cpu_step.resolved_engine == name, f"CPU {name} -> {cpu_step.resolved_engine}")
        lg = logodds(steps[name](imgs, flip).cpu().numpy())
        lc = logodds(cpu_step(imgs, flip).numpy())
        mx, mean, rank, ok = _gate(lg, lc)
        e_g, e_c = np.abs(ref["exact_card"] - lg), np.abs(ref["exact_cpu"] - lc)
        print(f"[serve] {name} log-odds, card vs CPU: max {mx:.5f} mean "
              f"{mean:.6f} (limits {CARD_CPU_MAX} / {CARD_CPU_MEAN}), rank corr "
              f"{[round(r, 4) for r in rank]}; vs the exact graph: card max "
              f"{e_g.max():.5f} mean {e_g.mean():.6f}, CPU max {e_c.max():.5f} mean "
              f"{e_c.mean():.6f} (limits: card mean <= {Q8DG_EXACT_MEAN} and <= CPU "
              f"mean + {CARD_CPU_MEAN})")
        check(ok, f"card and CPU {name} differ by max {mx:.5f} mean {mean:.6f}, rank "
              f"corr {rank}")
        check(e_g.mean() <= Q8DG_EXACT_MEAN and e_g.mean() <= e_c.mean() + CARD_CPU_MEAN,
              f"{name} sits {e_g.mean():.5f} from the exact graph on the card "
              f"(CPU: {e_c.mean():.5f})")

    # test_tile's path at its defaults: off the /4 lattice, q8dg -> q8g and
    # auto -> q8
    coords5 = tile_grid(args.hw, args.hw, 32, 5)
    for engine, want in (("q8dg", "q8g"), ("auto", "q8"), ("q8d", "q8")):
        st = make_tile_infer_step(model, 32, coords5, engine=engine, device="cuda",
                                  scales=steps["q8g"].engine.scales)
        check(st.resolved_engine == want,
              f"{engine} resolves to {st.resolved_engine} on the 32/5 grid, want {want}")
    a = make_synthetic_arrays(SERVE_TILE_IMAGES, args.hw, 30, seed=args.seed + 7)
    tsrc = LystoTestSource.from_arrays(a["images"], a["organs"])
    probs = {}
    with tempfile.TemporaryDirectory() as out:
        for engine in SERVE_TILE_ENGINES:
            targs = test_tile.build_parser().parse_args(
                ["-m", "unused", "--infer_engine", engine, "-B", str(SERVE_TILE_BATCH),
                 "-o", f"{out}/{engine}"])
            os.makedirs(targs.output)
            tq.reset_launch_counts()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res = test_tile.evaluate_tiles(model, tsrc, targs, 0, "cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            n_launch = sum(fn.launches for fn in tq.KERNELS)
            p = res["probs"]
            check(res["resolved_engine"] == engine, f"test_tile ran {res['resolved_engine']}")
            check(p.shape == (len(tsrc), len(coords5)) and bool(np.isfinite(p).all()),
                  f"test_tile probs {p.shape}")
            check((n_launch > 0) == (engine == "q8g"),
                  f"test_tile {engine}: {n_launch} hand-written kernel launches")
            n_png = len([f for f in os.listdir(targs.output) if f.endswith(".png")])
            check(n_png == len(tsrc), f"{n_png} heatmaps")
            probs[engine] = p
            print(f"[serve] test_tile (32/5 grid, {len(coords5)} tiles an image, threshold "
                  f"{targs.threshold}, image batch {targs.batch_size}) with {engine}: "
                  f"{len(tsrc)} images in {wall:.2f} s, engine build and heatmaps "
                  f"included ({len(tsrc) / wall:.1f} images/s); {len(res['groups'])} "
                  f"tiles kept; {n_launch} hand-written kernel launches; peak memory "
                  f"{peak / 2**30:.2f} GiB on {card}")
    lo = {k: logodds(v) for k, v in probs.items()}
    print("[serve] test_tile log-odds against flax: " + ", ".join(
        f"{k} mean {np.abs(lo[k] - lo['flax']).mean():.6f}" for k in lo if k != "flax"))
    print(f"[serve] phase {time.perf_counter() - t_phase:.1f} s")
    return launches["q8g"]


def _block_of_calls(calls):
    """The block index of each captured GEMM-land call: a block's calls end
    with its expand, the one call with a residual."""
    blocks, bi = [], 0
    for _, _, kw in calls:
        blocks.append(bi)
        bi += kw.get("residual") is not None
    return blocks


def _distinct_calls(calls):
    """The captured calls once per distinct (wrapper, shapes, options other
    than the scales): (calls, how many of the step's calls each stands
    for, each one's index in ``calls``)."""
    import torch

    keys, firsts, counts = [], [], []
    for i, (fn, args, kw) in enumerate(calls):
        key = (fn, tuple(tuple(a.shape) for a in args if torch.is_tensor(a)),
               tuple(sorted((k, v if not torch.is_tensor(v) else tuple(v.shape))
                            for k, v in kw.items() if not k.endswith("_scale"))))
        if key in keys:
            counts[keys.index(key)] += 1
        else:
            keys.append(key)
            firsts.append(i)
            counts.append(1)
    return [calls[i] for i in firsts], counts, firsts


def _grouped_work(m, rows, groups):
    """(int8 ops, bytes moved once) of block ``m``'s grouped 3x3 as the
    conv itself: 2 x C/g x C' per in-range tap of each output pixel, the
    input and output read and written once, the grouped weight once."""
    from cellsegmentation_tpu_torch.kernels import q8_gemm as tq

    table, _, _ = tq.tap_table(m.h_in, m.w_in, m.stride)
    cg = m.c_mid // groups
    ops = 2 * rows * cg * m.c_mid * sum(len(t) for t in table)
    nbytes = (rows * m.h_in * m.w_in * m.c_mid + 9 * cg * m.c_mid + 2 * 4 * m.c_mid
              + rows * len(table) * m.c_mid)
    return ops, nbytes


def _cudnn_grouped(h1, m, groups):
    """The yardstick of a grouped 3x3: cuDNN's bf16 grouped conv of the same
    map (the captured int8 input as bf16, channels-last) by a seeded bf16
    kernel of the grouped shape; the port never calls it."""
    import torch
    import torch.nn.functional as F

    xb = h1.view(h1.shape[0], m.h_in, m.w_in, m.c_mid).to(torch.bfloat16).permute(0, 3, 1, 2)
    gen = torch.Generator(device=h1.device).manual_seed(0)
    wb = torch.randn((m.c_mid, m.c_mid // groups, 3, 3), generator=gen, device=h1.device,
                     dtype=torch.bfloat16).to(memory_format=torch.channels_last)
    return F.conv2d, (xb, wb), dict(stride=m.stride, padding=1, groups=groups)


def phase_kernels_resnext(args, card, src):
    """Each ResNeXt's q8g GEMM-land at full width on one 32-image step
    (M = 7,200 tile rows): the step counted, every distinct kernel call
    against its plain version and timed as [kernels] times them (the
    101's repeated blocks once, weighted by their count), the rowtap 3x3
    form's calls likewise, each equal to the auto form's 3x3, and each
    grouped 3x3's block-diagonal kernel beside the grouped conv's own bound
    and cuDNN's bf16 grouped conv. Returns per model its counted steps'
    launches and the kernels' sums."""
    import numpy as np
    import torch

    from cellsegmentation_tpu_torch.kernels import q8_gemm as tq
    from cellsegmentation_tpu_torch.models import build_model
    from cellsegmentation_tpu_torch.ops.infer_engine import (
        calib_tiles_from_images,
        calibrate_trunk,
        fold_tile_trunk,
        pick_calib_images,
    )
    from cellsegmentation_tpu_torch.train.steps import make_tile_infer_step

    batch = torch.as_tensor(src.images[: args.image_batch]).cuda()
    flip0 = np.zeros(args.image_batch, np.int32)
    out = {}
    for name in RESNEXTS:
        t0 = time.perf_counter()
        model = quiet_head(build_model(name, device="cuda", seed=args.seed))
        calib = calib_tiles_from_images(pick_calib_images(src.images), _coords(args),
                                        args.tile)
        scales = calibrate_trunk(fold_tile_trunk(model), calib)
        steps = {w2: make_tile_infer_step(model, args.tile, _coords(args), engine="q8g",
                                          device="cuda", scales=scales, w2_impl=w2)
                 for w2 in ("auto", "rowtap")}
        build_s = time.perf_counter() - t0
        metas = steps["auto"].engine.metas
        tq.reset_launch_counts()
        calls = capture_calls(lambda: steps["auto"](batch, flip0))
        torch.cuda.synchronize()
        launches = {fn.__name__: fn.launches for fn in tq.KERNELS}
        check(launches == RESNEXT_Q8G_LAUNCHES[name],
              f"{name}: q8g step launches {launches}, want {RESNEXT_Q8G_LAUNCHES[name]}")
        block = _block_of_calls(calls)
        check(block[-1] == len(metas) - 1, f"{name}: {block[-1] + 1} blocks, {len(metas)} metas")
        distinct, repeat, firsts = _distinct_calls(calls)
        # the row-Toeplitz form: one rowtap 3x3 a block, each bit-identical
        # to the auto form's 3x3 on the same input
        tq.reset_launch_counts()
        row_calls = [c for c in capture_calls(lambda: steps["rowtap"](batch, flip0))
                     if c[0] is tq.q8_conv3_rowtap]
        n_row = tq.q8_conv3_rowtap.launches
        check(n_row == len(row_calls) == len(metas), f"{name}: {n_row} rowtap launches, "
              f"{len(metas)} blocks")
        auto3 = [c for c in calls if c[0] is not tq.q8_matmul_px]
        for bi, ((fr, ar, kr), (fa, aa, ka)) in enumerate(zip(row_calls, auto3)):
            check(torch.equal(fr(*ar, **kr), fa(*aa, **ka)),
                  f"{name} block {bi}: the rowtap 3x3 differs from the auto form's")
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        print(f"[kernels-resnext] {name}: engines built in {build_s:.1f} s (fold, calibrate, "
              f"pack both 3x3 forms); one q8g step of {args.image_batch} images "
              f"(M = {calls[0][1][0].shape[0]}) launches {launches}; {len(distinct)} distinct "
              f"calls of {len(calls)}; c_mid by layer "
              f"{sorted(set((m.c_mid) for m in metas))}; memory peak so far "
              f"{peak / 2**30:.2f} GiB")
        stats, three = measure_calls(distinct, f"kernels-resnext {name}", repeat)
        for fn in tq.KERNELS:
            check(stats[fn]["calls"] == launches[fn.__name__],
                  f"{name}: {fn.__name__} measured {stats[fn]['calls']} calls")
        d_row, r_row, _ = _distinct_calls(row_calls)
        stats[tq.q8_conv3_rowtap] = measure_calls(d_row, f"kernels-resnext {name}",
                                                   r_row)[0][tq.q8_conv3_rowtap]
        launches["q8_conv3_rowtap"] = n_row
        print_stats(stats, f"kernels-resnext {name}",
                     f"per image batch (rowtap: the rowtap form's {n_row})")

        # each distinct grouped 3x3 beside the grouped conv's own work
        keys = ("kernel_ms", "bound_ms", "grouped_bound_ms", "cudnn_ms", "ops", "grouped_ops")
        grouped = {fn: dict.fromkeys(keys, 0.0) for fn in tq.KERNELS}
        for (fn, a, kw), rep, i in zip(distinct, repeat, firsts):
            if fn is tq.q8_matmul_px:
                continue
            bi = block[i]
            m, h1 = metas[bi], a[0]
            ops, nbytes = call_work(fn, a, kw)
            g_ops, g_bytes = _grouped_work(m, h1.shape[0], RESNEXT_GROUPS)
            bound = max(ops / PEAK_INT8_OPS, nbytes / PEAK_BYTES) * 1e3
            g_bound = max(g_ops / PEAK_INT8_OPS, g_bytes / PEAK_BYTES) * 1e3
            k_ms = three.pop(0)[1]  # [kernels-resnext]'s cold time of this call
            conv, cargs, ckw = _cudnn_grouped(h1, m, RESNEXT_GROUPS)
            c_ms = graph_ms(conv, cargs, ckw, cold=True)
            del conv, cargs, ckw
            for key, v in (("kernel_ms", k_ms), ("bound_ms", bound),
                           ("grouped_bound_ms", g_bound), ("cudnn_ms", c_ms),
                           ("ops", ops), ("grouped_ops", g_ops)):
                grouped[fn][key] += rep * v
            print(f"[kernels-resnext] {name} block {bi} 3x3 ({m.h_in}x{m.w_in} s{m.stride}, "
                  f"c_mid {m.c_mid}, x{rep}): block-diagonal {fn.__name__} {k_ms:.5f} ms "
                  f"cold; bound expanded {bound:.5f} ms ({100 * bound / k_ms:.1f}%), grouped "
                  f"{g_bound:.5f} ms ({ops / g_ops:.1f}x the operations); cuDNN bf16 "
                  f"grouped conv {c_ms:.5f} ms cold")
        tot = {k: sum(g[k] for g in grouped.values()) for k in keys}
        print(f"[kernels-resnext] {name} grouped 3x3s of one step: block-diagonal kernels "
              f"{tot['kernel_ms']:.4f} ms cold, bound expanded {tot['bound_ms']:.4f} ms, grouped "
              f"{tot['grouped_bound_ms']:.4f} ms ({tot['ops'] / tot['grouped_ops']:.1f}x the "
              f"operations), cuDNN bf16 grouped {tot['cudnn_ms']:.4f} ms cold, on {card}")
        # the rowtap form's 3x3s do the same grouped convs
        grouped[tq.q8_conv3_rowtap].update(grouped_bound_ms=tot["grouped_bound_ms"],
                                           cudnn_ms=tot["cudnn_ms"])
        out[name] = {"launches": launches, "stats": stats, "grouped": grouped}
        del model, steps, calls, distinct
        torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def _groups_ignored():
    """A planted fault: the block-diagonal expansion copies each group's
    kernel across every input group instead of its own."""
    import numpy as np

    from cellsegmentation_tpu_torch.ops import q8_trunk

    orig = q8_trunk._expand_grouped
    q8_trunk._expand_grouped = lambda k2, g: np.tile(k2, (1, 1, g, 1))
    try:
        yield
    finally:
        q8_trunk._expand_grouped = orig


def _wrong_group_epilogue(engine, groups):
    """A planted fault in GEMM-land: every block-diagonal 3x3's epilogue
    reads the previous group's scales and bias (each channel's of c_mid/g
    channels before; the whole-tile form's per-pixel copies roll alike)."""
    import torch

    for p, m in zip(engine.qparams, engine.metas):
        for k in ("s2", "b2"):
            p[k] = torch.roll(p[k], m.c_mid // groups, dims=0)


def _wrong_group_weights(engine, groups):
    """A planted fault in conv-land: every grouped 3x3 reads its next
    group's kernel."""
    import torch

    stem_w, stem_b, stages = engine.tree
    engine.tree = (stem_w, stem_b, [
        [tuple(torch.roll(t, t.shape[0] // groups, dims=0) if j == 2 else t
               for j, t in enumerate(blk)) for blk in stage] for stage in stages])


def phase_resnext(args, card, src):
    """ResNeXt-50 at full width on the [slice] source: every engine's sweep
    at 299/32/20, counted (auto -> q8dg's dense conv chain and per-tile q8
    reach no kernel; q8g; q8dg with the grouped dense GEMM), each engine
    against the port on the CPU and against the exact graph under
    ResNeXt's own limits, each card-vs-CPU gate against planted faults, the
    sweeps timed in turns with their peak memory. Returns q8g's counted
    launches."""
    import numpy as np
    import torch

    from cellsegmentation_tpu_torch.kernels import q8_gemm as tq
    from cellsegmentation_tpu_torch.models import build_model
    from cellsegmentation_tpu_torch.ops.infer_engine import pick_calib_images
    from cellsegmentation_tpu_torch.train.steps import make_tile_infer_step

    t_phase = time.perf_counter()
    name = RESNEXTS[0]
    n_batches = math.ceil(len(src) / args.image_batch)
    model = quiet_head(build_model(name, device="cuda", seed=args.seed))
    coords = _coords(args)
    t0 = time.perf_counter()
    auto = make_tile_infer_step(model, args.tile, coords, engine="auto",
                                calib_images=pick_calib_images(src.images), device="cuda")
    q8g = make_tile_infer_step(model, args.tile, coords, engine="q8g",
                               calib_images=pick_calib_images(src.images), device="cuda")
    build_s = time.perf_counter() - t0
    scales = q8g.engine.scales
    # (engine, step keywords, resolved engine, dense backend, launches per batch)
    cases = {
        "auto": ("auto", {}, "q8dg", "conv", {}),
        "q8": ("q8", {}, "q8", None, {}),
        "q8g": ("q8g", {}, "q8g", None, RESNEXT_Q8G_LAUNCHES[name]),
        "q8dg-gemm": ("q8dg", {"grouped_gemm": True}, "q8dg", "gemm", RESNEXT_Q8DG_LAUNCHES),
    }

    def make(key, dev, mdl):
        engine, kw, _, _, _ = cases[key]
        return make_tile_infer_step(mdl, args.tile, coords, engine=engine, device=dev,
                                    scales=scales, **kw)

    steps = {"auto": auto, "q8g": q8g}
    steps.update({k: make(k, "cuda", model) for k in cases if k not in steps})
    for key, (_, _, resolved, backend, _) in cases.items():
        st = steps[key]
        check(st.resolved_engine == resolved, f"{key} resolves to {st.resolved_engine}")
        check(backend is None or st.engine.backend == backend,
              f"{key}: dense backend {getattr(st.engine, 'backend', None)}, want {backend}")
    print(f"[resnext] {name} at full width (head x {HEAD_SCALE}): auto -> q8dg (the dense "
          f"conv chain), built with q8g in {build_s:.1f} s; every engine on q8g's scales")

    probs, launches, peaks = {}, {}, {}
    for key in cases:
        warm_flips(steps[key], src, args.image_batch)
        tq.reset_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        probs[key], _ = _sweep(src, steps[key], args)
        peaks[key] = torch.cuda.max_memory_allocated()
        launches[key] = {fn.__name__: fn.launches for fn in tq.KERNELS}
        want = {fn.__name__: cases[key][4].get(fn.__name__, 0) * n_batches for fn in tq.KERNELS}
        check(launches[key] == want, f"{key}: launches {launches[key]}, want {want}")
        check(probs[key].shape == (len(src), 225) and bool(np.isfinite(probs[key]).all()),
              f"{key} probs {probs[key].shape}")
        print(f"[resnext] {key} sweep launches over {n_batches} image batches: "
              f"{launches[key]}; peak memory {peaks[key] / 2**30:.2f} GiB")
    passes = {k: [] for k in cases}
    for i in range(SWEEP_REPEATS):
        for key in (list(passes) if i % 2 == 0 else list(reversed(passes))):
            passes[key].append(_sweep(src, steps[key], args)[1])
    ips = {k: len(src) / float(np.median(v)) for k, v in passes.items()}
    print(f"[resnext] sweeps at 299/32/20, image batch {args.image_batch}, in turns, s: "
          f"{ {k: [round(x, 4) for x in v] for k, v in passes.items()} }; median images/s: "
          + ", ".join(f"{k} {v:.1f}" for k, v in ips.items()) + f" on {card}")

    # each engine on the card against the port on the CPU and the exact graph
    imgs, flip = src.images[:2], np.asarray([0, 3], np.int32)
    cpu_model = quiet_head(build_model(name, device="cpu", seed=args.seed))
    exact_g = logodds(make_tile_infer_step(model, args.tile, coords, engine="flax",
                                            device="cuda")(imgs, flip).cpu().numpy())
    exact_c = logodds(make_tile_infer_step(cpu_model, args.tile, coords, engine="flax",
                                            device="cpu")(imgs, flip).numpy())
    cpu_lo = {}
    for key in cases:
        cpu_step = make(key, "cpu", cpu_model)
        check(cpu_step.resolved_engine == cases[key][2], f"CPU {key} -> {cpu_step.resolved_engine}")
        lg = logodds(steps[key](imgs, flip).cpu().numpy())
        cpu_lo[key] = lc = logodds(cpu_step(imgs, flip).numpy())
        mx, mean, rank, ok = _gate(lg, lc, RESNEXT_CARD_CPU_MAX, RESNEXT_CARD_CPU_MEAN)
        e_g, e_c = np.abs(exact_g - lg), np.abs(exact_c - lc)
        print(f"[resnext] {key} log-odds, card vs CPU: max {mx:.5f} mean {mean:.6f} "
              f"(limits {RESNEXT_CARD_CPU_MAX} / {RESNEXT_CARD_CPU_MEAN}), rank corr "
              f"{min(rank):.4f}; vs the exact graph: card max {e_g.max():.5f} mean "
              f"{e_g.mean():.6f}, CPU max {e_c.max():.5f} mean {e_c.mean():.6f} (limits: "
              f"card mean <= {RESNEXT_EXACT_MEAN} and <= CPU mean + {RESNEXT_CARD_CPU_MEAN})")
        check(ok, f"{key}: card and CPU differ by max {mx:.5f} mean {mean:.6f} "
              f"rank {min(rank):.4f}")
        check(e_g.mean() <= RESNEXT_EXACT_MEAN
              and e_g.mean() <= e_c.mean() + RESNEXT_CARD_CPU_MEAN,
              f"{key} sits {e_g.mean():.5f} from the exact graph on the card "
              f"(CPU: {e_c.mean():.5f})")
    del cpu_model

    # every gate against the faults planted in its engine on the card
    def planted(key):
        if key in ("q8g", "q8dg-gemm"):
            with _groups_ignored():
                yield make(key, "cuda", model), "groups ignored in the expansion"
            st = make(key, "cuda", model)
            _wrong_group_epilogue(st.engine, RESNEXT_GROUPS)
            yield st, "the wrong group's scales and bias"
        else:
            st = make(key, "cuda", model)
            _wrong_group_weights(st.engine, RESNEXT_GROUPS)
            yield st, "the wrong group's 3x3 kernel"

    for key in cases:
        for st, fault in planted(key):
            lg = logodds(st(imgs, flip).cpu().numpy())
            mx, mean, rank, ok = _gate(lg, cpu_lo[key], RESNEXT_CARD_CPU_MAX,
                                       RESNEXT_CARD_CPU_MEAN)
            print(f"[resnext] planted fault in {key} ({fault}) vs CPU: max {mx:.5f} mean "
                  f"{mean:.6f} rank corr {min(rank):.4f}; vs the exact graph mean "
                  f"{np.abs(exact_g - lg).mean():.6f}: {'passes' if ok else 'rejected'}")
            check(not ok, f"the {key} gate passes a planted fault: {fault}")
            del st
    print(f"[resnext] phase {time.perf_counter() - t_phase:.1f} s")
    return launches["q8g"]


def _spread_count_head(model, images, mean, std, seed, device="cuda"):
    """Rewrite ``model``'s count head so that its counts before the final
    ReLU on ``images`` have this mean and standard deviation and differ
    image by image: BN1 standardizes the images' own pooled features by
    their spread over these images, a seeded Dense maps them to 64 units,
    BN2 standardizes those, and the last Dense maps a seeded combination of
    them onto the mean and spread. Each image's count is read from the
    trained encoder's features of that image."""
    import numpy as np
    import torch

    from cellsegmentation_tpu_torch.train.steps import make_image_infer_step

    head = model.fc_image_reg
    pooled = []
    hook = head.register_forward_hook(lambda mod, inp, out: pooled.append(inp[0].float()))
    try:
        make_image_infer_step(model, device=device)(images, np.zeros(len(images), np.int32))
    finally:
        hook.remove()
    x = torch.cat(pooled)
    gen = torch.Generator(device=x.device).manual_seed(seed)

    def standardize(bn, v):  # BN1d on v's own statistics, unit affine
        bn.running_mean.copy_(v.mean(0))
        bn.running_var.copy_(v.var(0) + (1e-2 * v.abs().mean()) ** 2)
        bn.weight.fill_(1.0)
        bn.bias.zero_()
        return (v - bn.running_mean) / torch.sqrt(bn.running_var + bn.eps)

    with torch.no_grad():
        z = torch.relu(standardize(head[1], x))
        w4 = torch.randn(head[4].weight.shape, generator=gen, device=x.device)
        head[4].weight.copy_(w4 / math.sqrt(x.shape[1]))
        head[4].bias.zero_()
        z = standardize(head[5], z @ head[4].weight.float().T)
        w7 = torch.randn((z.shape[1],), generator=gen, device=x.device)
        t = z @ w7
        scale = std / float(t.std())
        head[7].weight.copy_((w7 * scale)[None])
        head[7].bias.fill_(mean - float(t.mean()) * scale)


def phase_ensemble(args, card):
    """train_ensemble's folds on ResNeXt-50 from arrays (k folds, 1 epoch,
    the CLI's batch 48), counted: no hand-written kernel; each fold's
    checkpoint reloaded; each fold's count head spread over the test
    images, then test_ensemble's counts against round(mean) of the folds'
    own inference_image; the f32 card-vs-CPU image step gate with
    its planted faults, and the step's images/s, MFU and peak memory."""
    import os

    import numpy as np
    import torch

    from cellsegmentation_tpu_torch import infer
    from cellsegmentation_tpu_torch.cli import test_ensemble, train_ensemble
    from cellsegmentation_tpu_torch.data import (
        EnsembleSource,
        LystoTestSource,
        make_synthetic_arrays,
    )
    from cellsegmentation_tpu_torch.kernels import q8_gemm as tq
    from cellsegmentation_tpu_torch.models import build_model
    from cellsegmentation_tpu_torch.train import checkpoint as ckpt_mod
    from cellsegmentation_tpu_torch.train.steps import make_image_infer_step
    from cellsegmentation_tpu_torch.utils.logging import RunLogger

    t_phase = time.perf_counter()
    name = RESNEXTS[0]
    a = make_synthetic_arrays(ENSEMBLE_IMAGES, args.hw, 30, seed=args.seed + 17)
    ens = EnsembleSource.from_arrays(a["images"], a["organs"], a["counts"], k=ENSEMBLE_K)
    t = make_synthetic_arrays(ENSEMBLE_TEST_IMAGES, args.hw, 30, seed=args.seed + 19)
    test_src = LystoTestSource.from_arrays(t["images"], t["organs"])
    trained = []
    orig = train_ensemble.train_stage1

    def keep_model(model, *a, **kw):  # the fold's model, for the checks below
        trained.append(model)
        return orig(model, *a, **kw)

    with tempfile.TemporaryDirectory() as out:
        eargs = train_ensemble.build_parser().parse_args(
            ["-E", name, "-e", str(ENSEMBLE_EPOCHS), "-k", str(ENSEMBLE_K), "-o", out,
             "--seed", str(args.seed)])
        check(eargs.batch_size == STAGE1_BATCH, f"the CLI's batch {eargs.batch_size}")
        train_ensemble.train_stage1 = keep_model
        tq.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            paths = train_ensemble.train_folds(
                ens, eargs, RunLogger(out, run_name="ensemble", tensorboard=False), "cuda")
        finally:
            train_ensemble.train_stage1 = orig
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in tq.KERNELS}
        check(not any(launches.values()), f"train_ensemble launched {launches}")
        names = [os.path.basename(p) for p in paths]
        check(names == [f"reg_pt1_{i}_{ENSEMBLE_EPOCHS}epochs.ckpt" for i in range(ENSEMBLE_K)],
              f"checkpoints {names}")
        sizes = [tuple(len(v) for v in ens.fold(i)) for i in range(ENSEMBLE_K)]
        print(f"[ensemble] train_ensemble on {name}: {ENSEMBLE_K} folds (train, val) "
              f"{sizes}, {ENSEMBLE_EPOCHS} epoch each at batch {eargs.batch_size}, in "
              f"{wall:.1f} s on {card}; wrote {names}; hand-written kernel launches "
              f"{launches}")
        counts = []
        for path, model in zip(paths, trained):
            ck = ckpt_mod.load_checkpoint(path)
            check((ck["mode"], ck["epoch"], ck["encoder"]) == ("image", ENSEMBLE_EPOCHS, name),
                  f"{path}: {ck['mode']} {ck['epoch']} {ck['encoder']}")
            fresh = build_model(name, device="cuda", seed=args.seed + 99)
            ckpt_mod.restore_into(fresh, ck, ckpt_mod.STAGE_SAVE_PARTITIONS["image"])
            sd_t, sd_f = model.state_dict(), fresh.state_dict()
            parts = ckpt_mod.STAGE_SAVE_PARTITIONS["image"]
            check(all(torch.equal(sd_t[k], sd_f[k]) for k in sd_t
                      if k.split(".", 1)[0] in parts),
                  f"{path}: the reloaded model's state differs from the trained one")
            c_t = infer.inference_image(test_src, make_image_infer_step(model, device="cuda"),
                                        batch_size=128)[1]
            c_f = infer.inference_image(test_src, make_image_infer_step(fresh, device="cuda"),
                                        batch_size=128)[1]
            check(np.array_equal(c_t, c_f), f"{path}: counts differ after the reload")
            counts.append(c_t)
            del fresh
        targs = test_ensemble.build_parser().parse_args(["-m", out, "-e", str(ENSEMBLE_EPOCHS)])
        check(test_ensemble.ensemble_paths(out, ENSEMBLE_EPOCHS) == sorted(paths),
              "test_ensemble finds other checkpoints")
        t0 = time.perf_counter()
        final = test_ensemble.ensemble_counts(sorted(paths), test_src, targs, "cuda")
        e_s = time.perf_counter() - t0
        want = np.asarray(counts).mean(axis=0).round().astype(int)
        check(np.array_equal(final, want), f"ensemble counts {final[:8]} vs {want[:8]}")
        print(f"[ensemble] each checkpoint reloaded (state equal, counts bit-equal); "
              f"test_ensemble over {len(test_src)} images x {ENSEMBLE_K} models in "
              f"{e_s:.2f} s: round(mean) of the folds' own counts, "
              f"{final.min()}..{final.max()}")
        # one epoch leaves every count at 0 (the head's ReLU) and the raw
        # counts one value over the images: each fold's count head is
        # rewritten (in the trained model and its file alike) to spread its
        # counts over the test images, each fold about its own mean
        for i, (path, model) in enumerate(zip(paths, trained)):
            _spread_count_head(model, test_src.images, ENSEMBLE_COUNT_MEANS[i],
                               ENSEMBLE_COUNT_STDS[i], args.seed + i)
            ck = ckpt_mod.load_checkpoint(path)
            for k, v in model.state_dict().items():
                if k.startswith("fc_image_reg."):
                    ck["state_dict"][k] = v.cpu()
            torch.save(ck, path)
            counts[i] = infer.inference_image(
                test_src, make_image_infer_step(model, device="cuda"), batch_size=128)[1]
        final = test_ensemble.ensemble_counts(sorted(paths), test_src, targs, "cuda")
    counts = np.asarray(counts)
    want = counts.mean(axis=0).round().astype(int)
    check(np.array_equal(final, want), f"ensemble counts {final[:8]} vs {want[:8]}")
    n_values = [len(set(c.tolist())) for c in counts]
    check(min(n_values) >= 5, f"the folds' counts take {n_values} values over the images")
    # round(mean) is neither one fold's counts nor the median: a wrong
    # averaging (one checkpoint, the median, a sum) differs on some image
    off_fold = [int((final != c).sum()) for c in counts]
    off_median = int((final != np.median(counts, axis=0)).sum())
    check(min(off_fold) > 0 and off_median > 0,
          f"round(mean) equals a fold's counts or the median: images apart from each "
          f"fold {off_fold}, from the median {off_median}")
    print(f"[ensemble] with each fold's count head spread (means {ENSEMBLE_COUNT_MEANS}, "
          f"stds {ENSEMBLE_COUNT_STDS}): the folds' counts take {n_values} values over "
          f"{len(test_src)} images; test_ensemble's counts {final.min()}..{final.max()} = "
          f"round(mean) of the folds' own, apart from each fold's on {off_fold} images "
          f"and from the median on {off_median}")
    del trained
    torch.cuda.empty_cache()

    train, _ = _stage1_sources(args)
    _stage1_gate(args, train, name, "ensemble")
    step_model = build_model(name, device="cuda", seed=args.seed)
    tq.reset_launch_counts()
    _stage1_rate(step_model, train, args, card, "ensemble")
    launches = {fn.__name__: fn.launches for fn in tq.KERNELS}
    check(not any(launches.values()), f"the {name} image step launched {launches}")
    print(f"[ensemble] phase {time.perf_counter() - t_phase:.1f} s")


@contextlib.contextmanager
def _se_range(name="squeeze-excite"):
    """Every squeeze-excite gate, the engine's and the model's, inside a
    ``record_function`` range called ``name`` (for the profiles)."""
    from torch.profiler import record_function

    from cellsegmentation_tpu_torch.models import efficientnet
    from cellsegmentation_tpu_torch.ops import effnet_engine

    se_fn, se_fwd = effnet_engine._se, efficientnet.SqueezeExcitation.forward

    def se(x, w):
        with record_function(name):
            return se_fn(x, w)

    def fwd(self, x):
        with record_function(name):
            return se_fwd(self, x)

    effnet_engine._se, efficientnet.SqueezeExcitation.forward = se, fwd
    try:
        yield name
    finally:
        effnet_engine._se, efficientnet.SqueezeExcitation.forward = se_fn, se_fwd


@contextlib.contextmanager
def _planted_effnet_sweep_fault(fault, model, step):
    """A fault planted in an EfficientNet sweep for the card-vs-CPU gate:
    ``"squeeze-excite gate left out"`` (the engine's x * gate is x),
    ``"a block's sandwich scale from its neighbour"`` (on ``step``'s engine,
    the block whose scale differs most from the next one's), ``"stochastic
    depth at inference"`` (the exact graph's encoder draws its masks in
    eval mode)."""
    from cellsegmentation_tpu_torch.models.efficientnet import EfficientNetEncoder
    from cellsegmentation_tpu_torch.ops import effnet_engine

    if fault == "squeeze-excite gate left out":
        orig = effnet_engine._se
        effnet_engine._se = lambda x, se: x
        try:
            yield
        finally:
            effnet_engine._se = orig
    elif fault == "a block's sandwich scale from its neighbour":
        sc = step.engine.scales
        i = max(range(len(sc) - 1), key=lambda j: abs(math.log(sc[j + 1] / sc[j])))
        orig = sc[i]
        sc[i] = sc[i + 1]
        try:
            yield
        finally:
            sc[i] = orig
    else:
        enc = model.encoder

        def block_masks(n, train, *a, **k):
            return EfficientNetEncoder.block_masks(enc, n, True, *a, **k)

        enc.block_masks = block_masks
        try:
            yield
        finally:
            del enc.block_masks


def _effnet_sweeps(args, card, src, name):
    """One EfficientNet's sweep at 299/32/20: auto (-> q8, the MBConv
    engine) and flax, counted and timed in turns with their peak memory;
    each against the port on the CPU and the engine against the exact
    graph; on B0 the planted faults. Returns (model, auto step)."""
    import numpy as np
    import torch

    from cellsegmentation_tpu_torch.data import normalize_images
    from cellsegmentation_tpu_torch.kernels import q8_gemm as tq
    from cellsegmentation_tpu_torch.models import build_model
    from cellsegmentation_tpu_torch.models.milnet import settle_batch_stats
    from cellsegmentation_tpu_torch.ops.effnet_engine import EffTrunkLogits
    from cellsegmentation_tpu_torch.ops.infer_engine import pick_calib_images
    from cellsegmentation_tpu_torch.ops.tiles import extract_tiles
    from cellsegmentation_tpu_torch.train.steps import make_tile_infer_step

    n_batches = math.ceil(len(src) / args.image_batch)
    model = quiet_head(build_model(name, device="cuda", seed=args.seed))
    coords = _coords(args)
    x = extract_tiles(torch.as_tensor(src.images[:EFFNET_SETTLE_IMAGES]).cuda(), coords,
                      args.tile).flatten(0, 1)
    settle_batch_stats(model, normalize_images(x, torch.zeros(len(x), dtype=torch.int32,
                                                                 device="cuda")))
    t0 = time.perf_counter()
    steps = {"auto": make_tile_infer_step(model, args.tile, coords, engine="auto",
                                          calib_images=pick_calib_images(src.images),
                                          device="cuda"),
             "flax": make_tile_infer_step(model, args.tile, coords, engine="flax",
                                          device="cuda")}
    build_s = time.perf_counter() - t0
    check(steps["auto"].resolved_engine == "q8"
          and isinstance(steps["auto"].engine, EffTrunkLogits),
          f"{name}: auto resolved to {steps['auto'].resolved_engine}, want q8")
    scales = steps["auto"].engine.scales
    print(f"[effnet] {name} at full width ({len(model.encoder.blocks)} blocks, feature_dim "
          f"{model.encoder.feature_dim}, head x {HEAD_SCALE}, statistics from the "
          f"{len(x)} tiles of {EFFNET_SETTLE_IMAGES} images): auto -> q8, the MBConv "
          f"engine, built in "
          f"{build_s:.1f} s; block-output scales {[round(v, 4) for v in scales]}")
    peaks = {}
    for key, st in steps.items():
        warm_flips(st, src, args.image_batch)
        tq.reset_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        probs, _ = _sweep(src, st, args)
        peaks[key] = torch.cuda.max_memory_allocated()
        launches = {fn.__name__: fn.launches for fn in tq.KERNELS}
        check(not any(launches.values()), f"{name} {key} sweep launched {launches}")
        check(probs.shape == (len(src), 225) and bool(np.isfinite(probs).all()),
              f"{name} {key} probs {probs.shape}")
    passes = {k: [] for k in steps}
    for i in range(SWEEP_REPEATS):
        for key in (list(passes) if i % 2 == 0 else list(reversed(passes))):
            passes[key].append(_sweep(src, steps[key], args)[1])
    ips = {k: len(src) / float(np.median(v)) for k, v in passes.items()}
    print(f"[effnet] {name} sweeps at 299/32/20, {n_batches} image batches of "
          f"{args.image_batch} (M = {args.image_batch * 225}), no hand-written kernel "
          f"launched; in turns, s: { {k: [round(v, 4) for v in p] for k, p in passes.items()} }; "
          f"median images/s: " + ", ".join(f"{k} {v:.1f}" for k, v in ips.items())
          + "; peak memory " + ", ".join(f"{k} {v / 2**30:.2f} GiB" for k, v in peaks.items())
          + f" on {card}")

    imgs, flip = src.images[:2], np.asarray([0, 3], np.int32)
    cpu_model = build_model(name, device="cpu", seed=args.seed)
    cpu_model.load_state_dict(model.state_dict())
    cpu = {"auto": make_tile_infer_step(cpu_model, args.tile, coords, engine="auto",
                                        scales=scales, device="cpu"),
           "flax": make_tile_infer_step(cpu_model, args.tile, coords, engine="flax",
                                        device="cpu")}
    check(cpu["auto"].resolved_engine == "q8", "CPU auto resolution")
    lo = {(k, d): logodds((steps[k] if d == "card" else cpu[k])(imgs, flip).cpu().numpy())
          for k in steps for d in ("card", "cpu")}
    limits = EFFNET_LIMITS[name]
    for key in steps:
        mx, mean, rank, ok = _gate(lo[key, "card"], lo[key, "cpu"], *limits[key])
        print(f"[effnet] {name} {key} log-odds card vs CPU: max {mx:.5f} mean {mean:.6f} "
              f"rank corr {min(rank):.4f} (limits {limits[key]}); card log-odds "
              f"{lo[key, 'card'].min():.4f}.."
              f"{lo[key, 'card'].max():.4f} (std {lo[key, 'card'].std():.5f})")
        check(ok, f"{name} {key}: card and CPU differ by max {mx:.5f} mean {mean:.6f} "
              f"rank {min(rank):.4f}")
    e_g = np.abs(lo["auto", "card"] - lo["flax", "card"])
    e_c = np.abs(lo["auto", "cpu"] - lo["flax", "cpu"])
    print(f"[effnet] {name} q8 vs the exact graph, log-odds: card max {e_g.max():.5f} mean "
          f"{e_g.mean():.6f}; CPU max {e_c.max():.5f} mean {e_c.mean():.6f} (limits: card "
          f"mean <= {EFFNET_EXACT_MEAN} and <= CPU mean + {EFFNET_EXACT_SLACK})")
    check(e_g.mean() <= EFFNET_EXACT_MEAN and e_g.mean() <= e_c.mean() + EFFNET_EXACT_SLACK,
          f"{name}: q8 sits {e_g.mean():.5f} from the exact graph on the card")
    if name == EFFNETS[0]:
        for fault, key in (("squeeze-excite gate left out", "auto"),
                           ("a block's sandwich scale from its neighbour", "auto"),
                           ("stochastic depth at inference", "flax")):
            st = make_tile_infer_step(model, args.tile, coords, engine=key, device="cuda",
                                      scales=scales if key == "auto" else None)
            with _planted_effnet_sweep_fault(fault, model, st):
                lg = logodds(st(imgs, flip).cpu().numpy())
            mx, mean, rank, ok = _gate(lg, lo[key, "cpu"], *limits[key])
            print(f"[effnet] planted fault in {key} ({fault}) vs CPU: max {mx:.5f} mean "
                  f"{mean:.6f} rank corr {min(rank):.4f}: "
                  f"{'passes' if ok else 'rejected'}")
            check(not ok, f"the {key} gate passes a planted fault: {fault}")
    return model, steps["auto"]


def phase_effnet(args, card, src):
    """EfficientNet-B0/B2 through stages 1 and 2 on the card (module
    docstring, item 14)."""
    import numpy as np
    import torch

    from cellsegmentation_tpu_torch.data import (
        LystoDataSource,
        MaskDataSource,
        normalize_images,
    )
    from cellsegmentation_tpu_torch.kernels import q8_gemm as tq
    from cellsegmentation_tpu_torch.models import build_model
    from cellsegmentation_tpu_torch.models.milnet import settle_batch_stats
    from cellsegmentation_tpu_torch.ops.infer_engine import pick_calib_images
    from cellsegmentation_tpu_torch.ops.tiles import extract_tiles, tile_grid
    from cellsegmentation_tpu_torch.train import checkpoint as ckpt_mod
    from cellsegmentation_tpu_torch.train.schedules import make_schedule
    from cellsegmentation_tpu_torch.train.state import create_train_state
    from cellsegmentation_tpu_torch.train.steps import (
        make_image_infer_step,
        make_image_train_step,
        make_tile_infer_step,
    )
    from cellsegmentation_tpu_torch.train.trainers import (
        draw_pseudo_masks,
        train_stage1,
        train_stage2,
        train_stage3,
    )
    from cellsegmentation_tpu_torch.utils.logging import RunLogger

    t_phase = time.perf_counter()
    tq.reset_launch_counts()
    flip0 = np.zeros(args.image_batch, np.int32)
    train, val = _stage1_sources(args)
    b0, sweep_step = None, None
    for name in EFFNETS:
        model, step = _effnet_sweeps(args, card, src, name)
        print(f"[effnet] {name}'s stage-1 step:")
        _stage1_rate(model, train, args, card, "effnet")
        if name == EFFNETS[0]:
            b0, sweep_step = model, step
        else:
            del model, step
    with _se_range() as se:
        profile_rows("effnet", f"{EFFNETS[0]} q8 sweep step, {args.image_batch} images "
                      f"x 225 tiles", lambda: sweep_step(src.images[: args.image_batch], flip0),
                      split=se)
    del sweep_step

    # stage 1 on B0: the f32 gate, the step's profile, train_stage1 for one epoch
    _stage1_gate(args, train, EFFNETS[0], "effnet",
                 faults=("stochastic depth without 1/keep",
                         "stochastic depth on a non-residual block"))
    state = create_train_state(copy.deepcopy(b0), "image",
                               make_schedule(None, STAGE1_LR, 1, 1), device="cuda")
    step = make_image_train_step(state.model, seed=args.seed, device="cuda")
    batch = batch_of(train, np.arange(STAGE1_BATCH))
    with _se_range() as se:
        profile_rows("effnet", f"{EFFNETS[0]} stage-1 train step, batch {STAGE1_BATCH}",
                      lambda: step(state, batch), split=se)
    del state, step

    model = build_model(EFFNETS[0], device="cuda", seed=args.seed)
    with tempfile.TemporaryDirectory() as out:
        log = RunLogger(out, run_name="effnet", tensorboard=False)
        t0 = time.perf_counter()
        res1 = train_stage1(model, train, val, epochs=1, batch_size=STAGE1_BATCH,
                            lr=STAGE1_LR, seed=args.seed, encoder_name=EFFNETS[0],
                            output_dir=out, device="cuda", logger=log)
        s1 = time.perf_counter() - t0
        st = res1.epoch_stats[0]
        check(all(math.isfinite(st[k]) for k in ("loss_cls", "loss_reg", "loss")),
              f"train_stage1 losses {st}")
        pt1 = ckpt_mod.load_checkpoint(f"{out}/pt1_1epochs.ckpt")
        check(pt1["encoder"] == EFFNETS[0] and pt1["mode"] == "image", "pt1 payload")
        fresh = ckpt_mod.restore_into(build_model(EFFNETS[0], device="cuda", seed=1), pt1)
        for k, v in pt1["state_dict"].items():
            check(torch.equal(fresh.state_dict()[k].cpu(), v), f"pt1 entry {k}")
        vimgs, vflip = val.gather_images(np.arange(len(val))), val.flip_code
        want = make_image_infer_step(model, device="cuda")(vimgs, vflip)
        got = make_image_infer_step(fresh, device="cuda")(vimgs, vflip)
        check(all(torch.equal(a, b) for a, b in zip(want, got)), "pt1 counts differ")
        print(f"[effnet] train_stage1: 1 epoch of {st['steps']} steps (batch {STAGE1_BATCH}) "
              f"in {s1:.1f} s, loss {st['loss']:.6f}, validation {res1.last_metrics}; "
              f"pt1 ({len(pt1['state_dict'])} entries) reloads exactly, the same counts")

        # stage 2 from it, on the [slice] source's first images
        n2 = EFFNET_DRAW_BATCH
        tsrc = LystoDataSource.from_arrays(src.images[:n2], ["colon_0"] * n2,
                                           src.labels[:n2], kfold=None, augment=True)
        vsrc = LystoDataSource.from_arrays(src.images[n2:n2 + 8], ["colon_0"] * 8,
                                           src.labels[n2:n2 + 8], kfold=None)
        st2 = make_tile_infer_step(model, args.tile, _coords(args), engine="auto",
                                   calib_images=pick_calib_images(tsrc.images), device="cuda")
        check(st2.resolved_engine == "q8", f"stage-2 auto -> {st2.resolved_engine}")
        t0 = time.perf_counter()
        res2 = train_stage2(model, tsrc, vsrc, epochs=1, image_batch=args.image_batch,
                            tile_size=args.tile, interval=args.interval, lr=5e-5,
                            seed=args.seed, encoder_name=EFFNETS[0], output_dir=out,
                            infer_engine="auto", device="cuda", logger=log)
        s2 = time.perf_counter() - t0
        pt2 = ckpt_mod.load_checkpoint(f"{out}/pt2_1epochs.ckpt")
        check(pt2["encoder"] == EFFNETS[0] and pt2["mode"] == "tile", "pt2 payload")
        for k, v in pt1["state_dict"].items():
            check(torch.equal(pt2["state_dict"][k], v), f"stage 2 moved {k}")
        fresh = ckpt_mod.restore_into(build_model(EFFNETS[0], device="cuda", seed=1), pt2)
        for k, v in model.state_dict().items():
            check(torch.equal(fresh.state_dict()[k], v), f"pt2 entry {k}")
        print(f"[effnet] train_stage2: 1 epoch on {len(tsrc)} samples (auto -> q8) in "
              f"{s2:.1f} s, {res2.epoch_stats[0]}; validation {res2.last_metrics}; pt2 "
              f"reloads exactly, its encoder pt1's bit for bit")

        # the draw of one image batch at 16/5, then train_stage3's refusal
        dsrc = LystoDataSource.from_arrays(src.images[:EFFNET_DRAW_BATCH],
                                           ["colon_0"] * EFFNET_DRAW_BATCH,
                                           src.labels[:EFFNET_DRAW_BATCH], kfold=None)
        coords16 = tile_grid(args.hw, args.hw, STAGE3_TILE, STAGE3_INTERVAL)
        # five steps of stage 1 leave the running statistics near their init,
        # where the eval-mode tiles' log-odds are all one value: set them from
        # the draw's own 16-px tiles first, as for the sweeps
        x = extract_tiles(torch.as_tensor(dsrc.images[:EFFNET_SETTLE_IMAGES]).cuda(),
                          coords16, STAGE3_TILE).flatten(0, 1)
        settle_batch_stats(model, normalize_images(
            x, torch.zeros(len(x), dtype=torch.int32, device="cuda")))
        del x
        dstep = make_tile_infer_step(model, STAGE3_TILE, coords16, engine="auto",
                                     calib_images=pick_calib_images(dsrc.images),
                                     device="cuda")
        check(dstep.resolved_engine == "q8", f"draw auto -> {dstep.resolved_engine}")
        # as in [stage3]: the count head pinned at 5, the tile head's bias set
        # so that STAGE3_PASS_SHARE of the first two images' tiles pass
        with torch.no_grad():
            model.fc_image_reg[2].weight.zero_()
            model.fc_image_reg[2].bias.fill_(5.0)
            lo = logodds(dstep(dsrc.images[:2], np.zeros(2, np.int32)).cpu().numpy())
            model.fc_tile[1].bias[1] += float(
                math.log(STAGE3_THRESHOLD / (1 - STAGE3_THRESHOLD))
                - np.quantile(lo, 1 - STAGE3_PASS_SHARE))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        masks = draw_pseudo_masks(model, dsrc, tile_size=STAGE3_TILE,
                                  interval=STAGE3_INTERVAL, threshold=STAGE3_THRESHOLD,
                                  image_batch=EFFNET_DRAW_BATCH, logger=log,
                                  infer_tiles_fn=dstep, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(masks.shape == (EFFNET_DRAW_BATCH, args.hw, args.hw), f"masks {masks.shape}")
        print(f"[effnet] draw_pseudo_masks: {EFFNET_DRAW_BATCH} images x {len(coords16)} "
              f"tiles at 16/5 (auto -> q8; the first two images' log-odds std "
              f"{lo.std():.5f} before the bias) in {wall:.2f} s "
              f"({EFFNET_DRAW_BATCH / wall:.1f} images/s), {int(masks.any(axis=(1, 2)).sum())} "
              f"images with kept tiles")
        msrc = MaskDataSource.from_arrays(dsrc.images, masks)
        try:
            train_stage3(model, msrc, epochs=1, batch_size=4, output_dir=out,
                         device="cuda", logger=log)
        except NotImplementedError as exc:
            print(f"[effnet] train_stage3 refused: {exc}")
        else:
            check(False, "train_stage3 ran on an EfficientNet")
    launches = {fn.__name__: fn.launches for fn in tq.KERNELS}
    check(not any(launches.values()), f"the EfficientNet paths launched {launches}")
    print(f"[effnet] hand-written kernel launches over the phase: {launches}")
    print(f"[effnet] phase {time.perf_counter() - t_phase:.1f} s")


def _block_cv2_sklearn() -> None:
    """Make ``cv2`` and ``sklearn`` unimportable in this process, as on a
    machine without them: a ``None`` entry in ``sys.modules`` fails every
    later import and reads as absent to ``importlib.util.find_spec``."""
    for name in ("cv2", "sklearn"):
        check(sys.modules.get(name) is None, f"{name} was imported before [detect]")
        sys.modules[name] = None


def _cv2_sklearn_blocked() -> bool:
    return all(name in sys.modules and sys.modules[name] is None
               for name in ("cv2", "sklearn"))


def _roi_images(args):
    """DETECT_IMAGES uint8 ROI arrays of DETECT_HW px, each a mosaic of
    seeded synthetic 299^2 LYSTO images."""
    import numpy as np

    from cellsegmentation_tpu_torch.data import make_synthetic_arrays

    h, w = DETECT_HW
    ny, nx = -(-h // args.hw), -(-w // args.hw)
    a = make_synthetic_arrays(DETECT_IMAGES * ny * nx, args.hw, 30, seed=args.seed + 11)
    tiles = a["images"].reshape(DETECT_IMAGES, ny, nx, args.hw, args.hw, 3)
    return [np.concatenate(np.concatenate(t, axis=1), axis=1)[:h, :w] for t in tiles]


def _planted_masks(n_masks=3, h=600, w=900, n_cells=40, seed=5):
    """uint8 masks of sigma-5 Gaussian blobs at planted (row, col) centres
    at least 40 px apart, and the centres."""
    import numpy as np

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[-20:21, -20:21]
    blob = np.exp(-(yy ** 2 + xx ** 2) / (2 * 5.0 ** 2))
    out = []
    for _ in range(n_masks):
        pts = []
        while len(pts) < n_cells:
            p = rng.integers((20, 20), (h - 20, w - 20))
            if all(np.hypot(*(p - q)) >= 40 for q in pts):
                pts.append(p)
        m = np.zeros((h, w))
        for cy, cx in pts:
            win = m[cy - 20:cy + 21, cx - 20:cx + 21]
            np.maximum(win, blob, out=win)
        out.append(((255 * m).astype(np.uint8), np.asarray(pts)))
    return out


def phase_detect(args, card, ck):
    """test_seg --detect on the stage-3 model, with cv2 and sklearn
    unimportable: cell_detect over ROI arrays with and without the dot
    images (its CSV, the stitched mask PNGs and the counts against the
    steps' own outputs; no hand-written kernel), the seg probs of one patch
    batch card vs CPU, the host time of the localization by part, the
    device's busy share, the localization alone on planted cells, and
    test_seg's point evaluation."""
    import csv
    import os

    import numpy as np
    import torch

    _block_cv2_sklearn()

    from cellsegmentation_tpu_torch.cli import test_seg
    from cellsegmentation_tpu_torch.data import PointTestSource, make_synthetic_arrays
    from cellsegmentation_tpu_torch.data.masks import MaskTestSource
    from cellsegmentation_tpu_torch.detect import cell_detect, get_prf1, meanshift_cluster
    from cellsegmentation_tpu_torch.detect import cluster
    from cellsegmentation_tpu_torch.kernels import q8_gemm as tq
    from cellsegmentation_tpu_torch.models import build_model
    from cellsegmentation_tpu_torch.ops.tiles import tile_grid
    from cellsegmentation_tpu_torch.train import checkpoint as ckpt_mod
    from cellsegmentation_tpu_torch.train.steps import (
        make_image_infer_step,
        make_seg_infer_step,
    )
    from cellsegmentation_tpu_torch.utils.images import read_png

    t_phase = time.perf_counter()
    model = build_model("resnet50", device="cuda", seed=args.seed)
    ckpt_mod.restore_into(model, ck)
    rois = _roi_images(args)
    names = ["roi_1.png", "roi_2.png", "slide-1000.png", "roi_4.png"][:DETECT_IMAGES]
    src = MaskTestSource.from_arrays(rois, names)
    per = [sum(1 for fi, _, _ in src.patch_index if fi == i) for i in range(len(names))]
    grid = tile_grid(*DETECT_HW, src.patch_size, src.stride)
    check(per == [len(grid)] * DETECT_IMAGES, f"patches per image {per}, want {len(grid)}")
    seg, img = make_seg_infer_step(model, device="cuda"), make_image_infer_step(model,
                                                                               device="cuda")
    rec = {"masks": [], "counts": []}

    def seg_rec(x, f):
        out = seg(x, f)
        rec["masks"].append(out.cpu().numpy())
        return out

    def img_rec(x, f):
        probs, counts = img(x, f)
        rec["counts"].append(counts.cpu().numpy())
        return probs, counts

    ps = src.patch_size
    with tempfile.TemporaryDirectory() as out:
        walls = {}
        for output_image in (False, True):
            rec["masks"].clear()
            rec["counts"].clear()
            tq.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            path = cell_detect(src, seg_rec, img_rec, batch_size=DETECT_BATCH,
                               output_path=f"{out}/{output_image}",
                               output_image=output_image, device="cuda")
            walls[output_image] = time.perf_counter() - t0
            launches = {fn.__name__: fn.launches for fn in tq.KERNELS}
            check(not any(launches.values()), f"detection launched {launches}")
            masks = np.concatenate(rec["masks"])
            counts = np.round(np.concatenate(rec["counts"])).astype(int)
            check(len(masks) == len(src), f"{len(masks)} seg outputs for {len(src)} patches")
            with open(path) as f:
                rows = list(csv.reader(f))
            check(rows[0] == ["image_id", "x", "y"], f"CSV header {rows[0]}")
            det = os.path.dirname(path)
            stitched = [np.zeros(hw, np.uint8) for hw in src.image_sizes]
            image_count = [0] * len(names)
            for (fi, x, y), m, c in zip(src.patch_index, masks, counts):
                h, w = src.image_sizes[fi]
                stitched[fi][x:x + ps, y:y + ps] = np.uint8(255 * m)[:h - x, :w - y]
                image_count[fi] += c
            for fi, name in enumerate(names):
                stem = os.path.splitext(name)[0]
                base, off = ("slide", 1000) if stem == "slide-1000" else (stem, 0)
                mine = [r for r in rows[1:] if r[0] == base]
                check(np.array_equal(read_png(f"{det}/mask_{stem}.png"), stitched[fi]),
                      f"mask_{stem}.png is not the stitched mask")
                # the rows are the stitched mask's top-count centres, offset
                kept = meanshift_cluster(stitched[fi], "gaussianblur", image_count[fi])[0]
                check(mine == [[base, str(int(x) + off), str(int(y))] for x, y in kept],
                      f"{name}: {len(mine)} CSV rows are not the mask's {len(kept)} "
                      f"centres for count {image_count[fi]}")
                if output_image:
                    check(os.path.exists(f"{det}/{stem}_{image_count[fi]}cells.png"),
                          f"{stem}: no dot image for count {image_count[fi]}")
            check(len(rows) > 1 and {r[0] for r in rows[1:]} <= {"roi_1", "roi_2", "slide",
                                                                  "roi_4"}, "CSV rows")
            print(f"[detect] cell_detect (output_image={output_image}): {DETECT_IMAGES} "
                  f"images of {DETECT_HW[0]}x{DETECT_HW[1]} px, {len(src)} patches at batch "
                  f"{DETECT_BATCH} in {walls[output_image]:.2f} s "
                  f"({len(src) / walls[output_image]:.1f} patches/s); {len(rows) - 1} cells, "
                  f"counts {[int(c) for c in image_count]}; hand-written kernel launches "
                  f"{launches}")

        # the localization by part, per image, on the stitched masks
        parts = {"blur": 0.0, "seeds and mean-shift": 0.0, "DBSCAN and ranking": 0.0}
        for m in stitched:
            t0 = time.perf_counter()
            sm = cluster.smooth_mask(m, "gaussianblur")
            t1 = time.perf_counter()
            grid = tile_grid(*sm.shape, 16, 10)
            seeds = grid[sm[grid[:, 0] + 8, grid[:, 1] + 8] > 0.2 * 255]
            centers = cluster.vectorized_meanshift(sm, seeds, 16) if len(seeds) else seeds
            t2 = time.perf_counter()
            if len(centers):
                cluster.dbscan_labels(centers, 15)
            t3 = time.perf_counter()
            for k, dt in zip(parts, (t1 - t0, t2 - t1, t3 - t2)):
                parts[k] += dt / len(stitched)
        print(f"[detect] host seconds per image: " + ", ".join(
            f"{k} {v:.4f}" for k, v in parts.items()) + f" ({len(seeds)} seeds on the last)")

        # the device's busy share over one detection run
        from torch.profiler import ProfilerActivity, profile

        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            cell_detect(src, seg, img, batch_size=DETECT_BATCH, output_path=f"{out}/prof",
                        output_image=False, device="cuda")
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        busy = sum((getattr(e, "self_device_time_total", 0) or 0) for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA) / 1e6
        check(busy > 0, "the profiler recorded no device time")
        print(f"[detect] device busy {busy:.3f} s of a {wall:.2f} s profiled detection run "
              f"({100 * busy / wall:.1f}%)")

    # one patch batch's seg probs, card vs CPU (the same bf16 model)
    batch = np.stack([src.get_patch(i) for i in range(DETECT_BATCH)])
    flip = np.zeros(DETECT_BATCH, np.int32)
    cpu_model = build_model("resnet50", device="cpu", seed=args.seed)
    ckpt_mod.restore_into(cpu_model, ck)
    p_g = seg(batch, flip).cpu().numpy()
    t0 = time.perf_counter()
    p_c = make_seg_infer_step(cpu_model, device="cpu")(batch, flip).numpy()
    cpu_s = time.perf_counter() - t0
    d = np.abs(p_g - p_c)
    print(f"[detect] seg probs of {DETECT_BATCH} patches, card vs CPU ({cpu_s:.1f} s on the "
          f"CPU): max {d.max():.6f} mean {d.mean():.7f} (limits {DETECT_CARD_CPU_MAX} / "
          f"{DETECT_CARD_CPU_MEAN}); P(positive) {p_g.min():.4f}..{p_g.max():.4f}")
    check(d.max() <= DETECT_CARD_CPU_MAX and d.mean() <= DETECT_CARD_CPU_MEAN,
          f"seg probs card vs CPU max {d.max():.6f} mean {d.mean():.7f}")
    for name in DETECT_FAULT_BNS:
        bad = copy.deepcopy(cpu_model)
        bn = bad.seg_decoder.get_submodule(f"{name}.1")
        with torch.no_grad():
            bn.running_mean.zero_()
            bn.running_var.fill_(1.0)
        d = np.abs(p_g - make_seg_infer_step(bad, device="cpu")(batch, flip).numpy())
        passed = d.max() <= DETECT_CARD_CPU_MAX and d.mean() <= DETECT_CARD_CPU_MEAN
        print(f"[detect] planted fault '{name} BatchNorm on its initial statistics' "
              f"(CPU): max {d.max():.6f} mean {d.mean():.7f}: "
              f"{'passed' if passed else 'REJECTED'}")
        check(not passed, f"the seg-probs gate passed the planted fault in {name}")

    # the localization alone on planted cells
    worst, n_cells = 0.0, 0
    for mask, pts in _planted_masks():
        kept, _ = meanshift_cluster(mask, "gaussianblur", cell_count=len(pts))
        dist = np.hypot(*(pts[:, None, :] - kept[None, :, :]).transpose(2, 0, 1)).min(axis=1)
        worst, n_cells = max(worst, float(dist.max())), n_cells + len(pts)
        p, r, f1, tp, fp, fn = get_prf1(kept[:, ::-1], pts[:, ::-1])
        check(f1 == 1 and len(kept) == len(pts), f"planted cells: F1 {f1} ({tp}/{fp}/{fn})")
    check(worst <= PLANTED_TOL_PX, f"a planted centre found {worst:.2f} px off")
    print(f"[detect] localization on planted cells: {n_cells} of {n_cells} found, worst "
          f"{worst:.2f} px off (limit {PLANTED_TOL_PX}), F1 1.0; cv2 and sklearn "
          f"unimportable: {_cv2_sklearn_blocked()}")

    # test_seg's point evaluation
    a = make_synthetic_arrays(POINT_EVAL_IMAGES, args.hw, 30, seed=args.seed + 13)
    psrc = PointTestSource.from_arrays(
        [f"p_{i + 1}.png" for i in range(POINT_EVAL_IMAGES)], a["images"],
        [c[:, ::-1] for c in a["centers"]])
    with tempfile.TemporaryDirectory() as out:
        pargs = test_seg.build_parser().parse_args(["-m", "unused", "--reg_limit", "-o", out])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        test_seg.point_eval(pargs, model, psrc, "cuda")
        wall = time.perf_counter() - t0
        with open(f"{out}/center.csv") as f:
            rows = list(csv.reader(f))
    check(len(rows) == 1 + POINT_EVAL_IMAGES, f"center.csv rows {len(rows)}")
    print(f"[detect] test_seg point evaluation: {POINT_EVAL_IMAGES} images in {wall:.2f} s "
          f"({POINT_EVAL_IMAGES / wall:.1f} images/s) on {card}")
    check(_cv2_sklearn_blocked(), "cv2 or sklearn was imported during [detect]")
    print(f"[detect] phase {time.perf_counter() - t_phase:.1f} s")


def _ranks(v):
    import numpy as np

    return np.argsort(np.argsort(v, kind="stable"), kind="stable")


def phase_profile(step, images):
    """Device time by kernel over one sweep step."""
    import numpy as np

    flip = np.zeros(len(images), np.int32)
    rows, busy = profile_rows("profile", f"one flip-free step of {len(images)} images",
                               lambda: step(images, flip))
    # the hand-written kernels by name: the wgmma core's, 8 q8_matmul + 20
    # q8_matmul_px + 1 q8_conv3_tap launches a step, and no other
    by_name = {}
    for t, n, key in rows:
        hit = re.search(r"\bq8_\w+", key)
        if hit:
            name = hit.group(0)
            ms, count = by_name.get(name, (0.0, 0))
            by_name[name] = (ms + t, count + n)
    for name, (ms, n) in by_name.items():
        print(f"[profile] {name}: {n} launches, {ms:.3f} ms ({100 * ms / busy:.1f}% of busy)")
    check(list(by_name) == ["q8_wgmma_kernel"] and by_name["q8_wgmma_kernel"][1] == 29,
          f"profiled hand-written kernels {by_name}, want 29 q8_wgmma_kernel launches "
          f"and no other")


# ---------------------------------------------------------------------------
# [bench]: the benchmark's two cells at a short window, and their gates
# against planted faults (the benchmark itself plants none)
# ---------------------------------------------------------------------------

SWEEP_FAULTS = ("layer4.2's residual dropped", "flip codes ignored")
BENCH_EPOCHS = 2  # the stage-1 cell's timed epochs here


@contextlib.contextmanager
def planted_sweep_fault(fault):
    """``SWEEP_FAULTS[0]``: the last of each step's three layer-4 expands
    (``q8_matmul_px``, wt [2048, 512]) runs without its residual (yields
    None); ``SWEEP_FAULTS[1]``: the engine sweeps every image unflipped
    (yields the planted step wrapper)."""
    import itertools

    import numpy as np

    from cellsegmentation_tpu_torch.ops import q8_trunk

    if fault == SWEEP_FAULTS[1]:
        yield lambda step: (lambda images, flip: step(images, np.zeros_like(flip)))
        return
    orig = q8_trunk.q8_matmul_px
    seen = itertools.count()

    def planted(*args, **kw):
        if tuple(args[1].shape) == (2048, 512) and next(seen) % 3 == 2:
            kw = dict(kw, residual=None)
        return orig(*args, **kw)

    q8_trunk.q8_matmul_px = planted
    try:
        yield None
    finally:
        q8_trunk.q8_matmul_px = orig


def phase_bench(args, card):
    """The benchmark's cells through its own functions, each result line
    printed (one timed sweep, two timed stage-1 epochs; the
    host recorded, not controlled: this process runs every phase), then
    each cell's gates against planted faults, which they must reject."""
    import copy

    import numpy as np
    import torch

    from cellsegmentation_tpu_torch.bench import host

    t_phase = time.perf_counter()
    rec = host.control(apply=False)
    t0 = time.perf_counter()
    cell = bench_sweep.setup(args.seed)
    res = bench_sweep.measure(cell, 1, "bench", t0, rec)
    print(json.dumps(res))
    check(res["correct"], f"{bench_sweep.CELL}: gates {res['gates']}")
    for fault in SWEEP_FAULTS:
        per_batch = []
        with planted_sweep_fault(fault) as wrap:
            step = cell.step if wrap is None else wrap(cell.step)
            probs, _ = sweep_once(cell.src, bench_sweep.counted(step, per_batch))
        g = bench_sweep.sweep_gates(cell, probs, per_batch)
        bench_sweep.print_check("bench", f"planted fault ({fault})", g["reference"])
        print(f"[bench] planted fault ({fault}): launches {g['launches_ok']}, probs "
              f"{g['probs_ok']}: {'passes' if g['ok'] else 'rejected'}")
        check(not g["ok"], f"the sweep gates pass a planted fault: {fault}")
    del cell, probs
    torch.cuda.empty_cache()

    # stage 1 at a short window: its gate takes train_stage1's step on the
    # train state the last timed epoch leaves
    t0 = time.perf_counter()
    c1 = bench_stage1.setup(args.seed)
    res, start = bench_stage1.measure(c1, BENCH_EPOCHS, "bench", t0, rec)
    print(json.dumps(res))
    check(res["correct"], f"{bench_stage1.CELL}: gates {res['gates']}")
    want = bench_stage1.reference_reading(start, args.seed)
    restarted = copy.deepcopy(start.adam_state)
    for st in restarted["state"].values():
        st["step"] = torch.zeros_like(st["step"])
    unflipped = dict(start.batch, flip=np.zeros_like(start.batch["flip"]))
    planted = {  # fault: (Adam state, batch, planted in the model)
        "unbiased running variance": (None, None, "unbiased running variance"),
        "dropout scaled by keep": (None, None, "dropout scaled by keep"),
        "flipped images fed unflipped": (None, unflipped, None),
        "Adam's moments dropped": ({"state": {}, "param_groups":
                                    start.adam_state["param_groups"]}, None, None),
        "Adam's step count restarted": (restarted, None, None),
    }
    for fault, (adam_state, batch, name) in planted.items():
        plant = None if name is None else (lambda m, f=name: planted_stage1_fault(f, m))
        r = step_gap(bench_stage1.program_reading(start, adam_state, batch, plant), want)
        ok = within(r, bench_stage1.GATE_LIMITS)
        bench_stage1.print_gate("bench", f"planted fault ({fault})", r, ok)
        check(not ok, f"the stage-1 cell's gate passes a planted fault: {fault}")
    del c1, start
    torch.cuda.empty_cache()
    print(f"[bench] phase {time.perf_counter() - t_phase:.1f} s on {card}")


# ---------------------------------------------------------------------------
# [multiproc]: the port's parallel/ over torch.distributed, two ranks on the
# one card
# ---------------------------------------------------------------------------


def _mp_source(args):
    """The [slice] source's first MP_SAMPLES samples (base images 0-63,
    unflipped), sharing its 64-image stack."""
    import numpy as np

    from cellsegmentation_tpu_torch.data import LystoDataSource, make_synthetic_arrays
    from cellsegmentation_tpu_torch.data.lysto import SubsetSource

    arrays = make_synthetic_arrays(args.images, args.hw, 30, seed=args.seed)
    src = LystoDataSource.from_arrays(arrays["images"], arrays["organs"],
                                      arrays["counts"], kfold=None, augment=True)
    return src, SubsetSource(src, np.arange(MP_SAMPLES))


def _mp_sweep_step(args, sub, dev):
    """The stack step train_stage2 builds for ``sub`` (engine auto, the
    calibration images picked from its stack) on a seeded ResNet-50."""
    from cellsegmentation_tpu_torch.models import build_model
    from cellsegmentation_tpu_torch.ops.infer_engine import pick_calib_images
    from cellsegmentation_tpu_torch.train.steps import make_stack_tile_infer_step

    model = quiet_head(build_model("resnet50", device=dev, seed=args.seed))
    step = make_stack_tile_infer_step(model, args.tile, _coords(args), engine="auto",
                                      calib_images=pick_calib_images(sub.images),
                                      device=dev)
    check(step.resolved_engine == "q8dg", f"auto resolved to {step.resolved_engine}")
    return model, step


def _mp_timed_sweeps(args, step, images_dev, sub, image_batch, barrier=None):
    """(merged probs of the first of MP_SWEEPS split sweeps, each sweep's
    seconds, the first sweep's launches): every sweep starts together on
    every rank."""
    import torch

    from cellsegmentation_tpu_torch.kernels import q8_gemm as tq
    from cellsegmentation_tpu_torch.train.trainers import split_sweep

    secs, probs, launches = [], None, None
    for i in range(MP_SWEEPS):
        if barrier:
            barrier()
        torch.cuda.synchronize()
        tq.reset_launch_counts()
        t0 = time.perf_counter()
        out = split_sweep(step, images_dev, sub, len(_coords(args)), image_batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        if i == 0:
            probs, launches = out, {fn.__name__: fn.launches for fn in tq.KERNELS}
    return probs, secs, launches


@contextlib.contextmanager
def planted_mp_fault(fault, model):
    """A fault planted in the multi-process image step for its gate to
    reject: ``"local BatchNorm"`` (each rank normalizes by its own rows),
    ``"loss over the local count"`` or ``"gradients averaged over the
    ranks"`` (summed, then divided by the rank count)."""
    from cellsegmentation_tpu_torch.models.common import sync_batch_norm
    from cellsegmentation_tpu_torch.train import steps as tsteps

    real, real_grads = tsteps.global_count, tsteps.all_reduce_grads

    def averaged(mesh, params):
        real_grads(mesh, params)
        for p in params:
            if p.grad is not None:
                p.grad.div_(mesh.size)

    if fault == "local BatchNorm":
        sync_batch_norm(model, None)
    elif fault == "loss over the local count":
        tsteps.global_count = lambda mesh, valid: valid.detach().float().sum()
    elif fault == "gradients averaged over the ranks":
        tsteps.all_reduce_grads = averaged
    try:
        yield
    finally:
        tsteps.global_count, tsteps.all_reduce_grads = real, real_grads


def _mp_stage1_reading(args, src, dev, mesh, fault=None, reverse=False, solo=None):
    """One f32 stage-1 step (SGD, the generator's dropout) of a seeded
    ResNet-50 on this rank's rows of the global batch (the first
    MP_STAGE1_BATCH samples; every row with a ``mesh``): (global loss, every
    trainable gradient, the running statistics), f64 on the host. With
    ``reverse`` (one rank), the same step on the rows in reverse order,
    each row keeping its dropout masks: the same sums in another order.
    With ``solo``, a group of this rank alone, the 1-rank step with its
    BatchNorm through the multi-rank formula (models/common.py
    ``_global_batch_norm``) in place of cuDNN's."""
    import numpy as np
    import torch

    from cellsegmentation_tpu_torch.core.dtypes import F32_POLICY
    from cellsegmentation_tpu_torch.models import build_model
    from cellsegmentation_tpu_torch.parallel.sharding import global_rows
    from cellsegmentation_tpu_torch.train.schedules import make_schedule
    from cellsegmentation_tpu_torch.train.state import create_train_state
    from cellsegmentation_tpu_torch.models.common import sync_batch_norm
    from cellsegmentation_tpu_torch.models.milnet import IMAGE_HEADS
    from cellsegmentation_tpu_torch.parallel.mesh import Mesh
    from cellsegmentation_tpu_torch.train.steps import dropout_generator, make_image_train_step

    model = build_model("resnet50", policy=F32_POLICY, device=dev, seed=args.seed)
    per = MP_STAGE1_BATCH // (mesh.size if mesh else 1)
    _, rows = global_rows(mesh, per)
    batch = batch_of(src, np.arange(MP_STAGE1_BATCH)[rows])
    masks = None
    if reverse:
        batch = {k: v[::-1].copy() for k, v in batch.items()}
        gen = dropout_generator(args.seed, 0, dev)
        masks = {k: tuple(m.flip(0) for m in getattr(model, k).draw_masks(
            MP_STAGE1_BATCH, gen, dev)) for k in IMAGE_HEADS}
    state = create_train_state(model, "image", make_schedule(None, S1_CHECK_LR, 1, 1),
                               use_sgd=True, device=dev)
    step = make_image_train_step(model, seed=args.seed, device=dev, mesh=mesh)
    if solo is not None:
        sync_batch_norm(model, Mesh(group=solo))
    with planted_mp_fault(fault, model):
        _, metrics = step(state, batch, dropout_masks=masks)
    params = [p for g in state.optimizer.param_groups for p in g["params"]]
    grads = torch.cat([p.grad.detach().double().cpu().flatten() for p in params])
    stats = {k: v.detach().double().cpu() for k, v in model.state_dict().items()
             if "running_" in k}
    return float(metrics["loss"]), grads, stats


def mp_stage1_gap(got, want):
    """(loss rel, gradient cosine, gradient norm ratio's gap from 1,
    statistic gap, within the MP_* limits) of a 2-rank stage-1 reading
    against the 1-rank one."""
    r = step_gap(got, want)
    ok = within(r, {"loss_rel": MP_LOSS_RTOL, "grad_cos": MP_GRAD_MIN_COS,
                    "grad_norm": MP_GRAD_NORM_RTOL, "stat": MP_STAT_RTOL})
    return r["loss_rel"], r["grad_cos"], r["grad_norm"], r["stat"], ok


def mp_worker(args) -> int:
    """One rank of [multiproc] (``--mp-rank``): joins the group through
    ``maybe_initialize`` (CST_* variables from the parent), then the split
    sweep (timed), a 1-epoch train_stage2 and the stage-1 step with its
    planted faults; writes its readings to ``<mp-out>/rank<r>.json`` (rank 0
    also the merged probs)."""
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist

    from cellsegmentation_tpu_torch.parallel.mesh import make_mesh
    from cellsegmentation_tpu_torch.parallel.multihost import maybe_initialize
    from cellsegmentation_tpu_torch.train.trainers import train_stage2
    from cellsegmentation_tpu_torch.utils.logging import RunLogger

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    backend = maybe_initialize(timeout=datetime.timedelta(seconds=MP_TIMEOUT_S))
    rank, dev = dist.get_rank(), torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    mesh = make_mesh()
    res = {"rank": rank, "backend": backend, "mesh": mesh.size}
    src, sub = _mp_source(args)
    model, step = _mp_sweep_step(args, sub, dev)
    images_dev = torch.as_tensor(sub.images).to(dev)
    step(images_dev, np.arange(args.image_batch // 2), np.zeros(args.image_batch // 2, np.int32))
    probs, secs, launches = _mp_timed_sweeps(args, step, images_dev, sub, args.image_batch,
                                             dist.barrier)
    res.update(sweep_s=secs, launches=launches)
    if rank == 0:
        np.save(os.path.join(args.mp_out, "probs.npy"), probs)

    from cellsegmentation_tpu_torch.kernels import q8_gemm as tq

    tq.reset_launch_counts()
    t0 = time.perf_counter()
    r = train_stage2(model, sub, None, epochs=1, image_batch=args.image_batch,
                     tile_size=args.tile, interval=args.interval, infer_engine="auto",
                     record_selection=True, device=dev,
                     logger=RunLogger(os.path.join(args.mp_out, f"log{rank}"),
                                      tensorboard=False))
    res["train_stage2"] = {
        "s": time.perf_counter() - t0, "loss": r.epoch_stats[0]["loss"],
        "tiles": r.epoch_stats[0]["train_tiles"],
        "launches": {fn.__name__: fn.launches for fn in tq.KERNELS},
        "selection": {k: v.tolist() for k, v in r.selections[0].items()},
        "fc_tile": [t.detach().cpu().tolist() for t in model.fc_tile.parameters()]}
    del model, step

    want = _mp_stage1_reading(args, src, dev, None) if rank == 0 else None
    solo = dist.new_group([0])  # every rank takes part in making a group
    if rank == 0:
        res["stage1 rows reversed"] = mp_stage1_gap(
            _mp_stage1_reading(args, src, dev, None, reverse=True), want)
        res["stage1 formula"] = mp_stage1_gap(
            _mp_stage1_reading(args, src, dev, None, solo=solo), want)
    for fault in (None, *MP_FAULTS):
        got = _mp_stage1_reading(args, src, dev, mesh, fault)
        if rank == 0:
            res[f"stage1 {fault or 'clean'}"] = mp_stage1_gap(got, want)
    with open(os.path.join(args.mp_out, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()
    return 0


def _mp_spawn(args, out_dir, port):
    """The MP_RANKS worker processes of this script, output to files."""
    procs = []
    for rank in range(MP_RANKS):
        env = dict(os.environ, CST_COORDINATOR_ADDRESS=f"localhost:{port}",
                   CST_NUM_PROCESSES=str(MP_RANKS), CST_PROCESS_ID=str(rank))
        log = open(os.path.join(out_dir, f"worker{rank}.log"), "w")
        cmd = [sys.executable, os.path.abspath(__file__), "--mp-rank", str(rank),
               "--mp-out", out_dir, "--images", str(args.images),
               "--image-batch", str(args.image_batch), "--seed", str(args.seed)]
        procs.append((subprocess.Popen(cmd, env=env, stdout=log,
                                       stderr=subprocess.STDOUT), log))
    return procs


def _mp_wait(procs, out_dir):
    """Wait for every worker; the first to fail, or MP_TIMEOUT_S passing,
    kills the others (a rank left alone would wait at its next collective).
    Any worker's failure fails the phase, its log's tail in the message."""
    deadline = time.monotonic() + MP_TIMEOUT_S
    try:
        while (any(p.poll() is None for p, _ in procs)
               and all(p.poll() in (None, 0) for p, _ in procs)
               and time.monotonic() < deadline):
            time.sleep(0.5)
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    # the rank that failed by itself first, then any the phase killed
    for rank, (p, _) in sorted(enumerate(procs), key=lambda rp: rp[1][0].returncode < 0):
        if p.returncode != 0:
            with open(os.path.join(out_dir, f"worker{rank}.log")) as f:
                tail = f.read()[-3000:]
            raise PhaseError(f"rank {rank} exited {p.returncode}:\n{tail}")


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _nccl_probe():
    """One world-size-1 group through maybe_initialize on the card: NCCL
    (every rank owns its card), one all-reduce, then torn down."""
    import torch
    import torch.distributed as dist

    from cellsegmentation_tpu_torch.parallel.multihost import maybe_initialize

    env = {"CST_COORDINATOR_ADDRESS": f"localhost:{_free_port()}",
           "CST_NUM_PROCESSES": "1", "CST_PROCESS_ID": "0"}
    os.environ.update(env)
    try:
        backend = maybe_initialize()
        t = torch.full((4,), 3.0, device="cuda")
        dist.all_reduce(t)
        torch.cuda.synchronize()
        check(backend == "nccl" and dist.get_backend() == "nccl",
              f"world size 1 on the card chose {backend}, want nccl")
        check(bool((t == 3.0).all()), f"world-1 all-reduce gave {t.tolist()}")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k in env:
            os.environ.pop(k, None)
    return backend


def phase_multiproc(args, card):
    """[multiproc]: two ranks share the card over gloo (NCCL refuses two
    ranks on one GPU): the split sweep (q8dg, auto) of train_stage2 on the
    [slice] source's first 64 samples, a 1-epoch train_stage2, one stage-1
    step at global batch MP_STAGE1_BATCH with its planted faults; held
    against this process's 1-process runs."""
    import numpy as np
    import torch

    t_phase = time.perf_counter()
    backend = _nccl_probe()
    print(f"[multiproc] world size 1 through maybe_initialize: backend {backend}")
    out_dir = tempfile.mkdtemp(prefix="cst_mp_")
    _mp_wait(_mp_spawn(args, out_dir, _free_port()), out_dir)
    res = [json.load(open(os.path.join(out_dir, f"rank{r}.json"))) for r in range(MP_RANKS)]
    merged = np.load(os.path.join(out_dir, "probs.npy"))
    for r in res:
        check(r["backend"] == "gloo", f"rank {r['rank']}: backend {r['backend']}")
    print(f"[multiproc] {MP_RANKS} ranks on {card}: backend {res[0]['backend']} "
          f"(ranks share the card), mesh over {res[0]['mesh']} ranks")
    n_calls = math.ceil(MP_SAMPLES / args.image_batch)  # local calls per rank
    for r in res:
        print(f"[multiproc] rank {r['rank']} launches, split sweep of {MP_SAMPLES} "
              f"samples ({n_calls} calls of {args.image_batch // MP_RANKS} images): "
              f"{r['launches']}; train_stage2 epoch: {r['train_stage2']['launches']}")
        for name, per in (("q8_conv3_tap", 1), ("q8_matmul", 8), ("q8_matmul_px", 20)):
            check(r["launches"][name] == per * n_calls > 0,
                  f"rank {r['rank']}: {name} launched {r['launches'][name]}, "
                  f"want {per} x {n_calls}")
            check(r["train_stage2"]["launches"][name] >= per * n_calls,
                  f"rank {r['rank']}: train_stage2 launched {name} "
                  f"{r['train_stage2']['launches'][name]} times")

    # 1-process references in this process, same seeds and calibration
    src, sub = _mp_source(args)
    model, step = _mp_sweep_step(args, sub, "cuda")
    images_dev = torch.as_tensor(sub.images).cuda()
    step(images_dev, np.arange(args.image_batch // 2), np.zeros(args.image_batch // 2, np.int32))
    half, _, _ = _mp_timed_sweeps(args, step, images_dev, sub, args.image_batch // MP_RANKS)
    full, secs, _ = _mp_timed_sweeps(args, step, images_dev, sub, args.image_batch)
    check(merged.shape == (MP_SAMPLES, len(_coords(args))) and bool(np.isfinite(merged).all()),
          f"merged probs {merged.shape}")
    same = bool(np.array_equal(merged, half))
    print(f"[multiproc] merged 2-rank sweep vs a 1-process sweep at the per-rank "
          f"batch {args.image_batch // MP_RANKS}: bit-equal {same} (max |diff| "
          f"{float(np.abs(merged - half).max()):.3g})")
    check(same, "the merged 2-rank sweep differs from the per-rank-batch sweep")
    mx, mean, rank, ok = _gate(logodds(merged), logodds(full))
    print(f"[multiproc] merged vs the 1-process sweep at batch {args.image_batch}, "
          f"log-odds: max {mx:.5f} mean {mean:.6f} (limits {CARD_CPU_MAX} / "
          f"{CARD_CPU_MEAN}), min rank corr {min(rank):.4f}")
    check(ok, f"merged vs full-batch sweep: max {mx:.5f} mean {mean:.6f}")
    ips2 = MP_SAMPLES / float(np.median(res[0]["sweep_s"]))
    ips1 = MP_SAMPLES / float(np.median(secs))
    print(f"[multiproc] sweep images/s (median of {MP_SWEEPS}): 2 ranks time-slicing "
          f"the card {ips2:.1f} (rank seconds {[round(s, 4) for s in res[0]['sweep_s']]}) "
          f"vs 1 process at batch {args.image_batch} {ips1:.1f} ({ips2 / ips1:.3f}x)")

    s2 = [r["train_stage2"] for r in res]
    check(s2[0]["selection"] == s2[1]["selection"], "the ranks selected other tiles")
    check(s2[0]["fc_tile"] == s2[1]["fc_tile"], "fc_tile differs between the ranks")
    check(np.isfinite(s2[0]["loss"]), f"train_stage2 loss {s2[0]['loss']}")
    print(f"[multiproc] train_stage2, 1 epoch over {MP_RANKS} ranks: "
          f"{s2[0]['tiles']} tiles, loss {s2[0]['loss']:.5f}, {s2[0]['s']:.1f} s; "
          "selections and fc_tile bit-identical across ranks")

    for name, what in (("rows reversed", "its rows reversed (the same sums in another "
                                         "order)"),
                       ("formula", "its BatchNorm through the multi-rank formula "
                                   "(one rank's group)")):
        rel, cos, norm, stat, _ = res[0][f"stage1 {name}"]
        print(f"[multiproc] floor: the 1-rank step with {what} vs the 1-rank step: "
              f"loss rel {rel:.3g}, grad cos {cos:.9f}, grad norm gap {norm:.3g}, "
              f"stats gap {stat:.3g}")
    rel, cos, norm, stat, ok = res[0]["stage1 clean"]
    print(f"[multiproc] stage-1 step, {MP_RANKS} ranks x {MP_STAGE1_BATCH // MP_RANKS} "
          f"vs 1 rank x {MP_STAGE1_BATCH} (f32): loss rel {rel:.3g}, grad cos "
          f"{cos:.9f}, grad norm gap {norm:.3g}, stats gap {stat:.3g} (limits "
          f"{MP_LOSS_RTOL} / {MP_GRAD_MIN_COS} / {MP_GRAD_NORM_RTOL} / {MP_STAT_RTOL})")
    check(ok, "the 2-rank stage-1 step differs from the 1-rank step")
    for fault in MP_FAULTS:
        rel, cos, norm, stat, ok = res[0][f"stage1 {fault}"]
        print(f"[multiproc] planted fault '{fault}': loss rel {rel:.3g}, grad cos "
              f"{cos:.6f}, grad norm gap {norm:.3g}, stats gap {stat:.3g}: "
              f"{'REJECTED' if not ok else 'passed'}")
        check(not ok, f"the stage-1 gate passed the planted fault '{fault}'")
    del model, step, images_dev
    torch.cuda.empty_cache()
    print(f"[multiproc] {time.perf_counter() - t_phase:.1f} s")


def _coords(args):
    from cellsegmentation_tpu_torch.ops.tiles import tile_grid

    return tile_grid(args.hw, args.hw, args.tile, args.interval)


def _kernel_row(fn, s, launches, path=None, **extra):
    """One kernel's entry of the JSON line from its measured ``s``
    (``measure_calls``) and its launches on the path it names."""
    row = {"name": fn.__name__}
    if path is not None:
        row["path"] = path
    row.update({
        "route": "cuda", "source": SOURCES[fn.__name__], "replaces": REPLACES[fn.__name__],
        "launches": launches, "max_abs_err": s["err"], "ms": s["ms"],
        "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
        "bound_by": "bytes" if s["bytes_ms"] > s["ops_ms"] else "operations",
        "library_ms": s["lib_ms"], "warm_ms": s["warm_ms"], **extra,
    })
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--images", type=int, default=64,
                    help="base images; the augmented source holds 4x as many")
    ap.add_argument("--image-batch", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--val-images", type=int, default=16,
                    help="base images of the [train] phase's validation source")
    ap.add_argument("--epochs", type=int, default=2, help="[train] epochs")
    # one rank of [multiproc], spawned by the phase itself
    ap.add_argument("--mp-rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--mp-out", type=str, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    args.hw, args.tile, args.interval = 299, 32, 20

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    if args.mp_rank is not None:
        return mp_worker(args)

    from cellsegmentation_tpu_torch.data import LystoDataSource, make_synthetic_arrays
    from cellsegmentation_tpu_torch.kernels import q8_gemm as tq
    from cellsegmentation_tpu_torch.models import build_model
    from cellsegmentation_tpu_torch.ops.infer_engine import pick_calib_images
    from cellsegmentation_tpu_torch.train.steps import make_tile_infer_step

    t_start = time.perf_counter()
    phase = "device"
    try:
        card = phase_device()
        phase = "build"
        phase_build()

        phase = "setup"
        arrays = make_synthetic_arrays(args.images, args.hw, 30, seed=args.seed)
        src = LystoDataSource.from_arrays(
            arrays["images"], arrays["organs"], arrays["counts"], kfold=None,
            augment=True,
        )
        model = quiet_head(build_model("resnet50", device="cuda", seed=args.seed))
        base = copy.deepcopy(model)  # the [train] phase's initial weights
        t0 = time.perf_counter()
        step = make_tile_infer_step(
            model, args.tile, _coords(args), engine="auto",
            calib_images=pick_calib_images(src.images), device="cuda",
        )
        check(step.resolved_engine == "q8dg",
              f"engine auto resolved to {step.resolved_engine}, want q8dg")
        print(f"[setup] engine build (fold, calibrate, pack) "
              f"{time.perf_counter() - t0:.1f} s; {len(src)} samples")
        step_row = make_tile_infer_step(
            model, args.tile, _coords(args), engine="auto", device="cuda",
            scales=step.engine.scales, w2_impl="rowtap",
        )
        # the other engines on the same calibration (the same pilot tiles)
        serve = {"q8dg": step}
        for engine in ("q8g", "q8d"):
            serve[engine] = make_tile_infer_step(
                model, args.tile, _coords(args), engine=engine, device="cuda",
                scales=step.engine.scales)
        q8g_row = make_tile_infer_step(model, args.tile, _coords(args), engine="q8g",
                                       device="cuda", scales=step.engine.scales,
                                       w2_impl="rowtap")

        phase = "kernels"
        batch = torch.as_tensor(src.images[: args.image_batch]).cuda()
        calls = capture_calls(lambda: step.engine(batch, None))
        entry = calls[0][1][0]  # layer3 block0's reduce reads the int8 entry
        calls += [c for c in capture_calls(lambda: step_row.engine(batch, None))
                  if c[0] is tq.q8_conv3_rowtap]
        stats = phase_kernels(calls)

        phase = "kernels-q8g"
        flip0 = np.zeros(args.image_batch, np.int32)
        stats_q8g = phase_kernels_q8g(capture_calls(lambda: serve["q8g"](batch, flip0)),
                                      capture_calls(lambda: q8g_row(batch, flip0)))
        del q8g_row

        phase = "seam"
        phase_seam(step, step_row, entry)

        phase = "slice"
        launches, probs_auto, auto_ips, slice_gap, ref = phase_slice(args, card, model,
                                                                     step, src)

        phase = "rowtap"
        row_launches = phase_rowtap(args, card, step, step_row, src, probs_auto,
                                    auto_ips)

        phase = "variants"
        stats_var, launches_var = phase_variants(args, card, model, step, src, ref)

        phase = "train"
        phase_train(args, card, base, src)

        phase = "stage1"
        s1_model, s1_state, s1_train = phase_stage1(args, card, src, slice_gap)

        phase = "jaxckpt"
        launches_jax = phase_jaxckpt(args, card, s1_model, s1_state, s1_train, src)
        del s1_model, s1_state, s1_train

        phase = "alternative"
        phase_alternative(args, card)

        phase = "stage3"
        pt3 = phase_stage3(args, card)

        phase = "serve"
        launches_q8g = phase_serve(args, card, model, serve, src, ref)
        del ref

        phase = "detect"
        phase_detect(args, card, pt3)

        phase = "kernels-resnext"
        rx = phase_kernels_resnext(args, card, src)

        phase = "resnext"
        # ResNeXt-50's q8g launches from the counted sweep (rowtap: the
        # rowtap form's counted step in [kernels-resnext])
        rx[RESNEXTS[0]]["launches"].update(phase_resnext(args, card, src),
                                           q8_conv3_rowtap=rx[RESNEXTS[0]]["launches"][
                                               "q8_conv3_rowtap"])

        phase = "ensemble"
        phase_ensemble(args, card)

        phase = "effnet"
        phase_effnet(args, card, src)

        phase = "multiproc"
        phase_multiproc(args, card)

        phase = "bench"
        phase_bench(args, card)

        phase = "profile"
        phase_profile(step, src.images[: args.image_batch])
    except Exception as exc:  # report the phase, exit non-zero, no result
        print(f"chip_smoke: phase {phase} failed: {type(exc).__name__}: {exc}",
              file=sys.stderr)
        import traceback

        traceback.print_exc()
        return 1

    # launches on the path that runs each kernel: the counted auto sweep,
    # and the counted rowtap sweep for the row-Toeplitz kernel
    launches["q8_conv3_rowtap"] = row_launches["q8_conv3_rowtap"]
    threes = (tq.q8_conv3_tap, tq.q8_conv3_rowtap)
    kernels = [_kernel_row(fn, stats[fn], launches[fn.__name__],
                           cudnn_ms=stats[fn]["cudnn_ms"] if fn in threes else None)
               for fn in tq.KERNELS]
    # the q8g path: its counted sweep in [serve], every call of its step in
    # [kernels-q8g]
    kernels += [_kernel_row(fn, stats_q8g[fn], launches_q8g[fn.__name__], path="q8g",
                            cudnn_ms=stats_q8g[fn]["cudnn_ms"] if fn is tq.q8_conv3_tap
                            else None)
                for fn in tq.KERNELS if launches_q8g[fn.__name__]]
    # the JAX-format pt2's counted sweep in [jaxckpt]: q8dg at (2, 0), the
    # calls of [kernels]
    kernels += [_kernel_row(fn, stats[fn], launches_jax[fn.__name__], path="jaxckpt pt2",
                            cudnn_ms=stats[fn]["cudnn_ms"] if fn in threes else None)
                for fn in tq.KERNELS if launches_jax[fn.__name__]]
    # q8dg's (1, 0) and (1, 1) splits: their counted sweeps and the calls of
    # one step each in [variants]
    for name in ("1,0", "1,1"):
        kernels += [_kernel_row(fn, stats_var[name][fn], launches_var[name][fn.__name__],
                                path=f"q8dg {name}",
                                cudnn_ms=stats_var[name][fn]["cudnn_ms"]
                                if fn is tq.q8_conv3_tap else None)
                    for fn in tq.KERNELS if launches_var[name][fn.__name__]]
    # each ResNeXt's q8g: ResNeXt-50's counted sweep in [resnext], the 101's
    # counted step in [kernels-resnext] (rowtap: the rowtap form's counted
    # step there); the 3x3s' grouped bound and cuDNN's bf16 grouped conv
    # beside the expanded product's
    for name in RESNEXTS:
        for fn in tq.KERNELS:
            s, g = rx[name]["stats"][fn], rx[name]["grouped"][fn]
            if not rx[name]["launches"][fn.__name__]:
                continue
            three = fn is not tq.q8_matmul_px
            row = fn is tq.q8_conv3_rowtap
            kernels.append(_kernel_row(
                fn, s, rx[name]["launches"][fn.__name__],
                path=f"{name} q8g{' rowtap' if row else ''}",
                cudnn_ms=s["cudnn_ms"] if fn is tq.q8_conv3_tap else None,
                grouped_bound_ms=g["grouped_bound_ms"] if three else None,
                cudnn_grouped_ms=g["cudnn_ms"] if three else None))
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
