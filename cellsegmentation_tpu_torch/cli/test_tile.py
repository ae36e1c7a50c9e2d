"""Stage-2 evaluation CLI: per-tile heatmaps over ``test.h5``, the JAX
package's ``test_tile`` flags and outputs.

Dense tile inference, the threshold filter, optional ``--reg_limit``
artifact clearing (the tiles of images whose predicted count is 0 are
dropped; the counts go to ``<time>-count-e<epoch>.csv``), then JET heatmap
overlays ``test_<n:05>.png`` and the per-tile CSV
``<time>-pred-e<epoch>-p<tile>-i<interval>-c<threshold>.csv``.

Usage:
    python -m cellsegmentation_tpu_torch.cli.test_tile -m output/pt2_30epochs.ckpt \
        -t 32 -i 5 -c 0.95 [--reg_limit] [--infer_engine q8g]
"""

from __future__ import annotations

import argparse
import csv
import os
import time

import numpy as np

from cellsegmentation_tpu_torch.cli import common
from cellsegmentation_tpu_torch.data.lysto import LystoTestSource
from cellsegmentation_tpu_torch.infer import inference_image, inference_tiles
from cellsegmentation_tpu_torch.models.milnet import (
    ENCODER_KEY,
    IMAGE_CLS_KEY,
    IMAGE_REG_KEY,
    TILE_KEY,
)
from cellsegmentation_tpu_torch.ops.infer_engine import pick_calib_images
from cellsegmentation_tpu_torch.ops.tiles import tile_grid
from cellsegmentation_tpu_torch.postprocess.masks import heatmap
from cellsegmentation_tpu_torch.train.steps import (
    make_image_infer_step,
    make_tile_infer_step,
)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="pt.2 evaluation: tile heatmaps")
    parser.add_argument("-m", "--model", type=str, required=True)
    parser.add_argument("-B", "--batch_size", type=int, default=128,
                        help="image batch for dense tile inference")
    parser.add_argument("-t", "--tile_size", type=int, default=32)
    parser.add_argument("-i", "--interval", type=int, default=5)
    parser.add_argument("-c", "--threshold", type=float, default=0.95)
    parser.add_argument("--reg_limit", action="store_true")
    parser.add_argument("--infer_engine",
                        choices=("auto", "q8", "q8g", "q8d", "q8dg", "flax"),
                        default="flax",
                        help="dense-sweep engine; evaluation defaults to the "
                             "exact flax graph so that tile metrics carry no "
                             "quantization error (serving engines opt in)")
    parser.add_argument("-o", "--output", type=str, default="./output")
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--data_path", type=str, default=None)
    parser.add_argument("--f32", action="store_true")
    common.add_device_arg(parser)
    parser.add_argument("-w", "--workers", type=int, default=4)
    return parser


def evaluate_tiles(model, source, args, epoch, device) -> dict:
    """The CLI's work on a built model and source: the tile sweep with
    ``args.infer_engine``, the threshold, ``--reg_limit`` with its count CSV,
    the heatmaps and the prediction CSV under ``args.output``. Returns the
    resolved engine, the [N, T] probs and the kept tiles."""
    now = time.strftime("%Y%m%d-%H%M%S")
    h, w = source.image_hw
    coords = tile_grid(h, w, args.tile_size, args.interval)
    calib = (pick_calib_images(source.images)
             if args.infer_engine != "flax" else None)
    tile_infer = make_tile_infer_step(model, args.tile_size, coords,
                                      engine=args.infer_engine,
                                      calib_images=calib, device=device)
    probs = inference_tiles(source, tile_infer, args.tile_size, args.interval,
                            image_batch=args.batch_size)
    keep = probs > args.threshold

    if args.reg_limit:
        image_infer = make_image_infer_step(model, device=device)
        _, counts = inference_image(source, image_infer, batch_size=args.batch_size)
        with open(os.path.join(args.output, f"{now}-count-e{epoch}.csv"), "w",
                  newline="") as f:
            cw = csv.writer(f)
            cw.writerow(["id", "count", "organ"])
            for i, y in enumerate(counts, start=1):
                cw.writerow([i, y, source.organs[i - 1]])
        keep &= (counts != 0)[:, None]

    groups, tile_idx = np.nonzero(keep)
    tiles_xy = coords[tile_idx]
    tile_probs = probs[groups, tile_idx]
    csv_path = os.path.join(
        args.output, f"{now}-pred-e{epoch}-p{args.tile_size}-i{args.interval}"
                     f"-c{args.threshold}.csv")
    with open(csv_path, "w", newline="") as f:
        cw = csv.writer(f)
        cw.writerow(["tile_size", args.tile_size])
        cw.writerow(["interval", args.interval])
        cw.writerow(["idx", "grid", "prob"])
        for i, g in enumerate(groups):
            cw.writerow([g, f"[{tiles_xy[i, 0]}, {tiles_xy[i, 1]}]", tile_probs[i]])
    heatmap(source.images, groups, tiles_xy, tile_probs, args.tile_size,
            args.output)
    return {"resolved_engine": tile_infer.resolved_engine, "probs": probs,
            "groups": groups, "tiles_xy": tiles_xy, "csv": csv_path}


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    dev = common.device_of(args)
    h5 = os.path.join(common.resolve_data_path(args), "test.h5")
    os.makedirs(args.output, exist_ok=True)
    source = LystoTestSource(h5, num_of_imgs=20 if args.debug else 0)
    model, ckpt = common.load_stage_checkpoint(
        args.model, args,
        partitions=(ENCODER_KEY, TILE_KEY, IMAGE_CLS_KEY, IMAGE_REG_KEY))
    evaluate_tiles(model, source, args, ckpt["epoch"], dev)
    print(f"Test results saved in '{args.output}'.")


if __name__ == "__main__":
    main()
