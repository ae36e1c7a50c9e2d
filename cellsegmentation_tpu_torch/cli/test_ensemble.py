"""Ensemble evaluation CLI, the JAX package's ``test_ensemble`` flags and
outputs: every ``*_<epoch>epochs.ckpt`` of a directory, in sorted order,
counts ``test.h5``; the mean of the models' rounded counts, rounded, goes
to ``<time>-count-e<epoch>.csv`` (id, count, organ).

Usage:
    python -m cellsegmentation_tpu_torch.cli.test_ensemble -m ./output -e 30
"""

from __future__ import annotations

import argparse
import csv
import glob
import os
import time

import numpy as np

from cellsegmentation_tpu_torch.cli import common
from cellsegmentation_tpu_torch.data.lysto import LystoTestSource
from cellsegmentation_tpu_torch.infer import inference_image
from cellsegmentation_tpu_torch.models import build_model
from cellsegmentation_tpu_torch.train.checkpoint import (
    STAGE_SAVE_PARTITIONS,
    load_checkpoint,
    restore_into,
)
from cellsegmentation_tpu_torch.train.steps import make_image_infer_step


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="pt.1 ensemble evaluation")
    parser.add_argument("-m", "--model", type=str, required=True,
                        help="directory of fold checkpoints")
    parser.add_argument("-e", "--epoch", type=int, default=30,
                        help="epoch tag of the checkpoints to load")
    parser.add_argument("-B", "--batch_size", type=int, default=128)
    parser.add_argument("--cls_limit", action="store_true")
    parser.add_argument("-o", "--output", type=str, default="./output")
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--data_path", type=str, default=None)
    parser.add_argument("--f32", action="store_true")
    common.add_device_arg(parser)
    parser.add_argument("-w", "--workers", type=int, default=4)
    return parser


def ensemble_paths(model_dir: str, epoch: int) -> list:
    """The directory's ``*_<epoch>epochs.ckpt`` files, sorted."""
    return sorted(glob.glob(os.path.join(model_dir, f"*_{epoch}epochs.ckpt")))


def ensemble_counts(paths, source, args, device) -> np.ndarray:
    """The CLI's averaging on a built ``LystoTestSource``: each checkpoint's
    rounded counts through ``inference_image`` on ``device``, then the
    mean over the models, rounded: int [N]."""
    outputs = []
    for i, path in enumerate(paths):
        print(f"Testing {i + 1}/{len(paths)}...")
        ckpt = load_checkpoint(path)
        model = build_model(ckpt["encoder"], policy=common.policy_of(args), device=device)
        restore_into(model, ckpt, STAGE_SAVE_PARTITIONS["image"])
        step = make_image_infer_step(model, device=device)
        _, counts = inference_image(source, step, batch_size=args.batch_size,
                                    cls_limit=args.cls_limit)
        outputs.append(counts)
    return np.asarray(outputs).mean(axis=0).round().astype(int)


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    dev = common.device_of(args)
    h5 = os.path.join(common.resolve_data_path(args), "test.h5")
    source = LystoTestSource(h5, num_of_imgs=20 if args.debug else 0)
    os.makedirs(args.output, exist_ok=True)
    now = time.strftime("%Y%m%d-%H%M%S")
    paths = ensemble_paths(args.model, args.epoch)
    if not paths:
        raise SystemExit(f"no *_{args.epoch}epochs.ckpt files in {args.model}")
    final = ensemble_counts(paths, source, args, dev)
    out_csv = os.path.join(args.output, f"{now}-count-e{args.epoch}.csv")
    with open(out_csv, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["id", "count", "organ"])
        for i, y in enumerate(final, start=1):
            w.writerow([i, y, source.organs[i - 1]])
    print(f"Results saved in '{out_csv}'.")


if __name__ == "__main__":
    main()
