"""Stage-1 evaluation CLI: cell counts over ``test.h5`` from one pt1
checkpoint, or from three per-organ ones (colon, breast, prostate) merged by
image id; ``--cls_limit`` clamps each count into its predicted class's
range. Writes ``<time>-count-e<epoch>.csv`` (id, count, organ) or
``<time>-count.csv`` (id, count), as the JAX package's ``test_count``.

Usage:
    python -m cellsegmentation_tpu_torch.cli.test_count -m output/pt1_50epochs.ckpt
    python -m cellsegmentation_tpu_torch.cli.test_count -m colon.ckpt breast.ckpt prostate.ckpt
"""

from __future__ import annotations

import argparse
import csv
import os
import time

import numpy as np

from cellsegmentation_tpu_torch.cli import common
from cellsegmentation_tpu_torch.data.lysto import LystoTestSource
from cellsegmentation_tpu_torch.infer import inference_image
from cellsegmentation_tpu_torch.train.checkpoint import STAGE_SAVE_PARTITIONS
from cellsegmentation_tpu_torch.train.steps import make_image_infer_step

ORGANS = ("colon", "breast", "prostate")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="pt.1 evaluation: cell counting")
    parser.add_argument("-m", "--model", type=str, nargs="+", required=True,
                        help="1 checkpoint, or 3 per-organ (colon breast prostate)")
    parser.add_argument("-B", "--batch_size", type=int, default=128)
    parser.add_argument("--cls_limit", action="store_true")
    parser.add_argument("-o", "--output", type=str, default="./output")
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--data_path", type=str, default=None)
    parser.add_argument("--f32", action="store_true")
    common.add_device_arg(parser)
    parser.add_argument("-w", "--workers", type=int, default=4)
    return parser


def _counts(path: str, source, args):
    """(counts of ``source`` from the pt1 checkpoint at ``path``, payload)."""
    model, ckpt = common.load_stage_checkpoint(
        path, args, partitions=STAGE_SAVE_PARTITIONS["image"])
    step = make_image_infer_step(model, device=common.device_of(args))
    _, counts = inference_image(source, step, batch_size=args.batch_size,
                                cls_limit=args.cls_limit)
    return counts, ckpt


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if len(args.model) not in (1, 3):
        raise SystemExit("expected 1 or 3 checkpoints")
    common.device_of(args)  # no card and no CST_PLATFORM=cpu: raise first
    h5 = os.path.join(common.resolve_data_path(args), "test.h5")
    num = 20 if args.debug else 0
    os.makedirs(args.output, exist_ok=True)
    now = time.strftime("%Y%m%d-%H%M%S")

    if len(args.model) == 3:
        ids, counts = [], []
        for organ, path in zip(ORGANS, args.model):
            source = LystoTestSource(h5, organ=organ, num_of_imgs=num)
            ids.append(source.ids)
            counts.append(_counts(path, source, args)[0])
        counts = np.concatenate(counts)[np.argsort(np.concatenate(ids))]
        out_csv = os.path.join(args.output, f"{now}-count.csv")
        with open(out_csv, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["id", "count"])
            for i, y in enumerate(counts, start=1):
                w.writerow([i, y])
    else:
        source = LystoTestSource(h5, num_of_imgs=num)
        counts, ckpt = _counts(args.model[0], source, args)
        out_csv = os.path.join(args.output, f"{now}-count-e{ckpt['epoch']}.csv")
        with open(out_csv, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["id", "count", "organ"])
            for i, y in enumerate(counts, start=1):
                w.writerow([i, y, source.organs[i - 1]])
    print(f"Results saved in '{out_csv}'.")


if __name__ == "__main__":
    main()
