"""Stage-2 training CLI: the MIL tile cycle, the JAX package's
``train_tile`` flags and outputs (``pt2_<epochs>epochs.ckpt`` at the last
epoch, ``<time>-tile-training.csv`` and ``<time>-tile-validation.csv``).

Usage:
    python -m cellsegmentation_tpu_torch.cli.train_tile \
        -m output/pt1_50epochs.ckpt -b 40960 -t 32 -i 20 -k 1 -n 30 -R 0.5 \
        -c 0.95 -e 30 -o ./output
"""

from __future__ import annotations

import argparse
import os

from cellsegmentation_tpu_torch.cli import common
from cellsegmentation_tpu_torch.data.lysto import LystoDataSource
from cellsegmentation_tpu_torch.models.milnet import (
    ENCODER_KEY,
    IMAGE_CLS_KEY,
    IMAGE_REG_KEY,
    TILE_KEY,
)
from cellsegmentation_tpu_torch.train.steps import ENGINES
from cellsegmentation_tpu_torch.train.trainers import train_stage2
from cellsegmentation_tpu_torch.utils.logging import RunLogger


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="pt.2: tile-wise MIL training")
    # -B is the image batch of the dense sweeps
    common.add_common_args(parser, default_epochs=30, default_batch=192,
                           default_lr=5e-5)
    parser.add_argument("-m", "--model", type=str, default=None,
                        help="stage-1 checkpoint to start from")
    parser.add_argument("-r", "--resume", type=str, default=None,
                        help="stage-2 checkpoint to resume")
    parser.add_argument("--scratch", action="store_true",
                        help="ablation: train from fresh resnet50 weights")
    parser.add_argument("-b", "--tile_batch_size", type=int, default=40960)
    parser.add_argument("-t", "--tile_size", type=int, default=32)
    parser.add_argument("-i", "--interval", type=int, default=20)
    parser.add_argument("-k", "--tiles_per_pos", type=int, default=1)
    parser.add_argument("-n", "--topk_neg", type=int, default=30)
    parser.add_argument("-R", "--pos_neg_ratio", type=float, default=0.5)
    parser.add_argument("-c", "--threshold", type=float, default=0.95)
    parser.add_argument("--infer_engine", choices=ENGINES, default="auto",
                        help="dense-sweep engine (auto: the fastest validated "
                             "chain the grid and arch support)")
    return parser


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    dev = common.device_of(args)
    h5 = os.path.join(common.resolve_data_path(args), "training.h5")
    num = 100 if args.debug else 0
    # no validation split when validation never runs
    kfold = None if args.test_every > args.epochs else 10
    train_source = LystoDataSource(h5, train=True, kfold=kfold, num_of_imgs=num)
    val_source = (LystoDataSource(h5, train=False, kfold=kfold, num_of_imgs=num)
                  if kfold is not None else None)

    last_epoch = 0
    resume_opt = None
    stage1_parts = (ENCODER_KEY, IMAGE_CLS_KEY, IMAGE_REG_KEY)
    if args.resume:
        model, ckpt = common.load_stage_checkpoint(
            args.resume, args, partitions=(*stage1_parts, TILE_KEY))
        encoder = ckpt["encoder"]
        last_epoch = int(ckpt["epoch"])
        resume_opt = ckpt.get("optimizer")
    elif args.scratch:
        encoder = "resnet50"
        model = common.setup_model(encoder, args, seed=args.seed)
    else:
        if not args.model:
            raise SystemExit("pass -m <pt1 checkpoint> (or --scratch)")
        model, ckpt = common.load_stage_checkpoint(args.model, args,
                                                   partitions=stage1_parts)
        encoder = ckpt["encoder"]

    os.makedirs(args.output, exist_ok=True)
    logger = RunLogger(args.output)
    logger.info(
        f"PT.II tile classifier training | encoder={encoder} device={dev} "
        f"tile={args.tile_size}/{args.interval} topk_neg={args.topk_neg} "
        f"train={len(train_source)}"
        + (f" val={len(val_source)}" if val_source else "")
    )
    train_stage2(
        model, train_source, val_source,
        epochs=args.epochs, tile_batch_size=args.tile_batch_size,
        image_batch=args.batch_size, tile_size=args.tile_size,
        interval=args.interval, tiles_per_pos=args.tiles_per_pos,
        topk_neg=args.topk_neg, pos_neg_ratio=args.pos_neg_ratio,
        threshold=args.threshold, lr=args.lr, weight_decay=args.weight_decay,
        scheduler=args.scheduler, test_every=args.test_every,
        encoder_name=encoder, output_dir=args.output, logger=logger,
        seed=args.seed, last_epoch=last_epoch, resume_opt_state=resume_opt,
        infer_engine=args.infer_engine, device=dev,
    )
    logger.close()


if __name__ == "__main__":
    main()
