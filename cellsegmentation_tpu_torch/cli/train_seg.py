"""Stage-3 training CLI: pseudo-mask drawing, then seg-decoder training, the
JAX package's ``train_seg`` flags and outputs (the ``<pseudomask_dir>/
{rgb,mask}`` PNG trees under the data path, ``pt3_<epochs>epochs.ckpt`` at
the last epoch, ``<time>-seg-training.csv``).

Usage:
    python -m cellsegmentation_tpu_torch.cli.train_seg \
        -m output/pt2_30epochs.ckpt -t 16 -i 5 -c 0.95 -B 32 -e 30 [-p] \
        -o ./output
"""

from __future__ import annotations

import argparse
import os

from cellsegmentation_tpu_torch.cli import common
from cellsegmentation_tpu_torch.data.lysto import LystoDataSource
from cellsegmentation_tpu_torch.data.masks import MaskDataSource
from cellsegmentation_tpu_torch.models.milnet import (
    ENCODER_KEY,
    IMAGE_CLS_KEY,
    IMAGE_REG_KEY,
    TILE_KEY,
)
from cellsegmentation_tpu_torch.train.trainers import draw_pseudo_masks, train_stage3
from cellsegmentation_tpu_torch.utils.logging import RunLogger


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="pt.3: segmentation training")
    common.add_common_args(parser, default_epochs=30, default_batch=32,
                           default_lr=5e-5)
    parser.add_argument("-m", "--model", type=str, default=None,
                        help="stage-2 checkpoint to start from")
    parser.add_argument("-r", "--resume", type=str, default=None,
                        help="stage-3 checkpoint to resume")
    parser.add_argument("--scratch", action="store_true")
    parser.add_argument("-t", "--tile_size", type=int, default=16)
    parser.add_argument("-i", "--interval", type=int, default=5)
    parser.add_argument("-c", "--threshold", type=float, default=0.95)
    parser.add_argument("-b", "--tile_batch_size", type=int, default=128,
                        help="image batch for mask drawing")
    parser.add_argument("-p", "--preprocess", action="store_true",
                        help="V-channel refinement of the drawn masks")
    parser.add_argument("-P", "--pseudomask_dir", type=str, default="pseudomask")
    parser.add_argument("--skip_draw", action="store_true",
                        help="reuse masks in the pseudomask dir")
    parser.add_argument("-a", "--augment", action="store_true")
    return parser


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    dev = common.device_of(args)
    data_path = common.resolve_data_path(args)
    h5 = os.path.join(data_path, "training.h5")
    num = 100 if args.debug else 0

    last_epoch = 0
    resume_opt = None
    if args.resume:
        model, ckpt = common.load_stage_checkpoint(args.resume, args)
        encoder = ckpt["encoder"]
        last_epoch = int(ckpt["epoch"])
        resume_opt = ckpt.get("optimizer")
    elif args.scratch:
        encoder = "resnet50"
        model = common.setup_model(encoder, args, seed=args.seed)
    else:
        if not args.model:
            raise SystemExit("pass -m <pt2 checkpoint> (or --scratch)")
        # the encoder and the tile and image heads; the decoder starts fresh
        model, ckpt = common.load_stage_checkpoint(
            args.model, args,
            partitions=(ENCODER_KEY, TILE_KEY, IMAGE_CLS_KEY, IMAGE_REG_KEY))
        encoder = ckpt["encoder"]

    os.makedirs(args.output, exist_ok=True)
    logger = RunLogger(args.output)
    mask_dir = os.path.join(data_path, args.pseudomask_dir)
    if not args.skip_draw:
        # every training image (no k-fold split) on the dense grid
        draw_source = LystoDataSource(h5, train=True, kfold=None, num_of_imgs=num)
        logger.info(
            f"Generating pseudo-masks on the {args.tile_size}/{args.interval} grid "
            f"(threshold {args.threshold}, preprocess={args.preprocess}) ..."
        )
        masks = draw_pseudo_masks(
            model, draw_source, tile_size=args.tile_size,
            interval=args.interval, threshold=args.threshold,
            image_batch=args.tile_batch_size, preprocess=args.preprocess,
            output_path=mask_dir, logger=logger, device=dev,
        )
        mask_source = MaskDataSource(h5, masks, num_of_imgs=num,
                                     augment=args.augment)
    else:
        mask_source = MaskDataSource(h5, mask_dir, num_of_imgs=num,
                                     augment=args.augment)

    logger.info(f"PT.III segmentation training | encoder={encoder} device={dev} "
                f"train={len(mask_source)} batch={args.batch_size}")
    train_stage3(
        model, mask_source, epochs=args.epochs, batch_size=args.batch_size,
        lr=args.lr, weight_decay=args.weight_decay, scheduler=args.scheduler,
        encoder_name=encoder, output_dir=args.output, logger=logger,
        seed=args.seed, last_epoch=last_epoch, resume_opt_state=resume_opt,
        device=dev,
    )
    logger.close()


if __name__ == "__main__":
    main()
