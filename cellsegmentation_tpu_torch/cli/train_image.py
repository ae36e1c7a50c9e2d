"""Stage-1 training CLI: image-wise count training, the JAX package's
``train_image`` flags and outputs (``pt1_<epoch>epochs.ckpt`` every epoch,
``<time>-image-training.csv`` and ``<time>-image-validation.csv``).

Usage:
    python -m cellsegmentation_tpu_torch.cli.train_image -E resnet50 -B 48 \
        -e 50 -l 5e-4 -a -o ./output
"""

from __future__ import annotations

import argparse
import os

from cellsegmentation_tpu_torch.cli import common
from cellsegmentation_tpu_torch.data.lysto import LystoDataSource
from cellsegmentation_tpu_torch.train.trainers import train_stage1
from cellsegmentation_tpu_torch.utils.logging import RunLogger


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="pt.1: image-wise count training")
    common.add_common_args(parser, default_epochs=50, default_batch=48,
                           default_lr=5e-4)
    parser.add_argument("-E", "--encoder", type=str, default="resnet50")
    parser.add_argument("-a", "--augment", action="store_true")
    parser.add_argument("-k", "--kfold", type=int, default=10)
    parser.add_argument("--organ", type=str, default=None)
    parser.add_argument("--reg_only", action="store_true")
    parser.add_argument("--weighted_mse", action="store_true",
                        help="use WeightedMSELoss for the count regression")
    parser.add_argument("--hard_threshold", type=float, default=None)
    parser.add_argument("-r", "--resume", type=str, default=None)
    return parser


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    dev = common.device_of(args)
    h5 = os.path.join(common.resolve_data_path(args), "training.h5")
    num = 100 if args.debug else 0
    train_source = LystoDataSource(
        h5, train=True, kfold=args.kfold, organ=args.organ,
        augment=args.augment, shuffle=True, num_of_imgs=num, seed=args.seed,
    )
    val_source = LystoDataSource(h5, train=False, kfold=args.kfold,
                                 organ=args.organ, num_of_imgs=num)

    last_epoch = 0
    resume_opt = None
    if args.resume:
        model, ckpt = common.load_stage_checkpoint(args.resume, args)
        encoder = ckpt["encoder"]
        last_epoch = int(ckpt["epoch"])
        resume_opt = ckpt.get("optimizer")
    else:
        encoder = args.encoder
        model = common.setup_model(encoder, args, seed=args.seed)

    logger = RunLogger(args.output)
    logger.info(f"PT.I image assessment training | encoder={encoder} "
                f"device={dev} train={len(train_source)} val={len(val_source)}")
    train_stage1(
        model, train_source, val_source,
        epochs=args.epochs, batch_size=args.batch_size, lr=args.lr,
        weight_decay=args.weight_decay, scheduler=args.scheduler,
        test_every=args.test_every,
        heads="reg" if args.reg_only else "both",
        reg_loss="weighted_mse" if args.weighted_mse else "mse",
        hard_threshold=args.hard_threshold, encoder_name=encoder,
        output_dir=args.output, logger=logger, seed=args.seed,
        last_epoch=last_epoch, resume_opt_state=resume_opt, device=dev,
    )
    logger.close()


if __name__ == "__main__":
    main()
