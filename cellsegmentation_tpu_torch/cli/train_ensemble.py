"""Ensemble training CLI: k bagged count regressors, the JAX package's
``train_ensemble`` flags and outputs.

Each fold trains a fresh model (seeded ``seed + fold``), the encoder and
the regression head (``heads="reg"``), on the other k-1 folds with its own
optimizer and schedule, validates on its own fold, and writes
``reg_pt1_<fold>_<epochs>epochs.ckpt``.

Usage:
    python -m cellsegmentation_tpu_torch.cli.train_ensemble -E resnext50_32x4d \
        -k 10 -e 30 -o ./output
"""

from __future__ import annotations

import argparse
import os

from cellsegmentation_tpu_torch.cli import common
from cellsegmentation_tpu_torch.data.lysto import EnsembleSource
from cellsegmentation_tpu_torch.models import build_model
from cellsegmentation_tpu_torch.train.checkpoint import save_checkpoint
from cellsegmentation_tpu_torch.train.trainers import train_stage1
from cellsegmentation_tpu_torch.utils.logging import RunLogger


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="pt.1 ensemble: k bagged regressors")
    common.add_common_args(parser, default_epochs=30, default_batch=48,
                           default_lr=5e-4)
    parser.add_argument("-E", "--encoder", type=str, default="resnet50")
    parser.add_argument("-k", "--kfold", type=int, default=10)
    parser.add_argument("-a", "--augment", action="store_true")
    parser.add_argument("--start_fold", type=int, default=0,
                        help="resume the sweep from this fold")
    return parser


def train_folds(ensemble: EnsembleSource, args, logger: RunLogger, device) -> list:
    """The CLI's work on a built ``EnsembleSource``: for each fold from
    ``args.start_fold``, a fresh model seeded ``args.seed + fold`` on
    ``device`` trained by ``train_stage1(heads="reg")`` for ``args.epochs``
    (over every rank of the process group), its checkpoint written under
    ``args.output``. Returns the paths."""
    paths = []
    for fold in range(args.start_fold, args.kfold):
        train_view, val_view = ensemble.fold(fold)
        logger.info(f"=== fold {fold + 1}/{args.kfold}: train={len(train_view)} "
                    f"val={len(val_view)} ===")
        model = build_model(args.encoder, policy=common.policy_of(args), device=device,
                            seed=args.seed + fold)
        result = train_stage1(
            model, train_view, val_view,
            epochs=args.epochs, batch_size=args.batch_size, lr=args.lr,
            weight_decay=args.weight_decay, scheduler=args.scheduler,
            test_every=args.test_every, heads="reg", encoder_name=args.encoder,
            output_dir=None,  # the fold's checkpoint is written below
            logger=logger, seed=args.seed + fold, device=device,
        )
        paths.append(save_checkpoint(
            args.output, "image", args.epochs, args.encoder, model.state_dict(),
            result.state.optimizer.state_dict(), step=result.state.step,
            prefix=f"reg_pt1_{fold}"))
    return paths


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    dev = common.device_of(args)
    h5 = os.path.join(common.resolve_data_path(args), "training.h5")
    ensemble = EnsembleSource(h5, k=args.kfold, augment=args.augment,
                              num_of_imgs=100 if args.debug else 0, seed=args.seed)
    os.makedirs(args.output, exist_ok=True)
    logger = RunLogger(args.output)
    train_folds(ensemble, args, logger, dev)
    logger.close()


if __name__ == "__main__":
    main()
