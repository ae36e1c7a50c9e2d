"""Shared CLI plumbing: the JAX package's flags, device choice, model and
checkpoint setup.

The CLIs run on the CUDA card (``-d`` picks its index) and raise without
one. ``CST_PLATFORM=cpu``, the JAX package's own override variable, runs
them on the CPU instead.
"""

from __future__ import annotations

import argparse
import os

import torch

from cellsegmentation_tpu_torch.core.config import load_data_path
from cellsegmentation_tpu_torch.core.device import resolve_device
from cellsegmentation_tpu_torch.core.dtypes import DEFAULT_POLICY, F32_POLICY
from cellsegmentation_tpu_torch.models import build_model
from cellsegmentation_tpu_torch.train import checkpoint as ckpt_mod


def add_common_args(parser: argparse.ArgumentParser, default_epochs: int,
                    default_batch: int, default_lr: float) -> None:
    parser.add_argument("-e", "--epochs", type=int, default=default_epochs)
    parser.add_argument("-B", "--batch_size", type=int, default=default_batch)
    parser.add_argument("-l", "--lr", type=float, default=default_lr)
    parser.add_argument("-s", "--scheduler", type=str, default=None,
                        choices=[None, "OneCycleLR", "ExponentialLR",
                                 "CosineAnnealingWarmRestarts"])
    parser.add_argument("-w", "--workers", type=int, default=4,
                        help="kept for reference-CLI parity; batches are "
                             "gathered on the host without loader workers")
    parser.add_argument("--weight_decay", type=float, default=1e-4)
    parser.add_argument("--test_every", type=int, default=1)
    add_device_arg(parser)
    parser.add_argument("--distributed", action="store_true",
                        help="kept for parity; one process on one card")
    parser.add_argument("-o", "--output", type=str, default="./output")
    parser.add_argument("--debug", action="store_true", help="use only 100 images")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--data_path", type=str, default=None,
                        help="override [data] data_path from config.ini")
    parser.add_argument("--f32", action="store_true", help="disable bf16 compute")


def add_device_arg(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("-d", "--device", type=int, default=0,
                        help="index of the CUDA card to run on")


def device_of(args) -> torch.device:
    """The card ``-d`` names, or the CPU under ``CST_PLATFORM=cpu``."""
    if os.environ.get("CST_PLATFORM") == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; set CST_PLATFORM=cpu "
                           "to run on the CPU")
    return resolve_device(f"cuda:{args.device}")


def resolve_data_path(args) -> str:
    return args.data_path or load_data_path()


def policy_of(args):
    return F32_POLICY if args.f32 else DEFAULT_POLICY


def setup_model(encoder: str, args, seed: int = 0):
    """A seeded model on the CLI's device."""
    return build_model(encoder, policy=policy_of(args), device=device_of(args),
                       seed=seed)


def load_stage_checkpoint(path: str, args, partitions=None):
    """(model, payload): a checkpoint's encoder built on the CLI's device,
    with the file's entries (of ``partitions`` only, when given) loaded."""
    ckpt = ckpt_mod.load_checkpoint(path)
    model = setup_model(ckpt["encoder"], args)
    ckpt_mod.restore_into(model, ckpt, partitions)
    return model, ckpt
