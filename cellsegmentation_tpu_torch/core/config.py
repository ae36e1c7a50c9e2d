"""Config handling: the reference's two-line ``config.ini`` with
``[data] data_path``, read by every CLI, and the typed per-stage option
sets (the reference CLIs' flags and defaults)."""

from __future__ import annotations

import configparser
import dataclasses
import os
from typing import Optional


def load_data_path(ini_path: str = "config.ini", default: str = "./data") -> str:
    """Read ``[data] data_path`` from an ini file; fall back to ``default``."""
    if os.path.exists(ini_path):
        parser = configparser.ConfigParser()
        parser.read(ini_path)
        if parser.has_option("data", "data_path"):
            return parser.get("data", "data_path")
    return default


@dataclasses.dataclass
class StageConfig:
    """Options shared by every training stage."""

    encoder: str = "resnet50"
    epochs: int = 50
    batch_size: int = 48
    lr: float = 5e-4
    weight_decay: float = 1e-4
    scheduler: Optional[str] = None  # None | OneCycleLR | ExponentialLR | CosineAnnealingWarmRestarts
    augment: bool = False
    kfold: int = 10
    num_of_imgs: int = 0  # debug truncation; 0 = all
    test_every: int = 1
    seed: int = 42
    output: str = "./output"
    device_count: Optional[int] = None  # None = every visible device


@dataclasses.dataclass
class TileStageConfig(StageConfig):
    """Stage-2 options."""

    epochs: int = 30
    tile_batch_size: int = 40960
    tile_size: int = 32
    interval: int = 20
    tiles_per_pos: int = 1
    topk_neg: int = 30
    pos_neg_ratio: float = 0.5
    threshold: float = 0.95


@dataclasses.dataclass
class SegStageConfig(StageConfig):
    """Stage-3 options."""

    epochs: int = 30
    batch_size: int = 32
    tile_size: int = 16
    interval: int = 5
    threshold: float = 0.95
    preprocess: bool = False
