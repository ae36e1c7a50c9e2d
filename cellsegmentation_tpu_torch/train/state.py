"""Train state with per-stage trainable partitions.

The reference freezes modules by flipping ``requires_grad`` per stage; the
JAX package masks its optimizer over the top-level partitions. Here the
stage's partitions get ``requires_grad`` and the optimizer holds their
parameters only, so the others are never updated (and never decayed):

    stage "image":   encoder + fc_image_cls + fc_image_reg
    stage "tile":    fc_tile only
    stage "segment": seg_decoder only

Optimizer: Adam (betas 0.9/0.999, eps 1e-8) without a scheduler, SGD with
momentum 0.9 with one, as in the reference. Weight decay is L2 added to the
gradient (``torch.optim``'s own ``weight_decay``, so it flows through the
momentum). The learning rate is ``schedule(step)``, written into the
optimizer before each update, so realigning ``step`` (epoch boundaries,
resume) moves the schedule.
"""

from __future__ import annotations

import dataclasses

import torch

from cellsegmentation_tpu_torch.core.device import model_device
from cellsegmentation_tpu_torch.models.milnet import (
    ENCODER_KEY,
    IMAGE_CLS_KEY,
    IMAGE_REG_KEY,
    SEG_KEY,
    TILE_KEY,
    MILNet,
)
from cellsegmentation_tpu_torch.train.schedules import Schedule

STAGE_TRAINABLE = {
    "image": (ENCODER_KEY, IMAGE_CLS_KEY, IMAGE_REG_KEY),
    "image_cls": (ENCODER_KEY, IMAGE_CLS_KEY),
    "image_reg": (ENCODER_KEY, IMAGE_REG_KEY),
    "tile": (TILE_KEY,),
    "segment": (SEG_KEY,),
}


@dataclasses.dataclass
class TrainState:
    model: MILNet
    optimizer: torch.optim.Optimizer
    schedule: Schedule
    step: int = 0

    def apply_gradients(self) -> None:
        """One optimizer update at ``schedule(step)`` from the gradients the
        trainable parameters hold; ``step`` advances by one."""
        lr = float(self.schedule(self.step))
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.step += 1


def create_train_state(model: MILNet, stage: str, schedule: Schedule,
                       use_sgd: bool = False, weight_decay: float = 1e-4,
                       momentum: float = 0.9, device=None) -> TrainState:
    """The stage's train state over ``model`` (updated in place), on
    ``device`` (the CUDA card unless ``device="cpu"``; the model must
    already live there)."""
    model_device(model, device)
    model.set_trainable(STAGE_TRAINABLE[stage])
    params = [p for p in model.parameters() if p.requires_grad]
    lr = float(schedule(0))
    if use_sgd:
        opt = torch.optim.SGD(params, lr=lr, momentum=momentum,
                              weight_decay=weight_decay)
    else:
        opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                               weight_decay=weight_decay)
    return TrainState(model=model, optimizer=opt, schedule=schedule)
