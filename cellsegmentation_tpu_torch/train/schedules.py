"""Learning-rate schedules as pure functions of the update step.

The reference's scheduler menu (the JAX package's ``train/schedules.py``):
- ``None``: the base rate, constant;
- ``"OneCycleLR"``: max lr = base, div_factor 25, pct_start 0.3, final
  div_factor 1e4, cosine phases, over ``max(epochs * steps_per_epoch, 4)``
  steps (below 4 steps the warm-up interval would be empty); evaluated in
  f32 in the reference's op order, so the values are the reference's,
  cancellation at the phase ends included;
- ``"ExponentialLR"``: gamma 0.9 per *epoch*;
- ``"CosineAnnealingWarmRestarts"``: per epoch, period ``t0`` epochs.

Epoch-stepped schedules quantize the step by ``steps_per_epoch``. The
train state writes ``schedule(step)`` into the optimizer before each update
(train/state.py), so moving the step moves the schedule: no scheduler
object to checkpoint.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np

Schedule = Callable[[int], float]


def _onecycle(total: int, peak: float, pct_start: float = 0.3,
              div_factor: float = 25.0,
              final_div_factor: float = 1e4) -> Schedule:
    # cosine from peak/div_factor up to peak over [0, b1), then down to
    # peak/(div_factor*final_div_factor) over [b1, total), flat after
    b1 = int(pct_start * total)
    v0 = peak / div_factor
    v1 = v0 * div_factor
    v2 = v1 * (1.0 / (div_factor * final_div_factor))

    def cos_interp(start, end, pct):
        c = np.cos(np.float32(math.pi * pct)) + np.float32(1)
        return float(np.float32(end) + np.float32((start - end) / 2.0) * c)

    def sched(step: int) -> float:
        if step < 0:
            return 0.0
        if step < b1:
            return cos_interp(v0, v1, step / b1)
        if step < total:
            return cos_interp(v1, v2, (step - b1) / (total - b1))
        return v2

    return sched


def make_schedule(name: Optional[str], base_lr: float, epochs: int,
                  steps_per_epoch: int, t0: int = 10) -> Schedule:
    if name is None:
        return lambda step: base_lr
    if name == "OneCycleLR":
        return _onecycle(max(epochs * steps_per_epoch, 4), base_lr)
    if name == "ExponentialLR":
        return lambda step: base_lr * 0.9 ** (step // steps_per_epoch)
    if name == "CosineAnnealingWarmRestarts":
        def sched(step: int) -> float:
            t_cur = (step // steps_per_epoch) % t0
            return 0.5 * base_lr * (1 + math.cos(math.pi * t_cur / t0))
        return sched
    raise ValueError(f"unknown scheduler {name!r}")
