"""Losses: cross-entropy and (weighted) MSE, reduced in f32.

``weighted_mse`` keeps the reference's quirk: the per-element weight is
``ln(count)`` for counts >= 20 and the raw count otherwise (its weights
start as a copy of the targets and only entries >= 20 are replaced by their
log), because it changes training dynamics. Soft dice (eps 1e-6) comes in
the flat 2-D form and the per-row batch form.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy with integer labels."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels.long()[..., None]).mean()


def _reduce(x: torch.Tensor, reduction: str) -> torch.Tensor:
    return x.mean() if reduction == "mean" else x.sum()


def mse(inputs: torch.Tensor, targets: torch.Tensor,
        reduction: str = "mean") -> torch.Tensor:
    return _reduce((inputs.float() - targets.float()) ** 2, reduction)


def count_weights(targets: torch.Tensor) -> torch.Tensor:
    """WeightedMSELoss's per-element weights: ln(t) where t >= 20, else t."""
    t = targets.float()
    return torch.where(t >= 20, torch.log(t.clamp_min(1e-12)), t)


def weighted_mse(inputs: torch.Tensor, targets: torch.Tensor,
                 reduction: str = "mean") -> torch.Tensor:
    """MSE weighted by ``count_weights(targets)``."""
    t = targets.float()
    return _reduce(count_weights(t) * (inputs.float() - t) ** 2, reduction)


def dice_coef(inputs: torch.Tensor, targets: torch.Tensor,
              epsilon: float = 1e-6) -> torch.Tensor:
    """Soft dice. 2-D inputs -> a scalar over the flattened mask; N-D
    inputs -> one coefficient per leading batch row."""
    inputs, targets = inputs.float(), targets.float()
    if inputs.ndim == 2:
        a = torch.sum(inputs * targets)
        b = torch.sum(inputs * inputs)
        c = torch.sum(targets * targets)
    else:
        fi = inputs.reshape(inputs.shape[0], -1)
        ft = targets.reshape(targets.shape[0], -1)
        a = torch.sum(fi * ft, dim=1)
        b = torch.sum(fi * fi, dim=1)
        c = torch.sum(ft * ft, dim=1)
    return (2 * a + epsilon) / (b + c + epsilon)


def dice_loss(inputs: torch.Tensor, targets: torch.Tensor,
              epsilon: float = 1e-6, reduction: str = "mean") -> torch.Tensor:
    return _reduce(1 - dice_coef(inputs, targets, epsilon), reduction)
