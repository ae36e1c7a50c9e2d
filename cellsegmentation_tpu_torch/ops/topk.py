"""Adaptive, count-driven top-k tile selection — the core of stage 2.

Per image, the k highest-prob tiles are selected, with k = count *
tiles_per_pos for positive images and topk_neg for negative ones, as a
stable rank mask over the dense [B, T] grid:

    selected[b, t]  <=>  ascending-stable-rank(probs[b])[t] >= T - k_b

which breaks ties towards higher tile indices, as the reference's stable
lexsort taken from the top of the ascending order does.
"""

from __future__ import annotations

import torch


def _ascending_stable_rank(probs: torch.Tensor) -> torch.Tensor:
    """rank[t] = position of tile t in a stable ascending sort of its row."""
    order = torch.argsort(probs, dim=-1, stable=True)
    put = torch.arange(probs.shape[-1], device=probs.device).expand_as(order)
    return torch.empty_like(order).scatter_(-1, order, put)


def adaptive_topk_mask(
    probs: torch.Tensor,
    labels: torch.Tensor,
    tiles_per_pos: int,
    topk_neg: int,
    valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """Boolean [B, T] mask of the selected tiles.

    probs:  [B, T] P(positive) per tile.
    labels: [B] integer cell counts.
    valid:  optional [B, T] mask of real tiles (padding is never selected).
    """
    t = probs.shape[-1]
    if valid is not None:
        probs = torch.where(valid, probs, torch.full_like(probs, float("-inf")))
    k = torch.where(labels > 0, labels * tiles_per_pos,
                    torch.full_like(labels, topk_neg))
    k = torch.clamp(k, 0, t)[..., None]  # [B, 1]
    mask = _ascending_stable_rank(probs) >= (t - k)
    if valid is not None:
        mask = mask & valid
    return mask


def topk_threshold_mask(probs, threshold: float):
    """Tiles whose probability is above ``threshold``, on a tensor or a host
    array (the stage-3 draw keeps prob > 0.95)."""
    return probs > threshold
