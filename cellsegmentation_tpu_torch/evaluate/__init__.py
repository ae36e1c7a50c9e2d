"""Stage evaluation (host numpy).

``evaluate_tile`` rebuilds per-tile ground truth by marking each image's top
``count * tiles_per_pos`` tiles (by predicted prob) positive, thresholds the
probs, and reports (err, FPR, FNR). The image-level evaluation comes with
the stage-1 slice of the port.
"""

from __future__ import annotations

import numpy as np

from cellsegmentation_tpu_torch.ops.metrics import calc_err


def evaluate_tile(labels: np.ndarray, probs: np.ndarray, tiles_per_pos: int,
                  threshold: float) -> tuple[float, float, float]:
    """labels: [N] image counts; probs: [N, T] dense per-tile probs."""
    n, t = probs.shape
    ranks = np.argsort(np.argsort(probs, axis=1, kind="stable"), axis=1,
                       kind="stable")
    k = np.minimum(labels * tiles_per_pos, t)[:, None]
    gt = (ranks >= t - k).astype(np.int64)
    pred = (probs > threshold).astype(np.int64)
    return calc_err(pred.reshape(-1), gt.reshape(-1))
