"""Stage evaluation (host numpy).

``evaluate_tile`` rebuilds per-tile ground truth by marking each image's top
``count * tiles_per_pos`` tiles (by predicted prob) positive, thresholds the
probs, and reports (err, FPR, FNR). ``evaluate_image`` reports (0, MSE,
QWK) of regressed counts against the labels: the kappa over raw integer
counts, not class bins, and the mAP slot 0, as in the reference.
"""

from __future__ import annotations

import numpy as np

from cellsegmentation_tpu_torch.ops.metrics import calc_err, quadratic_weighted_kappa


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


def evaluate_image(labels: np.ndarray, categories: np.ndarray,
                   counts: np.ndarray) -> tuple[float, float, float]:
    """(mAP placeholder 0, MSE, QWK). The kappa's confusion matrix is
    (max rating)^2, so for it alone the counts are clipped to
    ``max(500, 2 * max label)``: a diverged regressor's huge count would
    make it unallocatable, and any count past the cap already disagrees
    maximally. The MSE is unclipped."""
    counts = np.asarray(counts, dtype=np.float64)
    labels = np.asarray(labels, dtype=np.float64)
    mse = float(np.mean((counts - labels) ** 2))
    cap = max(500, 2 * int(labels.max(initial=0)))
    score = quadratic_weighted_kappa(counts.clip(0, cap).astype(int),
                                     labels.astype(int))
    return 0.0, mse, score
