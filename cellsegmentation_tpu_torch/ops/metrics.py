"""Metrics: tile error rates, average precision, the quadratic weighted
kappa (LYSTO's headline count metric) and its linear and unweighted
siblings, Fisher-z kappa means, point distances, precision and recall, on
the host in numpy; and ``qwk_device``, the QWK of rating tensors on their
own device (the confusion matrix a one-hot product, O(K^2) to reduce)."""

from __future__ import annotations

import numpy as np
import torch


def calc_map(pred, real) -> float:
    """Average precision with the reference's argument order, quirk
    included: ``pred`` (0/1) is passed where sklearn takes the truth and
    ``real`` where it takes the scores, as the JAX package's
    ``average_precision_score(pred, real)`` does. The same step-wise sum as
    sklearn: precision at each distinct score times the recall it adds."""
    y = np.asarray(pred).ravel()
    score = np.asarray(real, np.float64).ravel()
    if not np.isin(y, (0, 1)).all():
        raise ValueError("calc_map: pred must be 0/1 (sklearn's y_true)")
    order = np.argsort(-score, kind="mergesort")
    y, score = y[order].astype(np.float64), score[order]
    last = np.r_[np.nonzero(np.diff(score))[0], y.size - 1]
    tps = np.cumsum(y)[last]
    precision = tps / (last + 1)
    # sklearn: with no positive, recall is 1 at every threshold
    recall = tps / tps[-1] if tps[-1] else np.ones_like(tps)
    return float(np.sum(np.diff(np.r_[0.0, recall]) * precision))


def calc_err(pred, real) -> tuple[float, float, float]:
    """Tile error rate, FPR, FNR of 0/1 predictions against 0/1 truth."""
    pred = np.asarray(pred)
    real = np.asarray(real)
    neq = np.not_equal(pred, real)
    err = float(neq.sum()) / pred.shape[0]
    fpr = float(np.logical_and(pred == 1, neq).sum()) / max((real == 0).sum(), 1)
    fnr = float(np.logical_and(pred == 0, neq).sum()) / max((real == 1).sum(), 1)
    return err, fpr, fnr


def _kappa_from_confusion(conf: np.ndarray) -> float:
    k = conf.shape[0]
    n = conf.sum()
    if k <= 1:
        return 1.0
    idx = np.arange(k)
    w = (idx[:, None] - idx[None, :]) ** 2 / (k - 1) ** 2
    expected = np.outer(conf.sum(axis=1), conf.sum(axis=0)) / n
    denom = (w * expected).sum()
    if denom == 0:
        return 1.0
    return float(1.0 - (w * conf).sum() / denom)


def quadratic_weighted_kappa(rater_a, rater_b, min_rating=None,
                             max_rating=None) -> float:
    """QWK between two integer rating vectors; the rating range is the
    min/max over both raters unless given."""
    a = np.asarray(rater_a, dtype=int)
    b = np.asarray(rater_b, dtype=int)
    if a.shape != b.shape:
        raise ValueError(f"rater shapes differ: {a.shape} vs {b.shape}")
    if min_rating is None:
        min_rating = int(min(a.min(), b.min()))
    if max_rating is None:
        max_rating = int(max(a.max(), b.max()))
    k = max_rating - min_rating + 1
    conf = np.zeros((k, k), dtype=np.float64)
    np.add.at(conf, (a - min_rating, b - min_rating), 1)
    return _kappa_from_confusion(conf)


def precision_recall(tp, fp, fn, return_f1: bool = False):
    """Precision and recall (and F1) of point counts, with the reference's
    empty-set conventions: a zero denominator gives 1 for P and R, and 0 for
    F1."""
    p = 1 if tp + fp == 0 else tp / (tp + fp)
    r = 1 if tp + fn == 0 else tp / (tp + fn)
    if return_f1:
        return p, r, 0 if p + r == 0 else (2 * p * r) / (p + r)
    return p, r


def _one_hot(x: torch.Tensor, k: int) -> torch.Tensor:
    """f32 one-hot [..., k] of integer ratings."""
    return (x[..., None].to(torch.int32)
            == torch.arange(k, dtype=torch.int32, device=x.device)).to(torch.float32)


def qwk_device(pred: torch.Tensor, target: torch.Tensor, num_ratings: int) -> torch.Tensor:
    """QWK over the fixed rating range [0, num_ratings) on the ratings'
    device, as an f32 scalar tensor: the confusion matrix is
    onehot(pred)^T @ onehot(target) (summed in f64, so the counts are exact
    whatever the matmul precision), the rest of the arithmetic f32."""
    conf = (_one_hot(pred, num_ratings).double().T
            @ _one_hot(target, num_ratings).double()).to(torch.float32)
    idx = torch.arange(num_ratings, dtype=torch.float32, device=conf.device)
    w = (idx[:, None] - idx[None, :]) ** 2 / (num_ratings - 1) ** 2
    expected = torch.outer(conf.sum(dim=1), conf.sum(dim=0)) / conf.sum()
    return 1.0 - torch.sum(w * conf) / torch.sum(w * expected)


def _weighted_kappa(a, b, weight_fn, min_rating=None, max_rating=None) -> float:
    a = np.asarray(a, dtype=int)
    b = np.asarray(b, dtype=int)
    if min_rating is None:
        min_rating = int(min(a.min(), b.min()))
    if max_rating is None:
        max_rating = int(max(a.max(), b.max()))
    k = max_rating - min_rating + 1
    conf = np.zeros((k, k), dtype=np.float64)
    np.add.at(conf, (a - min_rating, b - min_rating), 1)
    idx = np.arange(k)
    w = weight_fn(idx[:, None], idx[None, :], k)
    expected = np.outer(conf.sum(axis=1), conf.sum(axis=0)) / conf.sum()
    denom = (w * expected).sum()
    return 1.0 if denom == 0 else float(1.0 - (w * conf).sum() / denom)


def linear_weighted_kappa(rater_a, rater_b, min_rating=None, max_rating=None) -> float:
    """Kappa with |i - j| / (k - 1) disagreement weights."""
    return _weighted_kappa(rater_a, rater_b,
                           lambda i, j, k: np.abs(i - j) / max(k - 1, 1),
                           min_rating, max_rating)


def unweighted_kappa(rater_a, rater_b, min_rating=None, max_rating=None) -> float:
    """Kappa with 0/1 disagreement weights."""
    return _weighted_kappa(rater_a, rater_b, lambda i, j, k: (i != j).astype(float),
                           min_rating, max_rating)


def mean_quadratic_weighted_kappa(kappas, weights=None) -> float:
    """The Fisher-z mean of kappas clipped to [-0.999, 0.999], optionally
    weighted (weights normalized to mean 1)."""
    kappas = np.clip(np.asarray(kappas, dtype=float), -0.999, 0.999)
    if weights is None:
        weights = np.ones_like(kappas)
    else:
        weights = np.asarray(weights, dtype=float)
        weights = weights / np.mean(weights)
    z = np.mean(0.5 * np.log((1 + kappas) / (1 - kappas)) * weights)
    return float((np.exp(2 * z) - 1) / (np.exp(2 * z) + 1))


def weighted_mean_quadratic_weighted_kappa(labels, preds, groups,
                                           group_weights=None) -> float:
    """One QWK per group id (in sorted id order), Fisher-z averaged with
    ``group_weights[id]`` if given."""
    labels = np.asarray(labels)
    preds = np.asarray(preds)
    groups = np.asarray(groups)
    uniq = np.unique(groups)
    kappas = [quadratic_weighted_kappa(labels[groups == g], preds[groups == g])
              for g in uniq]
    weights = None if group_weights is None else [group_weights[g] for g in uniq]
    return mean_quadratic_weighted_kappa(kappas, weights)


def euclid_dist(p1, p2) -> float:
    """Euclidean distance between two points."""
    return float(np.sqrt(sum((d1 - d2) ** 2 for d1, d2 in zip(p1, p2))))
