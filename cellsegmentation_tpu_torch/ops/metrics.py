"""Metrics (host numpy): tile error rates, the quadratic weighted kappa,
LYSTO's headline count metric, and point precision and recall."""

from __future__ import annotations

import numpy as np


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
