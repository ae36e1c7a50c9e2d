"""Tile error metrics (host numpy)."""

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
