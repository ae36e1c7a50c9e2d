"""Detection metrics: running averages and greedy point matching.

Each predicted point claims its nearest unmatched ground-truth point; a
claim within a 16-px cell radius is a true positive. P/R/F1 follow
``ops.metrics.precision_recall``'s empty-set conventions.
"""

from __future__ import annotations

import numpy as np

from cellsegmentation_tpu_torch.ops.metrics import precision_recall

CELL_RADIUS_PXS = 16


class AverageMeter:
    """The last value, and the running average of the values seen."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self._sum = 0.0
        self._count = 0

    def update(self, val, n: int = 1):
        self.val = float(val)
        self._sum += float(val) * n
        self._count += n

    @property
    def avg(self) -> float:
        return self._sum / self._count if self._count else 0.0


class MetricGroup:
    """P, R, F1 and dice meters, updated together."""

    def __init__(self):
        self.P = AverageMeter()
        self.R = AverageMeter()
        self.F1 = AverageMeter()
        self.dice = AverageMeter()

    def update(self, vals):
        self.P.update(vals[0])
        self.R.update(vals[1])
        self.F1.update(vals[2])
        self.dice.update(vals[3])

    def avg(self):
        return self.P.avg, self.R.avg, self.F1.avg, self.dice.avg

    def val(self):
        return self.P.val, self.R.val, self.F1.val, self.dice.val


def get_prf1(points_hat, points):
    """Greedy matching of predicted to ground-truth points: (p, r, f1, tp,
    fp, fn)."""
    points_hat = np.asarray(points_hat, dtype=np.float64).reshape(-1, 2)
    points = np.asarray(points, dtype=np.float64).reshape(-1, 2)
    matched = np.zeros(len(points), dtype=bool)
    tp = 0
    for p_hat in points_hat:
        if len(points) == 0:
            break
        d = np.linalg.norm(points - p_hat, axis=1)
        d[matched] = np.inf
        idx = int(np.argmin(d))
        if d[idx] <= CELL_RADIUS_PXS:
            matched[idx] = True
            tp += 1
    fp = len(points_hat) - tp
    fn = int((~matched).sum())
    p, r, f1 = precision_recall(tp, fp, fn, return_f1=True)
    return p, r, f1, tp, fp, fn
