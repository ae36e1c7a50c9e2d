"""LYSTO 7-bin count <-> class mapping (host side).

Bins: 0 | 1-5 | 6-10 | 11-20 | 21-50 | 51-200 | >200.
"""

from __future__ import annotations

import numpy as np

NUM_CLASSES = 7
_BOUNDARIES = np.asarray([1, 6, 11, 21, 51, 201])
CLASS_MIN_COUNT = np.asarray([0, 1, 6, 11, 21, 51, 201], dtype=np.int32)
CLASS_MAX_COUNT = np.asarray([0, 5, 10, 20, 50, 200, 100000], dtype=np.int32)


def categorize_np(x) -> np.ndarray:
    """Count -> class id."""
    return np.digitize(x, _BOUNDARIES)


def de_categorize_np(label) -> tuple[np.ndarray, np.ndarray]:
    """Class id -> (min count, max count) of its bin."""
    label = np.asarray(label, dtype=np.int64)
    return CLASS_MIN_COUNT[label], CLASS_MAX_COUNT[label]
