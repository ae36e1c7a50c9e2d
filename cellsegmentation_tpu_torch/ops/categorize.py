"""LYSTO 7-bin count <-> class mapping: tensor forms (on the tensor's
device) and numpy twins for host code.

Bins: 0 | 1-5 | 6-10 | 11-20 | 21-50 | 51-200 | >200.
"""

from __future__ import annotations

import numpy as np
import torch

NUM_CLASSES = 7
_BOUNDARIES = np.asarray([1, 6, 11, 21, 51, 201])
CLASS_MIN_COUNT = np.asarray([0, 1, 6, 11, 21, 51, 201], dtype=np.int32)
CLASS_MAX_COUNT = np.asarray([0, 5, 10, 20, 50, 200, 100000], dtype=np.int32)


def categorize(x: torch.Tensor) -> torch.Tensor:
    """Count -> int32 class id (``numpy.digitize``'s right-open bins)."""
    bounds = torch.as_tensor(_BOUNDARIES, dtype=x.dtype, device=x.device)
    return torch.bucketize(x, bounds, out_int32=True, right=True)


def de_categorize(label: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Class id -> (min count, max count) of its bin, int32."""
    idx = label.long()
    return (torch.as_tensor(CLASS_MIN_COUNT, device=label.device)[idx],
            torch.as_tensor(CLASS_MAX_COUNT, device=label.device)[idx])


def categorize_np(x) -> np.ndarray:
    """Count -> class id."""
    return np.digitize(x, _BOUNDARIES)


def de_categorize_np(label) -> tuple[np.ndarray, np.ndarray]:
    """Class id -> (min count, max count) of its bin."""
    label = np.asarray(label, dtype=np.int64)
    return CLASS_MIN_COUNT[label], CLASS_MAX_COUNT[label]
