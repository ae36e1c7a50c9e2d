"""Mode-seeking cell localization on one stitched uint8 mask, without
``cv2`` or ``sklearn``.

Smooth the mask (the 15x15 sigma-3 Gaussian blur, or a normalized distance
transform), seed a 16x16 track window at every grid point whose centre
exceeds 0.2*255, shift every window to its local mass mode at once (three
integral images give each window's box moments in O(1) per iteration),
merge the converged centres with DBSCAN(eps, min_samples=1), rank the
cluster means by smoothed mask value and keep the top ``cell_count``.

The smoothing reproduces OpenCV's 8-bit results exactly:
``gaussian_blur_u8`` is ``cv2.GaussianBlur`` on uint8 (a fixed-point
separable filter), ``distance_transform_u8`` is
``cv2.distanceTransform(DIST_L2, DIST_MASK_PRECISE)`` followed by
``cv2.normalize(NORM_MINMAX)``, x255 and rounding; ``dbscan_labels`` is
sklearn's DBSCAN labelling for ``min_samples=1``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from cellsegmentation_tpu_torch.ops.tiles import tile_grid

# OpenCV's fixed kernels for ksize 1-7 when sigma <= 0
_SMALL_KERNELS = {1: [1.0], 3: [0.25, 0.5, 0.25],
                  5: [0.0625, 0.25, 0.375, 0.25, 0.0625],
                  7: [0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375,
                      0.03125]}


def gaussian_kernel_u8(ksize: int, sigma: float) -> np.ndarray:
    """OpenCV's 8-bit Gaussian kernel: int64 taps with 8 fractional bits
    summing to 256. The float64 kernel's first half is rounded by error
    diffusion, mirrored, and the centre takes what is left."""
    if ksize < 1 or ksize % 2 == 0:
        raise ValueError(f"ksize must be odd and positive, got {ksize}")
    half = ksize // 2
    if sigma <= 0 and ksize in _SMALL_KERNELS:
        k = np.asarray(_SMALL_KERNELS[ksize])
    else:
        if sigma <= 0:
            sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
        x = np.arange(-half, half + 1, dtype=np.float64)
        k = np.exp(-(x * x) / (2 * sigma * sigma))
        k /= k.sum()
    out = np.zeros(ksize, np.int64)
    err = 0.0
    for i in range(half):
        v = k[i] * 256 + err
        out[i] = int(np.rint(v))
        err = v - out[i]
    out[ksize - half:] = out[:half][::-1]
    out[half] = 256 - 2 * int(out[:half].sum())
    return out


def gaussian_blur_u8(mask: np.ndarray, ksize=(15, 15), sigmaX: float = 3,
                     **other) -> np.ndarray:
    """``cv2.GaussianBlur(mask, ksize, sigmaX)`` on a uint8 [H, W] image,
    bit-exact: BORDER_REFLECT_101 padding, a horizontal then a vertical
    integer pass with the 8-bit kernels, ``(acc + 2**15) >> 16``."""
    if other:
        raise ValueError(f"unsupported GaussianBlur arguments {sorted(other)}; "
                         "only ksize and sigmaX are reproduced")
    mask = np.asarray(mask)
    if mask.dtype != np.uint8 or mask.ndim != 2:
        raise ValueError(f"expected a uint8 [H, W] mask, got {mask.dtype} {mask.shape}")
    kw, kh = (int(ksize[0]), int(ksize[1]))
    kx, ky = gaussian_kernel_u8(kw, sigmaX), gaussian_kernel_u8(kh, sigmaX)
    h, w = mask.shape
    src = np.pad(mask, ((kh // 2, kh // 2), (kw // 2, kw // 2)), mode="reflect")
    src = src.astype(np.int64)
    rows = np.zeros((src.shape[0], w), np.int64)
    for j, t in enumerate(kx):
        rows += t * src[:, j:j + w]
    acc = np.zeros((h, w), np.int64)
    for i, t in enumerate(ky):
        acc += t * rows[i:i + h]
    return ((acc + (1 << 15)) >> 16).astype(np.uint8)


def distance_transform_u8(binary: np.ndarray) -> np.ndarray:
    """The Euclidean distance of every nonzero pixel to the nearest zero
    pixel, min-max normalized to [0, 1], x255 and rounded: uint8 [H, W].
    A mask with no zero pixel gets 0 everywhere, as an all-zero one does:
    its distances are undefined, and cv2 fills in a sentinel (not a
    distance) that normalizes to 0 where it is uniform; on some shapes and
    thread counts cv2 mixes two sentinels, which no fixed rule follows."""
    from scipy.ndimage import distance_transform_edt

    binary = np.asarray(binary)
    if binary.all():
        return np.zeros(binary.shape, np.uint8)
    dt = distance_transform_edt(binary != 0).astype(np.float32)
    lo, hi = float(dt.min()), float(dt.max())
    scale = 1.0 / (hi - lo) if hi - lo > np.finfo(np.float64).eps else 0.0
    norm = (dt.astype(np.float64) * scale - lo * scale).astype(np.float32)
    return np.round(norm * 255).astype(np.uint8)


def dbscan_labels(points: np.ndarray, eps: float) -> np.ndarray:
    """sklearn's ``DBSCAN(eps, min_samples=1).fit_predict(points)``: the
    connected components of the graph "distance <= eps", numbered in order
    of each component's lowest-indexed point."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components
    from scipy.spatial import cKDTree

    points = np.asarray(points, np.float64)
    n = len(points)
    pairs = cKDTree(points).query_pairs(eps, output_type="ndarray")
    graph = coo_matrix((np.ones(len(pairs)), (pairs[:, 0], pairs[:, 1])),
                       shape=(n, n))
    _, comp = connected_components(graph, directed=False)
    first = np.full(comp.max() + 1, n)
    np.minimum.at(first, comp, np.arange(n))
    rank = np.empty_like(first)
    rank[np.argsort(first)] = np.arange(len(first))
    return rank[comp]


def _integral(a: np.ndarray) -> np.ndarray:
    out = np.zeros((a.shape[0] + 1, a.shape[1] + 1), dtype=np.float64)
    np.cumsum(np.cumsum(a, axis=0), axis=1, out=out[1:, 1:])
    return out


def _box_sums(ii: np.ndarray, x0, y0, size: int):
    return (ii[x0 + size, y0 + size] - ii[x0, y0 + size]
            - ii[x0 + size, y0] + ii[x0, y0])


def vectorized_meanshift(mask: np.ndarray, windows_xy: np.ndarray,
                         window_size: int, max_iter: int = 100) -> np.ndarray:
    """Shift every [x, y]-cornered box to its local mass mode at once.
    Returns the final window centres [K, 2] (x, y); a window with no mass
    stays put, as with ``cv2.meanShift``."""
    h, w = mask.shape
    m = mask.astype(np.float64)
    ii = _integral(m)
    ii_x = _integral(m * np.arange(h, dtype=np.float64)[:, None])
    ii_y = _integral(m * np.arange(w, dtype=np.float64)[None, :])

    x0 = np.clip(windows_xy[:, 0].astype(np.int64), 0, h - window_size)
    y0 = np.clip(windows_xy[:, 1].astype(np.int64), 0, w - window_size)
    active = np.ones(len(x0), dtype=bool)
    for _ in range(max_iter):
        if not active.any():
            break
        ax0, ay0 = x0[active], y0[active]
        m00 = _box_sums(ii, ax0, ay0, window_size)
        m10 = _box_sums(ii_x, ax0, ay0, window_size)
        m01 = _box_sums(ii_y, ax0, ay0, window_size)
        has_mass = m00 > 0
        cx = np.where(has_mass, m10 / np.maximum(m00, 1e-12), ax0 + window_size / 2)
        cy = np.where(has_mass, m01 / np.maximum(m00, 1e-12), ay0 + window_size / 2)
        nx0 = np.clip(np.round(cx - window_size / 2).astype(np.int64), 0, h - window_size)
        ny0 = np.clip(np.round(cy - window_size / 2).astype(np.int64), 0, w - window_size)
        moved = (nx0 != ax0) | (ny0 != ay0)
        x0[active], y0[active] = nx0, ny0
        still = np.zeros_like(active)
        still[np.nonzero(active)[0][moved]] = True
        active = still
    return np.stack([x0 + window_size // 2, y0 + window_size // 2], axis=1)


def smooth_mask(mask: np.ndarray, method: str, **method_kwargs) -> np.ndarray:
    """The smoothed uint8 map the windows climb: ``"gaussianblur"``
    (``ksize``, ``sigmaX``; 15x15, sigma 3 by default) or
    ``"distancetransform"`` (of ``mask > 10``; L2 with the precise mask,
    the only form reproduced)."""
    if method == "gaussianblur":
        return gaussian_blur_u8(mask, **(method_kwargs or {"ksize": (15, 15),
                                                           "sigmaX": 3}))
    if method == "distancetransform":
        # cv2.DIST_L2 == 2, cv2.DIST_MASK_PRECISE == 0
        if {k: v for k, v in method_kwargs.items()
                if (k, v) not in (("distanceType", 2), ("maskSize", 0))}:
            raise ValueError(f"unsupported distanceTransform arguments "
                             f"{method_kwargs}; only DIST_L2 with "
                             "DIST_MASK_PRECISE is reproduced")
        return distance_transform_u8(np.asarray(mask) > 10)
    raise ValueError(f"smoothing method {method!r} not found")


def meanshift_cluster(
    mask: np.ndarray,
    method: str = "gaussianblur",
    cell_count: Optional[int] = None,
    thr_for_setting_points: float = 0.2,
    window_size: int = 16,
    interval: int = 10,
    eps: float = 15,
    **method_kwargs,
):
    """The localization pass over one stitched uint8 mask: (kept centres
    [K, 2] as (x, y), discarded centres)."""
    smoothed = smooth_mask(mask, method, **method_kwargs)
    none = np.zeros((0, 2), dtype=int)
    h, w = smoothed.shape[:2]
    if h < window_size or w < window_size:
        return none, none
    grid = tile_grid(h, w, window_size, interval)
    half = window_size // 2
    centers_val = smoothed[grid[:, 0] + half, grid[:, 1] + half]
    seeds = grid[centers_val > thr_for_setting_points * 255]
    if len(seeds) == 0:
        return none, none

    centers = vectorized_meanshift(smoothed, seeds, window_size)
    labels = dbscan_labels(centers, eps)
    merged = np.stack([
        np.mean(centers[labels == i], axis=0).round().astype(int)
        for i in range(labels.max() + 1)
    ])
    weights = smoothed[merged[:, 0], merged[:, 1]]
    merged = merged[np.argsort(weights)[::-1]]
    if cell_count is not None:
        return merged[:cell_count], merged[cell_count:]
    return merged, none

