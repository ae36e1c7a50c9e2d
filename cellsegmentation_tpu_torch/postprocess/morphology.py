"""Small-region morphology: the native C++ library (native/), or SciPy when
it cannot be built.

Semantics (skimage's):
- ``remove_small_objects(mask, min_size)``: drop 4-connected foreground
  components with area < min_size;
- ``remove_small_holes(mask, area_threshold)``: fill 4-connected background
  components with area < area_threshold (the outer background is one more
  component; it survives by its size).
"""

from __future__ import annotations

import ctypes

import numpy as np

from cellsegmentation_tpu_torch.native.build import load_native


def _scipy_filter(mask: np.ndarray, threshold: int, connectivity: int,
                  value: int) -> np.ndarray:
    from scipy import ndimage

    structure = ndimage.generate_binary_structure(2, connectivity)
    labels, n = ndimage.label(mask == value, structure=structure)
    if n == 0:
        return mask
    small = np.bincount(labels.reshape(-1)) < threshold
    small[0] = False
    mask = mask.copy()
    mask[small[labels]] = 1 - value
    return mask


def _as_u8(mask: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(mask.astype(np.uint8))


def _native_filter(fn_name: str, mask, threshold: int, connectivity: int,
                   value: int) -> np.ndarray:
    lib = load_native()
    if lib is None:
        return _scipy_filter(np.asarray(mask), threshold, connectivity,
                             value).astype(bool)
    buf = _as_u8(mask)
    h, w = buf.shape
    getattr(lib, fn_name)(buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                          h, w, threshold, connectivity)
    return buf.astype(bool)


def remove_small_objects(mask: np.ndarray, min_size: int,
                         connectivity: int = 1) -> np.ndarray:
    """0/1 mask -> bool mask without its components of area < min_size."""
    return _native_filter("remove_small_objects", mask, min_size, connectivity, 1)


def remove_small_holes(mask: np.ndarray, area_threshold: int,
                       connectivity: int = 1) -> np.ndarray:
    """0/1 mask -> bool mask with its holes of area < area_threshold filled."""
    return _native_filter("remove_small_holes", mask, area_threshold,
                          connectivity, 0)


def remove_small_regions(mask: np.ndarray, min_object_size: int,
                         hole_area_threshold: int) -> np.ndarray:
    """Objects, then holes."""
    mask = remove_small_objects(mask, min_object_size)
    return remove_small_holes(mask, hole_area_threshold)


def remove_small_regions_batch(masks: np.ndarray, min_object_size: int,
                               hole_area_threshold: int) -> np.ndarray:
    """[N, H, W] objects-then-holes pass, one native call for the batch."""
    lib = load_native()
    if lib is None:
        return np.stack([remove_small_regions(m, min_object_size,
                                              hole_area_threshold)
                         for m in masks])
    buf = _as_u8(masks)
    n, h, w = buf.shape
    lib.remove_small_regions_batch(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        n, h, w, min_object_size, hole_area_threshold, 1,
    )
    return buf.astype(bool)
