"""Stage-3 pseudo-masks: block painting, the V-channel refinement and the
rgb/ + mask/ PNG trees.

- ``paint_tile_blocks``: a tile_size^2 block of 1s at every kept tile
  corner, as a corner-increment + 2-D cumsum (one vectorized pass);
- ``preprocess_masks``: AND the mask with V <= 170 (V = the max channel),
  then drop objects < 400 px and fill holes < 120 px;
- ``save_mask_pairs``: ``rgb/<row+1:05>.png`` and ``mask/<row+1:05>.png``
  (``cv2`` is imported only there).
"""

from __future__ import annotations

import os

import numpy as np

from cellsegmentation_tpu_torch.postprocess.morphology import (
    remove_small_regions,
    remove_small_regions_batch,
)


def paint_tile_blocks(n_images: int, image_hw: tuple, groups: np.ndarray,
                      tiles_xy: np.ndarray, tile_size: int) -> np.ndarray:
    """[N, H, W] bool masks, True under every kept tile: +1 at (x, y), -1 at
    (x, y+ts) and (x+ts, y), +1 at (x+ts, y+ts), two cumsums, > 0."""
    h, w = image_hw
    inc = np.zeros((n_images, h + 1, w + 1), dtype=np.int32)
    xs = tiles_xy[:, 0].astype(np.int64)
    ys = tiles_xy[:, 1].astype(np.int64)
    g = groups.astype(np.int64)
    np.add.at(inc, (g, xs, ys), 1)
    np.add.at(inc, (g, xs, ys + tile_size), -1)
    np.add.at(inc, (g, xs + tile_size, ys), -1)
    np.add.at(inc, (g, xs + tile_size, ys + tile_size), 1)
    return inc.cumsum(axis=1).cumsum(axis=2)[:, :h, :w] > 0


def preprocess_masks(img: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """One image's refinement: keep mask pixels with V <= 170, drop objects
    < 400 px, fill holes < 120 px. V is the channel max, so the channel
    order does not matter."""
    refined = np.logical_and(mask.astype(bool), img.max(axis=-1) <= 170)
    return remove_small_regions(refined, min_object_size=400,
                                hole_area_threshold=120)


def preprocess_masks_batch(images: np.ndarray, masks: np.ndarray) -> np.ndarray:
    """[N,H,W,3] x [N,H,W] refinement, one native morphology call."""
    refined = np.logical_and(masks.astype(bool), images.max(axis=-1) <= 170)
    return remove_small_regions_batch(refined, 400, 120)


def save_mask_pairs(output_path: str, rows: np.ndarray, images: np.ndarray,
                    masks: np.ndarray) -> None:
    """Write ``rgb/<row+1:05>.png`` and ``mask/<row+1:05>.png`` for each of
    the batch's global 0-based ``rows``, so a streamed draw names its files
    as a whole-set save does."""
    import cv2

    os.makedirs(os.path.join(output_path, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(output_path, "mask"), exist_ok=True)
    for j, row in enumerate(np.asarray(rows)):
        cv2.imwrite(os.path.join(output_path, f"rgb/{row + 1:05}.png"),
                    cv2.cvtColor(images[j], cv2.COLOR_RGB2BGR))
        cv2.imwrite(os.path.join(output_path, f"mask/{row + 1:05}.png"),
                    (masks[j] * 255).astype(np.uint8))


def generate_masks(images: np.ndarray, groups: np.ndarray, tiles_xy: np.ndarray,
                   tile_size: int, preprocess: bool = False,
                   save_masks: bool = True,
                   output_path: str = "./data/pseudomask") -> np.ndarray:
    """uint8 [N, H, W] pseudo-masks of [N, H, W, 3] images from the kept
    tiles (image index ``groups``, upper-left ``tiles_xy``), refined with
    ``preprocess``, saved as PNG pairs with ``save_masks``."""
    masks = paint_tile_blocks(len(images), images.shape[1:3], groups,
                              tiles_xy, tile_size)
    if preprocess:
        masks = preprocess_masks_batch(images, masks)
    if save_masks:
        save_mask_pairs(output_path, np.arange(len(images)), images, masks)
    return masks.astype(np.uint8)
