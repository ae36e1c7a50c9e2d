"""Host post-processing of masks and the images written from them.

- ``paint_tile_blocks``: a tile_size^2 block of 1s at every kept tile
  corner, as a corner-increment + 2-D cumsum (one vectorized pass);
- ``preprocess_masks``: AND the mask with V <= 170 (V = the max channel),
  then drop objects < 400 px and fill holes < 120 px;
- ``save_mask_pairs``: the pseudo-mask trees ``rgb/<row+1:05>.png`` and
  ``mask/<row+1:05>.png``, written by ``cv2``;
- ``heatmap`` (stage-2 tile probs as JET overlays), ``overlap_mask`` and
  ``save_images_with_masks`` (seg-mask overlays), ``dotting`` and
  ``locate_cells`` (detected centres as dots), ``save_images`` (h5 images
  to PNG files) and ``crop_wsi`` (oversized slides split into strips).

The evaluation images are written by ``utils.images.write_png`` with the
pixels the JAX package's ``cv2.imwrite`` calls leave in their files, its
colour-order quirks included, so they need no ``cv2``; ``save_mask_pairs``
and ``crop_wsi`` (which reads slides) import it.
"""

from __future__ import annotations

import csv
import os
import shutil
from typing import Optional, Sequence

import numpy as np
import torch

from cellsegmentation_tpu_torch.ops.hsv import hsv_refine_mask
from cellsegmentation_tpu_torch.postprocess.morphology import (
    remove_small_regions,
    remove_small_regions_batch,
)
from cellsegmentation_tpu_torch.utils.images import (
    add_weighted_half,
    apply_jet,
    fill_circle,
    write_png,
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


def _value_refine(images: np.ndarray, masks: np.ndarray) -> np.ndarray:
    """bool masks AND V <= 170 (ops/hsv.py), on the host arrays."""
    return hsv_refine_mask(torch.from_numpy(np.ascontiguousarray(images)),
                           torch.from_numpy(np.ascontiguousarray(masks))).numpy()


def preprocess_masks(img: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """One image's refinement: keep mask pixels with V <= 170, drop objects
    < 400 px, fill holes < 120 px. V is the channel max, so the channel
    order does not matter."""
    return remove_small_regions(_value_refine(img, mask), min_object_size=400,
                                hole_area_threshold=120)


def preprocess_masks_batch(images: np.ndarray, masks: np.ndarray) -> np.ndarray:
    """[N,H,W,3] x [N,H,W] refinement, one native morphology call."""
    return remove_small_regions_batch(_value_refine(images, masks), 400, 120)


def save_mask_pairs(output_path: str, rows: np.ndarray, images: np.ndarray,
                    masks: np.ndarray) -> None:
    """Write ``rgb/<row+1:05>.png`` and ``mask/<row+1:05>.png`` for each of
    the batch's global 0-based ``rows``, so a streamed draw names its files
    as a whole-set save does. The files are ``cv2``'s (imported only here),
    byte-equal to the JAX package's, which the stage-3 training source
    reads back."""
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


def heatmap(images: np.ndarray, groups: np.ndarray, tiles_xy: np.ndarray,
            probs: np.ndarray, tile_size: int, output_path: str,
            csv_path: Optional[str] = None) -> None:
    """Tile-prob overlays ``test_<i+1:05>.png``: each kept tile's prob
    painted into an image-sized map in tile order (later tiles overwrite),
    255 - 255*prob through the JET colormap (BGR), blended 50/50 with the
    RGB image as it stands, and written channel-swapped, as the reference's
    ``cv2`` calls leave it. ``csv_path`` gets one (image, "[x, y]", prob)
    row per tile."""
    os.makedirs(output_path, exist_ok=True)
    h, w = images.shape[1:3]
    masks = np.zeros((len(images), h, w), dtype=np.float32)
    rows = []
    for i, g in enumerate(groups):
        x, y = int(tiles_xy[i, 0]), int(tiles_xy[i, 1])
        masks[g, x : x + tile_size, y : y + tile_size] = probs[i]
        rows.append([g, f"[{x}, {y}]", probs[i]])
    if csv_path:
        with open(csv_path, "w", newline="") as f:
            csv.writer(f).writerows(rows)
    for i in range(len(images)):
        cmap = apply_jet(255 - np.uint8(255 * masks[i]))
        blend = add_weighted_half(images[i], cmap)
        write_png(os.path.join(output_path, f"test_{i + 1:05}.png"), blend)


def _half_overlay(img: np.ndarray, binary: np.ndarray) -> np.ndarray:
    """``img * 0.5 + 255 * binary * 0.5`` per channel, truncated into the
    uint8 image (in place)."""
    overlay = np.uint8(255 * binary.astype(np.uint8)) * 0.5
    for c in range(3):
        img[:, :, c] = img[:, :, c] * 0.5 + overlay
    return img


def overlap_mask(img: np.ndarray, mask: np.ndarray, postprocess: bool = True,
                 min_object_size: int = 300, hole_area_threshold: int = 100,
                 save: Optional[str] = None) -> np.ndarray:
    """A binary mask blended 50/50 onto an RGB image (after the small-region
    clean-up with ``postprocess``), written to ``save`` when given."""
    if postprocess:
        mask = remove_small_regions(mask, min_object_size, hole_area_threshold)
    img = _half_overlay(img.copy(), mask)
    if save is not None:
        write_png(save, img.astype(np.uint8))
    return img


def save_images_with_masks(images: Sequence[np.ndarray],
                           masks: Sequence[np.ndarray], threshold: float,
                           output_path: str, soft: bool = False,
                           start_index: int = 0) -> None:
    """``test_<n:05>.png`` overlays of thresholded seg masks (n counts from
    ``start_index + 1``, so streamed batches number their files as one call
    would); with ``soft``, the kept probs as ``soft/<n:05>.png`` and a JET
    overlay instead."""
    os.makedirs(output_path, exist_ok=True)
    for i in range(len(images)):
        n = start_index + i + 1
        img = images[i].copy()
        classes = masks[i] > threshold
        if soft:
            soft_dir = os.path.join(output_path, "soft")
            os.makedirs(soft_dir, exist_ok=True)
            soft_map = np.uint8(255 * masks[i] * classes)
            write_png(os.path.join(soft_dir, f"{n:05}.png"), soft_map)
            img = add_weighted_half(img, apply_jet(255 - soft_map))
        else:
            img = _half_overlay(img, classes)
        write_png(os.path.join(output_path, f"test_{n:05}.png"), img.astype(np.uint8))


def dotting(img: np.ndarray, points, radius: int = 4,
            color=(255, 0, 0)) -> np.ndarray:
    """Filled circles at (column, row) ``points``, in place."""
    for x, y in points:
        fill_circle(img, (x, y), radius, color)
    return img


def locate_cells(slide: np.ndarray, grids, discarded_grids=None) -> np.ndarray:
    """Red dots at kept centres and blue ones at discarded centres, each
    given as (row, column), in place."""
    for y, x in grids:
        fill_circle(slide, (x, y), 4, (255, 0, 0))
    if discarded_grids is not None:
        for y, x in discarded_grids:
            fill_circle(slide, (x, y), 4, (0, 0, 255))
    return slide


def save_images(images: np.ndarray, organs, labels, prefix: str,
                output_path: str) -> None:
    """h5 images as ``<prefix>_<i+1>[_<label>cells].png`` files and a
    ``<prefix>_organ.csv`` index."""
    os.makedirs(output_path, exist_ok=True)
    with open(os.path.join(output_path, f"{prefix}_organ.csv"), "w", newline="") as f:
        w = csv.writer(f)
        for i, img in enumerate(images):
            if labels is not None:
                name = f"{prefix}_{i + 1}_{labels[i]}cells.png"
                w.writerow([name, labels[i], organs[i]])
            else:
                name = f"{prefix}_{i + 1}.png"
                w.writerow([name, organs[i]])
            write_png(os.path.join(output_path, name), img.astype(np.uint8))


def crop_wsi(data_path: str, max_size: float = 5e7) -> None:
    """Split every PNG larger than ``max_size`` bytes in ``data_path`` into
    vertical strips named ``<file>-<x origin>.png``, recursively: a plain
    file into 5 strips (the original moves to ``backup/``), a strip into 2.
    Reads the slides with ``cv2``, imported only when a file is too large."""
    backup_path = os.path.join(data_path, "backup")
    os.makedirs(backup_path, exist_ok=True)
    for fname in sorted(os.listdir(data_path)):
        fpath = os.path.join(data_path, fname)
        if not os.path.isfile(fpath) or os.path.getsize(fpath) <= max_size:
            continue
        import cv2

        wsi = cv2.imread(fpath, cv2.IMREAD_COLOR)[..., ::-1]  # BGR -> RGB
        stem = os.path.splitext(fname)[0]
        if stem.find("-") > 0:
            base, xo = stem.split("-", 1)
            xorigin = int(xo)
            borders = np.linspace(xorigin, xorigin + wsi.shape[1], 3, dtype=int)
            for i in range(2):
                write_png(os.path.join(data_path, f"{base}-{borders[i]}.png"),
                          wsi[:, borders[i] - xorigin : borders[i + 1] - xorigin])
        else:
            borders = np.linspace(0, wsi.shape[1], 6, dtype=int)
            for i in range(5):
                write_png(os.path.join(data_path, f"{stem}-{borders[i]}.png"),
                          wsi[:, borders[i] : borders[i + 1]])
            shutil.move(fpath, backup_path)
    for fname in sorted(os.listdir(data_path)):
        fpath = os.path.join(data_path, fname)
        if os.path.isfile(fpath) and os.path.getsize(fpath) > max_size:
            crop_wsi(data_path, max_size)
            break
