"""Static tile grids and on-device tile extraction.

Every LYSTO image is 299x299, so the sliding-window grid (border completion
included) is a static coordinate table shared by all images, and tiles are
materialized on the device from whole images.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _axis_coords(length: int, tile_size: int, interval: int) -> np.ndarray:
    """1-D window starts every ``interval`` px, plus a final start flush with
    the border when the last regular window does not touch it."""
    starts = list(range(0, length - tile_size + 1, interval))
    if starts[-1] + tile_size != length:
        starts.append(length - tile_size)
    return np.asarray(starts, dtype=np.int32)


@functools.lru_cache(maxsize=None)
def tile_grid(height: int, width: int, tile_size: int, interval: int) -> np.ndarray:
    """Upper-left (x, y) coords of all tiles in the reference order: for each
    x, all y's (border y last), the border x row last — the row-major
    product of the per-axis lists. Returns [T, 2] int32."""
    xs = _axis_coords(height, tile_size, interval)
    ys = _axis_coords(width, tile_size, interval)
    grid = np.stack(np.meshgrid(xs, ys, indexing="ij"), axis=-1).reshape(-1, 2)
    return grid.astype(np.int32)


def num_tiles(height: int, width: int, tile_size: int, interval: int) -> int:
    return tile_grid(height, width, tile_size, interval).shape[0]


def extract_tiles_factored(images: torch.Tensor, xs: np.ndarray, ys: np.ndarray,
                           tile_size: int) -> torch.Tensor:
    """[B, H, W, C] images -> [B, nx*ny, ts, ts, C] tiles of the product
    grid xs x ys (x outer, y inner, the ``tile_grid`` order): the nx*ts row
    bands are gathered once, then the ny*ts columns."""
    b, _, _, c = images.shape
    offs = np.arange(tile_size)
    xs, ys = np.asarray(xs), np.asarray(ys)
    rows = torch.from_numpy((xs[:, None] + offs).reshape(-1)).to(images.device)
    cols = torch.from_numpy((ys[:, None] + offs).reshape(-1)).to(images.device)
    t = images.index_select(1, rows).index_select(2, cols)
    t = t.view(b, len(xs), tile_size, len(ys), tile_size, c)
    return t.permute(0, 1, 3, 2, 4, 5).reshape(b, -1, tile_size, tile_size, c)


def extract_tiles(images: torch.Tensor, coords: np.ndarray,
                  tile_size: int) -> torch.Tensor:
    """[B, H, W, C] images -> [B, T, ts, ts, C] tiles at ``coords`` [T, 2].

    A product grid (every tile_grid) takes ``extract_tiles_factored``;
    other coordinate lists gather per tile."""
    coords = np.asarray(coords)
    dev = images.device
    offs = np.arange(tile_size)
    xs, ys = np.unique(coords[:, 0]), np.unique(coords[:, 1])
    product = np.stack(np.meshgrid(xs, ys, indexing="ij"), -1).reshape(-1, 2)
    if len(product) == len(coords) and np.array_equal(product, coords):
        return extract_tiles_factored(images, xs, ys, tile_size)
    rows = torch.from_numpy(coords[:, 0:1] + offs).to(dev)  # [T, ts]
    cols = torch.from_numpy(coords[:, 1:2] + offs).to(dev)
    return images[:, rows[:, :, None], cols[:, None, :]]
