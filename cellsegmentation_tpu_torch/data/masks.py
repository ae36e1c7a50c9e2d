"""The stage-3 training source: LYSTO images paired with their pseudo-masks.

Masks come as an array [N, H, W] (nonzero = positive) or as a pseudomask
directory holding ``mask/<n>.png`` files (read with ``cv2``, imported only
then, in natural file order, > 127 = positive). Images come from a LYSTO h5
file (``h5py`` imported only then) or, through ``from_arrays``, from
memory. Random flips are the trainer's, drawn per epoch when ``augment``.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from cellsegmentation_tpu_torch.data.lysto import _load_h5
from cellsegmentation_tpu_torch.utils.logging import sort_files


def _load_mask_dir(path: str, n: int) -> np.ndarray:
    import cv2

    mask_dir = os.path.join(path, "mask")
    files = sort_files([f for f in os.listdir(mask_dir) if f.endswith(".png")])
    return np.stack([cv2.imread(os.path.join(mask_dir, f), cv2.IMREAD_GRAYSCALE)
                     for f in files[:n]]) > 127


class MaskDataSource:
    """``images`` uint8 [N, H, W, 3], ``masks`` uint8 0/1 [N, H, W],
    ``labels`` (the file's counts), ``organs``; ``flip_code`` zeros and
    ``base_idx`` the identity, as the drawing and training loops read
    them."""

    def __init__(self, filepath: str, masks, num_of_imgs: int = 0,
                 augment: bool = False):
        images, organs, counts = _load_h5(filepath, num_of_imgs)
        self._setup(images, masks, organs, counts, augment)

    @classmethod
    def from_arrays(cls, images: np.ndarray, masks, organs: Optional[Sequence] = None,
                    counts: Optional[np.ndarray] = None,
                    augment: bool = False) -> "MaskDataSource":
        """The same source from in-memory images; ``masks`` as above."""
        src = cls.__new__(cls)
        src._setup(np.asarray(images), masks, organs, counts, augment)
        return src

    def _setup(self, images, masks, organs, counts, augment) -> None:
        self.images = images
        self.organs = organs
        self.labels = counts
        self.augment = augment
        if isinstance(masks, (str, os.PathLike)):
            masks = _load_mask_dir(masks, len(images))
        self.masks = (np.asarray(masks) > 0).astype(np.uint8)[: len(images)]
        if len(self.masks) != len(self.images):
            raise ValueError(f"{len(self.masks)} masks for {len(self.images)} images")
        self.flip_code = np.zeros(len(self.images), dtype=np.int32)
        self.base_idx = np.arange(len(self.images))

    def __len__(self) -> int:
        return len(self.images)

    @property
    def image_hw(self) -> tuple[int, int]:
        return self.images.shape[1], self.images.shape[2]
