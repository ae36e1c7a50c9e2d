"""Stage-3 sources: the training source (LYSTO images paired with their
pseudo-masks) and the two test sources (patch grids over slides, ROI images
or h5 patches for ``test_seg --draw_masks/--detect``; point-annotated images
for its point evaluation).

Masks come as an array [N, H, W] (nonzero = positive) or as a pseudomask
directory holding ``mask/<n>.png`` files (read with ``cv2``, imported only
then, in natural file order, > 127 = positive). Images come from a LYSTO h5
file (``h5py`` imported only then) or, through ``from_arrays``, from
memory. Random flips are the trainer's, drawn per epoch when ``augment``.
Image files are read with ``cv2`` (``openslide`` for slides), imported where
a file is read; every source also has a ``from_arrays`` constructor that
reads nothing.
"""

from __future__ import annotations

import csv
import os
from typing import Optional, Sequence

import numpy as np

from cellsegmentation_tpu_torch.data.lysto import _load_h5
from cellsegmentation_tpu_torch.ops.tiles import tile_grid
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


def _read_rgb(path: str) -> np.ndarray:
    import cv2

    return cv2.imread(path, cv2.IMREAD_COLOR)[..., ::-1].copy()  # BGR -> RGB


def _after_resume(names: Sequence[str], resume_from: Optional[str]) -> list[str]:
    """``names`` from ``resume_from`` on (all of them without one)."""
    if resume_from is None:
        return list(names)
    names = list(names)
    return names[names.index(resume_from):] if resume_from in names else []


class MaskTestSource:
    """Patch grid over slides (``.svs``/``.tiff``), ROI images
    (``.jpg``/``.png``) or an h5 file of patches.

    ``patch_index`` lists (file index, x, y) patch corners: a grid of stride
    ``patch_size - 16`` with border completion per file, or one patch at
    (0, 0) for an image smaller than the patch (zero-padded by
    ``get_patch``) and for every h5 image. ``resume_from`` skips the files
    before the named one. Files load lazily, the last one cached. In h5
    mode the files are named ``<i+1:05>.h5img``, so detection writes its
    outputs alike for every kind of source."""

    WSI_EXT = (".svs", ".tiff")
    ROI_EXT = (".jpg", ".png")

    def __init__(self, filepath: str, patch_size: int = 299,
                 resume_from: Optional[str] = None, num_of_imgs: int = 0):
        self.filepath = filepath
        self._arrays = None
        if os.path.isdir(filepath):
            entries = sort_files([f for f in os.listdir(filepath)
                                  if f.lower().endswith(self.WSI_EXT + self.ROI_EXT)])
            if num_of_imgs:
                entries = entries[:num_of_imgs]
            files = _after_resume(entries, resume_from)
            mode = ("wsi" if files and files[0].lower().endswith(self.WSI_EXT)
                    else "roi")
            self._setup(mode, files, [self._file_hw(f) for f in files], patch_size)
        elif filepath.endswith(".h5"):
            images, organs, _ = _load_h5(filepath, num_of_imgs)
            self.images = images
            self.organs = organs
            self._setup("h5", [f"{i + 1:05}.h5img" for i in range(len(images))],
                        [images.shape[1:3]] * len(images), patch_size)
        else:
            raise ValueError(f"unsupported test path: {filepath}")

    @classmethod
    def from_arrays(cls, images: Sequence[np.ndarray],
                    names: Optional[Sequence[str]] = None, patch_size: int = 299,
                    resume_from: Optional[str] = None) -> "MaskTestSource":
        """ROI mode over in-memory RGB uint8 images [H_i, W_i, 3] of any
        sizes, named ``names`` (``<i+1:05>.png`` by default)."""
        names = list(names) if names is not None else [
            f"{i + 1:05}.png" for i in range(len(images))]
        if len(names) != len(images):
            raise ValueError(f"{len(names)} names for {len(images)} images")
        files = _after_resume(names, resume_from)
        by_name = dict(zip(names, images))
        src = cls.__new__(cls)
        src.filepath = None
        src._arrays = [np.asarray(by_name[f]) for f in files]
        src._setup("roi", files, [a.shape[:2] for a in src._arrays], patch_size)
        return src

    def _setup(self, mode, files, sizes, patch_size) -> None:
        self.mode = mode
        self.files = list(files)
        self.patch_size = patch_size
        self.stride = patch_size - 16
        self.image_sizes = [tuple(int(v) for v in hw) for hw in sizes]
        self.patch_index = []
        for fi, (h, w) in enumerate(self.image_sizes):
            grid = [(0, 0)] if mode == "h5" else self._grid(h, w)
            self.patch_index += [(fi, int(x), int(y)) for x, y in grid]
        self._cache: tuple = (None, None)

    def _file_hw(self, fname: str) -> tuple[int, int]:
        path = os.path.join(self.filepath, fname)
        if fname.lower().endswith(self.WSI_EXT):
            import openslide  # only slides need it

            with openslide.OpenSlide(path) as slide:
                w, h = slide.dimensions
            return h, w
        return _read_rgb(path).shape[:2]

    def _grid(self, h: int, w: int):
        """Window corners with border completion; one full-image patch for
        an image smaller than the patch."""
        if h < self.patch_size or w < self.patch_size:
            return [(0, 0)]
        return [tuple(c) for c in tile_grid(h, w, self.patch_size, self.stride)]

    def __len__(self) -> int:
        return len(self.patch_index)

    @property
    def image_hw(self) -> tuple[int, int]:
        return (self.patch_size, self.patch_size)

    def load_file(self, file_idx: int) -> np.ndarray:
        """The RGB pixels of one source file (the last one cached)."""
        if self.mode == "h5":
            return self.images[file_idx]
        if self._cache[0] == file_idx:
            return self._cache[1]
        if self._arrays is not None:
            img = self._arrays[file_idx]
        else:
            path = os.path.join(self.filepath, self.files[file_idx])
            if self.mode == "wsi":
                import openslide

                with openslide.OpenSlide(path) as slide:
                    img = np.asarray(slide.read_region(
                        (0, 0), 0, slide.dimensions).convert("RGB"))
            else:
                img = _read_rgb(path)
        self._cache = (file_idx, img)
        return img

    def get_patch(self, patch_idx: int) -> np.ndarray:
        fi, x, y = self.patch_index[patch_idx]
        img = self.load_file(fi)
        ps = self.patch_size
        patch = img[x : x + ps, y : y + ps]
        if patch.shape[:2] != (ps, ps):  # a small ROI: zero-pad to the patch
            pad = np.zeros((ps, ps, 3), dtype=patch.dtype)
            pad[: patch.shape[0], : patch.shape[1]] = patch
            patch = pad
        return patch


class PointTestSource:
    """Point-annotated evaluation images: ``<root>/images/*.png``, optional
    ``<root>/masks/*.png`` (> 127 = positive), ``<root>/points/<name>.tsv``
    rows of ``x<TAB>y``, and ``<root>/image_type.csv`` rows of (name, cancer
    type, area type); names in natural order."""

    def __init__(self, root: str, num_of_imgs: int = 0):
        import cv2

        img_dir = os.path.join(root, "images")
        names = sort_files([f for f in os.listdir(img_dir) if f.endswith(".png")])
        if num_of_imgs:
            names = names[:num_of_imgs]
        images = np.stack([_read_rgb(os.path.join(img_dir, n)) for n in names])
        mask_dir = os.path.join(root, "masks")
        masks = None
        if os.path.isdir(mask_dir):
            masks = np.stack([
                cv2.imread(os.path.join(mask_dir, n), cv2.IMREAD_GRAYSCALE) > 127
                for n in names])
        points = []
        for n in names:
            tsv = os.path.join(root, "points", os.path.splitext(n)[0] + ".tsv")
            points.append(np.loadtxt(tsv, delimiter="\t", ndmin=2)
                          if os.path.exists(tsv) else None)
        cancer_types, area_types = {}, {}
        type_csv = os.path.join(root, "image_type.csv")
        if os.path.exists(type_csv):
            with open(type_csv) as f:
                for row in csv.reader(f):
                    if len(row) >= 3:
                        cancer_types[row[0]] = row[1]
                        area_types[row[0]] = row[2]
        self.root = root
        self._setup(names, images, points, masks, cancer_types, area_types)

    @classmethod
    def from_arrays(cls, names: Sequence[str], images: np.ndarray, points,
                    masks: Optional[np.ndarray] = None,
                    cancer_types: Optional[dict] = None,
                    area_types: Optional[dict] = None) -> "PointTestSource":
        """The same source from memory: RGB uint8 ``images`` [N, H, W, 3],
        one [K, 2] (x, y) array (or None) per image in ``points``."""
        src = cls.__new__(cls)
        src.root = None
        src._setup(list(names), np.asarray(images), points, masks,
                   dict(cancer_types or {}), dict(area_types or {}))
        return src

    def _setup(self, names, images, points, masks, cancer_types, area_types):
        self.names = names
        self.images = images
        self.masks = None if masks is None else (np.asarray(masks) > 0).astype(np.uint8)
        self.points = [np.zeros((0, 2), dtype=np.int64) if p is None
                       else np.asarray(p).reshape(-1, 2).astype(np.int64)
                       for p in points]
        self.cancer_types = cancer_types
        self.area_types = area_types
        self.flip_code = np.zeros(len(self.images), dtype=np.int32)
        self.base_idx = np.arange(len(self.images))

    def __len__(self) -> int:
        return len(self.images)

    @property
    def image_hw(self) -> tuple[int, int]:
        return self.images.shape[1], self.images.shape[2]
