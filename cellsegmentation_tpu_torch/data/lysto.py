"""LYSTO sources: the training/validation source, its k-fold ensemble
views, and the unlabeled test source.

- k-fold split by ``(i+1) % kfold``: fold members are the validation set;
- the organ filter compares the prefix before '_';
- augmentation stores *flip codes*, not image copies: one uint8 copy of each
  image plus an index table (base_idx, flip_code), flips run on the device;
- hard-example resampling mutates the same index table.

A source is built from an h5 file (``h5py`` is imported only then) or,
through ``from_arrays``, from in-memory arrays with the same split, organ
and augment logic.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from cellsegmentation_tpu_torch.ops.categorize import categorize_np


def _load_h5(filepath: str, num_of_imgs: int = 0):
    import h5py

    with h5py.File(filepath, "r") as f:
        n = f["x"].shape[0]
        if num_of_imgs:
            n = min(n, num_of_imgs)
        images = np.asarray(f["x"][:n])
        organs = [o.decode("utf-8") for o in f["organ"][:n]]
        counts = np.asarray(f["y"][:n]) if "y" in f else None
    return images, organs, counts


class LystoDataSource:
    """Exposes ``images`` (uint8, one copy per base image) plus per-sample
    index tables ``base_idx``/``flip_code`` and ``labels``. Batches are
    assembled as ``images[base_idx[sel]]`` on the host."""

    FLIP_NONE, FLIP_H, FLIP_V, FLIP_HV = 0, 1, 2, 3

    def __init__(
        self,
        filepath: str,
        train: bool = True,
        kfold: Optional[int] = 10,
        organ: Optional[str] = None,
        augment: bool = False,
        shuffle: bool = False,
        num_of_imgs: int = 0,
        seed: int = 0,
    ):
        images, organs, counts = _load_h5(filepath, num_of_imgs)
        if counts is None:
            raise ValueError(f"{filepath} has no 'y' labels")
        self._setup(images, organs, counts, train, kfold, organ, augment,
                    shuffle, seed)

    @classmethod
    def from_arrays(
        cls,
        images: np.ndarray,
        organs: Sequence,
        counts: np.ndarray,
        train: bool = True,
        kfold: Optional[int] = 10,
        organ: Optional[str] = None,
        augment: bool = False,
        shuffle: bool = False,
        seed: int = 0,
    ) -> "LystoDataSource":
        """The same source from arrays; ``organs`` may be str or bytes."""
        organs = [o.decode("utf-8") if isinstance(o, bytes) else o for o in organs]
        src = cls.__new__(cls)
        src._setup(np.asarray(images), organs, np.asarray(counts), train,
                   kfold, organ, augment, shuffle, seed)
        return src

    def _setup(self, images, organs, counts, train, kfold, organ, augment,
               shuffle, seed) -> None:
        if kfold is not None and kfold <= 0:
            raise ValueError("kfold must be positive or None")
        keep = []
        for i in range(len(images)):
            if kfold is not None:
                in_val = (i + 1) % kfold == 0
                if (train and in_val) or (not train and not in_val):
                    continue
            if organ is not None and organs[i].partition("_")[0] != organ:
                continue
            keep.append(i)
        keep = np.asarray(keep, dtype=np.int64)

        self.images = images[keep]
        self.organs = [organs[i] for i in keep]
        base_counts = counts[keep].astype(np.int64)

        n_base = len(keep)
        reps = 4 if (train and augment) else 1
        # sample table: every base image, then its 3 flipped variants
        self.base_idx = np.tile(np.arange(n_base), reps)
        self.flip_code = np.repeat(np.arange(reps), n_base).astype(np.int32)
        self.labels = np.tile(base_counts, reps)
        self.train = train
        self.augment = augment
        self._rng = np.random.default_rng(seed)

        if shuffle:
            order = self._rng.permutation(len(self.base_idx))
            self.base_idx = self.base_idx[order]
            self.flip_code = self.flip_code[order]
            self.labels = self.labels[order]

    def __len__(self) -> int:
        return len(self.base_idx)

    @property
    def cls_labels(self) -> np.ndarray:
        return categorize_np(self.labels)

    @property
    def image_hw(self) -> tuple[int, int]:
        return self.images.shape[1], self.images.shape[2]

    def gather_images(self, sample_indices: Sequence[int]) -> np.ndarray:
        """Host gather of the uint8 images for a set of samples."""
        sample_indices = np.asarray(sample_indices)
        return self.images[self.base_idx[sample_indices]]

    # ---- hard-example resampling -------------------------------------------
    def random_delete(self, num: int) -> None:
        """Drop ``num`` random samples from the index table."""
        idx = self._rng.choice(len(self.base_idx), num, replace=False)
        mask = np.ones(len(self.base_idx), dtype=bool)
        mask[idx] = False
        self.base_idx = self.base_idx[mask]
        self.flip_code = self.flip_code[mask]
        self.labels = self.labels[mask]

    def add_samples(self, sample_indices: Sequence[int]) -> None:
        """Duplicate existing samples (hard examples) into the table."""
        sample_indices = np.asarray(sample_indices)
        self.append_rows(
            self.base_idx[sample_indices],
            self.flip_code[sample_indices],
            self.labels[sample_indices],
        )

    def snapshot_rows(self, sample_indices: Sequence[int]):
        """Copy (base_idx, flip, label) rows — safe across later mutation."""
        sample_indices = np.asarray(sample_indices)
        return (
            self.base_idx[sample_indices].copy(),
            self.flip_code[sample_indices].copy(),
            self.labels[sample_indices].copy(),
        )

    def append_rows(self, base_idx, flip_code, labels) -> None:
        self.base_idx = np.concatenate([self.base_idx, base_idx])
        self.flip_code = np.concatenate([self.flip_code, flip_code])
        self.labels = np.concatenate([self.labels, labels])


class SubsetSource:
    """A sample-index view over a LystoDataSource sharing its image stack."""

    def __init__(self, base: LystoDataSource, sample_indices: Sequence[int]):
        sample_indices = np.asarray(sample_indices, dtype=np.int64)
        self.images = base.images  # shared, not copied
        self.base_idx = base.base_idx[sample_indices]
        self.flip_code = base.flip_code[sample_indices]
        self.labels = base.labels[sample_indices]
        self.organs = [base.organs[base.base_idx[i]] for i in sample_indices]

    def __len__(self) -> int:
        return len(self.base_idx)

    @property
    def cls_labels(self) -> np.ndarray:
        return categorize_np(self.labels)

    @property
    def image_hw(self) -> tuple[int, int]:
        return self.images.shape[1], self.images.shape[2]

    def gather_images(self, sample_indices: Sequence[int]) -> np.ndarray:
        sample_indices = np.asarray(sample_indices)
        return self.images[self.base_idx[sample_indices]]


class EnsembleSource:
    """k-fold bagging splits: one LystoDataSource over every image (no
    validation fold of its own) and per-fold contiguous validation blocks,
    the first ``N % k`` of ceil(N/k) samples and the rest of floor(N/k)
    (``divmod``). ``fold(i)`` returns (train view, validation view), both
    sharing the one image stack."""

    def __init__(self, filepath: str, k: int = 10, augment: bool = False,
                 num_of_imgs: int = 0, seed: int = 0):
        self._setup(LystoDataSource(filepath, train=True, kfold=None,
                                    augment=augment, num_of_imgs=num_of_imgs,
                                    seed=seed), k)

    @classmethod
    def from_arrays(cls, images: np.ndarray, organs: Sequence, counts: np.ndarray,
                    k: int = 10, augment: bool = False,
                    seed: int = 0) -> "EnsembleSource":
        """The same splits over arrays; ``organs`` may be str or bytes."""
        src = cls.__new__(cls)
        src._setup(LystoDataSource.from_arrays(images, organs, counts, train=True,
                                               kfold=None, augment=augment,
                                               seed=seed), k)
        return src

    def _setup(self, data: LystoDataSource, k: int) -> None:
        self.data = data
        self.k = k
        size, extra = divmod(len(data), k)
        bounds = [0]
        for i in range(k):
            bounds.append(bounds[-1] + size + (1 if i < extra else 0))
        self._bounds = bounds

    def fold(self, idx: int) -> tuple[SubsetSource, SubsetSource]:
        lo, hi = self._bounds[idx], self._bounds[idx + 1]
        val_idx = np.arange(lo, hi)
        train_idx = np.concatenate([np.arange(0, lo), np.arange(hi, self._bounds[-1])])
        return SubsetSource(self.data, train_idx), SubsetSource(self.data, val_idx)


class LystoTestSource:
    """Unlabeled test source over ``test.h5``, optionally one organ's
    images; ``ids`` are the images' 1-based positions in the file, and
    ``labels`` the file's counts when it has any (else None)."""

    def __init__(self, filepath: str, organ: Optional[str] = None,
                 num_of_imgs: int = 0):
        images, organs, counts = _load_h5(filepath, num_of_imgs)
        self._setup(images, organs, counts, organ)

    @classmethod
    def from_arrays(cls, images: np.ndarray, organs: Sequence,
                    counts: Optional[np.ndarray] = None,
                    organ: Optional[str] = None) -> "LystoTestSource":
        """The same source from arrays; ``organs`` may be str or bytes."""
        organs = [o.decode("utf-8") if isinstance(o, bytes) else o for o in organs]
        src = cls.__new__(cls)
        src._setup(np.asarray(images), organs,
                   None if counts is None else np.asarray(counts), organ)
        return src

    def _setup(self, images, organs, counts, organ) -> None:
        keep = np.asarray([i for i in range(len(images))
                           if organ is None or organs[i].partition("_")[0] == organ],
                          dtype=np.int64)
        self.images = images[keep]
        self.organs = [organs[i] for i in keep]
        self.ids = keep + 1
        self.labels = counts[keep] if counts is not None else None

    def __len__(self) -> int:
        return len(self.images)

    @property
    def image_hw(self) -> tuple[int, int]:
        return self.images.shape[1], self.images.shape[2]
