from cellsegmentation_tpu_torch.data.batches import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    BatchIterator,
    normalize_images,
)
from cellsegmentation_tpu_torch.data.lysto import (
    EnsembleSource,
    LystoDataSource,
    LystoTestSource,
    SubsetSource,
)
from cellsegmentation_tpu_torch.data.masks import (
    MaskDataSource,
    MaskTestSource,
    PointTestSource,
)
from cellsegmentation_tpu_torch.data.synthetic import (
    make_synthetic_arrays,
    make_synthetic_h5,
)

__all__ = [
    "LystoDataSource",
    "LystoTestSource",
    "EnsembleSource",
    "SubsetSource",
    "MaskDataSource",
    "MaskTestSource",
    "PointTestSource",
    "BatchIterator",
    "normalize_images",
    "IMAGENET_MEAN",
    "IMAGENET_STD",
    "make_synthetic_arrays",
    "make_synthetic_h5",
]
