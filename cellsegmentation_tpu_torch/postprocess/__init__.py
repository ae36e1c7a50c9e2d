"""Host post-processing of the stage-3 pseudo-masks: block painting, the
V-channel refinement and small-region morphology."""

from cellsegmentation_tpu_torch.postprocess.masks import (
    generate_masks,
    paint_tile_blocks,
    preprocess_masks,
    preprocess_masks_batch,
    save_mask_pairs,
)
from cellsegmentation_tpu_torch.postprocess.morphology import (
    remove_small_holes,
    remove_small_objects,
    remove_small_regions,
    remove_small_regions_batch,
)

__all__ = [
    "generate_masks",
    "paint_tile_blocks",
    "preprocess_masks",
    "preprocess_masks_batch",
    "save_mask_pairs",
    "remove_small_holes",
    "remove_small_objects",
    "remove_small_regions",
    "remove_small_regions_batch",
]
