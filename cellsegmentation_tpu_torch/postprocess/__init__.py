"""Host post-processing: the stage-3 pseudo-masks (block painting, the
V-channel refinement, small-region morphology) and the images the
evaluation CLIs write (heatmaps, mask overlays, detected centres)."""

from cellsegmentation_tpu_torch.postprocess.masks import (
    crop_wsi,
    dotting,
    generate_masks,
    heatmap,
    locate_cells,
    overlap_mask,
    paint_tile_blocks,
    preprocess_masks,
    preprocess_masks_batch,
    save_images,
    save_images_with_masks,
    save_mask_pairs,
)
from cellsegmentation_tpu_torch.postprocess.morphology import (
    remove_small_holes,
    remove_small_objects,
    remove_small_regions,
    remove_small_regions_batch,
)

__all__ = [
    "crop_wsi",
    "dotting",
    "generate_masks",
    "heatmap",
    "locate_cells",
    "overlap_mask",
    "paint_tile_blocks",
    "preprocess_masks",
    "preprocess_masks_batch",
    "save_images",
    "save_images_with_masks",
    "save_mask_pairs",
    "remove_small_holes",
    "remove_small_objects",
    "remove_small_regions",
    "remove_small_regions_batch",
]
