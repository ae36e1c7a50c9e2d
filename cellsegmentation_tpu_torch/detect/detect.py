"""Cell detection over slides and ROI images: stream patches, stitch the
seg masks, localize cells, write a CSV.

Per batch of patches, one upload serves the seg step (P(positive) per
pixel) and the image step (the patch's cell count). Per source image: the
stitched ``255 * mask`` (later patches overwrite), the sum of its patches'
rounded counts, ``mask_<file>.png``, then mean-shift localization keeping
the top ``count`` centres as (image_id, x, y) rows, with the strip's x
offset added for slides split into ``<name>-<x>`` strips. On a crash the
current image's rows are dropped and the run resumes with ``resume_from``;
``resume`` appends to the newest CSV.
"""

from __future__ import annotations

import csv
import glob
import os
import time
import traceback
from typing import Optional

import numpy as np
import torch

from cellsegmentation_tpu_torch.core.device import resolve_device
from cellsegmentation_tpu_torch.data.masks import MaskTestSource
from cellsegmentation_tpu_torch.detect.cluster import meanshift_cluster
from cellsegmentation_tpu_torch.postprocess.masks import locate_cells
from cellsegmentation_tpu_torch.utils.images import write_png


def _strip_offset(image_file: str) -> tuple[str, int]:
    """'name-1234' -> ('name', 1234); other names have offset 0."""
    if image_file.find("-") > 0:
        base, xo = image_file.split("-", 1)
        try:
            return base, int(xo)
        except ValueError:
            return image_file, 0
    return image_file, 0


def _rollback(fpath: str, base: Optional[str]) -> None:
    """Drop every row of image ``base`` from the CSV at ``fpath``."""
    tmp_path = os.path.join(os.path.dirname(fpath), "tmp.csv")
    with open(fpath) as src, open(tmp_path, "w", newline="") as dst:
        w = csv.writer(dst)
        for row in csv.reader(src):
            if row and row[0] != base:
                w.writerow(row)
    os.replace(tmp_path, fpath)


def cell_detect(
    testset: MaskTestSource,
    seg_infer,  # (images u8, flip) -> [B, H, W] P(positive)
    image_infer,  # (images u8, flip) -> (cls_probs, counts)
    *,
    batch_size: int = 8,
    output_path: str = "./output",
    output_image: bool = True,
    method: str = "gaussianblur",
    eps: float = 15,
    resume: bool = False,
    device=None,
    **method_kwargs,
) -> str:
    """Detect cells in every patch of every file of ``testset`` on
    ``device`` (the CUDA card unless ``device="cpu"``); returns the CSV's
    path. ``output_image`` also writes each image with its kept (red) and
    discarded (blue) centres as ``<file>_<count>cells.png``."""
    dev = resolve_device(device)
    detect_path = os.path.join(output_path, "detect")
    os.makedirs(detect_path, exist_ok=True)
    if resume:
        fpath = sorted(glob.glob(os.path.join(detect_path, "*-location.csv")))[-1]
        f = open(fpath, "a", newline="")
        writer = csv.writer(f)
    else:
        fpath = os.path.join(detect_path,
                             time.strftime("%Y%m%d-%H%M%S") + "-location.csv")
        f = open(fpath, "w", newline="")
        writer = csv.writer(f)
        writer.writerow(["image_id", "x", "y"])

    ps = testset.patch_size
    current_file: Optional[int] = None
    whole_mask: Optional[np.ndarray] = None
    cell_count = 0.0

    def flush_image(file_idx: int) -> None:
        image_file = os.path.splitext(testset.files[file_idx])[0]
        write_png(os.path.join(detect_path, f"mask_{image_file}.png"), whole_mask)
        kept, discarded = meanshift_cluster(whole_mask, method, int(cell_count),
                                            eps=eps, **method_kwargs)
        base, xoffset = _strip_offset(image_file)
        for x, y in kept:
            writer.writerow([base, int(x) + xoffset, int(y)])
        f.flush()
        if output_image:
            slide = testset.load_file(file_idx).astype(np.uint8).copy()
            write_png(os.path.join(detect_path, f"{image_file}_{int(cell_count)}cells.png"),
                      locate_cells(slide, kept, discarded))

    try:
        n = len(testset)
        for start in range(0, n, batch_size):
            idxs = list(range(start, min(start + batch_size, n)))
            patches = torch.as_tensor(
                np.stack([testset.get_patch(i) for i in idxs])).to(dev)
            flip = torch.zeros((len(idxs),), dtype=torch.int32, device=dev)
            d_masks = seg_infer(patches, flip)
            _, d_counts = image_infer(patches, flip)
            masks = d_masks.cpu().numpy()
            counts = np.round(d_counts.cpu().numpy()).astype(int)

            for i, patch_idx in enumerate(idxs):
                file_idx, x, y = testset.patch_index[patch_idx]
                h, w = testset.image_sizes[file_idx]
                if current_file is None or file_idx != current_file:
                    if current_file is not None:
                        flush_image(current_file)
                    current_file = file_idx
                    whole_mask = np.zeros((h, w), dtype=np.uint8)
                    cell_count = 0.0
                mask_u8 = np.uint8(255 * masks[i])
                whole_mask[x : x + ps, y : y + ps] = mask_u8[
                    : max(0, min(ps, h - x)), : max(0, min(ps, w - y))]
                cell_count += counts[i]

        if current_file is not None:
            flush_image(current_file)
        f.close()
    except Exception:
        f.close()
        image_file = (os.path.splitext(testset.files[current_file])[0]
                      if current_file is not None else None)
        _rollback(fpath, _strip_offset(image_file)[0] if image_file else None)
        traceback.print_exc()
        print(f"Exception caught; partial results kept in '{fpath}'. "
              f"Rerun with --resume_from {image_file}.<ext> to continue.")
    return fpath
