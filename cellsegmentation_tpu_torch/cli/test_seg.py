"""Stage-3 evaluation CLI, the JAX package's ``test_seg`` flags and
outputs, in four modes:

- ``--draw_masks``: mask overlays ``test_<n:05>.png`` over the patches of
  an h5 file, ROI images or slides (``--soft_mask``: the kept probs and a
  JET overlay);
- ``--detect``: detection over ROI images or slides: stitched masks,
  counts from the image head, mean-shift localization and the
  (image_id, x, y) CSV, with crash rollback and ``--resume_from``;
- default: the point-annotated evaluation, dice and point P/R/F1 per image
  (``center.csv``), bucketed by ``--cancer_type`` or ``--area_type``;
  ``--parity_prf1`` reports P/R/F1 as 0, as the reference does;
- ``--test_qupath``: QuPath GeoJSON detections scored with the same
  metrics.

Usage:
    python -m cellsegmentation_tpu_torch.cli.test_seg -m pt3.ckpt --draw_masks
    python -m cellsegmentation_tpu_torch.cli.test_seg -m pt3.ckpt --detect --smooth_method gaussianblur
    python -m cellsegmentation_tpu_torch.cli.test_seg -m pt3.ckpt --data_path point_root
"""

from __future__ import annotations

import argparse
import csv
import json
import os

import numpy as np
import torch

from cellsegmentation_tpu_torch.cli import common
from cellsegmentation_tpu_torch.core.device import resolve_device
from cellsegmentation_tpu_torch.data.masks import MaskTestSource, PointTestSource
from cellsegmentation_tpu_torch.detect import (
    MetricGroup,
    cell_detect,
    get_prf1,
    meanshift_cluster,
)
from cellsegmentation_tpu_torch.ops.losses import dice_coef
from cellsegmentation_tpu_torch.postprocess import (
    crop_wsi,
    overlap_mask,
    remove_small_regions,
    save_images_with_masks,
)
from cellsegmentation_tpu_torch.train.steps import (
    make_image_infer_step,
    make_seg_infer_step,
)
from cellsegmentation_tpu_torch.utils.images import write_png


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="pt.3 evaluation: segmentation & detection")
    parser.add_argument("-m", "--model", type=str, required=True)
    parser.add_argument("-B", "--batch_size", type=int, default=8)
    parser.add_argument("-c", "--threshold", type=float, default=0.5)
    parser.add_argument("--draw_masks", action="store_true")
    parser.add_argument("--detect", action="store_true")
    parser.add_argument("--test_qupath", type=str, default=None,
                        help="directory of QuPath GeoJSON detections")
    parser.add_argument("--smooth_method", type=str, default="gaussianblur",
                        choices=["gaussianblur", "distancetransform"])
    parser.add_argument("--eps", type=float, default=15)
    parser.add_argument("--reg_limit", action="store_true")
    parser.add_argument("--soft_mask", action="store_true")
    parser.add_argument("--cancer_type", action="store_true",
                        help="bucket point-eval metrics by cancer type")
    parser.add_argument("--area_type", action="store_true",
                        help="bucket point-eval metrics by area type")
    parser.add_argument("--parity_prf1", action="store_true",
                        help="reference parity: report P/R/F1 as 0")
    parser.add_argument("--resume_from", type=str, default=None)
    parser.add_argument("-o", "--output", type=str, default="./output")
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--data_path", type=str, default=None)
    parser.add_argument("--f32", action="store_true")
    common.add_device_arg(parser)
    parser.add_argument("-w", "--workers", type=int, default=4)
    return parser


def point_eval(args, model, testset: PointTestSource, device) -> None:
    """The point-annotated evaluation of ``model`` over ``testset``: per
    image the seg mask and the count, dice against the ground-truth mask,
    the localized centres matched to the ground-truth points; writes
    ``center.csv`` and the ``predict_mask_binary/`` and ``predict_mask/``
    PNGs under ``args.output`` and prints the averages."""
    device = resolve_device(device)
    seg_infer = make_seg_infer_step(model, device=device)
    image_infer = make_image_infer_step(model, device=device)
    os.makedirs(args.output, exist_ok=True)

    if args.cancer_type:
        metrics = {k: MetricGroup() for k in ("breast", "colon", "prostate")}
        bucket_of = lambda name: testset.cancer_types.get(name, "colon")  # noqa: E731
    elif args.area_type:
        metrics = {k: MetricGroup() for k in ("regular", "clustered", "artifact")}
        bucket_of = lambda name: testset.area_types.get(name, "regular")  # noqa: E731
    else:
        metrics = MetricGroup()
        bucket_of = None

    bin_dir = os.path.join(args.output, "predict_mask_binary")
    ovl_dir = os.path.join(args.output, "predict_mask")
    os.makedirs(bin_dir, exist_ok=True)
    os.makedirs(ovl_dir, exist_ok=True)
    with open(os.path.join(args.output, "center.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["id", "count", "tp", "fp", "fn", "p", "r", "f1", "dice"])
        for i in range(len(testset)):
            image = torch.as_tensor(testset.images[i : i + 1]).to(device)
            flip = torch.zeros((1,), dtype=torch.int32, device=device)
            mask_hat = seg_infer(image, flip).cpu().numpy()[0]
            _, counts = image_infer(image, flip)
            count = int(np.round(float(counts.cpu().numpy()[0])))
            if args.reg_limit and count == 0:
                mask_hat = 0 * mask_hat

            classes = remove_small_regions(mask_hat > args.threshold,
                                           min_object_size=300,
                                           hole_area_threshold=100)
            gt_mask = (testset.masks[i].astype(np.float32)
                       if testset.masks is not None
                       else np.zeros_like(classes, dtype=np.float32))
            dice = float(dice_coef(torch.from_numpy(classes.astype(np.float32)),
                                   torch.from_numpy(gt_mask)))

            if args.parity_prf1:
                p = r = f1 = tp = fp = fn = 0
            else:
                kept, _ = meanshift_cluster(
                    np.uint8(mask_hat * 255), args.smooth_method,
                    cell_count=count if args.reg_limit else None, eps=args.eps)
                pred_points = np.asarray([(y, x) for (x, y) in kept])
                p, r, f1, tp, fp, fn = get_prf1(pred_points, testset.points[i])

            name = testset.names[i]
            if bucket_of is not None:
                metrics[bucket_of(name)].update([p, r, f1, dice])
            else:
                metrics.update([p, r, f1, dice])
            w.writerow([name, count, tp, fp, fn, p, r, f1, dice])

            write_png(os.path.join(bin_dir, name), (classes * 255).astype(np.uint8))
            overlap_mask(testset.images[i].copy(), classes, postprocess=False,
                         save=os.path.join(ovl_dir,
                                           os.path.splitext(name)[0] + f"_{count}.png"))

    if isinstance(metrics, dict):
        for k, g in metrics.items():
            print(f"{k}: P={g.P.avg:.4f} R={g.R.avg:.4f} F1={g.F1.avg:.4f} "
                  f"dice={g.dice.avg:.4f}")
    else:
        print(f"Average Precision: {metrics.P.avg}\nAverage Recall: {metrics.R.avg}\n"
              f"Average F1: {metrics.F1.avg}\nAverage Dice: {metrics.dice.avg}")


def _qupath_points(geojson_path: str) -> np.ndarray:
    """Detection centroids of a QuPath GeoJSON export."""
    with open(geojson_path) as f:
        data = json.load(f)
    feats = data["features"] if isinstance(data, dict) else data
    pts = []
    for feat in feats:
        geom = feat.get("geometry", {})
        if geom.get("type") == "Point":
            pts.append(geom["coordinates"][:2])
        elif geom.get("type") == "Polygon":
            ring = np.asarray(geom["coordinates"][0], dtype=float)
            pts.append(ring.mean(axis=0)[:2])
    return np.asarray(pts, dtype=float).reshape(-1, 2)


def score_qupath(args, testset: PointTestSource) -> None:
    """QuPath's detections scored with the same matching, into
    ``qupath-center.csv``."""
    metrics = MetricGroup()
    os.makedirs(args.output, exist_ok=True)
    with open(os.path.join(args.output, "qupath-center.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["id", "tp", "fp", "fn", "p", "r", "f1"])
        for i, name in enumerate(testset.names):
            gj = os.path.join(args.test_qupath, os.path.splitext(name)[0] + ".geojson")
            pred = _qupath_points(gj) if os.path.exists(gj) else np.zeros((0, 2))
            p, r, f1, tp, fp, fn = get_prf1(pred, testset.points[i])
            metrics.update([p, r, f1, 0.0])
            w.writerow([name, tp, fp, fn, p, r, f1])
    print(f"QuPath baseline — P={metrics.P.avg:.4f} R={metrics.R.avg:.4f} "
          f"F1={metrics.F1.avg:.4f}")


def draw_masks(args, model, testset: MaskTestSource, device) -> None:
    """Seg-mask overlays of every patch, streamed in batches (a slide's
    patches do not fit in memory)."""
    device = resolve_device(device)
    seg_infer = make_seg_infer_step(model, device=device)
    os.makedirs(args.output, exist_ok=True)
    for s in range(0, len(testset), args.batch_size):
        chunk = np.stack([testset.get_patch(i)
                          for i in range(s, min(s + args.batch_size, len(testset)))])
        m = seg_infer(torch.as_tensor(chunk).to(device),
                      torch.zeros((len(chunk),), dtype=torch.int32,
                                  device=device)).cpu().numpy()
        save_images_with_masks(list(chunk), list(m), args.threshold, args.output,
                               soft=args.soft_mask, start_index=s)


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if args.data_path is None:
        args.data_path = common.resolve_data_path(args)
    num = 1 if args.debug else 0
    if args.test_qupath:
        score_qupath(args, PointTestSource(args.data_path, num_of_imgs=num))
        return

    dev = common.device_of(args)
    model, _ = common.load_stage_checkpoint(args.model, args)
    if args.draw_masks or args.detect:
        src_path = args.data_path
        if not src_path.endswith(".h5") and os.path.isdir(src_path):
            crop_wsi(src_path)
        testset = MaskTestSource(src_path, resume_from=args.resume_from,
                                 num_of_imgs=20 if args.debug else 0)
        if args.detect:
            out = cell_detect(
                testset, make_seg_infer_step(model, device=dev),
                make_image_infer_step(model, device=dev),
                batch_size=args.batch_size, output_path=args.output,
                method=args.smooth_method, eps=args.eps,
                resume=args.resume_from is not None, device=dev)
            print(f"Detection results saved in '{out}'.")
        else:
            draw_masks(args, model, testset, dev)
        return
    point_eval(args, model, PointTestSource(args.data_path, num_of_imgs=num), dev)


if __name__ == "__main__":
    main()
