"""Batched inference (stage-1 counts, the stage-2 tile sweep, the stage-3
drawing sweep and seg masks) and the adaptive top-k sampling step.

Host loops around the steps of train/steps.py. Device->host traffic is two
scalars per image for stage 1, one [N, T] prob matrix for stages 2 and
3's drawing, and one [H, W] prob map per image for the seg masks; the tile
images never leave the device. Each loop is
a 2-deep software pipeline: CUDA work is asynchronous, so batch i+1's upload
and compute are queued before batch i's probs are fetched, and the blocking
fetch overlaps the device's next batch.

Across processes (parallel/multihost.py) each rank sweeps a round-robin
share of the batches (``my_batches``) and the rows are merged at the end
(``merge_process_rows``), so every rank returns the whole result. The
steps must be process-local, with no collective: ranks take different
numbers of batches, so a collective there would deadlock.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from cellsegmentation_tpu_torch.core.device import resolve_device
from cellsegmentation_tpu_torch.data.batches import BatchIterator
from cellsegmentation_tpu_torch.ops.categorize import categorize_np, de_categorize_np
from cellsegmentation_tpu_torch.ops.tiles import tile_grid
from cellsegmentation_tpu_torch.ops.topk import adaptive_topk_mask
from cellsegmentation_tpu_torch.parallel.multihost import merge_process_rows, my_batches


def pipeline2(items, dispatch):
    """Yield (item, dispatch(item)) one batch BEHIND the dispatch order, so
    the consumer's blocking fetch of batch i overlaps batch i+1's device
    work. The generator flushes the last pending batch itself."""
    pending = None
    for item in items:
        res = dispatch(item)
        if pending is not None:
            yield pending
        pending = (item, res)
    if pending is not None:
        yield pending


def _my_batches(n: int, batch_size: int):
    """This process's round-robin share of the in-order batches over ``n``."""
    batches = list(BatchIterator(n, batch_size, shuffle=False))
    return [batches[b] for b in my_batches(len(batches))]


def _clean_counts(regs: np.ndarray) -> np.ndarray:
    """Round regressed counts, clamping diverged values (nan, inf, absurd)
    into [0, 1e6]."""
    return np.round(
        np.nan_to_num(regs, nan=0.0, posinf=1e6, neginf=0.0)
    ).clip(0, 1e6).astype(np.int64)


def apply_cls_limit(counts: np.ndarray, categories: np.ndarray) -> np.ndarray:
    """Clamp regressed counts into the predicted class's count range: a
    count whose bin is above the class snaps to the class's max, one below
    to its min."""
    counts = counts.astype(np.int64).copy()
    cat_of_count = categorize_np(counts)
    lo, hi = de_categorize_np(categories)
    counts = np.where(cat_of_count > categories, hi, counts)
    return np.where(cat_of_count < categories, lo, counts)


def inference_image(source, infer_step, batch_size: int = 64,
                    cls_limit: bool = False):
    """The image counter over a source: (categories [N], counts [N]) int64.

    ``infer_step`` is ``train.steps.make_image_infer_step(model)``:
    ``(images u8, flip) -> (probs [B, 7], counts [B])`` on the device.
    Counts are rounded with diverged values clamped (a nan or huge count
    must not poison the kappa downstream), then with ``cls_limit`` clamped
    into the predicted class's range."""
    n = len(source)
    flip = getattr(source, "flip_code", np.zeros(n, dtype=np.int32))
    base_idx = getattr(source, "base_idx", np.arange(n))
    categories = np.zeros(n, dtype=np.int64)
    counts = np.zeros(n, dtype=np.int64)
    idx_chunks, cat_chunks, cnt_chunks = [], [], []

    def dispatch(sv):
        sel, _ = sv
        return infer_step(source.images[base_idx[sel]], flip[sel])

    for (sel, valid), (d_probs, d_regs) in pipeline2(_my_batches(n, batch_size),
                                                     dispatch):
        keep = sel[valid]
        cat = d_probs.argmax(dim=1).cpu().numpy()[valid]
        cnt = _clean_counts(d_regs.cpu().numpy()[valid])
        categories[keep] = cat
        counts[keep] = cnt
        idx_chunks.append(keep)
        cat_chunks.append(cat)
        cnt_chunks.append(cnt)
    merge_process_rows([categories, counts], idx_chunks, [cat_chunks, cnt_chunks])

    if cls_limit:
        counts = apply_cls_limit(counts, categories)
    return categories, counts


def inference_tiles(
    source,
    infer_step,
    tile_size: int,
    interval: int,
    image_batch: int = 64,
) -> np.ndarray:
    """Dense per-tile P(positive) for every sample: returns [N, T] float32.

    ``infer_step`` is ``train.steps.make_tile_infer_step(model, tile_size,
    tile_grid(...))``; all images share the static grid."""
    h, w = source.image_hw
    n_t = tile_grid(h, w, tile_size, interval).shape[0]
    n = len(source)
    flip = getattr(source, "flip_code", np.zeros(n, dtype=np.int32))
    base_idx = getattr(source, "base_idx", np.arange(n))
    out = np.zeros((n, n_t), dtype=np.float32)
    idx_chunks, val_chunks = [], []

    def dispatch(sv):
        sel, _ = sv
        # flip stays a HOST array: the step sends flip-free batches to the
        # graph without flips after a cheap host check
        return infer_step(source.images[base_idx[sel]], flip[sel])

    for (sel, valid), d_probs in pipeline2(_my_batches(n, image_batch), dispatch):
        vals = d_probs.cpu().numpy()[valid]
        out[sel[valid]] = vals
        idx_chunks.append(sel[valid])
        val_chunks.append(vals)
    merge_process_rows([out], idx_chunks, [val_chunks])
    return out


def inference_seg(source, infer_step, batch_size: int = 16) -> np.ndarray:
    """Soft positive-class masks [N, H, W] float32 of every sample.

    ``infer_step`` is ``train.steps.make_seg_infer_step(model)``:
    ``(images u8, flip) -> P(positive) [B, H, W]`` on the device."""
    n = len(source)
    h, w = source.image_hw
    flip = getattr(source, "flip_code", np.zeros(n, dtype=np.int32))
    base_idx = getattr(source, "base_idx", np.arange(n))
    out = np.zeros((n, h, w), dtype=np.float32)

    def dispatch(sv):
        sel, _ = sv
        return infer_step(source.images[base_idx[sel]], flip[sel])

    batches = BatchIterator(n, batch_size, shuffle=False)
    for (sel, valid), d_masks in pipeline2(batches, dispatch):
        out[sel[valid]] = d_masks.cpu().numpy()[valid]
    return out


def iter_tiles_and_counts(source, tile_step, image_step, image_batch: int = 64,
                          device=None):
    """The stage-3 drawing sweep, per batch: yields (rows, probs, counts)
    one batch behind the device, ``rows`` the batch's valid sample indices,
    ``probs`` [B, T] f32 tile P(positive), ``counts`` [B] int64 (rounded,
    diverged values clamped).

    Each uint8 image batch crosses to ``device`` (the CUDA card unless
    ``device="cpu"``) once and serves both the tile step
    (``make_tile_infer_step``, given the host flip array for its flip-free
    check) and the count head (``make_image_infer_step``). Across processes
    it yields this rank's round-robin share of the batches only."""
    dev = resolve_device(device)
    n = len(source)
    flip = getattr(source, "flip_code", np.zeros(n, dtype=np.int32))
    base_idx = getattr(source, "base_idx", np.arange(n))

    def dispatch(sv):
        sel, _ = sv
        images = torch.as_tensor(source.images[base_idx[sel]]).to(dev)
        probs = tile_step(images, flip[sel])
        _, regs = image_step(images, torch.as_tensor(flip[sel]).to(dev))
        return probs, regs

    for (sel, valid), (d_probs, d_regs) in pipeline2(_my_batches(n, image_batch),
                                                     dispatch):
        yield (sel[valid], d_probs.cpu().numpy()[valid],
               _clean_counts(d_regs.cpu().numpy()[valid]))


def inference_tiles_and_counts(source, tile_step, image_step, tile_size: int,
                               interval: int, image_batch: int = 64, device=None):
    """The whole drawing sweep in one pass over the data: (probs [N, T] f32,
    counts [N] int64), ``inference_tiles`` and ``inference_image``'s counts
    at once (``iter_tiles_and_counts`` for the steps), every rank's rows
    merged. The multi-process draw uses it, which must hold every row to
    merge them."""
    h, w = source.image_hw
    n_t = tile_grid(h, w, tile_size, interval).shape[0]
    n = len(source)
    probs_out = np.zeros((n, n_t), dtype=np.float32)
    counts_out = np.zeros(n, dtype=np.int64)
    idx_chunks, val_chunks, cnt_chunks = [], [], []
    for rows, vals, cnt in iter_tiles_and_counts(source, tile_step, image_step,
                                                 image_batch=image_batch,
                                                 device=device):
        probs_out[rows] = vals
        counts_out[rows] = cnt
        idx_chunks.append(rows)
        val_chunks.append(vals)
        cnt_chunks.append(cnt)
    merge_process_rows([probs_out, counts_out], idx_chunks, [val_chunks, cnt_chunks])
    return probs_out, counts_out


def sample_topk(
    source,
    probs: np.ndarray,
    tile_size: int,
    interval: int,
    tiles_per_pos: int,
    topk_neg: int,
    pos_neg_ratio: Optional[float] = None,
    seed: int = 0,
    device=None,
) -> dict:
    """Adaptive top-k selection + pos/neg-ratio pruning -> stage-2 train data.

    Device: rank-mask top-k per image (ops/topk.py), on the CUDA card unless
    ``device="cpu"``. Host: tile labels binarized by the parent image's count
    and the majority class pruned to the requested ratio after a seeded
    shuffle.

    Returns {'img_idx', 'xs', 'ys', 'flip', 'label', 'n_pos', 'n_neg'}.
    """
    dev = resolve_device(device)
    h, w = source.image_hw
    coords = tile_grid(h, w, tile_size, interval)
    labels = source.labels
    mask = adaptive_topk_mask(
        torch.as_tensor(np.asarray(probs), device=dev),
        torch.as_tensor(labels, device=dev),
        tiles_per_pos, topk_neg,
    ).cpu().numpy()

    sample_idx, tile_idx = np.nonzero(mask)
    img_idx = source.base_idx[sample_idx].astype(np.int32)
    flip = source.flip_code[sample_idx].astype(np.int32)
    xs = coords[tile_idx, 0].astype(np.int32)
    ys = coords[tile_idx, 1].astype(np.int32)
    tlabel = (labels[sample_idx] > 0).astype(np.int32)

    order = np.random.default_rng(seed).permutation(len(tlabel))
    img_idx, flip, xs, ys, tlabel = (
        a[order] for a in (img_idx, flip, xs, ys, tlabel)
    )

    pos = int(tlabel.sum())
    neg = len(tlabel) - pos
    if pos_neg_ratio is not None:
        if pos > int(neg * pos_neg_ratio):
            excess, flag = pos - int(neg * pos_neg_ratio), 1
        elif neg > int(pos / pos_neg_ratio):
            excess, flag = neg - int(pos / pos_neg_ratio), 0
        else:
            excess, flag = 0, None
        if excess:
            drop = np.nonzero(tlabel == flag)[0][:excess]
            keep = np.ones(len(tlabel), dtype=bool)
            keep[drop] = False
            img_idx, flip, xs, ys, tlabel = (
                a[keep] for a in (img_idx, flip, xs, ys, tlabel)
            )
            pos = int(tlabel.sum())
            neg = len(tlabel) - pos

    return {
        "img_idx": img_idx,
        "xs": xs,
        "ys": ys,
        "flip": flip,
        "label": tlabel,
        "n_pos": pos,
        "n_neg": neg,
    }
