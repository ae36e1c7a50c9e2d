"""Host-side epoch orchestration of stage 1 (image counting), the stage-2
MIL cycle and stage 3 (pseudo-mask drawing, seg-decoder training).

The steps (train/steps.py) do the math on the device; the host loop owns
the data-dependent control flow: the batches, stage 1's hard-example
resampling, stage 2's per-epoch sweep and selection, stage 3's per-epoch
flips, validation and checkpointing. Single-process: the multi-host split
comes with the ``parallel/`` slice of the port.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
import warnings
from typing import Optional

import numpy as np
import torch

from cellsegmentation_tpu_torch import infer
from cellsegmentation_tpu_torch.core.device import model_device
from cellsegmentation_tpu_torch.data.batches import BatchIterator
from cellsegmentation_tpu_torch.evaluate import evaluate_image, evaluate_tile
from cellsegmentation_tpu_torch.models.milnet import MILNet
from cellsegmentation_tpu_torch.ops.infer_engine import pick_calib_images
from cellsegmentation_tpu_torch.ops.tiles import tile_grid
from cellsegmentation_tpu_torch.ops.topk import topk_threshold_mask
from cellsegmentation_tpu_torch.train.checkpoint import save_checkpoint
from cellsegmentation_tpu_torch.train.schedules import make_schedule
from cellsegmentation_tpu_torch.train.state import TrainState, create_train_state
from cellsegmentation_tpu_torch.train.steps import (
    make_image_infer_step,
    make_image_train_step,
    make_seg_train_step,
    make_stack_tile_infer_step,
    make_tile_infer_step,
    make_tile_train_step,
)
from cellsegmentation_tpu_torch.utils.logging import RunLogger
from cellsegmentation_tpu_torch.utils.profiling import trace


@dataclasses.dataclass
class Stage1Result:
    state: TrainState
    last_metrics: Optional[tuple] = None  # (mAP, mse, qwk)
    # per epoch: host seconds of the train steps ("train") and of
    # validation plus hard-example scoring ("val"; each ends in a
    # device->host read), the steps taken ("steps") and the metric means
    # ("loss_cls", "loss_reg", "loss")
    epoch_stats: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Stage2Result:
    state: TrainState
    last_metrics: Optional[tuple] = None  # (err, fpr, fnr)
    # per-epoch selected tile sets ({'img_idx','xs','ys','flip','label'}),
    # recorded with train_stage2(record_selection=True)
    selections: Optional[list] = None
    # per epoch: host seconds of each phase ("sweep", "select", "train",
    # "val"; each ends in a device->host read), the tiles trained on
    # ("train_tiles") and the mean tile loss ("loss")
    epoch_stats: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Stage3Result:
    state: TrainState
    last_loss: Optional[float] = None
    # per epoch: host seconds of the train steps ("train", ending in a
    # device->host read), the steps taken ("steps") and the metric means
    # ("loss_ce", "loss_dice", "loss")
    epoch_stats: list = dataclasses.field(default_factory=list)


class _MetricsPipe:
    """Per-epoch metric means that fetch each step's device scalars one step
    late: batch i+1 is queued on the device before batch i's loss is read,
    so the blocking read never leaves the device idle."""

    def __init__(self):
        self.sums: dict = {}
        self.n = 0
        self._pending = None

    def push(self, metrics: dict) -> None:
        self._drain()
        self._pending = metrics
        self.n += 1

    def _drain(self) -> None:
        if self._pending is not None:
            for k, v in self._pending.items():
                self.sums[k] = self.sums.get(k, 0.0) + float(v)
            self._pending = None

    def means(self) -> dict:
        self._drain()
        return {k: v / max(self.n, 1) for k, v in self.sums.items()}


def _restore_optimizer(state: TrainState, resume_opt_state) -> None:
    """Load a checkpoint's optimizer state; one another optimizer or stage
    wrote is refused with a warning, and the run goes on with fresh state."""
    if resume_opt_state is None:
        return
    try:
        state.optimizer.load_state_dict(resume_opt_state)
    except ValueError as e:
        warnings.warn(
            "checkpoint optimizer state does not match this run's "
            f"optimizer ({e}); continuing with fresh optimizer state",
            stacklevel=3,
        )


def train_stage1(
    model: MILNet,
    train_source,
    val_source,
    *,
    epochs: int = 50,
    batch_size: int = 48,
    lr: float = 5e-4,
    weight_decay: float = 1e-4,
    scheduler: Optional[str] = None,
    test_every: int = 1,
    heads: str = "both",
    reg_loss: str = "mse",
    hard_threshold: Optional[float] = None,
    encoder_name: str = "resnet50",
    output_dir: Optional[str] = None,
    logger: Optional[RunLogger] = None,
    seed: int = 42,
    last_epoch: int = 0,
    resume_opt_state: Optional[dict] = None,
    device=None,
) -> Stage1Result:
    """Stage-1 image-count training: CE(cls) + MSE(reg) on whole images,
    the encoder and both heads in train mode.

    Per epoch: the shuffled batches through the image train step; every
    ``test_every`` epochs validation (0, MSE, QWK) through
    ``inference_image``; with ``hard_threshold``, the training pool scored
    and every sample whose rounded count misses its label by at least that
    much duplicated in place of as many random rows (the next epoch's
    iterator is seeded by the epoch); with ``output_dir``, an ``"image"``
    (pt1) checkpoint.

    The model carries the weights and is trained in place; it must live on
    ``device`` (the CUDA card unless ``device="cpu"``). The arguments are
    the JAX package's, without ``variables``, ``mesh`` and
    ``save_every_epoch`` (a checkpoint is written every epoch). Adam without a
    scheduler, SGD with one. Resuming (``last_epoch``) moves the step to
    ``last_epoch * steps_per_epoch`` and the shuffle stream past the done
    epochs; the dropout masks follow the step, so the run continues as a
    straight one would.
    """
    dev = model_device(model, device)
    logger = logger or RunLogger(output_dir or "./output")
    it = BatchIterator(len(train_source), batch_size, shuffle=True, seed=seed)
    steps_per_epoch = len(it)
    schedule = make_schedule(scheduler, lr, epochs, steps_per_epoch)
    stage = {"both": "image", "cls": "image_cls", "reg": "image_reg"}[heads]
    state = create_train_state(model, stage, schedule,
                               use_sgd=scheduler is not None,
                               weight_decay=weight_decay, device=dev)
    if last_epoch:
        state.step = last_epoch * steps_per_epoch
        it.fast_forward(last_epoch)
    _restore_optimizer(state, resume_opt_state)
    step_fn = make_image_train_step(model, heads=heads, reg_loss=reg_loss,
                                    seed=seed, device=dev)
    infer_fn = make_image_infer_step(model, device=dev)

    def save(epoch):
        save_checkpoint(output_dir, "image", epoch, encoder_name,
                        model.state_dict(), state.optimizer.state_dict(),
                        step=state.step)

    last_metrics = None
    epoch_stats = []
    for epoch in range(1 + last_epoch, epochs + 1):
        try:
            t0 = time.perf_counter()
            pipe = _MetricsPipe()
            cls_labels = train_source.cls_labels  # after any resampling
            # CST_PROFILE=1 records a torch.profiler trace of the first epoch
            prof = (trace(os.path.join(output_dir or ".", "profile"))
                    if epoch == 1 + last_epoch else contextlib.nullcontext())
            with prof:
                for sel, valid in it:
                    batch = {"images": train_source.gather_images(sel),
                             "flip": train_source.flip_code[sel],
                             "cls": cls_labels[sel],
                             "reg": train_source.labels[sel].astype(np.float32),
                             "valid": valid}
                    state, metrics = step_fn(state, batch)
                    pipe.push(metrics)
                means = pipe.means()  # waits for the last step
            t1 = time.perf_counter()
            logger.info(
                f"[stage1 epoch {epoch}/{epochs}] "
                + " | ".join(f"{k}: {v:.4f}" for k, v in means.items())
            )
            logger.csv_row(
                "image-training",
                ["epoch", "image_cls_loss", "image_reg_loss", "image_loss"],
                [epoch, means.get("loss_cls", 0), means.get("loss_reg", 0),
                 means.get("loss", 0)],
            )
            logger.scalars({f"image/{k}": v for k, v in means.items()}, epoch)

            if (val_source is not None and len(val_source) > 0
                    and epoch % test_every == 0):
                categories, counts = infer.inference_image(
                    val_source, infer_fn, batch_size=batch_size)
                m = evaluate_image(val_source.labels, categories, counts)
                last_metrics = m
                logger.info(f"  val mAP: {m[0]} | MSE: {m[1]:.3f} | QWK: {m[2]:.4f}")
                logger.csv_row("image-validation", ["epoch", "image_map", "mse", "qwk"],
                               [epoch, *m])
                logger.scalars({"val/mse": m[1], "val/qwk": m[2]}, epoch)

            if hard_threshold is not None:
                _, counts = infer.inference_image(train_source, infer_fn,
                                            batch_size=batch_size)
                hard = np.nonzero(
                    np.abs(counts - train_source.labels) >= hard_threshold)[0]
                if len(hard):
                    rows = train_source.snapshot_rows(hard)
                    train_source.random_delete(len(hard))
                    train_source.append_rows(*rows)
                    it = BatchIterator(len(train_source), batch_size,
                                       shuffle=True, seed=seed + epoch)
                    logger.info(f"  resampled {len(hard)} hard examples")
            t2 = time.perf_counter()
            epoch_stats.append({"train": t1 - t0, "val": t2 - t1,
                                "steps": pipe.n, **means})

            if output_dir:
                save(epoch)
        except KeyboardInterrupt:
            if output_dir:
                save(epoch)
            logger.info(f"interrupted at epoch {epoch}; checkpoint saved")
            raise

    return Stage1Result(state=state, last_metrics=last_metrics,
                        epoch_stats=epoch_stats)


def train_stage2(
    model: MILNet,
    train_source,
    val_source,
    *,
    epochs: int = 30,
    tile_batch_size: int = 40960,
    image_batch: int = 128,
    tile_size: int = 32,
    interval: int = 20,
    tiles_per_pos: int = 1,
    topk_neg: int = 30,
    pos_neg_ratio: Optional[float] = 0.5,
    threshold: float = 0.95,
    lr: float = 5e-5,
    weight_decay: float = 1e-4,
    scheduler: Optional[str] = None,
    test_every: int = 1,
    encoder_name: str = "resnet50",
    output_dir: Optional[str] = None,
    logger: Optional[RunLogger] = None,
    seed: int = 42,
    last_epoch: int = 0,
    resume_opt_state: Optional[dict] = None,
    infer_engine: str = "auto",
    record_selection: bool = False,
    w2_impl: str = "auto",
    device=None,
) -> Stage2Result:
    """Stage-2 MIL tile-classifier training, the adaptive top-k cycle.

    Per epoch: a dense tile sweep over every training sample → count-driven
    top-k selection and ratio pruning → cross-entropy training of ``fc_tile``
    on the selected tiles with the encoder frozen. Validation scores dense
    validation probs against count-derived tile labels. The checkpoint is
    written at the final epoch only.

    The model carries the weights and is trained in place; it must live on
    ``device`` (the CUDA card unless ``device="cpu"``). The arguments are
    the JAX package's, without its ``variables`` (the model holds them) and
    ``mesh``, plus ``w2_impl`` (the GEMM trunk's 3x3 form) and ``device``.
    The sweep engine is built once (the encoder is frozen for the whole
    cycle, so its folding and calibration stay valid; it reads ``fc_tile``
    at every call), and the training images cross to the device once.
    """
    dev = model_device(model, device)
    logger = logger or RunLogger(output_dir or "./output")
    h, w = train_source.image_hw
    coords = tile_grid(h, w, tile_size, interval)
    calib = (pick_calib_images(train_source.images)
             if infer_engine != "flax" else None)
    stack_infer_fn = make_stack_tile_infer_step(
        model, tile_size, coords, engine=infer_engine, calib_images=calib,
        device=dev, w2_impl=w2_impl,
    )
    infer_fn = stack_infer_fn.infer_step
    step_fn = make_tile_train_step(model, tile_size, device=dev)
    images_dev = torch.as_tensor(np.asarray(train_source.images)).to(dev)

    # the schedule is sized from a nominal epoch length: the real per-epoch
    # batch count varies with the selection
    nominal_steps = max(
        1, (len(train_source) * (topk_neg + 1)) // tile_batch_size
    )
    schedule = make_schedule(scheduler, lr, epochs, nominal_steps, t0=5)
    state = create_train_state(model, "tile", schedule,
                               use_sgd=scheduler is not None,
                               weight_decay=weight_decay, device=dev)
    _restore_optimizer(state, resume_opt_state)

    n_t = coords.shape[0]

    def dense_probs() -> np.ndarray:
        """[N, T] tile probs of every training sample, gathered from the
        device-resident stack, two batches in flight."""
        n = len(train_source)
        flip, base_idx = train_source.flip_code, train_source.base_idx
        out = np.zeros((n, n_t), dtype=np.float32)

        def dispatch(sv):
            sel, _ = sv
            return stack_infer_fn(images_dev, base_idx[sel], flip[sel])

        batches = BatchIterator(n, image_batch, shuffle=False)
        for (sel, valid), probs in infer.pipeline2(batches, dispatch):
            out[sel[valid]] = probs.cpu().numpy()[valid]
        return out

    last_metrics = None
    selections = [] if record_selection else None
    epoch_stats = []

    def save(epoch):
        save_checkpoint(output_dir, "tile", epoch, encoder_name,
                        model.state_dict(), state.optimizer.state_dict(),
                        step=state.step)

    for epoch in range(1 + last_epoch, epochs + 1):
        try:
            # realign the step to the epoch boundary: the schedule position
            # is the step, and the real batch count drifts from the nominal
            state.step = (epoch - 1) * nominal_steps
            t0 = time.perf_counter()
            # 1) dense inference over every training tile
            probs = dense_probs()
            t1 = time.perf_counter()
            # 2) adaptive top-k selection + ratio pruning
            train_data = infer.sample_topk(
                train_source, probs, tile_size, interval, tiles_per_pos,
                topk_neg, pos_neg_ratio, seed=seed + epoch, device=dev,
            )
            t2 = time.perf_counter()
            logger.info(
                f"[stage2 epoch {epoch}/{epochs}] sampled "
                f"pos={train_data['n_pos']} neg={train_data['n_neg']}"
            )
            if record_selection:
                selections.append({k: np.asarray(train_data[k]) for k in
                                   ("img_idx", "xs", "ys", "flip", "label")})
            # 3) cross-entropy training over the selected tiles; a fresh
            # iterator seeded by the epoch, so a resumed epoch replays the
            # same batches
            n_sel = len(train_data["label"])
            it = BatchIterator(n_sel, min(tile_batch_size, max(n_sel, 1)),
                               shuffle=True, seed=seed + epoch)
            pipe = _MetricsPipe()
            for sel, valid in it:
                batch = {k: train_data[k][sel]
                         for k in ("img_idx", "xs", "ys", "flip", "label")}
                batch["valid"] = valid
                state, metrics = step_fn(state, images_dev, batch)
                pipe.push(metrics)
            loss = pipe.means().get("loss", 0.0)  # waits for the last step
            t3 = time.perf_counter()
            logger.info(f"  tile loss: {loss:.4f}")
            logger.csv_row("tile-training", ["epoch", "tile_loss"], [epoch, loss])
            logger.scalar("tile/loss", loss, epoch)

            if (val_source is not None and len(val_source) > 0
                    and epoch % test_every == 0):
                val_probs = infer.inference_tiles(
                    val_source, infer_fn, tile_size, interval,
                    image_batch=image_batch,
                )
                m = evaluate_tile(val_source.labels, val_probs,
                                  tiles_per_pos, threshold)
                last_metrics = m
                logger.info(
                    f"  tile error: {m[0]:.4f} | FPR: {m[1]:.4f} | FNR: {m[2]:.4f}"
                )
                logger.csv_row(
                    "tile-validation",
                    ["epoch", "tile_error", "tile_fpr", "tile_fnr"],
                    [epoch, *m],
                )
                logger.scalars(
                    {"tile/err": m[0], "tile/fpr": m[1], "tile/fnr": m[2]}, epoch
                )
            t4 = time.perf_counter()
            epoch_stats.append({"sweep": t1 - t0, "select": t2 - t1,
                            "train": t3 - t2, "val": t4 - t3,
                            "train_tiles": n_sel, "loss": loss})

            if output_dir and epoch >= epochs:
                save(epoch)
        except KeyboardInterrupt:
            if output_dir:
                save(epoch)
            logger.info(f"interrupted at epoch {epoch}; checkpoint saved")
            raise

    return Stage2Result(state=state, last_metrics=last_metrics,
                        selections=selections, epoch_stats=epoch_stats)


def draw_pseudo_masks(
    model: MILNet,
    source,
    *,
    tile_size: int = 16,
    interval: int = 5,
    threshold: float = 0.95,
    image_batch: int = 64,
    preprocess: bool = False,
    output_path: Optional[str] = None,
    logger: Optional[RunLogger] = None,
    engine: str = "auto",
    infer_tiles_fn=None,
    device=None,
) -> np.ndarray:
    """Stage-3 pseudo-masks: uint8 [N, H, W] for every sample of ``source``.

    The tile sweep on the ``tile_size``/``interval`` grid keeps the tiles
    with P(positive) > ``threshold``; artifact clearing drops every tile of
    an image whose predicted count is 0 (the image head); the kept tiles
    are painted as blocks, refined with ``preprocess`` (the V-channel
    refinement and small-region morphology) and, with ``output_path``,
    saved as ``rgb/``/``mask/`` PNG pairs.

    ``infer_tiles_fn``: a built ``make_tile_infer_step`` on the same grid,
    to reuse one engine build across draws; else one is built with
    ``engine`` and calibration images picked from the source. On the CLI's
    16/5 grid ``"auto"`` resolves to per-tile q8 (the grid is off q8dg's /4
    lattice); the log names the engine that ran. The model must live on
    ``device`` (the CUDA card unless ``device="cpu"``). Streamed: each image
    batch crosses to the device once for both heads
    (``infer.iter_tiles_and_counts``), and the host paints, refines and
    saves batch i while the device sweeps batch i+1. Single-process: the
    multi-host branch comes with the ``parallel/`` slice of the port."""
    from cellsegmentation_tpu_torch.postprocess.masks import (
        paint_tile_blocks,
        preprocess_masks_batch,
        save_mask_pairs,
    )

    dev = model_device(model, device)
    logger = logger or RunLogger(output_path or "./output")
    h, w = source.image_hw
    coords = tile_grid(h, w, tile_size, interval)
    if infer_tiles_fn is None:
        infer_tiles_fn = make_tile_infer_step(
            model, tile_size, coords, engine=engine,
            calib_images=pick_calib_images(source.images), device=dev,
        )
    engine_ran = getattr(infer_tiles_fn, "resolved_engine", "unknown")
    infer_image_fn = make_image_infer_step(model, device=dev)
    n = len(source)
    base_idx = getattr(source, "base_idx", np.arange(n))
    masks = np.zeros((n, h, w), dtype=np.uint8)
    kept_tiles = kept_images = 0
    for rows, probs, counts in infer.iter_tiles_and_counts(
        source, infer_tiles_fn, infer_image_fn, image_batch=image_batch,
        device=dev,
    ):
        keep = topk_threshold_mask(probs, threshold) & (counts != 0)[:, None]
        groups, tile_idx = np.nonzero(keep)
        kept_tiles += len(groups)
        kept_images += len(np.unique(groups))
        imgs = source.images[base_idx[rows]]
        m = paint_tile_blocks(len(imgs), (h, w), groups, coords[tile_idx],
                              tile_size)
        if preprocess:
            m = preprocess_masks_batch(imgs, m)
        masks[rows] = m.astype(np.uint8)
        if output_path:
            save_mask_pairs(output_path, rows, imgs, m)
    logger.info(f"pseudo-masks: {kept_tiles} tiles kept on {kept_images}/{n} "
                f"images (tile engine {engine_ran})")
    return masks


def flip_masks(masks: np.ndarray, flips: np.ndarray) -> np.ndarray:
    """[B, H, W] masks flipped by their images' codes (``flip_images``):
    1 reverses W, 2 reverses H, 3 both."""
    mh = (flips == 1) | (flips == 3)
    mv = (flips == 2) | (flips == 3)
    masks = np.where(mh[:, None, None], masks[:, :, ::-1], masks)
    return np.where(mv[:, None, None], masks[:, ::-1, :], masks)


def train_stage3(
    model: MILNet,
    mask_source,
    *,
    epochs: int = 30,
    batch_size: int = 32,
    lr: float = 5e-5,
    weight_decay: float = 1e-4,
    scheduler: Optional[str] = None,
    encoder_name: str = "resnet50",
    output_dir: Optional[str] = None,
    logger: Optional[RunLogger] = None,
    seed: int = 42,
    last_epoch: int = 0,
    resume_opt_state: Optional[dict] = None,
    device=None,
) -> Stage3Result:
    """Stage-3 seg-decoder training on a ``MaskDataSource``: dice on the
    positive softmax channel, cross-entropy logged beside it, the decoder's
    parameters trained and every BatchNorm's statistics moving (the
    encoder's too).

    Per epoch: the shuffled batches, each image with a random flip drawn
    from a generator seeded by ``seed + epoch`` when the source augments
    (its mask flipped with it); the ``seg-training`` CSV; with
    ``output_dir``, a ``"segment"`` (pt3) checkpoint at the last epoch and
    on interrupt. Adam without a scheduler, SGD with one (``t0`` 5 for the
    warm restarts). Resuming (``last_epoch``) moves the step and the
    shuffle stream past the done epochs, so the run continues as a straight
    one would. The model carries the weights and is trained in place; it
    must live on ``device`` (the CUDA card unless ``device="cpu"``)."""
    dev = model_device(model, device)
    logger = logger or RunLogger(output_dir or "./output")
    it = BatchIterator(len(mask_source), batch_size, shuffle=True, seed=seed)
    schedule = make_schedule(scheduler, lr, epochs, len(it), t0=5)
    state = create_train_state(model, "segment", schedule,
                               use_sgd=scheduler is not None,
                               weight_decay=weight_decay, device=dev)
    if last_epoch:
        state.step = last_epoch * len(it)
        it.fast_forward(last_epoch)
    _restore_optimizer(state, resume_opt_state)
    step_fn = make_seg_train_step(model, device=dev)

    def save(epoch):
        save_checkpoint(output_dir, "segment", epoch, encoder_name,
                        model.state_dict(), state.optimizer.state_dict(),
                        step=state.step)

    last_loss = None
    epoch_stats = []
    for epoch in range(1 + last_epoch, epochs + 1):
        try:
            t0 = time.perf_counter()
            pipe = _MetricsPipe()
            aug_rng = np.random.default_rng(seed + epoch)
            for sel, valid in it:
                flips = (aug_rng.integers(0, 4, size=len(sel)).astype(np.int32)
                         if mask_source.augment
                         else np.zeros(len(sel), dtype=np.int32))
                batch = {"images": mask_source.images[sel], "flip": flips,
                         "mask": flip_masks(mask_source.masks[sel], flips),
                         "valid": valid}
                state, metrics = step_fn(state, batch)
                pipe.push(metrics)
            means = pipe.means()  # waits for the last step
            epoch_stats.append({"train": time.perf_counter() - t0,
                                "steps": pipe.n, **means})
            last_loss = means.get("loss")
            logger.info(
                f"[stage3 epoch {epoch}/{epochs}] "
                + " | ".join(f"{k}: {v:.4f}" for k, v in means.items())
            )
            logger.csv_row("seg-training", ["epoch", "seg_loss_ce", "seg_loss_dice"],
                           [epoch, means.get("loss_ce", 0), means.get("loss_dice", 0)])
            logger.scalars({f"seg/{k}": v for k, v in means.items()}, epoch)
            if output_dir and epoch >= epochs:
                save(epoch)
        except KeyboardInterrupt:
            if output_dir:
                save(epoch)
            logger.info(f"interrupted at epoch {epoch}; checkpoint saved")
            raise

    return Stage3Result(state=state, last_loss=last_loss, epoch_stats=epoch_stats)
