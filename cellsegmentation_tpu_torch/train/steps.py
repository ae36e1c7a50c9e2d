"""The stage steps: stage 1's image train and infer steps, stage 2's tile
sweep (engine resolution, the exact per-tile graph) and selected-tile train
step, stage 3's seg-decoder train and infer steps.

``make_image_train_step`` trains the whole model in train mode (every
BatchNorm on batch statistics, running ones updated; dropout on) against
``CE(cls) + MSE(reg)``; ``make_image_infer_step`` runs it on
running statistics without dropout.

``make_tile_infer_step`` returns a callable ``(images_u8, flip) -> probs
[G, T]`` (softmax P(positive) per tile, reference tile order) on the
model's device; ``make_stack_tile_infer_step`` the same sweep over images
gathered from a device-resident uint8 stack. Engine names are the JAX
package's, so flags carry over:

- ``"flax"``: the model's own graph on extracted tiles (exact per-tile);
- ``"q8"``: the per-tile q8 engine, the folded conv trunk with int8
  sandwiches on extracted tiles (ops/infer_engine.py);
- ``"q8g"``: per tile, stem and layer1 in conv-land, layers 2-4 as int8
  GEMMs (the conv trunk for a BasicBlock encoder);
- ``"q8dg"``: the dense shared-stem sweep with layers 3-4 as int8 GEMMs
  (with layers 2-4 in conv-land for a BasicBlock encoder, and for a grouped
  one unless ``grouped_gemm`` asks for its GEMMs);
- ``"q8d"``: the dense shared-stem sweep with layers 2-4 in conv-land;
- ``"auto"``: q8dg on any device.

The dense engines need a grid on the /4 stem lattice; elsewhere, as in
the JAX package, ``"q8dg"`` falls back to q8g and ``"q8d"`` and
``"auto"`` to q8. Every engine but flax needs calibration images or
scales: without them a request runs the exact graph, as does an encoder
that does not fold. The step's ``resolved_engine`` names what runs.

``make_tile_train_step`` trains the tile head on selected tiles with the
encoder frozen (BatchNorm on running statistics, no autograd graph through
it), as the JAX package's stage-2 step does with ``freeze_encoder_stats``
and its ``"tile"`` optimizer mask. ``make_alternative_train_step``
alternates it with the image step on one model, batch by batch.

The image, tile and seg train steps take an optional ``mesh``
(parallel/mesh.py). Over more than one rank, a step on each rank's local
rows computes the JAX package's one step on the dp-sharded global batch,
the ranks' batches in rank order: each rank's loss is its masked sum over
the global valid count; the gradients of the trainable partition are
all-reduced (summed) before the optimizer; the logged metrics are
all-reduced, so every rank logs the global ones; train-mode BatchNorm
normalizes by the global batch's statistics and moves the running ones by
them (models/common.py ``sync_batch_norm``); dropout and stochastic-depth
masks are drawn for the global batch from the (seed, step) generator and
each rank takes its rows. ``make_alternative_train_step`` has no caller in
either package and stays single-process.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from cellsegmentation_tpu_torch.core.device import model_device
from cellsegmentation_tpu_torch.data.batches import flip_images, normalize_images
from cellsegmentation_tpu_torch.models.common import sync_batch_norm
from cellsegmentation_tpu_torch.models.milnet import IMAGE_HEADS, MILNet
from cellsegmentation_tpu_torch.ops.losses import count_weights, dice_coef
from cellsegmentation_tpu_torch.ops.q8_trunk import W2_IMPLS
from cellsegmentation_tpu_torch.ops.tiles import extract_tiles, tile_grid
from cellsegmentation_tpu_torch.parallel.mesh import distributed
from cellsegmentation_tpu_torch.parallel.sharding import (
    all_reduce_grads,
    all_reduce_sum,
    global_count,
    global_rows,
)
from cellsegmentation_tpu_torch.train.state import STAGE_TRAINABLE

ENGINES = ("flax", "auto", "q8", "q8g", "q8d", "q8dg")
# the per-tile engine a dense request falls back to off the /4 lattice
_PER_TILE_FALLBACK = {"q8d": "q8", "q8dg": "q8g", "auto": "q8"}


def _as_device(x, device, dtype=None) -> torch.Tensor:
    t = torch.as_tensor(np.asarray(x)) if not torch.is_tensor(x) else x
    return t.to(device=device, dtype=dtype)


def make_tile_infer_step(
    model: MILNet, tile_size: int, coords, engine: str = "flax",
    calib_images=None, device=None, scales=None, w2_impl: str = "auto",
    grouped_gemm: bool = False,
):
    """Tile sweep over whole uint8 images [G, H, W, 3] on ``device`` (the
    CUDA card unless ``device="cpu"``; the model must already live there).

    ``coords`` is the static [T, 2] grid. The engines other than flax need
    ``calib_images`` (uint8 full frames) for the int8 scale calibration, or
    ``scales`` (a TrunkScales) to skip it; ``w2_impl`` picks the GEMM
    trunk's 3x3 form (ops/q8_trunk.py ``W2_IMPLS``, a speed switch: the
    forms are bit-identical). ``grouped_gemm`` runs a grouped (ResNeXt)
    trunk's layers 3-4 under q8dg as int8 GEMMs (the JAX package's
    ``CST_GROUPED_GEMM``); without it q8dg runs the dense conv chain there.
    The step's ``resolved_engine`` names the engine that runs, and
    ``engine`` holds the built engine."""
    dev = model_device(model, device)
    if w2_impl not in W2_IMPLS:
        raise ValueError(f"w2_impl must be one of {W2_IMPLS}, got {w2_impl!r}")
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; expected one of {ENGINES}")
    coords = np.asarray(coords)
    calibrated = calib_images is not None or scales is not None

    dense = _resolve_dense_engine(engine)
    if dense is not None and calibrated:
        built = _build_dense_engine(model, tile_size, coords, dense,
                                    calib_images, scales, w2_impl, grouped_gemm)
        if built is not None:
            if engine == "auto":
                # auto changes stem/layer1 numerics against the per-tile
                # zero-padded forward (real neighbour pixels at tile
                # borders); say so per build
                print(
                    f"[engine] auto -> {dense} (dense shared-stem sweep; "
                    "validated approximation of the per-tile forward — pass "
                    "engine='flax' for exact per-tile numerics)"
                )

            @torch.no_grad()
            def infer_dense(images, flip):
                f = np.asarray(flip.cpu() if torch.is_tensor(flip) else flip)
                imgs = _as_device(images, dev)
                # flip-free batches take the graph without selects or reversal
                return built(imgs, _as_device(f, dev) if f.any() else None)

            infer_dense.resolved_engine = dense
            infer_dense.engine = built
            return infer_dense
        engine = _PER_TILE_FALLBACK[engine]

    fast = None
    if engine in ("q8", "q8g", "auto") and calibrated:
        fast = _build_tile_engine(model, tile_size, coords, engine, calib_images,
                                  scales, w2_impl)
    if fast is not None:
        @torch.no_grad()
        def infer_q8(images, flip):
            return _q8_tile_body(fast, tile_size, _as_device(images, dev),
                                 _as_device(flip, dev), coords)

        infer_q8.resolved_engine = "q8g" if engine == "q8g" else "q8"
        infer_q8.engine = fast
        return infer_q8

    @torch.no_grad()
    def infer(images, flip):
        return _tile_infer_body(model, tile_size, _as_device(images, dev),
                                _as_device(flip, dev), coords)

    infer.resolved_engine = "flax"
    return infer


def _resolve_dense_engine(engine: str):
    """The dense engine an ``engine`` request maps to, if any: explicit
    ``"q8d"`` and ``"q8dg"`` are honored, and ``"auto"`` promotes to q8dg
    on every device.

    The JAX package promotes ``"auto"`` only off its CPU backend, where its
    GEMM kernels run as Pallas in interpret mode, a Python loop per grid
    cell. The port's CPU versions of the kernels are plain PyTorch at full
    speed, so it promotes on the CPU too, a deliberate difference: the CPU
    then runs the engine the card runs. Where the dense engines do not
    qualify, both fall back alike (``_PER_TILE_FALLBACK``)."""
    if engine in ("q8d", "q8dg"):
        return engine
    return "q8dg" if engine == "auto" else None


def _build_dense_engine(model, tile_size, coords, dense, calib_images, scales,
                        w2_impl, grouped_gemm):
    """The dense sweep ``dense`` names, or None when the grid or the arch
    does not qualify. The image size comes from the calibration images; the
    coordinate table must be the canonical product grid of ``tile_grid``.
    q8dg on a BasicBlock encoder, or on a grouped one without
    ``grouped_gemm``, builds the conv-land chain, as the JAX package's
    does."""
    from cellsegmentation_tpu_torch.ops.infer_engine import (
        calib_tiles_from_images,
        make_dense_tile_probs,
    )

    xs = np.unique(coords[:, 0])
    if len(xs) < 2:
        return None
    interval = int(xs[1] - xs[0])
    hw = int(xs[-1]) + tile_size  # the border tile is flush with the edge
    if calib_images is not None:
        calib_images = np.asarray(calib_images)
        hw = calib_images.shape[1]
    if not np.array_equal(coords, tile_grid(hw, hw, tile_size, interval)):
        return None
    calib = (None if calib_images is None
             else calib_tiles_from_images(calib_images, coords, tile_size))
    built = None
    if dense == "q8dg":
        built = make_dense_tile_probs(model, tile_size, interval, hw, calib,
                                      scales=scales, w2_impl=w2_impl,
                                      grouped_gemm=grouped_gemm)
    return built or make_dense_tile_probs(model, tile_size, interval, hw, calib,
                                          scales=scales, backend="conv")


def _build_tile_engine(model, tile_size, coords, engine, calib_images, scales,
                       w2_impl):
    """The per-tile engine of a ``"q8"``, ``"q8g"`` or ``"auto"`` request
    (q8g: the GEMM backend), or None for an encoder that does not fold (the
    exact graph serves those, as in the JAX package)."""
    from cellsegmentation_tpu_torch.ops.infer_engine import (
        calib_tiles_from_images,
        make_fast_tile_logits,
    )

    calib = (None if calib_images is None else
             calib_tiles_from_images(np.asarray(calib_images), coords, tile_size))
    return make_fast_tile_logits(model, calib, scales,
                                 backend="gemm" if engine == "q8g" else "conv",
                                 tile_size=tile_size, w2_impl=w2_impl)


def _flat_tiles(images, flip, coords, tile_size):
    """uint8 tiles [G*T, ts, ts, 3] extracted on the device, and each
    tile's flip code, its parent sample's [G*T]."""
    tiles = extract_tiles(images, coords, tile_size)  # [G, T, ts, ts, 3] u8
    flat = tiles.reshape(-1, tile_size, tile_size, 3)
    return flat, flip.repeat_interleave(tiles.shape[1])


def _q8_tile_body(fast, tile_size, images, flip, coords):
    """Per-tile q8: the tiles flipped and normalized into bf16, then the
    engine's logits in passes of at most ``Q8_TILE_CHUNK`` tiles."""
    from cellsegmentation_tpu_torch.ops.infer_engine import Q8_TILE_CHUNK

    flat, flip_t = _flat_tiles(images, flip, coords, tile_size)
    logits = torch.cat([
        fast(normalize_images(flat[i:i + Q8_TILE_CHUNK],
                              flip_t[i:i + Q8_TILE_CHUNK], dtype=torch.bfloat16))
        for i in range(0, len(flat), Q8_TILE_CHUNK)
    ])
    return torch.softmax(logits.float(), dim=-1)[:, 1].reshape(images.shape[0], -1)


def _tile_infer_body(model, tile_size, images, flip, coords):
    """The exact per-tile graph: the tiles flipped, forwards in the compute
    dtype in passes of at most ``Q8_TILE_CHUNK`` tiles (test_tile's 32/5
    grid at image batch 128 is 387,200 tiles; each tile's result does not
    depend on the split)."""
    from cellsegmentation_tpu_torch.ops.infer_engine import Q8_TILE_CHUNK

    flat, flip_t = _flat_tiles(images, flip, coords, tile_size)
    dtype = model.policy.compute_dtype
    logits = torch.cat([
        model(normalize_images(flat[i:i + Q8_TILE_CHUNK], flip_t[i:i + Q8_TILE_CHUNK],
                               dtype=dtype), mode="tile")
        for i in range(0, len(flat), Q8_TILE_CHUNK)
    ])
    return torch.softmax(logits.float(), dim=-1)[:, 1].reshape(images.shape[0], -1)


def make_stack_tile_infer_step(
    model: MILNet, tile_size: int, coords, engine: str = "flax",
    calib_images=None, device=None, w2_impl: str = "auto",
    grouped_gemm: bool = False,
):
    """The tile sweep over images gathered from a device-resident stack:
    ``(images_stack u8 [N, H, W, 3] on the device, idx [G], flip [G]) ->
    probs [G, T]``. The gather ``images_stack[idx]`` runs on the device, so
    the images cross to it once per run, not once per sweep. Arguments as
    ``make_tile_infer_step``; the underlying per-batch step (the same built
    engine) is the result's ``infer_step``, for sweeps over images that are
    not in the stack."""
    infer_step = make_tile_infer_step(
        model, tile_size, coords, engine=engine, calib_images=calib_images,
        device=device, w2_impl=w2_impl, grouped_gemm=grouped_gemm,
    )
    dev = model_device(model, device)

    @torch.no_grad()
    def infer_stack(images_stack, idx, flip):
        imgs = images_stack[_as_device(idx, dev, torch.long)]
        return infer_step(imgs, flip)

    infer_stack.resolved_engine = infer_step.resolved_engine
    infer_stack.infer_step = infer_step
    return infer_stack


def _masked_mean(values: torch.Tensor, valid: torch.Tensor,
                 count: torch.Tensor) -> torch.Tensor:
    """The sum of ``values`` over the valid rows, over ``count`` valid rows
    (``global_count``: the global batch's, so that the ranks' terms sum to
    the global mean)."""
    return torch.sum(values * valid.to(torch.float32)) / torch.clamp_min(count, 1.0)


def _trained(state) -> list:
    return [p for g in state.optimizer.param_groups for p in g["params"]]


def _gather_tiles(images_dev: torch.Tensor, img_idx, xs, ys,
                 tile_size: int) -> torch.Tensor:
    """``images_dev[i, x:x+ts, y:y+ts]`` for every (i, x, y), on the
    stack's device: [B, ts, ts, 3] uint8."""
    r = torch.arange(tile_size, device=images_dev.device)
    rows = (xs[:, None] + r)[:, :, None]
    cols = (ys[:, None] + r)[:, None, :]
    return images_dev[img_idx[:, None, None], rows, cols]


_BATCH_KEYS = ("img_idx", "xs", "ys", "flip", "label", "valid")


def make_tile_train_step(model: MILNet, tile_size: int, device=None, mesh=None):
    """Cross-entropy training of ``fc_tile`` on selected tiles gathered from
    the device-resident uint8 stack.

    ``step(state, images_dev, batch) -> (state, {"loss": ce})`` with batch
    ``{img_idx, xs, ys, flip, label, valid}`` ([B] arrays, host or device;
    ``valid`` masks the last batch's padding). The tiles are gathered and
    flipped on the device, normalized in f32, run through the frozen encoder
    (BatchNorm on running statistics, no autograd graph), and the
    masked-mean f32 cross-entropy steps the state's optimizer, which holds
    ``fc_tile`` only (train/state.py). The loss is returned as a device
    scalar, so the caller decides when to wait for it. ``step.loss_fn(
    images_dev, batch)`` is the differentiable loss alone. Over a ``mesh``
    of several ranks, the step of the global batch (module docstring)."""
    dev = model_device(model, device)

    def loss_fn(images_dev, batch):
        b = {k: _as_device(batch[k], dev) for k in _BATCH_KEYS}
        idx = b["img_idx"].long()
        tiles = _gather_tiles(images_dev, idx, b["xs"].long(), b["ys"].long(),
                             tile_size)
        # the flip applies to the sliced tile's content, not its parent image
        tiles = flip_images(tiles, b["flip"])
        x = normalize_images(tiles, torch.zeros_like(b["flip"]))
        with torch.no_grad():
            x4 = model.encoder(x)[0]
        logits = model.fc_tile(x4)
        logp = F.log_softmax(logits.float(), dim=-1)
        ce_each = -logp.gather(1, b["label"].long()[:, None])[:, 0]
        return _masked_mean(ce_each, b["valid"], global_count(mesh, b["valid"]))

    def step(state, images_dev, batch):
        ce = loss_fn(images_dev, batch)
        state.optimizer.zero_grad(set_to_none=True)
        ce.backward()
        all_reduce_grads(mesh, _trained(state))
        state.apply_gradients()
        return state, all_reduce_sum(mesh, {"loss": ce.detach()})

    step.loss_fn = loss_fn
    return step


# ---------------------------------------------------------------------------
# Stage 1: the image-wise counter
# ---------------------------------------------------------------------------

HEADS = ("both", "cls", "reg")
REG_LOSSES = ("mse", "weighted_mse")
_IMAGE_KEYS = ("images", "flip", "cls", "reg", "valid")


def dropout_generator(seed: int, step: int, device) -> torch.Generator:
    """The dropout masks' generator of update ``step``: seeded from
    (``seed``, ``step``), so a resumed run draws what a straight run draws."""
    mixed = np.random.SeedSequence((seed, step)).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(mixed))


def make_image_train_step(model: MILNet, heads: str = "both",
                          reg_loss: str = "mse", seed: int = 0, device=None,
                          alpha: float = 1.0, beta: float = 1.0, mesh=None):
    """Stage-1 step over batches ``{images: u8 [B,H,W,3], flip, cls, reg,
    valid}`` (host or device arrays; ``valid`` masks the last batch's
    padding out of the loss, while the padded rows still take part in every
    BatchNorm's batch statistics, as in the JAX package).

    ``step(state, batch, dropout_masks=None, sd_masks=None) -> (state,
    metrics)``: the masked-mean losses ``loss_cls`` (CE), ``loss_reg``
    (MSE, or the reference's WeightedMSELoss with
    ``reg_loss="weighted_mse"``) and ``loss = alpha * CE + beta * MSE``
    (the reference's weights are 1 and 1) as device scalars; the gradient
    is taken of the ``heads`` part alone. The state's optimizer holds the stage's
    partitions (``"image"``, ``"image_cls"`` or ``"image_reg"``,
    train/state.py); a frozen head still runs in train mode and updates its
    BatchNorm statistics. Dropout masks come from ``dropout_generator(seed, state.step)`` unless
    ``dropout_masks`` (``{head: masks}``, the heads' ``draw_masks``
    tuples) gives them, and so do an EfficientNet encoder's
    stochastic-depth masks (drawn first) unless ``sd_masks`` gives them
    (models/efficientnet.py). ``step.loss_fn(batch, dropout_masks=None,
    step=0, sd_masks=None)`` is the forward alone: (loss, ce, se). Over a
    ``mesh`` of several ranks, the step of the global batch (module
    docstring); given masks are this rank's rows."""
    if heads not in HEADS:
        raise ValueError(f"heads must be one of {HEADS}, got {heads!r}")
    if reg_loss not in REG_LOSSES:
        raise ValueError(f"reg_loss must be one of {REG_LOSSES}, got {reg_loss!r}")
    dev = model_device(model, device)
    sync_batch_norm(model, mesh if distributed(mesh) else None)

    def loss_fn(batch, dropout_masks=None, step=0, sd_masks=None):
        b = {k: _as_device(batch[k], dev) for k in _IMAGE_KEYS}
        x = normalize_images(b["images"], b["flip"])
        gen = dropout_generator(seed, step, dev)
        if distributed(mesh):
            sd_masks, dropout_masks = _global_masks(model, x.shape[0], mesh, gen,
                                                    sd_masks, dropout_masks)
        out_cls, out_reg = model(x, mode="image", train=True,
                                 dropout_masks=dropout_masks, sd_masks=sd_masks,
                                 generator=gen)
        count = global_count(mesh, b["valid"])
        logp = F.log_softmax(out_cls.float(), dim=-1)
        ce = _masked_mean(-logp.gather(1, b["cls"].long()[:, None])[:, 0],
                          b["valid"], count)
        targets = b["reg"].float()
        se_each = (out_reg[:, 0].float() - targets) ** 2
        if reg_loss == "weighted_mse":
            se_each = count_weights(targets) * se_each
        se = _masked_mean(se_each, b["valid"], count)
        loss = {"both": alpha * ce + beta * se, "cls": alpha * ce, "reg": beta * se}[heads]
        return loss, ce, se

    def step(state, batch, dropout_masks=None, sd_masks=None):
        loss, ce, se = loss_fn(batch, dropout_masks, state.step, sd_masks)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        all_reduce_grads(mesh, _trained(state))
        state.apply_gradients()
        ce, se = ce.detach(), se.detach()
        return state, all_reduce_sum(
            mesh, {"loss_cls": ce, "loss_reg": se, "loss": alpha * ce + beta * se})

    step.loss_fn = loss_fn
    return step


def _global_masks(model, n: int, mesh, gen, sd_masks, dropout_masks):
    """The stochastic-depth and dropout keep masks of the global batch, drawn
    from ``gen`` in the single-process forward's order (the encoder's first,
    then each head's, the class head first), each cut to this rank's rows.
    Masks the caller gave are kept as given."""
    dev = gen.device
    n_global, rows = global_rows(mesh, n)
    if sd_masks is None and hasattr(model.encoder, "sd_blocks"):
        sd_masks = [m[rows] for m in model.encoder.draw_sd_masks(n_global, gen, dev)]
    if dropout_masks is None:
        dropout_masks = {k: tuple(m[rows] for m in getattr(model, k).draw_masks(
            n_global, gen, dev)) for k in IMAGE_HEADS}
    return sd_masks, dropout_masks


_TILE_OF_ALTERNATIVE = {"img_idx": "img_idx", "xs": "xs", "ys": "ys", "flip": "tflip",
                        "label": "tlabel", "valid": "tvalid"}


def make_alternative_train_step(model: MILNet, tile_size: int, alpha: float = 1.0,
                                beta: float = 1.0, seed: int = 0, device=None):
    """Per-batch alternation on one model: a tile CE update of ``fc_tile``
    (``make_tile_train_step``), then an image CE + MSE update of the
    encoder and the image heads (``make_image_train_step`` with ``alpha`` /
    ``beta``), so the image pass reads the parameters the tile pass wrote.
    The JAX package keeps it beside its stage steps, unused by its CLIs.

    ``step(tile_state, image_state, images_dev, batch, dropout_masks=None)
    -> (tile_state, image_state, metrics)``: the states are
    ``create_train_state(model, "tile", ...)`` and ``(model, "image",
    ...)``, each with its own optimizer and step count; ``batch`` holds the
    image keys ``{images, flip, cls, reg, valid}`` and the tile selection
    ``{img_idx, xs, ys, tflip, tlabel, tvalid}`` into the uint8 stack
    ``images_dev``. Dropout masks come from ``dropout_generator(seed,
    image_state.step)`` unless given. The metrics are the tile step's and
    the image step's, the image ``loss`` last."""
    tile_step = make_tile_train_step(model, tile_size, device)
    image_step = make_image_train_step(model, seed=seed, device=device, alpha=alpha,
                                       beta=beta)
    both = (*STAGE_TRAINABLE["tile"], *STAGE_TRAINABLE["image"])

    def step(tile_state, image_state, images_dev, batch, dropout_masks=None):
        # each optimizer holds its own partitions; the other's parameters
        # need their gradients on too, the states' constructors set only
        # their own
        model.set_trainable(both)
        tile_batch = {k: batch[v] for k, v in _TILE_OF_ALTERNATIVE.items()}
        tile_state, tile_metrics = tile_step(tile_state, images_dev, tile_batch)
        image_batch = {k: batch[k] for k in _IMAGE_KEYS}
        image_state, image_metrics = image_step(image_state, image_batch, dropout_masks)
        return tile_state, image_state, {**tile_metrics, **image_metrics}

    return step


def make_image_infer_step(model: MILNet, device=None):
    """``(images u8 [B,H,W,3], flip [B]) -> (softmax probs [B, 7], counts
    [B])``, f32 device tensors: the image mode on running statistics."""
    dev = model_device(model, device)

    @torch.no_grad()
    def infer(images, flip):
        x = normalize_images(_as_device(images, dev), _as_device(flip, dev))
        out_cls, out_reg = model(x, mode="image")
        return torch.softmax(out_cls.float(), dim=-1), out_reg[:, 0].float()

    return infer


# ---------------------------------------------------------------------------
# Stage 3: the segmentation decoder
# ---------------------------------------------------------------------------

_SEG_KEYS = ("images", "flip", "mask", "valid")


def make_seg_train_step(model: MILNet, device=None, mesh=None):
    """Stage-3 step over batches ``{images: u8 [B,H,W,3], flip, mask: 0/1
    [B,H,W] (already flipped with its image), valid}``, host or device.

    ``step(state, batch) -> (state, {"loss_ce", "loss_dice", "loss"})``:
    the loss is soft dice on softmax channel 1, one coefficient per image,
    masked-mean over ``valid``; the pixel cross-entropy is computed for the
    log only. Encoder and decoder run in train mode, so every BatchNorm
    normalizes by the batch and moves its running statistics (the padded
    rows take part, as in the JAX package). The state's optimizer holds the
    ``"segment"`` partition, the decoder (train/state.py): the encoder's
    parameters need no gradient, so autograd keeps out of it.
    ``step.loss_fn(batch) -> (dice, ce)`` is the forward alone. Over a
    ``mesh`` of several ranks, the step of the global batch (module
    docstring)."""
    dev = model_device(model, device)
    sync_batch_norm(model, mesh if distributed(mesh) else None)

    def loss_fn(batch):
        b = {k: _as_device(batch[k], dev) for k in _SEG_KEYS}
        x = normalize_images(b["images"], b["flip"])
        logits = model(x, mode="segment", train=True).float()
        probs_pos = torch.softmax(logits, dim=-1)[..., 1]
        count = global_count(mesh, b["valid"])
        dice = _masked_mean(1 - dice_coef(probs_pos, b["mask"]), b["valid"], count)
        with torch.no_grad():
            logp = F.log_softmax(logits, dim=-1)
            ce_map = -logp.gather(-1, b["mask"].long()[..., None])[..., 0]
            ce = _masked_mean(ce_map.mean(dim=(1, 2)), b["valid"], count)
        return dice, ce

    def step(state, batch):
        dice, ce = loss_fn(batch)
        state.optimizer.zero_grad(set_to_none=True)
        dice.backward()
        all_reduce_grads(mesh, _trained(state))
        state.apply_gradients()
        dice = dice.detach()
        return state, all_reduce_sum(mesh, {"loss_ce": ce, "loss_dice": dice,
                                            "loss": dice})

    step.loss_fn = loss_fn
    return step


def make_seg_infer_step(model: MILNet, device=None):
    """``(images u8 [B,H,W,3], flip [B]) -> P(positive) [B, H, W]``, f32 on
    the device: the segment mode on running statistics, softmax channel 1."""
    dev = model_device(model, device)

    @torch.no_grad()
    def infer(images, flip):
        x = normalize_images(_as_device(images, dev), _as_device(flip, dev))
        logits = model(x, mode="segment")
        return torch.softmax(logits.float(), dim=-1)[..., 1]

    return infer
