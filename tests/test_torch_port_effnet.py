"""The port's EfficientNet held against the JAX package on the same weights
and numpy-seeded inputs: the registry and the weight bridge at full width
(B0 and B2, from ``jax.eval_shape``: no compile), and on a reduced encoder
the four encoder outputs and both image heads in eval mode (f32 and bf16),
the train-mode forward under injected dropout and stochastic-depth masks
with its BatchNorm updates, one image train step, one tile train step, the
mask draws, and the segment-mode refusals.

The reduced encoder is ``EfficientNetEncoder(width_mult=0.25,
depth_mult=0.34)``: 10 blocks with kernels 3 and 5, with and without the
expand 1x1, residual and strided ones, 5 of them with stochastic depth.
Its weights are the port's seeded init with every BatchNorm's statistics
set from a batch (``settle_batch_stats``: at the kaiming fan_out init the
eval-mode activations otherwise shrink to ~1e-14 through the blocks) and
then perturbed, converted to the JAX package's tree by ``_jax_variables``
(the bridge's inverse, held to a round trip).

The JAX package draws stochastic depth as ``floor(keep + U[0, 1))`` from
``jax.random.uniform``; the tests replace that function while the JAX side
traces, returning values that give the test's masks, and give the port the
same masks through ``sd_masks``. Head dropout is injected on both sides as
in ``tests/test_torch_port_stage1.py``.
"""

from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cellsegmentation_tpu import models as jmodels
from cellsegmentation_tpu.core.dtypes import DEFAULT_POLICY as J_BF16
from cellsegmentation_tpu.core.dtypes import F32_POLICY as J_F32
from cellsegmentation_tpu.data.batches import normalize_images as jnormalize
from cellsegmentation_tpu.models.efficientnet import EfficientNetEncoder as JEncoder
from cellsegmentation_tpu.models.milnet import MILNet as JMILNet
from cellsegmentation_tpu.train import schedules as jsched
from cellsegmentation_tpu.train import state as jstate
from cellsegmentation_tpu.train import steps as jsteps

from cellsegmentation_tpu_torch import models as tmodels
from cellsegmentation_tpu_torch.core.dtypes import DEFAULT_POLICY, F32_POLICY
from cellsegmentation_tpu_torch.data import normalize_images
from cellsegmentation_tpu_torch.models import (
    MODEL_NAMES,
    EfficientNetEncoder,
    MILNet,
    build_model,
)
from cellsegmentation_tpu_torch.models.milnet import init_milnet, settle_batch_stats
from cellsegmentation_tpu_torch.train import schedules as tsched
from cellsegmentation_tpu_torch.train import state as tstate
from cellsegmentation_tpu_torch.train import steps as tsteps
from cellsegmentation_tpu_torch.utils.jax_weights import (
    jax_to_state_dict,
    load_jax_variables,
)

from test_torch_port_slice import one_torch_thread  # noqa: F401 (autouse)
from test_torch_port_stage1 import _intercept

WIDTH, DEPTH = 0.25, 0.34
HW, B = 64, 8
HEADS = ("fc_image_cls", "fc_image_reg")


def _port_model(policy=F32_POLICY):
    return MILNet(EfficientNetEncoder(WIDTH, DEPTH, policy), policy=policy,
                  image_head_style="simple", supports_segment=False)


def _jax_model(policy=J_F32):
    return JMILNet(encoder=JEncoder(width_mult=WIDTH, depth_mult=DEPTH, policy=policy),
                   image_head_style="simple", supports_segment=False, policy=policy)


def _images(n, seed, hw=HW):
    return np.random.default_rng(seed).integers(0, 256, (n, hw, hw, 3)).astype(np.uint8)


def _np(t):
    return t.detach().numpy().copy()


def _hwio(w):
    return np.transpose(_np(w), (2, 3, 1, 0))


def _unit(unit):
    """A port conv+BN unit -> the JAX package's (params, stats) subtrees."""
    conv, bn = unit
    return ({"Conv_0": {"kernel": _hwio(conv.weight)},
             "BatchNorm_0": {"scale": _np(bn.weight), "bias": _np(bn.bias)}},
            {"BatchNorm_0": {"mean": _np(bn.running_mean), "var": _np(bn.running_var)}})


def _jax_variables(model):
    """The port EfficientNet MILNet's weights as the JAX package's tree."""
    enc = model.encoder
    params, stats = {}, {}
    params["_ConvNormSiLU_0"], stats["_ConvNormSiLU_0"] = _unit(enc.features[0])
    params["_ConvNormSiLU_1"], stats["_ConvNormSiLU_1"] = _unit(enc.features[-1])
    for i, blk in enumerate(enc.blocks):
        units = list(blk.block)
        bp, bs = {}, {}
        for k, u in enumerate(units[:-2] + units[-1:]):
            bp[f"_ConvNormSiLU_{k}"], bs[f"_ConvNormSiLU_{k}"] = _unit(u)
        se = units[-2]
        bp["SqueezeExcitation_0"] = {
            f"Conv_{c}": {"kernel": _hwio(fc.weight), "bias": _np(fc.bias)}
            for c, fc in enumerate((se.fc1, se.fc2))}
        params[f"MBConv_{i}"], stats[f"MBConv_{i}"] = bp, bs

    def dense(lin):
        return {"Dense_0": {"kernel": _np(lin.weight).T, "bias": _np(lin.bias)}}

    return {"params": {"encoder": params, "fc_tile": dense(model.fc_tile[1]),
                       **{h: dense(getattr(model, h)[2]) for h in HEADS}},
            "batch_stats": {"encoder": stats}}


@pytest.fixture(scope="module")
def fx():
    """The reduced model (f32, seeded, statistics from a batch, then every
    BatchNorm perturbed), its JAX variables, a batch of 8 (6 valid rows and
    2 padded copies of row 0) and its masks."""
    model = init_milnet(_port_model(), seed=0)
    x = normalize_images(torch.from_numpy(_images(8, seed=1)), torch.zeros(8, dtype=torch.int32))
    settle_batch_stats(model, x)
    rng = np.random.default_rng(11)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                c = m.num_features
                m.weight.mul_(torch.from_numpy(1 + 0.1 * rng.standard_normal(c, np.float32)))
                m.bias.add_(torch.from_numpy(0.1 * rng.standard_normal(c, np.float32)))
        # a count head whose pre-ReLU output is positive carries a gradient
        model.fc_image_reg[2].bias.fill_(3.0)
    imgs = _images(6, seed=2)
    rows = np.concatenate([np.arange(6), np.zeros(B - 6, int)])
    counts = np.random.default_rng(5).integers(0, 40, 6)
    batch = {
        "images": imgs[rows],
        "flip": (np.arange(B) % 4).astype(np.int32)[rows],
        "cls": np.digitize(counts, [1, 6, 11, 21, 51, 201]).astype(np.int32)[rows],
        "reg": counts.astype(np.float32)[rows],
        "valid": np.arange(B) < 6,
    }
    return dict(model=model, variables=_jax_variables(model), batch=batch,
                masks=_masks(model, seed=3))


def _masks(model, seed):
    """Head dropout {(head, "Dropout_0"): [B, C]} and one stochastic-depth
    keep mask [B] per ``sd_blocks`` entry, each dropping at least one row
    and keeping at least one."""
    rng = np.random.default_rng(seed)
    c = model.encoder.feature_dim
    heads = {(h, "Dropout_0"): rng.random((B, c)) >= 0.3 for h in HEADS}
    sd = []
    for _ in model.encoder.sd_blocks:
        m = rng.random(B) >= 0.5
        m[:2] = (False, True)
        sd.append(m)
    return {"heads": heads, "sd": sd}


def _port_masks(masks):
    return ({h: (torch.from_numpy(masks["heads"][(h, "Dropout_0")]),) for h in HEADS},
            [torch.from_numpy(m) for m in masks["sd"]])


@contextlib.contextmanager
def _jax_masks(masks, monkeypatch):
    """While the JAX side traces: head dropout injected, and every
    ``jax.random.uniform`` call of a block with stochastic depth (in
    forward order) returning U such that floor(keep + U) is the mask."""
    sd = list(masks["sd"])

    def uniform(key, shape, *a, **k):
        m = sd.pop(0)
        assert shape == (len(m), 1, 1, 1)
        return jnp.asarray(np.where(m, 0.99999, 0.0).reshape(shape), jnp.float32)

    with monkeypatch.context() as mp:
        mp.setattr(jax.random, "uniform", uniform)
        with _intercept(masks["heads"]):
            yield
    assert not sd, "a stochastic-depth mask was not drawn"


def _x(batch):
    return normalize_images(torch.from_numpy(batch["images"]), torch.from_numpy(batch["flip"]))


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _sd_of(model):
    return {k: _np(v) for k, v in model.state_dict().items()
            if not k.endswith("num_batches_tracked")}


# ---------------------------------------------------------------------------
# registry, structure, bridge
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,blocks,dim", [("efficientnet_b0", 16, 1280),
                                             ("efficientnet_b2", 23, 1408)])
def test_full_width_structure_matches_jax(name, blocks, dim):
    """The JAX package's full variable tree (``jax.eval_shape``, zeros)
    through the bridge is the port's state dict key for key and shape for
    shape, with no key left over; the block count, feature_dim and every
    squeeze width are the JAX package's. MODEL_NAMES equals its registry."""
    assert MODEL_NAMES == jmodels.MODEL_NAMES
    jm = jmodels.build_model(name)
    shapes = jax.eval_shape(lambda: jmodels.init_variables(jm, jax.random.PRNGKey(0)))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    with torch.device("meta"):
        model = tmodels._BUILDERS[name](F32_POLICY)
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()
            if not k.endswith("num_batches_tracked")}
    enc = model.encoder
    sd, skipped = jax_to_state_dict(zeros, enc.stage_depths)
    assert skipped == [] and {k: tuple(v.shape) for k, v in sd.items()} == want
    with pytest.raises(ValueError, match="stage depths"):
        jax_to_state_dict(zeros)
    assert len(enc.blocks) == blocks and enc.feature_dim == dim == jm.encoder.feature_dim
    jblocks = shapes["params"]["encoder"]
    assert len([k for k in jblocks if k.startswith("MBConv_")]) == blocks
    for i, blk in enumerate(enc.blocks):
        se = jblocks[f"MBConv_{i}"]["SqueezeExcitation_0"]["Conv_0"]["kernel"].shape
        assert blk.block[-2].fc1.out_channels == se[-1]


def test_registry_builds_with_simple_heads():
    """build_model gives B0 its single-Dense heads (Flatten, Dropout,
    Linear[, ReLU]: keys ``.2``), no seg decoder, and 9 blocks with
    stochastic depth (the residual ones after block 0)."""
    model = build_model("efficientnet_b0", device="cpu")
    keys = {k for k in model.state_dict() if k.startswith("fc_image")}
    assert keys == {f"{h}.2.{p}" for h in HEADS for p in ("weight", "bias")}
    assert not hasattr(model, "seg_decoder") and not model.supports_segment
    enc = model.encoder
    assert enc.sd_blocks == (2, 4, 6, 7, 9, 10, 12, 13, 14)
    assert all(enc.blocks[i].use_res for i in enc.sd_blocks)


def test_bridge_round_trip(fx):
    """The test's port -> JAX conversion has the JAX package's tree
    structure and shapes, and the bridge maps it back onto the port's
    state dict bit for bit."""
    v = fx["variables"]
    shapes = jax.eval_shape(lambda: jmodels.init_variables(_jax_model(),
                                                           jax.random.PRNGKey(0)))
    assert jax.tree_util.tree_structure(shapes) == jax.tree_util.tree_structure(v)
    assert all(a.shape == b.shape for a, b in zip(jax.tree_util.tree_leaves(shapes),
                                                  jax.tree_util.tree_leaves(v)))
    fresh = _port_model()
    assert load_jax_variables(fresh, v) == []
    got, want = _sd_of(fresh), _sd_of(fx["model"])
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---------------------------------------------------------------------------
# forwards
# ---------------------------------------------------------------------------

def _port_copy(fx, policy):
    model = _port_model(policy)
    model.load_state_dict(fx["model"].state_dict())
    return model


# f32: 1e-5 of each output's largest value (measured <= 2.5e-6). bf16: the
# two frameworks round the bf16 conv outputs, SiLU, the squeeze-excite gate
# and the residual adds in other places, 10 blocks deep (the port after
# every op; XLA keeps some fused chains in f32). Measured, as mean |error| /
# mean |f32 output| against the f32 outputs: the JAX bf16 0.009-0.053, the
# port's 0.011-0.063, 1.00-1.29x the JAX package's output by output; the
# two bf16 runs sit at most 0.073 of the largest value apart. Held: the
# port's mean error at most 1.6x the JAX bf16's (+ 2e-3), and the two
# within 0.1 of the largest value.
BF16_NOISE_RATIO, BF16_NOISE_ABS, BF16_TOL = 1.6, 2e-3, 0.1


def _mean_rel(got, want):
    return float(np.abs(got - want).mean() / np.abs(want).mean())


@pytest.mark.parametrize("policy", ["f32", "bf16"])
def test_forward_eval_matches_jax(fx, policy):
    """Eval mode: the encoder's (x4, x3, x2, x1), the tile logits and both
    image heads."""
    jp, tp = {"f32": (J_F32, F32_POLICY), "bf16": (J_BF16, DEFAULT_POLICY)}[policy]
    b, jm = fx["batch"], _jax_model(jp)

    def run(v, x):
        return (jm.apply(v, x, method=lambda m, x: m.encoder(x, train=False)),
                jm.apply(v, x, mode="tile"), jm.apply(v, x, mode="image"))

    def port(model):
        x = _x(b)
        with torch.no_grad():
            out = (*model.encoder(x), model(x, mode="tile"), *model(x, mode="image"))
        return [t.float().numpy() for t in out]

    jenc, jtile, jimg = jax.jit(run)(fx["variables"], jnormalize(b["images"], b["flip"]))
    want = [np.asarray(t, np.float32) for t in (*jenc, jtile, *jimg)]
    model = _port_copy(fx, tp)
    got = port(model)
    assert [t.shape for t in got[:4]] == [(B, 2, 2, 320), (B, 4, 4, 32),
                                          (B, 8, 8, 16), (B, 16, 16, 8)]
    assert all(t.dtype == tp.compute_dtype for t in model.encoder(_x(b)))
    if policy == "f32":
        for g, w in zip(got, want):
            assert _rel(g, w) <= 1e-5, _rel(g, w)
        return
    f32 = port(_port_copy(fx, F32_POLICY))
    for g, w, ref in zip(got, want, f32):
        d_port, d_jax = _mean_rel(g, ref), _mean_rel(w, ref)
        assert d_port <= BF16_NOISE_RATIO * d_jax + BF16_NOISE_ABS, (d_port, d_jax)
        assert _rel(g, w) <= BF16_TOL, _rel(g, w)


# f32 train mode: batch statistics over 8 images at 2x2 (x4) normalize each
# channel by 32 values, which amplifies rounding: outputs within 1e-4 of the
# largest (measured <= 1.4e-5), every running statistic within 1e-4 of its
# tensor's largest value (measured <= 2.8e-6).
def test_forward_train_matches_jax(fx, monkeypatch):
    """mode="image", train=True, the same dropout and stochastic-depth
    masks on both sides: both heads' outputs and every running statistic
    after flax's update; the statistics moved, and stochastic depth did
    act (the same step with every row kept differs)."""
    b, v = fx["batch"], fx["variables"]
    jm = _jax_model()

    @jax.jit
    def forward(v, x):
        return jm.apply(v, x, mode="image", train=True, mutable=["batch_stats"],
                        rngs={"dropout": jax.random.PRNGKey(0)})

    with _jax_masks(fx["masks"], monkeypatch):
        (jc, jr), mut = forward(v, jnormalize(b["images"], b["flip"]))
    model = _port_copy(fx, F32_POLICY)
    heads, sd = _port_masks(fx["masks"])
    with torch.no_grad():
        tc, tr = model(_x(b), mode="image", train=True, dropout_masks=heads, sd_masks=sd)
    assert _rel(tc.numpy(), jc) <= 1e-4 and _rel(tr.numpy(), jr) <= 1e-4
    want, _ = jax_to_state_dict({"params": v["params"], "batch_stats": mut["batch_stats"]},
                                model.encoder.stage_depths)
    got, before = _sd_of(model), _sd_of(fx["model"])
    stats = [k for k in want if "running_" in k]
    assert len(stats) == 2 * sum(isinstance(m, torch.nn.BatchNorm2d) for m in model.modules())
    for k in stats:
        assert _rel(got[k], want[k].numpy()) <= 1e-4, (k, _rel(got[k], want[k].numpy()))
        assert not np.array_equal(got[k], before[k]), k
    kept = _port_copy(fx, F32_POLICY)
    with torch.no_grad():
        kc, _ = kept(_x(b), mode="image", train=True, dropout_masks=heads,
                     sd_masks=[torch.ones(B, dtype=torch.bool)] * len(sd))
    assert _rel(kc.numpy(), tc.numpy()) > 1e-2


def test_masks_draw_encoder_first_then_heads(fx):
    """Without injected masks the encoder draws its stochastic-depth masks
    from the generator first, in forward order, then the class head and
    the count head draw theirs; in eval mode and with frozen encoder
    statistics nothing is drawn."""
    b = fx["batch"]
    model = _port_copy(fx, F32_POLICY)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        got = model(_x(b), mode="image", train=True,
                    generator=torch.Generator().manual_seed(7))
        model.load_state_dict(state)
        g = torch.Generator().manual_seed(7)
        sd = model.encoder.draw_sd_masks(B, g)
        heads = {h: getattr(model, h).draw_masks(B, g) for h in HEADS}
        want = model(_x(b), mode="image", train=True, dropout_masks=heads, sd_masks=sd)
        for a, w in zip(got, want):
            assert torch.equal(a, w)
        g = torch.Generator().manual_seed(7)
        model(_x(b), mode="image", train=True, freeze_encoder_stats=True, generator=g)
        heads_only = torch.Generator().manual_seed(7)
        model.fc_image_cls.draw_masks(B, heads_only)
        model.fc_image_reg.draw_masks(B, heads_only)
        assert torch.equal(torch.rand(3, generator=g), torch.rand(3, generator=heads_only))


# ---------------------------------------------------------------------------
# the train steps
# ---------------------------------------------------------------------------

LR = 1e-3


# One SGD update (momentum 0.9, weight decay 1e-4, lr 1e-3), f32 both sides,
# the same masks: the losses within 2e-5 relative (measured <= 3.7e-6), the
# running statistics within 1e-4 of their largest entry (<= 2.8e-6), and
# each partition's update within a relative L2 gap of 1e-3 (<= 1.9e-5).
def test_image_train_step_matches_jax(fx, monkeypatch):
    """make_image_train_step under injected dropout and stochastic-depth
    masks: the loss, every partition's updated parameters, the statistics;
    fc_tile untouched."""
    v, b = fx["variables"], fx["batch"]
    sched = jsched.make_schedule(None, LR, 1, 1)
    js = jstate.create_train_state(v["params"], v["batch_stats"], "image", sched,
                                   use_sgd=True)
    jstep = jsteps.make_image_train_step(_jax_model())
    with _jax_masks(fx["masks"], monkeypatch):
        js, jm = jstep(js, b, jax.random.PRNGKey(0))
    model = _port_copy(fx, F32_POLICY)
    ts = tstate.create_train_state(model, "image", tsched.make_schedule(None, LR, 1, 1),
                                   use_sgd=True, device="cpu")
    heads, sd = _port_masks(fx["masks"])
    ts, tm = tsteps.make_image_train_step(model, device="cpu")(
        ts, b, dropout_masks=heads, sd_masks=sd)
    for k in ("loss_cls", "loss_reg", "loss"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=2e-5, err_msg=k)
    want = {k: x.numpy() for k, x in jax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, js.variables), model.encoder.stage_depths)[0].items()}
    got, before = _sd_of(model), _sd_of(fx["model"])
    for k in (k for k in want if "running_" in k):
        assert _rel(got[k], want[k]) <= 1e-4, k
    for part in ("encoder", *HEADS):
        keys = [k for k in want if k.startswith(part) and "running_" not in k]
        ut = np.concatenate([(got[k] - before[k]).ravel() for k in keys])
        uj = np.concatenate([(want[k] - before[k]).ravel() for k in keys])
        assert np.abs(uj).max() > 0
        gap = np.linalg.norm(ut - uj) / np.linalg.norm(uj)
        assert gap <= 1e-3, (part, gap)
    for k in ("fc_tile.1.weight", "fc_tile.1.bias"):
        assert np.array_equal(got[k], before[k]) and np.array_equal(want[k], before[k])


def test_image_step_draws_from_seed_and_step(fx):
    """Without injected masks the step draws dropout and stochastic depth
    from (seed, step): the same pair gives the same loss, another step
    another loss; injected head masks alone still leave stochastic depth
    to the generator."""
    model = _port_copy(fx, F32_POLICY)
    step = tsteps.make_image_train_step(model, seed=7, device="cpu")
    heads, sd = _port_masks(fx["masks"])
    with torch.no_grad():
        a, b, c = (float(step.loss_fn(fx["batch"], step=s)[0]) for s in (3, 3, 4))
        d, e = (float(step.loss_fn(fx["batch"], heads, step=s)[0]) for s in (3, 4))
        f, g = (float(step.loss_fn(fx["batch"], heads, step=s, sd_masks=sd)[0])
                for s in (3, 4))
    assert a == b != c and d != e and f == g


def test_tile_train_step_matches_jax(fx):
    """make_tile_train_step, one Adam update on 10 selected tiles (every
    flip code, the last row masked out): the loss and fc_tile within 1e-5
    (f32 both sides; measured 2.4e-7 and 1.5e-8); the encoder runs on its
    running statistics without stochastic depth, its weights and statistics
    bit-unchanged."""
    v, imgs = fx["variables"], fx["batch"]["images"]
    rng = np.random.default_rng(4)
    batch = {"img_idx": rng.integers(0, len(imgs), 10).astype(np.int32),
             "xs": rng.integers(0, HW - 32 + 1, 10).astype(np.int32),
             "ys": rng.integers(0, HW - 32 + 1, 10).astype(np.int32),
             "flip": np.arange(10, dtype=np.int32) % 4,
             "label": rng.integers(0, 2, 10).astype(np.int32),
             "valid": np.arange(10) < 9}
    sched = jsched.make_schedule(None, LR, 1, 1)
    js = jstate.create_train_state(v["params"], v["batch_stats"], "tile", sched)
    js, jm = jsteps.make_tile_train_step(_jax_model(), 32)(js, jnp.asarray(imgs), batch)
    model = _port_copy(fx, F32_POLICY)
    enc0 = {k: x.clone() for k, x in model.encoder.state_dict().items()}
    ts = tstate.create_train_state(model, "tile", tsched.make_schedule(None, LR, 1, 1),
                                   device="cpu")
    ts, tm = tsteps.make_tile_train_step(model, 32, device="cpu")(
        ts, torch.from_numpy(imgs), batch)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=0, atol=1e-5)
    dense = js.params["fc_tile"]["Dense_0"]
    np.testing.assert_allclose(_np(model.fc_tile[1].weight), np.asarray(dense["kernel"]).T,
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(_np(model.fc_tile[1].bias), np.asarray(dense["bias"]),
                               rtol=0, atol=1e-5)
    for k, x in model.encoder.state_dict().items():
        assert torch.equal(x, enc0[k]), k


# ---------------------------------------------------------------------------
# the segment refusals
# ---------------------------------------------------------------------------

NO_DECODER = "EfficientNetEncoder has no segmentation decoder"


def test_segment_mode_refused_on_both_sides(fx):
    """Segment mode raises NotImplementedError with the JAX package's
    message on both sides; the port's set_trainable refuses the decoder it
    does not have, and an unknown partition is a KeyError."""
    x = _x(fx["batch"])
    with pytest.raises(NotImplementedError, match=NO_DECODER):
        jax.eval_shape(lambda v, x: _jax_model().apply(v, x, mode="segment"),
                       fx["variables"], jnp.asarray(x.numpy()))
    model = _port_copy(fx, F32_POLICY)
    with pytest.raises(NotImplementedError, match=NO_DECODER):
        model(x, mode="segment")
    with pytest.raises(NotImplementedError, match=NO_DECODER):
        model.set_trainable(("seg_decoder",))
    with pytest.raises(KeyError, match="decoder"):
        model.set_trainable(("decoder",))
