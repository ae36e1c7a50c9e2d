"""The port's stage 1 (image-count training) held against the JAX package on
the same weights (through the weight bridge) and the same numpy-seeded
inputs: the image heads and train-mode BatchNorm, the image train and infer
steps, ``inference_image``, ``evaluate_image`` and its pieces, and
``train_stage1`` end to end, plus the port's own exact resume. The train
step's grid over heads, losses and optimizers is in
``tests/test_torch_port_stage1_step.py``.

The model is ``MILNet(ResNetEncoder(Bottleneck, (1, 1, 1, 1)))`` at full
width with every BatchNorm (the heads' too) perturbed from its init values;
images are 64^2, so x4 is 2x2. A batch holds 6 valid rows and 2 padded
ones, copies of row 0 as ``BatchIterator`` pads: the loss ignores them but
every BatchNorm's batch statistics include them, on both sides.

Dropout: the JAX package draws its masks from ``jax.random`` and the port
from a ``torch.Generator``, so the tests inject the same keep masks into
both: on the JAX side by intercepting every non-deterministic
``nn.Dropout`` call (``flax.linen.intercept_methods``; the interceptor
runs at trace time, so one constant mask serves every step of one jitted
function), on the port side through ``dropout_masks``.
"""

from __future__ import annotations

import csv
import glob
import os

import numpy as np
import pytest
import torch

import flax.linen as nn
import jax
import jax.numpy as jnp

from cellsegmentation_tpu import evaluate as jeval
from cellsegmentation_tpu import infer as jinfer
from cellsegmentation_tpu.core.dtypes import DEFAULT_POLICY as J_BF16
from cellsegmentation_tpu.core.dtypes import F32_POLICY as J_F32
from cellsegmentation_tpu.data.batches import normalize_images as jnormalize
from cellsegmentation_tpu.data.lysto import LystoDataSource as JSource
from cellsegmentation_tpu.models import init_variables
from cellsegmentation_tpu.models.milnet import MILNet as JMILNet
from cellsegmentation_tpu.models.resnet import Bottleneck as JBottleneck
from cellsegmentation_tpu.models.resnet import ResNetEncoder as JEncoder
from cellsegmentation_tpu.ops import losses as jlosses
from cellsegmentation_tpu.ops import metrics as jmetrics
from cellsegmentation_tpu.train import steps as jsteps
from cellsegmentation_tpu.train.trainers import train_stage1 as jtrain_stage1
from cellsegmentation_tpu.utils.logging import RunLogger as JLogger

from cellsegmentation_tpu_torch import evaluate as teval
from cellsegmentation_tpu_torch import infer as tinfer
from cellsegmentation_tpu_torch.core.dtypes import DEFAULT_POLICY, F32_POLICY
from cellsegmentation_tpu_torch.data import LystoDataSource, normalize_images
from cellsegmentation_tpu_torch.models import Bottleneck, MILNet, ResNetEncoder
from cellsegmentation_tpu_torch.ops import losses as tlosses
from cellsegmentation_tpu_torch.ops import metrics as tmetrics
from cellsegmentation_tpu_torch.train import checkpoint as tckpt
from cellsegmentation_tpu_torch.train import steps as tsteps
from cellsegmentation_tpu_torch.train.trainers import train_stage1
from cellsegmentation_tpu_torch.utils.jax_weights import (
    jax_to_state_dict,
    load_jax_variables,
)
from cellsegmentation_tpu_torch.utils.logging import RunLogger

from test_torch_port_slice import one_torch_thread  # noqa: F401 (autouse)

SIZES = (1, 1, 1, 1)
HW, B, N_VALID = 64, 8, 6
HEADS = ("fc_image_cls", "fc_image_reg")
WIDTHS = ((2048, 0.25), (64, 0.5))  # (features, rate) of Dropout_0, Dropout_1


def _jax_model(policy):
    return JMILNet(encoder=JEncoder(block_cls=JBottleneck, stage_sizes=SIZES,
                                    policy=policy),
                   decoder_expansion=4, policy=policy)


def _port_model(policy, variables):
    model = MILNet(ResNetEncoder(Bottleneck, SIZES, policy=policy), policy=policy)
    assert load_jax_variables(model, variables) == []
    return model.eval()


def _perturb_bn(variables, seed=11):
    """Seeded non-trivial scale/bias/mean/var of every BatchNorm of the
    encoder and the image heads (numpy tree)."""
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    stats = jax.tree_util.tree_map(np.asarray, variables["batch_stats"])

    def walk(p, s):
        for k in p:
            if k.startswith("BatchNorm") or k == "bn1":
                c = p[k]["scale"].shape
                p[k]["scale"] = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
                p[k]["bias"] = (0.1 * rng.standard_normal(c)).astype(np.float32)
                s[k]["mean"] = (0.1 * rng.standard_normal(c)).astype(np.float32)
                s[k]["var"] = (1 + 0.2 * rng.random(c)).astype(np.float32)
            elif isinstance(p[k], dict) and k in s:
                walk(p[k], s[k])

    for part in ("encoder", *HEADS):
        walk(params[part], stats[part])
    return {"params": params, "batch_stats": stats}


def _noise(n, seed):
    """Seeded 64^2 images of uniform random pixels. BatchNorm on a batch of
    8 at 2x2 (x4) normalizes each channel by 32 values; varied content keeps
    those variances away from zero, where normalizing amplifies rounding,
    and leaves no ties in the stem's max-pool windows, where the two
    frameworks route the gradient to different elements."""
    return np.random.default_rng(seed).integers(0, 256, (n, HW, HW, 3)).astype(np.uint8)


def _masks(seed):
    """{(head, Dropout_i): keep mask [B, features]} for both heads."""
    rng = np.random.default_rng(seed)
    return {(h, f"Dropout_{i}"): rng.random((B, c)) >= rate
            for h in HEADS for i, (c, rate) in enumerate(WIDTHS)}


def _port_masks(masks):
    return {h: tuple(torch.from_numpy(masks[(h, f"Dropout_{i}")]) for i in range(2))
            for h in HEADS}


def _intercept(masks):
    """Every non-deterministic flax Dropout becomes where(mask, x/keep, 0)."""
    def interceptor(next_fun, args, kwargs, context):
        mod = context.module
        if isinstance(mod, nn.Dropout) and context.method_name == "__call__":
            det = nn.merge_param("deterministic", mod.deterministic,
                                 kwargs.get("deterministic"))
            if not det:
                x = args[0]
                keep = 1.0 - mod.rate
                return jnp.where(masks[tuple(mod.path[-2:])], x / keep,
                                 jnp.zeros_like(x))
        return next_fun(*args, **kwargs)

    return nn.intercept_methods(interceptor)


@pytest.fixture(scope="module")
def fx():
    jmodel = _jax_model(J_F32)
    v = _perturb_bn(init_variables(jmodel, jax.random.PRNGKey(0)))
    # the random count head's pre-ReLU output is negative on these images;
    # a raised bias puts it above zero, so the counts carry the gradient
    dense = v["params"]["fc_image_reg"]["Dense_1"]
    dense["bias"] = dense["bias"] + np.float32(5.0)
    rng = np.random.default_rng(5)
    imgs = _noise(N_VALID, seed=2)
    rows = np.concatenate([np.arange(N_VALID), np.zeros(B - N_VALID, int)])
    counts = rng.integers(0, 40, N_VALID)
    counts[:2] = (0, 25)  # a negative image and one in the ln-weight range
    batch = {
        "images": imgs[rows],
        "flip": (np.arange(B) % 4).astype(np.int32)[rows],
        "cls": np.digitize(counts, [1, 6, 11, 21, 51, 201]).astype(np.int32)[rows],
        "reg": counts.astype(np.float32)[rows],
        "valid": np.arange(B) < N_VALID,
    }
    return dict(jmodel=jmodel, variables=v, batch=batch, masks=_masks(3))


def _state_dict(model):
    return {k: v.detach().numpy().copy() for k, v in model.state_dict().items()
            if not k.endswith("num_batches_tracked")}


def _rel(got, want):
    """max |got - want| / max |want|."""
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _assert_state_close(model, jvariables, tol, keys=None):
    """Every entry of the port's state dict against the bridged JAX
    variables: max |diff| / max |entry| <= tol, entry by entry."""
    want, _ = jax_to_state_dict(jax.tree_util.tree_map(np.asarray, jvariables))
    got = _state_dict(model)
    assert set(got) == set(want)
    for k in keys or sorted(want):
        assert _rel(got[k], want[k].numpy()) <= tol, (k, _rel(got[k], want[k].numpy()))


# ---------------------------------------------------------------------------
# the image mode: heads, eval and train forwards, BatchNorm statistics
# ---------------------------------------------------------------------------


def test_bridge_skips_only_the_seg_decoder(fx):
    """Every image-head entry comes across: .1/.4/.5/.7 of both heads. The
    seg decoder, once skipped, comes across too: nothing is skipped."""
    model = _port_model(F32_POLICY, fx["variables"])
    sd, skipped = jax_to_state_dict(fx["variables"])
    assert skipped == []
    assert any(k.startswith("seg_decoder.") for k in sd)
    for h in HEADS:
        assert {k.split(".", 2)[1] for k in sd if k.startswith(h)} == {"1", "4", "5", "7"}
        np.testing.assert_array_equal(
            getattr(model, h)[4].weight.detach().numpy(),
            np.asarray(fx["variables"]["params"][h]["Dense_0"]["kernel"]).T)


# bf16: the encoder's convs round to bf16 in other places in XLA and
# oneDNN; the heads' Dense layers are bf16 too. 3e-2 of the largest output
# (the counts are O(1-10) on this fixture).
@pytest.mark.parametrize("policy,tol", [("f32", 1e-5), ("bf16", 3e-2)])
def test_image_forward_eval_matches_jax(fx, policy, tol):
    """mode="image" on running statistics: class logits and counts."""
    jp, tp = {"f32": (J_F32, F32_POLICY), "bf16": (J_BF16, DEFAULT_POLICY)}[policy]
    b = fx["batch"]
    jm = _jax_model(jp)
    jc, jr = jax.jit(lambda v, x: jm.apply(v, x, mode="image", train=False))(
        fx["variables"], jnormalize(b["images"], b["flip"]))
    model = _port_model(tp, fx["variables"])
    x = normalize_images(torch.from_numpy(b["images"]), torch.from_numpy(b["flip"]))
    with torch.no_grad():
        tc, tr = model(x, mode="image")
    assert tc.dtype == tr.dtype == torch.float32
    assert tc.shape == (B, 7) and tr.shape == (B, 1)
    assert _rel(tc.numpy(), np.asarray(jc)) <= tol
    assert _rel(tr.numpy(), np.asarray(jr)) <= tol


# f32: train-mode BatchNorm on 32 values a channel amplifies rounding, so
# 1e-4 of the largest output (the eval forward holds 1e-5). bf16: the JAX
# package's own bf16 run of this batch sits 0.058 / 0.021 (class / count)
# from its f32 run; the port's bf16 sits within 0.1 of the JAX bf16, and
# its statistics within 5e-2 (the heads' means of pooled bf16 features read
# 2.2e-2).
@pytest.mark.parametrize("policy,tol,stat_tol", [("f32", 1e-4, 1e-4),
                                                 ("bf16", 0.1, 5e-2)])
def test_image_forward_train_matches_jax(fx, policy, tol, stat_tol):
    """mode="image", train=True, the same keep masks on both sides: the
    outputs, and every running statistic after flax's update (the heads'
    BatchNorm1d included, whose batch of 8 would show torch's unbiased
    variance as 8/7). bf16 statistics: the stats of bf16 conv outputs move
    with their roundings."""
    jp, tp = {"f32": (J_F32, F32_POLICY), "bf16": (J_BF16, DEFAULT_POLICY)}[policy]
    b, v = fx["batch"], fx["variables"]
    jm = _jax_model(jp)

    @jax.jit
    def forward(v, x):
        return jm.apply(v, x, mode="image", train=True, mutable=["batch_stats"],
                        rngs={"dropout": jax.random.PRNGKey(0)})

    with _intercept(fx["masks"]):
        (jc, jr), mut = forward(v, jnormalize(b["images"], b["flip"]))
    model = _port_model(tp, v)
    x = normalize_images(torch.from_numpy(b["images"]), torch.from_numpy(b["flip"]))
    with torch.no_grad():
        tc, tr = model(x, mode="image", train=True,
                       dropout_masks=_port_masks(fx["masks"]))
    assert _rel(tc.numpy(), np.asarray(jc)) <= tol, _rel(tc.numpy(), np.asarray(jc))
    assert _rel(tr.numpy(), np.asarray(jr)) <= tol, _rel(tr.numpy(), np.asarray(jr))
    stats = [k for k in _state_dict(model) if "running_" in k]
    _assert_state_close(model, {"params": v["params"], "batch_stats": mut["batch_stats"]},
                        stat_tol, keys=stats)
    # the statistics did move, in the encoder and in both heads
    for k in ("encoder.layer4.0.bn3.running_var", "fc_image_cls.1.running_mean",
              "fc_image_reg.5.running_var"):
        before = jax_to_state_dict(v)[0][k].numpy()
        assert np.abs(_state_dict(model)[k] - before).max() > 1e-3, k


def test_frozen_encoder_stats_stay(fx):
    """freeze_encoder_stats: the encoder's statistics stay, the heads' move."""
    model = _port_model(F32_POLICY, fx["variables"])
    before = _state_dict(model)
    b = fx["batch"]
    x = normalize_images(torch.from_numpy(b["images"]), torch.from_numpy(b["flip"]))
    with torch.no_grad():
        model(x, mode="image", train=True, freeze_encoder_stats=True,
              dropout_masks=_port_masks(fx["masks"]))
    after = _state_dict(model)
    assert all(np.array_equal(after[k], before[k]) for k in after if k.startswith("encoder"))
    assert not np.array_equal(after["fc_image_cls.1.running_mean"],
                              before["fc_image_cls.1.running_mean"])


# ---------------------------------------------------------------------------
# the image train step
# ---------------------------------------------------------------------------

def test_step_dropout_follows_seed_and_step(fx):
    """Without injected masks the step draws them from (seed, step): the
    same pair gives the same loss, another step another loss."""
    model = _port_model(F32_POLICY, fx["variables"])
    step = tsteps.make_image_train_step(model, seed=7, device="cpu")
    with torch.no_grad():
        a = step.loss_fn(fx["batch"], step=3)[0]
        b = step.loss_fn(fx["batch"], step=3)[0]
        c = step.loss_fn(fx["batch"], step=4)[0]
    assert float(a) == float(b) != float(c)


# ---------------------------------------------------------------------------
# inference: the infer step, inference_image, evaluate_image and its pieces
# ---------------------------------------------------------------------------


def test_image_infer_step_matches_jax(fx):
    """Softmax probs and counts, f32 (1e-5 of the largest value)."""
    b = fx["batch"]
    jp, jc = jsteps.make_image_infer_step(fx["jmodel"])(fx["variables"], b["images"],
                                                        b["flip"])
    step = tsteps.make_image_infer_step(_port_model(F32_POLICY, fx["variables"]),
                                        device="cpu")
    tp, tc = step(b["images"], b["flip"])
    assert tp.shape == (B, 7) and tc.shape == (B,)
    assert _rel(tp.numpy(), np.asarray(jp)) <= 1e-5
    assert _rel(tc.numpy(), np.asarray(jc)) <= 1e-5


def _source(fx):
    b = fx["batch"]
    return LystoDataSource.from_arrays(
        b["images"][:N_VALID], [f"colon_{i}" for i in range(N_VALID)],
        b["reg"][:N_VALID].astype(int), kfold=None, augment=True)


def _jax_source(src):
    j = JSource.__new__(JSource)
    j.images, j.labels = src.images, src.labels
    j.base_idx, j.flip_code = src.base_idx, src.flip_code
    return j


@pytest.mark.parametrize("cls_limit", [False, True])
def test_inference_image_matches_jax(fx, cls_limit):
    """24 samples (every flip) in batches of 10, the last one padded: the
    same categories and counts. The count head's last Dense is scaled by
    30 and its bias moved down so the counts spread over 2..17 (three
    bins), and every raw count is checked to sit at least 1e-3 from a
    rounding boundary."""
    v = jax.tree_util.tree_map(np.array, fx["variables"])
    dense = v["params"]["fc_image_reg"]["Dense_1"]
    dense["kernel"] = dense["kernel"] * np.float32(30)
    dense["bias"] = dense["bias"] * np.float32(30) - np.float32(100)
    src = _source(fx)
    jfn = jsteps.make_image_infer_step(fx["jmodel"])
    _, raw = jfn(v, src.gather_images(np.arange(len(src))), src.flip_code)
    frac = np.abs(np.asarray(raw) % 1 - 0.5)
    assert frac.min() > 1e-3
    jcat, jcnt = jinfer.inference_image(_jax_source(src), jfn, v, batch_size=10,
                                        cls_limit=cls_limit)
    step = tsteps.make_image_infer_step(_port_model(F32_POLICY, v), device="cpu")
    tcat, tcnt = tinfer.inference_image(src, step, batch_size=10, cls_limit=cls_limit)
    np.testing.assert_array_equal(tcat, jcat)
    np.testing.assert_array_equal(tcnt, jcnt)
    assert len(np.unique(tcnt)) > 3


def test_count_helpers_match_jax():
    """_clean_counts (nan/inf/absurd), apply_cls_limit, evaluate_image and
    QWK on seeded inputs; the losses on seeded tensors."""
    rng = np.random.default_rng(9)
    regs = rng.normal(20, 30, 200).astype(np.float32)
    regs[:6] = [np.nan, np.inf, -np.inf, 1e9, -3.0, 0.5]
    np.testing.assert_array_equal(tinfer._clean_counts(regs), jinfer._clean_counts(regs))
    counts = tinfer._clean_counts(regs)
    cats = rng.integers(0, 7, 200)
    np.testing.assert_array_equal(tinfer.apply_cls_limit(counts, cats),
                                  jinfer.apply_cls_limit(counts, cats))
    labels = rng.integers(0, 300, 200)
    assert teval.evaluate_image(labels, cats, counts) == \
        jeval.evaluate_image(labels, cats, counts)
    assert teval.evaluate_image(labels, cats, counts)[2] != 0.0
    for a, b in ((counts.clip(0, 600), labels), (cats, rng.integers(0, 7, 200)),
                 (np.zeros(5, int), np.zeros(5, int))):
        assert tmetrics.quadratic_weighted_kappa(a, b) == \
            jmetrics.quadratic_weighted_kappa(a, b)
    x = rng.normal(10, 8, (64,)).astype(np.float32)
    t = rng.integers(0, 60, 64).astype(np.float32)
    logits = rng.normal(0, 2, (64, 7)).astype(np.float32)
    lab = rng.integers(0, 7, 64)
    tx, tt = torch.from_numpy(x), torch.from_numpy(t)
    for red in ("mean", "sum"):
        np.testing.assert_allclose(float(tlosses.weighted_mse(tx, tt, red)),
                                   float(jlosses.weighted_mse(x, t, red)), rtol=1e-6)
        np.testing.assert_allclose(float(tlosses.mse(tx, tt, red)),
                                   float(jlosses.mse(x, t, red)), rtol=1e-6)
    np.testing.assert_allclose(
        float(tlosses.cross_entropy(torch.from_numpy(logits), torch.from_numpy(lab))),
        float(jlosses.cross_entropy(logits, lab)), rtol=1e-6)


# ---------------------------------------------------------------------------
# train_stage1 end to end, and resume
# ---------------------------------------------------------------------------

# lr 1e-5: Adam moves every parameter by about lr a step, and the sign ties
# of each step (see above) then move a few hundred by 2 * lr on one side
# only; at 1e-3 ten such steps drift the class loss by 4%, at 1e-5 they
# stay near rounding.
STAGE1 = dict(epochs=2, batch_size=B, lr=1e-5, seed=0, test_every=1)


def _stage1_sources(fx):
    imgs = _noise(12, seed=4)
    counts = np.random.default_rng(8).integers(0, 30, 12)
    organs = [f"colon_{i}" for i in range(12)]
    train = LystoDataSource.from_arrays(imgs, organs, counts, kfold=4, augment=True)
    val = LystoDataSource.from_arrays(imgs, organs, counts, train=False, kfold=4)
    return train, val


def _csv(logdir, stream):
    (path,) = glob.glob(os.path.join(logdir, f"*-{stream}.csv"))
    with open(path) as f:
        rows = list(csv.reader(f))
    return rows[0], [[float(x) for x in r] for r in rows[1:]]


def _fixed_masks(monkeypatch, masks):
    """The port's heads draw the fixture's masks at every step (the reg
    head is the one with the output ReLU)."""
    from cellsegmentation_tpu_torch.models.common import ImageHeadMLP

    pairs = _port_masks(masks)
    monkeypatch.setattr(
        ImageHeadMLP, "draw_masks",
        lambda self, *a, **k: pairs[HEADS[1] if self.relu_out else HEADS[0]])


def _port_stage1(fx, logdir, **kw):
    train, val = _stage1_sources(fx)
    model = _port_model(F32_POLICY, fx["variables"])
    res = train_stage1(model, train, val, logger=RunLogger(logdir, tensorboard=False),
                       device="cpu", **dict(STAGE1, **kw))
    return model, res, train


def test_train_stage1_matches_jax(fx, tmp_path, monkeypatch):
    """Two epochs (36 samples, batches of 8, the last padded), validation
    every epoch and hard-example resampling at threshold 10, the same masks
    at every step on both sides: the CSV headers equal, the epoch losses
    within 1e-3 relative, the validation rows equal, and the same rows
    resampled."""
    jlog, tlog = str(tmp_path / "jax"), str(tmp_path / "port")
    train, val = _stage1_sources(fx)
    jtrain = _jax_source(train)
    jtrain._rng = np.random.default_rng(0)
    with _intercept(fx["masks"]):
        rj = jtrain_stage1(fx["jmodel"], jax.device_put(fx["variables"]), jtrain,
                           _jax_source(val), logger=JLogger(jlog, tensorboard=False),
                           hard_threshold=10, **STAGE1)
    _fixed_masks(monkeypatch, fx["masks"])
    model, rt, ttrain = _port_stage1(fx, tlog, hard_threshold=10)
    hj, lj = _csv(jlog, "image-training")
    ht, lt = _csv(tlog, "image-training")
    assert ht == hj == ["epoch", "image_cls_loss", "image_reg_loss", "image_loss"]
    np.testing.assert_allclose(lt, lj, rtol=1e-3)
    assert _csv(tlog, "image-validation") == _csv(jlog, "image-validation")
    assert rt.last_metrics == tuple(rj.last_metrics)
    for key in ("base_idx", "flip_code", "labels"):
        np.testing.assert_array_equal(getattr(ttrain, key), getattr(jtrain, key))
    assert len(ttrain) == len(train) and not np.array_equal(ttrain.base_idx, train.base_idx)
    assert [e["steps"] for e in rt.epoch_stats] == [5, 5]


def test_train_stage1_resume_is_exact(fx, tmp_path):
    """Two epochs straight equal one epoch, its pt1 checkpoint and a
    resumed second epoch, bit for bit: weights, statistics, Adam state,
    the step, the losses (the dropout masks follow the step)."""
    straight, r2, _ = _port_stage1(fx, str(tmp_path / "a"))
    out = str(tmp_path / "ckpt")
    _port_stage1(fx, str(tmp_path / "b"), epochs=1, output_dir=out)
    ck = tckpt.load_checkpoint(os.path.join(out, "pt1_1epochs.ckpt"))
    assert ck["mode"] == "image" and ck["epoch"] == 1 and ck["step"] == 5
    assert {k.split(".")[0] for k in ck["state_dict"]} == {"encoder", *HEADS}
    train, val = _stage1_sources(fx)
    resumed = _port_model(F32_POLICY, fx["variables"])
    with torch.no_grad():
        resumed.fc_image_reg[7].weight.zero_()  # the checkpoint must restore it
    tckpt.restore_into(resumed, ck, tckpt.STAGE_SAVE_PARTITIONS["image"])
    r1 = train_stage1(resumed, train, val, last_epoch=1, resume_opt_state=ck["optimizer"],
                      logger=RunLogger(str(tmp_path / "c"), tensorboard=False),
                      device="cpu", **STAGE1)
    assert r1.epoch_stats[0]["loss"] == r2.epoch_stats[1]["loss"]
    assert r1.last_metrics == r2.last_metrics and r1.state.step == r2.state.step == 10
    for k, x in straight.state_dict().items():
        assert torch.equal(x, resumed.state_dict()[k]), k
    sa, sb = (r.state.optimizer.state_dict()["state"] for r in (r2, r1))
    for i in sa:
        for name in sa[i]:
            assert torch.equal(torch.as_tensor(sa[i][name]),
                               torch.as_tensor(sb[i][name])), (i, name)


def test_restore_into_merges_named_partitions_only(fx, tmp_path):
    """A pt1 file into a fresh model: the named partitions come from the
    file, every other entry stays the model's."""
    src = _port_model(F32_POLICY, fx["variables"])
    with torch.no_grad():
        for p in src.parameters():
            p.add_(1.0)
    path = tckpt.save_checkpoint(str(tmp_path), "image", 3, "resnet50", src.state_dict())
    ck = tckpt.load_checkpoint(path)
    dst = _port_model(F32_POLICY, fx["variables"])
    fresh = {k: v.clone() for k, v in dst.state_dict().items()}
    tckpt.restore_into(dst, ck, ("encoder",))
    for k, x in dst.state_dict().items():
        want = src.state_dict()[k] if k.startswith("encoder") else fresh[k]
        assert torch.equal(x, want), k
    tckpt.restore_into(dst, ck)
    for k, x in dst.state_dict().items():
        # a pt1 file holds no tile head and no seg decoder
        want = fresh[k] if k.startswith(("fc_tile", "seg_decoder")) else src.state_dict()[k]
        assert torch.equal(x, want), k
