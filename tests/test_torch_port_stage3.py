"""The port's stage-3 model held against the JAX package on the same weights
(through the weight bridge) and the same numpy-seeded inputs: the
align-corners resize, the seg decoder and ``mode="segment"`` in eval and
train mode, the soft dice losses, the seg train step over two updates and
the seg infer step.

The model is ``MILNet(ResNetEncoder(Bottleneck, (1, 1, 1, 1)))`` at full
width, so the decoder runs at expansion 4 (widths 1024..64), with every
BatchNorm of the encoder and the decoder and the output conv's bias
perturbed from their init values. Images are 64^2: the decoder upsamples
2 -> 4 -> 8 -> 16 -> 32 -> 64. A batch holds 3 valid rows and one padded
one, a copy of row 0 as ``BatchIterator`` pads: the loss ignores it, every
train-mode BatchNorm's statistics include it, on both sides.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cellsegmentation_tpu.core.dtypes import DEFAULT_POLICY as J_BF16
from cellsegmentation_tpu.core.dtypes import F32_POLICY as J_F32
from cellsegmentation_tpu.data.batches import normalize_images as jnormalize
from cellsegmentation_tpu.models import init_variables
from cellsegmentation_tpu.models.milnet import MILNet as JMILNet
from cellsegmentation_tpu.models.resnet import Bottleneck as JBottleneck
from cellsegmentation_tpu.models.resnet import ResNetEncoder as JEncoder
from cellsegmentation_tpu.ops import losses as jlosses
from cellsegmentation_tpu.ops.resize import resize_bilinear_align_corners as jresize
from cellsegmentation_tpu.train import schedules as jsched
from cellsegmentation_tpu.train import state as jstate
from cellsegmentation_tpu.train import steps as jsteps

from cellsegmentation_tpu_torch.core.dtypes import DEFAULT_POLICY, F32_POLICY
from cellsegmentation_tpu_torch.data import normalize_images
from cellsegmentation_tpu_torch.models import Bottleneck, MILNet, ResNetEncoder
from cellsegmentation_tpu_torch.ops import losses as tlosses
from cellsegmentation_tpu_torch.ops.resize import resize_bilinear_align_corners
from cellsegmentation_tpu_torch.train import schedules as tsched
from cellsegmentation_tpu_torch.train import state as tstate
from cellsegmentation_tpu_torch.train import steps as tsteps
from cellsegmentation_tpu_torch.utils.jax_weights import (
    jax_to_state_dict,
    load_jax_variables,
)

from test_torch_port_slice import one_torch_thread  # noqa: F401 (autouse)

SIZES = (1, 1, 1, 1)
HW, B, N_VALID = 64, 4, 3
LR = 1e-3


def _jax_model(policy):
    return JMILNet(encoder=JEncoder(block_cls=JBottleneck, stage_sizes=SIZES,
                                    policy=policy),
                   decoder_expansion=4, policy=policy)


def _port_model(policy, variables):
    model = MILNet(ResNetEncoder(Bottleneck, SIZES, policy=policy), policy=policy)
    assert load_jax_variables(model, variables) == []
    return model.eval()


def perturb(variables, seed=11):
    """Seeded non-trivial scale/bias/mean/var of every BatchNorm of the
    encoder and the decoder, and a nonzero output-conv bias (numpy tree)."""
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

    for part in ("encoder", "seg_decoder"):
        walk(params[part], stats[part])
    conv = params["seg_decoder"]["Conv_0"]
    conv["bias"] = (0.1 * rng.standard_normal(2)).astype(np.float32)
    return {"params": params, "batch_stats": stats}


def seg_batch(seed=2):
    """B images of uniform noise (3 valid + row 0 again), flip codes 0..3,
    asymmetric 0/1 masks."""
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (N_VALID, HW, HW, 3)).astype(np.uint8)
    masks = np.zeros((N_VALID, HW, HW), np.int32)
    masks[:, 10:40, 5:30] = 1
    masks[1, 50:, :] = 1
    rows = np.r_[np.arange(N_VALID), np.zeros(B - N_VALID, int)]
    return {"images": imgs[rows], "flip": np.asarray([0, 1, 3, 0], np.int32),
            "mask": masks[rows], "valid": np.arange(B) < N_VALID}


@pytest.fixture(scope="module")
def fx():
    v = perturb(init_variables(_jax_model(J_F32), jax.random.PRNGKey(0)))
    return dict(variables=v, batch=seg_batch())


def _state_dict(model):
    return {k: x.detach().numpy().copy() for k, x in model.state_dict().items()
            if not k.endswith("num_batches_tracked")}


def _rel(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# resize, decoder, segment mode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 4), (10, 19), (75, 150), (150, 299), (1, 2)],
                         ids=lambda s: f"{s[0]}to{s[1]}")
def test_resize_matches_jax(shape):
    """The gather-lerp resize: bf16 output bit-equal to the JAX lerp (both
    round every op in bf16, H first), f32 within 5e-7 (summation order).
    ``F.interpolate(align_corners=True)`` interpolates in f32 and rounds
    once: on the same bf16 input it differs from the JAX lerp on 7-60% of
    the elements (by up to 0.047 here), so the port keeps the gathers."""
    hi, ho = shape
    x = np.random.default_rng(hi).standard_normal((2, hi, hi, 8)).astype(np.float32)
    for dt, jdt in ((torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32)):
        want = np.asarray(jax.jit(lambda a: jresize(a, ho, ho))(
            jnp.asarray(x).astype(jdt)).astype(jnp.float32))
        got = resize_bilinear_align_corners(torch.from_numpy(x).to(dt), ho, ho)
        assert got.dtype == dt and got.shape == (2, ho, ho, 8)
        if dt == torch.bfloat16:
            np.testing.assert_array_equal(got.float().numpy(), want)
            interp = F.interpolate(torch.from_numpy(x).to(dt).permute(0, 3, 1, 2),
                                   size=(ho, ho), mode="bilinear", align_corners=True)
            off = float((interp.permute(0, 2, 3, 1).float().numpy() != want).mean())
            assert (off > 0.05) == (hi > 1), off
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=5e-7)


def test_bridge_maps_the_seg_decoder(fx):
    """Every seg-decoder entry comes across under the reference's names
    (upconv1..8, seg_out_conv); nothing is skipped; the widths are the
    expansion-4 ones."""
    sd, skipped = jax_to_state_dict(fx["variables"])
    assert skipped == []
    model = _port_model(F32_POLICY, fx["variables"])
    dec = model.seg_decoder
    assert [getattr(dec, f"upconv{k}")[0].out_channels for k in range(1, 9)] == \
        [1024, 1024, 512, 512, 256, 256, 128, 64]
    assert [getattr(dec, f"upconv{k}")[0].in_channels for k in range(1, 9)] == \
        [2048, 2048, 1024, 1024, 512, 512, 256, 128]
    assert dec.upconv1[0].bias is None and dec.seg_out_conv.bias is not None
    np.testing.assert_array_equal(
        dec.seg_out_conv.bias.detach().numpy(),
        fx["variables"]["params"]["seg_decoder"]["Conv_0"]["bias"])
    assert {k.split(".")[1] for k in sd if k.startswith("seg_decoder.")} == \
        {*(f"upconv{k}" for k in range(1, 9)), "seg_out_conv"}


def test_reference_conv_bias_folds_into_the_running_mean(fx):
    """A reference state dict's ``upconv<k>.0.bias`` folds into that unit's
    running mean as it loads: the unit's eval output equals a conv with
    that bias followed by the unfolded BatchNorm."""
    model = _port_model(F32_POLICY, fx["variables"])
    unit = model.seg_decoder.upconv3
    ref = {k: v.clone() for k, v in unit.state_dict().items()}
    bias = torch.from_numpy(np.random.default_rng(4).standard_normal(512)
                            .astype(np.float32))
    ref["0.bias"] = bias
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 1024, 5, 5))
                         .astype(np.float32))
    with torch.no_grad():
        bn = unit[1]
        want = F.relu(F.batch_norm(F.conv2d(x, unit[0].weight, bias, padding=1),
                                   bn.running_mean, bn.running_var, bn.weight,
                                   bn.bias, False, 0.0, bn.eps))
        unit.load_state_dict(ref)
        got = unit(x)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


# f32: 1e-5 of the largest logit (measured 4.5e-6); train mode 1e-4 (1.7e-5):
# train-mode BatchNorm over 64 values a channel at the decoder's first
# units amplifies rounding. bf16: convs round in other places in XLA and
# oneDNN, and the decoder's eight units carry the differences on: measured
# 2.2e-2 (eval) / 7.2e-2 (train) of the largest logit, held at 5e-2 / 0.15.
# Running statistics: f32 1e-4 of each entry's largest value (2.3e-6), bf16
# 5e-2 (9.9e-3).
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("policy", ["f32", "bf16"])
def test_segment_forward_matches_jax(fx, policy, train):
    """mode="segment": f32 logits [B, H, W, 2] on running statistics, or in
    train mode with every running statistic after flax's update."""
    jp, tp = {"f32": (J_F32, F32_POLICY), "bf16": (J_BF16, DEFAULT_POLICY)}[policy]
    tol, stat_tol = {("f32", False): (1e-5, 0), ("f32", True): (1e-4, 1e-4),
                     ("bf16", False): (5e-2, 0), ("bf16", True): (0.15, 5e-2)}[
                         (policy, train)]
    v, b = fx["variables"], fx["batch"]
    jm = _jax_model(jp)
    x = jnormalize(b["images"], b["flip"])
    if train:
        want, mut = jax.jit(lambda v, x: jm.apply(
            v, x, mode="segment", train=True, mutable=["batch_stats"]))(v, x)
    else:
        want = jax.jit(lambda v, x: jm.apply(v, x, mode="segment"))(v, x)
    model = _port_model(tp, v)
    with torch.no_grad():
        got = model(normalize_images(torch.from_numpy(b["images"]),
                                     torch.from_numpy(b["flip"])),
                    mode="segment", train=train)
    assert got.dtype == torch.float32 and got.shape == (B, HW, HW, 2)
    assert _rel(got.numpy(), np.asarray(want)) <= tol
    if train:
        stats = jax_to_state_dict({"params": v["params"], "batch_stats":
                                   jax.tree_util.tree_map(np.asarray,
                                                          mut["batch_stats"])})[0]
        sd = _state_dict(model)
        before = jax_to_state_dict(v)[0]
        for k in (k for k in stats if "running_" in k):
            assert _rel(sd[k], stats[k].numpy()) <= stat_tol, k
            moved = not np.array_equal(sd[k], before[k].numpy())
            assert moved == k.startswith(("encoder.", "seg_decoder.")), k


def test_freeze_encoder_stats_keeps_the_encoder_on_running_statistics(fx):
    """train=True with freeze_encoder_stats: the encoder's statistics stay,
    the decoder's move."""
    model = _port_model(F32_POLICY, fx["variables"])
    before = _state_dict(model)
    b = fx["batch"]
    with torch.no_grad():
        model(normalize_images(torch.from_numpy(b["images"]),
                               torch.from_numpy(b["flip"])),
              mode="segment", train=True, freeze_encoder_stats=True)
    after = _state_dict(model)
    for k in (k for k in after if "running_" in k):
        moved = not np.array_equal(after[k], before[k])
        assert moved == k.startswith("seg_decoder."), k


# ---------------------------------------------------------------------------
# dice, the seg steps
# ---------------------------------------------------------------------------


def test_dice_matches_jax():
    """dice_coef in the 2-D scalar form and the per-row form, and
    dice_loss with both reductions: within 1e-6 (f32 sums)."""
    rng = np.random.default_rng(6)
    p = rng.random((3, 9, 11)).astype(np.float32)
    m = (rng.random((3, 9, 11)) > 0.6).astype(np.float32)
    for a, b in ((p[0], m[0]), (p, m)):
        want = np.asarray(jlosses.dice_coef(jnp.asarray(a), jnp.asarray(b)))
        got = tlosses.dice_coef(torch.from_numpy(a), torch.from_numpy(b)).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-6)
    for red in ("mean", "sum"):
        want = float(jlosses.dice_loss(jnp.asarray(p), jnp.asarray(m), reduction=red))
        got = float(tlosses.dice_loss(torch.from_numpy(p), torch.from_numpy(m),
                                      reduction=red))
        np.testing.assert_allclose(got, want, rtol=1e-6)
    empty = np.zeros((2, 4, 4), np.float32)
    assert float(tlosses.dice_coef(torch.from_numpy(empty),
                                   torch.from_numpy(empty))[0]) == 1.0


def _run(fx, n, use_sgd, keep):
    """n seg steps on the fixture batch, f32, JAX then port: (JAX metrics,
    JAX state dict after step ``keep``, port metrics, port state dict after
    step ``keep``)."""
    v, b = fx["variables"], fx["batch"]
    name = "OneCycleLR" if use_sgd else None
    js = jstate.create_train_state(v["params"], v["batch_stats"], "segment",
                                   jsched.make_schedule(name, LR, 2, 4),
                                   use_sgd=use_sgd)
    jstep = jsteps.make_seg_train_step(_jax_model(J_F32))
    jm = []
    for i in range(1, n + 1):
        js, m = jstep(js, b, jax.random.PRNGKey(0))
        jm.append({k: float(x) for k, x in m.items()})
        if i == keep:
            tree = jax.tree_util.tree_map(np.asarray, {"params": js.params,
                                                       "batch_stats": js.batch_stats})
            jsd = {k: x.numpy() for k, x in jax_to_state_dict(tree)[0].items()}
    model = _port_model(F32_POLICY, v)
    ts = tstate.create_train_state(model, "segment",
                                   tsched.make_schedule(name, LR, 2, 4),
                                   use_sgd=use_sgd, device="cpu")
    tstep = tsteps.make_seg_train_step(model, device="cpu")
    tm = []
    for i in range(1, n + 1):
        ts, m = tstep(ts, b)
        tm.append({k: float(x) for k, x in m.items()})
        if i == keep:
            tsd = _state_dict(model)
    assert ts.step == int(js.step) == n
    return jm, jsd, tm, tsd


def _updates(sd, before, part):
    keys = [k for k in sd if k.startswith(part) and "running_" not in k]
    return np.concatenate([(sd[k] - before[k]).ravel() for k in keys])


# Two SGD (OneCycleLR) updates, f32 (measured in brackets): losses within
# 1e-5 relative (2e-7), the decoder's updates within 2e-2 relative L2 of
# JAX's (2.6e-3), every running statistic within 1e-4 of its largest value
# (6.3e-6), the encoder's parameters unchanged on both sides.
def test_seg_train_step_two_updates_match_jax(fx):
    jm, want, tm, got = _run(fx, 2, use_sgd=True, keep=2)
    before = {k: x.numpy() for k, x in jax_to_state_dict(fx["variables"])[0].items()}
    for a, b in zip(tm, jm):
        assert a.keys() == b.keys() == {"loss_ce", "loss_dice", "loss"}
        for k in b:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, err_msg=k)
    assert jm[1]["loss"] < jm[0]["loss"]
    ut, uj = _updates(got, before, "seg_decoder"), _updates(want, before, "seg_decoder")
    assert np.linalg.norm(ut - uj) / np.linalg.norm(uj) <= 2e-2
    assert np.abs(ut).max() > 0
    for k in got:
        if "running_" in k:
            assert _rel(got[k], want[k]) <= 1e-4, k
            moved = not np.array_equal(got[k], before[k])
            assert moved == k.startswith(("encoder.", "seg_decoder.")), k
        elif k.startswith(("encoder.", "fc_")):
            assert np.array_equal(got[k], before[k]), k
            assert np.array_equal(want[k], before[k]), k


# Adam's first update is lr * g / (|g| + eps), about +-lr whatever |g|: a
# gradient that is zero up to rounding takes either sign on the two sides
# (0.23% of the decoder's entries here). Held: the share of entries whose
# updates differ by more than lr / 100 at most 5e-3, every entry within
# 2 * lr; the losses within 1e-5 relative (2e-7). After a second update
# those ties have moved the model: its loss read 1.9e-4 apart.
def test_seg_train_step_adam_matches_jax(fx):
    jm, jsd, tm, tsd = _run(fx, 1, use_sgd=False, keep=1)
    before = {k: x.numpy() for k, x in jax_to_state_dict(fx["variables"])[0].items()}
    ut = _updates(tsd, before, "seg_decoder")
    uj = _updates(jsd, before, "seg_decoder")
    assert float((np.abs(ut - uj) > LR / 100).mean()) <= 5e-3
    assert np.abs(ut - uj).max() <= 2 * LR * (1 + 1e-3)
    for k in jm[0]:
        np.testing.assert_allclose(tm[0][k], jm[0][k], rtol=1e-5, err_msg=k)


def test_seg_infer_step_matches_jax(fx):
    """P(positive) [B, H, W] on running statistics, f32: within 1e-5."""
    v, b = fx["variables"], fx["batch"]
    want = np.asarray(jsteps.make_seg_infer_step(_jax_model(J_F32))(
        v, b["images"], b["flip"]))
    got = tsteps.make_seg_infer_step(_port_model(F32_POLICY, v), device="cpu")(
        b["images"], b["flip"])
    assert got.shape == (B, HW, HW) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
