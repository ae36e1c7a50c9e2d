"""The port's stage-2 MIL training cycle held against the JAX package on the
same weights (through the weight bridge) and the same numpy-seeded inputs:
schedules, the optimizer, the selected-tile train step, the stack sweep,
``evaluate_tile``, and ``train_stage2`` end to end, with the q8dg engine's
JAX side in interpret mode (``TILE_ALIGN`` cut to 32, as its own tests do).

The model is the reduced-depth Bottleneck MILNet of the serving-slice tests
(``stage_sizes=(1, 1, 2, 2)``, full width, perturbed BatchNorm) under the
f32 policy, so the exact paths agree to f32 summation order. Images are
52^2 with 16-px tiles at interval 8 (36 tiles), whose 4-px blocks of
seeded random colour make every tile's content distinct: the top-k margins
of the selection are then decisive, which the cycle test asserts.
"""

from __future__ import annotations

import csv
import glob
import os

import numpy as np
import pytest
import torch

import jax

from cellsegmentation_tpu import evaluate as jeval
from cellsegmentation_tpu import infer as jinfer
from cellsegmentation_tpu.core.dtypes import F32_POLICY as J_F32
from cellsegmentation_tpu.data.lysto import LystoDataSource as JSource
from cellsegmentation_tpu.models import init_variables
from cellsegmentation_tpu.ops import q8_trunk as jqt
from cellsegmentation_tpu.ops.tiles import tile_grid
from cellsegmentation_tpu.train import schedules as jsched
from cellsegmentation_tpu.train import state as jstate
from cellsegmentation_tpu.train import steps as jsteps
from cellsegmentation_tpu.train.trainers import train_stage2 as jtrain_stage2
from cellsegmentation_tpu.utils.logging import RunLogger as JLogger

from cellsegmentation_tpu_torch import evaluate as teval
from cellsegmentation_tpu_torch.core.dtypes import F32_POLICY
from cellsegmentation_tpu_torch.data import LystoDataSource
from cellsegmentation_tpu_torch.train import checkpoint as tckpt
from cellsegmentation_tpu_torch.train import schedules as tsched
from cellsegmentation_tpu_torch.train import state as tstate
from cellsegmentation_tpu_torch.train import steps as tsteps
from cellsegmentation_tpu_torch.train.trainers import train_stage2
from cellsegmentation_tpu_torch.utils.logging import RunLogger

from test_torch_port_slice import (  # noqa: F401 (one_torch_thread: autouse)
    _jax_model,
    _perturb_bn,
    _port_model,
    one_torch_thread,
)

HW, TILE, INTERVAL = 52, 16, 8
# the random tile head's kernel x4: probs spread over ~0.1..0.9 instead of
# ~0.45..0.6, so the selection boundaries sit further apart
HEAD_SCALE = 4.0


def _blocky_images(n, seed, block=4):
    rng = np.random.default_rng(seed)
    nb = -(-HW // block)
    b = rng.integers(0, 256, (n, nb, nb, 3)).astype(np.uint8)
    return np.ascontiguousarray(b.repeat(block, 1).repeat(block, 2)[:, :HW, :HW])


@pytest.fixture(scope="module")
def fx():
    jmodel = _jax_model(J_F32)
    v = _perturb_bn(init_variables(jmodel, jax.random.PRNGKey(0)))
    dense = v["params"]["fc_tile"]["Dense_0"]
    dense["kernel"] = dense["kernel"] * np.float32(HEAD_SCALE)
    return dict(jmodel=jmodel, variables=v, images=_blocky_images(8, seed=2),
                counts=np.asarray([0, 1, 2, 3] * 2),
                organs=[f"colon_{i}" for i in range(8)])


def _fc_tile(jparams):
    d = jparams["fc_tile"]["Dense_0"]
    return np.asarray(d["kernel"]).T, np.asarray(d["bias"])


# ---------------------------------------------------------------------------
# schedules and the optimizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,epochs,spe", [
    (None, 10, 4), ("OneCycleLR", 10, 4), ("OneCycleLR", 1, 1),
    ("ExponentialLR", 10, 4), ("CosineAnnealingWarmRestarts", 10, 4),
])
def test_schedules_match_jax(name, epochs, spe):
    """Every schedule at steps 0..3 epochs against the JAX package's (optax
    for OneCycleLR, the short one through its 4-step guard): rtol 1e-6,
    the JAX side evaluates in f32."""
    t = tsched.make_schedule(name, 1e-3, epochs, spe, t0=5)
    j = jsched.make_schedule(name, 1e-3, epochs, spe, t0=5)
    for step in range(3 * spe + 1):
        np.testing.assert_allclose(t(step), float(j(step)), rtol=1e-6,
                                   err_msg=f"{name} step {step}")


@pytest.mark.parametrize("scheduler", [None, "OneCycleLR"])
def test_optimizer_matches_jax(fx, scheduler):
    """create_train_state + apply_gradients for the same gradients over 5
    steps: Adam without a scheduler, SGD with momentum with one, weight
    decay 0.01 on both, lr 0.01 (SGD: OneCycle's peak). fc_tile within
    1e-6; the frozen encoder unchanged on both sides, bit for bit. The JAX
    side computes Adam's bias correction 1 - 0.999^t in f32, 1.3e-5
    relative off at t = 1 (torch computes it in double), which moves its
    update by ~6e-6 relative: ~3e-7 absolute after these 5 steps."""
    model = _port_model(F32_POLICY, fx["variables"])
    enc0 = {k: v.clone() for k, v in model.encoder.state_dict().items()}
    w0 = model.fc_tile[1].weight.detach().numpy().copy()
    b0 = model.fc_tile[1].bias.detach().numpy().copy()
    enc_leaf = np.ones((3, 3), np.float32)
    jparams = {"encoder": {"w": enc_leaf},
               "fc_tile": {"Dense_0": {"kernel": w0.T.copy(), "bias": b0}}}
    kw = dict(use_sgd=scheduler is not None, weight_decay=0.01)
    j = jstate.create_train_state(
        jparams, {}, "tile", jsched.make_schedule(scheduler, 0.01, 3, 2), **kw)
    t = tstate.create_train_state(
        model, "tile", tsched.make_schedule(scheduler, 0.01, 3, 2),
        device="cpu", **kw)
    assert [p is model.fc_tile[1].weight or p is model.fc_tile[1].bias
            for g in t.optimizer.param_groups for p in g["params"]] == [True, True]
    rng = np.random.default_rng(3)
    for _ in range(5):
        gw = rng.normal(size=w0.shape).astype(np.float32)
        gb = rng.normal(size=b0.shape).astype(np.float32)
        j = j.apply_gradients(
            {"encoder": {"w": enc_leaf}, "fc_tile": {"Dense_0": {
                "kernel": gw.T.copy(), "bias": gb}}}, {})
        model.fc_tile[1].weight.grad = torch.from_numpy(gw)
        model.fc_tile[1].bias.grad = torch.from_numpy(gb)
        t.apply_gradients()
    assert t.step == int(j.step) == 5
    jw, jb = _fc_tile(j.params)
    np.testing.assert_allclose(model.fc_tile[1].weight.detach().numpy(), jw,
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(model.fc_tile[1].bias.detach().numpy(), jb,
                               rtol=0, atol=1e-6)
    assert np.abs(jw - w0).max() > 1e-3  # the updates did move the head
    np.testing.assert_array_equal(np.asarray(j.params["encoder"]["w"]), enc_leaf)
    for k, v in model.encoder.state_dict().items():
        assert torch.equal(v, enc0[k]), k
    assert not any(p.requires_grad for p in model.encoder.parameters())


# ---------------------------------------------------------------------------
# the tile train step, the stack sweep, evaluate_tile
# ---------------------------------------------------------------------------


def test_tile_train_step_matches_jax(fx):
    """make_tile_train_step, 3 steps on the same batches (every flip code, a
    padded last row masked out by ``valid``), Adam at lr 1e-3: losses and
    fc_tile within 1e-5 (f32 both sides; the first loss agrees to 1e-7,
    the later ones carry the JAX side's Adam bias-correction error, see
    test_optimizer_matches_jax); encoder weights and BatchNorm statistics
    bit-unchanged."""
    v, imgs = fx["variables"], fx["images"]
    rng = np.random.default_rng(4)
    batches = []
    for _ in range(3):
        b = 10
        batches.append({
            "img_idx": rng.integers(0, len(imgs), b).astype(np.int32),
            "xs": rng.integers(0, HW - TILE + 1, b).astype(np.int32),
            "ys": rng.integers(0, HW - TILE + 1, b).astype(np.int32),
            "flip": np.arange(b, dtype=np.int32) % 4,
            "label": rng.integers(0, 2, b).astype(np.int32),
            "valid": np.arange(b) < b - 1,
        })
    sched = jsched.make_schedule(None, 1e-3, 1, 1)
    js = jstate.create_train_state(v["params"], v["batch_stats"], "tile", sched)
    jstep = jsteps.make_tile_train_step(fx["jmodel"], TILE)
    model = _port_model(F32_POLICY, v)
    enc0 = {k: x.clone() for k, x in model.encoder.state_dict().items()}
    ts = tstate.create_train_state(model, "tile", tsched.make_schedule(None, 1e-3, 1, 1),
                                   device="cpu")
    tstep = tsteps.make_tile_train_step(model, TILE, device="cpu")
    images_dev = torch.from_numpy(imgs)
    for batch in batches:
        js, jm = jstep(js, jax.numpy.asarray(imgs), batch)
        ts, tm = tstep(ts, images_dev, batch)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=0, atol=1e-5)
    jw, jb = _fc_tile(js.params)
    np.testing.assert_allclose(model.fc_tile[1].weight.detach().numpy(), jw,
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(model.fc_tile[1].bias.detach().numpy(), jb,
                               rtol=0, atol=1e-5)
    for k, x in model.encoder.state_dict().items():
        assert torch.equal(x, enc0[k]), k


@pytest.mark.parametrize("engine", ["flax", "q8dg"])
def test_stack_infer_step_equals_infer_step(fx, engine):
    """The stack sweep (device-resident images gathered by index) gives the
    probs of the per-batch sweep on the same images, flips included."""
    model = _port_model(F32_POLICY, fx["variables"])
    imgs = fx["images"]
    coords = tile_grid(HW, HW, TILE, INTERVAL)
    kw = dict(engine=engine, device="cpu",
              calib_images=imgs[:4] if engine == "q8dg" else None)
    stack = tsteps.make_stack_tile_infer_step(model, TILE, coords, **kw)
    assert stack.resolved_engine == engine
    idx = np.asarray([5, 0, 7, 5])
    flip = np.asarray([0, 1, 2, 3], np.int32)
    got = stack(torch.from_numpy(imgs), idx, flip)
    assert torch.equal(got, stack.infer_step(imgs[idx], flip))
    one = tsteps.make_tile_infer_step(model, TILE, coords, **kw)
    assert torch.equal(got, one(imgs[idx], flip))


def test_evaluate_tile_matches_jax():
    rng = np.random.default_rng(6)
    probs = rng.random((20, 36)).astype(np.float32)
    labels = rng.integers(0, 30, 20)
    for tpp, thr in ((1, 0.5), (2, 0.9)):
        assert teval.evaluate_tile(labels, probs, tpp, thr) == \
            jeval.evaluate_tile(labels, probs, tpp, thr)


# ---------------------------------------------------------------------------
# train_stage2 end to end, and resume
# ---------------------------------------------------------------------------


STAGE2 = dict(epochs=2, tile_batch_size=64, image_batch=8, tile_size=TILE,
              interval=INTERVAL, tiles_per_pos=2, topk_neg=4,
              pos_neg_ratio=0.5, threshold=0.5, lr=1e-3, seed=0,
              record_selection=True)


def _sources(fx):
    arrays = (fx["images"], fx["organs"], fx["counts"])
    train = LystoDataSource.from_arrays(*arrays, kfold=4, augment=True)
    val = LystoDataSource.from_arrays(*arrays, train=False, kfold=4)
    return train, val


def _jax_source(src):
    j = JSource.__new__(JSource)
    j.images, j.labels = src.images, src.labels
    j.base_idx, j.flip_code = src.base_idx, src.flip_code
    return j


def _csv(logdir, stream):
    (path,) = glob.glob(os.path.join(logdir, f"*-{stream}.csv"))
    with open(path) as f:
        return [[float(x) for x in row] for row in list(csv.reader(f))[1:]]


def _record_probs(monkeypatch, module, into):
    real = module.sample_topk

    def rec(source, probs, *args, **kwargs):
        into.append(np.array(probs))
        return real(source, probs, *args, **kwargs)

    monkeypatch.setattr(module, "sample_topk", rec)


def _port_stage2(fx, logdir, **kw):
    train, val = _sources(fx)
    model = _port_model(F32_POLICY, fx["variables"])
    res = train_stage2(model, train, val,
                       logger=RunLogger(logdir, tensorboard=False),
                       device="cpu", **dict(STAGE2, **kw))
    return model, res


@pytest.fixture(scope="module")
def port_q8dg(fx, tmp_path_factory):
    """The port's straight 2-epoch q8dg run: (model, result, log dir),
    shared by the JAX-parity and the resume tests."""
    logdir = str(tmp_path_factory.mktemp("port_q8dg"))
    return (*_port_stage2(fx, logdir, infer_engine="q8dg"), logdir)


@pytest.mark.parametrize("engine", ["flax", "q8dg"])
def test_train_stage2_matches_jax(fx, engine, tmp_path, monkeypatch, request):
    """Two epochs of the MIL cycle, port against JAX, the same engine named
    on both sides. Every epoch selects the same tiles, and the fixture's
    top-k margins in the JAX sweep exceed 1e-4 at every selection boundary,
    so no near-tie decides the comparison (the port's probs sit within
    1e-6 of the JAX ones at most tiles; q8dg's int8 sandwiches move a few
    by up to ~3e-3). Epoch losses and fc_tile within 1e-4 (f32 train steps
    on the same tiles); validation metrics equal."""
    monkeypatch.setattr(jqt, "TILE_ALIGN", 32)
    probs = []
    _record_probs(monkeypatch, jinfer, probs)
    train, val = _sources(fx)
    jlog = str(tmp_path / "jax")
    rj = jtrain_stage2(
        fx["jmodel"], jax.device_put(fx["variables"]), _jax_source(train),
        _jax_source(val), logger=JLogger(jlog, tensorboard=False),
        infer_engine=engine, **STAGE2)
    if engine == "q8dg":
        model, rt, tlog = request.getfixturevalue("port_q8dg")
    else:
        tlog = str(tmp_path / "port")
        model, rt = _port_stage2(fx, tlog, infer_engine=engine)

    k = np.where(train.labels > 0, train.labels * STAGE2["tiles_per_pos"],
                 STAGE2["topk_neg"])
    rows = np.arange(len(k))
    assert len(probs) == 2
    for pj in probs:
        order = np.argsort(-pj, axis=1, kind="stable")
        above, below = order[rows, k - 1], order[rows, k]
        margin = pj[rows, above] - pj[rows, below]
        assert margin.min() > 1e-4, margin.min()
    assert len(rj.selections) == len(rt.selections) == 2
    for sj, st in zip(rj.selections, rt.selections):
        for key in ("img_idx", "xs", "ys", "label"):
            np.testing.assert_array_equal(st[key], sj[key])
    loss_j = [r[1] for r in _csv(jlog, "tile-training")]
    loss_t = [e["loss"] for e in rt.epoch_stats]
    np.testing.assert_allclose(loss_t, loss_j, rtol=0, atol=1e-4)
    assert _csv(tlog, "tile-validation") == _csv(jlog, "tile-validation")
    assert rt.last_metrics == tuple(rj.last_metrics)
    jw, jb = _fc_tile(rj.state.params)
    np.testing.assert_allclose(model.fc_tile[1].weight.detach().numpy(), jw,
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(model.fc_tile[1].bias.detach().numpy(), jb,
                               rtol=0, atol=1e-4)


def test_train_stage2_resume_is_exact(fx, port_q8dg, tmp_path):
    """Two epochs straight (the shared q8dg run) equal one epoch, its
    checkpoint, and a resumed second epoch, bit for bit: the model state
    from the checkpoint, the Adam state from its optimizer entry, the
    selection and the batches from the epoch's seeds. The checkpoint holds
    the "tile" stage's partitions only (pt2: the encoder, the image heads
    and fc_tile)."""
    straight, r2, _ = port_q8dg
    out = str(tmp_path / "ckpt")
    _port_stage2(fx, str(tmp_path / "b"), infer_engine="q8dg", epochs=1,
                 output_dir=out)
    ck = tckpt.load_checkpoint(os.path.join(out, "pt2_1epochs.ckpt"))
    assert ck["mode"] == "tile" and ck["epoch"] == 1 and ck["encoder"] == "resnet50"
    assert {k.split(".")[0] for k in ck["state_dict"]} == \
        set(tckpt.STAGE_SAVE_PARTITIONS["tile"]) == \
        {"encoder", "fc_image_cls", "fc_image_reg", "fc_tile"}

    train, val = _sources(fx)
    resumed = _port_model(F32_POLICY, fx["variables"])
    with torch.no_grad():
        resumed.fc_tile[1].weight.zero_()  # the checkpoint must restore it
    resumed.load_state_dict(tckpt.merge_loaded(resumed.state_dict(),
                                               ck["state_dict"]))
    r1 = train_stage2(resumed, train, val, last_epoch=1,
                      resume_opt_state=ck["optimizer"],
                      logger=RunLogger(str(tmp_path / "c"), tensorboard=False),
                      device="cpu", **dict(STAGE2, infer_engine="q8dg"))
    for a, b in zip(r2.selections[1:], r1.selections):
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])
    assert r1.epoch_stats[0]["loss"] == r2.epoch_stats[1]["loss"]
    assert r1.last_metrics == r2.last_metrics
    assert r1.state.step == r2.state.step
    for k, x in straight.state_dict().items():
        assert torch.equal(x, resumed.state_dict()[k]), k
    sa, sb = (r.state.optimizer.state_dict()["state"] for r in (r2, r1))
    for i in sa:
        for name in sa[i]:
            assert torch.equal(torch.as_tensor(sa[i][name]),
                               torch.as_tensor(sb[i][name])), (i, name)
