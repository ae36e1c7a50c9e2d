"""The port's single-device long tail held against the JAX package on the
same seeded numpy inputs: the kappas and the other metrics, the threshold
mask, the factored tile gather, the V-channel refinement, the int8
quantization primitives, the stage option sets, the parameter summary, the
profiler hooks, and ``make_alternative_train_step`` (on the stage-1 tests'
reduced model through the bridge, f32, under injected dropout masks).
"""

from __future__ import annotations

import dataclasses
import glob
import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cellsegmentation_tpu.core import config as jconfig
from cellsegmentation_tpu.ops import hsv as jhsv
from cellsegmentation_tpu.ops import metrics as jmetrics
from cellsegmentation_tpu.ops import quant as jquant
from cellsegmentation_tpu.ops import tiles as jtiles
from cellsegmentation_tpu.ops import topk as jtopk
from cellsegmentation_tpu.train import schedules as jsched
from cellsegmentation_tpu.train import state as jstate
from cellsegmentation_tpu.train import steps as jsteps
from cellsegmentation_tpu.utils import summary as jsummary

from cellsegmentation_tpu_torch.core import config as tconfig
from cellsegmentation_tpu_torch.core.dtypes import F32_POLICY
from cellsegmentation_tpu_torch.ops import hsv as thsv
from cellsegmentation_tpu_torch.ops import metrics as tmetrics
from cellsegmentation_tpu_torch.ops import quant as tquant
from cellsegmentation_tpu_torch.ops import tiles as ttiles
from cellsegmentation_tpu_torch.ops import topk as ttopk
from cellsegmentation_tpu_torch.train import schedules as tsched
from cellsegmentation_tpu_torch.train import state as tstate
from cellsegmentation_tpu_torch.train import steps as tsteps
from cellsegmentation_tpu_torch.utils import profiling as tprof
from cellsegmentation_tpu_torch.utils import summary as tsummary
from cellsegmentation_tpu_torch.utils.jax_weights import jax_to_state_dict

from test_torch_port_slice import one_torch_thread  # noqa: F401 (autouse)
from test_torch_port_stage1 import (  # noqa: F401 (fx: a fixture)
    HEADS,
    HW,
    _intercept,
    _port_masks,
    _port_model,
    _rel,
    _state_dict,
    fx,
)
from test_torch_port_stage1_step import ADAM_SHARE, LOSS_RTOL, STAT_TOL

KAPPA_TOL = 1e-12


def _ratings(seed, n=200, k=7):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, k, n)
    # a correlated second rater: a +- noise, clipped to the range
    b = np.clip(a + rng.integers(-2, 3, n) * (rng.random(n) < 0.4), 0, k - 1)
    return a, b


@pytest.mark.parametrize("seed", range(4))
def test_kappas_match_jax(seed):
    """The linear and unweighted kappas (inferred and given rating ranges),
    the QWK, the Fisher-z means (plain and weighted) and the grouped mean,
    within 1e-12 of the JAX package's."""
    a, b = _ratings(seed)
    for lo, hi in ((None, None), (0, 9)):
        for name in ("linear_weighted_kappa", "unweighted_kappa",
                     "quadratic_weighted_kappa"):
            got = getattr(tmetrics, name)(a, b, lo, hi)
            want = getattr(jmetrics, name)(a, b, lo, hi)
            assert abs(got - want) <= KAPPA_TOL, (name, lo, got, want)
    rng = np.random.default_rng(seed + 10)
    kappas = rng.uniform(-1, 1, 6)
    kappas[0] = 1.0  # clipped to 0.999
    weights = rng.uniform(0.5, 2, 6)
    for w in (None, weights):
        assert abs(tmetrics.mean_quadratic_weighted_kappa(kappas, w)
                   - jmetrics.mean_quadratic_weighted_kappa(kappas, w)) <= KAPPA_TOL
    groups = rng.integers(0, 4, len(a))
    gw = {g: float(g + 1) for g in range(4)}
    for w in (None, gw):
        got = tmetrics.weighted_mean_quadratic_weighted_kappa(a, b, groups, w)
        want = jmetrics.weighted_mean_quadratic_weighted_kappa(a, b, groups, w)
        assert abs(got - want) <= KAPPA_TOL


def test_qwk_device_matches_jax():
    """qwk_device on tensors (f32, as the JAX package's) within 1e-6 of the
    JAX package's and of the host QWK over the same fixed range, on seeded
    ratings that miss some of the range."""
    for seed in range(3):
        a, b = _ratings(seed, n=500, k=6)
        got = tmetrics.qwk_device(torch.from_numpy(a), torch.from_numpy(b), 7)
        assert got.dtype == torch.float32 and got.shape == ()
        want = float(jmetrics.qwk_device(jnp.asarray(a), jnp.asarray(b), 7))
        assert abs(float(got) - want) <= 1e-6
        host = tmetrics.quadratic_weighted_kappa(a, b, 0, 6)
        assert abs(float(got) - host) <= 1e-6
        oh = tmetrics._one_hot(torch.from_numpy(a), 7)
        np.testing.assert_array_equal(oh.numpy(), np.asarray(jmetrics._one_hot(jnp.asarray(a), 7)))


def test_calc_map_and_euclid_dist_match_jax():
    """calc_map (the reference's argument order) against the JAX package's
    sklearn call, ties in the scores and a set without positives included;
    euclid_dist on 2-D and 3-D points."""
    rng = np.random.default_rng(4)
    cases = [(rng.integers(0, 2, 50), rng.random(50)),
             (rng.integers(0, 2, 40), rng.integers(0, 5, 40) / 4.0),
             (np.r_[1, np.zeros(9, int)], np.linspace(0, 1, 10)),
             (np.zeros(8, int), rng.random(8))]
    for pred, real in cases:
        with warnings.catch_warnings():  # sklearn warns on a set without positives
            warnings.simplefilter("ignore")
            want = jmetrics.calc_map(pred, real)
        assert abs(tmetrics.calc_map(pred, real) - want) <= KAPPA_TOL
    for p1, p2 in (((0, 0), (3, 4)), ((1.5, -2.0, 7.0), (0.5, 3.0, -1.0))):
        assert tmetrics.euclid_dist(p1, p2) == jmetrics.euclid_dist(p1, p2)


def test_topk_threshold_and_tiles_match_jax():
    """topk_threshold_mask on seeded probs (values on the threshold
    included), num_tiles on the LYSTO grids, extract_tiles_factored's
    uint8 tiles equal to the JAX package's and to the per-tile gather."""
    rng = np.random.default_rng(5)
    probs = rng.random((3, 225)).astype(np.float32)
    probs[0, :5] = 0.95
    got = ttopk.topk_threshold_mask(torch.from_numpy(probs), 0.95).numpy()
    np.testing.assert_array_equal(got, np.asarray(jtopk.topk_threshold_mask(
        jnp.asarray(probs), 0.95)))
    for grid in ((299, 299, 32, 20), (299, 299, 16, 5), (299, 299, 32, 5), (64, 80, 16, 8)):
        assert ttiles.num_tiles(*grid) == jtiles.num_tiles(*grid)
    imgs = rng.integers(0, 256, (2, 64, 80, 3)).astype(np.uint8)
    coords = ttiles.tile_grid(64, 80, 16, 8)
    xs, ys = np.unique(coords[:, 0]), np.unique(coords[:, 1])
    got = ttiles.extract_tiles_factored(torch.from_numpy(imgs), xs, ys, 16).numpy()
    want = np.asarray(jtiles.extract_tiles_factored(jnp.asarray(imgs), xs, ys, 16))
    np.testing.assert_array_equal(got, want)
    per_tile = ttiles.extract_tiles(torch.from_numpy(imgs), coords[::-1].copy(), 16)
    np.testing.assert_array_equal(per_tile.numpy()[:, ::-1], got)


def test_hsv_matches_jax():
    """The V channel exact and the refined masks equal, with pixels at the
    threshold and either side of it."""
    rng = np.random.default_rng(6)
    imgs = rng.integers(120, 220, (2, 32, 48, 3)).astype(np.uint8)
    imgs[0, 0, :3] = [[170, 0, 0], [0, 171, 0], [169, 169, 169]]
    masks = rng.random((2, 32, 48)) < 0.5
    v = thsv.rgb_value_channel(torch.from_numpy(imgs))
    assert v.dtype == torch.uint8
    np.testing.assert_array_equal(v.numpy(), np.asarray(jhsv.rgb_value_channel(
        jnp.asarray(imgs))))
    for thr in (170, 150):
        for m in (masks, masks.astype(np.int32)):
            got = thsv.hsv_refine_mask(torch.from_numpy(imgs), torch.from_numpy(m), thr)
            assert got.dtype == torch.bool
            np.testing.assert_array_equal(got.numpy(), np.asarray(jhsv.hsv_refine_mask(
                jnp.asarray(imgs), jnp.asarray(m), thr)))


def test_quant_matches_jax():
    """quantize_weights (per channel on either axis), the activation scale,
    quantize_activations: int8 and scales bit-equal; int8_gemm and
    quantized_dense_forward equal in f32, with and without bias."""
    rng = np.random.default_rng(7)
    w = rng.normal(size=(64, 48)).astype(np.float32)
    w[:, 3] = 0.0  # an all-zero channel takes scale 1
    for axis in (-1, 0):
        tq_, ts_ = tquant.quantize_weights(w, axis=axis)
        jq_, js_ = jquant.quantize_weights(w, axis=axis)
        assert tq_.dtype == torch.int8 and ts_.dtype == torch.float32
        np.testing.assert_array_equal(tq_.numpy(), np.asarray(jq_))
        np.testing.assert_array_equal(ts_.numpy(), np.asarray(js_))
    x = rng.normal(size=(32, 64)).astype(np.float32) * 3
    s = tquant.calibrate_activation_scale(x)
    assert s == jquant.calibrate_activation_scale(x)
    assert tquant.calibrate_activation_scale(np.zeros(4)) == 1.0
    xq = tquant.quantize_activations(torch.from_numpy(x), s)
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jquant.quantize_activations(
        jnp.asarray(x), s)))
    wq, ws = tquant.quantize_weights(w)
    bias = rng.normal(size=(48,)).astype(np.float32)
    for b in (None, bias):
        got = tquant.int8_gemm(xq, wq, s, ws, None if b is None else torch.from_numpy(b))
        want = jquant.int8_gemm(jnp.asarray(xq.numpy()), jnp.asarray(wq.numpy()), s,
                                jnp.asarray(ws.numpy()), None if b is None else jnp.asarray(b))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = tquant.quantized_dense_forward(torch.from_numpy(x), w, torch.from_numpy(bias), s)
    want = jquant.quantized_dense_forward(jnp.asarray(x), w, jnp.asarray(bias), s)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_stage_configs_match_jax():
    """The stage option sets: the same fields, defaults and inheritance."""
    for name in ("StageConfig", "TileStageConfig", "SegStageConfig"):
        t, j = getattr(tconfig, name), getattr(jconfig, name)
        assert dataclasses.asdict(t()) == dataclasses.asdict(j())
        assert [f.name for f in dataclasses.fields(t)] == [f.name for f in dataclasses.fields(j)]
    assert issubclass(tconfig.TileStageConfig, tconfig.StageConfig)
    assert tconfig.SegStageConfig(epochs=3).batch_size == 32


def test_summary_matches_jax():
    """Parameter counts per partition and in total, the JAX package's
    (from its abstract init) for the same model name."""
    got = tsummary.summary("resnet18")
    assert got == jsummary.summary("resnet18")
    assert got["TOTAL"] == sum(v for k, v in got.items() if k != "TOTAL")
    assert tsummary.count_params(torch.nn.Linear(3, 2)) == 8


def test_profiling_trace_and_gate(tmp_path, monkeypatch):
    """trace(force=True) writes a Chrome trace holding the annotated span;
    without force it follows CST_PROFILE."""
    monkeypatch.delenv("CST_PROFILE", raising=False)
    assert not tprof.profiling_enabled()
    with tprof.trace(str(tmp_path / "off")):
        torch.ones(4).sum()
    assert not (tmp_path / "off").exists()
    with tprof.trace(str(tmp_path / "on"), force=True):
        with tprof.annotate("longtail-span"):
            (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    files = glob.glob(str(tmp_path / "on" / "*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "longtail-span" for e in events)
    monkeypatch.setenv("CST_PROFILE", "0")
    assert not tprof.profiling_enabled()
    monkeypatch.setenv("CST_PROFILE", "1")
    assert tprof.profiling_enabled()


def test_train_stage1_writes_a_trace_under_cst_profile(fx, tmp_path, monkeypatch):
    """CST_PROFILE=1: train_stage1 traces its first epoch into
    ``<output_dir>/profile``, where the JAX package's hook writes."""
    from cellsegmentation_tpu_torch.data import LystoDataSource
    from cellsegmentation_tpu_torch.train.trainers import train_stage1
    from cellsegmentation_tpu_torch.utils.logging import RunLogger

    monkeypatch.setenv("CST_PROFILE", "1")
    b = fx["batch"]
    src = LystoDataSource.from_arrays(b["images"][:4], ["colon_0"] * 4,
                                      b["reg"][:4].astype(int), kfold=None)
    model = _port_model(F32_POLICY, fx["variables"])
    train_stage1(model, src, None, epochs=1, batch_size=4, device="cpu",
                 output_dir=str(tmp_path), logger=RunLogger(str(tmp_path), tensorboard=False))
    assert len(glob.glob(str(tmp_path / "profile" / "*.json"))) == 1


# ---------------------------------------------------------------------------
# make_alternative_train_step
# ---------------------------------------------------------------------------

LR = 1e-3
TILE = 32


def _alt_batch(fx):
    """The stage-1 fixture's image batch and 8 tiles of its images, every
    flip code, both labels, the last one padding."""
    rng = np.random.default_rng(9)
    b = dict(fx["batch"])
    n = 8
    b.update(img_idx=rng.integers(0, 6, n).astype(np.int32),
             xs=rng.integers(0, HW - TILE + 1, n).astype(np.int32),
             ys=rng.integers(0, HW - TILE + 1, n).astype(np.int32),
             tflip=(np.arange(n) % 4).astype(np.int32),
             tlabel=(np.arange(n) % 2).astype(np.int32),
             tvalid=np.arange(n) < n - 1)
    return b


def _port_alt(fx, batch, model=None):
    model = model or _port_model(F32_POLICY, fx["variables"])
    sched = tsched.make_schedule(None, LR, 2, 4)
    ts = tstate.create_train_state(model, "tile", sched, device="cpu")
    ims = tstate.create_train_state(model, "image", sched, device="cpu")
    step = tsteps.make_alternative_train_step(model, TILE, device="cpu")
    ts, ims, m = step(ts, ims, torch.from_numpy(batch["images"]), batch,
                      dropout_masks=_port_masks(fx["masks"]))
    return model, ts, ims, {k: float(x) for k, x in m.items()}


def test_alternative_step_matches_jax(fx):
    """One alternation (Adam on both partitions) against the JAX package's
    make_alternative_train_step: the metrics within LOSS_RTOL, the running
    statistics within STAT_TOL, and every partition's Adam update under the
    image step test's ADAM_SHARE (every entry within 2 * lr); fc_tile
    trained by the tile half, the seg decoder untouched."""
    v, batch = fx["variables"], _alt_batch(fx)
    sched = jsched.make_schedule(None, LR, 2, 4)
    jts = jstate.create_train_state(v["params"], v["batch_stats"], "tile", sched)
    jis = jstate.create_train_state(v["params"], v["batch_stats"], "image", sched)
    jstep = jsteps.make_alternative_train_step(fx["jmodel"], TILE)
    with _intercept(fx["masks"]):
        jts, jis, jm = jstep(jts, jis, jnp.asarray(batch["images"]), batch,
                             jax.random.PRNGKey(0))
    jm = {k: float(x) for k, x in jm.items()}
    model, ts, ims, tm = _port_alt(fx, batch)
    assert tm.keys() == jm.keys() == {"loss", "loss_cls", "loss_reg"}
    for k in jm:
        np.testing.assert_allclose(tm[k], jm[k], rtol=LOSS_RTOL, err_msg=k)
    assert ts.step == int(jts.step) == 1 and ims.step == int(jis.step) == 1
    want = {k: x.numpy() for k, x in
            jax_to_state_dict(jax.tree_util.tree_map(np.asarray, jts.variables))[0].items()}
    before = {k: x.numpy() for k, x in jax_to_state_dict(v)[0].items()}
    got = _state_dict(model)
    for k in (k for k in want if "running_" in k):
        assert _rel(got[k], want[k]) <= STAT_TOL, (k, _rel(got[k], want[k]))
    for part in ("encoder", *HEADS, "fc_tile", "seg_decoder"):
        keys = [k for k in want if k.startswith(part) and "running_" not in k]
        ut = np.concatenate([(got[k] - before[k]).ravel() for k in keys])
        uj = np.concatenate([(want[k] - before[k]).ravel() for k in keys])
        if part == "seg_decoder":
            assert not ut.any() and not uj.any()
            continue
        assert float((np.abs(ut - uj) > LR / 100).mean()) <= ADAM_SHARE, part
        assert np.abs(ut - uj).max() <= 2 * LR * (1 + 1e-3), part
        assert np.abs(ut).max() > 0, part


def test_alternative_step_image_half_reads_the_tile_update(fx):
    """The alternation equals the tile step then the image step run one
    after the other on one model, bit for bit: the image half starts from
    the parameters the tile half wrote, and fc_tile leaves the image half
    as the tile half wrote it."""
    batch = _alt_batch(fx)
    model, _, _, m = _port_alt(fx, batch)
    ref = _port_model(F32_POLICY, fx["variables"])
    before = _state_dict(ref)
    sched = tsched.make_schedule(None, LR, 2, 4)
    ts = tstate.create_train_state(ref, "tile", sched, device="cpu")
    tile = {"img_idx": batch["img_idx"], "xs": batch["xs"], "ys": batch["ys"],
            "flip": batch["tflip"], "label": batch["tlabel"], "valid": batch["tvalid"]}
    tsteps.make_tile_train_step(ref, TILE, device="cpu")(
        ts, torch.from_numpy(batch["images"]), tile)
    after_tile = _state_dict(ref)
    ims = tstate.create_train_state(ref, "image", sched, device="cpu")
    _, mi = tsteps.make_image_train_step(ref, device="cpu")(
        ims, batch, dropout_masks=_port_masks(fx["masks"]))
    got, want = _state_dict(model), _state_dict(ref)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert m["loss"] == float(mi["loss"])
    fc = [k for k in want if k.startswith("fc_tile")]
    assert all(np.array_equal(got[k], after_tile[k]) for k in fc)
    assert any(not np.array_equal(got[k], before[k]) for k in fc)
