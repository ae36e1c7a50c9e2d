"""The port's ResNeXt held against the JAX package on the same weights and
numpy-seeded inputs: the registry, the weight bridge's grouped 3x3s, the
three forward modes, folding and calibration of grouped Bottlenecks, the
grouped GEMM trunk (the block-diagonal expansion through the ungrouped
kernels) against both of the JAX package's grouped forms (``blockdiag``, and
``gdot``: one batched int32 product per group, bit-identical to it), the
engines on a grouped trunk and their resolution.

The models are full-width ResNeXt MILNets (groups 32, base widths 4 and 8:
the 32x4d and 32x8d widths) at stage sizes (1, 1, 1, 1), with perturbed
BatchNorm; the JAX variables are the port model's, converted with the JAX
package's own torch converter. The JAX side runs its Pallas kernels in
interpret mode with ``TILE_ALIGN`` cut to 32, as its own tests do, and
picks its grouped forms through its module switches ``GROUPED_IMPL`` and
``_GROUPED_GEMM`` (monkeypatched; no JAX file changes). The full-depth call
shapes of both ResNeXts are checked against the Hopper core's limits.
"""

from __future__ import annotations

import collections
import dataclasses

import jax
import numpy as np
import pytest
import torch

from cellsegmentation_tpu import models as jmodels
from cellsegmentation_tpu.core.dtypes import DEFAULT_POLICY as J_BF16
from cellsegmentation_tpu.core.dtypes import F32_POLICY as J_F32
from cellsegmentation_tpu.data.batches import normalize_images as jnormalize
from cellsegmentation_tpu.models.milnet import MILNet as JMILNet
from cellsegmentation_tpu.models.resnet import Bottleneck as JBottleneck
from cellsegmentation_tpu.models.resnet import ResNetEncoder as JEncoder
from cellsegmentation_tpu.ops import infer_engine as jie
from cellsegmentation_tpu.ops import q8_trunk as jqt
from cellsegmentation_tpu.ops.tiles import tile_grid
from cellsegmentation_tpu.train import steps as jsteps
from cellsegmentation_tpu.utils.torch_convert import convert_milnet

from cellsegmentation_tpu_torch import models
from cellsegmentation_tpu_torch.core.dtypes import F32_POLICY
from cellsegmentation_tpu_torch.data import normalize_images
from cellsegmentation_tpu_torch.kernels import q8_gemm as tq
from cellsegmentation_tpu_torch.models import (
    MODEL_NAMES,
    Bottleneck,
    MILNet,
    ResNetEncoder,
    build_model,
)
from cellsegmentation_tpu_torch.models.milnet import init_milnet
from cellsegmentation_tpu_torch.ops import infer_engine as tie
from cellsegmentation_tpu_torch.ops import q8_trunk as tqt
from cellsegmentation_tpu_torch.train import steps as tsteps
from cellsegmentation_tpu_torch.utils.jax_weights import load_jax_variables

from test_torch_port_serve import (
    _jax_q8g_counts,
    _logodds,
    _ones_scales,
    _port_scales_for_jax,
    _q8g_calls,
)
from test_torch_port_slice import one_torch_thread  # noqa: F401 (autouse)
from test_torch_port_slice import _structured_images
from test_torch_port_sm90 import M_STEP

SIZES = (1, 1, 1, 1)
GROUPS = 32
WIDTHS = (4, 8)  # base widths: resnext50_32x4d's and resnext101_32x8d's
# (hw, tile, interval): on the /4 stem lattice, and test_tile's 32/5 off it
GRIDS = {"dense": (80, 32, 20), "32/5": (40, 32, 5)}


def _port_sd(tm):
    """The port model's state dict as the JAX package's torch converter
    reads it: encoder keys unprefixed, the decoder's under the reference's
    top-level names, with the conv biases the reference's decoder has
    (zero: the port folds a loaded one into the running mean)."""
    sd = {}
    for k, v in tm.state_dict().items():
        sd[k.removeprefix("encoder.").removeprefix("seg_decoder.")] = v.numpy()
    for k in range(1, 9):
        sd[f"upconv{k}.0.bias"] = np.zeros(sd[f"upconv{k}.0.weight"].shape[0], np.float32)
    return sd


def _jax_model(bw, policy=J_BF16, sizes=SIZES):
    return JMILNet(encoder=JEncoder(block_cls=JBottleneck, stage_sizes=sizes,
                                    policy=policy, groups=GROUPS, base_width=bw),
                   decoder_expansion=4, policy=policy)


def _models(bw, seed=0):
    """(JAX model, JAX variables, port model): the port's seeded weights
    with perturbed BatchNorm, converted for the JAX side."""
    tm = init_milnet(MILNet(ResNetEncoder(Bottleneck, SIZES, groups=GROUPS,
                                          base_width=bw)), seed)
    rng = np.random.default_rng(11 + bw)
    with torch.no_grad():
        for m in tm.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                c = m.num_features
                m.weight.copy_(torch.from_numpy(1 + 0.1 * rng.standard_normal(c)))
                m.bias.copy_(torch.from_numpy(0.1 * rng.standard_normal(c)))
                m.running_mean.copy_(torch.from_numpy(0.1 * rng.standard_normal(c)))
                m.running_var.copy_(torch.from_numpy(1 + 0.2 * rng.random(c)))
    params, stats = convert_milnet(_port_sd(tm), SIZES, True)
    return _jax_model(bw), {"params": params, "batch_stats": stats}, tm.eval()


@pytest.fixture(scope="module")
def fx():
    mp = pytest.MonkeyPatch()
    mp.setattr(jqt, "TILE_ALIGN", 32)
    yield {bw: _models(bw) for bw in WIDTHS}
    mp.undo()


def test_registry_builds_both_resnexts():
    """resnext50_32x4d and resnext101_32x8d build with the JAX registry's
    widths: the grouped 3x3 of layer s is [c_mid, c_mid/32, 3, 3]; both
    EfficientNets build too, and MODEL_NAMES is the JAX package's.
    (ResNeXt-101's modules are made on the meta device: its seeded weights
    cost seconds and are not read here.)"""
    assert {"resnext50_32x4d", "resnext101_32x8d"} <= set(MODEL_NAMES)
    for name, bw, c_mid in (("resnext50_32x4d", 4, (128, 256, 512, 1024)),
                            ("resnext101_32x8d", 8, (256, 512, 1024, 2048))):
        if bw == 4:
            enc = build_model(name, device="cpu").encoder
        else:
            with torch.device("meta"):
                enc = models._BUILDERS[name](F32_POLICY).encoder
        assert (enc.groups, enc.stage_sizes[2]) == (GROUPS, 6 if bw == 4 else 23)
        for s, c in enumerate(c_mid):
            w = getattr(enc, f"layer{s + 1}")[0].conv2.weight
            assert tuple(w.shape) == (c, c // GROUPS, 3, 3)
        assert enc.out_channels == 2048
    for name in ("efficientnet_b0", "efficientnet_b2"):
        assert isinstance(build_model(name, device="cpu").encoder,
                          models.EfficientNetEncoder)
    assert MODEL_NAMES == jmodels.MODEL_NAMES


# f32 policy on both sides: rtol 1e-3 of each output's largest value (a
# grouped conv sums C/32 terms a tap, so the two frameworks' f32 orders
# part by a few ulp; the segment logits ride the decoder's eight units)
@pytest.mark.parametrize("mode", ["tile", "image", "segment"])
def test_bridged_forward_matches_jax(fx, mode):
    """The JAX variables bridged into a fresh port model (grouped HWIO
    [3, 3, C/g, C'] kernels become [C', C/g, 3, 3] weights): the three
    forward modes in f32 against the JAX model on the same inputs."""
    _, v, _ = fx[4]
    model = MILNet(ResNetEncoder(Bottleneck, SIZES, policy=F32_POLICY, groups=GROUPS,
                                 base_width=4), policy=F32_POLICY)
    assert load_jax_variables(model, v) == []
    model.eval()
    hw = 32 if mode == "tile" else 64
    rng = np.random.default_rng(5)
    imgs = rng.integers(0, 256, (3, hw, hw, 3)).astype(np.uint8)
    flip = np.asarray([0, 1, 3], np.int32)
    jm = _jax_model(4, J_F32)
    want = jax.jit(lambda v, x: jm.apply(v, x, mode=mode))(v, jnormalize(imgs, flip))
    with torch.no_grad():
        got = model(normalize_images(torch.from_numpy(imgs), torch.from_numpy(flip)),
                    mode=mode)
    for g, w in zip(*(o if isinstance(o, tuple) else (o,) for o in (got, want))):
        g, w = g.float().numpy(), np.asarray(w, np.float32)
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= 1e-3 * np.abs(w).max(), mode


@pytest.mark.parametrize("bw", WIDTHS)
def test_fold_like_jax(fx, bw):
    """fold_tile_trunk on a grouped Bottleneck encoder: groups, kind and
    every folded array equal to the JAX package's."""
    jm, v, tm = fx[bw]
    tf, jf = tie.fold_tile_trunk(tm), jie.fold_tile_trunk(jm, v)
    assert (tf.groups, tf.kind, tf.strides) == (jf.groups, jf.kind, jf.strides) == (
        GROUPS, "bottleneck", [1, 2, 2, 2])
    np.testing.assert_array_equal(tf.stem_w, np.asarray(jf.stem_w, np.float32))
    for ts, js in zip(tf.stages, jf.stages):
        for tb, jb in zip(ts, js):
            assert len(tb) == len(jb) == 8
            for t, j in zip(tb, jb):
                np.testing.assert_array_equal(t, np.asarray(j, np.float32))
    assert tf.stages[1][0][2].shape == (3, 3, 8 * bw // 4, 64 * bw)


def test_expand_grouped_byte_equal(fx):
    """The block-diagonal expansion of a random grouped kernel and of a
    folded layer-2 one: the JAX package's bytes."""
    k2 = np.random.default_rng(2).normal(size=(3, 3, 8, 256)).astype(np.float32)
    assert tqt._expand_grouped(k2, GROUPS).tobytes() == jqt._expand_grouped(
        k2, GROUPS).tobytes()
    w2 = tie.fold_tile_trunk(fx[4][2]).stages[1][0][2]
    big = tqt._expand_grouped(w2, GROUPS)
    assert big.shape == (3, 3, 256, 256)
    assert big.tobytes() == jqt._expand_grouped(w2, GROUPS).tobytes()


def _jax_trunk(fx, bw, impl, monkeypatch, scales=None, w2_impl="auto"):
    """q8g's GEMM-land (layers 2-4 from the 8x8 map): the port's in the 3x3
    form ``w2_impl``, the JAX package's in its grouped form ``impl`` and
    the same ``W2_IMPL``."""
    jm, v, tm = fx[bw]
    monkeypatch.setattr(jqt, "GROUPED_IMPL", impl)
    monkeypatch.setattr(jqt, "W2_IMPL", w2_impl)
    tf, jf = tie.fold_tile_trunk(tm), jie.fold_tile_trunk(jm, v)
    ts = scales or tie.calibrate_trunk(tf, _calib_tiles())
    js = jie.TrunkScales(block_out=ts.block_out, h1=ts.h1, h2=ts.h2, proj=ts.proj)
    tp, tmetas = tqt.build_q8_backend(tf, ts, 8, 8, first_stage=1, w2_impl=w2_impl)
    jp, jmetas = jqt.build_q8_backend(jf, js, 8, 8, first_stage=1)
    return (tp, tmetas), (jp, jmetas)


def _calib_tiles():
    return tie.calib_tiles_from_images(_structured_images(80, 2),
                                       tile_grid(80, 80, 32, 20), 32)


@pytest.mark.parametrize("w2_impl", tqt.W2_IMPLS)
@pytest.mark.parametrize("bw", WIDTHS)
def test_packed_params_like_jax(fx, bw, w2_impl, monkeypatch):
    """q8g's GEMM-land (layers 2-4 from the 8x8 map) in both 3x3 forms the
    block-diagonal expansion runs in: every packed array and every block's
    meta equal to the JAX package's blockdiag trunk; the expanded 3x3
    weights are dense over all C input channels."""
    (tp, tmetas), (jp, jmetas) = _jax_trunk(fx, bw, "blockdiag", monkeypatch,
                                            _ones_scales(tie.fold_tile_trunk(fx[bw][2]),
                                                         True, tie), w2_impl)
    assert [dataclasses.asdict(m) for m in tmetas] == [dataclasses.asdict(m)
                                                        for m in jmetas]
    for t, j in zip(tp, jp):
        assert sorted(t) == sorted(j)
        for k in t:
            assert t[k].dtype == np.asarray(j[k]).dtype, k
            np.testing.assert_array_equal(t[k], np.asarray(j[k]), err_msg=k)
    assert all(m.groups == 1 for m in tmetas)
    if w2_impl == "rowtap":
        assert [m.w2_impl for m in tmetas] == ["rowtap"] * 3
    else:
        assert [m.w2_impl for m in tmetas] == ["tap", "tap", "wholetile"]
        c_mid = 64 * bw  # layer 2's, tap-major [9 * c_mid, c_mid]
        assert tp[0]["w2"].shape == (9 * c_mid, c_mid)


def _bf16_ulp(want):
    w = np.abs(np.asarray(want, np.float32))
    return np.exp2(np.floor(np.log2(np.maximum(w, 1e-30))) - 7)


def test_gemm_land_features_both_forms(fx, monkeypatch):
    """The same int8 entry through q8g's GEMM-land: the port's grouped
    trunk in both 3x3 forms (auto, rowtap) and the JAX package's in both
    grouped forms (blockdiag, gdot). The int8 outputs of layers 2-3
    bit-equal across all four; the final bf16 features bit-equal within
    each side and within one bf16 ulp across the two."""
    xq = np.random.default_rng(7).integers(-127, 128, (32, 64 * 256), dtype=np.int8)
    scales = tie.calibrate_trunk(tie.fold_tile_trunk(fx[4][2]), _calib_tiles())
    outs = {}
    # (the JAX package's gdot form takes no W2_IMPL)
    for impl, w2_impl in (("blockdiag", "auto"), ("gdot", "rowtap")):
        (tp, tmetas), (jp, jmetas) = _jax_trunk(fx, 4, impl, monkeypatch, scales, w2_impl)
        qp = tqt.upload_q8_params(tp, "cpu")
        for n in (2, 3):  # through layer 3 (int8 out), and the whole trunk
            outs[("port", w2_impl, n)] = tqt.q8_backend_forward(
                qp[:n], tmetas[:n], torch.from_numpy(xq)).float().numpy()
            outs[("jax", impl, n)] = np.asarray(jqt.q8_backend_forward(
                jp[:n], jmetas[:n], jax.numpy.asarray(xq), interpret=True), np.float32)
    ref = outs[("port", "auto", 2)]
    assert ref.shape == (32, 4 * 1024) and np.abs(ref).max() > 0
    for side, forms in (("port", ("auto", "rowtap")), ("jax", ("blockdiag", "gdot"))):
        for form in forms:
            np.testing.assert_array_equal(outs[(side, form, 2)], ref)
        np.testing.assert_array_equal(outs[(side, forms[1], 3)], outs[(side, forms[0], 3)])
    t = outs[("port", "auto", 3)]
    assert t.shape == (32, 2048)
    for impl in ("blockdiag", "gdot"):
        j = outs[("jax", impl, 3)]
        assert (np.abs(t - j) <= _bf16_ulp(j)).all()


# (engine, kwargs, the JAX switches, resolved engine); on the dense grid.
# The port's grouped GEMM-land is held against both of the JAX package's
# grouped forms. The limits are test_torch_port_serve.py's: bf16 conv-land
# rounds in other places in XLA and oneDNN, flipping single int8 LSBs.
PROB_CASES = [
    ("flax", {}, {}, "flax"),
    ("q8", {}, {}, "q8"),
    ("q8g", {}, {}, "q8g"),
    ("q8g", {}, {"GROUPED_IMPL": "gdot"}, "q8g"),
    ("q8dg", {}, {}, "q8dg"),
    ("q8dg", {"grouped_gemm": True}, {"_GROUPED_GEMM": True}, "q8dg"),
    ("q8dg", {"grouped_gemm": True}, {"_GROUPED_GEMM": True, "GROUPED_IMPL": "gdot"},
     "q8dg"),
]


@pytest.fixture(scope="module")
def port_probs(fx):
    """Every PROB_CASES engine's probs through the port, one image."""
    _, _, tm = fx[4]
    hw, ts, iv = GRIDS["dense"]
    coords = tile_grid(hw, hw, ts, iv)
    imgs = _structured_images(hw, 1)
    out = {}
    for engine, kw, _, _ in PROB_CASES:
        if (engine, tuple(kw.items())) in out:
            continue
        fn = tsteps.make_tile_infer_step(tm, ts, coords, engine=engine,
                                         calib_images=imgs, device="cpu", **kw)
        out[engine, tuple(kw.items())] = (fn, fn(imgs, np.asarray([3], np.int32)).numpy())
    return out


@pytest.mark.parametrize("engine,kw,switches,resolved", PROB_CASES,
                         ids=[f"{c[0]}-" + "-".join(f"{v}" for v in c[2].values())
                              for c in PROB_CASES])
def test_engine_probs_like_jax(fx, port_probs, engine, kw, switches, resolved,
                               monkeypatch):
    """Each engine on the grouped trunk against the JAX package on one
    calibration, the GEMM-land engines against both JAX grouped forms."""
    jm, v, tm = fx[4]
    hw, ts, iv = GRIDS["dense"]
    coords = tile_grid(hw, hw, ts, iv)
    imgs = _structured_images(hw, 1)
    for name, value in switches.items():
        monkeypatch.setattr(jqt if name == "GROUPED_IMPL" else jie, name, value)
    monkeypatch.setattr(jie, "calibrate_trunk", _port_scales_for_jax(tm, imgs, coords, ts))
    jfn = jsteps.make_tile_infer_step(jm, ts, coords, variables=v, engine=engine,
                                      calib_images=imgs)
    tfn, p_t = port_probs[engine, tuple(kw.items())]
    assert jfn.resolved_engine == tfn.resolved_engine == resolved
    p_j = np.asarray(jfn(v, imgs, np.asarray([3], np.int32)))
    assert p_t.shape == p_j.shape == (1, len(coords))
    d = np.abs(p_t - p_j)
    assert d.max() < 5e-3 and d.mean() < 1e-3, (d.max(), d.mean())
    assert np.abs(_logodds(p_t) - _logodds(p_j)).mean() < 2e-3
    if engine == "q8dg":
        assert tfn.engine.backend == ("gemm" if kw else "conv")


# the JAX package's resolution (train/steps.py:204-296) on a grouped
# trunk, with calibration: engine -> (dense grid, off it)
WANT = {"q8dg": ("q8dg", "q8g"), "q8d": ("q8d", "q8"), "q8g": ("q8g", "q8g"),
        "q8": ("q8", "q8"), "flax": ("flax", "flax")}


@pytest.mark.parametrize("grid,grouped_gemm",
                         [("dense", False), ("dense", True), ("32/5", False)])
def test_engine_resolution_like_jax(fx, grid, grouped_gemm, monkeypatch):
    """Every engine with and without calibration images, with and without
    the grouped dense GEMM, through both step factories: the JAX package's
    resolved engine, and which backend the dense engine built. "auto"
    differs by design on an eligible grid: the port promotes to q8dg on
    the CPU, which on ResNeXt runs the dense conv chain unless the grouped
    GEMM is asked for. (Off the /4 lattice the grouped GEMM changes
    nothing: no dense engine is built there.)"""
    monkeypatch.setattr(jie, "calibrate_trunk", lambda t, c, deep=False: _ones_scales(t, deep))
    monkeypatch.setattr(tie, "calibrate_trunk", lambda t, c: _ones_scales(t, True, tie))
    monkeypatch.setattr(jie, "_GROUPED_GEMM", grouped_gemm)
    jm, v, tm = fx[4]
    hw, ts, iv = GRIDS[grid]
    coords = tile_grid(hw, hw, ts, iv)
    imgs = _structured_images(hw, 1)
    for engine in ("q8dg", "q8d", "q8g", "q8", "flax", "auto"):
        for calib in (imgs, None):
            for jmake, tmake in ((jsteps.make_tile_infer_step, tsteps.make_tile_infer_step),
                                 (jsteps.make_stack_tile_infer_step,
                                  tsteps.make_stack_tile_infer_step)):
                jfn = jmake(jm, ts, coords, variables=v, engine=engine, calib_images=calib)
                tfn = tmake(tm, ts, coords, engine=engine, calib_images=calib,
                            device="cpu", grouped_gemm=grouped_gemm)
                case = (engine, calib is not None, jmake.__name__)
                got = tfn.resolved_engine
                if engine == "auto" and grid == "dense" and calib is not None:
                    assert (jfn.resolved_engine, got) == ("q8", "q8dg"), case
                else:
                    assert got == jfn.resolved_engine, case
                    want = "q8" if engine == "auto" else WANT[engine][grid != "dense"]
                    assert got == (want if calib is not None else "flax"), case
                if got == "q8dg":
                    engine_obj = getattr(tfn, "infer_step", tfn).engine
                    assert engine_obj.backend == ("gemm" if grouped_gemm else "conv"), case


def _depth_counts(calls, sizes):
    """Kernel calls per step of a trunk of ``sizes`` blocks a stage, from
    the calls of a (1, 2, 2, 2) one (layers 2-4, two blocks each; a block
    ends with its expand, the call with a residual): a stage's later blocks
    repeat its block 1's calls."""
    counts, blk = collections.Counter(), 0
    for fn, _, _, _, has_res, _ in calls:
        si, bi = 1 + blk // 2, blk % 2
        counts[fn.__name__] += 1 if bi == 0 else sizes[si] - 1
        blk += has_res
    assert blk == 6
    return dict(counts)


# the counts the JAX package's q8g makes at the 32-px tile: ResNeXt-50's
# are ResNet-50's; ResNeXt-101's layer 3 has 23 blocks
Q8G_COUNTS = {4: ((3, 4, 6, 3), {"q8_matmul_px": 29, "q8_conv3_tap": 5, "q8_matmul": 8}),
              8: ((3, 4, 23, 3), {"q8_matmul_px": 63, "q8_conv3_tap": 5,
                                  "q8_matmul": 25})}


@pytest.mark.parametrize("bw", WIDTHS)
def test_q8g_calls_fit_the_hopper_core(bw, monkeypatch):
    """Every distinct q8g call of both ResNeXts at full width, the
    expanded grouped 3x3s included (a whole-tile K of 4,096 / 8,192 at
    layer 4 block 0, N = K = 2,048 / 4,096 at layer 3), is one sm90_config
    takes, and the launches per sweep step are the JAX package's count.

    The calls come from a full-width trunk of (1, 2, 2, 2) blocks, which
    holds every distinct call shape (a stage's later blocks repeat block
    1's); the full-depth counts follow from them, and are checked against
    the JAX package's own q8g counted on the same trunk and, for ResNeXt-50,
    on the full-depth one directly."""
    sizes, want = Q8G_COUNTS[bw]
    tm = init_milnet(MILNet(ResNetEncoder(Bottleneck, (1, 2, 2, 2), groups=GROUPS,
                                          base_width=bw)), 0)
    calls = _q8g_calls(tie.fold_tile_trunk(tm), "auto")
    jm = _jax_model(bw, sizes=(1, 2, 2, 2))
    params, stats = convert_milnet(_port_sd(tm), (1, 2, 2, 2), True)
    jfolded = jie.fold_tile_trunk(jm, {"params": params, "batch_stats": stats})
    monkeypatch.setattr(jqt, "GROUPED_IMPL", "blockdiag")
    kinds = dict(collections.Counter(fn.__name__ for fn, *_ in calls))
    assert kinds == _jax_q8g_counts(jfolded, "auto", monkeypatch)
    assert _depth_counts(calls, sizes) == want
    c3 = 256 * bw // 2  # c_mid of layer 3 (layer 4: twice)
    mm = [(n, segs.k_seg) for fn, n, segs, *_ in calls if fn is tq.q8_matmul]
    # layer3.1 at 2x2, layer4.0 (2x2 -> 1x1), layer4.1 at 1x1
    assert mm == [(4 * c3, 4 * c3), (2 * c3, 8 * c3), (2 * c3, 2 * c3)]
    reduce = calls[0]
    assert reduce[0] is tq.q8_matmul_px and reduce[2].px == tq.SM90_MAX_GROUPS
    for fn, n, segs, out_kind, has_res, _ in calls:
        cfg = tq.sm90_config(M_STEP, n, segs, out_kind, has_res)
        assert cfg.smem <= tq.SM90_SMEM_LIMIT and 2 <= cfg.stages <= tq.SM90_MAX_STAGES
    if bw == 4:  # the full-depth ResNeXt-50 directly
        full = tie.fold_tile_trunk(build_model("resnext50_32x4d", device="cpu"))
        calls50 = _q8g_calls(full, "auto")
        assert dict(collections.Counter(fn.__name__ for fn, *_ in calls50)) == want


def test_stage2_and_draw_take_resnext(fx, tmp_path, capsys):
    """train_stage2 (its sweep with "auto": q8dg, the dense conv chain on a
    grouped trunk) and draw_pseudo_masks (per-tile q8 on the 16/5 grid)
    run a ResNeXt as they run ResNet-50, through the same code."""
    from cellsegmentation_tpu_torch.data import LystoDataSource
    from cellsegmentation_tpu_torch.train.trainers import draw_pseudo_masks, train_stage2
    from cellsegmentation_tpu_torch.utils.logging import RunLogger

    import copy

    model = copy.deepcopy(fx[4][2])
    imgs = _structured_images(64, 3)
    train = LystoDataSource.from_arrays(imgs, ["a_0"] * 3, np.asarray([1, 0, 2]),
                                        kfold=None)
    log = RunLogger(str(tmp_path), tensorboard=False)
    head = model.fc_tile[1].weight.detach().clone()
    res = train_stage2(model, train, None, epochs=1, tile_batch_size=16,
                       image_batch=2, tiles_per_pos=1, topk_neg=2, lr=1e-2,
                       logger=log, device="cpu", record_selection=True)
    assert "[engine] auto -> q8dg" in capsys.readouterr().out
    assert len(res.selections) == 1 and len(res.selections[0]["img_idx"]) > 0
    assert not torch.equal(model.fc_tile[1].weight, head)
    with torch.no_grad():
        model.fc_image_reg[7].weight.zero_()
        model.fc_image_reg[7].bias.fill_(5.0)
        model.fc_tile[1].weight.zero_()  # every tile at P = sigmoid(6) > 0.95
        model.fc_tile[1].bias.copy_(torch.tensor([0.0, 6.0]))
    masks = draw_pseudo_masks(model, train, image_batch=2, device="cpu", logger=log)
    assert "(tile engine q8)" in capsys.readouterr().out
    assert masks.shape == (3, 64, 64) and masks.all()
