"""The port's q8g and q8d engines and its engine resolution held against the
JAX package on the same weights and numpy-seeded images.

- Resolution: every (engine, grid, encoder, calibration given or not) case
  of both step factories resolves to the JAX package's engine. Explicit
  "q8dg" off the /4 stem lattice (the 32/5 grid, test_tile's default)
  falls back to q8g, "q8d" to q8; q8dg on a BasicBlock encoder runs the
  dense conv chain; without calibration every engine runs the exact graph.
  Before this change the port raised in these cases.
- Probs of the new engines and of the fallbacks on both sides, on one
  calibration (the port's scales of the same pilot tiles).
- q8g's GEMM-land at full ResNet-50 width: every kernel call it makes
  from the 8x8 map of a 32-px tile (layer2 block0's 64-group reduce
  included) is one the Hopper core takes, in both 3x3 forms, and a sweep
  step makes 29 q8_matmul_px, 5 q8_conv3_tap and 8 q8_matmul calls (13
  q8_conv3_rowtap in the row-Toeplitz form), as the JAX package's q8g
  does, counted while its trunk is traced.

The models are full-width MILNets at stage sizes (1, 1, 1, 1), Bottleneck
and BasicBlock, with perturbed BatchNorm; the JAX variables are the port
model's, converted with the JAX package's own torch converter. The JAX side
runs its Pallas kernels in interpret mode with ``TILE_ALIGN`` cut to 32, as
its own tests do.
"""

from __future__ import annotations

import collections

import numpy as np
import pytest
import torch

from cellsegmentation_tpu.core.dtypes import DEFAULT_POLICY as J_BF16
from cellsegmentation_tpu.models.milnet import MILNet as JMILNet
from cellsegmentation_tpu.models.resnet import BasicBlock as JBasic
from cellsegmentation_tpu.models.resnet import Bottleneck as JBottleneck
from cellsegmentation_tpu.models.resnet import ResNetEncoder as JEncoder
from cellsegmentation_tpu.ops import infer_engine as jie
from cellsegmentation_tpu.ops import q8_trunk as jqt
from cellsegmentation_tpu.ops.tiles import tile_grid
from cellsegmentation_tpu.train import steps as jsteps
from cellsegmentation_tpu.utils.torch_convert import convert_milnet

from cellsegmentation_tpu_torch.kernels import q8_gemm as tq
from cellsegmentation_tpu_torch.models import (
    BasicBlock,
    Bottleneck,
    MILNet,
    ResNetEncoder,
    build_model,
)
from cellsegmentation_tpu_torch.models.milnet import init_milnet
from cellsegmentation_tpu_torch.ops import infer_engine as tie
from cellsegmentation_tpu_torch.ops import q8_trunk as tqt
from cellsegmentation_tpu_torch.train import steps as tsteps

from test_torch_port_slice import one_torch_thread  # noqa: F401 (autouse)
from test_torch_port_slice import _structured_images
from test_torch_port_sm90 import M_STEP, WRAPPERS, call_segments

SIZES = (1, 1, 1, 1)
# (hw, tile, interval): on the /4 stem lattice, and test_tile's 32/5 off it
GRIDS = {"dense": (80, 32, 20), "32/5": (40, 32, 5)}


def _models(block, seed=0):
    """(JAX model, JAX variables, port model): the port's seeded weights
    with perturbed BatchNorm, converted for the JAX side."""
    tm = init_milnet(MILNet(ResNetEncoder(block, SIZES)), seed)
    rng = np.random.default_rng(11)
    with torch.no_grad():
        for m in tm.encoder.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                c = m.num_features
                m.weight.copy_(torch.from_numpy(1 + 0.1 * rng.standard_normal(c)))
                m.bias.copy_(torch.from_numpy(0.1 * rng.standard_normal(c)))
                m.running_mean.copy_(torch.from_numpy(0.1 * rng.standard_normal(c)))
                m.running_var.copy_(torch.from_numpy(1 + 0.2 * rng.random(c)))
    sd = {k.removeprefix("encoder."): v.numpy() for k, v in tm.state_dict().items()}
    params, stats = convert_milnet(sd, SIZES, block is Bottleneck)
    jblock = JBottleneck if block is Bottleneck else JBasic
    jm = JMILNet(encoder=JEncoder(block_cls=jblock, stage_sizes=SIZES, policy=J_BF16),
                 decoder_expansion=block.expansion, policy=J_BF16)
    return jm, {"params": params, "batch_stats": stats}, tm.eval()


@pytest.fixture(scope="module")
def fx():
    mp = pytest.MonkeyPatch()
    mp.setattr(jqt, "TILE_ALIGN", 32)
    yield {"bottleneck": _models(Bottleneck), "basic": _models(BasicBlock)}
    mp.undo()


def _ones_scales(folded, deep=False, lib=jie):
    ones = [[1.0] * len(st) for st in folded.stages]
    return lib.TrunkScales(block_out=ones, h1=ones, h2=ones,
                           proj=ones if deep else None)


# the JAX package's resolution (train/steps.py:204-296): engine -> (dense
# grid, off it), for a Bottleneck and a BasicBlock encoder, with calibration
WANT = {
    "q8dg": ("q8dg", "q8g"), "q8d": ("q8d", "q8"), "q8g": ("q8g", "q8g"),
    "q8": ("q8", "q8"), "flax": ("flax", "flax"),
}


@pytest.mark.parametrize("encoder", ["bottleneck", "basic"])
@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_engine_resolution_like_jax(fx, encoder, grid, monkeypatch):
    """Every engine, with and without calibration images (the stack
    factory too for the dense requests and q8g): the JAX package's resolved
    engine. Both sides' calibration is replaced
    by unit scales here (resolution does not read them); "auto" differs by
    design on an eligible grid (the port promotes on the CPU)."""
    monkeypatch.setattr(jie, "calibrate_trunk", lambda t, c, deep=False: _ones_scales(t, deep))
    monkeypatch.setattr(tie, "calibrate_trunk", lambda t, c: _ones_scales(t, True, tie))
    jm, v, tm = fx[encoder]
    hw, ts, iv = GRIDS[grid]
    coords = tile_grid(hw, hw, ts, iv)
    imgs = _structured_images(hw, 1)
    per_batch = (jsteps.make_tile_infer_step, tsteps.make_tile_infer_step)
    stack = (jsteps.make_stack_tile_infer_step, tsteps.make_stack_tile_infer_step)
    for engine in ("q8dg", "q8d", "q8g", "q8", "flax", "auto"):
        for calib in (imgs, None):
            # the stack factory on the engines whose resolution the
            # repair changed, with calibration images
            both = engine in ("q8dg", "q8d", "q8g") and calib is not None
            for jmake, tmake in (per_batch, stack) if both else (per_batch,):
                jfn = jmake(jm, ts, coords, variables=v, engine=engine, calib_images=calib)
                tfn = tmake(tm, ts, coords, engine=engine, calib_images=calib, device="cpu")
                case = (engine, calib is not None, jmake.__name__)
                if engine == "auto" and grid == "dense" and calib is not None:
                    assert (jfn.resolved_engine, tfn.resolved_engine) == ("q8", "q8dg"), case
                    continue
                assert tfn.resolved_engine == jfn.resolved_engine, case
                want = "q8" if engine == "auto" else WANT[engine][grid != "dense"]
                assert tfn.resolved_engine == (want if calib is not None else "flax"), case


def _logodds(p):
    p = np.asarray(p, np.float64)
    return np.log(p) - np.log1p(-p)


# (encoder, grid, engine): the new engines (q8g as q8dg's fallback), and the
# fallbacks the repair adds. Measured (bf16 conv-land rounds in other places
# in XLA and oneDNN, flipping single int8 LSBs): probs max 1.1e-3 (q8g),
# 1.2e-7 (q8d); log-odds mean 4e-4 and below. The limits are q8dg's and
# per-tile q8's existing ones (tests/test_torch_port_slice.py,
# test_torch_port_stage3_engine.py).
PROB_CASES = [
    ("bottleneck", "dense", "q8d", "q8d"),
    ("bottleneck", "32/5", "q8dg", "q8g"),
    ("bottleneck", "32/5", "q8d", "q8"),
    ("basic", "dense", "q8dg", "q8dg"),
]


def _port_scales_for_jax(tm, imgs, coords, ts):
    """The JAX package's calibrate_trunk replaced by the port's scales of
    the same pilot tiles (their depths as the JAX call asks): both engines
    then run on one calibration, which tests/test_torch_port_slice.py and
    test_torch_port_stage3_engine.py hold against the JAX package's."""
    full = tie.calibrate_trunk(tie.fold_tile_trunk(tm),
                               tie.calib_tiles_from_images(imgs, coords, ts))
    shallow = tie.conv_trunk_scales(full)

    def scales(trunk, calib, deep=False):
        pick = full if deep else shallow
        return jie.TrunkScales(block_out=pick.block_out, h1=pick.h1, h2=pick.h2,
                               proj=pick.proj)
    return scales


@pytest.mark.parametrize("encoder,grid,engine,resolved", PROB_CASES,
                         ids=["-".join(c[:3]) for c in PROB_CASES])
def test_engine_probs_like_jax(fx, encoder, grid, engine, resolved, monkeypatch):
    jm, v, tm = fx[encoder]
    hw, ts, iv = GRIDS[grid]
    coords = tile_grid(hw, hw, ts, iv)
    imgs = _structured_images(hw, 1)
    f = np.asarray([3], np.int32)
    monkeypatch.setattr(jie, "calibrate_trunk", _port_scales_for_jax(tm, imgs, coords, ts))
    jfn = jsteps.make_tile_infer_step(jm, ts, coords, variables=v, engine=engine,
                                      calib_images=imgs)
    tfn = tsteps.make_tile_infer_step(tm, ts, coords, engine=engine, calib_images=imgs,
                                      device="cpu")
    assert jfn.resolved_engine == tfn.resolved_engine == resolved
    p_j, p_t = np.asarray(jfn(v, imgs, f)), tfn(imgs, f).numpy()
    assert p_t.shape == p_j.shape == (1, len(coords))
    d = np.abs(p_t - p_j)
    assert d.max() < 5e-3 and d.mean() < 1e-3, (d.max(), d.mean())
    assert np.abs(_logodds(p_t) - _logodds(p_j)).mean() < 2e-3
    if resolved == "q8g":
        assert isinstance(tfn.engine, tie.TileGemmLogits)
        assert [m.h_in for m in tfn.engine.metas] == [8, 4, 2]


def test_q8g_scales_need_every_point(fx):
    """q8g's GEMM-land reads the projection scales: given scales without
    them (a conv-land calibration), the build refuses."""
    _, _, tm = fx["bottleneck"]
    folded = tie.fold_tile_trunk(tm)
    coords = tile_grid(*GRIDS["32/5"][:1] * 2, 32, 5)
    with pytest.raises(ValueError, match="proj"):
        tsteps.make_tile_infer_step(tm, 32, coords, engine="q8g", device="cpu",
                                    scales=_ones_scales(folded, lib=tie))


@pytest.fixture(scope="module")
def resnet50():
    """A seeded full-width ResNet-50 MILNet, folded on both sides."""
    model = build_model("resnet50", device="cpu", seed=0)
    sd = {k.removeprefix("encoder."): v.numpy() for k, v in model.state_dict().items()}
    params, stats = convert_milnet(sd, (3, 4, 6, 3), True)
    jm = JMILNet(encoder=JEncoder(block_cls=JBottleneck, stage_sizes=(3, 4, 6, 3),
                                  policy=J_BF16), policy=J_BF16)
    return (tie.fold_tile_trunk(model),
            jie.fold_tile_trunk(jm, {"params": params, "batch_stats": stats}))


def _q8g_calls(folded, w2_impl):
    """Every kernel call of the full-width ResNet-50 q8g engine's GEMM-land
    on 2 tiles, as (wrapper name, n, segments, out_kind, has_res, kwargs)."""
    params, metas = tqt.build_q8_backend(folded, _ones_scales(folded, True, tie),
                                         8, 8, first_stage=1, w2_impl=w2_impl)
    qparams = tqt.upload_q8_params(params, "cpu")
    calls = []

    def recorder(fn):
        def rec(x, wt, bias, w_scale, **kw):
            calls.append((fn, wt.shape[0], call_segments(fn, x, wt, kw),
                          kw.get("out_kind", "int8"), kw.get("residual") is not None, kw))
            return fn(x, wt, bias, w_scale, **kw)
        return rec

    with pytest.MonkeyPatch.context() as mp:
        for n in WRAPPERS:
            mp.setattr(tqt, n, recorder(getattr(tq, n)))
        out = tqt.q8_backend_forward(qparams, metas, torch.zeros((2, 64 * 256), dtype=torch.int8))
    assert out.shape == (2, 2048) and out.dtype == torch.bfloat16
    return calls


def _jax_q8g_counts(jfolded, w2_impl, monkeypatch):
    """The JAX package's q8g GEMM-land kernel calls per sweep step, counted
    while its trunk is traced abstractly (jax.eval_shape) on a 32-tile
    batch."""
    import jax
    import jax.numpy as jnp

    monkeypatch.setattr(jqt, "W2_IMPL", w2_impl)
    params, metas = jqt.build_q8_backend(jfolded, _ones_scales(jfolded, True), 8, 8,
                                         first_stage=1)
    counts = collections.Counter()

    def counting(name, fn):
        def count(*args, **kwargs):
            counts[name] += 1
            return fn(*args, **kwargs)
        return count

    for n in WRAPPERS:
        monkeypatch.setattr(jqt, n, counting(n, getattr(jqt, n)))
    out = jax.eval_shape(
        lambda x: jqt.q8_backend_forward(params, metas, x, interpret=True),
        jax.ShapeDtypeStruct((32, 64 * 256), jnp.int8))
    assert out.shape == (32, 2048)
    return dict(counts)


@pytest.mark.parametrize("w2_impl", tqt.W2_IMPLS)
def test_q8g_calls_fit_the_hopper_core(resnet50, w2_impl, monkeypatch):
    """The sweep step's launches per kernel, the JAX package's q8g counts;
    and sm90_config takes every call at M = 7,200, layer2 block0's 8x8
    reduce at exactly the core's 64 pixel groups among them."""
    calls = _q8g_calls(resnet50[0], w2_impl)
    kinds = collections.Counter(fn.__name__ for fn, *_ in calls)
    assert kinds == ({"q8_matmul_px": 29, "q8_conv3_tap": 5, "q8_matmul": 8}
                     if w2_impl == "auto" else {"q8_matmul_px": 29, "q8_conv3_rowtap": 13})
    assert kinds == _jax_q8g_counts(resnet50[1], w2_impl, monkeypatch)
    reduce = calls[0]
    assert reduce[0] is tq.q8_matmul_px and reduce[2].px == tq.SM90_MAX_GROUPS == 64
    for fn, n, segs, out_kind, has_res, _ in calls:
        cfg = tq.sm90_config(M_STEP, n, segs, out_kind, has_res)
        assert cfg.smem <= tq.SM90_SMEM_LIMIT and 2 <= cfg.stages <= tq.SM90_MAX_STAGES
