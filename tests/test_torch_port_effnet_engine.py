"""The port's EfficientNet per-tile q8 engine (ops/effnet_engine.py) held
against the JAX package's on the same folded weights: the fold, the
calibration's block-output scales, the engine's logits on the same scales,
and engine resolution for every request in both tile-sweep factories; and
the ranking-fidelity gate of the JAX package's engine tests on a
full-width B0. The reduced model and its JAX variables are
``tests/test_torch_port_effnet.py``'s fixture.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cellsegmentation_tpu.data.batches import normalize_images as jnormalize
from cellsegmentation_tpu.ops import effnet_engine as jeff
from cellsegmentation_tpu.ops import infer_engine as jie
from cellsegmentation_tpu.ops.tiles import tile_grid
from cellsegmentation_tpu.train import steps as jsteps

from cellsegmentation_tpu_torch.data import normalize_images
from cellsegmentation_tpu_torch.models import build_model
from cellsegmentation_tpu_torch.models.milnet import settle_batch_stats
from cellsegmentation_tpu_torch.ops import effnet_engine as teff
from cellsegmentation_tpu_torch.ops import infer_engine as tie
from cellsegmentation_tpu_torch.train import steps as tsteps

from test_torch_port_effnet import _images, _jax_model, fx  # noqa: F401 (fx: a fixture)
from test_torch_port_slice import one_torch_thread  # noqa: F401 (autouse)

TILE = 32


def _tiles(n, seed):
    """Normalized f32 NHWC 32^2 tiles of uniform random pixels."""
    u8 = _images(n, seed, hw=TILE)
    return np.array(jnormalize(u8, np.zeros(n, np.int32)), np.float32)


def _f32(a):
    return np.asarray(a, np.float32)


@pytest.fixture(scope="module")
def jax_engine(fx):
    """The JAX package's fold and calibration (16 pilot tiles) of the
    reduced model."""
    jm, v = _jax_model(), fx["variables"]
    trunk = jeff.fold_effnet_trunk(jm, v)
    calib = _tiles(16, seed=6)
    return trunk, jeff.calibrate_effnet(trunk, calib), calib


def test_fold_like_jax(fx, jax_engine):
    """fold_effnet_trunk: the block metas and every folded array (stem,
    each block's expand / depthwise / project and squeeze-excite weights,
    the widening 1x1) equal to the JAX package's."""
    jt, _, _ = jax_engine
    tt = teff.fold_effnet_trunk(fx["model"])
    assert [tuple(dataclass_row(m)) for m in tt.metas] == [
        tuple(dataclass_row(m)) for m in jt.metas]
    assert any(m.use_res for m in tt.metas) and any(m.stride == 2 for m in tt.metas)
    assert {m.kernel for m in tt.metas} == {3, 5}
    for t, j in ((tt.stem, jt.stem), (tt.widen, jt.widen)):
        for a, b in zip(t, j):
            np.testing.assert_array_equal(a, _f32(b))
    assert len(tt.blocks) == len(jt.blocks) == 10
    assert sum("expand" in b for b in tt.blocks) == 9
    for tb, jb in zip(tt.blocks, jt.blocks):
        assert tb.keys() == jb.keys()
        for k in tb:
            assert len(tb[k]) == len(jb[k])
            for a, b in zip(tb[k], jb[k]):
                np.testing.assert_array_equal(a, _f32(b), err_msg=k)


def dataclass_row(meta):
    return meta.kernel, meta.stride, meta.expanded, meta.use_res


# the host f32 forward of each side orders its sums differently: relative
# 1e-5 (measured <= 6.7e-7)
def test_calibration_scales_like_jax(fx, jax_engine):
    """calibrate_effnet on the same pilot tiles: one scale per block
    output, each within 1e-5 relative of the JAX package's."""
    jt, jscales, calib = jax_engine
    scales = teff.calibrate_effnet(teff.fold_effnet_trunk(fx["model"]), calib)
    assert len(scales) == len(jscales) == 10
    np.testing.assert_allclose(scales, jscales, rtol=1e-5)
    assert len(set(scales)) == 10


# Logits on the same folded weights and the same scales, 48 tiles: the two
# frameworks round the bf16 convs, SiLU and the gate in other places, and
# the int8 sandwiches turn some of those roundings into 1-LSB flips. Against
# the exact f32 graph (mean |error| / mean |logit|) the port's engine reads
# 0.0154 and the JAX package's 0.0165 (plain folded trunk: 0.0077 and
# 0.0080); the two engines sit 0.0163 apart in the mean and 0.022 of the
# largest logit at most (plain: 0.0077 and 0.0175). Held: the port's
# error at most 1.6x the JAX engine's (+ 1e-3), and the two within 5e-2
# of the largest logit and 3e-2 in the mean.
@pytest.mark.parametrize("sandwiched", [True, False])
def test_engine_logits_like_jax(fx, jax_engine, sandwiched):
    jt, jscales, _ = jax_engine
    scales = jscales if sandwiched else None
    x = _tiles(48, seed=8)
    head = fx["variables"]["params"]["fc_tile"]

    @jax.jit
    def run(tree, x):
        x4 = jeff.effnet_forward(tree, jt.metas, x.astype(jnp.bfloat16), scales=scales)
        return jie._head_logits(head, x4)

    want = _f32(run(jax.device_put((jt.stem, jt.blocks, jt.widen)), x))
    trunk = teff.fold_effnet_trunk(fx["model"])
    with torch.no_grad():
        exact = fx["model"](torch.from_numpy(x), mode="tile").numpy()
        if sandwiched:
            engine = tie.make_fast_tile_logits(fx["model"], scales=list(jscales))
            assert isinstance(engine, teff.EffTrunkLogits)
            got = engine(torch.from_numpy(x).to(torch.bfloat16)).numpy()
        else:
            x4 = teff.effnet_forward(teff.effnet_tree(trunk, "cpu"), trunk.metas,
                                     torch.from_numpy(x).to(torch.bfloat16))
            got = tie._head_logits(fx["model"].fc_tile, x4).numpy()

    def mean_rel(a, ref):
        return float(np.abs(a - ref).mean() / np.abs(ref).mean())

    assert mean_rel(got, exact) <= 1.6 * mean_rel(want, exact) + 1e-3
    assert np.abs(got - want).max() <= 5e-2 * np.abs(want).max()
    assert mean_rel(got, want) <= 3e-2


def test_engine_ranking_fidelity_full_width_b0():
    """The JAX package's ranking gate (tests/test_infer_engine.py), on the
    port alone at full width: B0's seeded weights with its statistics set
    from 8 images, 64 random 32^2 tiles, the engine calibrated on 16 of
    them against the exact f32 graph: the tile margins' correlation above
    0.9 and their rank correlation above 0.85 (measured 0.963 and 0.955)."""
    from cellsegmentation_tpu_torch.core.dtypes import F32_POLICY

    model = build_model("efficientnet_b0", policy=F32_POLICY, device="cpu")
    settle_batch_stats(model, normalize_images(torch.from_numpy(_images(8, 9)),
                                               torch.zeros(8, dtype=torch.int32)))
    x = _tiles(64, seed=1)
    engine = tie.make_fast_tile_logits(model, calib_tiles=x[:16])
    got = engine(torch.from_numpy(x).to(torch.bfloat16)).numpy()
    with torch.no_grad():
        want = model(torch.from_numpy(x), mode="tile").numpy()
    m_g, m_w = got[:, 1] - got[:, 0], want[:, 1] - want[:, 0]
    assert np.corrcoef(m_g, m_w)[0, 1] > 0.9
    rank_g, rank_w = np.argsort(np.argsort(m_g)), np.argsort(np.argsort(m_w))
    assert np.corrcoef(rank_g, rank_w)[0, 1] > 0.85


ENGINES = ("flax", "auto", "q8", "q8g", "q8d", "q8dg")


@pytest.mark.parametrize("factory", ["infer", "stack"])
def test_resolved_engine_like_jax(fx, monkeypatch, factory):
    """Every engine request, with and without calibration images, on the
    /4 lattice grid (80^2, 32/20) and off it (64^2, 32/5), in both sweep
    factories: the port resolves as the JAX package does (auto and q8d ->
    q8, q8dg -> q8g, q8g -> q8g, no calibration -> flax), and every engine
    but flax is the MBConv engine. (The JAX package's calibration is
    replaced by fixed scales: resolution does not read them.)"""
    monkeypatch.setattr(jeff, "calibrate_effnet", lambda trunk, tiles: [1.0] * len(trunk.metas))
    v, jm = fx["variables"], _jax_model()
    seen = set()
    for hw, interval in ((80, 20), (64, 5)):
        coords = tile_grid(hw, hw, TILE, interval)
        imgs = _images(2, seed=4, hw=hw)
        for engine in ENGINES:
            for calib in (imgs, None):
                if factory == "infer":
                    jstep = jsteps.make_tile_infer_step(jm, TILE, coords, variables=v,
                                                        engine=engine, calib_images=calib)
                    tstep = tsteps.make_tile_infer_step(fx["model"], TILE, coords,
                                                        engine=engine, calib_images=calib,
                                                        device="cpu")
                else:
                    jstep = jsteps.make_stack_tile_infer_step(jm, TILE, coords, variables=v,
                                                              engine=engine,
                                                              calib_images=calib)
                    tstep = tsteps.make_stack_tile_infer_step(fx["model"], TILE, coords,
                                                              engine=engine,
                                                              calib_images=calib,
                                                              device="cpu")
                assert tstep.resolved_engine == jstep.resolved_engine, (engine, calib is None)
                built = getattr(tstep, "engine", None) or getattr(
                    getattr(tstep, "infer_step", None), "engine", None)
                assert (tstep.resolved_engine == "flax") == (built is None)
                assert built is None or isinstance(built, teff.EffTrunkLogits)
                seen.add((engine, calib is None, tstep.resolved_engine))
    assert {(e, r) for e, nocal, r in seen if not nocal} == {
        ("flax", "flax"), ("auto", "q8"), ("q8", "q8"), ("q8g", "q8g"),
        ("q8d", "q8"), ("q8dg", "q8g")}
    assert {r for _, nocal, r in seen if nocal} == {"flax"}
