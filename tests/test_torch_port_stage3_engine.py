"""The port's per-tile q8 engine and ``engine="auto"``'s fallback to it, held
against the JAX package on the same weights and numpy-seeded images.

The grid is the stage-3 CLI's 16/5 on 64^2 images (121 tiles each), off the
/4 stem lattice, so q8dg does not qualify on either side and ``"auto"``
resolves to per-tile q8 on both (the JAX package's CPU backend never
promotes to q8dg; the port would, were the grid eligible). The models are
full-width MILNets at stage sizes (1, 1, 1, 1), Bottleneck and BasicBlock,
with perturbed BatchNorm, in bf16 (the engine's only dtype).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cellsegmentation_tpu.core.dtypes import DEFAULT_POLICY as J_BF16
from cellsegmentation_tpu.models import init_variables
from cellsegmentation_tpu.models.milnet import MILNet as JMILNet
from cellsegmentation_tpu.models.resnet import BasicBlock as JBasic
from cellsegmentation_tpu.models.resnet import Bottleneck as JBottleneck
from cellsegmentation_tpu.models.resnet import ResNetEncoder as JEncoder
from cellsegmentation_tpu.ops import infer_engine as jie
from cellsegmentation_tpu.ops.tiles import tile_grid
from cellsegmentation_tpu.train import steps as jsteps

from cellsegmentation_tpu_torch.models import (
    BasicBlock,
    Bottleneck,
    MILNet,
    ResNetEncoder,
)
from cellsegmentation_tpu_torch.ops import infer_engine as tie
from cellsegmentation_tpu_torch.train import steps as tsteps
from cellsegmentation_tpu_torch.utils.jax_weights import load_jax_variables

from test_torch_port_slice import one_torch_thread  # noqa: F401 (autouse)
from test_torch_port_slice import _structured_images
from test_torch_port_stage3 import perturb

SIZES = (1, 1, 1, 1)
HW, TILE, INTERVAL, G = 64, 16, 5, 2


def _models(block, jblock):
    jm = JMILNet(encoder=JEncoder(block_cls=jblock, stage_sizes=SIZES, policy=J_BF16),
                 decoder_expansion=block.expansion, policy=J_BF16)
    v = perturb(init_variables(jm, jax.random.PRNGKey(0)))
    tm = MILNet(ResNetEncoder(block, SIZES))
    assert load_jax_variables(tm, v) == []
    return jm, v, tm.eval()


@pytest.fixture(scope="module")
def fx():
    return dict(imgs=_structured_images(HW, G), coords=tile_grid(HW, HW, TILE, INTERVAL),
                bottleneck=_models(Bottleneck, JBottleneck))


def _logodds(p):
    p = np.asarray(p, np.float64)
    return np.log(p) - np.log1p(-p)


def _same_topk(p_t, p_j, k, tie_eps):
    """The top-k tiles of each image agree wherever the JAX margin to the
    selection boundary is decisive (> tie_eps)."""
    for i in range(len(p_j)):
        order = np.argsort(-p_j[i], kind="stable")
        boundary = p_j[i][order[k - 1]]
        top_t = set(np.argsort(-p_t[i], kind="stable")[:k])
        for t in set(order[:k]).symmetric_difference(top_t):
            assert abs(p_j[i][t] - boundary) <= tie_eps, (i, t)


# Bottleneck, bf16 (measured in brackets): probs max 5e-3 (1.9e-3), mean
# 1e-4 (1.4e-5); log-odds mean 1e-3 (6.2e-5). Conv-land rounds bf16 in other
# places in XLA and oneDNN, which flips single int8 LSBs of the sandwiches.
# The limits reject a wrong sandwich depth: h1/h2 sandwiched in every stage
# read log-odds mean 8.2e-3, in stage 0 only 1.1e-2, the last block's
# output left unsandwiched 5.2e-3.
@pytest.mark.parametrize("flip", [(0, 0), (0, 3)])
def test_auto_falls_back_to_per_tile_q8_like_jax(fx, flip):
    jm, v, tm = fx["bottleneck"]
    imgs, coords = fx["imgs"], fx["coords"]
    f = np.asarray(flip, np.int32)
    jfn = jsteps.make_tile_infer_step(jm, TILE, coords, variables=v, engine="auto",
                                      calib_images=imgs)
    tfn = tsteps.make_tile_infer_step(tm, TILE, coords, engine="auto",
                                      calib_images=imgs, device="cpu")
    assert jfn.resolved_engine == tfn.resolved_engine == "q8"
    p_j = np.asarray(jfn(v, imgs, f))
    p_t = tfn(imgs, f).numpy()
    assert p_t.shape == p_j.shape == (G, len(coords)) == (G, 121)
    d = np.abs(p_t - p_j)
    assert d.max() < 5e-3 and d.mean() < 1e-4, (d.max(), d.mean())
    assert np.abs(_logodds(p_t) - _logodds(p_j)).mean() < 1e-3
    _same_topk(p_t, p_j, k=20, tie_eps=0.005)


def test_explicit_q8_in_both_factories(fx):
    """engine="q8" in the per-batch and the stack factories, on both sides;
    the port's stack step is its per-batch step after the gather, and the
    JAX calibration's scales (deep=False) give the port's own probs."""
    jm, v, tm = fx["bottleneck"]
    imgs, coords = fx["imgs"], fx["coords"]
    f = np.asarray([3, 1], np.int32)
    idx = np.asarray([1, 0])
    jstack = jsteps.make_stack_tile_infer_step(jm, TILE, coords, variables=v,
                                               engine="q8", calib_images=imgs)
    tstack = tsteps.make_stack_tile_infer_step(tm, TILE, coords, engine="q8",
                                               calib_images=imgs, device="cpu")
    assert jstack.resolved_engine == tstack.resolved_engine == "q8"
    p_j = np.asarray(jstack(v, jnp.asarray(imgs), idx, f))
    p_t = tstack(torch.from_numpy(imgs), idx, f).numpy()
    assert np.abs(p_t - p_j).max() < 5e-3 and np.abs(p_t - p_j).mean() < 1e-4
    step = tsteps.make_tile_infer_step(tm, TILE, coords, engine="q8",
                                       calib_images=imgs, device="cpu")
    assert step.resolved_engine == "q8"
    np.testing.assert_array_equal(step(imgs[idx], f).numpy(), p_t)
    jscales = jie.calibrate_trunk(
        jie.fold_tile_trunk(jm, v), jie.calib_tiles_from_images(imgs, coords, TILE))
    with_j = tsteps.make_tile_infer_step(tm, TILE, coords, engine="q8",
                                         scales=jscales, device="cpu")
    np.testing.assert_allclose(with_j(imgs[idx], f).numpy(), p_t, rtol=0, atol=2e-3)


def test_conv_trunk_scales_are_jax_depths(fx):
    """conv_trunk_scales of the port's calibration: the JAX package's
    calibrate_trunk(deep=False) points (block outputs everywhere, h1/h2 in
    stages 0-1, no projections), each within 0.1% (a bf16 stem on both)."""
    jm, v, tm = fx["bottleneck"]
    calib = jie.calib_tiles_from_images(fx["imgs"], fx["coords"], TILE)
    js = jie.calibrate_trunk(jie.fold_tile_trunk(jm, v), calib)
    ts = tie.conv_trunk_scales(tie.calibrate_trunk(tie.fold_tile_trunk(tm), calib))
    assert js.proj is None and ts.proj is None
    for name in ("block_out", "h1", "h2"):
        a, b = getattr(ts, name), getattr(js, name)
        assert [[x is None for x in r] for r in a] == [[x is None for x in r] for r in b]
        got = [x for r in a for x in r if x is not None]
        want = [x for r in b for x in r if x is not None]
        np.testing.assert_allclose(got, want, rtol=1e-3, err_msg=name)
    assert [r[0] is None for r in ts.h1] == [False, False, True, True]


def test_head_logits_pool_in_bf16_like_jax():
    """_head_logits on a 2x2 bf16 map (a 64-px tile's x4): the mean summed
    in f32 and rounded to bf16, plus the bf16 max, in bf16; then the Dense
    on bf16 operands. Pooled values bit-equal, logits within 1e-5 (the f32
    dot's summation order)."""
    rng = np.random.default_rng(0)
    x = (3 * rng.standard_normal((64, 2, 2, 2048))).astype(np.float32)
    k = (0.02 * rng.standard_normal((2048, 2))).astype(np.float32)
    b = rng.standard_normal(2).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(jax.jit(jie._head_logits)(
        {"Dense_0": {"kernel": jnp.asarray(k), "bias": jnp.asarray(b)}}, xb))
    fc = torch.nn.Sequential(torch.nn.Flatten(), torch.nn.Linear(2048, 2))
    with torch.no_grad():
        fc[1].weight.copy_(torch.from_numpy(k.T))
        fc[1].bias.copy_(torch.from_numpy(b))
        got = tie._head_logits(fc, torch.from_numpy(x).to(torch.bfloat16)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_basic_block_per_tile_q8_matches_jax(fx):
    """A BasicBlock encoder folds for per-tile q8 as in the JAX package (and
    never for q8dg's GEMM chain): auto -> q8 on both sides, probs within the
    Bottleneck test's limits (measured: 241 of 242 tiles within 1e-7, one
    int8 LSB flip moved one by 1.1e-3)."""
    jm, v, tm = _models(BasicBlock, JBasic)
    imgs, coords = fx["imgs"], fx["coords"]
    f = np.asarray([0, 2], np.int32)
    jfn = jsteps.make_tile_infer_step(jm, TILE, coords, variables=v, engine="auto",
                                      calib_images=imgs)
    tfn = tsteps.make_tile_infer_step(tm, TILE, coords, engine="auto",
                                      calib_images=imgs, device="cpu")
    assert jfn.resolved_engine == tfn.resolved_engine == "q8"
    assert tfn.engine.kind == "basic"
    d = np.abs(tfn(imgs, f).numpy() - np.asarray(jfn(v, imgs, f)))
    assert d.max() < 5e-3 and d.mean() < 1e-4, (d.max(), d.mean())
    assert tie.make_dense_tile_probs(tm, 32, 20, 150, None) is None


def test_engine_resolution_rules(fx):
    """Without calibration images or scales every engine runs the exact
    graph, as in the JAX package (q8dg, q8d and q8g included, which raised
    before they were ported); an unknown name is refused; all six of the
    JAX package's engines are offered."""
    _, _, tm = fx["bottleneck"]
    coords = fx["coords"]
    for engine in ("auto", "q8", "flax", "q8dg", "q8d", "q8g"):
        step = tsteps.make_tile_infer_step(tm, TILE, coords, engine=engine, device="cpu")
        assert step.resolved_engine == "flax", engine
    with pytest.raises(ValueError, match="unknown engine"):
        tsteps.make_tile_infer_step(tm, TILE, coords, engine="q9", device="cpu")
    assert set(tsteps.ENGINES) == {"flax", "auto", "q8", "q8g", "q8d", "q8dg"}
