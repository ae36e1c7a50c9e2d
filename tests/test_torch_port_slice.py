"""The port's stage-2 serving slice held against the JAX package on the same
weights (through the weight bridge) and the same numpy-seeded inputs.

The model is a reduced-depth Bottleneck MILNet, ``stage_sizes=(1, 1, 2, 2)``
at full width: GEMM-land still runs the tap 3x3 (layer3 block0 at 4x4 px),
the whole-tile Toeplitz 3x3s, the strided projections and the identity
residuals. Images are 150^2 with the 32/20 grid (49 tiles). BatchNorm
parameters and statistics are perturbed from their init values so that
folding is not the identity. The JAX side runs its Pallas kernels in
interpret mode with ``TILE_ALIGN`` cut to 32, as its own tests do.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import jax

from cellsegmentation_tpu import infer as jinfer
from cellsegmentation_tpu.core.dtypes import DEFAULT_POLICY as J_DEFAULT
from cellsegmentation_tpu.core.dtypes import F32_POLICY as J_F32
from cellsegmentation_tpu.models import init_variables
from cellsegmentation_tpu.models.milnet import MILNet as JMILNet
from cellsegmentation_tpu.models.resnet import Bottleneck as JBottleneck
from cellsegmentation_tpu.models.resnet import ResNetEncoder as JEncoder
from cellsegmentation_tpu.ops import infer_engine as jie
from cellsegmentation_tpu.ops import q8_trunk as jqt
from cellsegmentation_tpu.ops.tiles import tile_grid
from cellsegmentation_tpu.train import steps as jsteps

from cellsegmentation_tpu_torch import infer as tinfer
from cellsegmentation_tpu_torch.core.dtypes import DEFAULT_POLICY, F32_POLICY
from cellsegmentation_tpu_torch.data.lysto import LystoDataSource
from cellsegmentation_tpu_torch.models import Bottleneck, MILNet, ResNetEncoder
from cellsegmentation_tpu_torch.ops import infer_engine as tie
from cellsegmentation_tpu_torch.ops import q8_trunk as tqt
from cellsegmentation_tpu_torch.train import steps as tsteps
from cellsegmentation_tpu_torch.utils.jax_weights import load_jax_variables

SIZES = (1, 1, 2, 2)
HW, TILE, INTERVAL, G = 150, 32, 20, 2


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run the module's torch ops on one intra-op thread. Under pytest-xdist
    the workers share the host's cores, and torch's OpenMP pool (one thread
    per core in every worker) then spins at its barriers against the other
    workers: some of the port's tests ran 10-50x slower under six workers
    than alone. One thread per worker keeps them near their time alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _structured_images(hw, g, seed=3):
    rng = np.random.default_rng(seed)
    xx, yy = np.meshgrid(np.arange(hw), np.arange(hw), indexing="ij")
    return np.stack([
        (127 + 120 * np.sin(xx / 23.0 + i) * np.cos(yy / 17.0 - i)
         + rng.normal(0, 20, (hw, hw))).clip(0, 255)
        for i in range(g)
    ]).astype(np.uint8)[..., None].repeat(3, axis=-1)


def _perturb_bn(variables, seed=11):
    """Seeded non-trivial BatchNorm scale/bias/mean/var (numpy tree)."""
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

    walk(params["encoder"], stats["encoder"])
    return {"params": params, "batch_stats": stats}


def _jax_model(policy):
    return JMILNet(
        encoder=JEncoder(block_cls=JBottleneck, stage_sizes=SIZES, policy=policy),
        decoder_expansion=4, policy=policy,
    )


def _port_model(policy, variables):
    model = MILNet(ResNetEncoder(Bottleneck, SIZES, policy=policy), policy=policy)
    skipped = load_jax_variables(model, variables)
    assert skipped == []
    return model.eval()


@pytest.fixture(scope="module")
def fixture():
    jmodel = _jax_model(J_DEFAULT)
    variables = _perturb_bn(init_variables(jmodel, jax.random.PRNGKey(0)))
    coords = tile_grid(HW, HW, TILE, INTERVAL)
    imgs = _structured_images(HW, G)
    calib = jie.calib_tiles_from_images(imgs, coords, TILE)
    jfolded = jie.fold_tile_trunk(jmodel, variables)
    jscales = jie.calibrate_trunk(jfolded, calib, deep=True)
    return dict(jmodel=jmodel, variables=variables, coords=coords, imgs=imgs,
                calib=calib, jfolded=jfolded, jscales=jscales,
                tmodel=_port_model(DEFAULT_POLICY, variables))


def test_exact_path_matches_flax_f32(fixture):
    """The flax-engine step (the model's own graph on extracted, flipped
    tiles) under F32_POLICY. Tolerance 1e-5 on probs (measured 4e-7): both
    sides are f32 end to end and differ only in conv summation order."""
    v, coords, imgs = fixture["variables"], fixture["coords"], fixture["imgs"]
    flip = np.asarray([0, 3], np.int32)
    jfn = jsteps.make_tile_infer_step(_jax_model(J_F32), TILE, coords)
    p_j = np.asarray(jfn(v, imgs, flip))
    tfn = tsteps.make_tile_infer_step(_port_model(F32_POLICY, v), TILE, coords,
                                      engine="flax", device="cpu")
    assert tfn.resolved_engine == "flax"
    p_t = tfn(imgs, flip).numpy()
    assert p_t.shape == (G, len(coords))
    np.testing.assert_allclose(p_t, p_j, rtol=0, atol=1e-5)


def test_folding_and_packing_byte_equal(fixture):
    """BN folding of the bridged weights and build_q8_backend's int8
    packing reproduce the JAX package's arrays byte for byte."""
    tfolded = tie.fold_tile_trunk(fixture["tmodel"])
    jfolded = fixture["jfolded"]
    np.testing.assert_array_equal(tfolded.stem_w, np.asarray(jfolded.stem_w, np.float32))
    for ts, js in zip(tfolded.stages, jfolded.stages):
        for tb, jb in zip(ts, js):
            assert len(tb) == len(jb)
            for a, b in zip(tb, jb):
                np.testing.assert_array_equal(a, np.asarray(b, np.float32))
    jscales = fixture["jscales"]
    tp, tm = tqt.build_q8_backend(tfolded, jscales, 4, 4, first_stage=2)
    jp, jm = jqt.build_q8_backend(jfolded, jscales, 4, 4, first_stage=2)
    assert [m.w2_impl for m in tm] == ["tap", "wholetile", "wholetile", "wholetile"]
    for a, b in zip(tm, jm):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    for a, b in zip(tp, jp):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == np.asarray(b[k]).dtype, k
            assert a[k].tobytes() == np.asarray(b[k]).tobytes(), k


def test_calibration_scales_match(fixture):
    """calibrate_trunk on the same pilot tiles: every scale within 0.1%
    relative. The stem runs in bf16 on both sides, where a summation-order
    difference can move one output by a bf16 ulp (0.4%) and so an absmax
    by a fraction of that; the f32 blocks add only summation-order noise."""
    ts = tie.calibrate_trunk(tie.fold_tile_trunk(fixture["tmodel"]), fixture["calib"])
    js = fixture["jscales"]
    for name in ("block_out", "h1", "h2", "proj"):
        a = [v for row in getattr(ts, name) for v in row]
        b = [v for row in getattr(js, name) for v in row]
        assert [x is None for x in a] == [x is None for x in b], name
        got = np.asarray([x for x in a if x is not None])
        want = np.asarray([x for x in b if x is not None])
        np.testing.assert_allclose(got, want, rtol=1e-3, err_msg=name)


def test_gemm_land_matches_pallas(fixture, monkeypatch):
    """q8_backend_forward on the same int8 entry tensor: every block's int8
    output equal, the final bf16 features within 1 ulp."""
    monkeypatch.setattr(jqt, "TILE_ALIGN", 32)
    jscales = fixture["jscales"]
    jp, jm = jqt.build_q8_backend(fixture["jfolded"], jscales, 4, 4, first_stage=2)
    tp = tqt.upload_q8_params(jp, "cpu")
    rng = np.random.default_rng(7)
    m = 32
    xq = rng.integers(-127, 128, size=(m, 16 * jm[0].c_in)).astype(np.int8)
    for i in range(len(jm)):
        want = np.asarray(jqt.q8_backend_forward(jp[: i + 1], jm[: i + 1], xq,
                                                 interpret=True))
        got = tqt.q8_backend_forward(tp[: i + 1], jm[: i + 1], torch.from_numpy(xq))
        if jm[i].s_out is not None:
            np.testing.assert_array_equal(got.numpy(), want)
        else:
            w = want.astype(np.float32)
            ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(w), 1e-30))) - 7)
            assert np.all(np.abs(got.float().numpy() - w) <= ulp)


def test_rowtap_packing_byte_equal(fixture, monkeypatch):
    """build_q8_backend(w2_impl="rowtap") packs every 3x3 in the dy-major
    row-Toeplitz form, byte for byte as the JAX package does under
    W2_IMPL="rowtap"."""
    monkeypatch.setattr(jqt, "W2_IMPL", "rowtap")
    jscales = fixture["jscales"]
    tfolded = tie.fold_tile_trunk(fixture["tmodel"])
    tp, tm = tqt.build_q8_backend(tfolded, jscales, 4, 4, first_stage=2,
                                  w2_impl="rowtap")
    jp, jm = jqt.build_q8_backend(fixture["jfolded"], jscales, 4, 4,
                                  first_stage=2)
    assert [m.w2_impl for m in tm] == ["rowtap"] * 4
    for a, b in zip(tm, jm):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    for a, b in zip(tp, jp):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == np.asarray(b[k]).dtype, k
            assert a[k].tobytes() == np.asarray(b[k]).tobytes(), k
    with pytest.raises(ValueError, match="w2_impl"):
        tqt.build_q8_backend(tfolded, jscales, 4, 4, first_stage=2,
                             w2_impl="gdot")


def test_rowtap_gemm_land_matches_pallas_and_auto(fixture, monkeypatch):
    """q8_backend_forward in the row-Toeplitz form on one int8 entry tensor:
    every block's int8 output equals the JAX package's rowtap trunk in
    interpret mode and the final bf16 features lie within 1 ulp of it (as
    in the auto form's test above: XLA contracts the final epilogue's
    multiply-add, the port rounds each step); against the port's own auto
    form (tap + whole-tile) every output is bit-identical."""
    monkeypatch.setattr(jqt, "TILE_ALIGN", 32)
    monkeypatch.setattr(jqt, "W2_IMPL", "rowtap")
    jscales, tfolded = fixture["jscales"], tie.fold_tile_trunk(fixture["tmodel"])
    jp, jm = jqt.build_q8_backend(fixture["jfolded"], jscales, 4, 4, first_stage=2)
    built = {impl: tqt.build_q8_backend(tfolded, jscales, 4, 4, first_stage=2,
                                        w2_impl=impl)
             for impl in ("rowtap", "auto")}
    tp = {impl: tqt.upload_q8_params(hp, "cpu") for impl, (hp, _) in built.items()}
    rng = np.random.default_rng(12)
    xq = rng.integers(-127, 128, size=(32, 16 * jm[0].c_in)).astype(np.int8)
    for i in range(len(jm)):
        got = {impl: tqt.q8_backend_forward(tp[impl][: i + 1],
                                            built[impl][1][: i + 1],
                                            torch.from_numpy(xq))
               for impl in tp}
        assert torch.equal(got["rowtap"], got["auto"]), i
        want = np.asarray(jqt.q8_backend_forward(jp[: i + 1], jm[: i + 1], xq,
                                                 interpret=True))
        if jm[i].s_out is not None:
            np.testing.assert_array_equal(got["rowtap"].numpy(), want)
        else:
            w = want.astype(np.float32)
            ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(w), 1e-30))) - 7)
            assert np.all(np.abs(got["rowtap"].float().numpy() - w) <= ulp)


def test_q8dg_sweep_rowtap_equals_auto(fixture):
    """The whole q8dg sweep with every 3x3 in the row-Toeplitz form gives
    the same probs as the auto forms, flip-free and flipped."""
    coords, imgs = fixture["coords"], fixture["imgs"]
    steps = {
        impl: tsteps.make_tile_infer_step(
            fixture["tmodel"], TILE, coords, engine="q8dg", device="cpu",
            scales=fixture["jscales"], w2_impl=impl)
        for impl in ("auto", "rowtap")
    }
    assert [m.w2_impl for m in steps["rowtap"].engine.metas] == ["rowtap"] * 4
    for flip in ([0, 0], [0, 3]):
        f = np.asarray(flip, np.int32)
        assert torch.equal(steps["rowtap"](imgs, f), steps["auto"](imgs, f))


@pytest.mark.parametrize("flip", [None, (0, 3)])
def test_q8dg_slice_matches_jax(fixture, flip, monkeypatch):
    """The whole q8dg sweep, both fed the JAX calibration's TrunkScales:
    probs within 0.01 abs and 1e-3 on average (conv-land bf16 rounds in
    other places in XLA and oneDNN, which flips single int8 LSBs of the
    sandwiches; measured 0.004 max, 4e-5 mean) and the same
    top-k tiles wherever the JAX margin to the selection boundary is
    decisive (> 0.02)."""
    monkeypatch.setattr(jqt, "TILE_ALIGN", 32)
    coords, imgs, v = fixture["coords"], fixture["imgs"], fixture["variables"]
    f = np.zeros(G, np.int32) if flip is None else np.asarray(flip, np.int32)
    jfn = jsteps.make_tile_infer_step(
        fixture["jmodel"], TILE, coords, variables=v, engine="q8dg",
        calib_images=imgs,
    )
    p_j = np.asarray(jfn(v, imgs, f))
    tfn = tsteps.make_tile_infer_step(
        fixture["tmodel"], TILE, coords, engine="auto", device="cpu",
        calib_images=imgs, scales=fixture["jscales"],
    )
    assert tfn.resolved_engine == "q8dg"
    p_t = tfn(imgs, f).numpy()
    assert p_t.shape == p_j.shape == (G, len(coords))
    assert np.abs(p_t - p_j).max() < 0.01
    assert np.abs(p_t - p_j).mean() < 1e-3
    labels = np.asarray([3, 0])
    tiles_per_pos, topk_neg, tie_eps = 2, 4, 0.02
    for i in range(G):
        k = labels[i] * tiles_per_pos if labels[i] > 0 else topk_neg
        order = np.argsort(-p_j[i], kind="stable")
        boundary = p_j[i][order[k - 1]]
        top_t = set(np.argsort(-p_t[i], kind="stable")[:k])
        for t in set(order[:k]).symmetric_difference(top_t):
            assert abs(p_j[i][t] - boundary) <= tie_eps, (i, t)


def test_inference_tiles_and_sample_topk_match_jax(fixture, monkeypatch):
    """inference_tiles + sample_topk over an augmented source (flip-free and
    flipped batches) through the port's q8dg step, against the JAX package's
    sampler on the same probs."""
    from cellsegmentation_tpu.data.lysto import LystoDataSource as JSource

    monkeypatch.setattr(jqt, "TILE_ALIGN", 32)
    coords, imgs = fixture["coords"], fixture["imgs"]
    counts = np.asarray([3, 0])
    organs = ["colon_0", "breast_1"]
    src = LystoDataSource.from_arrays(imgs, organs, counts, kfold=None,
                                      augment=True)
    assert list(src.flip_code) == [0, 0, 1, 1, 2, 2, 3, 3]
    step = tsteps.make_tile_infer_step(
        fixture["tmodel"], TILE, coords, engine="q8dg", device="cpu",
        scales=fixture["jscales"],
    )
    probs = tinfer.inference_tiles(src, step, TILE, INTERVAL, image_batch=2)
    assert probs.shape == (8, len(coords))
    assert np.isfinite(probs).all() and (probs >= 0).all() and (probs <= 1).all()
    # each batch is one flip code; the batch of flip 0 matches a direct call
    np.testing.assert_array_equal(probs[:2], step(imgs, np.zeros(2, np.int32)).numpy())

    jsrc = JSource.__new__(JSource)
    jsrc.images, jsrc.labels = src.images, src.labels
    jsrc.base_idx, jsrc.flip_code = src.base_idx, src.flip_code
    kw = dict(tiles_per_pos=2, topk_neg=4, pos_neg_ratio=0.5, seed=123)
    sel_t = tinfer.sample_topk(src, probs, TILE, INTERVAL, device="cpu", **kw)
    sel_j = jinfer.sample_topk(jsrc, probs, TILE, INTERVAL, **kw)
    for key in ("img_idx", "xs", "ys", "flip", "label", "n_pos", "n_neg"):
        np.testing.assert_array_equal(sel_t[key], sel_j[key])


def test_q8dg_full_width_resnet50_299(monkeypatch):
    """The full-width ResNet-50 q8dg sweep at 299^2 / 32 / 20 (225 tiles),
    port against the JAX package on bridged weights and the JAX calibration's
    TrunkScales, one flip-free and one flipped image. The tile head's kernel
    is scaled by 0.01 on both sides, so the random-init logits do not
    saturate the probs. Compared on log-odds: max 0.1, mean 0.005 (measured
    0.020 / 0.00045); the JAX engine's own distance from its exact graph is
    ~0.015 on average here, so the port stays well inside the engine's
    approximation."""
    from cellsegmentation_tpu.models import build_model as jbuild
    from cellsegmentation_tpu_torch.data import make_synthetic_arrays
    from cellsegmentation_tpu_torch.models import build_model

    monkeypatch.setattr(jqt, "TILE_ALIGN", 32)
    jmodel = jbuild("resnet50")
    v = jax.tree_util.tree_map(
        np.asarray, init_variables(jmodel, jax.random.PRNGKey(0))
    )
    dense = v["params"]["fc_tile"]["Dense_0"]
    dense["kernel"] = dense["kernel"] * np.float32(0.01)
    tmodel = build_model("resnet50", device="cpu")
    load_jax_variables(tmodel, v)
    imgs = make_synthetic_arrays(2, 299, 30, seed=0)["images"]
    coords = tile_grid(299, 299, TILE, INTERVAL)
    flip = np.asarray([0, 3], np.int32)
    jfn = jsteps.make_tile_infer_step(jmodel, TILE, coords, variables=v,
                                      engine="q8dg", calib_images=imgs)
    p_j = np.asarray(jfn(v, imgs, flip))
    calib = jie.calib_tiles_from_images(imgs, coords, TILE)
    jscales = jie.calibrate_trunk(jie.fold_tile_trunk(jmodel, v), calib, deep=True)
    tfn = tsteps.make_tile_infer_step(tmodel, TILE, coords, engine="q8dg",
                                      device="cpu", scales=jscales)
    p_t = tfn(imgs, flip).numpy()
    assert p_t.shape == (2, 225)

    def logodds(p):
        p = np.asarray(p, np.float64)
        return np.log(p) - np.log1p(-p)

    d = np.abs(logodds(p_t) - logodds(p_j))
    assert d.max() < 0.1 and d.mean() < 0.005, (d.max(), d.mean())
