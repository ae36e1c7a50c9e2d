"""q8dg's conv/GEMM splits in the port (``gemm_first_stage`` /
``gemm_first_block``, with the hybrid conv->GEMM entry at (1, 0)), held
against the JAX package's dense engine on the same weights and scales, and
the launch counts each split gives the full-width ResNet-50.

The fixture is ``tests/test_torch_port_slice.py``'s: a reduced-depth
Bottleneck MILNet (``stage_sizes=(1, 1, 2, 2)``) at full width, 150^2
images on the 32/20 grid, perturbed BatchNorm; the JAX side runs its Pallas
kernels in interpret mode with ``TILE_ALIGN`` cut to 32.
"""

from __future__ import annotations

import collections

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cellsegmentation_tpu.ops import infer_engine as jie
from cellsegmentation_tpu.ops import q8_trunk as jqt

from cellsegmentation_tpu_torch.kernels import q8_gemm as tq
from cellsegmentation_tpu_torch.models import build_model
from cellsegmentation_tpu_torch.ops import infer_engine as tie
from cellsegmentation_tpu_torch.ops import q8_trunk as tqt
from cellsegmentation_tpu_torch.ops.dense_frontend import dense_grid_meta

from test_torch_port_serve import _ones_scales
from test_torch_port_slice import G, HW, INTERVAL, TILE, fixture, one_torch_thread  # noqa: F401
from test_torch_port_sm90 import M_STEP, WRAPPERS, call_segments

# probs against the JAX engine: the slice test's limits (conv-land bf16
# rounds in other places in XLA and oneDNN and flips single int8 LSBs)
MAX_DIFF, MEAN_DIFF = 0.01, 1e-3
# ResNet-50's launches per image batch, (q8_conv3_tap, q8_matmul, q8_matmul_px)
SPLIT_LAUNCHES = {(2, 0): (1, 8, 20), (1, 1): (4, 8, 26), (1, 0): (5, 8, 27)}


def _jax_probs(fx, flip, **kw):
    fn, tree = jie.make_dense_tile_probs(fx["jmodel"], fx["variables"], TILE, INTERVAL,
                                         HW, fx["calib"], backend="gemm", **kw)
    head = fx["variables"]["params"]["fc_tile"]
    return np.asarray(jax.jit(fn)(head, tree, jnp.asarray(fx["imgs"]), jnp.asarray(flip)))


def _port_engine(fx, **kw):
    return tie.make_dense_tile_probs(fx["tmodel"], TILE, INTERVAL, HW, None,
                                     scales=fx["jscales"], **kw)


def _port_probs(engine, fx, flip):
    return engine(torch.from_numpy(fx["imgs"]), torch.from_numpy(flip)).numpy()


def _assert_close(got, want, max_lim, mean_lim):
    d = np.abs(got - want)
    assert got.shape == want.shape == (G, 49)
    assert d.max() < max_lim and d.mean() < mean_lim, (d.max(), d.mean())


# each split's conv-land plan and the span GEMM-land starts on (8 x 8
# patches; layer2 has one block here, layers 3 and 4 two each)
SPLIT_PLANS = {
    (1, 0): ([], 8),
    (1, 1): ([(1, 0)], 4),
    (2, 1): ([(1, 0), (2, 0)], 2),
    (3, 0): ([(1, 0), (2, 0), (2, 1)], 2),
    (3, 1): ([(1, 0), (2, 0), (2, 1), (3, 0)], 1),
}


@pytest.mark.parametrize("split", list(SPLIT_PLANS), ids=str)
def test_split_probs_match_jax(fixture, split, monkeypatch):
    """Each split's whole q8dg sweep (flipped batch) against the JAX
    engine's with the same ``gemm_first_stage`` / ``gemm_first_block``, on
    the JAX calibration's scales. (1, 1) starts GEMM-land at layer3 here
    (layer2 has one block), the same trunk as (2, 0) in another plan;
    (2, 1) and (3, 1) start it in the middle of a stage (``first_block``
    1, the seam at the stage's block 0, one more span halving); (3, 0)
    puts layer3 in conv-land with no intra-block sandwiches."""
    monkeypatch.setattr(jqt, "TILE_ALIGN", 32)
    flip = np.asarray([0, 3], np.int32)
    engine = _port_engine(fixture, gemm_first_stage=split[0], gemm_first_block=split[1])
    assert engine.hybrid == (split == (1, 0))
    plan, span = SPLIT_PLANS[split]
    assert engine.plan == plan
    assert engine.metas[0].h_in == span
    _assert_close(_port_probs(engine, fixture, flip),
                  _jax_probs(fixture, flip, gemm_first_stage=split[0],
                             gemm_first_block=split[1]), MAX_DIFF, MEAN_DIFF)


def _expand_value(h2, res, p, m, r, c):
    """The exact (f64) pre-rounding value y / out_scale of block ``m``'s
    expand output at row r, column c (ReLU included)."""
    pix, co = divmod(c, m.c_out)
    acc = int(h2[r, pix * m.c_mid:(pix + 1) * m.c_mid].astype(np.int64)
              @ np.asarray(p["w3"])[:, co].astype(np.int64))
    y = (acc * np.float64(m.s_h2) * np.float64(p["s3"][co]) + np.float64(p["b3"][co])
         + int(res[r, c]) * np.float64(m.s_res))
    return max(y, 0.0) / np.float64(m.s_out)


def test_hybrid_entry_bit_equal(fixture, monkeypatch):
    """q8_backend_forward's hybrid entry (first_h1 / first_res, no xq) on
    shared int8 inputs. Layer2 block 0 skips its reduce and projection: its
    3x3 output and its int8 block output equal the JAX package's, except
    where the exact value sits on a rounding tie (within 1e-5 of a half:
    XLA contracts the interpret-mode epilogue's multiply-adds, the port
    rounds each f32 step, as the card's kernel does); measured: 1 of
    262,144 values, at 46.4999991. The whole trunk through the entry equals
    the trunk from block 1 on that block output."""
    monkeypatch.setattr(jqt, "TILE_ALIGN", 32)
    jp, jm = jqt.build_q8_backend(fixture["jfolded"], fixture["jscales"], 8, 8,
                                  first_stage=1, first_block=0)
    tp = tqt.upload_q8_params(jp, "cpu")
    rng = np.random.default_rng(8)
    h1 = rng.integers(-127, 128, size=(32, 64 * jm[0].c_mid)).astype(np.int8)
    res = rng.integers(-127, 128, size=(32, 16 * jm[0].c_out)).astype(np.int8)
    h1t, rest = torch.from_numpy(h1), torch.from_numpy(res)
    m, p = jm[0], jp[0]
    h2 = tq.q8_conv3_tap(h1t, tp[0]["w2"], tp[0]["b2"], tp[0]["s2"], h_in=8, w_in=8,
                         stride=2, c_in=m.c_mid, in_scale=m.s_h1,
                         out_scale=m.s_h2).numpy()
    np.testing.assert_array_equal(h2, np.asarray(jqt.q8_conv3_tap(
        h1, p["w2"], p["b2"], p["s2"], h_in=8, w_in=8, stride=2, c_in=m.c_mid,
        in_scale=m.s_h1, out_scale=m.s_h2, interpret=True)))
    want = np.asarray(jqt.q8_backend_forward(jp[:1], jm[:1], None, interpret=True,
                                             first_h1=h1, first_res=res))
    got = tqt.q8_backend_forward(tp[:1], jm[:1], None, first_h1=h1t, first_res=rest)
    got = got.numpy()
    off = np.argwhere(got != want)
    assert len(off) <= 1e-5 * got.size, len(off)
    for r, c in off:
        assert abs(int(got[r, c]) - int(want[r, c])) == 1
        v = _expand_value(h2, res, p, m, r, c)
        assert abs(v - np.floor(v) - 0.5) < 1e-5, (r, c, v)
    # the whole trunk through the entry hands block 0's output on unchanged
    full = tqt.q8_backend_forward(tp, jm, None, first_h1=h1t, first_res=rest)
    assert torch.equal(full, tqt.q8_backend_forward(tp[1:], jm[1:], torch.from_numpy(got)))
    with pytest.raises(ValueError, match="together"):
        tqt.q8_backend_forward(tp, jm, None, first_h1=torch.from_numpy(h1))
    with pytest.raises(ValueError, match="projection"):
        tqt.q8_backend_forward(tp[2:], jm[2:], None, first_h1=torch.from_numpy(h1),
                               first_res=torch.from_numpy(res))


def test_unknown_switches_raise(fixture):
    """A split the trunk has not (before layer2, past the last stage, past
    a stage's end, or leaving GEMM-land empty) raises ValueError."""
    for kw in (dict(gemm_first_stage=0), dict(gemm_first_stage=4),
               dict(gemm_first_stage=1, gemm_first_block=2),
               dict(gemm_first_stage=3, gemm_first_block=2)):
        with pytest.raises(ValueError, match="no GEMM split"):
            _port_engine(fixture, **kw)


@pytest.fixture(scope="module")
def resnet50_folded():
    return tie.fold_tile_trunk(build_model("resnet50", device="cpu", seed=0))


@pytest.mark.parametrize("split", list(SPLIT_LAUNCHES), ids=str)
def test_split_launches_and_hopper_fit(resnet50_folded, split):
    """The full-width ResNet-50 q8dg's GEMM-land calls per image batch at
    each split (299/32/20), from its metas (taps /
    whole-tile matmuls / pixel matmuls), and sm90_config takes every call
    at the 32-image batch's M = 7,200 tiles."""
    folded = resnet50_folded
    engine = tie.DenseTileProbs(build_model("resnet50", device="cpu", seed=0), folded,
                                dense_grid_meta(299, 32, 20),
                                _ones_scales(folded, True, tie),
                                gemm_first_stage=split[0], gemm_first_block=split[1])
    calls = []

    def recorder(fn):
        def rec(x, wt, bias, w_scale, **kw):
            calls.append((fn, wt.shape[0], call_segments(fn, x, wt, kw),
                          kw.get("out_kind", "int8"), kw.get("residual") is not None))
            return fn(x, wt, bias, w_scale, **kw)
        return rec

    m0 = engine.metas[0]
    if engine.hybrid:
        entry = dict(xq=None,
                     first_h1=torch.zeros((2, m0.h_in * m0.w_in * m0.c_mid), dtype=torch.int8),
                     first_res=torch.zeros((2, m0.h_out * m0.w_out * m0.c_out),
                                           dtype=torch.int8))
    else:
        entry = dict(xq=torch.zeros((2, m0.h_in * m0.w_in * m0.c_in), dtype=torch.int8))
    with pytest.MonkeyPatch.context() as mp:
        for n in WRAPPERS:
            mp.setattr(tqt, n, recorder(getattr(tq, n)))
        out = tqt.q8_backend_forward(engine.qparams, engine.metas, **entry)
    assert out.shape == (2, 2048)
    kinds = collections.Counter(fn.__name__ for fn, *_ in calls)
    assert (kinds["q8_conv3_tap"], kinds["q8_matmul"], kinds["q8_matmul_px"]) == \
        SPLIT_LAUNCHES[split]
    assert sum(kinds.values()) == sum(SPLIT_LAUNCHES[split])
    for fn, n, segs, out_kind, has_res in calls:
        cfg = tq.sm90_config(M_STEP, n, segs, out_kind, has_res)
        assert cfg.smem <= tq.SM90_SMEM_LIMIT and 2 <= cfg.stages <= tq.SM90_MAX_STAGES
