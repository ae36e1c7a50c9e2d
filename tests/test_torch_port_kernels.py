"""The port's int8 GEMM kernels (cellsegmentation_tpu_torch/kernels/q8_gemm.py)
held against the JAX package's Pallas kernels (ops/q8_gemm.py) run in
interpret mode, on the same numpy-seeded int8 inputs.

On the CPU each wrapper runs its plain PyTorch version; int32 and int8
outputs must be bit-exact, bf16 within 1 ulp (both sides round one f32 to
bf16 with round-half-even, so they are in fact expected equal; the
row-Toeplitz tests hold bf16 to equality). The CUDA
kernels themselves are held against the same plain versions on the card
(``chip_smoke.py`` and tests/test_torch_port_cuda.py)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cellsegmentation_tpu.ops import q8_gemm as jq
from cellsegmentation_tpu.ops import q8_trunk as jqt
from cellsegmentation_tpu_torch.kernels import q8_gemm as tq


def _ints(rng, shape):
    return rng.integers(-127, 128, size=shape).astype(np.int8)


def _epi_args(rng, n):
    bias = rng.normal(0, 2.0, n).astype(np.float32)
    ws = (rng.random(n) * 0.02 + 1e-3).astype(np.float32)
    return bias, ws


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _assert_same(got: torch.Tensor, want, kind: str):
    want = np.asarray(want)
    if kind == "bf16":
        g = got.float().numpy()
        w = want.astype(np.float32)
        # <= 1 bf16 ulp: 2^-7 relative to the value's binade
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(w), 1e-30))) - 7)
        assert np.all(np.abs(g - w) <= ulp), np.abs(g - w).max()
    else:
        np.testing.assert_array_equal(got.numpy(), want)


SCALES = dict(in_scale=0.0123, res_scale=0.037, out_scale=0.91)


@pytest.mark.parametrize("kind,residual,relu", [
    ("int8", True, True), ("int8", False, False), ("bf16", True, True),
    ("bf16", False, True), ("int32", False, True),
])
def test_q8_matmul_matches_pallas(kind, residual, relu):
    rng = np.random.default_rng(1)
    m, k, n = 40, 256, 128
    x, w = _ints(rng, (m, k)), _ints(rng, (k, n))
    bias, ws = _epi_args(rng, n)
    r = _ints(rng, (m, n)) if residual else None
    want = jq.q8_matmul(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias), jnp.asarray(ws),
        residual=None if r is None else jnp.asarray(r), out_kind=kind,
        relu=relu, bm=8, interpret=True, **SCALES,
    )
    got = tq.q8_matmul(
        _t(x), _t(w.T), _t(bias), _t(ws),
        residual=None if r is None else _t(r), out_kind=kind, relu=relu,
        **SCALES,
    )
    _assert_same(got, want, kind)


@pytest.mark.parametrize("px,px_map,residual,relu,kind", [
    (4, None, False, True, "int8"),
    (4, (2, 4, 2), False, False, "int8"),  # strided projection, 4x4 -> 2x2
    (4, None, True, True, "int8"),  # expand + residual
    (1, None, True, True, "bf16"),  # final expand, bf16 out
    (9, (1, 3, 3), True, False, "bf16"),
])
def test_q8_matmul_px_matches_pallas(px, px_map, residual, relu, kind):
    rng = np.random.default_rng(2)
    m, c_in, n = 24, 128, 128
    px_x = px if px_map is None else px_map[1] ** 2
    x, w = _ints(rng, (m, px_x * c_in)), _ints(rng, (c_in, n))
    bias, ws = _epi_args(rng, n)
    r = _ints(rng, (m, px * n)) if residual else None
    want = jq.q8_matmul_px(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias), jnp.asarray(ws),
        residual=None if r is None else jnp.asarray(r), px=px, c_in=c_in,
        px_map=px_map, out_kind=kind, relu=relu, bm=8, interpret=True,
        **SCALES,
    )
    got = tq.q8_matmul_px(
        _t(x), _t(w.T), _t(bias), _t(ws),
        residual=None if r is None else _t(r), px=px, c_in=c_in,
        px_map=px_map, out_kind=kind, relu=relu, **SCALES,
    )
    _assert_same(got, want, kind)


@pytest.mark.parametrize("hw,stride,kind,relu", [
    (3, 1, "int8", True), (3, 2, "int8", True), (4, 1, "bf16", False),
    (4, 2, "int8", True), (4, 2, "bf16", True),
])
def test_q8_conv3_tap_matches_pallas(hw, stride, kind, relu):
    rng = np.random.default_rng(3)
    m, c, n = 16, 128, 128
    x, w = _ints(rng, (m, hw * hw * c)), _ints(rng, (9 * c, n))
    bias, ws = _epi_args(rng, n)
    kw = dict(h_in=hw, w_in=hw, stride=stride, c_in=c, out_kind=kind,
              in_scale=SCALES["in_scale"], out_scale=SCALES["out_scale"],
              relu=relu)
    want = jq.q8_conv3_tap(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias),
                           jnp.asarray(ws), bm=8, interpret=True, **kw)
    got = tq.q8_conv3_tap(_t(x), _t(w.T), _t(bias), _t(ws), **kw)
    _assert_same(got, want, kind)


ROWTAP_GEOMS = [(2, 8), (1, 4), (2, 4), (1, 2), (2, 2), (1, 1)]


def _conv3_weights(rng, h, stride, c_in, c_out):
    """One folded 3x3 kernel packed in the three forms by the JAX package's
    own packing (tap-major, whole-tile Toeplitz, dy-major row-Toeplitz),
    each with its bias and per-column scales."""
    k2 = rng.normal(size=(3, 3, c_in, c_out)).astype(np.float32)
    b2 = rng.normal(size=(c_out,)).astype(np.float32)
    s2c = jqt._per_channel_scale(k2)
    big, ho, wo = jqt._wholetile_weight(k2, h, h, stride)
    row, wo_r = jqt._rowtap_weight(k2, h, stride)
    assert wo_r == wo
    return {
        "tap": (jqt._quant_w(k2.reshape(9 * c_in, c_out), s2c), b2, s2c),
        "wholetile": (jqt._quant_w(big, np.tile(s2c, ho * wo)),
                      np.tile(b2, ho * wo), np.tile(s2c, ho * wo)),
        "rowtap": (jqt._quant_w(row, np.tile(s2c, wo)), np.tile(b2, wo),
                   np.tile(s2c, wo)),
    }


@pytest.mark.parametrize("kind", ["int8", "bf16"])
@pytest.mark.parametrize("stride,h", ROWTAP_GEOMS)
def test_q8_conv3_rowtap_matches_pallas(stride, h, kind):
    """The row-Toeplitz 3x3 against the Pallas kernel in interpret mode:
    int8 bit-exact, bf16 equal (one f32 rounded once to bf16, RNE, on both
    sides)."""
    rng = np.random.default_rng(8)
    m, c, n = 16, 16, 32
    w, b, ws = _conv3_weights(rng, h, stride, c, n)["rowtap"]
    x = _ints(rng, (m, h * h * c))
    kw = dict(h_in=h, w_in=h, stride=stride, c_in=c, out_kind=kind,
              in_scale=SCALES["in_scale"], out_scale=SCALES["out_scale"])
    want = jq.q8_conv3_rowtap(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                              jnp.asarray(ws), bm=8, interpret=True, **kw)
    got = tq.q8_conv3_rowtap(_t(x), _t(w.T), _t(b), _t(ws), **kw)
    if kind == "bf16":
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want).astype(np.float32))
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kind", ["int8", "bf16"])
@pytest.mark.parametrize("stride,h", ROWTAP_GEOMS)
def test_port_3x3_forms_bit_identical(stride, h, kind):
    """The port's row-Toeplitz, tap and whole-tile plain forms of one 3x3
    accumulate the same int32 products: equal outputs, int8 and bf16."""
    rng = np.random.default_rng(9)
    m, c, n = 16, 16, 32
    forms = _conv3_weights(rng, h, stride, c, n)
    x = _t(_ints(rng, (m, h * h * c)))
    geo = dict(h_in=h, w_in=h, stride=stride, c_in=c)
    epi = dict(out_kind=kind, in_scale=SCALES["in_scale"],
               out_scale=SCALES["out_scale"])

    def args(form):
        w, b, ws = forms[form]
        return x, _t(w.T), _t(b), _t(ws)

    row = tq.q8_conv3_rowtap(*args("rowtap"), **geo, **epi)
    tap = tq.q8_conv3_tap(*args("tap"), **geo, **epi)
    whole = tq.q8_matmul(*args("wholetile"), **epi)
    assert torch.equal(row, tap) and torch.equal(row, whole)


def test_wrappers_reject_bad_inputs():
    x = torch.zeros((8, 128), dtype=torch.int8)
    wt = torch.zeros((128, 128), dtype=torch.int8)
    b = torch.zeros(128)
    with pytest.raises(TypeError):
        tq.q8_matmul(x.float(), wt, b, b)
    with pytest.raises(ValueError):
        tq.q8_matmul(x, wt[:, :64], b, b)  # K mismatch
    with pytest.raises(ValueError):
        tq.q8_matmul(x, wt.t(), b, b)  # not contiguous
    with pytest.raises(ValueError):
        tq.q8_matmul_px(x, wt, b, b, px=1, px_map=(2, 1, 1))  # no c_in
    with pytest.raises(ValueError):
        tq.q8_conv3_tap(x, wt, b, b)  # no geometry
    with pytest.raises(ValueError):
        tq.q8_conv3_rowtap(x, wt, b, b)  # no geometry
    with pytest.raises(ValueError):  # wt must hold 3 row planes
        tq.q8_conv3_rowtap(x, wt, b, b, h_in=1, w_in=1, stride=1, c_in=128)


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    rng = np.random.default_rng(4)
    x, wt = _t(_ints(rng, (8, 128))), _t(_ints(rng, (128, 128)))
    b, ws = (_t(a) for a in _epi_args(rng, 128))
    tq.reset_launch_counts()
    got = tq.q8_matmul(x, wt, b, ws, out_kind="int32")
    assert torch.equal(got, x.int() @ wt.int().T)
    assert all(fn.launches == 0 for fn in tq.KERNELS)
