"""The port's CUDA kernels against their plain PyTorch versions, and the
stage-1 train step against its CPU run, on the card.

Marked ``cuda``: without a card these tests skip (the kernels have no CPU
mode). This file imports no JAX, so it runs on a machine with the card:

    python -m pytest --noconftest tests/test_torch_port_cuda.py -q
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from cellsegmentation_tpu_torch.kernels import q8_gemm as tq

SCALES = dict(in_scale=0.0123, res_scale=0.037, out_scale=0.91)
# the row counts at the wgmma core's edges: one row, a consumer's 64 and
# the tile's 128 either side, and the sweep's 32-image batch
EDGE_M = (1, 63, 65, 127, 129, 7200)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    return torch.device("cuda")


def _ints(rng, shape):
    return torch.from_numpy(rng.integers(-127, 128, size=shape).astype(np.int8))


def _epi_args(rng, n):
    bias = torch.from_numpy(rng.normal(0, 2.0, n).astype(np.float32))
    ws = torch.from_numpy((rng.random(n) * 0.02 + 1e-3).astype(np.float32))
    return bias, ws


def _assert_plain(got, want, what):
    assert got.shape == want.shape and got.dtype == want.dtype, what
    if got.dtype == torch.bfloat16:  # within 1 bf16 ulp
        w = want.float()
        ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(1e-30))) - 7)
        assert bool(((got.float() - w).abs() <= ulp).all()), what
    else:
        assert torch.equal(got, want), what


@pytest.mark.cuda
def test_cuda_kernels_match_plain():
    """On the card: every wrapper launches its kernel (counted) and agrees
    with its plain version bit for bit at a trunk-like shape."""
    dev = _card()
    rng = np.random.default_rng(5)
    m, c, n = 450, 256, 256
    x = _ints(rng, (m, 16 * c)).to(dev)
    wt_px = _ints(rng, (n, c)).to(dev)
    wt_tap = _ints(rng, (n, 9 * c)).to(dev)
    wt_mm = _ints(rng, (n, 16 * c)).to(dev)
    # rowtap at layer3 block0's geometry: 4x4 px, stride 2 -> N = 2*c
    wt_row = _ints(rng, (2 * c, 3 * 4 * c)).to(dev)
    b_row, ws_row = (a.to(dev) for a in _epi_args(rng, 2 * c))
    b, ws = (a.to(dev) for a in _epi_args(rng, n))
    r = _ints(rng, (m, 4 * n)).to(dev)
    tq.reset_launch_counts()
    cases = [
        (tq.q8_matmul, (x, wt_mm, b, ws), dict(out_kind="int32")),
        (tq.q8_matmul, (x, wt_mm, b, ws), dict(**SCALES)),
        (tq.q8_matmul_px, (x, wt_px, b, ws),
         dict(residual=r, px=4, c_in=c, px_map=(2, 4, 2), **SCALES)),
        (tq.q8_conv3_tap, (x, wt_tap, b, ws),
         dict(h_in=4, w_in=4, stride=2, c_in=c, out_kind="bf16")),
        (tq.q8_conv3_rowtap, (x, wt_row, b_row, ws_row),
         dict(h_in=4, w_in=4, stride=2, c_in=c, **{k: SCALES[k] for k in
                                                   ("in_scale", "out_scale")})),
        (tq.q8_conv3_rowtap, (x, wt_row, b_row, ws_row),
         dict(h_in=4, w_in=4, stride=1, c_in=c, out_kind="bf16")),
    ]
    for fn, args, kw in cases:
        got = fn(*args, **kw)
        want = tq.PLAIN[fn](*args, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, want), fn.__name__
    assert [f.launches for f in tq.KERNELS] == [2, 1, 1, 2]


def _edge_cases(rng, m, dev):
    """(wrapper, args, kwargs) at the trunk's matmul and px shapes: every
    out_kind with and without residual and ReLU, both px_maps, C = 2048 and
    N' = 2048."""

    def w(n, k):
        b, ws = _epi_args(rng, n)
        return _ints(rng, (n, k)).to(dev), b.to(dev), ws.to(dev)

    x1k = _ints(rng, (m, 1024)).to(dev)
    x16 = _ints(rng, (m, 16 * 512)).to(dev)   # layer3 block0 input, 4x4 x 512
    x4 = _ints(rng, (m, 4 * 1024)).to(dev)    # layer4 block0 input, 2x2 x 1024
    x2k = _ints(rng, (m, 2048)).to(dev)       # layer4 block1 input, 1x1 x 2048
    mm = w(1024, 1024)
    r1k = _ints(rng, (m, 1024)).to(dev)
    cases = [(tq.q8_matmul, (x1k, *mm), dict(out_kind=kind, residual=res,
                                             relu=relu, **SCALES))
             for kind, res, relu in (("int8", None, True), ("int8", r1k, False),
                                     ("bf16", r1k, True), ("bf16", None, False),
                                     ("int32", None, True))]
    cases += [
        (tq.q8_matmul, (x2k, *w(512, 2048)), dict(**SCALES)),
        # layer3 block0: reduce px16, the strided projection (2, 4, 2)
        (tq.q8_matmul_px, (x16, *w(256, 512)), dict(px=16, c_in=512, **SCALES)),
        (tq.q8_matmul_px, (x16, *w(1024, 512)),
         dict(px=4, c_in=512, px_map=(2, 4, 2), relu=False, **SCALES)),
        # an expand with the residual, int8
        (tq.q8_matmul_px, (_ints(rng, (m, 4 * 256)).to(dev), *w(1024, 256)),
         dict(residual=_ints(rng, (m, 4096)).to(dev), px=4, c_in=256, **SCALES)),
        # layer4 block0: the projection (2, 2, 1) to N' = 2048
        (tq.q8_matmul_px, (x4, *w(2048, 1024)),
         dict(px=1, c_in=1024, px_map=(2, 2, 1), relu=False, **SCALES)),
        # C = 2048 reduce; the final expand, bf16 out with the residual
        (tq.q8_matmul_px, (x2k, *w(512, 2048)), dict(px=1, c_in=2048, **SCALES)),
        (tq.q8_matmul_px, (_ints(rng, (m, 512)).to(dev), *w(2048, 512)),
         dict(residual=x2k, px=1, c_in=512, out_kind="bf16", **SCALES)),
        (tq.q8_matmul_px, (_ints(rng, (m, 512)).to(dev), *w(2048, 512)),
         dict(px=1, c_in=512, out_kind="bf16", relu=False, **SCALES)),
    ]
    return cases


@pytest.mark.cuda
@pytest.mark.parametrize("m", EDGE_M)
def test_wgmma_core_edges(m):
    """q8_matmul and q8_matmul_px on the wgmma/TMA core against their plain
    versions (int8/int32 exact, bf16 within 1 ulp) at ragged and full row
    counts; each launch counted."""
    dev = _card()
    rng = np.random.default_rng(100 + m)
    cases = _edge_cases(rng, m, dev)
    tq.reset_launch_counts()
    for fn, args, kw in cases:
        got = fn(*args, **kw)
        want = tq.PLAIN[fn](*args, **kw)
        torch.cuda.synchronize()
        what = f"{fn.__name__} m={m} wt{tuple(args[1].shape)} {kw.get('out_kind', 'int8')}"
        _assert_plain(got, want, what)
    n_mm = sum(fn is tq.q8_matmul for fn, _, _ in cases)
    assert (tq.q8_matmul.launches, tq.q8_matmul_px.launches) == (n_mm, len(cases) - n_mm)


# every 3x3 geometry of the ResNet-50 trunk: (h = w, stride, C); C' = C
TAP_GEOMS = [(4, 2, 256)]                                      # layer3 block0
ROWTAP_GEOMS = [(4, 2, 256), (2, 1, 256), (2, 2, 512), (1, 1, 512)]  # 3.0, 3.1-5, 4.0, 4.1-2


def _conv_cases(rng, m, dev):
    """(wrapper, args, kwargs) of the two 3x3 convs at every trunk geometry:
    the tap with int8 and bf16 out, ReLU on and off; each rowtap geometry
    with int8 + ReLU and bf16 without."""
    epi = {k: SCALES[k] for k in ("in_scale", "out_scale")}

    def operands(h, c, n, k):
        b, ws = _epi_args(rng, n)
        return (_ints(rng, (m, h * h * c)).to(dev), _ints(rng, (n, k)).to(dev),
                b.to(dev), ws.to(dev))

    cases = []
    for h, stride, c in TAP_GEOMS:
        ops = operands(h, c, c, 9 * c)
        cases += [(tq.q8_conv3_tap, ops, dict(h_in=h, w_in=h, stride=stride, c_in=c,
                                             out_kind=kind, relu=relu, **epi))
                  for kind in ("int8", "bf16") for relu in (True, False)]
    for h, stride, c in ROWTAP_GEOMS:
        ops = operands(h, c, ((h - 1) // stride + 1) * c, 3 * h * c)
        cases += [(tq.q8_conv3_rowtap, ops, dict(h_in=h, w_in=h, stride=stride, c_in=c,
                                                out_kind=kind, relu=relu, **epi))
                  for kind, relu in (("int8", True), ("bf16", False))]
    return cases


@pytest.mark.cuda
@pytest.mark.parametrize("m", EDGE_M)
def test_wgmma_core_conv_edges(m):
    """q8_conv3_tap and q8_conv3_rowtap on the wgmma/TMA core (a segment
    table per output pixel or row) against their plain versions at every
    trunk geometry, at ragged and full row counts; each launch counted."""
    dev = _card()
    rng = np.random.default_rng(200 + m)
    cases = _conv_cases(rng, m, dev)
    tq.reset_launch_counts()
    for fn, args, kw in cases:
        got = fn(*args, **kw)
        want = tq.PLAIN[fn](*args, **kw)
        torch.cuda.synchronize()
        _assert_plain(got, want, f"{fn.__name__} m={m} {kw}")
    n_tap = sum(fn is tq.q8_conv3_tap for fn, _, _ in cases)
    assert [f.launches for f in tq.KERNELS] == [0, 0, n_tap, len(cases) - n_tap]


# ResNeXt's calls the ResNet-50 trunk never makes (grouped 3x3s expanded
# block-diagonally, so c_mid is 2-4x ResNet-50's): ResNeXt-101's whole-tile
# Toeplitz 3x3s at K = 8,192 (layer4 block0) and N = 4,096 (layer3, 2x2),
# q8g's 64-group layer2 reduce at 256 -> 512, and its taps at c_mid 512
# (layer2, 8x8 s2 and 4x4) and 1,024 (layer3 block0, 4x4 s2)
RESNEXT_MM = [(8192, 4096), (8192, 2048), (4096, 4096)]  # (K, N)
RESNEXT_TAPS = [(8, 2, 512), (4, 1, 512), (4, 2, 1024)]  # (h = w, stride, C)


@pytest.mark.cuda
@pytest.mark.parametrize("m", (129, 7200))
def test_wgmma_core_resnext_shapes(m):
    """The four kernels' wrappers at ResNeXt's widest call shapes against
    their plain versions (int8 exact, bf16 within 1 ulp); each launch
    counted, none refused."""
    dev = _card()
    rng = np.random.default_rng(300 + m)
    epi = {k: SCALES[k] for k in ("in_scale", "out_scale")}

    def epi_dev(n):
        return tuple(a.to(dev) for a in _epi_args(rng, n))

    cases = []
    for k, n in RESNEXT_MM:
        ops = (_ints(rng, (m, k)).to(dev), _ints(rng, (n, k)).to(dev), *epi_dev(n))
        cases += [(tq.q8_matmul, ops, dict(out_kind=kind, **epi)) for kind in ("int8", "bf16")]
    x = _ints(rng, (m, 64 * 256)).to(dev)
    cases.append((tq.q8_matmul_px, (x, _ints(rng, (512, 256)).to(dev), *epi_dev(512)),
                  dict(px=64, c_in=256, **epi)))
    for h, stride, c in RESNEXT_TAPS:
        ops = (_ints(rng, (m, h * h * c)).to(dev), _ints(rng, (c, 9 * c)).to(dev),
               *epi_dev(c))
        cases.append((tq.q8_conv3_tap, ops, dict(h_in=h, w_in=h, stride=stride, c_in=c,
                                                **epi)))
    tq.reset_launch_counts()
    for fn, args, kw in cases:
        got = fn(*args, **kw)
        want = tq.PLAIN[fn](*args, **kw)
        torch.cuda.synchronize()
        _assert_plain(got, want, f"{fn.__name__} m={m} wt{tuple(args[1].shape)} {kw}")
        del got, want
    assert [f.launches for f in tq.KERNELS] == [2 * len(RESNEXT_MM), 1,
                                                len(RESNEXT_TAPS), 0]


@pytest.mark.cuda
def test_wgmma_core_refuses_what_it_does_not_take():
    """A call outside the core's tile rules raises before any launch."""
    dev = _card()
    rng = np.random.default_rng(7)
    b, ws = (a.to(dev) for a in _epi_args(rng, 128))
    x = _ints(rng, (8, 64)).to(dev)
    tq.reset_launch_counts()
    with pytest.raises(ValueError):  # K = 64: not a whole 128-byte stage
        tq.q8_matmul(x, _ints(rng, (128, 64)).to(dev), b, ws)
    with pytest.raises(ValueError):  # N = 64
        tq.q8_matmul(_ints(rng, (8, 128)).to(dev), _ints(rng, (64, 128)).to(dev),
                     b[:64].clone(), ws[:64].clone())
    with pytest.raises(ValueError):  # C = 64 per pixel group
        tq.q8_matmul_px(_ints(rng, (8, 256)).to(dev), _ints(rng, (128, 64)).to(dev),
                        b, ws, px=4, c_in=64)
    buf = _ints(rng, (8 * 128 + 16,)).to(dev)
    with pytest.raises(ValueError):  # a contiguous x that TMA cannot address
        tq.q8_matmul(buf[1:1 + 8 * 128].view(8, 128), _ints(rng, (128, 128)).to(dev),
                     b, ws)
    with pytest.raises(ValueError):  # tap segments of C = 64 bytes
        tq.q8_conv3_tap(_ints(rng, (8, 16 * 64)).to(dev), _ints(rng, (128, 9 * 64)).to(dev),
                        b, ws, h_in=4, w_in=4, stride=2, c_in=64)
    with pytest.raises(ValueError):  # 100 output pixels: more groups than the table holds
        tq.q8_conv3_tap(_ints(rng, (8, 100 * 128)).to(dev), _ints(rng, (128, 9 * 128)).to(dev),
                        b, ws, h_in=10, w_in=10, stride=1, c_in=128)
    with pytest.raises(ValueError):  # rowtap segments of w_in*C = 64 bytes
        tq.q8_conv3_rowtap(_ints(rng, (8, 64)).to(dev), _ints(rng, (128, 3 * 64)).to(dev),
                           b, ws, h_in=1, w_in=1, stride=1, c_in=64)
    assert all(f.launches == 0 for f in tq.KERNELS)


@pytest.mark.cuda
def test_image_train_step_card_matches_cpu():
    """One f32 stage-1 train step (TF32 off) of a reduced-depth MILNet on 8
    128^2 images, every flip code, under the same injected dropout masks:
    the card against the CPU within chip_smoke.py's [stage1] limits, and
    the three planted faults of that phase rejected."""
    dev = _card()
    import chip_smoke as cs

    from cellsegmentation_tpu_torch.core.dtypes import F32_POLICY
    from cellsegmentation_tpu_torch.models import Bottleneck, MILNet, ResNetEncoder
    from cellsegmentation_tpu_torch.models.milnet import init_milnet

    def model(device):
        m = MILNet(ResNetEncoder(Bottleneck, (1, 1, 1, 1), policy=F32_POLICY),
                   policy=F32_POLICY)
        return init_milnet(m, seed=1).to(device)

    rng = np.random.default_rng(3)
    n = 8
    counts = rng.integers(0, 40, n)
    batch = {"images": rng.integers(0, 256, (n, 128, 128, 3)).astype(np.uint8),
             "flip": (np.arange(n) % 4).astype(np.int32),
             "cls": np.digitize(counts, [1, 6, 11, 21, 51, 201]),
             "reg": counts.astype(np.float32), "valid": np.ones(n, bool)}
    cpu_model = model("cpu")
    gen = torch.Generator().manual_seed(0)
    masks = {k: getattr(cpu_model, k).draw_masks(n, gen)
             for k in ("fc_image_cls", "fc_image_reg")}
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cpu = cs.stage1_step_reading(cpu_model, batch, masks, "cpu")
        card = cs.stage1_step_reading(model(dev), batch, masks, dev)
        assert cs.stage1_gap(card, cpu)[-1], cs.stage1_gap(card, cpu)
        for fault in ("unbiased running variance", "dropout scaled by keep"):
            m = model(dev)
            with cs.planted_stage1_fault(fault, m):
                bad = cs.stage1_step_reading(m, batch, masks, dev)
            assert not cs.stage1_gap(bad, cpu)[-1], (fault, cs.stage1_gap(bad, cpu))
        unflipped = dict(batch, flip=np.zeros(n, np.int32))
        bad = cs.stage1_step_reading(model(dev), unflipped, masks, dev)
        assert not cs.stage1_gap(bad, cpu)[-1], ("flips dropped", cs.stage1_gap(bad, cpu))
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
