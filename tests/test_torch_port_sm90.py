"""The wgmma/TMA core's host side (cellsegmentation_tpu_torch/kernels): the
segment table and tile shape chosen for every GEMM-land call of the
full-width ResNet-50 trunk in both 3x3 forms, the persistent grid's tile
order, and the build's rebuild rule.

The kernel itself runs only on the card (tests/test_torch_port_cuda.py and
``chip_smoke.py``); these tests check what the CPU can: the tables and
choices the wrapper hands the C entry and what the source will be rebuilt
from."""

from __future__ import annotations

import collections
import shutil

import numpy as np
import pytest
import torch

from cellsegmentation_tpu_torch.kernels import build
from cellsegmentation_tpu_torch.kernels import q8_gemm as tq
from cellsegmentation_tpu_torch.models import build_model
from cellsegmentation_tpu_torch.ops import q8_trunk as tqt
from cellsegmentation_tpu_torch.ops.infer_engine import TrunkScales, fold_tile_trunk

from test_torch_port_slice import one_torch_thread  # noqa: F401 (autouse)

# the sweep's image batch of 32 at 299/32/20: 225 tiles an image
M_STEP = 7200
WRAPPERS = ("q8_matmul", "q8_matmul_px", "q8_conv3_tap", "q8_conv3_rowtap")


def call_segments(fn, x, wt, kw):
    """The segment table the wrapper ``fn`` hands the core for this call."""
    if fn is tq.q8_matmul:
        return tq.matmul_segments(x.shape[1])
    if fn is tq.q8_matmul_px:
        return tq.px_segments(kw.get("px", 1), kw.get("c_in") or x.shape[1],
                              kw.get("px_map"))
    geo = (kw["h_in"], kw["w_in"], kw["stride"], kw["c_in"])
    if fn is tq.q8_conv3_tap:
        return tq.tap_segments(*geo)
    return tq.rowtap_segments(*geo)


def _trunk_calls(w2_impl):
    """Every kernel call of the ResNet-50 GEMM trunk (layers 3-4 from a 4x4
    layer2 map), as (wrapper, n, segment table, out_kind, has_res, kwargs),
    recorded from q8_backend_forward on 2 rows."""
    model = build_model("resnet50", device="cpu", seed=0)
    folded = fold_tile_trunk(model)
    ones = [[1.0] * len(st) for st in folded.stages]
    scales = TrunkScales(block_out=ones, h1=ones, h2=ones, proj=ones)
    params, metas = tqt.build_q8_backend(folded, scales, 4, 4, first_stage=2,
                                         w2_impl=w2_impl)
    qparams = tqt.upload_q8_params(params, "cpu")
    calls = []

    def recorder(fn):
        def rec(x, wt, bias, w_scale, **kw):
            calls.append((fn, wt.shape[0], call_segments(fn, x, wt, kw),
                          kw.get("out_kind", "int8"),
                          kw.get("residual") is not None, kw))
            return fn(x, wt, bias, w_scale, **kw)
        return rec

    orig = {n: getattr(tqt, n) for n in WRAPPERS}
    for n in WRAPPERS:
        setattr(tqt, n, recorder(getattr(tq, n)))
    try:
        xq = torch.zeros((2, 16 * metas[0].c_in), dtype=torch.int8)
        out = tqt.q8_backend_forward(qparams, metas, xq)
    finally:
        for n in WRAPPERS:
            setattr(tqt, n, orig[n])
    assert out.shape == (2, 2048) and out.dtype == torch.bfloat16
    return calls


@pytest.fixture(scope="module")
def trunk_calls():
    return {impl: _trunk_calls(impl) for impl in tqt.W2_IMPLS}


@pytest.mark.parametrize("w2_impl", tqt.W2_IMPLS)
def test_sm90_config_takes_every_trunk_call(trunk_calls, w2_impl):
    """sm90_config accepts every call of the full-width trunk at M = 7,200,
    the 3x3 convs included, and each tile shape fits the block's shared
    memory by its own count."""
    calls = trunk_calls[w2_impl]
    kinds = collections.Counter(fn.__name__ for fn, *_ in calls)
    assert kinds == ({"q8_matmul": 8, "q8_matmul_px": 20, "q8_conv3_tap": 1}
                     if w2_impl == "auto"
                     else {"q8_conv3_rowtap": 9, "q8_matmul_px": 20})
    for fn, n, segs, out_kind, has_res, _ in calls:
        cfg = tq.sm90_config(M_STEP, n, segs, out_kind, has_res)
        assert cfg.bn in (128, 256) and n % cfg.bn == 0
        assert 2 <= cfg.stages <= tq.SM90_MAX_STAGES
        assert cfg.kblocks == tuple(len(g) * segs.k_seg // tq.SM90_BK
                                    for g in segs.groups)
        # BN = 256 only with a ring that holds the longest tile's K or 3 stages
        assert cfg.bn == 128 or cfg.stages >= min(3, max(cfg.kblocks))
        assert cfg.smem == tq.sm90_smem(cfg.bn, cfg.stages, has_res, out_kind)
        assert cfg.smem <= tq.SM90_SMEM_LIMIT
        assert cfg.tiles == -(-M_STEP // tq.SM90_BM) * segs.px * (n // cfg.bn)
        # one more stage would not fit, or the ring is at its longest
        assert (cfg.stages == tq.SM90_MAX_STAGES or tq.sm90_smem(
            cfg.bn, cfg.stages + 1, has_res, out_kind) > tq.SM90_SMEM_LIMIT)


def _tap_k_order(h, w, stride, c):
    """The plain tap version's K order, per output pixel: the byte columns
    of x and wt its gathers concatenate, read off tap_table."""
    table, _, _ = tq.tap_table(h, w, stride)
    return [([gi * c + j for _, gi in taps for j in range(c)],
             [t * c + j for t, _ in taps for j in range(c)]) for taps in table]


def _rowtap_k_order(h, w, stride, c):
    k_row = w * c
    return [([hi * k_row + j for _, hi in rows for j in range(k_row)],
             [dy * k_row + j for dy, _ in rows for j in range(k_row)])
            for rows in tq.rowtap_rows(h, stride)]


def _segment_k_order(segs):
    return [([a + j for a, _ in g for j in range(segs.k_seg)],
             [b + j for _, b in g for j in range(segs.k_seg)]) for g in segs.groups]


@pytest.mark.parametrize("w2_impl", tqt.W2_IMPLS)
def test_conv_segment_tables_follow_the_plain_k_order(trunk_calls, w2_impl):
    """Every 3x3 call of the trunk, in both forms: its segment table holds
    one segment per in-range tap (row) of each output pixel (row), read off
    tap_table / rowtap_rows, and walks x's and wt's columns in the plain
    version's K order."""
    convs = [c for c in trunk_calls[w2_impl]
             if c[0] in (tq.q8_conv3_tap, tq.q8_conv3_rowtap)]
    assert len(convs) == (1 if w2_impl == "auto" else 9)
    for fn, n, segs, _, _, kw in convs:
        geo = (kw["h_in"], kw["w_in"], kw["stride"], kw["c_in"])
        if fn is tq.q8_conv3_tap:
            table, h_out, w_out = tq.tap_table(*geo[:3])
            assert segs.k_seg == geo[3] and segs.px == h_out * w_out
            assert [len(g) for g in segs.groups] == [len(t) for t in table]
            assert _segment_k_order(segs) == _tap_k_order(*geo)
        else:
            rows = tq.rowtap_rows(geo[0], geo[2])
            assert segs.k_seg == geo[1] * geo[3] and segs.px == len(rows)
            assert [len(g) for g in segs.groups] == [len(r) for r in rows]
            assert _segment_k_order(segs) == _rowtap_k_order(*geo)


def test_tap_segments_at_layer3_block0():
    """The tap of layer3 block0 (4x4 stride 2, C = 256): its four output
    pixels read 4, 6, 6 and 9 taps, 8, 12, 12 and 18 ring stages."""
    segs = tq.tap_segments(4, 4, 2, 256)
    assert segs.groups[0] == ((0, 4 * 256), (256, 5 * 256), (4 * 256, 7 * 256),
                              (5 * 256, 8 * 256))
    cfg = tq.sm90_config(M_STEP, 256, segs, "int8", False)
    assert cfg.kblocks == (8, 12, 12, 18)
    assert (cfg.bn, cfg.stages, cfg.tiles) == (256, 4, 57 * 4)


def _walk(x, wt, segs):
    """The kernel's accumulation, in Python: group p sums its segments'
    products -> int32 [M, px, N]."""
    k = segs.k_seg
    return torch.stack([sum(tq.int_matmul(x[:, a:a + k].contiguous(),
                                          wt[:, b:b + k].contiguous())
                            for a, b in g) for g in segs.groups], dim=1)


@pytest.mark.parametrize("form,h,stride", [
    ("tap", 8, 1), ("tap", 8, 2), ("tap", 4, 2), ("rowtap", 3, 1),
    ("rowtap", 3, 2), ("rowtap", 4, 2),
])
def test_segment_walk_matches_the_plain_versions(form, h, stride):
    """The segment table walked as the kernel walks it gives the plain
    version's int32 sums, at the trunk's geometries and others (8x8 tap at
    stride 1 and 2, 3x3 rowtap)."""
    rng = np.random.default_rng(11)
    m, c, c_out = 6, 8, 16
    x = torch.from_numpy(rng.integers(-127, 128, (m, h * h * c)).astype(np.int8))
    if form == "tap":
        n, k = c_out, 9 * c
        segs = tq.tap_segments(h, h, stride, c)
        plain = tq.q8_conv3_tap_plain
    else:
        n, k = ((h - 1) // stride + 1) * c_out, 3 * h * c
        segs = tq.rowtap_segments(h, h, stride, c)
        plain = tq.q8_conv3_rowtap_plain
    wt = torch.from_numpy(rng.integers(-127, 128, (n, k)).astype(np.int8))
    # the plain versions' epilogue passes an int32 accumulator through
    want = plain(x, wt, torch.zeros(n), torch.ones(n), h_in=h, w_in=h,
                 stride=stride, c_in=c, out_kind="int32")
    assert torch.equal(_walk(x, wt, segs).reshape(m, -1), want)
    # the core takes the table at the trunk's channel width too
    wide = (tq.tap_segments if form == "tap" else tq.rowtap_segments)(h, h, stride, 256)
    assert tq.sm90_config(M_STEP, 512, wide, "int8", False).px == segs.px


def test_sm90_config_refuses_a_table_that_does_not_fit():
    """More groups or segments than the kernel's parameters hold: refused."""
    with pytest.raises(ValueError):  # 10x10 stride 1: 100 output pixels
        tq.sm90_config(M_STEP, 256, tq.tap_segments(10, 10, 1, 256), "int8", False)
    big = tq.KSegments(128, tuple(((0, 0),) * 9 for _ in range(60)))
    with pytest.raises(ValueError):  # 540 segments
        tq.sm90_config(M_STEP, 256, big, "int8", False)
    with pytest.raises(ValueError):  # a group with no segment
        tq.sm90_config(M_STEP, 256, tq.KSegments(128, (((0, 0),), ())), "int8", False)
    with pytest.raises(ValueError):  # a column off the 128-byte grid
        tq.sm90_config(M_STEP, 256, tq.KSegments(128, (((64, 0),),)), "int8", False)


def test_sm90_config_shapes():
    """The rule's choices at the trunk's shapes: BN = 256 where the ring
    holds the whole K segment or three stages beside the epilogue's
    buffers, else 128."""
    # layer3 block0 reduce: 912 tiles of 256, 4 stages
    cfg = tq.sm90_config(M_STEP, 256, tq.px_segments(16, 512), "int8", False)
    assert (cfg.bn, cfg.stages, cfg.tiles) == (256, 4, 57 * 16)
    # a layer-3 expand: two residual tiles leave 2 stages at 256, which
    # hold its whole 256-byte K
    cfg = tq.sm90_config(M_STEP, 1024, tq.px_segments(4, 256), "int8", True)
    assert (cfg.bn, cfg.stages) == (256, 2)
    # a layer-4 expand: 2 stages would not hold its 512-byte K
    cfg = tq.sm90_config(M_STEP, 2048, tq.px_segments(1, 512), "int8", True)
    assert (cfg.bn, cfg.stages) == (128, 5)
    # layer4's 2048-deep matmul: 114 tiles of 256, 4 stages
    cfg = tq.sm90_config(M_STEP, 512, tq.matmul_segments(2048), "int8", False)
    assert (cfg.bn, cfg.stages, cfg.tiles) == (256, 4, 114)
    # the final expand, bf16 out with a residual
    cfg = tq.sm90_config(M_STEP, 2048, tq.px_segments(1, 512), "bf16", True)
    assert (cfg.bn, cfg.stages) == (128, 5)
    # int32 out (tests) stays at 128 columns
    assert tq.sm90_config(M_STEP, 1024, tq.matmul_segments(1024), "int32",
                          False).bn == 128
    # a small M gets one tile row
    assert tq.sm90_config(1, 256, tq.px_segments(16, 512), "int8",
                          False).m_tiles == 1


@pytest.mark.parametrize("m,n,k_seg,out_kind", [
    (8, 128, 64, "int8"),     # K segment not a whole 128-byte stage
    (8, 64, 128, "int8"),     # N not a whole 128-column tile
    (0, 128, 128, "int8"),    # no rows
    (8, 128, 128, "int4"),    # no such output
])
def test_sm90_config_refuses(m, n, k_seg, out_kind):
    with pytest.raises(ValueError):
        tq.sm90_config(m, n, tq.matmul_segments(k_seg), out_kind, False)


@pytest.mark.parametrize("w2_impl", tqt.W2_IMPLS)
@pytest.mark.parametrize("m,n_sm", [(M_STEP, 132), (129, 132), (1, 132), (M_STEP, 7)])
def test_sm90_tile_order_covers_each_tile_once(trunk_calls, w2_impl, m, n_sm):
    """The persistent grid's snake walk computes every output tile of every
    trunk call, the 3x3 convs included, exactly once, with no CTA idle."""
    for fn, n, segs, out_kind, has_res, _ in trunk_calls[w2_impl]:
        cfg = tq.sm90_config(m, n, segs, out_kind, has_res)
        order = tq.sm90_tile_order(cfg, n_sm)
        assert len(order) == min(n_sm, cfg.tiles) and all(order)
        seen = collections.Counter(t for cta in order for t in cta)
        want = {(mt, p, nt) for mt in range(cfg.m_tiles) for p in range(segs.px)
                for nt in range(cfg.n_tiles)}
        assert set(seen) == want and set(seen.values()) == {1}


@pytest.mark.parametrize("segs,n,most", [
    # layer3 block0's tap: 228 tiles of 8, 12, 12 or 18 stages; two tiles
    # on a CTA cannot carry fewer than 18 + 8
    (tq.tap_segments(4, 4, 2, 256), 256, 26),
    # its row-Toeplitz form: output rows of 16 and 24 stages, 2 N tiles
    (tq.rowtap_segments(4, 4, 2, 256), 512, 40),
])
def test_sm90_tile_order_balances_uneven_groups(segs, n, most):
    """The snake gives a CTA that drew a heavy pixel group a light one next:
    no CTA carries more ring stages than the best split into whole tiles."""
    cfg = tq.sm90_config(M_STEP, n, segs, "int8", False)
    per_cta = [sum(cfg.kblocks[p] for _, p, _ in cta)
               for cta in tq.sm90_tile_order(cfg)]
    assert max(per_cta) == most
    assert max(per_cta) < 1.25 * sum(per_cta) / len(per_cta)


def test_sm90_tile_order_puts_a_slabs_n_tiles_side_by_side():
    """N is innermost: the N' / BN tiles that read one A slab go to
    neighbouring CTAs in the same round, so its re-reads hit L2."""
    cfg = tq.sm90_config(M_STEP, 1024, tq.px_segments(4, 512), "int8", False)
    order = tq.sm90_tile_order(cfg)
    first = [cta[0] for cta in order]
    assert cfg.n_tiles == 4
    for b in range(0, len(first) - 3, 4):
        assert {t[:2] for t in first[b:b + 4]} == {first[b][:2]}
        assert [t[2] for t in first[b:b + 4]] == [0, 1, 2, 3]


def test_library_path_hashes_included_headers(tmp_path, monkeypatch):
    """An edit to a header that the source includes changes the library it
    builds to; a header it does not include does not."""
    src = tmp_path / "csrc"
    shutil.copytree(build.CSRC, src)
    (src / "unused.cuh").write_text("// not included\n")
    monkeypatch.setattr(build, "CSRC", src)
    assert sorted(p.name for p in src.glob("*.cu")) == ["q8_gemm_sm90.cu"]
    assert build.sources_of("q8_gemm_sm90.cu") == ["q8_gemm_sm90.cu", "q8_epilogue.cuh"]
    before = build.library_path("q8_gemm_sm90.cu")
    (src / "unused.cuh").write_text("// still not included\n")
    assert build.library_path("q8_gemm_sm90.cu") == before
    header = src / "q8_epilogue.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = build.library_path("q8_gemm_sm90.cu")
    assert after != before and after.name.startswith("libq8_gemm_sm90_")


def test_sources_of_follows_nested_includes(tmp_path, monkeypatch):
    (tmp_path / "a.cu").write_text('#include <stdint.h>\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text('#pragma once\n  #  include "c.cuh"\n')
    (tmp_path / "c.cuh").write_text('#include "b.cuh"\n#include "missing.h"\n')
    monkeypatch.setattr(build, "CSRC", tmp_path)
    assert build.sources_of("a.cu") == ["a.cu", "b.cuh", "c.cuh"]
    before = build.library_path("a.cu")
    (tmp_path / "c.cuh").write_text('#include "b.cuh"\n// edited\n')
    assert build.library_path("a.cu") != before


def test_cpu_calls_check_no_core_rules():
    """On the CPU the wrappers take their plain versions at any shape; the
    cores' tile rules apply to CUDA tensors only."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.integers(-127, 128, (5, 96)).astype(np.int8))
    wt = torch.from_numpy(rng.integers(-127, 128, (40, 96)).astype(np.int8))
    b, ws = torch.zeros(40), torch.ones(40)
    got = tq.q8_matmul(x, wt, b, ws, out_kind="int32")
    assert torch.equal(got, x.int() @ wt.int().T)
    with pytest.raises(ValueError):
        tq.sm90_config(5, 40, tq.matmul_segments(96), "int32", False)
