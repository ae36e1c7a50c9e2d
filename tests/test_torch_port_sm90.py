"""The wgmma/TMA core's host side (cellsegmentation_tpu_torch/kernels): the
tile shape chosen for every GEMM-land call of the full-width ResNet-50 trunk,
the persistent grid's tile order, and the build's rebuild rule.

The kernel itself runs only on the card (tests/test_torch_port_cuda.py and
``chip_smoke.py``); these tests check what the CPU can: the choices the
wrapper hands the C entry and what the source will be rebuilt from."""

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


def _trunk_calls(w2_impl):
    """Every q8_matmul / q8_matmul_px call of the ResNet-50 GEMM trunk
    (layers 3-4 from a 4x4 layer2 map), as (wrapper, m, n, k_seg, px,
    out_kind, has_res), recorded from q8_backend_forward on 2 rows."""
    model = build_model("resnet50", device="cpu", seed=0)
    folded = fold_tile_trunk(model)
    ones = [[1.0] * len(st) for st in folded.stages]
    scales = TrunkScales(block_out=ones, h1=ones, h2=ones, proj=ones)
    params, metas = tqt.build_q8_backend(folded, scales, 4, 4, first_stage=2,
                                         w2_impl=w2_impl)
    qparams = tqt.upload_q8_params(params, "cpu")
    calls = []

    def recorder(fn):
        def rec(x, wt, bias, w_scale, residual=None, px=1, c_in=0, **kw):
            k_seg = c_in or x.shape[1]
            calls.append((fn, wt.shape[0], k_seg, px, kw.get("out_kind", "int8"),
                          residual is not None))
            if fn is tq.q8_matmul:
                return fn(x, wt, bias, w_scale, residual=residual, **kw)
            return fn(x, wt, bias, w_scale, residual=residual, px=px, c_in=c_in, **kw)
        return rec

    orig = (tqt.q8_matmul, tqt.q8_matmul_px)
    tqt.q8_matmul, tqt.q8_matmul_px = recorder(tq.q8_matmul), recorder(tq.q8_matmul_px)
    try:
        xq = torch.zeros((2, 16 * metas[0].c_in), dtype=torch.int8)
        out = tqt.q8_backend_forward(qparams, metas, xq)
    finally:
        tqt.q8_matmul, tqt.q8_matmul_px = orig
    assert out.shape == (2, 2048) and out.dtype == torch.bfloat16
    return calls


@pytest.fixture(scope="module")
def trunk_calls():
    return {impl: _trunk_calls(impl) for impl in tqt.W2_IMPLS}


@pytest.mark.parametrize("w2_impl", tqt.W2_IMPLS)
def test_sm90_config_takes_every_trunk_call(trunk_calls, w2_impl):
    """sm90_config accepts every matmul and px call of the full-width trunk
    at M = 7,200, and each tile shape fits the block's shared memory by its
    own count."""
    calls = trunk_calls[w2_impl]
    kinds = collections.Counter(fn.__name__ for fn, *_ in calls)
    assert kinds == ({"q8_matmul": 8, "q8_matmul_px": 20} if w2_impl == "auto"
                     else {"q8_matmul_px": 20})
    for fn, n, k_seg, px, out_kind, has_res in calls:
        cfg = tq.sm90_config(M_STEP, n, k_seg, px, out_kind, has_res)
        assert cfg.bn in (128, 256) and n % cfg.bn == 0
        assert 2 <= cfg.stages <= tq.SM90_MAX_STAGES
        # BN = 256 only with a ring that holds the whole K segment or 3 stages
        assert cfg.bn == 128 or cfg.stages >= min(3, k_seg // tq.SM90_BK)
        assert cfg.smem == tq.sm90_smem(cfg.bn, cfg.stages, has_res, out_kind)
        assert cfg.smem <= tq.SM90_SMEM_LIMIT
        assert cfg.tiles == -(-M_STEP // tq.SM90_BM) * px * (n // cfg.bn)
        # one more stage would not fit, or the ring is at its longest
        assert (cfg.stages == tq.SM90_MAX_STAGES or tq.sm90_smem(
            cfg.bn, cfg.stages + 1, has_res, out_kind) > tq.SM90_SMEM_LIMIT)


def test_sm90_config_shapes():
    """The rule's choices at the trunk's shapes: BN = 256 where the ring
    holds the whole K segment or three stages beside the epilogue's
    buffers, else 128."""
    # layer3 block0 reduce: 912 tiles of 256, 4 stages
    cfg = tq.sm90_config(M_STEP, 256, 512, 16, "int8", False)
    assert (cfg.bn, cfg.stages, cfg.tiles) == (256, 4, 57 * 16)
    # a layer-3 expand: two residual tiles leave 2 stages at 256, which
    # hold its whole 256-byte K
    cfg = tq.sm90_config(M_STEP, 1024, 256, 4, "int8", True)
    assert (cfg.bn, cfg.stages) == (256, 2)
    # a layer-4 expand: 2 stages would not hold its 512-byte K
    cfg = tq.sm90_config(M_STEP, 2048, 512, 1, "int8", True)
    assert (cfg.bn, cfg.stages) == (128, 5)
    # layer4's 2048-deep matmul: 114 tiles of 256, 4 stages
    cfg = tq.sm90_config(M_STEP, 512, 2048, 1, "int8", False)
    assert (cfg.bn, cfg.stages, cfg.tiles) == (256, 4, 114)
    # the final expand, bf16 out with a residual
    cfg = tq.sm90_config(M_STEP, 2048, 512, 1, "bf16", True)
    assert (cfg.bn, cfg.stages) == (128, 5)
    # int32 out (tests) stays at 128 columns
    assert tq.sm90_config(M_STEP, 1024, 1024, 1, "int32", False).bn == 128
    # a small M gets one tile row
    assert tq.sm90_config(1, 256, 512, 16, "int8", False).m_tiles == 1


@pytest.mark.parametrize("m,n,k_seg,out_kind", [
    (8, 128, 64, "int8"),     # K segment not a whole 128-byte stage
    (8, 64, 128, "int8"),     # N not a whole 128-column tile
    (0, 128, 128, "int8"),    # no rows
    (8, 128, 128, "int4"),    # no such output
])
def test_sm90_config_refuses(m, n, k_seg, out_kind):
    with pytest.raises(ValueError):
        tq.sm90_config(m, n, k_seg, 1, out_kind, False)


@pytest.mark.parametrize("w2_impl", tqt.W2_IMPLS)
@pytest.mark.parametrize("m,n_sm", [(M_STEP, 132), (129, 132), (1, 132), (M_STEP, 7)])
def test_sm90_tile_order_covers_each_tile_once(trunk_calls, w2_impl, m, n_sm):
    """The persistent grid's walk (CTA b takes tiles b, b + grid, ...)
    computes every output tile of every trunk call exactly once, with no
    CTA idle."""
    for fn, n, k_seg, px, out_kind, has_res in trunk_calls[w2_impl]:
        cfg = tq.sm90_config(m, n, k_seg, px, out_kind, has_res)
        order = tq.sm90_tile_order(cfg, n_sm)
        assert len(order) == min(n_sm, cfg.tiles) and all(order)
        seen = collections.Counter(t for cta in order for t in cta)
        want = {(mt, p, nt) for mt in range(cfg.m_tiles) for p in range(px)
                for nt in range(cfg.n_tiles)}
        assert set(seen) == want and set(seen.values()) == {1}


def test_sm90_tile_order_puts_a_slabs_n_tiles_side_by_side():
    """N is innermost: the N' / BN tiles that read one A slab go to
    neighbouring CTAs in the same round, so its re-reads hit L2."""
    cfg = tq.sm90_config(M_STEP, 1024, 512, 4, "int8", False)
    order = tq.sm90_tile_order(cfg)
    first = [cta[0] for cta in order]
    assert cfg.n_tiles == 4
    for b in range(0, len(first) - 3, 4):
        assert {t[:2] for t in first[b:b + 4]} == {first[b][:2]}
        assert [t[2] for t in first[b:b + 4]] == [0, 1, 2, 3]


def test_library_path_hashes_included_headers(tmp_path, monkeypatch):
    """An edit to a header that a source includes changes the library it
    builds to; a header it does not include does not."""
    src = tmp_path / "csrc"
    shutil.copytree(build.CSRC, src)
    (src / "unused.cuh").write_text("// not included\n")
    monkeypatch.setattr(build, "CSRC", src)
    assert build.sources_of("q8_gemm_sm90.cu") == ["q8_gemm_sm90.cu", "q8_epilogue.cuh"]
    assert build.sources_of("q8_gemm.cu") == ["q8_gemm.cu", "q8_epilogue.cuh"]
    before = {s: build.library_path(s) for s in ("q8_gemm.cu", "q8_gemm_sm90.cu")}
    (src / "unused.cuh").write_text("// still not included\n")
    assert {s: build.library_path(s) for s in before} == before
    header = src / "q8_epilogue.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {s: build.library_path(s) for s in before}
    assert all(after[s] != before[s] for s in before)
    assert all(p.name.startswith(f"lib{s.split('.')[0]}_") for s, p in after.items())


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
        tq.sm90_config(5, 40, 96, 1, "int32", False)
