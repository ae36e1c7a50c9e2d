"""int8 GEMMs with the fused dequant/bias/residual/ReLU/requant epilogue —
the compute primitive of the stage-2 serving trunk (ops/q8_trunk.py).

Four wrappers, each the counterpart of one Pallas TPU kernel of
``cellsegmentation_tpu/ops/q8_gemm.py``, all on the wgmma/TMA core of
``csrc/q8_gemm_sm90.cu`` (see its source notes):

- ``q8_matmul``        <- ``q8_matmul`` (``_mm_kernel``)
- ``q8_matmul_px``     <- ``q8_matmul_px`` (``_bmm_kernel``)
- ``q8_conv3_tap``     <- ``q8_conv3_tap`` (``_tap_kernel``)
- ``q8_conv3_rowtap``  <- ``q8_conv3_rowtap`` (``_rowtap_kernel``)

The core sees every call as a table of K segments per output pixel group
(``KSegments``), which is built here from ``px_groups``, ``tap_table`` and
``rowtap_rows``; its tile shape is chosen here too (``sm90_config``). Both
are passed to its C entry.

Weights are taken TRANSPOSED, ``wt [N, K]`` (K contiguous), which is what
the kernel's B fragments read; the engine transposes the packed ``[K, N]``
weights once when it is built.

Beside each wrapper sits its plain PyTorch version (``*_plain``) with the
same signature and the same integer semantics: exact int32 accumulation,
then the epilogue in f32 with every scalar an explicit f32 tensor:

    y = f32(acc) * (f32(in_scale) * w_scale[col]) + bias[col]
    y = y + f32(res) * f32(res_scale)            (residual, optional)
    y = relu(y)                                   (optional)
    int8: clip(round_half_even(y * f32(1/out_scale)), -127, 127) | bf16: y

A wrapper takes its plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises. Each wrapper counts its launches
in a plain integer attribute ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

_OUT_KINDS = {"int8": (0, torch.int8), "bf16": (1, torch.bfloat16),
              "int32": (2, torch.int32)}
# the wgmma/TMA core (q8_gemm_sm90.cu): 128-row tiles, 128-byte K stages,
# a segment table of at most 64 groups and 512 segments; the constants
# mirror the source's
SM90_BM, SM90_BK = 128, 128
SM90_MAX_STAGES = 6
SM90_MAX_GROUPS, SM90_MAX_SEGS = 64, 512
SM90_SMEM_LIMIT = 232448  # dynamic shared memory a Hopper block may use
H100_SMS = 132
_OUT_BYTES = {"int8": 1, "bf16": 2, "int32": 4}


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _f32(v: float, device) -> torch.Tensor:
    # a Python float rounded once to f32, as JAX's weak-typed scalars are
    return torch.tensor(v, dtype=torch.float32, device=device)


def int_matmul(a: torch.Tensor, bt: torch.Tensor) -> torch.Tensor:
    """Exact int32 ``a [M, K] @ bt[N, K]^T`` of int8 operands. On the card
    the products are summed in f64, which is exact here (|sum| < 2^53)."""
    if a.is_cuda:
        return (a.double() @ bt.double().T).to(torch.int32)
    return a.int() @ bt.int().T


def dequantize_plain(acc, w_scale, bias=None, in_scale=1.0):
    """The epilogue's first step: the int32 accumulator [..., N] in f32
    times ``in_scale * w_scale``, plus ``bias``."""
    y = acc.to(torch.float32) * (_f32(in_scale, acc.device) * w_scale)
    return y if bias is None else y + bias


def epilogue_plain(acc, bias, w_scale, residual=None, out_kind="int8",
                   in_scale=1.0, res_scale=1.0, out_scale=1.0, relu=True):
    """The kernels' shared epilogue on an int32 accumulator [..., N]."""
    if out_kind == "int32":
        return acc
    dev = acc.device
    y = dequantize_plain(acc, w_scale, bias, in_scale)
    if residual is not None:
        y = y + residual.to(torch.float32) * _f32(res_scale, dev)
    if relu:
        y = torch.clamp_min(y, 0.0)
    if out_kind == "int8":
        q = torch.round(y * _f32(1.0 / out_scale, dev))
        return torch.clamp(q, -127, 127).to(torch.int8)
    return y.to(torch.bfloat16)


def q8_matmul_plain(x, wt, bias, w_scale, residual=None, out_kind="int8",
                    in_scale=1.0, res_scale=1.0, out_scale=1.0, relu=True):
    acc = int_matmul(x, wt)
    return epilogue_plain(acc, bias, w_scale, residual, out_kind, in_scale,
                          res_scale, out_scale, relu)


def px_groups(px: int, px_map=None) -> list[int]:
    """Input pixel group read by each output group p (identity, or the
    strided projection's stride*(p//w_out)*w_in + stride*(p%w_out))."""
    if px_map is None:
        return list(range(px))
    stride, w_in, w_out = px_map
    return [stride * (p // w_out) * w_in + stride * (p % w_out)
            for p in range(px)]


def q8_matmul_px_plain(x, wt, bias, w_scale, residual=None, px=1, c_in=0,
                       px_map=None, out_kind="int8", in_scale=1.0,
                       res_scale=1.0, out_scale=1.0, relu=True):
    m = x.shape[0]
    c_in = _px_c_in(x, px, c_in, px_map)
    n = wt.shape[0]
    xg = x.view(m, -1, c_in)[:, px_groups(px, px_map)]  # [M, px, C_in]
    acc = int_matmul(xg.reshape(m * px, c_in), wt).view(m, px, n)
    res = None if residual is None else residual.view(m, px, n)
    out = epilogue_plain(acc, bias, w_scale, res, out_kind, in_scale,
                         res_scale, out_scale, relu)
    return out.reshape(m, px * n)


def tap_table(h_in: int, w_in: int, stride: int):
    """Per output pixel, the in-range (tap, input pixel) pairs of a 3x3
    pad-1 stride-s conv; returns (table, h_out, w_out)."""
    h_out = (h_in - 1) // stride + 1
    w_out = (w_in - 1) // stride + 1
    table = []
    for ho in range(h_out):
        for wo in range(w_out):
            taps = []
            for t in range(9):
                hi = stride * ho + t // 3 - 1
                wi = stride * wo + t % 3 - 1
                if 0 <= hi < h_in and 0 <= wi < w_in:
                    taps.append((t, hi * w_in + wi))
            table.append(taps)
    return table, h_out, w_out


def q8_conv3_tap_plain(x, wt, bias, w_scale, h_in=0, w_in=0, stride=1,
                       c_in=0, out_kind="int8", in_scale=1.0, out_scale=1.0,
                       relu=True):
    m = x.shape[0]
    n = wt.shape[0]
    table, _, _ = tap_table(h_in, w_in, stride)
    xs = x.view(m, h_in * w_in, c_in)
    ws = wt.view(n, 9, c_in)
    accs = []
    for taps in table:  # gather the valid taps of one output pixel: one dot
        t_idx = [t for t, _ in taps]
        g_idx = [gi for _, gi in taps]
        a = xs[:, g_idx].reshape(m, -1)
        b = ws[:, t_idx].reshape(n, -1)
        accs.append(int_matmul(a, b))
    acc = torch.stack(accs, dim=1)  # [M, px_out, N]
    out = epilogue_plain(acc, bias, w_scale, None, out_kind, in_scale, 1.0,
                         out_scale, relu)
    return out.reshape(m, -1)


def rowtap_rows(h_in: int, stride: int) -> list[list[tuple[int, int]]]:
    """Per output row ho, the in-range (dy, input row hi) pairs of a 3x3
    pad-1 stride-s conv, hi = stride*ho + dy - 1."""
    h_out = (h_in - 1) // stride + 1
    return [[(dy, stride * ho + dy - 1) for dy in range(3)
             if 0 <= stride * ho + dy - 1 < h_in] for ho in range(h_out)]


def q8_conv3_rowtap_plain(x, wt, bias, w_scale, h_in=0, w_in=0, stride=1,
                          c_in=0, out_kind="int8", in_scale=1.0,
                          out_scale=1.0, relu=True):
    m = x.shape[0]
    n = wt.shape[0]
    k_row = w_in * c_in
    xs = x.view(m, h_in, k_row)
    ws = wt.view(n, 3, k_row)
    accs = []
    for rows in rowtap_rows(h_in, stride):  # the valid rows of one output row: one dot
        a = xs[:, [hi for _, hi in rows]].reshape(m, -1)
        b = ws[:, [dy for dy, _ in rows]].reshape(n, -1)
        accs.append(int_matmul(a, b))
    acc = torch.stack(accs, dim=1)  # [M, h_out, N]
    out = epilogue_plain(acc, bias, w_scale, None, out_kind, in_scale, 1.0,
                         out_scale, relu)
    return out.reshape(m, -1)


# ---------------------------------------------------------------------------
# the wgmma core's segment tables, tile shape and tile order (mirrors
# q8_gemm_sm90.cu)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class KSegments:
    """One call as the wgmma core sees it: output pixel group p is the sum
    over ``groups[p]``'s segments (a, b) of ``x[:, a : a + k_seg] @
    wt[:, b : b + k_seg]^T``; a, b and ``k_seg`` are bytes (int8 columns).
    The segments of a group are in the plain version's K order."""

    k_seg: int
    groups: tuple  # per output group, a tuple of (a, b) pairs

    @property
    def px(self) -> int:
        return len(self.groups)


@functools.lru_cache(maxsize=None)
def matmul_segments(k: int) -> KSegments:
    return KSegments(k, (((0, 0),),))


@functools.lru_cache(maxsize=None)
def px_segments(px: int, c_in: int, px_map=None) -> KSegments:
    """Group p reads input pixel group g(p) (``px_groups``)."""
    return KSegments(c_in, tuple(((g * c_in, 0),) for g in px_groups(px, px_map)))


@functools.lru_cache(maxsize=None)
def tap_segments(h_in: int, w_in: int, stride: int, c_in: int) -> KSegments:
    """Output pixel p: one segment per in-range tap t at input pixel gi
    (``tap_table``), the pixel's C channels against tap t's weight rows."""
    table, _, _ = tap_table(h_in, w_in, stride)
    return KSegments(c_in, tuple(tuple((gi * c_in, t * c_in) for t, gi in taps)
                                 for taps in table))


@functools.lru_cache(maxsize=None)
def rowtap_segments(h_in: int, w_in: int, stride: int, c_in: int) -> KSegments:
    """Output row ho: one segment per in-range input row hi (``rowtap_rows``),
    the whole row against the dy-th row-Toeplitz weight plane."""
    k_row = w_in * c_in
    return KSegments(k_row, tuple(tuple((hi * k_row, dy * k_row) for dy, hi in rows)
                                  for rows in rowtap_rows(h_in, stride)))


@dataclasses.dataclass(frozen=True)
class Sm90Config:
    """One call's tile shape on the wgmma core: BN output columns by
    ``SM90_BM`` rows per tile, ``stages`` ring stages, ``smem`` bytes of
    dynamic shared memory; tiles number (M tile, pixel group, N tile), and
    a tile of group p runs ``kblocks[p]`` ring stages."""

    bn: int
    stages: int
    m_tiles: int
    px: int
    n_tiles: int
    smem: int
    kblocks: tuple

    @property
    def tiles(self) -> int:
        return self.m_tiles * self.px * self.n_tiles


def sm90_smem(bn: int, stages: int, has_res: bool, out_kind: str) -> int:
    """Shared memory of one block, as the source lays it out: alignment
    slack, the ring, two residual tiles, the output staging, mbarriers."""
    return (1024 + stages * (SM90_BM + bn) * SM90_BK
            + (2 * SM90_BM * bn if has_res else 0)
            + SM90_BM * bn * _OUT_BYTES[out_kind] + 8 * (2 * SM90_MAX_STAGES + 4))


def sm90_stages(bn: int, has_res: bool, out_kind: str) -> int:
    """The longest ring (at most SM90_MAX_STAGES) that fits a block's shared
    memory beside the epilogue's buffers; 0 below two stages."""
    fit = [s for s in range(2, SM90_MAX_STAGES + 1)
           if sm90_smem(bn, s, has_res, out_kind) <= SM90_SMEM_LIMIT]
    return max(fit, default=0)


@functools.lru_cache(maxsize=None)
def sm90_config(m: int, n: int, segs: KSegments, out_kind: str,
                has_res: bool) -> Sm90Config:
    """The wgmma core's tile shape for one call (M rows, N output columns
    per pixel group, the groups' K segments), or ValueError for a call it
    does not take.

    BN = 256 halves the B bytes read from shared memory per operation and
    the epilogue's per-tile overhead; it is taken where its ring holds the
    whole K of the call's longest tile or at least three stages beside the
    epilogue's buffers (fewer expose the loads' latency), else BN = 128.
    The ring takes as many stages as shared memory holds, up to
    SM90_MAX_STAGES."""
    if out_kind not in _OUT_BYTES:
        raise ValueError(f"out_kind must be one of {list(_OUT_BYTES)}")
    k_seg = segs.k_seg
    if m < 1 or k_seg < SM90_BK or k_seg % SM90_BK or n % 128:
        raise ValueError(
            f"the wgmma core needs M >= 1, K % {SM90_BK} == 0 per segment and "
            f"N % 128 == 0, got M={m}, K={k_seg}, N={n}")
    n_segs = sum(len(g) for g in segs.groups)
    if not 1 <= segs.px <= SM90_MAX_GROUPS or n_segs > SM90_MAX_SEGS:
        raise ValueError(
            f"the wgmma core's segment table holds 1..{SM90_MAX_GROUPS} groups "
            f"and {SM90_MAX_SEGS} segments, got {segs.px} and {n_segs}")
    if (not all(segs.groups)
            or any(a % SM90_BK or b % SM90_BK for g in segs.groups for a, b in g)):
        raise ValueError(f"every group needs a segment, each at columns that "
                         f"are multiples of {SM90_BK} bytes")
    kblocks = tuple(len(g) * k_seg // SM90_BK for g in segs.groups)
    bn = 128
    if (n % 256 == 0 and out_kind != "int32"
            and sm90_stages(256, has_res, out_kind) >= min(3, max(kblocks))):
        bn = 256
    stages = sm90_stages(bn, has_res, out_kind)
    if stages < 2:
        raise ValueError("the wgmma core has no ring that fits this call")
    return Sm90Config(bn, stages, -(-m // SM90_BM), segs.px, n // bn,
                      sm90_smem(bn, stages, has_res, out_kind), kblocks)


def sm90_tile_order(cfg: Sm90Config, n_sm: int = H100_SMS):
    """Per CTA of the persistent grid, the (M tile, pixel group, N tile) it
    computes, in order. Tiles t number with N innermost; in round i CTA b
    takes t = i*grid + b for even i and i*grid + grid-1-b for odd i."""
    grid = min(n_sm, cfg.tiles)
    order = []
    for b in range(grid):
        mine = []
        for i in range(-(-cfg.tiles // grid)):
            t = i * grid + (grid - 1 - b if i % 2 else b)
            if t >= cfg.tiles:
                break
            q = t // cfg.n_tiles
            mine.append((q // cfg.px, q % cfg.px, t % cfg.n_tiles))
        order.append(mine)
    return order


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _lib_sm90():
    from cellsegmentation_tpu_torch.kernels import build

    lib = build.load("q8_gemm_sm90.cu")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.q8_gemm_sm90_launch.argtypes = [
        p, p, p, p, p, p, i, i, i, i, i, i, p, p, p, f, f, f, i, i, i, i, p]
    lib.q8_gemm_sm90_launch.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _c_table(segs: KSegments):
    """The segment table as the C entry takes it: int arrays first[px + 1]
    (group p's segments are [first[p], first[p + 1])), seg_a and seg_b."""
    first, seg_a, seg_b = [0], [], []
    for g in segs.groups:
        seg_a += [a for a, _ in g]
        seg_b += [b for _, b in g]
        first.append(len(seg_a))
    return tuple((ctypes.c_int * len(v))(*v) for v in (first, seg_a, seg_b))


def _sm90_run(x, wt, bias, w_scale, residual, out, segs, out_kind, in_scale,
              res_scale, out_scale, relu, bn, stages) -> int:
    """One launch of the wgmma/TMA core into ``out`` at the tile shape (bn,
    stages); returns the C entry's code."""
    first, seg_a, seg_b = _c_table(segs)
    return _lib_sm90().q8_gemm_sm90_launch(
        x.data_ptr(), wt.data_ptr(), bias.data_ptr(), w_scale.data_ptr(),
        _ptr(residual), out.data_ptr(), x.shape[0], wt.shape[0], x.shape[1],
        wt.shape[1], segs.k_seg, segs.px, first, seg_a, seg_b, in_scale,
        res_scale, 1.0 / out_scale, _OUT_KINDS[out_kind][0], int(relu), bn,
        stages, _stream(x),
    )


def _px_c_in(x, px, c_in, px_map):
    if c_in:
        return c_in
    if px_map is not None:
        # a strided map reads stride^2 more input groups than px
        raise ValueError("px_map requires an explicit c_in")
    return x.shape[1] // px


def _check(name, x, wt, bias, w_scale, residual, out_kind):
    if out_kind not in _OUT_KINDS:
        raise ValueError(f"{name}: out_kind must be one of {list(_OUT_KINDS)}")
    dev = x.device
    for t, want, what in ((x, torch.int8, "x"), (wt, torch.int8, "wt"),
                          (bias, torch.float32, "bias"),
                          (w_scale, torch.float32, "w_scale")):
        if t.dtype != want:
            raise TypeError(f"{name}: {what} must be {want}, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name}: {what} is on {t.device}, x on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
    if x.dim() != 2 or wt.dim() != 2:
        raise ValueError(f"{name}: x and wt must be 2-D")
    n = wt.shape[0]
    if bias.shape != (n,) or w_scale.shape != (n,):
        raise ValueError(f"{name}: bias/w_scale must be [{n}]")
    if residual is not None:
        if residual.dtype != torch.int8 or residual.device != dev:
            raise TypeError(f"{name}: residual must be int8 on {dev}")
        if not residual.is_contiguous():
            raise ValueError(f"{name}: residual must be contiguous")
    if dev.type == "cuda":
        for t in (x, wt, bias, w_scale) + (() if residual is None else (residual,)):
            if t.data_ptr() % 16:
                raise ValueError(f"{name}: operands must be 16-byte aligned")
    elif dev.type != "cpu":
        raise ValueError(f"{name}: unsupported device {dev}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _raise_on(name, err):
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _sm90_launch(name, x, wt, bias, w_scale, residual, segs, out_kind,
                 in_scale, res_scale, out_scale, relu):
    """[M, px*N] = one call of the wgmma/TMA core, at sm90_config's shape."""
    m, n = x.shape[0], wt.shape[0]
    cfg = sm90_config(m, n, segs, out_kind, residual is not None)
    out = torch.empty((m, segs.px * n), dtype=_OUT_KINDS[out_kind][1],
                      device=x.device)
    _raise_on(name, _sm90_run(x, wt, bias, w_scale, residual, out, segs,
                              out_kind, in_scale, res_scale, out_scale, relu,
                              cfg.bn, cfg.stages))
    return out


def q8_matmul(x, wt, bias, w_scale, residual=None, out_kind="int8",
              in_scale=1.0, res_scale=1.0, out_scale=1.0, relu=True):
    """epilogue(x_i8 [M, K] @ wt_i8 [N, K]^T) -> [M, N] int8 | bf16 | int32."""
    m, k = x.shape
    _check("q8_matmul", x, wt, bias, w_scale, residual, out_kind)
    if wt.shape[1] != k:
        raise ValueError(f"q8_matmul: wt is {tuple(wt.shape)}, want [N, {k}]")
    if residual is not None and residual.shape != (m, wt.shape[0]):
        raise ValueError(f"q8_matmul: residual must be [{m}, {wt.shape[0]}]")
    if x.device.type == "cpu":
        return q8_matmul_plain(x, wt, bias, w_scale, residual, out_kind,
                               in_scale, res_scale, out_scale, relu)
    out = _sm90_launch("q8_matmul", x, wt, bias, w_scale, residual,
                       matmul_segments(k), out_kind, in_scale, res_scale,
                       out_scale, relu)
    q8_matmul.launches += 1
    return out


def q8_matmul_px(x, wt, bias, w_scale, residual=None, px=1, c_in=0,
                 px_map=None, out_kind="int8", in_scale=1.0, res_scale=1.0,
                 out_scale=1.0, relu=True):
    """Per-pixel 1x1 conv on the whole-tile layout: for each output pixel
    group p, epilogue(x[:, g(p)*c_in : +c_in] @ wt [N', c_in]^T) lands in
    columns [p*N', (p+1)*N') of the [M, px*N'] output."""
    m = x.shape[0]
    c_in = _px_c_in(x, px, c_in, px_map)
    n = wt.shape[0]
    if out_kind == "int32":
        raise ValueError("q8_matmul_px: out_kind must be int8 or bf16")
    _check("q8_matmul_px", x, wt, bias, w_scale, residual, out_kind)
    if wt.shape[1] != c_in or x.shape[1] % c_in:
        raise ValueError(f"q8_matmul_px: wt must be [N', {c_in}] and x [M, px_in*{c_in}]")
    if max(px_groups(px, px_map)) >= x.shape[1] // c_in:
        raise ValueError("q8_matmul_px: px/px_map read past x's pixel groups")
    if residual is not None and residual.shape != (m, px * n):
        raise ValueError(f"q8_matmul_px: residual must be [{m}, {px * n}]")
    if x.device.type == "cpu":
        return q8_matmul_px_plain(x, wt, bias, w_scale, residual, px, c_in,
                                  px_map, out_kind, in_scale, res_scale,
                                  out_scale, relu)
    segs = px_segments(px, c_in, None if px_map is None else tuple(px_map))
    out = _sm90_launch("q8_matmul_px", x, wt, bias, w_scale, residual, segs,
                       out_kind, in_scale, res_scale, out_scale, relu)
    q8_matmul_px.launches += 1
    return out


def q8_conv3_tap(x, wt, bias, w_scale, h_in=0, w_in=0, stride=1, c_in=0,
                 out_kind="int8", in_scale=1.0, out_scale=1.0, relu=True):
    """3x3 pad-1 stride-s conv on the whole-tile layout as 9 shifted
    [M, C] x [C, C'] dots per output pixel (out-of-range taps skipped);
    tap-major ``wt [C', 9*C]``, column (dy*3+dx)*C + ci."""
    if not (h_in and w_in and c_in):
        raise ValueError("q8_conv3_tap: h_in, w_in and c_in are required")
    if out_kind == "int32":
        raise ValueError("q8_conv3_tap: out_kind must be int8 or bf16")
    _check("q8_conv3_tap", x, wt, bias, w_scale, None, out_kind)
    if x.shape[1] != h_in * w_in * c_in or wt.shape[1] != 9 * c_in:
        raise ValueError("q8_conv3_tap: x must be [M, h_in*w_in*c_in] and wt [N, 9*c_in]")
    if x.device.type == "cpu":
        return q8_conv3_tap_plain(x, wt, bias, w_scale, h_in, w_in, stride,
                                  c_in, out_kind, in_scale, out_scale, relu)
    out = _sm90_launch("q8_conv3_tap", x, wt, bias, w_scale, None,
                       tap_segments(h_in, w_in, stride, c_in), out_kind,
                       in_scale, 1.0, out_scale, relu)
    q8_conv3_tap.launches += 1
    return out


def q8_conv3_rowtap(x, wt, bias, w_scale, h_in=0, w_in=0, stride=1, c_in=0,
                    out_kind="int8", in_scale=1.0, out_scale=1.0, relu=True):
    """3x3 pad-1 stride-s conv on the whole-tile layout as one row-Toeplitz
    dot per (output row, in-range dy): input row ``[M, w_in*C]`` against the
    dy-th plane of the dy-major ``wt [w_out*C', 3*w_in*C]`` (column
    ``dy*w_in*C + wi*C + ci``), summed in int32; the output row lands in
    columns ``[ho*N, (ho+1)*N)``, N = w_out*C'."""
    if not (h_in and w_in and c_in):
        raise ValueError("q8_conv3_rowtap: h_in, w_in and c_in are required")
    k_row = w_in * c_in
    if out_kind == "int32":
        raise ValueError("q8_conv3_rowtap: out_kind must be int8 or bf16")
    _check("q8_conv3_rowtap", x, wt, bias, w_scale, None, out_kind)
    if x.shape[1] != h_in * k_row or wt.shape[1] != 3 * k_row:
        raise ValueError("q8_conv3_rowtap: x must be [M, h_in*w_in*c_in] and "
                         "wt [N, 3*w_in*c_in]")
    if wt.shape[0] % ((w_in - 1) // stride + 1):
        raise ValueError("q8_conv3_rowtap: N must be w_out*c_out")
    if x.device.type == "cpu":
        return q8_conv3_rowtap_plain(x, wt, bias, w_scale, h_in, w_in, stride,
                                     c_in, out_kind, in_scale, out_scale, relu)
    out = _sm90_launch("q8_conv3_rowtap", x, wt, bias, w_scale, None,
                       rowtap_segments(h_in, w_in, stride, c_in), out_kind,
                       in_scale, 1.0, out_scale, relu)
    q8_conv3_rowtap.launches += 1
    return out


KERNELS = (q8_matmul, q8_matmul_px, q8_conv3_tap, q8_conv3_rowtap)
PLAIN = {q8_matmul: q8_matmul_plain, q8_matmul_px: q8_matmul_px_plain,
         q8_conv3_tap: q8_conv3_tap_plain,
         q8_conv3_rowtap: q8_conv3_rowtap_plain}
for _fn in KERNELS:
    _fn.launches = 0


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
