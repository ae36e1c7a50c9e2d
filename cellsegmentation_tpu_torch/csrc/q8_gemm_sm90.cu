// int8 GEMMs of the stage-2 serving trunk on Hopper's wgmma/TMA core (sm_90a).
//
// Replaces the four Pallas TPU kernels of cellsegmentation_tpu/ops/q8_gemm.py
// through one entry point, q8_gemm_sm90_launch. Every call is a list of
// output pixel groups; group p sums the products of its K segments, each a
// pair (A column, B column) of k_seg bytes, into columns [p*N, (p+1)*N):
//   q8_matmul       / _mm_kernel     - the whole-tile Toeplitz 3x3 of layer3
//                                      blocks 1-5 and layer4: one group, one
//                                      segment (0, 0) of K bytes;
//   q8_matmul_px    / _bmm_kernel    - every layer-3/4 1x1 (reduce, strided
//                                      projection, expand with the residual
//                                      fused): one segment (g(p)*C, 0) of C;
//   q8_conv3_tap    / _tap_kernel    - the 3x3 of layer3 block0: one segment
//                                      ((hi*w_in + wi)*C, t*C) of C per
//                                      in-range tap t of output pixel p;
//   q8_conv3_rowtap / _rowtap_kernel - every layer-3/4 3x3 as row-Toeplitz
//                                      dots: one segment (hi*w_in*C,
//                                      dy*w_in*C) of w_in*C per in-range input
//                                      row hi = stride*ho + dy - 1 of output
//                                      row p = ho; bias and scale come tiled
//                                      over wo, so the epilogue is the same.
// The TPU kernels walk the taps or rows on a sequential grid axis with the
// int32 sum in scratch memory; here they are the tile's K loop, and
// out-of-range taps and rows are never loaded.
//
// What bounds them on the H100 (1979 TOP/s int8, 3.35 TB/s: ridge 590 op/B).
// At M = 7,200 tile rows the reduces and expands move 1 byte per 100-500
// operations (the expands read a residual and write as many bytes as the
// reduces read): bytes bound them. The matmuls, the 2048-wide projection and
// the 3x3 convs on 2x2 and larger maps do 600-4,000 operations per byte:
// operations bound them. The row-Toeplitz 3x3 on layer4's 1x1 map (about
// 490) is bound by bytes.
//
// Design:
// - Instruction. wgmma.mma_async m64nNk32 s32.s8.s8 with both operands read
//   from shared memory by descriptor: no fragment loads through registers.
//   8-bit wgmma takes K-major operands only; A is x[M, K] and B is wt[N, K]
//   (the engine transposes each weight once), both K-major already.
// - Warp roles. Warpgroups 0-1 consume, each owning 64 rows of a BM = 128
//   tile; one thread of warpgroup 2 produces. setmaxnreg moves registers
//   from the producer warpgroup (40) to the consumers (232): a BN = 256
//   tile holds 128 int32 accumulators a thread.
// - Ring. TMA loads a (128 x 128-byte) A tile and a (BN x 128-byte) B tile per
//   stage with the 128-byte swizzle into an mbarrier-guarded ring of 2-6
//   stages (as many as shared memory holds beside the epilogue's buffers).
//   The wgmma descriptors name the same swizzle; each k32 step advances the
//   descriptor's start address by 32 bytes inside the 1024-byte swizzle atom.
// - Segments. The producer walks the tile's segments and each segment's
//   128-byte stages; a segment's columns are only TMA coordinates. The ring
//   runs on across segments and tiles, so a 256-byte tap segment costs no
//   more than two stages of one long K. The consumers count the tile's
//   k-blocks (segments x stages per segment) from the same table, and only
//   the tile's first k-block overwrites the accumulator. The host builds
//   the table (kernels/q8_gemm.py); it travels in the kernel's parameters
//   (__grid_constant__, so an indexed read does not copy it to the stack),
//   at most MAX_GROUPS groups and MAX_SEGS segments, 2.3 KB.
// - Persistent grid. One CTA per SM walks output tiles; the producer runs
//   ahead into the next tile's stages while the consumers run the epilogue.
//   Tiles are numbered with N innermost, then the pixel group, then M: the
//   N' / BN tiles that read one A slab run on neighbouring CTAs at the same
//   time, so A comes from device memory once and its re-reads hit L2. CTA b
//   takes tile i*grid + b in even rounds i and i*grid + grid-1-b in odd
//   ones (a snake): the groups of a conv carry unequal K (the tap's four
//   output pixels 8, 12, 12 and 18 stages), and the snake gives the CTA
//   that drew a heavy group of one M tile a light group of another next.
// - Epilogue. The accumulator fragment (rows 16*warp + lane/4 (+8), columns
//   8j + 2*(lane%4) (+1)) goes through q8_epilogue.cuh in registers, is staged
//   as int8, bf16 or int32 in shared memory in the TMA store's 128-byte
//   swizzle (conflict-free), and leaves by TMA store, one 64-row box per
//   consumer per 128-byte column span. The producer loads the residual tile
//   by TMA into one of two buffers during the main loop. TMA zero-fills
//   rows >= M on load and clips them on store, which replaces the masking.
//   The epilogue is the short-K calls' main cost: its code is specialised
//   on (residual, ReLU) outside the column loop, the residual is read ahead
//   of its arithmetic in batches, and neither the residual's int8 -> f32
//   nor the requant goes through the conversion unit (q8_epilogue.cuh).
// The tile shape (BN, stages) is chosen by the caller (kernels/q8_gemm.py,
// sm90_config) and checked here.

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes through the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "q8_epilogue.cuh"

namespace {

constexpr int BM = 128;             // tile rows: two consumer warpgroups x 64
constexpr int BK = 128;             // bytes of K per ring stage: one swizzle span
constexpr int MAX_STAGES = 6;
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory a block may use
constexpr int THREADS = 384;        // consumer warpgroups 0-1, producer warpgroup 2
constexpr int A_BYTES = BM * BK;
constexpr int SPAN = 64 * 128;      // one consumer's 64 rows of a 128-byte column span
constexpr int MAX_GROUPS = 64;      // output pixel groups of one call
constexpr int MAX_SEGS = 512;       // K segments of one call, all groups together

struct Args {
  const float* bias;    // [N]
  const float* wscale;  // [N]
  int M, N;             // rows; output columns of one pixel group
  int kblocks;          // one K segment / BK
  int groups, n_tiles, tiles;
  int has_res, relu, stages;
  float in_scale, res_scale, inv_out;
  // The segment table: group p sums segments [first[p], first[p + 1]);
  // segment s reads A columns from BK * (seg[s] & 0xFFFF) and B columns from
  // BK * (seg[s] >> 16), k_seg = kblocks * BK bytes of each.
  uint16_t first[MAX_GROUPS + 1];
  uint32_t seg[MAX_SEGS];
};

__host__ __device__ constexpr int out_bytes(int out) {
  return out == OUT_INT8 ? 1 : (out == OUT_BF16 ? 2 : 4);
}

// Shared memory, from a 1024-aligned base: the ring, two residual tiles (with
// a residual), the two consumers' output staging, then the mbarriers.
__host__ __device__ inline int ring_bytes(int bn, int stages) { return stages * (A_BYTES + bn * BK); }
__host__ __device__ inline int res_bytes(int bn, int has_res) { return has_res ? 2 * BM * bn : 0; }
__host__ __device__ inline int smem_bytes(int bn, int stages, int has_res, int out) {
  return 1024 + ring_bytes(bn, stages) + res_bytes(bn, has_res) + BM * bn * out_bytes(out) +
         8 * (2 * MAX_STAGES + 4);
}

__device__ __forceinline__ uint32_t full_bar(uint32_t bars, int s) { return bars + 8 * s; }
__device__ __forceinline__ uint32_t empty_bar(uint32_t bars, int s) { return bars + 8 * (MAX_STAGES + s); }
__device__ __forceinline__ uint32_t rfull_bar(uint32_t bars, int i) { return bars + 8 * (2 * MAX_STAGES + i); }
__device__ __forceinline__ uint32_t rempty_bar(uint32_t bars, int i) { return bars + 8 * (2 * MAX_STAGES + 2 + i); }

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                         int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(src), "r"(c0), "r"(c1)
               : "memory");
}

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// This CTA's i-th output tile, in the snake over the grid; false past the last.
__device__ __forceinline__ bool tile_at(const Args& a, int i, int bn, int& m0, int& p, int& n0) {
  const int b = (i & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int t = i * gridDim.x + b;
  if (t >= a.tiles) return false;
  n0 = (t % a.n_tiles) * bn;
  const int q = t / a.n_tiles;
  p = q % a.groups;
  m0 = (q / a.groups) * BM;
  return true;
}

// K-major operand tile in 128-byte swizzle: rows of 128 bytes, 8-row atoms of
// 1024 bytes (the stride byte offset); the leading offset is unused.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

// Byte b (0..127) of row r of a box staged with the 128-byte swizzle.
__device__ __forceinline__ uint32_t swz(uint32_t span, int r, int b) {
  return span + r * 128 + ((((b >> 4) ^ r) & 7) << 4) + (b & 15);
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (the 64 x BN s32 fragment) += A (64 x 32 bytes) . B (BN x 32 bytes)^T,
// both by descriptor; scale_d = 0 overwrites d instead.
template <int BN>
__device__ __forceinline__ void wgmma_s8(uint32_t* d, uint64_t da, uint64_t db, int scale_d);

template <>
__device__ __forceinline__ void wgmma_s8<128>(uint32_t* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8<256>(uint32_t* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

// One consumer's 64 x BN output tile from its accumulator fragment: the
// epilogue in registers, staged for the TMA store. The thread's row and
// column (wr, tc) sit at one of eight swizzled places in each 16-byte chunk
// of a 128-byte span, worked out once (off); every other offset is a
// constant, so each shared-memory access is one register plus an
// immediate. The residual (rows of the tile at rrow) is read four n8 column
// groups at a time ahead of their arithmetic; rrow and stg do not alias,
// so the loads of later groups can move ahead of earlier stores.
template <int BN, int OUT, bool RES, bool RELU>
__device__ __forceinline__ void epilogue_tile(const uint32_t* acc, const Args& a, int n0,
                                              const uint8_t* __restrict__ rrow,
                                              uint8_t* __restrict__ stg, uint32_t stg_addr,
                                              int wr, int tc) {
  constexpr int CHUNK = 4;
  const int cb = OUT == OUT_BF16 ? 2 * tc : tc;  // the thread's first byte in its chunk
  int off[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) off[c] = wr * 128 + (((c ^ wr) & 7) << 4);
#pragma unroll
  for (int j0 = 0; j0 < BN / 8; j0 += CHUNK) {
    uint16_t rv[CHUNK][2];
    if (RES) {
#pragma unroll
      for (int jj = 0; jj < CHUNK; ++jj) {
        const int j = j0 + jj;
#pragma unroll
        for (int h = 0; h < 2; ++h)
          rv[jj][h] = *reinterpret_cast<const uint16_t*>(
              rrow + (j >> 4) * BM * 128 + off[(j >> 1) & 7] + tc + 8 * (j & 1) + 1024 * h);
      }
    }
#pragma unroll
    for (int jj = 0; jj < CHUNK; ++jj) {
      const int j = j0 + jj;
      const int col = 8 * j + tc;
      const float2 ws = __ldg(reinterpret_cast<const float2*>(a.wscale + n0 + col));
      const float2 bb = __ldg(reinterpret_cast<const float2*>(a.bias + n0 + col));
      const float s0 = __fmul_rn(a.in_scale, ws.x);
      const float s1 = __fmul_rn(a.in_scale, ws.y);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int v0 = static_cast<int>(acc[4 * j + 2 * h]);
        const int v1 = static_cast<int>(acc[4 * j + 2 * h + 1]);
        if (OUT == OUT_INT32) {
          asm volatile("st.shared.v2.u32 [%0], {%1, %2};\n" ::"r"(
                           swz(stg_addr + (col >> 5) * SPAN, wr + 8 * h, (col * 4) & 127)),
                       "r"(v0), "r"(v1));
          continue;
        }
        const float2 x = RES ? q8_int8x2_to_float(rv[jj][h]) : make_float2(0.0f, 0.0f);
        const float y0 = q8_epilogue_scaled(v0, s0, bb.x, x.x, RES, a.res_scale, RELU);
        const float y1 = q8_epilogue_scaled(v1, s1, bb.y, x.y, RES, a.res_scale, RELU);
        if (OUT == OUT_INT8) {
          *reinterpret_cast<uint16_t*>(stg + (j >> 4) * SPAN + off[(j >> 1) & 7] + cb +
                                       8 * (j & 1) + 1024 * h) =
              q8_requant2<RELU>(y0, y1, a.inv_out);
        } else {  // bf16: two bytes a column, a 16-byte chunk per n8 group
          *reinterpret_cast<__nv_bfloat162*>(stg + (j >> 3) * SPAN + off[j & 7] + cb +
                                             1024 * h) = __floats2bfloat162_rn(y0, y1);
        }
      }
    }
  }
}

template <int BN, int OUT>
__global__ void __launch_bounds__(THREADS, 1)
    q8_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
                    const __grid_constant__ CUtensorMap tm_res,
                    const __grid_constant__ CUtensorMap tm_out, const __grid_constant__ Args a) {
  constexpr int OB = out_bytes(OUT);
  constexpr int STAGE = A_BYTES + BN * BK;
  constexpr int OUT_SPANS = BN * OB / 128;  // 128-byte column spans of an output tile
  constexpr int OUT_COLS = 128 / OB;        // output columns in one span
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t ring = base;
  const uint32_t res = ring + a.stages * STAGE;
  const uint32_t stg = res + res_bytes(BN, a.has_res);
  const uint32_t bars = stg + BM * BN * OB;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wg = warp >> 2;

  if (tid == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(full_bar(bars, s), 1);
      mbar_init(empty_bar(bars, s), 8);  // one arrival per consumer warp
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(rfull_bar(bars, i), 1);
      mbar_init(rempty_bar(bars, i), 8);  // free once every consumer warp has read it
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {  // producer: one thread issues every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp == 8 && lane == 0) {
      int stage = 0, rb = 0;
      uint32_t phase = 0, rphase = 0;
      int m0, p, n0;
      for (int i = 0; tile_at(a, i, BN, m0, p, n0); ++i) {
        for (int s = a.first[p]; s < a.first[p + 1]; ++s) {
          const int ac = static_cast<int>(a.seg[s] & 0xFFFFu) * BK;
          const int bc = static_cast<int>(a.seg[s] >> 16) * BK;
          for (int kb = 0; kb < a.kblocks; ++kb) {
            mbar_wait(empty_bar(bars, stage), phase ^ 1);
            const uint32_t fb = full_bar(bars, stage);
            const uint32_t dst = ring + stage * STAGE;
            mbar_expect_tx(fb, STAGE);
            tma_load(dst, &tm_x, fb, ac + kb * BK, m0);
            tma_load(dst + A_BYTES, &tm_w, fb, bc + kb * BK, n0);
            if (++stage == a.stages) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
        if (a.has_res) {
          mbar_wait(rempty_bar(bars, rb), rphase ^ 1);
          const uint32_t fb = rfull_bar(bars, rb);
          mbar_expect_tx(fb, BM * BN);
          for (int s = 0; s < BN / 128; ++s)
            tma_load(res + rb * BM * BN + s * BM * 128, &tm_res, fb, p * a.N + n0 + s * 128, m0);
          if (++rb == 2) {
            rb = 0;
            rphase ^= 1;
          }
        }
      }
    }
  } else {  // consumers: warpgroup wg owns rows [64*wg, 64*wg + 64) of each tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    int stage = 0, rb = 0;
    uint32_t phase = 0, rphase = 0;
    const int wr = 16 * (warp & 3) + (lane >> 2);  // fragment row (and +8) in the 64
    const int tc = 2 * (lane & 3);                 // fragment column (and +1) in each n8
    const uint32_t my_stg = stg + wg * (BM / 2) * BN * OB;
    uint32_t acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;

    int m0, p, n0;
    for (int i = 0; tile_at(a, i, BN, m0, p, n0); ++i) {
      // the producer loads this many k-blocks for the tile, in this order
      const int nk = (a.first[p + 1] - a.first[p]) * a.kblocks;
      fence_regs<BN / 2>(acc);
      int prev = 0;
      for (int kb = 0; kb < nk; ++kb) {
        mbar_wait(full_bar(bars, stage), phase);
        const uint32_t sa = ring + stage * STAGE + wg * (BM / 2) * BK;
        const uint32_t sb = ring + stage * STAGE + A_BYTES;
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int kk = 0; kk < BK / 32; ++kk)
          wgmma_s8<BN>(acc, sw128_desc(sa + 32 * kk), sw128_desc(sb + 32 * kk), (kb | kk) != 0);
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        // the previous k-block's products are done: release its stage
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        if (kb > 0 && lane == 0) mbar_arrive(empty_bar(bars, prev));
        prev = stage;
        if (++stage == a.stages) {
          stage = 0;
          phase ^= 1;
        }
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_regs<BN / 2>(acc);
      if (lane == 0) mbar_arrive(empty_bar(bars, prev));

      // epilogue: the previous tile's store must have read the staging buffer
      if ((tid & 127) == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      named_sync(1 + wg);
      uint32_t rtile = 0;
      if (a.has_res) {
        mbar_wait(rfull_bar(bars, rb), rphase);
        rtile = res + rb * BM * BN;
      }
      // the same places as generic pointers into shared memory
      const uint8_t* rrow = smem_raw + (rtile + wg * (BM / 2) * 128 - raw);
      uint8_t* sp = smem_raw + (my_stg - raw);
      if (a.has_res) {
        if (a.relu) epilogue_tile<BN, OUT, true, true>(acc, a, n0, rrow, sp, my_stg, wr, tc);
        else epilogue_tile<BN, OUT, true, false>(acc, a, n0, rrow, sp, my_stg, wr, tc);
      } else {
        if (a.relu) epilogue_tile<BN, OUT, false, true>(acc, a, n0, rrow, sp, my_stg, wr, tc);
        else epilogue_tile<BN, OUT, false, false>(acc, a, n0, rrow, sp, my_stg, wr, tc);
      }
      if (a.has_res) {  // this warp is done with the residual tile
        __syncwarp();
        if (lane == 0) mbar_arrive(rempty_bar(bars, rb));
        if (++rb == 2) {
          rb = 0;
          rphase ^= 1;
        }
      }
      // make the staged tile visible to the TMA unit, then store it
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      named_sync(1 + wg);
      if ((tid & 127) == 0 && m0 + 64 * wg < a.M) {
#pragma unroll
        for (int s = 0; s < OUT_SPANS; ++s)
          tma_store(&tm_out, my_stg + s * SPAN, p * a.N + n0 + s * OUT_COLS, m0 + 64 * wg);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
    }
    if ((tid & 127) == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API function: take it through the
// runtime, so the library needs no -lcuda.
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault,
                                         &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      f = nullptr;
    return reinterpret_cast<EncodeTiled>(f);
  }();
  return fn;
}

int sm_count() {
  static const int n = [] {
    int dev = 0, v = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    return v;
  }();
  return n;
}

// A row-major [rows, cols] tensor read or written in (box_rows x box_cols)
// boxes with the 128-byte swizzle; out-of-range rows load as zeros.
bool make_map(CUtensorMap* m, const void* ptr, CUtensorMapDataType type, int elem, int cols,
              int rows, int box_cols, int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t estr[2] = {1, 1};
  return encoder()(m, type, 2, const_cast<void*>(ptr), dims, strides, box, estr,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN, int OUT>
int launch(const CUtensorMap& mx, const CUtensorMap& mw, const CUtensorMap& mr,
           const CUtensorMap& mo, const Args& a, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      q8_wgmma_kernel<BN, OUT>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int grid = a.tiles < sm_count() ? a.tiles : sm_count();
  q8_wgmma_kernel<BN, OUT><<<grid, THREADS, smem_bytes(BN, a.stages, a.has_res, OUT), stream>>>(
      mx, mw, mr, mo, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// out[M, groups*N] group p = epilogue(sum over s in [first[p], first[p+1]) of
// x[:, seg_a[s] : +k_seg] @ wt[:, seg_b[s] : +k_seg]^T), x [M, lda] and wt
// [N, ldw] row-major; the columns are bytes. The tile shape (bn, stages)
// comes from the caller. Returns 0, a cudaError_t, or -1 (a tile shape or
// segment table this core refuses), -2 (no cuTensorMapEncodeTiled), -3 (a
// tensor map refused: alignment or strides).
int q8_gemm_sm90_launch(const void* x, const void* wt, const void* bias, const void* wscale,
                        const void* res, void* out, int M, int N, int lda, int ldw, int k_seg,
                        int groups, const int* first, const int* seg_a, const int* seg_b,
                        float in_scale, float res_scale, float inv_out, int out_kind, int relu,
                        int bn, int stages, void* stream) {
  const int has_res = res != nullptr;
  if ((bn != 128 && bn != 256) || (bn == 256 && out_kind == OUT_INT32) || out_kind < 0 ||
      out_kind > 2 || stages < 2 || stages > MAX_STAGES || M < 1 || groups < 1 ||
      groups > MAX_GROUPS || k_seg < BK || k_seg % BK || N % bn || lda > 0xFFFF * BK ||
      ldw > 0xFFFF * BK || smem_bytes(bn, stages, has_res, out_kind) > SMEM_LIMIT ||
      first[0] != 0 || first[groups] > MAX_SEGS)
    return -1;
  Args a = {};
  for (int p = 0; p <= groups; ++p) {
    if (p < groups && first[p + 1] <= first[p]) return -1;  // every group has a segment
    a.first[p] = static_cast<uint16_t>(first[p]);
  }
  for (int s = 0; s < first[groups]; ++s) {
    if (seg_a[s] < 0 || seg_a[s] % BK || seg_a[s] + k_seg > lda || seg_b[s] < 0 ||
        seg_b[s] % BK || seg_b[s] + k_seg > ldw)
      return -1;
    a.seg[s] = static_cast<uint32_t>(seg_a[s] / BK) | (static_cast<uint32_t>(seg_b[s] / BK) << 16);
  }
  if (!encoder()) return -2;
  a.bias = static_cast<const float*>(bias);
  a.wscale = static_cast<const float*>(wscale);
  a.M = M;
  a.N = N;
  a.kblocks = k_seg / BK;
  a.groups = groups;
  a.n_tiles = N / bn;
  a.tiles = ((M + BM - 1) / BM) * groups * a.n_tiles;
  a.has_res = has_res;
  a.relu = relu;
  a.stages = stages;
  a.in_scale = in_scale;
  a.res_scale = res_scale;
  a.inv_out = inv_out;

  static const CUtensorMapDataType out_type[3] = {
      CU_TENSOR_MAP_DATA_TYPE_UINT8, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, CU_TENSOR_MAP_DATA_TYPE_INT32};
  const int ob = out_bytes(out_kind);
  CUtensorMap mx, mw, mr, mo;
  memset(&mr, 0, sizeof(mr));
  if (!make_map(&mx, x, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, lda, M, BK, BM) ||
      !make_map(&mw, wt, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, ldw, N, BK, bn) ||
      !make_map(&mo, out, out_type[out_kind], ob, groups * N, M, 128 / ob, BM / 2) ||
      (has_res && !make_map(&mr, res, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, groups * N, M, 128, BM)))
    return -3;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bn == 256) {
    return out_kind == OUT_INT8 ? launch<256, OUT_INT8>(mx, mw, mr, mo, a, st)
                                : launch<256, OUT_BF16>(mx, mw, mr, mo, a, st);
  }
  switch (out_kind) {
    case OUT_INT8: return launch<128, OUT_INT8>(mx, mw, mr, mo, a, st);
    case OUT_BF16: return launch<128, OUT_BF16>(mx, mw, mr, mo, a, st);
    default: return launch<128, OUT_INT32>(mx, mw, mr, mo, a, st);
  }
}

}  // extern "C"
