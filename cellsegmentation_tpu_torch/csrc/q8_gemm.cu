// int8 GEMMs of the stage-2 serving trunk on the mma.sync core, for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of cellsegmentation_tpu/ops/q8_gemm.py:
//   q8_conv3_tap_launch     <- q8_conv3_tap / _tap_kernel       (tap-accumulating 3x3)
//   q8_conv3_rowtap_launch  <- q8_conv3_rowtap / _rowtap_kernel (row-Toeplitz 3x3)
// q8_matmul and q8_matmul_px run on the wgmma/TMA core of q8_gemm_sm90.cu.
// This core's MM and PX paths stay as private entries (q8_matmul_mma_launch,
// q8_matmul_px_mma_launch), a same-run yardstick that only chip_smoke.py and
// the card test call; they go with the whole core when tap and rowtap move
// to the wgmma core.
//
// What bounds them on the H100: at the trunk's shapes (M = 225 tiles per
// image x the image batch, K and N of 256..2048) each call does 2*M*N*K int8
// operations on M*K + K*N + M*N bytes, i.e. 300..1000 operations per byte:
// above the card's int8 ridge (1979 TOP/s / 3.35 TB/s = 590 op/B) for the
// big-K calls and below it for the 1x1 reduce/expand calls. Both rates need
// tensor cores, so the core runs mma.sync.m16n8k32 (s8 x s8 -> s32).
//
// Design. One tiled GEMM core serves all four entry points; they differ
// only in where a block's A columns and B rows come from, which the core
// sees as a list of K segments (a_off, b_off), each kseg bytes long:
//   matmul: one segment (0, 0), kseg = K;
//   px:     one segment (g*C_in, 0), g = p or the px_map formula, where
//           blockIdx.z = p is the output pixel group;
//   tap:    one segment per in-range tap t of output pixel p = blockIdx.z,
//           ((hi*w_in + wi)*C, t*C). The TPU's sequential tap grid axis is a
//           loop inside the block here: Hopper blocks run in parallel and no
//           accumulator carries across them.
//   rowtap: one segment per in-range input row hi = stride*ho + dy - 1 of
//           output row ho = blockIdx.z, (hi*w_in*C, dy*w_in*C), kseg = w_in*C:
//           the TPU kernel's sequential dy grid axis (its int32 accumulator
//           carried in VMEM scratch) becomes the same in-block loop. Each
//           segment is a whole input row (w_in*C = 512..1024 bytes of K)
//           against the dy-th row-Toeplitz weight plane; the per-column bias
//           and scale arrive tiled over wo, so the epilogue is unchanged.
//           At the trunk's shapes these calls sit below the int8 ridge as
//           well as above it (the row-Toeplitz weight is w_in/3-redundant
//           along the row, so K per output pixel is 1.3-2x the tap form's):
//           operations bound the big-K calls, bytes the 1x1-map ones.
// A block computes a 128x128 output tile with 8 warps (4 along M, 2 along
// N, a 32x64 warp tile = 2x8 mma tiles, int32 accumulators in registers).
// A and B tiles (128x64 bytes each) are staged in shared memory by cp.async,
// double-buffered, with rows padded to 80 bytes so fragment loads hit 32
// distinct banks. Rows past M are zero-filled on load and masked on store.
// B is read as wt[N, K] (K contiguous): the engine transposes each weight
// once when it is built. The epilogue is q8_epilogue.cuh's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "q8_epilogue.cuh"

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 64;
constexpr int LDS = BK + 16;  // padded shared-memory row, bytes
constexpr int THREADS = 256;
constexpr int WARPS_M = 4;
constexpr int WM = BM / WARPS_M;  // 32 rows per warp
constexpr int WN = BN / 2;        // 64 columns per warp
constexpr int MT = WM / 16;       // m16 tiles per warp
constexpr int NT = WN / 8;        // n8 tiles per warp
constexpr int MAX_SEG = 9;

enum { MODE_MM = 0, MODE_PX = 1, MODE_TAP = 2, MODE_ROWTAP = 3 };

struct Params {
  const int8_t* x;      // [M, lda] int8
  const int8_t* wt;     // [N, ldw] int8, K contiguous
  const float* bias;    // [N]
  const float* wscale;  // [N]
  const int8_t* res;    // [M, ldo] int8 or null
  void* out;            // [M, ldo] int8 / bf16 / int32
  int M, N;             // rows; output columns of one pixel group
  int lda, ldw, ldo;    // row strides in elements
  int kseg;             // bytes of K per segment (multiple of BK)
  int mode;
  int h_in, w_in, w_out, stride, c_in;  // px (strided map), tap and rowtap geometry
  int map;              // px: 1 when px_map is given
  float in_scale, res_scale, inv_out;
  int out_kind, relu;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  unsigned saddr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int bytes = valid ? 16 : 0;  // 0 source bytes -> the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(saddr), "l"(gmem),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_s8(int* c, const unsigned* a, const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Stage one (BM x BK) A tile and one (BN x BK) B tile: each thread copies
// two 16-byte chunks of each. A rows past M are zero-filled.
__device__ __forceinline__ void load_tiles(int8_t* as, int8_t* bs, const Params& p, int a_col,
                                           int b_col, int m0, int n0, int tid) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = tid + i * THREADS;
    const int row = c >> 2;
    const int col = (c & 3) * 16;
    const int gm = m0 + row;
    const bool ok = gm < p.M;
    const int8_t* src = ok ? p.x + (size_t)gm * p.lda + a_col + col : p.x;
    cp_async16(as + row * LDS + col, src, ok);
    cp_async16(bs + row * LDS + col, p.wt + (size_t)(n0 + row) * p.ldw + b_col + col, true);
  }
}

__global__ void __launch_bounds__(THREADS) q8_gemm_kernel(const Params p) {
  __shared__ __align__(16) int8_t As[2][BM * LDS];
  __shared__ __align__(16) int8_t Bs[2][BN * LDS];
  __shared__ int seg_a[MAX_SEG];
  __shared__ int seg_b[MAX_SEG];
  __shared__ int n_seg;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warp_m = warp % WARPS_M;
  const int warp_n = warp / WARPS_M;
  const int g = lane >> 2;  // mma groupID
  const int t4 = lane & 3;  // mma threadID_in_group
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int pz = blockIdx.z;  // output pixel group (px, tap) or output row (rowtap)

  if (tid == 0) {
    int ns = 0;
    if (p.mode == MODE_MM) {
      seg_a[0] = 0;
      seg_b[0] = 0;
      ns = 1;
    } else if (p.mode == MODE_PX) {
      int grp = p.map ? p.stride * (pz / p.w_out) * p.w_in + p.stride * (pz % p.w_out) : pz;
      seg_a[0] = grp * p.c_in;
      seg_b[0] = 0;
      ns = 1;
    } else if (p.mode == MODE_ROWTAP) {
      const int k_row = p.w_in * p.c_in;
      for (int dy = 0; dy < 3; ++dy) {
        const int hi = p.stride * pz + dy - 1;
        if (hi >= 0 && hi < p.h_in) {
          seg_a[ns] = hi * k_row;
          seg_b[ns] = dy * k_row;
          ++ns;
        }
      }
    } else {
      const int ho = pz / p.w_out, wo = pz % p.w_out;
      for (int t = 0; t < 9; ++t) {
        const int hi = p.stride * ho + t / 3 - 1;
        const int wi = p.stride * wo + t % 3 - 1;
        if (hi >= 0 && hi < p.h_in && wi >= 0 && wi < p.w_in) {
          seg_a[ns] = (hi * p.w_in + wi) * p.c_in;
          seg_b[ns] = t * p.c_in;
          ++ns;
        }
      }
    }
    n_seg = ns;
  }
  __syncthreads();

  const int k_steps = p.kseg / BK;
  const int n_steps = n_seg * k_steps;

  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  // K step -> (segment, offset inside it)
  load_tiles(As[0], Bs[0], p, seg_a[0], seg_b[0], m0, n0, tid);
  cp_async_commit();
  for (int step = 0; step < n_steps; ++step) {
    const int cur = step & 1;
    if (step + 1 < n_steps) {
      const int s = (step + 1) / k_steps;
      const int kk = ((step + 1) % k_steps) * BK;
      load_tiles(As[cur ^ 1], Bs[cur ^ 1], p, seg_a[s] + kk, seg_b[s] + kk, m0, n0, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int8_t* a_s = As[cur];
    const int8_t* b_s = Bs[cur];
#pragma unroll
    for (int k32 = 0; k32 < BK; k32 += 32) {
      unsigned af[MT][4];
      unsigned bf[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int r = warp_m * WM + i * 16 + g;
        const int c = k32 + t4 * 4;
        af[i][0] = *reinterpret_cast<const unsigned*>(a_s + r * LDS + c);
        af[i][1] = *reinterpret_cast<const unsigned*>(a_s + (r + 8) * LDS + c);
        af[i][2] = *reinterpret_cast<const unsigned*>(a_s + r * LDS + c + 16);
        af[i][3] = *reinterpret_cast<const unsigned*>(a_s + (r + 8) * LDS + c + 16);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = warp_n * WN + j * 8 + g;
        const int c = k32 + t4 * 4;
        bf[j][0] = *reinterpret_cast<const unsigned*>(b_s + n * LDS + c);
        bf[j][1] = *reinterpret_cast<const unsigned*>(b_s + n * LDS + c + 16);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    }
    __syncthreads();
  }

  // epilogue: thread holds rows (g, g+8) x columns (2*t4, 2*t4+1) of each tile
  const size_t col_base = (p.mode == MODE_MM) ? 0 : (size_t)pz * p.N;
  const bool has_res = p.res != nullptr;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = n0 + warp_n * WN + j * 8 + t4 * 2;
    const float ws0 = p.wscale[col], ws1 = p.wscale[col + 1];
    const float b0 = p.bias[col], b1 = p.bias[col + 1];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + warp_m * WM + i * 16 + g + h * 8;
        if (row >= p.M) continue;
        const size_t off = (size_t)row * p.ldo + col_base + col;
        const int a0 = acc[i][j][2 * h], a1 = acc[i][j][2 * h + 1];
        if (p.out_kind == OUT_INT32) {
          *reinterpret_cast<int2*>(static_cast<int*>(p.out) + off) = make_int2(a0, a1);
          continue;
        }
        float r0 = 0.0f, r1 = 0.0f;
        if (has_res) {
          const char2 rv = *reinterpret_cast<const char2*>(p.res + off);
          r0 = static_cast<float>(rv.x);
          r1 = static_cast<float>(rv.y);
        }
        const float y0 = q8_epilogue(a0, ws0, b0, r0, has_res, p.in_scale, p.res_scale, p.relu);
        const float y1 = q8_epilogue(a1, ws1, b1, r1, has_res, p.in_scale, p.res_scale, p.relu);
        if (p.out_kind == OUT_INT8) {
          char2 o;
          o.x = q8_requant(y0, p.inv_out);
          o.y = q8_requant(y1, p.inv_out);
          *reinterpret_cast<char2*>(static_cast<int8_t*>(p.out) + off) = o;
        } else {
          __nv_bfloat162 o;
          o.x = __float2bfloat16_rn(y0);
          o.y = __float2bfloat16_rn(y1);
          *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(p.out) + off) = o;
        }
      }
    }
  }
}

int launch(const Params& p, int grid_z, void* stream) {
  dim3 grid((p.M + BM - 1) / BM, p.N / BN, grid_z);
  q8_gemm_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

Params base(const void* x, const void* wt, const void* bias, const void* wscale, const void* res,
            void* out, int M, int N, float in_scale, float res_scale, float inv_out, int out_kind,
            int relu) {
  Params p = {};
  p.x = static_cast<const int8_t*>(x);
  p.wt = static_cast<const int8_t*>(wt);
  p.bias = static_cast<const float*>(bias);
  p.wscale = static_cast<const float*>(wscale);
  p.res = static_cast<const int8_t*>(res);
  p.out = out;
  p.M = M;
  p.N = N;
  p.in_scale = in_scale;
  p.res_scale = res_scale;
  p.inv_out = inv_out;
  p.out_kind = out_kind;
  p.relu = relu;
  return p;
}

}  // namespace

extern "C" {

// out[M, N] = epilogue(x[M, K] @ wt[N, K]^T)
int q8_matmul_mma_launch(const void* x, const void* wt, const void* bias, const void* wscale,
                     const void* res, void* out, int M, int N, int K, float in_scale,
                     float res_scale, float inv_out, int out_kind, int relu, void* stream) {
  Params p = base(x, wt, bias, wscale, res, out, M, N, in_scale, res_scale, inv_out, out_kind,
                  relu);
  p.mode = MODE_MM;
  p.lda = K;
  p.ldw = K;
  p.ldo = N;
  p.kseg = K;
  return launch(p, 1, stream);
}

// out[M, px*N] group p = epilogue(x[:, g(p)*c_in : +c_in] @ wt[N, c_in]^T)
int q8_matmul_px_mma_launch(const void* x, const void* wt, const void* bias, const void* wscale,
                        const void* res, void* out, int M, int N, int c_in, int lda, int px,
                        int map_stride, int map_w_in, int map_w_out, float in_scale,
                        float res_scale, float inv_out, int out_kind, int relu, void* stream) {
  Params p = base(x, wt, bias, wscale, res, out, M, N, in_scale, res_scale, inv_out, out_kind,
                  relu);
  p.mode = MODE_PX;
  p.lda = lda;
  p.ldw = c_in;
  p.ldo = px * N;
  p.kseg = c_in;
  p.c_in = c_in;
  p.map = map_stride > 0;
  p.stride = map_stride;
  p.w_in = map_w_in;
  p.w_out = map_w_out;
  return launch(p, px, stream);
}

// 3x3 pad-1 stride-s conv on the whole-tile layout, tap-major wt[N, 9*c_in]
int q8_conv3_tap_launch(const void* x, const void* wt, const void* bias, const void* wscale,
                        void* out, int M, int N, int c_in, int h_in, int w_in, int stride,
                        float in_scale, float inv_out, int out_kind, int relu, void* stream) {
  const int h_out = (h_in - 1) / stride + 1;
  const int w_out = (w_in - 1) / stride + 1;
  Params p = base(x, wt, bias, wscale, nullptr, out, M, N, in_scale, 1.0f, inv_out, out_kind,
                  relu);
  p.mode = MODE_TAP;
  p.lda = h_in * w_in * c_in;
  p.ldw = 9 * c_in;
  p.ldo = h_out * w_out * N;
  p.kseg = c_in;
  p.c_in = c_in;
  p.h_in = h_in;
  p.w_in = w_in;
  p.w_out = w_out;
  p.stride = stride;
  return launch(p, h_out * w_out, stream);
}

// 3x3 pad-1 stride-s conv on the whole-tile layout as row-Toeplitz dots:
// dy-major wt[N, 3*w_in*c_in] (N = w_out*c_out), out[M, h_out*N]
int q8_conv3_rowtap_launch(const void* x, const void* wt, const void* bias, const void* wscale,
                           void* out, int M, int N, int c_in, int h_in, int w_in, int stride,
                           float in_scale, float inv_out, int out_kind, int relu, void* stream) {
  const int h_out = (h_in - 1) / stride + 1;
  const int k_row = w_in * c_in;
  Params p = base(x, wt, bias, wscale, nullptr, out, M, N, in_scale, 1.0f, inv_out, out_kind,
                  relu);
  p.mode = MODE_ROWTAP;
  p.lda = h_in * k_row;
  p.ldw = 3 * k_row;
  p.ldo = h_out * N;
  p.kseg = k_row;
  p.c_in = c_in;
  p.h_in = h_in;
  p.w_in = w_in;
  p.stride = stride;
  return launch(p, h_out, stream);
}

}  // extern "C"
