// The int8 GEMM epilogue of the wgmma/TMA core (q8_gemm_sm90.cu).
//
// Bit-exact to the Pallas one (cellsegmentation_tpu/ops/q8_gemm.py:106-120):
//   y = f32(acc) * (in_scale * w_scale[col]); y += bias[col];
//   y += f32(res) * res_scale; y = relu(y);
//   int8: clip(rint(y * inv_out), -127, 127)   bf16: RNE(y)   int32: acc
// with every multiply and add rounded separately (__fmul_rn/__fadd_rn; the
// library is also built with -fmad=false) and round-half-even.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

enum { OUT_INT8 = 0, OUT_BF16 = 1, OUT_INT32 = 2 };

// The epilogue up to (and including) the ReLU, with the column's scale
// in_scale * w_scale[col] already formed.
__device__ __forceinline__ float q8_epilogue_scaled(int acc, float scale, float b, float r,
                                                    bool has_res, float res_scale, bool relu) {
  float y = __fmul_rn(__int2float_rn(acc), scale);
  y = __fadd_rn(y, b);
  if (has_res) y = __fadd_rn(y, __fmul_rn(r, res_scale));
  if (relu) y = fmaxf(y, 0.0f);
  return y;
}

// Two requantized values, clip(rint(y * inv_out), -127, 127), as int8 in
// the low 16 bits, q(y0) in the low byte; the clip bounds are integers, so
// clipping before the rounding gives the same value. Without the conversion
// unit (16 results a clock per SM on Hopper): after the clip, adding
// 1.5 * 2^23 rounds half to even onto the integers (the sum's ulp is 1), and
// the int8 is the low byte of the sum's bits. After a ReLU (NONNEG) y >= 0,
// so the clip at -127 cannot bind and is left out.
template <bool NONNEG>
__device__ __forceinline__ uint16_t q8_requant2(float y0, float y1, float inv_out) {
  const float magic = 12582912.0f;  // 1.5 * 2^23
  float v0 = fminf(__fmul_rn(y0, inv_out), 127.0f);
  float v1 = fminf(__fmul_rn(y1, inv_out), 127.0f);
  if (!NONNEG) {
    v0 = fmaxf(v0, -127.0f);
    v1 = fmaxf(v1, -127.0f);
  }
  return static_cast<uint16_t>(__byte_perm(__float_as_uint(__fadd_rn(v0, magic)),
                                           __float_as_uint(__fadd_rn(v1, magic)), 0x0040));
}

// Two int8 (the low 16 bits of rv, lower column first) as exact floats,
// without the conversion unit: each byte, biased to unsigned, becomes the
// low mantissa byte of 2^23, and 2^23 + 128 comes off again.
__device__ __forceinline__ float2 q8_int8x2_to_float(uint32_t rv) {
  const uint32_t u = rv ^ 0x8080u;
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540));
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541));
  return make_float2(__fsub_rn(f0, 8388736.0f), __fsub_rn(f1, 8388736.0f));
}
