// The JAX quantize of one value, clip(rint(v / s), -127, 127), without a
// division: shared by the int8 GEMM core (quant_wgmma.cuh: K3, K4, K5 and
// their quantize pass) and K2's int8 entries (normalize.cu), so that every
// int8 tensor the port makes from an fp value is the same byte.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace qwg {

// clip(rint(v / s), -127, 127) as an int8 byte, from r = 1/s rounded
// (__frcp_rn), bit for bit what the IEEE division gives, with no division:
// q0 = v·r is within an ulp of v/s, the remainder v - q0·s is exact in one
// FMA, and q0 + rem·r rounded is the correctly rounded quotient (Markstein's
// theorem; r within half an ulp of 1/s). From |q0| >= 128 on both clip to
// ±127 (and a NaN stays a NaN either way).
// With lo, hi (whole numbers, -127 <= lo <= hi <= 127) the code is clipped
// to [lo, hi] instead: the quantize of a value clamped to [x_lo, x_hi] for
// lo = q8(x_lo), hi = q8(x_hi), as the quantize is monotone (K3/K5's
// activations in a quantizing epilogue).
__device__ __forceinline__ uint32_t q8(float v, float s, float r, float lo = -127.0f,
                                       float hi = 127.0f) {
  const float q0 = __fmul_rn(v, r);
  float t = __fmaf_rn(__fmaf_rn(-q0, s, v), r, q0);
  t = fabsf(q0) < 128.0f ? t : q0;
  t = fminf(fmaxf(rintf(t), lo), hi);
  return static_cast<uint32_t>(static_cast<int>(t)) & 0xFFu;
}

}  // namespace qwg
