// K4: int8 post-training-quantized dense, y = q(x) Wq^T * (s_x s_w) (+ b).
//
// Replaces: fac_fake_tpu/models/layers.py QuantDense (:142-176), which XLA
// lowered to one int8 dot_general with the quantize and the dequant fused
// around it. torch._int_mm would do only the GEMM.
//
// Shapes on the int8_full path (batch 96): the (96, 25088) x (25088, 1024)
// patch embedding; (192, 1024) x (1024, 3072 | 1024 | 2048) and (192, 2048)
// x (2048, 1024) in the transformer; (96, 1024) x (1024, 2048) in the head.
//
// Bound on the H100: bytes. At M <= 192 rows a weight byte is used at most
// 192 times, far below the card's ~590 int8 operations per byte of HBM, so
// the time is reading Wq (25.7 MB for the patch embedding) and x. Design
// (quant_mma.cuh): x is quantized once into an int8 (M, Kp) scratch, Kp = K
// rounded up to 16; 64 x 64 CTA tiles stream both operands with cp.async;
// where that gives few CTAs, K is split over blockIdx.y with exact int32
// atomics, so that the 25088-deep patch embedding runs on 8 x 32 CTAs
// rather than 32.
#include "quant_mma.cuh"

// x: (M, K) fp32 (x_bf16 == 0) or bf16, contiguous; wq: (N, Kp) int8, Kp =
// K rounded up to 16, zero past K; w_scale (N,), x_scale 0-d, bias (N,) or
// null: fp32 device pointers; out: (M, N) in x's dtype; xq: (M, Kp) int8
// scratch; splits > 1 needs ws: (M, N) int32 scratch.
extern "C" int fac_quant_dense(const void* x, int x_bf16, const void* wq, const void* w_scale,
                               const void* x_scale, const void* bias, void* out, int M, int N,
                               int K, int splits, void* xq, void* ws, void* stream) {
  qmma::Epi e{static_cast<const float*>(w_scale), static_cast<const float*>(x_scale),
              static_cast<const float*>(bias), out, x_bf16, static_cast<int*>(ws), 0, N, 0};
  return static_cast<int>(qmma::run<2, 2, false>(
      x, x_bf16, M, K, static_cast<int8_t*>(xq), 1, 1, static_cast<const int8_t*>(wq), N, splits,
      e, static_cast<cudaStream_t>(stream)));
}
