// K5: the int8 3D convs of the S3D int8 walk — a quantize pass, and an int8
// x int8 -> exact int32 implicit-GEMM conv with the dequant epilogue.
//
// Replaces: fac_fake_tpu/compat/quantize_s3d.py _conv3d(int8=True) (:59-62),
// _quantize_in (:93-95) and the epilogue of conv_step (:147-149), which XLA
// lowered to an int8 conv_general_dilated (preferred_element_type int32)
// with the quantize and the `acc * s + b` epilogue fused around it. PyTorch
// has no int8 convolution on CUDA.
//
//   fac_quantize_pad:  x (rows, C) fp32 or bf16 -> xq (rows, Cp) int8,
//                      q = clip(rint(x / s_x), -127, 127), Cp = C rounded up
//                      to 16 with zero channels. Its own pass, so that an
//                      Inception mix quantizes its input once for its three
//                      1x1x1 branches and the int8 max-pool (K6) of the fourth.
//   fac_int8_conv3d:   xq (B, T, H, W, Cp) int8, wq (N, kt, kh, kw, Cp) int8
//                      -> out[..., c0 : c0 + N] = relu?(acc * s[o] + b[o]),
//                      fp32 or bf16, out rows ldo values apart (an Inception
//                      branch writes its slice of the concatenated output).
//
// Implicit GEMM (quant_mma.cuh): M = B*To*Ho*Wo output positions, N = Cout,
// K = kt*kh*kw*Cp ordered (dt, dy, dx, c); each 16-channel chunk of a tap is
// one 16-byte cp.async, zero-filled where the tap falls in the padding. The
// geometries of a ca_s3d forward: (1,7,7) stride (1,2,2) pad (0,3,3) on 3
// (padded to 16) channels; (7,1,1) stride (2,1,1) pad (3,0,0); (1,1,1);
// (1,3,3) pad (0,1,1); (3,1,1) pad (1,0,0); Cin 16..832.
//
// Bound on the H100 at batch 32 (224 x 224, 20 frames): bytes for the wide
// early convs (the (1,7,7) stem conv writes 2 GB of fp32 for 151 G int8
// operations) and operations for the deep 1x1x1 and (1,3,3) convs of the
// mixes. Design: the int8 image is a quarter of the fp32 activation's
// bytes; the taps re-read it from L2; CTA tiles follow Cout as in K3. Not
// yet done: wgmma/TMA, a split of K for the small late convs (7 x 7 x 2
// positions a clip), the next layer's quantize in the epilogue.
#include "quant_mma.cuh"

extern "C" int fac_quantize_pad(const void* x, int x_bf16, const void* x_scale, void* xq,
                                int rows, int C, void* stream) {
  return static_cast<int>(qmma::quantize(x, x_bf16, rows, C, static_cast<int8_t*>(xq),
                                         static_cast<const float*>(x_scale),
                                         static_cast<cudaStream_t>(stream)));
}

// g: B, T, H, W, Cp, To, Ho, Wo, N, kt, kh, kw, st, sh, sw, pt, ph, pw (host
// ints); s, bias: (N,) fp32 device pointers; out: (B, To, Ho, Wo, ldo).
extern "C" int fac_int8_conv3d(const void* xq, const void* wq, const void* s, const void* bias,
                               void* out, int out_bf16, int relu, int ldo, int c0, const int* g,
                               void* stream) {
  const int B = g[0], T = g[1], H = g[2], W = g[3], Cp = g[4], To = g[5], Ho = g[6], Wo = g[7];
  const int N = g[8];
  const long long rows = static_cast<long long>(B) * To * Ho * Wo;
  const long long pixels = static_cast<long long>(B) * T * H * W;
  if (rows > 0x7fffffffLL || pixels > 0x7fffffffLL || c0 + N > ldo)
    return static_cast<int>(cudaErrorInvalidValue);
  const qmma::AOperand a = qmma::conv_operand(static_cast<const int8_t*>(xq), static_cast<int>(rows),
                                              Cp, T, H, W, To, Ho, Wo, g[9], g[10], g[11], g[12],
                                              g[13], g[14], g[15], g[16], g[17]);
  qmma::Epi e{static_cast<const float*>(s), nullptr, static_cast<const float*>(bias), out,
              out_bf16, nullptr, relu, ldo, c0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* w = static_cast<const int8_t*>(wq);
  cudaError_t err;
  if (N <= 32) {
    err = qmma::gemm<8, 1, true>(a, w, N, 1, e, st);
  } else if (N <= 64) {
    err = qmma::gemm<4, 2, true>(a, w, N, 1, e, st);
  } else {
    err = qmma::gemm<4, 4, true>(a, w, N, 1, e, st);
  }
  return static_cast<int>(err);
}
