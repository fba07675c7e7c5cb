// K3: int8 post-training-quantized 3x3 conv, stride 1, pad 1, NHWC.
//
// Replaces: fac_fake_tpu/models/layers.py QuantConv3x3 (:106-139), which XLA
// lowered to an int8 conv_general_dilated with the quantize and the dequant
// fused around it. PyTorch has no int8 convolution on CUDA.
//
// Implicit GEMM (quant_mma.cuh): M = B*H*W output pixels, N = Cout, K =
// 9*Cp ordered (dy, dx, c), Cp = Cin rounded up to 16. The input is
// quantized once into an int8 (B, H, W, Cp) scratch image; the GEMM gathers
// each 16-channel chunk of a tap with one cp.async, and the image border
// reads as zeros, which is what JAX's zero padding of the int8 tensor
// gives. The weights come in O-HW-I memory with Cin padded to Cp by the
// wrapper, which is the (N, K) K-major operand as stored. Cin = 3 (the
// first conv) pads to 16.
//
// Bound on the H100, at the 17 convs of the base stem at batch 96: bytes for
// the wide early convs (224^2 x 32 -> 32 channels: 1.23 GB of fp32 in and
// out for 89 G int8 operations) and operations for the deep late ones
// (14^2 x 512 -> 512: the same 89 G operations for 79 MB). Design: the
// int8 image is a quarter of the fp32 input's bytes, and the 9 taps re-read
// it from L2; CTA tiles follow Cout: 256 x 32 for the 32-channel stage (no
// mma spent on padding, and twice the rows over its few k-tiles), 128 x 64
// at 64 channels, 128 x 128 above (half the L2 re-reads of A of a 64-wide
// tile).
#include "quant_mma.cuh"

// x: (B, H, W, Cin) fp32 (x_bf16 == 0) or bf16, contiguous; wq: (Cout, 3, 3,
// Cp) int8, Cp = Cin rounded up to 16, zero past Cin; w_scale (Cout,),
// x_scale 0-d, bias (Cout,): fp32 device pointers; out: (B, H, W, Cout) in
// x's dtype; xq: (B, H, W, Cp) int8 scratch.
extern "C" int fac_quant_conv3x3(const void* x, int x_bf16, const void* wq, const void* w_scale,
                                 const void* x_scale, const void* bias, void* out, int B, int H,
                                 int W, int Cin, int Cout, void* xq, void* stream) {
  const long long rows = static_cast<long long>(B) * H * W;
  if (rows > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  qmma::Epi e{static_cast<const float*>(w_scale), static_cast<const float*>(x_scale),
              static_cast<const float*>(bias), out, x_bf16, nullptr, 0, Cout, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int8_t* q = static_cast<int8_t*>(xq);
  const int8_t* w = static_cast<const int8_t*>(wq);
  const int m = static_cast<int>(rows);
  cudaError_t err;
  if (Cout <= 32) {
    err = qmma::run<8, 1, true>(x, x_bf16, m, Cin, q, H, W, w, Cout, 1, e, s);
  } else if (Cout <= 64) {
    err = qmma::run<4, 2, true>(x, x_bf16, m, Cin, q, H, W, w, Cout, 1, e, s);
  } else {
    err = qmma::run<4, 4, true>(x, x_bf16, m, Cin, q, H, W, w, Cout, 1, e, s);
  }
  return static_cast<int>(err);
}
