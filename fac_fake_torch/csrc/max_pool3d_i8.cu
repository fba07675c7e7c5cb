// K6: int8 NDHWC max-pool, window 3 x 3 x 3, stride 1, padding 1 with the
// identity -128 (below every quantized value, which lies in [-127, 127]).
//
// Replaces: fac_fake_tpu/compat/quantize_s3d.py _max_pool3d_i8 (:85-90), a
// reduce_window over the int8 tensor: the fourth branch of an Inception mix
// pools the mix's int8 input, which is exact because max-pool commutes with
// the monotone quantizer under the shared scale. PyTorch has no int8
// max-pool.
//
// Bound on the H100: bytes (one int8 read and one int8 write an element,
// 26 byte-max operations). Design: one thread an output position's 16
// channels; each of the 27 taps is one coalesced 16-byte load (neighbouring
// threads read neighbouring channel chunks), reduced with __vmaxs4 (four
// signed byte maxima an instruction); the 27-fold re-reads hit L1/L2. The
// channels are a multiple of 16 (the int8 activations are padded to 16).
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void max_pool3d_i8_333(const int4* __restrict__ x, int4* __restrict__ y, int T, int H,
                                  int W, int C16, long long total) {
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int c = static_cast<int>(i % C16);
    long long p = i / C16;
    const int w = static_cast<int>(p % W);
    p /= W;
    const int h = static_cast<int>(p % H);
    p /= H;
    const int t = static_cast<int>(p % T);
    const long long b = p / T;
    unsigned m0 = 0x80808080u, m1 = 0x80808080u, m2 = 0x80808080u, m3 = 0x80808080u;
    for (int dt = -1; dt <= 1; ++dt) {
      const int tt = t + dt;
      if (tt < 0 || tt >= T) continue;
      for (int dy = -1; dy <= 1; ++dy) {
        const int yy = h + dy;
        if (yy < 0 || yy >= H) continue;
        for (int dx = -1; dx <= 1; ++dx) {
          const int xx = w + dx;
          if (xx < 0 || xx >= W) continue;
          const int4 v = x[(((b * T + tt) * H + yy) * W + xx) * C16 + c];
          m0 = __vmaxs4(m0, static_cast<unsigned>(v.x));
          m1 = __vmaxs4(m1, static_cast<unsigned>(v.y));
          m2 = __vmaxs4(m2, static_cast<unsigned>(v.z));
          m3 = __vmaxs4(m3, static_cast<unsigned>(v.w));
        }
      }
    }
    y[i] = make_int4(static_cast<int>(m0), static_cast<int>(m1), static_cast<int>(m2),
                     static_cast<int>(m3));
  }
}

// x, y: (B, T, H, W, C) int8, contiguous, 16-byte aligned, C % 16 == 0.
extern "C" int fac_max_pool3d_i8(const void* x, void* y, int B, int T, int H, int W, int C,
                                 void* stream) {
  if (C % 16 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(y) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long total = static_cast<long long>(B) * T * H * W * (C / 16);
  if (total == 0) return static_cast<int>(cudaSuccess);
  long long blocks = (total + 255) / 256;
  if (blocks > 132 * 16) blocks = 132 * 16;
  max_pool3d_i8_333<<<static_cast<unsigned>(blocks), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(x), static_cast<int4*>(y), T, H, W, C / 16, total);
  return static_cast<int>(cudaGetLastError());
}
