// K7: CLAHE on the luma of a batch of (K, H, W, 3) float32 RGB images in
// [0, 1], clip limit and tile grid as cv2's CLAHE.
//
// Replaces: fac_fake_tpu/data/augment.py:274 clahe_luma, vmapped over the
// CLAHE subset of augment_batch (:802-811). XLA ran it on the TPU as a fused
// compare-reduce histogram and a bf16 one-hot x LUT matmul; this kernel
// computes the same values (ops/augment.py clahe_luma_plain is its plain
// version, the CPU path and the card's oracle), not the same graph.
//
// Two kernels, one call:
//   1. clahe_luts: one CTA per (image, tile). Each thread bins pixels of the
//      tile (y in JFIF order, rint(clamp(y, 0, 255)), half to even as
//      jnp.round) into a 256-bin histogram in shared memory with atomicAdd:
//      integer counts, exact in any order. Thread b then clips bin b at the
//      limit, the block scans the clipped counts (warp shuffles, then the 8
//      warp totals), and thread b adds cv2's redistribution in JAX's closed
//      form: the whole-256 batch, batch * (b + 1), and the residual's
//      min(b / step + 1, resid). Every partial sum is an integer below 2^24,
//      so the int32 arithmetic gives the fp32 plain version's values exactly.
//      lut[k][tile][b] = rint(cdf * fp32(255 / tile_px)).
//   2. clahe_apply: one thread per pixel. It recomputes the pixel's Y, Cb,
//      Cr and bin with the same operations, reads the four LUTs of JAX's
//      padded block mapping (band (i + py) / th, offset (i + py) % th;
//      tiles clip(band - 1) and clip(band); weight offset / th, 0 in the edge
//      bands), blends them left to right in fp32 as
//      v0(1-wy)(1-wx) + v1(1-wy)wx + v2 wy(1-wx) + v3 wy wx, converts back
//      to RGB, divides by 255 and clips to [0, 1]. Grid 1 (JAX's rule for
//      odd or sub-2-pixel tiles) reads one LUT and blends nothing.
// Every fp32 operation is the plain version's, in its order, with IEEE
// rounding (__fmul_rn, __fadd_rn, __fdiv_rn; the library is built with
// -fmad=false), so the output is bit-equal to the plain version's on the card.
//
// Bound on the H100: bytes, the input read once and the output written once,
// 2 * K * H * W * 3 * 4 B: 9.63 MB at K = 8, 224^2, about 2.9 us at
// 3.35 TB/s. The simple design reads the input twice (the second time mostly
// from the L2, which holds it) and is launch-bound at the trainer's shape.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBins = 256;

// JAX's constants are Python floats rounded to fp32; so are these
constexpr float kYR = (float)0.299, kYG = (float)0.587, kYB = (float)0.114;
constexpr float kBR = (float)-0.168736, kBG = (float)0.331264, kBB = (float)0.5;
constexpr float kRR = (float)0.5, kRG = (float)0.418688, kRB = (float)0.081312;
constexpr float kCr2R = (float)1.402, kCb2G = (float)0.344136, kCr2G = (float)0.714136;
constexpr float kCb2B = (float)1.772;

struct YCbCr {
  float y, cb, cr;
};

__device__ __forceinline__ YCbCr to_ycbcr(const float* px) {
  const float r = __fmul_rn(px[0], 255.0f);
  const float g = __fmul_rn(px[1], 255.0f);
  const float b = __fmul_rn(px[2], 255.0f);
  YCbCr o;
  o.y = __fadd_rn(__fadd_rn(__fmul_rn(kYR, r), __fmul_rn(kYG, g)), __fmul_rn(kYB, b));
  o.cb = __fadd_rn(
      __fadd_rn(__fsub_rn(__fmul_rn(kBR, r), __fmul_rn(kBG, g)), __fmul_rn(kBB, b)), 128.0f);
  o.cr = __fadd_rn(
      __fsub_rn(__fsub_rn(__fmul_rn(kRR, r), __fmul_rn(kRG, g)), __fmul_rn(kRB, b)), 128.0f);
  return o;
}

__device__ __forceinline__ int luma_bin(float y) {
  return static_cast<int>(rintf(fminf(fmaxf(y, 0.0f), 255.0f)));
}

__device__ __forceinline__ float unit(float v) {
  return fminf(fmaxf(__fdiv_rn(v, 255.0f), 0.0f), 1.0f);
}

__global__ void __launch_bounds__(kThreads)
clahe_luts(const float* __restrict__ img, float* __restrict__ lut, int h, int w, int grid,
           int limit, float scale) {
  __shared__ int hist[kBins];
  __shared__ int warp_sum[kThreads / 32];
  const int k = blockIdx.y, tile = blockIdx.x;
  const int th = h / grid, tw = w / grid;
  const int row0 = (tile / grid) * th, col0 = (tile % grid) * tw;
  const int npx = th * tw;
  const float* base = img + static_cast<size_t>(k) * h * w * 3;
  hist[threadIdx.x] = 0;
  __syncthreads();
  for (int p = threadIdx.x; p < npx; p += kThreads) {
    const int i = row0 + p / tw, j = col0 + p % tw;
    atomicAdd(&hist[luma_bin(to_ycbcr(base + (static_cast<size_t>(i) * w + j) * 3).y)], 1);
  }
  __syncthreads();

  const int b = threadIdx.x, lane = b & 31, warp = b >> 5;
  int v = min(hist[b], limit);
  for (int o = 1; o < 32; o <<= 1) {       // inclusive scan within the warp
    const int n = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += n;
  }
  if (lane == 31) warp_sum[warp] = v;
  __syncthreads();
  int before = 0, total = 0;
  for (int q = 0; q < kThreads / 32; ++q) {
    before += q < warp ? warp_sum[q] : 0;
    total += warp_sum[q];
  }
  const int excess = npx - total;         // every pixel has one bin
  const int batch = excess / kBins, resid = excess - batch * kBins;
  const int step = max(kBins / max(resid, 1), 1);
  const int resid_cum = resid > 0 ? min(b / step + 1, resid) : 0;
  const int cdf = before + v + batch * (b + 1) + resid_cum;
  lut[(static_cast<size_t>(k) * grid * grid + tile) * kBins + b] =
      rintf(__fmul_rn(static_cast<float>(cdf), scale));
}

__global__ void __launch_bounds__(kThreads)
clahe_apply(const float* __restrict__ img, const float* __restrict__ lut,
            float* __restrict__ out, int k_imgs, int h, int w, int grid) {
  const long long n = static_cast<long long>(k_imgs) * h * w;
  const int th = h / grid, tw = w / grid, py = th / 2, px = tw / 2;
  for (long long p = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x; p < n;
       p += static_cast<long long>(gridDim.x) * kThreads) {
    const int k = static_cast<int>(p / (static_cast<long long>(h) * w));
    const int rem = static_cast<int>(p - static_cast<long long>(k) * h * w);
    const int i = rem / w, j = rem % w;
    const YCbCr c = to_ycbcr(img + p * 3);
    const int bin = luma_bin(c.y);
    const float* L = lut + static_cast<size_t>(k) * grid * grid * kBins + bin;
    float v;
    if (grid == 1) {
      v = L[0];
    } else {
      const int by = (i + py) / th, ry = (i + py) % th;
      const int bx = (j + px) / tw, rx = (j + px) % tw;
      const int y0 = min(max(by - 1, 0), grid - 1), y1 = min(by, grid - 1);
      const int x0 = min(max(bx - 1, 0), grid - 1), x1 = min(bx, grid - 1);
      const float wy = (by >= 1 && by <= grid - 1)
                           ? __fdiv_rn(static_cast<float>(ry), static_cast<float>(th)) : 0.0f;
      const float wx = (bx >= 1 && bx <= grid - 1)
                           ? __fdiv_rn(static_cast<float>(rx), static_cast<float>(tw)) : 0.0f;
      const float v0 = L[(y0 * grid + x0) * kBins], v1 = L[(y0 * grid + x1) * kBins];
      const float v2 = L[(y1 * grid + x0) * kBins], v3 = L[(y1 * grid + x1) * kBins];
      const float ay = __fsub_rn(1.0f, wy), ax = __fsub_rn(1.0f, wx);
      v = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(__fmul_rn(v0, ay), ax),
                                        __fmul_rn(__fmul_rn(v1, ay), wx)),
                              __fmul_rn(__fmul_rn(v2, wy), ax)),
                    __fmul_rn(__fmul_rn(v3, wy), wx));
    }
    const float dcr = __fsub_rn(c.cr, 128.0f), dcb = __fsub_rn(c.cb, 128.0f);
    float* o = out + p * 3;
    o[0] = unit(__fadd_rn(v, __fmul_rn(kCr2R, dcr)));
    o[1] = unit(__fsub_rn(__fsub_rn(v, __fmul_rn(kCb2G, dcb)), __fmul_rn(kCr2G, dcr)));
    o[2] = unit(__fadd_rn(v, __fmul_rn(kCb2B, dcb)));
  }
}

}  // namespace

extern "C" int fac_clahe_luma(const float* img, float* out, float* lut, int k_imgs, int h,
                              int w, int grid, int limit, float scale, cudaStream_t stream) {
  if (k_imgs <= 0) return 0;
  clahe_luts<<<dim3(grid * grid, k_imgs), kThreads, 0, stream>>>(img, lut, h, w, grid, limit,
                                                                  scale);
  const long long n = static_cast<long long>(k_imgs) * h * w;
  const long long blocks = (n + kThreads - 1) / kThreads;
  clahe_apply<<<static_cast<int>(blocks < 132 * 16 ? blocks : 132 * 16), kThreads, 0, stream>>>(
      img, lut, out, k_imgs, h, w, grid);
  return static_cast<int>(cudaGetLastError());
}
