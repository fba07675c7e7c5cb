// K10: the S3D train transform's JPEG compression step. In place on a batch
// of (N, H, W, 3) float32 RGB frames in [0, 1], H and W multiples of 16: each
// frame whose `take` byte is set becomes its JPEG at quality[n] (8x8 block
// DCT quantization, 4:2:0 chroma); every other frame keeps its bits.
//
// Replaces: fac_fake_tpu/data/augment.py:415 jpeg_compress (with
// _rgb_to_ycbcr :258, _jpeg_quality_table :397, _dct_quantize :404,
// _ycbcr_to_rgb :267), vmapped over every frame of augment_batch and then
// selected by where(take) (:701-708); XLA fused it into matmuls on the TPU.
// This kernel computes only the taken frames (ops/jpeg.py
// jpeg_compress_plain is its plain version, the CPU path and the card's
// oracle).
//
// Design, simple first: one CTA of 256 threads a (frame, 16x16 MCU); the CTAs
// of untaken frames read their byte of `take` and return. A thread a pixel:
//   1. its RGB from device memory, x255, to Y, Cb, Cr (JFIF, the plain
//      version's fp32 operations in its order); Y - 128 into one of the four
//      8x8 luma blocks in shared memory, Cb and Cr at full resolution;
//   2. Cb and Cr averaged over 2x2 pixels into two 8x8 blocks (minus 128);
//   3. the six blocks' DCT as two products with the constant DCT matrix
//      (made in the kernel, as JAX's _dct8), each output a thread's sum of 8;
//      rintf(coef / table) * table (half to even as jnp.round; a true IEEE
//      division: the library builds without --use_fast_math and with
//      -fmad=false); the libjpeg quality tables made in the kernel from
//      quality[n], read on the card (no host sync);
//   4. the inverse DCT as two more products, + 128;
//   5. each pixel's luma and its 2x2 cell's chroma (nearest upsample) back
//      to RGB, / 255, clipped to [0, 1], stored over the input.
// The DCT sums run in another order than the plain version's einsums, so a
// coefficient within float32 noise of a rounding boundary can round the
// other way: ops/jpeg.py near_ties finds those blocks; outside them the two
// agree to 2e-5.
//
// Bound on the H100: bytes, each taken frame read once and written once,
// 2 * H * W * 3 * 4 B (1.2 MB at 224^2; 86.7 MB for 72 frames, 26 us at
// 3.35 TB/s); the arithmetic, about 0.4 GFLOP at 72 frames, is far below it.
// Untaken frames are not read. The kernel is not tuned: its loads are 12-byte
// strided and its shared-memory DCT passes are bank-conflicted (PERF.md §6).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// ITU-T T.81 Annex K base tables
__constant__ float kLuma[64] = {
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
__constant__ float kChroma[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// libjpeg quality scaling, as _jpeg_quality_table: q already clipped to [1, 100]
__device__ __forceinline__ float table_entry(float base, float q) {
  const float scale = q < 50.f ? 5000.f / q : 200.f - 2.f * q;
  return fminf(fmaxf(floorf((base * scale + 50.f) / 100.f), 1.f), 255.f);
}

__global__ void __launch_bounds__(kThreads)
    jpeg_mcu(float* __restrict__ x, const uint8_t* __restrict__ take,
             const float* __restrict__ quality, int h, int w, int mcu_w, int mcus) {
  const int n = blockIdx.x / mcus;
  if (!take[n]) return;
  const int m = blockIdx.x - n * mcus;
  const int my = m / mcu_w, mx = m - my * mcu_w;

  __shared__ float d[8][8];             // d[u][x], JAX's _dct8
  __shared__ float tab[2][64];          // luma, chroma quantization tables
  __shared__ float cfull[2][16][17];    // Cb, Cr at full resolution
  __shared__ float blk[6][8][8];        // luma 0-3, Cb, Cr: samples, then coefficients
  __shared__ float tmp[6][8][8];

  const int t = threadIdx.x, ty = t >> 4, tx = t & 15;
  if (t < 64) {
    const int u = t >> 3, xx = t & 7;
    const float c = u == 0 ? sqrtf(0.125f) : sqrtf(0.25f);
    d[u][xx] = cosf((2.f * static_cast<float>(xx) + 1.f) * static_cast<float>(u) *
                    0.19634954084936207f) * c;
  } else if (t < 192) {
    const float q = fminf(fmaxf(quality[n], 1.f), 100.f);
    const int i = t - 64;
    tab[i >> 6][i & 63] = table_entry(i < 64 ? kLuma[i] : kChroma[i - 64], q);
  }

  // 1. the pixel's Y, Cb, Cr
  float* p = x + ((static_cast<size_t>(n) * h + my * 16 + ty) * w + mx * 16 + tx) * 3;
  const float r = p[0] * 255.f, g = p[1] * 255.f, b = p[2] * 255.f;
  blk[(ty >> 3) * 2 + (tx >> 3)][ty & 7][tx & 7] = 0.299f * r + 0.587f * g + 0.114f * b - 128.f;
  cfull[0][ty][tx] = -0.168736f * r - 0.331264f * g + 0.5f * b + 128.f;
  cfull[1][ty][tx] = 0.5f * r - 0.418688f * g - 0.081312f * b + 128.f;
  __syncthreads();

  // 2. 4:2:0 chroma: the mean of each 2x2 cell
  if (t < 128) {
    const int c = t >> 6, i = (t >> 3) & 7, j = t & 7;
    const float s = cfull[c][2 * i][2 * j] + cfull[c][2 * i][2 * j + 1] +
                    cfull[c][2 * i + 1][2 * j] + cfull[c][2 * i + 1][2 * j + 1];
    blk[4 + c][i][j] = s / 4.f - 128.f;
  }
  __syncthreads();

  // 3. forward DCT (D B, then (D B) D^T) and quantization
  for (int e = t; e < 384; e += kThreads) {
    const int bi = e >> 6, u = (e >> 3) & 7, yy = e & 7;
    float s = 0.f;
    for (int k = 0; k < 8; ++k) s += d[u][k] * blk[bi][k][yy];
    tmp[bi][u][yy] = s;
  }
  __syncthreads();
  for (int e = t; e < 384; e += kThreads) {
    const int bi = e >> 6, u = (e >> 3) & 7, v = e & 7;
    float s = 0.f;
    for (int k = 0; k < 8; ++k) s += tmp[bi][u][k] * d[v][k];
    const float tq = tab[bi < 4 ? 0 : 1][u * 8 + v];
    blk[bi][u][v] = rintf(s / tq) * tq;
  }
  __syncthreads();

  // 4. inverse DCT (D^T Q, then (D^T Q) D), + 128
  for (int e = t; e < 384; e += kThreads) {
    const int bi = e >> 6, xx = (e >> 3) & 7, v = e & 7;
    float s = 0.f;
    for (int k = 0; k < 8; ++k) s += d[k][xx] * blk[bi][k][v];
    tmp[bi][xx][v] = s;
  }
  __syncthreads();
  for (int e = t; e < 384; e += kThreads) {
    const int bi = e >> 6, xx = (e >> 3) & 7, yy = e & 7;
    float s = 0.f;
    for (int k = 0; k < 8; ++k) s += tmp[bi][xx][k] * d[k][yy];
    blk[bi][xx][yy] = s + 128.f;
  }
  __syncthreads();

  // 5. back to RGB, the chroma by nearest upsample
  const float yv = blk[(ty >> 3) * 2 + (tx >> 3)][ty & 7][tx & 7];
  const float cb = blk[4][ty >> 1][tx >> 1] - 128.f, cr = blk[5][ty >> 1][tx >> 1] - 128.f;
  const float ro = yv + 1.402f * cr;
  const float go = yv - 0.344136f * cb - 0.714136f * cr;
  const float bo = yv + 1.772f * cb;
  p[0] = fminf(fmaxf(ro / 255.f, 0.f), 1.f);
  p[1] = fminf(fmaxf(go / 255.f, 0.f), 1.f);
  p[2] = fminf(fmaxf(bo / 255.f, 0.f), 1.f);
}

}  // namespace

extern "C" int fac_jpeg_subset(float* x, const uint8_t* take, const float* quality, int n,
                               int h, int w, cudaStream_t stream) {
  if (n <= 0) return 0;
  if (h % 16 || w % 16) return cudaErrorInvalidValue;
  const int mcu_w = w / 16, mcus = (h / 16) * mcu_w;
  const long long blocks = static_cast<long long>(n) * mcus;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  jpeg_mcu<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(x, take, quality, h, w,
                                                                  mcu_w, mcus);
  return static_cast<int>(cudaGetLastError());
}
