// K9: KAN's B-spline bases -- one thread per (row, feature).
//
// Replaces: fac_fake_tpu/models/blocks/kan.py b_splines, called from
// KANLinear.__call__ for x (B, in) over a per-feature grid (in, L), L = G +
// 2k + 1 knots: the order-0 indicator bases, then k Cox-de Boor levels, each
// two divisions and a blend. XLA fuses the recursion into one pass; eager
// PyTorch runs ~25 elementwise launches a layer and writes every level to
// memory. The result, (B, in, L - 1 - k) contiguous, is the A operand of the
// spline GEMM (B, in * (L - 1 - k)) that follows.
//
// Bound on the H100: bytes. At (96, 2048) with G = 5, k = 3 the function
// reads x (786 KB) and the grid (98 KB) and writes 6.29 MB of bases; ~7
// operations an output a level are far under the card's fp32 rate. Design:
// a block of 256 threads takes 32 features x 8 rows; it stages its 32
// features' grid rows in shared memory (odd row stride: no bank conflicts),
// converted to fp32; each thread reads its x, keeps its L knots and L - 1
// bases in registers (the level loops unroll over the caps, every index a
// constant), and writes its L - 1 - k bases with 16-byte stores where they
// fill whole vectors (fp32: 2 stores of 4; bf16: 1 store of 8). The block
// walks the rows by a grid stride, so it loads its grid rows once.
//
// Semantics kept from the plain version (PyTorch's elementwise kernels, one
// op each), bit for bit:
//  * the grid is read as given: per feature, no uniform spacing assumed;
//  * order 0: (x >= g[j]) & (x < g[j+1]), half open: x at or past the last
//    knot, below the first, or NaN gives all zeros;
//  * level l, for j < L - 1 - l: left = (x - g[j]) / (g[j+l] - g[j]),
//    right = (g[j+l+1] - x) / (g[j+l+1] - g[j+1]), b[j] = left*b[j] +
//    right*b[j+1]: IEEE division (__fdiv_rn, never a reciprocal multiply),
//    each product rounded before the sum (-fmad=false, and the _rn
//    intrinsics), so a repeated knot gives 0/0 = NaN as there;
//  * bf16: PyTorch computes each bf16 op in fp32 and rounds its result to
//    bf16, so every intermediate here is rounded to bf16 (round to nearest
//    even) at the same places; nothing is carried in fp32 across two ops.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFeatures = 32;        // features a block (one warp's worth)
constexpr int kRows = 8;             // rows a block a step
constexpr int kThreads = kFeatures * kRows;
constexpr int kMaxKnots = 16;        // the cap on L
constexpr int kMaxOrder = 5;         // the cap on k
constexpr int kMaxRowsGrid = 65535;

template <typename T> struct Io;

template <> struct Io<float> {
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ float round(float v) { return v; }
};

template <> struct Io<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

// nb bases (already rounded to T) to dst; 16-byte stores where nb fills them
template <int N>
__device__ __forceinline__ void store(float* dst, const float (&b)[N], int nb) {
  if ((nb & 3) == 0) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q)
      if (4 * q < nb)
        reinterpret_cast<float4*>(dst)[q] = make_float4(b[4 * q], b[4 * q + 1], b[4 * q + 2],
                                                        b[4 * q + 3]);
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (j < nb) dst[j] = b[j];
  }
}

template <int N>
__device__ __forceinline__ void store(__nv_bfloat16* dst, const float (&b)[N], int nb) {
  if ((nb & 7) == 0) {
#pragma unroll
    for (int q = 0; q < N / 8; ++q)
      if (8 * q < nb) {
        uint32_t w[4];
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const __nv_bfloat162 p = __halves2bfloat162(__float2bfloat16_rn(b[8 * q + 2 * h]),
                                                      __float2bfloat16_rn(b[8 * q + 2 * h + 1]));
          w[h] = *reinterpret_cast<const uint32_t*>(&p);
        }
        reinterpret_cast<uint4*>(dst)[q] = make_uint4(w[0], w[1], w[2], w[3]);
      }
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (j < nb) dst[j] = __float2bfloat16_rn(b[j]);
  }
}

// MAXL, MAXK: compile-time caps on the knots and the order; L, k at run time
template <typename T, int MAXL, int MAXK>
__global__ void __launch_bounds__(kThreads)
kan_bases_kernel(const T* __restrict__ x, const T* __restrict__ grid, T* __restrict__ out,
                 int B, int in, int L, int k) {
  constexpr int kStride = MAXL | 1;                 // odd: conflict-free reads
  __shared__ float s_g[kFeatures * kStride];
  using R = Io<T>;

  const int tx = threadIdx.x % kFeatures, ty = threadIdx.x / kFeatures;
  const int i0 = blockIdx.x * kFeatures;
  const int nf = min(kFeatures, in - i0);
  const T* G = grid + static_cast<size_t>(i0) * L;  // the block's rows, contiguous
  for (int t = threadIdx.x; t < nf * L; t += kThreads)
    s_g[(t / L) * kStride + t % L] = R::load(G + t);
  __syncthreads();
  if (tx >= nf) return;

  const int i = i0 + tx;
  const int nb = L - 1 - k;
  float g[MAXL];
#pragma unroll
  for (int j = 0; j < MAXL; ++j) g[j] = j < L ? s_g[tx * kStride + j] : 0.0f;

  for (int r = blockIdx.y * kRows + ty; r < B; r += gridDim.y * kRows) {
    const size_t at = static_cast<size_t>(r) * in + i;
    const float xv = R::load(x + at);
    float b[MAXL - 1];
#pragma unroll
    for (int j = 0; j < MAXL - 1; ++j)
      b[j] = (j < L - 1 && xv >= g[j] && xv < g[j + 1]) ? 1.0f : 0.0f;
#pragma unroll
    for (int l = 1; l <= MAXK; ++l) {
      if (l > k) break;
#pragma unroll
      for (int j = 0; j < MAXL - 1 - l; ++j) {
        if (j < L - 1 - l) {
          const float left = R::round(__fdiv_rn(R::round(__fsub_rn(xv, g[j])),
                                                R::round(__fsub_rn(g[j + l], g[j]))));
          const float right = R::round(__fdiv_rn(R::round(__fsub_rn(g[j + l + 1], xv)),
                                                 R::round(__fsub_rn(g[j + l + 1], g[j + 1]))));
          b[j] = R::round(__fadd_rn(R::round(__fmul_rn(left, b[j])),
                                    R::round(__fmul_rn(right, b[j + 1]))));
        }
      }
    }
    store(out + at * nb, b, nb);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* grid, void* out, int B, int in, int L, int k,
                   cudaStream_t stream) {
  const int row_blocks = (B + kRows - 1) / kRows;
  const dim3 blocks((in + kFeatures - 1) / kFeatures,
                    row_blocks < kMaxRowsGrid ? row_blocks : kMaxRowsGrid);
  const T* xp = static_cast<const T*>(x);
  const T* gp = static_cast<const T*>(grid);
  T* op = static_cast<T*>(out);
  if (L <= 12 && k <= 3)   // the KAN heads' G = 5, k = 3
    kan_bases_kernel<T, 12, 3><<<blocks, kThreads, 0, stream>>>(xp, gp, op, B, in, L, k);
  else
    kan_bases_kernel<T, kMaxKnots, kMaxOrder><<<blocks, kThreads, 0, stream>>>(
        xp, gp, op, B, in, L, k);
  return cudaGetLastError();
}

}  // namespace

// x (B, in), grid (in, L), out (B, in, L - 1 - k), all contiguous on the
// device in one dtype: fp32 (bf16 = 0) or bf16 (bf16 = 1). 0 <= k <= 5,
// k + 2 <= L <= 16; out 16-byte aligned.
extern "C" int fac_kan_bases(const void* x, const void* grid, void* out, int B, int in, int L,
                             int k, int bf16, void* stream) {
  if (B < 0 || in < 0 || k < 0 || k > kMaxOrder || L < k + 2 || L > kMaxKnots)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || in == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = bf16 ? launch<__nv_bfloat16>(x, grid, out, B, in, L, k, s)
                               : launch<float>(x, grid, out, B, in, L, k, s);
  return static_cast<int>(err);
}
