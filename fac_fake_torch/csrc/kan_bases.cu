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
// reads x (786 KB) and the grid (98 KB) and writes 6.29 MB of bases, so
// torch's copy_ of the outputs' bytes is the yardstick. PR 12's design ran
// the whole recursion for every (row, feature): 54 IEEE divisions and ~160
// other operations at order 3, issue-bound at 1.9x that copy_. Layout: a
// block of 256 threads takes 32 features x 8 rows; it stages its 32
// features' grid rows in shared memory (odd row stride: no bank conflicts),
// converted to fp32; each thread reads its x, keeps its L knots and L - 1
// bases in registers (the level loops unroll over the caps, every index a
// constant), and writes its L - 1 - k bases with 16-byte stores where they
// fill whole vectors (fp32: 2 stores of 4; bf16: 1 store of 8). The block
// walks the rows by a grid stride, so it loads its grid rows once; the
// grid is one wave of the blocks the card holds at once (at (96, 2048): 384
// blocks, 2 rows a thread), so no partial second wave runs after the first.
//
// Design: divide only on x's support. For a finite x inside a strictly
// increasing grid only the l + 1 bases j0 - l .. j0 of level l (the window;
// j0: the order-0 interval that holds x) can be nonzero, so the fast path
// makes (l + 1) x 2 IEEE divisions at level l (18 at order 3, against 54),
// and x below the first knot or at or past the last makes none:
//  * Per feature, once a block when its knots are staged: lim = min(dmin *
//    2^124, 2^126), dmin the least spacing R(g[j+1] - g[j]) in the dtype's
//    rounding; the feature takes the fast path when its knots are finite,
//    every spacing is > 0 and every |g| <= lim. Per value: |x| <= lim (false
//    for NaN and +-inf). Then every numerator x - g or g - x is at most 2^127,
//    every denominator at least dmin, so every quotient is finite (at most
//    2^125) and not NaN. An underflow does not matter: a zero times a finite
//    number is a zero.
//  * Bit-equal by construction: the window's bases are computed by the same
//    rounded operations as the full recursion, on the same inputs; a base
//    outside it is, in the full recursion, R(R(left * z1) + R(right * z2)),
//    z1 and z2 zeros of the level below and left, right finite: a zero.
//  * The zero's sign: left has the sign of x - g[j] and right that of
//    g[j+l+1] - x (their denominators are > 0, and a zero numerator keeps
//    its sign); a product with a zero is -0 iff the two signs differ, a sum
//    of two zeros is -0 iff both are. Order 0's zeros are +0; with z1 = z2 =
//    +0 the base is -0 only if x - g[j] and g[j+l+1] - x both carry a minus
//    sign, i.e. x <= g[j] and g[j+l+1] <= x, which a strictly increasing
//    grid rules out (g[j] < g[j+l+1]). So, level by level, every base
//    outside the window is +0, and the window's edges read +0 below them.
//  * Outside the fast path (a repeated knot's 0/0, an unsorted or non-finite
//    grid, a NaN or +-inf x, a magnitude beyond lim) the (row, feature) runs
//    the full recursion of PR 12's design: a branch on the card, not a
//    fallback.
// What bounds it now: its bytes, with copy_ of its outputs as the yardstick
// (0.0107 ms cold for a resvitkan forward's two calls on the H100, against
// the kernel's 0.0159: chip_smoke.py R1); what is left above it is the
// latency of the small (96, 64) call and of the division chains.
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
#include <math.h>
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

// The fast path's range for a feature's knots: lim, or -1 (every x takes the
// full recursion) unless the knots are finite, strictly increasing in the
// dtype's rounding and at most lim in magnitude.
template <typename R, int MAXL>
__device__ __forceinline__ float fast_limit(const float (&g)[MAXL], int L) {
  bool ok = true;
  float dmin = INFINITY, gmax = 0.0f;
#pragma unroll
  for (int j = 0; j < MAXL; ++j) {
    if (j < L) {
      ok &= isfinite(g[j]);
      gmax = fmaxf(gmax, fabsf(g[j]));
    }
  }
#pragma unroll
  for (int j = 0; j < MAXL - 1; ++j) {
    if (j < L - 1) {
      const float d = R::round(__fsub_rn(g[j + 1], g[j]));
      ok &= d > 0.0f;
      dmin = fminf(dmin, d);
    }
  }
  const float lim = fminf(__fmul_rn(dmin, 0x1p124f), 0x1p126f);
  return ok && gmax <= lim ? lim : -1.0f;
}

// left * b[j] + right * b[j+1] of base j at level l, each op rounded
template <typename R>
__device__ __forceinline__ float blend(float xv, float gj, float gj1, float gjl, float gjl1,
                                       float bj, float bj1) {
  const float left = R::round(__fdiv_rn(R::round(__fsub_rn(xv, gj)), R::round(__fsub_rn(gjl, gj))));
  const float right =
      R::round(__fdiv_rn(R::round(__fsub_rn(gjl1, xv)), R::round(__fsub_rn(gjl1, gj1))));
  return R::round(__fadd_rn(R::round(__fmul_rn(left, bj)), R::round(__fmul_rn(right, bj1))));
}

// The fast path: divisions on x's support alone, every other base +0.
// gs: the feature's knots in shared memory (read at run-time indices).
template <typename R, int MAXL, int MAXK>
__device__ __forceinline__ void support_bases(float xv, const float (&g)[MAXL], const float* gs,
                                              int L, int k, float (&b)[MAXL - 1]) {
  int cnt = 0;                                      // knots at or below x
#pragma unroll
  for (int j = 0; j < MAXL; ++j) cnt += j < L && xv >= g[j];
  const bool has = cnt >= 1 && cnt <= L - 1;       // g[j0] <= x < g[j0 + 1]
  const int j0 = has ? cnt - 1 : 0;
  float w[MAXK + 1];                                // bases j0 - l .. j0 of level l
  w[0] = 1.0f;
#pragma unroll
  for (int l = 1; l <= MAXK; ++l) {
    if (l > k) break;
#pragma unroll
    for (int t = l; t >= 0; --t) {                  // descending: w[t - 1] is still level l - 1
      const int jj = min(max(j0 - l + t, 0), L - 2 - l);   // a base past the ends is never read
      w[t] = blend<R>(xv, gs[jj], gs[jj + 1], gs[jj + l], gs[jj + l + 1],
                      t == 0 ? 0.0f : w[t - 1], t == l ? 0.0f : w[t]);
    }
  }
#pragma unroll
  for (int j = 0; j < MAXL - 1; ++j) {
    b[j] = 0.0f;
#pragma unroll
    for (int t = 0; t <= MAXK; ++t)
      if (t <= k && has && j == j0 - k + t) b[j] = w[t];
  }
}

// The full recursion over every base (PR 12's design)
template <typename R, int MAXL, int MAXK>
__device__ __forceinline__ void all_bases(float xv, const float (&g)[MAXL], int L, int k,
                                          float (&b)[MAXL - 1]) {
#pragma unroll
  for (int j = 0; j < MAXL - 1; ++j)
    b[j] = (j < L - 1 && xv >= g[j] && xv < g[j + 1]) ? 1.0f : 0.0f;
#pragma unroll
  for (int l = 1; l <= MAXK; ++l) {
    if (l > k) break;
#pragma unroll
    for (int j = 0; j < MAXL - 1 - l; ++j)
      if (j < L - 1 - l)
        b[j] = blend<R>(xv, g[j], g[j + 1], g[j + l], g[j + l + 1], b[j], b[j + 1]);
  }
}

// MAXL, MAXK: compile-time caps on the knots and the order; L, k at run time
template <typename T, int MAXL, int MAXK>
__global__ void __launch_bounds__(kThreads)
kan_bases_kernel(const T* __restrict__ x, const T* __restrict__ grid, T* __restrict__ out,
                 int B, int in, int L, int k) {
  constexpr int kStride = MAXL | 1;                 // odd: conflict-free reads
  __shared__ float s_g[kFeatures * kStride];
  __shared__ float s_lim[kFeatures];               // a feature's fast-path range
  using R = Io<T>;

  const int tx = threadIdx.x % kFeatures, ty = threadIdx.x / kFeatures;
  const int i0 = blockIdx.x * kFeatures;
  const int nf = min(kFeatures, in - i0);
  const T* G = grid + static_cast<size_t>(i0) * L;  // the block's rows, contiguous
  for (int t = threadIdx.x; t < nf * L; t += kThreads)
    s_g[(t / L) * kStride + t % L] = R::load(G + t);
  __syncthreads();
  const float* gs = s_g + tx * kStride;
  float g[MAXL];
#pragma unroll
  for (int j = 0; j < MAXL; ++j) g[j] = j < L ? gs[j] : 0.0f;
  if (ty == 0 && tx < nf) s_lim[tx] = fast_limit<R>(g, L);   // once a feature
  __syncthreads();
  if (tx >= nf) return;

  const int i = i0 + tx;
  const int nb = L - 1 - k;
  const float lim = s_lim[tx];

  for (int r = blockIdx.y * kRows + ty; r < B; r += gridDim.y * kRows) {
    const size_t at = static_cast<size_t>(r) * in + i;
    const float xv = R::load(x + at);
    float b[MAXL - 1];
    if (fabsf(xv) <= lim)
      support_bases<R, MAXL, MAXK>(xv, g, gs, L, k, b);
    else
      all_bases<R, MAXL, MAXK>(xv, g, L, k, b);
    store(out + at * nb, b, nb);
  }
}

// One wave: the row blocks are cut to what the card holds at once beside the
// feature blocks (each block strides over its rows), so no second, partial
// wave runs after the first.
template <typename T, int MAXL, int MAXK>
cudaError_t launch_one(const T* xp, const T* gp, T* op, int B, int in, int L, int k,
                       cudaStream_t stream) {
  static int resident = 0;                          // blocks the card holds at once
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kan_bases_kernel<T, MAXL, MAXK>, kThreads, 0);
    if (err != cudaSuccess) return err;
    resident = sms * per_sm;
  }
  const int fb = (in + kFeatures - 1) / kFeatures;
  const int row_blocks = (B + kRows - 1) / kRows;
  int gy = resident / fb;
  gy = gy < row_blocks ? gy : row_blocks;
  gy = gy < kMaxRowsGrid ? gy : kMaxRowsGrid;
  gy = gy < 1 ? 1 : gy;
  kan_bases_kernel<T, MAXL, MAXK><<<dim3(fb, gy), kThreads, 0, stream>>>(xp, gp, op, B, in, L, k);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* grid, void* out, int B, int in, int L, int k,
                   cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const T* gp = static_cast<const T*>(grid);
  T* op = static_cast<T*>(out);
  if (L <= 12 && k <= 3)   // the KAN heads' G = 5, k = 3
    return launch_one<T, 12, 3>(xp, gp, op, B, in, L, k, stream);
  return launch_one<T, kMaxKnots, kMaxOrder>(xp, gp, op, B, in, L, k, stream);
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
