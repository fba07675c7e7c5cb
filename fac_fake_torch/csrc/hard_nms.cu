// K8: greedy hard NMS over a padded candidate set -- one CTA per call.
//
// Replaces: fac_fake_tpu/detect/mtcnn.py hard_nms (with _iou), the MTCNN
// cascade's lax.scan of max_out steps. In eager PyTorch the same scan is
// about fifteen small launches a step (argmax, IoU, suppression), for each of
// up to 128 steps.
//
// Bound on the H100: latency. A frame of the cascade reads under 100 KB of
// candidates over its four calls, and tests at most ~300k IoUs (about 5
// MFLOP): both well under a microsecond. The steps are sequential, each an
// argmax over the call's live scores, so the chain of reductions sets the
// time. Design: one CTA per call (blockIdx.x = call), so one launch takes a
// frame's per-scale pyramid calls; threads = N / 4 rounded up to a warp
// (32..512), each thread keeping up to 8 candidates (tid + k * threads) in
// registers: box, +1 area, order key, live bit. The boxes also sit in
// shared memory, where every thread reads the seed's.
//  * A step: one reduction of the order keys gives the seed (warp shuffles;
//    with more than one warp, one exchange through shared memory,
//    double-buffered by step, and one barrier); thread 0 writes (seed, keep);
//    every thread tests its live candidates against the seed and suppresses
//    those above the threshold and the seed itself, updating their keys.
//  * A call whose N fits one warp (N <= 128) runs with no barrier at all.
//  * When the best key is that of -inf, no live score is left: the rest of
//    the slots are (0, not kept), as the scan's argmax of an all -inf row,
//    and the CTA writes them and stops.
//
// Semantics kept from the JAX scan, bit for bit:
//  * s0 = valid ? score : -inf; argmax in jnp.argmax order -- NaN first,
//    then the largest score (-0 as +0), ties to the lowest index -- as one
//    unsigned 64-bit key: the score's bits mapped to an unsigned order above
//    the complemented index;
//  * keep = s[seed] > -inf (a NaN seed is not kept, and still suppresses);
//  * IoU = inter / max(denom, 1e-12) in IEEE fp32 in JAX's order: (ix2 - ix1)
//    + 1 clamped at 0 on each axis, their product; the +1 areas; denom
//    (area_seed + area) - inter (union) or min(area_seed, area) (min); max
//    and min propagate NaN as jnp.maximum / jnp.minimum do; '>' against the
//    fp32 threshold;
//  * the seed is always suppressed, even when its own IoU fails (a zero-area,
//    inverted or NaN box).
// IoU(i, j) is bitwise symmetric (max, min and + commute in IEEE), so testing
// each candidate against the seed gives the scan's values. Built with
// -fmad=false: no product is contracted into an FMA.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxPer = 8;                            // candidates a thread
constexpr int kMaxN = kMaxThreads * kMaxPer;          // 4096
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxSmem = kMaxN * static_cast<int>(sizeof(float4));
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNanOrder = 0xffffffffu;           // the order bits of any NaN
constexpr unsigned kNegInfOrder = 0x007fffffu;        // the order bits of -inf

__device__ __forceinline__ float nan_max(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

__device__ __forceinline__ float nan_min(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fc00000) : fminf(a, b);
}

// jnp.argmax order as one unsigned 64-bit key, larger = better: NaN above
// every number, then the score's order (-0 as +0), then the lower index.
// 0 is below every candidate's key.
__device__ __forceinline__ unsigned long long order_key(float v, int idx) {
  unsigned u = kNanOrder;
  if (!isnan(v)) {
    u = __float_as_uint(v == 0.0f ? 0.0f : v);
    u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  }
  return (static_cast<unsigned long long>(u) << 32) | (~static_cast<unsigned>(idx));
}

__device__ __forceinline__ unsigned long long warp_max(unsigned long long k) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long ok = __shfl_xor_sync(kFull, k, o);
    k = ok > k ? ok : k;
  }
  return k;
}

// (x2 - x1 + 1) * (y2 - y1 + 1), JAX's +1 area
__device__ __forceinline__ float area_of(float x1, float y1, float x2, float y2) {
  return __fmul_rn(__fadd_rn(__fsub_rn(x2, x1), 1.0f), __fadd_rn(__fsub_rn(y2, y1), 1.0f));
}

// _iou(seed, box) > thresh, in JAX's order
__device__ __forceinline__ bool above(const float4 s, float s_area, float x1, float y1,
                                      float x2, float y2, float area, float thresh,
                                      int mode_min) {
  const float ix1 = nan_max(s.x, x1), iy1 = nan_max(s.y, y1);
  const float ix2 = nan_min(s.z, x2), iy2 = nan_min(s.w, y2);
  const float inter = __fmul_rn(nan_max(0.0f, __fadd_rn(__fsub_rn(ix2, ix1), 1.0f)),
                                nan_max(0.0f, __fadd_rn(__fsub_rn(iy2, iy1), 1.0f)));
  const float denom = mode_min ? nan_min(s_area, area) : __fsub_rn(__fadd_rn(s_area, area), inter);
  return __fdiv_rn(inter, nan_max(denom, 1e-12f)) > thresh;
}

__global__ void __launch_bounds__(kMaxThreads)
hard_nms_kernel(const float* __restrict__ boxes, const float* __restrict__ scores,
                const uint8_t* __restrict__ valid, int N, int per, int max_out, float thresh,
                int mode_min, long long* __restrict__ idx_out, uint8_t* __restrict__ keep_out) {
  extern __shared__ float4 s_box[];                   // the call's N boxes
  __shared__ unsigned long long s_key[2][kMaxWarps];  // a warp's best key, by step parity

  const int g = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x, nwarps = nthreads >> 5;
  const float* B = boxes + static_cast<size_t>(g) * N * 4;
  const float* S = scores + static_cast<size_t>(g) * N;
  const uint8_t* V = valid + static_cast<size_t>(g) * N;
  long long* I = idx_out + static_cast<size_t>(g) * max_out;
  uint8_t* K = keep_out + static_cast<size_t>(g) * max_out;

  float x1[kMaxPer], y1[kMaxPer], x2[kMaxPer], y2[kMaxPer], area[kMaxPer];
  unsigned long long key[kMaxPer];
  unsigned live = 0;
  unsigned long long best = 0;
#pragma unroll
  for (int k = 0; k < kMaxPer; ++k) {
    const int a = tid + k * nthreads;
    key[k] = 0;
    x1[k] = y1[k] = x2[k] = y2[k] = area[k] = 0.0f;
    if (k < per && a < N) {
      x1[k] = B[4 * a];
      y1[k] = B[4 * a + 1];
      x2[k] = B[4 * a + 2];
      y2[k] = B[4 * a + 3];
      s_box[a] = make_float4(x1[k], y1[k], x2[k], y2[k]);
      area[k] = area_of(x1[k], y1[k], x2[k], y2[k]);
      const float s = V[a] ? S[a] : -INFINITY;
      key[k] = order_key(s, a);
      if (isnan(s) || s > -INFINITY) live |= 1u << k;
      best = key[k] > best ? key[k] : best;
    }
  }
  if (nwarps > 1) __syncthreads();   // s_box complete (one warp: shuffles order it)
  __syncwarp();

  int p = 0;
  for (int step = 0; step < max_out; ++step) {
    unsigned long long seed_key = warp_max(best);
    if (nwarps > 1) {
      if (lane == 0) s_key[p][warp] = seed_key;
      __syncthreads();
      seed_key = warp_max(lane < nwarps ? s_key[p][lane] : 0ull);
      p ^= 1;
    }
    const unsigned bits = static_cast<unsigned>(seed_key >> 32);
    if (bits == kNegInfOrder) {   // no live score left: (0, not kept) to the end
      for (int t = step + tid; t < max_out; t += nthreads) {
        I[t] = 0;
        K[t] = 0;
      }
      return;
    }
    const int seed = static_cast<int>(~static_cast<unsigned>(seed_key));
    if (tid == 0) {
      I[step] = seed;
      K[step] = bits != kNanOrder;
    }
    const float4 sb = s_box[seed];
    const float s_area = area_of(sb.x, sb.y, sb.z, sb.w);
    best = 0;
#pragma unroll
    for (int k = 0; k < kMaxPer; ++k) {
      if ((live >> k) & 1u) {
        const int a = tid + k * nthreads;
        if (a == seed || above(sb, s_area, x1[k], y1[k], x2[k], y2[k], area[k], thresh, mode_min)) {
          live &= ~(1u << k);
          key[k] = order_key(-INFINITY, a);
        }
      }
      best = key[k] > best ? key[k] : best;
    }
  }
}

cudaError_t set_smem_once() {
  static const cudaError_t err = cudaFuncSetAttribute(
      hard_nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  return err;
}

}  // namespace

// boxes (G, N, 4) fp32 x1y1x2y2, scores (G, N) fp32, valid (G, N) bool, all on
// the device; idx (G, max_out) int64 and keep (G, max_out) bool written.
// mode_min: 0 = union, 1 = min denominator. 1 <= N <= 4096.
extern "C" int fac_hard_nms(const float* boxes, const float* scores, const uint8_t* valid,
                            int G, int N, int max_out, float thresh, int mode_min,
                            long long* idx, uint8_t* keep, void* stream) {
  if (N < 1 || N > kMaxN || G < 0 || max_out < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = set_smem_once();
  if (err != cudaSuccess) return static_cast<int>(err);
  int threads = ((N + 3) / 4 + 31) / 32 * 32;
  threads = threads < 32 ? 32 : (threads > kMaxThreads ? kMaxThreads : threads);
  const int per = (N + threads - 1) / threads;
  if (G > 0) {
    const size_t smem = static_cast<size_t>(N) * sizeof(float4);
    hard_nms_kernel<<<G, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        boxes, scores, valid, N, per, max_out, thresh, mode_min, idx, keep);
  }
  return static_cast<int>(cudaGetLastError());
}
