// K8: greedy hard NMS over a padded candidate set -- one CTA per call.
//
// Replaces: fac_fake_tpu/detect/mtcnn.py hard_nms (with _iou), the MTCNN
// cascade's lax.scan of max_out steps. In eager PyTorch the same scan is
// about fifteen small launches a step (argmax, IoU, suppression), for each of
// up to 128 steps.
//
// Bound on the H100: latency. A frame of the cascade reads under 100 KB of
// candidates over its four calls, and tests at most ~300k IoUs (about 5
// MFLOP): both far under a microsecond. The scan is a chain of max_out
// dependent argmaxes; taken literally (PR 11's design) it is one block-wide
// reduction and barrier a step, ~1 us each, 288 a frame. Design: the greedy
// result is a fixed sweep in score order, so the argmax chain goes.
//  * Keys and sort. Each candidate's order key (below) is built once; the
//    live ones (valid, score above -inf or NaN) are packed into shared memory
//    and sorted once, descending: a warp sorts each 64-key run in registers
//    (a bitonic network, by shuffles), then the runs are merged in pairs by
//    rank, one barrier a level (a key's place: its index in its run plus a
//    binary search in the partner run), O(L log L) reads in all. The keys
//    are distinct, so the sorted order is the scan's seed order.
//  * Tiles. The sorted list is swept in tiles of 32 (a warp's lanes, a
//    32-bit mask), by one CTA of 512 threads whatever N. For each tile, in
//    one parallel phase: every warp tests the tile's 32 candidates against
//    its share of the seeds emitted so far (the removed bits, by ballot), and
//    builds its share of the tile's upper triangle: bit j of row i (i before
//    j) is _iou(box_i, box_j) > thresh, the earlier box as the seed. One
//    barrier; warp 0 then resolves the tile by bit operations alone, in
//    rounds of two OR-reductions: a candidate whose earlier suppressors in
//    the tile are all decided is decided too (removed if an emitted one
//    suppresses it, else emitted), so a round decides at least the first
//    undecided candidate, and most tiles take one or two. The emitted ones
//    write (idx, keep) at their places. One barrier, and the next tile.
//  * Stop. When max_out seeds are emitted or the live list ends; the rest of
//    the slots are (0, not kept), as the scan's argmax of an all -inf row.
// A call's dependent chain is ~2 barriers a tile reached plus a few rounds
// of warp reductions, instead of max_out block-wide reductions; the IoU
// tests stay bounded by (tiles reached x 32) x seeds, plus one triangle a
// tile, and a candidate after the last tile reached is never tested. A pair
// of boxes that does not meet is decided without a division.
//
// Semantics kept from the JAX scan, bit for bit:
//  * s0 = valid ? score : -inf; argmax in jnp.argmax order -- NaN first,
//    then the largest score (-0 as +0), ties to the lowest index -- as one
//    unsigned 64-bit key: the score's bits mapped to an unsigned order above
//    the complemented index;
//  * keep = s[seed] > -inf (a NaN seed is not kept, and still suppresses);
//  * IoU = inter / max(denom, 1e-12) in IEEE fp32 in JAX's order: (ix2 - ix1)
//    + 1 clamped at 0 on each axis, their product; the +1 areas (a zero-area
//    or inverted box too); denom (area_seed + area) - inter (union) or
//    min(area_seed, area) (min); max and min propagate NaN as jnp.maximum /
//    jnp.minimum do, so a NaN box suppresses nothing; '>' against the fp32
//    threshold;
//  * the seed is always removed, even when its own IoU fails (a zero-area,
//    inverted or NaN box);
//  * max_out may be 0 or above the live count; the G calls of a launch may
//    have different live counts.
// IoU(i, j) is bitwise symmetric (max, min and + commute in IEEE), so the
// sweep's pair tests give the scan's values. Built with -fmad=false: no
// product is contracted into an FMA.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;                         // a CTA, whatever N
constexpr int kWarps = kThreads / 32;
constexpr int kMaxN = 4096;
constexpr int kPer = kMaxN / kThreads;                // candidates a thread
constexpr int kTile = 32;                             // candidates a tile: a warp's lanes
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNanOrder = 0xffffffffu;           // the order bits of any NaN
using Key = unsigned long long;

__host__ __device__ constexpr int round64(int n) { return (n + 63) & ~63; }

// jnp.maximum / jnp.minimum: NaN if either is NaN (one instruction each; a
// zero's sign never reaches a result here)
__device__ __forceinline__ float nan_max(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float nan_min(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// jnp.argmax order as one unsigned 64-bit key, larger = better: NaN above
// every number, then the score's order (-0 as +0), then the lower index.
// 0 is below every candidate's key.
__device__ __forceinline__ Key order_key(float v, int idx) {
  unsigned u = kNanOrder;
  if (!isnan(v)) {
    u = __float_as_uint(v == 0.0f ? 0.0f : v);
    u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  }
  return (static_cast<Key>(u) << 32) | (~static_cast<unsigned>(idx));
}

// (x2 - x1 + 1) * (y2 - y1 + 1), JAX's +1 area
__device__ __forceinline__ float area_of(const float4 b) {
  return __fmul_rn(__fadd_rn(__fsub_rn(b.z, b.x), 1.0f), __fadd_rn(__fsub_rn(b.w, b.y), 1.0f));
}

// _iou(seed, box) > thresh, in JAX's order. Most pairs do not meet: with
// inter = 0 the quotient 0 / max(denom, 1e-12) is a zero, or NaN when denom
// is, so the test needs no division (whose zero numerator would leave the
// IEEE division's fast path), and a zero's sign cannot change '>'.
__device__ __forceinline__ bool above(const float4 s, float s_area, const float4 b, float area,
                                      float thresh, int mode_min) {
  const float ix1 = nan_max(s.x, b.x), iy1 = nan_max(s.y, b.y);
  const float ix2 = nan_min(s.z, b.z), iy2 = nan_min(s.w, b.w);
  const float inter = __fmul_rn(nan_max(0.0f, __fadd_rn(__fsub_rn(ix2, ix1), 1.0f)),
                                nan_max(0.0f, __fadd_rn(__fsub_rn(iy2, iy1), 1.0f)));
  const float denom = mode_min ? nan_min(s_area, area) : __fsub_rn(__fadd_rn(s_area, area), inter);
  const float d = nan_max(denom, 1e-12f);
  if (inter == 0.0f) return !isnan(d) && 0.0f > thresh;
  return __fdiv_rn(inter, d) > thresh;
}

__device__ __forceinline__ Key keep_hi(Key a, Key b, bool hi) {
  return hi == (a > b) ? a : b;
}

// The bitonic stages j = jtop .. 1 of merge size k on the 64 keys of a run
// that a warp holds, two a lane (places lane and lane + 32); the run's
// last merge (k = 64) leaves it descending.
__device__ __forceinline__ void warp_stages(Key& a0, Key& a1, int lane, int k, int jtop) {
  for (int j = jtop; j > 0; j >>= 1) {
    if (j == 32) {
      const bool desc = (lane & k) == 0;
      const Key hi = a0 > a1 ? a0 : a1, lo = a0 > a1 ? a1 : a0;
      a0 = desc ? hi : lo;
      a1 = desc ? lo : hi;
    } else {
      const Key b0 = __shfl_xor_sync(kFull, a0, j), b1 = __shfl_xor_sync(kFull, a1, j);
      const bool lower = (lane & j) == 0;
      a0 = keep_hi(a0, b0, lower == ((lane & k) == 0));
      a1 = keep_hi(a1, b1, lower == (((lane + 32) & k) == 0));
    }
  }
}

// s_key[0, Q) sorted descending, Q a multiple of 64, the keys distinct; the
// result in s_key or s_tmp, whichever is returned. A warp sorts each 64-key
// run in registers (the bitonic network above, every run descending); then
// the runs are merged in pairs, twice as long each level: a key's place is
// its index in its run plus the number of keys above it in the partner run
// (a binary search there), written to the other buffer. One barrier a level.
__device__ Key* sort_desc(Key* s_key, Key* s_tmp, int Q, int tid, int lane, int warp) {
  for (int m = warp; m < Q / 64; m += kWarps) {
    Key a0 = s_key[64 * m + lane], a1 = s_key[64 * m + lane + 32];
    for (int k = 2; k <= 64; k <<= 1) warp_stages(a0, a1, lane, k, k >> 1);
    s_key[64 * m + lane] = a0;
    s_key[64 * m + lane + 32] = a1;
  }
  __syncthreads();
  Key* src = s_key;
  Key* dst = s_tmp;
  for (int r = 64; r < Q; r <<= 1) {
    for (int e = tid; e < Q; e += kThreads) {
      const int i = e & (r - 1), run = e - i;       // run: its first index
      const int part = run ^ r;                     // the partner run's first index
      const Key x = src[e];
      int lo = 0, hi = max(0, min(r, Q - part));    // partner keys above x: [0, lo)
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (src[part + mid] > x) lo = mid + 1; else hi = mid;
      }
      dst[(run & ~r) + i + lo] = x;
    }
    __syncthreads();
    Key* t = src;
    src = dst;
    dst = t;
  }
  return src;
}

// Dynamic shared memory: the call's N boxes by index, the emitted seeds'
// boxes (at most S = min(max_out, N)), the sort's two key buffers (N rounded
// up to 64 each).
__global__ void __launch_bounds__(kThreads)
hard_nms_kernel(const float* __restrict__ boxes, const float* __restrict__ scores,
                const uint8_t* __restrict__ valid, int N, int S, int max_out, float thresh,
                int mode_min, long long* __restrict__ idx_out, uint8_t* __restrict__ keep_out) {
  extern __shared__ float4 s_box[];
  float4* s_seed = s_box + N;
  Key* s_key = reinterpret_cast<Key*>(s_seed + S);
  Key* s_tmp = s_key + round64(N);
  __shared__ unsigned s_rows[kTile];                  // the tile's triangle, a row a candidate
  __shared__ unsigned s_part[kWarps];                 // a warp's removed bits of the tile
  __shared__ int s_live, s_emitted;

  const int g = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* B = boxes + static_cast<size_t>(g) * N * 4;
  const float* Sc = scores + static_cast<size_t>(g) * N;
  const uint8_t* V = valid + static_cast<size_t>(g) * N;
  long long* I = idx_out + static_cast<size_t>(g) * max_out;
  uint8_t* K = keep_out + static_cast<size_t>(g) * max_out;
  if (max_out == 0) return;

  // boxes to shared memory (every load issued first); the live keys packed,
  // in no order, a warp's at a time
  if (tid == 0) s_live = 0;
  float s[kPer];
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int a = tid + q * kThreads;
    s[q] = -INFINITY;
    if (a < N) {
      s_box[a] = make_float4(B[4 * a], B[4 * a + 1], B[4 * a + 2], B[4 * a + 3]);
      const float v = Sc[a];
      if (V[a]) s[q] = v;
    }
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    if (q * kThreads >= N) break;
    const bool live = isnan(s[q]) || s[q] > -INFINITY;
    const unsigned m = __ballot_sync(kFull, live);
    int base = 0;
    if (lane == 0 && m) base = atomicAdd(&s_live, __popc(m));
    base = __shfl_sync(kFull, base, 0);
    if (live) s_key[base + __popc(m & ((1u << lane) - 1u))] = order_key(s[q], tid + q * kThreads);
  }
  __syncthreads();
  const int L = s_live, Q = round64(L);
  // padding: distinct keys below every live key
  for (int r = L + tid; r < Q; r += kThreads) s_key[r] = static_cast<Key>(Q - r);
  __syncthreads();
  const Key* keys = L > 0 ? sort_desc(s_key, s_tmp, Q, tid, lane, warp) : s_key;

  int E = 0;                                          // seeds emitted
  for (int t0 = 0; t0 < L && E < max_out; t0 += kTile) {
    // this lane's candidate of the tile
    const int n_in = min(kTile, L - t0);
    const bool in = lane < n_in;
    const Key key = in ? keys[t0 + lane] : 0;
    const unsigned cidx = ~static_cast<unsigned>(key);
    const float4 cb = in ? s_box[cidx] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const float ca = area_of(cb);
    // removed by a seed of an earlier tile: this warp's share of the seeds
    bool hit = false;
#pragma unroll 4
    for (int e = warp; e < E; e += kWarps) {
      const float4 sb = s_seed[e];
      hit |= above(sb, area_of(sb), cb, ca, thresh, mode_min);
    }
    const unsigned part = __ballot_sync(kFull, in && hit);
    // the tile's triangle: this warp's share of the rows
    for (int i = warp; i < n_in; i += kWarps) {
      const float4 bi = make_float4(__shfl_sync(kFull, cb.x, i), __shfl_sync(kFull, cb.y, i),
                                    __shfl_sync(kFull, cb.z, i), __shfl_sync(kFull, cb.w, i));
      const float ai = __shfl_sync(kFull, ca, i);
      const unsigned row =
          __ballot_sync(kFull, in && lane > i && above(bi, ai, cb, ca, thresh, mode_min));
      if (lane == 0) s_rows[i] = row;
    }
    if (lane == 0) s_part[warp] = part;
    __syncthreads();
    if (warp == 0) {
      // resolve the tile by bit operations, in rounds: a candidate whose
      // earlier suppressors are all decided is decided too (removed if an
      // emitted one suppresses it, else emitted), so the first undecided
      // candidate is decided every round
      const unsigned removed = __reduce_or_sync(kFull, lane < kWarps ? s_part[lane] : 0u);
      const unsigned row = in ? s_rows[lane] : 0u;
      const unsigned bit = 1u << lane;
      bool undecided = in && !(removed & bit), emitted = false;
      while (__any_sync(kFull, undecided)) {
        const unsigned by_emitted = __reduce_or_sync(kFull, emitted ? row : 0u);
        const unsigned by_undecided = __reduce_or_sync(kFull, undecided ? row : 0u);
        if (undecided && ((by_emitted & bit) || !(by_undecided & bit))) {
          undecided = false;
          emitted = !(by_emitted & bit);
        }
      }
      const unsigned em = __ballot_sync(kFull, emitted);
      const int e = E + __popc(em & (bit - 1u));
      if (emitted && e < max_out) {
        s_seed[e] = cb;
        I[e] = cidx;
        K[e] = static_cast<unsigned>(key >> 32) != kNanOrder;
      }
      if (lane == 0) s_emitted = min(max_out, E + __popc(em));
    }
    __syncthreads();
    E = s_emitted;
  }
  // no live score left: (0, not kept) to the end
  for (int t = E + tid; t < max_out; t += kThreads) {
    I[t] = 0;
    K[t] = 0;
  }
}

size_t smem_bytes(int N, int S) {
  return static_cast<size_t>(N + S) * sizeof(float4) +
         2 * static_cast<size_t>(round64(N)) * sizeof(Key);
}

cudaError_t set_smem_once() {
  static const cudaError_t err = cudaFuncSetAttribute(
      hard_nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes(kMaxN, kMaxN)));
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
  const int S = max_out < N ? max_out : N;
  if (G > 0) {
    hard_nms_kernel<<<G, kThreads, smem_bytes(N, S), static_cast<cudaStream_t>(stream)>>>(
        boxes, scores, valid, N, S, max_out, thresh, mode_min, idx, keep);
  }
  return static_cast<int>(cudaGetLastError());
}
