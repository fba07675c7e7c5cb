// K1: fused frame detections -- tile->frame affine, 8-step weighted NMS,
// margin clamp -- one CTA per frame.
//
// Replaces: fac_fake_tpu/detect/extractor.py _frame_detections and the
// fac_fake_tpu/detect/blazeface.py weighted_nms lax.scan it vmaps over the
// frames. In eager PyTorch the same scan is about a hundred small launches
// (argmax, IoU, cluster sums, suppression, for each of 8 steps).
//
// Bound on the H100: latency. One chunk of 16 landscape frames reads
// 16 x 2688 x 17 x 4 B = 2.9 MB, about 1 us at 3.35 TB/s; the 8 steps are
// sequential, each an argmax and a cluster sum over the frame, and the chain
// of barriers between them sets the time. Design: one 512-thread CTA per
// frame, one barrier a step.
//  * Load pass: the frame's detector rows come into dynamic shared memory
//    once, by 16-byte cp.async copies (68 bytes an anchor; an odd stride of
//    17 words, so a warp reading one column of 32 anchors hits 32 banks).
//    Each thread keeps its anchors' frame boxes, areas and working scores in
//    registers (anchors tid + k * 512, k < 6), and computes its candidate for
//    the first seed in the same pass.
//  * A step: every thread tests its anchors that can still join a cluster
//    (score > 0) against the seed, adds its cluster members' 16 frame
//    coordinates (from shared memory) times their scores in fp64,
//    suppresses them, and takes its candidate for the next seed over its
//    anchors' new scores. The keys of anchors that can join no cluster
//    (invalid, suppressed, NaN, <= 0) do not change, so a thread folds each
//    into one running key once, when it loads or suppresses the anchor, and
//    a step costs the frame's live anchors, not all of its anchors. One
//    combined reduction gives this step's sums and the next seed: warp
//    shuffles (a warp with no
//    member skips the fp64 shuffles of its 17 sums, which would add exact
//    zeros), one exchange through shared memory (double-buffered by step),
//    one barrier. Then 17 lanes of warp 0 form the cross-warp sums at once,
//    each lane its column over the warps in warp order, and write the
//    step's row; every warp reads the next seed from the same exchange.
//
// Semantics kept from the JAX scan:
//  * argmax: NaN first, then the largest score, ties to the lowest index
//    (an order key: the score's bits mapped to an unsigned order above the
//    complemented index, -0 taken as +0);
//  * IoU = inter / (area_a + area_b - inter) in IEEE fp32, so a zero-area
//    seed gets 0/0 = NaN against itself, falls out of its own cluster
//    (n = 0), is not suppressed and is picked again next step;
//  * cluster = IoU > thresh & score > 0; n > 1 -> score-weighted mean of the
//    16 coords over max(total, 1e-20) and mean score total / max(n, 1);
//    otherwise the seed row verbatim;
//  * margin: off = rint(margin * (ymax - ymin)) (half to even, as
//    jnp.round), ymin - 2 off and xmin - off clamped at 0, ymax + off and
//    xmax + off clamped at the frame size; max/min propagate NaN.
// The weighted sums accumulate in fp64 and round to fp32 once, as the plain
// PyTorch version does, so the two agree to the last bit but for rare ties
// of rounding. Built with -fmad=false: every fp32 multiply and add rounds
// on its own, as in the plain version.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 6;                           // anchors a thread
constexpr int kMaxAnchors = kThreads * kPer;      // 3072; a frame has T x 896 <= 2688
constexpr int kCols = 17;
constexpr int kCoords = 16;
constexpr int kMaxSmem = kMaxAnchors * kCols * static_cast<int>(sizeof(float));
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float nan_max(float a, float b) {
  return (isnan(a) || isnan(b)) ? nanf("") : fmaxf(a, b);
}

__device__ __forceinline__ float nan_min(float a, float b) {
  return (isnan(a) || isnan(b)) ? nanf("") : fminf(a, b);
}

// jnp.argmax order as one unsigned 64-bit key, larger = better: NaN above
// every number, then the score's order (-0 as +0), then the lower index.
// 0 is below every anchor's key.
__device__ __forceinline__ unsigned long long order_key(float v, int idx) {
  unsigned u = 0xffffffffu;
  if (!isnan(v)) {
    u = __float_as_uint(v == 0.0f ? 0.0f : v);
    u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  }
  return (static_cast<unsigned long long>(u) << 32) | (~static_cast<unsigned>(idx));
}

__device__ __forceinline__ int key_index(unsigned long long key) {
  return static_cast<int>(~static_cast<unsigned>(key));
}

// the keyed score is > 0 (not NaN, above the key of +0)
__device__ __forceinline__ bool key_positive(unsigned long long key) {
  const unsigned u = static_cast<unsigned>(key >> 32);
  return u != 0xffffffffu && u > 0x80000000u;
}

__device__ __forceinline__ unsigned long long warp_max(unsigned long long k) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long ok = __shfl_xor_sync(kFull, k, o);
    k = ok > k ? ok : k;
  }
  return k;
}

// Box columns 0..3: even = y, odd = x. Keypoint columns 4..15: even = x, odd = y.
__device__ __forceinline__ float frame_coord(float raw, int col, float split, float yo, float xo) {
  const bool is_y = (col < 4) ? ((col & 1) == 0) : ((col & 1) == 1);
  return raw * split + (is_y ? yo : xo);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem) : "memory");
}

__global__ void __launch_bounds__(kThreads, 1)
frame_detections_kernel(const float* __restrict__ dets, const uint8_t* __restrict__ valid,
                        const float* __restrict__ offsets, float split, float fh, float fw,
                        int T, int A, int max_out, float iou_thresh, float margin,
                        int apply_margin, float* __restrict__ faces, uint8_t* __restrict__ mask) {
  extern __shared__ __align__(16) float s_rows[];   // the frame's N x 17 detector rows
  __shared__ double s_sum[2][kWarps][kCols];          // a warp's 16 coordinate sums, total
  __shared__ int s_n[2][kWarps];                      // a warp's cluster members
  __shared__ unsigned long long s_key[2][kWarps];     // a warp's next-seed candidate

  const int N = T * A;
  const int f = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* D = dets + static_cast<size_t>(f) * N * kCols;
  const uint8_t* V = valid + static_cast<size_t>(f) * N;

  // --- load pass --------------------------------------------------------------
  const int words = N * kCols;
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(D) & 15) == 0) {
    done = words & ~3;
    for (int i = 4 * tid; i < done; i += 4 * kThreads) cp_async16(s_rows + i, D + i);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  }
  for (int i = done + tid; i < words; i += kThreads) s_rows[i] = D[i];
  __syncthreads();

  float y0[kPer], x0[kPer], y1[kPer], x1[kPer], area[kPer], score[kPer];
  unsigned long long fixed = 0;   // the best key of this thread's anchors that cannot join
  unsigned long long best = 0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int a = tid + k * kThreads;
    score[k] = -1.0f;
    if (a < N) {
      const int t = a / A;
      const float yo = offsets[2 * t], xo = offsets[2 * t + 1];
      const float* r = s_rows + a * kCols;
      y0[k] = r[0] * split + yo;
      x0[k] = r[1] * split + xo;
      y1[k] = r[2] * split + yo;
      x1[k] = r[3] * split + xo;
      area[k] = (y1[k] - y0[k]) * (x1[k] - x0[k]);
      score[k] = V[a] ? r[kCoords] : -1.0f;
      const unsigned long long key = order_key(score[k], a);
      if (score[k] > 0.0f)
        best = key > best ? key : best;
      else
        fixed = key > fixed ? key : fixed;
    }
  }
  best = fixed > best ? fixed : best;

  // The combined reduction of round `p` (0: the first seed; step s: s + 1):
  // this thread's cluster sums (n members) and its next-seed candidate.
  double acc[kCoords + 1];
  int n = 0;
  int p = 0;
  {
    best = warp_max(best);
    if (lane == 0) s_key[0][warp] = best;
    __syncthreads();
  }
  for (int step = 0; step < max_out; ++step) {
    // every warp: the seed from round p's candidates
    unsigned long long seed = warp_max(lane < kWarps ? s_key[p][lane] : 0ull);
    const int idx = key_index(seed);
    const int ts = idx / A;
    const float syo = offsets[2 * ts], sxo = offsets[2 * ts + 1];
    const float* sr = s_rows + idx * kCols;
    const float sy0 = sr[0] * split + syo, sx0 = sr[1] * split + sxo;
    const float sy1 = sr[2] * split + syo, sx1 = sr[3] * split + sxo;
    const float area_a = (sy1 - sy0) * (sx1 - sx0);

    // --- cluster, its weighted sums, suppression, the next seed's candidate --
#pragma unroll
    for (int c = 0; c <= kCoords; ++c) acc[c] = 0.0;
    n = 0;
    best = fixed;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int a = tid + k * kThreads;
      if (a < N && score[k] > 0.0f) {
        const float ih = nan_max(nan_min(sy1, y1[k]) - nan_max(sy0, y0[k]), 0.0f);
        const float iw = nan_max(nan_min(sx1, x1[k]) - nan_max(sx0, x0[k]), 0.0f);
        const float inter = ih * iw;
        const float iou = inter / (area_a + area[k] - inter);
        if (iou > iou_thresh) {
          const double wgt = static_cast<double>(score[k]);
          const int t = a / A;
          const float yo = offsets[2 * t], xo = offsets[2 * t + 1];
          const float* r = s_rows + a * kCols;
#pragma unroll
          for (int c = 0; c < kCoords; ++c)
            acc[c] += static_cast<double>(frame_coord(r[c], c, split, yo, xo)) * wgt;
          acc[kCoords] += wgt;
          ++n;
          score[k] = -1.0f;
          const unsigned long long key = order_key(-1.0f, a);
          fixed = key > fixed ? key : fixed;
        } else {
          const unsigned long long key = order_key(score[k], a);
          best = key > best ? key : best;
        }
      }
    }
    best = fixed > best ? fixed : best;

    // --- one combined reduction -------------------------------------------------
    p ^= 1;
    best = warp_max(best);
    const int wn = __reduce_add_sync(kFull, n);
    if (wn > 0) {   // warp-uniform: only a warp holding a member shuffles its sums
      for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
        for (int c = 0; c <= kCoords; ++c) acc[c] += __shfl_xor_sync(kFull, acc[c], o);
      }
    }
    if (lane == 0) {
      s_key[p][warp] = best;
      s_n[p][warp] = wn;
#pragma unroll
      for (int c = 0; c <= kCoords; ++c) s_sum[p][warp][c] = acc[c];
    }
    __syncthreads();

    // --- this step's row: 17 lanes of warp 0, one column each -----------------
    if (warp == 0) {
      int nt = 0;
      double sc = 0.0;
      const int c = lane < kCols ? lane : kCoords;
      for (int w = 0; w < kWarps; ++w) {
        nt += s_n[p][w];
        sc += s_sum[p][w][c];
      }
      float v;
      if (nt > 1) {
        const float total = static_cast<float>(__shfl_sync(kFull, sc, kCoords));
        const float denom = nan_max(total, 1e-20f);
        v = c < kCoords ? static_cast<float>(sc) / denom
                        : total / static_cast<float>(nt);   // nt > 1 = max(n, 1)
      } else {
        v = c < kCoords ? frame_coord(sr[c], c, split, syo, sxo) : sr[kCoords];
      }
      if (apply_margin) {
        const float r0 = __shfl_sync(kFull, v, 0), r2 = __shfl_sync(kFull, v, 2);
        const float off = rintf(margin * (r2 - r0));
        if (lane == 0) v = nan_max(v - off * 2.0f, 0.0f);
        if (lane == 1) v = nan_max(v - off, 0.0f);
        if (lane == 2) v = nan_min(v + off, fh);
        if (lane == 3) v = nan_min(v + off, fw);
      }
      if (lane < kCols) faces[(static_cast<size_t>(f) * max_out + step) * kCols + lane] = v;
      if (lane == 0) mask[static_cast<size_t>(f) * max_out + step] = key_positive(seed) ? 1 : 0;
    }
  }
}

cudaError_t set_smem_once() {
  static const cudaError_t err = cudaFuncSetAttribute(
      frame_detections_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  return err;
}

}  // namespace

// dets (F, T*A, 17) fp32, valid (F, T*A) bool, offsets (T, 2) fp32 [y, x],
// all on the device; faces (F, max_out, 17) fp32 and mask (F, max_out) bool
// written. apply_margin == 0 skips the margin clamp (plain weighted NMS).
// T * A <= 3072 (512 threads x 6 anchors in registers).
extern "C" int fac_frame_detections(const float* dets, const uint8_t* valid,
                                    const float* offsets, float split, float fh, float fw,
                                    int F, int T, int A, int max_out, float iou_thresh,
                                    float margin, int apply_margin, float* faces,
                                    uint8_t* mask, void* stream) {
  const long long n = static_cast<long long>(T) * A;
  if (n <= 0 || n > kMaxAnchors) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = set_smem_once();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (F > 0) {
    const size_t smem = static_cast<size_t>(n) * kCols * sizeof(float);
    frame_detections_kernel<<<F, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        dets, valid, offsets, split, fh, fw, T, A, max_out, iou_thresh, margin, apply_margin,
        faces, mask);
  }
  return static_cast<int>(cudaGetLastError());
}
