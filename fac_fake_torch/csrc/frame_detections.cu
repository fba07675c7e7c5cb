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
// sequential, each a block-wide argmax and a block-wide sum. Design: one
// 512-thread CTA per frame keeps the frame's boxes and scores in shared
// memory (24 B per anchor) for all 8 steps, so after the first read every
// step costs two block reductions and no trip to device memory except the
// cluster members' 16 coordinates.
//
// Semantics kept from the JAX scan:
//  * argmax: NaN first, then the largest score, ties to the lowest index;
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
constexpr int kCols = 17;
constexpr int kCoords = 16;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float nan_max(float a, float b) {
  return (isnan(a) || isnan(b)) ? nanf("") : fmaxf(a, b);
}

__device__ __forceinline__ float nan_min(float a, float b) {
  return (isnan(a) || isnan(b)) ? nanf("") : fminf(a, b);
}

// jnp.argmax order: NaN beats everything, then larger, ties -> lower index.
__device__ __forceinline__ bool better(float a, int ia, float b, int ib) {
  const bool an = isnan(a), bn = isnan(b);
  if (an != bn) return an;
  if (!an && a != b) return a > b;
  return ia < ib;
}

// Box columns 0..3: even = y, odd = x. Keypoint columns 4..15: even = x, odd = y.
__device__ __forceinline__ float frame_coord(float raw, int col, float split, float yo, float xo) {
  const bool is_y = (col < 4) ? ((col & 1) == 0) : ((col & 1) == 1);
  return raw * split + (is_y ? yo : xo);
}

__global__ void __launch_bounds__(kThreads)
frame_detections_kernel(const float* __restrict__ dets, const uint8_t* __restrict__ valid,
                        const float* __restrict__ offsets, float split, float fh, float fw,
                        int T, int A, int max_out, float iou_thresh, float margin,
                        int apply_margin, float* __restrict__ faces, uint8_t* __restrict__ mask) {
  extern __shared__ float4 smem[];
  const int N = T * A;
  float4* s_box = smem;                                   // (y0, x0, y1, x1) in frame coords
  float* s_score = reinterpret_cast<float*>(s_box + N);  // working scores (-1 = gone)
  float* s_raw = s_score + N;                             // detector scores

  __shared__ float s_wv[kWarps];
  __shared__ int s_wi[kWarps];
  __shared__ int s_seed;
  __shared__ double s_red[kWarps][kCoords + 1];
  __shared__ int s_n[kWarps];

  const int f = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* D = dets + static_cast<size_t>(f) * N * kCols;
  const uint8_t* V = valid + static_cast<size_t>(f) * N;

  for (int a = tid; a < N; a += kThreads) {
    const int t = a / A;
    const float yo = offsets[2 * t], xo = offsets[2 * t + 1];
    const float* r = D + static_cast<size_t>(a) * kCols;
    s_box[a] = make_float4(r[0] * split + yo, r[1] * split + xo, r[2] * split + yo,
                           r[3] * split + xo);
    const float s = r[kCoords];
    s_raw[a] = s;
    s_score[a] = V[a] ? s : -1.0f;
  }
  __syncthreads();

  for (int step = 0; step < max_out; ++step) {
    // --- seed: block-wide argmax -----------------------------------------
    float bv = -INFINITY;
    int bi = 0x7fffffff;
    for (int a = tid; a < N; a += kThreads) {
      const float v = s_score[a];
      if (better(v, a, bv, bi)) { bv = v; bi = a; }
    }
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(kFull, bv, o);
      const int oi = __shfl_xor_sync(kFull, bi, o);
      if (better(ov, oi, bv, bi)) { bv = ov; bi = oi; }
    }
    if (lane == 0) { s_wv[warp] = bv; s_wi[warp] = bi; }
    __syncthreads();
    if (warp == 0) {
      bv = lane < kWarps ? s_wv[lane] : -INFINITY;
      bi = lane < kWarps ? s_wi[lane] : 0x7fffffff;
      for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(kFull, bv, o);
        const int oi = __shfl_xor_sync(kFull, bi, o);
        if (better(ov, oi, bv, bi)) { bv = ov; bi = oi; }
      }
      if (lane == 0) s_seed = bi;
    }
    __syncthreads();
    const int idx = s_seed;
    const float seed_score = s_score[idx];
    const float4 sb = s_box[idx];
    __syncthreads();  // every thread holds the seed before any suppression

    // --- cluster, its weighted sums, suppression ---------------------------
    const float area_a = (sb.z - sb.x) * (sb.w - sb.y);
    double acc[kCoords];
#pragma unroll
    for (int c = 0; c < kCoords; ++c) acc[c] = 0.0;
    double tot = 0.0;
    int n = 0;
    for (int a = tid; a < N; a += kThreads) {
      const float4 b = s_box[a];
      const float ih = nan_max(nan_min(sb.z, b.z) - nan_max(sb.x, b.x), 0.0f);
      const float iw = nan_max(nan_min(sb.w, b.w) - nan_max(sb.y, b.y), 0.0f);
      const float inter = ih * iw;
      const float area_b = (b.z - b.x) * (b.w - b.y);
      const float iou = inter / (area_a + area_b - inter);
      if (iou > iou_thresh && s_score[a] > 0.0f) {
        const float wgt = s_raw[a];
        const int t = a / A;
        const float yo = offsets[2 * t], xo = offsets[2 * t + 1];
        const float* r = D + static_cast<size_t>(a) * kCols;
#pragma unroll
        for (int c = 0; c < kCoords; ++c)
          acc[c] += static_cast<double>(frame_coord(r[c], c, split, yo, xo)) *
                    static_cast<double>(wgt);
        tot += static_cast<double>(wgt);
        ++n;
        s_score[a] = -1.0f;
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int c = 0; c < kCoords; ++c) acc[c] += __shfl_xor_sync(kFull, acc[c], o);
      tot += __shfl_xor_sync(kFull, tot, o);
      n += __shfl_xor_sync(kFull, n, o);
    }
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < kCoords; ++c) s_red[warp][c] = acc[c];
      s_red[warp][kCoords] = tot;
      s_n[warp] = n;
    }
    __syncthreads();

    // --- output row --------------------------------------------------------
    if (tid == 0) {
      float row[kCols];
      int nt = 0;
      double tt = 0.0;
      for (int w = 0; w < kWarps; ++w) { nt += s_n[w]; tt += s_red[w][kCoords]; }
      if (nt > 1) {
        const float total = static_cast<float>(tt);
        const float denom = nan_max(total, 1e-20f);
        for (int c = 0; c < kCoords; ++c) {
          double sc = 0.0;
          for (int w = 0; w < kWarps; ++w) sc += s_red[w][c];
          row[c] = static_cast<float>(sc) / denom;
        }
        row[kCoords] = total / static_cast<float>(nt);  // nt > 1 = max(n, 1)
      } else {
        const int t = idx / A;
        const float yo = offsets[2 * t], xo = offsets[2 * t + 1];
        const float* r = D + static_cast<size_t>(idx) * kCols;
        for (int c = 0; c < kCoords; ++c) row[c] = frame_coord(r[c], c, split, yo, xo);
        row[kCoords] = r[kCoords];
      }
      if (apply_margin) {
        const float off = rintf(margin * (row[2] - row[0]));
        row[0] = nan_max(row[0] - off * 2.0f, 0.0f);
        row[1] = nan_max(row[1] - off, 0.0f);
        row[2] = nan_min(row[2] + off, fh);
        row[3] = nan_min(row[3] + off, fw);
      }
      float* out = faces + (static_cast<size_t>(f) * max_out + step) * kCols;
      for (int c = 0; c < kCols; ++c) out[c] = row[c];
      mask[static_cast<size_t>(f) * max_out + step] = seed_score > 0.0f ? 1 : 0;
    }
    __syncthreads();  // suppression and s_red reads done before the next step
  }
}

}  // namespace

// dets (F, T*A, 17) fp32, valid (F, T*A) bool, offsets (T, 2) fp32 [y, x],
// all on the device; faces (F, max_out, 17) fp32 and mask (F, max_out) bool
// written. apply_margin == 0 skips the margin clamp (plain weighted NMS).
extern "C" int fac_frame_detections(const float* dets, const uint8_t* valid,
                                    const float* offsets, float split, float fh, float fw,
                                    int F, int T, int A, int max_out, float iou_thresh,
                                    float margin, int apply_margin, float* faces,
                                    uint8_t* mask, void* stream) {
  const size_t smem = static_cast<size_t>(T) * A * (sizeof(float4) + 2 * sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      frame_detections_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (F > 0) {
    frame_detections_kernel<<<F, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        dets, valid, offsets, split, fh, fw, T, A, max_out, iou_thresh, margin, apply_margin,
        faces, mask);
  }
  return static_cast<int>(cudaGetLastError());
}
