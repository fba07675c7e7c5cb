// K7: the strong_aug chain's CLAHE step. In place on a batch of (N, H, W, 3)
// float32 RGB images in [0, 1]: each of the first k_budget images whose
// `take` byte is set (in index order) gets CLAHE on its luma, clip limit and
// tile grid as cv2's; every other image keeps its bits.
//
// Replaces: fac_fake_tpu/data/augment.py:274 clahe_luma, vmapped over the
// CLAHE subset of augment_batch (:802-811) by _subset_apply (:608-618): a
// stable argsort puts the takers first, a gather makes the sub-batch, the
// LUT math runs on it (XLA on the TPU: a fused compare-reduce histogram and a
// bf16 one-hot x LUT matmul), a where keeps the non-takers' bits and a
// scatter writes it back. This kernel computes the same values in one launch
// (ops/augment.py clahe_subset_plain_ is its plain version, the CPU path and
// the card's oracle), not the same graph. With `take` null, slot s takes
// image s (clahe_luma, the whole batch into another tensor).
//
// Design: one thread-block cluster a budget slot, CTA r of it owning the
// band of tile rows [r * rows, (r + 1) * rows) (rows = 1 up to grid 8, the
// portable cluster size; a grid above 8 gives each CTA several tile rows).
// A thread owns one column of the band (up to 1024 threads) and every
// rstep-th row of it, so that a warp reads and writes consecutive pixels.
//   0. The kernel is launched with programmatic stream serialization: its
//      set-up runs while the kernel before it drains, and griddepcontrol.wait
//      holds every read of `x` and `take` until that kernel is done. Warp 0
//      of each CTA of slot s finds the s-th taker in `take` (a lane a run of
//      bytes, a warp scan), and at once its lanes ask for the band: one
//      contiguous run of bytes in NHWC (75,264 B at 224^2, grid 8), as
//      kChunks bulk copies (cp.async.bulk, the non-tensor TMA copy), each on
//      its own mbarrier. The other warps meanwhile build the band rows'
//      table (LUT rows and weight of JAX's padded block mapping: band
//      (i + py) / th, offset (i + py) % th, tile rows clip(band - 1) and
//      clip(band), weight offset / th, 0 in the edge bands). The cluster
//      exits if there is no s-th taker. The input is read from device memory
//      once.
//   1. Histograms, a chunk as it lands: each pixel's Y, Cb, Cr once (JFIF,
//      the plain version's fp32 operations); its bin rint(clamp(y, 0, 255))
//      (half to even, as jnp.round) into its tile's 256-bin histogram with a
//      shared-memory atomic; its RGB in shared memory replaced by
//      (bin, Cb, Cr).
//   2. LUTs. One warp a tile: lane l clips bins 8l..8l+7 at the limit, a
//      warp scan gives the cumulative counts, and cv2's redistribution is
//      added in JAX's closed form: the whole-256 batch, batch * (b + 1), and
//      the residual's min(b / step + 1, resid). Every partial sum is an
//      integer below 2^24, so the int32 arithmetic gives the fp32 plain
//      version's values exactly. lut[b] = rint(cdf * fp32(255 / tile_px)),
//      written over the histogram, and the band's first and last tile rows
//      also into the shared memory of CTAs r - 1 and r + 1 (DSMEM), which
//      blend with them. A cluster barrier arrive at the start and its wait
//      before these stores keep them off a CTA that has not started; one
//      cluster.sync() after them puts every LUT row in place.
//   3. Blend. Each pixel reads the four LUTs of its tiles from shared memory,
//      blends them left to right in fp32 as
//      v0(1-wy)(1-wx) + v1(1-wy)wx + v2 wy(1-wx) + v3 wy wx, converts back
//      to RGB, divides by 255, clips to [0, 1] and writes the image's rows.
//      Grid 1 (JAX's rule for odd or sub-2-pixel tiles) is one CTA a slot,
//      one LUT, no blend.
// A band that does not fit in shared memory (a large image at grid 1), or
// whose rows are not 16-byte multiples, is read from device memory twice in
// the same kernel: once for the histograms, once for the blend (its Y, Cb,
// Cr computed again, with the same operations). Every fp32 operation is the
// plain version's, in its order, with IEEE rounding (__fmul_rn, __fadd_rn,
// __fdiv_rn; the library is built with -fmad=false), so the output is
// bit-equal to the plain version's on the card.
//
// Bound on the H100: bytes, each taken image read once and written once,
// 2 * kb * H * W * 3 * 4 B: 9.63 MB at kb = 8, 224^2, about 2.9 us at
// 3.35 TB/s. Untaken images are neither read nor written. The kernel is
// far from it: the 8 CTAs of a slot hold 8 SMs, so 8 slots use 64 of the
// 132, and each CTA's phases (the load's latency, the pixels' work through
// shared memory, the cluster barriers) run one after another (PERF.md §6).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kBins = 256;
constexpr int kMaxCluster = 8;    // the portable cluster size
constexpr int kChunks = 4;        // bulk copies a band, each on its own mbarrier
// dynamic shared memory a CTA may take: the H100's 227 KB a block less room
// for the static arrays below
constexpr int kSmemDynMax = 232448 - 1024;

// JAX's constants are Python floats rounded to fp32; so are these
constexpr float kYR = (float)0.299, kYG = (float)0.587, kYB = (float)0.114;
constexpr float kBR = (float)-0.168736, kBG = (float)0.331264, kBB = (float)0.5;
constexpr float kRR = (float)0.5, kRG = (float)0.418688, kRB = (float)0.081312;
constexpr float kCr2R = (float)1.402, kCb2G = (float)0.344136, kCr2G = (float)0.714136;
constexpr float kCb2B = (float)1.772;

struct Args {
  const float* src;      // (N, H, W, 3); src == dst in place
  float* dst;
  const uint8_t* take;   // (N,) bools, or null: slot s takes image s
  int n, h, w, grid;
  int rows;              // tile rows a CTA owns (the last CTA of a cluster may own fewer)
  int limit;             // the clip limit in pixels
  float scale;           // fp32(255 / tile_px)
  int staged;            // 1: the band goes through shared memory; 0: read twice from global
  int cw, rstep;         // threads across a row (each its columns), rows at a time
};

struct YCbCr {
  float y, cb, cr;
};

__device__ __forceinline__ YCbCr to_ycbcr(float r8, float g8, float b8) {
  const float r = __fmul_rn(r8, 255.0f);
  const float g = __fmul_rn(g8, 255.0f);
  const float b = __fmul_rn(b8, 255.0f);
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

// A pixel's output: its value from the LUTs at lut + bin (the blend of JAX's
// padded block mapping, in the plain version's order) and its chroma, back
// to RGB in [0, 1]. y0, y1: its band row's LUT rows (offsets) above and
// below, weight wy; x0, x1: its column's tiles (offsets) left and right,
// weight wx.
__device__ __forceinline__ float3 blend_rgb(const float* L, float cb, float cr, int y0, int y1,
                                            float wy, int x0, int x1, float wx, float ax,
                                            bool one_tile) {
  float v;
  if (one_tile) {
    v = L[y0 + x0];
  } else {
    const float v0 = L[y0 + x0], v1 = L[y0 + x1];
    const float v2 = L[y1 + x0], v3 = L[y1 + x1];
    const float ay = __fsub_rn(1.0f, wy);
    v = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(__fmul_rn(v0, ay), ax),
                                      __fmul_rn(__fmul_rn(v1, ay), wx)),
                            __fmul_rn(__fmul_rn(v2, wy), ax)),
                  __fmul_rn(__fmul_rn(v3, wy), wx));
  }
  const float dcr = __fsub_rn(cr, 128.0f), dcb = __fsub_rn(cb, 128.0f);
  return make_float3(unit(__fadd_rn(v, __fmul_rn(kCr2R, dcr))),
                     unit(__fsub_rn(__fsub_rn(v, __fmul_rn(kCb2G, dcb)), __fmul_rn(kCr2G, dcr))),
                     unit(__fadd_rn(v, __fmul_rn(kCb2B, dcb))));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A wait that has not returned after about 10 s of clock traps, so a fault
// ends the launch with an error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  long long t0 = 0;
  for (int spin = 0;; ++spin) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (spin == 0) t0 = clock64();
    if ((spin & 1023) == 1023 && clock64() - t0 > 20000000000LL) __trap();
  }
}

// ``bytes`` (a multiple of 16, both addresses 16-byte aligned) from global
// into shared memory, completing on ``bar``
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Warp 0: the index of the s-th image (from 0) whose take byte is set, or
// -1. Lane l counts the takers in its own run of take, a warp scan places
// the runs, and the lane whose run holds the s-th taker finds it.
__device__ int find_taker(const uint8_t* take, int n, int s) {
  const int lane = threadIdx.x & 31;
  const int per = (n + 31) / 32;
  const int lo = min(lane * per, n), hi = min(lo + per, n);
  int cnt = 0;
#pragma unroll 4
  for (int i = lo; i < hi; ++i) cnt += take[i] != 0;
  int incl = cnt;
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  int found = -1;
  if (s >= incl - cnt && s < incl) {
    int k = s - (incl - cnt);
#pragma unroll 1
    for (int i = lo; i < hi; ++i) {
      if (take[i] != 0 && k-- == 0) {
        found = i;
        break;
      }
    }
  }
  const unsigned who = __ballot_sync(0xffffffffu, found >= 0);
  return who != 0 ? __shfl_sync(0xffffffffu, found, __ffs(who) - 1) : -1;
}

__global__ void __launch_bounds__(kMaxThreads, 1024 / kMaxThreads) clahe_subset(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) uint64_t bars[kChunks];
  __shared__ int found;
  cg::cluster_group cluster = cg::this_cluster();
  // this CTA has started: its neighbours may write into its shared memory
  // once they have waited for this arrive
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const int csize = static_cast<int>(cluster.num_blocks());
  const int r = static_cast<int>(cluster.block_rank());
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int nthreads = blockDim.x, nwarps = nthreads / 32;
  const int g = a.grid, w = a.w, th = a.h / g, tw = w / g;
  const int r0 = r * a.rows;                 // the first tile row this CTA owns
  const int own = min(a.rows, g - r0);       // how many it owns
  const int band_rows = own * th;
  const int row0 = r0 * th;                  // the band's first image row
  // thread t takes columns t % cw (+ cw, ...) and rows t / cw (+ rstep, ...)
  const int jt = t % a.cw, it = t < a.cw * a.rstep ? t / a.cw : band_rows;
  // shared memory: lut, rows + 2 tile rows of g LUTs (0 the tile row above
  // the band, written by CTA r - 1; 1..own this CTA's, its histograms first;
  // own + 1 the one below, written by CTA r + 1); a band row's LUT offsets
  // and blend weight; then the band
  const int row_floats = g * kBins;
  float* lut = reinterpret_cast<float*>(smem);
  int* hist = reinterpret_cast<int*>(lut);
  int4* rowtab = reinterpret_cast<int4*>(lut + (a.rows + 2) * row_floats);
  float* band = reinterpret_cast<float*>(rowtab + a.rows * th);
  const int rows_chunk = (band_rows + kChunks - 1) / kChunks;

  // ---- 0. the image (warp 0), and what does not depend on it -----------------
  if (warp == 0) {
    if (lane == 0) {
      for (int c = 0; c < kChunks; ++c)
        asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(&bars[c])),
                     "r"(1)
                     : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    asm volatile("griddepcontrol.wait;\n" ::: "memory");   // x and take are written
    const int img = a.take != nullptr ? find_taker(a.take, a.n, blockIdx.x / csize)
                                      : static_cast<int>(blockIdx.x) / csize;
    if (lane == 0) found = img;
    __syncwarp();
    // lane c asks for chunk c of the band
    if (img >= 0 && a.staged && lane < kChunks && lane * rows_chunk < band_rows) {
      const int rc = min(rows_chunk, band_rows - lane * rows_chunk);
      const size_t off = static_cast<size_t>(lane) * rows_chunk * w * 3;
      bulk_load(band + off, a.src + (static_cast<size_t>(img) * a.h + row0) * w * 3 + off,
                static_cast<uint32_t>(rc) * w * 12, &bars[lane]);
    }
  }
#pragma unroll 1
  for (int i = t; i < own * row_floats; i += nthreads) hist[row_floats + i] = 0;
  // JAX's padded block mapping, a band row at a time: the histogram's tile
  // row, the two tile rows blended, the weight (0 in the edge bands)
  const int py = th / 2, px = tw / 2;
#pragma unroll 1
  for (int i = t; i < band_rows; i += nthreads) {
    const int gi = row0 + i, by = (gi + py) / th, ry = (gi + py) % th;
    const int y0 = min(max(by - 1, 0), g - 1) - r0 + 1, y1 = min(by, g - 1) - r0 + 1;
    const float wy = (by >= 1 && by <= g - 1)
                         ? __fdiv_rn(static_cast<float>(ry), static_cast<float>(th)) : 0.0f;
    rowtab[i] = make_int4((i / th + 1) * row_floats, y0 * row_floats, y1 * row_floats,
                          __float_as_int(wy));
  }
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  __syncthreads();
  const int img = found;
  if (img < 0) return;                       // so does every CTA of the cluster
  const size_t at = (static_cast<size_t>(img) * a.h + row0) * w * 3;
  const float* gsrc = a.src + at;
  float* gdst = a.dst + at;

  // ---- 1. histograms ---------------------------------------------------------
  // staged, each pixel's RGB in shared memory is replaced by (bin, Cb, Cr)
  const float* in = a.staged ? band : gsrc;
#pragma unroll 1
  for (int j = jt; j < w; j += a.cw) {
    const int hcol = (j / tw) * kBins;
#pragma unroll 1
    for (int c = 0; c * rows_chunk < band_rows; ++c) {
      if (a.staged) mbar_wait(&bars[c], 0);
      const int i1 = min((c + 1) * rows_chunk, band_rows);
#pragma unroll 2
      for (int i = c * rows_chunk + it; i < i1; i += a.rstep) {
        const size_t p = static_cast<size_t>(i) * w + j;
        const float* q = in + p * 3;
        const YCbCr ycc = to_ycbcr(q[0], q[1], q[2]);
        const int bin = luma_bin(ycc.y);
        atomicAdd(&hist[rowtab[i].x + hcol + bin], 1);
        if (a.staged) {
          float* o = band + p * 3;
          o[0] = __int_as_float(bin);
          o[1] = ycc.cb;
          o[2] = ycc.cr;
        }
      }
    }
  }
  __syncthreads();

  // ---- 2. LUTs: a warp a tile, 8 bins a lane; the first and last tile rows
  // also into the neighbours' shared memory --------------------------------------
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");   // every CTA has started
  float* up = r > 0 ? cluster.map_shared_rank(lut, r - 1) + (a.rows + 1) * row_floats : nullptr;
  float* down = r < csize - 1 ? cluster.map_shared_rank(lut, r + 1) : nullptr;
  const int tile_px = th * tw;
#pragma unroll 1
  for (int k = warp; k < own * g; k += nwarps) {
    int* hk = hist + row_floats + k * kBins + lane * 8;
    const int4 h0 = reinterpret_cast<const int4*>(hk)[0];
    const int4 h1 = reinterpret_cast<const int4*>(hk)[1];
    int v[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
    int run = 0;
    for (int e = 0; e < 8; ++e) {      // the lane's inclusive cumulative clipped counts
      run += min(v[e], a.limit);
      v[e] = run;
    }
    int incl = run;
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += u;
    }
    const int total = __shfl_sync(0xffffffffu, incl, 31);
    const int before = incl - run;
    const int excess = tile_px - total;   // every pixel has one bin
    const int batch = excess / kBins, resid = excess - batch * kBins;
    const int step = max(kBins / max(resid, 1), 1);
    // b / step for b < 256 as a multiply by ceil(2^32 / step) and a shift
    const unsigned long long magic = 0xffffffffu / static_cast<unsigned>(step) + 1ull;
    float o[8];
    for (int e = 0; e < 8; ++e) {
      const int b = lane * 8 + e;
      const int resid_cum = resid > 0 ? min(static_cast<int>((b * magic) >> 32) + 1, resid) : 0;
      const int cdf = before + v[e] + batch * (b + 1) + resid_cum;
      o[e] = rintf(__fmul_rn(static_cast<float>(cdf), a.scale));
    }
    const float4 lo4 = make_float4(o[0], o[1], o[2], o[3]);
    const float4 hi4 = make_float4(o[4], o[5], o[6], o[7]);
    float4* out = reinterpret_cast<float4*>(hk);
    out[0] = lo4;
    out[1] = hi4;
    const int off = (k % g) * kBins + lane * 8;
    if (k < g && up != nullptr) {                 // the first tile row: CTA r - 1's row below
      reinterpret_cast<float4*>(up + off)[0] = lo4;
      reinterpret_cast<float4*>(up + off)[1] = hi4;
    }
    if (k >= (own - 1) * g && down != nullptr) {  // the last: CTA r + 1's row above
      reinterpret_cast<float4*>(down + off)[0] = lo4;
      reinterpret_cast<float4*>(down + off)[1] = hi4;
    }
  }
  cluster.sync();                      // every LUT row in place, here and in the neighbours

  // ---- 3. the blend ---------------------------------------------------------------
  const bool one_tile = g == 1;
#pragma unroll 1
  for (int j = jt; j < w; j += a.cw) {
    const int bx = (j + px) / tw, rx = (j + px) % tw;
    const int x0 = min(max(bx - 1, 0), g - 1) * kBins, x1 = min(bx, g - 1) * kBins;
    const float wx = (bx >= 1 && bx <= g - 1)
                         ? __fdiv_rn(static_cast<float>(rx), static_cast<float>(tw)) : 0.0f;
    const float ax = __fsub_rn(1.0f, wx);
#pragma unroll 2
    for (int i = it; i < band_rows; i += a.rstep) {
      const size_t p = static_cast<size_t>(i) * w + j;
      int bin;
      float cb, cr;
      if (a.staged) {
        const float* q = band + p * 3;
        bin = __float_as_int(q[0]);
        cb = q[1];
        cr = q[2];
      } else {
        const float* q = gsrc + p * 3;
        const YCbCr ycc = to_ycbcr(q[0], q[1], q[2]);
        bin = luma_bin(ycc.y);
        cb = ycc.cb;
        cr = ycc.cr;
      }
      const int4 ry = rowtab[i];
      const float3 o = blend_rgb(lut + bin, cb, cr, ry.y, ry.z, __int_as_float(ry.w), x0, x1,
                                 wx, ax, one_tile);
      float* d = gdst + p * 3;
      d[0] = o.x;
      d[1] = o.y;
      d[2] = o.z;
    }
  }
}

}  // namespace

// src, dst: (n, h, w, 3) fp32 (the same pointer in place); take: (n,) bools or
// null; k_budget: slots (<= n); grid: 1, or dividing h and w into even tiles.
// Returns cudaErrorInvalidValue where a CTA's LUTs (rows + 2 tile rows of
// them, rows = ceil(grid / 8)) and row and column tables do not fit in its
// shared memory.
extern "C" int fac_clahe_subset(const float* src, float* dst, const uint8_t* take, int n,
                                int k_budget, int h, int w, int grid, int limit, float scale,
                                cudaStream_t stream) {
  if (k_budget <= 0) return 0;
  const int rows = (grid + kMaxCluster - 1) / kMaxCluster;
  const int ctas = (grid + rows - 1) / rows;
  const int band_rows = rows * (h / grid);
  const size_t fixed = static_cast<size_t>(rows + 2) * grid * kBins * 4 +
                       static_cast<size_t>(band_rows) * 16;
  const size_t band_bytes = static_cast<size_t>(band_rows) * w * 12;
  if (fixed > static_cast<size_t>(kSmemDynMax)) return cudaErrorInvalidValue;
  const bool staged = w % 4 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0 &&
                      fixed + band_bytes <= static_cast<size_t>(kSmemDynMax);
  static const cudaError_t attr = cudaFuncSetAttribute(
      clahe_subset, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemDynMax);
  if (attr != cudaSuccess) return attr;
  // a thread a column (up to kMaxThreads of them), and as many rows at a
  // time as the rest allows; whole warps
  const int cw = w < kMaxThreads ? w : kMaxThreads;
  const int rstep = std::max(1, std::min(kMaxThreads / cw, band_rows));
  const int threads = std::max(32, (cw * rstep + 31) / 32 * 32);
  Args a{src, dst, take, n, h, w, grid, rows, limit, scale, staged ? 1 : 0, cw, rstep};
  // the cluster of a slot; programmatic stream serialization lets the set-up
  // run while the kernel before this one drains
  cudaLaunchAttribute at[2];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = ctas;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  at[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  at[1].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(k_budget * ctas);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = fixed + (staged ? band_bytes : 0);
  cfg.stream = stream;
  cfg.attrs = at;
  cfg.numAttrs = 2;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, clahe_subset, a);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
