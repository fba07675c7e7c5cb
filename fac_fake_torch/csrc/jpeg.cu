// K10: the S3D train transform's JPEG compression step. In place on a batch
// of (N, H, W, 3) float32 or bfloat16 RGB frames in [0, 1], H and W
// multiples of 16: each frame whose `take` byte is set becomes its JPEG at
// quality[n] (8x8 block DCT quantization, 4:2:0 chroma); every other frame
// keeps its bits.
//
// The bf16 mode is JAX's bf16 chain (data/augment.py:707: jpeg_compress on
// the bf16 frames, .astype(bf16)), whose steps ops/jpeg.py
// jpeg_compress_plain spells out: RGB x 255 to Y, Cb, Cr in bf16 arithmetic
// (each product and sum rounded to bf16, the JFIF constants rounded to bf16,
// as JAX's weak Python floats are); the chroma 2x2 mean summed in fp32 and
// rounded to bf16; block - 128 rounded to bf16; the DCTs, the quantization
// and the way back to RGB in fp32 as the fp32 mode; the store rounded to
// bf16 (nearest even). A bf16 band halves the bulk-copy bytes.
//
// Replaces: fac_fake_tpu/data/augment.py:415 jpeg_compress (with
// _rgb_to_ycbcr :258, _jpeg_quality_table :397, _dct_quantize :404,
// _ycbcr_to_rgb :267), vmapped over every frame of augment_batch and then
// selected by where(take) (:701-708); XLA fused it into matmuls on the TPU.
// This kernel computes only the taken frames (ops/jpeg.py
// jpeg_compress_plain is its plain version, the CPU path and the card's
// oracle).
//
// Design: a persistent grid (as many CTAs of 256 threads as fit on the
// card) over work items: (k-th taken frame, 16-row band, chunk of at most 16
// MCUs across the band; ops/jpeg.py band_chunks). CTA b takes items b, b +
// grid, ... No CTA exists for an untaken frame and the host never reads
// `take`: each CTA finds the k-th taken frame itself, a block-wide ballot
// scan over `take` whose cursor only moves forward. A CTA holds two item
// buffers in shared memory:
//   0. thread 0 brings the next item's 16 row segments (192 B an MCU each,
//      so always 16-byte aligned; one copy of 43,008 B when the chunk is the
//      whole band, as at 224^2) with cp.async.bulk against that buffer's
//      mbarrier, while the CTA computes this item;
//   1. a thread a 2x2 cell: its four pixels' RGB (8-byte loads, no bank
//      conflict), x255, to Y, Cb, Cr (JFIF); Y - 128 into the luma blocks;
//      Cb and Cr as ((c00 + c01) + c10) + c11, x 0.25 (the plain version's
//      / 4, exactly), - 128 into the chroma blocks. A block is 8 rows of 9
//      floats. The item's two quality tables and their reciprocals are made
//      once in shared memory;
//   2. a warp 4 blocks, a thread one line (row or column) of one, 8 values
//      in registers: the forward DCT over the block's rows (a thread a
//      column), then over its columns (a thread a row) and the quantization
//      rint(coef / table) * table; the inverse over the rows, then over the
//      columns, + 128. Each output is a sum of 8 products, k = 0..7 left to
//      right, the DCT matrix read from the kernel's parameters (the plain
//      version's own dct8, built once on the host). With rows of 9 floats
//      and blocks 72 floats apart, the 32 lanes' lines fall in 32 banks for
//      both a column and a row, so the passes run in place, separated by
//      __syncwarp, with no bank conflict;
//   3. a thread a cell again: each pixel's luma and its cell's chroma back to
//      RGB, / 255, clipped to [0, 1], written over the item's buffer;
//      thread 0 stores the 16 row segments with cp.async.bulk (after
//      fence.proxy.async and a barrier) and waits for their reads of shared
//      memory before the buffer takes another item.
// Every fp32 operation is the plain version's, in its order, rounded as
// IEEE (__fmul_rn, __fadd_rn, rintf half to even; the library is built with
// -fmad=false), so the output is bit-equal to the plain version's on the
// card. The divisions by a table entry and by 255 are a reciprocal product
// and one fma residual step (div_fast), which gives the IEEE quotient:
// div_check holds quantize and unit to the IEEE division over all 2^32
// floats and every divisor 1..255. An IEEE division (a MUFU reciprocal, its
// refinement and a range check with a slow path) took a quarter of the
// kernel's time on the H100 (PERF.md).
//
// Bound on the H100: bytes, each taken frame read once and written once,
// 2 * H * W * 3 * 4 B (1.2 MB at 224^2; 86.7 MB for 72 frames, 26 us at
// 3.35 TB/s). The arithmetic (about 0.4 GFLOP at 72 frames, every mul and
// add issued apart) is not far below it on the CUDA cores, so the two
// buffers let one item's copies run under another's compute. No tensor
// cores: bit-equality needs fp32 sums in a fixed order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunk = 16;     // MCUs in a work item, at most
constexpr int kItemFloats = 768;  // floats of one MCU column in a band: 16 rows x 16 px x 3
constexpr int kBlk = 72;          // a block in shared memory: 8 rows of 9 floats
constexpr int kRow = 9;

// JAX's constants are Python floats rounded to fp32; so are these
constexpr float kYR = (float)0.299, kYG = (float)0.587, kYB = (float)0.114;
constexpr float kBR = (float)-0.168736, kBG = (float)0.331264, kBB = (float)0.5;
constexpr float kRR = (float)0.5, kRG = (float)0.418688, kRB = (float)0.081312;
constexpr float kCr2R = (float)1.402, kCb2G = (float)0.344136, kCr2G = (float)0.714136;
constexpr float kCb2B = (float)1.772;

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

struct Args {
  void* x;                // (N, H, W, 3) of the mode's type, in place
  const uint8_t* take;    // (N,)
  const float* quality;   // (N,)
  int n, h, w;
  int mcu_w, chunks, mcus, per_frame;  // MCUs across, chunks a band, MCUs a chunk, items a frame
  float d[8][8];          // the DCT matrix D[u][x]: ops/jpeg.py dct8, built on the host
};

// a value rounded to bf16 (nearest even) and back: one bf16 operation's result
__device__ __forceinline__ float rb(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

// Two pixels' RGB (6 values) of a row of the item's buffer, and back
__device__ __forceinline__ void load6(const float* p, float (&v)[6]) {
  const float2* q = reinterpret_cast<const float2*>(p);
  const float2 a = q[0], b = q[1], c = q[2];
  v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y, v[4] = c.x, v[5] = c.y;
}
__device__ __forceinline__ void load6(const __nv_bfloat16* p, float (&v)[6]) {
  const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(p);
  for (int i = 0; i < 3; ++i) {
    const float2 f = __bfloat1622float2(q[i]);
    v[2 * i] = f.x, v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void store6(float* p, const float* v) {
  float2* q = reinterpret_cast<float2*>(p);
  q[0] = make_float2(v[0], v[1]);
  q[1] = make_float2(v[2], v[3]);
  q[2] = make_float2(v[4], v[5]);
}
__device__ __forceinline__ void store6(__nv_bfloat16* p, const float* v) {
  __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(p);
  for (int i = 0; i < 3; ++i) q[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
}

// A pixel's Y - 128 and its Cb, Cr (Y, Cb, Cr each rounded to bf16 op by op
// in the bf16 mode: the mode's values, in the plain version's order)
template <bool B>
__device__ __forceinline__ void to_ycbcr(float r8, float g8, float b8, float& lum, float& cb,
                                         float& cr) {
  auto o = [](float v) { return B ? rb(v) : v; };
  const float rr = o(__fmul_rn(r8, 255.f)), gg = o(__fmul_rn(g8, 255.f)),
              bb = o(__fmul_rn(b8, 255.f));
  const float yr = B ? rb(kYR) : kYR, yg = B ? rb(kYG) : kYG, yb = B ? rb(kYB) : kYB;
  const float br = B ? rb(kBR) : kBR, bg = B ? rb(kBG) : kBG, bq = B ? rb(kBB) : kBB;
  const float cq = B ? rb(kRR) : kRR, cg = B ? rb(kRG) : kRG, cbq = B ? rb(kRB) : kRB;
  const float y = o(__fadd_rn(o(__fadd_rn(o(__fmul_rn(yr, rr)), o(__fmul_rn(yg, gg)))),
                              o(__fmul_rn(yb, bb))));
  cb = o(__fadd_rn(
      o(__fadd_rn(o(__fsub_rn(o(__fmul_rn(br, rr)), o(__fmul_rn(bg, gg)))), o(__fmul_rn(bq, bb)))),
      128.f));
  cr = o(__fadd_rn(
      o(__fsub_rn(o(__fsub_rn(o(__fmul_rn(cq, rr)), o(__fmul_rn(cg, gg)))), o(__fmul_rn(cbq, bb)))),
      128.f));
  lum = o(__fsub_rn(y, 128.f));
}

// libjpeg quality scaling, as quality_table: q already clipped to [1, 100]
__device__ __forceinline__ float table_entry(float base, float q) {
  const float scale = q < 50.f ? __fdiv_rn(5000.f, q) : __fsub_rn(200.f, __fmul_rn(2.f, q));
  return fminf(fmaxf(floorf(__fdiv_rn(__fadd_rn(__fmul_rn(base, scale), 50.f), 100.f)), 1.f),
               255.f);
}

// x / y for a divisor y in 1..255 (a table entry, or 255) whose reciprocal
// r = RN(1 / y) is given: the product x * r, then one residual step,
// q + (x - q * y) * r, each fma rounded once (Markstein's correction), with
// no reciprocal (MUFU) or range check a quotient. quantize and unit below
// are built on it; div_check holds both to the plain version's IEEE
// division for every float x and every such y.
__device__ __forceinline__ float div_fast(float x, float y, float r) {
  const float q = __fmul_rn(x, r);
  return __fmaf_rn(__fmaf_rn(-q, y, x), r, q);
}

// rint(x / t) * t with the IEEE quotient (the plain version's
// round(coef / table) * table): an infinite x passes through, and copysign
// gives a zero quotient the sign of x
__device__ __forceinline__ float quantize(float x, float t, float r) {
  const float q = fabsf(x) == __int_as_float(0x7f800000) ? x : div_fast(x, t, r);
  return __fmul_rn(copysignf(rintf(q), x), t);
}

// min(max(v / 255, 0), 1) with the IEEE quotient (the plain version's
// clamp(v / 255, 0, 1)): v clipped to [0, 255] first; r255 = RN(1 / 255)
__device__ __forceinline__ float unit(float v, float r255) {
  return div_fast(fminf(fmaxf(v, 0.f), 255.f), 255.f, r255);
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
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               ::"l"(dst), "r"(smem_u32(src)), "r"(bytes)
               : "memory");
}

// Block-wide: the index of the k-th frame (from 0) whose take byte is set,
// or -1. The cursor (base: the first frame of the tile the scan stands on;
// before: the taken frames ahead of it) only moves forward, so a CTA whose k
// never decreases reads `take` once.
__device__ int kth_taken(const uint8_t* take, int n, int k, int& base, int& before,
                         int* counts, int* found) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  while (base < n) {
    const int i = base + t;
    const bool tk = i < n && take[i] != 0;
    const unsigned bal = __ballot_sync(0xffffffffu, tk);
    if (lane == 0) counts[warp] = __popc(bal);
    __syncthreads();
    int ahead = before, tile = 0;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) {
      if (v < warp) ahead += counts[v];
      tile += counts[v];
    }
    if (tk && ahead + __popc(bal & ((1u << lane) - 1u)) == k) *found = i;
    __syncthreads();
    if (k < before + tile) return *found;
    before += tile;
    base += kThreads;
  }
  return -1;
}

// A work item: its first pixel in x and its MCUs across
template <typename T>
struct Item {
  T* g;
  int mcus;
};

template <typename T>
__device__ __forceinline__ Item<T> item_at(const Args& a, int item, int frame) {
  const int r = item % a.per_frame, band = r / a.chunks;
  const int c0 = (r - band * a.chunks) * a.mcus;
  return {static_cast<T*>(a.x) + (static_cast<size_t>(frame) * a.h + band * 16) * a.w * 3 +
              c0 * 48,
          min(a.mcus, a.mcu_w - c0)};
}

// thread 0: the item's 16 row segments into ``buf``
template <typename T>
__device__ void load_item(const Args& a, const Item<T>& it, T* buf, uint64_t* bar) {
  const uint32_t row = it.mcus * 48 * sizeof(T);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(16 * row)
               : "memory");
  if (it.mcus == a.mcu_w) {
    bulk_load(buf, it.g, 16 * row, bar);   // the whole band: one run of bytes
  } else {
    for (int r = 0; r < 16; ++r)
      bulk_load(buf + r * it.mcus * 48, it.g + static_cast<size_t>(r) * a.w * 3, row, bar);
  }
}

// thread 0: ``buf`` over the item's 16 row segments
template <typename T>
__device__ void store_item(const Args& a, const Item<T>& it, const T* buf) {
  const uint32_t row = it.mcus * 48 * sizeof(T);
  if (it.mcus == a.mcu_w) {
    bulk_store(it.g, buf, 16 * row);
  } else {
    for (int r = 0; r < 16; ++r)
      bulk_store(it.g + static_cast<size_t>(r) * a.w * 3, buf + r * it.mcus * 48, row);
  }
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// o[i] = sum_k m[i][k] v[k] (T: m[k][i]), k = 0..7 left to right
template <bool T>
__device__ __forceinline__ void contract(const float (&m)[8][8], const float (&v)[8],
                                         float (&o)[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float s = __fmul_rn(T ? m[0][i] : m[i][0], v[0]);
#pragma unroll
    for (int k = 1; k < 8; ++k) s = __fadd_rn(s, __fmul_rn(T ? m[k][i] : m[i][k], v[k]));
    o[i] = s;
  }
}

__device__ __forceinline__ void load_line(const float* p, int step, float (&v)[8]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = p[k * step];
}

__device__ __forceinline__ void store_line(float* p, int step, const float (&v)[8]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) p[k * step] = v[k];
}

// rint(o / tq) * tq over a row of 8 coefficients, the row's table entries
// and their reciprocals read 4 at a time
__device__ __forceinline__ void quantize_row(float (&o)[8], const float* tab, const float* rtab) {
  float tq[8], rq[8];
  *reinterpret_cast<float4*>(tq) = reinterpret_cast<const float4*>(tab)[0];
  *reinterpret_cast<float4*>(tq + 4) = reinterpret_cast<const float4*>(tab)[1];
  *reinterpret_cast<float4*>(rq) = reinterpret_cast<const float4*>(rtab)[0];
  *reinterpret_cast<float4*>(rq + 4) = reinterpret_cast<const float4*>(rtab)[1];
#pragma unroll
  for (int k = 0; k < 8; ++k) o[k] = quantize(o[k], tq[k], rq[k]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2) jpeg_bands(const __grid_constant__ Args a) {
  constexpr bool kBf16 = sizeof(T) == 2;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  __shared__ __align__(8) uint64_t bars[2];
  __shared__ __align__(16) float tab[2][64];    // the item's luma and chroma tables
  __shared__ __align__(16) float rtab[2][64];   // their reciprocals, RN(1 / entry)
  __shared__ int counts[kWarps], found;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const float r255 = __fdiv_rn(1.f, 255.f);
  const int buf_floats = a.mcus * kItemFloats;   // an item buffer; there are two
  float* blk = reinterpret_cast<float*>(smem + 2 * buf_floats);   // 4 m luma, m Cb, m Cr blocks

  if (t == 0) {
    for (int i = 0; i < 2; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(&bars[i])), "r"(1)
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  int base = 0, before = 0;
  int item = blockIdx.x;
  int frame = kth_taken(a.take, a.n, item / a.per_frame, base, before, counts, &found);
  if (frame < 0) return;
  Item<T> it = item_at<T>(a, item, frame);
  if (t == 0) load_item(a, it, smem, &bars[0]);

#pragma unroll 1
  for (int j = 0;; ++j) {
    T* buf = smem + (j & 1) * buf_floats;
    const int m = it.mcus, cells_w = 8 * m, row_f = 48 * m;
    const int cell_magic = ((1 << 20) + cells_w - 1) / cells_w;
    const int next = item + gridDim.x;
    const int next_frame = kth_taken(a.take, a.n, next / a.per_frame, base, before, counts,
                                     &found);
    if (t < 128) {
      const float q = fminf(fmaxf(a.quality[frame], 1.f), 100.f);
      const float e = table_entry(t < 64 ? kLuma[t] : kChroma[t - 64], q);
      tab[t >> 6][t & 63] = e;
      rtab[t >> 6][t & 63] = __fdiv_rn(1.f, e);
    }
    mbar_wait(&bars[j & 1], (j >> 1) & 1);

    // 1. colour: a thread a 2x2 cell
    float* cbb = blk + 4 * m * kBlk;
    float* crb = blk + 5 * m * kBlk;
#pragma unroll 1
    for (int c = t; c < 8 * cells_w; c += kThreads) {
      const int ci = (c * cell_magic) >> 20, cj = c - ci * cells_w;   // c / cells_w exactly
      // the cell's luma in its block: rows 2 (ci & 3) + dy, columns 2 (cj & 3) + dx
      float* lum = blk + ((ci >> 2) * 2 * m + (cj >> 2)) * kBlk + (ci & 3) * 2 * kRow +
                   (cj & 3) * 2;
      float cbs[4], crs[4];
#pragma unroll
      for (int dy = 0; dy < 2; ++dy) {
        float px[6];
        load6(buf + (2 * ci + dy) * row_f + cj * 6, px);
#pragma unroll
        for (int dx = 0; dx < 2; ++dx)
          to_ycbcr<kBf16>(px[3 * dx], px[3 * dx + 1], px[3 * dx + 2], lum[dy * kRow + dx],
                          cbs[dy * 2 + dx], crs[dy * 2 + dx]);
      }
      // the 2x2 mean in fp32 (rounded to bf16 in the bf16 mode), then - 128
      auto o = [](float v) { return kBf16 ? rb(v) : v; };
      const int at = (cj >> 3) * kBlk + ci * kRow + (cj & 7);
      cbb[at] = o(__fsub_rn(
          o(__fmul_rn(__fadd_rn(__fadd_rn(__fadd_rn(cbs[0], cbs[1]), cbs[2]), cbs[3]), 0.25f)),
          128.f));
      crb[at] = o(__fsub_rn(
          o(__fmul_rn(__fadd_rn(__fadd_rn(__fadd_rn(crs[0], crs[1]), crs[2]), crs[3]), 0.25f)),
          128.f));
    }
    __syncthreads();

    // the buffer has been read: the store that last read the other one is
    // waited for, and the next item's rows fill it under this item's DCTs
    if (t == 0 && next_frame >= 0) {
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      load_item(a, item_at<T>(a, next, next_frame), smem + ((j + 1) & 1) * buf_floats,
                &bars[(j + 1) & 1]);
    }

    // 2. DCTs: a warp 4 blocks, a thread a line of one
    const int nb = 6 * m;
#pragma unroll 1
    for (int b0 = warp * 4; b0 < nb; b0 += kWarps * 4) {
      const int b = b0 + (lane >> 3), l = lane & 7;
      const bool on = b < nb;
      float* col = blk + b * kBlk + l;          // column l: step kRow
      float* row = blk + b * kBlk + l * kRow;   // row l: step 1
      float v[8], o[8];
      if (on) {   // forward, over the rows: t[u][l] = sum_k d[u][k] b[k][l]
        load_line(col, kRow, v);
        contract<false>(a.d, v, o);
        store_line(col, kRow, o);
      }
      __syncwarp();
      if (on) {   // over the columns: coef[l][v] = sum_k d[v][k] t[l][k]; quantize
        load_line(row, 1, v);
        contract<false>(a.d, v, o);
        const int tt = b < 4 * m ? 0 : 1;
        quantize_row(o, tab[tt] + l * 8, rtab[tt] + l * 8);
        store_line(row, 1, o);
      }
      __syncwarp();
      if (on) {   // inverse, over the rows: s[x][l] = sum_k d[k][x] q[k][l]
        load_line(col, kRow, v);
        contract<true>(a.d, v, o);
        store_line(col, kRow, o);
      }
      __syncwarp();
      if (on) {   // over the columns: rec[l][y] = sum_k d[k][y] s[l][k], + 128
        load_line(row, 1, v);
        contract<true>(a.d, v, o);
#pragma unroll
        for (int k = 0; k < 8; ++k) o[k] = __fadd_rn(o[k], 128.f);
        store_line(row, 1, o);
      }
      __syncwarp();
    }
    __syncthreads();

    // 3. back to RGB, a thread a cell, over the item's buffer
#pragma unroll 1
    for (int c = t; c < 8 * cells_w; c += kThreads) {
      const int ci = (c * cell_magic) >> 20, cj = c - ci * cells_w;
      const float* lum = blk + ((ci >> 2) * 2 * m + (cj >> 2)) * kBlk + (ci & 3) * 2 * kRow +
                         (cj & 3) * 2;
      const int at = (cj >> 3) * kBlk + ci * kRow + (cj & 7);
      const float cb = __fsub_rn(cbb[at], 128.f), cr = __fsub_rn(crb[at], 128.f);
      const float rc = __fmul_rn(kCr2R, cr), gb = __fmul_rn(kCb2G, cb),
                  gc = __fmul_rn(kCr2G, cr), bc = __fmul_rn(kCb2B, cb);
      float out[12];
#pragma unroll
      for (int i = 0; i < 4; ++i) {   // pixel (dy, dx) = (i >> 1, i & 1)
        const float y = lum[(i >> 1) * kRow + (i & 1)];
        out[3 * i + 0] = unit(__fadd_rn(y, rc), r255);
        out[3 * i + 1] = unit(__fsub_rn(__fsub_rn(y, gb), gc), r255);
        out[3 * i + 2] = unit(__fadd_rn(y, bc), r255);
      }
#pragma unroll
      for (int dy = 0; dy < 2; ++dy) store6(buf + (2 * ci + dy) * row_f + cj * 6, out + 6 * dy);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");   // to the bulk store
    __syncthreads();
    if (t == 0) store_item(a, it, buf);
    if (next_frame < 0) break;
    item = next;
    frame = next_frame;
    it = item_at<T>(a, item, frame);
  }
  if (t == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Every float x (all 2^32 bit patterns) against the plain version's IEEE
// arithmetic: quantize(x, t) for each table entry t = 1..255 against
// rint(x / t) * t, and unit(x) against min(max(x / 255, 0), 1). The count of
// results that differ in any bit (NaN and NaN alike) into *bad.
__global__ void __launch_bounds__(256) div_check(unsigned long long* bad) {
  __shared__ float recip[256];
  for (int y = threadIdx.x; y < 256; y += blockDim.x)
    recip[y] = y ? __fdiv_rn(1.f, static_cast<float>(y)) : 0.f;
  __syncthreads();
  auto differ = [](float a, float b) {
    return __float_as_uint(a) != __float_as_uint(b) && !(a != a && b != b);
  };
  unsigned long long mine = 0;
  for (uint64_t i = blockIdx.x * static_cast<uint64_t>(blockDim.x) + threadIdx.x; i < (1ull << 32);
       i += static_cast<uint64_t>(gridDim.x) * blockDim.x) {
    const float x = __uint_as_float(static_cast<uint32_t>(i));
    mine += differ(unit(x, recip[255]), fminf(fmaxf(__fdiv_rn(x, 255.f), 0.f), 1.f));
#pragma unroll 5
    for (int t = 1; t < 256; ++t) {
      const float ft = static_cast<float>(t);
      mine += differ(quantize(x, ft, recip[t]), __fmul_rn(rintf(__fdiv_rn(x, ft)), ft));
    }
  }
  for (int o = 16; o; o >>= 1) mine += __shfl_xor_sync(0xffffffffu, mine, o);
  if ((threadIdx.x & 31) == 0 && mine) atomicAdd(bad, mine);
}

}  // namespace

// x: (n, h, w, 3), fp32 or with bf16 = 1 bfloat16; chunks, mcus: ops/jpeg.py
// band_chunks(h, w); dct: the 64 floats of dct8 in host memory
extern "C" int fac_jpeg_subset(void* x, const uint8_t* take, const float* quality,
                               const float* dct, int n, int h, int w, int chunks, int mcus,
                               int bf16, cudaStream_t stream) {
  if (n <= 0) return 0;
  const int mcu_w = w / 16;
  if (h <= 0 || w <= 0 || h % 16 || w % 16 || mcus < 1 || mcus > kMaxChunk ||
      (chunks - 1) * mcus >= mcu_w || chunks * mcus < mcu_w ||
      reinterpret_cast<uintptr_t>(x) % 16)
    return cudaErrorInvalidValue;
  const long long per_frame = static_cast<long long>(h / 16) * chunks;
  if (per_frame * n > 0x3fffffffLL) return cudaErrorInvalidValue;   // item + grid fits an int
  Args a;
  a.x = x;
  a.take = take;
  a.quality = quality;
  a.n = n;
  a.h = h;
  a.w = w;
  a.mcu_w = mcu_w;
  a.chunks = chunks;
  a.mcus = mcus;
  a.per_frame = static_cast<int>(per_frame);
  for (int i = 0; i < 64; ++i) a.d[i / 8][i % 8] = dct[i];
  // two item buffers and the item's blocks
  const int esize = bf16 ? 2 : 4;
  const int smem = mcus * (2 * kItemFloats * esize + 6 * kBlk * 4);
  const void* fn = bf16 ? reinterpret_cast<const void*>(jpeg_bands<__nv_bfloat16>)
                        : reinterpret_cast<const void*>(jpeg_bands<float>);
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, smem)) !=
          cudaSuccess)
    return static_cast<int>(e);
  const long long grid = std::min<long long>(static_cast<long long>(sms) * std::max(per_sm, 1),
                                             per_frame * n);
  if (bf16)
    jpeg_bands<__nv_bfloat16><<<static_cast<unsigned>(grid), kThreads, smem, stream>>>(a);
  else
    jpeg_bands<float><<<static_cast<unsigned>(grid), kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// div_check over its whole range, counting into *bad (zeroed by the caller)
extern "C" int fac_jpeg_div_check(unsigned long long* bad, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(e);
  div_check<<<sms * 8, 256, 0, stream>>>(bad);
  return static_cast<int>(cudaGetLastError());
}
