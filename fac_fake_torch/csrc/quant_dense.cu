// K4: int8 post-training-quantized dense, y = q(x) Wq^T * (s_x s_w) (+ b).
//
// Replaces: fac_fake_tpu/models/layers.py QuantDense (:142-176), which XLA
// lowered to one int8 dot_general with the quantize and the dequant fused
// around it. torch._int_mm would do only the GEMM.
//
// Shapes on the int8_full path (batch 96): the (96, 25088) x (25088, 1024)
// patch embedding; (192, 1024) x (1024, 3072 | 1024 | 2048) and (192, 2048)
// x (2048, 1024) in the transformer; (96, 1024) x (1024, 2048) in the head.
//
// Bound on the H100: bytes. At M <= 192 rows a weight byte is used at most
// 192 times, far below the card's ~590 int8 operations per byte of HBM, so
// the time is reading Wq (1-3 MB a transformer dense, 25.7 MB for the patch
// embedding) and x; at these sizes that is a few microseconds, so fixed
// per-launch costs and a short k loop set the time. Design (quant_wgmma.cuh):
//  * A and B swapped: out^T = Wq xq^T, so that 128 output channels fill two
//    consumer warpgroups' 64-row wgmma sides and the M activation rows are
//    wgmma's N (m64n96k32 at 96 rows, m64n192k32 at 192): one CTA covers
//    every row (up to 256) and each weight byte leaves HBM once. Both
//    operands are K-major, as s8 wgmma requires; TMA brings Wq's (128
//    channels x 128 B) and xq's (rows x 128 B) tiles into a 4-stage ring.
//  * K split inside the one launch: the `splits` CTAs of a thread-block
//    cluster (at most 8) take slices of the k-tiles, leave their int32
//    partial tiles in shared memory, and each CTA adds every CTA's partials
//    for its share of the rows through distributed shared memory, then
//    applies the epilogue to them (integer sums are exact in any order). No
//    workspace, no memset, no second kernel.
//    `ops/quant.py dense_splits` keeps a launch within 96 CTAs: more
//    clusters of 8 than that wait for free SMs.
//  * the quantize pass (one launch before) lets the GEMM launch early
//    (programmatic dependent launch): the producer issues the first stages'
//    weight loads, then waits on the quantize (griddepcontrol.wait) before
//    loading xq. Measured against the quantize folded into the producer
//    warpgroup (each CTA quantizing its rows of x into the ring), this is
//    3-10x faster a dense: the fold's loads of x wait on each other.
#include <cooperative_groups.h>

#include "quant_wgmma.cuh"

namespace {

using namespace qwg;
namespace cg = cooperative_groups;

constexpr int kChan = 128;   // output channels a CTA: two consumer warpgroups of 64
constexpr int kMaxCluster = 8;
constexpr int kStages = 4;   // the ring's stages

struct DenseArgs {
  const float* w_scale;  // (N,)
  const float* x_scale;  // 0-d
  const float* bias;     // (N,) or null
  void* out;             // (M, N), fp32 or bf16
  int out_bf16;
  int M, N, k_tiles, per, splits;
};

template <int NR>
__host__ __device__ constexpr int stage_bytes() {
  return (kChan + NR) * kBK;
}

// the ring, its barriers, and room to align the ring to 1024 bytes; the
// int32 C tile (NR x (kChan + 4)) reuses the ring after the k loop
template <int NR>
__host__ __device__ constexpr int smem_bytes() {
  return kStages * stage_bytes<NR>() + 2 * kStages * 8 + 1024;
}

template <int NR>
__global__ void __launch_bounds__(384, 1)
    dense_wgmma(const __grid_constant__ CUtensorMap w_map, const __grid_constant__ CUtensorMap x_map,
                DenseArgs p) {
  constexpr int SB = stage_bytes<NR>();
  constexpr int CS = kChan + 4;  // C tile row stride, int32
  static_assert(NR * CS * 4 <= kStages * SB, "C tile fits the ring");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * SB);
  uint64_t* empty = full + kStages;

  const int tid = threadIdx.x, wg = tid / 128;
  const int o0 = blockIdx.x * kChan, r0 = blockIdx.z * NR;
  const int kt0 = blockIdx.y * p.per;
  const int n_k = min(p.per, p.k_tiles - kt0);
  if (tid == 256) {
    tma_prefetch(&w_map);
    tma_prefetch(&x_map);
  }
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {  // ---- producer: one thread keeps the TMA loads in flight
    regs_dec<40>();
    if (tid == 256) {
      const int pre = min(n_k, kStages);
      for (int i = 0; i < pre; ++i) {
        mbar_expect_tx(&full[i], SB);
        tma_load(smem + i * SB, &w_map, &full[i], (kt0 + i) * kBK, o0);
      }
      griddep_wait();  // the quantize pass has written xq
      for (int i = 0; i < pre; ++i)
        tma_load(smem + i * SB + kChan * kBK, &x_map, &full[i], (kt0 + i) * kBK, r0);
      for (int i = pre; i < n_k; ++i) {
        const int s = i % kStages;
        mbar_wait(&empty[s], (i / kStages - 1) & 1);
        mbar_expect_tx(&full[s], SB);
        tma_load(smem + s * SB, &w_map, &full[s], (kt0 + i) * kBK, o0);
        tma_load(smem + s * SB + kChan * kBK, &x_map, &full[s], (kt0 + i) * kBK, r0);
      }
    }
    if (p.splits > 1) {  // the consumers' two cluster barriers
      __syncwarp();
      cg::this_cluster().sync();
      cg::this_cluster().sync();
    }
  } else {  // ---- consumers: warpgroup wg owns channels o0 + 64 wg .. + 63
    regs_inc<232>();
    int acc[NR / 2];
#pragma unroll
    for (int j = 0; j < NR / 2; ++j) acc[j] = 0;
    for (int i = 0; i < n_k; ++i) {
      const int s = i % kStages;
      mbar_wait(&full[s], (i / kStages) & 1);
      const uint64_t da = sw128_desc(smem + s * SB + wg * 64 * kBK);
      const uint64_t db = sw128_desc(smem + s * SB + kChan * kBK);
      fence_regs(acc);  // the accumulators' last writes stay before the wgmmas
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 32; ++kk) wgmma_s8<NR>(acc, da + 2 * kk, db + 2 * kk);
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's wgmmas have retired: release it
      fence_regs(acc);
      if (i > 0 && (tid & 31) == 0) mbar_arrive(&empty[(i - 1) % kStages]);
    }
    wgmma_wait<0>();
    fence_regs(acc);

    // the int32 tile, rows (activations) x channels, in the ring's memory
    named_sync(1, 256);  // both warpgroups are done reading the ring
    int* ct = reinterpret_cast<int*>(smem);
    const int warp = (tid / 32) % 4, lane = tid & 31;
#pragma unroll
    for (int j = 0; j < NR / 2; ++j) {
      const int o = wg * 64 + 16 * warp + lane / 4 + 8 * ((j / 2) % 2);
      const int r = 8 * (j / 4) + 2 * (lane % 4) + (j % 2);
      ct[r * CS + o] = acc[j];
    }
    int rb = 0, re = NR;
    cg::cluster_group cluster = cg::this_cluster();
    if (p.splits > 1) {
      cluster.sync();  // every CTA's partial tile is in place
      const int chunk = (NR + p.splits - 1) / p.splits;
      rb = min(NR, static_cast<int>(cluster.block_rank()) * chunk);
      re = min(NR, rb + chunk);
    } else {
      named_sync(1, 256);
    }
    const float sx = *p.x_scale;
    const bool vec = p.N % 4 == 0;
    for (int idx = tid; idx < (re - rb) * (kChan / 4); idx += 256) {
      const int rr = rb + idx / (kChan / 4), cq = (idx % (kChan / 4)) * 4;
      const int r = r0 + rr, o = o0 + cq;
      if (r >= p.M || o >= p.N) continue;
      int4 v = *reinterpret_cast<const int4*>(ct + rr * CS + cq);
      if (p.splits > 1) {  // every CTA's partial sums, this one's included
        v = make_int4(0, 0, 0, 0);
        for (int c = 0; c < p.splits; ++c) {
          const int4 w =
              *reinterpret_cast<const int4*>(cluster.map_shared_rank(ct, c) + rr * CS + cq);
          v.x += w.x;
          v.y += w.y;
          v.z += w.z;
          v.w += w.w;
        }
      }
      const int a[4] = {v.x, v.y, v.z, v.w};
      float y[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int col = min(o + u, p.N - 1);
        y[u] = epilogue(a[u], __fmul_rn(sx, p.w_scale[col]), p.bias, col, p.out_bf16, 0);
      }
      const size_t at = static_cast<size_t>(r) * p.N + o;
      if (vec) {
        store4(p.out, at, make_float4(y[0], y[1], y[2], y[3]), p.out_bf16);
      } else {
        for (int u = 0; u < 4 && o + u < p.N; ++u) store1(p.out, at + u, y[u], p.out_bf16);
      }
    }
    if (p.splits > 1) cluster.sync();  // no CTA leaves while another reads its tile
  }
}

template <int NR>
cudaError_t launch(const CUtensorMap& wm, const CUtensorMap& xm, const DenseArgs& p,
                   int row_tiles, cudaStream_t stream) {
  constexpr int smem = smem_bytes<NR>();
  static cudaError_t err =
      cudaFuncSetAttribute(dense_wgmma<NR>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  // the cluster of the K split; programmatic stream serialization lets the
  // grid start before the quantize pass launched just before it ends
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = p.splits;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((p.N + kChan - 1) / kChan, p.splits, row_tiles);
  cfg.blockDim = dim3(384);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  return cudaLaunchKernelEx(&cfg, dense_wgmma<NR>, wm, xm, p);
}

// wgmma's N for M activation rows (a row tile of 256 above that)
int rows_tile(int M) {
  const int sizes[] = {16, 32, 64, 96, 128, 192};
  for (int n : sizes)
    if (M <= n) return n;
  return 256;
}

}  // namespace

// x: (M, K) fp32 (x_bf16 == 0) or bf16, contiguous; wq: (N, Kp) int8, Kp =
// K rounded up to 16, zero past K; w_scale (N,), x_scale 0-d, bias (N,) or
// null: fp32 device pointers; out: (M, N) in x's dtype; xq: (M, Kp) int8
// scratch; splits: CTAs (one cluster) that share an output tile's k-tiles,
// 1-8.
extern "C" int fac_quant_dense(const void* x, int x_bf16, const void* wq, const void* w_scale,
                               const void* x_scale, const void* bias, void* out, int M, int N,
                               int K, int splits, void* xq, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M < 1 || N < 1 || K < 1 || splits < 1 || splits > kMaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  const int Kp = pad16(K);
  int8_t* q = static_cast<int8_t*>(xq);
  cudaError_t err = quantize(x, x_bf16, M, K, Kp, q, static_cast<const float*>(x_scale), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nr = rows_tile(M);
  DenseArgs p{static_cast<const float*>(w_scale), static_cast<const float*>(x_scale),
              static_cast<const float*>(bias), out, x_bf16, M, N, (Kp + kBK - 1) / kBK, 0, 0};
  p.per = (p.k_tiles + splits - 1) / splits;
  p.splits = (p.k_tiles + p.per - 1) / p.per;
  CUtensorMap wm, xm;
  err = tma_map(&wm, wq, N, Kp, Kp, kChan);
  if (err == cudaSuccess) err = tma_map(&xm, q, M, Kp, Kp, nr);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int row_tiles = (M + nr - 1) / nr;
  switch (nr) {
    case 16: err = launch<16>(wm, xm, p, row_tiles, st); break;
    case 32: err = launch<32>(wm, xm, p, row_tiles, st); break;
    case 64: err = launch<64>(wm, xm, p, row_tiles, st); break;
    case 96: err = launch<96>(wm, xm, p, row_tiles, st); break;
    case 128: err = launch<128>(wm, xm, p, row_tiles, st); break;
    case 192: err = launch<192>(wm, xm, p, row_tiles, st); break;
    default: err = launch<256>(wm, xm, p, row_tiles, st); break;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
