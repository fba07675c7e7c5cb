// K5 and K3: the int8 3D convs of the S3D int8 walk and the int8 3x3 convs
// of the CViT stem's int8 walk (T = 1, kernel (1, 3, 3), padding (0, 1,
// 1)) — a quantize pass, and an int8 x int8 -> exact int32 implicit-GEMM
// conv with the dequant epilogue, which can quantize its output for the
// next conv.
//
// Replaces: fac_fake_tpu/compat/quantize_s3d.py _conv3d(int8=True) (:59-62),
// _quantize_in (:93-95), the epilogue of conv_step (:147-149) and _act's
// relu and relu6 (:65-70) (K5), and
// fac_fake_tpu/models/layers.py QuantConv3x3 (:106-139) with the nn.relu
// after it (K3), which XLA lowered to an int8 conv_general_dilated
// (preferred_element_type int32) with the quantize and the epilogue fused
// around it. PyTorch has no int8 convolution on CUDA.
//
//   fac_quantize_pad:  x (rows, C) fp32 or bf16 -> xq (rows, Cp) int8,
//                      q = clip(rint(x / s_x), -127, 127), Cp = C rounded up
//                      to 16 with zero channels (or to 4 for the 3-channel
//                      stem input). Its own pass where the fp tensor comes
//                      from elsewhere (the clip, a spec max-pool, a mix input
//                      that three convs and K6 share).
//   fac_int8_conv3d:   xq (B, T, H, W, Cp) int8 * wq -> out[..., c0 : c0 + N]
//                      = act(acc * s[o] + b[o]), act none, ReLU or ReLU6
//                      (the msca family's clip to [0, 6]; Act below), fp32
//                      or bf16, out rows ldo
//                      values apart (an Inception branch writes its slice of
//                      the concatenated output); or, given q_scale (the next
//                      conv's s_x), that value rounded to the walk's dtype
//                      and quantized again: int8 (B, To, Ho, Wo, pad16(N))
//                      with zero channels past N, the next conv's input.
//
// Implicit GEMM (quant_wgmma.cuh): M = B*To*Ho*Wo output positions, N =
// Cout, K = kt*kh*kw*Cp ordered (dt, dy, dx, c); wq is the (N, K) K-major
// matrix as stored, (N, kt, kh, kw, Cp). Output tiles of BM = 64 NWG
// positions (NWG consumer warpgroups, each 64 x BN on wgmma m64nBNk32) x BN
// channels, BN from Cout (16-256); NWG = 1 where 128-row tiles would leave
// SMs idle (the late 7 x 7 x 2 convs). One persistent CTA an SM walks the
// tiles; its ring (4-8 stages, 192 KB) runs on from one tile into the
// next, so loads, wgmmas and the last tile's stores overlap. TMA brings the
// weights' (BN x 128 B) tiles.
// The A operand:
//  * 1x1x1 convs: the plain (M, Cp) matrix, by TMA as well;
//  * other geometries: the producer warpgroup gathers each 16-channel chunk
//    of a tap with one 16-byte cp.async into the 128B swizzle, zero-filled
//    where the tap falls in the padding or past K, completing on the ring's
//    mbarrier; each thread owns one chunk column and up to 8 rows, and
//    advances its tap without dividing;
//  * a 3-channel image (K5's (1,7,7) stride-2 stem, K3's first 3x3): the
//    input is quantized to 4 channels (RGB and a zero), and each (dt, dy)
//    row's kw taps are kw x 4 contiguous bytes (28 for the stem), gathered
//    with 4-byte cp.asyncs into one 32-byte K chunk (taps past kw, whose
//    weights are zero, fill it): K = kt*kh*32 = 224 instead of 7*7*16 =
//    784. wq is then (N, kt*kh*32), each row's kw*4 bytes of (dx, c)
//    weights and zeros.
//
// Bound on the H100 at batch 32 (224 x 224, 20 frames): bytes for the wide
// early convs and the quantize passes, operations for the deep 1x1x1 and
// (1,3,3) convs of the mixes. The fused epilogue keeps the 39 tensors that
// one conv writes and only the next conv reads as int8 at real channels
// (the stem conv's 514 M outputs at batch 32: 0.5 GB instead of 2 GB out and
// 2 GB back in). What the epilogue costs sets the early convs' time: its
// per-value work (dequant, rounding, quantize by q8) runs after the tile's
// wgmmas on the same warps.
#include "quant_wgmma.cuh"

namespace {

using namespace qwg;

enum AMode { kGather = 0, kTma = 1, kRows4 = 2 };

// The epilogue's activations (fac_int8_conv3d's act): none, ReLU, or the
// msca family's ReLU6, a clip to [0, 6]. Each is a clamp of the value to
// [act_lo, act_hi], applied after its rounding to the output type (0 and 6
// are exact in bf16, so the clamp commutes with the rounding, as JAX's (y *
// s + b).astype(dt) then clip); where the epilogue quantizes the value, it
// is a clamp of the code to [q8(act_lo), q8(act_hi)] instead, the same
// bytes since the quantize is monotone, and free (q8's own clip).
enum Act { kActNone = 0, kActRelu = 1, kActRelu6 = 2 };

__device__ __forceinline__ float act_lo(int act) {
  return act == kActNone ? -__int_as_float(0x7f800000) : 0.0f;  // -inf
}
__device__ __forceinline__ float act_hi(int act) {
  return act == kActRelu6 ? 6.0f : __int_as_float(0x7f800000);  // +inf
}

// The int8 A operand: (B, T, H, W, Cp) image, output (B, To, Ho, Wo),
// kernel (kt, kh, kw), stride, zero padding; K = kt*kh*kw*Cp (kRows4:
// kt*kh*32).
struct Geo {
  const int8_t* q;
  int M, Cp, K;
  int T, H, W, To, Ho, Wo;
  int kt, kh, kw, st, sh, sw, pt, ph, pw;
  FastDiv dWo, dHo, dTo, dCp, dkhw, dkw, dkh;
};

struct ConvEpi {
  const float* s;        // (N,)
  const float* bias;     // (N,)
  void* out;             // fp32 / bf16 rows of ldo values, or int8 rows of pad16(N)
  int out_bf16;          // the walk's dtype is bf16 (with q_scale: round to it first)
  int act, ldo, c0, N;  // act: kActNone, kActRelu, kActRelu6
  const float* q_scale;  // 0-d, or null
};

constexpr int kRingBytes = 192 * 1024;  // the ring: as many stages as fit, at most 8
constexpr int kMaxStages = 8;

template <int BN, int NWG>
__host__ __device__ constexpr int stage_bytes() {
  return (64 * NWG + BN) * kBK;
}

template <int BN, int NWG>
__host__ __device__ constexpr int ring_stages() {
  return kRingBytes / stage_bytes<BN, NWG>() < kMaxStages ? kRingBytes / stage_bytes<BN, NWG>()
                                                          : kMaxStages;
}

// the ring, its barriers, and room to align it to 1024 bytes
template <int BN, int NWG>
__host__ __device__ constexpr int smem_bytes() {
  return ring_stages<BN, NWG>() * stage_bytes<BN, NWG>() + 2 * kMaxStages * 8 + 1024;
}

// A persistent CTA walks output tiles blockIdx.x, + gridDim.x, ... (channel
// tiles fastest, so the CTAs running together share their A rows in L2);
// the ring runs on across tiles, so the producer fills the next tile's
// stages while the consumers finish this one's wgmmas and store it.
template <int BN, int NWG, int MODE>
__global__ void __launch_bounds__(128 * (NWG + 1), 1)
    conv_wgmma(const __grid_constant__ CUtensorMap w_map, const __grid_constant__ CUtensorMap a_map,
               Geo g, ConvEpi e, int n_tiles, int tiles) {
  constexpr int BM = 64 * NWG;
  constexpr int SB = stage_bytes<BN, NWG>();
  constexpr int S = ring_stages<BN, NWG>();
  constexpr int NC = 128 * NWG;  // consumer threads
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S * SB);
  uint64_t* empty = full + S;

  const int tid = threadIdx.x, wg = tid / 128;
  const int k_tiles = (g.K + kBK - 1) / kBK;
  if (tid == NC) {
    tma_prefetch(&w_map);
    if (MODE == kTma) tma_prefetch(&a_map);
  }
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      // TMA: one arrival with the bytes; gather: also one per producer thread
      mbar_init(&full[s], MODE == kTma ? 1 : 129);
      mbar_init(&empty[s], 4 * NWG);  // lane 0 of each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == NWG) {  // ---- producer warpgroup
    if (NWG == 2) regs_dec<MODE == kTma ? 40 : 88>();
    const int p = tid - NC;
    int s = 0, phase = 0;  // the ring's next stage and its pass parity
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int n0 = (tile % n_tiles) * BN, m0 = (tile / n_tiles) * BM;
      if (MODE == kTma) {
        if (p == 0) {
          for (int i = 0; i < k_tiles; ++i) {
            mbar_wait(&empty[s], phase ^ 1);  // passes at once on the first pass
            mbar_expect_tx(&full[s], SB);
            tma_load(smem + s * SB, &a_map, &full[s], i * kBK, m0);
            tma_load(smem + s * SB + BM * kBK, &w_map, &full[s], i * kBK, n0);
            if (++s == S) s = 0, phase ^= 1;
          }
        }
        continue;
      }
      constexpr int RPT = BM / 16;  // rows a thread
      const int j = p % 8;          // this thread's 16-byte chunk column
      // each row's first input tap (t, y, x) and its pixel index (outside
      // the image where the tap is: only in-bounds taps are read); rows
      // past M get a t that no tap brings into the image
      int pix[RPT], at[RPT], ay[RPT], ax[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int m = m0 + p / 8 + 16 * i;
        pix[i] = ay[i] = ax[i] = 0;
        at[i] = -(1 << 28);
        if (m < g.M) {
          const int q1 = fdiv(m, g.dWo), q2 = fdiv(q1, g.dHo), b = fdiv(q2, g.dTo);
          const int wo = m - q1 * g.Wo, ho = q1 - q2 * g.Ho, to = q2 - b * g.To;
          at[i] = to * g.st - g.pt;
          ay[i] = ho * g.sh - g.ph;
          ax[i] = wo * g.sw - g.pw;
          pix[i] = ((b * g.T + at[i]) * g.H + ay[i]) * g.W + ax[i];
        }
      }
      // the tap of this thread's chunk in k-tile 0: channel c of tap (dt,
      // dy, dx); kRows4: half (dx0 = 0 or 4) of row (dt, dy)
      int c = 0, dt = 0, dy = 0, dx = 0;
      if (MODE == kGather) {
        const int tap = fdiv(16 * j, g.dCp);
        c = 16 * j - tap * g.Cp;
        dt = fdiv(tap, g.dkhw);
        const int r = tap - dt * g.kh * g.kw;
        dy = fdiv(r, g.dkw);
        dx = r - dy * g.kw;
      } else {
        const int row = j / 2;
        dt = fdiv(row, g.dkh);
        dy = row - dt * g.kh;
        dx = 4 * (j % 2);
      }
      for (int i = 0; i < k_tiles; ++i) {
        mbar_wait(&empty[s], phase ^ 1);
        if (p == 0) {
          mbar_expect_tx(&full[s], BN * kBK);
          tma_load(smem + s * SB + BM * kBK, &w_map, &full[s], i * kBK, n0);
        }
        const uint32_t a_base = smem_u32(smem + s * SB);
        const bool k_ok = i * kBK + 16 * j < g.K;
        const int tap_off = (dt * g.H + dy) * g.W + dx;
#pragma unroll
        for (int ii = 0; ii < RPT; ++ii) {
          const int r = p / 8 + 16 * ii;
          const uint32_t dst = a_base + r * kBK + ((j ^ (r & 7)) << 4);
          const int tt = at[ii] + dt, yy = ay[ii] + dy;
          const bool row_ok = k_ok && static_cast<unsigned>(tt) < static_cast<unsigned>(g.T) &&
                              static_cast<unsigned>(yy) < static_cast<unsigned>(g.H);
          if (MODE == kGather) {
            const int xx = ax[ii] + dx;
            const bool ok = row_ok && static_cast<unsigned>(xx) < static_cast<unsigned>(g.W);
            const int8_t* src =
                ok ? g.q + static_cast<size_t>(pix[ii] + tap_off) * g.Cp + c : g.q;
            cp16(dst, src, ok ? 16 : 0);
          } else {
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int xx = ax[ii] + dx + u;
              const bool ok = row_ok && static_cast<unsigned>(xx) < static_cast<unsigned>(g.W);
              const int8_t* src = ok ? g.q + static_cast<size_t>(pix[ii] + tap_off + u) * 4 : g.q;
              cp4(dst + 4 * u, src, ok ? 4 : 0);
            }
          }
        }
        cp_arrive(&full[s]);
        if (++s == S) s = 0, phase ^= 1;
        // the next k-tile's tap, 128 bytes on, without dividing
        if (MODE == kGather) {
          for (c += kBK; c >= g.Cp; c -= g.Cp) {
            if (++dx == g.kw) {
              dx = 0;
              if (++dy == g.kh) {
                dy = 0;
                ++dt;
              }
            }
          }
        } else {
#pragma unroll
          for (int u = 0; u < kBK / 32; ++u) {
            if (++dy == g.kh) {
              dy = 0;
              ++dt;
            }
          }
        }
      }
    }
  } else {  // ---- consumers: warpgroup wg owns rows m0 + 64 wg .. + 63 of each tile
    if (NWG == 2) regs_inc<MODE == kTma ? 232 : 208>();
    const int warp = (tid / 32) % 4, lane = tid & 31;
    const int N = e.N, Np = (N + 15) / 16 * 16;
    const bool pairs = e.ldo % 2 == 0 && e.c0 % 2 == 0;  // two values a store
    const bool quant = e.q_scale != nullptr;
    const float qs = quant ? *e.q_scale : 1.0f, qr = __frcp_rn(qs);
    // the activation: the clamp of an fp value, or of a code (Act); no
    // value here is a NaN (finite scales and biases), which the clamp of
    // an fp value with no activation would turn into -inf
    const float lo = act_lo(e.act), hi = act_hi(e.act);
    const float qlo = e.act == kActNone ? -127.0f : 0.0f;
    const float qhi = e.act == kActRelu6
                          ? static_cast<float>(static_cast<int8_t>(q8(hi, qs, qr)))
                          : 127.0f;
    int s = 0, phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int n0 = (tile % n_tiles) * BN, m0 = (tile / n_tiles) * BM;
      int acc[BN / 2];
#pragma unroll
      for (int j = 0; j < BN / 2; ++j) acc[j] = 0;
      int prev = 0;
      for (int i = 0; i < k_tiles; ++i) {
        mbar_wait(&full[s], phase);
        if (MODE != kTma) fence_proxy_async();  // the cp.async writes, to wgmma's proxy
        const uint64_t da = sw128_desc(smem + s * SB + wg * 64 * kBK);
        const uint64_t db = sw128_desc(smem + s * SB + BM * kBK);
        fence_regs(acc);  // the accumulators' last writes stay before the wgmmas
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 32; ++kk) wgmma_s8<BN>(acc, da + 2 * kk, db + 2 * kk);
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's wgmmas have retired: release it
        fence_regs(acc);
        if (i > 0 && lane == 0) mbar_arrive(&empty[prev]);
        prev = s;
        if (++s == S) s = 0, phase ^= 1;
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(&empty[prev]);

      // the epilogue, from the registers: acc[4 q + h] is row r0 + 8 (h / 2),
      // column n0 + 8 q + 2 (lane % 4) + h % 2. First every value in place,
      // rounded to the output type (a column's scale and bias loaded once,
      // no load behind a store; columns past N compute zeros), then the
      // stores, each with the activation: the code's bounds of a quantizing
      // store, the value's clamp of an fp one.
      const int r0 = m0 + wg * 64 + 16 * warp + lane / 4;
#pragma unroll
      for (int q = 0; q < BN / 8; ++q) {
        const int n = n0 + 8 * q + 2 * (lane % 4);
        const float s0 = n < N ? __ldg(e.s + n) : 0.0f, s1 = n + 1 < N ? __ldg(e.s + n + 1) : 0.0f;
        const float b0 = n < N ? __ldg(e.bias + n) : 0.0f;
        const float b1 = n + 1 < N ? __ldg(e.bias + n + 1) : 0.0f;
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const float y = __fadd_rn(__fmul_rn(__int2float_rn(acc[4 * q + h]), h % 2 ? s1 : s0),
                                    h % 2 ? b1 : b0);
          acc[4 * q + h] = __float_as_int(finish(y, e.out_bf16, 0));
        }
      }
      if (quant) {  // the next conv's int8 input: rows of Np, zero past N
#pragma unroll
        for (int q = 0; q < BN / 8; ++q) {
          const int n = n0 + 8 * q + 2 * (lane % 4);
#pragma unroll
          for (int h = 0; h < 4; h += 2) {
            const int r = r0 + 4 * h;
            if (r >= g.M || n >= Np) continue;
            const uint32_t b2 = q8(__int_as_float(acc[4 * q + h]), qs, qr, qlo, qhi) |
                                q8(__int_as_float(acc[4 * q + h + 1]), qs, qr, qlo, qhi) << 8;
            *reinterpret_cast<uint16_t*>(static_cast<int8_t*>(e.out) +
                                         static_cast<size_t>(r) * Np + n) =
                static_cast<uint16_t>(b2);
          }
        }
        continue;
      }
#pragma unroll
      for (int q = 0; q < BN / 8; ++q) {
        const int n = n0 + 8 * q + 2 * (lane % 4);
#pragma unroll
        for (int h = 0; h < 4; h += 2) {
          const int r = r0 + 4 * h;
          if (r >= g.M || n >= N) continue;
          const size_t o = static_cast<size_t>(r) * e.ldo + e.c0 + n;
          const float y0 = fminf(fmaxf(__int_as_float(acc[4 * q + h]), lo), hi);
          const float y1 = fminf(fmaxf(__int_as_float(acc[4 * q + h + 1]), lo), hi);
          if (n + 1 < N && pairs) {
            store2(e.out, o, y0, y1, e.out_bf16);
          } else {
            store1(e.out, o, y0, e.out_bf16);
            if (n + 1 < N) store1(e.out, o + 1, y1, e.out_bf16);
          }
        }
      }
    }
  }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n < 1)
      n = 132;
  }
  return n;
}

template <int BN, int NWG, int MODE>
cudaError_t launch(const CUtensorMap& wm, const CUtensorMap& am, const Geo& g, const ConvEpi& e,
                   cudaStream_t stream) {
  constexpr int smem = smem_bytes<BN, NWG>();
  static cudaError_t err = cudaFuncSetAttribute(conv_wgmma<BN, NWG, MODE>,
                                                cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int n_tiles = (e.N + BN - 1) / BN;
  const long long tiles = static_cast<long long>((g.M + 64 * NWG - 1) / (64 * NWG)) * n_tiles;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int grid = static_cast<int>(tiles < sm_count() ? tiles : sm_count());
  conv_wgmma<BN, NWG, MODE><<<grid, 128 * (NWG + 1), smem, stream>>>(
      wm, am, g, e, n_tiles, static_cast<int>(tiles));
  return cudaGetLastError();
}

template <int BN>
cudaError_t launch_bn(const CUtensorMap& wm, const CUtensorMap& am, const Geo& g,
                      const ConvEpi& e, int nwg, int mode, cudaStream_t stream) {
  if (mode == kRows4) return launch<BN, 2, kRows4>(wm, am, g, e, stream);
  if (nwg == 1)
    return mode == kTma ? launch<BN, 1, kTma>(wm, am, g, e, stream)
                        : launch<BN, 1, kGather>(wm, am, g, e, stream);
  return mode == kTma ? launch<BN, 2, kTma>(wm, am, g, e, stream)
                      : launch<BN, 2, kGather>(wm, am, g, e, stream);
}

// BN for N output channels: the fewest channels computed, counting 64 more
// for each tile (the A tile is gathered again for each)
int channels_tile(int N) {
  const int sizes[] = {16, 32, 64, 96, 128, 192, 256};
  int best = 256, cost = 1 << 30;
  for (int bn : sizes) {
    const int c = (N + bn - 1) / bn * (bn + 64);
    if (c < cost) {
      cost = c;
      best = bn;
    }
  }
  return best;
}

}  // namespace

// x: (rows, C) fp32 or bf16, contiguous; xq: (rows, Cp) int8, Cp = C rounded
// up to 16, or 4 (C <= 4, the stem's input).
extern "C" int fac_quantize_pad(const void* x, int x_bf16, const void* x_scale, void* xq,
                                int rows, int C, int Cp, void* stream) {
  if (Cp != pad16(C) && !(Cp == 4 && C <= 4)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(quantize(x, x_bf16, rows, C, Cp, static_cast<int8_t*>(xq),
                                   static_cast<const float*>(x_scale),
                                   static_cast<cudaStream_t>(stream)));
}

// g: B, T, H, W, Cp, To, Ho, Wo, N, kt, kh, kw, st, sh, sw, pt, ph, pw (host
// ints); wq: (N, kt, kh, kw, Cp) int8, or with Cp == 4 the (N, kt, kh, 32)
// rows of the stem; s, bias: (N,) fp32 device pointers; out: (B, To, Ho, Wo,
// ldo) in the walk's dtype, or with q_scale (0-d fp32) int8 (B, To, Ho, Wo,
// pad16(N)), ldo = pad16(N), c0 = 0; act: 0 none, 1 ReLU, 2 ReLU6.
extern "C" int fac_int8_conv3d(const void* xq, const void* wq, const void* s, const void* bias,
                               void* out, int out_bf16, int act, int ldo, int c0,
                               const void* q_scale, const int* g, void* stream) {
  const int B = g[0], T = g[1], H = g[2], W = g[3], Cp = g[4], To = g[5], Ho = g[6], Wo = g[7];
  const int N = g[8], kt = g[9], kh = g[10], kw = g[11];
  const long long rows = static_cast<long long>(B) * To * Ho * Wo;
  const long long pixels = static_cast<long long>(B) * T * H * W;
  const bool rows4 = Cp == 4;
  if (rows < 1 || N < 1 || rows > 0x7fffffffLL || pixels > 0x7fffffffLL || c0 + N > ldo ||
      act < kActNone || act > kActRelu6 ||
      (rows4 ? kw > 8 : Cp % 16 != 0) ||
      (q_scale != nullptr && (ldo != pad16(N) || c0 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  Geo geo{static_cast<const int8_t*>(xq),
          static_cast<int>(rows), Cp, rows4 ? kt * kh * 32 : kt * kh * kw * Cp,
          T, H, W, To, Ho, Wo,
          kt, kh, kw, g[12], g[13], g[14], g[15], g[16], g[17],
          fast_div(Wo), fast_div(Ho), fast_div(To), fast_div(Cp), fast_div(kh * kw),
          fast_div(kw), fast_div(kh)};
  const ConvEpi e{static_cast<const float*>(s), static_cast<const float*>(bias), out, out_bf16,
                  act, ldo, c0, N, static_cast<const float*>(q_scale)};
  const bool pointwise = kt == 1 && kh == 1 && kw == 1 && g[12] == 1 && g[13] == 1 &&
                         g[14] == 1 && g[15] == 0 && g[16] == 0 && g[17] == 0;
  const int mode = rows4 ? kRows4 : pointwise ? kTma : kGather;
  const int bn = channels_tile(N);
  const long long tiles128 = (rows + 127) / 128 * ((N + bn - 1) / bn);
  const int nwg = mode != kRows4 && tiles128 < 132 ? 1 : 2;
  CUtensorMap wm, am;
  cudaError_t err = tma_map(&wm, wq, N, geo.K, geo.K, bn);
  if (err == cudaSuccess)
    err = mode == kTma ? tma_map(&am, xq, rows, Cp, Cp, 64 * nwg)
                       : tma_map(&am, wq, N, geo.K, geo.K, bn);  // unused
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bn) {
    case 16: err = launch_bn<16>(wm, am, geo, e, nwg, mode, st); break;
    case 32: err = launch_bn<32>(wm, am, geo, e, nwg, mode, st); break;
    case 64: err = launch_bn<64>(wm, am, geo, e, nwg, mode, st); break;
    case 96: err = launch_bn<96>(wm, am, geo, e, nwg, mode, st); break;
    case 128: err = launch_bn<128>(wm, am, geo, e, nwg, mode, st); break;
    case 192: err = launch_bn<192>(wm, am, geo, e, nwg, mode, st); break;
    default: err = launch_bn<256>(wm, am, geo, e, nwg, mode, st); break;
  }
  return static_cast<int>(err);
}
