// Shared core of K3 (quant_conv.cu) and K4 (quant_dense.cu): the JAX
// quantize prologue, an int8 GEMM on the tensor cores with exact int32
// sums, and the dequant epilogue of fac_fake_tpu/models/layers.py
// QuantConv3x3 / QuantDense:
//
//   q(v)    = clip(rint(v / s_x), -127, 127)          IEEE division, half to even
//   C[m][o] = sum_k q(A)[m][k] * Wq[o][k]             exact int32
//   out     = C[m][o] * (s_x * s_w[o]) (+ b[o])       fp32, then fp32 or bf16
//
// Two kernels a call (three with a K split):
//  1. quantize_rows: the fp32 or bf16 activations (rows x C) -> int8 (rows x
//     Cp), Cp = C rounded up to 16 with zero channels, one division per
//     element. (A first design quantized on the GEMM's load instead: every
//     element was then divided again for each of the 9 taps and each column
//     of output tiles, 72 times at Cout 512, and the divisions bound the
//     conv at ~44 int8 TOP/s on the H100.)
//  2. qgemm: C = A Wq^T with A the int8 rows (dense) or the 3x3 patches of
//     the int8 NHWC image gathered on the fly (implicit-GEMM conv, k ordered
//     (dy, dx, c)); Wq is (N, taps * Cp) int8, K-major, the `col` operand of
//     mma.sync.m16n8k32.s32.s8.s8.s32 as stored. Tiles of BM x BN x 64 bytes
//     stream in with 16-byte cp.async (zero-fill for the image border, the
//     ragged edges and the padded taps) through a 3-stage ring in shared
//     memory; fragments load with ldmatrix; each warp owns a 32 x 32 block
//     of C as 2 x 4 mma tiles. Shared rows are padded to 80 bytes, so the
//     8 row addresses of every ldmatrix phase hit distinct banks. The
//     epilogue dequantizes into a C tile in the same shared memory and
//     writes whole rows with 16-byte stores.
//  3. with a K split (K4 only): blockIdx.y takes a slice of the k-tiles and
//     adds its int32 partial sums into a zeroed workspace with atomics
//     (integer addition is exact in any order); dequant_ws applies the
//     epilogue.
//
// The quantize and the epilogue use __fdiv_rn, __fmul_rn, __fadd_rn and
// __int2float_rn, so they round as PyTorch's separate elementwise kernels
// do whatever the contraction flags; the library is built with -fmad=false
// besides.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace qmma {

constexpr int kBK = 64;         // k (int8 values) per tile
constexpr int kRow = kBK + 16;  // padded shared row, bytes
constexpr int kStages = 3;

inline int pad16(int c) { return (c + 15) / 16 * 16; }

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&t.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&t.y);
  v[0] = __low2float(lo);
  v[1] = __high2float(lo);
  v[2] = __low2float(hi);
  v[3] = __high2float(hi);
}

__device__ __forceinline__ uint32_t q8(float v, float s) {
  float r = rintf(__fdiv_rn(v, s));
  r = fminf(fmaxf(r, -127.0f), 127.0f);
  return static_cast<uint32_t>(static_cast<int>(r)) & 0xFFu;
}

// x (rows, C) -> q (rows, Cp), four channels a thread; vec: C % 4 == 0 and x
// aligned for a 4-value load.
template <typename T>
__global__ void quantize_rows(const T* __restrict__ x, int8_t* __restrict__ q, int total4, int C,
                              int Cp, const float* __restrict__ x_scale, int vec) {
  const float s = *x_scale;
  const int g4 = Cp / 4;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total4; i += gridDim.x * blockDim.x) {
    const int row = i / g4, c = (i - row * g4) * 4;
    const T* src = x + static_cast<size_t>(row) * C + c;
    float v[4];
    if (vec && c < C) {
      load4(src, v);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = (c + j < C) ? to_f(src[j]) : 0.0f;
    }
    const uint32_t packed = q8(v[0], s) | (q8(v[1], s) << 8) | (q8(v[2], s) << 16) |
                            (q8(v[3], s) << 24);
    *reinterpret_cast<uint32_t*>(q + static_cast<size_t>(row) * Cp + c) = packed;
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; bytes == 0 writes zeros and reads nothing
__device__ __forceinline__ void cp16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float dequant(int acc, float sx, float sw, const float* bias, int col) {
  float y = __fmul_rn(__int2float_rn(acc), __fmul_rn(sx, sw));
  if (bias != nullptr) y = __fadd_rn(y, bias[col]);
  return y;
}

__device__ __forceinline__ void store(void* out, size_t i, float y, int out_bf16) {
  if (out_bf16) {
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(y);
  } else {
    static_cast<float*>(out)[i] = y;
  }
}

// Epilogue parameters shared by both kernels.
struct Epi {
  const float* w_scale;  // (N,)
  const float* x_scale;  // 0-d, on the device
  const float* bias;     // (N,) or null
  void* out;             // (M, N), fp32 or bf16
  int out_bf16;
  int* ws;               // (M, N) int32 partial sums when split, else null
};

// Dynamic shared memory of a BM x BN tile: the ring of A and B tiles, and
// after the k loop the fp32 C tile (rows padded by 4 floats) in its place.
template <int BM, int BN>
constexpr int smem_bytes() {
  return kStages * (BM + BN) * kRow > BM * (BN + 4) * 4 ? kStages * (BM + BN) * kRow
                                                        : BM * (BN + 4) * 4;
}

// The int8 A operand: rows of Cp channels; with CONV, the 3x3 patches of an
// (B, H, W, Cp) image, else the rows themselves (K = Cp).
struct AOperand {
  const int8_t* q;
  int M, Cp, H, W;
};

template <int WM, int WN, bool CONV>
__global__ void __launch_bounds__(WM * WN * 32)
    qgemm(AOperand a, const int8_t* __restrict__ wq, int N, int K, int n_tiles,
          int k_tiles_per_split, Epi e) {
  constexpr int NT = WM * WN * 32;
  constexpr int BM = 32 * WM, BN = 32 * WN;
  constexpr int CH = kBK / 16;               // 16-byte chunks a tile row
  constexpr int A_PER = BM * CH / NT;        // A chunks a thread
  static_assert(BM * CH % NT == 0, "A chunks");

  constexpr int CS = BN + 4;  // C tile row stride, floats (see smem_bytes)
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t (*As)[BM * kRow] = reinterpret_cast<uint8_t (*)[BM * kRow]>(smem);
  uint8_t (*Bs)[BN * kRow] = reinterpret_cast<uint8_t (*)[BN * kRow]>(smem + kStages * BM * kRow);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WN, wn = warp % WN;
  const int n0 = (blockIdx.x % n_tiles) * BN;
  const int m0 = (blockIdx.x / n_tiles) * BM;
  const int k_tiles = (K + kBK - 1) / kBK;
  const int kt0 = blockIdx.y * k_tiles_per_split;
  const int kt1 = min(kt0 + k_tiles_per_split, k_tiles);
  const int M = a.M;

  // this thread's A chunks: chunk column j (fixed), rows r_i
  const int j = tid % CH;
  int am[A_PER], ay[A_PER], ax[A_PER];
#pragma unroll
  for (int i = 0; i < A_PER; ++i) {
    const int m = m0 + tid / CH + i * (NT / CH);
    am[i] = m < M ? m : -1;
    if (CONV && m < M) {
      ax[i] = m % a.W;
      ay[i] = (m / a.W) % a.H;
    } else {
      ax[i] = ay[i] = 0;
    }
  }

  auto load_tile = [&](int stage, int kt) {
    const int k = kt * kBK + 16 * j;
    int tap = 0, c = k, dy = 0, dx = 0;
    if (CONV) {
      tap = k / a.Cp;
      c = k - tap * a.Cp;
      dy = tap / 3 - 1;
      dx = tap % 3 - 1;
    }
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const int r = tid / CH + i * (NT / CH);
      const int8_t* src = a.q;
      int bytes = 0;
      if (am[i] >= 0) {
        if (CONV) {
          const int yy = ay[i] + dy, xx = ax[i] + dx;
          if (tap < 9 && yy >= 0 && yy < a.H && xx >= 0 && xx < a.W) {
            src = a.q + static_cast<size_t>(am[i] + dy * a.W + dx) * a.Cp + c;
            bytes = 16;
          }
        } else if (k < K) {
          src = a.q + static_cast<size_t>(am[i]) * a.Cp + k;
          bytes = 16;
        }
      }
      cp16(&As[stage][r * kRow + 16 * j], src, bytes);
    }
    for (int id = tid; id < BN * CH; id += NT) {
      const int r = id / CH, kk = kt * kBK + 16 * (id % CH);
      const int n = n0 + r;
      const bool ok = n < N && kk < K;
      cp16(&Bs[stage][r * kRow + 16 * (id % CH)],
           ok ? wq + static_cast<size_t>(n) * K + kk : wq, ok ? 16 : 0);
    }
  };

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][t][r] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (kt0 + s < kt1) load_tile(s, kt0 + s);
    cp_commit();
  }
  // ldmatrix row addresses within a warp's 32 x 32 block
  const int a_row = (lane % 8) + 8 * ((lane / 8) % 2), a_col = 16 * (lane / 16);
  const int b_row = (lane % 8) + 8 * (lane / 16), b_col = 16 * ((lane / 8) % 2);

  for (int kt = kt0; kt < kt1; ++kt) {
    cp_wait<kStages - 2>();
    __syncthreads();
    const int nxt = kt + kStages - 1;
    if (nxt < kt1) load_tile((nxt - kt0) % kStages, nxt);
    cp_commit();
    const uint8_t* as = As[(kt - kt0) % kStages];
    const uint8_t* bs = Bs[(kt - kt0) % kStages];
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 32) {
      uint32_t af[2][4], bf[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldsm_x4(af[i], as + (wm * 32 + i * 16 + a_row) * kRow + ks + a_col);
#pragma unroll
      for (int p = 0; p < 2; ++p)
        ldsm_x4(bf[p], bs + (wn * 32 + p * 16 + b_row) * kRow + ks + b_col);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int t = 0; t < 4; ++t)
          mma_s8(acc[i][t], af[i], bf[t / 2][2 * (t % 2)], bf[t / 2][2 * (t % 2) + 1]);
    }
  }
  cp_wait<0>();

  // C fragment: c0, c1 at (g, 2t..2t+1), c2, c3 at (g + 8, 2t..2t+1)
  const int g = lane >> 2, tq = lane & 3;
  if (e.ws != nullptr) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = m0 + wm * 32 + i * 16 + g + (r >= 2 ? 8 : 0);
          const int col = n0 + wn * 32 + t * 8 + tq * 2 + (r & 1);
          if (row < M && col < N) atomicAdd(&e.ws[static_cast<size_t>(row) * N + col], acc[i][t][r]);
        }
    return;
  }
  // dequantize into a shared C tile, then write whole rows with 16-byte stores
  const float sx = *e.x_scale;
  float* cs = reinterpret_cast<float*>(smem);
  __syncthreads();  // every warp is done reading the ring
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm * 32 + i * 16 + g + 8 * h, c = wn * 32 + t * 8 + tq * 2;
        float2 y = make_float2(0.0f, 0.0f);
        if (n0 + c < N) y.x = dequant(acc[i][t][2 * h], sx, e.w_scale[n0 + c], e.bias, n0 + c);
        if (n0 + c + 1 < N)
          y.y = dequant(acc[i][t][2 * h + 1], sx, e.w_scale[n0 + c + 1], e.bias, n0 + c + 1);
        *reinterpret_cast<float2*>(&cs[r * CS + c]) = y;
      }
  __syncthreads();
  const bool vec = (N % 4 == 0);
  for (int idx = tid; idx < BM * (BN / 4); idx += NT) {
    const int r = idx / (BN / 4), c = (idx % (BN / 4)) * 4;
    const int row = m0 + r, col = n0 + c;
    if (row >= M || col >= N) continue;
    const float4 y = *reinterpret_cast<const float4*>(&cs[r * CS + c]);
    const size_t o = static_cast<size_t>(row) * N + col;
    if (vec) {
      if (e.out_bf16) {
        __nv_bfloat162 lo = __floats2bfloat162_rn(y.x, y.y);
        __nv_bfloat162 hi = __floats2bfloat162_rn(y.z, y.w);
        uint2 packed;
        packed.x = *reinterpret_cast<uint32_t*>(&lo);
        packed.y = *reinterpret_cast<uint32_t*>(&hi);
        *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(e.out) + o) = packed;
      } else {
        *reinterpret_cast<float4*>(static_cast<float*>(e.out) + o) = y;
      }
    } else {
      const float v[4] = {y.x, y.y, y.z, y.w};
      for (int q = 0; q < 4 && col + q < N; ++q) store(e.out, o + q, v[q], e.out_bf16);
    }
  }
}

// The epilogue over split-K partial sums.
__global__ void dequant_ws(int M, int N, Epi e) {
  const float sx = *e.x_scale;
  const size_t total = static_cast<size_t>(M) * N;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int col = static_cast<int>(i % N);
    store(e.out, i, dequant(e.ws[i], sx, e.w_scale[col], e.bias, col), e.out_bf16);
  }
}

inline int grid_for(long long work, int threads) {
  long long b = (work + threads - 1) / threads;
  if (b > 132 * 16) b = 132 * 16;
  return static_cast<int>(b < 1 ? 1 : b);
}

// Quantize x (rows x C, fp32 or bf16) into xq (rows x Cp), then C = A Wq^T
// and the epilogue. wq is (N, taps * Cp); splits > 1 needs e.ws.
template <int WM, int WN, bool CONV>
cudaError_t run(const void* x, int x_bf16, int rows, int C, int8_t* xq, int H, int W,
                const int8_t* wq, int N, int splits, Epi e, cudaStream_t stream) {
  constexpr int BM = 32 * WM, BN = 32 * WN;
  const int Cp = pad16(C);
  const long long total4 = static_cast<long long>(rows) * (Cp / 4);
  if (total4 > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(xq) % 16 != 0 || reinterpret_cast<uintptr_t>(wq) % 16 != 0)
    return cudaErrorMisalignedAddress;
  const int t4 = static_cast<int>(total4);
  if (x_bf16) {
    const int vec = C % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 8 == 0;
    quantize_rows<__nv_bfloat16><<<grid_for(t4, 256), 256, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), xq, t4, C, Cp, e.x_scale, vec);
  } else {
    const int vec = C % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
    quantize_rows<float><<<grid_for(t4, 256), 256, 0, stream>>>(
        static_cast<const float*>(x), xq, t4, C, Cp, e.x_scale, vec);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int K = (CONV ? 9 : 1) * Cp;
  const int n_tiles = (N + BN - 1) / BN;
  const long long tiles = static_cast<long long>((rows + BM - 1) / BM) * n_tiles;
  const int k_tiles = (K + kBK - 1) / kBK;
  if (splits < 1) splits = 1;
  const int per = (k_tiles + splits - 1) / splits;
  splits = (k_tiles + per - 1) / per;
  if (tiles > 0x7fffffffLL || splits > 65535) return cudaErrorInvalidValue;
  if (splits > 1) {
    if (e.ws == nullptr) return cudaErrorInvalidValue;
    err = cudaMemsetAsync(e.ws, 0, static_cast<size_t>(rows) * N * sizeof(int), stream);
    if (err != cudaSuccess) return err;
  } else {
    e.ws = nullptr;
  }
  constexpr int smem = smem_bytes<BM, BN>();  // above 48 KB only when asked for
  err = cudaFuncSetAttribute(qgemm<WM, WN, CONV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  AOperand a{xq, rows, Cp, H, W};
  qgemm<WM, WN, CONV><<<dim3(static_cast<unsigned>(tiles), splits), WM * WN * 32, smem, stream>>>(
      a, wq, N, K, n_tiles, per, e);
  if (splits > 1) {
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    dequant_ws<<<grid_for(static_cast<long long>(rows) * N, 256), 256, 0, stream>>>(rows, N, e);
  }
  return cudaGetLastError();
}

}  // namespace qmma
