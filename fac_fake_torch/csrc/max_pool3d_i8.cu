// K6: int8 NDHWC max-pool, window 3 x 3 x 3, stride 1, padding 1 with the
// identity -128 (below every quantized value, which lies in [-127, 127]).
//
// Replaces: fac_fake_tpu/compat/quantize_s3d.py _max_pool3d_i8 (:85-90), a
// reduce_window over the int8 tensor: the fourth branch of an Inception mix
// pools the mix's int8 input, which is exact because max-pool commutes with
// the monotone quantizer under the shared scale. PyTorch has no int8
// max-pool.
//
// Bound on the H100: bytes, one int8 read and one int8 write an element (26
// byte maxima an element are far below the integer rate). Design: the max
// is separable, and each input byte comes from device memory once.
//  * A CTA owns one clip, a band of kBH output rows, a tile of BW output
//    columns (the full width at the pools' sizes) and a chunk of G 16-byte
//    channel groups (8 or 4 where they divide the channels, so that a chunk
//    is whole 64-byte bursts; else 8 and a short last chunk), and walks the
//    clip's T planes in order.
//  * Each input plane's tile, the band and its halo (kBH + 2 rows, BW + 2
//    columns, the ones inside the image), comes into a ring of kStages
//    planes in shared memory by 16-byte cp.async copies, so the next planes'
//    loads overlap this plane's max. Only the halo rows and columns are read
//    twice (by the neighbouring CTA, from L2).
//  * A thread owns one output column and channel group of the band: three
//    taps along W (16-byte shared loads, __vmaxs4 on four bytes a word), then
//    three along H in registers give the plane's spatial max S_t on each of
//    the band's rows; y_t = max(S_{t-1}, S_t, S_{t+1}) is a rolling window
//    of planes in registers. Each output is one 16-byte store.
//  * Edges: a column tap clamps to the edge, which repeats a value that is
//    already in the window (the window always holds its centre), so it
//    gives what -128 padding gives; a row or plane outside the image is
//    left out (uniformly across the CTA), and no tile slot outside the image
//    is loaded or read. Nothing is zero-filled: 0 is not the identity for
//    int8.
//  * 32-bit index math within a clip; no division inside the loops.
// The channels are a multiple of 16 (the int8 activations are padded to 16).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBH = 7;                 // output rows a CTA: the pools' H are 28, 14, 7
constexpr int kStages = 3;             // planes in the ring
constexpr int kMaxThreads = 256;       // BW * G
constexpr int kMaxGroups = 8;          // 16-byte channel groups a chunk
// (BW + 2) * G <= kMaxThreads + 2 * kMaxGroups slots a tile row
constexpr int kMaxSmem = kStages * (kBH + 2) * (kMaxThreads + 2 * kMaxGroups) * 16;
constexpr unsigned kIdentity = 0x80808080u;

struct Geom {
  int T, H, W, C16;   // the tensor, channels in 16-byte groups
  int G, BW, chunks;  // groups a chunk, output columns a CTA, chunks
};

__device__ __forceinline__ uint4 vmax(uint4 a, uint4 b) {
  return make_uint4(__vmaxs4(a.x, b.x), __vmaxs4(a.y, b.y), __vmaxs4(a.z, b.z),
                    __vmaxs4(a.w, b.w));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// two CTAs of 256 threads an SM at least: at most 128 registers a thread
__global__ void __launch_bounds__(kMaxThreads, 2)
max_pool3d_i8_sep(const uint4* __restrict__ x, uint4* __restrict__ y, Geom g) {
  extern __shared__ uint4 ring[];
  const int row_slots = (g.BW + 2) * g.G;          // 16-byte slots a tile row
  const int stage_slots = (kBH + 2) * row_slots;
  const int ctile = blockIdx.x / g.chunks;
  const int c0 = (blockIdx.x - ctile * g.chunks) * g.G;
  const int gc = min(g.G, g.C16 - c0);             // groups of this chunk (the last may be short)
  const int h0 = blockIdx.y * kBH, w0 = ctile * g.BW;
  const int tid = threadIdx.x, nthreads = blockDim.x;   // BW * G
  const size_t clip = static_cast<size_t>(blockIdx.z) * g.T * g.H * g.W * g.C16;
  const uint4* xb = x + clip;
  uint4* yb = y + clip;
  const int row = g.W * g.C16, plane = g.H * row;      // 16-byte groups

  // Load slots of a tile row: slot tid, and slot tid + nthreads for the 2G
  // halo-column slots left over. Slot s is tile column s / G, group s % G.
  const int col0 = tid / g.G, gi = tid - col0 * g.G;
  const int s1 = tid + nthreads;
  const int col1 = s1 / g.G, g1 = s1 - col1 * g.G;
  const int wc0 = w0 - 1 + col0, wc1 = w0 - 1 + col1;
  const bool ld0 = gi < gc && wc0 >= 0 && wc0 < g.W;
  const bool ld1 = s1 < row_slots && g1 < gc && wc1 >= 0 && wc1 < g.W;
  const int src0 = wc0 * g.C16 + c0 + gi, src1 = wc1 * g.C16 + c0 + g1;

  // The thread's output column w = w0 + col0, group gi; its three W taps,
  // clamped to the image, as slots of a tile row.
  const int w = w0 + col0;
  const int wl = g.W - 1;
  const int tap_m = (min(max(w - 1, 0), wl) - w0 + 1) * g.G + gi;
  const int tap_c = (min(w, wl) - w0 + 1) * g.G + gi;
  const int tap_p = (min(w + 1, wl) - w0 + 1) * g.G + gi;
  const bool out_col = w < g.W && gi < gc;
  const int dst = w * g.C16 + c0 + gi;

  auto load_plane = [&](int t, uint4* tile) {
    const uint4* src = xb + t * plane;
#pragma unroll
    for (int r = 0; r < kBH + 2; ++r) {
      const int hr = h0 - 1 + r;
      if (hr < 0 || hr >= g.H) continue;
      if (ld0) cp_async16(tile + r * row_slots + tid, src + hr * row + src0);
      if (ld1) cp_async16(tile + r * row_slots + s1, src + hr * row + src1);
    }
  };

  const uint4 ident = make_uint4(kIdentity, kIdentity, kIdentity, kIdentity);
  uint4 lo[kBH], mid[kBH];   // max(S_{t-1}, S_t) and S_t on each row of the band
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < g.T) load_plane(s, ring + s * stage_slots);
    cp_async_commit();
  }
  int stage = 0, fill = kStages - 1;   // ring slots of plane t and of plane t + kStages - 1
  for (int t = 0; t < g.T; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // plane t landed; plane t - 1's slot is free
    if (t + kStages - 1 < g.T) load_plane(t + kStages - 1, ring + fill * stage_slots);
    cp_async_commit();
    const uint4* tile = ring + stage * stage_slots;
    uint4 a = ident, b = ident;   // W maxima of tile rows r - 2 and r - 1
    uint4* out = yb + (t > 0 ? t - 1 : 0) * plane + dst;   // plane t - 1's outputs
#pragma unroll
    for (int r = 0; r < kBH + 2; ++r) {
      const int hr = h0 - 1 + r;
      uint4 c = ident;
      if (hr >= 0 && hr < g.H) {
        const uint4* tr = tile + r * row_slots;
        c = vmax(vmax(tr[tap_m], tr[tap_c]), tr[tap_p]);
      }
      if (r >= 2) {
        const int i = r - 2;
        const uint4 s = vmax(vmax(a, b), c);   // S_t at row h0 + i
        if (t == 0) {
          lo[i] = s;
        } else {
          if (out_col && h0 + i < g.H) out[(h0 + i) * row] = vmax(lo[i], s);
          lo[i] = vmax(mid[i], s);
        }
        mid[i] = s;
      }
      a = b;
      b = c;
    }
    stage = stage + 1 == kStages ? 0 : stage + 1;
    fill = fill + 1 == kStages ? 0 : fill + 1;
  }
  uint4* out = yb + (g.T - 1) * plane + dst;
#pragma unroll
  for (int i = 0; i < kBH; ++i)
    if (out_col && h0 + i < g.H) out[(h0 + i) * row] = lo[i];
}

// Groups a chunk: 8 or 4 where they divide the channels, else 8 (all of
// them, below 8) with a short last chunk.
int chunk_groups(int c16) {
  if (c16 % 8 == 0) return 8;
  if (c16 % 4 == 0) return 4;
  return c16 < kMaxGroups ? c16 : kMaxGroups;
}

cudaError_t set_smem_once() {
  static const cudaError_t err = cudaFuncSetAttribute(
      max_pool3d_i8_sep, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  return err;
}

}  // namespace

// x, y: (B, T, H, W, C) int8, contiguous, 16-byte aligned, C % 16 == 0.
extern "C" int fac_max_pool3d_i8(const void* x, void* y, int B, int T, int H, int W, int C,
                                 void* stream) {
  if (C % 16 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(y) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(B) * T * H * W * C == 0) return static_cast<int>(cudaSuccess);
  Geom g;
  g.T = T, g.H = H, g.W = W, g.C16 = C / 16;
  if (static_cast<long long>(T) * H * W * g.C16 >= (1LL << 31) || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);   // 32-bit offsets within a clip
  g.G = chunk_groups(g.C16);
  g.BW = W < kMaxThreads / g.G ? W : kMaxThreads / g.G;
  g.chunks = (g.C16 + g.G - 1) / g.G;
  const cudaError_t err = set_smem_once();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long gx = static_cast<long long>((W + g.BW - 1) / g.BW) * g.chunks;
  const int gy = (H + kBH - 1) / kBH;
  if (gx >= (1LL << 31) || gy > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(kStages) * (kBH + 2) * (g.BW + 2) * g.G * 16;
  max_pool3d_i8_sep<<<dim3(static_cast<unsigned>(gx), gy, B), g.BW * g.G, smem,
                      static_cast<cudaStream_t>(stream)>>>(static_cast<const uint4*>(x),
                                                           static_cast<uint4*>(y), g);
  return static_cast<int>(cudaGetLastError());
}
