// K2: uint8 NHWC images -> the first conv's input, in one table-driven byte
// pass.
//
// Replaces: fac_fake_tpu/ops/preprocess.py normalize_imagenet (:25-29),
// which XLA fused into the first conv's input read on the TPU, and on the
// int8 paths the quantize of that input by the first int8 conv
// (fac_fake_tpu/models/layers.py:132-133 QuantConv3x3;
// compat/quantize_s3d.py:93 _quantize_in on the raw clip): XLA ran the two
// as one uint8 -> int8 fusion, and so does this kernel.
//
// Modes (one kernel, the mode a template argument):
//   0  fp32 (u / 255 - mean[c]) / std[c], JAX's order        (..., 3)
//   1  bf16: that fp32 value rounded to nearest even         (..., 3)
//   2  int8 q8(the fp32 value, x_scale), channel 3 zero      (..., 4)
//   3  int8 q8(the bf16 value, x_scale), channel 3 zero      (..., 4)
//   4  int8 q8(u, x_scale), channel 3 zero: S3D's raw clips  (..., 4)
//
// Each output value depends only on the byte and its channel. So each CTA
// first builds a 3 x 256 table in shared memory, with the device functions
// that computed those values before this design (norm1 in IEEE fp32, the
// library built with -fmad=false; q8 of q8.cuh, the quantize of K3-K5), and
// then streams: each value is one table read. The modes' outputs are
// therefore bit for bit those of the normalize and quantize passes they
// replace. x_scale is read from device memory as the table is built.
//
// Bound on the H100: bytes. In, 3 bytes a pixel; out, 12 (fp32), 6 (bf16) or 3
// (int8; it writes 4, the fourth a zero pad). Design: a warp's step is 512
// pixels (16 a lane), so every step starts at channel 0. The lanes load the
// step's 1536 input bytes as three 16-byte loads each, neighbouring lanes on
// neighbouring addresses, into the warp's stage in shared memory; the next
// step's three loads are issued before this step's values are made, so they are
// in flight during it. Each lane then takes 16-byte output chunks of the step,
// neighbouring lanes on neighbouring chunks (4 fp32 values, 8 bf16 values or 4
// int8 pixels), reads their input bytes from the stage, looks each value up and
// stores the chunk, 16 bytes a lane. A chunk's channels follow from its index
// with no division. The grid is the CTAs the card holds at once, and its warps
// stride over the steps. A misaligned input is read a byte at a time, and so is
// the ragged last step, whose chunks past the tensor's end are stored a byte at
// a time as far as it reaches.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "q8.cuh"

namespace {

enum Mode : int { kF32 = 0, kBF16 = 1, kI8F32 = 2, kI8BF16 = 3, kI8Raw = 4 };

constexpr int kThreads = 256;              // one table byte of each channel a thread
constexpr int kWarps = kThreads / 32;
constexpr int kStepPix = 512;              // a warp's step: 16 pixels a lane
constexpr int kStepVecs = 3 * kStepPix / 16;   // its input as 16-byte vectors, 3 a lane
// CTAs an SM holds at least (at most 64 registers a thread): 32 warps, each with
// its next step's 48 bytes a lane in flight
constexpr int kMinCtas = 4;

struct Norm {
  float mean[3];
  float std[3];
};

template <int M>
__host__ __device__ constexpr int out_bytes() {   // a pixel's output bytes
  return M == kF32 ? 12 : M == kBF16 ? 6 : 4;
}

__device__ __forceinline__ float norm1(uint32_t u, int c, const Norm& nm) {
  const float x = static_cast<float>(u) / 255.0f;
  return (x - nm.mean[c]) / nm.std[c];
}

// tab[c * 256 + u]: channel c's output for byte u, as 32 bits: the fp32
// value, the bf16 value's bits, or the int8 byte at bits 8c .. 8c + 7 of its
// pixel's output word. Thread u makes the three entries of byte u.
template <int M>
__device__ __forceinline__ void build_table(uint32_t* tab, const Norm& nm,
                                            const float* x_scale) {
  const uint32_t u = threadIdx.x;
  if constexpr (M == kF32 || M == kBF16) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float v = norm1(u, c, nm);
      tab[c * 256 + u] = M == kF32 ? __float_as_uint(v)
                                   : static_cast<uint32_t>(
                                         __bfloat16_as_ushort(__float2bfloat16_rn(v)));
    }
  } else {
    const float s = *x_scale, r = __frcp_rn(s);
    if constexpr (M == kI8Raw) {   // u8 -> fp32 (or bf16) is exact: one row for all channels
      const uint32_t q = qwg::q8(static_cast<float>(u), s, r);
#pragma unroll
      for (int c = 0; c < 3; ++c) tab[c * 256 + u] = q << (8 * c);
    } else {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        float v = norm1(u, c, nm);
        if (M == kI8BF16) v = __bfloat162float(__float2bfloat16_rn(v));
        tab[c * 256 + u] = qwg::q8(v, s, r) << (8 * c);
      }
    }
  }
}

__device__ __forceinline__ uint32_t byte_of(uint32_t w, int i) { return (w >> (8 * i)) & 0xFFu; }

// Output chunk k of a step (16 bytes) from the step's input bytes ``st``
// (as 32-bit words, in shared memory).
template <int M>
__device__ __forceinline__ uint4 chunk(const uint32_t* __restrict__ tab,
                                       const uint32_t* __restrict__ st, uint32_t k) {
  if constexpr (M == kF32 || M == kBF16) {
    // value i of the step has channel i mod 3: value 4k (fp32) or 8k (bf16)
    // has channel k mod 3 or 2k mod 3, the next ones the next channels
    const uint32_t c0 = (M == kF32 ? k : 2u * k) % 3u;
    const uint32_t* t0 = tab + (c0 << 8);
    const uint32_t* t1 = tab + ((c0 == 2u ? 0u : c0 + 1u) << 8);
    const uint32_t* t2 = tab + ((c0 == 0u ? 2u : c0 - 1u) << 8);
    if constexpr (M == kF32) {
      const uint32_t w = st[k];
      return make_uint4(t0[byte_of(w, 0)], t1[byte_of(w, 1)], t2[byte_of(w, 2)],
                        t0[byte_of(w, 3)]);
    } else {
      const uint2 w = reinterpret_cast<const uint2*>(st)[k];
      return make_uint4(t0[byte_of(w.x, 0)] | t1[byte_of(w.x, 1)] << 16,
                        t2[byte_of(w.x, 2)] | t0[byte_of(w.x, 3)] << 16,
                        t1[byte_of(w.y, 0)] | t2[byte_of(w.y, 1)] << 16,
                        t0[byte_of(w.y, 2)] | t1[byte_of(w.y, 3)] << 16);
    }
  } else {
    // pixels 4k .. 4k + 3: input bytes 12k .. 12k + 11, words 3k .. 3k + 2
    const uint32_t a = st[3 * k], b = st[3 * k + 1], c = st[3 * k + 2];
    const uint32_t *t0 = tab, *t1 = tab + 256, *t2 = tab + 512;
    return make_uint4(t0[byte_of(a, 0)] | t1[byte_of(a, 1)] | t2[byte_of(a, 2)],
                      t0[byte_of(a, 3)] | t1[byte_of(b, 0)] | t2[byte_of(b, 1)],
                      t0[byte_of(b, 2)] | t1[byte_of(b, 3)] | t2[byte_of(c, 0)],
                      t0[byte_of(c, 1)] | t1[byte_of(c, 2)] | t2[byte_of(c, 3)]);
  }
}

__device__ __forceinline__ uint32_t word_of(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// npix pixels of 3 bytes in -> npix pixels of out_bytes<M>() out; vec: ``in``
// is 16-byte aligned (``out`` always is)
template <int M>
__global__ void __launch_bounds__(kThreads, kMinCtas)
    normalize_table(const uint8_t* __restrict__ in, uint8_t* __restrict__ out, long long npix,
                    Norm nm, const float* __restrict__ x_scale, int vec) {
  __shared__ uint32_t tab[3 * 256];
  __shared__ uint4 stages[kWarps][kStepVecs];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint4* stage = stages[warp];
  const uint32_t* words = reinterpret_cast<const uint32_t*>(stage);
  const uint4* in4 = reinterpret_cast<const uint4*>(in);
  const long long steps = (npix + kStepPix - 1) / kStepPix;
  const long long whole = vec ? npix / kStepPix : 0;   // steps loaded 16 bytes a lane
  const long long stride = static_cast<long long>(gridDim.x) * kWarps;
  long long s = static_cast<long long>(blockIdx.x) * kWarps + warp;

  uint4 a0, a1, a2;   // the input of the warp's next whole step
  if (s < whole) {
    const uint4* p = in4 + s * kStepVecs + lane;
    a0 = p[0];
    a1 = p[32];
    a2 = p[64];
  }
  build_table<M>(tab, nm, x_scale);
  __syncthreads();

  constexpr int kChunks = kStepPix * out_bytes<M>() / 16;
  for (; s < steps; s += stride) {
    const long long px = s * kStepPix;
    int n_out = kStepPix * out_bytes<M>();   // the step's output bytes inside the tensor
    if (s < whole) {
      stage[lane] = a0;
      stage[lane + 32] = a1;
      stage[lane + 64] = a2;
      if (s + stride < whole) {
        const uint4* p = in4 + (s + stride) * kStepVecs + lane;
        a0 = p[0];
        a1 = p[32];
        a2 = p[64];
      }
    } else {
      const int n_in = static_cast<int>(min(static_cast<long long>(kStepPix), npix - px)) * 3;
      uint8_t* sb = reinterpret_cast<uint8_t*>(stage);
      const uint8_t* src = in + px * 3;
      for (int i = lane; i < 3 * kStepPix; i += 32) sb[i] = i < n_in ? src[i] : 0;
      n_out = n_in / 3 * out_bytes<M>();
    }
    __syncwarp();
    uint8_t* dst = out + px * out_bytes<M>();
#pragma unroll 2
    for (int j = 0; j < kChunks / 32; ++j) {
      const int k = lane + 32 * j;
      const uint4 v = chunk<M>(tab, words, k);
      if (16 * k + 16 <= n_out) {
        *reinterpret_cast<uint4*>(dst + 16 * k) = v;
      } else {
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          if (16 * k + i < n_out) dst[16 * k + i] = byte_of(word_of(v, i / 4), i % 4);
        }
      }
    }
    __syncwarp();   // the stage is written again by the next step
  }
}

template <int M>
cudaError_t launch(const uint8_t* in, uint8_t* out, long long npix, const Norm& nm,
                   const float* x_scale, cudaStream_t stream) {
  static int resident = 0;   // CTAs of this mode the card holds at once
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, normalize_table<M>, kThreads, 0);
    }
    if (e != cudaSuccess) return e;
    resident = sms * per_sm > 0 ? sms * per_sm : 1;
  }
  const long long steps = (npix + kStepPix - 1) / kStepPix;
  const long long want = (steps + kWarps - 1) / kWarps;
  const int blocks = static_cast<int>(want < resident ? want : resident);
  const int vec = reinterpret_cast<uintptr_t>(in) % 16 == 0;
  normalize_table<M><<<blocks, kThreads, 0, stream>>>(in, out, npix, nm, x_scale, vec);
  return cudaGetLastError();
}

}  // namespace

// in: npix pixels of an NHWC (..., 3) uint8 tensor; out: 16-byte aligned,
// npix pixels of 3 fp32 (mode 0), 3 bf16 (mode 1) or 4 int8 (modes 2-4) values.
// mean_std: host pointer to 6 floats (mean, std); x_scale: device pointer to
// the 0-d fp32 scale of the int8 modes (unused by modes 0 and 1).
extern "C" int fac_normalize_imagenet(const void* in, void* out, long long npix, int mode,
                                      const float* mean_std, const float* x_scale,
                                      void* stream) {
  if (npix < 0 || mode < kF32 || mode > kI8Raw) return static_cast<int>(cudaErrorInvalidValue);
  if (mode >= kI8F32 && x_scale == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  if (npix == 0) return static_cast<int>(cudaSuccess);
  Norm nm;
  for (int c = 0; c < 3; ++c) {
    nm.mean[c] = mean_std[c];
    nm.std[c] = mean_std[3 + c];
  }
  const uint8_t* src = static_cast<const uint8_t*>(in);
  uint8_t* dst = static_cast<uint8_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (mode) {
    case kF32: err = launch<kF32>(src, dst, npix, nm, x_scale, s); break;
    case kBF16: err = launch<kBF16>(src, dst, npix, nm, x_scale, s); break;
    case kI8F32: err = launch<kI8F32>(src, dst, npix, nm, x_scale, s); break;
    case kI8BF16: err = launch<kI8BF16>(src, dst, npix, nm, x_scale, s); break;
    default: err = launch<kI8Raw>(src, dst, npix, nm, x_scale, s); break;
  }
  return static_cast<int>(err);
}
