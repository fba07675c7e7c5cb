// K2: uint8 NHWC crops -> ImageNet-normalized NHWC, fp32 or bf16, one pass.
//
// Replaces: fac_fake_tpu/ops/preprocess.py normalize_imagenet (which XLA
// fused into the first conv's input read on the TPU; eager PyTorch would run
// it as a chain of elementwise passes over the crop batch).
//
// Bound on the H100: bytes. Each crop element is read once (1 B) and written
// once (4 B fp32 or 2 B bf16) and costs three flops, far below the card's
// ratio of operations to bytes. Design: each thread moves four elements at
// a time -- one 4-byte uchar4 load, one 16-byte (fp32) or 8-byte (bf16)
// store -- so every access is a full coalesced vector; a grid-stride loop
// keeps the grid at a fixed multiple of the SM count. A scalar loop takes
// the ragged tail and misaligned pointers.
//
// Arithmetic is the JAX order, x / 255 then (x - mean) / std, in IEEE fp32
// (the library is built with -fmad=false and without fast math), so the fp32
// result equals the plain PyTorch version bit for bit; bf16 rounds that fp32
// value to nearest even, as a tensor's .to(torch.bfloat16) does.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Norm {
  float mean[3];
  float std[3];
};

__device__ __forceinline__ float norm1(uint8_t u, int c, const Norm& nm) {
  float x = static_cast<float>(u) / 255.0f;
  return (x - nm.mean[c]) / nm.std[c];
}

__device__ __forceinline__ int next_c(int c) { return c == 2 ? 0 : c + 1; }

__device__ __forceinline__ void store4(float* out, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(out) = make_float4(a, b, c, d);
}

__device__ __forceinline__ void store4(__nv_bfloat16* out, float a, float b, float c, float d) {
  __nv_bfloat162 lo = __halves2bfloat162(__float2bfloat16_rn(a), __float2bfloat16_rn(b));
  __nv_bfloat162 hi = __halves2bfloat162(__float2bfloat16_rn(c), __float2bfloat16_rn(d));
  uint2 packed;
  packed.x = *reinterpret_cast<uint32_t*>(&lo);
  packed.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(out) = packed;
}

__device__ __forceinline__ void store1(float* out, float v) { *out = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* out, float v) { *out = __float2bfloat16_rn(v); }

template <typename OutT>
__global__ void normalize_vec4(const uchar4* __restrict__ in, OutT* __restrict__ out,
                               long long n4, Norm nm) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long g = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; g < n4;
       g += stride) {
    const uchar4 v = in[g];
    int c = static_cast<int>((g * 4) % 3);
    const float r0 = norm1(v.x, c, nm);
    c = next_c(c);
    const float r1 = norm1(v.y, c, nm);
    c = next_c(c);
    const float r2 = norm1(v.z, c, nm);
    c = next_c(c);
    const float r3 = norm1(v.w, c, nm);
    store4(out + g * 4, r0, r1, r2, r3);
  }
}

template <typename OutT>
__global__ void normalize_scalar(const uint8_t* __restrict__ in, OutT* __restrict__ out,
                                 long long start, long long n, Norm nm) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = start + static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    store1(out + i, norm1(in[i], static_cast<int>(i % 3), nm));
  }
}

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;

int blocks_for(long long work) {
  long long b = (work + kThreads - 1) / kThreads;
  if (b > kMaxBlocks) b = kMaxBlocks;
  return static_cast<int>(b < 1 ? 1 : b);
}

template <typename OutT>
void launch(const uint8_t* in, OutT* out, long long n, const Norm& nm, cudaStream_t stream,
            int out_align) {
  long long start = 0;
  const bool aligned = (reinterpret_cast<uintptr_t>(in) % 4 == 0) &&
                       (reinterpret_cast<uintptr_t>(out) % out_align == 0);
  if (aligned && n >= 4) {
    const long long n4 = n / 4;
    normalize_vec4<OutT><<<blocks_for(n4), kThreads, 0, stream>>>(
        reinterpret_cast<const uchar4*>(in), out, n4, nm);
    start = n4 * 4;
  }
  if (start < n) {
    normalize_scalar<OutT><<<blocks_for(n - start), kThreads, 0, stream>>>(in, out, start, n, nm);
  }
}

}  // namespace

// in: n uint8 values of an NHWC (..., 3) tensor; out: n values, fp32
// (out_bf16 == 0) or bf16. mean_std: host pointer to 6 floats (mean, std).
extern "C" int fac_normalize_imagenet(const void* in, void* out, long long n, int out_bf16,
                                      const float* mean_std, void* stream) {
  Norm nm;
  for (int c = 0; c < 3; ++c) {
    nm.mean[c] = mean_std[c];
    nm.std[c] = mean_std[3 + c];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* src = static_cast<const uint8_t*>(in);
  if (out_bf16) {
    launch(src, static_cast<__nv_bfloat16*>(out), n, nm, s, 8);
  } else {
    launch(src, static_cast<float*>(out), n, nm, s, 16);
  }
  return static_cast<int>(cudaGetLastError());
}
