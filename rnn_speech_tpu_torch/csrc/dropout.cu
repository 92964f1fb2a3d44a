// Fused dropout, for Hopper (sm_90a): out = x·mask·scale in one pass.
//
// Replaces the TPU kernel `_dropout_kernel` of
// rnn_speech_tpu/ops/dropout_pallas.py (entry `dropout_pallas`): one or
// two keep probabilities, each an independent Bernoulli mask, ANDed, and
// scale = 1/(k1·k2) rounded to x's dtype as the TPU kernel rounds it.
// The TPU seeds its core generator from (seed, grid step); here every
// element's bits are Philox4x32-10 of its flat index (philox.cuh): group
// q = n >> 2 of four elements is counter (q, q >> 32, k, 0) for keep k and
// element n takes word n & 3.  So the backward, run on the cotangent of the
// same shape, regenerates the forward's mask exactly, and the plain version
// (ops/random_bits.py) computes the same bits.
//
// What bounds it on the H100: bytes.  It reads x and writes out once, 2 x
// 0.92 GB for a (3510, 64, 1024) f32 stream, 0.55 ms at 3.35 TB/s; ten
// Philox rounds per four elements and keep are a few dozen integer
// operations per element, which the memory time hides.
//
// What this design does about it: a grid-stride loop over groups of four
// elements, one Philox call per group and keep, 16-byte (f32) or 8-byte
// (bf16) vector loads and stores where the tensor is 16-byte aligned,
// elementwise for the ragged tail.
//
// Also the Bernoulli mask stream, replacing `_mask_kernel` of the same
// file (entry `bernoulli_mask_pallas`): a {0, 1} mask in f32 or bf16 that
// several consumers share (the wavefront's inter-layer masks on the
// layered-backward and materialized-mask training routes).  Its bits are
// those of the dropout kernel's first keep on the same flat index, so its
// plain version is random_bits.dropout_mask.  It reads nothing and writes
// the mask once: (2, 3510, 64, 1024) bf16 is 0.92 GB, 0.27 ms at 3.35
// TB/s, bound by bytes; the same grid-stride loop with one Philox call
// and one 8-byte (bf16) or 16-byte (f32) store per four elements.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "philox.cuh"

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }

template <typename T>
__global__ void dropout_kernel(const T* __restrict__ x, T* __restrict__ out, long long n,
                               float scale, int n_keeps, uint32_t k0, uint32_t k1,
                               uint32_t thr0, uint32_t thr1) {
  const long long groups = (n + 3) / 4;
  for (long long q = blockIdx.x * (long long)blockDim.x + threadIdx.x; q < groups;
       q += (long long)gridDim.x * blockDim.x) {
    const uint32_t lo = (uint32_t)q, hi = (uint32_t)(q >> 32);
    const rst::Words4 a = rst::philox4x32_10(lo, hi, 0u, 0u, k0, k1);
    bool keep[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) keep[i] = a.w[i] < thr0;
    if (n_keeps > 1) {
      const rst::Words4 b = rst::philox4x32_10(lo, hi, 1u, 0u, k0, k1);
#pragma unroll
      for (int i = 0; i < 4; ++i) keep[i] = keep[i] && b.w[i] < thr1;
    }
    const long long e0 = 4 * q;
    if (e0 + 4 <= n) {
      T v[4];
      if constexpr (sizeof(T) == 4) {
        *reinterpret_cast<float4*>(v) = *reinterpret_cast<const float4*>(x + e0);
      } else {
        *reinterpret_cast<uint2*>(v) = *reinterpret_cast<const uint2*>(x + e0);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = from_f<T>(keep[i] ? to_f(v[i]) * scale : 0.0f);
      if constexpr (sizeof(T) == 4) {
        *reinterpret_cast<float4*>(out + e0) = *reinterpret_cast<float4*>(v);
      } else {
        *reinterpret_cast<uint2*>(out + e0) = *reinterpret_cast<uint2*>(v);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (e0 + i < n) out[e0 + i] = from_f<T>(keep[i] ? to_f(x[e0 + i]) * scale : 0.0f);
      }
    }
  }
}

// The {0, 1} Bernoulli(keep) mask stream: element n is 1 iff word n & 3 of
// Philox4x32-10 of counter (n >> 2, n >> 34, 0, 0) is < thr, the bits of
// the dropout kernel's first keep.  It reads nothing and writes n elements.
template <typename T>
__global__ void mask_kernel(T* __restrict__ out, long long n, uint32_t k0, uint32_t k1,
                            uint32_t thr) {
  const long long groups = (n + 3) / 4;
  for (long long q = blockIdx.x * (long long)blockDim.x + threadIdx.x; q < groups;
       q += (long long)gridDim.x * blockDim.x) {
    const rst::Words4 a =
        rst::philox4x32_10((uint32_t)q, (uint32_t)(q >> 32), 0u, 0u, k0, k1);
    T v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = from_f<T>(a.w[i] < thr ? 1.0f : 0.0f);
    const long long e0 = 4 * q;
    if (e0 + 4 <= n) {
      if constexpr (sizeof(T) == 4) {
        *reinterpret_cast<float4*>(out + e0) = *reinterpret_cast<float4*>(v);
      } else {
        *reinterpret_cast<uint2*>(out + e0) = *reinterpret_cast<uint2*>(v);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (e0 + i < n) out[e0 + i] = v[i];
      }
    }
  }
}

int grid_for(long long n, int threads, int sms) {
  const long long want = ((n + 3) / 4 + threads - 1) / threads;
  return (int)(want < 8LL * sms ? want : 8LL * sms);
}

}  // namespace

// x, out: n contiguous elements, 16-byte aligned, float32 (is_f32 = 1) or
// bf16; scale already rounded to x's dtype; thr0 (and thr1 when
// n_keeps = 2) the keep thresholds; (k0, k1) the seed words.
// Returns the CUDA error code of the launch (0 = success).
extern "C" int rst_dropout(const void* x, void* out, long long n, int is_f32,
                           float scale, int n_keeps, unsigned k0, unsigned k1,
                           unsigned thr0, unsigned thr1, int sms, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const int blocks = grid_for(n, threads, sms);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_f32) {
    dropout_kernel<float><<<blocks, threads, 0, st>>>(
        static_cast<const float*>(x), static_cast<float*>(out), n, scale, n_keeps, k0,
        k1, thr0, thr1);
  } else {
    dropout_kernel<bf16><<<blocks, threads, 0, st>>>(
        static_cast<const bf16*>(x), static_cast<bf16*>(out), n, scale, n_keeps, k0, k1,
        thr0, thr1);
  }
  return (int)cudaGetLastError();
}

// out: n contiguous elements, 16-byte aligned, float32 (is_f32 = 1) or
// bf16, receiving the {0, 1} mask of keep threshold thr under the seed
// words (k0, k1).  Returns the CUDA error code of the launch.
extern "C" int rst_bernoulli_mask(void* out, long long n, int is_f32, unsigned k0,
                                  unsigned k1, unsigned thr, int sms, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const int blocks = grid_for(n, threads, sms);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_f32) {
    mask_kernel<float><<<blocks, threads, 0, st>>>(static_cast<float*>(out), n, k0, k1,
                                                   thr);
  } else {
    mask_kernel<bf16><<<blocks, threads, 0, st>>>(static_cast<bf16*>(out), n, k0, k1, thr);
  }
  return (int)cudaGetLastError();
}
