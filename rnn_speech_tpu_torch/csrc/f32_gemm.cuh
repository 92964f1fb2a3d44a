// A float32 GEMM tile for Hopper (sm_90a) without tensor cores: the
// float32 compute mode's large products, which the JAX kernels compute
// inside their steps and the port runs ahead of (or between) the serial
// chains.  Three users:
//
// * the recompute backward's gate rebuild in float32 (rebuild_gates.cuh
//   ``launch_f32``, row 8 of PERF.md): [x | h_prev] · [W_x ; W_h], B in
//   (K, N) rows;
// * the float32 layer sweep of the reverse diagonal (row 4,
//   lstm_layer_bwd_f32.cu ``rst_sweep_dout_f32``): the layer below's
//   cotangent dgates · W_xᵀ, B in (N, K) rows (W_x itself);
// * the float32 layer sweep of the training forward (row 3,
//   lstm_layer_fwd_f32.cu): each layer's input product x·W_x + b into its
//   gates residual, B in (K, N) rows.
//
// C (M, N) = [A1 | A2] (M, K1 + K2) · B (K1 + K2, N), float32 sums of
// float32 operands, each output's K in ascending order, one owner thread
// per output: a run repeats bit for bit.
//
// What bounds it on the H100: 2·M·N·K operations at the float32 rate (67
// TFLOP/s); at the rebuild's shape (K = 2048, N = 4096) about 500
// operations a byte.
//
// What this design does about it: 128x128 block tiles of 256 threads, two
// blocks an SM, an 8x8 register tile a thread (64 FMAs for every 16 float4
// shared loads),
// K in stages of 16 through a three-stage cp.async ring (zero-filled past
// the last row or column, so no batch padding is copied).  A thread owns
// rows ty + 16i and, with B in (N, K) rows, columns tx + 16j (both operands
// read as float4 along K, conflict-free with rows padded by four floats),
// or, with B in (K, N) rows, columns 4tx + 64(j/4) + j%4 (B read as float4
// along N).  K1 and K2 must be multiples of 16, N a multiple of 4.
#pragma once

#include <cuda_runtime.h>

#include "bounds_check.cuh"
#include "lstm_cell.cuh"

namespace rst_f32 {

constexpr int kBM = 128, kBN = 128, kBK = 16, kThreads = 256, kStages = 3;
constexpr int kLdA = kBK + 4;    // As[m][k]
constexpr int kLdBk = kBN + 4;   // Bs[k][n]: B in (K, N) rows
constexpr int kLdBn = kBK + 4;   // Bs[n][k]: B in (N, K) rows
constexpr int kStageFloats = kBM * kLdA + kBN * kLdBn;
static_assert(kBK * kLdBk <= kBN * kLdBn, "a (K, N) stage of B fits the (N, K) one");
constexpr size_t kSmemBytes = (size_t)kStages * kStageFloats * sizeof(float);

// 16 bytes global -> shared, or 16 zero bytes where !valid (src unread).
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
}

// 4 bytes global -> shared, or 4 zero bytes where !valid (src unread): for
// rows that are not 16-byte aligned, and gathers.
__device__ __forceinline__ void cp_async4_zfill(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(n));
}

struct Operands {
  const float* a1;   // (rows, K1) row-major, from row row0
  const float* a2;   // (rows, K2) row-major, or null (K2 = 0)
  const float* b1;   // (K1, N) rows, or (N, K1) rows with kBT
  const float* b2;   // (K2, N) rows, or (N, K2) rows with kBT; null when K2 = 0
  int M, N, K1, K2;
  int row0;          // first row of a1, a2
  long long a_rows;  // rows a1 and a2 hold (bounds checks)
  int skip_k;        // K stages left out at the end (a planted fault; 0)
};

// The tile's column of thread tx's j-th column (j < 8), block-local.
template <bool kBT>
__device__ __forceinline__ int tile_col(int tx, int j) {
  return kBT ? tx + 16 * j : 4 * tx + 64 * (j / 4) + j % 4;
}

// acc[i][j] = C[m0 + ty + 16i][n0 + tile_col(tx, j)] for thread (tx =
// tid % 16, ty = tid / 16); smem holds kSmemBytes.
template <bool kBT>
__device__ __forceinline__ void gemm_tile(float* smem, const Operands& op, int m0, int n0,
                                          float (&acc)[8][8]) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int nk = (op.K1 + op.K2) / kBK - op.skip_k;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  auto load = [&](int kc, int stage) {
    float* As = smem + (size_t)stage * kStageFloats;
    float* Bs = As + kBM * kLdA;
    const int k0 = kc * kBK;
    const bool in1 = k0 < op.K1;
    const float* a = in1 ? op.a1 : op.a2;
    const float* b = in1 ? op.b1 : op.b2;
    const int ld = in1 ? op.K1 : op.K2;
    const int ka = in1 ? k0 : k0 - op.K1;
    for (int v = tid; v < kBM * kBK / 4; v += kThreads) {
      const int r = v / (kBK / 4), p = v % (kBK / 4);
      const int row = m0 + r;
      const bool ok = row < op.M;
      const long long arow = (long long)op.row0 + (ok ? row : 0);
      if (ok) RST_CHECK(arow, op.a_rows);
      RST_CHECK(ka + 4 * p + 3, ld);
      cp_async16_zfill(As + r * kLdA + 4 * p, a + arow * ld + ka + 4 * p, ok);
    }
    if (kBT) {
      for (int v = tid; v < kBN * kBK / 4; v += kThreads) {
        const int n = v / (kBK / 4), p = v % (kBK / 4);
        const int col = n0 + n;
        const bool ok = col < op.N;
        if (ok) RST_CHECK(col, op.N);
        RST_CHECK(ka + 4 * p + 3, ld);
        cp_async16_zfill(Bs + n * kLdBn + 4 * p, b + (size_t)(ok ? col : 0) * ld + ka + 4 * p,
                         ok);
      }
    } else {
      for (int v = tid; v < kBK * kBN / 4; v += kThreads) {
        const int kr = v / (kBN / 4), p = v % (kBN / 4);
        const int col = n0 + 4 * p;
        const bool ok = col < op.N;
        if (ok) RST_CHECK(col + 3, op.N);
        RST_CHECK(ka + kr, ld);
        cp_async16_zfill(Bs + kr * kLdBk + 4 * p, b + (size_t)(ka + kr) * op.N + (ok ? col : 0),
                         ok);
      }
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(s, s);
    rst::cp_async_commit();
  }
  for (int kc = 0; kc < nk; ++kc) {
    rst::cp_async_wait<kStages - 2>();   // stage kc has landed
    __syncthreads();                     // and every thread is done with stage kc - 1
    if (kc + kStages - 1 < nk) load(kc + kStages - 1, (kc + kStages - 1) % kStages);
    rst::cp_async_commit();
    const float* As = smem + (size_t)(kc % kStages) * kStageFloats;
    const float* Bs = As + kBM * kLdA;
#pragma unroll
    for (int k = 0; k < kBK; k += 4) {
      float4 a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        a[i] = *reinterpret_cast<const float4*>(As + (ty + 16 * i) * kLdA + k);
      }
      if (kBT) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float4 b = *reinterpret_cast<const float4*>(Bs + (tx + 16 * j) * kLdBn + k);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            float s = acc[i][j];
            s = fmaf(a[i].x, b.x, s);
            s = fmaf(a[i].y, b.y, s);
            s = fmaf(a[i].z, b.z, s);
            acc[i][j] = fmaf(a[i].w, b.w, s);
          }
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float* brow = Bs + (k + kk) * kLdBk + 4 * tx;
          const float4 b0 = *reinterpret_cast<const float4*>(brow);
          const float4 b1 = *reinterpret_cast<const float4*>(brow + 64);
          const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float av = kk == 0 ? a[i].x : kk == 1 ? a[i].y : kk == 2 ? a[i].z : a[i].w;
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av, bv[j], acc[i][j]);
          }
        }
      }
    }
  }
  rst::cp_async_wait<0>();
}

// Block (x: 128-column tile of N, y: 128-row tile of M): the tile, then
// epi(row, col, value) for every output inside (M, N).
template <bool kBT, class Epi>
__global__ void __launch_bounds__(kThreads, 2) gemm_kernel(Operands op, Epi epi) {
  extern __shared__ __align__(16) float smem_f32[];
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  float acc[8][8];
  gemm_tile<kBT>(smem_f32, op, m0, n0, acc);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= op.M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + tile_col<kBT>(tx, j);
      if (col < op.N) epi(row, col, acc[i][j]);
    }
  }
}

// One launch of the tile over (M, N) on `st`.  Returns the CUDA error code.
template <bool kBT, class Epi>
int launch(const Operands& op, Epi epi, cudaStream_t st) {
  if (op.M <= 0) return 0;
  if (op.K1 % kBK || op.K2 % kBK || op.N % 4 || op.K1 <= 0 || op.K2 < 0 ||
      op.skip_k < 0 || op.skip_k >= (op.K1 + op.K2) / kBK) {
    return (int)cudaErrorInvalidValue;
  }
  auto fn = gemm_kernel<kBT, Epi>;
  const cudaError_t attr =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((op.N + kBN - 1) / kBN, (op.M + kBM - 1) / kBM);
  fn<<<grid, kThreads, kSmemBytes, st>>>(op, epi);
  return (int)cudaGetLastError();
}

}  // namespace rst_f32
