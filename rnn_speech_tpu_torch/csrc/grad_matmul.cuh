// The tall-K weight-gradient product shared by csrc/grad_matmul.cu (the
// weight-gradient kernels) and csrc/lstm_wavefront_bwd.cu (the reverse
// diagonal's in-pass dW_x accumulation):
//
//   dW = Aᵀ·dg   (D, G) f32,  A (N, D) bf16 row-major, dg (N, G) bf16 or f32
//   db = Σ_N dg  (G,)   f32, summed from the UNROUNDED dg (when asked for)
//
// 128x128 output tiles, eight warps of bf16 WMMA 16x16x16 with f32
// accumulators (a 32x64 patch each), K walked in 32-row steps, the next
// step's operands loaded into registers while the tensor cores work on the
// current one from shared memory.  A is read as the transposed
// (column-major) operand straight from its row-major rows.  When there are
// too few output tiles to fill the card, K is split across blocks into f32
// partials that a second pass sums in a fixed order, so a run repeats bit
// for bit (no atomics).  dg arrives in the caller's dtype: f32 rows are
// rounded to bf16 on their way to shared memory, and the blocks of the
// first row tile also sum the unrounded values into db.  Ragged D, G and N
// edges load zeros and store nothing.  With `accumulate` the tile adds its
// sum to dW instead of storing it: each output element has one owner block,
// so successive launches on one stream add in launch order, deterministically.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace rst_grad {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128;                // output rows (A columns) per block
constexpr int kBN = 128;                // output columns (dg columns) per block
constexpr int kBK = 32;                 // K rows per step
constexpr int kThreads = 256;           // eight warps: 4 (rows) x 2 (columns)
constexpr int kLdA = kBM + 8;           // As[k][m], padded
constexpr int kLdB = kBN + 8;           // Bs[k][n], padded
constexpr int kStage = kBK * (kLdA + kLdB);  // bf16 elements of one stage

__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }

// A K step of one operand in registers: kRowsK rows of kCols columns in
// 16-byte vectors.  Each thread always holds the same VEC columns, so it
// can keep running column sums (db) of what it loads.
template <typename T, int kCols>
struct Tile {
  static constexpr int VEC = 16 / sizeof(T);
  static constexpr int CPR = kCols / VEC;              // vectors per row
  static constexpr int CPT = kBK * CPR / kThreads;     // vectors per thread
  uint4 r[CPT];

  // Rows [n0, n0 + kBK) (those < n_end) and columns [c0, c0 + kCols)
  // (those < ncols) of the row-major (rows, ncols) array p; zeros elsewhere.
  __device__ __forceinline__ void load(const T* p, int ncols, bool vec_ok, int n0,
                                       int n_end, int c0) {
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int v = threadIdx.x + i * kThreads;
      const int n = n0 + v / CPR;
      const int col = c0 + (v % CPR) * VEC;
      if (n < n_end && vec_ok && col + VEC <= ncols) {
        r[i] = __ldg(reinterpret_cast<const uint4*>(p + (size_t)n * ncols + col));
      } else {
        alignas(16) T tmp[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          tmp[e] = (n < n_end && col + e < ncols) ? p[(size_t)n * ncols + col + e]
                                                  : T(0.0f);
        }
        r[i] = *reinterpret_cast<const uint4*>(tmp);
      }
    }
  }

  __device__ __forceinline__ void add_column_sums(float* acc) const {
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const T* e = reinterpret_cast<const T*>(&r[i]);
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[k] += to_f32(e[k]);
    }
  }

  // To shared memory as bf16, [k][col] with leading dimension ld.
  __device__ __forceinline__ void store(bf16* s, int ld) const {
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int v = threadIdx.x + i * kThreads;
      bf16* dst = s + (v / CPR) * ld + (v % CPR) * VEC;
      if constexpr (sizeof(T) == 2) {
        *reinterpret_cast<uint4*>(dst) = r[i];
      } else {
        const float* f = reinterpret_cast<const float*>(&r[i]);
        __nv_bfloat162 lo = __floats2bfloat162_rn(f[0], f[1]);
        __nv_bfloat162 hi = __floats2bfloat162_rn(f[2], f[3]);
        uint2 packed;
        packed.x = *reinterpret_cast<uint32_t*>(&lo);
        packed.y = *reinterpret_cast<uint32_t*>(&hi);
        *reinterpret_cast<uint2*>(dst) = packed;
      }
    }
  }
};

struct Args {
  const bf16* a0;    // (N, d0) first A operand
  const bf16* a1;    // (N, d1) second A operand, or null (d1 = 0)
  const void* dg;    // (N, G) bf16 or f32
  int d0, d1, N, G;
  int mt0;           // row tiles of a0; grid.x = mt0 + row tiles of a1
  int rows_per_split;
  int accumulate;    // add into out instead of storing (one split only)
  float* out;        // (d0 + d1, G) f32 dW, or (splits, d0 + d1, G) partials
  float* out_db;     // (G,) f32 db, or (splits, G) partials; null: no db
};

template <typename TG>
__global__ void __launch_bounds__(kThreads) grad_kernel(Args p) {
  using namespace nvcuda;
  __shared__ __align__(128) bf16 smem[2 * kStage];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp % 4, wn = warp / 4;   // 32-row x 64-column warp patch
  const bool second = blockIdx.x >= p.mt0;
  const bf16* a = second ? p.a1 : p.a0;
  const int D = second ? p.d1 : p.d0;
  const int m0 = (second ? blockIdx.x - p.mt0 : blockIdx.x) * kBM;
  const int row_off = second ? p.d0 : 0;   // first output row of this operand
  const int g0 = blockIdx.y * kBN;
  const int split = blockIdx.z;
  const int n_begin = split * p.rows_per_split;
  const int n_end = min(p.N, n_begin + p.rows_per_split);
  const int n_steps = n_end > n_begin ? (n_end - n_begin + kBK - 1) / kBK : 0;
  const bool do_db = blockIdx.x == 0 && p.out_db != nullptr;  // one row tile sums db
  const TG* dg = static_cast<const TG*>(p.dg);
  const bool a_vec = D % 8 == 0;
  const bool g_vec = p.G % (16 / (int)sizeof(TG)) == 0;

  Tile<bf16, kBM> ta;
  Tile<TG, kBN> tb;
  float db_acc[Tile<TG, kBN>::VEC];
#pragma unroll
  for (int k = 0; k < Tile<TG, kBN>::VEC; ++k) db_acc[k] = 0.0f;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  if (n_steps > 0) {
    ta.load(a, D, a_vec, n_begin, n_end, m0);
    tb.load(dg, p.G, g_vec, n_begin, n_end, g0);
    if (do_db) tb.add_column_sums(db_acc);
    ta.store(smem, kLdA);
    tb.store(smem + kBK * kLdA, kLdB);
  }
  __syncthreads();

  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa[2];
  wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
  for (int ks = 0; ks < n_steps; ++ks) {
    const bool more = ks + 1 < n_steps;
    if (more) {  // next step's operands into registers, in flight meanwhile
      const int n0 = n_begin + (ks + 1) * kBK;
      ta.load(a, D, a_vec, n0, n_end, m0);
      tb.load(dg, p.G, g_vec, n0, n_end, g0);
      if (do_db) tb.add_column_sums(db_acc);
    }
    const bf16* As = smem + (ks & 1) * kStage;
    const bf16* Bs = As + kBK * kLdA;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], As + kk * kLdA + wm * 32 + i * 16, kLdA);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::load_matrix_sync(fb, Bs + kk * kLdB + wn * 64 + j * 16, kLdB);
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
      }
    }
    if (more) {
      bf16* nxt = smem + ((ks + 1) & 1) * kStage;
      ta.store(nxt, kLdA);
      tb.store(nxt + kBK * kLdA, kLdB);
    }
    __syncthreads();
  }

  // Epilogue through a 16x16 f32 staging patch per warp, with bounds.
  float* stage = reinterpret_cast<float*>(smem) + warp * 256;
  const int Mtot = p.d0 + p.d1;
  float* out = p.out + (size_t)split * Mtot * p.G;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(stage, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int m = m0 + wm * 32 + i * 16 + e / 16;
        const int g = g0 + wn * 64 + j * 16 + e % 16;
        if (m < D && g < p.G) {
          float* o = out + (size_t)(row_off + m) * p.G + g;
          *o = p.accumulate ? *o + stage[e] : stage[e];
        }
      }
      __syncwarp();
    }
  }

  if (do_db) {  // uniform over the block
    constexpr int VEC = Tile<TG, kBN>::VEC, CPR = Tile<TG, kBN>::CPR;
    float* red = reinterpret_cast<float*>(smem) + 8 * 256;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < VEC; ++k) red[threadIdx.x * VEC + k] = db_acc[k];
    __syncthreads();
    if (threadIdx.x < kBN) {
      const int col = threadIdx.x, q = col / VEC, k = col % VEC;
      float s = 0.0f;
      for (int t = q; t < kThreads; t += CPR) s += red[t * VEC + k];  // fixed order
      if (g0 + col < p.G) p.out_db[(size_t)split * p.G + g0 + col] = s;
    }
  }
}

// out[i] = Σ_s part[s][i] in the order s = 0, 1, ...
__global__ void sum_splits(const float* part, int splits, size_t count, float* out) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < count;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.0f;
    for (int k = 0; k < splits; ++k) s += part[(size_t)k * count + i];
    out[i] = s;
  }
}

// Launches the product (and, with splits > 1, the fixed-order sum of the
// partials) on `stream`; db may be null.  With accumulate the product adds
// into dw and splits must be 1.  Returns the CUDA error code.
inline int launch(const void* a0, int d0, const void* a1, int d1, const void* dg,
                  int dg_f32, int N, int G, int splits, int rows_per_split, float* partial,
                  float* partial_db, float* dw, float* db, int accumulate, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (accumulate && splits != 1) return (int)cudaErrorInvalidValue;
  Args p;
  p.a0 = static_cast<const bf16*>(a0);
  p.a1 = static_cast<const bf16*>(a1);
  p.dg = dg;
  p.d0 = d0;
  p.d1 = d1;
  p.N = N;
  p.G = G;
  p.mt0 = (d0 + kBM - 1) / kBM;
  p.rows_per_split = rows_per_split;
  p.accumulate = accumulate;
  p.out = splits > 1 ? partial : dw;
  p.out_db = splits > 1 ? partial_db : db;
  const dim3 grid(p.mt0 + (d1 + kBM - 1) / kBM, (G + kBN - 1) / kBN, splits);
  if (dg_f32) {
    grad_kernel<float><<<grid, kThreads, 0, st>>>(p);
  } else {
    grad_kernel<bf16><<<grid, kThreads, 0, st>>>(p);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const size_t count = (size_t)(d0 + d1) * G;
  sum_splits<<<(unsigned)((count + 255) / 256 < 4096 ? (count + 255) / 256 : 4096), 256, 0,
               st>>>(partial, splits, count, dw);
  if (db != nullptr) {
    sum_splits<<<(unsigned)((G + 255) / 256), 256, 0, st>>>(partial_db, splits, (size_t)G,
                                                            db);
  }
  return (int)cudaGetLastError();
}

}  // namespace rst_grad
