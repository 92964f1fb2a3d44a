// The tall-K weight-gradient product shared by csrc/grad_matmul.cu (the
// weight-gradient kernels) and csrc/lstm_wavefront_bwd.cu (the reverse
// diagonal's in-pass dW_x accumulation):
//
//   dW = Aᵀ·dg   (D, G) f32,  A (N, D) bf16 row-major, dg (N, G) bf16 or f32
//   db = Σ_N dg  (G,)   f32, summed from the UNROUNDED dg (when asked for)
//
// What bounds it on the H100: at the LSTM shapes (N = T·B rows, D = 1024 or
// the stacked 2048, G = 4096) the product does 2·N·D·G operations against
// N·(D + G) bf16 bytes, about 1000 operations a byte: the tensor-core rate.
// A and dg are both MN-major: the reduction axis N is the slow axis of each.
//
// Two tile products, one chosen by shape in one place (the wrapper's plan,
// ops/grad_matmul.py), never one after a failed launch of the other:
//
// `tma::tile_kernel`, for bf16 dg, D a multiple of 64 and G a multiple of
// 256 (every LSTM product): 128x256 output tiles, one producer warp that
// keeps TMA loads (cp.async.bulk.tensor) of 64-row K stages in flight
// through a ring of four 48 KiB shared-memory stages with full and empty
// mbarriers, and two consumer warpgroups that each run wgmma.mma_async
// m64n256k16 (bf16 x bf16 -> f32, both operands from shared memory, both
// transposed: 64-element strips in 128-byte swizzle) into a 64x256 f32
// accumulator held in registers (setmaxnreg moves registers from the
// producer warpgroup to the consumers).  The K tail past N is zero-filled
// by TMA.  db is a separate fixed-order pass (`column_sums`): summed in
// the tile, by spare warps of the producer warpgroup from the staged dg or
// by extra m64n8 wgmmas against a block of ones, it cost the product more
// than the pass does.
//
// `grad_kernel`, for every other shape (the projections: D = 120 or
// G = 80, f32 dg; ragged test shapes), which are bound by their bytes:
// 128x128 output tiles, eight warps of bf16 WMMA 16x16x16 with f32
// accumulators, K walked in 32-row steps staged through registers.  f32
// dg rows are rounded to bf16 on their way to shared memory and the
// blocks of the first row tile sum the unrounded values into db.  Ragged
// D, G and N edges load zeros and store nothing.
//
// Both: when there are too few output tiles to fill the card, K is split
// across blocks into f32 partials that a second pass sums in a fixed order,
// so a run repeats bit for bit (no atomics).  With `accumulate` the tile
// adds its sum to dW instead of storing it: each output element has one
// owner block, so successive launches on one stream add in launch order,
// deterministically.
#pragma once

#include <cuda.h>
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

// --------------------------------------------------------- the Hopper tile

namespace tma {

constexpr int kTM = 128;                     // output rows per block: 2 x 64
constexpr int kTN = 256;                     // output columns per block
constexpr int kTK = 64;                      // K rows per stage
constexpr int kStages = 4;
// K stages a warpgroup sums in registers before it adds them to its dW
// tile: the tensor cores' f32 sums lose precision in proportion to the
// length of one accumulation chain, so no chain exceeds kFlushSteps·kTK
// rows, at any N.
constexpr int kFlushSteps = 256;
constexpr int kStrip = 64 * kTK * 2;         // bytes of a 64-column strip of kTK rows
constexpr int kStageBytes = (kTM + kTN) / 64 * kStrip;   // 2 A + 4 dg strips: 48 KiB
constexpr int kThreads = 384;                // producer warpgroup, two consumers
constexpr int kSmemBytes = kStages * kStageBytes + 2 * kStages * 8 + 1024;  // + barriers, align

struct Args {
  int d0, d1, G;
  int mt0;              // row tiles of the first operand; grid.x = mt0 + those of the second
  int steps;            // K stages in all: ceil(N / kTK)
  int steps_per_split;  // K stages of one split (grid.z)
  int accumulate;
  float* out;           // (d0 + d1, G) dW, or (splits, d0 + d1, G) partials
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void bar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Until the barrier's phase of the given parity has completed.  A wait
// that never ends (a miscounted barrier) traps instead of hanging the card.
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t spins = 0; !done; ++spins) {
    if (spins == (1u << 28)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// Until the global `count` reaches `target` (acquire): the persistent
// recurrences' grid barriers.  Traps after ~2^24 polls (a grid that is not
// co-resident, or a barrier that never fills) instead of hanging.
__device__ __forceinline__ void grid_wait(const unsigned* count, unsigned target) {
  for (uint32_t spins = 0;; ++spins) {
    unsigned v;
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(count) : "memory");
    if (v >= target) break;
    if (spins == (1u << 24)) __trap();
    __nanosleep(32);
  }
}

// A 64-column x kTK-row box at (col, row) of a 2-D tensor map into shared
// memory at dst, completing on the barrier's transaction count.
__device__ __forceinline__ void load_box(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row)
      : "memory");
}

// wgmma descriptor of an MN-major operand in 128-byte swizzle, as TMA
// writes it: 64-element strips along M (or N) `strip` bytes apart (the
// leading byte offset), K in groups of 8 rows of 128 bytes, 1024 bytes
// apart (the stride byte offset).  Stage bases are 1024-byte aligned, so
// the base offset is 0.
__device__ __forceinline__ uint64_t mn_desc(uint32_t addr, uint32_t strip) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(strip >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// Keeps the compiler from moving accumulator registers across the
// asynchronous wgmma region.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define RST_ACC8(i)                                                              \
  "+f"(d[(i)]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3]), "+f"(d[(i) + 4]), \
      "+f"(d[(i) + 5]), "+f"(d[(i) + 6]), "+f"(d[(i) + 7])

// d (64x256 f32, this warpgroup's) = a·b + (keep ? d : 0) over 16 K rows:
// b (16, 256) MN-major (transpose bit set); a (64, 16) MN-major (kTransA = 1,
// the weight-gradient tile's Aᵀ) or K-major (kTransA = 0, the recompute
// backward's gate rebuild, rebuild_gates.cuh).
template <int kTransA = 1>
__device__ __forceinline__ void mma_64x256x16(float (&d)[128], uint64_t a, uint64_t b,
                                              uint32_t keep) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "
      "%124, %125, %126, %127}, %128, %129, p, 1, 1, %131, 1;\n"
      "}\n"
      : RST_ACC8(0), RST_ACC8(8), RST_ACC8(16), RST_ACC8(24), RST_ACC8(32), RST_ACC8(40),
        RST_ACC8(48), RST_ACC8(56), RST_ACC8(64), RST_ACC8(72), RST_ACC8(80), RST_ACC8(88),
        RST_ACC8(96), RST_ACC8(104), RST_ACC8(112), RST_ACC8(120)
      : "l"(a), "l"(b), "r"(keep), "n"(kTransA));
}

// d (64x64 f32) = a·b + (keep ? d : 0) over 16 K: a (64 x 16) and b
// (16 x 64) both K-major (the persistent recurrences, csrc/lstm_layer_lean.cu
// and csrc/lstm_layer_bwd_persistent.cu).  Register 4j + r holds row
// 16·warp + lane/4 + 8·(r/2), column 8j + 2·(lane%4) + r%2.
__device__ __forceinline__ void mma_64x64x16(float (&d)[32], uint64_t a, uint64_t b,
                                             uint32_t keep) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : RST_ACC8(0), RST_ACC8(8), RST_ACC8(16), RST_ACC8(24)
      : "l"(a), "l"(b), "r"(keep));
}

// d (64x96 f32) = a·b + (keep ? d : 0) over 16 K: a (64 x 16) and b
// (16 x 96) both K-major (the persistent wavefront kernels,
// csrc/lstm_wavefront_persistent.cu, lstm_wavefront_eval.cu and
// lstm_wavefront_bwd_persistent.cu).  Register 4j + r holds row 16·warp +
// lane/4 + 8·(r/2), column 8j + 2·(lane%4) + r%2.
__device__ __forceinline__ void mma_64x96x16(float (&d)[48], uint64_t a, uint64_t b,
                                             uint32_t keep) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "%48, %49, p, 1, 1, 0, 0;\n"
      "}\n"
      : RST_ACC8(0), RST_ACC8(8), RST_ACC8(16), RST_ACC8(24), RST_ACC8(32), RST_ACC8(40)
      : "l"(a), "l"(b), "r"(keep));
}

#undef RST_ACC8

// A ring of `n` shared-memory stages of `bytes` each with full and empty
// mbarriers, walked in the same order by the producer (put) and the
// consumers (get, then release); the first round's empty waits pass (the
// persistent wavefront kernels).
template <int n, int bytes>
struct Ring {
  uint32_t base, full, empty;   // shared addresses: stage 0, its full and empty barriers
  int it;
  __device__ __forceinline__ uint32_t put() {   // producer: the next stage, its barrier armed
    const int s = it % n;
    bar_wait(empty + 8 * s, ((it / n) & 1) ^ 1);
    bar_expect_tx(full + 8 * s, bytes);
    ++it;
    return s;
  }
  __device__ __forceinline__ uint32_t get() {   // consumers: the next stage once landed
    const int s = it % n;
    bar_wait(full + 8 * s, (it / n) & 1);
    return base + s * bytes;
  }
  __device__ __forceinline__ void release(int lane) {
    if (lane == 0) bar_arrive(empty + 8 * (it % n));
    ++it;
  }
};

// Stores (or, with `add`, adds) a warpgroup's 64x256 accumulator into the
// row-major f32 tile at `out` (row 0, column 0 of this thread's first
// element; rows G apart).  Register 4j + r holds row 16·warp + lane/4 +
// 8·(r/2), column 8j + 2·(lane%4) + r%2 of the warpgroup's tile.
// The adds read four column groups before they write any, so the reads
// overlap instead of each waiting behind the previous write.
__device__ __forceinline__ void put_tile(const float (&d)[128], float* out, int G, bool add) {
  constexpr int kBatch = 4;
#pragma unroll
  for (int j0 = 0; j0 < kTN / 8; j0 += kBatch) {
    float2 old[kBatch][2];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        old[j][hh] = add ? *reinterpret_cast<const float2*>(out + (size_t)(8 * hh) * G +
                                                             8 * (j0 + j))
                         : make_float2(0.0f, 0.0f);
      }
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int e = 4 * (j0 + j) + 2 * hh;
        *reinterpret_cast<float2*>(out + (size_t)(8 * hh) * G + 8 * (j0 + j)) =
            make_float2(old[j][hh].x + d[e], old[j][hh].y + d[e + 1]);
      }
    }
  }
}

// wgmma descriptor of a K-major operand in 128-byte swizzle, as TMA writes
// a 64-column box: rows of 128 bytes, groups of 8 rows 1024 bytes apart
// (the stride byte offset; the leading byte offset is unused for swizzled
// K-major layouts and set to 1).  16 K columns further is 32 bytes further
// inside the swizzle atom.
__device__ __forceinline__ uint64_t k_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

// The main loop of a block's 128x256 output tile over K stages [k0, k1),
// which tile_kernel and the recompute backward's gate rebuild
// (rebuild_gates.cuh) share.  Warpgroup 0: one thread issues the loads of
// each stage into a ring of kStages buffers with full and empty mbarriers:
// `load(st, bar, k)` puts n_a A strips and then kTN / 64 B strips of stage
// k at st, each kStrip bytes, completing on bar.  Warpgroups 1, 2: the two
// 64-row halves of the tile (those below n_a), each running wgmma
// m64n256k16 into a 64x256 f32 accumulator; A is MN-major (kTransA = 1) or
// K-major (kTransA = 0), B MN-major.  `epi(d, c, chain)` takes half c's
// accumulator after each chain of at most kFlushSteps stages (chain 0
// first); an empty K range gives one call with zeros.  kOneChain: the
// caller guarantees k1 - k0 <= kFlushSteps and the chain loop goes; inside
// it the compiler builds the K-major descriptors in vector registers and
// moves them to uniform ones at every product, which slows the rebuild.
template <int kTransA, bool kOneChain, class Load, class Epi>
__device__ __forceinline__ void tile_loop(int n_a, int k0, int k1, const Load& load,
                                          const Epi& epi) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  const int wg = threadIdx.x / 128, warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      bar_init(smem_addr(&full[s]), 1);
      bar_init(smem_addr(&empty[s]), 4 * n_a);   // released by each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == 0 && lane == 0) {
      for (int k = k0; k < k1; ++k) {
        const int i = k - k0, s = i % kStages;
        bar_wait(smem_addr(&empty[s]), ((i / kStages) & 1) ^ 1);   // first round passes
        const uint32_t bar = smem_addr(&full[s]);
        bar_expect_tx(bar, (n_a + kTN / 64) * kStrip);
        load(smem_addr(smem + s * kStageBytes), bar, k);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int c = wg - 1;   // this warpgroup's 64-row half
    if (c < n_a) {
      float d[128];
#pragma unroll
      for (int i = 0; i < 128; ++i) d[i] = 0.0f;
      // Chains of at most kFlushSteps stages (at least one, so an empty
      // range gives its zeros through the same epilogue); a chain's first
      // product overwrites d (keep = 0), so no other instruction writes
      // the accumulators inside the loop, and the epilogue stays out of it.
      const int chains = kOneChain ? 1 : max(1, (k1 - k0 + kFlushSteps - 1) / kFlushSteps);
      for (int chain = 0; chain < chains; ++chain) {
        const int c0 = k0 + chain * kFlushSteps;
        const int c1 = kOneChain ? k1 : min(k1, c0 + kFlushSteps);
        for (int k = c0; k < c1; ++k) {
          const int i = k - k0, s = i % kStages;
          bar_wait(smem_addr(&full[s]), (i / kStages) & 1);
          const uint32_t st = smem_addr(smem + s * kStageBytes);
          fence_acc(d);
          asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
          for (int kk = 0; kk < kTK / 16; ++kk) {
            // 16 K rows: two 1024-byte row groups of an MN-major strip, or
            // 32 bytes of each row of a K-major one.
            const uint32_t a = st + c * kStrip;
            mma_64x256x16<kTransA>(
                d, kTransA ? mn_desc(a + kk * 2048, kStrip) : k_desc(a + kk * 32),
                mn_desc(st + (kTM / 64) * kStrip + kk * 2048, kStrip), (k > c0) | kk);
          }
          asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
          fence_acc(d);
          // The previous stage's products are done: release its buffers.
          asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
          if (i > 0 && lane == 0) bar_arrive(smem_addr(&empty[(i - 1) % kStages]));
        }
        asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
        fence_acc(d);
        epi(d, c, chain);
      }
    }
  }
}

// Block (x: row tile of either operand, y: column tile, z: K split): the
// dW tile aᵀ·dg, a and dg both MN-major.
__global__ void __launch_bounds__(kThreads, 1)
    tile_kernel(const __grid_constant__ CUtensorMap map_a0,
                const __grid_constant__ CUtensorMap map_a1,
                const __grid_constant__ CUtensorMap map_dg, Args p) {
  const bool second = blockIdx.x >= p.mt0;
  const CUtensorMap* map_a = second ? &map_a1 : &map_a0;
  const CUtensorMap* dg = &map_dg;
  const int D = second ? p.d1 : p.d0;
  const int m0 = (second ? blockIdx.x - p.mt0 : blockIdx.x) * kTM;
  const int n_a = min(kTM / 64, (D - m0) / 64);   // 64-row halves this tile has
  const int g0 = blockIdx.y * kTN;
  const int k0 = blockIdx.z * p.steps_per_split;
  const int k1 = min(p.steps, k0 + p.steps_per_split);
  const int row0 = (second ? p.d0 : 0) + m0;
  tile_loop<1, false>(
      n_a, k0, k1,
      [=](uint32_t st, uint32_t bar, int k) {
        for (int c = 0; c < n_a; ++c) load_box(st + c * kStrip, map_a, bar, m0 + 64 * c, k * kTK);
        for (int q = 0; q < kTN / 64; ++q) {
          load_box(st + (kTM / 64 + q) * kStrip, dg, bar, g0 + 64 * q, k * kTK);
        }
      },
      [=](const float(&d)[128], int c, int chain) {
        const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
        const int row = row0 + 64 * c + 16 * warp + lane / 4;
        float* out = p.out + ((size_t)blockIdx.z * (p.d0 + p.d1) + row) * p.G + g0 +
                     2 * (lane % 4);
        // A store first, unless accumulating into dW.
        put_tile(d, out, p.G, p.accumulate || chain > 0);
      });
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled (a libcuda entry point) looked up through the
// runtime, so the libraries link no libcuda.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(ptr)
               : nullptr;
  }();
  return fn;
}

// Tensor map of a row-major (rows, cols) bf16 array in boxes of 64 columns
// by kTK rows, 128-byte swizzle; reads past `rows` fill zeros.
inline bool make_map(CUtensorMap* map, const void* base, int rows, int cols) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, kTK};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Whether the Hopper tile takes these operands (the wrapper's plan decides
// the same by shape; this guards the C entry points).
inline bool takes(const void* a0, int d0, const void* a1, int d1, const void* dg, int dg_f32,
                  int G) {
  auto aligned = [](const void* q) { return reinterpret_cast<uintptr_t>(q) % 16 == 0; };
  return !dg_f32 && d0 > 0 && d0 % 64 == 0 && d1 % 64 == 0 && G % kTN == 0 && aligned(a0) &&
         aligned(dg) && (d1 == 0 || aligned(a1));
}

inline int launch(const void* a0, int d0, const void* a1, int d1, const void* dg, int N, int G,
                  int splits, int rows_per_split, float* out, int accumulate, cudaStream_t st) {
  CUtensorMap m0, m1, mg;
  if (!make_map(&m0, a0, N, d0) || !make_map(&mg, dg, N, G) ||
      (d1 > 0 && !make_map(&m1, a1, N, d1))) {
    return (int)cudaErrorInvalidValue;
  }
  Args p;
  p.d0 = d0;
  p.d1 = d1;
  p.G = G;
  p.mt0 = (d0 + kTM - 1) / kTM;
  p.steps = (N + kTK - 1) / kTK;
  p.steps_per_split = splits > 1 ? rows_per_split / kTK : p.steps;
  p.accumulate = accumulate;
  p.out = out;
  cudaError_t err =
      cudaFuncSetAttribute(tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(p.mt0 + (d1 + kTM - 1) / kTM, G / kTN, splits);
  tile_kernel<<<grid, kThreads, kSmemBytes, st>>>(m0, d1 > 0 ? m1 : m0, mg, p);
  return (int)cudaGetLastError();
}

}  // namespace tma

constexpr int kColRows = 4096;   // dg rows per block of column_sums

// part[r][g] = Σ dg[n][g] over rows n of block row r (kColRows each) of a
// bf16 (N, G) dg, G a multiple of 256: 256 columns a block, eight warps on
// interleaved rows, each lane 8 columns of 16-byte loads, the warps' sums
// added in warp order.
__global__ void __launch_bounds__(256) column_sums(const bf16* dg, int N, int G, float* part) {
  __shared__ float red[8][256];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int col = blockIdx.x * 256 + 8 * lane;
  const int r1 = min(N, (blockIdx.y + 1) * kColRows);
  float acc[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
  for (int r = blockIdx.y * kColRows + warp; r < r1; r += 8) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(dg + (size_t)r * G + col));
    const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      acc[2 * k] += __low2float(e[k]);
      acc[2 * k + 1] += __high2float(e[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) red[warp][8 * lane + k] = acc[k];
  __syncthreads();
  float sum = 0.0f;
#pragma unroll
  for (int w = 0; w < 8; ++w) sum += red[w][threadIdx.x];
  part[(size_t)blockIdx.y * G + blockIdx.x * 256 + threadIdx.x] = sum;
}

// The two tile products: the WMMA tile for any shape, the Hopper tile for
// the shapes tma::takes.
enum Path { kWmma = 0, kWgmma = 1 };

// Launches the product on `path` (and, with splits > 1, the fixed-order sum
// of the partials) on `stream`; db may be null.  With accumulate the
// product adds into dw and splits must be 1.  K splits are rows_per_split
// rows each, a multiple of the path's K step.  partial_db holds the db
// partials: (splits, G) on the WMMA tile when K is split; on the Hopper
// tile the column sums' (ceil(N / kColRows), G), whatever the split.
// Returns the CUDA error code.
inline int launch(int path, const void* a0, int d0, const void* a1, int d1, const void* dg,
                  int dg_f32, int N, int G, int splits, int rows_per_split, float* partial,
                  float* partial_db, float* dw, float* db, int accumulate, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (accumulate && splits != 1) return (int)cudaErrorInvalidValue;
  float* out = splits > 1 ? partial : dw;
  if (path == kWgmma) {
    if (!tma::takes(a0, d0, a1, d1, dg, dg_f32, G) ||
        (splits > 1 && rows_per_split % tma::kTK != 0)) {
      return (int)cudaErrorInvalidValue;
    }
    const int err =
        tma::launch(a0, d0, a1, d1, dg, N, G, splits, rows_per_split, out, accumulate, st);
    if (err != 0) return err;
    if (db != nullptr) {
      const int rows = (N + kColRows - 1) / kColRows;
      column_sums<<<dim3(G / 256, rows), 256, 0, st>>>(static_cast<const bf16*>(dg), N, G,
                                                       partial_db);
      sum_splits<<<(unsigned)((G + 255) / 256), 256, 0, st>>>(partial_db, rows, (size_t)G,
                                                              db);
      db = nullptr;   // summed
    }
  } else {
    if (path != kWmma || (splits > 1 && rows_per_split % kBK != 0)) {
      return (int)cudaErrorInvalidValue;
    }
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
    p.out = out;
    p.out_db = splits > 1 ? partial_db : db;
    const dim3 grid(p.mt0 + (d1 + kBM - 1) / kBM, (G + kBN - 1) / kBN, splits);
    if (dg_f32) {
      grad_kernel<float><<<grid, kThreads, 0, st>>>(p);
    } else {
      grad_kernel<bf16><<<grid, kThreads, 0, st>>>(p);
    }
  }
  const cudaError_t err = cudaGetLastError();
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
