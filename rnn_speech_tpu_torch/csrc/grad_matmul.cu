// Tall-K weight-gradient reductions of the training backward, for Hopper
// (sm_90a):
//
//   dW = Aᵀ·dg   (D, G) f32,  A (N, D) bf16 row-major, dg (N, G) bf16 or f32
//   db = Σ_N dg  (G,)   f32, summed from the UNROUNDED dg
//
// Replaces the TPU kernels `_grad_kernel` (entry `dgates_weight_grads`:
// dW_h = h_prevᵀ·dgates, dW_x = xᵀ·dgates, db, one pass over the three
// streams) and `_single_grad_kernel` (entry `weight_grad`: one A operand)
// of rnn_speech_tpu/ops/grad_matmul_pallas.py.  Both entry points below
// run the same product; the two-operand form stacks the output rows of
// both A operands (dW_h over dW_x) so dgates is read once per output tile
// column, as on the TPU.
//
// What bounds it on the H100: at the LSTM shape (N = T·B = 224,640 rows,
// D = H = 1024, G = 4H = 4096) the two products are 3.8 TFLOP against
// 2.8 GB of operands, so the tensor-core rate bounds it (3.8 ms at
// 989 TFLOP/s).  The projections' calls (D = 120, G = 1024; D = 1024,
// G = 80) are bound by their bytes instead: a few output tiles and a very
// long K.
//
// What this design does about it: the caller's plan (ops/grad_matmul.py)
// picks the path by shape.  The LSTM shapes (bf16 dg, D a multiple of 64,
// G of 256) run the Hopper tile of grad_matmul.cuh: TMA loads through a
// four-stage mbarrier ring feeding wgmma m64n256k16 in two consumer
// warpgroups, 128x256 output tiles, then db in a fixed-order column-sum
// pass over dg.  The projections run the skinny tile below (`skinny`), and
// every shape neither takes the WMMA tile.  Each splits K across blocks
// into f32 partials summed in a fixed order when there are too few output
// tiles to fill the card.
//
// The skinny tile (entry rst_weight_grad_skinny), for one A operand where
// one side of dW is narrow (min(D, G) <= 256; D and G multiples of 8): the
// projections, D = 120 x G = 1024 with f32 x and dg, and D = 1024 bf16 x
// G = 80 f32 dg, 1.56 GB at N = 224,640, about 92 GFLOP: a streaming
// problem.  Of x and dg, the wider is the "wide" operand, the other the
// "narrow" one.  Each block owns 128 columns of the wide operand and the
// narrow side whole (an output tile of 128 x n), over one K slice, so the
// wide operand is read from device memory exactly once across the grid and
// the narrow one is re-read by the blocks of a slice through L2.  Thread 0
// keeps a ring of 64-row stages (32 past a narrow side of 128) in flight
// by TMA: a bf16 operand lands in 64-column strips in the 128-byte swizzle
// wgmma reads; an f32 operand lands as one dense box of its rows, which
// all 256 threads then copy into such strips, rounding to nearest even as
// the plain version's `_product` does.  db is summed from the unrounded dg
// in shared memory in the same pass, each thread its columns over its rows
// in row order.  Then each of the two warpgroups runs wgmma m64nNk16 (N =
// 64, 128 or 256 covers the narrow side; both operands MN-major) on its 64
// wide columns, into f32 accumulators held across the slice.  A K slice
// has at most 16,384 rows (one accumulation chain) and the plan takes
// enough slices to fill the card; the slices' partials are summed in a
// fixed order, so dW and db repeat bit for bit.  (A first design built
// mma.sync fragments straight from f32 in shared memory, each element
// converted by every warp that used it: at the projections that cost more
// than the loads.  Copying bf16 operands into the strips as well slowed
// the output projection.)
//
// Float32 compute (entry rst_weight_grads_f32; the JAX kernels'
// compute_dtype=float32): the float32 tile below (`f32`), for one or two
// float32 A operands and float32 dg, every shape (the LSTM products, the
// projections, the float32 route's dW_x of layers 1..L-1): no operand is
// rounded.  128x128 output tiles of 256 threads, each thread 8x8 sums by
// FMA (no tensor cores), K walked in 8-row steps staged through registers
// into double-buffered shared memory; db summed from dg by the blocks of
// the first row tile; K split into fixed-order partials as the other
// tiles.  What bounds it on the H100 is the float32 rate (67 TFLOP/s):
// the LSTM shape's 3.8 TFLOP a call take at least 56 ms at that rate.
//
// The float32 skinny tile (entry rst_weight_grad_skinny_f32, `skinny_f32`):
// float32 compute for one A operand whose narrow side (min(D, G)) is at most
// 256 columns: the projections in the float32 mode (D = 120 x G = 1024 and
// D = 1024 x G = 80 at N = 224,640, 92 GFLOP the pair, 1.37 ms at 67
// TFLOP/s: bound by the float32 rate, not by their 2.0 GB).  The float32
// tile above fills 80 of an output tile's 128 columns at the output
// projection and walks K in 8-row steps through registers.  Here, as in
// the bf16 skinny tile, a block owns 128 columns of the wide operand and
// the narrow side whole, over one K slice: the wide operand is read from
// device memory once across the grid.  Both float32 operands stream
// through a four-stage cp.async ring in 16-row stages (16-byte copies, or
// 4-byte ones for rows that are not 16-byte aligned; zeros past the
// edges); each of the 256 threads sums 8 wide x NJ narrow outputs by FMA
// (NJ = 16ths of the narrow side, rounded up to one of a few instances:
// 8 at n = 120, 5 at n = 80), the rows in order; db is summed from the
// staged dg in the same pass, a thread a column, the rows in order.  K is
// split so that the grid fills the card at two blocks an SM (33 slices of
// 6,816 rows at the projections, 264 blocks), and the slices' partials
// are summed in a fixed order: dW and db repeat bit for bit.

#include "f32_gemm.cuh"
#include "grad_matmul.cuh"

namespace rst_grad {
namespace skinny {

constexpr int kBM = 128;                    // wide columns a block: 2 warpgroups x 64
constexpr int kThreads = 256;               // thread 0 also issues the loads
constexpr int kMaxNarrow = 256;
constexpr int kMaxStages = 8;
constexpr int kSmemLimit = 232448;          // the H100's 227 KB a block may use

// Strips of the narrow side: the wgmma N (64, 128 or 256) over 64.
__host__ __device__ constexpr int narrow_strips(int n) { return n <= 64 ? 1 : n <= 128 ? 2 : 4; }

// K rows a stage: 64, or 32 for a narrow side past 128 columns, whose
// stages would not fit twice in shared memory otherwise.
__host__ __device__ constexpr int stage_rows(int n) { return n <= 128 ? 64 : 32; }

// d (64 x kN f32) = a·b + (keep ? d : 0) over 16 K rows, a (64 x 16) and
// b (16 x kN) both MN-major bf16 in 128-byte swizzle.
template <int kN>
__device__ __forceinline__ void mma(float (&d)[kN / 2], uint64_t a, uint64_t b, uint32_t keep);

#define RST_ACC8(i)                                                              \
  "+f"(d[(i)]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3]), "+f"(d[(i) + 4]), \
      "+f"(d[(i) + 5]), "+f"(d[(i) + 6]), "+f"(d[(i) + 7])

template <>
__device__ __forceinline__ void mma<64>(float (&d)[32], uint64_t a, uint64_t b, uint32_t keep) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 1, 1;\n"
      "}\n"
      : RST_ACC8(0), RST_ACC8(8), RST_ACC8(16), RST_ACC8(24)
      : "l"(a), "l"(b), "r"(keep));
}

template <>
__device__ __forceinline__ void mma<128>(float (&d)[64], uint64_t a, uint64_t b, uint32_t keep) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 1, 1;\n"
      "}\n"
      : RST_ACC8(0), RST_ACC8(8), RST_ACC8(16), RST_ACC8(24), RST_ACC8(32), RST_ACC8(40),
        RST_ACC8(48), RST_ACC8(56)
      : "l"(a), "l"(b), "r"(keep));
}

#undef RST_ACC8

template <>
__device__ __forceinline__ void mma<256>(float (&d)[128], uint64_t a, uint64_t b, uint32_t keep) {
  tma::mma_64x256x16<1>(d, a, b, keep);
}

struct Args {
  int w, n;             // widths of the wide and the narrow operand
  int wide_dg;          // 1: dg is the wide operand (dW stored transposed); 0: x is
  int steps;            // K stages in all: ceil(N / kBK)
  int steps_per_split;  // K stages of one slice (grid.y)
  int stages;           // ring depth
  int skip_split;       // planted fault: this slice's blocks store zeros (-1: none)
  float* out;           // (D, G) dW, or (splits, D, G) partials
  float* out_db;        // (G,) db, or (splits, G) partials
};

// Copies a (kBK, cols) f32 box (rows `cols` floats apart) into bf16
// strips (64 columns each, 128·kBK bytes apart) at dst, in the 128-byte
// swizzle wgmma reads, rounding to nearest even: 16 bytes of a row a
// thread, thread (rg, cg) taking columns [4cg, 4cg + 4) of rows rg,
// rg + RG, ...  With `sum`, adds each value, unrounded, to acc in that row
// order.
template <bool kSum, int kBK>
__device__ __forceinline__ void to_strips(const uint8_t* src, int cols, uint8_t* dst,
                                          float (&acc)[8]) {
  constexpr int kStrip = 128 * kBK;
  const int cg_n = cols / 4, rg_n = kThreads / cg_n;
  const int cg = threadIdx.x % cg_n, rg = threadIdx.x / cg_n;
  if (rg >= rg_n) return;
  const int c = cg * 4;
  uint8_t* strip = dst + (c / 64) * kStrip;
  const int byte = 2 * (c % 64);
  for (int r = rg; r < kBK; r += rg_n) {
    const float4 f = *reinterpret_cast<const float4*>(src + ((size_t)r * cols + c) * 4);
    if (kSum) {
      acc[0] += f.x;
      acc[1] += f.y;
      acc[2] += f.z;
      acc[3] += f.w;
    }
    __nv_bfloat162 lo = __floats2bfloat162_rn(f.x, f.y);
    __nv_bfloat162 hi = __floats2bfloat162_rn(f.z, f.w);
    uint2 packed;
    packed.x = *reinterpret_cast<uint32_t*>(&lo);
    packed.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(strip + r * 128 + (byte ^ ((r & 7) << 4))) = packed;
  }
}

// Adds the columns of bf16 strips (as TMA writes them, 128-byte swizzle)
// to acc: thread (rg, cg) its columns [8cg, 8cg + 8) over rows rg,
// rg + RG, ..., in row order (the mapping to_strips would use for bf16).
template <int kBK>
__device__ __forceinline__ void sum_strips(const uint8_t* src, int cols, float (&acc)[8]) {
  constexpr int kStrip = 128 * kBK;
  const int cg_n = cols / 8, rg_n = kThreads / cg_n;
  const int cg = threadIdx.x % cg_n, rg = threadIdx.x / cg_n;
  if (rg >= rg_n) return;
  const int c = cg * 8;
  const uint8_t* strip = src + (c / 64) * kStrip;
  const int byte = 2 * (c % 64);
  for (int r = rg; r < kBK; r += rg_n) {
    const uint4 v = *reinterpret_cast<const uint4*>(strip + r * 128 + (byte ^ ((r & 7) << 4)));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[2 * e] += __low2float(h[e]);
      acc[2 * e + 1] += __high2float(h[e]);
    }
  }
}

// Block (x: 128-column chunk of the wide operand, y: K slice).  Shared
// memory: the bf16 strips converted from f32 operands (at the end, the db
// partials), the ring of stages, the full barriers.  A stage holds each
// operand as TMA wrote it: a bf16 operand as swizzled 64-column strips
// that wgmma reads where they landed, an f32 one as a dense box of its
// rows that the block converts into the strips.
template <typename TW, typename TN, int kN>
__global__ void __launch_bounds__(kThreads, 1)
    skinny_kernel(const __grid_constant__ CUtensorMap map_w,
                  const __grid_constant__ CUtensorMap map_n, Args p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  constexpr int kBK = stage_rows(kN);                    // K rows a stage
  constexpr int kStrip = 128 * kBK;                      // bytes of a 64-column bf16 strip
  constexpr int kNS = kN / 64;                           // narrow strips
  constexpr bool kWideF32 = sizeof(TW) == 4, kNarrowF32 = sizeof(TN) == 4;
  uint8_t* cw = smem;                                    // [2] wide strips from f32
  uint8_t* cn = cw + 2 * kStrip;                         // [kNS] narrow strips from f32
  uint8_t* ring = cn + kNS * kStrip;
  const int w_bytes = kStrip * (int)sizeof(TW);          // a stage's 128 wide columns
  const int n_bytes = kNarrowF32 ? kBK * p.n * 4 : kNS * kStrip;
  const int stage_bytes = w_bytes + n_bytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + p.stages * stage_bytes);
  const int chunk = blockIdx.x, split = blockIdx.y;
  const int m0 = chunk * kBM;
  const int k0 = split * p.steps_per_split;
  const int k1 = min(p.steps, k0 + p.steps_per_split);
  const int n_st = k1 - k0;
  // bf16 strips past the operand's columns would load only zeros (and feed
  // only outputs that are not stored): they are not loaded.
  const int w_boxes = kWideF32 ? 1 : min(2, (p.w - m0 + 63) / 64);
  const int n_boxes = kNarrowF32 ? 1 : (p.n + 63) / 64;
  const int tx = (kWideF32 ? w_bytes : w_boxes * kStrip) +
                 (kNarrowF32 ? n_bytes : n_boxes * kStrip);
  // Thread 0: stage k's boxes into its ring slot, on its full barrier.
  auto issue = [&](int k) {
    const int s = (k - k0) % p.stages;
    const uint32_t bar = tma::smem_addr(&full[s]);
    tma::bar_expect_tx(bar, tx);
    const uint32_t st = tma::smem_addr(ring + s * stage_bytes);
    for (int q = 0; q < w_boxes; ++q) {
      tma::load_box(st + q * kStrip, &map_w, bar, m0 + 64 * q, k * kBK);
    }
    for (int q = 0; q < n_boxes; ++q) {
      tma::load_box(st + w_bytes + q * kStrip, &map_n, bar, 64 * q, k * kBK);
    }
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) tma::bar_init(tma::smem_addr(&full[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int i = 0; i < min(n_st, p.stages); ++i) issue(k0 + i);
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;           // this warpgroup's 64 wide columns
  float d[kN / 2];
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) d[i] = 0.0f;
  float dsum[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  const bool db_wide = p.out_db != nullptr && p.wide_dg;
  const bool db_narrow = p.out_db != nullptr && !p.wide_dg && chunk == 0;
  for (int i = 0; i < n_st; ++i) {
    const int s = i % p.stages;
    tma::bar_wait(tma::smem_addr(&full[s]), (i / p.stages) & 1);
    uint8_t* raw = ring + s * stage_bytes;
    if constexpr (kWideF32) {
      if (db_wide) {
        to_strips<true, kBK>(raw, kBM, cw, dsum);
      } else {
        to_strips<false, kBK>(raw, kBM, cw, dsum);
      }
    } else if (db_wide) {
      sum_strips<kBK>(raw, kBM, dsum);
    }
    if constexpr (kNarrowF32) {
      if (db_narrow) {
        to_strips<true, kBK>(raw + w_bytes, p.n, cn, dsum);
      } else {
        to_strips<false, kBK>(raw + w_bytes, p.n, cn, dsum);
      }
    } else if (db_narrow) {
      sum_strips<kBK>(raw + w_bytes, p.n, dsum);
    }
    // The converted strips, written by this proxy, are read by wgmma's.
    if (kWideF32 || kNarrowF32) asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    // With both operands converted, slot s is free now; else wgmma reads it.
    if (kWideF32 && kNarrowF32 && threadIdx.x == 0 && i + p.stages < n_st) {
      issue(k0 + i + p.stages);
    }
    const uint32_t a = tma::smem_addr((kWideF32 ? cw : raw) + wg * kStrip);
    const uint32_t b = tma::smem_addr(kNarrowF32 ? cn : raw + w_bytes);
    tma::fence_acc(d);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      // 16 K rows: two 1024-byte row groups of each strip.
      mma<kN>(d, tma::mn_desc(a + kk * 2048, kStrip), tma::mn_desc(b + kk * 2048, kStrip),
              (i > 0) | kk);
    }
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    tma::fence_acc(d);
    __syncthreads();                           // slot s and the strips are free
    if (!(kWideF32 && kNarrowF32) && threadIdx.x == 0 && i + p.stages < n_st) {
      issue(k0 + i + p.stages);
    }
  }

  // dW: x wide, dW[m][col] (D = w, G = n); dg wide, dW[col][m] (D = n, G = w).
  // Register 4j + r holds row 16·warp + lane/4 + 8·(r/2), column
  // 8j + 2·(lane%4) + r%2 of the warpgroup's 64 x kN tile.
  const bool zero = split == p.skip_split;
  const int D = p.wide_dg ? p.n : p.w, G = p.wide_dg ? p.w : p.n;
  float* out = p.out + (size_t)split * D * G;   // the slice's partial, or dW itself
  const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
#pragma unroll
  for (int e = 0; e < kN / 2; ++e) {
    const int m = m0 + 64 * wg + 16 * warp + lane / 4 + 8 * ((e % 4) / 2);
    const int col = 8 * (e / 4) + 2 * (lane % 4) + e % 2;
    if (m < p.w && col < p.n) {
      out[p.wide_dg ? (size_t)col * G + m : (size_t)m * G + col] = zero ? 0.0f : d[e];
    }
  }
  // db: dg's columns, each summed over its row groups in order.
  if (!db_wide && !db_narrow) return;
  const int v = 16 / (p.wide_dg ? sizeof(TW) : sizeof(TN)), cols = p.wide_dg ? kBM : p.n;
  const int cg_n = cols / v, rg_n = kThreads / cg_n;
  const int cg = threadIdx.x % cg_n, rg = threadIdx.x / cg_n;
  float* red = reinterpret_cast<float*>(cw);   // [row group][column]; the strips are free
  if (rg < rg_n) {
    for (int e = 0; e < v; ++e) red[rg * cols + cg * v + e] = dsum[e];
  }
  __syncthreads();
  const int valid = p.wide_dg ? min(kBM, p.w - m0) : p.n;
  for (int c = threadIdx.x; c < valid; c += kThreads) {
    float sum = 0.0f;
    for (int r = 0; r < rg_n; ++r) sum += red[r * cols + c];
    p.out_db[(size_t)split * G + (p.wide_dg ? m0 + c : c)] = zero ? 0.0f : sum;
  }
}

// Tensor map of a row-major (rows, cols) array in boxes of box_rows rows:
// f32 in boxes of box_cols columns, unswizzled (the rows as they lie in
// memory); bf16 in 64-column strips in 128-byte swizzle, as wgmma reads
// them.  Reads past either edge fill zeros.
inline bool make_map(CUtensorMap* map, const void* base, bool f32, int rows, int cols,
                     int box_cols, int box_rows) {
  const tma::EncodeTiled encode = tma::encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t esz = f32 ? 4 : 2;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * esz};
  const cuuint32_t box[2] = {(cuuint32_t)(f32 ? box_cols : 64), (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                2, const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                f32 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Dynamic shared memory of a launch: the 1024-byte alignment slack, the
// bf16 strips, the ring of raw stages and its mbarriers.
inline size_t smem_bytes(int w_f32, int n_f32, int n, int stages) {
  const size_t rows = stage_rows(n), strip = 128 * rows;
  const size_t stage = rows * kBM * (w_f32 ? 4 : 2) +
                       (n_f32 ? rows * n * 4 : narrow_strips(n) * strip);
  return 1024 + (2 + narrow_strips(n)) * strip + stages * (stage + 8);
}

template <typename TW, typename TN, int kN>
int run(const CUtensorMap& mw, const CUtensorMap& mn, const Args& p, int chunks, int splits,
        size_t smem, cudaStream_t st) {
  const cudaError_t err = cudaFuncSetAttribute(
      skinny_kernel<TW, TN, kN>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  skinny_kernel<TW, TN, kN><<<dim3(chunks, splits), kThreads, smem, st>>>(mw, mn, p);
  return (int)cudaGetLastError();
}

template <typename TW, typename TN>
int run_n(const CUtensorMap& mw, const CUtensorMap& mn, const Args& p, int chunks, int splits,
          size_t smem, cudaStream_t st) {
  switch (narrow_strips(p.n)) {
    case 1:
      return run<TW, TN, 64>(mw, mn, p, chunks, splits, smem, st);
    case 2:
      return run<TW, TN, 128>(mw, mn, p, chunks, splits, smem, st);
    default:
      return run<TW, TN, 256>(mw, mn, p, chunks, splits, smem, st);
  }
}

// x (N, D) f32 or bf16, dg (N, G) f32 or bf16, both 16-byte aligned with
// D and G multiples of 8 and min(D, G) <= 256; wide_dg as the plan says
// (dg is the wide operand); K slices of rows_per_split rows, a multiple of
// 64.  out: dW or the (splits, D, G) partials; out_db: db, the (splits, G)
// partials, or null.
inline int launch(const void* x, int x_f32, int D, const void* dg, int dg_f32, int N, int G,
                  int wide_dg, int splits, int rows_per_split, int stages, int skip_split,
                  float* out, float* out_db, cudaStream_t st) {
  const int w = wide_dg ? G : D, n = wide_dg ? D : G;
  const int w_f32 = wide_dg ? dg_f32 : x_f32, n_f32 = wide_dg ? x_f32 : dg_f32;
  auto aligned = [](const void* q) { return reinterpret_cast<uintptr_t>(q) % 16 == 0; };
  if (D <= 0 || G <= 0 || D % 8 || G % 8 || n > kMaxNarrow || N <= 0 || splits < 1 ||
      rows_per_split % 64 || stages < 2 || stages > kMaxStages || !aligned(x) ||
      !aligned(dg) || (long long)splits * rows_per_split < N ||
      (long long)(splits - 1) * rows_per_split >= N) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = smem_bytes(w_f32, n_f32, n, stages);
  if (smem > (size_t)kSmemLimit) return (int)cudaErrorInvalidValue;
  CUtensorMap mw, mn;
  const int rows = stage_rows(n);
  if (!make_map(&mw, wide_dg ? dg : x, w_f32, N, w, kBM, rows) ||
      !make_map(&mn, wide_dg ? x : dg, n_f32, N, n, n, rows)) {
    return (int)cudaErrorInvalidValue;
  }
  Args p;
  p.w = w;
  p.n = n;
  p.wide_dg = wide_dg;
  p.steps = (N + rows - 1) / rows;
  p.steps_per_split = rows_per_split / rows;
  p.stages = stages;
  p.skip_split = skip_split;
  p.out = out;
  p.out_db = out_db;
  const int chunks = (w + kBM - 1) / kBM;
  if (w_f32) {
    return n_f32 ? run_n<float, float>(mw, mn, p, chunks, splits, smem, st)
                 : run_n<float, bf16>(mw, mn, p, chunks, splits, smem, st);
  }
  return n_f32 ? run_n<bf16, float>(mw, mn, p, chunks, splits, smem, st)
               : run_n<bf16, bf16>(mw, mn, p, chunks, splits, smem, st);
}

}  // namespace skinny

// ------------------------------------------------------ the float32 tile

namespace f32 {

constexpr int kBM = 128;        // output rows (A columns) per block
constexpr int kBN = 128;        // output columns (dg columns) per block
constexpr int kBK = 8;          // K rows per step
constexpr int kThreads = 256;   // thread (tx, ty) = (tid % 16, tid / 16): 8x8 sums

struct Args {
  const float* a0;    // (N, d0) first A operand
  const float* a1;    // (N, d1) second A operand, or null (d1 = 0)
  const float* dg;    // (N, G)
  int d0, d1, N, G;
  int mt0;            // row tiles of a0; grid.x = mt0 + row tiles of a1
  int rows_per_split;
  float* out;         // (d0 + d1, G) dW, or (splits, d0 + d1, G) partials
  float* out_db;      // (G,) db, or (splits, G) partials; null: no db
};

// Row n (< n_end) of a row-major (rows, cols) array at columns [col,
// col + 4) (those < cols); zeros elsewhere.
__device__ __forceinline__ float4 load4(const float* p, int cols, bool vec, int n, int n_end,
                                        int col) {
  if (n < n_end && vec && col + 4 <= cols) {
    return __ldg(reinterpret_cast<const float4*>(p + (size_t)n * cols + col));
  }
  float v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    v[e] = (n < n_end && col + e < cols) ? p[(size_t)n * cols + col + e] : 0.0f;
  }
  return make_float4(v[0], v[1], v[2], v[3]);
}

__global__ void __launch_bounds__(kThreads) grad_kernel(Args p) {
  __shared__ __align__(16) float As[2][kBK][kBM + 4];   // As[k][m]
  __shared__ __align__(16) float Bs[2][kBK][kBN + 4];   // Bs[k][g]

  const bool second = blockIdx.x >= p.mt0;
  const float* a = second ? p.a1 : p.a0;
  const int D = second ? p.d1 : p.d0;
  const int m0 = (second ? blockIdx.x - p.mt0 : blockIdx.x) * kBM;
  const int row_off = second ? p.d0 : 0;   // first output row of this operand
  const int g0 = blockIdx.y * kBN;
  const int split = blockIdx.z;
  const int n_begin = split * p.rows_per_split;
  const int n_end = min(p.N, n_begin + p.rows_per_split);
  const int n_steps = n_end > n_begin ? (n_end - n_begin + kBK - 1) / kBK : 0;
  const bool do_db = blockIdx.x == 0 && p.out_db != nullptr;  // one row tile sums db
  const bool a_vec = D % 4 == 0, g_vec = p.G % 4 == 0;
  const int lr = threadIdx.x / 32, lc = (threadIdx.x % 32) * 4;   // this thread's loads
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  float db[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  float4 ra, rb;
  auto fetch = [&](int n0) {
    ra = load4(a, D, a_vec, n0 + lr, n_end, m0 + lc);
    rb = load4(p.dg, p.G, g_vec, n0 + lr, n_end, g0 + lc);
    if (do_db) {
      db[0] += rb.x;
      db[1] += rb.y;
      db[2] += rb.z;
      db[3] += rb.w;
    }
  };
  auto put = [&](int buf) {
    *reinterpret_cast<float4*>(&As[buf][lr][lc]) = ra;
    *reinterpret_cast<float4*>(&Bs[buf][lr][lc]) = rb;
  };
  if (n_steps > 0) {
    fetch(n_begin);
    put(0);
  }
  __syncthreads();
  for (int ks = 0; ks < n_steps; ++ks) {
    const bool more = ks + 1 < n_steps;
    if (more) fetch(n_begin + (ks + 1) * kBK);   // in flight during the sums
    const int cur = ks & 1;
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 a_lo = *reinterpret_cast<const float4*>(&As[cur][k][4 * ty]);
      const float4 a_hi = *reinterpret_cast<const float4*>(&As[cur][k][64 + 4 * ty]);
      const float4 b_lo = *reinterpret_cast<const float4*>(&Bs[cur][k][4 * tx]);
      const float4 b_hi = *reinterpret_cast<const float4*>(&Bs[cur][k][64 + 4 * tx]);
      const float av[8] = {a_lo.x, a_lo.y, a_lo.z, a_lo.w, a_hi.x, a_hi.y, a_hi.z, a_hi.w};
      const float bv[8] = {b_lo.x, b_lo.y, b_lo.z, b_lo.w, b_hi.x, b_hi.y, b_hi.z, b_hi.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (more) put(cur ^ 1);   // read by every thread two steps ago, synced since
    __syncthreads();
  }

  const int Mtot = p.d0 + p.d1;
  float* out = p.out + (size_t)split * Mtot * p.G;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
    if (m >= D) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int g = g0 + (j < 4 ? 4 * tx + j : 64 + 4 * tx + j - 4);
      if (g < p.G) out[(size_t)(row_off + m) * p.G + g] = acc[i][j];
    }
  }

  if (do_db) {  // uniform over the block: the load rows' sums, in row order
    float* red = &As[0][0][0];   // [kBK][kBM]; the stages are free
#pragma unroll
    for (int e = 0; e < 4; ++e) red[lr * kBN + lc + e] = db[e];
    __syncthreads();
    if (threadIdx.x < kBN && g0 + threadIdx.x < p.G) {
      float sum = 0.0f;
      for (int r = 0; r < kBK; ++r) sum += red[r * kBN + threadIdx.x];
      p.out_db[(size_t)split * p.G + g0 + threadIdx.x] = sum;
    }
  }
}

}  // namespace f32

// ---------------------------------------------- the float32 skinny tile

namespace skinny_f32 {

constexpr int kBM = 128;        // wide columns a block
constexpr int kThreads = 256;   // thread (tx, ty) = (tid % 16, tid / 16)
constexpr int kBK = 16;         // K rows a stage
constexpr int kStages = 4;      // the cp.async ring
constexpr int kMaxNarrow = 256;
constexpr int kLdW = kBM + 4;   // a staged row of the wide operand

// Narrow columns a thread sums: the narrow side n in 16 groups of NJ
// columns, NJ from a few instances.
__host__ __device__ constexpr int narrow_per_thread(int n) {
  return n <= 32 ? 2 : n <= 64 ? 4 : n <= 80 ? 5 : n <= 96 ? 6 : n <= 128 ? 8 : n <= 192 ? 12 : 16;
}

// Narrow column of thread group ty's j-th sum, NJ = 4a + b: the first 4a
// in float4s, 4ty + 64(j/4) + j%4 (columns [0, 64a)), the other b single,
// 64a + ty + 16(j - 4a).
template <int NJ>
__device__ __forceinline__ int narrow_col(int ty, int j) {
  constexpr int kA = NJ / 4;
  return j < 4 * kA ? 4 * ty + 64 * (j / 4) + j % 4 : 64 * kA + ty + 16 * (j - 4 * kA);
}

// A staged row of the narrow operand (16·NJ columns, padded by four).
__host__ __device__ constexpr int narrow_ld(int nj) { return 16 * nj + 4; }

__host__ __device__ constexpr size_t smem_bytes(int nj) {
  return (size_t)kStages * kBK * (kLdW + narrow_ld(nj)) * sizeof(float);
}

struct Args {
  const float* wide;     // (N, w) row-major
  const float* narrow;   // (N, n) row-major
  int w, n, N;
  int wide_dg;           // dg is the wide operand: dW is (n, w); else x is: dW (w, n)
  int rows_per_split;
  int skip_split;        // a planted fault: that slice stores zeros (-1: none)
  float* out;            // dW, or the (splits, D, G) partials
  float* out_db;         // db, or the (splits, G) partials; null: no db
};

// Rows [r0, r0 + kBK) (those < r_end) of the row-major (N, cols) array src
// at columns [c0, c0 + width) into dst (kBK rows of ld floats): 16-byte
// copies where the rows are 16-byte aligned (cols a multiple of 4), else
// 4-byte ones; zeros past either edge.
__device__ __forceinline__ void stage_rows(float* dst, int ld, const float* src, int cols, int c0,
                                           int width, int r0, int r_end, int N) {
  if (cols % 4 == 0) {
    for (int v = threadIdx.x; v < kBK * (width / 4); v += kThreads) {
      const int r = v / (width / 4), c = 4 * (v % (width / 4));
      const int row = r0 + r, col = c0 + c;
      const bool ok = row < r_end && col < cols;
      const size_t off = ok ? (size_t)row * cols + col : 0;
      if (ok) RST_CHECK(off + 3, (long long)N * cols);
      rst_f32::cp_async16_zfill(dst + r * ld + c, src + off, ok);
    }
  } else {
    for (int v = threadIdx.x; v < kBK * width; v += kThreads) {
      const int r = v / width, c = v % width;
      const int row = r0 + r, col = c0 + c;
      const bool ok = row < r_end && col < cols;
      const size_t off = ok ? (size_t)row * cols + col : 0;
      if (ok) RST_CHECK(off, (long long)N * cols);
      rst_f32::cp_async4_zfill(dst + r * ld + c, src + off, ok);
    }
  }
}

// Block (x: 128-column chunk of the wide operand, y: K slice): the
// (128, n) tile of dW over the slice's rows, each thread 8 wide x NJ
// narrow sums (``narrow_col``) by FMA over the rows in order; db (dg's columns of this
// block, the wide chunk's or, in chunk 0's blocks, the narrow side) summed
// from the staged rows in order by one thread a column.
template <int NJ>
__global__ void __launch_bounds__(kThreads, NJ <= 8 ? 2 : 1) skinny_f32_kernel(Args p) {
  extern __shared__ __align__(16) float smem_sk[];
  constexpr int kLdN = narrow_ld(NJ);
  constexpr int kStageF = kBK * (kLdW + kLdN);
  const int chunk = blockIdx.x, split = blockIdx.y;
  const int m0 = chunk * kBM;
  const int r_begin = split * p.rows_per_split;
  const int r_end = min(p.N, r_begin + p.rows_per_split);
  const int n_st = r_end > r_begin ? (r_end - r_begin + kBK - 1) / kBK : 0;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const bool db_wide = p.out_db != nullptr && p.wide_dg;
  const bool db_narrow = p.out_db != nullptr && !p.wide_dg && chunk == 0;
  const int db_cols = db_wide ? min(kBM, p.w - m0) : db_narrow ? p.n : 0;

  auto issue = [&](int i) {
    float* st = smem_sk + (size_t)(i % kStages) * kStageF;
    const int r0 = r_begin + i * kBK;
    stage_rows(st, kLdW, p.wide, p.w, m0, kBM, r0, r_end, p.N);
    stage_rows(st + kBK * kLdW, kLdN, p.narrow, p.n, 0, 16 * NJ, r0, r_end, p.N);
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_st) issue(s);
    rst::cp_async_commit();
  }
  float acc[8][NJ];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;
  float dsum = 0.0f;
  for (int i = 0; i < n_st; ++i) {
    rst::cp_async_wait<kStages - 2>();   // stage i has landed
    __syncthreads();                     // every thread is done with stage i - 1
    if (i + kStages - 1 < n_st) issue(i + kStages - 1);
    rst::cp_async_commit();
    const float* ws = smem_sk + (size_t)(i % kStages) * kStageF;
    const float* ns = ws + kBK * kLdW;
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 w0 = *reinterpret_cast<const float4*>(ws + k * kLdW + 4 * tx);
      const float4 w1 = *reinterpret_cast<const float4*>(ws + k * kLdW + 64 + 4 * tx);
      const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
      float nv[NJ];
#pragma unroll
      for (int j = 0; j < NJ / 4; ++j) {
        const float4 v = *reinterpret_cast<const float4*>(ns + k * kLdN + 4 * ty + 64 * j);
        nv[4 * j] = v.x;
        nv[4 * j + 1] = v.y;
        nv[4 * j + 2] = v.z;
        nv[4 * j + 3] = v.w;
      }
#pragma unroll
      for (int j = 4 * (NJ / 4); j < NJ; ++j) nv[j] = ns[k * kLdN + narrow_col<NJ>(ty, j)];
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[a][j] = fmaf(wv[a], nv[j], acc[a][j]);
    }
    if (tid < db_cols) {
      const float* d = db_wide ? ws + tid : ns + tid;
      const int ld = db_wide ? kLdW : kLdN;
#pragma unroll
      for (int k = 0; k < kBK; ++k) dsum += d[k * ld];
    }
  }
  rst::cp_async_wait<0>();

  const bool zero = split == p.skip_split;
  const int D = p.wide_dg ? p.n : p.w, G = p.wide_dg ? p.w : p.n;
  float* out = p.out + (size_t)split * D * G;   // the slice's partial, or dW itself
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int m = m0 + 4 * tx + 64 * (a / 4) + a % 4;
    if (m >= p.w) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int nc = narrow_col<NJ>(ty, j);
      if (nc >= p.n) continue;
      const size_t o = p.wide_dg ? (size_t)nc * G + m : (size_t)m * G + nc;
      RST_CHECK(o, (long long)D * G);
      out[o] = zero ? 0.0f : acc[a][j];
    }
  }
  if (tid < db_cols) {
    const int col = db_wide ? m0 + tid : tid;
    RST_CHECK(col, G);
    p.out_db[(size_t)split * G + col] = zero ? 0.0f : dsum;
  }
}

template <int NJ>
int run(const Args& p, int chunks, int splits, cudaStream_t st) {
  const size_t smem = smem_bytes(NJ);
  const cudaError_t err = cudaFuncSetAttribute(
      skinny_f32_kernel<NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  skinny_f32_kernel<NJ><<<dim3(chunks, splits), kThreads, smem, st>>>(p);
  return (int)cudaGetLastError();
}

// x (N, D), dg (N, G) float32, 16-byte aligned, min(D, G) <= 256 on the
// narrow side; wide_dg as the plan says; K slices of rows_per_split rows
// (a multiple of kBK).  out: dW or the (splits, D, G) partials; out_db: db
// or the (splits, G) partials.
inline int launch(const float* x, int D, const float* dg, int N, int G, int wide_dg, int splits,
                  int rows_per_split, int skip_split, float* out, float* out_db,
                  cudaStream_t st) {
  const int w = wide_dg ? G : D, n = wide_dg ? D : G;
  auto aligned = [](const void* q) { return reinterpret_cast<uintptr_t>(q) % 16 == 0; };
  if (D <= 0 || G <= 0 || n > kMaxNarrow || N <= 0 || splits < 1 || rows_per_split <= 0 ||
      rows_per_split % kBK || !aligned(x) || !aligned(dg) ||
      (long long)splits * rows_per_split < N || (long long)(splits - 1) * rows_per_split >= N) {
    return (int)cudaErrorInvalidValue;
  }
  Args p;
  p.wide = wide_dg ? dg : x;
  p.narrow = wide_dg ? x : dg;
  p.w = w;
  p.n = n;
  p.N = N;
  p.wide_dg = wide_dg;
  p.rows_per_split = rows_per_split;
  p.skip_split = skip_split;
  p.out = out;
  p.out_db = out_db;
  const int chunks = (w + kBM - 1) / kBM;
  switch (narrow_per_thread(n)) {
    case 2:
      return run<2>(p, chunks, splits, st);
    case 4:
      return run<4>(p, chunks, splits, st);
    case 5:
      return run<5>(p, chunks, splits, st);
    case 6:
      return run<6>(p, chunks, splits, st);
    case 8:
      return run<8>(p, chunks, splits, st);
    case 12:
      return run<12>(p, chunks, splits, st);
    default:
      return run<16>(p, chunks, splits, st);
  }
}

}  // namespace skinny_f32
}  // namespace rst_grad

// h (N, dh) and x (N, dx) bf16, dgates (N, G) bf16 (dg_f32 = 0) or f32;
// dw (dh + dx, G) f32 = [h_prevᵀ·dgates ; xᵀ·dgates], db (G,) f32.
// path 0: the WMMA tile, 1: the Hopper tile (rst_grad::Path).  K is split
// into `splits` slices of rows_per_split rows (a multiple of the path's K
// step: 32 or 64); with splits > 1, partial (splits, dh + dx, G) and
// partial_db (splits, G) f32 hold the slices' sums before the second pass.
// Returns the CUDA error code of the launches (0 = success).
extern "C" int rst_dgates_weight_grads(int path, const void* h, int dh, const void* x, int dx,
                                       const void* dgates, int dg_f32, int N, int G,
                                       int splits, int rows_per_split, float* partial,
                                       float* partial_db, float* dw, float* db,
                                       void* stream) {
  return rst_grad::launch(path, h, dh, x, dx, dgates, dg_f32, N, G, splits, rows_per_split,
                          partial, partial_db, dw, db, 0, stream);
}

// x (N, D) bf16, dg (N, G) bf16 or f32 -> dw (D, G) = xᵀ·dg, db (G,) f32.
extern "C" int rst_weight_grad(int path, const void* x, int D, const void* dg, int dg_f32,
                               int N, int G, int splits, int rows_per_split, float* partial,
                               float* partial_db, float* dw, float* db, void* stream) {
  return rst_grad::launch(path, x, D, nullptr, 0, dg, dg_f32, N, G, splits, rows_per_split,
                          partial, partial_db, dw, db, 0, stream);
}

// Float32 compute: a0 (N, d0) and a1 (N, d1) (a1 null, d1 = 0: one
// operand), dg (N, G), all float32, 16-byte aligned -> dw (d0 + d1, G) =
// [a0ᵀ·dg ; a1ᵀ·dg], db (G,) = Σ dg (db null: none), on the float32 tile,
// no operand rounded.  K is split into `splits` slices of rows_per_split
// rows (a multiple of 8); with splits > 1, partial (splits, d0 + d1, G) and
// partial_db (splits, G) hold the slices' sums before the fixed-order
// second pass.  Returns the CUDA error code (0 = success).
extern "C" int rst_weight_grads_f32(const float* a0, int d0, const float* a1, int d1,
                                    const float* dg, int N, int G, int splits,
                                    int rows_per_split, float* partial, float* partial_db,
                                    float* dw, float* db, void* stream) {
  namespace f = rst_grad::f32;
  if (d0 <= 0 || d1 < 0 || (d1 > 0) != (a1 != nullptr) || G <= 0 || N <= 0 || splits < 1 ||
      rows_per_split % f::kBK || (long long)splits * rows_per_split < N) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  f::Args p;
  p.a0 = a0;
  p.a1 = a1;
  p.dg = dg;
  p.d0 = d0;
  p.d1 = d1;
  p.N = N;
  p.G = G;
  p.mt0 = (d0 + f::kBM - 1) / f::kBM;
  p.rows_per_split = rows_per_split;
  p.out = splits > 1 ? partial : dw;
  p.out_db = db == nullptr ? nullptr : splits > 1 ? partial_db : db;
  const dim3 grid(p.mt0 + (d1 + f::kBM - 1) / f::kBM, (G + f::kBN - 1) / f::kBN, splits);
  f::grad_kernel<<<grid, f::kThreads, 0, st>>>(p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const size_t count = (size_t)(d0 + d1) * G;
  rst_grad::sum_splits<<<(unsigned)((count + 255) / 256 < 4096 ? (count + 255) / 256 : 4096),
                         256, 0, st>>>(partial, splits, count, dw);
  if (db != nullptr) {
    rst_grad::sum_splits<<<(unsigned)((G + 255) / 256), 256, 0, st>>>(partial_db, splits,
                                                                      (size_t)G, db);
  }
  return (int)cudaGetLastError();
}

// x (N, D) f32 (x_f32 = 1) or bf16, dg (N, G) f32 (dg_f32 = 1) or bf16 ->
// dw (D, G) = xᵀ·dg (both rounded to bf16, f32 sums), db (G,) = Σ dg in
// f32, on the skinny tile.  The plan (ops/grad_matmul.py) gives wide_dg,
// the K partition (splits slices of rows_per_split rows, a multiple of 32)
// and the ring's stages; with splits > 1, partial (splits, D, G) and
// partial_db (splits, G) f32 hold the slices' sums before the fixed-order
// second pass.  skip_split >= 0 is a planted fault for checks: that
// slice's blocks store zeros.  Returns the CUDA error code (0 = success).
extern "C" int rst_weight_grad_skinny(const void* x, int x_f32, int D, const void* dg,
                                      int dg_f32, int N, int G, int wide_dg, int splits,
                                      int rows_per_split, int stages, float* partial,
                                      float* partial_db, float* dw, float* db, int skip_split,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = rst_grad::skinny::launch(
      x, x_f32, D, dg, dg_f32, N, G, wide_dg, splits, rows_per_split, stages, skip_split,
      splits > 1 ? partial : dw, splits > 1 ? partial_db : db, st);
  if (err != 0 || splits == 1) return err;
  const size_t count = (size_t)D * G;
  rst_grad::sum_splits<<<(unsigned)((count + 255) / 256 < 4096 ? (count + 255) / 256 : 4096),
                         256, 0, st>>>(partial, splits, count, dw);
  rst_grad::sum_splits<<<(unsigned)((G + 255) / 256), 256, 0, st>>>(partial_db, splits,
                                                                    (size_t)G, db);
  return (int)cudaGetLastError();
}

// Float32 compute, one operand with a narrow side: x (N, D) and dg (N, G)
// float32, 16-byte aligned, min(D, G) <= 256 -> dw (D, G) = xᵀ·dg, db (G,)
// = Σ dg, on the float32 skinny tile, no operand rounded.  The plan
// (ops/grad_matmul.py) gives wide_dg and the K partition (splits slices of
// rows_per_split rows, a multiple of 16); with splits > 1, partial
// (splits, D, G) and partial_db (splits, G) hold the slices' sums before
// the fixed-order second pass.  skip_split >= 0 is a planted fault for
// checks: that slice's blocks store zeros.  Returns the CUDA error code.
extern "C" int rst_weight_grad_skinny_f32(const float* x, int D, const float* dg, int N, int G,
                                          int wide_dg, int splits, int rows_per_split,
                                          float* partial, float* partial_db, float* dw,
                                          float* db, int skip_split, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = rst_grad::skinny_f32::launch(
      x, D, dg, N, G, wide_dg, splits, rows_per_split, skip_split, splits > 1 ? partial : dw,
      splits > 1 ? partial_db : db, st);
  if (err != 0 || splits == 1) return err;
  const size_t count = (size_t)D * G;
  rst_grad::sum_splits<<<(unsigned)((count + 255) / 256 < 4096 ? (count + 255) / 256 : 4096),
                         256, 0, st>>>(partial, splits, count, dw);
  rst_grad::sum_splits<<<(unsigned)((G + 255) / 256), 256, 0, st>>>(partial_db, splits,
                                                                    (size_t)G, db);
  return (int)cudaGetLastError();
}
