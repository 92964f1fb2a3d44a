// One LSTM timestep for one tile of hidden units: the cell the forward
// kernels share (lstm_recurrence.cu, lstm_wavefront.cu,
// lstm_wavefront_train.cu, lstm_layer_train.cu).  The recompute backward's
// gate rebuild (rebuild_gates.cuh) applies its activations.
//
// A block owns kJT = 16 hidden units j0..j0+15 and up to kMaxMT 16-row
// batch tiles (64 rows).  It computes the four gate columns of those units
// (gate order i, g, f, o), so all four gates of a (row, unit) pair meet in
// the block's shared memory and the cell update stays local: no gate
// pre-activation goes to device memory.
//
//   gates = [xp | b + x_in·W_x] + h_in·W_h   (f32 sums; xp f32 or residual dtype)
//   c' = sigmoid(f + 1)·c + sigmoid(i)·tanh(g);  h' = sigmoid(o)·tanh(c')
//   c, h <- m·(c', h') + (1 - m)·(c, h);  out <- m·h'
//
// The cell is a template on its operand type T and its residual type R
// (R = T by default): the two compute modes of the JAX kernels, and their
// mixed modes (bf16 compute with float32 residuals, or the reverse).
//
// * bf16 (T = bf16): the products' operands h, x_in, W are bf16 and each
//   of the four warps computes one gate's columns with bf16 WMMA 16x16x16
//   tiles and f32 accumulation (``cell_products``).
// * float32 (T = float): operands, h buffers and residuals are float32, as
//   the JAX kernels compute with compute_dtype=float32 (and as the plain
//   versions do with TF32 off); SIMT FMA products from the same kind of
//   staged chunks (``cell_products_f32``, K chunks of kKCf = 32), no tensor
//   cores.  What bounds it on the H100 is the float32 rate (67 TFLOP/s).
//
// The training forwards also store the backward's residuals in R, each
// where its pointer is set: the activated gates (i, g, f, o) =
// (sig(i), tanh(g), sig(f + 1), sig(o)), the carried c and the masked
// output m·h'.  With inter-layer dropout it also writes T(h·keep·scale),
// the dropped copy the layer above reads: the mask applies where the
// float32 h is produced, so the one rounding of the product's operand is
// the TPU kernel's.
//
// The product walks K in chunks (kKC = 64 bf16, kKCf = 32 float32).  Each
// chunk of the block's A rows (h) and of its 64 weight columns is copied
// to shared memory with 16-byte cp.async copies, double-buffered, so the
// next chunk's copies overlap this chunk's products and every element is
// read from device memory (in practice L2) once per block.  The W_x product
// (layers >= 1 of the wavefront, and layer 0 of its training form with
// K = D) continues the same chunk sequence after W_h.
//
// The copy of h that feeds the next step's product is written to a
// separate buffer (the caller ping-pongs two), because every block reads
// all H columns of it; the f32 carries h and c are read and written by the
// same thread only, so they are updated in place.  Batch rows are padded
// to a multiple of 16 in the h buffers; padded rows are never written and
// never read back into a real row (a product row depends only on its own A
// row).  H and the input width Kx must be multiples of kKC.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <type_traits>

#include "philox.cuh"

namespace rst {

using bf16 = __nv_bfloat16;

constexpr int kJT = 16;             // hidden units per block
constexpr int kMaxMT = 4;           // 16-row batch tiles per block (64 rows)
constexpr int kRows = kMaxMT * 16;  // batch rows per block
constexpr int kThreads = 128;       // four warps, one per gate
constexpr int kKC = 64;             // K chunk staged in shared memory
constexpr int kLd = kKC + 8;        // padded shared row (bf16), A and B tiles
constexpr int kTile = kRows * kLd;  // elements of one staged 64x64 tile
// The float32 product's staging: K chunks of 32, A rows and the block's 64
// weight columns padded by four floats (rows stay 16-byte aligned).  Two
// stages take 35,840 bytes, within the bf16 product's kCellSmem.
constexpr int kKCf = 32;
constexpr int kLdAf = kKCf + 4;
constexpr int kLdBf = 4 * kJT + 4;
constexpr int kStageF = kRows * kLdAf + kKCf * kLdBf;   // floats of one stage

__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(float v) { return v; }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }

// One step's operands and outputs; T is the operand type, R the residual
// type (bf16 or float each).
template <typename T, typename R = T>
struct CellStepT {
  const float* xp;     // (B, 4H) input pre-activations of this step, or null
  const R* xp_res = nullptr;    // (B, 4H) the same in the residual type, or null
  const float* bias;   // (4H) input bias, or null
  const T* x_in;       // (Bp, Kx) input (lower layer's h, or x), or null
  const T* w_x;        // (Kx, 4H) input weights, or null
  const T* h_in;       // (Bp, H) recurrent h
  const T* w_h;        // (H, 4H) recurrent weights
  const float* mask;   // (B) validity of this step, {0, 1}
  T* h_out;            // (Bp, H) h after this step
  float* h;            // (B, H) f32 carried h, in place
  float* c;            // (B, H) f32 carried c, in place
  float* out;          // (B, H) masked output of this step, or null
  int B, Bp, H;
  int Kx = 0;                   // width of x_in; 0 means H
  R* gates_res = nullptr;       // (B, 4H) activated gates, or null
  R* c_res = nullptr;           // (B, H) carried c, or null
  R* out_res = nullptr;         // (B, H) masked output, or null
  // Inter-layer dropout of the training forward (drop modes 1, 2): the
  // dropped copy T(h·keep·drop_scale) of the carried h, which the layer
  // above reads as its input, or null.  keep comes from drop_mask (mode 1,
  // (B, H) {0, 1}, bf16 in both modes) or from the Philox bits of
  // (drop_l, drop_t).
  T* x_drop = nullptr;          // (Bp, H)
  const bf16* drop_mask = nullptr;
  unsigned seed0 = 0, seed1 = 0, drop_thr = 0;
  int drop_l = 0, drop_t = 0;
  float drop_scale = 1.0f;
};

using CellStep = CellStepT<bf16>;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage K rows [k0, k0 + kKC) of A (rows x lda, row-major, first row of
// the block) and of the block's 64 weight columns (4 gates x 16) of W
// (K x 4H).
__device__ __forceinline__ void stage_chunk(bf16* As, bf16* Bs, const bf16* a,
                                           int lda, const bf16* w, int k0, int rows,
                                           int H, int j0) {
  for (int i = threadIdx.x; i < rows * (kKC / 8); i += kThreads) {
    const int r = i / (kKC / 8), p = i % (kKC / 8);
    cp_async16(As + r * kLd + p * 8, a + (size_t)r * lda + k0 + p * 8);
  }
  for (int i = threadIdx.x; i < kKC * 8; i += kThreads) {
    const int kr = i / 8, q = i % 8, g = q / 2, p = q % 2;
    cp_async16(Bs + kr * kLd + g * kJT + p * 8,
               w + (size_t)(k0 + kr) * 4 * H + (size_t)g * H + j0 + p * 8);
  }
}

__device__ __forceinline__ float sigmoidf_(float x) { return 1.0f / (1.0f + expf(-x)); }

// The products of the block's rows and units, bf16(h_in)·W_h followed by
// bf16(x_in)·W_x when x_in is set (s.h_in, s.w_h, s.x_in, s.w_x, s.Kx,
// s.H, s.Bp are read), as f32 sums gates[4][kRows][kJT] at the start of
// smem, which holds kCellSmem bf16.  Ends with a __syncthreads.
// Grid: x = H / kJT unit tiles, y = batch tiles of kRows rows.
constexpr int kCellSmem = 2 * 2 * kTile;

template <typename R>
__device__ __forceinline__ const float* cell_products(bf16* smem,
                                                     const CellStepT<bf16, R>& s) {
  using namespace nvcuda;
  const int warp = threadIdx.x / 32;  // the gate this warp computes
  const int j0 = blockIdx.x * kJT;
  const int row0 = blockIdx.y * kRows;
  const int n_mt = min(kMaxMT, (s.Bp - row0) / 16);
  const int rows = n_mt * 16;
  const int H = s.H;
  const int Kx = s.Kx > 0 ? s.Kx : H;
  const int n_h = H / kKC;
  const int n_chunks = s.x_in != nullptr ? n_h + Kx / kKC : n_h;

  auto stage = [&](int c) {
    bf16* As = smem + (c & 1) * 2 * kTile;
    const bool rec = c < n_h;
    const int lda = rec ? H : Kx;
    const bf16* a = (rec ? s.h_in : s.x_in) + (size_t)row0 * lda;
    stage_chunk(As, As + kTile, a, lda, rec ? s.w_h : s.w_x,
                (rec ? c : c - n_h) * kKC, rows, H, j0);
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kMaxMT];
#pragma unroll
  for (int m = 0; m < kMaxMT; ++m) wmma::fill_fragment(acc[m], 0.0f);
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;

  stage(0);
  cp_async_commit();
  for (int c = 0; c < n_chunks; ++c) {
    if (c + 1 < n_chunks) stage(c + 1);
    cp_async_commit();
    cp_async_wait<1>();  // chunk c has landed
    __syncthreads();
    const bf16* As = smem + (c & 1) * 2 * kTile;
    const bf16* Bs = As + kTile;
#pragma unroll
    for (int kk = 0; kk < kKC; kk += 16) {
      wmma::load_matrix_sync(fb, Bs + kk * kLd + warp * kJT, kLd);
#pragma unroll
      for (int m = 0; m < kMaxMT; ++m) {
        if (m < n_mt) {
          wmma::load_matrix_sync(fa, As + m * 16 * kLd + kk, kLd);
          wmma::mma_sync(acc[m], fa, fb, acc[m]);
        }
      }
    }
    __syncthreads();  // before the next iteration overwrites this stage
  }

  float* gates = reinterpret_cast<float*>(smem);  // [4][kRows][kJT]
#pragma unroll
  for (int m = 0; m < kMaxMT; ++m) {
    if (m < n_mt) {
      wmma::store_matrix_sync(gates + (warp * kRows + m * 16) * kJT, acc[m], kJT,
                              wmma::mem_row_major);
    }
  }
  __syncthreads();
  return gates;
}

// Stage K rows [k0, k0 + kKCf) of A (rows x lda float32, row-major, first
// row of the block) into As[row][k] and of the block's 64 weight columns
// (4 gates x 16) of W (K x 4H float32) into Bs[k][col].
__device__ __forceinline__ void stage_chunk_f32(float* As, float* Bs, const float* a, int lda,
                                               const float* w, int k0, int rows, int H,
                                               int j0) {
  for (int i = threadIdx.x; i < rows * (kKCf / 4); i += kThreads) {
    const int r = i / (kKCf / 4), p = i % (kKCf / 4);
    cp_async16(As + r * kLdAf + p * 4, a + (size_t)r * lda + k0 + p * 4);
  }
  for (int i = threadIdx.x; i < kKCf * 16; i += kThreads) {
    const int kr = i / 16, q = i % 16, g = q / 4, p = q % 4;
    cp_async16(Bs + kr * kLdBf + g * kJT + p * 4,
               w + (size_t)(k0 + kr) * 4 * H + (size_t)g * H + j0 + p * 4);
  }
}

// The float32 products, as ``cell_products`` with float32 operands: thread
// (rg = tid % 8, cg = tid / 8) sums rows rg + 8i (i < 8) by columns 4cg ..
// 4cg + 3 of the block's 64, over K in ascending order with FMAs.  Rows
// past the block's last real tile are staged from nothing and never
// stored.  Ends with a __syncthreads.
template <typename R>
__device__ __forceinline__ const float* cell_products_f32(float* smem,
                                                         const CellStepT<float, R>& s) {
  const int j0 = blockIdx.x * kJT;
  const int row0 = blockIdx.y * kRows;
  const int rows = min(kRows, s.Bp - row0);
  const int H = s.H;
  const int Kx = s.Kx > 0 ? s.Kx : H;
  const int n_h = H / kKCf;
  const int n_chunks = s.x_in != nullptr ? n_h + Kx / kKCf : n_h;

  auto stage = [&](int c) {
    float* As = smem + (c & 1) * kStageF;
    const bool rec = c < n_h;
    const int lda = rec ? H : Kx;
    const float* a = (rec ? s.h_in : s.x_in) + (size_t)row0 * lda;
    stage_chunk_f32(As, As + kRows * kLdAf, a, lda, rec ? s.w_h : s.w_x,
                    (rec ? c : c - n_h) * kKCf, rows, H, j0);
  };

  const int rg = threadIdx.x % 8, cg = threadIdx.x / 8;
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  stage(0);
  cp_async_commit();
  for (int c = 0; c < n_chunks; ++c) {
    if (c + 1 < n_chunks) stage(c + 1);
    cp_async_commit();
    cp_async_wait<1>();  // chunk c has landed
    __syncthreads();
    const float* As = smem + (c & 1) * kStageF;
    const float* Bs = As + kRows * kLdAf;
#pragma unroll
    for (int k = 0; k < kKCf; k += 4) {
      float4 b[4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        b[kk] = *reinterpret_cast<const float4*>(Bs + (k + kk) * kLdBf + cg * 4);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(As + (rg + 8 * i) * kLdAf + k);
        const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          acc[i][0] = fmaf(av[kk], b[kk].x, acc[i][0]);
          acc[i][1] = fmaf(av[kk], b[kk].y, acc[i][1]);
          acc[i][2] = fmaf(av[kk], b[kk].z, acc[i][2]);
          acc[i][3] = fmaf(av[kk], b[kk].w, acc[i][3]);
        }
      }
    }
    __syncthreads();  // before the next iteration overwrites this stage
  }

  float* gates = smem;  // [4][kRows][kJT]
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = cg * 4 + j;
      gates[((col / kJT) * kRows + rg + 8 * i) * kJT + col % kJT] = acc[i][j];
    }
  }
  __syncthreads();
  return gates;
}

template <typename T, typename R>
__device__ __forceinline__ void lstm_cell_tile(const CellStepT<T, R>& s) {
  // Two stages of {A, B} tiles; reused for the gate sums after the loop.
  __shared__ __align__(128) bf16 smem[kCellSmem];
  static_assert(2 * kStageF * sizeof(float) <= sizeof(smem), "float32 stages fit");
  const float* gates;
  if constexpr (std::is_same<T, float>::value) {
    gates = cell_products_f32(reinterpret_cast<float*>(smem), s);
  } else {
    gates = cell_products(smem, s);
  }

  const int j0 = blockIdx.x * kJT;
  const int row0 = blockIdx.y * kRows;
  const int rows = min(kMaxMT, (s.Bp - row0) / 16) * 16;
  const int H = s.H;
  const int ld = 4 * H;
  for (int idx = threadIdx.x; idx < rows * kJT; idx += kThreads) {
    const int r = idx / kJT;
    const int jj = idx % kJT;
    const int b = row0 + r;
    if (b >= s.B) continue;
    const int j = j0 + jj;
    float gi = gates[(0 * kRows + r) * kJT + jj];
    float gg = gates[(1 * kRows + r) * kJT + jj];
    float gf = gates[(2 * kRows + r) * kJT + jj];
    float go = gates[(3 * kRows + r) * kJT + jj];
    if (s.xp != nullptr) {
      const float* x = s.xp + (size_t)b * ld;
      gi += x[j];
      gg += x[H + j];
      gf += x[2 * H + j];
      go += x[3 * H + j];
    }
    if (s.xp_res != nullptr) {
      const R* x = s.xp_res + (size_t)b * ld;
      gi += to_f(x[j]);
      gg += to_f(x[H + j]);
      gf += to_f(x[2 * H + j]);
      go += to_f(x[3 * H + j]);
    }
    if (s.bias != nullptr) {
      gi += s.bias[j];
      gg += s.bias[H + j];
      gf += s.bias[2 * H + j];
      go += s.bias[3 * H + j];
    }
    const size_t e = (size_t)b * H + j;
    const float c_old = s.c[e];
    const float h_old = s.h[e];
    const float i_a = sigmoidf_(gi), g_a = tanhf(gg);
    const float f_a = sigmoidf_(gf + 1.0f), o_a = sigmoidf_(go);
    const float c_new = f_a * c_old + i_a * g_a;
    const float h_new = o_a * tanhf(c_new);
    const float m = s.mask[b];
    const float c_sel = m * c_new + (1.0f - m) * c_old;
    const float h_sel = m * h_new + (1.0f - m) * h_old;
    s.c[e] = c_sel;
    s.h[e] = h_sel;
    s.h_out[e] = from_f<T>(h_sel);
    if (s.x_drop != nullptr) {
      const float keep =
          s.drop_mask != nullptr
              ? __bfloat162float(s.drop_mask[e])
              : (wavefront_keep(s.seed0, s.seed1, s.drop_thr, s.drop_l, s.drop_t, b, j)
                     ? 1.0f
                     : 0.0f);
      s.x_drop[e] = from_f<T>(h_sel * (keep * s.drop_scale));
    }
    if (s.out != nullptr) s.out[e] = m * h_new;
    if (s.gates_res != nullptr) {
      R* gr = s.gates_res + (size_t)b * ld;
      gr[j] = from_f<R>(i_a);
      gr[H + j] = from_f<R>(g_a);
      gr[2 * H + j] = from_f<R>(f_a);
      gr[3 * H + j] = from_f<R>(o_a);
    }
    if (s.c_res != nullptr) s.c_res[e] = from_f<R>(c_sel);
    if (s.out_res != nullptr) s.out_res[e] = from_f<R>(m * h_new);
  }
}

}  // namespace rst
