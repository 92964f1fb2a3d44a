// One LSTM timestep for one tile of hidden units: the cell both inference
// kernels share (lstm_recurrence.cu, lstm_wavefront.cu).
//
// A block owns kJT = 16 hidden units j0..j0+15 and up to kMaxMT 16-row
// batch tiles (64 rows).  Its four warps compute the four gate columns of
// those units (warp g -> columns g*H + j0 .. g*H + j0 + 15; gate order
// i, g, f, o) with bf16 WMMA 16x16x16 tiles and f32 accumulation, so all
// four gates of a (row, unit) pair meet in the block's shared memory and
// the cell update stays local: no gate pre-activation goes to device
// memory.
//
//   gates = [xp | b + bf16(x_in)·W_x] + bf16(h_in)·W_h
//   c' = sigmoid(f + 1)·c + sigmoid(i)·tanh(g);  h' = sigmoid(o)·tanh(c')
//   c, h <- m·(c', h') + (1 - m)·(c, h);  out <- m·h'
//
// The product walks K in chunks of kKC = 64.  Each chunk of the block's
// A rows (bf16 h) and of its 64 weight columns is copied to shared memory
// with 16-byte cp.async copies, double-buffered, so the next chunk's
// copies overlap this chunk's MMAs and every fragment is read from device
// memory (in practice L2) once per block.  The W_x product (layers >= 1 of
// the wavefront) continues the same chunk sequence after W_h.
//
// The bf16 copy of h that feeds the next step's product is written to a
// separate buffer (the caller ping-pongs two), because every block reads
// all H columns of it; the f32 carries h and c are read and written by the
// same thread only, so they are updated in place.  Batch rows are padded
// to a multiple of 16 in the bf16 buffers; padded rows are never written
// and never read back into a real row (a product row depends only on its
// own A row).  H must be a multiple of kKC.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace rst {

using bf16 = __nv_bfloat16;

constexpr int kJT = 16;             // hidden units per block
constexpr int kMaxMT = 4;           // 16-row batch tiles per block (64 rows)
constexpr int kRows = kMaxMT * 16;  // batch rows per block
constexpr int kThreads = 128;       // four warps, one per gate
constexpr int kKC = 64;             // K chunk staged in shared memory
constexpr int kLd = kKC + 8;        // padded shared row (bf16), A and B tiles
constexpr int kTile = kRows * kLd;  // elements of one staged 64x64 tile

struct CellStep {
  const float* xp;     // (B, 4H) input pre-activations of this step, or null
  const float* bias;   // (4H) input bias, or null
  const bf16* x_in;    // (Bp, H) bf16 input (lower layer's h), or null
  const bf16* w_x;     // (H, 4H) input weights, or null
  const bf16* h_in;    // (Bp, H) bf16 recurrent h
  const bf16* w_h;     // (H, 4H) recurrent weights
  const float* mask;   // (B) validity of this step, {0, 1}
  bf16* h_out;         // (Bp, H) bf16 h after this step
  float* h;            // (B, H) f32 carried h, in place
  float* c;            // (B, H) f32 carried c, in place
  float* out;          // (B, H) masked output of this step, or null
  int B, Bp, H;
};

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

// Stage K rows [k0, k0 + kKC) of A (rows x H, row-major, first row of the
// block) and of the block's 64 weight columns (4 gates x 16) of W (H x 4H).
__device__ __forceinline__ void stage_chunk(bf16* As, bf16* Bs, const bf16* a,
                                           const bf16* w, int k0, int rows, int H,
                                           int j0) {
  for (int i = threadIdx.x; i < rows * (kKC / 8); i += kThreads) {
    const int r = i / (kKC / 8), p = i % (kKC / 8);
    cp_async16(As + r * kLd + p * 8, a + (size_t)r * H + k0 + p * 8);
  }
  for (int i = threadIdx.x; i < kKC * 8; i += kThreads) {
    const int kr = i / 8, q = i % 8, g = q / 2, p = q % 2;
    cp_async16(Bs + kr * kLd + g * kJT + p * 8,
               w + (size_t)(k0 + kr) * 4 * H + (size_t)g * H + j0 + p * 8);
  }
}

__device__ __forceinline__ float sigmoidf_(float x) { return 1.0f / (1.0f + expf(-x)); }

// Grid: x = H / kJT unit tiles, y = batch tiles of kRows rows.
__device__ __forceinline__ void lstm_cell_tile(const CellStep& s) {
  using namespace nvcuda;
  // Two stages of {A, B} tiles; reused for the gate sums after the loop.
  __shared__ __align__(128) bf16 smem[2 * 2 * kTile];

  const int warp = threadIdx.x / 32;  // the gate this warp computes
  const int j0 = blockIdx.x * kJT;
  const int row0 = blockIdx.y * kRows;
  const int n_mt = min(kMaxMT, (s.Bp - row0) / 16);
  const int rows = n_mt * 16;
  const int H = s.H;
  const int n_h = H / kKC;
  const int n_chunks = s.x_in != nullptr ? 2 * n_h : n_h;

  auto stage = [&](int c) {
    bf16* As = smem + (c & 1) * 2 * kTile;
    const bool rec = c < n_h;
    const bf16* a = (rec ? s.h_in : s.x_in) + (size_t)row0 * H;
    stage_chunk(As, As + kTile, a, rec ? s.w_h : s.w_x, (rec ? c : c - n_h) * kKC,
                rows, H, j0);
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
    if (s.bias != nullptr) {
      gi += s.bias[j];
      gg += s.bias[H + j];
      gf += s.bias[2 * H + j];
      go += s.bias[3 * H + j];
    }
    const size_t e = (size_t)b * H + j;
    const float c_old = s.c[e];
    const float h_old = s.h[e];
    const float c_new = sigmoidf_(gf + 1.0f) * c_old + sigmoidf_(gi) * tanhf(gg);
    const float h_new = sigmoidf_(go) * tanhf(c_new);
    const float m = s.mask[b];
    const float c_sel = m * c_new + (1.0f - m) * c_old;
    const float h_sel = m * h_new + (1.0f - m) * h_old;
    s.c[e] = c_sel;
    s.h[e] = h_sel;
    s.h_out[e] = __float2bfloat16(h_sel);
    if (s.out != nullptr) s.out[e] = m * h_new;
  }
}

}  // namespace rst
