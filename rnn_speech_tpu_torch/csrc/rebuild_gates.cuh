// The recompute backward's gate rebuild, for Hopper (sm_90a): for the rows
// (t, b) of a chunk of steps, the activated gates in float32
//
//   pre = bf16(x)·W_x + bf16(h_prev)·W_h + b      (C·B, D + H) x (D + H, 4H)
//   act = [σ(pre_i) | tanh(pre_g) | σ(pre_f + 1) | σ(pre_o)]
//
// which the TPU kernel `_recurrence_bwd_recompute_kernel`
// (rnn_speech_tpu/ops/lstm_pallas.py) forms inside each reverse step.  The
// products depend only on the residuals x and h_prev, never on the reverse
// carry, so lstm_layer_bwd.cu runs them here, one large product per chunk
// of steps ahead of the chunk's serial chain, instead of two (B, K) x
// (K, 4H) products inside every step.
//
// What bounds it on the H100: 2·rows·(D + H)·4H operations against
// rows·(D + H) bf16 in and rows·4H float32 out: at D = H = 1024 about 300
// operations a byte, the tensor-core rate (989 TFLOP/s).
//
// What this design does about it: the weight-gradient product's Hopper
// tile (grad_matmul.cuh, `tma::tile_loop`): 128x256 output tiles, one producer
// thread keeping TMA loads of 64-deep K stages in flight through a
// four-stage ring of 48 KiB with full and empty mbarriers, two consumer
// warpgroups each running wgmma m64n256k16 into a 64x256 f32 accumulator.
// Here A (the x and h_prev rows) is K-major (row-major (rows, K), 64x64
// boxes in 128-byte swizzle, K stepped by 32 bytes inside the swizzle
// atom) and B (W_x, W_h: row-major (K, 4H)) is MN-major as the
// weight-gradient tile's dg.  K walks D from the x and W_x
// tensor maps, then H from the h_prev and W_h maps, so x and h_prev are
// never concatenated; rows past the last step are zero-filled by TMA, so
// no batch padding is copied.  The epilogue adds the bias and applies the
// activations with the forward cell's float32 operations (lstm_cell.cuh)
// and stores only the chunk's rows.  One owner block per output element,
// a fixed K order, no atomics: a run repeats bit for bit.
//
// Float32 compute (``launch_f32``; the JAX kernel's compute_dtype=float32
// with float32 residuals): the same rebuild from float32 x, h_prev, W_x and
// W_h on the float32 GEMM tile of f32_gemm.cuh (128x128 block tiles, 8x8
// register tiles, a cp.async ring; D and H multiples of 16, which the
// wrappers' padding to 64 gives), the activations in its epilogue.  What
// bounds it is the float32 rate (67 TFLOP/s).
#pragma once

#include "f32_gemm.cuh"
#include "grad_matmul.cuh"
#include "lstm_cell.cuh"

namespace rst_rebuild {

namespace tma = rst_grad::tma;

struct Args {
  int row0;           // first row (t·B + b) of the chunk in the tensor maps
  int rows;           // rows of the chunk: act holds rows x 4H
  int kx, kh;         // K stages of x (D / 64), then of h_prev (H / 64)
  int H;
  const float* bias;  // (4H)
  float* act;         // (rows, 4H) activated gates
};

__device__ __forceinline__ float activate(int gate, float v) {
  return gate == 1 ? tanhf(v) : rst::sigmoidf_(gate == 2 ? v + 1.0f : v);
}

// Block (x: 256-column tile of 4H, y: 128-row tile of the chunk).  The
// column tiles run fastest, so a wave of blocks shares a few row tiles of
// A and W stays in L2: A is read from device memory about once.  The main
// loop is the weight-gradient tile's (tma::tile_loop) with A K-major; the
// K stages run over D (x, W_x) and then H (h_prev, W_h) in one chain
// (launch checks that D + H fits one: kOneChain).
__global__ void __launch_bounds__(tma::kThreads, 1)
    rebuild_kernel(const __grid_constant__ CUtensorMap map_x,
                   const __grid_constant__ CUtensorMap map_h,
                   const __grid_constant__ CUtensorMap map_wx,
                   const __grid_constant__ CUtensorMap map_wh, Args p) {
  using namespace tma;
  const CUtensorMap *mx = &map_x, *mh = &map_h, *mwx = &map_wx, *mwh = &map_wh;
  const int m0 = blockIdx.y * kTM;                            // chunk-local first row
  const int n_a = min(kTM / 64, (p.rows - m0 + 63) / 64);    // 64-row halves with rows
  const int n0 = blockIdx.x * kTN;
  tile_loop<0, true>(
      n_a, 0, p.kx + p.kh,
      [=](uint32_t st, uint32_t bar, int k) {
        const bool in_x = k < p.kx;
        const int kc = (in_x ? k : k - p.kx) * kTK;
        for (int c = 0; c < n_a; ++c) {
          load_box(st + c * kStrip, in_x ? mx : mh, bar, kc, p.row0 + m0 + 64 * c);
        }
        for (int q = 0; q < kTN / 64; ++q) {
          load_box(st + (kTM / 64 + q) * kStrip, in_x ? mwx : mwh, bar, n0 + 64 * q, kc);
        }
      },
      [=](const float(&d)[128], int c, int) {
        // Register 4j + r holds row 16·warp + lane/4 + 8·(r/2), column
        // 8j + 2·(lane%4) + r%2 of this warpgroup's 64x256 tile.
        const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
        const int G = 4 * p.H;
        const int row = m0 + 64 * c + 16 * warp + lane / 4;
#pragma unroll
        for (int j = 0; j < kTN / 8; ++j) {
          const int col = n0 + 8 * j + 2 * (lane % 4);
          const int gate = col / p.H;
          const float b0 = p.bias[col], b1 = p.bias[col + 1];
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            if (row + 8 * hh < p.rows) {
              *reinterpret_cast<float2*>(p.act + (size_t)(row + 8 * hh) * G + col) =
                  make_float2(activate(gate, d[4 * j + 2 * hh] + b0),
                              activate(gate, d[4 * j + 2 * hh + 1] + b1));
            }
          }
        }
      });
}

// The four tensor maps of one layer's operands: x (rows, D) and h_prev
// (rows, H) bf16, W_x (D, 4H) and W_h (H, 4H) bf16, all row-major, in
// 64x64 boxes.
struct Maps {
  CUtensorMap x, h, wx, wh;
};

inline bool make_maps(Maps* m, const void* x, const void* h_prev, const void* w_x,
                      const void* w_h, int rows, int D, int H) {
  return tma::make_map(&m->x, x, rows, D) && tma::make_map(&m->h, h_prev, rows, H) &&
         tma::make_map(&m->wx, w_x, D, 4 * H) && tma::make_map(&m->wh, w_h, H, 4 * H);
}

// act (rows, 4H) f32 = the activated gates of map rows [row0, row0 + rows),
// on `st`.  D and H multiples of 64.  Returns the CUDA error code.
inline int launch(const Maps& m, int row0, int rows, int D, int H, const float* bias, float* act,
                  cudaStream_t st) {
  if (rows <= 0) return 0;
  if ((D + H) / tma::kTK > tma::kFlushSteps) return (int)cudaErrorInvalidValue;   // one chain
  const cudaError_t attr = cudaFuncSetAttribute(
      rebuild_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, tma::kSmemBytes);
  if (attr != cudaSuccess) return (int)attr;
  Args p;
  p.row0 = row0;
  p.rows = rows;
  p.kx = D / tma::kTK;
  p.kh = H / tma::kTK;
  p.H = H;
  p.bias = bias;
  p.act = act;
  const dim3 grid(4 * H / tma::kTN, (rows + tma::kTM - 1) / tma::kTM);
  rebuild_kernel<<<grid, tma::kThreads, tma::kSmemBytes, st>>>(m.x, m.h, m.wx, m.wh, p);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------- float32 compute

// The epilogue of the float32 rebuild: the bias and the activations, one
// output at a time.
struct ActEpi {
  float* act;         // (rows, 4H)
  const float* bias;  // (4H)
  int H;
  int rows;
  __device__ __forceinline__ void operator()(int row, int col, float v) const {
    RST_CHECK(col, 4 * H);
    RST_CHECK(row, rows);
    act[(size_t)row * 4 * H + col] = activate(col / H, v + bias[col]);
  }
};

// act (rows, 4H) f32 = the activated gates of rows [row0, row0 + rows) of
// the float32 x (·, D) and h_prev (·, H) with w_x (D, 4H), w_h (H, 4H),
// on `st`: the float32 GEMM tile of f32_gemm.cuh, K over D then H.  D and
// H multiples of 16 (the wrappers pad both to 64); x and h_prev hold
// `total_rows` rows.  ``skip_k`` K stages are left out at the end (a
// planted fault; 0).  Returns the CUDA error code.
inline int launch_f32(const float* x, const float* h_prev, const float* w_x, const float* w_h,
                      int row0, int rows, int D, int H, const float* bias, float* act,
                      cudaStream_t st, long long total_rows = 1ll << 62, int skip_k = 0) {
  rst_f32::Operands op;
  op.a1 = x;
  op.a2 = h_prev;
  op.b1 = w_x;
  op.b2 = w_h;
  op.M = rows;
  op.N = 4 * H;
  op.K1 = D;
  op.K2 = H;
  op.row0 = row0;
  op.a_rows = total_rows;
  op.skip_k = skip_k;
  return rst_f32::launch<false>(op, ActEpi{act, bias, H, rows}, st);
}

}  // namespace rst_rebuild
