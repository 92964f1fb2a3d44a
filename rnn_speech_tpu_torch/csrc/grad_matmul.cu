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
// pass over dg.  The projections run the WMMA tile.  Either splits K
// across blocks into f32 partials summed in a fixed order when there are
// too few output tiles to fill the card.

#include "grad_matmul.cuh"

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
