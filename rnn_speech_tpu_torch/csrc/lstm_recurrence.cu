// One LSTM layer's inference recurrence over T steps, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_recurrence_kernel` of
// rnn_speech_tpu/ops/lstm_pallas.py (entry `lstm_recurrence_pallas`): the
// layered stack's per-layer recurrence, run when the wavefront kernel is
// off or the stack has one layer.  Given x_proj = x·W_x + b for all steps,
// it walks t = 0..T-1 with W_h, carrying (h, c) and freezing rows past
// their length.
//
// What bounds it on the H100: each step is a (B, H)·(H, 4H) product that
// depends on the previous step, so the T steps are a serial chain.  At the
// serving shape (B=128, H=1024) one step is 1.07 GFLOP against 8 MiB of
// bf16 W_h: far too little work per step to fill the card's tensor cores,
// and W_h is re-read every step (from the 50 MB L2, where it stays
// resident).  The chain's latency, launch overhead included, is the limit,
// not the card's peak rate or its memory bandwidth.
//
// What this design does about it: one launch per step, all T launched by
// one host call on the caller's stream, so Python pays one call per layer.
// Every block computes all four gates of its 16 hidden units
// (lstm_cell.cuh), so the cell update needs no second pass, and it stages
// 64-wide K chunks of h and of its W_h columns through shared memory with
// double-buffered cp.async copies, so each fragment leaves L2 once per
// block and the copies overlap the MMAs.  A persistent kernel that keeps
// W_h in shared memory and replaces the launches by grid-wide barriers is
// later work.

#include "lstm_cell.cuh"

namespace {

__global__ void __launch_bounds__(rst::kThreads)
    recurrence_step(const float* xp_t, const rst::bf16* w_h, const float* mask_t,
                    const rst::bf16* h_in, rst::bf16* h_out, float* h, float* c,
                    float* out_t, int B, int Bp, int H) {
  rst::CellStep s;
  s.xp = xp_t;
  s.bias = nullptr;
  s.x_in = nullptr;
  s.w_x = nullptr;
  s.h_in = h_in;
  s.w_h = w_h;
  s.mask = mask_t;
  s.h_out = h_out;
  s.h = h;
  s.c = c;
  s.out = out_t;
  s.B = B;
  s.Bp = Bp;
  s.H = H;
  rst::lstm_cell_tile(s);
}

}  // namespace

// x_proj (T, B, 4H) f32; w_h (H, 4H) bf16; mask (T, B) f32 {0, 1};
// hb (2, Bp, H) bf16 with hb[0] = bf16(h0) and padded rows zero;
// h, c (B, H) f32 holding h0, c0 on entry and hn, cn on return;
// out (T, B, H) f32.  Bp = B rounded up to 16; H a multiple of 64.
// Returns the CUDA error code of the launches (0 = success).
extern "C" int rst_lstm_recurrence(const float* x_proj, const void* w_h,
                                   const float* mask, void* hb, float* h, float* c,
                                   float* out, int T, int B, int H, void* stream) {
  const int Bp = (B + 15) / 16 * 16;
  const int rows_per_block = rst::kMaxMT * 16;
  const dim3 grid(H / rst::kJT, (Bp + rows_per_block - 1) / rows_per_block);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const rst::bf16* w = static_cast<const rst::bf16*>(w_h);
  rst::bf16* buf = static_cast<rst::bf16*>(hb);
  const size_t plane = (size_t)Bp * H;
  for (int t = 0; t < T; ++t) {
    recurrence_step<<<grid, rst::kThreads, 0, st>>>(
        x_proj + (size_t)t * B * 4 * H, w, mask + (size_t)t * B,
        buf + (size_t)(t & 1) * plane, buf + (size_t)((t + 1) & 1) * plane, h, c,
        out + (size_t)t * B * H, B, Bp, H);
    if (t == 0) {
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
  }
  return (int)cudaGetLastError();
}
