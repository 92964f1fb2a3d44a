// One LSTM layer's training forward over T steps, in both residual modes,
// for Hopper (sm_90a).
//
// Replaces two TPU kernels of rnn_speech_tpu/ops/lstm_pallas.py, which
// train one layer at a time (the layered route: wavefront off, one layer,
// remat, recompute residuals):
//
// * `_recurrence_train_kernel` (entry `_lstm_recurrence_train`, gates
//   mode): given x_proj = x·W_x + b (T, B, 4H) f32 it walks the T steps
//   with W_h and stores, per step, the masked output (f32), the activated
//   gates (i, g, f, o) = (sig(i), tanh(g), sig(f + 1), sig(o)) and the
//   carried c, both in bf16;
// * `_recurrence_train_lean_kernel` (entry `_lstm_recurrence_train_lean`,
//   recompute mode): x_proj arrives in bf16, the residual dtype, and only
//   the carried c is stored; the backward rebuilds the gates.
//
// Both are the inference recurrence (lstm_recurrence.cu) plus the
// residual stores of the cell (lstm_cell.cuh): each block owns all four
// gates of 16 hidden units, so the cell update and the stores need no
// second pass.
//
// What bounds it on the H100: per step a (B, H)·(H, 4H) product that
// depends on the previous step.  At the flagship train shape (H=1024,
// B=64, T=3510) one layer is 1.9 TFLOP, 1.9 ms at the bf16 tensor rate,
// against 7 GB of x_proj reads and residual stores in gates mode (2.1 ms
// at 3.35 TB/s).  In practice the serial chain of T steps, each a few
// microseconds of dependent K chunks per block, is the limit.
//
// What this design does about it: one launch per step, all T from one
// host call, double-buffered cp.async staging of 64-wide K chunks.  Both
// modes run, at the shapes `lean_plan` (ops/lstm_recurrence.py) sends
// there, on the persistent kernel of csrc/lstm_layer_lean.cu instead (W_h
// resident, wgmma, one grid barrier a step; the gates mode with
// `x_f32=True`); the entries below serve the shapes it does not take.

#include "lstm_cell.cuh"

namespace {

using rst::bf16;

__global__ void __launch_bounds__(rst::kThreads)
    layer_train_step(const float* xp_t, const bf16* xpb_t, const bf16* w_h,
                     const float* mask_t, const bf16* h_in, bf16* h_out, float* h,
                     float* c, float* out_t, bf16* gates_t, bf16* c_t, int B, int Bp,
                     int H) {
  rst::CellStep s;
  s.xp = xp_t;
  s.xp_bf = xpb_t;
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
  s.gates_res = gates_t;
  s.c_res = c_t;
  rst::lstm_cell_tile(s);
}

// x_proj f32 (gates mode) or bf16 (lean): (T, B, 4H); the other null.
int launch(const float* xp, const bf16* xpb, const void* w_h, const float* mask,
           void* hb, float* h, float* c, float* out, void* gates, void* cseq, int T,
           int B, int H, void* stream) {
  const int Bp = (B + 15) / 16 * 16;
  const dim3 grid(H / rst::kJT, (Bp + rst::kRows - 1) / rst::kRows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bf16* buf = static_cast<bf16*>(hb);
  bf16* g = static_cast<bf16*>(gates);
  bf16* cs = static_cast<bf16*>(cseq);
  const size_t plane = (size_t)Bp * H;
  const size_t x_step = (size_t)B * 4 * H, h_step = (size_t)B * H;
  for (int t = 0; t < T; ++t) {
    layer_train_step<<<grid, rst::kThreads, 0, st>>>(
        xp != nullptr ? xp + t * x_step : nullptr,
        xpb != nullptr ? xpb + t * x_step : nullptr, static_cast<const bf16*>(w_h),
        mask + (size_t)t * B, buf + (size_t)(t & 1) * plane,
        buf + (size_t)((t + 1) & 1) * plane, h, c, out + t * h_step,
        g != nullptr ? g + t * x_step : nullptr, cs + t * h_step, B, Bp, H);
    if (t == 0) {
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Gates mode.  x_proj (T, B, 4H) f32; w_h (H, 4H) bf16; mask (T, B) f32
// {0, 1}; hb (2, Bp, H) bf16 with hb[0] = bf16(h0) and padded rows zero;
// h, c (B, H) f32 holding h0, c0 on entry and hn, cn on return; out
// (T, B, H) f32; gates (T, B, 4H) and cseq (T, B, H) bf16 residuals.
// Bp = B rounded up to 16; H a multiple of 64.
// Returns the CUDA error code of the launches (0 = success).
extern "C" int rst_lstm_layer_train(const float* x_proj, const void* w_h,
                                    const float* mask, void* hb, float* h, float* c,
                                    float* out, void* gates, void* cseq, int T, int B,
                                    int H, void* stream) {
  return launch(x_proj, nullptr, w_h, mask, hb, h, c, out, gates, cseq, T, B, H,
                stream);
}

// Recompute mode: as above with x_proj (T, B, 4H) bf16 and no gates.
extern "C" int rst_lstm_layer_train_lean(const void* x_proj, const void* w_h,
                                         const float* mask, void* hb, float* h,
                                         float* c, float* out, void* cseq, int T, int B,
                                         int H, void* stream) {
  return launch(nullptr, static_cast<const bf16*>(x_proj), w_h, mask, hb, h, c, out,
                nullptr, cseq, T, B, H, stream);
}
