// Whole-stack LSTM inference on the (layer, time) diagonal, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `_wavefront_kernel` of
// rnn_speech_tpu/ops/lstm_wavefront.py (entry `lstm_stack_wavefront`):
// diagonal s runs every layer l with 0 <= t = s - l < T at its step t.
// Layer 0 adds the precomputed xp0 = x·W_x0 + b0; layers l >= 1 apply
// their own input product b_l + bf16(h^{l-1})·W_x,l in-kernel, so the
// inter-layer activations never go to device memory.  The input of layer
// l is the lower layer's CARRIED state h^{l-1} (equal to its masked
// output except on padded steps), as in the TPU kernel.
//
// The one difference forced by the card: the TPU grid runs in order, so
// the TPU kernel walks the layers of a diagonal in descending order and
// each reads the lower layer's h before it is overwritten.  GPU blocks run
// in parallel, so the bf16 copies of h live in two (L, Bp, H) buffers by
// diagonal parity: diagonal s reads parity s%2 and writes (s+1)%2.  Rows
// frozen by the mask copy their state across.  The f32 carries (h, c) are
// updated in place (each element has one owner thread) and hold hn, cn at
// the end, since no row changes after t = T-1.
//
// What bounds it on the H100: per diagonal the L layer products are
// independent, so one launch carries L times the work of a layered step,
// but the T + L - 1 diagonals are still a serial chain.  At the serving
// shape (L=3, B=128, H=1024) a diagonal is 5.4 GFLOP against 40 MiB of
// bf16 W_h and W_x, which fit together in the 50 MB L2; the chain's
// latency, launch overhead included, is the limit rather than the card's
// peak tensor rate.
//
// What this design does about it: one launch per diagonal with every
// layer's blocks in it (grid z = layer), all launched by one host call on
// the caller's stream, and the four-gate tiles of lstm_cell.cuh, which
// stage 64-wide K chunks of h and W through shared memory with
// double-buffered cp.async copies.  The persistent kernel of
// csrc/lstm_wavefront_eval.cu runs the bf16 shapes `wavefront_eval_plan`
// sends it (ops/lstm_wavefront.py); this one the others.
//
// Float32 compute (entry rst_lstm_wavefront_f32; the JAX kernel's
// compute_dtype=float32): the same launches on float32 weights and h
// buffers, through the cell's float32 SIMT product (lstm_cell.cuh); every
// float32 shape runs here.

#include "lstm_cell.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(rst::kThreads)
    wavefront_step(int s, const float* xp0, const T* w_h, const T* w_x, const float* bias,
                   const float* mask, T* hb, float* h, float* c, float* out, int T_, int B,
                   int Bp, int H, int L) {
  const int l = blockIdx.z;
  const int t = s - l;
  if (t < 0 || t >= T_) return;  // uniform over the block
  const size_t plane = (size_t)Bp * H;
  const size_t wsize = (size_t)H * 4 * H;
  const int par = s & 1;
  rst::CellStepT<T> st;
  st.xp = l == 0 ? xp0 + (size_t)t * B * 4 * H : nullptr;
  st.bias = l > 0 ? bias + (size_t)(l - 1) * 4 * H : nullptr;
  st.x_in = l > 0 ? hb + (size_t)(par * L + l - 1) * plane : nullptr;
  st.w_x = l > 0 ? w_x + (size_t)(l - 1) * wsize : nullptr;
  st.h_in = hb + (size_t)(par * L + l) * plane;
  st.w_h = w_h + (size_t)l * wsize;
  st.mask = mask + (size_t)t * B;
  st.h_out = hb + (size_t)((par ^ 1) * L + l) * plane;
  st.h = h + (size_t)l * B * H;
  st.c = c + (size_t)l * B * H;
  st.out = l == L - 1 ? out + (size_t)t * B * H : nullptr;
  st.B = B;
  st.Bp = Bp;
  st.H = H;
  rst::lstm_cell_tile(st);
}

template <typename T>
int launch(const float* xp0, const void* w_h, const void* w_x, const float* bias,
           const float* mask, void* hb, float* h, float* c, float* out, int T_, int B, int H,
           int L, void* stream) {
  const int Bp = (B + 15) / 16 * 16;
  const int rows_per_block = rst::kMaxMT * 16;
  const dim3 grid(H / rst::kJT, (Bp + rows_per_block - 1) / rows_per_block, L);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int s = 0; s < T_ + L - 1; ++s) {
    wavefront_step<T><<<grid, rst::kThreads, 0, st>>>(
        s, xp0, static_cast<const T*>(w_h), static_cast<const T*>(w_x), bias, mask,
        static_cast<T*>(hb), h, c, out, T_, B, Bp, H, L);
    if (s == 0) {
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace

// xp0 (T, B, 4H) f32; w_h (L, H, 4H) bf16; w_x (L-1, H, 4H) bf16;
// bias (L-1, 4H) f32; mask (T, B) f32 {0, 1};
// hb (2, L, Bp, H) bf16 with both parities = bf16(h0) and padded rows zero;
// h, c (L, B, H) f32 holding h0, c0 on entry and hn, cn on return;
// out (T, B, H) f32, the top layer's masked outputs.
// Bp = B rounded up to 16; H a multiple of 64.
// Returns the CUDA error code of the launches (0 = success).
extern "C" int rst_lstm_wavefront(const float* xp0, const void* w_h, const void* w_x,
                                  const float* bias, const float* mask, void* hb,
                                  float* h, float* c, float* out, int T, int B, int H,
                                  int L, void* stream) {
  return launch<rst::bf16>(xp0, w_h, w_x, bias, mask, hb, h, c, out, T, B, H, L, stream);
}

// Float32 compute: as above with w_h, w_x and hb float32.
extern "C" int rst_lstm_wavefront_f32(const float* xp0, const void* w_h, const void* w_x,
                                      const float* bias, const float* mask, void* hb,
                                      float* h, float* c, float* out, int T, int B, int H,
                                      int L, void* stream) {
  return launch<float>(xp0, w_h, w_x, bias, mask, hb, h, c, out, T, B, H, L, stream);
}
