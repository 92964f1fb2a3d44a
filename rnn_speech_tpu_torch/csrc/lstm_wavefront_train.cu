// Whole-stack LSTM training forward on the (layer, time) diagonal, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel `_wavefront_train_kernel` of
// rnn_speech_tpu/ops/lstm_wavefront.py (entry `_wavefront_train`, drop
// modes 0, 1 and 2): diagonal s runs every layer l with 0 <= t = s - l < T at its
// step t.  Unlike the inference kernel, layer 0 applies its own input
// product b_0 + bf16(x[t])·W_x0 in-kernel, so no (T, B, 4H) f32
// projection of the input exists in device memory; layers l >= 1 apply
// b_l + bf16(h^{l-1})·W_x,l from the lower layer's CARRIED h.  Every step
// stores the backward's residuals in bf16: activated gates (T, B, 4H),
// carried c (T, B, H) and masked output (T, B, H) per layer.
//
// Inter-layer dropout: layer l >= 1 reads x_in = bf16(h^{l-1}·keep·scale)
// with keep from explicit masks (mode 1) or regenerated from two seed
// words for (boundary l-1, t) (mode 2, csrc/philox.cuh).  The producing
// layer writes that dropped copy next to its bf16 h, from its float32 h,
// into a (2, L-1, Bp, H) buffer by diagonal parity; the outs residual
// stays the undropped masked output.
//
// As in the inference kernel (lstm_wavefront.cu), GPU blocks run in no
// order, so the bf16 copies of h that the products read live in two
// (L, Bp, H) buffers by diagonal parity; the f32 carries (h, c) are
// updated in place by their one owner thread and hold hn, cn at the end.
// x arrives padded to Bp = 16·ceil(B/16) rows per step, because the cell
// reads whole 16-row tiles of its A operands.
//
// What bounds it on the H100: 2·T·B·H·4H·2L operations, 11.3 TFLOP at the
// flagship train shape (L=3, H=1024, B=64, T=3510), 11.4 ms at the bf16
// tensor rate, against 8.7 GB of residual stores and inputs.  In practice
// the serial chain of T + L - 1 diagonals, each a few microseconds of
// dependent K chunks per block, is the limit, as for the inference kernel.
//
// What this design does about it: one launch per diagonal with every
// layer's blocks in it (grid z = layer), all from one host call, and the
// four-gate tiles of lstm_cell.cuh with double-buffered cp.async staging.
// At the shapes `wavefront_plan` (ops/lstm_wavefront.py) sends there (the
// default step's B <= 64 at H = D = 1024) the persistent kernel of
// csrc/lstm_wavefront_persistent.cu runs instead (W_h resident, the layers
// paced by counters); this one serves the others (the wide step).

#include "lstm_cell.cuh"

namespace {

// Inter-layer dropout (drop modes 1, 2; mode 0 has xb == nullptr).
struct Drop {
  const rst::bf16* masks;  // (L-1, T, B, H) {0, 1} (mode 1), or null (mode 2)
  rst::bf16* xb;           // (2, L-1, Bp, H) dropped copies by diagonal parity
  unsigned seed0, seed1, thr;
  float scale;
};

__global__ void __launch_bounds__(rst::kThreads)
    wavefront_train_step(int s, const rst::bf16* x, const rst::bf16* w_x0,
                         const rst::bf16* w_h, const rst::bf16* w_x, const float* bias,
                         const float* mask, rst::bf16* hb, float* h, float* c,
                         rst::bf16* outs, rst::bf16* gates, rst::bf16* cseq, int T,
                         int B, int Bp, int H, int D, int L, Drop drop) {
  const int l = blockIdx.z;
  const int t = s - l;
  if (t < 0 || t >= T) return;  // uniform over the block
  const size_t plane = (size_t)Bp * H;
  const size_t wsize = (size_t)H * 4 * H;
  const size_t step = ((size_t)l * T + t) * B;  // first row of (l, t) in a stream
  const int par = s & 1;
  rst::CellStep st;
  st.xp = nullptr;
  st.bias = bias + (size_t)l * 4 * H;
  if (l == 0) {
    st.x_in = x + (size_t)t * Bp * D;
  } else if (drop.xb != nullptr) {  // the lower layer's dropped copy
    st.x_in = drop.xb + (size_t)(par * (L - 1) + l - 1) * plane;
  } else {
    st.x_in = hb + (size_t)(par * L + l - 1) * plane;
  }
  st.Kx = l == 0 ? D : H;
  st.w_x = l == 0 ? w_x0 : w_x + (size_t)(l - 1) * wsize;
  st.h_in = hb + (size_t)(par * L + l) * plane;
  st.w_h = w_h + (size_t)l * wsize;
  st.mask = mask + (size_t)t * B;
  st.h_out = hb + (size_t)((par ^ 1) * L + l) * plane;
  st.h = h + (size_t)l * B * H;
  st.c = c + (size_t)l * B * H;
  st.out = nullptr;
  st.gates_res = gates + step * 4 * H;
  st.c_res = cseq + step * H;
  st.out_res = outs + step * H;
  if (drop.xb != nullptr && l < L - 1) {  // this layer feeds boundary l
    st.x_drop = drop.xb + (size_t)((par ^ 1) * (L - 1) + l) * plane;
    st.drop_mask = drop.masks != nullptr
                       ? drop.masks + ((size_t)l * T + t) * B * H
                       : nullptr;
    st.seed0 = drop.seed0;
    st.seed1 = drop.seed1;
    st.drop_thr = drop.thr;
    st.drop_l = l;
    st.drop_t = t;
    st.drop_scale = drop.scale;
  }
  st.B = B;
  st.Bp = Bp;
  st.H = H;
  rst::lstm_cell_tile(st);
}

}  // namespace

// x (T, Bp, D) bf16 with rows >= B zero; w_x0 (D, 4H), w_h (L, H, 4H),
// w_x (L-1, H, 4H) bf16; bias (L, 4H) f32; mask (T, B) f32 {0, 1};
// hb (2, L, Bp, H) bf16 with both parities = bf16(h0) and padded rows zero;
// h, c (L, B, H) f32 holding h0, c0 on entry and hn, cn on return;
// outs, cseq (L, T, B, H) and gates (L, T, B, 4H) bf16 residual streams.
// Dropout: drop_mode 0 (none; xb, masks unused), 1 (masks (L-1, T, B, H)
// bf16 {0, 1}) or 2 (Philox bits of (seed0, seed1) under threshold thr);
// xb (2, L-1, Bp, H) bf16 scratch with padded rows zero; scale = 1/keep.
// Bp = B rounded up to 16; H and D multiples of 64.
// Returns the CUDA error code of the launches (0 = success).
extern "C" int rst_lstm_wavefront_train(const void* x, const void* w_x0, const void* w_h,
                                        const void* w_x, const float* bias,
                                        const float* mask, void* hb, float* h, float* c,
                                        void* outs, void* gates, void* cseq, int T, int B,
                                        int H, int D, int L, int drop_mode,
                                        const void* masks, void* xb, unsigned seed0,
                                        unsigned seed1, unsigned thr, float scale,
                                        void* stream) {
  using rst::bf16;
  const int Bp = (B + 15) / 16 * 16;
  const dim3 grid(H / rst::kJT, (Bp + rst::kRows - 1) / rst::kRows, L);
  Drop drop;
  drop.masks = drop_mode == 1 ? static_cast<const bf16*>(masks) : nullptr;
  drop.xb = drop_mode != 0 ? static_cast<bf16*>(xb) : nullptr;
  drop.seed0 = seed0;
  drop.seed1 = seed1;
  drop.thr = thr;
  drop.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int s = 0; s < T + L - 1; ++s) {
    wavefront_train_step<<<grid, rst::kThreads, 0, st>>>(
        s, static_cast<const bf16*>(x), static_cast<const bf16*>(w_x0),
        static_cast<const bf16*>(w_h), static_cast<const bf16*>(w_x), bias, mask,
        static_cast<bf16*>(hb), h, c, static_cast<bf16*>(outs),
        static_cast<bf16*>(gates), static_cast<bf16*>(cseq), T, B, Bp, H, D, L, drop);
    if (s == 0) {
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
  }
  return (int)cudaGetLastError();
}
