// The window products of the fused dW_x (the TPU kernel's `fuse_dwx` mode
// of `_wavefront_bwd_kernel`, rnn_speech_tpu/ops/lstm_wavefront.py), shared
// by both reverse diagonals: the per-diagonal kernel
// (csrc/lstm_wavefront_bwd.cu) and the persistent one
// (csrc/lstm_wavefront_bwd_persistent.cu).  The reverse pass runs in
// windows of W diagonals; after each window one product per boundary l
// adds the window's steps of
//
//   dW_x,l+1 += bf16(outs_l(t)·keep·scale)ᵀ · dgates_{l+1}(t)
//
// into the (L-1, H, 4H) f32 dW_x, K = (steps)·B rows, with a tile product
// of grad_matmul.cuh in accumulate mode.  Diagonal s runs layer l at step
// t = T-1 - (s - (L-1-l)).  In drop mode 2 the pass writes xdrop_l(t) into
// slot W-1-(s mod W) of a ring (L-1, W, B, H): slot j of boundary l holds
// step t_base + j, ascending in t like the gates residual; in drop mode 0
// the A operand is the outs residual itself.  Each output element has one
// owner block and the launches share the stream, so the sums repeat bit
// for bit and a ring slot is read before the next window writes it.
#pragma once

#include <algorithm>

#include "bounds_check.cuh"
#include "grad_matmul.cuh"

namespace rst_dwx {

using bf16 = __nv_bfloat16;

// The products of the window of diagonals [s0, s1] (W wide): per boundary
// l, the steps t whose dropped input layer l produced in the window, from
// `ring` (drop mode 2) or `outs` (L, T, B, H) (ring null, mode 0), times
// layer l+1's dgates (over the (L, T, B, 4H) gates residual), added into
// dwx[l] by the product on `path` (rst_grad::Path).  Adds the products
// launched on the Hopper tile to `products`.  Returns the CUDA error code.
inline int accumulate(const bf16* outs, const bf16* ring, const bf16* dgates, int T, int B,
                      int H, int L, int s0, int s1, int W, int path, float* dwx,
                      long long& products, cudaStream_t st) {
  const int G = 4 * H;
  for (int l = 0; l + 1 < L; ++l) {
    const int off = L - 1 - l;
    const int t_lo = std::max(0, T - 1 - s1 + off), t_hi = std::min(T - 1, T - 1 - s0 + off);
    if (t_lo > t_hi) continue;
    const int n = (t_hi - t_lo + 1) * B;
    const int slot = t_lo - (T - W + off - s0);  // ring slot of step t_lo
    if (ring != nullptr) {
      RST_CHECK(slot, W);
      RST_CHECK(slot + t_hi - t_lo, W);
    }
    RST_CHECK((l + 1) * (long long)T + t_hi, (long long)L * T);
    const bf16* a = ring != nullptr ? ring + ((size_t)l * W + slot) * B * H
                                    : outs + ((size_t)l * T + t_lo) * B * H;
    const bf16* dg = dgates + ((size_t)(l + 1) * T + t_lo) * B * G;
    const int err = rst_grad::launch(path, a, H, nullptr, 0, dg, 0, n, G, 1, n, nullptr,
                                     nullptr, dwx + (size_t)l * H * G, nullptr, 1, st);
    if (err != 0) return err;
    products += path == rst_grad::kWgmma;
  }
  return 0;
}

}  // namespace rst_dwx
