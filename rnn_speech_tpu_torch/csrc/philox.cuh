// Counter-based random bits for dropout: Philox4x32-10 (Salmon et al.,
// SC 2011), keyed on two 32-bit seed words.  Mirrored bit for bit by
// rnn_speech_tpu_torch/ops/random_bits.py, which states the counter
// layouts: every counter is built from an element's logical coordinates,
// never from a block or thread id, so kernels that tile differently (the
// wavefront forward and backward, a dropout and its backward) draw the
// same bits.  An element is kept iff its word < threshold =
// min(round(keep·2^32), 2^32 - 1), computed on the host.
#pragma once

#include <cstdint>

namespace rst {

struct Words4 {
  uint32_t w[4];
};

__device__ __forceinline__ Words4 philox4x32_10(uint32_t c0, uint32_t c1, uint32_t c2,
                                                uint32_t c3, uint32_t k0, uint32_t k1) {
  constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
  constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += kW0;
      k1 += kW1;
    }
    const uint32_t hi0 = __umulhi(kM0, c0), lo0 = kM0 * c0;
    const uint32_t hi1 = __umulhi(kM1, c2), lo1 = kM1 * c2;
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
  }
  return Words4{{c0, c1, c2, c3}};
}

// Word i (0..3) of w, selected without an indexed (local-memory) load.
__device__ __forceinline__ uint32_t word(const Words4& w, int i) {
  return (i & 2) ? ((i & 1) ? w.w[3] : w.w[2]) : ((i & 1) ? w.w[1] : w.w[0]);
}

// The wavefront's keep bit of inter-layer boundary l at step t, row b,
// unit j: counter (j >> 2, b, t, l), word j & 3.
__device__ __forceinline__ bool wavefront_keep(uint32_t k0, uint32_t k1, uint32_t thr,
                                               int l, int t, int b, int j) {
  const Words4 w = philox4x32_10((uint32_t)j >> 2, (uint32_t)b, (uint32_t)t,
                                 (uint32_t)l, k0, k1);
  return word(w, j & 3) < thr;
}

}  // namespace rst
