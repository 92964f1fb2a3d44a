// Whole-stack LSTM backward on the reverse (layer, time) diagonal, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel `_wavefront_bwd_kernel` of
// rnn_speech_tpu/ops/lstm_wavefront.py (entry `_wavefront_bwd`, drop modes
// 0, 1 and 2, and its fused dW_x): reverse diagonal s runs every layer l
// with 0 <= s - (L-1-l) < T at t = T-1 - (s - (L-1-l)), so the top layer leads
// and layer l's upstream cotangent dout_l(t) = dgates_{l+1}(t)·W_x,l+1ᵀ
// comes from the diagonal before.  Per (layer, step) it computes, from the
// forward's bf16 residuals (activated gates, carried c):
//
//   dh = m·(dout + dh_carry);  do = dh·tanh(c)·o(1-o)
//   dc = dh·o·(1 - tanh²c) + m·dc_carry
//   di = dc·g·i(1-i);  dg = dc·i(1-g²);  df = dc·c_prev·f(1-f)
//   dh_carry' = (1-m)·dh_carry + dgates·W_hᵀ;  dc_carry' = (1-m)·dc_carry + dc·f
//
// with c_prev = cseq[t-1] (c0 at t = 0).  Rows past their length have
// m = 0: their dgates are zero and dh/dc pass through.
//
// Inter-layer dropout (modes 1, 2): below the top, dout is the product
// times boundary l's keep·scale, whose bit comes from the explicit mask
// (mode 1) or is regenerated from the seed words for (l, t) exactly as the
// forward drew it (mode 2, csrc/philox.cuh).  At the same element the
// kernel emits xdrop_l(t) = bf16(outs_l(t)·keep·scale), the dropped input
// of layer l+1's dW_x contraction, so no mask stream exists in mode 2.
//
// The difference forced by the card: the TPU computes dgates·W_hᵀ and
// dgates·W_xᵀ on the producing step and hands the results to the next
// grid step in VMEM.  GPU blocks run in no order and each owns 16 hidden
// units, while those products need every unit's dgates.  So each step
// writes its bf16 dgates to a (2, L, Bp, 4H) buffer by diagonal parity,
// and the CONSUMING step computes both products for its own 16 units J:
// dgates_l(t+1)·W_h,l[J,:]ᵀ (its dh carry) and dgates_{l+1}(t)·W_x,l+1[J,:]ᵀ
// (its dout), both read from the previous diagonal's parity and walking
// K = 4H over contiguous rows of W.  The f32 carries hold only the
// elementwise part (1-m)·dh_carry and dc_carry, one owner thread per
// element.  One extra launch after the last diagonal adds
// dgates_l(0)·W_h,lᵀ to give dh0.  dgates overwrite the gates residual in
// place, as the TPU kernel aliases it: each element is read and then
// written by the same thread, and no other step reads it.
//
// Fused dW_x (the TPU kernel's `fuse_dwx` mode, drop modes 0 and 2): the
// pass also returns dW_x of layers 1..L-1, (L-1, H, 4H) f32,
//
//   dW_x,l+1 = Σ_t bf16(outs_l(t)·keep·scale)ᵀ · dgates_{l+1}(t)
//
// without the (L-1, T, B, H) xdrop stream.  The TPU folds each step's
// rank-B update into a VMEM-resident accumulator; here a rank-B update of
// the 32 MiB (L = 3) accumulator per diagonal would move it through device
// memory 3512 times.  Instead the pass works in windows of W diagonals.
// In drop mode 2 the blocks write xdrop_l(t), whose keep bit they draw
// anyway for the cotangent, into slot W-1-(s mod W) of a ring
// (L-1, W, B, H): slot j of boundary l then holds step t = t_base + j,
// ascending in t like the gates buffer, where layer l+1's dgates(t) was
// written one diagonal earlier.  After the window's last diagonal (and
// after the last diagonal of all) one launch per boundary adds ringᵀ ·
// dgates over the window's steps, K = (steps)·B rows, into dW_x with a
// tile product of grad_matmul.cuh in accumulate mode: the Hopper tile
// (TMA + wgmma) at the LSTM widths, whose tensor maps span exactly the
// window's steps·B rows, so TMA zero-fills the K tail instead of reading
// the next steps' rows; the WMMA tile where the caller's plan says so
// (dwx_path).  In drop mode 0 the A operand is the outs residual itself
// and no ring exists.  The launches share the stream, so a ring slot is
// read before the next window writes it, and each output element has one
// owner block, so the sums repeat bit for bit.  dgates, dh0 and dc0 are
// those of the unfused pass, bit for bit.
//
// What bounds it on the H100: 2·T·B·H·4H·(2L-1) operations, 9.4 TFLOP at
// the flagship train shape, 9.5 ms at the bf16 tensor rate; the fused dW_x
// adds 2·T·B·H·4H·(L-1), 3.8 ms at B = 64.  In practice
// the serial chain of T + L diagonals is the limit: per diagonal each
// block walks 2·4H/128 dependent K chunks.
//
// What this design does about it: one launch per diagonal with every
// layer's blocks in it, 128-wide K chunks staged with double-buffered
// cp.async copies (half the chunk count of 64-wide ones), each of the four
// warps owning one 16-row batch tile.  Keeping W resident on chip and
// splitting K across warps is later work.

#include <algorithm>

#include "grad_matmul.cuh"
#include "lstm_cell.cuh"

namespace {

using rst::bf16;

constexpr int kBKC = 128;                  // K chunk
constexpr int kBLd = kBKC + 8;             // padded shared row (bf16)
constexpr int kATile = rst::kRows * kBLd;  // 64 rows of A
constexpr int kWTile = rst::kJT * kBLd;    // 16 rows of W
constexpr int kStage = kATile + kWTile;

long long g_wgmma_products = 0;   // window products launched on the Hopper tile

__device__ __forceinline__ float bf(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float sig_grad(float a) { return a * (1.0f - a); }

struct BwdArgs {
  const bf16* dout_top;  // (T, B, H)
  const bf16* w_h;       // (L, H, 4H)
  const bf16* w_x;       // (L-1, H, 4H): layers 1..L-1
  const float* mask;     // (T, B)
  bf16* gates;           // (L, T, B, 4H): activated gates in, dgates out
  const bf16* cseq;      // (L, T, B, H)
  const float* c0;       // (L, B, H)
  bf16* par;             // (2, L, Bp, 4H) dgates by diagonal parity
  float* dhc;            // (L, B, H) (1-m)·dh_carry; dh0 at the end
  float* dcc;            // (L, B, H) dc_carry; dc0 at the end
  int T, B, Bp, H, L;
  // Inter-layer dropout (modes 1, 2; xdrop == nullptr in mode 0).
  const bf16* masks;     // (L-1, T, B, H) {0, 1} in mode 1, else null
  const bf16* outs;      // (L, T, B, H) masked outputs (boundaries 0..L-2 read)
  bf16* xdrop;           // (L-1, T, B, H) dropped boundary inputs, out, or the
                         // (L-1, W, B, H) ring of the fused dW_x (W = ring)
  int ring;              // W when xdrop is the ring, else 0
  unsigned seed0, seed1, thr;
  float scale;
};

// Stage K columns [k0, k0 + kBKC) of `rows` rows of A (row-major, ld 4H)
// and of W's rows j0..j0+15 (row-major (H, 4H)).
__device__ __forceinline__ void stage(bf16* As, bf16* Ws, const bf16* a, const bf16* w,
                                      int k0, int rows, int ld, int j0) {
  constexpr int V = kBKC / 8;  // 16-byte vectors per row
  for (int i = threadIdx.x; i < rows * V; i += rst::kThreads) {
    const int r = i / V, p = i % V;
    rst::cp_async16(As + r * kBLd + p * 8, a + (size_t)r * ld + k0 + p * 8);
  }
  for (int i = threadIdx.x; i < rst::kJT * V; i += rst::kThreads) {
    const int r = i / V, p = i % V;
    rst::cp_async16(Ws + r * kBLd + p * 8, w + (size_t)(j0 + r) * ld + k0 + p * 8);
  }
}

// s < T + L - 1: one reverse diagonal.  s == T + L - 1: the final pass
// that turns each layer's dh carry into dh0.
__global__ void __launch_bounds__(rst::kThreads) wavefront_bwd_step(int s, BwdArgs p) {
  using namespace nvcuda;
  __shared__ __align__(128) bf16 smem[2 * kStage];

  const int T = p.T, B = p.B, Bp = p.Bp, H = p.H, L = p.L;
  const int l = blockIdx.z;
  const bool final_pass = s == T + L - 1;
  const int off = L - 1 - l;
  const int t = T - 1 - (s - off);
  if (!final_pass && (s < off || t < 0)) return;  // uniform over the block
  const int G = 4 * H;
  const size_t pplane = (size_t)Bp * G;
  const int j0 = blockIdx.x * rst::kJT;
  const int row0 = blockIdx.y * rst::kRows;
  const int n_mt = min(rst::kMaxMT, (Bp - row0) / 16);
  const int rows = n_mt * 16;
  const int warp = threadIdx.x / 32;

  // The previous diagonal's dgates: layer l's at t+1 and layer l+1's at t.
  // The final pass reads layer l's dgates at t = 0, from its last diagonal.
  const int rpar = final_pass ? ((T - 1 + off) & 1) : ((s + 1) & 1);
  const bf16* a_h = (final_pass || t < T - 1)
                        ? p.par + (size_t)(rpar * L + l) * pplane + (size_t)row0 * G
                        : nullptr;
  const bf16* a_x = (!final_pass && l < L - 1)
                        ? p.par + (size_t)(rpar * L + l + 1) * pplane + (size_t)row0 * G
                        : nullptr;
  const bf16* w_h = p.w_h + (size_t)l * H * G;
  const bf16* w_x = l < L - 1 ? p.w_x + (size_t)l * H * G : nullptr;  // W_x of layer l+1
  const int n_k = G / kBKC;
  const int n_ah = a_h != nullptr ? n_k : 0;
  const int n_chunks = n_ah + (a_x != nullptr ? n_k : 0);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc_h, acc_x;
  wmma::fill_fragment(acc_h, 0.0f);
  wmma::fill_fragment(acc_x, 0.0f);
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;

  auto load = [&](int c) {
    bf16* As = smem + (c & 1) * kStage;
    const bool hpart = c < n_ah;
    stage(As, As + kATile, hpart ? a_h : a_x, hpart ? w_h : w_x,
          (hpart ? c : c - n_ah) * kBKC, rows, G, j0);
  };
  if (n_chunks > 0) load(0);
  rst::cp_async_commit();
  for (int c = 0; c < n_chunks; ++c) {
    if (c + 1 < n_chunks) load(c + 1);
    rst::cp_async_commit();
    rst::cp_async_wait<1>();  // chunk c has landed
    __syncthreads();
    const bf16* As = smem + (c & 1) * kStage;
    const bf16* Ws = As + kATile;
    if (warp < n_mt) {
#pragma unroll
      for (int kk = 0; kk < kBKC; kk += 16) {
        wmma::load_matrix_sync(fb, Ws + kk, kBLd);  // (k, j) = W[j0 + j][k]
        wmma::load_matrix_sync(fa, As + warp * 16 * kBLd + kk, kBLd);
        if (c < n_ah) {
          wmma::mma_sync(acc_h, fa, fb, acc_h);
        } else {
          wmma::mma_sync(acc_x, fa, fb, acc_x);
        }
      }
    }
    __syncthreads();  // before the next iteration overwrites this stage
  }
  rst::cp_async_wait<0>();

  float* ph = reinterpret_cast<float*>(smem);  // [kRows][kJT]
  float* px = ph + rst::kRows * rst::kJT;      // [kRows][kJT]
  if (warp < n_mt) {
    wmma::store_matrix_sync(ph + warp * 16 * rst::kJT, acc_h, rst::kJT,
                            wmma::mem_row_major);
    wmma::store_matrix_sync(px + warp * 16 * rst::kJT, acc_x, rst::kJT,
                            wmma::mem_row_major);
  }
  __syncthreads();

  float* dhc = p.dhc + (size_t)l * B * H;
  float* dcc = p.dcc + (size_t)l * B * H;
  if (final_pass) {
    for (int idx = threadIdx.x; idx < rows * rst::kJT; idx += rst::kThreads) {
      const int b = row0 + idx / rst::kJT;
      if (b < B) dhc[(size_t)b * H + j0 + idx % rst::kJT] += ph[idx];
    }
    return;
  }

  const size_t step = (size_t)l * T + t;
  bf16* gates = p.gates + step * B * G;
  const bf16* c_t = p.cseq + step * B * H;
  const bf16* c_p = t > 0 ? p.cseq + (step - 1) * B * H : nullptr;
  const float* c0 = p.c0 + (size_t)l * B * H;
  const bf16* dtop = l == L - 1 ? p.dout_top + (size_t)t * B * H : nullptr;
  const float* mask = p.mask + (size_t)t * B;
  bf16* wpar = p.par + (size_t)((s & 1) * L + l) * pplane;
  const size_t step_b = step * B * H;  // (l, t) plane of a (·, T, B, H) stream
  for (int idx = threadIdx.x; idx < rows * rst::kJT; idx += rst::kThreads) {
    const int r = idx / rst::kJT;
    const int b = row0 + r;
    if (b >= B) continue;
    const int j = j0 + idx % rst::kJT;
    const size_t e = (size_t)b * H + j;
    const float m = mask[b];
    float dout = dtop != nullptr ? bf(dtop[e]) : px[idx];
    if (p.xdrop != nullptr && l < L - 1) {
      // Boundary l's keep·scale at its producer's diagonal: it scales the
      // cotangent from the layer above and gives the dropped input that
      // the dW_x contraction of layer l+1 reads.
      const size_t de = step_b + e;
      const float keep =
          p.masks != nullptr
              ? bf(p.masks[de])
              : (rst::wavefront_keep(p.seed0, p.seed1, p.thr, l, t, b, j) ? 1.0f : 0.0f);
      const float ks = keep * p.scale;
      dout *= ks;
      const size_t xe =
          p.ring > 0 ? ((size_t)l * p.ring + (p.ring - 1 - s % p.ring)) * B * H + e : de;
      p.xdrop[xe] = __float2bfloat16(bf(p.outs[de]) * ks);
    }
    const float dh_carry = dhc[e] + ph[idx];  // ph is zero at t = T-1
    const float dc_carry = dcc[e];
    bf16* g = gates + (size_t)b * G;
    const float i_a = bf(g[j]), g_a = bf(g[H + j]);
    const float f_a = bf(g[2 * H + j]), o_a = bf(g[3 * H + j]);
    const float tanh_c = tanhf(bf(c_t[e]));
    const float c_prev = c_p != nullptr ? bf(c_p[e]) : c0[e];
    const float dh_new = m * (dout + dh_carry);
    const float do_pre = dh_new * tanh_c * sig_grad(o_a);
    const float dc_new = dh_new * o_a * (1.0f - tanh_c * tanh_c) + m * dc_carry;
    const bf16 di = __float2bfloat16(dc_new * g_a * sig_grad(i_a));
    const bf16 dg = __float2bfloat16(dc_new * i_a * (1.0f - g_a * g_a));
    const bf16 df = __float2bfloat16(dc_new * c_prev * sig_grad(f_a));
    const bf16 dq = __float2bfloat16(do_pre);
    g[j] = di;
    g[H + j] = dg;
    g[2 * H + j] = df;
    g[3 * H + j] = dq;
    bf16* w = wpar + (size_t)b * G;
    w[j] = di;
    w[H + j] = dg;
    w[2 * H + j] = df;
    w[3 * H + j] = dq;
    dhc[e] = (1.0f - m) * dh_carry;
    dcc[e] = (1.0f - m) * dc_carry + dc_new * f_a;
  }
}

// The fused dW_x of the window of diagonals [s0, s1] (W wide): per boundary
// l, the steps t whose dropped input layer l produced in the window, from
// the ring (drop mode 2) or the outs residual (mode 0), times layer l+1's
// dgates, added into dwx[l] by the product on `path`.  Returns the CUDA
// error code.
int accumulate_dwx(const BwdArgs& p, int s0, int s1, int W, int path, float* dwx,
                   cudaStream_t st) {
  const int T = p.T, B = p.B, H = p.H, L = p.L, G = 4 * H;
  for (int l = 0; l + 1 < L; ++l) {
    const int off = L - 1 - l;
    const int t_lo = std::max(0, T - 1 - s1 + off), t_hi = std::min(T - 1, T - 1 - s0 + off);
    if (t_lo > t_hi) continue;
    const int n = (t_hi - t_lo + 1) * B;
    const int slot = t_lo - (T - W + off - s0);  // ring slot of step t_lo
    const bf16* a = p.xdrop != nullptr ? p.xdrop + ((size_t)l * W + slot) * B * H
                                       : p.outs + ((size_t)l * T + t_lo) * B * H;
    const bf16* dg = p.gates + ((size_t)(l + 1) * T + t_lo) * B * G;
    const int err = rst_grad::launch(path, a, H, nullptr, 0, dg, 0, n, G, 1, n, nullptr,
                                     nullptr, dwx + (size_t)l * H * G, nullptr, 1, st);
    if (err != 0) return err;
    g_wgmma_products += path == rst_grad::kWgmma;
  }
  return 0;
}

}  // namespace

// dout_top (T, B, H) bf16: cotangent of the top layer's output;
// w_h (L, H, 4H), w_x (L-1, H, 4H) bf16; mask (T, B) f32 {0, 1};
// gates (L, T, B, 4H) bf16: activated gates, overwritten with dgates;
// cseq (L, T, B, H) bf16 carried c; c0 (L, B, H) f32;
// par (2, L, Bp, 4H) bf16 scratch, zero;
// dhc, dcc (L, B, H) f32 holding dhn, dcn on entry and dh0, dc0 on return.
// Dropout: drop_mode 0 (none), 1 (masks (L-1, T, B, H) bf16 {0, 1}) or 2
// (Philox bits of (seed0, seed1) under threshold thr), scale = 1/keep;
// outs (L, T, B, H) bf16, the forward's masked outputs; xdrop
// (L-1, T, B, H) bf16 receives bf16(outs·keep·scale) of boundaries 0..L-2.
// Fused dW_x (window W > 0, drop modes 0 and 2): dwx (L-1, H, 4H) f32, zero
// on entry, receives dW_x of layers 1..L-1; outs is read in both modes, and
// xdrop is the (L-1, W, B, H) bf16 ring in mode 2 (null in mode 0);
// dwx_path picks the window products' tile (rst_grad::Path).
// Bp = B rounded up to 16; H a multiple of 32.
// Returns the CUDA error code of the launches (0 = success).
extern "C" int rst_lstm_wavefront_bwd(const void* dout_top, const void* w_h,
                                      const void* w_x, const float* mask, void* gates,
                                      const void* cseq, const float* c0, void* par,
                                      float* dhc, float* dcc, int T, int B, int H, int L,
                                      int drop_mode, const void* masks, const void* outs,
                                      void* xdrop, unsigned seed0, unsigned seed1,
                                      unsigned thr, float scale, int window, float* dwx,
                                      int dwx_path, void* stream) {
  if (window > 0 && (drop_mode == 1 || dwx == nullptr || outs == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  BwdArgs p;
  p.dout_top = static_cast<const bf16*>(dout_top);
  p.w_h = static_cast<const bf16*>(w_h);
  p.w_x = static_cast<const bf16*>(w_x);
  p.mask = mask;
  p.gates = static_cast<bf16*>(gates);
  p.cseq = static_cast<const bf16*>(cseq);
  p.c0 = c0;
  p.par = static_cast<bf16*>(par);
  p.dhc = dhc;
  p.dcc = dcc;
  p.T = T;
  p.B = B;
  p.Bp = (B + 15) / 16 * 16;
  p.H = H;
  p.L = L;
  p.masks = drop_mode == 1 ? static_cast<const bf16*>(masks) : nullptr;
  p.outs = static_cast<const bf16*>(outs);
  p.xdrop = drop_mode != 0 ? static_cast<bf16*>(xdrop) : nullptr;
  p.ring = window > 0 ? window : 0;
  p.seed0 = seed0;
  p.seed1 = seed1;
  p.thr = thr;
  p.scale = scale;
  const dim3 grid(H / rst::kJT, (p.Bp + rst::kRows - 1) / rst::kRows, L);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_diag = T + L - 1;
  for (int s = 0; s < T + L; ++s) {
    wavefront_bwd_step<<<grid, rst::kThreads, 0, st>>>(s, p);
    if (s == 0) {
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    if (window > 0 && s < n_diag && ((s + 1) % window == 0 || s == n_diag - 1)) {
      const int err = accumulate_dwx(p, s - s % window, s, window, dwx_path, dwx, st);
      if (err != 0) return err;
    }
  }
  return (int)cudaGetLastError();
}

// Window products launched on the Hopper tile so far.
extern "C" long long rst_wgmma_products() { return g_wgmma_products; }

// The pass's window products alone, as drop mode 0 runs them: outs (L, T,
// B, H) and dgates (L, T, B, 4H) bf16; dwx (L-1, H, 4H) f32 receives, window
// by window, dW_x of layers 1..L-1 from outs (for timing and tests).
extern "C" int rst_dwx_windows(const void* outs, const void* dgates, int T, int B, int H,
                               int L, int window, float* dwx, int dwx_path, void* stream) {
  BwdArgs p = {};
  p.outs = static_cast<const bf16*>(outs);
  p.gates = static_cast<bf16*>(const_cast<void*>(dgates));
  p.T = T;
  p.B = B;
  p.H = H;
  p.L = L;
  const int n_diag = T + L - 1;
  for (int s0 = 0; s0 < n_diag; s0 += window) {
    const int err = accumulate_dwx(p, s0, std::min(s0 + window, n_diag) - 1, window, dwx_path,
                                   dwx, static_cast<cudaStream_t>(stream));
    if (err != 0) return err;
  }
  return (int)cudaGetLastError();
}
