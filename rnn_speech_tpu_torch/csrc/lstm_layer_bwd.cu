// One LSTM layer's backward over T steps in reverse, in both residual
// modes, for Hopper (sm_90a).
//
// Replaces two TPU kernels of rnn_speech_tpu/ops/lstm_pallas.py:
//
// * `_recurrence_bwd_kernel` (entry `_lstm_recurrence_bwd`, gates mode):
//   reads the forward's bf16 activated gates and carried c;
// * `_recurrence_bwd_recompute_kernel` (entry
//   `_lstm_recurrence_bwd_recompute`, recompute mode): rebuilds the gates
//   each step as sig/tanh of bf16(x[t])·W_x + bf16(h_prev[t])·W_h + b from
//   the bf16 residuals, with the forward cell's products (lstm_cell.cuh).
//
// Per step t = T-1 .. 0, with c_prev = cseq[t-1] (the initial c at t = 0):
//
//   dh = m·(dout + dh_carry);  do = dh·tanh(c)·o(1-o)
//   dc = dh·o·(1 - tanh²c) + m·dc_carry
//   di = dc·g·i(1-i);  dg = dc·i(1-g²);  df = dc·c_prev·f(1-f)
//   dh_carry' = (1-m)·dh_carry + bf16(dgates)·W_hᵀ;  dc_carry' = (1-m)·dc_carry + dc·f
//
// Rows past their length have m = 0: their dgates are zero and dh, dc
// pass through.  dgates leave in bf16: over the gates residual in gates
// mode (the TPU kernel aliases them onto it), into a new stream in
// recompute mode.
//
// The difference forced by the card, as in the wavefront backward
// (lstm_wavefront_bwd.cu at one layer): the TPU forms dgates·W_hᵀ on the
// producing step and carries it in VMEM.  GPU blocks run in no order and
// each owns 16 hidden units, while that product needs every unit's
// dgates.  So each step also writes its bf16 dgates to a (2, Bp, 4H)
// buffer by step parity, and the CONSUMING step computes dgates(t+1)·
// W_h[J, :]ᵀ for its own units J over K = 4H.  The f32 carries hold only
// (1-m)·dh_carry and dc_carry, one owner thread per element; one extra
// launch after step 0 adds dgates(0)·W_hᵀ to give dh0.
//
// What bounds it on the H100: 2·T·B·H·4H operations in gates mode (1.9 ms
// at the flagship train shape, H=1024, B=64, T=3510) and three times that
// in recompute mode, whose two rebuild products (K = D and K = H) depend
// only on the residuals, not on the reverse carry.  In practice the serial
// chain of T steps is the limit.  What this design does about it: one
// launch per step from one host call, 128-wide K chunks for the carry's
// product and the forward cell's 64-wide ones for the rebuild, each
// double-buffered through cp.async.  Moving the rebuild products off the
// serial chain (one large product before the loop, or overlapped) is
// later work.

#include "lstm_cell.cuh"

namespace {

using rst::bf16;

constexpr int kBKC = 128;                  // K chunk of the carry's product
constexpr int kBLd = kBKC + 8;             // padded shared row (bf16)
constexpr int kATile = rst::kRows * kBLd;  // 64 rows of A
constexpr int kWTile = rst::kJT * kBLd;    // 16 rows of W
constexpr int kStage = kATile + kWTile;
constexpr int kSmem = 2 * kStage > rst::kCellSmem ? 2 * kStage : rst::kCellSmem;

__device__ __forceinline__ float bf(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float sig_grad(float a) { return a * (1.0f - a); }

struct LayerBwd {
  const float* dout;   // (T, B, H) cotangent of the layer's output
  bf16* gates;         // (T, B, 4H): activated gates in (gates mode), dgates out
  const bf16* cseq;    // (T, B, H) carried c
  const float* c0;     // (B, H) initial c as the residual stores it
  const float* mask;   // (T, B)
  const bf16* w_h;     // (H, 4H)
  bf16* par;           // (2, Bp, 4H) dgates by step parity
  float* dhc;          // (B, H) (1-m)·dh_carry; dh0 at the end
  float* dcc;          // (B, H) dc_carry; dc0 at the end
  // Recompute mode (x == nullptr in gates mode):
  const bf16* x;       // (T, Bp, D) layer input
  const bf16* h_prev;  // (T, Bp, H) h entering each step
  const bf16* w_x;     // (D, 4H)
  const float* bias;   // (4H)
  int T, B, Bp, H, D;
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

// ph[kRows][kJT] = a·W[j0..j0+15, :]ᵀ over K = G for the block's rows
// (a: the block's first row, ld G), or zero when a is null.  Warp w owns
// the 16-row tile w.  Ends with a __syncthreads.
__device__ __forceinline__ void carry_product(bf16* smem, float* ph, const bf16* a,
                                              const bf16* w, int G, int n_mt, int j0) {
  using namespace nvcuda;
  const int warp = threadIdx.x / 32;
  const int rows = n_mt * 16;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
  wmma::fill_fragment(acc, 0.0f);
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
  const int n_k = a != nullptr ? G / kBKC : 0;
  if (n_k > 0) stage(smem, smem + kATile, a, w, 0, rows, G, j0);
  rst::cp_async_commit();
  for (int c = 0; c < n_k; ++c) {
    if (c + 1 < n_k) {
      bf16* As = smem + ((c + 1) & 1) * kStage;
      stage(As, As + kATile, a, w, (c + 1) * kBKC, rows, G, j0);
    }
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
        wmma::mma_sync(acc, fa, fb, acc);
      }
    }
    __syncthreads();  // before the next iteration overwrites this stage
  }
  rst::cp_async_wait<0>();
  if (warp < n_mt) {
    wmma::store_matrix_sync(ph + warp * 16 * rst::kJT, acc, rst::kJT,
                            wmma::mem_row_major);
  }
  __syncthreads();
}

// s < T: step t = T-1-s.  s == T: the final pass that turns the dh carry
// into dh0.
__global__ void __launch_bounds__(rst::kThreads) layer_bwd_step(int s, LayerBwd p) {
  __shared__ __align__(128) bf16 smem[kSmem];
  __shared__ float ph[rst::kRows * rst::kJT];

  const int T = p.T, B = p.B, Bp = p.Bp, H = p.H;
  const int G = 4 * H;
  const bool final_pass = s == T;
  const int t = T - 1 - s;
  const int j0 = blockIdx.x * rst::kJT;
  const int row0 = blockIdx.y * rst::kRows;
  const int n_mt = min(rst::kMaxMT, (Bp - row0) / 16);
  const int rows = n_mt * 16;
  const size_t pplane = (size_t)Bp * G;

  // dgates of the step before (t+1), or of t = 0 in the final pass.
  const bf16* a = s > 0 ? p.par + ((s + 1) & 1) * pplane + (size_t)row0 * G : nullptr;
  carry_product(smem, ph, a, p.w_h, G, n_mt, j0);
  if (final_pass) {
    for (int idx = threadIdx.x; idx < rows * rst::kJT; idx += rst::kThreads) {
      const int b = row0 + idx / rst::kJT;
      if (b < B) p.dhc[(size_t)b * H + j0 + idx % rst::kJT] += ph[idx];
    }
    return;
  }

  const float* pre = nullptr;  // recompute mode: gate sums [4][kRows][kJT]
  if (p.x != nullptr) {
    rst::CellStep cs;
    cs.x_in = p.x + (size_t)t * Bp * p.D;
    cs.w_x = p.w_x;
    cs.Kx = p.D;
    cs.h_in = p.h_prev + (size_t)t * Bp * H;
    cs.w_h = p.w_h;
    cs.H = H;
    cs.Bp = Bp;
    pre = rst::cell_products(smem, cs);
  }

  const size_t th = (size_t)t * B * H;
  bf16* wpar = p.par + (s & 1) * pplane;
  for (int idx = threadIdx.x; idx < rows * rst::kJT; idx += rst::kThreads) {
    const int r = idx / rst::kJT;
    const int b = row0 + r;
    if (b >= B) continue;
    const int jj = idx % rst::kJT;
    const int j = j0 + jj;
    const size_t e = (size_t)b * H + j;
    const float m = p.mask[(size_t)t * B + b];
    bf16* g = p.gates + ((size_t)t * B + b) * G;
    float i_a, g_a, f_a, o_a;
    if (pre != nullptr) {
      const float* bias = p.bias;
      i_a = rst::sigmoidf_(pre[(0 * rst::kRows + r) * rst::kJT + jj] + bias[j]);
      g_a = tanhf(pre[(1 * rst::kRows + r) * rst::kJT + jj] + bias[H + j]);
      f_a = rst::sigmoidf_(pre[(2 * rst::kRows + r) * rst::kJT + jj] + bias[2 * H + j] +
                           1.0f);
      o_a = rst::sigmoidf_(pre[(3 * rst::kRows + r) * rst::kJT + jj] + bias[3 * H + j]);
    } else {
      i_a = bf(g[j]);
      g_a = bf(g[H + j]);
      f_a = bf(g[2 * H + j]);
      o_a = bf(g[3 * H + j]);
    }
    const float dh_carry = p.dhc[e] + ph[idx];  // ph is zero at t = T-1
    const float dc_carry = p.dcc[e];
    const float tanh_c = tanhf(bf(p.cseq[th + e]));
    const float c_prev = t > 0 ? bf(p.cseq[th - (size_t)B * H + e]) : p.c0[e];
    const float dh_new = m * (p.dout[th + e] + dh_carry);
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
    p.dhc[e] = (1.0f - m) * dh_carry;
    p.dcc[e] = (1.0f - m) * dc_carry + dc_new * f_a;
  }
}

int launch(LayerBwd p, void* stream) {
  const dim3 grid(p.H / rst::kJT, (p.Bp + rst::kRows - 1) / rst::kRows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int s = 0; s <= p.T; ++s) {
    layer_bwd_step<<<grid, rst::kThreads, 0, st>>>(s, p);
    if (s == 0) {
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
  }
  return (int)cudaGetLastError();
}

LayerBwd common(const float* dout, void* dgates, const void* cseq, const float* c0,
                const float* mask, const void* w_h, void* par, float* dhc, float* dcc,
                int T, int B, int H) {
  LayerBwd p;
  p.dout = dout;
  p.gates = static_cast<bf16*>(dgates);
  p.cseq = static_cast<const bf16*>(cseq);
  p.c0 = c0;
  p.mask = mask;
  p.w_h = static_cast<const bf16*>(w_h);
  p.par = static_cast<bf16*>(par);
  p.dhc = dhc;
  p.dcc = dcc;
  p.x = nullptr;
  p.h_prev = nullptr;
  p.w_x = nullptr;
  p.bias = nullptr;
  p.T = T;
  p.B = B;
  p.Bp = (B + 15) / 16 * 16;
  p.H = H;
  p.D = 0;
  return p;
}

}  // namespace

// Gates mode.  dout (T, B, H) f32; gates (T, B, 4H) bf16: activated gates,
// overwritten with dgates; cseq (T, B, H) bf16; c0 (B, H) f32, the initial
// c rounded as the residual stores it; mask (T, B) f32 {0, 1}; w_h (H, 4H)
// bf16; par (2, Bp, 4H) bf16 scratch, zero; dhc, dcc (B, H) f32 holding
// dhn, dcn on entry and dh0, dc0 on return.  Bp = B rounded up to 16; H a
// multiple of 64.  Returns the CUDA error code of the launches (0 = success).
extern "C" int rst_lstm_layer_bwd(const float* dout, void* gates, const void* cseq,
                                  const float* c0, const float* mask, const void* w_h,
                                  void* par, float* dhc, float* dcc, int T, int B, int H,
                                  void* stream) {
  return launch(common(dout, gates, cseq, c0, mask, w_h, par, dhc, dcc, T, B, H), stream);
}

// Recompute mode: as above, with dgates (T, B, 4H) bf16 written fresh and
// the gates rebuilt from x (T, Bp, D) and h_prev (T, Bp, H) bf16 (rows
// >= B zero), w_x (D, 4H) bf16 and bias (4H) f32.  D a multiple of 64.
extern "C" int rst_lstm_layer_bwd_recompute(const float* dout, void* dgates,
                                            const void* cseq, const float* c0,
                                            const float* mask, const void* w_h,
                                            const void* x, const void* h_prev,
                                            const void* w_x, const float* bias, void* par,
                                            float* dhc, float* dcc, int T, int B, int H,
                                            int D, void* stream) {
  LayerBwd p = common(dout, dgates, cseq, c0, mask, w_h, par, dhc, dcc, T, B, H);
  p.x = static_cast<const bf16*>(x);
  p.h_prev = static_cast<const bf16*>(h_prev);
  p.w_x = static_cast<const bf16*>(w_x);
  p.bias = bias;
  p.D = D;
  return launch(p, stream);
}
