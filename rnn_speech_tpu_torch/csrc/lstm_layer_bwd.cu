// One LSTM layer's backward over T steps in reverse, in both residual
// modes, for Hopper (sm_90a).
//
// Replaces two TPU kernels of rnn_speech_tpu/ops/lstm_pallas.py:
//
// * `_recurrence_bwd_kernel` (entry `_lstm_recurrence_bwd`, gates mode):
//   reads the forward's bf16 activated gates and carried c;
// * `_recurrence_bwd_recompute_kernel` (entry
//   `_lstm_recurrence_bwd_recompute`, recompute mode): rebuilds the gates
//   as sig/tanh of bf16(x[t])·W_x + bf16(h_prev[t])·W_h + b from the bf16
//   residuals.  The TPU kernel forms them inside each step; here they are
//   one Hopper product per chunk of steps (rebuild_gates.cuh), ahead of
//   the chunk's serial chain.
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
// In gates mode the wrapper's plan (`bwd_plan`, ops/lstm_layer_train.py)
// sends the shapes whose grid fits the card (the layered step's B=64) to
// the persistent kernel, csrc/lstm_layer_bwd_persistent.cu; this file's
// per-step form runs the others, and recompute mode.
//
// What bounds it on the H100: 2·T·B·H·4H operations in gates mode (1.9 ms
// at the flagship train shape, H=1024, B=64, T=3510) and three times that
// in recompute mode, whose two rebuild products (K = D and K = H) depend
// only on the residuals, not on the reverse carry.  In practice the serial
// chain of T steps is the limit.  What this design does about it: one
// launch per step from one host call, the carry's product in 128-wide K
// chunks double-buffered through cp.async.  In recompute mode the chain
// keeps only that product: for chunks of at most C steps, last first, one
// launch of the rebuild product writes the chunk's activated gates (C·B,
// 4H) in float32 at the tensor-core rate, then the chunk's steps read them.
// The chunks are the caller's (ops/lstm_layer_train.py `rebuild_chunks`:
// a byte cap on the chunk buffer), checked here to cover [0, T) once.

#include "lstm_cell.cuh"
#include "rebuild_gates.cuh"

namespace {

using rst::bf16;

constexpr int kBKC = 128;                  // K chunk of the carry's product
constexpr int kBLd = kBKC + 8;             // padded shared row (bf16)
constexpr int kATile = rst::kRows * kBLd;  // 64 rows of A
constexpr int kWTile = rst::kJT * kBLd;    // 16 rows of W
constexpr int kStage = kATile + kWTile;
constexpr int kSmem = 2 * kStage;

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
  // Recompute mode (act == nullptr in gates mode): the activated gates of
  // steps t0 .. t0 + C - 1, row (t - t0)·B + b, from the rebuild product.
  const float* act;    // (C·B, 4H)
  int t0;
  int T, B, Bp, H;
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

  // Recompute mode: this step's rows of the chunk's activated gates.
  const float* act = p.act != nullptr ? p.act + (size_t)(t - p.t0) * B * G : nullptr;

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
    if (act != nullptr) {
      const float* a = act + (size_t)b * G;
      i_a = a[j];
      g_a = a[H + j];
      f_a = a[2 * H + j];
      o_a = a[3 * H + j];
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

dim3 step_grid(const LayerBwd& p) {
  return dim3(p.H / rst::kJT, (p.Bp + rst::kRows - 1) / rst::kRows);
}

int launch(LayerBwd p, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int s = 0; s <= p.T; ++s) {
    layer_bwd_step<<<step_grid(p), rst::kThreads, 0, st>>>(s, p);
    if (s == 0) {
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
  }
  return (int)cudaGetLastError();
}

long long g_rebuild_launches = 0;   // rebuild products launched by launch_recompute

// Recompute mode: for the caller's chunks, in its order (starts t0[0] >
// t0[1] > ... > t0[n - 1] = 0; chunk k spans [t0[k], t0[k - 1]), chunk 0
// ends at T; each at most `chunk` steps), the rebuild product of the chunk
// into act, then its steps t1-1 .. t0; then the final pass.
int launch_recompute(LayerBwd p, const rst_rebuild::Maps& maps, int D, const float* bias,
                     float* act, const int* starts, int n_chunks, int chunk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  p.act = act;
  for (int k = 0, t1 = p.T; k < n_chunks; t1 = starts[k++]) {
    const int t0 = starts[k];
    if (t0 < 0 || t0 >= t1 || t1 - t0 > chunk || (k == n_chunks - 1) != (t0 == 0)) {
      return (int)cudaErrorInvalidValue;
    }
    const int err = rst_rebuild::launch(maps, t0 * p.B, (t1 - t0) * p.B, D, p.H, bias, act, st);
    if (err != 0) return err;
    ++g_rebuild_launches;
    p.t0 = t0;
    for (int t = t1 - 1; t >= t0; --t) {
      layer_bwd_step<<<step_grid(p), rst::kThreads, 0, st>>>(p.T - 1 - t, p);
    }
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  layer_bwd_step<<<step_grid(p), rst::kThreads, 0, st>>>(p.T, p);
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
  p.act = nullptr;
  p.t0 = 0;
  p.T = T;
  p.B = B;
  p.Bp = (B + 15) / 16 * 16;
  p.H = H;
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
// the gates rebuilt from x (T, B, D) and h_prev (T, B, H) bf16, w_x (D, 4H)
// bf16 and bias (4H) f32, over the n_chunks chunks that `starts` gives (as
// launch_recompute reads them) into act (chunk·B, 4H) f32 scratch.  D a
// multiple of 64; x, h_prev, w_x, w_h 16-byte aligned.
extern "C" int rst_lstm_layer_bwd_recompute(const float* dout, void* dgates,
                                            const void* cseq, const float* c0,
                                            const float* mask, const void* w_h,
                                            const void* x, const void* h_prev,
                                            const void* w_x, const float* bias, void* par,
                                            float* dhc, float* dcc, float* act,
                                            const int* starts, int n_chunks, int chunk,
                                            int T, int B, int H, int D, void* stream) {
  if (T <= 0 || B <= 0 || n_chunks <= 0) return (int)cudaErrorInvalidValue;
  rst_rebuild::Maps maps;
  if (!rst_rebuild::make_maps(&maps, x, h_prev, w_x, w_h, T * B, D, H)) {
    return (int)cudaErrorInvalidValue;
  }
  LayerBwd p = common(dout, dgates, cseq, c0, mask, w_h, par, dhc, dcc, T, B, H);
  return launch_recompute(p, maps, D, bias, act, starts, n_chunks, chunk, stream);
}

// Rebuild products that rst_lstm_layer_bwd_recompute has launched.
extern "C" long long rst_rebuild_launches() { return g_rebuild_launches; }

// The rebuild product alone: act (rows, 4H) f32 = the activated gates of
// x (rows, D) and h_prev (rows, H) bf16 with w_x (D, 4H), w_h (H, 4H) bf16
// and bias (4H) f32.  D and H multiples of 64, operands 16-byte aligned.
extern "C" int rst_rebuild_gates(const void* x, const void* h_prev, const void* w_x,
                                 const void* w_h, const float* bias, float* act, int rows, int D,
                                 int H, void* stream) {
  rst_rebuild::Maps maps;
  if (!rst_rebuild::make_maps(&maps, x, h_prev, w_x, w_h, rows, D, H)) {
    return (int)cudaErrorInvalidValue;
  }
  return rst_rebuild::launch(maps, 0, rows, D, H, bias, act, static_cast<cudaStream_t>(stream));
}
