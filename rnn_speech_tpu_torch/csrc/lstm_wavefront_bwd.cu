// Whole-stack LSTM backward on the reverse (layer, time) diagonal, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel `_wavefront_bwd_kernel` of
// rnn_speech_tpu/ops/lstm_wavefront.py (entry `_wavefront_bwd`, drop modes
// 0, 1 and 2, and its fused dW_x) at the shapes the wrapper's plan
// (`wavefront_bwd_plan`) does not send to the persistent kernel
// (csrc/lstm_wavefront_bwd_persistent.cu): reverse diagonal s runs every layer l
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
// memory 3512 times.  Instead the pass works in windows of W diagonals
// (csrc/dwx_windows.cuh, shared with the persistent reverse diagonal).
// In drop mode 2 the blocks write xdrop_l(t), whose keep bit they draw
// anyway for the cotangent, into the window's ring (L-1, W, B, H).  After
// the window's last diagonal (and after the last diagonal of all) one
// launch per boundary adds ringᵀ · dgates over the window's steps into
// dW_x with a tile product of grad_matmul.cuh in accumulate mode: the
// Hopper tile (TMA + wgmma) at the LSTM widths, whose tensor maps span
// exactly the window's steps·B rows, so TMA zero-fills the K tail instead
// of reading the next steps' rows; the WMMA tile where the caller's plan
// says so (dwx_path).  dgates, dh0 and dc0 are those of the unfused pass,
// bit for bit.
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
//
// Float32 compute (entry rst_lstm_wavefront_bwd_f32; the JAX kernel's
// compute_dtype=float32 with float32 residuals, unfused): the residuals,
// the weights, dout_top, dgates, their parity buffer and xdrop are
// float32, the two carry products SIMT products over 64-wide float32 K
// chunks (the drop masks of mode 1 stay bf16 {0, 1}).  The persistent
// kernel and the fused dW_x are bf16 only; in float32 the reverse diagonal
// runs as the layer sweep of csrc/lstm_layer_bwd_f32.cu where
// `wavefront_bwd_plan` says so, and here unfused for the other shapes; the
// caller takes dW_x from the weight-gradient kernel's float32 tile
// (ops/lstm_wavefront.py).  Mixed compute and residual types (entries
// ``_bf16_f32`` and ``_f32_bf16``, unfused): the weights and the parity
// buffer in the compute type, dout_top, the residuals, dgates and xdrop in
// the residual type.

#include <algorithm>

#include "dwx_windows.cuh"
#include "lstm_cell.cuh"

namespace {

using rst::bf16;

constexpr int kBKC = 128;                  // K chunk
constexpr int kBLd = kBKC + 8;             // padded shared row (bf16)
constexpr int kATile = rst::kRows * kBLd;  // 64 rows of A
constexpr int kWTile = rst::kJT * kBLd;    // 16 rows of W
constexpr int kStage = kATile + kWTile;
// The float32 products' chunk: 64 floats of K, rows padded by four (the
// same bytes of shared memory as the bf16 stages).
constexpr int kFKC = 64;
constexpr int kFLd = kFKC + 4;
constexpr int kFStage = (rst::kRows + rst::kJT) * kFLd;   // floats of one stage
static_assert(2 * kFStage * 4 <= 2 * kStage * 2, "float32 stages fit the bf16 ones");

long long g_wgmma_products = 0;   // window products launched on the Hopper tile

__device__ __forceinline__ float sig_grad(float a) { return a * (1.0f - a); }

// E: the operand type (the weights and the dgates the carry products
// read); R: the residual type (dout_top, gates, cseq, outs, xdrop).
template <typename E, typename R = E>
struct BwdArgs {
  const R* dout_top;     // (T, B, H)
  const E* w_h;          // (L, H, 4H)
  const E* w_x;          // (L-1, H, 4H): layers 1..L-1
  const float* mask;     // (T, B)
  R* gates;              // (L, T, B, 4H): activated gates in, dgates out
  const R* cseq;         // (L, T, B, H)
  const float* c0;       // (L, B, H)
  E* par;                // (2, L, Bp, 4H) dgates by diagonal parity
  float* dhc;            // (L, B, H) (1-m)·dh_carry; dh0 at the end
  float* dcc;            // (L, B, H) dc_carry; dc0 at the end
  int T, B, Bp, H, L;
  // Inter-layer dropout (modes 1, 2; xdrop == nullptr in mode 0).
  const bf16* masks;     // (L-1, T, B, H) {0, 1} in mode 1, else null
  const R* outs;         // (L, T, B, H) masked outputs (boundaries 0..L-2 read)
  R* xdrop;              // (L-1, T, B, H) dropped boundary inputs, out, or the
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

// The two carry products of a (layer, step), bf16: ph = a_h·W_h[J, :]ᵀ and
// px = a_x·W_x[J, :]ᵀ (zero where the operand is null) into [kRows][kJT]
// f32 each at the start of smem; warp w owns the 16-row tile w.  Ends with
// a __syncthreads.
__device__ __forceinline__ void carry_products(bf16* smem, const bf16* a_h, const bf16* a_x,
                                               const bf16* w_h, const bf16* w_x, int G,
                                               int n_mt, int j0) {
  using namespace nvcuda;
  const int rows = n_mt * 16;
  const int warp = threadIdx.x / 32;
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
}

// Stage K columns [k0, k0 + kFKC) of `rows` float32 rows of A and of W's
// rows j0..j0+15, both row-major with ld 4H.
__device__ __forceinline__ void stage_f32(float* As, float* Ws, const float* a, const float* w,
                                          int k0, int rows, int ld, int j0) {
  constexpr int V = kFKC / 4;  // 16-byte vectors per row
  for (int i = threadIdx.x; i < rows * V; i += rst::kThreads) {
    const int r = i / V, p = i % V;
    rst::cp_async16(As + r * kFLd + p * 4, a + (size_t)r * ld + k0 + p * 4);
  }
  for (int i = threadIdx.x; i < rst::kJT * V; i += rst::kThreads) {
    const int r = i / V, p = i % V;
    rst::cp_async16(Ws + r * kFLd + p * 4, w + (size_t)(j0 + r) * ld + k0 + p * 4);
  }
}

// The two carry products in float32, as ``carry_products``: thread (j =
// tid % 16, rg = tid / 16) sums rows rg + 8i (i < 8) of its unit j over K
// in ascending order with FMAs.  Ends with a __syncthreads.
__device__ __forceinline__ void carry_products(float* smem, const float* a_h, const float* a_x,
                                               const float* w_h, const float* w_x, int G,
                                               int n_mt, int j0) {
  const int rows = n_mt * 16;
  const int j = threadIdx.x % rst::kJT, rg = threadIdx.x / rst::kJT;
  const int n_k = G / kFKC;
  const int n_ah = a_h != nullptr ? n_k : 0;
  const int n_chunks = n_ah + (a_x != nullptr ? n_k : 0);
  float acc_h[8], acc_x[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc_h[i] = acc_x[i] = 0.0f;

  auto load = [&](int c) {
    float* As = smem + (c & 1) * kFStage;
    const bool hpart = c < n_ah;
    stage_f32(As, As + rst::kRows * kFLd, hpart ? a_h : a_x, hpart ? w_h : w_x,
              (hpart ? c : c - n_ah) * kFKC, rows, G, j0);
  };
  if (n_chunks > 0) load(0);
  rst::cp_async_commit();
  for (int c = 0; c < n_chunks; ++c) {
    if (c + 1 < n_chunks) load(c + 1);
    rst::cp_async_commit();
    rst::cp_async_wait<1>();  // chunk c has landed
    __syncthreads();
    const float* As = smem + (c & 1) * kFStage;
    const float* Ws = As + rst::kRows * kFLd;
    const bool hpart = c < n_ah;
    float sum[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) sum[i] = hpart ? acc_h[i] : acc_x[i];
#pragma unroll 4
    for (int k = 0; k < kFKC; k += 4) {
      const float4 wv = *reinterpret_cast<const float4*>(Ws + j * kFLd + k);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 av = *reinterpret_cast<const float4*>(As + (rg + 8 * i) * kFLd + k);
        sum[i] = fmaf(av.x, wv.x, sum[i]);
        sum[i] = fmaf(av.y, wv.y, sum[i]);
        sum[i] = fmaf(av.z, wv.z, sum[i]);
        sum[i] = fmaf(av.w, wv.w, sum[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (hpart) {
        acc_h[i] = sum[i];
      } else {
        acc_x[i] = sum[i];
      }
    }
    __syncthreads();  // before the next iteration overwrites this stage
  }
  rst::cp_async_wait<0>();

  float* ph = smem;                     // [kRows][kJT]
  float* px = ph + rst::kRows * rst::kJT;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    ph[(rg + 8 * i) * rst::kJT + j] = acc_h[i];
    px[(rg + 8 * i) * rst::kJT + j] = acc_x[i];
  }
  __syncthreads();
}

// s < T + L - 1: one reverse diagonal.  s == T + L - 1: the final pass
// that turns each layer's dh carry into dh0.
template <typename T, typename R>
__global__ void __launch_bounds__(rst::kThreads) wavefront_bwd_step(int s, BwdArgs<T, R> p) {
  __shared__ __align__(128) bf16 smem[2 * kStage];

  const int T_ = p.T, B = p.B, Bp = p.Bp, H = p.H, L = p.L;
  const int l = blockIdx.z;
  const bool final_pass = s == T_ + L - 1;
  const int off = L - 1 - l;
  const int t = T_ - 1 - (s - off);
  if (!final_pass && (s < off || t < 0)) return;  // uniform over the block
  const int G = 4 * H;
  const size_t pplane = (size_t)Bp * G;
  const int j0 = blockIdx.x * rst::kJT;
  const int row0 = blockIdx.y * rst::kRows;
  const int n_mt = min(rst::kMaxMT, (Bp - row0) / 16);
  const int rows = n_mt * 16;

  // The previous diagonal's dgates: layer l's at t+1 and layer l+1's at t.
  // The final pass reads layer l's dgates at t = 0, from its last diagonal.
  const int rpar = final_pass ? ((T_ - 1 + off) & 1) : ((s + 1) & 1);
  const T* a_h = (final_pass || t < T_ - 1)
                     ? p.par + (size_t)(rpar * L + l) * pplane + (size_t)row0 * G
                     : nullptr;
  const T* a_x = (!final_pass && l < L - 1)
                     ? p.par + (size_t)(rpar * L + l + 1) * pplane + (size_t)row0 * G
                     : nullptr;
  const T* w_h = p.w_h + (size_t)l * H * G;
  const T* w_x = l < L - 1 ? p.w_x + (size_t)l * H * G : nullptr;  // W_x of layer l+1
  if constexpr (std::is_same<T, float>::value) {
    carry_products(reinterpret_cast<float*>(smem), a_h, a_x, w_h, w_x, G, n_mt, j0);
  } else {
    carry_products(smem, a_h, a_x, w_h, w_x, G, n_mt, j0);
  }
  const float* ph = reinterpret_cast<const float*>(smem);  // [kRows][kJT]
  const float* px = ph + rst::kRows * rst::kJT;            // [kRows][kJT]

  float* dhc = p.dhc + (size_t)l * B * H;
  float* dcc = p.dcc + (size_t)l * B * H;
  if (final_pass) {
    for (int idx = threadIdx.x; idx < rows * rst::kJT; idx += rst::kThreads) {
      const int b = row0 + idx / rst::kJT;
      if (b < B) dhc[(size_t)b * H + j0 + idx % rst::kJT] += ph[idx];
    }
    return;
  }

  const size_t step = (size_t)l * T_ + t;
  R* gates = p.gates + step * B * G;
  const R* c_t = p.cseq + step * B * H;
  const R* c_p = t > 0 ? p.cseq + (step - 1) * B * H : nullptr;
  const float* c0 = p.c0 + (size_t)l * B * H;
  const R* dtop = l == L - 1 ? p.dout_top + (size_t)t * B * H : nullptr;
  const float* mask = p.mask + (size_t)t * B;
  T* wpar = p.par + (size_t)((s & 1) * L + l) * pplane;
  const size_t step_b = step * B * H;  // (l, t) plane of a (·, T, B, H) stream
  for (int idx = threadIdx.x; idx < rows * rst::kJT; idx += rst::kThreads) {
    const int r = idx / rst::kJT;
    const int b = row0 + r;
    if (b >= B) continue;
    const int j = j0 + idx % rst::kJT;
    const size_t e = (size_t)b * H + j;
    const float m = mask[b];
    float dout = dtop != nullptr ? rst::to_f(dtop[e]) : px[idx];
    if (p.xdrop != nullptr && l < L - 1) {
      // Boundary l's keep·scale at its producer's diagonal: it scales the
      // cotangent from the layer above and gives the dropped input that
      // the dW_x contraction of layer l+1 reads.
      const size_t de = step_b + e;
      const float keep =
          p.masks != nullptr
              ? rst::to_f(p.masks[de])
              : (rst::wavefront_keep(p.seed0, p.seed1, p.thr, l, t, b, j) ? 1.0f : 0.0f);
      const float ks = keep * p.scale;
      dout *= ks;
      const size_t xe =
          p.ring > 0 ? ((size_t)l * p.ring + (p.ring - 1 - s % p.ring)) * B * H + e : de;
      p.xdrop[xe] = rst::from_f<R>(rst::to_f(p.outs[de]) * ks);
    }
    const float dh_carry = dhc[e] + ph[idx];  // ph is zero at t = T-1
    const float dc_carry = dcc[e];
    R* g = gates + (size_t)b * G;
    const float i_a = rst::to_f(g[j]), g_a = rst::to_f(g[H + j]);
    const float f_a = rst::to_f(g[2 * H + j]), o_a = rst::to_f(g[3 * H + j]);
    const float tanh_c = tanhf(rst::to_f(c_t[e]));
    const float c_prev = c_p != nullptr ? rst::to_f(c_p[e]) : c0[e];
    const float dh_new = m * (dout + dh_carry);
    const float do_pre = dh_new * tanh_c * sig_grad(o_a);
    const float dc_new = dh_new * o_a * (1.0f - tanh_c * tanh_c) + m * dc_carry;
    const float di = dc_new * g_a * sig_grad(i_a);
    const float dg = dc_new * i_a * (1.0f - g_a * g_a);
    const float df = dc_new * c_prev * sig_grad(f_a);
    g[j] = rst::from_f<R>(di);
    g[H + j] = rst::from_f<R>(dg);
    g[2 * H + j] = rst::from_f<R>(df);
    g[3 * H + j] = rst::from_f<R>(do_pre);
    T* w = wpar + (size_t)b * G;
    w[j] = rst::from_f<T>(di);
    w[H + j] = rst::from_f<T>(dg);
    w[2 * H + j] = rst::from_f<T>(df);
    w[3 * H + j] = rst::from_f<T>(do_pre);
    dhc[e] = (1.0f - m) * dh_carry;
    dcc[e] = (1.0f - m) * dc_carry + dc_new * f_a;
  }
}

// The fused dW_x of the window of diagonals [s0, s1] (W wide): the
// products of csrc/dwx_windows.cuh on `path`, from the ring (drop mode 2)
// or the outs residual (mode 0).  Returns the CUDA error code.
int accumulate_dwx(const BwdArgs<bf16>& p, int s0, int s1, int W, int path, float* dwx,
                   cudaStream_t st) {
  return rst_dwx::accumulate(p.outs, p.xdrop, p.gates, p.T, p.B, p.H, p.L, s0, s1, W, path, dwx,
                             g_wgmma_products, st);
}

template <typename T, typename R = T>
int launch(const void* dout_top, const void* w_h, const void* w_x, const float* mask,
           void* gates, const void* cseq, const float* c0, void* par, float* dhc, float* dcc,
           int T_, int B, int H, int L, int drop_mode, const void* masks, const void* outs,
           void* xdrop, unsigned seed0, unsigned seed1, unsigned thr, float scale, int window,
           float* dwx, int dwx_path, void* stream) {
  if (window > 0 && (drop_mode == 1 || dwx == nullptr || outs == nullptr ||
                     !std::is_same<T, bf16>::value || !std::is_same<R, bf16>::value)) {
    return (int)cudaErrorInvalidValue;
  }
  BwdArgs<T, R> p;
  p.dout_top = static_cast<const R*>(dout_top);
  p.w_h = static_cast<const T*>(w_h);
  p.w_x = static_cast<const T*>(w_x);
  p.mask = mask;
  p.gates = static_cast<R*>(gates);
  p.cseq = static_cast<const R*>(cseq);
  p.c0 = c0;
  p.par = static_cast<T*>(par);
  p.dhc = dhc;
  p.dcc = dcc;
  p.T = T_;
  p.B = B;
  p.Bp = (B + 15) / 16 * 16;
  p.H = H;
  p.L = L;
  p.masks = drop_mode == 1 ? static_cast<const bf16*>(masks) : nullptr;
  p.outs = static_cast<const R*>(outs);
  p.xdrop = drop_mode != 0 ? static_cast<R*>(xdrop) : nullptr;
  p.ring = window > 0 ? window : 0;
  p.seed0 = seed0;
  p.seed1 = seed1;
  p.thr = thr;
  p.scale = scale;
  const dim3 grid(H / rst::kJT, (p.Bp + rst::kRows - 1) / rst::kRows, L);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_diag = T_ + L - 1;
  for (int s = 0; s < T_ + L; ++s) {
    wavefront_bwd_step<T, R><<<grid, rst::kThreads, 0, st>>>(s, p);
    if (s == 0) {
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    if constexpr (std::is_same<T, bf16>::value && std::is_same<R, bf16>::value) {
      if (window > 0 && s < n_diag && ((s + 1) % window == 0 || s == n_diag - 1)) {
        const int err = accumulate_dwx(p, s - s % window, s, window, dwx_path, dwx, st);
        if (err != 0) return err;
      }
    }
  }
  return (int)cudaGetLastError();
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
  return launch<bf16>(dout_top, w_h, w_x, mask, gates, cseq, c0, par, dhc, dcc, T, B, H, L,
                      drop_mode, masks, outs, xdrop, seed0, seed1, thr, scale, window, dwx,
                      dwx_path, stream);
}

// Float32 compute, unfused: as above with dout_top, the weights, gates,
// cseq, par, outs and xdrop float32 (masks stay bf16); no window.
extern "C" int rst_lstm_wavefront_bwd_f32(const void* dout_top, const void* w_h,
                                          const void* w_x, const float* mask, void* gates,
                                          const void* cseq, const float* c0, void* par,
                                          float* dhc, float* dcc, int T, int B, int H, int L,
                                          int drop_mode, const void* masks, const void* outs,
                                          void* xdrop, unsigned seed0, unsigned seed1,
                                          unsigned thr, float scale, void* stream) {
  return launch<float>(dout_top, w_h, w_x, mask, gates, cseq, c0, par, dhc, dcc, T, B, H, L,
                       drop_mode, masks, outs, xdrop, seed0, seed1, thr, scale, 0, nullptr, 0,
                       stream);
}

// Mixed compute and residual types, unfused: as rst_lstm_wavefront_bwd_f32
// with the weights and par in the compute type and dout_top, gates, cseq,
// outs and xdrop in the residual type (``_bf16_f32``: bf16 compute, float32
// residuals; ``_f32_bf16``: the reverse).
extern "C" int rst_lstm_wavefront_bwd_bf16_f32(
    const void* dout_top, const void* w_h, const void* w_x, const float* mask, void* gates,
    const void* cseq, const float* c0, void* par, float* dhc, float* dcc, int T, int B, int H,
    int L, int drop_mode, const void* masks, const void* outs, void* xdrop, unsigned seed0,
    unsigned seed1, unsigned thr, float scale, void* stream) {
  return launch<bf16, float>(dout_top, w_h, w_x, mask, gates, cseq, c0, par, dhc, dcc, T, B, H,
                             L, drop_mode, masks, outs, xdrop, seed0, seed1, thr, scale, 0,
                             nullptr, 0, stream);
}

extern "C" int rst_lstm_wavefront_bwd_f32_bf16(
    const void* dout_top, const void* w_h, const void* w_x, const float* mask, void* gates,
    const void* cseq, const float* c0, void* par, float* dhc, float* dcc, int T, int B, int H,
    int L, int drop_mode, const void* masks, const void* outs, void* xdrop, unsigned seed0,
    unsigned seed1, unsigned thr, float scale, void* stream) {
  return launch<float, bf16>(dout_top, w_h, w_x, mask, gates, cseq, c0, par, dhc, dcc, T, B, H,
                             L, drop_mode, masks, outs, xdrop, seed0, seed1, thr, scale, 0,
                             nullptr, 0, stream);
}

// Window products launched on the Hopper tile so far.
extern "C" long long rst_wgmma_products() { return g_wgmma_products; }

// The pass's window products alone, as drop mode 0 runs them: outs (L, T,
// B, H) and dgates (L, T, B, 4H) bf16; dwx (L-1, H, 4H) f32 receives, window
// by window, dW_x of layers 1..L-1 from outs (for timing and tests).
extern "C" int rst_dwx_windows(const void* outs, const void* dgates, int T, int B, int H,
                               int L, int window, float* dwx, int dwx_path, void* stream) {
  BwdArgs<bf16> p = {};
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
