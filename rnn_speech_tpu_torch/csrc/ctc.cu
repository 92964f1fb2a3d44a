// CTC alpha and beta recursions, for Hopper (sm_90a).
//
// Replaces three TPU kernels of rnn_speech_tpu/ops/ctc_pallas.py:
//   `_alpha_kernel_ckpt`     the training forward: alpha over time, one
//                            (B, S) f32 checkpoint per K steps and the last
//                            row (rst_ctc_alpha with ckpt != null);
//   `_alpha_kernel_lossonly` the same recursion, last row only (eval loss;
//                            rst_ctc_alpha with ckpt == null);
//   `_beta_post_ckpt_kernel` the backward: each K-step block's alpha rows
//                            rebuilt from its checkpoint, beta in the
//                            bstar = beta + lp form, the state posteriors
//                            exp(min(alpha + beta - logP, 0)) (rst_ctc_beta_post).
// and the two of its alpha-stream backward (RST_CTC_ALPHA_STREAM=1):
//   `_alpha_kernel`          every alpha row into a (T, B, S) f32 stream and
//                            the last row (rst_ctc_alpha_stream: the same
//                            recursion as the checkpoint kernel, a store per
//                            step instead of per K steps);
//   `_beta_post_kernel`      beta, the posteriors and their per-label sums as
//                            rst_ctc_beta_post, each alpha row read from the
//                            stream instead of rebuilt (rst_ctc_beta_post_stream).
// S = 2U + 1 extended states (labels interleaved with blanks), -1e30 for
// -inf, log_add3 with m_safe, the freeze past each row's input length and
// the t = 0 seeding are the TPU kernels'.
//
// What differs from the TPU design, and why.  The TPU builds the (B, T, S)
// f32 lattice lp_ext with a one-hot matmul to avoid gathers, and chunks
// over time to fit its HBM; here each block gathers log_probs[t, b, ext[s]]
// straight from the (T, B, V) log-probs (72 MB at the flagship shape), so
// no lattice exists.  The posteriors are not streamed out as (B, T, S):
// the backward sums them over the states of each vocabulary entry into
// label_post (T, B, V), each entry v walking its own sorted list of states
// (offs/idx, built by the wrapper) in a fixed order, so the gradient
// repeats bit for bit.  States past 2·label_length cannot reach the
// terminal states (transitions only go up in s), so their posteriors are 0
// in the TPU kernels too; both recursions run only the live states
// s < 2·label_length + 1 of each row and leave the others at -1e30.
//
// What bounds it on the H100: each pass is a serial chain of T dependent
// steps per row; the work (~10 flops and 4 transcendentals per live state
// and step) and bytes (the gathered log-probs) are far below a millisecond.
// What this design does about it: one block of 256 threads per batch row
// (64 blocks at B = 64), the alpha row, ext and the skip flags in shared
// memory, one barrier per time step (rows double-buffered by parity), and
// in the backward a K-row block of rebuilt alpha in shared memory (K = 32:
// 154 KB at S = 1201).  The stream pair moves 1.08 GB of f32 alpha rows at
// the flagship shape (B = 64, T = 3510, S = 1201), 0.32 ms at 3.35 TB/s:
// still far below the serial chain, so the same design; each step's row
// store (alpha) or load (beta) is coalesced across the block's threads.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kNegInf = -1.0e30f;
constexpr int kThreads = 256;

__device__ __forceinline__ float log_add3(float a, float b, float c) {
  const float m = fmaxf(fmaxf(a, b), c);
  const float ms = fmaxf(m, kNegInf);
  const float out = ms + logf(expf(a - ms) + expf(b - ms) + expf(c - ms));
  return m <= kNegInf ? kNegInf : out;
}

// One alpha step at state s from the previous row.
__device__ __forceinline__ float alpha_step(const float* prev, int s, bool skip,
                                           float lp) {
  const float a1 = s >= 1 ? prev[s - 1] : kNegInf;
  const float a2 = (s >= 2 && skip) ? prev[s - 2] : kNegInf;
  return log_add3(prev[s], a1, a2) + lp;
}

// What the alpha pass keeps: the last row only, a checkpoint every K
// steps, or every row (the stream).
enum AlphaOut { kLastOnly = 0, kCkpt = 1, kStream = 2 };

template <int kOut>
__global__ void __launch_bounds__(kThreads)
    ctc_alpha(const float* __restrict__ lp, const int* __restrict__ ext,
              const uint8_t* __restrict__ skip, const int* __restrict__ logit_len,
              const int* __restrict__ label_len, float* __restrict__ ckpt,
              float* __restrict__ last, int T, int B, int S, int V, int K) {
  extern __shared__ float smem[];
  float* buf = smem;                                    // [2][S]
  int* ext_s = reinterpret_cast<int*>(buf + 2 * S);     // [S]
  uint8_t* skip_s = reinterpret_cast<uint8_t*>(ext_s + S);
  const int b = blockIdx.x;
  const int Tb = logit_len[b];
  const int Sb = min(S, 2 * label_len[b] + 1);
  for (int s = threadIdx.x; s < S; s += kThreads) {
    ext_s[s] = ext[(size_t)b * S + s];
    skip_s[s] = skip[(size_t)b * S + s];
    buf[s] = kNegInf;
    buf[S + s] = kNegInf;
  }
  __syncthreads();
  // Checkpoint i is the row after step t = iK + K - 1 (or T - 1); the
  // stream keeps row t at index t.
  auto store_ckpt = [&](const float* row, int t) {
    if (kOut == kStream || (kOut == kCkpt && ((t + 1) % K == 0 || t == T - 1))) {
      float* dst = ckpt + ((size_t)(kOut == kStream ? t : t / K) * B + b) * S;
      for (int s = threadIdx.x; s < S; s += kThreads) dst[s] = row[s];
    }
  };
  {
    const float* row = lp + (size_t)b * V;  // t = 0: seed states 0 and 1
    for (int s = threadIdx.x; s < Sb && s < 2; s += kThreads) buf[s] = row[ext_s[s]];
  }
  __syncthreads();
  store_ckpt(buf, 0);
  int cur = 0;
  for (int t = 1; t < T; ++t) {
    const float* row = lp + ((size_t)t * B + b) * V;
    const float* prev = buf + cur * S;
    float* nxt = buf + (cur ^ 1) * S;
    const bool live = t < Tb;
    for (int s = threadIdx.x; s < Sb; s += kThreads) {
      nxt[s] = live ? alpha_step(prev, s, skip_s[s], row[ext_s[s]]) : prev[s];
    }
    __syncthreads();
    cur ^= 1;
    store_ckpt(nxt, t);
  }
  for (int s = threadIdx.x; s < S; s += kThreads) last[(size_t)b * S + s] = buf[cur * S + s];
}

// kStream: `alphas` is the (T, B, S) alpha stream and row t is read from
// it; else `alphas` holds the checkpoints and each K-step block's rows are
// rebuilt in shared memory.
template <bool kStream>
__global__ void __launch_bounds__(kThreads)
    ctc_beta_post(const float* __restrict__ lp, const int* __restrict__ ext,
                  const uint8_t* __restrict__ skip, const int* __restrict__ logit_len,
                  const int* __restrict__ label_len, const float* __restrict__ logp,
                  const float* __restrict__ alphas, const int* __restrict__ offs,
                  const int* __restrict__ idx, float* __restrict__ label_post, int T,
                  int B, int S, int V, int K) {
  extern __shared__ float smem[];
  float* alpha = smem;                                  // [K][S], none for kStream
  float* post = alpha + (kStream ? 0 : (size_t)K * S);  // [2][S]
  float* bstar = post + 2 * S;                          // [2][S + 2]
  int* ext_s = reinterpret_cast<int*>(bstar + 2 * (S + 2));  // [S]
  int* idx_s = ext_s + S;                               // [S]
  int* offs_s = idx_s + S;                              // [V + 1]
  uint8_t* skip_s = reinterpret_cast<uint8_t*>(offs_s + V + 1);  // [S]
  const int b = blockIdx.x;
  const int Tb = logit_len[b];
  const int L = label_len[b];
  const int Sb = min(S, 2 * L + 1);
  const int end = 2 * L;
  const float logp_b = logp[b];
  for (int s = threadIdx.x; s < S; s += kThreads) {
    ext_s[s] = ext[(size_t)b * S + s];
    idx_s[s] = idx[(size_t)b * S + s];
    skip_s[s] = skip[(size_t)b * S + s];
  }
  for (int s = threadIdx.x; s < 2 * (S + 2); s += kThreads) bstar[s] = kNegInf;
  for (int v = threadIdx.x; v <= V; v += kThreads) offs_s[v] = offs[(size_t)b * (V + 1) + v];
  __syncthreads();

  int par = 0;  // bstar + par·(S+2) holds beta_{t+1} + lp_{t+1}
  const int NI = (T + K - 1) / K;
  for (int i = NI - 1; i >= 0; --i) {
    const int t0 = i * K;
    const int nk = min(K, T - t0);
    // Rebuild this block's alpha rows from the previous block's checkpoint.
    for (int k = 0; k < nk && !kStream; ++k) {
      const int t = t0 + k;
      const float* row = lp + ((size_t)t * B + b) * V;
      float* dst = alpha + (size_t)k * S;
      if (t == 0) {
        for (int s = threadIdx.x; s < Sb; s += kThreads) {
          dst[s] = s < 2 ? row[ext_s[s]] : kNegInf;
        }
      } else {
        const float* prev = k == 0 ? alphas + ((size_t)(i - 1) * B + b) * S
                                   : alpha + (size_t)(k - 1) * S;
        const bool live = t < Tb;
        for (int s = threadIdx.x; s < Sb; s += kThreads) {
          dst[s] = live ? alpha_step(prev, s, skip_s[s], row[ext_s[s]]) : prev[s];
        }
      }
      __syncthreads();
    }
    // Beta in reverse time, the posteriors, and their sums per label.
    for (int k = nk - 1; k >= 0; --k) {
      const int t = t0 + k;
      const float* row = lp + ((size_t)t * B + b) * V;
      const float* bs = bstar + par * (S + 2);
      float* bn = bstar + (par ^ 1) * (S + 2);
      float* pp = post + (t & 1) * S;
      const bool live = t < Tb;
      const bool islast = t == Tb - 1;
      const float* arow = kStream ? alphas + ((size_t)t * B + b) * S : alpha + (size_t)k * S;
      for (int s = threadIdx.x; s < Sb; s += kThreads) {
        float beta;
        if (islast) {
          beta = (s == end || (s == end - 1 && L > 0)) ? 0.0f : kNegInf;
        } else {
          const bool skip2 = s + 2 < S && skip_s[s + 2];
          beta = log_add3(bs[s], bs[s + 1], skip2 ? bs[s + 2] : kNegInf);
        }
        const float gamma = arow[s] + beta - logp_b;
        pp[s] = live ? expf(fminf(gamma, 0.0f)) : 0.0f;
        bn[s] = beta + row[ext_s[s]];
      }
      __syncthreads();
      for (int v = threadIdx.x; v < V; v += kThreads) {
        const int j0 = offs_s[v], j1 = offs_s[v + 1];
        float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
        int j = j0;
        for (; j + 4 <= j1; j += 4) {
          a0 += pp[idx_s[j]];
          a1 += pp[idx_s[j + 1]];
          a2 += pp[idx_s[j + 2]];
          a3 += pp[idx_s[j + 3]];
        }
        for (; j < j1; ++j) a0 += pp[idx_s[j]];
        label_post[((size_t)t * B + b) * V + v] = (a0 + a1) + (a2 + a3);
      }
      par ^= 1;
    }
  }
}

size_t beta_smem_bytes(int S, int V, int K) {
  return sizeof(float) * ((size_t)K * S + 2 * S + 2 * (S + 2)) +
         sizeof(int) * (2 * (size_t)S + V + 1) + S;
}

template <int kOut>
int launch_alpha(const float* lp, const int* ext, const uint8_t* skip, const int* logit_len,
                 const int* label_len, float* ckpt, float* last, int T, int B, int S, int V,
                 int K, void* stream) {
  const size_t smem = sizeof(float) * 2 * (size_t)S + sizeof(int) * (size_t)S + S;
  cudaError_t err = cudaFuncSetAttribute(
      ctc_alpha<kOut>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ctc_alpha<kOut><<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      lp, ext, skip, logit_len, label_len, ckpt, last, T, B, S, V, K);
  return (int)cudaGetLastError();
}

template <bool kStream>
int launch_beta_post(const float* lp, const int* ext, const uint8_t* skip,
                     const int* logit_len, const int* label_len, const float* logp,
                     const float* alphas, const int* offs, const int* idx,
                     float* label_post, int T, int B, int S, int V, int K, void* stream) {
  const size_t smem = beta_smem_bytes(S, V, kStream ? 0 : K);
  cudaError_t err = cudaFuncSetAttribute(
      ctc_beta_post<kStream>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ctc_beta_post<kStream><<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      lp, ext, skip, logit_len, label_len, logp, alphas, offs, idx, label_post, T, B, S, V,
      K);
  return (int)cudaGetLastError();
}

}  // namespace

// lp (T, B, V) f32 log-probs; ext (B, S) int32 extended labels; skip (B, S)
// uint8 (the s-2 -> s transition is allowed); logit_len, label_len (B)
// int32.  ckpt (ceil(T/K), B, S) f32 or null (loss only); last (B, S) f32.
// Returns the CUDA error code of the launch (0 = success).
extern "C" int rst_ctc_alpha(const float* lp, const int* ext, const uint8_t* skip,
                             const int* logit_len, const int* label_len, float* ckpt,
                             float* last, int T, int B, int S, int V, int K,
                             void* stream) {
  if (ckpt != nullptr) {
    return launch_alpha<kCkpt>(lp, ext, skip, logit_len, label_len, ckpt, last, T, B, S, V,
                               K, stream);
  }
  return launch_alpha<kLastOnly>(lp, ext, skip, logit_len, label_len, nullptr, last, T, B,
                                 S, V, K, stream);
}

// The same inputs; alphas (T, B, S) f32 receives every alpha row (the
// stream of `_alpha_kernel`), last (B, S) the last one.
extern "C" int rst_ctc_alpha_stream(const float* lp, const int* ext, const uint8_t* skip,
                                    const int* logit_len, const int* label_len,
                                    float* alphas, float* last, int T, int B, int S, int V,
                                    void* stream) {
  return launch_alpha<kStream>(lp, ext, skip, logit_len, label_len, alphas, last, T, B, S,
                               V, 1, stream);
}

// Also logp (B) f32, the rows' log-likelihoods; ckpt from rst_ctc_alpha;
// offs (B, V+1) and idx (B, S) int32: row b's live states sorted by label,
// entry v's states being idx[b, offs[b, v] .. offs[b, v+1]).  label_post
// (T, B, V) f32 receives Σ_{s : ext[s] = v} posterior(t, s).
extern "C" int rst_ctc_beta_post(const float* lp, const int* ext, const uint8_t* skip,
                                 const int* logit_len, const int* label_len,
                                 const float* logp, const float* ckpt, const int* offs,
                                 const int* idx, float* label_post, int T, int B, int S,
                                 int V, int K, void* stream) {
  return launch_beta_post<false>(lp, ext, skip, logit_len, label_len, logp, ckpt, offs, idx,
                                 label_post, T, B, S, V, K, stream);
}

// The same with alphas (T, B, S) f32 from rst_ctc_alpha_stream in place of
// the checkpoints (`_beta_post_kernel`): no rebuild, the alpha row of each
// step read from the stream.
extern "C" int rst_ctc_beta_post_stream(const float* lp, const int* ext, const uint8_t* skip,
                                        const int* logit_len, const int* label_len,
                                        const float* logp, const float* alphas,
                                        const int* offs, const int* idx, float* label_post,
                                        int T, int B, int S, int V, void* stream) {
  return launch_beta_post<true>(lp, ext, skip, logit_len, label_len, logp, alphas, offs, idx,
                                label_post, T, B, S, V, 32, stream);
}

// Dynamic shared memory of rst_ctc_beta_post at (S, V, K), in bytes.
extern "C" long long rst_ctc_beta_smem(int S, int V, int K) {
  return (long long)beta_smem_bytes(S, V, K);
}
