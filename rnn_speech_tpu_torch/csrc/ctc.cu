// CTC alpha and beta recursions, for Hopper (sm_90a).
//
// Replaces five TPU kernels of rnn_speech_tpu/ops/ctc_pallas.py, three
// forwards on one kernel (`ctc_alpha_fwd`, entry rst_ctc_alpha_fwd) in three
// output modes:
//   `_alpha_kernel_ckpt`     the training forward: alpha over time, one
//                            (B, S) f32 checkpoint per K steps and the last
//                            row;
//   `_alpha_kernel_lossonly` the same recursion, last row only (eval loss);
//   `_alpha_kernel`          every alpha row into a (T, B, S) f32 stream and
//                            the last row (the alpha-stream backward,
//                            RST_CTC_ALPHA_STREAM=1: checkpoints of K = 1);
// and the two backwards:
//   `_beta_post_ckpt_kernel` each K-step block's alpha rows rebuilt from its
//                            checkpoint, beta in the bstar = beta + lp form,
//                            the state posteriors exp(min(alpha + beta -
//                            logP, 0)) (rst_ctc_beta_post);
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
// from the (T, B, V) log-probs (72 MB at the flagship shape), so no
// lattice exists.  The posteriors are not streamed out as (B, T, S): the
// backward sums them over the states of each vocabulary entry into
// label_post (T, B, V), each entry v walking its own sorted list of states
// (offs/idx, built by the wrapper) in a fixed order, so the gradient
// repeats bit for bit.  States past 2·label_length cannot reach the
// terminal states (transitions only go up in s), so their posteriors are 0
// in the TPU kernels too; both recursions run only the live states
// s < 2·label_length + 1 of each row and leave the others at -1e30.
//
// What bounds it on the H100: each pass is a serial chain of T dependent
// steps per row, one block per row (64 of the 132 SMs at B = 64); the work
// (~10 flops and 4 transcendentals per live state and step) and bytes (the
// log-probs, the outputs) are far below a millisecond, except the stream's
// 1.08 GB of f32 rows at the flagship shape (B = 64, T = 3510, S = 1201):
// 0.32 ms at 3.35 TB/s, which the chain's time covers.
//
// The forward keeps device memory off the chain: a producer warp copies
// each coming step's log-prob row (V contiguous floats) into a shared ring
// of slots of four rows by cp.async, completing on an mbarrier per slot,
// so the gather ext[s] reads shared memory and the chain waits on a
// barrier once every four steps; each thread owns kP consecutive states
// and keeps their alpha in registers, computes all kP of them and then
// selects the live ones (a branch around each would run them one after
// another), the s-1 and s-2 neighbours come by warp shuffle and only each
// warp's last two states pass through shared memory, behind one named
// barrier a step among the warps that hold live states (the producer stays
// out of it); output rows are stored from registers (kP consecutive floats
// a thread), and the warps without a live state write the rows' dead
// states, -1e30, 16 bytes a store, beside the chain; the recursion stops
// at the row's last live step, then writes that row into the remaining
// output rows and `last`, which is what the freeze (`live ? ... : prev`)
// gives.  Each step is `alpha_step`'s arithmetic on the same operands, so
// the three modes' rows equal each other, and the backward's rebuilt rows,
// bit for bit.
//
// The backward (`_beta_post_ckpt_kernel`, and the stream form) was 1.6x
// F.ctc_loss's whole forward + backward on the H100 with that design plus a
// serial per-label sum: the blank's list (L + 1 = 251 states at labels of
// 250) was walked by one thread every step, two dependent shared loads a
// state, and each K-step block's alpha rebuild ran before its beta pass,
// on the same threads.  What the design does now: the blank's posteriors
// by a fixed tree (every thread its even states, warp shuffles, eight warp
// sums in order); the other labels' short lists of odd states walked in
// the tick after their step, beside the next step; a second group of 256
// threads rebuilding the next block's alpha rows while beta walks this
// one, in ONE K-row buffer (S = 1201: 154 KB at K = 32) that the rebuild
// refills in the order beta frees it (blocks stored in alternating
// orientation), so neither K nor the checkpoints change (double buffering
// 2·K·S rows does not fit at K = 32, and halving K would double the
// forward's checkpoints); each thread's log-probs loaded a step ahead.
// One __syncthreads a tick serves beta's row exchange, the rebuild's row
// dependence and the handshake between the groups.  The stream pair moves
// 1.08 GB of f32 alpha rows at the flagship shape (B = 64, T = 3510,
// S = 1201), 0.32 ms at 3.35 TB/s: still far below the serial chain, so
// the same design, alpha entries loaded a step ahead too.

#include <cuda_runtime.h>

#include <cstdint>

#include "grad_matmul.cuh"   // the mbarrier helpers (rst_grad::tma)

namespace {

namespace tma = rst_grad::tma;

constexpr float kNegInf = -1.0e30f;

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

// ------------------------------------------------ the alpha forward

constexpr int kSlotRows = 4;   // log-prob rows a ring slot holds: one wait per 4 steps

// Shared memory of ctc_alpha_fwd: the ring's mbarriers, the warps' last two
// states by step parity, the ring of slots of kSlotRows log-prob rows.
size_t alpha_fwd_smem_bytes(int threads, int ring, int V) {
  return 2 * sizeof(uint64_t) * (size_t)ring + sizeof(float) * 4 * (size_t)(threads / 32) +
         sizeof(float) * (size_t)ring * kSlotRows * V;
}

// The alpha recursion over t for one batch row a block, in one of three
// output modes: `rows` null, the last row only (row 10); K > 1, the row
// after each step t = iK + K - 1 (or T - 1) into checkpoint i (row 9);
// K = 1, every row (the stream, row 11).  `last` gets the last row.
//
// Block: `nc` compute threads (warps 0 .. nc/32 - 1, kP states each:
// thread i owns states kP·i .. kP·i + kP - 1) and one producer warp after
// them.  Shared memory: a full and an empty mbarrier per ring slot, the
// warps' last two states by step parity, the ring of `ring` slots of
// kSlotRows log-prob rows (steps 4j .. 4j + 3 in slot j % ring).  Warps
// whose states all lie past the row's 2U + 1 write -1e30 into every
// output row, 16 bytes a store, and leave; the row's `nwa` live warps
// meet at one named barrier a step.  Every index that advances with t is
// a counter, so no step divides.
// fault_step > 0 is a planted fault for checks: that step's log-prob row
// is taken from step fault_step - 1.
template <int kP>
__global__ void __launch_bounds__(1024, 1)
    ctc_alpha_fwd(const float* __restrict__ lp, const int* __restrict__ ext,
                  const uint8_t* __restrict__ skip, const int* __restrict__ logit_len,
                  const int* __restrict__ label_len, float* __restrict__ rows_out,
                  float* __restrict__ last, int T, int B, int S, int V, int K, int ring,
                  int fault_step) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nc = blockDim.x - 32;
  const int nw = nc / 32;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw);   // [ring]: slot landed
  uint64_t* empty = full + ring;                            // [ring]: slot consumed
  float* edge = reinterpret_cast<float*>(empty + ring);     // [2][nw][2]
  float* rows = edge + 4 * nw;                              // [ring][kSlotRows][V]
  const int b = blockIdx.x;
  const int Sb = min(S, 2 * label_len[b] + 1);
  // Rows 0 .. t_end - 1 are computed; every later row equals row t_end - 1.
  const int t_end = min(T, max(logit_len[b], 1));
  const int NI = rows_out != nullptr ? (T + K - 1) / K : 0;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < ring; ++i) {
      // One cp.async arrive per producer lane; compute thread 0 after a
      // slot's last step.
      tma::bar_init(tma::smem_addr(&full[i]), 32);
      tma::bar_init(tma::smem_addr(&empty[i]), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= nc) {   // the producer warp: rows 0 .. t_end - 1 into the ring
    const int lane = tid - nc;
    uint32_t par = 1;   // the empty barriers' first round passes
    for (int t0 = 0, slot = 0; t0 < t_end; t0 += kSlotRows) {
      tma::bar_wait(tma::smem_addr(&empty[slot]), par);
      float* dst = rows + (size_t)slot * kSlotRows * V;
      for (int r = 0; r < kSlotRows && t0 + r < t_end; ++r) {
        const int t = t0 + r;
        const int src = fault_step > 0 && t == fault_step ? t - 1 : t;
        const float* row = lp + ((size_t)src * B + b) * V;
        for (int v = lane; v < V; v += 32) {
          asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                           tma::smem_addr(dst + r * V + v)),
                       "l"(row + v)
                       : "memory");
        }
      }
      asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                       tma::smem_addr(&full[slot]))
                   : "memory");
      if (++slot == ring) {
        slot = 0;
        par ^= 1;
      }
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
    return;
  }

  const int warp = tid / 32, lane = tid % 32;
  const int s0 = tid * kP;
  float* out = rows_out + (size_t)b * S;   // output row i: out + i·B·S
  auto store = [&](float* dst, const float (&a)[kP]) {
#pragma unroll
    for (int j = 0; j < kP; ++j) {
      if (s0 + j < S) dst[s0 + j] = a[j];
    }
  };
  float a[kP];
#pragma unroll
  for (int j = 0; j < kP; ++j) a[j] = kNegInf;
  const int nwa = ((Sb + kP - 1) / kP + 31) / 32;
  if (warp >= nwa) {
    // States 32·nwa·kP .. S - 1 hold no live state: -1e30 in every output
    // row and in last, written by these warps together, 16 bytes a store.
    const int d0 = 32 * nwa * kP, nd = S - d0;
    const int lid = tid - 32 * nwa, nt = nc - 32 * nwa;
    auto fill = [&](float* p) {
      const int head = min(nd, (int)((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15) / 4);
      const int n4 = (nd - head) / 4;
      float4* q = reinterpret_cast<float4*>(p + head);
      if (lid < head) p[lid] = kNegInf;
      for (int k = lid; k < n4; k += nt) q[k] = make_float4(kNegInf, kNegInf, kNegInf, kNegInf);
      const int k = head + 4 * n4 + lid;
      if (k < nd) p[k] = kNegInf;
    };
    for (int i = 0; i < NI; ++i) fill(out + (size_t)i * B * S + d0);
    fill(last + (size_t)b * S + d0);
    return;
  }
  const int nbar = 32 * nwa;
  int e[kP];
  bool sk[kP];
#pragma unroll
  for (int j = 0; j < kP; ++j) {
    const int s = s0 + j;
    e[j] = s < Sb ? ext[(size_t)b * S + s] : 0;
    sk[j] = s < Sb && s >= 2 && skip[(size_t)b * S + s];
  }
  int slot = 0, r = 0;     // step t's row: row r of ring slot `slot`
  uint32_t par = 0;        // the slot's full phase
  int out_t = NI > 0 ? K - 1 : T;   // the step of the next output row
  float* out_row = out;
  auto store_row = [&](int t) {
    if (t == out_t) {
      store(out_row, a);
      out_row += (size_t)B * S;
      out_t += K;
    }
  };
  // t = 0: seed states 0 and 1.
  tma::bar_wait(tma::smem_addr(&full[0]), 0);
#pragma unroll
  for (int j = 0; j < kP; ++j) {
    if (s0 + j < Sb && s0 + j < 2) a[j] = rows[e[j]];
  }
  if (lane == 31) {
    edge[2 * warp] = a[kP - 2];
    edge[2 * warp + 1] = a[kP - 1];
  }
  store_row(0);
  asm volatile("bar.sync 1, %0;" ::"r"(nbar) : "memory");
  for (int t = 1; t < t_end; ++t) {
    if (++r == kSlotRows) {
      r = 0;
      if (++slot == ring) {
        slot = 0;
        par ^= 1;
      }
      tma::bar_wait(tma::smem_addr(&full[slot]), par);
    }
    const float* row = rows + ((size_t)slot * kSlotRows + r) * V;
    float lpv[kP];
#pragma unroll
    for (int j = 0; j < kP; ++j) lpv[j] = row[e[j]];
    // States s0 - 1 and s0 - 2 of the previous row: the thread before this
    // one, by shuffle, or the previous warp's last thread, from shared memory.
    float l1 = __shfl_up_sync(0xffffffffu, a[kP - 1], 1);
    float l2 = __shfl_up_sync(0xffffffffu, a[kP - 2], 1);
    if (lane == 0) {
      const float* pe = edge + ((t - 1) & 1) * 2 * nw + 2 * max(warp - 1, 0);
      l1 = warp > 0 ? pe[1] : kNegInf;
      l2 = warp > 0 ? pe[0] : kNegInf;
    }
    float n[kP];
#pragma unroll
    for (int j = 0; j < kP; ++j) {
      const int s = s0 + j;
      const float p1 = j >= 1 ? a[j - 1] : l1;
      const float p2 = j >= 2 ? a[j - 2] : (j == 1 ? l1 : l2);
      const float a1 = s >= 1 ? p1 : kNegInf;
      const float a2 = sk[j] ? p2 : kNegInf;
      // Computed for every state, then selected: a branch around it
      // would run a thread's states one after another.
      const float v = log_add3(a[j], a1, a2) + lpv[j];
      n[j] = s < Sb ? v : a[j];
    }
#pragma unroll
    for (int j = 0; j < kP; ++j) a[j] = n[j];
    if (lane == 31) {
      float* pe = edge + (t & 1) * 2 * nw + 2 * warp;
      pe[0] = a[kP - 2];
      pe[1] = a[kP - 1];
    }
    store_row(t);
    asm volatile("bar.sync 1, %0;" ::"r"(nbar) : "memory");
    if (tid == 0 && r == kSlotRows - 1) {
      tma::bar_arrive(tma::smem_addr(&empty[slot]));
    }
  }
  // The frozen row: every output row after the last live step, and last.
  for (int i = t_end / K; i < NI; ++i) store(out + (size_t)i * B * S, a);
  store(last + (size_t)b * S, a);
}

// The backward's thread groups: kBeta threads run beta, the posteriors and
// their per-label sums; with the checkpoints, kRebuild more rebuild the
// alpha rows of the block beta reaches next, at the same time.
constexpr int kBeta = 256;
constexpr int kRebuild = 256;
constexpr int kPer = 5;        // states a thread prefetches log-probs for (Sb <= 1280)

// The log-probs (or, for the stream, alpha entries) of a thread's first
// kPer states s = s0 + n·kBeta of one row, loaded a step ahead of their use.
struct Ahead {
  float v[kPer];
  __device__ __forceinline__ void lp(const float* row, const int* ext_s, int s0, int Sb) {
#pragma unroll
    for (int n = 0; n < kPer; ++n) {
      const int s = s0 + n * kBeta;
      v[n] = s < Sb ? __ldg(row + ext_s[s]) : 0.0f;
    }
  }
  __device__ __forceinline__ void at(const float* row, int s0, int Sb) {
#pragma unroll
    for (int n = 0; n < kPer; ++n) {
      const int s = s0 + n * kBeta;
      v[n] = s < Sb ? __ldg(row + s) : 0.0f;
    }
  }
};

// kStream: `alphas` is the (T, B, S) alpha stream and row t is read from
// it; else `alphas` holds the checkpoints and each K-step block's rows are
// rebuilt in shared memory by the rebuild group, one block ahead of beta.
//
// One K-row buffer serves both groups: consecutive blocks are stored in
// opposite orientations (block i's row k in slot k for even i, K-1-k for
// odd i), so the rebuild of block i-1 writes its rows 0, 1, ... into the
// slots in the order beta frees them while it walks block i from its last
// row down.  Every tick (one __syncthreads) beta takes one step once its
// block is complete, and the rebuild one row once its slot is free: they
// overlap except for the top block's rows and one tick a block.
//
// The per-label sums: the blank's states (every even s, L + 1 of them) by
// a fixed tree (each thread's states in order, warp shuffles, the eight
// warps' sums in order); the other labels each walk their list of odd
// states (offs/idx, a few entries each), in the tick after the step, so
// the walk overlaps the next step.  Everything in a fixed order: the
// gradient repeats bit for bit.
template <bool kStream>
__global__ void __launch_bounds__(kStream ? kBeta : kBeta + kRebuild)
    ctc_beta_post(const float* __restrict__ lp, const int* __restrict__ ext,
                  const uint8_t* __restrict__ skip, const int* __restrict__ logit_len,
                  const int* __restrict__ label_len, const float* __restrict__ logp,
                  const float* __restrict__ alphas, const int* __restrict__ offs,
                  const int* __restrict__ idx, float* __restrict__ label_post, int T,
                  int B, int S, int V, int K) {
  extern __shared__ float smem[];
  const int half = (S + 1) / 2;
  float* alpha = smem;                                  // [K][S], none for kStream
  float* bstar = alpha + (kStream ? 0 : (size_t)K * S); // [2][S + 2]
  float* pp = bstar + 2 * (S + 2);                      // [2][half]: odd states' posteriors
  float* wpart = pp + 2 * half;                         // [2][kBeta / 32]: blank partials
  int* ext_s = reinterpret_cast<int*>(wpart + 2 * (kBeta / 32));  // [S]
  int* idx_s = ext_s + S;                               // [S]
  int* offs_s = idx_s + S;                              // [V + 1]
  uint8_t* skip_s = reinterpret_cast<uint8_t*>(offs_s + V + 1);  // [S]
  const int b = blockIdx.x;
  const int Tb = logit_len[b];
  const int L = label_len[b];
  const int Sb = min(S, 2 * L + 1);
  const int end = 2 * L;
  const float logp_b = logp[b];
  const int tid = threadIdx.x;
  const int nthreads = kStream ? kBeta : kBeta + kRebuild;
  const bool in_beta = tid < kBeta;
  const int gt = in_beta ? tid : tid - kBeta;           // thread within its group
  const int warp = tid / 32, lane = tid % 32;
  for (int s = tid; s < S; s += nthreads) {
    ext_s[s] = ext[(size_t)b * S + s];
    idx_s[s] = idx[(size_t)b * S + s];
    skip_s[s] = skip[(size_t)b * S + s];
  }
  for (int s = tid; s < 2 * (S + 2); s += nthreads) bstar[s] = kNegInf;
  for (int v = tid; v <= V; v += nthreads) offs_s[v] = offs[(size_t)b * (V + 1) + v];
  __syncthreads();
  const int blank = ext_s[0];

  const int NI = (T + K - 1) / K;
  auto nk = [&](int i) { return min(K, T - i * K); };
  auto slot = [&](int i, int k) { return (i & 1) ? K - 1 - k : k; };
  auto lp_row = [&](int t) { return lp + ((size_t)t * B + b) * V; };

  // Step t's per-label sums into label_post (beta threads): each label's
  // odd states in list order, the blank's tree of warp sums added.
  auto walk = [&](int t) {
    const float* ppw = pp + (t & 1) * half;
    for (int v = gt; v < V; v += kBeta) {
      const int j0 = offs_s[v], j1 = offs_s[v + 1];
      float a0 = 0.0f, a1 = 0.0f;
      int j = j0;
      for (; j + 2 <= j1; j += 2) {
        a0 += ppw[idx_s[j] >> 1];
        a1 += ppw[idx_s[j + 1] >> 1];
      }
      if (j < j1) a0 += ppw[idx_s[j] >> 1];
      float sum = a0 + a1;
      if (v == blank) {
        float bl = 0.0f;
#pragma unroll
        for (int w = 0; w < kBeta / 32; ++w) bl += wpart[(t & 1) * (kBeta / 32) + w];
        sum += bl;
      }
      label_post[((size_t)t * B + b) * V + v] = sum;
    }
  };

  int bi = NI - 1, bj = 0;                 // beta: block, steps done in it
  int ri = kStream ? -1 : NI - 1, rj = 0;  // rebuild: block, rows done in it
  int par = 0;                             // bstar + par·(S+2): beta_{t+1} + lp_{t+1}
  int walk_t = -1;                         // a step whose label sums are pending
  Ahead ahead;                             // the next beta step's (or rebuild row's) lp
  Ahead arow_ahead;                        // kStream: the next step's alpha row
  if (in_beta) {
    ahead.lp(lp_row(T - 1), ext_s, gt, Sb);
    if (kStream) arow_ahead.at(alphas + ((size_t)(T - 1) * B + b) * S, gt, Sb);
  } else {
    ahead.lp(lp_row((NI - 1) * K), ext_s, gt, Sb);
  }

  while (bi >= 0) {
    const bool beta_go = kStream || ri < bi;   // block bi rebuilt
    bool reb_go = false;
    if (!kStream && ri >= 0) {
      // Row (ri, rj)'s slot held block ri+1's row K-1-rj, which beta frees
      // at its step rj - (K - nk(ri+1)) of that block.
      reb_go = ri == NI - 1 || bi < ri + 1 ||
               (bi == ri + 1 && bj >= rj - (K - nk(ri + 1)) + 1);
    }
    if (in_beta) {
      if (walk_t >= 0) walk(walk_t);         // the previous step's label sums
      walk_t = -1;
      if (beta_go) {
        const int k = nk(bi) - 1 - bj;
        const int t = bi * K + k;
        const float* bs = bstar + par * (S + 2);
        float* bn = bstar + (par ^ 1) * (S + 2);
        float* ppt = pp + (t & 1) * half;
        const bool live = t < Tb;
        const bool islast = t == Tb - 1;
        const float* arow = kStream ? nullptr : alpha + (size_t)slot(bi, k) * S;
        Ahead cur = ahead, acur = arow_ahead;
        if (t > 0) {                          // the next step's operands, in flight
          ahead.lp(lp_row(t - 1), ext_s, gt, Sb);
          if (kStream) arow_ahead.at(alphas + ((size_t)(t - 1) * B + b) * S, gt, Sb);
        }
        const float* row = lp_row(t);
        const float* srow = kStream ? alphas + ((size_t)t * B + b) * S : nullptr;
        float blank_acc = 0.0f;
        auto state = [&](int s, float lps, float as) {
          float beta;
          if (islast) {
            beta = (s == end || (s == end - 1 && L > 0)) ? 0.0f : kNegInf;
          } else {
            const bool skip2 = s + 2 < S && skip_s[s + 2];
            beta = log_add3(bs[s], bs[s + 1], skip2 ? bs[s + 2] : kNegInf);
          }
          const float gamma = as + beta - logp_b;
          const float p = live ? expf(fminf(gamma, 0.0f)) : 0.0f;
          bn[s] = beta + lps;
          if (s & 1) {
            ppt[s >> 1] = p;
          } else {
            blank_acc += p;
          }
        };
#pragma unroll
        for (int n = 0; n < kPer; ++n) {
          const int s = gt + n * kBeta;
          if (s < Sb) state(s, cur.v[n], kStream ? acur.v[n] : arow[s]);
        }
        for (int s = gt + kPer * kBeta; s < Sb; s += kBeta) {
          state(s, __ldg(row + ext_s[s]), kStream ? __ldg(srow + s) : arow[s]);
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) blank_acc += __shfl_xor_sync(0xffffffffu, blank_acc, o);
        if (lane == 0) wpart[(t & 1) * (kBeta / 32) + warp] = blank_acc;
        walk_t = t;
      }
    } else if (reb_go) {
      // Rebuild row rj of block ri into its slot.
      const int t = ri * K + rj;
      float* dst = alpha + (size_t)slot(ri, rj) * S;
      const Ahead cur = ahead;
      const int t_next = rj + 1 < nk(ri) ? t + 1 : (ri - 1) * K;
      if (ri > 0 || rj + 1 < nk(ri)) ahead.lp(lp_row(t_next), ext_s, gt, Sb);
      const float* row = lp_row(t);
      auto value = [&](int s, float lps) {
        if (t == 0) return s < 2 ? lps : kNegInf;
        const float* prev = rj == 0 ? alphas + ((size_t)(ri - 1) * B + b) * S
                                    : alpha + (size_t)slot(ri, rj - 1) * S;
        return t < Tb ? alpha_step(prev, s, skip_s[s], lps) : prev[s];
      };
#pragma unroll
      for (int n = 0; n < kPer; ++n) {
        const int s = gt + n * kBeta;
        if (s < Sb) dst[s] = value(s, cur.v[n]);
      }
      for (int s = gt + kPer * kBeta; s < Sb; s += kBeta) dst[s] = value(s, __ldg(row + ext_s[s]));
    }
    __syncthreads();
    if (beta_go) {
      par ^= 1;
      if (++bj == nk(bi)) {
        --bi;
        bj = 0;
      }
    }
    if (reb_go && ++rj == nk(ri)) {
      --ri;
      rj = 0;
    }
  }
  if (in_beta && walk_t >= 0) walk(walk_t);  // the last step's label sums
}

size_t beta_smem_bytes(int S, int V, int K) {
  return sizeof(float) * ((size_t)K * S + 2 * (S + 2) + 2 * (size_t)((S + 1) / 2) +
                          2 * (kBeta / 32)) +
         sizeof(int) * (2 * (size_t)S + V + 1) + S;
}

template <int kP>
int launch_alpha_fwd(const float* lp, const int* ext, const uint8_t* skip,
                     const int* logit_len, const int* label_len, float* rows, float* last,
                     int T, int B, int S, int V, int K, int threads, int ring, int fault_step,
                     void* stream) {
  const size_t smem = alpha_fwd_smem_bytes(threads, ring, V);
  cudaError_t err = cudaFuncSetAttribute(
      ctc_alpha_fwd<kP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ctc_alpha_fwd<kP><<<B, threads + 32, smem, static_cast<cudaStream_t>(stream)>>>(
      lp, ext, skip, logit_len, label_len, rows, last, T, B, S, V, K, ring, fault_step);
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
  ctc_beta_post<kStream><<<B, kStream ? kBeta : kBeta + kRebuild, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      lp, ext, skip, logit_len, label_len, logp, alphas, offs, idx, label_post, T, B, S, V,
      K);
  return (int)cudaGetLastError();
}

}  // namespace

// lp (T, B, V) f32 log-probs; ext (B, S) int32 extended labels; skip (B, S)
// uint8 (the s-2 -> s transition is allowed); logit_len, label_len (B)
// int32.  last (B, S) f32 receives the last alpha row.  rows: null (the
// loss only), or (ceil(T/K), B, S) f32 receiving the row after each step
// t = iK + K - 1 (or T - 1): the checkpoints, or with K = 1 every row (the
// stream of `_alpha_kernel`).  The launch's geometry comes from the
// wrapper (ops/ctc_kernel.py `alpha_geometry`): `states` (kP: 2, 4 or 8) a
// thread, `threads` compute threads (a multiple of 32 covering S, at most
// 992), a ring of `ring` slots of 4 log-prob rows.  fault_step > 0 plants
// a fault for checks (that step reads the previous step's log-probs).
// Returns the CUDA error code of the launch (0 = success).
extern "C" int rst_ctc_alpha_fwd(const float* lp, const int* ext, const uint8_t* skip,
                                 const int* logit_len, const int* label_len, float* rows,
                                 float* last, int T, int B, int S, int V, int K, int states,
                                 int threads, int ring, int fault_step, void* stream) {
  if (T < 1 || K < 1 || ring < 1 || threads % 32 != 0 || threads + 32 > 1024 ||
      (long long)threads * states < S) {
    return (int)cudaErrorInvalidValue;
  }
  switch (states) {
    case 2:
      return launch_alpha_fwd<2>(lp, ext, skip, logit_len, label_len, rows, last, T, B, S, V, K,
                                 threads, ring, fault_step, stream);
    case 4:
      return launch_alpha_fwd<4>(lp, ext, skip, logit_len, label_len, rows, last, T, B, S, V, K,
                                 threads, ring, fault_step, stream);
    case 8:
      return launch_alpha_fwd<8>(lp, ext, skip, logit_len, label_len, rows, last, T, B, S, V, K,
                                 threads, ring, fault_step, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Dynamic shared memory of rst_ctc_alpha_fwd, in bytes.
extern "C" long long rst_ctc_alpha_fwd_smem(int threads, int ring, int V) {
  return (long long)alpha_fwd_smem_bytes(threads, ring, V);
}

// Also logp (B) f32, the rows' log-likelihoods; ckpt from rst_ctc_alpha_fwd;
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

// The same with alphas (T, B, S) f32 from rst_ctc_alpha_fwd at K = 1 in place of
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
