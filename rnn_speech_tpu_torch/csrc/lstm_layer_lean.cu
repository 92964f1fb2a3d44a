// A layer's forward recurrence as one persistent Hopper kernel (sm_90a):
// W_h stays in shared memory for all T steps, one grid-wide barrier a step
// instead of one launch a step, the product on wgmma.
//
// Replaces three TPU kernels of rnn_speech_tpu/ops/lstm_pallas.py, one
// template instance each:
//
// * `_recurrence_train_lean_kernel` (entry `_lstm_recurrence_train_lean`,
//   the recompute-mode training forward; rst_lstm_layer_train_lean_persistent):
//   bf16 x_proj, c_seq stored;
// * `_recurrence_kernel` (entry `lstm_recurrence_pallas`, the layered
//   inference recurrence; rst_lstm_recurrence_persistent): float32 x_proj,
//   no residual;
// * `_recurrence_train_kernel` (entry `_lstm_recurrence_train`, the
//   gates-mode training forward; rst_lstm_layer_train_persistent): float32
//   x_proj, c_seq and the activated gates stored.
//
// Per step t
//
//   gates = x_proj[t] + bf16(h)·W_h                (f32 sums; x_proj added as stored)
//   i, g, f, o = σ(i), tanh(g), σ(f + 1), σ(o)
//   c' = f·c + i·g;  h' = o·tanh(c');  c, h <- m·(c', h') + (1 - m)·(c, h)
//   out[t] = m·h' (f32);  c_seq[t] = bf16(c) (the training forwards)
//   gates[t] = bf16(i, g, f, o) (the gates-mode forward, in the residual's
//   [i | g | f | o] column order, H wide each, that the backward reads)
//
// and returns (out, hn, cn[, c_seq[, gates]]).  csrc/lstm_layer_train.cu and
// csrc/lstm_recurrence.cu keep the per-step forms (one launch a step on the
// shared cell, lstm_cell.cuh) for the shapes the wrappers' plan
// (`lean_plan`, ops/lstm_recurrence.py) does not send here.
//
// What bounds it on the H100: 2·T·B·H·4H operations, 3.4 µs a step at the
// bf16 tensor rate (989 TFLOP/s) at B=400, H=1024, against x_proj read once
// (3.3 MB a step).  The per-step kernel took ~43 µs a step: a launch per
// step, W_h and h re-read from L2 by 448 blocks every step (~112 MiB),
// legacy mma.sync products and the f32 carries through device memory.  The
// inference recurrence at the serving batch (B=128): 1.1 µs a step at the
// tensor rate; its per-step kernel took 26.8 µs a step.
//
// What this design does about it:
// * One cooperative launch per call (co-residency guaranteed, or the
//   launch is refused and the wrapper raises; a barrier that never fills
//   traps instead of hanging).  The grid is (row groups) x (H / 16 unit
//   slices): CTA (r, u) owns hidden units 16u .. 16u + 15 with all four of
//   their gates and the rows of row group r (at most four 64-row tiles).
//   At H=1024 and B=400 or 473: 2 x 64 = 128 CTAs, one per SM.
// * W_h resident: the wrapper orders W_h's columns CTA by CTA as
//   [i(16) | g(16) | f(16) | o(16)] and transposes them (`lean_weights`:
//   w_perm (4H, H), K contiguous), so CTA u's 64 columns are 64 rows of
//   w_perm, loaded once by TMA into shared memory (128 KiB at H=1024) as a
//   K-major wgmma operand in 128-byte swizzle.
// * Column order = fragment order: in the m64n64 accumulator, column
//   group j = 2·gate + jj holds units 8·jj + 2·(lane % 4) + {0, 1}, so each
//   thread holds all four gates of the same 2 rows x 4 units and the cell
//   update runs in registers; c and h stay in f32 registers for all T
//   steps.  Only bf16(h) goes out, into a ping-pong buffer that every CTA
//   of the row group reads; out and c_seq are streamed stores.
// * The product: one producer warp keeps TMA loads of h (64-column K
//   stages of the group's tiles, 8 KiB a tile) in flight through a ring of
//   2-8 stages with full and empty mbarriers (each released as soon as its
//   own products are done); two consumer warpgroups run
//   wgmma m64n64k16 (A = the h tile, B = the resident W_h slice, both
//   K-major) into one 64x64 f32 accumulator per tile (tiles wg, wg + 2).
//   Rows past B are zero in the h buffer and never stored.
// * The step barrier, one per row group (the groups' rows never meet):
//   each consumer thread fences its h stores to the async proxy
//   (fence.proxy.async.global: the next step reads h by TMA), the
//   consumers meet at a named barrier, one thread adds 1 to its group's
//   arrival counter after a gpu-scope fence; the producer polls that
//   counter with acquire loads until every CTA of the group has arrived,
//   fences, and only then loads the next step's h.  No atomic takes part in the arithmetic: a run
//   repeats bit for bit.
// * Registers: 64 accumulators, 32 carries and 32 prefetched x_proj words
//   a consumer thread; 288 threads, one block an SM (launch bounds), no
//   setmaxnreg.  ptxas caps the block at 168 registers a thread and spills
//   ~120 bytes (`-Xptxas -v` in the build log).
// * f32 x_proj (the inference recurrence) would double that prefetch, and
//   rounding it to bf16 would change the sum the TPU kernel forms.  So it
//   is staged by TMA instead: per 64-row tile and gate a box of the CTA's
//   16 units (64 x 16 f32, 4 KiB; 16 KiB a tile a step), in two step
//   buffers with full and empty mbarriers, loaded by the producer a step
//   ahead (after the step's h loads) and read by the cell from shared
//   memory.  The budget at B=128 (2 row groups x 64 slices of one tile:
//   128 CTAs): 128 KiB of resident W_h, an h ring of 8 stages x 8 KiB and
//   32 KiB of x_proj buffers, 225 KiB of the 227.  The h stream is 128 KiB
//   a CTA a step (one tile x K = 1024), half of it in flight at once.
//
// What bounds this design (PERF.md; NVIDIA H100 80GB HBM3, 700.00 W):
// ~22 µs a step at B=400; at B=64 (12.1 µs a step) and with the step
// barrier left out (4% less; both in chip_smoke.py's opt-in lean_study
// phase) it stays far from its bound.  The inference recurrence: ~11.5 µs a
// step at B=128 and ~11.1 at B=1 (one padded tile), the step barrier ~10%
// of it (chip_smoke.py's opt-in persistent_study): the h ring's round trips,
// not the rows, set the step.  Every step each CTA streams 512 KiB of h
// (256 rows) through a ring that the resident W_h slice leaves room for
// (3 stages of 32 KiB): too few bytes in flight for the L2's latency, so
// the stream, not the product or the barrier, sets the step time.
// Releasing each stage when its own products finish (not when the next
// stage arrives) keeps all 3 in flight: 83.8 -> 76.4 ms a call at B=400.
//
// Tried and measured (chip_smoke.py, PERF.md): TMA multicast of the h
// tiles across a cluster of two CTAs of a row group (each loading half of every tile's
// rows, a stage refilled only when both CTAs have released it) was
// correct and bit-equal but slower, 137.9 against 82.7 ms a call at
// B=400 (NVIDIA H100 80GB HBM3, 700.00 W): the pair's coupled ring and
// the halved boxes cost more than the L2 reads saved.  Not done here: the
// backward's K split (csrc/lstm_layer_bwd_persistent.cu) for the forward:
// split four ways, a CTA would hold 64 units' columns of a K quarter and
// stream a quarter of h, but exchange a (64, 256) f32 partial (64 KiB) a
// tile a step through L2, as many bytes as the h stream it shortens.
//
// The gates-mode forward (row 5 of PERF.md's table) adds to the inference
// recurrence's instance only the two residual stores, each thread writing
// its 2 rows x 4 units of c and of each activated gate as bf16 pairs from
// registers: 4H·2 + H·2 bytes a row a step, 640 KiB a step at B=64, beside
// the 1 MiB of f32 x_proj it reads.  The per-step kernel it replaces at
// the layered step's B=64 (csrc/lstm_layer_train.cu) took 26.3 µs a step:
// one launch a step, W_h re-staged from L2 by every block in 64-wide K
// chunks.  Its plan is the inference recurrence's (`lean_plan(B, H, sms,
// x_f32=True)`): at B=64, H=1024 one row group of 64 CTAs, 8 ring stages.

#include <type_traits>

#include "bounds_check.cuh"
#include "grad_matmul.cuh"
#include "lstm_cell.cuh"

namespace {

namespace tma = rst_grad::tma;
using bf16 = __nv_bfloat16;

constexpr int kUnits = 16;                      // hidden units a CTA owns
constexpr int kConsumers = 2;                   // consumer warpgroups
constexpr int kThreads = 128 * kConsumers + 32; // + one producer warp
constexpr int kBox = 64 * 64 * 2;               // a 64x64 bf16 TMA box (8 KiB)
constexpr int kMaxTiles = 2 * kConsumers;       // 64-row tiles a CTA
constexpr int kSmemLimit = 232448;              // the H100's per-block opt-in

long long g_launches = 0;                       // launches with bf16 x_proj (row 7)
long long g_rec_launches = 0;                   // launches with f32 x_proj (row 2)
long long g_train_launches = 0;                 // launches with f32 x_proj and gates (row 5)

template <typename XT>
struct Args {
  const XT* x_proj;     // (T, B, 4H) bf16 (row 7) or f32 (row 2)
  const float* mask;    // (T, 1, B) f32 {0, 1}
  float* h;             // (B, H) f32: h0 on entry, hn on return
  float* c;             // (B, H) f32: c0 on entry, cn on return
  float* out;           // (T, B, H) f32
  bf16* cseq;           // (T, B, H) bf16, or null (row 2 stores no residual)
  bf16* gates;          // (T, B, 4H) bf16 activated gates (row 5), or null
  bf16* hb;             // (2, Bpa, H) bf16: hb[0] = bf16(h0), padding rows zero
  unsigned* counter;    // (groups) step barrier arrivals of each row group, zero on entry
  int T, B, H, Bpa, tiles, stages;
  int skip_barrier;     // a planted fault (chip_smoke.py): read h without waiting
  // (T + 1, 4) SM clocks of CTA 0 (row 5 only: chip_smoke.py's
  // persistent_study), or null: step t's barrier passed (producer), its
  // product done, its cell stored, its arrival (consumer 0).
  long long* stamps;
};

__device__ __forceinline__ void stamp(long long* stamps, int t, int k) {
  if (stamps != nullptr && blockIdx.x == 0) stamps[4 * t + k] = clock64();
}

// f32 x_proj is staged by TMA: per 64-row tile and gate a box of 16 units
// (64 rows x 16 f32, 4 KiB), two step buffers.
constexpr int kXBox = 64 * kUnits * 4;
constexpr int kXTile = 4 * kXBox;

__host__ __device__ constexpr size_t smem_bytes(int H, int tiles, int stages, bool xf32) {
  return (size_t)(H / 64) * kBox + (size_t)stages * tiles * kBox +
         (xf32 ? (size_t)2 * tiles * kXTile : 0) + 8 * (1 + 2 * stages + (xf32 ? 4 : 0)) + 1024;
}

__device__ __forceinline__ float bf_lo(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float bf_hi(uint32_t v) {
  return __uint_as_float(v & 0xFFFF0000u);
}

__device__ __forceinline__ uint32_t pack_bf2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// XT: x_proj's type (bf16: row 7, read into registers; float: rows 2 and
// 5, staged by TMA through map_x).  kStoreC: store c_seq (rows 7 and 5).
// kStoreGates: store the activated gates (row 5).
template <typename XT, bool kStoreC, bool kStoreGates>
__global__ void __launch_bounds__(kThreads, 1)
    lean_persistent(const __grid_constant__ CUtensorMap map_w,
                    const __grid_constant__ CUtensorMap map_h,
                    const __grid_constant__ CUtensorMap map_x, Args<XT> p) {
  using namespace tma;
  constexpr bool kXF32 = std::is_same<XT, float>::value;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int KS = p.H / 64;                       // K stages of a step
  const int S = p.stages;
  const int stage_bytes = p.tiles * kBox;
  uint8_t* w_s = smem;                           // KS boxes: the W_h slice
  uint8_t* ring = smem + (size_t)KS * kBox;      // S stages of `tiles` h boxes
  uint8_t* xs = ring + (size_t)S * stage_bytes;  // f32 x_proj: 2 steps of `tiles` tiles
  uint64_t* wbar =
      reinterpret_cast<uint64_t*>(xs + (kXF32 ? (size_t)2 * p.tiles * kXTile : 0));
  uint64_t* full = wbar + 1;
  uint64_t* empty = full + S;
  uint64_t* xfull = empty + S;                   // f32 x_proj of step buffer 0, 1 landed
  uint64_t* xempty = xfull + 2;                  // ... read by the consumers
  const int slices = p.H / kUnits;
  const int slice = blockIdx.x % slices, group = blockIdx.x / slices;
  const int row0 = group * p.tiles * 64;         // this CTA's first row
  const int j0 = slice * kUnits;                 // its first hidden unit
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    bar_init(smem_addr(wbar), 1);
    for (int s = 0; s < S; ++s) {
      bar_init(smem_addr(&full[s]), 1);
      bar_init(smem_addr(&empty[s]), 4 * kConsumers);   // each consumer warp releases
    }
    if constexpr (kXF32) {
      for (int i = 0; i < 2; ++i) {
        bar_init(smem_addr(&xfull[i]), 1);
        bar_init(smem_addr(&xempty[i]), 4 * kConsumers);
      }
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * kConsumers) {                  // the producer warp
    if (lane == 0) {
      const uint32_t wb = smem_addr(wbar);
      bar_expect_tx(wb, KS * kBox);
      for (int k = 0; k < KS; ++k) {
        RST_CHECK(k * 64, p.H);                  // K: the (4H, H) operand's columns
        RST_CHECK(slice * 64, 4 * p.H);          // its rows: the slice's 64 gate columns
        load_box(smem_addr(w_s + (size_t)k * kBox), &map_w, wb, k * 64, slice * 64);
      }
      // f32 x_proj of step t into step buffer t % 2: the four gates' boxes
      // of 16 units per tile, once the consumers have read step t - 2's.
      auto load_x = [&](int t) {
        const int i = t & 1;
        bar_wait(smem_addr(&xempty[i]), ((t >> 1) & 1) ^ 1);   // first round passes
        const uint32_t xb = smem_addr(&xfull[i]);
        bar_expect_tx(xb, p.tiles * kXTile);
        const uint32_t dst = smem_addr(xs + (size_t)i * p.tiles * kXTile);
        for (int m = 0; m < p.tiles; ++m) {
          for (int g = 0; g < 4; ++g) {
            RST_CHECK(g * p.H + j0, 4 * p.H);
            RST_CHECK((long long)t * p.B + row0 + 64 * m, (long long)p.T * p.B);
            load_box(dst + m * kXTile + g * kXBox, &map_x, xb, g * p.H + j0,
                     t * p.B + row0 + 64 * m);
          }
        }
      };
      if constexpr (kXF32) load_x(0);
      int it = 0;
      for (int t = 0; t < p.T; ++t) {
        RST_CHECK(group, p.Bpa / (p.tiles * 64));
        if (t > 0 && !p.skip_barrier) grid_wait(p.counter + group, (unsigned)t * slices);
        if constexpr (kStoreGates) stamp(p.stamps, t, 0);
        asm volatile("fence.proxy.async.global;" ::: "memory");
        const int hrow = (t & 1) * p.Bpa + row0;
        for (int k = 0; k < KS; ++k, ++it) {
          const int s = it % S;
          bar_wait(smem_addr(&empty[s]), ((it / S) & 1) ^ 1);   // first round passes
          const uint32_t fb = smem_addr(&full[s]);
          bar_expect_tx(fb, stage_bytes);
          const uint32_t dst = smem_addr(ring + (size_t)s * stage_bytes);
          for (int m = 0; m < p.tiles; ++m) {
            RST_CHECK(hrow + 64 * m, 2 * p.Bpa);
            load_box(dst + m * kBox, &map_h, fb, k * 64, hrow + 64 * m);
          }
        }
        if constexpr (kXF32) {
          if (t + 1 < p.T) load_x(t + 1);
        }
      }
    }
    return;
  }

  // Consumers: warpgroup wg computes tiles wg and wg + 2 (those < tiles).
  const int wg = warp / 4;
  const int nt = (p.tiles - wg + 1) / 2;
  const int H = p.H, B = p.B;
  const size_t G = 4 * (size_t)H;
  const int ucol = 2 * (lane % 4);               // unit offset of e = 0 in a group of 8
  auto row_of = [&](int m, int hh) {
    return row0 + 64 * (wg + 2 * m) + 16 * (warp % 4) + lane / 4 + 8 * hh;
  };

  // Carries of (tile m, row hh, unit group jj, unit e), f32 in registers.
  float c_r[2][2][2][2], h_r[2][2][2][2];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int b = row_of(m, hh);
      const bool ok = m < nt && b < B;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const size_t i = (size_t)b * H + j0 + 8 * jj + ucol + e;
          if (ok) RST_CHECK(i, (long long)B * H);
          c_r[m][hh][jj][e] = ok ? p.c[i] : 0.0f;
          h_r[m][hh][jj][e] = ok ? p.h[i] : 0.0f;
        }
    }

  bar_wait(smem_addr(wbar), 0);                  // W_h resident
  const uint32_t w_base = smem_addr(w_s);
  float d[2][32];
  int it = 0;
  for (int t = 0; t < p.T; ++t) {
    // This step's x_proj words (bf16 pairs of units e = 0, 1) and masks:
    // in flight while the product runs.  f32 x_proj arrives by TMA instead.
    uint32_t xr[2][2][4][2];
    float mk[2][2];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int b = row_of(m, hh);
        const bool ok = m < nt && b < B;
        if (ok) RST_CHECK((size_t)t * B + b, (long long)p.T * B);
        mk[m][hh] = ok ? p.mask[(size_t)t * B + b] : 0.0f;
        if constexpr (!kXF32) {
          const bf16* xrow = p.x_proj + ((size_t)t * B + b) * G + j0 + ucol;
          if (ok) RST_CHECK(((size_t)t * B + b) * G + j0 + ucol + 3 * H + 9, (long long)p.T * B * G);
#pragma unroll
          for (int g = 0; g < 4; ++g)
#pragma unroll
            for (int jj = 0; jj < 2; ++jj) {
              xr[m][hh][g][jj] =
                  ok ? __ldg(reinterpret_cast<const unsigned int*>(xrow + (size_t)g * H + 8 * jj))
                     : 0u;
            }
        }
      }

    for (int k = 0; k < KS; ++k, ++it) {
      const int s = it % S;
      bar_wait(smem_addr(&full[s]), (it / S) & 1);
      const uint32_t st = smem_addr(ring + (size_t)s * stage_bytes);
#pragma unroll
      for (int m = 0; m < 2; ++m) fence_acc(d[m]);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        if (m < nt) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            mma_64x64x16(d[m], k_desc(st + (wg + 2 * m) * kBox + kk * 32),
                         k_desc(w_base + k * kBox + kk * 32), (k | kk) != 0);
          }
        }
      }
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
#pragma unroll
      for (int m = 0; m < 2; ++m) fence_acc(d[m]);
      // Release this stage as soon as its own products are done, not
      // after the next stage has arrived: the ring's every stage can then
      // be in flight while this warpgroup waits (the h stream, not the
      // product, sets the step).
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
#pragma unroll
      for (int m = 0; m < 2; ++m) fence_acc(d[m]);
      if (lane == 0) bar_arrive(smem_addr(&empty[s]));
    }
    if constexpr (kStoreGates) {
      if (threadIdx.x == 0) stamp(p.stamps, t, 1);
    }

    // The cell, in registers; gate g of unit group jj is column group 2g + jj.
    bf16* hnext = p.hb + (size_t)((t + 1) & 1) * p.Bpa * H;
    const float* xt = reinterpret_cast<const float*>(xs + (size_t)(t & 1) * p.tiles * kXTile);
    if constexpr (kXF32) bar_wait(smem_addr(&xfull[t & 1]), (t >> 1) & 1);
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      if (m >= nt) continue;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int b = row_of(m, hh);
        const float mm = mk[m][hh];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          float o_v[2], c_v[2], h_v[2], a_v[4][2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float pre[4];
#pragma unroll
            for (int g = 0; g < 4; ++g) {
              if constexpr (kXF32) {
                // Box g of tile wg + 2m: (row in the tile, unit) as 64 x 16 f32.
                const int r = 16 * (warp % 4) + lane / 4 + 8 * hh;
                pre[g] = d[m][4 * (2 * g + jj) + 2 * hh + e] +
                         xt[(wg + 2 * m) * (kXTile / 4) + g * (kXBox / 4) + r * kUnits +
                            8 * jj + ucol + e];
              } else {
                const uint32_t x = xr[m][hh][g][jj];
                pre[g] = d[m][4 * (2 * g + jj) + 2 * hh + e] + (e ? bf_hi(x) : bf_lo(x));
              }
            }
            const float i_a = rst::sigmoidf_(pre[0]), g_a = tanhf(pre[1]);
            const float f_a = rst::sigmoidf_(pre[2] + 1.0f), o_a = rst::sigmoidf_(pre[3]);
            const float c_old = c_r[m][hh][jj][e], h_old = h_r[m][hh][jj][e];
            const float c_new = f_a * c_old + i_a * g_a;
            const float h_new = o_a * tanhf(c_new);
            const float c_sel = mm * c_new + (1.0f - mm) * c_old;
            const float h_sel = mm * h_new + (1.0f - mm) * h_old;
            c_r[m][hh][jj][e] = c_sel;
            h_r[m][hh][jj][e] = h_sel;
            o_v[e] = mm * h_new;
            c_v[e] = c_sel;
            h_v[e] = h_sel;
            a_v[0][e] = i_a;
            a_v[1][e] = g_a;
            a_v[2][e] = f_a;
            a_v[3][e] = o_a;
          }
          if (b < B) {
            const size_t i = (size_t)b * H + j0 + 8 * jj + ucol;
            const size_t ti = (size_t)t * B * H + i;
            RST_CHECK(ti + 1, (long long)p.T * B * H);
            RST_CHECK(i + 1, (long long)p.Bpa * H);
            *reinterpret_cast<float2*>(p.out + ti) = make_float2(o_v[0], o_v[1]);
            if constexpr (kStoreC) {
              *reinterpret_cast<uint32_t*>(p.cseq + ti) = pack_bf2(c_v[0], c_v[1]);
            }
            if constexpr (kStoreGates) {
              bf16* gr = p.gates + ((size_t)t * B + b) * G + j0 + 8 * jj + ucol;
#pragma unroll
              for (int g = 0; g < 4; ++g) {
                *reinterpret_cast<uint32_t*>(gr + (size_t)g * H) =
                    pack_bf2(a_v[g][0], a_v[g][1]);
              }
            }
            *reinterpret_cast<uint32_t*>(hnext + i) = pack_bf2(h_v[0], h_v[1]);
          }
        }
      }
    }
    if constexpr (kXF32) {                       // this warp is done with the x buffer
      __syncwarp();
      if (lane == 0) bar_arrive(smem_addr(&xempty[t & 1]));
    }
    if constexpr (kStoreGates) {
      if (threadIdx.x == 0) stamp(p.stamps, t, 2);
    }
    // h of step t + 1 is read by TMA (the async proxy) in every CTA of the
    // row group: fence it, meet, and arrive once for the CTA.
    asm volatile("fence.proxy.async.global;" ::: "memory");
    asm volatile("bar.sync 1, %0;" ::"n"(128 * kConsumers) : "memory");
    if (threadIdx.x == 0) {
      RST_CHECK(group, p.Bpa / (p.tiles * 64));
      __threadfence();
      atomicAdd(p.counter + group, 1u);
      if constexpr (kStoreGates) stamp(p.stamps, t, 3);
    }
  }

#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int b = row_of(m, hh);
      if (m >= nt || b >= B) continue;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const size_t i = (size_t)b * H + j0 + 8 * jj + ucol + e;
          RST_CHECK(i, (long long)B * H);
          p.c[i] = c_r[m][hh][jj][e];
          p.h[i] = h_r[m][hh][jj][e];
        }
    }
}

// Tensor map of the row-major (rows, 4H) f32 x_proj in boxes of 16 columns
// (one gate of a CTA's units) by 64 rows, no swizzle; reads past `rows`
// fill zeros.
bool make_x_map(CUtensorMap* map, const void* base, long long rows, int cols) {
  const tma::EncodeTiled encode = tma::encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 4};
  const cuuint32_t box[2] = {kUnits, 64};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(base), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename XT, bool kStoreC, bool kStoreGates>
int launch(const XT* x_proj, const void* w_perm, const float* mask, void* hb, float* h,
           float* c, float* out, void* cseq, void* gates, void* counter, int T, int B, int H,
           int groups, int tiles, int stages, int skip_barrier, long long* stamps,
           void* stream, long long* launches) {
  constexpr bool kXF32 = std::is_same<XT, float>::value;
  if (H % 64 != 0 || tiles < 1 || tiles > kMaxTiles || stages < 2 || groups < 1 ||
      T < 1 || B < 1 || B > groups * tiles * 64) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = smem_bytes(H, tiles, stages, kXF32);
  if (smem > (size_t)kSmemLimit) return (int)cudaErrorInvalidValue;
  const int Bpa = groups * tiles * 64;
  CUtensorMap map_w, map_h, map_x;
  if (!tma::make_map(&map_w, w_perm, 4 * H, H) || !tma::make_map(&map_h, hb, 2 * Bpa, H)) {
    return (int)cudaErrorInvalidValue;
  }
  if constexpr (kXF32) {
    if (!make_x_map(&map_x, x_proj, (long long)T * B, 4 * H)) return (int)cudaErrorInvalidValue;
  } else {
    map_x = map_h;                               // unused: bf16 x_proj is read by the threads
  }
  auto kernel = lean_persistent<XT, kStoreC, kStoreGates>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = groups * (H / kUnits);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem)) !=
          cudaSuccess) {
    return (int)err;
  }
  if (per_sm * sms < grid) return (int)cudaErrorCooperativeLaunchTooLarge;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((err = cudaMemsetAsync(counter, 0, groups * sizeof(unsigned), st)) != cudaSuccess) {
    return (int)err;
  }
  Args<XT> p;
  p.x_proj = x_proj;
  p.mask = mask;
  p.h = h;
  p.c = c;
  p.out = out;
  p.cseq = static_cast<bf16*>(cseq);
  p.gates = static_cast<bf16*>(gates);
  p.hb = static_cast<bf16*>(hb);
  p.counter = static_cast<unsigned*>(counter);
  p.T = T;
  p.B = B;
  p.H = H;
  p.Bpa = Bpa;
  p.tiles = tiles;
  p.stages = stages;
  p.skip_barrier = skip_barrier;
  p.stamps = stamps;
  void* args[] = {&map_w, &map_h, &map_x, &p};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), grid, kThreads, args,
                                    smem, st);
  if (err == cudaSuccess) ++*launches;
  return (int)err;
}

}  // namespace

// Row 7, the recompute-mode forward: x_proj (T, B, 4H) bf16; w_perm (4H, H)
// bf16 = the columns of W_h in the kernel's order, transposed
// (`lean_weights`); mask (T, 1, B) f32; hb (2, Bpa, H) bf16 with
// hb[0, :B] = bf16(h0), the rest zero; h, c (B, H) f32 holding h0, c0 on
// entry and hn, cn on return; out (T, B, H) f32; cseq (T, B, H) bf16;
// counter `groups` uint32 of device memory.  The plan (`lean_plan`):
// `groups` row groups of `tiles` 64-row tiles (Bpa = groups·tiles·64 >= B),
// `stages` ring stages; H a multiple of 64.  skip_barrier != 0 plants a
// fault (no wait for the other CTAs' h).  Returns the CUDA error code (0 =
// success); cudaErrorCooperativeLaunchTooLarge when the grid cannot be
// co-resident.
extern "C" int rst_lstm_layer_train_lean_persistent(
    const void* x_proj, const void* w_perm, const float* mask, void* hb, float* h, float* c,
    float* out, void* cseq, void* counter, int T, int B, int H, int groups, int tiles,
    int stages, int skip_barrier, void* stream) {
  return launch<bf16, true, false>(static_cast<const bf16*>(x_proj), w_perm, mask, hb, h, c,
                                   out, cseq, nullptr, counter, T, B, H, groups, tiles, stages,
                                   skip_barrier, nullptr, stream, &g_launches);
}

// Row 2, the inference recurrence: as above with x_proj (T, B, 4H) f32
// (16-byte aligned; the plan's `x_f32` shared memory) and no cseq.
extern "C" int rst_lstm_recurrence_persistent(
    const float* x_proj, const void* w_perm, const float* mask, void* hb, float* h, float* c,
    float* out, void* counter, int T, int B, int H, int groups, int tiles, int stages,
    int skip_barrier, void* stream) {
  return launch<float, false, false>(x_proj, w_perm, mask, hb, h, c, out, nullptr, nullptr,
                                     counter, T, B, H, groups, tiles, stages, skip_barrier,
                                     nullptr, stream, &g_rec_launches);
}

// Row 5, the gates-mode training forward: as row 2 with cseq (T, B, H) and
// gates (T, B, 4H) bf16 residuals; stamps, (T + 1, 4) int64 or null, takes
// CTA 0's SM clock at four points of each step (Args::stamps).
extern "C" int rst_lstm_layer_train_persistent(
    const float* x_proj, const void* w_perm, const float* mask, void* hb, float* h, float* c,
    float* out, void* gates, void* cseq, void* counter, int T, int B, int H, int groups,
    int tiles, int stages, int skip_barrier, long long* stamps, void* stream) {
  return launch<float, true, true>(x_proj, w_perm, mask, hb, h, c, out, cseq, gates, counter,
                                   T, B, H, groups, tiles, stages, skip_barrier, stamps, stream,
                                   &g_train_launches);
}

// Launches of the persistent kernel so far, each entry point's own
// (counted at the launch site).
extern "C" long long rst_lean_persistent_launches() { return g_launches; }
extern "C" long long rst_recurrence_persistent_launches() { return g_rec_launches; }
extern "C" long long rst_train_persistent_launches() { return g_train_launches; }

// Dynamic shared memory of the kernel at (H, tiles, stages), in bytes, with
// bf16 (x_f32 = 0) or f32 x_proj.
extern "C" long long rst_lean_persistent_smem(int H, int tiles, int stages, int x_f32) {
  return (long long)smem_bytes(H, tiles, stages, x_f32 != 0);
}
