// The layer backward as one persistent Hopper kernel (sm_90a), in both
// residual modes: W_h stays in shared memory across the steps of a launch,
// the carry's product runs on wgmma, and a CTA walks every 64-row group of
// the batch in turn.
//
// Replaces two TPU kernels of rnn_speech_tpu/ops/lstm_pallas.py:
//
// * `_recurrence_bwd_kernel` (entry `_lstm_recurrence_bwd`, gates mode):
//   reads the forward's bf16 activated gates and writes dgates over them;
// * `_recurrence_bwd_recompute_kernel` (entry
//   `_lstm_recurrence_bwd_recompute`, recompute mode): the gates are
//   rebuilt as sig/tanh of bf16(x[t])·W_x + bf16(h_prev[t])·W_h + b.  As
//   in csrc/lstm_layer_bwd.cu, the rebuild is one tensor-core product per
//   chunk of steps (rebuild_gates.cuh) into a float32 buffer `act`; this
//   kernel then runs the chunk's steps, reading `act`, one launch a chunk,
//   and writes dgates into a fresh stream.
//
// Per step t = T-1 .. 0, from the activated gates and carried c,
//
//   dh = m·(dout + dh_carry);  do = dh·tanh(c)·o(1-o)
//   dc = dh·o·(1 - tanh²c) + m·dc_carry
//   di = dc·g·i(1-i);  dg = dc·i(1-g²);  df = dc·c_prev·f(1-f)
//   dh_carry' = (1-m)·dh_carry + bf16(dgates)·W_hᵀ;  dc_carry' = (1-m)·dc_carry + dc·f
//
// and dh0, dc0 at the end.  As in the per-step kernels (csrc/lstm_layer_bwd.cu,
// which keeps the shapes the wrapper's plan, `bwd_plan` in
// ops/lstm_layer_train.py, does not send here), the CONSUMING step forms
// the carry's product: step t adds dgates(t+1)·W_h[J, :]ᵀ for its own units
// J, and a last pass adds dgates(0)·W_hᵀ to give dh0.
//
// What bounds it on the H100: 2·T·B·H·4H operations for the carry's
// product (0.54 µs a step at the bf16 tensor rate at B=64, H=1024; the
// rebuild adds twice that in recompute mode, at the tensor rate, off the
// chain); the T steps are a serial chain.  The per-step kernel took 32.6
// µs a step at B=64 and ~67 µs at B=400: a launch a step, and a grid of
// 16-unit blocks that re-reads its W_h slice and the whole bf16 dgates
// tile from L2 every step (~280 MiB a step at B=400), with a serial chain
// of WMMA 16x16x16 products a warp.
//
// The A stream sets the step, and for the backward it is 4x wider than
// for the forward: K = 4H.  The budget, per CTA, at H=1024, for a K split
// of eight:
//
//   resident W_h slice   64 units x 512 K              64 KiB
//   A = dgates(t+1)      64 rows x 512 K a row group   64 KiB, all 8 boxes in flight
//                        one buffer a consumer warpgroup (two past 64 rows)
//   its partial product  64 rows x 64 units f32        16 KiB a row group, out through L2
//   total shared memory                                129 KiB (one warpgroup), 193 KiB (two)
//
// and 128 CTAs x 64 KiB = 8 MiB of A a row group and step from L2.
//
// What this design does about it:
// * K split in eighths.  A slice of 64 hidden units J is eight CTAs: CTA
//   (u, q) holds W_h[J_u, 512q .. 512q + 512) (W_h's own rows, K
//   contiguous: no permuted copy), loaded once a launch by TMA as a K-major
//   wgmma operand in 128-byte swizzle, and streams only dgates(t+1)[rows,
//   K_q], half a gate.  It runs wgmma m64n64k16 over its 512 K into a
//   (64, 64) f32 partial.  The split trades the A stream against the
//   partials' exchange: split by gate (four CTAs of 32 units, 128 KiB of
//   A, 8 KiB partials) the stream took 56% of the step; split in
//   sixteenths (128 units, 32 KiB of A, 32 KiB partials) the exchange grew
//   more than the stream shrank (both measured slower than eighths;
//   PERF.md).
// * Row groups in turn.  The grid is (H/64 slices) x 8 CTAs whatever the
//   batch (128 at H=1024), so W_h is read once a launch, not once a row
//   group: each CTA walks the ceil(B/64) row groups of every step.  With
//   more than one group, two consumer warpgroups take the groups in turn
//   (warpgroup w the groups g = w mod 2), each with its own A buffer, so
//   one group's exchange and cell overlap the next group's product.  A
//   producer warp loads the groups' A boxes in the order 0, 1, 2, ... of
//   each step, into the buffer of the group's warpgroup.
// * The partials meet through L2, not distributed shared memory: the H100
//   co-schedules at most 15 clusters of eight CTAs of this size (30 of
//   four, 66 of two; cudaOccupancyMaxActiveClusters, read by
//   persistent_study), fewer than the 16 slices at H=1024, so a grid of
//   clusters of a slice cannot be co-resident.  Each CTA stores its
//   group's partial (L2 only) into the (group, slice, q) slot, adds 1 to
//   the (group, slice) counter (release), waits until the eight have
//   arrived (acquire) and sums the eight partials of its cells in the
//   order of q: a fixed order, no atomics in the arithmetic, so a run
//   repeats bit for bit, and one row group at one warpgroup runs the same
//   arithmetic as the one-tile design before it.
// * Each warpgroup then runs the cell backward for 8 of the slice's 64
//   units (units 64u + 8q .. 64u + 8q + 7) over its group's 64 rows: a
//   thread owns a row and 4 units.  Its dh and dc carries live in global
//   memory (dhc, dcc: read and written by that thread alone, so they need
//   no fence) and, with the cell's inputs (dout, the four gates or their
//   float32 rebuild, c, c_prev, the mask), are loaded before the thread
//   waits for the group's product.
// * The dgates exchange needs no buffer of its own: step t writes bf16
//   dgates into the dgates stream (gates mode: over gates[t]), and step
//   t-1's TMA reads them there (rows past B in the last group's 64-row box
//   read a later step's dgates or TMA's zero fill; they only reach product
//   rows that are never stored).  Writers fence their stores to the async
//   proxy (fence.proxy.async.global), the warpgroup meets, and one thread
//   adds 1 to its row group's step counter (release); the producer polls
//   it (acquire), fences, and only then loads.
// * Recompute mode: one launch a rebuild chunk [t0, t1), after that chunk's
//   rebuild product (stream order: the product is done before the chain
//   reads `act`, and the chain before the next product overwrites it).  A
//   launch's first step reads dgates(t1) that the previous launch wrote
//   (no step wait: the launches are ordered), the carries cross launches in
//   dhc and dcc, and only the launch that ends at t = 0 runs the dh0 pass.
//   The counters are zeroed before every launch, on the same stream, so no
//   reset races with a previous launch's tail.
// * One cooperative launch (a chunk), one CTA an SM.  Co-resident or
//   refused (the wrapper raises); a barrier that never fills traps instead
//   of hanging.
//
// What bounds this design (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py's
// persistent_study, CTA 0's SM clock at four points of each pass): a step
// of a row group is a chain of two exchanges through L2, each a
// release-add and an acquire poll (the step's dgates, then the slice's
// partials), around the A stream and 32 dependent wgmmas; PERF.md gives
// each segment's share.

#include "bounds_check.cuh"
#include "rebuild_gates.cuh"

namespace {

namespace tma = rst_grad::tma;
using bf16 = __nv_bfloat16;

constexpr int kSplit = 8;                    // CTAs of a slice: the K split
constexpr int kCellUnits = 8;                // units whose cells a CTA runs
constexpr int kUnits = kSplit * kCellUnits;  // hidden units of a slice: the product's N (64)
constexpr int kRows = 64;                    // rows of a row group: one wgmma M tile
constexpr int kBox = 64 * 64 * 2;            // a 64x64 bf16 box of W_h or dgates (8 KiB)
constexpr int kPart = kRows * kUnits;        // floats of one partial product
constexpr int kSmemLimit = 232448;           // the H100's per-block opt-in

// Threads of a CTA: kWG consumer warpgroups and a producer warp.
template <int kWG>
constexpr int kThreads = 128 * kWG + 32;

long long g_launches = 0;            // persistent launches in gates mode
long long g_recompute_launches = 0;  // persistent launches in recompute mode (one a chunk)
long long g_rebuild_launches = 0;    // rebuild products launched by the recompute entry

struct Args {
  const float* dout;    // (T, B, H) f32
  const bf16* gates;    // gates mode: (T, B, 4H) activated gates (the dgates stream itself)
  const float* act;     // recompute mode: (chunk·B, 4H) f32 activated gates of steps t_lo ..
  bf16* dg;             // (T, B, 4H) dgates out
  const bf16* cseq;     // (T, B, H) carried c
  const float* c0;      // (B, H) initial c as the residual stores it
  const float* mask;    // (T, 1, B) f32 {0, 1}
  float* dhc;           // (B, H) dh carry: dhn on the first launch's entry, dh0 at the end
  float* dcc;           // (B, H) dc carry: dcn on entry, dc0 at the end
  float* part;          // (groups, slices, kSplit, 64, kUnits) f32 partial products
  unsigned* counter;    // groups step counters, then groups x slices slice counters
  int T, B, H, groups;
  int t_lo, t_hi;       // this launch's steps [t_lo, t_hi), walked last first
  int act_rows;         // rows of act (recompute mode), for the bounds checks
  // Planted faults (chip_smoke.py), bits: 1 reads dgates without the step
  // wait, 2 sums the partials without the slice wait (bit 4, the recompute
  // entry's, acts on act_rows alone).
  int skip_barrier;
  // (passes, 4) SM clocks of CTA 0, row group 0 (the step's breakdown,
  // chip_smoke.py's persistent_study), or null: pass s's step barrier
  // passed (producer), product done, the slice's partials all arrived,
  // cell stored and arrived (its warpgroup's first thread).
  long long* stamps;
};

__device__ __forceinline__ void stamp(long long* stamps, int s, int k) {
  if (stamps != nullptr && blockIdx.x == 0) stamps[4 * s + k] = clock64();
}

// K boxes (64 columns) of a CTA's share of the 4H: H/128.
__host__ __device__ constexpr int k_boxes(int H) { return 4 * H / (64 * kSplit); }

// The resident W_h slice, one A buffer a consumer warpgroup, the mbarriers
// (W_h, a release and k_boxes landings a buffer) and the alignment slack.
__host__ __device__ constexpr size_t smem_bytes(int H, int wg) {
  return (size_t)k_boxes(H) * (1 + wg) * kBox + 8 * (1 + wg + wg * k_boxes(H)) + 1024;
}

__device__ __forceinline__ float sig_grad(float a) { return a * (1.0f - a); }

// Four bf16 values (8 bytes) as floats, and back.
__device__ __forceinline__ void unpack4(uint2 v, float (&f)[4]) {
  f[0] = __uint_as_float(v.x << 16);
  f[1] = __uint_as_float(v.x & 0xFFFF0000u);
  f[2] = __uint_as_float(v.y << 16);
  f[3] = __uint_as_float(v.y & 0xFFFF0000u);
}

__device__ __forceinline__ void split4(float4 v, float (&f)[4]) {
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}

__device__ __forceinline__ uint2 pack4(const float (&f)[4]) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(f[0], f[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(f[2], f[3]);
  return make_uint2(*reinterpret_cast<uint32_t*>(&lo), *reinterpret_cast<uint32_t*>(&hi));
}

// kWG consumer warpgroups; kAct: recompute mode (the gates from act).
template <int kWG, bool kAct>
__global__ void __launch_bounds__(kThreads<kWG>, 1)
    bwd_persistent(const __grid_constant__ CUtensorMap map_w,
                   const __grid_constant__ CUtensorMap map_g, Args p) {
  using namespace tma;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int H = p.H, B = p.B, T = p.T, groups = p.groups;
  const int KS = k_boxes(H);                     // K boxes of the CTA's share
  const int kq = 64 * KS;                        // its K columns: 4H / kSplit
  uint8_t* w_s = smem;                           // KS boxes: the W_h slice
  uint8_t* a_s = smem + (size_t)KS * kBox;       // kWG buffers of KS boxes: dgates(t+1)
  uint64_t* wbar = reinterpret_cast<uint64_t*>(a_s + (size_t)kWG * KS * kBox);
  uint64_t* afree = wbar + 1;                    // kWG: the warpgroup is done with its A
  uint64_t* full = afree + kWG;                  // kWG x KS: box k of buffer w has landed
  const int slices = H / kUnits;
  const int q = blockIdx.x % kSplit;             // the CTA's share of K
  const int slice = blockIdx.x / kSplit;
  const unsigned ctas = kSplit * slices;         // CTAs of the grid
  const int steps = p.t_hi - p.t_lo;
  const bool first = p.t_hi == T;                // the launch's pass 0 has no product
  const int passes = steps + (p.t_lo == 0);      // with the dh0 pass at the end
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  RST_CHECK(blockIdx.x, ctas);

  if (threadIdx.x == 0) {
    bar_init(smem_addr(wbar), 1);
    for (int w = 0; w < kWG; ++w) bar_init(smem_addr(&afree[w]), 4);   // each consumer warp
    for (int k = 0; k < kWG * KS; ++k) bar_init(smem_addr(&full[k]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * kWG) {                         // the producer warp
    if (lane == 0) {
      const uint32_t wb = smem_addr(wbar);
      bar_expect_tx(wb, KS * kBox);
      for (int k = 0; k < KS; ++k) {
        RST_CHECK(q * kq + 64 * k, 4 * H);
        RST_CHECK(slice * kUnits, H);
        load_box(smem_addr(w_s + (size_t)k * kBox), &map_w, wb, q * kq + 64 * k,
                 slice * kUnits);
      }
      // Pass s forms the product of dgates(t_hi - s): written by pass s - 1
      // of this launch, or (s = 0) by the previous launch.  Buffer w's u-th
      // use (u = products before this one x its groups a pass + the group's
      // turn) waits for the u-1-th to be released; the first passes.
      for (int s = first ? 1 : 0; s < passes; ++s) {
        const int pi = s - (first ? 1 : 0);      // product passes before this one
        const int row_t = (p.t_hi - s) * B;
        for (int g = 0; g < groups; ++g) {
          const int w = g % kWG;
          const int u = pi * ((groups - w + kWG - 1) / kWG) + g / kWG;
          bar_wait(smem_addr(&afree[w]), (u & 1) ^ 1);
          RST_CHECK(g, groups);
          if (s > 0 && !(p.skip_barrier & 1)) grid_wait(p.counter + g, (unsigned)s * ctas);
          if (g == 0) stamp(p.stamps, s, 0);
          asm volatile("fence.proxy.async.global;" ::: "memory");
          const int row = row_t + g * kRows;
          RST_CHECK(row, (long long)T * B);
          for (int k = 0; k < KS; ++k) {
            const uint32_t fb = smem_addr(&full[w * KS + k]);
            RST_CHECK(q * kq + 64 * k, 4 * H);
            bar_expect_tx(fb, kBox);
            load_box(smem_addr(a_s + (size_t)(w * KS + k) * kBox), &map_g, fb, q * kq + 64 * k,
                     row);
          }
        }
      }
    }
    return;
  }

  // Consumers: thread wt of warpgroup wg runs, for each of its row groups
  // g, the cells of row 64g + wt/2, units j .. j + 3.
  const int tid = threadIdx.x, wg = tid / 128, wt = tid % 128, wwarp = wt / 32;
  const int r_loc = wt / 2;
  const int ju = kCellUnits * q + 4 * (wt % 2);  // unit offset in the slice
  const int j = slice * kUnits + ju;
  const size_t G = 4 * (size_t)H;
  const uint32_t w_base = smem_addr(w_s);
  const uint32_t a_base = smem_addr(a_s + (size_t)wg * KS * kBox);
  const int my_groups = (groups - wg + kWG - 1) / kWG;
  bool w_ready = false;

  for (int s = 0; s < passes; ++s) {
    const int t = p.t_hi - 1 - s;                // -1 in the dh0 pass
    const bool last = s == steps;                // the dh0 pass: dh0, dc0
    const bool product = s > 0 || !first;
    const int pi = s - (first ? 1 : 0);
    for (int gi = 0; gi < my_groups; ++gi) {
      const int g = wg + kWG * gi;
      const int b = g * kRows + r_loc;
      const bool ok = b < B;
      const size_t e = (size_t)b * H + j;
      // The carries and the cell's inputs of step t: they do not wait for
      // the chain.
      float4 dh4 = {}, dc4 = {}, dw = {}, c0w = {};
      uint2 cw = {}, pw = {};
      uint2 gw[4] = {};
      float4 aw[4] = {};
      float m = 0.0f;
      if (ok) {
        RST_CHECK(e + 3, (long long)B * H);
        dh4 = *reinterpret_cast<const float4*>(p.dhc + e);
        dc4 = *reinterpret_cast<const float4*>(p.dcc + e);
        if (!last) {
          const size_t th = (size_t)t * B * H;
          RST_CHECK(th + e + 3, (long long)T * B * H);
          if constexpr (kAct) {
            const size_t arow = (size_t)(t - p.t_lo) * B + b;
            RST_CHECK(arow, p.act_rows);
            const float* a = p.act + arow * G + j;
#pragma unroll
            for (int g4 = 0; g4 < 4; ++g4) aw[g4] = *reinterpret_cast<const float4*>(a + g4 * H);
          } else {
            const bf16* grow = p.gates + ((size_t)t * B + b) * G + j;
#pragma unroll
            for (int g4 = 0; g4 < 4; ++g4) {
              gw[g4] = *reinterpret_cast<const uint2*>(grow + (size_t)g4 * H);
            }
          }
          cw = *reinterpret_cast<const uint2*>(p.cseq + th + e);
          if (t > 0) {
            pw = *reinterpret_cast<const uint2*>(p.cseq + th - (size_t)B * H + e);
          } else {
            c0w = *reinterpret_cast<const float4*>(p.c0 + e);
          }
          dw = *reinterpret_cast<const float4*>(p.dout + th + e);
          RST_CHECK((size_t)t * B + b, (long long)T * B);
          m = p.mask[(size_t)t * B + b];
        }
      }

      // The carry's product: dgates(t+1)[rows, K_q]·W_h[J, K_q]ᵀ, then the
      // slice's kSplit partials summed in the order of q.
      float ph[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (product) {
        if (!w_ready) {
          bar_wait(smem_addr(wbar), 0);          // W_h resident
          w_ready = true;
        }
        const uint32_t par = (uint32_t)((pi * my_groups + gi) & 1);
        float d[32];
        fence_acc(d);
        asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
        for (int k = 0; k < KS; ++k) {
          bar_wait(smem_addr(&full[wg * KS + k]), par);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            mma_64x64x16(d, k_desc(a_base + k * kBox + kk * 32),
                         k_desc(w_base + k * kBox + kk * 32), (k | kk) != 0);
          }
        }
        asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
        fence_acc(d);
        asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
        fence_acc(d);
        if (wt == 0 && gi == 0) stamp(p.stamps, s, 1);
        if (lane == 0) bar_arrive(smem_addr(&afree[wg]));
        const size_t slot = ((size_t)g * slices + slice) * kSplit;
        RST_CHECK((slot + kSplit) * kPart - 1, (long long)groups * slices * kSplit * kPart);
        float* my_part = p.part + (slot + q) * kPart;
#pragma unroll
        for (int jg = 0; jg < kUnits / 8; ++jg)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int row = 16 * wwarp + lane / 4 + 8 * hh, col = 8 * jg + 2 * (lane % 4);
            __stcg(reinterpret_cast<float2*>(my_part + row * kUnits + col),
                   make_float2(d[4 * jg + 2 * hh], d[4 * jg + 2 * hh + 1]));
          }
        asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
        if (wt == 0) {
          RST_CHECK(groups + g * slices + slice, (long long)groups * (1 + slices));
          unsigned* slice_count = p.counter + groups + g * slices + slice;
          __threadfence();
          atomicAdd(slice_count, 1u);
          if (!(p.skip_barrier & 2)) grid_wait(slice_count, (unsigned)(pi + 1) * kSplit);
        }
        asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
        if (wt == 0 && gi == 0) stamp(p.stamps, s, 2);
        const float* slice_part = p.part + slot * kPart + r_loc * kUnits + ju;
        RST_CHECK((slot + kSplit - 1) * kPart + r_loc * kUnits + ju + 3,
                  (long long)groups * slices * kSplit * kPart);
#pragma unroll
        for (int g8 = 0; g8 < kSplit; ++g8) {
          const float4 v = __ldcg(reinterpret_cast<const float4*>(slice_part + g8 * kPart));
          ph[0] += v.x;
          ph[1] += v.y;
          ph[2] += v.z;
          ph[3] += v.w;
        }
      }

      if (last) {                                // dh0; dc0 stays in dcc
        if (ok) {
          *reinterpret_cast<float4*>(p.dhc + e) =
              make_float4(dh4.x + ph[0], dh4.y + ph[1], dh4.z + ph[2], dh4.w + ph[3]);
        }
        continue;
      }

      if (ok) {
        float i_a[4], g_a[4], f_a[4], o_a[4], c_t[4], c_p[4], di[4], dg[4], df[4], dq[4];
        if constexpr (kAct) {
          split4(aw[0], i_a);
          split4(aw[1], g_a);
          split4(aw[2], f_a);
          split4(aw[3], o_a);
        } else {
          unpack4(gw[0], i_a);
          unpack4(gw[1], g_a);
          unpack4(gw[2], f_a);
          unpack4(gw[3], o_a);
        }
        unpack4(cw, c_t);
        if (t > 0) {
          unpack4(pw, c_p);
        } else {
          split4(c0w, c_p);
        }
        const float dout[4] = {dw.x, dw.y, dw.z, dw.w};
        const float dh[4] = {dh4.x, dh4.y, dh4.z, dh4.w};
        const float dc[4] = {dc4.x, dc4.y, dc4.z, dc4.w};
        float dh_out[4], dc_out[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float dh_carry = dh[k] + ph[k];
          const float tanh_c = tanhf(c_t[k]);
          const float dh_new = m * (dout[k] + dh_carry);
          const float do_pre = dh_new * tanh_c * sig_grad(o_a[k]);
          const float dc_new = dh_new * o_a[k] * (1.0f - tanh_c * tanh_c) + m * dc[k];
          di[k] = dc_new * g_a[k] * sig_grad(i_a[k]);
          dg[k] = dc_new * i_a[k] * (1.0f - g_a[k] * g_a[k]);
          df[k] = dc_new * c_p[k] * sig_grad(f_a[k]);
          dq[k] = do_pre;
          dh_out[k] = (1.0f - m) * dh_carry;
          dc_out[k] = (1.0f - m) * dc[k] + dc_new * f_a[k];
        }
        RST_CHECK(((size_t)t * B + b) * G + j + 3 * (size_t)H + 3, (long long)T * B * G);
        bf16* grow = p.dg + ((size_t)t * B + b) * G + j;
        *reinterpret_cast<uint2*>(grow) = pack4(di);
        *reinterpret_cast<uint2*>(grow + H) = pack4(dg);
        *reinterpret_cast<uint2*>(grow + 2 * (size_t)H) = pack4(df);
        *reinterpret_cast<uint2*>(grow + 3 * (size_t)H) = pack4(dq);
        *reinterpret_cast<float4*>(p.dhc + e) =
            make_float4(dh_out[0], dh_out[1], dh_out[2], dh_out[3]);
        *reinterpret_cast<float4*>(p.dcc + e) =
            make_float4(dc_out[0], dc_out[1], dc_out[2], dc_out[3]);
      }
      // dgates(t) of this row group are read by TMA (the async proxy) in
      // every CTA: fence them, meet, and arrive once for the warpgroup.
      asm volatile("fence.proxy.async.global;" ::: "memory");
      asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
      if (wt == 0) {
        RST_CHECK(g, groups);
        __threadfence();
        atomicAdd(p.counter + g, 1u);
        if (gi == 0) stamp(p.stamps, s, 3);
      }
    }
  }
}

// The launch geometry of one plan: kernel attributes set and the grid's
// co-residency checked once a call.
struct Launcher {
  const void* fn;
  int grid, threads, groups, slices;
  size_t smem;
};

template <int kWG, bool kAct>
int prepare(Launcher* l, int H, int groups) {
  const void* fn = reinterpret_cast<const void*>(bwd_persistent<kWG, kAct>);
  l->fn = fn;
  l->slices = H / kUnits;
  l->grid = l->slices * kSplit;
  l->threads = kThreads<kWG>;
  l->groups = groups;
  l->smem = smem_bytes(H, kWG);
  if (l->smem > (size_t)kSmemLimit) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)l->smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, l->threads, l->smem)) !=
          cudaSuccess) {
    return (int)err;
  }
  if (per_sm * sms < l->grid) return (int)cudaErrorCooperativeLaunchTooLarge;
  return 0;
}

// Consumer warpgroups for `groups` row groups: one for one, two past it.
int prepare_for(Launcher* l, int H, int groups, bool act) {
  if (groups == 1) return act ? prepare<1, true>(l, H, groups) : prepare<1, false>(l, H, groups);
  return act ? prepare<2, true>(l, H, groups) : prepare<2, false>(l, H, groups);
}

// The counters zeroed, then one cooperative launch, both on `st`.
int launch_one(const Launcher& l, const CUtensorMap& map_w, const CUtensorMap& map_g,
               const Args& p, cudaStream_t st) {
  cudaError_t err = cudaMemsetAsync(
      p.counter, 0, (size_t)l.groups * (1 + l.slices) * sizeof(unsigned), st);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap mw = map_w, mg = map_g;
  Args a = p;
  void* args[] = {&mw, &mg, &a};
  return (int)cudaLaunchCooperativeKernel(l.fn, l.grid, l.threads, args, l.smem, st);
}

bool valid(int T, int B, int H, int groups) {
  return H % 128 == 0 && groups >= 1 && T >= 1 && B >= 1 && B <= groups * kRows &&
         B > (groups - 1) * kRows;
}

Args common(const float* dout, void* dg, const void* cseq, const float* c0, const float* mask,
            float* dhc, float* dcc, float* part, void* counter, int T, int B, int H, int groups,
            int skip_barrier) {
  Args p = {};
  p.dout = dout;
  p.dg = static_cast<bf16*>(dg);
  p.cseq = static_cast<const bf16*>(cseq);
  p.c0 = c0;
  p.mask = mask;
  p.dhc = dhc;
  p.dcc = dcc;
  p.part = part;
  p.counter = static_cast<unsigned*>(counter);
  p.T = T;
  p.B = B;
  p.H = H;
  p.groups = groups;
  p.skip_barrier = skip_barrier;
  return p;
}

}  // namespace

// Gates mode.  dout (T, B, H) f32; gates (T, B, 4H) bf16: activated gates,
// overwritten with dgates; cseq (T, B, H) bf16; c0 (B, H) f32, the initial
// c rounded as the residual stores it; mask (T, 1, B) f32 {0, 1}; w_h (H,
// 4H) bf16; dhc, dcc (B, H) f32 holding dhn, dcn on entry and dh0, dc0 on
// return; part (groups, H/64, 8, 64, 64) f32 scratch; counter
// groups·(1 + H/64) uint32 of device memory.  The plan (`bwd_plan`):
// groups = ceil(B/64) row groups of 64 rows, one consumer warpgroup for
// one group and two past it, H a multiple of 128; every operand 16-byte
// aligned.  skip_barrier plants faults: bit 1 no wait for the other CTAs'
// dgates, bit 2 no wait for the slice's partials.  stamps, (T + 1, 4) int64 or null, takes CTA 0's SM clock at
// four points of each pass (Args::stamps).  Returns the CUDA error code (0
// = success); cudaErrorCooperativeLaunchTooLarge when the grid cannot be
// co-resident.
extern "C" int rst_lstm_layer_bwd_persistent(const float* dout, void* gates, const void* cseq,
                                             const float* c0, const float* mask,
                                             const void* w_h, float* dhc, float* dcc,
                                             float* part, void* counter, int T, int B, int H,
                                             int groups, int skip_barrier, long long* stamps,
                                             void* stream) {
  if (!valid(T, B, H, groups)) return (int)cudaErrorInvalidValue;
  CUtensorMap map_w, map_g;
  if (!tma::make_map(&map_w, w_h, H, 4 * H) || !tma::make_map(&map_g, gates, T * B, 4 * H)) {
    return (int)cudaErrorInvalidValue;
  }
  Launcher l;
  int err = prepare_for(&l, H, groups, false);
  if (err != 0) return err;
  Args p = common(dout, gates, cseq, c0, mask, dhc, dcc, part, counter, T, B, H, groups,
                  skip_barrier);
  p.gates = static_cast<const bf16*>(gates);
  p.t_lo = 0;
  p.t_hi = T;
  p.stamps = stamps;
  err = launch_one(l, map_w, map_g, p, static_cast<cudaStream_t>(stream));
  if (err == 0) ++g_launches;
  return err;
}

// Recompute mode: as above with dgates (T, B, 4H) bf16 written fresh and
// the gates rebuilt from x (T, B, D) and h_prev (T, B, H) bf16, w_x (D, 4H)
// bf16 and bias (4H) f32.  For the n_chunks chunks that `starts` gives
// (t0[0] > t0[1] > ... > t0[n - 1] = 0; chunk k spans [t0[k], t0[k - 1]),
// chunk 0 ends at T; each at most `chunk` steps), in that order: the
// rebuild product of the chunk into act (chunk·B, 4H) f32 scratch, then one
// persistent launch of the chunk's steps (the last chunk's with the dh0
// pass).  D a multiple of 64; x, h_prev, w_x, w_h 16-byte aligned.
// skip_barrier's bit 4 states act's rows one step short of each chunk's: a
// bound the checked build must trap on at the chunk's first step (its
// positive control); the default build runs the same arithmetic.
extern "C" int rst_lstm_layer_bwd_recompute_persistent(
    const float* dout, void* dgates, const void* cseq, const float* c0, const float* mask,
    const void* w_h, const void* x, const void* h_prev, const void* w_x, const float* bias,
    float* dhc, float* dcc, float* act, float* part, void* counter, const int* starts,
    int n_chunks, int chunk, int T, int B, int H, int D, int groups, int skip_barrier,
    void* stream) {
  if (!valid(T, B, H, groups) || n_chunks <= 0 || chunk <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  for (int k = 0, t1 = T; k < n_chunks; t1 = starts[k++]) {
    const int t0 = starts[k];
    if (t0 < 0 || t0 >= t1 || t1 - t0 > chunk || (k == n_chunks - 1) != (t0 == 0)) {
      return (int)cudaErrorInvalidValue;
    }
  }
  rst_rebuild::Maps maps;
  CUtensorMap map_w, map_g;
  if (!rst_rebuild::make_maps(&maps, x, h_prev, w_x, w_h, T * B, D, H) ||
      !tma::make_map(&map_w, w_h, H, 4 * H) || !tma::make_map(&map_g, dgates, T * B, 4 * H)) {
    return (int)cudaErrorInvalidValue;
  }
  Launcher l;
  int err = prepare_for(&l, H, groups, true);
  if (err != 0) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Args p = common(dout, dgates, cseq, c0, mask, dhc, dcc, part, counter, T, B, H, groups,
                  skip_barrier);
  p.act = act;
  for (int k = 0, t1 = T; k < n_chunks; t1 = starts[k++]) {
    const int t0 = starts[k];
    p.act_rows = (skip_barrier & 4) ? (t1 - t0 - 1) * B : chunk * B;
    if ((err = rst_rebuild::launch(maps, t0 * B, (t1 - t0) * B, D, H, bias, act, st)) != 0) {
      return err;
    }
    ++g_rebuild_launches;
    p.t_lo = t0;
    p.t_hi = t1;
    if ((err = launch_one(l, map_w, map_g, p, st)) != 0) return err;
    ++g_recompute_launches;
  }
  return 0;
}

// Launches of the persistent kernel so far (counted at the launch sites):
// gates mode, recompute mode (one a chunk), and the recompute entry's
// rebuild products.
extern "C" long long rst_layer_bwd_persistent_launches() { return g_launches; }
extern "C" long long rst_recompute_persistent_launches() { return g_recompute_launches; }
extern "C" long long rst_recompute_rebuild_launches() { return g_rebuild_launches; }

// How many clusters of `cluster` CTAs of this kernel's size (one consumer
// warpgroup's threads and shared memory at H) the card co-schedules
// (cudaOccupancyMaxActiveClusters), or -1 on an error: the reading behind
// the K split's exchange through L2.
extern "C" int rst_layer_bwd_max_clusters(int cluster, int H) {
  const size_t smem = smem_bytes(H, 1);
  auto fn = bwd_persistent<1, false>;
  if (cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) !=
      cudaSuccess) {
    return -1;
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(cluster * (H / kUnits));
  cfg.blockDim = dim3(kThreads<1>);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = -1;
  return cudaOccupancyMaxActiveClusters(&n, fn, &cfg) == cudaSuccess ? n : -1;
}
