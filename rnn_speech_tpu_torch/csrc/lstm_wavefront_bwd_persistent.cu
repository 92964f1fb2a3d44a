// The whole stack's LSTM backward on the reverse (layer, time) diagonal as
// one persistent Hopper kernel (sm_90a): W_hᵀ stays (most of it) in shared
// memory for all T steps, the layers are paced by per-layer counters
// instead of one launch a diagonal, both products on wgmma fed by TMA.
//
// Replaces the TPU kernel `_wavefront_bwd_kernel` of
// rnn_speech_tpu/ops/lstm_wavefront.py (entry `_wavefront_bwd`, drop modes
// 0, 1 and 2, and its `fuse_dwx` mode) at the shapes the wrapper's plan
// (`wavefront_bwd_plan`, ops/lstm_wavefront.py) sends here, any batch;
// csrc/lstm_wavefront_bwd.cu keeps the per-diagonal form for the others.
// Layer l at step t = T-1 .. 0 (the top layer leads) takes, from the
// forward's bf16 residuals (activated gates, carried c),
//
//   dout = dout_top(t)                          (the top layer)
//   dout = (dgates_{l+1}(t)·W_x,l+1ᵀ)·keep·scale  (below it; keep·scale = 1
//                                                 in drop mode 0)
//   dh = m·(dout + dh_carry);  do = dh·tanh(c)·o(1-o)
//   dc = dh·o·(1 - tanh²c) + m·dc_carry
//   di = dc·g·i(1-i);  dg = dc·i(1-g²);  df = dc·c_prev·f(1-f)
//   dh_carry' = (1-m)·dh_carry + bf16(dgates)·W_hᵀ;  dc_carry' = (1-m)·dc_carry + dc·f
//
// with c_prev = cseq[t-1] (c0 at t = 0), the bf16 dgates written over the
// gates residual, dh0 and dc0 at the end, and in drop modes 1 and 2
// xdrop_l(t) = bf16(outs_l(t)·keep·scale) of boundary l, the dropped input
// of layer l+1's dW_x contraction.  The keep bit is the explicit mask
// (mode 1) or the Philox bit of counter (j/4, b, t, l) (mode 2,
// csrc/philox.cuh), as the forward drew it: one Philox call gives the
// four units j .. j+3 a thread holds.
//
// What bounds it on the H100: 2·T·B·H·4H·(2L-1) operations, 9.4 ms at the
// bf16 tensor rate at the default step (L=3, H=1024, B=64, T=3510: 2.7 µs a
// diagonal).  The per-diagonal kernel took 66.6 µs a diagonal: one launch
// a diagonal, all layers' W_h and W_x (40 MiB) re-streamed from L2 every
// diagonal, 2·4H/128 dependent cp.async K chunks a block, dgates through
// a parity buffer in global memory.
//
// The budget decides the layout.  Per step, layer l < L-1 forms two
// products with K = 4H (the carry's and dout's), the top layer one: their
// weights are 3 W_h + 2 W_x = 40 MiB of bf16 against 132 x 227 KiB = 29 MiB
// of shared memory, so they cannot all stay resident; and each product's A
// operand is the whole (64, 4H) dgates tile (512 KiB), which every CTA that
// walks all of K would read every step.  Per CTA and step at B=64, H=1024:
//
//   CTA (l, u, q): units 96u .. 96u + 95 of layer l (a slice, N = 96),
//   K = gate q's 1024 columns of 4H (a K split in four, one gate each)
//   resident W_h,l[96 units, gate q]       14 of 16 K chunks    168 KiB
//   streamed W (12 KiB boxes, 2 stages)    W_h's other 2 chunks,
//                                          W_x,l+1's 16 (l < L-1) 24 KiB
//   A = dgates[:, gate q], 8 KiB boxes     16 (carry) + 16 (dout) 32 KiB
//     (4 stages)                           boxes a step
//   partials (64 x 96 f32, one a product)  out through L2         24 KiB each
//   total shared memory                                           225.1 KiB of 227
//
// and ceil(H/96) = 11 slices x 4 = 44 CTAs a layer, 132 in all: the H100's
// SMs, one CTA each.  A slice's A stream is 4 x 128 KiB a product and step
// (5.5 MiB a layer-product for the 11 slices, against the 8 MiB of the
// layered backward's K split in eighths at N = 64); its partials, 4 x 24
// KiB, meet through L2.
//
// What this design does about it:
// * One cooperative launch, no clusters (the card co-schedules too few
//   clusters of CTAs this size, PERF.md).  The producer warp acquires the
//   layer counters and feeds both products by TMA: A boxes of dgates read
//   where they were written, over gates (rows past B in a 64-row box read
//   the next step's rows or TMA's zero fill and reach only product rows
//   that are never stored), and W boxes of W_h,l and W_x,l+1 by 3-D tensor
//   maps, whose rows past H are TMA's zero fill.
// * Layers paced by per-layer counters.  Layer l at step t acquires layer
//   l+1's count of step t (for dout) and its own of step t+1 (for the
//   carry).  dgates stay in the gates residual, which no later step
//   overwrites, so the top layer runs ahead without a ring to bound it.
// * The K split meets through L2 in a fixed order: each CTA stores its
//   partials (the dout product's right after it, then the carry's) into a
//   buffer by step parity, adds 1 to its slice's counter (release), waits
//   for the slice's four (acquire) and sums the four partials of its cells
//   in the order of q.  No atomic takes part in the arithmetic: a run
//   repeats bit for bit.
// * Each CTA then runs the cells of 24 of the slice's 96 units (96u + 24q
//   ..) over its 64 rows: a thread owns a row and 12 units, keeps their dh
//   and dc carries in f32 registers for all T steps, and loads the cell's
//   inputs (the four gates, c, c_prev, the mask, dout_top or the keep
//   bits' inputs) after the products and before the partials' exchange,
//   so the loads overlap the exchange (with two warpgroups, after it, four
//   units at a time, within 168 registers).  It writes dgates over gates,
//   fences them to the async proxy, and one thread adds 1 to the layer's
//   counter (release).

#include <algorithm>

#include "bounds_check.cuh"
#include "dwx_windows.cuh"
#include "philox.cuh"

namespace {

namespace tma = rst_grad::tma;
using bf16 = __nv_bfloat16;

constexpr int kSplit = 4;                    // CTAs of a slice: one gate's K block each
constexpr int kUnits = 96;                   // hidden units of a slice: the products' N
constexpr int kCellUnits = kUnits / kSplit;  // units whose cells a CTA runs (24)
constexpr int kThreadUnits = kCellUnits / 2; // units of a consumer thread (12)
constexpr int kRows = 64;                    // batch rows of a group: one wgmma M tile
constexpr int kBox = kUnits * 64 * 2;        // a 96-unit x 64-K bf16 box of W (12 KiB)
constexpr int kABox = kRows * 64 * 2;        // a 64-row x 64-K bf16 box of dgates (8 KiB)
constexpr int kSmemLimit = 232448;           // the H100's per-block opt-in
constexpr int kWStages = 2;                  // ring stages of streamed W boxes
constexpr int kAStages = 4;                  // ring stages of A boxes
constexpr int kMaxGroups = 2;                // consumer warpgroups (64-row groups) a CTA

// Threads of a CTA: the consumer warpgroups and a producer warp, or with two
// consumer warpgroups a whole producer warpgroup that hands registers to
// them by setmaxnreg.  ptxas compiles a block of 288 or 384 threads within
// 168 registers a thread, whatever setmaxnreg asks; at 384 threads the two
// warpgroups' code fits them without a spill (at 288, 44 bytes spill).
template <int kGroups>
constexpr int kThreads = kGroups == 2 ? 3 * 128 : 128 + 32;

long long g_launches = 0;
long long g_wgmma_products = 0;              // window products launched on the Hopper tile

struct Args {
  const bf16* dout_top;     // (T, B, H) cotangent of the top layer's output
  bf16* gates;              // (L, T, B, 4H) activated gates in, dgates out
  const bf16* cseq;         // (L, T, B, H) carried c
  const float* c0;          // (L, B, H)
  const float* mask;        // (T, 1, B) f32 {0, 1}
  float* dhc;               // (L, B, H) dhn on entry, dh0 on return
  float* dcc;               // (L, B, H) dcn on entry, dc0 on return
  float* part;              // (L, slices, 2, kSplit, 2, 64·groups, 96) partials by step parity
  unsigned* counter;        // the row group's L layer counters (CTA-steps published), then
                            // L x slices slice counters (arrivals), zero at the pass's start
  const bf16* masks;        // (L - 1, T, B, H) {0, 1} (drop mode 1), or null
  const bf16* outs;         // (L, T, B, H) masked outputs (drop modes 1, 2), or null
  bf16* xdrop;              // (L - 1, T, B, H) dropped boundary inputs, out (modes 1, 2), or
                            // the fused dW_x's (L - 1, ring, B, H) ring (mode 2)
  int ring;                 // the window W when xdrop is the ring, else 0
  unsigned seed0, seed1, thr;
  float scale;
  int drop_mode;
  int T, B, H, L, slices;
  int row0;                 // the launch's first batch row
  int d0, d1;               // the launch's window of diagonals
  int resident;             // W_h's K chunks 0 .. resident - 1 of the gate kept in shared memory
  int skip_waits;           // a planted fault (chip_smoke.py): no layer counter waits
  int skip_carries;         // a planted fault (chip_smoke.py): carries not kept past a window
  // (T + 1, 5) SM clocks of CTA 0 (layer 0, chip_smoke.py's
  // persistent_study), or null, taken by its first consumer thread: pass
  // s begun, dout product stored, carry product stored, the slice's
  // partials all arrived, cell stored and published.
  long long* stamps;
};

__host__ __device__ constexpr size_t smem_bytes(int resident, int groups) {
  return (size_t)(resident + kWStages) * kBox + (size_t)kAStages * groups * kABox +
         8 * (1 + 2 * (kWStages + kAStages)) + 1024;
}

// W_h's K chunks (of one gate's H columns) kept resident at width H: all
// H/64, or as many as fit beside the rings.
constexpr int resident_chunks(int H, int groups) {
  return H / 64 < (int)((kSmemLimit - smem_bytes(0, groups)) / kBox)
             ? H / 64
             : (int)((kSmemLimit - smem_bytes(0, groups)) / kBox);
}

__device__ __forceinline__ float sig_grad(float a) { return a * (1.0f - a); }

// Four bf16 values (8 bytes) as floats, and back.
__device__ __forceinline__ void unpack4(uint2 v, float* f) {
  f[0] = __uint_as_float(v.x << 16);
  f[1] = __uint_as_float(v.x & 0xFFFF0000u);
  f[2] = __uint_as_float(v.y << 16);
  f[3] = __uint_as_float(v.y & 0xFFFF0000u);
}

__device__ __forceinline__ uint2 pack4(const float* f) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(f[0], f[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(f[2], f[3]);
  return make_uint2(*reinterpret_cast<uint32_t*>(&lo), *reinterpret_cast<uint32_t*>(&hi));
}

// A 64-column x 96-row box at (col, row) of layer `layer` of a 3-D tensor map.
__device__ __forceinline__ void load_box3(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int col, int row, int layer) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row), "r"(layer)
      : "memory");
}

__device__ __forceinline__ void stamp(long long* stamps, int s, int k) {
  if (stamps != nullptr) stamps[5 * s + k] = clock64();
}

template <int kGroups>
__global__ void __launch_bounds__(kThreads<kGroups>, 1)
    wavefront_bwd_persistent(const __grid_constant__ CUtensorMap map_wh,
                             const __grid_constant__ CUtensorMap map_wx,
                             const __grid_constant__ CUtensorMap map_g, Args p) {
  using namespace tma;
  constexpr int kConsumers = 128 * kGroups;
  constexpr int kAStage = kGroups * kABox;             // one A stage: a 64-row box a group
  constexpr int kPart = kGroups * kRows * kUnits;      // floats of one partial product
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int H = p.H, KQ = H / 64, RC = p.resident;
  constexpr int SW = kWStages, SA = kAStages;
  uint8_t* w_s = smem;                                   // RC boxes: the resident W_h chunks
  uint8_t* wring = smem + (size_t)RC * kBox;             // SW streamed W boxes
  uint8_t* aring = wring + (size_t)SW * kBox;            // SA A stages
  uint64_t* wbar = reinterpret_cast<uint64_t*>(aring + (size_t)SA * kAStage);
  uint64_t* wbars = wbar + 1;                            // W ring: SW full, SW empty
  uint64_t* abars = wbars + 2 * SW;                      // A ring: SA full, SA empty
  const int q = blockIdx.x % kSplit;                     // the CTA's gate: its K block
  const int u = blockIdx.x / kSplit % p.slices;
  const int l = blockIdx.x / (kSplit * p.slices);
  const int T = p.T, B = p.B, L = p.L;
  const unsigned n_layer = kSplit * p.slices;            // CTAs of a layer
  const int wrow = u * kUnits, kcol = q * H;             // the CTA's W rows, its K columns
  const bool has_x = l + 1 < L;                          // dout comes from the layer above
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // The layer's passes in this launch's window: pass s runs on diagonal
  // s + L-1-l.  The range is uniform over the CTA and over its slice.
  const int off = L - 1 - l;
  const int s_lo = max(0, p.d0 - off), s_hi = min(T, p.d1 - off);
  if (s_lo > s_hi) return;

  if (threadIdx.x == 0) {
    bar_init(smem_addr(wbar), 1);
    for (int s = 0; s < SW; ++s) {
      bar_init(smem_addr(&wbars[s]), 1);
      bar_init(smem_addr(&wbars[SW + s]), 4 * kGroups);  // each consumer warp releases
    }
    for (int s = 0; s < SA; ++s) {
      bar_init(smem_addr(&abars[s]), 1);
      bar_init(smem_addr(&abars[SA + s]), 4 * kGroups);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  Ring<SW, kBox> wr{smem_addr(wring), smem_addr(wbars), smem_addr(wbars + SW), 0};
  Ring<SA, kAStage> ar{smem_addr(aring), smem_addr(abars), smem_addr(abars + SA), 0};

  if (warp >= 4 * kGroups) {                             // the producer warp(group)
    if constexpr (kGroups == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    if (warp == 4 * kGroups && lane == 0) {
      const uint32_t wb = smem_addr(wbar);
      bar_expect_tx(wb, RC * kBox);
      for (int k = 0; k < RC; ++k) {
        load_box3(smem_addr(w_s + (size_t)k * kBox), &map_wh, wb, kcol + 64 * k, wrow, l);
      }
      auto load_w = [&](const CUtensorMap* map, int layer, int k) {
        const uint32_t s = wr.put();
        load_box3(wr.base + s * kBox, map, wr.full + 8 * s, kcol + 64 * k, wrow, layer);
      };
      auto load_a = [&](int row, int k) {                // a 64-row box for each group
        const uint32_t s = ar.put();
#pragma unroll
        for (int g = 0; g < kGroups; ++g) {
          RST_CHECK(row + kRows * g, (long long)L * T * B);
          RST_CHECK(kcol + 64 * k, 4 * (long long)H);
          load_box(ar.base + s * kAStage + g * kABox, &map_g, ar.full + 8 * s, kcol + 64 * k,
                   row + kRows * g);
        }
      };
      auto acquire = [&](const unsigned* count, unsigned target) {
        RST_CHECK(count - p.counter, L);
        if (!p.skip_waits) grid_wait(count, target);
        asm volatile("fence.proxy.async.global;" ::: "memory");   // dgates are read by TMA
      };
      // Pass s (0 .. T) runs step t = T-1-s; pass T only forms dh0's product.
      for (int s = s_lo; s <= s_hi; ++s) {
        const int t = T - 1 - s;
        if (has_x && s < T) {                            // dout: dgates_{l+1}(t), W_x,l+1
          acquire(p.counter + l + 1, (unsigned)(s + 1) * n_layer);
          const int row = ((l + 1) * T + t) * B + p.row0;
          for (int k = 0; k < KQ; ++k) {
            load_a(row, k);
            load_w(&map_wx, l, k);
          }
        }
        if (s > 0) {                                     // the carry: dgates_l(t+1), W_h,l
          acquire(p.counter + l, (unsigned)s * n_layer);
          const int row = (l * T + t + 1) * B + p.row0;
          for (int k = 0; k < KQ; ++k) {
            load_a(row, k);
            if (k >= RC) load_w(&map_wh, l, k);
          }
        }
      }
    }
    return;
  }

  if constexpr (kGroups == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
  // The consumer warpgroups: warpgroup wg runs rows row0 + 64·wg ..; in it
  // thread i runs row i/2, units j .. j+11.
  const int tid = threadIdx.x;
  const int wg = tid / 128, wt = tid % 128, wwarp = wt / 32;
  const int r = kRows * wg + wt / 2;                     // the thread's row of the launch
  const int b = p.row0 + r;
  const bool row_ok = b < B;
  const int jc = kCellUnits * q + kThreadUnits * (wt % 2);   // unit offset in the slice
  const int j = wrow + jc;
  const size_t G = 4 * (size_t)H;
  const bool dropped = p.drop_mode != 0 && has_x;
  auto group_ok = [&](int k) { return row_ok && j + 4 * k < H; };   // whole groups of 4
  long long* stamps = (p.stamps != nullptr && blockIdx.x == 0 && tid == 0) ? p.stamps : nullptr;

  float dh[kThreadUnits], dc[kThreadUnits];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const size_t e = ((size_t)l * B + b) * H + j + 4 * k;
    if (group_ok(k)) RST_CHECK(e + 3, (long long)L * B * H);
    const float4 vh = group_ok(k) ? *reinterpret_cast<const float4*>(p.dhc + e)
                                  : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const float4 vc = group_ok(k) ? *reinterpret_cast<const float4*>(p.dcc + e)
                                  : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    dh[4 * k] = vh.x, dh[4 * k + 1] = vh.y, dh[4 * k + 2] = vh.z, dh[4 * k + 3] = vh.w;
    dc[4 * k] = vc.x, dc[4 * k + 1] = vc.y, dc[4 * k + 2] = vc.z, dc[4 * k + 3] = vc.w;
  }

  bar_wait(smem_addr(wbar), 0);                          // the W_h chunks resident
  const uint32_t w_base = smem_addr(w_s);
  const uint32_t a_off = wg * kABox;                     // this warpgroup's half of an A stage
  unsigned* slice_count = p.counter + L + l * p.slices + u;
  float* slice_part = p.part + (size_t)(l * p.slices + u) * 2 * kSplit * 2 * kPart;
  auto part_at = [&](int par, int qq, int kind) {
    const size_t o = ((size_t)(par * kSplit + qq) * 2 + kind) * kPart;
    RST_CHECK((size_t)(l * p.slices + u) * 2 * kSplit * 2 * kPart + o + kPart - 1,
              (long long)L * p.slices * 2 * kSplit * 2 * kPart);
    return slice_part + o;
  };
  float d[48];
  // One 64-wide K chunk: A from the A ring, W resident or from the W ring.
  auto chunk = [&](int c, bool streamed_w, uint32_t w_addr) {
    const uint32_t a = ar.get() + a_off;
    const uint32_t wb = streamed_w ? wr.get() : w_addr;
    fence_acc(d);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      mma_64x96x16(d, k_desc(a + 32 * kk), k_desc(wb + 32 * kk), c > 0 || kk > 0);
    }
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    fence_acc(d);
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fence_acc(d);
    ar.release(lane);
    if (streamed_w) wr.release(lane);
  };
  // This thread's accumulator elements into a partial (L2 only).
  auto store_part = [&](float* dst) {
#pragma unroll
    for (int jg = 0; jg < kUnits / 8; ++jg)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = kRows * wg + 16 * wwarp + lane / 4 + 8 * hh, col = 8 * jg + 2 * (lane % 4);
        __stcg(reinterpret_cast<float2*>(dst + row * kUnits + col),
               make_float2(d[4 * jg + 2 * hh], d[4 * jg + 2 * hh + 1]));
      }
  };

  bool finished = false;                                 // pass T ran: dh0, dc0 stored
  for (int s = s_lo; s <= s_hi; ++s) {
    const int t = T - 1 - s, par = s & 1;
    const bool hx = has_x && s < T, hc = s > 0;
    if (stamps) stamp(stamps, s, 0);
    if (hx) {
      for (int c = 0; c < KQ; ++c) chunk(c, true, 0);
      store_part(part_at(par, q, 0));
    }
    if (stamps) stamp(stamps, s, 1);
    if (hc) {
      for (int k = 0; k < KQ; ++k) chunk(k, k >= RC, w_base + (uint32_t)(k * kBox));
      store_part(part_at(par, q, 1));
    }
    if (stamps) stamp(stamps, s, 2);

    // The cell's inputs of step t (c0, read once a pass, is read in the
    // cell).  xw is the top layer's dout_top, or below it the outs that
    // dropout scales into xdrop.  One warpgroup (up to 255 registers)
    // loads them before the partials' exchange, so they are in flight
    // during it, and sums all its partials after it.  Two warpgroups (168
    // registers: 384 threads) hold neither across the exchange: after it,
    // each group of four units sums its partials and loads its inputs one
    // group ahead of its cell (all at once, they spill).
    constexpr bool kByGroup = kGroups == 2;
    uint2 gw[4][3] = {}, cw[3] = {}, pw[3] = {}, xw[3] = {}, kw[3] = {};
    if (s < T && row_ok) RST_CHECK((size_t)t * B + b, (long long)T * B);
    const float m = s < T && row_ok ? p.mask[(size_t)t * B + b] : 0.0f;
    auto load_inputs = [&](int k) {
      if (s < T && group_ok(k)) {
        const size_t th = ((size_t)l * T + t) * B * H;   // (l, t) plane of a (., T, B, H) stream
        const size_t e = (size_t)b * H + j + 4 * k;
        const bf16* grow = p.gates + (((size_t)l * T + t) * B + b) * G + j + 4 * k;
        RST_CHECK((((size_t)l * T + t) * B + b) * G + j + 4 * k + 3 * H + 3,
                  (long long)L * T * B * G);
        RST_CHECK(th + e + 3, (long long)L * T * B * H);
#pragma unroll
        for (int g = 0; g < 4; ++g) gw[g][k] = *reinterpret_cast<const uint2*>(grow + g * H);
        cw[k] = *reinterpret_cast<const uint2*>(p.cseq + th + e);
        if (t > 0) pw[k] = *reinterpret_cast<const uint2*>(p.cseq + th - (size_t)B * H + e);
        if (!has_x) xw[k] = *reinterpret_cast<const uint2*>(p.dout_top + (size_t)t * B * H + e);
        if (dropped) {
          xw[k] = *reinterpret_cast<const uint2*>(p.outs + th + e);
          if (p.drop_mode == 1) kw[k] = *reinterpret_cast<const uint2*>(p.masks + th + e);
        }
      }
    };
    float px[kThreadUnits] = {}, ph[kThreadUnits] = {};
    auto sum_partials = [&](int k) {                     // in the order of q
      const size_t o = (size_t)r * kUnits + jc + 4 * k;
#pragma unroll
      for (int qq = 0; qq < kSplit; ++qq) {
        if (hx) {
          const float4 v = __ldcg(reinterpret_cast<const float4*>(part_at(par, qq, 0) + o));
          px[4 * k] += v.x, px[4 * k + 1] += v.y, px[4 * k + 2] += v.z, px[4 * k + 3] += v.w;
        }
        if (hc) {
          const float4 v = __ldcg(reinterpret_cast<const float4*>(part_at(par, qq, 1) + o));
          ph[4 * k] += v.x, ph[4 * k + 1] += v.y, ph[4 * k + 2] += v.z, ph[4 * k + 3] += v.w;
        }
      }
    };
    if constexpr (!kByGroup) {
#pragma unroll
      for (int k = 0; k < 3; ++k) load_inputs(k);
    }

    // The slice's partials: arrive, wait for the four, sum in the order of q.
    asm volatile("bar.sync 1, %0;" ::"r"(kConsumers) : "memory");
    if (tid == 0) {
      RST_CHECK(L + l * p.slices + u, (long long)L * (1 + p.slices));
      __threadfence();
      atomicAdd(slice_count, 1u);
      grid_wait(slice_count, (unsigned)(s + 1) * kSplit);
    }
    asm volatile("bar.sync 1, %0;" ::"r"(kConsumers) : "memory");
    if (stamps) stamp(stamps, s, 3);
    if constexpr (kByGroup) {
      load_inputs(0);
    } else {
#pragma unroll
      for (int k = 0; k < 3; ++k) sum_partials(k);
    }

    if (s == T) {                                        // the last pass: dh0, dc0
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        if constexpr (kByGroup) sum_partials(k);
        if (!group_ok(k)) continue;
        const size_t e = ((size_t)l * B + b) * H + j + 4 * k;
        *reinterpret_cast<float4*>(p.dhc + e) =
            make_float4(dh[4 * k] + ph[4 * k], dh[4 * k + 1] + ph[4 * k + 1],
                        dh[4 * k + 2] + ph[4 * k + 2], dh[4 * k + 3] + ph[4 * k + 3]);
        *reinterpret_cast<float4*>(p.dcc + e) =
            make_float4(dc[4 * k], dc[4 * k + 1], dc[4 * k + 2], dc[4 * k + 3]);
      }
      finished = true;
      break;
    }

#pragma unroll
    for (int k = 0; k < 3; ++k) {
      if constexpr (kByGroup) {
        sum_partials(k);
        if (k + 1 < 3) load_inputs(k + 1);               // in flight during this group's cell
      }
      if (!group_ok(k)) continue;
      float i_a[4], g_a[4], f_a[4], o_a[4], c_t[4], c_p[4], x_in[4], di[4], dg[4], df[4], dq[4];
      unpack4(gw[0][k], i_a);
      unpack4(gw[1][k], g_a);
      unpack4(gw[2][k], f_a);
      unpack4(gw[3][k], o_a);
      unpack4(cw[k], c_t);
      if (t > 0) {
        unpack4(pw[k], c_p);
      } else {
        const float4 v = *reinterpret_cast<const float4*>(p.c0 + ((size_t)l * B + b) * H + j +
                                                          4 * k);
        c_p[0] = v.x, c_p[1] = v.y, c_p[2] = v.z, c_p[3] = v.w;
      }
      unpack4(xw[k], x_in);             // dout_top (top layer) or outs
      float ks[4] = {1.0f, 1.0f, 1.0f, 1.0f};
      if (dropped) {                                     // boundary l's keep·scale
        if (p.drop_mode == 1) {
          unpack4(kw[k], ks);
        } else {                                         // one Philox call for four units
          const rst::Words4 w = rst::philox4x32_10((uint32_t)(j + 4 * k) >> 2, (uint32_t)b,
                                                   (uint32_t)t, (uint32_t)l, p.seed0, p.seed1);
#pragma unroll
          for (int e = 0; e < 4; ++e) ks[e] = w.w[e] < p.thr ? 1.0f : 0.0f;
        }
        float xd[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ks[e] *= p.scale;
          xd[e] = x_in[e] * ks[e];
        }
        // The stream's (l, t) plane, or the ring's slot of this diagonal.
        const size_t plane = p.ring > 0 ? (size_t)l * p.ring + p.ring - 1 - (s + off) % p.ring
                                        : (size_t)l * T + t;
        RST_CHECK((plane * B + b) * H + j + 4 * k + 3,
                  (long long)(p.ring > 0 ? (L - 1) * p.ring : (L - 1) * T) * B * H);
        *reinterpret_cast<uint2*>(p.xdrop + (plane * B + b) * H + j + 4 * k) = pack4(xd);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * k + e;
        const float dout = has_x ? px[i] * ks[e] : x_in[e];
        const float dh_carry = dh[i] + ph[i];
        const float tanh_c = tanhf(c_t[e]);
        const float dh_new = m * (dout + dh_carry);
        const float do_pre = dh_new * tanh_c * sig_grad(o_a[e]);
        const float dc_new = dh_new * o_a[e] * (1.0f - tanh_c * tanh_c) + m * dc[i];
        di[e] = dc_new * g_a[e] * sig_grad(i_a[e]);
        dg[e] = dc_new * i_a[e] * (1.0f - g_a[e] * g_a[e]);
        df[e] = dc_new * c_p[e] * sig_grad(f_a[e]);
        dq[e] = do_pre;
        dh[i] = (1.0f - m) * dh_carry;
        dc[i] = (1.0f - m) * dc[i] + dc_new * f_a[e];
      }
      bf16* grow = p.gates + (((size_t)l * T + t) * B + b) * G + j + 4 * k;
      RST_CHECK((((size_t)l * T + t) * B + b) * G + j + 4 * k + 3 * H + 3,
                (long long)L * T * B * G);
      *reinterpret_cast<uint2*>(grow) = pack4(di);
      *reinterpret_cast<uint2*>(grow + H) = pack4(dg);
      *reinterpret_cast<uint2*>(grow + 2 * (size_t)H) = pack4(df);
      *reinterpret_cast<uint2*>(grow + 3 * (size_t)H) = pack4(dq);
    }
    // dgates(t) are read by TMA (the async proxy) in other CTAs: fence them,
    // meet, and release once for the CTA.
    asm volatile("fence.proxy.async.global;" ::: "memory");
    asm volatile("bar.sync 1, %0;" ::"r"(kConsumers) : "memory");
    if (tid == 0) {
      RST_CHECK(l, L);
      __threadfence();
      atomicAdd(p.counter + l, 1u);
    }
    if (stamps) stamp(stamps, s, 4);
  }
  // The window ends before pass T: the f32 carries wait in dhc/dcc for the
  // next window's launch.
  if (!finished && !p.skip_carries) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      if (!group_ok(k)) continue;
      const size_t e = ((size_t)l * B + b) * H + j + 4 * k;
      *reinterpret_cast<float4*>(p.dhc + e) = make_float4(dh[4 * k], dh[4 * k + 1], dh[4 * k + 2],
                                                          dh[4 * k + 3]);
      *reinterpret_cast<float4*>(p.dcc + e) = make_float4(dc[4 * k], dc[4 * k + 1], dc[4 * k + 2],
                                                          dc[4 * k + 3]);
    }
  }
}

// Tensor map of the (L, H, 4H) bf16 weights w, as 3-D (4H, H, L) in boxes
// of 64 K columns by 96 rows of one layer, 128-byte swizzle; rows past H
// fill zeros.
bool make_w_map(CUtensorMap* map, const void* w, int layers, int H) {
  const tma::EncodeTiled encode = tma::encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)4 * H, (cuuint64_t)H, (cuuint64_t)layers};
  const cuuint64_t strides[2] = {(cuuint64_t)4 * H * 2, (cuuint64_t)4 * H * H * 2};
  const cuuint32_t box[3] = {64, kUnits, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(w), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// One cooperative launch of the kernel with kGroups consumer warpgroups on
// p's rows and window.
template <int kGroups>
int launch(const CUtensorMap& map_wh, const CUtensorMap& map_wx, const CUtensorMap& map_g,
           Args& p, cudaStream_t st) {
  p.resident = resident_chunks(p.H, kGroups);
  const size_t smem = smem_bytes(p.resident, kGroups);
  const int threads = kThreads<kGroups>;
  auto kernel = wavefront_bwd_persistent<kGroups>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = p.L * p.slices * kSplit;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem)) !=
          cudaSuccess) {
    return (int)err;
  }
  if (per_sm * sms < grid) return (int)cudaErrorCooperativeLaunchTooLarge;
  CUtensorMap mh = map_wh, mx = map_wx, mg = map_g;
  void* args[] = {&mh, &mx, &mg, &p};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), grid, threads, args,
                                    smem, st);
  if (err == cudaSuccess) ++g_launches;
  return (int)err;
}

}  // namespace

// dout_top (T, B, H) bf16; w_h (L, H, 4H), w_x (L-1, H, 4H) bf16 (layers
// 1..L-1's W_x, as the layers' own rows: no arranged copy); mask (T, 1, B)
// f32 {0, 1}; gates (L, T, B, 4H) bf16: activated gates, overwritten with
// dgates; cseq (L, T, B, H) bf16; c0 (L, B, H) f32; dhc, dcc (L, B, H) f32
// holding dhn, dcn on entry and dh0, dc0 on return; part (L, slices, 2, 4,
// 2, 64·min(2, ceil(B/64)), 96) f32 scratch; counter ceil(B/128)·L·(1 +
// slices) uint32 of device memory.  Dropout: drop_mode 0, 1 (masks (L-1,
// T, B, H) bf16 {0, 1}) or 2 (Philox bits of (seed0, seed1) under thr);
// scale = 1/keep; in modes 1 and 2 outs (L, T, B, H) bf16, the forward's
// masked outputs, and xdrop (L-1, T, B, H) bf16, which receives
// bf16(outs·keep·scale) of boundaries 0..L-2.  Fused dW_x (window W > 0,
// drop modes 0 and 2): dwx (L-1, H, 4H) f32, zero on entry, receives dW_x
// of layers 1..L-1; outs is read in both modes, and xdrop is the (L-1, W,
// B, H) bf16 ring in mode 2 (null in mode 0); dwx_path picks the window
// products' tile (rst_grad::Path).  The plan (`wavefront_bwd_plan`):
// slices = ceil(H / 96) slices x 4 CTAs a layer, row groups of at most 128
// rows in turn (two warpgroups a CTA past 64 rows), W_h's first
// resident_chunks(H, warpgroups) K chunks of each gate resident; H a
// multiple of 64.  skip_waits != 0 plants a fault (no layer counter
// waits); skip_carries != 0 another (the carries are not kept past a
// window's end: the next window starts from dhn, dcn).  stamps, (T + 1, 5)
// int64 or null, takes CTA 0's SM clock at five points of each pass
// (Args::stamps).  Returns the CUDA error code (0 = success);
// cudaErrorCooperativeLaunchTooLarge when the grid cannot be co-resident.
extern "C" int rst_lstm_wavefront_bwd_persistent(
    const void* dout_top, const void* w_h, const void* w_x, const float* mask, void* gates,
    const void* cseq, const float* c0, float* dhc, float* dcc, float* part, void* counter,
    int T, int B, int H, int L, int slices, int drop_mode, const void* masks, const void* outs,
    void* xdrop, unsigned seed0, unsigned seed1, unsigned thr, float scale, int window,
    float* dwx, int dwx_path, int skip_waits, int skip_carries, long long* stamps,
    void* stream) {
  if (H % 64 != 0 || B < 1 || L < 2 || T < 1 || window < 0 ||
      slices != (H + kUnits - 1) / kUnits || drop_mode < 0 || drop_mode > 2 ||
      (drop_mode != 0 && (outs == nullptr || xdrop == nullptr)) ||
      (drop_mode == 1 && masks == nullptr) ||
      (window > 0 && (drop_mode == 1 || dwx == nullptr || outs == nullptr)) ||
      (long long)L * T * B > 0x7FFFFFFF) {
    return (int)cudaErrorInvalidValue;
  }
  CUtensorMap map_wh, map_wx, map_g;
  if (!make_w_map(&map_wh, w_h, L, H) || !make_w_map(&map_wx, w_x, L - 1, H) ||
      !tma::make_map(&map_g, gates, L * T * B, 4 * H)) {
    return (int)cudaErrorInvalidValue;
  }
  const int groups = (B + kMaxGroups * kRows - 1) / (kMaxGroups * kRows);
  const size_t group_counters = (size_t)L * (1 + slices);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(counter, 0, groups * group_counters * sizeof(unsigned), st);
  if (err != cudaSuccess) return (int)err;
  Args p;
  p.dout_top = static_cast<const bf16*>(dout_top);
  p.gates = static_cast<bf16*>(gates);
  p.cseq = static_cast<const bf16*>(cseq);
  p.c0 = c0;
  p.mask = mask;
  p.dhc = dhc;
  p.dcc = dcc;
  p.part = part;
  p.masks = drop_mode == 1 ? static_cast<const bf16*>(masks) : nullptr;
  p.outs = static_cast<const bf16*>(outs);
  p.xdrop = drop_mode != 0 ? static_cast<bf16*>(xdrop) : nullptr;
  p.ring = window;
  p.seed0 = seed0;
  p.seed1 = seed1;
  p.thr = thr;
  p.scale = scale;
  p.drop_mode = drop_mode;
  p.T = T;
  p.B = B;
  p.H = H;
  p.L = L;
  p.slices = slices;
  p.skip_waits = skip_waits;
  p.skip_carries = skip_carries;
  p.stamps = stamps;
  // Window-major, row-group-minor; the unfused pass is one window of every
  // diagonal and pass T.  The last window also takes the passes T (dh0's
  // products) of the layers whose diagonal T + L-1-l lies past the last.
  const int n_diag = T + L - 1, step = window > 0 ? window : n_diag;
  for (int s0 = 0; s0 < n_diag; s0 += step) {
    const int s1 = std::min(s0 + step, n_diag) - 1;
    p.d0 = s0;
    p.d1 = s1 == n_diag - 1 ? n_diag : s1;
    for (int g = 0; g < groups; ++g) {
      p.row0 = g * kMaxGroups * kRows;
      p.counter = static_cast<unsigned*>(counter) + g * group_counters;
      const int rc = B - p.row0 > kRows ? launch<2>(map_wh, map_wx, map_g, p, st)
                                        : launch<1>(map_wh, map_wx, map_g, p, st);
      if (rc != 0) return rc;
    }
    if (window > 0) {
      const int rc = rst_dwx::accumulate(p.outs, p.xdrop, p.gates, T, B, H, L, s0, s1, window,
                                         dwx_path, dwx, g_wgmma_products, st);
      if (rc != 0) return rc;
    }
  }
  return (int)cudaGetLastError();
}

// Launches of the persistent kernel so far (counted at the launch site).
extern "C" long long rst_wavefront_bwd_persistent_launches() { return g_launches; }

// Window products of the fused passes launched on the Hopper tile so far.
extern "C" long long rst_bwd_persistent_wgmma_products() { return g_wgmma_products; }
