// The whole stack's LSTM training forward as one persistent Hopper kernel
// (sm_90a): every layer's W_h stays (most of it) in shared memory for all
// T steps, the layers are paced by per-layer counters instead of one
// launch a diagonal, both products on wgmma fed by TMA.
//
// Replaces the TPU kernel `_wavefront_train_kernel` of
// rnn_speech_tpu/ops/lstm_wavefront.py (entry `_wavefront_train`, drop
// modes 0, 1 and 2) at the shapes the wrapper's plan (`wavefront_plan`,
// ops/lstm_wavefront.py) sends here; csrc/lstm_wavefront_train.cu keeps the
// per-diagonal form for the others.  Layer l at step t computes
//
//   gates = b_l + bf16(x_l(t))·W_x,l + bf16(h_l(t-1))·W_h,l   (f32 sums)
//
// with x_0(t) = x[t] and x_l(t) = h_{l-1}(t), or in drop modes 1 and 2 its
// dropped copy h_{l-1}(t)·keep·scale (keep from explicit masks, or the
// Philox bits of (boundary l-1, t), csrc/philox.cuh, the same counters as
// the per-diagonal kernel and the backward), then the cell
//
//   i, g, f, o = σ(i), tanh(g), σ(f + 1), σ(o);  c' = f·c + i·g;  h' = o·tanh(c')
//   c, h <- m·(c', h') + (1 - m)·(c, h)
//
// and stores the backward's bf16 residuals: the activated gates, the
// carried c and the masked undropped output m·h'; hn, cn at the end.
//
// What bounds it on the H100: 2·T·B·H·4H·2L operations, 11.4 ms at the bf16
// tensor rate at the default step's shape (L=3, H=1024, B=64, T=3510: 3.3
// µs a diagonal), against 8.7 GB of inputs and residual stores.  The
// per-diagonal kernel took 53.9 µs a diagonal: one launch a diagonal, the
// three layers' W_h and W_x (48 MiB) re-streamed through L2 every
// diagonal, 2 x 16 dependent 64-wide K chunks a block.
//
// What this design does about it:
// * One cooperative launch, no clusters (the card co-schedules too few).
//   CTA (l, u) owns 24 hidden units of layer l, all four gates: the
//   products' N = 96 columns, [i(24) | g(24) | f(24) | o(24)].  ceil(H/24)
//   CTAs a layer: 43 at H=1024, 129 in all on the 132 SMs (the last CTA
//   of a layer owns 16 units; its padded columns are zero weights and are
//   never stored).
// * W_h resident: the first `resident` 64-wide K chunks of the CTA's 96
//   columns of W_h,l (14 of 16 at H=1024, 168 KiB), loaded once by TMA as
//   a K-major wgmma operand in 128-byte swizzle.  W_x,l and W_h's other
//   chunks stream from L2 through a ring of 12 KiB stages that the
//   producer warp refills ahead with no data dependency.
// * Both A operands by TMA through a ring of 8 KiB stages (64 rows x 64 K):
//   the producer warp waits for each layer counter and then loads the
//   chunks, so the A stream runs as far ahead as the ring allows.  The
//   rings' depths (kWStages = 2 W and kAStages = 4 A stages, W_h's other
//   14 chunks resident) were the fastest of the depths measured (PERF.md).
//   (A
//   design that fed A from registers, the RS form of wgmma, loaded from L2
//   four chunks ahead, paid a whole L2 round trip a chunk all the same,
//   the warpgroup's wgmma fence waiting for all the warp's pending loads;
//   it measured slower and is gone, PERF.md.)
// * Layers paced by per-layer counters, not a grid barrier.  Layer l
//   publishes bf16 h_l(t) (and in drop modes 1 and 2 the dropped copy for
//   the layer above) into slot t % R of a small per-layer ring in global
//   memory, fences it to the async proxy, then one thread releases (a
//   fence, then an add to counter[l]).  The producer of layer l acquires
//   counter[l-1] before it loads x_l(t) and counter[l] before it loads
//   h_l(t-1): the x product is off the layer's serial chain.  Before the
//   consumers overwrite slot t % R they wait until layer l+1 has finished
//   step t - R, so layer 0 runs at most R - 1 steps ahead.  No atomic
//   takes part in the arithmetic: a run repeats bit for bit.
// * The cell in registers: in the m64n96 accumulator, column group
//   j = 3·gate + jj holds units 8·jj + 2q + {0, 1} (q = lane % 4), so each
//   thread holds all four gates of 2 rows x 6 units and their f32 carries
//   for all T steps.  Rows past B are never stored.

#include "grad_matmul.cuh"
#include "philox.cuh"

namespace {

namespace tma = rst_grad::tma;
using bf16 = __nv_bfloat16;

constexpr int kUnits = 24;                  // hidden units a CTA owns, of one layer
constexpr int kN = 4 * kUnits;              // its gate columns: the products' N (96)
constexpr int kRows = 64;                   // batch rows: one wgmma M tile
constexpr int kThreads = 128 + 32;          // a consumer warpgroup and a producer warp
constexpr int kBox = kN * 64 * 2;           // a 96-column x 64-K bf16 box of W (12 KiB)
constexpr int kABox = kRows * 64 * 2;       // a 64-row x 64-K bf16 box of A (8 KiB)
constexpr int kSmemLimit = 232448;          // the H100's per-block opt-in
constexpr int kWStages = 2;                 // ring stages of streamed W boxes
constexpr int kAStages = 4;                 // ring stages of A boxes

long long g_launches = 0;

struct Args {
  const float* bias;        // (L, 4H)
  const float* mask;        // (T, 1, B) f32 {0, 1}
  float* h;                 // (L, B, H) f32: h0 on entry, hn on return
  float* c;                 // (L, B, H) f32: c0 on entry, cn on return
  bf16* outs;               // (L, T, B, H) masked outputs
  bf16* gates;              // (L, T, B, 4H) activated gates
  bf16* cseq;               // (L, T, B, H) carried c
  bf16* ring_h;             // (L, R, 64, H) bf16 h by step (slot t % R; slot R - 1 = h0)
  bf16* ring_x;             // (L - 1, R, 64, H) dropped copies (drop modes 1, 2), or null
  const bf16* drop_masks;   // (L - 1, T, B, H) {0, 1} (drop mode 1), or null
  unsigned* counter;        // (L) CTA-steps each layer has published, zero on entry
  unsigned seed0, seed1, thr;
  float scale;
  int drop_mode;
  int T, B, H, L, slices, ring;
  int resident;             // W_h's K chunks 0 .. resident - 1 kept in shared memory
  int skip_waits;           // a planted fault (chip_smoke.py): no counter waits
  // (T, 5) SM clocks of the first CTA of the top layer (chip_smoke.py's
  // persistent_study), or null, taken by its first consumer thread: step
  // t begun, x product done, the first h box landed, h product done, cell
  // stored and published.
  long long* stamps;
};

__host__ __device__ constexpr size_t smem_bytes(int resident) {
  return (size_t)(resident + kWStages) * kBox + (size_t)kAStages * kABox +
         8 * (1 + 2 * (kWStages + kAStages)) + 1024;
}

// W_h's K chunks kept resident at width H: all H/64, or as many as fit
// beside the rings.
constexpr int resident_chunks(int H) {
  return H / 64 < (int)((kSmemLimit - smem_bytes(0)) / kBox)
             ? H / 64
             : (int)((kSmemLimit - smem_bytes(0)) / kBox);
}

__device__ __forceinline__ uint32_t pack_bf2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float sigmoidf_(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ __forceinline__ void stamp(long long* stamps, int t, int k) {
  if (stamps != nullptr) stamps[5 * t + k] = clock64();
}

__global__ void __launch_bounds__(kThreads, 1)
    wavefront_persistent(const __grid_constant__ CUtensorMap map_wh,
                         const __grid_constant__ CUtensorMap map_wx,
                         const __grid_constant__ CUtensorMap map_x,
                         const __grid_constant__ CUtensorMap map_rh,
                         const __grid_constant__ CUtensorMap map_rx, Args p) {
  using namespace tma;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int H = p.H, KS = H / 64, R = p.ring, RC = p.resident;
  constexpr int SW = kWStages, SA = kAStages;
  uint8_t* w_s = smem;                                   // RC boxes: the resident W_h chunks
  uint8_t* wring = smem + (size_t)RC * kBox;             // SW streamed W boxes
  uint8_t* aring = wring + (size_t)SW * kBox;            // SA A boxes
  uint64_t* wbar = reinterpret_cast<uint64_t*>(aring + (size_t)SA * kABox);
  uint64_t* wbars = wbar + 1;                            // W ring: SW full, SW empty
  uint64_t* abars = wbars + 2 * SW;                      // A ring: SA full, SA empty
  const int l = blockIdx.x / p.slices, u = blockIdx.x % p.slices;
  const int wrow = blockIdx.x * kN;                      // this CTA's rows of the arranged W
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const unsigned n_ctas = (unsigned)p.slices;
  const int B = p.B, T = p.T, L = p.L;
  const bool dropped = p.drop_mode != 0;

  if (threadIdx.x == 0) {
    bar_init(smem_addr(wbar), 1);
    for (int s = 0; s < SW; ++s) {
      bar_init(smem_addr(&wbars[s]), 1);
      bar_init(smem_addr(&wbars[SW + s]), 4);            // each consumer warp releases
    }
    for (int s = 0; s < SA; ++s) {
      bar_init(smem_addr(&abars[s]), 1);
      bar_init(smem_addr(&abars[SA + s]), 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  Ring<SW, kBox> wr{smem_addr(wring), smem_addr(wbars), smem_addr(wbars + SW), 0};
  Ring<SA, kABox> ar{smem_addr(aring), smem_addr(abars), smem_addr(abars + SA), 0};

  if (warp == 4) {                                       // the producer warp
    if (lane == 0) {
      const uint32_t wb = smem_addr(wbar);
      bar_expect_tx(wb, RC * kBox);
      for (int k = 0; k < RC; ++k) {
        load_box(smem_addr(w_s + (size_t)k * kBox), &map_wh, wb, 64 * k, wrow);
      }
      auto load_w = [&](const CUtensorMap* map, int k) {
        const uint32_t s = wr.put();
        load_box(wr.base + s * kBox, map, wr.full + 8 * s, 64 * k, wrow);
      };
      auto load_a = [&](const CUtensorMap* map, int row, int k) {
        const uint32_t s = ar.put();
        load_box(ar.base + s * kABox, map, ar.full + 8 * s, 64 * k, row);
      };
      auto acquire = [&](const unsigned* count, unsigned target) {
        if (!p.skip_waits) grid_wait(count, target);
        asm volatile("fence.proxy.async.global;" ::: "memory");   // the rings are read by TMA
      };
      const CUtensorMap* lower = dropped ? &map_rx : &map_rh;
      for (int t = 0; t < T; ++t) {
        // The x product: x_l(t) (x[t], or the lower layer's ring slot), W_x.
        int xrow = t * B;
        if (l > 0) {
          acquire(p.counter + l - 1, (unsigned)(t + 1) * n_ctas);
          xrow = ((l - 1) * R + t % R) * kRows;
        }
        for (int k = 0; k < KS; ++k) {
          load_a(l == 0 ? &map_x : lower, xrow, k);
          load_w(&map_wx, k);
        }
        // The h product: h_l(t-1) once every CTA of layer l has published it.
        if (t > 0) acquire(p.counter + l, (unsigned)t * n_ctas);
        const int hrow = (l * R + (t - 1 + R) % R) * kRows;
        for (int k = 0; k < KS; ++k) {
          load_a(&map_rh, hrow, k);
          if (k >= RC) load_w(&map_wh, k);
        }
      }
    }
    return;
  }

  // The consumer warpgroup.
  const int G = 4 * H;
  const int q = lane % 4, r0 = 16 * warp + lane / 4;
  const int j0 = u * kUnits;
  const size_t plane = (size_t)kRows * H;
  const bool feeds = l + 1 < L;                          // this layer feeds boundary l
  long long* stamps = (p.stamps != nullptr && blockIdx.x == (L - 1) * p.slices && threadIdx.x == 0)
                          ? p.stamps
                          : nullptr;
  auto unit_ok = [&](int jj) { return j0 + 8 * jj < H; };   // whole groups of 8 units

  // Carries of (row hh, unit group jj, unit e), f32 in registers.
  float c_r[2][3][2], h_r[2][3][2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int b = r0 + 8 * hh;
#pragma unroll
    for (int jj = 0; jj < 3; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = b < B && unit_ok(jj);
        const size_t i = ((size_t)l * B + b) * H + j0 + 8 * jj + 2 * q + e;
        c_r[hh][jj][e] = ok ? p.c[i] : 0.0f;
        h_r[hh][jj][e] = ok ? p.h[i] : 0.0f;
      }
  }

  bar_wait(smem_addr(wbar), 0);                          // the W_h chunks resident
  const uint32_t w_base = smem_addr(w_s);
  bf16* own = p.ring_h + (size_t)l * R * plane;
  bf16* drop_out = dropped && feeds ? p.ring_x + (size_t)l * R * plane : nullptr;
  const float* bias = p.bias + (size_t)l * G;
  float d[48];
  // One 64-wide K chunk: A from the A ring, W resident or from the W ring.
  auto chunk = [&](int c, bool streamed_w, uint32_t w_addr) {
    const uint32_t a = ar.get();
    const uint32_t b = streamed_w ? wr.get() : w_addr;
    fence_acc(d);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      mma_64x96x16(d, k_desc(a + 32 * kk), k_desc(b + 32 * kk), c > 0 || kk > 0);
    }
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    fence_acc(d);
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fence_acc(d);
    ar.release(lane);
    if (streamed_w) wr.release(lane);
  };
  for (int t = 0; t < T; ++t) {
    // This step's masks: in flight while the products run.
    float mk[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int b = r0 + 8 * hh;
      mk[hh] = b < B ? p.mask[(size_t)t * B + b] : 0.0f;
    }
    if (stamps) stamp(stamps, t, 0);
    for (int c = 0; c < KS; ++c) chunk(c, true, 0);
    if (stamps) stamp(stamps, t, 1);
    for (int k = 0; k < KS; ++k) {
      chunk(KS + k, k >= RC, w_base + (uint32_t)(k * kBox));
      if (stamps && k == 0) stamp(stamps, t, 2);
    }
    if (stamps) stamp(stamps, t, 3);

    // Slot t % R last held step t - R: the layer above must be done with it.
    if (feeds && t >= R) {
      if (!p.skip_waits && threadIdx.x == 0) {
        grid_wait(p.counter + l + 1, (unsigned)(t - R + 1) * n_ctas);
      }
      asm volatile("bar.sync 1, 128;" ::: "memory");
    }
    bf16* hslot = own + (size_t)(t % R) * plane;
    bf16* xslot = drop_out == nullptr ? nullptr : drop_out + (size_t)(t % R) * plane;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int b = r0 + 8 * hh;
      const float m = mk[hh];
      const size_t step_row = ((size_t)l * T + t) * B + b;
#pragma unroll
      for (int jj = 0; jj < 3; ++jj) {
        const int j = j0 + 8 * jj + 2 * q;               // units j, j + 1
        const bool ok = b < B && unit_ok(jj);
        float keep[2] = {1.0f, 1.0f};
        if (xslot != nullptr && ok) {
          if (p.drop_mode == 1) {
            const __nv_bfloat162 km = *reinterpret_cast<const __nv_bfloat162*>(
                p.drop_masks + (((size_t)l * T + t) * B + b) * H + j);
            keep[0] = __low2float(km);
            keep[1] = __high2float(km);
          } else {                                         // one Philox call for both units
            const rst::Words4 w = rst::philox4x32_10((uint32_t)j >> 2, (uint32_t)b,
                                                     (uint32_t)t, (uint32_t)l, p.seed0, p.seed1);
            keep[0] = rst::word(w, j & 3) < p.thr ? 1.0f : 0.0f;
            keep[1] = rst::word(w, (j + 1) & 3) < p.thr ? 1.0f : 0.0f;
          }
        }
        float o_v[2], c_v[2], h_v[2], x_v[2], a_v[4][2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float pre[4];
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            // Gate g of unit group jj is column group 3g + jj.
            pre[g] = d[4 * (3 * g + jj) + 2 * hh + e] + (ok ? bias[g * H + j + e] : 0.0f);
          }
          const float i_a = sigmoidf_(pre[0]), g_a = tanhf(pre[1]);
          const float f_a = sigmoidf_(pre[2] + 1.0f), o_a = sigmoidf_(pre[3]);
          const float c_old = c_r[hh][jj][e], h_old = h_r[hh][jj][e];
          const float c_new = f_a * c_old + i_a * g_a;
          const float h_new = o_a * tanhf(c_new);
          const float c_sel = m * c_new + (1.0f - m) * c_old;
          const float h_sel = m * h_new + (1.0f - m) * h_old;
          c_r[hh][jj][e] = c_sel;
          h_r[hh][jj][e] = h_sel;
          o_v[e] = m * h_new;
          c_v[e] = c_sel;
          h_v[e] = h_sel;
          x_v[e] = h_sel * (keep[e] * p.scale);
          a_v[0][e] = i_a;
          a_v[1][e] = g_a;
          a_v[2][e] = f_a;
          a_v[3][e] = o_a;
        }
        if (ok) {
          const size_t e0 = step_row * H + j;
          *reinterpret_cast<uint32_t*>(p.outs + e0) = pack_bf2(o_v[0], o_v[1]);
          *reinterpret_cast<uint32_t*>(p.cseq + e0) = pack_bf2(c_v[0], c_v[1]);
          bf16* gr = p.gates + step_row * G + j;
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            *reinterpret_cast<uint32_t*>(gr + (size_t)g * H) = pack_bf2(a_v[g][0], a_v[g][1]);
          }
          *reinterpret_cast<uint32_t*>(hslot + (size_t)b * H + j) = pack_bf2(h_v[0], h_v[1]);
          if (xslot != nullptr) {
            *reinterpret_cast<uint32_t*>(xslot + (size_t)b * H + j) =
                pack_bf2(x_v[0], x_v[1]);
          }
        }
      }
    }
    // Publish step t: the ring stores are read by TMA (the async proxy) in
    // other CTAs: fence them, meet, and release once for the CTA.
    asm volatile("fence.proxy.async.global;" ::: "memory");
    asm volatile("bar.sync 1, 128;" ::: "memory");
    if (threadIdx.x == 0) {
      __threadfence();
      atomicAdd(p.counter + l, 1u);
    }
    if (stamps) stamp(stamps, t, 4);
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int b = r0 + 8 * hh;
#pragma unroll
    for (int jj = 0; jj < 3; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (b >= B || !unit_ok(jj)) continue;
        const size_t i = ((size_t)l * B + b) * H + j0 + 8 * jj + 2 * q + e;
        p.c[i] = c_r[hh][jj][e];
        p.h[i] = h_r[hh][jj][e];
      }
  }
}

// Tensor map of the arranged weights, row-major (rows, H) bf16, in boxes of
// 64 K columns by kN rows, 128-byte swizzle.
bool make_w_map(CUtensorMap* map, const void* base, long long rows, int cols) {
  const tma::EncodeTiled encode = tma::encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, kN};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// x (T, B, H) bf16 (layer 0's input; D = H); wx, wh (L·slices·96, H) bf16:
// each layer's W_x,l (W_x0 for layer 0) and W_h,l, the columns CTA by CTA
// as [i(24) | g(24) | f(24) | o(24)] (zero rows past H) as rows, K
// contiguous (the wrapper's `wavefront_weights`); bias (L, 4H) f32; mask
// (T, 1, B) f32; h, c (L, B, H) f32 holding h0, c0 on entry and hn, cn on
// return; outs, cseq (L, T, B, H) and gates (L, T, B, 4H) bf16 residuals;
// ring_h (L, ring, 64, H) bf16, zero, with slot ring - 1 holding bf16(h0);
// ring_x (L - 1, ring, 64, H) bf16, zero (drop modes 1 and 2); counter L
// uint32 of device memory.  Dropout: drop_mode 0, 1 (masks (L - 1, T, B, H)
// bf16 {0, 1}) or 2 (Philox bits of (seed0, seed1) under thr); scale =
// 1/keep.  The plan: slices = ceil(H / 24) CTAs a layer (W_h's first
// resident_chunks(H) K chunks resident); 1 <= B <= 64, H a multiple of 64,
// ring >= 2.  skip_waits != 0 plants a
// fault (no counter waits).  stamps, (T, 5) int64 or null,
// takes the SM clock of the top layer's first CTA at five points of each
// step (Args::stamps).  Returns the CUDA error code (0 = success);
// cudaErrorCooperativeLaunchTooLarge when the grid cannot be co-resident.
extern "C" int rst_lstm_wavefront_train_persistent(
    const void* x, const void* wx, const void* wh, const float* bias, const float* mask,
    float* h, float* c, void* outs, void* gates, void* cseq, void* ring_h, void* ring_x,
    const void* drop_masks, void* counter, int T, int B, int H, int L, int slices, int ring,
    int drop_mode, unsigned seed0, unsigned seed1, unsigned thr, float scale, int skip_waits,
    long long* stamps, void* stream) {
  if (H % 64 != 0 || B < 1 || B > kRows || L < 2 || T < 1 || ring < 2 ||
      slices != (H + kUnits - 1) / kUnits || drop_mode < 0 || drop_mode > 2 ||
      (drop_mode != 0 && ring_x == nullptr) || (drop_mode == 1 && drop_masks == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const int resident = resident_chunks(H);
  const size_t smem = smem_bytes(resident);
  const long long rows = (long long)L * slices * kN;
  CUtensorMap map_wh, map_wx, map_x, map_rh, map_rx;
  if (!make_w_map(&map_wh, wh, rows, H) || !make_w_map(&map_wx, wx, rows, H) ||
      !tma::make_map(&map_x, x, T * B, H) || !tma::make_map(&map_rh, ring_h, L * ring * kRows, H)) {
    return (int)cudaErrorInvalidValue;
  }
  if (drop_mode != 0) {
    if (!tma::make_map(&map_rx, ring_x, (L - 1) * ring * kRows, H)) {
      return (int)cudaErrorInvalidValue;
    }
  } else {
    map_rx = map_rh;                                     // unused: layers read ring_h
  }
  cudaError_t err = cudaFuncSetAttribute(wavefront_persistent,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = L * slices;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, wavefront_persistent,
                                                           kThreads, smem)) != cudaSuccess) {
    return (int)err;
  }
  if (per_sm * sms < grid) return (int)cudaErrorCooperativeLaunchTooLarge;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((err = cudaMemsetAsync(counter, 0, L * sizeof(unsigned), st)) != cudaSuccess) {
    return (int)err;
  }
  Args p;
  p.bias = bias;
  p.mask = mask;
  p.h = h;
  p.c = c;
  p.outs = static_cast<bf16*>(outs);
  p.gates = static_cast<bf16*>(gates);
  p.cseq = static_cast<bf16*>(cseq);
  p.ring_h = static_cast<bf16*>(ring_h);
  p.ring_x = static_cast<bf16*>(ring_x);
  p.drop_masks = static_cast<const bf16*>(drop_masks);
  p.counter = static_cast<unsigned*>(counter);
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
  p.ring = ring;
  p.resident = resident;
  p.skip_waits = skip_waits;
  p.stamps = stamps;
  void* args[] = {&map_wh, &map_wx, &map_x, &map_rh, &map_rx, &p};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(wavefront_persistent), grid,
                                    kThreads, args, smem, st);
  if (err == cudaSuccess) ++g_launches;
  return (int)err;
}

// Launches of the persistent kernel so far (counted at the launch site).
extern "C" long long rst_wavefront_persistent_launches() { return g_launches; }
