// The whole stack's LSTM inference forward as one persistent Hopper kernel
// (sm_90a): every layer's W_h stays (most of it) in shared memory for all
// T steps, the layers are paced by per-layer counters instead of one
// launch a diagonal, both products on wgmma fed by TMA.
//
// Replaces the TPU kernel `_wavefront_kernel` of
// rnn_speech_tpu/ops/lstm_wavefront.py (entry `lstm_stack_wavefront`) at
// the shapes the wrapper's plan (`wavefront_eval_plan`,
// ops/lstm_wavefront.py) sends here; csrc/lstm_wavefront.cu keeps the
// per-diagonal form for the others.  Layer l at step t computes
//
//   layer 0:  gates = xp0[t] + bf16(h_0(t-1))·W_h,0              (xp0 f32)
//   above:    gates = b_l + bf16(h_{l-1}(t))·W_x,l + bf16(h_l(t-1))·W_h,l
//
// with f32 sums, then the cell
//
//   i, g, f, o = σ(i), tanh(g), σ(f + 1), σ(o);  c' = f·c + i·g;  h' = o·tanh(c')
//   c, h <- m·(c', h') + (1 - m)·(c, h)
//
// and stores the top layer's masked output m·h' in f32; hn, cn at the end.
// Layer l >= 1 reads the lower layer's carried h, as the TPU kernel does.
//
// What bounds it on the H100: 2·T·B·H·4H·(2L-1) operations, 5.6 ms at the
// bf16 tensor rate at the serving shape (L=3, H=1024, B=128, T=1024: 5.4 µs
// a diagonal), against 2.1 GB of f32 xp0 (0.6 ms at 3.35 TB/s).  The
// per-diagonal kernel took 66.2 µs a diagonal: one launch a diagonal, the
// stack's W_h and W_x (40 MiB) re-streamed from L2 every diagonal in
// dependent 64-wide K chunks, h between layers and the f32 carries in
// global memory.
//
// What this design does about it (csrc/lstm_wavefront_persistent.cu's,
// the training forward's, without its dropout and residual stores):
// * One cooperative launch, no clusters.  CTA (l, u) owns 24 hidden units
//   of layer l, all four gates: the products' N = 96 columns, [i(24) |
//   g(24) | f(24) | o(24)] (the wrapper's `wavefront_weights`).
//   ceil(H/24) CTAs a layer: 43 at H=1024, 129 in all on 132 SMs.
// * Both row groups in one CTA.  B=128 is two 64-row wgmma tiles, and there
//   is no room for a second grid, so a CTA runs kGroups = ceil(B/64) consumer
//   warpgroups that share its resident W_h and its streamed W boxes, each
//   with its own m64n96 accumulator and its own half of each A stage (one
//   TMA box of 64·kGroups rows).  The shared-memory plan per CTA (H=1024):
//
//                          B=128 (2 groups)     B <= 64 (1 group)
//     W ring, 2 x 12 KiB        24 KiB               24 KiB
//     A ring, 4 stages          64 KiB (16 KiB)      32 KiB (8 KiB)
//     W_h resident, 12 KiB a    11 of 16 chunks      14 of 16 chunks
//     K chunk                   132 KiB              168 KiB
//     total (+ barriers, align) 221.1 KiB            225.1 KiB of 227
//
// * Layer 0 has no x product: its consumers read the step's f32 xp0 for
//   their own accumulator elements (two adjacent columns a load) before
//   the h product and add it in the epilogue, as the other layers add their
//   bias.  Layer 0 streams no W_x; it leads the other layers by up to
//   R - 1 steps, so these loads are off the stack's pace.
// * Layers paced by per-layer counters, not a grid barrier: layer l
//   publishes bf16 h_l(t) into slot t % R of a per-layer ring in global
//   memory, fences it to the async proxy, then one thread releases (a
//   fence, then an add to counter[l]).  The producer warp of layer l
//   acquires counter[l-1] before it loads x_l(t) and counter[l] before it
//   loads h_l(t-1).  Before the consumers overwrite slot t % R they wait
//   until layer l+1 has finished step t - R.  No atomic takes part in the
//   arithmetic: a run repeats bit for bit.
// * The cell in registers: in each m64n96 accumulator, column group
//   j = 3·gate + jj holds units 8·jj + 2q + {0, 1} (q = lane % 4), so each
//   thread holds all four gates of 2 rows x 6 units and their f32 carries
//   for all T steps.  Rows past B are never stored.

#include "bounds_check.cuh"
#include "grad_matmul.cuh"

namespace {

namespace tma = rst_grad::tma;
using bf16 = __nv_bfloat16;

constexpr int kUnits = 24;                  // hidden units a CTA owns, of one layer
constexpr int kN = 4 * kUnits;              // its gate columns: the products' N (96)
constexpr int kRows = 64;                   // batch rows of a row group: one wgmma M tile
constexpr int kBox = kN * 64 * 2;           // a 96-column x 64-K bf16 box of W (12 KiB)
constexpr int kABox = kRows * 64 * 2;       // a row group's 64 x 64-K bf16 share of an A box
constexpr int kSmemLimit = 232448;          // the H100's per-block opt-in
constexpr int kWStages = 2;                 // ring stages of streamed W boxes
constexpr int kAStages = 4;                 // ring stages of A boxes
constexpr int kMaxGroups = 2;

long long g_launches = 0;

struct Args {
  const float* xp0;         // (T, B, 4H) f32: layer 0's x·W_x0 + b0
  const float* bias;        // (L - 1, 4H) f32: layers 1 .. L-1
  const float* mask;        // (T, 1, B) f32 {0, 1}
  float* h;                 // (L, B, H) f32: h0 on entry, hn on return
  float* c;                 // (L, B, H) f32: c0 on entry, cn on return
  float* out;               // (T, B, H) f32: the top layer's masked output
  bf16* ring_h;             // (L, R, 64·groups, H) bf16 h by step (slot t % R; slot R - 1 = h0)
  unsigned* counter;        // (L) CTA-steps each layer has published, zero on entry
  int T, B, H, L, slices, ring;
  int resident;             // W_h's K chunks 0 .. resident - 1 kept in shared memory
  int skip_waits;           // a planted fault (chip_smoke.py): no counter waits
  // (T, 5) SM clocks of the first CTA of the top layer (chip_smoke.py's
  // persistent_study), or null, taken by its first consumer thread: step
  // t begun, x product done, the first h box landed, h product done, cell
  // stored and published.
  long long* stamps;
};

__host__ __device__ constexpr size_t smem_bytes(int resident, int groups) {
  return (size_t)(resident + kWStages) * kBox + (size_t)kAStages * groups * kABox +
         8 * (1 + 2 * (kWStages + kAStages)) + 1024;
}

// W_h's K chunks kept resident at width H: all H/64, or as many as fit
// beside the rings.
constexpr int resident_chunks(int H, int groups) {
  return H / 64 < (int)((kSmemLimit - smem_bytes(0, groups)) / kBox)
             ? H / 64
             : (int)((kSmemLimit - smem_bytes(0, groups)) / kBox);
}

__device__ __forceinline__ uint32_t pack_bf2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float sigmoidf_(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ __forceinline__ void stamp(long long* stamps, int t, int k) {
  if (stamps != nullptr) stamps[5 * t + k] = clock64();
}

template <int kGroups>
__global__ void __launch_bounds__(128 * kGroups + 32, 1)
    wavefront_eval(const __grid_constant__ CUtensorMap map_wh,
                   const __grid_constant__ CUtensorMap map_wx,
                   const __grid_constant__ CUtensorMap map_rh, Args p) {
  using namespace tma;
  constexpr int kConsumers = 128 * kGroups;
  constexpr int kAStage = kGroups * kABox;             // one A box: 64·kGroups rows
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int H = p.H, KS = H / 64, R = p.ring, RC = p.resident;
  constexpr int SW = kWStages, SA = kAStages;
  uint8_t* w_s = smem;                                   // RC boxes: the resident W_h chunks
  uint8_t* wring = smem + (size_t)RC * kBox;             // SW streamed W boxes
  uint8_t* aring = wring + (size_t)SW * kBox;            // SA A boxes
  uint64_t* wbar = reinterpret_cast<uint64_t*>(aring + (size_t)SA * kAStage);
  uint64_t* wbars = wbar + 1;                            // W ring: SW full, SW empty
  uint64_t* abars = wbars + 2 * SW;                      // A ring: SA full, SA empty
  const int l = blockIdx.x / p.slices, u = blockIdx.x % p.slices;
  const int wrow = blockIdx.x * kN;                      // this CTA's rows of the arranged W_h
  const int xrow_w = (blockIdx.x - p.slices) * kN;       // and of the arranged W_x (l >= 1)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const unsigned n_ctas = (unsigned)p.slices;
  const int B = p.B, T = p.T, L = p.L;
  const int arows = kRows * kGroups;                     // rows of a ring slot and an A box

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

  if (warp == 4 * kGroups) {                             // the producer warp
    if (lane == 0) {
      const uint32_t wb = smem_addr(wbar);
      bar_expect_tx(wb, RC * kBox);
      for (int k = 0; k < RC; ++k) {
        load_box(smem_addr(w_s + (size_t)k * kBox), &map_wh, wb, 64 * k, wrow);
      }
      auto load_w = [&](const CUtensorMap* map, int row, int k) {
        const uint32_t s = wr.put();
        load_box(wr.base + s * kBox, map, wr.full + 8 * s, 64 * k, row);
      };
      auto load_a = [&](int row, int k) {
        const uint32_t s = ar.put();
        load_box(ar.base + s * kAStage, &map_rh, ar.full + 8 * s, 64 * k, row);
      };
      auto acquire = [&](const unsigned* count, unsigned target) {
        RST_CHECK(count - p.counter, L);
        if (!p.skip_waits) grid_wait(count, target);
        asm volatile("fence.proxy.async.global;" ::: "memory");   // the rings are read by TMA
      };
      for (int t = 0; t < T; ++t) {
        // The x product (layers above 0): the lower layer's ring slot, W_x.
        if (l > 0) {
          acquire(p.counter + l - 1, (unsigned)(t + 1) * n_ctas);
          const int xrow = ((l - 1) * R + t % R) * arows;
          RST_CHECK(xrow, (long long)L * R * arows);
          for (int k = 0; k < KS; ++k) {
            load_a(xrow, k);
            load_w(&map_wx, xrow_w, k);
          }
        }
        // The h product: h_l(t-1) once every CTA of layer l has published it.
        if (t > 0) acquire(p.counter + l, (unsigned)t * n_ctas);
        const int hrow = (l * R + (t - 1 + R) % R) * arows;
        RST_CHECK(hrow, (long long)L * R * arows);
        for (int k = 0; k < KS; ++k) {
          load_a(hrow, k);
          if (k >= RC) load_w(&map_wh, wrow, k);
        }
      }
    }
    return;
  }

  // The consumer warpgroups: warpgroup wg runs rows 64·wg .. 64·wg + 63.
  const int G = 4 * H;
  const int wg = warp / 4;
  const int q = lane % 4, r0 = kRows * wg + 16 * (warp % 4) + lane / 4;
  const int j0 = u * kUnits;
  const size_t plane = (size_t)arows * H;
  const bool feeds = l + 1 < L;                          // the layer above reads this ring
  const bool top = l + 1 == L;
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
        if (ok) RST_CHECK(i, (long long)L * B * H);
        c_r[hh][jj][e] = ok ? p.c[i] : 0.0f;
        h_r[hh][jj][e] = ok ? p.h[i] : 0.0f;
      }
  }

  bar_wait(smem_addr(wbar), 0);                          // the W_h chunks resident
  const uint32_t w_base = smem_addr(w_s);
  const uint32_t a_off = wg * kABox;                     // this warpgroup's half of an A stage
  bf16* own = p.ring_h + (size_t)l * R * plane;
  const float* bias = l > 0 ? p.bias + (size_t)(l - 1) * G : nullptr;
  float d[48];
  // One 64-wide K chunk: A from the A ring, W resident or from the W ring.
  auto chunk = [&](int c, bool streamed_w, uint32_t w_addr) {
    const uint32_t a = ar.get() + a_off;
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
    // This step's masks, and layer 0's xp0 (two adjacent columns a load):
    // in flight while the products run.
    float mk[2];
    float2 xv[2][3][4];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int b = r0 + 8 * hh;
      if (b < B) RST_CHECK((size_t)t * B + b, (long long)T * B);
      if (l == 0 && b < B) {
        RST_CHECK(((size_t)t * B + b) * G + 3 * H + j0 + 2 * q + 1, (long long)T * B * G);
      }
      mk[hh] = b < B ? p.mask[(size_t)t * B + b] : 0.0f;
#pragma unroll
      for (int jj = 0; jj < 3; ++jj)
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          xv[hh][jj][g] = (l == 0 && b < B && unit_ok(jj))
                              ? *reinterpret_cast<const float2*>(
                                    p.xp0 + ((size_t)t * B + b) * G + g * H + j0 + 8 * jj + 2 * q)
                              : make_float2(0.0f, 0.0f);
        }
    }
    if (stamps) stamp(stamps, t, 0);
    if (l > 0) {
      for (int c = 0; c < KS; ++c) chunk(c, true, 0);
    }
    if (stamps) stamp(stamps, t, 1);
    for (int k = 0; k < KS; ++k) {
      chunk(l > 0 ? KS + k : k, k >= RC, w_base + (uint32_t)(k * kBox));
      if (stamps && k == 0) stamp(stamps, t, 2);
    }
    if (stamps) stamp(stamps, t, 3);

    // Slot t % R last held step t - R: the layer above must be done with it.
    if (feeds && t >= R) {
      if (!p.skip_waits && threadIdx.x == 0) {
        RST_CHECK(l + 1, L);
        grid_wait(p.counter + l + 1, (unsigned)(t - R + 1) * n_ctas);
      }
      asm volatile("bar.sync 1, %0;" ::"r"(kConsumers) : "memory");
    }
    bf16* hslot = own + (size_t)(t % R) * plane;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int b = r0 + 8 * hh;
      const float m = mk[hh];
#pragma unroll
      for (int jj = 0; jj < 3; ++jj) {
        const int j = j0 + 8 * jj + 2 * q;               // units j, j + 1
        const bool ok = b < B && unit_ok(jj);
        float o_v[2], h_v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float pre[4];
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            // Gate g of unit group jj is column group 3g + jj.
            const float add = l == 0 ? (e ? xv[hh][jj][g].y : xv[hh][jj][g].x)
                                     : (ok ? bias[g * H + j + e] : 0.0f);
            pre[g] = d[4 * (3 * g + jj) + 2 * hh + e] + add;
          }
          const float i_a = sigmoidf_(pre[0]), g_a = tanhf(pre[1]);
          const float f_a = sigmoidf_(pre[2] + 1.0f), o_a = sigmoidf_(pre[3]);
          const float c_old = c_r[hh][jj][e], h_old = h_r[hh][jj][e];
          const float c_new = f_a * c_old + i_a * g_a;
          const float h_new = o_a * tanhf(c_new);
          const float h_sel = m * h_new + (1.0f - m) * h_old;
          c_r[hh][jj][e] = m * c_new + (1.0f - m) * c_old;
          h_r[hh][jj][e] = h_sel;
          o_v[e] = m * h_new;
          h_v[e] = h_sel;
        }
        if (ok) {
          RST_CHECK((size_t)(hslot - p.ring_h) + (size_t)b * H + j + 1, (long long)L * R * plane);
          if (top) RST_CHECK(((size_t)t * B + b) * H + j + 1, (long long)T * B * H);
          *reinterpret_cast<uint32_t*>(hslot + (size_t)b * H + j) = pack_bf2(h_v[0], h_v[1]);
          if (top) {
            *reinterpret_cast<float2*>(p.out + ((size_t)t * B + b) * H + j) =
                make_float2(o_v[0], o_v[1]);
          }
        }
      }
    }
    // Publish step t: the ring stores are read by TMA (the async proxy) in
    // other CTAs: fence them, meet, and release once for the CTA.
    asm volatile("fence.proxy.async.global;" ::: "memory");
    asm volatile("bar.sync 1, %0;" ::"r"(kConsumers) : "memory");
    if (threadIdx.x == 0) {
      RST_CHECK(l, L);
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
        RST_CHECK(i, (long long)L * B * H);
        p.c[i] = c_r[hh][jj][e];
        p.h[i] = h_r[hh][jj][e];
      }
  }
}

// Tensor map of a row-major (rows, cols) bf16 array in boxes of 64 K
// columns by `box_rows` rows, 128-byte swizzle; reads past `rows` fill zeros.
bool make_box_map(CUtensorMap* map, const void* base, long long rows, int cols, int box_rows) {
  const tma::EncodeTiled encode = tma::encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int kGroups>
int launch(const CUtensorMap& map_wh, const CUtensorMap& map_wx, const CUtensorMap& map_rh,
           Args& p, cudaStream_t st) {
  const size_t smem = smem_bytes(p.resident, kGroups);
  const int threads = 128 * kGroups + 32;
  auto kernel = wavefront_eval<kGroups>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = p.L * p.slices;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem)) !=
          cudaSuccess) {
    return (int)err;
  }
  if (per_sm * sms < grid) return (int)cudaErrorCooperativeLaunchTooLarge;
  if ((err = cudaMemsetAsync(p.counter, 0, p.L * sizeof(unsigned), st)) != cudaSuccess) {
    return (int)err;
  }
  CUtensorMap mh = map_wh, mx = map_wx, mr = map_rh;
  void* args[] = {&mh, &mx, &mr, &p};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), grid, threads, args,
                                    smem, st);
  if (err == cudaSuccess) ++g_launches;
  return (int)err;
}

}  // namespace

// xp0 (T, B, 4H) f32: layer 0's x·W_x0 + b0; wh (L·slices·96, H) and wx
// ((L - 1)·slices·96, H) bf16: each layer's W_h,l and layers 1..L-1's W_x,l,
// the columns CTA by CTA as [i(24) | g(24) | f(24) | o(24)] (zero rows past
// H) as rows, K contiguous (the wrapper's `wavefront_weights`); bias
// (L - 1, 4H) f32 of layers 1..L-1; mask (T, 1, B) f32; h, c (L, B, H) f32
// holding h0, c0 on entry and hn, cn on return; out (T, B, H) f32; ring_h
// (L, ring, 64·groups, H) bf16, zero, with slot ring - 1 holding bf16(h0);
// counter L uint32 of device memory.  The plan: slices = ceil(H / 24) CTAs
// a layer, groups = ceil(B / 64) row groups (1 or 2), W_h's first
// resident_chunks(H, groups) K chunks resident; H a multiple of 64, ring
// >= 2.  skip_waits != 0 plants a fault (no counter waits).  stamps, (T, 5)
// int64 or null, takes the SM clock of the top layer's first CTA at five
// points of each step (Args::stamps).  Returns the CUDA error code (0 =
// success); cudaErrorCooperativeLaunchTooLarge when the grid cannot be
// co-resident.
extern "C" int rst_lstm_wavefront_eval_persistent(
    const float* xp0, const void* wx, const void* wh, const float* bias, const float* mask,
    float* h, float* c, float* out, void* ring_h, void* counter, int T, int B, int H, int L,
    int slices, int groups, int ring, int skip_waits, long long* stamps, void* stream) {
  if (H % 64 != 0 || B < 1 || groups < 1 || groups > kMaxGroups || B > groups * kRows ||
      L < 2 || T < 1 || ring < 2 || slices != (H + kUnits - 1) / kUnits) {
    return (int)cudaErrorInvalidValue;
  }
  const long long rows = (long long)L * slices * kN;
  CUtensorMap map_wh, map_wx, map_rh;
  if (!make_box_map(&map_wh, wh, rows, H, kN) ||
      !make_box_map(&map_wx, wx, rows - (long long)slices * kN, H, kN) ||
      !make_box_map(&map_rh, ring_h, (long long)L * ring * kRows * groups, H, kRows * groups)) {
    return (int)cudaErrorInvalidValue;
  }
  Args p;
  p.xp0 = xp0;
  p.bias = bias;
  p.mask = mask;
  p.h = h;
  p.c = c;
  p.out = out;
  p.ring_h = static_cast<bf16*>(ring_h);
  p.counter = static_cast<unsigned*>(counter);
  p.T = T;
  p.B = B;
  p.H = H;
  p.L = L;
  p.slices = slices;
  p.ring = ring;
  p.resident = resident_chunks(H, groups);
  p.skip_waits = skip_waits;
  p.stamps = stamps;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return groups == 1 ? launch<1>(map_wh, map_wx, map_rh, p, st)
                     : launch<2>(map_wh, map_wx, map_rh, p, st);
}

// Launches of the persistent kernel so far (counted at the launch site).
extern "C" long long rst_wavefront_eval_launches() { return g_launches; }
