// The recompute-mode layer forward as one persistent Hopper kernel
// (sm_90a): W_h stays in shared memory for all T steps, one grid-wide
// barrier a step instead of one launch a step, the product on wgmma.
//
// Replaces `_recurrence_train_lean_kernel` (entry
// `_lstm_recurrence_train_lean`) of rnn_speech_tpu/ops/lstm_pallas.py:
// per step t
//
//   gates = x_proj[t] (bf16) + bf16(h)·W_h         (f32 sums)
//   i, g, f, o = σ(i), tanh(g), σ(f + 1), σ(o)
//   c' = f·c + i·g;  h' = o·tanh(c');  c, h <- m·(c', h') + (1 - m)·(c, h)
//   out[t] = m·h' (f32);  c_seq[t] = bf16(c)
//
// and returns (out, hn, cn, c_seq).  csrc/lstm_layer_train.cu keeps the
// per-step form (one launch a step on the shared cell, lstm_cell.cuh) for
// the shapes the wrapper's plan (`lean_plan`, ops/lstm_layer_train.py)
// does not send here.
//
// What bounds it on the H100: 2·T·B·H·4H operations, 3.4 µs a step at the
// bf16 tensor rate (989 TFLOP/s) at B=400, H=1024, against x_proj read once
// (3.3 MB a step).  The per-step kernel took ~43 µs a step: a launch per
// step, W_h and h re-read from L2 by 448 blocks every step (~112 MiB),
// legacy mma.sync products and the f32 carries through device memory.
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
//
// What bounds this design (PERF.md; NVIDIA H100 80GB HBM3, 700.00 W):
// ~22 µs a step at B=400; at B=64 (12.1 µs a step) and with the step
// barrier left out (4% less; both in chip_smoke.py's opt-in lean_study
// phase) it stays far from its bound.  Every step each CTA streams 512 KiB of h
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
// the halved boxes cost more than the L2 reads saved.  Not done here
// (ROADMAP Queue B): the per-step kernel's other users (the gates-mode
// forward, the inference recurrence).

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

long long g_launches = 0;                       // launches of lean_persistent

struct Args {
  const bf16* x_proj;   // (T, B, 4H) bf16
  const float* mask;    // (T, 1, B) f32 {0, 1}
  float* h;             // (B, H) f32: h0 on entry, hn on return
  float* c;             // (B, H) f32: c0 on entry, cn on return
  float* out;           // (T, B, H) f32
  bf16* cseq;           // (T, B, H) bf16
  bf16* hb;             // (2, Bpa, H) bf16: hb[0] = bf16(h0), padding rows zero
  unsigned* counter;    // (groups) step barrier arrivals of each row group, zero on entry
  int T, B, H, Bpa, tiles, stages;
  int skip_barrier;     // a planted fault (chip_smoke.py): read h without waiting
};

__host__ __device__ constexpr size_t smem_bytes(int H, int tiles, int stages) {
  return (size_t)(H / 64) * kBox + (size_t)stages * tiles * kBox + 8 * (1 + 2 * stages) + 1024;
}

__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define RST_ACC8(i)                                                              \
  "+f"(d[(i)]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3]), "+f"(d[(i) + 4]), \
      "+f"(d[(i) + 5]), "+f"(d[(i) + 6]), "+f"(d[(i) + 7])

// d (64x64 f32) = a·b + (keep ? d : 0) over 16 K: a (64 x 16) and b
// (16 x 64) both K-major.  Register 4j + r holds row 16·warp + lane/4 +
// 8·(r/2), column 8j + 2·(lane%4) + r%2.
__device__ __forceinline__ void mma_64x64x16(float (&d)[32], uint64_t a, uint64_t b,
                                             uint32_t keep) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : RST_ACC8(0), RST_ACC8(8), RST_ACC8(16), RST_ACC8(24)
      : "l"(a), "l"(b), "r"(keep));
}

#undef RST_ACC8

// Until `count` reaches `target` (acquire); traps after ~2^24 polls (a grid
// that is not co-resident, or a barrier that never fills) instead of hanging.
__device__ __forceinline__ void grid_wait(const unsigned* count, unsigned target) {
  for (uint32_t spins = 0;; ++spins) {
    unsigned v;
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(count) : "memory");
    if (v >= target) break;
    if (spins == (1u << 24)) __trap();
    __nanosleep(32);
  }
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

__global__ void __launch_bounds__(kThreads, 1)
    lean_persistent(const __grid_constant__ CUtensorMap map_w,
                    const __grid_constant__ CUtensorMap map_h, Args p) {
  using namespace tma;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int KS = p.H / 64;                       // K stages of a step
  const int S = p.stages;
  const int stage_bytes = p.tiles * kBox;
  uint8_t* w_s = smem;                           // KS boxes: the W_h slice
  uint8_t* ring = smem + (size_t)KS * kBox;      // S stages of `tiles` h boxes
  uint64_t* wbar = reinterpret_cast<uint64_t*>(ring + (size_t)S * stage_bytes);
  uint64_t* full = wbar + 1;
  uint64_t* empty = full + S;
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
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * kConsumers) {                  // the producer warp
    if (lane == 0) {
      const uint32_t wb = smem_addr(wbar);
      bar_expect_tx(wb, KS * kBox);
      for (int k = 0; k < KS; ++k) {
        load_box(smem_addr(w_s + (size_t)k * kBox), &map_w, wb, k * 64, slice * 64);
      }
      int it = 0;
      for (int t = 0; t < p.T; ++t) {
        if (t > 0 && !p.skip_barrier) grid_wait(p.counter + group, (unsigned)t * slices);
        asm volatile("fence.proxy.async.global;" ::: "memory");
        const int hrow = (t & 1) * p.Bpa + row0;
        for (int k = 0; k < KS; ++k, ++it) {
          const int s = it % S;
          bar_wait(smem_addr(&empty[s]), ((it / S) & 1) ^ 1);   // first round passes
          const uint32_t fb = smem_addr(&full[s]);
          bar_expect_tx(fb, stage_bytes);
          const uint32_t dst = smem_addr(ring + (size_t)s * stage_bytes);
          for (int m = 0; m < p.tiles; ++m) {
            load_box(dst + m * kBox, &map_h, fb, k * 64, hrow + 64 * m);
          }
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
    // in flight while the product runs.
    uint32_t xr[2][2][4][2];
    float mk[2][2];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int b = row_of(m, hh);
        const bool ok = m < nt && b < B;
        mk[m][hh] = ok ? p.mask[(size_t)t * B + b] : 0.0f;
        const bf16* xrow = p.x_proj + ((size_t)t * B + b) * G + j0 + ucol;
#pragma unroll
        for (int g = 0; g < 4; ++g)
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            xr[m][hh][g][jj] =
                ok ? __ldg(reinterpret_cast<const unsigned int*>(xrow + (size_t)g * H + 8 * jj))
                   : 0u;
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

    // The cell, in registers; gate g of unit group jj is column group 2g + jj.
    bf16* hnext = p.hb + (size_t)((t + 1) & 1) * p.Bpa * H;
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      if (m >= nt) continue;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int b = row_of(m, hh);
        const float mm = mk[m][hh];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          float o_v[2], c_v[2], h_v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float pre[4];
#pragma unroll
            for (int g = 0; g < 4; ++g) {
              const uint32_t x = xr[m][hh][g][jj];
              pre[g] = d[m][4 * (2 * g + jj) + 2 * hh + e] + (e ? bf_hi(x) : bf_lo(x));
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
          }
          if (b < B) {
            const size_t i = (size_t)b * H + j0 + 8 * jj + ucol;
            const size_t ti = (size_t)t * B * H + i;
            *reinterpret_cast<float2*>(p.out + ti) = make_float2(o_v[0], o_v[1]);
            *reinterpret_cast<uint32_t*>(p.cseq + ti) = pack_bf2(c_v[0], c_v[1]);
            *reinterpret_cast<uint32_t*>(hnext + i) = pack_bf2(h_v[0], h_v[1]);
          }
        }
      }
    }
    // h of step t + 1 is read by TMA (the async proxy) in every CTA of the
    // row group: fence it, meet, and arrive once for the CTA.
    asm volatile("fence.proxy.async.global;" ::: "memory");
    asm volatile("bar.sync 1, %0;" ::"n"(128 * kConsumers) : "memory");
    if (threadIdx.x == 0) {
      __threadfence();
      atomicAdd(p.counter + group, 1u);
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
          p.c[i] = c_r[m][hh][jj][e];
          p.h[i] = h_r[m][hh][jj][e];
        }
    }
}

}  // namespace

// x_proj (T, B, 4H) bf16; w_perm (4H, H) bf16 = the columns of W_h in the
// kernel's order, transposed (`lean_weights`); mask (T, 1, B) f32; hb
// (2, Bpa, H) bf16 with hb[0, :B] = bf16(h0), the rest zero; h, c (B, H)
// f32 holding h0, c0 on entry and hn, cn on return; out (T, B, H) f32;
// cseq (T, B, H) bf16; counter `groups` uint32 of device memory.  The plan
// (`lean_plan`): `groups` row groups of `tiles` 64-row tiles (Bpa =
// groups·tiles·64 >= B), `stages` ring stages; H a multiple of 64.
// skip_barrier != 0 plants a fault (no wait for the other CTAs' h).
// Returns the CUDA error code (0 = success); cudaErrorCooperativeLaunchTooLarge
// when the grid cannot be co-resident.
extern "C" int rst_lstm_layer_train_lean_persistent(
    const void* x_proj, const void* w_perm, const float* mask, void* hb, float* h, float* c,
    float* out, void* cseq, void* counter, int T, int B, int H, int groups, int tiles,
    int stages, int skip_barrier, void* stream) {
  if (H % 64 != 0 || tiles < 1 || tiles > kMaxTiles || stages < 2 || groups < 1 ||
      T < 1 || B < 1 || B > groups * tiles * 64) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = smem_bytes(H, tiles, stages);
  if (smem > (size_t)kSmemLimit) return (int)cudaErrorInvalidValue;
  const int Bpa = groups * tiles * 64;
  CUtensorMap map_w, map_h;
  if (!tma::make_map(&map_w, w_perm, 4 * H, H) || !tma::make_map(&map_h, hb, 2 * Bpa, H)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      lean_persistent, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = groups * (H / kUnits);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, lean_persistent, kThreads,
                                                           smem)) != cudaSuccess) {
    return (int)err;
  }
  if (per_sm * sms < grid) return (int)cudaErrorCooperativeLaunchTooLarge;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((err = cudaMemsetAsync(counter, 0, groups * sizeof(unsigned), st)) != cudaSuccess) {
    return (int)err;
  }
  Args p;
  p.x_proj = static_cast<const bf16*>(x_proj);
  p.mask = mask;
  p.h = h;
  p.c = c;
  p.out = out;
  p.cseq = static_cast<bf16*>(cseq);
  p.hb = static_cast<bf16*>(hb);
  p.counter = static_cast<unsigned*>(counter);
  p.T = T;
  p.B = B;
  p.H = H;
  p.Bpa = Bpa;
  p.tiles = tiles;
  p.stages = stages;
  p.skip_barrier = skip_barrier;
  void* args[] = {&map_w, &map_h, &p};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(lean_persistent), grid,
                                    kThreads, args, smem, st);
  if (err == cudaSuccess) ++g_launches;
  return (int)err;
}

// Launches of the persistent kernel so far (counted at the launch site).
extern "C" long long rst_lean_persistent_launches() { return g_launches; }

// Dynamic shared memory of the kernel at (H, tiles, stages), in bytes.
extern "C" long long rst_lean_persistent_smem(int H, int tiles, int stages) {
  return (long long)smem_bytes(H, tiles, stages);
}
