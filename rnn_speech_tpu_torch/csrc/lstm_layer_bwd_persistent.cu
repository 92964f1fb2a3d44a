// The gates-mode layer backward as one persistent Hopper kernel (sm_90a):
// W_h stays in shared memory for all T steps, one launch a call instead of
// one a step, the carry's product on wgmma.
//
// Replaces `_recurrence_bwd_kernel` (entry `_lstm_recurrence_bwd`) of
// rnn_speech_tpu/ops/lstm_pallas.py: per step t = T-1 .. 0, from the
// forward's bf16 activated gates and carried c,
//
//   dh = m·(dout + dh_carry);  do = dh·tanh(c)·o(1-o)
//   dc = dh·o·(1 - tanh²c) + m·dc_carry
//   di = dc·g·i(1-i);  dg = dc·i(1-g²);  df = dc·c_prev·f(1-f)
//   dh_carry' = (1-m)·dh_carry + bf16(dgates)·W_hᵀ;  dc_carry' = (1-m)·dc_carry + dc·f
//
// with the bf16 dgates written over the gates residual, and dh0, dc0 at
// the end.  As in csrc/lstm_layer_bwd.cu (which keeps the per-step form for
// the shapes the wrapper's plan, `bwd_plan` in ops/lstm_layer_train.py,
// does not send here), the CONSUMING step forms the carry's product: step t
// adds dgates(t+1)·W_h[J, :]ᵀ for its own units J, and a last pass adds
// dgates(0)·W_hᵀ to give dh0.
//
// What bounds it on the H100: 2·T·B·H·4H operations, 0.54 µs a step at the
// bf16 tensor rate at B=64, H=1024; the T steps are a serial chain.  The
// per-step kernel took 32.6 µs a step: a launch a step, 64 blocks on 132
// SMs, each re-reading its 128 KiB W_h slice and the whole (64, 4096) bf16
// dgates tile (512 KiB) from L2 every step (~40 MiB a step), and a serial
// chain of 256 WMMA 16x16x16 products a warp.
//
// The A stream sets the step (PR 9's lesson from csrc/lstm_layer_lean.cu),
// and for the backward it is 4x wider than for the forward: K = 4H.  The
// budget, per CTA and step, at B=64, H=1024, for a K split of eight:
//
//   resident W_h slice   64 units x 512 K            64 KiB
//   A = dgates(t+1)      64 rows x 512 K             64 KiB, all 8 boxes in
//                                                    flight at once
//   its partial product  64 rows x 64 units f32      16 KiB, out through L2
//   total shared memory                              129 KiB of 227 KiB
//
// and 128 CTAs x 64 KiB = 8 MiB of A a step from L2 (the per-step kernel
// read 32 MiB of dgates alone, in ~1 MiB-deep dependent chunks).
//
// What this design does about it:
// * K split in eighths.  A slice of 64 hidden units J is eight CTAs: CTA
//   (u, q) holds W_h[J_u, 512q .. 512q + 512) (W_h's own rows, K
//   contiguous: no permuted copy), loaded once by TMA as a K-major wgmma
//   operand in 128-byte swizzle, and streams only dgates(t+1)[:, K_q], half
//   a gate.  It runs wgmma m64n64k16 over its 512 K into a (64, 64) f32
//   partial.  The split trades the A stream against the partials'
//   exchange: split by gate (four CTAs of 32 units, 128 KiB of A, 8 KiB
//   partials) the stream took 56% of the step; split in sixteenths (128
//   units, 32 KiB of A, 32 KiB partials) the exchange grew more than the
//   stream shrank (both measured slower than eighths; PERF.md).
// * The partials meet through L2, not distributed shared memory: the H100
//   co-schedules at most 15 clusters of eight CTAs of this size (30 of
//   four, 66 of two; cudaOccupancyMaxActiveClusters, read by
//   persistent_study), fewer than the 16 slices at H=1024, so a grid of
//   clusters of a slice cannot be co-resident.  Each CTA stores its partial
//   (L2 only), adds 1 to its slice's counter (release), waits until the
//   eight have arrived (acquire) and sums the eight partials of its cells
//   in the order of q: a fixed order, no atomics in the arithmetic, so a
//   run repeats bit for bit.
// * Each CTA then runs the cell backward for 8 of the slice's 64 units
//   (units 64u + 8q .. 64u + 8q + 7) over its 64 rows: a thread owns a row
//   and 4 units, keeps their dh and dc carries in f32 registers for all T
//   steps, and loads the cell's inputs (dout, the four gates, c, c_prev,
//   the mask), which do not depend on the chain, before it waits for the
//   step's product.
// * The dgates exchange needs no buffer of its own: step t writes bf16
//   dgates over gates[t], and step t-1's TMA reads them there (rows past B
//   in a 64-row box read the next step's dgates or TMA's zero fill; they
//   only reach product rows that are never stored).  Writers fence their
//   stores to the async proxy (fence.proxy.async.global), the consumers
//   meet, and one thread adds 1 to its row group's step counter (release);
//   the producer warp polls it (acquire), fences, and only then loads.
// * One cooperative launch of (row groups) x (H/64 slices) x 8 CTAs, one
//   an SM: 128 at B=64, H=1024.  Co-resident or refused (the wrapper
//   raises); a barrier that never fills traps instead of hanging.
//
// What bounds this design (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py's
// persistent_study, CTA 0's SM clock at four points of each pass): a step
// is a chain of two exchanges through L2, each a release-add and an
// acquire poll (the step's dgates, then the slice's partials), around the
// A stream and 32 dependent wgmmas; PERF.md gives each segment's share.

#include "grad_matmul.cuh"

namespace {

namespace tma = rst_grad::tma;
using bf16 = __nv_bfloat16;

constexpr int kSplit = 8;                    // CTAs of a slice: the K split
constexpr int kCellUnits = 8;                // units whose cells a CTA runs
constexpr int kUnits = kSplit * kCellUnits;  // hidden units of a slice: the product's N (64)
constexpr int kRows = 64;                    // rows of a row group: one wgmma M tile
constexpr int kThreads = 128 + 32;           // a consumer warpgroup and a producer warp
constexpr int kBox = 64 * 64 * 2;            // a 64x64 bf16 box of W_h or dgates (8 KiB)
constexpr int kPart = kRows * kUnits;        // floats of one partial product
constexpr int kSmemLimit = 232448;           // the H100's per-block opt-in

long long g_launches = 0;

struct Args {
  const float* dout;    // (T, B, H) f32
  bf16* gates;          // (T, B, 4H) activated gates in, dgates out
  const bf16* cseq;     // (T, B, H) carried c
  const float* c0;      // (B, H) initial c as the residual stores it
  const float* mask;    // (T, 1, B) f32 {0, 1}
  float* dhc;           // (B, H) dhn on entry, dh0 on return
  float* dcc;           // (B, H) dcn on entry, dc0 on return
  float* part;          // (groups, slices, kSplit, 64, kUnits) f32 partial products
  unsigned* counter;    // groups step counters, then groups x slices slice counters
  int T, B, H, groups;
  int skip_barrier;     // a planted fault (chip_smoke.py): read dgates without waiting
  // (T + 1, 4) SM clocks of CTA 0 (the step's breakdown, chip_smoke.py's
  // persistent_study), or null: pass s's step barrier passed (producer),
  // product done, the slice's partials all arrived, cell stored and
  // arrived (consumer 0).
  long long* stamps;
};

__device__ __forceinline__ void stamp(long long* stamps, int s, int k) {
  if (stamps != nullptr && blockIdx.x == 0) stamps[4 * s + k] = clock64();
}

// K boxes (64 columns) of a CTA's share of the 4H: H/128.
__host__ __device__ constexpr int k_boxes(int H) { return 4 * H / (64 * kSplit); }

__host__ __device__ constexpr size_t smem_bytes(int H) {
  return (size_t)k_boxes(H) * 2 * kBox + 8 * (2 + k_boxes(H)) + 1024;
}

__device__ __forceinline__ float sig_grad(float a) { return a * (1.0f - a); }

// Four bf16 values (8 bytes) as floats, and back.
__device__ __forceinline__ void unpack4(uint2 v, float (&f)[4]) {
  f[0] = __uint_as_float(v.x << 16);
  f[1] = __uint_as_float(v.x & 0xFFFF0000u);
  f[2] = __uint_as_float(v.y << 16);
  f[3] = __uint_as_float(v.y & 0xFFFF0000u);
}

__device__ __forceinline__ uint2 pack4(const float (&f)[4]) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(f[0], f[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(f[2], f[3]);
  return make_uint2(*reinterpret_cast<uint32_t*>(&lo), *reinterpret_cast<uint32_t*>(&hi));
}

__global__ void __launch_bounds__(kThreads, 1)
    bwd_persistent(const __grid_constant__ CUtensorMap map_w,
                   const __grid_constant__ CUtensorMap map_g, Args p) {
  using namespace tma;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int H = p.H, B = p.B, T = p.T;
  const int KS = k_boxes(H);                     // K boxes of the CTA's share
  const int kq = 64 * KS;                        // its K columns: 4H / kSplit
  uint8_t* w_s = smem;                           // KS boxes: the W_h slice
  uint8_t* a_s = smem + (size_t)KS * kBox;       // KS boxes: its share of dgates(t+1)
  uint64_t* wbar = reinterpret_cast<uint64_t*>(a_s + (size_t)KS * kBox);
  uint64_t* afree = wbar + 1;                    // the consumers are done with A
  uint64_t* full = wbar + 2;                     // box k of A has landed
  const int slices = H / kUnits;
  const int q = blockIdx.x % kSplit;             // the CTA's share of K
  const int slice = blockIdx.x / kSplit % slices;
  const int group = blockIdx.x / (kSplit * slices);
  const int row0 = group * kRows;
  unsigned* step_count = p.counter + group;
  unsigned* slice_count = p.counter + p.groups + group * slices + slice;
  const unsigned ctas = kSplit * slices;         // CTAs of a row group
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    bar_init(smem_addr(wbar), 1);
    bar_init(smem_addr(afree), 4);               // each consumer warp releases
    for (int k = 0; k < KS; ++k) bar_init(smem_addr(&full[k]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {                               // the producer warp
    if (lane == 0) {
      const uint32_t wb = smem_addr(wbar);
      bar_expect_tx(wb, KS * kBox);
      for (int k = 0; k < KS; ++k) {
        load_box(smem_addr(w_s + (size_t)k * kBox), &map_w, wb, q * kq + 64 * k,
                 slice * kUnits);
      }
      // Pass s (1 .. T) forms the product of dgates(T - s), written by pass s - 1.
      for (int s = 1; s <= T; ++s) {
        bar_wait(smem_addr(afree), ((s - 1) & 1) ^ 1);   // the first pass passes
        if (!p.skip_barrier) grid_wait(step_count, (unsigned)s * ctas);
        stamp(p.stamps, s, 0);
        asm volatile("fence.proxy.async.global;" ::: "memory");
        const int row = (T - s) * B + row0;
        for (int k = 0; k < KS; ++k) {
          const uint32_t fb = smem_addr(&full[k]);
          bar_expect_tx(fb, kBox);
          load_box(smem_addr(a_s + (size_t)k * kBox), &map_g, fb, q * kq + 64 * k, row);
        }
      }
    }
    return;
  }

  // Consumers: thread i runs the cells of row row0 + i/2, units j .. j + 3.
  const int tid = threadIdx.x;
  const int r_loc = tid / 2;
  const int b = row0 + r_loc;
  const bool ok = b < B;
  const int ju = kCellUnits * q + 4 * (tid % 2);        // unit offset in the slice
  const int j = slice * kUnits + ju;
  const size_t G = 4 * (size_t)H;
  float dh[4], dc[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    dh[e] = ok ? p.dhc[(size_t)b * H + j + e] : 0.0f;
    dc[e] = ok ? p.dcc[(size_t)b * H + j + e] : 0.0f;
  }
  float* my_part = p.part + (((size_t)group * slices + slice) * kSplit + q) * kPart;
  const float* slice_part =
      p.part + ((size_t)group * slices + slice) * kSplit * kPart + r_loc * kUnits + ju;
  const uint32_t w_base = smem_addr(w_s), a_base = smem_addr(a_s);

  for (int s = 0; s <= T; ++s) {
    const int t = T - 1 - s;
    // The cell's inputs of step t: they do not wait for the chain.
    uint2 gw[4] = {}, cw = {}, pw = {};
    float4 dw = {}, c0w = {};
    float m = 0.0f;
    if (s < T && ok) {
      const size_t e = (size_t)b * H + j, th = (size_t)t * B * H;
      const bf16* grow = p.gates + ((size_t)t * B + b) * G + j;
#pragma unroll
      for (int g = 0; g < 4; ++g) gw[g] = *reinterpret_cast<const uint2*>(grow + (size_t)g * H);
      cw = *reinterpret_cast<const uint2*>(p.cseq + th + e);
      if (t > 0) {
        pw = *reinterpret_cast<const uint2*>(p.cseq + th - (size_t)B * H + e);
      } else {
        c0w = *reinterpret_cast<const float4*>(p.c0 + e);
      }
      dw = *reinterpret_cast<const float4*>(p.dout + th + e);
      m = p.mask[(size_t)t * B + b];
    }

    // The carry's product: dgates(t+1)[:, K_q]·W_h[J, K_q]ᵀ, then the
    // slice's kSplit partials summed in the order of q.
    float ph[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (s > 0) {
      if (s == 1) bar_wait(smem_addr(wbar), 0);  // W_h resident
      float d[32];
      fence_acc(d);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
      for (int k = 0; k < KS; ++k) {
        bar_wait(smem_addr(&full[k]), (s - 1) & 1);
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
      if (tid == 0) stamp(p.stamps, s, 1);
      if (lane == 0) bar_arrive(smem_addr(afree));
#pragma unroll
      for (int jg = 0; jg < kUnits / 8; ++jg)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = 16 * warp + lane / 4 + 8 * hh, col = 8 * jg + 2 * (lane % 4);
          __stcg(reinterpret_cast<float2*>(my_part + row * kUnits + col),
                 make_float2(d[4 * jg + 2 * hh], d[4 * jg + 2 * hh + 1]));
        }
      asm volatile("bar.sync 1, 128;" ::: "memory");
      if (tid == 0) {
        __threadfence();
        atomicAdd(slice_count, 1u);
        grid_wait(slice_count, (unsigned)s * kSplit);
      }
      asm volatile("bar.sync 1, 128;" ::: "memory");
      if (tid == 0) stamp(p.stamps, s, 2);
#pragma unroll
      for (int g = 0; g < kSplit; ++g) {
        const float4 v = __ldcg(reinterpret_cast<const float4*>(slice_part + g * kPart));
        ph[0] += v.x;
        ph[1] += v.y;
        ph[2] += v.z;
        ph[3] += v.w;
      }
    }

    if (s == T) {                                // the last pass: dh0, dc0
      if (ok) {
        const size_t e = (size_t)b * H + j;
        *reinterpret_cast<float4*>(p.dhc + e) =
            make_float4(dh[0] + ph[0], dh[1] + ph[1], dh[2] + ph[2], dh[3] + ph[3]);
        *reinterpret_cast<float4*>(p.dcc + e) = make_float4(dc[0], dc[1], dc[2], dc[3]);
      }
      break;
    }

    if (ok) {
      float i_a[4], g_a[4], f_a[4], o_a[4], c_t[4], c_p[4], di[4], dg[4], df[4], dq[4];
      unpack4(gw[0], i_a);
      unpack4(gw[1], g_a);
      unpack4(gw[2], f_a);
      unpack4(gw[3], o_a);
      unpack4(cw, c_t);
      if (t > 0) {
        unpack4(pw, c_p);
      } else {
        c_p[0] = c0w.x;
        c_p[1] = c0w.y;
        c_p[2] = c0w.z;
        c_p[3] = c0w.w;
      }
      const float dout[4] = {dw.x, dw.y, dw.z, dw.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float dh_carry = dh[e] + ph[e];
        const float tanh_c = tanhf(c_t[e]);
        const float dh_new = m * (dout[e] + dh_carry);
        const float do_pre = dh_new * tanh_c * sig_grad(o_a[e]);
        const float dc_new = dh_new * o_a[e] * (1.0f - tanh_c * tanh_c) + m * dc[e];
        di[e] = dc_new * g_a[e] * sig_grad(i_a[e]);
        dg[e] = dc_new * i_a[e] * (1.0f - g_a[e] * g_a[e]);
        df[e] = dc_new * c_p[e] * sig_grad(f_a[e]);
        dq[e] = do_pre;
        dh[e] = (1.0f - m) * dh_carry;
        dc[e] = (1.0f - m) * dc[e] + dc_new * f_a[e];
      }
      bf16* grow = p.gates + ((size_t)t * B + b) * G + j;
      *reinterpret_cast<uint2*>(grow) = pack4(di);
      *reinterpret_cast<uint2*>(grow + H) = pack4(dg);
      *reinterpret_cast<uint2*>(grow + 2 * (size_t)H) = pack4(df);
      *reinterpret_cast<uint2*>(grow + 3 * (size_t)H) = pack4(dq);
    }
    // dgates(t) are read by TMA (the async proxy) in every CTA of the row
    // group: fence them, meet, and arrive once for the CTA.
    asm volatile("fence.proxy.async.global;" ::: "memory");
    asm volatile("bar.sync 1, 128;" ::: "memory");
    if (tid == 0) {
      __threadfence();
      atomicAdd(step_count, 1u);
      stamp(p.stamps, s, 3);
    }
  }
}

}  // namespace

// dout (T, B, H) f32; gates (T, B, 4H) bf16: activated gates, overwritten
// with dgates; cseq (T, B, H) bf16; c0 (B, H) f32, the initial c rounded as
// the residual stores it; mask (T, 1, B) f32 {0, 1}; w_h (H, 4H) bf16;
// dhc, dcc (B, H) f32 holding dhn, dcn on entry and dh0, dc0 on return;
// part (groups, H/64, 8, 64, 64) f32 scratch; counter groups·(1 + H/64)
// uint32 of device memory.  The plan (`bwd_plan`): `groups` row groups of
// 64 rows (B <= 64·groups), H a multiple of 128; every operand 16-byte
// aligned.  skip_barrier != 0 plants a fault (no wait for the other CTAs'
// dgates).  stamps, (T + 1, 4) int64 or null, takes CTA 0's SM clock at
// four points of each pass (Args::stamps).  Returns the CUDA error code (0 = success);
// cudaErrorCooperativeLaunchTooLarge when the grid cannot be co-resident.
extern "C" int rst_lstm_layer_bwd_persistent(const float* dout, void* gates, const void* cseq,
                                             const float* c0, const float* mask,
                                             const void* w_h, float* dhc, float* dcc,
                                             float* part, void* counter, int T, int B, int H,
                                             int groups, int skip_barrier, long long* stamps,
                                             void* stream) {
  if (H % 128 != 0 || groups < 1 || T < 1 || B < 1 || B > groups * kRows) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = smem_bytes(H);
  if (smem > (size_t)kSmemLimit) return (int)cudaErrorInvalidValue;
  CUtensorMap map_w, map_g;
  if (!tma::make_map(&map_w, w_h, H, 4 * H) || !tma::make_map(&map_g, gates, T * B, 4 * H)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(bwd_persistent,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int slices = H / kUnits;
  const int grid = groups * slices * kSplit;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bwd_persistent, kThreads,
                                                           smem)) != cudaSuccess) {
    return (int)err;
  }
  if (per_sm * sms < grid) return (int)cudaErrorCooperativeLaunchTooLarge;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((err = cudaMemsetAsync(counter, 0, (size_t)groups * (1 + slices) * sizeof(unsigned),
                             st)) != cudaSuccess) {
    return (int)err;
  }
  Args p;
  p.dout = dout;
  p.gates = static_cast<bf16*>(gates);
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
  p.stamps = stamps;
  void* args[] = {&map_w, &map_g, &p};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(bwd_persistent), grid,
                                    kThreads, args, smem, st);
  if (err == cudaSuccess) ++g_launches;
  return (int)err;
}

// Launches of the persistent kernel so far (counted at the launch site).
extern "C" long long rst_layer_bwd_persistent_launches() { return g_launches; }

// How many clusters of `cluster` CTAs of this kernel's size (threads and
// shared memory at H) the card co-schedules (cudaOccupancyMaxActiveClusters),
// or -1 on an error: the reading behind the K split's exchange through L2.
extern "C" int rst_layer_bwd_max_clusters(int cluster, int H) {
  const size_t smem = smem_bytes(H);
  if (cudaFuncSetAttribute(bwd_persistent, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess) {
    return -1;
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(cluster * (H / kUnits));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = -1;
  return cudaOccupancyMaxActiveClusters(&n, bwd_persistent, &cfg) == cudaSuccess ? n : -1;
}
