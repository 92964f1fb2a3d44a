// The float32 layer backward as one persistent Hopper kernel (sm_90a), in
// both residual modes, and the float32 layer sweep's cotangent product.
//
// Replaces, in the float32 compute mode (the JAX kernels' default
// compute_dtype with float32 residuals), two TPU kernels:
//
// * `_recurrence_bwd_recompute_kernel` (rnn_speech_tpu/ops/lstm_pallas.py,
//   row 8 of PERF.md): per rebuild chunk the float32 rebuild product
//   (rebuild_gates.cuh ``launch_f32``, the GEMM tile of f32_gemm.cuh),
//   then one persistent launch of the chunk's steps (recompute mode);
// * `_wavefront_bwd_kernel` (rnn_speech_tpu/ops/lstm_wavefront.py, row 4),
//   drop modes 0-2, unfused: as a layer sweep (ops/lstm_wavefront.py
//   ``_layer_sweep_launch``) that computes the same function.  From the
//   top layer down, one launch of this kernel in gates mode runs the
//   layer's whole reverse walk over T, reading the float32 activated gates
//   and writing dgates over them; then ``rst_sweep_dout_f32`` forms the
//   layer below's cotangent (dgates·W_x,l+1ᵀ)·keep·scale on the GEMM tile
//   and, in drop modes 1 and 2, writes the xdrop stream outs·keep·scale
//   in its epilogue, with the keep bits the reverse diagonal draws.
//
// Per step t = T-1 .. 0 (as csrc/lstm_layer_bwd_persistent.cu, in float32):
//
//   dh = m·(dout + dh_carry);  do = dh·tanh(c)·o(1-o)
//   dc = dh·o·(1 - tanh²c) + m·dc_carry
//   di = dc·g·i(1-i);  dg = dc·i(1-g²);  df = dc·c_prev·f(1-f)
//   dh_carry' = (1-m)·dh_carry + dgates·W_hᵀ;  dc_carry' = (1-m)·dc_carry + dc·f
//
// What bounds it on the H100: without tensor cores the carry's product,
// 2·B·4H·H operations a step, at the float32 rate: 8.0 µs a step at B=64,
// H=1024 (67 TFLOP/s), and the rebuild twice that off the chain.  The
// per-step design before it (csrc/lstm_layer_bwd.cu) took 87 µs a step: a
// launch a step, 64 blocks on 132 SMs, W_h (16 MiB in float32) re-read
// from L2 every step, 8 sums a thread.
//
// What this design does about it:
// * One cooperative launch a rebuild chunk (recompute mode) or a layer
//   (gates mode), counters instead of a launch a step.  The grid is the
//   bf16 persistent backward's: (H/64 slices) x 8 CTAs, the carry
//   product's K = 4H split in eighths; CTA (u, q) keeps W_h[64u .. 64u+64,
//   q·H/2 .. (q+1)·H/2) resident in shared memory for the whole launch (128
//   KiB in float32 at H=1024, rows padded by four floats).
// * dgates(t+1) of a 64-row group stream through a four-stage cp.async
//   ring in 64x64 boxes (16 KiB), zero-filled past the batch; a CTA walks
//   the row groups of every step in turn, and past one group it issues the
//   next group's first boxes before the current group's exchange.
// * The product is a register-tiled SIMT FMA product: 256 threads in two K
//   halves of 128, each thread 8 rows x 4 units over its half of each box
//   (8 float4 loads of A, broadcast, and 4 of W, conflict-free, for 128
//   FMAs); the second half's sums meet the first's through shared memory.
// * The eight CTAs of a slice meet their (64, 64) partials through L2 in a
//   fixed order (a slot each, a per-slice counter, summed in the order of
//   q): no atomics in the arithmetic, a run repeats bit for bit.  Each CTA
//   then runs the cells of 8 of the slice's 64 units over the group's 64
//   rows (a thread a row and 2 units), writes float32 dgates into the
//   stream and adds 1 to the group's step counter, which the next step's
//   loads wait for.
// * Recompute mode: counters zeroed before every launch on the stream; a
//   launch's first step reads dgates(t1) that the previous launch wrote;
//   carries cross launches in dhc and dcc; the launch ending at t = 0 adds
//   the dh0 pass.
// Planted faults (``skip_barrier``): bit 1 loads dgates without the step
// wait, bit 2 sums the partials without the slice wait, bit 4 leaves the
// slice's last partial out of the sum (a wrong partial: the checks' fault,
// since the barriers' races show only now and then); the GEMM tile's
// ``skip_k`` leaves out its last K stages.

#include "bounds_check.cuh"
#include "f32_gemm.cuh"
#include "philox.cuh"
#include "rebuild_gates.cuh"

namespace {

namespace tma = rst_grad::tma;

constexpr int kSplit = 8;                     // CTAs of a slice: the K split
constexpr int kUnits = 64;                    // hidden units of a slice
constexpr int kCellUnits = kUnits / kSplit;   // units whose cells a CTA runs
constexpr int kRows = 64;                     // rows of a row group
constexpr int kThreads = 256;                 // two K halves of 128
constexpr int kKC = 64;                       // K columns of a streamed box
constexpr int kLdA = kKC + 4;                 // a box's padded row
constexpr int kStages = 4;                    // the box ring
constexpr int kPart = kRows * kUnits;         // floats of one partial
constexpr int kSmemLimit = 232448;

long long g_launches = 0;             // gates-mode launches (the layer sweep)
long long g_recompute_launches = 0;   // recompute-mode launches (one a chunk)
long long g_rebuild_launches = 0;     // rebuild products of the recompute entry
long long g_dout_launches = 0;        // the sweep's cotangent products

// K columns of a CTA's share of the 4H, and its resident W rows' stride.
__host__ __device__ constexpr int k_share(int H) { return 4 * H / kSplit; }
__host__ __device__ constexpr int w_ld(int H) { return k_share(H) + 4; }

// The resident W_h slice, the box ring and the second K half's sums.
__host__ __device__ constexpr size_t smem_bytes(int H) {
  return ((size_t)kUnits * w_ld(H) + (size_t)kStages * kRows * kLdA + (size_t)kRows * kUnits) *
         sizeof(float);
}

struct Args {
  const float* dout;   // (T, B, H)
  const float* act;    // recompute mode: (chunk·B, 4H) activated gates of steps t_lo ..
  float* dg;           // (T, B, 4H) dgates out (gates mode: the activated gates in)
  const float* cseq;   // (T, B, H) carried c
  const float* c0;     // (B, H) initial c as the residual stores it
  const float* mask;   // (T, 1, B) f32 {0, 1}
  const float* w_h;    // (H, 4H)
  float* dhc;          // (B, H) dh carry: dhn on the first launch's entry, dh0 at the end
  float* dcc;          // (B, H) dc carry
  float* part;         // (groups, slices, kSplit, 64, 64) partial products
  unsigned* counter;   // groups step counters, then groups x slices slice counters
  int T, B, H, groups;
  int t_lo, t_hi;      // this launch's steps [t_lo, t_hi), walked last first
  int act_rows;        // rows of act (recompute mode), for the bounds checks
  int skip_barrier;    // planted faults: 1 no step wait, 2 no slice wait, 4 a partial left out
};

template <bool kAct>
__global__ void __launch_bounds__(kThreads, 1) bwd_f32_persistent(Args p) {
  extern __shared__ __align__(16) float smem[];
  const int H = p.H, B = p.B, T = p.T, groups = p.groups;
  const int G = 4 * H;
  const int KQ = k_share(H), LW = w_ld(H), NC = KQ / kKC;
  float* w_s = smem;                                    // [kUnits][LW]
  float* a_s = smem + (size_t)kUnits * LW;              // kStages x [kRows][kLdA]
  float* red = a_s + (size_t)kStages * kRows * kLdA;    // [kRows][kUnits]
  const int slices = H / kUnits;
  const int q = blockIdx.x % kSplit, slice = blockIdx.x / kSplit;
  const unsigned ctas = kSplit * slices;
  const int steps = p.t_hi - p.t_lo;
  const bool first = p.t_hi == T;          // the launch's pass 0 has no product
  const int passes = steps + (p.t_lo == 0);
  const int s0 = first ? 1 : 0;            // the first pass with a product
  const int tid = threadIdx.x;
  RST_CHECK(blockIdx.x, ctas);

  for (int v = tid; v < kUnits * (KQ / 4); v += kThreads) {
    const int u = v / (KQ / 4), c4 = v % (KQ / 4);
    const size_t src = (size_t)(slice * kUnits + u) * G + (size_t)q * KQ + 4 * c4;
    RST_CHECK(src + 3, (long long)H * G);
    rst::cp_async16(w_s + u * LW + 4 * c4, p.w_h + src);
  }
  rst::cp_async_commit();

  // The product: K half kh, rows ty + 8i, units tx + 16jj.  The cells:
  // row r_c of the group, slice units ju, ju + 1.
  const int kh = tid / 128, tx = tid % 16, ty = tid % 128 / 16;
  const int r_c = tid / 4, ju = kCellUnits * q + 2 * (tid % 4), j = slice * kUnits + ju;

  // Box c of pass s's dgates(t_hi - s), rows of group g, into `stage`.
  auto load = [&](int s, int g, int c, int stage) {
    const size_t t1 = (size_t)(p.t_hi - s);
    float* as = a_s + (size_t)stage * kRows * kLdA;
    for (int v = tid; v < kRows * (kKC / 4); v += kThreads) {
      const int r = v / (kKC / 4), c4 = v % (kKC / 4);
      const int b = g * kRows + r;
      const bool ok = b < B;
      const size_t src = (t1 * B + (ok ? b : 0)) * G + (size_t)q * KQ + c * kKC + 4 * c4;
      if (ok) RST_CHECK(src + 3, (long long)T * B * G);
      rst_f32::cp_async16_zfill(as + r * kLdA + 4 * c4, p.dg + src, ok);
    }
  };
  // The first kStages - 1 boxes of pair (s, g), its boxes numbered from
  // `base` in the ring, after group g's dgates(t_hi - s) are all written.
  auto prologue = [&](int s, int g, int base) {
    if (tid == 0 && s > 0 && !(p.skip_barrier & 1)) {
      RST_CHECK(g, groups);
      tma::grid_wait(p.counter + g, (unsigned)s * ctas);
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < kStages - 1; ++c) {
      if (c < NC) load(s, g, c, (base + c) % kStages);
      rst::cp_async_commit();
    }
  };

  int pair = 0;          // product pairs (pass, group) done: their boxes are pair·NC ..
  bool ahead = false;    // the current pair's prologue was issued ahead
  for (int s = 0; s < passes; ++s) {
    const int t = p.t_hi - 1 - s;          // -1 in the dh0 pass
    const bool last = s == steps;          // the dh0 pass
    const bool product = s >= s0;
    const int pi = s - s0;
    for (int g = 0; g < groups; ++g) {
      const int b = g * kRows + r_c;
      const bool ok = b < B;
      const size_t e = (size_t)b * H + j;
      // The cell's inputs and carries: they do not wait for the chain.
      float2 dh2 = {0.0f, 0.0f}, dc2 = {0.0f, 0.0f}, dw = {0.0f, 0.0f};
      float2 cw = {0.0f, 0.0f}, pw = {0.0f, 0.0f};
      float2 gw[4] = {};
      float m = 0.0f;
      if (ok) {
        RST_CHECK(e + 1, (long long)B * H);
        dh2 = *reinterpret_cast<const float2*>(p.dhc + e);
        dc2 = *reinterpret_cast<const float2*>(p.dcc + e);
        if (!last) {
          const size_t th = (size_t)t * B * H;
          RST_CHECK(th + e + 1, (long long)T * B * H);
          const float* ga;
          if (kAct) {
            const size_t arow = (size_t)(t - p.t_lo) * B + b;
            RST_CHECK(arow, p.act_rows);
            ga = p.act + arow * G + j;
          } else {
            ga = p.dg + ((size_t)t * B + b) * G + j;
          }
#pragma unroll
          for (int g4 = 0; g4 < 4; ++g4) gw[g4] = *reinterpret_cast<const float2*>(ga + g4 * H);
          cw = *reinterpret_cast<const float2*>(p.cseq + th + e);
          pw = t > 0 ? *reinterpret_cast<const float2*>(p.cseq + th - (size_t)B * H + e)
                     : *reinterpret_cast<const float2*>(p.c0 + e);
          dw = *reinterpret_cast<const float2*>(p.dout + th + e);
          RST_CHECK((size_t)t * B + b, (long long)T * B);
          m = p.mask[(size_t)t * B + b];
        }
      }

      float ph0 = 0.0f, ph1 = 0.0f;
      if (product) {
        const int base = pair * NC;
        if (!ahead) prologue(s, g, base);
        ahead = false;
        float acc[8][4];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) acc[i][jj] = 0.0f;
        for (int c = 0; c < NC; ++c) {
          rst::cp_async_wait<kStages - 2>();   // box c (and W_h) has landed
          __syncthreads();                     // every thread is done with box c - 1
          if (c + kStages - 1 < NC) load(s, g, c + kStages - 1, (base + c + kStages - 1) % kStages);
          rst::cp_async_commit();
          const float* as = a_s + (size_t)((base + c) % kStages) * kRows * kLdA;
          const float* ws = w_s + c * kKC;
#pragma unroll
          for (int kk = 0; kk < 8; ++kk) {
            const int k = 32 * kh + 4 * kk;
            float4 a[8], w[4];
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              a[i] = *reinterpret_cast<const float4*>(as + (ty + 8 * i) * kLdA + k);
            }
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              w[jj] = *reinterpret_cast<const float4*>(ws + (tx + 16 * jj) * LW + k);
            }
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
              for (int jj = 0; jj < 4; ++jj) {
                float v = acc[i][jj];
                v = fmaf(a[i].x, w[jj].x, v);
                v = fmaf(a[i].y, w[jj].y, v);
                v = fmaf(a[i].z, w[jj].z, v);
                acc[i][jj] = fmaf(a[i].w, w[jj].w, v);
              }
          }
        }
        ++pair;
        // Past one row group, the next pair's first boxes go out ahead of
        // this pair's exchange: they wait only for cells every CTA ran
        // before this pair.
        if (groups > 1 && (g + 1 < groups || s + 1 < passes)) {
          prologue(g + 1 < groups ? s : s + 1, (g + 1) % groups, pair * NC);
          ahead = true;
        }
        if (kh == 1) {
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) red[(ty + 8 * i) * kUnits + tx + 16 * jj] = acc[i][jj];
        }
        __syncthreads();
        const size_t slot = ((size_t)g * slices + slice) * kSplit;
        RST_CHECK((slot + kSplit) * kPart - 1, (long long)groups * slices * kSplit * kPart);
        if (kh == 0) {
          float* my = p.part + (slot + q) * kPart;
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              const int o = (ty + 8 * i) * kUnits + tx + 16 * jj;
              __stcg(my + o, acc[i][jj] + red[o]);
            }
        }
        __syncthreads();
        if (tid == 0) {
          RST_CHECK(groups + g * slices + slice, (long long)groups * (1 + slices));
          unsigned* slice_count = p.counter + groups + g * slices + slice;
          __threadfence();
          atomicAdd(slice_count, 1u);
          if (!(p.skip_barrier & 2)) tma::grid_wait(slice_count, (unsigned)(pi + 1) * kSplit);
        }
        __syncthreads();
        const float* sp = p.part + slot * kPart + r_c * kUnits + ju;
        const int parts = (p.skip_barrier & 4) ? kSplit - 1 : kSplit;
        for (int g8 = 0; g8 < parts; ++g8) {
          const float2 v = __ldcg(reinterpret_cast<const float2*>(sp + g8 * kPart));
          ph0 += v.x;
          ph1 += v.y;
        }
      }

      if (last) {                          // dh0; dc0 stays in dcc
        if (ok) *reinterpret_cast<float2*>(p.dhc + e) = make_float2(dh2.x + ph0, dh2.y + ph1);
        continue;
      }
      if (ok) {
        const float ia[2] = {gw[0].x, gw[0].y}, ga[2] = {gw[1].x, gw[1].y};
        const float fa[2] = {gw[2].x, gw[2].y}, oa[2] = {gw[3].x, gw[3].y};
        const float ct[2] = {cw.x, cw.y}, cp[2] = {pw.x, pw.y};
        const float dout[2] = {dw.x, dw.y}, dh[2] = {dh2.x + ph0, dh2.y + ph1};
        const float dc[2] = {dc2.x, dc2.y};
        float di[2], dgg[2], df[2], dq[2], dh_out[2], dc_out[2];
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const float tanh_c = tanhf(ct[k]);
          const float dh_new = m * (dout[k] + dh[k]);
          dq[k] = dh_new * tanh_c * oa[k] * (1.0f - oa[k]);
          const float dc_new = dh_new * oa[k] * (1.0f - tanh_c * tanh_c) + m * dc[k];
          di[k] = dc_new * ga[k] * ia[k] * (1.0f - ia[k]);
          dgg[k] = dc_new * ia[k] * (1.0f - ga[k] * ga[k]);
          df[k] = dc_new * cp[k] * fa[k] * (1.0f - fa[k]);
          dh_out[k] = (1.0f - m) * dh[k];
          dc_out[k] = (1.0f - m) * dc[k] + dc_new * fa[k];
        }
        const size_t grow = ((size_t)t * B + b) * G + j;
        RST_CHECK(grow + 3 * (size_t)H + 1, (long long)T * B * G);
        float* d = p.dg + grow;
        *reinterpret_cast<float2*>(d) = make_float2(di[0], di[1]);
        *reinterpret_cast<float2*>(d + H) = make_float2(dgg[0], dgg[1]);
        *reinterpret_cast<float2*>(d + 2 * (size_t)H) = make_float2(df[0], df[1]);
        *reinterpret_cast<float2*>(d + 3 * (size_t)H) = make_float2(dq[0], dq[1]);
        *reinterpret_cast<float2*>(p.dhc + e) = make_float2(dh_out[0], dh_out[1]);
        *reinterpret_cast<float2*>(p.dcc + e) = make_float2(dc_out[0], dc_out[1]);
      }
      __syncthreads();                     // the group's dgates(t) are all written
      if (tid == 0) {
        RST_CHECK(g, groups);
        __threadfence();
        atomicAdd(p.counter + g, 1u);
      }
    }
  }
}

// The launch geometry, attributes set and co-residency checked once a call.
struct Launcher {
  const void* fn;
  int grid, groups, slices;
  size_t smem;
};

template <bool kAct>
int prepare(Launcher* l, int H, int groups) {
  const void* fn = reinterpret_cast<const void*>(bwd_f32_persistent<kAct>);
  l->fn = fn;
  l->slices = H / kUnits;
  l->grid = l->slices * kSplit;
  l->groups = groups;
  l->smem = smem_bytes(H);
  if (l->smem > (size_t)kSmemLimit) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)l->smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, l->smem)) !=
          cudaSuccess) {
    return (int)err;
  }
  if (per_sm * sms < l->grid) return (int)cudaErrorCooperativeLaunchTooLarge;
  return 0;
}

// The counters zeroed, then one cooperative launch, both on `st`.
int launch_one(const Launcher& l, const Args& p, cudaStream_t st) {
  cudaError_t err = cudaMemsetAsync(
      p.counter, 0, (size_t)l.groups * (1 + l.slices) * sizeof(unsigned), st);
  if (err != cudaSuccess) return (int)err;
  Args a = p;
  void* args[] = {&a};
  return (int)cudaLaunchCooperativeKernel(l.fn, l.grid, kThreads, args, l.smem, st);
}

bool valid(int T, int B, int H, int groups) {
  return H % 128 == 0 && groups >= 1 && T >= 1 && B >= 1 && B <= groups * kRows &&
         B > (groups - 1) * kRows;
}

Args common(const float* dout, float* dg, const float* cseq, const float* c0, const float* mask,
            const float* w_h, float* dhc, float* dcc, float* part, void* counter, int T, int B,
            int H, int groups, int skip_barrier) {
  Args p = {};
  p.dout = dout;
  p.dg = dg;
  p.cseq = cseq;
  p.c0 = c0;
  p.mask = mask;
  p.w_h = w_h;
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

// The sweep's epilogue: dout = acc·keep·scale of boundary l at (t, b, col)
// and, with xdrop set, xdrop = outs·keep·scale (keep 1 and scale 1 in drop
// mode 0).
struct DoutEpi {
  float* dout;           // (rows, H)
  const float* outs;     // (rows, H) boundary l's masked outputs, or null
  float* xdrop;          // (rows, H), or null
  const __nv_bfloat16* masks;   // (rows, H) {0, 1} (drop mode 1), or null
  int rows, B, H, drop_mode, l;
  unsigned seed0, seed1, thr;
  float scale;
  __device__ __forceinline__ void operator()(int row, int col, float v) const {
    const size_t e = (size_t)row * H + col;
    RST_CHECK(e, (long long)rows * H);
    float ks = 1.0f;
    if (drop_mode == 1) {
      ks = __bfloat162float(masks[e]) * scale;
    } else if (drop_mode == 2) {
      ks = rst::wavefront_keep(seed0, seed1, thr, l, row / B, row % B, col) ? scale : 0.0f;
    }
    dout[e] = v * ks;
    if (xdrop != nullptr) xdrop[e] = outs[e] * ks;
  }
};

}  // namespace

// Gates mode (the float32 layer sweep's chain): dout (T, B, H); gates
// (T, B, 4H): activated gates, overwritten with dgates; cseq (T, B, H);
// c0 (B, H), the initial c; mask (T, 1, B) {0, 1}; w_h (H, 4H); dhc, dcc
// (B, H) holding dhn, dcn on entry and dh0, dc0 on return; part (groups,
// H/64, 8, 64, 64) scratch; counter groups·(1 + H/64) uint32.  All
// float32, 16-byte aligned; H a multiple of 128; groups = ceil(B/64).
// skip_barrier plants faults (bit 1 no step wait, bit 2 no slice wait, bit 4
// the slice's last partial left out of the sum).
// Returns the CUDA error code (0 = success).
extern "C" int rst_lstm_layer_bwd_f32_persistent(const float* dout, float* gates,
                                                 const float* cseq, const float* c0,
                                                 const float* mask, const float* w_h,
                                                 float* dhc, float* dcc, float* part,
                                                 void* counter, int T, int B, int H, int groups,
                                                 int skip_barrier, void* stream) {
  if (!valid(T, B, H, groups)) return (int)cudaErrorInvalidValue;
  Launcher l;
  int err = prepare<false>(&l, H, groups);
  if (err != 0) return err;
  Args p = common(dout, gates, cseq, c0, mask, w_h, dhc, dcc, part, counter, T, B, H, groups,
                  skip_barrier);
  p.t_lo = 0;
  p.t_hi = T;
  err = launch_one(l, p, static_cast<cudaStream_t>(stream));
  if (err == 0) ++g_launches;
  return err;
}

// Recompute mode: as above with dgates (T, B, 4H) written fresh and the
// gates rebuilt from x (T, B, D) and h_prev (T, B, H), w_x (D, 4H) and
// bias (4H), all float32: for the n_chunks chunks that `starts` gives
// (t0[0] > t0[1] > ... > t0[n - 1] = 0; chunk k spans [t0[k], t0[k - 1]),
// chunk 0 ends at T; each at most `chunk` steps), in that order, the
// rebuild product of the chunk into act (chunk·B, 4H) scratch, then one
// persistent launch of its steps (the last chunk's with the dh0 pass).  D
// a multiple of 16.
extern "C" int rst_lstm_layer_bwd_recompute_f32_persistent(
    const float* dout, float* dgates, const float* cseq, const float* c0, const float* mask,
    const float* w_h, const float* x, const float* h_prev, const float* w_x, const float* bias,
    float* dhc, float* dcc, float* act, float* part, void* counter, const int* starts,
    int n_chunks, int chunk, int T, int B, int H, int D, int groups, int skip_barrier,
    void* stream) {
  if (!valid(T, B, H, groups) || n_chunks <= 0 || chunk <= 0 || D % 16) {
    return (int)cudaErrorInvalidValue;
  }
  for (int k = 0, t1 = T; k < n_chunks; t1 = starts[k++]) {
    const int t0 = starts[k];
    if (t0 < 0 || t0 >= t1 || t1 - t0 > chunk || (k == n_chunks - 1) != (t0 == 0)) {
      return (int)cudaErrorInvalidValue;
    }
  }
  Launcher l;
  int err = prepare<true>(&l, H, groups);
  if (err != 0) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Args p = common(dout, dgates, cseq, c0, mask, w_h, dhc, dcc, part, counter, T, B, H, groups,
                  skip_barrier);
  p.act_rows = chunk * B;
  for (int k = 0, t1 = T; k < n_chunks; t1 = starts[k++]) {
    const int t0 = starts[k];
    p.act = act;
    if ((err = rst_rebuild::launch_f32(x, h_prev, w_x, w_h, t0 * B, (t1 - t0) * B, D, H, bias,
                                       act, st, (long long)T * B)) != 0) {
      return err;
    }
    ++g_rebuild_launches;
    p.t_lo = t0;
    p.t_hi = t1;
    if ((err = launch_one(l, p, st)) != 0) return err;
    ++g_recompute_launches;
  }
  return 0;
}

// The float32 layer sweep's cotangent of layer l (below the layer whose
// dgates (rows, 4H) are given): dout (rows, H) = (dgates · w_xᵀ)·keep·scale
// with w_x (H, 4H), the layer above's input weights; in drop modes 1
// (masks (rows, H) bf16 {0, 1}, boundary l's) and 2 (the Philox bits of
// (seed0, seed1) under thr at boundary l) also xdrop (rows, H) = outs ·
// keep·scale; rows = T·B, row t·B + b.  skip_k planted fault (K stages
// left out).  Returns the CUDA error code.
extern "C" int rst_sweep_dout_f32(const float* dgates, const float* w_x, const float* outs,
                                  const void* masks, float* xdrop, float* dout, int rows, int B,
                                  int H, int drop_mode, unsigned seed0, unsigned seed1,
                                  unsigned thr, float scale, int l, int skip_k, void* stream) {
  if (rows < 0 || B <= 0 || H % 16 || drop_mode < 0 || drop_mode > 2 ||
      (drop_mode != 0) != (xdrop != nullptr && outs != nullptr) ||
      (drop_mode == 1) != (masks != nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  rst_f32::Operands op = {};
  op.a1 = dgates;
  op.b1 = w_x;
  op.M = rows;
  op.N = H;
  op.K1 = 4 * H;
  op.K2 = 0;
  op.a_rows = rows;
  op.skip_k = skip_k;
  DoutEpi epi{dout, outs, xdrop, static_cast<const __nv_bfloat16*>(masks), rows, B, H,
              drop_mode, l, seed0, seed1, thr, drop_mode ? scale : 1.0f};
  const int err = rst_f32::launch<true>(op, epi, static_cast<cudaStream_t>(stream));
  if (err == 0) ++g_dout_launches;
  return err;
}

// Launches so far, counted at the launch sites: gates mode, recompute mode
// (one a chunk), the recompute entry's rebuild products, the sweep's
// cotangent products.
extern "C" long long rst_layer_bwd_f32_launches() { return g_launches; }
extern "C" long long rst_recompute_f32_launches() { return g_recompute_launches; }
extern "C" long long rst_recompute_f32_rebuild_launches() { return g_rebuild_launches; }
extern "C" long long rst_sweep_dout_launches() { return g_dout_launches; }
