// The float32 training forward of one LSTM layer for Hopper (sm_90a): its
// input product on the float32 GEMM tile, then its recurrence as one
// persistent cooperative launch.  The float32 layer sweep of the training
// forward runs it layer by layer.
//
// Replaces, in the float32 compute mode (the JAX kernels' default
// compute_dtype with float32 residuals), the TPU kernel
// `_wavefront_train_kernel` (rnn_speech_tpu/ops/lstm_wavefront.py, row 3 of
// PERF.md), drop modes 0-2, as a layer sweep (ops/lstm_wavefront.py
// ``_fwd_layer_sweep_launch``) that computes the same function on another
// schedule.  From the bottom layer up, entry rst_lstm_layer_fwd_f32 runs,
// for layer l:
//
// 1. the input product xp = X_l·W_x,l + b_l for all T·B rows at once on the
//    float32 GEMM tile (f32_gemm.cuh), written straight into layer l's slot
//    of the float32 gates residual (T, B, 4H), which the residual needs
//    anyway: X_0 = x, and X_l (l >= 1) is the layer below's carried h times
//    boundary l-1's keep·scale;
// 2. the recurrence, per step t: the pre-activations xp(t) + h(t-1)·W_h,
//    the cell with the length mask (lstm_cell.cuh's float32 operations),
//    the activated gates written over xp(t), the carried c and the masked
//    output stored, h and c carried; and below the top layer the next
//    layer's input X_{l+1}(t) = h(t)·keep·scale of boundary l.
//
// The dropped copy X_{l+1} is formed in the chain's epilogue, into one
// (T, B, H) scratch used again for every layer (layer l+1's product reads
// it before layer l+1's chain writes it), and not in the GEMM's A stage:
// the tile's A stage is a cp.async copy straight into shared memory, which
// cannot scale on the way; the cell holds h(t) in a register already; and
// its keep bits (the mask, or one Philox call for a thread's two units,
// csrc/philox.cuh, the bits the per-diagonal kernel and the reverse
// diagonal draw for (boundary, t, b, unit)) are read before the step's
// product, off the chain's wait.
//
// What bounds it on the H100 (no tensor cores in float32): each of a
// layer's two products does 2·T·B·4H·H operations (K = D for layer 0's
// input product) at 67 TFLOP/s.  The chain's, 2·B·4H·H a step, is 8.0 µs a
// step at B=64, H=1024, on the serial path; both products over L=3 layers
// of T=3510 steps are 168.75 ms.  The per-diagonal design before it
// (csrc/lstm_wavefront_train.cu's float32 instance) took 510 ms: a launch
// a diagonal, W_h and W_x re-read from L2 every diagonal in K chunks of 32,
// and the input product on the serial path.
//
// What the chain's design does about it (the machinery of
// csrc/lstm_layer_bwd_f32.cu):
// * One cooperative launch a layer; step counters (one a 64-row group)
//   instead of a launch a step; the batch's ceil(B/64) row groups walked
//   in turn every step.
// * The split.  About 128 CTAs share a step's product, B rows x 4H columns
//   x K = H.  Split s ways in K, each CTA owns 4H·s/128 columns over a K
//   share of H/s rows: it reads the group's h(t-1) for its share
//   (B·H/s floats) and, for s > 1, writes its (B, 4H·s/128) partial and
//   reads the s partials of its cells' columns.  L2 bytes a step at B=64,
//   H=1024, 128 CTAs: h, 128·64·(1024/s)·4 = 32 MiB/s; partials,
//   2·s·64·4096·4 = 2 MiB·s.  s = 1: 32 MiB; 2: 20; 4: 16; 8: 20; 16: 36.
//   So s = 4 (kSplit): CTA (u, q) owns the four gates' columns of a 32-unit
//   slice (128 columns) over K rows [q·H/4, (q+1)·H/4), and keeps that
//   (H/4, 128) block of W_h resident in shared memory in float32 for the
//   whole launch (130 KiB at H=1024, rows padded by four floats): H/32
//   slices x 4 = 128 CTAs at H=1024.
// * h(t-1) of a row group streams through an eight-stage cp.async ring in
//   64-row x 32-K boxes (9 KiB; the share's eight boxes at H=1024 all in
//   flight once the step's wait clears), zero-filled past the batch, from
//   a two-parity (2, B, H) buffer of carried h (parity 1 holds h0).
// * The product is a register-tiled SIMT FMA product: 256 threads, each
//   8 rows x 4 columns over the whole K share (8 broadcast float4 loads of
//   h and 4 conflict-free float4 loads of W for 128 FMAs).  (Two K halves
//   of 8 x 8 tiles meeting in shared memory, as the float32 GEMM tile sums,
//   spilled at 255 registers and took 22.9 against 21.1 µs a step.)
// * The four CTAs of a slice meet their (64, 128) partials through L2 in a
//   fixed order (a slot each, a per-slice counter, summed in the order of
//   q): no atomics in the arithmetic, a run repeats bit for bit.  Each CTA
//   then runs the cells of 8 of the slice's 32 units over the group's 64
//   rows (a thread a row and 2 units), stores h(t), adds 1 to the group's
//   step counter, which the next step's loads wait for, and only then
//   stores the residuals, the carries and the next layer's input (no other
//   CTA reads them in the launch), so the counter's fence waits for h(t)
//   alone.
// Planted faults (``skip_barrier``): bit 1 loads h(t-1) without the step
// wait, bit 2 sums the partials without the slice wait, bit 4 leaves the
// slice's last partial out of the sum (a wrong partial: the checks' fault,
// since the barriers' races show only now and then); ``skip_k`` leaves out
// the input product's last K stages.

#include <cuda_bf16.h>

#include "bounds_check.cuh"
#include "f32_gemm.cuh"
#include "grad_matmul.cuh"
#include "lstm_cell.cuh"
#include "philox.cuh"

namespace {

namespace tma = rst_grad::tma;

constexpr int kSplit = 4;                     // CTAs of a slice: the K split
constexpr int kUnits = 32;                    // hidden units of a slice
constexpr int kCols = 4 * kUnits;             // a slice's gate columns
constexpr int kCellUnits = kUnits / kSplit;   // units whose cells a CTA runs
constexpr int kRows = 64;                     // rows of a row group
constexpr int kThreads = 256;
constexpr int kKC = 32;                       // K columns of a streamed box
constexpr int kLdA = kKC + 4;                 // a box's padded row
constexpr int kStages = 8;                    // the box ring
constexpr int kPart = kRows * kCols;          // floats of one partial
constexpr int kSmemLimit = 232448;

long long g_launches = 0;      // chain launches (one a layer)
long long g_xp_launches = 0;   // input products (one a layer)

// K rows of a CTA's share of H, and its resident W rows' stride.
__host__ __device__ constexpr int k_share(int H) { return H / kSplit; }
__host__ __device__ constexpr int w_ld(int H) { return k_share(H) + 4; }

// The resident W_h block and the box ring.
__host__ __device__ constexpr size_t smem_bytes(int H) {
  return ((size_t)kCols * w_ld(H) + (size_t)kStages * kRows * kLdA) * sizeof(float);
}

struct Args {
  float* gates;        // (T, B, 4H): the input pre-activations in, activated gates out
  float* cseq;         // (T, B, H) carried c
  float* outs;         // (T, B, H) masked output
  float* xnext;        // (T, B, H) the next layer's input, or null (the top layer)
  const float* mask;   // (T, 1, B) f32 {0, 1}
  const float* w_h;    // (H, 4H)
  float* hc;           // (B, H) h carry: h0 on entry, hn on return
  float* cc;           // (B, H) c carry: c0 on entry, cn on return
  float* ring;         // (2, B, H) h(t) at parity t & 1; parity 1 holds h0 on entry
  float* part;         // (groups, slices, kSplit, 64, 128) partial products
  unsigned* counter;   // groups step counters, then groups x slices slice counters
  const __nv_bfloat16* masks;   // (T, B, H) boundary l's {0, 1} (drop mode 1), or null
  int T, B, H, groups;
  int drop_mode, l;              // the drop mode; the boundary this layer feeds
  unsigned seed0, seed1, thr;
  float scale;                   // 1/keep (drop modes 1, 2)
  int skip_barrier;              // planted faults: 1 no step wait, 2 no slice wait, 4 a partial left out
};

__global__ void __launch_bounds__(kThreads, 1) fwd_f32_persistent(Args p) {
  extern __shared__ __align__(16) float smem[];
  const int H = p.H, B = p.B, T = p.T, groups = p.groups;
  const int G = 4 * H;
  const int KQ = k_share(H), LW = w_ld(H), NC = KQ / kKC;
  float* w_s = smem;                                    // [kCols][LW]
  float* a_s = smem + (size_t)kCols * LW;               // kStages x [kRows][kLdA]
  const int slices = H / kUnits;
  const int q = blockIdx.x % kSplit, slice = blockIdx.x / kSplit;
  const unsigned ctas = kSplit * slices;
  const int tid = threadIdx.x;
  RST_CHECK(blockIdx.x, ctas);

  // W_h's block, transposed: w_s[c][k] = W_h[q·KQ + k][gate·H + 32·slice + u]
  // for column c = 32·gate + u.  Once a launch.
  for (int v = tid; v < kCols * KQ; v += kThreads) {
    const int k = v / kCols, c = v % kCols;
    const size_t src =
        (size_t)(q * KQ + k) * G + (size_t)(c / kUnits) * H + slice * kUnits + c % kUnits;
    RST_CHECK(src, (long long)H * G);
    rst_f32::cp_async4_zfill(w_s + c * LW + k, p.w_h + src, true);
  }
  rst::cp_async_commit();

  // The product: rows ty + 8i, columns tx + 32jj.  The cells: row r_c of
  // the group, slice units ju, ju + 1 (global unit j).
  const int tx = tid % 32, ty = tid / 32;
  const int r_c = tid / 4, ju = kCellUnits * q + 2 * (tid % 4), j = slice * kUnits + ju;

  // Box c of group g's h(t-1) (K columns q·KQ + 32c ..) into `stage`.
  auto load = [&](int t, int g, int c, int stage) {
    const float* hp = p.ring + (size_t)((t + 1) & 1) * B * H;
    float* as = a_s + (size_t)stage * kRows * kLdA;
    for (int v = tid; v < kRows * (kKC / 4); v += kThreads) {
      const int r = v / (kKC / 4), c4 = v % (kKC / 4);
      const int b = g * kRows + r;
      const bool ok = b < B;
      const size_t src = (size_t)(ok ? b : 0) * H + (size_t)q * KQ + c * kKC + 4 * c4;
      if (ok) RST_CHECK(src + 3, (long long)B * H);
      rst_f32::cp_async16_zfill(as + r * kLdA + 4 * c4, hp + src, ok);
    }
  };

  for (int t = 0; t < T; ++t) {
    for (int g = 0; g < groups; ++g) {
      const int b = g * kRows + r_c;
      const bool ok = b < B;
      const size_t e = (size_t)b * H + j;
      const size_t grow = ((size_t)t * B + b) * G + j;
      const size_t th = (size_t)t * B * H;
      // The cell's inputs, carries and keep bits: they do not wait for the chain.
      float2 h2 = {0.0f, 0.0f}, c2 = {0.0f, 0.0f};
      float2 xw[4] = {};
      float m = 0.0f, ks[2] = {1.0f, 1.0f};
      if (ok) {
        RST_CHECK(e + 1, (long long)B * H);
        RST_CHECK(grow + 3 * (size_t)H + 1, (long long)T * B * G);
        RST_CHECK((size_t)t * B + b, (long long)T * B);
        h2 = *reinterpret_cast<const float2*>(p.hc + e);
        c2 = *reinterpret_cast<const float2*>(p.cc + e);
#pragma unroll
        for (int g4 = 0; g4 < 4; ++g4) {
          xw[g4] = *reinterpret_cast<const float2*>(p.gates + grow + (size_t)g4 * H);
        }
        m = p.mask[(size_t)t * B + b];
        if (p.xnext != nullptr && p.drop_mode == 1) {
          RST_CHECK(th + e + 1, (long long)T * B * H);
#pragma unroll
          for (int k = 0; k < 2; ++k) ks[k] = __bfloat162float(p.masks[th + e + k]) * p.scale;
        } else if (p.xnext != nullptr && p.drop_mode == 2) {
          // Units j and j + 1 (j even) share Philox counter (j >> 2, b, t, l).
          const rst::Words4 w = rst::philox4x32_10((uint32_t)j >> 2, (uint32_t)b, (uint32_t)t,
                                                   (uint32_t)p.l, p.seed0, p.seed1);
#pragma unroll
          for (int k = 0; k < 2; ++k) ks[k] = rst::word(w, (j + k) & 3) < p.thr ? p.scale : 0.0f;
        }
      }

      if (t > 0 && tid == 0 && !(p.skip_barrier & 1)) {
        RST_CHECK(g, groups);
        tma::grid_wait(p.counter + g, (unsigned)t * ctas);
      }
      __syncthreads();
#pragma unroll
      for (int c = 0; c < kStages - 1; ++c) {
        if (c < NC) load(t, g, c, c);
        rst::cp_async_commit();
      }
      float acc[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) acc[i][jj] = 0.0f;
      for (int c = 0; c < NC; ++c) {
        rst::cp_async_wait<kStages - 2>();   // box c (and W_h) has landed
        __syncthreads();                     // every thread is done with box c - 1
        if (c + kStages - 1 < NC) load(t, g, c + kStages - 1, (c + kStages - 1) % kStages);
        rst::cp_async_commit();
        const float* as = a_s + (size_t)(c % kStages) * kRows * kLdA;
        const float* ws = w_s + c * kKC;
#pragma unroll
        for (int kk = 0; kk < kKC / 4; ++kk) {
          const int k = 4 * kk;
          float4 a[8], w[4];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            a[i] = *reinterpret_cast<const float4*>(as + (ty + 8 * i) * kLdA + k);
          }
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            w[jj] = *reinterpret_cast<const float4*>(ws + (tx + 32 * jj) * LW + k);
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
      rst::cp_async_wait<0>();

      // The slice's four partials meet through L2, summed in the order of q.
      const size_t slot = ((size_t)g * slices + slice) * kSplit;
      RST_CHECK((slot + kSplit) * kPart - 1, (long long)groups * slices * kSplit * kPart);
      float* my = p.part + (slot + q) * kPart;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) __stcg(my + (ty + 8 * i) * kCols + tx + 32 * jj, acc[i][jj]);
      __syncthreads();
      if (tid == 0) {
        RST_CHECK(groups + g * slices + slice, (long long)groups * (1 + slices));
        unsigned* slice_count = p.counter + groups + g * slices + slice;
        __threadfence();
        atomicAdd(slice_count, 1u);
        if (!(p.skip_barrier & 2)) tma::grid_wait(slice_count, (unsigned)(t + 1) * kSplit);
      }
      __syncthreads();

      // The cells.  h(t) goes out first: the step counter waits for it
      // alone; the residuals and carries, which no other CTA reads in this
      // launch, are stored after the arrive.
      float act[4][2] = {}, c_sel[2] = {}, h_sel[2] = {}, out[2] = {}, xn[2] = {};
      if (ok) {
        float sum[4][2] = {};
        const float* sp = p.part + slot * kPart + r_c * kCols + ju;
        const int parts = (p.skip_barrier & 4) ? kSplit - 1 : kSplit;
        for (int q4 = 0; q4 < parts; ++q4) {
#pragma unroll
          for (int g4 = 0; g4 < 4; ++g4) {
            const float2 v =
                __ldcg(reinterpret_cast<const float2*>(sp + (size_t)q4 * kPart + g4 * kUnits));
            sum[g4][0] += v.x;
            sum[g4][1] += v.y;
          }
        }
        const float xp[4][2] = {{xw[0].x, xw[0].y}, {xw[1].x, xw[1].y},
                                {xw[2].x, xw[2].y}, {xw[3].x, xw[3].y}};
        const float h_old[2] = {h2.x, h2.y}, c_old[2] = {c2.x, c2.y};
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const float i_a = rst::sigmoidf_(xp[0][k] + sum[0][k]);
          const float g_a = tanhf(xp[1][k] + sum[1][k]);
          const float f_a = rst::sigmoidf_(xp[2][k] + sum[2][k] + 1.0f);
          const float o_a = rst::sigmoidf_(xp[3][k] + sum[3][k]);
          const float c_new = f_a * c_old[k] + i_a * g_a;
          const float h_new = o_a * tanhf(c_new);
          c_sel[k] = m * c_new + (1.0f - m) * c_old[k];
          h_sel[k] = m * h_new + (1.0f - m) * h_old[k];
          out[k] = m * h_new;
          xn[k] = p.drop_mode ? h_sel[k] * ks[k] : h_sel[k];
          act[0][k] = i_a;
          act[1][k] = g_a;
          act[2][k] = f_a;
          act[3][k] = o_a;
        }
        RST_CHECK((size_t)(t & 1) * B * H + e + 1, 2ll * B * H);
        *reinterpret_cast<float2*>(p.ring + (size_t)(t & 1) * B * H + e) =
            make_float2(h_sel[0], h_sel[1]);
      }
      __syncthreads();                     // the group's h(t) is all written
      if (tid == 0) {
        RST_CHECK(g, groups);
        __threadfence();
        atomicAdd(p.counter + g, 1u);
      }
      if (ok) {
        RST_CHECK(th + e + 1, (long long)T * B * H);
#pragma unroll
        for (int g4 = 0; g4 < 4; ++g4) {
          *reinterpret_cast<float2*>(p.gates + grow + (size_t)g4 * H) =
              make_float2(act[g4][0], act[g4][1]);
        }
        *reinterpret_cast<float2*>(p.cseq + th + e) = make_float2(c_sel[0], c_sel[1]);
        *reinterpret_cast<float2*>(p.outs + th + e) = make_float2(out[0], out[1]);
        *reinterpret_cast<float2*>(p.hc + e) = make_float2(h_sel[0], h_sel[1]);
        *reinterpret_cast<float2*>(p.cc + e) = make_float2(c_sel[0], c_sel[1]);
        if (p.xnext != nullptr) {
          *reinterpret_cast<float2*>(p.xnext + th + e) = make_float2(xn[0], xn[1]);
        }
      }
    }
  }
}

// The input product's epilogue: xp = acc + bias into the gates residual.
struct XpEpi {
  float* gates;        // (rows, 4H)
  const float* bias;   // (4H)
  int G;
  long long rows;
  __device__ __forceinline__ void operator()(int row, int col, float v) const {
    RST_CHECK(row, rows);
    RST_CHECK(col, G);
    gates[(size_t)row * G + col] = v + bias[col];
  }
};

// The input product xp = x_in·w_x + bias of `rows` rows into gates.
int launch_xp(const float* x_in, const float* w_x, const float* bias, float* gates, int rows,
              int H, int K, int skip_k, cudaStream_t st) {
  rst_f32::Operands op = {};
  op.a1 = x_in;
  op.b1 = w_x;
  op.M = rows;
  op.N = 4 * H;
  op.K1 = K;
  op.K2 = 0;
  op.a_rows = rows;
  op.skip_k = skip_k;
  return rst_f32::launch<false>(op, XpEpi{gates, bias, 4 * H, rows}, st);
}

// The chain's attributes set and its co-residency checked; the grid.
int prepare(int H, int* grid, size_t* smem) {
  const void* fn = reinterpret_cast<const void*>(fwd_f32_persistent);
  *grid = H / kUnits * kSplit;
  *smem = smem_bytes(H);
  if (*smem > (size_t)kSmemLimit) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, *smem)) !=
          cudaSuccess) {
    return (int)err;
  }
  if (per_sm * sms < *grid) return (int)cudaErrorCooperativeLaunchTooLarge;
  return 0;
}

}  // namespace

// One layer of the float32 layer sweep's forward.  x_in (T·B, K): the
// layer's input (x for layer 0, the layer below's next-layer input
// otherwise); w_x (K, 4H), bias (4H), w_h (H, 4H); mask (T, 1, B) {0, 1};
// gates (T, B, 4H), cseq, outs (T, B, H): the layer's residuals, written;
// xnext (T, B, H): the next layer's input h·keep·scale of boundary l, or
// null for the top layer (it may be x_in's buffer: the product reads x_in
// before the chain writes xnext); hc, cc (B, H) holding h0, c0 on entry
// and hn, cn on return; ring (2, B, H) scratch with h0 in parity 1; part
// (groups, H/32, 4, 64, 128) scratch; counter groups·(1 + H/32) uint32.
// All float32, 16-byte aligned; H a multiple of 128, K of 16; groups =
// ceil(B/64).  Dropout of boundary l (below the top layer): drop_mode 0,
// 1 (masks (T, B, H) bf16 {0, 1}) or 2 (the Philox bits of (seed0, seed1)
// under thr); scale = 1/keep.  skip_barrier and skip_k plant faults (see
// the header).  Both launches on `stream`; returns the CUDA error code
// (0 = success).
extern "C" int rst_lstm_layer_fwd_f32(const float* x_in, const float* w_x, const float* bias,
                                      const float* w_h, const float* mask, float* gates,
                                      float* cseq, float* outs, float* xnext, float* hc,
                                      float* cc, float* ring, float* part, void* counter,
                                      const void* masks, int T, int B, int H, int K, int groups,
                                      int drop_mode, unsigned seed0, unsigned seed1, unsigned thr,
                                      float scale, int l, int skip_barrier, int skip_k,
                                      void* stream) {
  if (H % 128 || K % 16 || K <= 0 || T < 1 || B < 1 || groups < 1 || B > groups * kRows ||
      B <= (groups - 1) * kRows || drop_mode < 0 || drop_mode > 2 ||
      (xnext != nullptr && drop_mode == 1) != (masks != nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = launch_xp(x_in, w_x, bias, gates, T * B, H, K, skip_k, st);
  if (err != 0) return err;
  ++g_xp_launches;

  int grid = 0;
  size_t smem = 0;
  if ((err = prepare(H, &grid, &smem)) != 0) return err;
  const int slices = H / kUnits;
  Args p = {};
  p.gates = gates;
  p.cseq = cseq;
  p.outs = outs;
  p.xnext = xnext;
  p.mask = mask;
  p.w_h = w_h;
  p.hc = hc;
  p.cc = cc;
  p.ring = ring;
  p.part = part;
  p.counter = static_cast<unsigned*>(counter);
  p.masks = static_cast<const __nv_bfloat16*>(masks);
  p.T = T;
  p.B = B;
  p.H = H;
  p.groups = groups;
  p.drop_mode = xnext != nullptr ? drop_mode : 0;
  p.l = l;
  p.seed0 = seed0;
  p.seed1 = seed1;
  p.thr = thr;
  p.scale = scale;
  p.skip_barrier = skip_barrier;
  cudaError_t e =
      cudaMemsetAsync(counter, 0, (size_t)groups * (1 + slices) * sizeof(unsigned), st);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {&p};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(fwd_f32_persistent), grid,
                                  kThreads, args, smem, st);
  if (e != cudaSuccess) return (int)e;
  ++g_launches;
  return 0;
}

// The input product alone (for timings of the sweep's split; not
// counted): gates (rows, 4H) = x_in (rows, K)·w_x (K, 4H) + bias.  Returns
// the CUDA error code.
extern "C" int rst_layer_fwd_f32_xp(const float* x_in, const float* w_x, const float* bias,
                                    float* gates, int rows, int H, int K, void* stream) {
  if (H % 128 || K % 16 || K <= 0 || rows < 0) return (int)cudaErrorInvalidValue;
  return launch_xp(x_in, w_x, bias, gates, rows, H, K, 0, static_cast<cudaStream_t>(stream));
}

// Launches so far, counted at the launch sites: the chains (one a layer)
// and the input products (one a layer).
extern "C" long long rst_layer_fwd_f32_launches() { return g_launches; }
extern "C" long long rst_layer_fwd_f32_xp_launches() { return g_xp_launches; }
