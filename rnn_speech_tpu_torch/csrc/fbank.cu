// Log-mel filterbank energies of the fbank frontend, for Hopper (sm_90a):
// framing -> window -> real FFT -> power -> mel -> 10·log10 in one pass.
//
// Replaces the TPU kernel `_fbank_kernel` of
// rnn_speech_tpu/ops/frontend_pallas.py (entry `fbank_banks_pallas`).  For
// each row b of the pre-emphasised, padding-zeroed signal and each frame t
// (samples t·step .. t·step + L_eff - 1, L_eff = min(frame_length, n_fft),
// zero-padded to n_fft = 512):
//   X     = rfft(frame · window)     257 bins
//   power = (re² + im²) / n_fft      per bin
//   banks = 10·log10(power · mel), a bank of exactly 0 taken as float64 eps.
// The TPU kernel runs the windowed DFT as a dense product against a
// (frame_length, 2·bins) basis and the mel step as a dense product; here
// the transform is an FFT and each filter sums only its non-zero bins.
//
// What bounds it on the H100: operations.  A real FFT of 512 points is
// about 5·256·log2(512) = 11.5k float32 operations a frame; with the
// window, the power and the mel product counted dense (2·257·40), 33.6k:
// at B = 128 rows of 1024 frames, 4.4 GFLOP, 0.066 ms at 67 TFLOP/s (the
// bound chip_smoke.py reports).  The signal in and the banks out are 137
// MB, 0.04 ms at 3.35 TB/s.  The dense DFT did 2·512·2·257 = 526k a frame;
// this kernel does ~13k (the filters' non-zero bins only, ~2·2·257).
//
// What this design does about it: one block of eight warps per (row, 64
// frames) stages its signal strip ((64 - 1)·step + n_fft samples, 57.5 KB
// at 22050 Hz) in shared memory with cp.async; each warp then takes one
// frame at a time.  The 512 real samples are 256 complex points z[n] =
// (x[2n], x[2n+1]); a lane loads four samples at a time (16-byte shared
// loads, hence step % 4 == 0) with its window values held in registers,
// and the 256-point complex FFT runs as four radix-4 Stockham passes (the
// output in natural order, no bit reversal) through two padded
// shared-memory buffers of the warp, two butterflies a lane a pass.  The
// split step X[k] = ½(Z[k] + Z*[256-k]) - ½i·W^k(Z[k] - Z*[256-k]) turns
// Z into the 257 bins; each lane's mel filters then sum their bins' power
// from shared memory.  Twiddles, split factors W^k = e^(-2πik/512) and the
// filters' bin ranges come from the host (ops/frontend_kernel.py),
// computed in float64 and rounded to float32.  Sums are float32 in
// another order than the plain version's matmuls.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kNfft = 512;
constexpr int kN = kNfft / 2;        // complex points of the FFT
constexpr int kBins = kN + 1;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTF = 64;              // frames per block
constexpr int kTw = 64 + 16 + 4 + 1;  // twiddle triples (w, w², w³) of the four passes
constexpr int kBuf = kN + kN / 16;   // padded complex slots of one buffer
constexpr float kEps = 2.220446049250313e-16f;  // float64 eps, as the plain version

__device__ __forceinline__ int pad(int i) { return i + (i >> 4); }

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes));
}

// (re² + im²) / n_fft without contracting the sum into an FMA, rounded as
// the plain version rounds it.
__device__ __forceinline__ float power_of(float re, float im, float n_fft) {
  return __fdiv_rn(__fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im)), n_fft);
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// One radix-4 butterfly of a decimation-in-frequency pass over n = 4m
// points (stride s): inputs a, b, c, d = x[q + s(p + jm)], j = 0..3, out
// y[q + s(4p + r)] = w^r · (Σ_j x_j (-i)^(jr)), w = e^(-2πip/n).
__device__ __forceinline__ void butterfly(float2 a, float2 b, float2 c, float2 d,
                                          const float2* w, float2* y, int q, int s, int p) {
  const float2 apc = cadd(a, c), amc = csub(a, c), bpd = cadd(b, d);
  const float2 bmd = csub(b, d);
  const float2 jbmd = make_float2(bmd.y, -bmd.x);   // -i·(b - d)
  y[pad(q + s * (4 * p))] = cadd(apc, bpd);
  y[pad(q + s * (4 * p + 1))] = cmul(w[0], cadd(amc, jbmd));
  y[pad(q + s * (4 * p + 2))] = cmul(w[1], csub(apc, bpd));
  y[pad(q + s * (4 * p + 3))] = cmul(w[2], csub(amc, jbmd));
}

__global__ void __launch_bounds__(kThreads)
    fbank_kernel(const float* __restrict__ pre, const float* __restrict__ window,
                 const float2* __restrict__ twiddles, const float2* __restrict__ split,
                 const float* __restrict__ mel, const int* __restrict__ mel_lo,
                 const int* __restrict__ mel_hi, float* __restrict__ out, int n_samples,
                 int step, int n_mels, int n_frames, int strip_len) {
  extern __shared__ __align__(16) float smem[];
  float* strip = smem;                                               // [strip_len]
  float2* bufs = reinterpret_cast<float2*>(smem + strip_len);        // [kWarps][2][kBuf]
  float2* tw = bufs + kWarps * 2 * kBuf;                             // [kTw][3]
  float2* sp = tw + 3 * kTw;                                         // [kBins]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kTF;
  const float* sig = pre + (size_t)b * n_samples;
  const long long base = (long long)t0 * step;
  for (int i = tid; i < strip_len; i += kThreads) {
    const long long g = base + i;
    const bool ok = g < n_samples;
    cp_async4(strip + i, sig + (ok ? g : 0), ok ? 4 : 0);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  for (int i = tid; i < 3 * kTw; i += kThreads) tw[i] = twiddles[i];
  for (int i = tid; i < kBins; i += kThreads) sp[i] = split[i];
  // This lane's window values: samples 4·lane + 128j .. + 3, j = 0..3.
  float4 win[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) win[j] = reinterpret_cast<const float4*>(window)[lane + 32 * j];
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  float2* A = bufs + warp * 2 * kBuf;
  float2* Bf = A + kBuf;
  const int nf = min(kTF, n_frames - t0);
  for (int f = warp; f < nf; f += kWarps) {
    // Pass 0 (n = 256, s = 1) from the strip: this lane's butterflies
    // β = 2·lane, 2·lane + 1 read z[β + 64j], the samples 4·lane + 128j ...
    const float* frame = strip + f * step;
    float2 z0[4], z1[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 v = *reinterpret_cast<const float4*>(frame + 4 * lane + 128 * j);
      z0[j] = make_float2(v.x * win[j].x, v.y * win[j].y);
      z1[j] = make_float2(v.z * win[j].z, v.w * win[j].w);
    }
    butterfly(z0[0], z0[1], z0[2], z0[3], tw + 3 * (2 * lane), A, 0, 1, 2 * lane);
    butterfly(z1[0], z1[1], z1[2], z1[3], tw + 3 * (2 * lane + 1), A, 0, 1, 2 * lane + 1);
    __syncwarp();
    // Passes 1..3 (s = 4, 16, 64; m = 64 / s): butterflies β = lane, lane + 32.
    float2* in = A;
    float2* outb = Bf;
    int off = 64;
#pragma unroll
    for (int s = 4; s <= 64; s *= 4) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int beta = lane + 32 * h;
        const int p = beta / s, q = beta % s;
        butterfly(in[pad(beta)], in[pad(beta + 64)], in[pad(beta + 128)], in[pad(beta + 192)],
                  tw + 3 * (off + p), outb, q, s, p);
      }
      off += 64 / s;
      __syncwarp();
      float2* tmp = in;
      in = outb;
      outb = tmp;
    }
    // Z (natural order) is in `in`; the split into 257 bins, their power
    // into the other buffer.
    float* pw = reinterpret_cast<float*>(outb);
    for (int k = lane; k < kBins; k += 32) {
      const float2 zk = in[pad(k & (kN - 1))];
      const float2 zn = in[pad((kN - k) & (kN - 1))];
      const float2 w = sp[k];
      const float ore = zk.x - zn.x, oim = zk.y + zn.y;       // Z[k] - conj(Z[256-k])
      const float re = 0.5f * (zk.x + zn.x) + 0.5f * (w.x * oim + w.y * ore);
      const float im = 0.5f * (zk.y - zn.y) - 0.5f * (w.x * ore - w.y * oim);
      pw[k] = power_of(re, im, (float)kNfft);
    }
    __syncwarp();
    float* o = out + ((size_t)b * n_frames + t0 + f) * n_mels;
    for (int m = lane; m < n_mels; m += 32) {
      float acc = 0.0f;
      for (int k = mel_lo[m]; k < mel_hi[m]; ++k) acc = fmaf(pw[k], mel[k * n_mels + m], acc);
      o[m] = 10.0f * log10f(acc == 0.0f ? kEps : acc);
    }
    __syncwarp();   // before the next frame overwrites the buffers
  }
}

int strip_of(int step) { return ((kTF - 1) * step + kNfft + 3) / 4 * 4; }

}  // namespace

// Dynamic shared memory of rst_fbank, in bytes.
extern "C" long long rst_fbank_smem(int step) {
  return (long long)sizeof(float) * strip_of(step) +
         (long long)sizeof(float2) * (kWarps * 2 * kBuf + 3 * kTw + kBins);
}

// pre (B, n_samples) f32, pre-emphasised with its padding zeroed; window
// (512,) f32, zero past L_eff (16-byte aligned); twiddles (85, 3) complex
// f32 (the passes' (w, w², w³) for p < 64, 16, 4, 1); split (257,) complex
// f32, e^(-2πik/512); mel (257, n_mels) f32; mel_lo, mel_hi (n_mels,) int32:
// each filter's non-zero bins [lo, hi); out (B, n_frames, n_mels) f32.
// step % 4 == 0 is the wrapper's to check.  Returns the CUDA error code of
// the launch (0 = success).
extern "C" int rst_fbank(const float* pre, const float* window, const void* twiddles,
                         const void* split, const float* mel, const int* mel_lo,
                         const int* mel_hi, float* out, int B, int n_samples, int step,
                         int n_mels, int n_frames, void* stream) {
  if (B <= 0 || n_frames <= 0) return 0;
  const size_t smem = (size_t)rst_fbank_smem(step);
  cudaError_t err =
      cudaFuncSetAttribute(fbank_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_frames + kTF - 1) / kTF, B);
  fbank_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      pre, window, static_cast<const float2*>(twiddles), static_cast<const float2*>(split), mel,
      mel_lo, mel_hi, out, n_samples, step, n_mels, n_frames, strip_of(step));
  return (int)cudaGetLastError();
}
