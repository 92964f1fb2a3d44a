// Log-mel filterbank energies of the fbank frontend, for Hopper (sm_90a):
// framing -> windowed DFT -> power -> mel -> 10·log10 in one pass.
//
// Replaces the TPU kernel `_fbank_kernel` of
// rnn_speech_tpu/ops/frontend_pallas.py (entry `fbank_banks_pallas`).  For
// each row b of the pre-emphasised, padding-zeroed signal and each frame t
// (samples t·step .. t·step + L_eff - 1, L_eff = min(frame_length, n_fft)):
//   spec  = frame · basis            (the windowed real DFT, [cos | -sin])
//   power = (re² + im²) / n_fft      per bin (n_fft/2 + 1 bins)
//   banks = 10·log10(power · mel), a bank of exactly 0 taken as float64 eps.
// The TPU kernel frames a tile with K shifted sublane slices of a
// lane-padded (rows, step) strip and pads the basis and the mel matrix to
// 128 lanes for Mosaic; here a frame is read straight from a shared-memory
// strip of the signal at offset f·step, and nothing is padded.
//
// What bounds it on the H100: operations.  The DFT is 2·L_eff·2·bins flops
// per frame in float32 (the JAX kernel runs Precision.HIGHEST and the
// port's frontend keeps TF32 off): at B = 128 rows of 1024 frames, L_eff =
// 512 and 257 bins, 69.0 GFLOP, plus 2.7 for the mel product, 1.07 ms at 67
// TFLOP/s of f32 FMA; the signal in and the banks out are 137 MB, 0.04 ms.
//
// What this design does about it: one block of 256 threads per (row, 64
// frames).  The block stages its signal strip ((64 - 1)·step + L_eff
// samples, 57.5 KB at 22050 Hz) in shared memory with cp.async, then
// streams the basis through a double-buffered shared ring of 32-row
// stages (cp.async, from L2: every block reads the same 1 MB basis), 64
// bins (their cos and sin columns) at a time.  Each thread keeps a 4-frame
// x 4-bin x (re, im) register tile, fed by 16-byte shared loads (four
// samples of a frame, four bins of a basis row), so the inner loop is 32
// FMAs per 12 vector loads.  A chunk's power rows go to shared memory (64
// x 257 f32); the bins past the last whole chunk (the Nyquist bin) are
// summed per frame by a warp.  Then the mel matrix replaces the strip and
// each thread forms banks of its (frame, filter) pairs and their log10.
// Sums are float32 FMAs in another order than the plain version's matmul.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kTF = 64;   // frames per block
constexpr int kBC = 64;   // DFT bins per chunk (cos and sin columns each)
constexpr int kKC = 32;   // basis rows per stage
constexpr int kStage = kKC * 2 * kBC;
constexpr float kEps = 2.220446049250313e-16f;  // float64 eps, as the plain version

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// (re² + im²) / n_fft without contracting the sum into an FMA, rounded as
// the plain version rounds it.
__device__ __forceinline__ float power_of(float re, float im, float n_fft) {
  return __fdiv_rn(__fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im)), n_fft);
}

__device__ __forceinline__ float lane_of(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

__global__ void __launch_bounds__(kThreads)
    fbank_kernel(const float* __restrict__ pre, const float* __restrict__ basis,
                 const float* __restrict__ mel, float* __restrict__ out, int n_samples,
                 int step, int l_eff, int ld_basis, int bins, int n_mels, int n_frames,
                 float n_fft, int strip_len, int region) {
  extern __shared__ __align__(16) float smem[];
  float* strip = smem;                  // [region]: the signal strip, then the mel matrix
  float* power = smem + region;         // [kTF][bins]
  float* ring = power + kTF * bins;     // [2][kKC][2 kBC]: basis stages
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kTF;
  const float* sig = pre + (size_t)b * n_samples;
  const long long base = (long long)t0 * step;
  for (int i = tid; i < strip_len; i += kThreads) {
    const long long g = base + i;
    const bool ok = g < n_samples;
    cp_async4(strip + i, sig + (ok ? g : 0), ok ? 4 : 0);
  }
  cp_async_commit();

  const int n_full = bins / kBC;
  const int n_k = (l_eff + kKC - 1) / kKC;
  const int n_stages = n_full * n_k;
  // Stage st: rows kc·kKC.. of chunk c's cos columns, then its sin columns;
  // rows past L_eff are zero-filled.
  auto load_stage = [&](int st) {
    const int c = st / n_k, kc = st % n_k;
    float* dst = ring + (st & 1) * kStage;
    for (int e = tid; e < kStage; e += kThreads) {
      const int r = e / (2 * kBC), col = e % (2 * kBC);
      const int k = kc * kKC + r;
      const int gcol = col < kBC ? c * kBC + col : bins + c * kBC + (col - kBC);
      const bool ok = k < l_eff;
      cp_async4(dst + e, basis + (size_t)(ok ? k : 0) * ld_basis + gcol, ok ? 4 : 0);
    }
    cp_async_commit();
  };

  const int tf = tid >> 4;  // frames tf + 16 i
  const int tb = tid & 15;  // bins 4 tb .. 4 tb + 3 of the chunk
  float re[4][4], im[4][4];
  if (n_stages > 0) load_stage(0);
  for (int st = 0; st < n_stages; ++st) {
    const int c = st / n_k, kc = st % n_k;
    if (kc == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) re[i][j] = im[i][j] = 0.0f;
      }
    }
    if (st + 1 < n_stages) {
      load_stage(st + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* bb = ring + (st & 1) * kStage;
    const float* a0 = strip + kc * kKC;
#pragma unroll
    for (int kk = 0; kk < kKC; kk += 4) {
      float4 a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = *reinterpret_cast<const float4*>(a0 + (tf + 16 * i) * step + kk);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 br = *reinterpret_cast<const float4*>(bb + (kk + q) * 2 * kBC + 4 * tb);
        const float4 bi =
            *reinterpret_cast<const float4*>(bb + (kk + q) * 2 * kBC + kBC + 4 * tb);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float av = lane_of(a[i], q);
          re[i][0] = fmaf(av, br.x, re[i][0]);
          re[i][1] = fmaf(av, br.y, re[i][1]);
          re[i][2] = fmaf(av, br.z, re[i][2]);
          re[i][3] = fmaf(av, br.w, re[i][3]);
          im[i][0] = fmaf(av, bi.x, im[i][0]);
          im[i][1] = fmaf(av, bi.y, im[i][1]);
          im[i][2] = fmaf(av, bi.z, im[i][2]);
          im[i][3] = fmaf(av, bi.w, im[i][3]);
        }
      }
    }
    if (kc == n_k - 1) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          power[(tf + 16 * i) * bins + c * kBC + 4 * tb + j] =
              power_of(re[i][j], im[i][j], n_fft);
        }
      }
    }
    __syncthreads();  // the ring buffer is refilled by the next iteration
  }
  cp_async_wait<0>();
  __syncthreads();

  // The bins past the last whole chunk: their columns staged in the ring,
  // each frame's sums split over a warp's lanes.
  const int R = bins - n_full * kBC;
  if (R > 0) {
    for (int e = tid; e < l_eff * 2 * R; e += kThreads) {
      const int k = e / (2 * R), j = e % (2 * R);
      const int gcol = j < R ? n_full * kBC + j : bins + n_full * kBC + (j - R);
      ring[e] = basis[(size_t)k * ld_basis + gcol];
    }
    __syncthreads();
    const int warp = tid >> 5, lane = tid & 31;
    for (int f = warp; f < kTF; f += kThreads / 32) {
      for (int j = 0; j < R; ++j) {
        float sr = 0.0f, si = 0.0f;
        for (int k = lane; k < l_eff; k += 32) {
          const float a = strip[f * step + k];
          sr = fmaf(a, ring[k * 2 * R + j], sr);
          si = fmaf(a, ring[k * 2 * R + R + j], si);
        }
#pragma unroll
        for (int o = 16; o; o >>= 1) {
          sr += __shfl_xor_sync(0xffffffffu, sr, o);
          si += __shfl_xor_sync(0xffffffffu, si, o);
        }
        if (lane == 0) power[f * bins + n_full * kBC + j] = power_of(sr, si, n_fft);
      }
    }
    __syncthreads();
  }

  // The mel product and the log, the mel matrix in the strip's place.
  for (int e = tid; e < bins * n_mels; e += kThreads) strip[e] = mel[e];
  __syncthreads();
  const int nf = min(kTF, n_frames - t0);
  for (int o = tid; o < nf * n_mels; o += kThreads) {
    const int f = o / n_mels, m = o % n_mels;
    const float* pw = power + f * bins;
    float acc = 0.0f;
    for (int k = 0; k < bins; ++k) acc = fmaf(pw[k], strip[k * n_mels + m], acc);
    out[((size_t)b * n_frames + t0 + f) * n_mels + m] =
        10.0f * log10f(acc == 0.0f ? kEps : acc);
  }
}

int region_of(int step, int l_eff, int bins, int n_mels, int* strip_len) {
  const int n_k = (l_eff + kKC - 1) / kKC;
  *strip_len = (kTF - 1) * step + n_k * kKC;
  const int region = *strip_len > bins * n_mels ? *strip_len : bins * n_mels;
  return (region + 3) / 4 * 4;
}

}  // namespace

// Dynamic shared memory of rst_fbank, in bytes.
extern "C" long long rst_fbank_smem(int step, int l_eff, int bins, int n_mels) {
  int strip_len;
  const int region = region_of(step, l_eff, bins, n_mels, &strip_len);
  return (long long)sizeof(float) * (region + kTF * bins + 2 * kStage);
}

// pre (B, n_samples) f32, pre-emphasised with its padding zeroed; basis
// (>= l_eff rows, ld_basis = 2·bins columns [cos | -sin]) f32 with the
// window folded in; mel (bins, n_mels) f32; out (B, n_frames, n_mels) f32.
// step % 4 == 0 (16-byte frame loads) and l_eff·2·(bins % 64) <= 8192 (the
// remainder bins' columns fit the ring) are the wrapper's to check.
// Returns the CUDA error code of the launch (0 = success).
extern "C" int rst_fbank(const float* pre, const float* basis, const float* mel, float* out,
                         int B, int n_samples, int step, int l_eff, int ld_basis, int bins,
                         int n_mels, int n_frames, int n_fft, void* stream) {
  if (B <= 0 || n_frames <= 0) return 0;
  int strip_len;
  const int region = region_of(step, l_eff, bins, n_mels, &strip_len);
  const size_t smem = sizeof(float) * ((size_t)region + kTF * bins + 2 * kStage);
  cudaError_t err =
      cudaFuncSetAttribute(fbank_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_frames + kTF - 1) / kTF, B);
  fbank_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      pre, basis, mel, out, n_samples, step, l_eff, ld_basis, bins, n_mels, n_frames,
      (float)n_fft, strip_len, region);
  return (int)cudaGetLastError();
}
