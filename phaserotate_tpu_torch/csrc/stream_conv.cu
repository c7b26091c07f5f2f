// Partitioned direct-DFT Hilbert convolution, with an optional rotation
// mix, for Hopper (sm_90a).
//
// Replaces: phaserotate_tpu/kernels/stream_conv.py _call / _make_kernel, the
// Pallas kernel behind fused_hilbert_small (conv-only mode: the Hilbert
// half of every analyzer sweep and apply) and fused_rotate_small /
// fused_stream_mix (mix mode: the FIR rotate).  It computes the linear
// convolution h = fir * x with the fir_taps-tap Hilbert FIR through a fixed
// 256-sample frame:
//   - forward half spectrum of each frame, zero padded to 512 points
//     (bins 0..256), as a direct DFT;
//   - a frequency-delay-line complex multiply-accumulate over the
//     ns = fir_taps / 256 partition spectra;
//   - the inverse with the Hermitian doubling and 1/512 folded in, and a
//     one-frame overlap-add tail;
//   - mix mode: out[m] = cos(rad_m) * x[m - D*256] + sin(rad_m) * h[m] with
//     rad_m = 2*pi*(angle + slope*i) from per-frame (angle, slope) pairs.
//
// What bounds it on the card: FP32 arithmetic.  The direct transforms cost
// about 256*257*2 (forward) + 256*258*2 (inverse) multiply-adds per frame,
// some 1,000 FP32 operations per input sample, against 8 bytes of HBM
// traffic per sample for input and output plus 2 KB of spectrum per frame.
// All of it runs in full FP32 on CUDA cores: nothing at TF32.
//
// What the design does about it:
//   - The TPU carried the spectrum history, the overlap-add tail and the
//     dry delay across a sequential time axis.  Blocks here run in no
//     order, so the work is split in two passes.  Pass 1 writes every
//     frame's 257-bin spectrum to global memory.  Pass 2 takes one tile of
//     frames per block, reads the ns spectra each frame needs, and
//     recomputes the one frame before the tile for its overlap-add tail.
//   - Every twiddle comes from one 512-entry (cos, sin) table in shared
//     memory, indexed by (n*k) mod 512 — the values of stream_conv.py
//     _dft_consts.  A twiddle read serves a whole tile of frames.
//   - The inverse computes, per output sample m, the sums over even and odd
//     bins separately: since e^{j*pi*k} = (-1)^k, sample m of the frame is
//     even + odd and sample m + 256 (the overlap-add tail) is even - odd,
//     so the 512-point inverse costs one 256-point pass.
//   - The imaginary parts of the DC and Nyquist bins are exact zeros, as
//     irfft discards them.
//   - Mix mode rounds cos*dry + sin*h with __fmul_rn / __fadd_rn like the
//     plain PyTorch version; sincosf is full precision (no fast math).
//   - Rows times frame tiles ride gridDim.x, so any number of rows fits
//     one launch.

#include <cuda_runtime.h>

namespace {

constexpr int kP = 256;           // samples per internal frame
constexpr int kFftLen = 2 * kP;   // zero-padded transform length
constexpr int kBins = kP + 2;     // bins 0..256 plus one zero bin (pairs)
constexpr int kThreads = 288;     // 9 warps: one thread per bin 0..257
constexpr int kFwdTile = 32;      // frames per block, pass 1
constexpr int kConvTile = 16;     // output frames per block, pass 2
constexpr float kTwoPi = 6.28318530717958647692f;

__device__ __forceinline__ void load_twiddles(float2* tw_s,
                                              const float2* twiddle) {
  for (int i = threadIdx.x; i < kFftLen; i += kThreads) tw_s[i] = twiddle[i];
}

// Pass 1: spec[b, f, k] = sum_n frames[b, f, n] * e^{-2*pi*j*n*k/512}.
__global__ void __launch_bounds__(kThreads)
dft_forward(const float* __restrict__ frames, const float2* __restrict__ twiddle,
            float2* __restrict__ spec, int n_frames, int tiles) {
  __shared__ __align__(16) float x_s[kFwdTile][kP];
  __shared__ float2 tw_s[kFftLen];
  const int b = blockIdx.x / tiles;
  const int f0 = (blockIdx.x % tiles) * kFwdTile;
  const long long base = static_cast<long long>(b) * n_frames;
  for (int i = threadIdx.x; i < kFwdTile * kP; i += kThreads) {
    const int f = i / kP, n = i % kP;
    x_s[f][n] = f0 + f < n_frames ? frames[(base + f0 + f) * kP + n] : 0.f;
  }
  load_twiddles(tw_s, twiddle);
  __syncthreads();

  const int k = threadIdx.x;
  if (k > kP + 1) return;
  float re[kFwdTile], im[kFwdTile];
#pragma unroll
  for (int f = 0; f < kFwdTile; ++f) re[f] = im[f] = 0.f;
  if (k <= kP) {
    for (int n = 0; n < kP; n += 4) {
      float2 w[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) w[q] = tw_s[((n + q) * k) & (kFftLen - 1)];
#pragma unroll
      for (int f = 0; f < kFwdTile; ++f) {
        const float4 xv = *reinterpret_cast<const float4*>(&x_s[f][n]);
        re[f] += xv.x * w[0].x + xv.y * w[1].x + xv.z * w[2].x + xv.w * w[3].x;
        im[f] += xv.x * w[0].y + xv.y * w[1].y + xv.z * w[2].y + xv.w * w[3].y;
      }
    }
  }
  // DC and Nyquist are real for real input; bin 257 is the zero pad bin
  const bool real_bin = k == 0 || k == kP;
#pragma unroll
  for (int f = 0; f < kFwdTile; ++f) {
    if (f0 + f < n_frames) {
      spec[(base + f0 + f) * kBins + k] =
          make_float2(re[f], real_bin ? 0.f : -im[f]);
    }
  }
}

// Pass 2: frequency-delay-line MAC, inverse DFT, overlap-add, optional mix.
template <bool kMix>
__global__ void __launch_bounds__(kThreads)
conv_mix(const float* __restrict__ frames, const float2* __restrict__ fir,
         const float2* __restrict__ twiddle, const float2* __restrict__ angs,
         const float2* __restrict__ spec, float* __restrict__ out,
         int n_frames, int ns, int d_frames, int tiles) {
  // u_s[f][k/2] holds bins (k, k+1) of frame f0-1+f as
  // (c_k*Re, -c_k*Im, c_k1*Re, -c_k1*Im), the inverse weights folded in
  __shared__ float4 u_s[kConvTile + 1][kBins / 2];
  __shared__ float2 tw_s[kFftLen];
  const int b = blockIdx.x / tiles;
  const int f0 = (blockIdx.x % tiles) * kConvTile;
  const long long base = static_cast<long long>(b) * n_frames;
  load_twiddles(tw_s, twiddle);

  {  // stage 1: U[g] = sum_s S[g - s] * F[s], thread per bin
    const int k = threadIdx.x;
    if (k < kBins) {
      float ur[kConvTile + 1], ui[kConvTile + 1];
#pragma unroll
      for (int f = 0; f <= kConvTile; ++f) ur[f] = ui[f] = 0.f;
      for (int s = 0; s < ns; ++s) {
        const float2 g = fir[s * kBins + k];
#pragma unroll
        for (int f = 0; f <= kConvTile; ++f) {
          const int fr = f0 - 1 + f;  // frame whose spectrum sum this is
          const int src = fr - s;
          if (src >= 0 && fr < n_frames) {
            const float2 x = spec[(base + src) * kBins + k];
            ur[f] += x.x * g.x - x.y * g.y;
            ui[f] += x.x * g.y + x.y * g.x;
          }
        }
      }
      const bool real_bin = k == 0 || k == kP;
      const float c = (real_bin ? 1.f : 2.f) / kFftLen;
      float* u = reinterpret_cast<float*>(u_s);
#pragma unroll
      for (int f = 0; f <= kConvTile; ++f) {
        u[(f * kBins + k) * 2] = c * ur[f];
        u[(f * kBins + k) * 2 + 1] = real_bin ? 0.f : -c * ui[f];
      }
    }
  }
  __syncthreads();

  const int m = threadIdx.x;  // stage 2: thread per output sample
  if (m >= kP) return;
  float ev[kConvTile + 1], od[kConvTile + 1];
#pragma unroll
  for (int f = 0; f <= kConvTile; ++f) ev[f] = od[f] = 0.f;
  for (int kp = 0; kp < kBins / 2; ++kp) {
    const float2 w0 = tw_s[(2 * kp * m) & (kFftLen - 1)];
    const float2 w1 = tw_s[((2 * kp + 1) * m) & (kFftLen - 1)];
#pragma unroll
    for (int f = 0; f <= kConvTile; ++f) {
      const float4 u = u_s[f][kp];
      ev[f] += u.x * w0.x + u.y * w0.y;
      od[f] += u.z * w1.x + u.w * w1.y;
    }
  }
#pragma unroll
  for (int f = 1; f <= kConvTile; ++f) {
    const int fr = f0 - 1 + f;
    if (fr >= n_frames) break;
    // head of this frame + tail (samples 256..511) of the frame before
    const float h = (ev[f] + od[f]) + (ev[f - 1] - od[f - 1]);
    float y = h;
    if (kMix) {
      const float dry =
          fr >= d_frames ? frames[(base + fr - d_frames) * kP + m] : 0.f;
      const float2 a = angs[base + fr];
      const float rad = __fmul_rn(
          __fadd_rn(a.x, __fmul_rn(a.y, static_cast<float>(m))), kTwoPi);
      float sn, cs;
      sincosf(rad, &sn, &cs);
      y = __fadd_rn(__fmul_rn(cs, dry), __fmul_rn(sn, h));
    }
    out[(base + fr) * kP + m] = y;
  }
}

}  // namespace

extern "C" int prt_stream_conv(const float* frames, const float* fir,
                               const float* twiddle, const float* angs,
                               float* spec, float* out, int batch,
                               int n_frames, int ns, int d_frames,
                               void* stream) {
  if (batch <= 0 || n_frames <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float2* tw = reinterpret_cast<const float2*>(twiddle);
  float2* sp = reinterpret_cast<float2*>(spec);
  const int tiles1 = (n_frames + kFwdTile - 1) / kFwdTile;
  const int tiles2 = (n_frames + kConvTile - 1) / kConvTile;
  if (static_cast<long long>(tiles2) * batch > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  dft_forward<<<tiles1 * batch, kThreads, 0, st>>>(frames, tw, sp, n_frames,
                                                   tiles1);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid2 = static_cast<unsigned>(tiles2) * batch;
  const float2* f2 = reinterpret_cast<const float2*>(fir);
  if (angs != nullptr) {
    conv_mix<true><<<grid2, kThreads, 0, st>>>(
        frames, f2, tw, reinterpret_cast<const float2*>(angs), sp, out,
        n_frames, ns, d_frames, tiles2);
  } else {
    conv_mix<false><<<grid2, kThreads, 0, st>>>(
        frames, f2, tw, nullptr, sp, out, n_frames, ns, d_frames, tiles2);
  }
  return static_cast<int>(cudaGetLastError());
}
