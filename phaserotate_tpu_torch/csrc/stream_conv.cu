// Partitioned FFT Hilbert convolution, with an optional rotation mix, for
// Hopper (sm_90a).
//
// Replaces: phaserotate_tpu/kernels/stream_conv.py _call / _make_kernel, the
// Pallas kernel behind fused_hilbert_small (conv-only mode: the Hilbert
// half of every analyzer sweep and apply) and fused_rotate_small /
// fused_stream_mix (mix mode: the FIR rotate and the streaming ramp).  It
// computes the linear convolution h = fir * x with the fir_taps-tap Hilbert
// FIR through a fixed 256-sample frame:
//   - pass 1 (fft_forward): the half spectrum X[0..256] of each frame, zero
//     padded to N = 512 points, as one M = 256-point complex FFT of the
//     packed frame z[n] = x[2n] + j*x[2n+1] plus an untangling step;
//   - pass 2 (conv_mix): the frequency-delay-line multiply-accumulate
//     U_f = sum_s X_{f-s} F_s over the ns = fir_taps / 256 partition
//     spectra F_s, U_f packed into the M-point spectrum whose inverse FFT,
//     read as floats, is y_f = irfft(U_f), and a one-frame overlap-add:
//     h over frame f is y_f[0, 256) + y_{f-1}[256, 512);
//   - mix mode: out[m] = cos(rad_m) * x[m - D*256] + sin(rad_m) * h[m] with
//     rad_m = 2*pi*(angle + slope*i) from per-frame (angle, slope) pairs.
//
// Why the TPU's design was dropped: the TPU kernel multiplies every frame
// by dense DFT matrices (_dft_consts) on its matrix unit.  Here that
// product runs on CUDA cores (TF32 would break the 1e-5 budget): some
// 264 k multiply-adds per frame, ~1,030 per sample.  The FFT does each
// direction in ~14 k FP32 operations per frame, ~19x less.
//
// What bounds it on the card: device memory, then the MAC.  Pass 1 reads
// 1 KiB of input and writes a 2,064-byte spectrum row per frame and runs
// near the rate of device memory.  Pass 2 reads the rows back (from L2
// where a neighbouring tile loaded them), writes 1 KiB of output and, in
// mix mode, reads the input again for the dry signal; its MAC issues 4
// FP32 FMA per bin, partition and frame and is the larger part of the
// pass already at 12 partitions (PERF.md).  Per frame the whole kernel
// needs some 20 k operations for the transforms and 2 k per partition for
// the MAC, against 3 KiB of traffic in pass 1 and 3-4 KiB in pass 2.
//
// What the design does about it:
//   - The transforms are csrc/fused_conv.cu's at M = 256 as a compile-time
//     constant: forward decimation in frequency (natural order in,
//     bit-reversed out), inverse decimation in time (bit-reversed in,
//     natural out), four radix-4 passes each, in place in shared memory,
//     element i of a frame in slot(i) so that every pass access is one
//     wavefront per half-warp.  The upper half of a packed frame is zero,
//     so the first forward pass reads its two live inputs straight from
//     device memory.
//   - Spectrum rows are kept in bit-reversed position order: entry p < 256
//     holds bin bitrev(p), entry 256 the Nyquist bin and entry 257 is an
//     unused pad (rows stay 16-byte aligned).  The wrapper permutes the
//     FIR partitions into the same order.  The MAC is per bin, so nothing
//     of its arithmetic changes; the order lets one thread own a pair of
//     bins (k, M - k) at positions (pk, pmk) from the untangling to the
//     packing (fused_conv's position walk), with conflict-free shared
//     memory and contiguous runs in device memory.
//   - Thread roles, 288 threads (9 warps): in the FFT passes threads < 256
//     are 4 groups of M/4 = 64 butterflies, group g taking frames g, g+4,
//     ...; in the pair work threads < 256 take item u = t % 128 of the
//     frames of half t / 128, and warp 8's lanes 0 and 16 take item 128
//     (k = M/2).  A thread keeps its butterfly or pair across frames, so
//     it reads its twiddles once per pass.  They come from one 512-entry
//     (cos, sin)(2*pi*i/512) table staged in shared memory: W_512^i is its
//     conjugate and W_256^i = W_512^(2i).
//   - Blocks run in no order, so the TPU's sequential carry of spectrum
//     history and overlap-add tail is split in two passes.  Pass 1 writes
//     every frame's spectrum row.  Pass 2 takes 16 output frames per block
//     and recomputes the frame before them for its tail: 17 frames of
//     2 KiB in shared memory.  Each thread sums 9 consecutive frames of its
//     pair over the partitions, bin k and then bin M - k (U[k] waits in
//     shared memory), from a ring of registers: a step s loads one new
//     spectrum entry, not one per frame, one step before it is needed, and
//     the sums are explicit fmaf chains, 4 FMA per complex multiply-add.
//     One bin at a time keeps the MAC in 72 registers, so three blocks
//     fit on an SM; both bins at once needed 96 and spilled in mix mode.
//   - Resources (ptxas, sm_90a): fft_forward 32 registers and 36,864 bytes
//     of shared memory, six blocks per SM; conv_mix 70 (conv) or 72 (mix)
//     registers and 38,912 or 39,168 bytes, three blocks per SM, no
//     spills.  In mix mode the output loads its dry samples before the
//     inverse FFT, and takes one sincosf per frame where the angle's slope
//     is 0 (then every sample's angle is the same float).
//   - The imaginary parts of the DC and Nyquist bins are exact zeros from
//     pass 1 and dropped before the inverse, as irfft drops them.
//   - Mix mode rounds cos*dry + sin*h with __fmul_rn / __fadd_rn like the
//     plain PyTorch version; sincosf is full precision (no fast math).  All
//     arithmetic is FP32 on CUDA cores: nothing at TF32.
//   - Rows times frame tiles ride gridDim.x, so any number of rows fits
//     one launch.

#include <cuda_runtime.h>

namespace {

constexpr int kP = 256;            // samples per frame; M, the FFT points
constexpr int kLog2M = 8;
constexpr int kFftLen = 2 * kP;    // N, the zero-padded real transform
constexpr int kBins = kP + 2;      // spectrum row: positions, Nyquist, pad
constexpr int kPairs = kP / 2;     // pair items u < 128; item 128 is k = M/2
constexpr int kThreads = 288;      // 9 warps
constexpr int kFftThreads = 256;   // 4 groups of M/4 = 64 butterflies
constexpr int kGroups = kFftThreads / (kP / 4);
constexpr int kFwdTile = 16;       // frames per block, pass 1
constexpr int kConvTile = 16;      // output frames per block, pass 2
constexpr int kConvFrames = kConvTile + 1;    // and the frame before them
constexpr int kFwdHalf = kFwdTile / 2;        // frames per pair thread
constexpr int kConvHalf = (kConvFrames + 1) / 2;
constexpr int kAhead = 1;         // MAC steps a spectrum load runs ahead
constexpr float kTwoPi = 6.28318530717958647692f;

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 conj(float2 a) {
  return make_float2(a.x, -a.y);
}
// a * (-j)
__device__ __forceinline__ float2 mul_mj(float2 a) {
  return make_float2(a.y, -a.x);
}
// a * (+j)
__device__ __forceinline__ float2 mul_pj(float2 a) {
  return make_float2(-a.y, a.x);
}
// acc + a * b as four fused multiply-adds
__device__ __forceinline__ float2 cmac(float2 acc, float2 a, float2 b) {
  acc.x = fmaf(a.x, b.x, acc.x);
  acc.x = fmaf(-a.y, b.y, acc.x);
  acc.y = fmaf(a.x, b.y, acc.y);
  acc.y = fmaf(a.y, b.x, acc.y);
  return acc;
}
__device__ __forceinline__ float2 scale(float2 a, float c) {
  return make_float2(a.x * c, a.y * c);
}

// The shared-memory slot of frame element i: bits 4-5 pick one of four
// XOR masks of bits 0-3, so the slot stays in i's aligned 16-element run.
__device__ __forceinline__ int slot(int i) {
  return i ^ (((i >> 4) & 3) * 5);
}

__device__ __forceinline__ int bitrev8(int p) {
  return static_cast<int>(__brev(static_cast<unsigned>(p)) >> 24);
}

// W_512^i = e^{-2*pi*j*i/512} from the (cos, sin)(2*pi*i/512) table
__device__ __forceinline__ float2 w512(const float2* tw_s, int i) {
  return conj(tw_s[i]);
}

__device__ __forceinline__ void load_twiddles(float2* tw_s,
                                              const float2* twiddle) {
  for (int i = threadIdx.x; i < kFftLen; i += kThreads) tw_s[i] = twiddle[i];
}

// The pair walk of fused_conv.cu spectrum_product at M = 256.  Item u in
// [2^(b-1), 2^b) holds the positions u + 2^(b-1) and (u + 2^(b-1)) ^
// (2^b - 1); pk, the even one, holds X[k] with k = bitrev(pk) < M/2, and
// pmk holds X[M - k].  Item 0 is k = 0 (X[M] sits in row entry kP) and
// item kPairs is k = M/2 alone at position 1.
__device__ __forceinline__ void pair_positions(int u, int& pk, int& pmk) {
  if (u == 0 || u == kPairs) {
    pk = pmk = u == 0 ? 0 : 1;
    return;
  }
  const int hb = 1 << (31 - __clz(u)), flip = 2 * hb - 1;
  pk = u + hb;
  if (pk & 1) pk ^= flip;
  pmk = pk ^ flip;
}

// The pair item and first frame of thread t in the pair work: threads
// < 256 take item t % 128 of half t / 128; warp 8's lanes 0 and 16 (one
// per half-warp, so their accesses to position 1 do not collide) take
// item 128.  Returns false for the idle lanes.
__device__ __forceinline__ bool pair_role(int t, int half_len, int& u,
                                          int& fb) {
  if (t < 2 * kPairs) {
    u = t & (kPairs - 1);
    fb = (t >> 7) * half_len;
    return true;
  }
  u = kPairs;
  fb = ((t - 2 * kPairs) >> 4) * half_len;
  return ((t - 2 * kPairs) & 15) == 0;
}

// Forward passes 2-4 (larger spans 32, 8, 2) over kFrames frames.
template <int kFrames>
__device__ void dif_passes(float2 (*z)[kP], const float2* tw_s) {
  const int t = threadIdx.x, g = t & (kP / 4 - 1);
  for (int log2h = kLog2M - 3; log2h >= 1; log2h -= 2) {
    if (t < kFftThreads) {
      const int q = 1 << (log2h - 1), h = 2 * q;
      const int j = g & (q - 1);
      const int p0 = ((g >> (log2h - 1)) << (log2h + 1)) + j;
      const int s0 = slot(p0), s1 = slot(p0 + q), s2 = slot(p0 + h),
                s3 = slot(p0 + h + q);
      const float2 wa = w512(tw_s, j << (kLog2M - log2h));        // W_2h^j
      const float2 wc = w512(tw_s, (2 * j) << (kLog2M - log2h));  // W_h^j
#pragma unroll
      for (int f = t / (kP / 4); f < kFrames; f += kGroups) {
        float2* zf = z[f];
        const float2 a0 = zf[s0], a1 = zf[s1], a2 = zf[s2], a3 = zf[s3];
        const float2 x0 = cadd(a0, a2), d0 = cmul(csub(a0, a2), wa);
        // W_2h^(j + h/2) = -j * W_2h^j
        const float2 x1 = cadd(a1, a3), d1 = cmul(mul_mj(csub(a1, a3)), wa);
        zf[s0] = cadd(x0, x1);
        zf[s1] = cmul(csub(x0, x1), wc);
        zf[s2] = cadd(d0, d1);
        zf[s3] = cmul(csub(d0, d1), wc);
      }
    }
    __syncthreads();
  }
}

// Inverse, unnormalized: spans 1, 2, ..., 128 in four radix-4 passes.
template <int kFrames>
__device__ void dit_passes(float2 (*z)[kP], const float2* tw_s) {
  const int t = threadIdx.x, g = t & (kP / 4 - 1);
  for (int log2h = 1; log2h < kLog2M; log2h += 2) {
    if (t < kFftThreads) {
      const int q = 1 << (log2h - 1), h = 2 * q;
      const int j = g & (q - 1);
      const int p0 = ((g >> (log2h - 1)) << (log2h + 1)) + j;
      const int s0 = slot(p0), s1 = slot(p0 + q), s2 = slot(p0 + h),
                s3 = slot(p0 + h + q);
      const float2 wa = tw_s[j << (kLog2M - log2h)];        // conj(W_2h^j)
      const float2 wc = tw_s[(2 * j) << (kLog2M - log2h)];  // conj(W_h^j)
#pragma unroll
      for (int f = t / (kP / 4); f < kFrames; f += kGroups) {
        float2* zf = z[f];
        const float2 a0 = zf[s0], a1 = zf[s1], a2 = zf[s2], a3 = zf[s3];
        const float2 t1 = cmul(a1, wc), t3 = cmul(a3, wc);
        const float2 x0 = cadd(a0, t1), x1 = csub(a0, t1);
        const float2 x2 = cadd(a2, t3), x3 = csub(a2, t3);
        const float2 u = cmul(x2, wa);
        // conj(W_2h^(j + h/2)) = +j * conj(W_2h^j)
        const float2 v = cmul(mul_pj(x3), wa);
        zf[s0] = cadd(x0, u);
        zf[s2] = csub(x0, u);
        zf[s1] = cadd(x1, v);
        zf[s3] = csub(x1, v);
      }
    }
    __syncthreads();
  }
}

// Pass 1: spec[b, f] = X[0..256] of frame f in position order.
__global__ void __launch_bounds__(kThreads)
fft_forward(const float* __restrict__ frames,
            const float2* __restrict__ twiddle, float2* __restrict__ spec,
            int n_frames, int tiles) {
  __shared__ float2 z[kFwdTile][kP];
  __shared__ float2 tw_s[kFftLen];
  const int t = threadIdx.x;
  const int b = blockIdx.x / tiles;
  const int f0 = (blockIdx.x % tiles) * kFwdTile;
  const long long base = static_cast<long long>(b) * n_frames;
  load_twiddles(tw_s, twiddle);
  __syncthreads();

  // pass 1 of the DIF (span 128): z[n] = (x[2n], x[2n+1]) for n < 128 and
  // zero above, so butterfly j reads a0 = z[j] and a1 = z[j + 64] from
  // device memory and a2 = a3 = 0
  if (t < kFftThreads) {
    const int j = t & (kP / 4 - 1);
    const float2 wa = w512(tw_s, 2 * j), wc = w512(tw_s, 4 * j);
    const float2* src = reinterpret_cast<const float2*>(frames);
#pragma unroll
    for (int f = t / (kP / 4); f < kFwdTile; f += kGroups) {
      float2 a0 = make_float2(0.f, 0.f), a1 = a0;
      if (f0 + f < n_frames) {
        const float2* row = src + (base + f0 + f) * (kP / 2);
        a0 = row[j];
        a1 = row[j + kP / 4];
      }
      const float2 d0 = cmul(a0, wa), d1 = cmul(mul_mj(a1), wa);
      z[f][slot(j)] = cadd(a0, a1);
      z[f][slot(j + kP / 4)] = cmul(csub(a0, a1), wc);
      z[f][slot(j + kP / 2)] = cadd(d0, d1);
      z[f][slot(j + 3 * kP / 4)] = cmul(csub(d0, d1), wc);
    }
  }
  __syncthreads();
  dif_passes<kFwdTile>(z, tw_s);

  // untangle Z into X: X[k] = E + W_N^k O, X[M-k] = conj(E - W_N^k O) with
  // E = (Z[k] + conj(Z[M-k])) / 2, O = -j (Z[k] - conj(Z[M-k])) / 2
  int u, fb;
  if (!pair_role(t, kFwdHalf, u, fb)) return;
  int pk, pmk;
  pair_positions(u, pk, pmk);
  const float2 w = w512(tw_s, bitrev8(pk));
#pragma unroll
  for (int i = 0; i < kFwdHalf; ++i) {
    const int f = fb + i;
    if (f0 + f >= n_frames) break;
    // items 0 and 128 hold one position: no second load, whose bank
    // pair item 13's partner uses
    const float2 a = z[f][slot(pk)];
    float2 c = a;
    if (pmk != pk) c = z[f][slot(pmk)];
    c = conj(c);
    const float2 e = make_float2(0.5f * (a.x + c.x), 0.5f * (a.y + c.y));
    const float2 o = mul_mj(make_float2(0.5f * (a.x - c.x),
                                        0.5f * (a.y - c.y)));
    float2* row = spec + (base + f0 + f) * kBins;
    if (u == 0) {  // X[0] = E + O and X[M] = E - O are real
      row[0] = make_float2(e.x + o.x, 0.f);
      row[kP] = make_float2(e.x - o.x, 0.f);
    } else {
      const float2 wo = cmul(w, o);
      row[pk] = cadd(e, wo);
      if (pmk != pk) row[pmk] = conj(csub(e, wo));
    }
  }
}

// Pass 2: frequency-delay-line MAC, packing, inverse FFT, overlap-add,
// optional mix.
template <bool kMix>
__global__ void __launch_bounds__(kThreads, 3)
conv_mix(const float* __restrict__ frames, const float2* __restrict__ fir,
         const float2* __restrict__ twiddle, const float2* __restrict__ angs,
         const float2* __restrict__ spec, float* __restrict__ out,
         int n_frames, int ns, int d_frames, int tiles) {
  // z[f] is frame f0 - 1 + f: its packed product spectrum, then y
  __shared__ float2 z[kConvFrames][kP];
  __shared__ float2 tw_s[kFftLen];
  __shared__ float2 ang_s[kConvTile];  // mix: (angle, slope) of frame f0 + f
  __shared__ float2 sc_s[kConvTile];   // mix: (sin, cos) where the slope is 0
  const int t = threadIdx.x;
  const int b = blockIdx.x / tiles;
  const int f0 = (blockIdx.x % tiles) * kConvTile;
  const long long base = static_cast<long long>(b) * n_frames;
  load_twiddles(tw_s, twiddle);
  if (kMix && t < kConvTile) {
    const float2 a =
        f0 + t < n_frames ? angs[base + f0 + t] : make_float2(0.f, 0.f);
    ang_s[t] = a;
    if (a.y == 0.f) {  // rad_m below is the same float for every m
      float sn, cs;
      sincosf(__fmul_rn(__fadd_rn(a.x, __fmul_rn(a.y, 0.f)), kTwoPi), &sn,
              &cs);
      sc_s[t] = make_float2(sn, cs);
    }
  }
  __syncthreads();

  int u, fb;
  if (pair_role(t, kConvHalf, u, fb)) {
    int pk, pmk;
    pair_positions(u, pk, pmk);
    const int qmk = u == 0 ? kP : pmk;  // row entry of X[M - k]
    const int fr0 = f0 - 1 + fb;        // the frame of sum i is fr0 + i
    const float2 wn = tw_s[bitrev8(pk)];  // W_N^-k
    const float inv_n = 1.0f / static_cast<float>(kFftLen);  // exact
    constexpr int K = kConvHalf, R = K + kAhead;
    // bin k, then bin M - k: U[k] waits in z[f][slot(pk)] for its partner
    for (int bin = 0; bin < 2; ++bin) {
      const int q = bin == 0 ? pk : qmk;
      // Step s adds frame fr0 + i - s times F_s into sum i, i < K.  Frame
      // F lives in ring slot (F - fr0) mod R, R = K + kAhead: step s loads
      // the frame that step s + kAhead first needs into the slot of the
      // frame that has just left the window, so each load has kAhead steps
      // to arrive.  The steps run in unrolled blocks of R, so every slot
      // index is a constant and no register moves.
      float2 x[R], y[K];
#pragma unroll
      for (int i = 1 - kAhead; i < K; ++i) {
        const int src = fr0 + i, r = (i + R) % R;
        x[r] = src >= 0 && src < n_frames ? spec[(base + src) * kBins + q]
                                          : make_float2(0.f, 0.f);
      }
#pragma unroll
      for (int i = 0; i < K; ++i) y[i] = make_float2(0.f, 0.f);
      for (int s0 = 0; s0 < ns; s0 += R) {
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int s = s0 + j;
          if (s < ns) {
            const int src = fr0 - s - kAhead, r = (R - (j + kAhead) % R) % R;
            x[r] = s + kAhead < ns && src >= 0 && src < n_frames
                       ? spec[(base + src) * kBins + q]
                       : make_float2(0.f, 0.f);
            const float2 g = fir[s * kBins + q];
#pragma unroll
            for (int i = 0; i < K; ++i) {
              y[i] = cmac(y[i], x[(i - j + R) % R], g);
            }
          }
        }
      }
      // pack Y = U / N into the M-point spectrum W of the inverse:
      // W[k] = P + j*T, W[M-k] = conj(P) + j*conj(T) with
      // P = Y[k] + conj(Y[M-k]), T = W_N^-k (Y[k] - conj(Y[M-k]))
#pragma unroll
      for (int i = 0; i < K; ++i) {
        const int f = fb + i;
        if (f >= kConvFrames) break;
        if (bin == 0) {
          z[f][slot(pk)] = y[i];
          continue;
        }
        float2 a = z[f][slot(pk)], c = y[i];
        if (u == 0) a.y = c.y = 0.f;  // irfft drops Im U[0] and Im U[M]
        const float2 p = cadd(a, conj(c));
        const float2 t2 = cmul(wn, csub(a, conj(c)));
        z[f][slot(pk)] = scale(cadd(p, mul_pj(t2)), inv_n);
        if (pmk != pk) {
          z[f][slot(pmk)] = scale(cadd(conj(p), mul_pj(conj(t2))), inv_n);
        }
      }
    }
  }
  // mix: the dry samples of the tile, loaded while the inverse runs
  float dry[kConvTile];
  if (kMix && t < kP) {
#pragma unroll
    for (int f = 0; f < kConvTile; ++f) {
      const int fr = f0 + f;
      dry[f] = 0.f;
      if (fr < n_frames && fr >= d_frames) {
        dry[f] = frames[(base + fr - d_frames) * kP + t];
      }
    }
  }
  __syncthreads();
  dit_passes<kConvFrames>(z, tw_s);

  if (t >= kP) return;
  const int m = t;  // output sample of the frame
  const float* zf = reinterpret_cast<const float*>(&z[0][0]);
  const int head = 2 * slot(m >> 1) + (m & 1);           // y[m]
  const int tail = 2 * slot(kP / 2 + (m >> 1)) + (m & 1);  // y[256 + m]
#pragma unroll
  for (int f = 0; f < kConvTile; ++f) {
    const int fr = f0 + f;
    if (fr >= n_frames) break;
    // head of this frame + tail of the frame before
    const float h = zf[(f + 1) * 2 * kP + head] + zf[f * 2 * kP + tail];
    float y = h;
    if (kMix) {
      const float2 a = ang_s[f];
      float sn, cs;
      if (a.y == 0.f) {
        sn = sc_s[f].x;
        cs = sc_s[f].y;
      } else {
        const float rad = __fmul_rn(
            __fadd_rn(a.x, __fmul_rn(a.y, static_cast<float>(m))), kTwoPi);
        sincosf(rad, &sn, &cs);
      }
      y = __fadd_rn(__fmul_rn(cs, dry[f]), __fmul_rn(sn, h));
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
  if (static_cast<long long>(tiles1 > tiles2 ? tiles1 : tiles2) * batch >
      0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  fft_forward<<<tiles1 * batch, kThreads, 0, st>>>(frames, tw, sp, n_frames,
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
