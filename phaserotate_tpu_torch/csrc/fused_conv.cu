// Single-partition overlap-add Hilbert convolution, with an optional
// rotation mix, for Hopper (sm_90a).
//
// Replaces: phaserotate_tpu/kernels/fused_conv.py _fused_call /
// _make_kernel, the Pallas kernel behind fused_ola_conv / fused_hilbert
// (conv mode: hilbert_fir for every FIR up to 16384 taps, and rotate_fir
// for the FIRs the small stream_conv kernel cannot frame) and
// fused_rotate_fir (mix mode).  Per row and per parsiz-sample block f it
// computes, with N = 2*parsiz and H the FIR's N-point half spectrum,
//
//     y_f = irfft(rfft(pad(block_f, N)) * H)
//     h[f*parsiz + m] = y_f[m] + y_{f-1}[parsiz + m]
//
// and in mix mode out[m] = ca * x[m - lat] + sa * h[m] (zeros before the
// start), with one (ca, sa) pair per row.
//
// What bounds it on the card: the transform.  A direct DFT would cost
// O(parsiz^2) per frame (~1e9 FMA at parsiz 16384), so each frame gets a
// real FFT: about 2 * 5 * M * log2(M) FP32 operations for M = parsiz
// (forward and inverse), some 140 operations per sample at 16384, against
// 24 bytes of HBM traffic per sample over both passes.  Within a block
// every radix-2 stage reads and writes the whole frame in shared memory,
// so bank conflicts cost directly; the layout below has none, and what
// remains largest on an H100 is the pass twiddles' __ldg reads (PERF.md).
//
// What the design does about it:
//   - The N-point real input is zero in its upper half, so its rfft is one
//     M-point complex FFT of z[n] = x[2n] + j*x[2n+1] (half of it zeros)
//     plus an untangling pass; the inverse packs the product spectrum the
//     same way and its M-point complex result, read as floats, is y in
//     natural order.  One frame is M complex values: 128 KiB at parsiz
//     16384, in dynamic shared memory (cudaFuncSetAttribute lifts the
//     48 KiB default).
//   - The forward transform is decimation in frequency (natural order in,
//     bit-reversed order out) and the inverse decimation in time
//     (bit-reversed in, natural out), both in place, so no permutation
//     pass runs: the spectrum product and the untangling index their
//     operands through the bit reversal.  This is the port of the TPU
//     kernel's digit-reversed [k1][k2] layout trick, without its matrices.
//   - Stages run in radix-4 groups (two radix-2 stages per pass, one
//     __syncthreads each), with one radix-2 stage where log2(M) is odd.
//   - Shared memory has 32 four-byte banks, so a half-warp's 16 float2
//     accesses are one wavefront only if they fall in 16 different bank
//     pairs (index mod 16).  The radix-4 passes with quarter spans 1, 2,
//     4 and 8 stride by 4, 8, 16 and 32 elements, and the radix-2 stage
//     by 2, and would collide 2- to 4-fold.  Element i of the frame
//     therefore lives in slot(i) = i ^ (((i >> 4) & 3) * 5): the XOR mask
//     changes with bits 4-5, so the strided runs of a half-warp land on
//     disjoint sets of bank pairs, while wider spans keep a contiguous run
//     under one mask.  Every pass access is one wavefront per half-warp at every
//     supported M.  slot() stays inside each aligned 16-element run, so
//     the frame is still M float2 (no padding) and elements 2n and 2n+1
//     still share one float4, swapped where slot(2n) is odd (pair_order).
//   - The spectrum product walks the pairs (k, M - k) in bit-reversed
//     position order, not in k order: thread k would touch position
//     bitrev(k), and 32 consecutive k are M/32 apart, all in one bank
//     pair.  Item u takes the pair at position u + 2^(b-1), in the lower
//     half of [2^b, 2^(b+1)) (b = msb(u) + 1), and its partner at
//     (u + 2^(b-1)) ^ (2^b - 1), so a warp's two runs are contiguous.
//     The FIR spectrum and the product's twiddles W_N^k arrive permuted
//     into the same order by the wrapper, so the global reads stay
//     coalesced.  No operation of the product changes, only which thread
//     does it.
//   - Twiddles W_N^i = e^{-2*pi*j*i/N}, i < M, are one float32 table
//     computed in float64 on the host and read through __ldg; W_M^i is
//     W_N^{2i}, and the quarter-turn factors are exact swaps.
//   - The TPU carried the overlap-add tail in scratch along a sequential
//     grid axis; blocks here run in no order.  Pass 1 (one block per
//     frame, rows * frames on gridDim.x) writes each frame's head into the
//     output and its tail to a scratch buffer; pass 2, elementwise, adds
//     tail[f-1] and applies the mix, rounding cos*dry + sin*h with
//     __fmul_rn / __fadd_rn as the plain PyTorch version does.
//   - The imaginary parts of the DC and Nyquist bins of the product are
//     dropped, as irfft discards them.  All arithmetic is FP32: no TF32,
//     no fast math.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxLog2M = 14;  // parsiz 16384: 128 KiB of shared memory

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

// The shared-memory slot of frame element i: bits 4-5 pick one of four
// XOR masks of bits 0-3, so the slot stays in i's aligned 16-element run.
__device__ __forceinline__ int slot(int i) {
  return i ^ (((i >> 4) & 3) * 5);
}

// Elements 2n and 2n+1 sit in slots s and s ^ 1 for s = slot(2n): one
// float4, halves swapped where s is odd.  The swap is its own inverse.
__device__ __forceinline__ float4 pair_order(float4 v, int s) {
  return (s & 1) ? make_float4(v.z, v.w, v.x, v.y) : v;
}

// W_M^(j * M / (2h)) for the radix-2 span h: table index j * M / h of W_N.
__device__ __forceinline__ float2 stage_tw(const float2* tw, int j,
                                           int log2m, int log2h) {
  return __ldg(tw + (j << (log2m - log2h)));
}

// Forward (decimation in frequency): spans M/2, M/4, ..., 1.
__device__ void fft_dif(float2* z, const float2* tw, int log2m) {
  const int m = 1 << log2m;
  int log2h = log2m - 1;
  for (; log2h >= 1; log2h -= 2) {  // spans h and h/2 in one pass
    const int h = 1 << log2h, q = h >> 1;
    for (int g = threadIdx.x; g < (m >> 2); g += blockDim.x) {
      const int j = g & (q - 1);
      const int p0 = ((g >> (log2h - 1)) << (log2h + 1)) + j;
      const int p1 = p0 + q, p2 = p0 + h, p3 = p2 + q;
      const float2 a0 = z[slot(p0)], a1 = z[slot(p1)], a2 = z[slot(p2)],
                   a3 = z[slot(p3)];
      const float2 wa = stage_tw(tw, j, log2m, log2h);      // W_2h^j
      const float2 wc = stage_tw(tw, 2 * j, log2m, log2h);  // W_h^j
      const float2 s0 = cadd(a0, a2), d0 = cmul(csub(a0, a2), wa);
      // W_2h^(j + h/2) = -j * W_2h^j
      const float2 s1 = cadd(a1, a3), d1 = cmul(mul_mj(csub(a1, a3)), wa);
      z[slot(p0)] = cadd(s0, s1);
      z[slot(p1)] = cmul(csub(s0, s1), wc);
      z[slot(p2)] = cadd(d0, d1);
      z[slot(p3)] = cmul(csub(d0, d1), wc);
    }
    __syncthreads();
  }
  if (log2h == 0) {  // odd log2(M): the last span-1 stage, twiddle 1
    for (int g = threadIdx.x; g < (m >> 1); g += blockDim.x) {
      const float2 a = z[slot(2 * g)], c = z[slot(2 * g + 1)];
      z[slot(2 * g)] = cadd(a, c);
      z[slot(2 * g + 1)] = csub(a, c);
    }
    __syncthreads();
  }
}

// Inverse, unnormalized (decimation in time): spans 1, 2, ..., M/2.
__device__ void ifft_dit(float2* z, const float2* tw, int log2m) {
  const int m = 1 << log2m;
  int log2h = 1;  // the larger span of the next pass
  if (log2m & 1) {  // odd log2(M): the first span-1 stage alone
    for (int g = threadIdx.x; g < (m >> 1); g += blockDim.x) {
      const float2 a = z[slot(2 * g)], c = z[slot(2 * g + 1)];
      z[slot(2 * g)] = cadd(a, c);
      z[slot(2 * g + 1)] = csub(a, c);
    }
    __syncthreads();
    log2h = 2;
  }
  for (; log2h < log2m; log2h += 2) {  // spans h/2 then h in one pass
    const int h = 1 << log2h, q = h >> 1;
    for (int g = threadIdx.x; g < (m >> 2); g += blockDim.x) {
      const int j = g & (q - 1);
      const int p0 = ((g >> (log2h - 1)) << (log2h + 1)) + j;
      const int p1 = p0 + q, p2 = p0 + h, p3 = p2 + q;
      const float2 a0 = z[slot(p0)], a1 = z[slot(p1)], a2 = z[slot(p2)],
                   a3 = z[slot(p3)];
      const float2 wa = conj(stage_tw(tw, j, log2m, log2h));
      const float2 wc = conj(stage_tw(tw, 2 * j, log2m, log2h));
      const float2 t1 = cmul(a1, wc), t3 = cmul(a3, wc);
      const float2 s0 = cadd(a0, t1), s1 = csub(a0, t1);
      const float2 s2 = cadd(a2, t3), s3 = csub(a2, t3);
      const float2 u = cmul(s2, wa);
      // conj(W_2h^(j + h/2)) = +j * conj(W_2h^j)
      const float2 v = cmul(mul_pj(s3), wa);
      z[slot(p0)] = cadd(s0, u);
      z[slot(p2)] = csub(s0, u);
      z[slot(p1)] = cadd(s1, v);
      z[slot(p3)] = csub(s1, v);
    }
    __syncthreads();
  }
}

// Untangle Z (the M-point FFT of the packed real frame) into X, the
// N-point rfft, multiply by H, and pack the product Y back into the
// M-point spectrum whose inverse is y = irfft(Y) read as complex pairs.
// Pairs (k, M - k), k <= M/2, are handled by one thread, walked in
// bit-reversed position order: item u = 0 is position 0 (k = 0, with
// k = M), item u = M/2 is position 1 (k = M/2), and item u in
// [2^(b-1), 2^b) is the pair at positions u + 2^(b-1), in the lower half
// of [2^b, 2^(b+1)), and (u + 2^(b-1)) ^ (2^b - 1).  Of the two, k sits
// at the even one, since bitrev(p) < M/2 for even p, so every pair runs
// the arithmetic that thread k ran in the k-order walk.  h is H in
// position order (h[p] = H[bitrev(p)], h[M] = H[M]); wp[u] is W_N^k of
// item u.
__device__ void spectrum_product(float2* z, const float2* h,
                                 const float2* wp, int log2m) {
  const int m = 1 << log2m, half = m >> 1;
  const float inv_n = 1.0f / static_cast<float>(2 * m);  // exact
  for (int u = threadIdx.x; u <= half; u += blockDim.x) {
    int pk = 0, pmk = 0;  // u = 0: k = 0
    if (u == half) {
      pk = pmk = 1;  // k = M/2 is its own partner
    } else if (u != 0) {
      const int hb = 1 << (31 - __clz(u)), flip = 2 * hb - 1;
      pk = u + hb;            // the pair's position in the lower half
      if (pk & 1) pk ^= flip;  // k = bitrev(pk) < M/2: the even position
      pmk = pk ^ flip;
    }
    const float2 a = z[slot(pk)], b = conj(z[slot(pmk)]);
    const float2 e = make_float2(0.5f * (a.x + b.x), 0.5f * (a.y + b.y));
    const float2 o = mul_mj(make_float2(0.5f * (a.x - b.x),
                                        0.5f * (a.y - b.y)));
    const float2 w = __ldg(wp + u);  // W_N^k
    const float2 wo = cmul(w, o);
    float2 yk, ymk;
    if (u == 0) {
      // X[0] = E + O and X[M] = E - O are real; irfft drops the
      // imaginary parts of Y[0] and Y[M]
      yk = make_float2((e.x + o.x) * __ldg(h).x, 0.f);
      ymk = make_float2((e.x - o.x) * __ldg(h + m).x, 0.f);
    } else {
      yk = cmul(cadd(e, wo), __ldg(h + pk));             // X[k] H[k]
      ymk = cmul(conj(csub(e, wo)), __ldg(h + pmk));     // X[M-k] H[M-k]
    }
    // W[k] = P + j*T, W[M-k] = conj(P) + j*conj(T) with
    // P = Y[k] + conj(Y[M-k]), T = W_N^-k (Y[k] - conj(Y[M-k]))
    const float2 p = cadd(yk, conj(ymk));
    const float2 t = cmul(conj(w), csub(yk, conj(ymk)));
    const float2 wk = cadd(p, mul_pj(t));
    z[slot(pk)] = make_float2(wk.x * inv_n, wk.y * inv_n);
    if (pmk != pk) {
      const float2 wmk = cadd(conj(p), mul_pj(conj(t)));
      z[slot(pmk)] = make_float2(wmk.x * inv_n, wmk.y * inv_n);
    }
  }
  __syncthreads();
}

// Pass 1: one block per frame.  head (the output buffer) gets y_f[0, P),
// tail gets y_f[P, 2P).
__global__ void __launch_bounds__(1024)
ola_frames(const float* __restrict__ frames, const float2* __restrict__ h,
           const float2* __restrict__ tw, const float2* __restrict__ wp,
           float* __restrict__ head, float* __restrict__ tail, int log2m) {
  extern __shared__ float4 smem4[];
  float2* z = reinterpret_cast<float2*>(smem4);
  const int m = 1 << log2m;     // complex points = parsiz
  const int p4 = m >> 2;        // float4s per frame of parsiz floats
  const long long f = blockIdx.x;
  const float4* src = reinterpret_cast<const float4*>(frames) + f * p4;
  for (int i = threadIdx.x; i < p4; i += blockDim.x) {
    const int s = slot(2 * i);  // z[n] = (x[2n], x[2n+1])
    smem4[s >> 1] = pair_order(__ldg(src + i), s);
    // the zero half: slot() maps it onto itself
    smem4[p4 + i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();
  fft_dif(z, tw, log2m);
  spectrum_product(z, h, wp, log2m);
  ifft_dit(z, tw, log2m);
  float4* dh = reinterpret_cast<float4*>(head) + f * p4;
  float4* dt = reinterpret_cast<float4*>(tail) + f * p4;
  for (int i = threadIdx.x; i < p4; i += blockDim.x) {
    const int s = slot(2 * i), st = slot(2 * (p4 + i));
    dh[i] = pair_order(smem4[s >> 1], s);
    dt[i] = pair_order(smem4[st >> 1], st);
  }
}

// Pass 2: h = head + tail of the frame before; conv mode writes h, mix
// mode ca * x[m - lat] + sa * h.  In place over head.
template <bool kMix>
__global__ void ola_mix(const float* __restrict__ frames,
                        const float* __restrict__ tail,
                        const float2* __restrict__ cs, float* out,
                        int rows, long long row_len, int parsiz, int lat) {
  const long long total = static_cast<long long>(rows) * row_len;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < total; i += step) {
    const long long r = i / row_len, s = i - r * row_len;
    float h = out[i];
    if (s >= parsiz) h = __fadd_rn(h, tail[i - parsiz]);
    if (kMix) {
      const float dry = s >= lat ? frames[i - lat] : 0.f;
      const float2 c = cs[r];
      h = __fadd_rn(__fmul_rn(c.x, dry), __fmul_rn(c.y, h));
    }
    out[i] = h;
  }
}

}  // namespace

extern "C" int prt_fused_conv(const float* frames, const float* spectrum,
                              const float* twiddle,
                              const float* product_twiddle, const float* cs,
                              float* tail, float* out, int rows,
                              int n_blocks, int parsiz, int lat,
                              void* stream) {
  if (rows <= 0 || n_blocks <= 0) return 0;
  int log2m = 0;
  while ((1 << log2m) < parsiz) ++log2m;
  if ((1 << log2m) != parsiz || log2m < 4 || log2m > kMaxLog2M) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n_frames = static_cast<long long>(rows) * n_blocks;
  if (n_frames > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(parsiz) * sizeof(float2);
  cudaError_t err = cudaFuncSetAttribute(
      ola_frames, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int threads = parsiz / 8;
  threads = threads < 256 ? 256 : (threads > 1024 ? 1024 : threads);
  ola_frames<<<static_cast<unsigned>(n_frames), threads, smem, st>>>(
      frames, reinterpret_cast<const float2*>(spectrum),
      reinterpret_cast<const float2*>(twiddle),
      reinterpret_cast<const float2*>(product_twiddle), out, tail, log2m);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long row_len = static_cast<long long>(n_blocks) * parsiz;
  const long long total = rows * row_len;
  long long blocks = (total + 255) / 256;
  if (blocks > 132LL * 64) blocks = 132LL * 64;  // grid-stride beyond
  if (cs != nullptr) {
    ola_mix<true><<<static_cast<unsigned>(blocks), 256, 0, st>>>(
        frames, tail, reinterpret_cast<const float2*>(cs), out, rows,
        row_len, parsiz, lat);
  } else {
    ola_mix<false><<<static_cast<unsigned>(blocks), 256, 0, st>>>(
        frames, tail, nullptr, out, rows, row_len, parsiz, lat);
  }
  return static_cast<int>(cudaGetLastError());
}
