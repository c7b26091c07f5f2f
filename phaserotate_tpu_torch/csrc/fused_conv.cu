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
// the 8 bytes of HBM traffic per sample the function needs (read x, write
// h).  Within a block every radix-2 stage reads and writes the whole frame
// in shared memory, so bank conflicts and the pass twiddles' reads cost
// directly; the layout below has no bank conflict, and the twiddles are
// read as one contiguous float4 per butterfly from a table in shared
// memory.
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
//   - The pass twiddles are stage-major: for each radix-4 pass of span h
//     (h = M/2, M/8, ..., the forward pass order), the float4
//     {W_2h^j, W_h^j} for j < h/2, the pass of span h from entry
//     (M - 2h)/3, (M - 1)/3 entries in all (87,376 bytes at parsiz 16384).
//     W_N^i = e^{-2*pi*j*i/N} are computed in float64 on the host and
//     copied into the table as float32 by the wrapper; the inverse reads
//     the same entries conjugated, and the quarter-turn factors are exact
//     swaps.  Butterfly g of a pass reads entry j = g mod h/2, so a warp
//     reads 32 consecutive float4 (or fewer, repeated): one request of 512
//     contiguous bytes.  A strided read of a natural-order table would
//     touch up to 32 lines per request.  Each block copies the table into
//     shared memory once, after its frame; every read is then one
//     wavefront per quarter-warp.
//   - The TPU carried the overlap-add tail in scratch along a sequential
//     grid axis; here a persistent grid (as many blocks as fit on the
//     card at once) gives each block one contiguous run of frames in
//     flattened (row, frame) order, which it transforms one after the
//     other.  In the copy-out, the thread that writes float4 i of a frame's
//     head adds float4 i of the previous frame's tail, which it holds in
//     registers (the carry, p4 / blockDim float4 a thread), so h leaves
//     the block finished.  A row's first frame has no tail before it, and
//     a row's last tail is dropped.  Only the first frame of a run lacks
//     the tail of the run before it: each block writes its last tail to a
//     small scratch (one frame per block), and a second kernel adds it to
//     those frames alone.  The mix, cos*dry + sin*h with __fmul_rn /
//     __fadd_rn as the plain PyTorch version rounds it, is applied where
//     h is finished: in the copy-out, or in that second kernel.
//   - The imaginary parts of the DC and Nyquist bins of the product are
//     dropped, as irfft discards them.  All arithmetic is FP32: no TF32,
//     no fast math.

#include <cuda_runtime.h>

#include "ola_fft.cuh"

namespace {

constexpr int kMinLog2M = 11;  // parsiz 2048
constexpr int kMaxLog2M = 14;  // parsiz 16384: 128 KiB of shared memory

// The spectrum product of one frame (product_item): the M/2 + 1 items,
// one a thread in turn.
__device__ void spectrum_product(float2* z, const float2* h,
                                 const float2* wp, int log2m) {
  const int m = 1 << log2m;
  for (int u = threadIdx.x; u <= (m >> 1); u += blockDim.x) {
    product_item(z, h, wp, m, u, 0);
  }
  __syncthreads();
}

// ca * dry + sa * h, each product and the sum rounded on its own
__device__ __forceinline__ float mix1(float2 c, float dry, float h) {
  return __fadd_rn(__fmul_rn(c.x, dry), __fmul_rn(c.y, h));
}

__device__ __forceinline__ float4 mix4(float2 c, float4 dry, float4 h) {
  return make_float4(mix1(c, dry.x, h.x), mix1(c, dry.y, h.y),
                     mix1(c, dry.z, h.z), mix1(c, dry.w, h.w));
}

// The overlap-add over one contiguous run of frames per block; frame f
// is row f / n_blocks, block f % n_blocks of its row.  Each thread owns
// float4 i = threadIdx.x + k * blockDim.x, k < kCarry, of every frame's
// head and tail (blockDim * kCarry = parsiz / 4), in the copy-in and in
// the copy-out alike, so the copy-in of the next frame overwrites only
// the slots this thread has just read and needs no barrier.  The last
// tail of a run whose next frame is not a row's first goes to
// run_tails[blockIdx.x]; that frame's head leaves unfinished, for
// ola_fixup.
template <int kCarry, bool kMix>
__global__ void __launch_bounds__(1024)
ola_runs(const float* __restrict__ frames, const float2* __restrict__ h,
         const float4* __restrict__ twiddles, const float2* __restrict__ wp,
         const float2* __restrict__ cs, float* __restrict__ run_tails,
         float* __restrict__ out, long long n_frames, int n_blocks,
         int lat, int log2m) {
  extern __shared__ float4 smem4[];
  float2* z = reinterpret_cast<float2*>(smem4);
  const int m = 1 << log2m;     // complex points = parsiz
  const int p4 = m >> 2;        // float4s per frame of parsiz floats
  float4* tws = smem4 + (m >> 1);  // the twiddle table after the frame
  for (int i = threadIdx.x; i < table_len(m); i += blockDim.x) {
    tws[i] = __ldg(twiddles + i);
  }
  const long long f0 = run_start(blockIdx.x, n_frames, gridDim.x);
  const long long f1 = run_start(blockIdx.x + 1, n_frames, gridDim.x);
  const float4* src = reinterpret_cast<const float4*>(frames);
  float4* dst = reinterpret_cast<float4*>(out);
  float4 carry[kCarry];
  for (long long f = f0; f < f1; ++f) {
    const long long row = f / n_blocks;
    const long long s0 = (f - row * n_blocks) * m;  // sample in the row
#pragma unroll
    for (int k = 0; k < kCarry; ++k) {
      const int i = threadIdx.x + k * blockDim.x;
      const int s = slot(2 * i), st = slot(2 * (p4 + i));
      // z[n] = (x[2n], x[2n+1]), and the zero half in the slots of the tail
      smem4[s >> 1] = pair_order(__ldg(src + f * p4 + i), s);
      smem4[st >> 1] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();
    fft_dif(z, tws, log2m);
    spectrum_product(z, h, wp, log2m);
    ifft_dit(z, tws, log2m);
    const bool has_carry = f != f0 && s0 != 0;
    const bool done = has_carry || s0 == 0;  // else ola_fixup finishes it
    const float2 c = kMix ? cs[row] : make_float2(0.f, 0.f);
#pragma unroll
    for (int k = 0; k < kCarry; ++k) {
      const int i = threadIdx.x + k * blockDim.x;
      const int s = slot(2 * i), st = slot(2 * (p4 + i));
      float4 v = pair_order(smem4[s >> 1], s);
      if (has_carry) v = add4(v, carry[k]);
      if (kMix && done) {
        // dry = x[s - lat], zeros before the row's start (lat % 4 == 0)
        const float4 dry = s0 + 4 * i >= lat
                               ? __ldg(src + f * p4 + i - (lat >> 2))
                               : make_float4(0.f, 0.f, 0.f, 0.f);
        v = mix4(c, dry, v);
      }
      dst[f * p4 + i] = v;
      carry[k] = pair_order(smem4[st >> 1], st);
    }
  }
  if (f1 < n_frames && f1 % n_blocks != 0) {
    float4* keep = reinterpret_cast<float4*>(run_tails) +
                   static_cast<long long>(blockIdx.x) * p4;
#pragma unroll
    for (int k = 0; k < kCarry; ++k) {
      keep[threadIdx.x + k * blockDim.x] = carry[k];
    }
  }
}

// The first frame of run b = blockIdx.x + 1, where it is not a row's
// first: h = head + the tail of run b - 1's last frame, then the mix.
template <bool kMix>
__global__ void ola_fixup(const float* __restrict__ frames,
                          const float* __restrict__ run_tails,
                          const float2* __restrict__ cs, float* out,
                          long long n_frames, int n_blocks, int parsiz,
                          int lat) {
  const long long f = run_start(blockIdx.x + 1, n_frames, gridDim.x + 1);
  if (f % n_blocks == 0) return;
  const float* tail = run_tails + static_cast<long long>(blockIdx.x) * parsiz;
  for (int m = threadIdx.x; m < parsiz; m += blockDim.x) {
    const long long i = f * parsiz + m;
    float v = __fadd_rn(out[i], tail[m]);
    if (kMix) v = mix1(cs[f / n_blocks], frames[i - lat], v);  // lat < parsiz
    out[i] = v;
  }
}

using RunKernel = void (*)(const float*, const float2*, const float4*,
                           const float2*, const float2*, float*, float*,
                           long long, int, int, int);

int log2_supported(int parsiz) {
  int log2m = 0;
  while ((1 << log2m) < parsiz) ++log2m;
  if ((1 << log2m) != parsiz || log2m < kMinLog2M || log2m > kMaxLog2M) {
    return -1;
  }
  return log2m;
}

// Threads per block: parsiz / 8 within [256, 1024], so parsiz / 4 float4
// are 2 a thread below 16384 and 4 at 16384.
int block_threads(int parsiz) {
  const int t = parsiz / 8;
  return t < 256 ? 256 : (t > 1024 ? 1024 : t);
}

// The run kernel of one parsiz and mode, with its shared memory (frame
// and twiddle table) allowed.
cudaError_t run_kernel(int log2m, bool mix, RunKernel* fn, size_t* smem) {
  const int m = 1 << log2m;
  const bool wide = m / 4 / block_threads(m) == 4;
  *fn = mix ? (wide ? ola_runs<4, true> : ola_runs<2, true>)
            : (wide ? ola_runs<4, false> : ola_runs<2, false>);
  *smem = static_cast<size_t>(m) * sizeof(float2) +
          static_cast<size_t>(table_len(m)) * sizeof(float4);
  return cudaFuncSetAttribute(*fn,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*smem));
}

}  // namespace

// The run kernel's launch geometry on the current device for ``parsiz``
// and mode: info = {blocks resident on the whole card at once (the grid
// of a persistent launch), threads per block, registers per thread,
// local memory bytes per thread (spills)}.
extern "C" int prt_fused_conv_grid(int parsiz, int mix, int* info) {
  const int log2m = log2_supported(parsiz);
  if (log2m < 0) return static_cast<int>(cudaErrorInvalidValue);
  RunKernel fn;
  size_t smem;
  cudaError_t err = run_kernel(log2m, mix != 0, &fn, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = block_threads(parsiz);
  int per_sm = 0, device = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads,
                                                      smem);
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  info[0] = per_sm * sms;
  info[1] = threads;
  info[2] = attr.numRegs;
  info[3] = static_cast<int>(attr.localSizeBytes);
  return 0;
}

// frames (rows, n_blocks, parsiz); spectrum and product_twiddle in the
// product's position order; twiddles the stage-major table; cs (rows, 2)
// (ca, sa) or NULL for conv mode; run_tails (grid - 1, parsiz) scratch;
// out (rows, n_blocks * parsiz); grid in [1, rows * n_blocks] blocks, each
// one run of frames (the card's resident blocks for speed: any grid gives
// the same output).
extern "C" int prt_fused_conv(const float* frames, const float* spectrum,
                              const float* twiddles,
                              const float* product_twiddle, const float* cs,
                              float* run_tails, float* out, int rows,
                              int n_blocks, int parsiz, int lat, int grid,
                              void* stream) {
  if (rows <= 0 || n_blocks <= 0) return 0;
  const int log2m = log2_supported(parsiz);
  const long long n_frames = static_cast<long long>(rows) * n_blocks;
  if (log2m < 0 || n_frames > 0x7fffffffLL || grid < 1 || grid > n_frames ||
      lat < 0 || lat >= parsiz || (lat & 3) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool mix = cs != nullptr;
  RunKernel fn;
  size_t smem;
  cudaError_t err = run_kernel(log2m, mix, &fn, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float2* cs2 = reinterpret_cast<const float2*>(cs);
  fn<<<grid, block_threads(parsiz), smem, st>>>(
      frames, reinterpret_cast<const float2*>(spectrum),
      reinterpret_cast<const float4*>(twiddles),
      reinterpret_cast<const float2*>(product_twiddle), cs2, run_tails, out,
      n_frames, n_blocks, lat, log2m);
  err = cudaGetLastError();
  if (err != cudaSuccess || grid == 1) return static_cast<int>(err);
  if (mix) {
    ola_fixup<true><<<grid - 1, 256, 0, st>>>(frames, run_tails, cs2, out,
                                              n_frames, n_blocks, parsiz, lat);
  } else {
    ola_fixup<false><<<grid - 1, 256, 0, st>>>(frames, run_tails, nullptr, out,
                                               n_frames, n_blocks, parsiz, 0);
  }
  return static_cast<int>(cudaGetLastError());
}
