// The offline Hilbert signal at the CLI's largest geometry, blksiz 32768
// (176.4 and 192 kHz), for Hopper (sm_90a): the one-partition overlap-add
// of the 32768-tap Hilbert FIR at an FFT length of 65,536.
//
// Replaces no TPU kernel: the JAX package, like the port before this
// kernel, takes a plain FFT convolution at this blksiz, because no kernel
// of either frames it.  stream_conv's ring would need 128 partitions of
// 256 and 287 KiB of shared memory, and fused_conv holds one frame of
// 2 * parsiz points in one block, 256 KiB here, over the 227 KiB a block
// may have.  Per row and per 32768-sample block f it computes, with
// N = 65536 and H the FIR's N-point half spectrum,
//
//     y_f = irfft(rfft(pad(block_f, N)) * H)
//     h[f*32768 + m] = y_f[m] + y_{f-1}[32768 + m]
//
// over the row's B = ceil(n / 32768) blocks and one flush block, B + 1
// frames, reading the input in place (zeros past its n samples).
//
// What bounds it on the card: the transform, as in fused_conv: ~6.19 M
// FP32 operations a frame against 128 KiB read and 128 KiB written, so
// the operations bound it by a little (harness/roofline.py).
//
// What the design does about it:
//   - As in fused_conv, the N-point real frame, zero in its upper half, is
//     the M-point complex FFT of z[n] = x[2n] + j*x[2n+1], M = 32768, with
//     z[n] = 0 for n >= M/2, and an untangling pass.
//   - M complex points are 256 KiB, so a cluster of two blocks on two SMs
//     shares each frame.  The first decimation-in-frequency stage (span
//     M/2) pairs z[p] with z[p + M/2] = 0: block 0 keeps a[p] = z[p], the
//     sub-problem of the even bins, and block 1 b[p] = z[p] * W_M^p, that
//     of the odd bins.  Both read the frame from device memory (the
//     second read is an L2 hit) and apply that stage as they load it, so
//     the stage costs no pass.  Each block then holds M/2 = 16384 complex
//     points, 128 KiB, and runs fused_conv's 16384-point transform on
//     them unchanged (csrc/ola_fft.cuh: the conflict-free slots, the
//     stage-major twiddle table in shared memory, 218,448 bytes a block).
//     Block b's half is positions [b * M/2, (b + 1) * M/2) of the full
//     bit-reversed spectrum.
//   - The spectrum product pairs bins k and M - k, which share k's parity,
//     so every pair lies in one block: block 0 takes the items of the walk
//     in [0, M/4) and item M/2, block 1 those in [M/4, M/2) (product_item,
//     the same arithmetic as fused_conv).
//   - Each block's inverse (decimation in time, bit-reversed in, natural
//     out) of its half gives s_b[n], n < M/2; the last stage of the full
//     inverse, y[p] = s_0[p] + conj(W_M^p) s_1[p] and y[p + M/2] = s_0[p]
//     - conj(W_M^p) s_1[p], needs both halves.  After a cluster barrier
//     block b computes it for p in [b * M/4, (b + 1) * M/4), reading the
//     other block's half through distributed shared memory (64 KiB each
//     way a frame), and writes both the head y[p] and, as the next
//     frame's carry in registers, the tail y[p + M/2].  A second barrier
//     keeps either block from loading its next frame while the other
//     still reads its half.
//   - A persistent grid of clusters (as many as the card holds at once)
//     gives each cluster one contiguous run of frames in flattened (row,
//     frame) order.  As in fused_conv, the thread that writes float4 i of
//     a frame's head adds float4 i of the previous frame's tail, which it
//     computed itself; only a run's first frame lacks the tail of the run
//     before it: each cluster writes its last tail to a scratch row, and
//     a second kernel adds it to those frames alone.
//   - W_M^p (p < M/2) and the product's W_N^k are computed in float64 on
//     the host and read as float32 tables.  All arithmetic is FP32: no
//     TF32, no fast math.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "ola_fft.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kParsiz = 32768;               // samples a block
constexpr int kM = kParsiz;                  // complex points a frame
constexpr int kLog2Half = 14;                // each block's transform
constexpr int kHalf = 1 << kLog2Half;        // M/2 complex points a block
constexpr int kThreads = 1024;
constexpr int kLoad = kHalf / 2 / kThreads;  // float4 a thread loads: 8
constexpr int kOut = kHalf / 4 / kThreads;   // head float4 a thread: 4
constexpr size_t kSmem = kHalf * sizeof(float2) +
                         static_cast<size_t>((kHalf - 1) / 3) * sizeof(float4);

__device__ __forceinline__ float4 cmul2(float4 v, float4 w) {
  const float2 a = cmul(make_float2(v.x, v.y), make_float2(w.x, w.y));
  const float2 b = cmul(make_float2(v.z, v.w), make_float2(w.z, w.w));
  return make_float4(a.x, a.y, b.x, b.y);
}

// Samples s .. s + 3 of a row of n, zeros past its end.
__device__ __forceinline__ float4 load4(const float* __restrict__ xr,
                                        long long s, long long n,
                                        bool aligned) {
  if (aligned && s + 4 <= n) {
    return __ldg(reinterpret_cast<const float4*>(xr + s));
  }
  float v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = s + j < n ? __ldg(xr + s + j) : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

// One contiguous run of frames per cluster of two blocks; frame f is row
// f / frames_per_row, block f % frames_per_row of its row.  x rows of n
// samples, x_stride apart (aligned: float4 loads allowed); w_split[i] =
// (W_M^2i, W_M^(2i+1)); spectrum and product_twiddle in the product's
// position and item order; out rows of frames_per_row * 32768 samples.
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kThreads)
hilbert32k_runs(const float* __restrict__ x, long long x_stride, long long n,
                int aligned, const float4* __restrict__ twiddles,
                const float4* __restrict__ w_split,
                const float2* __restrict__ spectrum,
                const float2* __restrict__ product_twiddle,
                float* __restrict__ run_tails, float* __restrict__ out,
                long long n_frames, int frames_per_row) {
  extern __shared__ float4 smem4[];
  float2* z = reinterpret_cast<float2*>(smem4);
  float4* tws = smem4 + (kHalf >> 1);  // the twiddle table after the half
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  for (int i = threadIdx.x; i < table_len(kHalf); i += kThreads) {
    tws[i] = __ldg(twiddles + i);
  }
  const float4* half0 = cluster.map_shared_rank(smem4, 0);
  const float4* half1 = cluster.map_shared_rank(smem4, 1);
  const long long clusters = gridDim.x >> 1, c = blockIdx.x >> 1;
  const long long f0 = run_start(c, n_frames, clusters);
  const long long f1 = run_start(c + 1, n_frames, clusters);
  const long long out_stride = static_cast<long long>(frames_per_row) * kParsiz;
  // the items of the product walk this block takes: block 0 [0, M/4) and
  // M/2, block 1 [M/4, M/2)
  const int items = kM / 4 + (rank == 0);
  const int item0 = rank * (kM / 4), off = rank * kHalf;
  float4 carry[kOut];
  for (long long f = f0; f < f1; ++f) {
    const long long row = f / frames_per_row;
    const long long s0 = (f - row * frames_per_row) * kParsiz;
    const float* xr = x + row * x_stride;
#pragma unroll
    for (int k = 0; k < kLoad; ++k) {
      const int i = threadIdx.x + k * kThreads;  // z[2i], z[2i + 1]
      float4 v = load4(xr, s0 + 4 * i, n, aligned != 0);
      if (rank == 1) v = cmul2(v, __ldg(w_split + i));
      const int s = slot(2 * i);
      smem4[s >> 1] = pair_order(v, s);
    }
    __syncthreads();
    fft_dif(z, tws, kLog2Half);
    for (int t = threadIdx.x; t < items; t += kThreads) {
      product_item(z, spectrum, product_twiddle, kM,
                   t == kM / 4 ? kM / 2 : item0 + t, off);
    }
    __syncthreads();
    ifft_dit(z, tws, kLog2Half);
    cluster.sync();  // both halves inverted
    const bool has_carry = f != f0 && s0 != 0;
    float4* dst = reinterpret_cast<float4*>(out + row * out_stride + s0);
#pragma unroll
    for (int k = 0; k < kOut; ++k) {
      const int i = rank * (kHalf / 4) + threadIdx.x + k * kThreads;
      const int s = slot(2 * i);
      const float4 a = pair_order(half0[s >> 1], s);
      const float4 w = __ldg(w_split + i);
      const float4 t = cmul2(pair_order(half1[s >> 1], s),
                             make_float4(w.x, -w.y, w.z, -w.w));
      float4 head = make_float4(a.x + t.x, a.y + t.y, a.z + t.z, a.w + t.w);
      if (has_carry) head = add4(head, carry[k]);
      dst[i] = head;
      carry[k] = make_float4(a.x - t.x, a.y - t.y, a.z - t.z, a.w - t.w);
    }
    cluster.sync();  // the other block has read this one's half
  }
  if (f1 < n_frames && f1 % frames_per_row != 0) {
    float4* keep = reinterpret_cast<float4*>(run_tails + c * kParsiz);
#pragma unroll
    for (int k = 0; k < kOut; ++k) {
      keep[rank * (kHalf / 4) + threadIdx.x + k * kThreads] = carry[k];
    }
  }
}

// The first frame of run c = blockIdx.x + 1, where it is not a row's
// first: its head plus the tail of run c - 1's last frame.
__global__ void hilbert32k_fixup(const float* __restrict__ run_tails,
                                 float* out, long long n_frames,
                                 int frames_per_row) {
  const long long f = run_start(blockIdx.x + 1, n_frames, gridDim.x + 1);
  if (f % frames_per_row == 0) return;
  const long long row = f / frames_per_row;
  float* head = out + row * frames_per_row * static_cast<long long>(kParsiz) +
                (f - row * frames_per_row) * kParsiz;
  const float* tail = run_tails + static_cast<long long>(blockIdx.x) * kParsiz;
  for (int m = threadIdx.x; m < kParsiz; m += blockDim.x) {
    head[m] = __fadd_rn(head[m], tail[m]);
  }
}

cudaError_t allow_smem() {
  return cudaFuncSetAttribute(hilbert32k_runs,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(kSmem));
}

}  // namespace

// The run kernel's launch on the current device: info = {clusters of two
// blocks resident on the whole card at once (the grid of a persistent
// launch), threads per block, registers per thread, local memory bytes
// per thread (spills), dynamic shared memory bytes per block}.
extern "C" int prt_hilbert32k_grid(int* info) {
  cudaError_t err = allow_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(2, 1, 1);
  config.blockDim = dim3(kThreads, 1, 1);
  config.dynamicSmemBytes = kSmem;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, hilbert32k_runs, &config);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, hilbert32k_runs);
  if (err != cudaSuccess) return static_cast<int>(err);
  info[0] = clusters;
  info[1] = kThreads;
  info[2] = attr.numRegs;
  info[3] = static_cast<int>(attr.localSizeBytes);
  info[4] = static_cast<int>(kSmem);
  return 0;
}

// x (rows, n) with rows x_stride floats apart; aligned: x and x_stride
// allow float4 loads; twiddles the stage-major table of the 16384-point
// transform; w_split (M/2, 2) W_M^p; spectrum and product_twiddle in the
// product's position and item order; run_tails (clusters - 1, 32768)
// scratch; out (rows, frames_per_row * 32768); clusters in [1, rows *
// frames_per_row], each one run of frames (the card's resident clusters
// for speed: any count gives the same output).
extern "C" int prt_hilbert32k(const float* x, long long x_stride, long long n,
                              int aligned, const float* twiddles,
                              const float* w_split, const float* spectrum,
                              const float* product_twiddle, float* run_tails,
                              float* out, int rows, int frames_per_row,
                              int clusters, void* stream) {
  if (rows <= 0 || frames_per_row <= 0) return 0;
  const long long n_frames = static_cast<long long>(rows) * frames_per_row;
  if (clusters < 1 || clusters > n_frames || n < 0 ||
      n > static_cast<long long>(frames_per_row) * kParsiz) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = allow_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  hilbert32k_runs<<<2 * clusters, kThreads, kSmem, st>>>(
      x, x_stride, n, aligned, reinterpret_cast<const float4*>(twiddles),
      reinterpret_cast<const float4*>(w_split),
      reinterpret_cast<const float2*>(spectrum),
      reinterpret_cast<const float2*>(product_twiddle), run_tails, out,
      n_frames, frames_per_row);
  err = cudaGetLastError();
  if (err != cudaSuccess || clusters == 1) return static_cast<int>(err);
  hilbert32k_fixup<<<clusters - 1, 256, 0, st>>>(run_tails, out, n_frames,
                                                 frames_per_row);
  return static_cast<int>(cudaGetLastError());
}
