// All-angle rotated-peak sweep for Hopper (sm_90a).
//
// Replaces: phaserotate_tpu/kernels/rotate_peak.py rotate_peak_sweep_kernel
// (_sweep_body), the Pallas kernel of the analyzer's angle sweep:
//
//     peaks[row, a] = max_m | cos[a] * b0[row, m] + sin[a] * b1[row, m] |
//
// over the 360 half-degree angles of core/angles.all_angle_cos_sin.
//
// What bounds it on the card: arithmetic, not bytes.  Each sample pair is
// 8 bytes read and 360 x (2 mul + add + abs-max) = 1,440 FP32 operations,
// about 180 operations per byte, far above the H100's ~20 FP32 operations
// per byte of HBM bandwidth.  The contraction depth is 2, so tensor cores
// have nothing to do: this is CUDA-core work.
//
// What the design does about it: one block per (sample tile, row) stages
// the tile's (b0, b1) pairs in shared memory once; each of its 128 threads
// keeps the cos/sin of up to four angles and their running maxima in
// registers, so every shared-memory read feeds several angles and the
// inner loop is nothing but FP32 instructions.  The TPU carried its
// running max across a sequential grid axis; Hopper blocks run in no
// order, so tiles combine with atomicMax on the float's bits as unsigned
// int (the values are >= +0 and the output starts at zeros, so the bit
// order is the numeric order).  Rows times tiles ride gridDim.x, so any
// number of rows fits one launch.
//
// Rounding: __fmul_rn / __fadd_rn keep the compiler from contracting
// c*b0 + s*b1 into an FMA, so every value rounds exactly as the plain
// PyTorch version (two products, one sum) does; max is exact, so the
// table is bit-equal to it.  fmaxf drops NaN where torch.amax keeps it.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

template <int APT>
__global__ void __launch_bounds__(kThreads)
sweep_kernel(const float* __restrict__ b0, const float* __restrict__ b1,
             long long stride0, long long stride1,
             const float* __restrict__ cos_sin,
             unsigned int* __restrict__ out, long long n, int a_count,
             int tile_len, int tiles) {
  extern __shared__ float2 tile[];
  const long long row = blockIdx.x / tiles;
  const long long start = static_cast<long long>(blockIdx.x % tiles) *
                          tile_len;
  const float* r0 = b0 + row * stride0 + start;
  const float* r1 = b1 + row * stride1 + start;
  const long long remain = n - start;
  const int len = remain < tile_len ? static_cast<int>(remain) : tile_len;
  for (int i = threadIdx.x; i < len; i += kThreads) {
    tile[i] = make_float2(r0[i], r1[i]);
  }

  float c[APT], s[APT], m[APT];
#pragma unroll
  for (int j = 0; j < APT; ++j) {
    const int a = threadIdx.x + j * kThreads;
    c[j] = a < a_count ? cos_sin[a] : 0.f;
    s[j] = a < a_count ? cos_sin[a_count + a] : 0.f;
    m[j] = 0.f;
  }
  __syncthreads();

#pragma unroll 4
  for (int i = 0; i < len; ++i) {
    const float2 v = tile[i];
#pragma unroll
    for (int j = 0; j < APT; ++j) {
      const float p = __fadd_rn(__fmul_rn(c[j], v.x), __fmul_rn(s[j], v.y));
      m[j] = fmaxf(m[j], fabsf(p));
    }
  }

#pragma unroll
  for (int j = 0; j < APT; ++j) {
    const int a = threadIdx.x + j * kThreads;
    if (a < a_count) {
      atomicMax(out + row * a_count + a,
                __float_as_uint(m[j]));
    }
  }
}

}  // namespace

extern "C" int prt_rotate_peak_sweep(const float* b0, const float* b1,
                                     long long stride0, long long stride1,
                                     const float* cos_sin, float* out,
                                     int rows, long long n, int a_count,
                                     int tile_len, void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  const long long tiles = (n + tile_len - 1) / tile_len;
  const long long blocks = tiles * rows;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks));
  const int t = static_cast<int>(tiles);
  const size_t smem = static_cast<size_t>(tile_len) * sizeof(float2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned int* o = reinterpret_cast<unsigned int*>(out);
  switch ((a_count + kThreads - 1) / kThreads) {
    case 1:
      sweep_kernel<1><<<grid, kThreads, smem, st>>>(
          b0, b1, stride0, stride1, cos_sin, o, n, a_count, tile_len, t);
      break;
    case 2:
      sweep_kernel<2><<<grid, kThreads, smem, st>>>(
          b0, b1, stride0, stride1, cos_sin, o, n, a_count, tile_len, t);
      break;
    case 3:
      sweep_kernel<3><<<grid, kThreads, smem, st>>>(
          b0, b1, stride0, stride1, cos_sin, o, n, a_count, tile_len, t);
      break;
    case 4:
      sweep_kernel<4><<<grid, kThreads, smem, st>>>(
          b0, b1, stride0, stride1, cos_sin, o, n, a_count, tile_len, t);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// max |x| of a 1-D signal.
//
// Replaces: phaserotate_tpu/kernels/rotate_peak.py peak_kernel (_peak_body),
// the tiled abs-max reduction of the reference's dsp_compute_peak
// (cli/dsp_peak_calc.h:27).  Bound by HBM bandwidth: 4 bytes read per
// sample and one max.  Each thread walks the signal grid-stride in float4
// loads, a warp reduces with __reduce_max_sync and a block through shared
// memory, and blocks combine with atomicMax on the float bits as unsigned
// int, the sweep's trick; the output starts at +0.
//
// The reduction is over the bits of fabsf(x) as unsigned int: for values
// >= +0 that order is the numeric one, and a NaN's bits (exponent all ones,
// nonzero mantissa, sign cleared by fabsf) exceed those of +inf, so a NaN
// anywhere propagates to the result as it does in jnp.max and torch.amax.
// Max is exact, so the result is bit-equal to x.abs().max() otherwise.
namespace {

constexpr int kPeakThreads = 256;

__global__ void __launch_bounds__(kPeakThreads)
peak_abs_max(const float* __restrict__ x, long long n, int head,
             unsigned int* __restrict__ out) {
  const long long tid =
      static_cast<long long>(blockIdx.x) * kPeakThreads + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kPeakThreads;
  unsigned int m = 0u;
  if (tid < head) m = __float_as_uint(fabsf(x[tid]));  // up to 16-byte
  const long long body = (n - head) / 4;                // alignment
  const float4* v = reinterpret_cast<const float4*>(x + head);
  for (long long i = tid; i < body; i += stride) {
    const float4 q = __ldg(v + i);
    m = max(m, max(max(__float_as_uint(fabsf(q.x)),
                       __float_as_uint(fabsf(q.y))),
                   max(__float_as_uint(fabsf(q.z)),
                       __float_as_uint(fabsf(q.w)))));
  }
  for (long long i = head + body * 4 + tid; i < n; i += stride) {
    m = max(m, __float_as_uint(fabsf(x[i])));
  }
  m = __reduce_max_sync(0xffffffffu, m);
  __shared__ unsigned int warp_max[kPeakThreads / 32];
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    m = threadIdx.x < kPeakThreads / 32 ? warp_max[threadIdx.x] : 0u;
    m = __reduce_max_sync(0xffffffffu, m);
    if (threadIdx.x == 0) atomicMax(out, m);
  }
}

}  // namespace

extern "C" int prt_peak(const float* x, long long n, float* out,
                        void* stream) {
  if (n <= 0) return 0;
  const unsigned long long addr = reinterpret_cast<unsigned long long>(x);
  long long head = static_cast<long long>(((16 - (addr & 15)) & 15) / 4);
  if (head > n) head = n;
  long long blocks = ((n - head) / 4 + kPeakThreads - 1) / kPeakThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > 132LL * 16) blocks = 132LL * 16;  // grid-stride beyond
  peak_abs_max<<<static_cast<unsigned>(blocks), kPeakThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      x, n, static_cast<int>(head), reinterpret_cast<unsigned int*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* prt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
