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
// order is the numeric order).
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
             int tile_len) {
  extern __shared__ float2 tile[];
  const int row = blockIdx.y;
  const long long start = static_cast<long long>(blockIdx.x) * tile_len;
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
      atomicMax(out + static_cast<long long>(row) * a_count + a,
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
  const dim3 grid(static_cast<unsigned>(tiles), rows);
  const size_t smem = static_cast<size_t>(tile_len) * sizeof(float2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned int* o = reinterpret_cast<unsigned int*>(out);
  switch ((a_count + kThreads - 1) / kThreads) {
    case 1:
      sweep_kernel<1><<<grid, kThreads, smem, st>>>(
          b0, b1, stride0, stride1, cos_sin, o, n, a_count, tile_len);
      break;
    case 2:
      sweep_kernel<2><<<grid, kThreads, smem, st>>>(
          b0, b1, stride0, stride1, cos_sin, o, n, a_count, tile_len);
      break;
    case 3:
      sweep_kernel<3><<<grid, kThreads, smem, st>>>(
          b0, b1, stride0, stride1, cos_sin, o, n, a_count, tile_len);
      break;
    case 4:
      sweep_kernel<4><<<grid, kThreads, smem, st>>>(
          b0, b1, stride0, stride1, cos_sin, o, n, a_count, tile_len);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* prt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
