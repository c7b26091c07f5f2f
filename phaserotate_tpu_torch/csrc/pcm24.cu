// 24-bit PCM widening for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package reads a 24-bit file through its
// float reader on the host.  The port's fleet ships a 24-bit master's data
// payload to the card as the file holds it (interleaved, three bytes a
// sample, little-endian; io/pcm24.py) and this kernel turns it into the
// sweep's input:
//
//     out[row, c, f] = sign_extend(b0 | b1 << 8 | b2 << 16) * 2^-23,
//     (b0, b1, b2) = in[row * n * channels * 3 + (f * channels + c) * 3 ...]
//
// A 24-bit integer over 2^23 is a float32, so the result is exact and
// bit-equal to the plain twin (kernels/pcm24.py pcm24_widen_plain).
//
// What bounds it on the card: HBM bandwidth.  Each sample is 3 bytes read
// and 4 written, with a few integer instructions between.
//
// What the design does about it: one pass, every load and store coalesced
// and as wide as the layout allows.  For mono and stereo rows whose frame
// count is a multiple of 4 (every fleet batch: its rows are zero-padded to
// a multiple of the block size), a thread takes 4 frames, 12 * CH
// contiguous bytes: 3 * CH aligned 32-bit loads, each sample's three bytes
// taken from one or two words with a funnel shift that the compiler places
// at compile time (CH is a template parameter), and one float4 store per
// channel, so a warp reads 384 * CH contiguous bytes and writes 512
// contiguous bytes per channel.  Any other row (more channels, an odd
// length, an unaligned buffer) takes the general kernel: a thread per
// frame, three byte loads and one store per sample.  Rows ride gridDim.y
// and frames gridDim.x, both grid-stride, so any batch fits one launch.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWidenThreads = 256;
constexpr float kScale = 1.0f / 8388608.0f;  // 2^-23

__device__ __forceinline__ float widen(unsigned int u) {
  // the low 24 bits of u, sign-extended
  const int s = static_cast<int>(u << 8) >> 8;
  return __fmul_rn(__int2float_rn(s), kScale);
}

template <int CH>
__global__ void __launch_bounds__(kWidenThreads)
pcm24_widen_groups(const unsigned int* __restrict__ in,
                   float* __restrict__ out, long long n, int rows) {
  constexpr int kWords = 3 * CH;  // 4 frames of CH 3-byte samples
  const long long groups = n / 4;
  const long long step = static_cast<long long>(gridDim.x) * kWidenThreads;
  for (int r = blockIdx.y; r < rows; r += gridDim.y) {
    const unsigned int* src = in + static_cast<long long>(r) * groups * kWords;
    float* dst = out + static_cast<long long>(r) * CH * n;
    for (long long g = static_cast<long long>(blockIdx.x) * kWidenThreads +
                       threadIdx.x;
         g < groups; g += step) {
      unsigned int w[kWords];
#pragma unroll
      for (int j = 0; j < kWords; ++j) w[j] = __ldg(src + g * kWords + j);
      float v[4 * CH];
#pragma unroll
      for (int k = 0; k < 4 * CH; ++k) {
        const int b = 3 * k;  // sample k's first byte, in word b / 4
        const int i = b >> 2;
        // the last sample sits in the last word's top three bytes: its
        // second word is never read, as widen drops the top byte
        const unsigned int hi = w[i + 1 < kWords ? i + 1 : i];
        v[k] = widen(__funnelshift_r(w[i], hi, 8 * (b & 3)));
      }
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        reinterpret_cast<float4*>(dst + static_cast<long long>(c) * n)[g] =
            make_float4(v[c], v[CH + c], v[2 * CH + c], v[3 * CH + c]);
      }
    }
  }
}

__global__ void __launch_bounds__(kWidenThreads)
pcm24_widen_frames(const unsigned char* __restrict__ in,
                   float* __restrict__ out, long long n, int channels,
                   int rows) {
  const long long step = static_cast<long long>(gridDim.x) * kWidenThreads;
  for (int r = blockIdx.y; r < rows; r += gridDim.y) {
    for (long long f = static_cast<long long>(blockIdx.x) * kWidenThreads +
                       threadIdx.x;
         f < n; f += step) {
      const unsigned char* src =
          in + (static_cast<long long>(r) * n + f) * channels * 3;
      for (int c = 0; c < channels; ++c) {
        const unsigned int u = src[3 * c] | (src[3 * c + 1] << 8) |
                               (src[3 * c + 2] << 16);
        out[(static_cast<long long>(r) * channels + c) * n + f] = widen(u);
      }
    }
  }
}

unsigned grid_x(long long items) {
  const long long blocks = (items + kWidenThreads - 1) / kWidenThreads;
  return static_cast<unsigned>(blocks < 65535 ? blocks : 65535);
}

}  // namespace

// in: rows x n x channels x 3 bytes; out: rows x channels x n float32.
extern "C" int prt_pcm24_widen(const void* in, float* out, int rows,
                               int channels, long long n, void* stream) {
  if (rows <= 0 || channels <= 0 || n <= 0) return 0;
  const dim3 grid_rows(1, static_cast<unsigned>(rows < 65535 ? rows : 65535));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned = (reinterpret_cast<std::uintptr_t>(in) & 3) == 0 &&
                       (reinterpret_cast<std::uintptr_t>(out) & 15) == 0 &&
                       n % 4 == 0;
  const unsigned int* words = static_cast<const unsigned int*>(in);
  dim3 grid = grid_rows;
  if (aligned && channels == 1) {
    grid.x = grid_x(n / 4);
    pcm24_widen_groups<1><<<grid, kWidenThreads, 0, s>>>(words, out, n, rows);
  } else if (aligned && channels == 2) {
    grid.x = grid_x(n / 4);
    pcm24_widen_groups<2><<<grid, kWidenThreads, 0, s>>>(words, out, n, rows);
  } else {
    grid.x = grid_x(n);
    pcm24_widen_frames<<<grid, kWidenThreads, 0, s>>>(
        static_cast<const unsigned char*>(in), out, n, channels, rows);
  }
  return static_cast<int>(cudaGetLastError());
}
