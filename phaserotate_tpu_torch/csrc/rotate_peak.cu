// All-angle rotated-peak sweep for Hopper (sm_90a).
//
// Replaces: phaserotate_tpu/kernels/rotate_peak.py rotate_peak_sweep_kernel
// (_sweep_body), the Pallas kernel of the analyzer's angle sweep:
//
//     peaks[row, a] = max_m | cos[a] * b0[row, m] + sin[a] * b1[row, m] |
//
// over the 360 half-degree angles of core/angles.all_angle_cos_sin.
//
// What bounds it on the card: instruction issue.  Each sample pair is 8
// bytes read and 360 x (2 mul + add + abs-max) FP32 operations, far above
// the H100's ~20 FP32 operations per byte of HBM bandwidth, and the
// contraction depth of 2 leaves tensor cores nothing to do.  The products
// must not fuse into an FMA (see Rounding), so every operation is its own
// instruction, and an SM issues one instruction per warp scheduler per
// clock: the count of instructions per sample, not FLOP/s, sets the time.
//
// What the design does about it: it issues fewer instructions.  The
// canonical table is mirror-symmetric bit for bit: cos[360 - u] ==
// -cos[u] and sin[360 - u] == sin[u] for u = 1..179.  So angles u and
// 360 - u share both products, p = c*x and q = s*h: angle u is |p + q|
// and angle 360 - u is |q - p|, which is what the plain version's
// fl(fl(-c*x) + fl(s*h)) gives, since negation is exact.  That pair unit
// is 2 FMUL, 2 FADD (the negation is an operand modifier) and 2 FMNMX (so
// is the |.|): 3 instructions per sample-angle where one angle at a time
// takes 4.  Angles 0 and 180 have no partner and form the one general
// unit (4 FMUL, 2 FADD, 2 FMNMX), so 180 units cover the table with no
// padded slot.
//
// Thread map (mirrored by kernels/rotate_peak.py SWEEP_*): one block per
// (sample tile, row), 20 groups of 8 threads.  Group g holds units
// 9g .. 9g + 8, unit u being angles (u, 360 - u), unit 0 angles (0, 180);
// each of its threads keeps those units' cos/sin and 18 running maxima in
// registers and walks samples i = lane (mod 8) of the tile staged in
// shared memory, so one LDS.64 feeds 54 FP32 instructions and a warp's 8
// distinct float2 addresses are one wavefront.  Warp 0 (groups 0-3) runs
// its first unit in the general form, the other angle's cos/sin read from
// the table, which keeps the warp on one path at 2 extra FMUL per group.
// The 8 threads of a group then combine by shuffles, the groups through
// shared memory, and tiles with one coalesced atomicMax per angle on the
// float's bits as unsigned int (a warp's 32 angles are one L2 request,
// where 18 atomics from each group leader would be 7x the requests, all
// on the row's few lines).  The values are >= +0 and the output
// starts at zeros, so the bit order is the numeric order; a NaN's bits,
// sign cleared, order above +inf.  Rows times tiles ride gridDim.x, so any
// number of rows fits one launch.
//
// Before the pair units run, every block checks on the device, with no
// host sync: that the table has 360 angles; that its entries are mirror
// pairs, bit for bit; that each |cos| and |sin| is <= 1; and that every
// staged sample is finite.  One __syncthreads_and combines the answers.
// Under those conditions no product overflows and no sum is NaN, so
// fmaxf, which drops NaN, loses nothing.
//
// A block that fails any of them (an angle slice, another table, a tile
// with a NaN or an inf) runs the general map, for any table of up to 512
// angles (mirrored by kernels/rotate_peak.py GENERAL_SLOTS and
// general_slots).  It has the same shape as the pair units: each thread
// holds the cos/sin of K angles and K running maxima in registers, K =
// min(ceil(A / 20), 9) a template parameter chosen on the host (a
// runtime K would leave padded slots issuing), and walks samples i = lane
// (mod 8), so one LDS.64 feeds 4K FP32 instructions: 4 + 1/K per
// sample-angle, where one thread per angle walking the whole tile would
// take ~6 (a broadcast LDS.64 each).  Slot j of group g in chunk c is angle
// c * 20K + g * K + j: a table above 20K angles runs in chunks over the
// same staged tile, each angle in exactly one (chunk, group, slot).  The
// group's 8 lanes combine by shuffles; the group leader writes its
// angles' maxima into a region of shared memory after the tile (which the
// next chunk still reads), and after the last chunk one barrier and one
// coalesced atomicMax per angle, as above.  A second __syncthreads_and,
// reached by the whole block on this branch alone, picks the form: where
// the tile is finite and every |cos|, |sin| <= 1, fmaxf with the |.|
// operand modifier (one FMNMX); otherwise the abs-max on the bits as
// unsigned int (the |.| and an integer max, 5 + 1/K), which propagates
// NaN as torch.amax and jnp.max do.  Either way a zero sample gives +0.
//
// Rounding: __fmul_rn / __fadd_rn / __fsub_rn keep the compiler from
// contracting c*b0 + s*b1 into an FMA, so every value rounds exactly as
// the plain PyTorch version (two products, one sum) does; max is exact, so
// the table is bit-equal to it, NaN for NaN.

#include <cuda_runtime.h>

namespace {

// The thread map; kernels/rotate_peak.py mirrors these as SWEEP_ANGLES,
// SWEEP_GROUPS, SWEEP_LANES and SWEEP_UNITS.  Edit both together.
constexpr int kSweepAngles = 360;  // the table the pair units serve
constexpr int kSweepGroups = 20;   // groups of a block
constexpr int kSweepLanes = 8;     // threads of a group
constexpr int kSweepUnits = 9;     // units per thread
constexpr int kSweepThreads = kSweepGroups * kSweepLanes;  // 160: 5 warps
constexpr int kMaxAngles = 512;    // the wrapper's limit on any table
// the general map's most angles per thread (GENERAL_SLOTS); K is
// min(ceil(A / kSweepGroups), kGeneralSlots), in prt_rotate_peak_sweep
constexpr int kGeneralSlots = 9;
static_assert(2 * kSweepGroups * kSweepUnits == kSweepAngles,
              "every angle in exactly one unit");
static_assert(32 % kSweepLanes == 0, "a group lies within one warp");

__device__ __forceinline__ bool finite(float v) {
  return (__float_as_uint(v) & 0x7f800000u) != 0x7f800000u;
}

// |c| <= 1 and |s| <= 1, false for NaN: then the products of finite
// samples are finite, and p + q and q - p are never NaN.
__device__ __forceinline__ bool bounded(float c, float s) {
  return fabsf(c) <= 1.f && fabsf(s) <= 1.f;
}

// One thread's 9 units over its samples i = lane (mod 8) of the tile.
// Unit j's first angle is |p + q|; its second is |q - p|, or in the
// general form (kGeneral0, unit 0 only) |cb0*x + sb0*h|.
template <bool kGeneral0>
__device__ __forceinline__ void pair_units(
    const float2* __restrict__ tile, int len, int lane,
    const float (&c)[kSweepUnits], const float (&s)[kSweepUnits],
    float cb0, float sb0, float (&m1)[kSweepUnits],
    float (&m2)[kSweepUnits]) {
#pragma unroll 4
  for (int i = lane; i < len; i += kSweepLanes) {
    const float2 v = tile[i];
#pragma unroll
    for (int j = 0; j < kSweepUnits; ++j) {
      const float p = __fmul_rn(c[j], v.x);
      const float q = __fmul_rn(s[j], v.y);
      const float y2 = kGeneral0 && j == 0
                           ? __fadd_rn(__fmul_rn(cb0, v.x),
                                       __fmul_rn(sb0, v.y))
                           : __fsub_rn(q, p);
      m1[j] = fmaxf(m1[j], fabsf(__fadd_rn(p, q)));
      m2[j] = fmaxf(m2[j], fabsf(y2));
    }
  }
}

// One chunk of the general map over this thread's samples i = lane
// (mod 8): slot j is angle a0 + j, (c[j], s[j]) = (0, 0) past the table.
// kFinite: the block's tile is finite and its table bounded, so |y| is
// never NaN and fmaxf takes the max; otherwise the max is taken on the
// bits as unsigned int.  Returns the maxima's bits in m.
template <int K, bool kFinite>
__device__ __forceinline__ void general_slots(
    const float2* __restrict__ tile, int len, int lane,
    const float (&c)[K], const float (&s)[K], unsigned int (&m)[K]) {
  float f[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    f[j] = 0.f;
    m[j] = 0u;
  }
#pragma unroll 4
  for (int i = lane; i < len; i += kSweepLanes) {
    const float2 v = tile[i];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const float y = __fadd_rn(__fmul_rn(c[j], v.x), __fmul_rn(s[j], v.y));
      if (kFinite) {
        f[j] = fmaxf(f[j], fabsf(y));
      } else {
        m[j] = max(m[j], __float_as_uint(fabsf(y)));
      }
    }
  }
  if (kFinite) {
#pragma unroll
    for (int j = 0; j < K; ++j) m[j] = __float_as_uint(f[j]);
  }
}

// K: the general map's angles per thread.  Only K = kGeneralSlots can
// serve the canonical table (A = 360), so only it carries the pair units.
template <int K>
__global__ void __launch_bounds__(kSweepThreads)
sweep_kernel(const float* __restrict__ b0, const float* __restrict__ b1,
             long long stride0, long long stride1,
             const float* __restrict__ cos_sin,
             unsigned int* __restrict__ out, long long n, int a_count,
             int tile_len, int tiles) {
  extern __shared__ float2 tile[];
  // the maxima by angle, after the tile: the general map's chunks write
  // theirs while later chunks still read the tile
  unsigned int* peak = reinterpret_cast<unsigned int*>(tile + tile_len);
  const long long row = blockIdx.x / tiles;
  const long long start = static_cast<long long>(blockIdx.x % tiles) *
                          tile_len;
  const float* r0 = b0 + row * stride0 + start;
  const float* r1 = b1 + row * stride1 + start;
  const long long remain = n - start;
  const int len = remain < tile_len ? static_cast<int>(remain) : tile_len;
  bool ok = true;  // finite samples and a bounded table: the fmaxf form
  for (int i = threadIdx.x; i < len; i += kSweepThreads) {
    const float x = r0[i], h = r1[i];
    tile[i] = make_float2(x, h);
    ok &= finite(x) & finite(h);
  }
  for (int a = threadIdx.x; a < a_count; a += kSweepThreads) {
    ok &= bounded(cos_sin[a], cos_sin[a_count + a]);
  }
  const int g = threadIdx.x / kSweepLanes;
  const int lane = threadIdx.x % kSweepLanes;
  unsigned int* o = out + row * a_count;

  if constexpr (K == kGeneralSlots) {
    // this thread's units and the mirror check of the table on their
    // entries
    float c[kSweepUnits], s[kSweepUnits], cb0 = 0.f, sb0 = 0.f;
    bool pairs = ok & (a_count == kSweepAngles);
    if (a_count == kSweepAngles) {
#pragma unroll
      for (int j = 0; j < kSweepUnits; ++j) {
        const int u = g * kSweepUnits + j;
        const int b = u ? kSweepAngles - u : kSweepAngles / 2;
        c[j] = cos_sin[u];
        s[j] = cos_sin[kSweepAngles + u];
        const float cb = cos_sin[b], sb = cos_sin[kSweepAngles + b];
        if (u) {  // a mirror pair: -cos and the same sin, bit for bit
          pairs &= (__float_as_uint(cb) ==
                    (__float_as_uint(c[j]) ^ 0x80000000u)) &
                   (__float_as_uint(sb) == __float_as_uint(s[j]));
        }
        if (j == 0) {
          cb0 = cb;
          sb0 = sb;
        }
      }
    }
    if (__syncthreads_and(pairs)) {
      float m1[kSweepUnits], m2[kSweepUnits];
#pragma unroll
      for (int j = 0; j < kSweepUnits; ++j) m1[j] = m2[j] = 0.f;
      if (threadIdx.x < 32) {  // warp 0: unit 0 in the general form
        pair_units<true>(tile, len, lane, c, s, cb0, sb0, m1, m2);
      } else {
        pair_units<false>(tile, len, lane, c, s, cb0, sb0, m1, m2);
      }
#pragma unroll
      for (int j = 0; j < kSweepUnits; ++j) {
#pragma unroll
        for (int d = kSweepLanes / 2; d > 0; d >>= 1) {
          m1[j] = fmaxf(m1[j], __shfl_xor_sync(0xffffffffu, m1[j], d));
          m2[j] = fmaxf(m2[j], __shfl_xor_sync(0xffffffffu, m2[j], d));
        }
      }
      if (lane == 0) {  // the groups' maxima by angle
#pragma unroll
        for (int j = 0; j < kSweepUnits; ++j) {
          const int u = g * kSweepUnits + j;
          peak[u] = __float_as_uint(m1[j]);
          peak[u ? kSweepAngles - u : kSweepAngles / 2] =
              __float_as_uint(m2[j]);
        }
      }
      __syncthreads();
      for (int a = threadIdx.x; a < kSweepAngles; a += kSweepThreads) {
        atomicMax(o + a, peak[a]);
      }
      return;
    }
  }

  // the general map: any table; the block takes one form
  const bool fin = __syncthreads_and(ok);
  for (int base = 0; base < a_count; base += kSweepGroups * K) {
    const int a0 = base + g * K;
    float c[K], s[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const bool in = a0 + j < a_count;
      c[j] = in ? cos_sin[a0 + j] : 0.f;
      s[j] = in ? cos_sin[a_count + a0 + j] : 0.f;
    }
    unsigned int m[K];
    if (a0 >= a_count) {  // a group past the table issues no sample
#pragma unroll
      for (int j = 0; j < K; ++j) m[j] = 0u;
    } else if (fin) {
      general_slots<K, true>(tile, len, lane, c, s, m);
    } else {
      general_slots<K, false>(tile, len, lane, c, s, m);
    }
#pragma unroll
    for (int j = 0; j < K; ++j) {
#pragma unroll
      for (int d = kSweepLanes / 2; d > 0; d >>= 1) {
        m[j] = max(m[j], __shfl_xor_sync(0xffffffffu, m[j], d));
      }
      if (lane == 0 && a0 + j < a_count) peak[a0 + j] = m[j];
    }
  }
  __syncthreads();
  for (int a = threadIdx.x; a < a_count; a += kSweepThreads) {
    atomicMax(o + a, peak[a]);
  }
}

using SweepKernel = decltype(&sweep_kernel<1>);
const SweepKernel kSweepKernels[kGeneralSlots] = {
    sweep_kernel<1>, sweep_kernel<2>, sweep_kernel<3>,
    sweep_kernel<4>, sweep_kernel<5>, sweep_kernel<6>,
    sweep_kernel<7>, sweep_kernel<8>, sweep_kernel<9>};

}  // namespace

extern "C" int prt_rotate_peak_sweep(const float* b0, const float* b1,
                                     long long stride0, long long stride1,
                                     const float* cos_sin, float* out,
                                     int rows, long long n, int a_count,
                                     int tile_len, void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  if (a_count <= 0 || a_count > kMaxAngles) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long tiles = (n + tile_len - 1) / tile_len;
  const long long blocks = tiles * rows;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  // the general map's angles per thread: every group full where A allows
  const int per_group = (a_count + kSweepGroups - 1) / kSweepGroups;
  const int k = per_group < kGeneralSlots ? per_group : kGeneralSlots;
  // the tile, then the maxima of up to kMaxAngles angles
  const size_t smem = static_cast<size_t>(tile_len) * sizeof(float2) +
                      kMaxAngles * sizeof(unsigned int);
  kSweepKernels[k - 1]<<<static_cast<unsigned>(blocks), kSweepThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      b0, b1, stride0, stride1, cos_sin, reinterpret_cast<unsigned int*>(out),
      n, a_count, tile_len, static_cast<int>(tiles));
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
