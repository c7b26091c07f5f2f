// The packed wire's unpack for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package unpacks the wire
// (phaserotate_tpu/search/packed.py unpack_residual) in plain XLA, and the
// port did so in plain torch, three int32 cumsums and three selects over
// groups of streams (kept as the twin, kernels/unpack.py
// wire_unpack_plain).  torch's innermost-dimension scan walks each row of
// 8-34 M samples on a few warps, about 0.1 % of the card's bandwidth, so
// the unpack was most of a 16-bit catalogue batch's device time.
//
// The format (search/packed.py): stream s of S holds nb blocks of
// kBlock = 4096 residuals; block (s, b) has one width w = widths[s, b]
// (1..32 bits) and its 128 * w words start at words[woffs[s, b]]; residual
// i of the block is bits [i * w, (i + 1) * w) of them, little-endian,
// sign-extended.  A stream of order k (order[s], 1..3) is the k-th
// difference of its samples, zero before the first, so the samples are k
// nested prefix sums of the residuals along the whole stream; any other
// order ships the samples themselves.  out[s, i] = float(v) * 2^-15 for
// i < n, the twin's conversion.
//
// The decomposition.  Let L1, L2, L3 be the nested prefix sums of a
// segment's residuals taken from zero, and (c1, c2, c3) the values y1, y2,
// y3 of the nested sums just before it (the carries).  At the segment's
// local index i:
//
//     y1 = c1 + L1[i]
//     y2 = c2 + (i + 1) c1 + L2[i]
//     y3 = c3 + (i + 1) c2 + (i + 1)(i + 2) / 2 c1 + L3[i]
//
// So a segment of length l is summed up by (l, L1, L2, L3 at its end),
// and two segments one after the other by `combine` below: an associative
// operator that a scan can take in any grouping.  Every sum is uint32,
// exact mod 2^32; a sample is an int16 (or the int32 the twin's int32
// cumsums wrap to on any wire), so the low 32 bits are the result however
// large the intermediates grow.
//
// What bounds it on the card: HBM bandwidth.  The words are read (< 1
// byte a sample at the catalogue's widths, twice here), float32 written (4
// bytes a sample); a few integer instructions a sample between.
//
// The design: reduce, then scan, three launches a call.
//   1. wire_blocks<false>: one block of 128 threads per (stream, block):
//      decode, and the block's (L1, L2, L3) at its end into `agg`.
//   2. wire_stream_carries: one block of 1024 threads per stream: the
//      exclusive scan of its blocks' sums, each block's carries written
//      over its sums in `agg`.
//   3. wire_blocks<true>: decode again, the nested sums from the block's
//      carries, and the float32 samples out.
// In 1 and 3, thread t owns residuals [32 t, 32 t + 32) of its block,
// which are exactly words [t w, t w + w): the block's words come into
// shared memory with coalesced 16-byte loads (4-byte ones where a block is
// not 16-byte aligned or not inside the words), thread t's at t * pitch,
// pitch = w | 1, so the 32 threads' reads of their k-th words fall in 32
// banks for any w; each residual is a funnel shift of two neighbouring
// words.  The thread sums its 32 residuals in registers, the block scans
// the 128 threads' sums with warp shuffles and one exchange of the four
// warps' totals, and kernel 3 stages the samples through shared memory
// (one pad word every 32) so that each warp writes 128 contiguous bytes.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlock = 4096;     // residuals a block (search/packed.py BLOCK)
constexpr int kThreads = 128;    // a block's threads, 32 residuals each
constexpr int kPerThread = kBlock / kThreads;
constexpr int kWarps = kThreads / 32;
constexpr int kScanThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kScale = 1.0f / 32768.0f;  // 2^-15

static_assert(kPerThread == 32, "thread t's residuals are its w words");

// A segment's summary: its length and L1, L2, L3 at its end.
struct Sums {
  unsigned l, a1, a2, a3;
};

__device__ __forceinline__ unsigned tri(unsigned l) {
  // l (l + 1) / 2 mod 2^32, halving the even factor first
  return (l & 1u) ? l * ((l + 1u) >> 1) : (l >> 1) * (l + 1u);
}

// p, then q.  p's length is not read: carries combine as a segment of any
// length.
__device__ __forceinline__ Sums combine(const Sums& p, const Sums& q) {
  return {p.l + q.l, p.a1 + q.a1, p.a2 + q.l * p.a1 + q.a2,
          p.a3 + q.l * p.a2 + tri(q.l) * p.a1 + q.a3};
}

__device__ __forceinline__ Sums shfl_up(const Sums& s, int d) {
  return {__shfl_up_sync(kFull, s.l, d), __shfl_up_sync(kFull, s.a1, d),
          __shfl_up_sync(kFull, s.a2, d), __shfl_up_sync(kFull, s.a3, d)};
}

// The inclusive scan of the warp's 32 summaries, lane order.
__device__ __forceinline__ Sums warp_inclusive(Sums s) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Sums p = shfl_up(s, d);
    if (lane >= d) s = combine(p, s);
  }
  return s;
}

// What precedes this thread in the scan of the block's threads'
// summaries; `warp_total` (shared, a slot a warp) gets the warps' totals.
__device__ __forceinline__ Sums block_exclusive(const Sums& mine,
                                                Sums* warp_total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const Sums inc = warp_inclusive(mine);
  Sums excl = shfl_up(inc, 1);
  if (lane == 0) excl = {0u, 0u, 0u, 0u};
  if (lane == 31) warp_total[warp] = inc;
  __syncthreads();
  Sums pre = {0u, 0u, 0u, 0u};
  for (int q = 0; q < warp; ++q) pre = combine(pre, warp_total[q]);
  return combine(pre, excl);
}

// Decode block `blk` (stream s, block b) into thread t's 32 residuals.
// `sm` holds kThreads * 33 + 1 words.
__device__ __forceinline__ void decode(const unsigned* __restrict__ words,
                                       long long n_words, long long off,
                                       unsigned w, unsigned* sm,
                                       unsigned (&r)[kPerThread]) {
  const int tid = threadIdx.x;
  const unsigned pitch = w | 1u;
  const unsigned total = kThreads * w;
  // g / w for g < 4096 and w <= 32: floor(g * ceil(2^32 / w) / 2^32)
  const unsigned long long magic = ((1ull << 32) + w - 1) / w;
  auto put = [&](unsigned g, unsigned v) {
    const unsigned t = static_cast<unsigned>((g * magic) >> 32);
    sm[t * pitch + (g - t * w)] = v;
  };
  const bool inside = off >= 0 && off + total <= n_words;
  if (inside && (reinterpret_cast<std::uintptr_t>(words + off) & 15) == 0) {
    const uint4* src = reinterpret_cast<const uint4*>(words + off);
    for (unsigned q = tid; q < total / 4; q += kThreads) {
      const uint4 v = __ldg(src + q);
      put(4 * q, v.x);
      put(4 * q + 1, v.y);
      put(4 * q + 2, v.z);
      put(4 * q + 3, v.w);
    }
  } else {  // words past either end of the array read as zero
    for (unsigned g = tid; g < total; g += kThreads) {
      const long long at = off + g;
      put(g, at >= 0 && at < n_words ? __ldg(words + at) : 0u);
    }
  }
  __syncthreads();
  // residual j lies in words k = j w / 32 and k + 1 of the thread's; the
  // second is past the thread's words (the pad, or the next thread's
  // first) only where the residual ends inside the first, and the funnel
  // shift's top bits are then cut off by the sign extension
  const unsigned* mine = sm + tid * pitch;
  const unsigned cut = 32u - w;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const unsigned bit = j * w;
    const unsigned k = bit >> 5;
    const unsigned v = __funnelshift_r(mine[k], mine[k + 1], bit & 31u);
    r[j] = static_cast<unsigned>(static_cast<int>(v << cut) >> cut);
  }
}

template <bool kOut>
__global__ void __launch_bounds__(kThreads)
wire_blocks(const unsigned* __restrict__ words, long long n_words,
            const int* __restrict__ widths, const int* __restrict__ woffs,
            const int* __restrict__ order, uint4* __restrict__ agg,
            float* __restrict__ out, long long n, int nb) {
  __shared__ unsigned sm[kThreads * 33 + 1];
  __shared__ Sums warp_total[kWarps];
  const long long blk = blockIdx.x;
  const int s = static_cast<int>(blk / nb);
  const int b = static_cast<int>(blk - static_cast<long long>(s) * nb);
  const int wid = widths[blk];
  const unsigned w = wid < 1 ? 1u : wid > 32 ? 32u : static_cast<unsigned>(wid);
  const int ord = order[s];
  const bool scan = ord >= 1 && ord <= 3;
  if (!kOut && !scan) return;  // its sums are never read

  unsigned r[kPerThread];
  decode(words, n_words, woffs[blk], w, sm, r);

  if (scan) {
    unsigned a1 = 0, a2 = 0, a3 = 0;
    if (kOut) {
      // the sums of the block's and the thread's predecessors: the carries
      const uint4 c = agg[blk];
      a1 = c.x, a2 = c.y, a3 = c.z;
    }
    unsigned l1 = 0, l2 = 0, l3 = 0;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      l1 += r[j];
      l2 += l1;
      l3 += l2;
    }
    const Sums own = {static_cast<unsigned>(kPerThread), l1, l2, l3};
    const Sums pre = block_exclusive(own, warp_total);
    if (!kOut) {
      if (threadIdx.x == kThreads - 1) {
        const Sums all = combine(pre, own);
        agg[blk] = make_uint4(all.a1, all.a2, all.a3, 0u);
      }
      return;
    }
    const Sums c = combine({0u, a1, a2, a3}, pre);
    a1 = c.a1, a2 = c.a2, a3 = c.a3;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      a1 += r[j];
      a2 += a1;
      a3 += a2;
      r[j] = ord == 1 ? a1 : ord == 2 ? a2 : a3;
    }
  } else {
    __syncthreads();  // every thread's words are read before sm is reused
  }

  if (kOut) {
    // thread t's sample j at 33 t + j, then 128 consecutive samples a step
    float* f = reinterpret_cast<float*>(sm);
    const int tid = threadIdx.x;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      f[tid * (kPerThread + 1) + j] =
          __fmul_rn(__int2float_rn(static_cast<int>(r[j])), kScale);
    }
    __syncthreads();
    const long long base = static_cast<long long>(b) * kBlock;
    float* dst = out + static_cast<long long>(s) * n + base;
    const long long left = n - base;
#pragma unroll 4
    for (int j = 0; j < kPerThread; ++j) {
      const int i = j * kThreads + tid;
      if (i < left) dst[i] = f[i + (i >> 5)];
    }
  }
}

__global__ void __launch_bounds__(kScanThreads)
wire_stream_carries(const int* __restrict__ order, uint4* __restrict__ agg,
                    int nb) {
  __shared__ Sums warp_total[kScanThreads / 32];
  const int s = blockIdx.x;
  const int ord = order[s];
  if (ord < 1 || ord > 3) return;
  uint4* row = agg + static_cast<long long>(s) * nb;
  const int per = (nb + kScanThreads - 1) / kScanThreads;
  const int lo = min(nb, static_cast<int>(threadIdx.x) * per);
  const int hi = min(nb, lo + per);
  Sums mine = {0u, 0u, 0u, 0u};
  for (int j = lo; j < hi; ++j) {
    const uint4 a = row[j];
    mine = combine(mine, {static_cast<unsigned>(kBlock), a.x, a.y, a.z});
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const Sums inc = warp_inclusive(mine);
  Sums excl = shfl_up(inc, 1);
  if (lane == 0) excl = {0u, 0u, 0u, 0u};
  if (lane == 31) warp_total[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const Sums t = warp_inclusive(warp_total[lane]);
    __syncwarp();
    warp_total[lane] = t;
  }
  __syncthreads();
  Sums pre = warp > 0 ? warp_total[warp - 1] : Sums{0u, 0u, 0u, 0u};
  pre = combine(pre, excl);
  for (int j = lo; j < hi; ++j) {
    const uint4 a = row[j];
    row[j] = make_uint4(pre.a1, pre.a2, pre.a3, 0u);
    pre = combine(pre, {static_cast<unsigned>(kBlock), a.x, a.y, a.z});
  }
}

}  // namespace

// words: n_words int32; widths, woffs: (streams, nb) int32; order:
// (streams,) int32; agg: (streams, nb) x 4 uint32 scratch; out: (streams,
// n) float32, n <= nb * 4096.  Returns the CUDA error of the launches.
extern "C" int prt_wire_unpack(const void* words, long long n_words,
                               const int* widths, const int* woffs,
                               const int* order, void* agg, float* out,
                               int streams, int nb, long long n,
                               void* stream) {
  if (streams <= 0 || nb <= 0 || n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>(
      static_cast<long long>(streams) * nb);
  const unsigned* w = static_cast<const unsigned*>(words);
  uint4* a = static_cast<uint4*>(agg);
  wire_blocks<false><<<blocks, kThreads, 0, st>>>(w, n_words, widths, woffs,
                                                  order, a, out, n, nb);
  wire_stream_carries<<<streams, kScanThreads, 0, st>>>(order, a, nb);
  wire_blocks<true><<<blocks, kThreads, 0, st>>>(w, n_words, widths, woffs,
                                                 order, a, out, n, nb);
  return static_cast<int>(cudaGetLastError());
}
