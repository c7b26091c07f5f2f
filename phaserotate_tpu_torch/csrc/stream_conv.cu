// Partitioned FFT Hilbert convolution, with an optional rotation mix, for
// Hopper (sm_90a), in one pass that keeps the spectrum history on chip.
//
// Replaces: phaserotate_tpu/kernels/stream_conv.py _call / _make_kernel, the
// Pallas kernel behind fused_hilbert_small (conv-only mode: the Hilbert
// half of every analyzer sweep and apply) and fused_rotate_small /
// fused_stream_mix (mix mode: the FIR rotate and the streaming ramp).  It
// computes the linear convolution h = fir * x with the fir_taps-tap Hilbert
// FIR through a fixed 256-sample frame:
//   - the half spectrum X_f[0..256] of each frame f, zero padded to N = 512
//     points, as one M = 256-point complex FFT of the packed frame
//     z[n] = x[2n] + j*x[2n+1] plus an untangling step;
//   - the frequency-delay-line multiply-accumulate U_f = sum_s X_{f-s} F_s
//     over the ns = fir_taps / 256 partition spectra F_s, U_f packed into
//     the M-point spectrum whose inverse FFT, read as floats, is
//     y_f = irfft(U_f), and a one-frame overlap-add: h over frame f is
//     y_f[0, 256) + y_{f-1}[256, 512);
//   - mix mode: out[m] = cos(rad_m) * x[m - D*256] + sin(rad_m) * h[m] with
//     rad_m = 2*pi*(angle + slope*i) from per-frame (angle, slope) pairs.
// The TPU kernel multiplies every frame by dense DFT matrices on its
// matrix unit (_dft_consts); on CUDA cores (TF32 would break the 1e-5
// budget) that is ~1,030 multiply-adds per sample, and the FFT does each
// direction in ~14 k FP32 operations per frame, ~19x less.
//
// What bounds it on the card: the MAC and the transforms, both FP32 on
// CUDA cores, once the spectra stay on chip.  Per frame it needs some
// 28 k operations for the two transforms and 2 k per partition for the
// MAC (4 FMA per bin and partition), against 1 KiB of input read and
// 1 KiB of output written (2 KiB read in mix mode, for the dry signal).
//
// What the design does about it:
//   - One kernel, a persistent grid (the blocks resident on the card), as
//     the TPU kernel's sequential grid axis carries its history in VMEM
//     (stream_conv.py:141-170).  The output frames of all rows, flattened
//     (row, frame), are cut into one contiguous run per block.  A run is
//     walked one segment per row it touches; a segment restarts the
//     history, so a run crosses a row boundary only by resetting it.
//   - The history lives in shared memory: a ring of R = ns - 1 + 16
//     spectrum rows of 258 float2 (2,064 bytes: 256 positions in slot
//     order, a pad, the Nyquist bin), 35 KiB at ns = 2, 97 KiB at 32,
//     163 KiB at 64.  Frame F sits in ring row (F - base) mod R.  A
//     segment first fills ns - 1 rows (the warm-up: the frames before its
//     first, zero rows for frames before the stream's start), then walks
//     tiles of 16 frames.  Its first frame is the one before its first
//     output frame: that frame's output is dropped and only its tail kept,
//     the one frame a run computes twice (no separate fix-up launch).
//   - Per tile: the forward FFT of the new frames in place in their ring
//     rows (the input read in place from (rows, n) at any row stride,
//     zeros past n; float2 loads where the row is 8-byte aligned and the
//     frame lies inside n, else scalar loads with bounds), the untangling
//     in place; the MAC read from the ring; the packing into the ring rows
//     of the tile's 16 oldest frames, which no later tile reads; the
//     inverse FFT there; the overlap-add with the tail of the frame before,
//     which the first half of the output threads carries in a register
//     from tile to tile.  No spectrum leaves the chip, and the wrapper
//     makes no framed copy: rotate_small's output is written time-aligned,
//     (rows, n) directly.
//   - The transforms are csrc/fused_conv.cu's at M = 256 as a compile-time
//     constant: forward decimation in frequency (natural order in,
//     bit-reversed out), inverse decimation in time (bit-reversed in,
//     natural out), four radix-4 passes each, in place in shared memory,
//     element i of a frame in slot(i) so that every pass access is one
//     wavefront per half-warp.  The upper half of a packed frame is zero,
//     so the first forward pass reads its two live inputs straight from
//     device memory.  Each pass loads all of a thread's frames before it
//     computes, and reads its twiddles from a stage-major table (one
//     contiguous float4 per butterfly, kPassTw entries) copied once per
//     block from the 512-entry (cos, sin)(2*pi*i/512) table.
//   - Spectra are kept in bit-reversed position order: position p < 256
//     holds bin bitrev(p) (in ring slot(p)), entry 257 the Nyquist bin.
//     The wrapper permutes the FIR partitions into the same position
//     order.  The MAC is per bin, so nothing of its arithmetic changes;
//     the order lets the threads of one pair of bins (k, M - k) at
//     positions (pk, pmk) work from the untangling to the packing
//     (fused_conv's position walk) with conflict-free shared memory.
//   - Thread roles, 544 threads (17 warps): in the FFT passes threads
//     < 512 are 8 groups of M/4 = 64 butterflies, two frames each; in the
//     untangling they take item u = t % 128 of 4 frames; in the MAC item
//     u = t % 128 of 8 frames, bin k below thread 256 and bin M - k above,
//     and warp 16 takes item 128 (k = M/2), whose two bins are one; in the
//     output each of threads < 512 writes one sample of 8 frames.
//   - The MAC: each thread sums its 8 frames over the partitions in
//     explicit fmaf chains from zero, s ascending, 4 FMA per complex
//     multiply-add, one ring entry loaded per step into a window of
//     registers and F_s through the read-only cache two steps ahead (the
//     wrapper appends two zero partitions, so the look-ahead needs no
//     check); the sums of bin M - k then wait in the oldest rows for the
//     thread of bin k, which packs both.  Registers are sized for two
//     blocks per SM (56) where two rings fit in shared memory (ns <= 38),
//     else for one (95-96).
//   - Arithmetic is that of the two-pass kernel it replaces: the same
//     butterflies, untangling, MAC order, packing and overlap-add, and the
//     same twiddle values.  The complex product rounds one product and
//     fuses the other (cmul), as the source says, not as the compiler
//     picks per call site: the outputs differ from the earlier kernel's by
//     that choice (within 1.2e-6), and do not depend on the grid.  The
//     imaginary parts of the DC and Nyquist bins are exact zeros from the
//     untangling and dropped before the inverse, as irfft drops them.  Mix
//     mode rounds cos*dry + sin*h with __fmul_rn / __fadd_rn like the
//     plain PyTorch version and takes one sincosf per frame where the
//     angle's slope is 0 (then every sample's angle is the same float);
//     sincosf is full precision (no fast math).  All arithmetic is FP32 on
//     CUDA cores: nothing at TF32.
//   - The grid is 1-D and runs are long long, so any number of rows fits
//     one launch.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kP = 256;            // samples per frame; M, the FFT points
constexpr int kLog2M = 8;
constexpr int kFftLen = 2 * kP;    // N, the zero-padded real transform
constexpr int kBins = kP + 2;      // spectrum row: positions, pad, Nyquist
// The ring entry of the Nyquist bin: bank pair 1 of its row, the one that
// no other item of its half-warp reads in the walk of the bins M - k
constexpr int kNyquist = kP + 1;
constexpr int kPairs = kP / 2;     // pair items u < 128; item 128 is k = M/2
constexpr int kThreads = 544;      // 17 warps
constexpr int kFftThreads = 512;   // 8 groups of M/4 = 64 butterflies
constexpr int kGroups = kFftThreads / (kP / 4);
constexpr int kTile = 16;          // frames per tile
constexpr int kHalf = kTile / 2;   // frames per MAC thread
constexpr int kQuarter = kTile / 4;  // frames per untangling thread
constexpr int kAhead = 1;          // MAC steps a ring load runs ahead
constexpr int kMinNs = 2;
constexpr int kMaxNs = 64;
constexpr float kTwoPi = 6.28318530717958647692f;

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
// a * b, each part one rounded product and one FMA, as the source fixes
// them: the compiler fuses no other product, so a frame's bits do not
// depend on which unrolled copy of a loop computes it
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(__fmaf_rn(a.x, b.x, -__fmul_rn(a.y, b.y)),
                     __fmaf_rn(a.x, b.y, __fmul_rn(a.y, b.x)));
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

// The ring row of the tile's frame f, the tile's first frame in row r0
// (r0 < R and f < R, so one subtraction wraps it).
__device__ __forceinline__ float2* ring_row(float2* ring, int r0, int f,
                                            int R) {
  int r = r0 + f;
  if (r >= R) r -= R;
  return ring + r * kBins;
}

// The radix-4 passes' twiddles, stage-major: the pass of larger span
// 2^log2h (log2h = 1, 3, 5, 7) holds, from entry pass_off(log2h), one
// float4 (cos, sin)(2*pi*j/2h), (cos, sin)(2*pi*j/h) for each j <
// 2^(log2h - 1), so a warp reads them contiguously.  They are the
// 512-entry table's entries j * 256/h and 2j * 256/h, copied.
constexpr int kPassTw = 1 + 4 + 16 + 64;
__device__ __forceinline__ int pass_off(int log2h) {
  return ((1 << (log2h - 1)) - 1) / 3;
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

// The untangling's pair item and first frame of thread t: threads < 512
// take item t % 128 of the 4 frames of quarter t / 128; warp 16's lanes
// 0, 8, 16 and 24 take item 128 (their frames 4 rows apart, so their
// accesses to position 1 fall in other bank pairs).  Returns false for
// the idle lanes.
__device__ __forceinline__ bool untangle_role(int t, int& u, int& fb) {
  if (t < 4 * kPairs) {
    u = t & (kPairs - 1);
    fb = (t >> 7) * kQuarter;
    return true;
  }
  u = kPairs;
  fb = ((t - 4 * kPairs) >> 3) * kQuarter;
  return ((t - 4 * kPairs) & 7) == 0;
}

// The MAC's pair item, first frame and bin of thread t: threads < 512
// take item t % 128 of the 8 frames of half (t / 128) % 2, bin k below
// thread 256 and bin M - k above (``upper``); warp 16's lanes 0 and 16
// (one per half-warp) take item 128, whose two bins are one.  Returns
// false for the idle lanes.
__device__ __forceinline__ bool mac_role(int t, int& u, int& fb,
                                         bool& upper) {
  if (t < 4 * kPairs) {
    u = t & (kPairs - 1);
    fb = ((t >> 7) & 1) * kHalf;
    upper = t >= 2 * kPairs;
    return true;
  }
  u = kPairs;
  fb = ((t - 4 * kPairs) >> 4) * kHalf;
  upper = false;
  return ((t - 4 * kPairs) & 15) == 0;
}

// A thread's frames in an FFT pass: f = lo + g + kGroups * i for its
// group g = t / 64 and i < kPerThread, those below cnt.  Each pass loads
// all of them before it computes, so their loads overlap.
constexpr int kPerThread = kTile / kGroups;

// Forward passes 2-4 (larger spans 32, 8, 2) over frames [lo, cnt) of
// the tile whose frame 0 is ring row r0.
__device__ void dif_passes(float2* ring, int r0, int lo, int cnt, int R,
                           const float4* tw_p) {
  const int t = threadIdx.x, g = t & (kP / 4 - 1);
  for (int log2h = kLog2M - 3; log2h >= 1; log2h -= 2) {
    if (t < kFftThreads) {
      const int q = 1 << (log2h - 1), h = 2 * q;
      const int j = g & (q - 1);
      const int p0 = ((g >> (log2h - 1)) << (log2h + 1)) + j;
      const int s0 = slot(p0), s1 = slot(p0 + q), s2 = slot(p0 + h),
                s3 = slot(p0 + h + q);
      const float4 tw = tw_p[pass_off(log2h) + j];
      const float2 wa = make_float2(tw.x, -tw.y);  // W_2h^j
      const float2 wc = make_float2(tw.z, -tw.w);  // W_h^j
      float2* zf[kPerThread];
      float2 a0[kPerThread], a1[kPerThread], a2[kPerThread], a3[kPerThread];
#pragma unroll
      for (int i = 0; i < kPerThread; ++i) {
        const int f = lo + t / (kP / 4) + kGroups * i;
        zf[i] = ring_row(ring, r0, f < cnt ? f : lo, R);
        a0[i] = zf[i][s0];
        a1[i] = zf[i][s1];
        a2[i] = zf[i][s2];
        a3[i] = zf[i][s3];
      }
#pragma unroll
      for (int i = 0; i < kPerThread; ++i) {
        if (lo + t / (kP / 4) + kGroups * i < cnt) {
          const float2 x0 = cadd(a0[i], a2[i]);
          const float2 d0 = cmul(csub(a0[i], a2[i]), wa);
          // W_2h^(j + h/2) = -j * W_2h^j
          const float2 x1 = cadd(a1[i], a3[i]);
          const float2 d1 = cmul(mul_mj(csub(a1[i], a3[i])), wa);
          zf[i][s0] = cadd(x0, x1);
          zf[i][s1] = cmul(csub(x0, x1), wc);
          zf[i][s2] = cadd(d0, d1);
          zf[i][s3] = cmul(csub(d0, d1), wc);
        }
      }
    }
    __syncthreads();
  }
}

// Inverse, unnormalized: spans 1, 2, ..., 128 in four radix-4 passes over
// frames [0, cnt) of the tile whose frame 0 is ring row r0.
__device__ void dit_passes(float2* ring, int r0, int cnt, int R,
                           const float4* tw_p) {
  const int t = threadIdx.x, g = t & (kP / 4 - 1);
  for (int log2h = 1; log2h < kLog2M; log2h += 2) {
    if (t < kFftThreads) {
      const int q = 1 << (log2h - 1), h = 2 * q;
      const int j = g & (q - 1);
      const int p0 = ((g >> (log2h - 1)) << (log2h + 1)) + j;
      const int s0 = slot(p0), s1 = slot(p0 + q), s2 = slot(p0 + h),
                s3 = slot(p0 + h + q);
      const float4 tw = tw_p[pass_off(log2h) + j];
      const float2 wa = make_float2(tw.x, tw.y);  // conj(W_2h^j)
      const float2 wc = make_float2(tw.z, tw.w);  // conj(W_h^j)
      float2* zf[kPerThread];
      float2 a0[kPerThread], a1[kPerThread], a2[kPerThread], a3[kPerThread];
#pragma unroll
      for (int i = 0; i < kPerThread; ++i) {
        const int f = t / (kP / 4) + kGroups * i;
        zf[i] = ring_row(ring, r0, f < cnt ? f : 0, R);
        a0[i] = zf[i][s0];
        a1[i] = zf[i][s1];
        a2[i] = zf[i][s2];
        a3[i] = zf[i][s3];
      }
#pragma unroll
      for (int i = 0; i < kPerThread; ++i) {
        if (t / (kP / 4) + kGroups * i < cnt) {
          const float2 t1 = cmul(a1[i], wc), t3 = cmul(a3[i], wc);
          const float2 x0 = cadd(a0[i], t1), x1 = csub(a0[i], t1);
          const float2 x2 = cadd(a2[i], t3), x3 = csub(a2[i], t3);
          const float2 u = cmul(x2, wa);
          // conj(W_2h^(j + h/2)) = +j * conj(W_2h^j)
          const float2 v = cmul(mul_pj(x3), wa);
          zf[i][s0] = cadd(x0, u);
          zf[i][s2] = csub(x0, u);
          zf[i][s1] = cadd(x1, v);
          zf[i][s3] = csub(x1, v);
        }
      }
    }
    __syncthreads();
  }
}

// Sample i of a row of n samples, zero at and past n.
__device__ __forceinline__ float sample(const float* xr, long long i,
                                        long long n) {
  return i < n ? __ldg(xr + i) : 0.f;
}

// The spectra of stream frames F0 .. F0 + cnt - 1 of row xr into ring rows
// r0 .. r0 + cnt - 1 (mod R): zero rows for frames before the stream's
// start, else the forward FFT of the frame read in place and its
// untangling.  Starts with a barrier (the rows may still be read) and
// ends with one.
__device__ void forward(float2* ring, int r0, int cnt, int R, long long F0,
                        const float* xr, long long n, bool aligned,
                        const float2* tw_s, const float4* tw_p) {
  const int t = threadIdx.x;
  // frames [0, lo) of the chunk lie before the stream: zero rows, no FFT
  const int lo = F0 >= 0 ? 0 : (-F0 < cnt ? static_cast<int>(-F0) : cnt);
  __syncthreads();
  for (int f = 0; f < lo; ++f) {
    if (t < kBins) ring_row(ring, r0, f, R)[t] = make_float2(0.f, 0.f);
  }
  if (lo == cnt) {  // block-uniform
    __syncthreads();
    return;
  }

  // pass 1 of the DIF (span 128): z[n] = (x[2n], x[2n+1]) for n < 128 and
  // zero above, so butterfly j reads a0 = z[j] and a1 = z[j + 64] from
  // device memory and a2 = a3 = 0
  if (t < kFftThreads) {
    const int j = t & (kP / 4 - 1);
    const float4 tw = tw_p[pass_off(kLog2M - 1) + j];
    const float2 wa = make_float2(tw.x, -tw.y);  // W_512^(2j)
    const float2 wc = make_float2(tw.z, -tw.w);  // W_512^(4j)
    float2 a0[kPerThread], a1[kPerThread];
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {  // all loads first
      const int f = lo + t / (kP / 4) + kGroups * i;
      const long long s0 = (F0 + f) * kP;  // the frame's first sample
      if (f >= cnt) {
        a0[i] = a1[i] = make_float2(0.f, 0.f);
      } else if (aligned && s0 + kP <= n) {
        const float2* src = reinterpret_cast<const float2*>(xr + s0);
        a0[i] = __ldg(src + j);
        a1[i] = __ldg(src + j + kP / 4);
      } else {
        a0[i] = make_float2(sample(xr, s0 + 2 * j, n),
                            sample(xr, s0 + 2 * j + 1, n));
        a1[i] = make_float2(sample(xr, s0 + 2 * j + kP / 2, n),
                            sample(xr, s0 + 2 * j + kP / 2 + 1, n));
      }
    }
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int f = lo + t / (kP / 4) + kGroups * i;
      if (f < cnt) {
        float2* zf = ring_row(ring, r0, f, R);
        const float2 d0 = cmul(a0[i], wa), d1 = cmul(mul_mj(a1[i]), wa);
        zf[slot(j)] = cadd(a0[i], a1[i]);
        zf[slot(j + kP / 4)] = cmul(csub(a0[i], a1[i]), wc);
        zf[slot(j + kP / 2)] = cadd(d0, d1);
        zf[slot(j + 3 * kP / 4)] = cmul(csub(d0, d1), wc);
      }
    }
  }
  __syncthreads();
  dif_passes(ring, r0, lo, cnt, R, tw_p);

  // untangle Z into X: X[k] = E + W_N^k O, X[M-k] = conj(E - W_N^k O) with
  // E = (Z[k] + conj(Z[M-k])) / 2, O = -j (Z[k] - conj(Z[M-k])) / 2, in
  // place: each pair's positions belong to one thread
  int u, fb;
  if (untangle_role(t, u, fb)) {
    int pk, pmk;
    pair_positions(u, pk, pmk);
    const float2 w = w512(tw_s, bitrev8(pk));
#pragma unroll
    for (int i = 0; i < kQuarter; ++i) {
      const int f = fb + i;
      if (f >= lo && f < cnt) {
        float2* zf = ring_row(ring, r0, f, R);
        // items 0 and 128 hold one position: no second load, whose bank
        // pair item 13's partner uses
        const float2 a = zf[slot(pk)];
        float2 c = a;
        if (pmk != pk) c = zf[slot(pmk)];
        c = conj(c);
        const float2 e = make_float2(0.5f * (a.x + c.x), 0.5f * (a.y + c.y));
        const float2 o = mul_mj(make_float2(0.5f * (a.x - c.x),
                                            0.5f * (a.y - c.y)));
        if (u == 0) {  // X[0] = E + O and X[M] = E - O are real
          zf[slot(0)] = make_float2(e.x + o.x, 0.f);
          zf[kNyquist] = make_float2(e.x - o.x, 0.f);
        } else {
          const float2 wo = cmul(w, o);
          zf[slot(pk)] = cadd(e, wo);
          if (pmk != pk) zf[slot(pmk)] = conj(csub(e, wo));
        }
      }
    }
  }
  __syncthreads();
}

// The sums U of one bin (ring entry e, FIR position q) for the thread's
// kHalf frames: frame fb + i of the tile (ring row r0 + fb + i) sums
// X_{F-s} F_s over s < ns.  Step s adds frame fb + i - s into sum i; the
// registers hold a window of kW = kHalf + kAhead frames, and step s loads
// the frame that step s + kAhead first needs into the register of the
// frame that has just left the window; F_s rides a ring of kFRegs
// registers, loaded kFRegs - 1 steps ahead.  The steps run in unrolled
// blocks of kW (a multiple of kFRegs), so every register index is a
// constant and no register moves; the full blocks check nothing (the
// ring rows a late load reads are valid, and ``fir`` holds two zero
// partitions past ns), the last partial block checks s < ns.
constexpr int kW = kHalf + kAhead;
constexpr int kFRegs = 3;
static_assert(kW % kFRegs == 0, "F's register ring must tile the block");

template <bool kCheck>
__device__ __forceinline__ void mac_step(
    int j, int s, int ns, float2 (&x)[kW], float2 (&g)[kFRegs],
    float2 (&y)[kHalf], const float2* xe, int& r, int R,
    const float2* __restrict__ fq) {
  if (kCheck && s >= ns) return;
  x[(kW - (j + kAhead) % kW) % kW] = xe[r * kBins];
  r = r == 0 ? R - 1 : r - 1;
  g[(j + kFRegs - 1) % kFRegs] = __ldg(fq + (s + kFRegs - 1) * kBins);
  const float2 gs = g[j % kFRegs];
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    y[i] = cmac(y[i], x[(i - j + kW) % kW], gs);
  }
}

__device__ __forceinline__ void mac_bin(const float2* ring, int r0, int fb,
                                        int R, int e, int q, int ns,
                                        const float2* __restrict__ fir,
                                        float2 (&y)[kHalf]) {
  const float2* xe = ring + e;
  float2 x[kW], g[kFRegs];
  int r = r0 + fb + 1 - kAhead;  // the row of the first frame loaded
  if (r >= R) r -= R;
#pragma unroll
  for (int i = 1 - kAhead; i < kHalf; ++i) {
    x[(i + kW) % kW] = xe[r * kBins];
    if (++r == R) r = 0;
  }
  // the row of the frame step s = 0 loads: fb - kAhead
  r = r0 + fb - kAhead;
  if (r < 0) r += R;
  if (r >= R) r -= R;
  const float2* fq = fir + q;
#pragma unroll
  for (int i = 0; i < kFRegs - 1; ++i) g[i] = __ldg(fq + i * kBins);
#pragma unroll
  for (int i = 0; i < kHalf; ++i) y[i] = make_float2(0.f, 0.f);
  int s0 = 0;
  for (; s0 + kW <= ns; s0 += kW) {
#pragma unroll
    for (int j = 0; j < kW; ++j) {
      mac_step<false>(j, s0 + j, ns, x, g, y, xe, r, R, fq);
    }
  }
#pragma unroll
  for (int j = 0; j < kW - 1; ++j) {
    mac_step<true>(j, s0 + j, ns, x, g, y, xe, r, R, fq);
  }
}

// One run per block over the flattened (row, output frame) space of
// ``total`` frames: frames f0 = (b * total) / grid, runs differ by at most
// one frame.
__device__ __forceinline__ long long run_start(long long b, long long total,
                                               long long grid) {
  return (b * total) / grid;
}

// Output frame o of a row is stream frame o + d_out; its samples go to
// out[row * out_ld + o * 256 + m] below out_len.  Stream frame F reads
// input samples [F * 256, F * 256 + 256) of its row (zeros at and past n)
// and, in mix mode, its dry samples from input frame F - d_dry and its
// (angle, slope) from angs[row * ang_ld + F * ang_fs].
// kBlocks: the blocks per SM the registers are sized for (two where two
// rings fit in shared memory, else one with registers to spare).
template <bool kMix, int kBlocks>
__global__ void __launch_bounds__(kThreads, kBlocks)
stream_runs(const float* __restrict__ x, long long x_ld, long long n,
            const float2* __restrict__ fir,
            const float2* __restrict__ twiddle,
            const float2* __restrict__ angs, long long ang_ld,
            long long ang_fs, float* __restrict__ out, long long out_ld,
            long long out_len, int n_out, long long total, int ns,
            int d_out, int d_dry) {
  extern __shared__ float2 smem[];
  const int R = ns - 1 + kTile;
  float2* ring = smem;
  float2* tw_s = ring + R * kBins;
  float2* ang_s = tw_s + kFftLen;  // mix: (angle, slope) of tile frame f
  float2* sc_s = ang_s + kTile;    // mix: (sin, cos) where the slope is 0
  float4* tw_p = reinterpret_cast<float4*>(sc_s + kTile);
  const int t = threadIdx.x;
  for (int i = t; i < kFftLen; i += kThreads) tw_s[i] = twiddle[i];
  if (t < kPassTw) {
    const int log2h = t < 1 ? 1 : (t < 5 ? 3 : (t < 21 ? 5 : 7));
    const int j = t - pass_off(log2h);
    const float2 a = twiddle[j << (kLog2M - log2h)];
    const float2 b = twiddle[(2 * j) << (kLog2M - log2h)];
    tw_p[t] = make_float4(a.x, a.y, b.x, b.y);
  }
  // (the first forward stage's barrier publishes the table)

  int u = 0, fb = 0, pk = 0, pmk = 0;
  bool upper = false;
  const bool macs = mac_role(t, u, fb, upper);
  pair_positions(u, pk, pmk);
  // the ring entry of X[M - k], where the sums of bin M - k also wait
  const int emk = u == 0 ? kNyquist : slot(pmk);
  // this thread's bin: its ring entry and FIR position
  const int e = upper ? emk : slot(pk);
  const int q = upper ? (u == 0 ? kP : pmk) : pk;
  const float inv_n = 1.0f / static_cast<float>(kFftLen);  // exact
  const int m = t & (kP - 1);  // output sample of the frame
  const int head = 2 * slot(m >> 1) + (m & 1);           // y[m]
  const int tail = 2 * slot(kP / 2 + (m >> 1)) + (m & 1);  // y[256 + m]

  const long long g1 = run_start(blockIdx.x + 1, total, gridDim.x);
  for (long long g = run_start(blockIdx.x, total, gridDim.x); g < g1;) {
    const long long row = g / n_out;
    const int o0 = static_cast<int>(g - row * n_out);
    const int o1 = g1 - row * n_out < n_out
                       ? static_cast<int>(g1 - row * n_out) : n_out;
    g = row * n_out + o1;
    const float* xr = x + row * x_ld;
    const bool aligned = (reinterpret_cast<uintptr_t>(xr) & 7) == 0;
    // stream frames [fs, fe): fs's output is dropped, only its tail kept
    const long long fs = static_cast<long long>(o0) + d_out - 1;
    const long long fe = static_cast<long long>(o1) + d_out;

    // warm-up: the ns - 1 frames before fs into rows 0 .. ns - 2
    int r0 = 0;
    for (long long w = fs - (ns - 1); w < fs; w += kTile) {
      const int cnt = fs - w < kTile ? static_cast<int>(fs - w) : kTile;
      forward(ring, r0, cnt, R, w, xr, n, aligned, tw_s, tw_p);
      r0 += cnt;
    }

    float carry = 0.f;  // y[256 + m] of the frame before the tile
    for (long long F0 = fs; F0 < fe; F0 += kTile) {
      const int cnt = fe - F0 < kTile ? static_cast<int>(fe - F0) : kTile;
      forward(ring, r0, cnt, R, F0, xr, n, aligned, tw_s, tw_p);
      if (kMix && t < cnt) {
        const long long F = F0 + t;
        const float2 a = F >= 0 ? angs[row * ang_ld + F * ang_fs]
                                : make_float2(0.f, 0.f);
        ang_s[t] = a;
        if (a.y == 0.f) {  // rad_m below is the same float for every m
          float sn, cs;
          sincosf(__fmul_rn(__fadd_rn(a.x, __fmul_rn(a.y, 0.f)), kTwoPi),
                  &sn, &cs);
          sc_s[t] = make_float2(sn, cs);
        }
      }
      // the MAC: the tile's frame f in ring row r0 + f, frame f - s in
      // row r0 + f - s (mod R)
      float2 y[kHalf];
      if (macs) mac_bin(ring, r0, fb, R, e, q, ns, fir, y);
      // the tile's 16 oldest ring rows (frames F0 - ns + 1 + f) are read
      // by no later tile: the packed spectra and the inverse go there
      const int rz = r0 + kTile < R ? r0 + kTile : r0 + kTile - R;
      __syncthreads();
      if (macs && upper) {  // the sums of bin M - k wait there
#pragma unroll
        for (int i = 0; i < kHalf; ++i) {
          if (fb + i < cnt) ring_row(ring, rz, fb + i, R)[emk] = y[i];
        }
      }
      __syncthreads();
      if (macs && !upper) {
        // pack Y = U / N into the M-point spectrum W of the inverse:
        // W[k] = P + j*T, W[M-k] = conj(P) + j*conj(T) with
        // P = Y[k] + conj(Y[M-k]), T = W_N^-k (Y[k] - conj(Y[M-k]))
        const float2 wn = tw_s[bitrev8(pk)];  // W_N^-k
#pragma unroll
        for (int i = 0; i < kHalf; ++i) {
          const int f = fb + i;
          if (f < cnt) {
            float2* zf = ring_row(ring, rz, f, R);
            float2 a = y[i], c = u == kPairs ? y[i] : zf[emk];
            if (u == 0) a.y = c.y = 0.f;  // irfft drops Im U[0] and Im U[M]
            const float2 p = cadd(a, conj(c));
            const float2 t2 = cmul(wn, csub(a, conj(c)));
            zf[slot(pk)] = scale(cadd(p, mul_pj(t2)), inv_n);
            if (pmk != pk) {
              zf[slot(pmk)] = scale(cadd(conj(p), mul_pj(conj(t2))), inv_n);
            }
          }
        }
      }
      __syncthreads();
      dit_passes(ring, rz, cnt, R, tw_p);

      if (t < 2 * kP) {
        // thread (m, t / 256) writes frames fo .. fo + 7 of the tile; the
        // tail before frame 8 is still in its row, the one before frame 0
        // in the first half's carry
        const int fo = (t >> 8) * kHalf;
        // frame fo + i's output sample sits at p0 + i * 256 of the row,
        // its dry sample at d0 + i * 256 of the input row; frames i in
        // [w_lo, w_hi) are written (not the segment's first, not past
        // out_len), frames in [d_lo, d_hi) have a dry sample
        const long long p0 = (F0 + fo - d_out) * kP + m;
        const long long d0 = (F0 + fo - d_dry) * kP + m;
        const int live = cnt - fo;
        const int w_lo = F0 + fo > fs ? 0 : 1;
        const int w_hi = out_len - p0 >= static_cast<long long>(live) * kP
                             ? live
                             : static_cast<int>((out_len - p0 + kP - 1) / kP);
        const int d_lo = d0 >= 0 ? 0 : static_cast<int>((kP - 1 - d0) / kP);
        const int d_hi =
            n - d0 >= static_cast<long long>(live) * kP ? live
            : n > d0 ? static_cast<int>((n - d0 + kP - 1) / kP)
                     : 0;
        // mix: the dry samples, all loads first (input frames a tile or
        // two back, most in cache)
        float dry[kHalf];
        if (kMix) {
#pragma unroll
          for (int i = 0; i < kHalf; ++i) {
            dry[i] = i >= d_lo && i < d_hi ? __ldg(xr + d0 + i * kP) : 0.f;
          }
        }
        float tl = fo == 0 ? carry
                           : reinterpret_cast<const float*>(
                                 ring_row(ring, rz, fo - 1, R))[tail];
        float* orow = out + row * out_ld;
#pragma unroll
        for (int i = 0; i < kHalf; ++i) {
          const int f = fo + i;
          if (i < live) {
            const float* zf =
                reinterpret_cast<const float*>(ring_row(ring, rz, f, R));
            // head of this frame + tail of the frame before
            const float h = zf[head] + tl;
            tl = zf[tail];
            if (i >= w_lo && i < w_hi) {
              float y = h;
              if (kMix) {
                const float2 a = ang_s[f];
                float sn, cs;
                if (a.y == 0.f) {
                  sn = sc_s[f].x;
                  cs = sc_s[f].y;
                } else {
                  const float rad = __fmul_rn(
                      __fadd_rn(a.x, __fmul_rn(a.y, static_cast<float>(m))),
                      kTwoPi);
                  sincosf(rad, &sn, &cs);
                }
                y = __fadd_rn(__fmul_rn(cs, dry[i]), __fmul_rn(sn, h));
              }
              orow[p0 + i * kP] = y;
            }
          }
        }
        if (fo == 0) {  // the tail of the tile's last frame
          carry = reinterpret_cast<const float*>(
              ring_row(ring, rz, cnt - 1, R))[tail];
        }
      }
      r0 = r0 + cnt < R ? r0 + cnt : r0 + cnt - R;
    }
  }
}

using RunKernel = void (*)(const float*, long long, long long, const float2*,
                           const float2*, const float2*, long long, long long,
                           float*, long long, long long, int, long long, int,
                           int, int);

// The kernel of one mode with its shared memory for ns partitions allowed:
// the two-block build where two rings fit on an SM, else the one-block.
cudaError_t run_kernel(int ns, bool mix, RunKernel* fn, size_t* smem) {
  *smem = (static_cast<size_t>(ns - 1 + kTile) * kBins + kFftLen +
           2 * kTile) * sizeof(float2) + kPassTw * sizeof(float4);
  int device = 0, per_sm = 0, reserved = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        &per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, device);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        &reserved, cudaDevAttrReservedSharedMemoryPerBlock, device);
  }
  if (err != cudaSuccess) return err;
  const bool two = 2 * (*smem + reserved) <= static_cast<size_t>(per_sm);
  *fn = mix ? (two ? stream_runs<true, 2> : stream_runs<true, 1>)
            : (two ? stream_runs<false, 2> : stream_runs<false, 1>);
  return cudaFuncSetAttribute(*fn,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*smem));
}

}  // namespace

// The kernel's launch geometry on the current device for ns partitions
// and mode: info = {blocks resident on the whole card at once (the grid
// of a persistent launch), threads per block, registers per thread,
// local memory bytes per thread (spills), dynamic shared memory bytes}.
extern "C" int prt_stream_conv_grid(int ns, int mix, int* info) {
  if (ns < kMinNs || ns > kMaxNs) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  RunKernel fn;
  size_t smem;
  cudaError_t err = run_kernel(ns, mix != 0, &fn, &smem);
  int per_sm = 0, device = 0, sms = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn,
                                                        kThreads, smem);
  }
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  info[0] = per_sm * sms;
  info[1] = kThreads;
  info[2] = attr.numRegs;
  info[3] = static_cast<int>(attr.localSizeBytes);
  info[4] = static_cast<int>(smem);
  return 0;
}

// x: rows of n samples at row stride x_ld floats; fir (ns + 2, 258)
// float2 partition spectra in position order, two zero partitions last;
// twiddle (512) (cos, sin); angs (angle, slope) float2 at row stride
// ang_ld and frame stride ang_fs, or NULL for conv mode; out: rows at
// row stride out_ld, n_out frames each (output frame o is stream frame
// o + d_out), samples below out_len written; d_dry: the dry signal's
// delay in frames (mix mode).  grid in [1, rows * n_out] blocks, each one
// run of frames (the card's resident blocks for speed: any grid gives
// the same output).
extern "C" int prt_stream_conv(const float* x, long long x_ld, long long n,
                               const float* fir, const float* twiddle,
                               const float* angs, long long ang_ld,
                               long long ang_fs, float* out, long long out_ld,
                               long long out_len, int rows, int n_out, int ns,
                               int d_out, int d_dry, int grid, void* stream) {
  if (rows <= 0 || n_out <= 0) return 0;
  const long long total = static_cast<long long>(rows) * n_out;
  if (total > 0x7fffffffLL || ns < kMinNs || ns > kMaxNs || n < 0 ||
      d_out < 0 || d_dry < 0 || out_len > static_cast<long long>(n_out) * kP ||
      grid < 1 || grid > total) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  RunKernel fn;
  size_t smem;
  cudaError_t err = run_kernel(ns, angs != nullptr, &fn, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fn<<<grid, kThreads, smem, st>>>(
      x, x_ld, n, reinterpret_cast<const float2*>(fir),
      reinterpret_cast<const float2*>(twiddle),
      reinterpret_cast<const float2*>(angs), ang_ld, ang_fs, out, out_ld,
      out_len, n_out, total, ns, d_out, d_dry);
  return static_cast<int>(cudaGetLastError());
}
