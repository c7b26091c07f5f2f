// Shared-memory complex FFT of a one-partition overlap-add frame, with
// the spectrum product of a real transform packed into it: the device
// code that csrc/fused_conv.cu (one block a frame, parsiz 2048-16384) and
// csrc/hilbert32k.cu (a cluster of two blocks a frame, parsiz 32768)
// share.  The layout, the bank-conflict-free slots and the stage-major
// twiddle table are described at the top of csrc/fused_conv.cu.

#pragma once

#include <cuda_runtime.h>

namespace {

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

// The first entry of the radix-4 pass of span h in the stage-major
// twiddle table: the passes before it, of spans M/2, M/8, ..., 4h, hold
// half their span each, (M - 2h)/3 entries together.
__device__ __forceinline__ int pass_offset(int m, int log2h) {
  return (m - (2 << log2h)) / 3;
}

// Entries of the stage-major table: (M - 1) / 3 for every supported M.
__host__ __device__ __forceinline__ int table_len(int m) {
  return (m - 1) / 3;
}

// Forward (decimation in frequency): spans M/2, M/4, ..., 1.
__device__ void fft_dif(float2* z, const float4* tws, int log2m) {
  const int m = 1 << log2m;
  int log2h = log2m - 1;
  for (; log2h >= 1; log2h -= 2) {  // spans h and h/2 in one pass
    const int h = 1 << log2h, q = h >> 1;
    const float4* tw = tws + pass_offset(m, log2h);
    for (int g = threadIdx.x; g < (m >> 2); g += blockDim.x) {
      const int j = g & (q - 1);
      const int p0 = ((g >> (log2h - 1)) << (log2h + 1)) + j;
      const int p1 = p0 + q, p2 = p0 + h, p3 = p2 + q;
      const float2 a0 = z[slot(p0)], a1 = z[slot(p1)], a2 = z[slot(p2)],
                   a3 = z[slot(p3)];
      const float4 t = tw[j];
      const float2 wa = make_float2(t.x, t.y);  // W_2h^j
      const float2 wc = make_float2(t.z, t.w);  // W_h^j
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
__device__ void ifft_dit(float2* z, const float4* tws, int log2m) {
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
    const float4* tw = tws + pass_offset(m, log2h);
    for (int g = threadIdx.x; g < (m >> 2); g += blockDim.x) {
      const int j = g & (q - 1);
      const int p0 = ((g >> (log2h - 1)) << (log2h + 1)) + j;
      const int p1 = p0 + q, p2 = p0 + h, p3 = p2 + q;
      const float2 a0 = z[slot(p0)], a1 = z[slot(p1)], a2 = z[slot(p2)],
                   a3 = z[slot(p3)];
      const float4 t = tw[j];
      const float2 wa = conj(make_float2(t.x, t.y));
      const float2 wc = conj(make_float2(t.z, t.w));
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
// M-point spectrum whose inverse is y = irfft(Y) read as complex pairs,
// for one pair (k, M - k), k <= M/2: item u of the walk in bit-reversed
// position order.  Item u = 0 is position 0 (k = 0, with k = M), item
// u = M/2 is position 1 (k = M/2), and item u in [2^(b-1), 2^b) is the
// pair at positions u + 2^(b-1), in the lower half of [2^b, 2^(b+1)),
// and (u + 2^(b-1)) ^ (2^b - 1).  Of the two, k sits at the even one,
// since bitrev(p) < M/2 for even p, so every pair runs the arithmetic
// that thread k ran in the k-order walk.  h is H in position order
// (h[p] = H[bitrev(p)], h[M] = H[M]); wp[u] is W_N^k of item u.  z holds
// positions [off, off + its length) of the M-point spectrum (off a
// multiple of 64, so slot(p) - off = slot(p - off)), and both positions
// of item u lie there.
__device__ __forceinline__ void product_item(float2* z, const float2* h,
                                             const float2* wp, int m,
                                             int u, int off) {
  const int half = m >> 1;
  const float inv_n = 1.0f / static_cast<float>(2 * m);  // exact
  int pk = 0, pmk = 0;  // u = 0: k = 0
  if (u == half) {
    pk = pmk = 1;  // k = M/2 is its own partner
  } else if (u != 0) {
    const int hb = 1 << (31 - __clz(u)), flip = 2 * hb - 1;
    pk = u + hb;            // the pair's position in the lower half
    if (pk & 1) pk ^= flip;  // k = bitrev(pk) < M/2: the even position
    pmk = pk ^ flip;
  }
  float2* zk = z + slot(pk - off);
  float2* zmk = z + slot(pmk - off);
  const float2 a = *zk, b = conj(*zmk);
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
  *zk = make_float2(wk.x * inv_n, wk.y * inv_n);
  if (pmk != pk) {
    const float2 wmk = cadd(conj(p), mul_pj(conj(t)));
    *zmk = make_float2(wmk.x * inv_n, wmk.y * inv_n);
  }
}

// Frame f0 of the run of block b of ``grid`` over n_frames frames: runs
// differ by at most one frame.
__device__ __forceinline__ long long run_start(long long b,
                                               long long n_frames,
                                               long long grid) {
  return (b * n_frames) / grid;
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

}  // namespace
