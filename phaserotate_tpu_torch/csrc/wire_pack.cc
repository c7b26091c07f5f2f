// Host packer of the packed wire transport (search/packed.py).
//
// The wire: each int16 stream's fixed-order residual (the k-th iterated
// first difference, k = 0..3, zeros before the first sample and after
// the last), packed at each 4096-sample block's minimal signed width,
// little-endian (sample i of a block in bits [i*w, (i+1)*w)), into int32
// words, blocks in (stream, block) order and each word-aligned.  A stream
// takes the order of least total width, the first minimum winning.  These
// are the words, widths, offsets and orders of packed.py's numpy pack and
// of native/wire_pack.cc, bit for bit.
//
// The pack is block-local, in two passes over the int16 source with
// nothing the size of a stream in between:
//
//   prt_wire_widths  loads each block with the three samples before it
//                    into a block-sized buffer (it stays in L1), forms the
//                    residuals of all four orders in registers and takes
//                    their widths in the same loop; then chooses each
//                    stream's order and lays out every block's word offset.
//   prt_wire_words   loads each block again, forms its stream's order and
//                    bit-packs it at the block's width, with a packer
//                    specialised for that width, at the block's offset.
//
// The caller sees the total between the two passes, so a pack over its
// budget stops before it writes a word.  Blocks are independent in both
// passes: `workers` threads take runs of blocks from a shared counter.
// The loops are vectorised for AVX2 and for the x86-64 baseline, chosen
// when the library loads; the arithmetic is integer, so both give the
// same words.
//
// Build (search/_wirepack.py does this at the first pack of a process):
//   c++ -std=c++17 -O3 -fPIC -shared -pthread -o libprt_wire.so wire_pack.cc

#include <array>
#include <atomic>
#include <cstdint>
#include <system_error>
#include <thread>
#include <utility>
#include <vector>

namespace {

constexpr int kBlock = 4096;   // packed.py BLOCK
constexpr int kOrders = 4;     // packed.py MAX_ORDER + 1
constexpr int kHistory = 3;    // samples before a block that order 3 reads
constexpr int64_t kRun = 16;   // most blocks a worker takes at a time

#if defined(__x86_64__) && defined(__GNUC__)
#define PRT_CLONES __attribute__((target_clones("avx2", "default")))
#else
#define PRT_CLONES
#endif

// buf[0..2] = the three samples before block `start`, buf[3..] its 4096
// samples; zeros outside [0, n).
PRT_CLONES void load_block(const int16_t* src, int64_t n, int64_t start,
                           int32_t* buf) {
  const int64_t lo = start - kHistory;
  if (lo >= 0 && start + kBlock <= n) {
    const int16_t* s = src + lo;
    for (int i = 0; i < kBlock + kHistory; ++i) buf[i] = s[i];
    return;
  }
  for (int i = 0; i < kBlock + kHistory; ++i) {
    const int64_t j = lo + i;
    buf[i] = (j >= 0 && j < n) ? src[j] : 0;
  }
}

// |v| folded to the magnitude bits a signed width must hold: v for
// v >= 0, -v - 1 for v < 0.
inline uint32_t magnitude(int32_t v) { return (uint32_t)(v ^ (v >> 31)); }

// Minimal signed width of values whose magnitudes OR to `m`:
// floor(log2(max magnitude)) + 2, or 1 when every value is 0 or -1
// (packed.py _signed_width).
inline uint8_t signed_width(uint32_t m) {
  return m ? (uint8_t)(33 - __builtin_clz(m)) : 1;
}

// The widths of one loaded block at orders 0..3.
PRT_CLONES void block_widths(const int32_t* buf, uint8_t* w) {
  const int32_t* x = buf + kHistory;
  uint32_t m0 = 0, m1 = 0, m2 = 0, m3 = 0;
  for (int i = 0; i < kBlock; ++i) {
    const int32_t d1 = x[i] - x[i - 1], p1 = x[i - 1] - x[i - 2],
                  q1 = x[i - 2] - x[i - 3];
    const int32_t d2 = d1 - p1, p2 = p1 - q1;
    m0 |= magnitude(x[i]);
    m1 |= magnitude(d1);
    m2 |= magnitude(d2);
    m3 |= magnitude(d2 - p2);
  }
  w[0] = signed_width(m0);
  w[1] = signed_width(m1);
  w[2] = signed_width(m2);
  w[3] = signed_width(m3);
}

// The order-k residual of one loaded block.
PRT_CLONES void block_residual(const int32_t* buf, int k, int32_t* r) {
  const int32_t* x = buf + kHistory;
  switch (k) {
    case 0:
      for (int i = 0; i < kBlock; ++i) r[i] = x[i];
      break;
    case 1:
      for (int i = 0; i < kBlock; ++i) r[i] = x[i] - x[i - 1];
      break;
    case 2:
      for (int i = 0; i < kBlock; ++i) r[i] = x[i] - 2 * x[i - 1] + x[i - 2];
      break;
    default:
      for (int i = 0; i < kBlock; ++i)
        r[i] = x[i] - 3 * x[i - 1] + 3 * x[i - 2] - x[i - 3];
  }
}

// One block's residuals at width W: every 32 samples fill W words, and
// with W fixed the unrolled loop resolves each sample's word and shift
// at compile time.
template <int W>
void pack_block(const int32_t* r, uint32_t* out) {
  constexpr uint32_t mask = W >= 32 ? 0xffffffffu : (1u << W) - 1u;
  for (int g = 0; g < kBlock; g += 32, out += W) {
    uint64_t acc = 0;
    int nacc = 0, k = 0;
#pragma GCC unroll 32
    for (int i = 0; i < 32; ++i) {
      acc |= (uint64_t)((uint32_t)r[g + i] & mask) << nacc;
      nacc += W;
      if (nacc >= 32) {
        out[k++] = (uint32_t)acc;
        acc >>= 32;
        nacc -= 32;
      }
    }
  }
}

using PackFn = void (*)(const int32_t*, uint32_t*);

template <std::size_t... I>
constexpr auto pack_table(std::index_sequence<I...>) {
  return std::array<PackFn, sizeof...(I)>{&pack_block<(int)I + 1>...};
}

// Runs fn(first, last) over [0, nblocks) on `workers` threads, the
// calling thread one of them, each taking the next run of blocks until
// none is left: runs of kRun blocks, or fewer where that leaves under
// four runs a worker.  A thread that cannot be started leaves its share
// to the others.
template <class Fn>
void parallel_blocks(int64_t nblocks, int workers, const Fn& fn) {
  if (workers > nblocks) workers = (int)nblocks;
  if (workers < 1) workers = 1;
  int64_t run = nblocks / (4 * (int64_t)workers);
  run = run < 1 ? 1 : run > kRun ? kRun : run;
  std::atomic<int64_t> next{0};
  auto work = [&] {
    for (;;) {
      const int64_t a = next.fetch_add(run);
      if (a >= nblocks) return;
      fn(a, a + run < nblocks ? a + run : nblocks);
    }
  };
  std::vector<std::thread> pool;
  try {
    for (int t = 1; t < workers; ++t) pool.emplace_back(work);
  } catch (const std::system_error&) {
  }
  work();
  for (auto& t : pool) t.join();
}

}  // namespace

extern "C" {

// Pass 1.  x: (S, n) C-contiguous int16.  Writes widths (S, nb), woffs
// (S, nb) and order (S,) as int32, nb = ceil(n / 4096), and returns the
// total words the pack will write.
int64_t prt_wire_widths(const int16_t* x, int64_t S, int64_t n,
                        int32_t workers, int32_t* widths, int32_t* woffs,
                        int32_t* order) {
  if (S <= 0 || n <= 0) return 0;
  const int64_t nb = (n + kBlock - 1) / kBlock;
  std::vector<uint8_t> wk((size_t)(S * nb * kOrders));
  parallel_blocks(S * nb, workers, [&](int64_t a, int64_t z) {
    alignas(64) int32_t buf[kBlock + kHistory];
    for (int64_t blk = a; blk < z; ++blk) {
      const int64_t s = blk / nb, b = blk % nb;
      load_block(x + s * n, n, b * kBlock, buf);
      block_widths(buf, &wk[(size_t)(blk * kOrders)]);
    }
  });
  int64_t cursor = 0;
  for (int64_t s = 0; s < S; ++s) {
    const uint8_t* row = &wk[(size_t)(s * nb * kOrders)];
    int64_t cost[kOrders] = {0, 0, 0, 0};
    for (int64_t b = 0; b < nb; ++b)
      for (int k = 0; k < kOrders; ++k) cost[k] += row[b * kOrders + k];
    int best = 0;
    for (int k = 1; k < kOrders; ++k)
      if (cost[k] < cost[best]) best = k;  // strict: first minimum wins
    order[s] = best;
    for (int64_t b = 0; b < nb; ++b) {
      const int32_t w = row[b * kOrders + best];
      widths[s * nb + b] = w;
      woffs[s * nb + b] = (int32_t)cursor;
      cursor += (int64_t)w * (kBlock / 32);
    }
  }
  return cursor;
}

// Pass 2.  Packs each block of x at widths / woffs / order (pass 1's)
// into words, which must hold the total pass 1 returned.  Writes no word
// outside the blocks' payloads.
void prt_wire_words(const int16_t* x, int64_t S, int64_t n, int32_t workers,
                    const int32_t* widths, const int32_t* woffs,
                    const int32_t* order, int32_t* words) {
  if (S <= 0 || n <= 0) return;
  static constexpr auto kPack =
      pack_table(std::make_index_sequence<32>{});
  const int64_t nb = (n + kBlock - 1) / kBlock;
  parallel_blocks(S * nb, workers, [&](int64_t a, int64_t z) {
    alignas(64) int32_t buf[kBlock + kHistory];
    alignas(64) int32_t r[kBlock];
    for (int64_t blk = a; blk < z; ++blk) {
      const int64_t s = blk / nb, b = blk % nb;
      load_block(x + s * n, n, b * kBlock, buf);
      block_residual(buf, order[s], r);
      kPack[widths[blk] - 1](r, (uint32_t*)(words + woffs[blk]));
    }
  });
}

}  // extern "C"
