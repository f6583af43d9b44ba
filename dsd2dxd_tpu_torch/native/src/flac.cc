// flac.cc — native FLAC encoder for dsd2dxd_tpu.
//
// Replaces the reference's `flac-codec` crate (OutputType::Flac,
// reference src/main.rs:207-214; SURVEY.md §2.3 item 2: the largest
// native host component). Streaming encoder with:
//   - fixed predictors (orders 0-4) and LPC (Levinson-Durbin, Tukey
//     window, per-block order selection up to DSDKIT_FLAC_ORDER —
//     default 8; 12/16 trade ~4%/8% speed for 2.3%/4.9% ratio on real
//     DXD material — from the recursion's own per-order error terms),
//   - per-block stereo decorrelation choice (LR / LS / RS / MS),
//   - Rice coding with partition-order search (4- and 5-bit parameter
//     methods; no spec escape codes — incompressible blocks fall back
//     to VERBATIM subframes instead),
//   - CONSTANT / VERBATIM subframes,
//   - streaming MD5 of the raw samples for STREAMINFO,
//   - frame CRC-8 / CRC-16.
// C ABI only (consumed via ctypes — ../loader.py).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>
#if defined(__AVX2__)
#include <immintrin.h>
#endif

#define DSDKIT_API extern "C" __attribute__((visibility("default")))

namespace {

// ---------------------------------------------------------------------------
// Bit writer
// ---------------------------------------------------------------------------

class BitWriter {
 public:
  // `buf` is CAPACITY; the first `len` bytes are valid. Writes go
  // through a raw length cursor so the hot Rice loop never pays
  // vector::resize's zero-initialisation or per-call bounds logic —
  // call trim() before reading buf as a whole.
  std::vector<uint8_t> buf;
  size_t len = 0;
  uint64_t acc = 0;  // bits pending, left-aligned semantics via nbits
  int nbits = 0;

  inline void ensure(size_t extra) {
    if (len + extra > buf.size())
      buf.resize(std::max(buf.size() * 2, len + extra + 4096));
  }

  // adopt existing bytes (frame header) as the already-written prefix
  void seed(std::vector<uint8_t>&& head) {
    buf = std::move(head);
    len = buf.size();
  }

  inline void flush_bytes() {
    ensure(8);
    while (nbits >= 8) {
      nbits -= 8;
      buf[len++] = uint8_t(acc >> nbits);
    }
  }

  // drain whole big-endian words: one 4-byte store instead of four
  // bounds-checked byte pushes (the Rice loop lives here)
  inline void flush_words() {
    if (nbits >= 32) {
      ensure(8);  // the accumulator holds at most two words
      do {
        nbits -= 32;
        uint32_t be = __builtin_bswap32(uint32_t(acc >> nbits));
        memcpy(buf.data() + len, &be, 4);
        len += 4;
      } while (nbits >= 32);
    }
  }

  inline void put(uint32_t value, int bits) {
    // fast path: stays within the 64-bit accumulator
    if (nbits + bits > 57) flush_words();
    acc = (acc << bits) | (uint64_t(value) & ((bits >= 32) ? 0xFFFFFFFFull
                                                           : ((1ull << bits) - 1)));
    nbits += bits;
    if (nbits >= 32) flush_words();
  }

  inline void put_signed(int32_t value, int bits) { put(uint32_t(value), bits); }

  void align_byte() {
    flush_bytes();
    if (nbits) put(0, 8 - nbits);
    flush_bytes();
  }

  // shrink buf to the valid bytes (end of bit-level writing)
  void trim() {
    flush_bytes();
    buf.resize(len);
  }
};

// ---------------------------------------------------------------------------
// CRCs + MD5
// ---------------------------------------------------------------------------

struct Crc8Table {
  uint8_t t[256];
  Crc8Table() {
    for (int v = 0; v < 256; ++v) {
      uint8_t c = uint8_t(v);
      for (int b = 0; b < 8; ++b)
        c = (c & 0x80) ? uint8_t((c << 1) ^ 0x07) : uint8_t(c << 1);
      t[v] = c;
    }
  }
};

struct Crc16Table {
  uint16_t t[256];
  Crc16Table() {
    for (int v = 0; v < 256; ++v) {
      uint16_t c = uint16_t(v) << 8;
      for (int b = 0; b < 8; ++b)
        c = (c & 0x8000) ? uint16_t((c << 1) ^ 0x8005) : uint16_t(c << 1);
      t[v] = c;
    }
  }
};

uint8_t crc8(const uint8_t* d, size_t n) {
  static const Crc8Table tbl;
  uint8_t c = 0;
  for (size_t i = 0; i < n; ++i) c = tbl.t[c ^ d[i]];
  return c;
}

// Slice-by-8 CRC-16: T[j][v] = CRC of byte v followed by j zero bytes;
// eight independent lookups replace eight serially-dependent ones.
struct Crc16Slice {
  uint16_t t[8][256];
  Crc16Slice() {
    Crc16Table base;
    for (int v = 0; v < 256; ++v) t[0][v] = base.t[v];
    for (int j = 1; j < 8; ++j)
      for (int v = 0; v < 256; ++v)
        t[j][v] = uint16_t((t[j - 1][v] << 8) ^ t[0][t[j - 1][v] >> 8]);
  }
};

uint16_t crc16(const uint8_t* d, size_t n) {
  static const Crc16Slice s;
  uint16_t c = 0;
  for (; n >= 8; d += 8, n -= 8)
    c = s.t[7][(c >> 8) ^ d[0]] ^ s.t[6][(c & 0xFF) ^ d[1]] ^
        s.t[5][d[2]] ^ s.t[4][d[3]] ^ s.t[3][d[4]] ^ s.t[2][d[5]] ^
        s.t[1][d[6]] ^ s.t[0][d[7]];
  for (size_t i = 0; i < n; ++i)
    c = uint16_t((c << 8) ^ s.t[0][(c >> 8) ^ d[i]]);
  return c;
}

struct MD5 {
  uint32_t a = 0x67452301, b = 0xefcdab89, c = 0x98badcfe, d = 0x10325476;
  uint64_t total = 0;
  uint8_t chunk[64];
  size_t fill = 0;

  static uint32_t rotl(uint32_t x, int s) { return (x << s) | (x >> (32 - s)); }

  void process(const uint8_t* p) {
    static const uint32_t K[64] = {
        0xd76aa478, 0xe8c7b756, 0x242070db, 0xc1bdceee, 0xf57c0faf, 0x4787c62a,
        0xa8304613, 0xfd469501, 0x698098d8, 0x8b44f7af, 0xffff5bb1, 0x895cd7be,
        0x6b901122, 0xfd987193, 0xa679438e, 0x49b40821, 0xf61e2562, 0xc040b340,
        0x265e5a51, 0xe9b6c7aa, 0xd62f105d, 0x02441453, 0xd8a1e681, 0xe7d3fbc8,
        0x21e1cde6, 0xc33707d6, 0xf4d50d87, 0x455a14ed, 0xa9e3e905, 0xfcefa3f8,
        0x676f02d9, 0x8d2a4c8a, 0xfffa3942, 0x8771f681, 0x6d9d6122, 0xfde5380c,
        0xa4beea44, 0x4bdecfa9, 0xf6bb4b60, 0xbebfbc70, 0x289b7ec6, 0xeaa127fa,
        0xd4ef3085, 0x04881d05, 0xd9d4d039, 0xe6db99e5, 0x1fa27cf8, 0xc4ac5665,
        0xf4292244, 0x432aff97, 0xab9423a7, 0xfc93a039, 0x655b59c3, 0x8f0ccc92,
        0xffeff47d, 0x85845dd1, 0x6fa87e4f, 0xfe2ce6e0, 0xa3014314, 0x4e0811a1,
        0xf7537e82, 0xbd3af235, 0x2ad7d2bb, 0xeb86d391};
    uint32_t m[16];
    memcpy(m, p, 64);  // little-endian host: words load directly
    uint32_t A = a, B = b, C = c, D = d;
    // unrolled per-group rounds: the generic loop's per-iteration
    // branching on i cost ~30% of the digest time
#define MD5_STEP(f, w, x, y, zz, g, s, i)                     \
  w = x + rotl(w + (f) + K[i] + m[g], s)
    // rounds 1-2 use the 3-op muxer identities (x&y)|(~x&z) == z^(x&(y^z))
    // and (z&x)|(~z&y) == y^(z&(x^y)) — one op fewer per step than the
    // textbook and/andnot/or form
    for (int i = 0; i < 16; i += 4) {
      MD5_STEP(D ^ (B & (C ^ D)), A, B, C, D, i, 7, i);
      MD5_STEP(C ^ (A & (B ^ C)), D, A, B, C, i + 1, 12, i + 1);
      MD5_STEP(B ^ (D & (A ^ B)), C, D, A, B, i + 2, 17, i + 2);
      MD5_STEP(A ^ (C & (D ^ A)), B, C, D, A, i + 3, 22, i + 3);
    }
    for (int i = 16; i < 32; i += 4) {
      MD5_STEP(C ^ (D & (B ^ C)), A, B, C, D, (5 * i + 1) & 15, 5, i);
      MD5_STEP(B ^ (C & (A ^ B)), D, A, B, C, (5 * i + 6) & 15, 9, i + 1);
      MD5_STEP(A ^ (B & (D ^ A)), C, D, A, B, (5 * i + 11) & 15, 14, i + 2);
      MD5_STEP(D ^ (A & (C ^ D)), B, C, D, A, (5 * i + 16) & 15, 20, i + 3);
    }
    for (int i = 32; i < 48; i += 4) {
      MD5_STEP(B ^ C ^ D, A, B, C, D, (3 * i + 5) & 15, 4, i);
      MD5_STEP(A ^ B ^ C, D, A, B, C, (3 * i + 8) & 15, 11, i + 1);
      MD5_STEP(D ^ A ^ B, C, D, A, B, (3 * i + 11) & 15, 16, i + 2);
      MD5_STEP(C ^ D ^ A, B, C, D, A, (3 * i + 14) & 15, 23, i + 3);
    }
    for (int i = 48; i < 64; i += 4) {
      MD5_STEP(C ^ (B | ~D), A, B, C, D, (7 * i) & 15, 6, i);
      MD5_STEP(B ^ (A | ~C), D, A, B, C, (7 * (i + 1)) & 15, 10, i + 1);
      MD5_STEP(A ^ (D | ~B), C, D, A, B, (7 * (i + 2)) & 15, 15, i + 2);
      MD5_STEP(D ^ (C | ~A), B, C, D, A, (7 * (i + 3)) & 15, 21, i + 3);
    }
#undef MD5_STEP
    a += A; b += B; c += C; d += D;
  }

  void update(const uint8_t* p, size_t n) {
    total += n;
    if (fill) {
      size_t take = std::min(n, size_t(64) - fill);
      memcpy(chunk + fill, p, take);
      fill += take;
      p += take;
      n -= take;
      if (fill == 64) { process(chunk); fill = 0; }
    }
    // bulk: digest straight from the caller's buffer, no staging copy
    while (n >= 64) { process(p); p += 64; n -= 64; }
    if (n) {
      memcpy(chunk, p, n);
      fill = n;
    }
  }

  void finish(uint8_t out[16]) {
    uint64_t bits = total * 8;
    uint8_t pad = 0x80;
    update(&pad, 1);
    uint8_t z = 0;
    while (fill != 56) update(&z, 1);
    uint8_t len[8];
    for (int i = 0; i < 8; ++i) len[i] = uint8_t(bits >> (8 * i));
    update(len, 8);
    uint32_t h[4] = {a, b, c, d};
    for (int i = 0; i < 4; ++i)
      for (int j = 0; j < 4; ++j) out[i * 4 + j] = uint8_t(h[i] >> (8 * j));
  }
};

// ---------------------------------------------------------------------------
// Rice coding
// ---------------------------------------------------------------------------

inline uint32_t zigzag(int32_t v) {
  return (uint32_t(v) << 1) ^ uint32_t(v >> 31);
}

// Rice parameter from a partition's zigzag sum (libFLAC-style estimate:
// k ~= log2(mean); encode cost estimated as n*(k+1) + (sum >> k)).
int param_for_sum(uint64_t sum, uint64_t n) {
  if (n == 0 || sum <= n) return 0;
  int k = 0;
  while (k < 30 && (n << (k + 1)) < sum) ++k;
  return k;
}

uint64_t est_cost(uint64_t sum, uint64_t n, int k) {
  return n * (uint64_t(k) + 1) + (sum >> k);
}

void write_rice(BitWriter& bw, const uint32_t* z, size_t n, int k,
                uint64_t zsum) {
  // The partition's total encoded size is known up front from its
  // zigzag sum: sum(z>>k) <= zsum>>k quotient bits plus n stop bits and
  // n*k remainder bits. One capacity reservation then lets the whole
  // loop run on LOCAL accumulator/cursor state with zero per-sample
  // capacity or spill checks (the member-state put() path was the
  // encoder's second-largest cost after MD5).
  uint64_t bound_bits = (zsum >> k) + n * (uint64_t(k) + 1);
  bw.ensure(bound_bits / 8 + 16);
  uint64_t acc = bw.acc;
  int nb = bw.nbits;
  uint8_t* p = bw.buf.data() + bw.len;
#define RICE_DRAIN()                                    \
  if (nb >= 32) {                                       \
    nb -= 32;                                           \
    uint32_t be = __builtin_bswap32(uint32_t(acc >> nb)); \
    memcpy(p, &be, 4);                                  \
    p += 4;                                             \
  }
  uint32_t stop = 1u << k;  // stop bit pre-positioned above k remainder bits
  uint32_t mask = stop - 1;
  auto emit_one = [&](uint32_t v, uint32_t q, uint32_t bits) {
    if (bits <= 32) {
      acc = (acc << bits) | (stop | (v & mask));
      nb += int(bits);
      RICE_DRAIN();
    } else {
      while (q >= 24) {
        acc <<= 24;
        nb += 24;
        RICE_DRAIN();
        q -= 24;
      }
      acc = (acc << (q + 1)) | 1u;
      nb += int(q) + 1;
      RICE_DRAIN();
      if (k) {
        acc = (acc << k) | (v & mask);
        nb += k;
        RICE_DRAIN();
      }
    }
  };
  // pairs: two codes land in one accumulator insert + one drain check
  // whenever their combined width fits 32 bits (mean quotient < 1, so
  // 2*(k+1) + a few quotient bits almost always does)
  size_t i = 0;
  for (; i + 2 <= n; i += 2) {
    uint32_t v0 = z[i], v1 = z[i + 1];
    uint32_t q0 = v0 >> k, q1 = v1 >> k;
    uint32_t b0 = q0 + 1 + uint32_t(k), b1 = q1 + 1 + uint32_t(k);
    uint32_t bb = b0 + b1;
    if (bb <= 32) {
      acc = (acc << bb) |
            (((stop | (v0 & mask)) << b1) | (stop | (v1 & mask)));
      nb += int(bb);
      RICE_DRAIN();
    } else {
      emit_one(v0, q0, b0);
      emit_one(v1, q1, b1);
    }
  }
  if (i < n) {
    uint32_t v = z[i];
    uint32_t q = v >> k;
    emit_one(v, q, q + 1 + uint32_t(k));
  }
#undef RICE_DRAIN
  bw.acc = acc;
  bw.nbits = nb;
  bw.len = size_t(p - bw.buf.data());
}

// Residual block: partitioned Rice, method 0 (4-bit params) or 1 (5-bit).
// ONE pass computes zigzags + finest partition sums; coarser orders merge
// pairwise; parameters come from the sums (no per-k rescans). Split into
// prep + write so write_subframe can reuse the prep pass's total for the
// LPC-vs-fixed decision instead of paying a separate abs-sum scan.
int residual_max_po(size_t block_size, int pred_order) {
  int max_po = 0;
  while (max_po < 6 && (block_size % (1u << (max_po + 1))) == 0 &&
         (block_size >> (max_po + 1)) > uint32_t(pred_order))
    ++max_po;
  return max_po;
}

// zigzag + finest-partition sums over `res` (already offset past the
// warmup samples); returns the total zigzag sum over all residuals.
uint64_t zigzag_partition_sums(const int32_t* res, size_t block_size,
                               int pred_order, int max_po, uint32_t* z,
                               uint64_t sums[64]) {
  uint32_t parts_max = 1u << max_po;
  size_t cnt_min = block_size / parts_max;
  uint64_t total = 0;
  size_t idx = 0;
  for (uint32_t p = 0; p < parts_max; ++p) {
    size_t cnt = cnt_min - (p == 0 ? pred_order : 0);
    uint64_t s = 0;
    size_t i = 0;
#if defined(__AVX2__)
    if (cnt >= 8) {
      const __m256i lo32 = _mm256_set1_epi64x(0xFFFFFFFFll);
      __m256i acc = _mm256_setzero_si256();
      for (; i + 8 <= cnt; i += 8) {
        __m256i v = _mm256_loadu_si256((const __m256i*)(res + idx + i));
        __m256i u = _mm256_xor_si256(_mm256_slli_epi32(v, 1),
                                     _mm256_srai_epi32(v, 31));
        _mm256_storeu_si256((__m256i*)(z + idx + i), u);
        acc = _mm256_add_epi64(acc, _mm256_and_si256(u, lo32));
        acc = _mm256_add_epi64(acc, _mm256_srli_epi64(u, 32));
      }
      alignas(32) uint64_t t[4];
      _mm256_store_si256((__m256i*)t, acc);
      s = t[0] + t[1] + t[2] + t[3];
    }
#endif
    for (; i < cnt; ++i) {
      uint32_t u = zigzag(res[idx + i]);
      z[idx + i] = u;
      s += u;
    }
    idx += cnt;
    sums[p] = s;
    total += s;
  }
  return total;
}

// Build the partition-sum pyramid into `lvl` (level po at offset
// (1<<po)-1; max_po <= 6 -> 127 slots) and pick the partition order with
// the lowest estimated cost. Returned bits include the 2+4 method/order
// header and the per-partition parameter fields — 5 bits each when any
// partition of that order needs k > 14 (the RICE2 method applies to the
// WHOLE residual, so one hot partition re-prices every other one; costing
// them all at 4 under-penalized fine orders on high-entropy material).
struct ResChoice { int po; uint64_t bits; };

ResChoice residual_choose(size_t block_size, int pred_order, int max_po,
                          const uint64_t sums[64], uint64_t lvl[127]) {
  uint32_t parts_max = 1u << max_po;
  auto level_at = [&](int po) { return lvl + ((1u << po) - 1); };
  memcpy(level_at(max_po), sums, parts_max * sizeof(uint64_t));
  for (int po = max_po - 1; po >= 0; --po) {
    const uint64_t* src = level_at(po + 1);
    uint64_t* dst = level_at(po);
    for (size_t p = 0; p < (1u << po); ++p)
      dst[p] = src[2 * p] + src[2 * p + 1];
  }
  ResChoice best{max_po, ~0ull};
  for (int po = 0; po <= max_po; ++po) {
    uint64_t cost = 2 + 4;
    uint32_t parts = 1u << po;
    size_t cnt = block_size / parts;
    const uint64_t* lv = level_at(po);
    bool five_bit = false;
    for (uint32_t p = 0; p < parts; ++p) {
      uint64_t c = cnt - (p == 0 ? pred_order : 0);
      int k = param_for_sum(lv[p], c);
      five_bit |= (k > 14);
      cost += est_cost(lv[p], c, k) + 4;
    }
    if (five_bit) cost += parts;
    if (cost < best.bits) best = {po, cost};
  }
  return best;
}

// Writes the residual using the pyramid + choice residual_choose already
// produced for the costing decision in write_subframe — recomputing the
// per-order parameter search here doubled the partition-search cost of
// every non-verbatim subframe.
void write_residual_chosen(BitWriter& bw, const uint32_t* zp,
                           size_t block_size, int pred_order,
                           const ResChoice& rc, const uint64_t lvl[127]) {
  auto level_at = [&](int po) { return lvl + ((1u << po) - 1); };
  int best_po = rc.po;
  uint32_t parts = 1u << best_po;
  size_t cnt_full = block_size / parts;
  const uint64_t* best_lv = level_at(best_po);
  static thread_local std::vector<int> params;
  params.resize(parts);
  bool five_bit = false;
  for (uint32_t p = 0; p < parts; ++p) {
    uint64_t c = cnt_full - (p == 0 ? pred_order : 0);
    params[p] = param_for_sum(best_lv[p], c);
    five_bit |= (params[p] > 14);
  }
  bw.put(five_bit ? 1 : 0, 2);  // residual coding method
  bw.put(uint32_t(best_po), 4);
  size_t idx = 0;
  int pbits = five_bit ? 5 : 4;
  for (uint32_t p = 0; p < parts; ++p) {
    size_t cnt = cnt_full - (p == 0 ? pred_order : 0);
    bw.put(uint32_t(params[p]), pbits);
    write_rice(bw, zp + idx, cnt, params[p], best_lv[p]);
    idx += cnt;
  }
}

// ---------------------------------------------------------------------------
// Subframe encoders
// ---------------------------------------------------------------------------

// One pass: |residual| sums for fixed orders 0..4 via running differences.
void fixed_order_sums_scalar(const int32_t* x, size_t n, size_t from,
                             uint64_t out[5]) {
  // differences seeded from x[from-1...] so a vector main loop can hand
  // off the tail; `from` samples must precede x+from when from > 0
  int64_t p1 = from >= 1 ? x[from - 1] : 0;
  int64_t p2 = from >= 2 ? x[from - 1] - x[from - 2] : 0;
  int64_t p3 = from >= 3 ? x[from - 1] - 2 * x[from - 2] + x[from - 3] : 0;
  int64_t p4 = from >= 4
                   ? x[from - 1] - 3 * x[from - 2] + 3 * x[from - 3] - x[from - 4]
                   : 0;
  for (size_t i = from; i < n; ++i) {
    int64_t d0 = x[i];
    int64_t d1 = d0 - p1;
    int64_t d2 = d1 - p2;
    int64_t d3 = d2 - p3;
    int64_t d4 = d3 - p4;
    if (i >= 1) out[1] += uint64_t(d1 < 0 ? -d1 : d1);
    if (i >= 2) out[2] += uint64_t(d2 < 0 ? -d2 : d2);
    if (i >= 3) out[3] += uint64_t(d3 < 0 ? -d3 : d3);
    if (i >= 4) out[4] += uint64_t(d4 < 0 ? -d4 : d4);
    out[0] += uint64_t(d0 < 0 ? -d0 : d0);
    p4 = d3; p3 = d2; p2 = d1; p1 = d0;
  }
}

void fixed_order_sums(const int32_t* x, size_t n, uint64_t out[5],
                      int bps = 26) {
  for (int o = 0; o < 5; ++o) out[o] = 0;
#if defined(__AVX2__)
  // |d4| <= 16*2^(bps-1): stay in i32 lanes only when that fits
  if (n >= 16 && bps <= 26) {
    // binomial differences from shifted unaligned loads, 8 lanes/step;
    // |d4| <= 16*2^24 < 2^31 so i32 never overflows. Non-negative abs
    // values accumulate into i64 lanes by even/odd dword split.
    const __m256i lo32 = _mm256_set1_epi64x(0xFFFFFFFFll);
    __m256i s0 = _mm256_setzero_si256(), s1 = s0, s2 = s0, s3 = s0, s4 = s0;
    // scalar prologue covers the order-dependent start offsets
    fixed_order_sums_scalar(x, 4, 0, out);
    size_t i = 4;
    for (; i + 8 <= n; i += 8) {
      __m256i v0 = _mm256_loadu_si256((const __m256i*)(x + i));
      __m256i v1 = _mm256_loadu_si256((const __m256i*)(x + i - 1));
      __m256i v2 = _mm256_loadu_si256((const __m256i*)(x + i - 2));
      __m256i v3 = _mm256_loadu_si256((const __m256i*)(x + i - 3));
      __m256i v4 = _mm256_loadu_si256((const __m256i*)(x + i - 4));
      __m256i e1 = _mm256_sub_epi32(v0, v1);
      __m256i e2 = _mm256_sub_epi32(v1, v2);
      __m256i e3 = _mm256_sub_epi32(v2, v3);
      __m256i e4 = _mm256_sub_epi32(v3, v4);
      __m256i d2 = _mm256_sub_epi32(e1, e2);
      __m256i f2 = _mm256_sub_epi32(e2, e3);
      __m256i f3 = _mm256_sub_epi32(e3, e4);
      __m256i d3 = _mm256_sub_epi32(d2, f2);
      __m256i d4 = _mm256_sub_epi32(d3, _mm256_sub_epi32(f2, f3));
#define ACC(sacc, dv)                                                     \
  {                                                                       \
    __m256i va = _mm256_abs_epi32(dv);                                    \
    sacc = _mm256_add_epi64(sacc, _mm256_and_si256(va, lo32));            \
    sacc = _mm256_add_epi64(sacc, _mm256_srli_epi64(va, 32));             \
  }
      ACC(s0, v0)
      ACC(s1, e1)
      ACC(s2, d2)
      ACC(s3, d3)
      ACC(s4, d4)
#undef ACC
    }
    uint64_t t[4];
#define HSUM(sacc, o)                                                     \
  {                                                                       \
    _mm256_storeu_si256((__m256i*)t, sacc);                               \
    out[o] += t[0] + t[1] + t[2] + t[3];                                  \
  }
    HSUM(s0, 0) HSUM(s1, 1) HSUM(s2, 2) HSUM(s3, 3) HSUM(s4, 4)
#undef HSUM
    fixed_order_sums_scalar(x, n, i, out);
    return;
  }
#endif
  fixed_order_sums_scalar(x, n, 0, out);
}

// Fixed-predictor residuals, order 0..4 (in place over a copy).
void fixed_residual(const int32_t* x, size_t n, int order, int32_t* out) {
  switch (order) {
    case 0:
      memcpy(out, x, n * sizeof(int32_t));
      break;
    case 1:
      for (size_t i = 1; i < n; ++i) out[i] = x[i] - x[i - 1];
      break;
    case 2:
      for (size_t i = 2; i < n; ++i) out[i] = x[i] - 2 * x[i - 1] + x[i - 2];
      break;
    case 3:
      for (size_t i = 3; i < n; ++i)
        out[i] = x[i] - 3 * x[i - 1] + 3 * x[i - 2] - x[i - 3];
      break;
    case 4:
      for (size_t i = 4; i < n; ++i)
        out[i] = x[i] - 4 * x[i - 1] + 6 * x[i - 2] - 4 * x[i - 3] + x[i - 4];
      break;
  }
}

struct LpcModel {
  int order = 0;
  int shift = 0;
  int precision = 15;
  int32_t qcoef[32];
  bool ok = false;
};

// Cached Tukey(0.5) window (depends only on the block length). Float:
// the window feeds the ANALYSIS autocorrelation only — coefficients are
// quantized to 15 bits afterwards, so f32 analysis precision is ample
// and the 8-accumulator product loop vectorizes twice as wide.
const std::vector<float>& tukey_window(size_t n) {
  static thread_local std::vector<float> cache;
  static thread_local size_t cached_n = 0;
  if (cached_n != n) {
    cache.resize(n);
    size_t taper = n / 4;
    for (size_t i = 0; i < n; ++i) {
      double win = 1.0;
      if (i < taper)
        win = 0.5 * (1.0 + cos(3.14159265358979323846 *
                               (double(i) / taper - 1.0)));
      else if (i >= n - taper)
        win = 0.5 * (1.0 + cos(3.14159265358979323846 *
                               (double(i - (n - taper)) / taper)));
      cache[i] = float(win);
    }
    cached_n = n;
  }
  return cache;
}

#if defined(__AVX2__) && defined(__FMA__)
// All lags 0..L in one pass over the windowed samples, 4-wide FMA with
// L+1 accumulators (L is a compile-time constant so the inner loop
// fully unrolls; L=12 keeps 14 ymm registers live). Requires n > 2L.
template <int L>
void autocorr_fma(const double* p, size_t n, double* ac) {
  __m256d v[L + 1];
  for (int l = 0; l <= L; ++l) v[l] = _mm256_setzero_pd();
  size_t i = L;
  for (; i + 4 <= n; i += 4) {
    __m256d wi = _mm256_loadu_pd(p + i);
    for (int l = 0; l <= L; ++l)
      v[l] = _mm256_fmadd_pd(wi, _mm256_loadu_pd(p + i - l), v[l]);
  }
  for (int l = 0; l <= L; ++l) {
    double t[4];
    _mm256_storeu_pd(t, v[l]);
    ac[l] = t[0] + t[1] + t[2] + t[3];
  }
  for (; i < n; ++i)
    for (int l = 0; l <= L; ++l) ac[l] += p[i] * p[i - l];
  // the skipped head (i < L) contributes to low lags
  for (size_t j = 0; j < size_t(L) && j < n; ++j)
    for (int lag = 0; lag <= int(j); ++lag) ac[lag] += p[j] * p[j - lag];
}
#endif

LpcModel lpc_analyze(const int32_t* x, size_t n, int max_order, int bps) {
  LpcModel m;
  if (max_order > 16) max_order = 16;  // hist[] bound; env is clamped too
  if (size_t(max_order) * 2 > n) max_order = int(n / 2);  // short tail block
  if (max_order < 1) return m;
  const std::vector<float>& win = tukey_window(n);
  static thread_local std::vector<double> w;
  w.resize(n);
  for (size_t i = 0; i < n; ++i) w[i] = double(x[i]) * win[i];
  // Single-pass autocorrelation in DOUBLE (f32 analysis collapses the
  // Levinson error term on near-tonal material — exactly what dithered
  // test tones are — and cost ~9% compression when tried): all lags
  // accumulate while w[i-lag..i] is hot in L1, 4-wide with FMA when
  // available (the per-lag re-scan was the encoder's top profile cost).
  double ac[33] = {0};
  {
    const double* p = w.data();
#if defined(__AVX2__) && defined(__FMA__)
    if (max_order == 8) {
      autocorr_fma<8>(p, n, ac);
    } else if (max_order == 12) {
      autocorr_fma<12>(p, n, ac);
    } else if (max_order == 16) {
      autocorr_fma<16>(p, n, ac);
    } else
#endif
    if (max_order == 8 && n > 16) {
      double a0 = 0, a1 = 0, a2 = 0, a3 = 0, a4 = 0, a5 = 0, a6 = 0,
             a7 = 0, a8 = 0;
      for (size_t i = 8; i < n; ++i) {
        double wi = p[i];
        a0 += wi * p[i];
        a1 += wi * p[i - 1];
        a2 += wi * p[i - 2];
        a3 += wi * p[i - 3];
        a4 += wi * p[i - 4];
        a5 += wi * p[i - 5];
        a6 += wi * p[i - 6];
        a7 += wi * p[i - 7];
        a8 += wi * p[i - 8];
      }
      ac[0] = a0; ac[1] = a1; ac[2] = a2; ac[3] = a3; ac[4] = a4;
      ac[5] = a5; ac[6] = a6; ac[7] = a7; ac[8] = a8;
      // the skipped head (i < 8) contributes to low lags
      for (size_t j = 0; j < 8 && j < n; ++j)
        for (int lag = 0; lag <= int(j); ++lag) ac[lag] += p[j] * p[j - lag];
    } else {
      for (int lag = 0; lag <= max_order; ++lag) {
        double s = 0;
        for (size_t k = lag; k < n; ++k) s += p[k] * p[k - lag];
        ac[lag] = s;
      }
    }
  }
  if (ac[0] <= 0) return m;
  // Levinson-Durbin with per-order snapshots: the recursion yields the
  // prediction-error energy of EVERY order up to max_order for free, so
  // the order is chosen per block by estimated total subframe bits —
  // expected residual bits/sample ≈ 0.5·log2(err_o/n) (the Rice-coding
  // constant cancels across orders) plus o·(bps+precision) of
  // warmup+coefficient header. A constant offset in the estimate can
  // only misrank neighboring orders; the LPC-vs-FIXED-vs-VERBATIM
  // choice downstream still uses the chosen order's ACTUAL residual
  // sums, so a bad estimate costs ratio, never correctness.
  double err = ac[0];
  double lpc[32] = {0};
  double hist[16][16];
  double herr[17];
  int avail = 0;
  for (int i = 0; i < max_order; ++i) {
    double r = -ac[i + 1];
    for (int j = 0; j < i; ++j) r -= lpc[j] * ac[i - j];
    r /= err;
    lpc[i] = r;
    for (int j = 0; j < i / 2; ++j) {
      double tmp = lpc[j];
      lpc[j] += r * lpc[i - 1 - j];
      lpc[i - 1 - j] += r * tmp;
    }
    if (i & 1) lpc[i / 2] += lpc[i / 2] * r;
    err *= 1.0 - r * r;
    if (!(err > 0)) break;  // numerically singular beyond this order
    memcpy(hist[i], lpc, sizeof(double) * size_t(i + 1));
    herr[i + 1] = err;
    avail = i + 1;
  }
  if (avail == 0) return m;
  int order = avail;
  double best_bits = 1e300;
  for (int o = 1; o <= avail; ++o) {
    double var = herr[o] / double(n);
    double est = var > 1.0 ? 0.5 * log2(var) : 0.0;
    double bits = est * double(n - size_t(o)) +
                  double(o) * double(bps + m.precision);
    if (bits < best_bits) { best_bits = bits; order = o; }
  }
  const double* sel = hist[order - 1];
  // quantize coefficients (precision 15)
  double cmax = 0;
  for (int i = 0; i < order; ++i) cmax = std::max(cmax, std::abs(sel[i]));
  if (cmax <= 0) return m;
  int headroom = 0;
  while ((1 << headroom) <= cmax && headroom < 30) ++headroom;
  int shift = m.precision - 1 - headroom;
  if (shift > 15) shift = 15;
  if (shift <= 0) return m;
  double e = 0;
  for (int i = 0; i < order; ++i) {
    e += sel[i] * double(1 << shift);
    int32_t q = int32_t(lround(e));
    int32_t lim = (1 << (m.precision - 1)) - 1;
    // clamp to [-lim, lim], NOT the full two's-complement [-(lim+1), lim]:
    // the sign fold below negates q, and +(lim+1) = +16384 is not
    // representable in the 15-bit coefficient field — put_signed would
    // emit 0x4000, which decoders sign-extend to -16384 and the whole
    // subframe would decode to wrong samples (CRCs pass; only MD5 trips)
    if (q > lim) q = lim;
    if (q < -lim) q = -lim;
    e -= q;
    m.qcoef[i] = -q;  // predictor: x[i] ~= sum qcoef*x[i-1-j] (sign folded)
  }
  m.order = order;
  m.shift = shift;
  m.ok = true;
  return m;
}

void lpc_residual(const int32_t* x, size_t n, const LpcModel& m, int32_t* out) {
  if (m.order == 8) {  // the default analysis order
#if defined(__AVX2__)
    // four predictions at a time: mul_epi32 takes the sign-extended low
    // dwords of i64 lanes (15-bit coef x 25-bit sample fits easily);
    // the >> shift epilogue is scalar (AVX2 has no arithmetic i64 shift)
    __m256i qv[8];
    for (int j = 0; j < 8; ++j)
      qv[j] = _mm256_set1_epi64x(int64_t(m.qcoef[j]));
    size_t i = 8;
    alignas(32) int64_t t[4];
    for (; i + 4 <= n; i += 4) {
      __m256i acc = _mm256_setzero_si256();
      for (int j = 0; j < 8; ++j) {
        __m256i v = _mm256_cvtepi32_epi64(
            _mm_loadu_si128((const __m128i*)(x + i - 1 - j)));
        acc = _mm256_add_epi64(acc, _mm256_mul_epi32(v, qv[j]));
      }
      _mm256_store_si256((__m256i*)t, acc);
      out[i] = x[i] - int32_t(t[0] >> m.shift);
      out[i + 1] = x[i + 1] - int32_t(t[1] >> m.shift);
      out[i + 2] = x[i + 2] - int32_t(t[2] >> m.shift);
      out[i + 3] = x[i + 3] - int32_t(t[3] >> m.shift);
    }
    const int32_t* q = m.qcoef;
    for (; i < n; ++i) {
      int64_t pred = int64_t(q[0]) * x[i - 1] + int64_t(q[1]) * x[i - 2] +
                     int64_t(q[2]) * x[i - 3] + int64_t(q[3]) * x[i - 4] +
                     int64_t(q[4]) * x[i - 5] + int64_t(q[5]) * x[i - 6] +
                     int64_t(q[6]) * x[i - 7] + int64_t(q[7]) * x[i - 8];
      out[i] = x[i] - int32_t(pred >> m.shift);
    }
#else
    const int32_t* q = m.qcoef;
    for (size_t i = 8; i < n; ++i) {
      int64_t pred = int64_t(q[0]) * x[i - 1] + int64_t(q[1]) * x[i - 2] +
                     int64_t(q[2]) * x[i - 3] + int64_t(q[3]) * x[i - 4] +
                     int64_t(q[4]) * x[i - 5] + int64_t(q[5]) * x[i - 6] +
                     int64_t(q[6]) * x[i - 7] + int64_t(q[7]) * x[i - 8];
      out[i] = x[i] - int32_t(pred >> m.shift);
    }
#endif
    return;
  }
#if defined(__AVX2__)
  if (n > size_t(m.order) + 4) {  // generic-order 4-wide path
    __m256i qv[16];
    const int ord = m.order;
    for (int j = 0; j < ord; ++j)
      qv[j] = _mm256_set1_epi64x(int64_t(m.qcoef[j]));
    size_t i = size_t(ord);
    alignas(32) int64_t t[4];
    for (; i + 4 <= n; i += 4) {
      __m256i acc = _mm256_setzero_si256();
      for (int j = 0; j < ord; ++j) {
        __m256i v = _mm256_cvtepi32_epi64(
            _mm_loadu_si128((const __m128i*)(x + i - 1 - j)));
        acc = _mm256_add_epi64(acc, _mm256_mul_epi32(v, qv[j]));
      }
      _mm256_store_si256((__m256i*)t, acc);
      out[i] = x[i] - int32_t(t[0] >> m.shift);
      out[i + 1] = x[i + 1] - int32_t(t[1] >> m.shift);
      out[i + 2] = x[i + 2] - int32_t(t[2] >> m.shift);
      out[i + 3] = x[i + 3] - int32_t(t[3] >> m.shift);
    }
    for (; i < n; ++i) {
      int64_t pred = 0;
      for (int j = 0; j < ord; ++j) pred += int64_t(m.qcoef[j]) * x[i - 1 - j];
      out[i] = x[i] - int32_t(pred >> m.shift);
    }
    return;
  }
#endif
  for (size_t i = m.order; i < n; ++i) {
    int64_t pred = 0;
    for (int j = 0; j < m.order; ++j) pred += int64_t(m.qcoef[j]) * x[i - 1 - j];
    out[i] = x[i] - int32_t(pred >> m.shift);
  }
}

// Encode one channel's samples as the best subframe.
void write_subframe(BitWriter& bw, const int32_t* x, size_t n, int bps,
                    int max_order) {
  // CONSTANT?
  bool constant = true;
  for (size_t i = 1; i < n && constant; ++i) constant = (x[i] == x[0]);
  if (constant) {
    bw.put(0, 1);            // zero pad
    bw.put(0, 6);            // CONSTANT
    bw.put(0, 1);            // no wasted bits
    bw.put_signed(x[0], bps);
    return;
  }
  // choose fixed order by min abs residual sum (single pass)
  uint64_t sums[5];
  fixed_order_sums(x, n, sums, bps);
  int best_order = 0;
  uint64_t best_sum = sums[0];
  for (int order = 1; order <= 4 && size_t(order) < n; ++order) {
    if (sums[order] < best_sum) { best_sum = sums[order]; best_order = order; }
  }
  // LPC candidate. Its residual's zigzag+partition-sum prep doubles as
  // the decision statistic (zigzag(v) ~ 2|v|, same scale as 2x the fixed
  // abs sums), so choosing LPC costs no extra pass over the residuals —
  // and the fixed residual pass only runs when fixed actually wins.
  LpcModel lpc = lpc_analyze(x, n, max_order, bps);
  bool use_lpc = false;
  static thread_local std::vector<int32_t> lres;
  static thread_local std::vector<uint32_t> zl;
  int lpo = 0;
  uint64_t lsums[64];
  if (lpc.ok && n > size_t(lpc.order) * 2) {
    lres.resize(n);
    lpc_residual(x, n, lpc, lres.data());
    lpo = residual_max_po(n, lpc.order);
    zl.resize(n - lpc.order);
    uint64_t zsum = zigzag_partition_sums(lres.data() + lpc.order, n,
                                          lpc.order, lpo, zl.data(), lsums);
    uint64_t s = zsum / 2;
    // ~bits: lpc header overhead = order*(bps + precision); compare sums
    double fixed_bits = double(best_sum) / std::max<size_t>(n - best_order, 1);
    double lpc_bits = double(s) / std::max<size_t>(n - lpc.order, 1);
    double overhead = double(lpc.order) * (bps + lpc.precision) / double(n);
    use_lpc = (log2(lpc_bits + 1) + overhead + 0.05) < log2(fixed_bits + 1);
  }
  // VERBATIM fallback: rice-coded residuals have no size cap (param_for_sum
  // caps k at 30, so incompressible noise costs up to ~k+1 > bps bits per
  // sample); when the chosen predictor's estimated subframe exceeds raw
  // samples, emit them raw. Estimated vs written: est_cost upper-bounds the
  // quotient bits, so the comparison never picks an oversized rice encoding.
  const uint64_t verbatim_bits = 8 + uint64_t(n) * bps;
  static thread_local std::vector<int32_t> best_res;
  static thread_local std::vector<uint32_t> zf;
  int fpo = 0;
  uint64_t fsums[64];
  if (!use_lpc) {
    best_res.resize(n);
    fixed_residual(x, n, best_order, best_res.data());
    fpo = residual_max_po(n, best_order);
    zf.resize(n - best_order);
    zigzag_partition_sums(best_res.data() + best_order, n, best_order, fpo,
                          zf.data(), fsums);
  }
  uint64_t lvl[127];
  ResChoice rc = use_lpc
      ? residual_choose(n, lpc.order, lpo, lsums, lvl)
      : residual_choose(n, best_order, fpo, fsums, lvl);
  uint64_t coded_bits =
      use_lpc ? 8 + uint64_t(lpc.order) * bps + 4 + 5 +
                    uint64_t(lpc.order) * lpc.precision + rc.bits
              : 8 + uint64_t(best_order) * bps + rc.bits;
  if (coded_bits >= verbatim_bits) {
    bw.put(0, 1);
    bw.put(1, 6);  // VERBATIM
    bw.put(0, 1);
    for (size_t i = 0; i < n; ++i) bw.put_signed(x[i], bps);
  } else if (use_lpc) {
    bw.put(0, 1);
    bw.put(0x20 | uint32_t(lpc.order - 1), 6);  // LPC
    bw.put(0, 1);
    for (int i = 0; i < lpc.order; ++i) bw.put_signed(x[i], bps);  // warmup
    bw.put(uint32_t(lpc.precision - 1), 4);
    bw.put(uint32_t(lpc.shift), 5);
    for (int i = 0; i < lpc.order; ++i) bw.put_signed(lpc.qcoef[i], lpc.precision);
    write_residual_chosen(bw, zl.data(), n, lpc.order, rc, lvl);
  } else {
    bw.put(0, 1);
    bw.put(0x08 | uint32_t(best_order), 6);  // FIXED
    bw.put(0, 1);
    for (int i = 0; i < best_order; ++i) bw.put_signed(x[i], bps);
    write_residual_chosen(bw, zf.data(), n, best_order, rc, lvl);
  }
}

// ---------------------------------------------------------------------------
// Frame assembly
// ---------------------------------------------------------------------------

void write_utf8(std::vector<uint8_t>& v, uint64_t val) {
  if (val < 0x80) { v.push_back(uint8_t(val)); return; }
  // k continuation bytes cover 5k+6 payload bits
  int cont = 1;
  while (val >= (1ull << (5 * cont + 6)) && cont < 6) ++cont;
  uint8_t lead = uint8_t(0xFF << (7 - cont)) & 0xFF;
  v.push_back(uint8_t(lead | (val >> (6 * cont))));
  for (int i = cont - 1; i >= 0; --i)
    v.push_back(uint8_t(0x80 | ((val >> (6 * i)) & 0x3F)));
}

int sample_rate_code(uint32_t rate) {
  switch (rate) {
    case 88200: return 0x1;   // actually 88.2k = 0b0001? (see table below)
    case 176400: return 0x2;
    case 192000: return 0x3;
    case 8000: return 0x4;
    case 16000: return 0x5;
    case 22050: return 0x6;
    case 24000: return 0x7;
    case 32000: return 0x8;
    case 44100: return 0x9;
    case 48000: return 0xA;
    case 96000: return 0xB;
    default: return 0;  // 0b0000: take from STREAMINFO
  }
}

int sample_size_code(int bps) {
  switch (bps) {
    case 8: return 1;
    case 12: return 2;
    case 16: return 4;
    case 20: return 5;
    case 24: return 6;
    case 32: return 7;
    default: return 0;
  }
}

// Persistent worker pool for feed()'s block fan-out. feed() runs
// hundreds of times per file; fresh std::threads per call would pay
// create/join latency AND recompute every worker's thread_local scratch
// (Tukey window, LPC/rice buffers) each time. Workers park on a
// condition variable between jobs, so their thread_locals live for the
// whole encode. The job itself still distributes blocks via the
// caller's atomic cursor, so an over-sized pool just finds the cursor
// exhausted and parks again.
class Pool {
 public:
  explicit Pool(unsigned workers) {
    for (unsigned t = 0; t < workers; ++t)
      threads.emplace_back([this] { run(); });
  }
  ~Pool() {
    {
      std::lock_guard<std::mutex> l(mu);
      stop = true;
    }
    cv_work.notify_all();
    for (auto& t : threads) t.join();
  }
  // hand `j` to every worker; the caller should run j() itself too,
  // then wait() before touching anything j captured by reference
  void launch(std::function<void()> j) {
    {
      std::lock_guard<std::mutex> l(mu);
      job = std::move(j);
      ++gen;
      pending = threads.size();
    }
    cv_work.notify_all();
  }
  void wait() {
    std::unique_lock<std::mutex> l(mu);
    cv_done.wait(l, [this] { return pending == 0; });
    job = nullptr;
  }

 private:
  void run() {
    uint64_t seen = 0;
    std::unique_lock<std::mutex> l(mu);
    for (;;) {
      cv_work.wait(l, [&] { return stop || gen != seen; });
      if (stop) return;
      seen = gen;
      std::function<void()> j = job;
      l.unlock();
      j();
      l.lock();
      if (--pending == 0) cv_done.notify_all();
    }
  }
  std::vector<std::thread> threads;
  std::mutex mu;
  std::condition_variable cv_work, cv_done;
  std::function<void()> job;
  uint64_t gen = 0;
  size_t pending = 0;
  bool stop = false;
};

// Encode threads (main + workers): DSDKIT_FLAC_THREADS if set (lets a
// 1-core CI box exercise the pool path deterministically), else the
// hardware count.
unsigned flac_threads() {
  if (const char* e = getenv("DSDKIT_FLAC_THREADS")) {
    long v = strtol(e, nullptr, 10);
    if (v >= 1 && v <= 64) return unsigned(v);
  }
  unsigned n = std::thread::hardware_concurrency();
  return n ? n : 4;
}

struct Encoder {
  uint32_t rate, channels, bps, block_size;
  uint64_t frame_index = 0;
  uint64_t total_samples = 0;
  uint32_t min_frame = 0xFFFFFFFF, max_frame = 0;
  MD5 md5;
  std::vector<int32_t> pend;  // interleaved pending samples
  std::vector<uint8_t> out;
  unsigned n_threads;               // main + workers (flac_threads())
  int max_order = 8;                // LPC order cap (DSDKIT_FLAC_ORDER)
  std::unique_ptr<Pool> pool;       // created on first multi-block feed

  // MD5 over raw little-endian samples, ceil(bps/8) bytes each; packed
  // into a reused staging buffer with a specialized 24-bit loop (the
  // per-feed fresh vector + generic inner loop showed in the profile).
  void md5_update_samples(const int32_t* samples, size_t n_frames) {
    size_t bytes_per = (bps + 7) / 8;
    size_t n_vals = n_frames * channels;
    static thread_local std::vector<uint8_t> raw;
    raw.resize(n_vals * bytes_per);
    uint8_t* o = raw.data();
    if (bytes_per == 3) {
      size_t i = 0;
#if defined(__AVX2__)
      // 8 samples -> 24 bytes via an in-lane byte shuffle; stores
      // overlap by 4 bytes, so stop while 28 bytes of room remain
      const __m256i m = _mm256_setr_epi8(
          0, 1, 2, 4, 5, 6, 8, 9, 10, 12, 13, 14, -1, -1, -1, -1,
          0, 1, 2, 4, 5, 6, 8, 9, 10, 12, 13, 14, -1, -1, -1, -1);
      for (; i + 10 <= n_vals; i += 8, o += 24) {
        __m256i v = _mm256_shuffle_epi8(
            _mm256_loadu_si256((const __m256i*)(samples + i)), m);
        _mm_storeu_si128((__m128i*)o, _mm256_castsi256_si128(v));
        _mm_storeu_si128((__m128i*)(o + 12), _mm256_extracti128_si256(v, 1));
      }
#endif
      for (; i < n_vals; ++i) {
        uint32_t v = uint32_t(samples[i]);
        o[0] = uint8_t(v);
        o[1] = uint8_t(v >> 8);
        o[2] = uint8_t(v >> 16);
        o += 3;
      }
    } else {
      for (size_t i = 0; i < n_vals; ++i) {
        int32_t v = samples[i];
        for (size_t b = 0; b < bytes_per; ++b) *o++ = uint8_t(v >> (8 * b));
      }
    }
    md5.update(raw.data(), raw.size());
  }

  void feed(const int32_t* samples, size_t n_frames) {
    total_samples += n_frames;
    // encode straight from the caller's buffer; only the sub-block
    // remainder is staged (no O(n^2) buffer shuffling)
    const int32_t* p = samples;
    size_t left = n_frames;
    size_t bs_vals = size_t(block_size) * channels;
    bool pend_ready = false;
    if (!pend.empty()) {
      size_t have = pend.size() / channels;
      size_t take = std::min(size_t(block_size) - have, left);
      pend.insert(pend.end(), p, p + take * channels);
      p += take * channels;
      left -= take;
      pend_ready = pend.size() == bs_vals;
    }
    // fan full blocks across cores (frames are independent; order is
    // restored by indexed results — the reference parallelizes with a
    // Rayon pool at the file level, we add it inside the encoder too)
    size_t n_blocks = left / block_size;
    if (n_blocks >= 2) {
      std::vector<std::vector<uint8_t>> results(n_blocks);
      std::atomic<size_t> next{0};
      // block frames are numbered after the completed pend frame, which
      // the main thread emits below while the workers already run
      uint64_t base = frame_index + (pend_ready ? 1 : 0);
      auto worker = [&]() {
        for (;;) {
          size_t b = next.fetch_add(1);
          if (b >= n_blocks) return;
          results[b] = encode_frame(p + b * bs_vals, block_size, base + b);
        }
      };
      bool fan_out = n_threads > 1;
      if (fan_out) {
        if (!pool) pool.reset(new Pool(n_threads - 1));
        pool->launch(worker);
      }
      if (pend_ready) {
        emit(encode_frame(pend.data(), block_size, frame_index));
        pend.clear();
      }
      // MD5 is the serial floor (~27% of a 24/352.8k encode): hash on
      // this thread while the workers encode, instead of before them
      md5_update_samples(samples, n_frames);
      worker();
      if (fan_out) pool->wait();
      for (auto& r : results) emit(std::move(r));
      p += n_blocks * bs_vals;
      left -= n_blocks * block_size;
    } else {
      md5_update_samples(samples, n_frames);
      if (pend_ready) {
        emit(encode_frame(pend.data(), block_size, frame_index));
        pend.clear();
      }
      if (n_blocks == 1) {
        emit(encode_frame(p, block_size, frame_index));
        p += bs_vals;
        left -= block_size;
      }
    }
    if (left) pend.insert(pend.end(), p, p + left * channels);
  }

  void finish() {
    if (!pend.empty()) {
      emit(encode_frame(pend.data(), uint32_t(pend.size() / channels),
                        frame_index));
      pend.clear();
    }
  }

  // Encode one frame; pure w.r.t. the encoder (thread-safe given a
  // frame index), so feed() can fan blocks out across cores.
  std::vector<uint8_t> encode_frame(const int32_t* inter, uint32_t bs,
                                    uint64_t index) const {
    // deinterleave into per-thread scratch (feed() fans frames across
    // worker threads; thread_local keeps encode_frame allocation-free)
    static thread_local std::vector<std::vector<int32_t>> ch;
    ch.resize(channels);
    for (uint32_t c = 0; c < channels; ++c) ch[c].resize(bs);

    int assignment = int(channels) - 1;  // independent
    static thread_local std::vector<int32_t> mid, side;
    if (channels == 2) {
      mid.resize(bs);
      side.resize(bs);
      // one pass produces L, R, mid, side (deinterleave was two strided
      // stores per sample and showed as encode_frame's self time)
      int32_t* lp = ch[0].data();
      int32_t* rp = ch[1].data();
      uint32_t i = 0;
      uint64_t cl = 0, cr = 0, cm = 0, cs = 0;
      uint32_t vec_from = 0;  // first index the fused vector sums cover
#if defined(__AVX2__)
      // one pass: deinterleave, mid/side, AND the order-2 |residual|
      // sums the stereo-mode heuristic needs — lag-1/-2 vectors come
      // from cross-lane alignr against the previous iteration, so the
      // four separate order2_sum re-scans disappear
      const __m256i perm = _mm256_setr_epi32(0, 2, 4, 6, 1, 3, 5, 7);
      const __m256i lo32 = _mm256_set1_epi64x(0xFFFFFFFFll);
      __m256i al = _mm256_setzero_si256(), ar = al, am = al, as_ = al;
      __m256i pl = al, pr = al, pm = al, ps = al;
      for (; i + 8 <= bs; i += 8) {
        __m256i a = _mm256_loadu_si256((const __m256i*)(inter + 2 * i));
        __m256i b = _mm256_loadu_si256((const __m256i*)(inter + 2 * i + 8));
        __m256i ta = _mm256_permutevar8x32_epi32(a, perm);  // l0-3 r0-3
        __m256i tb = _mm256_permutevar8x32_epi32(b, perm);  // l4-7 r4-7
        __m256i l = _mm256_permute2x128_si256(ta, tb, 0x20);
        __m256i r = _mm256_permute2x128_si256(ta, tb, 0x31);
        __m256i m = _mm256_srai_epi32(_mm256_add_epi32(l, r), 1);
        __m256i s = _mm256_sub_epi32(l, r);
        _mm256_storeu_si256((__m256i*)(lp + i), l);
        _mm256_storeu_si256((__m256i*)(rp + i), r);
        _mm256_storeu_si256((__m256i*)(mid.data() + i), m);
        _mm256_storeu_si256((__m256i*)(side.data() + i), s);
        if (i) {
#define O2ACC(acc, cur, prev)                                              \
  {                                                                        \
    __m256i t = _mm256_permute2x128_si256(prev, cur, 0x21);                \
    __m256i s1 = _mm256_alignr_epi8(cur, t, 12);                           \
    __m256i s2 = _mm256_alignr_epi8(cur, t, 8);                            \
    __m256i d = _mm256_abs_epi32(_mm256_sub_epi32(                         \
        _mm256_sub_epi32(cur, s1), _mm256_sub_epi32(s1, s2)));             \
    acc = _mm256_add_epi64(acc, _mm256_and_si256(d, lo32));                \
    acc = _mm256_add_epi64(acc, _mm256_srli_epi64(d, 32));                 \
  }
          O2ACC(al, l, pl);
          O2ACC(ar, r, pr);
          O2ACC(am, m, pm);
          O2ACC(as_, s, ps);
#undef O2ACC
        }
        pl = l; pr = r; pm = m; ps = s;
      }
      {
        alignas(32) uint64_t t[4];
        _mm256_store_si256((__m256i*)t, al); cl = t[0] + t[1] + t[2] + t[3];
        _mm256_store_si256((__m256i*)t, ar); cr = t[0] + t[1] + t[2] + t[3];
        _mm256_store_si256((__m256i*)t, am); cm = t[0] + t[1] + t[2] + t[3];
        _mm256_store_si256((__m256i*)t, as_); cs = t[0] + t[1] + t[2] + t[3];
      }
      vec_from = (i > 8) ? 8 : 0;  // sums above cover [8, i)
#endif
      for (; i < bs; ++i) {
        int32_t l = inter[2 * i], r = inter[2 * i + 1];
        lp[i] = l;
        rp[i] = r;
        mid[i] = (l + r) >> 1;
        side[i] = l - r;
      }
      // scalar head [2, vec_from) and tail [max(2, last vector end), bs)
      auto o2_range = [&](const int32_t* x, uint32_t from, uint32_t to) {
        uint64_t s = 0;
        for (uint32_t j = std::max(from, 2u); j < to; ++j) {
          int64_t d = int64_t(x[j]) - 2 * int64_t(x[j - 1]) + int64_t(x[j - 2]);
          s += uint64_t(d < 0 ? -d : d);
        }
        return s;
      };
      uint32_t vec_to = vec_from ? (bs & ~7u) : 0;
      cl += o2_range(lp, 0, vec_from) + o2_range(lp, vec_to, bs);
      cr += o2_range(rp, 0, vec_from) + o2_range(rp, vec_to, bs);
      cm += o2_range(mid.data(), 0, vec_from) + o2_range(mid.data(), vec_to, bs);
      cs += o2_range(side.data(), 0, vec_from) + o2_range(side.data(), vec_to, bs);
      uint64_t independent = cl + cr, ls = cl + cs, rs = cr + cs, ms = cm + cs;
      uint64_t best = std::min(std::min(independent, ms), std::min(ls, rs));
      if (best == ls) assignment = 8;
      else if (best == rs) assignment = 9;
      else if (best == ms) assignment = 10;
    } else {
      for (uint32_t i = 0; i < bs; ++i)
        for (uint32_t c = 0; c < channels; ++c)
          ch[c][i] = inter[i * channels + c];
    }

    // frame header
    std::vector<uint8_t> hdr;
    {
      BitWriter h;
      h.put(0x3FFE, 14);  // sync
      h.put(0, 1);        // reserved
      h.put(0, 1);        // fixed blocksize stream
      int bs_code;
      int bs_tail_bits = 0;
      uint32_t bs_tail = 0;
      if (bs == block_size && bs >= 256 && bs <= 16384 &&
          (bs & (bs - 1)) == 0) {
        // direct codes 8..14 = 256 * 2^k (4096 -> 12, 8192 -> 13)
        int k = 0;
        while ((256u << k) != uint32_t(bs)) ++k;
        bs_code = 8 + k;
      } else if (bs == block_size && bs == 4608) bs_code = 5;  // 576*2^3
      else if (bs == block_size && bs == 192) bs_code = 1;
      else { bs_code = 7; bs_tail_bits = 16; bs_tail = bs - 1; }
      h.put(uint32_t(bs_code), 4);
      h.put(uint32_t(sample_rate_code(rate)), 4);
      h.put(uint32_t(assignment), 4);
      h.put(uint32_t(sample_size_code(int(bps))), 3);
      h.put(0, 1);  // reserved
      h.trim();
      hdr = std::move(h.buf);
      write_utf8(hdr, index);
      if (bs_tail_bits) {
        hdr.push_back(uint8_t(bs_tail >> 8));
        hdr.push_back(uint8_t(bs_tail));
      }
      hdr.push_back(crc8(hdr.data(), hdr.size()));
    }

    BitWriter bw;
    bw.seed(std::move(hdr));
    bw.ensure(size_t(bs) * channels * (bps + 8) / 8 / 2);  // one grow for typical frames
    if (channels == 2 && assignment >= 8) {
      if (assignment == 8) {        // left/side
        write_subframe(bw, ch[0].data(), bs, int(bps), max_order);
        write_subframe(bw, side.data(), bs, int(bps) + 1, max_order);
      } else if (assignment == 9) { // right/side
        write_subframe(bw, side.data(), bs, int(bps) + 1, max_order);
        write_subframe(bw, ch[1].data(), bs, int(bps), max_order);
      } else {                      // mid/side
        write_subframe(bw, mid.data(), bs, int(bps), max_order);
        write_subframe(bw, side.data(), bs, int(bps) + 1, max_order);
      }
    } else {
      for (uint32_t c = 0; c < channels; ++c)
        write_subframe(bw, ch[c].data(), bs, int(bps), max_order);
    }
    bw.align_byte();
    bw.trim();
    uint16_t c16 = crc16(bw.buf.data(), bw.buf.size());
    bw.buf.push_back(uint8_t(c16 >> 8));
    bw.buf.push_back(uint8_t(c16));
    return std::move(bw.buf);
  }

  void emit(std::vector<uint8_t>&& frame) {
    uint32_t fsz = uint32_t(frame.size());
    min_frame = std::min(min_frame, fsz);
    max_frame = std::max(max_frame, fsz);
    out.insert(out.end(), frame.begin(), frame.end());
    ++frame_index;
  }

  // 4-byte "fLaC" + 4-byte block header + 34-byte STREAMINFO
  void header(uint8_t* dst, int is_last) {
    uint8_t md[16];
    MD5 m = md5;  // copy so header() can be called before/after finish
    m.finish(md);
    uint8_t* p = dst;
    memcpy(p, "fLaC", 4); p += 4;
    *p++ = uint8_t((is_last ? 0x80 : 0x00) | 0x00);  // STREAMINFO
    *p++ = 0; *p++ = 0; *p++ = 34;
    auto put16 = [&](uint32_t v) { *p++ = uint8_t(v >> 8); *p++ = uint8_t(v); };
    auto put24 = [&](uint32_t v) { *p++ = uint8_t(v >> 16); *p++ = uint8_t(v >> 8); *p++ = uint8_t(v); };
    put16(block_size);  // min block
    put16(block_size);  // max block (frames may be shorter at EOF: spec allows equal declared)
    put24(min_frame == 0xFFFFFFFF ? 0 : min_frame);
    put24(max_frame);
    // 20 bits rate, 3 bits ch-1, 5 bits bps-1, 36 bits total samples
    uint64_t v = (uint64_t(rate) << 44) | (uint64_t(channels - 1) << 41) |
                 (uint64_t(bps - 1) << 36) | (total_samples & 0xFFFFFFFFFull);
    for (int i = 7; i >= 0; --i) *p++ = uint8_t(v >> (8 * i));
    memcpy(p, md, 16);
  }
};

}  // namespace

DSDKIT_API void* dsdkit_flac_new(uint32_t rate, uint32_t channels,
                                 uint32_t bps, uint32_t block_size) {
  // Validate at the ABI boundary (like njad_new), not just in the
  // Python FlacWriter: bps > 24 would overflow int32 in the side
  // channel (l - r is UB at 32-bit full scale) and exceed BitWriter's
  // 32-bit put for the bps+1-bit side subframe; bps < 4 / channels > 8
  // / block_size outside 16..32768 are outside both the spec and the
  // encoder's assumptions. nullptr maps to ConfigError in the loader.
  if (rate == 0 || channels == 0 || channels > 8 || bps < 4 || bps > 24)
    return nullptr;
  if (block_size == 0) block_size = 4096;
  if (block_size < 16 || block_size > 32768) return nullptr;
  auto* e = new Encoder();
  e->rate = rate;
  e->channels = channels;
  e->bps = bps;
  e->block_size = block_size;
  e->n_threads = flac_threads();
  // LPC order cap. The order is selected PER BLOCK up to this cap from
  // the Levinson recursion's own per-order error terms. Default 8:
  // measured on real DSD-sourced 352.8k/24 PCM (interleaved
  // median-of-pairs vs the old always-order-8 encoder), selection at
  // cap 8 is a few % faster at identical ratio; cap 12 compresses 2.3%
  // smaller at ~4% slower; cap 16 4.9% smaller at ~8% slower. Speed
  // keeps the >1000x-device-output pace (SURVEY §2.3), so 12/16 are
  // opt-in. Read per encoder so one process can A/B orders.
  if (const char* oenv = getenv("DSDKIT_FLAC_ORDER")) {
    long v = strtol(oenv, nullptr, 10);
    // caps 9-15 snap up to the next AVX2 autocorrelation template
    // (8/12/16): the selector can still pick any lower order per
    // block, but a 9-11/13-15 cap would silently fall off the
    // vectorized analysis path and encode SLOWER than the next cap up.
    if (v > 8 && v < 12) v = 12;
    else if (v > 12 && v < 16) v = 16;
    if (v >= 1 && v <= 16) e->max_order = int(v);
  }
  return e;
}

DSDKIT_API void dsdkit_flac_feed(void* enc, const int32_t* samples,
                                 size_t n_frames) {
  static_cast<Encoder*>(enc)->feed(samples, n_frames);
}

DSDKIT_API void dsdkit_flac_finish(void* enc) {
  static_cast<Encoder*>(enc)->finish();
}

DSDKIT_API size_t dsdkit_flac_pending(void* enc) {
  return static_cast<Encoder*>(enc)->out.size();
}

DSDKIT_API size_t dsdkit_flac_drain(void* enc, uint8_t* dst, size_t cap) {
  auto* e = static_cast<Encoder*>(enc);
  size_t n = std::min(cap, e->out.size());
  memcpy(dst, e->out.data(), n);
  e->out.erase(e->out.begin(), e->out.begin() + n);
  return n;
}

DSDKIT_API void dsdkit_flac_header(void* enc, uint8_t* dst42, int is_last) {
  static_cast<Encoder*>(enc)->header(dst42, is_last);
}

DSDKIT_API void dsdkit_flac_free(void* enc) {
  delete static_cast<Encoder*>(enc);
}
