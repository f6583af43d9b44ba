// A plain FLAC reader, written from the format (RFC 9639): the stream's
// metadata (STREAMINFO first), frame headers with their CRC-8, CONSTANT,
// VERBATIM, FIXED and LPC subframes, Rice partitions with 4- and 5-bit
// parameters and their escape, wasted bits, left/side, side/right and
// mid/side channels, and each frame's CRC-16.
//
// Two readers share it: `Scanner`, which counts a stream's frames as it
// streams past (no decoding: a frame counts where its header and its
// CRC-16 check), and `decode`, which decodes a whole stream to samples.
#pragma once

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <vector>

namespace benchflac {

enum Err {
  OK = 0,
  E_MAGIC = -1,        // no "fLaC" marker
  E_META = -2,         // a metadata block is malformed
  E_STREAMINFO = -3,   // STREAMINFO missing, first or out of range
  E_SYNC = -4,         // no frame sync code where a frame must start
  E_HEADER = -5,       // a frame header field is reserved or invalid
  E_HEADER_CRC = -6,   // a frame header's CRC-8 fails
  E_SUBFRAME = -7,     // a subframe header or its fields are invalid
  E_RESIDUAL = -8,     // a residual's coding or partitions are invalid
  E_FRAME_CRC = -9,    // a frame's CRC-16 fails
  E_TRUNCATED = -10,   // the stream ends inside a block or a frame
  E_MISMATCH = -11,    // a frame disagrees with STREAMINFO
  E_ORDER = -12,       // frame numbers out of sequence, or a short
                       // block before the last
  E_CAPACITY = -13,    // more samples than the caller made room for
  E_RANGE = -14,       // a sample outside the stream's bit depth
  E_PADDING = -15,     // a frame's padding bits are not zero
};

inline const char* err_name(int e) {
  switch (e) {
    case OK: return "ok";
    case E_MAGIC: return "no fLaC marker";
    case E_META: return "malformed metadata block";
    case E_STREAMINFO: return "bad STREAMINFO";
    case E_SYNC: return "no frame sync";
    case E_HEADER: return "invalid frame header";
    case E_HEADER_CRC: return "frame header CRC-8 fails";
    case E_SUBFRAME: return "invalid subframe";
    case E_RESIDUAL: return "invalid residual";
    case E_FRAME_CRC: return "frame CRC-16 fails";
    case E_TRUNCATED: return "stream truncated";
    case E_MISMATCH: return "frame disagrees with STREAMINFO";
    case E_ORDER: return "frames out of sequence";
    case E_CAPACITY: return "more samples than expected";
    case E_RANGE: return "sample outside the bit depth";
    case E_PADDING: return "nonzero frame padding";
  }
  return "unknown";
}

struct Tables {
  uint8_t c8[256];
  uint16_t c16[256];
  Tables() {
    for (int i = 0; i < 256; ++i) {
      unsigned c = i;
      for (int k = 0; k < 8; ++k) c = ((c << 1) ^ (c & 0x80 ? 0x07 : 0)) & 0xFF;
      c8[i] = (uint8_t)c;
      unsigned d = (unsigned)i << 8;
      for (int k = 0; k < 8; ++k)
        d = ((d << 1) ^ (d & 0x8000 ? 0x8005 : 0)) & 0xFFFF;
      c16[i] = (uint16_t)d;
    }
  }
};

inline const Tables& tables() {
  static const Tables t;
  return t;
}

// CRC-8 (x^8 + x^2 + x + 1) and CRC-16 (x^16 + x^15 + x^2 + 1), both from
// 0, unreflected: a frame followed by its own CRC-16 sums to 0
inline uint8_t crc8(const uint8_t* p, size_t n, uint8_t c = 0) {
  const Tables& t = tables();
  for (size_t i = 0; i < n; ++i) c = t.c8[c ^ p[i]];
  return c;
}

inline uint16_t crc16(const uint8_t* p, size_t n, uint16_t c = 0) {
  const Tables& t = tables();
  for (size_t i = 0; i < n; ++i)
    c = (uint16_t)((c << 8) ^ t.c16[((c >> 8) ^ p[i]) & 0xFF]);
  return c;
}

struct StreamInfo {
  int min_block = 0, max_block = 0, rate = 0, channels = 0, bits = 0;
  uint64_t total = 0;  // samples per channel; 0 where unknown
  uint8_t md5[16] = {};
};

inline uint32_t be(const uint8_t* p, int n) {
  uint32_t v = 0;
  for (int i = 0; i < n; ++i) v = (v << 8) | p[i];
  return v;
}

// The marker and the metadata blocks of p[0, n): STREAMINFO into *si and
// the first frame's offset into *frames_at. E_TRUNCATED where the
// metadata does not end inside n bytes.
inline int parse_metadata(const uint8_t* p, size_t n, StreamInfo* si,
                          size_t* frames_at) {
  if (n < 4) return E_TRUNCATED;
  if (memcmp(p, "fLaC", 4) != 0) return E_MAGIC;
  size_t pos = 4;
  bool first = true;
  for (;;) {
    if (pos + 4 > n) return E_TRUNCATED;
    bool last = p[pos] & 0x80;
    int type = p[pos] & 0x7F;
    size_t len = be(p + pos + 1, 3);
    if (type == 127) return E_META;
    if (first != (type == 0)) return E_STREAMINFO;
    if (pos + 4 + len > n) return E_TRUNCATED;
    if (type == 0) {
      if (len != 34) return E_STREAMINFO;
      const uint8_t* b = p + pos + 4;
      si->min_block = (int)be(b, 2);
      si->max_block = (int)be(b + 2, 2);
      si->rate = (int)(be(b + 10, 3) >> 4);
      si->channels = ((b[12] >> 1) & 7) + 1;
      si->bits = (((b[12] & 1) << 4) | (b[13] >> 4)) + 1;
      si->total = ((uint64_t)(b[13] & 0x0F) << 32) | be(b + 14, 4);
      memcpy(si->md5, b + 18, 16);
      if (si->min_block < 16 || si->max_block < si->min_block ||
          si->rate == 0 || si->bits < 4)
        return E_STREAMINFO;
    }
    first = false;
    pos += 4 + len;
    if (last) break;
  }
  *frames_at = pos;
  return OK;
}

struct FrameHeader {
  int variable = 0;    // blocking strategy: 1 = numbered by sample
  int block = 0;       // samples per channel
  int rate = 0, channels = 0, bits = 0;
  int assignment = 0;  // 0-7 independent, 8 left/side, 9 side/right,
                       // 10 mid/side
  uint64_t number = 0; // frame number, or first sample's number
  int length = 0;      // header bytes, its CRC-8 included
};

// The frame header at p[0, n), checked against STREAMINFO.
inline int parse_header(const uint8_t* p, size_t n, const StreamInfo& si,
                        FrameHeader* h) {
  if (n < 2) return E_TRUNCATED;
  if (p[0] != 0xFF || (p[1] & 0xFE) != 0xF8) return E_SYNC;
  if (n < 5) return E_TRUNCATED;
  h->variable = p[1] & 1;
  int bs = p[2] >> 4, sr = p[2] & 15, ca = p[3] >> 4, ss = (p[3] >> 1) & 7;
  if (bs == 0 || sr == 15 || ca >= 11 || ss == 3 || (p[3] & 1))
    return E_HEADER;
  size_t pos = 4;
  unsigned x = p[pos++];
  uint64_t v;
  int more;
  if (x < 0x80) {
    v = x, more = 0;
  } else {
    int ones = __builtin_clz(~(x << 24) & 0xFFFFFFFFu);
    if (ones < 2 || ones > 7 || (!h->variable && ones > 6)) return E_HEADER;
    v = x & (0x7Fu >> ones);
    more = ones - 1;
  }
  if (n < pos + more + 4) return E_TRUNCATED;
  for (int i = 0; i < more; ++i) {
    unsigned c = p[pos++];
    if ((c & 0xC0) != 0x80) return E_HEADER;
    v = (v << 6) | (c & 0x3F);
  }
  h->number = v;
  if (bs == 1) h->block = 192;
  else if (bs <= 5) h->block = 576 << (bs - 2);
  else if (bs == 6) h->block = p[pos++] + 1;
  else if (bs == 7) h->block = (int)be(p + pos, 2) + 1, pos += 2;
  else h->block = 256 << (bs - 8);
  static const int rates[12] = {0, 88200, 176400, 192000, 8000, 16000,
                                22050, 24000, 32000, 44100, 48000, 96000};
  if (sr == 0) h->rate = si.rate;
  else if (sr < 12) h->rate = rates[sr];
  else if (sr == 12) h->rate = p[pos++] * 1000;
  else if (sr == 13) h->rate = (int)be(p + pos, 2), pos += 2;
  else h->rate = (int)be(p + pos, 2) * 10, pos += 2;
  static const int sizes[8] = {0, 8, 12, 0, 16, 20, 24, 32};
  h->bits = ss == 0 ? si.bits : sizes[ss];
  h->assignment = ca;
  h->channels = ca < 8 ? ca + 1 : 2;
  if (pos >= n) return E_TRUNCATED;
  if (crc8(p, pos) != p[pos]) return E_HEADER_CRC;
  h->length = (int)pos + 1;
  if (h->rate != si.rate || h->bits != si.bits ||
      h->channels != si.channels || h->block > si.max_block)
    return E_MISMATCH;
  return OK;
}

// ---- counting frames as a stream passes ---------------------------------

// Counts the frames of a stream fed in pieces: a frame counts where its
// header parses and checks and the CRC-16 over it and its stored CRC sums
// to 0. A frame ends where the next frame's header starts (its number the
// one that follows) or at the stream's end. Whatever does not count is
// counted as bad: a frame whose CRC-16 fails, a frame out of sequence, a
// short block before the last, bytes outside any frame, a stream whose
// metadata is malformed or missing.
struct Scanner {
  StreamInfo si;
  int state = 0;  // 0 metadata, 1 frames, 2 unreadable
  std::vector<uint8_t> buf;  // bytes not yet consumed
  bool in_frame = false;
  FrameHeader cur;
  uint16_t crc = 0;
  uint64_t expect = 0;  // the next frame's number
  bool short_seen = false;
  int64_t frames = 0, samples = 0, bad = 0, stray = 0;

  uint64_t after(const FrameHeader& h) const {
    return h.variable ? h.number + (uint64_t)h.block : h.number + 1;
  }

  void end_frame(bool crc_ok) {
    if (!crc_ok) {
      ++bad;
    } else {
      if (short_seen) ++bad;  // a short block that was not the last
      ++frames;
      samples += cur.block;
    }
    // only a stream of fixed block size has its short block last
    if (!cur.variable && cur.block != si.max_block) short_seen = true;
    in_frame = false;
  }

  void start_frame(const uint8_t* p, const FrameHeader& h) {
    if (h.number != expect) ++bad;
    cur = h;
    expect = after(h);
    crc = crc16(p, (size_t)h.length);
    in_frame = true;
  }

  void feed(const uint8_t* p, size_t n) {
    buf.insert(buf.end(), p, p + n);
    run(false);
  }

  void finish() {
    run(true);
    if (state == 0) ++bad;  // the stream ended inside its metadata
    if (in_frame) end_frame(crc == 0);
    stray += (int64_t)buf.size();
    buf.clear();
  }

  void run(bool eof) {
    if (state == 0) {
      size_t at = 0;
      int e = parse_metadata(buf.data(), buf.size(), &si, &at);
      if (e == E_TRUNCATED) return;
      if (e != OK) {
        state = 2, ++bad;
      } else {
        state = 1;
        buf.erase(buf.begin(), buf.begin() + (long)at);
      }
    }
    if (state == 2) {
      stray += (int64_t)buf.size();
      buf.clear();
      return;
    }
    const uint8_t* b = buf.data();
    size_t n = buf.size(), k = 0;
    while (k < n) {
      if (!in_frame) {
        FrameHeader h;
        int e = parse_header(b + k, n - k, si, &h);
        if (e == E_TRUNCATED && !eof) break;
        if (e == OK) {
          start_frame(b + k, h);
          k += (size_t)h.length;
        } else {
          ++stray, ++k;
        }
        continue;
      }
      const uint8_t* ff = (const uint8_t*)memchr(b + k, 0xFF, n - k);
      size_t j = ff ? (size_t)(ff - b) : n;
      crc = crc16(b + k, j - k, crc);
      k = j;
      if (k == n) break;
      FrameHeader h;
      int e = parse_header(b + k, n - k, si, &h);
      if (e == E_TRUNCATED && !eof) break;
      if (e == OK && h.number == after(cur)) {
        end_frame(crc == 0);
        start_frame(b + k, h);
        k += (size_t)h.length;
      } else {
        crc = crc16(b + k, 1, crc);
        ++k;
      }
    }
    buf.erase(buf.begin(), buf.begin() + (long)k);
  }
};

// ---- decoding -------------------------------------------------------------

struct Bits {
  const uint8_t* start;
  const uint8_t* p;
  const uint8_t* end;
  uint64_t acc = 0;  // the next n bits, left-aligned; the rest 0
  int n = 0;
  bool over = false;

  Bits(const uint8_t* a, const uint8_t* b) : start(a), p(a), end(b) {}

  void fill() {
    while (n <= 56 && p < end) {
      acc |= (uint64_t)(*p++) << (56 - n);
      n += 8;
    }
  }

  uint32_t get(int k) {  // k <= 32
    if (k == 0) return 0;
    if (n < k) fill();
    if (n < k) {
      over = true;
      return 0;
    }
    uint32_t v = (uint32_t)(acc >> (64 - k));
    acc <<= k;
    n -= k;
    return v;
  }

  int64_t sget(int k) {  // k <= 33, two's complement
    if (k == 0) return 0;
    uint64_t v = k > 32 ? ((uint64_t)get(k - 32) << 32) | get(32) : get(k);
    int s = 64 - k;
    return (int64_t)(v << s) >> s;
  }

  uint32_t unary() {  // zeros before the next 1
    uint32_t zeros = 0;
    for (;;) {
      if (n == 0) {
        fill();
        if (n == 0) {
          over = true;
          return 0;
        }
      }
      if (acc == 0) {
        zeros += n;
        n = 0;
        continue;
      }
      int lz = __builtin_clzll(acc);
      acc <<= lz;
      acc <<= 1;
      n -= lz + 1;
      return zeros + lz;
    }
  }

  // bytes consumed, and whether the bits to the byte's end are all 0
  size_t align(bool* zero) {
    int r = n % 8;
    *zero = r == 0 || get(r) == 0;
    return (size_t)(p - start) - (size_t)(n / 8);
  }
};

inline int residual(Bits& b, int block, int order, int64_t* out) {
  unsigned method = b.get(2);
  if (method > 1) return E_RESIDUAL;
  int pbits = method ? 5 : 4;
  unsigned escape = method ? 31 : 15;
  int porder = (int)b.get(4);
  int parts = 1 << porder;
  if (block % parts) return E_RESIDUAL;
  int psize = block >> porder;
  if (psize < order) return E_RESIDUAL;
  int i = order;
  for (int part = 0; part < parts; ++part) {
    int count = psize - (part == 0 ? order : 0);
    unsigned k = b.get(pbits);
    if (k == escape) {
      int raw = (int)b.get(5);
      for (int j = 0; j < count; ++j) out[i++] = b.sget(raw);
    } else {
      for (int j = 0; j < count; ++j) {
        uint64_t u = ((uint64_t)b.unary() << k) | b.get((int)k);
        out[i++] = (int64_t)(u >> 1) ^ -(int64_t)(u & 1);
      }
    }
    if (b.over) return E_TRUNCATED;
  }
  return OK;
}

inline int subframe(Bits& b, int bps, int block, int64_t* out) {
  if (b.get(1) != 0) return E_SUBFRAME;
  unsigned type = b.get(6);
  int wasted = 0;
  if (b.get(1)) wasted = (int)b.unary() + 1;
  if (b.over) return E_TRUNCATED;
  bps -= wasted;
  if (bps < 1) return E_SUBFRAME;
  if (type == 0) {
    int64_t v = b.sget(bps);
    for (int i = 0; i < block; ++i) out[i] = v;
  } else if (type == 1) {
    for (int i = 0; i < block; ++i) out[i] = b.sget(bps);
  } else if (type >= 8 && type <= 12) {
    int order = (int)type - 8;
    if (order > block) return E_SUBFRAME;
    for (int i = 0; i < order; ++i) out[i] = b.sget(bps);
    int e = residual(b, block, order, out);
    if (e != OK) return e;
    for (int i = order; i < block; ++i) {
      int64_t a = i >= 1 ? out[i - 1] : 0, c = i >= 2 ? out[i - 2] : 0,
              d = i >= 3 ? out[i - 3] : 0, f = i >= 4 ? out[i - 4] : 0;
      switch (order) {
        case 1: out[i] += a; break;
        case 2: out[i] += 2 * a - c; break;
        case 3: out[i] += 3 * a - 3 * c + d; break;
        case 4: out[i] += 4 * a - 6 * c + 4 * d - f; break;
        default: break;
      }
    }
  } else if (type >= 32) {
    int order = (int)type - 31;
    if (order > block) return E_SUBFRAME;
    for (int i = 0; i < order; ++i) out[i] = b.sget(bps);
    int precision = (int)b.get(4) + 1;
    int shift = (int)b.sget(5);
    if (precision == 16 || shift < 0) return E_SUBFRAME;
    int64_t coef[32];
    for (int j = 0; j < order; ++j) coef[j] = b.sget(precision);
    if (b.over) return E_TRUNCATED;
    int e = residual(b, block, order, out);
    if (e != OK) return e;
    for (int i = order; i < block; ++i) {
      int64_t sum = 0;
      for (int j = 0; j < order; ++j) sum += coef[j] * out[i - 1 - j];
      out[i] += sum >> shift;
    }
  } else {
    return E_SUBFRAME;
  }
  if (b.over) return E_TRUNCATED;
  if (wasted)
    for (int i = 0; i < block; ++i) out[i] = (int64_t)((uint64_t)out[i] << wasted);
  return OK;
}

// One frame at p[0, n): its samples into out[c][pos ...] (each channel
// holding `cap` samples), its size into *used.
inline int frame(const uint8_t* p, size_t n, const StreamInfo& si,
                 FrameHeader* h, std::vector<int64_t>* scratch, int32_t* out,
                 int64_t cap, int64_t pos, size_t* used) {
  int e = parse_header(p, n, si, h);
  if (e != OK) return e;
  int block = h->block, ch = h->channels;
  if (pos + block > cap) return E_CAPACITY;
  scratch->resize((size_t)block * (size_t)ch);
  int64_t* s = scratch->data();
  Bits b(p + h->length, p + n);
  for (int c = 0; c < ch; ++c) {
    bool side = (h->assignment == 8 && c == 1) ||
                (h->assignment == 9 && c == 0) ||
                (h->assignment == 10 && c == 1);
    e = subframe(b, h->bits + (side ? 1 : 0), block, s + (size_t)c * block);
    if (e != OK) return e;
  }
  bool zero;
  size_t at = (size_t)h->length + b.align(&zero);
  if (!zero) return E_PADDING;
  if (at + 2 > n) return E_TRUNCATED;
  if (crc16(p, at + 2) != 0) return E_FRAME_CRC;
  int64_t* l = s;
  int64_t* r = s + block;
  for (int i = 0; i < block && h->assignment >= 8; ++i) {
    if (h->assignment == 8) {
      r[i] = l[i] - r[i];
    } else if (h->assignment == 9) {
      l[i] = l[i] + r[i];
    } else {
      int64_t mid = (int64_t)((uint64_t)l[i] << 1) | (r[i] & 1);
      int64_t side = r[i];
      l[i] = (mid + side) >> 1;
      r[i] = (mid - side) >> 1;
    }
  }
  int64_t lo = -((int64_t)1 << (h->bits - 1)), hi = -lo - 1;
  for (int c = 0; c < ch; ++c)
    for (int i = 0; i < block; ++i) {
      int64_t v = s[(size_t)c * block + i];
      if (v < lo || v > hi) return E_RANGE;
      out[(size_t)c * (size_t)cap + (size_t)(pos + i)] = (int32_t)v;
    }
  *used = at + 2;
  return OK;
}

// A whole stream: its samples into out (channel c at out[c * cap]).
// Returns the samples per channel, or an Err; *si its STREAMINFO and
// *err_at the byte offset where decoding stopped.
inline int64_t decode(const uint8_t* p, size_t n, int32_t* out, int64_t cap,
                      int channels, StreamInfo* si, int64_t* n_frames,
                      int64_t* err_at) {
  size_t off = 0;
  *n_frames = 0;
  *err_at = 0;
  int e = parse_metadata(p, n, si, &off);
  if (e != OK) return e;
  if (si->channels != channels) return E_MISMATCH;
  std::vector<int64_t> scratch;
  int64_t pos = 0;
  bool short_seen = false;
  int variable = -1;
  while (off < n) {
    FrameHeader h;
    size_t used = 0;
    *err_at = (int64_t)off;
    e = frame(p + off, n - off, *si, &h, &scratch, out, cap, pos, &used);
    if (e != OK) return e;
    if (variable < 0) variable = h.variable;
    uint64_t want = h.variable ? (uint64_t)pos : (uint64_t)*n_frames;
    if (short_seen || h.variable != variable || h.number != want)
      return E_ORDER;
    // only a stream of fixed block size has its short block last
    if (!h.variable && h.block != si->max_block) short_seen = true;
    pos += h.block;
    off += used;
    ++*n_frames;
  }
  *err_at = (int64_t)off;
  if (si->total != 0 && si->total != (uint64_t)pos) return E_MISMATCH;
  return pos;
}

}  // namespace benchflac
