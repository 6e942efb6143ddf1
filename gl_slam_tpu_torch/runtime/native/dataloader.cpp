// Native frame loader: PNG grayscale decode + threaded prefetch ring.
//
// The port's copy of the JAX package's loader: a pool of decoder threads
// keeps a bounded ring of decoded float32 frames ahead of the tracker, so
// image decode runs off the hot loop, and frames come out in path order.
//
// The PNG reader is the port's own (no libpng, no zlib): the signature,
// IHDR, PLTE, tRNS, IDAT split over any number of chunks and IEND, CRC-32
// on every critical chunk and on tRNS, and the zlib stream (RFC 1950) with
// its stored, fixed- and dynamic-Huffman deflate blocks (RFC 1951) and its
// Adler-32. It gives what the JAX loader's libpng set-up gives (palette to
// RGB, gray 1/2/4 bits to 8, 16 bits to the high byte, alpha stripped,
// RGB to gray with libpng's default coefficients and rounding, in libpng's
// order), and refuses what libpng refuses, so the loader skips that frame:
//   * a file libpng stops on: bad signature, IHDR, CRC of a critical
//     chunk, zlib header, deflate data, filter type, missing PLTE, too
//     little image data, a chunk past libpng's length limits;
// and, where JAX's output is not the image:
//   * an interlaced (Adam7) file: the JAX loader reads the pass rows as
//     if they were image rows, the bytes past each pass row left from
//     earlier rows in libpng's row buffer;
//   * a colour file with gAMA, cHRM, sRGB or iCCP: libpng then converts
//     to gray through gamma tables or the chunk's own coefficients;
//   * damage in the zlib stream after the image's last byte (a bad
//     Adler-32, a stream that does not end): libpng reports it, or not,
//     depending on where its 8 KiB read windows fall.
// A palette file with tRNS is decoded as libpng does it for the JAX loader:
// the palette expands to RGBA, the alpha channel is not stripped, so a row
// is (gray, alpha) pairs, of which the first `w` bytes are read.
//
// Admission: a decoded frame waits for room in the ring (`depth` frames
// ready or parked, plus one per worker) -- except the in-order frame
// `next_emit`, which is always admitted. Without that exception the ring
// can fill with later, out-of-order frames while the worker holding
// `next_emit` waits for room; the consumer then waits for `next_emit`,
// which can never be parked, and nothing moves again.
//
// C ABI (ctypes-friendly), no C++ types across the boundary. Links nothing
// but the C++ runtime and pthreads.

#include <algorithm>
#include <array>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// CRC-32 (PNG chunks) and Adler-32 (the zlib trailer)

const uint32_t* crc_table() {
  static const auto table = [] {
    std::array<uint32_t, 256> t{};
    for (uint32_t n = 0; n < 256; ++n) {
      uint32_t c = n;
      for (int k = 0; k < 8; ++k) c = (c & 1) ? 0xedb88320u ^ (c >> 1) : c >> 1;
      t[n] = c;
    }
    return t;
  }();
  return table.data();
}

uint32_t crc32(const uint8_t* p, size_t n) {
  const uint32_t* t = crc_table();
  uint32_t c = 0xffffffffu;
  for (size_t i = 0; i < n; ++i) c = t[(c ^ p[i]) & 0xff] ^ (c >> 8);
  return c ^ 0xffffffffu;
}

uint32_t adler32(const uint8_t* p, size_t n) {
  uint32_t a = 1, b = 0;
  while (n > 0) {
    size_t k = n < 5552 ? n : 5552;    // no overflow before the modulo
    n -= k;
    while (k--) {
      a += *p++;
      b += a;
    }
    a %= 65521;
    b %= 65521;
  }
  return (b << 16) | a;
}

uint32_t be32(const uint8_t* p) {
  return (uint32_t)p[0] << 24 | (uint32_t)p[1] << 16 | (uint32_t)p[2] << 8 |
         p[3];
}

// ---------------------------------------------------------------------------
// Inflate (RFC 1950 / 1951), with zlib's checks

struct Bits {
  const uint8_t* p;
  size_t n, pos = 0;
  uint64_t hold = 0;
  int bits = 0;
  // Top the bit buffer up to 56 or more bits, eight bytes at a time where
  // the input has them (little-endian loads).
  void refill() {
    if (n - pos >= 8) {
      uint64_t v;
      std::memcpy(&v, p + pos, 8);
      hold |= v << bits;
      pos += (63 - bits) >> 3;
      bits |= 56;
      return;
    }
    while (bits <= 56 && pos < n) {
      hold |= (uint64_t)p[pos++] << bits;
      bits += 8;
    }
  }
  bool need(int k) {
    if (bits < k) refill();
    return bits >= k;
  }
  bool get(int k, uint32_t* v) {
    if (!need(k)) return false;
    *v = (uint32_t)(hold & ((1ull << k) - 1));
    hold >>= k;
    bits -= k;
    return true;
  }
  void align() {
    hold >>= bits & 7;
    bits -= bits & 7;
  }
};

// The inflated bytes: a buffer that grows by doubling up to `max`.
struct Out {
  std::vector<uint8_t> buf;
  size_t len = 0, max = 0;
  bool room(size_t k) {
    if (len + k <= buf.size()) return true;
    if (len + k > max) return false;
    buf.resize(std::min(max, std::max(len + k, 2 * buf.size())));
    return true;
  }
};

// A canonical Huffman code: symbols by code length, and a table of the
// next kFast bits for the codes that short.
struct Huffman {
  static constexpr int kFast = 9;
  uint16_t count[16] = {};
  uint16_t symbol[320] = {};
  uint16_t fast[1 << kFast] = {};   // symbol + 1 | length << 10; 0: slow path
};

// zlib's inflate_table rules: over-subscribed is an error; incomplete is
// an error but for a literal/length or distance code of one length-1 code;
// a distance code of no code at all is valid until a distance is read.
enum class Kind { kCodes, kLens, kDists };

bool build(Huffman* h, const uint8_t* lengths, int n, Kind kind) {
  *h = Huffman();
  int max = 0;
  for (int i = 0; i < n; ++i) {
    h->count[lengths[i]]++;
    if (lengths[i] > max) max = lengths[i];
  }
  h->count[0] = 0;
  if (max == 0) return kind != Kind::kCodes;
  int left = 1;
  for (int len = 1; len < 16; ++len) {
    left = (left << 1) - h->count[len];
    if (left < 0) return false;
  }
  if (left > 0 && (kind == Kind::kCodes || max != 1)) return false;
  uint16_t offs[16] = {};
  for (int len = 1; len < 15; ++len) offs[len + 1] = offs[len] + h->count[len];
  for (int i = 0; i < n; ++i)
    if (lengths[i]) h->symbol[offs[lengths[i]]++] = (uint16_t)i;
  // the short codes' table, indexed by the stream's next bits (LSB first)
  int code = 0, index = 0;
  for (int len = 1; len <= Huffman::kFast; ++len) {
    for (int k = 0; k < h->count[len]; ++k, ++code, ++index) {
      int rev = 0;
      for (int b = 0; b < len; ++b) rev |= ((code >> b) & 1) << (len - 1 - b);
      for (int e = rev; e < (1 << Huffman::kFast); e += 1 << len)
        h->fast[e] = (uint16_t)((h->symbol[index] + 1) | (len << 10));
    }
    code <<= 1;
  }
  return true;
}

// The next symbol; -1 when the input ends, -2 for a code not in the set.
int decode(Bits* in, const Huffman& h) {
  in->need(Huffman::kFast);     // may stop short at the end of the input
  uint16_t e = h.fast[in->hold & ((1u << Huffman::kFast) - 1)];
  if (e && (e >> 10) <= in->bits) {
    in->hold >>= e >> 10;
    in->bits -= e >> 10;
    return (e & 1023) - 1;
  }
  int code = 0, first = 0, index = 0;
  for (int len = 1; len < 16; ++len) {
    uint32_t b;
    if (!in->get(1, &b)) return -1;
    code |= (int)b;
    int count = h.count[len];
    if (code - count < first) return h.symbol[index + (code - first)];
    index += count;
    first = (first + count) << 1;
    code <<= 1;
  }
  return -2;
}

const uint16_t kLenBase[29] = {3,  4,  5,  6,  7,  8,  9,  10,  11,  13,
                               15, 17, 19, 23, 27, 31, 35, 43,  51,  59,
                               67, 83, 99, 115, 131, 163, 195, 227, 258};
const uint8_t kLenExtra[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2,
                               2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
const uint16_t kDistBase[30] = {
    1,    2,    3,    4,    5,    7,     9,     13,    17,  25,
    33,   49,   65,   97,   129,  193,   257,   385,   513, 769,
    1025, 1537, 2049, 3073, 4097, 6145, 8193, 12289, 16385, 24577};
const uint8_t kDistExtra[30] = {0, 0, 0, 0, 1, 1, 2,  2,  3,  3,
                                4, 4, 5, 5, 6, 6, 7,  7,  8,  8,
                                9, 9, 10, 10, 11, 11, 12, 12, 13, 13};

// Output past the image that a stream may carry (libpng skips it).
constexpr size_t kMaxExtra = (size_t)1 << 24;

// Inflate the zlib stream in[0, n) into out. libpng asks zlib for one row
// (`stride` bytes) a call, and zlib takes a back-reference only as far as
// its window (1 << (8 + CINFO) bytes) plus what that call has written: the
// same rule here. True when the stream ends with a matching Adler-32.
bool inflate_zlib(const uint8_t* in, size_t n, size_t image, size_t stride,
                  Out* out) {
  Bits s{in, n};
  out->max = image + kMaxExtra;
  out->buf.resize(std::min(image, (size_t)1 << 26));
  uint32_t cmf, flg;
  if (!s.get(8, &cmf) || !s.get(8, &flg)) return false;
  if ((cmf * 256 + flg) % 31 != 0 || (cmf & 15) != 8 || (cmf >> 4) > 7 ||
      (flg & 0x20))                 // a preset dictionary: zlib stops
    return false;
  const size_t window = (size_t)1 << (8 + (cmf >> 4));
  auto call_start = [&](size_t pos) {
    if (pos < image) return pos / stride * stride;
    return image + (pos - image) / 1024 * 1024;   // libpng's 1 KiB skips
  };
  Huffman lit, dist;
  uint32_t last = 0;
  while (!last) {
    uint32_t type;
    if (!s.get(1, &last) || !s.get(2, &type)) return false;
    if (type == 0) {                            // stored
      s.align();
      uint32_t len, nlen;
      if (!s.get(16, &len) || !s.get(16, &nlen) || len != (~nlen & 0xffff) ||
          !out->room(len))
        return false;
      for (; len && s.bits >= 8; --len, s.hold >>= 8, s.bits -= 8)
        out->buf[out->len++] = (uint8_t)s.hold;   // bytes already buffered
      if (len) {
        if (s.n - s.pos < len) return false;
        s.hold = 0;           // the look-ahead bits were the bytes copied
        std::memcpy(&out->buf[out->len], s.p + s.pos, len);
        out->len += len;
        s.pos += len;
      }
    } else if (type == 1 || type == 2) {
      if (type == 1) {                          // fixed codes
        uint8_t l[320];
        for (int i = 0; i < 288; ++i)
          l[i] = i < 144 ? 8 : i < 256 ? 9 : i < 280 ? 7 : 8;
        for (int i = 0; i < 32; ++i) l[288 + i] = 5;   // 30, 31: invalid
        build(&lit, l, 288, Kind::kLens);
        build(&dist, l + 288, 32, Kind::kDists);
      } else {                                  // dynamic codes
        static const uint8_t order[19] = {16, 17, 18, 0, 8,  7, 9,  6, 10, 5,
                                          11, 4,  12, 3, 13, 2, 14, 1, 15};
        uint32_t hlit, hdist, hclen;
        if (!s.get(5, &hlit) || !s.get(5, &hdist) || !s.get(4, &hclen))
          return false;
        hlit += 257;
        hdist += 1;
        hclen += 4;
        if (hlit > 286 || hdist > 30) return false;
        uint8_t cl[19] = {};
        for (uint32_t i = 0; i < hclen; ++i) {
          uint32_t v;
          if (!s.get(3, &v)) return false;
          cl[order[i]] = (uint8_t)v;
        }
        Huffman codes;
        if (!build(&codes, cl, 19, Kind::kCodes)) return false;
        uint8_t l[320] = {};
        uint32_t have = 0;
        while (have < hlit + hdist) {
          int sym = decode(&s, codes);
          if (sym < 0) return false;
          if (sym < 16) {
            l[have++] = (uint8_t)sym;
            continue;
          }
          uint32_t rep, len = 0;
          if (sym == 16) {
            if (have == 0 || !s.get(2, &rep)) return false;
            len = l[have - 1];
            rep += 3;
          } else if (sym == 17) {
            if (!s.get(3, &rep)) return false;
            rep += 3;
          } else {
            if (!s.get(7, &rep)) return false;
            rep += 11;
          }
          if (have + rep > hlit + hdist) return false;
          while (rep--) l[have++] = (uint8_t)len;
        }
        if (l[256] == 0) return false;          // no end-of-block code
        if (!build(&lit, l, (int)hlit, Kind::kLens) ||
            !build(&dist, l + hlit, (int)hdist, Kind::kDists))
          return false;
      }
      for (;;) {
        int sym = decode(&s, lit);
        if (sym < 0) return false;
        if (sym < 256) {
          if (!out->room(1)) return false;
          out->buf[out->len++] = (uint8_t)sym;
        } else if (sym == 256) {
          break;
        } else {
          sym -= 257;
          if (sym >= 29) return false;
          uint32_t extra, d;
          if (!s.get(kLenExtra[sym], &extra)) return false;
          size_t len = kLenBase[sym] + extra;
          int dsym = decode(&s, dist);
          if (dsym < 0 || dsym >= 30 || !s.get(kDistExtra[dsym], &d))
            return false;
          size_t back = kDistBase[dsym] + d;
          // each of zlib's calls the copy spans: its window plus what the
          // call has written so far
          for (size_t pos = out->len, end = pos + len; pos < end;) {
            size_t c = call_start(pos);
            if (back > pos - c + std::min(c, window)) return false;
            pos = pos < image ? std::min(end, c + stride)
                              : std::min(end, c + 1024);
          }
          if (!out->room(len)) return false;
          uint8_t* dst = &out->buf[out->len];
          for (size_t k = 0; k < len; ++k) dst[k] = dst[k - back];
          out->len += len;
        }
      }
    } else {
      return false;                             // block type 3
    }
  }
  s.align();
  uint32_t b0, b1, b2, b3;
  if (!s.get(8, &b0) || !s.get(8, &b1) || !s.get(8, &b2) || !s.get(8, &b3))
    return false;
  return (b0 << 24 | b1 << 16 | b2 << 8 | b3) ==
         adler32(out->buf.data(), out->len);
}

// ---------------------------------------------------------------------------
// PNG chunks and rows

inline bool chunk_is(const uint8_t* t, const char* name) {
  return std::memcmp(t, name, 4) == 0;
}

// Ancillary chunks libpng knows: before IHDR, each stops it.
bool known_ancillary(const uint8_t* t) {
  static const char* names[] = {"bKGD", "cHRM", "eXIf", "gAMA", "hIST",
                                "iCCP", "iTXt", "oFFs", "pCAL", "pHYs",
                                "sBIT", "sCAL", "sPLT", "sRGB", "tEXt",
                                "tIME", "tRNS", "zTXt"};
  for (const char* n : names)
    if (chunk_is(t, n)) return true;
  return false;
}

bool read_file(const char* path, std::vector<uint8_t>* data) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return false;
  uint8_t buf[1 << 16];
  size_t got;
  while ((got = std::fread(buf, 1, sizeof buf, fp)) > 0)
    data->insert(data->end(), buf, buf + got);
  bool ok = !std::ferror(fp);
  std::fclose(fp);
  return ok;
}

// Decode an 8/16-bit PNG to float32 grayscale [0,1] into out (h*w), with
// top-left crop/zero-pad to the requested (h, w).
bool decode_png_gray_impl(const char* path, float* out, int out_h,
                          int out_w) {
  std::vector<uint8_t> f;
  if (!read_file(path, &f)) return false;
  static const uint8_t sig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  if (f.size() < 8 || std::memcmp(f.data(), sig, 8) != 0) return false;

  uint32_t w = 0, h = 0;
  int depth = 0, color = 0, channels = 0;
  bool have_ihdr = false, have_plte = false, have_trns = false;
  bool colour_space = false;                 // gAMA, cHRM, sRGB or iCCP
  int num_palette = 0, num_trans = 0;
  uint8_t palette[256][3] = {};
  uint8_t trans[256];
  std::memset(trans, 255, sizeof trans);
  std::vector<uint8_t> idat;
  int idat_state = 0;                        // 0 before, 1 in, 2 after
  bool have_iend = false;
  size_t at = 8;
  while (!have_iend) {
    if (f.size() - at < 8) return false;     // truncated
    uint32_t len = be32(&f[at]);
    const uint8_t* type = &f[at + 4];
    if (len > 0x7fffffffu) return false;
    for (int i = 0; i < 4; ++i) {
      int c = type[i];
      if (c < 65 || c > 122 || (c > 90 && c < 97)) return false;
    }
    // png_check_chunk_length: 8 MB, or for IDAT what the image can need
    uint64_t limit = 8000000;
    if (chunk_is(type, "IDAT")) {
      uint64_t row = (uint64_t)w * channels * (depth > 8 ? 2 : 1) + 1;
      uint64_t idat_limit = (uint64_t)h * row;
      if (idat_limit > 0x7fffffffu) idat_limit = 0x7fffffffu;
      uint64_t rf = row > 32566 ? 32566 : row;
      idat_limit += 6 + 5 * (idat_limit / rf + 1);
      if (idat_limit > 0x7fffffffu) idat_limit = 0x7fffffffu;
      if (idat_limit > limit) limit = idat_limit;
    }
    if (len > limit) return false;
    if (f.size() - at - 8 < (uint64_t)len + 4) return false;   // truncated
    const uint8_t* data = &f[at + 8];
    bool crc_ok = crc32(type, (size_t)len + 4) == be32(data + len);
    bool critical = !(type[0] & 0x20);
    at += 12 + (size_t)len;
    if (critical && !crc_ok) return false;
    bool is_idat = chunk_is(type, "IDAT");
    if (idat_state == 1 && !is_idat) idat_state = 2;

    if (chunk_is(type, "IHDR")) {
      if (have_ihdr || len != 13) return false;
      have_ihdr = true;
      w = be32(data);
      h = be32(data + 4);
      depth = data[8];
      color = data[9];
      if (w == 0 || h == 0 || w > 1000000 || h > 1000000) return false;
      switch (color) {
        case 0: channels = 1; break;
        case 2: channels = 3; break;
        case 3: channels = 1; break;
        case 4: channels = 2; break;
        case 6: channels = 4; break;
        default: return false;
      }
      if (depth != 1 && depth != 2 && depth != 4 && depth != 8 && depth != 16)
        return false;
      if ((color == 3 && depth > 8) ||
          ((color == 2 || color == 4 || color == 6) && depth < 8))
        return false;
      if (data[10] != 0 || data[11] != 0 || data[12] > 1) return false;
      if (data[12] == 1) return false;       // interlaced: see the top
      continue;
    }
    if (!have_ihdr) {
      if (critical || known_ancillary(type)) return false;
      continue;
    }
    if (chunk_is(type, "IEND")) {
      if (idat_state == 0) return false;     // IEND before IDAT
      have_iend = true;
      continue;
    }
    if (idat_state == 2) continue;           // after the image: CRC only
    if (is_idat) {
      if (color == 3 && !have_plte) return false;
      idat_state = 1;
      idat.insert(idat.end(), data, data + len);
      continue;
    }
    if (chunk_is(type, "PLTE")) {
      if (have_plte) return false;
      have_plte = true;
      if (color != 2 && color != 3 && color != 6) continue;
      if (len > 768 || len % 3 != 0) {
        if (color == 3) return false;
        continue;
      }
      int num = (int)(len / 3);
      if (color == 3 && num > (1 << depth)) num = 1 << depth;
      if (num == 0) return false;
      num_palette = num;
      std::memset(palette, 0, sizeof palette);
      std::memcpy(palette, data, (size_t)num * 3);
      continue;
    }
    if (chunk_is(type, "tRNS")) {
      // only a palette's tRNS changes what the JAX loader reads
      if (have_trns || color != 3 || !have_plte) continue;
      if (len == 0 || len > (uint32_t)num_palette || !crc_ok) continue;
      have_trns = true;
      num_trans = (int)len;
      std::memcpy(trans, data, len);
      continue;
    }
    if (chunk_is(type, "gAMA") || chunk_is(type, "cHRM") ||
        chunk_is(type, "sRGB") || chunk_is(type, "iCCP"))
      colour_space = true;
    if (critical) return false;              // an unknown critical chunk
  }
  if (colour_space && (color & 2)) return false;   // see the top

  const int bits = depth * channels;
  const size_t rowbytes = ((size_t)w * bits + 7) / 8;
  const size_t stride = rowbytes + 1;
  const size_t image = stride * h;
  Out inflated;
  if (!inflate_zlib(idat.data(), idat.size(), image, stride, &inflated) ||
      inflated.len < image)
    return false;
  uint8_t* raw = inflated.buf.data();

  // unfilter in place; the row above the first is zeros
  const size_t bpp = bits >= 8 ? (size_t)bits / 8 : 1;
  std::vector<uint8_t> zeros(rowbytes, 0);
  for (uint32_t y = 0; y < h; ++y) {
    uint8_t ft = raw[y * stride];
    uint8_t* r = &raw[y * stride + 1];
    const uint8_t* up = y ? &raw[(y - 1) * stride + 1] : zeros.data();
    switch (ft) {
      case 0: break;
      case 1:
        for (size_t i = bpp; i < rowbytes; ++i) r[i] += r[i - bpp];
        break;
      case 2:
        for (size_t i = 0; i < rowbytes; ++i) r[i] += up[i];
        break;
      case 3:
        for (size_t i = 0; i < rowbytes; ++i)
          r[i] += (uint8_t)(((i >= bpp ? r[i - bpp] : 0) + up[i]) >> 1);
        break;
      case 4:
        for (size_t i = 0; i < rowbytes; ++i) {
          int a = i >= bpp ? r[i - bpp] : 0, b = up[i];
          int c = i >= bpp ? up[i - bpp] : 0;
          int p = a + b - c;
          int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
          r[i] += (uint8_t)(pa <= pb && pa <= pc ? a : pb <= pc ? b : c);
        }
        break;
      default:
        return false;
    }
  }

  // libpng's transforms for the JAX loader, into one row of 8-bit bytes:
  // gray (or, for a palette with tRNS, gray and alpha pairs)
  const uint32_t rc = 6968, gc = 23434, bc = 32768 - rc - gc;
  auto gray8 = [&](uint32_t r, uint32_t g, uint32_t b) -> uint8_t {
    if (r == g && r == b) return (uint8_t)r;
    return (uint8_t)((rc * r + gc * g + bc * b) >> 15);
  };
  auto sample = [&](const uint8_t* r, size_t i) -> uint32_t {
    // sample i of a row of `depth`-bit samples, big-endian and MSB first
    if (depth == 16) return (uint32_t)r[2 * i] << 8 | r[2 * i + 1];
    if (depth == 8) return r[i];
    size_t bit = i * depth;
    return (r[bit >> 3] >> (8 - depth - (bit & 7))) & ((1u << depth) - 1);
  };
  const size_t out_bytes = (size_t)w * (color == 3 && num_trans ? 2 : 1);
  std::vector<uint8_t> row(out_bytes);
  const size_t copy_w = std::min<size_t>(w, (size_t)out_w);
  const float inv = 1.0f / 255.0f;
  for (uint32_t y = 0; y < h && (int)y < out_h; ++y) {
    const uint8_t* r = &raw[y * stride + 1];
    if (color == 0 && depth == 8) std::memcpy(row.data(), r, w);
    for (uint32_t x = 0; x < w && !(color == 0 && depth == 8); ++x) {
      uint8_t v;
      if (color == 0 || color == 4) {          // gray: expand, chop, strip
        uint32_t s = sample(r, (size_t)x * channels);
        v = depth == 16 ? (uint8_t)(s >> 8)
            : depth == 8 ? (uint8_t)s
            : depth == 4 ? (uint8_t)(s * 0x11)
            : depth == 2 ? (uint8_t)(s * 0x55)
            : (uint8_t)(s ? 0xff : 0);
      } else if (color == 3) {                 // palette -> RGB(A) -> gray
        uint32_t idx = sample(r, x);
        v = gray8(palette[idx][0], palette[idx][1], palette[idx][2]);
        if (num_trans) {
          row[2 * x] = v;
          row[2 * x + 1] = (int)idx < num_trans ? trans[idx] : 255;
          continue;
        }
      } else if (depth == 8) {                 // RGB(A): gray, then chop
        v = gray8(sample(r, (size_t)x * channels),
                  sample(r, (size_t)x * channels + 1),
                  sample(r, (size_t)x * channels + 2));
      } else {
        uint32_t g16 = (rc * sample(r, (size_t)x * channels) +
                        gc * sample(r, (size_t)x * channels + 1) +
                        bc * sample(r, (size_t)x * channels + 2) + 16384) >>
                       15;
        v = (uint8_t)(g16 >> 8);
      }
      row[x] = v;
    }
    float* dst = out + (size_t)y * out_w;
    for (size_t x = 0; x < copy_w; ++x) dst[x] = row[x] * inv;
    for (size_t x = copy_w; x < (size_t)out_w; ++x) dst[x] = 0.0f;
  }
  for (int y = (int)h; y < out_h; ++y)
    std::memset(out + (size_t)y * out_w, 0, sizeof(float) * out_w);
  return true;
}

bool decode_png_gray(const char* path, float* out, int out_h, int out_w) {
  try {
    return decode_png_gray_impl(path, out, out_h, out_w);
  } catch (...) {                              // std::bad_alloc
    return false;
  }
}

struct Slot {
  std::vector<float> data;
  long index = -1;
  bool ok = false;
};

struct Loader {
  std::vector<std::string> paths;
  int h = 0, w = 0;
  size_t next_decode = 0;           // next path index to hand to a worker
  std::queue<Slot> ready;           // decoded frames in order? (see note)
  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  size_t depth = 4;
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};
  // In-order delivery: frames must come out in path order, so workers park
  // out-of-order results here until their turn.
  std::vector<Slot> parked;
  size_t next_emit = 0;

  void worker() {
    for (;;) {
      size_t idx;
      {
        std::unique_lock<std::mutex> lk(mu);
        if (stop || next_decode >= paths.size()) return;
        idx = next_decode++;
      }
      Slot s;
      s.data.resize((size_t)h * w);
      s.index = (long)idx;
      s.ok = decode_png_gray(paths[idx].c_str(), s.data.data(), h, w);
      {
        std::unique_lock<std::mutex> lk(mu);
        // The in-order frame always passes: it is the one the consumer
        // waits for, and it drains the parked frames behind it.
        cv_space.wait(lk, [&] {
          return stop || (size_t)s.index == next_emit ||
                 ready.size() + parked.size() < depth + workers.size();
        });
        if (stop) return;
        parked.push_back(std::move(s));
        // Drain any parked frames that are now in order.
        bool moved = true;
        while (moved) {
          moved = false;
          for (size_t i = 0; i < parked.size(); ++i) {
            if ((size_t)parked[i].index == next_emit) {
              ready.push(std::move(parked[i]));
              parked.erase(parked.begin() + i);
              ++next_emit;
              moved = true;
              break;
            }
          }
        }
        cv_ready.notify_all();
      }
    }
  }
};

}  // namespace

extern "C" {

int glslam_decode_png(const char* path, float* out, int h, int w) {
  return decode_png_gray(path, out, h, w) ? 0 : -1;
}

void* glslam_loader_create(const char** paths, long n, int h, int w,
                           int depth, int num_threads) {
  Loader* L = new Loader();
  L->paths.assign(paths, paths + n);
  L->h = h;
  L->w = w;
  L->depth = depth > 0 ? (size_t)depth : 4;
  int nt = num_threads > 0 ? num_threads : 2;
  for (int i = 0; i < nt; ++i)
    L->workers.emplace_back(&Loader::worker, L);
  return L;
}

// Blocks until the next in-order frame is decoded; copies it into out.
// Returns the frame index, or -1 when the sequence is exhausted, -2 on a
// decode failure for that frame.
long glslam_loader_next(void* handle, float* out) {
  Loader* L = (Loader*)handle;
  std::unique_lock<std::mutex> lk(L->mu);
  L->cv_ready.wait(lk, [&] {
    return !L->ready.empty() || (L->next_emit >= L->paths.size());
  });
  if (L->ready.empty()) return -1;
  Slot s = std::move(L->ready.front());
  L->ready.pop();
  L->cv_space.notify_all();
  if (!s.ok) return -2;
  std::memcpy(out, s.data.data(), sizeof(float) * (size_t)L->h * L->w);
  return s.index;
}

void glslam_loader_destroy(void* handle) {
  Loader* L = (Loader*)handle;
  {
    std::unique_lock<std::mutex> lk(L->mu);
    L->stop = true;
    L->cv_space.notify_all();
    L->cv_ready.notify_all();
  }
  for (auto& t : L->workers) t.join();
  delete L;
}

}  // extern "C"
