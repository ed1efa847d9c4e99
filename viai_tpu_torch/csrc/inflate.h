// Inflate (RFC 1950/1951) for the PNG reader of imagedec.cpp and the
// zlib-compressed Matroska tracks of videodec.cpp: canonical Huffman
// codes read LSB first, a 9-bit lookahead table and puff's bit-serial
// decode for longer codes. A broken stream throws Error; each reader
// turns it into its own.
#pragma once

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace viai_inflate {

struct Error {
  std::string msg;      // what is wrong, after the stream's name
};

[[noreturn]] inline void fail(const std::string& what) { throw Error{what}; }

struct InflateHuffman {
  uint16_t count[16];
  uint16_t symbol[320];
  uint16_t lut[512];        // (length << 9) | symbol, 0 = slow
};

inline void build_inflate(InflateHuffman& h, const uint8_t* len, int n) {
  std::memset(h.count, 0, sizeof(h.count));
  std::memset(h.lut, 0, sizeof(h.lut));
  for (int i = 0; i < n; ++i) ++h.count[len[i]];
  int left = 1;
  for (int l = 1; l < 16; ++l) {
    left = (left << 1) - h.count[l];
    if (left < 0) fail("deflate code is over-subscribed");
  }
  uint16_t offs[16];
  offs[1] = 0;
  for (int l = 1; l < 15; ++l) offs[l + 1] = uint16_t(offs[l] + h.count[l]);
  for (int i = 0; i < n; ++i)
    if (len[i]) h.symbol[offs[len[i]]++] = uint16_t(i);
  int code = 0, next[16];
  h.count[0] = 0;
  for (int l = 1; l < 16; ++l) {
    code = (code + h.count[l - 1]) << 1;
    next[l] = code;
  }
  for (int i = 0; i < n; ++i) {
    int l = len[i];
    if (!l || l > 9) continue;
    int c = next[l]++, rev = 0;
    for (int b = 0; b < l; ++b) rev |= ((c >> b) & 1) << (l - 1 - b);
    for (int j = rev; j < 512; j += 1 << l) h.lut[j] = uint16_t((l << 9) | i);
  }
}

struct Inflater {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;
  int bits = 0;
  int64_t over = 0;         // bits fed past the end

  void fill() {
    while (bits <= 56) {
      if (p < end) {
        buf |= uint64_t(*p++) << bits;
      } else {
        over += 8;
      }
      bits += 8;
    }
  }
  uint32_t need(int n) {
    if (bits < n) fill();
    return uint32_t(buf & ((uint64_t(1) << n) - 1));
  }
  void drop(int n) {
    buf >>= n;
    bits -= n;
    if (bits < over) fail("ends early");
  }
  int get(int n) {
    if (n == 0) return 0;
    uint32_t v = need(n);
    drop(n);
    return int(v);
  }
  int decode(const InflateHuffman& h) {
    uint32_t v = need(15);
    uint16_t e = h.lut[v & 511];
    if (e) {
      drop(e >> 9);
      return e & 511;
    }
    int code = 0, first = 0, index = 0;
    for (int l = 1; l < 16; ++l) {
      code |= int((v >> (l - 1)) & 1);
      int count = h.count[l];
      if (code - count < first) {
        drop(l);
        return h.symbol[index + (code - first)];
      }
      index += count;
      first = (first + count) << 1;
      code <<= 1;
    }
    fail("deflate data holds a bad code");
  }
};

inline constexpr uint16_t kLenBase[29] = {3,  4,  5,  6,  7,  8,  9,  10, 11,  13,
                               15, 17, 19, 23, 27, 31, 35, 43, 51,  59,
                               67, 83, 99, 115, 131, 163, 195, 227, 258};
inline constexpr uint8_t kLenExtra[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2,
                               2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
inline constexpr uint16_t kDistBase[30] = {1,    2,    3,    4,    5,    7,     9,
                                13,   17,   25,   33,   49,   65,    97,
                                129,  193,  257,  385,  513,  769,   1025,
                                1537, 2049, 3073, 4097, 6145, 8193, 12289,
                                16385, 24577};
inline constexpr uint8_t kDistExtra[30] = {0, 0, 0, 0, 1, 1, 2,  2,  3,  3,
                                4, 4, 5, 5, 6, 6, 7,  7,  8,  8,
                                9, 9, 10, 10, 11, 11, 12, 12, 13, 13};

// A zlib stream (RFC 1950) of `n` bytes → its first `want` bytes (the
// rest of the stream and its Adler-32 not read, as Pillow stops once it
// has a PNG's rows); `want` kAll: the whole stream, its Adler-32 checked
// (zlib's inflate, as libavformat's Matroska demuxer runs it).
inline constexpr size_t kAll = ~size_t(0);

inline std::vector<uint8_t> inflate_zlib(const uint8_t* z, size_t n,
                                         size_t want) {
  if (n < 6) fail("is empty");
  if ((z[0] & 15) != 8 || ((z[0] << 8) | z[1]) % 31 != 0 || (z[1] & 0x20))
    fail("is not a zlib stream");
  std::vector<uint8_t> out;
  if (want != kAll) out.reserve(want);
  Inflater in{z + 2, z + n};
  InflateHuffman lit, dist;
  bool last = false;
  while (!last) {
    last = in.get(1);
    int type = in.get(2);
    if (type == 0) {                                   // stored
      in.drop(in.bits & 7);
      int len = in.get(16), nlen = in.get(16);
      if ((len ^ 0xFFFF) != nlen) fail("stored block length is bad");
      for (int i = 0; i < len; ++i) out.push_back(uint8_t(in.get(8)));
      if (out.size() >= want) return out;
      continue;
    }
    if (type == 1) {                                   // fixed codes
      uint8_t l[320];
      for (int i = 0; i < 288; ++i)
        l[i] = i < 144 ? 8 : i < 256 ? 9 : i < 280 ? 7 : 8;
      build_inflate(lit, l, 288);
      for (int i = 0; i < 30; ++i) l[i] = 5;
      build_inflate(dist, l, 30);
    } else if (type == 2) {                            // dynamic codes
      int nlen = in.get(5) + 257, ndist = in.get(5) + 1, ncode = in.get(4) + 4;
      if (nlen > 286 || ndist > 30) fail("deflate block counts are bad");
      static const uint8_t order[19] = {16, 17, 18, 0, 8,  7, 9,  6, 10, 5,
                                        11, 4,  12, 3, 13, 2, 14, 1, 15};
      uint8_t l[320] = {0};
      for (int i = 0; i < ncode; ++i) l[order[i]] = uint8_t(in.get(3));
      InflateHuffman lencode;
      build_inflate(lencode, l, 19);
      uint8_t lens[320] = {0};
      int idx = 0;
      while (idx < nlen + ndist) {
        int sym = in.decode(lencode);
        if (sym < 16) {
          lens[idx++] = uint8_t(sym);
          continue;
        }
        int rep, val = 0;
        if (sym == 16) {
          if (idx == 0) fail("deflate repeats no length");
          val = lens[idx - 1];
          rep = 3 + in.get(2);
        } else if (sym == 17) {
          rep = 3 + in.get(3);
        } else {
          rep = 11 + in.get(7);
        }
        if (idx + rep > nlen + ndist) fail("deflate lengths overrun");
        while (rep--) lens[idx++] = uint8_t(val);
      }
      if (lens[256] == 0) fail("deflate block has no end code");
      build_inflate(lit, lens, nlen);
      build_inflate(dist, lens + nlen, ndist);
    } else {
      fail("deflate block of type 3");
    }
    while (true) {
      int sym = in.decode(lit);
      if (out.size() >= want) return out;
      if (sym < 256) {
        out.push_back(uint8_t(sym));
      } else if (sym == 256) {
        break;
      } else {
        sym -= 257;
        if (sym >= 29) fail("deflate length code is bad");
        int len = kLenBase[sym] + in.get(kLenExtra[sym]);
        int ds = in.decode(dist);
        if (ds >= 30) fail("deflate distance code is bad");
        size_t d = kDistBase[ds] + in.get(kDistExtra[ds]);
        if (d > out.size()) fail("deflate distance too far back");
        size_t from = out.size() - d;
        for (int i = 0; i < len; ++i) out.push_back(out[from + i]);
      }
    }
  }
  if (want == kAll) {
    in.drop(in.bits & 7);
    uint32_t a = 1, b = 0;
    for (uint8_t v : out) {
      a = (a + v) % 65521;
      b = (b + a) % 65521;
    }
    uint32_t adler = 0;
    for (int i = 0; i < 4; ++i) adler = (adler << 8) | uint32_t(in.get(8));
    if (adler != ((b << 16) | a)) fail("fails its Adler-32 check");
  } else if (out.size() < want) {
    fail("ends early");
  }
  return out;
}

}  // namespace viai_inflate
