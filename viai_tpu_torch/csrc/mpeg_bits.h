// Shared by mpeg4.cpp and mpeg12.cpp: the MPEG bit reader, VLC lookup
// tables and ffmpeg's zigzag scan.
#pragma once

#include <cstddef>
#include <cstdint>
#include <vector>

namespace viai_video {
namespace mpeg {

// ffmpeg's zigzag: scan position → natural index.
inline constexpr uint8_t kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// MSB-first bits of one packet; past its end it reads zeros.
struct Bits {
  const uint8_t* d;
  size_t n;
  size_t pos = 0;   // in bits
  uint32_t peek(int k) const {          // 1 ≤ k ≤ 32
    uint64_t v = 0;
    size_t byte = pos >> 3;
    for (int i = 0; i < 5; ++i)
      v = (v << 8) | (byte + i < n ? d[byte + i] : 0);
    return uint32_t((v << (24 + (pos & 7))) >> (64 - k));
  }
  uint32_t get(int k) {
    if (k == 0) return 0;
    uint32_t v = peek(k);
    pos += size_t(k);
    return v;
  }
  int get1() { return int(get(1)); }
  // k bits as ffmpeg's get_xbits: a leading 0 makes the value negative.
  int xbits(int k) {
    int v = int(get(k));
    return v >> (k - 1) ? v : v - (1 << k) + 1;
  }
  void skip(int k) { pos += size_t(k); }
  bool over() const { return pos > 8 * n; }
  long left() const { return long(8 * n) - long(pos); }
};

// A VLC as a lookup of `bits` bits: (length << 8 | symbol), 0 unused.
struct Vlc {
  int bits = 0;
  std::vector<uint16_t> lut;
  template <typename T>
  Vlc(const T (*t)[2], size_t n, int max_bits)
      : bits(max_bits), lut(size_t(1) << max_bits, 0) {
    for (size_t s = 0; s < n; ++s) {
      int shift = bits - int(t[s][1]);
      for (unsigned k = 0; k < (1u << shift); ++k)
        lut[(unsigned(t[s][0]) << shift) | k] =
            uint16_t((int(t[s][1]) << 8) | int(s));
    }
  }
  // The symbol, or −1 for a code that is not in the table.
  int read(Bits& b) const {
    uint16_t e = lut[b.peek(bits)];
    if (!e) return -1;
    b.skip(e >> 8);
    return e & 0xFF;
  }
};

}  // namespace mpeg
}  // namespace viai_video
