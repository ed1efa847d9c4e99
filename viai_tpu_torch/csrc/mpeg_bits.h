// Shared by mpeg4.cpp, mpeg12.cpp and msmpeg4.cpp: the MPEG bit reader,
// VLC lookup tables, ffmpeg's zigzag and alternate scans and the H.263
// half-pel motion compensation.
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

// ffmpeg's alternate scans (AC prediction from the left: vertical; from
// above: horizontal), scan position → natural index.
inline constexpr uint8_t kAltVertical[64] = {
    0,  8,  16, 24, 1,  9,  2,  10, 17, 25, 32, 40, 48, 56, 57, 49,
    41, 33, 26, 18, 3,  11, 4,  12, 19, 27, 34, 42, 50, 58, 35, 43,
    51, 59, 20, 28, 5,  13, 6,  14, 21, 29, 36, 44, 52, 60, 37, 45,
    53, 61, 22, 30, 7,  15, 23, 31, 38, 46, 54, 62, 39, 47, 55, 63};
inline constexpr uint8_t kAltHorizontal[64] = {
    0,  1,  2,  3,  8,  9,  16, 17, 10, 11, 4,  5,  6,  7,  15, 14,
    13, 12, 19, 18, 24, 25, 32, 33, 26, 27, 20, 21, 22, 23, 28, 29,
    30, 31, 34, 35, 40, 41, 48, 49, 42, 43, 36, 37, 38, 39, 44, 45,
    46, 47, 50, 51, 56, 57, 58, 59, 52, 53, 54, 55, 60, 61, 62, 63};

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

// A reference plane: its pixels and the edge its reads clamp to
// (libavcodec's emulated_edge_mc at h_edge_pos, v_edge_pos).
struct Plane {
  const uint8_t* p;
  int stride, w, h;
  int at(int x, int y) const {
    int cy = y < 0 ? 0 : y > h - 1 ? h - 1 : y;
    int cx = x < 0 ? 0 : x > w - 1 ? w - 1 : x;
    return p[size_t(cy) * stride + cx];
  }
};

// Half-pel put (or average into dst, `avg`) of a (bw, bh) block read at
// integer (sx, sy) with half-pel flags dxy (1 x, 2 y); `no_rnd` rounds
// the interpolation down (put_no_rnd_pixels).
inline void hpel(const Plane& r, int sx, int sy, int dxy, int no_rnd, bool avg,
                 uint8_t* dst, int ds, int bw, int bh) {
  const bool approx = no_rnd && !avg && bw == 8;
  auto dec = [](int v) { return v > 0 ? v - 1 : 0; };
  for (int y = 0; y < bh; ++y)
    for (int x = 0; x < bw; ++x) {
      int a = r.at(sx + x, sy + y), v;
      switch (dxy) {
        case 0: v = a; break;
        case 1: {
          int b = r.at(sx + x + 1, sy + y);
          v = approx ? (dec(a) + b + 1) >> 1 : (a + b + 1 - no_rnd) >> 1;
          break;
        }
        case 2: {
          int b = r.at(sx + x, sy + y + 1);
          v = (approx ? (y & 1 ? dec(a) + b : a + dec(b)) + 1
                      : a + b + 1 - no_rnd) >> 1;
          break;
        }
        default:
          v = (a + r.at(sx + x + 1, sy + y) + r.at(sx + x, sy + y + 1) +
               r.at(sx + x + 1, sy + y + 1) + 2 - no_rnd) >> 2;
      }
      uint8_t& d = dst[size_t(y) * ds + x];
      d = uint8_t(avg ? (d + v + 1) >> 1 : v);
    }
}

}  // namespace mpeg
}  // namespace viai_video
