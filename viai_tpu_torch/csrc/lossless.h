// Shared by utvideo.cpp and huffyuv.cpp: the bit reader over 32-bit
// little-endian words read most significant bit first (libavcodec
// byte-swaps both codecs' packets into big-endian words, then reads them
// with get_bits), prefix codes of up to 32 bits, and the median
// predictor.
#pragma once

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <vector>

#include "video.h"

namespace viai_video {

// get_bits over n bytes of data whose 32-bit words are reversed
// (bswap_buf), reading zeros past them. `partial_word`: a last word of
// fewer than 4 bytes is swapped whole, with the bytes after it (up to
// `avail`; UT Video swaps a slice's last word so); else it is left out
// (HuffYUV swaps only whole words).
struct SwappedBits {
  std::vector<uint8_t> buf;
  int64_t size_bits = 0;
  int64_t pos = 0;

  SwappedBits(const uint8_t* d, size_t avail, size_t n, bool partial_word) {
    const size_t words = partial_word ? (n + 3) / 4 : n / 4;
    buf.assign(words * 4 + 8, 0);
    for (size_t i = 0; i < words * 4; i += 4)
      for (size_t j = 0; j < 4; ++j)
        if (i + 3 - j < avail) buf[i + j] = d[i + 3 - j];
    size_bits = int64_t(n) * 8;
  }
  // get_bits over n bytes as they are (no swap).
  SwappedBits(const uint8_t* d, size_t n) : buf(d, d + n) {
    buf.resize(n + 8, 0);
    size_bits = int64_t(n) * 8;
  }
  int64_t left() const { return size_bits - pos; }
  uint32_t show(int k) const {       // k ≤ 32
    if (!k) return 0;
    uint64_t v = 0;
    const int64_t byte = pos >> 3;
    for (int i = 0; i < 5; ++i) {
      const int64_t b = byte + i;
      v = (v << 8) | (b < int64_t(buf.size()) ? buf[size_t(b)] : 0);
    }
    v <<= (pos & 7);
    return uint32_t((v >> (40 - k)) & ((uint64_t(1) << k) - 1));
  }
  uint32_t get(int k) {
    const uint32_t v = show(k);
    pos += k;
    return v;
  }
};

// A prefix code given each symbol's length (0: absent) and code value;
// decode() reads one symbol (−1 for bits that match no code).
class PrefixCode {
 public:
  // → false when the codes are not prefix-free.
  bool build(const std::vector<uint8_t>& len, const std::vector<uint32_t>& code) {
    lut_.assign(size_t(1) << kLutBits, 0);
    for (auto& l : by_len_) l.clear();
    for (size_t s = 0; s < len.size(); ++s) {
      const int l = len[s];
      if (!l) continue;
      if (l > 32) return false;
      const uint32_t c = code[s];
      if (l < 32 && (c >> l)) return false;
      by_len_[l].push_back({c, int(s)});
      if (l <= kLutBits) {
        const uint32_t first = c << (kLutBits - l);
        for (uint32_t k = 0; k < (1u << (kLutBits - l)); ++k) {
          uint32_t& e = lut_[first + k];
          if (e) return false;
          e = uint32_t((l << 16) | (s + 1));
        }
      }
    }
    for (auto& l : by_len_)
      std::sort(l.begin(), l.end(),
                [](const Entry& a, const Entry& b) { return a.code < b.code; });
    return true;
  }
  int decode(SwappedBits& b) const {
    const uint32_t e = lut_[b.show(kLutBits)];
    if (e) {
      b.pos += e >> 16;
      return int(e & 0xFFFF) - 1;
    }
    for (int l = kLutBits + 1; l <= 32; ++l) {
      const std::vector<Entry>& v = by_len_[l];
      if (v.empty()) continue;
      const uint32_t c = b.show(l);
      auto it = std::lower_bound(
          v.begin(), v.end(), c,
          [](const Entry& a, uint32_t x) { return a.code < x; });
      if (it != v.end() && it->code == c) {
        b.pos += l;
        return it->sym;
      }
    }
    return -1;
  }

 private:
  static constexpr int kLutBits = 12;
  struct Entry {
    uint32_t code;
    int sym;
  };
  std::vector<uint32_t> lut_;          // (length << 16) | (symbol + 1)
  std::vector<Entry> by_len_[33];
};

inline int median3(int a, int b, int c) {
  return std::max(std::min(a, b), std::min(std::max(a, b), c));
}

}  // namespace viai_video
