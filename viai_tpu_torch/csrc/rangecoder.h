// Shared by ffv1.cpp and snow.cpp: libavcodec's range decoder
// (rangecoder.c) with the state tables both codecs build
// (ff_build_rac_states at 0.05 · 2^32, 256 − 8) and get_symbol over a
// context's 32 states.
#pragma once

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <cstring>

#include "video.h"

namespace viai_video {

// rangecoder.c's decoder over data[pos, end).
struct RangeCoder {
  const uint8_t* data = nullptr;
  size_t start = 0, pos = 0, end = 0;
  uint32_t low = 0, range = 0;
  int overread = 0;
  uint8_t zero[256] = {}, one[256] = {};

  void init(const uint8_t* d, size_t from, size_t to) {
    data = d;
    start = pos = from;
    end = to;
    range = 0xFF00;
    overread = 0;
    low = (uint32_t(pos < end ? d[pos] : 0) << 8) |
          (pos + 1 < end ? d[pos + 1] : 0);
    pos += 2;
    if (low >= 0xFF00) {
      low = 0xFF00;
      end = pos;
    }
  }
  // ff_build_rac_states(c, 0.05 * 2^32, 256 - 8).
  void build_states() {
    const int64_t one_ = int64_t(1) << 32;
    const int64_t factor = int64_t(0.05 * double(one_));
    const int max_p = 256 - 8;
    std::memset(zero, 0, sizeof(zero));
    std::memset(one, 0, sizeof(one));
    int last_p8 = 0;
    int64_t p = one_ / 2;
    for (int i = 0; i < 128; ++i) {
      int p8 = int((256 * p + one_ / 2) >> 32);
      if (p8 <= last_p8) p8 = last_p8 + 1;
      if (last_p8 && last_p8 < 256 && p8 <= max_p) one[last_p8] = uint8_t(p8);
      p += ((one_ - p) * factor + one_ / 2) >> 32;
      last_p8 = p8;
    }
    for (int i = 256 - max_p; i <= max_p; ++i) {
      if (one[i]) continue;
      p = (int64_t(i) * one_ + 128) >> 8;
      p += ((one_ - p) * factor + one_ / 2) >> 32;
      int p8 = int((256 * p + one_ / 2) >> 32);
      if (p8 <= i) p8 = i + 1;
      if (p8 > max_p) p8 = max_p;
      one[i] = uint8_t(p8);
    }
    for (int i = 1; i < 255; ++i) zero[i] = uint8_t(256 - one[256 - i]);
  }
  __attribute__((always_inline)) void refill() {
    if (range < 0x100) {
      range <<= 8;
      low <<= 8;
      if (pos < end)
        low += data[pos++];
      else
        ++overread;
    }
  }
  __attribute__((always_inline)) int bit(uint8_t& st) {
    const uint32_t r1 = (range * st) >> 8;
    range -= r1;
    if (low < range) {
      st = zero[st];
      refill();
      return 0;
    }
    low -= range;
    st = one[st];
    range = r1;
    refill();
    return 1;
  }
  // get_symbol over a context's 32 states.
  __attribute__((always_inline)) int symbol(uint8_t* st, bool is_signed) {
    if (bit(st[0])) return 0;
    int e = 0;
    while (bit(st[1 + std::min(e, 9)])) {
      if (++e > 31) broken("range-coded symbol out of range");
    }
    unsigned a = 1;
    for (int i = e - 1; i >= 0; --i) a += a + bit(st[22 + std::min(i, 9)]);
    const unsigned neg = (is_signed && bit(st[11 + std::min(e, 10)])) ? ~0u
                                                                        : 0u;
    return int((a ^ neg) - neg);
  }
};

}  // namespace viai_video
