// ASUS ASV1 and ASV2 of viai_tpu_torch: libavcodec's asv1 and asv2
// decoders (asvdec.c, asv.c) for what its encoders and OpenCV's writer
// store under ASV1 and ASV2.
//
//   * each packet one intra picture of 16x16 macroblocks of 4:2:0, six
//     8x8 blocks each: the whole macroblocks row by row, then the right
//     column's partial ones, then the bottom row's (with the corner);
//     the picture cropped to the container's size;
//   * ASV1: the packet's 32-bit words byte-swapped, then read most
//     significant bit first; a block is an 8-bit DC, then up to ten
//     groups of four coefficients (ff_asv_scantab's 2x2 squares) under
//     the coded-coefficient-pattern VLC (16 ends the block) with the
//     level VLC and its 8-bit escape;
//   * ASV2: the packet read least significant bit first; a block is a
//     4-bit group count, an 8-bit DC, the three coefficients after it
//     under their own pattern VLC, then the counted groups under the AC
//     pattern VLC, levels under ASV2's VLC with its 8-bit escape;
//   * the intra matrix: MPEG-1's default at each scan position times 64
//     (ASV1) or 128 (ASV2) over the quantiser the encoder keeps in the
//     first byte of the extradata (6 and 10 when there is none, or 0);
//     each level times its weight >> 4;
//   * ffmpeg's simple IDCT (idct_put).

#include <algorithm>
#include <cstdint>
#include <memory>
#include <vector>

#include "mpeg_bits.h"
#include "video.h"

namespace viai_video {

namespace {

// asv.c's tables (read from libavcodec): {code, length}.
constexpr uint8_t kScan[64] = {
    0,  8,  1,  9,  16, 24, 17, 25, 2,  10, 3,  11, 18, 26, 19, 27,
    4,  12, 5,  13, 32, 40, 33, 41, 6,  14, 7,  15, 20, 28, 21, 29,
    34, 42, 35, 43, 48, 56, 49, 57, 22, 30, 23, 31, 36, 44, 37, 45,
    50, 58, 51, 59, 38, 46, 39, 47, 52, 60, 53, 61, 54, 62, 55, 63};
constexpr uint8_t kCcp[17][2] = {
    {2, 2},  {7, 5},  {11, 5}, {3, 5}, {13, 5}, {5, 5}, {9, 5},
    {1, 5},  {14, 5}, {6, 5},  {10, 5}, {2, 5}, {12, 5}, {4, 5},
    {8, 5},  {3, 2},  {15, 5}};
constexpr uint8_t kLevel[7][2] = {{3, 4}, {3, 3}, {3, 2}, {0, 3},
                                  {2, 2}, {2, 3}, {2, 4}};
// ASV2's, least significant bit first.
constexpr uint8_t kDcCcp[8][2] = {{2, 2}, {11, 4}, {15, 4}, {3, 4},
                                  {5, 3}, {7, 4},  {1, 3},  {0, 2}};
constexpr uint8_t kAcCcp[16][2] = {
    {0, 2},  {55, 6}, {5, 4},  {23, 6}, {2, 3},  {39, 6}, {15, 6}, {7, 6},
    {6, 3},  {47, 6}, {1, 4},  {31, 5}, {9, 4},  {13, 4}, {11, 4}, {3, 4}};
constexpr uint16_t kAsv2Level[63][2] = {
    {1008, 10}, {976, 10}, {944, 10}, {912, 10}, {880, 10}, {848, 10},
    {816, 10},  {784, 10}, {752, 10}, {720, 10}, {688, 10}, {656, 10},
    {624, 10},  {592, 10}, {560, 10}, {528, 10}, {248, 8},  {232, 8},
    {216, 8},   {200, 8},  {184, 8},  {168, 8},  {152, 8},  {136, 8},
    {60, 6},    {52, 6},   {44, 6},   {36, 6},   {14, 4},   {10, 4},
    {3, 2},     {0, 5},    {1, 2},    {2, 4},    {6, 4},    {4, 6},
    {12, 6},    {20, 6},   {28, 6},   {8, 8},    {24, 8},   {40, 8},
    {56, 8},    {72, 8},   {88, 8},   {104, 8},  {120, 8},  {16, 10},
    {48, 10},   {80, 10},  {112, 10}, {144, 10}, {176, 10}, {208, 10},
    {240, 10},  {272, 10}, {304, 10}, {336, 10}, {368, 10}, {400, 10},
    {432, 10},  {464, 10}, {496, 10}};
constexpr uint8_t kMpeg1Intra[64] = {
    8,  16, 19, 22, 26, 27, 29, 34, 16, 16, 22, 24, 27, 29, 34, 37,
    19, 22, 26, 27, 29, 34, 34, 38, 22, 22, 26, 27, 29, 34, 37, 40,
    22, 26, 27, 29, 32, 35, 40, 48, 26, 27, 29, 32, 35, 40, 48, 58,
    26, 27, 29, 34, 38, 46, 56, 69, 27, 29, 35, 38, 46, 56, 69, 83};

// Bits read least significant first (libavcodec's BITSTREAM_READER_LE);
// zeros past the end.
struct LeBits {
  const uint8_t* d;
  size_t n;
  size_t pos = 0;
  uint32_t peek(int k) const {
    uint32_t v = 0;
    for (int i = 0; i < k; ++i) {
      const size_t b = pos + size_t(i);
      if ((b >> 3) < n) v |= uint32_t((d[b >> 3] >> (b & 7)) & 1) << i;
    }
    return v;
  }
  uint32_t get(int k) {
    const uint32_t v = peek(k);
    pos += size_t(k);
    return v;
  }
};

// A little-endian VLC as a lookup of `bits` bits: (length << 8 | symbol).
struct LeVlc {
  int bits;
  std::vector<uint16_t> lut;
  template <typename T>
  LeVlc(const T (*t)[2], size_t n, int max_bits)
      : bits(max_bits), lut(size_t(1) << max_bits, 0) {
    for (size_t s = 0; s < n; ++s) {
      const int l = int(t[s][1]);
      for (unsigned hi = 0; hi < (1u << (bits - l)); ++hi)
        lut[(hi << l) | unsigned(t[s][0])] = uint16_t((l << 8) | int(s));
    }
  }
  int read(LeBits& b) const {
    const uint16_t e = lut[b.peek(bits)];
    if (!e) return -1;
    b.pos += size_t(e >> 8);
    return e & 0xFF;
  }
};

}  // namespace

struct AsvDecoder::State {
  int version = 1;
  int w = 0, h = 0;
  int mb_width = 0, mb_height = 0, mb_width2 = 0, mb_height2 = 0;
  int intra_matrix[64] = {};
  mpeg::Vlc ccp{kCcp, 17, 6}, level{kLevel, 7, 6};
  LeVlc dc_ccp{kDcCcp, 8, 6}, ac_ccp{kAcCcp, 16, 6},
      asv2_level{kAsv2Level, 63, 10};

  void asv1_block(mpeg::Bits& b, int16_t* blk) const;
  void asv2_block(LeBits& b, int16_t* blk) const;
};

AsvDecoder::AsvDecoder(int version, const std::vector<uint8_t>& extradata,
                       int w, int h)
    : s_(new State) {
  State& s = *s_;
  s.version = version;
  check_size(w, h, "ASV track's");
  s.w = w;
  s.h = h;
  s.mb_width = (w + 15) / 16;
  s.mb_height = (h + 15) / 16;
  s.mb_width2 = w / 16;
  s.mb_height2 = h / 16;
  const int scale = version == 1 ? 1 : 2;
  int inv_qscale = extradata.empty() ? 0 : extradata[0];
  if (!inv_qscale) inv_qscale = version == 1 ? 6 : 10;
  for (int i = 0; i < 64; ++i)
    s.intra_matrix[i] = 64 * scale * kMpeg1Intra[kScan[i]] / inv_qscale;
}

AsvDecoder::~AsvDecoder() = default;

void AsvDecoder::State::asv1_block(mpeg::Bits& b, int16_t* blk) const {
  auto get_level = [&]() {
    const int code = level.read(b);
    if (code < 0) broken("ASV1 level damaged");
    if (code == 3) return int(int8_t(b.get(8)));
    return code - 3;
  };
  blk[0] = int16_t(8 * int(b.get(8)));
  for (int i = 0; i < 11; ++i) {
    const int c = ccp.read(b);
    if (!c) continue;
    if (c == 16) break;
    if (c < 0 || i >= 10) broken("ASV1 coded coefficient pattern damaged");
    for (int k = 0; k < 4; ++k)
      if (c & (8 >> k))
        blk[kScan[4 * i + k]] =
            int16_t((get_level() * intra_matrix[4 * i + k]) >> 4);
  }
}

void AsvDecoder::State::asv2_block(LeBits& b, int16_t* blk) const {
  auto get_level = [&]() {
    const int code = asv2_level.read(b);
    if (code < 0) broken("ASV2 level damaged");
    if (code == 31) return int(int8_t(b.get(8)));
    return code - 31;
  };
  const int count = int(b.get(4));
  blk[0] = int16_t(8 * int(b.get(8)));
  const int dc = dc_ccp.read(b);
  if (dc < 0) broken("ASV2 coded coefficient pattern damaged");
  for (int k = 1; k < 4; ++k)
    if (dc & (8 >> k))
      blk[kScan[k]] = int16_t((get_level() * intra_matrix[k]) >> 4);
  for (int i = 1; i < count + 1; ++i) {
    const int c = ac_ccp.read(b);
    if (c < 0) broken("ASV2 coded coefficient pattern damaged");
    for (int k = 0; k < 4; ++k)
      if (c & (8 >> k))
        blk[kScan[4 * i + k]] =
            int16_t((get_level() * intra_matrix[4 * i + k]) >> 4);
  }
}

bool AsvDecoder::decode(const uint8_t* data, size_t n, Picture& out) {
  const State& s = *s_;
  if (int64_t(n) * 8 < int64_t(s.mb_height) * s.mb_width * 13)
    broken("ASV packet too short for its macroblocks");
  const int fw = s.mb_width * 16, fh = s.mb_height * 16;
  std::vector<uint8_t> y(size_t(fw) * fh), u(size_t(fw / 2) * (fh / 2)),
      v(size_t(fw / 2) * (fh / 2));
  // ASV1: bswap_buf of the whole 32-bit words (a tail of 1-3 bytes is
  // left out)
  std::vector<uint8_t> swapped;
  if (s.version == 1) {
    swapped.assign(n / 4 * 4, 0);
    for (size_t i = 0; i < swapped.size(); i += 4)
      for (size_t k = 0; k < 4; ++k) swapped[i + k] = data[i + 3 - k];
  }
  mpeg::Bits b1{swapped.data(), swapped.size()};
  LeBits b2{data, n};
  int16_t blk[6][64];
  auto mb = [&](int mx, int my) {
    std::fill(&blk[0][0], &blk[0][0] + 6 * 64, int16_t(0));
    for (int i = 0; i < 6; ++i) {
      if (s.version == 1)
        s.asv1_block(b1, blk[i]);
      else
        s.asv2_block(b2, blk[i]);
    }
    uint8_t* dy = &y[size_t(my) * 16 * fw + size_t(mx) * 16];
    idct_put(blk[0], dy, fw);
    idct_put(blk[1], dy + 8, fw);
    idct_put(blk[2], dy + 8 * fw, fw);
    idct_put(blk[3], dy + 8 * fw + 8, fw);
    const size_t c = size_t(my) * 8 * (fw / 2) + size_t(mx) * 8;
    idct_put(blk[4], &u[c], fw / 2);
    idct_put(blk[5], &v[c], fw / 2);
  };
  for (int my = 0; my < s.mb_height2; ++my)
    for (int mx = 0; mx < s.mb_width2; ++mx) mb(mx, my);
  if (s.mb_width2 != s.mb_width)
    for (int my = 0; my < s.mb_height2; ++my) mb(s.mb_width2, my);
  if (s.mb_height2 != s.mb_height)
    for (int mx = 0; mx < s.mb_width; ++mx) mb(mx, s.mb_height2);
  out = Picture();
  out.w = s.w;
  out.h = s.h;
  out.ystride = s.w;
  out.xshift = out.yshift = 1;
  const int cw = (s.w + 1) / 2, ch = (s.h + 1) / 2;
  out.cstride = cw;
  out.y.resize(size_t(s.w) * s.h);
  out.u.resize(size_t(cw) * ch);
  out.v.resize(size_t(cw) * ch);
  for (int r = 0; r < s.h; ++r)
    std::copy_n(&y[size_t(r) * fw], s.w, &out.y[size_t(r) * s.w]);
  for (int r = 0; r < ch; ++r) {
    std::copy_n(&u[size_t(r) * (fw / 2)], cw, &out.u[size_t(r) * cw]);
    std::copy_n(&v[size_t(r) * (fw / 2)], cw, &out.v[size_t(r) * cw]);
  }
  return true;
}

}  // namespace viai_video
