// MPEG-4 Part 2 (ISO/IEC 14496-2) video decoder of viai_tpu_torch, for
// what ffmpeg's mpeg4 encoder writes through cv2's VideoWriter (fourccs
// mp4v, FMP4, XVID, DIVX, DX50; objectTypeIndication 0x20): a
// rectangular Simple-profile stream of I-VOPs and P-VOPs, decoded as
// libavcodec's mpeg4 decoder decodes it:
//
//   * the VOS, VO and VOL headers, GOV and user data skipped;
//   * H.263 quantisation: intra DC by the MPEG-4 DC scalers with intra DC
//     prediction (neighbours outside the picture or not intra give 1024),
//     intra AC by 2·q·|l| + ((q − 1) | 1), inter levels the same, third
//     escapes clipped to ±2048;
//   * 1MV: median prediction of the left, above and above-right vectors
//     (the first row takes the left one), f_code wrap-around, half-pel
//     motion compensation with vop_rounding_type, chroma vectors by the
//     H.263 rule, unrestricted vectors reading the reference with its
//     coordinates clamped to the picture's macroblock-rounded size;
//   * not-coded macroblocks (a copy at vector 0), not-coded VOPs (no
//     picture, as ffmpeg gives none);
//   * ffmpeg's simple IDCT (videodec.cpp).
//
// Each feature the encoder does not write raises NotImplementedError
// (code 2) naming it, detected from its header or macroblock flag:
// B-VOPs and packed bitstreams, S-VOPs (GMC) and sprites, quarter-pel,
// interlace, data partitioning/RVLC, video packets (resync markers),
// MPEG quantisation matrices, 4MV, AC prediction, short-header H.263,
// arbitrary shapes, OBMC, scalability, newpred, reduced resolution,
// complexity estimation, bit depths other than 8, and streams that
// libavcodec decodes with its bug workarounds or another IDCT (XviD and
// DivX user data, libavcodec builds before 4714).

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include "video.h"

namespace viai_video {

namespace {

// Table B-16/B-17 (TCOEF): (code, length) a row, the escape last; each
// non-escape code's run and |level|; codes from `kLast*` on end the block.
const uint16_t kInterVlc[103][2] = {
    {0x2, 2}, {0xf, 4}, {0x15, 6}, {0x17, 7}, {0x1f, 8}, {0x25, 9},
    {0x24, 9}, {0x21, 10}, {0x20, 10}, {0x7, 11}, {0x6, 11}, {0x20, 11},
    {0x6, 3}, {0x14, 6}, {0x1e, 8}, {0xf, 10}, {0x21, 11}, {0x50, 12},
    {0xe, 4}, {0x1d, 8}, {0xe, 10}, {0x51, 12}, {0xd, 5}, {0x23, 9},
    {0xd, 10}, {0xc, 5}, {0x22, 9}, {0x52, 12}, {0xb, 5}, {0xc, 10},
    {0x53, 12}, {0x13, 6}, {0xb, 10}, {0x54, 12}, {0x12, 6}, {0xa, 10},
    {0x11, 6}, {0x9, 10}, {0x10, 6}, {0x8, 10}, {0x16, 7}, {0x55, 12},
    {0x15, 7}, {0x14, 7}, {0x1c, 8}, {0x1b, 8}, {0x21, 9}, {0x20, 9},
    {0x1f, 9}, {0x1e, 9}, {0x1d, 9}, {0x1c, 9}, {0x1b, 9}, {0x1a, 9},
    {0x22, 11}, {0x23, 11}, {0x56, 12}, {0x57, 12}, {0x7, 4}, {0x19, 9},
    {0x5, 11}, {0xf, 6}, {0x4, 11}, {0xe, 6}, {0xd, 6}, {0xc, 6},
    {0x13, 7}, {0x12, 7}, {0x11, 7}, {0x10, 7}, {0x1a, 8}, {0x19, 8},
    {0x18, 8}, {0x17, 8}, {0x16, 8}, {0x15, 8}, {0x14, 8}, {0x13, 8},
    {0x18, 9}, {0x17, 9}, {0x16, 9}, {0x15, 9}, {0x14, 9}, {0x13, 9},
    {0x12, 9}, {0x11, 9}, {0x7, 10}, {0x6, 10}, {0x5, 10}, {0x4, 10},
    {0x24, 11}, {0x25, 11}, {0x26, 11}, {0x27, 11}, {0x58, 12}, {0x59, 12},
    {0x5a, 12}, {0x5b, 12}, {0x5c, 12}, {0x5d, 12}, {0x5e, 12}, {0x5f, 12},
    {0x3, 7},
};
const int8_t kInterRun[102] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3,
    3, 4, 4, 4, 5, 5, 5, 6, 6, 6, 7, 7,
    8, 8, 9, 9, 10, 10, 11, 12, 13, 14, 15, 16,
    17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 0, 0,
    0, 1, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10,
    11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22,
    23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34,
    35, 36, 37, 38, 39, 40,
};
const int8_t kInterLevel[102] = {
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12,
    1, 2, 3, 4, 5, 6, 1, 2, 3, 4, 1, 2,
    3, 1, 2, 3, 1, 2, 3, 1, 2, 3, 1, 2,
    1, 2, 1, 2, 1, 2, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2,
    3, 1, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1,
};
const uint16_t kIntraVlc[103][2] = {
    {0x2, 2}, {0x6, 3}, {0xf, 4}, {0xd, 5}, {0xc, 5}, {0x15, 6},
    {0x13, 6}, {0x12, 6}, {0x17, 7}, {0x1f, 8}, {0x1e, 8}, {0x1d, 8},
    {0x25, 9}, {0x24, 9}, {0x23, 9}, {0x21, 9}, {0x21, 10}, {0x20, 10},
    {0xf, 10}, {0xe, 10}, {0x7, 11}, {0x6, 11}, {0x20, 11}, {0x21, 11},
    {0x50, 12}, {0x51, 12}, {0x52, 12}, {0xe, 4}, {0x14, 6}, {0x16, 7},
    {0x1c, 8}, {0x20, 9}, {0x1f, 9}, {0xd, 10}, {0x22, 11}, {0x53, 12},
    {0x55, 12}, {0xb, 5}, {0x15, 7}, {0x1e, 9}, {0xc, 10}, {0x56, 12},
    {0x11, 6}, {0x1b, 8}, {0x1d, 9}, {0xb, 10}, {0x10, 6}, {0x22, 9},
    {0xa, 10}, {0xd, 6}, {0x1c, 9}, {0x8, 10}, {0x12, 7}, {0x1b, 9},
    {0x54, 12}, {0x14, 7}, {0x1a, 9}, {0x57, 12}, {0x19, 8}, {0x9, 10},
    {0x18, 8}, {0x23, 11}, {0x17, 8}, {0x19, 9}, {0x18, 9}, {0x7, 10},
    {0x58, 12}, {0x7, 4}, {0xc, 6}, {0x16, 8}, {0x17, 9}, {0x6, 10},
    {0x5, 11}, {0x4, 11}, {0x59, 12}, {0xf, 6}, {0x16, 9}, {0x5, 10},
    {0xe, 6}, {0x4, 10}, {0x11, 7}, {0x24, 11}, {0x10, 7}, {0x25, 11},
    {0x13, 7}, {0x5a, 12}, {0x15, 8}, {0x5b, 12}, {0x14, 8}, {0x13, 8},
    {0x1a, 8}, {0x15, 9}, {0x14, 9}, {0x13, 9}, {0x12, 9}, {0x11, 9},
    {0x26, 11}, {0x27, 11}, {0x5c, 12}, {0x5d, 12}, {0x5e, 12}, {0x5f, 12},
    {0x3, 7},
};
const int8_t kIntraRun[102] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 2, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4,
    4, 5, 5, 5, 6, 6, 6, 7, 7, 7, 8, 8,
    9, 9, 10, 11, 12, 13, 14, 0, 0, 0, 0, 0,
    0, 0, 0, 1, 1, 1, 2, 2, 3, 3, 4, 4,
    5, 5, 6, 6, 7, 8, 9, 10, 11, 12, 13, 14,
    15, 16, 17, 18, 19, 20,
};
const int8_t kIntraLevel[102] = {
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12,
    13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24,
    25, 26, 27, 1, 2, 3, 4, 5, 6, 7, 8, 9,
    10, 1, 2, 3, 4, 5, 1, 2, 3, 4, 1, 2,
    3, 1, 2, 3, 1, 2, 3, 1, 2, 3, 1, 2,
    1, 2, 1, 1, 1, 1, 1, 1, 2, 3, 4, 5,
    6, 7, 8, 1, 2, 3, 1, 2, 1, 2, 1, 2,
    1, 2, 1, 2, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1,
};

constexpr int kInterLast = 58, kIntraLast = 67;

// ffmpeg's zigzag: scan position → natural index.
const uint8_t kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// (code, length): MCBPC for I-VOPs (type 3 cbpc 0..3, type 4 cbpc 0..3,
// stuffing), for P-VOPs (inter, intra, inter+Q, intra+Q, inter4v, 4
// each, then stuffing), CBPY, the motion vector codes 0..32, DC sizes.
const uint8_t kIntraMcbpc[9][2] = {{1, 1}, {1, 3}, {2, 3}, {3, 3}, {1, 4},
                                   {1, 6}, {2, 6}, {3, 6}, {1, 9}};
const uint8_t kInterMcbpc[21][2] = {
    {1, 1}, {3, 4}, {2, 4}, {5, 6}, {3, 5}, {4, 8}, {3, 8},
    {3, 7}, {3, 3}, {7, 7}, {6, 7}, {5, 9}, {4, 6}, {4, 9},
    {3, 9}, {2, 9}, {2, 3}, {5, 7}, {4, 7}, {5, 8}, {1, 9}};
const uint8_t kCbpy[16][2] = {{3, 4}, {5, 5},  {4, 5}, {9, 4}, {3, 5}, {7, 4},
                              {2, 6}, {11, 4}, {2, 5}, {3, 6}, {5, 4}, {10, 4},
                              {4, 4}, {8, 4},  {6, 4}, {3, 2}};
const uint8_t kMv[33][2] = {
    {1, 1},   {1, 2},   {1, 3},   {1, 4},   {3, 6},   {5, 7},   {4, 7},
    {3, 7},   {11, 9},  {10, 9},  {9, 9},   {17, 10}, {16, 10}, {15, 10},
    {14, 10}, {13, 10}, {12, 10}, {11, 10}, {10, 10}, {9, 10},  {8, 10},
    {7, 10},  {6, 10},  {5, 10},  {4, 10},  {7, 11},  {6, 11},  {5, 11},
    {4, 11},  {3, 11},  {2, 11},  {3, 12},  {2, 12}};
const uint8_t kDcLuma[13][2] = {{3, 3}, {3, 2}, {2, 2}, {2, 3}, {1, 3},
                                {1, 4}, {1, 5}, {1, 6}, {1, 7}, {1, 8},
                                {1, 9}, {1, 10}, {1, 11}};
const uint8_t kDcChroma[13][2] = {{3, 2}, {2, 2}, {1, 2}, {1, 3}, {1, 4},
                                  {1, 5}, {1, 6}, {1, 7}, {1, 8}, {1, 9},
                                  {1, 10}, {1, 11}, {1, 12}};

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
  void skip(int k) { pos += size_t(k); }
  bool over() const { return pos > 8 * n; }
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

// The TCOEF table of a kind, with ffmpeg's max_level/max_run per last.
struct Rl {
  Vlc vlc;
  const int8_t* run;
  const int8_t* level;
  int last;
  int max_level[2][64];
  int max_run[2][64];
  Rl(const uint16_t (*t)[2], const int8_t* r, const int8_t* l, int lst)
      : vlc(t, 103, 12), run(r), level(l), last(lst) {
    std::memset(max_level, 0, sizeof(max_level));
    std::memset(max_run, 0, sizeof(max_run));
    for (int i = 0; i < 102; ++i) {
      int k = i >= last;
      max_level[k][run[i]] = std::max(max_level[k][run[i]], int(level[i]));
      max_run[k][level[i]] = std::max(max_run[k][level[i]], int(run[i]));
    }
  }
};

template <typename T, size_t N>
Vlc make_vlc(const T (&t)[N][2], int max_bits) {
  return Vlc(t, N, max_bits);
}

const Vlc& intra_mcbpc_vlc() {
  static const Vlc v = make_vlc(kIntraMcbpc, 9);
  return v;
}
const Vlc& inter_mcbpc_vlc() {
  static const Vlc v = make_vlc(kInterMcbpc, 9);
  return v;
}
const Vlc& cbpy_vlc() {
  static const Vlc v = make_vlc(kCbpy, 6);
  return v;
}
const Vlc& mv_vlc() {
  static const Vlc v = make_vlc(kMv, 12);
  return v;
}
const Vlc& dc_luma_vlc() {
  static const Vlc v = make_vlc(kDcLuma, 11);
  return v;
}
const Vlc& dc_chroma_vlc() {
  static const Vlc v = make_vlc(kDcChroma, 12);
  return v;
}
const Rl& intra_rl() {
  static const Rl r(kIntraVlc, kIntraRun, kIntraLevel, kIntraLast);
  return r;
}
const Rl& inter_rl() {
  static const Rl r(kInterVlc, kInterRun, kInterLevel, kInterLast);
  return r;
}

int y_dc_scale(int q) {
  return q < 5 ? 8 : q < 9 ? 2 * q : q < 25 ? q + 8 : 2 * q - 16;
}
int c_dc_scale(int q) {
  return q < 5 ? 8 : q < 25 ? (q + 13) / 2 : q - 6;
}

inline int mid_pred(int a, int b, int c) {
  return std::max(std::min(a, b), std::min(std::max(a, b), c));
}

inline uint8_t clip_u8(int v) {
  return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v);
}

struct Frame {
  std::vector<uint8_t> y, u, v;   // coded size, strides cw and cw / 2
};

// Where the next start code (00 00 01 xx) begins at or after `p`; n if
// none.
size_t next_start(const uint8_t* d, size_t n, size_t p) {
  for (; p + 3 < n; ++p)
    if (d[p] == 0 && d[p + 1] == 0 && d[p + 2] == 1) return p;
  return n;
}

}  // namespace

struct Mpeg4Decoder::State {
  std::string tag;
  bool have_vol = false;
  int width = 0, height = 0, mbw = 0, mbh = 0;
  int time_bits = 1;
  // VOP
  int type = 0, qscale = 1, rounding = 0, fcode = 1, dc_thr = 0;
  Frame cur, ref;
  bool have_ref = false;
  // This VOP's intra DC levels · scale (1024 where not intra): luma by
  // 8x8 block (2·mbh, 2·mbw), then Cb and Cr by macroblock (mbh, mbw).
  std::vector<int> dc;
  std::vector<int16_t> mvs;      // (mbh, mbw, 2) this VOP's vectors

  [[noreturn]] void no(const std::string& what) {
    unsupported("MPEG-4 Part 2 ('" + tag + "'): " + what);
  }
  [[noreturn]] void bad(const std::string& what) {
    broken("MPEG-4 Part 2 ('" + tag + "'): " + what);
  }

  void parse_vo(Bits& b) {
    if (b.get1()) b.skip(7);                  // verid, priority
    int type = int(b.get(4));
    if (type != 1) no("visual object type other than video");
  }

  void parse_vol(Bits& b) {
    b.skip(1);                                // random_accessible_vol
    int vo_type = int(b.get(8));
    if (vo_type == 0x12) no("fine granularity scalability");
    int verid = 1;
    if (b.get1()) {
      verid = int(b.get(4));
      b.skip(3);
    }
    if (b.get(4) == 15) b.skip(16);           // extended PAR
    if (b.get1()) {                           // vol_control_parameters
      if (b.get(2) != 1) no("chroma format other than 4:2:0");
      b.skip(1);                              // low_delay
      if (b.get1()) b.skip(79);               // vbv parameters
    }
    int shape = int(b.get(2));
    if (shape != 0) no("arbitrary (non-rectangular) shape");
    b.skip(1);
    int res = int(b.get(16));
    if (res == 0) bad("VOL with a time increment resolution of 0");
    b.skip(1);
    int bits = 0;
    while ((1 << bits) < res) ++bits;         // av_log2(res − 1) + 1
    time_bits = std::max(bits, 1);
    if (b.get1()) b.skip(time_bits);          // fixed_vop_rate
    b.skip(1);
    width = int(b.get(13));
    b.skip(1);
    height = int(b.get(13));
    b.skip(1);
    if (b.get1()) no("interlace");
    if (!b.get1()) no("OBMC");
    int sprite = int(b.get(verid == 1 ? 1 : 2));
    if (sprite == 1) no("static sprites");
    if (sprite == 2) no("GMC (S-VOPs)");
    if (b.get1()) no("bit depths other than 8 (not_8_bit)");
    if (b.get1()) no("MPEG quantisation matrices (quant_type 1)");
    if (verid != 1 && b.get1()) no("quarter-pel motion");
    if (!b.get1()) no("complexity estimation headers");
    if (!b.get1()) no("video packets (resync markers)");
    if (b.get1()) no("data partitioning/RVLC");
    if (verid != 1) {
      if (b.get1()) no("newpred");
      if (b.get1()) no("reduced resolution VOPs");
    }
    if (b.get1()) no("scalability");
    if (width < 1 || height < 1 || width > 8192 || height > 8192)
      bad("VOL size out of range");
    mbw = (width + 15) / 16;
    mbh = (height + 15) / 16;
    have_vol = true;
    have_ref = false;
  }

  void parse_user_data(const uint8_t* d, size_t n) {
    std::string s(reinterpret_cast<const char*>(d), n);
    if (s.compare(0, 4, "XviD") == 0)
      no("an XviD stream (libavcodec decodes it with the XviD IDCT)");
    if (s.compare(0, 4, "DivX") == 0)
      no("a DivX stream (libavcodec applies DivX bug workarounds and "
         "reads packed bitstreams)");
    int a = 0, bb = 0, c = 0;
    if (std::sscanf(s.c_str(), "Lavc%d.%d.%d", &a, &bb, &c) == 3 &&
        (a << 16) + (bb << 8) + c < 4714)
      no("an old libavcodec's stream (decoded with bug workarounds)");
    int build = 0;
    if (std::sscanf(s.c_str(), "FFmpeg v%*d.%*d.%*d / libavcodec build: %d",
                    &build) == 1 || std::sscanf(s.c_str(), "FFmpe%*[^b]b%d",
                                                &build) == 1)
      if (build < 4714)
        no("an old libavcodec's stream (decoded with bug workarounds)");
  }

  // The VOP header up to vop_coded → the VOP kind, or −1 when not coded.
  int vop_header(Bits& b, bool full) {
    if (!have_vol) bad("VOP before its VOL header");
    int t = int(b.get(2));
    while (b.get1()) {                        // modulo_time_base
      if (b.over()) bad("VOP header cut short");
    }
    b.skip(1);
    b.skip(time_bits);
    b.skip(1);
    if (!b.get1()) return -1;                 // vop_coded
    if (t == 2) no("B-VOPs");
    if (t == 3) no("S-VOPs (GMC)");
    if (!full) return t;
    type = t;
    rounding = t == 1 ? b.get1() : 0;
    dc_thr = int(b.get(3));
    qscale = int(b.get(5));
    if (qscale == 0) bad("VOP quantiser 0");
    if (t == 1) {
      fcode = int(b.get(3));
      if (fcode == 0) bad("VOP f_code 0");
    }
    return t;
  }

  // ---------------------------------------------------------- blocks

  // ff_mpeg4_pred_dc: block n's DC predictor, stored DC level·scale.
  int dc_pred(int mx, int my, int n, int scale, int& at) {
    int bx, by, w;
    int* plane;
    if (n < 4) {
      bx = 2 * mx + (n & 1);
      by = 2 * my + (n >> 1);
      w = 2 * mbw;
      plane = &dc[0];
    } else {
      bx = mx;
      by = my;
      w = mbw;
      plane = &dc[size_t(4 * mbw * mbh) + size_t(n - 4) * mbw * mbh];
    }
    auto val = [&](int x, int y) {
      return x < 0 || y < 0 ? 1024 : plane[size_t(y) * w + x];
    };
    int a = val(bx - 1, by), b = val(bx - 1, by - 1), c = val(bx, by - 1);
    at = by * w + bx;
    int pred = std::abs(a - b) < std::abs(b - c) ? c : a;
    return (pred + (scale >> 1)) / scale;
  }

  void dc_store(int n, int at, int level) {
    int* plane = n < 4 ? &dc[0]
                       : &dc[size_t(4 * mbw * mbh) + size_t(n - 4) * mbw * mbh];
    if (level & ~2047) level = level < 0 ? 0 : 2047;
    plane[at] = level;
  }

  // One block's coefficients (natural order) into blk; intra blocks get
  // their DC predicted and are dequantized here, inter levels as read.
  void block(Bits& b, int16_t* blk, int mx, int my, int n, bool intra,
             bool coded, bool dc_vlc) {
    std::memset(blk, 0, 64 * sizeof(int16_t));
    int q = qscale;
    int i;
    int dc_at = 0, scale = n < 4 ? y_dc_scale(q) : c_dc_scale(q);
    if (intra) {
      if (dc_vlc) {
        int size = (n < 4 ? dc_luma_vlc() : dc_chroma_vlc()).read(b);
        if (size < 0 || size > 9) bad("bad intra DC size code");
        int diff = 0;
        if (size) {
          int v = int(b.get(size));
          diff = v >> (size - 1) ? v : v - (1 << size) + 1;
          if (size > 8) b.skip(1);
        }
        int level = dc_pred(mx, my, n, scale, dc_at) + diff;
        dc_store(n, dc_at, level * scale);
        blk[0] = int16_t(level);
        i = 0;
      } else {
        i = -1;
      }
    } else {
      i = -1;
    }
    const Rl& rl = intra ? intra_rl() : inter_rl();
    int qmul = intra ? 1 : 2 * q, qadd = intra ? 0 : (q - 1) | 1;
    if (coded) {
      for (;;) {
        int c = rl.vlc.read(b);
        if (c < 0) bad("bad TCOEF code");
        int last, run, level;
        if (c == 102) {                          // escape
          if (!b.get1()) {                       // type 1: level offset
            c = rl.vlc.read(b);
            if (c < 0 || c == 102) bad("bad TCOEF escape");
            last = c >= rl.last;
            run = rl.run[c];
            level = rl.level[c] + rl.max_level[last][run];
            level = level * qmul + qadd;
            if (b.get1()) level = -level;
          } else if (!b.get1()) {                // type 2: run offset
            c = rl.vlc.read(b);
            if (c < 0 || c == 102) bad("bad TCOEF escape");
            last = c >= rl.last;
            run = rl.run[c] + rl.max_run[last][rl.level[c]] + 1;
            level = rl.level[c] * qmul + qadd;
            if (b.get1()) level = -level;
          } else {                               // type 3: fixed length
            last = b.get1();
            run = int(b.get(6));
            b.skip(1);
            level = int(b.get(12));
            if (level & 0x800) level -= 0x1000;
            b.skip(1);
            if (level == 0) bad("TCOEF escape of level 0");
            level = level > 0 ? level * qmul + qadd : level * qmul - qadd;
            if (unsigned(level + 2048) > 4095) level = level < 0 ? -2048 : 2047;
          }
        } else {
          last = c >= rl.last;
          run = rl.run[c];
          level = rl.level[c] * qmul + qadd;
          if (b.get1()) level = -level;
        }
        i += run + 1;
        if (i > 63) bad("TCOEF run past the block");
        blk[kZigzag[i]] = int16_t(level);
        if (last) break;
        if (b.over()) bad("macroblock data cut short");
      }
    }
    if (!intra) return;
    if (!dc_vlc) {
      int level = dc_pred(mx, my, n, scale, dc_at) + blk[0];
      dc_store(n, dc_at, level * scale);
      blk[0] = int16_t(level);
    }
    // dct_unquantize_h263_intra.
    blk[0] = int16_t(blk[0] * scale);
    int qm = 2 * q, qa = (q - 1) | 1;
    for (int k = 1; k < 64; ++k) {
      int l = blk[k];
      if (l) blk[k] = int16_t(l < 0 ? l * qm - qa : l * qm + qa);
    }
  }

  // ------------------------------------------------------ prediction

  // hpel put of a (bw, bh) block from plane (pw, ph) stride ps, read at
  // integer (sx, sy) with half-pel flags dxy, coordinates clamped.
  void mc(const uint8_t* src, int ps, int pw, int ph, int sx, int sy,
          int dxy, uint8_t* dst, int ds, int bw, int bh) {
    auto at = [&](int x, int y) {
      x = std::min(std::max(x, 0), pw - 1);
      y = std::min(std::max(y, 0), ph - 1);
      return int(src[size_t(y) * ps + x]);
    };
    int r = rounding;
    for (int y = 0; y < bh; ++y)
      for (int x = 0; x < bw; ++x) {
        int a = at(sx + x, sy + y), v;
        switch (dxy) {
          case 0: v = a; break;
          case 1: v = (a + at(sx + x + 1, sy + y) + 1 - r) >> 1; break;
          case 2: v = (a + at(sx + x, sy + y + 1) + 1 - r) >> 1; break;
          default:
            v = (a + at(sx + x + 1, sy + y) + at(sx + x, sy + y + 1) +
                 at(sx + x + 1, sy + y + 1) + 2 - r) >> 2;
        }
        dst[size_t(y) * ds + x] = uint8_t(v);
      }
  }

  void predict(int mx, int my, int vx, int vy) {
    int cw = mbw * 16, ch = mbh * 16;
    int dxy = ((vy & 1) << 1) | (vx & 1);
    int sx = mx * 16 + (vx >> 1), sy = my * 16 + (vy >> 1);
    mc(ref.y.data(), cw, cw, ch, sx, sy, dxy,
       &cur.y[size_t(my) * 16 * cw + mx * 16], cw, 16, 16);
    int uvdxy = dxy | (vy & 2) | ((vx & 2) >> 1);
    int ux = sx >> 1, uy = sy >> 1;
    int cs = cw / 2;
    mc(ref.u.data(), cs, cs, ch / 2, ux, uy, uvdxy,
       &cur.u[size_t(my) * 8 * cs + mx * 8], cs, 8, 8);
    mc(ref.v.data(), cs, cs, ch / 2, ux, uy, uvdxy,
       &cur.v[size_t(my) * 8 * cs + mx * 8], cs, 8, 8);
  }

  int motion(Bits& b, int pred) {
    int code = mv_vlc().read(b);
    if (code < 0) bad("bad motion vector code");
    if (code == 0) return pred;
    int sign = b.get1();
    int shift = fcode - 1;
    int val = code;
    if (shift) {
      val = (val - 1) << shift;
      val |= int(b.get(shift));
      val++;
    }
    if (sign) val = -val;
    val += pred;
    int bits = 5 + fcode;                     // sign_extend(val, 5 + f)
    int m = 1 << (bits - 1);
    val = ((val + m) & ((1 << bits) - 1)) - m;
    return val;
  }

  void mv_pred(int mx, int my, int& px, int& py) {
    auto mv = [&](int x, int y, int k) {
      if (x < 0 || y < 0 || x >= mbw) return 0;
      return int(mvs[(size_t(y) * mbw + x) * 2 + k]);
    };
    if (my == 0) {
      px = mx == 0 ? 0 : mv(mx - 1, 0, 0);
      py = mx == 0 ? 0 : mv(mx - 1, 0, 1);
      return;
    }
    int ax = mx == 0 ? 0 : mv(mx - 1, my, 0), ay = mx == 0 ? 0 : mv(mx - 1, my, 1);
    px = mid_pred(ax, mv(mx, my - 1, 0), mv(mx + 1, my - 1, 0));
    py = mid_pred(ay, mv(mx, my - 1, 1), mv(mx + 1, my - 1, 1));
  }

  // ------------------------------------------------------ the VOP

  void put_blocks(int16_t (*blk)[64], int mx, int my, int cbp, bool intra) {
    int cw = mbw * 16, cs = cw / 2;
    for (int n = 0; n < 6; ++n) {
      uint8_t* dst;
      int stride;
      if (n < 4) {
        dst = &cur.y[size_t(my * 16 + (n >> 1) * 8) * cw + mx * 16 +
                     (n & 1) * 8];
        stride = cw;
      } else {
        dst = &(n == 4 ? cur.u : cur.v)[size_t(my) * 8 * cs + mx * 8];
        stride = cs;
      }
      if (intra) idct_put(blk[n], dst, stride);
      else if (cbp & (32 >> n)) idct_add(blk[n], dst, stride);
    }
  }

  void decode_vop(Bits& b) {
    int cw = mbw * 16, ch = mbh * 16;
    if (type == 1 && !have_ref) bad("P-VOP without a reference picture");
    cur.y.assign(size_t(cw) * ch, 0);
    cur.u.assign(size_t(cw / 2) * (ch / 2), 0);
    cur.v.assign(size_t(cw / 2) * (ch / 2), 0);
    dc.assign(size_t(6) * mbw * mbh, 1024);
    mvs.assign(size_t(2) * mbw * mbh, 0);
    static const int kDquant[4] = {-1, -2, 1, 2};
    static const int kDcThr[8] = {99, 13, 15, 17, 19, 21, 23, 0};
    int16_t blk[6][64];
    for (int my = 0; my < mbh; ++my)
      for (int mx = 0; mx < mbw; ++mx) {
        if (b.over()) bad("VOP data cut short");
        bool intra;
        int cbpc, mbtype;
        if (type == 1) {
          if (b.get1()) {                       // not coded
            predict(mx, my, 0, 0);
            continue;
          }
          int c;
          do {
            c = inter_mcbpc_vlc().read(b);
            if (c < 0) bad("bad MCBPC code");
          } while (c == 20);
          mbtype = c >> 2;                      // 0 inter, 1 intra, 2 inter+Q,
          cbpc = c & 3;                         // 3 intra+Q, 4 inter4v
          if (mbtype == 4) no("4MV (inter4v macroblocks)");
          intra = mbtype == 1 || mbtype == 3;
        } else {
          int c;
          do {
            c = intra_mcbpc_vlc().read(b);
            if (c < 0) bad("bad MCBPC code");
          } while (c == 8);
          mbtype = c < 4 ? 1 : 3;
          cbpc = c & 3;
          intra = true;
        }
        bool dquant = mbtype == 2 || mbtype == 3;
        if (intra && b.get1()) no("AC prediction");
        int cbpy = cbpy_vlc().read(b);
        if (cbpy < 0) bad("bad CBPY code");
        if (!intra) cbpy ^= 15;
        int cbp = (cbpy << 2) | cbpc;
        bool dc_vlc = qscale < kDcThr[dc_thr];
        if (dquant)
          qscale = std::min(std::max(qscale + kDquant[b.get(2)], 1), 31);
        if (intra) {
          for (int n = 0; n < 6; ++n)
            block(b, blk[n], mx, my, n, true, cbp & (32 >> n), dc_vlc);
          put_blocks(blk, mx, my, cbp, true);
          continue;
        }
        int px, py;
        mv_pred(mx, my, px, py);
        int vx = motion(b, px);
        int vy = motion(b, py);
        mvs[(size_t(my) * mbw + mx) * 2] = int16_t(vx);
        mvs[(size_t(my) * mbw + mx) * 2 + 1] = int16_t(vy);
        for (int n = 0; n < 6; ++n)
          block(b, blk[n], mx, my, n, false, cbp & (32 >> n), false);
        predict(mx, my, vx, vy);
        put_blocks(blk, mx, my, cbp, false);
      }
    std::swap(ref, cur);
    have_ref = true;
  }

  void output(Picture& out) {
    int cw = mbw * 16;
    out.w = width;
    out.h = height;
    out.ystride = cw;
    out.cstride = cw / 2;
    out.y = ref.y;
    out.u = ref.u;
    out.v = ref.v;
    out.full_range = false;
  }

  // Walk a packet's start codes; decode its VOP when `full`.
  int packet(const uint8_t* d, size_t n, bool full, Picture* out) {
    size_t p = next_start(d, n, 0);
    int kind = -1;
    bool vop_seen = false;
    if (p == n && n >= 3 && d[0] == 0 && d[1] == 0 && (d[2] & 0xFC) == 0x80)
      no("short-header (H.263) video");
    while (p < n) {
      size_t q = next_start(d, n, p + 4);
      uint8_t code = d[p + 3];
      Bits b{d + p + 4, n - p - 4};
      if (code >= 0x20 && code <= 0x2F) {
        parse_vol(b);
      } else if (code == 0xB5) {
        parse_vo(b);
      } else if (code == 0xB2) {
        parse_user_data(d + p + 4, q - p - 4);
      } else if (code == 0xB6) {
        if (vop_seen) no("packed bitstreams (two VOPs in one packet)");
        vop_seen = true;
        Bits vb{d + p + 4, n - p - 4};
        kind = vop_header(vb, full);
        if (kind >= 0 && full) {
          decode_vop(vb);
          output(*out);
        }
        // The rest of the VOP's data may hold 00 00 01 only at its end.
        q = next_start(d, n, p + 4);
        while (q < n && d[q + 3] != 0xB6 && d[q + 3] != 0xB0 &&
               d[q + 3] != 0xB3 && d[q + 3] != 0xB5 && d[q + 3] != 0xB2 &&
               !(d[q + 3] >= 0x20 && d[q + 3] <= 0x2F))
          q = next_start(d, n, q + 4);
      } else if (code == 0xB0 || code == 0xB1 || code == 0xB3 ||
                 code <= 0x1F) {
        // VOS, its end, GOV, VO: nothing the decoder keeps.
      } else if (code >= 0xB7 && code <= 0xB9) {
        // reserved, slice/extension start codes of other syntaxes
      } else {
        no("start code 0x" + std::to_string(code));
      }
      p = q;
    }
    return kind;
  }
};

Mpeg4Decoder::Mpeg4Decoder(const std::vector<uint8_t>& config,
                           const std::string& tag)
    : s_(new State) {
  s_->tag = tag;
  if (!config.empty()) s_->packet(config.data(), config.size(), false, nullptr);
}

Mpeg4Decoder::~Mpeg4Decoder() = default;

bool Mpeg4Decoder::decode(const uint8_t* data, size_t n, Picture& out) {
  return s_->packet(data, n, true, &out) >= 0;
}

int Mpeg4Decoder::peek(const uint8_t* data, size_t n) {
  return s_->packet(data, n, false, nullptr);
}

}  // namespace viai_video
