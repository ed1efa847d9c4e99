// MPEG-4 Part 2 (ISO/IEC 14496-2) video decoder of viai_tpu_torch, for
// what libavcodec's mpeg4 encoder and XviD write (fourccs mp4v, FMP4, XVID,
// DIVX, DX50; objectTypeIndication 0x20): rectangular progressive Simple
// and Advanced Simple Profile streams, decoded as libavcodec's mpeg4
// decoder decodes them:
//
//   * the VOS, VO and VOL headers, GOV time codes, user data (the XviD,
//     DivX and libavcodec builds, from which libavcodec derives its bug
//     workarounds and the XviD IDCT: FF_BUG_QPEL_CHROMA and _CHROMA2,
//     EDGE, DC_CLIP);
//   * I-, P-, B- and S-VOPs (GMC); not-coded VOPs (no picture);
//   * H.263 and MPEG quantisation (the default or loaded matrices, inter
//     mismatch control), intra DC prediction, AC prediction with its
//     alternate scans and rescaling across quantisers;
//   * 1MV and 4MV (median prediction, chroma by the H.263 rounding table),
//     half-pel and quarter-pel motion (MPEG-4's 8-tap filters over each
//     block alone), libavcodec's edge handling;
//   * B-VOPs: forward, backward, interpolated and direct (from the
//     backward reference's vectors by TRB/TRD, 8x8 under quarter-pel),
//     skipped where the backward reference's macroblock was; output one
//     picture behind (low_delay 0), flushed at the end;
//   * packed bitstreams (DivX's 'p'): a B-VOP after a P-VOP in one packet
//     is decoded at the next packet, as libavcodec unpacks them;
//   * GMC of up to 3 warping points at any accuracy, reduced to libavcodec's
//     one-point route where the warp is a translation, mcsel per macroblock;
//   * video packets (resync markers, header extension) and data
//     partitioning (not RVLC);
//   * ffmpeg's simple IDCT, or the XviD IDCT for XviD's streams
//     (videodec.cpp).
//
// Each feature that is not read raises NotImplementedError (code 2)
// naming it, detected from its header or macroblock flag: interlace
// (cv2's libavcodec 62 gives no usable frames of it), short-header H.263,
// static sprites, GMC brightness change or with data partitioning, RVLC,
// OBMC, arbitrary shapes, scalability, newpred, reduced resolution,
// complexity estimation, bit depths other than 8, and streams that
// libavcodec decodes with workarounds not copied (libavcodec builds
// before 4714 or with its IEDGE bug, DivX 5.00 build 413 GMC, UMP4, GEOV's
// bottom-up pictures; XVIX's workaround is for interlace, which raises).

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include "mpeg_bits.h"
#include "video.h"

namespace viai_video {

namespace {

using mpeg::Bits;
using mpeg::kAltHorizontal;
using mpeg::kAltVertical;
using mpeg::hpel;
using mpeg::Plane;
using mpeg::kZigzag;
using mpeg::Vlc;

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

// MPEG-4's default quantisation matrices, natural order.
const uint8_t kDefaultIntra[64] = {
    8,  17, 18, 19, 21, 23, 25, 27, 17, 18, 19, 21, 23, 25, 27, 28,
    20, 21, 22, 23, 24, 26, 28, 30, 21, 22, 23, 24, 26, 28, 30, 32,
    22, 23, 24, 26, 28, 30, 32, 35, 23, 24, 26, 28, 30, 32, 35, 38,
    25, 26, 28, 30, 32, 35, 38, 41, 27, 28, 30, 32, 35, 38, 41, 45};
const uint8_t kDefaultInter[64] = {
    16, 17, 18, 19, 20, 21, 22, 23, 17, 18, 19, 20, 21, 22, 23, 24,
    18, 19, 20, 21, 22, 23, 24, 25, 19, 20, 21, 22, 23, 24, 26, 27,
    20, 21, 22, 23, 25, 26, 27, 28, 21, 22, 23, 24, 26, 27, 28, 30,
    22, 23, 24, 26, 27, 28, 30, 31, 23, 24, 25, 27, 28, 30, 31, 33};
// (code, length): the sprite trajectory's dmv_length 0..14 (table B-33),
// B-VOP mb_type (direct, interpolate, backward, forward).
const uint16_t kSpriteTraj[15][2] = {
    {0x0, 2},   {0x2, 3},   {0x3, 3},    {0x4, 3},    {0x5, 3},
    {0x6, 3},   {0xE, 4},   {0x1E, 5},   {0x3E, 6},   {0x7E, 7},
    {0xFE, 8},  {0x1FE, 9}, {0x3FE, 10}, {0x7FE, 11}, {0xFFE, 12}};
const uint8_t kBType[4][2] = {{1, 1}, {1, 2}, {1, 3}, {1, 4}};
// ff_h263_round_chroma's table: a 4MV macroblock's chroma vector from
// the sum of its four luma vectors, + (sum >> 3).
const uint8_t kChromaRound[16] = {0, 0, 0, 1, 1, 1, 1, 1,
                                  0, 0, 0, 0, 0, 0, 1, 1};

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
const Vlc& sprite_traj_vlc() {
  static const Vlc v = make_vlc(kSpriteTraj, 12);
  return v;
}
const Vlc& b_type_vlc() {
  static const Vlc v = make_vlc(kBType, 4);
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

inline int clip(int v, int lo, int hi) { return v < lo ? lo : v > hi ? hi : v; }

inline uint8_t clip_u8(int v) {
  return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v);
}

// ffmpeg's ROUNDED_DIV and RSHIFT.
inline int rounded_div(int a, int b) {
  return (a > 0 ? a + (b >> 1) : a - (b >> 1)) / b;
}
inline int64_t rounded_div64(int64_t a, int64_t b) {
  return (a > 0 ? a + (b >> 1) : a - (b >> 1)) / b;
}
inline int rshift(int a, int b) {
  return a > 0 ? (a + ((1 << b) >> 1)) >> b : (a + ((1 << b) >> 1) - 1) >> b;
}

// Where the next start code (00 00 01 xx) begins at or after `p`; n if
// none.
size_t next_start(const uint8_t* d, size_t n, size_t p) {
  for (; p + 3 < n; ++p)
    if (d[p] == 0 && d[p + 1] == 0 && d[p + 2] == 1) return p;
  return n;
}

// libavcodec's bug workarounds that the decoder reproduces
// (workaround_bugs, derived from the stream's user data and tag).
enum Bug : unsigned {
  kBugQpelChroma = 1,       // FF_BUG_QPEL_CHROMA
  kBugQpelChroma2 = 2,      // FF_BUG_QPEL_CHROMA2
  kBugEdge = 4,             // FF_BUG_EDGE: edges at the picture's size
  kBugDcClip = 8            // FF_BUG_DC_CLIP: DC not clipped at 2047
};


// The (n + 1)² pixels at (sx, sy), edges replicated (emulated_edge_mc).
void fetch(const Plane& r, int sx, int sy, int n, uint8_t* o) {
  for (int y = 0; y <= n; ++y)
    for (int x = 0; x <= n; ++x) o[y * 17 + x] = uint8_t(r.at(sx + x, sy + y));
}

// MPEG-4's quarter-pel lowpass (qpeldsp.c): the half-sample between s[i]
// and s[i + 1] of n + 1 samples s[0..n] with stride st, mirrored past
// both ends; `no_rnd` rounds down.
inline int lowpass(const uint8_t* s, int st, int i, int n, int no_rnd) {
  auto at = [&](int k) {
    k = k < 0 ? -1 - k : k > n ? 2 * n + 1 - k : k;
    return int(s[k * st]);
  };
  int v = (at(i) + at(i + 1)) * 20 - (at(i - 1) + at(i + 2)) * 6 +
          (at(i - 2) + at(i + 3)) * 3 - (at(i - 3) + at(i + 4));
  return clip_u8((v + 16 - no_rnd) >> 5);
}

// Quarter-pel put (or average into dst) of an n x n block (8 or 16) read
// at integer (sx, sy) with quarter-pel phase dxy (x | y << 2): ffmpeg's
// qpel{8,16}_mcXY, which filter the (n + 1)² pixels of the block alone,
// horizontally, then vertically.
void qpel(const Plane& r, int sx, int sy, int dxy, int no_rnd, bool avg,
          uint8_t* dst, int ds, int n) {
  uint8_t full[17 * 17], hb[17 * 17];
  fetch(r, sx, sy, n, full);
  int fx = dxy & 3, fy = dxy >> 2;
  auto mean = [&](int a, int b) { return (a + b + 1 - no_rnd) >> 1; };
  int rows = fy ? n + 1 : n;
  for (int y = 0; y < rows; ++y)
    for (int x = 0; x < n; ++x) {
      const uint8_t* s = &full[y * 17];
      int v = fx == 0 ? s[x] : lowpass(s, 1, x, n, no_rnd);
      if (fx == 1) v = mean(s[x], v);
      if (fx == 3) v = mean(s[x + 1], v);
      hb[y * 17 + x] = uint8_t(v);
    }
  for (int y = 0; y < n; ++y)
    for (int x = 0; x < n; ++x) {
      int v = fy == 0 ? hb[y * 17 + x] : lowpass(&hb[x], 17, y, n, no_rnd);
      if (fy == 1) v = mean(hb[y * 17 + x], v);
      if (fy == 3) v = mean(hb[(y + 1) * 17 + x], v);
      uint8_t& d = dst[size_t(y) * ds + x];
      d = uint8_t(avg ? (d + v + 1) >> 1 : v);
    }
}

// ff_gmc_c: 8 columns by h rows of a warp from (ox, oy) in 1/2^16 of
// 1/2^shift pel, stepping (dxx, dyx) a column and (dxy, dyy) a row,
// bilinear with rounder r; rows and columns outside (w, h) clamp.
void gmc(const Plane& r, uint8_t* dst, int ds, int h, int ox, int oy,
         int dxx, int dxy, int dyx, int dyy, int shift, int rnd) {
  const int s = 1 << shift, w1 = r.w - 1, h1 = r.h - 1;
  for (int y = 0; y < h; ++y) {
    int vx = ox, vy = oy;
    for (int x = 0; x < 8; ++x) {
      int src_x = vx >> 16, src_y = vy >> 16;
      int fx = src_x & (s - 1), fy = src_y & (s - 1);
      src_x >>= shift;
      src_y >>= shift;
      auto px = [&](int xx, int yy) {
        return int(r.p[size_t(yy) * r.stride + xx]);
      };
      int v;
      if (unsigned(src_x) < unsigned(w1)) {
        if (unsigned(src_y) < unsigned(h1)) {
          v = ((px(src_x, src_y) * (s - fx) + px(src_x + 1, src_y) * fx) *
                   (s - fy) +
               (px(src_x, src_y + 1) * (s - fx) +
                px(src_x + 1, src_y + 1) * fx) * fy + rnd) >> (2 * shift);
        } else {
          int yy = clip(src_y, 0, h1);
          v = ((px(src_x, yy) * (s - fx) + px(src_x + 1, yy) * fx) * s +
               rnd) >> (2 * shift);
        }
      } else {
        int xx = clip(src_x, 0, w1);
        if (unsigned(src_y) < unsigned(h1)) {
          v = ((px(xx, src_y) * (s - fy) + px(xx, src_y + 1) * fy) * s +
               rnd) >> (2 * shift);
        } else {
          v = px(xx, clip(src_y, 0, h1));
        }
      }
      dst[size_t(y) * ds + x] = uint8_t(v);
      vx += dxx;
      vy += dyx;
    }
    ox += dxy;
    oy += dyy;
  }
}

// gmc1_c: 8 columns by h rows at 1/16-pel phase (x16, y16) from the
// (9 x h + 1) pixels at `src` (stride 17).
void gmc1(const uint8_t* src, uint8_t* dst, int ds, int h, int x16, int y16,
          int rnd) {
  const int a = (16 - x16) * (16 - y16), b = x16 * (16 - y16),
            c = (16 - x16) * y16, d = x16 * y16;
  for (int y = 0; y < h; ++y)
    for (int x = 0; x < 8; ++x) {
      const uint8_t* s = &src[y * 17 + x];
      dst[size_t(y) * ds + x] =
          uint8_t((a * s[0] + b * s[1] + c * s[17] + d * s[18] + rnd) >> 8);
    }
}

// A decoded VOP: its planes (the coded size, strides cw and cw / 2) and
// what a later B-VOP reads of it.
struct Pic {
  std::vector<uint8_t> y, u, v;
  std::vector<int16_t> mv;     // (2·mbh, 2·mbw, 2) each 8x8 block's vector
  std::vector<uint8_t> mb;     // per macroblock: kSkipped | k8x8
  int64_t source = 0;          // the decode call that gave it
};
constexpr uint8_t kSkipped = 1, k8x8 = 2;

}  // namespace

struct Mpeg4Decoder::State {
  std::string tag;
  bool have_vol = false;
  int width = 0, height = 0, mbw = 0, mbh = 0;
  int time_bits = 1, time_res = 1;
  // The VOL's fixed_vop_time_increment (libavcodec's framerate.den: 1
  // without fixed_vop_rate).
  int time_inc = 1;
  int vo_type = 0;
  bool vol_control = false, low_delay = false;
  int sprite_usage = 0, warp_points = 0, warp_accuracy = 0;
  bool mpeg_quant = false, quarter = false, resync = false;
  bool partitioned = false;
  int intra_matrix[64], inter_matrix[64];
  // User data: the builds libavcodec reads (−1: none), and what it derives.
  int xvid_build = -1, divx_version = -1, divx_build = -1, lavc_build = -1;
  bool divx_packed = false;
  unsigned bugs = 0;
  bool xvid_idct = false;
  int picture_number = 0;
  // VOP times (ffmpeg's time_base, last_time_base, last_non_b_time).
  int64_t time_base = 0, last_time_base = 0, time = 0, last_non_b = 0;
  int pp_time = 0, pb_time = 0;
  // VOP
  int type = 0, qscale = 1, no_rounding = 0, fcode = 1, bcode = 1;
  int dc_threshold = 99;
  // GMC (mpeg4_decode_sprite_trajectory)
  int sprite_offset[2][2] = {}, sprite_delta[2][2] = {}, sprite_shift[2] = {};
  int real_warp_points = 0;
  // Pictures: the one being decoded, the older (forward) and newer
  // (backward) references, as ffmpeg's current, last and next.
  Pic cur, last, next;
  bool have_last = false, have_next = false;
  // Per VOP: intra DC levels · scale (1024 where not intra) and AC
  // predictors (16 a block: left column 1..7, top row 9..15), luma by
  // 8x8 block (2·mbh, 2·mbw), then Cb and Cr by macroblock (mbh, mbw);
  // each macroblock's quantiser.
  std::vector<int> dc;
  std::vector<int16_t> ac;
  std::vector<uint8_t> qs;
  // The macroblock being decoded: its vectors (direction, block, x/y).
  int mv[2][4][2] = {};
  int last_mv[2][2] = {};          // B-VOP predictors, forward, backward
  // The video packet: its first macroblock, and whether the macroblock
  // is in its first row (ffmpeg's resync_mb_x/y, first_slice_line).
  int rx = 0, ry = 0;
  bool first_line = true;
  bool ac_pred = false;
  // Packed bitstreams: the VOP that followed a decoded one in its packet.
  std::vector<uint8_t> held;
  int64_t calls = 0;
  bool saw_b = false;
  bool skipped_b = false;          // this packet's B-VOP had no reference
  bool flushed = false;

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

  void read_matrix(Bits& b, int* m) {
    int last = 0, i = 0;
    for (; i < 64; ++i) {
      int v = int(b.get(8));
      if (v == 0) break;
      last = v;
      m[kZigzag[i]] = v;
    }
    for (; i < 64; ++i) m[kZigzag[i]] = last;
  }

  void parse_vol(Bits& b) {
    b.skip(1);                                // random_accessible_vol
    vo_type = int(b.get(8));
    if (vo_type == 0x12) no("fine granularity scalability");
    int verid = 1;
    if (b.get1()) {
      verid = int(b.get(4));
      b.skip(3);
    }
    if (b.get(4) == 15) b.skip(16);           // extended PAR
    vol_control = b.get1();
    if (vol_control) {
      if (b.get(2) != 1) no("chroma format other than 4:2:0");
      low_delay = b.get1();
      if (b.get1()) b.skip(79);               // vbv parameters
    } else if (picture_number == 0) {
      low_delay = vo_type == 1 || vo_type == 17;   // simple, advanced simple
    }
    int shape = int(b.get(2));
    if (shape != 0) no("arbitrary (non-rectangular) shape");
    b.skip(1);
    int res = int(b.get(16));
    if (res == 0) bad("VOL with a time increment resolution of 0");
    time_res = res;
    b.skip(1);
    int bits = 0;
    while ((1 << bits) < res) ++bits;         // av_log2(res − 1) + 1
    time_bits = std::max(bits, 1);
    time_inc = b.get1() ? int(b.get(time_bits)) : 1;   // fixed_vop_rate
    b.skip(1);
    width = int(b.get(13));
    b.skip(1);
    height = int(b.get(13));
    b.skip(1);
    if (b.get1()) no("interlace");
    if (!b.get1()) no("OBMC");
    sprite_usage = int(b.get(verid == 1 ? 1 : 2));
    if (sprite_usage == 1) no("static sprites");
    if (sprite_usage == 2) {
      warp_points = int(b.get(6));
      if (warp_points > 3) bad("more than 3 sprite warping points");
      warp_accuracy = int(b.get(2));
      if (b.get1()) no("GMC with sprite brightness change");
    }
    if (b.get1()) no("bit depths other than 8 (not_8_bit)");
    mpeg_quant = b.get1();
    if (mpeg_quant) {
      for (int i = 0; i < 64; ++i) {
        intra_matrix[i] = kDefaultIntra[i];
        inter_matrix[i] = kDefaultInter[i];
      }
      if (b.get1()) read_matrix(b, intra_matrix);
      if (b.get1()) read_matrix(b, inter_matrix);
    }
    quarter = verid != 1 && b.get1();
    if (!b.get1()) no("complexity estimation headers");
    resync = !b.get1();                       // video packets
    partitioned = b.get1();
    if (partitioned && b.get1()) no("data partitioning with RVLC");
    if (verid != 1) {
      if (b.get1()) no("newpred");
      if (b.get1()) no("reduced resolution VOPs");
    }
    if (b.get1()) no("scalability");
    if (width < 1 || height < 1 || width > 8192 || height > 8192)
      bad("VOL size out of range");
    // A repeated VOL keeps the references; another size drops them.
    if (!have_vol || (width + 15) / 16 != mbw || (height + 15) / 16 != mbh)
      have_last = have_next = false;
    mbw = (width + 15) / 16;
    mbh = (height + 15) / 16;
    have_vol = true;
  }

  // decode_user_data: the encoder's build.
  void parse_user_data(const uint8_t* d, size_t n) {
    std::string s(reinterpret_cast<const char*>(d), n);
    s = s.substr(0, s.find('\0'));
    int ver = 0, build = 0, v2 = 0, v3 = 0;
    char last = 0;
    int e = std::sscanf(s.c_str(), "DivX%dBuild%d%c", &ver, &build, &last);
    if (e < 2) e = std::sscanf(s.c_str(), "DivX%db%d%c", &ver, &build, &last);
    if (e >= 2) {
      divx_version = ver;
      divx_build = build;
      divx_packed = e == 3 && last == 'p';
    }
    e = std::sscanf(s.c_str(), "FFmpe%*[^b]b%d", &build) + 3;
    if (e != 4)
      e = std::sscanf(s.c_str(), "FFmpeg v%d.%d.%d / libavcodec build: %d",
                      &ver, &v2, &v3, &build);
    if (e != 4) {
      e = std::sscanf(s.c_str(), "Lavc%d.%d.%d", &ver, &v2, &v3) + 1;
      if (e > 1) build = (ver << 16) + (v2 << 8) + v3;
    }
    if (e != 4 && s == "ffmpeg") {
      lavc_build = 4600;
    } else if (e == 4) {
      lavc_build = build;
    }
    if (std::sscanf(s.c_str(), "XviD%d", &build) == 1) xvid_build = build;
  }

  // ff_mpeg4_workaround_bugs, for what the decoder reproduces; raises
  // for the rest.
  void workarounds() {
    auto is = [&](const char* t) { return tag == t; };
    if (xvid_build == -1 && divx_version == -1 && lavc_build == -1 &&
        (is("XVID") || is("XVIX") || is("RMP4") || is("ZMP4") || is("SIPP")))
      xvid_build = 0;
    if (xvid_build == -1 && divx_version == -1 && lavc_build == -1 &&
        is("DIVX") && vo_type == 0 && !vol_control)
      divx_version = 400;
    if (xvid_build >= 0 && divx_version >= 0) divx_version = divx_build = -1;
    if (is("UMP4")) no("UMP4 streams (decoded with bug workarounds)");
    if (is("GEOV"))
      no("GEOV streams (libavcodec hands their pictures over bottom-up)");
    unsigned xb = unsigned(xvid_build), lb = unsigned(lavc_build);
    unsigned dv = unsigned(divx_version);
    bugs = 0;
    if (divx_version >= 500 && divx_build < 1814) bugs |= kBugQpelChroma;
    if (divx_version > 502 && divx_build < 1814) bugs |= kBugQpelChroma2;
    if (xb <= 1) bugs |= kBugQpelChroma;
    if (xb <= 12) bugs |= kBugEdge;
    if (xb <= 32) bugs |= kBugDcClip;
    if (lb < 4714)
      no("an old libavcodec's stream (decoded with bug workarounds)");
    if ((lb & 0xFF) >= 100 && lb > 3621476 && lb < 3752552 &&
        (lb < 3752037 || lb > 3752191))
      no("a libavcodec 55/57 stream (decoded with the IEDGE workaround)");
    if (dv < 500) bugs |= kBugEdge;
    if (divx_version == 500 && divx_build == 413)
      no("DivX 5.00 build 413 GMC");
    if (xvid_build >= 0) xvid_idct = true;
  }

  // ---------------------------------------------------------- VOP header

  // mpeg4_decode_sprite_trajectory, then its reduction to one point.
  void sprite_trajectory(Bits& b) {
    const int a = 2 << warp_accuracy, rho = 3 - warp_accuracy, r = 16 / a;
    const int w = width, h = height;
    const int vop_ref[4][2] = {{0, 0}, {w, 0}, {0, h}, {w, h}};
    int d[4][2] = {};
    for (int i = 0; i < warp_points; ++i) {
      for (int k = 0; k < 2; ++k) {
        int len = sprite_traj_vlc().read(b);
        if (len < 0) bad("bad sprite trajectory code");
        d[i][k] = len ? b.xbits(len) : 0;
        b.skip(1);                            // marker
      }
    }
    int alpha = 1, beta = 0;
    while ((1 << alpha) < w) ++alpha;
    while ((1 << beta) < h) ++beta;
    const int w2 = 1 << alpha, h2 = 1 << beta;
    int64_t sref[3][2];
    for (int k = 0; k < 2; ++k) {
      sref[0][k] = (a >> 1) * (2 * vop_ref[0][k] + d[0][k]);
      sref[1][k] = (a >> 1) * (2 * vop_ref[1][k] + d[0][k] + d[1][k]);
      sref[2][k] = (a >> 1) * (2 * vop_ref[2][k] + d[0][k] + d[2][k]);
    }
    // virtual_ref: the warp at (w2, 0) and (0, h2), for shifts per pixel.
    auto rel = [&](int i, int k) {
      return r * sref[i][k] - 16 * vop_ref[i][k];
    };
    int64_t vref[2][2];
    vref[0][0] = 16 * (vop_ref[0][0] + w2) +
                 rounded_div64((w - w2) * rel(0, 0) + w2 * rel(1, 0), w);
    vref[0][1] = 16 * vop_ref[0][1] +
                 rounded_div64((w - w2) * rel(0, 1) + w2 * rel(1, 1), w);
    vref[1][0] = 16 * vop_ref[0][0] +
                 rounded_div64((h - h2) * rel(0, 0) + h2 * rel(2, 0), h);
    vref[1][1] = 16 * (vop_ref[0][1] + h2) +
                 rounded_div64((h - h2) * rel(0, 1) + h2 * rel(2, 1), h);
    int64_t off[2][2], del[2][2];
    int shift[2];
    switch (warp_points) {
      case 0:
        off[0][0] = off[0][1] = off[1][0] = off[1][1] = 0;
        del[0][0] = a;
        del[0][1] = del[1][0] = 0;
        del[1][1] = a;
        shift[0] = shift[1] = 0;
        break;
      case 1:
        off[0][0] = sref[0][0] - a * vop_ref[0][0];
        off[0][1] = sref[0][1] - a * vop_ref[0][1];
        off[1][0] = ((sref[0][0] >> 1) | (sref[0][0] & 1)) -
                    a * (vop_ref[0][0] / 2);
        off[1][1] = ((sref[0][1] >> 1) | (sref[0][1] & 1)) -
                    a * (vop_ref[0][1] / 2);
        del[0][0] = a;
        del[0][1] = del[1][0] = 0;
        del[1][1] = a;
        shift[0] = shift[1] = 0;
        break;
      case 2:
        off[0][0] = sref[0][0] * (int64_t(1) << (alpha + rho)) +
                    (-r * sref[0][0] + vref[0][0]) * (-vop_ref[0][0]) +
                    (r * sref[0][1] - vref[0][1]) * (-vop_ref[0][1]) +
                    (int64_t(1) << (alpha + rho - 1));
        off[0][1] = sref[0][1] * (int64_t(1) << (alpha + rho)) +
                    (-r * sref[0][1] + vref[0][1]) * (-vop_ref[0][0]) +
                    (-r * sref[0][0] + vref[0][0]) * (-vop_ref[0][1]) +
                    (int64_t(1) << (alpha + rho - 1));
        off[1][0] = (-r * sref[0][0] + vref[0][0]) * (-2 * vop_ref[0][0] + 1) +
                    (r * sref[0][1] - vref[0][1]) * (-2 * vop_ref[0][1] + 1) +
                    2 * w2 * r * sref[0][0] - 16 * w2 +
                    (int64_t(1) << (alpha + rho + 1));
        off[1][1] = (-r * sref[0][1] + vref[0][1]) * (-2 * vop_ref[0][0] + 1) +
                    (-r * sref[0][0] + vref[0][0]) * (-2 * vop_ref[0][1] + 1) +
                    2 * w2 * r * sref[0][1] - 16 * w2 +
                    (int64_t(1) << (alpha + rho + 1));
        del[0][0] = -r * sref[0][0] + vref[0][0];
        del[0][1] = r * sref[0][1] - vref[0][1];
        del[1][0] = -r * sref[0][1] + vref[0][1];
        del[1][1] = -r * sref[0][0] + vref[0][0];
        shift[0] = alpha + rho;
        shift[1] = alpha + rho + 2;
        break;
      default: {
        int min_ab = std::min(alpha, beta);
        int64_t w3 = w2 >> min_ab, h3 = h2 >> min_ab;
        int sh = alpha + beta + rho - min_ab;
        // The warp's steps along x and y, component k.
        auto gx = [&](int k) { return (-r * sref[0][k] + vref[0][k]) * h3; };
        auto gy = [&](int k) { return (-r * sref[0][k] + vref[1][k]) * w3; };
        for (int k = 0; k < 2; ++k) {
          off[0][k] = sref[0][k] * (int64_t(1) << sh) +
                      gx(k) * -vop_ref[0][0] + gy(k) * -vop_ref[0][1] +
                      (int64_t(1) << (sh - 1));
          off[1][k] = gx(k) * (-2 * vop_ref[0][0] + 1) +
                      gy(k) * (-2 * vop_ref[0][1] + 1) +
                      2 * w2 * h3 * r * sref[0][k] - 16 * w2 * h3 +
                      (int64_t(1) << (sh + 1));
          del[k][0] = gx(k);
          del[k][1] = gy(k);
        }
        shift[0] = sh;
        shift[1] = sh + 2;
      }
    }
    if (del[0][0] == int64_t(a) << shift[0] && del[0][1] == 0 &&
        del[1][0] == 0 && del[1][1] == int64_t(a) << shift[0]) {
      off[0][0] >>= shift[0];
      off[0][1] >>= shift[0];
      off[1][0] >>= shift[1];
      off[1][1] >>= shift[1];
      del[0][0] = a;
      del[0][1] = del[1][0] = 0;
      del[1][1] = a;
      shift[0] = shift[1] = 0;
      real_warp_points = 1;
    } else {
      int sy = 16 - shift[0], sc = 16 - shift[1];
      const int64_t big = 0x7FFFFFFF;
      for (int i = 0; i < 2; ++i)
        if (sc < 0 || sy < 0 || std::llabs(off[0][i]) >= big >> sy ||
            std::llabs(off[1][i]) >= big >> sc ||
            std::llabs(del[0][i]) >= big >> sy ||
            std::llabs(del[1][i]) >= big >> sy)
          no("a GMC warp too large for libavcodec's arithmetic");
      for (int i = 0; i < 2; ++i) {
        off[0][i] *= int64_t(1) << sy;
        off[1][i] *= int64_t(1) << sc;
        del[0][i] *= int64_t(1) << sy;
        del[1][i] *= int64_t(1) << sy;
        shift[i] = 16;
      }
      real_warp_points = warp_points;
    }
    for (int i = 0; i < 2; ++i)
      for (int k = 0; k < 2; ++k) {
        sprite_offset[i][k] = int(off[i][k]);
        sprite_delta[i][k] = int(del[i][k]);
      }
    sprite_shift[0] = shift[0];
    sprite_shift[1] = shift[1];
  }

  // decode_vop_header → the VOP kind (0 I, 1 P, 2 B, 3 S), −1 when it
  // gives no picture (not coded, or a B-VOP out of order). Times are
  // kept; with `full`, the rest of the header is read too.
  int vop_header(Bits& b, bool full) {
    if (!have_vol) bad("VOP before its VOL header");
    int t = int(b.get(2));
    if (t == 2) saw_b = true;
    if (t == 2 && low_delay && !vol_control) low_delay = false;
    int incr = 0;
    while (b.get1()) {                        // modulo_time_base
      ++incr;
      if (b.over()) bad("VOP header cut short");
    }
    b.skip(1);
    int inc = int(b.get(time_bits));
    b.skip(1);
    if (!full) return b.get1() ? t : -1;
    if (t != 2) {
      last_time_base = time_base;
      time_base += incr;
      time = time_base * time_res + inc;
      pp_time = int(time - last_non_b);
      last_non_b = time;
    } else {
      time = (last_time_base + incr) * time_res + inc;
      pb_time = int(pp_time - (last_non_b - time));
      if (pp_time <= pb_time || pp_time <= pp_time - pb_time || pp_time <= 0)
        return -1;                            // out of order: skipped
    }
    if (!b.get1()) return -1;                 // vop_coded
    if (t == 3 && sprite_usage != 2) no("S-VOPs without GMC (sprites)");
    type = t;
    no_rounding = t == 1 || t == 3 ? b.get1() : 0;
    dc_threshold = kDcThr[b.get(3)];
    if (t == 3) sprite_trajectory(b);
    qscale = int(b.get(5));
    if (qscale == 0) bad("VOP quantiser 0");
    fcode = bcode = 1;
    if (t != 0) {
      fcode = int(b.get(3));
      if (fcode == 0) bad("VOP f_code 0");
    }
    if (t == 2) {
      bcode = int(b.get(3));
      if (bcode == 0) bad("VOP b_code 0");
    }
    if (vo_type == 0 && !vol_control && divx_version == -1 &&
        picture_number == 0)
      low_delay = true;
    ++picture_number;
    return t;
  }
  static constexpr int kDcThr[8] = {99, 13, 15, 17, 19, 21, 23, 0};

  // ---------------------------------------------------------- blocks

  int* dc_plane(int n) {
    return n < 4 ? &dc[0]
                 : &dc[size_t(4 * mbw * mbh) + size_t(n - 4) * mbw * mbh];
  }
  int16_t* ac_plane(int n) {
    return n < 4 ? &ac[0]
                 : &ac[16 * (size_t(4 * mbw * mbh) +
                             size_t(n - 4) * mbw * mbh)];
  }
  // Block n's (x, y) and row width in its plane's grid.
  void grid(int mx, int my, int n, int& bx, int& by, int& w) const {
    if (n < 4) {
      bx = 2 * mx + (n & 1);
      by = 2 * my + (n >> 1);
      w = 2 * mbw;
    } else {
      bx = mx;
      by = my;
      w = mbw;
    }
  }

  // ff_mpeg4_pred_dc: block n's DC predictor (stored DC level·scale) and
  // its direction (0 left, 1 above).
  int dc_pred(int mx, int my, int n, int scale, int& dir) {
    int bx, by, w;
    grid(mx, my, n, bx, by, w);
    const int* plane = dc_plane(n);
    auto val = [&](int x, int y) {
      return x < 0 || y < 0 ? 1024 : plane[size_t(y) * w + x];
    };
    int a = val(bx - 1, by), b = val(bx - 1, by - 1), c = val(bx, by - 1);
    // Neighbours in an earlier video packet.
    if (first_line && n != 3) {
      if (n != 2) b = c = 1024;
      if (n != 1 && mx == rx) b = a = 1024;
    }
    if (mx == rx && my == ry + 1 && (n == 0 || n == 4 || n == 5)) b = 1024;
    int pred;
    if (std::abs(a - b) < std::abs(b - c)) {
      pred = c;
      dir = 1;
    } else {
      pred = a;
      dir = 0;
    }
    return (pred + (scale >> 1)) / scale;
  }

  void dc_store(int mx, int my, int n, int level) {
    int bx, by, w;
    grid(mx, my, n, bx, by, w);
    if (level & ~2047) {
      if (level < 0) level = 0;
      else if (!(bugs & kBugDcClip)) level = 2047;
    }
    dc_plane(n)[size_t(by) * w + bx] = level;
  }

  // ff_mpeg4_pred_ac: add the left column or top row of the neighbour in
  // `dir` (rescaled to this quantiser), then keep this block's.
  void ac_predict(int16_t* blk, int mx, int my, int n, int dir) {
    int bx, by, w;
    grid(mx, my, n, bx, by, w);
    int16_t* plane = ac_plane(n);
    int16_t* self = &plane[16 * (size_t(by) * w + bx)];
    if (ac_pred) {
      if (dir == 0) {
        if (bx > 0) {
          const int16_t* l = self - 16;
          int q = qs[size_t(my) * mbw + mx - (mx > 0)];
          bool same = mx == 0 || qscale == q || n == 1 || n == 3;
          for (int i = 1; i < 8; ++i)
            blk[i << 3] = int16_t(
                blk[i << 3] + (same ? l[i] : rounded_div(l[i] * q, qscale)));
        }
      } else if (by > 0) {
        const int16_t* t = self - 16 * size_t(w);
        int q = my > 0 ? qs[size_t(my - 1) * mbw + mx] : qscale;
        bool same = my == 0 || qscale == q || n == 2 || n == 3;
        for (int i = 1; i < 8; ++i)
          blk[i] = int16_t(
              blk[i] + (same ? t[i + 8] : rounded_div(t[i + 8] * q, qscale)));
      }
    }
    for (int i = 1; i < 8; ++i) {
      self[i] = blk[i << 3];
      self[8 + i] = blk[i];
    }
  }

  // mpeg4_decode_dc: block n's DC level, its predictor plus the coded
  // difference, stored; `dir` the prediction's direction.
  int read_dc(Bits& b, int mx, int my, int n, int& dir) {
    int scale = n < 4 ? y_dc_scale(qscale) : c_dc_scale(qscale);
    int size = (n < 4 ? dc_luma_vlc() : dc_chroma_vlc()).read(b);
    if (size < 0 || size > 9) bad("bad intra DC size code");
    int diff = 0;
    if (size) {
      diff = b.xbits(size);
      if (size > 8) b.skip(1);
    }
    int level = dc_pred(mx, my, n, scale, dir) + diff;
    dc_store(mx, my, n, level * scale);
    return level;
  }

  // Where an intra block's DC comes from: its coefficients (the
  // quantiser at the intra DC VLC threshold or above), its own VLC, or a
  // data partition already read (kept as level · scale).
  enum { kDcInTexture, kDcVlc, kDcRead };

  // One block's coefficients (natural order) into blk: intra blocks get
  // their DC and AC predicted and are dequantized here; inter levels are
  // dequantized (H.263) as read, or left for MPEG quantisation. `pdir`:
  // the DC prediction's direction of a kDcRead block.
  void block(Bits& b, int16_t* blk, int mx, int my, int n, bool intra,
             bool coded, int dc_mode, int pdir = 0) {
    std::memset(blk, 0, 64 * sizeof(int16_t));
    int q = qscale;
    int i;
    int dir = 0, scale = n < 4 ? y_dc_scale(q) : c_dc_scale(q);
    if (intra) {
      if (dc_mode == kDcVlc) {
        blk[0] = int16_t(read_dc(b, mx, my, n, dir));
        i = 0;
      } else if (dc_mode == kDcRead) {
        int bx, by, w;
        grid(mx, my, n, bx, by, w);
        blk[0] = int16_t((dc_plane(n)[size_t(by) * w + bx] + (scale >> 1)) /
                         scale);
        dir = pdir;
        i = 0;
      } else {
        dc_pred(mx, my, n, scale, dir);
        i = -1;
      }
    } else {
      i = -1;
    }
    const uint8_t* scan = intra && ac_pred
                              ? (dir == 0 ? kAltVertical : kAltHorizontal)
                              : kZigzag;
    const Rl& rl = intra ? intra_rl() : inter_rl();
    bool raw = intra || mpeg_quant;
    int qmul = raw ? 1 : 2 * q, qadd = raw ? 0 : (q - 1) | 1;
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
        blk[scan[i]] = int16_t(level);
        if (last) break;
        if (b.over()) bad("macroblock data cut short");
      }
    }
    if (!intra) return;
    if (dc_mode == kDcInTexture) {
      int level = dc_pred(mx, my, n, scale, dir) + blk[0];
      dc_store(mx, my, n, level * scale);
      blk[0] = int16_t(level);
    }
    ac_predict(blk, mx, my, n, dir);
    blk[0] = int16_t(blk[0] * scale);
    if (mpeg_quant) {                         // dct_unquantize_mpeg2_intra
      int q2 = 2 * q;
      for (int k = 1; k < 64; ++k) {
        int l = blk[k];
        if (!l) continue;
        int v = (std::abs(l) * q2 * intra_matrix[k]) >> 4;
        blk[k] = int16_t(l < 0 ? -v : v);
      }
    } else {                                  // dct_unquantize_h263_intra
      int qm = 2 * q, qa = (q - 1) | 1;
      for (int k = 1; k < 64; ++k) {
        int l = blk[k];
        if (l) blk[k] = int16_t(l < 0 ? l * qm - qa : l * qm + qa);
      }
    }
  }

  // dct_unquantize_mpeg2_inter with MPEG-4's mismatch control.
  void unquant_inter(int16_t* blk) {
    int q2 = 2 * qscale, sum = -1;
    for (int k = 0; k < 64; ++k) {
      int l = blk[k];
      if (!l) continue;
      int v = ((2 * std::abs(l) + 1) * q2 * inter_matrix[k]) >> 5;
      v = l < 0 ? -v : v;
      blk[k] = int16_t(v);
      sum += v;
    }
    blk[63] = int16_t(blk[63] ^ (sum & 1));
  }

  // ------------------------------------------------------ prediction

  // The edge references are read to (h_edge_pos, v_edge_pos): the
  // macroblock-rounded size, or the picture's with FF_BUG_EDGE.
  int edge_w() const { return bugs & kBugEdge ? width : mbw * 16; }
  int edge_h() const { return bugs & kBugEdge ? height : mbh * 16; }

  Plane plane(const Pic& p, int k) const {
    int cw = mbw * 16;
    if (k == 0) return Plane{p.y.data(), cw, edge_w(), edge_h()};
    return Plane{(k == 1 ? p.u : p.v).data(), cw / 2, edge_w() >> 1,
                 edge_h() >> 1};
  }

  uint8_t* dst(int k, int mx, int my) {
    int cw = mbw * 16;
    if (k == 0) return &cur.y[size_t(my) * 16 * cw + mx * 16];
    return &(k == 1 ? cur.u : cur.v)[size_t(my) * 8 * (cw / 2) + mx * 8];
  }

  // mpeg_motion (half-pel, H.263 chroma) or qpel_motion of one 16x16
  // vector.
  void motion16(const Pic& ref, int mx, int my, int vx, int vy, bool avg) {
    int cw = mbw * 16, cs = cw / 2;
    int rnd = avg ? 0 : no_rounding;
    int cx, cy, cdxy;
    if (quarter) {
      qpel(plane(ref, 0), mx * 16 + (vx >> 2), my * 16 + (vy >> 2),
           ((vy & 3) << 2) | (vx & 3), rnd, avg, dst(0, mx, my), cw, 16);
      int ux, uy;
      if (bugs & kBugQpelChroma2) {
        static const int rtab[8] = {0, 0, 1, 1, 0, 0, 0, 1};
        ux = (vx >> 1) + rtab[vx & 7];
        uy = (vy >> 1) + rtab[vy & 7];
      } else if (bugs & kBugQpelChroma) {
        ux = (vx >> 1) | (vx & 1);
        uy = (vy >> 1) | (vy & 1);
      } else {
        ux = vx / 2;
        uy = vy / 2;
      }
      ux = (ux >> 1) | (ux & 1);
      uy = (uy >> 1) | (uy & 1);
      cdxy = (ux & 1) | ((uy & 1) << 1);
      cx = mx * 8 + (ux >> 1);
      cy = my * 8 + (uy >> 1);
    } else {
      int dxy = ((vy & 1) << 1) | (vx & 1);
      int sx = mx * 16 + (vx >> 1), sy = my * 16 + (vy >> 1);
      hpel(plane(ref, 0), sx, sy, dxy, rnd, avg, dst(0, mx, my), cw, 16, 16);
      cdxy = dxy | (vy & 2) | ((vx & 2) >> 1);
      cx = sx >> 1;
      cy = sy >> 1;
    }
    hpel(plane(ref, 1), cx, cy, cdxy, rnd, avg, dst(1, mx, my), cs, 8, 8);
    hpel(plane(ref, 2), cx, cy, cdxy, rnd, avg, dst(2, mx, my), cs, 8, 8);
  }

  // apply_8x8: four 8x8 vectors, chroma from their sum (chroma_4mv_motion).
  void motion8(const Pic& ref, int mx, int my, const int (*v)[2], bool avg) {
    int cw = mbw * 16, cs = cw / 2;
    int rnd = avg ? 0 : no_rounding;
    int sumx = 0, sumy = 0;
    for (int i = 0; i < 4; ++i) {
      int vx = v[i][0], vy = v[i][1];
      uint8_t* d = dst(0, mx, my) + (i & 1) * 8 + (i >> 1) * 8 * cw;
      if (quarter) {
        int dxy = ((vy & 3) << 2) | (vx & 3);
        int sx = mx * 16 + (vx >> 2) + (i & 1) * 8;
        int sy = my * 16 + (vy >> 2) + (i >> 1) * 8;
        sx = clip(sx, -16, width);
        if (sx == width) dxy &= ~3;
        sy = clip(sy, -16, height);
        if (sy == height) dxy &= ~12;
        qpel(plane(ref, 0), sx, sy, dxy, rnd, avg, d, cw, 8);
        sumx += vx / 2;
        sumy += vy / 2;
      } else {
        int sx = mx * 16 + (i & 1) * 8 + (vx >> 1);
        int sy = my * 16 + (i >> 1) * 8 + (vy >> 1);
        int dxy = 0;
        sx = clip(sx, -16, width);
        if (sx != width) dxy |= vx & 1;
        sy = clip(sy, -16, height);
        if (sy != height) dxy |= (vy & 1) << 1;
        hpel(plane(ref, 0), sx, sy, dxy, rnd, avg, d, cw, 8, 8);
        sumx += vx;
        sumy += vy;
      }
    }
    int ux = kChromaRound[sumx & 15] + (sumx >> 3);
    int uy = kChromaRound[sumy & 15] + (sumy >> 3);
    int dxy = ((uy & 1) << 1) | (ux & 1);
    int sx = clip(mx * 8 + (ux >> 1), -8, width >> 1);
    if (sx == width >> 1) dxy &= ~1;
    int sy = clip(my * 8 + (uy >> 1), -8, height >> 1);
    if (sy == height >> 1) dxy &= ~2;
    hpel(plane(ref, 1), sx, sy, dxy, rnd, avg, dst(1, mx, my), cs, 8, 8);
    hpel(plane(ref, 2), sx, sy, dxy, rnd, avg, dst(2, mx, my), cs, 8, 8);
  }

  // gmc1_motion or gmc_motion: the macroblock by the VOP's warp.
  void motion_gmc(int mx, int my) {
    int cw = mbw * 16, cs = cw / 2;
    const int acc = warp_accuracy;
    if (real_warp_points == 1) {
      uint8_t buf[17 * 17];
      for (int c = 0; c < 2; ++c) {
        int n = c ? 8 : 16;
        int vx = sprite_offset[c][0], vy = sprite_offset[c][1];
        int sx = mx * n + (vx >> (acc + 1)), sy = my * n + (vy >> (acc + 1));
        vx *= 1 << (3 - acc);
        vy *= 1 << (3 - acc);
        int wl = c ? width >> 1 : width, hl = c ? height >> 1 : height;
        sx = clip(sx, -n, wl);
        if (sx == wl) vx = 0;
        sy = clip(sy, -n, hl);
        if (sy == hl) vy = 0;
        for (int k = c ? 1 : 0; k < (c ? 3 : 1); ++k) {
          Plane r = plane(last, k);
          fetch(r, sx, sy, n, buf);
          uint8_t* d = dst(k, mx, my);
          int ds = k ? cs : cw;
          if (k == 0 && !((vx | vy) & 7)) {
            int dxy = ((vx >> 3) & 1) | ((vy >> 2) & 2);
            hpel(Plane{buf, 17, 17, 17}, 0, 0, dxy, no_rounding, false, d,
                 ds, 16, 16);
          } else {
            for (int h = 0; h < n; h += 8)
              gmc1(buf + h, d + h, ds, n, vx & 15, vy & 15,
                   128 - no_rounding);
          }
        }
      }
      return;
    }
    const int rnd = (1 << (2 * acc + 1)) - no_rounding;
    const int(&d)[2][2] = sprite_delta;
    int ox = sprite_offset[0][0] + d[0][0] * mx * 16 + d[0][1] * my * 16;
    int oy = sprite_offset[0][1] + d[1][0] * mx * 16 + d[1][1] * my * 16;
    Plane y = plane(last, 0);
    gmc(y, dst(0, mx, my), cw, 16, ox, oy, d[0][0], d[0][1], d[1][0], d[1][1],
        acc + 1, rnd);
    gmc(y, dst(0, mx, my) + 8, cw, 16, ox + d[0][0] * 8, oy + d[1][0] * 8,
        d[0][0], d[0][1], d[1][0], d[1][1], acc + 1, rnd);
    ox = sprite_offset[1][0] + d[0][0] * mx * 8 + d[0][1] * my * 8;
    oy = sprite_offset[1][1] + d[1][0] * mx * 8 + d[1][1] * my * 8;
    for (int k = 1; k < 3; ++k) {
      Plane c = plane(last, k);
      c.w = (edge_w() + 1) >> 1;
      c.h = (edge_h() + 1) >> 1;
      gmc(c, dst(k, mx, my), cs, 8, ox, oy, d[0][0], d[0][1], d[1][0],
          d[1][1], acc + 1, rnd);
    }
  }

  // get_amv: a GMC macroblock's mean vector (for prediction and direct
  // mode), component n.
  int amv(int mx, int my, int n) {
    int len = 1 << (fcode + 4);
    const int a = warp_accuracy;
    int sum;
    if (real_warp_points == 1) {
      sum = rshift(sprite_offset[0][n] * (1 << int(quarter)), a);
    } else {
      int dx = sprite_delta[n][0], dy = sprite_delta[n][1];
      int shift = sprite_shift[0];
      if (n) dy -= 1 << (shift + a + 1);
      else dx -= 1 << (shift + a + 1);
      unsigned mb_v = unsigned(sprite_offset[0][n]) + unsigned(dx) * mx * 16u +
                      unsigned(dy) * my * 16u;
      sum = 0;
      for (int y = 0; y < 16; ++y) {
        unsigned v = mb_v + unsigned(dy) * y;
        for (int x = 0; x < 16; ++x) {
          sum += int(v) >> shift;
          v += unsigned(dx);
        }
      }
      sum = rshift(sum, a + 8 - int(quarter));
    }
    return sum < -len ? -len : sum >= len ? len - 1 : sum;
  }

  int motion(Bits& b, int pred, int f) {
    int code = mv_vlc().read(b);
    if (code < 0) bad("bad motion vector code");
    if (code == 0) return pred;
    int sign = b.get1();
    int shift = f - 1;
    int val = code;
    if (shift) {
      val = (val - 1) << shift;
      val |= int(b.get(shift));
      val++;
    }
    if (sign) val = -val;
    val += pred;
    int bits = 5 + f;                         // sign_extend(val, 5 + f)
    int m = 1 << (bits - 1);
    val = ((val + m) & ((1 << bits) - 1)) - m;
    return val;
  }

  // ff_h263_pred_motion of block n (0..3) of macroblock (mx, my) in this
  // VOP's block vectors (outside the picture: 0), with its rules for the
  // first row of a video packet.
  void mv_pred(int mx, int my, int n, int& px, int& py) {
    int16_t outside[2] = {0, 0};
    auto at = [&](int x, int y) -> int16_t* {
      if (x < 0 || y < 0 || x >= 2 * mbw) return outside;
      return &cur.mv[(size_t(y) * 2 * mbw + x) * 2];
    };
    int bx = 2 * mx + (n & 1), by = 2 * my + (n >> 1);
    static const int off[4] = {2, 1, 1, -1};
    int16_t* a = at(bx - 1, by);
    if (first_line && n < 3) {
      const int16_t* c = at(bx + off[n], by - 1);
      if (n == 0 && mx == rx) {
        px = py = 0;
      } else if (n < 2 && mx + 1 == rx) {
        px = n == 0 && mx == 0 ? c[0] : mid_pred(a[0], 0, c[0]);
        py = n == 0 && mx == 0 ? c[1] : mid_pred(a[1], 0, c[1]);
      } else if (n < 2) {
        px = a[0];
        py = a[1];
      } else {
        if (mx == rx) a[0] = a[1] = 0;       // as ffmpeg, in the array
        const int16_t* t = at(bx, by - 1);
        const int16_t* r = at(bx + 1, by - 1);
        px = mid_pred(a[0], t[0], r[0]);
        py = mid_pred(a[1], t[1], r[1]);
      }
      return;
    }
    const int16_t* t = at(bx, by - 1);
    const int16_t* c = at(bx + off[n], by - 1);
    px = mid_pred(a[0], t[0], c[0]);
    py = mid_pred(a[1], t[1], c[1]);
  }

  // ff_mpeg4_clean_buffers at a video packet from (mx, my): the AC
  // predictors around it are cleared.
  void clean_ac(int mx, int my) {
    auto zero = [&](int n, int y, int x0, int x1) {
      int bx, by, w;
      grid(0, 0, n, bx, by, w);
      int rows = n < 4 ? 2 * mbh : mbh;
      if (y < 0 || y >= rows) return;
      for (int x = std::max(x0, 0); x < std::min(x1, w); ++x)
        std::memset(&ac_plane(n)[16 * (size_t(y) * w + x)], 0,
                    16 * sizeof(int16_t));
    };
    zero(0, 2 * my - 1, 2 * mx - 1, 2 * mbw);
    zero(0, 2 * my, 0, 2 * mbw);
    zero(0, 2 * my + 1, 0, 2 * mx);
    for (int n = 4; n < 6; ++n) {
      zero(n, my - 1, mx - 1, mbw);
      zero(n, my, 0, mx);
    }
  }

  int prefix_len() const {
    return type == 0 ? 16 : type == 2 ? std::max({fcode, bcode, 2}) + 15
                                      : fcode + 15;
  }
  int mb_num_bits() const {
    int n = mbw * mbh - 1, bits = 0;
    while (n >> bits) ++bits;                // av_log2(mb_num − 1) + 1
    return std::max(bits, 1);
  }

  // mpeg4_is_resync: the first macroblock of a video packet whose
  // stuffing and resync marker begin at the current position, else −1.
  int resync_at(const Bits& b) const {
    static const uint16_t kPrefix[8] = {0x7F00, 0x7E00, 0x7C00, 0x7800,
                                        0x7000, 0x6000, 0x4000, 0x0000};
    if (b.left() < 8 + 16 || b.peek(16) != kPrefix[b.pos & 7]) return -1;
    Bits g = b;
    g.skip(1);
    g.pos = (g.pos + 7) & ~size_t(7);
    int len = 0;
    while (len < 32 && !g.get1()) ++len;
    int mb = int(g.get(mb_num_bits()));
    if (len < prefix_len() || mb == 0 || mb >= mbw * mbh) return -1;
    return mb;
  }

  // ff_mpeg4_decode_video_packet_header, at a resync marker.
  void video_packet(Bits& b, int mx, int my) {
    b.skip(1);
    b.pos = (b.pos + 7) & ~size_t(7);
    int len = 0;
    while (len < 32 && !b.get1()) ++len;
    if (len != prefix_len()) bad("video packet marker does not match f_code");
    b.skip(mb_num_bits());
    int q = int(b.get(5));
    if (q) qscale = q;
    if (b.get1()) {                          // header_extension_code
      while (b.get1()) {
        if (b.over()) bad("video packet header cut short");
      }
      b.skip(1 + time_bits + 1 + 2 + 3);
      if (type == 3) no("GMC video packets with a header extension");
      if (type != 0) b.skip(3);
      if (type == 2) b.skip(3);
    }
    rx = mx;
    ry = my;
    first_line = true;
    clean_ac(mx, my);
    std::memset(last_mv, 0, sizeof(last_mv));
  }

  void set_mv(int mx, int my, int n, int vx, int vy) {
    size_t at = (size_t(2 * my + (n >> 1)) * 2 * mbw + 2 * mx + (n & 1)) * 2;
    cur.mv[at] = int16_t(vx);
    cur.mv[at + 1] = int16_t(vy);
  }

  // ------------------------------------------------------ the VOP

  void put_blocks(int16_t (*blk)[64], int mx, int my, int cbp, bool intra) {
    int cw = mbw * 16, cs = cw / 2;
    auto put = xvid_idct ? xvid_idct_put : idct_put;
    auto add = xvid_idct ? xvid_idct_add : idct_add;
    for (int n = 0; n < 6; ++n) {
      uint8_t* d;
      int stride;
      if (n < 4) {
        d = dst(0, mx, my) + (n >> 1) * 8 * cw + (n & 1) * 8;
        stride = cw;
      } else {
        d = dst(n - 3, mx, my);
        stride = cs;
      }
      if (intra) {
        put(blk[n], d, stride);
      } else if (cbp & (32 >> n)) {
        if (mpeg_quant) unquant_inter(blk[n]);
        add(blk[n], d, stride);
      }
    }
  }

  // ff_mpeg4_set_direct_mv: the B macroblock's vectors from the backward
  // reference's co-located ones; true when 8x8.
  bool direct(int mx, int my, int dmx, int dmy) {
    bool eight = next.mb[size_t(my) * mbw + mx] & k8x8;
    int nb = eight ? 4 : 1;
    for (int i = 0; i < nb; ++i) {
      size_t at = (size_t(2 * my + (i >> 1)) * 2 * mbw + 2 * mx + (i & 1)) * 2;
      for (int k = 0; k < 2; ++k) {
        int p = next.mv[at + k], dm = k ? dmy : dmx;
        mv[0][i][k] = p * pb_time / pp_time + dm;
        mv[1][i][k] = dm ? mv[0][i][k] - p : p * (pb_time - pp_time) / pp_time;
      }
    }
    if (eight) return true;
    for (int i = 1; i < 4; ++i)
      for (int d = 0; d < 2; ++d)
        for (int k = 0; k < 2; ++k) mv[d][i][k] = mv[d][0][k];
    return quarter;
  }

  // One B-VOP macroblock: skipped when its co-located one in the backward
  // reference was, else direct, interpolated, backward or forward.
  void decode_b_mb(Bits& b, int mx, int my) {
    int16_t blk[6][64];
    if (mx == 0) std::memset(last_mv, 0, sizeof(last_mv));
    if (next.mb[size_t(my) * mbw + mx] & kSkipped) {
      motion16(last, mx, my, 0, 0, false);
      return;
    }
    int kind = 0, cbp = 0;                   // 0 direct, 1 interpolated,
    bool modb1 = b.get1();                   // 2 backward, 3 forward
    if (!modb1) {
      bool no_cbp = b.get1();
      kind = b_type_vlc().read(b);
      if (kind < 0) bad("bad B-VOP mb_type");
      if (!no_cbp) cbp = int(b.get(6));
      if (kind != 0 && cbp && b.get1())
        qscale = clip(qscale + int(b.get1()) * 4 - 2, 1, 31);
    }
    bool eight = false;
    bool fwd = kind != 2, bwd = kind != 3;
    if (kind == 0) {
      int dmx = 0, dmy = 0;
      if (!modb1) {
        dmx = motion(b, 0, 1);
        dmy = motion(b, 0, 1);
      }
      eight = direct(mx, my, dmx, dmy);
    } else {
      for (int d = 0; d < 2; ++d) {
        if (!(d ? bwd : fwd)) continue;
        int f = d ? bcode : fcode;
        int vx = motion(b, last_mv[d][0], f);
        int vy = motion(b, last_mv[d][1], f);
        last_mv[d][0] = mv[d][0][0] = vx;
        last_mv[d][1] = mv[d][0][1] = vy;
      }
    }
    for (int n = 0; n < 6; ++n)
      block(b, blk[n], mx, my, n, false, cbp & (32 >> n), kDcInTexture);
    bool avg = false;
    for (int d = 0; d < 2; ++d) {
      if (!(d ? bwd : fwd)) continue;
      const Pic& ref = d ? next : last;
      if (eight) motion8(ref, mx, my, mv[d], avg);
      else motion16(ref, mx, my, mv[d][0][0], mv[d][0][1], avg);
      avg = true;
    }
    put_blocks(blk, mx, my, cbp, false);
  }

  // A data-partitioned I- or P-VOP (ff_mpeg4_decode_partitions,
  // mpeg4_decode_partitioned_mb), video packet by video packet: the first
  // partition (MCBPC and the DCs of an I-VOP; a P-VOP's MCBPC and
  // vectors) to its marker, the second (AC prediction flags, CBPY, the
  // quantiser, a P-VOP's intra DCs), then each macroblock's texture.
  void decode_partitioned(Bits& b) {
    static const int kDquant[4] = {-1, -2, 1, 2};
    enum { kIntra = 1, kSkip = 2, kFour = 4, kAc = 8 };
    const int total = mbw * mbh;
    std::vector<uint8_t> kind(size_t(total), 0), cbps(size_t(total), 0),
        dirs(size_t(total), 0);
    int16_t blk[6][64];
    rx = ry = 0;
    auto cbpy_of = [&]() {
      int c = cbpy_vlc().read(b);
      if (c < 0) bad("bad CBPY code");
      return c;
    };
    auto dquant = [&]() {
      qscale = clip(qscale + kDquant[b.get(2)], 1, 31);
    };
    auto dcs = [&](int mx, int my) {
      int d = 0;
      for (int n = 0; n < 6; ++n) {
        int dir;
        read_dc(b, mx, my, n, dir);
        d = (d << 1) | dir;
      }
      return uint8_t(d);
    };
    for (int start = 0; start < total;) {
      if (start > 0) {
        if (resync_at(b) != start)
          bad("video packet does not start at the next macroblock");
        video_packet(b, start % mbw, start / mbw);
      }
      const int q0 = qscale;
      int k = start;
      first_line = true;
      for (; k < total; ++k) {                 // partition A
        int mx = k % mbw, my = k / mbw;
        if (mx == rx && my == ry + 1) first_line = false;
        if (type == 0) {
          if (b.peek(19) == 0x6B001) break;   // DC marker
          int c;
          do {
            c = intra_mcbpc_vlc().read(b);
            if (c < 0) bad("bad MCBPC code");
          } while (c == 8);
          kind[k] = kIntra;
          cbps[k] = uint8_t(c & 3);
          if (c & 4) dquant();
          qs[k] = uint8_t(qscale);
          dirs[k] = dcs(mx, my);
          continue;
        }
        if (b.peek(17) == 0x1F001) break;     // motion marker
        int c = 20;
        while (c == 20) {
          if (b.get1()) break;                // not coded
          c = inter_mcbpc_vlc().read(b);
          if (c < 0) bad("bad MCBPC code");
        }
        if (c == 20) {
          kind[k] = kSkip;
          continue;
        }
        cbps[k] = uint8_t(c & 11);
        if (c & 4) {
          kind[k] = kIntra;
          continue;
        }
        int px, py;
        if (c & 16) {
          kind[k] = kFour;
          for (int n = 0; n < 4; ++n) {
            mv_pred(mx, my, n, px, py);
            int vx = motion(b, px, fcode);
            set_mv(mx, my, n, vx, motion(b, py, fcode));
          }
        } else {
          mv_pred(mx, my, 0, px, py);
          int vx = motion(b, px, fcode), vy = motion(b, py, fcode);
          for (int n = 0; n < 4; ++n) set_mv(mx, my, n, vx, vy);
        }
      }
      const int end = k;
      if (end == start) bad("an empty data partition");
      if (type == 0) {
        while (b.peek(9) == 1) b.skip(9);
        if (b.get(19) != 0x6B001) bad("DC marker missing");
      } else {
        while (b.peek(10) == 1) b.skip(10);
        if (b.get(17) != 0x1F001) bad("motion marker missing");
      }
      first_line = true;
      for (k = start; k < end; ++k) {          // partition B
        int mx = k % mbw, my = k / mbw;
        if (mx == rx && my == ry + 1) first_line = false;
        if (type == 0 || (kind[k] & kIntra)) {
          if (b.get1()) kind[k] |= kAc;
          int cbpy = cbpy_of();
          if (type != 0) {
            if (cbps[k] & 8) dquant();
            qs[k] = uint8_t(qscale);
            dirs[k] = dcs(mx, my);
          }
          cbps[k] = uint8_t((cbps[k] & 3) | cbpy << 2);
        } else if (kind[k] & kSkip) {
          qs[k] = uint8_t(qscale);
          cbps[k] = 0;
        } else {
          int cbpy = cbpy_of() ^ 15;
          if (cbps[k] & 8) dquant();
          qs[k] = uint8_t(qscale);
          cbps[k] = uint8_t((cbps[k] & 3) | cbpy << 2);
        }
      }
      qscale = q0;
      first_line = true;
      for (k = start; k < end; ++k) {          // texture, reconstruction
        int mx = k % mbw, my = k / mbw;
        if (mx == rx && my == ry + 1) first_line = false;
        // libavcodec tests the threshold with the quantiser before this
        // macroblock's.
        bool dc_vlc = qscale < dc_threshold;
        qscale = qs[k];
        int cbp = cbps[k];
        if (kind[k] & kSkip) {
          cur.mb[size_t(k)] = kSkipped;
          motion16(last, mx, my, 0, 0, false);
          continue;
        }
        if (kind[k] & kIntra) {
          ac_pred = kind[k] & kAc;
          for (int n = 0; n < 6; ++n)
            block(b, blk[n], mx, my, n, true, cbp & (32 >> n),
                  dc_vlc ? kDcRead : kDcInTexture, (dirs[k] >> (5 - n)) & 1);
          put_blocks(blk, mx, my, cbp, true);
          continue;
        }
        for (int n = 0; n < 6; ++n)
          block(b, blk[n], mx, my, n, false, cbp & (32 >> n), kDcInTexture);
        for (int n = 0; n < 4; ++n)
          for (int c = 0; c < 2; ++c)
            mv[0][n][c] = cur.mv[(size_t(2 * my + (n >> 1)) * 2 * mbw +
                                  2 * mx + (n & 1)) * 2 + c];
        if (kind[k] & kFour) {
          cur.mb[size_t(k)] = k8x8;
          motion8(last, mx, my, mv[0], false);
        } else {
          motion16(last, mx, my, mv[0][0][0], mv[0][0][1], false);
        }
        put_blocks(blk, mx, my, cbp, false);
      }
      start = end;
    }
  }

  void decode_vop(Bits& b) {
    int cw = mbw * 16, ch = mbh * 16;
    if (type != 0 && type != 2 && !have_next)
      bad("P-VOP without a reference picture");
    cur.y.assign(size_t(cw) * ch, 0);
    cur.u.assign(size_t(cw / 2) * (ch / 2), 0);
    cur.v.assign(size_t(cw / 2) * (ch / 2), 0);
    cur.mv.assign(size_t(8) * mbw * mbh, 0);
    cur.mb.assign(size_t(mbw) * mbh, 0);
    dc.assign(size_t(6) * mbw * mbh, 1024);
    ac.assign(size_t(16 * 6) * mbw * mbh, 0);
    qs.assign(size_t(mbw) * mbh, uint8_t(qscale));
    if (type != 2) {
      // ff_mpv_frame_start: the newer reference becomes the older.
      std::swap(last, next);
      have_last = have_next;
    }
    if (partitioned && type != 2) {
      if (type == 3) no("GMC with data partitioning");
      decode_partitioned(b);
      cur.source = calls - 1;
      std::swap(next, cur);
      have_next = true;
      return;
    }
    static const int kDquant[4] = {-1, -2, 1, 2};
    int16_t blk[6][64];
    rx = ry = 0;
    first_line = true;
    for (int my = 0; my < mbh; ++my)
      for (int mx = 0; mx < mbw; ++mx) {
        if (b.over()) bad("VOP data cut short");
        int at = my * mbw + mx;
        if (resync && at > 0) {
          int mb = resync_at(b);
          if (mb == at) {
            video_packet(b, mx, my);
          } else if (mb > at &&
                     !(type == 2 && (next.mb[size_t(at)] & kSkipped))) {
            bad("video packet does not start at the next macroblock");
          }
        }
        if (mx == rx && my == ry + 1) first_line = false;
        if (type == 2) {
          decode_b_mb(b, mx, my);
          qs[size_t(my) * mbw + mx] = uint8_t(qscale);
          continue;
        }
        bool intra, mcsel = false;
        int cbpc, mbtype;
        if (type != 0) {
          if (b.get1()) {                       // not coded
            if (type == 3) {
              int vx = amv(mx, my, 0), vy = amv(mx, my, 1);
              for (int n = 0; n < 4; ++n) set_mv(mx, my, n, vx, vy);
              motion_gmc(mx, my);
            } else {
              cur.mb[size_t(my) * mbw + mx] = kSkipped;
              motion16(last, mx, my, 0, 0, false);
            }
            qs[size_t(my) * mbw + mx] = uint8_t(qscale);
            continue;
          }
          int c;
          do {
            c = inter_mcbpc_vlc().read(b);
            if (c < 0) bad("bad MCBPC code");
          } while (c == 20);
          mbtype = c >> 2;                      // 0 inter, 1 intra, 2 inter+Q,
          cbpc = c & 3;                         // 3 intra+Q, 4 inter4v
          intra = mbtype == 1 || mbtype == 3;
          if (type == 3 && !intra && mbtype != 4) mcsel = b.get1();
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
        ac_pred = intra && b.get1();
        int cbpy = cbpy_vlc().read(b);
        if (cbpy < 0) bad("bad CBPY code");
        if (!intra) cbpy ^= 15;
        int cbp = (cbpy << 2) | cbpc;
        bool dc_vlc = qscale < dc_threshold;
        if (dquant) qscale = clip(qscale + kDquant[b.get(2)], 1, 31);
        qs[size_t(my) * mbw + mx] = uint8_t(qscale);
        if (intra) {
          for (int n = 0; n < 6; ++n)
            block(b, blk[n], mx, my, n, true, cbp & (32 >> n),
                  dc_vlc ? kDcVlc : kDcInTexture);
          put_blocks(blk, mx, my, cbp, true);
          continue;
        }
        if (mcsel) {
          int vx = amv(mx, my, 0), vy = amv(mx, my, 1);
          for (int n = 0; n < 4; ++n) set_mv(mx, my, n, vx, vy);
        } else if (mbtype == 4) {
          cur.mb[size_t(my) * mbw + mx] = k8x8;
          for (int n = 0; n < 4; ++n) {
            int px, py;
            mv_pred(mx, my, n, px, py);
            mv[0][n][0] = motion(b, px, fcode);
            mv[0][n][1] = motion(b, py, fcode);
            set_mv(mx, my, n, mv[0][n][0], mv[0][n][1]);
          }
        } else {
          int px, py;
          mv_pred(mx, my, 0, px, py);
          int vx = motion(b, px, fcode);
          int vy = motion(b, py, fcode);
          mv[0][0][0] = vx;
          mv[0][0][1] = vy;
          for (int n = 0; n < 4; ++n) set_mv(mx, my, n, vx, vy);
        }
        for (int n = 0; n < 6; ++n)
          block(b, blk[n], mx, my, n, false, cbp & (32 >> n), kDcInTexture);
        if (mcsel) motion_gmc(mx, my);
        else if (mbtype == 4) motion8(last, mx, my, mv[0], false);
        else motion16(last, mx, my, mv[0][0][0], mv[0][0][1], false);
        put_blocks(blk, mx, my, cbp, false);
      }
    cur.source = calls - 1;
    if (type != 2) {
      std::swap(next, cur);
      have_next = true;
    }
  }

  void picture(const Pic& p, Picture& out) const {
    int cw = mbw * 16;
    out.w = width;
    out.h = height;
    out.ystride = cw;
    out.cstride = cw / 2;
    out.y = p.y;
    out.u = p.u;
    out.v = p.v;
    out.full_range = false;
    out.source = p.source;
  }

  // Decode the first VOP of one packet's bytes (`full`) or read its
  // headers; → its kind (−1 none). `second`: where a second VOP begins
  // (packed bitstreams), else n.
  int walk(const uint8_t* d, size_t n, bool full, Picture* out, bool& got,
           size_t& second) {
    size_t p = next_start(d, n, 0);
    int kind = -1;
    bool vop_seen = false;
    second = n;
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
        if (vop_seen) {
          // A second VOP (packed bitstreams): held by the caller.
          second = p;
          if (!full && p + 4 < n && d[p + 4] >> 6 == 2) saw_b = true;
          break;
        }
        vop_seen = true;
        Bits vb{d + p + 4, n - p - 4};
        workarounds();
        kind = vop_header(vb, full);
        if (kind >= 0 && full) decode_picture(vb, out, got);
        // The rest of the VOP's data may hold 00 00 01 only at its end.
        q = next_start(d, n, p + 4);
        while (q < n && d[q + 3] != 0xB6 && d[q + 3] != 0xB0 &&
               d[q + 3] != 0xB3 && d[q + 3] != 0xB5 && d[q + 3] != 0xB2 &&
               !(d[q + 3] >= 0x20 && d[q + 3] <= 0x2F))
          q = next_start(d, n, q + 4);
      } else if (code == 0xB3) {
        // GOV (mpeg4_decode_gop_header): its time code restarts the VOP
        // time base.
        if (b.peek(23)) {
          int hours = int(b.get(5)), minutes = int(b.get(6));
          b.skip(1);
          int seconds = int(b.get(6));
          time_base = seconds + 60 * (minutes + 60 * hours);
        }
      } else if (code == 0xB0 || code == 0xB1 || code <= 0x1F) {
        // VOS, its end, VO: nothing the decoder keeps.
      } else if (code >= 0xB7 && code <= 0xB9) {
        // reserved, slice/extension start codes of other syntaxes
      } else {
        no("start code 0x" + std::to_string(code));
      }
      p = q;
    }
    return kind;
  }

  // The VOP after its header: skipped B-VOPs (no older reference), the
  // decode, and ffmpeg's output (the B-VOP or, behind low_delay, the
  // older reference).
  void decode_picture(Bits& b, Picture* out, bool& got) {
    if (type == 2 && !have_last) {
      skipped_b = true;
      return;
    }
    decode_vop(b);
    if (type == 2 || low_delay) {
      picture(type == 2 ? cur : next, *out);
      got = true;
    } else if (have_last) {
      picture(last, *out);
      got = true;
    }
  }

  bool decode(const uint8_t* d, size_t n, Picture& out) {
    ++calls;
    bool got = false;
    skipped_b = false;
    if (divx_packed && !held.empty()) {
      // Discarding excessive bitstream in packed xvid: a VOS start code.
      size_t p = next_start(d, n, 0);
      if (p < n && d[p + 3] == 0xB0) held.clear();
    }
    std::vector<uint8_t> src;
    bool from_held = !held.empty() && (divx_packed || n <= 19);
    if (from_held) src.swap(held);
    held.clear();
    const uint8_t* s = from_held ? src.data() : d;
    size_t sn = from_held ? src.size() : n;
    size_t second;
    int kind = walk(s, sn, true, &out, got, second);
    // ff_mpeg4_frame_end: the VOP after a decoded one in this packet,
    // when it is an I- or B-VOP, is decoded at the next packet.
    if (divx_packed && kind >= 0 && !skipped_b) {
      size_t pos = from_held ? 0 : second;
      if (n > pos && n - pos > 7) {
        size_t q = pos;
        for (; q + 4 < n; ++q)
          if (d[q] == 0 && d[q + 1] == 0 && d[q + 2] == 1 && d[q + 3] == 0xB6)
            break;
        if (q + 4 < n && !(d[q + 4] & 0x40)) held.assign(d + q, d + n);
      }
    }
    return got;
  }

  bool flush(Picture& out) {
    if (low_delay || !have_next || flushed) return false;
    flushed = true;
    picture(next, out);
    return true;
  }
};

Mpeg4Decoder::Mpeg4Decoder(const std::vector<uint8_t>& config,
                           const std::string& tag)
    : s_(new State) {
  s_->tag = tag;
  if (!config.empty()) {
    bool got;
    size_t second;
    s_->walk(config.data(), config.size(), false, nullptr, got, second);
  }
}

Mpeg4Decoder::~Mpeg4Decoder() = default;

bool Mpeg4Decoder::decode(const uint8_t* data, size_t n, Picture& out) {
  return s_->decode(data, n, out);
}

bool Mpeg4Decoder::flush(Picture& out) { return s_->flush(out); }

int Mpeg4Decoder::peek(const uint8_t* data, size_t n) {
  bool got;
  size_t second;
  return s_->walk(data, n, false, nullptr, got, second);
}

bool Mpeg4Decoder::picture_size(int& w, int& h) const {
  if (!s_->have_vol) return false;
  w = s_->width;
  h = s_->height;
  return true;
}

bool Mpeg4Decoder::frame_rate(int64_t& num, int64_t& den) const {
  if (!s_->have_vol || !s_->time_inc) return false;
  num = s_->time_res;
  den = s_->time_inc;
  return true;
}

bool Mpeg4Decoder::reorders() const {
  return s_->saw_b || (s_->have_vol && !s_->low_delay);
}

}  // namespace viai_video
