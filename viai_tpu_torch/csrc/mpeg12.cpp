// MPEG-1 (ISO/IEC 11172-2) and MPEG-2 (ISO/IEC 13818-2, H.262) video
// decoder of viai_tpu_torch, for what DVD rips, broadcast captures,
// camcorders and OpenCV's own writer (fourcc PIM1) store: progressive
// frame pictures, decoded as libavcodec's mpeg1video/mpeg2video decoder
// (mpeg12dec.c) decodes them:
//
//   * the sequence header (repeated or not), sequence extension, sequence
//     display extension (its matrix_coefficients, which swscale follows)
//     and quant matrix extension (4:2:2's chroma matrices), the GOP
//     header (closed_gop), the picture header and picture coding
//     extension;
//   * slices: macroblock address increments with the escape and stuffing
//     codes, skipped macroblocks (P: a zero vector, B: the previous
//     macroblock's vectors and directions);
//   * I, P and B frame pictures at any f_code, concealment vectors read
//     and dropped; frame_pred_frame_dct 0 (what libavcodec writes with
//     interlaced tools on, in a frame marked progressive): frame or field
//     DCT and frame or field motion chosen by macroblock;
//   * intra DC prediction at intra_dc_precision 8 to 11, table B-15
//     (intra_vlc_format), the alternate scan, the non-linear quantiser
//     scale (q_scale_type), the default and loaded matrices;
//   * MPEG-2's mismatch control and MPEG-1's oddification, done in the
//     coefficient loop as libavcodec does it (no saturation);
//   * 4:2:0 and 4:2:2 (the 4:2:2 Profile); any horizontal_size and
//     vertical_size, cropped from the coded macroblocks (a 32-line pair
//     of macroblock rows when progressive_sequence is 0);
//   * half-pel motion with rounding, chroma vectors halved toward zero
//     (horizontally only in 4:2:2), B's average rounding up, field
//     vectors reading either field of the reference;
//   * ffmpeg's simple IDCT (videodec.cpp), as libavcodec's mpegvideo
//     decoders use it;
//   * libavcodec's output order: one picture behind unless low_delay, a
//     B-picture at once, the held reference at the end (or at a packet
//     that is a sequence end code alone); B-pictures of an open GOP
//     without a forward reference skipped; a new sequence at another
//     size dropping the held references (mpeg_decode_postinit).
//
// Soft telecine (progressive_frame 1 with repeat_first_field) is read
// one frame a picture, as cv2 reads it. What raises NotImplementedError
// (code 2), naming it: pictures libavcodec marks interlaced (field
// pictures, frame pictures with progressive_frame 0), whose frames cv2's
// swscale refuses; dual-prime motion (which no encoder at hand writes);
// MPEG-1 D-pictures and full_pel vectors; scalable extensions; 4:4:4.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <memory>
#include <string>
#include <vector>

#include "mpeg_bits.h"
#include "video.h"

namespace viai_video {

namespace {

using mpeg::Bits;
using mpeg::kZigzag;
using mpeg::Vlc;


// Tables of libavcodec's mpeg12data.c, mpeg12.c and mpegvideodata.c, as
// (code, length) rows: the macroblock address increments 1..33, escape,
// stuffing and 8 zero bits (the end of a slice); the motion codes of
// |motion_code| 0..16; coded_block_pattern by value; the DC sizes 0..11;
// tables B-14 and B-15 (the 111 (run, level) rows of kRun and kLevel,
// escape, end of block); macroblock_type of P- and B-pictures (the rows
// of kPFlags and kBFlags); the alternate scan is mpeg::kAltVertical;
// kIntraDefault: MPEG's default intra matrix in natural order;
// kNonLinear: q_scale_type 1's quantiser scale by code.
const uint8_t kMbIncr[36][2] = {
    {0x1, 1}, {0x3, 3}, {0x2, 3}, {0x3, 4}, {0x2, 4}, {0x3, 5},
    {0x2, 5}, {0x7, 7}, {0x6, 7}, {0xb, 8}, {0xa, 8}, {0x9, 8},
    {0x8, 8}, {0x7, 8}, {0x6, 8}, {0x17, 10}, {0x16, 10}, {0x15, 10},
    {0x14, 10}, {0x13, 10}, {0x12, 10}, {0x23, 11}, {0x22, 11}, {0x21, 11},
    {0x20, 11}, {0x1f, 11}, {0x1e, 11}, {0x1d, 11}, {0x1c, 11}, {0x1b, 11},
    {0x1a, 11}, {0x19, 11}, {0x18, 11}, {0x8, 11}, {0xf, 11}, {0x0, 8}};
const uint8_t kMvCode[17][2] = {
    {0x1, 1}, {0x1, 2}, {0x1, 3}, {0x1, 4}, {0x3, 6}, {0x5, 7},
    {0x4, 7}, {0x3, 7}, {0xb, 9}, {0xa, 9}, {0x9, 9}, {0x11, 10},
    {0x10, 10}, {0xf, 10}, {0xe, 10}, {0xd, 10}, {0xc, 10}};
const uint8_t kCbp[64][2] = {
    {0x1, 9}, {0xb, 5}, {0x9, 5}, {0xd, 6}, {0xd, 4}, {0x17, 7},
    {0x13, 7}, {0x1f, 8}, {0xc, 4}, {0x16, 7}, {0x12, 7}, {0x1e, 8},
    {0x13, 5}, {0x1b, 8}, {0x17, 8}, {0x13, 8}, {0xb, 4}, {0x15, 7},
    {0x11, 7}, {0x1d, 8}, {0x11, 5}, {0x19, 8}, {0x15, 8}, {0x11, 8},
    {0xf, 6}, {0xf, 8}, {0xd, 8}, {0x3, 9}, {0xf, 5}, {0xb, 8},
    {0x7, 8}, {0x7, 9}, {0xa, 4}, {0x14, 7}, {0x10, 7}, {0x1c, 8},
    {0xe, 6}, {0xe, 8}, {0xc, 8}, {0x2, 9}, {0x10, 5}, {0x18, 8},
    {0x14, 8}, {0x10, 8}, {0xe, 5}, {0xa, 8}, {0x6, 8}, {0x6, 9},
    {0x12, 5}, {0x1a, 8}, {0x16, 8}, {0x12, 8}, {0xd, 5}, {0x9, 8},
    {0x5, 8}, {0x5, 9}, {0xc, 5}, {0x8, 8}, {0x4, 8}, {0x4, 9},
    {0x7, 3}, {0xa, 5}, {0x8, 5}, {0xc, 6}};
const uint16_t kDcLuma[12][2] = {
    {0x4, 3}, {0x0, 2}, {0x1, 2}, {0x5, 3}, {0x6, 3}, {0xe, 4},
    {0x1e, 5}, {0x3e, 6}, {0x7e, 7}, {0xfe, 8}, {0x1fe, 9}, {0x1ff, 9}};
const uint16_t kDcChroma[12][2] = {
    {0x0, 2}, {0x1, 2}, {0x2, 2}, {0x6, 3}, {0xe, 4}, {0x1e, 5},
    {0x3e, 6}, {0x7e, 7}, {0xfe, 8}, {0x1fe, 9}, {0x3fe, 10}, {0x3ff, 10}};
const uint16_t kTcoef1[113][2] = {
    {0x3, 2}, {0x4, 4}, {0x5, 5}, {0x6, 7}, {0x26, 8}, {0x21, 8},
    {0xa, 10}, {0x1d, 12}, {0x18, 12}, {0x13, 12}, {0x10, 12}, {0x1a, 13},
    {0x19, 13}, {0x18, 13}, {0x17, 13}, {0x1f, 14}, {0x1e, 14}, {0x1d, 14},
    {0x1c, 14}, {0x1b, 14}, {0x1a, 14}, {0x19, 14}, {0x18, 14}, {0x17, 14},
    {0x16, 14}, {0x15, 14}, {0x14, 14}, {0x13, 14}, {0x12, 14}, {0x11, 14},
    {0x10, 14}, {0x18, 15}, {0x17, 15}, {0x16, 15}, {0x15, 15}, {0x14, 15},
    {0x13, 15}, {0x12, 15}, {0x11, 15}, {0x10, 15}, {0x3, 3}, {0x6, 6},
    {0x25, 8}, {0xc, 10}, {0x1b, 12}, {0x16, 13}, {0x15, 13}, {0x1f, 15},
    {0x1e, 15}, {0x1d, 15}, {0x1c, 15}, {0x1b, 15}, {0x1a, 15}, {0x19, 15},
    {0x13, 16}, {0x12, 16}, {0x11, 16}, {0x10, 16}, {0x5, 4}, {0x4, 7},
    {0xb, 10}, {0x14, 12}, {0x14, 13}, {0x7, 5}, {0x24, 8}, {0x1c, 12},
    {0x13, 13}, {0x6, 5}, {0xf, 10}, {0x12, 12}, {0x7, 6}, {0x9, 10},
    {0x12, 13}, {0x5, 6}, {0x1e, 12}, {0x14, 16}, {0x4, 6}, {0x15, 12},
    {0x7, 7}, {0x11, 12}, {0x5, 7}, {0x11, 13}, {0x27, 8}, {0x10, 13},
    {0x23, 8}, {0x1a, 16}, {0x22, 8}, {0x19, 16}, {0x20, 8}, {0x18, 16},
    {0xe, 10}, {0x17, 16}, {0xd, 10}, {0x16, 16}, {0x8, 10}, {0x15, 16},
    {0x1f, 12}, {0x1a, 12}, {0x19, 12}, {0x17, 12}, {0x16, 12}, {0x1f, 13},
    {0x1e, 13}, {0x1d, 13}, {0x1c, 13}, {0x1b, 13}, {0x1f, 16}, {0x1e, 16},
    {0x1d, 16}, {0x1c, 16}, {0x1b, 16}, {0x1, 6}, {0x2, 2}};
const uint16_t kTcoef2[113][2] = {
    {0x2, 2}, {0x6, 3}, {0x7, 4}, {0x1c, 5}, {0x1d, 5}, {0x5, 6},
    {0x4, 6}, {0x7b, 7}, {0x7c, 7}, {0x23, 8}, {0x22, 8}, {0xfa, 8},
    {0xfb, 8}, {0xfe, 8}, {0xff, 8}, {0x1f, 14}, {0x1e, 14}, {0x1d, 14},
    {0x1c, 14}, {0x1b, 14}, {0x1a, 14}, {0x19, 14}, {0x18, 14}, {0x17, 14},
    {0x16, 14}, {0x15, 14}, {0x14, 14}, {0x13, 14}, {0x12, 14}, {0x11, 14},
    {0x10, 14}, {0x18, 15}, {0x17, 15}, {0x16, 15}, {0x15, 15}, {0x14, 15},
    {0x13, 15}, {0x12, 15}, {0x11, 15}, {0x10, 15}, {0x2, 3}, {0x6, 5},
    {0x79, 7}, {0x27, 8}, {0x20, 8}, {0x16, 13}, {0x15, 13}, {0x1f, 15},
    {0x1e, 15}, {0x1d, 15}, {0x1c, 15}, {0x1b, 15}, {0x1a, 15}, {0x19, 15},
    {0x13, 16}, {0x12, 16}, {0x11, 16}, {0x10, 16}, {0x5, 5}, {0x7, 7},
    {0xfc, 8}, {0xc, 10}, {0x14, 13}, {0x7, 5}, {0x26, 8}, {0x1c, 12},
    {0x13, 13}, {0x6, 6}, {0xfd, 8}, {0x12, 12}, {0x7, 6}, {0x4, 9},
    {0x12, 13}, {0x6, 7}, {0x1e, 12}, {0x14, 16}, {0x4, 7}, {0x15, 12},
    {0x5, 7}, {0x11, 12}, {0x78, 7}, {0x11, 13}, {0x7a, 7}, {0x10, 13},
    {0x21, 8}, {0x1a, 16}, {0x25, 8}, {0x19, 16}, {0x24, 8}, {0x18, 16},
    {0x5, 9}, {0x17, 16}, {0x7, 9}, {0x16, 16}, {0xd, 10}, {0x15, 16},
    {0x1f, 12}, {0x1a, 12}, {0x19, 12}, {0x17, 12}, {0x16, 12}, {0x1f, 13},
    {0x1e, 13}, {0x1d, 13}, {0x1c, 13}, {0x1b, 13}, {0x1f, 16}, {0x1e, 16},
    {0x1d, 16}, {0x1c, 16}, {0x1b, 16}, {0x1, 6}, {0x6, 4}};
const uint8_t kRun[111] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 2, 3,
    3, 3, 3, 4, 4, 4, 5, 5, 5, 6, 6, 6, 7, 7, 8, 8,
    9, 9, 10, 10, 11, 11, 12, 12, 13, 13, 14, 14, 15, 15, 16, 16,
    17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31};
const uint8_t kLevel[111] = {
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16,
    17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32,
    33, 34, 35, 36, 37, 38, 39, 40, 1, 2, 3, 4, 5, 6, 7, 8,
    9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 1, 2, 3, 4, 5, 1,
    2, 3, 4, 1, 2, 3, 1, 2, 3, 1, 2, 3, 1, 2, 1, 2,
    1, 2, 1, 2, 1, 2, 1, 2, 1, 2, 1, 2, 1, 2, 1, 2,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1};
const uint8_t kPType[7][2] = {
    {0x3, 5}, {0x1, 2}, {0x1, 3}, {0x1, 1}, {0x1, 6}, {0x1, 5}, {0x2, 5}};
const uint8_t kBType[11][2] = {
    {0x3, 5}, {0x2, 3}, {0x3, 3}, {0x2, 4}, {0x3, 4}, {0x2, 2},
    {0x3, 2}, {0x1, 6}, {0x2, 6}, {0x3, 6}, {0x2, 5}};
const uint8_t kIntraDefault[64] = {
    8, 16, 19, 22, 26, 27, 29, 34, 16, 16, 22, 24, 27, 29, 34, 37,
    19, 22, 26, 27, 29, 34, 34, 38, 22, 22, 26, 27, 29, 34, 37, 40,
    22, 26, 27, 29, 32, 35, 40, 48, 26, 27, 29, 32, 35, 40, 48, 58,
    26, 27, 29, 34, 38, 46, 56, 69, 27, 29, 35, 38, 46, 56, 69, 83};
const uint8_t kNonLinear[32] = {
    0, 1, 2, 3, 4, 5, 6, 7, 8, 10, 12, 14, 16, 18, 20, 22,
    24, 28, 32, 36, 40, 44, 48, 52, 56, 64, 72, 80, 88, 96, 104, 112};

// macroblock_type as flags (libavcodec's ptype2mb_type, btype2mb_type).
enum : int {
  kIntra = 1, kQuant = 2, kPattern = 4, kFwd = 8, kBwd = 16, kZeroMv = 32
};
const int kPFlags[7] = {kIntra,
                        kFwd | kPattern | kZeroMv,
                        kFwd,
                        kFwd | kPattern,
                        kQuant | kIntra,
                        kQuant | kFwd | kPattern | kZeroMv,
                        kQuant | kFwd | kPattern};
const int kBFlags[11] = {kIntra,
                         kBwd,
                         kBwd | kPattern,
                         kFwd,
                         kFwd | kPattern,
                         kFwd | kBwd,
                         kFwd | kBwd | kPattern,
                         kQuant | kIntra,
                         kQuant | kBwd | kPattern,
                         kQuant | kFwd | kPattern,
                         kQuant | kFwd | kBwd | kPattern};

// Start codes (the byte after 00 00 01).
enum : int {
  kPictureCode = 0x00, kSeqCode = 0xB3, kExtCode = 0xB5, kSeqEndCode = 0xB7,
  kGopCode = 0xB8, kSliceMax = 0xAF
};

inline int sign_extend(int v, int bits) {
  return int32_t(uint32_t(v) << (32 - bits)) >> (32 - bits);
}

const Vlc& incr_vlc() {
  static const Vlc v(kMbIncr, 36, 11);
  return v;
}
const Vlc& mv_vlc() {
  static const Vlc v(kMvCode, 17, 10);
  return v;
}
const Vlc& cbp_vlc() {
  static const Vlc v(kCbp, 64, 9);
  return v;
}
const Vlc& dc_vlc(int chroma) {
  static const Vlc l(kDcLuma, 12, 9), c(kDcChroma, 12, 10);
  return chroma ? c : l;
}
const Vlc& ptype_vlc() {
  static const Vlc v(kPType, 7, 6);
  return v;
}
const Vlc& btype_vlc() {
  static const Vlc v(kBType, 11, 6);
  return v;
}
// Table B-14 (b15 false) or B-15: symbols 0..110 (kRun, kLevel), 111
// escape, 112 end of block.
const Vlc& tcoef_vlc(bool b15) {
  static const Vlc one(kTcoef1, 113, 16), two(kTcoef2, 113, 16);
  return b15 ? two : one;
}
constexpr int kEscape = 111, kEob = 112;

// hpeldsp's put (or avg) of a w x h block at half-pel phase dxy (1 x,
// 2 y), rounding up; avg rounds the mean with dst up too.
void hpel(const uint8_t* s, ptrdiff_t ss, uint8_t* d, ptrdiff_t ds, int w,
          int h, int dxy, bool avg) {
  for (int y = 0; y < h; ++y, s += ss, d += ds)
    for (int x = 0; x < w; ++x) {
      int v;
      switch (dxy) {
        case 0: v = s[x]; break;
        case 1: v = (s[x] + s[x + 1] + 1) >> 1; break;
        case 2: v = (s[x] + s[x + ss] + 1) >> 1; break;
        default:
          v = (s[x] + s[x + 1] + s[x + ss] + s[x + ss + 1] + 2) >> 2;
      }
      d[x] = uint8_t(avg ? (d[x] + v + 1) >> 1 : v);
    }
}

// A decoded picture at the coded size (whole macroblocks).
struct Frame {
  std::vector<uint8_t> y, u, v;
  int w = 0, h = 0, ys = 0, cs = 0, yshift = 1;
  int matrix = 2, chroma_loc = 0;
  int64_t source = 0;
  bool dummy = false;   // libavcodec's grey stand-in for a missing reference
};
using FramePtr = std::shared_ptr<Frame>;

}  // namespace

struct Mpeg12Decoder::State {
  std::string tag;
  std::vector<uint8_t> config;
  bool config_done = false;
  bool headers_only = false;
  int64_t calls = -1;
  // The sequence (header and extensions).
  bool have_seq = false, mpeg2 = false;
  int width = 0, height = 0, aspect = 0;
  bool progressive_seq = true, low_delay = false;
  int chroma_format = 1;
  // frame_rate_code, and the sequence extension's frame_rate_extension_n
  // and _d.
  int rate_code = 0, rate_n = 0, rate_d = 0;
  int colorspace = 2;          // matrix_coefficients (2: unspecified)
  int pan_w = 0, pan_h = 0;    // the sequence display extension's size
  uint16_t intra_m[64], inter_m[64], cintra_m[64], cinter_m[64];
  // The context mpeg_decode_postinit allocated, and what it keyed on.
  bool alloc = false;
  int a_w = 0, a_h = 0, a_aspect = 0, a_pan_w = 0, a_pan_h = 0, a_cf = 1;
  bool a_prog = true;
  int mbw = 0, mbh = 0, yshift = 1, chroma_loc = 0;
  // The GOP.
  bool closed_gop = false, sync = false;
  // The picture.
  int pict_type = 0;               // 1 I, 2 P, 3 B; 0 none
  int f_code[2][2] = {{1, 1}, {1, 1}};
  bool full_pel[2] = {false, false};
  int dc_prec = 0, structure = 3, tff = 0, fpfd = 1, concealment = 0;
  int qtype = 0, intra_vlc = 0, alt_scan = 0, rff = 0, progressive_frame = 1;
  bool first_slice = false;
  // References: the picture being decoded, the older (forward) and the
  // newer (backward), as libavcodec's current, last and next.
  FramePtr cur, last, next;
  // The macroblock.
  Bits* b = nullptr;
  int qscale = 2, last_dc[3] = {128, 128, 128};
  // Vectors by direction, then field (the frame vector in field 0),
  // then component; field vectors' vertical predictors in frame units.
  int last_mv[2][2][2] = {};
  int mv[2][2][2] = {};
  int field_select[2][2] = {};
  bool field_mv = false, interlaced_dct = false;
  int mv_dir = 0, flags = 0, mb_x = 0, mb_y = 0, skip_run = 0;
  int16_t blk[8][64];
  bool coded[8];

  State(const std::vector<uint8_t>& cfg, const std::string& t)
      : tag(t), config(cfg) {
    for (int i = 0; i < 64; ++i) {
      intra_m[i] = cintra_m[i] = kIntraDefault[i];
      inter_m[i] = cinter_m[i] = 16;
    }
  }

  [[noreturn]] void no(const std::string& what) const {
    unsupported("MPEG-1/2 video ('" + tag + "'): " + what);
  }
  [[noreturn]] void bad(const std::string& what) const {
    broken("MPEG-1/2 video ('" + tag + "'): " + what);
  }

  // ------------------------------------------------------------ headers

  // load_matrix: 64 values in zigzag order, the intra DC forced to 8.
  void load_matrix(Bits& q, uint16_t* m0, uint16_t* m1, bool intra) {
    for (int i = 0; i < 64; ++i) {
      int v = int(q.get(8));
      if (!v) bad("quantiser matrix with a zero");
      if (intra && i == 0) v = 8;
      m0[kZigzag[i]] = uint16_t(v);
      if (m1) m1[kZigzag[i]] = uint16_t(v);
    }
  }

  // mpeg1_decode_sequence.
  void sequence_header(Bits& q) {
    int w = int(q.get(12)), h = int(q.get(12));
    int ar = int(q.get(4));
    rate_code = int(q.get(4));
    rate_n = rate_d = 0;
    q.skip(18);                               // bit rate
    if (!q.get1()) bad("sequence header without its marker bit");
    q.skip(10 + 1);                           // vbv_buffer_size, constrained
    if (q.get1()) {
      load_matrix(q, cintra_m, intra_m, true);
    } else {
      for (int i = 0; i < 64; ++i) intra_m[i] = cintra_m[i] = kIntraDefault[i];
    }
    if (q.get1()) {
      load_matrix(q, cinter_m, inter_m, false);
    } else {
      for (int i = 0; i < 64; ++i) inter_m[i] = cinter_m[i] = 16;
    }
    if (!w || !h) bad("sequence header of size 0");
    width = w;
    height = h;
    aspect = ar;
    progressive_seq = true;
    progressive_frame = 1;
    structure = 3;
    fpfd = 1;
    chroma_format = 1;
    mpeg2 = false;
    have_seq = true;
  }

  // The extensions mpeg12dec reads (ids 1, 2, 3, 8; 7 is skipped); the
  // scalable ones (5, 9, 10) raise. `last_code` as decode_chunks tracks it.
  void extension(Bits& q, int last_code) {
    int id = int(q.get(4));
    if (id == 1 && last_code == 0) {
      q.skip(1 + 3 + 4);                      // profile and level
      progressive_seq = q.get1();
      chroma_format = int(q.get(2));
      if (!chroma_format) chroma_format = 1;
      width |= int(q.get(2)) << 12;
      height |= int(q.get(2)) << 12;
      q.skip(12 + 1 + 8);                     // bit rate, marker, vbv
      low_delay = q.get1();
      rate_n = int(q.get(2));
      rate_d = int(q.get(5));
      mpeg2 = true;
      if (chroma_format == 3) no("4:4:4 (chroma_format 3)");
    } else if (id == 2) {
      q.skip(3);                              // video_format
      if (q.get1()) {
        q.skip(16);                           // primaries, transfer
        colorspace = int(q.get(8));
      }
      pan_w = 16 * int(q.get(14));
      q.skip(1);
      pan_h = 16 * int(q.get(14));
    } else if (id == 3) {
      if (q.get1()) load_matrix(q, cintra_m, intra_m, true);
      if (q.get1()) load_matrix(q, cinter_m, inter_m, false);
      if (q.get1()) load_matrix(q, cintra_m, nullptr, true);
      if (q.get1()) load_matrix(q, cinter_m, nullptr, false);
    } else if (id == 8 && last_code == kPictureCode + 0x100) {
      for (int s = 0; s < 2; ++s)
        for (int t = 0; t < 2; ++t) {
          f_code[s][t] = int(q.get(4));
          f_code[s][t] += !f_code[s][t];
        }
      full_pel[0] = full_pel[1] = false;
      dc_prec = int(q.get(2));
      structure = int(q.get(2));
      tff = q.get1();
      fpfd = q.get1();
      concealment = q.get1();
      qtype = q.get1();
      intra_vlc = q.get1();
      alt_scan = q.get1();
      rff = q.get1();
      q.skip(1);                              // chroma_420_type
      progressive_frame = q.get1();
    } else if (id == 5) {
      no("scalable coding (a sequence scalable extension)");
    } else if (id == 9 || id == 10) {
      no(std::string("scalable coding (a picture ") +
         (id == 9 ? "spatial" : "temporal") + " scalable extension)");
    }
  }

  // mpeg1_decode_picture: false for a picture libavcodec refuses.
  void picture_header(Bits& q) {
    q.skip(10);                               // temporal_reference
    pict_type = int(q.get(3));
    if (pict_type == 4) no("MPEG-1 D-pictures (DC intra-coded)");
    if (pict_type == 0 || pict_type > 4) bad("picture of coding type 0 or 5-7");
    q.skip(16);                               // vbv_delay
    if (pict_type == 2 || pict_type == 3) {
      full_pel[0] = q.get1();
      int f = int(q.get(3));
      f_code[0][0] = f_code[0][1] = f + !f;
    }
    if (pict_type == 3) {
      full_pel[1] = q.get1();
      int f = int(q.get(3));
      f_code[1][0] = f_code[1][1] = f + !f;
    }
  }

  // mpeg_decode_postinit: a new context at another size, aspect ratio or
  // (where it changes the macroblock rows) progressive_sequence, which
  // drops every picture held.
  void postinit() {
    if (!have_seq) bad("picture before a sequence header");
    auto a16 = [](int v) { return (v + 15) & ~15; };
    auto a32 = [](int v) { return (v + 31) & ~31; };
    if (alloc && width == a_w && height == a_h && aspect == a_aspect &&
        pan_w == a_pan_w && pan_h == a_pan_h &&
        (progressive_seq == a_prog || a16(height) == a32(height))) {
      if (chroma_format != a_cf)
        no("a chroma format change without a new picture size");
      return;
    }
    alloc = true;
    a_w = width;
    a_h = height;
    a_aspect = aspect;
    a_pan_w = pan_w;
    a_pan_h = pan_h;
    a_prog = progressive_seq;
    a_cf = chroma_format;
    cur.reset();
    last.reset();
    next.reset();
    mbw = (width + 15) / 16;
    mbh = mpeg2 && !progressive_seq ? 2 * ((height + 31) / 32)
                                    : (height + 15) / 16;
    yshift = chroma_format == 1 ? 1 : 0;
    // AVCodecContext.chroma_sample_location: MPEG-1 centre, MPEG-2 left
    // (4:2:0) or top left (4:2:2).
    chroma_loc = !mpeg2 ? 2 : chroma_format == 1 ? 1 : 3;
  }

  FramePtr new_frame(bool grey) const {
    FramePtr f = std::make_shared<Frame>();
    f->w = width;
    f->h = height;
    f->ys = mbw * 16;
    f->cs = mbw * 8;
    f->yshift = yshift;
    f->matrix = colorspace;
    f->chroma_loc = chroma_loc;
    f->source = calls;
    if (!headers_only) {
      f->y.assign(size_t(f->ys) * mbh * 16, grey ? 0x80 : 0);
      f->u.assign(size_t(f->cs) * ((mbh * 16) >> yshift), grey ? 0x80 : 0);
      f->v = f->u;
    }
    f->dummy = grey;
    return f;
  }

  // ff_mpv_frame_start: the references move on at an I- or P-picture; a
  // missing one is libavcodec's grey stand-in.
  void frame_start() {
    cur = new_frame(false);
    if (pict_type != 3) {
      last = next;
      next = cur;
    }
    if (!last && pict_type != 1) last = new_frame(true);
    if (!next && pict_type == 3) next = new_frame(true);
  }

  void picture(const Frame& f, Picture& out) const {
    out.w = f.w;
    out.h = f.h;
    out.ystride = f.ys;
    out.cstride = f.cs;
    out.y = f.y;
    out.u = f.u;
    out.v = f.v;
    out.y16.clear();
    out.u16.clear();
    out.v16.clear();
    out.depth = 8;
    out.xshift = 1;
    out.yshift = f.yshift;
    out.grey = out.rgb = out.full_range = false;
    out.matrix = f.matrix;
    out.chroma_loc = f.chroma_loc;
    out.source = f.source;
  }

  // ------------------------------------------------------- macroblocks

  int get_qscale() {
    int q = int(b->get(5));
    return qtype ? kNonLinear[q] : q << 1;
  }

  // mpeg_decode_motion: the component from its predictor, modulo
  // 32 << (f_code − 1).
  int motion(int fcode, int pred) {
    int code = mv_vlc().read(*b);
    if (code == 0) return pred;
    if (code < 0) bad("motion code not in table B-10");
    int sign = b->get1(), shift = fcode - 1, val = code;
    if (shift) {
      val = (val - 1) << shift;
      val |= int(b->get(shift));
      ++val;
    }
    if (sign) val = -val;
    return sign_extend(val + pred, 5 + shift);
  }

  int dc_diff(int comp) {
    int size = dc_vlc(comp).read(*b);
    if (size < 0) bad("DC size not in table B-12/B-13");
    return size ? b->xbits(size) : 0;
  }

  // Table B-14/B-15's next code: run and |level|, with its sign read;
  // false at the end of the block. MPEG-1's escape reads an 8- or
  // 16-bit level, MPEG-2's a 12-bit one; `esc` tells.
  bool tcoef(const Vlc& v, int& run, int& level, bool& esc) {
    int s = v.read(*b);
    if (s < 0) bad("DCT coefficient not in table B-14/B-15");
    if (s == kEob) return false;
    if (s == kEscape) {
      esc = true;
      run = int(b->get(6)) + 1;
      if (mpeg2) {
        level = sign_extend(int(b->get(12)), 12);
      } else {
        level = sign_extend(int(b->get(8)), 8);
        if (level == -128)
          level = int(b->get(8)) - 256;
        else if (level == 0)
          level = int(b->get(8));
      }
    } else {
      esc = false;
      run = kRun[s] + 1;
      level = kLevel[s];
    }
    return true;
  }

  const uint8_t* scan() const { return alt_scan ? mpeg::kAltVertical : kZigzag; }

  // The end of a non-intra block, or of an MPEG-1 intra block: "10".
  bool at_eob() const { return b->peek(2) == 2; }

  // ff_mpeg1_decode_block_intra / mpeg2_decode_block_intra.
  void intra_block(int n, int16_t* blk) {
    const uint8_t* sc = scan();
    int comp;
    const uint16_t* m;
    if (mpeg2) {
      comp = n < 4 ? 0 : (n & 1) + 1;
      m = n < 4 ? intra_m : cintra_m;
    } else {
      comp = n <= 3 ? 0 : n - 3;
      m = intra_m;
    }
    int dc = last_dc[comp] += dc_diff(comp);
    int i = 0, run, level;
    bool esc;
    if (!mpeg2) {
      blk[0] = int16_t(dc * m[0]);
      if (at_eob()) {
        b->skip(2);
        return;
      }
      for (;;) {
        if (!tcoef(tcoef_vlc(false), run, level, esc)) bad("misplaced EOB");
        i += run;
        if (i > 63) bad("more than 64 coefficients in a block");
        int j = sc[i];
        if (!esc) {
          level = ((level * qscale * m[j]) >> 4);
          level = (level - 1) | 1;
          if (b->get1()) level = -level;
        } else if (level < 0) {
          level = (((-level) * qscale * m[j]) >> 4);
          level = -((level - 1) | 1);
        } else {
          level = (level * qscale * m[j]) >> 4;
          level = (level - 1) | 1;
        }
        blk[j] = int16_t(level);
        if (at_eob()) break;
      }
      b->skip(2);
      return;
    }
    blk[0] = int16_t(dc * (1 << (3 - dc_prec)));
    int mismatch = blk[0] ^ 1;
    const Vlc& v = tcoef_vlc(intra_vlc);
    while (tcoef(v, run, level, esc)) {
      i += run;
      if (i > 63) bad("more than 64 coefficients in a block");
      int j = sc[i];
      if (!esc) {
        level = (level * qscale * m[j]) >> 4;
        if (b->get1()) level = -level;
      } else if (level < 0) {
        level = -(((-level) * qscale * m[j]) >> 4);
      } else {
        level = (level * qscale * m[j]) >> 4;
      }
      mismatch ^= level;
      blk[j] = int16_t(level);
    }
    blk[63] ^= int16_t(mismatch & 1);
  }

  // mpeg1_decode_block_inter / mpeg2_decode_block_non_intra.
  void inter_block(int n, int16_t* blk) {
    const uint8_t* sc = scan();
    const uint16_t* m = mpeg2 && n >= 4 ? cinter_m : inter_m;
    int i = -1, mismatch = 1, run, level;
    bool esc;
    auto store = [&](int j, int lv) {
      mismatch ^= lv;
      blk[j] = int16_t(lv);
    };
    if (b->peek(1)) {
      // The first coefficient's "1s": run 0, level ±1.
      level = (3 * qscale * m[0]) >> 5;
      if (!mpeg2) level = (level - 1) | 1;
      if (b->peek(2) & 1) level = -level;
      b->skip(2);
      store(0, level);
      i = 0;
      if (at_eob()) goto end;
    }
    for (;;) {
      if (!tcoef(tcoef_vlc(false), run, level, esc)) bad("misplaced EOB");
      i += run;
      if (i > 63) bad("more than 64 coefficients in a block");
      {
        int j = sc[i];
        int mag = esc ? (level < 0 ? -level : level) : level;
        int v = ((mag * 2 + 1) * qscale * m[j]) >> 5;
        if (!mpeg2) v = (v - 1) | 1;
        bool neg = esc ? level < 0 : b->get1();
        store(j, neg ? -v : v);
      }
      if (at_eob()) break;
    }
  end:
    b->skip(2);
    if (mpeg2) blk[63] ^= int16_t(mismatch & 1);
  }

  // mpeg_motion_internal: luma and chroma put (or averaged, `avg`) from
  // `ref` by a frame vector (fb 0) or by a field vector (fb 1) from the
  // field `sel` of the reference into the field `bottom` of the
  // macroblock. A vector out of the macroblock-aligned picture, which
  // libavcodec ignores, raises.
  void motion_comp(const Frame& ref, int mx, int my, bool avg, int fb = 0,
                   int bottom = 0, int sel = 0) {
    const int h = 16 >> fb;
    const int sx = mb_x * 16 + (mx >> 1);
    const int sy = (mb_y << (4 - fb)) + (my >> 1);
    const int he = mbw * 16, ve = (mbh * 16) >> fb;
    if (unsigned(sx) >= unsigned(std::max(he - (mx & 1) - 15, 0)) ||
        unsigned(sy) >= unsigned(std::max(ve - (my & 1) - h + 1, 0)))
      bad("motion vector out of the picture");
    Frame& c = *cur;
    const int ys = c.ys, cs = c.cs;
    const ptrdiff_t ls = ptrdiff_t(ys) << fb, cls = ptrdiff_t(cs) << fb;
    hpel(&ref.y[size_t(sy) * ls + sx + size_t(sel) * ys], ls,
         &c.y[size_t(mb_y) * 16 * ys + mb_x * 16 + size_t(bottom) * ys], ls,
         16, h, ((my & 1) << 1) | (mx & 1), avg);
    int cmx = mx / 2, cx = mb_x * 8 + (cmx >> 1), cy, cdxy, ch;
    if (yshift) {
      int cmy = my / 2;
      cdxy = ((cmy & 1) << 1) | (cmx & 1);
      cy = (mb_y << (3 - fb)) + (cmy >> 1);
      ch = h >> 1;
    } else {
      cdxy = ((my & 1) << 1) | (cmx & 1);
      cy = sy;
      ch = h;
    }
    const size_t src = size_t(cy) * cls + cx + size_t(sel) * cs;
    const size_t dst = size_t(mb_y) * (16 >> yshift) * cs + mb_x * 8 +
                       size_t(bottom) * cs;
    hpel(&ref.u[src], cls, &c.u[dst], cls, 8, ch, cdxy, avg);
    hpel(&ref.v[src], cls, &c.v[dst], cls, 8, ch, cdxy, avg);
  }

  // The blocks' places: 4 luma, then Cb and Cr (4:2:2: Cb, Cr, Cb, Cr
  // from the top); under field DCT a luma (and 4:2:2 chroma) block's
  // rows are every other line, the lower blocks the bottom field's.
  uint8_t* block_dst(int n, ptrdiff_t& stride) {
    Frame& c = *cur;
    const int il = interlaced_dct ? 1 : 0;
    if (n < 4) {
      stride = ptrdiff_t(c.ys) << il;
      int row = mb_y * 16 + (n >> 1) * (il ? 1 : 8);
      return &c.y[size_t(row) * c.ys + mb_x * 16 + (n & 1) * 8];
    }
    std::vector<uint8_t>& p = (n & 1) ? c.v : c.u;
    if (yshift) {
      stride = c.cs;
      return &p[size_t(mb_y) * 8 * c.cs + mb_x * 8];
    }
    stride = ptrdiff_t(c.cs) << il;
    int row = mb_y * 16 + ((n - 4) >> 1) * (il ? 1 : 8);
    return &p[size_t(row) * c.cs + mb_x * 8];
  }

  void reconstruct(int count) {
    ptrdiff_t st;
    if (flags & kIntra) {
      for (int n = 0; n < count; ++n) {
        uint8_t* d = block_dst(n, st);
        idct_put(blk[n], d, st);
      }
      return;
    }
    for (int i = 0; i < 2; ++i) {
      if (!(mv_dir & (1 << i))) continue;
      const Frame& ref = i ? *next : *last;
      const bool avg = i && (mv_dir & 1);
      if (!field_mv) {
        motion_comp(ref, mv[i][0][0], mv[i][0][1], avg);
      } else {
        for (int j = 0; j < 2; ++j)
          motion_comp(ref, mv[i][j][0], mv[i][j][1], avg, 1, j,
                      field_select[i][j]);
      }
    }
    for (int n = 0; n < count; ++n)
      if (coded[n]) {
        uint8_t* d = block_dst(n, st);
        idct_add(blk[n], d, st);
      }
  }

  // mpeg_decode_mb, then its reconstruction.
  void macroblock() {
    const int count = mpeg2 ? 4 + (1 << chroma_format) : 6;
    if (skip_run-- != 0) {
      // A skipped macroblock (its vectors set where the run was read).
      for (int n = 0; n < count; ++n) coded[n] = false;
      reconstruct(count);
      last_dc[0] = last_dc[1] = last_dc[2] = 128 << dc_prec;
      return;
    }
    int t;
    if (pict_type == 1) {
      if (b->get1()) {
        t = kIntra;
      } else {
        if (!b->get1()) bad("macroblock_type 00 in an I-picture");
        t = kIntra | kQuant;
      }
    } else {
      int s = (pict_type == 2 ? ptype_vlc() : btype_vlc()).read(*b);
      if (s < 0) bad("macroblock_type not in table B-3/B-4");
      t = pict_type == 2 ? kPFlags[s] : kBFlags[s];
    }
    flags = t;
    std::memset(blk, 0, sizeof(int16_t) * 64 * size_t(count));
    if (t & kIntra) {
      if (!fpfd) interlaced_dct = b->get1();
      if (t & kQuant) qscale = get_qscale();
      if (concealment) {
        // Concealment vectors: read and dropped (they set the
        // predictors).
        int x = motion(f_code[0][0], last_mv[0][0][0]);
        last_mv[0][0][0] = last_mv[0][1][0] = x;
        int y = motion(f_code[0][1], last_mv[0][0][1]);
        last_mv[0][0][1] = last_mv[0][1][1] = y;
        b->skip(1);
      } else {
        std::memset(last_mv, 0, sizeof(last_mv));
      }
      for (int n = 0; n < count; ++n) intra_block(n, blk[n]);
    } else {
      if (t & kZeroMv) {
        if (!fpfd) interlaced_dct = b->get1();
        if (t & kQuant) qscale = get_qscale();
        mv_dir = 1;
        field_mv = false;
        std::memset(last_mv[0], 0, sizeof(last_mv[0]));
        mv[0][0][0] = mv[0][0][1] = 0;
      } else {
        // motion_type: 1 field, 2 frame, 3 dual-prime.
        int mt = 2;
        if (!fpfd) {
          mt = int(b->get(2));
          if (t & kPattern) interlaced_dct = b->get1();
        }
        if (t & kQuant) qscale = get_qscale();
        mv_dir = ((t & kFwd) ? 1 : 0) | ((t & kBwd) ? 2 : 0);
        if (mt == 3) no("dual-prime motion");
        if (mt == 0) bad("frame_motion_type 0");
        field_mv = mt == 1;
        for (int i = 0; i < 2; ++i) {
          if (!(mv_dir & (1 << i))) continue;
          if (!field_mv) {
            int x = motion(f_code[i][0], last_mv[i][0][0]);
            last_mv[i][0][0] = last_mv[i][1][0] = mv[i][0][0] = x;
            int y = motion(f_code[i][1], last_mv[i][0][1]);
            last_mv[i][0][1] = last_mv[i][1][1] = mv[i][0][1] = y;
            continue;
          }
          for (int j = 0; j < 2; ++j) {
            field_select[i][j] = b->get1();
            int x = motion(f_code[i][0], last_mv[i][j][0]);
            last_mv[i][j][0] = mv[i][j][0] = x;
            int y = motion(f_code[i][1], last_mv[i][j][1] >> 1);
            last_mv[i][j][1] = 2 * y;
            mv[i][j][1] = y;
          }
        }
      }
      for (int n = 0; n < count; ++n) coded[n] = false;
      if (t & kPattern) {
        int cbp = cbp_vlc().read(*b);
        if (cbp < 0) bad("coded_block_pattern not in table B-9");
        if (count > 6) cbp = (cbp << (count - 6)) | int(b->get(count - 6));
        if (cbp <= 0) bad("coded_block_pattern 0");
        for (int n = 0; n < count; ++n)
          if (cbp & (1 << (count - 1 - n))) {
            coded[n] = true;
            inter_block(n, blk[n]);
          }
      }
    }
    reconstruct(count);
    if (!(t & kIntra)) last_dc[0] = last_dc[1] = last_dc[2] = 128 << dc_prec;
  }

  // The macroblock address increment (with escapes and stuffing): the
  // increment − 1, or −1 at the end of the slice.
  int increment() {
    int run = 0;
    for (;;) {
      int code = incr_vlc().read(*b);
      if (code < 0) bad("macroblock_address_increment not in table B-1");
      if (code == 33) {
        run += 33;
      } else if (code == 35) {
        return -1;
      } else if (code < 33) {
        return run + code;
      }
    }
  }

  // mpeg_decode_slice over the bytes after its start code.
  void slice(const uint8_t* d, size_t n, int row) {
    Bits bits{d, n};
    b = &bits;
    if (mpeg2 && mbh > 2800 / 16) b->skip(3);
    last_dc[0] = last_dc[1] = last_dc[2] = 1 << (7 + dc_prec);
    std::memset(last_mv, 0, sizeof(last_mv));
    interlaced_dct = false;
    qscale = get_qscale();
    if (!qscale) bad("quantiser_scale_code 0");
    while (b->get1()) b->skip(8);             // extra_information_slice
    int first = 0;
    for (;;) {
      int code = incr_vlc().read(*b);
      if (code < 0) bad("macroblock_address_increment not in table B-1");
      if (code == 33) {
        first += 33;
      } else if (code < 33) {
        first += code;
        break;
      } else if (code == 35 && bits.pos >= 8 * bits.n) {
        bad("a slice without macroblocks");
      }
    }
    if (first >= mbw) bad("slice starting past the picture's width");
    mb_x = first;
    mb_y = row;
    skip_run = 0;
    flags = kIntra;
    for (;;) {
      macroblock();
      if (++mb_x >= mbw) {
        mb_x = 0;
        if (++mb_y >= mbh) return;
      }
      if (skip_run == -1) {
        int run = increment();
        if (run < 0) return;                  // the end of the slice
        skip_run = run;
        if (run) {
          if (pict_type == 1) bad("skipped macroblock in an I-picture");
          field_mv = false;
          if (pict_type == 2) {
            mv_dir = 1;
            mv[0][0][0] = mv[0][0][1] = 0;
            std::memset(last_mv[0], 0, sizeof(last_mv[0]));
          } else {
            if (flags & kIntra) bad("skipped macroblock after an intra one");
            mv[0][0][0] = last_mv[0][0][0];
            mv[0][0][1] = last_mv[0][0][1];
            mv[1][0][0] = last_mv[1][0][0];
            mv[1][0][1] = last_mv[1][0][1];
          }
          flags &= ~kIntra;
        }
      }
    }
  }

  // ------------------------------------------------------- the packet

  // decode_chunks over one packet (or the container's headers: `config`
  // true, no picture decoded); true with `out` filled when libavcodec
  // outputs a picture after it.
  bool chunks(const uint8_t* d, size_t n, bool config, Picture* out) {
    int last_code = 0;                        // 0x100 + code; 0 none
    bool picture_seen = false, skip_frame = false;
    size_t p = 0;
    auto next_start = [&](size_t from) {
      for (size_t k = from; k + 3 < n; ++k)
        if (d[k] == 0 && d[k + 1] == 0 && d[k + 2] == 1) return k;
      return n;
    };
    for (p = next_start(0); p < n; ) {
      const int code = d[p + 3];
      const size_t body = p + 4;
      size_t q = next_start(body);
      Bits h{d + body, n - body};
      if (code == kSeqCode) {
        if (last_code == 0) {
          sequence_header(h);
          if (!config) sync = true;
        }
      } else if (code == kPictureCode) {
        if (config) {
          // libavcodec decodes no picture of the extradata
        } else if (picture_seen && structure == 3) {
          no("two pictures in one packet");
        } else {
          picture_seen = true;
          if (last_code == 0 || last_code == 0x101) {
            postinit();
            picture_header(h);
            first_slice = true;
            last_code = 0x100 + kPictureCode;
          }
        }
      } else if (code == kExtCode) {
        extension(h, last_code);
      } else if (code == kGopCode) {
        if (last_code == 0) {
          h.skip(25);                         // time_code
          closed_gop = h.get1();
          sync = true;
        }
      } else if (code >= 0x01 && code <= kSliceMax && !config) {
        if (last_code == 0x100 + kPictureCode) {
          if (progressive_seq && !progressive_frame) progressive_frame = 1;
          if (structure == 0 || (progressive_frame && structure != 3))
            structure = 3;
          if (structure != 3)
            no("field pictures (picture_structure " +
               std::to_string(structure) +
               "; interlaced, which cv2 converts to no usable frame)");
          if (!progressive_frame)
            no("interlaced frame pictures (progressive_frame 0, which cv2 "
               "converts to no usable frame)");
          if ((full_pel[0] && pict_type >= 2) ||
              (full_pel[1] && pict_type == 3))
            no("full-pel motion vectors (full_pel_*_vector)");
        }
        if (last_code != 0) {
          int row = code - 1;
          last_code = 0x101;
          if (mpeg2 && mbh > 2800 / 16) row += (d[body] & 0xE0) << 2;
          if (n - body < 2) bad("slice too small");
          if (row >= mbh) bad("slice below the picture");
          if (!last && pict_type == 3 && !closed_gop) {
            // B-pictures of an open GOP without their forward reference.
            skip_frame = true;
          } else {
            if (pict_type == 1) sync = true;
            if (!next && pict_type == 2 && !sync) {
              skip_frame = true;
            } else if (pict_type) {
              if (first_slice) {
                skip_frame = false;
                first_slice = false;
                frame_start();
              }
              if (!headers_only) slice(d + body, n - body, row);
            }
          }
        }
      }
      p = q;
    }
    if (config) return false;
    bool got = false;
    if (!skip_frame && alloc && cur && !first_slice) {
      // slice_end: the picture is complete.
      if (pict_type == 3 || low_delay) {
        picture(*cur, *out);
        got = true;
      } else if (last && !last->dummy) {
        picture(*last, *out);
        got = true;
      }
    }
    pict_type = 0;
    if (got) cur.reset();
    return got;
  }

  // The container's headers, read once before the first packet (as
  // libavcodec reads the extradata).
  void read_config() {
    if (config_done) return;
    config_done = true;
    if (!config.empty()) chunks(config.data(), config.size(), true, nullptr);
  }

  bool decode(const uint8_t* d, size_t n, Picture& out) {
    ++calls;
    if (n == 0 || (n == 4 && d[0] == 0 && d[1] == 0 && d[2] == 1 &&
                   d[3] == kSeqEndCode))
      return flush(out);
    read_config();
    return chunks(d, n, false, &out);
  }

  bool flush(Picture& out) {
    if (low_delay || !next || next->dummy) return false;
    picture(*next, out);
    next.reset();
    return true;
  }

  // The sequence-level headers of a packet (before a later start).
  void headers(const uint8_t* d, size_t n) {
    read_config();
    chunks(d, n, true, nullptr);
  }
};

Mpeg12Decoder::Mpeg12Decoder(const std::vector<uint8_t>& config,
                             const std::string& tag)
    : s_(new State(config, tag)) {}

Mpeg12Decoder::~Mpeg12Decoder() = default;

bool Mpeg12Decoder::decode(const uint8_t* data, size_t n, Picture& out) {
  return s_->decode(data, n, out);
}

bool Mpeg12Decoder::flush(Picture& out) {
  ++s_->calls;
  return s_->flush(out);
}

void Mpeg12Decoder::headers(const uint8_t* data, size_t n) {
  s_->headers(data, n);
}

void Mpeg12Decoder::headers_only() { s_->headers_only = true; }

bool Mpeg12Decoder::low_delay() const { return s_->low_delay; }

bool Mpeg12Decoder::frame_rate(int64_t& num, int64_t& den, bool& mpeg2) const {
  // ff_mpeg12_frame_rate_tab: the standard's codes 1-8, Xing's 15 fps
  // (9) and libmpeg3's economy rates (10-13).
  static const int kRates[16][2] = {
      {0, 0},  {24000, 1001}, {24, 1}, {25, 1}, {30000, 1001}, {30, 1},
      {50, 1}, {60000, 1001}, {60, 1}, {15, 1}, {5, 1},         {10, 1},
      {12, 1}, {15, 1},       {0, 0},  {0, 0}};
  const State& s = *s_;
  if (!s.have_seq || !kRates[s.rate_code][0]) return false;
  num = kRates[s.rate_code][0];
  den = kRates[s.rate_code][1];
  if (s.mpeg2) {
    num *= s.rate_n + 1;
    den *= s.rate_d + 1;
  }
  mpeg2 = s.mpeg2;
  return true;
}

bool Mpeg12Decoder::picture_size(int& w, int& h) const {
  if (!s_->have_seq) return false;
  w = s_->width;
  h = s_->height;
  return true;
}

int Mpeg12Decoder::peek(const uint8_t* data, size_t n, bool* closed) {
  bool gop = false, cl = false;
  for (size_t k = 0; k + 5 < n; ++k) {
    if (data[k] || data[k + 1] || data[k + 2] != 1) continue;
    if (data[k + 3] == kGopCode && k + 8 < n) {
      gop = true;
      cl = (data[k + 7] >> 6) & 1;
    } else if (data[k + 3] == kPictureCode) {
      int type = (data[k + 5] >> 3) & 7;
      if (closed) *closed = gop && cl && type == 1;
      return type >= 1 && type <= 4 ? type - 1 : -1;
    }
  }
  if (closed) *closed = false;
  return -1;
}

}  // namespace viai_video
