// VP9 video decoder of viai_tpu_torch (profiles 0-3: 8, 10 and 12 bits;
// 4:2:0, 4:2:2, 4:4:0, 4:4:4 and sRGB), for the VP9 streams that cv2
// reads through libavcodec (Matroska/WebM CodecID V_VP9, AVI fourcc VP90,
// MP4 sample entry vp09). VP9 reconstruction is exact by specification
// (VP9 Bitstream & Decoding Process Specification v0.6: integer
// transforms, filters and loop filter), so this decoder computes what
// libvpx and libavcodec compute and gives their pictures:
//
//   * the superframe index (Annex B): a packet's frames are decoded in
//     order; a hidden frame is kept as a reference and gives no picture,
//     show_existing_frame gives the referenced slot's picture, and a
//     packet that shows several (an SVC superframe, one a spatial layer)
//     gives each, as libavcodec's superframe split does;
//   * the uncompressed header (§6.2): sync code, colour config (bit depth
//     in profiles 2 and 3, sampling in 1 and 3, sRGB), frame size and
//     size from a reference, intra-only frames (profile 0's without a
//     colour config: 8 bits, 4:2:0, BT.601 limited, as libavcodec sets
//     them), the eight reference slots and their refresh flags, sign
//     bias, high-precision MVs, the interpolation filter, the
//     frame-context flags and setup_past_independence with
//     reset_frame_context, loop filter deltas, quantiser (lossless
//     included; 8, 10 and 12-bit steps), segmentation and tile info;
//   * the boolean decoder and the compressed header (§6.3): tx mode,
//     the coefficient, skip, mode, filter, reference, partition and MV
//     probability updates (vp9_tables.h holds the default tables);
//   * per 64x64 superblock: partitions and mode info with their
//     above/left contexts, keyframe (and intra-only) and inter-frame
//     intra modes, sub-8x8 modes, segment ids with temporal prediction,
//     skip, tx size, single and compound references, inter modes,
//     switchable filters, the MV candidate list (the previous frame's
//     MVs when the spec's UsePrevFrameMvs holds) and MV reading;
//   * tokens with their contexts, bands and scans (chroma in 4x4 units
//     of its own sampling), CAT6 with its bd − 8 extra bits,
//     dequantisation (32x32 halved), the integer inverse DCT/ADST at
//     4-32 points (16-bit intermediates at 8 bits, wide ones above) and
//     the WHT of lossless frames;
//   * intra prediction (the ten modes per transform block, edges of
//     2^(bd−1) ∓ 1 above and left of the frame, above-right pixels for 4x4
//     transforms only), inter prediction (8-tap regular, smooth, sharp
//     and bilinear filters at 1/16 pel, compound averaging, clipped to the
//     bit depth), references read clamped to their own frame size, and
//     from a reference of another size (reference scaling, a reference
//     from twice the frame's size to a sixteenth of it) the positions
//     and steps of libvpx's scaled prediction, which libavcodec copies
//     with its rounding;
//   * the loop filter as libvpx's frame masks build it: levels per
//     segment, reference and mode, 4/8/16-wide filters chosen by transform
//     size and flatness, the 4:2:0 chroma edge rules (4:4:4 chroma by the
//     luma masks, 4:2:2 and 4:4:0 by vp9_filter_block_plane_non420),
//     superblock order; above 8 bits libavcodec's filter with its
//     thresholds shifted by bd − 8;
//   * backward adaptation of the coefficient, mode and MV probabilities
//     and the four saved frame contexts; tiles (columns and rows); the
//     segmentation features (quantiser, loop-filter level, reference,
//     skip) and the segment map carried from frame to frame (cleared by a
//     new frame size);
//   * the picture cropped to the frame size in 8 or 16-bit samples with
//     the stream's colour range and matrix and its sampling (planar GBR
//     for sRGB), which libavcodec passes to cv2's swscale conversion
//     (BT.601 for an unspecified space, as swscale's default).
//
// What the decoder does not read raises NotImplementedError (code 2)
// naming it, read from the header: what libavcodec refuses (sRGB in
// profiles 0 and 2, 4:2:0 signalled in profiles 1 and 3, a reference
// outside the scaling range or of another depth or sampling). Where the
// specification and
// libvpx/libavcodec part, the two libraries (which agree) are followed:
// the loop-filter deltas scale with the frame's level, and the above
// contexts are cleared once a frame.

#include <algorithm>
#include <array>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <string>
#include <type_traits>
#include <vector>

#include "video.h"
#include "vp9_tables.h"

namespace viai_video {

namespace {

using namespace vp9;

// ---------------------------------------------------------------- enums

enum { DC_PRED, V_PRED, H_PRED, D45_PRED, D135_PRED, D117_PRED, D153_PRED,
       D207_PRED, D63_PRED, TM_PRED, NEARESTMV, NEARMV, ZEROMV, NEWMV };
enum { TX_4X4, TX_8X8, TX_16X16, TX_32X32 };
enum { ONLY_4X4, ALLOW_8X8, ALLOW_16X16, ALLOW_32X32, TX_MODE_SELECT };
enum { DCT_DCT, ADST_DCT, DCT_ADST, ADST_ADST };
enum { B4X4, B4X8, B8X4, B8X8, B8X16, B16X8, B16X16, B16X32, B32X16,
       B32X32, B32X64, B64X32, B64X64 };
enum { PART_NONE, PART_HORZ, PART_VERT, PART_SPLIT };
enum { INTRA = 0, LAST = 1, GOLDEN = 2, ALTREF = 3 };
enum { SINGLE_REF, COMPOUND_REF, REF_SELECT };
enum { EIGHTTAP, EIGHTTAP_SMOOTH, EIGHTTAP_SHARP, BILINEAR, SWITCHABLE };
enum { SEG_ALT_Q, SEG_ALT_LF, SEG_REF, SEG_SKIP };

// Block size lookups (4x4 and 8x8 units).
const uint8_t kW4[13] = {1, 1, 2, 2, 2, 4, 4, 4, 8, 8, 8, 16, 16};
const uint8_t kH4[13] = {1, 2, 1, 2, 4, 2, 4, 8, 4, 8, 16, 8, 16};
const uint8_t kW8[13] = {1, 1, 1, 1, 1, 2, 2, 2, 4, 4, 4, 8, 8};
const uint8_t kH8[13] = {1, 1, 1, 1, 2, 1, 2, 4, 2, 4, 8, 4, 8};
const uint8_t kSizeGroup[13] = {0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 3};
const uint8_t kMaxTx[13] = {0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 3};
const uint8_t kTxModeMax[5] = {0, 1, 2, 3, 3};
// subsize[partition][square size 8x8 .. 64x64 as 0..3]
const uint8_t kSubsize[4][4] = {{B8X8, B16X16, B32X32, B64X64},
                                {B8X4, B16X8, B32X16, B64X32},
                                {B4X8, B8X16, B16X32, B32X64},
                                {B4X4, B8X8, B16X16, B32X32}};
// Partition context bits {above, left} each block size leaves.
const uint8_t kPartCtx[13][2] = {{15, 15}, {15, 14}, {14, 15}, {14, 14},
                                 {14, 12}, {12, 14}, {12, 12}, {12, 8},
                                 {8, 12},  {8, 8},   {8, 0},   {0, 8},
                                 {0, 0}};
const uint8_t kIntraTxType[10] = {DCT_DCT,  ADST_DCT, DCT_ADST, DCT_DCT,
                                  ADST_ADST, ADST_DCT, DCT_ADST, DCT_ADST,
                                  ADST_DCT, ADST_ADST};

// The MV candidate positions {row, col} of each block size.
const int8_t kMvRefs[13][8][2] = {
    {{-1, 0}, {0, -1}, {-1, -1}, {-2, 0}, {0, -2}, {-2, -1}, {-1, -2}, {-2, -2}},
    {{-1, 0}, {0, -1}, {-1, -1}, {-2, 0}, {0, -2}, {-2, -1}, {-1, -2}, {-2, -2}},
    {{-1, 0}, {0, -1}, {-1, -1}, {-2, 0}, {0, -2}, {-2, -1}, {-1, -2}, {-2, -2}},
    {{-1, 0}, {0, -1}, {-1, -1}, {-2, 0}, {0, -2}, {-2, -1}, {-1, -2}, {-2, -2}},
    {{0, -1}, {-1, 0}, {1, -1}, {-1, -1}, {0, -2}, {-2, 0}, {-2, -1}, {-1, -2}},
    {{-1, 0}, {0, -1}, {-1, 1}, {-1, -1}, {-2, 0}, {0, -2}, {-1, -2}, {-2, -1}},
    {{-1, 0}, {0, -1}, {-1, 1}, {1, -1}, {-1, -1}, {-3, 0}, {0, -3}, {-3, -3}},
    {{0, -1}, {-1, 0}, {2, -1}, {-1, -1}, {-1, 1}, {0, -3}, {-3, 0}, {-3, -3}},
    {{-1, 0}, {0, -1}, {-1, 2}, {-1, -1}, {1, -1}, {-3, 0}, {0, -3}, {-3, -3}},
    {{-1, 1}, {1, -1}, {-1, 2}, {2, -1}, {-1, -1}, {-3, 0}, {0, -3}, {-3, -3}},
    {{0, -1}, {-1, 0}, {4, -1}, {-1, 2}, {-1, -1}, {0, -3}, {-3, 0}, {2, -1}},
    {{-1, 0}, {0, -1}, {-1, 4}, {2, -1}, {-1, -1}, {-3, 0}, {0, -3}, {-1, 2}},
    {{-1, 3}, {3, -1}, {-1, 4}, {4, -1}, {-1, -1}, {-1, 0}, {0, -1}, {-1, 6}}};
const uint8_t kMode2Counter[14] = {9, 9, 9, 9, 9, 9, 9, 9, 9, 9, 0, 0, 3, 1};
const uint8_t kCounterToCtx[19] = {2, 3, 4, 1, 3, 9, 0, 9, 9, 5,
                                   5, 9, 5, 9, 9, 9, 9, 9, 6};
const uint8_t kSubblockOfCol[4][2] = {{1, 2}, {1, 3}, {3, 2}, {3, 3}};

// Trees (§9.3): an inner node gives the index of its pair, a leaf −value.
const int8_t kIntraTree[18] = {-DC_PRED, 2, -TM_PRED, 4, -V_PRED, 6, 8, 12,
                               -H_PRED, 10, -D135_PRED, -D117_PRED,
                               -D45_PRED, 14, -D63_PRED, 16, -D153_PRED,
                               -D207_PRED};
const int8_t kSegTree[14] = {2, 4, 6, 8, 10, 12, 0, -1, -2, -3, -4, -5,
                             -6, -7};
const int8_t kPartTree[6] = {-PART_NONE, 2, -PART_HORZ, 4, -PART_VERT,
                             -PART_SPLIT};
// Inter modes as offsets from NEARESTMV: ZERO 2, NEAREST 0, NEAR 1, NEW 3.
const int8_t kInterModeTree[6] = {-2, 2, 0, 4, -1, -3};
const int8_t kInterpTree[4] = {-EIGHTTAP, 2, -EIGHTTAP_SMOOTH,
                               -EIGHTTAP_SHARP};
const int8_t kMvJointTree[6] = {0, 2, -1, 4, -2, -3};
const int8_t kMvClassTree[20] = {0, 2, -1, 4, 6, 8, -2, -3, 10, 12,
                                 -4, -5, -6, 14, 16, 18, -7, -8, -9, -10};
const int8_t kMvFpTree[6] = {0, 2, -1, 4, -2, -3};
const int8_t kTokenTree[16] = {2, 6, -2, 4, -3, -4, 8, 10, -5, -6,
                               12, 14, -7, -8, -9, -10};

// Tokens: ZERO, ONE, TWO, THREE, FOUR, CAT1..CAT6.
const uint8_t kEnergy[11] = {0, 1, 2, 3, 3, 4, 4, 5, 5, 5, 5};
const uint8_t kCatProbs[6][14] = {
    {159},
    {165, 145},
    {173, 148, 140},
    {176, 155, 140, 135},
    {180, 157, 141, 134, 130},
    {254, 254, 254, 252, 249, 243, 230, 196, 177, 153, 140, 133, 130, 129}};
const uint8_t kCatBits[6] = {1, 2, 3, 4, 5, 14};
const uint16_t kCatBase[6] = {5, 7, 11, 19, 35, 67};
const uint8_t kBand4[16] = {0, 1, 1, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 5, 5, 5};
const uint8_t kBand8[21] = {0, 1, 1, 2, 2, 2, 3, 3, 3, 3, 4,
                            4, 4, 4, 4, 4, 4, 4, 4, 4, 4};

const uint8_t kModeLf[14] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 0, 1};

inline int clampi(int v, int lo, int hi) {
  return v < lo ? lo : v > hi ? hi : v;
}
// A sample of `bd` bits, clipped (av_clip_pixel).
template <class P>
inline P clip_px(int v, int bd) {
  return P(clampi(v, 0, (1 << bd) - 1));
}

// ------------------------------------------------------- frame contexts

struct MvComp {
  uint8_t sign, classes[10], class0[1], bits[10], class0_fp[2][3], fp[3],
      class0_hp, hp;
};

struct Probs {
  uint8_t tx8[2][1], tx16[2][2], tx32[2][3];
  uint8_t coef[4][2][2][6][6][3];
  uint8_t skip[3];
  uint8_t inter_mode[7][3];
  uint8_t interp[4][2];
  uint8_t is_inter[4];
  uint8_t comp_mode[5];
  uint8_t single_ref[5][2];
  uint8_t comp_ref[5];
  uint8_t y_mode[4][9];
  uint8_t uv_mode[10][9];
  uint8_t partition[16][3];
  uint8_t mv_joint[3];
  MvComp mv[2];
};

Probs default_probs() {
  Probs p;
  std::memset(&p, 0, sizeof(p));
  p.tx8[0][0] = 100;
  p.tx8[1][0] = 66;
  const uint8_t t16[2][2] = {{20, 152}, {15, 101}};
  const uint8_t t32[2][3] = {{3, 136, 37}, {5, 52, 13}};
  std::memcpy(p.tx16, t16, sizeof(t16));
  std::memcpy(p.tx32, t32, sizeof(t32));
  std::memcpy(p.coef, kCoefProbs, sizeof(p.coef));
  const uint8_t skip[3] = {192, 128, 64};
  std::memcpy(p.skip, skip, 3);
  const uint8_t im[7][3] = {{2, 173, 34}, {7, 145, 85}, {7, 166, 63},
                            {7, 94, 66},  {8, 64, 46},  {17, 81, 31},
                            {25, 29, 30}};
  std::memcpy(p.inter_mode, im, sizeof(im));
  const uint8_t interp[4][2] = {{235, 162}, {36, 255}, {34, 3}, {149, 144}};
  std::memcpy(p.interp, interp, sizeof(interp));
  const uint8_t ii[4] = {9, 102, 187, 225};
  std::memcpy(p.is_inter, ii, 4);
  const uint8_t cm[5] = {239, 183, 119, 96, 41};
  std::memcpy(p.comp_mode, cm, 5);
  const uint8_t sr[5][2] = {{33, 16}, {77, 74}, {142, 142}, {172, 170},
                            {238, 247}};
  std::memcpy(p.single_ref, sr, sizeof(sr));
  const uint8_t cr[5] = {50, 126, 123, 221, 226};
  std::memcpy(p.comp_ref, cr, 5);
  std::memcpy(p.y_mode, kYModeDefault, sizeof(p.y_mode));
  std::memcpy(p.uv_mode, kUvModeDefault, sizeof(p.uv_mode));
  std::memcpy(p.partition, kPartitionDefault, sizeof(p.partition));
  p.mv_joint[0] = 32;
  p.mv_joint[1] = 64;
  p.mv_joint[2] = 96;
  const uint8_t cls[2][10] = {{224, 144, 192, 168, 192, 176, 192, 198, 198,
                               245},
                              {216, 128, 176, 160, 176, 176, 192, 198, 198,
                               208}};
  const uint8_t bits[10] = {136, 140, 148, 160, 176, 192, 224, 234, 234, 240};
  const uint8_t c0fp[2][3] = {{128, 128, 64}, {96, 112, 64}};
  const uint8_t fp[3] = {64, 96, 64};
  for (int i = 0; i < 2; ++i) {
    MvComp& c = p.mv[i];
    c.sign = 128;
    std::memcpy(c.classes, cls[i], 10);
    c.class0[0] = i ? 208 : 216;
    std::memcpy(c.bits, bits, 10);
    std::memcpy(c.class0_fp, c0fp, sizeof(c0fp));
    std::memcpy(c.fp, fp, 3);
    c.class0_hp = 160;
    c.hp = 128;
  }
  return p;
}

struct MvCompCounts {
  unsigned sign[2], classes[11], class0[2], bits[10][2], class0_fp[2][4],
      fp[4], class0_hp[2], hp[2];
};

struct Counts {
  unsigned coef[4][2][2][6][6][4];
  unsigned eob[4][2][2][6][6];
  unsigned tx8[2][2], tx16[2][3], tx32[2][4];
  unsigned skip[3][2];
  unsigned inter_mode[7][4];
  unsigned interp[4][3];
  unsigned is_inter[4][2];
  unsigned comp_mode[5][2];
  unsigned single_ref[5][2][2];
  unsigned comp_ref[5][2];
  unsigned y_mode[4][10];
  unsigned uv_mode[10][10];
  unsigned partition[16][4];
  unsigned mv_joint[4];
  MvCompCounts mv[2];
};

// ------------------------------------------------------ boolean decoder

// §9.2: VP8's arithmetic decoder; `value_` holds the window's bits at the
// top of 64, `count_` the bits below the top 8 still valid (zeros are read
// past the end).
class BoolDecoder {
 public:
  void init(const uint8_t* p, size_t n) {
    p_ = p;
    end_ = p + n;
    value_ = 0;
    count_ = -8;
    range_ = 255;
    fill();
    if (read(128)) broken("VP9 boolean decoder marker bit set");
  }
  int read(int prob) {
    unsigned split = (range_ * unsigned(prob) + (256 - unsigned(prob))) >> 8;
    if (count_ < 0) fill();
    uint64_t big = uint64_t(split) << 56;
    int bit;
    if (value_ >= big) {
      range_ -= split;
      value_ -= big;
      bit = 1;
    } else {
      range_ = split;
      bit = 0;
    }
    int shift = __builtin_clz(range_) - 24;
    range_ <<= shift;
    value_ <<= shift;
    count_ -= shift;
    return bit;
  }
  int literal(int n) {
    int v = 0;
    for (int i = 0; i < n; ++i) v = (v << 1) | read(128);
    return v;
  }
  int tree(const int8_t* t, const uint8_t* probs) {
    int i = 0;
    while ((i = t[i + read(probs[i >> 1])]) > 0) {
    }
    return -i;
  }

 private:
  void fill() {
    int shift = 48 - count_;
    while (shift >= 0) {
      if (p_ < end_) value_ |= uint64_t(*p_++) << shift;
      shift -= 8;
      count_ += 8;
    }
  }
  const uint8_t *p_ = nullptr, *end_ = nullptr;
  uint64_t value_ = 0;
  int count_ = 0;
  unsigned range_ = 255;
};

// Uncompressed header bits, most significant first.
class BitReader {
 public:
  BitReader(const uint8_t* p, size_t n) : p_(p), n_(n) {}
  int bit() {
    if (pos_ >= 8 * n_) broken("VP9 uncompressed header cut short");
    int b = (p_[pos_ >> 3] >> (7 - (pos_ & 7))) & 1;
    ++pos_;
    return b;
  }
  int f(int n) {
    int v = 0;
    for (int i = 0; i < n; ++i) v = (v << 1) | bit();
    return v;
  }
  int s(int n) {
    int v = f(n);
    return bit() ? -v : v;
  }
  size_t bytes() const { return (pos_ + 7) >> 3; }

 private:
  const uint8_t* p_;
  size_t n_, pos_ = 0;
};

// ------------------------------------------------------------- frames

struct Mv {
  int16_t row = 0, col = 0;
  bool operator==(const Mv& o) const { return row == o.row && col == o.col; }
  bool operator!=(const Mv& o) const { return !(*this == o); }
};

// The MVs a frame leaves for the next one's candidate lists (per 8x8).
struct MvRef {
  int8_t ref[2] = {INTRA, -1};
  Mv mv[2];
};

// A decoded frame: planes padded to whole superblocks, chroma subsampled
// by (ss_x, ss_y); 8-bit samples in `plane`, 10 and 12-bit ones in
// `plane16`.
struct Frame {
  int w = 0, h = 0;                 // coded size
  int depth = 8, ss_x = 1, ss_y = 1;
  int stride[3] = {0, 0, 0};
  int pw[3] = {0, 0, 0}, ph[3] = {0, 0, 0};   // padded plane sizes
  std::vector<uint8_t> plane[3];
  std::vector<uint16_t> plane16[3];
  Frame(int width, int height, int bits, int sx, int sy)
      : w(width), h(height), depth(bits), ss_x(sx), ss_y(sy) {
    int aw = (w + 63) & ~63, ah = (h + 63) & ~63;
    for (int p = 0; p < 3; ++p) {
      pw[p] = p ? aw >> ss_x : aw;
      ph[p] = p ? ah >> ss_y : ah;
      stride[p] = pw[p];
      if (depth > 8) plane16[p].assign(size_t(pw[p]) * ph[p], 0);
      else plane[p].assign(size_t(pw[p]) * ph[p], 0);
    }
  }
  int crop_w(int p) const { return p ? (w + ss_x) >> ss_x : w; }
  int crop_h(int p) const { return p ? (h + ss_y) >> ss_y : h; }
  template <class P>
  P* data(int p) {
    if constexpr (sizeof(P) == 1) return plane[p].data();
    else return plane16[p].data();
  }
  template <class P>
  const P* data(int p) const {
    if constexpr (sizeof(P) == 1) return plane[p].data();
    else return plane16[p].data();
  }
  template <class P>
  P* at(int p, int x, int y) {
    return data<P>(p) + size_t(y) * stride[p] + x;
  }
};

// Mode info of one block, copied into each 8x8 cell it covers.
struct ModeInfo {
  uint8_t size = B8X8, skip = 0, tx = 0, is_inter = 0, seg = 0;
  uint8_t filter = 0, mode = DC_PRED, uv_mode = DC_PRED, seg_pred = 0;
  uint8_t sub_modes[4] = {0, 0, 0, 0};
  int8_t ref[2] = {INTRA, -1};
  Mv mv[4][2];          // per 4x4 sub-block (all four equal for >= 8x8)
};

// A loop-filter level's limits at 8 bits.
struct Thresh {
  uint8_t lim, mblim, hev;
};

struct Segmentation {
  bool enabled = false, update_map = false, temporal = false;
  bool abs_delta = false;
  uint8_t tree_probs[7] = {255, 255, 255, 255, 255, 255, 255};
  uint8_t pred_probs[3] = {255, 255, 255};
  bool feature[8][4] = {};
  int data[8][4] = {};
  bool active(int seg, int f) const { return enabled && feature[seg][f]; }
};

// The uncompressed header's fields for one frame.
struct Header {
  int profile = 0;
  bool show_existing = false;
  int existing_idx = 0;
  bool key = false, show = false, error_res = false, intra_only = false;
  int reset_context = 0;
  int refresh_flags = 0;
  int ref_idx[3] = {0, 0, 0};
  int w = 0, h = 0;
  bool allow_hp = false;
  int filter = EIGHTTAP;
  bool refresh_context = false, parallel = false;
  int context_idx = 0;
  int lf_level = 0, sharpness = 0;
  int base_q = 0, dq_y_dc = 0, dq_uv_dc = 0, dq_uv_ac = 0;
  bool lossless = false;
  int tile_cols_log2 = 0, tile_rows_log2 = 0;
  int header_size = 0;
  size_t uncompressed_size = 0;
  // The colour config of a keyframe or intra-only frame (an inter frame
  // keeps the last one's): bit depth, chroma subsampling, sRGB.
  int depth = 8, ss_x = 1, ss_y = 1;
  bool rgb = false;
  int color_range = 0, color_space = 0;
  // Per reference: scaled (another frame size than this frame's), the
  // 14-bit scale factors (x, y) and the 1/16-pel steps.
  bool scaled[3] = {false, false, false};
  int scale[3][2] = {}, step[3][2] = {};
};

}  // namespace

struct Vp9Decoder::State {
  // Persistent state.
  std::shared_ptr<Frame> slots[8];
  Probs contexts[4];
  Segmentation seg;
  int8_t lf_ref_deltas[4] = {1, 0, -1, -1};
  int8_t lf_mode_deltas[2] = {0, 0};
  bool lf_delta_enabled = false;
  int sign_bias[4] = {0, 0, 0, 0};
  int last_w = 0, last_h = 0;
  bool last_show = false, last_key = false, last_intra_only = false;
  bool have_key = false;
  // From the last keyframe or intra-only frame.
  int depth = 8, ss_x = 1, ss_y = 1;
  bool rgb = false;
  int color_range = 0, color_space = 0;
  std::vector<MvRef> prev_mvs, cur_mvs;
  std::vector<uint8_t> seg_map_last, seg_map_cur;
  // A packet's shown pictures after its first (next()).
  std::vector<Picture> pending;
  size_t next_pending = 0;

  // Per frame.
  Header hd;
  Probs fc;
  Counts counts;
  int tx_mode = ONLY_4X4;
  int ref_mode = SINGLE_REF;
  int comp_fixed_ref = ALTREF, comp_var_ref[2] = {LAST, GOLDEN};
  int mi_cols = 0, mi_rows = 0, sb_cols = 0;
  std::shared_ptr<Frame> cur;
  std::vector<ModeInfo> mi;             // mi_rows x mi_cols
  bool use_prev_mvs = false;
  int16_t dq[8][2][2];                  // [segment][plane type][dc, ac]
  // Contexts: above (frame width) and left (one superblock).
  std::vector<uint8_t> above_nz[3], above_part;
  uint8_t left_nz[3][16], left_part[8];
  int tile_col_start = 0, tile_col_end = 0;
  BoolDecoder bd;
  // Dequantised coefficients (8 bits: wrapped to 16 as libavcodec stores
  // them).
  alignas(16) int32_t coef[32 * 32] = {};
  int ssx(int p) const { return p ? hd.ss_x : 0; }
  int ssy(int p) const { return p ? hd.ss_y : 0; }

  void parse_header(const uint8_t* data, size_t n);
  void read_compressed_header();
  void setup_past_independence();
  void decode_frame(const uint8_t* data, size_t n, Picture& out, bool& shown);
  void write_picture(const Frame& f, Picture& out);
  void decode_tiles(const uint8_t* data, size_t n);
  void decode_partition(int row, int col, int bsize_sq);
  void decode_block(int row, int col, int bsize);
  // mode info
  void read_intra_frame_mode_info(ModeInfo& m, int row, int col);
  void read_inter_frame_mode_info(ModeInfo& m, int row, int col);
  int read_tx_size(const ModeInfo& m, int row, int col, bool allow_select);
  void read_inter_block(ModeInfo& m, int row, int col);
  void find_mv_refs(const ModeInfo& m, int row, int col, int ref_frame,
                    int block, Mv list[2]);
  Mv read_mv(const Mv& ref);
  int read_mv_component(int comp, bool use_hp);
  const ModeInfo* above(int row, int col) const {
    return row > 0 ? &mi[size_t(row - 1) * mi_cols + col] : nullptr;
  }
  const ModeInfo* left(int row, int col) const {
    return col > tile_col_start ? &mi[size_t(row) * mi_cols + col - 1]
                                : nullptr;
  }
  // reconstruction (P: the sample type, uint8_t or uint16_t)
  int decode_coefs(int plane, int x4, int y4, int tx, int tx_type,
                   bool is_inter, int seg, int max_x4, int max_y4);
  template <class P>
  void predict_intra(int plane, int x, int y, int tx, int mode,
                     bool have_left, bool have_above, bool have_right);
  template <class P>
  void predict_inter(const ModeInfo& m, int row, int col);
  template <class P>
  void reconstruct(int plane, int x, int y, int tx, int tx_type);
  template <class P>
  void decode_block_planes(ModeInfo& m, int row, int col, int bsize);
  // after the tiles
  template <class P>
  void loop_filter();
  template <class P>
  void filter_non420(int p, int sr, int sc, const uint8_t (*lvl)[4][2],
                     const Thresh* th);
  void adapt();
};

namespace {

// ---------------------------------------------- probability delta updates

int inv_recenter(int v, int m) {
  if (v > 2 * m) return v;
  return v & 1 ? m - ((v + 1) >> 1) : m + (v >> 1);
}

void diff_update(BoolDecoder& bd, uint8_t& prob) {
  if (!bd.read(252)) return;
  int d;
  if (!bd.literal(1)) {
    d = bd.literal(4);
  } else if (!bd.literal(1)) {
    d = bd.literal(4) + 16;
  } else if (!bd.literal(1)) {
    d = bd.literal(5) + 32;
  } else {
    int v = bd.literal(7);
    d = v < 65 ? v + 64 : (v << 1) - 1 + bd.literal(1);
  }
  d = kInvMap[clampi(d, 0, 253)];
  int m = prob - 1;
  prob = uint8_t((m << 1) <= 255 ? 1 + inv_recenter(d, m)
                                 : 255 - inv_recenter(d, 255 - 1 - m));
}

void mv_update(BoolDecoder& bd, uint8_t& prob) {
  if (bd.read(252)) prob = uint8_t((bd.literal(7) << 1) | 1);
}

}  // namespace

// ---------------------------------------------------------------- headers

void Vp9Decoder::State::setup_past_independence() {
  for (auto& f : seg.feature)
    for (bool& b : f) b = false;
  for (auto& d : seg.data)
    for (int& v : d) v = 0;
  seg.abs_delta = false;
  std::fill(seg_map_last.begin(), seg_map_last.end(), 0);
  std::fill(seg_map_cur.begin(), seg_map_cur.end(), 0);
  lf_ref_deltas[0] = 1;
  lf_ref_deltas[1] = 0;
  lf_ref_deltas[2] = lf_ref_deltas[3] = -1;
  lf_mode_deltas[0] = lf_mode_deltas[1] = 0;
  lf_delta_enabled = true;
  Probs d = default_probs();
  if (hd.key || hd.error_res || hd.reset_context == 3) {
    for (Probs& c : contexts) c = d;
  } else if (hd.reset_context == 2) {
    contexts[hd.context_idx] = d;
  }
  hd.context_idx = 0;
}

void Vp9Decoder::State::parse_header(const uint8_t* data, size_t n) {
  BitReader br(data, n);
  Header h;
  if (br.f(2) != 2) broken("VP9 frame marker is not 2");
  int lo = br.bit(), hi = br.bit();
  h.profile = (hi << 1) | lo;
  if (h.profile == 3 && br.bit()) broken("VP9 reserved bit set");
  h.show_existing = br.bit();
  if (h.show_existing) {
    h.existing_idx = br.f(3);
    hd = h;
    return;
  }
  h.key = br.bit() == 0;
  h.show = br.bit();
  h.error_res = br.bit();
  auto sync = [&] {
    if (br.f(8) != 0x49 || br.f(8) != 0x83 || br.f(8) != 0x42)
      broken("VP9 sync code is wrong");
  };
  // The colour config as libavcodec reads it (read_colorspace_details):
  // 10 or 12 bits in profiles 2 and 3; sampling in profiles 1 and 3,
  // where 4:2:0 is refused; sRGB (GBR 4:4:4, full range) in profiles 1
  // and 3 only.
  const std::string prof = "VP9 profile " + std::to_string(h.profile);
  auto color_config = [&] {
    h.depth = h.profile >= 2 ? (br.bit() ? 12 : 10) : 8;
    h.color_space = br.f(3);
    if (h.color_space == 7) {
      if (!(h.profile & 1))
        unsupported("VP9 colour space sRGB in profile " +
                    std::to_string(h.profile) +
                    " (libavcodec refuses it: only profiles 1 and 3 "
                    "carry RGB)");
      if (br.bit()) broken("VP9 reserved bit set after sRGB");
      h.rgb = true;
      h.ss_x = h.ss_y = 0;
      h.color_range = 1;
    } else {
      h.color_range = br.bit();
      if (h.profile & 1) {
        h.ss_x = br.bit();
        h.ss_y = br.bit();
        if (h.ss_x && h.ss_y)
          unsupported(prof + " with 4:2:0 sampling (libavcodec refuses "
                      "it)");
        if (br.bit()) broken("VP9 reserved bit set in the colour config");
      }
    }
  };
  auto frame_size = [&] {
    h.w = br.f(16) + 1;
    h.h = br.f(16) + 1;
  };
  auto render_size = [&] {
    if (br.bit()) br.f(32);                   // render size: not used
  };
  if (h.key) {
    sync();
    color_config();
    frame_size();
    render_size();
    h.refresh_flags = 0xFF;
  } else {
    h.intra_only = h.show ? false : br.bit();
    h.reset_context = h.error_res ? 0 : br.f(2);
    if (h.intra_only) {
      // Profile 0 carries no colour config: 8 bits, 4:2:0, and the
      // colour space and range libavcodec then sets (BT.601, limited).
      sync();
      if (h.profile > 0) {
        color_config();
      } else {
        h.color_space = 1;
        h.color_range = 0;
      }
      h.refresh_flags = br.f(8);
      frame_size();
      render_size();
    } else {
      if (!have_key) broken("VP9 inter frame before the first keyframe");
      h.depth = depth;
      h.ss_x = ss_x;
      h.ss_y = ss_y;
      h.rgb = rgb;
      h.color_space = color_space;
      h.color_range = color_range;
      h.refresh_flags = br.f(8);
      for (int i = 0; i < 3; ++i) {
        h.ref_idx[i] = br.f(3);
        sign_bias[LAST + i] = br.bit();
        if (!slots[h.ref_idx[i]])
          broken("VP9 frame refers to an empty slot");
      }
      bool found = false;
      for (int i = 0; i < 3 && !found; ++i) {
        if (br.bit()) {
          h.w = slots[h.ref_idx[i]]->w;
          h.h = slots[h.ref_idx[i]]->h;
          found = true;
        }
      }
      if (!found) frame_size();
      render_size();
      // Each reference: of this frame's sampling and depth, and within
      // the sizes the standard scales from (at most twice the frame's,
      // at least a sixteenth of it), as libavcodec checks them all.
      for (int i = 0; i < 3; ++i) {
        const Frame& r = *slots[h.ref_idx[i]];
        if (r.depth != h.depth || r.ss_x != h.ss_x || r.ss_y != h.ss_y)
          unsupported("VP9 reference of another bit depth or sampling");
        if (r.w == h.w && r.h == h.h) continue;
        if (2 * h.w < r.w || 2 * h.h < r.h || h.w > 16 * r.w ||
            h.h > 16 * r.h)
          unsupported("VP9 reference scaling beyond its range (a "
                      "reference more than twice the frame's size or "
                      "less than a sixteenth of it)");
        h.scaled[i] = true;
        h.scale[i][0] = (r.w << 14) / h.w;
        h.scale[i][1] = (r.h << 14) / h.h;
        h.step[i][0] = (16 * h.scale[i][0]) >> 14;
        h.step[i][1] = (16 * h.scale[i][1]) >> 14;
      }
      h.allow_hp = br.bit();
      if (br.bit()) {
        h.filter = SWITCHABLE;
      } else {
        const int lit[4] = {EIGHTTAP_SMOOTH, EIGHTTAP, EIGHTTAP_SHARP,
                            BILINEAR};
        h.filter = lit[br.f(2)];
      }
    }
  }
  if (!h.error_res) {
    h.refresh_context = br.bit();
    h.parallel = br.bit();
  } else {
    h.refresh_context = false;
    h.parallel = true;
  }
  h.context_idx = br.f(2);
  hd = h;
  mi_cols = (h.w + 7) >> 3;
  mi_rows = (h.h + 7) >> 3;
  sb_cols = (mi_cols + 7) >> 3;
  // A new frame size clears the segment map (libvpx's
  // vp9_init_context_buffers), as a keyframe does.
  if (seg_map_last.size() != size_t(mi_cols) * mi_rows || h.key ||
      h.w != last_w || h.h != last_h) {
    seg_map_last.assign(size_t(mi_cols) * mi_rows, 0);
    seg_map_cur.assign(size_t(mi_cols) * mi_rows, 0);
  }
  if (h.key || h.intra_only || h.error_res) setup_past_independence();
  // Loop filter.
  hd.lf_level = br.f(6);
  hd.sharpness = br.f(3);
  lf_delta_enabled = br.bit();
  if (lf_delta_enabled && br.bit()) {
    for (int i = 0; i < 4; ++i)
      if (br.bit()) lf_ref_deltas[i] = int8_t(br.s(6));
    for (int i = 0; i < 2; ++i)
      if (br.bit()) lf_mode_deltas[i] = int8_t(br.s(6));
  }
  // Quantiser.
  hd.base_q = br.f(8);
  auto delta = [&] { return br.bit() ? br.s(4) : 0; };
  hd.dq_y_dc = delta();
  hd.dq_uv_dc = delta();
  hd.dq_uv_ac = delta();
  hd.lossless = hd.base_q == 0 && !hd.dq_y_dc && !hd.dq_uv_dc &&
                !hd.dq_uv_ac;
  // Segmentation.
  seg.update_map = false;
  seg.enabled = br.bit();
  if (seg.enabled) {
    seg.update_map = br.bit();
    if (seg.update_map) {
      for (uint8_t& p : seg.tree_probs) p = uint8_t(br.bit() ? br.f(8) : 255);
      seg.temporal = br.bit();
      for (uint8_t& p : seg.pred_probs)
        p = uint8_t(seg.temporal && br.bit() ? br.f(8) : 255);
    }
    if (br.bit()) {
      seg.abs_delta = br.bit();
      const int bits[4] = {8, 6, 2, 0};
      for (int i = 0; i < 8; ++i)
        for (int j = 0; j < 4; ++j) {
          seg.feature[i][j] = br.bit();
          int v = 0;
          if (seg.feature[i][j]) {
            v = br.f(bits[j]);
            if (j < 2 && br.bit()) v = -v;
          }
          seg.data[i][j] = v;
        }
    }
  }
  // Tiles.
  int min_log2 = 0, max_log2 = 1;
  while ((64 << min_log2) < sb_cols) ++min_log2;
  while ((sb_cols >> max_log2) >= 4) ++max_log2;
  --max_log2;
  hd.tile_cols_log2 = min_log2;
  while (hd.tile_cols_log2 < max_log2 && br.bit()) ++hd.tile_cols_log2;
  hd.tile_rows_log2 = br.bit();
  if (hd.tile_rows_log2) hd.tile_rows_log2 += br.bit();
  hd.header_size = br.f(16);
  hd.uncompressed_size = br.bytes();
  if (!hd.header_size) broken("VP9 compressed header of size 0");
}

void Vp9Decoder::State::read_compressed_header() {
  BoolDecoder& b = bd;
  if (hd.lossless) {
    tx_mode = ONLY_4X4;
  } else {
    tx_mode = b.literal(2);
    if (tx_mode == ALLOW_32X32) tx_mode += b.literal(1);
  }
  if (tx_mode == TX_MODE_SELECT) {
    for (auto& p : fc.tx8) diff_update(b, p[0]);
    for (auto& p : fc.tx16)
      for (uint8_t& q : p) diff_update(b, q);
    for (auto& p : fc.tx32)
      for (uint8_t& q : p) diff_update(b, q);
  }
  for (int t = 0; t <= kTxModeMax[tx_mode]; ++t) {
    if (!b.literal(1)) continue;
    for (int i = 0; i < 2; ++i)
      for (int j = 0; j < 2; ++j)
        for (int k = 0; k < 6; ++k)
          for (int l = 0; l < (k ? 6 : 3); ++l)
            for (int m = 0; m < 3; ++m)
              diff_update(b, fc.coef[t][i][j][k][l][m]);
  }
  for (uint8_t& p : fc.skip) diff_update(b, p);
  if (hd.key || hd.intra_only) return;
  for (auto& p : fc.inter_mode)
    for (uint8_t& q : p) diff_update(b, q);
  if (hd.filter == SWITCHABLE)
    for (auto& p : fc.interp)
      for (uint8_t& q : p) diff_update(b, q);
  for (uint8_t& p : fc.is_inter) diff_update(b, p);
  // Reference mode.
  bool compound_allowed = false;
  for (int i = GOLDEN; i <= ALTREF; ++i)
    if (sign_bias[i] != sign_bias[LAST]) compound_allowed = true;
  ref_mode = SINGLE_REF;
  if (compound_allowed && b.literal(1))
    ref_mode = b.literal(1) ? REF_SELECT : COMPOUND_REF;
  if (sign_bias[LAST] == sign_bias[GOLDEN]) {
    comp_fixed_ref = ALTREF;
    comp_var_ref[0] = LAST;
    comp_var_ref[1] = GOLDEN;
  } else if (sign_bias[LAST] == sign_bias[ALTREF]) {
    comp_fixed_ref = GOLDEN;
    comp_var_ref[0] = LAST;
    comp_var_ref[1] = ALTREF;
  } else {
    comp_fixed_ref = LAST;
    comp_var_ref[0] = GOLDEN;
    comp_var_ref[1] = ALTREF;
  }
  if (ref_mode == REF_SELECT)
    for (uint8_t& p : fc.comp_mode) diff_update(b, p);
  if (ref_mode != COMPOUND_REF)
    for (auto& p : fc.single_ref) {
      diff_update(b, p[0]);
      diff_update(b, p[1]);
    }
  if (ref_mode != SINGLE_REF)
    for (uint8_t& p : fc.comp_ref) diff_update(b, p);
  for (auto& p : fc.y_mode)
    for (uint8_t& q : p) diff_update(b, q);
  for (auto& p : fc.partition)
    for (uint8_t& q : p) diff_update(b, q);
  for (uint8_t& p : fc.mv_joint) mv_update(b, p);
  for (MvComp& c : fc.mv) {
    mv_update(b, c.sign);
    for (uint8_t& p : c.classes) mv_update(b, p);
    mv_update(b, c.class0[0]);
    for (uint8_t& p : c.bits) mv_update(b, p);
  }
  for (MvComp& c : fc.mv) {
    for (auto& p : c.class0_fp)
      for (uint8_t& q : p) mv_update(b, q);
    for (uint8_t& p : c.fp) mv_update(b, p);
  }
  if (hd.allow_hp)
    for (MvComp& c : fc.mv) {
      mv_update(b, c.class0_hp);
      mv_update(b, c.hp);
    }
}

// ------------------------------------------------------------ mode info

namespace {

inline bool is_comp(const ModeInfo* m) { return m->ref[1] > INTRA; }

// The contexts of the reference syntax elements (libvpx's
// vp9_pred_common.c, which the specification follows).
int comp_mode_ctx(const ModeInfo* a, const ModeInfo* l, int fixed) {
  if (a && l) {
    if (!is_comp(a) && !is_comp(l))
      return (a->ref[0] == fixed) ^ (l->ref[0] == fixed);
    if (!is_comp(a)) return 2 + (a->ref[0] == fixed || !a->is_inter);
    if (!is_comp(l)) return 2 + (l->ref[0] == fixed || !l->is_inter);
    return 4;
  }
  if (a || l) {
    const ModeInfo* e = a ? a : l;
    return is_comp(e) ? 3 : e->ref[0] == fixed;
  }
  return 1;
}

int comp_ref_ctx(const ModeInfo* a, const ModeInfo* l, int fixed,
                 const int var[2], const int sign_bias[4]) {
  const int var_idx = !sign_bias[fixed];
  if (a && l) {
    bool ai = !a->is_inter, li = !l->is_inter;
    if (ai && li) return 2;
    if (ai || li) {
      const ModeInfo* e = ai ? l : a;
      if (!is_comp(e)) return 1 + 2 * (e->ref[0] != var[1]);
      return 1 + 2 * (e->ref[var_idx] != var[1]);
    }
    bool l_sg = !is_comp(l), a_sg = !is_comp(a);
    int vrfa = a_sg ? a->ref[0] : a->ref[var_idx];
    int vrfl = l_sg ? l->ref[0] : l->ref[var_idx];
    if (vrfa == vrfl && var[1] == vrfa) return 0;
    if (l_sg && a_sg) {
      if ((vrfa == fixed && vrfl == var[0]) ||
          (vrfl == fixed && vrfa == var[0]))
        return 4;
      return vrfa == vrfl ? 3 : 1;
    }
    if (l_sg || a_sg) {
      int vrfc = l_sg ? vrfa : vrfl;
      int rfs = a_sg ? vrfa : vrfl;
      if (vrfc == var[1] && rfs != var[1]) return 1;
      if (rfs == var[1] && vrfc != var[1]) return 2;
      return 4;
    }
    return vrfa == vrfl ? 4 : 2;
  }
  if (a || l) {
    const ModeInfo* e = a ? a : l;
    if (!e->is_inter) return 2;
    if (is_comp(e)) return 4 * (e->ref[var_idx] != var[1]);
    return 3 * (e->ref[0] != var[1]);
  }
  return 2;
}

int single_ref_p1_ctx(const ModeInfo* a, const ModeInfo* l) {
  if (a && l) {
    bool ai = !a->is_inter, li = !l->is_inter;
    if (ai && li) return 2;
    if (ai || li) {
      const ModeInfo* e = ai ? l : a;
      if (!is_comp(e)) return 4 * (e->ref[0] == LAST);
      return 1 + (e->ref[0] == LAST || e->ref[1] == LAST);
    }
    bool ac = is_comp(a), lc = is_comp(l);
    int a0 = a->ref[0], a1 = a->ref[1], l0 = l->ref[0], l1 = l->ref[1];
    if (ac && lc)
      return 1 + (a0 == LAST || a1 == LAST || l0 == LAST || l1 == LAST);
    if (ac || lc) {
      int rfs = !ac ? a0 : l0;
      int crf1 = ac ? a0 : l0, crf2 = ac ? a1 : l1;
      if (rfs == LAST) return 3 + (crf1 == LAST || crf2 == LAST);
      return crf1 == LAST || crf2 == LAST;
    }
    return 2 * (a0 == LAST) + 2 * (l0 == LAST);
  }
  if (a || l) {
    const ModeInfo* e = a ? a : l;
    if (!e->is_inter) return 2;
    if (!is_comp(e)) return 4 * (e->ref[0] == LAST);
    return 1 + (e->ref[0] == LAST || e->ref[1] == LAST);
  }
  return 2;
}

int single_ref_p2_ctx(const ModeInfo* a, const ModeInfo* l) {
  if (a && l) {
    bool ai = !a->is_inter, li = !l->is_inter;
    if (ai && li) return 2;
    if (ai || li) {
      const ModeInfo* e = ai ? l : a;
      if (!is_comp(e)) {
        if (e->ref[0] == LAST) return 3;
        return 4 * (e->ref[0] == GOLDEN);
      }
      return 1 + 2 * (e->ref[0] == GOLDEN || e->ref[1] == GOLDEN);
    }
    bool ac = is_comp(a), lc = is_comp(l);
    int a0 = a->ref[0], a1 = a->ref[1], l0 = l->ref[0], l1 = l->ref[1];
    if (ac && lc) {
      if (a0 == l0 && a1 == l1)
        return 3 * (a0 == GOLDEN || a1 == GOLDEN || l0 == GOLDEN ||
                    l1 == GOLDEN);
      return 2;
    }
    if (ac || lc) {
      int rfs = !ac ? a0 : l0;
      int crf1 = ac ? a0 : l0, crf2 = ac ? a1 : l1;
      if (rfs == GOLDEN) return 3 + (crf1 == GOLDEN || crf2 == GOLDEN);
      if (rfs == ALTREF) return crf1 == GOLDEN || crf2 == GOLDEN;
      return 1 + 2 * (crf1 == GOLDEN || crf2 == GOLDEN);
    }
    if (a0 == LAST && l0 == LAST) return 3;
    if (a0 == LAST || l0 == LAST) {
      int edge0 = a0 == LAST ? l0 : a0;
      return 4 * (edge0 == GOLDEN);
    }
    return 2 * (a0 == GOLDEN) + 2 * (l0 == GOLDEN);
  }
  if (a || l) {
    const ModeInfo* e = a ? a : l;
    if (!e->is_inter || (e->ref[0] == LAST && !is_comp(e))) return 2;
    if (!is_comp(e)) return 4 * (e->ref[0] == GOLDEN);
    return 3 * (e->ref[0] == GOLDEN || e->ref[1] == GOLDEN);
  }
  return 2;
}

inline bool use_mv_hp(const Mv& mv) {
  return (std::abs(mv.row) >> 3) < 8 && (std::abs(mv.col) >> 3) < 8;
}

inline void lower_precision(Mv& mv, bool allow_hp) {
  if (allow_hp && use_mv_hp(mv)) return;
  if (mv.row & 1) mv.row = int16_t(mv.row + (mv.row > 0 ? -1 : 1));
  if (mv.col & 1) mv.col = int16_t(mv.col + (mv.col > 0 ? -1 : 1));
}

}  // namespace

int Vp9Decoder::State::read_tx_size(const ModeInfo& m, int row, int col,
                                    bool allow_select) {
  int max = kMaxTx[m.size];
  if (!(allow_select && tx_mode == TX_MODE_SELECT && m.size >= B8X8))
    return std::min(max, int(kTxModeMax[tx_mode]));
  const ModeInfo *a = above(row, col), *l = left(row, col);
  int actx = a && !a->skip ? a->tx : max;
  int lctx = l && !l->skip ? l->tx : max;
  if (!l) lctx = actx;
  if (!a) actx = lctx;
  int ctx = (actx + lctx) > max;
  const uint8_t* p = max == TX_8X8 ? fc.tx8[ctx]
                     : max == TX_16X16 ? fc.tx16[ctx] : fc.tx32[ctx];
  int tx = bd.read(p[0]);
  if (tx != TX_4X4 && max >= TX_16X16) {
    tx += bd.read(p[1]);
    if (tx != TX_8X8 && max >= TX_32X32) tx += bd.read(p[2]);
  }
  if (max == TX_8X8) ++counts.tx8[ctx][tx];
  else if (max == TX_16X16) ++counts.tx16[ctx][tx];
  else ++counts.tx32[ctx][tx];
  return tx;
}

void Vp9Decoder::State::read_intra_frame_mode_info(ModeInfo& m, int row,
                                                   int col) {
  const ModeInfo *a = above(row, col), *l = left(row, col);
  m.seg = 0;
  if (seg.enabled && seg.update_map) {
    m.seg = uint8_t(bd.tree(kSegTree, seg.tree_probs));
    int xm = std::min<int>(kW8[m.size], mi_cols - col);
    int ym = std::min<int>(kH8[m.size], mi_rows - row);
    for (int y = 0; y < ym; ++y)
      for (int x = 0; x < xm; ++x)
        seg_map_cur[size_t(row + y) * mi_cols + col + x] = m.seg;
  }
  if (seg.active(m.seg, SEG_SKIP)) {
    m.skip = 1;
  } else {
    int ctx = (a ? a->skip : 0) + (l ? l->skip : 0);
    m.skip = uint8_t(bd.read(fc.skip[ctx]));
    ++counts.skip[ctx][m.skip];
  }
  m.tx = uint8_t(read_tx_size(m, row, col, true));
  m.is_inter = 0;
  m.ref[0] = INTRA;
  m.ref[1] = -1;
  auto above_mode = [&](int i) {
    if (i >= 2) return int(m.sub_modes[i - 2]);
    return a && !a->is_inter ? int(a->sub_modes[i + 2]) : int(DC_PRED);
  };
  auto left_mode = [&](int i) {
    if (i & 1) return int(m.sub_modes[i - 1]);
    return l && !l->is_inter ? int(l->sub_modes[i + 1]) : int(DC_PRED);
  };
  if (m.size >= B8X8) {
    m.mode = uint8_t(bd.tree(kIntraTree,
                             kKfYMode[above_mode(0)][left_mode(0)]));
    for (uint8_t& s : m.sub_modes) s = m.mode;
  } else {
    int w4 = kW4[m.size], h4 = kH4[m.size];
    for (int y = 0; y < 2; y += h4)
      for (int x = 0; x < 2; x += w4) {
        int i = y * 2 + x;
        uint8_t b = uint8_t(bd.tree(kIntraTree,
                                    kKfYMode[above_mode(i)][left_mode(i)]));
        m.sub_modes[i] = b;
        if (h4 == 2) m.sub_modes[i + 2] = b;
        if (w4 == 2) m.sub_modes[i + 1] = b;
      }
    m.mode = m.sub_modes[3];
  }
  m.uv_mode = uint8_t(bd.tree(kIntraTree, kKfUvMode[m.mode]));
  m.filter = 3;
}

void Vp9Decoder::State::read_inter_frame_mode_info(ModeInfo& m, int row,
                                                   int col) {
  const ModeInfo *a = above(row, col), *l = left(row, col);
  // Segment id.
  m.seg = 0;
  m.seg_pred = 0;
  if (seg.enabled) {
    int xm = std::min<int>(kW8[m.size], mi_cols - col);
    int ym = std::min<int>(kH8[m.size], mi_rows - row);
    int pred = 8;
    for (int y = 0; y < ym; ++y)
      for (int x = 0; x < xm; ++x)
        pred = std::min<int>(pred,
                             seg_map_last[size_t(row + y) * mi_cols + col + x]);
    if (!seg.update_map) {
      for (int y = 0; y < ym; ++y)
        for (int x = 0; x < xm; ++x) {
          size_t i = size_t(row + y) * mi_cols + col + x;
          seg_map_cur[i] = seg_map_last[i];
        }
      m.seg = uint8_t(pred);
    } else {
      if (seg.temporal) {
        int ctx = (a ? a->seg_pred : 0) + (l ? l->seg_pred : 0);
        m.seg_pred = uint8_t(bd.read(seg.pred_probs[ctx]));
        m.seg = m.seg_pred ? uint8_t(pred)
                           : uint8_t(bd.tree(kSegTree, seg.tree_probs));
      } else {
        m.seg = uint8_t(bd.tree(kSegTree, seg.tree_probs));
      }
      for (int y = 0; y < ym; ++y)
        for (int x = 0; x < xm; ++x)
          seg_map_cur[size_t(row + y) * mi_cols + col + x] = m.seg;
    }
  }
  // Skip.
  if (seg.active(m.seg, SEG_SKIP)) {
    m.skip = 1;
  } else {
    int ctx = (a ? a->skip : 0) + (l ? l->skip : 0);
    m.skip = uint8_t(bd.read(fc.skip[ctx]));
    ++counts.skip[ctx][m.skip];
  }
  // Intra or inter.
  if (seg.active(m.seg, SEG_REF)) {
    m.is_inter = seg.data[m.seg][SEG_REF] != INTRA;
  } else {
    int ctx;
    if (a && l) {
      bool ai = !a->is_inter, li = !l->is_inter;
      ctx = ai && li ? 3 : (ai || li);
    } else if (a || l) {
      ctx = 2 * !(a ? a : l)->is_inter;
    } else {
      ctx = 0;
    }
    m.is_inter = uint8_t(bd.read(fc.is_inter[ctx]));
    ++counts.is_inter[ctx][m.is_inter];
  }
  m.tx = uint8_t(read_tx_size(m, row, col, !m.skip || !m.is_inter));
  if (m.is_inter) {
    read_inter_block(m, row, col);
    return;
  }
  m.ref[0] = INTRA;
  m.ref[1] = -1;
  m.filter = 3;
  if (m.size >= B8X8) {
    int g = kSizeGroup[m.size];
    m.mode = uint8_t(bd.tree(kIntraTree, fc.y_mode[g]));
    ++counts.y_mode[g][m.mode];
    for (uint8_t& s : m.sub_modes) s = m.mode;
  } else {
    int w4 = kW4[m.size], h4 = kH4[m.size];
    for (int y = 0; y < 2; y += h4)
      for (int x = 0; x < 2; x += w4) {
        int i = y * 2 + x;
        uint8_t b = uint8_t(bd.tree(kIntraTree, fc.y_mode[0]));
        ++counts.y_mode[0][b];
        m.sub_modes[i] = b;
        if (h4 == 2) m.sub_modes[i + 2] = b;
        if (w4 == 2) m.sub_modes[i + 1] = b;
      }
    m.mode = m.sub_modes[3];
  }
  m.uv_mode = uint8_t(bd.tree(kIntraTree, fc.uv_mode[m.mode]));
  ++counts.uv_mode[m.mode][m.uv_mode];
}

// find_mv_refs (libvpx's vp9_mvref_common.c): up to two distinct MV
// candidates for `ref_frame`, from the neighbours, the previous frame's
// MVs and neighbours of other references; `block` >= 0 takes the nearest
// two neighbours' sub-block MVs.
void Vp9Decoder::State::find_mv_refs(const ModeInfo& m, int row, int col,
                                     int ref_frame, int block, Mv list[2]) {
  list[0] = list[1] = Mv();
  int count = 0;
  bool different_ref = false;
  const int8_t(*pos)[2] = kMvRefs[m.size];
  auto inside = [&](int k) {
    int r = row + pos[k][0], c = col + pos[k][1];
    return r >= 0 && r < mi_rows && c >= tile_col_start && c < tile_col_end;
  };
  auto cand = [&](int k) -> const ModeInfo& {
    return mi[size_t(row + pos[k][0]) * mi_cols + col + pos[k][1]];
  };
  // Add `mv`; true when the list is full.
  auto add = [&](const Mv& mv) {
    if (count) {
      if (mv != list[0]) {
        list[1] = mv;
        count = 2;
        return true;
      }
      return false;
    }
    list[count++] = mv;
    return false;
  };
  auto sub_mv = [&](const ModeInfo& c, int which, int k) {
    if (block >= 0 && c.size < B8X8)
      return c.mv[kSubblockOfCol[block][pos[k][1] == 0]][which];
    return c.mv[3][which];
  };
  const MvRef* prev = use_prev_mvs ? &prev_mvs[size_t(row) * mi_cols + col]
                                   : nullptr;
  auto scaled = [&](int ref, Mv mv) {
    if (sign_bias[ref] != sign_bias[ref_frame]) {
      mv.row = int16_t(-mv.row);
      mv.col = int16_t(-mv.col);
    }
    return mv;
  };
  bool done = false;
  for (int k = 0; k < 2 && !done; ++k) {
    if (!inside(k)) continue;
    const ModeInfo& c = cand(k);
    different_ref = true;
    if (c.ref[0] == ref_frame) done = add(sub_mv(c, 0, k));
    else if (c.ref[1] == ref_frame) done = add(sub_mv(c, 1, k));
  }
  for (int k = 2; k < 8 && !done; ++k) {
    if (!inside(k)) continue;
    const ModeInfo& c = cand(k);
    different_ref = true;
    if (c.ref[0] == ref_frame) done = add(c.mv[3][0]);
    else if (c.ref[1] == ref_frame) done = add(c.mv[3][1]);
  }
  if (!done && prev) {
    if (prev->ref[0] == ref_frame) done = add(prev->mv[0]);
    else if (prev->ref[1] == ref_frame) done = add(prev->mv[1]);
  }
  if (!done && different_ref) {
    for (int k = 0; k < 8 && !done; ++k) {
      if (!inside(k)) continue;
      const ModeInfo& c = cand(k);
      if (!c.is_inter) continue;
      if (c.ref[0] != ref_frame) done = add(scaled(c.ref[0], c.mv[3][0]));
      if (!done && is_comp(&c) && c.ref[1] != ref_frame &&
          c.mv[3][1] != c.mv[3][0])
        done = add(scaled(c.ref[1], c.mv[3][1]));
    }
  }
  if (!done && prev) {
    if (prev->ref[0] != ref_frame && prev->ref[0] > INTRA)
      done = add(scaled(prev->ref[0], prev->mv[0]));
    if (!done && prev->ref[1] > INTRA && prev->ref[1] != ref_frame &&
        prev->mv[1] != prev->mv[0])
      done = add(scaled(prev->ref[1], prev->mv[1]));
  }
  // clamp_mv_ref: 16 pixels beyond the frame's 8x8-aligned edges.
  int bw = kW8[m.size], bh = kH8[m.size];
  int to_left = -col * 64, to_right = (mi_cols - bw - col) * 64;
  int to_top = -row * 64, to_bottom = (mi_rows - bh - row) * 64;
  for (int i = 0; i < 2; ++i) {
    list[i].col = int16_t(clampi(list[i].col, to_left - 128, to_right + 128));
    list[i].row = int16_t(clampi(list[i].row, to_top - 128, to_bottom + 128));
  }
}

int Vp9Decoder::State::read_mv_component(int i, bool use_hp) {
  const MvComp& c = fc.mv[i];
  MvCompCounts& n = counts.mv[i];
  int sign = bd.read(c.sign);
  int cls = bd.tree(kMvClassTree, c.classes);
  int d, fr, hp, mag;
  if (cls == 0) {
    d = bd.read(c.class0[0]);
    fr = bd.tree(kMvFpTree, c.class0_fp[d]);
    hp = use_hp ? bd.read(c.class0_hp) : 1;
    mag = 0;
    ++n.class0[d];
    ++n.class0_fp[d][fr];
    ++n.class0_hp[hp];
  } else {
    d = 0;
    for (int k = 0; k < cls; ++k) {
      int b = bd.read(c.bits[k]);
      d |= b << k;
      ++n.bits[k][b];
    }
    fr = bd.tree(kMvFpTree, c.fp);
    hp = use_hp ? bd.read(c.hp) : 1;
    mag = 2 << (cls + 2);
    ++n.fp[fr];
    ++n.hp[hp];
  }
  ++n.sign[sign];
  ++n.classes[cls];
  mag += ((d << 3) | (fr << 1) | hp) + 1;
  return sign ? -mag : mag;
}

Mv Vp9Decoder::State::read_mv(const Mv& ref) {
  int joint = bd.tree(kMvJointTree, fc.mv_joint);
  ++counts.mv_joint[joint];
  bool use_hp = hd.allow_hp && use_mv_hp(ref);
  Mv mv = ref;
  if (joint == 2 || joint == 3)
    mv.row = int16_t(mv.row + read_mv_component(0, use_hp));
  if (joint == 1 || joint == 3)
    mv.col = int16_t(mv.col + read_mv_component(1, use_hp));
  return mv;
}

void Vp9Decoder::State::read_inter_block(ModeInfo& m, int row, int col) {
  const ModeInfo *a = above(row, col), *l = left(row, col);
  // References.
  if (seg.active(m.seg, SEG_REF)) {
    m.ref[0] = int8_t(seg.data[m.seg][SEG_REF]);
    m.ref[1] = -1;
  } else {
    bool comp = ref_mode == COMPOUND_REF;
    if (ref_mode == REF_SELECT) {
      int ctx = comp_mode_ctx(a, l, comp_fixed_ref);
      comp = bd.read(fc.comp_mode[ctx]);
      ++counts.comp_mode[ctx][comp];
    }
    if (comp) {
      int idx = sign_bias[comp_fixed_ref];
      int ctx = comp_ref_ctx(a, l, comp_fixed_ref, comp_var_ref, sign_bias);
      int bit = bd.read(fc.comp_ref[ctx]);
      ++counts.comp_ref[ctx][bit];
      m.ref[idx] = int8_t(comp_fixed_ref);
      m.ref[!idx] = int8_t(comp_var_ref[bit]);
    } else {
      int ctx = single_ref_p1_ctx(a, l);
      int bit = bd.read(fc.single_ref[ctx][0]);
      ++counts.single_ref[ctx][0][bit];
      if (bit) {
        int ctx2 = single_ref_p2_ctx(a, l);
        int bit2 = bd.read(fc.single_ref[ctx2][1]);
        ++counts.single_ref[ctx2][1][bit2];
        m.ref[0] = int8_t(bit2 ? ALTREF : GOLDEN);
      } else {
        m.ref[0] = LAST;
      }
      m.ref[1] = -1;
    }
  }
  const int nrefs = 1 + is_comp(&m);
  // The inter mode context: the nearest two neighbours' modes.
  int counter = 0;
  for (int k = 0; k < 2; ++k) {
    int r = row + kMvRefs[m.size][k][0], c = col + kMvRefs[m.size][k][1];
    if (r >= 0 && r < mi_rows && c >= tile_col_start && c < tile_col_end)
      counter += kMode2Counter[mi[size_t(r) * mi_cols + c].mode];
  }
  const int mctx = kCounterToCtx[counter];
  auto read_mode = [&] {
    int v = bd.tree(kInterModeTree, fc.inter_mode[mctx]);
    ++counts.inter_mode[mctx][v];
    return NEARESTMV + v;
  };
  if (seg.active(m.seg, SEG_SKIP)) {
    if (m.size < B8X8)
      broken("VP9 segment skip feature on a block smaller than 8x8");
    m.mode = ZEROMV;
  } else if (m.size >= B8X8) {
    m.mode = uint8_t(read_mode());
  }
  if (hd.filter == SWITCHABLE) {
    int lt = l && l->is_inter ? l->filter : 3;
    int at = a && a->is_inter ? a->filter : 3;
    int ctx = lt == at ? lt : lt == 3 ? at : at == 3 ? lt : 3;
    m.filter = uint8_t(bd.tree(kInterpTree, fc.interp[ctx]));
    ++counts.interp[ctx][m.filter];
  } else {
    m.filter = uint8_t(hd.filter);
  }
  // The block's best MVs (nearest, lowered to the frame's precision).
  Mv best[2], nearest[2], nearv[2];
  bool have_best = false;
  auto block_mvs = [&] {
    if (have_best) return;
    for (int r = 0; r < nrefs; ++r) {
      Mv list[2];
      find_mv_refs(m, row, col, m.ref[r], -1, list);
      for (Mv& v : list) lower_precision(v, hd.allow_hp);
      nearest[r] = list[0];
      nearv[r] = list[1];
      best[r] = list[0];
    }
    have_best = true;
  };
  if (m.size < B8X8) {
    int w4 = kW4[m.size], h4 = kH4[m.size];
    int b = ZEROMV;
    for (int y = 0; y < 2; y += h4)
      for (int x = 0; x < 2; x += w4) {
        int j = y * 2 + x;
        b = read_mode();
        Mv mv[2];
        for (int r = 0; r < nrefs; ++r) {
          if (b == NEWMV) {
            block_mvs();
            mv[r] = read_mv(best[r]);
          } else if (b == NEARESTMV || b == NEARMV) {
            Mv list[2];
            find_mv_refs(m, row, col, m.ref[r], j, list);
            Mv ns, nr;
            if (j == 0) {
              ns = list[0];
              nr = list[1];
            } else if (j == 1 || j == 2) {
              ns = m.mv[0][r];
              for (int k = 0; k < 2; ++k)
                if (ns != list[k]) {
                  nr = list[k];
                  break;
                }
            } else {
              ns = m.mv[2][r];
              const Mv c4[4] = {m.mv[1][r], m.mv[0][r], list[0], list[1]};
              for (int k = 0; k < 4; ++k)
                if (ns != c4[k]) {
                  nr = c4[k];
                  break;
                }
            }
            mv[r] = b == NEARESTMV ? ns : nr;
          }
        }
        for (int r = 0; r < 2; ++r) {
          m.mv[j][r] = r < nrefs ? mv[r] : Mv();
          if (h4 == 2) m.mv[j + 2][r] = m.mv[j][r];
          if (w4 == 2) m.mv[j + 1][r] = m.mv[j][r];
        }
      }
    m.mode = uint8_t(b);
  } else {
    Mv mv[2];
    if (m.mode != ZEROMV) {
      block_mvs();
      for (int r = 0; r < nrefs; ++r)
        mv[r] = m.mode == NEWMV ? read_mv(best[r])
                : m.mode == NEARESTMV ? nearest[r] : nearv[r];
    }
    for (int k = 0; k < 4; ++k)
      for (int r = 0; r < 2; ++r) m.mv[k][r] = r < nrefs ? mv[r] : Mv();
  }
}

// ---------------------------------------------------------------- tokens

namespace {

// For each transform size and scan (default, row, column): the scan and,
// for each scan position, the raster positions of the two neighbours
// whose tokens give its context (libvpx's init_scan_neighbors).
struct ScanTables {
  const int16_t* scan[4][3];
  std::vector<int16_t> nb[4][3];
  ScanTables() {
    const int16_t* s[4][3] = {{kScan4[0], kScan4[1], kScan4[2]},
                              {kScan8[0], kScan8[1], kScan8[2]},
                              {kScan16[0], kScan16[1], kScan16[2]},
                              {kScan32, kScan32, kScan32}};
    for (int t = 0; t < 4; ++t)
      for (int k = 0; k < 3; ++k) {
        scan[t][k] = s[t][k];
        int w = 4 << t, n = w * w;
        std::vector<int16_t>& v = nb[t][k];
        v.assign(2 * n, 0);
        for (int c = 1; c < n; ++c) {
          int rc = s[t][k][c], i = rc / w, j = rc % w, a, b;
          if (i > 0 && j > 0) {
            if (k == 2 && t < 3) {
              a = b = (i - 1) * w + j;
            } else if (k == 1 && t < 3) {
              a = b = i * w + j - 1;
            } else {
              a = (i - 1) * w + j;
              b = i * w + j - 1;
            }
          } else if (i > 0) {
            a = b = (i - 1) * w + j;
          } else {
            a = b = i * w + j - 1;
          }
          v[2 * c] = int16_t(a);
          v[2 * c + 1] = int16_t(b);
        }
      }
  }
};

const ScanTables& scans() {
  static const ScanTables t;
  return t;
}

inline int scan_kind(int tx_type) {
  return tx_type == ADST_DCT ? 1 : tx_type == DCT_ADST ? 2 : 0;
}

}  // namespace

int Vp9Decoder::State::decode_coefs(int plane, int x4, int y4, int tx,
                                    int tx_type, bool is_inter, int segid,
                                    int max_x4, int max_y4) {
  const int n4 = 1 << tx;
  uint8_t* a = &above_nz[plane][x4];
  uint8_t* l = &left_nz[plane][y4 & ((16 >> ssy(plane)) - 1)];
  int actx = 0, lctx = 0;
  for (int i = 0; i < n4; ++i) {
    if (x4 + i < max_x4) actx |= a[i];
    if (y4 + i < max_y4) lctx |= l[i];
  }
  int ctx = actx + lctx;
  const int type = plane > 0;
  const uint8_t(*probs)[6][3] = fc.coef[tx][type][is_inter];
  unsigned(*cnt)[6][4] = counts.coef[tx][type][is_inter];
  unsigned(*eobc)[6] = counts.eob[tx][type][is_inter];
  const ScanTables& st = scans();
  const int kind = scan_kind(tx_type);
  const int16_t* scan = st.scan[tx][kind];
  const int16_t* nb = st.nb[tx][kind].data();
  const int16_t* dqs = dq[segid][type];
  const int shift = tx == TX_32X32;
  const int max_eob = 16 << (2 * tx);
  uint8_t cache[1024];
  int c = 0, dqv = dqs[0];
  auto band = [&](int i) {
    return tx == TX_4X4 ? kBand4[i] : i < 21 ? kBand8[i] : 5;
  };
  while (c < max_eob) {
    int bnd = band(c);
    const uint8_t* p = probs[bnd][ctx];
    ++eobc[bnd][ctx];
    if (!bd.read(p[0])) {
      ++cnt[bnd][ctx][3];
      break;
    }
    bool end = false;
    while (!bd.read(p[1])) {
      ++cnt[bnd][ctx][0];
      dqv = dqs[1];
      cache[scan[c]] = 0;
      if (++c >= max_eob) {
        end = true;
        break;
      }
      ctx = (1 + cache[nb[2 * c]] + cache[nb[2 * c + 1]]) >> 1;
      bnd = band(c);
      p = probs[bnd][ctx];
    }
    if (end) break;
    int token, val;
    if (!bd.read(p[2])) {
      ++cnt[bnd][ctx][1];
      token = 1;
      val = 1;
    } else {
      ++cnt[bnd][ctx][2];
      token = bd.tree(kTokenTree, kPareto[p[2] - 1]);
      if (token <= 4) {
        val = token;
      } else {
        int k = token - 5, e = 0;
        // CAT6 above 8 bits: depth - 8 more bits first, at 255.
        if (k == 5)
          for (int i = 8; i < hd.depth; ++i) e = (e << 1) | bd.read(255);
        for (int i = 0; i < kCatBits[k]; ++i)
          e = (e << 1) | bd.read(kCatProbs[k][i]);
        val = kCatBase[k] + e;
      }
    }
    // libavcodec: (±val · q) in 32 bits, halved toward zero at 32x32;
    // stored in 16 bits at 8 bits.
    int64_t v = (int64_t(val) * dqv) >> shift;
    int32_t sv = int32_t(uint32_t(bd.read(128) ? -v : v));
    coef[scan[c]] = hd.depth > 8 ? sv : int16_t(sv);
    cache[scan[c]] = kEnergy[token];
    ++c;
    if (c < max_eob) ctx = (1 + cache[nb[2 * c]] + cache[nb[2 * c + 1]]) >> 1;
    dqv = dqs[1];
  }
  const uint8_t nz = c > 0;
  for (int i = 0; i < n4; ++i) {
    a[i] = x4 + i < max_x4 ? nz : 0;
    l[i] = y4 + i < max_y4 ? nz : 0;
  }
  return c;
}

// ------------------------------------------------------------ transforms

namespace {

// cospi_k_64 = round(16384 · cos(kπ/64)); sinpi_k_9 for the 4-point ADST.
const int kC[33] = {16384, 16364, 16305, 16207, 16069, 15893, 15679, 15426,
                    15137, 14811, 14449, 14053, 13623, 13160, 12665, 12140,
                    11585, 11003, 10394, 9760,  9102,  8423,  7723,  7005,
                    6270,  5520,  4756,  3981,  3196,  2404,  1606,  804,
                    0};
const int kS1 = 5283, kS2 = 9929, kS3 = 13377, kS4 = 15212;

inline int rs(int64_t x) { return int((x + (1 << 13)) >> 14); }
// A butterfly rotation: (a·c1 − b·c2, a·c2 + b·c1), rounded.
template <class T>
inline void rot(int64_t a, int64_t b, int c1, int c2, T& o1, T& o2) {
  o1 = T(rs(a * c1 - b * c2));
  o2 = T(rs(a * c2 + b * c1));
}

template <class T>
void idct4(const int64_t* in, int64_t* out) {
  T s0, s1, s2, s3;
  s0 = T(rs(int64_t(in[0] + in[2]) * kC[16]));
  s1 = T(rs(int64_t(in[0] - in[2]) * kC[16]));
  rot(in[1], in[3], kC[24], kC[8], s2, s3);
  out[0] = s0 + s3;
  out[1] = s1 + s2;
  out[2] = s1 - s2;
  out[3] = s0 - s3;
}

void iadst4(const int64_t* in, int64_t* out) {
  int64_t x0 = in[0], x1 = in[1], x2 = in[2], x3 = in[3];
  if (!(x0 | x1 | x2 | x3)) {
    out[0] = out[1] = out[2] = out[3] = 0;
    return;
  }
  int64_t s0 = kS1 * x0, s1 = kS2 * x0, s2 = kS3 * x1, s3 = kS4 * x2;
  int64_t s4 = kS1 * x2, s5 = kS2 * x3, s6 = kS4 * x3;
  int64_t s7 = x0 - x2 + x3;
  s0 = s0 + s3 + s5;
  s1 = s1 - s4 - s6;
  s3 = s2;
  s2 = kS3 * s7;
  out[0] = rs(s0 + s3);
  out[1] = rs(s1 + s3);
  out[2] = rs(s2);
  out[3] = rs(s0 + s1 - s3);
}

template <class T>
void idct8(const int64_t* in, int64_t* out) {
  T s1[8], s2[8];
  s1[0] = T(in[0]);
  s1[2] = T(in[4]);
  s1[1] = T(in[2]);
  s1[3] = T(in[6]);
  rot(in[1], in[7], kC[28], kC[4], s1[4], s1[7]);
  rot(in[5], in[3], kC[12], kC[20], s1[5], s1[6]);
  s2[0] = T(rs(int64_t(s1[0] + s1[2]) * kC[16]));
  s2[1] = T(rs(int64_t(s1[0] - s1[2]) * kC[16]));
  rot(s1[1], s1[3], kC[24], kC[8], s2[2], s2[3]);
  s2[4] = T(s1[4] + s1[5]);
  s2[5] = T(s1[4] - s1[5]);
  s2[6] = T(-s1[6] + s1[7]);
  s2[7] = T(s1[6] + s1[7]);
  s1[0] = T(s2[0] + s2[3]);
  s1[1] = T(s2[1] + s2[2]);
  s1[2] = T(s2[1] - s2[2]);
  s1[3] = T(s2[0] - s2[3]);
  s1[4] = s2[4];
  s1[5] = T(rs(int64_t(s2[6] - s2[5]) * kC[16]));
  s1[6] = T(rs(int64_t(s2[5] + s2[6]) * kC[16]));
  s1[7] = s2[7];
  for (int i = 0; i < 4; ++i) {
    out[i] = s1[i] + s1[7 - i];
    out[7 - i] = s1[i] - s1[7 - i];
  }
}

void iadst8(const int64_t* in, int64_t* out) {
  int64_t x0 = in[7], x1 = in[0], x2 = in[5], x3 = in[2], x4 = in[3],
          x5 = in[4], x6 = in[1], x7 = in[6];
  if (!(x0 | x1 | x2 | x3 | x4 | x5 | x6 | x7)) {
    for (int i = 0; i < 8; ++i) out[i] = 0;
    return;
  }
  int64_t s0 = kC[2] * x0 + kC[30] * x1, s1 = kC[30] * x0 - kC[2] * x1;
  int64_t s2 = kC[10] * x2 + kC[22] * x3, s3 = kC[22] * x2 - kC[10] * x3;
  int64_t s4 = kC[18] * x4 + kC[14] * x5, s5 = kC[14] * x4 - kC[18] * x5;
  int64_t s6 = kC[26] * x6 + kC[6] * x7, s7 = kC[6] * x6 - kC[26] * x7;
  x0 = rs(s0 + s4);
  x1 = rs(s1 + s5);
  x2 = rs(s2 + s6);
  x3 = rs(s3 + s7);
  x4 = rs(s0 - s4);
  x5 = rs(s1 - s5);
  x6 = rs(s2 - s6);
  x7 = rs(s3 - s7);
  s0 = x0;
  s1 = x1;
  s2 = x2;
  s3 = x3;
  s4 = kC[8] * x4 + kC[24] * x5;
  s5 = kC[24] * x4 - kC[8] * x5;
  s6 = -kC[24] * x6 + kC[8] * x7;
  s7 = kC[8] * x6 + kC[24] * x7;
  x0 = s0 + s2;
  x1 = s1 + s3;
  x2 = s0 - s2;
  x3 = s1 - s3;
  x4 = rs(s4 + s6);
  x5 = rs(s5 + s7);
  x6 = rs(s4 - s6);
  x7 = rs(s5 - s7);
  s2 = kC[16] * (x2 + x3);
  s3 = kC[16] * (x2 - x3);
  s6 = kC[16] * (x6 + x7);
  s7 = kC[16] * (x6 - x7);
  x2 = rs(s2);
  x3 = rs(s3);
  x6 = rs(s6);
  x7 = rs(s7);
  out[0] = int(x0);
  out[1] = int(-x4);
  out[2] = int(x6);
  out[3] = int(-x2);
  out[4] = int(x3);
  out[5] = int(-x7);
  out[6] = int(x5);
  out[7] = int(-x1);
}

template <class T>
void idct16(const int64_t* in, int64_t* out) {
  T s1[16], s2[16];
  const int perm[16] = {0, 8, 4, 12, 2, 10, 6, 14, 1, 9, 5, 13, 3, 11, 7, 15};
  for (int i = 0; i < 16; ++i) s1[i] = T(in[perm[i]]);
  for (int i = 0; i < 8; ++i) s2[i] = s1[i];
  rot(s1[8], s1[15], kC[30], kC[2], s2[8], s2[15]);
  rot(s1[9], s1[14], kC[14], kC[18], s2[9], s2[14]);
  rot(s1[10], s1[13], kC[22], kC[10], s2[10], s2[13]);
  rot(s1[11], s1[12], kC[6], kC[26], s2[11], s2[12]);
  // stage 3
  for (int i = 0; i < 4; ++i) s1[i] = s2[i];
  rot(s2[4], s2[7], kC[28], kC[4], s1[4], s1[7]);
  rot(s2[5], s2[6], kC[12], kC[20], s1[5], s1[6]);
  s1[8] = T(s2[8] + s2[9]);
  s1[9] = T(s2[8] - s2[9]);
  s1[10] = T(-s2[10] + s2[11]);
  s1[11] = T(s2[10] + s2[11]);
  s1[12] = T(s2[12] + s2[13]);
  s1[13] = T(s2[12] - s2[13]);
  s1[14] = T(-s2[14] + s2[15]);
  s1[15] = T(s2[14] + s2[15]);
  // stage 4
  s2[0] = T(rs(int64_t(s1[0] + s1[1]) * kC[16]));
  s2[1] = T(rs(int64_t(s1[0] - s1[1]) * kC[16]));
  rot(s1[2], s1[3], kC[24], kC[8], s2[2], s2[3]);
  s2[4] = T(s1[4] + s1[5]);
  s2[5] = T(s1[4] - s1[5]);
  s2[6] = T(-s1[6] + s1[7]);
  s2[7] = T(s1[6] + s1[7]);
  s2[8] = s1[8];
  s2[15] = s1[15];
  s2[9] = T(rs(-int64_t(s1[9]) * kC[8] + int64_t(s1[14]) * kC[24]));
  s2[14] = T(rs(int64_t(s1[9]) * kC[24] + int64_t(s1[14]) * kC[8]));
  s2[10] = T(rs(-int64_t(s1[10]) * kC[24] - int64_t(s1[13]) * kC[8]));
  s2[13] = T(rs(-int64_t(s1[10]) * kC[8] + int64_t(s1[13]) * kC[24]));
  s2[11] = s1[11];
  s2[12] = s1[12];
  // stage 5
  s1[0] = T(s2[0] + s2[3]);
  s1[1] = T(s2[1] + s2[2]);
  s1[2] = T(s2[1] - s2[2]);
  s1[3] = T(s2[0] - s2[3]);
  s1[4] = s2[4];
  s1[5] = T(rs(int64_t(s2[6] - s2[5]) * kC[16]));
  s1[6] = T(rs(int64_t(s2[5] + s2[6]) * kC[16]));
  s1[7] = s2[7];
  s1[8] = T(s2[8] + s2[11]);
  s1[9] = T(s2[9] + s2[10]);
  s1[10] = T(s2[9] - s2[10]);
  s1[11] = T(s2[8] - s2[11]);
  s1[12] = T(-s2[12] + s2[15]);
  s1[13] = T(-s2[13] + s2[14]);
  s1[14] = T(s2[13] + s2[14]);
  s1[15] = T(s2[12] + s2[15]);
  // stage 6
  for (int i = 0; i < 4; ++i) {
    s2[i] = T(s1[i] + s1[7 - i]);
    s2[7 - i] = T(s1[i] - s1[7 - i]);
  }
  s2[8] = s1[8];
  s2[9] = s1[9];
  s2[10] = T(rs(int64_t(-s1[10] + s1[13]) * kC[16]));
  s2[13] = T(rs(int64_t(s1[10] + s1[13]) * kC[16]));
  s2[11] = T(rs(int64_t(-s1[11] + s1[12]) * kC[16]));
  s2[12] = T(rs(int64_t(s1[11] + s1[12]) * kC[16]));
  s2[14] = s1[14];
  s2[15] = s1[15];
  for (int i = 0; i < 8; ++i) {
    out[i] = s2[i] + s2[15 - i];
    out[15 - i] = s2[i] - s2[15 - i];
  }
}

void iadst16(const int64_t* in, int64_t* out) {
  int64_t x[16];
  const int perm[16] = {15, 0, 13, 2, 11, 4, 9, 6, 7, 8, 5, 10, 3, 12, 1, 14};
  int64_t any = 0;
  for (int i = 0; i < 16; ++i) any |= (x[i] = in[perm[i]]);
  if (!any) {
    for (int i = 0; i < 16; ++i) out[i] = 0;
    return;
  }
  int64_t s[16];
  // stage 1: rotations by odd angles
  const int c1[8] = {1, 5, 9, 13, 17, 21, 25, 29};
  for (int k = 0; k < 8; ++k) {
    int a = c1[k], b = 32 - a;
    s[2 * k] = x[2 * k] * kC[a] + x[2 * k + 1] * kC[b];
    s[2 * k + 1] = x[2 * k] * kC[b] - x[2 * k + 1] * kC[a];
  }
  for (int k = 0; k < 8; ++k) {
    x[k] = rs(s[k] + s[k + 8]);
    x[k + 8] = rs(s[k] - s[k + 8]);
  }
  // stage 2
  for (int k = 0; k < 8; ++k) s[k] = x[k];
  s[8] = x[8] * kC[4] + x[9] * kC[28];
  s[9] = x[8] * kC[28] - x[9] * kC[4];
  s[10] = x[10] * kC[20] + x[11] * kC[12];
  s[11] = x[10] * kC[12] - x[11] * kC[20];
  s[12] = -x[12] * kC[28] + x[13] * kC[4];
  s[13] = x[12] * kC[4] + x[13] * kC[28];
  s[14] = -x[14] * kC[12] + x[15] * kC[20];
  s[15] = x[14] * kC[20] + x[15] * kC[12];
  for (int k = 0; k < 4; ++k) {
    x[k] = s[k] + s[k + 4];
    x[k + 4] = s[k] - s[k + 4];
    x[k + 8] = rs(s[k + 8] + s[k + 12]);
    x[k + 12] = rs(s[k + 8] - s[k + 12]);
  }
  // stage 3
  for (int k : {0, 1, 2, 3, 8, 9, 10, 11}) s[k] = x[k];
  s[4] = x[4] * kC[8] + x[5] * kC[24];
  s[5] = x[4] * kC[24] - x[5] * kC[8];
  s[6] = -x[6] * kC[24] + x[7] * kC[8];
  s[7] = x[6] * kC[8] + x[7] * kC[24];
  s[12] = x[12] * kC[8] + x[13] * kC[24];
  s[13] = x[12] * kC[24] - x[13] * kC[8];
  s[14] = -x[14] * kC[24] + x[15] * kC[8];
  s[15] = x[14] * kC[8] + x[15] * kC[24];
  x[0] = s[0] + s[2];
  x[1] = s[1] + s[3];
  x[2] = s[0] - s[2];
  x[3] = s[1] - s[3];
  x[4] = rs(s[4] + s[6]);
  x[5] = rs(s[5] + s[7]);
  x[6] = rs(s[4] - s[6]);
  x[7] = rs(s[5] - s[7]);
  x[8] = s[8] + s[10];
  x[9] = s[9] + s[11];
  x[10] = s[8] - s[10];
  x[11] = s[9] - s[11];
  x[12] = rs(s[12] + s[14]);
  x[13] = rs(s[13] + s[15]);
  x[14] = rs(s[12] - s[14]);
  x[15] = rs(s[13] - s[15]);
  // stage 4
  s[2] = -kC[16] * (x[2] + x[3]);
  s[3] = kC[16] * (x[2] - x[3]);
  s[6] = kC[16] * (x[6] + x[7]);
  s[7] = kC[16] * (-x[6] + x[7]);
  s[10] = kC[16] * (x[10] + x[11]);
  s[11] = kC[16] * (-x[10] + x[11]);
  s[14] = -kC[16] * (x[14] + x[15]);
  s[15] = kC[16] * (x[14] - x[15]);
  for (int k : {2, 3, 6, 7, 10, 11, 14, 15}) x[k] = rs(s[k]);
  const int64_t o[16] = {x[0],  -x[8], x[12], -x[4], x[6],  x[14],
                         x[10], x[2],  x[3],  x[11], x[15], x[7],
                         x[5],  -x[13], x[9], -x[1]};
  for (int i = 0; i < 16; ++i) out[i] = int(o[i]);
}

template <class T>
void idct32(const int64_t* in, int64_t* out) {
  T s1[32], s2[32];
  const int perm[16] = {0, 16, 8, 24, 4, 20, 12, 28, 2, 18, 10, 26, 6, 22,
                        14, 30};
  for (int i = 0; i < 16; ++i) s1[i] = T(in[perm[i]]);
  // stage 1: odd inputs
  rot(in[1], in[31], kC[31], kC[1], s1[16], s1[31]);
  rot(in[17], in[15], kC[15], kC[17], s1[17], s1[30]);
  rot(in[9], in[23], kC[23], kC[9], s1[18], s1[29]);
  rot(in[25], in[7], kC[7], kC[25], s1[19], s1[28]);
  rot(in[5], in[27], kC[27], kC[5], s1[20], s1[27]);
  rot(in[21], in[11], kC[11], kC[21], s1[21], s1[26]);
  rot(in[13], in[19], kC[19], kC[13], s1[22], s1[25]);
  rot(in[29], in[3], kC[3], kC[29], s1[23], s1[24]);
  // stage 2
  for (int i = 0; i < 8; ++i) s2[i] = s1[i];
  rot(s1[8], s1[15], kC[30], kC[2], s2[8], s2[15]);
  rot(s1[9], s1[14], kC[14], kC[18], s2[9], s2[14]);
  rot(s1[10], s1[13], kC[22], kC[10], s2[10], s2[13]);
  rot(s1[11], s1[12], kC[6], kC[26], s2[11], s2[12]);
  for (int k = 16; k < 32; k += 4) {
    s2[k] = T(s1[k] + s1[k + 1]);
    s2[k + 1] = T(s1[k] - s1[k + 1]);
    s2[k + 2] = T(-s1[k + 2] + s1[k + 3]);
    s2[k + 3] = T(s1[k + 2] + s1[k + 3]);
  }
  // stage 3
  for (int i = 0; i < 4; ++i) s1[i] = s2[i];
  rot(s2[4], s2[7], kC[28], kC[4], s1[4], s1[7]);
  rot(s2[5], s2[6], kC[12], kC[20], s1[5], s1[6]);
  for (int k = 8; k < 16; k += 4) {
    s1[k] = T(s2[k] + s2[k + 1]);
    s1[k + 1] = T(s2[k] - s2[k + 1]);
    s1[k + 2] = T(-s2[k + 2] + s2[k + 3]);
    s1[k + 3] = T(s2[k + 2] + s2[k + 3]);
  }
  auto r2 = [](int64_t a, int64_t b, int ca, int cb) {
    return T(rs(a * ca + b * cb));
  };
  s1[16] = s2[16];
  s1[31] = s2[31];
  s1[17] = r2(s2[17], s2[30], -kC[4], kC[28]);
  s1[30] = r2(s2[17], s2[30], kC[28], kC[4]);
  s1[18] = r2(s2[18], s2[29], -kC[28], -kC[4]);
  s1[29] = r2(s2[18], s2[29], -kC[4], kC[28]);
  s1[19] = s2[19];
  s1[20] = s2[20];
  s1[21] = r2(s2[21], s2[26], -kC[20], kC[12]);
  s1[26] = r2(s2[21], s2[26], kC[12], kC[20]);
  s1[22] = r2(s2[22], s2[25], -kC[12], -kC[20]);
  s1[25] = r2(s2[22], s2[25], -kC[20], kC[12]);
  s1[23] = s2[23];
  s1[24] = s2[24];
  s1[27] = s2[27];
  s1[28] = s2[28];
  // stage 4
  s2[0] = T(rs(int64_t(s1[0] + s1[1]) * kC[16]));
  s2[1] = T(rs(int64_t(s1[0] - s1[1]) * kC[16]));
  rot(s1[2], s1[3], kC[24], kC[8], s2[2], s2[3]);
  s2[4] = T(s1[4] + s1[5]);
  s2[5] = T(s1[4] - s1[5]);
  s2[6] = T(-s1[6] + s1[7]);
  s2[7] = T(s1[6] + s1[7]);
  s2[8] = s1[8];
  s2[15] = s1[15];
  s2[9] = r2(s1[9], s1[14], -kC[8], kC[24]);
  s2[14] = r2(s1[9], s1[14], kC[24], kC[8]);
  s2[10] = r2(s1[10], s1[13], -kC[24], -kC[8]);
  s2[13] = r2(s1[10], s1[13], -kC[8], kC[24]);
  s2[11] = s1[11];
  s2[12] = s1[12];
  s2[16] = T(s1[16] + s1[19]);
  s2[17] = T(s1[17] + s1[18]);
  s2[18] = T(s1[17] - s1[18]);
  s2[19] = T(s1[16] - s1[19]);
  s2[20] = T(-s1[20] + s1[23]);
  s2[21] = T(-s1[21] + s1[22]);
  s2[22] = T(s1[21] + s1[22]);
  s2[23] = T(s1[20] + s1[23]);
  s2[24] = T(s1[24] + s1[27]);
  s2[25] = T(s1[25] + s1[26]);
  s2[26] = T(s1[25] - s1[26]);
  s2[27] = T(s1[24] - s1[27]);
  s2[28] = T(-s1[28] + s1[31]);
  s2[29] = T(-s1[29] + s1[30]);
  s2[30] = T(s1[29] + s1[30]);
  s2[31] = T(s1[28] + s1[31]);
  // stage 5
  s1[0] = T(s2[0] + s2[3]);
  s1[1] = T(s2[1] + s2[2]);
  s1[2] = T(s2[1] - s2[2]);
  s1[3] = T(s2[0] - s2[3]);
  s1[4] = s2[4];
  s1[5] = T(rs(int64_t(s2[6] - s2[5]) * kC[16]));
  s1[6] = T(rs(int64_t(s2[5] + s2[6]) * kC[16]));
  s1[7] = s2[7];
  s1[8] = T(s2[8] + s2[11]);
  s1[9] = T(s2[9] + s2[10]);
  s1[10] = T(s2[9] - s2[10]);
  s1[11] = T(s2[8] - s2[11]);
  s1[12] = T(-s2[12] + s2[15]);
  s1[13] = T(-s2[13] + s2[14]);
  s1[14] = T(s2[13] + s2[14]);
  s1[15] = T(s2[12] + s2[15]);
  s1[16] = s2[16];
  s1[17] = s2[17];
  s1[18] = r2(s2[18], s2[29], -kC[8], kC[24]);
  s1[29] = r2(s2[18], s2[29], kC[24], kC[8]);
  s1[19] = r2(s2[19], s2[28], -kC[8], kC[24]);
  s1[28] = r2(s2[19], s2[28], kC[24], kC[8]);
  s1[20] = r2(s2[20], s2[27], -kC[24], -kC[8]);
  s1[27] = r2(s2[20], s2[27], -kC[8], kC[24]);
  s1[21] = r2(s2[21], s2[26], -kC[24], -kC[8]);
  s1[26] = r2(s2[21], s2[26], -kC[8], kC[24]);
  s1[22] = s2[22];
  s1[23] = s2[23];
  s1[24] = s2[24];
  s1[25] = s2[25];
  s1[30] = s2[30];
  s1[31] = s2[31];
  // stage 6
  for (int i = 0; i < 4; ++i) {
    s2[i] = T(s1[i] + s1[7 - i]);
    s2[7 - i] = T(s1[i] - s1[7 - i]);
  }
  s2[8] = s1[8];
  s2[9] = s1[9];
  s2[10] = T(rs(int64_t(-s1[10] + s1[13]) * kC[16]));
  s2[13] = T(rs(int64_t(s1[10] + s1[13]) * kC[16]));
  s2[11] = T(rs(int64_t(-s1[11] + s1[12]) * kC[16]));
  s2[12] = T(rs(int64_t(s1[11] + s1[12]) * kC[16]));
  s2[14] = s1[14];
  s2[15] = s1[15];
  for (int i = 0; i < 4; ++i) {
    s2[16 + i] = T(s1[16 + i] + s1[23 - i]);
    s2[23 - i] = T(s1[16 + i] - s1[23 - i]);
    s2[24 + i] = T(-s1[24 + i] + s1[31 - i]);
    s2[31 - i] = T(s1[24 + i] + s1[31 - i]);
  }
  // stage 7
  for (int i = 0; i < 8; ++i) {
    s1[i] = T(s2[i] + s2[15 - i]);
    s1[15 - i] = T(s2[i] - s2[15 - i]);
  }
  for (int i = 16; i < 20; ++i) s1[i] = s2[i];
  for (int i = 0; i < 4; ++i) {
    s1[20 + i] = T(rs(int64_t(-s2[20 + i] + s2[27 - i]) * kC[16]));
    s1[27 - i] = T(rs(int64_t(s2[20 + i] + s2[27 - i]) * kC[16]));
  }
  for (int i = 28; i < 32; ++i) s1[i] = s2[i];
  for (int i = 0; i < 16; ++i) {
    out[i] = s1[i] + s1[31 - i];
    out[31 - i] = s1[i] - s1[31 - i];
  }
}

using Tx1d = void (*)(const int64_t*, int64_t*);

// Inverse transform of an n×n block of coefficients (row-major), added to
// `dst` and clipped to `bd` bits: rows, then columns, each output rounded
// by `shift` bits; between the passes the rows are kept in 16 bits at 8
// bits (libvpx's and libavcodec's int16 coefficients), else in 32.
template <class P>
void inverse_2d(const int32_t* coef, int n, Tx1d rows, Tx1d cols, int shift,
                P* dst, int stride, int bd) {
  int64_t tmp[32 * 32], in[32], out[32];
  for (int r = 0; r < n; ++r) {
    bool zero = true;
    for (int c = 0; c < n; ++c) {
      in[c] = coef[r * n + c];
      zero = zero && !in[c];
    }
    if (zero) {
      for (int c = 0; c < n; ++c) tmp[r * n + c] = 0;
      continue;
    }
    rows(in, out);
    for (int c = 0; c < n; ++c)
      tmp[r * n + c] = bd > 8 ? int64_t(int32_t(out[c])) : int16_t(out[c]);
  }
  for (int c = 0; c < n; ++c) {
    for (int r = 0; r < n; ++r) in[r] = tmp[r * n + c];
    cols(in, out);
    for (int r = 0; r < n; ++r) {
      P& d = dst[r * stride + c];
      d = clip_px<P>(d + int((out[r] + (1 << (shift - 1))) >> shift), bd);
    }
  }
}

template <class P>
void iwht4x4(const int32_t* coef, P* dst, int stride, int bd) {
  int out[16];
  for (int i = 0; i < 4; ++i) {
    const int32_t* ip = coef + 4 * i;
    int a = ip[0] >> 2, c = ip[1] >> 2, d = ip[2] >> 2, b = ip[3] >> 2;
    a += c;
    d -= b;
    int e = (a - d) >> 1;
    b = e - b;
    c = e - c;
    a -= b;
    d += c;
    out[4 * i] = a;
    out[4 * i + 1] = b;
    out[4 * i + 2] = c;
    out[4 * i + 3] = d;
  }
  for (int i = 0; i < 4; ++i) {
    int a = out[i], c = out[4 + i], d = out[8 + i], b = out[12 + i];
    a += c;
    d -= b;
    int e = (a - d) >> 1;
    b = e - b;
    c = e - c;
    a -= b;
    d += c;
    dst[i] = clip_px<P>(dst[i] + a, bd);
    dst[stride + i] = clip_px<P>(dst[stride + i] + b, bd);
    dst[2 * stride + i] = clip_px<P>(dst[2 * stride + i] + c, bd);
    dst[3 * stride + i] = clip_px<P>(dst[3 * stride + i] + d, bd);
  }
}

}  // namespace

template <class P>
void Vp9Decoder::State::reconstruct(int plane, int x, int y, int tx,
                                    int tx_type) {
  P* dst = cur->at<P>(plane, x, y);
  int stride = cur->stride[plane];
  int n = 4 << tx;
  const int bdp = hd.depth;
  // 16-bit intermediates at 8 bits (libvpx's), wide ones above.
  const bool narrow = bdp == 8;
  if (hd.lossless) {
    iwht4x4(coef, dst, stride, bdp);
  } else if (tx == TX_32X32) {
    Tx1d t = narrow ? idct32<int16_t> : idct32<int64_t>;
    inverse_2d(coef, 32, t, t, 6, dst, stride, bdp);
  } else {
    static const Tx1d dct8[3] = {idct4<int16_t>, idct8<int16_t>,
                                 idct16<int16_t>};
    static const Tx1d dct_wide[3] = {idct4<int64_t>, idct8<int64_t>,
                                     idct16<int64_t>};
    static const Tx1d adst[3] = {iadst4, iadst8, iadst16};
    const Tx1d* dct = narrow ? dct8 : dct_wide;
    // ADST_DCT: ADST on the columns (vertical), DCT on the rows.
    Tx1d cols = tx_type == ADST_DCT || tx_type == ADST_ADST ? adst[tx]
                                                            : dct[tx];
    Tx1d rows = tx_type == DCT_ADST || tx_type == ADST_ADST ? adst[tx]
                                                            : dct[tx];
    inverse_2d(coef, n, rows, cols, 4 + tx, dst, stride, bdp);
  }
  std::memset(coef, 0, sizeof(int32_t) * size_t(n) * n);
}

// ------------------------------------------------------------ prediction

namespace {

// The ten predictors of §8.5.1.2 from the edges `a` (a[-1] the corner,
// 2·bs pixels) and `left` (bs pixels), at `bd` bits (DC without edges:
// 1 << (bd − 1)).
template <class P>
void intra_pred(int mode, int bs, const P* a, const P* left, bool have_left,
                bool have_above, P* dst, int stride, int bd) {
  auto Pt = [&](int r, int c) -> P& { return dst[r * stride + c]; };
  auto avg2 = [](int p, int q) { return P((p + q + 1) >> 1); };
  auto avg3 = [](int p, int q, int r) { return P((p + 2 * q + r + 2) >> 2); };
  auto fill = [&](int r, P v) {
    for (int c = 0; c < bs; ++c) Pt(r, c) = v;
  };
  switch (mode) {
    case DC_PRED: {
      int sum = 0, cnt = 0;
      if (have_above) {
        for (int i = 0; i < bs; ++i) sum += a[i];
        cnt += bs;
      }
      if (have_left) {
        for (int i = 0; i < bs; ++i) sum += left[i];
        cnt += bs;
      }
      P v = P(cnt ? (sum + cnt / 2) / cnt : 1 << (bd - 1));
      for (int r = 0; r < bs; ++r) fill(r, v);
      break;
    }
    case V_PRED:
      for (int r = 0; r < bs; ++r)
        std::memcpy(&Pt(r, 0), a, sizeof(P) * size_t(bs));
      break;
    case H_PRED:
      for (int r = 0; r < bs; ++r) fill(r, left[r]);
      break;
    case TM_PRED:
      for (int r = 0; r < bs; ++r)
        for (int c = 0; c < bs; ++c)
          Pt(r, c) = clip_px<P>(left[r] + a[c] - a[-1], bd);
      break;
    case D45_PRED:
      for (int r = 0; r < bs; ++r)
        for (int c = 0; c < bs; ++c)
          Pt(r, c) = r + c + 2 < 2 * bs ? avg3(a[r + c], a[r + c + 1],
                                               a[r + c + 2])
                                        : a[2 * bs - 1];
      break;
    case D63_PRED:
      for (int r = 0; r < bs; ++r)
        for (int c = 0; c < bs; ++c) {
          int i = r / 2 + c;
          Pt(r, c) = r & 1 ? avg3(a[i], a[i + 1], a[i + 2])
                           : avg2(a[i], a[i + 1]);
        }
      break;
    case D207_PRED: {
      P col0[32], col1[32];
      for (int r = 0; r < bs - 1; ++r) col0[r] = avg2(left[r], left[r + 1]);
      col0[bs - 1] = left[bs - 1];
      for (int r = 0; r < bs - 2; ++r)
        col1[r] = avg3(left[r], left[r + 1], left[r + 2]);
      col1[bs - 2] = avg3(left[bs - 2], left[bs - 1], left[bs - 1]);
      col1[bs - 1] = left[bs - 1];
      for (int r = 0; r < bs; ++r) {
        Pt(r, 0) = col0[r];
        Pt(r, 1) = col1[r];
      }
      for (int c = 2; c < bs; ++c) Pt(bs - 1, c) = left[bs - 1];
      for (int r = bs - 2; r >= 0; --r)
        for (int c = 2; c < bs; ++c) Pt(r, c) = Pt(r + 1, c - 2);
      break;
    }
    case D135_PRED: {
      Pt(0, 0) = avg3(left[0], a[-1], a[0]);
      for (int c = 1; c < bs; ++c) Pt(0, c) = avg3(a[c - 2], a[c - 1], a[c]);
      Pt(1, 0) = avg3(a[-1], left[0], left[1]);
      for (int r = 2; r < bs; ++r)
        Pt(r, 0) = avg3(left[r - 2], left[r - 1], left[r]);
      for (int r = 1; r < bs; ++r)
        for (int c = 1; c < bs; ++c) Pt(r, c) = Pt(r - 1, c - 1);
      break;
    }
    case D117_PRED: {
      Pt(0, 0) = avg2(a[-1], a[0]);
      for (int c = 1; c < bs; ++c) Pt(0, c) = avg2(a[c - 1], a[c]);
      Pt(1, 0) = avg3(left[0], a[-1], a[0]);
      for (int c = 1; c < bs; ++c) Pt(1, c) = avg3(a[c - 2], a[c - 1], a[c]);
      Pt(2, 0) = avg3(a[-1], left[0], left[1]);
      for (int r = 3; r < bs; ++r)
        Pt(r, 0) = avg3(left[r - 3], left[r - 2], left[r - 1]);
      for (int r = 2; r < bs; ++r)
        for (int c = 1; c < bs; ++c) Pt(r, c) = Pt(r - 2, c - 1);
      break;
    }
    case D153_PRED: {
      Pt(0, 0) = avg2(left[0], a[-1]);
      for (int r = 1; r < bs; ++r) Pt(r, 0) = avg2(left[r - 1], left[r]);
      Pt(0, 1) = avg3(left[0], a[-1], a[0]);
      Pt(1, 1) = avg3(a[-1], left[0], left[1]);
      for (int r = 2; r < bs; ++r)
        Pt(r, 1) = avg3(left[r - 2], left[r - 1], left[r]);
      for (int c = 2; c < bs; ++c)
        Pt(0, c) = avg3(a[c - 3], a[c - 2], a[c - 1]);
      for (int r = 1; r < bs; ++r)
        for (int c = 2; c < bs; ++c) Pt(r, c) = Pt(r - 1, c - 2);
      break;
    }
  }
}

}  // namespace

// Intra prediction of one transform block at (x, y) of `plane` (§8.5.1 as
// libvpx builds its edges): above row and left column from the frame
// before the loop filter, 2^(bd−1) − 1 above the frame, 2^(bd−1) + 1 left
// of it (127 and 129 at 8 bits); pixels past the 8x8-aligned frame edge
// repeat the last one; above-right pixels only for 4x4 transforms not in
// the block's last column.
template <class P>
void Vp9Decoder::State::predict_intra(int plane, int x, int y, int tx,
                                      int mode, bool have_left,
                                      bool have_above, bool have_right) {
  const int bs = 4 << tx;
  const int stride = cur->stride[plane];
  P* dst = cur->at<P>(plane, x, y);
  const int fw = (mi_cols * 8) >> ssx(plane);
  const int fh = (mi_rows * 8) >> ssy(plane);
  const int base = 1 << (hd.depth - 1);
  P above_buf[64 + 1] = {}, left[32] = {};
  P* a = above_buf + 1;
  const bool need_left = mode != V_PRED && mode != D45_PRED &&
                         mode != D63_PRED;
  const bool need_above = mode != H_PRED && mode != D207_PRED;
  const bool need_ar = mode == D45_PRED || mode == D63_PRED;
  if (need_left) {
    if (have_left) {
      int n = std::min(bs, fh - y);
      for (int i = 0; i < bs; ++i)
        left[i] = dst[(i < n ? i : n - 1) * stride - 1];
    } else {
      for (int i = 0; i < bs; ++i) left[i] = P(base + 1);
    }
  }
  if (need_above || need_ar) {
    int want = need_ar ? 2 * bs : bs;
    if (have_above) {
      const P* ar = dst - stride;
      int avail = need_ar && have_right && bs == 4 ? 2 * bs : bs;
      avail = std::min(avail, fw - x);
      for (int i = 0; i < want; ++i) a[i] = ar[i < avail ? i : avail - 1];
      a[-1] = have_left ? ar[-1] : P(base + 1);
    } else {
      for (int i = 0; i < want; ++i) a[i] = P(base - 1);
      a[-1] = P(base - 1);
    }
  }
  intra_pred(mode, bs, a, left, have_left, have_above, dst, stride,
             hd.depth);
}

namespace {

// One prediction block from a reference: (x, y) and w×h in `plane`, the
// MV in 1/16 of the plane's pixels; the source read clamped to the
// reference's own size; the 8-tap filter horizontally (rounded, clipped
// to `bd` bits), then vertically; `avg` averages with what `dst` holds
// (the second of a compound pair).
template <class P>
void predict_block(const Frame& ref, int plane, int x, int y, int w, int h,
                   int mvx, int mvy, int filter, bool avg, P* dst,
                   int dstride, int bd) {
  const int16_t* fx = kFilters[filter][mvx & 15];
  const int16_t* fy = kFilters[filter][mvy & 15];
  const int x0 = x + (mvx >> 4) - 3, y0 = y + (mvy >> 4) - 3;
  const int cw = ref.crop_w(plane), ch = ref.crop_h(plane);
  const P* src = ref.data<P>(plane);
  const int sstride = ref.stride[plane];
  P mid[(64 + 7) * 64];
  int xs[64 + 7];
  for (int c = 0; c < w + 7; ++c) xs[c] = clampi(x0 + c, 0, cw - 1);
  for (int r = 0; r < h + 7; ++r) {
    const P* row = src + size_t(clampi(y0 + r, 0, ch - 1)) * sstride;
    for (int c = 0; c < w; ++c) {
      int s = 0;
      for (int k = 0; k < 8; ++k) s += row[xs[c + k]] * fx[k];
      mid[r * 64 + c] = clip_px<P>((s + 64) >> 7, bd);
    }
  }
  for (int r = 0; r < h; ++r)
    for (int c = 0; c < w; ++c) {
      int s = 0;
      for (int k = 0; k < 8; ++k) s += mid[(r + k) * 64 + c] * fy[k];
      P v = clip_px<P>((s + 64) >> 7, bd);
      P& d = dst[r * dstride + c];
      d = avg ? P((d + v + 1) >> 1) : v;
    }
}

// The same from a reference of another size (libvpx's vpx_scaled_2d,
// libavcodec's do_scaled_8tap): the block's top-left sample at (x0, y0)
// plus (sx, sy)/16 of the reference, each next output `xs`/`ys` 1/16 on;
// the filter always applied, reads clamped to the reference's size.
template <class P>
void predict_scaled(const Frame& ref, int plane, int x0, int y0, int sx,
                    int sy, int xs, int ys, int w, int h, int filter,
                    bool avg, P* dst, int dstride, int bd) {
  const int cw = ref.crop_w(plane), ch = ref.crop_h(plane);
  const P* src = ref.data<P>(plane);
  const int sstride = ref.stride[plane];
  const int rows = (((h - 1) * ys + sy) >> 4) + 8;
  P mid[64 * 135];
  for (int r = 0; r < rows; ++r) {
    const P* row = src + size_t(clampi(y0 - 3 + r, 0, ch - 1)) * sstride;
    for (int c = 0; c < w; ++c) {
      int pos = sx + c * xs;
      const int16_t* f = kFilters[filter][pos & 15];
      int x = x0 + (pos >> 4) - 3, s = 0;
      for (int k = 0; k < 8; ++k) s += row[clampi(x + k, 0, cw - 1)] * f[k];
      mid[r * 64 + c] = clip_px<P>((s + 64) >> 7, bd);
    }
  }
  for (int r = 0; r < h; ++r) {
    int pos = sy + r * ys;
    const int16_t* f = kFilters[filter][pos & 15];
    const P* m = mid + (pos >> 4) * 64;
    for (int c = 0; c < w; ++c) {
      int s = 0;
      for (int k = 0; k < 8; ++k) s += m[k * 64 + c] * f[k];
      P v = clip_px<P>((s + 64) >> 7, bd);
      P& d = dst[r * dstride + c];
      d = avg ? P((d + v + 1) >> 1) : v;
    }
  }
}

// libavcodec's ROUNDED_DIV of a sum of MVs.
inline int rounded_div(int a, int b) {
  return (a >= 0 ? a + (b >> 1) : a - (b >> 1)) / b;
}

}  // namespace

// Inter prediction of a block from its one or two references. A block of
// 8x8 or more is one prediction per plane; a smaller one is predicted in
// 4x4 pieces, each with its own MV (libvpx's dec_build_inter_predictors_sb:
// chroma pieces take the MVs of the luma pieces they cover, averaged,
// and in 4:2:2 the lower piece the average of the second and third, as
// libvpx does and libavcodec copies). From a scaled reference the MV is
// clamped to 4 pixels beyond the block's reach past the frame edge and
// the position scaled as libvpx scales it (the block's position and the
// MV separately, libavcodec's "BUG" comment; chroma positions from the
// luma block's).
template <class P>
void Vp9Decoder::State::predict_inter(const ModeInfo& m, int row, int col) {
  const int nrefs = 1 + is_comp(&m);
  const bool sub8 = m.size < B8X8;
  for (int r = 0; r < nrefs; ++r) {
    const int ri = m.ref[r] - 1;
    const Frame& ref = *slots[hd.ref_idx[ri]];
    const bool scaled = hd.scaled[ri];
    for (int p = 0; p < 3; ++p) {
      const int sx = ssx(p), sy = ssy(p);
      const int bx = (col * 8) >> sx, by = (row * 8) >> sy;   // block origin
      const int bw = sub8 ? 8 >> sx : (kW8[m.size] * 8) >> sx;
      const int bh = sub8 ? 8 >> sy : (kH8[m.size] * 8) >> sy;
      const int stride = cur->stride[p];
      // The pieces: (offset x, y, size w, h, luma 1/8-pel MV).
      auto piece = [&](int ox, int oy, int w, int h, Mv mv) {
        P* dst = cur->at<P>(p, bx + ox, by + oy);
        if (!scaled) {
          int mx = mv.col * (2 >> sx), my = mv.row * (2 >> sy);
          predict_block(ref, p, bx + ox, by + oy, w, h, mx, my, m.filter,
                        r > 0, dst, stride, hd.depth);
          return;
        }
        // clamp_mv_to_umv_border_sb, in 1/16 of the plane's pixels.
        const int bw8 = sub8 ? 1 : kW8[m.size], bh8 = sub8 ? 1 : kH8[m.size];
        int mcol = mv.col * (2 >> sx), mrow = mv.row * (2 >> sy);
        const int left = -col * 64 * (2 >> sx) - ((4 + bw) << 4);
        const int right = (mi_cols - bw8 - col) * 64 * (2 >> sx) +
                          ((4 + bw) << 4) - 16;
        const int top = -row * 64 * (2 >> sy) - ((4 + bh) << 4);
        const int bottom = (mi_rows - bh8 - row) * 64 * (2 >> sy) +
                           ((4 + bh) << 4) - 16;
        mcol = clampi(mcol, left, right);
        mrow = clampi(mrow, top, bottom);
        auto sc = [&](int64_t v, int d) {
          return int((v * hd.scale[ri][d]) >> 14);
        };
        // vp9_scale_mv at the luma position plus the piece's offset.
        const int fx = sc(mcol, 0) + (sc(int64_t(col * 8 + ox) << 4, 0) & 15);
        const int fy = sc(mrow, 1) + (sc(int64_t(row * 8 + oy) << 4, 1) & 15);
        const int x0 = sc(bx + ox, 0) + (fx >> 4);
        const int y0 = sc(by + oy, 1) + (fy >> 4);
        predict_scaled(ref, p, x0, y0, fx & 15, fy & 15, hd.step[ri][0],
                       hd.step[ri][1], w, h, m.filter, r > 0, dst, stride,
                       hd.depth);
      };
      if (!sub8) {
        piece(0, 0, bw, bh, m.mv[0][r]);
        continue;
      }
      // 4x4 pieces over the plane's 8x8-block area: 2x2 in luma, fewer
      // where chroma is subsampled.
      const int nw = 2 >> sx, nh = 2 >> sy;
      for (int j = 0; j < nh; ++j)
        for (int i = 0; i < nw; ++i) {
          const int k = j * nw + i;
          Mv mv;
          if (!sx && !sy) {
            mv = m.mv[k][r];
          } else if (sx && sy) {
            int sr = 0, sc2 = 0;
            for (int q = 0; q < 4; ++q) {
              sr += m.mv[q][r].row;
              sc2 += m.mv[q][r].col;
            }
            mv.row = int16_t(rounded_div(sr, 4));
            mv.col = int16_t(rounded_div(sc2, 4));
          } else {
            const Mv& a = m.mv[k][r];
            const Mv& b = m.mv[sy ? k + 2 : k + 1][r];
            mv.row = int16_t(rounded_div(a.row + b.row, 2));
            mv.col = int16_t(rounded_div(a.col + b.col, 2));
          }
          piece(4 * i, 4 * j, 4, 4, mv);
        }
    }
  }
}

// ---------------------------------------------------------------- blocks

// The block's residual and prediction, plane by plane: transform blocks
// of the luma size and of the chroma one (the largest square that the
// plane's block holds, at most the luma one), token contexts in 4x4
// units of each plane.
template <class P>
void Vp9Decoder::State::decode_block_planes(ModeInfo& m, int row, int col,
                                            int bsize) {
  const int bw = kW8[bsize], bh = kH8[bsize];
  const int xm = std::min(bw, mi_cols - col), ym = std::min(bh, mi_rows - row);
  auto store = [&] {
    for (int y = 0; y < ym; ++y)
      for (int x = 0; x < xm; ++x) mi[size_t(row + y) * mi_cols + col + x] = m;
  };
  store();
  const bool sub8 = bsize < B8X8;
  const int cw4 = std::max(kW4[bsize] >> hd.ss_x, 1);
  const int ch4 = std::max(kH4[bsize] >> hd.ss_y, 1);
  const int uv_tx = sub8 ? TX_4X4
                         : std::min<int>(m.tx,
                                         __builtin_ctz(std::min(cw4, ch4)));
  // Plane p's 4x4 units: the block's, its origin's, the frame's.
  auto units = [&](int p, int& n4w, int& n4h, int& x4, int& y4, int& lim_x,
                   int& lim_y) {
    n4w = (2 * bw) >> ssx(p);
    n4h = (2 * bh) >> ssy(p);
    x4 = (2 * col) >> ssx(p);
    y4 = (2 * row) >> ssy(p);
    lim_x = (2 * mi_cols) >> ssx(p);
    lim_y = (2 * mi_rows) >> ssy(p);
  };
  int n4w, n4h, x4, y4, lim_x, lim_y;
  if (m.skip) {
    for (int p = 0; p < 3; ++p) {
      units(p, n4w, n4h, x4, y4, lim_x, lim_y);
      std::memset(&above_nz[p][x4], 0, size_t(n4w));
      std::memset(&left_nz[p][y4 & ((16 >> ssy(p)) - 1)], 0, size_t(n4h));
    }
  }
  if (!m.is_inter) {
    for (int p = 0; p < 3; ++p) {
      int tx = p ? uv_tx : m.tx, step = 1 << tx;
      units(p, n4w, n4h, x4, y4, lim_x, lim_y);
      int maxw = std::min(n4w, lim_x - x4), maxh = std::min(n4h, lim_y - y4);
      for (int y = 0; y < maxh; y += step)
        for (int x = 0; x < maxw; x += step) {
          int mode = p ? m.uv_mode : sub8 ? m.sub_modes[(y << 1) + x] : m.mode;
          bool have_left = x > 0 || left(row, col) != nullptr;
          bool have_above = y > 0 || row > 0;
          bool have_right = x + step < n4w;
          predict_intra<P>(p, 4 * (x4 + x), 4 * (y4 + y), tx, mode,
                           have_left, have_above, have_right);
          if (m.skip) continue;
          int tx_type = p || hd.lossless || tx == TX_32X32
                            ? int(DCT_DCT)
                            : int(kIntraTxType[mode]);
          int eob = decode_coefs(p, x4 + x, y4 + y, tx, tx_type, false, m.seg,
                                 lim_x, lim_y);
          if (eob) reconstruct<P>(p, 4 * (x4 + x), 4 * (y4 + y), tx, tx_type);
        }
    }
  } else {
    predict_inter<P>(m, row, col);
    if (!m.skip) {
      int eobtotal = 0;
      for (int p = 0; p < 3; ++p) {
        int tx = p ? uv_tx : m.tx, step = 1 << tx;
        units(p, n4w, n4h, x4, y4, lim_x, lim_y);
        int maxw = std::min(n4w, lim_x - x4), maxh = std::min(n4h, lim_y - y4);
        for (int y = 0; y < maxh; y += step)
          for (int x = 0; x < maxw; x += step) {
            int eob = decode_coefs(p, x4 + x, y4 + y, tx, DCT_DCT, true,
                                   m.seg, lim_x, lim_y);
            eobtotal += eob;
            if (eob)
              reconstruct<P>(p, 4 * (x4 + x), 4 * (y4 + y), tx, DCT_DCT);
          }
      }
      if (!sub8 && !eobtotal) {
        m.skip = 1;
        store();
      }
    }
  }
}

void Vp9Decoder::State::decode_block(int row, int col, int bsize) {
  ModeInfo m;
  m.size = uint8_t(bsize);
  if (hd.key || hd.intra_only) read_intra_frame_mode_info(m, row, col);
  else read_inter_frame_mode_info(m, row, col);
  if (hd.depth > 8) decode_block_planes<uint16_t>(m, row, col, bsize);
  else decode_block_planes<uint8_t>(m, row, col, bsize);
  const int bw = kW8[bsize], bh = kH8[bsize];
  const int xm = std::min(bw, mi_cols - col), ym = std::min(bh, mi_rows - row);
  // The MVs the next frame's candidate lists read.
  for (int y = 0; y < ym; ++y)
    for (int x = 0; x < xm; ++x) {
      MvRef& r = cur_mvs[size_t(row + y) * mi_cols + col + x];
      r.ref[0] = m.ref[0];
      r.ref[1] = m.ref[1];
      r.mv[0] = m.mv[3][0];
      r.mv[1] = m.mv[3][1];
    }
}

void Vp9Decoder::State::decode_partition(int row, int col, int sq) {
  if (row >= mi_rows || col >= mi_cols) return;
  const int n8 = 1 << sq, hbs = n8 >> 1;
  const bool has_rows = row + hbs < mi_rows, has_cols = col + hbs < mi_cols;
  int a = (above_part[col] >> sq) & 1, l = (left_part[row & 7] >> sq) & 1;
  int ctx = l * 2 + a + sq * 4;
  const uint8_t* p = hd.key || hd.intra_only ? kKfPartition[ctx]
                                              : fc.partition[ctx];
  int part;
  if (has_rows && has_cols) part = bd.tree(kPartTree, p);
  else if (has_cols) part = bd.read(p[1]) ? PART_SPLIT : PART_HORZ;
  else if (has_rows) part = bd.read(p[2]) ? PART_SPLIT : PART_VERT;
  else part = PART_SPLIT;
  ++counts.partition[ctx][part];
  const int sub = kSubsize[part][sq];
  if (!hbs) {
    decode_block(row, col, sub);
  } else {
    switch (part) {
      case PART_NONE:
        decode_block(row, col, sub);
        break;
      case PART_HORZ:
        decode_block(row, col, sub);
        if (has_rows) decode_block(row + hbs, col, sub);
        break;
      case PART_VERT:
        decode_block(row, col, sub);
        if (has_cols) decode_block(row, col + hbs, sub);
        break;
      default:
        decode_partition(row, col, sq - 1);
        decode_partition(row, col + hbs, sq - 1);
        decode_partition(row + hbs, col, sq - 1);
        decode_partition(row + hbs, col + hbs, sq - 1);
    }
  }
  if (sq == 0 || part != PART_SPLIT) {
    std::memset(&above_part[col], kPartCtx[sub][0], size_t(n8));
    std::memset(&left_part[row & 7], kPartCtx[sub][1], size_t(n8));
  }
}

void Vp9Decoder::State::decode_tiles(const uint8_t* data, size_t n) {
  const int tile_cols = 1 << hd.tile_cols_log2;
  const int tile_rows = 1 << hd.tile_rows_log2;
  auto offset = [](int i, int mis, int log2) {
    int sbs = (mis + 7) >> 3;
    return std::min(((i * sbs) >> log2) << 3, mis);
  };
  for (int p = 0; p < 3; ++p) above_nz[p].assign(size_t(sb_cols) * 16, 0);
  above_part.assign(size_t(sb_cols) * 8, 0);
  size_t pos = 0;
  for (int tr = 0; tr < tile_rows; ++tr)
    for (int tc = 0; tc < tile_cols; ++tc) {
      bool last = tr == tile_rows - 1 && tc == tile_cols - 1;
      size_t size;
      if (last) {
        size = n - pos;
      } else {
        if (pos + 4 > n) broken("VP9 tile size cut short");
        size = (size_t(data[pos]) << 24) | (size_t(data[pos + 1]) << 16) |
               (size_t(data[pos + 2]) << 8) | data[pos + 3];
        pos += 4;
        if (size > n - pos) broken("VP9 tile runs past its frame");
      }
      bd.init(data + pos, size);
      pos += size;
      int r0 = offset(tr, mi_rows, hd.tile_rows_log2);
      int r1 = offset(tr + 1, mi_rows, hd.tile_rows_log2);
      tile_col_start = offset(tc, mi_cols, hd.tile_cols_log2);
      tile_col_end = offset(tc + 1, mi_cols, hd.tile_cols_log2);
      for (int row = r0; row < r1; row += 8) {
        std::memset(left_nz, 0, sizeof(left_nz));
        std::memset(left_part, 0, sizeof(left_part));
        for (int col = tile_col_start; col < tile_col_end; col += 8)
          decode_partition(row, col, 3);
      }
    }
}

// ----------------------------------------------------------- loop filter

namespace {

inline int8_t sclamp(int t) { return int8_t(clampi(t, -128, 127)); }

// One position of an edge: p[-k·pitch] are p(k−1), p[k·pitch] q(k)
// (libvpx's vpx_dsp/loopfilter.c at 8 bits; above, libavcodec's
// loop_filter: the thresholds and the flatness bound shifted by bd − 8,
// the filter clamped to bd − 1 signed bits).
template <class P>
void filter_at(P* s, int pitch, int width, const Thresh& t, int bd) {
  auto Pk = [&](int k) -> P& { return s[-(k + 1) * pitch]; };
  auto Qk = [&](int k) -> P& { return s[k * pitch]; };
  const int sh = bd - 8, one = 1 << sh;
  const int lim = t.lim << sh, mblim = t.mblim << sh, hevt = t.hev << sh;
  int p3 = Pk(3), p2 = Pk(2), p1 = Pk(1), p0 = Pk(0);
  int q0 = Qk(0), q1 = Qk(1), q2 = Qk(2), q3 = Qk(3);
  if (std::abs(p3 - p2) > lim || std::abs(p2 - p1) > lim ||
      std::abs(p1 - p0) > lim || std::abs(q1 - q0) > lim ||
      std::abs(q2 - q1) > lim || std::abs(q3 - q2) > lim ||
      std::abs(p0 - q0) * 2 + std::abs(p1 - q1) / 2 > mblim)
    return;
  auto flat4 = [&] {
    return std::abs(p1 - p0) <= one && std::abs(q1 - q0) <= one &&
           std::abs(p2 - p0) <= one && std::abs(q2 - q0) <= one &&
           std::abs(p3 - p0) <= one && std::abs(q3 - q0) <= one;
  };
  if (width >= 8 && flat4()) {
    bool flat2 = false;
    if (width == 16) {
      flat2 = true;
      for (int k = 4; k < 8 && flat2; ++k)
        flat2 = std::abs(Pk(k) - p0) <= one && std::abs(Qk(k) - q0) <= one;
    }
    if (flat2) {
      int v[16];
      for (int k = 0; k < 8; ++k) {
        v[7 - k] = Pk(k);
        v[8 + k] = Qk(k);
      }
      for (int i = 1; i < 15; ++i) {
        int sum = v[i];
        for (int j = i - 7; j <= i + 7; ++j) sum += v[clampi(j, 0, 15)];
        P o = P((sum + 8) >> 4);
        if (i < 8) Pk(7 - i) = o;
        else Qk(i - 8) = o;
      }
    } else {
      int v[8] = {p3, p2, p1, p0, q0, q1, q2, q3};
      for (int i = 1; i < 7; ++i) {
        int sum = v[i];
        for (int j = i - 3; j <= i + 3; ++j) sum += v[clampi(j, 0, 7)];
        P o = P((sum + 4) >> 3);
        if (i < 4) Pk(3 - i) = o;
        else Qk(i - 4) = o;
      }
    }
    return;
  }
  const bool hev = std::abs(p1 - p0) > hevt || std::abs(q1 - q0) > hevt;
  if (bd == 8) {
    int ps1 = p1 - 128, ps0 = p0 - 128, qs0 = q0 - 128, qs1 = q1 - 128;
    int f = hev ? sclamp(ps1 - qs1) : 0;
    f = sclamp(f + 3 * (qs0 - ps0));
    int f1 = sclamp(f + 4) >> 3, f2 = sclamp(f + 3) >> 3;
    Qk(0) = P(sclamp(qs0 - f1) + 128);
    Pk(0) = P(sclamp(ps0 + f2) + 128);
    if (!hev) {
      int g = (f1 + 1) >> 1;
      Qk(1) = P(sclamp(qs1 - g) + 128);
      Pk(1) = P(sclamp(ps1 + g) + 128);
    }
    return;
  }
  const int hi = (1 << (bd - 1)) - 1, lo = -(1 << (bd - 1));
  int f = hev ? clampi(p1 - q1, lo, hi) : 0;
  f = clampi(3 * (q0 - p0) + f, lo, hi);
  int f1 = std::min(f + 4, hi) >> 3, f2 = std::min(f + 3, hi) >> 3;
  Pk(0) = clip_px<P>(p0 + f2, bd);
  Qk(0) = clip_px<P>(q0 - f1, bd);
  if (!hev) {
    int g = (f1 + 1) >> 1;
    Pk(1) = clip_px<P>(p1 + g, bd);
    Qk(1) = clip_px<P>(q1 - g, bd);
  }
}

// An 8-pixel stretch of an edge: `s` at its first q0, `pitch` across the
// edge, `along` along it.
template <class P>
void filter_edge(P* s, int pitch, int along, int width, const Thresh& t,
                 int bd) {
  for (int i = 0; i < 8; ++i) filter_at(s + i * along, pitch, width, t, bd);
}

// libvpx's LOOP_FILTER_MASK of one superblock (vp9_loopfilter.c): per
// transform size, the 8x8 cells (bit row·8 + col; 4x4 cells of chroma,
// row·4 + col) whose left and top edges are filtered, the cells whose
// internal 4x4 edges are, and each luma cell's level.
struct LfMask {
  uint64_t left_y[4] = {}, above_y[4] = {}, int4_y = 0;
  uint16_t left_uv[4] = {}, above_uv[4] = {}, int4_uv = 0;
  uint8_t lfl_y[64] = {};
};

uint64_t rect_y(int w, int h) {
  uint64_t m = 0;
  for (int r = 0; r < h; ++r)
    for (int c = 0; c < w; ++c) m |= uint64_t(1) << (r * 8 + c);
  return m;
}
uint16_t rect_uv(int w, int h) {
  uint16_t m = 0;
  for (int r = 0; r < h; ++r)
    for (int c = 0; c < w; ++c) m = uint16_t(m | (1 << (r * 4 + c)));
  return m;
}

}  // namespace

template <class P>
void Vp9Decoder::State::loop_filter() {
  if (!hd.lf_level) return;
  const int bd = hd.depth;
  // Levels by segment, reference and mode (vp9_loop_filter_frame_init).
  uint8_t lvl[8][4][2];
  const int scale = 1 << (hd.lf_level >> 5);
  for (int s = 0; s < 8; ++s) {
    int ls = hd.lf_level;
    if (seg.active(s, SEG_ALT_LF)) {
      int d = seg.data[s][SEG_ALT_LF];
      ls = clampi(seg.abs_delta ? d : hd.lf_level + d, 0, 63);
    }
    if (!lf_delta_enabled) {
      std::memset(lvl[s], ls, sizeof(lvl[s]));
      continue;
    }
    lvl[s][INTRA][0] = lvl[s][INTRA][1] =
        uint8_t(clampi(ls + lf_ref_deltas[INTRA] * scale, 0, 63));
    for (int r = LAST; r <= ALTREF; ++r)
      for (int m = 0; m < 2; ++m)
        lvl[s][r][m] = uint8_t(clampi(
            ls + lf_ref_deltas[r] * scale + lf_mode_deltas[m] * scale, 0, 63));
  }
  Thresh th[64];
  for (int l = 0; l < 64; ++l) {
    int sh = hd.sharpness;
    int lim = l >> ((sh > 0) + (sh > 4));
    if (sh > 0) lim = std::min(lim, 9 - sh);
    lim = std::max(lim, 1);
    th[l] = {uint8_t(lim), uint8_t(2 * (l + 2) + lim), uint8_t(l >> 4)};
  }
  const uint64_t m64[4] = {~uint64_t(0), ~uint64_t(0),
                           0x5555555555555555ULL, 0x1111111111111111ULL};
  const uint64_t a64[4] = {~uint64_t(0), ~uint64_t(0),
                           0x00FF00FF00FF00FFULL, 0x000000FF000000FFULL};
  const uint16_t muv[4] = {0xFFFF, 0xFFFF, 0x5555, 0x1111};
  const uint16_t auv[4] = {0xFFFF, 0xFFFF, 0x0F0F, 0x000F};
  for (int sr = 0; sr < mi_rows; sr += 8)
    for (int sc = 0; sc < mi_cols; sc += 8) {
      LfMask lm;
      const int rows = std::min(8, mi_rows - sr), cols = std::min(8, mi_cols - sc);
      for (int r = 0; r < rows; ++r)
        for (int c = 0; c < cols; ++c) {
          const ModeInfo& m = mi[size_t(sr + r) * mi_cols + sc + c];
          int w8 = kW8[m.size], h8 = kH8[m.size];
          if ((sr + r) % h8 || (sc + c) % w8) continue;   // not its origin
          int level = lvl[m.seg][m.ref[0] > 0 ? m.ref[0] : 0]
                         [kModeLf[m.mode]];
          if (!level) continue;
          for (int y = 0; y < h8 && r + y < 8; ++y)
            for (int x = 0; x < w8 && c + x < 8; ++x)
              lm.lfl_y[(r + y) * 8 + c + x] = uint8_t(level);
          const int shift = r * 8 + c;
          const int tx = m.tx;
          const uint64_t size = rect_y(w8, h8);
          lm.above_y[tx] |= rect_y(w8, 1) << shift;
          lm.left_y[tx] |= rect_y(1, h8) << shift;
          bool uv = !(r & 1) && !(c & 1);
          int uv_tx = 0, shift_uv = (r / 2) * 4 + c / 2;
          int wu = std::max(1, w8 / 2), hu = std::max(1, h8 / 2);
          uint16_t size_uv = rect_uv(wu, hu);
          if (uv) {
            uv_tx = m.size < B8X8 ? 0
                    : std::min<int>(tx, __builtin_ctz(std::min(
                                            kW4[m.size], kH4[m.size])) - 1);
            lm.above_uv[uv_tx] |= uint16_t(rect_uv(wu, 1) << shift_uv);
            lm.left_uv[uv_tx] |= uint16_t(rect_uv(1, hu) << shift_uv);
          }
          if (m.skip && m.is_inter) continue;
          lm.above_y[tx] |= (size & a64[tx]) << shift;
          lm.left_y[tx] |= (size & m64[tx]) << shift;
          if (tx == TX_4X4) lm.int4_y |= size << shift;
          if (uv) {
            lm.above_uv[uv_tx] |= uint16_t((size_uv & auv[uv_tx]) << shift_uv);
            lm.left_uv[uv_tx] |= uint16_t((size_uv & muv[uv_tx]) << shift_uv);
            if (uv_tx == TX_4X4) lm.int4_uv |= uint16_t(size_uv << shift_uv);
          }
        }
      // vp9_setup_mask's adjustments.
      lm.left_y[TX_16X16] |= lm.left_y[TX_32X32];
      lm.above_y[TX_16X16] |= lm.above_y[TX_32X32];
      lm.left_uv[TX_16X16] |= lm.left_uv[TX_32X32];
      lm.above_uv[TX_16X16] |= lm.above_uv[TX_32X32];
      const uint64_t left_border = 0x1111111111111111ULL;
      const uint64_t above_border = 0x000000FF000000FFULL;
      lm.left_y[TX_8X8] |= lm.left_y[TX_4X4] & left_border;
      lm.left_y[TX_4X4] &= ~left_border;
      lm.above_y[TX_8X8] |= lm.above_y[TX_4X4] & above_border;
      lm.above_y[TX_4X4] &= ~above_border;
      lm.left_uv[TX_8X8] |= lm.left_uv[TX_4X4] & 0x1111;
      lm.left_uv[TX_4X4] &= ~0x1111;
      lm.above_uv[TX_8X8] |= lm.above_uv[TX_4X4] & 0x000F;
      lm.above_uv[TX_4X4] &= ~0x000F;
      if (rows < 8) {
        uint64_t mask_y = (uint64_t(1) << (rows << 3)) - 1;
        uint16_t mask_uv = uint16_t((1 << (((rows + 1) >> 1) << 2)) - 1);
        for (int i = 0; i < 3; ++i) {
          lm.left_y[i] &= mask_y;
          lm.above_y[i] &= mask_y;
          lm.left_uv[i] &= mask_uv;
          lm.above_uv[i] &= mask_uv;
        }
        lm.int4_y &= mask_y;
        lm.int4_uv &= mask_uv;
        if (rows == 1) {
          lm.above_uv[TX_8X8] |= lm.above_uv[TX_16X16];
          lm.above_uv[TX_16X16] = 0;
        }
        if (rows == 5) {
          lm.above_uv[TX_8X8] |= lm.above_uv[TX_16X16] & 0xFF00;
          lm.above_uv[TX_16X16] &= ~(lm.above_uv[TX_16X16] & 0xFF00);
        }
      }
      if (cols < 8) {
        uint64_t mask_y = uint64_t((1 << cols) - 1) * 0x0101010101010101ULL;
        uint16_t mask_uv = uint16_t(((1 << ((cols + 1) >> 1)) - 1) * 0x1111);
        uint16_t mask_uv_int = uint16_t(((1 << (cols >> 1)) - 1) * 0x1111);
        for (int i = 0; i < 3; ++i) {
          lm.left_y[i] &= mask_y;
          lm.above_y[i] &= mask_y;
          lm.left_uv[i] &= mask_uv;
          lm.above_uv[i] &= mask_uv;
        }
        lm.int4_y &= mask_y;
        lm.int4_uv &= mask_uv_int;
        if (cols == 1) {
          lm.left_uv[TX_8X8] |= lm.left_uv[TX_16X16];
          lm.left_uv[TX_16X16] = 0;
        }
        if (cols == 5) {
          lm.left_uv[TX_8X8] |= lm.left_uv[TX_16X16] & 0xCCCC;
          lm.left_uv[TX_16X16] &= ~(lm.left_uv[TX_16X16] & 0xCCCC);
        }
      }
      if (sc == 0) {
        for (int i = 0; i < 3; ++i) {
          lm.left_y[i] &= 0xFEFEFEFEFEFEFEFEULL;
          lm.left_uv[i] &= 0xEEEE;
        }
      }
      // Luma (and 4:4:4 chroma, by the same masks): vertical edges, then
      // horizontal ones.
      auto filter_ss00 = [&](int p) {
        const int st = cur->stride[p];
        P* base = cur->at<P>(p, sc * 8, sr * 8);
        for (int r = 0; r < rows; ++r)
          for (int c = 0; c < 8; ++c) {
            uint64_t bit = uint64_t(1) << (r * 8 + c);
            const Thresh& t = th[lm.lfl_y[r * 8 + c]];
            P* s = base + r * 8 * st + c * 8;
            if (lm.left_y[TX_16X16] & bit) filter_edge(s, 1, st, 16, t, bd);
            else if (lm.left_y[TX_8X8] & bit) filter_edge(s, 1, st, 8, t, bd);
            else if (lm.left_y[TX_4X4] & bit) filter_edge(s, 1, st, 4, t, bd);
            if (lm.int4_y & bit) filter_edge(s + 4, 1, st, 4, t, bd);
          }
        for (int r = 0; r < rows; ++r)
          for (int c = 0; c < 8; ++c) {
            uint64_t bit = uint64_t(1) << (r * 8 + c);
            const Thresh& t = th[lm.lfl_y[r * 8 + c]];
            P* s = base + r * 8 * st + c * 8;
            if (sr + r > 0) {
              if (lm.above_y[TX_16X16] & bit) filter_edge(s, st, 1, 16, t, bd);
              else if (lm.above_y[TX_8X8] & bit)
                filter_edge(s, st, 1, 8, t, bd);
              else if (lm.above_y[TX_4X4] & bit)
                filter_edge(s, st, 1, 4, t, bd);
            }
            if (lm.int4_y & bit) filter_edge(s + 4 * st, st, 1, 4, t, bd);
          }
      };
      filter_ss00(0);
      if (!hd.ss_x && !hd.ss_y) {
        filter_ss00(1);
        filter_ss00(2);
        continue;
      }
      if (hd.ss_x != hd.ss_y) {
        for (int p = 1; p < 3; ++p) filter_non420<P>(p, sr, sc, lvl, th);
        continue;
      }
      // 4:2:0 chroma: levels from the luma cell at even (row, col).
      for (int p = 1; p < 3; ++p) {
        const int st = cur->stride[p];
        P* base = cur->at<P>(p, sc * 4, sr * 4);
        for (int r = 0; r < 4; ++r)
          for (int c = 0; c < 4; ++c) {
            uint16_t bit = uint16_t(1 << (r * 4 + c));
            const Thresh& t = th[lm.lfl_y[(2 * r) * 8 + 2 * c]];
            P* s = base + r * 8 * st + c * 8;
            if (lm.left_uv[TX_16X16] & bit) filter_edge(s, 1, st, 16, t, bd);
            else if (lm.left_uv[TX_8X8] & bit) filter_edge(s, 1, st, 8, t, bd);
            else if (lm.left_uv[TX_4X4] & bit) filter_edge(s, 1, st, 4, t, bd);
            if (lm.int4_uv & bit) filter_edge(s + 4, 1, st, 4, t, bd);
          }
        for (int r = 0; r < 4 && sr + 2 * r < mi_rows; ++r)
          for (int c = 0; c < 4; ++c) {
            uint16_t bit = uint16_t(1 << (r * 4 + c));
            const Thresh& t = th[lm.lfl_y[(2 * r) * 8 + 2 * c]];
            P* s = base + r * 8 * st + c * 8;
            if (sr + 2 * r > 0) {
              if (lm.above_uv[TX_16X16] & bit)
                filter_edge(s, st, 1, 16, t, bd);
              else if (lm.above_uv[TX_8X8] & bit)
                filter_edge(s, st, 1, 8, t, bd);
              else if (lm.above_uv[TX_4X4] & bit)
                filter_edge(s, st, 1, 4, t, bd);
            }
            if ((lm.int4_uv & bit) && sr + 2 * r != mi_rows - 1)
              filter_edge(s + 4 * st, st, 1, 4, t, bd);
          }
      }
    }
}

// A chroma plane of 4:2:2 or 4:4:0 in the superblock at (sr, sc)
// (libvpx's vp9_filter_block_plane_non420): per 8x8 unit of the plane,
// the edges its block's chroma transform size and skip flag give, built
// and filtered a row of units at a time (vertical edges), then the
// horizontal ones; 16-wide edges become 8-wide on the frame's last odd
// column or row of chroma.
template <class P>
void Vp9Decoder::State::filter_non420(int p, int sr, int sc,
                                      const uint8_t (*lvl)[4][2],
                                      const Thresh* th) {
  const int sx = hd.ss_x, sy = hd.ss_y, bd = hd.depth;
  const int st = cur->stride[p];
  P* base = cur->at<P>(p, (sc * 8) >> sx, (sr * 8) >> sy);
  unsigned m16[8] = {}, m8[8] = {}, m4[8] = {}, m4i[8] = {};
  uint8_t lfl[64] = {};
  // The vertical edges of a row of units, or the horizontal ones: each
  // bit an 8-pixel unit.
  auto vert = [&](P* s, unsigned a16, unsigned a8, unsigned a4, unsigned ai,
                  const uint8_t* l) {
    for (; a16 | a8 | a4 | ai; s += 8, ++l) {
      const Thresh& t = th[*l];
      if (a16 & 1) filter_edge(s, 1, st, 16, t, bd);
      else if (a8 & 1) filter_edge(s, 1, st, 8, t, bd);
      else if (a4 & 1) filter_edge(s, 1, st, 4, t, bd);
      if (ai & 1) filter_edge(s + 4, 1, st, 4, t, bd);
      a16 >>= 1, a8 >>= 1, a4 >>= 1, ai >>= 1;
    }
  };
  auto horiz = [&](P* s, unsigned a16, unsigned a8, unsigned a4, unsigned ai,
                   const uint8_t* l) {
    for (; a16 | a8 | a4 | ai; s += 8, ++l) {
      const Thresh& t = th[*l];
      if (a16 & 1) filter_edge(s, st, 1, 16, t, bd);
      else if (a8 & 1) filter_edge(s, st, 1, 8, t, bd);
      else if (a4 & 1) filter_edge(s, st, 1, 4, t, bd);
      if (ai & 1) filter_edge(s + 4 * st, st, 1, 4, t, bd);
      a16 >>= 1, a8 >>= 1, a4 >>= 1, ai >>= 1;
    }
  };
  for (int r = 0; r < 8 && sr + r < mi_rows; r += 1 << sy) {
    unsigned c16 = 0, c8 = 0, c4 = 0;
    for (int c = 0; c < 8 && sc + c < mi_cols; c += 1 << sx) {
      const ModeInfo& m = mi[size_t(sr + r) * mi_cols + sc + c];
      const bool skip_this = m.skip && m.is_inter;
      const bool edge_left = kW4[m.size] > 1 ? !(c & (kW8[m.size] - 1)) : true;
      const bool edge_above =
          kH4[m.size] > 1 ? !(r & (kH8[m.size] - 1)) : true;
      const bool skip_c = skip_this && !edge_left;
      const bool skip_r = skip_this && !edge_above;
      const int tx =
          m.size < B8X8
              ? int(TX_4X4)
              : std::min<int>(m.tx, __builtin_ctz(std::min(
                                        std::max(kW4[m.size] >> sx, 1),
                                        std::max(kH4[m.size] >> sy, 1))));
      const bool border_c = sx && sc + c == mi_cols - 1;
      const bool border_r = sy && sr + r == mi_rows - 1;
      const int cu = c >> sx, ru = r >> sy;
      lfl[(r << 3) + cu] =
          lvl[m.seg][m.ref[0] > 0 ? m.ref[0] : 0][kModeLf[m.mode]];
      if (!lfl[(r << 3) + cu]) continue;
      const unsigned bit = 1u << cu;
      if (tx == TX_32X32 || tx == TX_16X16) {
        const int align = tx == TX_32X32 ? 3 : 1;
        if (!skip_c && (cu & align) == 0) (border_c ? c8 : c16) |= bit;
        if (!skip_r && (ru & align) == 0) (border_r ? m8[r] : m16[r]) |= bit;
      } else {
        // 8x8 edges on 32x32 boundaries
        if (!skip_c) (tx == TX_8X8 || (cu & 3) == 0 ? c8 : c4) |= bit;
        if (!skip_r) (tx == TX_8X8 || (ru & 3) == 0 ? m8[r] : m4[r]) |= bit;
        if (!skip_this && tx < TX_8X8 && !border_c) m4i[r] |= bit;
      }
    }
    const unsigned border = sc == 0 ? ~1u : ~0u;
    vert(base + (r >> sy) * 8 * st, c16 & border, c8 & border, c4 & border,
         m4i[r], &lfl[r << 3]);
  }
  for (int r = 0; r < 8 && sr + r < mi_rows; r += 1 << sy) {
    const bool border_r = sy && sr + r == mi_rows - 1;
    const bool top = sr + r == 0;
    horiz(base + (r >> sy) * 8 * st, top ? 0 : m16[r], top ? 0 : m8[r],
          top ? 0 : m4[r], border_r ? 0 : m4i[r], &lfl[r << 3]);
  }
}

// ------------------------------------------------------------ adaptation

namespace {

uint8_t get_prob(unsigned num, unsigned den) {
  int p = int((uint64_t(num) * 256 + (den >> 1)) / den);
  return uint8_t(clampi(p, 1, 255));
}

uint8_t weighted(int pre, int prob, int factor) {
  return uint8_t((pre * (256 - factor) + prob * factor + 128) >> 8);
}

uint8_t merge_coef(uint8_t pre, unsigned c0, unsigned c1, unsigned sat,
                   unsigned update) {
  unsigned den = c0 + c1;
  int prob = den ? get_prob(c0, den) : 128;
  unsigned count = std::min(den, sat);
  return weighted(pre, prob, int(update * count / sat));
}

// mode_mv_merge_probs: MODE_MV_COUNT_SAT 20, MAX_UPDATE_FACTOR 128.
uint8_t merge_mode(uint8_t pre, unsigned c0, unsigned c1) {
  unsigned den = c0 + c1;
  if (!den) return pre;
  static const int kFactor[21] = {0,  6,  12, 19, 25,  32,  38,
                                  44, 51, 57, 64, 70,  76,  83,
                                  89, 96, 102, 108, 115, 121, 128};
  return weighted(pre, get_prob(c0, den), kFactor[std::min(den, 20u)]);
}

unsigned merge_tree(const int8_t* tree, int i, const uint8_t* pre,
                    const unsigned* counts, uint8_t* out) {
  int l = tree[i], r = tree[i + 1];
  unsigned lc = l <= 0 ? counts[-l] : merge_tree(tree, l, pre, counts, out);
  unsigned rc = r <= 0 ? counts[-r] : merge_tree(tree, r, pre, counts, out);
  out[i >> 1] = merge_mode(pre[i >> 1], lc, rc);
  return lc + rc;
}

}  // namespace

void Vp9Decoder::State::adapt() {
  const Probs& pre = contexts[hd.context_idx];
  const Counts& n = counts;
  // libavcodec: 112, or 128 on an inter frame after a keyframe.
  const bool intra = hd.key || hd.intra_only;
  unsigned update = 112, sat = 24;
  if (!intra && last_key) update = 128;
  for (int t = 0; t < 4; ++t)
    for (int i = 0; i < 2; ++i)
      for (int j = 0; j < 2; ++j)
        for (int k = 0; k < 6; ++k)
          for (int l = 0; l < (k ? 6 : 3); ++l) {
            const unsigned* c = n.coef[t][i][j][k][l];
            unsigned eob = n.eob[t][i][j][k][l];
            const uint8_t* pp = pre.coef[t][i][j][k][l];
            uint8_t* p = fc.coef[t][i][j][k][l];
            p[0] = merge_coef(pp[0], c[3], eob - c[3], sat, update);
            p[1] = merge_coef(pp[1], c[0], c[1] + c[2], sat, update);
            p[2] = merge_coef(pp[2], c[1], c[2], sat, update);
          }
  if (intra) return;
  for (int i = 0; i < 4; ++i)
    fc.is_inter[i] = merge_mode(pre.is_inter[i], n.is_inter[i][0],
                                n.is_inter[i][1]);
  for (int i = 0; i < 5; ++i) {
    fc.comp_mode[i] = merge_mode(pre.comp_mode[i], n.comp_mode[i][0],
                                 n.comp_mode[i][1]);
    fc.comp_ref[i] = merge_mode(pre.comp_ref[i], n.comp_ref[i][0],
                                n.comp_ref[i][1]);
    for (int j = 0; j < 2; ++j)
      fc.single_ref[i][j] = merge_mode(pre.single_ref[i][j],
                                       n.single_ref[i][j][0],
                                       n.single_ref[i][j][1]);
  }
  for (int i = 0; i < 7; ++i) {
    // The inter-mode counts are kept by offset from NEARESTMV; the tree's
    // leaves name the same offsets.
    merge_tree(kInterModeTree, 0, pre.inter_mode[i], n.inter_mode[i],
               fc.inter_mode[i]);
  }
  for (int i = 0; i < 4; ++i)
    merge_tree(kIntraTree, 0, pre.y_mode[i], n.y_mode[i], fc.y_mode[i]);
  for (int i = 0; i < 10; ++i)
    merge_tree(kIntraTree, 0, pre.uv_mode[i], n.uv_mode[i], fc.uv_mode[i]);
  for (int i = 0; i < 16; ++i)
    merge_tree(kPartTree, 0, pre.partition[i], n.partition[i],
               fc.partition[i]);
  if (hd.filter == SWITCHABLE)
    for (int i = 0; i < 4; ++i)
      merge_tree(kInterpTree, 0, pre.interp[i], n.interp[i], fc.interp[i]);
  if (tx_mode == TX_MODE_SELECT)
    for (int i = 0; i < 2; ++i) {
      const unsigned* c8 = n.tx8[i];
      fc.tx8[i][0] = merge_mode(pre.tx8[i][0], c8[0], c8[1]);
      const unsigned* c16 = n.tx16[i];
      fc.tx16[i][0] = merge_mode(pre.tx16[i][0], c16[0], c16[1] + c16[2]);
      fc.tx16[i][1] = merge_mode(pre.tx16[i][1], c16[1], c16[2]);
      const unsigned* c32 = n.tx32[i];
      fc.tx32[i][0] = merge_mode(pre.tx32[i][0], c32[0],
                                 c32[1] + c32[2] + c32[3]);
      fc.tx32[i][1] = merge_mode(pre.tx32[i][1], c32[1], c32[2] + c32[3]);
      fc.tx32[i][2] = merge_mode(pre.tx32[i][2], c32[2], c32[3]);
    }
  for (int i = 0; i < 3; ++i)
    fc.skip[i] = merge_mode(pre.skip[i], n.skip[i][0], n.skip[i][1]);
  // MVs.
  merge_tree(kMvJointTree, 0, pre.mv_joint, n.mv_joint, fc.mv_joint);
  for (int i = 0; i < 2; ++i) {
    const MvComp& pc = pre.mv[i];
    MvComp& c = fc.mv[i];
    const MvCompCounts& k = n.mv[i];
    c.sign = merge_mode(pc.sign, k.sign[0], k.sign[1]);
    merge_tree(kMvClassTree, 0, pc.classes, k.classes, c.classes);
    c.class0[0] = merge_mode(pc.class0[0], k.class0[0], k.class0[1]);
    for (int j = 0; j < 10; ++j)
      c.bits[j] = merge_mode(pc.bits[j], k.bits[j][0], k.bits[j][1]);
    for (int j = 0; j < 2; ++j)
      merge_tree(kMvFpTree, 0, pc.class0_fp[j], k.class0_fp[j],
                 c.class0_fp[j]);
    merge_tree(kMvFpTree, 0, pc.fp, k.fp, c.fp);
    if (hd.allow_hp) {
      c.class0_hp = merge_mode(pc.class0_hp, k.class0_hp[0], k.class0_hp[1]);
      c.hp = merge_mode(pc.hp, k.hp[0], k.hp[1]);
    }
  }
}

// ------------------------------------------------------------- one frame

void Vp9Decoder::State::decode_frame(const uint8_t* data, size_t n,
                                     Picture& out, bool& shown) {
  parse_header(data, n);
  std::shared_ptr<Frame> show;
  if (hd.show_existing) {
    show = slots[hd.existing_idx];
    if (!show) broken("VP9 frame shows an empty slot");
  } else {
    if (hd.key || hd.intra_only) {
      have_key = have_key || hd.key;
      depth = hd.depth;
      ss_x = hd.ss_x;
      ss_y = hd.ss_y;
      rgb = hd.rgb;
      color_range = hd.color_range;
      color_space = hd.color_space;
    }
    if (hd.uncompressed_size + size_t(hd.header_size) > n)
      broken("VP9 compressed header runs past its frame");
    fc = contexts[hd.context_idx];
    bd.init(data + hd.uncompressed_size, size_t(hd.header_size));
    read_compressed_header();
    std::memset(&counts, 0, sizeof(counts));
    const int16_t* dc = hd.depth == 12 ? kDcQ12 : hd.depth == 10 ? kDcQ10
                                                                 : kDcQ;
    const int16_t* ac = hd.depth == 12 ? kAcQ12 : hd.depth == 10 ? kAcQ10
                                                                 : kAcQ;
    for (int s = 0; s < 8; ++s) {
      int q = hd.base_q;
      if (seg.active(s, SEG_ALT_Q)) {
        int d = seg.data[s][SEG_ALT_Q];
        q = clampi(seg.abs_delta ? d : hd.base_q + d, 0, 255);
      }
      dq[s][0][0] = dc[clampi(q + hd.dq_y_dc, 0, 255)];
      dq[s][0][1] = ac[q];
      dq[s][1][0] = dc[clampi(q + hd.dq_uv_dc, 0, 255)];
      dq[s][1][1] = ac[clampi(q + hd.dq_uv_ac, 0, 255)];
    }
    cur = std::make_shared<Frame>(hd.w, hd.h, hd.depth, hd.ss_x, hd.ss_y);
    mi.assign(size_t(mi_rows) * mi_cols, ModeInfo());
    cur_mvs.assign(size_t(mi_rows) * mi_cols, MvRef());
    // UsePrevFrameMvs: the last frame decoded was shown, of this size and
    // not intra-only, and this one is not error resilient (nor intra:
    // it reads no MVs).
    use_prev_mvs = !hd.error_res && hd.w == last_w && hd.h == last_h &&
                   last_show && !last_intra_only &&
                   prev_mvs.size() == cur_mvs.size();
    size_t start = hd.uncompressed_size + size_t(hd.header_size);
    decode_tiles(data + start, n - start);
    if (hd.depth > 8) loop_filter<uint16_t>();
    else loop_filter<uint8_t>();
    if (!hd.error_res && !hd.parallel) adapt();
    if (hd.refresh_context) contexts[hd.context_idx] = fc;
    for (int i = 0; i < 8; ++i)
      if (hd.refresh_flags & (1 << i)) slots[i] = cur;
    prev_mvs.swap(cur_mvs);
    last_w = hd.w;
    last_h = hd.h;
    last_show = hd.show;
    last_key = hd.key;
    last_intra_only = hd.intra_only;
    if (seg.enabled) seg_map_last.swap(seg_map_cur);
    if (hd.show) show = cur;
  }
  if (!show) return;
  // A packet that shows more than one picture (an SVC superframe, one a
  // spatial layer) gives each, as libavcodec's superframe split does.
  if (shown) {
    pending.emplace_back();
    write_picture(*show, pending.back());
    return;
  }
  shown = true;
  write_picture(*show, out);
}

void Vp9Decoder::State::write_picture(const Frame& f, Picture& out) {
  out.w = f.w;
  out.h = f.h;
  out.depth = f.depth;
  out.xshift = f.ss_x;
  out.yshift = f.ss_y;
  out.grey = false;
  out.rgb = rgb;
  out.chroma_loc = 0;
  // libavcodec's colour range and space of the stream, which cv2 hands
  // to swscale: VP9's colour spaces as swscale's matrices.
  static const int kMatrix[8] = {2, 5, 1, 6, 7, 9, 3, 0};
  out.full_range = color_range != 0;
  out.matrix = kMatrix[color_space];
  const int cw = f.crop_w(1), ch = f.crop_h(1);
  out.ystride = f.w;
  out.cstride = cw;
  auto copy = [&](auto* dst, int p, int w, int h) {
    using P = std::remove_reference_t<decltype(*dst)>;
    const P* src = f.data<P>(p);
    for (int y = 0; y < h; ++y)
      std::memcpy(dst + size_t(y) * w, src + size_t(y) * f.stride[p],
                  sizeof(P) * size_t(w));
  };
  if (f.depth > 8) {
    out.y.clear();
    out.u.clear();
    out.v.clear();
    out.y16.resize(size_t(f.w) * f.h);
    out.u16.resize(size_t(cw) * ch);
    out.v16.resize(out.u16.size());
    copy(out.y16.data(), 0, f.w, f.h);
    copy(out.u16.data(), 1, cw, ch);
    copy(out.v16.data(), 2, cw, ch);
  } else {
    out.y16.clear();
    out.u16.clear();
    out.v16.clear();
    out.y.resize(size_t(f.w) * f.h);
    out.u.resize(size_t(cw) * ch);
    out.v.resize(out.u.size());
    copy(out.y.data(), 0, f.w, f.h);
    copy(out.u.data(), 1, cw, ch);
    copy(out.v.data(), 2, cw, ch);
  }
}

// -------------------------------------------------------------- packets

namespace {

// Annex B: a packet's frames (offset, size), by its superframe index.
std::vector<std::pair<size_t, size_t>> split_superframe(const uint8_t* d,
                                                        size_t n) {
  std::vector<std::pair<size_t, size_t>> out;
  if (n) {
    uint8_t marker = d[n - 1];
    if ((marker & 0xE0) == 0xC0) {
      int frames = (marker & 7) + 1, mag = ((marker >> 3) & 3) + 1;
      size_t index = 2 + size_t(mag) * frames;
      if (n >= index && d[n - index] == marker) {
        const uint8_t* p = d + n - index + 1;
        size_t off = 0;
        for (int i = 0; i < frames; ++i) {
          size_t sz = 0;
          for (int b = 0; b < mag; ++b) sz |= size_t(*p++) << (8 * b);
          if (off + sz > n - index)
            broken("VP9 superframe index names more bytes than it holds");
          if (sz) out.push_back({off, sz});
          off += sz;
        }
        return out;
      }
    }
    out.push_back({0, n});
  }
  return out;
}

}  // namespace

Vp9Decoder::Vp9Decoder() : s_(new State) {}
Vp9Decoder::~Vp9Decoder() = default;

bool Vp9Decoder::decode(const uint8_t* data, size_t n, Picture& out) {
  s_->pending.clear();
  s_->next_pending = 0;
  bool shown = false;
  for (auto [off, sz] : split_superframe(data, n))
    s_->decode_frame(data + off, sz, out, shown);
  return shown;
}

bool Vp9Decoder::picture_size(const uint8_t* data, size_t n, int& w,
                              int& h) {
  auto frames = split_superframe(data, n);
  if (frames.empty()) return false;
  BitReader br(data + frames[0].first, frames[0].second);
  try {
    if (br.f(2) != 2) return false;
    int lo = br.bit(), hi = br.bit(), profile = (hi << 1) | lo;
    if (profile == 3) br.bit();
    if (br.bit() || br.bit()) return false;   // show_existing, not a key
    br.f(2);                                  // show, error_res
    br.f(24);                                 // sync code
    if (profile >= 2) br.bit();
    int cs = br.f(3);
    if (cs != 7) br.bit();
    if (profile & 1) br.f(cs != 7 ? 3 : 1);
    w = br.f(16) + 1;
    h = br.f(16) + 1;
    return true;
  } catch (const Error&) {
    return false;
  }
}

bool Vp9Decoder::next(Picture& out) {
  if (s_->next_pending >= s_->pending.size()) return false;
  out = std::move(s_->pending[s_->next_pending++]);
  return true;
}

int Vp9Decoder::peek(const uint8_t* data, size_t n, int* pictures) {
  bool key = false, first = true;
  int count = 0;
  for (auto [off, sz] : split_superframe(data, n)) {
    const uint8_t* d = data + off;
    if (sz < 1 || (d[0] >> 6) != 2) broken("VP9 frame marker is not 2");
    int profile = ((d[0] >> 4) & 1) << 1 | ((d[0] >> 5) & 1);
    int bit = 4 + (profile == 3);
    auto at = [&](int b) { return (d[b >> 3] >> (7 - (b & 7))) & 1; };
    if (sz * 8 < size_t(bit + 3)) broken("VP9 uncompressed header cut short");
    if (at(bit)) {                               // show_existing_frame
      ++count;
    } else {
      if (first && at(bit + 1) == 0) key = true;
      if (at(bit + 2)) ++count;
    }
    first = false;
  }
  if (pictures) *pictures = count;
  return count ? (key ? 0 : 1) : -1;
}

}  // namespace viai_video
