// The H.263 family of viai_tpu_torch, decoded as libavcodec decodes it
// (h263dec.c's frame and slice loop, ituh263dec.c, h263.c, flvdec.c,
// msmpeg4dec.c, msmpeg4.c, wmv2dec.c, wmv2.c, wmv2dsp.c,
// mpegvideo_motion.c's OBMC):
//
//   * ITU H.263 (H263, X263, T263, L263, VX1K, M263, lsvm, U263; MP4's
//     s263 and h263): the picture header's five source
//     formats, GOB headers (GN, GFID, GQUANT) and the slice loop's end
//     and resync; Annex D's long vectors, Annex F's 4MV (H.263's vector
//     prediction, chroma rounding) and OBMC, with libavcodec's preview
//     of the next macroblock's vectors (zero where it previews none);
//     H.263+'s PLUSPTYPE
//     (UFEP, OPPTYPE, MPPTYPE, custom sizes and clock), Annex D's
//     reversible vector codes, Annex I's AC/DC prediction, Annex J's
//     loop filter, Annex K's slices, Annex S's second inter table,
//     Annex T's DQUANT, chroma quantiser and extended escape, the
//     rounding type;
//   * Sorenson H.263 (FLV1): its picture header (sizes, disposable P
//     pictures), H.263 baseline macroblocks (MCBPC, CBPY, DQUANT, 16x16
//     median-predicted vectors, the 8-bit intra DC, H.263's inter
//     run-level table with both of Sorenson's escapes), H.263
//     quantisation at reconstruction;
//   * MS-MPEG4 v2 (MP42, DIV2): v2's macroblock types and intra cbp, its
//     DC codes, AC prediction, H.263 vectors with MS-MPEG4's wrap;
//   * MS-MPEG4 v3 (MP43, DIV3 ...; Matroska's V_MPEG4/MS/V3): the
//     per-picture choice of run-level, DC and vector tables, predicted
//     intra coded block patterns, slices (the DC and AC predictors reset
//     at each), the extension header after an I picture (flip-flop
//     rounding);
//   * WMV1 (WMV7): its scans and DC scales, the extension header in the
//     I picture header, run-level tables chosen a macroblock, inter-intra
//     prediction (intra DC from the decoded pixels of P pictures), the
//     third escape's coded lengths;
//   * WMV2 (WMV8): the extradata's header, skip maps (none, MPEG's,
//     rows, columns; a picture all skipped gives none), coded block
//     pattern tables by quantiser, top-left vector prediction, mspel
//     motion (wmv2dsp's 4-tap half-pel filters), ABT's 8x4 and 4x8
//     blocks (the simple IDCT's 8x4 and 4x8 forms), ff_wmv2_idct for
//     8x8 blocks, and H.263's loop filter where the extradata asks for it;
//   * ffmpeg's simple IDCT (videodec.cpp) for the rest; half-pel motion
//     with H.263's chroma rounding and libavcodec's edge emulation.
//
// Each feature that is not read raises NotImplementedError (code 2)
// naming it: MS-MPEG4 v1 (MPG4, MP41, DIV1), WMV2 J-frames (IntraX8), a
// FLV1 or H.263 picture of another size, and H.263's Annex E (SAC), G
// and M (PB-frames), N (RPS), O (B, EI and EP pictures), P and Q (RPR,
// RRU), R (independent segments), rectangular and unordered slices.

#include <algorithm>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include "mpeg_bits.h"
#include "msmpeg4_tables.h"
#include "video.h"

namespace viai_video {

namespace {

using mpeg::Bits;
using mpeg::hpel;
using mpeg::kAltHorizontal;
using mpeg::kAltVertical;
using mpeg::kZigzag;
using mpeg::Plane;
namespace t = msmp4;

// A VLC of any code length (libavcodec's tables run to 26 bits) and up
// to 65536 symbols: a lookup of the first `bits` bits, codes longer than
// that matched one by one (they are rare).
class Vlc {
 public:
  static constexpr uint32_t kLong = 0xFFFFFFFFu;
  explicit Vlc(int bits) : bits_(bits), lut_(size_t(1) << bits, 0) {}
  // Symbol `sym`: `code` of `len` bits (0: not in the table).
  void add(uint32_t code, int len, int sym) {
    if (len <= 0) return;
    if (len <= bits_) {
      int shift = bits_ - len;
      for (uint32_t k = 0; k < (1u << shift); ++k)
        lut_[(code << shift) | k] = (uint32_t(len) << 16) | uint32_t(sym);
    } else {
      lut_[code >> (len - bits_)] = kLong;
      longs_.push_back({code, len, sym});
      std::stable_sort(longs_.begin(), longs_.end(),
                       [](const Long& a, const Long& b) { return a.len < b.len; });
    }
  }
  // The symbol, or −1 for a code that is not in the table.
  int read(Bits& b) const {
    uint32_t e = lut_[b.peek(bits_)];
    if (e == kLong) {
      for (const Long& l : longs_)
        if (b.peek(l.len) == l.code) {
          b.skip(l.len);
          return l.sym;
        }
      return -1;
    }
    if (!e) return -1;
    b.skip(int(e >> 16));
    return int(e & 0xFFFF);
  }

 private:
  struct Long {
    uint32_t code;
    int len, sym;
  };
  int bits_;
  std::vector<uint32_t> lut_;
  std::vector<Long> longs_;
};

template <typename T>
Vlc pairs_vlc(const T (*tab)[2], int n, int bits) {
  Vlc v(bits);
  for (int i = 0; i < n; ++i) v.add(uint32_t(tab[i][0]), int(tab[i][1]), i);
  return v;
}

// A run-level table with libavcodec's max_level (by last, run) and
// max_run (by last, level).
struct Rl {
  Vlc vlc;
  const int8_t* run;
  const int8_t* level;
  int n, last;
  int max_level[2][65];
  int max_run[2][65];
  Rl(const uint16_t (*tab)[2], const int8_t* r, const int8_t* l, int n_,
     int last_)
      : vlc(pairs_vlc(tab, n_ + 1, 12)), run(r), level(l), n(n_), last(last_) {
    std::memset(max_level, 0, sizeof(max_level));
    std::memset(max_run, 0, sizeof(max_run));
    for (int i = 0; i < n; ++i) {
      int k = i >= last;
      max_level[k][run[i]] = std::max(max_level[k][run[i]], int(level[i]));
      max_run[k][level[i]] = std::max(max_run[k][level[i]], int(run[i]));
    }
  }
};

const Rl& rl_table(int k) {
  static const Rl tabs[6] = {
      Rl(t::kRl0Vlc, t::kRl0Run, t::kRl0Level, t::kRlN[0], t::kRlLast[0]),
      Rl(t::kRl1Vlc, t::kRl1Run, t::kRl1Level, t::kRlN[1], t::kRlLast[1]),
      Rl(t::kRl2Vlc, t::kRl2Run, t::kRl2Level, t::kRlN[2], t::kRlLast[2]),
      Rl(t::kRl3Vlc, t::kRl3Run, t::kRl3Level, t::kRlN[3], t::kRlLast[3]),
      Rl(t::kRl4Vlc, t::kRl4Run, t::kRl4Level, t::kRlN[4], t::kRlLast[4]),
      Rl(t::kRl5Vlc, t::kRl5Run, t::kRl5Level, t::kRlN[5], t::kRlLast[5])};
  return tabs[k];
}

// ff_mv_tables[k]: symbol 1099 is the escape.
const Vlc& mv_vlc(int k) {
  static const Vlc v[2] = {
      [] {
        Vlc v(14);
        for (int i = 0; i < 1100; ++i) v.add(t::kMv0Code[i], t::kMv0Bits[i], i);
        return v;
      }(),
      [] {
        Vlc v(14);
        for (int i = 0; i < 1100; ++i) v.add(t::kMv1Code[i], t::kMv1Bits[i], i);
        return v;
      }()};
  return v[k];
}

const Vlc& mb_non_intra_vlc(int k) {
  static const Vlc v[4] = {pairs_vlc(t::kMbNonIntra0, 128, 12),
                           pairs_vlc(t::kMbNonIntra1, 128, 12),
                           pairs_vlc(t::kMbNonIntra2, 128, 12),
                           pairs_vlc(t::kMbNonIntra3, 128, 12)};
  return v[k];
}

// The DC tables of v3 and WMV (by dc_table_index; chroma when c).
const Vlc& dc_vlc(int k, bool c) {
  static const Vlc v[4] = {pairs_vlc(t::kDcLum0, 120, 12),
                           pairs_vlc(t::kDcChroma0, 120, 12),
                           pairs_vlc(t::kDcLum1, 120, 12),
                           pairs_vlc(t::kDcChroma1, 120, 12)};
  return v[2 * k + c];
}

// init_h263_dc_for_msmpeg4: MS-MPEG4 v2's DC codes, MPEG-4's size codes
// inverted, then the magnitude (and a marker past 8 bits); symbol
// level + 256.
Vlc make_v2_dc(bool chroma) {
  Vlc v(12);
  for (int level = -256; level < 256; ++level) {
    int size = 0;
    for (int a = std::abs(level); a; a >>= 1) ++size;
    int l = level < 0 ? (-level) ^ ((1 << size) - 1) : level;
    uint32_t code = chroma ? t::kDcTabChrom[size][0] : t::kDcTabLum[size][0];
    int len = chroma ? t::kDcTabChrom[size][1] : t::kDcTabLum[size][1];
    code ^= (1u << len) - 1;
    if (size > 0) {
      code = (code << size) | uint32_t(l);
      len += size;
      if (size > 8) {
        code = (code << 1) | 1;
        ++len;
      }
    }
    v.add(code, len, level + 256);
  }
  return v;
}

const Vlc& v2_dc_vlc(bool chroma) {
  static const Vlc v[2] = {make_v2_dc(false), make_v2_dc(true)};
  return v[chroma];
}

const Vlc& mb_i_vlc() {
  static const Vlc v = pairs_vlc(t::kMbI, 64, 12);
  return v;
}
const Vlc& inter_intra_vlc() {
  static const Vlc v = pairs_vlc(t::kInterIntra, 4, 4);
  return v;
}
const Vlc& v2_intra_cbpc_vlc() {
  static const Vlc v = pairs_vlc(t::kV2IntraCbpc, 4, 4);
  return v;
}
const Vlc& v2_mb_type_vlc() {
  static const Vlc v = pairs_vlc(t::kV2MbType, 8, 8);
  return v;
}
const Vlc& cbpy_vlc() {
  static const Vlc v = pairs_vlc(t::kCbpyTab, 16, 6);
  return v;
}
// Annex I's intra table (and Annex S's second inter table).
const Rl& aic_rl() {
  static const Rl r(t::kAicVlc, t::kAicRun, t::kAicLevel, 102, 58);
  return r;
}
const Vlc& h263_mv_vlc() {
  static const Vlc v = pairs_vlc(t::kMvtab, 33, 12);
  return v;
}
const Vlc& intra_mcbpc_vlc() {
  static const Vlc v = [] {
    Vlc v(9);
    for (int i = 0; i < 9; ++i)
      v.add(t::kIntraMcbpcCode[i], t::kIntraMcbpcBits[i], i);
    return v;
  }();
  return v;
}
const Vlc& inter_mcbpc_vlc() {
  static const Vlc v = [] {
    Vlc v(9);
    for (int i = 0; i < 28; ++i)
      v.add(t::kInterMcbpcCode[i], t::kInterMcbpcBits[i], i);
    return v;
  }();
  return v;
}

inline uint8_t clip_u8(int v) {
  return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v);
}
inline int clip(int v, int lo, int hi) { return v < lo ? lo : v > hi ? hi : v; }
inline int mid_pred(int a, int b, int c) {
  return std::max(std::min(a, b), std::min(std::max(a, b), c));
}

// (x + s / 2) / s as libavcodec's x86 ff_msmpeg4_pred_dc computes it: the
// high half of the product with ff_inverse[s] (a floor).
inline int inverse_div(int x, int s) {
  const int64_t inv = (int64_t(1) << 32) / s + ((int64_t(1) << 32) % s != 0);
  return int((int64_t(x) * inv) >> 32);
}

// ---------------------------------------------------------------- IDCTs

// ff_wmv2_idct (wmv2dsp.c): rows in 16 bits, then columns, with the
// sum/difference butterfly at 181/256.
constexpr int kW0 = 2048, kW1 = 2841, kW2 = 2676, kW3 = 2408, kW5 = 1609,
              kW6 = 1108, kW7 = 565;

void wmv2_idct_row(int16_t* b) {
  int a1 = kW1 * b[1] + kW7 * b[7];
  int a7 = kW7 * b[1] - kW1 * b[7];
  int a5 = kW5 * b[5] + kW3 * b[3];
  int a3 = kW3 * b[5] - kW5 * b[3];
  int a2 = kW2 * b[2] + kW6 * b[6];
  int a6 = kW6 * b[2] - kW2 * b[6];
  int a0 = kW0 * b[0] + kW0 * b[4];
  int a4 = kW0 * b[0] - kW0 * b[4];
  int s1 = int(181u * unsigned(a1 - a5 + a7 - a3) + 128) >> 8;
  int s2 = int(181u * unsigned(a1 - a5 - a7 + a3) + 128) >> 8;
  b[0] = int16_t((a0 + a2 + a1 + a5 + (1 << 7)) >> 8);
  b[1] = int16_t((a4 + a6 + s1 + (1 << 7)) >> 8);
  b[2] = int16_t((a4 - a6 + s2 + (1 << 7)) >> 8);
  b[3] = int16_t((a0 - a2 + a7 + a3 + (1 << 7)) >> 8);
  b[4] = int16_t((a0 - a2 - a7 - a3 + (1 << 7)) >> 8);
  b[5] = int16_t((a4 - a6 - s2 + (1 << 7)) >> 8);
  b[6] = int16_t((a4 + a6 - s1 + (1 << 7)) >> 8);
  b[7] = int16_t((a0 + a2 - a1 - a5 + (1 << 7)) >> 8);
}

void wmv2_idct_col(int16_t* b) {
  int a1 = (kW1 * b[8 * 1] + kW7 * b[8 * 7] + 4) >> 3;
  int a7 = (kW7 * b[8 * 1] - kW1 * b[8 * 7] + 4) >> 3;
  int a5 = (kW5 * b[8 * 5] + kW3 * b[8 * 3] + 4) >> 3;
  int a3 = (kW3 * b[8 * 5] - kW5 * b[8 * 3] + 4) >> 3;
  int a2 = (kW2 * b[8 * 2] + kW6 * b[8 * 6] + 4) >> 3;
  int a6 = (kW6 * b[8 * 2] - kW2 * b[8 * 6] + 4) >> 3;
  int a0 = (kW0 * b[8 * 0] + kW0 * b[8 * 4]) >> 3;
  int a4 = (kW0 * b[8 * 0] - kW0 * b[8 * 4]) >> 3;
  int s1 = int(181u * unsigned(a1 - a5 + a7 - a3) + 128) >> 8;
  int s2 = int(181u * unsigned(a1 - a5 - a7 + a3) + 128) >> 8;
  b[8 * 0] = int16_t((a0 + a2 + a1 + a5 + (1 << 13)) >> 14);
  b[8 * 1] = int16_t((a4 + a6 + s1 + (1 << 13)) >> 14);
  b[8 * 2] = int16_t((a4 - a6 + s2 + (1 << 13)) >> 14);
  b[8 * 3] = int16_t((a0 - a2 + a7 + a3 + (1 << 13)) >> 14);
  b[8 * 4] = int16_t((a0 - a2 - a7 - a3 + (1 << 13)) >> 14);
  b[8 * 5] = int16_t((a4 - a6 - s2 + (1 << 13)) >> 14);
  b[8 * 6] = int16_t((a4 + a6 - s1 + (1 << 13)) >> 14);
  b[8 * 7] = int16_t((a0 + a2 - a1 - a5 + (1 << 13)) >> 14);
}

void wmv2_idct(int16_t* blk, uint8_t* dst, ptrdiff_t stride, bool add) {
  for (int i = 0; i < 64; i += 8) wmv2_idct_row(blk + i);
  for (int i = 0; i < 8; ++i) wmv2_idct_col(blk + i);
  for (int y = 0; y < 8; ++y)
    for (int x = 0; x < 8; ++x) {
      uint8_t& d = dst[y * stride + x];
      d = clip_u8((add ? d : 0) + blk[8 * y + x]);
    }
}

// --------------------------------------------------------- WMV2 mspel

// wmv2dsp's 4-tap half-pel lowpass of the 8 samples s[0..7] (stride st)
// toward s[st].
inline int mspel_tap(const int* s, int st) {
  return clip_u8((9 * (s[0] + s[st]) - (s[-st] + s[2 * st]) + 8) >> 4);
}

// put_mspel8_mcXY of an 8x8 block at (sx, sy) of `r` (edges replicated
// as libavcodec's 19x19 emulation gives them), dxy = x (0..3 as
// mc00/10/20/30 from hshift) + 4 · vertical half.
void mspel8(const Plane& r, int sx, int sy, int dxy, uint8_t* dst, int ds) {
  int src[12][12];                  // rows/cols −1 .. 10
  for (int y = 0; y < 12; ++y)
    for (int x = 0; x < 12; ++x) src[y][x] = r.at(sx + x - 1, sy + y - 1);
  auto px = [&](int x, int y) { return src[y + 1][x + 1]; };
  int half[11][8];                  // horizontal half-pels, rows −1 .. 9
  for (int y = -1; y < 10; ++y)
    for (int x = 0; x < 8; ++x)
      half[y + 1][x] = mspel_tap(&src[y + 1][x + 1], 1);
  auto vlow = [&](auto get, int x, int y) {   // toward row y + 1
    return clip_u8((9 * (get(x, y) + get(x, y + 1)) -
                    (get(x, y - 1) + get(x, y + 2)) + 8) >> 4);
  };
  auto hget = [&](int x, int y) { return half[y + 1][x]; };
  for (int y = 0; y < 8; ++y)
    for (int x = 0; x < 8; ++x) {
      int v;
      switch (dxy) {
        case 0: v = px(x, y); break;
        case 1: v = (px(x, y) + half[y + 1][x] + 1) >> 1; break;
        case 2: v = half[y + 1][x]; break;
        case 3: v = (px(x + 1, y) + half[y + 1][x] + 1) >> 1; break;
        case 4: v = vlow(px, x, y); break;
        case 5: v = (vlow(px, x, y) + vlow(hget, x, y) + 1) >> 1; break;
        case 6: v = vlow(hget, x, y); break;
        default: v = (vlow(px, x + 1, y) + vlow(hget, x, y) + 1) >> 1;
      }
      dst[y * ds + x] = uint8_t(v);
    }
}

// ------------------------------------------------------- loop filter

// h263dsp's h263_h_loop_filter (across a vertical edge: `step` 1, the
// pixels along it `along` apart) and h263_v_loop_filter (step = stride,
// along 1) of the 8 pixel pairs at the edge before `src`.
void h263_edge(uint8_t* src, ptrdiff_t step, ptrdiff_t along, int qscale) {
  const int strength = t::kLoopStrength[qscale];
  for (int k = 0; k < 8; ++k) {
    uint8_t* s = src + k * along;
    int p0 = s[-2 * step], p1 = s[-step], p2 = s[0], p3 = s[step];
    int d = (p0 - p3 + 4 * (p2 - p1)) / 8;
    int d1;
    if (d < -2 * strength) d1 = 0;
    else if (d < -strength) d1 = -2 * strength - d;
    else if (d < strength) d1 = d;
    else if (d < 2 * strength) d1 = 2 * strength - d;
    else d1 = 0;
    p1 += d1;
    p2 -= d1;
    if (p1 & 256) p1 = ~(p1 >> 31);
    if (p2 & 256) p2 = ~(p2 >> 31);
    s[-step] = uint8_t(p1);
    s[0] = uint8_t(p2);
    int ad1 = std::abs(d1) >> 1;
    int d2 = clip((p0 - p3) / 4, -ad1, ad1);
    s[-2 * step] = uint8_t(p0 - d2);
    s[step] = uint8_t(p3 + d2);
  }
}

// ---------------------------------------------------------- variants

enum Variant { kFlv1 = 1, kV2, kV3, kWmv1, kWmv2, kH263 };

// ff_h263_round_chroma: the chroma vector of a macroblock's four luma
// vectors' sum.
inline int round_chroma(int x) {
  static const uint8_t kTab[16] = {0, 0, 0, 1, 1, 1, 1, 1,
                                   1, 1, 1, 1, 1, 1, 2, 2};
  return kTab[x & 0xF] + ((x >> 3) & ~1);
}

// Annex F's OBMC weights (eighths) of the block's own prediction and of
// its neighbours' vectors: above (rows 0-3) or below (4-7), left
// (columns 0-3) or right (4-7).
constexpr uint8_t kObmcMid[8][8] = {
    {4, 5, 5, 5, 5, 5, 5, 4}, {5, 5, 5, 5, 5, 5, 5, 5},
    {5, 5, 6, 6, 6, 6, 5, 5}, {5, 5, 6, 6, 6, 6, 5, 5},
    {5, 5, 6, 6, 6, 6, 5, 5}, {5, 5, 6, 6, 6, 6, 5, 5},
    {5, 5, 5, 5, 5, 5, 5, 5}, {4, 5, 5, 5, 5, 5, 5, 4}};
constexpr uint8_t kObmcVert[8][8] = {
    {2, 2, 2, 2, 2, 2, 2, 2}, {1, 1, 2, 2, 2, 2, 1, 1},
    {1, 1, 1, 1, 1, 1, 1, 1}, {1, 1, 1, 1, 1, 1, 1, 1},
    {1, 1, 1, 1, 1, 1, 1, 1}, {1, 1, 1, 1, 1, 1, 1, 1},
    {1, 1, 2, 2, 2, 2, 1, 1}, {2, 2, 2, 2, 2, 2, 2, 2}};
constexpr uint8_t kObmcHorz[8][8] = {
    {2, 1, 1, 1, 1, 1, 1, 2}, {2, 2, 1, 1, 1, 1, 2, 2},
    {2, 2, 1, 1, 1, 1, 2, 2}, {2, 2, 1, 1, 1, 1, 2, 2},
    {2, 2, 1, 1, 1, 1, 2, 2}, {2, 2, 1, 1, 1, 1, 2, 2},
    {2, 2, 1, 1, 1, 1, 2, 2}, {2, 1, 1, 1, 1, 1, 1, 2}};

// H.263's source formats (ff_h263_format): sub-QCIF to 16CIF.
bool h263_format(int f, int& w, int& h) {
  w = t::kH263Format[f][0];
  h = t::kH263Format[f][1];
  return w > 0;
}

// An ITU H.263 picture header from its start code through PTYPE and,
// under PLUSPTYPE, UFEP, OPPTYPE, MPPTYPE and the custom picture format.
struct ItuPtype {
  bool plus = false;                // PLUSPTYPE (H.263+)
  int ufep = 1;                     // 1: the header gives the size and modes
  int format = 0;                   // 1-5 ff_h263_format's, 6 custom
  int w = 0, h = 0;                 // the size, where the header gives it
  // 0 I, 1 P; PLUSPTYPE's 2 improved PB, 3-5 B, EI, EP, 7 I (ZyGo's)
  int type = 0;
  bool long_vectors = false, pb = false;                   // PTYPE's
  bool custom_pcf = false, umvplus = false, aic = false;   // OPPTYPE's
  bool loop_filter = false, slice_structured = false, rps = false;
  bool isd = false, alt_inter_vlc = false, modified_quant = false;
  bool sac = false, obmc = false;                          // both
  bool rpr = false, rru = false, no_rounding = false;      // MPPTYPE's
};

// The start code searched for as ff_h263_decode_picture_header searches;
// → what is wrong with the header, else null.
const char* read_ptype(Bits& b, ItuPtype& p) {
  uint32_t sc = b.get(14);
  for (long i = b.left(); i > 24; i -= 8) {
    sc = ((sc << 8) | b.get(8)) & 0x3FFFFF;
    if (sc == 0x20) break;
  }
  if (sc != 0x20) return "bad picture start code";
  b.skip(8);                        // temporal reference
  if (!b.get1()) return "bad marker in PTYPE";
  if (b.get1()) return "bad H.263 id";
  b.skip(3);                        // split screen, camera, freeze release
  p.format = int(b.get(3));
  if (p.format != 7 && p.format != 6) {
    if (!h263_format(p.format, p.w, p.h)) return "invalid source format";
    p.type = b.get1();
    p.long_vectors = b.get1();
    p.sac = b.get1();
    p.obmc = b.get1();
    p.pb = b.get1();
    return nullptr;
  }
  p.plus = true;
  p.ufep = int(b.get(3));
  if (p.ufep == 1) {
    p.format = int(b.get(3));
    p.custom_pcf = b.get1();
    p.umvplus = b.get1();
    p.sac = b.get1();
    p.obmc = b.get1();
    p.aic = b.get1();
    p.loop_filter = b.get1();
    p.slice_structured = b.get1();
    p.rps = b.get1();
    p.isd = b.get1();
    p.alt_inter_vlc = b.get1();
    p.modified_quant = b.get1();
    b.skip(4);                      // marker, reserved
  } else if (p.ufep != 0) {
    return "bad UFEP";
  }
  p.type = int(b.get(3));
  p.rpr = b.get1();
  p.rru = b.get1();
  p.no_rounding = b.get1();
  b.skip(4);                        // reserved, marker, CPM
  if (p.ufep) {
    if (p.format == 6) {
      int aspect = int(b.get(4));
      p.w = (int(b.get(9)) + 1) * 4;
      b.skip(1);
      p.h = int(b.get(9)) * 4;
      if (aspect == 15) b.skip(16);   // extended pixel aspect ratio
    } else if (!h263_format(p.format, p.w, p.h)) {
      return "invalid source format";
    }
    if (p.w <= 0 || p.h <= 0) return "invalid picture size";
  }
  return nullptr;
}

std::string upper(const std::string& s) {
  std::string u = s;
  for (char& c : u) c = char(std::toupper(static_cast<unsigned char>(c)));
  return u;
}

constexpr int kDcMax = 119;
constexpr int kMbacBitrate = 50 * 1024, kIiBitrate = 128 * 1024;

}  // namespace

int H263Decoder::variant(const std::string& tag) {
  std::string u = upper(tag);
  if (u == "FLV1" || u == "S263") return kFlv1;     // S263: Sorenson's
  if (u == "MP42" || u == "DIV2") return kV2;
  for (const char* v3 : {"MP43", "DIV3", "MPG3", "DIV4", "DIV5", "DIV6",
                         "DVX3", "AP41", "COL1", "COL0"})
    if (u == v3) return kV3;
  if (u == "WMV1") return kWmv1;
  if (u == "WMV2") return kWmv2;
  if (u == "MPG4" || u == "MP41" || u == "DIV1") return -1;
  // libavformat's riff tags of H.263 and H.263+, upper-cased as
  // ff_codec_get_id matches them at last (so h263 in an AVI too). ZyGo's
  // is not read: libavcodec reads 759 bits of ZyGo's own after the
  // header of each of its I pictures.
  for (const char* e : {"H263", "X263", "T263", "L263", "VX1K", "M263",
                        "LSVM", "U263"})
    if (u == e) return kH263;
  return 0;
}

struct H263Decoder::State {
  int variant = 0;
  std::string tag;
  int width = 0, height = 0, mbw = 0, mbh = 0;
  // Planes at the macroblock-rounded size: the picture being decoded and
  // the reference (libavcodec's current and last pictures).
  struct Pic {
    std::vector<uint8_t> y, u, v;
  } cur, ref;
  bool have_ref = false;

  // Picture header
  int pict_type = 1;                // 1 I, 2 P
  int qscale = 1, y_dc_scale = 8, c_dc_scale = 8;
  int no_rounding = 0;
  bool flipflop = false;
  int64_t bit_rate = 0;
  int rl_table_index = 0, rl_chroma_table_index = 0;
  int dc_table_index = 0, mv_table_index = 0;
  bool use_skip_mb_code = false, per_mb_rl_table = false;
  bool inter_intra_pred = false;
  int slice_height = 0;
  int esc3_level_length = 0, esc3_run_length = 0;
  int picture_number = 0;
  bool droppable = false;
  // The pictures kept as references so far (decoded, or passed over by
  // peek): libavcodec skips a disposable FLV1 picture while it has no
  // older reference (last_picture_ptr), i.e. before the second.
  int kept = 0;
  int flv = 0;                      // FLV1: 1 H.263 escapes, 2 Sorenson's
  // WMV2's extradata header and per-picture modes
  bool mspel_bit = false, loop_filter = false, abt_flag = false;
  bool j_type_bit = false, top_left_mv_flag = false, per_mb_rl_bit = false;
  bool ext_read = false;
  int cbp_table_index = 0;
  bool mspel = false, per_mb_abt = false, per_block_abt = false;
  int abt_type = 0;
  std::vector<uint8_t> skip;        // WMV2's skip map, a macroblock
  // ITU H.263's picture header modes (kept from picture to picture as
  // libavcodec keeps them; H.263+ updates them where UFEP is 1)
  bool umvplus = false, aic = false, slice_structured = false;
  bool alt_inter_vlc = false, modified_quant = false, obmc = false;
  bool long_vectors = false, custom_pcf = false;
  int gob_index = 1, resync_mb_x = 0;
  int chroma_qscale = 1;
  const uint8_t* chroma_table = nullptr;   // null: the identity
  // Which macroblocks of this picture are intra, and its 8x8 vectors
  // (libavcodec's mb_type and motion_val; every variant predicts from
  // the vector grid. ITU H.263 zeroes both at each picture: OBMC reads
  // the next macroblock's before it is decoded, where the macroblock it
  // blends is skipped, and finds zero vectors, not intra).
  std::vector<uint8_t> intra_at;
  std::vector<int16_t> mv8s;
  int b8s = 0;                      // the vector grid's stride, 2 mbw + 1
  int16_t* mv8 = nullptr;           // mv8s at its entry (b8s + 1)
  bool mv8x8 = false;
  int mv4[4][2];                    // this macroblock's 8x8 vectors

  // Per macroblock
  std::vector<uint8_t> skipped;     // this picture's skipped macroblocks
  int mb_x = 0, mb_y = 0, resync_mb_y = 0;
  bool first_slice_line = true;
  bool mb_intra = false, ac_pred = false;
  int aic_dir = 0, hshift = 0;
  int mv[2] = {0, 0};
  alignas(16) int16_t block[6][64];
  alignas(16) int16_t abt2[6][64];  // ABT's second 8x4 / 4x8 block
  int last_index[6];
  int abt_types[6];

  // Predictors: DC (level · scale, 1024 where not intra), AC (16 a
  // block: left column 1..7, top row 9..15) and coded-block flags (v3,
  // WMV), by 8x8 block with a border row above and columns at both sides.
  int lw = 0, cwid = 0;
  std::vector<int16_t> dc[3], ac[3];
  std::vector<uint8_t> coded;
  std::vector<uint8_t> mbq;         // each macroblock's quantiser

  [[noreturn]] void bad(const std::string& m) const {
    broken(tag + " video: " + m + " at macroblock (" + std::to_string(mb_x) +
           ", " + std::to_string(mb_y) + ")");
  }

  bool wmv() const { return variant >= kWmv1; }
  // H.263's macroblock layer (FLV1 and ITU H.263)
  bool itu() const { return variant == kFlv1 || variant == kH263; }
  int version() const {             // libavcodec's msmpeg4_version
    return variant == kV2 ? 2 : variant == kV3 ? 3 : variant == kWmv1 ? 4
           : variant == kWmv2 ? 5 : 0;
  }

  void set_size(int w, int h) {
    width = w;
    height = h;
    mbw = (w + 15) / 16;
    mbh = (h + 15) / 16;
    size_t ys = size_t(mbw) * 16 * mbh * 16;
    for (Pic* p : {&cur, &ref}) {
      p->y.assign(ys, 0);
      p->u.assign(ys / 4, 128);
      p->v.assign(ys / 4, 128);
    }
    have_ref = false;
    lw = 2 * mbw + 2;
    cwid = mbw + 2;
    dc[0].assign(size_t(lw) * (2 * mbh + 1), 1024);
    ac[0].assign(dc[0].size() * 16, 0);
    for (int k = 1; k < 3; ++k) {
      dc[k].assign(size_t(cwid) * (mbh + 1), 1024);
      ac[k].assign(dc[k].size() * 16, 0);
    }
    coded.assign(dc[0].size(), 0);
    skip.assign(size_t(mbw) * mbh, 0);
    skipped.assign(size_t(mbw) * mbh, 0);
    mbq.assign(size_t(mbw) * mbh, 0);
    slice_height = mbh;
    b8s = 2 * mbw + 1;
    intra_at.assign(size_t(mbw) * mbh, 0);
    mv8s.assign((size_t(2 * mbh + 1) * b8s + 2) * 2, 0);
    mv8 = mv8s.data() + size_t(b8s + 1) * 2;
  }

  void set_qscale(int q) {
    qscale = clip(q, 1, 31);
    chroma_qscale = chroma_table ? chroma_table[qscale] : qscale;
    if (variant == kH263) {
      y_dc_scale = aic ? t::kAicDcScale[qscale] : 8;
      c_dc_scale = aic ? t::kAicDcScale[chroma_qscale] : 8;
    } else if (variant == kFlv1 || variant == kV2) {
      y_dc_scale = c_dc_scale = 8;
    } else if (variant == kV3) {
      // FF_BUG_AUTODETECT (cv2's default) picks the old luma scales.
      y_dc_scale = t::kOldYDcScale[qscale];
      c_dc_scale = t::kWmv1CDcScale[qscale];
    } else {
      y_dc_scale = t::kWmv1YDcScale[qscale];
      c_dc_scale = t::kWmv1CDcScale[qscale];
    }
  }

  // Block n's index into dc / ac / coded (its plane's predictor grid).
  size_t pidx(int n) const {
    if (n < 4)
      return size_t(2 * mb_y + (n >> 1) + 1) * lw + 2 * mb_x + (n & 1) + 1;
    return size_t(mb_y + 1) * cwid + mb_x + 1;
  }
  int pwrap(int n) const { return n < 4 ? lw : cwid; }
  int plane_of(int n) const { return n < 4 ? 0 : n - 3; }

  static int decode012(Bits& b) { return b.get1() ? b.get1() + 1 : 0; }

  // ------------------------------------------------------- headers

  // ff_msmpeg4_decode_ext_header: fps, bit rate and (v3+) flip-flop
  // rounding when `left` bits of the picture remain for them.
  void ext_header(Bits& b, long left) {
    int length = version() >= 3 ? 17 : 16;
    if (left >= length && left < length + 8) {
      b.skip(5);
      bit_rate = int64_t(b.get(11)) * 1024;
      flipflop = version() >= 3 ? b.get1() : false;
    } else if (left < length + 8) {
      flipflop = false;
    }
  }

  // ff_msmpeg4_decode_picture_header (v2, v3, WMV1).
  void msmpeg4_header(Bits& b) {
    pict_type = int(b.get(2)) + 1;
    if (pict_type != 1 && pict_type != 2) bad("invalid picture type");
    int q = int(b.get(5));
    if (!q) bad("invalid quantiser");
    qscale = q;
    if (pict_type == 1) {
      int code = int(b.get(5));
      if (code < 0x17) bad("invalid slice code");
      slice_height = mbh / (code - 0x16);
      if (variant == kV2) {
        rl_chroma_table_index = rl_table_index = 2;
        dc_table_index = 0;
      } else if (variant == kV3) {
        rl_chroma_table_index = decode012(b);
        rl_table_index = decode012(b);
        dc_table_index = b.get1();
      } else {
        // The extension header inside the picture header: (2 + 5 + 5 + 17
        // + 7) / 8 bytes.
        ext_header(b, 4 * 8 - long(b.pos));
        per_mb_rl_table = bit_rate > kMbacBitrate ? b.get1() : false;
        if (!per_mb_rl_table) {
          rl_chroma_table_index = decode012(b);
          rl_table_index = decode012(b);
        }
        dc_table_index = b.get1();
        inter_intra_pred = false;
      }
      no_rounding = 1;
    } else {
      if (variant == kV2) {
        use_skip_mb_code = b.get1();
        rl_table_index = rl_chroma_table_index = 2;
        dc_table_index = 0;
        mv_table_index = 0;
      } else if (variant == kV3) {
        use_skip_mb_code = b.get1();
        rl_table_index = rl_chroma_table_index = decode012(b);
        dc_table_index = b.get1();
        mv_table_index = b.get1();
      } else {
        use_skip_mb_code = b.get1();
        per_mb_rl_table = bit_rate > kMbacBitrate ? b.get1() : false;
        if (!per_mb_rl_table)
          rl_table_index = rl_chroma_table_index = decode012(b);
        dc_table_index = b.get1();
        mv_table_index = b.get1();
        inter_intra_pred =
            width * height < 320 * 240 && bit_rate <= kIiBitrate;
      }
      no_rounding = flipflop ? no_rounding ^ 1 : 0;
    }
    esc3_level_length = esc3_run_length = 0;
  }

  // decode_ext_header: WMV2's extradata.
  // Without it libavcodec decodes with every flag clear.
  void wmv2_ext(const std::vector<uint8_t>& extra) {
    if (extra.size() < 4) return;
    Bits b{extra.data(), 4};
    b.skip(5);
    bit_rate = int64_t(b.get(11)) * 1024;
    mspel_bit = b.get1();
    loop_filter = b.get1();
    abt_flag = b.get1();
    j_type_bit = b.get1();
    top_left_mv_flag = b.get1();
    per_mb_rl_bit = b.get1();
    int code = int(b.get(3));
    if (code) slice_height = mbh / code;
  }

  // parse_mb_skip
  void wmv2_skip_map(Bits& b) {
    int type = int(b.get(2));
    std::fill(skip.begin(), skip.end(), 0);
    if (type == 1) {
      for (auto& s : skip) s = uint8_t(b.get1());
    } else if (type == 2) {
      for (int y = 0; y < mbh; ++y) {
        if (b.get1()) {
          for (int x = 0; x < mbw; ++x) skip[size_t(y) * mbw + x] = 1;
        } else {
          for (int x = 0; x < mbw; ++x)
            skip[size_t(y) * mbw + x] = uint8_t(b.get1());
        }
      }
    } else if (type == 3) {
      for (int x = 0; x < mbw; ++x) {
        if (b.get1()) {
          for (int y = 0; y < mbh; ++y) skip[size_t(y) * mbw + x] = 1;
        } else {
          for (int y = 0; y < mbh; ++y)
            skip[size_t(y) * mbw + x] = uint8_t(b.get1());
        }
      }
    }
    if (b.over()) bad("skip map past the packet's end");
  }

  // ff_wmv2_decode_picture_header and _secondary_picture_header; false
  // for a P picture whose skip map skips every macroblock (libavcodec's
  // FRAME_SKIPPED: no picture).
  bool wmv2_header(Bits& b) {
    pict_type = b.get1() + 1;
    if (pict_type == 1) b.skip(7);
    int q = int(b.get(5));
    if (!q) bad("invalid quantiser");
    qscale = q;
    if (pict_type == 2 && b.peek(1)) {
      Bits c = b;
      int type = int(c.get(2));
      int run = type == 3 ? mbw : mbh;
      while (run > 0) {
        int blk = std::min(run, 25);
        if (c.get(blk) + 1 != (1u << blk)) break;
        run -= blk;
      }
      if (!run) return false;
    }
    if (pict_type == 1) {
      bool j_type = j_type_bit ? b.get1() : false;
      if (j_type)
        unsupported(tag + " J-frame (IntraX8), which no encoder here writes");
      per_mb_rl_table = per_mb_rl_bit ? b.get1() : false;
      if (!per_mb_rl_table) {
        rl_chroma_table_index = decode012(b);
        rl_table_index = decode012(b);
      }
      dc_table_index = b.get1();
      inter_intra_pred = false;
      no_rounding = 1;
    } else {
      wmv2_skip_map(b);
      static const uint8_t map[3][3] = {{0, 2, 1}, {1, 0, 2}, {2, 1, 0}};
      cbp_table_index = map[(qscale > 10) + (qscale > 20)][decode012(b)];
      mspel = mspel_bit ? b.get1() : false;
      if (abt_flag) {
        per_mb_abt = b.get1() ^ 1;
        if (!per_mb_abt) abt_type = decode012(b);
      }
      per_mb_rl_table = per_mb_rl_bit ? b.get1() : false;
      if (!per_mb_rl_table)
        rl_table_index = rl_chroma_table_index = decode012(b);
      dc_table_index = b.get1();
      mv_table_index = b.get1();
      inter_intra_pred = false;
      no_rounding ^= 1;
    }
    esc3_level_length = esc3_run_length = 0;
    return true;
  }

  // ff_flv_decode_picture_header
  void flv_header(Bits& b) {
    if (b.get(17) != 1) bad("bad picture start code");
    int format = int(b.get(5));
    if (format > 1) bad("bad picture format");
    flv = format + 1;
    b.skip(8);                      // temporal reference
    int w, h;
    switch (b.get(3)) {
      case 0: w = int(b.get(8)); h = int(b.get(8)); break;
      case 1: w = int(b.get(16)); h = int(b.get(16)); break;
      case 2: w = 352; h = 288; break;
      case 3: w = 176; h = 144; break;
      case 4: w = 128; h = 96; break;
      case 5: w = 320; h = 240; break;
      case 6: w = 160; h = 120; break;
      default: w = h = 0;
    }
    if (w <= 0 || h <= 0) bad("invalid picture size");
    resize(w, h);
    pict_type = 1 + int(b.get(2));
    droppable = pict_type > 2;
    if (droppable) pict_type = 2;
    b.skip(1);                      // deblocking flag
    qscale = int(b.get(5));
    if (!qscale) bad("invalid quantiser");
    while (b.get1()) b.skip(8);     // PEI
  }

  // A picture of another size raises (libavcodec reinitialises).
  void resize(int w, int h) {
    if (w == width && h == height) return;
    if (width && picture_number)
      unsupported(tag + " picture of another size (" + std::to_string(w) +
                  "x" + std::to_string(h) + " after " + std::to_string(width) +
                  "x" + std::to_string(height) + ")");
    set_size(w, h);
  }

  // ff_h263_decode_picture_header: H.263 (PTYPE) and H.263+ (PLUSPTYPE)
  // pictures; false where libavcodec refuses the packet as too short for
  // its size (no picture). What libavcodec ignores (it reads such a
  // picture as if the bit were clear) raises as what it refuses does.
  bool itu_header(Bits& b) {
    ItuPtype p;
    if (const char* e = read_ptype(b, p)) bad(e);
    const std::string h263 = tag + " (H.263) ";
    if (p.sac)
      unsupported(h263 + "syntax-based arithmetic coding (Annex E), which "
                  "libavcodec " + (p.plus ? "ignores" : "refuses") +
                  " and no encoder here writes");
    if (p.pb)
      unsupported(h263 + "PB-frames (Annex G), which no encoder here writes");
    if (p.rps)
      unsupported(h263 + "reference picture selection (Annex N), which "
                  "libavcodec ignores and no encoder here writes");
    if (p.isd)
      unsupported(h263 + "independent segment decoding (Annex R), which "
                  "libavcodec ignores and no encoder here writes");
    if (p.type == 2)
      unsupported(h263 + "improved PB-frames (Annex M), which no encoder "
                  "here writes");
    if (p.type >= 3 && p.type <= 5)
      unsupported(h263 + "B, EI or EP picture (Annex O), which no encoder "
                  "here writes");
    if (p.type == 6) bad("invalid picture type");
    if (p.rpr)
      unsupported(h263 + "reference picture resampling (Annex P), which "
                  "libavcodec ignores and no encoder here writes");
    if (p.rru)
      unsupported(h263 + "reduced-resolution update (Annex Q), which "
                  "libavcodec ignores and no encoder here writes");
    pict_type = p.type == 1 ? 2 : 1;
    if (!p.plus) {
      long_vectors = p.long_vectors;
      obmc = p.obmc;
      qscale = int(b.get(5));
      b.skip(1);                    // continuous presence multipoint
      resize(p.w, p.h);
    } else {
      if (p.ufep) {
        custom_pcf = p.custom_pcf;
        umvplus = p.umvplus;
        obmc = p.obmc;
        aic = p.aic;
        loop_filter = p.loop_filter;
        slice_structured = p.slice_structured;
        alt_inter_vlc = p.alt_inter_vlc;
        modified_quant = p.modified_quant;
        if (modified_quant) chroma_table = t::kH263ChromaQscale;
        resize(p.w, p.h);
        if (custom_pcf) {
          b.skip(1);
          if (!b.get(7)) bad("zero frame rate");
        }
      }
      no_rounding = p.no_rounding;
      if (!width) bad("H.263+ picture without its size (UFEP 0 first)");
      if (custom_pcf) b.skip(2);    // extended temporal reference
      if (p.ufep) {
        if (umvplus && !b.get1()) b.skip(1);   // UUI
        if (slice_structured) {
          if (b.get1())
            unsupported(h263 + "rectangular slices (Annex K), which "
                        "libavcodec ignores");
          if (b.get1())
            unsupported(h263 + "arbitrarily ordered slices (Annex K), "
                        "which libavcodec ignores");
        }
      }
      qscale = int(b.get(5));
    }
    if (width * height / 256 / 8 > b.left()) return false;
    while (b.get1()) b.skip(8);     // PEI
    if (slice_structured) {
      if (!b.get1()) bad("bad SEPB1 marker");
      mba(b);
      if (!b.get1()) bad("bad SEPB2 marker");
    }
    gob_index = height <= 400 ? 1 : height <= 800 ? 2 : 4;
    return true;
  }

  // ff_h263_decode_mba: Annex K's macroblock address.
  void mba(Bits& b) {
    int i = 0;
    while (i < 5 && mbw * mbh - 1 > t::kMbaMax[i]) ++i;
    int pos = int(b.get(t::kMbaLength[i]));
    mb_x = pos % mbw;
    mb_y = pos / mbw;
  }

  // h263_decode_gob_header: a GOB or (Annex K) slice header; false where
  // libavcodec takes it for none.
  bool gob_header(Bits& b) {
    if (b.peek(16)) return false;
    b.skip(16);
    long left = std::min<long>(b.left(), 32);
    for (; left > 13; --left)
      if (b.get1()) break;
    if (left <= 13) return false;
    if (slice_structured) {
      if (!b.get1()) return false;
      mba(b);
      if (mbw * mbh > 1583 && !b.get1()) return false;
      qscale = int(b.get(5));
      if (!b.get1()) return false;
      b.skip(2);                    // GFID
    } else {
      int gn = int(b.get(5));
      mb_x = 0;
      mb_y = gob_index * gn;
      b.skip(2);                    // GFID
      qscale = int(b.get(5));
    }
    return mb_y < mbh && qscale != 0;
  }

  // ff_h263_resync: the next GOB or slice header, where the slice ended,
  // else searched for byte by byte from the slice's start.
  bool resync(Bits& b, size_t slice_start) {
    if (b.peek(16) == 0) {
      Bits c = b;
      if (gob_header(c)) {
        b = c;
        return true;
      }
    }
    Bits c = b;
    c.pos = (slice_start + 7) & ~size_t(7);
    for (long left = c.left(); left > 16 + 1 + 5 + 5; left -= 8) {
      if (c.peek(16) == 0) {
        Bits d = c;
        if (gob_header(d)) {
          b = d;
          return true;
        }
      }
      c.skip(8);
    }
    return false;
  }

  // -------------------------------------------------------- prediction

  // ff_msmpeg4_pred_dc (and libavcodec's inter-intra prediction); the
  // stored DC predictor's index in `at`, the direction (0 left, 1 above).
  int pred_dc(int n, size_t& at, int& dir) {
    int scale = n < 4 ? y_dc_scale : c_dc_scale;
    int k = plane_of(n), wrap = pwrap(n);
    at = pidx(n);
    const std::vector<int16_t>& d = dc[k];
    int a = d[at - 1], b = d[at - 1 - wrap], c = d[at - wrap];
    if (first_slice_line && !(n & 2) && version() < 4) b = c = 1024;
    a = inverse_div(a + (scale >> 1), scale);
    b = inverse_div(b + (scale >> 1), scale);
    c = inverse_div(c + (scale >> 1), scale);
    if (version() > 3) {
      if (inter_intra_pred) {
        if (n == 1) {
          dir = 0;
          return a;
        }
        if (n == 2) {
          dir = 1;
          return c;
        }
        if (n == 3) {
          if (std::abs(a - b) < std::abs(b - c)) {
            dir = 1;
            return c;
          }
          dir = 0;
          return a;
        }
        const uint8_t* dest;
        int stride;
        int cw = mbw * 16;
        if (n < 4) {
          stride = cw;
          dest = &cur.y[size_t((n >> 1) + 2 * mb_y) * 8 * cw +
                        ((n & 1) + 2 * mb_x) * 8];
        } else {
          stride = cw / 2;
          dest = &(n == 4 ? cur.u : cur.v)[size_t(mb_y) * 8 * stride +
                                           mb_x * 8];
        }
        auto get_dc = [&](const uint8_t* s) {
          int sum = 0;
          for (int y = 0; y < 8; ++y)
            for (int x = 0; x < 8; ++x) sum += s[y * stride + x];
          return inverse_div(sum + ((scale * 8) >> 1), scale * 8);
        };
        a = mb_x == 0 ? (1024 + (scale >> 1)) / scale : get_dc(dest - 8);
        c = mb_y == 0 ? (1024 + (scale >> 1)) / scale
                      : get_dc(dest - 8 * stride);
        if (aic_dir == 0) {
          dir = 0;
          return a;
        }
        if (aic_dir == 1) {
          dir = n == 0 ? 1 : 0;
          return n == 0 ? c : a;
        }
        if (aic_dir == 2) {
          dir = n == 0 ? 0 : 1;
          return n == 0 ? a : c;
        }
        dir = 1;
        return c;
      }
      if (std::abs(a - b) < std::abs(b - c)) {
        dir = 1;
        return c;
      }
      dir = 0;
      return a;
    }
    if (std::abs(a - b) <= std::abs(b - c)) {
      dir = 1;
      return c;
    }
    dir = 0;
    return a;
  }

  // msmpeg4_decode_dc: block n's DC level (the predictor plus the coded
  // difference), stored · scale.
  int decode_dc(Bits& b, int n, int& dir) {
    int level;
    if (version() <= 2) {
      level = v2_dc_vlc(n >= 4).read(b);
      if (level < 0) bad("illegal DC code");
      level -= 256;
    } else {
      level = dc_vlc(dc_table_index, n >= 4).read(b);
      if (level < 0) bad("illegal DC code");
      if (level == kDcMax) {
        level = int(b.get(8));
        if (b.get1()) level = -level;
      } else if (level != 0) {
        if (b.get1()) level = -level;
      }
    }
    size_t at;
    level += pred_dc(n, at, dir);
    dc[plane_of(n)][at] =
        int16_t(level * (n < 4 ? y_dc_scale : c_dc_scale));
    return level;
  }

  // ff_mpeg4_pred_ac (one quantiser a picture: no rescaling).
  void pred_ac(int16_t* blk, int n, int dir) {
    int k = plane_of(n);
    int16_t* v = &ac[k][pidx(n) * 16];
    if (ac_pred) {
      if (dir == 0) {
        const int16_t* l = v - 16;
        for (int i = 1; i < 8; ++i) blk[i << 3] = int16_t(blk[i << 3] + l[i]);
      } else {
        const int16_t* a = v - 16 * pwrap(n);
        for (int i = 1; i < 8; ++i) blk[i] = int16_t(blk[i] + a[i + 8]);
      }
    }
    for (int i = 1; i < 8; ++i) v[i] = blk[i << 3];
    for (int i = 1; i < 8; ++i) v[8 + i] = blk[i];
  }

  // ff_msmpeg4_coded_block_pred: block n's predicted coded flag; its
  // index in `at`.
  int coded_pred(int n, size_t& at) {
    at = pidx(n);
    int a = coded[at - 1], b = coded[at - 1 - lw], c = coded[at - lw];
    return b == c ? a : c;
  }

  // ff_clean_intra_table_entries: a macroblock that is not intra.
  void clean_intra() {
    for (int n = 0; n < 6; ++n) {
      size_t at = pidx(n);
      int k = plane_of(n);
      dc[k][at] = 1024;
      std::memset(&ac[k][at * 16], 0, 16 * sizeof(int16_t));
      if (n < 4) coded[at] = 0;
    }
  }

  // ff_mpeg4_clean_buffers at a new slice of v2 and v3: the predictors of
  // the row above the slice.
  void clean_buffers() {
    size_t l0 = size_t(2 * mb_y) * lw;      // the block row above, border
    for (size_t i = l0; i < l0 + size_t(lw); ++i) {
      dc[0][i] = 1024;
      std::memset(&ac[0][i * 16], 0, 16 * sizeof(int16_t));
    }
    for (int k = 1; k < 3; ++k) {
      size_t c0 = size_t(mb_y) * cwid;
      for (size_t i = c0; i < c0 + size_t(cwid); ++i) {
        dc[k][i] = 1024;
        std::memset(&ac[k][i * 16], 0, 16 * sizeof(int16_t));
      }
    }
  }

  // wmv2_pred_motion (the grid's row above the picture and its column
  // past the right edge are never written: zero vectors there)
  void wmv2_pred_motion(Bits& bits, int& px, int& py) {
    const long i = b8_index(0);
    const int16_t *a = mv8_at(i - 1), *b = mv8_at(i - b8s),
                  *c = mv8_at(i + 2 - b8s);
    int diff = 0;
    if (mb_x && !first_slice_line && !mspel && top_left_mv_flag)
      diff = std::max(std::abs(a[0] - b[0]), std::abs(a[1] - b[1]));
    int type = diff >= 8 ? bits.get1() : 2;
    if (type == 0) {
      px = a[0];
      py = a[1];
    } else if (type == 1) {
      px = b[0];
      py = b[1];
    } else if (first_slice_line) {
      px = a[0];
      py = a[1];
    } else {
      px = mid_pred(a[0], b[0], c[0]);
      py = mid_pred(a[1], b[1], c[1]);
    }
  }

  // ff_msmpeg4_decode_motion (v3, WMV)
  void msmpeg4_motion(Bits& b, int& mx, int& my) {
    int sym = mv_vlc(mv_table_index).read(b);
    if (sym < 0) bad("illegal motion vector code");
    int dx, dy;
    if (sym == 1099) {
      dx = int(b.get(6));
      dy = int(b.get(6));
    } else {
      const uint8_t* tx = mv_table_index ? t::kMv1X : t::kMv0X;
      const uint8_t* ty = mv_table_index ? t::kMv1Y : t::kMv0Y;
      dx = tx[sym];
      dy = ty[sym];
    }
    mx += dx - 32;
    my += dy - 32;
    if (mx <= -64) mx += 64;
    else if (mx >= 64) mx -= 64;
    if (my <= -64) my += 64;
    else if (my >= 64) my -= 64;
  }

  // msmpeg4v2_decode_motion (v2; f_code 1) and ff_h263_decode_motion
  // (FLV1, H.263; Annex D's long vectors) of one component. `lenient`:
  // an illegal code gives 0xFFFF, as OBMC's preview takes it.
  int h263_motion(Bits& b, int pred, bool lenient = false) {
    int code = h263_mv_vlc().read(b);
    if (code < 0) {
      if (lenient) return 0xFFFF;
      bad("illegal motion vector code");
    }
    if (code == 0) return pred;
    int val = b.get1() ? -code : code;
    val += pred;
    if (variant == kV2) {
      if (val <= -64) val += 64;
      else if (val >= 64) val -= 64;
      return val;
    }
    if (long_vectors) {
      if (pred < -31 && val < -63) val += 64;
      if (pred > 32 && val > 63) val -= 64;
      return val;
    }
    return ((val + 32) & 63) - 32;  // sign_extend(val, 6)
  }

  // h263p_decode_umotion: Annex D's reversible vector code (UMV in
  // H.263+).
  int umotion(Bits& b, int pred, bool lenient = false) {
    if (b.get1()) return pred;
    int code = 2 + b.get1();
    while (b.get1()) {
      code = (code << 1) + b.get1();
      if (code >= 32768) {
        if (lenient) return 0xFFFF;
        bad("huge motion vector difference");
      }
    }
    return code & 1 ? pred - (code >> 1) : pred + (code >> 1);
  }

  // One vector component of an ITU H.263 macroblock.
  int itu_motion(Bits& b, int pred, bool lenient = false) {
    return umvplus ? umotion(b, pred, lenient) : h263_motion(b, pred, lenient);
  }

  // The 8x8 vector grid of this picture (libavcodec's motion_val: a row
  // of 2 mbw + 1, the last entry shared by the row's right and the next
  // row's left, never written), by linear index.
  int16_t* mv8_at(long i) { return mv8 + 2 * i; }
  long b8_index(int block) const {
    return long(2 * mb_y + (block >> 1)) * b8s + 2 * mb_x + (block & 1);
  }

  // ff_h263_pred_motion of block `block` (0-3) of macroblock (mb_x,
  // mb_y): its median predictor; → its vector's entry.
  int16_t* pred_mv(int block, int& px, int& py) {
    static const int off[4] = {2, 1, 1, -1};
    const long i = b8_index(block);
    int16_t* A = mv8_at(i - 1);
    if (first_slice_line && block < 3) {
      if (block == 0 && mb_x == resync_mb_x) {
        px = py = 0;
      } else if (block < 2) {
        px = A[0];
        py = A[1];
      } else {
        const int16_t* B = mv8_at(i - b8s);
        const int16_t* C = mv8_at(i + off[block] - b8s);
        if (mb_x == resync_mb_x) A[0] = A[1] = 0;
        px = mid_pred(A[0], B[0], C[0]);
        py = mid_pred(A[1], B[1], C[1]);
      }
    } else {
      const int16_t* B = mv8_at(i - b8s);
      const int16_t* C = mv8_at(i + off[block] - b8s);
      px = mid_pred(A[0], B[0], C[0]);
      py = mid_pred(A[1], B[1], C[1]);
    }
    return mv8_at(i);
  }

  void set_mv16(long i, int x, int y) {
    for (long k : {i, i + 1, i + b8s, i + b8s + 1}) {
      mv8_at(k)[0] = int16_t(x);
      mv8_at(k)[1] = int16_t(y);
    }
  }

  // ---------------------------------------------------------- blocks

  // ff_msmpeg4_decode_block: block n's coefficients (natural order);
  // intra levels raw (the DC and AC predicted), inter levels dequantized.
  // `scan`: an inter block's scan (WMV2's ABT), else null.
  void msmpeg4_block(Bits& b, int16_t* blk, int n, bool coded_,
                     const uint8_t* scan) {
    int qmul, qadd, i, run_diff, dir = 0;
    const Rl* rl;
    if (mb_intra) {
      qmul = 1;
      qadd = 0;
      int level = decode_dc(b, n, dir);
      // libavcodec goes on past a negative DC, zeroed under inter-intra
      // prediction.
      if (level < 0 && inter_intra_pred) level = 0;
      if (n < 4) {
        rl = &rl_table(rl_table_index);
        if (level > 256 * y_dc_scale && !inter_intra_pred)
          bad("DC overflow");
      } else {
        rl = &rl_table(3 + rl_chroma_table_index);
        if (level > 256 * c_dc_scale && !inter_intra_pred)
          bad("DC overflow");
      }
      blk[0] = int16_t(level);
      run_diff = version() >= 4;
      i = 0;
      if (!coded_) goto not_coded;
      if (ac_pred) {
        scan = dir == 0 ? (wmv() ? t::kWmv1Scan[3] : kAltVertical)
                        : (wmv() ? t::kWmv1Scan[2] : kAltHorizontal);
      } else {
        scan = wmv() ? t::kWmv1Scan[1] : kZigzag;
      }
    } else {
      qmul = qscale << 1;
      qadd = (qscale - 1) | 1;
      i = -1;
      rl = &rl_table(3 + rl_table_index);
      run_diff = variant == kV2 ? 0 : 1;
      if (!coded_) {
        last_index[n] = -1;
        return;
      }
      if (!scan) scan = wmv() ? t::kWmv1Scan[0] : kZigzag;
    }
    for (;;) {
      int sym = rl->vlc.read(b);
      if (sym < 0) bad("illegal AC code");
      int level, run, last;
      if (sym != rl->n) {
        run = rl->run[sym] + 1;
        level = rl->level[sym] * qmul + qadd;
        last = sym >= rl->last;
        i += run;
        if (b.get1()) level = -level;
      } else if (!b.peek(1)) {
        if (!(b.peek(2) & 1)) {
          // third escape
          b.skip(2);
          if (version() <= 3) {
            last = b.get1();
            run = int(b.get(6));
            level = int(int8_t(b.get(8)));
          } else {
            last = b.get1();
            if (!esc3_level_length) {
              int ll;
              if (qscale < 8) {
                ll = int(b.get(3));
                if (ll == 0) ll = 8 + b.get1();
              } else {
                ll = 2;
                while (ll < 8 && b.peek(1) == 0) {
                  ++ll;
                  b.skip(1);
                }
                if (ll < 8) b.skip(1);
              }
              esc3_level_length = ll;
              esc3_run_length = int(b.get(2)) + 3;
            }
            run = int(b.get(esc3_run_length));
            int sign = b.get1();
            level = int(b.get(esc3_level_length));
            if (sign) level = -level;
          }
          level = level > 0 ? level * qmul + qadd : level * qmul - qadd;
          i += run + 1;
        } else {
          // second escape
          b.skip(2);
          sym = rl->vlc.read(b);
          if (sym < 0 || sym == rl->n) bad("illegal AC code");
          run = rl->run[sym] + 1;
          last = sym >= rl->last;
          level = rl->level[sym] * qmul + qadd;
          i += run + rl->max_run[last][level / qmul] + run_diff;
          if (b.get1()) level = -level;
        }
      } else {
        // first escape
        b.skip(1);
        sym = rl->vlc.read(b);
        if (sym < 0 || sym == rl->n) bad("illegal AC code");
        run = rl->run[sym] + 1;
        last = sym >= rl->last;
        level = rl->level[sym] * qmul + qadd;
        i += run;
        level += rl->max_level[last][(run - 1) & 63] * qmul;
        if (b.get1()) level = -level;
      }
      // libavcodec's "ignoring overflow": a coefficient past 63, or one
      // at 63 that is not the last, ends the block unstored.
      if (i > (last ? 63 : 62)) {
        i = 63;
        break;
      }
      blk[scan[i]] = int16_t(level);
      if (last) break;
    }
  not_coded:
    if (mb_intra) {
      pred_ac(blk, n, dir);
      if (ac_pred) i = 63;
    }
    if (version() >= 4 && i > 0) i = 63;
    last_index[n] = i;
  }

  // --------------------------------------------------------- macroblocks

  // msmpeg4v12_decode_mb (v2)
  void mb_v2(Bits& b) {
    int cbp;
    if (pict_type == 2) {
      if (use_skip_mb_code && b.get1()) {
        skip_mb();
        return;
      }
      int code = v2_mb_type_vlc().read(b);
      if (code < 0 || code > 7) bad("invalid macroblock type");
      mb_intra = code >> 2;
      cbp = code & 3;
    } else {
      mb_intra = true;
      cbp = v2_intra_cbpc_vlc().read(b);
      if (cbp < 0 || cbp > 3) bad("invalid intra cbp");
    }
    if (!mb_intra) {
      int cbpy = cbpy_vlc().read(b);
      if (cbpy < 0) bad("invalid CBPY");
      cbp |= cbpy << 2;
      if ((cbp & 3) != 3) cbp ^= 0x3C;
      int mx, my;
      pred_mv(0, mx, my);
      mv[0] = h263_motion(b, mx);
      mv[1] = h263_motion(b, my);
    } else {
      ac_pred = b.get1();
      int v = cbpy_vlc().read(b);
      if (v < 0) bad("invalid CBPY");
      cbp |= v << 2;
    }
    blocks(b, cbp);
  }

  // msmpeg4v34_decode_mb (v3, WMV1)
  void mb_v34(Bits& b) {
    int cbp;
    if (pict_type == 2) {
      if (use_skip_mb_code && b.get1()) {
        skip_mb();
        return;
      }
      int code = mb_non_intra_vlc(3).read(b);
      if (code < 0) bad("invalid macroblock type");
      mb_intra = !(code & 0x40);
      cbp = code & 0x3F;
    } else {
      mb_intra = true;
      int code = mb_i_vlc().read(b);
      if (code < 0) bad("invalid intra cbp");
      cbp = intra_cbp(code);
    }
    if (!mb_intra) {
      if (per_mb_rl_table && cbp)
        rl_table_index = rl_chroma_table_index = decode012(b);
      int mx, my;
      pred_mv(0, mx, my);
      msmpeg4_motion(b, mx, my);
      mv[0] = mx;
      mv[1] = my;
    } else {
      ac_pred = b.get1();
      if (inter_intra_pred) {
        aic_dir = inter_intra_vlc().read(b);
        if (aic_dir < 0) bad("invalid inter-intra direction");
      }
      if (per_mb_rl_table && cbp)
        rl_table_index = rl_chroma_table_index = decode012(b);
    }
    blocks(b, cbp);
  }

  // An I macroblock's coded flags, luma predicted from its neighbours'.
  int intra_cbp(int code) {
    int cbp = 0;
    for (int i = 0; i < 6; ++i) {
      int val = (code >> (5 - i)) & 1;
      if (i < 4) {
        size_t at;
        val ^= coded_pred(i, at);
        coded[at] = uint8_t(val);
      }
      cbp |= val << (5 - i);
    }
    return cbp;
  }

  void blocks(Bits& b, int cbp) {
    for (int i = 0; i < 6; ++i)
      msmpeg4_block(b, block[i], i, (cbp >> (5 - i)) & 1, nullptr);
  }

  void skip_mb() {
    mb_intra = false;
    for (int& l : last_index) l = -1;
    mv[0] = mv[1] = 0;
    hshift = 0;
  }

  // wmv2_decode_mb
  void mb_wmv2(Bits& b) {
    int cbp;
    if (pict_type == 2) {
      if (skip[size_t(mb_y) * mbw + mb_x]) {
        skip_mb();
        return;
      }
      if (b.left() <= 0) bad("packet ends early");
      int code = mb_non_intra_vlc(cbp_table_index).read(b);
      if (code < 0) bad("invalid macroblock type");
      mb_intra = !(code & 0x40);
      cbp = code & 0x3F;
    } else {
      mb_intra = true;
      if (b.left() <= 0) bad("packet ends early");
      int code = mb_i_vlc().read(b);
      if (code < 0) bad("invalid intra cbp");
      cbp = intra_cbp(code);
    }
    if (!mb_intra) {
      int mx, my;
      wmv2_pred_motion(b, mx, my);
      if (cbp) {
        if (per_mb_rl_table)
          rl_table_index = rl_chroma_table_index = decode012(b);
        if (abt_flag && per_mb_abt) {
          per_block_abt = b.get1();
          if (!per_block_abt) abt_type = decode012(b);
        } else {
          per_block_abt = false;
        }
      }
      msmpeg4_motion(b, mx, my);
      hshift = ((mx | my) & 1) && mspel ? b.get1() : 0;
      mv[0] = mx;
      mv[1] = my;
      static const int sub_cbp_table[3] = {2, 3, 1};
      for (int n = 0; n < 6; ++n) {
        if (!((cbp >> (5 - n)) & 1)) {
          last_index[n] = -1;
          continue;
        }
        if (per_block_abt) abt_type = decode012(b);
        abt_types[n] = abt_type;
        if (abt_type) {
          const uint8_t* scan = abt_type == 1 ? t::kWmv2ScanA : t::kWmv2ScanB;
          int sub = sub_cbp_table[decode012(b)];
          if (sub & 1) msmpeg4_block(b, block[n], n, true, scan);
          if (sub & 2) msmpeg4_block(b, abt2[n], n, true, scan);
          last_index[n] = 63;
        } else {
          msmpeg4_block(b, block[n], n, true, t::kWmv1Scan[0]);
        }
      }
    } else {
      ac_pred = b.get1();
      if (per_mb_rl_table && cbp)
        rl_table_index = rl_chroma_table_index = decode012(b);
      blocks(b, cbp);
    }
  }

  // h263_decode_dquant (Annex T's steps where modified_quant is set).
  void itu_dquant(Bits& b) {
    static const int kQuantTab[4] = {-1, -2, 1, 2};
    if (!modified_quant) set_qscale(qscale + kQuantTab[b.get(2)]);
    else if (b.get1()) set_qscale(t::kModifiedQuant[b.get1()][qscale]);
    else set_qscale(int(b.get(5)));
  }

  // ff_h263_decode_mb of an FLV1 or ITU H.263 macroblock (its vectors
  // into this picture's grid, whether it is intra into intra_at); →
  // whether its slice ends after it (the next 16 bits, or what is left of
  // them, all zero).
  bool mb_itu(Bits& b) {
    const int xy = mb_y * mbw + mb_x;
    int cbpc, cbp;
    bool dquant;
    if (pict_type == 2) {
      do {
        if (b.get1()) {
          skip_mb();
          skipped[size_t(xy)] = 1;
          goto end;
        }
        cbpc = inter_mcbpc_vlc().read(b);
        if (cbpc < 0) bad("damaged MCBPC");
      } while (cbpc == 20);
      if (variant == kFlv1 && (cbpc & 16))
        bad("4MV macroblock (not in FLV1)");
      dquant = cbpc & 8;
      mb_intra = (cbpc & 4) != 0;
      if (!mb_intra) {
        int cbpy = cbpy_vlc().read(b);
        if (cbpy < 0) bad("damaged CBPY");
        if (!alt_inter_vlc || (cbpc & 3) != 3) cbpy ^= 0xF;
        cbp = (cbpc & 3) | (cbpy << 2);
        if (dquant) itu_dquant(b);
        int px, py;
        if (!(cbpc & 16)) {
          pred_mv(0, px, py);
          mv[0] = itu_motion(b, px);
          mv[1] = itu_motion(b, py);
          if (umvplus && mv[0] - px == 1 && mv[1] - py == 1) b.skip(1);
        } else {
          mv8x8 = true;
          for (int i = 0; i < 4; ++i) {
            int16_t* m = pred_mv(i, px, py);
            mv4[i][0] = itu_motion(b, px);
            mv4[i][1] = itu_motion(b, py);
            if (umvplus && mv4[i][0] - px == 1 && mv4[i][1] - py == 1)
              b.skip(1);
            m[0] = int16_t(mv4[i][0]);
            m[1] = int16_t(mv4[i][1]);
          }
        }
      }
    } else {
      do {
        cbpc = intra_mcbpc_vlc().read(b);
        if (cbpc < 0) bad("damaged MCBPC");
      } while (cbpc == 8);
      dquant = cbpc & 4;
      mb_intra = true;
    }
    if (mb_intra) {
      if (aic) {
        ac_pred = b.get1();
        if (ac_pred) aic_dir = b.get1();
      }
      int cbpy = cbpy_vlc().read(b);
      if (cbpy < 0) bad("damaged CBPY");
      cbp = (cbpc & 3) | (cbpy << 2);
      if (dquant) itu_dquant(b);
    }
    for (int i = 0; i < 6; ++i)
      itu_block(b, block[i], i, (cbp >> (5 - i)) & 1);
    if (obmc && !mb_intra && pict_type == 2 && mb_x + 1 < mbw)
      preview_obmc(b);
  end:
    intra_at[size_t(xy)] = mb_intra;
    if (b.over()) bad("packet ends inside the macroblock");
    uint32_t v = b.peek(16);
    if (b.left() < 16) v >>= 16 - b.left();
    return v == 0;
  }

  // preview_obmc: the next macroblock's type and vectors, read ahead
  // (from a copy of the reader) for this one's OBMC (not for a skipped
  // one, which finds the next macroblock's zeroed).
  void preview_obmc(Bits b) {
    ++mb_x;
    const int xy = mb_y * mbw + mb_x;
    const long i0 = b8_index(0);
    int cbpc, px, py;
    do {
      if (b.get1()) {
        set_mv16(i0, 0, 0);
        intra_at[size_t(xy)] = 0;
        --mb_x;
        return;
      }
      cbpc = inter_mcbpc_vlc().read(b);
    } while (cbpc == 20);
    intra_at[size_t(xy)] = (cbpc & 4) != 0;   // intra, or a bad code
    if (!(cbpc & 4)) {
      cbpy_vlc().read(b);
      if (cbpc & 8) {
        if (!modified_quant) b.skip(2);
        else b.skip(b.get1() ? 1 : 5);
      }
      if (!(cbpc & 16)) {
        pred_mv(0, px, py);
        int mx = itu_motion(b, px, true);
        int my = itu_motion(b, py, true);
        set_mv16(i0, mx, my);
      } else {
        for (int i = 0; i < 4; ++i) {
          int16_t* m = pred_mv(i, px, py);
          int mx = itu_motion(b, px, true);
          int my = itu_motion(b, py, true);
          if (umvplus && mx - px == 1 && my - py == 1) b.skip(1);
          m[0] = int16_t(mx);
          m[1] = int16_t(my);
        }
      }
    }
    --mb_x;
  }

  // h263_decode_block of an FLV1 or ITU H.263 block: levels raw, in
  // natural order; Annex I's intra blocks (their DC among the levels)
  // predicted by pred_acdc; Annex S's inter blocks read again with Annex
  // I's table where H.263's overruns the block.
  void itu_block(Bits& b, int16_t* blk, int n, bool coded_) {
    const Rl* rl = &rl_table(5);
    const uint8_t* scan = kZigzag;
    int i = 0;
    const Bits start = b;
    if (aic && mb_intra) {
      rl = &aic_rl();
      if (ac_pred) scan = aic_dir ? kAltVertical : kAltHorizontal;
    } else if (mb_intra) {
      int level = int(b.get(8));
      if (level == 255) level = 128;
      blk[0] = int16_t(level);
      i = 1;
    }
    if (!coded_) {
      if (!(mb_intra && aic)) {
        last_index[n] = i - 1;
        return;
      }
    } else {
    retry:
      --i;
      for (;;) {
        int sym = rl->vlc.read(b);
        if (sym < 0) bad("illegal AC code");
        int level, run;
        bool last;
        if (sym == rl->n && flv > 1) {
          bool is11 = b.get1();     // Sorenson's: an 11-bit level, else 7
          last = b.get1();
          run = int(b.get(6)) + 1;
          int v = int(b.get(is11 ? 11 : 7));
          level = v >= (is11 ? 1024 : 64) ? v - (is11 ? 2048 : 128) : v;
        } else if (sym == rl->n) {
          last = b.get1();
          run = int(b.get(6)) + 1;
          level = int(int8_t(b.get(8)));
          if (level == -128) {      // Annex T's extended escape
            int lo = int(b.get(5));
            int hi = int(b.get(6));
            level = lo | ((hi >= 32 ? hi - 64 : hi) * 32);
          }
        } else {
          run = rl->run[sym] + 1;
          level = rl->level[sym];
          last = sym >= rl->last;
          if (b.get1()) level = -level;
        }
        i += run;
        if (i >= 64) {
          if (alt_inter_vlc && rl == &rl_table(5) && !mb_intra) {
            rl = &aic_rl();
            i = 0;
            b = start;
            std::memset(blk, 0, 64 * sizeof(int16_t));
            goto retry;
          }
          bad("run overflow");
        }
        blk[scan[i]] = int16_t(level);
        if (last) break;
      }
    }
    if (mb_intra && aic) {
      pred_acdc(blk, n);
      i = 63;
    }
    last_index[n] = i;
  }

  // ff_h263_pred_acdc (Annex I): the DC from the left or above (their
  // mean without AC prediction), the first row or column of levels from
  // the block the direction names; none across the slice's first row.
  void pred_acdc(int16_t* blk, int n) {
    const int k = plane_of(n), wrap = pwrap(n);
    const size_t at = pidx(n);
    std::vector<int16_t>& d = dc[k];
    int16_t* acv = &ac[k][at * 16];
    int a = d[at - 1], c = d[at - wrap];
    if (first_slice_line && n != 3) {
      if (n != 2) c = 1024;
      if (n != 1 && mb_x == resync_mb_x) a = 1024;
    }
    int pred = 1024;
    if (ac_pred) {
      if (aic_dir) {
        if (a != 1024) {
          const int16_t* l = acv - 16;
          for (int j = 1; j < 8; ++j)
            blk[j << 3] = int16_t(blk[j << 3] + l[j]);
          pred = a;
        }
      } else if (c != 1024) {
        const int16_t* u = acv - 16 * wrap;
        for (int j = 1; j < 8; ++j) blk[j] = int16_t(blk[j] + u[j + 8]);
        pred = c;
      }
    } else if (a != 1024 && c != 1024) {
      pred = (a + c) >> 1;
    } else if (a != 1024) {
      pred = a;
    } else {
      pred = c;
    }
    int dcv = blk[0] * (n < 4 ? y_dc_scale : c_dc_scale) + pred;
    dcv = dcv < 0 ? 0 : dcv | 1;
    blk[0] = int16_t(dcv);
    d[at] = int16_t(dcv);
    for (int j = 1; j < 8; ++j) acv[j] = blk[j << 3];
    for (int j = 1; j < 8; ++j) acv[8 + j] = blk[j];
  }

  // ----------------------------------------------------- reconstruction

  // dct_unquantize_h263_intra / _inter of block n (chroma at the chroma
  // quantiser; Annex I's intra blocks without the rounding offset, their
  // DC as predicted).
  void unquant(int16_t* blk, int n, bool intra) {
    const int q = n < 4 ? qscale : chroma_qscale;
    int qmul = q << 1, qadd = (q - 1) | 1;
    int start = 0;
    if (intra && variant == kH263 && aic) {
      qadd = 0;
      start = 1;
    } else if (intra) {
      blk[0] = int16_t(blk[0] * (n < 4 ? y_dc_scale : c_dc_scale));
      start = 1;
    }
    for (int i = start; i < 64; ++i) {
      int l = blk[i];
      if (l) blk[i] = int16_t(l < 0 ? l * qmul - qadd : l * qmul + qadd);
    }
  }

  uint8_t* dest(int n) {
    int cw = mbw * 16;
    if (n < 4)
      return &cur.y[size_t(16 * mb_y + 8 * (n >> 1)) * cw + 16 * mb_x +
                    8 * (n & 1)];
    return &(n == 4 ? cur.u : cur.v)[size_t(8 * mb_y) * (cw / 2) + 8 * mb_x];
  }

  // hpel_motion of the 8x8 luma block at (x0, y0) with vector (mx, my)
  // into dst.
  void hpel8(const Plane& p, int x0, int y0, int mx, int my, uint8_t* dst,
             int ds) {
    int dxy = 0;
    int sx = clip(x0 + (mx >> 1), -16, width);
    if (sx != width) dxy |= mx & 1;
    int sy = clip(y0 + (my >> 1), -16, height);
    if (sy != height) dxy |= (my & 1) << 1;
    hpel(p, sx, sy, dxy, no_rounding, false, dst, ds, 8, 8);
  }

  // chroma_4mv_motion: both chroma blocks from the sum of the four luma
  // vectors, rounded by ff_h263_round_chroma.
  void chroma4mv(const Plane& pu, const Plane& pv, int mx, int my) {
    const int cs = mbw * 8;
    mx = round_chroma(mx);
    my = round_chroma(my);
    int dxy = ((my & 1) << 1) | (mx & 1);
    int sx = clip(8 * mb_x + (mx >> 1), -8, width >> 1);
    if (sx == (width >> 1)) dxy &= ~1;
    int sy = clip(8 * mb_y + (my >> 1), -8, height >> 1);
    if (sy == (height >> 1)) dxy &= ~2;
    hpel(pu, sx, sy, dxy, no_rounding, false, dest(4), cs, 8, 8);
    hpel(pv, sx, sy, dxy, no_rounding, false, dest(5), cs, 8, 8);
  }

  // Annex F's OBMC (mpv_motion_internal): each 8x8 luma block blended
  // from its own vector's prediction and its neighbours' (the
  // macroblock above and to the left as decoded, to the right as
  // preview_obmc read it or zero; an intra neighbour or the picture's
  // edge lends the block's own); chroma from the four vectors.
  void obmc_motion(const Plane& py, const Plane& pu, const Plane& pv) {
    int16_t cache[4][4][2];
    const long i0 = b8_index(0);
    auto put = [&](int r, int c, long i) {
      cache[r][c][0] = mv8_at(i)[0];
      cache[r][c][1] = mv8_at(i)[1];
    };
    auto same = [&](int r, int c, int r2, int c2) {
      cache[r][c][0] = cache[r2][c2][0];
      cache[r][c][1] = cache[r2][c2][1];
    };
    const int xy = mb_y * mbw + mb_x;
    put(1, 1, i0);
    put(1, 2, i0 + 1);
    put(2, 1, i0 + b8s);
    put(2, 2, i0 + b8s + 1);
    same(3, 1, 2, 1);
    same(3, 2, 2, 2);
    if (mb_y == 0 || intra_at[size_t(xy - mbw)]) {
      same(0, 1, 1, 1);
      same(0, 2, 1, 2);
    } else {
      put(0, 1, i0 - b8s);
      put(0, 2, i0 - b8s + 1);
    }
    if (mb_x == 0 || intra_at[size_t(xy - 1)]) {
      same(1, 0, 1, 1);
      same(2, 0, 2, 1);
    } else {
      put(1, 0, i0 - 1);
      put(2, 0, i0 - 1 + b8s);
    }
    if (mb_x + 1 >= mbw || intra_at[size_t(xy + 1)]) {
      same(1, 3, 1, 2);
      same(2, 3, 2, 2);
    } else {
      put(1, 3, i0 + 2);
      put(2, 3, i0 + 2 + b8s);
    }
    const int cw = mbw * 16;
    int sx = 0, sy = 0;
    for (int i = 0; i < 4; ++i) {
      const int x = (i & 1) + 1, y = (i >> 1) + 1;
      const int16_t* v[5] = {cache[y][x], cache[y - 1][x], cache[y][x - 1],
                             cache[y][x + 1], cache[y + 1][x]};
      uint8_t pred[5][64];
      const int x0 = 16 * mb_x + 8 * (i & 1), y0 = 16 * mb_y + 8 * (i >> 1);
      for (int k = 0; k < 5; ++k) {
        if (k && v[k][0] == v[0][0] && v[k][1] == v[0][1])
          std::memcpy(pred[k], pred[0], 64);
        else
          hpel8(py, x0, y0, v[k][0], v[k][1], pred[k], 8);
      }
      uint8_t* d = dest(0) + 8 * (i & 1) + size_t(8 * (i >> 1)) * cw;
      for (int r = 0; r < 8; ++r)
        for (int c = 0; c < 8; ++c) {
          const int j = 8 * r + c;
          const int tb = kObmcVert[r][c], lr = kObmcHorz[r][c];
          int sum = kObmcMid[r][c] * pred[0][j] + 4;
          sum += tb * (r < 4 ? pred[1][j] : pred[4][j]);
          sum += lr * (c < 4 ? pred[2][j] : pred[3][j]);
          d[size_t(r) * cw + c] = uint8_t(sum >> 3);
        }
      sx += v[0][0];
      sy += v[0][1];
    }
    chroma4mv(pu, pv, sx, sy);
  }

  void motion() {
    int cw = mbw * 16, cs = cw / 2;
    Plane py{ref.y.data(), cw, cw, mbh * 16};
    Plane pu{ref.u.data(), cs, cs, mbh * 8};
    Plane pv{ref.v.data(), cs, cs, mbh * 8};
    if (variant == kH263 && obmc) {
      obmc_motion(py, pu, pv);
      return;
    }
    if (variant == kH263 && mv8x8) {
      int sx = 0, sy = 0;
      for (int i = 0; i < 4; ++i) {
        hpel8(py, 16 * mb_x + 8 * (i & 1), 16 * mb_y + 8 * (i >> 1),
              mv4[i][0], mv4[i][1],
              dest(0) + 8 * (i & 1) + size_t(8 * (i >> 1)) * cw, cw);
        sx += mv4[i][0];
        sy += mv4[i][1];
      }
      chroma4mv(pu, pv, sx, sy);
      return;
    }
    int vx = mv[0], vy = mv[1];
    if (variant == kWmv2 && mspel) {
      // ff_mspel_motion
      int dxy = 2 * (((vy & 1) << 1) | (vx & 1)) + hshift;
      int sx = clip(16 * mb_x + (vx >> 1), -16, width);
      int sy = clip(16 * mb_y + (vy >> 1), -16, height);
      if (sx <= -16 || sx >= width) dxy &= ~3;
      if (sy <= -16 || sy >= height) dxy &= ~4;
      for (int k = 0; k < 4; ++k)
        mspel8(py, sx + 8 * (k & 1), sy + 8 * (k >> 1), dxy,
               dest(0) + 8 * (k & 1) + 8 * (k >> 1) * cw, cw);
      int cdxy = ((vx & 3) != 0) | (((vy & 3) != 0) << 1);
      int cx = clip(8 * mb_x + (vx >> 2), -8, width >> 1);
      if (cx == (width >> 1)) cdxy &= ~1;
      int cy = clip(8 * mb_y + (vy >> 2), -8, height >> 1);
      if (cy == (height >> 1)) cdxy &= ~2;
      hpel(pu, cx, cy, cdxy, no_rounding, false, dest(4), cs, 8, 8);
      hpel(pv, cx, cy, cdxy, no_rounding, false, dest(5), cs, 8, 8);
      return;
    }
    int dxy = ((vy & 1) << 1) | (vx & 1);
    int sx = 16 * mb_x + (vx >> 1), sy = 16 * mb_y + (vy >> 1);
    hpel(py, sx, sy, dxy, no_rounding, false, dest(0), cw, 16, 16);
    int cdxy = dxy | (vy & 2) | ((vx & 2) >> 1);
    hpel(pu, sx >> 1, sy >> 1, cdxy, no_rounding, false, dest(4), cs, 8, 8);
    hpel(pv, sx >> 1, sy >> 1, cdxy, no_rounding, false, dest(5), cs, 8, 8);
  }

  void reconstruct() {
    int cw = mbw * 16;
    if (mb_intra) {
      for (int n = 0; n < 6; ++n) {
        int16_t* blk = block[n];
        unquant(blk, n, true);
        if (variant == kWmv2)
          wmv2_idct(blk, dest(n), n < 4 ? cw : cw / 2, false);
        else
          idct_put(blk, dest(n), n < 4 ? cw : cw / 2);
      }
      return;
    }
    motion();
    for (int n = 0; n < 6; ++n) {
      if (last_index[n] < 0) continue;
      int16_t* blk = block[n];
      ptrdiff_t st = n < 4 ? cw : cw / 2;
      if (itu()) unquant(blk, n, false);
      if (variant != kWmv2) {
        idct_add(blk, dest(n), st);
      } else if (abt_types[n] == 0) {
        wmv2_idct(blk, dest(n), st, true);
      } else if (abt_types[n] == 1) {
        idct84_add(blk, dest(n), st);
        idct84_add(abt2[n], dest(n) + 4 * st, st);
      } else {
        idct48_add(blk, dest(n), st);
        idct48_add(abt2[n], dest(n) + 4, st);
      }
    }
  }

  // One macroblock: its syntax, its vectors kept, its pixels; → whether
  // an ITU H.263 slice ends after it.
  bool macroblock(Bits& b) {
    std::memset(block, 0, sizeof(block));
    std::memset(abt2, 0, sizeof(abt2));
    for (int& a : abt_types) a = 0;
    mv[0] = mv[1] = 0;
    mv8x8 = false;
    ac_pred = false;
    bool end = false;
    switch (variant) {
      case kFlv1:
      case kH263: end = mb_itu(b); break;
      case kV2: mb_v2(b); break;
      case kWmv2: mb_wmv2(b); break;
      default: mb_v34(b);
    }
    if (b.over()) bad("packet ends inside the macroblock");
    const int mx = mb_intra ? 0 : mv[0], my = mb_intra ? 0 : mv[1];
    // ff_h263_update_motion_val (an 8x8 macroblock's were kept as read)
    if (!mv8x8) set_mv16(b8_index(0), mx, my);
    mbq[size_t(mb_y) * mbw + mb_x] = uint8_t(qscale);
    if (!mb_intra && variant != kFlv1) clean_intra();
    if (!mb_intra && !have_ref) bad("P picture without a reference");
    reconstruct();
    if (loop_filter) loop_filter_mb();
    return end;
  }

  // ff_h263_loop_filter after macroblock (mb_x, mb_y) (each macroblock
  // at its own quantiser, chroma at Annex T's chroma quantiser; a
  // skipped macroblock's edges are filtered by its neighbours').
  void loop_filter_mb() {
    int cw = mbw * 16, cs = cw / 2;
    uint8_t *y = dest(0), *cb = dest(4), *cr = dest(5);
    auto q_of = [&](int x, int yy) {
      const size_t i = size_t(yy) * mbw + x;
      return skipped[i] ? 0 : int(mbq[i]);
    };
    auto cq = [&](int q) { return chroma_table ? int(chroma_table[q]) : q; };
    int qp_c = q_of(mb_x, mb_y);
    if (qp_c) {
      h263_edge(y + 8 * cw, cw, 1, qp_c);
      h263_edge(y + 8 * cw + 8, cw, 1, qp_c);
    }
    if (mb_y) {
      int qp_tt = q_of(mb_x, mb_y - 1);
      int qp_tc = qp_c ? qp_c : qp_tt;
      if (qp_tc) {
        h263_edge(y, cw, 1, qp_tc);
        h263_edge(y + 8, cw, 1, qp_tc);
        h263_edge(cb, cs, 1, cq(qp_tc));
        h263_edge(cr, cs, 1, cq(qp_tc));
      }
      if (qp_tt) h263_edge(y - 8 * cw + 8, 1, cw, qp_tt);
      if (mb_x) {
        int qp_dt = qp_tt || skipped[size_t(mb_y - 1) * mbw + mb_x - 1]
                        ? qp_tt
                        : q_of(mb_x - 1, mb_y - 1);
        if (qp_dt) {
          h263_edge(y - 8 * cw, 1, cw, qp_dt);
          h263_edge(cb - 8 * cs, 1, cs, cq(qp_dt));
          h263_edge(cr - 8 * cs, 1, cs, cq(qp_dt));
        }
      }
    }
    if (qp_c) {
      h263_edge(y + 8, 1, cw, qp_c);
      if (mb_y + 1 == mbh) h263_edge(y + 8 * cw + 8, 1, cw, qp_c);
    }
    if (mb_x) {
      int qp_lc = qp_c || skipped[size_t(mb_y) * mbw + mb_x - 1]
                      ? qp_c
                      : q_of(mb_x - 1, mb_y);
      if (qp_lc) {
        h263_edge(y, 1, cw, qp_lc);
        if (mb_y + 1 == mbh) {
          h263_edge(y + 8 * cw, 1, cw, qp_lc);
          h263_edge(cb, 1, cs, cq(qp_lc));
          h263_edge(cr, 1, cs, cq(qp_lc));
        }
      }
    }
  }

  // ff_h263_decode_frame's slice loop over the picture.
  void picture_data(Bits& b) {
    set_qscale(qscale);
    mb_y = 0;
    bool first = true;
    while (mb_y < mbh) {
      if (!first && version() && version() < 4) clean_buffers();
      first = false;
      resync_mb_y = mb_y;
      first_slice_line = true;
      int end = variant == kFlv1 ? mbh : std::min(mbh, mb_y + slice_height);
      if (variant != kFlv1 && slice_height <= 0) bad("zero slice height");
      for (; mb_y < end; ++mb_y) {
        for (mb_x = 0; mb_x < mbw; ++mb_x) {
          if (mb_x == 0 && mb_y == resync_mb_y + 1) first_slice_line = false;
          macroblock(b);
        }
      }
    }
  }

  // ff_h263_decode_frame's slice loop over an ITU H.263 picture:
  // decode_slice from (0, 0), then from each GOB or slice header
  // (ff_h263_resync) until the last macroblock. Where a header is missing
  // or names another macroblock than the next, libavcodec conceals the
  // macroblocks it leaves out, and the port raises.
  void picture_itu(Bits& b) {
    mb_x = mb_y = 0;
    size_t start = b.pos;
    slice_itu(b, start);
    while (mb_y < mbh) {
      const int next = mb_y * mbw + mb_x;
      if (!resync(b, start))
        bad("no GOB or slice header where a slice ends (libavcodec "
            "conceals the rest)");
      if (mb_y * mbw + mb_x != next)
        bad("a GOB or slice header where macroblock " + std::to_string(next) +
            " is next (libavcodec conceals the macroblocks left out)");
      slice_itu(b, start);
    }
  }

  // decode_slice: macroblocks from (mb_x, mb_y) until one whose slice
  // ends; the predictors' borders at the slice's first row.
  void slice_itu(Bits& b, size_t& start) {
    start = b.pos;
    first_slice_line = true;
    resync_mb_x = mb_x;
    resync_mb_y = mb_y;
    set_qscale(qscale);
    for (; mb_y < mbh; ++mb_y) {
      for (; mb_x < mbw; ++mb_x) {
        if (mb_x == resync_mb_x && mb_y == resync_mb_y + 1)
          first_slice_line = false;
        if (macroblock(b)) {
          if (++mb_x >= mbw) {
            mb_x = 0;
            ++mb_y;
          }
          return;
        }
      }
      mb_x = 0;
    }
  }

  void output(Picture& out) const {
    int cw = mbw * 16;
    out.w = width;
    out.h = height;
    out.ystride = cw;
    out.cstride = cw / 2;
    out.y = cur.y;
    out.u = cur.u;
    out.v = cur.v;
    out.xshift = out.yshift = 1;
    out.full_range = false;
  }

  bool decode(const uint8_t* d, size_t n, Picture& out) {
    if (!n) return false;
    Bits b{d, n};
    if (variant == kH263) {
      if (!itu_header(b)) return false;
      if (pict_type == 2 && !have_ref) bad("P picture without a reference");
      std::fill(intra_at.begin(), intra_at.end(), 0);
      std::fill(mv8s.begin(), mv8s.end(), 0);
      std::fill(skipped.begin(), skipped.end(), 0);
      picture_itu(b);
      ++picture_number;
      output(out);
      std::swap(cur, ref);
      have_ref = true;
      return true;
    }
    if (variant == kFlv1) {
      flv_header(b);
    } else if (variant == kWmv2) {
      if (!wmv2_header(b)) return false;
    } else {
      if (long(n) * 64 < long(mbw) * mbh) return false;
      msmpeg4_header(b);
    }
    if (droppable && kept < 2) return false;
    if (pict_type == 2 && !have_ref) bad("P picture without a reference");
    std::fill(skipped.begin(), skipped.end(), 0);
    if (variant == kWmv2 && pict_type == 2) skipped = skip;
    picture_data(b);
    if (pict_type == 1 && (variant == kV2 || variant == kV3))
      ext_header(b, long(8 * n) - long(b.pos));
    ++picture_number;
    output(out);
    // A disposable picture is not a reference: the next one predicts from
    // the reference before it.
    if (!droppable) {
      std::swap(cur, ref);
      have_ref = true;
      ++kept;
    }
    return true;
  }
};

H263Decoder::H263Decoder(const std::string& tag, int w, int h,
                         const std::vector<uint8_t>& extradata)
    : s_(new State) {
  s_->tag = tag;
  s_->variant = variant(tag);
  if (s_->variant < 0)
    unsupported("MS-MPEG4 v1 ('" + tag + "'), which no encoder here writes");
  if (s_->variant == 0) unsupported("'" + tag + "' is not of the H.263 family");
  if (s_->variant != kFlv1 && s_->variant != kH263) {
    if (w <= 0 || h <= 0) broken(tag + " video without a picture size");
    s_->set_size(w, h);
  }
  if (s_->variant == kWmv2) s_->wmv2_ext(extradata);
}

H263Decoder::~H263Decoder() = default;

bool H263Decoder::decode(const uint8_t* data, size_t n, Picture& out) {
  return s_->decode(data, n, out);
}

int H263Decoder::peek(const uint8_t* d, size_t n) {
  if (!n) return -1;
  Bits b{d, n};
  switch (s_->variant) {
    case kFlv1: {
      if (b.get(17) != 1) return -1;
      b.skip(5 + 8);
      int f = int(b.get(3));
      b.skip(f == 0 ? 16 : f == 1 ? 32 : 0);
      int type = int(b.get(2));
      if (type < 2) return ++s_->kept, type;
      return s_->kept < 2 ? -1 : 1;
    }
    case kWmv2: {
      if (!b.get1()) return 0;
      b.skip(5);
      if (b.peek(1)) {
        int type = int(b.get(2));
        int run = type == 3 ? s_->mbw : s_->mbh;
        while (run > 0) {
          int blk = std::min(run, 25);
          if (b.get(blk) + 1 != (1u << blk)) break;
          run -= blk;
        }
        if (!run) return -1;
      }
      return 1;
    }
    case kH263: {
      ItuPtype p;
      if (read_ptype(b, p)) return -1;
      return p.type == 0 || p.type == 7 ? 0 : 1;
    }
    default:
      return b.get(2) == 0 ? 0 : 1;
  }
}

bool H263Decoder::picture_size(const std::string& tag, const uint8_t* d,
                               size_t n, int& w, int& h) {
  if (variant(tag) != kH263 || !n) return false;
  Bits b{d, n};
  ItuPtype p;
  if (read_ptype(b, p) || !p.w) return false;
  w = p.w;
  h = p.h;
  return true;
}

}  // namespace viai_video
