// The HEVC decoder of viai_tpu_torch's video reader (videodec.cpp): the
// Main, Main 10 and Main Still Picture profiles (4:2:0 at 8 and 10 bits)
// as x265, phones and cameras write them, decoded as ITU-T H.265 (v1)
// specifies and output in the order and number libavcodec's hevc decoder
// gives them to cv2.
//
//   * parsing: NAL units (Annex B start codes, or the length prefixes of
//     an hvcC record whose parameter-set arrays are read first),
//     emulation prevention, the SPS (profile_tier_level, the conformance
//     window, sub-layer ordering, scaling lists with their prediction,
//     short-term RPS sets with inter-RPS prediction, the VUI with its HRD
//     for range, matrix and chroma siting), the PPS (sign hiding,
//     transform skip, cu_qp_delta, chroma QP offsets, weighted
//     prediction, transquant bypass, WPP, deblocking control, lists
//     modification, the parallel merge level), slice segment headers
//     (POC LSB, the RPS, the collocated picture, pred_weight_table, SAO
//     and deblocking overrides, entry points); SEI is skipped;
//   * POC, RPS marking (a missing reference made as libavcodec makes it:
//     a grey picture never output) and libavcodec's output: bumping by
//     sps_max_num_reorder_pics and sps_max_dec_pic_buffering, every
//     picture output at an IRAP with NoRaslOutputFlag, the RASL pictures
//     of a CRA that begins the stream (or follows an end of sequence)
//     dropped, everything left drained at the end;
//   * CABAC: the engine bit by bit, contexts by initType and
//     cabac_init_flag, WPP (contexts saved after a row's second CTU and
//     restored at the next row's start, the substreams found by their
//     entry points), several slices a picture;
//   * the coding quadtree, skip and merge (spatial, temporal from the
//     collocated picture's motion at 16x16, combined bi-predictive and
//     zero candidates, the parallel merge level), AMVP, part_mode with
//     AMP, intra modes with their three MPMs, the transform tree,
//     cu_qp_delta and libavcodec's QP prediction, residual coding (last
//     position, coded sub-blocks, significance contexts, greater1 and
//     greater2, Rice adaptation, sign data hiding, transform_skip);
//   * reconstruction: scaling (flat or by scaling list), the inverse DCT
//     at 4 to 32 and the 4x4 DST, transform skip, transquant bypass;
//     intra prediction (substitution, filtering, strong intra smoothing,
//     planar, DC and the 33 angular modes with their edge filters,
//     constrained intra prediction); 8-tap luma and 4-tap chroma
//     interpolation at 14-bit intermediates, bi-prediction and explicit
//     weighted prediction;
//   * in-loop filters: deblocking (bS on the 8x8 grid from transform and
//     prediction edges, β and tC with the slice's offsets, slice borders
//     and transquant-bypass samples left alone) then SAO (band and edge,
//     picture and slice borders).
//
// Samples are held as uint16_t at every depth; the picture goes out as
// 8-bit planes (yuv420p) or 16-bit ones (yuv420p10le), cropped by the
// conformance window, with the VUI's range, matrix and chroma siting.
//
// Everything else raises NotImplementedError (code 2) naming it, at its
// first use: tiles, PCM samples, long-term references, dependent slice
// segments, NAL units of nuh_layer_id > 0 (MV-HEVC, SHVC), the RExt and
// SCC profiles (4:0:0, 4:2:2, 4:4:4, above 10 bits, their tools) and
// field-coded pictures (field_seq_flag). A stream that breaks the syntax
// raises ValueError (code 1).

#include <algorithm>
#include <array>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <memory>
#include <string>
#include <vector>

#include "h264_tables.h"
#include "video.h"

namespace viai_video {

namespace {

inline int clip3(int lo, int hi, int v) { return v < lo ? lo : v > hi ? hi : v; }
inline int ceil_log2(int v) {
  int k = 0;
  while ((1 << k) < v) ++k;
  return k;
}

// ------------------------------------------------------------ bits

// An RBSP read MSB first; reads past its end give zeros.
struct Bits {
  const uint8_t* p = nullptr;
  size_t n = 0;      // bytes
  size_t pos = 0;    // bit position

  uint32_t peek32() const {
    size_t b = pos >> 3;
    uint64_t w = 0;
    for (int i = 0; i < 5; ++i) w = (w << 8) | (b + i < n ? p[b + i] : 0);
    return uint32_t(w >> (8 - (pos & 7)));
  }
  uint32_t u(int k) {
    if (k == 0) return 0;
    uint32_t v = peek32() >> (32 - k);
    pos += size_t(k);
    return v;
  }
  int u1() {
    size_t b = pos >> 3;
    int v = b < n ? (p[b] >> (7 - (pos & 7))) & 1 : 0;
    ++pos;
    return v;
  }
  uint32_t ue() {
    uint32_t w = peek32();
    if (w == 0) broken("HEVC Exp-Golomb code too long");
    int lz = __builtin_clz(w);
    pos += size_t(lz);
    return u(lz + 1) - 1;
  }
  int32_t se() {
    uint32_t k = ue();
    return (k & 1) ? int32_t((k + 1) >> 1) : -int32_t(k >> 1);
  }
  bool over() const { return pos > n * 8; }
};

// A NAL unit's RBSP (emulation_prevention_three_byte removed) and, for
// each RBSP byte, its offset in the NAL unit (entry points count the
// removed bytes).
struct Rbsp {
  std::vector<uint8_t> d;
  std::vector<uint32_t> at;
};

void unescape(const uint8_t* s, size_t n, Rbsp& r) {
  r.d.clear();
  r.at.clear();
  r.d.reserve(n);
  r.at.reserve(n);
  int zeros = 0;
  for (size_t i = 0; i < n; ++i) {
    if (zeros >= 2 && s[i] == 3) {
      zeros = 0;
      continue;
    }
    r.d.push_back(s[i]);
    r.at.push_back(uint32_t(i));
    zeros = s[i] == 0 ? zeros + 1 : 0;
  }
}

// ------------------------------------------------------------ tables

// The scan orders of 6.5.3-6.5.5: ScanOrder[log2 size][scanIdx][pos]
// (up-right diagonal, horizontal, vertical) for blocks of 1, 2, 4 and 8.
struct ScanPos {
  uint8_t x, y;
};
struct Scans {
  ScanPos s[4][3][64];
  Scans() {
    for (int l = 0; l < 4; ++l) {
      int n = 1 << l;
      int i = 0, x = 0, y = 0;
      bool stop = false;
      while (!stop) {
        while (y >= 0) {
          if (x < n && y < n) s[l][0][i++] = {uint8_t(x), uint8_t(y)};
          --y;
          ++x;
        }
        y = x;
        x = 0;
        if (i >= n * n) stop = true;
      }
      i = 0;
      for (int yy = 0; yy < n; ++yy)
        for (int xx = 0; xx < n; ++xx) s[l][1][i++] = {uint8_t(xx), uint8_t(yy)};
      i = 0;
      for (int xx = 0; xx < n; ++xx)
        for (int yy = 0; yy < n; ++yy) s[l][2][i++] = {uint8_t(xx), uint8_t(yy)};
    }
  }
};
const Scans kScans;

// Default scaling lists (Table 7-6), in up-right diagonal order.
const uint8_t kDefaultIntra[64] = {
    16, 16, 16, 16, 16, 16, 16, 16, 16, 16, 17, 16, 17, 16, 17, 18,
    17, 18, 18, 17, 18, 21, 19, 20, 21, 20, 19, 21, 24, 22, 22, 24,
    24, 22, 22, 24, 25, 25, 27, 30, 27, 25, 25, 29, 31, 35, 35, 31,
    29, 36, 41, 44, 41, 36, 47, 54, 54, 47, 65, 70, 65, 88, 88, 115};
const uint8_t kDefaultInter[64] = {
    16, 16, 16, 16, 16, 16, 16, 16, 16, 16, 17, 17, 17, 17, 17, 18,
    18, 18, 18, 18, 18, 20, 20, 20, 20, 20, 20, 20, 24, 24, 24, 24,
    24, 24, 24, 24, 25, 25, 25, 25, 25, 25, 25, 28, 28, 28, 28, 28,
    28, 33, 33, 33, 33, 33, 41, 41, 41, 41, 54, 54, 54, 71, 71, 91};

// The context variables (9.3.2.2), by syntax element.
enum {
  kSaoMerge = 0, kSaoType = 1, kSplitCu = 2, kBypassFlag = 5, kSkip = 6,
  kQpDelta = 9, kPredMode = 11, kPartMode = 12, kPrevIntra = 16,
  kChromaMode = 17, kMergeFlag = 18, kMergeIdx = 19, kInterPred = 20,
  kRefIdx = 25, kMvdG0 = 27, kMvdG1 = 28, kMvpFlag = 29, kRqtRoot = 30,
  kSplitTf = 31, kCbfLuma = 34, kCbfChroma = 36, kTsFlag = 41,
  kLastX = 43, kLastY = 61, kCsbf = 79, kSig = 83, kGt1 = 127, kGt2 = 151,
  kNumCtx = 157
};

// initValue by initType (0: I, 1 and 2: P and B by cabac_init_flag).
const uint8_t kCtxInit[3][kNumCtx] = {
    {153, 200, 139, 141, 157, 154, 154, 154, 154, 154, 154, 154, 184, 154,
     154, 154, 184, 63, 154, 154, 154, 154, 154, 154, 154, 154, 154, 154,
     154, 154, 154, 153, 138, 138, 111, 141, 94, 138, 182, 154, 154, 139,
     139, 110, 110, 124, 125, 140, 153, 125, 127, 140, 109, 111, 143, 127,
     111, 79, 108, 123, 63, 110, 110, 124, 125, 140, 153, 125, 127, 140,
     109, 111, 143, 127, 111, 79, 108, 123, 63, 91, 171, 134, 141, 111,
     111, 125, 110, 110, 94, 124, 108, 124, 107, 125, 141, 179, 153, 125,
     107, 125, 141, 179, 153, 125, 107, 125, 141, 179, 153, 125, 140, 139,
     182, 182, 152, 136, 152, 136, 153, 136, 139, 111, 136, 139, 111, 141,
     111, 140, 92, 137, 138, 140, 152, 138, 139, 153, 74, 149, 92, 139,
     107, 122, 152, 140, 179, 166, 182, 140, 227, 122, 197, 138, 153, 136,
     167, 152, 152},
    {153, 185, 107, 139, 126, 154, 197, 185, 201, 154, 154, 149, 154, 139,
     154, 154, 154, 152, 110, 122, 95, 79, 63, 31, 31, 153, 153, 140, 198,
     168, 79, 124, 138, 94, 153, 111, 149, 107, 167, 154, 154, 139, 139,
     125, 110, 94, 110, 95, 79, 125, 111, 110, 78, 110, 111, 111, 95, 94,
     108, 123, 108, 125, 110, 94, 110, 95, 79, 125, 111, 110, 78, 110, 111,
     111, 95, 94, 108, 123, 108, 121, 140, 61, 154, 155, 154, 139, 153,
     139, 123, 123, 63, 153, 166, 183, 140, 136, 153, 154, 166, 183, 140,
     136, 153, 154, 166, 183, 140, 136, 153, 154, 170, 153, 123, 123, 107,
     121, 107, 121, 167, 151, 183, 140, 151, 183, 140, 140, 140, 154, 196,
     196, 167, 154, 152, 167, 182, 182, 134, 149, 136, 153, 121, 136, 137,
     169, 194, 166, 167, 154, 167, 137, 182, 107, 167, 91, 122, 107, 167},
    {153, 160, 107, 139, 126, 154, 197, 185, 201, 154, 154, 134, 154, 139,
     154, 154, 183, 152, 154, 137, 95, 79, 63, 31, 31, 153, 153, 169, 198,
     168, 79, 224, 167, 122, 153, 111, 149, 92, 167, 154, 154, 139, 139,
     125, 110, 124, 110, 95, 94, 125, 111, 111, 79, 125, 126, 111, 111, 79,
     108, 123, 93, 125, 110, 124, 110, 95, 94, 125, 111, 111, 79, 125, 126,
     111, 111, 79, 108, 123, 93, 121, 140, 61, 154, 170, 154, 139, 153,
     139, 123, 123, 63, 124, 166, 183, 140, 136, 153, 154, 166, 183, 140,
     136, 153, 154, 166, 183, 140, 136, 153, 154, 170, 153, 138, 138, 122,
     121, 122, 121, 167, 151, 183, 140, 151, 183, 140, 140, 140, 154, 196,
     167, 167, 154, 152, 167, 182, 182, 134, 149, 136, 153, 121, 136, 122,
     169, 208, 166, 167, 154, 152, 167, 182, 107, 167, 91, 107, 107, 167}};

// β′ and tC′ (Table 8-12).
const uint8_t kBeta[52] = {
    0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  6, 7,
    8,  9,  10, 11, 12, 13, 14, 15, 16, 17, 18, 20, 22, 24, 26, 28, 30, 32,
    34, 36, 38, 40, 42, 44, 46, 48, 50, 52, 54, 56, 58, 60, 62, 64};
const uint8_t kTc[54] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1,  1,  1,  1,  1,  1,  1,  1, 1,
    2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 5, 5, 6, 6, 7, 8, 9, 10, 11, 13, 14, 16, 18, 20, 22, 24};

// QpC for ChromaArrayType 1 (Table 8-10), qPi 30..43.
const uint8_t kQpC[14] = {29, 30, 31, 32, 33, 33, 34, 34, 35, 35, 36, 36, 37, 37};
int chroma_qp(int qpi) {
  return qpi < 30 ? qpi : qpi > 43 ? qpi - 6 : kQpC[qpi - 30];
}

const int8_t kIntraAngle[35] = {0,   0,   32,  26,  21,  17,  13, 9,  5,
                                2,   0,   -2,  -5,  -9,  -13, -17, -21, -26,
                                -32, -26, -21, -17, -13, -9,  -5,  -2, 0,
                                2,   5,   9,   13,  17,  21,  26,  32};
const int16_t kInvAngle[15] = {-4096, -1638, -910, -630, -482, -390, -315, -256,
                               -315,  -390,  -482, -630, -910, -1638, -4096};

const int8_t kLumaFilter[4][8] = {{0, 0, 0, 64, 0, 0, 0, 0},
                                  {-1, 4, -10, 58, 17, -5, 1, 0},
                                  {-1, 4, -11, 40, 40, -11, 4, -1},
                                  {0, 1, -5, 17, 58, -10, 4, -1}};
const int8_t kChromaFilter[8][4] = {{0, 64, 0, 0},    {-2, 58, 10, -2},
                                    {-4, 54, 16, -2}, {-6, 46, 28, -4},
                                    {-4, 36, 36, -4}, {-4, 28, 46, -6},
                                    {-2, 16, 54, -4}, {-2, 10, 58, -2}};

// The 32-point inverse DCT matrix (8.6.4.2), row k the k-th basis: the
// magnitudes of cos(aπ/64) the standard gives, a = (2n + 1)k mod 128.
struct DctMatrix {
  int8_t m[32][32];
  int8_t n[4][32][32];          // the 4- to 32-point matrices: m's rows
                                // k << (5 - log2), row stride 32
  DctMatrix() {
    static const int kC[33] = {64, 90, 90, 90, 89, 88, 87, 85, 83, 82, 80,
                               78, 75, 73, 70, 67, 64, 61, 57, 54, 50, 46,
                               43, 38, 36, 31, 25, 22, 18, 13, 9,  4,  0};
    for (int k = 0; k < 32; ++k)
      for (int n = 0; n < 32; ++n) {
        int a = ((2 * n + 1) * k) % 128;
        if (a > 64) a = 128 - a;
        int v = a > 32 ? -kC[64 - a] : kC[a];
        m[k][n] = int8_t(k == 0 ? 64 : v);
      }
    for (int l = 0; l < 4; ++l)
      for (int k = 0; k < (4 << l); ++k)
        for (int i = 0; i < 32; ++i) n[l][k][i] = m[k << (3 - l)][i];
  }
};
const DctMatrix kDct;
// The 4x4 DST (rows the bases), row stride 32 as DctMatrix::n.
const int8_t kDst4[4][32] = {{29, 55, 74, 84}, {74, 74, 0, -74},
                             {84, -29, -74, 55}, {55, -84, 74, -29}};

// ------------------------------------------------------ parameter sets

// Scaling factors (7.4.5) by sizeId 0..3 (4x4 .. 32x32) and matrixId
// (0..2 intra Y, Cb, Cr; 3..5 inter; 32x32 uses 0 and 3), each the 4x4
// or 8x8 list in raster order (16 and 32 upsample it), with its DC.
struct ScalingList {
  uint8_t sl[4][6][64];
  uint8_t dc[4][6];
};

void default_lists(ScalingList& s) {
  for (int m = 0; m < 6; ++m) {
    for (int i = 0; i < 16; ++i) s.sl[0][m][i] = 16;
    for (int size = 1; size < 4; ++size) {
      const uint8_t* d = m < 3 ? kDefaultIntra : kDefaultInter;
      for (int i = 0; i < 64; ++i) {
        ScanPos p = kScans.s[3][0][i];
        s.sl[size][m][p.y * 8 + p.x] = d[i];
      }
      s.dc[size][m] = 16;
    }
  }
}

void scaling_list_data(Bits& b, ScalingList& s) {
  for (int size = 0; size < 4; ++size)
    for (int m = 0; m < 6; m += size == 3 ? 3 : 1) {
      int n = std::min(64, 1 << (4 + (size << 1)));
      const ScanPos* scan = kScans.s[size == 0 ? 2 : 3][0];
      if (!b.u1()) {                            // scaling_list_pred_mode_flag
        unsigned delta = b.ue();
        if (delta > unsigned(m / (size == 3 ? 3 : 1)))
          broken("HEVC scaling_list_pred_matrix_id_delta out of range");
        if (delta == 0) {
          ScalingList d;
          default_lists(d);
          std::memcpy(s.sl[size][m], d.sl[size][m], 64);
          s.dc[size][m] = 16;
        } else {
          int ref = m - int(delta) * (size == 3 ? 3 : 1);
          std::memcpy(s.sl[size][m], s.sl[size][ref], 64);
          s.dc[size][m] = s.dc[size][ref];
        }
      } else {
        int next = 8;
        if (size > 1) {
          int dc = b.se();
          if (dc < -7 || dc > 247) broken("HEVC scaling_list_dc_coef out of range");
          next = dc + 8;
          s.dc[size][m] = uint8_t(next);
        }
        for (int i = 0; i < n; ++i) {
          int delta = b.se();
          if (delta < -128 || delta > 127) broken("HEVC scaling_list_delta_coef out of range");
          next = (next + delta + 256) % 256;
          ScanPos p = scan[i];
          s.sl[size][m][size == 0 ? p.y * 4 + p.x : p.y * 8 + p.x] = uint8_t(next);
        }
        if (size <= 1) s.dc[size][m] = s.sl[size][m][0];
      }
    }
}

// A short-term RPS (7.4.8): delta POCs, the n_neg negative ones first
// (nearest first), then the positive ones.
struct ShortRps {
  int n_neg = 0, n_pos = 0;
  int delta[32] = {};
  bool used[32] = {};
  int num() const { return n_neg + n_pos; }
};

void st_ref_pic_set(Bits& b, int idx, const std::vector<ShortRps>& sets,
                    ShortRps& r) {
  int num_sets = int(sets.size());
  bool inter = idx != 0 && b.u1();
  r = ShortRps();
  if (inter) {
    int delta_idx = idx == num_sets ? int(b.ue()) + 1 : 1;
    if (delta_idx > idx) broken("HEVC delta_idx_minus1 out of range");
    int sign = b.u1();
    int abs_delta = int(b.ue()) + 1;
    if (abs_delta > 32768) broken("HEVC abs_delta_rps_minus1 out of range");
    int delta_rps = sign ? -abs_delta : abs_delta;
    const ShortRps& ref = sets[size_t(idx - delta_idx)];
    bool used[33], use_delta[33];
    for (int j = 0; j <= ref.num(); ++j) {
      used[j] = b.u1();
      use_delta[j] = used[j] ? true : bool(b.u1());
    }
    // (7-61), (7-62)
    int i = 0;
    for (int j = ref.n_pos - 1; j >= 0; --j) {
      int d = ref.delta[ref.n_neg + j] + delta_rps;
      if (d < 0 && use_delta[ref.n_neg + j]) {
        r.delta[i] = d;
        r.used[i++] = used[ref.n_neg + j];
      }
    }
    if (delta_rps < 0 && use_delta[ref.num()]) {
      r.delta[i] = delta_rps;
      r.used[i++] = used[ref.num()];
    }
    for (int j = 0; j < ref.n_neg; ++j) {
      int d = ref.delta[j] + delta_rps;
      if (d < 0 && use_delta[j]) {
        if (i >= 16) broken("HEVC RPS of more than 16 pictures");
        r.delta[i] = d;
        r.used[i++] = used[j];
      }
    }
    r.n_neg = i;
    int neg[16];
    bool negu[16];
    std::copy(r.delta, r.delta + i, neg);
    std::copy(r.used, r.used + i, negu);
    int k = 0;
    int pos[16];
    bool posu[16];
    for (int j = ref.n_neg - 1; j >= 0; --j) {
      int d = ref.delta[j] + delta_rps;
      if (d > 0 && use_delta[j]) {
        pos[k] = d;
        posu[k++] = used[j];
      }
    }
    if (delta_rps > 0 && use_delta[ref.num()]) {
      pos[k] = delta_rps;
      posu[k++] = used[ref.num()];
    }
    for (int j = 0; j < ref.n_pos; ++j) {
      int d = ref.delta[ref.n_neg + j] + delta_rps;
      if (d > 0 && use_delta[ref.n_neg + j]) {
        if (k >= 16) broken("HEVC RPS of more than 16 pictures");
        pos[k] = d;
        posu[k++] = used[ref.n_neg + j];
      }
    }
    if (i + k > 16) broken("HEVC RPS of more than 16 pictures");
    r.n_pos = k;
    std::copy(neg, neg + i, r.delta);
    std::copy(negu, negu + i, r.used);
    std::copy(pos, pos + k, r.delta + i);
    std::copy(posu, posu + k, r.used + i);
  } else {
    unsigned nn = b.ue(), np = b.ue();
    if (nn > 16 || np > 16 || nn + np > 16) broken("HEVC RPS of more than 16 pictures");
    r.n_neg = int(nn);
    r.n_pos = int(np);
    int poc = 0;
    for (int i = 0; i < r.n_neg; ++i) {
      poc -= int(b.ue()) + 1;
      r.delta[i] = poc;
      r.used[i] = b.u1();
    }
    poc = 0;
    for (int i = 0; i < r.n_pos; ++i) {
      poc += int(b.ue()) + 1;
      r.delta[r.n_neg + i] = poc;
      r.used[r.n_neg + i] = b.u1();
    }
  }
}

void profile_tier_level(Bits& b, int max_sub_layers_minus1, int& profile) {
  b.u(2);                                     // general_profile_space
  b.u1();                                     // general_tier_flag
  profile = int(b.u(5));
  b.u(32);                                    // compatibility flags
  b.u(4);                                     // progressive .. frame_only
  b.u(32);                                    // 43 reserved bits and
  b.u(11);                                    // general_inbld_flag
  b.u(1);
  b.u(8);                                     // general_level_idc
  bool prof[8] = {}, lev[8] = {};
  for (int i = 0; i < max_sub_layers_minus1; ++i) {
    prof[i] = b.u1();
    lev[i] = b.u1();
  }
  if (max_sub_layers_minus1 > 0)
    for (int i = max_sub_layers_minus1; i < 8; ++i) b.u(2);
  for (int i = 0; i < max_sub_layers_minus1; ++i) {
    if (prof[i]) {
      b.u(32);
      b.u(32);
      b.u(24);
    }
    if (lev[i]) b.u(8);
  }
}

void sub_layer_hrd(Bits& b, int cpb_cnt, bool sub_pic) {
  for (int k = 0; k < cpb_cnt; ++k) {
    b.ue();
    b.ue();
    if (sub_pic) {
      b.ue();
      b.ue();
    }
    b.u1();
  }
}

void hrd_parameters(Bits& b, bool common, int max_sub_layers_minus1) {
  bool nal = false, vcl = false, sub_pic = false;
  if (common) {
    nal = b.u1();
    vcl = b.u1();
    if (nal || vcl) {
      sub_pic = b.u1();
      if (sub_pic) {
        b.u(8);
        b.u(5);
        b.u1();
        b.u(5);
      }
      b.u(4);
      b.u(4);
      if (sub_pic) b.u(4);
      b.u(5);
      b.u(5);
      b.u(5);
    }
  }
  for (int i = 0; i <= max_sub_layers_minus1; ++i) {
    bool fixed_general = b.u1();
    bool fixed_cvs = fixed_general ? true : bool(b.u1());
    bool low_delay = false;
    if (fixed_cvs)
      b.ue();
    else
      low_delay = b.u1();
    int cpb_cnt = 1;
    if (!low_delay) {
      unsigned c = b.ue();
      if (c > 31) broken("HEVC cpb_cnt_minus1 out of range");
      cpb_cnt = int(c) + 1;
    }
    if (nal) sub_layer_hrd(b, cpb_cnt, sub_pic);
    if (vcl) sub_layer_hrd(b, cpb_cnt, sub_pic);
  }
}

struct Sps {
  int id = 0;
  int max_sub_layers = 1;
  int profile = 0;
  int chroma_format = 1;
  int w = 0, h = 0;                    // pic_width/height_in_luma_samples
  int crop_l = 0, crop_r = 0, crop_t = 0, crop_b = 0;   // luma samples
  int depth = 8;
  int log2_max_poc_lsb = 4;
  int max_dec_pic_buffering = 1, num_reorder = 0;       // highest sub-layer
  int log2_min_cb = 3, log2_ctb = 4, log2_min_tb = 2, log2_max_tb = 4;
  int max_th_depth_inter = 0, max_th_depth_intra = 0;
  bool scaling_enabled = false;
  ScalingList sl;
  bool amp = false, sao = false, pcm = false;
  int log2_min_pcm = 0, log2_max_pcm = 0;
  std::vector<ShortRps> rps;
  bool long_term = false;
  int num_lt_sps = 0;
  bool temporal_mvp = false, strong_intra_smoothing = false;
  bool full_range = false;
  int matrix = 2;
  int chroma_loc = 1;          // libavcodec's AVChromaLocation: left, or
                               // the VUI's chroma_sample_loc_type + 1
  bool field_seq = false;
  // The VUI's timing (0 without it, or with a field of 0).
  uint32_t num_units_in_tick = 0, time_scale = 0;
  // derived
  int ctb_size = 16, ctb_w = 0, ctb_h = 0;
};

void vui_parameters(Bits& b, Sps& s) {
  if (b.u1()) {                                  // aspect_ratio_info
    if (b.u(8) == 255) {
      b.u(16);
      b.u(16);
    }
  }
  if (b.u1()) b.u1();                            // overscan
  if (b.u1()) {                                  // video_signal_type
    b.u(3);
    s.full_range = b.u1();
    if (b.u1()) {                                // colour_description
      b.u(8);
      b.u(8);
      s.matrix = int(b.u(8));
    }
  }
  if (b.u1()) {                                  // chroma_loc_info
    unsigned top = b.ue();
    b.ue();
    if (top <= 5) s.chroma_loc = int(top) + 1;
  }
  b.u1();                                        // neutral_chroma_indication
  s.field_seq = b.u1();
  b.u1();                                        // frame_field_info_present
  if (b.u1()) {                                  // default_display_window
    b.ue();
    b.ue();
    b.ue();
    b.ue();
  }
  if (b.u1()) {                                  // vui_timing_info
    s.num_units_in_tick = b.u(32);
    s.time_scale = b.u(32);
    if (!s.num_units_in_tick || !s.time_scale)
      s.num_units_in_tick = s.time_scale = 0;
    if (b.u1()) b.ue();
    if (b.u1()) hrd_parameters(b, true, s.max_sub_layers - 1);
  }
  if (b.u1()) {                                  // bitstream_restriction
    b.u1();
    b.u1();
    b.u1();
    b.ue();
    b.ue();
    b.ue();
    b.ue();
    b.ue();
  }
}

void parse_sps(Bits& b, Sps& s) {
  b.u(4);                                        // sps_video_parameter_set_id
  s.max_sub_layers = int(b.u(3)) + 1;
  if (s.max_sub_layers > 7) broken("HEVC sps_max_sub_layers_minus1 out of range");
  b.u1();
  profile_tier_level(b, s.max_sub_layers - 1, s.profile);
  unsigned id = b.ue();
  if (id > 15) broken("HEVC sps_seq_parameter_set_id out of range");
  s.id = int(id);
  s.chroma_format = int(b.ue());
  if (s.chroma_format > 3) broken("HEVC chroma_format_idc out of range");
  if (s.chroma_format == 3) b.u1();              // separate_colour_plane_flag
  s.w = int(b.ue());
  s.h = int(b.ue());
  if (s.w <= 0 || s.h <= 0 || s.w > 16888 || s.h > 16888)
    broken("HEVC picture size out of range");
  if (b.u1()) {                                  // conformance_window
    int sub_w = s.chroma_format == 1 || s.chroma_format == 2 ? 2 : 1;
    int sub_h = s.chroma_format == 1 ? 2 : 1;
    s.crop_l = int(b.ue()) * sub_w;
    s.crop_r = int(b.ue()) * sub_w;
    s.crop_t = int(b.ue()) * sub_h;
    s.crop_b = int(b.ue()) * sub_h;
    if (s.crop_l + s.crop_r >= s.w || s.crop_t + s.crop_b >= s.h)
      broken("HEVC conformance window out of the picture");
  }
  int depth = int(b.ue()) + 8, depth_c = int(b.ue()) + 8;
  s.log2_max_poc_lsb = int(b.ue()) + 4;
  if (s.log2_max_poc_lsb > 16) broken("HEVC log2_max_pic_order_cnt_lsb out of range");
  bool ordering = b.u1();
  for (int i = ordering ? 0 : s.max_sub_layers - 1; i < s.max_sub_layers; ++i) {
    s.max_dec_pic_buffering = int(b.ue()) + 1;
    s.num_reorder = int(b.ue());
    b.ue();                                      // max_latency_increase_plus1
  }
  if (s.max_dec_pic_buffering > 16 || s.num_reorder > 15)
    broken("HEVC sps_max_dec_pic_buffering out of range");
  // libavcodec raises the buffering to hold the reorder depth.
  if (s.num_reorder > s.max_dec_pic_buffering - 1)
    s.max_dec_pic_buffering = s.num_reorder + 1;
  s.log2_min_cb = int(b.ue()) + 3;
  s.log2_ctb = s.log2_min_cb + int(b.ue());
  s.log2_min_tb = int(b.ue()) + 2;
  s.log2_max_tb = s.log2_min_tb + int(b.ue());
  s.max_th_depth_inter = int(b.ue());
  s.max_th_depth_intra = int(b.ue());
  if (s.log2_ctb < 4 || s.log2_ctb > 6 || s.log2_min_cb > s.log2_ctb ||
      s.log2_min_tb >= s.log2_min_cb || s.log2_max_tb > 5 ||
      s.log2_max_tb > s.log2_ctb || s.max_th_depth_inter > 4 ||
      s.max_th_depth_intra > 4)
    broken("HEVC coding or transform block sizes out of range");
  if (s.w % (1 << s.log2_min_cb) || s.h % (1 << s.log2_min_cb))
    broken("HEVC picture size not a multiple of the minimum coding block");
  s.scaling_enabled = b.u1();
  default_lists(s.sl);
  if (s.scaling_enabled && b.u1()) scaling_list_data(b, s.sl);
  s.amp = b.u1();
  s.sao = b.u1();
  s.pcm = b.u1();
  if (s.pcm) {
    b.u(4);
    b.u(4);
    s.log2_min_pcm = int(b.ue()) + 3;
    s.log2_max_pcm = s.log2_min_pcm + int(b.ue());
    b.u1();                                      // pcm_loop_filter_disabled
  }
  unsigned nsets = b.ue();
  if (nsets > 64) broken("HEVC num_short_term_ref_pic_sets out of range");
  s.rps.clear();
  for (unsigned i = 0; i < nsets; ++i) {
    ShortRps r;
    st_ref_pic_set(b, int(i), s.rps, r);
    s.rps.push_back(r);
  }
  s.long_term = b.u1();
  if (s.long_term) {
    unsigned n = b.ue();
    if (n > 32) broken("HEVC num_long_term_ref_pics_sps out of range");
    s.num_lt_sps = int(n);
    for (unsigned i = 0; i < n; ++i) {
      b.u(s.log2_max_poc_lsb);
      b.u1();
    }
  }
  s.temporal_mvp = b.u1();
  s.strong_intra_smoothing = b.u1();
  if (b.u1()) vui_parameters(b, s);
  bool range_ext = false;
  if (b.u1()) {                                  // sps_extension_present
    range_ext = b.u1();
    b.u1();                                      // multilayer
    b.u1();                                      // 3d
    bool scc = b.u1();
    b.u(4);
    if (range_ext) {
      int any = 0;
      for (int i = 0; i < 9; ++i) any |= b.u1();
      if (any) unsupported("HEVC range extension coding tools (RExt)");
    }
    if (scc) unsupported("HEVC screen content coding extension (SCC)");
  }
  if (b.over()) broken("HEVC SPS cut short");
  // What is not read: the samplings and depths past Main 10 (a RExt
  // profile's 4:2:0 at 8 or 10 bits without its tools, as x265 writes
  // intra-only streams, is read as Main and Main 10), and the profiles
  // past RExt (SCC, the scalable and multiview ones).
  if (s.profile > 4) {
    char m[96];
    std::snprintf(m, sizeof(m),
                  "HEVC profile_idc %d (SCC, the scalable and multiview "
                  "profiles)", s.profile);
    unsupported(m);
  }
  if (s.chroma_format != 1)
    unsupported(s.chroma_format == 0 ? "HEVC 4:0:0 (monochrome, RExt)"
                : s.chroma_format == 2 ? "HEVC 4:2:2 (RExt)"
                                       : "HEVC 4:4:4 (RExt)");
  if (depth != depth_c)
    unsupported("HEVC luma and chroma of different depths (RExt)");
  if (depth != 8 && depth != 10) {
    char m[64];
    std::snprintf(m, sizeof(m), "HEVC at %d bits (RExt)", depth);
    unsupported(m);
  }
  s.depth = depth;
  s.ctb_size = 1 << s.log2_ctb;
  s.ctb_w = (s.w + s.ctb_size - 1) >> s.log2_ctb;
  s.ctb_h = (s.h + s.ctb_size - 1) >> s.log2_ctb;
}

struct Pps {
  int id = 0, sps_id = 0;
  bool dependent_slices = false, output_flag_present = false;
  int num_extra_bits = 0;
  bool sign_hiding = false, cabac_init_present = false;
  int num_ref_default[2] = {1, 1};
  int init_qp = 26;
  bool constrained_intra = false, transform_skip = false;
  bool cu_qp_delta = false;
  int diff_cu_qp_delta_depth = 0;
  int cb_qp_offset = 0, cr_qp_offset = 0;
  bool slice_chroma_qp_offsets = false;
  bool weighted_pred = false, weighted_bipred = false;
  bool transquant_bypass = false, tiles = false, entropy_sync = false;
  bool lf_across_slices = false;
  bool deblocking_override = false, deblocking_disabled = false;
  int beta_offset = 0, tc_offset = 0;          // div2 values
  bool scaling_present = false;
  ScalingList sl;
  bool lists_modification = false;
  int log2_parallel_merge = 2;
  bool slice_header_ext = false;
};

void parse_pps(Bits& b, Pps& p) {
  unsigned id = b.ue(), sid = b.ue();
  if (id > 63 || sid > 15) broken("HEVC PPS or SPS id out of range");
  p.id = int(id);
  p.sps_id = int(sid);
  p.dependent_slices = b.u1();
  p.output_flag_present = b.u1();
  p.num_extra_bits = int(b.u(3));
  p.sign_hiding = b.u1();
  p.cabac_init_present = b.u1();
  p.num_ref_default[0] = int(b.ue()) + 1;
  p.num_ref_default[1] = int(b.ue()) + 1;
  if (p.num_ref_default[0] > 15 || p.num_ref_default[1] > 15)
    broken("HEVC num_ref_idx_default_active out of range");
  p.init_qp = 26 + b.se();
  p.constrained_intra = b.u1();
  p.transform_skip = b.u1();
  p.cu_qp_delta = b.u1();
  if (p.cu_qp_delta) p.diff_cu_qp_delta_depth = int(b.ue());
  p.cb_qp_offset = b.se();
  p.cr_qp_offset = b.se();
  if (p.cb_qp_offset < -12 || p.cb_qp_offset > 12 || p.cr_qp_offset < -12 ||
      p.cr_qp_offset > 12)
    broken("HEVC pps chroma QP offset out of range");
  p.slice_chroma_qp_offsets = b.u1();
  p.weighted_pred = b.u1();
  p.weighted_bipred = b.u1();
  p.transquant_bypass = b.u1();
  p.tiles = b.u1();
  p.entropy_sync = b.u1();
  if (p.tiles) {
    unsigned cols = b.ue(), rows = b.ue();
    bool uniform = b.u1();
    if (!uniform) {
      for (unsigned i = 0; i < cols && !b.over(); ++i) b.ue();
      for (unsigned i = 0; i < rows && !b.over(); ++i) b.ue();
    }
    b.u1();                                      // loop_filter_across_tiles
  }
  p.lf_across_slices = b.u1();
  if (b.u1()) {                                  // deblocking_filter_control
    p.deblocking_override = b.u1();
    p.deblocking_disabled = b.u1();
    if (!p.deblocking_disabled) {
      p.beta_offset = b.se();
      p.tc_offset = b.se();
    }
  }
  p.scaling_present = b.u1();
  if (p.scaling_present) {
    default_lists(p.sl);
    scaling_list_data(b, p.sl);
  }
  p.lists_modification = b.u1();
  p.log2_parallel_merge = int(b.ue()) + 2;
  p.slice_header_ext = b.u1();
  if (b.u1()) {                                  // pps_extension_present
    bool range_ext = b.u1();
    b.u1();
    b.u1();
    bool scc = b.u1();
    if (range_ext) unsupported("HEVC PPS range extension (RExt)");
    if (scc) unsupported("HEVC screen content coding extension (SCC)");
  }
  if (b.over()) broken("HEVC PPS cut short");
}

// ------------------------------------------------------------ pictures

struct Mv {
  int16_t x = 0, y = 0;
  bool operator==(const Mv& o) const { return x == o.x && y == o.y; }
  bool operator!=(const Mv& o) const { return !(*this == o); }
};

// The motion of a 4x4 block; pred 0 is intra (or not coded), bit 0 L0,
// bit 1 L1; poc, the POCs of the pictures its ref indices name.
struct MvField {
  Mv mv[2];
  int8_t ref[2] = {-1, -1};
  uint8_t pred = 0;
  int32_t poc[2] = {0, 0};
};

bool same_motion(const MvField& a, const MvField& b) {
  if (a.pred != b.pred) return false;
  if ((a.pred & 1) && (a.ref[0] != b.ref[0] || a.mv[0] != b.mv[0])) return false;
  if ((a.pred & 2) && (a.ref[1] != b.ref[1] || a.mv[1] != b.mv[1])) return false;
  return a.pred != 0;
}

struct Frame {
  int poc = 0;
  bool ref = false;         // used for (short-term) reference
  bool out = false;         // waiting for output
  int w = 0, h = 0;         // coded luma size
  std::vector<uint16_t> pl[3];
  int stride[3] = {0, 0, 0};
  std::vector<MvField> mvf; // 4x4 blocks
  int mvw = 0;
  int64_t source = 0;
  // the picture that goes out
  int crop_l = 0, crop_t = 0, out_w = 0, out_h = 0;
  int depth = 8;
  bool full_range = false;
  int matrix = 2, chroma_loc = 1;
};
using FramePtr = std::shared_ptr<Frame>;

// --------------------------------------------------------------- CABAC

struct Cabac {
  Bits* b = nullptr;
  uint32_t range = 0, offset = 0;
  uint8_t st[kNumCtx];          // pStateIdx << 1 | valMps

  void init_contexts(int init_type, int qp) {
    qp = clip3(0, 51, qp);
    for (int i = 0; i < kNumCtx; ++i) {
      int v = kCtxInit[init_type][i];
      int m = (v >> 4) * 5 - 45, n = ((v & 15) << 3) - 16;
      int pre = clip3(1, 126, ((m * qp) >> 4) + n);
      st[i] = pre <= 63 ? uint8_t((63 - pre) << 1) : uint8_t(((pre - 64) << 1) | 1);
    }
  }
  void start() {
    range = 510;
    offset = b->u(9);
    if (offset >= 510) broken("HEVC CABAC offset out of range");
  }
  int decide(int ctx) {
    uint8_t& s = st[ctx];
    int p = s >> 1, mps = s & 1;
    uint32_t lps = h264::kRangeLps[p][(range >> 6) & 3];
    range -= lps;
    int bin;
    if (offset >= range) {
      bin = !mps;
      offset -= range;
      range = lps;
      if (p == 0) mps = 1 - mps;
      s = uint8_t((h264::kTransLps[p] << 1) | mps);
    } else {
      bin = mps;
      s = uint8_t((h264::kTransMps[p] << 1) | mps);
    }
    int n = __builtin_clz(range) - 23;
    if (n > 0) {
      range <<= n;
      offset = (offset << n) | b->u(n);
    }
    return bin;
  }
  int bypass() {
    offset = (offset << 1) | uint32_t(b->u1());
    if (offset >= range) {
      offset -= range;
      return 1;
    }
    return 0;
  }
  int bypass_bits(int n) {
    int v = 0;
    for (int i = 0; i < n; ++i) v = (v << 1) | bypass();
    return v;
  }
  int terminate() {
    range -= 2;
    if (offset >= range) return 1;
    int n = __builtin_clz(range) - 23;
    if (n > 0) {
      range <<= n;
      offset = (offset << n) | b->u(n);
    }
    return 0;
  }
};

// ------------------------------------------------------- slice header

struct SliceHeader {
  bool first = true;
  bool no_output_prior = false;
  int pps_id = 0;
  int address = 0;             // slice_segment_address (CTBs, raster)
  int type = 2;                // 0 B, 1 P, 2 I
  bool output = true;
  int poc_lsb = 0;
  ShortRps rps;
  bool has_rps = false;
  bool temporal_mvp = false;
  bool sao_luma = false, sao_chroma = false;
  int num_ref[2] = {0, 0};
  int list_entry[2][16] = {};
  bool modified[2] = {false, false};
  bool mvd_l1_zero = false, cabac_init = false;
  bool col_from_l0 = true;
  int col_ref = 0;
  int luma_log2 = 0, chroma_log2 = 0;
  int lw[2][16] = {}, lo[2][16] = {}, cw[2][16][2] = {}, co[2][16][2] = {};
  int max_merge = 5;
  int qp = 26;
  int cb_qp = 0, cr_qp = 0;
  bool deblocking_disabled = false;
  int beta_offset = 0, tc_offset = 0;   // div2
  bool lf_across = false;
  std::vector<uint32_t> entries;       // entry_point_offset_minus1 + 1
};

inline bool is_irap(int t) { return t >= 16 && t <= 23; }
inline bool is_idr(int t) { return t == 19 || t == 20; }
inline bool is_bla(int t) { return t >= 16 && t <= 18; }
inline bool is_rasl(int t) { return t == 8 || t == 9; }

// The deblocking and SAO parameters of a slice of the picture.
struct SliceParams {
  bool deblocking_disabled = false;
  int beta_offset = 0, tc_offset = 0;   // div2
  bool lf_across = false;
};

struct SaoParams {
  int type[3] = {0, 0, 0};     // 0 not applied, 1 band, 2 edge
  int band[3] = {0, 0, 0};
  int eo[3] = {0, 0, 0};
  int off[3][5] = {};
};

enum { kPart2Nx2N, kPart2NxN, kPartNx2N, kPartNxN, kPart2NxnU, kPart2NxnD,
       kPartnLx2N, kPartnRx2N };

}  // namespace

struct HevcDecoder::State {
  int nal_len = 0;                      // length prefix bytes; 0: Annex B
  std::unique_ptr<Sps> spss[16];
  std::unique_ptr<Pps> ppss[64];
  int first_sps = -1;
  bool headers_only = false;
  int64_t calls = 0;

  std::vector<FramePtr> dpb;
  std::deque<FramePtr> ready;           // output, not yet converted
  std::deque<Picture> outq;
  FramePtr cur;                         // the picture being decoded
  bool in_picture = false;
  bool skipping = false;                // a dropped RASL picture
  bool no_rasl = true;                  // NoRaslOutputFlag of the last IRAP
  bool eos = true;                      // the stream begins, or an EOS came
  int poc_tid0 = 0;
  int nal_type = 0, temporal_id = 0;
  SliceHeader sh;
  Sps sp;                               // active for the current picture
  Pps pp;
  std::vector<FramePtr> st_before, st_after;

  // per picture
  int W = 0, H = 0, w4 = 0, h4 = 0, mtb = 2, mtw = 0;
  int bd = 8, maxv = 255, qp_bd = 0;
  std::vector<uint8_t> mode4, skip4, depth4, ipm4, bypass4, cbf4;
  std::vector<int8_t> qp4;
  std::vector<uint8_t> bs_v, bs_h;      // bS of a 4x4 block's left / top edge
  std::vector<int> ctb_slice;           // slice index of each CTB, -1
  std::vector<SliceParams> slices;
  std::vector<uint32_t> zs;             // MinTbAddrZs
  std::vector<SaoParams> sao;

  // the current slice
  FramePtr list[2][16];
  FramePtr col;
  int slice_idx = 0;
  bool weighted = false;
  const ScalingList* sl = nullptr;

  // entropy decoding
  Rbsp rbsp;
  Bits bits;
  Cabac cab;
  uint8_t wpp_st[kNumCtx];
  int init_type = 0;

  // coding unit state
  int qp_y = 26, qpy_pred = 26;
  bool first_qp_group = true, qp_delta_coded = false;
  int qp_delta = 0;
  int log2_qg = 6;
  bool cu_bypass = false, cu_intra = false;
  int cu_part = 0, cu_x = 0, cu_y = 0, cu_log2 = 3;
  int chroma_mode = 0;
  int max_trafo_depth = 0;
  bool intra_split = false;
  bool merge_2nx2n = false;

  int16_t predbuf[2][64 * 64];
  int32_t coeff[32 * 32];
  int32_t resid[32 * 32];

  // ------------------------------------------------------------ NAL units

  void decode_packet(const uint8_t* d, size_t n) {
    for_each_nal(d, n, [&](const uint8_t* p, size_t len) { nal(p, len); });
  }

  template <class F>
  void for_each_nal(const uint8_t* d, size_t n, F f) const {
    if (nal_len) {
      size_t q = 0;
      while (q + size_t(nal_len) <= n) {
        size_t len = 0;
        for (int i = 0; i < nal_len; ++i) len = (len << 8) | d[q + size_t(i)];
        q += size_t(nal_len);
        if (len > n - q) broken("HEVC NAL unit runs past its packet");
        if (len) f(d + q, len);
        q += len;
      }
      return;
    }
    // Annex B: units between start codes, trailing zero bytes dropped.
    size_t i = 0, start = SIZE_MAX;
    auto emit = [&](size_t end) {
      while (end > start && d[end - 1] == 0) --end;
      if (start != SIZE_MAX && end > start) f(d + start, end - start);
    };
    while (i + 2 < n) {
      if (d[i] == 0 && d[i + 1] == 0 && d[i + 2] == 1) {
        emit(i);
        i += 3;
        start = i;
      } else {
        ++i;
      }
    }
    if (start != SIZE_MAX) emit(n);
  }

  void read_config(const std::vector<uint8_t>& c) {
    if (c.size() < 23) {
      if (!c.empty()) broken("HEVC hvcC record cut short");
      return;
    }
    if (c[0] == 0 && c[1] == 0 && (c[2] == 1 || (c[2] == 0 && c[3] == 1))) {
      decode_packet(c.data(), c.size());        // Annex B extradata
      return;
    }
    nal_len = (c[21] & 3) + 1;
    if (nal_len == 3) broken("HEVC hvcC lengthSizeMinusOne of 2");
    size_t p = 23;
    for (int a = 0; a < c[22]; ++a) {
      if (p + 3 > c.size()) broken("HEVC hvcC record cut short");
      int count = (c[p + 1] << 8) | c[p + 2];
      p += 3;
      for (int k = 0; k < count; ++k) {
        if (p + 2 > c.size()) broken("HEVC hvcC record cut short");
        size_t len = size_t((c[p] << 8) | c[p + 1]);
        p += 2;
        if (p + len > c.size()) broken("HEVC hvcC record cut short");
        if (len) nal(&c[p], len);
        p += len;
      }
    }
  }

  // 0: parameter sets and slices; 1: parameter sets only
  void nal(const uint8_t* p, size_t len, bool sets_only = false) {
    if (len < 2) return;
    if (p[0] & 0x80) broken("HEVC forbidden_zero_bit set");
    int type = (p[0] >> 1) & 63;
    int layer = ((p[0] & 1) << 5) | (p[1] >> 3);
    int tid = (p[1] & 7) - 1;
    if (tid < 0) broken("HEVC nuh_temporal_id_plus1 of 0");
    if (layer > 0)
      unsupported("HEVC NAL units of nuh_layer_id > 0 (MV-HEVC or SHVC "
                  "layers)");
    if (type == 33 || type == 34) {
      unescape(p + 2, len - 2, rbsp);
      Bits b{rbsp.d.data(), rbsp.d.size(), 0};
      if (type == 33) {
        std::unique_ptr<Sps> s(new Sps());
        parse_sps(b, *s);
        int id = s->id;
        spss[id] = std::move(s);
        if (first_sps < 0) first_sps = id;
      } else {
        std::unique_ptr<Pps> s(new Pps());
        parse_pps(b, *s);
        int id = s->id;
        ppss[id] = std::move(s);
      }
      return;
    }
    if (sets_only) return;
    if (type == 36 || type == 37) {                 // end of sequence / stream
      finish_picture();
      eos = true;
      return;
    }
    if (type <= 9 || (type >= 16 && type <= 21)) {
      nal_type = type;
      temporal_id = tid;
      unescape(p, len, rbsp);
      slice();
    }
  }

  // ------------------------------------------------------- slice header

  void slice_header(Bits& b) {
    SliceHeader h;
    h.first = b.u1();
    if (is_irap(nal_type)) h.no_output_prior = b.u1();
    unsigned pid = b.ue();
    if (pid > 63 || !ppss[pid]) broken("HEVC slice names a missing PPS");
    h.pps_id = int(pid);
    const Pps& p = *ppss[pid];
    if (!spss[p.sps_id]) broken("HEVC PPS names a missing SPS");
    const Sps& s = h.first ? *spss[p.sps_id] : sp;
    if (!h.first && !in_picture && !skipping)
      broken("HEVC slice segment without the first of its picture");
    if (!h.first) {
      bool dependent = p.dependent_slices && b.u1();
      if (dependent) unsupported("HEVC dependent slice segments");
      h.address = int(b.u(ceil_log2(s.ctb_w * s.ctb_h)));
      if (h.address >= s.ctb_w * s.ctb_h) broken("HEVC slice_segment_address out of range");
    }
    if (p.tiles) unsupported("HEVC tiles");
    for (int i = 0; i < p.num_extra_bits; ++i) b.u1();
    unsigned type = b.ue();
    if (type > 2) broken("HEVC slice_type out of range");
    h.type = int(type);
    if (p.output_flag_present) h.output = b.u1();
    int num_curr = 0;
    if (!is_idr(nal_type)) {
      h.poc_lsb = int(b.u(s.log2_max_poc_lsb));
      h.has_rps = true;
      if (!b.u1()) {                                // short_term_ref_pic_set_sps_flag
        st_ref_pic_set(b, int(s.rps.size()), s.rps, h.rps);
      } else {
        if (s.rps.empty()) broken("HEVC slice names an RPS of an SPS without any");
        int idx = s.rps.size() > 1 ? int(b.u(ceil_log2(int(s.rps.size())))) : 0;
        if (idx >= int(s.rps.size())) broken("HEVC short_term_ref_pic_set_idx out of range");
        h.rps = s.rps[size_t(idx)];
      }
      if (s.long_term) {
        unsigned n_sps = s.num_lt_sps > 0 ? b.ue() : 0, n_pics = b.ue();
        if (n_sps || n_pics) unsupported("HEVC long-term reference pictures");
      }
      if (s.temporal_mvp) h.temporal_mvp = b.u1();
      for (int i = 0; i < h.rps.num(); ++i) num_curr += h.rps.used[i];
    }
    if (s.sao) {
      h.sao_luma = b.u1();
      h.sao_chroma = b.u1();
    }
    if (h.type != 2) {
      h.num_ref[0] = p.num_ref_default[0];
      h.num_ref[1] = h.type == 0 ? p.num_ref_default[1] : 0;
      if (b.u1()) {                                 // num_ref_idx_active_override
        h.num_ref[0] = int(b.ue()) + 1;
        if (h.type == 0) h.num_ref[1] = int(b.ue()) + 1;
      }
      if (h.num_ref[0] > 15 || h.num_ref[1] > 15) broken("HEVC num_ref_idx_active out of range");
      if (num_curr == 0) broken("HEVC P or B slice without a current reference");
      if (p.lists_modification && num_curr > 1) {
        int bitsn = ceil_log2(num_curr);
        for (int l = 0; l < (h.type == 0 ? 2 : 1); ++l) {
          h.modified[l] = b.u1();
          if (h.modified[l])
            for (int i = 0; i < h.num_ref[l]; ++i) {
              h.list_entry[l][i] = int(b.u(bitsn));
              if (h.list_entry[l][i] >= num_curr) broken("HEVC list_entry out of range");
            }
        }
      }
      if (h.type == 0) h.mvd_l1_zero = b.u1();
      if (p.cabac_init_present) h.cabac_init = b.u1();
      if (h.temporal_mvp) {
        if (h.type == 0) h.col_from_l0 = b.u1();
        if ((h.col_from_l0 && h.num_ref[0] > 1) || (!h.col_from_l0 && h.num_ref[1] > 1)) {
          h.col_ref = int(b.ue());
          if (h.col_ref >= h.num_ref[h.col_from_l0 ? 0 : 1])
            broken("HEVC collocated_ref_idx out of range");
        }
      }
      if ((p.weighted_pred && h.type == 1) || (p.weighted_bipred && h.type == 0))
        pred_weight_table(b, h, s);
      unsigned five = b.ue();
      if (five > 4) broken("HEVC five_minus_max_num_merge_cand out of range");
      h.max_merge = 5 - int(five);
    }
    h.qp = p.init_qp + b.se();
    if (h.qp < -6 * (s.depth - 8) || h.qp > 51) broken("HEVC slice QP out of range");
    if (p.slice_chroma_qp_offsets) {
      h.cb_qp = b.se();
      h.cr_qp = b.se();
    }
    h.deblocking_disabled = p.deblocking_disabled;
    h.beta_offset = p.beta_offset;
    h.tc_offset = p.tc_offset;
    if (p.deblocking_override && b.u1()) {
      h.deblocking_disabled = b.u1();
      if (!h.deblocking_disabled) {
        h.beta_offset = b.se();
        h.tc_offset = b.se();
      }
    }
    h.lf_across = p.lf_across_slices;
    if (p.lf_across_slices &&
        (h.sao_luma || h.sao_chroma || !h.deblocking_disabled))
      h.lf_across = b.u1();
    if (p.tiles || p.entropy_sync) {
      unsigned n = b.ue();
      if (n > unsigned(s.ctb_h)) broken("HEVC num_entry_point_offsets out of range");
      if (n) {
        unsigned len = b.ue() + 1;
        if (len > 32) broken("HEVC offset_len_minus1 out of range");
        for (unsigned i = 0; i < n; ++i) h.entries.push_back(b.u(int(len)) + 1);
      }
    }
    if (p.slice_header_ext) {
      unsigned n = b.ue();
      for (unsigned i = 0; i < n; ++i) b.u(8);
    }
    if (!b.u1()) broken("HEVC slice header byte_alignment without its one bit");
    while (b.pos & 7) b.u1();
    if (b.over()) broken("HEVC slice header cut short");
    sh = h;
  }

  void pred_weight_table(Bits& b, SliceHeader& h, const Sps& s) {
    unsigned l = b.ue();
    if (l > 7) broken("HEVC luma_log2_weight_denom out of range");
    h.luma_log2 = int(l);
    int c = int(l) + b.se();
    if (c < 0 || c > 7) broken("HEVC chroma_log2_weight_denom out of range");
    h.chroma_log2 = c;
    int shift = s.depth - 8;
    for (int list_i = 0; list_i < (h.type == 0 ? 2 : 1); ++list_i) {
      int n = h.num_ref[list_i];
      bool lf[16], cf[16];
      for (int i = 0; i < n; ++i) lf[i] = b.u1();
      for (int i = 0; i < n; ++i) cf[i] = b.u1();
      for (int i = 0; i < n; ++i) {
        h.lw[list_i][i] = 1 << h.luma_log2;
        h.lo[list_i][i] = 0;
        if (lf[i]) {
          int dw = b.se();
          if (dw < -128 || dw > 127) broken("HEVC delta_luma_weight out of range");
          h.lw[list_i][i] += dw;
          h.lo[list_i][i] = b.se() * (1 << shift);
        }
        for (int j = 0; j < 2; ++j) {
          h.cw[list_i][i][j] = 1 << h.chroma_log2;
          h.co[list_i][i][j] = 0;
        }
        if (cf[i])
          for (int j = 0; j < 2; ++j) {
            int dw = b.se();
            if (dw < -128 || dw > 127) broken("HEVC delta_chroma_weight out of range");
            int w = (1 << h.chroma_log2) + dw;
            int dof = b.se();
            int off = clip3(-128, 127, (128 - ((128 * w) >> h.chroma_log2)) + dof);
            h.cw[list_i][i][j] = w;
            h.co[list_i][i][j] = off * (1 << shift);
          }
      }
    }
  }

  // ------------------------------------------------------ pictures and DPB

  FramePtr new_frame(int poc, bool planes) {
    FramePtr f = std::make_shared<Frame>();
    f->poc = poc;
    f->w = sp.w;
    f->h = sp.h;
    f->depth = sp.depth;
    f->crop_l = sp.crop_l;
    f->crop_t = sp.crop_t;
    f->out_w = sp.w - sp.crop_l - sp.crop_r;
    f->out_h = sp.h - sp.crop_t - sp.crop_b;
    f->full_range = sp.full_range;
    f->matrix = sp.matrix;
    f->chroma_loc = sp.chroma_loc;
    f->mvw = (sp.w + 3) >> 2;
    if (planes) {
      f->stride[0] = sp.w;
      f->stride[1] = f->stride[2] = sp.w >> 1;
      f->pl[0].assign(size_t(sp.w) * sp.h, uint16_t(1 << (sp.depth - 1)));
      f->pl[1].assign(size_t(sp.w >> 1) * (sp.h >> 1), uint16_t(1 << (sp.depth - 1)));
      f->pl[2] = f->pl[1];
      f->mvf.assign(size_t(f->mvw) * ((sp.h + 3) >> 2), MvField());
    }
    return f;
  }

  // libavcodec's ff_hevc_output_frames: while more pictures wait for
  // output than the reorder depth, or the DPB holds more than the
  // buffering, the one of least POC goes out.
  void bump(int max_output, int max_dpb) {
    for (;;) {
      int n_out = 0, n_dpb = 0;
      FramePtr best;
      for (const FramePtr& f : dpb) {
        if (f->out) {
          ++n_out;
          if (!best || f->poc < best->poc) best = f;
        }
        if (f->out || f->ref) ++n_dpb;
      }
      if (n_out > max_output || (n_out && n_dpb > max_dpb)) {
        ready.push_back(best);
        best->out = false;
        drop_unused();
        continue;
      }
      return;
    }
  }

  void drop_unused() {
    dpb.erase(std::remove_if(dpb.begin(), dpb.end(),
                             [&](const FramePtr& f) {
                               return !f->out && !f->ref && f != cur;
                             }),
              dpb.end());
  }

  void start_picture() {
    const Pps& p = *ppss[sh.pps_id];
    pp = p;
    sp = *spss[p.sps_id];
    if (sp.field_seq)
      unsupported("HEVC field-coded pictures (field_seq_flag): libavcodec "
                  "outputs each field as a picture");
    bool irap = is_irap(nal_type);
    if (irap) no_rasl = is_idr(nal_type) || is_bla(nal_type) || eos;
    if (is_rasl(nal_type) && no_rasl) {
      skipping = true;                // libavcodec drops it undecoded
      return;
    }
    skipping = false;
    bool no_output_prior = sh.no_output_prior;
    if (nal_type == 21 && eos) no_output_prior = true;
    eos = false;
    // POC (8.3.1, libavcodec's ff_hevc_compute_poc).
    int poc = 0;
    if (!is_idr(nal_type)) {
      int max = 1 << sp.log2_max_poc_lsb;
      int prev_lsb = ((poc_tid0 % max) + max) % max;
      int prev_msb = poc_tid0 - prev_lsb;
      int msb = prev_msb;
      if (sh.poc_lsb < prev_lsb && prev_lsb - sh.poc_lsb >= max / 2)
        msb = prev_msb + max;
      else if (sh.poc_lsb > prev_lsb && sh.poc_lsb - prev_lsb > max / 2)
        msb = prev_msb - max;
      if (is_bla(nal_type)) msb = 0;
      poc = msb + sh.poc_lsb;
    }
    if (temporal_id == 0 && nal_type != 0 && nal_type != 2 && nal_type != 4 &&
        (nal_type < 6 || nal_type > 9))
      poc_tid0 = poc;
    // Every picture before an IRAP with NoRaslOutputFlag goes out (or,
    // with no_output_of_prior_pics_flag, is dropped).
    if (irap && no_rasl) {
      if (no_output_prior) {
        for (const FramePtr& f : dpb) f->out = false;
        drop_unused();
      }
      bump(0, 0);
    }
    // RPS (8.3.2): the pictures it names stay references, the rest not.
    for (const FramePtr& f : dpb) f->ref = false;
    st_before.clear();
    st_after.clear();
    std::vector<FramePtr> keep;
    for (int i = 0; sh.has_rps && i < sh.rps.num(); ++i) {
      int rpoc = poc + sh.rps.delta[i];
      FramePtr found;
      for (const FramePtr& f : dpb)
        if (f->poc == rpoc) {
          found = f;
          break;
        }
      if (!found) {
        // libavcodec's generate_missing_ref: a grey picture, never output.
        found = new_frame(rpoc, !headers_only);
        dpb.push_back(found);
      }
      found->ref = true;
      if (sh.rps.used[i]) (i < sh.rps.n_neg ? st_before : st_after).push_back(found);
    }
    drop_unused();
    cur = new_frame(poc, !headers_only);
    cur->ref = true;
    cur->out = sh.output;
    cur->source = calls - 1;
    dpb.push_back(cur);
    if (dpb.size() > 17) broken("HEVC DPB overflow");
    bump(sp.num_reorder, sp.max_dec_pic_buffering);
    in_picture = true;
    if (headers_only) return;
    // Per-picture state.
    W = sp.w;
    H = sp.h;
    w4 = (W + 3) >> 2;
    h4 = (H + 3) >> 2;
    bd = sp.depth;
    maxv = (1 << bd) - 1;
    qp_bd = 6 * (bd - 8);
    size_t n4 = size_t(w4) * h4;
    mode4.assign(n4, 0);
    skip4.assign(n4, 0);
    depth4.assign(n4, 0);
    ipm4.assign(n4, 1);
    bypass4.assign(n4, 0);
    cbf4.assign(n4, 0);
    qp4.assign(n4, 0);
    bs_v.assign(n4, 0);
    bs_h.assign(n4, 0);
    ctb_slice.assign(size_t(sp.ctb_w) * sp.ctb_h, -1);
    slices.clear();
    sao.assign(size_t(sp.ctb_w) * sp.ctb_h, SaoParams());
    mtb = sp.log2_min_tb;
    mtw = W >> mtb;
    int mth = H >> mtb;
    zs.assign(size_t(mtw) * mth, 0);
    int d = sp.log2_ctb - mtb;
    for (int y = 0; y < mth; ++y)
      for (int x = 0; x < mtw; ++x) {
        int cx = x >> d, cy = y >> d;
        int tx = x - (cx << d), ty = y - (cy << d);
        uint32_t z = 0;
        for (int i = 0; i < d; ++i) {
          uint32_t m = 1u << i;
          z += (m & uint32_t(tx) ? m * m : 0) + (m & uint32_t(ty) ? 2 * m * m : 0);
        }
        zs[size_t(y) * mtw + x] =
            (uint32_t(cy * sp.ctb_w + cx) << (2 * d)) + z;
      }
  }

  void finish_picture() {
    if (!in_picture) return;
    in_picture = false;
    if (!headers_only && cur) {
      deblock();
      if (sp.sao) apply_sao();
    }
    cur.reset();
  }

  void slice() {
    Bits b{rbsp.d.data(), rbsp.d.size(), 16};
    slice_header(b);
    if (sh.first) {
      finish_picture();
      start_picture();
    }
    if (skipping || headers_only) return;
    if (!in_picture) broken("HEVC slice segment without its picture");
    // Reference lists (8.3.4).
    int num_curr = int(st_before.size() + st_after.size());
    for (int l = 0; l < 2; ++l)
      for (int i = 0; i < 16; ++i) list[l][i].reset();
    for (int l = 0; l < (sh.type == 0 ? 2 : sh.type == 1 ? 1 : 0); ++l) {
      std::vector<FramePtr> temp;
      const std::vector<FramePtr>& a = l == 0 ? st_before : st_after;
      const std::vector<FramePtr>& c = l == 0 ? st_after : st_before;
      while (int(temp.size()) < std::max(sh.num_ref[l], num_curr)) {
        for (const FramePtr& f : a) temp.push_back(f);
        for (const FramePtr& f : c) temp.push_back(f);
      }
      for (int i = 0; i < sh.num_ref[l]; ++i)
        list[l][i] = temp[size_t(sh.modified[l] ? sh.list_entry[l][i] : i)];
    }
    col.reset();
    if (sh.temporal_mvp && sh.type != 2)
      col = list[sh.col_from_l0 || sh.type == 1 ? 0 : 1][sh.col_ref];
    weighted = (sh.type == 1 && pp.weighted_pred) || (sh.type == 0 && pp.weighted_bipred);
    sl = sp.scaling_enabled ? (pp.scaling_present ? &pp.sl : &sp.sl) : nullptr;
    SliceParams prm;
    prm.deblocking_disabled = sh.deblocking_disabled;
    prm.beta_offset = sh.beta_offset;
    prm.tc_offset = sh.tc_offset;
    prm.lf_across = sh.lf_across;
    slices.push_back(prm);
    slice_idx = int(slices.size()) - 1;
    log2_qg = sp.log2_ctb - pp.diff_cu_qp_delta_depth;
    if (log2_qg < sp.log2_min_cb) broken("HEVC diff_cu_qp_delta_depth out of range");
    slice_data(b.pos >> 3);
  }

  // ------------------------------------------------------- slice data

  // The bit reader at byte `off` of the RBSP, the arithmetic decoder
  // started there.
  void start_engine(size_t off) {
    bits.p = rbsp.d.data();
    bits.n = rbsp.d.size();
    bits.pos = off * 8;
    cab.b = &bits;
    cab.start();
  }

  void slice_data(size_t data_off) {
    init_type = sh.type == 2 ? 0 : sh.type == 1 ? (sh.cabac_init ? 2 : 1)
                                               : (sh.cabac_init ? 1 : 2);
    start_engine(data_off);
    cab.init_contexts(init_type, sh.qp);
    // Substream k begins entries[0] + ... + entries[k-1] bytes of the NAL
    // unit after the slice data's first.
    size_t nal_off = rbsp.at[data_off];
    size_t entry = 0;
    int ctb = sh.address;
    const int nctb = sp.ctb_w * sp.ctb_h;
    qp_y = sh.qp;
    qpy_pred = sh.qp;
    first_qp_group = true;
    bool wpp_saved = false;
    for (;;) {
      if (ctb >= nctb) broken("HEVC slice data runs past the picture");
      int cx = ctb % sp.ctb_w, cy = ctb / sp.ctb_w;
      ctb_slice[size_t(ctb)] = slice_idx;
      if (pp.entropy_sync && cx == 0) {
        first_qp_group = true;
        if (ctb != sh.address) {
          // The contexts of the row above after its second CTB, when that
          // CTB is in the slice; else fresh ones.
          bool above = sp.ctb_w > 1 && cy > 0 &&
                       ctb_slice[size_t(ctb - sp.ctb_w + 1)] == slice_idx;
          if (above && wpp_saved)
            std::memcpy(cab.st, wpp_st, kNumCtx);
          else
            cab.init_contexts(init_type, sh.qp);
        }
      }
      int x0 = cx << sp.log2_ctb, y0 = cy << sp.log2_ctb;
      sao_syntax(ctb, cx, cy);
      coding_quadtree(x0, y0, sp.log2_ctb, 0);
      if (bits.over() && bits.pos > bits.n * 8 + 64)
        broken("HEVC slice data cut short");
      int end = cab.terminate();
      if (pp.entropy_sync && cx == 1) {
        std::memcpy(wpp_st, cab.st, kNumCtx);
        wpp_saved = true;
      }
      ++ctb;
      if (end) break;
      if (pp.entropy_sync && ctb % sp.ctb_w == 0) {
        if (!cab.terminate()) broken("HEVC end_of_subset_one_bit is 0");
        if (entry >= sh.entries.size()) broken("HEVC WPP row without its entry point");
        nal_off += sh.entries[entry++];
        auto it = std::lower_bound(rbsp.at.begin(), rbsp.at.end(), uint32_t(nal_off));
        if (it == rbsp.at.end()) broken("HEVC entry point past the slice");
        start_engine(size_t(it - rbsp.at.begin()));
      }
    }
  }

  // ------------------------------------------------------------ helpers

  size_t at4(int x, int y) const { return size_t(y >> 2) * size_t(w4) + size_t(x >> 2); }
  int ctb_of(int x, int y) const {
    return (y >> sp.log2_ctb) * sp.ctb_w + (x >> sp.log2_ctb);
  }

  // 6.4.1: whether (xn, yn) is decoded before (xc, yc), in the picture
  // and in the same slice.
  bool avail(int xc, int yc, int xn, int yn) const {
    if (xn < 0 || yn < 0 || xn >= W || yn >= H) return false;
    if (zs[size_t(yn >> mtb) * mtw + (xn >> mtb)] >
        zs[size_t(yc >> mtb) * mtw + (xc >> mtb)])
      return false;
    return ctb_slice[size_t(ctb_of(xn, yn))] == ctb_slice[size_t(ctb_of(xc, yc))];
  }

  template <class T>
  void fill4(std::vector<T>& a, int x0, int y0, int w, int h, T v) {
    for (int y = y0; y < y0 + h; y += 4)
      for (int x = x0; x < x0 + w; x += 4) a[at4(x, y)] = v;
  }

  // ------------------------------------------------------------ SAO

  void sao_syntax(int ctb, int cx, int cy) {
    SaoParams& s = sao[size_t(ctb)];
    if (!sh.sao_luma && !sh.sao_chroma) return;
    bool merge_left = false, merge_up = false;
    if (cx > 0 && ctb_slice[size_t(ctb - 1)] == slice_idx)
      merge_left = cab.decide(kSaoMerge);
    if (cy > 0 && !merge_left && ctb_slice[size_t(ctb - sp.ctb_w)] == slice_idx)
      merge_up = cab.decide(kSaoMerge);
    if (merge_left || merge_up) {
      s = sao[size_t(merge_left ? ctb - 1 : ctb - sp.ctb_w)];
      if (!sh.sao_luma) s.type[0] = 0;
      if (!sh.sao_chroma) s.type[1] = s.type[2] = 0;
      return;
    }
    int cmax = (1 << (std::min(bd, 10) - 5)) - 1;
    for (int c = 0; c < 3; ++c) {
      if ((c == 0 && !sh.sao_luma) || (c > 0 && !sh.sao_chroma)) {
        s.type[c] = 0;
        continue;
      }
      if (c == 2) {
        s.type[2] = s.type[1];
        s.eo[2] = s.eo[1];
      } else {
        s.type[c] = !cab.decide(kSaoType) ? 0 : cab.bypass() ? 2 : 1;
      }
      if (!s.type[c]) continue;
      int abs_v[4];
      for (int i = 0; i < 4; ++i) {
        int v = 0;
        while (v < cmax && cab.bypass()) ++v;
        abs_v[i] = v;
      }
      s.off[c][0] = 0;
      if (s.type[c] == 1) {
        for (int i = 0; i < 4; ++i)
          s.off[c][i + 1] = abs_v[i] && cab.bypass() ? -abs_v[i] : abs_v[i];
        s.band[c] = cab.bypass_bits(5);
      } else {
        for (int i = 0; i < 4; ++i) s.off[c][i + 1] = i < 2 ? abs_v[i] : -abs_v[i];
        if (c == 0) s.eo[0] = cab.bypass_bits(2);
        if (c == 1) s.eo[1] = cab.bypass_bits(2);
      }
    }
  }

  // ------------------------------------------------------- coding tree

  void coding_quadtree(int x0, int y0, int log2, int depth) {
    int size = 1 << log2;
    bool split;
    if (x0 + size <= W && y0 + size <= H && log2 > sp.log2_min_cb) {
      int ctx = 0;
      if (avail(x0, y0, x0 - 1, y0) && depth4[at4(x0 - 1, y0)] > depth) ++ctx;
      if (avail(x0, y0, x0, y0 - 1) && depth4[at4(x0, y0 - 1)] > depth) ++ctx;
      split = cab.decide(kSplitCu + ctx);
    } else {
      split = log2 > sp.log2_min_cb;
    }
    if (pp.cu_qp_delta && log2 >= log2_qg) {
      qp_delta_coded = false;
      qp_delta = 0;
    }
    int qg_mask = (1 << log2_qg) - 1;
    if (split) {
      int h = size >> 1;
      coding_quadtree(x0, y0, log2 - 1, depth + 1);
      if (x0 + h < W) coding_quadtree(x0 + h, y0, log2 - 1, depth + 1);
      if (y0 + h < H) coding_quadtree(x0, y0 + h, log2 - 1, depth + 1);
      if (x0 + h < W && y0 + h < H) coding_quadtree(x0 + h, y0 + h, log2 - 1, depth + 1);
      if (((x0 + size) & qg_mask) == 0 && ((y0 + size) & qg_mask) == 0)
        qpy_pred = qp_y;
    } else {
      coding_unit(x0, y0, log2, depth);
    }
  }

  // libavcodec's get_qPy_pred and ff_hevc_set_qPy (8.6.1).
  void set_qpy(int xb, int yb) {
    int ctb_mask = sp.ctb_size - 1, qg_mask = (1 << log2_qg) - 1;
    int xq = xb - (xb & qg_mask), yq = yb - (yb & qg_mask);
    bool av_a = (xb & ctb_mask) && (xq & ctb_mask);
    bool av_b = (yb & ctb_mask) && (yq & ctb_mask);
    int pred;
    if (first_qp_group || (!xq && !yq)) {
      first_qp_group = !qp_delta_coded;
      pred = sh.qp;
    } else {
      pred = qpy_pred;
    }
    int qa = av_a ? qp4[at4(xq - 1, yq)] : pred;
    int qb = av_b ? qp4[at4(xq, yq - 1)] : pred;
    int q = (qa + qb + 1) >> 1;
    if (qp_delta) {
      int m = 52 + qp_bd;
      q = ((q + qp_delta + 52 + 2 * qp_bd) % m + m) % m - qp_bd;
    }
    qp_y = q;
  }

  void coding_unit(int x0, int y0, int log2, int depth) {
    int n = 1 << log2;
    cu_x = x0;
    cu_y = y0;
    cu_log2 = log2;
    cu_bypass = pp.transquant_bypass && cab.decide(kBypassFlag);
    bool skip = false;
    if (sh.type != 2) {
      int ctx = 0;
      if (avail(x0, y0, x0 - 1, y0) && skip4[at4(x0 - 1, y0)]) ++ctx;
      if (avail(x0, y0, x0, y0 - 1) && skip4[at4(x0, y0 - 1)]) ++ctx;
      skip = cab.decide(kSkip + ctx);
    }
    fill4<uint8_t>(depth4, x0, y0, n, n, uint8_t(depth));
    fill4<uint8_t>(skip4, x0, y0, n, n, skip);
    fill4<uint8_t>(bypass4, x0, y0, n, n, cu_bypass);
    cu_part = kPart2Nx2N;
    merge_2nx2n = false;
    intra_split = false;
    if (skip) {
      cu_intra = false;
      fill4<uint8_t>(mode4, x0, y0, n, n, 2);
      prediction_unit(x0, y0, n, n, 0, true, depth);
      boundary_strengths(x0, y0, log2);
    } else {
      cu_intra = sh.type == 2 || cab.decide(kPredMode);
      if (!cu_intra || log2 == sp.log2_min_cb) cu_part = part_mode(log2);
      fill4<uint8_t>(mode4, x0, y0, n, n, cu_intra ? 1 : 2);
      if (cu_intra) {
        if (cu_part == kPart2Nx2N && sp.pcm && log2 >= sp.log2_min_pcm &&
            log2 <= sp.log2_max_pcm && cab.terminate())
          unsupported("HEVC PCM samples");
        intra_modes(x0, y0, log2);
        for (int y = y0; y < y0 + n; y += 4)
          for (int x = x0; x < x0 + n; x += 4)
            cur->mvf[size_t(y >> 2) * cur->mvw + size_t(x >> 2)] = MvField();
      } else {
        int h = n >> 1, q = n >> 2;
        switch (cu_part) {
          case kPart2Nx2N: prediction_unit(x0, y0, n, n, 0, false, depth); break;
          case kPart2NxN:
            prediction_unit(x0, y0, n, h, 0, false, depth);
            prediction_unit(x0, y0 + h, n, h, 1, false, depth);
            break;
          case kPartNx2N:
            prediction_unit(x0, y0, h, n, 0, false, depth);
            prediction_unit(x0 + h, y0, h, n, 1, false, depth);
            break;
          case kPart2NxnU:
            prediction_unit(x0, y0, n, q, 0, false, depth);
            prediction_unit(x0, y0 + q, n, n - q, 1, false, depth);
            break;
          case kPart2NxnD:
            prediction_unit(x0, y0, n, n - q, 0, false, depth);
            prediction_unit(x0, y0 + n - q, n, q, 1, false, depth);
            break;
          case kPartnLx2N:
            prediction_unit(x0, y0, q, n, 0, false, depth);
            prediction_unit(x0 + q, y0, n - q, n, 1, false, depth);
            break;
          case kPartnRx2N:
            prediction_unit(x0, y0, n - q, n, 0, false, depth);
            prediction_unit(x0 + n - q, y0, q, n, 1, false, depth);
            break;
          default:
            prediction_unit(x0, y0, h, h, 0, false, depth);
            prediction_unit(x0 + h, y0, h, h, 1, false, depth);
            prediction_unit(x0, y0 + h, h, h, 2, false, depth);
            prediction_unit(x0 + h, y0 + h, h, h, 3, false, depth);
            break;
        }
      }
      bool root = true;
      if (!cu_intra && !(cu_part == kPart2Nx2N && merge_2nx2n))
        root = cab.decide(kRqtRoot);
      if (root) {
        intra_split = cu_intra && cu_part == kPartNxN;
        max_trafo_depth = cu_intra ? sp.max_th_depth_intra + intra_split
                                   : sp.max_th_depth_inter;
        transform_tree(x0, y0, x0, y0, log2, 0, 0, false, false);
      } else {
        boundary_strengths(x0, y0, log2);
      }
    }
    if (pp.cu_qp_delta && !qp_delta_coded) set_qpy(x0, y0);
    fill4<int8_t>(qp4, x0, y0, n, n, int8_t(qp_y));
    int qg_mask = (1 << log2_qg) - 1;
    if (((x0 + n) & qg_mask) == 0 && ((y0 + n) & qg_mask) == 0) qpy_pred = qp_y;
  }

  int part_mode(int log2) {
    if (cab.decide(kPartMode)) return kPart2Nx2N;
    if (log2 == sp.log2_min_cb) {
      if (cu_intra) return kPartNxN;
      if (cab.decide(kPartMode + 1)) return kPart2NxN;
      if (log2 == 3) return kPartNx2N;
      if (cab.decide(kPartMode + 2)) return kPartNx2N;
      return kPartNxN;
    }
    if (!sp.amp) return cab.decide(kPartMode + 1) ? kPart2NxN : kPartNx2N;
    if (cab.decide(kPartMode + 1)) {
      if (cab.decide(kPartMode + 3)) return kPart2NxN;
      return cab.bypass() ? kPart2NxnD : kPart2NxnU;
    }
    if (cab.decide(kPartMode + 3)) return kPartNx2N;
    return cab.bypass() ? kPartnRx2N : kPartnLx2N;
  }

  // 8.4.2: the luma modes of the CU's prediction blocks, then chroma's.
  void intra_modes(int x0, int y0, int log2) {
    int nparts = cu_part == kPartNxN ? 4 : 1;
    int pb = cu_part == kPartNxN ? (1 << log2) >> 1 : 1 << log2;
    int flag[4], idx[4];
    for (int i = 0; i < nparts; ++i) flag[i] = cab.decide(kPrevIntra);
    for (int i = 0; i < nparts; ++i) {
      if (flag[i]) {
        idx[i] = 0;
        while (idx[i] < 2 && cab.bypass()) ++idx[i];
      } else {
        idx[i] = cab.bypass_bits(5);
      }
    }
    int first = 0;
    for (int i = 0; i < nparts; ++i) {
      int x = x0 + (i & 1) * pb, y = y0 + (i >> 1) * pb;
      auto cand = [&](int xn, int yn, bool above) {
        if (!avail(x, y, xn, yn) || mode4[at4(xn, yn)] != 1) return 1;
        if (above && yn < ((y >> sp.log2_ctb) << sp.log2_ctb)) return 1;
        return int(ipm4[at4(xn, yn)]);
      };
      int a = cand(x - 1, y, false), b = cand(x, y - 1, true);
      int list[3];
      if (a == b) {
        if (a < 2) {
          list[0] = 0;
          list[1] = 1;
          list[2] = 26;
        } else {
          list[0] = a;
          list[1] = 2 + ((a + 29) % 32);
          list[2] = 2 + ((a - 2 + 1) % 32);
        }
      } else {
        list[0] = a;
        list[1] = b;
        list[2] = a != 0 && b != 0 ? 0 : a != 1 && b != 1 ? 1 : 26;
      }
      int mode;
      if (flag[i]) {
        mode = list[idx[i]];
      } else {
        std::sort(list, list + 3);
        mode = idx[i];
        for (int k = 0; k < 3; ++k)
          if (mode >= list[k]) ++mode;
      }
      fill4<uint8_t>(ipm4, x, y, pb, pb, uint8_t(mode));
      if (i == 0) first = mode;
    }
    int c = cab.decide(kChromaMode) ? cab.bypass_bits(2) : 4;
    if (c == 4) {
      chroma_mode = first;
    } else {
      static const int kModes[4] = {0, 26, 10, 1};
      chroma_mode = kModes[c] == first ? 34 : kModes[c];
    }
  }

  // ------------------------------------------------- prediction units

  const MvField& mvf_at(int x, int y) const {
    return cur->mvf[size_t(y >> 2) * cur->mvw + size_t(x >> 2)];
  }

  // 6.4.2: a neighbouring prediction block's availability.
  bool avail_pb(int xp, int yp, int w, int h, int part, int xn, int yn) const {
    int n = 1 << cu_log2;
    bool same = cu_x <= xn && cu_y <= yn && cu_x + n > xn && cu_y + n > yn;
    bool a;
    if (!same)
      a = avail(xp, yp, xn, yn);
    else
      a = !((w << 1) == n && (h << 1) == n && part == 1 && cu_y + h <= yn &&
            cu_x + w > xn);
    return a && mode4[at4(xn, yn)] == 2;
  }

  int ref_poc(int l, int i) const { return list[l][i]->poc; }

  void prediction_unit(int xp, int yp, int w, int h, int part, bool skip,
                       int depth) {
    MvField m;
    bool merge = skip;
    int merge_idx = 0;
    int ref[2] = {0, 0}, mvp[2] = {0, 0};
    Mv mvd[2];
    int idc = 1;                                 // bit 0 L0, bit 1 L1
    if (!skip) merge = cab.decide(kMergeFlag);
    if (merge) {
      if (sh.max_merge > 1) {
        if (cab.decide(kMergeIdx)) {
          merge_idx = 1;
          while (merge_idx < sh.max_merge - 1 && cab.bypass()) ++merge_idx;
        }
      }
    } else {
      if (sh.type == 0) {
        if (w + h != 12 && cab.decide(kInterPred + depth))
          idc = 3;
        else
          idc = cab.decide(kInterPred + 4) ? 2 : 1;
      }
      for (int l = 0; l < 2; ++l) {
        if (!(idc & (1 << l))) continue;
        if (sh.num_ref[l] > 1) {
          int i = 0, maxc = std::min(sh.num_ref[l] - 1, 2);
          while (i < maxc && cab.decide(kRefIdx + i)) ++i;
          if (i == 2)
            while (i < sh.num_ref[l] - 1 && cab.bypass()) ++i;
          ref[l] = i;
        }
        if (l == 1 && sh.mvd_l1_zero && idc == 3)
          mvd[1] = Mv();
        else
          mvd[l] = mvd_coding();
        mvp[l] = cab.decide(kMvpFlag);
      }
    }
    if (part == 0 && merge) merge_2nx2n = true;
    if (merge) {
      m = merge_candidate(xp, yp, w, h, part, merge_idx);
    } else {
      m.pred = uint8_t(idc);
      for (int l = 0; l < 2; ++l) {
        if (!(idc & (1 << l))) continue;
        Mv p = amvp(xp, yp, w, h, part, l, ref[l], mvp[l]);
        m.ref[l] = int8_t(ref[l]);
        m.mv[l].x = int16_t(uint16_t(p.x + mvd[l].x));
        m.mv[l].y = int16_t(uint16_t(p.y + mvd[l].y));
      }
    }
    for (int l = 0; l < 2; ++l) {
      if (m.pred & (1 << l)) {
        if (m.ref[l] < 0 || m.ref[l] >= sh.num_ref[l] || !list[l][m.ref[l]])
          broken("HEVC reference index out of range");
        m.poc[l] = ref_poc(l, m.ref[l]);
      } else {
        m.ref[l] = -1;
        m.mv[l] = Mv();
      }
    }
    for (int y = yp; y < yp + h; y += 4)
      for (int x = xp; x < xp + w; x += 4)
        cur->mvf[size_t(y >> 2) * cur->mvw + size_t(x >> 2)] = m;
    motion_compensation(xp, yp, w, h, m);
  }

  Mv mvd_coding() {
    int g0x = cab.decide(kMvdG0), g0y = cab.decide(kMvdG0);
    int g1x = g0x ? cab.decide(kMvdG1) : 0, g1y = g0y ? cab.decide(kMvdG1) : 0;
    auto comp = [&](int g0, int g1) {
      if (!g0) return 0;
      int v = 1;
      if (g1) v = 2 + eg(1);
      return cab.bypass() ? -v : v;
    };
    Mv d;
    int x = comp(g0x, g1x);
    int y = comp(g0y, g1y);
    if (x < -32768 || x > 32767 || y < -32768 || y > 32767) broken("HEVC mvd out of range");
    d.x = int16_t(x);
    d.y = int16_t(y);
    return d;
  }

  int eg(int k) {
    int v = 0;
    while (cab.bypass()) {
      v += 1 << k;
      ++k;
      if (k > 31) broken("HEVC Exp-Golomb bypass code too long");
    }
    return v + cab.bypass_bits(k);
  }

  // 8.5.3.2.8-9 (libavcodec's temporal_luma_motion_vector).
  bool temporal_mv(int xp, int yp, int w, int h, int ref_idx, int X, Mv& out) {
    out = Mv();
    if (!col || col->mvf.empty()) return false;
    auto derive = [&](int x, int y) {
      x &= ~15;
      y &= ~15;
      const MvField& c = col->mvf[size_t(y >> 2) * col->mvw + size_t(x >> 2)];
      if (!c.pred) return false;
      int lc;
      if (!(c.pred & 1)) {
        lc = 1;
      } else if (c.pred == 1) {
        lc = 0;
      } else {
        bool backward = false;
        for (int l = 0; l < 2; ++l)
          for (int i = 0; i < sh.num_ref[l]; ++i)
            if (ref_poc(l, i) > cur->poc) backward = true;
        lc = !backward ? X : (sh.col_from_l0 ? 1 : 0);
      }
      int col_diff = col->poc - c.poc[lc];
      int cur_diff = cur->poc - ref_poc(X, ref_idx);
      Mv mv = c.mv[lc];
      if (col_diff == cur_diff || !col_diff)
        out = mv;
      else
        out = scale_mv(mv, col_diff, cur_diff);
      return true;
    };
    int x = xp + w, y = yp + h;
    if ((yp >> sp.log2_ctb) == (y >> sp.log2_ctb) && y < H && x < W && derive(x, y))
      return true;
    return derive(xp + (w >> 1), yp + (h >> 1));
  }

  static Mv scale_mv(Mv mv, int td, int tb) {
    td = clip3(-128, 127, td);
    tb = clip3(-128, 127, tb);
    int tx = (0x4000 + std::abs(td / 2)) / td;
    int f = clip3(-4096, 4095, (tb * tx + 32) >> 6);
    auto s = [&](int v) {
      int p = f * v;
      return int16_t(clip3(-32768, 32767, (p + 127 + (p < 0)) >> 8));
    };
    Mv r;
    r.x = s(mv.x);
    r.y = s(mv.y);
    return r;
  }

  // 8.5.3.2.2-5 (libavcodec's derive_spatial_merge_candidates).
  MvField merge_candidate(int xp, int yp, int w, int h, int part, int idx) {
    int ow = w, oh = h;
    int pidx = part;
    if (pp.log2_parallel_merge > 2 && (1 << cu_log2) == 8) {
      xp = cu_x;
      yp = cu_y;
      w = h = 8;
      pidx = 0;
    }
    int pm = pp.log2_parallel_merge;
    auto diff_mer = [&](int xn, int yn) {
      return (xp >> pm) == (xn >> pm) && (yp >> pm) == (yn >> pm);
    };
    MvField cand[5];
    int n = 0;
    auto done = [&]() { return n > idx; };
    int part_mode = cu_part;
    // A1
    int xa1 = xp - 1, ya1 = yp + h - 1;
    bool a1 = avail_pb(xp, yp, w, h, pidx, xa1, ya1) && !diff_mer(xa1, ya1) &&
              !(pidx == 1 && (part_mode == kPartNx2N || part_mode == kPartnLx2N ||
                              part_mode == kPartnRx2N));
    if (a1) cand[n++] = mvf_at(xa1, ya1);
    if (!done()) {
      int xb1 = xp + w - 1, yb1 = yp - 1;
      bool b1 = avail_pb(xp, yp, w, h, pidx, xb1, yb1) && !diff_mer(xb1, yb1) &&
                !(pidx == 1 && (part_mode == kPart2NxN || part_mode == kPart2NxnU ||
                                part_mode == kPart2NxnD));
      if (b1 && !(a1 && same_motion(mvf_at(xb1, yb1), mvf_at(xa1, ya1))))
        cand[n++] = mvf_at(xb1, yb1);
      int xb0 = xp + w, yb0 = yp - 1;
      bool b0 = !done() && avail_pb(xp, yp, w, h, pidx, xb0, yb0) && !diff_mer(xb0, yb0);
      if (b0 && !(b1 && same_motion(mvf_at(xb0, yb0), mvf_at(xb1, yb1))))
        cand[n++] = mvf_at(xb0, yb0);
      int xa0 = xp - 1, ya0 = yp + h;
      bool a0 = !done() && avail_pb(xp, yp, w, h, pidx, xa0, ya0) && !diff_mer(xa0, ya0);
      if (a0 && !(a1 && same_motion(mvf_at(xa0, ya0), mvf_at(xa1, ya1))))
        cand[n++] = mvf_at(xa0, ya0);
      int xb2 = xp - 1, yb2 = yp - 1;
      bool b2 = !done() && avail_pb(xp, yp, w, h, pidx, xb2, yb2) && !diff_mer(xb2, yb2);
      if (b2 && !(a1 && same_motion(mvf_at(xb2, yb2), mvf_at(xa1, ya1))) &&
          !(b1 && same_motion(mvf_at(xb2, yb2), mvf_at(xb1, yb1))) && n != 4)
        cand[n++] = mvf_at(xb2, yb2);
    }
    std::vector<MvField> list_c(cand, cand + n);
    if (int(list_c.size()) <= idx && sh.temporal_mvp &&
        int(list_c.size()) < sh.max_merge) {
      Mv m0, m1;
      bool l0 = temporal_mv(xp, yp, w, h, 0, 0, m0);
      bool l1 = sh.type == 0 && temporal_mv(xp, yp, w, h, 0, 1, m1);
      if (l0 || l1) {
        MvField t;
        t.pred = uint8_t(l0 + (l1 << 1));
        t.ref[0] = t.ref[1] = 0;
        t.mv[0] = m0;
        t.mv[1] = m1;
        list_c.push_back(t);
      }
    }
    int orig = int(list_c.size());
    if (int(list_c.size()) <= idx && sh.type == 0 && orig > 1 && orig < sh.max_merge) {
      static const int kL0[12] = {0, 1, 0, 2, 1, 2, 0, 3, 1, 3, 2, 3};
      static const int kL1[12] = {1, 0, 2, 0, 2, 1, 3, 0, 3, 1, 3, 2};
      for (int k = 0; int(list_c.size()) < sh.max_merge && k < orig * (orig - 1);
           ++k) {
        const MvField& c0 = list_c[size_t(kL0[k])];
        const MvField& c1 = list_c[size_t(kL1[k])];
        if ((c0.pred & 1) && (c1.pred & 2) &&
            (ref_poc(0, c0.ref[0]) != ref_poc(1, c1.ref[1]) || c0.mv[0] != c1.mv[1])) {
          MvField t;
          t.pred = 3;
          t.ref[0] = c0.ref[0];
          t.ref[1] = c1.ref[1];
          t.mv[0] = c0.mv[0];
          t.mv[1] = c1.mv[1];
          list_c.push_back(t);
          if (int(list_c.size()) > idx) break;
        }
      }
    }
    int nref = sh.type == 1 ? sh.num_ref[0] : std::min(sh.num_ref[0], sh.num_ref[1]);
    int zero = 0;
    while (int(list_c.size()) <= idx) {
      MvField t;
      t.pred = sh.type == 0 ? 3 : 1;
      int r = zero < nref ? zero : 0;
      t.ref[0] = int8_t(r);
      t.ref[1] = int8_t(sh.type == 0 ? r : -1);
      list_c.push_back(t);
      ++zero;
    }
    MvField m = list_c[size_t(idx)];
    if (m.pred == 3 && ow + oh == 12) {
      m.pred = 1;
      m.ref[1] = -1;
      m.mv[1] = Mv();
    }
    return m;
  }

  // 8.5.3.2.6-7: the motion vector predictor of list X.
  Mv amvp(int xp, int yp, int w, int h, int part, int X, int ref_idx, int flag) {
    int Y = 1 - X;
    int target = ref_poc(X, ref_idx);
    auto avl = [&](int xn, int yn) { return avail_pb(xp, yp, w, h, part, xn, yn); };
    // Without scaling: a list whose reference is the target picture.
    auto same_pic = [&](int xn, int yn, Mv& out) {
      const MvField& f = mvf_at(xn, yn);
      if ((f.pred & (1 << X)) && f.poc[X] == target) {
        out = f.mv[X];
        return true;
      }
      if ((f.pred & (1 << Y)) && f.poc[Y] == target) {
        out = f.mv[Y];
        return true;
      }
      return false;
    };
    auto scaled = [&](int xn, int yn, Mv& out) {
      const MvField& f = mvf_at(xn, yn);
      int l = (f.pred & (1 << X)) ? X : (f.pred & (1 << Y)) ? Y : -1;
      if (l < 0) return false;
      out = f.mv[l];
      if (f.poc[l] != target) {                  // libavcodec's dist_scale
        int td = cur->poc - f.poc[l];
        out = scale_mv(out, td ? td : 1, cur->poc - target);
      }
      return true;
    };
    int xa0 = xp - 1, ya0 = yp + h, xa1 = xp - 1, ya1 = yp + h - 1;
    bool a0 = avl(xa0, ya0), a1 = avl(xa1, ya1);
    bool scaled_flag = a0 || a1;
    Mv mva, mvb;
    bool fa = false, fb = false;
    if (a0) fa = same_pic(xa0, ya0, mva);
    if (!fa && a1) fa = same_pic(xa1, ya1, mva);
    if (!fa && a0) fa = scaled(xa0, ya0, mva);
    if (!fa && a1) fa = scaled(xa1, ya1, mva);
    int xb0 = xp + w, yb0 = yp - 1, xb1 = xp + w - 1, yb1 = yp - 1, xb2 = xp - 1, yb2 = yp - 1;
    bool b0 = avl(xb0, yb0), b1 = avl(xb1, yb1), b2 = avl(xb2, yb2);
    if (b0) fb = same_pic(xb0, yb0, mvb);
    if (!fb && b1) fb = same_pic(xb1, yb1, mvb);
    if (!fb && b2) fb = same_pic(xb2, yb2, mvb);
    if (!scaled_flag && fb) {
      fa = true;
      mva = mvb;
    }
    if (!scaled_flag) {
      fb = false;
      if (b0) fb = scaled(xb0, yb0, mvb);
      if (!fb && b1) fb = scaled(xb1, yb1, mvb);
      if (!fb && b2) fb = scaled(xb2, yb2, mvb);
    }
    Mv cands[3];
    int n = 0;
    if (fa) cands[n++] = mva;
    if (fb && !(fa && mva == mvb)) cands[n++] = mvb;
    if (n < 2 && flag >= n && sh.temporal_mvp) {
      Mv t;
      if (!(fa && fb && mva != mvb) && temporal_mv(xp, yp, w, h, ref_idx, X, t))
        cands[n++] = t;
    }
    while (n < 2) cands[n++] = Mv();
    return cands[flag];
  }

  // ------------------------------------------------ motion compensation

  // The reference samples a block's interpolation reads, `pad` before
  // and `pad + 1` after it each way, read clamped to the picture (its
  // padding) into `win` (row stride w + 2 * pad + 1).
  void window(const Frame& r, int c, int xi, int yi, int w, int h, int pad,
              std::vector<int16_t>& win) {
    const int ww = w + 2 * pad + 1, wh = h + 2 * pad + 1;
    const int pw = c ? r.w >> 1 : r.w, ph = c ? r.h >> 1 : r.h;
    const uint16_t* s = r.pl[c].data();
    const int st = r.stride[c];
    win.resize(size_t(ww) * wh);
    for (int y = 0; y < wh; ++y) {
      const uint16_t* row = s + size_t(clip3(0, ph - 1, yi - pad + y)) * st;
      int16_t* d = &win[size_t(y) * ww];
      int x0 = xi - pad;
      if (x0 >= 0 && x0 + ww <= pw) {
        for (int x = 0; x < ww; ++x) d[x] = int16_t(row[x0 + x]);
      } else {
        for (int x = 0; x < ww; ++x) d[x] = int16_t(row[clip3(0, pw - 1, x0 + x)]);
      }
    }
  }

  // 8.5.3.3.3: luma (8 taps, fractions of 4) or chroma (4 taps, of 8)
  // prediction samples at 14 bits of component c's block at (x0, y0).
  void interpolate(const Frame& r, int c, int x0, int y0, int w, int h, Mv mv,
                   int16_t* dst) {
    const bool luma = c == 0;
    const int fb = luma ? 2 : 3, taps = luma ? 8 : 4, pad = luma ? 3 : 1;
    const int fx = mv.x & ((1 << fb) - 1), fy = mv.y & ((1 << fb) - 1);
    const int xi = x0 + (mv.x >> fb), yi = y0 + (mv.y >> fb);
    const int shift1 = bd - 8, shift3 = 14 - bd;
    static thread_local std::vector<int16_t> win, tmp;
    window(r, c, xi, yi, w, h, pad, win);
    const int ww = w + 2 * pad + 1;
    const int8_t* fh = luma ? kLumaFilter[fx] : kChromaFilter[fx];
    const int8_t* fv = luma ? kLumaFilter[fy] : kChromaFilter[fy];
    auto at = [&](int x, int y) { return &win[size_t(y + pad) * ww + size_t(x + pad)]; };
    if (!fx && !fy) {
      for (int y = 0; y < h; ++y) {
        const int16_t* s = at(0, y);
        for (int x = 0; x < w; ++x) dst[y * w + x] = int16_t(s[x] << shift3);
      }
    } else if (!fy) {
      for (int y = 0; y < h; ++y) {
        const int16_t* s = at(-pad, y);
        for (int x = 0; x < w; ++x) {
          int v = 0;
          for (int i = 0; i < taps; ++i) v += fh[i] * s[x + i];
          dst[y * w + x] = int16_t(v >> shift1);
        }
      }
    } else if (!fx) {
      for (int y = 0; y < h; ++y)
        for (int x = 0; x < w; ++x) {
          const int16_t* s = at(x, y - pad);
          int v = 0;
          for (int i = 0; i < taps; ++i) v += fv[i] * s[size_t(i) * ww];
          dst[y * w + x] = int16_t(v >> shift1);
        }
    } else {
      const int th = h + taps - 1;
      tmp.resize(size_t(th) * w);
      for (int y = 0; y < th; ++y) {
        const int16_t* s = at(-pad, y - pad);
        for (int x = 0; x < w; ++x) {
          int v = 0;
          for (int i = 0; i < taps; ++i) v += fh[i] * s[x + i];
          tmp[size_t(y) * w + x] = int16_t(v >> shift1);
        }
      }
      for (int y = 0; y < h; ++y)
        for (int x = 0; x < w; ++x) {
          int v = 0;
          for (int i = 0; i < taps; ++i) v += fv[i] * tmp[size_t(y + i) * w + x];
          dst[y * w + x] = int16_t(v >> 6);
        }
    }
  }

  // 8.5.3.3.4: default and explicit weighted sample prediction.
  void motion_compensation(int xp, int yp, int w, int h, const MvField& m) {
    for (int c = 0; c < 3; ++c) {
      int cx = c ? xp >> 1 : xp, cy = c ? yp >> 1 : yp;
      int cw = c ? w >> 1 : w, chh = c ? h >> 1 : h;
      for (int l = 0; l < 2; ++l) {
        if (!(m.pred & (1 << l))) continue;
        const Frame& r = *list[l][m.ref[l]];
        if (r.pl[0].empty()) broken("HEVC reference without samples");
        interpolate(r, c, cx, cy, cw, chh, m.mv[l], predbuf[l]);
      }
      uint16_t* d = cur->pl[c].data();
      int st = cur->stride[c];
      bool bi = m.pred == 3;
      int l = m.pred == 2 ? 1 : 0;
      if (!weighted) {
        int shift1 = 14 - bd, off1 = shift1 > 0 ? 1 << (shift1 - 1) : 0;
        int shift2 = 15 - bd, off2 = 1 << (shift2 - 1);
        for (int y = 0; y < chh; ++y)
          for (int x = 0; x < cw; ++x) {
            int i = y * cw + x;
            int v = bi ? (predbuf[0][i] + predbuf[1][i] + off2) >> shift2
                       : (predbuf[l][i] + off1) >> shift1;
            d[size_t(cy + y) * st + size_t(cx + x)] = uint16_t(clip3(0, maxv, v));
          }
      } else {
        int log2wd = (c ? sh.chroma_log2 : sh.luma_log2) + 14 - bd;
        int w0 = 0, w1 = 0, o0 = 0, o1 = 0;
        auto wo = [&](int li, int& wv, int& ov) {
          int ri = m.ref[li];
          wv = c ? sh.cw[li][ri][c - 1] : sh.lw[li][ri];
          ov = c ? sh.co[li][ri][c - 1] : sh.lo[li][ri];
        };
        if (m.pred & 1) wo(0, w0, o0);
        if (m.pred & 2) wo(1, w1, o1);
        for (int y = 0; y < chh; ++y)
          for (int x = 0; x < cw; ++x) {
            int i = y * cw + x;
            int v;
            if (bi) {
              v = (predbuf[0][i] * w0 + predbuf[1][i] * w1 +
                   ((o0 + o1 + 1) << log2wd)) >> (log2wd + 1);
            } else {
              int ww = l ? w1 : w0, oo = l ? o1 : o0;
              v = log2wd >= 1
                      ? ((predbuf[l][i] * ww + (1 << (log2wd - 1))) >> log2wd) + oo
                      : predbuf[l][i] * ww + oo;
            }
            d[size_t(cy + y) * st + size_t(cx + x)] = uint16_t(clip3(0, maxv, v));
          }
      }
    }
  }

  // ------------------------------------------------------ transform tree

  void transform_tree(int x0, int y0, int xb, int yb, int log2, int depth,
                      int blk, bool pcb, bool pcr) {
    bool split;
    if (log2 <= sp.log2_max_tb && log2 > sp.log2_min_tb &&
        depth < max_trafo_depth && !(intra_split && depth == 0)) {
      split = cab.decide(kSplitTf + 5 - log2);
    } else {
      bool inter_split = sp.max_th_depth_inter == 0 && !cu_intra &&
                         cu_part != kPart2Nx2N && depth == 0;
      split = log2 > sp.log2_max_tb || (intra_split && depth == 0) || inter_split;
    }
    bool cb = pcb, cr = pcr;          // 4x4 luma: the parent's, for blkIdx 3
    if (log2 > 2) {
      cb = (depth == 0 || pcb) && cab.decide(kCbfChroma + depth);
      cr = (depth == 0 || pcr) && cab.decide(kCbfChroma + depth);
    }
    if (split) {
      int h = 1 << (log2 - 1);
      transform_tree(x0, y0, x0, y0, log2 - 1, depth + 1, 0, cb, cr);
      transform_tree(x0 + h, y0, x0, y0, log2 - 1, depth + 1, 1, cb, cr);
      transform_tree(x0, y0 + h, x0, y0, log2 - 1, depth + 1, 2, cb, cr);
      transform_tree(x0 + h, y0 + h, x0, y0, log2 - 1, depth + 1, 3, cb, cr);
      return;
    }
    bool luma = true;
    if (cu_intra || depth != 0 || cb || cr)
      luma = cab.decide(kCbfLuma + (depth == 0 ? 1 : 0));
    transform_unit(x0, y0, xb, yb, log2, blk, luma, cb, cr);
  }

  void transform_unit(int x0, int y0, int xb, int yb, int log2, int blk,
                      bool luma, bool cb, bool cr) {
    int n = 1 << log2;
    if ((luma || cb || cr) && pp.cu_qp_delta && !qp_delta_coded) {
      int v = 0;
      if (cab.decide(kQpDelta)) {
        v = 1;
        while (v < 5 && cab.decide(kQpDelta + 1)) ++v;
        if (v == 5) v += eg(0);
      }
      if (v && cab.bypass()) v = -v;
      if (v < -(26 + qp_bd / 2) || v > 25 + qp_bd / 2) broken("HEVC cu_qp_delta out of range");
      qp_delta = v;
      qp_delta_coded = true;
      set_qpy(cu_x, cu_y);
    }
    if (luma) fill4<uint8_t>(cbf4, x0, y0, n, n, 1);
    int lmode = ipm4[at4(x0, y0)];
    if (cu_intra) intra_pred(0, x0, y0, log2, lmode);
    if (luma) residual(0, x0, y0, log2, lmode);
    if (log2 > 2) {
      for (int c = 1; c < 3; ++c) {
        if (cu_intra) intra_pred(c, x0 >> 1, y0 >> 1, log2 - 1, chroma_mode);
        if (c == 1 ? cb : cr) residual(c, x0 >> 1, y0 >> 1, log2 - 1, chroma_mode);
      }
    } else if (blk == 3) {
      for (int c = 1; c < 3; ++c) {
        if (cu_intra) intra_pred(c, xb >> 1, yb >> 1, 2, chroma_mode);
        if (c == 1 ? cb : cr) residual(c, xb >> 1, yb >> 1, 2, chroma_mode);
      }
    }
    boundary_strengths(x0, y0, log2);
  }

  // ------------------------------------------------------ residual coding

  int chroma_qp_of(int c) const {
    int off = c == 1 ? pp.cb_qp_offset + sh.cb_qp : pp.cr_qp_offset + sh.cr_qp;
    int qpi = clip3(-qp_bd, 57, qp_y + off);
    return chroma_qp(qpi) + qp_bd;
  }

  void residual(int c, int x0, int y0, int log2, int pred_mode) {
    const int n = 1 << log2;
    bool ts = pp.transform_skip && !cu_bypass && log2 == 2 &&
              cab.decide(kTsFlag + (c ? 1 : 0));
    // last_sig_coeff prefixes and suffixes
    int off, shift;
    if (c == 0) {
      off = 3 * (log2 - 2) + ((log2 - 1) >> 2);
      shift = (log2 + 1) >> 2;
    } else {
      off = 15;
      shift = log2 - 2;
    }
    int maxp = (log2 << 1) - 1;
    int px = 0, py = 0;
    while (px < maxp && cab.decide(kLastX + off + (px >> shift))) ++px;
    while (py < maxp && cab.decide(kLastY + off + (py >> shift))) ++py;
    int lx = px, ly = py;
    if (px > 3) {
      int k = (px >> 1) - 1;
      lx = (1 << k) * (2 + (px & 1)) + cab.bypass_bits(k);
    }
    if (py > 3) {
      int k = (py >> 1) - 1;
      ly = (1 << k) * (2 + (py & 1)) + cab.bypass_bits(k);
    }
    int scan = 0;
    if (cu_intra && (log2 == 2 || (log2 == 3 && c == 0))) {
      if (pred_mode >= 6 && pred_mode <= 14) scan = 2;
      else if (pred_mode >= 22 && pred_mode <= 30) scan = 1;
    }
    if (scan == 2) std::swap(lx, ly);
    std::fill(coeff, coeff + n * n, 0);
    const int lsb = log2 - 2, sbw = 1 << lsb;
    const ScanPos* sbs = kScans.s[lsb][scan];
    const ScanPos* p4 = kScans.s[2][scan];
    int last_sb = 0, last_pos = 0;
    for (int i = 0; i < sbw * sbw; ++i)
      if (sbs[i].x == (lx >> 2) && sbs[i].y == (ly >> 2)) last_sb = i;
    for (int i = 0; i < 16; ++i)
      if (p4[i].x == (lx & 3) && p4[i].y == (ly & 3)) last_pos = i;
    uint8_t csbf[8][8] = {};
    int g1ctx = 1;
    static const uint8_t kMap4[16] = {0, 1, 4, 5, 2, 3, 4, 5, 6, 6, 8, 8, 7, 7, 8, 8};
    bool hide_ok = pp.sign_hiding && !cu_bypass;
    for (int i = last_sb; i >= 0; --i) {
      int xs = sbs[i].x, ys = sbs[i].y;
      bool infer_dc = false;
      if (i < last_sb && i > 0) {
        int ctx = std::min(1, (xs + 1 < sbw ? csbf[xs + 1][ys] : 0) +
                                  (ys + 1 < sbw ? csbf[xs][ys + 1] : 0));
        csbf[xs][ys] = uint8_t(cab.decide(kCsbf + ctx + (c ? 2 : 0)));
        infer_dc = true;
      } else {
        csbf[xs][ys] = 1;
      }
      int sig[16], nsig = 0;
      int start = 15;
      if (i == last_sb) {
        sig[nsig++] = last_pos;
        start = last_pos - 1;
      }
      if (csbf[xs][ys]) {
        int prev = (xs + 1 < sbw ? csbf[xs + 1][ys] : 0) |
                   ((ys + 1 < sbw ? csbf[xs][ys + 1] : 0) << 1);
        for (int k = start; k >= 0; --k) {
          int xp = p4[k].x, yp = p4[k].y;
          int xc = (xs << 2) + xp, yc = (ys << 2) + yp;
          bool s;
          if (k > 0 || !infer_dc) {
            int ctx;
            if (log2 == 2) {
              ctx = kMap4[(yc << 2) + xc];
            } else if (xc + yc == 0) {
              ctx = 0;
            } else {
              if (prev == 0) ctx = xp + yp == 0 ? 2 : xp + yp < 3 ? 1 : 0;
              else if (prev == 1) ctx = yp == 0 ? 2 : yp == 1 ? 1 : 0;
              else if (prev == 2) ctx = xp == 0 ? 2 : xp == 1 ? 1 : 0;
              else ctx = 2;
              if (c == 0) {
                if (xs || ys) ctx += 3;
                ctx += log2 == 3 ? (scan == 0 ? 9 : 15) : 21;
              } else {
                ctx += log2 == 3 ? 9 : 12;
              }
            }
            s = cab.decide(kSig + (c ? 27 + ctx : ctx));
            if (s) infer_dc = false;
          } else {
            s = true;
          }
          if (s) sig[nsig++] = k;
        }
      }
      if (!nsig) continue;
      int ctx_set = (i == 0 || c > 0) ? 0 : 2;
      if (i != last_sb && g1ctx == 0) ++ctx_set;
      g1ctx = 1;
      int g1[16] = {}, first_g1 = -1, g2 = 0;
      for (int m = 0; m < std::min(nsig, 8); ++m) {
        g1[m] = cab.decide(kGt1 + ctx_set * 4 + g1ctx + (c ? 16 : 0));
        if (g1[m]) {
          g1ctx = 0;
          if (first_g1 < 0) first_g1 = m;
        } else if (g1ctx > 0 && g1ctx < 3) {
          ++g1ctx;
        }
      }
      if (first_g1 >= 0) g2 = cab.decide(kGt2 + ctx_set + (c ? 4 : 0));
      bool hidden = hide_ok && sig[0] - sig[nsig - 1] > 3;
      int signs[16];
      for (int m = 0; m < nsig; ++m)
        signs[m] = (hidden && m == nsig - 1) ? 0 : cab.bypass();
      int rice = 0, sum = 0;
      for (int m = 0; m < nsig; ++m) {
        int base = 1 + (m < 8 ? g1[m] : 0) + (m == first_g1 ? g2 : 0);
        int level = base;
        if (base == (m < 8 ? (m == first_g1 ? 3 : 2) : 1)) {
          int prefix = 0;
          while (prefix < 32 && cab.bypass()) ++prefix;
          if (prefix == 32) broken("HEVC coeff_abs_level_remaining too long");
          int rem;
          if (prefix < 3) {
            rem = (prefix << rice) + cab.bypass_bits(rice);
          } else {
            int k = prefix - 3;
            if (k + rice > 31) broken("HEVC coeff_abs_level_remaining too long");
            rem = (((1 << k) + 3 - 1) << rice) + cab.bypass_bits(k + rice);
          }
          level = base + rem;
          if (level > 3 * (1 << rice)) rice = std::min(rice + 1, 4);
        }
        int v = signs[m] ? -level : level;
        if (hidden) {
          sum += level;
          if (m == nsig - 1 && (sum & 1)) v = -v;
        }
        int xc = (xs << 2) + p4[sig[m]].x, yc = (ys << 2) + p4[sig[m]].y;
        coeff[yc * n + xc] = v;
      }
    }
    reconstruct(c, x0, y0, log2, ts);
  }

  // Scaling (8.6.2-8.6.4), the inverse transform, and the sum with the
  // prediction.
  void reconstruct(int c, int x0, int y0, int log2, bool ts) {
    const int n = 1 << log2;
    if (cu_bypass) {
      for (int i = 0; i < n * n; ++i) resid[i] = coeff[i];
    } else {
      int qp = c == 0 ? qp_y + qp_bd : chroma_qp_of(c);
      static const int kLevel[6] = {40, 45, 51, 57, 64, 72};
      int64_t scale = int64_t(kLevel[qp % 6]) << (qp / 6);
      int bdshift = bd + log2 - 5;
      int64_t add = int64_t(1) << (bdshift - 1);
      const uint8_t* m = nullptr;
      int dc = 16, size = log2 - 2;
      if (sl && !(ts && log2 > 2)) {
        int mid = size == 3 ? (cu_intra ? 0 : 3) : c + (cu_intra ? 0 : 3);
        m = sl->sl[size][mid];
        dc = size >= 2 ? sl->dc[size][mid] : m[0];
      }
      for (int y = 0; y < n; ++y)
        for (int x = 0; x < n; ++x) {
          int v = coeff[y * n + x];
          if (!v) continue;
          int f = 16;
          if (m) {
            if (size == 0) f = m[y * 4 + x];
            else if (size == 1) f = m[y * 8 + x];
            else if (x == 0 && y == 0) f = dc;
            else f = m[(y >> (size - 1)) * 8 + (x >> (size - 1))];
          }
          int64_t d = (v * scale * f + add) >> bdshift;
          coeff[y * n + x] = int32_t(std::max<int64_t>(-32768, std::min<int64_t>(32767, d)));
        }
      if (ts) {
        int sh2 = 15 - bd - log2;
        for (int i = 0; i < n * n; ++i)
          resid[i] = sh2 > 0 ? (coeff[i] + (1 << (sh2 - 1))) >> sh2 : coeff[i] << -sh2;
      } else {
        inverse_transform(log2, cu_intra && c == 0 && log2 == 2);
      }
    }
    uint16_t* d = cur->pl[c].data();
    int st = cur->stride[c];
    for (int y = 0; y < n; ++y)
      for (int x = 0; x < n; ++x) {
        uint16_t& s = d[size_t(y0 + y) * st + size_t(x0 + x)];
        s = uint16_t(clip3(0, maxv, int(s) + resid[y * n + x]));
      }
  }

  void inverse_transform(int log2, bool dst) {
    const int n = 1 << log2;
    int last_row = -1, last_col = -1;
    for (int y = 0; y < n; ++y)
      for (int x = 0; x < n; ++x)
        if (coeff[y * n + x]) {
          last_row = y;
          last_col = std::max(last_col, x);
        }
    const int sh2 = 20 - bd, add2 = 1 << (sh2 - 1);
    auto clip16 = [](int v) { return v < -32768 ? -32768 : v > 32767 ? 32767 : v; };
    if (last_row < 0) {
      std::fill(resid, resid + n * n, 0);
      return;
    }
    if (!dst && last_row == 0 && last_col == 0) {   // DC alone
      int g = clip16((64 * coeff[0] + 64) >> 7);
      std::fill(resid, resid + n * n, clip16((64 * g + add2) >> sh2));
      return;
    }
    // basis k at row k of a table of row stride 32 (coefficients fit in
    // 16 bits, so the sums fit in 32)
    const int8_t* m = dst ? &kDst4[0][0] : &kDct.n[log2 - 2][0][0];
    int32_t tmp[32 * 32];
    for (int x = 0; x <= last_col; ++x)            // columns after: zero
      for (int i = 0; i < n; ++i) {
        int s = 0;
        for (int k = 0; k <= last_row; ++k) s += m[k * 32 + i] * coeff[k * n + x];
        tmp[i * n + x] = clip16((s + 64) >> 7);
      }
    for (int y = 0; y < n; ++y) {
      const int32_t* t = tmp + y * n;
      for (int i = 0; i < n; ++i) {
        int s = 0;
        for (int k = 0; k <= last_col; ++k) s += m[k * 32 + i] * t[k];
        resid[y * n + i] = clip16((s + add2) >> sh2);
      }
    }
  }

  // ------------------------------------------------------ intra prediction

  // libavcodec's reference samples under constrained_intra_pred_flag
  // (hevcpred_template.c's intra_pred), which differ from 8.4.4.2.2: the
  // neighbours' intra test on the minimum PU grid (every other PU of a
  // side, none for a side shorter than a PU), substitution in runs of 4
  // samples from the left column up and along the top, a left column
  // zeroed at the picture's left edge before the general inference, and
  // the unavailable samples' 128 (0x8080 above 8 bits). Component c's
  // block at (x0, y0), n wide: left[y + 1] = p[-1][y], top[x + 1] =
  // p[x][-1], both [0] the corner.
  void cip_refs(int c, int x0, int y0, int n, int* left_out, int* top_out) {
    const int sh = c ? 1 : 0;
    const uint16_t* d = cur->pl[c].data();
    const int st = cur->stride[c];
    const int xl = x0 << sh, yl = y0 << sh;       // luma
    const int lpu = sp.log2_min_cb - 1;
    const int pu_w = W >> lpu, pu_h = H >> lpu;
    auto PU = [&](int v) { return v >> lpu; };
    // tab_mvf[px + py * pu_w].pred_flag == PF_INTRA, flat as libavcodec
    // reads it (a column left of the picture is the row above's last).
    auto intra_pu = [&](int px, int py) {
      long f = long(px) + long(py) * pu_w;
      if (f < 0 || f >= long(pu_w) * pu_h) return false;
      int x = int(f % pu_w), y = int(f / pu_w);
      return mode4[at4(x << lpu, y << lpu)] == 1;
    };
    auto is_intra = [&](int x, int y) {
      return intra_pu(PU(xl + x * (1 << sh)), PU(yl + y * (1 << sh)));
    };
    auto pos = [&](int x, int y) {
      return int(d[size_t(y0 + y) * st + size_t(x0 + x)]);
    };
    const int size_l = n << sh;
    bool cand_up = avail(xl, yl, xl, yl - 1);
    bool cand_left = avail(xl, yl, xl - 1, yl);
    bool cand_up_left = avail(xl, yl, xl - 1, yl - 1);
    bool cand_up_right = avail(xl, yl, xl + size_l, yl - 1);
    bool cand_bottom_left = avail(xl, yl, xl - 1, yl + size_l);
    const int bl_size = (std::min(yl + 2 * size_l, H) - (yl + size_l)) >> sh;
    const int tr_size = (std::min(xl + 2 * size_l, W) - (xl + size_l)) >> sh;
    int left_a[2 * 64 + 1 + 4], top_a[2 * 64 + 1 + 4];
    int* left = left_a + 1;
    int* top = top_a + 1;
    auto extend = [&](int* p, int val, int len) {
      for (int i = 0; i < len; i += 4)
        for (int k = 0; k < 4; ++k) p[i + k] = val;
    };
    {
      int pu_v = PU(size_l), pu_h_ = PU(size_l);
      bool edge_x = !(xl & ((1 << lpu) - 1)), edge_y = !(yl & ((1 << lpu) - 1));
      if (!pu_h_) pu_h_ = 1;
      if (cand_bottom_left && edge_x) {
        int xp = PU(xl - 1), yp = PU(yl + size_l);
        int mx = std::min(pu_v, pu_h - yp);
        cand_bottom_left = false;
        for (int i = 0; i < mx; i += 2) cand_bottom_left |= intra_pu(xp, yp + i);
      }
      if (cand_left && edge_x) {
        int xp = PU(xl - 1), yp = PU(yl);
        int mx = std::min(pu_v, pu_h - yp);
        cand_left = false;
        for (int i = 0; i < mx; i += 2) cand_left |= intra_pu(xp, yp + i);
      }
      if (cand_up_left) cand_up_left = intra_pu(PU(xl - 1), PU(yl - 1));
      if (cand_up && edge_y) {
        int xp = PU(xl), yp = PU(yl - 1);
        int mx = std::min(pu_h_, pu_w - xp);
        cand_up = false;
        for (int i = 0; i < mx; i += 2) cand_up |= intra_pu(xp + i, yp);
      }
      if (cand_up_right && edge_y) {
        int yp = PU(yl - 1), xp = PU(xl + size_l);
        int mx = std::min(pu_h_, pu_w - xp);
        cand_up_right = false;
        for (int i = 0; i < mx; i += 2) cand_up_right |= intra_pu(xp + i, yp);
      }
      const int unset = bd > 8 ? 0x8080 : 128;
      for (int i = 0; i < 2 * 64; ++i) left[i] = top[i] = unset;
      top[-1] = 128;
    }
    if (cand_up_left) top[-1] = left[-1] = pos(-1, -1);
    if (cand_up)
      for (int i = 0; i < n; ++i) top[i] = pos(i, -1);
    if (cand_up_right) {
      for (int i = n; i < 2 * n; ++i) top[i] = pos(i, -1);
      extend(top + n + tr_size, pos(n + tr_size - 1, -1), n - tr_size);
    }
    if (cand_left)
      for (int i = 0; i < n; ++i) left[i] = pos(-1, i);
    if (cand_bottom_left) {
      for (int i = n; i < n + bl_size; ++i) left[i] = pos(-1, i);
      extend(left + n + bl_size, pos(-1, n + bl_size - 1), n - bl_size);
    }
    if (cand_bottom_left || cand_left || cand_up_left || cand_up ||
        cand_up_right) {
      int max_x = xl + ((2 * n) << sh) < W ? 2 * n : (W - xl) >> sh;
      int max_y = yl + ((2 * n) << sh) < H ? 2 * n : (H - yl) >> sh;
      int j = n + (cand_bottom_left ? bl_size : 0) - 1;
      if (!cand_up_right) max_x = xl + (n << sh) < W ? n : (W - xl) >> sh;
      if (!cand_bottom_left) max_y = yl + (n << sh) < H ? n : (H - yl) >> sh;
      auto extend_left_cip = [&](int* p, int start, int length) {
        for (int i = start; i > start - length; --i)
          if (!is_intra(i - 1, -1)) p[i - 1] = p[i];
      };
      if (cand_bottom_left || cand_left || cand_up_left) {
        while (j > -1 && !is_intra(-1, j)) --j;
        if (!is_intra(-1, j)) {
          j = 0;
          while (j < max_x && !is_intra(j, -1)) ++j;
          extend_left_cip(top, j, j + 1);
          left[-1] = top[-1];
        }
      } else {
        j = 0;
        while (j < max_x && !is_intra(j, -1)) ++j;
        if (j > 0) {
          extend_left_cip(top, j, j);
          top[-1] = top[0];
        }
        left[-1] = top[-1];
      }
      left[-1] = top[-1];
      int a;
      if (cand_bottom_left || cand_left) {
        a = left[-1];
        for (int i = 0; i < max_y; i += 4)
          if (!is_intra(-1, i)) extend(left + i, a, 4);
          else a = left[i + 3];
      }
      if (!cand_left) extend(left, left[-1], n);
      if (!cand_bottom_left) extend(left + n, left[n - 1], n);
      auto extend_up_cip = [&](int start, int length) {
        for (int i = start; i > start - length; i -= 4)
          if (!is_intra(-1, i - 3)) extend(left + i - 3, a, 4);
          else a = left[i - 3];
      };
      if (xl != 0 && yl != 0) {
        a = left[max_y - 1];
        extend_up_cip(max_y - 1, max_y);
        if (!is_intra(-1, -1)) left[-1] = left[0];
      } else if (xl == 0) {
        extend(left, 0, max_y);
      } else {
        a = left[max_y - 1];
        extend_up_cip(max_y - 1, max_y);
      }
      top[-1] = left[-1];
      if (yl != 0) {
        a = left[-1];
        for (int i = 0; i < max_x; i += 4)
          if (!is_intra(i, -1)) extend(top + i, a, 4);
          else a = top[i + 3];
      }
    }
    // The inference of the samples still unavailable.
    if (!cand_bottom_left) {
      if (cand_left) {
        extend(left + n, left[n - 1], n);
      } else if (cand_up_left) {
        extend(left, left[-1], 2 * n);
        cand_left = true;
      } else if (cand_up) {
        left[-1] = top[0];
        extend(left, left[-1], 2 * n);
        cand_up_left = cand_left = true;
      } else if (cand_up_right) {
        extend(top, top[n], n);
        left[-1] = top[n];
        extend(left, left[-1], 2 * n);
        cand_up = cand_up_left = cand_left = true;
      } else {
        left[-1] = 1 << (bd - 1);
        extend(top, left[-1], 2 * n);
        extend(left, left[-1], 2 * n);
      }
    }
    if (!cand_left) extend(left, left[n], n);
    if (!cand_up_left) left[-1] = left[0];
    if (!cand_up) extend(top, left[-1], n);
    if (!cand_up_right) extend(top + n, top[n - 1], n);
    top[-1] = left[-1];
    for (int i = -1; i < 2 * n; ++i) {
      left_out[i + 1] = left[i];
      top_out[i + 1] = top[i];
    }
  }

  // 8.4.4.2: component c's block at (x0, y0) (its own samples), 1 << log2
  // wide, predicted in place.
  void intra_pred(int c, int x0, int y0, int log2, int mode) {
    const int n = 1 << log2, sh1 = c ? 1 : 0, unit = c ? 2 : 4;
    uint16_t* d = cur->pl[c].data();
    const int st = cur->stride[c];
    const int xt = x0 << sh1, yt = y0 << sh1;
    // left[y + 1] = p[-1][y], top[x + 1] = p[x][-1], both [0] the corner
    int left[2 * 64 + 1], top[2 * 64 + 1];
    if (pp.constrained_intra) {
      cip_refs(c, x0, y0, n, left, top);
    } else {
    // L: p[-1][2n-1] .. p[-1][-1], then p[0][-1] .. p[2n-1][-1]
    int L[4 * 64 + 1];
    bool av[4 * 64 + 1];
    int any = 0;
    auto ok = [&](int xs, int ys) {
      return avail(xt, yt, xs << sh1, ys << sh1);
    };
    for (int y = 0; y < 2 * n; y += unit) {
      bool a = ok(x0 - 1, y0 + y);
      for (int k = 0; k < unit; ++k) {
        int i = 2 * n - 1 - (y + k);
        av[i] = a;
        if (a) L[i] = d[size_t(y0 + y + k) * st + size_t(x0 - 1)];
      }
      any |= a;
    }
    {
      bool a = ok(x0 - 1, y0 - 1);
      av[2 * n] = a;
      if (a) L[2 * n] = d[size_t(y0 - 1) * st + size_t(x0 - 1)];
      any |= a;
    }
    for (int x = 0; x < 2 * n; x += unit) {
      bool a = ok(x0 + x, y0 - 1);
      for (int k = 0; k < unit; ++k) {
        int i = 2 * n + 1 + x + k;
        av[i] = a;
        if (a) L[i] = d[size_t(y0 - 1) * st + size_t(x0 + x + k)];
      }
      any |= a;
    }
    const int total = 4 * n + 1;
    if (!any) {
      for (int i = 0; i < total; ++i) L[i] = 1 << (bd - 1);
    } else {
      if (!av[0]) {
        int k = 1;
        while (!av[k]) ++k;
        L[0] = L[k];
      }
      for (int i = 1; i < total; ++i)
        if (!av[i]) L[i] = L[i - 1];
    }
    left[0] = top[0] = L[2 * n];
    for (int y = 0; y < 2 * n; ++y) left[y + 1] = L[2 * n - 1 - y];
    for (int x = 0; x < 2 * n; ++x) top[x + 1] = L[2 * n + 1 + x];
    }
    // filtering (8.4.4.2.3), luma only
    if (c == 0 && mode != 1 && n != 4) {
      int dist = std::min(std::abs(mode - 26), std::abs(mode - 10));
      int thres = n == 8 ? 7 : n == 16 ? 1 : 0;
      if (dist > thres) {
        int fl[2 * 64 + 1], ft[2 * 64 + 1];
        bool strong = sp.strong_intra_smoothing && n == 32 &&
                      std::abs(left[0] + top[2 * n] - 2 * top[n]) < (1 << (bd - 5)) &&
                      std::abs(left[0] + left[2 * n] - 2 * left[n]) < (1 << (bd - 5));
        if (strong) {
          fl[0] = ft[0] = left[0];
          for (int i = 0; i < 63; ++i) {
            fl[i + 1] = ((63 - i) * left[0] + (i + 1) * left[64] + 32) >> 6;
            ft[i + 1] = ((63 - i) * top[0] + (i + 1) * top[64] + 32) >> 6;
          }
          fl[64] = left[64];
          ft[64] = top[64];
        } else {
          fl[0] = ft[0] = (left[1] + 2 * left[0] + top[1] + 2) >> 2;
          for (int i = 1; i < 2 * n; ++i) {
            fl[i] = (left[i + 1] + 2 * left[i] + left[i - 1] + 2) >> 2;
            ft[i] = (top[i + 1] + 2 * top[i] + top[i - 1] + 2) >> 2;
          }
          fl[2 * n] = left[2 * n];
          ft[2 * n] = top[2 * n];
        }
        std::copy(fl, fl + 2 * n + 1, left);
        std::copy(ft, ft + 2 * n + 1, top);
      }
    }
    auto put = [&](int x, int y, int v) { d[size_t(y0 + y) * st + size_t(x0 + x)] = uint16_t(v); };
    if (mode == 0) {                                   // planar
      for (int y = 0; y < n; ++y)
        for (int x = 0; x < n; ++x)
          put(x, y, ((n - 1 - x) * left[y + 1] + (x + 1) * top[n + 1] +
                     (n - 1 - y) * top[x + 1] + (y + 1) * left[n + 1] + n) >> (log2 + 1));
    } else if (mode == 1) {                            // DC
      int s = n;
      for (int i = 1; i <= n; ++i) s += left[i] + top[i];
      int dc = s >> (log2 + 1);
      for (int y = 0; y < n; ++y)
        for (int x = 0; x < n; ++x) put(x, y, dc);
      if (c == 0 && n < 32) {
        put(0, 0, (left[1] + 2 * dc + top[1] + 2) >> 2);
        for (int x = 1; x < n; ++x) put(x, 0, (top[x + 1] + 3 * dc + 2) >> 2);
        for (int y = 1; y < n; ++y) put(0, y, (left[y + 1] + 3 * dc + 2) >> 2);
      }
    } else {
      int angle = kIntraAngle[mode];
      int refbuf[3 * 64 + 1];
      int* ref = refbuf + 64;
      bool vert = mode >= 18;
      const int* main_s = vert ? top : left;    // main_s[k] = p at offset k - 1
      const int* side = vert ? left : top;
      for (int x = 0; x <= n; ++x) ref[x] = main_s[x];
      if (angle < 0) {
        int inv = kInvAngle[mode - 11];
        if (((n * angle) >> 5) < -1)
          for (int x = (n * angle) >> 5; x <= -1; ++x)
            ref[x] = side[((x * inv + 128) >> 8)];
      } else {
        for (int x = n + 1; x <= 2 * n; ++x) ref[x] = main_s[x];
      }
      for (int y = 0; y < n; ++y) {
        int idx = ((y + 1) * angle) >> 5, fact = ((y + 1) * angle) & 31;
        for (int x = 0; x < n; ++x) {
          int v = fact ? ((32 - fact) * ref[x + idx + 1] + fact * ref[x + idx + 2] + 16) >> 5
                       : ref[x + idx + 1];
          if (vert) put(x, y, v);
          else put(y, x, v);
        }
      }
      if (c == 0 && n < 32) {
        if (mode == 26)
          for (int y = 0; y < n; ++y)
            put(0, y, clip3(0, maxv, top[1] + ((left[y + 1] - left[0]) >> 1)));
        if (mode == 10)
          for (int x = 0; x < n; ++x)
            put(x, 0, clip3(0, maxv, left[1] + ((top[x + 1] - top[0]) >> 1)));
      }
    }
  }

  // ------------------------------------------------------ deblocking

  // libavcodec's boundary_strength: 1 when the two blocks' motion differs
  // (other pictures, another count of vectors, a vector apart by a sample
  // or more), else 0.
  static int motion_bs(const MvField& q, const MvField& p) {
    auto far = [](Mv a, Mv b) { return std::abs(a.x - b.x) >= 4 || std::abs(a.y - b.y) >= 4; };
    if (q.pred == 3 && p.pred == 3) {
      if (q.poc[0] == p.poc[0] && q.poc[0] == q.poc[1] && p.poc[0] == p.poc[1])
        return (far(p.mv[0], q.mv[0]) || far(p.mv[1], q.mv[1])) &&
               (far(p.mv[1], q.mv[0]) || far(p.mv[0], q.mv[1]));
      if (p.poc[0] == q.poc[0] && p.poc[1] == q.poc[1])
        return far(p.mv[0], q.mv[0]) || far(p.mv[1], q.mv[1]);
      if (p.poc[1] == q.poc[0] && p.poc[0] == q.poc[1])
        return far(p.mv[1], q.mv[0]) || far(p.mv[0], q.mv[1]);
      return 1;
    }
    if (q.pred != 3 && p.pred != 3) {
      int lq = q.pred & 1 ? 0 : 1, lp = p.pred & 1 ? 0 : 1;
      if (q.poc[lq] != p.poc[lp]) return 1;
      return far(q.mv[lq], p.mv[lp]);
    }
    return 1;
  }

  // The bS of a transform block's (or a CU's without residual) left and
  // top edges on the 8x8 grid, and of the prediction edges inside it
  // (libavcodec's ff_hevc_deblocking_boundary_strengths).
  void boundary_strengths(int x0, int y0, int log2) {
    if (sh.deblocking_disabled) return;
    const int n = 1 << log2;
    auto tu_bs = [&](int xq, int yq, int xp, int yp) {
      const MvField& q = mvf_at(xq, yq);
      const MvField& p = mvf_at(xp, yp);
      if (!q.pred || !p.pred) return 2;
      if (cbf4[at4(xq, yq)] || cbf4[at4(xp, yp)]) return 1;
      return motion_bs(q, p);
    };
    int ctb = ctb_of(x0, y0);
    if (y0 > 0 && (y0 & 7) == 0) {
      bool edge = true;
      if ((y0 & (sp.ctb_size - 1)) == 0 && !sh.lf_across &&
          ctb_slice[size_t(ctb_of(x0, y0 - 1))] != ctb_slice[size_t(ctb)])
        edge = false;
      if (edge)
        for (int i = 0; i < n; i += 4)
          bs_h[at4(x0 + i, y0)] = uint8_t(tu_bs(x0 + i, y0, x0 + i, y0 - 1));
    }
    if (x0 > 0 && (x0 & 7) == 0) {
      bool edge = true;
      if ((x0 & (sp.ctb_size - 1)) == 0 && !sh.lf_across &&
          ctb_slice[size_t(ctb_of(x0 - 1, y0))] != ctb_slice[size_t(ctb)])
        edge = false;
      if (edge)
        for (int i = 0; i < n; i += 4)
          bs_v[at4(x0, y0 + i)] = uint8_t(tu_bs(x0, y0 + i, x0 - 1, y0 + i));
    }
    if (log2 > 2 && !cu_intra) {
      for (int j = 8; j < n; j += 8)
        for (int i = 0; i < n; i += 4) {
          bs_h[at4(x0 + i, y0 + j)] =
              uint8_t(motion_bs(mvf_at(x0 + i, y0 + j), mvf_at(x0 + i, y0 + j - 1)));
          bs_v[at4(x0 + j, y0 + i)] =
              uint8_t(motion_bs(mvf_at(x0 + j, y0 + i), mvf_at(x0 + j - 1, y0 + i)));
        }
    }
  }

  int qp_at(int x, int y) const { return qp4[at4(x, y)]; }

  // 8.7.2: every vertical edge of the picture, then every horizontal one.
  void deblock() {
    for (int dir = 0; dir < 2; ++dir) {
      // luma
      uint16_t* s = cur->pl[0].data();
      const int st = cur->stride[0];
      for (int y = dir ? 8 : 0; y < H; y += dir ? 8 : 4)
        for (int x = dir ? 0 : 8; x < W; x += dir ? 4 : 8) {
          int bs = (dir ? bs_h : bs_v)[at4(x, y)];
          if (!bs) continue;
          int xp = dir ? x : x - 1, yp = dir ? y - 1 : y;
          const SliceParams& sp_q = slices[size_t(ctb_slice[size_t(ctb_of(x, y))])];
          int qp = (qp_at(xp, yp) + qp_at(x, y) + 1) >> 1;
          int beta = kBeta[clip3(0, 51, qp + 2 * sp_q.beta_offset)] * (1 << (bd - 8));
          int tc = kTc[clip3(0, 53, qp + 2 * (bs - 1) + 2 * sp_q.tc_offset)] * (1 << (bd - 8));
          bool no_p = bypass4[at4(xp, yp)], no_q = bypass4[at4(x, y)];
          // sample k of line j: q side k >= 0, p side -k - 1
          const ptrdiff_t along = dir ? 1 : st, across = dir ? st : 1;
          uint16_t* o = s + size_t(y) * st + size_t(x);
          auto P = [&](int j, int k) -> uint16_t& { return o[j * along - (k + 1) * across]; };
          auto Q = [&](int j, int k) -> uint16_t& { return o[j * along + k * across]; };
          int dp0 = std::abs(P(0, 2) - 2 * P(0, 1) + P(0, 0));
          int dq0 = std::abs(Q(0, 2) - 2 * Q(0, 1) + Q(0, 0));
          int dp3 = std::abs(P(3, 2) - 2 * P(3, 1) + P(3, 0));
          int dq3 = std::abs(Q(3, 2) - 2 * Q(3, 1) + Q(3, 0));
          int d0 = dp0 + dq0, d3 = dp3 + dq3;
          if (d0 + d3 >= beta) continue;
          int tc25 = (tc * 5 + 1) >> 1;
          bool strong =
              std::abs(P(0, 3) - P(0, 0)) + std::abs(Q(0, 3) - Q(0, 0)) < (beta >> 3) &&
              std::abs(P(0, 0) - Q(0, 0)) < tc25 &&
              std::abs(P(3, 3) - P(3, 0)) + std::abs(Q(3, 3) - Q(3, 0)) < (beta >> 3) &&
              std::abs(P(3, 0) - Q(3, 0)) < tc25 && (d0 << 1) < (beta >> 2) &&
              (d3 << 1) < (beta >> 2);
          if (strong) {
            int tc2 = tc << 1;
            // each sample moved towards its filtered value by 2·tC at most
            auto to = [&](int v, int f) { return uint16_t(v + clip3(-tc2, tc2, f - v)); };
            for (int j = 0; j < 4; ++j) {
              int p0 = P(j, 0), p1 = P(j, 1), p2 = P(j, 2), p3 = P(j, 3);
              int q0 = Q(j, 0), q1 = Q(j, 1), q2 = Q(j, 2), q3 = Q(j, 3);
              if (!no_p) {
                P(j, 0) = to(p0, (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3);
                P(j, 1) = to(p1, (p2 + p1 + p0 + q0 + 2) >> 2);
                P(j, 2) = to(p2, (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3);
              }
              if (!no_q) {
                Q(j, 0) = to(q0, (p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3);
                Q(j, 1) = to(q1, (p0 + q0 + q1 + q2 + 2) >> 2);
                Q(j, 2) = to(q2, (p0 + q0 + q1 + 3 * q2 + 2 * q3 + 4) >> 3);
              }
            }
          } else {
            int side = (beta + (beta >> 1)) >> 3;
            bool ep = dp0 + dp3 < side, eq = dq0 + dq3 < side;
            int tc_2 = tc >> 1;
            for (int j = 0; j < 4; ++j) {
              int p0 = P(j, 0), p1 = P(j, 1), p2 = P(j, 2);
              int q0 = Q(j, 0), q1 = Q(j, 1), q2 = Q(j, 2);
              int delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4;
              if (std::abs(delta) >= tc * 10) continue;
              delta = clip3(-tc, tc, delta);
              if (!no_p) P(j, 0) = uint16_t(clip3(0, maxv, p0 + delta));
              if (!no_q) Q(j, 0) = uint16_t(clip3(0, maxv, q0 - delta));
              if (!no_p && ep) {
                int d = clip3(-tc_2, tc_2, (((p2 + p0 + 1) >> 1) - p1 + delta) >> 1);
                P(j, 1) = uint16_t(clip3(0, maxv, p1 + d));
              }
              if (!no_q && eq) {
                int d = clip3(-tc_2, tc_2, (((q2 + q0 + 1) >> 1) - q1 - delta) >> 1);
                Q(j, 1) = uint16_t(clip3(0, maxv, q1 + d));
              }
            }
          }
        }
      // chroma: edges of bS 2 on the 8x8 chroma grid, 4 chroma lines a
      // luma bS
      for (int c = 1; c < 3; ++c) {
        uint16_t* cs = cur->pl[c].data();
        const int cst = cur->stride[c];
        int offc = c == 1 ? pp.cb_qp_offset : pp.cr_qp_offset;
        for (int y = dir ? 16 : 0; y < H; y += dir ? 16 : 8)
          for (int x = dir ? 0 : 16; x < W; x += dir ? 8 : 16) {
            int bs = (dir ? bs_h : bs_v)[at4(x, y)];
            if (bs != 2) continue;
            int xp = dir ? x : x - 1, yp = dir ? y - 1 : y;
            const SliceParams& sp_q = slices[size_t(ctb_slice[size_t(ctb_of(x, y))])];
            int qpi = ((qp_at(xp, yp) + qp_at(x, y) + 1) >> 1) + offc;
            int qpc = chroma_qp(clip3(0, 57, qpi));
            int tc = kTc[clip3(0, 53, qpc + 2 + 2 * sp_q.tc_offset)] * (1 << (bd - 8));
            if (tc <= 0) continue;
            bool no_p = bypass4[at4(xp, yp)], no_q = bypass4[at4(x, y)];
            const ptrdiff_t along = dir ? 1 : cst, across = dir ? cst : 1;
            uint16_t* o = cs + size_t(y >> 1) * cst + size_t(x >> 1);
            for (int j = 0; j < 4; ++j) {
              uint16_t* l = o + j * along;
              int p1 = l[-2 * across], p0 = l[-across], q0 = l[0], q1 = l[across];
              int delta = clip3(-tc, tc, ((((q0 - p0) * 4) + p1 - q1 + 4) >> 3));
              if (!no_p) l[-across] = uint16_t(clip3(0, maxv, p0 + delta));
              if (!no_q) l[0] = uint16_t(clip3(0, maxv, q0 - delta));
            }
          }
      }
    }
  }

  // ------------------------------------------------------------ SAO

  // 8.7.3 on the deblocked picture, CTB by CTB.
  void apply_sao() {
    std::vector<uint16_t> src[3];
    for (int c = 0; c < 3; ++c) src[c] = cur->pl[c];
    static const int kPos[4][2][2] = {{{-1, 0}, {1, 0}}, {{0, -1}, {0, 1}},
                                      {{-1, -1}, {1, 1}}, {{1, -1}, {-1, 1}}};
    static const int kEdgeIdx[5] = {1, 2, 0, 3, 4};
    for (int cy = 0; cy < sp.ctb_h; ++cy)
      for (int cx = 0; cx < sp.ctb_w; ++cx) {
        int ctb = cy * sp.ctb_w + cx;
        int si = ctb_slice[size_t(ctb)];
        if (si < 0) continue;
        const SaoParams& s = sao[size_t(ctb)];
        bool lf = slices[size_t(si)].lf_across;
        for (int c = 0; c < 3; ++c) {
          if (!s.type[c]) continue;
          int shc = c ? 1 : 0;
          int cw = W >> shc, chh = H >> shc;
          int size = sp.ctb_size >> shc;
          int x0 = cx * size, y0 = cy * size;
          int x1 = std::min(x0 + size, cw), y1 = std::min(y0 + size, chh);
          const uint16_t* in = src[c].data();
          uint16_t* out = cur->pl[c].data();
          int st = cur->stride[c];
          if (s.type[c] == 1) {
            int table[32] = {};
            for (int k = 0; k < 4; ++k) table[(k + s.band[c]) & 31] = s.off[c][k + 1];
            for (int y = y0; y < y1; ++y)
              for (int x = x0; x < x1; ++x) {
                if (bypass4[at4(x << shc, y << shc)]) continue;
                int v = in[size_t(y) * st + x];
                out[size_t(y) * st + x] = uint16_t(clip3(0, maxv, v + table[v >> (bd - 5)]));
              }
            continue;
          }
          const int(*pos)[2] = kPos[s.eo[c]];
          auto sgn = [](int d) { return d > 0 ? 1 : d < 0 ? -1 : 0; };
          // Inside the picture, away from other slices' CTBs and without
          // bypass samples: no sample of the CTB is left out.
          bool plain = !pp.transquant_bypass && cx > 0 && cy > 0 &&
                       x1 < cw && y1 < chh;
          for (int dy = -1; dy <= 1 && plain && !lf; ++dy)
            for (int dx = -1; dx <= 1; ++dx)
              plain = plain && ctb_slice[size_t(ctb + dy * sp.ctb_w + dx)] == si;
          if (plain) {
            const ptrdiff_t a_off = pos[0][1] * st + pos[0][0];
            const ptrdiff_t b_off = pos[1][1] * st + pos[1][0];
            for (int y = y0; y < y1; ++y) {
              const uint16_t* row = in + size_t(y) * st;
              uint16_t* o = out + size_t(y) * st;
              for (int x = x0; x < x1; ++x) {
                int v = row[x];
                int e = kEdgeIdx[2 + sgn(v - row[x + a_off]) + sgn(v - row[x + b_off])];
                o[x] = uint16_t(clip3(0, maxv, v + s.off[c][e]));
              }
            }
            continue;
          }
          for (int y = y0; y < y1; ++y)
            for (int x = x0; x < x1; ++x) {
              if (bypass4[at4(x << shc, y << shc)]) continue;
              bool skip = false;
              for (int k = 0; k < 2 && !skip; ++k) {
                int xn = x + pos[k][0], yn = y + pos[k][1];
                if (xn < 0 || yn < 0 || xn >= cw || yn >= chh) {
                  skip = true;
                } else if (!lf && ctb_slice[size_t(ctb_of(xn << shc, yn << shc))] != si) {
                  skip = true;
                }
              }
              if (skip) continue;
              int v = in[size_t(y) * st + x];
              int a = in[size_t(y + pos[0][1]) * st + size_t(x + pos[0][0])];
              int b = in[size_t(y + pos[1][1]) * st + size_t(x + pos[1][0])];
              int e = kEdgeIdx[2 + sgn(v - a) + sgn(v - b)];
              out[size_t(y) * st + x] = uint16_t(clip3(0, maxv, v + s.off[c][e]));
            }
        }
      }
  }

  // ------------------------------------------------------------ output

  void to_picture(const Frame& f, Picture& out) const {
    out = Picture();
    out.w = f.out_w;
    out.h = f.out_h;
    out.xshift = out.yshift = 1;
    out.depth = f.depth;
    out.full_range = f.full_range;
    out.matrix = f.matrix;
    out.chroma_loc = f.chroma_loc;
    out.source = f.source;
    out.ystride = f.out_w;
    out.cstride = (f.out_w + 1) >> 1;
    if (f.pl[0].empty()) return;
    int ch = (f.out_h + 1) >> 1;
    auto copy = [&](int c, int w, int h, int x0, int y0, auto& dst) {
      dst.resize(size_t(w) * h);
      for (int y = 0; y < h; ++y)
        for (int x = 0; x < w; ++x)
          dst[size_t(y) * w + x] = typename std::decay_t<decltype(dst)>::value_type(
              f.pl[c][size_t(y0 + y) * f.stride[c] + size_t(x0 + x)]);
    };
    if (f.depth > 8) {
      copy(0, f.out_w, f.out_h, f.crop_l, f.crop_t, out.y16);
      copy(1, out.cstride, ch, f.crop_l >> 1, f.crop_t >> 1, out.u16);
      copy(2, out.cstride, ch, f.crop_l >> 1, f.crop_t >> 1, out.v16);
    } else {
      copy(0, f.out_w, f.out_h, f.crop_l, f.crop_t, out.y);
      copy(1, out.cstride, ch, f.crop_l >> 1, f.crop_t >> 1, out.u);
      copy(2, out.cstride, ch, f.crop_l >> 1, f.crop_t >> 1, out.v);
    }
  }

  void deliver() {
    while (!ready.empty()) {
      Picture p;
      to_picture(*ready.front(), p);
      outq.push_back(std::move(p));
      ready.pop_front();
    }
  }

  bool pop(Picture& out) {
    if (outq.empty()) return false;
    out = std::move(outq.front());
    outq.pop_front();
    return true;
  }
};

HevcDecoder::HevcDecoder(const std::vector<uint8_t>& config) : s_(new State()) {
  s_->read_config(config);
}

HevcDecoder::~HevcDecoder() = default;

bool HevcDecoder::decode(const uint8_t* data, size_t n, Picture& out) {
  State& s = *s_;
  s.outq.clear();
  ++s.calls;
  s.decode_packet(data, n);
  s.finish_picture();
  s.deliver();
  return s.pop(out);
}

bool HevcDecoder::next(Picture& out) { return s_->pop(out); }

bool HevcDecoder::flush(Picture& out) {
  State& s = *s_;
  if (s.outq.empty()) {
    s.finish_picture();
    s.bump(0, 0);
    s.deliver();
  }
  return s.pop(out);
}

void HevcDecoder::headers(const uint8_t* data, size_t n) {
  State& s = *s_;
  s.for_each_nal(data, n, [&](const uint8_t* p, size_t len) { s.nal(p, len, true); });
}

void HevcDecoder::headers_only() { s_->headers_only = true; }

int HevcDecoder::peek(const uint8_t* data, size_t n) const {
  int kind = -1;
  s_->for_each_nal(data, n, [&](const uint8_t* p, size_t len) {
    if (kind >= 0 || len < 3) return;
    int t = (p[0] >> 1) & 63;
    if ((t <= 9 || (t >= 16 && t <= 21)) && (p[2] & 0x80)) kind = t;
  });
  return kind;
}

bool HevcDecoder::frame_rate(int64_t& num, int64_t& den) const {
  const State& s = *s_;
  const Sps* sps = s.in_picture || s.sp.w ? &s.sp : nullptr;
  if (!sps && s.first_sps >= 0) sps = s.spss[s.first_sps].get();
  if (!sps || !sps->time_scale) return false;
  num = sps->time_scale;
  den = sps->num_units_in_tick;
  return true;
}

bool HevcDecoder::picture_size(int& w, int& h) const {
  const State& s = *s_;
  const Sps* sps = s.in_picture || s.sp.w ? &s.sp : nullptr;
  if (!sps && s.first_sps >= 0) sps = s.spss[s.first_sps].get();
  if (!sps) return false;
  w = sps->w - sps->crop_l - sps->crop_r;
  h = sps->h - sps->crop_t - sps->crop_b;
  return true;
}

}  // namespace viai_video
