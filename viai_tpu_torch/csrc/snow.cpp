// Snow of viai_tpu_torch: libavcodec's snow decoder (snowdec.c, snow.c,
// snow.h, snow_dwt.c) for what its encoder and OpenCV's writer store
// under SNOW.
//
//   * the range coder of FFV1 (rangecoder.h) over the whole packet;
//   * the header: the keyframe bit, then on a keyframe the version, the
//     decomposition count, the colour space (0 YUV with its chroma
//     shifts: 4:2:0, 4:4:4 or 4:1:0; 1 grey), max_ref_frames and every
//     band's qlog; on other frames the half-pel filter's taps (diag_mc,
//     htaps, hcoeff) and a new decomposition count when sent; then the
//     deltas of the wavelet (9/7 or 5/3), qlog, mv_scale, qbias and
//     block_max_depth;
//   * the block tree (decode_q_branch): split flags, intra blocks with
//     their colours, reference indices and median-predicted vectors;
//   * the subbands (unpack_coeffs: zero runs, the left, top, top-right
//     and parent contexts), dequantised by qlog and qbias; the LL band
//     predicted from its left, top and top-left (correlate);
//   * snow_dwt.c's integer inverse 9/7 and 5/3 wavelets (the buffered
//     composition gives the same samples as a whole-plane one, which the
//     encoder's reconstruction runs);
//   * a keyframe is the wavelet's output plus 128; other frames add
//     it to the OBMC of the four blocks around each block-sized square
//     (ff_obmc_tab), each predicted from one of up to max_ref_frames
//     references by mc_block's half-pel filter and bilinear
//     interpolation, or H.264's quarter-pel filter where libavcodec
//     uses it (the default taps at quarter-pel positions), or filled
//     with its colour.
//
// The picture is yuv420p, yuv444p, yuv410p or gray as libavcodec gives
// it (BT.601, limited range). What libavcodec refuses raises ValueError.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <string>
#include <vector>

#include "lossless.h"
#include "rangecoder.h"
#include "snow_tables.h"
#include "video.h"

namespace viai_video {

namespace {

constexpr int kMaxDecompositions = 8;
constexpr int kMaxPlanes = 4;
constexpr int kMaxRefFrames = 8;
constexpr int kQShift = 5;
constexpr int kQRoot = 1 << kQShift;
constexpr int kLosslessQlog = -128;
constexpr int kFracBits = 4;
constexpr int kQExpShift = 7 - kFracBits + 8;
constexpr int kQBiasShift = 3;
constexpr int kMbSize = 16;
constexpr int kHtapsMax = 8;
constexpr int kBlockIntra = 1;
constexpr int kDwt97 = 0, kDwt53 = 1;

int av_log2(unsigned v) {
  int n = 0;
  while (v >>= 1) ++n;
  return n;
}

int avpriv_mirror(int x, int w) {
  if (!w) return 0;
  while (unsigned(x) > unsigned(w)) {
    x = -x;
    if (x < 0) x += 2 * w;
  }
  return x;
}

uint8_t clip_u8(int v) { return uint8_t(v & ~255 ? ~(v >> 31) : v); }

struct BlockNode {
  int16_t mx = 0, my = 0;
  uint8_t ref = 0;
  uint8_t color[3] = {128, 128, 128};
  uint8_t type = 0;
  uint8_t level = 0;
};

const BlockNode kNullBlock{};

struct XCoeff {
  int16_t x;
  uint16_t coeff;
};

struct SubBand {
  int level = 0, width = 0, height = 0, qlog = 0;
  int stride_line = 0, buf_x = 0, buf_y = 0;
  SubBand* parent = nullptr;
  std::vector<XCoeff> xc;
  uint8_t state[7 + 512][32];
};

// A plane's half-pel filter starts all zero (libavcodec's decoder sets it
// only from an inter frame's header; its encoder sends it in the first
// inter frame after each keyframe) and is kept across keyframes.
struct SnowPlane {
  int width = 0, height = 0;
  SubBand band[kMaxDecompositions][4];
  int htaps = 0;
  int8_t hcoeff[kHtapsMax / 2] = {0, 0, 0, 0};
  int diag_mc = 0;
  int fast_mc = 0;
};

struct Frame {
  bool key = false;
  int w[3] = {}, h[3] = {};
  std::vector<uint8_t> p[3];
};

// get_symbol2 (snow.h)
int get_symbol2(RangeCoder& c, uint8_t* state, int log2) {
  int r = log2 >= 0 ? 1 << log2 : 1;
  int v = 0;
  while (log2 < 28 && c.bit(state[4 + log2])) {
    v += r;
    ++log2;
    if (log2 > 0) r += r;
  }
  for (int i = log2 - 1; i >= 0; --i) v += c.bit(state[31 - i]) << i;
  return v;
}

// ---- snow_dwt.c: the inverse wavelets, in place over lines of a plane

void horizontal_compose53i(int16_t* b, int16_t* temp, int width) {
  const int width2 = width >> 1, w2 = (width + 1) >> 1;
  int x;
  for (x = 0; x < width2; ++x) {
    temp[2 * x] = b[x];
    temp[2 * x + 1] = b[x + w2];
  }
  if (width & 1) temp[2 * x] = b[x];
  b[0] = int16_t(temp[0] - ((temp[1] + 1) >> 1));
  for (x = 2; x < width - 1; x += 2) {
    b[x] = int16_t(temp[x] - ((temp[x - 1] + temp[x + 1] + 2) >> 2));
    b[x - 1] = int16_t(temp[x - 1] + ((b[x - 2] + b[x] + 1) >> 1));
  }
  if (width & 1) {
    b[x] = int16_t(temp[x] - ((temp[x - 1] + 1) >> 1));
    b[x - 1] = int16_t(temp[x - 1] + ((b[x - 2] + b[x] + 1) >> 1));
  } else {
    b[x - 1] = int16_t(temp[x - 1] + b[x - 2]);
  }
}

void horizontal_compose97i(int16_t* b, int16_t* temp, int width) {
  const int w2 = (width + 1) >> 1;
  int x;
  temp[0] = int16_t(b[0] - ((3 * b[w2] + 2) >> 2));
  for (x = 1; x < (width >> 1); ++x) {
    temp[2 * x] = int16_t(b[x] - ((3 * (b[x + w2 - 1] + b[x + w2]) + 4) >> 3));
    temp[2 * x - 1] = int16_t(b[x + w2 - 1] - temp[2 * x - 2] - temp[2 * x]);
  }
  if (width & 1) {
    temp[2 * x] = int16_t(b[x] - ((3 * b[x + w2 - 1] + 2) >> 2));
    temp[2 * x - 1] = int16_t(b[x + w2 - 1] - temp[2 * x - 2] - temp[2 * x]);
  } else {
    temp[2 * x - 1] = int16_t(b[x + w2 - 1] - 2 * temp[2 * x - 2]);
  }
  b[0] = int16_t(temp[0] + ((2 * temp[0] + temp[1] + 4) >> 3));
  for (x = 2; x < width - 1; x += 2) {
    b[x] = int16_t(temp[x] +
                   ((4 * temp[x] + temp[x - 1] + temp[x + 1] + 8) >> 4));
    b[x - 1] = int16_t(temp[x - 1] + ((3 * (b[x - 2] + b[x])) >> 1));
  }
  if (width & 1) {
    b[x] = int16_t(temp[x] + ((2 * temp[x] + temp[x - 1] + 4) >> 3));
    b[x - 1] = int16_t(temp[x - 1] + ((3 * (b[x - 2] + b[x])) >> 1));
  } else {
    b[x - 1] = int16_t(temp[x - 1] + 3 * b[x - 2]);
  }
}

// spatial_compose53i / spatial_compose97i over one level: `height` lines
// of `width` samples at `stride` samples apart.
void compose53(int16_t* buf, int16_t* temp, int width, int height,
               ptrdiff_t stride) {
  auto row = [&](int y) { return buf + avpriv_mirror(y, height - 1) * stride; };
  int16_t* b0 = row(-2);
  int16_t* b1 = row(-1);
  for (int y = -1; y <= height; y += 2) {
    int16_t* b2 = row(y + 1);
    int16_t* b3 = row(y + 2);
    if (unsigned(y + 1) < unsigned(height))
      for (int i = 0; i < width; ++i)
        b2[i] = int16_t(b2[i] - ((b1[i] + b3[i] + 2) >> 2));
    if (unsigned(y) < unsigned(height))
      for (int i = 0; i < width; ++i)
        b1[i] = int16_t(b1[i] + ((b0[i] + b2[i]) >> 1));
    if (unsigned(y - 1) < unsigned(height))
      horizontal_compose53i(b0, temp, width);
    if (unsigned(y) < unsigned(height)) horizontal_compose53i(b1, temp, width);
    b0 = b2;
    b1 = b3;
  }
}

void compose97(int16_t* buf, int16_t* temp, int width, int height,
               ptrdiff_t stride) {
  auto row = [&](int y) { return buf + avpriv_mirror(y, height - 1) * stride; };
  int16_t* b0 = row(-4);
  int16_t* b1 = row(-3);
  int16_t* b2 = row(-2);
  int16_t* b3 = row(-1);
  for (int y = -3; y <= height; y += 2) {
    int16_t* b4 = row(y + 3);
    int16_t* b5 = row(y + 4);
    if (unsigned(y + 3) < unsigned(height))        // L1
      for (int i = 0; i < width; ++i)
        b4[i] = int16_t(b4[i] - ((3 * (b3[i] + b5[i]) + 4) >> 3));
    if (unsigned(y + 2) < unsigned(height))        // H1
      for (int i = 0; i < width; ++i)
        b3[i] = int16_t(b3[i] - (b2[i] + b4[i]));
    if (unsigned(y + 1) < unsigned(height))        // L0
      for (int i = 0; i < width; ++i)
        b2[i] = int16_t(b2[i] + ((b1[i] + b3[i] + 4 * b2[i] + 8) >> 4));
    if (unsigned(y) < unsigned(height))            // H0
      for (int i = 0; i < width; ++i)
        b1[i] = int16_t(b1[i] + ((3 * (b0[i] + b2[i])) >> 1));
    if (unsigned(y - 1) < unsigned(height))
      horizontal_compose97i(b0, temp, width);
    if (unsigned(y) < unsigned(height)) horizontal_compose97i(b1, temp, width);
    b0 = b2;
    b1 = b3;
    b2 = b4;
    b3 = b5;
  }
}

// ---- motion compensation

// H.264's quarter-pel luma interpolation (h264qpel_template.c) of a
// (bw, bh) block at `src` (rows `stride` apart, 2 before and 3 after
// readable) at quarter-pel (qx, qy).
void h264_qpel(uint8_t* dst, int ds, const uint8_t* src, int stride, int bw,
               int bh, int qx, int qy) {
  auto tap = [](int a, int b, int c, int d, int e, int f) {
    return a - 5 * b + 20 * c + 20 * d - 5 * e + f;
  };
  auto H = [&](int x, int y) {               // half-pel right of (x, y)
    const uint8_t* s = src + y * stride + x;
    return int(clip_u8((tap(s[-2], s[-1], s[0], s[1], s[2], s[3]) + 16) >> 5));
  };
  auto V = [&](int x, int y) {               // half-pel below (x, y)
    const uint8_t* s = src + y * stride + x;
    return int(clip_u8((tap(s[-2 * stride], s[-stride], s[0], s[stride],
                            s[2 * stride], s[3 * stride]) + 16) >> 5));
  };
  auto HV = [&](int x, int y) {
    int t[6];
    for (int k = 0; k < 6; ++k) {
      const uint8_t* s = src + (y + k - 2) * stride + x;
      t[k] = tap(s[-2], s[-1], s[0], s[1], s[2], s[3]);
    }
    return int(clip_u8((tap(t[0], t[1], t[2], t[3], t[4], t[5]) + 512) >> 10));
  };
  auto F = [&](int x, int y) { return int(src[y * stride + x]); };
  auto l2 = [](int a, int b) { return (a + b + 1) >> 1; };
  for (int y = 0; y < bh; ++y)
    for (int x = 0; x < bw; ++x) {
      int v;
      switch (qx + 4 * qy) {
        case 0: v = F(x, y); break;
        case 1: v = l2(F(x, y), H(x, y)); break;
        case 2: v = H(x, y); break;
        case 3: v = l2(F(x + 1, y), H(x, y)); break;
        case 4: v = l2(F(x, y), V(x, y)); break;
        case 8: v = V(x, y); break;
        case 12: v = l2(F(x, y + 1), V(x, y)); break;
        case 5: v = l2(H(x, y), V(x, y)); break;
        case 7: v = l2(H(x, y), V(x + 1, y)); break;
        case 13: v = l2(H(x, y + 1), V(x, y)); break;
        case 15: v = l2(H(x, y + 1), V(x + 1, y)); break;
        case 10: v = HV(x, y); break;
        case 6: v = l2(H(x, y), HV(x, y)); break;
        case 14: v = l2(H(x, y + 1), HV(x, y)); break;
        case 9: v = l2(V(x, y), HV(x, y)); break;
        default: v = l2(V(x + 1, y), HV(x, y)); break;   // 11
      }
      dst[y * ds + x] = uint8_t(v);
    }
}

// snow.c's mc_block: `src` at the block's integer position less 3 in
// both directions ((b_w + 7) x (b_h + 7) readable, rows `stride` apart),
// (dx, dy) in 1/16 pel.
void mc_block(const SnowPlane* p, uint8_t* dst, int ds, const uint8_t* src,
              int stride, int b_w, int b_h, int dx, int dy) {
  int16_t tmpIt[64 * (32 + kHtapsMax)];
  uint8_t tmp2t[3][64 * (32 + kHtapsMax)];
  const uint8_t* hpel[11];
  const int r = snow::kMcBrane[dx + 16 * dy] & 15;
  const int l = snow::kMcBrane[dx + 16 * dy] >> 4;
  int b = snow::kMcNeeds[l] | snow::kMcNeeds[r];
  if (p && !p->diag_mc) b = 15;
  const bool fast = !p || p->fast_mc;
  auto hc = [&](int i) { return int(p->hcoeff[i]); };
  if (b & 5) {
    int16_t* tmpI = tmpIt;
    uint8_t* tmp2 = tmp2t[0];
    const uint8_t* s = src;
    for (int y = 0; y < b_h + kHtapsMax - 1; ++y) {
      for (int x = 0; x < b_w; ++x) {
        const int a_1 = s[x], a0 = s[x + 1], a1 = s[x + 2], a2 = s[x + 3],
                  a3 = s[x + 4], a4 = s[x + 5], a5 = s[x + 6], a6 = s[x + 7];
        int am;
        if (fast) {
          am = 20 * (a2 + a3) - 5 * (a1 + a4) + (a0 + a5);
          tmpI[x] = int16_t(am);
          am = (am + 16) >> 5;
        } else {
          am = hc(0) * (a2 + a3) + hc(1) * (a1 + a4) + hc(2) * (a0 + a5) +
               hc(3) * (a_1 + a6);
          tmpI[x] = int16_t(am);
          am = (am + 32) >> 6;
        }
        tmp2[x] = clip_u8(am);
      }
      tmpI += 64;
      tmp2 += 64;
      s += stride;
    }
  }
  const uint8_t* s = src + kHtapsMax / 2 - 1;
  if (b & 2) {
    uint8_t* tmp2 = tmp2t[1];
    const uint8_t* q = s;
    for (int y = 0; y < b_h; ++y) {
      for (int x = 0; x < b_w + 1; ++x) {
        auto at = [&](int k) { return int(q[x + k * stride]); };
        int am;
        if (fast)
          am = (20 * (at(3) + at(4)) - 5 * (at(2) + at(5)) + (at(1) + at(6)) +
                16) >> 5;
        else
          am = (hc(0) * (at(3) + at(4)) + hc(1) * (at(2) + at(5)) +
                hc(2) * (at(1) + at(6)) + hc(3) * (at(0) + at(7)) + 32) >> 6;
        tmp2[x] = clip_u8(am);
      }
      q += stride;
      tmp2 += 64;
    }
  }
  s += stride * (kHtapsMax / 2 - 1);
  if (b & 4) {
    uint8_t* tmp2 = tmp2t[2];
    const int16_t* tmpI = tmpIt;
    for (int y = 0; y < b_h; ++y) {
      for (int x = 0; x < b_w; ++x) {
        auto at = [&](int k) { return int(tmpI[x + k * 64]); };
        int am;
        if (fast)
          am = (20 * (at(3) + at(4)) - 5 * (at(2) + at(5)) + (at(1) + at(6)) +
                512) >> 10;
        else
          am = (hc(0) * (at(3) + at(4)) + hc(1) * (at(2) + at(5)) +
                hc(2) * (at(1) + at(6)) + hc(3) * (at(0) + at(7)) + 2048) >> 12;
        tmp2[x] = clip_u8(am);
      }
      tmpI += 64;
      tmp2 += 64;
    }
  }
  hpel[0] = s;
  hpel[1] = tmp2t[0] + 64 * (kHtapsMax / 2 - 1);
  hpel[2] = s + 1;
  hpel[3] = nullptr;
  hpel[4] = tmp2t[1];
  hpel[5] = tmp2t[2];
  hpel[6] = tmp2t[1] + 1;
  hpel[7] = nullptr;
  hpel[8] = s + stride;
  hpel[9] = hpel[1] + 64;
  hpel[10] = hpel[8] + 1;
  auto mc_stride = [&](int i) { return snow::kMcNeeds[i] ? 64 : stride; };
  if (b == 15) {
    const int dxy = dx / 8 + dy / 8 * 4;
    const uint8_t* s1 = hpel[dxy];
    const uint8_t* s2 = hpel[dxy + 1];
    const uint8_t* s3 = hpel[dxy + 4];
    const uint8_t* s4 = hpel[dxy + 5];
    const int st1 = mc_stride(dxy), st2 = mc_stride(dxy + 1),
              st3 = mc_stride(dxy + 4), st4 = mc_stride(dxy + 5);
    const int fx = dx & 7, fy = dy & 7;
    for (int y = 0; y < b_h; ++y) {
      for (int x = 0; x < b_w; ++x)
        dst[x] = uint8_t(((8 - fx) * (8 - fy) * s1[x] + fx * (8 - fy) * s2[x] +
                          (8 - fx) * fy * s3[x] + fx * fy * s4[x] + 32) >> 6);
      s1 += st1;
      s2 += st2;
      s3 += st3;
      s4 += st4;
      dst += ds;
    }
  } else {
    const uint8_t* s1 = hpel[l];
    const uint8_t* s2 = hpel[r];
    const int st1 = mc_stride(l), st2 = mc_stride(r);
    const int a = snow::kMcWeight[(dx & 7) + 8 * (dy & 7)], bb = 8 - a;
    for (int y = 0; y < b_h; ++y) {
      for (int x = 0; x < b_w; ++x)
        dst[x] = uint8_t((a * s1[x] + bb * s2[x] + 4) >> 3);
      s1 += st1;
      s2 += st2;
      dst += ds;
    }
  }
}

}  // namespace

struct SnowDecoder::State {
  int w = 0, h = 0;
  uint8_t header_state[32];
  uint8_t block_state[128 + 32 * 128];
  bool keyframe = false;
  int always_reduce = 0;
  int spatial_decomposition_type = 0, spatial_decomposition_count = 0;
  int colorspace_type = 0, chroma_h_shift = 0, chroma_v_shift = 0;
  int nb_planes = 0;
  int max_ref_frames = 1, ref_frames = 0;
  int qlog = 0, mv_scale = 0, qbias = 0, block_max_depth = 0;
  bool configured = false;               // a keyframe's header was read
  SnowPlane plane[kMaxPlanes];
  int b_width = 0, b_height = 0;
  std::vector<BlockNode> block;
  std::shared_ptr<Frame> last[kMaxRefFrames];
  std::shared_ptr<Frame> current;
  RangeCoder c;
  int scale_mv_ref[kMaxRefFrames][kMaxRefFrames];

  State() {
    for (int i = 0; i < kMaxRefFrames; ++i)
      for (int j = 0; j < kMaxRefFrames; ++j)
        scale_mv_ref[i][j] = 256 * (i + 1) / (j + 1);
    reset_contexts();
  }
  void reset_contexts() {
    for (auto& p : plane)
      for (auto& lv : p.band)
        for (auto& b : lv) std::memset(b.state, 128, sizeof(b.state));
    std::memset(header_state, 128, sizeof(header_state));
    std::memset(block_state, 128, sizeof(block_state));
  }
  int symbol(uint8_t* st, bool sgn) { return c.symbol(st, sgn); }
  void decode_qlogs();
  void decode_header();
  void init_bands();
  void decode_q_branch(int level, int x, int y);
  void pred_mv(int& mx, int& my, int ref, const BlockNode* left,
               const BlockNode* top, const BlockNode* tr) const;
  void set_blocks(int level, int x, int y, int l, int cb, int cr, int mx,
                  int my, int ref, int type);
  void unpack_coeffs(SubBand& b, SubBand* parent);
  void decode_plane(int pi, Frame& out);
  void pred_block(uint8_t* dst, int ds, int sx, int sy, int b_w, int b_h,
                  const BlockNode& blk, int pi, int w, int h);
  void add_yblock(const int16_t* idwt, uint8_t* dst8, const uint8_t* obmc,
                  int src_x, int src_y, int b_w, int b_h, int w, int h,
                  int obmc_stride, int b_x, int b_y, int pi);
};

SnowDecoder::SnowDecoder(int w, int h) : s_(new State) {
  check_size(w, h, "Snow track's");
  s_->w = w;
  s_->h = h;
}

SnowDecoder::~SnowDecoder() = default;

int SnowDecoder::peek(const uint8_t* data, size_t n) {
  RangeCoder c;
  c.init(data, 0, n);
  c.build_states();
  uint8_t kstate = 128;
  return c.bit(kstate) ? 0 : 1;
}

void SnowDecoder::State::decode_qlogs() {
  for (int pi = 0; pi < nb_planes; ++pi)
    for (int level = 0; level < spatial_decomposition_count; ++level)
      for (int o = level ? 1 : 0; o < 4; ++o) {
        int q;
        if (pi == 2)
          q = plane[1].band[level][o].qlog;
        else if (o == 2)
          q = plane[pi].band[level][1].qlog;
        else
          q = symbol(header_state, true);
        plane[pi].band[level][o].qlog = q;
      }
}

void SnowDecoder::State::decode_header() {
  uint8_t kstate[32];
  std::memset(kstate, 128, sizeof(kstate));
  keyframe = c.bit(kstate[0]);
  if (keyframe || always_reduce) {
    reset_contexts();
    spatial_decomposition_type = qlog = qbias = mv_scale = block_max_depth = 0;
  }
  if (keyframe) {
    const int version = symbol(header_state, false);
    if (version != 0)
      broken("Snow version " + std::to_string(version) +
             ": libavcodec refuses it");
    always_reduce = c.bit(header_state[0]);
    symbol(header_state, false);            // temporal_decomposition_type
    symbol(header_state, false);            // temporal_decomposition_count
    const int count = symbol(header_state, false);
    if (count <= 0 || count > kMaxDecompositions)
      broken("Snow decomposition count out of range");
    spatial_decomposition_count = count;
    colorspace_type = symbol(header_state, false);
    if (colorspace_type == 1) {
      nb_planes = 1;
      chroma_h_shift = chroma_v_shift = 0;
    } else if (colorspace_type == 0) {
      chroma_h_shift = symbol(header_state, false);
      chroma_v_shift = symbol(header_state, false);
      if (!((chroma_h_shift == 1 && chroma_v_shift == 1) ||
            (chroma_h_shift == 0 && chroma_v_shift == 0) ||
            (chroma_h_shift == 2 && chroma_v_shift == 2)))
        broken("Snow chroma subsampling " + std::to_string(chroma_h_shift) +
               "x" + std::to_string(chroma_v_shift) +
               ": libavcodec refuses it");
      nb_planes = 3;
    } else {
      broken("Snow colour space " + std::to_string(colorspace_type) +
             ": libavcodec refuses it");
    }
    c.bit(header_state[0]);                 // spatial_scalability
    const int refs = symbol(header_state, false);
    if (unsigned(refs) >= unsigned(kMaxRefFrames))
      broken("Snow max_ref_frames out of range");
    max_ref_frames = refs + 1;
    decode_qlogs();
    configured = true;
  }
  if (!configured)
    broken("Snow stream does not begin with a keyframe: libavcodec decodes "
           "nothing before one");
  if (!keyframe) {
    if (c.bit(header_state[0])) {
      for (int pi = 0; pi < std::min(nb_planes, 2); ++pi) {
        SnowPlane& p = plane[pi];
        p.diag_mc = c.bit(header_state[0]);
        int htaps = symbol(header_state, false);
        if (unsigned(htaps) >= unsigned(kHtapsMax / 2 - 1))
          broken("Snow half-pel filter taps out of range");
        htaps = htaps * 2 + 2;
        p.htaps = htaps;
        int sum = 0;
        for (int i = htaps / 2; i; --i) {
          const unsigned hcoeff = unsigned(symbol(header_state, false));
          if (hcoeff > 127) broken("Snow half-pel filter tap out of range");
          p.hcoeff[i] = int8_t(int(hcoeff) * (1 - 2 * (i & 1)));
          sum += p.hcoeff[i];
        }
        p.hcoeff[0] = int8_t(32 - sum);
      }
      plane[2].diag_mc = plane[1].diag_mc;
      plane[2].htaps = plane[1].htaps;
      std::memcpy(plane[2].hcoeff, plane[1].hcoeff, sizeof(plane[1].hcoeff));
    }
    if (c.bit(header_state[0])) {
      const int count = symbol(header_state, false);
      if (count <= 0 || count > kMaxDecompositions)
        broken("Snow decomposition count out of range");
      spatial_decomposition_count = count;
      decode_qlogs();
    }
  }
  spatial_decomposition_type += symbol(header_state, true);
  if (unsigned(spatial_decomposition_type) > 1u)
    broken("Snow spatial decomposition type " +
           std::to_string(spatial_decomposition_type) +
           ": libavcodec refuses it");
  if ((std::min(w >> chroma_h_shift, h >> chroma_v_shift) >>
       (spatial_decomposition_count - 1)) <= 1)
    broken("Snow decomposition count too large for the picture size");
  if (w > 65536 - 4) broken("Snow picture too wide");
  qlog += symbol(header_state, true);
  mv_scale += symbol(header_state, true);
  qbias += symbol(header_state, true);
  block_max_depth += symbol(header_state, true);
  if (block_max_depth > 1 || block_max_depth < 0 || unsigned(mv_scale) > 256u) {
    block_max_depth = mv_scale = 0;
    broken("Snow block_max_depth or mv_scale out of range");
  }
  if (std::abs(qbias) > 127) {
    qbias = 0;
    broken("Snow qbias out of range");
  }
}

// ff_snow_common_init_after_header's bands.
void SnowDecoder::State::init_bands() {
  for (int pi = 0; pi < nb_planes; ++pi) {
    int pw = w, ph = h;
    if (pi) {
      pw = (w + (1 << chroma_h_shift) - 1) >> chroma_h_shift;
      ph = (h + (1 << chroma_v_shift) - 1) >> chroma_v_shift;
    }
    plane[pi].width = pw;
    plane[pi].height = ph;
    for (int level = spatial_decomposition_count - 1; level >= 0; --level) {
      for (int o = level ? 1 : 0; o < 4; ++o) {
        SubBand& b = plane[pi].band[level][o];
        b.level = level;
        b.width = (pw + !(o & 1)) >> 1;
        b.height = (ph + !(o > 1)) >> 1;
        b.stride_line = 1 << (spatial_decomposition_count - level);
        b.buf_x = (o & 1) ? (pw + 1) >> 1 : 0;
        b.buf_y = o > 1 ? b.stride_line >> 1 : 0;
        b.parent = level ? &plane[pi].band[level - 1][o] : nullptr;
        b.xc.assign(size_t(b.width + 1) * b.height + 1, {0, 0});
      }
      pw = (pw + 1) >> 1;
      ph = (ph + 1) >> 1;
    }
  }
}

void SnowDecoder::State::pred_mv(int& mx, int& my, int ref,
                                 const BlockNode* left, const BlockNode* top,
                                 const BlockNode* tr) const {
  if (ref_frames == 1) {
    mx = median3(left->mx, top->mx, tr->mx);
    my = median3(left->my, top->my, tr->my);
  } else {
    const int* scale = scale_mv_ref[ref];
    mx = median3((left->mx * scale[left->ref] + 128) >> 8,
                  (top->mx * scale[top->ref] + 128) >> 8,
                  (tr->mx * scale[tr->ref] + 128) >> 8);
    my = median3((left->my * scale[left->ref] + 128) >> 8,
                  (top->my * scale[top->ref] + 128) >> 8,
                  (tr->my * scale[tr->ref] + 128) >> 8);
  }
}

void SnowDecoder::State::set_blocks(int level, int x, int y, int l, int cb,
                                    int cr, int mx, int my, int ref,
                                    int type) {
  const int bw = b_width << block_max_depth;
  const int rem = block_max_depth - level;
  const int index = (x + y * bw) << rem;
  BlockNode blk;
  blk.color[0] = uint8_t(l);
  blk.color[1] = uint8_t(cb);
  blk.color[2] = uint8_t(cr);
  blk.mx = int16_t(mx);
  blk.my = int16_t(my);
  blk.ref = uint8_t(ref);
  blk.type = uint8_t(type);
  blk.level = uint8_t(level);
  for (int j = 0; j < (1 << rem); ++j)
    for (int i = 0; i < (1 << rem); ++i)
      block[size_t(index + i + j * bw)] = blk;
}

void SnowDecoder::State::decode_q_branch(int level, int x, int y) {
  const int bw = b_width << block_max_depth;
  const int rem = block_max_depth - level;
  const int index = (x + y * bw) << rem;
  const int trx = (x + 1) << rem;
  const BlockNode* left = x ? &block[size_t(index - 1)] : &kNullBlock;
  const BlockNode* top = y ? &block[size_t(index - bw)] : &kNullBlock;
  const BlockNode* tl = y && x ? &block[size_t(index - bw - 1)] : left;
  const BlockNode* tr = y && trx < bw && ((x & 1) == 0 || level == 0)
                            ? &block[size_t(index - bw + (1 << rem))]
                            : tl;
  const int s_context =
      2 * left->level + 2 * top->level + tl->level + tr->level;
  if (keyframe) {
    set_blocks(level, x, y, 128, 128, 128, 0, 0, 0, kBlockIntra);
    return;
  }
  if (level == block_max_depth || c.bit(block_state[4 + s_context])) {
    int mx, my;
    int l = left->color[0], cb = left->color[1], cr = left->color[2];
    unsigned ref = 0;
    const int ref_context = av_log2(2 * left->ref) + av_log2(2 * top->ref);
    const int mx_context = av_log2(2 * unsigned(std::abs(left->mx - top->mx)));
    const int my_context = av_log2(2 * unsigned(std::abs(left->my - top->my)));
    const int type =
        c.bit(block_state[1 + left->type + top->type]) ? kBlockIntra : 0;
    if (type) {
      pred_mv(mx, my, 0, left, top, tr);
      const int ld = symbol(&block_state[32], true);
      if (ld < -255 || ld > 255) broken("Snow block luma out of range");
      l += ld;
      if (nb_planes > 2) {
        const int cbd = symbol(&block_state[64], true);
        const int crd = symbol(&block_state[96], true);
        if (cbd < -255 || cbd > 255 || crd < -255 || crd > 255)
          broken("Snow block chroma out of range");
        cb += cbd;
        cr += crd;
      }
    } else {
      if (ref_frames > 1)
        ref = unsigned(
            symbol(&block_state[128 + 1024 + 32 * ref_context], false));
      if (ref >= unsigned(ref_frames)) broken("Snow invalid reference");
      pred_mv(mx, my, int(ref), left, top, tr);
      mx = int(unsigned(mx) + unsigned(symbol(
          &block_state[128 + 32 * (mx_context + 16 * !!ref)], true)));
      my = int(unsigned(my) + unsigned(symbol(
          &block_state[128 + 32 * (my_context + 16 * !!ref)], true)));
    }
    set_blocks(level, x, y, l, cb, cr, mx, my, int(ref), type);
  } else {
    decode_q_branch(level + 1, 2 * x + 0, 2 * y + 0);
    decode_q_branch(level + 1, 2 * x + 1, 2 * y + 0);
    decode_q_branch(level + 1, 2 * x + 0, 2 * y + 1);
    decode_q_branch(level + 1, 2 * x + 1, 2 * y + 1);
  }
}

// unpack_coeffs: a band's nonzero coefficients, as (x, 2·|v| + sign)
// per row, each row ended by x = width + 1.
void SnowDecoder::State::unpack_coeffs(SubBand& b, SubBand* parent) {
  const int w = b.width, h = b.height;
  XCoeff* xc = b.xc.data();
  XCoeff* prev_xc = nullptr;
  XCoeff* prev2_xc = xc;
  XCoeff* parent_xc = parent ? parent->xc.data() : nullptr;
  XCoeff* prev_parent_xc = parent_xc;
  const int kIntMax = 0x7FFFFFFF;
  int runs = get_symbol2(c, b.state[30], 0);
  int run = runs-- > 0 ? get_symbol2(c, b.state[1], 3) : kIntMax;
  for (int y = 0; y < h; ++y) {
    int v = 0;
    int lt = 0, t = 0, rt = 0;
    if (y && prev_xc->x == 0) rt = prev_xc->coeff;
    for (int x = 0; x < w; ++x) {
      int p = 0;
      const int l = v;
      lt = t;
      t = rt;
      if (y) {
        if (prev_xc->x <= x) ++prev_xc;
        rt = prev_xc->x == x + 1 ? prev_xc->coeff : 0;
      }
      if (parent_xc) {
        if ((x >> 1) > parent_xc->x) ++parent_xc;
        if ((x >> 1) == parent_xc->x) p = parent_xc->coeff;
      }
      if (l | lt | t | rt | p) {
        const int context = av_log2(unsigned(3 * (l >> 1) + (lt >> 1) +
                                             (t & ~1) + (rt >> 1) + (p >> 1)));
        v = c.bit(b.state[0][context]);
        if (v) {
          v = 2 * (get_symbol2(c, b.state[context + 2], context - 4) + 1);
          v += c.bit(b.state[0][16 + 1 + 3 + snow::kQuant3bA[l & 0xFF] +
                                3 * snow::kQuant3bA[t & 0xFF]]);
          if (uint16_t(v) != v) v = 1;           // "Coefficient damaged"
          xc->x = int16_t(x);
          (xc++)->coeff = uint16_t(v);
        }
      } else {
        if (!run) {
          run = runs-- > 0 ? get_symbol2(c, b.state[1], 3) : kIntMax;
          v = 2 * (get_symbol2(c, b.state[0 + 2], 0 - 4) + 1);
          v += c.bit(b.state[0][16 + 1 + 3]);
          if (uint16_t(v) != v) v = 1;
          xc->x = int16_t(x);
          (xc++)->coeff = uint16_t(v);
        } else {
          --run;
          v = 0;
          int max_run = y ? std::min(run, prev_xc->x - x - 2)
                          : std::min(run, w - x - 1);
          if (parent_xc) max_run = std::min(max_run, 2 * parent_xc->x - x - 1);
          if (max_run < 0 || max_run > run)
            broken("Snow coefficient run out of range");
          x += max_run;
          run -= max_run;
        }
      }
    }
    (xc++)->x = int16_t(w + 1);
    prev_xc = prev2_xc;
    prev2_xc = xc;
    if (parent_xc) {
      if (y & 1) {
        while (parent_xc->x != parent->width + 1) ++parent_xc;
        ++parent_xc;
        prev_parent_xc = parent_xc;
      } else {
        parent_xc = prev_parent_xc;
      }
    }
  }
  (xc++)->x = int16_t(w + 1);
}

// ff_snow_pred_block: one block's prediction of (b_w, b_h) at (sx, sy)
// of plane `pi` (w, h) into dst.
void SnowDecoder::State::pred_block(uint8_t* dst, int ds, int sx, int sy,
                                    int b_w, int b_h, const BlockNode& blk,
                                    int pi, int w, int h) {
  if (blk.type & kBlockIntra) {
    for (int y = 0; y < b_h; ++y)
      std::memset(dst + y * ds, blk.color[pi], size_t(b_w));
    return;
  }
  const Frame& ref = *last[blk.ref];
  const uint8_t* src = ref.p[pi].data();
  const int scale = pi ? (2 * mv_scale) >> chroma_h_shift : 2 * mv_scale;
  const int mx = blk.mx * scale, my = blk.my * scale;
  const int dx = mx & 15, dy = my & 15;
  sx += (mx >> 4) - (kHtapsMax / 2 - 1);
  sy += (my >> 4) - (kHtapsMax / 2 - 1);
  // emulated_edge_mc: the window read, its samples outside the plane
  // taken from its edge
  uint8_t win[(kMbSize + kHtapsMax) * 64];
  const int ws = 64;
  for (int y = 0; y < b_h + kHtapsMax - 1; ++y) {
    const int cy = std::min(std::max(sy + y, 0), h - 1);
    for (int x = 0; x < b_w + kHtapsMax - 1; ++x) {
      const int cx = std::min(std::max(sx + x, 0), w - 1);
      win[y * ws + x] = src[size_t(cy) * w + cx];
    }
  }
  const SnowPlane& p = plane[pi];
  const bool square = b_w == b_h || 2 * b_w == b_h || b_w == 2 * b_h;
  if ((dx & 3) || (dy & 3) || !square || (b_w & (b_w - 1)) || b_w == 1 ||
      b_h == 1 || !p.fast_mc)
    mc_block(&p, dst, ds, win, ws, b_w, b_h, dx, dy);
  else
    h264_qpel(dst, ds, win + 3 + 3 * ws, ws, b_w, b_h, dx >> 2, dy >> 2);
}

// add_yblock (with add, as the decoder runs it): the OBMC of the four
// blocks around the square at (src_x, src_y) added to the wavelet's
// output, into the picture.
void SnowDecoder::State::add_yblock(const int16_t* idwt, uint8_t* dst8,
                                    const uint8_t* obmc, int src_x, int src_y,
                                    int b_w, int b_h, int w, int h,
                                    int obmc_stride, int b_x, int b_y,
                                    int pi) {
  const int bw = b_width << block_max_depth;
  const int bh = b_height << block_max_depth;
  auto at = [&](int x, int y) -> const BlockNode* {
    return &block[size_t(x + y * bw)];
  };
  // the neighbours, clamped into the grid as libavcodec's pointers are
  int lx = b_x, rx = b_x + 1, ty = b_y, by = b_y + 1;
  if (b_x < 0)
    lx = rx;
  else if (b_x + 1 >= bw)
    rx = lx;
  if (b_y < 0)
    ty = by;
  else if (b_y + 1 >= bh)
    by = ty;
  const BlockNode *lt = at(lx, ty), *rt = at(rx, ty), *lb = at(lx, by),
                  *rb = at(rx, by);
  if (src_x < 0) {
    obmc -= src_x;
    b_w += src_x;
    src_x = 0;
  }
  if (src_x + b_w > w) b_w = w - src_x;
  if (src_y < 0) {
    obmc -= src_y * obmc_stride;
    b_h += src_y;
    src_y = 0;
  }
  if (src_y + b_h > h) b_h = h - src_y;
  if (b_w <= 0 || b_h <= 0) return;
  uint8_t blocks[4][kMbSize * kMbSize];
  const BlockNode* nodes[4] = {lt, rt, lb, rb};
  for (int k = 0; k < 4; ++k)
    pred_block(blocks[k], kMbSize, src_x, src_y, b_w, b_h, *nodes[k], pi, w, h);
  for (int y = 0; y < b_h; ++y) {
    const uint8_t* o1 = obmc + y * obmc_stride;
    const uint8_t* o2 = o1 + (obmc_stride >> 1);
    const uint8_t* o3 = o1 + obmc_stride * (obmc_stride >> 1);
    const uint8_t* o4 = o3 + (obmc_stride >> 1);
    const int16_t* line = idwt + size_t(src_y + y) * w;
    for (int x = 0; x < b_w; ++x) {
      const int i = x + y * kMbSize;
      int v = o1[x] * blocks[3][i] + o2[x] * blocks[2][i] +
              o3[x] * blocks[1][i] + o4[x] * blocks[0][i];
      v >>= 8 - kFracBits;
      v += line[x + src_x];
      v = (v + (1 << (kFracBits - 1))) >> kFracBits;
      dst8[size_t(src_y + y) * w + src_x + x] = clip_u8(v);
    }
  }
}

// One plane: its bands, the inverse wavelet, the prediction.
void SnowDecoder::State::decode_plane(int pi, Frame& out) {
  SnowPlane& p = plane[pi];
  const int w = p.width, h = p.height;
  const int count = spatial_decomposition_count;
  for (int level = 0; level < count; ++level)
    for (int o = level ? 1 : 0; o < 4; ++o)
      unpack_coeffs(p.band[level][o], p.band[level][o].parent);
  std::vector<int16_t> buf(size_t(w) * h, 0);
  auto line = [&](const SubBand& b, int y) {
    return &buf[size_t(y * b.stride_line + b.buf_y) * w + b.buf_x];
  };
  // decode_subband_slice_buffered, then the LL band's correlate and
  // dequantize
  for (int level = 0; level < count; ++level)
    for (int o = level ? 1 : 0; o < 4; ++o) {
      SubBand& b = p.band[level][o];
      const bool ll = level == 0 && o == 0;
      const int ql = std::min(std::max(qlog + b.qlog, 0), kQRoot * 16);
      int qmul = snow::kQexp[ql & (kQRoot - 1)] << (ql >> kQShift);
      int qadd = (qbias * qmul) >> kQBiasShift;
      if (ll || qlog == kLosslessQlog) {
        qadd = 0;
        qmul = 1 << kQExpShift;
      }
      const XCoeff* xc = b.xc.data();
      for (int y = 0; y < b.height; ++y) {
        int16_t* ln = line(b, y);
        std::fill(ln, ln + b.width, int16_t(0));
        int v = xc->coeff, x = xc->x;
        ++xc;
        while (x < b.width) {
          const int t = int32_t(uint32_t(v >> 1) * uint32_t(qmul) +
                                uint32_t(qadd)) >> kQExpShift;
          const int u = -(v & 1);
          ln[x] = int16_t((t ^ u) - u);
          v = xc->coeff;
          x = xc->x;
          ++xc;
        }
      }
    }
  {
    SubBand& b = p.band[0][0];
    for (int y = 0; y < b.height; ++y) {       // correlate (inverse)
      int16_t* ln = line(b, y);
      const int16_t* prev = y ? line(b, y - 1) : nullptr;
      for (int x = 0; x < b.width; ++x) {
        if (x) {
          if (y)
            ln[x] = int16_t(ln[x] + median3(ln[x - 1], prev[x], ln[x - 1] +
                                            prev[x] - prev[x - 1]));
          else
            ln[x] = int16_t(ln[x] + ln[x - 1]);
        } else if (y) {
          ln[x] = int16_t(ln[x] + prev[x]);
        }
      }
    }
    if (qlog != kLosslessQlog) {               // dequantize
      const int ql = std::min(std::max(qlog + b.qlog, 0), kQRoot * 16);
      const uint32_t qmul =
          uint32_t(snow::kQexp[ql & (kQRoot - 1)]) << (ql >> kQShift);
      const uint32_t qadd = uint32_t((qbias * int(qmul)) >> kQBiasShift);
      for (int y = 0; y < b.height; ++y) {
        int16_t* ln = line(b, y);
        for (int x = 0; x < b.width; ++x) {
          const int i = ln[x];
          if (i < 0)
            ln[x] = int16_t(
                -int32_t((uint32_t(-i) * qmul + qadd) >> kQExpShift));
          else if (i > 0)
            ln[x] = int16_t((uint32_t(i) * qmul + qadd) >> kQExpShift);
        }
      }
    }
  }
  // ff_spatial_idwt: the coarsest level first
  std::vector<int16_t> temp(size_t(w) + 8);
  for (int level = count - 1; level >= 0; --level) {
    if (spatial_decomposition_type == kDwt97)
      compose97(buf.data(), temp.data(), w >> level, h >> level,
                ptrdiff_t(w) << level);
    else
      compose53(buf.data(), temp.data(), w >> level, h >> level,
                ptrdiff_t(w) << level);
  }
  if (qlog == kLosslessQlog)
    for (auto& v : buf) v = int16_t(v * (1 << kFracBits));
  out.w[pi] = w;
  out.h[pi] = h;
  out.p[pi].assign(size_t(w) * h, 0);
  uint8_t* dst8 = out.p[pi].data();
  if (keyframe) {
    for (size_t k = 0; k < buf.size(); ++k)
      dst8[k] = clip_u8(
          (buf[k] + (128 << kFracBits) + (1 << (kFracBits - 1))) >> kFracBits);
    return;
  }
  const int mb_w = b_width << block_max_depth;
  const int mb_h = b_height << block_max_depth;
  const int block_size = kMbSize >> block_max_depth;
  const int block_w = pi ? block_size >> chroma_h_shift : block_size;
  const int block_h = pi ? block_size >> chroma_v_shift : block_size;
  static const uint8_t* const kObmcTab[4] = {snow::kObmc32, snow::kObmc16,
                                             snow::kObmc8, snow::kObmc4};
  const int oi = pi ? block_max_depth + chroma_h_shift : block_max_depth;
  if (oi > 3) broken("Snow OBMC window out of range");
  const uint8_t* obmc = kObmcTab[oi];
  const int obmc_stride =
      pi ? (2 * block_size) >> chroma_h_shift : 2 * block_size;
  for (int mb_y = 0; mb_y <= mb_h; ++mb_y)
    for (int mb_x = 0; mb_x <= mb_w; ++mb_x)
      add_yblock(buf.data(), dst8, obmc, block_w * mb_x - block_w / 2,
                 block_h * mb_y - block_h / 2, block_w, block_h, w, h,
                 obmc_stride, mb_x - 1, mb_y - 1, pi);
}

bool SnowDecoder::decode(const uint8_t* data, size_t n, Picture& out) {
  State& s = *s_;
  s.c.init(data, 0, n);
  s.c.build_states();
  s.decode_header();
  s.init_bands();
  for (int pi = 0; pi < s.nb_planes; ++pi) {
    SnowPlane& p = s.plane[pi];
    p.fast_mc = p.diag_mc && p.htaps == 6 && p.hcoeff[0] == 40 &&
                p.hcoeff[1] == -10 && p.hcoeff[2] == 2;
  }
  s.b_width = (s.w + kMbSize - 1) >> 4;
  s.b_height = (s.h + kMbSize - 1) >> 4;
  s.block.assign(size_t(s.b_width * s.b_height) << (2 * s.block_max_depth),
                 BlockNode());
  // ff_snow_frame_start: the oldest reference dropped, the last picture
  // made the newest
  const int maxr = s.max_ref_frames;
  s.last[maxr - 1].reset();
  for (int i = maxr - 1; i > 0; --i) s.last[i] = s.last[i - 1];
  s.last[0] = s.current;
  s.current = std::make_shared<Frame>();
  if (s.keyframe) {
    s.ref_frames = 0;
  } else {
    int i = 0;
    for (; i < maxr && s.last[i]; ++i)
      if (i && s.last[i - 1]->key) break;
    s.ref_frames = i;
    if (!i) broken("Snow inter frame without a reference");
  }
  s.current->key = s.keyframe;
  // decode_blocks
  for (int y = 0; y < s.b_height; ++y)
    for (int x = 0; x < s.b_width; ++x) {
      if (s.c.pos >= s.c.end) broken("Snow packet ends inside its blocks");
      s.decode_q_branch(0, x, y);
    }
  for (int pi = 0; pi < s.nb_planes; ++pi) s.decode_plane(pi, *s.current);
  s.last[maxr - 1].reset();                    // ff_snow_release_buffer
  const Frame& f = *s.current;
  out = Picture();
  out.w = s.w;
  out.h = s.h;
  out.ystride = s.w;
  out.y = f.p[0];
  if (s.nb_planes == 1) {
    out.grey = true;
    out.xshift = out.yshift = 0;
    out.cstride = s.w;
    return true;
  }
  out.xshift = s.chroma_h_shift;
  out.yshift = s.chroma_v_shift;
  out.cstride = f.w[1];
  out.u = f.p[1];
  out.v = f.p[2];
  return true;
}

}  // namespace viai_video
