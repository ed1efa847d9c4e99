// HuffYUV and FFVHuff of viai_tpu_torch: libavcodec's huffyuv and ffvhuff
// decoders (huffyuvdec.c) for what VirtualDub, capture-card tools and
// ffmpeg's encoders store in AVI and Matroska:
//
//   * HuffYUV 1.x without extradata: the layout and predictor from strf's
//     bit count (its low 3 bits: left, left with decorrelation, plane,
//     median), the classic tables (huffyuv_tables.h);
//   * version 2 (HuffYUV 2.x, FFVHuff of 8-bit 4:2:0, 4:2:2 and RGB):
//     predictor, decorrelation, bit count, interlace and per-frame
//     tables (`context`) from the extradata, then its code lengths;
//   * version 3 (FFVHuff's planar layouts): grey, YUV 4:4:4 to 4:1:0 with
//     or without alpha and planar RGB, 8 to 16 bits (above 14 bits each
//     sample a code of its top 14 bits and 2 raw bits);
//   * the packet as 32-bit little-endian words read from their top bit;
//     4:2:2 and 4:2:0 coded as Y U Y V (4:2:0's odd rows Y only), RGB
//     bottom-up as B G R (A) or G, B − G, R − G, A; the predictions left,
//     plane (left, then the row above added; two rows above when
//     interlaced) and median, with libavcodec's start-up rows; the
//     interlace bit (set by default above 288 rows) as libavcodec reads
//     it.
//
// The picture is as libavcodec gives it: yuv420p/yuv422p planes, bgr0 and
// bgra as BGR24, the planar layouts as ffv1.cpp gives them (alpha
// dropped, grey above 8 bits as full-range 4:4:4 with mid chroma). A code that
// matches nothing, tables that do not build and data that runs out raise
// ValueError; RGB with the median predictor (libavcodec decodes none)
// NotImplementedError.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <memory>
#include <string>
#include <vector>

#include "huffyuv_tables.h"
#include "lossless.h"
#include "video.h"

namespace viai_video {

namespace {

enum { kLeft = 0, kPlane = 1, kMedian = 2 };
constexpr int kMaxVlcN = 16384;

// read_len_table: n lengths as (3-bit repeat, 5-bit value) runs, a zero
// repeat followed by an 8-bit one.
std::vector<uint8_t> read_len_table(SwappedBits& gb, int n) {
  std::vector<uint8_t> out(static_cast<size_t>(n));
  for (int i = 0; i < n;) {
    int repeat = int(gb.get(3));
    const int val = int(gb.get(5));
    if (repeat == 0) repeat = int(gb.get(8));
    if (i + repeat > n || gb.left() < 0)
      broken("HuffYUV Huffman table cannot be read");
    while (repeat--) out[size_t(i++)] = uint8_t(val);
  }
  return out;
}

// ff_huffyuv_generate_bits_table: canonical codes, the longest from 0.
std::vector<uint32_t> generate_bits(const std::vector<uint8_t>& len) {
  int lens[33] = {0};
  uint32_t codes[33];
  for (uint8_t l : len) ++lens[l];
  codes[32] = 0;
  for (int i = 32; i > 0; --i) {
    if ((lens[i] + codes[i]) & 1)
      broken("HuffYUV Huffman table does not build");
    codes[i - 1] = (uint32_t(lens[i]) + codes[i]) >> 1;
  }
  std::vector<uint32_t> out(len.size(), 0);
  for (size_t i = 0; i < len.size(); ++i)
    if (len[i]) out[i] = codes[len[i]]++;
  return out;
}

// Version 3's layouts with a pixel format, by
// (chroma << 10) | (yuv << 9) | (alpha << 8) | ((bps − 1) << 4) | hs | (vs << 2).
const int kV3Formats[] = {
    0x070, 0x0F0, 0x470, 0x480, 0x490, 0x4B0, 0x4D0, 0x4F0, 0x570,
    0x670, 0x680, 0x690, 0x6B0, 0x6D0, 0x6F0, 0x671, 0x681, 0x691,
    0x6B1, 0x6D1, 0x6F1, 0x672, 0x674, 0x675, 0x685, 0x695, 0x6B5,
    0x6D5, 0x6F5, 0x67A, 0x770, 0x780, 0x790, 0x7F0, 0x771, 0x781,
    0x791, 0x7F1, 0x775, 0x785, 0x795, 0x7F5};

}  // namespace

struct HuffyuvDecoder::State {
  int w = 0, h = 0;
  int version = 0;
  int bps = 8, n = 256, vlc_n = 256;
  int chroma = 1, yuv = 0, alpha = 0, hs = 0, vs = 0;
  int decorrelate = 0, predictor = kLeft, bitstream_bpp = 0;
  int context = 0, interlaced = 0;
  PrefixCode code[4];
  // Version 3's line of residuals (libavcodec's temp[0]): kept across
  // lines, planes and pictures, since what a chroma line of an odd width
  // leaves past its end shows (decode_v3).
  std::vector<int> tmp;

  int read_tables(SwappedBits& gb);
  void read_old_tables();
  int sym(SwappedBits& gb, int t) const {
    const int v = code[t].decode(gb);
    if (v < 0) broken("HuffYUV packet holds a bad code");
    return v;
  }
  void decode_yuv2(SwappedBits& gb, Picture& out);
  void decode_rgb2(SwappedBits& gb, Picture& out);
  void decode_v3(SwappedBits& gb, Picture& out);
};

int HuffyuvDecoder::State::read_tables(SwappedBits& gb) {
  const int64_t at = gb.pos;
  const int count = version > 2 ? 1 + alpha + 2 * chroma : 3;
  for (int i = 0; i < count; ++i) {
    std::vector<uint8_t> len = read_len_table(gb, vlc_n);
    if (!code[i].build(len, generate_bits(len)))
      broken("HuffYUV Huffman table is not prefix-free");
  }
  return int((gb.pos - at + 7) / 8);
}

void HuffyuvDecoder::State::read_old_tables() {
  SwappedBits lg(kClassicShiftLuma, sizeof(kClassicShiftLuma));
  SwappedBits cg(kClassicShiftChroma, sizeof(kClassicShiftChroma));
  std::vector<uint8_t> len[3];
  std::vector<uint32_t> bits[3];
  len[0] = read_len_table(lg, 256);
  len[1] = read_len_table(cg, 256);
  bits[0].assign(kClassicAddLuma, kClassicAddLuma + 256);
  bits[1].assign(kClassicAddChroma, kClassicAddChroma + 256);
  if (bitstream_bpp >= 24) {
    bits[1] = bits[0];
    len[1] = len[0];
  }
  bits[2] = bits[1];
  len[2] = len[1];
  for (int i = 0; i < 3; ++i)
    if (!code[i].build(len[i], bits[i]))
      broken("HuffYUV classic table is not prefix-free");
}

HuffyuvDecoder::HuffyuvDecoder(int bits, const std::vector<uint8_t>& ext,
                               int w, int h)
    : s_(new State) {
  State& s = *s_;
  if (w <= 0 || h <= 0) broken("HuffYUV track without a picture size");
  s.w = w;
  s.h = h;
  s.interlaced = h > 288;
  if (!ext.empty()) {
    if ((bits & 7) && bits != 12)
      s.version = 1;
    else if (ext.size() > 3 && ext[3] == 0)
      s.version = 2;
    else
      s.version = 3;
  }
  if (s.version >= 2) {
    if (ext.size() < 4) broken("HuffYUV extradata shorter than 4 bytes");
    s.decorrelate = (ext[0] & 64) ? 1 : 0;
    s.predictor = ext[0] & 63;
    if (s.version == 2) {
      s.bitstream_bpp = ext[1] ? ext[1] : (bits & ~7);
    } else {
      s.bps = (ext[1] >> 4) + 1;
      s.n = 1 << s.bps;
      s.vlc_n = std::min(s.n, kMaxVlcN);
      s.hs = ext[1] & 3;
      s.vs = (ext[1] >> 2) & 3;
      s.yuv = (ext[2] & 1) ? 1 : 0;
      s.chroma = (ext[2] & 3) ? 1 : 0;
      s.alpha = (ext[2] & 4) ? 1 : 0;
    }
    const int il = (ext[2] & 0x30) >> 4;
    s.interlaced = il == 1 ? 1 : il == 2 ? 0 : s.interlaced;
    s.context = (ext[2] & 0x40) ? 1 : 0;
    SwappedBits gb(ext.data() + 4, ext.size() - 4);
    s.read_tables(gb);
  } else {
    switch (bits & 7) {
      case 1: s.predictor = kLeft; s.decorrelate = 0; break;
      case 2: s.predictor = kLeft; s.decorrelate = 1; break;
      case 3: s.predictor = kPlane; s.decorrelate = bits >= 24; break;
      case 4: s.predictor = kMedian; s.decorrelate = 0; break;
      default: s.predictor = kLeft; s.decorrelate = 0; break;
    }
    s.bitstream_bpp = bits & ~7;
    s.context = 0;
    s.read_old_tables();
  }
  if (s.predictor > kMedian)
    broken("HuffYUV predictor " + std::to_string(s.predictor) +
           " is unknown");
  bool yuv422 = false, yuv420 = false;
  if (s.version <= 2) {
    switch (s.bitstream_bpp) {
      case 12: yuv420 = true; s.yuv = 1; s.hs = s.vs = 1; break;
      case 16: yuv422 = true; s.yuv = 1; s.hs = 1; s.vs = 0; break;
      case 24: break;
      case 32: s.alpha = 1; break;
      default:
        broken("HuffYUV bit count " + std::to_string(s.bitstream_bpp) +
               " names no layout");
    }
  } else {
    const int key = (s.chroma << 10) | (s.yuv << 9) | (s.alpha << 8) |
                    ((s.bps - 1) << 4) | s.hs | (s.vs << 2);
    bool ok = false;
    for (int k : kV3Formats) ok = ok || k == key;
    if (!ok) broken("FFVHuff layout without a pixel format");
    yuv420 = key == 0x675;
    yuv422 = key == 0x671;
  }
  if ((yuv422 || yuv420) && (w & 1))
    broken("HuffYUV 4:2:2 and 4:2:0 need an even width");
  if (s.predictor == kMedian && yuv422 && w % 4)
    broken("HuffYUV 4:2:2 with the median predictor needs a width of a "
           "multiple of 4");
}

HuffyuvDecoder::~HuffyuvDecoder() = default;

namespace {

inline int add_left(uint8_t* dst, const uint8_t* src, int w, int acc) {
  for (int i = 0; i < w; ++i) {
    acc += src[i];
    dst[i] = uint8_t(acc);
  }
  return acc;
}

inline void add_bytes(uint8_t* dst, const uint8_t* src, int w) {
  for (int i = 0; i < w; ++i) dst[i] = uint8_t(dst[i] + src[i]);
}

inline void add_median(uint8_t* dst, const uint8_t* top, const uint8_t* diff,
                       int w, int& left, int& left_top) {
  uint8_t l = uint8_t(left), lt = uint8_t(left_top);
  for (int i = 0; i < w; ++i) {
    l = uint8_t(median3(l, top[i], (l + top[i] - lt) & 0xFF) + diff[i]);
    lt = top[i];
    dst[i] = l;
  }
  left = l;
  left_top = lt;
}

}  // namespace

// Versions 0 to 2, yuv420p (bit count 12) and yuv422p (16).
void HuffyuvDecoder::State::decode_yuv2(SwappedBits& gb, Picture& out) {
  const int width2 = w >> 1, ch = bitstream_bpp == 12 ? (h + 1) / 2 : h;
  std::vector<uint8_t> Y(size_t(w) * h), U(size_t(width2) * ch),
      V(size_t(width2) * ch);
  auto yr = [&](int r) { return &Y[size_t(r) * w]; };
  auto ur = [&](int r) { return &U[size_t(r) * width2]; };
  auto vr = [&](int r) { return &V[size_t(r) * width2]; };
  std::vector<uint8_t> t0(size_t(w) + 8), t1(size_t(w) + 8), t2(size_t(w) + 8);
  auto d422 = [&](int count) {
    count /= 2;
    for (int i = 0; i < count; ++i) {
      t0[size_t(2 * i)] = uint8_t(sym(gb, 0));
      t1[size_t(i)] = uint8_t(sym(gb, 1));
      t0[size_t(2 * i + 1)] = uint8_t(sym(gb, 0));
      t2[size_t(i)] = uint8_t(sym(gb, 2));
    }
    if (gb.left() < 0) broken("HuffYUV packet runs out of bits");
  };
  auto dgray = [&](int count) {
    count /= 2;
    for (int i = 0; i < count; ++i) {
      t0[size_t(2 * i)] = uint8_t(sym(gb, 0));
      t0[size_t(2 * i + 1)] = uint8_t(sym(gb, 0));
    }
    if (gb.left() < 0) broken("HuffYUV packet runs out of bits");
  };
  const int fy = interlaced ? 2 : 1;        // fake strides, in rows
  int leftv = V[0] = uint8_t(gb.get(8));
  int lefty = Y[1] = uint8_t(gb.get(8));
  int leftu = U[0] = uint8_t(gb.get(8));
  Y[0] = uint8_t(gb.get(8));
  if (predictor == kLeft || predictor == kPlane) {
    d422(w - 2);
    lefty = add_left(Y.data() + 2, t0.data(), w - 2, lefty);
    leftu = add_left(U.data() + 1, t1.data(), width2 - 1, leftu);
    leftv = add_left(V.data() + 1, t2.data(), width2 - 1, leftv);
    for (int y = 1, cy = 1; y < h; ++y, ++cy) {
      if (bitstream_bpp == 12) {
        dgray(w);
        uint8_t* yd = yr(y);
        lefty = add_left(yd, t0.data(), w, lefty);
        if (predictor == kPlane && y > interlaced)
          add_bytes(yd, yd - size_t(fy) * w, w);
        ++y;
        if (y >= h) break;
      }
      uint8_t* yd = yr(y);
      uint8_t* ud = ur(cy);
      uint8_t* vd = vr(cy);
      d422(w);
      lefty = add_left(yd, t0.data(), w, lefty);
      leftu = add_left(ud, t1.data(), width2, leftu);
      leftv = add_left(vd, t2.data(), width2, leftv);
      if (predictor == kPlane && cy > interlaced) {
        add_bytes(yd, yd - size_t(fy) * w, w);
        add_bytes(ud, ud - size_t(fy) * width2, width2);
        add_bytes(vd, vd - size_t(fy) * width2, width2);
      }
    }
  } else {
    // median: the first row but its first 2 samples left-predicted
    d422(w - 2);
    lefty = add_left(Y.data() + 2, t0.data(), w - 2, lefty);
    leftu = add_left(U.data() + 1, t1.data(), width2 - 1, leftu);
    leftv = add_left(V.data() + 1, t2.data(), width2 - 1, leftv);
    int y = 1, cy = 1;
    do {
      if (y >= h) break;
      if (interlaced) {
        // the second row left-predicted too
        d422(w);
        lefty = add_left(yr(1), t0.data(), w, lefty);
        leftu = add_left(ur(1), t1.data(), width2, leftu);
        leftv = add_left(vr(1), t2.data(), width2, leftv);
        ++y;
        ++cy;
        if (y >= h) break;
      }
      // the next 4 samples left-predicted
      d422(4);
      lefty = add_left(yr(fy), t0.data(), 4, lefty);
      leftu = add_left(ur(fy), t1.data(), 2, leftu);
      leftv = add_left(vr(fy), t2.data(), 2, leftv);
      // the rest of that row median-predicted
      int lefttopy = Y[3];
      d422(w - 4);
      add_median(yr(fy) + 4, Y.data() + 4, t0.data(), w - 4, lefty, lefttopy);
      int lefttopu = U[1], lefttopv = V[1];
      add_median(ur(fy) + 2, U.data() + 2, t1.data(), width2 - 2, leftu,
                 lefttopu);
      add_median(vr(fy) + 2, V.data() + 2, t2.data(), width2 - 2, leftv,
                 lefttopv);
      ++y;
      ++cy;
      for (; y < h; ++y, ++cy) {
        if (bitstream_bpp == 12) {
          while (2 * cy > y) {
            dgray(w);
            uint8_t* yd = yr(y);
            add_median(yd, yd - size_t(fy) * w, t0.data(), w, lefty,
                       lefttopy);
            ++y;
          }
          if (y >= h) break;
        }
        d422(w);
        uint8_t* yd = yr(y);
        uint8_t* ud = ur(cy);
        uint8_t* vd = vr(cy);
        add_median(yd, yd - size_t(fy) * w, t0.data(), w, lefty, lefttopy);
        add_median(ud, ud - size_t(fy) * width2, t1.data(), width2, leftu,
                   lefttopu);
        add_median(vd, vd - size_t(fy) * width2, t2.data(), width2, leftv,
                   lefttopv);
      }
    } while (false);
  }
  out.xshift = 1;
  out.yshift = bitstream_bpp == 12 ? 1 : 0;
  out.cstride = width2;
  out.y = std::move(Y);
  out.u = std::move(U);
  out.v = std::move(V);
}

// Versions 0 to 2, RGB (bit count 24: bgr0, 32: bgra), bottom-up.
void HuffyuvDecoder::State::decode_rgb2(SwappedBits& gb, Picture& out) {
  if (predictor == kMedian)
    unsupported("HuffYUV RGB with the median predictor (libavcodec "
                "decodes none)");
  enum { B = 0, G = 1, R = 2, A = 3 };
  std::vector<uint8_t> px(size_t(w) * h * 4);
  std::vector<uint8_t> tmp(size_t(w) * 4 + 16);
  uint8_t left[4];
  const size_t last = size_t(h - 1) * w * 4;
  if (bitstream_bpp == 32) {
    left[A] = px[last + A] = uint8_t(gb.get(8));
    left[R] = px[last + R] = uint8_t(gb.get(8));
    left[G] = px[last + G] = uint8_t(gb.get(8));
    left[B] = px[last + B] = uint8_t(gb.get(8));
  } else {
    left[R] = px[last + R] = uint8_t(gb.get(8));
    left[G] = px[last + G] = uint8_t(gb.get(8));
    left[B] = px[last + B] = uint8_t(gb.get(8));
    left[A] = px[last + A] = 255;
    gb.get(8);
  }
  const bool with_alpha = bitstream_bpp == 32;
  auto dbgr = [&](int count) {
    for (int i = 0; i < count; ++i) {
      uint8_t* t = &tmp[size_t(4 * i)];
      if (decorrelate) {
        t[G] = uint8_t(sym(gb, 1));
        t[B] = uint8_t(sym(gb, 0) + t[G]);
        t[R] = uint8_t(sym(gb, 2) + t[G]);
      } else {
        t[B] = uint8_t(sym(gb, 0));
        t[G] = uint8_t(sym(gb, 1));
        t[R] = uint8_t(sym(gb, 2));
      }
      if (with_alpha) t[A] = uint8_t(sym(gb, 2));
    }
    if (gb.left() < 0) broken("HuffYUV packet runs out of bits");
  };
  auto left_bgr32 = [&](uint8_t* dst, int count) {
    for (int i = 0; i < count; ++i)
      for (int c = 0; c < 4; ++c) {
        left[c] = uint8_t(left[c] + tmp[size_t(4 * i + c)]);
        dst[4 * i + c] = left[c];
      }
  };
  dbgr(w - 1);
  left_bgr32(&px[last + 4], w - 1);
  const size_t fake = size_t(interlaced ? 2 : 1) * w * 4;
  for (int y = h - 2; y >= 0; --y) {
    dbgr(w);
    uint8_t* row = &px[size_t(y) * w * 4];
    left_bgr32(row, w);
    if (predictor == kPlane) {
      if (bitstream_bpp != 32) left[A] = 0;
      if (y < h - 1 - interlaced) add_bytes(row, row + fake, 4 * w);
    }
  }
  out.bgr.resize(size_t(w) * h * 3);
  for (size_t i = 0; i < size_t(w) * h; ++i)
    std::memcpy(&out.bgr[3 * i], &px[4 * i], 3);
}

// Version 3: planar, 8 to 16 bits.
void HuffyuvDecoder::State::decode_v3(SwappedBits& gb, Picture& out) {
  const int nplanes = 1 + 2 * chroma + alpha;
  const unsigned mask = unsigned(n - 1);
  const int cw = (w + (1 << hs) - 1) >> hs, chh = (h + (1 << vs) - 1) >> vs;
  std::vector<uint16_t> pl[4];
  if (tmp.size() < size_t(w) + 8) tmp.resize(size_t(w) + 8, 0);
  for (int p = 0; p < nplanes; ++p) {
    int pw = w, ph = h, stride = w;
    if (chroma && (p == 1 || p == 2)) {
      pw = w >> hs;
      ph = h >> vs;
      stride = cw;
      pl[p].assign(size_t(cw) * chh, 0);
    } else {
      pl[p].assign(size_t(w) * h, 0);
    }
    uint16_t* base = pl[p].data();
    const int fake = (interlaced ? 2 : 1) * stride;
    auto line = [&]() {
      const int count = pw / 2;
      for (int i = 0; i < 2 * count + (pw & 1); ++i) {
        int v = sym(gb, p);
        if (bps > 14) v = (v << 2) + int(gb.get(2));
        tmp[size_t(i)] = v;
      }
      if (gb.left() < 0) broken("FFVHuff packet runs out of bits");
    };
    // libavcodec's SIMD add_left_pred runs on past the line's end in its
    // blocks of 16 or 32, over the residuals still in temp[0] from longer
    // lines: a chroma plane's last column at an odd width, which the
    // bitstream does not code and cv2 converts, holds that running sum.
    auto left_pred = [&](uint16_t* dst, unsigned acc) {
      for (int i = 0; i < pw; ++i) {
        acc += unsigned(tmp[size_t(i)]);
        acc &= mask;
        dst[i] = uint16_t(acc);
      }
      for (unsigned run = acc, i = unsigned(pw); bps <= 8 && i < unsigned(stride);
           ++i) {
        run = (run + unsigned(tmp[i])) & mask;
        dst[i] = uint16_t(run);
      }
      return acc;
    };
    auto median = [&](uint16_t* dst, const uint16_t* top, int& l_, int& lt_) {
      int l = l_, lt = lt_;
      // libavcodec's SIMD add_median_pred runs on past the line's end too
      // (8 bits), over the row above's such column; the state it hands
      // back is the line's last pixel's.
      const int end = bps <= 8 ? stride : pw;
      for (int i = 0; i < end; ++i) {
        if (i == pw) {
          l_ = l;
          lt_ = lt;
        }
        if (bps <= 8)
          l = (median3(l & 0xFF, top[i], (l + top[i] - lt) & 0xFF) +
               tmp[size_t(i)]) & 0xFF;
        else
          l = int((unsigned(median3(l, top[i],
                                    int(unsigned(l + top[i] - lt) & mask))) +
                   unsigned(tmp[size_t(i)])) & mask);
        lt = top[i];
        dst[i] = uint16_t(l);
      }
      if (end == pw) {
        l_ = l;
        lt_ = lt;
      }
    };
    // The first line is coded even where the plane has none (a 4:2:0
    // picture one row high): libavcodec reads it into the row it has.
    if (predictor == kLeft || predictor == kPlane) {
      line();
      unsigned left = left_pred(base, 0);
      for (int y = 1; y < ph; ++y) {
        uint16_t* dst = base + size_t(y) * stride;
        line();
        left = left_pred(dst, left);
        if (predictor == kPlane && y > interlaced)
          for (int i = 0; i < pw; ++i)
            dst[i] = uint16_t((dst[i] + dst[i - fake]) & mask);
      }
    } else {
      line();
      int left = int(left_pred(base, 0));
      int y = 1;
      if (y >= ph) continue;
      if (interlaced) {
        line();
        left = int(left_pred(base + stride, unsigned(left)));
        if (++y >= ph) continue;
      }
      // libavcodec reads the first byte of the plane (above 8 bits the
      // first sample's low byte).
      int lefttop = bps > 8 ? base[0] & 0xFF : base[0];
      line();
      median(base + fake, base, left, lefttop);
      ++y;
      for (; y < ph; ++y) {
        line();
        uint16_t* dst = base + size_t(y) * stride;
        median(dst, dst - fake, left, lefttop);
      }
    }
  }
  const bool rgb = chroma && !yuv;
  out.depth = bps;
  if (!chroma) {
    out.xshift = out.yshift = 0;
    out.cstride = w;
    if (bps == 8) {
      out.grey = true;
      out.y.assign(pl[0].begin(), pl[0].end());
      return;
    }
    out.full_range = true;              // as cv2 converts grey
    out.y16 = pl[0];
    out.u16.assign(pl[0].size(), uint16_t(1 << (bps - 1)));
    out.v16.assign(pl[0].size(), uint16_t(1 << (bps - 1)));
    return;
  }
  out.rgb = rgb;
  out.xshift = hs;
  out.yshift = vs;
  out.cstride = cw;
  if (bps == 8) {
    out.y.assign(pl[0].begin(), pl[0].end());
    out.u.assign(pl[1].begin(), pl[1].end());
    out.v.assign(pl[2].begin(), pl[2].end());
    out.scaler_only = alpha && !rgb && hs == 1 && vs == 0;
  } else {
    out.y16 = std::move(pl[0]);
    out.u16 = std::move(pl[1]);
    out.v16 = std::move(pl[2]);
  }
}

bool HuffyuvDecoder::decode(const uint8_t* data, size_t n, Picture& out) {
  State& s = *s_;
  if (n < (size_t(s.w) * s.h + 7) / 8) broken("HuffYUV packet too short");
  SwappedBits gb(data, n, n, false);
  if (s.context) gb.pos = int64_t(s.read_tables(gb)) * 8;
  out = Picture();
  out.w = s.w;
  out.h = s.h;
  out.ystride = s.w;
  if (s.version > 2)
    s.decode_v3(gb, out);
  else if (s.bitstream_bpp < 24)
    s.decode_yuv2(gb, out);
  else
    s.decode_rgb2(gb, out);
  return true;
}

}  // namespace viai_video
