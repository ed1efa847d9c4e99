// Uncompressed video of viai_tpu_torch: libavcodec's rawvideo decoder
// (rawdec.c) and its v210 decoder (v210dec.c), as cv2's FFmpeg backend
// runs them on what OpenCV's writer, capture tools and ffmpeg's
// `-c:v rawvideo` store in AVI and Matroska:
//
//   * the layout: a fourcc looked up in ff_raw_pix_fmt_tags (its first
//     match, case and all: `YV12` is yuv420p with U and V swapped, `yv12`
//     without), which the AVI demuxer takes from strf's compression and
//     the Matroska demuxer from a V_UNCOMPRESSED track's ColourSpace;
//     BI_RGB (compression 0) by strf's bit count as libavcodec's
//     pix_fmt_bps_avi gives it (8 pal8, 15 and 16 rgb555le, 24 bgr24, 32
//     bgra), bottom-up when strf's height is positive (the AVI demuxer's
//     "BottomUp" extradata), its pal8 colour table the last 1 KiB or less
//     of strf's extradata (black without one);
//   * the planes as av_image_fill_arrays lays them at alignment 1 from
//     the packet's start (a longer packet is read from its start, a
//     shorter one refused: cv2 reads no further), then rawdec's
//     adjustments: rows of rgb24/bgr24/gray/rgb555le/pal8 aligned to 4
//     bytes where the packet holds them, NV12's planes aligned to 4 bytes
//     likewise, I420's chroma moved when the packet holds (w+1)·(h+1)·3/2
//     bytes, U and V swapped for YV12, YV16 and YV24; a layout of 16 bits
//     a pixel (packed 4:2:2, yuv422p) under a bit count b of 9 to 15 has
//     each 16-bit word x scaled to x << (16 − b) | x >> (2b − 16)
//     (rawdec's is_lt_16bpp);
//   * v210: 10-bit 4:2:2 in 128-bit words of three samples, rows of
//     ⌈w/48⌉·128 bytes (or 64-byte padding where the packet has exactly
//     that), unpacked as v210_decode_slice does (a last column it does
//     not reach stays 0);
//   * the picture: planar YUV as it is (yuvj full range); NV12/NV21 and
//     packed 4:2:2 as planar chroma for swscale's scaler, which cv2's
//     conversion runs for them (their input readers nv12ToUV, yuy2ToY,
//     uyvyToUV ... only move bytes); RGB as BGR24 as swscale's unscaled
//     converters give it (byte moves, rgb15tobgr24's bit replication,
//     pal8's palette lookup).
//
// A layout that is not read raises NotImplementedError (code 2) naming
// it; what cv2 reads no frame from raises ValueError (code 1).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <memory>
#include <string>
#include <utility>
#include <vector>

#include "video.h"

namespace viai_video {

namespace {

enum class Fmt {
  kYuv420p, kNv12, kNv21, kGray, kYuyv, kUyvy, kYvyu, kYuv422p, kYuv444p,
  kYuv411p, kYuv440p, kRgb24, kBgr24, kRgba, kBgra, kRgb555, kRgb444, kPal8,
  kV210
};

struct Layout {
  const char* tag;
  Fmt fmt;
  bool full;      // yuvj (full range)
  bool swap;      // U and V swapped (rawdec's YV12, YV16, YV24)
};

// ff_raw_pix_fmt_tags' entries for the layouts read, in its order where
// a tag occurs twice (its first match wins); `J...` are its yuvj tags.
const Layout kLayouts[] = {
    {"I420", Fmt::kYuv420p, false, false},
    {"IYUV", Fmt::kYuv420p, false, false},
    {"yv12", Fmt::kYuv420p, false, false},
    {"YV12", Fmt::kYuv420p, false, true},
    {"Y41B", Fmt::kYuv411p, false, false},
    {"Y42B", Fmt::kYuv422p, false, false},
    {"P422", Fmt::kYuv422p, false, false},
    {"YV16", Fmt::kYuv422p, false, true},
    {"Y800", Fmt::kGray, false, false},
    {"Y8  ", Fmt::kGray, false, false},
    {"YUY2", Fmt::kYuyv, false, false},
    {"Y422", Fmt::kYuyv, false, false},
    {"V422", Fmt::kYuyv, false, false},
    {"VYUY", Fmt::kYuyv, false, false},
    {"YUNV", Fmt::kYuyv, false, false},
    {"YUYV", Fmt::kYuyv, false, false},
    {"YVYU", Fmt::kYvyu, false, false},
    {"UYVY", Fmt::kUyvy, false, false},
    {"HDYC", Fmt::kUyvy, false, false},
    {"UYNV", Fmt::kUyvy, false, false},
    {"UYNY", Fmt::kUyvy, false, false},
    {"uyv1", Fmt::kUyvy, false, false},
    {"2Vu1", Fmt::kUyvy, false, false},
    {"VDTZ", Fmt::kUyvy, false, false},
    {"auv2", Fmt::kUyvy, false, false},
    {"GREY", Fmt::kGray, false, false},
    {"NV12", Fmt::kNv12, false, false},
    {"NV21", Fmt::kNv21, false, false},
    {"RGB\x18", Fmt::kRgb24, false, false},
    {"BGR\x18", Fmt::kBgr24, false, false},
    {"RGBA", Fmt::kRgba, false, false},
    {"BGRA", Fmt::kBgra, false, false},
    {"444P", Fmt::kYuv444p, false, false},
    {"2vuy", Fmt::kUyvy, false, false},
    {"2Vuy", Fmt::kUyvy, false, false},
    {"yuvs", Fmt::kYuyv, false, false},
    {"I411", Fmt::kYuv411p, false, false},
    {"I422", Fmt::kYuv422p, false, false},
    {"I440", Fmt::kYuv440p, false, false},
    {"I444", Fmt::kYuv444p, false, false},
    {"J420", Fmt::kYuv420p, true, false},
    {"J422", Fmt::kYuv422p, true, false},
    {"J444", Fmt::kYuv444p, true, false},
    {"YV24", Fmt::kYuv444p, false, true},
};

// Raw layouts of ff_raw_pix_fmt_tags, and Microsoft's 10/16-bit YUV
// tags, that libavformat's AVI demuxer names no codec for (they are in
// neither ff_codec_bmp_tags nor ff_codec_movvideo_tags): cv2 opens no
// decoder and reads no frame.
const char* const kAviUnnamed[] = {"444P", "RGB\x18", "BGR\x18", "P010",
                                   "P016", "P210", "P216"};

uint32_t fourcc(const char* s) {
  return uint32_t(uint8_t(s[0])) | (uint32_t(uint8_t(s[1])) << 8) |
         (uint32_t(uint8_t(s[2])) << 16) | (uint32_t(uint8_t(s[3])) << 24);
}

const Layout* find(uint32_t tag) {
  for (const Layout& l : kLayouts)
    if (fourcc(l.tag) == tag) return &l;
  return nullptr;
}

std::string tag_name(uint32_t tag) {
  std::string s;
  for (int i = 0; i < 4; ++i) {
    char c = char((tag >> (8 * i)) & 0xFF);
    s += (c >= 32 && c < 127) ? c : '?';
  }
  return s;
}

int align(int v, int a) { return (v + a - 1) & ~(a - 1); }

}  // namespace

struct RawDecoder::State {
  Fmt fmt = Fmt::kYuv420p;
  uint32_t tag = 0;
  int bits = 0, w = 0, h = 0;
  bool full = false, swap = false, flip = false;
  bool lt16 = false;                // rawdec's is_lt_16bpp
  uint8_t palette[256][3] = {};     // B, G, R
  bool stopped = false;             // a packet was refused
  int64_t frame_size = 0;           // av_image_get_buffer_size at align 1
};

RawDecoder::RawDecoder(uint32_t tag, int bits, int w, int h, bool bottom_up,
                       const std::vector<uint8_t>& extradata,
                       const std::string& where)
    : s_(new State) {
  State& s = *s_;
  s.tag = tag;
  s.bits = bits;
  s.w = w;
  s.h = h;
  if (w <= 0 || h <= 0) broken(where + " uncompressed video without a size");
  if (tag == 0) {
    // BI_RGB: libavcodec's pix_fmt_bps_avi by the bit count.
    if (bits == 8) s.fmt = Fmt::kPal8;
    else if (bits == 15 || bits == 16) s.fmt = Fmt::kRgb555;
    else if (bits == 24) s.fmt = Fmt::kBgr24;
    else if (bits == 32) s.fmt = Fmt::kBgra;
    else if (bits == 12) s.fmt = Fmt::kRgb444;
    else
      unsupported(where + " BI_RGB video at " + std::to_string(bits) +
                  " bits a pixel (1, 2 and 4-bit DIBs are not read)");
    s.flip = bottom_up;
    if (s.fmt == Fmt::kPal8 && !extradata.empty()) {
      // The AVI demuxer's palette: the last (1 << bits) · 4 bytes or less
      // of the extradata, entries B, G, R, reserved.
      size_t n = std::min<size_t>(1024, extradata.size());
      const uint8_t* p = extradata.data() + extradata.size() - n;
      for (size_t i = 0; i < n / 4; ++i)
        for (int c = 0; c < 3; ++c) s.palette[i][c] = p[4 * i + c];
    }
  } else if (tag == fourcc("v210")) {
    s.fmt = Fmt::kV210;
  } else {
    const Layout* l = find(tag);
    if (!l)
      unsupported(where + " uncompressed video of the layout '" +
                  tag_name(tag) + "' (not read)");
    s.fmt = l->fmt;
    s.full = l->full;
    s.swap = l->swap;
  }
  s.lt16 = (s.fmt == Fmt::kYuyv || s.fmt == Fmt::kUyvy ||
            s.fmt == Fmt::kYvyu || s.fmt == Fmt::kYuv422p) &&
           bits > 8 && bits < 16;
  const int64_t W = w, H = h, cw2 = (W + 1) >> 1, ch2 = (H + 1) >> 1;
  switch (s.fmt) {
    case Fmt::kYuv420p: case Fmt::kNv12: case Fmt::kNv21:
      s.frame_size = W * H + 2 * cw2 * ch2;
      break;
    case Fmt::kYuv422p:
      s.frame_size = W * H + 2 * cw2 * H;
      break;
    case Fmt::kYuv444p:
      s.frame_size = 3 * W * H;
      break;
    case Fmt::kYuv411p:
      s.frame_size = W * H + 2 * ((W + 3) >> 2) * H;
      break;
    case Fmt::kYuv440p:
      s.frame_size = W * H + 2 * W * ch2;
      break;
    case Fmt::kGray: case Fmt::kPal8:
      s.frame_size = W * H;
      break;
    case Fmt::kYuyv: case Fmt::kUyvy: case Fmt::kYvyu:
      s.frame_size = 4 * cw2 * H;
      break;
    case Fmt::kRgb555: case Fmt::kRgb444:
      s.frame_size = 2 * W * H;
      break;
    case Fmt::kRgb24: case Fmt::kBgr24:
      s.frame_size = 3 * W * H;
      break;
    case Fmt::kRgba: case Fmt::kBgra:
      s.frame_size = 4 * W * H;
      break;
    case Fmt::kV210:
      s.frame_size = ((W + 47) / 48) * 128 * H;
      break;
  }
}

RawDecoder::~RawDecoder() = default;

bool RawDecoder::avi_unnamed(uint32_t tag) {
  for (const char* t : kAviUnnamed)
    if (fourcc(t) == tag) return true;
  return false;
}

bool RawDecoder::avi_raw(uint32_t tag) {
  if (tag == 0 || tag == fourcc("v210")) return true;
  return find(tag) != nullptr && !avi_unnamed(tag);
}

bool RawDecoder::accepts(size_t n) const {
  const State& s = *s_;
  if (n / size_t(s.h) == 0) return false;           // "Packet too small"
  if (s.fmt == Fmt::kPal8) return true;             // read row by row
  if (s.fmt == Fmt::kV210) {
    const int64_t stride = ((int64_t(s.w) + 47) / 48) * 128;
    return int64_t(n) >= stride * s.h ||
           int64_t(n) == ((int64_t(s.w) + 23) / 24) * 24 * 8 / 3 * s.h;
  }
  return int64_t(n) >= s.frame_size;
}

bool RawDecoder::decode(const uint8_t* d, size_t n, Picture& p) {
  State& s = *s_;
  if (s.stopped || !accepts(n)) {
    // libavcodec refuses the packet, and cv2's read ends there.
    s.stopped = true;
    return false;
  }
  const int w = s.w, h = s.h;
  const int64_t buf = int64_t(n);
  // BI_RGB at 12 bits (rgb444le): sized, so that a short packet is
  // refused as libavcodec refuses it (cv2's writer stores BGRA so), but
  // not converted.
  if (s.fmt == Fmt::kRgb444)
    unsupported("BI_RGB video at 12 bits a pixel (rgb444le) is not read");
  std::vector<uint8_t> scaled, padded;
  if (s.lt16) {
    // scale16le: each little-endian word scaled up to 16 bits.
    scaled.assign(d, d + n);
    for (size_t i = 0; i + 1 < n; i += 2) {
      const unsigned x = unsigned(d[i] | (d[i + 1] << 8));
      const unsigned v = (x << (16 - s.bits)) | (x >> (2 * s.bits - 16));
      scaled[i] = uint8_t(v);
      scaled[i + 1] = uint8_t(v >> 8);
    }
    d = scaled.data();
  }
  p = Picture();
  p.w = w;
  p.h = h;
  p.full_range = s.full;
  auto plane = [&](std::vector<uint8_t>& out, const uint8_t* src,
                   int64_t stride, int pw, int ph) {
    out.resize(size_t(pw) * ph);
    for (int y = 0; y < ph; ++y)
      std::memcpy(&out[size_t(y) * pw], src + stride * y, size_t(pw));
  };
  const int cw2 = (w + 1) >> 1, ch2 = (h + 1) >> 1;
  switch (s.fmt) {
    case Fmt::kYuv420p: case Fmt::kYuv422p: case Fmt::kYuv444p:
    case Fmt::kYuv411p: case Fmt::kYuv440p: {
      const int xs = s.fmt == Fmt::kYuv444p || s.fmt == Fmt::kYuv440p ? 0
                     : s.fmt == Fmt::kYuv411p ? 2 : 1;
      const int ys = s.fmt == Fmt::kYuv420p || s.fmt == Fmt::kYuv440p ? 1 : 0;
      const int cw = (w + (1 << xs) - 1) >> xs, ch = (h + (1 << ys) - 1) >> ys;
      int64_t u_at = int64_t(w) * h, v_at = u_at + int64_t(cw) * ch;
      if (s.tag == fourcc("I420") &&
          (int64_t(w) + 1) * (h + 1) * 3 / 2 == buf) {
        const int64_t extra = (int64_t(w) + 1) * (h + 1) - int64_t(w) * h;
        u_at += extra;
        v_at += extra * 5 / 4;
      }
      if (s.swap) std::swap(u_at, v_at);
      // The moved chroma reads past the packet, into the zeroed padding
      // (AV_INPUT_BUFFER_PADDING_SIZE, 64 bytes) libavformat gives it.
      const int64_t end = std::max(u_at, v_at) + int64_t(cw) * ch;
      if (end > buf) {
        if (end > buf + 64)
          unsupported("I420 chroma moved past the packet's padding");
        padded.assign(d, d + n);
        padded.resize(size_t(end), 0);
        d = padded.data();
      }
      p.xshift = xs;
      p.yshift = ys;
      p.ystride = w;
      p.cstride = cw;
      plane(p.y, d, w, w, h);
      plane(p.u, d + u_at, cw, cw, ch);
      plane(p.v, d + v_at, cw, cw, ch);
      break;
    }
    case Fmt::kNv12: case Fmt::kNv21: {
      int64_t ls0 = w, ls1 = 2 * int64_t(cw2), c_at = int64_t(w) * h;
      if (s.tag == fourcc("NV12") &&
          int64_t(align(w, 4)) * h + int64_t(align(int(ls1), 4)) * ch2 <= buf) {
        c_at += (align(w, 4) - ls0) * h;
        ls0 = align(w, 4);
        ls1 = align(int(ls1), 4);
      }
      p.ystride = w;
      p.cstride = cw2;
      plane(p.y, d, ls0, w, h);
      p.u.resize(size_t(cw2) * ch2);
      p.v.resize(p.u.size());
      const int ui = s.fmt == Fmt::kNv12 ? 0 : 1;
      for (int y = 0; y < ch2; ++y)
        for (int x = 0; x < cw2; ++x) {
          const uint8_t* q = d + c_at + ls1 * y + 2 * x;
          p.u[size_t(y) * cw2 + x] = q[ui];
          p.v[size_t(y) * cw2 + x] = q[1 - ui];
        }
      p.scaler_only = true;
      break;
    }
    case Fmt::kGray: {
      const int64_t ls = int64_t(align(w, 4)) * h <= buf ? align(w, 4) : w;
      p.grey = true;
      p.ystride = w;
      plane(p.y, d, ls, w, h);
      break;
    }
    case Fmt::kYuyv: case Fmt::kUyvy: case Fmt::kYvyu: {
      // yuy2ToY/yuy2ToUV, uyvyToY/uyvyToUV, and yvyu's swapped chroma.
      const int64_t ls = 4 * int64_t(cw2);
      const int yo = s.fmt == Fmt::kUyvy ? 1 : 0;
      const int uo = s.fmt == Fmt::kYuyv ? 1 : s.fmt == Fmt::kUyvy ? 0 : 3;
      const int vo = s.fmt == Fmt::kYuyv ? 3 : s.fmt == Fmt::kUyvy ? 2 : 1;
      p.xshift = 1;
      p.yshift = 0;
      p.ystride = w;
      p.cstride = cw2;
      p.y.resize(size_t(w) * h);
      p.u.resize(size_t(cw2) * h);
      p.v.resize(p.u.size());
      for (int y = 0; y < h; ++y) {
        const uint8_t* r = d + ls * y;
        for (int x = 0; x < w; ++x) p.y[size_t(y) * w + x] = r[2 * x + yo];
        for (int x = 0; x < cw2; ++x) {
          p.u[size_t(y) * cw2 + x] = r[4 * x + uo];
          p.v[size_t(y) * cw2 + x] = r[4 * x + vo];
        }
      }
      p.scaler_only = true;
      break;
    }
    case Fmt::kV210: {
      int64_t stride = ((int64_t(w) + 47) / 48) * 128;
      if (buf < stride * h) stride = buf / h;       // 64-byte padding
      // Rows of an even width: libavcodec unpacks an odd width's last
      // pixel with its pair.
      const int we = w + (w & 1);
      p.depth = 10;
      p.xshift = 1;
      p.yshift = 0;
      p.ystride = we;
      p.cstride = cw2;
      p.y16.assign(size_t(we) * h, 0);
      p.u16.assign(size_t(cw2) * h, 0);
      p.v16.assign(p.u16.size(), 0);
      for (int y = 0; y < h; ++y) {
        const uint8_t* src = d + stride * y;
        uint16_t* py = &p.y16[size_t(y) * we];
        uint16_t* pu = &p.u16[size_t(y) * cw2];
        uint16_t* pv = &p.v16[size_t(y) * cw2];
        auto word = [&]() {
          uint32_t v = uint32_t(src[0]) | (uint32_t(src[1]) << 8) |
                       (uint32_t(src[2]) << 16) | (uint32_t(src[3]) << 24);
          src += 4;
          return v;
        };
        auto three = [&](uint16_t*& a, uint16_t*& b, uint16_t*& c) {
          uint32_t v = word();
          *a++ = uint16_t(v & 0x3FF);
          *b++ = uint16_t((v >> 10) & 0x3FF);
          *c++ = uint16_t((v >> 20) & 0x3FF);
        };
        auto six = [&]() {
          three(pu, py, pv);
          three(py, pu, py);
          three(pv, py, pu);
          three(py, pv, py);
        };
        int x = (we / 12) * 12;
        for (int i = 0; i < x - 5; i += 6) six();
        if (x < we - 5) {
          six();
          x += 6;
        }
        if (x < we - 1) {
          three(pu, py, pv);
          uint32_t v = word();
          *py++ = uint16_t(v & 0x3FF);
          if (x < we - 3) {
            *pu++ = uint16_t((v >> 10) & 0x3FF);
            *py++ = uint16_t((v >> 20) & 0x3FF);
            v = word();
            *pv++ = uint16_t(v & 0x3FF);
            *py++ = uint16_t((v >> 10) & 0x3FF);
          }
        }
      }
      break;
    }
    default: {
      // RGB: one plane, rows aligned to 4 bytes where the packet holds
      // them (pal8: rows of n / h bytes), bottom-up for a BI_RGB DIB
      // of positive height; then swscale's unscaled converter to BGR24.
      const int bpp = s.fmt == Fmt::kRgb555 ? 2
                      : s.fmt == Fmt::kRgb24 || s.fmt == Fmt::kBgr24 ? 3
                      : s.fmt == Fmt::kPal8 ? 1 : 4;
      int64_t ls = int64_t(w) * bpp;
      if (s.fmt == Fmt::kPal8) ls = buf / h;
      else if (s.fmt != Fmt::kRgba && s.fmt != Fmt::kBgra &&
               int64_t(align(int(ls), 4)) * h <= buf)
        ls = align(int(ls), 4);
      if (s.fmt == Fmt::kPal8 && ls < w)
        unsupported("a BI_RGB 8-bit packet of rows shorter than its width");
      p.bgr.resize(size_t(w) * h * 3);
      for (int y = 0; y < h; ++y) {
        const uint8_t* r = d + ls * (s.flip ? h - 1 - y : y);
        uint8_t* o = &p.bgr[size_t(y) * w * 3];
        for (int x = 0; x < w; ++x, o += 3) {
          switch (s.fmt) {
            case Fmt::kBgr24: std::memcpy(o, r + 3 * x, 3); break;
            case Fmt::kBgra: std::memcpy(o, r + 4 * x, 3); break;
            case Fmt::kRgb24: case Fmt::kRgba: {
              const uint8_t* q = r + bpp * x;
              o[0] = q[2];
              o[1] = q[1];
              o[2] = q[0];
              break;
            }
            case Fmt::kRgb555: {
              const int v = r[2 * x] | (r[2 * x + 1] << 8);
              const int b = v & 0x1F, g = (v >> 5) & 0x1F;
              const int rr = (v >> 10) & 0x1F;
              o[0] = uint8_t((b << 3) | (b >> 2));
              o[1] = uint8_t((g << 3) | (g >> 2));
              o[2] = uint8_t((rr << 3) | (rr >> 2));
              break;
            }
            default: std::memcpy(o, s.palette[r[x]], 3); break;
          }
        }
      }
      break;
    }
  }
  return true;
}

}  // namespace viai_video
