// UT Video of viai_tpu_torch: libavcodec's utvideo decoder (utvideodec.c)
// for the classic 8-bit layouts its encoder and OBS's lossless preset
// write: ULRG (gbrp), ULRA (gbrap), ULY0/ULY2/ULY4 (yuv420p/422p/444p,
// BT.601) and ULH0/ULH2/ULH4 (the same in BT.709).
//
//   * the 16-byte extradata: the frame information size, then the flags
//     (slices, compression, interlace);
//   * each plane: 256 code lengths (a 0 fills the plane with that
//     symbol), the slices' end offsets, the slices' Huffman bits (each
//     32-bit word little-endian, read from its top bit), the slices' rows
//     split at height · (i + 1) / slices (even for 4:2:0 luma);
//   * the frame information word's prediction: none, left (running on
//     across a slice's rows from 0x80), gradient or median (each slice's
//     first row left-predicted from 0x80), then for RGB G added to B and
//     R less 0x80.
//
// The picture is planar as libavcodec gives it: gbrp (alpha dropped, as
// swscale drops it), yuv at its matrix (the ULH* layouts' BT.709, which
// cv2's swscale takes from the frame). Interlaced streams, 10-bit (UQ**)
// and pack-mode (UM**) layouts raise NotImplementedError; what
// libavcodec refuses raises ValueError.

#include <algorithm>
#include <cstdint>
#include <memory>
#include <string>
#include <vector>

#include "lossless.h"
#include "video.h"

namespace viai_video {

namespace {

enum Pred { kNone = 0, kLeft = 1, kGradient = 2, kMedian = 3 };

uint32_t rl32(const uint8_t* p) {
  return uint32_t(p[0]) | (uint32_t(p[1]) << 8) | (uint32_t(p[2]) << 16) |
         (uint32_t(p[3]) << 24);
}

// build_huff: the codes in libavcodec's order (longest first; of one
// length, the higher symbol first), assigned upward from 0. → the single
// symbol that fills the plane (a length of 0), else −1.
int build_code(const uint8_t* src, PrefixCode& code) {
  std::vector<uint8_t> bits(256);
  int counts[34] = {0};
  for (int i = 0; i < 256; ++i) {
    if (src[i] == 0) return i;
    if (src[i] == 255)
      bits[size_t(i)] = 0;
    else if (src[i] <= 32)
      bits[size_t(i)] = src[i];
    else
      broken("UT Video code length out of range");
    ++counts[bits[size_t(i)]];
  }
  if (counts[0] == 256) broken("UT Video plane without codes");
  std::vector<uint32_t> value(256, 0);
  uint64_t next = 0;                       // left-aligned in 32 bits
  for (int l = 32; l >= 1; --l)
    for (int s = 255; s >= 0; --s) {
      if (bits[size_t(s)] != l) continue;
      if (next > 0xFFFFFFFFull) broken("UT Video codes overdetermined");
      value[size_t(s)] = uint32_t(next >> (32 - l));
      next += uint64_t(1) << (32 - l);
    }
  if (next > (uint64_t(1) << 32)) broken("UT Video codes overdetermined");
  if (!code.build(bits, value)) broken("UT Video codes not prefix-free");
  return -1;
}

}  // namespace

struct UtVideoDecoder::State {
  int w = 0, h = 0;
  int planes = 3;
  int xs = 0, ys = 0;                  // chroma shifts
  bool rgb = false;
  int matrix = 5;
  int slices = 1;
  uint32_t frame_info_size = 4;

  void decode_plane(const uint8_t* src, const uint8_t* end, uint8_t* dst,
                    int pw, int ph, bool luma420, bool use_pred) const;
  void restore(uint8_t* p, int pw, int ph, bool luma420, int pred) const;
};

bool UtVideoDecoder::reads(const std::string& tag) {
  static const char* kTags[] = {"ULRG", "ULRA", "ULY0", "ULY2",
                                "ULY4", "ULH0", "ULH2", "ULH4"};
  for (const char* t : kTags)
    if (tag == t) return true;
  return false;
}

UtVideoDecoder::UtVideoDecoder(const std::string& tag,
                               const std::vector<uint8_t>& extradata, int w,
                               int h)
    : s_(new State) {
  State& s = *s_;
  if (!reads(tag)) unsupported("UT Video layout '" + tag + "'");
  s.w = w;
  s.h = h;
  if (w <= 0 || h <= 0) broken("UT Video track without a picture size");
  s.rgb = tag[2] == 'R';
  s.planes = tag == "ULRA" ? 4 : 3;
  if (!s.rgb) {
    s.xs = tag[3] == '4' ? 0 : 1;
    s.ys = tag[3] == '0' ? 1 : 0;
    s.matrix = tag[2] == 'H' ? 1 : 5;      // AVCOL_SPC_BT709 / BT470BG
  }
  if ((w & ((1 << s.xs) - 1)) || (h & ((1 << s.ys) - 1)))
    broken("UT Video of odd dimensions for its chroma layout: libavcodec "
           "refuses it");
  if (extradata.size() < 16)
    broken("UT Video extradata shorter than 16 bytes");
  s.frame_info_size = rl32(&extradata[8]);
  const uint32_t flags = rl32(&extradata[12]);
  s.slices = int(flags >> 24) + 1;
  if ((flags & 1) != 1)
    unsupported("UT Video without Huffman compression (flags " +
                std::to_string(flags) + ")");
  if (flags & 0x800) unsupported("UT Video interlaced");
}

UtVideoDecoder::~UtVideoDecoder() = default;

// decode_plane: the plane's codes, then its slices.
void UtVideoDecoder::State::decode_plane(const uint8_t* src,
                                         const uint8_t* end, uint8_t* dst,
                                         int pw, int ph, bool luma420,
                                         bool use_pred) const {
  const int cmask = luma420 ? ~1 : ~0;
  PrefixCode code;
  const int fsym = build_code(src, code);
  if (fsym >= 0) {
    int send = 0;
    for (int sl = 0; sl < slices; ++sl) {
      const int sstart = send;
      send = (ph * (sl + 1) / slices) & cmask;
      int prev = 0x80;
      for (int j = sstart; j < send; ++j)
        for (int i = 0; i < pw; ++i) {
          int pix = fsym;
          if (use_pred) {
            prev += pix;
            pix = prev;
          }
          dst[size_t(j) * pw + i] = uint8_t(pix);
        }
    }
    return;
  }
  src += 256;
  const uint8_t* data = src + 4 * slices;
  int send = 0;
  for (int sl = 0; sl < slices; ++sl) {
    const int sstart = send;
    send = (ph * (sl + 1) / slices) & cmask;
    const uint32_t from = sl ? rl32(src + 4 * (sl - 1)) : 0;
    const uint32_t to = rl32(src + 4 * sl);
    const uint32_t size = to - from;
    if (!size)
      broken("UT Video plane with more than one symbol has an empty slice");
    SwappedBits gb(data + from, size_t(end - (data + from)), size, true);
    int prev = 0x80;
    for (int j = sstart; j < send; ++j) {
      uint8_t* row = dst + size_t(j) * pw;
      for (int i = 0; i < pw; ++i) {
        int pix = code.decode(gb);
        if (pix < 0) broken("UT Video slice holds a bad code");
        if (use_pred) {
          prev = (prev + pix) & 0xFF;
          pix = prev;
        }
        row[i] = uint8_t(pix);
      }
      if (gb.left() < 0) broken("UT Video slice ran out of bits");
    }
  }
}

// restore_median_planar / restore_gradient_planar (progressive).
void UtVideoDecoder::State::restore(uint8_t* p, int pw, int ph,
                                    bool luma420, int pred) const {
  const int cmask = luma420 ? ~1 : ~0;
  for (int sl = 0; sl < slices; ++sl) {
    const int start = ((sl * ph) / slices) & cmask;
    const int sh = ((((sl + 1) * ph) / slices) & cmask) - start;
    if (!sh) continue;
    uint8_t* b = p + size_t(start) * pw;
    // first row: left prediction from 0x80
    b[0] = uint8_t(b[0] + 0x80);
    uint8_t acc = 0;
    for (int i = 0; i < pw; ++i) {
      acc = uint8_t(acc + b[i]);
      b[i] = acc;
    }
    if (sh <= 1) continue;
    if (pred == kGradient) {
      for (int j = 1; j < sh; ++j) {
        uint8_t* r = b + size_t(j) * pw;
        const uint8_t* t = r - pw;
        r[0] = uint8_t(r[0] + t[0]);
        for (int i = 1; i < pw; ++i)
          r[i] = uint8_t(t[i] - t[i - 1] + r[i - 1] + r[i]);
      }
      continue;
    }
    // median: the second row's first sample from above, then the median
    // of left, top and left + top − top-left, running on across rows.
    uint8_t* r = b + pw;
    int C = r[-pw];
    r[0] = uint8_t(r[0] + C);
    int A = r[0], B = C;
    for (int i = 1; i < pw; ++i) {
      B = r[i - pw];
      r[i] = uint8_t(r[i] + median3(A, B, uint8_t(A + B - C)));
      C = B;
      A = r[i];
    }
    B = C;
    for (int j = 2; j < sh; ++j) {
      uint8_t* d = b + size_t(j) * pw;
      const uint8_t* t = d - pw;
      uint8_t l = uint8_t(A), lt = uint8_t(B);
      for (int i = 0; i < pw; ++i) {
        l = uint8_t(median3(l, t[i], (l + t[i] - lt) & 0xFF) + d[i]);
        lt = t[i];
        d[i] = l;
      }
      A = l;
      B = lt;
    }
  }
}

bool UtVideoDecoder::decode(const uint8_t* data, size_t n, Picture& out) {
  const State& s = *s_;
  const uint8_t* end = data + n;
  const uint8_t* p = data;
  std::vector<const uint8_t*> start(size_t(s.planes));
  for (int i = 0; i < s.planes; ++i) {
    start[size_t(i)] = p;
    if (size_t(end - p) < 256 + 4 * size_t(s.slices))
      broken("UT Video packet: insufficient data for a plane");
    const uint8_t* offs = p + 256;
    int64_t slice_start = 0, slice_end = 0;
    for (int j = 0; j < s.slices; ++j) {
      slice_end = int32_t(rl32(offs + 4 * j));
      const int64_t left = int64_t(end - (offs + 4 * (j + 1)));
      if (slice_end < 0 || slice_end < slice_start || left < slice_end)
        broken("UT Video packet: incorrect slice size");
      slice_start = slice_end;
    }
    p += 256 + 4 * s.slices + size_t(slice_end);
  }
  if (size_t(end - p) < s.frame_info_size)
    broken("UT Video packet: not enough data for the frame information");
  const uint32_t info = rl32(p);
  const int pred = int((info >> 8) & 3);
  out = Picture();
  out.w = s.w;
  out.h = s.h;
  out.ystride = s.w;
  out.xshift = s.xs;
  out.yshift = s.ys;
  out.cstride = s.w >> s.xs;
  out.matrix = s.matrix;
  out.rgb = s.rgb;
  std::vector<uint8_t> planes[4];
  for (int i = 0; i < s.planes; ++i) {
    const bool chroma = !s.rgb && (i == 1 || i == 2);
    const int pw = chroma ? s.w >> s.xs : s.w;
    const int ph = chroma ? s.h >> s.ys : s.h;
    const bool luma420 = !s.rgb && i == 0 && s.xs == 1 && s.ys == 1;
    planes[i].assign(size_t(pw) * ph, 0);
    s.decode_plane(start[size_t(i)], end, planes[i].data(), pw, ph, luma420,
                   pred == kLeft);
    if (pred == kMedian || pred == kGradient)
      s.restore(planes[i].data(), pw, ph, luma420, pred);
  }
  if (s.rgb) {
    // restore_rgb_planes: planes G, B, R; B and R hold their difference
    // from G less 0x80.
    for (size_t k = 0; k < planes[0].size(); ++k) {
      const uint8_t g = planes[0][k];
      planes[1][k] = uint8_t(planes[1][k] + g - 0x80);
      planes[2][k] = uint8_t(planes[2][k] + g - 0x80);
    }
    out.xshift = out.yshift = 0;
    out.cstride = s.w;
  }
  out.y = std::move(planes[0]);
  out.u = std::move(planes[1]);
  out.v = std::move(planes[2]);
  return true;
}

}  // namespace viai_video
