// MagicYUV of viai_tpu_torch: libavcodec's magicyuv decoder (magicyuv.c)
// for what its encoder, OpenCV's writer (MAGY, stored as M8Y0) and
// capture tools write, under every riff tag libavformat maps to it.
//
//   * the packet header: "MAGY", its size, version 7, the format byte
//     (the layout: 8-bit gbrp, gbrap, yuv444p, yuv422p, yuv420p,
//     yuva444p, gray; 10-bit yuv422p, yuv444p, yuv420p, gbrp, gbrap,
//     gray; 12 and 14-bit gbrp and gbrap), the colour matrix, the flags
//     (2 interlaced, 4 full range), the picture and slice sizes, and each
//     plane's slice offsets;
//   * the code lengths, run-length coded (a byte of length, its top bit
//     saying a count byte follows), made canonical as ff_init_vlc_from_
//     lengths makes them (longest first, of one length the lower symbol
//     first, assigned upward from 0);
//   * each slice of each plane: a flags byte (1: raw samples of the
//     plane's depth) and a prediction byte (left, gradient or median),
//     each slice's first line (two for an interlaced picture) predicted
//     from the left alone;
//   * RGB stored as B − G, G, R − G (and alpha), planes in that order.
//
// The picture is what cv2's swscale converts as libavcodec gives it:
// planar G, B, R at the stream's depth, planar YUV at its matrix (1
// BT.601, 2 BT.709) and range, grey (above 8 bits as full-range 4:4:4
// with mid chroma); alpha dropped, as swscale drops it.

#include <algorithm>
#include <cstdint>
#include <memory>
#include <string>
#include <vector>

#include "lossless.h"
#include "video.h"

namespace viai_video {

namespace {

enum Pred { kLeft = 1, kGradient = 2, kMedian = 3 };

uint32_t rl32(const uint8_t* p) {
  return uint32_t(p[0]) | (uint32_t(p[1]) << 8) | (uint32_t(p[2]) << 16) |
         (uint32_t(p[3]) << 24);
}

struct Layout {
  int format;
  int bps;
  int planes;                      // coded planes
  int hshift, vshift;              // of planes 1 and 2
  bool rgb;                        // decorrelated B, G, R
  bool grey;
};

// The format byte → the layout libavcodec decodes it to; false for one
// it does not take.
bool layout_of(int format, Layout& l) {
  switch (format) {
    case 0x65: l = {format, 8, 3, 0, 0, true, false}; return true;   // gbrp
    case 0x66: l = {format, 8, 4, 0, 0, true, false}; return true;   // gbrap
    case 0x67: l = {format, 8, 3, 0, 0, false, false}; return true;  // 444
    case 0x68: l = {format, 8, 3, 1, 0, false, false}; return true;  // 422
    case 0x69: l = {format, 8, 3, 1, 1, false, false}; return true;  // 420
    case 0x6a: l = {format, 8, 4, 0, 0, false, false}; return true;  // a444
    case 0x6b: l = {format, 8, 1, 0, 0, false, true}; return true;   // gray
    case 0x6c: l = {format, 10, 3, 1, 0, false, false}; return true;
    case 0x76: l = {format, 10, 3, 0, 0, false, false}; return true;
    case 0x6d: l = {format, 10, 3, 0, 0, true, false}; return true;
    case 0x6e: l = {format, 10, 4, 0, 0, true, false}; return true;
    case 0x6f: l = {format, 12, 3, 0, 0, true, false}; return true;
    case 0x70: l = {format, 12, 4, 0, 0, true, false}; return true;
    case 0x71: l = {format, 14, 3, 0, 0, true, false}; return true;
    case 0x72: l = {format, 14, 4, 0, 0, true, false}; return true;
    case 0x73: l = {format, 10, 1, 0, 0, false, true}; return true;  // gray10
    case 0x7b: l = {format, 10, 3, 1, 1, false, false}; return true;
    default: return false;
  }
}

// huff_build: of `max` lengths, the codes ff_init_vlc_from_lengths gives
// them.
void build_code(const std::vector<uint8_t>& len, PrefixCode& code) {
  std::vector<int> order(len.size());
  for (size_t i = 0; i < len.size(); ++i) order[i] = int(i);
  std::stable_sort(order.begin(), order.end(), [&](int a, int b) {
    return len[size_t(a)] > len[size_t(b)];
  });
  std::vector<uint32_t> value(len.size(), 0);
  uint64_t next = 0;                          // left-aligned in 32 bits
  for (int s : order) {
    const int l = len[size_t(s)];
    if (next > 0xFFFFFFFFull + 1 - (uint64_t(1) << (32 - l)))
      broken("MagicYUV Huffman codes overdetermined: libavcodec refuses "
             "them");
    value[size_t(s)] = uint32_t(next >> (32 - l));
    next += uint64_t(1) << (32 - l);
  }
  if (!code.build(len, value)) broken("MagicYUV Huffman codes broken");
}

}  // namespace

struct MagicyuvDecoder::State {
  Layout l{};
  int w = 0, h = 0;
  int slice_height = 0, nb_slices = 0;
  bool interlaced = false;
  int matrix = 5;
  bool full_range = false;
  struct Slice {
    uint32_t start, size;
  };
  std::vector<Slice> slices[4];
  PrefixCode code[4];

  void read_header(const uint8_t* d, size_t n);
  void decode_plane(const uint8_t* d, int i, int j,
                    std::vector<uint16_t>& plane, int stride) const;
};

MagicyuvDecoder::MagicyuvDecoder() : s_(new State) {}
MagicyuvDecoder::~MagicyuvDecoder() = default;

bool MagicyuvDecoder::picture_size(const uint8_t* d, size_t n, int& w,
                                   int& h) {
  if (n < 36 || rl32(d) != rl32(reinterpret_cast<const uint8_t*>("MAGY")))
    return false;
  w = int(rl32(d + 16));
  h = int(rl32(d + 20));
  return w > 0 && h > 0;
}

// magy_decode_frame's header: the layout, the sizes, each plane's
// slices and the code lengths.
void MagicyuvDecoder::State::read_header(const uint8_t* d, size_t n) {
  if (n < 36) broken("MagicYUV packet shorter than its header");
  if (rl32(d) != rl32(reinterpret_cast<const uint8_t*>("MAGY")))
    broken("MagicYUV packet without its MAGY magic");
  const uint32_t header_size = rl32(d + 4);
  if (header_size < 32 || header_size >= n)
    broken("MagicYUV header or packet too small");
  if (d[8] != 7)
    unsupported("MagicYUV version " + std::to_string(d[8]) +
                " (libavcodec reads version 7 only)");
  if (!layout_of(d[9], l))
    unsupported("MagicYUV format 0x" + [](int f) {
      const char* hex = "0123456789ABCDEF";
      return std::string{hex[f >> 4], hex[f & 15]};
    }(d[9]) + " (libavcodec does not read it)");
  const int color_matrix = d[11];
  const int flags = d[12];
  interlaced = flags & 2;
  full_range = flags & 4;
  matrix = color_matrix == 2 ? 1 : 5;         // BT.709, else BT.601
  w = int(rl32(d + 16));
  h = int(rl32(d + 20));
  check_size(w, h, "MagicYUV");
  if (int(rl32(d + 24)) != w)
    unsupported("MagicYUV slice width other than the picture's (libavcodec "
                "reads none)");
  slice_height = int(rl32(d + 28));
  if (slice_height <= 0 || slice_height > 0x7FFFFFFF - h)
    broken("MagicYUV invalid slice height");
  nb_slices = (h + slice_height - 1) / slice_height;
  if (interlaced) {
    if ((slice_height >> l.vshift) < 2)
      broken("MagicYUV interlaced: impossible slice height");
    if ((h % slice_height) && ((h % slice_height) >> l.vshift) < 2)
      broken("MagicYUV interlaced: impossible height");
  }
  size_t pos = 36;
  if (n - pos <= size_t(nb_slices) * l.planes * 5)
    broken("MagicYUV packet too short for its slice offsets");
  const uint32_t body = uint32_t(n - header_size);
  uint32_t first_offset = 0;
  for (int i = 0; i < l.planes; ++i) {
    slices[i].assign(size_t(nb_slices), {0, 0});
    uint32_t offset = rl32(d + pos);
    pos += 4;
    if (offset >= body) broken("MagicYUV slice offset past the packet");
    if (i == 0) first_offset = offset;
    int j = 0;
    for (; j < nb_slices - 1; ++j) {
      slices[i][size_t(j)].start = offset + header_size;
      const uint32_t next = rl32(d + pos);
      pos += 4;
      if (next <= offset || next >= body)
        broken("MagicYUV slice offsets out of order");
      slices[i][size_t(j)].size = next - offset;
      if (slices[i][size_t(j)].size < 2) broken("MagicYUV slice too short");
      offset = next;
    }
    slices[i][size_t(j)].start = offset + header_size;
    slices[i][size_t(j)].size = uint32_t(n) - slices[i][size_t(j)].start;
    if (slices[i][size_t(j)].size < 2) broken("MagicYUV slice too short");
  }
  if (d[pos++] != l.planes) broken("MagicYUV plane count does not match");
  pos += size_t(nb_slices) * l.planes;
  const int64_t table_size =
      int64_t(header_size) + first_offset - int64_t(pos);
  if (table_size < 2) broken("MagicYUV Huffman tables missing");
  // build_huffman: runs of (length, count) until every plane has `max`.
  const int max = 1 << l.bps;
  const uint8_t* t = d + pos;
  const uint8_t* end = t + table_size;
  std::vector<uint8_t> len(static_cast<size_t>(max));
  int plane = 0, j = 0;
  while (t < end) {
    const int b = *t & 0x80, x = *t & 0x7F;
    ++t;
    int run = 1;
    if (b) {
      if (t >= end) break;
      run += *t++;
    }
    if (j + run > max || x == 0 || x > 32)
      broken("MagicYUV invalid Huffman code lengths");
    std::fill(len.begin() + j, len.begin() + j + run, uint8_t(x));
    j += run;
    if (j == max) {
      j = 0;
      build_code(len, code[plane]);
      if (++plane == l.planes) break;
    }
  }
  if (plane != l.planes) broken("MagicYUV Huffman tables too short");
}

// One slice of one plane (magy_decode_slice / magy_decode_slice10), into
// `plane` of row stride `stride` (rows past the plane's own are padding,
// as in libavcodec's frame buffer).
void MagicyuvDecoder::State::decode_plane(const uint8_t* d, int i, int j,
                                          std::vector<uint16_t>& plane,
                                          int stride) const {
  const int vs = (i == 1 || i == 2) ? l.vshift : 0;
  const int hs = (i == 1 || i == 2) ? l.hshift : 0;
  const int rows = std::min(slice_height, h - j * slice_height);
  const int height = (rows + (1 << vs) - 1) >> vs;
  const int width = (w + (1 << hs) - 1) >> hs;
  const int sheight = (slice_height + (1 << vs) - 1) >> vs;
  const int mask = (1 << l.bps) - 1;
  const ptrdiff_t fake = ptrdiff_t(stride) * (1 + interlaced);
  const Slice& sl = slices[i][size_t(j)];
  const uint8_t* src = d + sl.start;
  const int flags = src[0], pred = src[1];
  SwappedBits gb(src + 2, sl.size - 2);
  uint16_t* base = &plane[size_t(j) * sheight * stride];
  if (flags & 1) {
    if (gb.left() < int64_t(l.bps) * width * height)
      broken("MagicYUV raw slice too short");
    for (int k = 0; k < height; ++k)
      for (int x = 0; x < width; ++x)
        base[size_t(k) * stride + x] = uint16_t(gb.get(l.bps));
  } else {
    for (int k = 0; k < height; ++k)
      for (int x = 0; x < width; ++x) {
        if (gb.left() <= 0) broken("MagicYUV slice ran out of bits");
        const int pix = code[i].decode(gb);
        if (pix < 0) broken("MagicYUV slice holds a bad code");
        base[size_t(k) * stride + x] = uint16_t(pix);
      }
  }
  // add_left_pred from `acc` over a row
  auto left_row = [&](uint16_t* r, int acc) {
    for (int x = 0; x < width; ++x) {
      acc = (acc + r[x]) & mask;
      r[x] = uint16_t(acc);
    }
  };
  const int first = 1 + interlaced;
  if (pred != kLeft && pred != kGradient && pred != kMedian) {
    // libavcodec asks for a sample and leaves the residuals as they are
    return;
  }
  for (int k = 0; k < std::min(first, height); ++k)
    left_row(base + size_t(k) * stride, 0);
  for (int k = first; k < height; ++k) {
    uint16_t* r = base + size_t(k) * stride;
    const uint16_t* t = r - fake;
    if (pred == kLeft) {
      left_row(r, t[0]);
    } else if (pred == kGradient) {
      int left = t[0] + r[0];
      r[0] = uint16_t(left & mask);
      for (int x = 1; x < width; ++x) {
        left = (left + t[x] - t[x - 1] + r[x]) & mask;
        r[x] = uint16_t(left);
      }
    } else {
      // add_median_pred: the first column from above (left = top-left).
      // Above 8 bits (magicyuv_median_pred16) the gradient term is not
      // wrapped to the sample's range.
      int lft = r[0], lt = r[0];
      for (int x = 0; x < width; ++x) {
        const int grad = lft + t[x] - lt;
        lft = (median3(lft, t[x], l.bps > 8 ? grad : grad & mask) + r[x]) &
              mask;
        lt = t[x];
        r[x] = uint16_t(lft);
      }
    }
  }
}

bool MagicyuvDecoder::decode(const uint8_t* data, size_t n, Picture& out) {
  State& s = *s_;
  s.read_header(data, n);
  const Layout& l = s.l;
  const int stride = s.w;
  std::vector<uint16_t> planes[4];
  int pw[4], ph[4];
  for (int i = 0; i < l.planes; ++i) {
    const int hs = (i == 1 || i == 2) ? l.hshift : 0;
    const int vs = (i == 1 || i == 2) ? l.vshift : 0;
    pw[i] = (s.w + (1 << hs) - 1) >> hs;
    ph[i] = (s.h + (1 << vs) - 1) >> vs;
    // rows to the last slice's end (a slice of 4:2:0 chroma at an odd
    // slice height runs past the plane, into libavcodec's frame padding)
    const int64_t sheight = (int64_t(s.slice_height) + (1 << vs) - 1) >> vs;
    const int last = s.h - (s.nb_slices - 1) * s.slice_height;
    const int64_t rows = (s.nb_slices - 1) * sheight +
                         ((last + (1 << vs) - 1) >> vs);
    planes[i].assign(size_t(stride) * size_t(rows + 1), 0);
    for (int j = 0; j < s.nb_slices; ++j)
      s.decode_plane(data, i, j, planes[i], stride);
  }
  const int mask = (1 << l.bps) - 1;
  if (l.rgb) {                          // coded B − G, G, R − G
    for (int y = 0; y < s.h; ++y)
      for (int x = 0; x < s.w; ++x) {
        const size_t k = size_t(y) * stride + x;
        const int g = planes[1][k];
        planes[0][k] = uint16_t((planes[0][k] + g) & mask);
        planes[2][k] = uint16_t((planes[2][k] + g) & mask);
      }
  }
  out = Picture();
  out.w = s.w;
  out.h = s.h;
  out.ystride = s.w;
  out.depth = l.bps;
  // The planes as the picture holds them: G, B, R for RGB; Y, U, V.
  const int order_rgb[3] = {1, 0, 2}, order_yuv[3] = {0, 1, 2};
  const int* order = l.rgb ? order_rgb : order_yuv;
  auto packed8 = [&](int i) {
    std::vector<uint8_t> p(size_t(pw[i]) * ph[i]);
    for (int y = 0; y < ph[i]; ++y)
      for (int x = 0; x < pw[i]; ++x)
        p[size_t(y) * pw[i] + x] = uint8_t(planes[i][size_t(y) * stride + x]);
    return p;
  };
  auto packed16 = [&](int i) {
    std::vector<uint16_t> p(size_t(pw[i]) * ph[i]);
    for (int y = 0; y < ph[i]; ++y)
      std::copy_n(&planes[i][size_t(y) * stride], pw[i],
                  &p[size_t(y) * pw[i]]);
    return p;
  };
  if (l.grey) {
    out.xshift = out.yshift = 0;
    out.cstride = s.w;
    if (l.bps == 8) {
      out.grey = true;
      out.y = packed8(0);
      return true;
    }
    out.full_range = true;              // as cv2 converts grey
    out.y16 = packed16(0);
    out.u16.assign(out.y16.size(), uint16_t(1 << (l.bps - 1)));
    out.v16.assign(out.y16.size(), uint16_t(1 << (l.bps - 1)));
    return true;
  }
  out.rgb = l.rgb;
  out.xshift = l.hshift;
  out.yshift = l.vshift;
  out.cstride = pw[1];
  if (!l.rgb) {
    out.matrix = s.matrix;
    out.full_range = s.full_range;
  }
  if (l.bps == 8) {
    out.y = packed8(order[0]);
    out.u = packed8(order[1]);
    out.v = packed8(order[2]);
  } else {
    out.y16 = packed16(order[0]);
    out.u16 = packed16(order[1]);
    out.v16 = packed16(order[2]);
  }
  return true;
}

}  // namespace viai_video
