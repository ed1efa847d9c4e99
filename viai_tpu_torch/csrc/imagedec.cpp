// Native image decoder of viai_tpu_torch: JPEG and PNG, and the
// frame-directory reader built on them (viai_tpu_torch/native.py binds
// it; viai_tpu_torch/data/image.py is its plain numpy twin, step by
// step).
//
// The JAX package reads a clip's directory of frames with PIL
// (viai_tpu/data/av.py::_load_frames_dir): the names ending in .jpg,
// .jpeg or .png (any case), sorted; the window's frames at
// round(linspace(w0·(T−1), w1·(T−1), n)) in float64; each file
// Image.open(f).convert("RGB"), .resize((size, size), BILINEAR), / 255.
// This file computes the same bytes without PIL:
//
//   * JPEG as libjpeg-turbo decodes it at PIL's settings: baseline,
//     extended and progressive Huffman, 8-bit, 1 or 3 components,
//     sampling ratios of 1 or 2 on each axis, restart intervals; the
//     ISLOW integer IDCT (jidctint.c), its output saturated to 0..255
//     as libjpeg-turbo's SIMD IDCT, which PIL runs, does (jidctint.c's
//     range-limit table wraps outputs beyond ±512 of the centre; no
//     8-bit image's coefficients reach that), fancy triangle upsampling (jdsample.c: h2v1, h1v2, h2v2, box where the
//     component is at most 2 samples wide) and the fixed-point
//     YCbCr->RGB tables (jdcolor.c). A fully read progressive file is
//     not block-smoothed (libjpeg smooths only incomplete coefficients);
//     one whose scans leave coefficients 0..9 incomplete, which libjpeg
//     would smooth, is refused as unsupported, as are arithmetic coding,
//     12-bit, lossless, hierarchical, CMYK/YCCK and Adobe-transform RGB
//     files.
//   * PNG: colour types 0, 2, 3, 4, 6 at every depth, Adam7, the five
//     row filters, inflate (RFC 1951, inflate.h, which videodec.cpp
//     shares); the result is what Pillow's convert("RGB") gives: alpha
//     dropped, palette looked up (an index past the palette reads black,
//     as in Pillow), grey replicated, 1/2/4-bit grey scaled to 0..255,
//     16-bit samples cut to their high byte, 16-bit grey (Pillow's I;16)
//     clipped to 255.
//   * The resize is Pillow's 8-bit BILINEAR (libImaging/Resample.c):
//     triangle weights in double normalized by their sum, rounded to 22
//     fractional bits, horizontal pass then vertical, uint8 between, a
//     pass skipped where its axis keeps its size.
//
// Errors: a file that cannot be decoded gives code 1 (Python:
// ValueError), a variant that is not read code 2 (NotImplementedError),
// a directory without frames code 3 (FileNotFoundError); the message
// names the file and the cause.

#include <dirent.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include "inflate.h"
#include "jpeg.h"
#include "png.h"
#include "window.h"

namespace {

struct DecodeError {
  int code;             // 1 broken, 2 unsupported, 3 no frames
  std::string msg;
};

[[noreturn]] void broken(const std::string& m) { throw DecodeError{1, m}; }
[[noreturn]] void unsupported(const std::string& m) {
  throw DecodeError{2, m};
}

struct Rgb {            // (h, w, 3) uint8, row-major
  int h = 0, w = 0;
  std::vector<uint8_t> px;
};

constexpr int64_t kMaxPixels = int64_t(1) << 26;

void check_size(int64_t w, int64_t h) {
  if (w <= 0 || h <= 0) broken("image has no pixels");
  if (w * h > kMaxPixels) unsupported("image larger than 2^26 pixels");
}

// =====================================================================
// JPEG
// =====================================================================

// jpeg_natural_order, with 16 extra entries as libjpeg has them.
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Huffman {
  bool defined = false;
  uint16_t lut[512];        // 9-bit lookahead: (length << 8) | value, 0 = slow
  int32_t maxcode[18];      // largest code of each length, −1 if none
  int32_t valoff[17];       // value index = code + valoff[length]
  uint8_t vals[256];
};

void build_huffman(Huffman& t, const uint8_t* counts, const uint8_t* vals,
                   int nvals) {
  std::memcpy(t.vals, vals, nvals);
  std::memset(t.lut, 0, sizeof(t.lut));
  int code = 0, k = 0;
  for (int l = 1; l <= 16; ++l) {
    t.valoff[l] = k - code;
    int n = counts[l - 1];
    if (code + n > (1 << l)) broken("JPEG Huffman table is over-subscribed");
    if (n) {
      for (int i = 0; i < n; ++i) {
        if (l <= 9) {
          int lo = (code + i) << (9 - l), hi = (code + i + 1) << (9 - l);
          for (int j = lo; j < hi; ++j)
            t.lut[j] = uint16_t((l << 8) | vals[k + i]);
        }
      }
      code += n;
      k += n;
      t.maxcode[l] = code - 1;
    } else {
      t.maxcode[l] = -1;
    }
    code <<= 1;
  }
  t.maxcode[17] = 0x7fffffff;
  t.defined = true;
}

// MSB-first reader of entropy-coded data: 0xFF00 is a literal 0xFF; a
// marker stops it, and zeros are fed after it (as libjpeg does) but
// counted, so that a scan that consumes them is known to be short.
struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;
  int bits = 0;             // bits held in buf, MSB-aligned
  int64_t real = 0;         // of them, bits read from the file (can go < 0)
  bool at_marker = false;

  void fill() {
    while (bits <= 56) {
      int byte = -1;
      if (!at_marker && p < end) {
        if (*p != 0xFF) {
          byte = *p++;
        } else if (p + 1 < end && p[1] == 0x00) {
          byte = 0xFF;
          p += 2;
        } else {
          at_marker = true;
        }
      }
      if (byte >= 0) {
        buf |= uint64_t(byte) << (56 - bits);
        real += 8;
      }
      bits += 8;
    }
  }
  uint32_t peek(int n) {
    if (bits < n) fill();
    return uint32_t(buf >> (64 - n));
  }
  void skip(int n) {
    buf <<= n;
    bits -= n;
    real -= n;
  }
  int get(int n) {
    if (n == 0) return 0;
    uint32_t v = peek(n);
    skip(n);
    return int(v);
  }
  // Drop what is buffered and step over the restart marker RSTn.
  void restart(int n) {
    buf = 0;
    bits = 0;
    real = 0;
    at_marker = false;
    while (p + 1 < end && !(p[0] == 0xFF && p[1] != 0x00 && p[1] != 0xFF))
      ++p;
    if (p + 1 >= end || p[1] != 0xD0 + (n & 7))
      broken("JPEG restart marker missing");
    p += 2;
  }
};

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

int huff_decode(BitReader& br, const Huffman& t) {
  uint32_t v = br.peek(16);
  uint16_t e = t.lut[v >> 7];
  if (e) {
    br.skip(e >> 8);
    return e & 0xFF;
  }
  for (int l = 10; l <= 16; ++l) {
    int code = int(v >> (16 - l));
    if (code <= t.maxcode[l]) {
      br.skip(l);
      int idx = code + t.valoff[l];
      if (idx < 0 || idx > 255) broken("JPEG Huffman code out of range");
      return t.vals[idx];
    }
  }
  broken("JPEG data holds a bad Huffman code");
}

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int dw = 0, dh = 0;       // downsampled size in samples
  int cbw = 0, cbh = 0;     // blocks that hold samples
  int bw = 0, bh = 0;       // blocks allocated (whole MCUs)
  bool latched = false;     // quantization table copied at its first scan
  int8_t bits[64];          // progressive: the last scan's Al, −1 unread
  int32_t q[64];            // natural order
  std::vector<int16_t> coef;
  int dc_tbl = 0, ac_tbl = 0, pred = 0;
};

struct Jpeg {
  int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1;
  int mcux = 0, mcuy = 0;
  bool progressive = false, frame = false, jfif = false;
  int adobe = -1;           // Adobe APP14 transform, −1 without the marker
  int restart = 0;
  bool qdef[4] = {false, false, false, false};
  int32_t qt[4][64];        // natural order
  Huffman dc[4], ac[4];
  Component comp[4];
};

struct Scan {
  int ns = 0;
  int ci[4];
  int ss = 0, se = 63, ah = 0, al = 0;
  int eobrun = 0;
};

void block_sequential(Jpeg& j, Component& c, int16_t* blk, BitReader& br) {
  const Huffman& dc = j.dc[c.dc_tbl];
  const Huffman& ac = j.ac[c.ac_tbl];
  int s = huff_decode(br, dc);
  if (s > 15) broken("JPEG DC difference too large");
  int diff = s ? extend(br.get(s), s) : 0;
  c.pred += diff;
  blk[0] = int16_t(c.pred);
  for (int k = 1; k < 64; ++k) {
    int rs = huff_decode(br, ac);
    int r = rs >> 4;
    s = rs & 15;
    if (s) {
      k += r;
      if (k > 63) broken("JPEG coefficient index past the block");
      blk[kNatural[k]] = int16_t(extend(br.get(s), s));
    } else {
      if (r != 15) break;
      k += 15;
    }
  }
}

void block_dc_first(Jpeg& j, Component& c, int16_t* blk, BitReader& br,
                    const Scan& sc) {
  int s = huff_decode(br, j.dc[c.dc_tbl]);
  if (s > 15) broken("JPEG DC difference too large");
  int diff = s ? extend(br.get(s), s) : 0;
  c.pred += diff;
  blk[0] = int16_t(int(unsigned(c.pred) << sc.al));
}

void block_dc_refine(int16_t* blk, BitReader& br, const Scan& sc) {
  if (br.get(1)) blk[0] = int16_t(blk[0] | (1 << sc.al));
}

void block_ac_first(Jpeg& j, Component& c, int16_t* blk, BitReader& br,
                    Scan& sc) {
  if (sc.eobrun > 0) {
    --sc.eobrun;
    return;
  }
  const Huffman& ac = j.ac[c.ac_tbl];
  for (int k = sc.ss; k <= sc.se; ++k) {
    int rs = huff_decode(br, ac);
    int r = rs >> 4, s = rs & 15;
    if (s) {
      k += r;
      if (k > 63) broken("JPEG coefficient index past the block");
      blk[kNatural[k]] = int16_t(int(unsigned(extend(br.get(s), s)) << sc.al));
    } else {
      if (r != 15) {
        sc.eobrun = 1 << r;
        if (r) sc.eobrun += br.get(r);
        --sc.eobrun;
        break;
      }
      k += 15;
    }
  }
}

// libjpeg's decode_mcu_AC_refine.
void block_ac_refine(Jpeg& j, Component& c, int16_t* blk, BitReader& br,
                     Scan& sc) {
  const int p1 = 1 << sc.al, m1 = -1 * (1 << sc.al);
  int k = sc.ss;
  auto correct = [&](int pos) {
    if (br.get(1) && (blk[pos] & p1) == 0)
      blk[pos] = int16_t(blk[pos] >= 0 ? blk[pos] + p1 : blk[pos] + m1);
  };
  if (sc.eobrun == 0) {
    const Huffman& ac = j.ac[c.ac_tbl];
    for (; k <= sc.se; ++k) {
      int rs = huff_decode(br, ac);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        if (s != 1) broken("JPEG refinement coefficient of size > 1");
        s = br.get(1) ? p1 : m1;
      } else if (r != 15) {
        sc.eobrun = 1 << r;
        if (r) sc.eobrun += br.get(r);
        break;
      }
      do {
        int pos = kNatural[k];
        if (blk[pos] != 0) {
          correct(pos);
        } else {
          if (--r < 0) break;
        }
        ++k;
      } while (k <= sc.se);
      if (s) {
        if (k > 63) broken("JPEG coefficient index past the block");
        blk[kNatural[k]] = int16_t(s);
      }
    }
  }
  if (sc.eobrun > 0) {
    for (; k <= sc.se; ++k) {
      int pos = kNatural[k];
      if (blk[pos] != 0) correct(pos);
    }
    --sc.eobrun;
  }
}

void decode_scan(Jpeg& j, Scan& sc, BitReader& br) {
  for (int i = 0; i < sc.ns; ++i) j.comp[sc.ci[i]].pred = 0;
  sc.eobrun = 0;
  auto block = [&](Component& c, int16_t* blk) {
    if (!j.progressive)
      block_sequential(j, c, blk, br);
    else if (sc.ss == 0)
      sc.ah == 0 ? block_dc_first(j, c, blk, br, sc)
                 : block_dc_refine(blk, br, sc);
    else
      sc.ah == 0 ? block_ac_first(j, c, blk, br, sc)
                 : block_ac_refine(j, c, blk, br, sc);
  };
  int64_t total;
  int mx;
  if (sc.ns == 1) {
    Component& c = j.comp[sc.ci[0]];
    mx = c.cbw;
    total = int64_t(c.cbw) * c.cbh;
  } else {
    mx = j.mcux;
    total = int64_t(j.mcux) * j.mcuy;
  }
  int rst = 0;
  for (int64_t m = 0; m < total; ++m) {
    if (j.restart && m > 0 && m % j.restart == 0) {
      if (br.real < 0) broken("JPEG entropy-coded data ends early");
      br.restart(rst++);
      for (int i = 0; i < sc.ns; ++i) j.comp[sc.ci[i]].pred = 0;
      sc.eobrun = 0;
    }
    int x = int(m % mx), y = int(m / mx);
    if (sc.ns == 1) {
      Component& c = j.comp[sc.ci[0]];
      block(c, &c.coef[(int64_t(y) * c.bw + x) * 64]);
    } else {
      for (int i = 0; i < sc.ns; ++i) {
        Component& c = j.comp[sc.ci[i]];
        for (int by = 0; by < c.v; ++by)
          for (int bx = 0; bx < c.h; ++bx)
            block(c, &c.coef[(int64_t(y * c.v + by) * c.bw + x * c.h + bx) *
                             64]);
      }
    }
  }
  if (br.real < 0) broken("JPEG entropy-coded data ends early");
}

// jidctint.c's jpeg_idct_islow (CONST_BITS 13, PASS1_BITS 2) into an
// 8x8 tile of `out` (row stride `stride`), each output saturated to a
// sample as the SIMD IDCT's packs do.
constexpr int64_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196,
                  FIX_0_541196100 = 4433, FIX_0_765366865 = 6270,
                  FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
                  FIX_1_501321110 = 12299, FIX_1_847759065 = 15137,
                  FIX_1_961570560 = 16069, FIX_2_053119869 = 16819,
                  FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) {
  return (x + (int64_t(1) << (n - 1))) >> n;
}

void idct_islow(const int16_t* in, const int32_t* q, uint8_t* out,
                int stride) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* ip = in + c;
    const int32_t* qp = q + c;
    if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] &&
        !ip[56]) {
      int dc = int(int64_t(ip[0]) * qp[0] * 4);
      for (int r = 0; r < 8; ++r) ws[r * 8 + c] = dc;
      continue;
    }
    int64_t z2 = int64_t(ip[16]) * qp[16], z3 = int64_t(ip[48]) * qp[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = int64_t(ip[0]) * qp[0];
    z3 = int64_t(ip[32]) * qp[32];
    int64_t tmp0 = (z2 + z3) * 8192, tmp1 = (z2 - z3) * 8192;
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = int64_t(ip[56]) * qp[56];
    tmp1 = int64_t(ip[40]) * qp[40];
    tmp2 = int64_t(ip[24]) * qp[24];
    tmp3 = int64_t(ip[8]) * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    ws[0 * 8 + c] = int(descale(tmp10 + tmp3, 11));
    ws[7 * 8 + c] = int(descale(tmp10 - tmp3, 11));
    ws[1 * 8 + c] = int(descale(tmp11 + tmp2, 11));
    ws[6 * 8 + c] = int(descale(tmp11 - tmp2, 11));
    ws[2 * 8 + c] = int(descale(tmp12 + tmp1, 11));
    ws[5 * 8 + c] = int(descale(tmp12 - tmp1, 11));
    ws[3 * 8 + c] = int(descale(tmp13 + tmp0, 11));
    ws[4 * 8 + c] = int(descale(tmp13 - tmp0, 11));
  }
  for (int r = 0; r < 8; ++r) {
    const int* w = ws + r * 8;
    uint8_t* o = out + int64_t(r) * stride;
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = (int64_t(w[0]) + w[4]) * 8192;
    int64_t tmp1 = (int64_t(w[0]) - w[4]) * 8192;
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    auto lim = [](int64_t x) {
      int64_t v = descale(x, 18);
      return uint8_t(v < -128 ? 0 : v > 127 ? 255 : v + 128);
    };
    o[0] = lim(tmp10 + tmp3);
    o[7] = lim(tmp10 - tmp3);
    o[1] = lim(tmp11 + tmp2);
    o[6] = lim(tmp11 - tmp2);
    o[2] = lim(tmp12 + tmp1);
    o[5] = lim(tmp12 - tmp1);
    o[3] = lim(tmp13 + tmp0);
    o[4] = lim(tmp13 - tmp0);
  }
}

// One component's samples: the IDCT of every block, cut to (dh, dw).
std::vector<uint8_t> component_plane(const Component& c) {
  int pw = c.bw * 8;
  std::vector<uint8_t> full(int64_t(pw) * c.cbh * 8);
  for (int by = 0; by < c.cbh; ++by)
    for (int bx = 0; bx < c.cbw; ++bx)
      idct_islow(&c.coef[(int64_t(by) * c.bw + bx) * 64], c.q,
                 &full[int64_t(by) * 8 * pw + bx * 8], pw);
  std::vector<uint8_t> out(int64_t(c.dw) * c.dh);
  for (int y = 0; y < c.dh; ++y)
    std::memcpy(&out[int64_t(y) * c.dw], &full[int64_t(y) * pw], c.dw);
  return out;
}

// jdsample.c: a (dh, dw) plane upsampled by (rh, rv) ∈ {1, 2}², the
// rows above the first and below the last their own edge rows.
std::vector<uint8_t> upsample(const std::vector<uint8_t>& in, int dw, int dh,
                              int rh, int rv) {
  if (rh == 1 && rv == 1) return in;
  int ow = dw * rh, oh = dh * rv;
  std::vector<uint8_t> out(int64_t(ow) * oh);
  auto row = [&](int y) {
    return &in[int64_t(std::min(std::max(y, 0), dh - 1)) * dw];
  };
  bool fancy_h = rh == 2 && dw > 2;   // h2v1 and h2v2: box when dw ≤ 2
  if (rh == 2 && !fancy_h) {          // h2v1_upsample / h2v2_upsample
    for (int y = 0; y < oh; ++y) {
      const uint8_t* ip = row(y / rv);
      uint8_t* op = &out[int64_t(y) * ow];
      for (int x = 0; x < ow; ++x) op[x] = ip[x >> 1];
    }
    return out;
  }
  if (rv == 1) {                       // h2v1_fancy_upsample
    for (int y = 0; y < dh; ++y) {
      const uint8_t* ip = row(y);
      uint8_t* op = &out[int64_t(y) * ow];
      for (int x = 0; x < dw; ++x) {
        int c = ip[x] * 3;
        int l = ip[std::max(x - 1, 0)], r = ip[std::min(x + 1, dw - 1)];
        op[2 * x] = uint8_t((c + l + 1) >> 2);
        op[2 * x + 1] = uint8_t((c + r + 2) >> 2);
      }
    }
    return out;
  }
  std::vector<int> cs(dw);
  for (int y = 0; y < dh; ++y) {
    for (int v = 0; v < 2; ++v) {
      const uint8_t* near = row(y);
      const uint8_t* far = row(v == 0 ? y - 1 : y + 1);
      uint8_t* op = &out[int64_t(2 * y + v) * ow];
      if (rh == 1) {                   // h1v2_fancy_upsample
        int bias = v == 0 ? 1 : 2;
        for (int x = 0; x < dw; ++x)
          op[x] = uint8_t((near[x] * 3 + far[x] + bias) >> 2);
        continue;
      }
      for (int x = 0; x < dw; ++x) cs[x] = near[x] * 3 + far[x];
      for (int x = 0; x < dw; ++x) {   // h2v2_fancy_upsample
        int c = cs[x] * 3;
        int l = cs[std::max(x - 1, 0)], r = cs[std::min(x + 1, dw - 1)];
        op[2 * x] = uint8_t((c + l + 8) >> 4);
        op[2 * x + 1] = uint8_t((c + r + 7) >> 4);
      }
    }
  }
  return out;
}

// jdcolor.c's ycc_rgb_convert tables (SCALEBITS 16).
struct YccTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  YccTables() {
    auto fix = [](double x) { return int64_t(x * 65536.0 + 0.5); };
    for (int i = 0; i < 256; ++i) {
      int64_t x = i - 128;
      cr_r[i] = int((fix(1.40200) * x + 32768) >> 16);
      cb_b[i] = int((fix(1.77200) * x + 32768) >> 16);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + 32768;
    }
  }
};
const YccTables kYcc;

inline uint8_t clamp255(int v) {
  return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v);
}

uint16_t be16(const uint8_t* p) { return uint16_t((p[0] << 8) | p[1]); }
uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | p[3];
}

void read_sof(Jpeg& j, const uint8_t* d, int len, int marker) {
  if (j.frame) broken("JPEG holds two frames");
  if (len < 6) broken("JPEG frame header too short");
  if (d[0] != 8)
    unsupported(std::to_string(d[0]) + "-bit JPEG (only 8-bit is read)");
  j.height = be16(d + 1);
  j.width = be16(d + 3);
  j.ncomp = d[5];
  if (j.height == 0)
    unsupported("JPEG whose height comes in a DNL marker");
  check_size(j.width, j.height);
  if (j.ncomp == 4) unsupported("CMYK/YCCK JPEG (4 components)");
  if (j.ncomp != 1 && j.ncomp != 3)
    unsupported("JPEG with " + std::to_string(j.ncomp) + " components");
  if (len < 6 + 3 * j.ncomp) broken("JPEG frame header too short");
  j.progressive = marker == 0xC2;
  j.hmax = j.vmax = 1;
  for (int i = 0; i < j.ncomp; ++i) {
    Component& c = j.comp[i];
    c.id = d[6 + 3 * i];
    c.h = d[7 + 3 * i] >> 4;
    c.v = d[7 + 3 * i] & 15;
    c.tq = d[8 + 3 * i];
    if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
      broken("JPEG component has bad sampling factors or table");
    j.hmax = std::max(j.hmax, c.h);
    j.vmax = std::max(j.vmax, c.v);
  }
  j.mcux = (j.width + 8 * j.hmax - 1) / (8 * j.hmax);
  j.mcuy = (j.height + 8 * j.vmax - 1) / (8 * j.vmax);
  for (int i = 0; i < j.ncomp; ++i) {
    Component& c = j.comp[i];
    c.dw = int((int64_t(j.width) * c.h + j.hmax - 1) / j.hmax);
    c.dh = int((int64_t(j.height) * c.v + j.vmax - 1) / j.vmax);
    c.cbw = (c.dw + 7) / 8;
    c.cbh = (c.dh + 7) / 8;
    c.bw = j.mcux * c.h;
    c.bh = j.mcuy * c.v;
    c.coef.assign(int64_t(c.bw) * c.bh * 64, 0);
    std::memset(c.bits, -1, sizeof(c.bits));
  }
  j.frame = true;
}

// JPEG annex K.3's Huffman tables, which ffmpeg's MJPEG decoder holds
// until a DHT replaces them (the AVI1 convention of MJPEG packets
// without tables).
const uint8_t kStdBits[4][16] = {
    {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0},
    {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0},
    {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125},
    {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119}};
const uint8_t kStdAcLuma[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kStdAcChroma[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

// The markers and scans of a JPEG: its frame and every component's
// quantized coefficients (`standard_tables`: start from annex K's
// Huffman tables, as ffmpeg does, instead of none).
Jpeg parse_jpeg(const uint8_t* data, size_t n, bool standard_tables) {
  Jpeg j;
  if (standard_tables) {
    static const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10,
                                        11};
    build_huffman(j.dc[0], kStdBits[0], kDcVals, 12);
    build_huffman(j.dc[1], kStdBits[1], kDcVals, 12);
    build_huffman(j.ac[0], kStdBits[2], kStdAcLuma, 162);
    build_huffman(j.ac[1], kStdBits[3], kStdAcChroma, 162);
  }
  if (n < 2 || data[0] != 0xFF || data[1] != 0xD8)
    broken("not a JPEG (no SOI marker)");
  const uint8_t* p = data + 2;
  const uint8_t* end = data + n;
  int scans = 0;
  while (true) {
    // Next marker: 0xFF fill bytes, then its code.
    while (p < end && *p != 0xFF) ++p;
    while (p < end && *p == 0xFF) ++p;
    if (p >= end) broken("JPEG ends before EOI");
    int m = *p++;
    if (m == 0xD9) break;                              // EOI
    if (m == 0x00 || m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01)
      continue;                                        // no length
    if (end - p < 2) broken("JPEG marker segment cut short");
    int len = be16(p);
    if (len < 2 || p + len > end) broken("JPEG marker segment cut short");
    const uint8_t* d = p + 2;
    int dl = len - 2;
    p += len;
    switch (m) {
      case 0xC0: case 0xC1: case 0xC2:
        read_sof(j, d, dl, m);
        break;
      case 0xC3: unsupported("lossless JPEG");
      case 0xC5: case 0xC6: case 0xC7:
      case 0xCD: case 0xCE: case 0xCF:
        unsupported("hierarchical (differential) JPEG");
      case 0xC9: case 0xCA: case 0xCB: case 0xCC:
        unsupported("arithmetic-coded JPEG");
      case 0xC4: {                                     // DHT
        int o = 0;
        while (o < dl) {
          if (dl - o < 17) broken("JPEG Huffman table cut short");
          int tc = d[o] >> 4, th = d[o] & 15;
          if (tc > 1 || th > 3) broken("JPEG Huffman table has a bad index");
          int total = 0;
          for (int i = 0; i < 16; ++i) total += d[o + 1 + i];
          if (total > 256 || dl - o - 17 < total)
            broken("JPEG Huffman table cut short");
          build_huffman(tc ? j.ac[th] : j.dc[th], d + o + 1, d + o + 17,
                        total);
          o += 17 + total;
        }
        break;
      }
      case 0xDB: {                                     // DQT
        int o = 0;
        while (o < dl) {
          int pq = d[o] >> 4, tq = d[o] & 15;
          if (pq > 1 || tq > 3) broken("JPEG quantization table is bad");
          int sz = pq ? 128 : 64;
          if (dl - o - 1 < sz) broken("JPEG quantization table cut short");
          for (int k = 0; k < 64; ++k)
            j.qt[tq][kNatural[k]] = pq ? be16(d + o + 1 + 2 * k)
                                       : d[o + 1 + k];
          j.qdef[tq] = true;
          o += 1 + sz;
        }
        break;
      }
      case 0xDD:                                       // DRI
        if (dl < 2) broken("JPEG restart interval cut short");
        j.restart = be16(d);
        break;
      case 0xDC: unsupported("JPEG with a DNL marker");
      case 0xE0:
        if (dl >= 5 && std::memcmp(d, "JFIF\0", 5) == 0) j.jfif = true;
        break;
      case 0xEE:
        if (dl >= 12 && std::memcmp(d, "Adobe", 5) == 0) j.adobe = d[11];
        break;
      case 0xDA: {                                     // SOS
        if (!j.frame) broken("JPEG scan before its frame header");
        Scan sc;
        if (dl < 1) broken("JPEG scan header cut short");
        sc.ns = d[0];
        if (sc.ns < 1 || sc.ns > j.ncomp || dl < 4 + 2 * sc.ns)
          broken("JPEG scan header is bad");
        for (int i = 0; i < sc.ns; ++i) {
          int id = d[1 + 2 * i], k = 0;
          while (k < j.ncomp && j.comp[k].id != id) ++k;
          if (k == j.ncomp) broken("JPEG scan names an unknown component");
          Component& c = j.comp[k];
          sc.ci[i] = k;
          c.dc_tbl = d[2 + 2 * i] >> 4;
          c.ac_tbl = d[2 + 2 * i] & 15;
          if (c.dc_tbl > 3 || c.ac_tbl > 3) broken("JPEG scan table index");
          if (!c.latched) {                 // latch_quant_tables
            if (!j.qdef[c.tq]) broken("JPEG quantization table missing");
            std::memcpy(c.q, j.qt[c.tq], sizeof(c.q));
            c.latched = true;
          }
        }
        const uint8_t* t = d + 1 + 2 * sc.ns;
        sc.ss = t[0];
        sc.se = t[1];
        sc.ah = t[2] >> 4;
        sc.al = t[2] & 15;
        if (j.progressive) {
          bool ok = sc.ss <= sc.se && sc.se <= 63 && sc.al <= 13 &&
                    sc.ah <= 13 && (sc.ss == 0 ? sc.se == 0 : sc.ns == 1);
          if (!ok) broken("JPEG progressive scan parameters are bad");
        }
        int blocks = 0;
        bool need_dc = !j.progressive || (sc.ss == 0 && sc.ah == 0);
        bool need_ac = !j.progressive || sc.ss > 0;
        for (int i = 0; i < sc.ns; ++i) {
          const Component& c = j.comp[sc.ci[i]];
          blocks += c.h * c.v;
          if ((need_dc && !j.dc[c.dc_tbl].defined) ||
              (need_ac && !j.ac[c.ac_tbl].defined))
            broken("JPEG Huffman table missing");
        }
        if (sc.ns > 1 && blocks > 10)
          broken("JPEG MCU of more than 10 blocks");
        for (int i = 0; i < sc.ns && j.progressive; ++i)
          for (int k = sc.ss; k <= sc.se; ++k)
            j.comp[sc.ci[i]].bits[k] = int8_t(sc.al);
        BitReader br{p, end};
        decode_scan(j, sc, br);
        p = br.p;
        ++scans;
        break;
      }
      default:
        break;                                         // APPn, COM, ...
    }
  }
  if (!j.frame || scans == 0) broken("JPEG holds no image");
  if (j.ncomp == 3) {
    if (j.adobe == 0)
      unsupported("Adobe-transform RGB JPEG (APP14 transform 0)");
    if (j.adobe == 2) unsupported("Adobe-transform YCCK JPEG");
    if (!j.jfif && j.adobe < 0 && j.comp[0].id == 'R' &&
        j.comp[1].id == 'G' && j.comp[2].id == 'B')
      unsupported("RGB-coded JPEG (components R, G, B)");
  }
  for (int i = 0; i < j.ncomp; ++i) {
    if (!j.comp[i].latched) broken("JPEG component never scanned");
    // libjpeg block-smooths a progressive image whose coefficients 0..9
    // are not all read to their last bit; that is not done here.
    for (int k = 0; k < 10 && j.progressive; ++k)
      if (j.comp[i].bits[k] != 0)
        unsupported("progressive JPEG whose scans leave its first "
                    "coefficients incomplete (libjpeg would smooth it)");
  }
  return j;
}

Rgb decode_jpeg(const uint8_t* data, size_t n) {
  Jpeg j = parse_jpeg(data, n, false);
  // The upsampling below takes ratios of 1 and 2 (MJPEG's planes, which
  // libavcodec keeps at 4:1:1 too, are decoded without it).
  for (int i = 0; i < j.ncomp && j.ncomp > 1; ++i) {
    const Component& c = j.comp[i];
    if ((j.hmax % c.h) || (j.vmax % c.v) || j.hmax / c.h > 2 ||
        j.vmax / c.v > 2)
      unsupported("JPEG sampling ratio other than 1 or 2");
  }

  Rgb img;
  img.w = j.width;
  img.h = j.height;
  img.px.resize(int64_t(img.w) * img.h * 3);
  std::vector<uint8_t> planes[3];
  int stride[3];
  for (int i = 0; i < j.ncomp; ++i) {
    const Component& c = j.comp[i];
    int rh = j.ncomp > 1 ? j.hmax / c.h : 1;
    int rv = j.ncomp > 1 ? j.vmax / c.v : 1;
    planes[i] = upsample(component_plane(c), c.dw, c.dh, rh, rv);
    stride[i] = c.dw * rh;
  }
  for (int y = 0; y < img.h; ++y) {
    uint8_t* o = &img.px[int64_t(y) * img.w * 3];
    if (j.ncomp == 1) {
      const uint8_t* yp = &planes[0][int64_t(y) * stride[0]];
      for (int x = 0; x < img.w; ++x)
        o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = yp[x];
      continue;
    }
    const uint8_t* yp = &planes[0][int64_t(y) * stride[0]];
    const uint8_t* cb = &planes[1][int64_t(y) * stride[1]];
    const uint8_t* cr = &planes[2][int64_t(y) * stride[2]];
    for (int x = 0; x < img.w; ++x) {
      int yy = yp[x];
      o[3 * x] = clamp255(yy + kYcc.cr_r[cr[x]]);
      o[3 * x + 1] =
          clamp255(yy + int((kYcc.cb_g[cb[x]] + kYcc.cr_g[cr[x]]) >> 16));
      o[3 * x + 2] = clamp255(yy + kYcc.cb_b[cb[x]]);
    }
  }
  return img;
}

// =====================================================================
// PNG
// =====================================================================

uint32_t crc32(const uint8_t* p, size_t n) {
  static const auto table = [] {
    std::vector<uint32_t> t(256);
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = c & 1 ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      t[i] = c;
    }
    return t;
  }();
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < n; ++i) c = table[(c ^ p[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

inline int paeth(int a, int b, int c) {
  int p = a + b - c, pa = std::abs(p - a), pb = std::abs(p - b),
      pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

// Undo the row filters of a (rows, 1 + rowbytes) block in place.
void unfilter(uint8_t* data, int rows, int rowbytes, int bpp) {
  std::vector<uint8_t> zero(rowbytes, 0);
  const uint8_t* prev = zero.data();
  for (int y = 0; y < rows; ++y) {
    uint8_t* r = data + int64_t(y) * (rowbytes + 1);
    int ft = r[0];
    uint8_t* c = r + 1;
    switch (ft) {
      case 0: break;
      case 1:
        for (int i = bpp; i < rowbytes; ++i) c[i] = uint8_t(c[i] + c[i - bpp]);
        break;
      case 2:
        for (int i = 0; i < rowbytes; ++i) c[i] = uint8_t(c[i] + prev[i]);
        break;
      case 3:
        for (int i = 0; i < rowbytes; ++i)
          c[i] = uint8_t(c[i] + (((i >= bpp ? c[i - bpp] : 0) + prev[i]) >> 1));
        break;
      case 4:
        for (int i = 0; i < rowbytes; ++i)
          c[i] = uint8_t(c[i] + paeth(i >= bpp ? c[i - bpp] : 0, prev[i],
                                      i >= bpp ? prev[i - bpp] : 0));
        break;
      default:
        broken("PNG row filter " + std::to_string(ft) + " is unknown");
    }
    prev = c;
  }
}

// The chunks, inflate, the row filters and Adam7 → the samples as the
// file packs them, rows of the whole image.
viai_png::Image parse_png(const uint8_t* data, size_t n, bool check_crc) {
  if (n < 8 || std::memcmp(data, "\x89PNG\r\n\x1a\n", 8) != 0)
    broken("PNG signature missing");
  size_t o = 8;
  viai_png::Image img;
  int w = 0, h = 0, depth = 0, ctype = 0, interlace = 0;
  bool ihdr = false, iend = false;
  std::vector<uint8_t> idat;
  while (o + 12 <= n) {
    uint32_t len = be32(data + o);
    if (len > n - o - 12) broken("PNG chunk runs past the file");
    const uint8_t* type = data + o + 4;
    const uint8_t* d = data + o + 8;
    if (check_crc && crc32(type, len + 4) != be32(d + len))
      broken(std::string("PNG chunk ") + std::string((const char*)type, 4) +
             " fails its CRC");
    if (!ihdr && std::memcmp(type, "IHDR", 4) != 0)
      broken("PNG does not start with IHDR");
    if (std::memcmp(type, "IHDR", 4) == 0) {
      if (len != 13) broken("PNG IHDR has the wrong length");
      w = int(std::min<uint32_t>(be32(d), 0x7fffffff));
      h = int(std::min<uint32_t>(be32(d + 4), 0x7fffffff));
      depth = d[8];
      ctype = d[9];
      interlace = d[12];
      check_size(w, h);
      bool ok = (ctype == 0 && (depth == 1 || depth == 2 || depth == 4 ||
                                depth == 8 || depth == 16)) ||
                (ctype == 3 && (depth == 1 || depth == 2 || depth == 4 ||
                                depth == 8)) ||
                ((ctype == 2 || ctype == 4 || ctype == 6) &&
                 (depth == 8 || depth == 16));
      if (!ok) broken("PNG colour type and depth do not go together");
      if (d[10] != 0 || d[11] != 0 || interlace > 1)
        broken("PNG compression, filter or interlace method is unknown");
      ihdr = true;
    } else if (std::memcmp(type, "PLTE", 4) == 0) {
      if (len % 3 || len > 768) broken("PNG palette has a bad length");
      img.npal = int(len / 3);
      std::memcpy(img.pal, d, len);
    } else if (std::memcmp(type, "tRNS", 4) == 0) {
      img.trns.assign(d, d + len);
    } else if (std::memcmp(type, "IDAT", 4) == 0) {
      idat.insert(idat.end(), d, d + len);
    } else if (std::memcmp(type, "IEND", 4) == 0) {
      iend = true;
      break;
    }
    o += 12 + len;
  }
  if (!ihdr || !iend) broken("PNG ends before IEND");
  int channels = ctype == 0 || ctype == 3 ? 1 : ctype == 4 ? 2
                 : ctype == 2 ? 3 : 4;
  int bitspp = channels * depth;
  int bpp = std::max(1, bitspp / 8);
  static const int ax0[7] = {0, 4, 0, 2, 0, 1, 0};
  static const int ay0[7] = {0, 0, 4, 0, 2, 0, 1};
  static const int adx[7] = {8, 8, 4, 4, 2, 2, 1};
  static const int ady[7] = {8, 8, 8, 4, 4, 2, 2};
  struct Pass { int x0, y0, dx, dy, pw, ph; int64_t rowbytes, off; };
  std::vector<Pass> passes;
  int64_t want = 0;
  for (int k = 0; k < (interlace ? 7 : 1); ++k) {
    Pass ps;
    ps.x0 = interlace ? ax0[k] : 0;
    ps.y0 = interlace ? ay0[k] : 0;
    ps.dx = interlace ? adx[k] : 1;
    ps.dy = interlace ? ady[k] : 1;
    ps.pw = w > ps.x0 ? (w - ps.x0 + ps.dx - 1) / ps.dx : 0;
    ps.ph = h > ps.y0 ? (h - ps.y0 + ps.dy - 1) / ps.dy : 0;
    ps.rowbytes = (int64_t(ps.pw) * bitspp + 7) / 8;
    ps.off = want;
    if (ps.pw && ps.ph) want += ps.ph * (ps.rowbytes + 1);
    passes.push_back(ps);
  }
  std::vector<uint8_t> raw;
  try {
    raw = viai_inflate::inflate_zlib(idat.data(), idat.size(), size_t(want));
  } catch (const viai_inflate::Error& e) {
    broken("PNG image data " + e.msg);
  }
  img.w = w;
  img.h = h;
  img.depth = depth;
  img.ctype = ctype;
  img.interlaced = interlace != 0;
  img.rowbytes = (int64_t(w) * bitspp + 7) / 8;
  img.rows.assign(size_t(img.rowbytes * h), 0);
  for (const Pass& ps : passes) {
    if (!ps.pw || !ps.ph) continue;
    uint8_t* block = raw.data() + ps.off;
    unfilter(block, ps.ph, int(ps.rowbytes), bpp);
    for (int y = 0; y < ps.ph; ++y) {
      const uint8_t* r = block + int64_t(y) * (ps.rowbytes + 1) + 1;
      uint8_t* orow = &img.rows[size_t(int64_t(ps.y0 + y * ps.dy) *
                                       img.rowbytes)];
      if (!interlace) {
        std::memcpy(orow, r, size_t(ps.rowbytes));
        continue;
      }
      for (int x = 0; x < ps.pw; ++x) {
        const int64_t ox = ps.x0 + int64_t(x) * ps.dx;
        if (depth < 8) {
          const int64_t sb = int64_t(x) * depth, db = ox * depth;
          const int s = (r[sb >> 3] >> (8 - depth - (sb & 7))) &
                        ((1 << depth) - 1);
          orow[db >> 3] = uint8_t(orow[db >> 3] |
                                  (s << (8 - depth - (db & 7))));
        } else {
          std::memcpy(orow + ox * (bitspp / 8), r + int64_t(x) * (bitspp / 8),
                      size_t(bitspp / 8));
        }
      }
    }
  }
  return img;
}

Rgb decode_png(const uint8_t* data, size_t n) {
  const viai_png::Image png = parse_png(data, n, true);
  const int w = png.w, h = png.h, depth = png.depth, ctype = png.ctype;
  if (ctype == 3 && png.npal < 0) broken("PNG palette missing");
  const int channels = ctype == 0 || ctype == 3 ? 1 : ctype == 4 ? 2
                       : ctype == 2 ? 3 : 4;
  auto lookup = [&](uint8_t* op, int s) {   // past the palette: black
    for (int c = 0; c < 3; ++c) op[c] = s < png.npal ? png.pal[3 * s + c] : 0;
  };
  Rgb img;
  img.w = w;
  img.h = h;
  img.px.resize(int64_t(w) * h * 3);
  for (int y = 0; y < h; ++y) {
    const uint8_t* r = &png.rows[size_t(int64_t(y) * png.rowbytes)];
    uint8_t* orow = &img.px[int64_t(y) * w * 3];
    for (int x = 0; x < w; ++x) {
      uint8_t* op = orow + int64_t(x) * 3;
      if (depth < 8) {
        int64_t bit = int64_t(x) * depth;
        int s = (r[bit >> 3] >> (8 - depth - (bit & 7))) & ((1 << depth) - 1);
        if (ctype == 3) {
          lookup(op, s);
        } else {
          int scale = depth == 1 ? 255 : depth == 2 ? 0x55 : 0x11;
          op[0] = op[1] = op[2] = uint8_t(s * scale);
        }
        continue;
      }
      const uint8_t* sp = r + int64_t(x) * channels * (depth / 8);
      int step = depth / 8;                            // high byte first
      switch (ctype) {
        case 0:
          op[0] = op[1] = op[2] =
              depth == 8 ? sp[0] : uint8_t(sp[0] ? 255 : sp[1]);
          break;
        case 3:
          lookup(op, sp[0]);
          break;
        case 4:
          op[0] = op[1] = op[2] = sp[0];
          break;
        default:                                       // 2 and 6
          op[0] = sp[0]; op[1] = sp[step]; op[2] = sp[2 * step];
      }
    }
  }
  return img;
}

// =====================================================================
// Dispatch, resize, the directory reader
// =====================================================================

Rgb decode_image(const uint8_t* d, size_t n) {
  if (n >= 3 && d[0] == 0xFF && d[1] == 0xD8 && d[2] == 0xFF)
    return decode_jpeg(d, n);
  if (n >= 8 && std::memcmp(d, "\x89PNG\r\n\x1a\n", 8) == 0)
    return decode_png(d, n);
  if (n >= 6 && (std::memcmp(d, "GIF87a", 6) == 0 ||
                 std::memcmp(d, "GIF89a", 6) == 0))
    unsupported("GIF image (only JPEG and PNG are read)");
  if (n >= 12 && std::memcmp(d, "RIFF", 4) == 0 &&
      std::memcmp(d + 8, "WEBP", 4) == 0)
    unsupported("WebP image (only JPEG and PNG are read)");
  if (n >= 2 && d[0] == 'B' && d[1] == 'M')
    unsupported("BMP image (only JPEG and PNG are read)");
  if (n >= 4 && (std::memcmp(d, "II*\0", 4) == 0 ||
                 std::memcmp(d, "MM\0*", 4) == 0))
    unsupported("TIFF image (only JPEG and PNG are read)");
  broken("not a JPEG or PNG image");
}

struct PillowCoeffs {
  int ksize = 0;
  std::vector<int> lo, n;   // per output: first input, number of inputs
  std::vector<int32_t> k;   // (out, ksize), 22 fractional bits
};

// libImaging/Resample.c precompute_coeffs + normalize_coeffs_8bpc.
PillowCoeffs pillow_coeffs(int n_in, int n_out) {
  PillowCoeffs c;
  double scale = double(float(n_in) - 0.0f) / n_out;
  double filterscale = scale < 1.0 ? 1.0 : scale;
  double support = 1.0 * filterscale;
  c.ksize = int(std::ceil(support)) * 2 + 1;
  c.lo.resize(n_out);
  c.n.resize(n_out);
  c.k.assign(int64_t(n_out) * c.ksize, 0);
  std::vector<double> w(c.ksize);
  for (int xx = 0; xx < n_out; ++xx) {
    double center = 0.0 + (xx + 0.5) * scale;
    double ww = 0.0, ss = 1.0 / filterscale;
    int xmin = int(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = int(center + support + 0.5);
    if (xmax > n_in) xmax = n_in;
    xmax -= xmin;
    for (int x = 0; x < xmax; ++x) {
      double t = (x + xmin - center + 0.5) * ss;
      if (t < 0.0) t = -t;
      w[x] = t < 1.0 ? 1.0 - t : 0.0;
      ww += w[x];
    }
    for (int x = 0; x < xmax; ++x) {
      double v = ww != 0.0 ? w[x] / ww : w[x];
      c.k[int64_t(xx) * c.ksize + x] =
          int32_t(v < 0 ? -0.5 + v * (1 << 22) : 0.5 + v * (1 << 22));
    }
    c.lo[xx] = xmin;
    c.n[xx] = xmax;
  }
  return c;
}

inline uint8_t clip8(int32_t v) {
  v >>= 22;
  return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v);
}

// Pillow's resize((size, size), BILINEAR) of an 8-bit RGB image, then
// float32 / 255 into `out` (size, size, 3).
void resize_to(const Rgb& img, int size, float* out) {
  std::vector<uint8_t> tmp;
  const uint8_t* src = img.px.data();
  int w = img.w, h = img.h;
  if (w != size) {
    PillowCoeffs c = pillow_coeffs(w, size);
    tmp.resize(int64_t(h) * size * 3);
    for (int y = 0; y < h; ++y)
      for (int xx = 0; xx < size; ++xx) {
        const int32_t* k = &c.k[int64_t(xx) * c.ksize];
        const uint8_t* p = src + (int64_t(y) * w + c.lo[xx]) * 3;
        for (int ch = 0; ch < 3; ++ch) {
          int32_t acc = 1 << 21;
          for (int x = 0; x < c.n[xx]; ++x) acc += p[3 * x + ch] * k[x];
          tmp[(int64_t(y) * size + xx) * 3 + ch] = clip8(acc);
        }
      }
    src = tmp.data();
    w = size;
  }
  std::vector<uint8_t> tmp2;
  if (h != size) {
    PillowCoeffs c = pillow_coeffs(h, size);
    tmp2.resize(int64_t(size) * w * 3);
    for (int yy = 0; yy < size; ++yy) {
      const int32_t* k = &c.k[int64_t(yy) * c.ksize];
      for (int x = 0; x < w * 3; ++x) {
        int32_t acc = 1 << 21;
        for (int y = 0; y < c.n[yy]; ++y)
          acc += src[(int64_t(c.lo[yy] + y) * w) * 3 + x] * k[y];
        tmp2[int64_t(yy) * w * 3 + x] = clip8(acc);
      }
    }
    src = tmp2.data();
  }
  for (int64_t i = 0; i < int64_t(size) * size * 3; ++i)
    out[i] = float(src[i]) / 255.0f;
}

std::vector<uint8_t> read_file(const std::string& path) {
  FILE* f = std::fopen(path.c_str(), "rb");
  if (!f) broken("cannot open");
  std::vector<uint8_t> out;
  uint8_t chunk[1 << 16];
  size_t got;
  while ((got = std::fread(chunk, 1, sizeof(chunk), f)) > 0)
    out.insert(out.end(), chunk, chunk + got);
  bool err = std::ferror(f);
  std::fclose(f);
  if (err) broken("cannot read");
  return out;
}

bool is_frame_name(const std::string& s) {
  std::string low = s.substr(s.size() > 5 ? s.size() - 5 : 0);
  for (char& ch : low)
    if (ch >= 'A' && ch <= 'Z') ch = char(ch - 'A' + 'a');
  auto ends = [&](const char* suf) {
    size_t k = std::strlen(suf);
    return low.size() >= k && low.compare(low.size() - k, k, suf) == 0;
  };
  return ends(".jpg") || ends(".jpeg") || ends(".png");
}

void set_error(char* err, int errlen, const std::string& msg) {
  if (err && errlen > 0) {
    std::snprintf(err, size_t(errlen), "%s", msg.c_str());
  }
}

}  // namespace

namespace viai_jpeg {

Coefficients decode_coefficients(const uint8_t* data, size_t n,
                                 bool standard_tables) {
  try {
    Jpeg j = parse_jpeg(data, n, standard_tables);
    Coefficients out;
    out.width = j.width;
    out.height = j.height;
    out.ncomp = j.ncomp;
    out.hmax = j.hmax;
    out.vmax = j.vmax;
    for (int i = 0; i < j.ncomp; ++i) {
      const Component& c = j.comp[i];
      Plane& p = out.comp[i];
      p.h = c.h;
      p.v = c.v;
      p.dw = c.dw;
      p.dh = c.dh;
      p.bw = c.bw;
      p.cbw = c.cbw;
      p.cbh = c.cbh;
      std::memcpy(p.q, c.q, sizeof(p.q));
      p.coef = c.coef;
    }
    return out;
  } catch (const DecodeError& e) {
    throw Error{e.code, e.msg};
  }
}

}  // namespace viai_jpeg

namespace viai_png {

Image parse(const uint8_t* data, size_t n, bool check_crc) {
  try {
    return parse_png(data, n, check_crc);
  } catch (const DecodeError& e) {
    throw Error{e.code, e.msg};
  }
}

}  // namespace viai_png

extern "C" {

// Decode JPEG or PNG bytes. → a malloc'd (h, w, 3) uint8 buffer (free it
// with viai_image_free), hw = (h, w); nullptr on failure with *code 1
// (broken) or 2 (unsupported) and the cause in err.
uint8_t* viai_decode_image(const uint8_t* data, int64_t n, int32_t* hw,
                           int32_t* code, char* err, int32_t errlen) {
  try {
    Rgb img = decode_image(data, size_t(n));
    uint8_t* out = static_cast<uint8_t*>(std::malloc(img.px.size()));
    if (!out) broken("out of memory");
    std::memcpy(out, img.px.data(), img.px.size());
    hw[0] = img.h;
    hw[1] = img.w;
    *code = 0;
    return out;
  } catch (const DecodeError& e) {
    *code = e.code;
    set_error(err, errlen, e.msg);
  } catch (const std::bad_alloc&) {
    *code = 1;
    set_error(err, errlen, "out of memory");
  }
  return nullptr;
}

void viai_image_free(uint8_t* p) { std::free(p); }

// A directory of frames → out (n_frames, size, size, 3) float32: the
// sorted .jpg/.jpeg/.png names (any case), the window's frames by
// viai_tpu's rule, each decoded once over up to `threads` threads
// (created for this call), resized as Pillow's BILINEAR does, / 255.
// → 0, or 1 broken / 2 unsupported / 3 no frames with err set.
int32_t viai_load_frame_dir(const char* dir, int32_t n_frames, int32_t size,
                            double w0, double w1, int32_t threads, float* out,
                            char* err, int32_t errlen) {
  if (n_frames < 1 || size < 1) {
    set_error(err, errlen, "n_frames and size must be positive");
    return 1;
  }
  std::vector<std::string> names;
  DIR* dp = opendir(dir);
  if (!dp) {
    set_error(err, errlen, std::string(dir) + ": cannot open the directory");
    return 3;
  }
  while (struct dirent* e = readdir(dp)) {
    std::string name = e->d_name;
    if (is_frame_name(name)) names.push_back(name);
  }
  closedir(dp);
  if (names.empty()) {
    set_error(err, errlen, std::string("no frames in ") + dir);
    return 3;
  }
  std::sort(names.begin(), names.end());
  std::vector<int64_t> idx =
      viai_window::window_indices(int64_t(names.size()), n_frames, w0, w1);
  std::vector<int64_t> unique(idx);
  std::sort(unique.begin(), unique.end());
  unique.erase(std::unique(unique.begin(), unique.end()), unique.end());
  int n_threads = std::max(1, std::min<int>(threads, int(unique.size())));
  std::atomic<size_t> next{0};
  std::mutex mu;
  int code = 0;
  std::string msg;
  const int64_t frame = int64_t(size) * size * 3;
  auto work = [&]() {
    for (size_t u; (u = next.fetch_add(1)) < unique.size();) {
      std::string path = std::string(dir) + "/" + names[unique[u]];
      try {
        std::vector<uint8_t> bytes = read_file(path);
        Rgb img = decode_image(bytes.data(), bytes.size());
        int first = -1;
        for (int i = 0; i < n_frames; ++i) {
          if (idx[i] != unique[u]) continue;
          if (first < 0) {
            resize_to(img, size, out + i * frame);
            first = i;
          } else {
            std::memcpy(out + i * frame, out + first * frame,
                        sizeof(float) * frame);
          }
        }
      } catch (const DecodeError& e) {
        std::lock_guard<std::mutex> lock(mu);
        if (!code) {
          code = e.code;
          msg = path + ": " + e.msg;
        }
      } catch (const std::bad_alloc&) {
        std::lock_guard<std::mutex> lock(mu);
        if (!code) {
          code = 1;
          msg = path + ": out of memory";
        }
      }
    }
  };
  std::vector<std::thread> pool;
  for (int t = 1; t < n_threads; ++t) pool.emplace_back(work);
  work();
  for (auto& t : pool) t.join();
  if (code) set_error(err, errlen, msg);
  return code;
}

}  // extern "C"
