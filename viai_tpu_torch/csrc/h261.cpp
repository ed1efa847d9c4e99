// libavcodec's H.261 decoder (h261dec.c, h261.c; mpegvideo's H.261
// motion and dequantisation), for viai_tpu_torch's video reader:
//
//   * the picture header (PSC, TR, PTYPE: QCIF or CIF, PEI);
//   * GOBs of 33 macroblocks (GN, GQUANT, GEI), found as libavcodec finds
//     them: the start code read as an MBA, or at the picture's start;
//   * MBA (differences, stuffing), MTYPE, MQUANT, integer-pel MVD
//     predicted from the macroblock before in the GOB row, CBP, TCOEF
//     with the first inter coefficient's short code and H.261's escape;
//   * macroblocks MBA skips copied from the reference;
//   * the in-loop filter (FIL) of the motion-compensated prediction;
//   * H.263's dequantisation and ffmpeg's simple IDCT (videodec.cpp).
//
// Every picture is a P picture, as libavcodec takes them; one before any
// reference predicts from mid-grey (libavcodec's dummy picture).

#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include "mpeg_bits.h"
#include "video.h"

namespace viai_video {

namespace {

using mpeg::Bits;
using mpeg::kZigzag;
using mpeg::Plane;
using mpeg::Vlc;

// The tables of h261data.o: the MBA codes (33 stuffing, 34 the GOB start
// code), MTYPE, the vector difference magnitudes, CBP (index cbp − 1),
// TCOEF (0 end of block, 64 the escape) with each code's run and level.
const uint8_t kMba[35][2] = {
    1, 1, 3, 3, 2, 3, 3, 4, 2, 4, 3, 5, 2, 5, 7, 7,
    6, 7, 11, 8, 10, 8, 9, 8, 8, 8, 7, 8, 6, 8, 23, 10,
    22, 10, 21, 10, 20, 10, 19, 10, 18, 10, 35, 11, 34, 11, 33, 11,
    32, 11, 31, 11, 30, 11, 29, 11, 28, 11, 27, 11, 26, 11, 25, 11,
    24, 11, 15, 11, 1, 16,
};
const uint8_t kMtype[10][2] = {
    1, 4, 1, 7, 1, 1, 1, 5, 1, 9, 1, 8, 1, 10, 1, 3,
    1, 2, 1, 6,
};
const uint8_t kMvTab[17][2] = {
    1, 1, 1, 2, 1, 3, 1, 4, 3, 6, 5, 7, 4, 7, 3, 7,
    11, 9, 10, 9, 9, 9, 17, 10, 16, 10, 15, 10, 14, 10, 13, 10,
    12, 10,
};
const uint8_t kCbpTab[63][2] = {
    11, 5, 9, 5, 13, 6, 13, 4, 23, 7, 19, 7, 31, 8, 12, 4,
    22, 7, 18, 7, 30, 8, 19, 5, 27, 8, 23, 8, 19, 8, 11, 4,
    21, 7, 17, 7, 29, 8, 17, 5, 25, 8, 21, 8, 17, 8, 15, 6,
    15, 8, 13, 8, 3, 9, 15, 5, 11, 8, 7, 8, 7, 9, 10, 4,
    20, 7, 16, 7, 28, 8, 14, 6, 14, 8, 12, 8, 2, 9, 16, 5,
    24, 8, 20, 8, 16, 8, 14, 5, 10, 8, 6, 8, 6, 9, 18, 5,
    26, 8, 22, 8, 18, 8, 13, 5, 9, 8, 5, 8, 5, 9, 12, 5,
    8, 8, 4, 8, 4, 9, 7, 3, 10, 5, 8, 5, 12, 6,
};
const uint16_t kTcoeffVlc[65][2] = {
    2, 2, 3, 2, 4, 4, 5, 5, 6, 7, 38, 8, 33, 8, 10, 10,
    29, 12, 24, 12, 19, 12, 16, 12, 26, 13, 25, 13, 24, 13, 23, 13,
    3, 3, 6, 6, 37, 8, 12, 10, 27, 12, 22, 13, 21, 13, 5, 4,
    4, 7, 11, 10, 20, 12, 20, 13, 7, 5, 36, 8, 28, 12, 19, 13,
    6, 5, 15, 10, 18, 12, 7, 6, 9, 10, 18, 13, 5, 6, 30, 12,
    4, 6, 21, 12, 7, 7, 17, 12, 5, 7, 17, 13, 39, 8, 16, 13,
    35, 8, 34, 8, 32, 8, 14, 10, 13, 10, 8, 10, 31, 12, 26, 12,
    25, 12, 23, 12, 22, 12, 31, 13, 30, 13, 29, 13, 28, 13, 27, 13,
    1, 6,
};
const int8_t kTcoeffRun[64] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 2, 3, 3, 3, 3,
    4, 4, 4, 5, 5, 5, 6, 6, 7, 7, 8, 8, 9, 9, 10, 10,
    11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26,
};
const int8_t kTcoeffLevel[64] = {
    0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
    1, 2, 3, 4, 5, 6, 7, 1, 2, 3, 4, 5, 1, 2, 3, 4,
    1, 2, 3, 1, 2, 3, 1, 2, 1, 2, 1, 2, 1, 2, 1, 2,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
};

const Vlc& mba_vlc() {
  static const Vlc v(kMba, 35, 16);
  return v;
}
const Vlc& mtype_vlc() {
  static const Vlc v(kMtype, 10, 10);
  return v;
}
const Vlc& mv_vlc() {
  static const Vlc v(kMvTab, 17, 10);
  return v;
}
const Vlc& cbp_vlc() {
  static const Vlc v(kCbpTab, 63, 9);
  return v;
}
const Vlc& tcoeff_vlc() {
  static const Vlc v(kTcoeffVlc, 65, 13);
  return v;
}

// ff_h261_mtype_map's flags by MTYPE code.
enum : int { kIntra = 1, kQuant = 2, kCbp = 4, kMc = 8, kFil = 16 };
constexpr int kMtypeMap[10] = {
    kIntra, kIntra | kQuant, kCbp, kQuant | kCbp, kMc, kCbp | kMc,
    kQuant | kCbp | kMc, kMc | kFil, kCbp | kMc | kFil,
    kQuant | kCbp | kMc | kFil};

constexpr int kStuffing = 33, kStartCode = 34;

inline int clip(int v, int lo, int hi) { return v < lo ? lo : v > hi ? hi : v; }

// h261_loop_filter: the separable (1, 2, 1) / 4 filter of an 8x8 block,
// its edge rows and columns left as they are along the edge.
void loop_filter(uint8_t* src, int stride) {
  int temp[64];
  for (int x = 0; x < 8; ++x) {
    temp[x] = 4 * src[x];
    temp[x + 56] = 4 * src[x + 7 * stride];
  }
  for (int y = 1; y < 7; ++y)
    for (int x = 0; x < 8; ++x) {
      const int xy = y * stride + x;
      temp[8 * y + x] = src[xy - stride] + 2 * src[xy] + src[xy + stride];
    }
  for (int y = 0; y < 8; ++y) {
    src[y * stride] = uint8_t((temp[8 * y] + 2) >> 2);
    src[y * stride + 7] = uint8_t((temp[8 * y + 7] + 2) >> 2);
    for (int x = 1; x < 7; ++x) {
      const int yz = 8 * y + x;
      src[y * stride + x] =
          uint8_t((temp[yz - 1] + 2 * temp[yz] + temp[yz + 1] + 8) >> 4);
    }
  }
}

// h261_decode_picture_header's start code search and source format.
bool header(Bits& b, int& w, int& h) {
  uint32_t sc = 0;
  for (long i = b.left(); i > 24; --i) {
    sc = ((sc << 1) | uint32_t(b.get1())) & 0xFFFFF;
    if (sc == 0x10) break;
  }
  if (sc != 0x10) return false;
  b.skip(5 + 3);                    // TR; split screen, camera, freeze
  const bool cif = b.get1();
  w = cif ? 352 : 176;
  h = cif ? 288 : 144;
  b.skip(2);                        // still image mode, reserved
  return true;
}

}  // namespace

struct H261Decoder::State {
  int width = 0, height = 0, mbw = 0, mbh = 0;
  struct Pic {
    std::vector<uint8_t> y, u, v;
  } cur, ref;
  int qscale = 1, gob = 0, mba = 0, mba_diff = 0, mv_x = 0, mv_y = 0;
  bool start_code_read = false;     // gob_start_code_skipped
  int mb_x = 0, mb_y = 0, mtype = 0;
  std::vector<uint8_t> done;        // the macroblocks this picture wrote
  alignas(16) int16_t block[6][64];
  int last_index[6];

  [[noreturn]] void bad(const std::string& m) const {
    broken("H261 video: " + m + " at macroblock (" + std::to_string(mb_x) +
           ", " + std::to_string(mb_y) + ")");
  }

  void set_size(int w, int h) {
    width = w;
    height = h;
    mbw = w / 16;
    mbh = h / 16;
    for (Pic* p : {&cur, &ref}) {
      p->y.assign(size_t(w) * h, 0x80);
      p->u.assign(size_t(w) * h / 4, 0x80);
      p->v.assign(size_t(w) * h / 4, 0x80);
    }
    done.assign(size_t(mbw) * mbh, 0);
  }

  // h261_decode_gob_header (its start code already read as an MBA, or
  // looked for here); false where libavcodec takes it for none.
  bool gob_header(Bits& b) {
    if (!start_code_read) {
      if (b.peek(15)) return false;
      b.skip(16);
    }
    start_code_read = false;
    gob = int(b.get(4));
    qscale = int(b.get(5));
    if (mbh == 18 ? gob <= 0 || gob > 12 : gob != 1 && gob != 3 && gob != 5)
      return false;
    while (b.get1()) b.skip(8);     // GEI, GSPARE
    mba = mba_diff = 0;
    return true;
  }

  // h261_resync without its byte-by-byte search (libavcodec's has no
  // slice start to search from).
  bool resync(Bits& b) {
    if (start_code_read) return gob_header(b);
    return b.peek(15) == 0 && gob_header(b);
  }

  // decode_mv_component: the difference's magnitude, its sign bit, the
  // vector kept within ±15.
  static int mv_component(Bits& b, int v) {
    int d = mv_vlc().read(b);
    if (d < 0) return v;
    d = -d;
    if (d && !b.get1()) d = -d;
    v += d;
    if (v <= -16) v += 32;
    else if (v >= 16) v -= 32;
    return v;
  }

  // h261_decode_block: raw levels in natural order.
  void decode_block(Bits& b, int16_t* blk, int n, bool coded, bool intra) {
    int i = 0;
    if (intra) {
      int level = int(b.get(8));
      if ((level & 0x7F) == 0) bad("illegal DC");
      if (level == 255) level = 128;
      blk[0] = int16_t(level);
      i = 1;
    } else if (coded) {
      const int check = int(b.peek(2));   // the first coefficient's "1s"
      if (check & 2) {
        b.skip(2);
        blk[0] = int16_t(check & 1 ? -1 : 1);
        i = 1;
      }
    }
    if (!coded) {
      last_index[n] = i - 1;
      return;
    }
    --i;
    for (;;) {
      int sym = tcoeff_vlc().read(b);
      if (sym < 0) bad("illegal AC code");
      int run, level;
      if (sym == 64) {
        run = int(b.get(6)) + 1;
        level = int(int8_t(b.get(8)));
      } else if (sym == 0) {
        break;                      // end of block
      } else {
        run = kTcoeffRun[sym] + 1;
        level = kTcoeffLevel[sym];
        if (b.get1()) level = -level;
      }
      i += run;
      if (i >= 64) bad("run overflow");
      blk[kZigzag[i]] = int16_t(level);
    }
    last_index[n] = i;
  }

  uint8_t* dest(Pic& p, int n) {
    if (n < 4)
      return &p.y[size_t(16 * mb_y + 8 * (n >> 1)) * width + 16 * mb_x +
                   8 * (n & 1)];
    return &(n == 4 ? p.u : p.v)[size_t(8 * mb_y) * (width / 2) + 8 * mb_x];
  }

  // dct_unquantize_h263_intra / _inter at the macroblock's quantiser.
  void unquant(int16_t* blk, bool intra) const {
    const int qmul = qscale << 1, qadd = (qscale - 1) | 1;
    int start = 0;
    if (intra) {
      blk[0] = int16_t(blk[0] * 8);
      start = 1;
    }
    for (int i = start; i < 64; ++i) {
      const int l = blk[i];
      if (l) blk[i] = int16_t(l < 0 ? l * qmul - qadd : l * qmul + qadd);
    }
  }

  // ff_mpv_reconstruct_mb: intra blocks put; else the reference moved by
  // the integer vector (chroma by half of it, truncated), filtered where
  // MTYPE says FIL, the residual added.
  void reconstruct(bool intra, int mvx, int mvy) {
    const int cs = width / 2;
    done[size_t(mb_y) * mbw + mb_x] = 1;
    if (intra) {
      for (int n = 0; n < 6; ++n) {
        unquant(block[n], true);
        idct_put(block[n], dest(cur, n), n < 4 ? width : cs);
      }
      return;
    }
    const Plane py{ref.y.data(), width, width, height};
    const Plane pu{ref.u.data(), cs, cs, height / 2};
    const Plane pv{ref.v.data(), cs, cs, height / 2};
    uint8_t* dy = dest(cur, 0);
    for (int y = 0; y < 16; ++y)
      for (int x = 0; x < 16; ++x)
        dy[size_t(y) * width + x] =
            uint8_t(py.at(16 * mb_x + mvx + x, 16 * mb_y + mvy + y));
    const int cx = 8 * mb_x + mvx / 2, cy = 8 * mb_y + mvy / 2;
    uint8_t *du = dest(cur, 4), *dv = dest(cur, 5);
    for (int y = 0; y < 8; ++y)
      for (int x = 0; x < 8; ++x) {
        du[size_t(y) * cs + x] = uint8_t(pu.at(cx + x, cy + y));
        dv[size_t(y) * cs + x] = uint8_t(pv.at(cx + x, cy + y));
      }
    if (mtype & kFil) {
      for (int n = 0; n < 4; ++n) loop_filter(dest(cur, n), width);
      loop_filter(du, cs);
      loop_filter(dv, cs);
    }
    for (int n = 0; n < 6; ++n) {
      if (last_index[n] < 0) continue;
      unquant(block[n], false);
      idct_add(block[n], dest(cur, n), n < 4 ? width : cs);
    }
  }

  void place(int k) {
    mb_x = ((gob - 1) % 2) * 11 + k % 11;
    mb_y = ((gob - 1) / 2) * 3 + k / 11;
  }

  // h261_decode_mb_skipped: macroblocks k0 .. k1 − 1 of the GOB copied.
  void skipped(int k0, int k1) {
    for (int k = k0; k < k1; ++k) {
      place(k);
      mtype &= ~kFil;
      for (int& l : last_index) l = -1;
      reconstruct(false, 0, 0);
    }
  }

  // h261_decode_mb; → false where the GOB ends (its start code read as
  // the next MBA, or the packet's end).
  bool macroblock(Bits& b) {
    do {
      mba_diff = mba_vlc().read(b);
      if (mba_diff == kStartCode) {
        start_code_read = true;
        return false;
      }
    } while (mba_diff == kStuffing);
    if (mba_diff < 0) {
      if (b.left() <= 7) return false;
      bad("illegal MBA");
    }
    mba_diff += 1;
    mba += mba_diff;
    if (mba > kStuffing) bad("MBA past the GOB");
    place(mba - 1);
    int code = mtype_vlc().read(b);
    if (code < 0) bad("invalid MTYPE");
    mtype = kMtypeMap[code];
    if (mtype & kQuant) qscale = clip(int(b.get(5)), 1, 31);
    const bool intra = mtype & kIntra;
    if (mtype & kMc) {
      if (mba == 1 || mba == 12 || mba == 23 || mba_diff != 1)
        mv_x = mv_y = 0;
      mv_x = mv_component(b, mv_x);
      mv_y = mv_component(b, mv_y);
    } else {
      mv_x = mv_y = 0;
    }
    int cbp = 63;
    if (mtype & kCbp) {
      cbp = cbp_vlc().read(b);
      if (cbp < 0) bad("invalid CBP");
      cbp += 1;
    }
    std::memset(block, 0, sizeof(block));
    if (intra || (mtype & kCbp)) {
      for (int n = 0; n < 6; ++n)
        decode_block(b, block[n], n, (cbp >> (5 - n)) & 1, intra);
    } else {
      for (int& l : last_index) l = -1;
    }
    if (b.over()) bad("packet ends inside the macroblock");
    reconstruct(intra, mv_x, mv_y);
    return true;
  }

  // h261_decode_gob
  void decode_gob(Bits& b) {
    qscale = clip(qscale, 1, 31);
    while (mba <= kStuffing) {
      if (!macroblock(b)) {
        skipped(mba, 33);
        return;
      }
      skipped(mba - mba_diff, mba - 1);
    }
    bad("GOB without its end");
  }

  bool decode(const uint8_t* d, size_t n, Picture& out) {
    if (!n) return false;
    Bits b{d, n};
    int w, h;
    start_code_read = false;
    mb_x = mb_y = 0;
    if (!header(b, w, h)) bad("bad picture start code");
    while (b.get1()) b.skip(8);     // PEI, PSPARE
    if (w != width || h != height) {
      if (width)
        unsupported("H261 picture of another size (" + std::to_string(w) +
                    "x" + std::to_string(h) + " after " +
                    std::to_string(width) + "x" + std::to_string(height) +
                    ")");
      set_size(w, h);
    }
    std::fill(done.begin(), done.end(), 0);
    gob = 0;
    while (gob < (mbh == 18 ? 12 : 5)) {
      if (!resync(b)) break;
      decode_gob(b);
    }
    for (uint8_t k : done)
      if (!k)
        broken("H261 video: a GOB is missing (libavcodec leaves its "
               "macroblocks undecoded)");
    out.w = width;
    out.h = height;
    out.ystride = width;
    out.cstride = width / 2;
    out.y = cur.y;
    out.u = cur.u;
    out.v = cur.v;
    out.xshift = out.yshift = 1;
    out.full_range = false;
    std::swap(cur, ref);
    return true;
  }
};

H261Decoder::H261Decoder() : s_(new State) {}
H261Decoder::~H261Decoder() = default;

bool H261Decoder::decode(const uint8_t* data, size_t n, Picture& out) {
  return s_->decode(data, n, out);
}

bool H261Decoder::picture_size(const uint8_t* data, size_t n, int& w,
                               int& h) {
  Bits b{data, n};
  return header(b, w, h);
}

}  // namespace viai_video
