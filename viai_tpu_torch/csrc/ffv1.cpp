// FFV1 of viai_tpu_torch: libavcodec's ffv1 decoder (ffv1dec.c) for what
// ffmpeg's encoder, archive workflows and cv2's writer store in AVI and
// Matroska (RFC 9043):
//
//   * versions 0 and 1 (the configuration in each key frame's header),
//     2 and 3 (a configuration record in the extradata: version 3's with
//     its CRC, initial context states, slice CRCs, the slices placed by
//     the sizes in the packet's trailer);
//   * the range coder with the default state table (coder 1) or the
//     record's own (coder 2), and Golomb-Rice with run mode (coder 0);
//     context models of 3 and 5 inputs over up to 8 quant tables;
//   * key frames and non-key frames, whose context states carry over
//     from the frame before (no prediction across frames);
//   * YUV 4:4:4, 4:4:0, 4:2:2, 4:2:0, 4:1:1 and 4:1:0 with or without
//     alpha, grey with or without alpha, 8 to 16 bits; RGB through the
//     JPEG 2000 RCT, as libavcodec writes it: bgr0/bgra at 8 bits (one
//     32-bit word a pixel), gbrp/gbrap above.
//
// The picture is what cv2's swscale converts as libavcodec gives it:
// planar YUV as it is, alpha dropped (swscale drops it on the way to
// BGR24; yuva422p at 8 bits takes the scaler, which its x86 yuv2rgb does
// not take); grey above 8 bits and grey with alpha as 4:4:4 with mid
// chroma (swscale's scaler reads them so: the same bytes); bgr0/bgra as
// BGR24. A slice whose CRC, end or context states do not check raises
// ValueError (libavcodec conceals it); an interlaced picture (version 3's
// picture_structure 1 or 2) NotImplementedError, as cv2 converts no such
// frame.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <memory>
#include <string>
#include <vector>

#include "rangecoder.h"
#include "video.h"

namespace viai_video {

namespace {

constexpr int kContextSize = 32;
constexpr int kMaxQuantTables = 8;
constexpr int kMaxSlices = 1024;

// get_bits over data[start, end), zeros past the end.
struct BitReader {
  const uint8_t* data = nullptr;
  size_t start = 0, end = 0;
  uint64_t pos = 0;       // bits from start

  int64_t left() const { return int64_t((end - start) * 8) - int64_t(pos); }
  uint32_t show(int n) const {     // n ≤ 25
    uint64_t v = 0;
    const size_t b0 = start + size_t(pos >> 3);
    for (int i = 0; i < 5; ++i) {
      const size_t b = b0 + size_t(i);
      v = (v << 8) | (b < end ? data[b] : 0);
    }
    v <<= (pos & 7);
    return uint32_t((v >> (40 - n)) & ((uint64_t(1) << n) - 1));
  }
  uint32_t get(int n) {
    if (!n) return 0;
    const uint32_t v = show(n);
    pos += uint64_t(n);
    return v;
  }
  // get_ur_golomb(gb, k, limit 12, esc_len) then the sign fold of
  // get_sr_golomb.
  int sr_golomb(int k, int esc_len) {
    const int limit = 12;
    int q = 0;
    while (q < limit && show(1) == 0 && q < 32) {
      ++pos;
      ++q;
    }
    unsigned v;
    if (q < limit) {
      ++pos;                                     // the terminating 1
      v = (unsigned(q) << k) + get(k);
    } else {
      v = get(esc_len) + unsigned(limit) - 1;
    }
    return int(v >> 1) ^ -int(v & 1);
  }
};

struct VlcState {
  int16_t drift = 0;
  uint16_t error_sum = 4;
  int8_t bias = 0;
  uint8_t count = 1;
};

int fold(int diff, int bits) {
  if (bits == 8) return int8_t(diff);
  diff += 1 << (bits - 1);
  diff &= (1 << bits) - 1;
  return diff - (1 << (bits - 1));
}

void update_vlc_state(VlcState& s, int v) {
  int drift = s.drift, count = s.count;
  s.error_sum = uint16_t(s.error_sum + std::abs(v));
  drift += v;
  if (count == 128) {
    count >>= 1;
    drift >>= 1;
    s.error_sum >>= 1;
  }
  ++count;
  if (drift <= -count) {
    s.bias = int8_t(std::max(s.bias - 1, -128));
    drift = std::max(drift + count, -count + 1);
  } else if (drift > 0) {
    s.bias = int8_t(std::min(s.bias + 1, 127));
    drift = std::min(drift - count, 0);
  }
  s.drift = int16_t(drift);
  s.count = uint8_t(count);
}

int vlc_symbol(BitReader& gb, VlcState& s, int bits) {
  int i = s.count, k = 0;
  while (i < s.error_sum) {
    ++k;
    i += i;
  }
  int v = gb.sr_golomb(k, bits);
  v ^= ((2 * s.drift + s.count) >> 31);
  const int ret = fold(v + s.bias, bits);
  update_vlc_state(s, v);
  return ret;
}

const uint8_t kLog2Run[41] = {0,  0,  0,  0,  1,  1,  1,  1,  2,  2,  2,
                              2,  3,  3,  3,  3,  4,  4,  5,  5,  6,  6,
                              7,  7,  8,  9,  10, 11, 12, 13, 14, 15, 16,
                              17, 18, 19, 20, 21, 22, 23, 24};

inline int mid_pred(int a, int b, int c) {
  return std::max(std::min(a, b), std::min(std::max(a, b), c));
}

using QuantTable = int16_t[5][256];

struct PlaneCtx {
  int quant_index = 0;
  int context_count = 0;
  std::vector<uint8_t> state;        // context_count × 32
  std::vector<VlcState> vlc;
};

struct Slice {
  int x = 0, y = 0, w = 0, h = 0;
  PlaneCtx plane[4];
  RangeCoder c;
  BitReader gb;
  int run_index = 0;
  bool first_frame = true;
};

// read_quant_table: runs of equal values from 0 up, mirrored below 0.
int read_quant_table(RangeCoder& c, int16_t* table, int scale) {
  uint8_t st[kContextSize];
  std::memset(st, 128, sizeof(st));
  int i = 0, v = 0;
  for (; i < 128; ++v) {
    const unsigned len = unsigned(c.symbol(st, false)) + 1u;
    if (len > unsigned(128 - i) || !len)
      broken("FFV1 quant table runs past its end");
    for (unsigned k = 0; k < len; ++k) table[i++] = int16_t(scale * v);
  }
  for (i = 1; i < 128; ++i) table[256 - i] = int16_t(-table[i]);
  table[128] = int16_t(-table[127]);
  return 2 * v - 1;
}

int read_quant_tables(RangeCoder& c, QuantTable& q) {
  int count = 1;
  for (int i = 0; i < 5; ++i) {
    count *= read_quant_table(c, q[i], count);
    if (count > 32768) broken("FFV1 quant tables with too many contexts");
  }
  return (count + 1) / 2;
}

uint32_t crc32_msb(const uint8_t* d, size_t n) {
  static uint32_t table[256];
  static bool ready = false;
  if (!ready) {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i << 24;
      for (int k = 0; k < 8; ++k)
        c = (c & 0x80000000u) ? (c << 1) ^ 0x04C11DB7u : c << 1;
      table[i] = c;
    }
    ready = true;
  }
  uint32_t crc = 0;
  for (size_t i = 0; i < n; ++i) crc = (crc << 8) ^ table[(crc >> 24) ^ d[i]];
  return crc;
}

}  // namespace

struct Ffv1Decoder::State {
  int width = 0, height = 0;
  int version = 0, micro_version = 0, ac = 0;
  uint8_t state_transition[256] = {};
  int colorspace = 0, bits = 8, chroma_planes = 0, hs = 0, vs = 0;
  int transparency = 0, plane_count = 0;
  int num_h = 1, num_v = 1;
  int quant_table_count = 0;
  QuantTable quant_tables[kMaxQuantTables];
  QuantTable quant_table;                 // versions 0 and 1
  int context_count[kMaxQuantTables] = {};
  std::vector<uint8_t> initial_states[kMaxQuantTables];
  int ec = 0;
  bool configured = false;                // a header (or the record) read
  bool key_frame_ok = false;
  bool key = false;
  bool packed_at_lsb = false;
  bool use32 = false;
  std::vector<Slice> slices;
  int slice_count = 0;
  // The frame's planes (libavcodec's buffer): 8-bit or 16-bit samples.
  std::vector<uint8_t> p8[4];
  std::vector<uint16_t> p16[4];
  std::vector<uint32_t> packed;           // bgr0 / bgra

  void read_extra(const std::vector<uint8_t>& ext);
  void read_header(RangeCoder& c);
  void check_format();
  void place_slices();
  void slice_header(Slice& s);
  void init_slice_state(Slice& s);
  void clear_slice_state(Slice& s);
  void decode_slice(Slice& s);
  template <class T>
  void decode_line(Slice& s, PlaneCtx& p, int w, T* prev, T* cur, int bits);
  void decode_plane(Slice& s, int plane, int x0, int y0, int w, int h,
                    int index);
  template <class T>
  void decode_rgb(Slice& s);
  void output(Picture& out) const;
};

void Ffv1Decoder::State::read_extra(const std::vector<uint8_t>& ext) {
  RangeCoder c;
  c.init(ext.data(), 0, ext.size());
  c.build_states();
  uint8_t st[kContextSize];
  std::memset(st, 128, sizeof(st));
  uint8_t st2[32][kContextSize];
  std::memset(st2, 128, sizeof(st2));
  version = c.symbol(st, false);
  if (version < 2) broken("FFV1 configuration record of version < 2");
  if (version > 3)
    unsupported("FFV1 version " + std::to_string(version));
  if (version > 2) {
    if (ext.size() < 4) broken("FFV1 configuration record cut short");
    c.end -= 4;
    micro_version = c.symbol(st, false);
  }
  ac = c.symbol(st, false);
  if (ac == 2)
    for (int i = 1; i < 256; ++i)
      state_transition[i] = uint8_t(c.symbol(st, true) + c.one[i]);
  colorspace = c.symbol(st, false);
  bits = c.symbol(st, false);
  chroma_planes = c.bit(st[0]);
  hs = c.symbol(st, false);
  vs = c.symbol(st, false);
  transparency = c.bit(st[0]);
  plane_count = 1 + 1 + transparency;     // chroma_planes || version < 4
  num_h = 1 + c.symbol(st, false);
  num_v = 1 + c.symbol(st, false);
  if (hs > 4 || vs > 4 || hs < 0 || vs < 0)
    broken("FFV1 chroma shift out of range");
  if (num_h < 1 || num_h > width || num_v < 1 || num_v > height)
    broken("FFV1 slice count out of range");
  quant_table_count = c.symbol(st, false);
  if (quant_table_count < 1 || quant_table_count > kMaxQuantTables)
    broken("FFV1 quant table count out of range");
  for (int i = 0; i < quant_table_count; ++i)
    context_count[i] = read_quant_tables(c, quant_tables[i]);
  for (int i = 0; i < quant_table_count; ++i)
    initial_states[i].assign(size_t(context_count[i]) * kContextSize, 128);
  for (int i = 0; i < quant_table_count; ++i)
    if (c.bit(st[0]))
      for (int j = 0; j < context_count[i]; ++j)
        for (int k = 0; k < kContextSize; ++k) {
          const int pred =
              j ? initial_states[i][size_t(j - 1) * kContextSize + k] : 128;
          initial_states[i][size_t(j) * kContextSize + k] =
              uint8_t((pred + c.symbol(st2[k], true)) & 0xFF);
        }
  if (version > 2) {
    ec = c.symbol(st, false);
    if (micro_version > 2) c.symbol(st, false);   // intra
    if (crc32_msb(ext.data(), ext.size()))
      broken("FFV1 configuration record CRC mismatch");
  }
  if (ac != 2)
    for (int i = 1; i < 256; ++i) state_transition[i] = c.one[i];
  check_format();
  const int n = num_h * num_v;
  if (n > kMaxSlices) broken("FFV1 with too many slices");
  slices.assign(size_t(n), Slice());
  configured = true;
}

// read_header's choice of pixel format, as far as libavcodec has one.
void Ffv1Decoder::State::check_format() {
  const int b = bits <= 8 ? 8 : bits;
  packed_at_lsb = false;
  use32 = false;
  auto no = [&](const char* what) {
    unsupported("FFV1 " + std::string(what) + " at " + std::to_string(bits) +
                " bits (libavcodec has no pixel format for it)");
  };
  if (colorspace == 0) {
    const int sub = 16 * hs + vs;
    if (!chroma_planes) {
      if (transparency) {
        if (b != 8) no("grey with alpha");
      } else if (b != 8) {
        if (b == 9 || b == 10 || b == 12 || b == 14 || b == 16)
          packed_at_lsb = true;
        else if (b > 16)
          no("grey");
      }
      return;
    }
    bool ok;
    if (b == 8)
      ok = transparency ? (sub == 0 || sub == 0x10 || sub == 0x11)
                        : (sub == 0 || sub == 1 || sub == 0x10 ||
                           sub == 0x11 || sub == 0x20 || sub == 0x22);
    else if (b == 9 || b == 16)
      ok = sub == 0 || sub == 0x10 || sub == 0x11;
    else if (b == 10)
      ok = sub == 0 || sub == 0x10 || sub == 0x11 ||
           (!transparency && sub == 1);
    else if (b == 12)
      ok = transparency ? (sub == 0 || sub == 0x10)
                        : (sub == 0 || sub == 1 || sub == 0x10 || sub == 0x11);
    else if (b == 14)
      ok = !transparency && (sub == 0 || sub == 0x10 || sub == 0x11);
    else
      ok = false;
    if (!ok) no("YUV of this sampling");
    packed_at_lsb = b > 8;
  } else if (colorspace == 1) {
    if (hs || vs) broken("FFV1 RGB with chroma subsampling");
    const bool ok = b == 8 || (b == 9 && !transparency) || b == 10 ||
                    b == 12 || (b == 14 && !transparency) || b == 16;
    if (!ok) no("RGB");
    use32 = b == 16;
  } else {
    unsupported("FFV1 colorspace " + std::to_string(colorspace));
  }
}

// read_header: versions 0 and 1 read their configuration here; every
// version places its slices.
void Ffv1Decoder::State::read_header(RangeCoder& c) {
  uint8_t st[kContextSize];
  std::memset(st, 128, sizeof(st));
  if (version < 2) {
    const int v = c.symbol(st, false);
    if (v >= 2) broken("FFV1 key frame header of version >= 2");
    version = v;
    ac = c.symbol(st, false);
    if (ac == 2) {
      for (int i = 1; i < 256; ++i) {
        const int s = c.symbol(st, true) + c.one[i];
        if (s < 1 || s > 255) broken("FFV1 state transition out of range");
        state_transition[i] = uint8_t(s);
      }
    } else {
      for (int i = 1; i < 256; ++i) state_transition[i] = c.one[i];
    }
    colorspace = c.symbol(st, false);
    bits = version > 0 ? c.symbol(st, false) : 0;
    chroma_planes = c.bit(st[0]);
    hs = c.symbol(st, false);
    vs = c.symbol(st, false);
    transparency = c.bit(st[0]);
    if (hs < 0 || vs < 0 || hs > 4 || vs > 4)
      broken("FFV1 chroma shift out of range");
    plane_count = 2 + transparency;
    check_format();
    const int count = read_quant_tables(c, quant_table);
    slice_count = 1;
    if (slices.size() != 1) slices.assign(1, Slice());
    Slice& s = slices[0];
    s.x = s.y = 0;
    s.w = width;
    s.h = height;
    for (int i = 0; i < plane_count; ++i) {
      s.plane[i].quant_index = 0;
      s.plane[i].context_count = count;
    }
    configured = true;
    return;
  }
  if (version == 2) {
    slice_count = c.symbol(st, false);
  } else {
    const int trailer = 3 + 5 * (ec != 0);
    size_t p = c.end;
    for (slice_count = 0;
         slice_count < kMaxSlices && size_t(trailer) < p - c.start;
         ++slice_count) {
      const size_t sz = (size_t(c.data[p - trailer]) << 16) |
                        (size_t(c.data[p - trailer + 1]) << 8) |
                        c.data[p - trailer + 2];
      if (sz + size_t(trailer) > p - c.start) break;
      p -= sz + size_t(trailer);
    }
  }
  if (slice_count <= 0 || slice_count > int(slices.size()))
    broken("FFV1 slice count out of range");
  if (version == 2) {
    for (int j = 0; j < slice_count; ++j) {
      Slice& s = slices[size_t(j)];
      const int64_t sx = int64_t(c.symbol(st, false)) * width;
      const int64_t sy = int64_t(c.symbol(st, false)) * height;
      const int64_t sw = (int64_t(c.symbol(st, false)) + 1) * width + sx;
      const int64_t sh = (int64_t(c.symbol(st, false)) + 1) * height + sy;
      s.x = int(sx / num_h);
      s.y = int(sy / num_v);
      s.w = int(sw / num_h - s.x);
      s.h = int(sh / num_v - s.y);
      if (s.w <= 0 || s.h <= 0 || s.x < 0 || s.y < 0 || s.x + s.w > width ||
          s.y + s.h > height)
        broken("FFV1 slice out of the picture");
      for (int i = 0; i < plane_count; ++i) {
        const int idx = c.symbol(st, false);
        if (idx < 0 || idx >= quant_table_count)
          broken("FFV1 quant table index out of range");
        s.plane[i].quant_index = idx;
        s.plane[i].context_count = context_count[idx];
      }
    }
  }
}

// decode_slice_header (version 3).
void Ffv1Decoder::State::slice_header(Slice& s) {
  RangeCoder& c = s.c;
  uint8_t st[kContextSize];
  std::memset(st, 128, sizeof(st));
  const int sx = c.symbol(st, false), sy = c.symbol(st, false);
  const int sw = c.symbol(st, false) + 1, sh = c.symbol(st, false) + 1;
  if (sx < 0 || sy < 0 || sw <= 0 || sh <= 0 || sx > num_h - sw ||
      sy > num_v - sh)
    broken("FFV1 slice header out of range");
  s.x = int(int64_t(sx) * width / num_h);
  s.y = int(int64_t(sy) * height / num_v);
  s.w = int(int64_t(sx + sw) * width / num_h - s.x);
  s.h = int(int64_t(sy + sh) * height / num_v - s.y);
  for (int i = 0; i < plane_count; ++i) {
    const int idx = c.symbol(st, false);
    if (idx < 0 || idx >= quant_table_count)
      broken("FFV1 quant table index out of range");
    const int count = context_count[idx];
    if (!key && (s.plane[i].quant_index != idx ||
                 s.plane[i].context_count != count))
      broken("FFV1 non-key frame changes a slice's quant table");
    s.plane[i].quant_index = idx;
    s.plane[i].context_count = count;
  }
  const int ps = c.symbol(st, false);
  if (ps == 1 || ps == 2)
    unsupported("FFV1 interlaced picture (picture_structure " +
                std::to_string(ps) +
                "): cv2 converts no frame libavcodec marks interlaced");
  c.symbol(st, false);                    // sample aspect ratio
  c.symbol(st, false);
}

void Ffv1Decoder::State::init_slice_state(Slice& s) {
  for (int j = 0; j < plane_count; ++j) {
    PlaneCtx& p = s.plane[j];
    if (ac) {
      if (p.state.size() < size_t(p.context_count) * kContextSize)
        p.state.resize(size_t(p.context_count) * kContextSize, 128);
    } else if (p.vlc.size() < size_t(p.context_count)) {
      p.vlc.resize(size_t(p.context_count));
    }
  }
  if (ac == 2)
    for (int j = 1; j < 256; ++j) {
      s.c.one[j] = state_transition[j];
      s.c.zero[256 - j] = uint8_t(256 - s.c.one[j]);
    }
}

void Ffv1Decoder::State::clear_slice_state(Slice& s) {
  for (int i = 0; i < plane_count; ++i) {
    PlaneCtx& p = s.plane[i];
    if (ac) {
      const size_t n = size_t(p.context_count) * kContextSize;
      p.state.resize(n);
      const std::vector<uint8_t>& init = initial_states[p.quant_index];
      if (version >= 2 && init.size() >= n)
        std::memcpy(p.state.data(), init.data(), n);
      else
        std::fill(p.state.begin(), p.state.end(), uint8_t(128));
    } else {
      p.vlc.assign(size_t(p.context_count), VlcState());
    }
  }
}

template <class T>
void Ffv1Decoder::State::decode_line(Slice& s, PlaneCtx& p, int w, T* prev,
                                     T* cur, int bits) {
  const QuantTable& q =
      version < 2 ? quant_table : quant_tables[p.quant_index];
  const bool five = q[3][127] || q[4][127];
  // The coder as a local: the context states' byte stores cannot alias
  // it, so its fields stay in registers.
  RangeCoder c = s.c;
  auto input_end = [&]() {
    return ac ? c.overread > 2 : s.gb.left() < 1;
  };
  if (input_end()) broken("FFV1 slice data cut short");
  int run_count = 0, run_mode = 0, run_index = s.run_index;
  const unsigned mask = bits >= 32 ? ~0u : (1u << bits) - 1;
  for (int x = 0; x < w; ++x) {
    if (!(x & 1023) && input_end()) broken("FFV1 slice data cut short");
    const int LT = prev[x - 1], T_ = prev[x], RT = prev[x + 1],
              L = cur[x - 1];
    int context = q[0][(L - LT) & 0xFF] + q[1][(LT - T_) & 0xFF] +
                  q[2][(T_ - RT) & 0xFF];
    if (five)
      context += q[3][(cur[x - 2] - L) & 0xFF] + q[4][(cur[x] - T_) & 0xFF];
    bool sign = false;
    if (context < 0) {
      context = -context;
      sign = true;
    }
    if (context >= p.context_count) broken("FFV1 context out of range");
    int diff;
    if (ac) {
      diff = c.symbol(&p.state[size_t(context) * kContextSize], true);
    } else {
      if (context == 0 && run_mode == 0) run_mode = 1;
      if (run_mode) {
        if (run_count == 0 && run_mode == 1) {
          if (s.gb.get(1)) {
            run_count = 1 << kLog2Run[run_index];
            if (x + run_count <= w) ++run_index;
          } else {
            run_count = kLog2Run[run_index]
                            ? int(s.gb.get(kLog2Run[run_index]))
                            : 0;
            if (run_index) --run_index;
            run_mode = 2;
          }
          if (run_index > 40) broken("FFV1 run index out of range");
        }
        while (run_count > 1 && w - x > 1) {
          cur[x] = T(mid_pred(cur[x - 1], cur[x - 1] + prev[x] - prev[x - 1],
                              prev[x]));
          ++x;
          --run_count;
        }
        --run_count;
        if (run_count < 0) {
          run_mode = 0;
          run_count = 0;
          diff = vlc_symbol(s.gb, p.vlc[size_t(context)], bits);
          if (diff >= 0) ++diff;
        } else {
          diff = 0;
        }
      } else {
        diff = vlc_symbol(s.gb, p.vlc[size_t(context)], bits);
      }
    }
    if (sign) diff = int(0u - unsigned(diff));
    const int pred =
        mid_pred(cur[x - 1], cur[x - 1] + prev[x] - prev[x - 1], prev[x]);
    cur[x] = T((unsigned(pred) + unsigned(diff)) & mask);
  }
  s.c = c;
  s.run_index = run_index;
}

// decode_plane: one plane of the slice, rows of w samples from (x0, y0)
// of frame plane `plane` (0 Y, 1 U, 2 V, 3 A) with the contexts of
// plane index `index`.
void Ffv1Decoder::State::decode_plane(Slice& s, int plane, int x0, int y0,
                                      int w, int h, int index) {
  std::vector<int16_t> buf(size_t(2) * (w + 6), 0);
  int16_t* rows[2] = {buf.data() + 3, buf.data() + w + 6 + 3};
  s.run_index = 0;
  const int pw = plane == 1 || plane == 2
                     ? (width + (1 << hs) - 1) >> hs : width;
  const int b = bits <= 8 ? 8 : bits;
  for (int y = 0; y < h; ++y) {
    std::swap(rows[0], rows[1]);
    rows[1][-1] = rows[0][0];
    rows[0][w] = rows[0][w - 1];
    decode_line(s, s.plane[index], w, rows[0], rows[1], b);
    const size_t at = size_t(y0 + y) * size_t(pw) + size_t(x0);
    if (b == 8) {
      uint8_t* d = &p8[plane][at];
      for (int x = 0; x < w; ++x) d[x] = uint8_t(rows[1][x]);
    } else {
      uint16_t* d = &p16[plane][at];
      for (int x = 0; x < w; ++x) {
        const uint16_t v = uint16_t(rows[1][x]);
        d[x] = packed_at_lsb
                   ? v
                   : uint16_t((v << (16 - b)) | (v >> (2 * b - 16)));
      }
    }
  }
}

template <class T>
void Ffv1Decoder::State::decode_rgb(Slice& s) {
  const int w = s.w, h = s.h;
  const bool lbd = bits <= 8;
  const int b = bits > 0 ? bits : 8;
  const int offset = 1 << b;
  std::vector<T> buf(size_t(8) * (w + 6), 0);
  T* sample[4][2];
  for (int k = 0; k < 4; ++k) {
    sample[k][0] = buf.data() + size_t(2 * k) * (w + 6) + 3;
    sample[k][1] = buf.data() + size_t(2 * k + 1) * (w + 6) + 3;
  }
  s.run_index = 0;
  for (int y = 0; y < h; ++y) {
    for (int p = 0; p < 3 + transparency; ++p) {
      std::swap(sample[p][0], sample[p][1]);
      sample[p][1][-1] = sample[p][0][0];
      sample[p][0][w] = sample[p][0][w - 1];
      decode_line(s, s.plane[(p + 1) / 2], w, sample[p][0], sample[p][1],
                  lbd ? 9 : b + 1);
    }
    const size_t row = size_t(s.y + y) * size_t(width) + size_t(s.x);
    for (int x = 0; x < w; ++x) {
      int g = sample[0][1][x], bb = sample[1][1][x], r = sample[2][1][x];
      const int a = sample[3][1][x];
      bb -= offset;
      r -= offset;
      g -= (bb + r) >> 2;
      bb += g;
      r += g;
      if (lbd) {
        packed[row + size_t(x)] = unsigned(bb) + (unsigned(g) << 8) +
                                  (unsigned(r) << 16) + (unsigned(a) << 24);
      } else if (sizeof(T) == 4 || transparency) {
        p16[0][row + size_t(x)] = uint16_t(g);
        p16[1][row + size_t(x)] = uint16_t(bb);
        p16[2][row + size_t(x)] = uint16_t(r);
        if (transparency) p16[3][row + size_t(x)] = uint16_t(a);
      } else {
        // libavcodec's order for gbrp9..14 (its encoder reads the same).
        p16[0][row + size_t(x)] = uint16_t(bb);
        p16[1][row + size_t(x)] = uint16_t(g);
        p16[2][row + size_t(x)] = uint16_t(r);
      }
    }
  }
}

void Ffv1Decoder::State::decode_slice(Slice& s) {
  if (version > 2) {
    init_slice_state(s);
    slice_header(s);
  }
  init_slice_state(s);
  if (key) {
    clear_slice_state(s);
  } else if (s.first_frame) {
    broken("FFV1 non-key frame before a key frame");
  }
  s.first_frame = false;
  if (s.w <= 0 || s.h <= 0) broken("FFV1 empty slice");
  if (!ac) {
    if (version == 3 && micro_version > 1) {
      uint8_t st = 129;
      s.c.bit(st);
    }
    const size_t skip = version > 2 || (!s.x && !s.y)
                            ? s.c.pos - s.c.start - 1 : 0;
    s.gb.data = s.c.data;
    s.gb.start = s.c.start + skip;
    s.gb.end = std::max(s.c.end, s.gb.start);
    s.gb.pos = 0;
  }
  if (colorspace == 0 && (chroma_planes || !transparency)) {
    const int cw = (s.w + (1 << hs) - 1) >> hs;
    const int ch = (s.h + (1 << vs) - 1) >> vs;
    decode_plane(s, 0, s.x, s.y, s.w, s.h, 0);
    if (chroma_planes) {
      decode_plane(s, 1, s.x >> hs, s.y >> vs, cw, ch, 1);
      decode_plane(s, 2, s.x >> hs, s.y >> vs, cw, ch, 1);
    }
    if (transparency) decode_plane(s, 3, s.x, s.y, s.w, s.h, 2);
  } else if (colorspace == 0) {
    // Grey with alpha (ya8): luma and alpha interleaved in libavcodec's
    // buffer, each coded as a plane of its own.
    decode_plane(s, 0, s.x, s.y, s.w, s.h, 0);
    decode_plane(s, 3, s.x, s.y, s.w, s.h, 1);
  } else if (use32) {
    decode_rgb<int32_t>(s);
  } else {
    decode_rgb<int16_t>(s);
  }
  if (ac && version > 2) {
    uint8_t st = 129;
    s.c.bit(st);
    const int64_t v = int64_t(s.c.end) - int64_t(s.c.pos) - 2 - 5 * ec;
    if (v) broken("FFV1 slice bytestream end mismatching by " +
                  std::to_string(v));
  }
}

void Ffv1Decoder::State::output(Picture& out) const {
  out = Picture();
  out.w = width;
  out.h = height;
  out.ystride = width;
  if (colorspace == 1) {
    if (bits <= 8) {
      out.bgr.resize(size_t(width) * height * 3);
      for (size_t i = 0; i < packed.size(); ++i) {
        out.bgr[3 * i] = uint8_t(packed[i]);
        out.bgr[3 * i + 1] = uint8_t(packed[i] >> 8);
        out.bgr[3 * i + 2] = uint8_t(packed[i] >> 16);
      }
      return;
    }
    out.rgb = true;
    out.depth = bits;
    out.xshift = out.yshift = 0;
    out.cstride = width;
    out.y16 = p16[0];
    out.u16 = p16[1];
    out.v16 = p16[2];
    return;
  }
  const int b = bits <= 8 ? 8 : bits;
  if (!chroma_planes) {
    if (b == 8 && !transparency) {
      out.grey = true;
      out.y = p8[0];
      return;
    }
    // ya8 and grey above 8 bits: what cv2's swscale makes of them is
    // full-range 4:4:4 with mid chroma.
    out.full_range = true;
    out.xshift = out.yshift = 0;
    out.cstride = width;
    out.depth = b;
    if (b == 8) {
      out.y = p8[0];
      out.u.assign(out.y.size(), 128);
      out.v.assign(out.y.size(), 128);
    } else {
      // grey stored above its depth (packed_at_lsb 0) is gray16's
      out.depth = packed_at_lsb ? b : 16;
      out.y16 = p16[0];
      out.u16.assign(out.y16.size(), uint16_t(1 << (out.depth - 1)));
      out.v16.assign(out.y16.size(), uint16_t(1 << (out.depth - 1)));
    }
    return;
  }
  out.xshift = hs;
  out.yshift = vs;
  out.cstride = (width + (1 << hs) - 1) >> hs;
  out.depth = b;
  if (b == 8) {
    out.y = p8[0];
    out.u = p8[1];
    out.v = p8[2];
    // yuva422p takes swscale's scaler (its x86 yuv2rgb reads yuv422p).
    out.scaler_only = transparency && hs == 1 && vs == 0;
  } else {
    out.y16 = p16[0];
    out.u16 = p16[1];
    out.v16 = p16[2];
  }
}

Ffv1Decoder::Ffv1Decoder(const std::vector<uint8_t>& extradata, int w, int h,
                         const std::string& where)
    : s_(new State) {
  if (w <= 0 || h <= 0)
    broken(where + " FFV1 track without a picture size");
  s_->width = w;
  s_->height = h;
  if (!extradata.empty()) s_->read_extra(extradata);
}

Ffv1Decoder::~Ffv1Decoder() = default;

int Ffv1Decoder::peek(const uint8_t* data, size_t n) {
  RangeCoder c;
  c.init(data, 0, n);
  c.build_states();
  uint8_t keystate = 128;
  return c.bit(keystate) ? 0 : 1;
}

bool Ffv1Decoder::decode(const uint8_t* data, size_t n, Picture& out) {
  State& s = *s_;
  RangeCoder c;
  c.init(data, 0, n);
  c.build_states();
  uint8_t keystate = 128;
  s.key = c.bit(keystate) != 0;
  if (s.key) {
    s.key_frame_ok = false;
    if (s.version < 2) s.version = 0;
    s.read_header(c);
    s.key_frame_ok = true;
  } else if (!s.key_frame_ok) {
    broken("FFV1 non-key frame without a key frame before it");
  }
  const int w = s.width, h = s.height;
  if (s.ac) {
    if (n < size_t(w) * h / (128 * 8)) broken("FFV1 packet too short");
  } else {
    static const uint8_t kLog2Tab[256] = {
#define L4(x) x, x, x, x
#define L8(x) L4(x), L4(x)
#define L16(x) L8(x), L8(x)
        0, 0, 1, 1, L4(2), L8(3), L16(4), L16(5), L16(5), L16(6), L16(6),
        L16(6), L16(6), L16(7), L16(7), L16(7), L16(7), L16(7), L16(7),
        L16(7), L16(7)
#undef L4
#undef L8
#undef L16
    };
    int ww = w;
    const int sc = 1 + w / (1 << 23);
    ww /= sc;
    int i = 0;
    for (; ww > (1 << kLog2Tab[i]); ++i) ww >>= kLog2Tab[i];
    if (n < size_t((h + i + 6) / 8 * sc)) broken("FFV1 packet too short");
  }
  if (s.version < 2 && s.slice_count != 1) broken("FFV1 without a slice");
  // The slices, from the packet's end.
  size_t buf_p = n;
  const size_t trailer = 3 + 5 * size_t(s.ec != 0);
  std::vector<std::pair<size_t, size_t>> at(size_t(s.slice_count));
  for (int i = s.slice_count - 1; i >= 0; --i) {
    size_t v;
    if (i || s.version > 2) {
      if (trailer > buf_p)
        v = SIZE_MAX;
      else
        v = ((size_t(data[buf_p - trailer]) << 16) |
             (size_t(data[buf_p - trailer + 1]) << 8) |
             data[buf_p - trailer + 2]) + trailer;
    } else {
      v = buf_p;
    }
    if (buf_p < v) broken("FFV1 slice pointer chain broken");
    buf_p -= v;
    if (s.ec && crc32_msb(data + buf_p, v))
      broken("FFV1 slice " + std::to_string(i) + " CRC mismatch");
    at[size_t(i)] = {buf_p, buf_p + v};
  }
  for (int i = 0; i < s.slice_count; ++i) {
    Slice& sl = s.slices[size_t(i)];
    if (i) {
      sl.c.init(data, at[size_t(i)].first, at[size_t(i)].second);
      // A slice's coder starts from the default states (libavcodec copies
      // the context whose coder read the record).
      RangeCoder d;
      d.build_states();
      std::memcpy(sl.c.one, d.one, 256);
      std::memcpy(sl.c.zero, d.zero, 256);
    } else {
      sl.c = c;
      sl.c.end = at[0].second;
    }
  }
  // libavcodec's frame buffer
  const int cw = (w + (1 << s.hs) - 1) >> s.hs;
  const int chh = (h + (1 << s.vs) - 1) >> s.vs;
  const size_t ny = size_t(w) * h, nc = size_t(cw) * chh;
  if (s.colorspace == 1 && s.bits <= 8) {
    s.packed.assign(ny, 0);
  } else if (s.bits <= 8) {
    s.p8[0].assign(ny, 0);
    s.p8[1].assign(s.chroma_planes ? nc : 0, 0);
    s.p8[2].assign(s.chroma_planes ? nc : 0, 0);
    s.p8[3].assign(s.transparency ? ny : 0, 0);
  } else {
    const bool rgb = s.colorspace == 1;
    s.p16[0].assign(ny, 0);
    s.p16[1].assign(rgb ? ny : s.chroma_planes ? nc : 0, 0);
    s.p16[2].assign(rgb ? ny : s.chroma_planes ? nc : 0, 0);
    s.p16[3].assign(s.transparency ? ny : 0, 0);
  }
  for (int i = 0; i < s.slice_count; ++i) s.decode_slice(s.slices[size_t(i)]);
  s.output(out);
  return true;
}

}  // namespace viai_video
