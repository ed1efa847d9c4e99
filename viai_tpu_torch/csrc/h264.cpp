// The H.264 decoder of viai_tpu_torch's video reader (videodec.cpp):
// frame pictures of the Baseline, Main, High, High 10, High 4:2:2 and
// High 4:4:4 Predictive profiles (and their Intra profiles, CAVLC 4:4:4
// Intra too) at 8, 9, 10, 12 and 14 bits, 4:2:0, 4:2:2, 4:4:4 (its GBR
// too: matrix_coefficients 0) and monochrome, lossless coding
// (qpprime_y_zero_transform_bypass) at every sampling, progressive or as
// progressive frames of an interlace-capable stream (frame_mbs_only_flag
// 0 without MBAFF), decoded as ITU-T H.264 (08/2021) specifies and
// output in the order and number libavcodec's decoder gives them to cv2.
//
//   * parsing: NAL units (Annex B start codes, or the length prefixes of
//     an avcC record), emulation prevention, SPS with VUI (HRD delay
//     lengths, pic_struct_present_flag, chroma siting), cropping (crop
//     units of 1 in 4:4:4) and scaling lists (twelve in 4:4:4), PPS with
//     transform_8x8_mode_flag and its lists (fall-back rules A and B),
//     slice headers, pred_weight_table, dec_ref_pic_marking, picture
//     timing SEI, libx264's build from its user data SEI;
//   * entropy decoding: CAVLC (9.2, chroma DC of nC -1 and -2) and CABAC
//     (9.3: the arithmetic engine bit by bit, context initialisation of
//     the 1024 contexts, every syntax element of frame coding for
//     ChromaArrayType 0 to 3: 4:4:4's Cb and Cr coded as luma in block
//     categories 6-13 with their own neighbours, and the coded_block_flag
//     of its 8x8 blocks; I_PCM with the engine's re-initialisation);
//   * macroblocks: I_PCM (at the bit depth, three full planes in 4:4:4),
//     Intra_16x16/4x4/8x8 (reference sample filtering; each plane coded as
//     luma with the luma modes), intra chroma on 8x8 and 8x16, P and B
//     partitions down to 4x4, P_Skip, B_Skip and B_Direct (spatial and
//     temporal, with and without direct_8x8_inference_flag), several
//     reference frames, list modification (long-term pictures too),
//     explicit weighted prediction in P and B slices (offsets scaled to
//     the depth; libavcodec's rounding of B's) and implicit weights in B
//     slices (equal for a long-term reference), direct prediction with a
//     long-term reference; quarter-sample luma (6-tap) and chroma interpolation
//     (eighth-sample, vertically quarter-sample for 4:2:2; 4:4:4's
//     chroma as luma), references read clamped to the picture;
//   * transforms: 4x4 and 8x8 inverse transforms, luma DC (Hadamard),
//     chroma DC 2x2 and 2x4 (4:2:2, at QP'c + 3), scaling with flat or
//     custom matrices and QpBdOffset; transform bypass where QP'Y is 0
//     (the residual added as it is; the Intra_NxN, Intra_16x16 and
//     chroma horizontal and vertical modes accumulating it, 8.3.5.1, in
//     the High 4:4:4 Predictive profile as libavcodec does);
//   * the deblocking filter (8.7) with the slice's offsets and
//     disable_deblocking_filter_idc 0, 1 and 2, bS of 8x8-transform
//     edges, 4:2:2's chroma edges, 4:4:4's chroma filtered as luma (bS
//     from the luma coefficients, as libavcodec takes it), thresholds
//     scaled to the depth;
//   * references: several slices a picture, POC types 0, 1 and 2, the
//     sliding window, long-term references (an IDR picture's
//     long_term_reference_flag) and memory_management_control_operation
//     1 to 6 (MMCO 5 with libavcodec's POC and output barrier), IDR;
//     gaps in frame_num filled as libavcodec fills them (copies of the
//     newest reference, mid-grey before a recovered picture), with the
//     SPS's flag or without it; streams that start elsewhere than at an
//     IDR picture (copy cuts), their pictures before a recovery point
//     (its SEI, or libavcodec's heuristic for an I picture) dropped as
//     libavcodec drops them, a missing reference replaced by its list's
//     first (libavcodec's default_ref);
//   * output: libavcodec's h264_select_output_frame (its reorder depth
//     from the VUI's max_num_reorder_frames, else guessed from its POC
//     history, which an IDR slice restarts, from where the caller sets
//     it: set_delay, libavformat's probe; its keyframe barriers: IDR
//     pictures and I pictures with a recovery point SEI) and, at
//     the end of the stream, its draining; the picture cropped by the
//     SPS's frame cropping, with the VUI's range, matrix and chroma
//     siting (Picture::full_range, matrix, chroma_loc; a left crop as
//     libavcodec aligns it, the picture then scaled to the cropped size as
//     cv2's swscale scales it: Picture::shown_w), samples of 8 bits
//     or 16 (Picture::y16...), monochrome with libavcodec's neutral
//     chroma, 4:4:4 of matrix_coefficients 0 as planar G, B, R
//     (Picture::rgb: libavcodec's gbrp, gbrp10 ...).
//
// Samples are uint8_t at 8 bits and uint16_t above; the reconstruction
// is written once, templated on the sample type (pixels()).
//
// Everything else raises NotImplementedError (code 2) naming it:
// interlaced coding (field pictures, MBAFF) and frames a picture timing
// SEI flags interlaced (libavcodec marks them so and cv2 cannot convert
// them), what libavcodec refuses too (separate_colour_plane_flag, luma
// and chroma of different depths, 11 and 13 bits), 4:4:4 CABAC and
// lossless coding with the 8x8 transform from libx264 before build 151
// (which libavcodec reads with a workaround), SP/SI slices, slice groups
// (FMO), arbitrary slice order (ASO) and redundant pictures, data
// partitioning, and a picture output whose slices lost their references
// (libavcodec conceals it; its error concealment is not copied). A stream
// that breaks the syntax raises ValueError (code 1); libavcodec conceals
// such slices too.

#include <algorithm>
#include <array>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <string>
#include <vector>

#include "h264_tables.h"
#include "video.h"

namespace viai_video {

namespace {

using namespace h264;

inline int clip3(int lo, int hi, int v) { return v < lo ? lo : v > hi ? hi : v; }
inline int median3(int a, int b, int c) {
  return std::max(std::min(a, b), std::min(std::max(a, b), c));
}

// ------------------------------------------------------------ bits

// An RBSP read MSB first; reads past its end give zeros (and are caught
// by the callers' length checks).
struct Bits {
  const uint8_t* p = nullptr;
  size_t n = 0;      // bytes
  size_t pos = 0;    // bit position
  bool padded = false;  // 8 zero bytes follow p[n - 1]

  uint32_t peek32() const {
    size_t b = pos >> 3;
    uint64_t w = 0;
    if (padded && b < n) {
      std::memcpy(&w, p + b, 8);
      return uint32_t(__builtin_bswap64(w) >> (32 - (pos & 7)));
    }
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
    if (w == 0) broken("H.264 Exp-Golomb code too long");
    int lz = __builtin_clz(w);
    pos += size_t(lz);
    return u(lz + 1) - 1;
  }
  int32_t se() {
    uint32_t k = ue();
    return (k & 1) ? int32_t((k + 1) >> 1) : -int32_t(k >> 1);
  }
  size_t bits_left() const { return n * 8 > pos ? n * 8 - pos : 0; }
  bool over() const { return pos > n * 8; }
  bool aligned() const { return (pos & 7) == 0; }
};

// The RBSP of a NAL unit's payload: emulation_prevention_three_byte
// removed.
std::vector<uint8_t> unescape(const uint8_t* d, size_t n) {
  std::vector<uint8_t> out;
  out.reserve(n);
  int zeros = 0;
  for (size_t i = 0; i < n; ++i) {
    if (zeros >= 2 && d[i] == 3) {
      zeros = 0;
      continue;
    }
    out.push_back(d[i]);
    zeros = d[i] == 0 ? zeros + 1 : 0;
  }
  return out;
}

// The bit position of the rbsp_stop_one_bit (the last 1 in the RBSP).
size_t stop_bit(const std::vector<uint8_t>& r) {
  size_t i = r.size();
  while (i > 0 && r[i - 1] == 0) --i;
  if (i == 0) return 0;
  int b = __builtin_ctz(r[i - 1]);
  return (i - 1) * 8 + size_t(7 - b);
}

// ------------------------------------------------------ parameter sets

struct Sps {
  bool valid = false;
  bool scaling_present = false;
  uint8_t scaling4[6][16];      // raster order, after fall-back rule A
  // Intra Y, Inter Y, Intra Cb, Inter Cb, Intra Cr, Inter Cr (the
  // chroma lists are coded in 4:4:4 only)
  uint8_t scaling8[6][64];
  int profile = 0, level = 0;   // profile_idc, level_idc
  int log2_max_frame_num = 4, poc_type = 0, log2_max_poc_lsb = 4;
  // POC type 1: delta_pic_order_always_zero_flag, offset_for_non_ref_pic,
  // offset_for_top_to_bottom_field and the cycle of offset_for_ref_frame
  bool delta_always_zero = false;
  int offset_non_ref = 0, offset_top_bottom = 0;
  std::vector<int> offset_ref;
  int max_num_ref_frames = 0;
  bool gaps_allowed = false;    // gaps_in_frame_num_value_allowed_flag
  int mb_w = 0, mb_h = 0;       // mb_h: FrameHeightInMbs
  int cfi = 1;                  // chroma_format_idc: 0 (4:0:0), 1, 2, 3
  int depth = 8;                // BitDepthY = BitDepthC
  bool bypass = false;          // qpprime_y_zero_transform_bypass_flag
  bool frame_mbs_only = true, mbaff = false;
  bool direct_8x8_inference = false;
  int crop_l = 0, crop_r = 0, crop_t = 0, crop_b = 0;
  int crop_ux = 2, crop_uy = 2;  // CropUnitX, CropUnitY
  bool full_range = false;
  int matrix = 2;               // matrix_coefficients (2: unspecified)
  int chroma_loc = 1;           // libavcodec's AVChromaLocation: left, or
                                // the VUI's chroma_sample_loc_type + 1
  bool bitstream_restriction = false;
  int num_reorder_frames = 0;
  // The VUI's timing_info (0 without it, or with a field of 0, which
  // libavcodec ignores).
  uint32_t num_units_in_tick = 0, time_scale = 0;
  // What a picture timing SEI holds: the HRD's delay fields (their
  // lengths when an HRD is present), pic_struct, time_offset's length.
  bool hrd = false, pic_struct_present = false;
  int cpb_len = 24, dpb_len = 24, time_offset_len = 24;
};

struct Pps {
  bool valid = false;
  int sps_id = 0;
  bool cabac = false, bottom_field_pic_order = false;
  int num_ref_idx_default[2] = {1, 1};
  bool weighted_pred = false;
  int weighted_bipred_idc = 0;
  int pic_init_qp = 26;
  int chroma_qp_offset[2] = {0, 0};
  bool deblocking_control = false, constrained_intra = false;
  bool transform_8x8 = false;
  bool scaling_present = false;
  bool list_present[12] = {};
  bool list_default[12] = {};   // useDefaultScalingMatrixFlag
  uint8_t lists[12][64] = {};   // as parsed, zigzag order
};

// scaling_list(): into `out` (zigzag order); → useDefaultScalingMatrixFlag.
bool read_scaling_list(Bits& b, uint8_t* out, int size) {
  int last = 8, next = 8;
  bool use_default = false;
  for (int j = 0; j < size; ++j) {
    if (next != 0) {
      int delta = b.se();
      if (delta < -128 || delta > 127) broken("H.264 scaling list delta out of range");
      next = (last + delta + 256) % 256;
      use_default = (j == 0 && next == 0);
    }
    out[j] = uint8_t(next == 0 ? last : next);
    last = out[j];
  }
  return use_default;
}

void to_raster4(const uint8_t* zz, uint8_t* raster) {
  for (int k = 0; k < 16; ++k) raster[kZigzag4[k]] = zz[k];
}
void to_raster8(const uint8_t* zz, uint8_t* raster) {
  for (int k = 0; k < 64; ++k) raster[kZigzag8[k]] = zz[k];
}

void parse_vui(Bits& b, Sps& s) {
  if (b.u1()) {                                   // aspect_ratio_info
    if (b.u(8) == 255) b.u(32);
  }
  if (b.u1()) b.u1();                             // overscan
  if (b.u1()) {                                   // video_signal_type
    b.u(3);
    s.full_range = b.u1();
    if (b.u1()) {                                 // colour_description
      b.u(8);
      b.u(8);
      s.matrix = int(b.u(8));
    }
  }
  if (b.u1()) {                                   // chroma_loc_info
    uint32_t top = b.ue();
    b.ue();
    if (top <= 5) s.chroma_loc = int(top) + 1;
  }
  if (b.u1()) {                                   // timing_info
    s.num_units_in_tick = b.u(32);
    s.time_scale = b.u(32);
    if (!s.num_units_in_tick || !s.time_scale)
      s.num_units_in_tick = s.time_scale = 0;
    b.u1();
  }
  auto hrd = [&]() {
    int cnt = int(b.ue()) + 1;
    if (cnt > 32) broken("H.264 HRD with too many schedules");
    b.u(4);
    b.u(4);
    for (int i = 0; i < cnt; ++i) {
      b.ue();
      b.ue();
      b.u1();
    }
    b.u(5);
    s.cpb_len = int(b.u(5)) + 1;
    s.dpb_len = int(b.u(5)) + 1;
    s.time_offset_len = int(b.u(5));
  };
  bool nal_hrd = b.u1();
  if (nal_hrd) hrd();
  bool vcl_hrd = b.u1();
  if (vcl_hrd) hrd();
  s.hrd = nal_hrd || vcl_hrd;
  if (s.hrd) b.u1();                              // low_delay_hrd_flag
  s.pic_struct_present = b.u1();
  s.bitstream_restriction = b.u1();
  if (s.bitstream_restriction) {
    b.u1();
    b.ue();
    b.ue();
    b.ue();
    b.ue();
    s.num_reorder_frames = int(b.ue());
    b.ue();                                       // max_dec_frame_buffering
    if (s.num_reorder_frames > 16) broken("H.264 max_num_reorder_frames above 16");
  }
}

void parse_sps(Bits& b, Sps* table) {
  Sps s;
  int p = int(b.u(8));                            // profile_idc
  b.u(8);                                         // constraint flags
  s.profile = p;
  s.level = int(b.u(8));
  uint32_t id = b.ue();
  if (id > 31) broken("H.264 seq_parameter_set_id above 31");
  for (int i = 0; i < 6; ++i) std::memset(s.scaling4[i], 16, 16);
  for (int i = 0; i < 6; ++i) std::memset(s.scaling8[i], 16, 64);
  if (p == 100 || p == 110 || p == 122 || p == 244 || p == 44 || p == 83 ||
      p == 86 || p == 118 || p == 128 || p == 138 || p == 139 || p == 134 ||
      p == 135) {
    uint32_t chroma_format_idc = b.ue();
    if (chroma_format_idc > 3) broken("H.264 chroma_format_idc above 3");
    if (chroma_format_idc == 3 && b.u1())
      unsupported("H.264 4:4:4 with separate_colour_plane_flag (libavcodec "
                  "refuses it too)");
    uint32_t depth_luma = b.ue() + 8, depth_chroma = b.ue() + 8;
    if (depth_luma > 14 || depth_chroma > 14) broken("H.264 bit depth above 14");
    s.bypass = b.u1();
    if (depth_luma != depth_chroma)
      unsupported("H.264 luma and chroma of different bit depths (" +
                  std::to_string(depth_luma) + " and " + std::to_string(depth_chroma) +
                  "; libavcodec refuses them too)");
    if (depth_luma == 11 || depth_luma == 13)
      unsupported("H.264 at " + std::to_string(depth_luma) +
                  "-bit (libavcodec refuses 11 and 13 bits too)");
    s.cfi = int(chroma_format_idc);
    s.depth = int(depth_luma);
    s.scaling_present = b.u1();
    if (s.scaling_present) {
      uint8_t zz[64];
      for (int i = 0; i < (s.cfi == 3 ? 12 : 8); ++i) {
        bool present = b.u1();
        bool is4 = i < 6;
        const uint8_t* fallback = nullptr;
        uint8_t def[64];
        if (is4) to_raster4(kDefaultScaling4[i < 3 ? 0 : 1], def);
        else to_raster8(kDefaultScaling8[i % 2], def);
        if (present) {
          bool use_def = read_scaling_list(b, zz, is4 ? 16 : 64);
          if (use_def) {
            fallback = def;
          } else {
            if (is4) to_raster4(zz, s.scaling4[i]);
            else to_raster8(zz, s.scaling8[i - 6]);
            continue;
          }
        } else {
          // Fall-back rule A: Y's lists from the defaults, Cb's from Y's,
          // Cr's from Cb's.
          if (i == 0 || i == 3 || i == 6 || i == 7) fallback = def;
          else if (is4) fallback = s.scaling4[i - 1];
          else fallback = s.scaling8[i - 8];
        }
        if (is4) std::memcpy(s.scaling4[i], fallback, 16);
        else std::memcpy(s.scaling8[i - 6], fallback, 64);
      }
    }
  }
  s.log2_max_frame_num = int(b.ue()) + 4;
  if (s.log2_max_frame_num > 16) broken("H.264 log2_max_frame_num above 16");
  s.poc_type = int(b.ue());
  if (s.poc_type == 0) {
    s.log2_max_poc_lsb = int(b.ue()) + 4;
    if (s.log2_max_poc_lsb > 16) broken("H.264 log2_max_pic_order_cnt_lsb above 16");
  } else if (s.poc_type == 1) {
    s.delta_always_zero = b.u1();
    s.offset_non_ref = b.se();
    s.offset_top_bottom = b.se();
    uint32_t cycle = b.ue();
    if (cycle > 255) broken("H.264 num_ref_frames_in_pic_order_cnt_cycle above 255");
    for (uint32_t i = 0; i < cycle; ++i) s.offset_ref.push_back(b.se());
  } else if (s.poc_type != 2) {
    broken("H.264 pic_order_cnt_type above 2");
  }
  s.max_num_ref_frames = int(b.ue());
  if (s.max_num_ref_frames > 16) broken("H.264 max_num_ref_frames above 16");
  // Gaps in frame_num are filled with frames that are never output,
  // with the flag or without it (as libavcodec conceals them).
  s.gaps_allowed = b.u1();
  s.mb_w = int(b.ue()) + 1;
  int map_units = int(b.ue()) + 1;                // PicHeightInMapUnits
  if (s.mb_w > 1024 || map_units > 1024) broken("H.264 picture too large");
  // frame_mbs_only_flag 0: the stream may code field pictures (which
  // raise) or MBAFF frames (mb_adaptive_frame_field_flag: raise); frame
  // pictures without MBAFF (progressive frames of an interlace-capable
  // stream, "PsF") are read. Frames are then twice the map units high.
  s.frame_mbs_only = b.u1();
  if (!s.frame_mbs_only) s.mbaff = b.u1();
  s.mb_h = map_units * (s.frame_mbs_only ? 1 : 2);
  s.direct_8x8_inference = b.u1();
  s.crop_ux = s.cfi == 0 || s.cfi == 3 ? 1 : 2;   // SubWidthC
  s.crop_uy = (s.cfi == 1 ? 2 : 1) * (s.frame_mbs_only ? 1 : 2);
  if (b.u1()) {                                   // frame_cropping
    s.crop_l = int(b.ue());
    s.crop_r = int(b.ue());
    s.crop_t = int(b.ue());
    s.crop_b = int(b.ue());
    if (int64_t(s.crop_ux) * (s.crop_l + s.crop_r) >= 16 * s.mb_w ||
        int64_t(s.crop_uy) * (s.crop_t + s.crop_b) >= 16 * s.mb_h)
      broken("H.264 frame cropping larger than the picture");
  }
  if (b.u1()) parse_vui(b, s);
  if (b.over()) broken("H.264 SPS cut short");
  s.valid = true;
  table[id] = s;
}

void parse_pps(Bits& b, const Sps* spss, Pps* table, size_t stop) {
  Pps q;
  uint32_t id = b.ue();
  if (id > 255) broken("H.264 pic_parameter_set_id above 255");
  q.sps_id = int(b.ue());
  if (q.sps_id > 31 || !spss[q.sps_id].valid) broken("H.264 PPS refers to a missing SPS");
  q.cabac = b.u1();
  q.bottom_field_pic_order = b.u1();
  if (b.ue() > 0) unsupported("H.264 slice groups (FMO)");
  q.num_ref_idx_default[0] = int(b.ue()) + 1;
  q.num_ref_idx_default[1] = int(b.ue()) + 1;
  if (q.num_ref_idx_default[0] > 32 || q.num_ref_idx_default[1] > 32)
    broken("H.264 num_ref_idx_default above 32");
  q.weighted_pred = b.u1();
  q.weighted_bipred_idc = int(b.u(2));
  q.pic_init_qp = 26 + b.se();                    // SliceQPY's base
  b.se();                                         // pic_init_qs
  q.chroma_qp_offset[0] = q.chroma_qp_offset[1] = b.se();
  q.deblocking_control = b.u1();
  q.constrained_intra = b.u1();
  if (b.u1()) unsupported("H.264 redundant pictures (redundant_pic_cnt_present_flag)");
  if (b.pos < stop) {
    q.transform_8x8 = b.u1();
    q.scaling_present = b.u1();
    if (q.scaling_present) {
      int lists = 6 + (q.transform_8x8 ? (spss[q.sps_id].cfi == 3 ? 6 : 2) : 0);
      for (int i = 0; i < lists; ++i) {
        q.list_present[i] = b.u1();
        if (q.list_present[i])
          q.list_default[i] = read_scaling_list(b, q.lists[i], i < 6 ? 16 : 64);
      }
    }
    q.chroma_qp_offset[1] = b.se();
  }
  if (q.pic_init_qp < -6 * (spss[q.sps_id].depth - 8) || q.pic_init_qp > 51)
    broken("H.264 pic_init_qp out of range");
  if (b.over()) broken("H.264 PPS cut short");
  q.valid = true;
  table[id] = q;
}

// ------------------------------------------------------------ pictures

enum MbKind : uint8_t { kI4x4, kI8x8, kI16x16, kPcm, kInter };

struct MbInfo {
  int slice = -1;               // slice number in the picture; -1 not decoded
  uint8_t kind = kInter;
  bool skip = false;            // P_Skip, B_Skip
  bool direct16 = false;        // B_Skip, B_Direct_16x16
  bool t8x8 = false;
  uint8_t cbp = 0;              // luma bits 0-3, chroma << 4
  // QPY and the QPc of Cb and Cr (deblocking; scaling adds QpBdOffset);
  // I_PCM's are those of QP'Y 0, as libavcodec's deblocking reads them.
  int8_t qp = 0;
  int8_t qpc[2] = {0, 0};
  uint8_t chroma_mode = 0;
  // coded_block_flag of the DC blocks: luma's Intra16x16 (1), Cb's (2)
  // and Cr's (4), chroma DC in 4:2:0 and 4:2:2, Intra16x16 in 4:4:4
  uint8_t dc_cbf = 0;
  uint8_t direct8 = 0;          // bit per 8x8: direct predicted
  int8_t ipred[16];             // Intra4x4/8x8 modes, raster 4x4 blocks
  // TotalCoeff of each 4x4 block: luma's in raster order at 0..15, Cb's
  // at 16.. and Cr's at 32.. (their own raster: 4 wide in 4:4:4, else 2)
  uint8_t nz[48];
  int16_t mv[2][16][2];
  uint8_t mvd[2][16][2];        // |mvd| (CABAC contexts)
  int8_t ref[2][4];             // refIdx per 8x8, -1 not used
  int32_t refid[2][4];          // the referenced frame's uid, -1
  int32_t dbk[2][4];            // and its dbk_id (deblocking)
  bool intra() const { return kind != kInter; }
};

struct Frame {
  int id = 0;                   // its buffer (a gap frame's copy shares it)
  int uid = 0;                  // the picture
  int64_t source = 0;           // the decode() call of its first slice
  int w = 0, h = 0;             // coded size (luma)
  int cw = 0, ch = 0;           // chroma size (w / 2 but for 4:4:4; h / 2
                                // but for 4:2:2 and 4:4:4)
  int cfi = 1, depth = 8;       // chroma_format_idc, bit depth
  // The planes' samples: bytes (8-bit) or uint16_t (9 to 14-bit).
  // Monochrome pictures carry neutral 4:2:0 chroma, as libavcodec
  // outputs them.
  std::vector<uint8_t> y, u, v;
  int poc = 0, frame_num = 0;
  bool key = false;             // an IDR picture or a recovery point
  bool mmco_reset = false;
  int pic_type = -1;            // its first slice's type (0 P, 1 B, 2 I);
                                // -1 a frame filling a gap in frame_num
  // libavcodec's H264Picture::recovered: 1 an IDR picture, 2 its
  // recovery point (SEI) reached, 4 an I picture its heuristic takes for
  // one; pictures output without it are dropped
  int recovered = 0;
  bool gray = false;            // a gap frame filled with mid-grey
  bool invalid_gap = false;     // a gap frame without the SPS's flag
  bool long_term = false;       // a long-term reference
  int long_idx = -1;            // its LongTermFrameIdx
  bool failed = false;          // a slice lost its references: not decoded
  std::vector<MbInfo> mbs;      // motion of the picture (temporal direct)
  // cropping and colour, from the SPS it was decoded with: the output's
  // size and its top left corner in the decoded picture
  int out_w = 0, out_h = 0, out_x = 0, out_y = 0;
  int shown_w = 0;              // the SPS's cropped width (cv2's size)
  bool full_range = false;
  int matrix = 2, chroma_loc = 1;
  bool rgb = false;             // planar G, B, R (4:4:4, matrix_coefficients 0)
};
using FramePtr = std::shared_ptr<Frame>;

// --------------------------------------------------------------- CABAC

struct Cabac {
  Bits* b = nullptr;
  uint32_t range = 0, offset = 0;
  uint8_t state[1024];          // pStateIdx << 1 | valMPS

  void init_contexts(int slice_qp, int idc, bool islice) {
    int qp = clip3(0, 51, slice_qp);
    for (int i = 0; i < 1024; ++i) {
      int m = islice ? kCabacInitI[i][0] : kCabacInitPB[idc][i][0];
      int n = islice ? kCabacInitI[i][1] : kCabacInitPB[idc][i][1];
      int pre = clip3(1, 126, ((m * qp) >> 4) + n);
      state[i] = pre <= 63 ? uint8_t((63 - pre) << 1) : uint8_t(((pre - 64) << 1) | 1);
    }
  }
  void init_engine() {
    range = 510;
    offset = b->u(9);
    if (offset == 510 || offset == 511) broken("H.264 CABAC offset out of range");
  }
  int decision(int ctx) {
    uint8_t& s = state[ctx];
    int p = s >> 1, mps = s & 1;
    uint32_t lps = kRangeLps[p][(range >> 6) & 3];
    range -= lps;
    int bin;
    if (offset >= range) {
      bin = !mps;
      offset -= range;
      range = lps;
      if (p == 0) mps = 1 - mps;
      s = uint8_t((kTransLps[p] << 1) | mps);
    } else {
      bin = mps;
      s = uint8_t((kTransMps[p] << 1) | mps);
    }
    renorm();
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
  int terminate() {
    range -= 2;
    if (offset >= range) return 1;
    renorm();
    return 0;
  }
  // RenormD: the shifts that bring the range to 256 or more, with as
  // many bits read into the offset.
  void renorm() {
    int n = __builtin_clz(range) - 23;
    if (n > 0) {
      range <<= n;
      offset = (offset << n) | b->u(n);
    }
  }
};

// --------------------------------------------------------- slice header

struct SliceHeader {
  int nal_type = 0, nal_ref_idc = 0;
  int first_mb = 0, type = 0;   // 0 P, 1 B, 2 I
  int pps_id = 0, frame_num = 0;
  int poc_lsb = 0, delta_poc_bottom = 0;
  int delta_poc[2] = {0, 0};    // POC type 1: delta_pic_order_cnt[0..1]
  bool direct_spatial = false;
  int num_ref_idx[2] = {0, 0};
  struct Mod {
    int idc, val;
  };
  std::vector<Mod> mods[2];
  int luma_log2 = 0, chroma_log2 = 0;
  int lw[2][32] = {}, lo[2][32] = {}, cw[2][32][2] = {}, co[2][32][2] = {};
  bool lw_flag[2][32] = {}, cw_flag[2][32] = {};
  bool adaptive_marking = false;
  bool long_term_ref = false;   // an IDR picture's long_term_reference_flag
  // memory_management_control_operation and its arguments: a the
  // picture number (difference_of_pic_nums_minus1 of 1 and 3,
  // long_term_pic_num of 2), b the long-term index (long_term_frame_idx
  // of 3 and 6, max_long_term_frame_idx_plus1 of 4)
  struct Mmco {
    int op, a, b;
  };
  std::vector<Mmco> mmco;
  int cabac_init_idc = 0;
  int qp = 26;
  int deblock_idc = 0, alpha_off = 0, beta_off = 0;
};

constexpr int kMaxDelayed = 16;   // libavcodec's MAX_DELAYED_PIC_COUNT
constexpr int32_t kUnknownRef = 0x7FFFFF00;   // see build_lists
constexpr int kPocMin = -0x7FFFFFFF - 1;

// Luma 4x4 block index (z-order, luma4x4BlkIdx) → raster index.
constexpr int kBlkRaster[16] = {0, 1, 4, 5, 2, 3, 6, 7,
                                8, 9, 12, 13, 10, 11, 14, 15};

// The left edge of the picture cv2 is handed: the SPS's left crop as
// libavcodec's av_frame_apply_cropping aligns it (cv2's decoder does not
// set AV_CODEC_FLAG_UNALIGNED). The planes' offsets are
// crop_top * linesize + (crop_left >> SubWidth) * bytes a sample; with
// linesizes of 32 bytes or more, the fewest trailing zero bits m of the
// offsets' column parts decide: below 5, crop_left is rounded down to a
// multiple of 2^(5 + ctz(crop_left) - m). The output keeps the cropped
// width, so it then starts left of the crop and ends short of the right
// edge. cv2 converts from the frame's data pointers at avctx's (fully
// cropped) size.
int crop_x(const Sps& s) {
  int left = s.crop_ux * s.crop_l;
  if (left == 0) return 0;
  const int bytes = s.depth > 8 ? 2 : 1;
  int m = __builtin_ctz(unsigned(left * bytes));
  if (s.cfi == 1 || s.cfi == 2) {
    int c = (left >> 1) * bytes;
    if (c) m = std::min(m, __builtin_ctz(unsigned(c)));
  }
  if (m < 5) left &= ~((1 << (5 + __builtin_ctz(unsigned(left)) - m)) - 1);
  return left;
}

}  // namespace

// =====================================================================
// The decoder
// =====================================================================

struct H264Decoder::State {
  Sps sps_table[32];
  Pps pps_table[256];
  int nal_len = 0;              // 0: Annex B; 1..4: avcC length prefixes

  // the active parameter sets and the picture being decoded
  Sps sps;
  Pps pps;
  FramePtr cur;
  int slice_num = 0;
  int last_first_mb = 0;
  int next_id = 1;
  int64_t calls = 0;            // decode() calls so far
  bool cur_idr = false;
  SliceHeader first_sh;         // the picture's first slice header
  int pic_w = 0, pic_h = 0, mb_w = 0, mb_h = 0;

  // references and POC state, as libavcodec keeps them (h264_refs.c,
  // h264_parse.c): the short-term references oldest first (libavcodec's
  // short_ref backwards), the long-term ones by LongTermFrameIdx; the
  // POC's previous values (a fresh decoder's prev_poc_msb is 1 << 16 and
  // its prev_frame_num -1, so a stream that starts at a later frame_num
  // begins with a gap)
  std::vector<FramePtr> refs;
  FramePtr long_refs[16];
  int long_count = 0;
  int poc_msb = 0, poc_lsb = 0, prev_poc_msb = 1 << 16, prev_poc_lsb = 0;
  int prev_frame_num_offset = 0, prev_frame_num = -1;
  int frame_num_offset = 0;
  int frame_num = 0;            // h->poc.frame_num: 0 after an MMCO 5
  bool mmco_reset_next = false; // h->mmco_reset: flags the next picture
  // Recovery (h264_field_start, h264_select_output_frame): the packet's
  // recovery point SEI (its recovery_frame_cnt, -1 none), the frame_num
  // it names, whether the stream has had a valid one, and
  // frame_recovered (1 an IDR picture seen, 2 a recovered picture
  // output).
  int sei_recovery = -1;
  int recovery_frame = -1;
  bool valid_recovery_point = false;
  int frame_recovered = 0;
  bool non_gray = false;        // an I picture came after the grey gap frames
  // The slice's first entries of its initial lists (libavcodec's
  // default_ref: what stands in for a missing reference).
  FramePtr default_ref[2];

  // the active picture format: ChromaArrayType (0 to 3), NumC8x8 (4:2:0
  // and 4:2:2), a macroblock's chroma columns and rows (MbWidthC,
  // MbHeightC), the coded planes (3 in 4:4:4, where Cb and Cr are coded
  // as luma; else 1), bit depth, its largest sample and QpBdOffset
  int cfi = 1, nc8 = 1, mbwc = 8, mbhc = 8, planes = 1, depth = 8, pmax = 255,
      qp_bd = 0;

  // libavcodec's picture timing SEI state (h264_sei.c): the payload
  // of the packet's pic_timing message, read with the SPS of the
  // picture it precedes; whether the last picture was flagged
  // interlaced (1 before the first)
  std::vector<uint8_t> pic_timing;
  bool prev_interlaced = true;
  // libx264's build from its SEI user data (libavcodec's x264_build; -1
  // unknown): before build 151 libx264 took 4:4:4's 8x8 coded_block_flag
  // contexts and lossless 8x8 horizontal and vertical prediction
  // otherwise, which libavcodec reads with workarounds not copied here.
  int x264_build = -1;

  // libavcodec's output state
  bool headers_only = false;    // order pictures without decoding them
  bool guesses_delay = false;   // a B slice under an SPS without
                                // bitstream_restriction was seen
  int has_b_frames = 0;
  int last_pocs[kMaxDelayed];
  int next_outputed_poc = kPocMin;
  std::vector<FramePtr> delayed;
  FramePtr next_output;

  // the slice being decoded
  SliceHeader sh;
  Bits bits;
  Cabac cabac;
  std::vector<FramePtr> list[2];
  bool lists_ok = true;         // the slice's lists have every picture
  int32_t dbk_id[2][32];        // their entries as the deblocking filter
                                // tells them apart
  int ls4[6][6][16];            // LevelScale4x4[list][qP % 6][raster]
  int ls8[6][6][64];            // LevelScale8x8, lists as Sps::scaling8
  int implicit_w[32][32][2];
  bool use_implicit = false;
  int qp = 0;                   // QPY of the last macroblock decoded
  int prev_qp_delta_nz = 0;
  int mb_x = 0, mb_y = 0, mb_addr = 0;
  MbInfo* mb = nullptr;
  std::vector<MbInfo>* mbs = nullptr;

  // the macroblock's residual (raster positions), by plane coded as
  // luma (Y; Cb and Cr in 4:4:4)
  int32_t coef[3][16][16];      // 4x4 blocks (raster block index)
  int32_t coef8[3][4][64];      // 8x8 blocks
  int32_t dc[3][16];            // Intra16x16 DC (scan order)
  int32_t cdc[2][8];
  int32_t cac[2][8][16];
  bool done4[16];               // motion assigned (current MB, raster 4x4)
  bool bypass = false;          // TransformBypassModeFlag of the macroblock
  // Whether lossless intra blocks of the horizontal and vertical modes
  // accumulate their residual (8.3.5.1): libavcodec does so in the High
  // 4:4:4 Predictive profile only (profile_idc 244), not in CAVLC 4:4:4
  // Intra.
  bool lossless_pred = false;

  State() {
    for (int i = 0; i < kMaxDelayed; ++i) last_pocs[i] = kPocMin;
  }

  // -------------------------------------------------------- NAL units

  template <class F>
  void for_each_nal(const uint8_t* d, size_t n, F&& f) {
    if (nal_len) {
      size_t p = 0;
      while (p + size_t(nal_len) <= n) {
        size_t len = 0;
        for (int i = 0; i < nal_len; ++i) len = (len << 8) | d[p + i];
        p += size_t(nal_len);
        if (len > n - p) broken("H.264 NAL unit runs past its packet");
        if (len) f(d + p, len);
        p += len;
      }
      return;
    }
    size_t p = 0, start = SIZE_MAX;
    while (p + 3 <= n) {
      if (d[p] == 0 && d[p + 1] == 0 && d[p + 2] == 1) {
        if (start != SIZE_MAX) {
          size_t e = p;
          while (e > start && d[e - 1] == 0) --e;
          if (e > start) f(d + start, e - start);
        }
        p += 3;
        start = p;
        continue;
      }
      ++p;
    }
    if (start == SIZE_MAX) {
      if (n) broken("H.264 packet without a start code");
      return;
    }
    size_t e = n;
    while (e > start && d[e - 1] == 0) --e;
    if (e > start) f(d + start, e - start);
  }

  void read_avcc(const std::vector<uint8_t>& c) {
    if (c.size() < 7 || c[0] != 1) broken("H.264 avcC record is bad");
    nal_len = (c[4] & 3) + 1;
    if (nal_len == 3) broken("H.264 avcC with 3-byte NAL lengths");
    size_t p = 5;
    for (int pass = 0; pass < 2; ++pass) {
      if (p >= c.size()) broken("H.264 avcC record cut short");
      int cnt = pass == 0 ? (c[p] & 31) : c[p];
      ++p;
      for (int i = 0; i < cnt; ++i) {
        if (p + 2 > c.size()) broken("H.264 avcC record cut short");
        size_t len = (size_t(c[p]) << 8) | c[p + 1];
        p += 2;
        if (p + len > c.size()) broken("H.264 avcC record cut short");
        parameter_set(&c[p], len);
        p += len;
      }
    }
  }

  // An SPS or PPS NAL unit (an SEI's libx264 build too); other kinds are
  // ignored.
  void parameter_set(const uint8_t* d, size_t n) {
    if (n < 1) return;
    int type = d[0] & 31;
    if (type == 6) return sei(d, n);
    if (type != 7 && type != 8) return;
    std::vector<uint8_t> r = unescape(d + 1, n - 1);
    Bits b{r.data(), r.size(), 0};
    if (type == 7) parse_sps(b, sps_table);
    else parse_pps(b, sps_table, pps_table, stop_bit(r));
  }

  // --------------------------------------------------------- decoding

  bool decode(const uint8_t* d, size_t n, Picture& out) {
    if (!step(d, n)) return false;
    check_whole(*next_output);
    to_picture(*next_output, out);
    next_output.reset();
    return true;
  }

  // One packet: whether a picture is output after it (next_output).
  bool step(const uint8_t* d, size_t n) {
    ++calls;
    pic_timing.clear();         // libavcodec forgets SEI between packets
    sei_recovery = -1;
    for_each_nal(d, n, [&](const uint8_t* u, size_t len) { nal(u, len); });
    if (cur) finish_picture();
    return next_output != nullptr;
  }

  void nal(const uint8_t* d, size_t n) {
    if (d[0] & 0x80) broken("H.264 forbidden_zero_bit set");
    int type = d[0] & 31;
    switch (type) {
      case 5:
        // libavcodec's idr() on every IDR slice: the references go, the
        // POC state and the history that guesses the reorder depth start
        // again.
        for (int& p : last_pocs) p = kPocMin;
        if (cur && n > 1 && (d[1] & 0x80)) finish_picture();   // first_mb_in_slice 0
        if (!cur) {
          refs.clear();
          for (auto& l : long_refs) l.reset();
          long_count = 0;
          default_ref[0].reset();
          default_ref[1].reset();
          prev_frame_num = prev_frame_num_offset = 0;
          prev_poc_msb = 1 << 16;
          prev_poc_lsb = -1;
        }
        slice(d, n);
        break;
      case 1:
        slice(d, n);
        break;
      case 2:
      case 3:
      case 4:
        unsupported("H.264 data partitioning (Extended profile)");
      case 6:
        sei(d, n);
        break;
      case 7:
      case 8:
        if (cur) finish_picture();
        parameter_set(d, n);
        break;
      default:                  // AUD, end of sequence, filler, ...
        break;
    }
  }

  // An SEI NAL unit: a pic_timing message's payload is kept (read when
  // the picture starts, with its SPS), libx264's build read from its user
  // data (h264_sei.c's sscanf); the rest are skipped.
  void sei(const uint8_t* d, size_t n) {
    std::vector<uint8_t> r = unescape(d + 1, n - 1);
    size_t p = 0, end = r.size();
    while (end > 0 && r[end - 1] == 0) --end;
    while (p + 2 <= end && !(p + 1 == end && r[p] == 0x80)) {
      int type = 0, size = 0;
      while (p < end && r[p] == 0xFF) type += r[p++];
      if (p >= end) return;
      type += r[p++];
      while (p < end && r[p] == 0xFF) size += r[p++];
      if (p >= end) return;
      size += r[p++];
      if (p + size_t(size) > end) return;    // libavcodec stops there too
      if (type == 1) pic_timing.assign(r.begin() + long(p), r.begin() + long(p + size_t(size)));
      if (type == 6) {                      // recovery point
        std::vector<uint8_t> q(r.begin() + long(p), r.begin() + long(p + size_t(size)));
        size_t qn = q.size();
        q.resize(qn + 8, 0);
        Bits b{q.data(), qn, 0};
        uint32_t w = b.peek32();
        if (w) {
          uint32_t cnt = b.ue();
          if (cnt < 65536 && !b.over()) sei_recovery = int(cnt);
        }
      }
      if (type == 5 && size >= 16) {
        std::string text(r.begin() + long(p + 16), r.begin() + long(p + size_t(size)));
        int build = 0;
        if (std::sscanf(text.c_str(), "x264 - core %d", &build) == 1) {
          if (build > 0) x264_build = build;
          if (build == 1 && text.compare(0, 16, "x264 - core 0000") == 0) x264_build = 67;
        }
      }
      p += size_t(size);
    }
  }

  // Whether libavcodec marks the picture about to start interlaced
  // (h264_field_start): by its picture timing SEI's pic_struct (fields,
  // or a frame shown as two fields after an interlaced one) and clock
  // timestamps, else by its coding (field pictures and MBAFF raise
  // before). cv2's swscale then refuses the frame ("Cannot convert
  // interlaced to progressive frames") and gives no picture of it.
  bool flagged_interlaced() {
    bool inter = false;
    if (sps.pic_struct_present && !pic_timing.empty()) {
      std::vector<uint8_t> r = pic_timing;
      size_t size = r.size();
      r.resize(size + 8, 0);
      Bits b{r.data(), size, 0};
      if (sps.hrd) {
        b.u(sps.cpb_len);
        b.u(sps.dpb_len);
      }
      int pic_struct = int(b.u(4));
      static const int kClockTs[9] = {1, 1, 1, 2, 2, 3, 3, 2, 3};
      if (pic_struct <= 8 && !b.over()) {
        int ct_type = 0;
        for (int i = 0; i < kClockTs[pic_struct]; ++i) {
          if (!b.u1()) continue;                  // clock_timestamp_flag
          ct_type |= 1 << b.u(2);
          b.u1();                                 // nuit_field_based_flag
          b.u(5);                                 // counting_type
          bool full = b.u1();
          b.u(2);                                 // discontinuity, cnt_dropped
          b.u(8);                                 // n_frames
          if (full) {
            b.u(17);
          } else if (b.u1()) {
            b.u(6);
            if (b.u1()) {
              b.u(6);
              if (b.u1()) b.u(5);
            }
          }
          b.u(sps.time_offset_len);
        }
        if (pic_struct == 1 || pic_struct == 2) inter = true;
        else if (pic_struct == 3 || pic_struct == 4) inter = prev_interlaced;
        if ((ct_type & 3) && pic_struct <= 4 && (ct_type & 2)) inter = true;
      }
    }
    prev_interlaced = inter;
    return inter;
  }

  void slice(const uint8_t* d, size_t n) {
    std::vector<uint8_t> r = unescape(d + 1, n - 1);
    size_t size = r.size();
    r.resize(size + 8, 0);      // the reader's padding
    bits = Bits{r.data(), size, 0, true};
    SliceHeader h;
    h.nal_type = d[0] & 31;
    h.nal_ref_idc = (d[0] >> 5) & 3;
    h.first_mb = int(bits.ue());
    uint32_t st = bits.ue();
    if (st > 9) broken("H.264 slice_type above 9");
    st %= 5;
    if (st == 3 || st == 4) unsupported("H.264 SP and SI slices (Extended profile)");
    h.type = int(st);
    h.pps_id = int(bits.ue());
    if (h.pps_id > 255) broken("H.264 pic_parameter_set_id above 255");
    // A slice before its PPS (a stream cut after its parameter sets):
    // libavcodec drops it.
    if (!pps_table[h.pps_id].valid) return;
    const Pps& p = pps_table[h.pps_id];
    const Sps& s = sps_table[p.sps_id];
    if (h.first_mb == 0 && cur) finish_picture();
    if (!cur) {
      sps = s;
      pps = p;
    } else if (h.pps_id != first_sh.pps_id) {
      pps = p;
      if (pps.sps_id != pps_table[first_sh.pps_id].sps_id)
        broken("H.264 slices of one picture with different SPS");
    }
    h.frame_num = int(bits.u(s.log2_max_frame_num));
    if (!s.frame_mbs_only && bits.u1())
      unsupported("H.264 interlaced coding (field pictures: field_pic_flag 1)");
    if (s.mbaff)
      unsupported("H.264 interlaced coding (MBAFF frames: mb_adaptive_frame_field_flag 1)");
    if (h.nal_type == 5) bits.ue();                 // idr_pic_id
    if (s.poc_type == 0) {
      h.poc_lsb = int(bits.u(s.log2_max_poc_lsb));
      if (p.bottom_field_pic_order) h.delta_poc_bottom = bits.se();
    }
    if (s.poc_type == 1 && !s.delta_always_zero) {
      h.delta_poc[0] = bits.se();
      if (p.bottom_field_pic_order) h.delta_poc[1] = bits.se();
    }
    if (h.type == 1) h.direct_spatial = bits.u1();
    if (h.type != 2) {
      h.num_ref_idx[0] = p.num_ref_idx_default[0];
      h.num_ref_idx[1] = h.type == 1 ? p.num_ref_idx_default[1] : 0;
      if (bits.u1()) {
        h.num_ref_idx[0] = int(bits.ue()) + 1;
        if (h.type == 1) h.num_ref_idx[1] = int(bits.ue()) + 1;
      }
      if (h.num_ref_idx[0] > 32 || h.num_ref_idx[1] > 32)
        broken("H.264 num_ref_idx_active above 32");
      for (int l = 0; l < (h.type == 1 ? 2 : 1); ++l) {
        if (!bits.u1()) continue;
        for (;;) {
          int idc = int(bits.ue());
          if (idc == 3) break;
          if (idc > 5) broken("H.264 modification_of_pic_nums_idc above 5");
          if (idc > 2) unsupported("H.264 MVC list modification");
          h.mods[l].push_back({idc, int(bits.ue())});
          if (h.mods[l].size() > 33) broken("H.264 too many list modifications");
        }
      }
    }
    if ((p.weighted_pred && h.type == 0) || (p.weighted_bipred_idc == 1 && h.type == 1)) {
      h.luma_log2 = int(bits.ue());
      h.chroma_log2 = s.cfi ? int(bits.ue()) : 0;
      if (h.luma_log2 > 7 || h.chroma_log2 > 7) broken("H.264 weight denominator above 7");
      for (int l = 0; l < (h.type == 1 ? 2 : 1); ++l)
        for (int i = 0; i < h.num_ref_idx[l]; ++i) {
          h.lw_flag[l][i] = bits.u1();
          h.lw[l][i] = 1 << h.luma_log2;
          h.lo[l][i] = 0;
          if (h.lw_flag[l][i]) {
            h.lw[l][i] = bits.se();
            h.lo[l][i] = bits.se();
          }
          h.cw_flag[l][i] = s.cfi != 0 && bits.u1();
          for (int c = 0; c < 2; ++c) {
            h.cw[l][i][c] = 1 << h.chroma_log2;
            h.co[l][i][c] = 0;
            if (h.cw_flag[l][i]) {
              h.cw[l][i][c] = bits.se();
              h.co[l][i][c] = bits.se();
            }
          }
        }
    }
    if (h.nal_ref_idc) {
      if (h.nal_type == 5) {
        bits.u1();                                // no_output_of_prior_pics
        h.long_term_ref = bits.u1();
      } else {
        h.adaptive_marking = bits.u1();
        if (h.adaptive_marking) {
          for (;;) {
            int op = int(bits.ue());
            if (op == 0) break;
            if (op > 6) broken("H.264 memory_management_control_operation above 6");
            SliceHeader::Mmco m{op, 0, 0};
            if (op == 1 || op == 3) m.a = int(bits.ue());
            if (op == 2) m.a = int(bits.ue());
            if (op == 3 || op == 6 || op == 4) m.b = int(bits.ue());
            // libavcodec's limits (ff_h264_decode_ref_pic_marking)
            if (m.b > 16 || (m.b == 16 && op != 4) || (op == 2 && m.a >= 16) || m.a > 65535)
              broken("H.264 long-term index out of range");
            h.mmco.push_back(m);
            if (h.mmco.size() > 66) broken("H.264 too many MMCOs");
          }
        }
      }
    }
    if (p.cabac && h.type != 2) {
      h.cabac_init_idc = int(bits.ue());
      if (h.cabac_init_idc > 2) broken("H.264 cabac_init_idc above 2");
    }
    h.qp = p.pic_init_qp + bits.se();
    if (h.qp < -6 * (s.depth - 8) || h.qp > 51) broken("H.264 slice QP out of range");
    if (p.deblocking_control) {
      h.deblock_idc = int(bits.ue());
      if (h.deblock_idc > 2) broken("H.264 disable_deblocking_filter_idc above 2");
      if (h.deblock_idc != 1) {
        h.alpha_off = bits.se() * 2;
        h.beta_off = bits.se() * 2;
        if (h.alpha_off < -12 || h.alpha_off > 12 || h.beta_off < -12 || h.beta_off > 12)
          broken("H.264 deblocking offsets out of range");
      }
    }
    if (bits.over()) broken("H.264 slice header cut short");
    if (h.type == 1 && !s.bitstream_restriction) guesses_delay = true;
    sh = h;
    // Slices in raster order, the first at macroblock 0; Baseline's
    // arbitrary slice order is not read.
    if (cur ? h.first_mb <= last_first_mb : h.first_mb != 0)
      unsupported("H.264 arbitrary slice order (ASO)");
    last_first_mb = h.first_mb;
    if (!cur) start_picture();
    else if (h.frame_num != first_sh.frame_num || h.nal_type != first_sh.nal_type)
      broken("H.264 slices of one picture disagree");
    pps = p;
    if (h.first_mb >= mb_w * mb_h) broken("H.264 first_mb_in_slice past the picture");
    slice_params.push_back({h.deblock_idc, h.alpha_off, h.beta_off});
    list[0].clear();
    list[1].clear();
    lists_ok = sh.type == 2 || build_lists();
    if (!headers_only) decode_slice(r);
    ++slice_num;
  }

  // ---------------------------------------------------------- pictures

  // A new picture of the active SPS's size and format (its planes when
  // decoding).
  FramePtr new_frame() {
    FramePtr p = std::make_shared<Frame>();
    Frame& f = *p;
    f.id = f.uid = next_id++;
    f.source = calls - 1;
    f.w = pic_w;
    f.h = pic_h;
    f.cw = cfi == 3 ? pic_w : pic_w / 2;
    f.ch = cfi >= 2 ? pic_h : pic_h / 2;
    f.cfi = cfi;
    f.depth = depth;
    if (!headers_only) {
      size_t bytes = depth > 8 ? 2 : 1;
      f.y.assign(size_t(pic_w) * pic_h * bytes, 0);
      f.u.assign(size_t(f.cw) * f.ch * bytes, 0);
      f.v.assign(f.u.size(), 0);
      if (cfi == 0) {                 // libavcodec's neutral chroma
        pixels([&](auto z) {
          using P = decltype(z);
          std::fill_n(reinterpret_cast<P*>(f.u.data()), f.u.size() / bytes, P(1 << (depth - 1)));
          std::fill_n(reinterpret_cast<P*>(f.v.data()), f.v.size() / bytes, P(1 << (depth - 1)));
        });
      }
      f.mbs.assign(size_t(mb_w) * mb_h, MbInfo());
    }
    f.out_x = crop_x(sps);
    f.out_w = pic_w - f.out_x - sps.crop_ux * sps.crop_r;
    f.out_h = pic_h - sps.crop_uy * (sps.crop_t + sps.crop_b);
    f.shown_w = pic_w - sps.crop_ux * (sps.crop_l + sps.crop_r);
    f.out_y = sps.crop_uy * sps.crop_t;
    f.full_range = sps.full_range;
    f.matrix = sps.matrix;
    f.chroma_loc = sps.chroma_loc;
    // libavcodec's gbrp, gbrp10 ...: G coded as Y, B as Cb, R as Cr.
    f.rgb = cfi == 3 && sps.matrix == 0;
    return p;
  }

  // libavcodec's gap filling (h264_field_start): a frame_num that skips
  // from the previous picture's gets "non-existing" frames for the
  // frame_nums between (at most max_num_ref_frames of them, the last
  // ones), each marked by the sliding window and never output. Each is
  // a copy of the newest short-term reference before it (sharing its
  // buffer, POC 2 above it) or, before any picture was recovered and
  // with no reference left, mid-grey (POC 0). Without the SPS's
  // gaps_in_frame_num_value_allowed_flag the same happens, the POC
  // history is cleared at each, and the sliding window's marking removes
  // them once they are more than max_num_ref_frames behind.
  void fill_gaps(const SliceHeader& h) {
    const int max_frame_num = 1 << sps.log2_max_frame_num;
    if (h.frame_num != prev_frame_num) {
      int unwrap = prev_frame_num;
      if (unwrap > h.frame_num) unwrap -= max_frame_num;
      if (h.frame_num - unwrap > sps.max_num_ref_frames) {
        unwrap = h.frame_num - sps.max_num_ref_frames - 1;
        if (unwrap < 0) unwrap += max_frame_num;
        prev_frame_num = unwrap;
      }
    }
    while (h.frame_num != prev_frame_num &&
           h.frame_num != (prev_frame_num + 1) % max_frame_num) {
      FramePtr prev = refs.empty() ? nullptr : refs.back();
      if (!sps.gaps_allowed)
        for (int& p : last_pocs) p = kPocMin;
      FramePtr g = new_frame();
      prev_frame_num = (prev_frame_num + 1) % max_frame_num;
      g->frame_num = prev_frame_num;
      g->invalid_gap = !sps.gaps_allowed;
      mark(*g, g, nullptr);
      if (!refs.empty() && refs.back() == g) {
        if (prev && prev->w == g->w && prev->h == g->h && prev->cfi == g->cfi &&
            prev->depth == g->depth) {
          g->id = prev->id;
          g->y = prev->y;
          g->u = prev->u;
          g->v = prev->v;
          g->poc = prev->poc + 2;
          g->gray = prev->gray;
        } else if (!frame_recovered) {
          if (!headers_only) {
            size_t bytes = depth > 8 ? 2 : 1;
            pixels([&](auto z) {
              using P = decltype(z);
              for (auto* pl : {&g->y, &g->u, &g->v})
                std::fill_n(reinterpret_cast<P*>(pl->data()), pl->size() / bytes, P(1 << (depth - 1)));
            });
          }
          g->gray = true;
        }
      }
    }
  }

  void start_picture() {
    const SliceHeader& h = sh;
    mb_w = sps.mb_w;
    mb_h = sps.mb_h;
    pic_w = mb_w * 16;
    pic_h = mb_h * 16;
    cfi = sps.cfi;
    nc8 = cfi == 2 ? 2 : 1;
    mbwc = cfi == 3 ? 16 : 8;
    mbhc = cfi == 3 ? 16 : 8 * nc8;
    planes = cfi == 3 ? 3 : 1;
    lossless_pred = sps.profile == 244;
    depth = sps.depth;
    pmax = (1 << depth) - 1;
    qp_bd = 6 * (depth - 8);
    if (x264_build >= 0 && x264_build < 151 && pps.transform_8x8 &&
        ((cfi == 3 && pps.cabac) || sps.bypass))
      unsupported("H.264 " + std::string(sps.bypass ? "lossless" : "4:4:4 CABAC") +
                  " with the 8x8 transform from libx264 before build 151 (core " +
                  std::to_string(x264_build) + "; libavcodec's workaround for its "
                  "contexts and prediction is not copied)");
    if (!headers_only && flagged_interlaced())
      unsupported("H.264 frames flagged interlaced by their picture timing SEI "
                  "(pic_struct): libavcodec marks them interlaced, and cv2 "
                  "cannot convert them");
    const int max_frame_num = 1 << sps.log2_max_frame_num;
    if (h.nal_type == 5 && h.frame_num != 0)
      broken("H.264 IDR picture with frame_num other than 0");
    frame_num = h.frame_num;
    fill_gaps(h);
    cur = new_frame();
    Frame& f = *cur;
    f.frame_num = h.frame_num;
    f.key = h.nal_type == 5;
    f.pic_type = h.type;
    // Picture order count as libavcodec's ff_h264_init_poc derives it
    // (8.2.1; after an MMCO 5 from the reset picture's own values).
    frame_num_offset = prev_frame_num_offset;
    if (h.frame_num < prev_frame_num) frame_num_offset += max_frame_num;
    int64_t top, bottom;
    if (sps.poc_type == 0) {
      int max_lsb = 1 << sps.log2_max_poc_lsb;
      if (h.poc_lsb < prev_poc_lsb && prev_poc_lsb - h.poc_lsb >= max_lsb / 2)
        poc_msb = prev_poc_msb + max_lsb;
      else if (h.poc_lsb > prev_poc_lsb && prev_poc_lsb - h.poc_lsb < -max_lsb / 2)
        poc_msb = prev_poc_msb - max_lsb;
      else
        poc_msb = prev_poc_msb;
      poc_lsb = h.poc_lsb;
      top = int64_t(poc_msb) + h.poc_lsb;
      bottom = top + h.delta_poc_bottom;
    } else if (sps.poc_type == 1) {
      const int cycle = int(sps.offset_ref.size());
      int64_t abs_frame_num = cycle ? int64_t(frame_num_offset) + h.frame_num : 0;
      if (h.nal_ref_idc == 0 && abs_frame_num > 0) --abs_frame_num;
      int64_t per_cycle = 0;
      for (int o : sps.offset_ref) per_cycle += o;
      int64_t expected = 0;
      if (abs_frame_num > 0) {
        int64_t cycles = (abs_frame_num - 1) / cycle, in_cycle = (abs_frame_num - 1) % cycle;
        expected = cycles * per_cycle;
        for (int64_t i = 0; i <= in_cycle; ++i) expected += sps.offset_ref[size_t(i)];
      }
      if (h.nal_ref_idc == 0) expected += sps.offset_non_ref;
      top = expected + h.delta_poc[0];
      bottom = top + sps.offset_top_bottom + h.delta_poc[1];
    } else {
      top = bottom = 2 * (int64_t(frame_num_offset) + h.frame_num) - (h.nal_ref_idc ? 0 : 1);
    }
    if (top != int32_t(top) || bottom != int32_t(bottom))
      broken("H.264 picture order count out of range");
    f.poc = int(std::min(top, bottom));
    first_sh = h;
    cur_idr = h.nal_type == 5;
    slice_num = 0;
    mbs = &f.mbs;
    // Recovery (libavcodec's h264_field_start): a recovery point SEI
    // names the frame_num from which pictures are whole; the reference
    // picture of that frame_num, or an IDR picture, is recovered, and so
    // is every picture decoded after an IDR picture or after a recovered
    // picture was output (select_output).
    if (sei_recovery >= 0) {
      if (h.frame_num != sei_recovery || h.type != 2) valid_recovery_point = true;
      if (recovery_frame < 0 ||
          ((recovery_frame - h.frame_num) & (max_frame_num - 1)) > sei_recovery) {
        recovery_frame = (h.frame_num + sei_recovery) & (max_frame_num - 1);
        if (!valid_recovery_point) recovery_frame = h.frame_num;
      }
    }
    if (cur_idr) {
      f.recovered |= 1;
      frame_recovered |= 1;
    }
    if (recovery_frame == h.frame_num && h.nal_ref_idc) {
      // libavcodec flags this picture a keyframe too: a barrier of the
      // output order as an IDR picture is.
      recovery_frame = -1;
      f.recovered |= 2;
    }
    // libavcodec flags an I picture with a recovery point SEI a keyframe,
    // as an IDR picture: a barrier of the output order (found on cv2).
    if (sei_recovery >= 0 && h.type == 2) f.key = true;
    f.recovered |= frame_recovered;
    if (h.type == 2) non_gray = true;
    select_output();
  }

  // libavcodec's h264_select_output_frame, run as a picture starts.
  void select_output() {
    Frame& c = *cur;
    // An MMCO 5 flags the picture after it (h->mmco_reset) as well as
    // itself (at its marking).
    c.mmco_reset = mmco_reset_next;
    mmco_reset_next = false;
    // A new SPS's reorder depth counts once the picture's output order
    // is placed: an IDR picture after pictures output without delay
    // restarts the order (next_outputed_poc) first.
    const int depth_before = has_b_frames;
    if (sps.bitstream_restriction) has_b_frames = std::max(has_b_frames, sps.num_reorder_frames);
    int i;
    for (i = 0;; ++i) {
      if (i == kMaxDelayed || c.poc < last_pocs[i]) {
        if (i) last_pocs[i - 1] = c.poc;
        break;
      } else if (i) {
        last_pocs[i - 1] = last_pocs[i];
      }
    }
    int out_of_order = kMaxDelayed - i;
    if (c.pic_type == 1 || (last_pocs[kMaxDelayed - 2] > kPocMin &&
                     int64_t(last_pocs[kMaxDelayed - 1]) - last_pocs[kMaxDelayed - 2] > 2))
      out_of_order = std::max(out_of_order, 1);
    if (out_of_order == kMaxDelayed) {
      for (int k = 1; k < kMaxDelayed; ++k) last_pocs[k] = kPocMin;
      last_pocs[0] = c.poc;
      c.mmco_reset = true;
    } else if (has_b_frames < out_of_order && !sps.bitstream_restriction) {
      has_b_frames = out_of_order;
    }
    delayed.push_back(cur);
    if (int(delayed.size()) > kMaxDelayed + 1) broken("H.264 reorder buffer overflow");
    size_t pics = delayed.size();
    size_t out_idx = 0;
    FramePtr out = delayed[0];
    for (size_t k = 1; k < delayed.size() && !(delayed[k]->key || delayed[k]->mmco_reset); ++k)
      if (delayed[k]->poc < out->poc) {
        out = delayed[k];
        out_idx = k;
      }
    if (depth_before == 0 &&
        (delayed[0]->key || delayed[0]->mmco_reset))
      next_outputed_poc = kPocMin;
    bool ooo = out->poc < next_outputed_poc;
    if (ooo || int(pics) > has_b_frames) delayed.erase(delayed.begin() + long(out_idx));
    if (!ooo && int(pics) > has_b_frames) {
      next_output = out;
      if (out_idx == 0 && !delayed.empty() && (delayed[0]->key || delayed[0]->mmco_reset))
        next_outputed_poc = kPocMin;
      else
        next_outputed_poc = out->poc;
      // A recovered picture output: the pictures decoded from now on are
      // whole, and after an IDR picture or a recovery point SEI's also
      // those output from now on (not after the heuristic's I picture:
      // the pictures decoded before its output but output after it are
      // still dropped). An unrecovered one is dropped (cv2's decoder does
      // not set AV_CODEC_FLAG_OUTPUT_CORRUPT).
      frame_recovered |= out->recovered;
      out->recovered |= frame_recovered & 2;
      if (!out->recovered) next_output.reset();
    }
  }

  // A picture output whose slices lost their references: libavcodec
  // conceals its macroblocks (error resilience), which is not copied.
  void check_whole(const Frame& f) const {
    if (f.failed)
      unsupported("H.264 picture output with references missing (libavcodec's "
                  "error concealment is not copied)");
  }

  // libavcodec's draining at the end of the stream.
  // (send_next_delayed_frame: unrecovered pictures are dropped).
  bool flush(Picture& out) {
    if (cur) finish_picture();
    while (!delayed.empty()) {
      size_t out_idx = 0;
      for (size_t k = 1; k < delayed.size() && !(delayed[k]->key || delayed[k]->mmco_reset); ++k)
        if (delayed[k]->poc < delayed[out_idx]->poc) out_idx = k;
      FramePtr f = delayed[out_idx];
      delayed.erase(delayed.begin() + long(out_idx));
      frame_recovered |= f->recovered;
      f->recovered |= frame_recovered & 2;
      if (!f->recovered) continue;
      check_whole(*f);
      to_picture(*f, out);
      return true;
    }
    return false;
  }

  void finish_picture() {
    Frame& f = *cur;
    for (const MbInfo& m : f.mbs)
      if (m.slice < 0 && !f.failed) broken("H.264 picture with macroblocks missing");
    if (!headers_only && !f.failed) pixels([&](auto z) { deblock_picture<decltype(z)>(); });
    slice_params.clear();
    if (first_sh.nal_ref_idc) {
      mark(f, cur, &first_sh);
      prev_poc_msb = poc_msb;
      prev_poc_lsb = poc_lsb;
    }
    prev_frame_num_offset = frame_num_offset;
    prev_frame_num = frame_num;
    cur.reset();
  }

  // Reference marking as libavcodec's ff_h264_execute_ref_pic_marking
  // does it (8.2.5): `h` the picture's first slice header (null: a gap
  // frame, marked by the sliding window). The sliding window removes the
  // oldest short-term reference once short and long-term ones reach
  // max_num_ref_frames; more references than that (a broken stream)
  // lose the oldest. An I picture with no long-term references, at most
  // two short-term ones (or PPSs of one reference a list) and PPSs of one
  // list-0 reference is taken for a recovery point.
  void mark(Frame& f, const FramePtr& fp, const SliceHeader* h) {
    const int max_frame_num = 1 << sps.log2_max_frame_num;
    bool err = false, assigned = false;
    auto remove_long = [&](int i) {
      if (!long_refs[i]) return;
      long_refs[i]->long_term = false;
      long_refs[i]->long_idx = -1;
      long_refs[i].reset();
      --long_count;
    };
    auto find_short = [&](int fn) -> int {
      for (size_t k = refs.size(); k-- > 0;)
        if (refs[k]->frame_num == fn) return int(k);
      return -1;
    };
    std::vector<SliceHeader::Mmco> ops;
    if (h && h->nal_type == 5) {
      if (h->long_term_ref) ops.push_back({6, 0, 0});
    } else if (h && h->adaptive_marking) {
      ops = h->mmco;
    } else if (!refs.empty() && long_count + int(refs.size()) >= sps.max_num_ref_frames) {
      ops.push_back({1, -1, 0});            // the oldest short-term one
    }
    for (const auto& m : ops) {
      int k = -1;
      if (m.op == 1 || m.op == 3) {
        int fn = m.a < 0 ? refs.front()->frame_num
                         : (f.frame_num - m.a - 1) & (max_frame_num - 1);
        k = find_short(fn);
        if (k < 0) {
          if (m.op != 3 || !long_refs[m.b] || long_refs[m.b]->frame_num != fn) err = true;
          continue;
        }
      }
      switch (m.op) {
        case 1:
          refs.erase(refs.begin() + k);
          break;
        case 2:
          if (long_refs[m.a]) remove_long(m.a);
          break;
        case 3: {
          FramePtr pic = refs[size_t(k)];
          if (long_refs[m.b] != pic) remove_long(m.b);
          refs.erase(refs.begin() + k);
          long_refs[m.b] = pic;
          pic->long_term = true;
          pic->long_idx = m.b;
          ++long_count;
          break;
        }
        case 4:
          for (int j = m.b; j < 16; ++j) remove_long(j);
          break;
        case 5:
          refs.clear();
          for (int j = 0; j < 16; ++j) remove_long(j);
          frame_num = f.frame_num = 0;
          mmco_reset_next = true;
          f.mmco_reset = true;
          for (int& p : last_pocs) p = kPocMin;
          break;
        case 6:
          if (!refs.empty() && refs.back() == fp) refs.pop_back();
          if (f.long_term)
            for (int j = 0; j < 16; ++j)
              if (long_refs[j] == fp) remove_long(j);
          if (long_refs[m.b] != fp) {
            remove_long(m.b);
            long_refs[m.b] = fp;
            f.long_term = true;
            f.long_idx = m.b;
            ++long_count;
          }
          assigned = true;
          break;
      }
    }
    if (!assigned) {
      int k = find_short(f.frame_num);
      if (k >= 0) {
        refs.erase(refs.begin() + k);
        err = true;
      }
      refs.push_back(fp);
    }
    if (long_count + int(refs.size()) > std::max(sps.max_num_ref_frames, 1)) {
      err = true;
      if (long_count && refs.empty()) {
        for (int j = 0; j < 16; ++j)
          if (long_refs[j]) {
            remove_long(j);
            break;
          }
      } else {
        refs.erase(refs.begin());
      }
    }
    for (size_t k = refs.size(); k-- > 0;) {
      const Frame& r = *refs[k];
      if (r.invalid_gap &&
          ((f.frame_num - r.frame_num) & (max_frame_num - 1)) > sps.max_num_ref_frames)
        refs.erase(refs.begin() + long(k));
    }
    int pps_refs[2] = {0, 0};
    for (const Pps& q : pps_table)
      if (q.valid)
        for (int l = 0; l < 2; ++l) pps_refs[l] = std::max(pps_refs[l], q.num_ref_idx_default[l]);
    if (!err && long_count == 0 &&
        (refs.size() <= 2 || (pps_refs[0] <= 1 && pps_refs[1] <= 1)) && pps_refs[0] <= 1 &&
        f.pic_type == 2) {
      f.recovered |= 4;
      if (!has_b_frames) frame_recovered |= 2;
    }
  }

  void to_picture(const Frame& f, Picture& out) {
    out.w = f.out_w;
    out.h = f.out_h;
    out.shown_w = f.shown_w;
    out.ystride = f.w;
    out.cstride = f.cw;
    out.xshift = f.cfi == 3 ? 0 : 1;
    out.yshift = f.cfi >= 2 ? 0 : 1;
    out.grey = false;
    out.rgb = f.rgb;
    out.depth = f.depth;
    // The planes from the output's corner on (the chroma's at its
    // subsampled position), rows of the decoded picture's stride.
    const size_t bytes = f.depth > 8 ? 2 : 1;
    const int cx = f.out_x >> (f.cfi == 3 ? 0 : 1);
    const int cy = f.out_y >> (f.cfi >= 2 ? 0 : 1);
    auto from = [&](const std::vector<uint8_t>& b, int x, int y, int stride) {
      size_t off = (size_t(y) * stride + size_t(x)) * bytes;
      return std::vector<uint8_t>(b.begin() + long(std::min(off, b.size())), b.end());
    };
    std::vector<uint8_t> y = from(f.y, f.out_x, f.out_y, f.w);
    std::vector<uint8_t> u = from(f.u, cx, cy, f.cw);
    std::vector<uint8_t> v = from(f.v, cx, cy, f.cw);
    // Rows of the last line past the decoded width: padded with zeros.
    y.resize(size_t(f.out_h) * f.w * bytes, 0);
    size_t crows = size_t(f.cfi >= 2 ? f.out_h : (f.out_h + 1) / 2);
    u.resize(crows * f.cw * bytes, 0);
    v.resize(crows * f.cw * bytes, 0);
    if (f.depth > 8) {
      auto words = [](const std::vector<uint8_t>& b, std::vector<uint16_t>& w) {
        w.resize(b.size() / 2);
        std::memcpy(w.data(), b.data(), b.size());
      };
      words(y, out.y16);
      words(u, out.u16);
      words(v, out.v16);
      out.y.clear();
      out.u.clear();
      out.v.clear();
    } else {
      out.y = std::move(y);
      out.u = std::move(u);
      out.v = std::move(v);
    }
    out.full_range = f.full_range;
    out.matrix = f.matrix;
    out.chroma_loc = f.chroma_loc;
    out.source = f.source;
  }

  // --------------------------------------------------------- the slice

  void decode_slice(const std::vector<uint8_t>& r) {
    // Reference lists (8.2.4) and weights.
    if (sh.type != 2 && !lists_ok) {
      cur->failed = true;
      return;
    }
    init_scaling();
    use_implicit = sh.type == 1 && pps.weighted_bipred_idc == 2;
    if (use_implicit) init_implicit();
    qp = sh.qp;
    prev_qp_delta_nz = 0;
    size_t stop = stop_bit(r);
    mb_addr = sh.first_mb;
    if (pps.cabac) {
      while (!bits.aligned()) {
        if (!bits.u1()) broken("H.264 cabac_alignment_one_bit is 0");
      }
      cabac.b = &bits;
      cabac.init_contexts(sh.qp, sh.cabac_init_idc, sh.type == 2);
      cabac.init_engine();
      for (;;) {
        if (mb_addr >= mb_w * mb_h) broken("H.264 slice runs past the picture");
        begin_mb();
        bool skip = false;
        if (sh.type != 2) skip = cabac_skip_flag();
        if (skip) decode_skip();
        else macroblock_layer();
        if (bits.pos > bits.n * 8 + 16) broken("H.264 slice data runs past its end");
        if (cabac.terminate()) break;
        ++mb_addr;
      }
    } else {
      for (;;) {
        bool more = true;
        if (sh.type != 2) {
          uint32_t run = bits.ue();
          if (run > uint32_t(mb_w * mb_h)) broken("H.264 mb_skip_run too long");
          for (uint32_t k = 0; k < run; ++k) {
            if (mb_addr >= mb_w * mb_h) broken("H.264 mb_skip_run past the picture");
            begin_mb();
            decode_skip();
            ++mb_addr;
          }
          if (run > 0) more = bits.pos < stop;
        }
        if (more) {
          if (mb_addr >= mb_w * mb_h) broken("H.264 slice runs past the picture");
          begin_mb();
          macroblock_layer();
          ++mb_addr;
        }
        if (bits.over() || bits.pos > stop) broken("H.264 slice data runs past its end");
        if (bits.pos >= stop) break;
      }
    }
  }

  void begin_mb() {
    mb_x = mb_addr % mb_w;
    mb_y = mb_addr / mb_w;
    mb = &(*mbs)[size_t(mb_addr)];
    if (mb->slice >= 0) broken("H.264 macroblock decoded twice");
    *mb = MbInfo();
    mb->slice = slice_num;
    std::memset(mb->ipred, 2, sizeof(mb->ipred));
    std::memset(mb->nz, 0, sizeof(mb->nz));
    std::memset(mb->mv, 0, sizeof(mb->mv));
    std::memset(mb->mvd, 0, sizeof(mb->mvd));
    std::memset(mb->ref, -1, sizeof(mb->ref));
    for (int l = 0; l < 2; ++l)
      for (int k = 0; k < 4; ++k) mb->refid[l][k] = mb->dbk[l][k] = -1;
    std::memset(done4, 0, sizeof(done4));
  }

  // The neighbouring macroblock (dx, dy in -1..1), nullptr when it is
  // outside the picture, in another slice or not decoded yet.
  MbInfo* nb_mb(int dx, int dy) {
    int x = mb_x + dx, y = mb_y + dy;
    if (x < 0 || x >= mb_w || y < 0) return nullptr;
    if (dy == 0 && dx >= 0) return dx == 0 ? mb : nullptr;
    MbInfo* m = &(*mbs)[size_t(y * mb_w + x)];
    return m->slice == slice_num ? m : nullptr;
  }
  MbInfo* mbA() { return nb_mb(-1, 0); }
  MbInfo* mbB() { return nb_mb(0, -1); }

  // The macroblock holding 4x4 block (x4, y4) of the current one's grid
  // (x4 in -1..4, y4 in -1..3) and the block's raster index in it
  // (6.4.12); the current macroblock for blocks inside it.
  MbInfo* nb4(int x4, int y4, int& blk) {
    blk = 0;
    if (y4 > 3) return nullptr;
    if (x4 > 3 && y4 >= 0) return nullptr;
    int dx = x4 < 0 ? -1 : x4 > 3 ? 1 : 0;
    int dy = y4 < 0 ? -1 : 0;
    blk = ((y4 + 4) & 3) * 4 + ((x4 + 4) & 3);
    return nb_mb(dx, dy);
  }

  // ------------------------------------------------ reference lists

  // The reference lists as libavcodec builds them (h264_refs.c): P
  // slices take the short-term references newest first, B slices those
  // of POC at or below the picture's (descending) then above it
  // (ascending) for list 0 and the other way for list 1 (one picture of
  // each POC), a list 1 equal to list 0 with its first two swapped; the
  // long-term ones follow by LongTermFrameIdx. The modifications then
  // insert pictures by number; an entry left empty takes its list's
  // first initial entry (default_ref; a grey gap frame the other list's
  // if that one is not grey), and with none the slice is lost (false).
  bool build_lists() {
    const int max_pic_num = 1 << sps.log2_max_frame_num;
    for (int l = 0; l < 2; ++l) list[l].clear();
    const int nl = sh.type == 1 ? 2 : 1;
    if (sh.type == 1) {
      auto add_sorted = [&](std::vector<FramePtr>& out, int limit, bool down) {
        for (;;) {
          FramePtr best;
          for (size_t k = refs.size(); k-- > 0;) {      // newest first
            int poc = refs[k]->poc;
            if (down ? (poc <= limit && (!best || poc >= best->poc))
                     : (poc > limit && (!best || poc < best->poc)))
              best = refs[k];
          }
          if (!best) return;
          out.push_back(best);
          limit = best->poc - (down ? 1 : 0);
        }
      };
      for (int l = 0; l < 2; ++l) {
        add_sorted(list[l], cur->poc, l == 0);
        add_sorted(list[l], cur->poc, l != 0);
      }
    } else {
      list[0].assign(refs.rbegin(), refs.rend());
    }
    for (int l = 0; l < nl; ++l)
      for (auto& r : long_refs)
        if (r) list[l].push_back(r);
    if (sh.type == 1 && list[0].size() == list[1].size() && list[1].size() > 1) {
      bool same = true;
      for (size_t k = 0; k < list[0].size(); ++k) same = same && list[0][k]->id == list[1][k]->id;
      if (same) std::swap(list[1][0], list[1][1]);
    }
    for (int l = 0; l < nl; ++l) {
      list[l].resize(size_t(sh.num_ref_idx[l]));
      default_ref[l] = list[l][0];
    }
    for (int l = 0; l < nl; ++l) {
      std::vector<FramePtr>& L = list[l];
      const int n = sh.num_ref_idx[l];
      int pred = sh.frame_num;
      for (size_t index = 0; index < sh.mods[l].size(); ++index) {
        const auto& m = sh.mods[l][index];
        FramePtr ref;
        if (m.idc < 2) {
          int abs_diff = m.val + 1;
          if (abs_diff > max_pic_num) broken("H.264 abs_diff_pic_num out of range");
          pred = (m.idc == 0 ? pred - abs_diff : pred + abs_diff) & (max_pic_num - 1);
          for (auto& f : refs)                          // oldest first
            if (f->frame_num == pred) {
              ref = f;
              break;
            }
        } else {
          if (m.val > 31) broken("H.264 long_term_pic_num out of range");
          if (m.val < 16) ref = long_refs[m.val];
        }
        if (int(index) >= n) broken("H.264 too many list modifications");
        if (!ref) {                     // libavcodec leaves the entry empty
          L[index] = nullptr;
          continue;
        }
        int i = int(index);
        for (; i + 1 < n; ++i)
          if (L[size_t(i)] && L[size_t(i)]->long_term == ref->long_term &&
              (ref->long_term ? L[size_t(i)]->long_idx == ref->long_idx
                              : L[size_t(i)]->frame_num == ref->frame_num))
            break;
        for (; i > int(index); --i) L[size_t(i)] = L[size_t(i) - 1];
        L[index] = ref;
      }
    }
    for (int l = 0; l < nl; ++l)
      for (auto& f : list[l]) {
        if (!f) {
          for (int& p : last_pocs) p = kPocMin;
          if (!default_ref[l]) return false;
          f = default_ref[l];
        }
        if (f->gray && non_gray)
          for (int j = 0; j < nl; ++j) {
            const FramePtr& d = default_ref[(l + j) & 1];
            if (d && !d->gray) {
              f = d;
              break;
            }
          }
      }
    // What the deblocking filter compares (libavcodec's ref2frm): the
    // picture's buffer, but a long-term reference whose LongTermFrameIdx
    // is not below their count is an unknown picture (60) to it.
    for (int l = 0; l < nl; ++l)
      for (int i = 0; i < sh.num_ref_idx[l]; ++i) {
        const Frame& f = *list[l][size_t(i)];
        dbk_id[l][i] = f.long_term && f.long_idx >= long_count ? kUnknownRef : f.id;
      }
    return true;
  }

  void init_implicit() {
    int poc = cur->poc;
    for (int i = 0; i < sh.num_ref_idx[0]; ++i)
      for (int j = 0; j < sh.num_ref_idx[1]; ++j) {
        int p0 = list[0][size_t(i)]->poc, p1 = list[1][size_t(j)]->poc;
        int tb = clip3(-128, 127, poc - p0), td = clip3(-128, 127, p1 - p0);
        int w0 = 32, w1 = 32;
        // Equal weights for a long-term reference in either list.
        if (td != 0 && !list[0][size_t(i)]->long_term && !list[1][size_t(j)]->long_term) {
          int tx = (16384 + std::abs(td / 2)) / td;
          int dsf = clip3(-1024, 1023, (tb * tx + 32) >> 6);
          if (!((dsf >> 2) < -64 || (dsf >> 2) > 128)) {
            w0 = 64 - (dsf >> 2);
            w1 = dsf >> 2;
          }
        }
        implicit_w[i][j][0] = w0;
        implicit_w[i][j][1] = w1;
      }
  }

  void init_scaling() {
    uint8_t w4[6][16], w8[6][64];
    std::memcpy(w4, sps.scaling4, sizeof(w4));
    std::memcpy(w8, sps.scaling8, sizeof(w8));
    if (pps.scaling_present) {
      // Fall-back rule B after an SPS with scaling lists, else A: Y's
      // lists from the SPS's (or the defaults), Cb's from Y's, Cr's from
      // Cb's.
      for (int i = 0; i < (cfi == 3 ? 12 : 8); ++i) {
        if (i >= 6 && !pps.transform_8x8) break;
        bool is4 = i < 6;
        uint8_t def[64];
        if (is4) to_raster4(kDefaultScaling4[i < 3 ? 0 : 1], def);
        else to_raster8(kDefaultScaling8[i % 2], def);
        uint8_t* dst = is4 ? w4[i] : w8[i - 6];
        size_t sz = is4 ? 16 : 64;
        if (pps.list_present[i]) {
          if (pps.list_default[i]) std::memcpy(dst, def, sz);
          else if (is4) to_raster4(pps.lists[i], dst);
          else to_raster8(pps.lists[i], dst);
        } else if (i == 0 || i == 3 || i == 6 || i == 7) {
          if (!sps.scaling_present) std::memcpy(dst, def, sz);
          else if (is4) std::memcpy(dst, sps.scaling4[i], 16);
          else std::memcpy(dst, sps.scaling8[i - 6], 64);
        } else if (is4) {
          std::memcpy(dst, w4[i - 1], 16);
        } else {
          std::memcpy(dst, w8[i - 8], 64);
        }
      }
    }
    static const int kNorm4[6][3] = {{10, 16, 13}, {11, 18, 14}, {13, 20, 16},
                                     {14, 23, 18}, {16, 25, 20}, {18, 29, 23}};
    static const int kNorm8[6][6] = {{20, 18, 32, 19, 25, 24}, {22, 19, 35, 21, 28, 26},
                                     {26, 23, 42, 24, 33, 31}, {28, 25, 45, 26, 35, 33},
                                     {32, 28, 51, 30, 40, 38}, {36, 32, 58, 34, 46, 43}};
    for (int m = 0; m < 6; ++m) {
      for (int pos = 0; pos < 16; ++pos) {
        int i = pos >> 2, j = pos & 3;
        int v = (i % 2 == 0 && j % 2 == 0) ? kNorm4[m][0]
                : (i % 2 == 1 && j % 2 == 1) ? kNorm4[m][1] : kNorm4[m][2];
        for (int l = 0; l < 6; ++l) ls4[l][m][pos] = w4[l][pos] * v;
      }
      for (int pos = 0; pos < 64; ++pos) {
        int i = pos >> 3, j = pos & 7;
        int v;
        if (i % 4 == 0 && j % 4 == 0) v = kNorm8[m][0];
        else if (i % 2 == 1 && j % 2 == 1) v = kNorm8[m][1];
        else if (i % 4 == 2 && j % 4 == 2) v = kNorm8[m][2];
        else if ((i % 4 == 0 && j % 2 == 1) || (i % 2 == 1 && j % 4 == 0)) v = kNorm8[m][3];
        else if ((i % 4 == 0 && j % 4 == 2) || (i % 4 == 2 && j % 4 == 0)) v = kNorm8[m][4];
        else v = kNorm8[m][5];
        for (int l = 0; l < 6; ++l) ls8[l][m][pos] = w8[l][pos] * v;
      }
    }
  }

  // ============================================== syntax elements

  // mb_skip_flag (CABAC).
  bool cabac_skip_flag() {
    MbInfo *a = mbA(), *b = mbB();
    int inc = (a && !a->skip) + (b && !b->skip);
    return cabac.decision((sh.type == 1 ? 24 : 11) + inc);
  }

  // The I mb_type's value (0 I_NxN, 1..24 I_16x16, 25 I_PCM).
  int cabac_intra_type(int base, bool islice) {
    int st = base;
    if (islice) {
      MbInfo *a = mbA(), *b = mbB();
      int inc = (a && a->kind != kI4x4 && a->kind != kI8x8) +
                (b && b->kind != kI4x4 && b->kind != kI8x8);
      if (!cabac.decision(st + inc)) return 0;
      st += 2;
    } else {
      if (!cabac.decision(st)) return 0;
    }
    if (cabac.terminate()) return 25;
    int t = 1;
    t += 12 * cabac.decision(st + 1);
    if (cabac.decision(st + 2)) t += 4 + 4 * cabac.decision(st + 2 + (islice ? 1 : 0));
    t += 2 * cabac.decision(st + 3 + (islice ? 1 : 0));
    t += cabac.decision(st + 3 + 2 * (islice ? 1 : 0));
    return t;
  }

  // mb_type: → (slice-relative) value; intra types of P and B slices
  // come back as 100 + the I value.
  int read_mb_type() {
    if (!pps.cabac) {
      uint32_t v = bits.ue();
      if (sh.type == 2) {
        if (v > 25) broken("H.264 I mb_type above 25");
        return int(v);
      }
      if (sh.type == 0) {
        if (v > 30) broken("H.264 P mb_type above 30");
        return v < 5 ? int(v) : 100 + int(v) - 5;
      }
      if (v > 48) broken("H.264 B mb_type above 48");
      return v < 23 ? int(v) : 100 + int(v) - 23;
    }
    if (sh.type == 2) return cabac_intra_type(3, true);
    if (sh.type == 0) {
      if (!cabac.decision(14)) {
        if (!cabac.decision(15)) return 3 * cabac.decision(16);
        return 2 - cabac.decision(17);
      }
      return 100 + cabac_intra_type(17, false);
    }
    MbInfo *a = mbA(), *b = mbB();
    int inc = (a && !a->direct16) + (b && !b->direct16);
    if (!cabac.decision(27 + inc)) return 0;
    if (!cabac.decision(27 + 3)) return 1 + cabac.decision(27 + 5);
    int v = cabac.decision(27 + 4) << 3;
    v |= cabac.decision(27 + 5) << 2;
    v |= cabac.decision(27 + 5) << 1;
    v |= cabac.decision(27 + 5);
    if (v < 8) return v + 3;
    if (v == 13) return 100 + cabac_intra_type(32, false);
    if (v == 14) return 11;
    if (v == 15) return 22;
    v = (v << 1) | cabac.decision(27 + 5);
    return v - 4;
  }

  int read_sub_type() {
    if (!pps.cabac) {
      uint32_t v = bits.ue();
      if (v > (sh.type == 1 ? 12u : 3u)) broken("H.264 sub_mb_type out of range");
      return int(v);
    }
    if (sh.type == 0) {
      if (cabac.decision(21)) return 0;
      if (!cabac.decision(22)) return 1;
      if (cabac.decision(23)) return 2;
      return 3;
    }
    if (!cabac.decision(36)) return 0;
    if (!cabac.decision(37)) return 1 + cabac.decision(39);
    int t = 3;
    if (cabac.decision(38)) {
      if (cabac.decision(39)) return 11 + cabac.decision(39);
      t += 4;
    }
    t += 2 * cabac.decision(39);
    t += cabac.decision(39);
    return t;
  }

  int read_ref_idx(int l, int x4, int y4) {
    int n = sh.num_ref_idx[l];
    int v;
    if (!pps.cabac) {
      v = n == 2 ? 1 - bits.u1() : int(bits.ue());
    } else {
      int inc = 0;
      for (int k = 0; k < 2; ++k) {
        int blk;
        MbInfo* m = k == 0 ? nb4(x4 - 1, y4, blk) : nb4(x4, y4 - 1, blk);
        if (!m || m->skip || m->intra()) continue;
        int b8 = ((blk >> 3) << 1) | ((blk & 3) >> 1);
        if (m->direct8 & (1 << b8)) continue;
        if (m->ref[l][b8] > 0) inc += k == 0 ? 1 : 2;
      }
      v = 0;
      if (cabac.decision(54 + inc)) {
        v = 1;
        int ctx = 54 + 4;
        while (cabac.decision(ctx)) {
          ctx = 54 + 5;
          if (++v > 32) broken("H.264 ref_idx too long");
        }
      }
    }
    if (v < 0 || v >= n) broken("H.264 ref_idx out of range");
    return v;
  }

  int read_mvd(int l, int comp, int x4, int y4) {
    if (!pps.cabac) return bits.se();
    int sum = 0;
    int blk;
    if (MbInfo* m = nb4(x4 - 1, y4, blk)) sum += m->mvd[l][blk][comp];
    if (MbInfo* m = nb4(x4, y4 - 1, blk)) sum += m->mvd[l][blk][comp];
    int base = comp == 0 ? 40 : 47;
    int inc = sum < 3 ? 0 : sum <= 32 ? 1 : 2;
    if (!cabac.decision(base + inc)) return 0;
    int v = 1;
    int ctx = base + 3;
    while (v < 9 && cabac.decision(ctx)) {
      if (v < 4) ++ctx;
      ++v;
    }
    if (v >= 9) {
      int k = 3;
      while (cabac.bypass()) {
        v += 1 << k;
        if (++k > 24) broken("H.264 mvd too long");
      }
      while (k--) v += cabac.bypass() << k;
    }
    return cabac.bypass() ? -v : v;
  }

  int read_cbp(bool intra) {
    if (!pps.cabac) {
      uint32_t v = bits.ue();
      if (cfi == 0 || cfi == 3) {
        if (v > 15) broken("H.264 coded_block_pattern above 15 (monochrome or 4:4:4)");
        return intra ? kIntraCbpGrey[v] : kInterCbpGrey[v];
      }
      if (v > 47) broken("H.264 coded_block_pattern above 47");
      return intra ? kIntraCbp[v] : kInterCbp[v];
    }
    MbInfo *a = mbA(), *b = mbB();
    auto luma_bit = [&](MbInfo* m, int b8) -> int {
      // condTermFlagN: 0 unless the neighbour is available, not I_PCM,
      // and its bit is 0 (skip: 0).
      if (!m) return 0;
      if (m->kind == kPcm) return 0;
      return ((m->cbp >> b8) & 1) ? 0 : 1;
    };
    int cbp = 0;
    for (int b8 = 0; b8 < 4; ++b8) {
      int bx = b8 & 1, by = b8 >> 1;
      int ca, cb;
      if (bx == 0) ca = luma_bit(a, b8 + 1);
      else ca = ((cbp >> (b8 - 1)) & 1) ? 0 : 1;
      if (by == 0) cb = luma_bit(b, b8 + 2);
      else cb = ((cbp >> (b8 - 2)) & 1) ? 0 : 1;
      cbp |= cabac.decision(73 + ca + 2 * cb) << b8;
    }
    if (cfi == 0 || cfi == 3) return cbp;
    auto chroma = [&](MbInfo* m) -> int {
      if (!m) return 0;
      if (m->kind == kPcm) return 2;
      return m->cbp >> 4;
    };
    int ca = chroma(a), cb = chroma(b);
    if (cabac.decision(77 + (ca > 0) + 2 * (cb > 0))) {
      int c = 1 + cabac.decision(77 + 4 + (ca == 2) + 2 * (cb == 2));
      cbp |= c << 4;
    }
    return cbp;
  }

  int read_qp_delta() {
    int v;
    if (!pps.cabac) {
      v = bits.se();
    } else {
      int k = 0;
      if (cabac.decision(60 + (prev_qp_delta_nz ? 1 : 0))) {
        k = 1;
        int ctx = 62;
        while (cabac.decision(ctx)) {
          ctx = 63;
          if (++k > 104 + 2 * qp_bd) broken("H.264 mb_qp_delta too long");
        }
      }
      v = (k & 1) ? (k + 1) / 2 : -(k / 2);
    }
    if (v < -(26 + qp_bd / 2) || v > 25 + qp_bd / 2) broken("H.264 mb_qp_delta out of range");
    return v;
  }

  int read_chroma_mode() {
    if (!pps.cabac) {
      uint32_t v = bits.ue();
      if (v > 3) broken("H.264 intra_chroma_pred_mode above 3");
      return int(v);
    }
    MbInfo *a = mbA(), *b = mbB();
    auto cond = [](MbInfo* m) {
      return m && m->intra() && m->kind != kPcm && m->chroma_mode != 0;
    };
    if (!cabac.decision(64 + cond(a) + cond(b))) return 0;
    if (!cabac.decision(64 + 3)) return 1;
    return cabac.decision(64 + 3) ? 3 : 2;
  }

  // prev_intra_pred_mode_flag / rem_intra_pred_mode → rem, or -1.
  int read_intra_mode() {
    if (!pps.cabac) {
      if (bits.u1()) return -1;
      return int(bits.u(3));
    }
    if (cabac.decision(68)) return -1;
    int m = cabac.decision(69);
    m |= cabac.decision(69) << 1;
    m |= cabac.decision(69) << 2;
    return m;
  }

  bool read_t8x8() {
    if (!pps.cabac) return bits.u1();
    MbInfo *a = mbA(), *b = mbB();
    return cabac.decision(399 + (a && a->t8x8) + (b && b->t8x8));
  }

  // ------------------------------------------------------ residuals

  // A VLC of (len, code) pairs, matched against the next 16 bits.
  int read_vlc(const uint8_t* len, const uint8_t* code, int n) {
    uint32_t pk = bits.peek32() >> 16;
    for (int i = 0; i < n; ++i) {
      int l = len[i];
      if (l && (pk >> (16 - l)) == code[i]) {
        bits.pos += size_t(l);
        return i;
      }
    }
    broken("H.264 CAVLC code not in its table");
  }

  // CAVLC residual_block: levels into coeffLevel[start..end] of `out`
  // (scan order, max entries), → TotalCoeff. nC -1 is 4:2:0's chroma DC,
  // -2 4:2:2's.
  int cavlc_block(int32_t* out, int start, int end, int max, int nc) {
    int tc, t1;
    if (nc == -1) {
      int i = read_vlc(kChromaDcTokenLen, kChromaDcTokenBits, 20);
      tc = i >> 2;
      t1 = i & 3;
    } else if (nc == -2) {
      int i = read_vlc(kChroma422DcTokenLen, kChroma422DcTokenBits, 36);
      tc = i >> 2;
      t1 = i & 3;
    } else {
      int t = nc < 2 ? 0 : nc < 4 ? 1 : nc < 8 ? 2 : 3;
      int i = read_vlc(kCoeffTokenLen[t], kCoeffTokenBits[t], 68);
      tc = i >> 2;
      t1 = i & 3;
    }
    if (tc == 0) return 0;
    if (tc > max || t1 > tc) broken("H.264 coeff_token out of range");
    int level[16];
    int suffix_len = (tc > 10 && t1 < 3) ? 1 : 0;
    for (int i = 0; i < tc; ++i) {
      if (i < t1) {
        level[i] = bits.u1() ? -1 : 1;
        continue;
      }
      int prefix = 0;
      while (!bits.u1()) {
        if (++prefix > 32) broken("H.264 level_prefix too long");
      }
      int code = (std::min(15, prefix) << suffix_len);
      int ssize = suffix_len;
      if (prefix == 14 && suffix_len == 0) ssize = 4;
      if (prefix >= 15) ssize = prefix - 3;
      if (ssize > 0) code += int(bits.u(ssize));
      if (prefix >= 15 && suffix_len == 0) code += 15;
      if (prefix >= 16) code += (1 << (prefix - 3)) - 4096;
      if (i == t1 && t1 < 3) code += 2;
      level[i] = (code & 1) ? (-code - 1) >> 1 : (code + 2) >> 1;
      if (suffix_len == 0) suffix_len = 1;
      if (std::abs(level[i]) > (3 << (suffix_len - 1)) && suffix_len < 6) ++suffix_len;
    }
    int zeros = 0;
    if (tc < end - start + 1) {
      if (nc == -1)
        zeros = read_vlc(kChromaDcTotalZerosLen[tc - 1], kChromaDcTotalZerosBits[tc - 1], 4);
      else if (nc == -2)
        zeros = read_vlc(kChroma422DcTotalZerosLen[tc - 1], kChroma422DcTotalZerosBits[tc - 1], 8);
      else
        zeros = read_vlc(kTotalZerosLen[tc - 1], kTotalZerosBits[tc - 1], 16);
    }
    if (tc + zeros > end - start + 1) broken("H.264 total_zeros out of range");
    int run[16];
    int left = zeros;
    for (int i = 0; i < tc - 1; ++i) {
      if (left > 0) {
        int r = read_vlc(kRunLen[std::min(left, 7) - 1], kRunBits[std::min(left, 7) - 1], 16);
        if (r > left) broken("H.264 run_before out of range");
        run[i] = r;
        left -= r;
      } else {
        run[i] = 0;
      }
    }
    run[tc - 1] = left;
    int pos = -1;
    for (int i = tc - 1; i >= 0; --i) {
      pos += run[i] + 1;
      out[start + pos] = level[i];
    }
    return tc;
  }

  // CABAC residual_block for ctxBlockCat `cat` (0-4 luma DC, AC, 4x4,
  // chroma DC and AC; 5 luma 8x8; 6-9 and 10-13 Cb's and Cr's DC, AC,
  // 4x4 and 8x8 in 4:4:4): levels into out[0..max) (scan order from
  // startIdx); cbf_inc < 0 when coded_block_flag is not coded (inferred
  // 1). → the number of non-zero levels.
  int cabac_block(int32_t* out, int cat, int max, int cbf_inc) {
    // ctxIdxOffset + ctxBlockCatOffset of each category (tables 9-34 and
    // 9-40, frame coded).
    static const int kCbf[14] = {85, 89, 93, 97, 101, 1012, 460,
                                 464, 468, 1016, 472, 476, 480, 1020};
    static const int kSig[14] = {105, 120, 134, 149, 152, 402, 484,
                                 499, 513, 660, 528, 543, 557, 718};
    static const int kLast[14] = {166, 181, 195, 210, 213, 417, 572,
                                  587, 601, 690, 616, 631, 645, 748};
    static const int kAbs[14] = {227, 237, 247, 257, 266, 426, 952,
                                 962, 972, 708, 982, 992, 1002, 766};
    if (cbf_inc >= 0 && !cabac.decision(kCbf[cat] + cbf_inc)) return 0;
    const bool is8x8 = cat == 5 || cat == 9 || cat == 13;
    int sig_at[64];
    int count = 0;
    bool last = false;
    for (int i = 0; i < max - 1 && !last; ++i) {
      int si = is8x8 ? kSig8x8[i] : cat == 3 ? std::min(i / nc8, 2) : i;
      if (cabac.decision(kSig[cat] + si)) {
        sig_at[count++] = i;
        int li = is8x8 ? kLast8x8[i] : cat == 3 ? std::min(i / nc8, 2) : i;
        last = cabac.decision(kLast[cat] + li);
      }
    }
    if (!last) sig_at[count++] = max - 1;
    int eq1 = 0, gt1 = 0;
    for (int k = count - 1; k >= 0; --k) {
      int ctx = kAbs[cat] + ((gt1 != 0) ? 0 : std::min(4, 1 + eq1));
      int v;
      if (!cabac.decision(ctx)) {
        v = 1;
      } else {
        int ctx2 = kAbs[cat] + 5 + std::min(4 - (cat == 3 ? 1 : 0), gt1);
        int prefix = 1;
        while (prefix < 14 && cabac.decision(ctx2)) ++prefix;
        v = prefix + 1;
        if (prefix >= 14) {
          int kk = 0, suf = 0;
          while (cabac.bypass()) {
            suf += 1 << kk;
            if (++kk > 24) broken("H.264 coeff_abs_level_minus1 too long");
          }
          while (kk--) suf += cabac.bypass() << kk;
          v += suf;
        }
      }
      if (v == 1) ++eq1;
      else ++gt1;
      out[sig_at[k]] = cabac.bypass() ? -v : v;
    }
    return count;
  }

  // The neighbouring macroblock holding 4x4 block (x, y) of plane `comp`
  // (0 luma, 1 Cb, 2 Cr) in the current one's grid, and its raster index
  // there: the luma grid for luma and 4:4:4's chroma, else the chroma one.
  MbInfo* nb_block(int comp, int x, int y, int& blk) {
    return comp == 0 || cfi == 3 ? nb4(x, y, blk) : nb_chroma(x, y, blk);
  }

  // The nC of a 4x4 block of plane `comp` (CAVLC).
  int cavlc_nc(int comp, int x4, int y4) {
    int n[2] = {0, 0}, avail[2];
    for (int k = 0; k < 2; ++k) {
      int blk;
      MbInfo* m = nb_block(comp, k == 0 ? x4 - 1 : x4, k == 0 ? y4 : y4 - 1, blk);
      avail[k] = m != nullptr;
      if (!m) continue;
      if (m->skip) n[k] = 0;
      else if (m->kind == kPcm) n[k] = 16;
      else n[k] = m->nz[16 * comp + blk];
    }
    if (avail[0] && avail[1]) return (n[0] + n[1] + 1) >> 1;
    if (avail[0]) return n[0];
    if (avail[1]) return n[1];
    return 0;
  }

  // The macroblock holding chroma 4x4 block (x2, y2) of the current
  // one's grid (2 wide, 2 or 4 high), and its raster index in it.
  MbInfo* nb_chroma(int x2, int y2, int& blk) {
    int rows = 2 * nc8;
    if (x2 > 1 || y2 >= rows) return nullptr;
    int dx = x2 < 0 ? -1 : 0, dy = y2 < 0 ? -1 : 0;
    blk = ((y2 + rows) % rows) * 2 + ((x2 + 2) & 1);
    return nb_mb(dx, dy);
  }

  // coded_block_flag's ctxIdxInc (CABAC) of a block of category `cat`
  // (as cabac_block's) of plane `comp` at 4x4 block (x, y).
  int cbf_inc(int cat, int comp, int x, int y) {
    const bool dc16 = cat == 0 || cat == 6 || cat == 10;
    const bool is8x8 = cat == 5 || cat == 9 || cat == 13;
    int inc = 0;
    for (int k = 0; k < 2; ++k) {
      int blk = 0;
      MbInfo* m;
      if (dc16 || cat == 3) m = k == 0 ? mbA() : mbB();
      else m = nb_block(cat == 4 ? comp : 0, k == 0 ? x - 1 : x, k == 0 ? y : y - 1, blk);
      int cond;
      if (!m) {
        cond = mb->intra() ? 1 : 0;
      } else if (m->kind == kPcm) {
        cond = 1;
      } else if (is8x8 && !m->t8x8) {
        // 4:4:4's 8x8 blocks: a neighbouring macroblock without the 8x8
        // transform has no 8x8 block to take the flag from.
        cond = 0;
      } else if (dc16) {
        cond = m->kind == kI16x16 ? ((m->dc_cbf >> comp) & 1) : 0;
      } else if (cat == 3) {
        cond = (m->cbp >> 4) ? ((m->dc_cbf >> comp) & 1) : 0;
      } else if (cat == 4) {
        cond = (m->cbp >> 4) == 2 ? (m->nz[16 * comp + blk] != 0) : 0;
      } else {
        int b8 = ((blk >> 3) << 1) | ((blk & 3) >> 1);
        cond = ((m->cbp >> b8) & 1) ? (m->nz[16 * comp + blk] != 0) : 0;
      }
      inc += cond << k;
    }
    return inc;
  }

  // residual_luma() of plane `p`: luma, or 4:4:4's Cb or Cr coded as luma
  // (ctxBlockCat 6-9 and 10-13, their own nC).
  void residual_luma(int p, bool i16) {
    static const int kCat[3][4] = {{0, 1, 2, 5}, {6, 7, 8, 9}, {10, 11, 12, 13}};
    const int* cat = kCat[p];
    int cbp = mb->cbp;
    if (i16) {
      int n;
      int32_t tmp[16] = {0};
      if (pps.cabac) n = cabac_block(tmp, cat[0], 16, cbf_inc(cat[0], p, 0, 0));
      else n = cavlc_block(tmp, 0, 15, 16, cavlc_nc(p, 0, 0));
      std::memcpy(dc[p], tmp, sizeof(tmp));
      if (n) mb->dc_cbf |= uint8_t(1 << p);
    }
    uint8_t* nz = mb->nz + 16 * p;
    for (int b8 = 0; b8 < 4; ++b8) {
      if (!((cbp >> b8) & 1)) continue;
      int bx = (b8 & 1) * 2, by = (b8 >> 1) * 2;
      if (mb->t8x8 && pps.cabac) {
        // coded_block_flag of an 8x8 block is coded in 4:4:4 only.
        int32_t tmp[64] = {0};
        int n = cabac_block(tmp, cat[3], 64, cfi == 3 ? cbf_inc(cat[3], p, bx, by) : -1);
        for (int k = 0; k < 64; ++k) coef8[p][b8][kZigzag8[k]] = tmp[k];
        for (int k = 0; k < 4; ++k) nz[(by + (k >> 1)) * 4 + bx + (k & 1)] = uint8_t(n);
        continue;
      }
      for (int i4 = 0; i4 < 4; ++i4) {
        int zblk = b8 * 4 + i4;
        int rb = kBlkRaster[zblk];
        int x4 = rb & 3, y4 = rb >> 2;
        int32_t tmp[16] = {0};
        int n;
        if (i16) {
          if (pps.cabac) n = cabac_block(tmp + 1, cat[1], 15, cbf_inc(cat[1], p, x4, y4));
          else n = cavlc_block(tmp, 1, 15, 15, cavlc_nc(p, x4, y4));
        } else {
          if (pps.cabac) n = cabac_block(tmp, cat[2], 16, cbf_inc(cat[2], p, x4, y4));
          else n = cavlc_block(tmp, 0, 15, 16, cavlc_nc(p, x4, y4));
        }
        nz[rb] = uint8_t(n);
        if (mb->t8x8) {
          for (int k = 0; k < 16; ++k) coef8[p][b8][kZigzag8[4 * k + i4]] = tmp[k];
        } else {
          for (int k = 0; k < 16; ++k) coef[p][rb][kZigzag4[k]] = tmp[k];
        }
      }
    }
  }

  void residual(bool i16) {
    std::memset(coef, 0, sizeof(coef));
    std::memset(coef8, 0, sizeof(coef8));
    std::memset(dc, 0, sizeof(dc));
    std::memset(cdc, 0, sizeof(cdc));
    std::memset(cac, 0, sizeof(cac));
    for (int p = 0; p < planes; ++p) residual_luma(p, i16);
    if (cfi != 1 && cfi != 2) return;
    int cc = mb->cbp >> 4;
    if (cc) {
      // Chroma DC: 2x2 (4:2:0) or 2x4 (4:2:2) levels in scan order.
      int ndc = 4 * nc8;
      for (int c = 0; c < 2; ++c) {
        int32_t tmp[8] = {0};
        int n;
        if (pps.cabac) n = cabac_block(tmp, 3, ndc, cbf_inc(3, c + 1, 0, 0));
        else n = cavlc_block(tmp, 0, ndc - 1, ndc, nc8 == 2 ? -2 : -1);
        std::memcpy(cdc[c], tmp, sizeof(tmp));
        if (n) mb->dc_cbf |= uint8_t(2 << c);
      }
    }
    if (cc == 2) {
      for (int c = 0; c < 2; ++c)
        for (int b = 0; b < 4 * nc8; ++b) {
          int x2 = b & 1, y2 = b >> 1;
          int32_t tmp[16] = {0};
          int n;
          if (pps.cabac) n = cabac_block(tmp + 1, 4, 15, cbf_inc(4, c + 1, x2, y2));
          else n = cavlc_block(tmp, 1, 15, 15, cavlc_nc(c + 1, x2, y2));
          mb->nz[16 * (c + 1) + b] = uint8_t(n);
          for (int k = 1; k < 16; ++k) cac[c][b][kZigzag4[k]] = tmp[k];
        }
    }
  }

  // ======================================================= macroblocks

  // QPY (from −QpBdOffsetY to 51, wrapping as 7.4.5 sets it) and the
  // macroblock's QPc (qPI clipped to −QpBdOffsetC..51, QPc = qPI below 30).
  void set_qp(int delta) {
    qp = (qp + delta + 52 + 2 * qp_bd) % (52 + qp_bd) - qp_bd;
    mb_qps(qp);
  }
  void mb_qps(int qpy) {
    mb->qp = int8_t(qpy);
    bypass = sps.bypass && qpy == -qp_bd;          // QP'Y 0
    for (int c = 0; c < 2; ++c) {
      int qpi = clip3(-qp_bd, 51, qpy + pps.chroma_qp_offset[c]);
      mb->qpc[c] = int8_t(qpi < 0 ? qpi : kChromaQp[qpi]);
    }
  }

  void decode_skip() {
    mb->skip = true;
    mb->kind = kInter;
    set_qp(0);
    prev_qp_delta_nz = 0;
    if (sh.type == 0) {
      // P_Skip (8.4.1.1).
      int mvx = 0, mvy = 0;
      int blk;
      MbInfo* a = nb4(-1, 0, blk);
      int ra = -1, ax = 0, ay = 0;
      if (a) mv_of(a, 0, blk, ra, ax, ay);
      int blkb;
      MbInfo* b = nb4(0, -1, blkb);
      int rb = -1, bx = 0, by = 0;
      if (b) mv_of(b, 0, blkb, rb, bx, by);
      if (!a || !b || (ra == 0 && ax == 0 && ay == 0) || (rb == 0 && bx == 0 && by == 0)) {
        mvx = mvy = 0;
      } else {
        mv_pred(0, 0, 0, 4, 0, mvx, mvy);
      }
      for (int k = 0; k < 4; ++k) set_ref(0, k, 0);
      fill_mv(0, 0, 0, 4, 4, mvx, mvy);
    } else {
      mb->direct16 = true;
      mb->direct8 = 15;
      direct_pred(15);
    }
    pixels([&](auto z) { inter_pred_mb<decltype(z)>(); });
  }

  void set_ref(int l, int b8, int r) {
    mb->ref[l][b8] = int8_t(r);
    mb->refid[l][b8] = r >= 0 ? list[l][size_t(r)]->uid : -1;
    mb->dbk[l][b8] = r >= 0 ? dbk_id[l][r] : -1;
  }

  void fill_mv(int l, int x4, int y4, int w4, int h4, int mx, int my) {
    if (mx < -32768 || mx > 32767 || my < -32768 || my > 32767)
      broken("H.264 motion vector out of range");
    for (int y = y4; y < y4 + h4; ++y)
      for (int x = x4; x < x4 + w4; ++x) {
        mb->mv[l][y * 4 + x][0] = int16_t(mx);
        mb->mv[l][y * 4 + x][1] = int16_t(my);
      }
  }

  // A neighbouring block's refIdx and mv in list l (refIdx -1 when it is
  // intra or does not use the list).
  void mv_of(MbInfo* m, int l, int blk, int& r, int& mx, int& my) {
    if (m->intra()) {
      r = -1;
      mx = my = 0;
      return;
    }
    int b8 = ((blk >> 3) << 1) | ((blk & 3) >> 1);
    r = m->ref[l][b8];
    if (r < 0) {
      mx = my = 0;
      return;
    }
    mx = m->mv[l][blk][0];
    my = m->mv[l][blk][1];
  }

  // Whether neighbouring 4x4 block (x4, y4) is available for motion
  // vector prediction: in another macroblock (available), or in the
  // current one and already given its motion.
  MbInfo* nb_motion(int x4, int y4, int& blk) {
    MbInfo* m = nb4(x4, y4, blk);
    if (m == mb && !done4[blk]) return nullptr;
    return m;
  }

  // Motion vector prediction (8.4.1.3) of the partition at (x4, y4),
  // w4 blocks wide, for list l and refIdx r; shape 0 median, 1 16x8,
  // 2 8x16; part is the partition index for the directional rules.
  void mv_pred(int l, int x4, int y4, int w4, int r, int& px, int& py,
               int shape = 0, int part = 0) {
    int ba, bb, bc;
    MbInfo* A = nb_motion(x4 - 1, y4, ba);
    MbInfo* B = nb_motion(x4, y4 - 1, bb);
    MbInfo* C = nb_motion(x4 + w4, y4 - 1, bc);
    if (!C) C = nb_motion(x4 - 1, y4 - 1, bc);
    int ra = -1, rb = -1, rc = -1, ax = 0, ay = 0, bx = 0, by = 0, cx = 0, cy = 0;
    if (A) mv_of(A, l, ba, ra, ax, ay);
    if (B) mv_of(B, l, bb, rb, bx, by);
    if (C) mv_of(C, l, bc, rc, cx, cy);
    if (shape == 1) {
      if (part == 0 && rb == r) { px = bx; py = by; return; }
      if (part == 1 && ra == r) { px = ax; py = ay; return; }
    } else if (shape == 2) {
      if (part == 0 && ra == r) { px = ax; py = ay; return; }
      if (part == 1 && rc == r) { px = cx; py = cy; return; }
    }
    if (!B && !C && A) {
      px = ax;
      py = ay;
      return;
    }
    int match = (ra == r) + (rb == r) + (rc == r);
    if (match == 1) {
      if (ra == r) { px = ax; py = ay; }
      else if (rb == r) { px = bx; py = by; }
      else { px = cx; py = cy; }
      return;
    }
    px = median3(ax, bx, cx);
    py = median3(ay, by, cy);
  }

  void mark_done(int x4, int y4, int w4, int h4) {
    for (int y = y4; y < y4 + h4; ++y)
      for (int x = x4; x < x4 + w4; ++x) done4[y * 4 + x] = true;
  }

  // B_Skip, B_Direct_16x16 and B_Direct_8x8 sub-macroblocks: the 8x8
  // blocks of `mask` (8.4.1.2).
  void direct_pred(int mask) {
    const Frame& col = *list[1][0];
    if (col.w != cur->w || col.h != cur->h) broken("H.264 colocated picture of another size");
    const MbInfo& cm = col.mbs[size_t(mb_addr)];
    auto col_of = [&](int blk, int& r, int& mx, int& my, int32_t& rid) {
      if (cm.intra()) {
        r = -1;
        mx = my = 0;
        rid = -1;
        return;
      }
      int b8 = ((blk >> 3) << 1) | ((blk & 3) >> 1);
      int l = cm.ref[0][b8] >= 0 ? 0 : 1;
      r = cm.ref[l][b8];
      rid = cm.refid[l][b8];
      mx = cm.mv[l][blk][0];
      my = cm.mv[l][blk][1];
    };
    static const int kCorner[4] = {0, 3, 12, 15};
    if (sh.direct_spatial) {
      int refs[2], mvx[2] = {0, 0}, mvy[2] = {0, 0};
      // Neighbours of the macroblock as a 16x16 partition.
      bool saved[16];
      std::memcpy(saved, done4, sizeof(done4));
      std::memset(done4, 0, sizeof(done4));
      for (int l = 0; l < 2; ++l) {
        int ba, bb, bc;
        MbInfo* A = nb_motion(-1, 0, ba);
        MbInfo* B = nb_motion(0, -1, bb);
        MbInfo* C = nb_motion(4, -1, bc);
        if (!C) C = nb_motion(-1, -1, bc);
        int ra = -1, rb = -1, rc = -1, x, y;
        if (A) mv_of(A, l, ba, ra, x, y);
        if (B) mv_of(B, l, bb, rb, x, y);
        if (C) mv_of(C, l, bc, rc, x, y);
        auto minpos = [](int a, int b) { return (a >= 0 && b >= 0) ? std::min(a, b) : std::max(a, b); };
        refs[l] = minpos(ra, minpos(rb, rc));
      }
      bool zero = refs[0] < 0 && refs[1] < 0;
      if (zero) refs[0] = refs[1] = 0;
      for (int l = 0; l < 2; ++l)
        if (!zero && refs[l] >= 0) mv_pred(l, 0, 0, 4, refs[l], mvx[l], mvy[l]);
      std::memcpy(done4, saved, sizeof(done4));
      for (int b8 = 0; b8 < 4; ++b8) {
        if (!((mask >> b8) & 1)) continue;
        int bx = (b8 & 1) * 2, by = (b8 >> 1) * 2;
        for (int l = 0; l < 2; ++l) set_ref(l, b8, refs[l]);
        for (int k = 0; k < 4; ++k) {
          int x4 = bx + (k & 1), y4 = by + (k >> 1);
          int blk = sps.direct_8x8_inference ? kCorner[b8] : y4 * 4 + x4;
          int r, cx, cy;
          int32_t rid;
          col_of(blk, r, cx, cy, rid);
          // colZeroFlag: RefPicList1[0] a short-term reference.
          bool colzero = !list[1][0]->long_term && r == 0 && cx >= -1 && cx <= 1 &&
                         cy >= -1 && cy <= 1;
          for (int l = 0; l < 2; ++l) {
            int mx = 0, my = 0;
            if (refs[l] >= 0 && !zero && !(refs[l] == 0 && colzero)) {
              mx = mvx[l];
              my = mvy[l];
            }
            fill_mv(l, x4, y4, 1, 1, mx, my);
          }
        }
        mark_done(bx, by, 2, 2);
      }
      return;
    }
    // Temporal direct.
    for (int b8 = 0; b8 < 4; ++b8) {
      if (!((mask >> b8) & 1)) continue;
      int bx = (b8 & 1) * 2, by = (b8 >> 1) * 2;
      int ref0 = -1;
      for (int k = 0; k < 4; ++k) {
        int x4 = bx + (k & 1), y4 = by + (k >> 1);
        int blk = sps.direct_8x8_inference ? kCorner[b8] : y4 * 4 + x4;
        int r, cx, cy;
        int32_t rid;
        col_of(blk, r, cx, cy, rid);
        int r0 = 0;
        if (r >= 0) {
          r0 = -1;
          for (int i = 0; i < sh.num_ref_idx[0]; ++i)
            if (list[0][size_t(i)]->uid == rid) {
              r0 = i;
              break;
            }
          if (r0 < 0) r0 = 0;
        }
        if (ref0 >= 0 && ref0 != r0) broken("H.264 temporal direct with two references in an 8x8 block");
        ref0 = r0;
        int poc0 = list[0][size_t(r0)]->poc, poc1 = list[1][0]->poc;
        int tb = clip3(-128, 127, cur->poc - poc0), td = clip3(-128, 127, poc1 - poc0);
        int m0x, m0y, m1x, m1y;
        // A long-term list-0 reference: mvCol unscaled, mvL1 0.
        if (td == 0 || list[0][size_t(r0)]->long_term) {
          m0x = cx;
          m0y = cy;
          m1x = m1y = 0;
        } else {
          int tx = (16384 + std::abs(td / 2)) / td;
          int dsf = clip3(-1024, 1023, (tb * tx + 32) >> 6);
          m0x = (dsf * cx + 128) >> 8;
          m0y = (dsf * cy + 128) >> 8;
          m1x = m0x - cx;
          m1y = m0y - cy;
        }
        fill_mv(0, x4, y4, 1, 1, m0x, m0y);
        fill_mv(1, x4, y4, 1, 1, m1x, m1y);
      }
      set_ref(0, b8, ref0);
      set_ref(1, b8, 0);
      mark_done(bx, by, 2, 2);
    }
  }

  void macroblock_layer() {
    int t = read_mb_type();
    bool islice = sh.type == 2;
    int itype = islice ? t : (t >= 100 ? t - 100 : -1);
    if (itype >= 0) {
      intra_mb(itype);
      return;
    }
    inter_mb(t);
  }

  void intra_mb(int itype) {
    if (itype == 25) {
      // I_PCM.
      mb->kind = kPcm;
      // The samples start at the next byte (after CABAC's terminating bin
      // in its bit-serial reading). The alignment bits are skipped
      // unread, as libavcodec does: x264 may set one after a CABAC flush.
      bits.pos = (bits.pos + 7) & ~size_t(7);
      int chroma = cfi == 0 ? 0 : 2 * mbwc * mbhc;
      if (bits.bits_left() < size_t(256 + chroma) * depth) broken("H.264 I_PCM samples cut short");
      pixels([&](auto z) {
        using P = decltype(z);
        for (int y = 0; y < 16; ++y)
          for (int x = 0; x < 16; ++x) ypix<P>(mb_x * 16 + x, mb_y * 16 + y)[0] = P(bits.u(depth));
        for (int c = 0; c < (cfi ? 2 : 0); ++c)
          for (int y = 0; y < mbhc; ++y)
            for (int x = 0; x < mbwc; ++x)
              cpix<P>(c, mb_x * mbwc + x, mb_y * mbhc + y)[0] = P(bits.u(depth));
      });
      mb->cbp = 0x2F;
      mb_qps(-qp_bd);           // libavcodec deblocks it at QP'Y 0
      std::memset(mb->nz, 16, sizeof(mb->nz));
      mb->dc_cbf = 7;
      prev_qp_delta_nz = 0;
      if (pps.cabac) cabac.init_engine();
      return;
    }
    bool i16 = itype >= 1;
    int pred16 = 0;
    if (i16) {
      mb->kind = kI16x16;
      int v = itype - 1;
      pred16 = v % 4;
      // CodedBlockPatternChroma is 0 where chroma is not coded apart
      // (4:4:4: the luma bits cover all three planes).
      mb->cbp = uint8_t((cfi == 3 ? 0 : ((v / 4) % 3) << 4) | (v >= 12 ? 15 : 0));
    } else {
      mb->kind = kI4x4;
      if (pps.transform_8x8 && read_t8x8()) {
        mb->kind = kI8x8;
        mb->t8x8 = true;
      }
      // Intra4x4/8x8 prediction modes.
      int nblk = mb->kind == kI8x8 ? 4 : 16;
      for (int k = 0; k < nblk; ++k) {
        int rem = read_intra_mode();
        int x4, y4;
        if (nblk == 4) {
          x4 = (k & 1) * 2;
          y4 = (k >> 1) * 2;
        } else {
          int rb = kBlkRaster[k];
          x4 = rb & 3;
          y4 = rb >> 2;
        }
        int pm = pred_intra_mode(x4, y4);
        int mode = rem < 0 ? pm : (rem < pm ? rem : rem + 1);
        if (nblk == 4) {
          for (int j = 0; j < 4; ++j) mb->ipred[(y4 + (j >> 1)) * 4 + x4 + (j & 1)] = int8_t(mode);
        } else {
          mb->ipred[y4 * 4 + x4] = int8_t(mode);
        }
      }
    }
    if (cfi == 1 || cfi == 2) mb->chroma_mode = uint8_t(read_chroma_mode());
    if (!i16) mb->cbp = uint8_t(read_cbp(true));
    if (mb->cbp || i16) {
      int d = read_qp_delta();
      set_qp(d);
      prev_qp_delta_nz = d != 0;
      residual(i16);
    } else {
      set_qp(0);
      prev_qp_delta_nz = 0;
      std::memset(coef, 0, sizeof(coef));     // no residual
      std::memset(coef8, 0, sizeof(coef8));
    }
    pixels([&](auto z) { intra_recon<decltype(z)>(i16, pred16); });
  }

  // Each plane coded as luma (Y; in 4:4:4 Cb and Cr too) is predicted
  // with the luma modes and gets its residual; 4:2:0's and 4:2:2's chroma
  // has its own prediction.
  template <class P>
  void intra_recon(bool i16, int pred16) {
    for (int p = 0; p < planes; ++p) {
      if (i16) {
        intra16<P>(p, pred16);
        luma_i16_residual<P>(p, pred16);
      } else if (mb->kind == kI8x8) {
        for (int b8 = 0; b8 < 4; ++b8) {
          int x = (b8 & 1) * 8, y = (b8 >> 1) * 8;
          int mode = mb->ipred[(y / 4) * 4 + x / 4];
          intra8<P>(p, b8, mode);
          add8x8<P>(p, b8, true, mode);
        }
      } else {
        for (int k = 0; k < 16; ++k) {
          int rb = kBlkRaster[k];
          intra4<P>(p, rb, mb->ipred[rb]);
          add4x4<P>(p, rb, true, mb->ipred[rb]);
        }
      }
    }
    if (cfi == 1 || cfi == 2) {
      intra_chroma<P>(mb->chroma_mode);
      chroma_residual<P>(true);
    }
  }

  // predIntra4x4PredMode / predIntra8x8PredMode of the block at (x4, y4).
  int pred_intra_mode(int x4, int y4) {
    int ba, bb;
    MbInfo* A = nb4(x4 - 1, y4, ba);
    MbInfo* B = nb4(x4, y4 - 1, bb);
    auto unavail = [&](MbInfo* m) { return !m || (m->kind == kInter && pps.constrained_intra); };
    if (unavail(A) || unavail(B)) return 2;
    int ma = (A->kind == kI4x4 || A->kind == kI8x8) ? A->ipred[ba] : 2;
    int mb_ = (B->kind == kI4x4 || B->kind == kI8x8) ? B->ipred[bb] : 2;
    return std::min(ma, mb_);
  }

  void inter_mb(int t) {
    mb->kind = kInter;
    bool pslice = sh.type == 0;
    int sub[4] = {0, 0, 0, 0};
    bool no_sub8x8_lt = true;
    if ((pslice && (t == 3 || t == 4)) || (!pslice && t == 22)) {
      // Sub-macroblocks.
      for (int k = 0; k < 4; ++k) sub[k] = read_sub_type();
      if (!pslice) {
        int mask = 0;
        for (int k = 0; k < 4; ++k)
          if (sub[k] == 0) mask |= 1 << k;
        if (mask) {
          mb->direct8 = uint8_t(mask);
          direct_pred(mask);
          std::memset(done4, 0, sizeof(done4));
          if (!sps.direct_8x8_inference) no_sub8x8_lt = false;
        }
      } else {
        for (int k = 0; k < 4; ++k)
          if (sub[k] != 0) no_sub8x8_lt = false;
      }
      // Sub-partition geometry: (count, w4, h4) and the lists each uses.
      int cnt[4], w4[4], h4[4], use[4];
      for (int k = 0; k < 4; ++k) {
        int s = sub[k];
        if (pslice) {
          static const int kC[4] = {1, 2, 2, 4}, kW[4] = {2, 2, 1, 1}, kH[4] = {2, 1, 2, 1};
          cnt[k] = kC[s];
          w4[k] = kW[s];
          h4[k] = kH[s];
          use[k] = 1;
        } else {
          static const int kC[13] = {4, 1, 1, 1, 2, 2, 2, 2, 2, 2, 4, 4, 4};
          static const int kW[13] = {1, 2, 2, 2, 2, 1, 2, 1, 2, 1, 1, 1, 1};
          static const int kH[13] = {1, 2, 2, 2, 1, 2, 1, 2, 1, 2, 1, 1, 1};
          static const int kU[13] = {0, 1, 2, 3, 1, 1, 2, 2, 3, 3, 1, 2, 3};
          cnt[k] = kC[s];
          w4[k] = kW[s];
          h4[k] = kH[s];
          use[k] = kU[s];
          if (s != 0 && cnt[k] > 1) no_sub8x8_lt = false;
        }
      }
      bool direct[4];
      for (int k = 0; k < 4; ++k) direct[k] = !pslice && sub[k] == 0;
      for (int l = 0; l < 2; ++l)
        for (int k = 0; k < 4; ++k) {
          if (direct[k]) continue;
          if (!((use[k] >> l) & 1)) {
            set_ref(l, k, -1);
            continue;
          }
          int r = 0;
          if (sh.num_ref_idx[l] > 1 && !(pslice && t == 4))
            r = read_ref_idx(l, (k & 1) * 2, (k >> 1) * 2);
          set_ref(l, k, r);
        }
      // mvds: all of list 0, then list 1; predictions in decoding order.
      int mvdx[2][4][4], mvdy[2][4][4];
      for (int l = 0; l < 2; ++l)
        for (int k = 0; k < 4; ++k) {
          if (direct[k] || !((use[k] >> l) & 1)) continue;
          for (int j = 0; j < cnt[k]; ++j) {
            int x4 = (k & 1) * 2 + (w4[k] == 1 ? (j & 1) : 0);
            int y4 = (k >> 1) * 2 + (h4[k] == 1 ? (w4[k] == 1 ? j >> 1 : j) : 0);
            int dx = read_mvd(l, 0, x4, y4);
            int dy = read_mvd(l, 1, x4, y4);
            mvdx[l][k][j] = dx;
            mvdy[l][k][j] = dy;
            for (int yy = y4; yy < y4 + h4[k]; ++yy)
              for (int xx = x4; xx < x4 + w4[k]; ++xx) {
                mb->mvd[l][yy * 4 + xx][0] = uint8_t(std::min(std::abs(dx), 255));
                mb->mvd[l][yy * 4 + xx][1] = uint8_t(std::min(std::abs(dy), 255));
              }
          }
        }
      for (int k = 0; k < 4; ++k) {
        if (direct[k]) {
          mark_done((k & 1) * 2, (k >> 1) * 2, 2, 2);
          continue;
        }
        for (int j = 0; j < cnt[k]; ++j) {
          int x4 = (k & 1) * 2 + (w4[k] == 1 ? (j & 1) : 0);
          int y4 = (k >> 1) * 2 + (h4[k] == 1 ? (w4[k] == 1 ? j >> 1 : j) : 0);
          for (int l = 0; l < 2; ++l) {
            if (!((use[k] >> l) & 1)) continue;
            int px, py;
            mv_pred(l, x4, y4, w4[k], mb->ref[l][k], px, py);
            fill_mv(l, x4, y4, w4[k], h4[k], px + mvdx[l][k][j], py + mvdy[l][k][j]);
          }
          mark_done(x4, y4, w4[k], h4[k]);
        }
      }
    } else if (!pslice && t == 0) {
      mb->direct16 = true;
      mb->direct8 = 15;
      direct_pred(15);
      if (!sps.direct_8x8_inference) no_sub8x8_lt = false;
    } else {
      // 16x16, 16x8, 8x16 partitions.
      int shape, uses[2];
      if (pslice) {
        shape = t;              // 0 16x16, 1 16x8, 2 8x16
        uses[0] = uses[1] = 1;
      } else if (t <= 3) {
        shape = 0;
        uses[0] = uses[1] = t;  // 1 L0, 2 L1, 3 Bi
      } else {
        shape = (t % 2 == 0) ? 1 : 2;
        static const int kP0[22] = {0, 0, 0, 0, 1, 1, 2, 2, 1, 1, 2, 2, 1, 1, 2, 2, 3, 3, 3, 3, 3, 3};
        static const int kP1[22] = {0, 0, 0, 0, 1, 1, 2, 2, 2, 2, 1, 1, 3, 3, 3, 3, 1, 1, 2, 2, 3, 3};
        uses[0] = kP0[t];
        uses[1] = kP1[t];
      }
      int nparts = shape == 0 ? 1 : 2;
      auto geom = [&](int p, int& x4, int& y4, int& w4, int& h4) {
        if (shape == 0) { x4 = 0; y4 = 0; w4 = 4; h4 = 4; }
        else if (shape == 1) { x4 = 0; y4 = 2 * p; w4 = 4; h4 = 2; }
        else { x4 = 2 * p; y4 = 0; w4 = 2; h4 = 4; }
      };
      for (int l = 0; l < 2; ++l)
        for (int p = 0; p < nparts; ++p) {
          int x4, y4, w4, h4;
          geom(p, x4, y4, w4, h4);
          int r = -1;
          if ((uses[p] >> l) & 1) {
            r = 0;
            if (sh.num_ref_idx[l] > 1) r = read_ref_idx(l, x4, y4);
          }
          for (int y = y4 / 2; y < (y4 + h4) / 2; ++y)
            for (int x = x4 / 2; x < (x4 + w4) / 2; ++x) set_ref(l, y * 2 + x, r);
        }
      int mvdx[2][2], mvdy[2][2];
      for (int l = 0; l < 2; ++l)
        for (int p = 0; p < nparts; ++p) {
          if (!((uses[p] >> l) & 1)) continue;
          int x4, y4, w4, h4;
          geom(p, x4, y4, w4, h4);
          int dx = read_mvd(l, 0, x4, y4);
          int dy = read_mvd(l, 1, x4, y4);
          mvdx[l][p] = dx;
          mvdy[l][p] = dy;
          for (int yy = y4; yy < y4 + h4; ++yy)
            for (int xx = x4; xx < x4 + w4; ++xx) {
              mb->mvd[l][yy * 4 + xx][0] = uint8_t(std::min(std::abs(dx), 255));
              mb->mvd[l][yy * 4 + xx][1] = uint8_t(std::min(std::abs(dy), 255));
            }
        }
      for (int p = 0; p < nparts; ++p) {
        int x4, y4, w4, h4;
        geom(p, x4, y4, w4, h4);
        for (int l = 0; l < 2; ++l) {
          if (!((uses[p] >> l) & 1)) continue;
          int px, py;
          mv_pred(l, x4, y4, w4, mb->ref[l][(y4 / 2) * 2 + x4 / 2], px, py, shape, p);
          fill_mv(l, x4, y4, w4, h4, px + mvdx[l][p], py + mvdy[l][p]);
        }
        mark_done(x4, y4, w4, h4);
      }
    }
    mb->cbp = uint8_t(read_cbp(false));
    if ((mb->cbp & 15) && pps.transform_8x8 && no_sub8x8_lt) mb->t8x8 = read_t8x8();
    if (mb->cbp) {
      int d = read_qp_delta();
      set_qp(d);
      prev_qp_delta_nz = d != 0;
      residual(false);
    } else {
      set_qp(0);
      prev_qp_delta_nz = 0;
    }
    pixels([&](auto z) { inter_recon<decltype(z)>(); });
  }

  template <class P>
  void inter_recon() {
    inter_pred_mb<P>();
    if (!mb->cbp) return;
    for (int p = 0; p < planes; ++p) {
      if (mb->t8x8) {
        for (int b8 = 0; b8 < 4; ++b8) add8x8<P>(p, b8, false);
      } else {
        for (int rb = 0; rb < 16; ++rb) add4x4<P>(p, rb, false);
      }
    }
    if (cfi == 1 || cfi == 2) chroma_residual<P>(false);
  }

  // ===================================================== reconstruction

  // Samples of the picture being decoded (P: uint8_t at 8 bits, uint16_t
  // above; see pixels()).
  template <class F>
  void pixels(F&& f) {
    if (depth > 8) f(uint16_t());
    else f(uint8_t());
  }
  int clipp(int v) const { return v < 0 ? 0 : v > pmax ? pmax : v; }
  template <class P>
  P* ypix(int x, int y) {
    return reinterpret_cast<P*>(cur->y.data()) + size_t(y) * cur->w + x;
  }
  template <class P>
  P* cpix(int c, int x, int y) {
    return reinterpret_cast<P*>((c == 0 ? cur->u : cur->v).data()) + size_t(y) * cur->cw + x;
  }
  // Plane p (0 Y, 1 Cb, 2 Cr) at a sample of the luma grid (4:4:4's
  // chroma is on it), and its row stride.
  template <class P>
  P* ppix(int p, int x, int y) {
    return p == 0 ? ypix<P>(x, y) : cpix<P>(p - 1, x, y);
  }
  int pstride(int p) const { return p == 0 ? cur->w : cur->cw; }

  // Lossless residual (TransformBypassModeFlag): r (n x n, raster, row
  // stride n) added to the prediction as it is, after the intra
  // horizontal or vertical modes' accumulation along their direction
  // (8.3.5.1; libavcodec's pred*_add): `dir` 0 vertical, 1 horizontal,
  // else none.
  template <class P>
  void bypass_add(int32_t* r, int w, int h, int dir, P* dst, int stride) const {
    if (dir == 0)
      for (int i = 1; i < h; ++i)
        for (int j = 0; j < w; ++j) r[i * w + j] += r[(i - 1) * w + j];
    else if (dir == 1)
      for (int i = 0; i < h; ++i)
        for (int j = 1; j < w; ++j) r[i * w + j] += r[i * w + j - 1];
    for (int i = 0; i < h; ++i)
      for (int j = 0; j < w; ++j) {
        P& p = dst[i * stride + j];
        p = P(clipp(p + r[i * w + j]));
      }
  }

  // Inverse 4x4 transform of d (raster, scaled) added to 4x4 pixels.
  template <class P>
  void idct4_add(int32_t* d, P* dst, int stride) const {
    int32_t t[16];
    for (int i = 0; i < 4; ++i) {
      int32_t* r = d + 4 * i;
      int e0 = r[0] + r[2], e1 = r[0] - r[2];
      int e2 = (r[1] >> 1) - r[3], e3 = r[1] + (r[3] >> 1);
      t[4 * i] = e0 + e3;
      t[4 * i + 1] = e1 + e2;
      t[4 * i + 2] = e1 - e2;
      t[4 * i + 3] = e0 - e3;
    }
    for (int j = 0; j < 4; ++j) {
      int g0 = t[j], g1 = t[4 + j], g2 = t[8 + j], g3 = t[12 + j];
      int e0 = g0 + g2, e1 = g0 - g2, e2 = (g1 >> 1) - g3, e3 = g1 + (g3 >> 1);
      int h[4] = {e0 + e3, e1 + e2, e1 - e2, e0 - e3};
      for (int i = 0; i < 4; ++i) {
        P& p = dst[i * stride + j];
        p = P(clipp(p + ((h[i] + 32) >> 6)));
      }
    }
  }

  template <class P>
  void idct8_add(int32_t* d, P* dst, int stride) const {
    int32_t t[64];
    auto pass = [](const int32_t* in, int step, int32_t* o, int ostep) {
      int d0 = in[0], d1 = in[step], d2 = in[2 * step], d3 = in[3 * step];
      int d4 = in[4 * step], d5 = in[5 * step], d6 = in[6 * step], d7 = in[7 * step];
      int e0 = d0 + d4, e1 = -d3 + d5 - d7 - (d7 >> 1), e2 = d0 - d4;
      int e3 = d1 + d7 - d3 - (d3 >> 1), e4 = (d2 >> 1) - d6;
      int e5 = -d1 + d7 + d5 + (d5 >> 1), e6 = d2 + (d6 >> 1);
      int e7 = d3 + d5 + d1 + (d1 >> 1);
      int f0 = e0 + e6, f1 = e1 + (e7 >> 2), f2 = e2 + e4, f3 = e3 + (e5 >> 2);
      int f4 = e2 - e4, f5 = (e3 >> 2) - e5, f6 = e0 - e6, f7 = e7 - (e1 >> 2);
      o[0] = f0 + f7;
      o[ostep] = f2 + f5;
      o[2 * ostep] = f4 + f3;
      o[3 * ostep] = f6 + f1;
      o[4 * ostep] = f6 - f1;
      o[5 * ostep] = f4 - f3;
      o[6 * ostep] = f2 - f5;
      o[7 * ostep] = f0 - f7;
    };
    for (int i = 0; i < 8; ++i) pass(d + 8 * i, 1, t + 8 * i, 1);
    int32_t r[64];
    for (int j = 0; j < 8; ++j) pass(t + j, 8, r + j, 8);
    for (int i = 0; i < 8; ++i)
      for (int j = 0; j < 8; ++j) {
        P& p = dst[i * stride + j];
        p = P(clipp(p + ((r[8 * i + j] + 32) >> 6)));
      }
  }

  // Scale a 4x4 block's coefficients (raster) in place; `skip_dc`
  // leaves coefficient 0 (already scaled DC).
  void scale4(int32_t* c, int list_idx, int q, bool skip_dc) {
    int m = q % 6, s = q / 6;
    for (int k = skip_dc ? 1 : 0; k < 16; ++k) {
      if (!c[k]) continue;
      int64_t v = int64_t(c[k]) * ls4[list_idx][m][k];
      if (q >= 24) v *= int64_t(1) << (s - 4);
      else v = (v + (1 << (3 - s))) >> (4 - s);
      c[k] = int32_t(v);
    }
  }

  // qP of plane p (QP'Y, or 4:4:4's QP'C of Cb or Cr).
  int plane_qp(int p) const { return (p == 0 ? mb->qp : mb->qpc[p - 1]) + qp_bd; }

  // A 4x4 block of plane p: scaled and inverse transformed, or under
  // transform bypass added as it is (`mode`: an Intra4x4 block's, whose
  // vertical and horizontal modes accumulate it).
  template <class P>
  void add4x4(int p, int rb, bool intra, int mode = -1) {
    int32_t* c = coef[p][rb];
    bool any = false;
    for (int k = 0; k < 16; ++k) any |= c[k] != 0;
    if (!any) return;
    int x = (rb & 3) * 4, y = (rb >> 2) * 4;
    P* dst = ppix<P>(p, mb_x * 16 + x, mb_y * 16 + y);
    if (bypass) return bypass_add(c, 4, 4, lossless_pred ? mode : -1, dst, pstride(p));
    scale4(c, (intra ? 0 : 3) + p, plane_qp(p), false);
    idct4_add(c, dst, pstride(p));
  }

  template <class P>
  void add8x8(int p, int b8, bool intra, int mode = -1) {
    int32_t* c = coef8[p][b8];
    bool any = false;
    for (int k = 0; k < 64; ++k) any |= c[k] != 0;
    if (!any) return;
    int x = (b8 & 1) * 8, y = (b8 >> 1) * 8;
    P* dst = ppix<P>(p, mb_x * 16 + x, mb_y * 16 + y);
    if (bypass) return bypass_add(c, 8, 8, lossless_pred ? mode : -1, dst, pstride(p));
    int q = plane_qp(p), m = q % 6, s = q / 6;
    const int* ls = ls8[2 * p + (intra ? 0 : 1)][m];
    for (int k = 0; k < 64; ++k) {
      if (!c[k]) continue;
      int64_t v = int64_t(c[k]) * ls[k];
      if (q >= 36) v *= int64_t(1) << (s - 6);
      else v = (v + (1 << (5 - s))) >> (6 - s);
      c[k] = int32_t(v);
    }
    idct8_add(c, dst, pstride(p));
  }

  template <class P>
  void luma_i16_residual(int p, int mode) {
    // DC: inverse scan, Hadamard, scale (8.5.10).
    int32_t c[16];
    for (int k = 0; k < 16; ++k) c[kZigzag4[k]] = dc[p][k];
    P* S = ppix<P>(p, mb_x * 16, mb_y * 16);
    const int W = pstride(p);
    if (bypass) {
      // Each 4x4 block's DC is the level at its place; the 16x16
      // residual accumulates under the vertical and horizontal modes.
      int32_t r[256];
      for (int rb = 0; rb < 16; ++rb) {
        coef[p][rb][0] = c[rb];
        for (int k = 0; k < 16; ++k)
          r[((rb >> 2) * 4 + (k >> 2)) * 16 + (rb & 3) * 4 + (k & 3)] = coef[p][rb][k];
      }
      return bypass_add(r, 16, 16, lossless_pred ? mode : -1, S, W);
    }
    int32_t t[16], f[16];
    for (int i = 0; i < 4; ++i) {
      int32_t* r = c + 4 * i;
      int a = r[0] + r[1], b = r[0] - r[1], cc = r[2] + r[3], d = r[2] - r[3];
      t[4 * i] = a + cc;
      t[4 * i + 1] = a - cc;
      t[4 * i + 2] = b - d;
      t[4 * i + 3] = b + d;
    }
    for (int j = 0; j < 4; ++j) {
      int a = t[j] + t[4 + j], b = t[j] - t[4 + j], cc = t[8 + j] + t[12 + j], d = t[8 + j] - t[12 + j];
      f[j] = a + cc;
      f[4 + j] = a - cc;
      f[8 + j] = b - d;
      f[12 + j] = b + d;
    }
    int q = plane_qp(p), m = q % 6, s = q / 6;
    int ls = ls4[p][m][0];
    for (int k = 0; k < 16; ++k) {
      int64_t v = int64_t(f[k]) * ls;
      if (q >= 36) v *= int64_t(1) << (s - 6);
      else v = (v + (1 << (5 - s))) >> (6 - s);
      f[k] = int32_t(v);
    }
    for (int rb = 0; rb < 16; ++rb) {
      int32_t* cb = coef[p][rb];
      cb[0] = 0;
      scale4(cb, p, q, true);
      cb[0] = f[rb];
      bool any = false;
      for (int k = 0; k < 16; ++k) any |= cb[k] != 0;
      if (!any) continue;
      int x = (rb & 3) * 4, y = (rb >> 2) * 4;
      idct4_add(cb, S + y * W + x, W);
    }
  }

  // Chroma DC (8.5.11: 2x2 for 4:2:0; 2x4 for 4:2:2, dequantised at
  // QP'c + 3) and the AC blocks, added to the prediction.
  template <class P>
  void chroma_residual(bool intra) {
    if (!(mb->cbp >> 4)) return;
    for (int c = 0; c < 2; ++c) {
      int q = mb->qpc[c] + qp_bd;
      int list = (intra ? 1 : 4) + c;
      int32_t* d = cdc[c];
      int32_t dcs[8];
      // c (4 rows, 2 columns) from 4:2:2's scan: c0 c2 / c1 c5 / c3 c6 / c4 c7.
      static const int kScan422[8] = {0, 2, 1, 5, 3, 6, 4, 7};
      if (bypass) {
        // Each 4x4 block's DC is the level at its place; the residual
        // accumulates under the horizontal (1) and vertical (2) modes.
        int32_t r[16 * 8];
        for (int b = 0; b < 4 * nc8; ++b) {
          cac[c][b][0] = nc8 == 1 ? d[b] : d[kScan422[b]];
          for (int k = 0; k < 16; ++k)
            r[((b >> 1) * 4 + (k >> 2)) * 8 + (b & 1) * 4 + (k & 3)] = cac[c][b][k];
        }
        int mode = mb->chroma_mode;
        int dir = !intra || !lossless_pred ? -1 : mode == 2 ? 0 : mode == 1 ? 1 : -1;
        bypass_add(r, 8, mbhc, dir, cpix<P>(c, mb_x * 8, mb_y * mbhc), cur->cw);
        continue;
      }
      if (nc8 == 1) {
        int f[4] = {d[0] + d[1] + d[2] + d[3], d[0] - d[1] + d[2] - d[3],
                    d[0] + d[1] - d[2] - d[3], d[0] - d[1] - d[2] + d[3]};
        int ls = ls4[list][q % 6][0];
        for (int b = 0; b < 4; ++b)
          dcs[b] = int32_t((int64_t(f[b]) * ls * (int64_t(1) << (q / 6))) >> 5);
      } else {
        int cm[4][2], t[4][2];
        for (int k = 0; k < 8; ++k) cm[k >> 1][k & 1] = d[kScan422[k]];
        for (int i2 = 0; i2 < 4; ++i2) {
          t[i2][0] = cm[i2][0] + cm[i2][1];
          t[i2][1] = cm[i2][0] - cm[i2][1];
        }
        int qdc = q + 3, ls = ls4[list][qdc % 6][0];
        for (int j2 = 0; j2 < 2; ++j2) {
          int z0 = t[0][j2] + t[2][j2], z1 = t[0][j2] - t[2][j2];
          int z2 = t[1][j2] - t[3][j2], z3 = t[1][j2] + t[3][j2];
          int f[4] = {z0 + z3, z1 + z2, z1 - z2, z0 - z3};
          for (int i2 = 0; i2 < 4; ++i2) {
            int64_t v = int64_t(f[i2]) * ls;
            if (qdc >= 36) v *= int64_t(1) << (qdc / 6 - 6);
            else v = (v + (int64_t(1) << (5 - qdc / 6))) >> (6 - qdc / 6);
            dcs[i2 * 2 + j2] = int32_t(v);
          }
        }
      }
      for (int b = 0; b < 4 * nc8; ++b) {
        int32_t* cb = cac[c][b];
        cb[0] = 0;
        scale4(cb, list, q, true);
        cb[0] = dcs[b];
        bool any = false;
        for (int k = 0; k < 16; ++k) any |= cb[k] != 0;
        if (!any) continue;
        int x = (b & 1) * 4, y = (b >> 1) * 4;
        idct4_add(cb, cpix<P>(c, mb_x * 8 + x, mb_y * mbhc + y), cur->cw);
      }
    }
  }

  // ---------------------------------------------------- intra prediction

  bool intra_avail(MbInfo* m) { return m && !(m->kind == kInter && pps.constrained_intra); }

  // Intra prediction of plane p (luma, or 4:4:4's Cb or Cr) with the
  // luma modes.
  template <class P>
  void intra4(int p, int rb, int mode) {
    int bx = rb & 3, by = rb >> 2;
    int x0 = mb_x * 16 + bx * 4, y0 = mb_y * 16 + by * 4;
    int ba;
    bool has_l = intra_avail(nb4(bx - 1, by, ba));
    bool has_t = intra_avail(nb4(bx, by - 1, ba));
    bool has_tl = intra_avail(nb4(bx - 1, by - 1, ba));
    // Blocks 3, 7, 11, 13 and 15 (z-order) have no decoded samples above
    // and to the right.
    bool has_tr = !(rb == 5 || rb == 7 || rb == 11 || rb == 13 || rb == 15) &&
                  intra_avail(nb4(bx + 1, by - 1, ba));
    int top[8], left[4], tl = 0;
    P* S = ppix<P>(p, x0, y0);
    int W = pstride(p);
    if (has_t) {
      for (int i = 0; i < 4; ++i) top[i] = S[-W + i];
      for (int i = 4; i < 8; ++i) top[i] = has_tr ? S[-W + i] : top[3];
    }
    if (has_l)
      for (int i = 0; i < 4; ++i) left[i] = S[i * W - 1];
    if (has_tl) tl = S[-W - 1];
    auto T = [&](int x) { return x < 0 ? tl : top[x]; };
    auto L = [&](int y) { return y < 0 ? tl : left[y]; };
    int pred[4][4];
    for (int y = 0; y < 4; ++y)
      for (int x = 0; x < 4; ++x) {
        int v = 0;
        switch (mode) {
          case 0:
            if (!has_t) broken("H.264 intra 4x4 vertical without its top");
            v = top[x];
            break;
          case 1:
            if (!has_l) broken("H.264 intra 4x4 horizontal without its left");
            v = left[y];
            break;
          case 2: {
            if (has_t && has_l) v = (top[0] + top[1] + top[2] + top[3] + left[0] + left[1] + left[2] + left[3] + 4) >> 3;
            else if (has_l) v = (left[0] + left[1] + left[2] + left[3] + 2) >> 2;
            else if (has_t) v = (top[0] + top[1] + top[2] + top[3] + 2) >> 2;
            else v = 1 << (depth - 1);
            break;
          }
          case 3:
            if (!has_t) broken("H.264 intra 4x4 mode without its top");
            if (x == 3 && y == 3) v = (top[6] + 3 * top[7] + 2) >> 2;
            else v = (top[x + y] + 2 * top[x + y + 1] + top[x + y + 2] + 2) >> 2;
            break;
          case 4:
            if (!has_t || !has_l || !has_tl) broken("H.264 intra 4x4 mode without its neighbours");
            if (x > y) v = (T(x - y - 2) + 2 * T(x - y - 1) + T(x - y) + 2) >> 2;
            else if (x < y) v = (L(y - x - 2) + 2 * L(y - x - 1) + L(y - x) + 2) >> 2;
            else v = (T(0) + 2 * tl + L(0) + 2) >> 2;
            break;
          case 5: {
            if (!has_t || !has_l || !has_tl) broken("H.264 intra 4x4 mode without its neighbours");
            int z = 2 * x - y;
            if (z >= 0 && !(z & 1)) v = (T(x - (y >> 1) - 1) + T(x - (y >> 1)) + 1) >> 1;
            else if (z >= 0) v = (T(x - (y >> 1) - 2) + 2 * T(x - (y >> 1) - 1) + T(x - (y >> 1)) + 2) >> 2;
            else if (z == -1) v = (L(0) + 2 * tl + T(0) + 2) >> 2;
            else v = (L(y - 2 * x - 1) + 2 * L(y - 2 * x - 2) + L(y - 2 * x - 3) + 2) >> 2;
            break;
          }
          case 6: {
            if (!has_t || !has_l || !has_tl) broken("H.264 intra 4x4 mode without its neighbours");
            int z = 2 * y - x;
            if (z >= 0 && !(z & 1)) v = (L(y - (x >> 1) - 1) + L(y - (x >> 1)) + 1) >> 1;
            else if (z >= 0) v = (L(y - (x >> 1) - 2) + 2 * L(y - (x >> 1) - 1) + L(y - (x >> 1)) + 2) >> 2;
            else if (z == -1) v = (L(0) + 2 * tl + T(0) + 2) >> 2;
            else v = (T(x - 2 * y - 1) + 2 * T(x - 2 * y - 2) + T(x - 2 * y - 3) + 2) >> 2;
            break;
          }
          case 7:
            if (!has_t) broken("H.264 intra 4x4 mode without its top");
            if (!(y & 1)) v = (top[x + (y >> 1)] + top[x + (y >> 1) + 1] + 1) >> 1;
            else v = (top[x + (y >> 1)] + 2 * top[x + (y >> 1) + 1] + top[x + (y >> 1) + 2] + 2) >> 2;
            break;
          case 8: {
            if (!has_l) broken("H.264 intra 4x4 mode without its left");
            int z = x + 2 * y;
            if (z < 5 && !(z & 1)) v = (left[y + (x >> 1)] + left[y + (x >> 1) + 1] + 1) >> 1;
            else if (z < 5) v = (left[y + (x >> 1)] + 2 * left[y + (x >> 1) + 1] + left[y + (x >> 1) + 2] + 2) >> 2;
            else if (z == 5) v = (left[2] + 3 * left[3] + 2) >> 2;
            else v = left[3];
            break;
          }
          default:
            broken("H.264 intra 4x4 mode above 8");
        }
        pred[y][x] = v;
      }
    for (int y = 0; y < 4; ++y)
      for (int x = 0; x < 4; ++x) S[y * W + x] = P(pred[y][x]);
  }

  template <class P>
  void intra8(int p, int b8, int mode) {
    int bx = (b8 & 1) * 2, by = (b8 >> 1) * 2;
    int x0 = mb_x * 16 + bx * 4, y0 = mb_y * 16 + by * 4;
    int ba;
    bool has_l = intra_avail(nb4(bx - 1, by, ba));
    bool has_t = intra_avail(nb4(bx, by - 1, ba));
    bool has_tl = intra_avail(nb4(bx - 1, by - 1, ba));
    bool has_tr = b8 == 3 ? false : b8 == 2 ? true : intra_avail(nb4(bx + 2, by - 1, ba));
    P* S = ppix<P>(p, x0, y0);
    int W = pstride(p);
    int p_top[16], p_left[8], p_tl = 0;
    if (has_t) {
      for (int i = 0; i < 8; ++i) p_top[i] = S[-W + i];
      for (int i = 8; i < 16; ++i) p_top[i] = has_tr ? S[-W + i] : p_top[7];
    }
    if (has_l)
      for (int i = 0; i < 8; ++i) p_left[i] = S[i * W - 1];
    if (has_tl) p_tl = S[-W - 1];
    // Reference sample filtering (8.3.2.2.1).
    int top[16], left[8], tl = 0;
    if (has_t) {
      top[0] = has_tl ? (p_tl + 2 * p_top[0] + p_top[1] + 2) >> 2 : (3 * p_top[0] + p_top[1] + 2) >> 2;
      for (int x = 1; x < 15; ++x) top[x] = (p_top[x - 1] + 2 * p_top[x] + p_top[x + 1] + 2) >> 2;
      top[15] = (p_top[14] + 3 * p_top[15] + 2) >> 2;
    }
    if (has_tl) {
      if (!has_t || !has_l) {
        if (has_t) tl = (3 * p_tl + p_top[0] + 2) >> 2;
        else if (has_l) tl = (3 * p_tl + p_left[0] + 2) >> 2;
        else tl = p_tl;
      } else {
        tl = (p_top[0] + 2 * p_tl + p_left[0] + 2) >> 2;
      }
    }
    if (has_l) {
      left[0] = has_tl ? (p_tl + 2 * p_left[0] + p_left[1] + 2) >> 2 : (3 * p_left[0] + p_left[1] + 2) >> 2;
      for (int y = 1; y < 7; ++y) left[y] = (p_left[y - 1] + 2 * p_left[y] + p_left[y + 1] + 2) >> 2;
      left[7] = (p_left[6] + 3 * p_left[7] + 2) >> 2;
    }
    auto T = [&](int x) { return x < 0 ? tl : top[x]; };
    auto L = [&](int y) { return y < 0 ? tl : left[y]; };
    bool need_t = mode == 0 || mode == 3 || mode == 4 || mode == 5 || mode == 6 || mode == 7;
    bool need_l = mode == 1 || mode == 4 || mode == 5 || mode == 6 || mode == 8;
    bool need_tl = mode == 4 || mode == 5 || mode == 6;
    if ((need_t && !has_t) || (need_l && !has_l) || (need_tl && !has_tl) || mode > 8)
      broken("H.264 intra 8x8 mode without its neighbours");
    int pred[8][8];
    for (int y = 0; y < 8; ++y)
      for (int x = 0; x < 8; ++x) {
        int v = 0;
        switch (mode) {
          case 0: v = top[x]; break;
          case 1: v = left[y]; break;
          case 2: {
            int s = 0;
            if (has_t && has_l) {
              for (int i = 0; i < 8; ++i) s += top[i] + left[i];
              v = (s + 8) >> 4;
            } else if (has_l) {
              for (int i = 0; i < 8; ++i) s += left[i];
              v = (s + 4) >> 3;
            } else if (has_t) {
              for (int i = 0; i < 8; ++i) s += top[i];
              v = (s + 4) >> 3;
            } else {
              v = 1 << (depth - 1);
            }
            break;
          }
          case 3:
            if (x == 7 && y == 7) v = (top[14] + 3 * top[15] + 2) >> 2;
            else v = (top[x + y] + 2 * top[x + y + 1] + top[x + y + 2] + 2) >> 2;
            break;
          case 4:
            if (x > y) v = (T(x - y - 2) + 2 * T(x - y - 1) + T(x - y) + 2) >> 2;
            else if (x < y) v = (L(y - x - 2) + 2 * L(y - x - 1) + L(y - x) + 2) >> 2;
            else v = (T(0) + 2 * tl + L(0) + 2) >> 2;
            break;
          case 5: {
            int z = 2 * x - y;
            if (z >= 0 && !(z & 1)) v = (T(x - (y >> 1) - 1) + T(x - (y >> 1)) + 1) >> 1;
            else if (z >= 0) v = (T(x - (y >> 1) - 2) + 2 * T(x - (y >> 1) - 1) + T(x - (y >> 1)) + 2) >> 2;
            else if (z == -1) v = (L(0) + 2 * tl + T(0) + 2) >> 2;
            else v = (L(y - 2 * x - 1) + 2 * L(y - 2 * x - 2) + L(y - 2 * x - 3) + 2) >> 2;
            break;
          }
          case 6: {
            int z = 2 * y - x;
            if (z >= 0 && !(z & 1)) v = (L(y - (x >> 1) - 1) + L(y - (x >> 1)) + 1) >> 1;
            else if (z >= 0) v = (L(y - (x >> 1) - 2) + 2 * L(y - (x >> 1) - 1) + L(y - (x >> 1)) + 2) >> 2;
            else if (z == -1) v = (L(0) + 2 * tl + T(0) + 2) >> 2;
            else v = (T(x - 2 * y - 1) + 2 * T(x - 2 * y - 2) + T(x - 2 * y - 3) + 2) >> 2;
            break;
          }
          case 7:
            if (!(y & 1)) v = (top[x + (y >> 1)] + top[x + (y >> 1) + 1] + 1) >> 1;
            else v = (top[x + (y >> 1)] + 2 * top[x + (y >> 1) + 1] + top[x + (y >> 1) + 2] + 2) >> 2;
            break;
          case 8: {
            int z = x + 2 * y;
            if (z < 13 && !(z & 1)) v = (left[y + (x >> 1)] + left[y + (x >> 1) + 1] + 1) >> 1;
            else if (z < 13) v = (left[y + (x >> 1)] + 2 * left[y + (x >> 1) + 1] + left[y + (x >> 1) + 2] + 2) >> 2;
            else if (z == 13) v = (left[6] + 3 * left[7] + 2) >> 2;
            else v = left[7];
            break;
          }
        }
        pred[y][x] = v;
      }
    for (int y = 0; y < 8; ++y)
      for (int x = 0; x < 8; ++x) S[y * W + x] = P(pred[y][x]);
  }

  template <class P>
  void intra16(int p, int mode) {
    bool has_l = intra_avail(mbA()), has_t = intra_avail(mbB()), has_tl = intra_avail(nb_mb(-1, -1));
    P* S = ppix<P>(p, mb_x * 16, mb_y * 16);
    int W = pstride(p);
    int top[16], left[16];
    if (has_t)
      for (int i = 0; i < 16; ++i) top[i] = S[-W + i];
    if (has_l)
      for (int i = 0; i < 16; ++i) left[i] = S[i * W - 1];
    if ((mode == 0 && !has_t) || (mode == 1 && !has_l) || (mode == 3 && !(has_t && has_l && has_tl)))
      broken("H.264 intra 16x16 mode without its neighbours");
    if (mode == 0 || mode == 1) {
      for (int y = 0; y < 16; ++y)
        for (int x = 0; x < 16; ++x) S[y * W + x] = P(mode == 0 ? top[x] : left[y]);
    } else if (mode == 2) {
      int s = 0, v;
      if (has_t && has_l) {
        for (int i = 0; i < 16; ++i) s += top[i] + left[i];
        v = (s + 16) >> 5;
      } else if (has_l) {
        for (int i = 0; i < 16; ++i) s += left[i];
        v = (s + 8) >> 4;
      } else if (has_t) {
        for (int i = 0; i < 16; ++i) s += top[i];
        v = (s + 8) >> 4;
      } else {
        v = 1 << (depth - 1);
      }
      for (int y = 0; y < 16; ++y) std::fill_n(S + y * W, 16, P(v));
    } else {
      int tl = S[-W - 1];
      auto T = [&](int x) { return x < 0 ? tl : top[x]; };
      auto L = [&](int y) { return y < 0 ? tl : left[y]; };
      int H = 0, V = 0;
      for (int k = 0; k < 8; ++k) {
        H += (k + 1) * (T(8 + k) - T(6 - k));
        V += (k + 1) * (L(8 + k) - L(6 - k));
      }
      int a = 16 * (left[15] + top[15]), b = (5 * H + 32) >> 6, c = (5 * V + 32) >> 6;
      for (int y = 0; y < 16; ++y)
        for (int x = 0; x < 16; ++x) S[y * W + x] = P(clipp((a + b * (x - 7) + c * (y - 7) + 16) >> 5));
    }
  }

  // Intra chroma prediction (8.3.4) of the 8x8 (4:2:0) or 8x16 (4:2:2)
  // blocks: DC per 4x4 block, horizontal, vertical, plane.
  template <class P>
  void intra_chroma(int mode) {
    bool has_l = intra_avail(mbA()), has_t = intra_avail(mbB()), has_tl = intra_avail(nb_mb(-1, -1));
    if ((mode == 1 && !has_l) || (mode == 2 && !has_t) || (mode == 3 && !(has_t && has_l && has_tl)))
      broken("H.264 intra chroma mode without its neighbours");
    int W = cur->cw, H = mbhc;
    for (int c = 0; c < 2; ++c) {
      P* S = cpix<P>(c, mb_x * 8, mb_y * H);
      int top[8], left[16];
      if (has_t)
        for (int i = 0; i < 8; ++i) top[i] = S[-W + i];
      if (has_l)
        for (int i = 0; i < H; ++i) left[i] = S[i * W - 1];
      if (mode == 0) {
        for (int b = 0; b < 2 * H / 4; ++b) {
          int xo = (b & 1) * 4, yo = (b >> 1) * 4;
          int st = 0, sl = 0;
          if (has_t) for (int i = 0; i < 4; ++i) st += top[xo + i];
          if (has_l) for (int i = 0; i < 4; ++i) sl += left[yo + i];
          int v;
          if ((xo == 0 && yo == 0) || (xo > 0 && yo > 0)) {
            if (has_t && has_l) v = (st + sl + 4) >> 3;
            else if (has_l) v = (sl + 2) >> 2;
            else if (has_t) v = (st + 2) >> 2;
            else v = 1 << (depth - 1);
          } else if (xo > 0) {
            if (has_t) v = (st + 2) >> 2;
            else if (has_l) v = (sl + 2) >> 2;
            else v = 1 << (depth - 1);
          } else {
            if (has_l) v = (sl + 2) >> 2;
            else if (has_t) v = (st + 2) >> 2;
            else v = 1 << (depth - 1);
          }
          for (int y = 0; y < 4; ++y) std::fill_n(S + (yo + y) * W + xo, 4, P(v));
        }
      } else if (mode == 1 || mode == 2) {
        for (int y = 0; y < H; ++y)
          for (int x = 0; x < 8; ++x) S[y * W + x] = P(mode == 1 ? left[y] : top[x]);
      } else {
        // xCF 0, yCF 4 for 4:2:2 (8-141 to 8-144).
        int tl = S[-W - 1], ycf = H == 16 ? 4 : 0;
        auto T = [&](int x) { return x < 0 ? tl : top[x]; };
        auto L = [&](int y) { return y < 0 ? tl : left[y]; };
        int Hs = 0, V = 0;
        for (int k = 0; k < 4; ++k) Hs += (k + 1) * (T(4 + k) - T(2 - k));
        for (int k = 0; k < 4 + ycf; ++k) V += (k + 1) * (L(4 + ycf + k) - L(2 + ycf - k));
        int a = 16 * (left[H - 1] + top[7]), b = (34 * Hs + 32) >> 6;
        int cc = ((H == 16 ? 5 : 34) * V + 32) >> 6;
        for (int y = 0; y < H; ++y)
          for (int x = 0; x < 8; ++x)
            S[y * W + x] = P(clipp((a + b * (x - 3) + cc * (y - 3 - ycf) + 16) >> 5));
      }
    }
  }

  // ---------------------------------------------------- inter prediction

  // Luma samples (or 4:4:4's chroma: plane p of `ref`, interpolated as
  // luma) of a w x h block at quarter-sample position (qx, qy) of `ref`
  // (picture coordinates), read clamped (8.4.2.2.1), into dst (stride
  // 16). The half-sample planes a position needs are computed once for
  // the block: b (horizontal), h (vertical), j (centre, from the
  // unrounded horizontal sums).
  template <class P>
  void mc_luma(const Frame& ref, int p, int qx, int qy, int w, int h, uint16_t* dst) const {
    int x0 = qx >> 2, y0 = qy >> 2, fx = qx & 3, fy = qy & 3;
    const P* plane = reinterpret_cast<const P*>((p == 0 ? ref.y : p == 1 ? ref.u : ref.v).data());
    // G(i, j) = g[(j + 2) * gs + i + 2], rows -2..h+2, columns -2..w+2.
    P win[21 * 21];
    const P* g;
    int gs;
    if (x0 - 2 >= 0 && y0 - 2 >= 0 && x0 + w + 3 <= ref.w && y0 + h + 3 <= ref.h) {
      gs = ref.w;
      g = plane + size_t(y0 - 2) * gs + x0 - 2;
    } else {
      gs = 21;
      for (int j = 0; j < h + 5; ++j) {
        const P* row = plane + size_t(clip3(0, ref.h - 1, y0 - 2 + j)) * ref.w;
        for (int i = 0; i < w + 5; ++i) win[j * 21 + i] = row[clip3(0, ref.w - 1, x0 - 2 + i)];
      }
      g = win;
    }
    auto G = [&](int i, int j) { return int(g[(j + 2) * gs + i + 2]); };
    int mode = fy * 4 + fx;
    if (mode == 0) {
      for (int j = 0; j < h; ++j)
        for (int i = 0; i < w; ++i) dst[j * 16 + i] = uint16_t(G(i, j));
      return;
    }
    auto tap6 = [](int a, int b, int c, int d, int e, int f) {
      return a - 5 * b + 20 * c + 20 * d - 5 * e + f;
    };
    bool use_j = mode == 6 || mode == 9 || mode == 10 || mode == 11 || mode == 14;
    bool use_b = fx != 0 && !(mode == 9 || mode == 10 || mode == 11);
    bool use_h = fy != 0 && !(mode == 6 || mode == 10 || mode == 14);
    // b1: unrounded horizontal sums, rows -2..h+2 (index j + 2).
    int b1[21][16];
    int B[17][16], H[16][17], J[16][16];
    if (use_b || use_j) {
      int lo = use_j ? -2 : 0, hi = use_j ? h + 3 : h + 1;
      for (int j = lo; j < hi; ++j)
        for (int i = 0; i < w; ++i)
          b1[j + 2][i] = tap6(G(i - 2, j), G(i - 1, j), G(i, j), G(i + 1, j), G(i + 2, j), G(i + 3, j));
      if (use_b)
        for (int j = 0; j <= h; ++j)
          for (int i = 0; i < w; ++i) B[j][i] = clipp((b1[j + 2][i] + 16) >> 5);
    }
    if (use_h)
      for (int j = 0; j < h; ++j)
        for (int i = 0; i <= w; ++i)
          H[j][i] = clipp((tap6(G(i, j - 2), G(i, j - 1), G(i, j), G(i, j + 1), G(i, j + 2), G(i, j + 3)) + 16) >> 5);
    if (use_j)
      for (int j = 0; j < h; ++j)
        for (int i = 0; i < w; ++i)
          J[j][i] = clipp((tap6(b1[j][i], b1[j + 1][i], b1[j + 2][i], b1[j + 3][i], b1[j + 4][i], b1[j + 5][i]) + 512) >> 10);
    for (int j = 0; j < h; ++j)
      for (int i = 0; i < w; ++i) {
        int v;
        switch (mode) {
          case 1: v = (G(i, j) + B[j][i] + 1) >> 1; break;
          case 2: v = B[j][i]; break;
          case 3: v = (G(i + 1, j) + B[j][i] + 1) >> 1; break;
          case 4: v = (G(i, j) + H[j][i] + 1) >> 1; break;
          case 5: v = (B[j][i] + H[j][i] + 1) >> 1; break;
          case 6: v = (B[j][i] + J[j][i] + 1) >> 1; break;
          case 7: v = (B[j][i] + H[j][i + 1] + 1) >> 1; break;
          case 8: v = H[j][i]; break;
          case 9: v = (H[j][i] + J[j][i] + 1) >> 1; break;
          case 10: v = J[j][i]; break;
          case 11: v = (J[j][i] + H[j][i + 1] + 1) >> 1; break;
          case 12: v = (G(i, j + 1) + H[j][i] + 1) >> 1; break;
          case 13: v = (H[j][i] + B[j + 1][i] + 1) >> 1; break;
          case 14: v = (J[j][i] + B[j + 1][i] + 1) >> 1; break;
          default: v = (H[j][i + 1] + B[j + 1][i] + 1) >> 1; break;
        }
        dst[j * 16 + i] = uint16_t(v);
      }
  }

  // Chroma samples of a w x h block at (x0 + fx / 8, y0 + fy / 8) of
  // `ref`'s plane c, read clamped (8.4.2.2.2), into dst (stride 16).
  template <class P>
  static void mc_chroma(const Frame& ref, int c, int x0, int y0, int fx, int fy, int w, int h,
                        uint16_t* dst) {
    int cw = ref.cw, ch = ref.ch;
    const P* pl = reinterpret_cast<const P*>((c == 0 ? ref.u : ref.v).data());
    for (int j = 0; j < h; ++j) {
      int ya = clip3(0, ch - 1, y0 + j), yb = clip3(0, ch - 1, y0 + j + 1);
      for (int i = 0; i < w; ++i) {
        int xa = clip3(0, cw - 1, x0 + i), xb = clip3(0, cw - 1, x0 + i + 1);
        int A = pl[size_t(ya) * cw + xa], Bv = pl[size_t(ya) * cw + xb];
        int C = pl[size_t(yb) * cw + xa], D = pl[size_t(yb) * cw + xb];
        dst[j * 16 + i] = uint16_t(((8 - fx) * (8 - fy) * A + fx * (8 - fy) * Bv +
                                    (8 - fx) * fy * C + fx * fy * D + 32) >> 6);
      }
    }
  }

  // Predicts a w4 x h4 block group at (x4, y4) with the motion stored in
  // the macroblock (both lists as used, weighted) into the picture.
  template <class P>
  void predict_part(int x4, int y4, int w4, int h4) {
    int b8 = (y4 / 2) * 2 + x4 / 2;
    int r0 = mb->ref[0][b8], r1 = mb->ref[1][b8];
    int w = w4 * 4, h = h4 * 4;
    int cw = w * mbwc / 16, chh = h * mbhc / 16;    // the chroma block
    uint16_t pl[2][3][256];
    int blk = y4 * 4 + x4;
    int nplanes = cfi ? 3 : 1;
    for (int l = 0; l < 2; ++l) {
      int r = l == 0 ? r0 : r1;
      if (r < 0) continue;
      const Frame& ref = *list[l][size_t(r)];
      if (ref.w != cur->w || ref.h != cur->h || ref.cfi != cur->cfi || ref.depth != cur->depth)
        broken("H.264 reference picture of another size or format");
      int mx = mb->mv[l][blk][0], my = mb->mv[l][blk][1];
      int px = mb_x * 16 + x4 * 4, py = mb_y * 16 + y4 * 4;
      mc_luma<P>(ref, 0, px * 4 + mx, py * 4 + my, w, h, pl[l][0]);
      // Chroma vectors: 1/8 sample horizontally; vertically 1/8 (4:2:0)
      // or 1/4 (4:2:2: its eighth as 2 * (my & 3)); 4:4:4's chroma is
      // interpolated as luma.
      for (int c = 0; c < nplanes - 1; ++c) {
        if (cfi == 3)
          mc_luma<P>(ref, 1 + c, px * 4 + mx, py * 4 + my, w, h, pl[l][1 + c]);
        else if (cfi == 2)
          mc_chroma<P>(ref, c, px / 2 + (mx >> 3), py + (my >> 2), mx & 7, (my & 3) << 1,
                       cw, chh, pl[l][1 + c]);
        else
          mc_chroma<P>(ref, c, px / 2 + (mx >> 3), py / 2 + (my >> 3), mx & 7, my & 7,
                       cw, chh, pl[l][1 + c]);
      }
    }
    if (r0 < 0 && r1 < 0) broken("H.264 inter block without a reference");
    for (int comp = 0; comp < nplanes; ++comp) {
      int bw = comp ? cw : w, bh = comp ? chh : h;
      P* dst = comp == 0 ? ypix<P>(mb_x * 16 + x4 * 4, mb_y * 16 + y4 * 4)
                         : cpix<P>(comp - 1, mb_x * mbwc + x4 * (mbwc / 4),
                                   mb_y * mbhc + y4 * (mbhc / 4));
      int stride = comp == 0 ? cur->w : cur->cw;
      // Weights: explicit (P, and B of weighted_bipred_idc 1), implicit
      // (B) or default; explicit offsets scaled to the bit depth.
      bool explicit_w = sh.type == 0 ? pps.weighted_pred : pps.weighted_bipred_idc == 1;
      for (int j = 0; j < bh; ++j)
        for (int i = 0; i < bw; ++i) {
          int v;
          if (r0 >= 0 && r1 >= 0) {
            int a = pl[0][comp][j * 16 + i], b = pl[1][comp][j * 16 + i];
            if (use_implicit) {
              int w0 = implicit_w[r0][r1][0], w1 = implicit_w[r0][r1][1];
              v = clipp((a * w0 + b * w1 + 32) >> 6);
            } else if (explicit_w) {
              // libavcodec's biweight: the offsets' sum scaled, then
              // ((o + 1) | 1) << logWD (the rounding and (o0 + o1 + 1) >> 1).
              int lwd = comp ? sh.chroma_log2 : sh.luma_log2;
              int w0 = comp ? sh.cw[0][r0][comp - 1] : sh.lw[0][r0];
              int w1 = comp ? sh.cw[1][r1][comp - 1] : sh.lw[1][r1];
              int o = (comp ? sh.co[0][r0][comp - 1] + sh.co[1][r1][comp - 1]
                            : sh.lo[0][r0] + sh.lo[1][r1]) * (1 << (depth - 8));
              v = clipp((a * w0 + b * w1 + (((o + 1) | 1) << lwd)) >> (lwd + 1));
            } else {
              v = (a + b + 1) >> 1;
            }
          } else {
            int l = r0 >= 0 ? 0 : 1;
            int r = l == 0 ? r0 : r1;
            int a = pl[l][comp][j * 16 + i];
            if (explicit_w) {
              int lwd = comp ? sh.chroma_log2 : sh.luma_log2;
              int wt = comp ? sh.cw[l][r][comp - 1] : sh.lw[l][r];
              int o = (comp ? sh.co[l][r][comp - 1] : sh.lo[l][r]) * (1 << (depth - 8));
              if (lwd >= 1) v = clipp(((a * wt + (1 << (lwd - 1))) >> lwd) + o);
              else v = clipp(a * wt + o);
            } else {
              v = a;
            }
          }
          dst[j * stride + i] = P(v);
        }
    }
  }

  template <class P>
  void inter_pred_mb() {
    // Predict in 4x4 units grouped where the motion is uniform: each 8x8
    // block as one unit when its four 4x4 blocks share their motion.
    for (int b8 = 0; b8 < 4; ++b8) {
      int bx = (b8 & 1) * 2, by = (b8 >> 1) * 2;
      bool same = true;
      for (int l = 0; l < 2 && same; ++l) {
        if (mb->ref[l][b8] < 0) continue;
        for (int k = 1; k < 4; ++k) {
          int blk = (by + (k >> 1)) * 4 + bx + (k & 1);
          if (mb->mv[l][blk][0] != mb->mv[l][by * 4 + bx][0] ||
              mb->mv[l][blk][1] != mb->mv[l][by * 4 + bx][1])
            same = false;
        }
      }
      if (same) {
        predict_part<P>(bx, by, 2, 2);
      } else {
        for (int k = 0; k < 4; ++k) predict_part<P>(bx + (k & 1), by + (k >> 1), 1, 1);
      }
    }
  }

  // ========================================================= deblocking

  // bS of the edge between 4x4 blocks p (in mp) and q (in mq).
  int bs_of(const MbInfo& mp, int bp, const MbInfo& mq, int bq, bool mb_edge) {
    if (mp.intra() || mq.intra()) return mb_edge ? 4 : 3;
    auto nz = [](const MbInfo& m, int b) {
      if (m.t8x8) {
        int b8 = ((b >> 3) << 1) | ((b & 3) >> 1);
        int bx = (b8 & 1) * 2, by = (b8 >> 1) * 2;
        for (int k = 0; k < 4; ++k)
          if (m.nz[(by + (k >> 1)) * 4 + bx + (k & 1)]) return true;
        return false;
      }
      return m.nz[b] != 0;
    };
    if (nz(mp, bp) || nz(mq, bq)) return 2;
    int p8 = ((bp >> 3) << 1) | ((bp & 3) >> 1), q8 = ((bq >> 3) << 1) | ((bq & 3) >> 1);
    int pr[2] = {mp.ref[0][p8] >= 0 ? mp.dbk[0][p8] : -1, mp.ref[1][p8] >= 0 ? mp.dbk[1][p8] : -1};
    int qr[2] = {mq.ref[0][q8] >= 0 ? mq.dbk[0][q8] : -1, mq.ref[1][q8] >= 0 ? mq.dbk[1][q8] : -1};
    int np = (pr[0] >= 0) + (pr[1] >= 0), nq = (qr[0] >= 0) + (qr[1] >= 0);
    if (np != nq) return 1;
    auto far = [](const int16_t* a, const int16_t* b) {
      return std::abs(a[0] - b[0]) >= 4 || std::abs(a[1] - b[1]) >= 4;
    };
    if (np == 1) {
      int lp = pr[0] >= 0 ? 0 : 1, lq = qr[0] >= 0 ? 0 : 1;
      if (pr[lp] != qr[lq]) return 1;
      return far(mp.mv[lp][bp], mq.mv[lq][bq]) ? 1 : 0;
    }
    // Two motion vectors each.
    bool same_set = (pr[0] == qr[0] && pr[1] == qr[1]) || (pr[0] == qr[1] && pr[1] == qr[0]);
    if (!same_set) return 1;
    if (pr[0] != pr[1]) {
      if (pr[0] == qr[0])
        return (far(mp.mv[0][bp], mq.mv[0][bq]) || far(mp.mv[1][bp], mq.mv[1][bq])) ? 1 : 0;
      return (far(mp.mv[0][bp], mq.mv[1][bq]) || far(mp.mv[1][bp], mq.mv[0][bq])) ? 1 : 0;
    }
    bool straight = far(mp.mv[0][bp], mq.mv[0][bq]) || far(mp.mv[1][bp], mq.mv[1][bq]);
    bool crossed = far(mp.mv[0][bp], mq.mv[1][bq]) || far(mp.mv[1][bp], mq.mv[0][bq]);
    return (straight && crossed) ? 1 : 0;
  }

  // Filters one line of samples across an edge (8.7.2.3-4): p[-k * step]
  // are p0..p3, p[k * step] q0..q3.
  // alpha, beta and tc0 are scaled to the bit depth (8.7.2.2: times 2^(depth − 8)).
  template <class P>
  void filter_line(P* s, int step, int bs, int alpha, int beta, int tc0, bool chroma) const {
    int p0 = s[-step], p1 = s[-2 * step], q0 = s[0], q1 = s[step];
    if (!(std::abs(p0 - q0) < alpha && std::abs(p1 - p0) < beta && std::abs(q1 - q0) < beta)) return;
    if (bs < 4) {
      int tc;
      int p2 = 0, q2 = 0, ap = 0, aq = 0;
      if (chroma) {
        tc = tc0 + 1;
      } else {
        p2 = s[-3 * step];
        q2 = s[2 * step];
        ap = std::abs(p2 - p0);
        aq = std::abs(q2 - q0);
        tc = tc0 + (ap < beta) + (aq < beta);
      }
      int delta = clip3(-tc, tc, ((q0 - p0) * 4 + (p1 - q1) + 4) >> 3);
      s[-step] = clipp(p0 + delta);
      s[0] = clipp(q0 - delta);
      if (!chroma) {
        if (ap < beta) s[-2 * step] = P(p1 + clip3(-tc0, tc0, (p2 + ((p0 + q0 + 1) >> 1) - (p1 << 1)) >> 1));
        if (aq < beta) s[step] = P(q1 + clip3(-tc0, tc0, (q2 + ((p0 + q0 + 1) >> 1) - (q1 << 1)) >> 1));
      }
      return;
    }
    if (chroma) {
      s[-step] = P((2 * p1 + p0 + q1 + 2) >> 2);
      s[0] = P((2 * q1 + q0 + p1 + 2) >> 2);
      return;
    }
    int p2 = s[-3 * step], q2 = s[2 * step], p3 = s[-4 * step], q3 = s[3 * step];
    int ap = std::abs(p2 - p0), aq = std::abs(q2 - q0);
    bool strong = std::abs(p0 - q0) < ((alpha >> 2) + 2);
    if (ap < beta && strong) {
      s[-step] = P((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3);
      s[-2 * step] = P((p2 + p1 + p0 + q0 + 2) >> 2);
      s[-3 * step] = P((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3);
    } else {
      s[-step] = P((2 * p1 + p0 + q1 + 2) >> 2);
    }
    if (aq < beta && strong) {
      s[0] = P((p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3);
      s[step] = P((p0 + q0 + q1 + q2 + 2) >> 2);
      s[2 * step] = P((2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3);
    } else {
      s[0] = P((2 * q1 + q0 + p1 + 2) >> 2);
    }
  }

  template <class P>
  void deblock_picture() {
    std::vector<MbInfo>& M = cur->mbs;
    const int sc = 1 << (depth - 8);
    const int W = cur->w, CW = cur->cw;
    // The deblocking parameters of each slice (from its header).
    for (int addr = 0; addr < mb_w * mb_h; ++addr) {
      const MbInfo& q = M[size_t(addr)];
      const SliceParams& sp = slice_params[size_t(q.slice)];
      if (sp.idc == 1) continue;
      int x = addr % mb_w, y = addr / mb_w;
      for (int dir = 0; dir < 2; ++dir) {            // 0 vertical edges, 1 horizontal
        for (int e = 0; e < 4; ++e) {
          bool mb_edge = e == 0;
          const MbInfo* p;
          if (mb_edge) {
            if (dir == 0 ? x == 0 : y == 0) continue;
            p = &M[size_t(dir == 0 ? addr - 1 : addr - mb_w)];
            if (sp.idc == 2 && p->slice != q.slice) continue;
          } else {
            p = &q;
          }
          // Luma skips the 4x4 edges inside an 8x8 transform; chroma
          // filters its own 4-sample edges: at luma edges 0 and 2 but
          // for 4:2:2's horizontal ones (chroma rows 0, 4, 8, 12); 4:4:4's
          // chroma is filtered as luma (chromaStyleFilteringFlag 0).
          bool luma = mb_edge || !(q.t8x8 && (e & 1));
          bool chroma = cfi == 3 ? luma
                                 : cfi != 0 && ((e & 1) == 0 || (cfi == 2 && dir == 1));
          if (!luma && !chroma) continue;
          int bs[4];
          bool any = false;
          for (int k = 0; k < 4; ++k) {
            int bq = dir == 0 ? k * 4 + e : e * 4 + k;
            int bp = mb_edge ? (dir == 0 ? k * 4 + 3 : 12 + k) : (dir == 0 ? bq - 1 : bq - 4);
            bs[k] = bs_of(*p, bp, q, bq, mb_edge);
            any |= bs[k] > 0;
          }
          if (!any) continue;
          if (luma) {
            int qpav = (p->qp + q.qp + 1) >> 1;
            int ia = clip3(0, 51, qpav + sp.alpha), ib = clip3(0, 51, qpav + sp.beta);
            int alpha = kAlpha[ia] * sc, beta = kBeta[ib] * sc;
            for (int k = 0; k < 16; ++k) {
              int b = bs[k >> 2];
              if (!b) continue;
              int px = x * 16 + (dir == 0 ? e * 4 : k), py = y * 16 + (dir == 0 ? k : e * 4);
              filter_line(ypix<P>(px, py), dir == 0 ? 1 : W, b, alpha, beta,
                          b < 4 ? kTc0[ia][b - 1] * sc : 0, false);
            }
          }
          if (!chroma) continue;
          for (int c = 0; c < 2; ++c) {
            int qpav = (p->qpc[c] + q.qpc[c] + 1) >> 1;
            int ia = clip3(0, 51, qpav + sp.alpha), ib = clip3(0, 51, qpav + sp.beta);
            int alpha = kAlpha[ia] * sc, beta = kBeta[ib] * sc;
            int lines = dir == 0 ? mbhc : mbwc;
            for (int k = 0; k < lines; ++k) {
              int b = bs[k * 4 / lines];
              if (!b) continue;
              int px = x * mbwc + (dir == 0 ? e * (mbwc / 4) : k);
              int py = y * mbhc + (dir == 0 ? k : e * (mbhc / 4));
              filter_line(cpix<P>(c, px, py), dir == 0 ? 1 : CW, b, alpha, beta,
                          b < 4 ? kTc0[ia][b - 1] * sc : 0, cfi != 3);
            }
          }
        }
      }
    }
  }

  // Each slice's deblocking parameters, by slice number.
  struct SliceParams {
    int idc, alpha, beta;
  };
  std::vector<SliceParams> slice_params;
};

// The SPS's max_num_reorder_frames as libavcodec holds it: the VUI's,
// else (with references) inferred from the level's MaxDpbMbs
// (h264_ps.c), capped at 15.
int H264Decoder::num_reorder_frames() const {
  const Sps* q = nullptr;
  for (const Sps& c : s_->sps_table)
    if (c.valid && !q) q = &c;
  if (s_->cur || s_->mb_w) q = &s_->sps;
  if (!q) return 0;
  if (q->bitstream_restriction || !q->max_num_ref_frames) return q->num_reorder_frames;
  static const int kMaxDpbMbs[16][2] = {
      {10, 396}, {11, 900}, {12, 2376}, {13, 2376}, {20, 2376}, {21, 4752},
      {22, 8100}, {30, 8100}, {31, 18000}, {32, 20480}, {40, 32768}, {41, 32768},
      {42, 34816}, {50, 110400}, {51, 184320}, {52, 184320}};
  int n = kMaxDelayed - 1;
  for (const auto& l : kMaxDpbMbs)
    if (l[0] == q->level) {
      n = std::min(l[1] / (q->mb_w * q->mb_h), n);
      break;
    }
  return n;
}

// The cropped picture size of the active (else the first) SPS.
bool H264Decoder::picture_size(int& w, int& h) const {
  const Sps* q = nullptr;
  for (const Sps& c : s_->sps_table)
    if (c.valid && !q) q = &c;
  if (s_->cur || s_->mb_w) q = &s_->sps;
  if (!q) return false;
  w = q->mb_w * 16 - q->crop_ux * (q->crop_l + q->crop_r);
  h = q->mb_h * 16 - q->crop_uy * (q->crop_t + q->crop_b);
  return true;
}

bool H264Decoder::frame_rate(int64_t& num, int64_t& den) const {
  const Sps* q = nullptr;
  for (const Sps& c : s_->sps_table)
    if (c.valid && !q) q = &c;
  if (s_->cur || s_->mb_w) q = &s_->sps;
  if (!q || !q->time_scale) return false;
  num = q->time_scale;
  den = int64_t(q->num_units_in_tick) * 2;
  return true;
}

int H264Decoder::delay() const { return s_->has_b_frames; }
void H264Decoder::set_delay(int delay) { s_->has_b_frames = std::min(std::max(delay, 0), kMaxDelayed); }
void H264Decoder::headers_only() { s_->headers_only = true; }
bool H264Decoder::step(const uint8_t* data, size_t n) {
  bool out = s_->step(data, n);
  s_->next_output.reset();
  return out;
}
bool H264Decoder::guesses_delay() const { return s_->guesses_delay; }

H264Decoder::H264Decoder(const std::vector<uint8_t>& config) : s_(new State()) {
  if (config.empty()) return;
  if (config[0] == 1) s_->read_avcc(config);
  else headers(config.data(), config.size());   // Annex B parameter sets
}
H264Decoder::~H264Decoder() = default;

bool H264Decoder::decode(const uint8_t* data, size_t n, Picture& out) {
  return s_->decode(data, n, out);
}

bool H264Decoder::flush(Picture& out) { return s_->flush(out); }

void H264Decoder::headers(const uint8_t* data, size_t n) {
  s_->for_each_nal(data, n, [&](const uint8_t* u, size_t len) { s_->parameter_set(u, len); });
}

int H264Decoder::peek(const uint8_t* data, size_t n) {
  int kind = -1;
  s_->for_each_nal(data, n, [&](const uint8_t* u, size_t) {
    int t = u[0] & 31;
    if (t == 5) kind = 0;
    else if (t == 1 && kind < 0) kind = 1;
  });
  return kind;
}

}  // namespace viai_video
