// Compressed video reader of viai_tpu_torch: the containers, the MJPEG
// decoder and the frame path of `viai_tpu/data/av.py::_load_frames_video`
// (viai_tpu_torch/native.py binds it; mpeg4.cpp decodes MPEG-4 Part 2,
// mpeg12.cpp MPEG-1/2, vp8.cpp VP8, vp9.cpp VP9, h264.cpp H.264,
// hevc.cpp HEVC, rawvideo.cpp uncompressed video, ffv1.cpp FFV1,
// utvideo.cpp UT Video, huffyuv.cpp HuffYUV and FFVHuff, msmpeg4.cpp the
// H.263 family, h261.cpp H.261, magicyuv.cpp MagicYUV, asv.cpp ASV1 and
// ASV2, snow.cpp Snow; PNG pictures through imagedec.cpp's reader,
// png.h).
//
// The JAX package reads `.mp4/.avi/.mkv/.webm` clips with cv2, whose
// FFmpeg backend demuxes with libavformat, decodes with libavcodec and
// converts each picture to BGR24 with swscale (SWS_BICUBIC, same size).
// This file gives the same bytes without them:
//
//   * demuxers: AVI (the `##dc`/`##db` chunks of the first video stream
//     through its OpenDML indx super-index and ix## indexes, else idx1,
//     else a scan of the movi lists, the `RIFF AVIX` extensions'
//     included), ISO-BMFF (.mp4/.mov: the first `vide` track's sample
//     tables, an edit list of one edit as libavformat's mov_fix_index
//     applies it: the samples from the keyframe before the edit on, the
//     frames presented outside it decoded and dropped; then its movie
//     fragments' samples, moof/traf/tfhd/tfdt/trun with mvex's trex
//     defaults) and Matroska/WebM (EBML,
//     unknown-size elements, SimpleBlock and BlockGroup with Xiph, EBML
//     and fixed lacing; VP8 and VP9 in MP4 under their vp08/vp09 sample
//     entries and vpcC boxes; H.264 under avc1/avc3 with its avcC box,
//     V_MPEG4/ISO/AVC with its avcC CodecPrivate, and Annex B in AVI;
//     HEVC under hvc1/hev1 with its hvcC box, V_MPEGH/ISO/HEVC with its
//     hvcC CodecPrivate, and Annex B in AVI under HEVC or H265;
//     uncompressed video by its fourcc: an AVI's strf compression, bit
//     count, height sign and colour table, a Matroska V_UNCOMPRESSED
//     track's ColourSpace; the lossless codecs by their fourcc, an AVI
//     strf's tail or a Matroska V_MS/VFW/FOURCC CodecPrivate after its
//     BITMAPINFOHEADER as their extradata, V_FFV1 with its configuration
//     record; MagicYUV, ASV1/ASV2 and Snow by their fourcc, Snow as
//     Matroska's V_SNOW too).
//     Each gives the track's packets in decode order, byte for byte as
//     libavformat gives them (H.264 and HEVC in MP4 and Matroska before
//     cv2's h264_mp4toannexb and hevc_mp4toannexb), the frame count
//     that cv2's CAP_PROP_FRAME_COUNT reports: AVI strh dwLength, MP4 the
//     sample
//     count (of a fragmented file without samples in moov, round(duration
//     · fps) over its streams' spans, see mp4_count), Matroska
//     round(duration · fps) with libavformat's duration and av_reduce'd
//     DefaultDuration (without it, libavformat's estimate from the block
//     times, see rfps_estimate); and the orientation cv2 reports
//     (CAP_PROP_ORIENTATION_META) from MP4's display matrices (tkhd's
//     times mvhd's) or a Matroska Projection's roll, by which the frames
//     are turned as cv2 turns them (90, 180 or 270 degrees). Other
//     tracks (sound, ...) are skipped.
//   * MJPEG: imagedec.cpp's entropy decoder (annex K tables until a DHT,
//     the AVI1 convention), ffmpeg's simple IDCT into the planes of the
//     layout libavcodec picks (yuvj420p, yuvj422p, yuvj444p, yuvj440p,
//     gray; limited range under a CS=ITU601 comment).
//   * the conversion to BGR24 that swscale does at the same size: its x86
//     yuv2rgb path for 4:2:0 and 4:2:2 of even height (each chroma sample
//     for its 2×2 or 2×1 pixels, 16-bit fixed-point products (pmulhw) of
//     the matrix's coefficients, full range for yuvj, limited else,
//     saturated to 0..255), grey copied to B, G, R, and its generic
//     bicubic scaler for the rest (see `sws`).
//   * cv2.rotate of the BGR frame by the track's orientation (see
//     turn_bgr);
//   * cv2.resize(frame, (size, size)) at INTER_LINEAR on the BGR frame:
//     11-bit weights from float32 positions, a horizontal pass in int32,
//     the vertical one as OpenCV's SIMD does it (each row >> 4, ·β >> 16,
//     summed, + 2 >> 2); rows beyond the edge take the edge row, with the
//     unclamped weight (an exact 2× shrink, cv2's INTER_AREA, gives the
//     same bytes).
//   * the frame pick: cv2's count, the float64 window rule, the `set`,
//     the frames found re-picked by the window rule over (0, 1). A
//     frame is a packet that gives a picture: every MJPEG packet, an
//     MPEG-4 packet with a coded VOP, a VP8 packet whose frame tag has
//     show_frame set, a VP9 packet one of whose frames is shown, an
//     uncompressed packet before the first one libavcodec refuses, every
//     FFV1, UT Video, HuffYUV, PNG, MagicYUV, ASV and Snow packet (FFV1
//     decoded from the key frame before the first pick: its context
//     states carry over; Snow from the keyframe before it: its other
//     frames predict from the pictures before them); H.264 frames count
//     in the decoder's output order.
//
// Errors: a broken file gives code 1 (ValueError), a codec, container or
// feature that is not read code 2 (NotImplementedError), naming it.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <initializer_list>
#include <string>
#include <vector>

#include "inflate.h"
#include "jpeg.h"
#include "png.h"
#include "video.h"
#include "window.h"

namespace viai_video {

namespace {

uint32_t le32(const uint8_t* p) {
  return uint32_t(p[0]) | (uint32_t(p[1]) << 8) | (uint32_t(p[2]) << 16) |
         (uint32_t(p[3]) << 24);
}
uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}
uint64_t be64(const uint8_t* p) {
  return (uint64_t(be32(p)) << 32) | be32(p + 4);
}

std::string fourcc_str(uint32_t le) {
  std::string s;
  for (int i = 0; i < 4; ++i) {
    char c = char((le >> (8 * i)) & 0xFF);
    s += (c >= 32 && c < 127) ? c : '?';
  }
  return s;
}

std::string upper(std::string s) {
  for (char& c : s)
    if (c >= 'a' && c <= 'z') c = char(c - 'a' + 'A');
  return s;
}

std::vector<uint8_t> read_file(const std::string& path) {
  FILE* f = std::fopen(path.c_str(), "rb");
  if (!f) broken(path + ": cannot open");
  std::vector<uint8_t> out;
  uint8_t chunk[1 << 16];
  size_t got;
  while ((got = std::fread(chunk, 1, sizeof(chunk), f)) > 0)
    out.insert(out.end(), chunk, chunk + got);
  bool err = std::ferror(f);
  std::fclose(f);
  if (err) broken(path + ": cannot read");
  return out;
}

}  // namespace

// =====================================================================
// Containers
// =====================================================================

enum class Codec {
  kMjpeg, kMpeg4, kVp8, kVp9, kH264, kMpeg12, kRaw, kHevc, kFfv1, kUtvideo,
  kHuffyuv, kPng, kH263, kH261, kMagicyuv, kAsv, kSnow, kOther
};

struct Packet {
  size_t off = 0;
  uint32_t size = 0;
  bool key = false;
  bool discard = false;   // decoded, its picture dropped (an MP4 edit)
};

struct Track {
  std::vector<uint8_t> file;
  Codec codec = Codec::kOther;
  std::string tag;              // fourcc or CodecID, for messages
  std::string container;
  int width = 0, height = 0;    // as the container gives them
  std::vector<uint8_t> config;  // MPEG-4 and MPEG-1/2 headers (esds,
                                // CodecPrivate, strf); H.264's avcC record
  std::vector<Packet> packets;
  int64_t count = 0;            // cv2's CAP_PROP_FRAME_COUNT
  // cv2's CAP_PROP_ORIENTATION_META: the clockwise turn, 0..359, of the
  // container's display matrix; cv2 turns the picture when it is 90,
  // 180 or 270 (CAP_PROP_ORIENTATION_AUTO, on by default).
  int orientation = 0;
  // H.264 in MP4: the reorder depth libavformat's demuxer guesses from
  // the composition times (AVCodecParameters.video_delay), else 0.
  int video_delay = 0;
  // Uncompressed video (kRaw): the layout's fourcc (AVI strf's
  // compression, 0 for BI_RGB; a Matroska track's ColourSpace, which
  // `raw_tagged` says it has), strf's bit count, whether a BI_RGB DIB is
  // bottom-up (a positive height) and strf's extradata as libavformat
  // takes it (the chunk after its first 40 bytes: pal8's colour table;
  // FFV1's configuration record, HuffYUV's tables, UT Video's 16 bytes;
  // a Matroska V_MS/VFW/FOURCC CodecPrivate after its 40 bytes, a V_FFV1
  // CodecPrivate whole).
  uint32_t raw_tag = 0;
  bool raw_tagged = false;
  int bits = 0;
  bool bottom_up = false;
  std::vector<uint8_t> extradata;
  // MP4: a track run without its data offset after another in one track
  // fragment, whose samples libavformat reads from the fragment's base
  // again (the packets are those bytes; decoding raises).
  bool rebased_runs = false;
};

namespace {

// libavutil's av_display_rotation_get over a display matrix (a, b, u,
// c, d, v, x, y, w; 16.16 but u, v, w), then OpenCV's angle: its
// negation rounded (cvRound, half to even) into 0..359. A matrix with a
// mirror (cv2 would turn the picture instead: a horizontal mirror by 180
// degrees, the transpose by 90) or a zero column (no angle) raises.
int cv2_orientation(const int32_t m[9], const std::string& where) {
  const double kPi = 3.14159265358979323846;
  if (int64_t(m[0]) * m[4] - int64_t(m[1]) * m[3] < 0)
    unsupported(where + " display matrix with a mirror (cv2 would turn "
                "the picture instead of mirroring it)");
  auto fp = [](int32_t x) { return double(x) / 65536.0; };
  double s0 = std::hypot(fp(m[0]), fp(m[3]));
  double s1 = std::hypot(fp(m[1]), fp(m[4]));
  if (s0 == 0.0 || s1 == 0.0)
    unsupported(where + " display matrix with a zero column (no angle)");
  double r = -(std::atan2(fp(m[1]) / s1, fp(m[0]) / s0) * 180 / kPi);
  int angle = -int(std::nearbyint(r));
  return angle < 0 ? angle + 360 : angle;
}

// libavformat's QuickTime tags of MPEG-1 and MPEG-2 video (isom.c's
// ff_codec_movvideo_tags: HDV, XDCAM, IMX ...), which its MP4 demuxer
// reads as sample entries and its AVI demuxer after the riff tags.
bool mov_mpeg12(const std::string& tag) {
  static const char* kTags[] = {
      "m1v1", "m1v ", "mp1v", "mpeg", "m2v1", "mp2v", "mmes", "AVmp",
      "hdv1", "hdv2", "hdv3", "hdv4", "hdv5", "hdv6", "hdv7", "hdv8",
      "hdv9", "hdva", "mx5n", "mx5p", "mx4n", "mx4p", "mx3n", "mx3p",
      "xd51", "xd54", "xd55", "xd59", "xd5a", "xd5b", "xd5c", "xd5d",
      "xd5e", "xd5f", "xdv1", "xdv2", "xdv3", "xdv4", "xdv5", "xdv6",
      "xdv7", "xdv8", "xdv9", "xdva", "xdvb", "xdvc", "xdvd", "xdve",
      "xdvf", "xdhd", "xdh2"};
  for (const char* t : kTags)
    if (tag == t) return true;
  return false;
}

// libavformat's riff tags (upper-cased, as its AVI demuxer retries) and
// the codecs they name.
Codec riff_codec(const std::string& tag) {
  static const char* kMjpeg[] = {
      "MJPG", "AVRN", "JPGL", "DMB1", "MJPA", "JPEG", "LJPG", "IJPG", "ACDV",
      "QIVG", "SLMJ", "CJPG", "IJLV", "MVJP", "AVI1", "AVI2", "ZJPG", "MJLS",
      "MMJP"};
  static const char* kMpeg4[] = {
      "FMP4", "DIVX", "DX50", "XVID", "MP4V", "MP4S", "M4S2", "3IV2", "RMP4",
      "UMP4", "SMP4", "DXGM", "FVFW", "FFDS", "DCOD", "WV1F", "SEDG", "XVIX",
      "BLZ0", "GEOV", "SIPP", "ZMP4", "DM4V", "EPHV", "M4CC", "VIDM"};
  std::string u = upper(tag);
  for (const char* t : kMjpeg)
    if (u == t) return Codec::kMjpeg;
  for (const char* t : kMpeg4)
    if (u == t) return Codec::kMpeg4;
  if (u == "VP80") return Codec::kVp8;
  if (u == "VP90") return Codec::kVp9;
  static const char* kH264[] = {"H264", "X264", "AVC1", "DAVC", "SMV2",
                                "VSSH", "Q264", "V264", "GAVC", "UMSV",
                                "TSHD", "INMC", "AI55"};
  for (const char* t : kH264)
    if (u == t) return Codec::kH264;
  if (u == "HEVC" || u == "H265") return Codec::kHevc;
  // The lossless intra codecs (ff_codec_bmp_tags): FFV1, HuffYUV and
  // FFVHuff, UT Video (its 10-bit UQ** and pack-mode UM** tags too, which
  // the decoder raises for by name), PNG.
  if (u == "FFV1") return Codec::kFfv1;
  if (u == "HFYU" || u == "FFVH") return Codec::kHuffyuv;
  static const char* kUt[] = {"ULRA", "ULRG", "ULY0", "ULY2", "ULY4",
                              "ULH0", "ULH2", "ULH4", "UQY0", "UQY2",
                              "UQRA", "UQRG", "UMY2", "UMH2", "UMY4",
                              "UMH4", "UMRG", "UMRA"};
  for (const char* t : kUt)
    if (u == t) return Codec::kUtvideo;
  if (u == "MPNG" || u == "PNG1" || u == "PNG ") return Codec::kPng;
  // MPEG-1 and MPEG-2 video (libavformat's ff_codec_bmp_tags; VCR2 and
  // SLIF, which libavcodec decodes with their own quirks, are not read).
  static const char* kMpeg12[] = {"MPG1", "MPG2", "MPEG", "PIM1", "PIM2",
                                  "MPGV", "EM2V", "MMES", "LMP2", "DVR ",
                                  "BW10", "XMPG", "M701", "M702", "M703",
                                  "M704", "M705"};
  for (const char* t : kMpeg12)
    if (u == t) return Codec::kMpeg12;
  if (mov_mpeg12(tag)) return Codec::kMpeg12;
  // The H.263 family: FLV1, MS-MPEG4 v2 and v3, WMV1, WMV2, ITU H.263 and
  // H.263+ (MS-MPEG4 v1's tags, which are not read, stay kOther).
  if (H263Decoder::variant(tag) > 0) return Codec::kH263;
  if (u == "H261") return Codec::kH261;
  // MagicYUV (every tag libavformat maps to it), ASUS ASV1/ASV2, Snow.
  static const char* kMagy[] = {"MAGY", "M8RG", "M8RA", "M8G0", "M8Y0",
                                "M8Y2", "M8Y4", "M8YA", "M0RA", "M0RG",
                                "M0G0", "M0Y0", "M0Y2", "M0Y4", "M2RA",
                                "M2RG"};
  for (const char* t : kMagy)
    if (u == t) return Codec::kMagicyuv;
  if (u == "ASV1" || u == "ASV2") return Codec::kAsv;
  if (u == "SNOW") return Codec::kSnow;
  return Codec::kOther;
}

// ---------------------------------------------------------------- AVI

// An OpenDML index chunk's body at `p` (libavformat's read_odml_index):
// a standard index (bIndexType 1) gives the packets, each at its
// qwBaseOffset + dwOffset, keyframes where bit 31 of dwSize is clear; a
// super-index (bIndexType 0) the standard indexes it points to, in turn.
void read_odml_index(Track& t, size_t p, size_t end, int depth) {
  const std::vector<uint8_t>& f = t.file;
  if (depth > 4) broken("AVI OpenDML indexes nested too deeply");
  if (p + 24 > end) broken("AVI OpenDML index cut short");
  int longs = f[p] | (f[p + 1] << 8);
  int sub = f[p + 2], type = f[p + 3];
  uint32_t entries = le32(&f[p + 4]);
  uint64_t base = uint64_t(le32(&f[p + 12])) |
                  (uint64_t(le32(&f[p + 16])) << 32);
  if (sub != 0 || type > 1 || (type == 1 && longs != 2))
    broken("AVI OpenDML index of an unknown kind");
  size_t w = type == 1 ? 8 : 16;
  if (p + 24 + w * size_t(entries) > end) broken("AVI OpenDML index cut short");
  for (uint32_t e = 0; e < entries; ++e) {
    const uint8_t* q = &f[p + 24 + w * e];
    if (type == 1) {
      uint32_t size = le32(q + 4);
      uint64_t at = base + le32(q);
      size &= 0x7FFFFFFF;
      if (at < 8 || at + size > f.size())
        broken("AVI OpenDML index points past the file");
      if (size) t.packets.push_back({size_t(at), size, !(le32(q + 4) >> 31)});
    } else {
      uint64_t at = uint64_t(le32(q)) | (uint64_t(le32(q + 4)) << 32);
      if (at + 8 > f.size())
        broken("AVI OpenDML super-index points past the file");
      size_t sz = le32(&f[size_t(at) + 4]);
      read_odml_index(t, size_t(at) + 8,
                      std::min(f.size(), size_t(at) + 8 + sz), depth + 1);
    }
  }
}

void demux_avi(Track& t) {
  const std::vector<uint8_t>& f = t.file;
  const size_t n = f.size();
  if (n < 12 || std::memcmp(f.data(), "RIFF", 4) != 0 ||
      std::memcmp(f.data() + 8, "AVI ", 4) != 0)
    broken("not an AVI file");
  t.container = "AVI";
  int stream = -1, nstreams = 0;
  size_t idx1 = 0, idx1_size = 0, indx = 0, indx_end = 0;
  bool have_idx1 = false;
  // The movi lists: the first RIFF's, then those of its OpenDML `RIFF
  // AVIX` extensions.
  std::vector<std::pair<size_t, size_t>> movis;
  // Walk the RIFF tree: hdrl's stream lists, movi, idx1, AVIX.
  std::vector<std::pair<size_t, size_t>> stack = {{12, n}};
  while (!stack.empty()) {
    auto [p, end] = stack.back();
    stack.pop_back();
    while (p + 8 <= end) {
      uint32_t id = le32(&f[p]);
      size_t sz = le32(&f[p + 4]);
      size_t body = p + 8;
      size_t next = body + sz + (sz & 1);
      if (body + sz > n) sz = n - body;   // a file cut short
      std::string tag = fourcc_str(id);
      if (tag == "LIST" && sz >= 4) {
        std::string kind = fourcc_str(le32(&f[body]));
        if (kind == "movi") {
          movis.push_back({body, body + sz});
        } else if (kind == "hdrl" || kind == "strl") {
          if (kind == "strl") ++nstreams;
          stack.push_back({next, end});
          end = body + sz;
          p = body + 4;
          continue;
        }
      } else if (tag == "RIFF" && sz >= 4 &&
                 fourcc_str(le32(&f[body])) == "AVIX") {
        stack.push_back({next, end});
        end = body + sz;
        p = body + 4;
        continue;
      } else if (tag == "indx" && stream == nstreams - 1 && stream >= 0 &&
                 !indx) {
        indx = body;
        indx_end = body + sz;
      } else if (tag == "strh" && sz >= 36 && stream < 0) {
        if (fourcc_str(le32(&f[body])) == "vids") {
          stream = nstreams - 1;
          t.count = le32(&f[body + 32]);      // dwLength, as cv2 counts
        }
      } else if (tag == "strf" && stream == nstreams - 1 && stream >= 0 &&
                 t.tag.empty()) {
        if (sz < 40) broken("AVI video format (strf) cut short");
        t.width = int32_t(le32(&f[body + 4]));
        const int32_t height = int32_t(le32(&f[body + 8]));
        t.height = std::abs(height);
        uint32_t comp = le32(&f[body + 16]);
        t.tag = fourcc_str(comp);
        if (comp <= 3) {
          static const char* kDib[] = {"BI_RGB", "BI_RLE8", "BI_RLE4",
                                       "BI_BITFIELDS"};
          t.tag = kDib[comp];
        }
        t.raw_tag = comp;
        t.raw_tagged = true;
        t.bits = f[body + 14] | (f[body + 15] << 8);
        // libavformat flips a BI_RGB DIB of positive height ("BottomUp").
        t.bottom_up = comp == 0 && height > 0;
        // Its extradata: the chunk after 40 bytes (biSize less 40 where
        // biSize is odd and one short of the chunk).
        const size_t esize = le32(&f[body]);
        const size_t ext = esize == sz - 1 && (esize & 1) ? esize - 40
                                                          : sz - 40;
        t.extradata.assign(f.begin() + body + 40, f.begin() + body + 40 + ext);
        size_t bisize = std::min<size_t>(le32(&f[body]), sz);
        if (bisize > 40 && bisize <= sz)
          t.config.assign(f.begin() + body + 40, f.begin() + body + bisize);
        else if (sz > 40)
          t.config.assign(f.begin() + body + 40, f.begin() + body + sz);
      } else if (tag == "idx1" && !have_idx1) {
        idx1 = body;
        idx1_size = sz;
        have_idx1 = true;
      }
      p = next;
    }
  }
  if (stream < 0 || t.tag.empty()) broken("AVI file without a video stream");
  if (movis.empty()) broken("AVI file without a movi list");
  std::sort(movis.begin(), movis.end());
  t.codec = riff_codec(t.tag);
  if (t.codec == Codec::kOther && RawDecoder::avi_raw(t.raw_tag))
    t.codec = Codec::kRaw;
  char id[3];
  std::snprintf(id, sizeof(id), "%02d", stream % 100);
  auto ours = [&](const uint8_t* ck) {
    return ck[0] == uint8_t(id[0]) && ck[1] == uint8_t(id[1]) &&
           ck[2] == 'd' && (ck[3] == 'c' || ck[3] == 'b');
  };
  if (indx) {
    // OpenDML: the stream's index, as libavformat reads it first.
    read_odml_index(t, indx, indx_end, 0);
  } else if (have_idx1 && idx1_size >= 16) {
    size_t entries = idx1_size / 16;
    // Offsets count from the 'movi' fourcc, or from the file's start
    // where the first one lies past it.
    size_t movi = movis[0].first;
    size_t base = le32(&f[idx1 + 8]) < movi ? movi : 0;
    for (size_t e = 0; e < entries; ++e) {
      const uint8_t* ent = &f[idx1 + 16 * e];
      if (!ours(ent)) continue;
      size_t ck = base + le32(ent + 8);
      uint32_t size = le32(ent + 12);
      if (ck + 8 + size > n) broken("AVI index points past the file");
      if (size == 0) continue;
      t.packets.push_back({ck + 8, size, (le32(ent + 4) & 0x10) != 0});
    }
  } else {
    std::vector<std::pair<size_t, size_t>> lists;
    for (auto it = movis.rbegin(); it != movis.rend(); ++it)
      lists.push_back({it->first + 4, it->second});
    while (!lists.empty()) {
      auto [p, end] = lists.back();
      lists.pop_back();
      while (p + 8 <= end) {
        uint32_t sz = le32(&f[p + 4]);
        if (std::memcmp(&f[p], "LIST", 4) == 0 && sz >= 4) {
          lists.push_back({p + 8 + sz + (sz & 1), end});
          end = p + 8 + sz;
          p += 12;
          continue;
        }
        if (ours(&f[p]) && sz > 0) {
          if (p + 8 + sz > n) broken("AVI chunk runs past the file");
          t.packets.push_back({p + 8, sz, t.packets.empty()});
        }
        p += 8 + sz + (sz & 1);
      }
    }
  }
}

// ---------------------------------------------------------------- MP4

int64_t gcd64(int64_t a, int64_t b) {
  while (b) {
    int64_t t = a % b;
    a = b;
    b = t;
  }
  return a;
}

// libavutil's av_reduce: the closest num/den with both at most `max`.
void av_reduce(int64_t& dn, int64_t& dd, int64_t num, int64_t den,
               int64_t max) {
  int64_t a0n = 0, a0d = 1, a1n = 1, a1d = 0;
  int64_t g = gcd64(num, den);
  if (g) {
    num /= g;
    den /= g;
  }
  if (num <= max && den <= max) {
    a1n = num;
    a1d = den;
    den = 0;
  }
  while (den) {
    uint64_t x = uint64_t(num / den);
    int64_t next_den = num - den * int64_t(x);
    int64_t a2n = int64_t(x) * a1n + a0n, a2d = int64_t(x) * a1d + a0d;
    if (a2n > max || a2d > max) {
      if (a1n) x = uint64_t((max - a0n) / a1n);
      if (a1d) x = std::min<uint64_t>(x, uint64_t((max - a0d) / a1d));
      if (den * (2 * int64_t(x) * a1d + a0d) > num * a1d) {
        a1n = int64_t(x) * a1n + a0n;
        a1d = int64_t(x) * a1d + a0d;
      }
      break;
    }
    a0n = a1n;
    a0d = a1d;
    a1n = a2n;
    a1d = a2d;
    num = den;
    den = next_den;
  }
  dn = a1n;
  dd = a1d;
}

struct Box {
  size_t body, end;
  std::string type;
  size_t start;                 // its header's first byte
};

// The boxes in [p, end).
std::vector<Box> boxes(const std::vector<uint8_t>& f, size_t p, size_t end) {
  std::vector<Box> out;
  while (p + 8 <= end) {
    uint64_t sz = be32(&f[p]);
    std::string type(reinterpret_cast<const char*>(&f[p + 4]), 4);
    size_t hdr = 8;
    if (sz == 1) {
      if (p + 16 > end) broken("MP4 box header cut short");
      sz = be64(&f[p + 8]);
      hdr = 16;
    } else if (sz == 0) {
      sz = end - p;
    }
    if (sz < hdr || p + sz > end) broken("MP4 box '" + type + "' runs past "
                                         "its parent");
    out.push_back({p + hdr, size_t(p + sz), type, p});
    p += sz;
  }
  return out;
}

const Box* child(const std::vector<Box>& bs, const char* type) {
  for (const Box& b : bs)
    if (b.type == type) return &b;
  return nullptr;
}

// An MPEG-4 descriptor's length (up to four 7-bit groups).
size_t desc_len(const std::vector<uint8_t>& f, size_t& p, size_t end) {
  size_t len = 0;
  for (int i = 0; i < 4; ++i) {
    if (p >= end) broken("MP4 esds descriptor cut short");
    uint8_t b = f[p++];
    len = (len << 7) | (b & 0x7F);
    if (!(b & 0x80)) break;
  }
  return len;
}

// esds → (objectTypeIndication, DecoderSpecificInfo).
void read_esds(Track& t, const Box& esds, int& oti) {
  const std::vector<uint8_t>& f = t.file;
  size_t p = esds.body + 4, end = esds.end;
  while (p < end) {
    uint8_t tag = f[p++];
    size_t len = desc_len(f, p, end);
    size_t body_end = std::min(end, p + len);
    if (tag == 0x03) {                          // ES_Descriptor
      if (p + 3 > body_end) broken("MP4 esds ES descriptor cut short");
      uint8_t flags = f[p + 2];
      p += 3;
      if (flags & 0x80) p += 2;
      if (flags & 0x40) {
        if (p >= body_end) broken("MP4 esds URL cut short");
        p += 1 + f[p];
      }
      if (flags & 0x20) p += 2;
      continue;                                 // its children follow
    }
    if (tag == 0x04) {                          // DecoderConfigDescriptor
      if (p + 13 > body_end) broken("MP4 esds decoder config cut short");
      oti = f[p];
      p += 13;
      continue;
    }
    if (tag == 0x05) {                          // DecoderSpecificInfo
      t.config.assign(f.begin() + p, f.begin() + body_end);
      return;
    }
    p = body_end;
  }
}

// A vp08/vp09 sample entry's vpcC box (VP Codec ISO Media File Format
// Binding, version 1): profile, level, bit depth, chroma subsampling.
void read_vpcc(Track& t, const std::vector<Box>& entry_boxes) {
  const std::vector<uint8_t>& f = t.file;
  const Box* vpcc = child(entry_boxes, "vpcC");
  const char* name = t.tag == "vp08" ? "VP8" : "VP9";
  if (!vpcc || vpcc->body + 8 > vpcc->end)
    broken(std::string("MP4 '") + t.tag + "' sample entry without its vpcC box");
  if (f[vpcc->body] != 1)
    unsupported(std::string("MP4 vpcC box of version ") +
                std::to_string(f[vpcc->body]));
  int profile = f[vpcc->body + 4];
  int depth = f[vpcc->body + 6] >> 4;
  int chroma = (f[vpcc->body + 6] >> 1) & 7;
  // VP9's frames carry their own depth and sampling (all its profiles
  // are read); VP8 has 8-bit 4:2:0 only.
  if (t.tag == "vp08" && (depth != 8 || chroma > 1))
    unsupported(std::string(name) + " profile " + std::to_string(profile) +
                " (" + std::to_string(depth) + "-bit, " +
                (chroma == 2 ? "4:2:2" : chroma == 3 ? "4:4:4" : "4:2:0") +
                "; only 8-bit 4:2:0 is read)");
  t.codec = t.tag == "vp08" ? Codec::kVp8 : Codec::kVp9;
}

// Each sample's decode time (stts) and composition time (plus its ctts
// offset; the decode time without ctts), in the media's timescale.
void sample_times(const std::vector<uint8_t>& f, const std::vector<Box>& sb,
                  size_t n, std::vector<int64_t>& dts,
                  std::vector<int64_t>& cts) {
  const Box* stts = child(sb, "stts");
  const Box* ctts = child(sb, "ctts");
  if (!stts || stts->body + 8 > stts->end)
    broken("MP4 video track without stts");
  uint32_t runs = be32(&f[stts->body + 4]);
  if (stts->body + 8 + 8 * size_t(runs) > stts->end) broken("MP4 stts cut short");
  int64_t t = 0;
  for (uint32_t r = 0; r < runs && dts.size() < n; ++r) {
    uint32_t cnt = be32(&f[stts->body + 8 + 8 * r]);
    uint32_t delta = be32(&f[stts->body + 12 + 8 * r]);
    for (uint32_t k = 0; k < cnt && dts.size() < n; ++k, t += delta)
      dts.push_back(t);
  }
  if (dts.size() < n) broken("MP4 stts shorter than the track");
  cts = dts;
  if (!ctts) return;
  if (ctts->body + 8 > ctts->end) broken("MP4 ctts cut short");
  runs = be32(&f[ctts->body + 4]);
  if (ctts->body + 8 + 8 * size_t(runs) > ctts->end) broken("MP4 ctts cut short");
  size_t i = 0;
  for (uint32_t r = 0; r < runs && i < n; ++r) {
    uint32_t cnt = be32(&f[ctts->body + 8 + 8 * r]);
    int32_t off = int32_t(be32(&f[ctts->body + 12 + 8 * r]));
    for (uint32_t k = 0; k < cnt && i < n; ++k) cts[i++] += off;
  }
  if (i < n) broken("MP4 ctts shorter than the track");
}

// libavformat's mov_estimate_video_delay: each sample's composition
// time (in decode order) sorted into a ring of the last 17 by swaps;
// the most swaps one needs is the reorder depth.
int guess_video_delay(const std::vector<int64_t>& cts) {
  const int kRing = 17;                     // MAX_REORDER_DELAY + 1
  int64_t buf[kRing];
  for (int64_t& v : buf) v = INT64_MIN;
  int start = 0, delay = 0;
  for (int64_t pts : cts) {
    int j = start;
    start = (start + 1) % kRing;
    buf[j] = pts;
    int swaps = 0;
    while (j != start) {
      int r = j == 0 ? kRing - 1 : j - 1;
      if (buf[j] >= buf[r]) break;
      std::swap(buf[j], buf[r]);
      ++swaps;
      j = r;
    }
    delay = std::max(delay, swaps);
  }
  return delay;
}

// A full box's timescale (mvhd, mdhd: after the version's times).
int64_t timescale(const std::vector<uint8_t>& f, const Box* b) {
  if (!b || b->body + 24 > b->end)
    broken("MP4 mvhd or mdhd missing or cut short");
  return be32(&f[b->body + (f[b->body] == 1 ? 20 : 12)]);
}

// A track of an MP4 file as libavformat makes it a stream: what cv2's
// frame count of a fragmented file needs (see mp4_fragments).
struct Mp4Stream {
  uint32_t id = 0;
  std::string handler;          // hdlr's type: vide, soun, ...
  int64_t timescale = 0;        // mdhd's
  int64_t duration = 0;         // mdhd's, then the fragments' end if later
  int64_t moov_samples = 0;     // stts's sample count
  int64_t moov_duration = 0;    // and their duration
  // The edit list's shift of the timestamps (libavformat's time_offset:
  // the media time of the first edit after an empty one, less that
  // empty edit's duration) and AAC's start padding (that media time).
  int64_t time_offset = 0, aac_pad = 0;
  bool aac = false;
  // trex's defaults: sample description, duration, size, flags.
  uint32_t trex[4] = {1, 0, 0, 0};
  // Its fragments' samples: whether any, the first one's decode time and
  // composition offset, the largest negative offset (libavformat's
  // dts_shift), where the next fragment starts without a tfdt, and the
  // sample count and duration (the average frame rate's).
  bool any = false;
  int64_t first_dts = 0, first_cts = 0, dts_shift = 0, next_dts = 0;
  int64_t frames = 0, frames_duration = 0;
  // The chosen track's sample entries (stsd's boxes): where each lies.
  std::vector<std::pair<size_t, size_t>> entries;
};

// The edit list of a trak as libavformat's mov_build_index reads it for
// the timestamps (`s.time_offset`), and for the chosen track also as
// mov_fix_index applies it (`edited`, the one edit's media time and
// duration in the movie's timescale).
void mp4_edits(const std::vector<uint8_t>& f, const std::vector<Box>& tb,
               int64_t movie, Mp4Stream& s, bool& edited, int64_t& edit_time,
               int64_t& edit_duration, bool check) {
  const Box* edts = child(tb, "edts");
  if (!edts) return;
  int64_t empty = 0, start = 0;
  int first_edit = 0, k_all = 0;
  for (const Box& elst : boxes(f, edts->body, edts->end)) {
    if (elst.type != "elst" || elst.body + 8 > elst.end) continue;
    int version = f[elst.body];
    uint32_t entries = be32(&f[elst.body + 4]);
    size_t w = version == 1 ? 20 : 12;
    if (elst.body + 8 + w * entries > elst.end)
      broken("MP4 edit list cut short");
    for (uint32_t k = 0; k < entries; ++k, ++k_all) {
      const uint8_t* e = &f[elst.body + 8 + w * k];
      int64_t duration = version == 1 ? int64_t(be64(e)) : be32(e);
      int64_t media_time = version == 1 ? int64_t(be64(e + 8))
                                        : int32_t(be32(e + 4));
      uint32_t rate = be32(e + (version == 1 ? 16 : 8));
      if (k_all == 0 && media_time == -1) {
        empty = duration;
        first_edit = 1;
      } else if (k_all == first_edit && media_time >= 0) {
        start = media_time;
      }
      if (!check) continue;
      // The edit list, as libavformat reads it (mov_fix_index): an empty
      // edit (media time -1) first only delays presentation; one edit at
      // rate 1 then keeps the samples from the last keyframe presented at
      // or before its media time, marking those presented before it or
      // past its end to be decoded and dropped.
      if (media_time == -1 && k_all == 0) continue;
      if (edited || media_time < 0)
        unsupported("MP4 edit list of several edits (libavformat's "
                    "advanced edit lists)");
      if (rate != 0x10000) {
        char b[96];
        std::snprintf(b, sizeof(b), "MP4 edit at rate %.4f (not 1)",
                      rate / 65536.0);
        unsupported(b);
      }
      if (duration == 0) unsupported("MP4 edit of duration 0");
      edited = true;
      edit_time = media_time;
      edit_duration = duration;
    }
  }
  if ((empty || start) && movie > 0) {
    if (empty) empty = (empty * s.timescale + movie / 2) / movie;
    s.time_offset = start - empty;
    if (s.aac && start > 0 && k_all <= first_edit + 1) s.aac_pad = start;
  }
}

// The frames of the chosen video trak's own sample tables (`tb`, its
// boxes; `mb`, its mdia's) into t.packets, from the keyframe before an
// edit on (see mp4_edits; libavformat applies none to a track whose
// samples all lie in fragments).
void mp4_samples(Track& t, const std::vector<Box>& tb,
                 const std::vector<Box>& mb, int64_t movie, Mp4Stream& st) {
  const std::vector<uint8_t>& f = t.file;
  bool edited = false;
  int64_t edit_time = 0, edit_duration = 0;
  mp4_edits(f, tb, movie, st, edited, edit_time, edit_duration,
            st.moov_samples > 0);
  const Box* minf = child(mb, "minf");
  if (!minf) broken("MP4 video track without minf");
  std::vector<Box> nb = boxes(f, minf->body, minf->end);
  const Box* stbl = child(nb, "stbl");
  if (!stbl) broken("MP4 video track without stbl");
  std::vector<Box> sb = boxes(f, stbl->body, stbl->end);
  const Box* stsd = child(sb, "stsd");
  if (!stsd || stsd->body + 16 > stsd->end)
    broken("MP4 video track without a sample description");
  size_t entry = stsd->body + 8;
  uint32_t esz = be32(&f[entry]);
  if (esz < 86 || entry + esz > stsd->end)
    broken("MP4 visual sample entry cut short");
  for (size_t e = entry; e + 8 <= stsd->end && be32(&f[e]) >= 8;
       e += be32(&f[e]))
    st.entries.push_back({e, std::min<size_t>(e + be32(&f[e]), stsd->end)});
  t.tag = fourcc_str(le32(&f[entry + 4]));
  t.width = (f[entry + 32] << 8) | f[entry + 33];
  t.height = (f[entry + 34] << 8) | f[entry + 35];
  if (t.tag == "jpeg" || t.tag == "mjpa" || t.tag == "MJPG") {
    t.codec = Codec::kMjpeg;
  } else if (t.tag == "avc1" || t.tag == "avc3") {
    std::vector<Box> eb = boxes(f, entry + 86, entry + esz);
    const Box* avcc = child(eb, "avcC");
    if (!avcc) broken("MP4 '" + t.tag + "' sample entry without its avcC box");
    t.config.assign(f.begin() + avcc->body, f.begin() + avcc->end);
    t.codec = Codec::kH264;
  } else if (t.tag == "hvc1" || t.tag == "hev1") {
    std::vector<Box> eb = boxes(f, entry + 86, entry + esz);
    const Box* hvcc = child(eb, "hvcC");
    if (!hvcc) broken("MP4 '" + t.tag + "' sample entry without its hvcC box");
    t.config.assign(f.begin() + hvcc->body, f.begin() + hvcc->end);
    t.codec = Codec::kHevc;
  } else if (t.tag == "vp08" || t.tag == "vp09") {
    read_vpcc(t, boxes(f, entry + 86, entry + esz));
  } else if (mov_mpeg12(t.tag)) {
    t.codec = Codec::kMpeg12;
  } else if (t.tag == "s263" || t.tag == "h263") {
    // H.263 as 3GPP phones store it (a d263 box, which the decoder does
    // not read, or none).
    t.codec = Codec::kH263;
  } else if (t.tag == "FFV1") {
    // FFV1's configuration record (versions 2 and 3) in a glbl box, which
    // libavformat takes as the extradata.
    t.codec = Codec::kFfv1;
    std::vector<Box> eb = boxes(f, entry + 86, entry + esz);
    if (const Box* glbl = child(eb, "glbl"))
      t.extradata.assign(f.begin() + glbl->body, f.begin() + glbl->end);
  } else if (t.tag == "mp4v") {
    const Box* esds = nullptr;
    std::vector<Box> eb = boxes(f, entry + 86, entry + esz);
    esds = child(eb, "esds");
    if (!esds) broken("MP4 'mp4v' sample entry without esds");
    int oti = -1;
    read_esds(t, *esds, oti);
    if (oti == 0x20) {
      t.codec = Codec::kMpeg4;
    } else if ((oti >= 0x60 && oti <= 0x65) || oti == 0x6A) {
      // MPEG-2 (Simple, Main, SNR, Spatial, High, 4:2:2) and MPEG-1
      // video, the sequence header as DecoderSpecificInfo.
      t.codec = Codec::kMpeg12;
    } else if (oti == 0x6C) {
      t.codec = Codec::kMjpeg;
      t.config.clear();
    } else if (oti == 0x6D) {              // PNG, as cv2's writer stores it
      t.codec = Codec::kPng;
      t.config.clear();
    } else {
      char b[64];
      std::snprintf(b, sizeof(b), "mp4v objectTypeIndication 0x%02X", oti);
      t.tag = b;
    }
  }
  // Sample table → packets.
  const Box* stsz = child(sb, "stsz");
  const Box* stz2 = child(sb, "stz2");
  const Box* stsc = child(sb, "stsc");
  const Box* stco = child(sb, "stco");
  const Box* co64 = child(sb, "co64");
  const Box* stss = child(sb, "stss");
  if ((!stsz && !stz2) || !stsc || (!stco && !co64))
    broken("MP4 video track without its sample tables");
  std::vector<uint32_t> sizes;
  if (stsz) {
    if (stsz->body + 12 > stsz->end) broken("MP4 stsz cut short");
    uint32_t fixed = be32(&f[stsz->body + 4]);
    uint32_t count = be32(&f[stsz->body + 8]);
    if (!fixed && stsz->body + 12 + 4 * size_t(count) > stsz->end)
      broken("MP4 stsz cut short");
    sizes.resize(count, fixed);
    for (uint32_t i = 0; i < count && !fixed; ++i)
      sizes[i] = be32(&f[stsz->body + 12 + 4 * i]);
  } else {
    if (stz2->body + 12 > stz2->end) broken("MP4 stz2 cut short");
    int bits = f[stz2->body + 7];
    uint32_t count = be32(&f[stz2->body + 8]);
    if (bits != 4 && bits != 8 && bits != 16) broken("MP4 stz2 field size");
    if (stz2->body + 12 + (size_t(count) * bits + 7) / 8 > stz2->end)
      broken("MP4 stz2 cut short");
    sizes.resize(count);
    const uint8_t* q = &f[stz2->body + 12];
    for (uint32_t i = 0; i < count; ++i)
      sizes[i] = bits == 16 ? (q[2 * i] << 8) | q[2 * i + 1]
                 : bits == 8 ? q[i]
                             : (i & 1 ? q[i / 2] & 15 : q[i / 2] >> 4);
  }
  std::vector<uint64_t> chunks;
  const Box* co = stco ? stco : co64;
  if (co->body + 8 > co->end) broken("MP4 chunk offsets cut short");
  uint32_t nchunks = be32(&f[co->body + 4]);
  size_t w = stco ? 4 : 8;
  if (co->body + 8 + w * nchunks > co->end)
    broken("MP4 chunk offsets cut short");
  for (uint32_t i = 0; i < nchunks; ++i)
    chunks.push_back(stco ? be32(&f[co->body + 8 + 4 * i])
                          : be64(&f[co->body + 8 + 8 * i]));
  if (stsc->body + 8 > stsc->end) broken("MP4 stsc cut short");
  uint32_t runs = be32(&f[stsc->body + 4]);
  if (stsc->body + 8 + 12 * size_t(runs) > stsc->end)
    broken("MP4 stsc cut short");
  std::vector<bool> key(sizes.size(), stss == nullptr);
  if (stss) {
    if (stss->body + 8 > stss->end) broken("MP4 stss cut short");
    uint32_t k = be32(&f[stss->body + 4]);
    if (stss->body + 8 + 4 * size_t(k) > stss->end)
      broken("MP4 stss cut short");
    for (uint32_t i = 0; i < k; ++i) {
      uint32_t s = be32(&f[stss->body + 8 + 4 * i]);
      if (s >= 1 && s <= key.size()) key[s - 1] = true;
    }
  }
  std::vector<size_t> offs(sizes.size(), 0);
  size_t sample = 0;
  for (uint32_t r = 0; r < runs && sample < sizes.size(); ++r) {
    const uint8_t* e = &f[stsc->body + 8 + 12 * r];
    uint32_t first = be32(e), per = be32(e + 4);
    uint32_t last = r + 1 < runs ? be32(e + 12) : nchunks + 1;
    if (first < 1 || last < first) broken("MP4 stsc is not ordered");
    for (uint32_t c = first; c < last && sample < sizes.size(); ++c) {
      if (c > nchunks) broken("MP4 stsc names a chunk past stco");
      uint64_t off = chunks[c - 1];
      for (uint32_t k = 0; k < per && sample < sizes.size(); ++k) {
        if (off + sizes[sample] > f.size())
          broken("MP4 sample runs past the file");
        offs[sample] = size_t(off);
        off += sizes[sample++];
      }
    }
  }
  const size_t n = sizes.size(), stored = sample;   // stsc may stop short
  size_t first = 0, last = n;                  // the samples read
  std::vector<bool> discard(n, false);
  if (edited && n) {
    std::vector<int64_t> dts, cts;
    sample_times(f, sb, n, dts, cts);
    // The edit's duration, in the movie's timescale, in the media's.
    int64_t media = timescale(f, child(mb, "mdhd"));
    if (movie <= 0 || media <= 0) broken("MP4 timescale of 0");
    int64_t dur = (edit_duration * media + movie / 2) / movie;
    int64_t end = edit_time + dur;
    // find_prev_closest_index: the last keyframe decoded at or before
    // the media time and, with ctts, presented at or before it; else
    // the first sample.
    bool with_ctts = child(sb, "ctts") != nullptr;
    auto search = [&](bool any) {
      int64_t k = -1;
      for (size_t i = 0; i < n && dts[i] <= edit_time; ++i)
        if (any || key[i]) k = int64_t(i);
      while (with_ctts && k >= 0 &&
             !(cts[size_t(k)] <= edit_time && key[size_t(k)]))
        --k;
      return k;
    };
    int64_t k = search(false);
    if (k < 0) k = search(true);
    first = k < 0 ? 0 : size_t(k);
    bool seen_key_after = false;
    for (size_t i = first; i < n; ++i) {
      discard[i] = cts[i] < edit_time || cts[i] >= end;
      last = i + 1;
      int64_t frame = i + 1 < n ? dts[i + 1] - dts[i] : dur;
      if (cts[i] + frame >= end && key[i]) {
        // With ctts, the keyframe after the next one: B-frames after
        // the first may still belong to the edit.
        if (!with_ctts || seen_key_after) break;
        seen_key_after = true;
      }
    }
  }
  for (size_t i = first; i < last && i < stored; ++i)
    if (sizes[i])
      t.packets.push_back({offs[i], sizes[i], key[i], discard[i]});
  t.count = int64_t(n);
  if (t.codec == Codec::kH264 && child(sb, "ctts") && n) {
    std::vector<int64_t> dts, cts;
    sample_times(f, sb, n, dts, cts);
    t.video_delay = guess_video_delay(cts);
  }
}

// cv2's view of an MP4 file's movie fragments (libavformat's mov_read_moof,
// mov_read_tfhd, mov_read_tfdt, mov_read_trun, which read every fragment
// when the file opens): the chosen track's samples appended to
// t.packets in file order, after those of moov's tables; a sample is a
// keyframe when its flags mark it neither sample_is_non_sync_sample nor
// depending on others. libavformat applies no edit list to them (only as
// a shift of their timestamps). Every track's timestamps go into
// cv2's frame count (see mp4_count).
void mp4_fragments(Track& t, const std::vector<Box>& top,
                   std::vector<Mp4Stream>& streams, size_t chosen) {
  const std::vector<uint8_t>& f = t.file;
  for (const Box& moof : top) {
    if (moof.type != "moof") continue;
    size_t implicit = moof.start;
    for (const Box& traf : boxes(f, moof.body, moof.end)) {
      if (traf.type != "traf") continue;
      std::vector<Box> fb = boxes(f, traf.body, traf.end);
      const Box* tfhd = child(fb, "tfhd");
      if (!tfhd || tfhd->body + 8 > tfhd->end)
        broken("MP4 track fragment without its tfhd");
      uint32_t flags = be32(&f[tfhd->body]) & 0xFFFFFF;
      uint32_t id = be32(&f[tfhd->body + 4]);
      size_t k = 0;
      while (k < streams.size() && streams[k].id != id) ++k;
      if (k == streams.size()) continue;         // no such track: skipped
      Mp4Stream& s = streams[k];
      size_t q = tfhd->body + 8;
      auto field = [&](int bytes) -> uint64_t {
        if (q + bytes > tfhd->end) broken("MP4 tfhd cut short");
        uint64_t v = bytes == 8 ? be64(&f[q]) : be32(&f[q]);
        q += bytes;
        return v;
      };
      uint64_t base = flags & 0x01 ? field(8)
                      : flags & 0x020000 ? moof.start : implicit;
      uint32_t desc = flags & 0x02 ? uint32_t(field(4)) : s.trex[0];
      uint32_t dflt_duration = flags & 0x08 ? uint32_t(field(4)) : s.trex[1];
      uint32_t dflt_size = flags & 0x10 ? uint32_t(field(4)) : s.trex[2];
      uint32_t dflt_flags = flags & 0x20 ? uint32_t(field(4)) : s.trex[3];
      // libavformat decodes every fragment with the first sample
      // description's parameters, whichever the tfhd names: one whose
      // entry is the first's bytes reads as it; another breaks cv2's
      // pictures from that fragment on.
      if (k == chosen && desc != 1) {
        const auto& en = s.entries;
        bool same = desc >= 1 && desc <= en.size() &&
                    en[desc - 1].second - en[desc - 1].first ==
                        en[0].second - en[0].first &&
                    std::equal(f.begin() + en[0].first + 8,
                               f.begin() + en[0].second,
                               f.begin() + en[desc - 1].first + 8);
        if (!same)
          unsupported("MP4 fragment of sample description " +
                      std::to_string(desc) + " (libavformat decodes it "
                      "with the first one's parameters)");
      }
      int64_t dts = s.next_dts;
      if (const Box* tfdt = child(fb, "tfdt")) {
        if (tfdt->body + 8 > tfdt->end) broken("MP4 tfdt cut short");
        bool v1 = f[tfdt->body] == 1;
        if (v1 && tfdt->body + 12 > tfdt->end) broken("MP4 tfdt cut short");
        dts = v1 ? int64_t(be64(&f[tfdt->body + 4]))
                 : int64_t(be32(&f[tfdt->body + 4]));
        if (k == chosen && dts < s.next_dts)
          broken("MP4 fragment that begins before the one before it ends");
      }
      uint64_t off = base;
      int runs = 0;
      for (const Box& trun : fb) {
        if (trun.type != "trun") continue;
        if (trun.body + 8 > trun.end) broken("MP4 trun cut short");
        uint32_t tf = be32(&f[trun.body]) & 0xFFFFFF;
        uint32_t entries = be32(&f[trun.body + 4]);
        size_t r = trun.body + 8;
        auto word = [&]() -> uint32_t {
          if (r + 4 > trun.end) broken("MP4 trun cut short");
          uint32_t v = be32(&f[r]);
          r += 4;
          return v;
        };
        if (tf & 0x001) {
          off = base + uint64_t(int64_t(int32_t(word())));
        } else if (runs) {
          // libavformat starts it at the base again, the standard after
          // the run before.
          off = base;
          if (k == chosen) t.rebased_runs = true;
        }
        uint32_t first_flags = tf & 0x004 ? word() : dflt_flags;
        for (uint32_t i = 0; i < entries; ++i) {
          uint32_t duration = tf & 0x100 ? word() : dflt_duration;
          uint32_t size = tf & 0x200 ? word() : dflt_size;
          uint32_t sflags = tf & 0x400 ? word() : i ? dflt_flags
                                                    : first_flags;
          int64_t cts = tf & 0x800 ? int64_t(int32_t(word())) : 0;
          if (k == chosen) {
            if (off + size > f.size())
              broken("MP4 fragment sample runs past the file");
            if (size)
              t.packets.push_back({size_t(off), size,
                                   !(sflags & (0x10000 | 0x1000000))});
            s.frames += 1;
            s.frames_duration += duration;
          }
          if (!s.any) {
            s.any = true;
            s.first_dts = dts;
            s.first_cts = cts;
          }
          s.dts_shift = std::max(s.dts_shift, -cts);
          dts += duration;
          off += size;
        }
        s.duration = std::max(s.duration, dts);
        ++runs;
      }
      s.next_dts = dts;
      implicit = size_t(off);
    }
  }
}

// cv2's CAP_PROP_FRAME_COUNT of an MP4 file whose video track's samples
// all lie in fragments (moov's tables empty; else it is their sample
// count): OpenCV's round(duration · fps) with libavformat's average frame
// rate (the fragments' samples over their duration) and its duration of
// the file, the longest of each stream's duration (mdhd's, or its last
// fragment's end if later) and the span from the earliest stream's start
// (its first sample's presentation time, the edit list's shift and the
// largest negative composition offset applied) to the latest stream's
// start plus duration; of a timecode (tmcd) or text track, as
// libavformat's update_stream_timings takes a data or subtitle stream,
// only where it lies within a second of those of the video and sound.
int64_t mp4_count(const std::vector<Mp4Stream>& streams, size_t chosen) {
  auto us = [](int64_t v, int64_t scale) {       // av_rescale_q, to µs
    int64_t a = v < 0 ? -v : v;
    int64_t r = (a * 1000000 + scale / 2) / scale;
    return v < 0 ? -r : r;
  };
  // [0] the video and sound streams', [1] the timecode and text
  // tracks' (update_stream_timings' non-primary streams)
  int64_t lo[2] = {INT64_MAX, INT64_MAX}, hi[2] = {INT64_MIN, INT64_MIN};
  int64_t longest[2] = {INT64_MIN, INT64_MIN};
  for (const Mp4Stream& s : streams) {
    if (s.handler != "vide" && s.handler != "soun" && s.handler != "tmcd" &&
        s.handler != "text")
      unsupported("fragmented MP4 with a '" + s.handler + "' track (cv2's "
                  "frame count would depend on it)");
    if (s.timescale <= 0) broken("MP4 timescale of 0");
    if (s.moov_samples)
      unsupported("fragmented MP4 with a track whose samples begin in "
                  "moov, the video's in fragments");
    const int k = s.handler == "tmcd" || s.handler == "text";
    longest[k] = std::max(longest[k], us(s.duration, s.timescale));
    if (!s.any) continue;
    int64_t start = s.first_dts - s.time_offset + s.dts_shift + s.first_cts +
                    (s.handler == "soun" ? s.aac_pad : 0);
    int64_t start_us = us(start, s.timescale);
    lo[k] = std::min(lo[k], start_us);
    hi[k] = std::max(hi[k], start_us + us(s.duration, s.timescale));
  }
  // A non-primary stream's start, end and duration count when no
  // primary stream gives one, or within a second of the primary's.
  constexpr int64_t kSecond = 1000000;
  if (lo[0] == INT64_MAX || (lo[0] > lo[1] && lo[0] - lo[1] < kSecond))
    lo[0] = lo[1];
  if (hi[0] == INT64_MIN || (hi[0] < hi[1] && hi[1] - hi[0] < kSecond))
    hi[0] = hi[1];
  if (longest[0] == INT64_MIN ||
      (longest[0] < longest[1] && longest[1] - longest[0] < kSecond))
    longest[0] = longest[1];
  int64_t duration = lo[0] == INT64_MAX || hi[0] == INT64_MIN
                         ? longest[0]
                         : std::max(longest[0], hi[0] - lo[0]);
  const Mp4Stream& v = streams[chosen];
  if (!v.frames_duration) return 0;
  int64_t fn = 0, fd = 1;
  av_reduce(fn, fd, v.timescale * v.frames, v.frames_duration, 0x7FFFFFFF);
  double fps = fd ? double(fn) / double(fd) : 0.0;
  return int64_t(std::floor(double(duration) / 1000000.0 * fps + 0.5));
}

void demux_mp4(Track& t) {
  const std::vector<uint8_t>& f = t.file;
  t.container = "MP4";
  std::vector<Box> top = boxes(f, 0, f.size());
  const Box* moov = child(top, "moov");
  if (!moov) broken("MP4 file without a moov box");
  std::vector<Box> mv = boxes(f, moov->body, moov->end);
  // mvhd's timescale and display matrix, which libavformat's
  // mov_read_tkhd multiplies into each track's.
  const Box* mvhd = child(mv, "mvhd");
  int64_t movie = 0;
  int32_t movie_m[9] = {0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000};
  if (mvhd && mvhd->body + 4 <= mvhd->end) {
    size_t at = mvhd->body + (f[mvhd->body] == 1 ? 48 : 36);
    if (at + 36 <= mvhd->end) {
      movie = timescale(f, mvhd);
      for (int i = 0; i < 9; ++i) movie_m[i] = int32_t(be32(&f[at + 4 * i]));
    }
  }
  std::vector<Mp4Stream> streams;
  size_t chosen = SIZE_MAX;
  for (const Box& trak : mv) {
    if (trak.type != "trak") continue;
    std::vector<Box> tb = boxes(f, trak.body, trak.end);
    const Box* mdia = child(tb, "mdia");
    if (!mdia) continue;
    std::vector<Box> mb = boxes(f, mdia->body, mdia->end);
    const Box* hdlr = child(mb, "hdlr");
    if (!hdlr || hdlr->body + 12 > hdlr->end) continue;
    Mp4Stream s;
    s.handler.assign(reinterpret_cast<const char*>(&f[hdlr->body + 8]), 4);
    const Box* tkhd = child(tb, "tkhd");
    bool v1 = tkhd && tkhd->body < tkhd->end && f[tkhd->body] == 1;
    if (!tkhd || tkhd->body + (v1 ? 88 : 76) > tkhd->end)
      broken("MP4 track without its tkhd");
    s.id = be32(&f[tkhd->body + (v1 ? 20 : 12)]);
    if (const Box* mdhd = child(mb, "mdhd")) {
      bool m1 = mdhd->body < mdhd->end && f[mdhd->body] == 1;
      if (mdhd->body + (m1 ? 32 : 20) <= mdhd->end) {
        s.timescale = timescale(f, mdhd);
        s.duration = m1 ? int64_t(be64(&f[mdhd->body + 24]))
                        : int64_t(be32(&f[mdhd->body + 16]));
      }
    }
    // stts's samples, and whether an audio track is AAC (mp4a, OTI 0x40).
    if (const Box* minf = child(mb, "minf")) {
      std::vector<Box> nb = boxes(f, minf->body, minf->end);
      if (const Box* stbl = child(nb, "stbl")) {
        std::vector<Box> sb = boxes(f, stbl->body, stbl->end);
        const Box* stts = child(sb, "stts");
        if (stts && stts->body + 8 <= stts->end) {
          uint32_t runs = be32(&f[stts->body + 4]);
          if (stts->body + 8 + 8 * size_t(runs) > stts->end)
            broken("MP4 stts cut short");
          for (uint32_t r = 0; r < runs; ++r) {
            uint32_t cnt = be32(&f[stts->body + 8 + 8 * r]);
            s.moov_samples += cnt;
            s.moov_duration += int64_t(cnt) * be32(&f[stts->body + 12 + 8 * r]);
          }
        }
        const Box* stsd = child(sb, "stsd");
        if (s.handler == "soun" && stsd && stsd->body + 16 <= stsd->end &&
            std::memcmp(&f[stsd->body + 12], "mp4a", 4) == 0) {
          size_t entry = stsd->body + 8, esz = be32(&f[entry]);
          if (esz >= 36 && entry + esz <= stsd->end) {
            Track probe;
            probe.file = f;
            std::vector<Box> eb = boxes(f, entry + 36, entry + esz);
            int oti = -1;
            if (const Box* esds = child(eb, "esds")) read_esds(probe, *esds, oti);
            s.aac = oti == 0x40;
          }
        }
      }
    }
    s.next_dts = s.moov_duration;
    bool edited = false;
    int64_t edit_time = 0, edit_duration = 0;
    if (chosen != SIZE_MAX || s.handler != "vide") {
      mp4_edits(f, tb, movie, s, edited, edit_time, edit_duration, false);
      streams.push_back(s);
      continue;
    }
    chosen = streams.size();
    mp4_samples(t, tb, mb, movie, s);
    streams.push_back(s);
    // The display matrix: tkhd's times mvhd's, each product shifted as
    // mov_read_tkhd shifts it (16, 16, 30 by the row of mvhd's).
    int32_t m[9], r[9];
    size_t at = tkhd->body + (v1 ? 52 : 40);
    for (int i = 0; i < 9; ++i) m[i] = int32_t(be32(&f[at + 4 * i]));
    const int shift[3] = {16, 16, 30};
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) {
        int64_t v = 0;
        for (int e = 0; e < 3; ++e)
          v += (int64_t(m[3 * i + e]) * movie_m[3 * e + j]) >> shift[e];
        r[3 * i + j] = int32_t(v);
      }
    const int32_t identity[9] = {0x10000, 0, 0, 0, 0x10000, 0, 0, 0,
                                 0x40000000};
    if (!std::equal(r, r + 9, identity)) t.orientation = cv2_orientation(r, "MP4");
  }
  if (chosen == SIZE_MAX) broken("MP4 file without a video track");
  if (const Box* mvex = child(mv, "mvex")) {
    for (const Box& trex : boxes(f, mvex->body, mvex->end)) {
      if (trex.type != "trex") continue;
      if (trex.body + 24 > trex.end) broken("MP4 trex cut short");
      for (Mp4Stream& s : streams)
        if (s.id == be32(&f[trex.body + 4]))
          for (int i = 0; i < 4; ++i) s.trex[i] = be32(&f[trex.body + 8 + 4 * i]);
    }
    mp4_fragments(t, top, streams, chosen);
    if (!streams[chosen].moov_samples) t.count = mp4_count(streams, chosen);
  }
}

// ----------------------------------------------------------- Matroska

struct Ebml {
  const std::vector<uint8_t>& f;
  size_t p, end;
};

constexpr uint64_t kUnknown = ~uint64_t(0);

uint32_t ebml_id(Ebml& e) {
  if (e.p >= e.end) broken("Matroska element cut short");
  uint8_t b = e.f[e.p];
  int len = b & 0x80 ? 1 : b & 0x40 ? 2 : b & 0x20 ? 3 : b & 0x10 ? 4 : 0;
  if (!len || e.p + len > e.end) broken("Matroska element ID is bad");
  uint32_t id = 0;
  for (int i = 0; i < len; ++i) id = (id << 8) | e.f[e.p++];
  return id;
}

uint64_t ebml_vint(const std::vector<uint8_t>& f, size_t& p, size_t end,
                   int* width = nullptr) {
  if (p >= end) broken("Matroska number cut short");
  uint8_t b = f[p];
  int len = 1;
  while (len <= 8 && !(b & (0x80 >> (len - 1)))) ++len;
  if (len > 8 || p + len > end) broken("Matroska number is bad");
  uint64_t v = b & (0xFF >> len);
  bool ones = v == uint64_t(0xFF >> len);
  for (int i = 1; i < len; ++i) {
    v = (v << 8) | f[p + i];
    ones = ones && f[p + i] == 0xFF;
  }
  p += len;
  if (width) *width = len;
  return ones ? kUnknown : v;
}

uint64_t ebml_uint(const std::vector<uint8_t>& f, size_t p, size_t n) {
  uint64_t v = 0;
  for (size_t i = 0; i < n && i < 8; ++i) v = (v << 8) | f[p + i];
  return v;
}

double ebml_float(const std::vector<uint8_t>& f, size_t p, size_t n) {
  if (n == 4) {
    uint32_t u = uint32_t(ebml_uint(f, p, 4));
    float x;
    std::memcpy(&x, &u, 4);
    return x;
  }
  if (n == 8) {
    uint64_t u = ebml_uint(f, p, 8);
    double x;
    std::memcpy(&x, &u, 8);
    return x;
  }
  return 0.0;
}

bool mkv_top_level(uint32_t id) {
  return id == 0x1F43B675 || id == 0x1C53BB6B || id == 0x1254C367 ||
         id == 0x1043A770 || id == 0x1941A469 || id == 0x114D9B74 ||
         id == 0x1549A966 || id == 0x1654AE6B || id == 0x18538067;
}

// A track's ContentEncoding (libavformat's MatroskaTrackEncoding).
struct MkvEncoding {
  uint64_t order = 0, scope = 1, type = 0, algo = 0;
  std::vector<uint8_t> settings;        // ContentCompSettings
};

// The ContentEncoding elements of a ContentEncodings body.
std::vector<MkvEncoding> mkv_encodings(const std::vector<uint8_t>& f,
                                       size_t p, size_t end) {
  std::vector<MkvEncoding> out;
  std::vector<std::pair<size_t, size_t>> st = {{p, end}};
  while (!st.empty()) {
    auto [q, qe] = st.back();
    st.pop_back();
    Ebml c{f, q, qe};
    while (c.p < qe) {
      uint32_t id = ebml_id(c);
      uint64_t n = ebml_vint(f, c.p, qe);
      if (n == kUnknown || c.p + n > qe)
        broken("Matroska content encoding is bad");
      size_t b = c.p;
      c.p += n;
      if (id == 0x6240) {                           // ContentEncoding
        out.emplace_back();
        st.push_back({b, b + n});
        continue;
      }
      if (out.empty()) continue;
      MkvEncoding& e = out.back();
      if (id == 0x5031) e.order = ebml_uint(f, b, n);
      else if (id == 0x5032) e.scope = ebml_uint(f, b, n);
      else if (id == 0x5033) e.type = ebml_uint(f, b, n);
      else if (id == 0x5034) st.push_back({b, b + n});   // ContentCompression
      else if (id == 0x4254) e.algo = ebml_uint(f, b, n);
      else if (id == 0x4255)
        e.settings.assign(f.begin() + b, f.begin() + b + n);
    }
  }
  return out;
}

// libavutil's av_lzo1x_decode of a whole LZO1X stream (its end marker
// reached; bytes after it ignored) → the bytes, as libavformat's
// Matroska demuxer decodes a frame of ContentCompAlgo 2.
std::vector<uint8_t> lzo1x_decode(const uint8_t* in, size_t n) {
  std::vector<uint8_t> out;
  size_t i = 0;
  auto next = [&]() -> int {
    if (i >= n) broken("Matroska LZO frame ends early");
    return in[i++];
  };
  auto literals = [&](size_t cnt) {
    if (cnt > n - i) broken("Matroska LZO frame ends early");
    out.insert(out.end(), in + i, in + i + cnt);
    i += cnt;
  };
  auto length = [&](int x, int mask) {        // get_len
    size_t cnt = size_t(x & mask);
    if (!cnt) {
      while (!(x = next())) cnt += 255;
      cnt += size_t(mask + x);
    }
    return cnt;
  };
  auto match = [&](size_t back, size_t cnt) {  // copy_backptr
    if (back > out.size()) broken("Matroska LZO frame points back too far");
    size_t from = out.size() - back;
    for (size_t k = 0; k < cnt; ++k) {
      uint8_t b = out[from + k];
      out.push_back(b);
    }
  };
  int state = 0;
  int x = next();
  if (x > 17) {
    literals(size_t(x - 17));
    x = next();
    if (x < 16) broken("Matroska LZO frame is bad");
  }
  while (true) {
    size_t cnt, back;
    if (x > 15) {
      if (x > 63) {
        cnt = size_t((x >> 5) - 1);
        back = (size_t(next()) << 3) + size_t((x >> 2) & 7) + 1;
      } else if (x > 31) {
        cnt = length(x, 31);
        x = next();
        back = (size_t(next()) << 6) + size_t(x >> 2) + 1;
      } else {
        cnt = length(x, 7);
        back = (size_t(1) << 14) + (size_t(x & 8) << 11);
        x = next();
        back += (size_t(next()) << 6) + size_t(x >> 2);
        if (back == (size_t(1) << 14)) {          // the end marker
          if (cnt != 1) broken("Matroska LZO frame is bad");
          return out;
        }
      }
    } else if (!state) {
      cnt = length(x, 15);
      literals(cnt + 3);
      x = next();
      if (x > 15) continue;
      cnt = 1;
      back = (size_t(1) << 11) + (size_t(next()) << 2) + size_t(x >> 2) + 1;
    } else {
      cnt = 0;
      back = (size_t(next()) << 2) + size_t(x >> 2) + 1;
    }
    match(back, cnt + 2);
    state = x & 3;
    literals(size_t(state));
    x = next();
  }
}

// libavformat's matroska_decode_buffer: a frame (or the CodecPrivate)
// under its track's one content encoding of compression (ContentCompAlgo
// 0 zlib, 2 LZO, 3 header stripping: ContentCompSettings before it).
std::vector<uint8_t> mkv_decode(const MkvEncoding& e, const uint8_t* d,
                                size_t n) {
  if (e.algo == 3) {
    std::vector<uint8_t> out(e.settings);
    out.insert(out.end(), d, d + n);
    return out;
  }
  if (e.algo == 2) return lzo1x_decode(d, n);
  try {
    return viai_inflate::inflate_zlib(d, n, viai_inflate::kAll);
  } catch (const viai_inflate::Error& err) {
    broken("Matroska zlib-compressed frame " + err.msg);
  }
}

// libavformat's reading of a video track's ContentEncodings → its
// CodecPrivate: one encoding of compression is undone, on the
// CodecPrivate under scope 2 (here) and on every frame under scope 1
// (mkv_block); of several it undoes none, and bzlib (algo 1: not in
// cv2's build) and unknown algorithms it ignores, so their frames stay
// compressed and cv2 decodes none (ValueError, as the JAX package then
// raises). Encryption raises.
std::vector<uint8_t> mkv_private(const std::vector<MkvEncoding>& encs,
                                 const std::vector<uint8_t>& priv) {
  if (encs.empty()) return priv;
  if (encs.size() > 1) {
    for (const MkvEncoding& e : encs)
      if (!e.type && (e.scope & 1) && !(e.algo == 3 && e.settings.empty()))
        broken("Matroska track with " + std::to_string(encs.size()) +
               " content encodings (libavformat undoes none of them, so "
               "cv2 decodes no frame)");
    unsupported("Matroska track with " + std::to_string(encs.size()) +
                " content encodings");
  }
  const MkvEncoding& e = encs[0];
  if (e.type)
    unsupported("Matroska track with encrypted content (ContentEncodingType "
                + std::to_string(e.type) + ")");
  if (e.algo == 1 || e.algo > 3) {
    if (e.scope & 3)
      broken("Matroska track compressed by " +
             std::string(e.algo == 1 ? "bzlib" : "an unknown algorithm") +
             " (ContentCompAlgo " + std::to_string(e.algo) + ": "
             "libavformat leaves it compressed, so cv2 decodes no frame)");
    return priv;
  }
  if ((e.scope & 2) && !priv.empty())
    return mkv_decode(e, priv.data(), priv.size());
  return priv;
}

// No timestamp: a laced frame after its block's first.
constexpr int64_t kNoTs = INT64_MIN;

// A block of `track` into t.packets; each frame's timestamp onto
// `stamps`: the block's (the cluster's plus its signed offset, in
// TimestampScale units) for its first, kNoTs for the rest of a lace, as
// libavformat gives them without DefaultDuration. `enc`, the track's
// frame compression: each frame decoded and appended to t.file, its
// packet there.
void mkv_block(Track& t, size_t p, size_t end, uint64_t track, bool simple,
               bool referenced, int64_t cluster, std::vector<int64_t>& stamps,
               const MkvEncoding* enc) {
  const std::vector<uint8_t>& f = t.file;
  uint64_t num = ebml_vint(f, p, end);
  if (num != track) return;
  if (p + 3 > end) broken("Matroska block cut short");
  uint8_t flags = f[p + 2];
  int64_t stamp = cluster + int16_t((f[p] << 8) | f[p + 1]);
  p += 3;
  bool key = simple ? (flags & 0x80) != 0 : !referenced;
  int lacing = (flags >> 1) & 3;
  auto frame = [&](size_t at, uint64_t size, bool k) {
    if (enc) {
      std::vector<uint8_t> d = mkv_decode(*enc, &f[at], size_t(size));
      at = t.file.size();
      size = d.size();
      t.file.insert(t.file.end(), d.begin(), d.end());
    }
    if (!size) return;
    stamps.push_back(stamp);
    stamp = kNoTs;
    t.packets.push_back({at, uint32_t(size), k});
  };
  if (lacing == 0) {
    if (end > p) frame(p, end - p, key);
    return;
  }
  if (p >= end) broken("Matroska laced block cut short");
  int frames = f[p++] + 1;
  std::vector<uint64_t> sizes(frames, 0);
  if (lacing == 1) {                             // Xiph
    for (int i = 0; i < frames - 1; ++i) {
      uint64_t s = 0;
      uint8_t b;
      do {
        if (p >= end) broken("Matroska Xiph lacing cut short");
        b = f[p++];
        s += b;
      } while (b == 255);
      sizes[i] = s;
    }
  } else if (lacing == 3) {                      // EBML
    int64_t s = int64_t(ebml_vint(f, p, end));
    sizes[0] = uint64_t(s);
    for (int i = 1; i < frames - 1; ++i) {
      int w = 0;
      uint64_t v = ebml_vint(f, p, end, &w);
      int64_t bias = (int64_t(1) << (7 * w - 1)) - 1;
      s += int64_t(v) - bias;
      if (s < 0) broken("Matroska EBML lacing is bad");
      sizes[i] = uint64_t(s);
    }
  } else {                                       // fixed
    if ((end - p) % frames) broken("Matroska fixed lacing is bad");
    for (int i = 0; i < frames - 1; ++i) sizes[i] = (end - p) / frames;
  }
  uint64_t used = 0;
  for (int i = 0; i < frames - 1; ++i) used += sizes[i];
  if (used > end - p) broken("Matroska lacing runs past its block");
  sizes[frames - 1] = (end - p) - used;
  for (int i = 0; i < frames; ++i) {
    if (sizes[i]) frame(p, sizes[i], key && i == 0);
    p += sizes[i];
  }
}

// cv2's orientation of a Matroska video track's Projection (libavformat's
// mkv_create_display_matrix): a rectangular one (ProjectionType 0) with
// a roll alone is av_display_rotation_set(-roll); with a yaw of 180 it
// is mirrored (raises, as in MP4); with another yaw or a pitch, and for
// the spherical types (1 equirectangular, 3 mesh), cv2 shows the picture
// as coded; a cubemap (2) it opens only with its layout, six faces.
int mkv_orientation(uint64_t type, double yaw, double pitch, double roll) {
  const double kPi = 3.14159265358979323846;
  if (type == 2)
    unsupported("Matroska cubemap projection (ProjectionType 2: six faces, "
                "not one picture)");
  if (type != 0 || (pitch == 0.0 && yaw == 0.0 && roll == 0.0)) return 0;
  if (pitch != 0.0 || (yaw != 0.0 && yaw != 180.0 && yaw != -180.0) ||
      std::isnan(roll))
    return 0;
  if (yaw != 0.0)
    unsupported("Matroska projection with a mirror (ProjectionPoseYaw 180; "
                "cv2 would turn the picture instead of mirroring it)");
  double radians = roll * kPi / 180.0f;        // -(-roll) · π / 180
  double c = std::cos(radians), s = std::sin(radians);
  const int32_t m[9] = {int32_t(c * 65536), int32_t(-s * 65536), 0,
                        int32_t(s * 65536), int32_t(c * 65536), 0, 0, 0,
                        1 << 30};
  return cv2_orientation(m, "Matroska");
}

// libavformat's standard frame rates (get_std_framerate), in 1/(12 · 1001)
// fps: 1/12 steps to 30 fps, then 31..60, 80, 120, 240, and 24, 30, 60,
// 12, 15, 48 at ·1000/1001.
constexpr int kStdRates = 30 * 12 + 30 + 3 + 6;
int64_t std_rate(int i) {
  if (i < 30 * 12) return int64_t(i + 1) * 1001;
  i -= 30 * 12;
  if (i < 30) return int64_t(i + 31) * 1001 * 12;
  i -= 30;
  if (i < 3) return int64_t((const int[]){80, 120, 240}[i]) * 1001 * 12;
  i -= 3;
  return int64_t((const int[]){24, 30, 60, 12, 15, 48}[i]) * 1000 * 12;
}

// libavformat's frame rate of a video stream whose container gives none
// (a Matroska track without DefaultDuration; its codec none either: VP8,
// VP9, MJPEG; see mkv_stream_rate for the rest): ff_rfps_add_frame over
// the decode times `ts` of the packets avformat_find_stream_info reads
// (kNoTs for a packet without one, a laced frame after its block's
// first: counted, not timed; in the time base tb_num / tb_den; until 20
// durations, 40 for a time base coarser than 0.5 ms, are counted, 5 s of
// them analysed or 5 MB read), ff_rfps_calculate (their common divisor,
// else the standard rate whose phase error varies least), as
// r_frame_rate, which av_guess_frame_rate and OpenCV's get_fps give cv2.
// → (num, den), or (0, 1) when it settles on none and libavformat falls
// back to the time base (a variable rate).
void rfps_estimate(const std::vector<int64_t>& ts,
                   const std::vector<uint32_t>& sizes, int64_t tb_num,
                   int64_t tb_den, int64_t& num, int64_t& den) {
  constexpr int kStd = kStdRates;
  const double tbq = double(tb_num) / double(tb_den);
  // tb_unreliable: a time base finer than 1/101 s or coarser than 1/5 s.
  bool unreliable = tb_den >= 101 * tb_num || tb_den < 5 * tb_num;
  num = 0;
  den = 1;
  if (!unreliable) {                 // no estimate: the time base's rate
    num = tb_den;
    den = tb_num;
    return;
  }
  const int framecount = tbq > 0.0005 ? 40 : 20;
  std::vector<double> errors(2 * 2 * kStd, 0.0);
  auto err = [&](int j, int k, int i) -> double& {
    return errors[size_t((2 * j + k) * kStd + i)];
  };
  int64_t last = INT64_MIN, sum = 0, divisor = 0, bytes = 0;
  int count = 0;
  int64_t fps_first = INT64_MIN, fps_last = INT64_MIN;
  int first_idx = 0, last_idx = 0;
  for (size_t k = 0; k < ts.size(); ++k) {
    // The loop's checks before it reads a packet: every stream done (the
    // other streams of a file done first), or 5 MB read.
    if (count >= framecount || bytes >= 5000000) break;
    bytes += sizes[k];
    const int64_t dts = ts[k];
    if (k > 1 && dts == kNoTs) {
      if (k > 30 && fps_first != INT64_MIN) {
        double us = double(fps_last - fps_first) * tb_num * 1000000.0 / tb_den;
        if (std::floor(us + 0.5) >= 5000000) break;
      }
    } else if (k > 1) {
      if (fps_last != INT64_MIN && fps_last >= dts)        // not increasing
        fps_first = fps_last = INT64_MIN;
      if (fps_last != INT64_MIN && last_idx > first_idx &&
          int64_t(uint64_t(dts - fps_last) / 1000) >
              (fps_last - fps_first) / (last_idx - first_idx))
        fps_first = fps_last = INT64_MIN;                    // a jump
      if (fps_first == INT64_MIN) {
        fps_first = dts;
        first_idx = int(k);
      }
      fps_last = dts;
      last_idx = int(k);
      // max_analyze_duration (5 s), timed by the decode times past 30.
      if (k > 30 && fps_first != INT64_MIN) {
        double us = double(fps_last - fps_first) * tb_num * 1000000.0 / tb_den;
        if (std::floor(us + 0.5) >= 5000000) break;
      }
    }
    if (dts == kNoTs) continue;
    // ff_rfps_add_frame
    if (last != INT64_MIN && dts > last) {
      double t = double(dts) * tbq;
      int64_t duration = dts - last;
      for (int i = 0; i < kStd; ++i) {
        if (err(0, 1, i) >= 1e10) continue;
        double sdts = t * double(std_rate(i)) / (1001 * 12);
        for (int j = 0; j < 2; ++j) {
          int64_t ticks = std::llrint(sdts + j * 0.5);
          double e = sdts - double(ticks) + j * 0.5;
          err(j, 0, i) += e;
          err(j, 1, i) += e * e;
        }
      }
      ++count;
      sum += duration;
      if (count % 10 == 0) {
        for (int i = 0; i < kStd; ++i) {
          if (err(0, 1, i) >= 1e10) continue;
          double a0 = err(0, 0, i) / count;
          double e0 = err(0, 1, i) / count - a0 * a0;
          double a1 = err(1, 0, i) / count;
          double e1 = err(1, 1, i) / count - a1 * a1;
          if (e0 > 0.04 && e1 > 0.04) err(0, 1, i) = err(1, 1, i) = 2e10;
        }
      }
      if (count > 3) divisor = gcd64(divisor, duration);
    }
    last = dts;
  }
  // ff_rfps_calculate
  if (count > 15 && divisor > std::max<int64_t>(1, tb_den / (500 * tb_num))) {
    av_reduce(num, den, tb_den, tb_num * divisor, 0x7FFFFFFF);
    return;
  }
  if (count > 1) {
    int64_t best = 0;
    double best_error = 0.01;
    for (int j = 0; j < kStd; ++j) {
      if (std_rate(j) < 1001 * 12) continue;
      if (tbq * double(sum) / count < (1001 * 12.0 * 0.8) / std_rate(j))
        continue;
      for (int k = 0; k < 2; ++k) {
        double a = err(k, 0, j) / count;
        double e = err(k, 1, j) / count - a * a;
        if (e < best_error && best_error > 0.000000001) {
          best_error = e;
          best = std_rate(j);
        }
      }
    }
    // At most 1% above the time base's rate.
    if (best && double(best) / (12 * 1001) < 1.01 * tb_den / tb_num)
      av_reduce(num, den, best, 12 * 1001, 0x7FFFFFFF);
  }
}

const char* codec_label(Codec c) {
  return c == Codec::kH264    ? "H.264"
         : c == Codec::kHevc  ? "HEVC"
         : c == Codec::kMpeg4 ? "MPEG-4 Part 2"
                              : "MPEG-1/2";
}

// The frame rate cv2 reports for a Matroska track without
// DefaultDuration whose codec gives one (found by probing cv2 5.0's
// libavformat 62 and held by tests/test_torch_video_muxers.py):
// libavcodec's rate F from the stream's headers (H.264's and HEVC's VUI
// timing, MPEG-4's VOL, MPEG-1/2's frame_rate_code). MPEG-4 and MPEG-1,
// whose rate libavformat trusts when F (MPEG-1: 2F, its fields) lies in
// [5, 101) fps, report it; otherwise, and always for H.264, HEVC and
// MPEG-2 (tb_unreliable), cv2 reports libavformat's average rate: every
// packet the duration floor(1/F) in time-base ticks
// (compute_frame_duration; none from F ≥ 1000 fps), one over it rounded
// to a standard rate (get_std_framerate) within 1%. Where no packet gets
// a duration, libavformat's estimate from the blocks' timestamps
// (false, for rfps_estimate) serves MPEG-4 and MPEG-1/2; H.264 and HEVC
// then raise, as without timing in their headers (libavformat estimates
// from timestamps it reorders and leaves out, which is not copied).
bool mkv_stream_rate(const Track& t, int64_t tn, int64_t td, int64_t& num,
                     int64_t& den) {
  if (t.codec != Codec::kH264 && t.codec != Codec::kHevc &&
      t.codec != Codec::kMpeg4 && t.codec != Codec::kMpeg12)
    return false;
  // The headers of the CodecPrivate, then of each packet, until a rate.
  int64_t cn = 0, cd = 1;
  bool have = false, mpeg2 = false;
  auto packets = [&](auto read, auto rate) {
    for (size_t i = 0; !(have = rate()) && i < t.packets.size(); ++i)
      read(&t.file[t.packets[i].off], t.packets[i].size);
  };
  if (t.codec == Codec::kH264) {
    H264Decoder q(t.config);
    packets([&](const uint8_t* d, size_t n) { q.headers(d, n); },
            [&] { return q.frame_rate(cn, cd); });
  } else if (t.codec == Codec::kHevc) {
    HevcDecoder q(t.config);
    packets([&](const uint8_t* d, size_t n) { q.headers(d, n); },
            [&] { return q.frame_rate(cn, cd); });
  } else if (t.codec == Codec::kMpeg4) {
    Mpeg4Decoder q(t.config, t.tag);
    packets([&](const uint8_t* d, size_t n) { q.peek(d, n); },
            [&] { return q.frame_rate(cn, cd); });
  } else {
    Mpeg12Decoder q(t.config, t.tag);
    packets([&](const uint8_t* d, size_t n) { q.headers(d, n); },
            [&] { return q.frame_rate(cn, cd, mpeg2); });
  }
  bool h26x = t.codec == Codec::kH264 || t.codec == Codec::kHevc;
  if (!have && h26x)
    unsupported(std::string("Matroska ") + codec_label(t.codec) +
                " track without DefaultDuration or timing in its " +
                (t.codec == Codec::kH264 ? "VUI" : "SPS's VUI") +
                " (cv2's rate would be libavformat's estimate from "
                "timestamps it reorders)");
  if (!have) return false;
  if (t.codec == Codec::kMpeg4 || (t.codec == Codec::kMpeg12 && !mpeg2)) {
    int64_t mul = t.codec == Codec::kMpeg4 ? 1 : 2;
    if (cn * mul < 101 * cd && cn * mul >= 5 * cd) {
      av_reduce(num, den, cn * mul, cd, 0x7FFFFFFF);
      // av_cmp_q(time_base, 1 / rate) > 0: the time base's rate
      if (tn * num > td * den) av_reduce(num, den, td, tn, 0x7FFFFFFF);
      return true;
    }
  }
  // compute_frame_duration → the packets' duration in ticks
  int64_t ticks = 0;
  if (tn * 1000 > td) ticks = 1;
  else if (cd * 1000 > cn)
    ticks = int64_t(__int128(cd) * td / (__int128(cn) * tn));
  if (ticks <= 0) {
    if (h26x)
      unsupported(std::string("Matroska ") + codec_label(t.codec) +
                  " track without DefaultDuration at a stream rate of "
                  "1000 fps or more (cv2's rate would be libavformat's "
                  "estimate from timestamps it reorders)");
    return false;
  }
  av_reduce(num, den, td, ticks * tn, 60000);
  // Rounded to a standard rate within 1%.
  double avg = double(num) / double(den), best_error = 0.01;
  int64_t best = 0;
  for (int j = 0; j < kStdRates; ++j) {
    double error = std::fabs(avg * (12 * 1001) / double(std_rate(j)) - 1);
    if (error < best_error) {
      best_error = error;
      best = std_rate(j);
    }
  }
  if (best) av_reduce(num, den, best, 12 * 1001, 0x7FFFFFFF);
  return true;
}

void demux_mkv(Track& t) {
  const std::vector<uint8_t>& f = t.file;
  t.container = "Matroska";
  Ebml e{f, 0, f.size()};
  if (ebml_id(e) != 0x1A45DFA3) broken("not a Matroska file");
  uint64_t hs = ebml_vint(f, e.p, e.end);
  if (hs == kUnknown || e.p + hs > e.end) broken("Matroska header is bad");
  e.p += hs;
  if (ebml_id(e) != 0x18538067) broken("Matroska file without a segment");
  uint64_t ss = ebml_vint(f, e.p, e.end);
  size_t seg_end = ss == kUnknown ? f.size()
                                  : std::min<size_t>(f.size(), e.p + ss);
  uint64_t scale = 1000000, track = 0, default_duration = 0;
  double duration = 0.0;
  bool have_track = false;
  int64_t cluster = 0;              // the cluster's Timestamp
  std::vector<int64_t> stamps;      // the video frames' timestamps
  std::vector<MkvEncoding> encodings;
  const MkvEncoding* frame_enc = nullptr;   // undone on every frame
  // Elements whose children are read: Segment's masters, then clusters.
  struct Level {
    size_t end;
    uint32_t id;
  };
  std::vector<Level> levels = {{seg_end, 0x18538067}};
  bool in_group = false, referenced = false;
  size_t block = 0, block_end = 0;
  while (!levels.empty()) {
    Level& lv = levels.back();
    if (e.p >= lv.end) {
      if (lv.id == 0xA0 && block)                 // end of a BlockGroup
        mkv_block(t, block, block_end, track, false, referenced, cluster,
                  stamps, frame_enc);
      if (lv.id == 0xA0) in_group = false;
      e.p = std::max(e.p, lv.end);
      levels.pop_back();
      continue;
    }
    size_t start = e.p;
    uint32_t id = ebml_id(e);
    uint64_t sz = ebml_vint(f, e.p, lv.end);
    // An unknown-size cluster ends where an element of a higher level
    // begins.
    if (lv.id == 0x1F43B675 && lv.end == seg_end && mkv_top_level(id) &&
        levels.size() > 1) {
      e.p = start;
      levels.pop_back();
      continue;
    }
    size_t body = e.p;
    size_t end = sz == kUnknown ? lv.end : body + sz;
    if (end > lv.end) {
      if (lv.id == 0x18538067) end = lv.end;     // a file cut short
      else broken("Matroska element runs past its parent");
    }
    switch (id) {
      case 0x1549A966:                            // Info
      case 0x1654AE6B:                            // Tracks
      case 0xE0:                                  // Video
        levels.push_back({end, id});
        continue;
      case 0xAE:                                  // TrackEntry
        if (!have_track) {
          // Read the entry; keep it if it is the first video track.
          Track cand;
          uint64_t number = 0, type = 0, dd = 0;
          std::string codec;
          std::vector<uint8_t> priv;
          int w = 0, h = 0;
          bool projected = false;
          std::vector<MkvEncoding> encs;
          uint64_t projection = 0;
          std::vector<uint8_t> colour_space;
          double yaw = 0.0, pitch = 0.0, roll = 0.0;
          std::vector<std::pair<size_t, size_t>> st = {{body, end}};
          while (!st.empty()) {
            auto [q, qe] = st.back();
            st.pop_back();
            Ebml c{f, q, qe};
            while (c.p < qe) {
              uint32_t cid = ebml_id(c);
              uint64_t cs = ebml_vint(f, c.p, qe);
              if (cs == kUnknown || c.p + cs > qe)
                broken("Matroska track entry is bad");
              size_t cb = c.p;
              c.p += cs;
              if (cid == 0xD7) number = ebml_uint(f, cb, cs);
              else if (cid == 0x83) type = ebml_uint(f, cb, cs);
              else if (cid == 0x86)
                codec.assign(reinterpret_cast<const char*>(&f[cb]), cs);
              else if (cid == 0x63A2) priv.assign(f.begin() + cb,
                                                  f.begin() + cb + cs);
              else if (cid == 0x23E383) dd = ebml_uint(f, cb, cs);
              else if (cid == 0xB0) w = int(ebml_uint(f, cb, cs));
              else if (cid == 0xBA) h = int(ebml_uint(f, cb, cs));
              else if (cid == 0x6D80) encs = mkv_encodings(f, cb, cb + cs);
              else if (cid == 0xE0) st.push_back({cb, cb + cs});
              else if (cid == 0x7670) {                 // Projection
                projected = true;
                st.push_back({cb, cb + cs});
              } else if (cid == 0x7671) projection = ebml_uint(f, cb, cs);
              else if (cid == 0x7673) yaw = ebml_float(f, cb, cs);
              else if (cid == 0x7674) pitch = ebml_float(f, cb, cs);
              else if (cid == 0x7675) roll = ebml_float(f, cb, cs);
              else if (cid == 0x2EB524)                 // ColourSpace
                colour_space.assign(f.begin() + cb, f.begin() + cb + cs);
            }
          }
          while (!codec.empty() && codec.back() == '\0') codec.pop_back();
          if (type == 1) {
            encodings = encs;
            priv = mkv_private(encodings, priv);
            if (!encodings.empty() && (encodings[0].scope & 1) &&
                !(encodings[0].algo == 3 && encodings[0].settings.empty()))
              frame_enc = &encodings[0];
            have_track = true;
            track = number;
            default_duration = dd;
            if (projected)
              t.orientation = mkv_orientation(projection, yaw, pitch, roll);
            t.width = w;
            t.height = h;
            t.tag = codec;
            if (codec == "V_MJPEG") {
              t.codec = Codec::kMjpeg;
            } else if (codec == "V_VP8") {
              t.codec = Codec::kVp8;
            } else if (codec == "V_VP9") {
              t.codec = Codec::kVp9;
            } else if (codec == "V_MPEG4/ISO/AVC") {
              t.codec = Codec::kH264;
              t.config = priv;
              if (priv.empty())
                broken("Matroska V_MPEG4/ISO/AVC track without its avcC "
                       "CodecPrivate");
            } else if (codec == "V_MPEGH/ISO/HEVC") {
              t.codec = Codec::kHevc;
              t.config = priv;
              if (priv.empty())
                broken("Matroska V_MPEGH/ISO/HEVC track without its hvcC "
                       "CodecPrivate");
            } else if (codec == "V_UNCOMPRESSED") {
              // libavformat takes the layout from ColourSpace's fourcc.
              t.codec = Codec::kRaw;
              if (colour_space.size() == 4) {
                t.raw_tag = le32(colour_space.data());
                t.raw_tagged = true;
                t.tag = codec + " " + fourcc_str(t.raw_tag);
              }
            } else if (codec == "V_MPEG1" || codec == "V_MPEG2") {
              t.codec = Codec::kMpeg12;
              t.config = priv;
            } else if (codec == "V_MPEG4/ISO/SP" ||
                       codec == "V_MPEG4/ISO/ASP" ||
                       codec == "V_MPEG4/ISO/AP") {
              t.codec = Codec::kMpeg4;
              t.config = priv;
            } else if (codec == "V_MPEG4/MS/V3") {
              t.codec = Codec::kH263;
            } else if (codec == "V_MS/VFW/FOURCC") {
              if (priv.size() < 40)
                broken("Matroska V_MS/VFW/FOURCC without its "
                       "BITMAPINFOHEADER");
              t.tag = codec + " " + fourcc_str(le32(&priv[16]));
              t.codec = riff_codec(fourcc_str(le32(&priv[16])));
              t.config.assign(priv.begin() + 40, priv.end());
              // libavformat's ff_get_bmp_header: the bit count, the rest
              // the extradata.
              t.bits = priv[14] | (priv[15] << 8);
              t.extradata = t.config;
            } else if (codec == "V_FFV1") {
              t.codec = Codec::kFfv1;
              t.extradata = priv;
            } else if (codec == "V_SNOW") {       // cv2's writer's Snow
              t.codec = Codec::kSnow;
            }
          }
        }
        e.p = end;
        continue;
      case 0x2AD7B1:                              // TimestampScale
        scale = ebml_uint(f, body, sz);
        break;
      case 0x4489:                                // Duration
        duration = ebml_float(f, body, sz);
        break;
      case 0x1F43B675:                            // Cluster
        levels.push_back({end, id});
        continue;
      case 0xA3:                                  // SimpleBlock
        if (!have_track) broken("Matroska block before its track");
        mkv_block(t, body, end, track, true, false, cluster, stamps,
                  frame_enc);
        break;
      case 0xE7:                                  // a cluster's Timestamp
        cluster = int64_t(ebml_uint(f, body, sz));
        break;
      case 0xA0:                                  // BlockGroup
        in_group = true;
        referenced = false;
        block = 0;
        levels.push_back({end, id});
        continue;
      case 0xA1:                                  // Block
        if (in_group) {
          block = body;
          block_end = end;
        }
        break;
      case 0xFB:                                  // ReferenceBlock
        if (in_group) referenced = true;
        break;
      default:
        break;
    }
    if (sz == kUnknown) broken("Matroska element of unknown size");
    e.p = end;
  }
  if (!have_track) broken("Matroska file without a video track");
  // cv2: round(duration_sec · fps), duration from the segment's Info as
  // libavformat converts it to microseconds, fps the av_reduce'd
  // DefaultDuration, else the stream's own rate as cv2 reports it
  // (mkv_stream_rate), else libavformat's estimate from the blocks'
  // timestamps (rfps_estimate).
  if (duration <= 0.0)
    unsupported("Matroska segment without a Duration");
  int64_t dur_us = int64_t(duration * double(scale) * 1000.0 / 1000000.0);
  int64_t fn = 0, fd = 1;
  int64_t tn = 0, td = 1;                      // the time base
  av_reduce(tn, td, int64_t(scale), 1000000000, 0x7FFFFFFF);
  if (default_duration) {
    av_reduce(fn, fd, 1000000000, int64_t(default_duration), 30000);
  } else if (!mkv_stream_rate(t, tn, td, fn, fd)) {
    std::vector<uint32_t> sizes;
    for (const Packet& p : t.packets) sizes.push_back(p.size);
    if (t.codec == Codec::kMpeg4 || t.codec == Codec::kMpeg12)
      for (size_t k = 1; k < stamps.size(); ++k)
        if (stamps[k] != kNoTs && stamps[k - 1] != kNoTs &&
            stamps[k] <= stamps[k - 1])
          unsupported(std::string("Matroska ") + codec_label(t.codec) +
                      " track without DefaultDuration whose blocks are "
                      "not in presentation order, at a rate libavformat "
                      "estimates from its timestamps");
    rfps_estimate(stamps, sizes, tn, td, fn, fd);
    if (!fn)
      unsupported("Matroska track without DefaultDuration at a variable "
                  "frame rate (cv2 counts frames at its time base's rate, "
                  "and the JAX package would read the first frame only)");
  }
  double fps = fd ? double(fn) / double(fd) : 0.0;
  t.count = int64_t(std::floor(double(dur_us) / 1000000.0 * fps + 0.5));
}

// ------------------------------------------------------------ by name

Track open_track(const std::string& path) {
  Track t;
  t.file = read_file(path);
  const std::vector<uint8_t>& f = t.file;
  if (f.size() >= 12 && std::memcmp(f.data(), "RIFF", 4) == 0) {
    demux_avi(t);
  } else if (f.size() >= 4 && be32(f.data()) == 0x1A45DFA3) {
    demux_mkv(t);
  } else if (f.size() >= 8 &&
             (std::memcmp(&f[4], "ftyp", 4) == 0 ||
              std::memcmp(&f[4], "moov", 4) == 0 ||
              std::memcmp(&f[4], "mdat", 4) == 0 ||
              std::memcmp(&f[4], "free", 4) == 0 ||
              std::memcmp(&f[4], "wide", 4) == 0 ||
              std::memcmp(&f[4], "skip", 4) == 0)) {
    demux_mp4(t);
  } else {
    broken(path + ": not an AVI, MP4/MOV or Matroska/WebM file");
  }
  return t;
}

}  // namespace

// =====================================================================
// ffmpeg's simple IDCT (libavcodec/simple_idct_template.c, 8 bits)
// =====================================================================

namespace {

constexpr int W1 = 22725, W2 = 21407, W3 = 19266, W4 = 16383, W5 = 12873,
              W6 = 8867, W7 = 4520;
constexpr int kRowShift = 11, kColShift = 20;

inline uint8_t clip_u8(int v) {
  return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v);
}

void idct_row(int16_t* row) {
  if (!(row[1] | row[2] | row[3] | row[4] | row[5] | row[6] | row[7])) {
    int16_t dc = int16_t(uint16_t(row[0]) << 3);
    for (int i = 0; i < 8; ++i) row[i] = dc;
    return;
  }
  int a0 = W4 * row[0] + (1 << (kRowShift - 1));
  int a1 = a0, a2 = a0, a3 = a0;
  a0 += W2 * row[2];
  a1 += W6 * row[2];
  a2 -= W6 * row[2];
  a3 -= W2 * row[2];
  int b0 = W1 * row[1] + W3 * row[3];
  int b1 = W3 * row[1] - W7 * row[3];
  int b2 = W5 * row[1] - W1 * row[3];
  int b3 = W7 * row[1] - W5 * row[3];
  if (row[4] | row[5] | row[6] | row[7]) {
    a0 += W4 * row[4] + W6 * row[6];
    a1 += -W4 * row[4] - W2 * row[6];
    a2 += -W4 * row[4] + W2 * row[6];
    a3 += W4 * row[4] - W6 * row[6];
    b0 += W5 * row[5] + W7 * row[7];
    b1 += -W1 * row[5] - W5 * row[7];
    b2 += W7 * row[5] + W3 * row[7];
    b3 += W3 * row[5] - W1 * row[7];
  }
  row[0] = int16_t((a0 + b0) >> kRowShift);
  row[7] = int16_t((a0 - b0) >> kRowShift);
  row[1] = int16_t((a1 + b1) >> kRowShift);
  row[6] = int16_t((a1 - b1) >> kRowShift);
  row[2] = int16_t((a2 + b2) >> kRowShift);
  row[5] = int16_t((a2 - b2) >> kRowShift);
  row[3] = int16_t((a3 + b3) >> kRowShift);
  row[4] = int16_t((a3 - b3) >> kRowShift);
}

// One column → its 8 outputs (before the clip), unsigned arithmetic as
// ffmpeg's SUINT.
void idct_col(const int16_t* col, int out[8]) {
  unsigned a0 = unsigned(W4 * (col[0] + ((1 << (kColShift - 1)) / W4)));
  unsigned a1 = a0, a2 = a0, a3 = a0;
  a0 += unsigned(W2 * col[16]);
  a1 += unsigned(W6 * col[16]);
  a2 += unsigned(-W6 * col[16]);
  a3 += unsigned(-W2 * col[16]);
  unsigned b0 = unsigned(W1 * col[8]), b1 = unsigned(W3 * col[8]);
  unsigned b2 = unsigned(W5 * col[8]), b3 = unsigned(W7 * col[8]);
  b0 += unsigned(W3 * col[24]);
  b1 += unsigned(-W7 * col[24]);
  b2 += unsigned(-W1 * col[24]);
  b3 += unsigned(-W5 * col[24]);
  a0 += unsigned(W4 * col[32]);
  a1 += unsigned(-W4 * col[32]);
  a2 += unsigned(-W4 * col[32]);
  a3 += unsigned(W4 * col[32]);
  b0 += unsigned(W5 * col[40]);
  b1 += unsigned(-W1 * col[40]);
  b2 += unsigned(W7 * col[40]);
  b3 += unsigned(W3 * col[40]);
  a0 += unsigned(W6 * col[48]);
  a1 += unsigned(-W2 * col[48]);
  a2 += unsigned(W2 * col[48]);
  a3 += unsigned(-W6 * col[48]);
  b0 += unsigned(W7 * col[56]);
  b1 += unsigned(-W5 * col[56]);
  b2 += unsigned(W3 * col[56]);
  b3 += unsigned(-W1 * col[56]);
  out[0] = int(a0 + b0) >> kColShift;
  out[1] = int(a1 + b1) >> kColShift;
  out[2] = int(a2 + b2) >> kColShift;
  out[3] = int(a3 + b3) >> kColShift;
  out[4] = int(a3 - b3) >> kColShift;
  out[5] = int(a2 - b2) >> kColShift;
  out[6] = int(a1 - b1) >> kColShift;
  out[7] = int(a0 - b0) >> kColShift;
}


// libavcodec's XviD IDCT (xvididct.c, rows by TAB04/17/26/35 with their
// rounders, columns by tangent multiplies), as its SSE2 form computes it:
// row outputs saturate to 16 bits (packssdw), column sums saturate
// (paddsw, psubsw), and a row whose outputs round to 0 is zeroed.
namespace xvid {

inline int sat16(int v) { return v < -32768 ? -32768 : v > 32767 ? 32767 : v; }
inline int16_t row_out(unsigned v) { return int16_t(sat16(int(v) >> 11)); }
inline int mult(int c, int x) { return int(c * unsigned(x)) >> 16; }

const int kTab04[7] = {22725, 21407, 19266, 16384, 12873, 8867, 4520};
const int kTab17[7] = {31521, 29692, 26722, 22725, 17855, 12299, 6270};
const int kTab26[7] = {29692, 27969, 25172, 21407, 16819, 11585, 5906};
const int kTab35[7] = {26722, 25172, 22654, 19266, 15137, 10426, 5315};

void row(int16_t* in, const int* tab, int rnd) {
  const unsigned c1 = tab[0], c2 = tab[1], c3 = tab[2], c4 = tab[3],
                 c5 = tab[4], c6 = tab[5], c7 = tab[6];
  const unsigned k = c4 * unsigned(in[0]) + unsigned(rnd);
  const unsigned a0 = k + c2 * in[2] + c4 * in[4] + c6 * in[6];
  const unsigned a1 = k + c6 * in[2] - c4 * in[4] - c2 * in[6];
  const unsigned a2 = k - c6 * in[2] - c4 * in[4] + c2 * in[6];
  const unsigned a3 = k - c2 * in[2] + c4 * in[4] - c6 * in[6];
  const unsigned b0 = c1 * in[1] + c3 * in[3] + c5 * in[5] + c7 * in[7];
  const unsigned b1 = c3 * in[1] - c7 * in[3] - c1 * in[5] - c5 * in[7];
  const unsigned b2 = c5 * in[1] - c1 * in[3] + c7 * in[5] + c3 * in[7];
  const unsigned b3 = c7 * in[1] - c5 * in[3] + c3 * in[5] - c1 * in[7];
  in[0] = row_out(a0 + b0);
  in[1] = row_out(a1 + b1);
  in[2] = row_out(a2 + b2);
  in[3] = row_out(a3 + b3);
  in[4] = row_out(a3 - b3);
  in[5] = row_out(a2 - b2);
  in[6] = row_out(a1 - b1);
  in[7] = row_out(a0 - b0);
}

// One column, in place (stride 8), butterflies in the order of
// xvididct.c's idct_col_8.
void col(int16_t* in) {
  const int kTan1 = 0x32EC, kTan2 = 0x6A0A, kTan3 = 0xAB0E, kSqrt2 = 0x5A82;
  int m4 = in[56], m5 = in[40], m6 = in[24], m7 = in[8];
  int m0 = sat16(mult(kTan1, m4) + m7), m1 = sat16(mult(kTan1, m7) - m4);
  int m2 = sat16(mult(kTan3, m5) + m6), m3 = sat16(mult(kTan3, m6) - m5);
  m7 = sat16(m0 + m2);
  m4 = sat16(m1 - m3);
  m0 = sat16(m0 - m2);
  m1 = sat16(m1 + m3);
  m6 = sat16(m0 + m1);
  m5 = sat16(m0 - m1);
  m5 = sat16(2 * mult(kSqrt2, m5));
  m6 = sat16(2 * mult(kSqrt2, m6));
  m1 = in[16];
  m2 = in[48];
  m3 = sat16(mult(kTan2, m2) + m1);
  m2 = sat16(mult(kTan2, m1) - m2);
  m0 = sat16(in[0] + in[32]);
  m1 = sat16(in[0] - in[32]);
  auto butterfly = [](int& a, int& b) {
    int t = sat16(a + b);
    b = sat16(a - b);
    a = t;
  };
  butterfly(m0, m3);
  butterfly(m0, m7);
  butterfly(m3, m4);
  butterfly(m1, m2);
  butterfly(m1, m6);
  butterfly(m2, m5);
  const int out[8] = {m0, m1, m2, m3, m4, m5, m6, m7};
  for (int r = 0; r < 8; ++r) in[8 * r] = int16_t(out[r] >> 6);
}

void idct(int16_t* b) {
  static const int* const tabs[8] = {kTab04, kTab17, kTab26, kTab35,
                                     kTab04, kTab35, kTab26, kTab17};
  static const int rnds[8] = {65536, 3597, 2260, 1203, 0, 120, 512, 512};
  for (int r = 0; r < 8; ++r) row(b + 8 * r, tabs[r], rnds[r]);
  for (int c = 0; c < 8; ++c) col(b + c);
}

}  // namespace xvid
}  // namespace

void idct_put(int16_t* blk, uint8_t* dst, ptrdiff_t stride) {
  for (int r = 0; r < 8; ++r) idct_row(blk + 8 * r);
  for (int c = 0; c < 8; ++c) {
    int o[8];
    idct_col(blk + c, o);
    for (int r = 0; r < 8; ++r) dst[r * stride + c] = clip_u8(o[r]);
  }
}

void xvid_idct_put(int16_t* blk, uint8_t* dst, ptrdiff_t stride) {
  xvid::idct(blk);
  for (int i = 0; i < 64; ++i)
    dst[(i >> 3) * stride + (i & 7)] = clip_u8(blk[i]);
}

void xvid_idct_add(int16_t* blk, uint8_t* dst, ptrdiff_t stride) {
  xvid::idct(blk);
  for (int i = 0; i < 64; ++i) {
    uint8_t& d = dst[(i >> 3) * stride + (i & 7)];
    d = clip_u8(d + blk[i]);
  }
}

void idct_add(int16_t* blk, uint8_t* dst, ptrdiff_t stride) {
  for (int r = 0; r < 8; ++r) idct_row(blk + 8 * r);
  for (int c = 0; c < 8; ++c) {
    int o[8];
    idct_col(blk + c, o);
    for (int r = 0; r < 8; ++r)
      dst[r * stride + c] = clip_u8(dst[r * stride + c] + o[r]);
  }
}

// The 4-point IDCT of simple_idct.c (the 2-4-8 and 8x4/4x8 forms):
// its constants sqrt(2) · cos(k·pi/8) at 2^15 in rows (idct4row) and
// 2^12 in columns (idct4col).
void idct84_add(int16_t* blk, uint8_t* dst, ptrdiff_t stride) {
  constexpr int C1 = 3784, C2 = 1567, C3 = 2896, kShift = 17;
  for (int r = 0; r < 4; ++r) idct_row(blk + 8 * r);
  for (int c = 0; c < 8; ++c) {
    const int16_t* col = blk + c;
    int c0 = (col[0] + col[16]) * C3 + (1 << (kShift - 1));
    int c2 = (col[0] - col[16]) * C3 + (1 << (kShift - 1));
    int c1 = col[8] * C1 + col[24] * C2;
    int c3 = col[8] * C2 - col[24] * C1;
    const int o[4] = {(c0 + c1) >> kShift, (c2 + c3) >> kShift,
                      (c2 - c3) >> kShift, (c0 - c1) >> kShift};
    for (int r = 0; r < 4; ++r)
      dst[r * stride + c] = clip_u8(dst[r * stride + c] + o[r]);
  }
}

void idct48_add(int16_t* blk, uint8_t* dst, ptrdiff_t stride) {
  constexpr int R1 = 30274, R2 = 12540, R3 = 23170, kShift = 11;
  for (int r = 0; r < 8; ++r) {
    int16_t* row = blk + 8 * r;
    int a0 = row[0], a1 = row[1], a2 = row[2], a3 = row[3];
    int c0 = (a0 + a2) * R3 + (1 << (kShift - 1));
    int c2 = (a0 - a2) * R3 + (1 << (kShift - 1));
    int c1 = a1 * R1 + a3 * R2;
    int c3 = a1 * R2 - a3 * R1;
    row[0] = int16_t((c0 + c1) >> kShift);
    row[1] = int16_t((c2 + c3) >> kShift);
    row[2] = int16_t((c2 - c3) >> kShift);
    row[3] = int16_t((c0 - c1) >> kShift);
  }
  for (int c = 0; c < 4; ++c) {
    int o[8];
    idct_col(blk + c, o);
    for (int r = 0; r < 8; ++r)
      dst[r * stride + c] = clip_u8(dst[r * stride + c] + o[r]);
  }
}

// =====================================================================
// MJPEG, the conversion to BGR24, the resize
// =====================================================================

namespace {

// Whether a JPEG's headers carry the comment "CS=ITU601", by which
// libavcodec's MJPEG decoder takes its YCbCr as limited range (the
// yuv4xxp formats, as ffmpeg's encoder writes them) instead of yuvj.
bool itu601_comment(const uint8_t* d, size_t n) {
  size_t p = 2;
  while (p + 4 <= n && d[p] == 0xFF) {
    uint8_t m = d[p + 1];
    if (m == 0xFF) {
      ++p;
      continue;
    }
    if (m == 0xDA || m == 0xD9) break;
    size_t len = (size_t(d[p + 2]) << 8) | d[p + 3];
    if (len < 2 || p + 2 + len > n) break;
    if (m == 0xFE && len - 2 == 10 &&
        std::memcmp(d + p + 4, "CS=ITU601", 10) == 0)
      return true;
    p += 2 + len;
  }
  return false;
}

// Where a JPEG ends: after its EOI marker (its entropy-coded data
// skipped, stuffed and restart markers in it), else n.
size_t jpeg_end(const uint8_t* d, size_t n) {
  size_t p = 2;
  while (p + 1 < n) {
    if (d[p] != 0xFF) {
      ++p;
      continue;
    }
    const int m = d[p + 1];
    if (m == 0xFF) {
      ++p;
      continue;
    }
    if (m == 0xD9) return p + 2;
    if (m == 0x01 || m == 0x00 || (m >= 0xD0 && m <= 0xD8)) {
      p += 2;
      continue;
    }
    if (p + 4 > n) break;
    p += 2 + ((size_t(d[p + 2]) << 8) | d[p + 3]);
    if (m != 0xDA) continue;
    while (p + 1 < n && !(d[p] == 0xFF && d[p + 1] != 0 &&
                          !(d[p + 1] >= 0xD0 && d[p + 1] <= 0xD7)))
      ++p;
  }
  return n;
}

// One MJPEG packet → planes in the layout libavcodec's MJPEG decoder
// gives it (its sampling factors halved where all are even, as it does):
// Y 2x2 with Cb, Cr 1x1 is 4:2:0, Y 2x1 4:2:2, Y 1x2 4:4:0, Y 4x1 4:1:1,
// all 1x1 4:4:4, one component grey; full range unless a CS=ITU601
// comment says limited. `fields`: the stream's first picture was under
// 3/4 of the container's height, so libavcodec reads every packet as a
// field pair (AVI1: two JPEGs, whatever polarity their APP0 gives), the
// first field's rows the even lines of each plane and the second's the
// odd, woven at twice their height; `bottom_first` the other way round
// (libavcodec's interlace_polarity, which it sets for the codec tag
// MJPG). cv2 converts the frame as progressive.
void decode_mjpeg(const uint8_t* data, size_t n, bool fields,
                  bool bottom_first, Picture& out) {
  if (fields) {
    size_t end = jpeg_end(data, n), next = end;
    while (next + 1 < n && !(data[next] == 0xFF && data[next + 1] == 0xD8))
      ++next;
    if (next + 1 >= n)
      unsupported("MJPEG field pairs (AVI1) with one field in a packet");
    Picture a, b;
    decode_mjpeg(data, end, false, false, a);
    decode_mjpeg(data + next, n - next, false, false, b);
    if (bottom_first) std::swap(a, b);
    if (a.w != b.w || a.h != b.h || a.grey != b.grey ||
        a.xshift != b.xshift || a.yshift != b.yshift ||
        a.full_range != b.full_range || a.ystride != b.ystride ||
        a.cstride != b.cstride || a.y.size() != b.y.size() ||
        a.u.size() != b.u.size())
      unsupported("MJPEG field pairs (AVI1) of unlike fields");
    auto weave = [](const std::vector<uint8_t>& top,
                    const std::vector<uint8_t>& bottom, int stride,
                    std::vector<uint8_t>& dst) {
      size_t rows = stride ? top.size() / size_t(stride) : 0;
      dst.resize(2 * top.size());
      for (size_t r = 0; r < rows; ++r) {
        std::memcpy(&dst[2 * r * stride], &top[r * stride], size_t(stride));
        std::memcpy(&dst[(2 * r + 1) * stride], &bottom[r * stride],
                    size_t(stride));
      }
    };
    out = a;
    out.h = 2 * a.h;
    weave(a.y, b.y, a.ystride, out.y);
    if (!a.grey) {
      weave(a.u, b.u, a.cstride, out.u);
      weave(a.v, b.v, a.cstride, out.v);
    }
    return;
  }
  viai_jpeg::Coefficients c;
  try {
    c = viai_jpeg::decode_coefficients(data, n, true);
  } catch (const viai_jpeg::Error& e) {
    throw Error{e.code, "MJPEG: " + e.msg};
  }
  // libavcodec's pix_fmt_id: (h, v) of each component, a nibble each.
  uint32_t id = 0;
  for (int i = 0; i < c.ncomp && i < 4; ++i)
    id |= (uint32_t(c.comp[i].h) << (28 - 8 * i)) |
          (uint32_t(c.comp[i].v) << (24 - 8 * i));
  if (!(id & 0xD0D0D0D0)) id -= (id & 0xF0F0F0F0) >> 1;
  if (!(id & 0x0D0D0D0D)) id -= (id & 0x0F0F0F0F) >> 1;
  bool grey = false;
  int xs = 1, ys = 1;
  if (c.ncomp == 1) {
    grey = true;                  // gray, whatever its sampling factors
  } else if (c.ncomp == 3 && (id & 0xFFFF) == 0x1100) {
    if (id == 0x22111100) xs = ys = 1;
    else if (id == 0x21111100) xs = 1, ys = 0;
    else if (id == 0x11111100) xs = ys = 0;
    else if (id == 0x12111100) xs = 0, ys = 1;
    else if (id == 0x41111100) xs = 2, ys = 0;
    else id = 0;
  } else {
    id = 0;
  }
  if (!grey && (c.ncomp != 3 || !id)) {
    std::string f;
    for (int i = 0; i < c.ncomp; ++i)
      f += std::string(i ? ", " : "") + std::to_string(c.comp[i].h) + "x" +
           std::to_string(c.comp[i].v);
    unsupported("MJPEG of " + std::to_string(c.ncomp) + " components "
                "sampled " + f + " (libavcodec converts or refuses it; "
                "4:2:0, 4:2:2, 4:4:4, 4:4:0, 4:1:1 YCbCr and grey are "
                "read)");
  }
  out.w = c.width;
  out.h = c.height;
  out.xshift = xs;
  out.yshift = ys;
  out.grey = grey;
  out.full_range = !itu601_comment(data, n);
  out.matrix = 5;
  std::vector<uint8_t>* planes[3] = {&out.y, &out.u, &out.v};
  for (int i = 0; i < c.ncomp; ++i) {
    viai_jpeg::Plane& p = c.comp[i];
    int pw = p.bw * 8, ph = p.cbh * 8;
    std::vector<uint8_t>& dst = *planes[i];
    dst.assign(size_t(pw) * ph, 0);
    int16_t blk[64];
    for (int by = 0; by < p.cbh; ++by)
      for (int bx = 0; bx < p.cbw; ++bx) {
        const int16_t* src = &p.coef[(size_t(by) * p.bw + bx) * 64];
        for (int k = 0; k < 64; ++k)
          blk[k] = int16_t(int(src[k]) * p.q[k]);
        // ffmpeg's DC predictor starts at 4 << 8: the level shift.
        blk[0] = int16_t(std::min(std::max(int(src[0]) * p.q[0] + 1024,
                                           -32768), 32767));
        idct_put(blk, &dst[size_t(by) * 8 * pw + bx * 8], pw);
      }
    if (i == 0) out.ystride = pw;
    else out.cstride = pw;
  }
  if (grey) {
    out.u.clear();
    out.v.clear();
  }
}

// libswscale's roundToInt16 of a 16.16 value.
int round16(int64_t f) {
  int64_t r = (f + (1 << 15)) >> 16;
  return int(std::max<int64_t>(std::min<int64_t>(r, 0x7FFF), -0x7FFF));
}

// swscale's YUV → RGB constants (ff_yuv2rgb_c_init_tables): the matrix's
// coefficients (ff_yuv2rgb_coeffs[matrix], the colour space cv2 passes on
// from the decoded frame) scaled by 224/255 for full range, or the luma
// by 255/219 for limited, as 16.16 values (cy ... oy), and as the 16-bit
// factors of its x86 code (y ... yoff).
struct BgrCoeffs {
  int64_t cy, crv, cbu, cgu, cgv, oy;
  int y, vr, ub, vg, ug, yoff;
};

// ff_yuv2rgb_coeffs[matrix] (swscale's default for an unknown one).
const int* yuv2rgb_table(int matrix) {
  static const int kTable[11][4] = {
      {104597, 132201, 25675, 53279}, {117489, 138438, 13975, 34925},
      {104597, 132201, 25675, 53279}, {104597, 132201, 25675, 53279},
      {104448, 132798, 24759, 53109}, {104597, 132201, 25675, 53279},
      {104597, 132201, 25675, 53279}, {117579, 136230, 16907, 35559},
      {0, 0, 0, 0},                   {110013, 140363, 12277, 42626},
      {110013, 140363, 12277, 42626}};
  if (matrix < 0 || matrix > 10 || matrix == 8) matrix = 5;
  return kTable[matrix];
}

BgrCoeffs bgr_coeffs(bool full, int matrix) {
  const int* t = yuv2rgb_table(matrix);
  int64_t crv = t[0], cbu = t[1], cgu = -t[2], cgv = -t[3];
  int64_t cy = 1 << 16, oy = 0;
  if (full) {
    crv = crv * 224 / 255;
    cbu = cbu * 224 / 255;
    cgu = cgu * 224 / 255;
    cgv = cgv * 224 / 255;
  } else {
    cy = (cy * 255) / 219;
    oy = 16 << 16;
  }
  return {cy, crv, cbu, cgu, cgv, oy,
          round16(cy << 13), round16(crv << 13), round16(cbu << 13),
          round16(cgv << 13), round16(cgu << 13), round16(oy << 3)};
}

inline int pmulhw(int a, int b) { return (a * b) >> 16; }
inline int wrap16(int v) { return int(int16_t(uint16_t(v))); }

// swscale's x86 YUV → BGR24 of one pixel: 16-bit fixed-point products
// (pmulhw) of Y·8 and (U, V)·8 − 1024 (`y8`, `u8`, `v8`: those 16-bit
// lanes), saturated to 0..255.
inline void simd_pixel(const BgrCoeffs& k, int y8, int u8, int v8,
                       uint8_t* o) {
  int yy = pmulhw(wrap16(y8 - k.yoff), k.y);
  int u = wrap16(u8 - 1024), v = wrap16(v8 - 1024);
  o[0] = clip_u8(wrap16(yy + pmulhw(u, k.ub)));
  o[1] = clip_u8(wrap16(yy + wrap16(pmulhw(u, k.ug) + pmulhw(v, k.vg))));
  o[2] = clip_u8(wrap16(yy + pmulhw(v, k.vr)));
}

// ------------------------------------------------ swscale's scaler path
//
// cv2 asks swscale for BGR24 at the same size with SWS_BICUBIC. For
// yuv420p/yuvj420p and 4:2:2 of even height it takes the unscaled x86
// converter (simd_pixel, each chroma sample for its 2x2 or 2x1 pixels);
// gray it copies to B, G and R (its palette path); everything else goes
// through the generic scaler, which the rest of this section copies from
// libswscale 9.5 (as cv2's wheel bundles it, x86 with MMXEXT; held
// against it on random planes of every layout and of sizes from 1x1):
//
//   * a horizontal and a vertical filter for each plane from initFilter's
//     fixed-point bicubic (B 0, C 0.6): luma at 1:1 is one tap; chroma is
//     resampled to the luma's lines and to half or all of its columns
//     (all for 4:4:4 input and odd widths: "full chroma", else half,
//     each for 2 pixels), centred as get_local_pos places it;
//   * the horizontal pass (hScale8To15): 15-bit lines;
//   * full chroma: the C output (yuv2rgb_full_{1,X}_c, 30-bit products);
//     else the MMXEXT output (yuv2bgr24_{1,X}: pmulhw sums with a
//     rounder of 4, then simd_pixel) for every line but the last two,
//     which its C output (yuv2rgb_{1,X}_c) writes through lookup tables.

namespace sws {

struct Filter {
  int size = 0;
  std::vector<int> pos;        // first source sample of each output
  std::vector<int> coef;       // size coefficients each, summing to `one`
};

int64_t rounded_div(int64_t a, int64_t b) {
  return (a >= 0 ? a + (b >> 1) : a - (b >> 1)) / b;
}

int av_log2(int v) {
  int n = 0;
  while (v > 1) {
    v >>= 1;
    ++n;
  }
  return n;
}

// initFilter for SWS_BICUBIC: `inc` source samples an output sample in
// 16.16; `align` the x86 alignment of the filter size (4 horizontal, 2
// vertical), `one` the sum (1 << 14 horizontal, 1 << 12 vertical);
// positions in 1/256 of a sample (get_local_pos).
Filter init_filter(int64_t inc, int src_n, int dst_n, int align, int one,
                   int src_pos, int dst_pos) {
  const int64_t fone = int64_t(1) << (54 - std::min(av_log2(src_n / dst_n), 8));
  int fsize;
  std::vector<int64_t> f;
  std::vector<int> pos(dst_n);
  if (std::abs(inc - 0x10000) < 10 && src_pos == dst_pos) {
    fsize = 1;
    f.assign(dst_n, fone);
    for (int i = 0; i < dst_n; ++i) pos[i] = i;
  } else {
    const int size_factor = 4;
    fsize = inc <= (1 << 16) ? 1 + size_factor
                             : 1 + (size_factor * src_n + dst_n - 1) / dst_n;
    fsize = std::max(std::min(fsize, src_n - 2), 1);
    f.assign(size_t(dst_n) * fsize, 0);
    const int64_t B = 0, C = int64_t(0.6 * (1 << 24));
    int64_t x_dst_in_src =
        ((dst_pos * inc) >> 7) - ((src_pos * 0x10000LL) >> 7);
    for (int i = 0; i < dst_n; ++i) {
      int xx = int((x_dst_in_src - (fsize - 2) * (int64_t(1) << 16)) /
                   (1 << 17));
      pos[i] = xx;
      for (int j = 0; j < fsize; ++j) {
        int64_t d = std::abs(int64_t(xx) * (1 << 17) - x_dst_in_src) << 13;
        if (inc > 1 << 16) d = d * dst_n / src_n;
        int64_t coeff;
        if (d >= int64_t(1) << 31) {
          coeff = 0;
        } else {
          int64_t dd = (d * d) >> 30, ddd = (dd * d) >> 30;
          if (d < int64_t(1) << 30)
            coeff = (12 * (1 << 24) - 9 * B - 6 * C) * ddd +
                    (-18 * (1 << 24) + 12 * B + 6 * C) * dd +
                    (6 * (1 << 24) - 2 * B) * (int64_t(1) << 30);
          else
            coeff = (-B - 6 * C) * ddd + (6 * B + 30 * C) * dd +
                    (-12 * B - 48 * C) * d +
                    (8 * B + 24 * C) * (int64_t(1) << 30);
        }
        coeff /= (int64_t(1) << 54) / fone;
        f[size_t(i) * fsize + j] = coeff;
        ++xx;
      }
      x_dst_in_src += 2 * inc;
    }
  }
  // Drop near-zero taps on the left (shifting) and count those on the
  // right: the smallest size that keeps every output's taps.
  int min_size = 0;
  for (int i = dst_n - 1; i >= 0; --i) {
    int64_t* r = &f[size_t(i) * fsize];
    int m = fsize;
    int64_t cut = 0;
    for (int j = 0; j < fsize; ++j) {
      cut += std::abs(r[0]);
      if (double(cut) > 0.002 * double(fone)) break;
      if (i < dst_n - 1 && pos[i] >= pos[i + 1]) break;
      for (int k = 1; k < fsize; ++k) r[k - 1] = r[k];
      r[fsize - 1] = 0;
      ++pos[i];
    }
    cut = 0;
    for (int j = fsize - 1; j > 0; --j) {
      cut += std::abs(r[j]);
      if (double(cut) > 0.002 * double(fone)) break;
      --m;
    }
    min_size = std::max(min_size, m);
  }
  if (min_size == 1 && align == 2) align = 1;
  const int size = (min_size + align - 1) & ~(align - 1);
  std::vector<int64_t> g(size_t(dst_n) * size, 0);
  for (int i = 0; i < dst_n; ++i)
    for (int j = 0; j < size && j < fsize; ++j)
      g[size_t(i) * size + j] = f[size_t(i) * fsize + j];
  // Fold taps outside the source onto its edge samples.
  for (int i = 0; i < dst_n; ++i) {
    int64_t* r = &g[size_t(i) * size];
    if (pos[i] < 0) {
      for (int j = 1; j < size; ++j) {
        int left = std::max(j + pos[i], 0);
        r[left] += r[j];
        r[j] = 0;
      }
      pos[i] = 0;
    }
    if (pos[i] + size > src_n) {
      int shift = pos[i] + std::min(size - src_n, 0);
      int64_t acc = 0;
      for (int j = size - 1; j >= 0; --j)
        if (pos[i] + j >= src_n) {
          acc += r[j];
          r[j] = 0;
        }
      for (int j = size - 1; j >= 0; --j) r[j] = j < shift ? 0 : r[j - shift];
      pos[i] -= shift;
      r[src_n - 1 - pos[i]] += acc;
    }
  }
  Filter out;
  out.size = size;
  out.pos = pos;
  out.coef.assign(size_t(dst_n) * size, 0);
  for (int i = 0; i < dst_n; ++i) {
    const int64_t* r = &g[size_t(i) * size];
    int64_t sum = 0, err = 0;
    for (int j = 0; j < size; ++j) sum += r[j];
    sum = (sum + one / 2) / one;
    if (!sum) sum = 1;
    for (int j = 0; j < size; ++j) {
      int64_t v = r[j] + err;
      int64_t iv = rounded_div(v, sum);
      out.coef[size_t(i) * size + j] = int(iv);
      err = v - iv * sum;
    }
  }
  return out;
}

// get_local_pos of the default chroma position for a subsampling shift.
int local_pos(int shift) { return (((128 << shift) - 128) + 128) >> shift; }

int64_t step(int src_n, int dst_n) {
  return ((int64_t(src_n) << 16) + (dst_n >> 1)) / dst_n;
}

// hScale8To15 (8-bit samples) or hScale16To15 (`depth` 9 to 16 bits in
// uint16_t; `depth` 0: the 14-bit lines of planar RGB input below 16
// bits) of a plane's rows → (rows, dst_n) 15-bit samples.
template <class T>
std::vector<int> hscale(const T* src, int stride, int rows, const Filter& f,
                        int dst_n, int depth) {
  const int sh = depth == 0 ? 13 : depth > 8 ? depth - 1 : 7;
  std::vector<int> out(size_t(rows) * dst_n);
  for (int y = 0; y < rows; ++y) {
    const T* s = src + size_t(y) * stride;
    for (int i = 0; i < dst_n; ++i) {
      const int* c = &f.coef[size_t(i) * f.size];
      int val = 0;
      for (int j = 0; j < f.size; ++j)
        if (c[j]) val += s[f.pos[i] + j] * c[j];
      out[size_t(y) * dst_n + i] = std::min(val >> sh, (1 << 15) - 1);
    }
  }
  return out;
}

// The C output's lookup tables (ff_yuv2rgb_c_init_tables at 24 bits): a
// clipped luma ramp, read at Y plus each chroma term's offset.
struct Tables {
  std::vector<uint8_t> ramp;
  int64_t crv, cbu, cgu, cgv;
  int yoffs;
  Tables(const BgrCoeffs& k, bool full) : ramp(2048) {
    auto scaled = [&](int64_t c) { return (c * (1 << 16) + 0x8000) / k.cy; };
    crv = scaled(k.crv);
    cbu = scaled(k.cbu);
    cgu = scaled(k.cgu);
    cgv = scaled(k.cgv);
    yoffs = (full ? 384 : 326) + 512;
    int64_t yb = -(int64_t(384) << 16) - 512 * k.cy - k.oy;
    for (int i = 0; i < 2048; ++i, yb += k.cy)
      ramp[size_t(i)] = clip_u8(int((yb + 0x8000) >> 16));
  }
  int term(int64_t c, int x) const {
    return int(-(c >> 9) + ((int64_t(clip_u8(x)) * c) >> 16));
  }
  // yuv2rgb_write for one pair: Y1, Y2 and their U, V (U and V clipped
  // by the tables' headroom; Y read as it is: 256 from 10-bit 1022 and
  // 1023 reads the ramp one step on, as swscale's table pointers do).
  void pair(int y1, int y2, int u, int v, uint8_t* o, bool two) const {
    int r = yoffs + term(crv, v), b = yoffs + term(cbu, u);
    int g = yoffs + term(cgu, u) + term(cgv, v);
    o[0] = ramp[size_t(b + y1)];
    o[1] = ramp[size_t(g + y1)];
    o[2] = ramp[size_t(r + y1)];
    if (two) {
      o[3] = ramp[size_t(b + y2)];
      o[4] = ramp[size_t(g + y2)];
      o[5] = ramp[size_t(r + y2)];
    }
  }
};

// yuv2rgb_write_full: Y, U, V at 1 << 9 (U, V less 128 << 9) → BGR;
// `yoff` the luma offset at that scale.
inline void full_pixel(const BgrCoeffs& k, int yoff, int y, int u, int v,
                       uint8_t* o) {
  y = (y - yoff) * k.y + (1 << 21);
  int r = int(unsigned(y) + unsigned(v) * unsigned(k.vr));
  int g = int(unsigned(y) + unsigned(v) * unsigned(k.vg) +
              unsigned(u) * unsigned(k.ug));
  int b = int(unsigned(y) + unsigned(u) * unsigned(k.ub));
  if ((r | g | b) & 0xC0000000) {
    const int max30 = (1 << 30) - 1;          // av_clip_uintp2(x, 30)
    auto c30 = [&](int x) { return x & ~max30 ? (~x >> 31) & max30 : x; };
    r = c30(r);
    g = c30(g);
    b = c30(b);
  }
  o[0] = uint8_t(b >> 22);
  o[1] = uint8_t(g >> 22);
  o[2] = uint8_t(r >> 22);
}

// swscale's RGB-to-YUV table (fill_rgb2yuv_table, at 15 bits, for
// limited range: its RGB input always) of a colour space's YUV-to-RGB
// coefficients; swscale's default space has its own rounded constants.
struct Rgb2Yuv {
  int ry, gy, by, ru, gu, bu, rv, gv, bv;
};

Rgb2Yuv rgb2yuv(int matrix) {
  const int* t = yuv2rgb_table(matrix);
  const int64_t one = 65536, vr = t[0], ub = t[1], ug = -t[2], vg = -t[3];
  if (vr == 104597 && ub == 132201 && ug == -25675 && vg == -53279) {
    auto c = [](double v) { return int(v * (1 << 15) + 0.5); };
    return {c(0.299 * 219 / 255), c(0.587 * 219 / 255),
            c(0.114 * 219 / 255), -c(0.169 * 224 / 255),
            -c(0.331 * 224 / 255), c(0.500 * 224 / 255),
            c(0.500 * 224 / 255), -c(0.419 * 224 / 255),
            -c(0.081 * 224 / 255)};
  }
  const int64_t cy = one * 255 / 219;
  const int64_t W = rounded_div(one * one * ug, ub);
  const int64_t V = rounded_div(one * one * vg, vr);
  const int64_t Z = one * one - W - V;
  const int64_t Cy = rounded_div(cy * Z, one), Cu = rounded_div(ub * Z, one),
                Cv = rounded_div(vr * Z, one);
  const int64_t s = int64_t(1) << 15;
  return {int(-rounded_div(s * V, Cy)), int(rounded_div(s * one * one, Cy)),
          int(-rounded_div(s * W, Cy)), int(rounded_div(s * V, Cu)),
          int(-rounded_div(s * one * one, Cu)), int(rounded_div(s * (Z + W), Cu)),
          int(rounded_div(s * (V + Z), Cv)), int(-rounded_div(s * one * one, Cv)),
          int(rounded_div(s * W, Cv))};
}

// Samples of depth d are read as swscale's 15-bit lines: Y << (15 − d)
// (luma at 1:1 is one tap of 1 << 14, so its horizontal pass is exact).
// The picture is scaled to dw × dh: luma through its own filters, each
// output line through the vertical filters' 1-tap, 2-tap (bilinear, taps
// summing to 4096) or n-tap outputs, as swscale's packed_vscale picks
// them.
//
// 8-bit planar GBR of even width scaled to half that width or less:
// swscale reads its chroma at half the width (chrSrcHSubSample), each
// sample from a pair of pixels summed (as its rgb24ToUV_half), and
// scales those columns to the output's (still full chroma: found by
// holding random planes against cv2's libswscale).
template <class T>
std::vector<uint8_t> scaled_bgr(const Picture& p, const T* py, const T* pu,
                                const T* pv, int dw, int dh) {
  const bool half = p.rgb && p.depth == 8 && !(p.w & 1) && dw <= p.w / 2;
  const int w = p.w, h = p.h, xs = half ? 1 : p.xshift, ys = p.yshift;
  const int lsh = 15 - p.depth;
  const bool full = (p.xshift == 0 && ys == 0) || (dw & 1);
  const int dxs = full ? 0 : 1;
  const int csw = (w + (1 << xs) - 1) >> xs, csh = (h + (1 << ys) - 1) >> ys;
  const int cdw = (dw + (1 << dxs) - 1) >> dxs;
  // The source's chroma siting: av_chroma_location_enum_to_pos's x, and
  // its y where chroma rows are halved, through get_local_pos; else
  // swscale's default.
  // Planar RGB at swscale's default (its chroma siting is not passed on).
  auto src_pos = [&](int shift, bool across) {
    if (p.chroma_loc < 1 || p.chroma_loc > 6 || (!across && !shift) || p.rgb)
      return local_pos(shift);
    int l = p.chroma_loc - 1;
    int pos = across ? (l & 1) * 128 : ((l >> 1) ^ (l < 4)) * 128;
    return (pos + 128) >> shift;
  };
  Filter lh = init_filter(step(w, dw), w, dw, 4, 1 << 14, local_pos(0),
                          local_pos(0));
  Filter lv = init_filter(step(h, dh), h, dh, 2, 1 << 12, local_pos(0),
                          local_pos(0));
  Filter hf = init_filter(step(csw, cdw), csw, cdw, 4, 1 << 14,
                          src_pos(xs, true), local_pos(dxs));
  Filter vf = init_filter(step(csh, dh), csh, dh, 2, 1 << 12,
                          src_pos(ys, false), local_pos(0));
  // swscale takes RGB input's range as limited (range_override_needed).
  const BgrCoeffs k = bgr_coeffs(p.full_range && !p.rgb, p.matrix);
  std::vector<int> Y, U, V;
  if (p.rgb) {
    // Planar G, B, R (planar_rgb_to_y/uv, planar_rgb16_to_y/uv above 8
    // bits): 14-bit Y, U, V lines of limited range, scaled as 14-bit
    // input (swscale takes RGB input as 16-bit); at 16 bits 16-bit lines
    // scaled as such.
    const Rgb2Yuv t = rgb2yuv(p.matrix);
    const int d = p.depth, shift = d < 16 ? d : 14, sh = 1 + shift;
    const int64_t yoff = (int64_t(16) << (7 + d)) + (1 << shift);
    const int64_t coff = (int64_t(128) << (7 + d)) + (1 << shift);
    std::vector<uint16_t> yi(size_t(w) * h), ui(size_t(csw) * h),
        vi(ui.size());
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x) {
        const int g = py[size_t(y) * p.ystride + x];
        const int b = pu[size_t(y) * p.cstride + x];
        const int r = pv[size_t(y) * p.cstride + x];
        yi[size_t(y) * w + x] = uint16_t((int64_t(t.ry) * r +
                                          int64_t(t.gy) * g +
                                          int64_t(t.by) * b + yoff) >> sh);
        if (half) {                     // each pair of pixels summed
          if (x & 1) continue;
          const size_t at = size_t(y) * p.ystride + x + 1;
          const size_t ct = size_t(y) * p.cstride + x + 1;
          const int g2 = g + py[at], b2 = b + pu[ct], r2 = r + pv[ct];
          const size_t i = size_t(y) * csw + (x >> 1);
          ui[i] = uint16_t((int64_t(t.ru) * r2 + int64_t(t.gu) * g2 +
                            int64_t(t.bu) * b2 + 2 * coff) >> (sh + 1));
          vi[i] = uint16_t((int64_t(t.rv) * r2 + int64_t(t.gv) * g2 +
                            int64_t(t.bv) * b2 + 2 * coff) >> (sh + 1));
          continue;
        }
        if (x >= csw) continue;
        const size_t i = size_t(y) * csw + x;
        ui[i] = uint16_t((int64_t(t.ru) * r + int64_t(t.gu) * g +
                          int64_t(t.bu) * b + coff) >> sh);
        vi[i] = uint16_t((int64_t(t.rv) * r + int64_t(t.gv) * g +
                          int64_t(t.bv) * b + coff) >> sh);
      }
    const int line = d < 16 ? 0 : 16;
    Y = hscale(yi.data(), w, h, lh, dw, line);
    U = hscale(ui.data(), csw, h, hf, cdw, line);
    V = hscale(vi.data(), csw, h, hf, cdw, line);
  } else {
    if (w == dw) {                 // one tap: the samples shifted up
      Y.resize(size_t(h) * w);
      for (int y = 0; y < h; ++y)
        for (int x = 0; x < w; ++x)
          Y[size_t(y) * w + x] = lsh >= 0
                                     ? int(py[size_t(y) * p.ystride + x]) << lsh
                                     : int(py[size_t(y) * p.ystride + x]) >> -lsh;
    } else {
      Y = hscale(py, p.ystride, h, lh, dw, p.depth);
    }
    U = hscale(pu, p.cstride, csh, hf, cdw, p.depth);
    V = hscale(pv, p.cstride, csh, hf, cdw, p.depth);
  }
  const int yoff_full = round16(k.oy << 9);
  const Tables tab(k, p.full_range);
  std::vector<uint8_t> out(size_t(dw) * dh * 3);
  const int nl = lv.size, nc = vf.size;
  // Taps of 4096 in all, the second at most 4096: the 1- or 2-tap outputs.
  auto pair4096 = [](const int* c) {
    return c[0] + c[1] == 4096 && unsigned(c[1]) <= 4096u;
  };
  for (int y = 0; y < dh; ++y) {
    const int* lc = &lv.coef[size_t(y) * nl];
    const int* cc = &vf.coef[size_t(y) * nc];
    const int* l0 = &Y[size_t(lv.pos[y]) * dw];
    const int* l1 = nl > 1 ? l0 + dw : l0;
    const int* u0 = &U[size_t(vf.pos[y]) * cdw];
    const int* v0 = &V[size_t(vf.pos[y]) * cdw];
    const int* u1 = nc > 1 ? u0 + cdw : u0;
    const int* v1 = nc > 1 ? v0 + cdw : v0;
    const bool c_one = nc == 1 || (nc == 2 && pair4096(cc));
    // 1: one luma tap, chroma one or two; 2: two and two; 0: n taps.
    const int mode = nl == 1 && c_one ? 1
                     : nl == 2 && nc == 2 && pair4096(lc) && pair4096(cc)
                         ? 2 : 0;
    const int ca = nc == 1 ? 0 : cc[1], la = nl == 1 ? 0 : lc[1];
    auto lsum = [&](int x) {
      int64_t s = 0;
      for (int j = 0; j < nl; ++j) s += int64_t(l0[size_t(j) * dw + x]) * lc[j];
      return s;
    };
    auto csum = [&](const int* P0, int x) {
      int64_t s = 0;
      for (int j = 0; j < nc; ++j) s += int64_t(P0[size_t(j) * cdw + x]) * cc[j];
      return s;
    };
    uint8_t* o = &out[size_t(y) * dw * 3];
    if (full) {                                   // yuv2rgb_full_{1,2,X}_c
      for (int x = 0; x < dw; ++x) {
        int yy, u, v;
        if (mode == 1) {
          yy = l0[x] * 4;
          if (ca) {
            u = (u0[x] * (4096 - ca) + u1[x] * ca - (128 << 19)) >> 10;
            v = (v0[x] * (4096 - ca) + v1[x] * ca - (128 << 19)) >> 10;
          } else {
            u = (u0[x] - (128 << 7)) * 4;
            v = (v0[x] - (128 << 7)) * 4;
          }
        } else if (mode == 2) {
          yy = (l0[x] * (4096 - la) + l1[x] * la) >> 10;
          u = (u0[x] * (4096 - ca) + u1[x] * ca - (128 << 19)) >> 10;
          v = (v0[x] * (4096 - ca) + v1[x] * ca - (128 << 19)) >> 10;
        } else {
          yy = int(((1 << 9) + lsum(x)) >> 10);
          u = int(((1 << 9) - (int64_t(128) << 19) + csum(u0, x)) >> 10);
          v = int(((1 << 9) - (int64_t(128) << 19) + csum(v0, x)) >> 10);
        }
        full_pixel(k, yoff_full, yy, u, v, o + 3 * x);
      }
    } else if (y < dh - 2) {                      // MMXEXT
      for (int i = 0; i < cdw; ++i) {
        int u8, v8;
        if (mode == 1 && ca >= 2048) {
          u8 = ((u0[i] + u1[i]) & 0xFFFF) >> 5;
          v8 = ((v0[i] + v1[i]) & 0xFFFF) >> 5;
        } else if (mode == 1) {
          u8 = u0[i] >> 4;
          v8 = v0[i] >> 4;
        } else if (mode == 2) {
          u8 = wrap16(pmulhw(wrap16(u0[i] - u1[i]), cc[0]) + (u1[i] >> 4));
          v8 = wrap16(pmulhw(wrap16(v0[i] - v1[i]), cc[0]) + (v1[i] >> 4));
        } else {
          u8 = v8 = 4;                           // the rounder
          for (int j = 0; j < nc; ++j) {
            u8 = wrap16(u8 + pmulhw(u0[size_t(j) * cdw + i], cc[j]));
            v8 = wrap16(v8 + pmulhw(v0[size_t(j) * cdw + i], cc[j]));
          }
        }
        for (int x = 2 * i; x < 2 * i + 2 && x < dw; ++x) {
          int y8;
          if (mode == 1) {
            y8 = l0[x] >> 4;
          } else if (mode == 2) {
            y8 = wrap16(pmulhw(wrap16(l0[x] - l1[x]), lc[0]) + (l1[x] >> 4));
          } else {
            y8 = 4;
            for (int j = 0; j < nl; ++j)
              y8 = wrap16(y8 + pmulhw(l0[size_t(j) * dw + x], lc[j]));
          }
          simd_pixel(k, y8, u8, v8, o + 3 * x);
        }
      }
    } else {                                      // C, the last two lines
      auto luma = [&](int x) {
        if (mode == 1) return (l0[x] + 64) >> 7;
        if (mode == 2) return (l0[x] * (4096 - la) + l1[x] * la) >> 19;
        return int(((1 << 18) + lsum(x)) >> 19);
      };
      for (int i = 0; i < cdw; ++i) {
        int u, v;
        if (mode == 1 && ca) {
          u = (u0[i] * (4096 - ca) + u1[i] * ca + (128 << 11)) >> 19;
          v = (v0[i] * (4096 - ca) + v1[i] * ca + (128 << 11)) >> 19;
        } else if (mode == 1) {
          u = (u0[i] + 64) >> 7;
          v = (v0[i] + 64) >> 7;
        } else if (mode == 2) {
          u = (u0[i] * (4096 - ca) + u1[i] * ca) >> 19;
          v = (v0[i] * (4096 - ca) + v1[i] * ca) >> 19;
        } else {
          u = int(((1 << 18) + csum(u0, i)) >> 19);
          v = int(((1 << 18) + csum(v0, i)) >> 19);
        }
        int x = 2 * i;
        tab.pair(luma(x), x + 1 < dw ? luma(x + 1) : 0, u, v, o + 3 * x,
                 x + 1 < dw);
      }
    }
  }
  return out;
}

}  // namespace sws

// A picture → (dh, dw, 3) BGR24 (its own size when dw, dh are 0), as
// swscale converts it for cv2 with SWS_BICUBIC: above 8 bits, at another
// size and for layouts without an unscaled converter through its scaler
// (it has none from yuv420p10/yuv422p10 to bgr24); planar GBR at 8 bits
// by its unscaled planar-RGB converter.
std::vector<uint8_t> to_bgr(const Picture& p, int dw = 0, int dh = 0) {
  if (!dw || !dh) {
    dw = p.w;
    dh = p.h;
  }
  const bool same = dw == p.w && dh == p.h;
  if (!p.bgr.empty()) {
    if (!same) unsupported("an RGB picture of another size than the first");
    return p.bgr;
  }
  if (p.rgb && (p.depth > 8 || !same))
    return p.depth > 8
               ? sws::scaled_bgr(p, p.y16.data(), p.u16.data(), p.v16.data(),
                                 dw, dh)
               : sws::scaled_bgr(p, p.y.data(), p.u.data(), p.v.data(), dw,
                                 dh);
  if (p.rgb) {
    std::vector<uint8_t> out(size_t(p.w) * p.h * 3);
    for (int y = 0; y < p.h; ++y)
      for (int x = 0; x < p.w; ++x) {
        uint8_t* o = &out[(size_t(y) * p.w + x) * 3];
        o[0] = p.u[size_t(y) * p.cstride + x];
        o[1] = p.y[size_t(y) * p.ystride + x];
        o[2] = p.v[size_t(y) * p.cstride + x];
      }
    return out;
  }
  if (p.depth > 8)
    return sws::scaled_bgr(p, p.y16.data(), p.u16.data(), p.v16.data(), dw,
                           dh);
  std::vector<uint8_t> out(size_t(p.w) * p.h * 3);
  if (p.grey && !same) {
    // swscale's scaler takes grey as full range with mid chroma lines
    // (its no-chroma input), as 4:4:4 of constant chroma.
    Picture q;
    q.w = p.w;
    q.h = p.h;
    q.xshift = q.yshift = 0;
    q.ystride = q.cstride = p.ystride;
    q.full_range = true;
    q.matrix = p.matrix;
    q.u.assign(p.y.size(), 128);
    return sws::scaled_bgr(q, p.y.data(), q.u.data(), q.u.data(), dw, dh);
  }
  if (p.grey) {
    for (int y = 0; y < p.h; ++y)
      for (int x = 0; x < p.w; ++x)
        std::memset(&out[(size_t(y) * p.w + x) * 3],
                    p.y[size_t(y) * p.ystride + x], 3);
    return out;
  }
  if (p.xshift != 1 || (p.h & 1) || !same || p.scaler_only)
    return sws::scaled_bgr(p, p.y.data(), p.u.data(), p.v.data(), dw, dh);
  BgrCoeffs k = bgr_coeffs(p.full_range, p.matrix);
  for (int y = 0; y < p.h; ++y) {
    const uint8_t* yr = &p.y[size_t(y) * p.ystride];
    const uint8_t* ur = &p.u[size_t(y >> p.yshift) * p.cstride];
    const uint8_t* vr = &p.v[size_t(y >> p.yshift) * p.cstride];
    uint8_t* o = &out[size_t(y) * p.w * 3];
    for (int x = 0; x < p.w; ++x)
      simd_pixel(k, yr[x] * 8, ur[x / 2] * 8, vr[x / 2] * 8, o + 3 * x);
  }
  return out;
}

struct Taps {
  std::vector<int> i0, i1;
  std::vector<int> a0, a1;   // 11-bit weights
};

// cv::resize INTER_LINEAR's taps for one axis: float32 positions,
// saturate_cast<short>(weight · 2048); the horizontal axis clamps
// positions outside the source (the weight of the edge pixel 1), the
// vertical one keeps its weights and reads the edge row for both.
Taps linear_taps(int n_in, int n_out, bool clamp) {
  Taps t;
  double scale = double(n_in) / double(n_out);
  for (int d = 0; d < n_out; ++d) {
    float fx = float((d + 0.5) * scale - 0.5);
    int s = int(std::floor(fx));
    fx -= float(s);
    int s1 = s + 1;
    if (clamp) {
      if (s < 0) {
        fx = 0.f;
        s = 0;
      }
      if (s + 1 >= n_in) {
        fx = 0.f;
        s = n_in - 1;
      }
      s1 = std::min(s + 1, n_in - 1);
    } else {
      s = std::min(std::max(s, 0), n_in - 1);
      s1 = std::min(std::max(s1, 0), n_in - 1);
    }
    t.i0.push_back(s);
    t.i1.push_back(s1);
    t.a0.push_back(int(std::nearbyint((1.f - fx) * 2048.f)));
    t.a1.push_back(int(std::nearbyint(fx * 2048.f)));
  }
  return t;
}

// cv2.rotate of a BGR picture (h, w) by cv2's orientation: 90 degrees
// clockwise, 180 or 270 (90 counter-clockwise), as OpenCV turns what it
// reads; any other angle leaves it as it is. h and w become the turned
// picture's.
void turn_bgr(std::vector<uint8_t>& bgr, int& h, int& w, int angle) {
  if (angle != 90 && angle != 180 && angle != 270) return;
  const int oh = angle == 180 ? h : w, ow = angle == 180 ? w : h;
  std::vector<uint8_t> out(bgr.size());
  for (int y = 0; y < oh; ++y)
    for (int x = 0; x < ow; ++x) {
      int sy = angle == 90 ? h - 1 - x : angle == 270 ? x : h - 1 - y;
      int sx = angle == 90 ? y : angle == 270 ? w - 1 - y : w - 1 - x;
      std::memcpy(&out[(size_t(y) * ow + x) * 3],
                  &bgr[(size_t(sy) * w + sx) * 3], 3);
    }
  bgr.swap(out);
  h = oh;
  w = ow;
}

// cv2.resize(bgr, (size, size)) → float32 RGB / 255 into `out`.
void resize_rgb(const uint8_t* bgr, int h, int w, int size, float* out) {
  Taps tx = linear_taps(w, size, true), ty = linear_taps(h, size, false);
  std::vector<int32_t> rows(size_t(h) * size * 3);
  for (int y = 0; y < h; ++y) {
    const uint8_t* s = bgr + size_t(y) * w * 3;
    int32_t* d = &rows[size_t(y) * size * 3];
    for (int x = 0; x < size; ++x)
      for (int c = 0; c < 3; ++c)
        d[3 * x + c] = s[3 * tx.i0[x] + c] * tx.a0[x] +
                       s[3 * tx.i1[x] + c] * tx.a1[x];
  }
  for (int y = 0; y < size; ++y) {
    const int32_t* r0 = &rows[size_t(ty.i0[y]) * size * 3];
    const int32_t* r1 = &rows[size_t(ty.i1[y]) * size * 3];
    int b0 = ty.a0[y], b1 = ty.a1[y];
    float* o = out + size_t(y) * size * 3;
    for (int x = 0; x < size; ++x)
      for (int c = 0; c < 3; ++c) {
        int v = (pmulhw(int(int16_t(r0[3 * x + c] >> 4)), b0) +
                 pmulhw(int(int16_t(r1[3 * x + c] >> 4)), b1) + 2) >> 2;
        o[3 * x + 2 - c] = float(clip_u8(v)) / 255.0f;
      }
  }
}

bool mjpeg_fields(const Track& t);

// Decodes a track's pictures in order.
class Decoder {
 public:
  explicit Decoder(const Track& t) : t_(t) {
    if (t.rebased_runs)
      unsupported("MP4 track run without its data offset after another in "
                  "one track fragment (libavformat reads its samples from "
                  "the fragment's base again, the moof's or the first run's "
                  "bytes, and cv2 stops at the first packet libavcodec "
                  "refuses)");
    if (t.codec == Codec::kOther && t.container == "AVI" &&
        RawDecoder::avi_unnamed(t.raw_tag))
      broken("AVI video tagged '" + t.tag + "': libavformat's AVI demuxer "
             "names no codec for it, so cv2 reads no frame");
    if (t.codec == Codec::kOther)
      unsupported(t.container + " video coded as '" + t.tag + "' (" +
                  codec_name(fourcc_of(t)) + ")");
    if (t.codec == Codec::kRaw) {
      if (!t.raw_tagged)
        broken("Matroska V_UNCOMPRESSED track without a ColourSpace: "
               "libavcodec finds no pixel format, so cv2 reads no frame");
      raw_.reset(new RawDecoder(t.raw_tag, t.bits, t.width, t.height,
                                t.bottom_up, t.extradata, t.container));
    }
    if (t.codec == Codec::kMjpeg) fields_ = mjpeg_fields(t);
    if (t.codec == Codec::kMpeg4)
      mpeg4_.reset(new Mpeg4Decoder(t.config, t.tag));
    if (t.codec == Codec::kMpeg12)
      mpeg12_.reset(new Mpeg12Decoder(t.config, t.tag));
    if (t.codec == Codec::kVp8) vp8_.reset(new Vp8Decoder());
    if (t.codec == Codec::kVp9) vp9_.reset(new Vp9Decoder());
    if (t.codec == Codec::kH264) {
      h264_.reset(new H264Decoder(t.config));
      h264_->set_delay(probe_delay(t));
    }
    if (t.codec == Codec::kHevc) hevc_.reset(new HevcDecoder(t.config));
    if (t.codec == Codec::kFfv1)
      ffv1_.reset(new Ffv1Decoder(t.extradata, t.width, t.height,
                                  t.container));
    if (t.codec == Codec::kUtvideo) {
      const std::string tag = fourcc_of(t);
      if (!UtVideoDecoder::reads(tag))
        unsupported(t.container + " video coded as '" + t.tag + "' (" +
                    codec_name(tag) + ")");
      ut_.reset(new UtVideoDecoder(tag, t.extradata, t.width, t.height));
    }
    if (t.codec == Codec::kHuffyuv)
      huffyuv_.reset(
          new HuffyuvDecoder(t.bits, t.extradata, t.width, t.height));
    if (t.codec == Codec::kH263) h263_ = h263_of(t);
    if (t.codec == Codec::kH261) h261_.reset(new H261Decoder());
    if (t.codec == Codec::kMagicyuv) magicyuv_.reset(new MagicyuvDecoder());
    if (t.codec == Codec::kAsv)
      asv_.reset(new AsvDecoder(upper(fourcc_of(t)) == "ASV1" ? 1 : 2,
                                t.extradata, t.width, t.height));
    if (t.codec == Codec::kSnow)
      snow_.reset(new SnowDecoder(t.width, t.height));
  }

  // The fourcc an H.263-family track's decoder is named by (Matroska's
  // V_MPEG4/MS/V3 is MS-MPEG4 v3, MP4's s263 and h263 are H.263).
  static std::string h263_tag(const Track& t) {
    if (t.tag == "V_MPEG4/MS/V3") return "MP43";
    if (t.container == "MP4") return "H263";
    return fourcc_of(t);
  }

  // The H.263-family decoder of a track.
  static std::unique_ptr<H263Decoder> h263_of(const Track& t) {
    return std::unique_ptr<H263Decoder>(
        new H263Decoder(h263_tag(t), t.width, t.height, t.extradata));
  }

  // The fourcc of an AVI track or a Matroska V_MS/VFW/FOURCC one.
  static std::string fourcc_of(const Track& t) {
    const std::string vfw = "V_MS/VFW/FOURCC ";
    return t.tag.compare(0, vfw.size(), vfw) == 0 ? t.tag.substr(vfw.size())
                                                  : t.tag;
  }

  // Whether each packet is one picture decoded on its own (MJPEG,
  // uncompressed video, UT Video, HuffYUV, PNG, MagicYUV, ASV; FFV1's and
  // Snow's key frames only).
  bool intra() const {
    return t_.codec == Codec::kMjpeg || t_.codec == Codec::kRaw ||
           t_.codec == Codec::kUtvideo || t_.codec == Codec::kHuffyuv ||
           t_.codec == Codec::kPng || t_.codec == Codec::kMagicyuv ||
           t_.codec == Codec::kAsv;
  }

  // The reorder depth libavformat's avformat_find_stream_info leaves in
  // AVCodecParameters.video_delay, where cv2's decoder starts: the MP4
  // demuxer's guess, grown by what the probe's own decoder (one thread)
  // finds while it decodes the first pictures, until it has output 7 of
  // them (18 once its depth is 3, 20 from 4) or its depth is the SPS's
  // max_num_reorder_frames (has_decode_delay_been_guessed). Only the
  // pictures' order matters, so their macroblocks are not decoded.
  static int probe_delay(const Track& t) {
    H264Decoder probe(t.config);
    probe.headers_only();
    probe.set_delay(t.video_delay);
    int outputs = 0;
    auto guessed = [&]() {
      int d = probe.delay();
      if (d && d == probe.num_reorder_frames()) return true;
      return outputs >= (d < 3 ? 7 : d < 4 ? 18 : 20);
    };
    for (size_t i = 0; i < t.packets.size() && !guessed(); ++i)
      if (probe.step(&t.file[t.packets[i].off], t.packets[i].size)) ++outputs;
    return probe.delay();
  }

  // Packet i → a picture in `out`; false when it gives none (H.264's
  // may come from an earlier packet: packet_of tells which).
  bool decode(size_t i, Picture& out) {
    const Packet& p = t_.packets[i];
    const uint8_t* d = &t_.file[p.off];
    calls_.push_back(i);
    out.source = int64_t(calls_.size()) - 1;
    if (t_.codec == Codec::kMjpeg) {
      decode_mjpeg(d, p.size, fields_,
                   t_.tag == "MJPG" || t_.tag == "V_MS/VFW/FOURCC MJPG", out);
      return true;
    }
    if (raw_) return raw_->decode(d, p.size, out);
    if (ffv1_ || ut_ || huffyuv_ || magicyuv_ || asv_ || snow_ ||
        t_.codec == Codec::kPng) {
      if (ffv1_) ffv1_->decode(d, p.size, out);
      if (ut_) ut_->decode(d, p.size, out);
      if (huffyuv_) huffyuv_->decode(d, p.size, out);
      if (magicyuv_) magicyuv_->decode(d, p.size, out);
      if (asv_) asv_->decode(d, p.size, out);
      if (snow_) snow_->decode(d, p.size, out);
      if (t_.codec == Codec::kPng) decode_png_picture(d, p.size, out);
      out.source = int64_t(calls_.size()) - 1;
      return true;
    }
    if (vp8_) return vp8_->decode(d, p.size, out);
    if (vp9_) return vp9_->decode(d, p.size, out);
    if (h264_) return h264_->decode(d, p.size, out);
    if (hevc_) return hevc_->decode(d, p.size, out);
    if (mpeg12_) return mpeg12_->decode(d, p.size, out);
    if (h263_) return h263_->decode(d, p.size, out);
    if (h261_) return h261_->decode(d, p.size, out);
    return mpeg4_->decode(d, p.size, out);
  }

  // The last decoded packet's further pictures (a VP9 SVC superframe
  // shows one a spatial layer; HEVC outputs every picture held at an
  // IRAP picture that begins a sequence); false when none is left.
  bool more(Picture& out) {
    if (hevc_) return hevc_->next(out);
    if (!vp9_ || !vp9_->next(out)) return false;
    out.source = int64_t(calls_.size()) - 1;
    return true;
  }

  // At the end of the track: a picture the decoder still holds back
  // (H.264's reorder delay, MPEG-4's B-VOPs, MPEG-1/2's reference);
  // false when none is left.
  bool flush(Picture& out) {
    return (h264_ && h264_->flush(out)) || (hevc_ && hevc_->flush(out)) ||
           (mpeg4_ && mpeg4_->flush(out)) || (mpeg12_ && mpeg12_->flush(out));
  }

  // The packet a picture of decode() or flush() was decoded from.
  size_t packet_of(const Picture& pic) const {
    return calls_[size_t(pic.source)];
  }

  // Whether cv2 sees the picture: false for one of a packet an MP4 edit
  // marks for discarding (libavcodec drops its frame).
  bool shown(const Picture& pic) const {
    return !t_.packets[packet_of(pic)].discard;
  }

  // Read packet i's headers only (MPEG-4: a VOL it holds is kept;
  // H.264: its parameter sets and libx264's build from its SEI; MPEG-1/2:
  // its sequence headers and extensions).
  void skip(size_t i) {
    const uint8_t* d = &t_.file[t_.packets[i].off];
    if (mpeg4_) mpeg4_->peek(d, t_.packets[i].size);
    if (h264_) h264_->headers(d, t_.packets[i].size);
    if (hevc_) hevc_->headers(d, t_.packets[i].size);
    if (mpeg12_) mpeg12_->headers(d, t_.packets[i].size);
    if (h263_) h263_->peek(d, t_.packets[i].size);
  }

  // The uncompressed video decoder; null for other codecs.
  const RawDecoder* raw() const { return raw_.get(); }

  // Whether a decode may start at a keyframe: not H.261's (libavcodec
  // takes every picture for a P picture), which starts at the first.
  bool seekable() const { return !h261_; }

  static std::string codec_name(const std::string& tag) {
    std::string u = upper(tag);
    auto has = [&](const char* s) { return u.find(s) != std::string::npos; };
    if (has("AV1") || has("AV01")) return "AV1, not read";
    if (has("FFV1")) return "FFV1, not read";
    if (u == "VCR2" || u == "SLIF")
      return "an MPEG-1/2 variant with its own quirks, not read";
    auto in = [&](std::initializer_list<const char*> tags) {
      for (const char* t : tags)
        if (u == t) return true;
      return false;
    };
    if (in({"UQY0", "UQY2", "UQRA", "UQRG"}))
      return "UT Video 10-bit (UQ**), not read";
    if (in({"UMY2", "UMH2", "UMY4", "UMH4", "UMRG", "UMRA"}))
      return "UT Video pack mode (UM**), not read";
    if (in({"MPG4", "MP41", "DIV1"})) return "MS-MPEG4 v1, not read";
    if (u == "MTSJ")
      return "MJPEG that libavcodec decodes with MTSJ's own quirk, not read";
    if (in({"MJ2C", "MJP2", "LJ2C", "LJ2K", "IPJ2", "AVJ2"}))
      return "JPEG 2000, not read";
    if (u == "ZYGO")
      return "ZyGo's H.263, not read: libavcodec reads 759 bits of ZyGo's "
             "own after each I picture's header, so cv2 reads the pictures "
             "that other H.263 tags hold wrongly";
    if (u == "I263") return "Intel H.263, not read";
    // DV (libavformat's riff and QuickTime tags of dvvideo): libavcodec
    // marks every DV frame interlaced and cv2's swscale converts none of
    // them (each frame it reads is black).
    if (in({"DVSD", "DV25", "DV50", "DVHD", "DVSL", "CDVC", "CDVH", "CDV5",
            "DVC ", "DVCS", "DVH1", "DVIS", "PDVC", "SL25", "SLDV", "AVD1",
            "DVCP", "DVPP", "DV5N", "DV5P", "AVDV", "DVHQ", "DVHP", "DVH2",
            "DVH3", "DVH4", "DVH5", "DVH6", "DV1N", "DV1P"}))
      return "DV, not read: cv2 converts no DV frame, since libavcodec "
             "marks DV frames interlaced and cv2's swscale then gives black";
    return "a codec that is not read";
  }

 private:
  const Track& t_;
  std::vector<size_t> calls_;     // the packet of each decode() call
  bool fields_ = false;           // MJPEG field pairs (mjpeg_fields)
  std::unique_ptr<Mpeg4Decoder> mpeg4_;
  std::unique_ptr<Vp8Decoder> vp8_;
  std::unique_ptr<Vp9Decoder> vp9_;
  std::unique_ptr<H264Decoder> h264_;
  std::unique_ptr<HevcDecoder> hevc_;
  std::unique_ptr<Mpeg12Decoder> mpeg12_;
  std::unique_ptr<RawDecoder> raw_;
  std::unique_ptr<Ffv1Decoder> ffv1_;
  std::unique_ptr<UtVideoDecoder> ut_;
  std::unique_ptr<HuffyuvDecoder> huffyuv_;
  std::unique_ptr<H263Decoder> h263_;
  std::unique_ptr<H261Decoder> h261_;
  std::unique_ptr<MagicyuvDecoder> magicyuv_;
  std::unique_ptr<AsvDecoder> asv_;
  std::unique_ptr<SnowDecoder> snow_;
};

// A JPEG's frame size, from its SOF segment; false without one.
bool jpeg_size(const uint8_t* d, size_t n, int& w, int& h) {
  for (size_t p = 2; p + 9 <= n;) {
    if (d[p] != 0xFF || d[p + 1] == 0xFF) {
      ++p;
      continue;
    }
    const int m = d[p + 1];
    if (m == 0xD8 || m == 0x01 || (m >= 0xD0 && m <= 0xD7)) {
      p += 2;
      continue;
    }
    if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC) {
      h = (d[p + 5] << 8) | d[p + 6];
      w = (d[p + 7] << 8) | d[p + 8];
      return true;
    }
    p += 2 + ((size_t(d[p + 2]) << 8) | d[p + 3]);
  }
  return false;
}

// Whether libavcodec reads an MJPEG track as field pairs: its first
// picture under 3/4 of the container's height (the test it makes of
// the first picture alone).
bool mjpeg_fields(const Track& t) {
  int w = 0, h = 0;
  return !t.packets.empty() && t.height > 0 &&
         jpeg_size(&t.file[t.packets[0].off], t.packets[0].size, w, h) &&
         h < (t.height * 3) / 4;
}

// The size of the track's first picture, before cv2's turn: the size
// libavformat's avformat_find_stream_info leaves in the stream's
// parameters (it decodes the first picture), which cv2 reports and to
// which its swscale scales every picture of another size (SWS_BICUBIC,
// from the picture's own size and chroma siting). Read from the first
// packet's headers (a JPEG's SOF, a VP8 or VP9 keyframe's size, the
// first SPS, the VOL, the sequence header); the container's size when
// they give none. A
// first MJPEG picture under 3/4 of the container's height is one field
// of a pair (libavcodec's test).
void first_size(const Track& t, int& w, int& h) {
  w = h = 0;
  if (!t.packets.empty()) {
    const Packet& p = t.packets[0];
    const uint8_t* d = &t.file[p.off];
    switch (t.codec) {
      case Codec::kMjpeg:
        if (jpeg_size(d, p.size, w, h) && mjpeg_fields(t)) h *= 2;
        break;
      case Codec::kVp8:
        if (p.size >= 10 && !(d[0] & 1)) {
          w = (d[6] | (d[7] << 8)) & 0x3FFF;
          h = (d[8] | (d[9] << 8)) & 0x3FFF;
        }
        break;
      case Codec::kVp9:
        Vp9Decoder::picture_size(d, p.size, w, h);
        break;
      case Codec::kH264: {
        H264Decoder q(t.config);
        q.headers(d, p.size);
        q.picture_size(w, h);
        break;
      }
      case Codec::kHevc: {
        HevcDecoder q(t.config);
        q.headers(d, p.size);
        q.picture_size(w, h);
        break;
      }
      case Codec::kMpeg4: {
        Mpeg4Decoder q(t.config, t.tag);
        q.peek(d, p.size);
        q.picture_size(w, h);
        break;
      }
      case Codec::kMpeg12: {
        Mpeg12Decoder q(t.config, t.tag);
        q.headers(d, p.size);
        q.picture_size(w, h);
        break;
      }
      case Codec::kH263:                  // ITU H.263's picture header
        H263Decoder::picture_size(Decoder::h263_tag(t), d, p.size, w, h);
        break;
      case Codec::kH261:
        H261Decoder::picture_size(d, p.size, w, h);
        break;
      case Codec::kMagicyuv:              // the packet header's size
        MagicyuvDecoder::picture_size(d, p.size, w, h);
        break;
      case Codec::kPng:                   // IHDR's size
        if (p.size >= 24 && std::memcmp(d + 12, "IHDR", 4) == 0) {
          w = int(std::min<uint32_t>(be32(d + 16), 0x7FFFFFFF));
          h = int(std::min<uint32_t>(be32(d + 20), 0x7FFFFFFF));
        }
        break;
      default:
        break;
    }
  }
  if (w <= 0 || h <= 0) {
    w = t.width;
    h = t.height;
  }
}

// Where a window's HEVC decode may start: the last IRAP packet whose
// fresh decode outputs exactly the whole decode's pictures from some
// point on (their number before it in `first`), that point at or before
// frame `pick`; packet 0 otherwise. A fresh decoder drops the RASL
// pictures of a CRA it starts at (NoRaslOutputFlag), so a CRA is such a
// start only for picks that follow its leading pictures in output
// order; an IDR or a BLA picture outputs every picture before it. The
// whole decode's order comes from a pass over the slice headers.
size_t hevc_start(const Track& t, int64_t pick, int64_t& first) {
  const size_t np = t.packets.size();
  HevcDecoder scan(t.config);
  scan.headers_only();
  std::vector<int> kind(np, -1);
  std::vector<size_t> order;                // the packet of each output
  Picture q;
  for (size_t i = 0; i < np; ++i) {
    const uint8_t* d = &t.file[t.packets[i].off];
    kind[i] = scan.peek(d, t.packets[i].size);
    if (scan.decode(d, t.packets[i].size, q)) {
      order.push_back(size_t(q.source));
      while (scan.next(q)) order.push_back(size_t(q.source));
    }
  }
  while (scan.flush(q)) order.push_back(size_t(q.source));
  auto irap = [&](size_t i) { return kind[i] >= 16 && kind[i] <= 23; };
  size_t best = 0;
  first = 0;
  std::vector<char> in(np);
  for (size_t s = 1; s < np; ++s) {
    if (!irap(s)) continue;
    std::fill(in.begin(), in.end(), 0);
    for (size_t j = s; j < np; ++j) in[j] = 1;
    if (kind[s] == 21)                        // CRA: its RASL pictures
      for (size_t j = s + 1; j < np && !irap(j); ++j)
        if (kind[j] == 8 || kind[j] == 9) in[j] = 0;
    size_t k = 0;
    while (k < order.size() && !in[order[k]]) ++k;
    bool suffix = true;
    for (size_t m = k; m < order.size() && suffix; ++m) suffix = in[order[m]];
    if (!suffix) continue;
    int64_t before = 0;
    for (size_t m = 0; m < k; ++m) before += !t.packets[order[m]].discard;
    if (before > pick) break;
    best = s;
    first = before;
  }
  return best;
}

}  // namespace

// libavcodec's png decoder's picture, as swscale converts it: rgb24 and
// rgba (tRNS or not), pal8 (indices past the palette black; alpha
// dropped) and 1/2/4-bit palette indices as BGR24; gray8 (2 and 4-bit
// grey scaled up, as handle_small_bpp does) as grey; ya8 (grey with
// alpha or tRNS) as full-range 4:4:4 with mid chroma, as cv2's swscale
// converts it; rgb48be and rgba64be as 16-bit planar RGB, gray16be and
// ya16be as full-range 16-bit 4:4:4 with mid chroma (the same bytes
// through swscale).
void decode_png_picture(const uint8_t* data, size_t n, Picture& out) {
  viai_png::Image png;
  try {
    png = viai_png::parse(data, n, false);
  } catch (const viai_png::Error& e) {
    throw Error{e.code, e.msg};
  }
  if (png.interlaced)
    unsupported("PNG interlaced (Adam7): libavcodec marks the frame "
                "interlaced and cv2's swscale converts no such frame");
  const int w = png.w, h = png.h, d = png.depth, ct = png.ctype;
  const bool trns = !png.trns.empty();
  out = Picture();
  out.w = w;
  out.h = h;
  out.ystride = w;
  const size_t np = size_t(w) * h;
  auto row = [&](int y) { return &png.rows[size_t(int64_t(y) * png.rowbytes)]; };
  auto sample = [&](const uint8_t* r, int x) {      // depths below 8
    const int64_t bit = int64_t(x) * d;
    return (r[bit >> 3] >> (8 - d - (bit & 7))) & ((1 << d) - 1);
  };
  if (ct == 3) {
    if (png.npal < 0) broken("PNG palette missing");
    out.bgr.resize(np * 3);
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x) {
        const int s = d == 8 ? row(y)[x] : sample(row(y), x);
        uint8_t* o = &out.bgr[(size_t(y) * w + x) * 3];
        for (int c = 0; c < 3; ++c)
          o[2 - c] = s < png.npal ? png.pal[3 * s + c] : 0;
      }
    return;
  }
  if ((ct == 2 || ct == 6) && d == 8) {
    const int ch = ct == 2 ? 3 : 4;
    out.bgr.resize(np * 3);
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x) {
        const uint8_t* s = row(y) + size_t(x) * ch;
        uint8_t* o = &out.bgr[(size_t(y) * w + x) * 3];
        o[0] = s[2];
        o[1] = s[1];
        o[2] = s[0];
      }
    return;
  }
  if (d == 16) {
    const int ch = ct == 0 ? 1 : ct == 4 ? 2 : ct == 2 ? 3 : 4;
    auto be = [&](int y, int x, int c) {
      const uint8_t* s = row(y) + (size_t(x) * ch + size_t(c)) * 2;
      return uint16_t((s[0] << 8) | s[1]);
    };
    out.depth = 16;
    out.xshift = out.yshift = 0;
    out.cstride = w;
    out.y16.resize(np);
    out.u16.resize(np);
    out.v16.resize(np);
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x) {
        const size_t i = size_t(y) * w + x;
        if (ct == 0 || ct == 4) {
          out.y16[i] = be(y, x, 0);
          out.u16[i] = out.v16[i] = 0x8000;
        } else {
          out.y16[i] = be(y, x, 1);            // G, B, R
          out.u16[i] = be(y, x, 2);
          out.v16[i] = be(y, x, 0);
        }
      }
    out.rgb = ct == 2 || ct == 6;
    out.full_range = !out.rgb;          // cv2 converts grey at full range
    return;
  }
  // grey at 8 bits and below, grey with alpha at 8
  if (ct == 0 && d == 1)
    unsupported("1-bit grey PNG (libavcodec's monoblack)");
  if (ct == 0 && d < 8 && trns)
    unsupported("PNG grey below 8 bits with tRNS");
  std::vector<uint8_t> Y(np);
  for (int y = 0; y < h; ++y)
    for (int x = 0; x < w; ++x) {
      const size_t i = size_t(y) * w + x;
      if (ct == 4)
        Y[i] = row(y)[size_t(x) * 2];
      else if (d == 8)
        Y[i] = row(y)[x];
      else
        Y[i] = uint8_t(sample(row(y), x) * (d == 2 ? 0x55 : 0x11));
    }
  if (ct == 0 && !trns) {
    out.grey = true;
    out.y = std::move(Y);
    return;
  }
  out.xshift = out.yshift = 0;
  out.cstride = w;
  out.full_range = true;
  out.y = std::move(Y);
  out.u.assign(np, 128);
  out.v.assign(np, 128);
}

}  // namespace viai_video

// =====================================================================
// C interface
// =====================================================================

namespace {

using viai_video::Error;
using viai_video::Picture;
using viai_video::Track;

void set_error(char* err, int errlen, const std::string& msg) {
  if (err && errlen > 0) std::snprintf(err, size_t(errlen), "%s", msg.c_str());
}

struct Handle {
  Track track;
};

}  // namespace

extern "C" {

// Demux a file. → a handle (free it with viai_video_close), nullptr on
// failure with *code 1 (broken) or 2 (unsupported) and err set.
void* viai_video_open(const char* path, int32_t* code, char* err,
                      int32_t errlen) {
  try {
    Handle* h = new Handle{viai_video::open_track(path)};
    *code = 0;
    return h;
  } catch (const Error& e) {
    *code = e.code;
    set_error(err, errlen, std::string(path) + ": " + e.msg);
  } catch (const std::bad_alloc&) {
    *code = 1;
    set_error(err, errlen, "out of memory");
  }
  return nullptr;
}

void viai_video_close(void* h) { delete static_cast<Handle*>(h); }

// info = (width, height (the first picture's, as cv2 reports them),
// cv2's frame count, packets, config bytes,
// codec: 0 MJPEG, 1 MPEG-4 Part 2, 2 VP8, 3 VP9, 4 H.264, 5 MPEG-1/2,
// 6 uncompressed, 7 HEVC, 8 FFV1, 9 UT Video, 10 HuffYUV/FFVHuff, 11 PNG,
// 12 another,
// cv2's orientation, an AVI strf's bit count); tag and container names.
void viai_video_info(void* hp, int64_t* info, char* tag, char* container,
                     int32_t len) {
  const Track& t = static_cast<Handle*>(hp)->track;
  int w = t.width, h = t.height;
  try {
    viai_video::first_size(t, w, h);
  } catch (const Error&) {
  }
  info[0] = w;
  info[1] = h;
  info[2] = t.count;
  info[3] = int64_t(t.packets.size());
  info[4] = int64_t(t.config.size());
  info[5] = int64_t(t.codec);
  info[6] = t.orientation;
  info[7] = t.bits;
  set_error(tag, len, t.tag);
  set_error(container, len, t.container);
}

// Packet i's bytes, size and keyframe flag (the container's).
const uint8_t* viai_video_packet(void* hp, int64_t i, int64_t* size,
                                 int32_t* key) {
  const Track& t = static_cast<Handle*>(hp)->track;
  const viai_video::Packet& p = t.packets[size_t(i)];
  *size = p.size;
  *key = p.key;
  return &t.file[p.off];
}

const uint8_t* viai_video_config(void* hp) {
  return static_cast<Handle*>(hp)->track.config.data();
}

// Every picture of the track as (T, h, w, 3) BGR24 at the first
// picture's size (a picture of another size scaled to it as cv2's
// swscale scales it), turned by cv2's orientation (90, 180 or 270) → a
// malloc'd buffer
// (free it with viai_video_free), shape in thw; nullptr on failure with
// *code and err set.
uint8_t* viai_video_decode(void* hp, int64_t* thw, int32_t* code, char* err,
                           int32_t errlen) {
  const Track& t = static_cast<Handle*>(hp)->track;
  try {
    viai_video::Decoder dec(t);
    std::vector<uint8_t> all;
    int64_t frames = 0, w = 0, h = 0;
    int tw = 0, th = 0;               // the first picture's size
    Picture pic;
    auto take = [&]() {
      if (!tw) {
        tw = pic.shown_w ? pic.shown_w : pic.w;
        th = pic.h;
      }
      if (!dec.shown(pic)) return;
      std::vector<uint8_t> bgr = viai_video::to_bgr(pic, tw, th);
      int ph = th, pw = tw;
      viai_video::turn_bgr(bgr, ph, pw, t.orientation);
      w = pw;
      h = ph;
      all.insert(all.end(), bgr.begin(), bgr.end());
      ++frames;
    };
    for (size_t i = 0; i < t.packets.size(); ++i)
      if (dec.decode(i, pic)) {
        take();
        while (dec.more(pic)) take();
      }
    while (dec.flush(pic)) take();
    if (!frames) viai_video::broken("no frames decoded");
    uint8_t* out = static_cast<uint8_t*>(std::malloc(all.size()));
    if (!out) viai_video::broken("out of memory");
    std::memcpy(out, all.data(), all.size());
    thw[0] = frames;
    thw[1] = h;
    thw[2] = w;
    *code = 0;
    return out;
  } catch (const Error& e) {
    *code = e.code;
    set_error(err, errlen, e.msg);
  } catch (const std::bad_alloc&) {
    *code = 1;
    set_error(err, errlen, "out of memory");
  }
  return nullptr;
}

void viai_video_free(uint8_t* p) { std::free(p); }

// Planes of (h, w) luma and chroma (h >> yshift, w >> xshift, rounded
// up), 8-bit (depth 8: bytes) or 9 to 14-bit (uint16_t), rows packed →
// out (dh, dw, 3) BGR24 as to_bgr converts a decoded picture to that
// size; full_range, matrix (swscale's colour space) and chroma_loc as
// Picture's; rgb 1: planar G, B, R, 2: grey (y alone, 8 bits). → 0, or 1
// with err set for a layout to_bgr has no route for.
int32_t viai_yuv_to_bgr(const void* y, const void* u, const void* v,
                        int32_t w, int32_t h, int32_t xshift, int32_t yshift,
                        int32_t depth, int32_t full_range, int32_t matrix,
                        int32_t chroma_loc, int32_t dw, int32_t dh,
                        int32_t rgb, uint8_t* out, char* err,
                        int32_t errlen) {
  try {
    if (w < 1 || h < 1 || xshift < 0 || xshift > 2 || yshift < 0 || yshift > 2 ||
        depth < 8 || depth > 16)
      viai_video::broken("a picture layout to_bgr does not convert");
    Picture p;
    p.w = w;
    p.h = h;
    p.xshift = xshift;
    p.yshift = yshift;
    p.depth = depth;
    p.full_range = full_range != 0;
    p.matrix = matrix;
    p.chroma_loc = chroma_loc;
    p.rgb = rgb == 1;
    p.grey = rgb == 2;
    p.ystride = w;
    p.cstride = (w + (1 << xshift) - 1) >> xshift;
    const size_t ny = size_t(w) * h,
                 nc = size_t(p.cstride) * ((h + (1 << yshift) - 1) >> yshift);
    if (depth > 8) {
      auto words = [](const void* s, size_t n) {
        const uint16_t* q = static_cast<const uint16_t*>(s);
        return std::vector<uint16_t>(q, q + n);
      };
      p.y16 = words(y, ny);
      p.u16 = words(u, nc);
      p.v16 = words(v, nc);
    } else {
      auto bytes = [](const void* s, size_t n) {
        const uint8_t* q = static_cast<const uint8_t*>(s);
        return std::vector<uint8_t>(q, q + n);
      };
      p.y = bytes(y, ny);
      p.u = bytes(u, nc);
      p.v = bytes(v, nc);
    }
    if (dw < 1 || dh < 1) viai_video::broken("an empty output size");
    std::vector<uint8_t> bgr = viai_video::to_bgr(p, dw, dh);
    std::memcpy(out, bgr.data(), bgr.size());
    return 0;
  } catch (const Error& e) {
    set_error(err, errlen, e.msg);
    return e.code;
  } catch (const std::bad_alloc&) {
    set_error(err, errlen, "out of memory");
    return 1;
  }
}

// One packet of uncompressed video → out (h, w, 3) BGR24, as cv2 reads
// it: libavcodec's rawvideo (or v210) decoder for the fourcc `tag` (0:
// BI_RGB of `bits` a pixel, bottom-up when `bottom_up`, `extradata`
// strf's bytes after 40 with pal8's colour table), then swscale's route
// to BGR24. → 0, or 1 broken (a packet libavcodec refuses) / 2 a layout
// that is not read, with err set.
int32_t viai_raw_to_bgr(const uint8_t* data, int64_t n, uint32_t tag,
                        int32_t bits, int32_t w, int32_t h, int32_t bottom_up,
                        const uint8_t* extradata, int64_t next, uint8_t* out,
                        char* err, int32_t errlen) {
  try {
    viai_video::RawDecoder dec(
        tag, bits, w, h, bottom_up != 0,
        std::vector<uint8_t>(extradata, extradata + next), "raw");
    Picture p;
    if (!dec.decode(data, size_t(n), p))
      viai_video::broken("a packet shorter than its frame");
    std::vector<uint8_t> bgr = viai_video::to_bgr(p);
    std::memcpy(out, bgr.data(), bgr.size());
    return 0;
  } catch (const Error& e) {
    set_error(err, errlen, e.msg);
    return e.code;
  } catch (const std::bad_alloc&) {
    set_error(err, errlen, "out of memory");
    return 1;
  }
}

// viai_tpu/data/av.py::_load_frames_video → out (n_frames, size, size, 3)
// float32 RGB in [0, 1]: the indices of cv2's frame count over the
// window (float64 rule) as a set; the frames found among them, each at
// the first picture's size (first_size: a picture of another size scaled
// to it as cv2's swscale scales it), turned by cv2's orientation,
// resized as cv2.resize at INTER_LINEAR on
// BGR, flipped to RGB, / 255;
// then re-picked by the window rule over (0, 1) when their number is
// not n_frames. MJPEG, uncompressed video, UT Video, HuffYUV, PNG,
// MagicYUV and ASV decode only the picked packets, FFV1 and Snow from the
// key frame at or before the first pick (FFV1's context states carry
// over, Snow's pictures are references); MPEG-4 from the
// last I-VOP at or before the first pick to the last pick, VP8 and VP9
// from the last shown keyframe at or before it, H.264 (whose frames count
// in output order) from the last IDR picture at or before it until the
// last pick is output (from the first packet when the stream does not
// begin with an IDR picture), MPEG-1/2 (in output order too) from the last
// I-picture of a closed GOP whose first output is at or before it, HEVC
// from the last IRAP picture whose fresh decode outputs the whole
// decode's pictures from some point at or before it (hevc_start: a CRA
// only for picks after its leading pictures). → 0, or 1 broken / 2
// unsupported with err set.
int32_t viai_load_video_frames(const char* path, int32_t n_frames,
                               int32_t size, double w0, double w1,
                               float* out, char* err, int32_t errlen) {
  try {
    if (n_frames < 1 || size < 1)
      viai_video::broken("n_frames and size must be positive");
    Track t = viai_video::open_track(path);
    viai_video::Decoder dec(t);
    int tw = 0, th = 0;              // cv2's size: the first picture's
    viai_video::first_size(t, tw, th);
    std::vector<int64_t> idx =
        viai_window::window_indices(t.count, n_frames, w0, w1);
    std::vector<int64_t> want(idx);
    std::sort(want.begin(), want.end());
    want.erase(std::unique(want.begin(), want.end()), want.end());
    const int64_t fsz = int64_t(size) * size * 3;
    std::vector<float> got;
    Picture pic;
    auto keep = [&]() {
      std::vector<uint8_t> bgr = viai_video::to_bgr(pic, tw, th);
      int h = th, w = tw;
      viai_video::turn_bgr(bgr, h, w, t.orientation);
      got.resize(got.size() + size_t(fsz));
      viai_video::resize_rgb(bgr.data(), h, w, size,
                             &got[got.size() - size_t(fsz)]);
    };
    auto wanted = [&](int64_t f) {
      return std::binary_search(want.begin(), want.end(), f);
    };
    // MPEG-4's VOP kinds (a packet holding none gives no frame); B-VOPs
    // reorder its output.
    std::vector<int> vop(t.packets.size(), 0);
    bool reorder = t.codec == viai_video::Codec::kH264 ||
                   t.codec == viai_video::Codec::kMpeg12 ||
                   t.codec == viai_video::Codec::kHevc;
    if (t.codec == viai_video::Codec::kMpeg4) {
      viai_video::Mpeg4Decoder scan(t.config, t.tag);
      for (size_t i = 0; i < t.packets.size(); ++i)
        vop[i] = scan.peek(&t.file[t.packets[i].off], t.packets[i].size);
      reorder = scan.reorders();
    }
    if (reorder) {
      // Frames count in output order, which B-frames make differ from
      // packet order. H.264: every picture before an IDR picture is
      // output before it, so in a stream that begins with one an IDR
      // packet's frame number is the count of pictures before it: decode
      // from the last IDR at or before the first pick until the last pick
      // is output (from the first packet in a stream that begins
      // elsewhere). MPEG-4 with B-VOPs:
      // from the first packet (libavcodec skips a B-VOP whose older
      // reference it has not decoded).
      int64_t n = 0;
      size_t start = 0;
      if (t.codec == viai_video::Codec::kH264) {
        viai_video::H264Decoder scan(t.config);
        scan.headers_only();
        int64_t pics = 0;
        int first_kind = -1;
        // Pictures an MP4 edit discards are not counted.
        for (size_t i = 0; i < t.packets.size(); ++i) {
          const uint8_t* d = &t.file[t.packets[i].off];
          int kind = scan.peek(d, t.packets[i].size);
          scan.step(d, t.packets[i].size);
          if (first_kind < 0) first_kind = kind;
          if (kind == 0 && pics <= want.front()) {
            start = i;
            n = pics;
          }
          if (kind >= 0 && !t.packets[i].discard) ++pics;
        }
        // A guessed reorder depth may drop pictures (as cv2's libavcodec
        // does) and grows as the stream goes; a stream that does not
        // begin with an IDR picture (a copy cut) has pictures dropped
        // before its recovery point, which the count above does not
        // know: both count from the start. That is the simplest rule that
        // gives the whole decode's pictures: a fresh decode from a later
        // recovery point would drop that point's leading pictures, which
        // the whole decode outputs, and fills its gaps with other frames.
        if (scan.guesses_delay() || first_kind != 0) start = 0, n = 0;
      } else if (t.codec == viai_video::Codec::kMpeg12) {
        // MPEG-1/2: libavcodec outputs one picture behind unless
        // low_delay, skips an open GOP's B-pictures that lack their
        // forward reference and drops the held references at a new size,
        // so a pass over the headers counts each packet's outputs. A
        // closed GOP's B-pictures predict from its I-picture alone: a
        // fresh decoder started there outputs what the whole decode
        // outputs from that packet on, but for the older reference the
        // whole decode outputs at it (low_delay 0). An open GOP's
        // I-picture is no such start (its leading B-pictures would be
        // skipped).
        viai_video::Mpeg12Decoder scan(t.config, t.tag);
        scan.headers_only();
        int64_t outs = 0;
        Picture q;
        for (size_t i = 0; i < t.packets.size(); ++i) {
          const uint8_t* d = &t.file[t.packets[i].off];
          const uint32_t sz = t.packets[i].size;
          bool closed = false;
          int kind = viai_video::Mpeg12Decoder::peek(d, sz, &closed);
          bool got = scan.decode(d, sz, q) &&
                     !t.packets[size_t(q.source)].discard;
          if (got) ++outs;
          if (kind == 0 && closed) {
            int64_t first = scan.low_delay() && got ? outs - 1 : outs;
            if (first <= want.front()) {
              start = i;
              n = first;
            }
          }
        }
      } else if (t.codec == viai_video::Codec::kHevc) {
        start = viai_video::hevc_start(t, want.front(), n);
      }
      for (size_t i = 0; i < start; ++i) dec.skip(i);
      bool done = false;
      auto next = [&]() {
        if (!dec.shown(pic)) return;
        if (wanted(n)) keep();
        done = ++n > want.back();
      };
      for (size_t i = start; i < t.packets.size() && !done; ++i)
        if (dec.decode(i, pic)) {
          next();
          while (!done && dec.more(pic)) next();
        }
      while (!done && dec.flush(pic)) next();
      if (got.empty()) viai_video::broken("no frames decoded");
    } else {
      // Frame numbers: MJPEG packet i is frame i; an MPEG-4 packet is a
      // frame when it holds a VOP, a VP8 or VP9 packet when it shows one
      // (a VP9 packet that shows n pictures, frames frame_of to
      // frame_of + n − 1).
      std::vector<int64_t> frame_of(t.packets.size(), -1);
      std::vector<int> shows(t.packets.size(), 1);
      std::unique_ptr<viai_video::H263Decoder> h263;
      if (t.codec == viai_video::Codec::kH263)
        h263 = viai_video::Decoder::h263_of(t);
      int64_t frames = 0;
      bool refused = false;
      for (size_t i = 0; i < t.packets.size(); ++i) {
        const viai_video::Packet& p = t.packets[i];
        // Uncompressed: cv2 reads no frame from the first packet
        // libavcodec refuses on.
        if (dec.raw() && (refused || !dec.raw()->accepts(p.size))) {
          refused = true;
          vop[i] = -1;
        }
        if (t.codec == viai_video::Codec::kVp8)
          vop[i] = viai_video::Vp8Decoder::peek(&t.file[p.off], p.size);
        if (t.codec == viai_video::Codec::kVp9)
          vop[i] = viai_video::Vp9Decoder::peek(&t.file[p.off], p.size,
                                               &shows[i]);
        if (t.codec == viai_video::Codec::kFfv1)
          vop[i] = viai_video::Ffv1Decoder::peek(&t.file[p.off], p.size);
        if (t.codec == viai_video::Codec::kSnow)
          vop[i] = viai_video::SnowDecoder::peek(&t.file[p.off], p.size);
        if (h263) vop[i] = h263->peek(&t.file[p.off], p.size);
        if (vop[i] >= 0 && !p.discard) {
          frame_of[i] = frames;
          frames += shows[i];
        }
      }
      auto picked_in = [&](size_t i) {
        if (frame_of[i] < 0) return false;
        auto lo = std::lower_bound(want.begin(), want.end(), frame_of[i]);
        return lo != want.end() && *lo < frame_of[i] + shows[i];
      };
      size_t first = 0, last = 0;
      bool any = false;
      for (size_t i = 0; i < t.packets.size(); ++i) {
        if (!picked_in(i)) continue;
        if (!any) first = i;
        last = i;
        any = true;
      }
      if (!any) viai_video::broken("no frames decoded");
      size_t start = first;
      if (!dec.intra())
        while (start > 0 && vop[start] != 0) --start;
      if (!dec.seekable()) start = 0;
      // Headers (an in-band VOL) may precede that I-VOP.
      for (size_t i = 0; i < start; ++i) dec.skip(i);
      for (size_t i = start; i <= last; ++i) {
        bool picked = picked_in(i);
        if (dec.intra() && !picked) continue;
        if (!dec.decode(i, pic) || !picked) continue;
        int64_t f = frame_of[i];
        do {
          if (wanted(f++)) keep();
        } while (dec.more(pic));
      }
    }
    int64_t k = int64_t(got.size() / size_t(fsz));
    std::vector<int64_t> pick(n_frames);
    if (k == n_frames) {
      for (int i = 0; i < n_frames; ++i) pick[i] = i;
    } else {
      pick = viai_window::window_indices(k, n_frames, 0.0, 1.0);
    }
    for (int i = 0; i < n_frames; ++i)
      std::memcpy(out + i * fsz, &got[size_t(pick[i] * fsz)],
                  sizeof(float) * size_t(fsz));
    return 0;
  } catch (const Error& e) {
    set_error(err, errlen, std::string(path) + ": " + e.msg);
    return e.code;
  } catch (const std::bad_alloc&) {
    set_error(err, errlen, "out of memory");
    return 1;
  }
}

}  // extern "C"
