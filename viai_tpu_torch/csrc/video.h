// Shared by videodec.cpp (containers, MJPEG, the frame path),
// mpeg4.cpp (the MPEG-4 Part 2 decoder), mpeg12.cpp (the MPEG-1/2
// decoder), vp8.cpp (the VP8 decoder), vp9.cpp (the VP9 decoder),
// h264.cpp (the H.264 decoder), hevc.cpp (the HEVC decoder),
// msmpeg4.cpp (the H.263 family), h261.cpp (H.261),
// rawvideo.cpp (uncompressed video), ffv1.cpp (FFV1), utvideo.cpp (UT
// Video), huffyuv.cpp (HuffYUV and FFVHuff), magicyuv.cpp (MagicYUV),
// asv.cpp (ASUS ASV1 and ASV2), snow.cpp (Snow) and imagedec.cpp (PNG in
// AVI and Matroska).
#pragma once

#include <cstddef>
#include <cstdint>
#include <memory>
#include <string>
#include <vector>

namespace viai_video {

struct Error {
  int code;             // 1 broken (ValueError), 2 unsupported
  std::string msg;      // (NotImplementedError)
};

[[noreturn]] inline void broken(const std::string& m) { throw Error{1, m}; }
[[noreturn]] inline void unsupported(const std::string& m) {
  throw Error{2, m};
}

// libavutil's av_image_check_size: a picture libavcodec allocates at all
// (each side positive, (w + 128)(h + 128) under INT_MAX / 8).
inline void check_size(int w, int h, const std::string& what) {
  if (w <= 0 || h <= 0 ||
      int64_t(w + 128) * int64_t(h + 128) >= int64_t(0x7FFFFFFF / 8))
    broken(what + " picture size " + std::to_string(w) + "x" +
           std::to_string(h) + " out of range");
}

// A decoded picture: luma (h, w); chroma (h >> yshift, w >> xshift),
// rounded up, each plane at its own row stride. The shifts are the
// chroma layouts of ffmpeg's decoders: 1, 1 (4:2:0, every decoder but
// MJPEG), 1, 0 (4:2:2), 0, 0 (4:4:4) and 0, 1 (4:4:0); `grey` has no
// chroma planes (ffmpeg's gray).
struct Picture {
  int w = 0, h = 0;
  // The width cv2 reports and scales the picture to when it is not w
  // (H.264's left crop, which libavcodec aligns); 0: w.
  int shown_w = 0;
  int ystride = 0, cstride = 0;
  std::vector<uint8_t> y, u, v;
  // Above 8 bits (H.264's High 10, High 4:2:2 and High 4:4:4 Predictive
  // at 9, 10, 12 or 14 bits, VP9's profiles 2 and 3 at 10 or 12, the
  // lossless codecs' 9 to 16): the samples are in y16, u16, v16 (y, u, v
  // empty), strides in samples. Chroma shifts run to 2 (4:1:1, 4:1:0).
  // The lossless decoders hand over alpha dropped (swscale drops it on
  // the way to BGR24), grey above 8 bits and grey with alpha as
  // full-range 4:4:4 with mid chroma (what cv2's swscale makes of them)
  // and 16-bit packed RGB as planar G, B, R.
  int depth = 8;
  std::vector<uint16_t> y16, u16, v16;
  int xshift = 1, yshift = 1;
  bool grey = false;
  // Planar GBR (VP9's sRGB, H.264's 4:4:4 of matrix_coefficients 0 as
  // libx264rgb writes it; libavcodec's gbrp, gbrp10 ... gbrp14): G in y
  // (y16), B in u, R in v, at full size.
  bool rgb = false;
  // The decode call (counted from 0 by the decoder that gave it) whose
  // packet the picture was decoded from: H.264, and MPEG-4 with B-VOPs,
  // output pictures after later packets.
  int64_t source = 0;
  bool full_range = false;  // yuvj (JPEG) levels, else limited (16..235)
  // The YCbCr matrix as swscale's colour space index (SWS_CS_*): 5 is
  // BT.601 (swscale's default), 1 BT.709, 7 SMPTE 240M, 9 BT.2020.
  int matrix = 5;
  // The chroma siting libavcodec gives the frame (AVChromaLocation):
  // 0 unspecified (swscale's default), 1 left (H.264's default), 2
  // centre, 3 top left, 4 top, 5 bottom left, 6 bottom. cv2's swscale
  // places the chroma samples by it when it scales them.
  int chroma_loc = 0;
  // The source was semi-planar or packed (rawvideo's nv12, nv21,
  // yuyv422, uyvy422, yvyu422): swscale has no unscaled converter from
  // it to BGR24, so cv2's conversion runs its scaler at any size.
  bool scaler_only = false;
  // The source was RGB (rawvideo's rgb24, bgr24, rgba, bgra, rgb555le,
  // pal8): the picture as BGR24 (h, w, 3), what swscale's unscaled
  // converters give at its own size; no planes.
  std::vector<uint8_t> bgr;
};

// ffmpeg's "simple" integer IDCT (simple_idct_template.c, 8 bits) of a
// block in natural order, in place: rows, then columns, written with
// saturation (put) or added to what `dst` holds (add).
void idct_put(int16_t* blk, uint8_t* dst, ptrdiff_t stride);
void idct_add(int16_t* blk, uint8_t* dst, ptrdiff_t stride);
// The XviD IDCT (libavcodec's xvididct, as its x86 SSE2 form computes it:
// 16-bit saturation in both passes), which libavcodec uses for XviD's
// streams.
void xvid_idct_put(int16_t* blk, uint8_t* dst, ptrdiff_t stride);
void xvid_idct_add(int16_t* blk, uint8_t* dst, ptrdiff_t stride);
// The simple IDCT's 8x4 and 4x8 forms (ff_simple_idct84_add, rows of 8
// then columns of 4; ff_simple_idct48_add, rows of 4 then columns of 8),
// added to dst: WMV2's ABT blocks.
void idct84_add(int16_t* blk, uint8_t* dst, ptrdiff_t stride);
void idct48_add(int16_t* blk, uint8_t* dst, ptrdiff_t stride);

// ffmpeg's mpeg4 decoder for what its encoder writes (see mpeg4.cpp).
class Mpeg4Decoder {
 public:
  // `config`: the stream's headers from the container (VOS, VO, VOL),
  // possibly empty when they travel in the first packet; `tag` names
  // the stream in messages.
  Mpeg4Decoder(const std::vector<uint8_t>& config, const std::string& tag);
  ~Mpeg4Decoder();
  // Decode one packet; true with `out` filled when libavcodec outputs a
  // picture after it: none for a packet without a coded VOP; behind
  // B-VOPs (low_delay 0) the older reference, a B-VOP at once.
  bool decode(const uint8_t* data, size_t n, Picture& out);
  // At the end of the stream: the reference still held back; false when
  // none is left.
  bool flush(Picture& out);
  // Read one packet's headers only: its first VOP's kind, 0 I, 1 P, 2 B,
  // 3 S, or −1 when it gives no picture. Headers it holds are kept.
  int peek(const uint8_t* data, size_t n);
  // Whether output runs one picture behind (in display order): a B-VOP
  // was seen (by peek or decode), or the VOL clears low_delay.
  bool reorders() const;
  // The VOL's picture size; false before a VOL.
  bool picture_size(int& w, int& h) const;
  // libavcodec's frame rate (AVCodecContext.framerate) from the VOL:
  // vop_time_increment_resolution over fixed_vop_time_increment (1
  // without fixed_vop_rate); false before a VOL.
  bool frame_rate(int64_t& num, int64_t& den) const;

 private:
  struct State;
  std::unique_ptr<State> s_;
};

// libavcodec's mpeg1video/mpeg2video decoder for progressive MPEG-1 and
// MPEG-2 video, 4:2:0 and 4:2:2 (see mpeg12.cpp).
class Mpeg12Decoder {
 public:
  // `config`: the headers the container holds (an MP4 esds's
  // DecoderSpecificInfo, a Matroska CodecPrivate), possibly empty; `tag`
  // names the stream in messages.
  Mpeg12Decoder(const std::vector<uint8_t>& config, const std::string& tag);
  ~Mpeg12Decoder();
  // Decode one packet; true with `out` filled when libavcodec outputs a
  // picture after it: behind low_delay 0 the older reference, a
  // B-picture at once; a packet that is a sequence end code alone gives
  // the reference still held.
  bool decode(const uint8_t* data, size_t n, Picture& out);
  // At the end of the stream: the reference still held back; false when
  // none is left.
  bool flush(Picture& out);
  // Read one packet's sequence-level headers only (the packets before a
  // later starting point).
  void headers(const uint8_t* data, size_t n);
  // Order pictures from their headers without decoding their slices.
  void headers_only();
  // Whether the sequence extension sets low_delay (no picture held back).
  bool low_delay() const;
  // The last sequence header's picture size; false before one.
  bool picture_size(int& w, int& h) const;
  // libavcodec's frame rate from the last sequence header's
  // frame_rate_code (times the sequence extension's
  // frame_rate_extension_n + 1 over _d + 1), and whether that extension
  // made it MPEG-2; false before one or for a forbidden code.
  bool frame_rate(int64_t& num, int64_t& den, bool& mpeg2) const;
  // A packet's first picture's coding type: 0 I, 1 P, 2 B, 3 D; −1 when
  // it holds none. `closed`: whether it is an I-picture after a GOP
  // header with closed_gop in the same packet.
  static int peek(const uint8_t* data, size_t n, bool* closed = nullptr);

 private:
  struct State;
  std::unique_ptr<State> s_;
};

// The VP8 decoder (RFC 6386) for libvpx's streams (see vp8.cpp).
class Vp8Decoder {
 public:
  Vp8Decoder();
  ~Vp8Decoder();
  // Decode one packet (one frame); true with `out` filled when the frame
  // is shown (a hidden frame is decoded, kept as a reference, and gives
  // no picture, as in ffmpeg).
  bool decode(const uint8_t* data, size_t n, Picture& out);
  // Read one packet's 3-byte frame tag only: 0 a shown keyframe, 1 a
  // shown inter frame, -1 a hidden frame.
  static int peek(const uint8_t* data, size_t n);

 private:
  struct State;
  std::unique_ptr<State> s_;
};

// The VP9 decoder (profiles 0-3: 8, 10 and 12 bits, 4:2:0, 4:2:2, 4:4:0,
// 4:4:4 and sRGB) for libvpx's streams (see vp9.cpp).
class Vp9Decoder {
 public:
  Vp9Decoder();
  ~Vp9Decoder();
  // Decode one packet (its frames, by its superframe index); true with
  // `out` filled when it shows a picture (a hidden frame is decoded and
  // kept as a reference; show_existing_frame gives the slot's picture).
  bool decode(const uint8_t* data, size_t n, Picture& out);
  // The packet's further shown pictures, in order (an SVC superframe
  // shows one a spatial layer): true with `out` filled while one is left.
  bool next(Picture& out);
  // Read one packet's frame headers only: 0 when it shows a picture and
  // begins with a keyframe, 1 when it shows one otherwise, -1 when it
  // shows none; `pictures`, when given, the number it shows.
  static int peek(const uint8_t* data, size_t n, int* pictures = nullptr);
  // The frame size of a packet whose first frame is a keyframe; false
  // otherwise.
  static bool picture_size(const uint8_t* data, size_t n, int& w, int& h);

 private:
  struct State;
  std::unique_ptr<State> s_;
};

// The H.264 decoder (frame pictures, 4:2:0, 4:2:2, 4:4:4, GBR and
// monochrome at 8, 9, 10, 12 and 14 bits, lossless too: Baseline, Main,
// High, High 10, High 4:2:2 and High 4:4:4 Predictive with their Intra
// profiles) for the streams of x264, cameras and ffmpeg from images and
// screens (see h264.cpp).
class H264Decoder {
 public:
  // `config`: the avcC record of an MP4 avc1/avc3 sample entry or a
  // Matroska V_MPEG4/ISO/AVC track, whose packets carry length-prefixed
  // NAL units; empty for Annex B packets (start codes, as in AVI).
  explicit H264Decoder(const std::vector<uint8_t>& config);
  ~H264Decoder();
  // Decode one packet (an access unit); true with `out` filled when
  // libavcodec would output a picture after it (in its output order,
  // after its reorder delay).
  bool decode(const uint8_t* data, size_t n, Picture& out);
  // At the end of the stream: the next picture still held back; false
  // when none is left.
  bool flush(Picture& out);
  // Read one packet's parameter sets (and libx264's build from its SEI)
  // only: the packets before a later starting point.
  void headers(const uint8_t* data, size_t n);
  // Read one packet's NAL unit types only: 0 when it holds an IDR
  // picture, 1 another picture, -1 none.
  int peek(const uint8_t* data, size_t n);

  // libavcodec's reorder depth (AVCodecContext.has_b_frames): now, and
  // where it starts (libavformat hands cv2's decoder the depth its own
  // probing found, AVCodecParameters.video_delay).
  int delay() const;
  void set_delay(int delay);
  // The active (else the first) SPS's max_num_reorder_frames as
  // libavcodec holds it: inferred from the level without the VUI's
  // bitstream_restriction.
  int num_reorder_frames() const;
  // Order pictures from their headers without decoding their
  // macroblocks (libavformat's probe needs only the output order).
  void headers_only();
  // decode() without the picture: whether one is output.
  bool step(const uint8_t* data, size_t n);
  // Whether a B slice came under an SPS without bitstream_restriction
  // (the reorder depth is then libavcodec's guess).
  bool guesses_delay() const;
  // The cropped picture size of the active (else the first) SPS; false
  // before an SPS.
  bool picture_size(int& w, int& h) const;
  // libavcodec's frame rate from that SPS's VUI timing_info: time_scale
  // over 2 · num_units_in_tick; false without it.
  bool frame_rate(int64_t& num, int64_t& den) const;

 private:
  struct State;
  std::unique_ptr<State> s_;
};

// The HEVC decoder (Main, Main 10 and Main Still Picture: 4:2:0 at 8 and
// 10 bits) for the streams of x265, phones and cameras (see hevc.cpp).
class HevcDecoder {
 public:
  // `config`: the hvcC record of an MP4 hvc1/hev1 sample entry or a
  // Matroska V_MPEGH/ISO/HEVC track, whose packets carry length-prefixed
  // NAL units (its parameter sets are read first); empty for Annex B
  // packets (start codes, as in AVI).
  explicit HevcDecoder(const std::vector<uint8_t>& config);
  ~HevcDecoder();
  // Decode one packet (an access unit); true with `out` filled when
  // libavcodec outputs a picture after it (in its output order, bumped by
  // the SPS's reorder depth and buffering; an IRAP picture that begins a
  // sequence outputs every picture before it).
  bool decode(const uint8_t* data, size_t n, Picture& out);
  // The last decoded packet's further pictures, in order: true with
  // `out` filled while one is left.
  bool next(Picture& out);
  // At the end of the stream: the next picture still held back; false
  // when none is left.
  bool flush(Picture& out);
  // Read one packet's parameter sets only (the packets before a later
  // starting point).
  void headers(const uint8_t* data, size_t n);
  // Order pictures from their slice headers without decoding their CTUs.
  void headers_only();
  // The nal_unit_type of the packet's first slice segment that begins a
  // picture; -1 when it holds none.
  int peek(const uint8_t* data, size_t n) const;
  // The cropped picture size of the active (else the first) SPS; false
  // before an SPS.
  bool picture_size(int& w, int& h) const;
  // libavcodec's frame rate from that SPS's VUI timing: vui_time_scale
  // over vui_num_units_in_tick; false without it (the VPS's timing is
  // not read).
  bool frame_rate(int64_t& num, int64_t& den) const;

 private:
  struct State;
  std::unique_ptr<State> s_;
};

// libavcodec's rawvideo and v210 decoders for uncompressed video (see
// rawvideo.cpp): planar, semi-planar and packed YUV, grey, v210 and RGB.
class RawDecoder {
 public:
  // `tag`: the fourcc (AVI strf's compression, 0 for BI_RGB; a Matroska
  // track's ColourSpace); `bits`, strf's bit count (BI_RGB's layout);
  // `bottom_up`, a BI_RGB DIB of positive height; `extradata`, strf's
  // bytes after the BITMAPINFOHEADER (pal8's colour table); `where`
  // names the container in messages.
  RawDecoder(uint32_t tag, int bits, int w, int h, bool bottom_up,
             const std::vector<uint8_t>& extradata, const std::string& where);
  ~RawDecoder();
  // Decode one packet; false when libavcodec refuses it (shorter than a
  // frame): cv2 reads no further, so every later packet is refused too.
  bool decode(const uint8_t* data, size_t n, Picture& out);
  // Whether libavcodec takes a packet of n bytes.
  bool accepts(size_t n) const;
  // Whether libavformat's AVI demuxer reads an AVI of the fourcc as
  // rawvideo or v210 (0: BI_RGB) in a layout this decoder reads.
  static bool avi_raw(uint32_t tag);
  // A raw layout's fourcc that the AVI demuxer names no codec for (cv2
  // reads no frame).
  static bool avi_unnamed(uint32_t tag);

 private:
  struct State;
  std::unique_ptr<State> s_;
};

// The lossless intra codecs: each packet one picture, none held back.
// FFV1's non-key frames keep the context states of the frame before
// them, so its decode of a packet needs every packet from the key frame
// before it.

// libavcodec's ffv1 decoder, versions 0 to 3 (see ffv1.cpp).
class Ffv1Decoder {
 public:
  // `extradata`: the configuration record (versions 2 and 3; empty for 0
  // and 1); w, h: the container's picture size; `where` names the
  // container in messages.
  Ffv1Decoder(const std::vector<uint8_t>& extradata, int w, int h,
              const std::string& where);
  ~Ffv1Decoder();
  bool decode(const uint8_t* data, size_t n, Picture& out);
  // 0 for a key frame's packet, 1 another.
  static int peek(const uint8_t* data, size_t n);

 private:
  struct State;
  std::unique_ptr<State> s_;
};

// libavcodec's utvideo decoder for the classic 8-bit layouts (see
// utvideo.cpp).
class UtVideoDecoder {
 public:
  // `tag`: the fourcc (ULRG, ULRA, ULY0, ULY2, ULY4, ULH0, ULH2, ULH4);
  // `extradata`: the 16 bytes after the BITMAPINFOHEADER.
  UtVideoDecoder(const std::string& tag, const std::vector<uint8_t>& extradata,
                 int w, int h);
  ~UtVideoDecoder();
  bool decode(const uint8_t* data, size_t n, Picture& out);
  // Whether libavcodec's decoder takes the fourcc (its 8-bit layouts).
  static bool reads(const std::string& tag);

 private:
  struct State;
  std::unique_ptr<State> s_;
};

// libavcodec's huffyuv and ffvhuff decoders (see huffyuv.cpp).
class HuffyuvDecoder {
 public:
  // `bits`: the strf's bit count (the layout of a stream without
  // extradata); `extradata`: the tables of version 2 and FFVHuff.
  HuffyuvDecoder(int bits, const std::vector<uint8_t>& extradata, int w,
                 int h);
  ~HuffyuvDecoder();
  bool decode(const uint8_t* data, size_t n, Picture& out);

 private:
  struct State;
  std::unique_ptr<State> s_;
};

// libavcodec's H.263-family decoders (see msmpeg4.cpp): Sorenson H.263
// (FLV1), MS-MPEG4 v2 and v3, WMV1 (WMV7), WMV2 (WMV8) and ITU H.263 and
// H.263+. No picture is held back; an I picture decodes on its own.
class H263Decoder {
 public:
  // `tag`: the fourcc (Matroska's V_MPEG4/MS/V3 as "MP43", MP4's s263
  // and h263 as "H263"); w, h: the container's picture size (FLV1's and
  // H.263's pictures carry their own); `extradata`: WMV2's 4-byte
  // header. MS-MPEG4 v1's tags raise.
  H263Decoder(const std::string& tag, int w, int h,
              const std::vector<uint8_t>& extradata);
  ~H263Decoder();
  // Decode one packet; true with `out` filled, false when libavcodec
  // gives no picture for it (an empty packet, a WMV2 picture that skips
  // every macroblock, a skipped disposable FLV1 picture).
  bool decode(const uint8_t* data, size_t n, Picture& out);
  // Read one packet's picture type only: 0 an I picture, 1 a P picture,
  // −1 none (a disposable FLV1 picture before the second reference is
  // skipped: peek the packets before the first decoded one in order).
  int peek(const uint8_t* data, size_t n);
  // Which decoder a fourcc names: 1 FLV1, 2 MS-MPEG4 v2, 3 v3, 4 WMV1,
  // 5 WMV2, 6 ITU H.263; −1 MS-MPEG4 v1 (not read); 0 none.
  static int variant(const std::string& tag);
  // An ITU H.263 picture's size from its header; false for other tags
  // and where the header gives none (H.263+ with UFEP 0).
  static bool picture_size(const std::string& tag, const uint8_t* data,
                           size_t n, int& w, int& h);

 private:
  struct State;
  std::unique_ptr<State> s_;
};

// libavcodec's H.261 decoder (see h261.cpp): QCIF and CIF pictures, all
// P pictures (the first is all intra as encoders write it; a picture
// before any reference predicts from mid-grey, as libavcodec's dummy).
class H261Decoder {
 public:
  H261Decoder();
  ~H261Decoder();
  // Decode one packet; true with `out` filled, false for an empty one.
  bool decode(const uint8_t* data, size_t n, Picture& out);
  // A picture's size from its header; false without a picture start.
  static bool picture_size(const uint8_t* data, size_t n, int& w, int& h);

 private:
  struct State;
  std::unique_ptr<State> s_;
};

// libavcodec's magicyuv decoder (see magicyuv.cpp): each packet one
// picture, which carries its own size and layout.
class MagicyuvDecoder {
 public:
  MagicyuvDecoder();
  ~MagicyuvDecoder();
  bool decode(const uint8_t* data, size_t n, Picture& out);
  // A packet's picture size from its header; false without one.
  static bool picture_size(const uint8_t* data, size_t n, int& w, int& h);

 private:
  struct State;
  std::unique_ptr<State> s_;
};

// libavcodec's asv1 and asv2 decoders (see asv.cpp): each packet one
// intra picture of 4:2:0.
class AsvDecoder {
 public:
  // `version`: 1 (ASV1) or 2 (ASV2); `extradata`: the bytes after the
  // BITMAPINFOHEADER (the encoder's quantiser first); w, h: the
  // container's picture size.
  AsvDecoder(int version, const std::vector<uint8_t>& extradata, int w,
             int h);
  ~AsvDecoder();
  bool decode(const uint8_t* data, size_t n, Picture& out);

 private:
  struct State;
  std::unique_ptr<State> s_;
};

// libavcodec's snow decoder (see snow.cpp): a keyframe decodes on its
// own, other frames predict from up to 8 pictures before them back to
// the last keyframe; no picture is held back.
class SnowDecoder {
 public:
  // w, h: the container's picture size (Snow's packets carry none).
  SnowDecoder(int w, int h);
  ~SnowDecoder();
  bool decode(const uint8_t* data, size_t n, Picture& out);
  // 0 for a keyframe's packet, 1 another.
  static int peek(const uint8_t* data, size_t n);

 private:
  struct State;
  std::unique_ptr<State> s_;
};

// One PNG image of a video packet (libavcodec's png decoder: MPNG, PNG1,
// "png ") → the picture as libavcodec gives it and swscale converts it
// (see imagedec.cpp).
void decode_png_picture(const uint8_t* data, size_t n, Picture& out);

}  // namespace viai_video
