"""ctypes bindings of the port's native host library (csrc/wavio.cpp,
csrc/framestack.cpp, csrc/imagedec.cpp, csrc/videodec.cpp,
csrc/mpeg4.cpp, csrc/mpeg12.cpp, csrc/vp8.cpp, csrc/vp9.cpp,
csrc/h264.cpp, csrc/hevc.cpp, csrc/rawvideo.cpp, csrc/ffv1.cpp,
csrc/utvideo.cpp, csrc/huffyuv.cpp, csrc/msmpeg4.cpp, csrc/h261.cpp,
csrc/magicyuv.cpp, csrc/asv.cpp, csrc/snow.cpp).

The port's copy of `viai_tpu/native/__init__.py`: WAV decode and linear
resampling, the frame-stack reader (npy uint8 stacks and uncompressed
AVI: window select, Pillow-style triangle resize, [0, 1] float32) and
the threaded random-crop clip loader; where the JAX package calls PIL,
the JPEG and PNG decoder (`decode_image`) and the frame-directory reader
(`load_frame_dir`), whose plain twin is `data/image.py`; and where it
calls cv2, the compressed video reader: the demuxers (`video_track`),
the MJPEG, MPEG-4 Part 2, MPEG-1/2, VP8, VP9, H.264 and HEVC decoders,
libavcodec's rawvideo and v210 decoders for uncompressed video and its
lossless FFV1, UT Video, HuffYUV/FFVHuff and PNG decoders, with
swscale's conversion to BGR and cv2's turn by the display orientation
(`decode_video`, `raw_to_bgr`) and the frame path
of `_load_frames_video` (`load_video_frames`).
`_build.py` compiles the library with g++ at first use; a failed build
raises, and there is no flag to go without it (the JAX module falls
back to numpy quietly).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import os

import numpy as np

from . import _build

_F32P = ctypes.POINTER(ctypes.c_float)
MAX_WAV_SAMPLES = 16000 * 600


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The library, built if needed, with every function's types."""
    lib = _build.library("native")
    lib.viai_decode_wav.restype = ctypes.c_int64
    lib.viai_decode_wav.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, _F32P, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32)]
    lib.viai_resample_linear.restype = None
    lib.viai_resample_linear.argtypes = [
        _F32P, ctypes.c_int64, ctypes.c_int32, _F32P, ctypes.c_int64,
        ctypes.c_int32]
    lib.viai_loader_create.restype = ctypes.c_void_p
    lib.viai_loader_create.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int64, ctypes.c_uint64]
    lib.viai_loader_next.restype = ctypes.c_int32
    lib.viai_loader_next.argtypes = [ctypes.c_void_p, _F32P]
    lib.viai_loader_destroy.restype = None
    lib.viai_loader_destroy.argtypes = [ctypes.c_void_p]
    lib.viai_load_frames.restype = ctypes.c_int32
    lib.viai_load_frames.argtypes = [
        ctypes.c_char_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_float,
        ctypes.c_float, _F32P]
    lib.viai_decode_image.restype = ctypes.c_void_p
    lib.viai_decode_image.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_char_p, ctypes.c_int32]
    lib.viai_image_free.restype = None
    lib.viai_image_free.argtypes = [ctypes.c_void_p]
    lib.viai_video_open.restype = ctypes.c_void_p
    lib.viai_video_open.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32), ctypes.c_char_p,
        ctypes.c_int32]
    lib.viai_video_close.restype = None
    lib.viai_video_close.argtypes = [ctypes.c_void_p]
    lib.viai_video_info.restype = None
    lib.viai_video_info.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_char_p,
        ctypes.c_char_p, ctypes.c_int32]
    lib.viai_video_packet.restype = ctypes.c_void_p
    lib.viai_video_packet.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32)]
    lib.viai_video_config.restype = ctypes.c_void_p
    lib.viai_video_config.argtypes = [ctypes.c_void_p]
    lib.viai_video_decode.restype = ctypes.c_void_p
    lib.viai_video_decode.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_char_p, ctypes.c_int32]
    lib.viai_video_free.restype = None
    lib.viai_video_free.argtypes = [ctypes.c_void_p]
    lib.viai_yuv_to_bgr.restype = ctypes.c_int32
    lib.viai_yuv_to_bgr.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p] + [
        ctypes.c_int32] * 11 + [ctypes.c_void_p, ctypes.c_char_p,
                                ctypes.c_int32]
    lib.viai_raw_to_bgr.restype = ctypes.c_int32
    lib.viai_raw_to_bgr.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_uint32] + [
        ctypes.c_int32] * 4 + [ctypes.c_char_p, ctypes.c_int64,
                               ctypes.c_void_p, ctypes.c_char_p,
                               ctypes.c_int32]
    lib.viai_load_video_frames.restype = ctypes.c_int32
    lib.viai_load_video_frames.argtypes = [
        ctypes.c_char_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_double,
        ctypes.c_double, _F32P, ctypes.c_char_p, ctypes.c_int32]
    lib.viai_load_frame_dir.restype = ctypes.c_int32
    lib.viai_load_frame_dir.argtypes = [
        ctypes.c_char_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_double,
        ctypes.c_double, ctypes.c_int32, _F32P, ctypes.c_char_p,
        ctypes.c_int32]
    return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_F32P)


def decode_wav(data: bytes, max_samples: int = MAX_WAV_SAMPLES
               ) -> tuple[np.ndarray, int]:
    """WAV bytes → (mono float32 samples, sample rate): PCM 8/16/24/32
    or float32, channels averaged, at most `max_samples`. Raises
    ValueError on a buffer it cannot decode."""
    out = np.empty(max_samples, np.float32)
    sr = ctypes.c_int32(0)
    n = library().viai_decode_wav(data, len(data), _ptr(out), max_samples,
                                  ctypes.byref(sr))
    if n < 0:
        raise ValueError("not a decodable WAV buffer")
    return out[:n].copy(), int(sr.value)


def resample_linear(x: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Linear interpolation of x at sr_in onto int(len·sr_out/sr_in)
    samples at sr_out."""
    x = np.ascontiguousarray(x, np.float32)
    out = np.empty(int(len(x) * sr_out / sr_in), np.float32)
    library().viai_resample_linear(_ptr(x), len(x), sr_in, _ptr(out),
                                   len(out), sr_out)
    return out


# viai_load_frames' codes for a container it does not read.
UNSUPPORTED = {-11: "npy stack of another dtype than uint8",
               -12: "Fortran-ordered npy stack",
               -13: "npy stack not shaped (T, H, W, 3)",
               -22: "compressed or top-down 24-bit AVI video"}


def load_frames(path: str, n_frames: int, size: int,
                window: tuple[float, float] | None = None) -> np.ndarray:
    """A `.npy` uint8 (T, H, W, 3) stack or an uncompressed AVI →
    (n_frames, size, size, 3) float32 in [0, 1]: frames at
    round(linspace(w0·(T−1), w1·(T−1), n_frames)) over the fractional
    `window` of the source (all of it by default), each resized with a
    Pillow-style triangle filter. Raises NotImplementedError, naming the
    layout, for a container it does not read, ValueError for a broken
    file."""
    w0, w1 = (0.0, 1.0) if window is None else window
    out = np.empty((n_frames, size, size, 3), np.float32)
    rc = library().viai_load_frames(path.encode(), n_frames, size,
                                    ctypes.c_float(w0), ctypes.c_float(w1),
                                    _ptr(out))
    if rc in UNSUPPORTED:
        raise NotImplementedError(f"{path}: {UNSUPPORTED[rc]} is not read "
                                  f"by viai_tpu_torch")
    if rc != 0:
        raise ValueError(f"native frame decode failed ({rc}) for {path}")
    return out


# imagedec.cpp's and videodec.cpp's codes: 1 a broken file, 2 a variant
# it does not read, 3 a directory without frames.
_IMAGE_ERRORS = {1: ValueError, 2: NotImplementedError,
                 3: FileNotFoundError}
_ERR_LEN = 512


def host_cores() -> int:
    """The cores this process may run on."""
    return len(os.sched_getaffinity(0))


def _image_error(code: int, err) -> Exception:
    msg = err.value.decode(errors="replace")
    return _IMAGE_ERRORS[code](f"{msg} (viai_tpu_torch's decoder)")


def decode_image(data: bytes) -> np.ndarray:
    """JPEG or PNG bytes → (H, W, 3) uint8, what PIL's
    `Image.open(...).convert("RGB")` gives (JPEG as libjpeg-turbo
    decodes it at PIL's settings). Raises ValueError for a broken file,
    NotImplementedError for a variant it does not read (arithmetic,
    12-bit, lossless or CMYK JPEG, another format)."""
    lib = library()
    hw = (ctypes.c_int32 * 2)()
    code = ctypes.c_int32(0)
    err = ctypes.create_string_buffer(_ERR_LEN)
    ptr = lib.viai_decode_image(data, len(data), hw, ctypes.byref(code), err,
                                _ERR_LEN)
    if not ptr:
        raise _image_error(code.value, err)
    try:
        return np.ctypeslib.as_array(
            ctypes.cast(ptr, ctypes.POINTER(ctypes.c_uint8)),
            shape=(hw[0], hw[1], 3)).copy()
    finally:
        lib.viai_image_free(ptr)


def load_frame_dir(path: str, n_frames: int, size: int,
                   window: tuple[float, float] | None = None,
                   threads: int | None = None) -> np.ndarray:
    """A directory of jpeg/png frames → (n_frames, size, size, 3) float32
    in [0, 1], as `viai_tpu/data/av.py::_load_frames_dir` computes it:
    the names ending in .jpg, .jpeg or .png (any case) in sorted order,
    the frames at round(linspace(w0·(T−1), w1·(T−1), n_frames)) in
    float64 over the fractional `window` (all of it by default), each
    decoded (only the picked files, over `threads` threads made for the
    call, by default one a core), resized by Pillow's 8-bit BILINEAR and
    / 255. Raises FileNotFoundError for a directory without frames,
    ValueError for a broken file and NotImplementedError for one it does
    not read."""
    if n_frames < 1 or size < 1:
        raise ValueError(f"n_frames {n_frames} and size {size} must be "
                         f"positive")
    w0, w1 = (0.0, 1.0) if window is None else window
    out = np.empty((n_frames, size, size, 3), np.float32)
    err = ctypes.create_string_buffer(_ERR_LEN)
    code = library().viai_load_frame_dir(
        os.fsencode(path), n_frames, size, float(w0), float(w1),
        host_cores() if threads is None else max(int(threads), 1),
        _ptr(out), err, _ERR_LEN)
    if code:
        raise _image_error(code, err)
    return out


# videodec.cpp's codecs (VideoTrack.codec): "raw" is uncompressed video
# (csrc/rawvideo.cpp); "ffv1", "utvideo", "huffyuv" (HuffYUV and FFVHuff)
# and "png" the lossless codecs; "h263" the H.263 family (csrc/msmpeg4.cpp:
# FLV1, MS-MPEG4, WMV, ITU H.263 and H.263+), "h261" H.261
# (csrc/h261.cpp); "magicyuv" MagicYUV (csrc/magicyuv.cpp), "asv" ASUS
# ASV1 and ASV2 (csrc/asv.cpp), "snow" Snow (csrc/snow.cpp).
VIDEO_CODECS = ("mjpeg", "mpeg4", "vp8", "vp9", "h264", "mpeg12", "raw",
                "hevc", "ffv1", "utvideo", "huffyuv", "png", "h263", "h261",
                "magicyuv", "asv", "snow", "other")


@dataclasses.dataclass
class VideoTrack:
    """A video file's first video track as the port's demuxer gives it:
    the container ("AVI", "MP4" for .mp4/.mov, "Matroska" for .mkv and
    .webm), the fourcc or Matroska CodecID (`tag`), the codec
    ("mjpeg", "mpeg4", "vp8", "vp9", "h264", "mpeg12", "raw", "hevc",
    "ffv1", "utvideo", "huffyuv", "png", "h263" for the H.263 family,
    "h261", "magicyuv", "asv", "snow" or "other"), the
    size of its first picture as cv2's CAP_PROP_FRAME_WIDTH and HEIGHT
    report it
    (from the first packet's headers; the container's when they give
    none), the frame count cv2's CAP_PROP_FRAME_COUNT reports,
    the MPEG-4 or MPEG-1/2 headers or H.264 avcC or HEVC hvcC record the
    container
    holds (`config`), an AVI strf's bit count (`bits`; 0 elsewhere)
    and the packets libavformat gives cv2 in decode order (under an MP4
    edit, from the keyframe it starts from; an MP4's movie fragments after
    moov's own samples), each (bytes, the container's keyframe flag):
    H.264's and HEVC's as the container holds them (length-prefixed NAL
    units in MP4 and Matroska, Annex B in AVI); `orientation`, cv2's
    CAP_PROP_ORIENTATION_META, the clockwise turn of the display matrix
    (MP4: tkhd's times mvhd's; Matroska: a Projection's roll), which
    decode_video and load_video_frames apply as cv2 does when it is 90,
    180 or 270. Uncompressed video is codec "raw" under its fourcc: an
    AVI's strf compression ("BI_RGB" for 0), a Matroska track's
    "V_UNCOMPRESSED" and its ColourSpace (e.g. "V_UNCOMPRESSED I420")."""
    container: str
    tag: str
    codec: str
    width: int
    height: int
    count: int
    config: bytes
    packets: list
    orientation: int = 0
    bits: int = 0


def reads_frame_stack(track: VideoTrack) -> bool:
    """Whether `load_frames` (the frame-stack reader) is the reader of a
    video file, as in the JAX package, whose own AVI readers take
    exactly these: an AVI of strf compression `RGBA` at 32 bits, or of
    BI_RGB (compression 0) at 24 bits (load_frames raises for a top-down
    one, whose JAX reading is all zeros). Every other file goes to
    `load_video_frames`, as the JAX package sends it to cv2."""
    return track.container == "AVI" and (track.tag, track.bits) in (
        ("RGBA", 32), ("BI_RGB", 24))


def _open_video(path: str):
    lib = library()
    code = ctypes.c_int32(0)
    err = ctypes.create_string_buffer(_ERR_LEN)
    handle = lib.viai_video_open(os.fsencode(path), ctypes.byref(code), err,
                                 _ERR_LEN)
    if not handle:
        raise _image_error(code.value, err)
    return lib, handle


def video_track(path: str, packets: bool = True) -> VideoTrack:
    """Demux `path` (AVI, MP4/MOV, Matroska/WebM). Raises ValueError for
    a broken file, NotImplementedError for a container feature that is
    not read (an MP4 edit at another rate than 1, of duration 0, or
    several non-empty edits; a display matrix with a mirror; Matroska
    content encodings, a mirrored or cubemap Projection; a Matroska
    track without DefaultDuration at a variable rate, or of H.264 or
    MPEG-4 Part 2, whose own timing cv2 would read). AVI's OpenDML index
    and `RIFF AVIX` extensions are read; an MP4 edit list of one
    edit (after an empty one or not) is read as libavformat reads it:
    the packets from the keyframe before the edit on, those presented
    outside it marked to be decoded and dropped; MP4 movie fragments are
    read after moov's samples (libavformat applies no edit to them).
    Sound and other tracks are skipped; their timestamps enter a
    fragmented file's count as they enter cv2's."""
    lib, h = _open_video(path)
    try:
        info = (ctypes.c_int64 * 8)()
        tag = ctypes.create_string_buffer(_ERR_LEN)
        container = ctypes.create_string_buffer(_ERR_LEN)
        lib.viai_video_info(h, info, tag, container, _ERR_LEN)
        config = ctypes.string_at(lib.viai_video_config(h), info[4]) \
            if info[4] else b""
        pkts = []
        for i in range(info[3] if packets else 0):
            size, key = ctypes.c_int64(0), ctypes.c_int32(0)
            ptr = lib.viai_video_packet(h, i, ctypes.byref(size),
                                        ctypes.byref(key))
            pkts.append((ctypes.string_at(ptr, size.value), bool(key.value)))
        return VideoTrack(container.value.decode(), tag.value.decode(),
                          VIDEO_CODECS[info[5]], int(info[0]), int(info[1]),
                          int(info[2]), config, pkts, int(info[6]),
                          int(info[7]))
    finally:
        lib.viai_video_close(h)


def decode_video(path: str) -> np.ndarray:
    """Every frame of a video file, (T, H, W, 3) BGR uint8, as cv2's
    `VideoCapture(path).read()` gives them: MJPEG (4:2:0, 4:2:2, 4:4:4,
    4:4:0 or grey), MPEG-4 Part 2 (Simple and Advanced Simple Profile
    as libavcodec's encoder and XviD write them: B-VOPs, packed or not,
    in libavcodec's output order; quarter-pel, GMC, 4MV, AC prediction,
    MPEG quantisation, video packets, data partitioning; not interlace),
    VP8 and VP9 (their shown frames; VP9's profiles 0-3 at 8, 10 and 12
    bits, 4:2:0, 4:2:2, 4:4:0, 4:4:4 and sRGB, intra-only
    frames and references of another size), H.264 (frame pictures
    of Baseline, Main, High, High 10, High 4:2:2 and High 4:4:4
    Predictive at 8 to 10, 12 and 14 bits, 4:2:0, 4:2:2, 4:4:4, GBR
    and monochrome, lossless transform bypass too, progressive frames of
    interlace-capable streams too, in libavcodec's output order and
    number, its guessed reorder depth included; streams cut elsewhere
    than at an IDR picture, their pictures before a recovery point
    dropped as libavcodec drops them; long-term references, every MMCO,
    POC type 1, gaps in frame_num, explicit B weights, left and top
    crops), HEVC (Main, Main 10 and
    Main Still Picture as x265, phones and cameras write them: WPP,
    slices, AMP, transform skip, scaling lists, lossless, open GOPs, in
    libavcodec's output order and number, the RASL pictures of a CRA
    that begins the stream dropped); in AVI (OpenDML too),
    Matroska/WebM and MP4 (an edit list's dropped frames left out;
    fragmented too), converted to BGR24 as swscale does (its scaler for
    odd heights, 4:4:4/4:4:0 and 9 to 14 bits, H.264's chroma sited
    left) at the first picture's size (a
    picture of another size scaled to it, as cv2's swscale scales it) and
    turned as cv2 turns them by the track's orientation (90, 180 or 270
    degrees: the MP4 display matrix, a Matroska Projection's roll);
    uncompressed video in AVI and Matroska (V_UNCOMPRESSED) as
    libavcodec's rawvideo and v210 decoders read it (`raw_to_bgr`): planar
    4:2:0, 4:2:2, 4:4:4, 4:4:0 and 4:1:1 YUV (I420, IYUV, YV12, Y42B,
    YV16, YV24, Y41B ...), NV12 and NV21, grey (Y800, GREY, Y8),
    packed 4:2:2 (YUY2, UYVY, HDYC, 2vuy, YVYU ...), v210, BI_RGB at 8,
    16, 24 and 32 bits and RGBA/BGRA/RGB24/BGR24, up to the first packet
    shorter than a frame (cv2 reads no further).
    Raises ValueError for
    a broken file or one without frames (cv2's own YUY2 and UYVY files,
    whose packets hold 1.5 bytes a pixel; an AVI tagged 444P, P010,
    BGR24 or RGB24, which libavformat names no codec for; a
    V_UNCOMPRESSED track without a ColourSpace), NotImplementedError
    naming the codec (AV1, FFV1, ...), the uncompressed layout or
    the MJPEG, MPEG-4, VP8, VP9, H.264, HEVC or container feature it
    does not read."""
    lib, h = _open_video(path)
    try:
        thw = (ctypes.c_int64 * 3)()
        code = ctypes.c_int32(0)
        err = ctypes.create_string_buffer(_ERR_LEN)
        ptr = lib.viai_video_decode(h, thw, ctypes.byref(code), err,
                                    _ERR_LEN)
        if not ptr:
            raise _image_error(code.value, err)
        try:
            return np.ctypeslib.as_array(
                ctypes.cast(ptr, ctypes.POINTER(ctypes.c_uint8)),
                shape=(thw[0], thw[1], thw[2], 3)).copy()
        finally:
            lib.viai_video_free(ptr)
    finally:
        lib.viai_video_close(h)


def yuv_to_bgr(y: np.ndarray, u: np.ndarray, v: np.ndarray,
               shift: tuple[int, int] = (1, 1), depth: int = 8,
               full_range: bool = False, matrix: int = 5,
               chroma_loc: int = 0, size: tuple[int, int] | None = None,
               rgb: bool = False, grey: bool = False) -> np.ndarray:
    """Planes of a decoded picture → (h, w, 3) BGR uint8, as the video
    reader converts them (swscale's routes to BGR24, as cv2 runs them):
    `y` (h, w), `u` and `v` (h >> yshift, w >> xshift, rounded up) for
    `shift` = (xshift, yshift): (1, 1) 4:2:0, (1, 0) 4:2:2, (0, 0) 4:4:4,
    (0, 1) 4:4:0, (2, 0) 4:1:1, (2, 2) 4:1:0; uint8 at depth 8, uint16
    holding 9 to 16-bit samples;
    limited range unless `full_range`; `matrix` swscale's colour space (5
    BT.601, 1 BT.709, 9 BT.2020); `chroma_loc` the frame's
    AVChromaLocation (0 unspecified, 1 left as H.264's frames, 2 centre,
    3 top left ...), where swscale's scaler places the chroma samples;
    `size` (h, w), scaled to it as swscale's bicubic scaler scales a
    picture of another size than a stream's first; `rgb`, planar G, B, R
    (gbrp) in y, u, v at (0, 0); `grey`, 8-bit grey in y (u and v, at
    (0, 0), not read)."""
    h, w = y.shape
    dh, dw = size or (h, w)
    xs, ys = shift
    kind = np.uint8 if depth == 8 else np.uint16
    planes = [np.ascontiguousarray(p, kind) for p in (y, u, v)]
    if u.shape != v.shape or u.shape != (-(-h >> ys), -(-w >> xs)):
        raise ValueError("chroma planes of another size than the layout's")
    out = np.empty((dh, dw, 3), np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    rc = library().viai_yuv_to_bgr(
        *(p.ctypes.data for p in planes), w, h, xs, ys, depth,
        int(full_range), matrix, chroma_loc, dw, dh, 1 if rgb else 2 * grey,
        out.ctypes.data, err, _ERR_LEN)
    if rc:
        raise _image_error(rc, err)
    return out


def raw_to_bgr(data: bytes, tag: str | bytes, width: int, height: int,
               bits: int = 0, bottom_up: bool = False,
               extradata: bytes = b"") -> np.ndarray:
    """One frame of uncompressed video → (height, width, 3) BGR uint8, as
    cv2 reads it: libavcodec's rawvideo (or v210) decoder for the fourcc
    `tag` (4 bytes, e.g. "I420", "YUY2", "v210"; "BI_RGB" for a DIB
    of `bits` a pixel, bottom-up when `bottom_up`, its pal8 colour table
    at the end of `extradata`), then swscale's route to BGR24. Raises
    ValueError for a packet shorter than a frame, NotImplementedError for
    a layout that is not read."""
    if tag == "BI_RGB":
        code = 0
    else:
        raw = tag.encode("latin-1") if isinstance(tag, str) else bytes(tag)
        if len(raw) != 4:
            raise ValueError(f"a fourcc is 4 bytes, not {tag!r}")
        code = int.from_bytes(raw, "little")
    out = np.empty((height, width, 3), np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    rc = library().viai_raw_to_bgr(
        bytes(data), len(data), code, bits, width, height, int(bottom_up),
        bytes(extradata), len(extradata), out.ctypes.data, err, _ERR_LEN)
    if rc:
        raise _image_error(rc, err)
    return out


def load_video_frames(path: str, n_frames: int, size: int,
                      window: tuple[float, float] | None = None
                      ) -> np.ndarray:
    """A video file, compressed or uncompressed (every format of
    decode_video) → (n_frames, size, size, 3) float32 RGB in
    [0, 1], what `viai_tpu/data/av.py::_load_frames_video` computes with
    cv2: the indices round(linspace(w0·(T−1), w1·(T−1), n_frames)) in
    float64 of cv2's frame count T over the fractional `window` (all of
    it by default), as a set; the frames decoded at those indices (an
    index past the last frame, or of an uncompressed packet at or after
    the first one shorter than a frame, is never reached), each turned
    as cv2 turns it, resized by cv2.resize at INTER_LINEAR on BGR,
    flipped to RGB, / 255; those
    frames re-picked by the same rule over all of them when they are
    not n_frames. Raises as decode_video."""
    if n_frames < 1 or size < 1:
        raise ValueError(f"n_frames {n_frames} and size {size} must be "
                         f"positive")
    w0, w1 = (0.0, 1.0) if window is None else window
    out = np.empty((n_frames, size, size, 3), np.float32)
    err = ctypes.create_string_buffer(_ERR_LEN)
    code = library().viai_load_video_frames(
        os.fsencode(path), n_frames, size, float(w0), float(w1), _ptr(out),
        err, _ERR_LEN)
    if code:
        raise _image_error(code, err)
    return out


class NativeClipLoader:
    """Threaded random-crop WAV batch loader (a C++ worker pool).

    Each worker's file and crop stream is a function of (seed, worker),
    and each worker assembles whole batches: one worker gives a
    reproducible batch sequence; with more, the interleaving of the
    workers' batches depends on thread scheduling. Files are drawn with
    replacement, forever (no epochs).
    """

    def __init__(self, paths, clip_samples: int, target_sr: int = 16000,
                 batch: int = 16, n_workers: int = 4, queue_depth: int = 8,
                 seed: int = 0):
        lib = library()
        blob = "\n".join(str(p) for p in paths).encode()
        self._lib = lib
        self._handle = lib.viai_loader_create(
            blob, clip_samples, target_sr, batch, n_workers, queue_depth,
            seed)
        if not self._handle:
            raise ValueError("no usable paths given to NativeClipLoader")
        self.batch = batch
        self.clip_samples = clip_samples

    def next(self) -> np.ndarray:
        out = np.empty((self.batch, self.clip_samples), np.float32)
        if self._lib.viai_loader_next(self._handle, _ptr(out)) != 0:
            raise StopIteration
        return out

    def __iter__(self):
        return self

    def __next__(self):
        return self.next()

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.viai_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()
