"""Compressed video clips for the port's video reader, and cv2's decodes.

    python tests/_torch_make_videos.py [out_dir [case ...]]

writes `tests/torch_videos/` (every case, or the named ones; needs cv2,
which the card's machine does not have, so the fixtures are committed):
  * `<case>.<ext>`: every case of CASES, written by cv2's VideoWriter
    (ffmpeg's MJPEG and MPEG-4 Part 2 encoders and libvpx's VP8 and VP9,
    in AVI, MP4, MOV, Matroska and WebM); the AVIs of HAND_CASES, muxed here:
    MJPEG packets without their Huffman tables (the AVI1 convention: the
    decoder takes the standard tables of JPEG's annex K), and one whose
    headers count more frames than it holds; the MP4s of MP4_MJPEG_CASES,
    cv2's MJPEG packets muxed here under the `mjpa` and `MJPG` sample
    entries (cv2's writer puts MJPG in MP4 under an `mp4v` entry whose
    esds objectTypeIndication is 0x6C, JPEG: `mjpeg_mp4v_mp4`); the MP4 of
    VP8_MP4_CASES, cv2's VP8 packets muxed here under a `vp08` sample entry
    with its vpcC box (cv2's writer does not put VP8 in MP4);
    the VP8 Matroska files of VP8_PATCHED, cv2's stream with bits of its
    frame tags or keyframe sizes changed (a hidden frame, versions 1-3,
    an odd width with the scaling fields set), which cv2 still reads;
    the AVIs of LIBVPX_CASES, VP8 and VP9 written by libvpx's own API
    (the library cv2's wheel bundles, through ctypes, `libvpx_encode`)
    with the settings cv2's writer does not reach. VP8: token
    partitions, sharpness, error-resilient mode (segmentation, no
    entropy refresh), a region-of-interest map (segment quantiser and
    level deltas), two-pass alt-ref frames (hidden, sign-biased), profile
    1 (bilinear, simple loop filter). VP9: one-pass good quality with
    backward adaptation (switchable filters, every transform size),
    two-pass alt-ref (superframes, hidden frames, compound prediction),
    2x2 tiles at 512x128, cyclic-refresh AQ (segmentation with temporal
    map prediction), an ROI map (segment quantiser, level, reference and
    skip), error-resilient with frame-parallel decoding (no adaptation,
    contexts reset), realtime speed 8, lossless at 64x64 (WHT), an odd
    width, full colour range and BT.709 (which cv2's conversion applies);
  * `<case>.npz`: cv2's view of it: `n`, the frames `cap.read()` gives;
    `frames`, the first, the middle and the last of them ((3, H, W, 3)
    BGR uint8, at `index`); and `count`, `CAP_PROP_FRAME_COUNT`;
  * `clip.avi`, `clip.mp4`, `clip.mkv`, `clip.mov`, `clip.webm`,
    `clip_vp8.mkv`, `clip_vp9.webm`, `clip_vp9.mp4`: the first frames of
    the committed 224x224 jpeg clip
    (tests/torch_frames/clip/) as video (CLIP_CASES), the clips
    chip_smoke.py trains from.

The small cases are 72x56 (not a multiple of 16) with a textured square
that moves over a drifting background, so that the MPEG-4 and VP8 clips'
inter frames carry motion and, at 30 frames, a third I-VOP or keyframe
(ffmpeg's GOP is 12 for all three). The encoders are deterministic here, so a
rerun rewrites the same bytes, but for the Matroska and WebM files'
random segment UID. tests/test_torch_video_decode.py holds the port
against cv2 live and against these files.
"""

from __future__ import annotations

import io
import os
import struct
import sys

import numpy as np

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "torch_videos")
CLIP_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "torch_frames", "clip")
H, W = 56, 72

# name: (ext, fourcc, fps, frames)
CASES = {
    "mjpeg_avi": ("avi", "MJPG", 25, 20),
    "mjpeg_mp4v_mp4": ("mp4", "MJPG", 25, 20),   # an mp4v entry, OTI 0x6C
    "mjpeg_mkv": ("mkv", "MJPG", 25, 20),
    "mjpeg_mov": ("mov", "MJPG", 25, 20),
    "mjpeg_8fps_mkv": ("mkv", "MJPG", 8, 13),
    "mpeg4_avi": ("avi", "mp4v", 25, 30),
    "mpeg4_mp4": ("mp4", "mp4v", 25, 30),
    "mpeg4_mkv": ("mkv", "mp4v", 25, 30),
    "mpeg4_mov": ("mov", "mp4v", 25, 30),
    "mpeg4_2997_mkv": ("mkv", "mp4v", 30000 / 1001, 25),
    "mpeg4_8fps_mkv": ("mkv", "mp4v", 8, 17),
    "xvid_avi": ("avi", "XVID", 25, 14),
    "vp8_webm": ("webm", "VP80", 25, 20),
    "vp8_mkv": ("mkv", "VP80", 25, 20),
    "vp8_avi": ("avi", "VP80", 25, 20),
    "vp8_8fps_mkv": ("mkv", "VP80", 8, 13),
    "vp8_2997_mkv": ("mkv", "VP80", 30000 / 1001, 25),
    "vp8_long_webm": ("webm", "VP80", 25, 40),        # keyframes 0, 12, 24, 36
    "vp9_webm": ("webm", "VP90", 25, 40),             # keyframes 0, 12, 24, 36
    "vp9_mkv": ("mkv", "VP90", 25, 20),
    "vp9_avi": ("avi", "VP90", 25, 20),
    "vp9_mp4": ("mp4", "vp09", 25, 20),
}
# name: the sample entry of cv2's MJPEG packets in a hand-muxed MP4
MP4_MJPEG_CASES = {"mjpeg_mjpa_mp4": b"mjpa", "mjpeg_mjpg_mp4": b"MJPG"}
# name: what is changed in cv2's 30-frame VP8 Matroska file
VP8_PATCHED = {
    "vp8_hidden_mkv": "show_frame cleared in packet 5",
    "vp8_v1_mkv": "version 1 in every frame tag",
    "vp8_v2_mkv": "version 2 in every frame tag",
    "vp8_v3_mkv": "version 3 in every frame tag",
    "vp8_odd_mkv": "width 71 (keyframes, PixelWidth), scaling fields 1, 2",
}
# name: the sample entry of cv2's VP8 packets in a hand-muxed MP4
VP8_MP4_CASES = {"vp8_mp4": b"vp08"}
# name: libvpx settings (see libvpx_encode; `size` (h, w), else 72x56;
# `zoom`, frames drawn at 1/zoom the size and enlarged, so that their
# decodes stay small in the .npz), 40 frames at 25 fps in AVI
LIBVPX_CASES = {
    "vp8_partitions_avi": dict(token_partitions=2, sharpness=5),
    "vp8_resilient_avi": dict(error_resilient=True),
    "vp8_roi_avi": dict(roi=True),
    "vp8_altref_avi": dict(two_pass=True),
    "vp8_profile1_avi": dict(profile=1),
    "vp9_good_avi": dict(frame_parallel=False, sharpness=3),
    "vp9_twopass_avi": dict(two_pass=True, frame_parallel=False,
                            size=(64, 96)),             # 21 compound blocks
    "vp9_tiles_avi": dict(tile_cols=1, tile_rows=1, frame_parallel=False,
                          size=(128, 512), zoom=4),
    "vp9_aq_avi": dict(aq_mode=3, frame_parallel=False),
    "vp9_roi_avi": dict(roi=True, frame_parallel=False, realtime_speed=5),
    "vp9_resilient_avi": dict(error_resilient=True, frame_parallel=True),
    "vp9_rt_avi": dict(realtime_speed=8, frame_parallel=False),
    "vp9_lossless_avi": dict(lossless=True, frame_parallel=False,
                             size=(64, 64)),
    "vp9_oddw_avi": dict(frame_parallel=False, size=(56, 71)),
    "vp9_range_avi": dict(color_range=1),
    "vp9_bt709_avi": dict(color_space=2),
}
# name: (frames, frame count the headers give, fps)
HAND_CASES = {
    "mjpeg_nodht_avi": (12, 12, 25),
    "mjpeg_longhdr_avi": (12, 17, 25),
}
# the clips chip_smoke.py trains from: name: (ext, fourcc, frames), the
# first frames of the 32.
CLIP_CASES = {"clip_avi": ("avi", "MJPG", 16), "clip_mp4": ("mp4", "mp4v", 16),
              "clip_mkv": ("mkv", "mp4v", 8), "clip_mov": ("mov", "MJPG", 8),
              "clip_webm": ("webm", "VP80", 8),
              "clip_vp8_mkv": ("mkv", "VP80", 8),
              "clip_vp9_webm": ("webm", "VP90", 8),
              "clip_vp9_mp4": ("mp4", "vp09", 8)}
# Every case held against cv2 (an .npz each), and the codec it holds.
DECODED = (*CASES, *HAND_CASES, *MP4_MJPEG_CASES, *VP8_PATCHED,
           *VP8_MP4_CASES, *LIBVPX_CASES)


def codec_of(name: str) -> str:
    """The codec a case holds, by its name."""
    if name in CLIP_CASES:
        return {"MJPG": "mjpeg", "mp4v": "mpeg4", "VP80": "vp8",
                "VP90": "vp9", "vp09": "vp9"}[CLIP_CASES[name][1]]
    return {"xvid": "mpeg4"}.get(name.split("_")[0], name.split("_")[0])


def path_of(name: str) -> str:
    if name in CLIP_CASES:
        return os.path.join(FIXTURES, name.rsplit("_", 1)[0] + "." +
                            CLIP_CASES[name][0])
    return os.path.join(FIXTURES, f"{name}.{name.rsplit('_', 1)[1]}")


def moving_frames(seed: int, t: int, h: int = H, w: int = W) -> np.ndarray:
    """(t, h, w, 3) uint8 BGR: drifting waves and a 24x24 smooth random
    texture moving 2 px right and 1 px down a frame."""
    rng = np.random.default_rng(seed)
    coarse = rng.uniform(0, 255, (5, 5, 3))
    u = np.linspace(0, 4, 24)
    i0 = np.minimum(u.astype(int), 3)
    a = (u - i0)[:, None, None]
    rows = coarse[i0] * (1 - a) + coarse[i0 + 1] * a         # (24, 5, 3)
    tex = rows[:, i0] * (1 - a[:, 0]) + rows[:, i0 + 1] * a[:, 0]
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    out = np.empty((t, h, w, 3), np.uint8)
    for k in range(t):
        f = np.stack([128 + 100 * np.sin((x + 3 * k) / 9.0),
                      128 + 90 * np.cos((y - k) / 7.0),
                      128 + 80 * np.sin((x + y + 2 * k) / 13.0)], -1)
        y0, x0 = 4 + k, 5 + 2 * k
        hh, ww = max(min(24, h - y0), 0), max(min(24, w - x0), 0)
        f[y0:y0 + hh, x0:x0 + ww] = tex[:hh, :ww]
        out[k] = np.clip(np.rint(f), 0, 255)
    return out


def write_cv2(path: str, fourcc: str, fps: float, frames) -> None:
    import cv2

    h, w = frames[0].shape[:2]
    wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*fourcc), fps, (w, h))
    if not wr.isOpened():
        raise RuntimeError(f"cv2 cannot write {fourcc} to {path}")
    for f in frames:
        wr.write(np.ascontiguousarray(f))
    wr.release()


def strip_dht(jpeg: bytes) -> bytes:
    """A JPEG without its DHT segments (standard tables assumed)."""
    out, p = bytearray(jpeg[:2]), 2
    while p < len(jpeg):
        m = jpeg[p + 1]
        n = struct.unpack(">H", jpeg[p + 2:p + 4])[0]
        if m == 0xDA:
            out += jpeg[p:]
            break
        if m != 0xC4:
            out += jpeg[p:p + 2 + n]
        p += 2 + n
    return bytes(out)


def _chunk(tag: bytes, data: bytes) -> bytes:
    return tag + struct.pack("<I", len(data)) + data + b"\0" * (len(data) & 1)


def _list(tag: bytes, data: bytes) -> bytes:
    return _chunk(b"LIST", tag + data)


def avi_file(packets: list[bytes], w: int, h: int, fps: int, count: int,
             fourcc: bytes = b"MJPG") -> bytes:
    """An AVI of video packets (stream 0 'vids' `fourcc`, `00dc` chunks,
    an idx1 index with every packet a keyframe) whose avih and strh say
    `count` frames."""
    avih = struct.pack("<14I", 1000000 // fps, 0, 0, 0x10, count, 0, 1, 0,
                       w, h, 0, 0, 0, 0)
    strh = (b"vids" + fourcc + struct.pack(
        "<IHHIIIIIIIIhhhh", 0, 0, 0, 0, 1, fps, 0, count, 0, 0xFFFFFFFF, 0,
        0, 0, w, h))
    strf = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 24, fourcc, w * h * 3,
                       0, 0, 0, 0)
    hdrl = _list(b"hdrl", _chunk(b"avih", avih) + _list(
        b"strl", _chunk(b"strh", strh) + _chunk(b"strf", strf)))
    movi, idx, off = b"", b"", 4
    for p in packets:
        c = _chunk(b"00dc", p)
        idx += b"00dc" + struct.pack("<III", 0x10, off, len(p))
        movi += c
        off += len(c)
    body = hdrl + _list(b"movi", movi) + _chunk(b"idx1", idx)
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"AVI " + body


def _box(kind: bytes, *parts: bytes) -> bytes:
    body = b"".join(parts)
    return struct.pack(">I", 8 + len(body)) + kind + body


def _full_box(kind: bytes, flags: int, *parts: bytes) -> bytes:
    return _box(kind, struct.pack(">I", flags), *parts)


def mp4_file(packets: list[bytes], w: int, h: int, fps: int,
             entry: bytes, boxes: bytes = b"") -> bytes:
    """An MP4 of one video track: `packets` as its samples (each a sync
    sample, one chunk, 1/fps apart) under the visual sample entry
    `entry` (a fourcc) holding the extension `boxes`."""
    n = len(packets)
    matrix = struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0,
                         0x40000000)
    sample_entry = _box(entry, bytes(6), struct.pack(
        ">HHH12xHHIIIH32sHh", 1, 0, 0, w, h, 0x480000, 0x480000, 0, 1,
        b"", 24, -1), boxes)

    def moov(mdat_at: int) -> bytes:
        stbl = _box(
            b"stbl",
            _full_box(b"stsd", 0, struct.pack(">I", 1), sample_entry),
            _full_box(b"stts", 0, struct.pack(">III", 1, n, 1)),
            _full_box(b"stsc", 0, struct.pack(">IIII", 1, 1, n, 1)),
            _full_box(b"stsz", 0, struct.pack(">II", 0, n),
                      *(struct.pack(">I", len(p)) for p in packets)),
            _full_box(b"stco", 0, struct.pack(">II", 1, mdat_at)))
        minf = _box(b"minf", _full_box(b"vmhd", 1, bytes(8)),
                    _box(b"dinf", _full_box(b"dref", 0, struct.pack(
                        ">I", 1), _full_box(b"url ", 1))), stbl)
        mdia = _box(
            b"mdia",
            _full_box(b"mdhd", 0, struct.pack(">IIIIHH", 0, 0, fps, n,
                                              0x55C4, 0)),
            _full_box(b"hdlr", 0, struct.pack(">I4s12x", 0, b"vide"),
                      b"VideoHandler\0"), minf)
        tkhd = _full_box(b"tkhd", 3, struct.pack(">IIIII8xHHHH", 0, 0, 1,
                                                 0, n, 0, 0, 0, 0),
                         matrix, struct.pack(">II", w << 16, h << 16))
        mvhd = _full_box(b"mvhd", 0, struct.pack(">IIIIIH10x", 0, 0, fps,
                                                 n, 0x10000, 0x100),
                         matrix, bytes(24), struct.pack(">I", 2))
        return _box(b"moov", mvhd, _box(b"trak", tkhd, mdia))

    ftyp = _box(b"ftyp", b"isom", struct.pack(">I", 0x200), b"isomiso2mp41")
    head = ftyp + moov(0)
    return ftyp + moov(len(head) + 8) + _box(b"mdat", *packets)


def libvpx_encode(frames, codec: str = "vp8", fps: int = 25,
                  profile: int = 0, error_resilient: bool = False,
                  token_partitions: int = 0, sharpness: int = 0,
                  roi: bool = False, two_pass: bool = False,
                  tile_cols: int | None = None, tile_rows: int = 0,
                  aq_mode: int | None = None, lossless: bool = False,
                  frame_parallel: bool | None = None,
                  color_range: int | None = None,
                  color_space: int | None = None,
                  realtime_speed: int | None = None) -> list[bytes]:
    """VP8 or VP9 packets of `frames` (BGR) from libvpx's encoder API,
    loaded from the libvpx that cv2's wheel bundles (1.15's structure
    layouts): one thread, good quality, the given profile,
    error-resilient mode, sharpness; VP8's log2 token partitions; with
    `roi`, a 4-segment map (each macroblock's, or VP9's 8x8 block's,
    segment its index mod 4) with quantiser deltas 0, -10, 10, 20 and
    level deltas 0, 5, -5, 10 (VP9: segment 3 skipped and segment 2 held
    to the last frame; libvpx applies a VP9 map in realtime mode only);
    with `two_pass`, a first pass for its
    statistics, then alt-ref frames from 16 frames of lag. VP9's controls:
    log2 tile columns (None: libvpx's default, as many as the width
    allows) and rows, the AQ mode, lossless, frame-parallel decoding
    (None: libvpx's default, on), colour range (1 full) and colour space
    (2 BT.709), and a realtime speed (one pass, no lag, the realtime
    deadline)."""
    import ctypes
    import glob

    import cv2

    libs = os.path.join(os.path.dirname(os.path.dirname(cv2.__file__)),
                        "opencv_python.libs")
    lib = ctypes.CDLL(glob.glob(os.path.join(libs, "libvpx*.so*"))[0])
    vp = ctypes.c_void_p
    for name, res, args in (
            (f"vpx_codec_{codec}_cx", vp, []),
            ("vpx_codec_enc_config_default", ctypes.c_int,
             [vp, vp, ctypes.c_uint]),
            ("vpx_codec_enc_init_ver", ctypes.c_int,
             [vp, vp, vp, ctypes.c_long, ctypes.c_int]),
            ("vpx_codec_control_", ctypes.c_int, [vp, ctypes.c_int]),
            ("vpx_img_wrap", vp, [vp, ctypes.c_int, ctypes.c_uint,
                                  ctypes.c_uint, ctypes.c_uint, vp]),
            ("vpx_codec_encode", ctypes.c_int,
             [vp, vp, ctypes.c_int64, ctypes.c_ulong, ctypes.c_long,
              ctypes.c_ulong]),
            ("vpx_codec_get_cx_data", vp, [vp, vp]),
            ("vpx_codec_destroy", ctypes.c_int, [vp])):
        getattr(lib, name).restype = res
        getattr(lib, name).argtypes = args

    class RoiMap(ctypes.Structure):
        _fields_ = [("enabled", ctypes.c_uint8), ("roi_map", ctypes.c_void_p),
                    ("rows", ctypes.c_uint), ("cols", ctypes.c_uint),
                    ("delta_q", ctypes.c_int * 8),
                    ("delta_lf", ctypes.c_int * 8),
                    ("skip", ctypes.c_int * 8), ("ref_frame", ctypes.c_int * 8),
                    ("static_threshold", ctypes.c_uint * 4)]

    h, w = frames[0].shape[:2]
    vp9 = codec == "vp9"
    deadline = 1 if realtime_speed is not None else 1000000

    def run(pass_no: int, stats: bytes = b"") -> list[bytes]:
        iface = getattr(lib, f"vpx_codec_{codec}_cx")()
        cfg = (ctypes.c_uint32 * 1024)()           # vpx_codec_enc_cfg_t
        if lib.vpx_codec_enc_config_default(iface, cfg, 0):
            raise RuntimeError("libvpx: no default configuration")
        cfg[1], cfg[2], cfg[3], cfg[4] = 1, profile, w, h
        cfg[7], cfg[8], cfg[9] = 1, fps, int(error_resilient)
        cfg[10] = pass_no
        if two_pass:
            cfg[11] = 16                           # g_lag_in_frames
        if realtime_speed is not None:
            cfg[11] = 0
        keep = ctypes.create_string_buffer(stats, len(stats) or 1)
        if pass_no == 2:                           # rc_twopass_stats_in
            ctypes.c_void_p.from_buffer(cfg, 80).value = \
                ctypes.addressof(keep)
            ctypes.c_size_t.from_buffer(cfg, 88).value = len(stats)
        ctx = (ctypes.c_uint8 * 256)()
        # The ABI version the library was built with: the one it accepts.
        if not any(lib.vpx_codec_enc_init_ver(ctx, iface, cfg,
                                              ctypes.c_long(0), v) == 0
                   for v in range(1, 100)):
            raise RuntimeError("libvpx: the encoder does not initialise")
        controls = [(16, sharpness)]
        if not vp9:
            controls.append((18, token_partitions))
        if two_pass:
            controls.append((14, 1))               # ENABLEAUTOALTREF
        if vp9:
            for cid, val in ((33, tile_cols), (34, tile_rows or None),
                             (36, aq_mode), (32, int(lossless) or None),
                             (35, None if frame_parallel is None
                              else int(frame_parallel)),
                             (51, color_range), (46, color_space),
                             (13, realtime_speed)):
                if val is not None:
                    controls.append((cid, val))
        for cid, val in controls:
            if lib.vpx_codec_control_(ctx, cid, ctypes.c_int(val)):
                raise RuntimeError(f"libvpx: control {cid} refused")
        if roi:
            blk = 8 if vp9 else 16
            rows, cols = (h + blk - 1) // blk, (w + blk - 1) // blk
            seg = (ctypes.c_uint8 * (rows * cols))(
                *[i % 4 for i in range(rows * cols)])
            m = RoiMap(1, ctypes.addressof(seg), rows, cols,
                       (ctypes.c_int * 8)(0, -10, 10, 20),
                       (ctypes.c_int * 8)(0, 5, -5, 10))
            if vp9:
                m.skip[3] = 1
                m.ref_frame[:] = [-1, -1, 1, -1, -1, -1, -1, -1]
            if lib.vpx_codec_control_(ctx, 40 if vp9 else 8,
                                      ctypes.byref(m)):
                raise RuntimeError("libvpx: ROI map refused")
        img = (ctypes.c_uint8 * 512)()             # vpx_image_t
        buf = (ctypes.c_uint8 * (w * h + 2 * ((w + 1) // 2) * ((h + 1) // 2)))()
        lib.vpx_img_wrap(img, 0x102, w, h, 1, buf)   # I420
        out = []

        def drain():
            it = ctypes.c_void_p(0)
            while p := lib.vpx_codec_get_cx_data(ctx, ctypes.byref(it)):
                kind = ctypes.c_int.from_address(p).value
                data = ctypes.string_at(
                    ctypes.c_void_p.from_address(p + 8).value,
                    ctypes.c_size_t.from_address(p + 16).value)
                if kind == (1 if pass_no == 1 else 0):
                    out.append(data)

        for i, f in enumerate(frames):
            ctypes.memmove(buf, i420(f), len(buf))
            if lib.vpx_codec_encode(ctx, img, i, 1, 0, deadline):
                raise RuntimeError("libvpx: a frame failed to encode")
            drain()
        while True:
            n = len(out)
            lib.vpx_codec_encode(ctx, None, -1, 1, 0, deadline)
            drain()
            if len(out) == n:
                break
        lib.vpx_codec_destroy(ctx)
        return out

    if two_pass:
        return run(2, b"".join(run(1)))
    return run(0)


def i420(bgr: np.ndarray) -> bytes:
    """A BGR frame as I420 planes (cv2's conversion; odd sizes by edge
    replication to even and cropping the chroma back)."""
    import cv2

    h, w = bgr.shape[:2]
    if h % 2 == 0 and w % 2 == 0:
        return cv2.cvtColor(np.ascontiguousarray(bgr),
                            cv2.COLOR_BGR2YUV_I420).tobytes()
    even = np.pad(bgr, ((0, h % 2), (0, w % 2), (0, 0)), mode="edge")
    yuv = cv2.cvtColor(even, cv2.COLOR_BGR2YUV_I420)
    eh, ew = even.shape[:2]
    y = yuv[:eh][:h, :w]
    chroma = yuv[eh:].ravel()
    u = chroma[:eh * ew // 4].reshape(eh // 2, ew // 2)
    v = chroma[eh * ew // 4:].reshape(eh // 2, ew // 2)
    cw, ch = (w + 1) // 2, (h + 1) // 2
    return y.tobytes() + u[:ch, :cw].tobytes() + v[:ch, :cw].tobytes()


def vpcc_box(profile: int = 0, depth: int = 8, chroma: int = 1) -> bytes:
    """A vpcC box (VP codec configuration, version 1) as cv2's muxer
    writes it: level 1.0, limited range, unspecified colour."""
    return _full_box(b"vpcC", 0x01000000, bytes(
        [profile, 10, (depth << 4) | (chroma << 1), 2, 2, 2, 0, 0]))


def patch_vp8(data: bytes, packets: list[bytes], change: str) -> bytes:
    """A VP8 Matroska file's bytes with VP8_PATCHED's `change` made to
    its packets (found in the file by their bytes)."""
    out = bytearray(data)
    for i, p in enumerate(packets):
        at = data.index(p)
        tag = out[at]
        if change.startswith("show_frame") and i == 5:
            out[at] = tag & ~0x10
        elif change.startswith("version"):
            out[at] = (tag & ~0x0E) | (int(change.split()[1]) << 1)
        elif change.startswith("width") and not tag & 1:   # a keyframe
            w, h = struct.unpack_from("<HH", out, at + 6)
            struct.pack_into("<HH", out, at + 6, 71 | (1 << 14),
                             (h & 0x3FFF) | (2 << 14))
    if change.startswith("width"):
        at = data.index(b"\xb0\x81" + bytes([W]))        # PixelWidth
        out[at + 2] = 71
    return bytes(out)


def cv2_packets(path: str) -> list[bytes]:
    """The packets cv2 demuxes (CAP_PROP_FORMAT -1), in decode order."""
    import cv2

    cap = cv2.VideoCapture(path)
    cap.set(cv2.CAP_PROP_FORMAT, -1)
    out = []
    while True:
        ok, p = cap.read()
        if not ok:
            break
        out.append(p.ravel().tobytes())
    cap.release()
    return out


def pil_jpegs(frames, quality: int = 75) -> list[bytes]:
    from PIL import Image

    out = []
    for f in frames:
        buf = io.BytesIO()
        Image.fromarray(f[..., ::-1]).save(buf, "JPEG", quality=quality,
                                           subsampling=2)
        out.append(buf.getvalue())
    return out


def clip_frames_bgr() -> np.ndarray:
    from PIL import Image

    files = sorted(os.listdir(CLIP_DIR))
    return np.stack([np.asarray(Image.open(os.path.join(CLIP_DIR, f))
                                .convert("RGB"))[..., ::-1] for f in files])


def cv2_view(path: str) -> tuple[np.ndarray, int]:
    """Every frame cv2 decodes, and the frame count it reports."""
    import cv2

    cap = cv2.VideoCapture(path)
    count = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f)
    cap.release()
    return np.stack(frames), count


def write_case(name: str, out: str = FIXTURES) -> str:
    """Write one case (not its .npz) into `out`; return its path."""
    import tempfile

    path = os.path.join(out, os.path.basename(path_of(name)))
    if name in MP4_MJPEG_CASES:
        with tempfile.TemporaryDirectory() as tmp:
            src = os.path.join(tmp, "src.avi")
            write_cv2(src, "MJPG", 25, moving_frames(len(name), 12))
            packets = cv2_packets(src)
        with open(path, "wb") as f:
            f.write(mp4_file(packets, W, H, 25, MP4_MJPEG_CASES[name]))
        return path
    if name in VP8_MP4_CASES:
        with tempfile.TemporaryDirectory() as tmp:
            src = os.path.join(tmp, "src.avi")
            write_cv2(src, "VP80", 25, moving_frames(len(name), 20))
            packets = cv2_packets(src)
        with open(path, "wb") as f:
            f.write(mp4_file(packets, W, H, 25, VP8_MP4_CASES[name],
                             vpcc_box()))
        return path
    if name in VP8_PATCHED:
        with tempfile.TemporaryDirectory() as tmp:
            src = os.path.join(tmp, "src.mkv")
            write_cv2(src, "VP80", 25, moving_frames(11, 30))
            data = open(src, "rb").read()
            packets = cv2_packets(src)
        with open(path, "wb") as f:
            f.write(patch_vp8(data, packets, VP8_PATCHED[name]))
        return path
    if name in LIBVPX_CASES:
        settings = dict(LIBVPX_CASES[name])
        h, w = settings.pop("size", (H, W))
        z = settings.pop("zoom", 1)
        frames = moving_frames(sum(map(ord, name)), 40, h // z, w // z)
        frames = frames.repeat(z, axis=1).repeat(z, axis=2)
        codec = codec_of(name)
        packets = libvpx_encode(frames, codec=codec, **settings)
        with open(path, "wb") as f:
            f.write(avi_file(packets, w, h, 25, len(packets),
                             b"VP80" if codec == "vp8" else b"VP90"))
        return path
    if name in HAND_CASES:
        t, count, fps = HAND_CASES[name]
        frames = moving_frames(len(name), t)
        jpegs = pil_jpegs(frames)
        if "nodht" in name:
            jpegs = [strip_dht(j) for j in jpegs]
        with open(path, "wb") as f:
            f.write(avi_file(jpegs, W, H, fps, count))
        return path
    if name in CLIP_CASES:
        ext, fourcc, t = CLIP_CASES[name]
        write_cv2(path, fourcc, 25, clip_frames_bgr()[:t])
        return path
    ext, fourcc, fps, t = CASES[name]
    write_cv2(path, fourcc, fps, moving_frames(sum(map(ord, name)), t))
    return path


def main(out: str = FIXTURES, *names: str):
    os.makedirs(out, exist_ok=True)
    for name in names or (*DECODED, *CLIP_CASES):
        path = write_case(name, out)
        if name not in DECODED:
            continue
        frames, count = cv2_view(path)
        index = np.array(sorted({0, len(frames) // 2, len(frames) - 1}))
        np.savez_compressed(os.path.join(out, name + ".npz"),
                            frames=frames[index], index=index,
                            n=np.int64(len(frames)), count=np.int64(count))


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:]))
