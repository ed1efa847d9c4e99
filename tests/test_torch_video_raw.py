"""The port's uncompressed video reader (csrc/rawvideo.cpp, through
csrc/videodec.cpp and native.py) on video as OpenCV's writer, capture
tools and ffmpeg store it, against cv2 and the JAX package's
`load_frames_for`.

The cases of tests/_torch_make_videos.py's RAW_CASES and RAW_CLIPS
(committed in tests/torch_videos/ with cv2's decodes): every AVI fourcc
of RAW_AVI_TAGS (planar 4:2:0, 4:2:2, 4:4:4 and 4:1:1 YUV, NV12/NV21,
grey, packed 4:2:2 as YUY2, UYVY, HDYC, 2vuy, YVYU ..., v210) at 64x48
and 45x29, BI_RGB at 8 bits with a colour table and without, 16 bits and
32 bits bottom-up and top-down, YUY2 under a bit count of 12 (each word
scaled up, as libavcodec scales it), V_UNCOMPRESSED Matroska tracks by
their ColourSpace, cv2.VideoWriter's own files for fourcc 0 (I420),
I420, IYUV, YV12, NV12, Y800, GREY and RGBA in AVI and Matroska, and the
two clips chip_smoke.py's `raw` folder trains from. Each goes through
`native.video_track` (packets byte for byte against cv2's
`CAP_PROP_FORMAT = -1`, the count against `CAP_PROP_FRAME_COUNT`, the
size), `native.decode_video` against `cap.read()` and the committed
decode (0 levels), and both packages' `load_frames_for` (0.0) over three
windows. Beside them: every fourcc the port reads written live in AVI and
Matroska against cv2, v210 at widths 1 to 50, fault F6 (BI_RGB-8, -16
and -32 AVIs refused by the frame-stack reader before PR 21), a packet
shorter than a frame (cv2 reads no further), the raises by class and
name, and swscale's routes to BGR24 for each pixel format on random
packets of sizes from 1x1 against cv2's libswscale through ctypes.

cv2 crashes (double free) on a BI_RGB-24 AVI of positive height and on
an AVI tagged `RGB\\x18`: those files never reach cv2 here.
"""

import ctypes
import glob
import os
import sys

import numpy as np
import pytest

from viai_tpu.data import av as j_av
from viai_tpu_torch import native
from viai_tpu_torch.data import av

cv2 = pytest.importorskip("cv2")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_make_videos as mk  # noqa: E402

ALL = [*mk.RAW_CASES, *mk.RAW_CLIPS]
FILES = {c: mk.path_of(c) for c in ALL}
WINDOWS = ((0.0, 1.0), (0.3, 0.6), (0.9, 1.0))
# Every fourcc the port reads, and the layout of raw_packets its bytes
# take (ff_raw_pix_fmt_tags' first match: `yv12` is I420's order).
TAGS = {
    "I420": "i420", "IYUV": "i420", "yv12": "i420", "YV12": "yv12",
    "J420": "i420", "NV12": "nv12", "NV21": "nv21", "Y800": "grey",
    "Y8  ": "grey", "GREY": "grey", "YUY2": "yuyv", "Y422": "yuyv",
    "V422": "yuyv", "VYUY": "yuyv", "YUNV": "yuyv", "YUYV": "yuyv",
    "yuvs": "yuyv", "YVYU": "yvyu", "UYVY": "uyvy", "HDYC": "uyvy",
    "UYNV": "uyvy", "UYNY": "uyvy", "uyv1": "uyvy", "2Vu1": "uyvy",
    "VDTZ": "uyvy", "auv2": "uyvy", "2vuy": "uyvy", "2Vuy": "uyvy",
    "Y42B": "y42b", "P422": "y42b", "I422": "y42b", "J422": "y42b",
    "YV16": "yv16", "I444": "i444", "J444": "i444", "444P": "i444",
    "YV24": "yv24", "I440": "i440", "Y41B": "y41b", "I411": "y41b",
    "RGBA": "rgba", "BGRA": "bgra", "RGB\x18": "rgb24", "BGR\x18": "bgr24",
    "v210": "v210"}
# The fourccs libavformat's AVI demuxer names no codec for: cv2 opens no
# decoder (and crashes on RGB\x18), the port raises ValueError.
AVI_UNNAMED = ("444P", "RGB\x18", "BGR\x18")


def _write(tmp_path, name: str, data: bytes) -> str:
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    return path


def _held(path: str, codec: str = "raw") -> np.ndarray:
    """The port's track and frames against cv2's packets, count, size and
    frames; → the frames."""
    track = native.video_track(path)
    assert track.codec == codec
    assert [p for p, _ in track.packets] == mk.cv2_packets(path)
    cap = cv2.VideoCapture(path)
    assert track.count == int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    assert (track.width, track.height) == (
        int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
        int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)))
    cap.release()
    got = native.decode_video(path)
    ref, _ = mk.cv2_view(path)
    assert got.shape == ref.shape and got.dtype == np.uint8
    assert int(np.abs(got.astype(int) - ref).max()) == 0
    return got


def _loads_as_jax(path: str, windows=WINDOWS) -> None:
    stem = os.path.splitext(path)[0]
    for window in windows:
        ref = j_av.load_frames_for(stem, 16, 32, window)
        got = av.load_frames_for(stem, 16, 32, window)
        assert got.shape == ref.shape and got.dtype == np.float32
        assert float(np.abs(got - ref).max()) == 0.0, window


@pytest.mark.parametrize("name", ALL)
def test_track_and_frames_match_cv2(name):
    got = _held(FILES[name])
    ref = np.load(os.path.join(mk.FIXTURES, name + ".npz"))
    assert got.shape[0] == int(ref["n"])
    np.testing.assert_array_equal(got[ref["index"]], ref["frames"])
    assert int(ref["count"]) == native.video_track(FILES[name]).count


@pytest.mark.parametrize("name", ALL)
def test_load_frames_match_jax(name):
    _loads_as_jax(FILES[name])


def test_fixtures_hold_what_they_are_named_for():
    """The AVI fourccs, bit counts and heights, the Matroska ColourSpaces,
    and cv2's writer: I420 for fourcc 0, yuv420p bytes under every YUV
    fourcc (1.5 bytes a pixel), RGBA at 32 bits."""
    for name, (mux, tag, layout, opts) in mk.RAW_CASES.items():
        track = native.video_track(FILES[name], packets=False)
        h, w = opts.get("size", mk.RAW_CV2_SIZE)
        assert (track.width, track.height) == (w, h), name
        if mux == "mkv":
            assert (track.container, track.tag) == (
                "Matroska", "V_UNCOMPRESSED " + tag.replace("\x18", "?"))
        elif mux == "avi":
            assert (track.container, track.tag) == ("AVI", tag), name
            assert track.bits == opts.get(
                "bits", mk.RAW_BITS.get(layout, 24)), name
            data = open(FILES[name], "rb").read()
            at = data.index(b"strf") + 8
            assert np.frombuffer(data[at + 8:at + 12], "<i4")[0] == (
                -h if opts.get("top_down") else h), name
        else:
            want = tag or "I420"
            assert track.tag in (want, "V_UNCOMPRESSED " + want), name
            sizes = {len(p) for p, _ in native.video_track(
                FILES[name]).packets}
            assert sizes == {w * h * (4 if tag == "RGBA" else 3) // (
                1 if tag == "RGBA" else 2)}, name


@pytest.mark.parametrize("tag", list(TAGS))
def test_fourccs_read_as_cv2(tmp_path, tag):
    """Each fourcc the port reads, written live at an odd and an even
    size in AVI (where libavformat names a codec for it) and as a
    Matroska ColourSpace, against cv2."""
    for h, w in ((21, 37), (16, 24)):
        frames = mk.moving_frames(len(tag) + w, 3, h, w)
        packets = mk.raw_packets(TAGS[tag], frames, seed=w)
        raw = tag.encode("latin-1")
        path = _write(tmp_path, "t.mkv", mk.mkv_file(
            packets, w, h, 25, "V_UNCOMPRESSED", colour_space=raw))
        if tag != "v210":          # rawvideo finds no pixel format for it
            _held(path)
        path = _write(tmp_path, "t.avi", mk.avi_file(
            packets, w, h, 25, len(packets), raw, bits=16))
        if tag in AVI_UNNAMED:
            with pytest.raises(ValueError, match="names no codec"):
                native.decode_video(path)
        else:
            _held(path)


def test_v210_widths_read_as_cv2(tmp_path):
    """v210's rows at every width to 50 (libavcodec's v210 unpacks 12
    pixels at a time, then 6, then 2 or 4: the last column of some widths
    is never written and reads 0) and at the 64-byte padding libavcodec
    accepts where the packet has exactly that."""
    for w in range(1, 51):
        frames = mk.moving_frames(w, 2, 5, w)
        packets = mk.raw_packets("v210", frames, seed=w)
        _held(_write(tmp_path, "t.avi", mk.avi_file(
            packets, w, 5, 25, 2, b"v210", bits=20)))
    w, h = 20, 4                   # rows of 64 bytes, not 128
    packets = mk.raw_packets("v210", mk.moving_frames(1, 2, h, w), seed=1)
    short = [b"".join(p[r * 128:r * 128 + 64] for r in range(h))
             for p in packets]
    assert len(short[0]) == ((w + 23) // 24) * 24 * 8 // 3 * h
    _held(_write(tmp_path, "t.avi", mk.avi_file(short, w, h, 25, 2,
                                                b"v210", bits=20)))


@pytest.mark.parametrize("bits", [8, 16, 32])
def test_f6_bi_rgb_avis_read_as_jax(bits):
    """Fault F6: a BI_RGB AVI of 8, 16 or 32 bits (32 bottom-up and
    top-down) went to the frame-stack reader, which refused it, where the
    JAX package reads it through cv2. The routing follows the JAX
    package's readers: the frame-stack reader for RGBA at 32 bits and
    BI_RGB at 24 only."""
    names = [n for n, (mux, tag, _, o) in mk.RAW_CASES.items()
             if mux == "avi" and tag == "BI_RGB" and o["bits"] == bits]
    assert len(names) == {8: 4, 16: 2, 32: 4}[bits]
    for name in names:
        _loads_as_jax(FILES[name])
        track = native.video_track(FILES[name], packets=False)
        assert (track.tag, track.bits) == ("BI_RGB", bits)
        assert not native.reads_frame_stack(track)
    rgba = native.video_track(FILES["raw_cv2rgba_avi"], packets=False)
    assert (rgba.tag, rgba.bits) == ("RGBA", 32)
    assert native.reads_frame_stack(rgba)


def test_dib8_colour_tables(tmp_path):
    """BI_RGB at 8 bits: libavformat takes the colour table from the end
    of strf's extradata (at most 256 entries: bytes ahead of it are not
    the table), fewer entries leave the rest black, none all black."""
    frames = mk.moving_frames(2, 2, 21, 37)
    packets = mk.raw_packets("dib", frames, bits=8)
    table = mk.RAW_PALETTE
    for extradata in (b"", table[:64], table, bytes(range(24)) + table,
                      table[::-1][:300]):
        _held(_write(tmp_path, "t.avi", mk.avi_file(
            packets, 37, 21, 25, 2, b"\0\0\0\0", bits=8,
            extradata=extradata)))


def test_bi_rgb24_routes(tmp_path):
    """BI_RGB at 24 bits: bottom-up, the frame-stack reader (as the JAX
    package's own reader; cv2 crashes on it), whose frames decode_video
    gives too (the source's bytes); top-down, decode_video as cv2 reads it
    and load_frames_for raising (the JAX package reads zeros: trap (i))."""
    frames = mk.moving_frames(5, 4, 21, 37)
    for top_down in (False, True):
        packets = mk.raw_packets("dib", frames, bits=24, top_down=top_down)
        path = _write(tmp_path, "clip.avi", mk.avi_file(
            packets, 37, 21, 25, 4, b"\0\0\0\0", bits=24, top_down=top_down))
        track = native.video_track(path)
        assert track.codec == "raw" and native.reads_frame_stack(track)
        got = native.decode_video(path)
        np.testing.assert_array_equal(got, frames)
        stem = os.path.splitext(path)[0]
        if top_down:
            _held(path)
            with pytest.raises(NotImplementedError, match="top-down"):
                av.load_frames_for(stem, 4, 16)
        else:
            np.testing.assert_array_equal(
                av.load_frames_for(stem, 4, 16, (0.2, 0.9)),
                j_av.load_frames_for(stem, 4, 16, (0.2, 0.9)))


def test_a_short_packet_ends_the_read(tmp_path):
    """A packet shorter than a frame: libavcodec refuses it and cv2 reads
    no further, though its count is the container's."""
    frames = mk.moving_frames(9, 8, 16, 24)
    packets = mk.raw_packets("i420", frames)
    packets[3] = packets[3][:-7]
    path = _write(tmp_path, "clip.avi", mk.avi_file(
        packets, 24, 16, 25, 8, b"I420", bits=12))
    assert len(_held(path)) == 3
    _loads_as_jax(path, ((0.0, 1.0), (0.0, 0.4)))
    stem = os.path.splitext(path)[0]
    for load in (j_av.load_frames_for, av.load_frames_for):
        with pytest.raises(ValueError, match="no frames decoded"):
            load(stem, 4, 16, (0.5, 1.0))


def test_packets_longer_than_a_frame(tmp_path):
    """A packet longer than a frame is read from its start, with
    rawdec's adjustments where it holds them: cv2's own Y800, GREY and
    NV12 files (yuv420p bytes) at a width that is not a multiple of 4
    (grey rows then aligned to 4 bytes), and random packets with room to
    spare: NV12's planes aligned to 4 bytes, grey and RGB24 rows aligned,
    I420's chroma moved when the packet holds (w+1)·(h+1)·3/2 bytes."""
    frames = mk.moving_frames(6, 3, 46, 62)
    for tag in ("Y800", "GREY", "NV12", "I420"):
        path = str(tmp_path / f"cv2_{tag}.avi")
        mk.write_cv2(path, tag, 25, frames)
        _held(path)
    rng = np.random.default_rng(8)
    for tag, (h, w), size in (
            ("NV12", (9, 13), 16 * 9 + 16 * 5),
            ("NV12", (9, 13), 13 * 9 + 14 * 5 + 3),
            ("GREY", (7, 13), 16 * 7), ("RGB\x18", (5, 7), 24 * 5),
            ("I420", (9, 13), 14 * 10 * 3 // 2),
            ("I420", (8, 12), 13 * 9 * 3 // 2),
            ("IYUV", (9, 13), 14 * 10 * 3 // 2)):
        packets = [rng.integers(0, 256, size, np.uint8).tobytes()
                   for _ in range(2)]
        raw = tag.encode("latin-1")
        _held(_write(tmp_path, "t.mkv", mk.mkv_file(
            packets, w, h, 25, "V_UNCOMPRESSED", colour_space=raw)))
        if tag != "RGB\x18":
            _held(_write(tmp_path, "t.avi", mk.avi_file(
                packets, w, h, 25, 2, raw, bits=12)))


@pytest.mark.parametrize("case", ["cv2_yuy2", "cv2_uyvy", "cv2_bgra",
                                  "444P", "P010", "BGR\x18", "nocs"])
def test_what_cv2_reads_no_frame_from_raises_value_error(tmp_path, case):
    """cv2's own YUY2 and UYVY files (yuv420p bytes, 1.5 a pixel, under a
    4:2:2 fourcc) and its BGRA AVI (BI_RGB at 12 bits over yuv420p bytes),
    AVIs tagged 444P, P010 or BGR24 (no codec in libavformat's AVI tables)
    and a V_UNCOMPRESSED track without a ColourSpace: cv2 reads no frame,
    so the JAX package raises ValueError, and the port too."""
    frames = mk.moving_frames(3, 4, 16, 24)
    if case.startswith("cv2_"):
        path = str(tmp_path / "clip.avi")
        mk.write_cv2(path, case[4:].upper(), 25, frames)
    elif case == "nocs":
        path = _write(tmp_path, "clip.mkv", mk.mkv_file(
            mk.raw_packets("i420", frames), 24, 16, 25, "V_UNCOMPRESSED"))
    else:
        path = _write(tmp_path, "clip.avi", mk.avi_file(
            mk.raw_packets("i420", frames), 24, 16, 25, 4,
            case.encode("latin-1")))
    stem = os.path.splitext(path)[0]
    with pytest.raises(ValueError):
        j_av.load_frames_for(stem, 4, 16)
    for read in (native.decode_video,
                 lambda p: native.load_video_frames(p, 4, 16),
                 lambda p: av.load_frames_for(stem, 4, 16)):
        with pytest.raises(ValueError):
            read(path)


def test_unread_layouts_raise_by_name(tmp_path):
    """What the port does not read raises NotImplementedError naming it:
    RLE-compressed DIBs (other decoders), 1, 2 and 4-bit DIBs, raw video
    in MP4, an AVI fourcc of another codec or none, a Matroska
    ColourSpace of a layout that is not read. An AVI tagged RGB24 never
    reaches cv2 (it crashes); the port raises ValueError."""
    frames = mk.moving_frames(4, 2, 16, 24)
    i420 = mk.raw_packets("i420", frames)
    dib = mk.raw_packets("dib", frames, bits=8)
    cases = [
        (mk.avi_file(dib, 24, 16, 25, 2, b"\1\0\0\0", bits=8), "BI_RLE8"),
        (mk.avi_file(dib, 24, 16, 25, 2, b"\2\0\0\0", bits=4), "BI_RLE4"),
        (mk.avi_file(dib, 24, 16, 25, 2, b"\0\0\0\0", bits=4),
         "4-bit DIBs"),
        (mk.avi_file(dib, 24, 16, 25, 2, b"\0\0\0\0", bits=1),
         "4-bit DIBs"),
        (mk.avi_file(i420, 24, 16, 25, 2, b"ABCD"), "ABCD"),
        (mk.mkv_file(i420, 24, 16, 25, "V_UNCOMPRESSED",
                     colour_space=b"YUV9"), "YUV9"),
    ]
    for k, (data, what) in enumerate(cases):
        path = _write(tmp_path, f"t{k}.{'mkv' if k == 5 else 'avi'}", data)
        with pytest.raises(NotImplementedError, match=what):
            native.decode_video(path)
        with pytest.raises(NotImplementedError, match=what):
            av.load_frames_for(os.path.splitext(path)[0], 4, 16)
    path = _write(tmp_path, "t.mp4", mk.mp4_file(i420, 24, 16, 25, b"raw "))
    with pytest.raises(NotImplementedError, match="raw "):
        native.decode_video(path)
    path = _write(tmp_path, "t.avi", mk.avi_file(i420, 24, 16, 25, 2,
                                                 b"RGB\x18"))
    with pytest.raises(ValueError, match="names no codec"):
        native.decode_video(path)


# ---- swscale's routes -------------------------------------------------------

def _libs():
    libs = os.path.join(os.path.dirname(os.path.dirname(cv2.__file__)),
                        "opencv_python.libs")
    found = [glob.glob(os.path.join(libs, f"lib{n}-*.so*"))
             for n in ("avutil", "swscale")]
    if not all(found):
        pytest.skip("cv2's wheel does not bundle libswscale")
    au, sw = ctypes.CDLL(found[0][0]), ctypes.CDLL(found[1][0])
    vp = ctypes.c_void_p
    au.av_get_pix_fmt.restype = ctypes.c_int
    au.av_get_pix_fmt.argtypes = [ctypes.c_char_p]
    au.av_image_fill_arrays.argtypes = [vp, vp, vp] + [ctypes.c_int] * 4
    au.av_image_get_buffer_size.argtypes = [ctypes.c_int] * 4
    au.av_log_set_level.argtypes = [ctypes.c_int]
    au.av_log_set_level(8)
    sw.sws_getContext.restype = vp
    sw.sws_getContext.argtypes = [ctypes.c_int] * 7 + [vp, vp, vp]
    sw.sws_getCoefficients.restype = vp
    sw.sws_setColorspaceDetails.argtypes = [vp, vp, ctypes.c_int, vp] + \
        [ctypes.c_int] * 4
    sw.sws_scale.argtypes = [vp, vp, vp, ctypes.c_int, ctypes.c_int, vp, vp]
    sw.sws_freeContext.argtypes = [vp]
    return au, sw


def _cv2_swscale(au, sw, data: bytes, fmt: str, w: int, h: int,
                 full: bool) -> np.ndarray:
    """cv2's libswscale on a packet laid out as av_image_fill_arrays lays
    `fmt` at alignment 1: BGR24 at the same size, SWS_BICUBIC, BT.601,
    the source's range `full`."""
    pix = au.av_get_pix_fmt(fmt.encode())
    buf = np.frombuffer(data, np.uint8).copy()
    planes = (ctypes.c_void_p * 4)()
    strides = (ctypes.c_int * 4)()
    assert au.av_image_fill_arrays(planes, strides, buf.ctypes.data, pix, w,
                                   h, 1) == len(data)
    ctx = sw.sws_getContext(w, h, pix, w, h, au.av_get_pix_fmt(b"bgr24"), 4,
                            None, None, None)
    coef = sw.sws_getCoefficients(5)
    sw.sws_setColorspaceDetails(ctx, coef, int(full), coef, 1, 0, 1 << 16,
                                1 << 16)
    out = np.zeros((h + 2, 3 * w + 64), np.uint8)   # its SIMD overwrites
    dst = (ctypes.c_void_p * 4)(out.ctypes.data, None, None, None)
    dst_strides = (ctypes.c_int * 4)(out.strides[0], 0, 0, 0)
    sw.sws_scale(ctx, planes, strides, 0, h, dst, dst_strides)
    sw.sws_freeContext(ctx)
    return out[:h, :3 * w].reshape(h, w, 3)


# fourcc (or BI_RGB bits) → libavutil's pixel format, full range
ROUTES = {
    "I420": ("yuv420p", False), "J420": ("yuvj420p", True),
    "NV12": ("nv12", False), "NV21": ("nv21", False),
    "Y800": ("gray", False), "YUY2": ("yuyv422", False),
    "UYVY": ("uyvy422", False), "YVYU": ("yvyu422", False),
    "Y42B": ("yuv422p", False), "J422": ("yuvj422p", True),
    "I444": ("yuv444p", False), "J444": ("yuvj444p", True),
    "I440": ("yuv440p", False), "Y41B": ("yuv411p", False),
    "RGB\x18": ("rgb24", False), "BGR\x18": ("bgr24", False),
    "RGBA": ("rgba", False), "BGRA": ("bgra", False),
    16: ("rgb555le", False), 24: ("bgr24", False), 32: ("bgra", False)}


@pytest.mark.parametrize("route", list(ROUTES))
def test_conversion_matches_cv2_swscale(route):
    """Random packets of each pixel format at sizes from 1x1 to 41x33,
    through the raw decoder and the conversion (swscale's x86 yuv2rgb
    for yuv420p and yuv422p of even height, its scaler with each format's
    input reader for the rest of the YUV formats and odd heights, gray's
    palette, the unscaled RGB converters: byte moves and rgb15's bit
    replication), against cv2's libswscale, 0 levels."""
    au, sw = _libs()
    fmt, full = ROUTES[route]
    rng = np.random.default_rng(len(fmt) * 7 + len(str(route)))
    pix = au.av_get_pix_fmt(fmt.encode())
    sizes = [(1, 1), (1, 2), (2, 1), (3, 3)] + [
        (int(rng.integers(1, 34)), int(rng.integers(1, 42)))
        for _ in range(24)]
    for h, w in sizes:
        n = au.av_image_get_buffer_size(pix, w, h, 1)
        data = rng.integers(0, 256, n, np.uint8).tobytes()
        ref = _cv2_swscale(au, sw, data, fmt, w, h, full)
        if isinstance(route, int):
            got = native.raw_to_bgr(data, "BI_RGB", w, h, bits=route)
        else:
            got = native.raw_to_bgr(data, route, w, h)
        assert np.array_equal(got, ref), (route, w, h)


def test_raw_to_bgr_refuses_a_short_packet():
    with pytest.raises(ValueError, match="shorter"):
        native.raw_to_bgr(bytes(10), "I420", 4, 4)
    with pytest.raises(NotImplementedError, match="YUV9"):
        native.raw_to_bgr(bytes(100), "YUV9", 4, 4)
