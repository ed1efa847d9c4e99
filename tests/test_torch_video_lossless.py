"""The port's lossless video readers (csrc/ffv1.cpp, csrc/utvideo.cpp,
csrc/huffyuv.cpp and PNG through csrc/imagedec.cpp's reader, routed by
csrc/videodec.cpp and native.py) on video as capture tools, archives and
OpenCV's writer store it, against cv2 and the JAX package's
`load_frames_for`.

The cases of tests/_torch_make_videos.py's LOSSLESS_CASES and
LOSSLESS_CLIPS (committed in tests/torch_videos/ with cv2's decodes):
FFV1 versions 0, 1, 2 and 3 (Golomb-Rice and both range coder tables,
slices with CRCs, context model 1, non-key frames, 4:2:0 to 4:1:0, 10
and 16 bits, grey, alpha, RGB at 8, 10 and 16 bits), UT Video's eight
classic layouts (left, median, none and gradient predictions, BT.709),
HuffYUV 1.x with the classic tables (written here), HuffYUV 2.x and
FFVHuff (left, plane, median, per-frame tables, RGB, 10 and 16 bits, the
interlace bit above 288 rows), PNG at 8 and 16 bits and with a palette,
in AVI and Matroska, and cv2.VideoWriter's own files. Each goes through
`native.video_track` (packets byte for byte against cv2's
`CAP_PROP_FORMAT = -1`, the count, the size), `native.decode_video`
against `cap.read()` and the committed decode (0 levels), and both
packages' `load_frames_for` (0.0) over three windows. Beside them: every
lossless fourcc cv2 writes, written live in AVI and Matroska; swscale's
routes to BGR24 of the new layouts on random planes against cv2's
libswscale; the raises (broken slices and tables as ValueError; Adam7
and UT Video's interlaced flag, which cv2 converts no frame of, and the
codecs still unread as NotImplementedError naming them).
"""

import os
import struct
import sys

import numpy as np
import pytest

from viai_tpu.data import av as j_av
from viai_tpu_torch import native
from viai_tpu_torch.data import av

cv2 = pytest.importorskip("cv2")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_make_videos as mk  # noqa: E402
import test_torch_video_raw as raw  # noqa: E402

ALL = [*mk.LOSSLESS_CASES, *mk.LOSSLESS_CLIPS]
FILES = {c: mk.path_of(c) for c in ALL}
WINDOWS = ((0.0, 1.0), (0.3, 0.6), (0.9, 1.0))


def _write(tmp_path, name: str, data: bytes) -> str:
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    return path


def _held(path: str, codec: str) -> np.ndarray:
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


@pytest.mark.parametrize("name", ALL)
def test_track_and_frames_match_cv2(name):
    got = _held(FILES[name], mk.codec_of(name))
    ref = np.load(os.path.join(mk.FIXTURES, name + ".npz"))
    assert got.shape[0] == int(ref["n"])
    np.testing.assert_array_equal(got[ref["index"]], ref["frames"])
    assert int(ref["count"]) == native.video_track(FILES[name]).count


@pytest.mark.parametrize("name", ALL)
def test_load_frames_match_jax(name):
    stem = os.path.splitext(FILES[name])[0]
    assert not native.reads_frame_stack(
        native.video_track(FILES[name], packets=False))
    for window in WINDOWS:
        ref = j_av.load_frames_for(stem, 16, 32, window)
        got = av.load_frames_for(stem, 16, 32, window)
        assert got.shape == ref.shape and got.dtype == np.float32
        assert float(np.abs(got - ref).max()) == 0.0, window


def _strf(path: str) -> tuple[bytes, int, bytes]:
    """An AVI's strf: (compression, bit count, the bytes after 40), read
    from the file (cv2's CAP_PROP_FOURCC reports ULRA for a ULY0 file)."""
    data = open(path, "rb").read()
    at = data.index(b"strf")
    size = struct.unpack_from("<I", data, at + 4)[0]
    body = data[at + 8:at + 8 + size]
    return body[16:20], struct.unpack_from("<H", body, 14)[0], body[40:]


def test_fixtures_hold_what_they_are_named_for():
    """Each case's fourcc and bit count as its strf (or Matroska track)
    holds them, FFV1's configuration record where versions 2 and 3 keep
    it, HuffYUV's interlace bit (set by -flags +ilme, not by the height)
    and the classic streams' missing extradata."""
    for name, (enc, kind, opts) in mk.LOSSLESS_CASES.items():
        track = native.video_track(FILES[name], packets=False)
        want = {"ffv1": "FFV1", "huffyuv": "HFYU", "ffvhuff": "FFVH",
                "classic": "HFYU", "cv2": kind}.get(enc, opts.get("tag"))
        if enc == "utvideo":
            want = {"gbrp": "ULRG", "gbrap": "ULRA", "yuv420p": "UL?0",
                    "yuv422p": "UL?2", "yuv444p": "UL?4"}[kind].replace(
                "?", "H" if opts.get("colorspace") == "bt709" else "Y")
        if name.endswith("_avi"):
            tag, bits, ext = _strf(FILES[name])
            assert (track.tag, track.bits) == (want, bits), name
            assert tag == want.encode(), name
            if enc == "classic":
                assert (bits, ext) == (opts["bits"], b""), name
            if enc == "ffv1":
                assert bool(ext) == (opts["level"] >= 2), name
        elif want == "FFV1":
            assert track.tag == "V_FFV1", name
        else:
            assert track.tag == "V_MS/VFW/FOURCC " + want, name
    for name in ("hfyu_tall_avi", "ffvh_il_avi"):  # -flags +ilme
        _, _, ext = _strf(FILES[name])
        assert ext[2] & 0x30 == 0x10 and ext[3] == 0, name
    _, _, ext = _strf(FILES["hfyu_v2_avi"])
    assert ext[2] & 0x30 == 0x20 and ext[3] == 0   # version 2, progressive
    # libavcodec's encoder writes the bit clear above 288 rows too (only a
    # stream without extradata is interlaced there by default)
    info = {}
    mk.lavc_encode(mk.moving_frames(0, 1, 300, 16), "huffyuv", info=info,
                   pixel_format="yuv422p")
    assert info["extradata"][2] & 0x30 == 0x20


@pytest.mark.parametrize("fourcc", ["FFV1", "HFYU", "FFVH", "ULY0", "ULRG",
                                    "ULH4", "MPNG", "PNG1", "png "])
def test_fourccs_cv2_writes_read_as_cv2(tmp_path, fourcc):
    """cv2.VideoWriter's lossless fourccs, written live in AVI and
    Matroska at an even and an odd size (cv2 writes one layout a codec:
    every UL** tag is ULY0, which needs even sizes)."""
    codec = {"FFV1": "ffv1", "HFYU": "huffyuv", "FFVH": "huffyuv",
             "MPNG": "png", "PNG1": "png", "png ": "png"}.get(fourcc,
                                                              "utvideo")
    sizes = ((16, 24),) if codec in ("utvideo", "huffyuv") else \
        ((16, 24), (13, 21))
    for h, w in sizes:
        for ext in ("avi", "mkv"):
            path = str(tmp_path / f"t.{ext}")
            mk.write_cv2(path, fourcc, 25, mk.moving_frames(w + h, 3, h, w))
            _held(path, codec)


# libavutil's pixel format → the picture the port makes of it: (planes
# from its bytes at alignment 1, shift, depth, full range, planar RGB)
def _route(fmt: str, data: np.ndarray, h: int, w: int):
    def mid(p, d):
        return np.full_like(p, 1 << (d - 1))

    if fmt in ("gray10le", "gray12le", "gray16le"):
        d = int(fmt[4:6])
        y = data.view("<u2").reshape(h, w) & ((1 << d) - 1)
        return (y, mid(y, d), mid(y, d)), (0, 0), d, True, False
    if fmt == "ya8":
        y = data.reshape(h, w, 2)[..., 0]
        return (y, mid(y, 8), mid(y, 8)), (0, 0), 8, True, False
    if fmt in ("ya16be", "gray16be"):
        y = data.view(">u2").reshape(h, w, -1)[..., 0].astype(np.uint16)
        return (y, mid(y, 16), mid(y, 16)), (0, 0), 16, True, False
    if fmt in ("rgb48be", "rgba64be"):
        px = data.view(">u2").reshape(h, w, -1).astype(np.uint16)
        return (px[..., 1], px[..., 2], px[..., 0]), (0, 0), 16, False, True
    if fmt.startswith("gbr"):
        d = int(fmt[-4:-2]) if fmt.endswith("le") else 8
        kind = "<u2" if d > 8 else np.uint8
        planes = data.view(kind).reshape(-1, h, w) & ((1 << d) - 1)
        return tuple(planes[:3]), (0, 0), d, False, True
    # planar YUV (alpha dropped)
    body = fmt[4:] if fmt.startswith("yuva") else fmt[3:]
    xs, ys = {"444": (0, 0), "422": (1, 0), "420": (1, 1), "440": (0, 1),
              "411": (2, 0), "410": (2, 2)}[body[:3]]
    d = int(body[4:6]) if fmt.endswith("le") else 8
    kind = "<u2" if d > 8 else np.uint8
    flat = data.view(kind) & ((1 << d) - 1)
    ch, cw = -(-h >> ys), -(-w >> xs)
    y = flat[:h * w].reshape(h, w)
    u = flat[h * w:h * w + ch * cw].reshape(ch, cw)
    v = flat[h * w + ch * cw:h * w + 2 * ch * cw].reshape(ch, cw)
    return (y, u, v), (xs, ys), d, False, False


ROUTES = ["yuv411p", "yuv410p", "yuv440p", "yuv444p16le", "yuv420p16le",
          "yuv422p16le", "yuva420p", "yuva444p10le", "gbrp16le", "gbrap",
          "gbrap10le", "gray10le", "gray16le", "ya8", "gray16be", "ya16be",
          "rgb48be", "rgba64be"]


@pytest.mark.parametrize("fmt", ROUTES)
def test_conversion_matches_cv2_swscale(fmt):
    """Random planes of each layout the lossless decoders give, through
    the port's conversion as the decoders hand them to it (alpha dropped;
    grey above 8 bits and grey with alpha as full-range 4:4:4 with mid
    chroma, as cv2 converts grey; 16-bit RGB as planar G, B, R), against
    cv2's libswscale at sizes from 1x1, 0 levels."""
    au, sw = raw._libs()
    rng = np.random.default_rng(sum(map(ord, fmt)))
    pix = au.av_get_pix_fmt(fmt.encode())
    sizes = [(1, 1), (2, 3), (5, 4)] + [
        (int(rng.integers(1, 30)), int(rng.integers(1, 40)))
        for _ in range(8)]
    for h, w in sizes:
        n = au.av_image_get_buffer_size(pix, w, h, 1)
        data = rng.integers(0, 256, n, np.uint8)
        planes, shift, d, full, rgb = _route(fmt, data, h, w)
        ref = raw._cv2_swscale(au, sw, _packed(fmt, data, h, w), fmt, w, h,
                               full)
        got = native.yuv_to_bgr(*planes, shift=shift, depth=d,
                                full_range=full, rgb=rgb)
        assert np.array_equal(got, ref), (fmt, h, w)


def _packed(fmt: str, data: np.ndarray, h: int, w: int) -> bytes:
    """The random bytes with each sample held within its depth (swscale
    reads the high bits of a 10-bit sample, the port does not)."""
    if fmt.endswith("le") and not fmt.endswith("16le"):
        d = int(fmt[-4:-2])
        return (data.view("<u2") & ((1 << d) - 1)).astype("<u2").tobytes()
    return data.tobytes()


def _relabel(path: str, out: str, old: bytes, new: bytes) -> str:
    """An AVI with its strh and strf fourccs `old` rewritten `new`."""
    data = open(path, "rb").read()
    assert data.count(old) >= 2
    with open(out, "wb") as f:
        f.write(data.replace(old, new))
    return out


def test_ulh_reads_in_bt709(tmp_path):
    """ULH0's frames carry BT.709, which cv2's swscale converts with: the
    same stream relabelled ULY0 (BT.601) reads otherwise, as cv2 reads
    it."""
    ulh = _held(FILES["ut_ulh0_avi"], "utvideo")
    uly = _held(_relabel(FILES["ut_ulh0_avi"], str(tmp_path / "y.avi"),
                         b"ULH0", b"ULY0"), "utvideo")
    assert int(np.abs(ulh.astype(int) - uly).max()) > 8


# The fourccs of the case list below that the port reads since (the
# H.263 family: csrc/msmpeg4.cpp; MagicYUV, ASV, Snow: csrc/magicyuv.cpp,
# csrc/asv.cpp, csrc/snow.cpp): the variant of each that still raises
# (relabelled to, or patched in) and what it names.
_FAMILY = {"MP42": ("MPG4", "MS-MPEG4 v1"), "MP43": ("MP41", "MS-MPEG4 v1"),
           "DIV3": ("DIV1", "MS-MPEG4 v1"), "WMV1": (None, None),
           "WMV2": ("J-frame", "J-frame"), "FLV1": ("size", "another size"),
           "M8Y0": ("version", "MagicYUV version"),
           "MAGY": ("version", "MagicYUV version"), "SNOW": (None, None),
           "ASV1": (None, None), "ASV2": (None, None)}


@pytest.mark.parametrize("fourcc,name", [
    ("M8Y0", "MagicYUV"), ("MAGY", "MagicYUV"), ("MP42", "MS-MPEG4 v2"),
    ("MP43", "MS-MPEG4 v3"), ("DIV3", "MS-MPEG4 v3"), ("WMV1", "WMV1"),
    ("WMV2", "WMV2"), ("FLV1", "FLV1"), ("MJ2C", "JPEG 2000"),
    ("SNOW", "Snow"), ("ASV1", "ASV1"), ("ASV2", "ASV2"),
    ("UQY2", "UT Video 10-bit"), ("UMY2", "UT Video pack mode"),
    ("UMRG", "UT Video pack mode")])
def test_unread_codecs_raise_naming_them(tmp_path, fourcc, name):
    """What cv2 writes or reads and the port does not: cv2.VideoWriter's
    own AVIs, UT Video's 10-bit and pack-mode layouts by their fourcc put
    on a ULY0 AVI. The H.263 family's fourccs, read since
    csrc/msmpeg4.cpp, and MagicYUV's (cv2 stores it as M8Y0 whatever is
    asked), Snow's and ASV's, read since csrc/magicyuv.cpp, csrc/snow.cpp
    and csrc/asv.cpp: cv2's AVI of each is held against cv2, and what
    stays unread raises (MS-MPEG4 v1's tags on it, a WMV2 J-frame, a FLV1
    picture of another size, a MagicYUV packet of another version than 7;
    WMV1, Snow and ASV have no unread variant)."""
    path = str(tmp_path / "t.avi")
    frames = mk.moving_frames(len(fourcc), 3, 16, 24)
    if fourcc in _FAMILY:
        mk.write_cv2(path, fourcc, 25, frames)
        got = native.decode_video(path)
        ref, _ = mk.cv2_view(path)
        assert got.shape == ref.shape == (3, 16, 24, 3)
        assert int(np.abs(got.astype(int) - ref).max()) == 0
        unread, match = _FAMILY[fourcc]
        if unread is None:
            return
        if unread == "J-frame":
            data = bytearray(open(path, "rb").read())
            at = data.index(native.video_track(path).packets[0][0])
            assert data[at] >> 7 == 0 and (data[at + 1] >> 2) & 1 == 0
            data[at + 1] |= 0x04                       # j_type (bit 13)
            open(path, "wb").write(bytes(data))
        elif unread == "version":
            data = bytearray(open(path, "rb").read())
            for pkt, _ in native.video_track(path).packets:
                at = data.index(pkt)
                assert data[at:at + 4] == b"MAGY" and data[at + 8] == 7
                data[at + 8] = 6
            open(path, "wb").write(bytes(data))
        elif unread == "size":
            a = mk.lavc_encode(frames, "flv")
            b = mk.lavc_encode(mk.moving_frames(1, 2, 32, 48), "flv")
            open(path, "wb").write(mk.avi_file(a + b, 24, 16, 25, 5, b"FLV1"))
        else:
            path = _relabel(path, str(tmp_path / "v1.avi"), fourcc.encode(),
                            unread.encode())
        with pytest.raises(NotImplementedError, match=match):
            native.decode_video(path)
        return
    if fourcc.startswith("UQ") or fourcc.startswith("UM"):
        mk.write_cv2(str(tmp_path / "u.avi"), "ULY0", 25, frames)
        _relabel(str(tmp_path / "u.avi"), path, b"ULY0", fourcc.encode())
    else:
        mk.write_cv2(path, fourcc, 25, frames)
        assert len(mk.cv2_view(path)[0]) == 3      # cv2 reads them
    with pytest.raises(NotImplementedError, match=name):
        native.decode_video(path)
    with pytest.raises(NotImplementedError, match=name):
        native.load_video_frames(path, 4, 16)


def test_interlaced_pictures_raise(tmp_path):
    """cv2's swscale converts no frame libavcodec marks interlaced (a PNG
    in Adam7, UT Video under its interlace flag): the port raises, as for
    H.264's and HEVC's fields."""
    frames = mk.moving_frames(1, 3, 16, 24)
    packets = mk.lavc_encode(frames, "png", pixel_format="rgb24",
                             flags="+ildct")
    assert packets[0][28] == 1                     # IHDR interlace method
    path = _write(tmp_path, "p.avi", mk.avi_file(packets, 24, 16, 25, 3,
                                                 b"MPNG"))
    with pytest.raises(NotImplementedError, match="Adam7"):
        native.decode_video(path)
    info = {}
    packets = mk.lavc_encode(frames, "utvideo", info=info,
                             pixel_format="yuv420p")
    ext = bytearray(info["extradata"])
    ext[13] |= 0x08                                # flags: interlaced
    path = _write(tmp_path, "u.avi", mk.avi_file(packets, 24, 16, 25, 3,
                                                 b"ULY0", extradata=ext))
    with pytest.raises(NotImplementedError, match="interlaced"):
        native.decode_video(path)


def test_broken_streams_raise(tmp_path):
    """What libavcodec conceals or cv2 shows broken raises ValueError: an
    FFV1 slice whose CRC fails, an FFV1 configuration record whose CRC
    fails, HuffYUV tables that do not build, a UT Video packet cut short,
    an FFV1 non-key frame without a key frame before it."""
    frames = mk.moving_frames(2, 3, 32, 48)
    info = {}
    packets = mk.lavc_encode(frames, "ffv1", info=info,
                             pixel_format="yuv420p", level=3, slices=4,
                             slicecrc=1)
    bad = [p[:10] + bytes([p[10] ^ 0x40]) + p[11:] for p in packets]
    path = _write(tmp_path, "c.avi", mk.avi_file(
        bad, 48, 32, 25, 3, b"FFV1", extradata=info["extradata"]))
    with pytest.raises(ValueError, match="CRC"):
        native.decode_video(path)
    ext = bytearray(info["extradata"])
    ext[-1] ^= 1                                   # the record's CRC
    path = _write(tmp_path, "r.avi", mk.avi_file(
        packets, 48, 32, 25, 3, b"FFV1", extradata=ext))
    with pytest.raises(ValueError, match="CRC"):
        native.decode_video(path)
    gop = mk.lavc_encode(frames, "ffv1", pixel_format="yuv420p", level=1,
                         g=3)
    path = _write(tmp_path, "g.avi", mk.avi_file(gop[1:], 48, 32, 25, 2,
                                                 b"FFV1"))
    with pytest.raises(ValueError, match="key frame"):
        native.decode_video(path)
    info = {}
    packets = mk.lavc_encode(frames, "huffyuv", info=info,
                             pixel_format="yuv422p")
    ext = bytearray(info["extradata"])
    ext[4:12] = b"\xff" * 8                        # lengths that overrun
    path = _write(tmp_path, "h.avi", mk.avi_file(
        packets, 48, 32, 25, 3, b"HFYU", bits=16, extradata=ext))
    with pytest.raises(ValueError, match="HuffYUV"):
        native.decode_video(path)
    info = {}
    packets = mk.lavc_encode(frames, "utvideo", info=info,
                             pixel_format="yuv420p")
    path = _write(tmp_path, "u.avi", mk.avi_file(
        [p[:len(p) // 2] for p in packets], 48, 32, 25, 3, b"ULY0",
        extradata=info["extradata"]))
    with pytest.raises(ValueError, match="UT Video"):
        native.decode_video(path)


@pytest.mark.parametrize("fourcc", ["FFV1", "MPNG", "PNG "])
def test_cv2_mp4_lossless_sample_entries(tmp_path, fourcc):
    """cv2's writer stores FFV1 in MP4 under an FFV1 sample entry (its
    configuration record in a glbl box) and PNG under mp4v with
    objectTypeIndication 0x6D; the JAX package opens .mp4 first. (The
    writer rounds an odd size down to even.)"""
    for size in ((48, 64), (45, 77)):
        path = str(tmp_path / "t.mp4")
        mk.write_cv2(path, fourcc, 25, mk.moving_frames(len(fourcc), 4, *size))
        want = "ffv1" if fourcc == "FFV1" else "png"
        assert _held(path, want).shape == (4, size[0] & ~1, size[1] & ~1, 3)


@pytest.mark.parametrize("pred", ["left", "median"])
@pytest.mark.parametrize("fmt", ["yuva420p", "yuva422p"])
def test_ffvhuff_alpha_at_odd_sizes_live(tmp_path, fmt, pred):
    """F8: FFVHuff with alpha and 4:2:0 / 4:2:2 chroma at odd widths and
    one row high (the chroma column the bitstream does not code; a chroma
    line coded for a plane of no row) and the sizes that read 0 before
    (odd heights, even sizes; yuv444p at 77x64), in AVI, against cv2."""
    sizes = [(77, 77), (64, 77), (1, 24), (77, 64), (78, 78), (65, 96)]
    cases = [(fmt, s) for s in sizes] + [("yuv444p", (64, 77))]
    for f, (h, w) in cases:
        info = {}
        packets = mk.lavc_encode(mk.moving_frames(h + w, 3, h, w), "ffvhuff",
                                 info=info, pixel_format=f, pred=pred)
        path = _write(tmp_path, "f.avi", mk.avi_file(
            packets, w, h, 25, 3, b"FFVH", bits=info["bits"] or 24,
            extradata=info["extradata"]))
        assert _held(path, "huffyuv").shape == (3, h, w, 3), (f, h, w)
