"""The port's VP9 decoder (csrc/vp9.cpp) and its conversion to BGR
(csrc/videodec.cpp, through native.py) on video as YouTube and browsers
write it, and on pictures that change size mid-stream, against cv2 and
the JAX package's `_load_frames_video`.

The cases of tests/_torch_make_videos.py's BROWSER_CASES and
BROWSER_CLIPS (committed in tests/torch_videos/ with cv2's decodes;
libvpx's own streams through its API, libx264's and PIL's for the size
changes of other codecs):

  * profile 2 at 10 and 12 bits in BT.2020 (YouTube's HDR uploads);
  * profiles 1 and 3: 4:4:4, 4:2:2 and 4:4:0 at 8, 10 and 12 bits, and
    sRGB (planar GBR) at 8, 10 and 12 bits;
  * reference scaling as libvpx's realtime encoder writes it when a
    browser's or a call's resolution drops and comes back: inter frames
    of a new size predicted from references of the old one (a half, three
    quarters, odd sizes; at 10 bits; with cyclic-refresh segmentation),
    back up without a keyframe or from one;
  * two spatial layers (SVC): each packet a superframe that shows both
    layers' pictures, the base layer coded intra-only at one frame;
  * pictures that change size mid-stream (fault F4): VP9, MJPEG and
    H.264 streams whose second part has another size, and a container
    that declares a size neither picture has;
  * the two 224x224 clips chip_smoke.py trains from (profile 2 10-bit
    two-pass with alt-refs; realtime dropping to 112x112 and back).

Each goes through `native.video_track` (packets byte for byte against
cv2's `CAP_PROP_FORMAT = -1`, the count against `CAP_PROP_FRAME_COUNT`,
the size against `CAP_PROP_FRAME_WIDTH`/`HEIGHT`: the first picture's),
`native.decode_video` against `cap.read()` (0 levels: VP9 is exact by
its specification, libavcodec follows libvpx's reference scaling bit for
bit, and the conversions copy swscale's), and
`load_video_frames`/`load_frames_for` against the JAX package at the
same bound, windows after the size changes included. cv2 converts every
picture to the first picture's size (its retrieveFrame scales each
picture with swscale's bicubic scaler, from the picture's own size and
chroma siting): the port's conversion of random planes, scaled and not,
in every layout, is held against cv2's own libswscale through ctypes.
What stays unread raises NotImplementedError naming it: sRGB in profile
0, profiles 1 and 3 with 4:2:0 sampling (libavcodec refuses both), a
reference outside the scaling range, and an 8-bit planar RGB picture
scaled to half its width or less (swscale then reads its chroma at half
width).
"""

import ctypes
import glob
import os
import re
import sys

import numpy as np
import pytest

from viai_tpu.data import av as j_av
from viai_tpu_torch import native
from viai_tpu_torch.data import av

cv2 = pytest.importorskip("cv2")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_make_videos as mk  # noqa: E402

CASES = list(mk.BROWSER_CASES)
ALL = [*CASES, *mk.BROWSER_CLIPS]
FILES = {c: mk.path_of(c) for c in ALL}
WINDOWS = (None, (0.25, 0.75), (0.6, 1.0), (0.5, 0.9))
SCALED = [c for c in CASES if "scaled" in c]


def _libvpx():
    """Skip unless cv2's wheel bundles libvpx to write streams."""
    libs = os.path.join(os.path.dirname(os.path.dirname(cv2.__file__)),
                        "opencv_python.libs")
    if not glob.glob(os.path.join(libs, "libvpx*.so*")):
        pytest.skip("cv2's wheel does not bundle libvpx")


@pytest.mark.parametrize("name", ALL)
def test_packets_and_count_match_cv2(name):
    path = FILES[name]
    track = native.video_track(path)
    got = [p for p, _ in track.packets]
    if track.codec == "h264" and track.config:
        got = mk.mp4toannexb(track)
    assert got == mk.cv2_packets(path)
    cap = cv2.VideoCapture(path)
    assert track.count == int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    assert (track.width, track.height) == (
        int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
        int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)))
    assert track.codec == mk.codec_of(name) and track.packets[0][1]


@pytest.mark.parametrize("name", ALL)
def test_decode_video_matches_cv2(name):
    got = native.decode_video(FILES[name])
    ref, _ = mk.cv2_view(FILES[name])
    assert got.shape == ref.shape and got.dtype == np.uint8
    err = int(np.abs(got.astype(int) - ref).max())
    print(f"{name}: max |Δ| {err} over {ref.shape}")
    assert err == 0


@pytest.mark.parametrize("name", ALL)
def test_load_frames_match_jax(name):
    path = FILES[name]
    worst = 0.0
    for n in (8, 16):
        for window in WINDOWS:
            ref = j_av._load_frames_video(path, n, 32, window)
            got = native.load_video_frames(path, n, 32, window)
            assert got.shape == ref.shape and got.dtype == np.float32
            worst = max(worst, float(np.abs(got - ref).max()))
    stem = os.path.splitext(path)[0]
    for window in WINDOWS[:2]:
        ref = j_av.load_frames_for(stem, 16, 64, window)
        got = av.load_frames_for(stem, 16, 64, window)
        worst = max(worst, float(np.abs(got - ref).max()))
    print(f"{name}: max |Δ| {worst * 255:.3f} / 255")
    assert worst == 0.0


@pytest.mark.parametrize("name", ALL)
def test_committed_decodes_are_cv2s(name):
    ref = np.load(os.path.join(mk.FIXTURES, name + ".npz"))
    frames, count = mk.cv2_view(FILES[name])
    assert int(ref["n"]) == len(frames) and int(ref["count"]) == count
    np.testing.assert_array_equal(ref["frames"], frames[ref["index"]])
    got = native.decode_video(FILES[name])
    assert got.shape[0] == int(ref["n"])
    np.testing.assert_array_equal(got[ref["index"]], ref["frames"])


@pytest.mark.parametrize("name", list(mk.BROWSER_CLIPS))
def test_committed_picks_are_the_jax_packages(name):
    """What chip_smoke.py holds the card's reads against: the JAX
    package's 16 frames at 64x64 of each window, stored as levels."""
    ref = np.load(os.path.join(mk.FIXTURES, name + ".npz"))
    for k, window in enumerate(mk.BROWSER_PICKS):
        jax = j_av._load_frames_video(FILES[name], 16, 64, window)
        np.testing.assert_array_equal(ref["picks"][k] / np.float32(255), jax)
        np.testing.assert_array_equal(
            native.load_video_frames(FILES[name], 16, 64, window), jax)
        assert tuple(ref["picks_windows"][k]) == (window or (-1.0, -1.0))


# ---- what the streams hold ------------------------------------------------

def _frames(packet: bytes) -> list[bytes]:
    """A VP9 packet's frames, by its superframe index (Annex B)."""
    m = packet[-1]
    if m & 0xE0 == 0xC0:
        n, mag = (m & 7) + 1, ((m >> 3) & 3) + 1
        size = 2 + mag * n
        if len(packet) >= size and packet[-size] == m:
            out, q, off = [], len(packet) - size + 1, 0
            for _ in range(n):
                k = int.from_bytes(packet[q:q + mag], "little")
                out.append(packet[off:off + k])
                q, off = q + mag, off + k
            return out
    return [packet]


def _kind(frame: bytes) -> str:
    """K keyframe, P inter, I intra-only, E show_existing_frame; s shown
    or h hidden."""
    bits = "".join(f"{b:08b}" for b in frame[:4])
    at = 4 + (bits[2:4] == "11")
    if bits[at] == "1":
        return "E"
    show = "s" if bits[at + 2] == "1" else "h"
    if bits[at + 1] == "0":
        return "K" + show
    return ("I" if show == "h" and bits[at + 4] == "1" else "P") + show


def test_scaled_cases_change_size_in_inter_frames():
    """libvpx's realtime encoder codes each new size as an inter frame
    from references of the old size (reference scaling), but where a
    keyframe is forced; the decoded sizes follow the schedule."""
    for name in SCALED:
        runs = mk.BROWSER_CASES[name]["sizes"]
        kinds = [_kind(f) for p, _ in native.video_track(FILES[name]).packets
                 for f in _frames(p)]
        starts = np.cumsum([0] + [r[2] for r in runs])[1:-1]
        forced = mk.BROWSER_CASES[name].get("keyframes", set())
        assert kinds[0] == "Ks"
        for k in starts:
            assert kinds[k] == ("Ks" if k in forced else "Ps"), (name, k)


def test_svc_superframes_show_both_layers_as_cv2_reads_them():
    """Two spatial layers: every packet a superframe of the base layer's
    picture (48x32) and the top one's (96x64), one with an intra-only
    base frame; cv2 counts 12 (its container's) and reads 24 pictures,
    each at the first one's size (the top layer's scaled down)."""
    packets = [p for p, _ in native.video_track(FILES["vp9_svc_webm"]).packets]
    kinds = [[_kind(f) for f in _frames(p)] for p in packets]
    assert all(k[-2:] == ["Ps", "Ps"] or k == ["Ks", "Ps"] for k in kinds)
    assert kinds[6][0] == "Ih" and sum(k[0] == "Ih" for k in kinds) == 1
    ref, count = mk.cv2_view(FILES["vp9_svc_webm"])
    assert (len(ref), count) == (24, 12) and ref.shape[1:3] == (32, 48)


def test_size_change_fixtures_hold_f4():
    """F4: the second part's pictures are scaled to the first picture's
    size as cv2 scales them (its decode equals the port's at 0 levels,
    above); the container's declared size plays no part."""
    for name in ("vp9_newsize_webm", "mjpeg_newsize_avi", "h264_newsize_avi",
                 "vp9_container_webm"):
        parts = mk.BROWSER_CASES[name]["parts"]
        got = native.decode_video(FILES[name])
        assert got.shape == (sum(p[2] for p in parts), *parts[0][:2], 3)
        track = native.video_track(FILES[name])
        assert (track.height, track.width) == parts[0][:2]


def test_browser_fixtures_rewrite_the_committed_files(tmp_path):
    """libvpx with one thread writes the same bytes again: high bit
    depth, other samplings, a size schedule, SVC (the existing libvpx
    cases' bytes are held by test_torch_video_decode.py)."""
    _libvpx()
    for name in ("vp9_hdr10_webm", "vp9_44410_mp4", "vp9_scaledaq_mp4",
                 "vp9_svc_webm", "vp9_srgb_webm", "h264_newsize_avi"):
        path = mk.write_case(name, str(tmp_path))
        with open(path, "rb") as f, open(FILES[name], "rb") as g:
            assert f.read() == g.read(), name


# ---- what stays unread -----------------------------------------------------

def _webm(tmp_path, packets, w=64, h=48):
    path = tmp_path / "x.webm"
    path.write_bytes(mk.mkv_file(packets, w, h, 25, "V_VP9"))
    return str(path)


# A keyframe's bits: marker 2, profile 2 (low, high), [reserved 1 in
# profile 3], show_existing 1, type, show, error_resilient 3, sync code
# 24, then the colour config.
@pytest.mark.parametrize("feature,case,patch", [
    ("VP9 colour space sRGB in profile 0", "vp9_scaled_webm",
     [(32, 3, 7)]),
    ("VP9 profile 1 with 4:2:0 sampling", "vp9_444_mkv",
     [(36, 2, 3)]),
    ("VP9 profile 3 with 4:2:0 sampling", "vp9_44410_mp4",
     [(38, 2, 3)]),
])
def test_patched_keyframes_still_unread_raise_naming_them(tmp_path, feature,
                                                          case, patch):
    """Colour configs libavcodec refuses (cv2 gives no frame): sRGB in
    profile 0, 4:2:0 sampling signalled in profiles 1 and 3."""
    packets = [p for p, _ in native.video_track(FILES[case]).packets]
    for pos, n, value in patch:
        packets[0] = mk.set_bits(packets[0], pos, n, value)
    path = _webm(tmp_path, packets)
    with pytest.raises(NotImplementedError, match=re.escape(feature)):
        native.decode_video(path)
    with pytest.raises(NotImplementedError, match=re.escape(feature)):
        native.load_video_frames(path, 4, 32)


@pytest.mark.parametrize("size", [(20, 14), (1100, 800)])
def test_reference_outside_the_scaling_range_raises(tmp_path, size):
    """An inter frame written after a 64x48 keyframe whose size makes its
    references more than twice its own or less than a sixteenth of it
    (libavcodec refuses the frame)."""
    _libvpx()
    w, h = size
    frame = mk.vp9_header((2, 2), (0, 2), (0, 1), (1, 1), (1, 1), (0, 1),
                    (0, 2), (0, 8), *[(0, 4)] * 3, (0, 3),
                    (w - 1, 16), (h - 1, 16))
    path = _webm(tmp_path, [mk.libvpx_encode(
        mk.moving_frames(2, 1, 48, 64), "vp9")[0], frame])
    with pytest.raises(NotImplementedError,
                       match="VP9 reference scaling beyond its range"):
        native.decode_video(path)


# ---- swscale's paths --------------------------------------------------------

def _swscale():
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
    au.av_opt_set_int.argtypes = [vp, ctypes.c_char_p, ctypes.c_int64,
                                  ctypes.c_int]
    au.av_log_set_level.argtypes = [ctypes.c_int]
    au.av_log_set_level(8)                # its "2 tap" notes are not errors
    sw.sws_alloc_context.restype = vp
    sw.sws_init_context.argtypes = [vp, vp, vp]
    sw.sws_getCoefficients.restype = vp
    sw.sws_setColorspaceDetails.argtypes = [vp, vp, ctypes.c_int, vp] + \
        [ctypes.c_int] * 4
    sw.sws_scale.argtypes = [vp, vp, vp, ctypes.c_int, ctypes.c_int, vp, vp]
    sw.sws_freeContext.argtypes = [vp]
    return au, sw


def _cv2_swscale(au, sw, planes, fmt, size, full, matrix, pos):
    """cv2's libswscale: the planes to BGR24 at `size` (h, w) with
    SWS_BICUBIC, the source chroma at `pos` (src_h_chr_pos, src_v_chr_pos;
    -513 swscale's default)."""
    h, w = planes[0].shape
    dh, dw = size
    ctx = sw.sws_alloc_context()
    for k, v in (("srcw", w), ("srch", h), ("dstw", dw), ("dsth", dh),
                 ("src_format", au.av_get_pix_fmt(fmt.encode())),
                 ("dst_format", au.av_get_pix_fmt(b"bgr24")),
                 ("sws_flags", 4), ("src_h_chr_pos", pos[0]),
                 ("src_v_chr_pos", pos[1])):
        assert au.av_opt_set_int(ctx, k.encode(), v, 0) == 0, k
    assert sw.sws_init_context(ctx, None, None) >= 0
    coef = sw.sws_getCoefficients(matrix)
    sw.sws_setColorspaceDetails(ctx, coef, int(full), coef, 1, 0, 1 << 16,
                                1 << 16)
    planes = [np.ascontiguousarray(p) for p in planes]
    src = (ctypes.c_void_p * 4)(*[p.ctypes.data for p in planes], None)
    strides = (ctypes.c_int * 4)(*[p.strides[0] for p in planes], 0)
    out = np.zeros((dh + 2, 3 * dw + 64), np.uint8)   # its SIMD overwrites
    dst = (ctypes.c_void_p * 4)(out.ctypes.data, None, None, None)
    dst_strides = (ctypes.c_int * 4)(out.strides[0], 0, 0, 0)
    sw.sws_scale(ctx, src, strides, 0, h, dst, dst_strides)
    sw.sws_freeContext(ctx)
    return out[:dh, :3 * dw].reshape(dh, dw, 3)


@pytest.mark.parametrize("layout", ["420", "422", "444", "440"])
def test_conversion_matches_cv2_swscale(layout):
    """Random planes at 8, 10 and 12 bits of every size to 39x33, limited
    and full range, BT.601, BT.709 and BT.2020, swscale's default chroma
    siting and H.264's, converted at their own size or scaled to another
    (as cv2 converts a picture of another size than the stream's first:
    the bicubic scaler's 1-, 2- and n-tap vertical outputs, MMXEXT and C,
    full chroma for 4:4:4 and odd widths): the port's copy against
    cv2's libswscale, 0 levels."""
    au, sw = _swscale()
    xs = 0 if layout in ("444", "440") else 1
    ys = 1 if layout in ("420", "440") else 0
    rng = np.random.default_rng(int(layout))
    for trial in range(80):
        w, h = int(rng.integers(2, 40)), int(rng.integers(2, 34))
        size = (h, w) if trial % 3 == 0 else \
            (int(rng.integers(2, 50)), int(rng.integers(2, 60)))
        depth = int(rng.choice([8, 10, 12]))
        full, matrix = bool(rng.integers(0, 2)), int(rng.choice([5, 1, 9]))
        loc = int(rng.choice([0, 1]))
        kind = np.uint8 if depth == 8 else np.uint16
        y = rng.integers(0, 1 << depth, (h, w)).astype(kind)
        u, v = (rng.integers(0, 1 << depth, ((h + ys) >> ys, (w + xs) >> xs))
                .astype(kind) for _ in range(2))
        pos = (0, 128 if ys else -513) if loc else (-513, -513)
        fmt = f"yuv{layout}p" + ("" if depth == 8 else f"{depth}le")
        ref = _cv2_swscale(au, sw, (y, u, v), fmt, size, full, matrix, pos)
        got = native.yuv_to_bgr(y, u, v, (xs, ys), depth, full, matrix, loc,
                                size=size)
        assert np.array_equal(got, ref), (layout, w, h, size, depth, full,
                                          matrix, loc)


@pytest.mark.parametrize("depth", [8, 10, 12])
def test_gbrp_conversion_matches_cv2_swscale(depth):
    """Planar GBR (VP9's sRGB; cv2 passes the frame's RGB colour space,
    0, and full range, which swscale takes as limited for RGB input): at
    8 bits and its own size swscale's unscaled planar-RGB converter,
    else its scaler from the RGB-to-YUV lines of planar_rgb16_to_y/uv;
    an 8-bit picture of even width scaled to half of it or less as
    swscale scales it (its chroma read at half width, each sample from a
    pair of pixels)."""
    au, sw = _swscale()
    rng = np.random.default_rng(depth)
    kind = np.uint8 if depth == 8 else np.uint16
    fmt = "gbrp" + ("" if depth == 8 else f"{depth}le")
    for trial in range(40):
        w, h = int(rng.integers(1, 40)), int(rng.integers(1, 30))
        size = (h, w) if trial % 2 == 0 else \
            (int(rng.integers(2, 50)), int(rng.integers(w // 2 + 1, 60)))
        full, matrix = bool(rng.integers(0, 2)), int(rng.choice([0, 1, 9]))
        g, b, r = (rng.integers(0, 1 << depth, (h, w)).astype(kind)
                   for _ in range(3))
        ref = _cv2_swscale(au, sw, (g, b, r), fmt, size, full, matrix,
                           (-513, -513))
        got = native.yuv_to_bgr(g, b, r, (0, 0), depth, full, matrix,
                                size=size, rgb=True)
        assert np.array_equal(got, ref), (w, h, size, full, matrix)
    if depth == 8:
        for w in (2, 8, 30):
            g, b, r = (rng.integers(0, 256, (4, w)).astype(np.uint8)
                       for _ in range(3))
            for size in ((4, w // 2), (3, 1)):
                ref = _cv2_swscale(au, sw, (g, b, r), fmt, size, True, 0,
                                   (-513, -513))
                got = native.yuv_to_bgr(g, b, r, (0, 0), 8, True, 0,
                                        size=size, rgb=True)
                assert np.array_equal(got, ref), (w, size)
