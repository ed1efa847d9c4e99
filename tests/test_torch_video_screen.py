"""The port's H.264 decoder (csrc/h264.cpp, through csrc/videodec.cpp and
native.py) on H.264 as ffmpeg writes it from images and screens, against
cv2 and the JAX package's `_load_frames_video`.

The cases of tests/_torch_make_videos.py's SCREEN_CASES and SCREEN_CLIPS
(committed in tests/torch_videos/ with cv2's decodes; libx264's streams,
their SPS patched where libx264 does not write the depth):

  * High 4:4:4 Predictive, what `ffmpeg -i %05d.png -c:v libx264` writes
    from RGB images: CABAC with B-frames and the 8x8 transform (Cb and
    Cr coded as luma, their own coded_block_flag of 8x8 blocks), CAVLC
    with weighted prediction, intra only, 10 bits, the JVT scaling lists
    (twelve), I_PCM beside 8x8 blocks, a crop of 8 lines (crop units of
    1);
  * libx264rgb's GBR (matrix_coefficients 0: libavcodec's gbrp, G coded
    as Y, B as Cb, R as Cr), lossy and lossless;
  * lossless transform bypass (`-qp 0`, screen captures) at 4:2:0 with
    CAVLC and no deblocking and with CABAC and B-frames, at 4:2:2, 4:4:4
    and 10 bits (the intra horizontal and vertical modes accumulating
    their residual);
  * 12- and 14-bit samples (a 10-bit stream's SPS patched: libavcodec
    reads it as such, and cv2's swscale converts yuv420p12 and
    yuv444p14);
  * the two 224x224 clips chip_smoke.py trains from (4:4:4 8-bit with
    the medium preset in MP4; lossless 4:2:0 with the ultrafast preset
    in Matroska).

Each goes through `native.video_track` (packets byte for byte against
cv2's `CAP_PROP_FORMAT = -1`, the count against `CAP_PROP_FRAME_COUNT`),
`native.decode_video` against `cap.read()` (0 levels), and
`load_video_frames`/`load_frames_for` against the JAX package at the same
bound. Beside them: the lossless fixtures against their source pictures,
the headers each fixture is named for, libavcodec's lossless intra
prediction, which accumulates the residual in the High 4:4:4 Predictive
profile only (a stream relabelled CAVLC 4:4:4 Intra), the conversion of
random 12- and
14-bit planes (yuv420p, yuv422p, yuv444p, gbrp) against cv2's own
libswscale (through ctypes), and NotImplementedError naming 4:4:4 CABAC
or lossless coding with the 8x8 transform from libx264 before build 151,
whose streams libavcodec reads with a workaround.
"""

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
from test_torch_video_browser import _cv2_swscale, _swscale  # noqa: E402
from test_torch_video_camera import _x264  # noqa: E402

CASES = list(mk.SCREEN_CASES)
ALL = [*CASES, *mk.SCREEN_CLIPS]
FILES = {c: mk.path_of(c) for c in ALL}
WINDOWS = (None, (0.25, 0.75), (0.6, 1.0))


@pytest.mark.parametrize("name", ALL)
def test_packets_and_count_match_cv2(name):
    path = FILES[name]
    track = native.video_track(path)
    got = [p for p, _ in track.packets]
    if track.config:
        got = mk.mp4toannexb(track)
    assert got == mk.cv2_packets(path)
    cap = cv2.VideoCapture(path)
    assert track.count == int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    assert (track.width, track.height) == (
        int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
        int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)))
    assert track.codec == "h264" and track.packets[0][1]


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
    for n in (16, 40):
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


@pytest.mark.parametrize("name", CASES)
def test_committed_decodes_are_cv2s(name):
    ref = np.load(os.path.join(mk.FIXTURES, name + ".npz"))
    frames, count = mk.cv2_view(FILES[name])
    assert int(ref["n"]) == len(frames) and int(ref["count"]) == count
    np.testing.assert_array_equal(ref["frames"], frames[ref["index"]])
    got = native.decode_video(FILES[name])
    assert got.shape[0] == int(ref["n"])
    np.testing.assert_array_equal(got[ref["index"]], ref["frames"])


def _sps(name):
    """The fields of a fixture's first SPS (its packets as cv2 gives
    them)."""
    for p in mk.cv2_packets(FILES[name]):
        for u in mk.nal_units(p):
            if u[0] & 31 == 7:
                return u[1], mk.sps_fields(mk.rbsp_bits(u))
    raise AssertionError(f"{name}: no SPS")


@pytest.mark.parametrize("name", ALL)
def test_fixtures_code_what_they_are_named_for(name):
    """Each stream's SPS: High 4:4:4 Predictive (profile_idc 244) for
    4:4:4 and lossless, its chroma format, bit depth and transform bypass,
    matrix_coefficients 0 for GBR."""
    profile, sps = _sps(name)
    settings = {**mk.SCREEN_CASES, **mk.SCREEN_CLIPS}[name]
    lossless = settings.get("qp") == 0
    csp = settings.get("csp", 2)
    assert sps.chroma_format_idc == {2: 1, 6: 2, 12: 3, 14: 3}[csp]
    assert profile == (110 if name == "h264_12bit_avi" else 244)
    assert sps.bypass == lossless
    assert sps.bit_depth == {"12 bits": 12, "14 bits": 14}.get(
        settings.get("edit"), settings.get("bitdepth", 8))
    assert (sps.matrix == 0) == (csp == 14)


@pytest.mark.parametrize("name", [n for n in ALL
                                  if {**mk.SCREEN_CASES, **mk.SCREEN_CLIPS}
                                  [n].get("qp") == 0])
def test_lossless_fixtures_give_their_source_pictures(name):
    """Lossless streams decode to the pictures libx264 was given: GBR's
    BGR frames themselves, and YCbCr's planes as the conversion of the
    source's own planes (H.264's left-sited chroma)."""
    settings = {**mk.SCREEN_CASES, **mk.SCREEN_CLIPS}[name]
    if name in mk.SCREEN_CLIPS:
        frames = mk.clip_frames_bgr()[:16]
    else:
        h, w = settings.get("size", (48, 64))
        frames = mk.moving_frames(sum(map(ord, name)),
                                  settings.get("frames", 12), h, w)
    got = native.decode_video(FILES[name])
    ref, _ = mk.cv2_view(FILES[name])
    csp, depth = settings.get("csp", 2), settings.get("bitdepth", 8)
    assert got.shape[0] == len(frames)
    for k, f in enumerate(frames):
        if csp == 14:
            src = f
        else:
            planes = mk.planes_of(f, csp)
            if depth > 8:
                planes = [p.astype(np.uint16) << (depth - 8) for p in planes]
            shift = {2: (1, 1), 6: (1, 0), 12: (0, 0)}[csp]
            src = native.yuv_to_bgr(*planes, shift, depth, chroma_loc=1)
        assert np.array_equal(got[k], src), (name, k)
        assert np.array_equal(ref[k], src), (name, k)


def test_screen_fixtures_rewrite_the_committed_files(tmp_path):
    """libx264 with one thread writes the same bytes again: 4:4:4,
    packed BGR input, lossless and a patched depth."""
    _x264()
    for name in ("h264_444_mp4", "h264_gbrlossless_avi", "h264_444pcm_avi",
                 "h264_12bit_avi"):
        path = mk.write_case(name, str(tmp_path))
        with open(path, "rb") as f, open(FILES[name], "rb") as g:
            assert f.read() == g.read(), name


@pytest.mark.parametrize("settings", [
    dict(csp=12, bframes=2),
    dict(qp=0),
    dict(csp=12, qp=0, cabac=0),
])
def test_old_x264_builds_with_the_8x8_transform_raise(tmp_path, settings):
    """A stream whose SEI names libx264 before build 151 (libavcodec
    reads its 4:4:4 CABAC and lossless 8x8 blocks with a workaround for
    that encoder's contexts and prediction, not copied here) raises
    naming it; the same stream under its own build decodes as cv2 reads
    it."""
    _x264()
    aus = mk.x264_encode(mk.moving_frames(9, 4, 48, 64), profile="high444",
                         **settings)
    packets = [a for a, _, _ in aus]
    assert b"x264 - core 164" in packets[0]
    for build, raises in ((b"164", False), (b"150", True)):
        path = tmp_path / f"x{build.decode()}.avi"
        path.write_bytes(mk.avi_file(
            [p.replace(b"core 164", b"core " + build) for p in packets],
            64, 48, 25, len(packets), b"H264"))
        if raises:
            with pytest.raises(NotImplementedError,
                               match=re.escape("before build 151 (core 150")):
                native.decode_video(str(path))
        else:
            ref, _ = mk.cv2_view(str(path))
            assert np.array_equal(native.decode_video(str(path)), ref)


@pytest.mark.parametrize("csp", [2, 12])
def test_cavlc_444_intra_profile_accumulates_no_lossless_residual(tmp_path,
                                                                 csp):
    """libavcodec runs the lossless horizontal and vertical prediction of
    8.3.5.1 in the High 4:4:4 Predictive profile only: libx264's lossless
    intra stream relabelled CAVLC 4:4:4 Intra (profile_idc 44) decodes
    to other pictures than its source, and the port gives cv2's."""
    _x264()
    frames = mk.moving_frames(5, 4, 48, 64)
    aus = mk.x264_encode(frames, csp=csp, profile="high444", qp=0, cabac=0,
                         keyint=1)
    packets = []
    for a, _, _ in aus:
        units = [bytes([u[0], 44]) + u[2:] if u[0] & 31 == 7 else u
                 for u in mk.nal_units(a)]
        packets.append(b"".join(b"\0\0\0\1" + u for u in units))
    path = tmp_path / "x.avi"
    path.write_bytes(mk.avi_file(packets, 64, 48, 25, len(packets), b"H264"))
    ref, _ = mk.cv2_view(str(path))
    assert np.array_equal(native.decode_video(str(path)), ref)
    shift = {2: (1, 1), 12: (0, 0)}[csp]
    src = np.stack([native.yuv_to_bgr(*mk.planes_of(f, csp), shift,
                                      chroma_loc=1) for f in frames])
    assert not np.array_equal(ref, src)


@pytest.mark.parametrize("layout", ["420", "422", "444"])
def test_12_and_14_bit_conversion_matches_cv2_swscale(layout):
    """Random 12- and 14-bit planes of every size to 39x33 (14 bits: new
    to the scaler's 16-bit horizontal pass), limited and full range,
    BT.601, BT.709 and BT.2020, swscale's default chroma siting and
    H.264's, at their own size or scaled to another: the port's copy of
    swscale against cv2's libswscale, 0 levels."""
    au, sw = _swscale()
    xs = 0 if layout == "444" else 1
    ys = 1 if layout == "420" else 0
    rng = np.random.default_rng(int(layout) + 14)
    for trial in range(60):
        w, h = int(rng.integers(2, 40)), int(rng.integers(2, 34))
        size = (h, w) if trial % 3 else \
            (int(rng.integers(2, 50)), int(rng.integers(2, 60)))
        depth = int(rng.choice([12, 14]))
        full, matrix = bool(rng.integers(0, 2)), int(rng.choice([5, 1, 9]))
        loc = int(rng.choice([0, 1]))
        y = rng.integers(0, 1 << depth, (h, w)).astype(np.uint16)
        u, v = (rng.integers(0, 1 << depth, ((h + ys) >> ys, (w + xs) >> xs))
                .astype(np.uint16) for _ in range(2))
        pos = (0, 128 if ys else -513) if loc else (-513, -513)
        ref = _cv2_swscale(au, sw, (y, u, v), f"yuv{layout}p{depth}le", size,
                           full, matrix, pos)
        got = native.yuv_to_bgr(y, u, v, (xs, ys), depth, full, matrix, loc,
                                size=size)
        assert np.array_equal(got, ref), (layout, w, h, size, depth, full,
                                          matrix, loc)


def test_gbrp14_conversion_matches_cv2_swscale():
    """14-bit planar GBR (H.264's GBR at 14 bits: libavcodec's gbrp14):
    swscale's RGB input lines from planar_rgb16_to_y/uv, its own size and
    scaled, against cv2's libswscale."""
    au, sw = _swscale()
    rng = np.random.default_rng(14)
    for trial in range(30):
        w, h = int(rng.integers(1, 40)), int(rng.integers(1, 30))
        size = (h, w) if trial % 2 == 0 else \
            (int(rng.integers(2, 50)), int(rng.integers(2, 60)))
        full, matrix = bool(rng.integers(0, 2)), int(rng.choice([0, 1]))
        g, b, r = (rng.integers(0, 1 << 14, (h, w)).astype(np.uint16)
                   for _ in range(3))
        ref = _cv2_swscale(au, sw, (g, b, r), "gbrp14le", size, full, matrix,
                           (-513, -513))
        got = native.yuv_to_bgr(g, b, r, (0, 0), 14, full, matrix,
                                size=size, rgb=True)
        assert np.array_equal(got, ref), (w, h, size, full, matrix)
