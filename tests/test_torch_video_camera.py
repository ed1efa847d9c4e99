"""The port's H.264 decoder (csrc/h264.cpp, through csrc/videodec.cpp and
native.py) on H.264 as cameras and other encoders write it, against cv2
and the JAX package's `_load_frames_video`.

The cases of tests/_torch_make_videos.py's CAMERA_CASES and CAMERA_CLIPS
(committed in tests/torch_videos/ with cv2's decodes; libx264's streams
of real pictures, rewritten where libx264 does not write the feature):

  * High 4:2:2 and High 10 at 10 bits: B-frames, intra only (as XAVC
    Intra and AVC-Intra code), CAVLC with weighted prediction, I_PCM;
    4:2:2 at 8 bits; monochrome at 8 and 10 bits, which libavcodec
    outputs with neutral chroma and cv2 converts as YUV;
  * progressive frames of an interlace-capable stream (frame_mbs_only_flag
    0, "PsF"): with B-frames, at a height of 8 modulo 16 lines (cropped
    in 4-row units), under a picture timing SEI that says they are
    frames;
  * B-frames without the VUI's bitstream_restriction and without a VUI,
    where libavcodec guesses its reorder depth: from what libavformat's
    probe saw (and, in MP4, from the composition times), growing later
    and dropping a frame where cv2 drops it (a B-pyramid in AVI; P frames
    and then an IDR picture with a B-pyramid);
  * B_8x8 macroblocks with sub-macroblock partitions below 8x8 (8x4,
    4x8, 4x4 of each list and both), which libx264 never writes: B
    slices written by the fixture script;
  * the two 224x224 clips chip_smoke.py trains from (High 4:2:2 10-bit
    with B-frames in MP4; PsF with B-frames and no bitstream_restriction
    in Matroska).

Each goes through `native.video_track` (packets byte for byte against
cv2's `CAP_PROP_FORMAT = -1`, the count against `CAP_PROP_FRAME_COUNT`),
`native.decode_video` against `cap.read()` (0 levels: H.264 is exact by
its specification, the conversion copies swscale's scaler, which cv2
runs for 10-bit pictures with H.264's left-sited chroma), and
`load_video_frames`/`load_frames_for` against the JAX package at the
same bound. Beside them: the conversion of random 9- and 10-bit planes
against cv2's own libswscale (through ctypes), the reorder guess on
live streams in AVI, Matroska and MP4, and NotImplementedError naming
what stays unread: MBAFF, field pictures, frames a picture timing SEI
flags interlaced (cv2 cannot convert them), and what libavcodec refuses
too: separate_colour_plane_flag, luma and chroma of different depths,
11 and 13 bits. (4:4:4, lossless coding and 12 and 14 bits are read:
tests/test_torch_video_screen.py.)
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

CASES = list(mk.CAMERA_CASES)
ALL = [*CASES, *mk.CAMERA_CLIPS]
FILES = {c: mk.path_of(c) for c in ALL}
WINDOWS = (None, (0.25, 0.75), (0.6, 1.0))


def _x264():
    """Skip unless libx264 (build 164) is there to write streams."""
    try:
        ctypes.CDLL("libx264.so.164")
    except OSError:
        pytest.skip("libx264.so.164 is not installed")


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


def test_guessed_reorder_depth_drops_what_cv2_drops():
    """Where the stream gives no bitstream_restriction, the frames cv2
    reads (and drops) are the port's: a B-pyramid from the start is seen
    by libavformat's probe (AVI and Matroska drop one frame where the
    depth outgrows its guess; MP4's composition times give it at once)."""
    counts = {}
    for name in ("h264_norestrict_avi", "h264_norestrict_mp4",
                 "h264_deep_avi"):
        ref, count = mk.cv2_view(FILES[name])
        counts[name] = (len(ref), count)
    assert counts == {"h264_norestrict_avi": (29, 30),
                      "h264_norestrict_mp4": (30, 30),
                      "h264_deep_avi": (23, 24)}


@pytest.mark.parametrize("ext,settings", [
    ("avi", dict(bframes=0, frames=4, edit="deep")),
    ("avi", dict(bframes=0, frames=6, edit="deep")),
    ("avi", dict(bframes=0, frames=10, edit="deep")),
    ("avi", dict(bframes=1, frames=20, edit="no restriction")),
    ("mkv", dict(bframes=3, b_pyramid="strict", frames=20,
                 edit="no restriction")),
    ("mkv", dict(bframes=3, b_pyramid="normal", frames=20, edit="no vui")),
    ("mp4", dict(bframes=5, b_pyramid="normal", frames=20,
                 edit="no restriction")),
])
def test_reorder_guess_matches_cv2_live(tmp_path, ext, settings):
    """Streams whose reorder depth libavcodec guesses: `frames` P frames,
    then an IDR picture and a B-pyramid ("deep": libavformat's probe
    decodes until it has output 7 pictures, so the depth it hands cv2's
    decoder sees the pyramid only after 4 P frames), and B-frames of
    several depths without bitstream_restriction or without a VUI; the
    count and the frames (with any dropped) are cv2's."""
    _x264()
    aus = mk.camera_stream(settings, seed=len(str(settings)))
    path = tmp_path / f"x.{ext}"
    path.write_bytes(mk.h264_file(aus, 64, 48, ext))
    ref, count = mk.cv2_view(str(path))
    got = native.decode_video(str(path))
    assert native.video_track(str(path)).count == count
    assert got.shape == ref.shape
    assert int(np.abs(got.astype(int) - ref).max()) == 0


def test_camera_fixtures_rewrite_the_committed_files(tmp_path):
    """libx264 with one thread writes the same bytes again, 10-bit and
    4:2:2 planes, patched and written slices included."""
    _x264()
    for name in ("h264_42210_mp4", "h264_mono8_avi", "h264_psfcrop_mkv",
                 "h264_norestrict_avi", "h264_deep_avi", "h264_sub8x8_avi"):
        path = mk.write_case(name, str(tmp_path))
        with open(path, "rb") as f, open(FILES[name], "rb") as g:
            assert f.read() == g.read(), name


def test_sub8x8_slices_code_every_sub_macroblock_type():
    """The written B slices, read back: B_8x8 macroblocks (and skips)
    whose sub-macroblocks take every sub_mb_type 0-12."""
    pk = [p for p, _ in native.video_track(FILES["h264_sub8x8_avi"]).packets]
    sps, subs, slices = None, set(), 0
    for p in pk:
        for u in mk.nal_units(p):
            bits = mk.rbsp_bits(u)
            if u[0] & 31 == 7:
                sps = mk.sps_fields(bits)
            r = mk.BitReader(bits)
            if u[0] & 31 != 1 or (r.ue(), r.ue() % 5)[1] != 1:
                continue
            slices += 1
            r.ue()
            r.u(sps.log2_max_frame_num + sps.log2_max_poc_lsb)
            assert r.u(2) == 3 and (r.ue(), r.ue()) == (0, 0)
            assert r.u(2) == 0 and r.se() == 0
            r.ue(), r.se(), r.se()
            end = len(bits.rstrip("0")) - 1       # the rbsp_stop_one_bit
            while r.p < end:
                r.ue()                            # mb_skip_run
                if r.p >= end:
                    break
                assert r.ue() == 22               # B_8x8
                types = [r.ue() for _ in range(4)]
                subs.update(types)
                for lst in (1, 2):
                    for t in types:
                        if mk.SUB_B_LISTS[t] & lst:
                            for _ in range(2 * mk.SUB_B_PARTS[t]):
                                r.se()
                assert r.ue() == 0                # coded_block_pattern
            assert r.p == end
    assert slices >= 5 and subs == set(range(13))


def _x264_avi(tmp_path, **settings):
    aus = mk.x264_encode(mk.moving_frames(3, 6, 48, 64), **settings)
    path = tmp_path / "x.avi"
    path.write_bytes(mk.h264_file(aus, 64, 48, "avi"))
    return str(path)


@pytest.mark.parametrize("feature,settings", [
    ("MBAFF", dict(interlaced=1)),
    ("MBAFF", dict(interlaced=1, bff=1, cabac=0)),
    ("MBAFF", dict(interlaced=1, csp=6, bitdepth=10, profile="high422")),
    ("flagged interlaced", dict(fake_interlaced=1, pic_struct=1,
                                picture_struct=4)),
    ("flagged interlaced", dict(pic_struct=1, picture_struct=5)),
])
def test_x264_streams_still_unread_raise_naming_them(tmp_path, feature,
                                                     settings):
    """libx264's own streams of what is not read; cv2 gives near-black
    frames for the interlaced ones (swscale: "Cannot convert interlaced
    to progressive frames")."""
    _x264()
    path = _x264_avi(tmp_path, **settings)
    with pytest.raises(NotImplementedError, match=re.escape(feature)):
        native.decode_video(path)
    with pytest.raises(NotImplementedError, match=re.escape(feature)):
        native.load_video_frames(path, 4, 32)


@pytest.mark.parametrize("feature,patches", [
    ("field pictures", [((1, 5), "field_pic", "10", 0),
                        (7, "frame_mbs_only", "00", 1)]),
    ("11 and 13 bits", [(7, "bit_depth_luma", mk.ue_bits(3), 3),
                        (7, "bit_depth_chroma", mk.ue_bits(3), 3)]),
    ("different bit depths", [(7, "bit_depth_chroma", mk.ue_bits(0), 3)]),
    ("separate_colour_plane_flag", [(7, "separate_colour_plane", "1", 1)]),
    ("11 and 13 bits", [(7, "bit_depth_luma", mk.ue_bits(5), 3),
                        (7, "bit_depth_chroma", mk.ue_bits(5), 3)]),
    ("different bit depths", [(7, "bit_depth_luma", mk.ue_bits(4), 3),
                              (7, "bit_depth_chroma", mk.ue_bits(6), 3)]),
    ("different bit depths", [(7, "bit_depth_luma", mk.ue_bits(0), 3)]),
])
def test_patched_streams_still_unread_raise_naming_them(tmp_path, feature,
                                                        patches):
    """Headers libx264 does not write, patched into its 10-bit High
    stream (High 4:4:4 Predictive for separate_colour_plane_flag) bit by
    bit: field pictures (frame_mbs_only_flag 0 without MBAFF, a bottom
    field_pic_flag in every slice), and what libavcodec refuses too: 11-
    and 13-bit samples, luma and chroma of different depths (10 and 8,
    12 and 14, 8 and 10), 4:4:4 coded as three separate planes."""
    _x264()
    four = any(field == "separate_colour_plane" for _, field, _, _ in patches)
    aus = mk.x264_encode(mk.moving_frames(4, 4, 48, 64), bitdepth=10,
                         profile="high444" if four else "high10",
                         csp=12 if four else 2, cabac=0, bframes=0,
                         weightp=0)
    packets = [a for a, _, _ in aus]
    for kinds, field, new, old in patches:
        for kind in (kinds if isinstance(kinds, tuple) else (kinds,)):
            packets = mk.patch_h264(packets, kind, field, new, old)
    path = tmp_path / "x.avi"
    path.write_bytes(mk.avi_file(packets, 64, 48, 25, len(packets), b"H264"))
    with pytest.raises(NotImplementedError, match=re.escape(feature)):
        native.decode_video(str(path))
    if feature != "field pictures":
        with pytest.raises(NotImplementedError, match="libavcodec refuses"):
            native.decode_video(str(path))


# ---- swscale's path from 9- and 10-bit planes ----------------------------

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
    sw.sws_alloc_context.restype = vp
    sw.sws_init_context.argtypes = [vp, vp, vp]
    sw.sws_getCoefficients.restype = vp
    sw.sws_setColorspaceDetails.argtypes = [vp, vp, ctypes.c_int, vp] + \
        [ctypes.c_int] * 4
    sw.sws_scale.argtypes = [vp, vp, vp, ctypes.c_int, ctypes.c_int, vp, vp]
    sw.sws_freeContext.argtypes = [vp]
    return au, sw


def _cv2_swscale(au, sw, planes, fmt, full, matrix, pos):
    """cv2's libswscale: the planes to BGR24 at the same size with
    SWS_BICUBIC, the source chroma at `pos` (swscale's src_h_chr_pos and
    src_v_chr_pos, -513 its default)."""
    h, w = planes[0].shape
    ctx = sw.sws_alloc_context()
    for k, v in (("srcw", w), ("srch", h), ("dstw", w), ("dsth", h),
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
    out = np.zeros((h + 2, 3 * w + 64), np.uint8)     # its SIMD overwrites
    dst = (ctypes.c_void_p * 4)(out.ctypes.data, None, None, None)
    dst_strides = (ctypes.c_int * 4)(out.strides[0], 0, 0, 0)
    sw.sws_scale(ctx, src, strides, 0, h, dst, dst_strides)
    sw.sws_freeContext(ctx)
    return out[:h, :3 * w].reshape(h, w, 3)


@pytest.mark.parametrize("layout", ["420", "422"])
def test_high_depth_conversion_matches_cv2_swscale(layout):
    """Random 9- and 10-bit planes of every size to 33x29 (odd widths:
    swscale's full chroma output), limited and full range, BT.601 and
    BT.709, swscale's default chroma siting and H.264's (left: what cv2
    asks of the frames libavcodec's H.264 decoder gives): the port's
    copy of swscale's scaler with its 16-bit horizontal pass against
    cv2's libswscale, 0 levels."""
    au, sw = _swscale()
    rng = np.random.default_rng(int(layout))
    ys = 1 if layout == "420" else 0
    for trial in range(120):
        w, h = int(rng.integers(1, 34)), int(rng.integers(1, 30))
        depth = int(rng.choice([9, 10]))
        full, matrix = bool(rng.integers(0, 2)), int(rng.choice([5, 1]))
        loc = int(rng.choice([0, 1]))
        y = rng.integers(0, 1 << depth, (h, w)).astype(np.uint16)
        u, v = (rng.integers(0, 1 << depth, ((h + ys) >> ys, (w + 1) // 2))
                .astype(np.uint16) for _ in range(2))
        pos = (0, 128 if ys else -513) if loc else (-513, -513)
        ref = _cv2_swscale(au, sw, (y, u, v), f"yuv{layout}p{depth}le", full,
                           matrix, pos)
        got = native.yuv_to_bgr(y, u, v, (1, ys), depth, full, matrix, loc)
        assert np.array_equal(got, ref), (w, h, depth, full, matrix, loc)
