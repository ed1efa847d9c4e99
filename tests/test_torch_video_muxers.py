"""The port's readers on video as mkvmerge and other muxers store it
(csrc/videodec.cpp's Matroska content encodings, frame rates without
DefaultDuration and laced blocks, fragmented MP4's tails, MJPEG's field
pairs and 4:1:1, swscale's gbrp and grey scalers; csrc/inflate.h),
against cv2 and the JAX package's `load_frames_for`.

The cases of tests/_torch_make_videos.py's MUXER_CASES and MUXER_CLIPS
(committed in tests/torch_videos/ with cv2's decodes): header stripping,
zlib and LZO on the frames and the CodecPrivate of H.264, HEVC, MPEG-4,
MPEG-2, VP8, MJPEG, V_UNCOMPRESSED and HuffYUV tracks; H.264, HEVC,
MPEG-4, MPEG-1 and MPEG-2 without DefaultDuration (cv2's rate from the
stream's own timing: H.264 blocks at 30 and 50 fps under a 25 fps VUI
count 10 and 6), Xiph, fixed and EBML lacing without it; fragmented MP4
with a timecode or a text track and with a second sample entry of the
first's bytes; MJPEG field pairs (AVI1) in AVI and Matroska and 4:1:1;
grey MJPEG and libx264rgb's GBR at a new size. Each goes through
`native.video_track` (packets byte for byte against cv2's
`CAP_PROP_FORMAT = -1`, H.264 and HEVC through the tests' copies of
libavcodec's mp4toannexb filters; the count and the size),
`native.decode_video` against `cap.read()` and the committed decode (0
levels), and both packages' `load_frames_for` (0.0) over four windows.
Beside them, written live: the rates of more streams, the raises (what
cv2 reads no frame of as ValueError, what is not copied as
NotImplementedError naming it), and swscale's two scalers on random
planes against cv2's libswscale.
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
import test_torch_video_browser as browser  # noqa: E402
import test_torch_video_hevc as hevc  # noqa: E402

ALL = [*mk.MUXER_CASES, *mk.MUXER_CLIPS]
FILES = {c: mk.path_of(c) for c in ALL}
WINDOWS = ((0.0, 1.0), (0.3, 0.6), (0.7, 1.0), (0.9, 1.0))


def _write(tmp_path, name: str, data: bytes) -> str:
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    return path


def _packets(track) -> list[bytes]:
    """The track's packets as cv2 gives them (H.264 and HEVC in MP4 and
    Matroska after libavcodec's mp4toannexb filters)."""
    if track.codec == "h264" and track.config:
        return mk.mp4toannexb(track)
    if track.codec == "hevc" and track.config:
        return hevc.hevc_mp4toannexb(track)
    return [p for p, _ in track.packets]


def _cv2_info(path: str) -> tuple[int, float, tuple[int, int]]:
    cap = cv2.VideoCapture(path)
    info = (int(cap.get(cv2.CAP_PROP_FRAME_COUNT)),
            cap.get(cv2.CAP_PROP_FPS),
            (int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
             int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))))
    cap.release()
    return info


def _held(path: str) -> np.ndarray:
    """The port's track and frames against cv2's packets, count, size and
    frames; → the frames."""
    track = native.video_track(path)
    assert _packets(track) == mk.cv2_packets(path)
    count, _, size = _cv2_info(path)
    assert track.count == count
    assert (track.width, track.height) == size
    got = native.decode_video(path)
    ref, _ = mk.cv2_view(path)
    assert got.shape == ref.shape and got.dtype == np.uint8
    assert int(np.abs(got.astype(int) - ref).max()) == 0
    return got


def _windows_match_jax(path: str) -> None:
    stem = os.path.splitext(path)[0]
    for window in WINDOWS:
        try:
            ref = j_av.load_frames_for(stem, 16, 32, window)
        except ValueError:                   # picks past the frames held
            with pytest.raises(ValueError):
                av.load_frames_for(stem, 16, 32, window)
            continue
        got = av.load_frames_for(stem, 16, 32, window)
        assert got.shape == ref.shape and got.dtype == np.float32
        assert float(np.abs(got - ref).max()) == 0.0, window


@pytest.mark.parametrize("name", ALL)
def test_track_and_frames_match_cv2(name):
    got = _held(FILES[name])
    track = native.video_track(FILES[name], packets=False)
    assert track.codec == mk.codec_of(name)
    ref = np.load(os.path.join(mk.FIXTURES, name + ".npz"))
    assert got.shape[0] == int(ref["n"])
    np.testing.assert_array_equal(got[ref["index"]], ref["frames"])
    assert int(ref["count"]) == track.count


@pytest.mark.parametrize("name", ALL)
def test_load_frames_match_jax(name):
    _windows_match_jax(FILES[name])


def test_h264_rate_comes_from_its_vui_not_its_blocks():
    """H.264 without DefaultDuration: cv2 counts at the VUI's 25 fps
    whatever the blocks' rate, so 12 frames in blocks at 30 and 50 fps
    count 10 and 6, and the JAX package picks over those counts."""
    for name, count in (("h264_nodd30_mkv", 10), ("h264_nodd50_mkv", 6)):
        track = native.video_track(FILES[name], packets=False)
        assert track.count == count
        assert _cv2_info(FILES[name])[:2] == (count, 25.0)
        assert native.decode_video(FILES[name]).shape[0] == 12


def _element(data: bytes, eid: int) -> bool:
    """Whether a Matroska file's header (before its first Cluster) holds
    the element ID `eid`."""
    tag = eid.to_bytes((eid.bit_length() + 7) // 8, "big")
    return tag in data[:data.index(b"\x1f\x43\xb6\x75")]


def test_fixtures_hold_what_they_are_named_for():
    """Each Matroska case's content encoding (its algorithm and scope),
    the DefaultDuration left out, the lacing of its blocks; the MP4s'
    timecode or text track and second sample entry; the AVI1 markers and
    4:1:1 frame headers of the MJPEG cases."""
    for name, spec in {**mk.MUXER_CASES, **mk.MUXER_CLIPS}.items():
        data = open(FILES[name], "rb").read()
        if name.endswith("_mkv"):
            assert _element(data, 0x6D80) == bool(spec.get("enc")), name
            head = data[:data.index(b"\x1f\x43\xb6\x75")]
            if spec.get("enc"):
                algo = {"strip": 3, "zlib": 0, "lzo": 2}[spec["enc"].split()[0]]
                assert bytes([0x42, 0x54, 0x81, algo]) in head, name
                scope = 3 if "priv" in spec["enc"] else 1
                assert bytes([0x50, 0x32, 0x81, scope]) in head, name
            assert _element(data, 0x23E383) == ("rate" not in spec), name
        if name.endswith("_mp4"):
            assert b"moof" in data, name
        kind = spec.get("data", {}).get("kind")
        if kind:
            assert (b"tmcd" in data) == (kind == "tmcd"), name
            assert b"hdlr" in data and kind.encode() in data, name
        if spec.get("desc"):
            at = data.index(b"stsd")
            assert struct.unpack_from(">I", data, at + 8)[0] == 2, name
        if spec.get("layout", "").startswith("fields"):
            assert data.count(b"AVI1") == 2 * mk.MUXER_FRAMES, name
        if spec.get("layout") == "4:1:1":
            assert b"\xff\xc0\x00\x11\x08" in data and \
                b"\x01\x41\x00" in data, name
    # Laced blocks without DefaultDuration: libavformat times a lace's
    # first frame only, so cv2's rate, and count, is the blocks'.
    for name in ("vp8_lace2_mkv", "vp8_lace3_mkv", "mjpeg_lace3_mkv",
                 "raw_lace4_mkv"):
        track = native.video_track(FILES[name])
        k = mk.MUXER_CASES[name]["lace"][0]
        assert track.count == -(-len(track.packets) // k), name


def test_lzo_stream_round_trips_through_the_reader(tmp_path):
    """mk.lzo1x_compress's matches and literal runs of every length form
    through the reader, on an LZO-compressed V_UNCOMPRESSED track: random
    bytes (literal runs past 238 and 255), repeats (long matches)."""
    rng = np.random.default_rng(5)
    w, h = 18, 10
    frames = []
    for k in range(6):
        f = rng.integers(0, 256, (h, w, 3), np.uint8)
        if k % 2:
            f[:, 6:] = f[:, :1]                  # long runs
        frames.append(f)
    packets = [mk.i420(f) for f in frames]
    data = mk.mkv_file(packets, w, h, 25, "V_UNCOMPRESSED",
                       colour_space=b"I420",
                       encodings=[dict(algo=2)])
    path = _write(tmp_path, "lzo.mkv", data)
    _held(path)


# ---- rates without DefaultDuration, written live --------------------------

@pytest.mark.parametrize("stream,fps,rate", [
    ("mpeg1", 12, 30), ("mpeg1", 15, 25), ("mpeg1", 50, 25),
    ("mpeg4", 4, 25), ("mpeg4", 101, 25), ("mpeg2", 60, 25),
    ("mpeg2", 30, 30), ("h264", "24000/1001", 30), ("h264", "12", 25),
    ("hevc", 60, 25)])
def test_stream_rates_match_cv2(tmp_path, stream, fps, rate):
    """cv2's count of more streams without DefaultDuration: MPEG-1 at 2F
    in [5, 101) (else libavformat's average), MPEG-4's VOL rate in [5,
    101), the average rounded to a standard rate for H.264, HEVC, MPEG-2
    and the rest."""
    spec = dict(stream=stream, fps=fps, rate=rate, bf=0)
    path = _write(tmp_path, "rate.mkv", mk.muxer_file("rate_mkv", spec))
    _held(path)


@pytest.mark.parametrize("kind", ["tmcd", "text"])
def test_data_tracks_count_as_cv2_counts(tmp_path, kind):
    """A timecode or text track beside fragmented video moves cv2's count
    only within a second of the video's span (libavformat's non-primary
    streams): its samples' shift and its mdhd duration, with and without
    sound."""
    packets, keys, (w, h), config, _ = mk.container_packets("mpeg4")
    n = len(packets)
    for shift, duration, audio in ((0, 0, False), (5, 0, False),
                                   (30, 0, False), (0, 50, False),
                                   (0, 60, True), (3, 0, True)):
        data = mk.mp4_file(
            packets, w, h, 25, b"mp4v", config, sync=keys,
            fragments=[12, 12, n - 24],
            data_track=dict(kind=kind, shift=shift, duration=duration),
            audio=mk.audio_track(n, 25, 8000) if audio else None)
        path = _write(tmp_path, "data.mp4", data)
        count = native.video_track(path, packets=False).count
        assert count == _cv2_info(path)[0], (shift, duration, audio)


# ---- the raises ------------------------------------------------------------

def _h264_mkv(**opts) -> bytes:
    spec = dict(stream="h264")
    frames = mk.moving_frames(3, 8)
    packets, times, keys, (w, h), cid, priv, _, _ = mk.muxer_stream(
        spec, frames)
    return mk.mkv_file(packets, w, h, 25, cid, priv, keys=keys,
                       pts=[p - times[0][1] for p, _ in times], **opts)


@pytest.mark.parametrize("kind,error,words", [
    ("encrypted", NotImplementedError, "encrypted content"),
    ("bzlib", ValueError, "bzlib"),
    ("two", ValueError, "2 content encodings"),
])
def test_encodings_that_stay_raising(tmp_path, kind, error, words):
    """Encryption (cv2 would decode the bytes as they are) raises
    NotImplementedError; bzlib, which cv2's libavformat lacks, and two
    encodings, of which it undoes none, leave cv2 no frame: ValueError,
    as the JAX package raises."""
    specs = {"encrypted": [dict(type=1)], "bzlib": [dict(algo=1)],
             "two": [dict(algo=3, settings=b"\0\0"), dict(type=1, order=1)]}
    path = _write(tmp_path, "enc.mkv", _h264_mkv(encodings=specs[kind]))
    if kind != "encrypted":
        cap = cv2.VideoCapture(path)
        assert not cap.read()[0]
        cap.release()
        with pytest.raises(ValueError):
            j_av.load_frames_for(os.path.splitext(path)[0], 4, 16, None)
    with pytest.raises(error, match=words):
        native.decode_video(path)


@pytest.mark.parametrize("case", ["h264 no vui", "hevc no timing",
                                  "h264 1000 fps"])
def test_rates_that_stay_raising(tmp_path, case):
    """Streams that give libavformat no rate it can average: H.264
    without VUI timing, HEVC without it, timing of 1000 fps or more. cv2
    then estimates from timestamps it reorders; the port raises."""
    spec = {"h264 no vui": dict(stream="h264", vui=False),
            "hevc no timing": dict(stream="hevc", params="vui-timing-info=0"),
            "h264 1000 fps": dict(stream="h264", fps=1000)}[case]
    data = mk.muxer_file("rate_mkv", dict(spec, rate=25),
                         mk.moving_frames(4, 8))
    words = {"h264 no vui": "timing in its VUI",
             "hevc no timing": "HEVC track without DefaultDuration or timing",
             "h264 1000 fps": "1000 fps"}[case]
    path = _write(tmp_path, "rate.mkv", data)
    assert _cv2_info(path)[0] > 0
    with pytest.raises(NotImplementedError, match=words):
        native.video_track(path, packets=False)


def test_second_run_without_data_offset_is_read_as_cv2_reads_it(tmp_path):
    """A second trun without a data offset in one traf: libavformat reads
    its samples from the fragment's base again (the standard: after the
    run before). The port's packets are cv2's bytes; decoding raises, as
    cv2 stops at the first packet libavcodec refuses."""
    packets, keys, (w, h), config, _ = mk.container_packets("mpeg4")
    n = len(packets)
    for base_offset in (False, True):
        data = mk.mp4_file(packets, w, h, 25, b"mp4v", config, sync=keys,
                           fragments=[12, 12, n - 24], run_samples=4,
                           base_offset=base_offset)
        path = _write(tmp_path, "runs.mp4", data)
        track = native.video_track(path)
        assert [p for p, _ in track.packets] == mk.cv2_packets(path)
        assert track.packets[4][0] != packets[4]
        assert track.count == _cv2_info(path)[0]
        with pytest.raises(NotImplementedError, match="data offset"):
            native.decode_video(path)


def test_fragment_of_another_description_stays_raising(tmp_path):
    """libavformat decodes every fragment with the first sample entry's
    parameters, whichever its tfhd names; a second entry of other bytes
    raises (cv2 breaks its pictures from that fragment on)."""
    frames = mk.moving_frames(9, 16)
    a1 = mk.x264_encode(frames[:8], bframes=0, keyint=8, profile="main",
                        cabac=0)
    a2 = mk.x264_encode(frames[8:], bframes=0, keyint=8)
    s1, sps1, pps1 = mk.avc_samples([a for a, _, _ in a1])
    s2, sps2, pps2 = mk.avc_samples([a for a, _, _ in a2])
    h, w = frames.shape[1:3]
    entry = mk._box(b"avc1", bytes(6), struct.pack(
        ">HHH12xHHIIIH32sHh", 1, 0, 0, w, h, 0x480000, 0x480000, 0, 1, b"",
        24, -1), mk.avcc_box(sps2, pps2))
    data = mk.mp4_file(s1 + s2, w, h, 25, b"avc1", mk.avcc_box(sps1, pps1),
                       sync=[0, 8], fragments=[8, 8], entries=[entry],
                       descriptions=[1, 2])
    path = _write(tmp_path, "desc.mp4", data)
    assert len(mk.cv2_view(path)[0]) < 16          # cv2's pictures break
    with pytest.raises(NotImplementedError, match="sample description 2"):
        native.video_track(path)


@pytest.mark.parametrize("case", ["12-bit", "one field"])
def test_mjpeg_that_stays_raising(tmp_path, case):
    """MJPEG of 12 bits (no encoder here writes one: a frame header's
    precision patched) and a field pair split over two packets raise,
    naming them."""
    frames = mk.moving_frames(6, 4)
    if case == "12-bit":
        jpegs = mk.pil_jpegs(frames)
        packets = [j.replace(b"\xff\xc0\x00\x11\x08", b"\xff\xc0\x00\x11\x0c",
                             1) for j in jpegs]
        h, words = 56, "12-bit"
    else:
        packets = [mk.pil_jpegs([np.ascontiguousarray(f[k::2])])[0]
                   for f in frames for k in (0, 1)]
        h, words = 56, "one field in a packet"
    path = _write(tmp_path, "mj.avi",
                  mk.avi_file(packets, 72, h, 25, len(packets), b"MJPG"))
    with pytest.raises(NotImplementedError, match=words):
        native.decode_video(path)


# ---- swscale's scalers on random planes ------------------------------------

def test_gbrp_and_grey_scaling_match_cv2_swscale():
    """8-bit planar GBR scaled to half its even width or less (swscale's
    chrSrcHSubSample: each chroma sample from a pair of pixels), and
    8-bit grey at a new size (full range, mid chroma), random planes of
    sizes from 1x2 against cv2's libswscale, 0 levels."""
    au, sw = browser._swscale()
    rng = np.random.default_rng(11)
    halves = 0
    for trial in range(120):
        w, h = int(rng.integers(2, 60)), int(rng.integers(1, 30))
        size = (int(rng.integers(1, 40)), int(rng.integers(1, 40)))
        if trial % 2:
            size = (size[0], max(1, w // 2 - int(rng.integers(0, 3))))
        halves += w % 2 == 0 and size[1] <= w // 2
        g, b, r = (rng.integers(0, 256, (h, w)).astype(np.uint8)
                   for _ in range(3))
        ref = browser._cv2_swscale(au, sw, (g, b, r), "gbrp", size, False, 5,
                                   (-513, -513))
        got = native.yuv_to_bgr(g, b, r, (0, 0), 8, False, 5, 0, size=size,
                                rgb=True)
        assert np.array_equal(got, ref), ("gbrp", w, h, size)
        y = rng.integers(0, 256, (h, w)).astype(np.uint8)
        ref = browser._cv2_swscale(au, sw, (y,), "gray", size, True, 5,
                                   (-513, -513))
        got = native.yuv_to_bgr(y, y, y, (0, 0), 8, True, 5, 0, size=size,
                                grey=True)
        assert np.array_equal(got, ref), ("gray", w, h, size)
    assert halves >= 30


def test_fixture_script_rewrites_the_committed_files(tmp_path):
    """muxer_file writes the same bytes again (libx264, libx265 and
    libavcodec on one thread, zlib and the LZO writer deterministic)."""
    for name in ("h264_strip_mkv", "h264_lzo_mkv", "hevc_zlib_mkv",
                 "mpeg1_nodd60_mkv", "vp8_lace3_mkv", "h264_fragtmcd_mp4",
                 "mjpeg_fields_avi", "h264_gbrhalf_avi", "clip_strip_mkv"):
        path = mk.write_case(name, str(tmp_path))
        with open(path, "rb") as f, open(FILES[name], "rb") as g:
            assert f.read() == g.read(), name


# libavformat's riff tags of MJPEG (ff_codec_bmp_tags) beyond MJPG, AVRn,
# JPGL, dmb1 and mjpa; MJLS names its JPEG-LS decoder, which reads
# baseline JPEG as the MJPEG one does.
MJPEG_TAGS = ["jpeg", "LJPG", "IJPG", "ACDV", "QIVG", "SLMJ", "CJPG", "IJLV",
              "MVJP", "AVI1", "AVI2", "ZJPG", "MJLS", "MMJP"]


@pytest.mark.parametrize("tag", MJPEG_TAGS)
def test_mjpeg_riff_tags_read_as_cv2_reads_them(tmp_path, tag):
    """Each tag on a frame AVI and on an AVI1 field-pair AVI: cv2's
    frames, the field pairs woven first-field-even as for every tag but
    MJPG (trap (ah))."""
    for src in ("mjpeg_avi", "mjpeg_fields_avi"):
        path = mk.relabel(mk.path_of(src), str(tmp_path / f"{src}.avi"),
                          b"MJPG", tag.encode())
        track = native.video_track(path, packets=False)
        assert track.codec == "mjpeg" and track.tag == tag
        got, (ref, _) = native.decode_video(path), mk.cv2_view(path)
        assert got.shape == ref.shape
        assert int(np.abs(got.astype(int) - ref).max()) == 0, src


def test_mtsj_raises_naming_it(tmp_path):
    """MTSJ, which libavcodec decodes otherwise than plain MJPEG (cv2's
    frames of the same JPEGs differ), raises by name."""
    path = mk.relabel(mk.path_of("mjpeg_avi"), str(tmp_path / "m.avi"),
                      b"MJPG", b"MTSJ")
    ref, _ = mk.cv2_view(path)
    plain = native.decode_video(mk.path_of("mjpeg_avi"))
    assert int(np.abs(plain.astype(int) - ref).max()) > 100
    with pytest.raises(NotImplementedError, match="MTSJ"):
        native.decode_video(path)
