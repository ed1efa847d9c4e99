"""The port's MagicYUV, ASV1/ASV2 and Snow readers (csrc/magicyuv.cpp,
csrc/asv.cpp, csrc/snow.cpp, routed by csrc/videodec.cpp and native.py)
on video as OpenCV's writer and capture tools store it, against cv2 and
the JAX package's `load_frames_for`.

The cases of tests/_torch_make_videos.py's OPENCV_CASES and OPENCV_CLIPS
(committed in tests/torch_videos/ with cv2's decodes): MagicYUV from
libavcodec 59's encoder in its seven 8-bit layouts under each predictor,
and written packet by packet (mk.magicyuv_packet) at 10, 12 and 14 bits,
with several slices, raw slices, slices of two rows, the interlace flag,
full range and BT.709; ASV1 and ASV2 at the default quantiser, at the
lowest (on noise) and the highest, at an odd size, without extradata;
Snow with both wavelets, lossless, quarter-pel, 4MV blocks, 2 and 4
references, keyframe intervals of 3 to 5, 4:4:4, 4:1:0 and grey, at odd
sizes; and cv2.VideoWriter's own files, in AVI and Matroska. Each goes
through `native.video_track` (packets byte for byte against cv2's
`CAP_PROP_FORMAT = -1`, the count, the size), `native.decode_video`
against `cap.read()` and the committed decode (0 levels), and both
packages' `load_frames_for` (0.0) at n 8 and 16 over windows, one of
which starts after a Snow keyframe. Beside them: the headers that make
each case what it is named for, cv2's writer live at 97x61 (and MP4
refusing these fourccs), and the variants libavcodec refuses raising.
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

ALL = [*mk.OPENCV_CASES, *mk.OPENCV_CLIPS]
FILES = {c: mk.path_of(c) for c in ALL}
WINDOWS = ((0.0, 1.0), (0.3, 0.6), (0.55, 1.0))


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
    for n in (8, 16):
        for window in WINDOWS:
            ref = j_av.load_frames_for(stem, n, 32, window)
            got = av.load_frames_for(stem, n, 32, window)
            assert got.shape == ref.shape and got.dtype == np.float32
            assert float(np.abs(got - ref).max()) == 0.0, (n, window)


def _magy_headers(name: str) -> list[dict]:
    """Each MagicYUV packet's header fields and its slices' flags and
    prediction bytes."""
    out = []
    for pkt, _ in native.video_track(FILES[name]).packets:
        (size, version, fmt, _, matrix, flags, w, h, sw,
         sh) = struct.unpack_from("<IBBBBB3x4I", pkt, 4)
        nslices = -(-h // sh)
        planes = mk.MAGY_LAYOUTS[[k for k, v in mk.MAGY_LAYOUTS.items()
                                  if v[0] == fmt][0]][4]
        offsets = struct.unpack_from(f"<{planes * nslices}I", pkt, 36)
        out.append(dict(version=version, fmt=fmt, matrix=matrix,
                        flags=flags, size=(w, h), slice_height=sh,
                        slices=[pkt[32 + o:32 + o + 2] for o in offsets]))
    return out


def _snow_keys(name: str) -> list[int]:
    """The keyframes of a Snow case: the range coder's first decision, at
    state 128 over the range 0xFF00, is 1 where the packet's first 16 bits
    reach 0xFF00 − 0x7F80."""
    track = native.video_track(FILES[name])
    return [i for i, (pkt, _) in enumerate(track.packets)
            if (pkt[0] << 8 | pkt[1]) >= 0x7F80]


def test_fixtures_hold_what_they_are_named_for():
    """MagicYUV's format byte, prediction, slices, raw flags, interlace
    and range flags and matrix as each case's packets hold them; ASV's
    quantiser byte (or none); Snow's keyframe pattern; the cv2 files'
    tags (cv2 stores MagicYUV as M8Y0)."""
    preds = {"left": 1, "gradient": 2, "median": 3}
    for name, (enc, tag, opts) in mk.OPENCV_CASES.items():
        track = native.video_track(FILES[name], packets=False)
        assert track.tag.endswith("M8Y0" if tag == "MAGY" and enc == "cv2"
                                  else tag), name
        if enc in ("magicyuv", "magyhand"):
            fmt = opts.get("pixel_format") or opts["fmt"]
            pred = preds.get(opts.get("pred"), opts.get("pred"))
            for hd in _magy_headers(name):
                assert hd["version"] == 7
                assert hd["fmt"] == mk.MAGY_LAYOUTS[fmt][0], name
                assert {s[1] for s in hd["slices"]} == {pred}, name
                assert hd["flags"] == (2 * opts.get("interlaced", False) +
                                       4 * opts.get("full_range", False))
                assert hd["matrix"] == opts.get("matrix", 0)
                nsl = -(-hd["size"][1] // hd["slice_height"])
                raw = {j for j, s in enumerate(hd["slices"]) if s[0] & 1}
                assert raw == {p * nsl + j for p in range(len(
                    hd["slices"]) // nsl) for j in opts.get("raw", ())}
                if enc == "magicyuv":
                    assert nsl == 1                # libavcodec 59's encoder
        if enc in ("asv1", "asv2"):
            data = open(FILES[name], "rb").read()
            has = b"ASUS" in data
            assert has != opts.get("noextra", False), name
    assert _snow_keys("snow_avi") == [0]
    assert _snow_keys("snow_g3_avi") == [0, 3, 6]
    assert _snow_keys("snow_odd_avi") == [0, 5]
    assert _snow_keys("snow_410_avi") == [0, 4]


def test_lossless_fixtures_read_their_source(tmp_path):
    """MagicYUV in RGB and Snow's lossless mode give back the frames they
    were written from (RGB above 8 bits within swscale's rounding)."""
    for name in ("magy_rgleft_avi", "magy_ramedian_avi", "magy10_rgmedian_avi",
                 "magy12_rgmedian_avi", "magy_slices10_mkv"):
        _, _, opts = mk.OPENCV_CASES[name]
        src = mk.moving_frames(sum(map(ord, name)), mk.OPENCV_FRAMES,
                               *opts.get("size", mk.OPENCV_SIZE))
        got = native.decode_video(FILES[name])
        deep = "10" in name or "12" in name
        assert int(np.abs(got.astype(int) - src).max()) <= (1 if deep else 0)
    # Snow's lossless mode: the I420 planes it was fed, as uncompressed
    # I420 reads them
    _, _, opts = mk.OPENCV_CASES["snow_lossless_avi"]
    src = mk.moving_frames(sum(map(ord, "snow_lossless_avi")), opts["frames"],
                           *mk.OPENCV_SIZE)
    raw = mk.avi_file([mk.i420(f) for f in src], 96, 64, 25, len(src),
                      b"I420", bits=12)
    ref = native.decode_video(_write(tmp_path, "i420.avi", raw))
    np.testing.assert_array_equal(
        native.decode_video(FILES["snow_lossless_avi"]), ref)


def test_magicyuv_median_above_8_bits_is_not_wrapped(tmp_path):
    """libavcodec's 10- to 14-bit median predictor (magicyuv_median_pred16)
    leaves the gradient term unwrapped, unlike the 8-bit one, which
    matters where planes wrap (RGB's B − G and R − G): packets written so
    read back their source in cv2 and in the port alike."""
    frames = mk.moving_frames(3, 2, 32, 48)
    good = [mk.magicyuv_packet(f, "gbrp10le", 3) for f in frames]
    path = _write(tmp_path, "m.avi", mk.avi_file(good, 48, 32, 25, 2,
                                                 b"M0RG"))
    got = _held(path, "magicyuv")
    assert int(np.abs(got.astype(int) - frames).max()) <= 1


def test_cv2_writer_live(tmp_path):
    """Every fourcc of the slice as cv2.VideoWriter writes it when opened
    at 97x61 (it stores the even size below, 96x60), in AVI and Matroska,
    against cv2; MP4 refuses them."""
    frames = mk.moving_frames(9, 4, 61, 97)
    for fourcc in ("MAGY", "ASV1", "ASV2", "SNOW"):
        for ext in ("avi", "mkv"):
            path = str(tmp_path / f"{fourcc}.{ext}")
            mk.write_cv2(path, fourcc, 25, frames)
            got = _held(path, {"MAGY": "magicyuv", "SNOW": "snow"}.get(
                fourcc, "asv"))
            assert got.shape == (4, 60, 96, 3)
        wr = cv2.VideoWriter(str(tmp_path / f"{fourcc}.mp4"),
                             cv2.VideoWriter_fourcc(*fourcc), 25, (97, 61))
        assert not wr.isOpened()
        wr.release()


def test_asv_quantiser_comes_from_the_extradata(tmp_path):
    """ASV's intra matrix is scaled by the extradata's first byte: the same
    packets under another byte read otherwise (as in cv2), and without
    extradata at the decoder's default."""
    data = bytearray(open(FILES["asv2_avi"], "rb").read())
    at = data.index(b"ASUS") - 4
    assert data[at] == 16                          # libavcodec 59's default
    data[at] = 10
    other = _held(_write(tmp_path, "q.avi", bytes(data)), "asv")
    base = native.decode_video(FILES["asv2_avi"])
    assert int(np.abs(other.astype(int) - base).max()) > 8


def _patched_magy(tmp_path, offset: int, value: int) -> str:
    data = bytearray(open(FILES["magy_y0median_avi"], "rb").read())
    for pkt, _ in native.video_track(FILES["magy_y0median_avi"]).packets:
        data[data.index(pkt) + offset] = value
    return _write(tmp_path, "p.avi", bytes(data))


def test_raises(tmp_path):
    """What libavcodec refuses: a MagicYUV version other than 7 or an
    unknown layout (NotImplementedError, naming it), a MagicYUV packet cut
    short, an ASV packet too short for its macroblocks, a Snow stream
    without its keyframe (ValueError); Snow's memc_only streams, whose
    packets libavcodec refuses (the range coder runs out before the
    blocks), of which cv2 reads no frame either."""
    with pytest.raises(NotImplementedError, match="MagicYUV version 6"):
        native.decode_video(_patched_magy(tmp_path, 8, 6))
    with pytest.raises(NotImplementedError, match="MagicYUV format 0x74"):
        native.decode_video(_patched_magy(tmp_path, 9, 0x74))
    pk = [p for p, _ in native.video_track(FILES["magy_y0median_avi"]).packets]
    path = _write(tmp_path, "cut.avi", mk.avi_file(
        [p[:len(p) // 2] for p in pk], 96, 64, 25, len(pk), b"M8Y0"))
    with pytest.raises(ValueError, match="MagicYUV"):
        native.decode_video(path)
    pk = [p for p, _ in native.video_track(FILES["asv1_avi"]).packets]
    path = _write(tmp_path, "short.avi", mk.avi_file(
        [p[:30] for p in pk], 96, 64, 25, len(pk), b"ASV1"))
    with pytest.raises(ValueError, match="ASV packet too short"):
        native.decode_video(path)
    pk = [p for p, _ in native.video_track(FILES["snow_g3_avi"]).packets]
    path = _write(tmp_path, "nokey.avi", mk.avi_file(pk[1:3], 96, 64, 25, 2,
                                                     b"SNOW"))
    with pytest.raises(ValueError, match="keyframe"):
        native.decode_video(path)
    frames = mk.moving_frames(2, 4, 64, 96)
    pk = mk.lavc_encode(frames, "snow", memc_only=1)
    path = _write(tmp_path, "memc.avi", mk.avi_file(pk, 96, 64, 25, 4,
                                                    b"SNOW"))
    cap = cv2.VideoCapture(path)
    assert not cap.read()[0]
    cap.release()
    with pytest.raises(ValueError, match="Snow"):
        native.decode_video(path)
    with pytest.raises(ValueError):
        av.load_frames_for(os.path.splitext(path)[0], 8, 32, (0.0, 1.0))


def test_snow_header_fields_written_by_hand(tmp_path):
    """Snow header fields libavcodec 59's encoder never writes, through the
    test's range coder (mk.SnowWriter): the half-pel filter's own taps
    read otherwise than the default ones (as in cv2); a colour space
    other than 0 and 1 and 4:2:2 chroma, which libavcodec refuses (cv2
    reads no frame), raise ValueError naming them."""
    frames = mk.moving_frames(4, 3, 64, 96)
    own = mk.snow_hand_packets(frames, {}, dict(
        taps=[(1, 6, [0, -12, 3, 0]), (1, 4, [0, -6, 1, 0])], mv=4))
    default = mk.snow_hand_packets(frames, {}, dict(
        taps=[(1, 6, [40, -10, 2, 0])] * 2, mv=4))
    a = _held(_write(tmp_path, "own.avi", mk.avi_file(
        own, 96, 64, 25, 3, b"SNOW")), "snow")
    b = _held(_write(tmp_path, "default.avi", mk.avi_file(
        default, 96, 64, 25, 3, b"SNOW")), "snow")
    assert int(np.abs(a[0].astype(int) - b[0]).max()) == 0
    assert int(np.abs(a[1:].astype(int) - b[1:]).max()) > 0
    for key, match in ((dict(colorspace=2), "colour space 2"),
                       (dict(shifts=(1, 0)), "chroma subsampling 1x0")):
        pk = mk.snow_hand_packets(frames, key, dict(mv=4))
        path = _write(tmp_path, "bad.avi", mk.avi_file(pk, 96, 64, 25, 3,
                                                       b"SNOW"))
        cap = cv2.VideoCapture(path)
        assert not cap.read()[0]
        cap.release()
        with pytest.raises(ValueError, match=match):
            native.decode_video(path)
