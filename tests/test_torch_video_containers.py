"""The port's video reader (csrc/videodec.cpp through native.py) on video
as phones and muxers write it, against cv2 and the JAX package's
`_load_frames_video`.

The cases of tests/_torch_make_videos.py's CONTAINER_CASES and
PHONE_CLIPS (committed in tests/torch_videos/ with cv2's decodes) re-mux
one stream each (cv2's MPEG-4 and VP8, libx264's High, PIL's MJPEG):

  * MP4 display matrices: 90, 180 and 270 degrees in tkhd, in mvhd and in
    both (libavformat multiplies them), version 1 boxes, 45 degrees and a
    scale (which cv2 leaves unturned); Matroska Projections with a roll of
    90, -90 and 180 degrees;
  * fragmented MP4: one fragment a keyframe (with and without mehd), one a
    sample, moov's own samples before fragments, an audio traf beside the
    video's, tfhd's base-data-offset, libx264's B-frames as negative
    composition offsets (trun version 1) and under ffmpeg's edit list;
  * Matroska without DefaultDuration at 25, 29.97, 30, 23.976 and 15 fps
    (block times in ms);
  * a sound track before or after the video: PCM in AVI (idx1 and
    OpenDML, `##wb` chunks interleaved), in MP4 (`sowt` in chunks of
    several stsc runs) and in Matroska (track 1, laced by Xiph, fixed and
    EBML lacing and in BlockGroups); AAC (`mp4a`, libavcodec's encoder)
    in MP4;
  * the two 224-wide clips chip_smoke.py trains from: a phone's (90
    degrees, AAC) and a fragmented one.

Each goes through `native.video_track` (packets byte for byte against
cv2's `CAP_PROP_FORMAT = -1`, the count against `CAP_PROP_FRAME_COUNT`,
the orientation against `CAP_PROP_ORIENTATION_META`),
`native.decode_video` against `cap.read()` and `load_video_frames`/
`load_frames_for` against the JAX package, at the video reader's bounds
(0 levels). Beside them, against cv2 live: the rules behind cv2's count
of a fragmented file (tfdt, audio, mdhd, composition offsets, edit
lists) and its rate for Matroska without DefaultDuration (random block
times), the angles that cv2 rounds or leaves unturned, the projections
it ignores; and NotImplementedError or ValueError, naming it, for what
is not read: a mirrored display matrix, a mirrored or cubemap
projection, a variable frame rate without DefaultDuration (where the
JAX package reads frame 0 only), H.264 and MPEG-4 in Matroska without
DefaultDuration, and fragments that overlap, lack a data offset, use
another sample description or sit beside a track that is neither video
nor sound.
"""

import os
import re
import shutil
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

# levels of 255 at full size: the video reader's bounds
# (tests/test_torch_video_decode.py)
TOL = {"mjpeg": 0, "mpeg4": 0, "vp8": 0, "vp9": 0, "h264": 0}
CASES = list(mk.CONTAINER_CASES)
ALL = [*CASES, *mk.PHONE_CLIPS]
FILES = {c: mk.path_of(c) for c in ALL}
WINDOWS = (None, (0.25, 0.75), (0.1, 0.9), (0.0, 0.3), (0.6, 1.0))
# the turned cases, each with the case of the same stream unturned
TURNED = {"mpeg4_rot90_mp4": 90, "mpeg4_rot180_mp4": 180,
          "mpeg4_rot270_mp4": 270, "mpeg4_movie90_mp4": 90,
          "mpeg4_movie180_mp4": 180, "mpeg4_movie270_mp4": 270,
          "mpeg4_rot90x2_mp4": 180, "vp8_roll90_mkv": 270,
          "vp8_rollm90_mkv": 90, "vp8_roll180_mkv": 180}


def _cv2_info(path):
    cap = cv2.VideoCapture(path)
    info = {k: cap.get(getattr(cv2, "CAP_PROP_" + k)) for k in (
        "FRAME_COUNT", "ORIENTATION_META", "FRAME_WIDTH", "FRAME_HEIGHT",
        "FPS")}
    cap.release()
    return info


def _held(path):
    """The port's track, decode and JAX parity of a file against cv2 →
    (track, cv2's info, max |Δ| of decode_video, of load_video_frames)."""
    track = native.video_track(path)
    got = [p for p, _ in track.packets]
    if track.codec == "h264" and track.config:
        got = mk.mp4toannexb(track)
    assert got == mk.cv2_packets(path)
    info = _cv2_info(path)
    assert track.count == int(info["FRAME_COUNT"])
    assert track.orientation == int(info["ORIENTATION_META"])
    ref = mk.cv2_view(path)[0]
    dec = native.decode_video(path)
    assert dec.shape == ref.shape
    load = 0.0
    for window in (None, (0.2, 0.8)):
        try:
            b = j_av._load_frames_video(path, 8, 32, window)
        except ValueError:                  # picks past the frames held
            with pytest.raises(ValueError):
                native.load_video_frames(path, 8, 32, window)
            continue
        a = native.load_video_frames(path, 8, 32, window)
        load = max(load, float(np.abs(a - b).max()))
    return track, info, int(np.abs(dec.astype(int) - ref).max()), load


@pytest.mark.parametrize("name", ALL)
def test_packets_count_and_orientation_match_cv2(name):
    path = FILES[name]
    track = native.video_track(path)
    got = [p for p, _ in track.packets]
    if track.codec == "h264" and track.config:
        got = mk.mp4toannexb(track)
    assert got == mk.cv2_packets(path)
    info = _cv2_info(path)
    assert track.count == int(info["FRAME_COUNT"])
    assert track.orientation == int(info["ORIENTATION_META"])
    size = (track.width, track.height)
    if track.orientation in (90, 270):          # cv2 gives the turned size
        size = size[::-1]
    assert size == (int(info["FRAME_WIDTH"]), int(info["FRAME_HEIGHT"]))
    assert track.codec == mk.codec_of(name)
    assert track.packets[0][1]                  # the first is a keyframe


@pytest.mark.parametrize("name", ALL)
def test_decode_video_matches_cv2(name):
    path = FILES[name]
    got = native.decode_video(path)
    ref = mk.cv2_view(path)[0]
    assert got.shape == ref.shape and got.dtype == np.uint8
    err = int(np.abs(got.astype(int) - ref).max())
    print(f"{name}: max |Δ| {err} over {ref.shape}")
    assert err <= TOL[mk.codec_of(name)]


@pytest.mark.parametrize("name", ALL)
def test_load_frames_match_jax(name):
    path = FILES[name]
    stem = os.path.splitext(path)[0]
    worst = 0.0
    for n in (16, 40):
        for window in WINDOWS:
            for size in (64, 32):
                try:
                    ref = j_av._load_frames_video(path, n, size, window)
                except ValueError:
                    with pytest.raises(ValueError):
                        native.load_video_frames(path, n, size, window)
                    continue
                got = native.load_video_frames(path, n, size, window)
                assert got.shape == ref.shape and got.dtype == np.float32
                worst = max(worst, float(np.abs(got - ref).max()))
    for window in WINDOWS[:3]:
        ref = j_av.load_frames_for(stem, 16, 64, window)
        got = av.load_frames_for(stem, 16, 64, window)
        worst = max(worst, float(np.abs(got - ref).max()))
    print(f"{name}: max |Δ| {worst * 255:.3f} / 255")
    assert worst <= TOL[mk.codec_of(name)] / 255


@pytest.mark.parametrize("name", CASES)
def test_committed_decodes_are_cv2s(name):
    """The .npz chip_smoke.py holds the card's build against: cv2's frames,
    count and orientation now, and the port's."""
    ref = np.load(os.path.join(mk.FIXTURES, name + ".npz"))
    frames, count = mk.cv2_view(FILES[name])
    assert int(ref["n"]) == len(frames) and int(ref["count"]) == count
    assert int(ref["orientation"]) == \
        int(_cv2_info(FILES[name])["ORIENTATION_META"]) == \
        native.video_track(FILES[name], packets=False).orientation
    np.testing.assert_array_equal(ref["frames"], frames[ref["index"]])
    got = native.decode_video(FILES[name])
    assert got.shape[0] == int(ref["n"])
    assert np.abs(got[ref["index"]].astype(int) - ref["frames"]).max() <= \
        TOL[mk.codec_of(name)]


# ---- display orientation (MP4 and Matroska) ---------------------------------

@pytest.mark.parametrize("name", sorted(TURNED))
def test_turned_clips_match_cv2_exactly(name):
    """tkhd's and mvhd's matrices (and their product) and Matroska's roll
    turn the picture as cv2 does: decode_video equals cap.read(), and
    load_video_frames the JAX package's frames, at 0 levels; the frames
    are the unturned stream's, turned by np.rot90."""
    path = FILES[name]
    got = native.decode_video(path)
    np.testing.assert_array_equal(got, mk.cv2_view(path)[0])
    for window in (None, (0, 1), (0.2, 0.7)):
        np.testing.assert_array_equal(
            native.load_video_frames(path, 8, 32, window),
            j_av._load_frames_video(path, 8, 32, window))
    plain = native.decode_video(mk.path_of(
        "mpeg4_avi" if name.startswith("mpeg4") else "vp8_webm"))
    np.testing.assert_array_equal(
        got, np.rot90(plain, -TURNED[name] // 90, axes=(1, 2)))
    assert native.video_track(path).orientation == TURNED[name]


@pytest.mark.parametrize("degrees", [45, -45, 89.6, 90.4, 135, 179.6, 225,
                                     269.5, 359.6])
def test_mp4_angles_cv2_rounds_or_leaves(tmp_path, degrees):
    """cv2's angle is −round(av_display_rotation_get) in 0..359: within
    half a degree of 90, 180 or 270 it turns the picture; at any other
    angle it reports the angle and leaves the picture as it is."""
    pk, keys, (w, h), esds, _ = mk.container_packets("mpeg4")
    path = tmp_path / "x.mp4"
    path.write_bytes(mk.mp4_file(pk[:12], w, h, 25, b"mp4v", esds,
                                 sync=[0], matrix=mk.display_matrix(degrees)))
    track, info, dec, load = _held(str(path))
    print(degrees, track.orientation)
    assert dec == 0 and load == 0.0


@pytest.mark.parametrize("mirror", ["h", "v", "t"])
def test_mp4_mirror_raises_naming_it(tmp_path, mirror):
    """A display matrix with a mirror raises: cv2 turns such a picture
    (by 180 degrees for a horizontal mirror, 90 for the transpose, not at
    all for a vertical one) instead of mirroring it. A mirror in both
    tkhd and mvhd is no mirror, and reads."""
    pk, keys, (w, h), esds, _ = mk.container_packets("mpeg4")
    m = mk.display_matrix(mirror=mirror)
    for where in ("matrix", "movie_matrix"):
        path = tmp_path / f"{where}.mp4"
        path.write_bytes(mk.mp4_file(pk[:12], w, h, 25, b"mp4v", esds,
                                     sync=[0], **{where: m}))
        with pytest.raises(NotImplementedError,
                           match="display matrix with a mirror"):
            native.decode_video(str(path))
        with pytest.raises(NotImplementedError,
                           match="display matrix with a mirror"):
            native.load_video_frames(str(path), 8, 32)
    both = tmp_path / "both.mp4"
    both.write_bytes(mk.mp4_file(pk[:12], w, h, 25, b"mp4v", esds, sync=[0],
                                 matrix=m, movie_matrix=m))
    track, info, dec, load = _held(str(both))
    assert track.orientation == 0 and dec == 0 and load == 0.0


def test_mp4_matrix_without_angle_raises(tmp_path):
    pk, keys, (w, h), esds, _ = mk.container_packets("mpeg4")
    path = tmp_path / "x.mp4"
    path.write_bytes(mk.mp4_file(pk[:12], w, h, 25, b"mp4v", esds, sync=[0],
                                 matrix=(0, 0x10000, 0, 0, 0x10000, 0, 0, 0,
                                         0x40000000)))
    with pytest.raises(NotImplementedError, match="zero column"):
        native.video_track(str(path))


@pytest.mark.parametrize("projection", [
    dict(roll=270), dict(roll=45), dict(roll=-89.6), dict(type=0, yaw=90),
    dict(type=0, pitch=10, roll=90), dict(type=1, roll=90),
    dict(type=3, roll=90), dict(type=0)])
def test_matroska_projections_as_cv2(tmp_path, projection):
    """libavformat turns a rectangular projection by its roll alone; with
    a pitch or another yaw, and for the spherical types (equirectangular,
    mesh), it gives no display matrix and cv2 the picture as coded."""
    pk, keys, (w, h), _, _ = mk.container_packets("vp8")
    path = tmp_path / "x.mkv"
    path.write_bytes(mk.mkv_file(pk, w, h, 25, "V_VP8",
                                 projection=projection))
    track, info, dec, load = _held(str(path))
    assert dec == 0 and load == 0.0


@pytest.mark.parametrize("projection,feature", [
    (dict(type=0, yaw=180), "projection with a mirror"),
    (dict(type=0, yaw=-180, roll=90), "projection with a mirror"),
    (dict(type=2, roll=90), "cubemap projection")])
def test_matroska_projections_not_read_raise(tmp_path, projection, feature):
    """A yaw of 180 degrees mirrors the picture (cv2 turns it instead); a
    cubemap lays out six faces (cv2 opens none without its layout)."""
    pk, keys, (w, h), _, _ = mk.container_packets("vp8")
    path = tmp_path / "x.mkv"
    path.write_bytes(mk.mkv_file(pk, w, h, 25, "V_VP8",
                                 projection=projection))
    with pytest.raises(NotImplementedError, match=re.escape(feature)):
        native.decode_video(str(path))
    with pytest.raises(NotImplementedError, match=re.escape(feature)):
        native.load_video_frames(str(path), 8, 32)


# ---- fragmented MP4 ---------------------------------------------------------

def _h264():
    pk, keys, (w, h), avcc, times = mk.container_packets("h264")
    dts0 = times[0][1]
    return pk, keys, (w, h), avcc, [p - d for p, d in times], \
        [p - (d - dts0) for p, d in times], -dts0


def _shift_tfdt(data: bytes, track_id: int, delta: int) -> bytes:
    """`data` with the tfdt of every fragment of `track_id` moved by
    `delta`."""
    out = bytearray(data)
    at = 0
    while (at := out.find(b"tfhd", at + 1)) >= 0:
        if struct.unpack_from(">I", out, at + 8)[0] == track_id:
            t = out.find(b"tfdt", at)
            v = struct.unpack_from(">Q", out, t + 8)[0]
            struct.pack_into(">Q", out, t + 8, v + delta)
    return bytes(out)


def _set_mdhd(data: bytes, durations) -> bytes:
    out = bytearray(data)
    at = 0
    for d in durations:
        at = out.find(b"mdhd", at + 1)
        struct.pack_into(">I", out, at + 20, d)
    return bytes(out)


FRAGMENT_COUNTS = {
    # name: (stream, mp4_file's options, a patch of the bytes)
    "tfdt +5": ("mpeg4", dict(), lambda d: _shift_tfdt(d, 1, 5)),
    "video +5, audio at 0": ("mpeg4", dict(audio="pcm"),
                             lambda d: _shift_tfdt(d, 2, 5)),
    "audio +0.2 s": ("mpeg4", dict(audio="pcm"),
                     lambda d: _shift_tfdt(d, 1, 1600)),
    "mdhd longer": ("mpeg4", dict(), lambda d: _set_mdhd(d, [50])),
    "mdhd shorter": ("mpeg4", dict(), lambda d: _set_mdhd(d, [10])),
    "audio mdhd longer": ("mpeg4", dict(audio="pcm after"),
                          lambda d: _set_mdhd(d, [0, 20000])),
    "negative offsets, audio": ("h264", dict(negative=True, audio="pcm"),
                                None),
    "positive offsets, audio": ("h264", dict(audio="pcm"), None),
    "positive offsets, no edit, audio": ("h264", dict(audio="pcm",
                                                      no_edit=True), None),
    "trimming edit, audio": ("h264", dict(audio="pcm", trim=5), None),
    "empty edit, negative offsets, AAC": ("h264", dict(
        negative=True, audio="aac", edits=[(3, -1, 0x10000),
                                           (30, 0, 0x10000)]), None),
    "one fragment a sample, AAC after": ("h264", dict(
        audio="aac after", per_sample=True), None),
    "moov samples, trimming edit": ("h264", dict(moov_samples=12, trim=5),
                                    None),
    "moov samples, ffmpeg's edit": ("h264", dict(moov_samples=12), None),
    "moov samples, an edit ending inside them": ("h264", dict(
        moov_samples=12, edits=[(6, "shift", 0x10000)]), None),
    "moov samples cut by an edit at a keyframe": ("mpeg4", dict(
        moov_samples=24, edits=[(6, 0, 0x10000)]), None),
    "several edits over fragments, audio": ("h264", dict(audio="pcm", edits=[
        (10, "shift", 0x10000), (20, 12, 0x10000)]), None),
    "an edit at rate 2 over fragments": ("h264", dict(edits=[
        (15, "shift", 0x20000)]), None),
}


@pytest.mark.parametrize("case", list(FRAGMENT_COUNTS))
def test_fragment_counts_and_frames_match_cv2(tmp_path, case):
    """cv2's count of a fragmented file: moov's sample count when its
    tables hold samples, else round(duration · fps) over every stream's
    span (tfdt, mdhd's duration, the edit list's shift, negative
    composition offsets, AAC's priming); libavformat drops no frame under
    an edit list over fragments, only moov's samples (mov_fix_index) when
    it holds some."""
    stream, opts, patch = FRAGMENT_COUNTS[case]
    opts = dict(opts)
    if stream == "mpeg4":
        pk, keys, (w, h), esds, _ = mk.container_packets("mpeg4")
        entry, extra = b"mp4v", dict()
    else:
        pk, keys, (w, h), esds, pos, neg, shift = _h264()
        entry = b"avc1"
        trim = opts.pop("trim", None)
        if opts.pop("negative", False):
            extra = dict(ctts=neg)
        elif opts.pop("no_edit", False):
            extra = dict(ctts=pos)
        elif trim:
            extra = dict(ctts=pos, edits=[(25, shift + trim, 0x10000)])
        else:
            extra = dict(ctts=pos, media_time=shift)
        if "edits" in opts:
            extra = dict(ctts=extra["ctts"], edits=[
                (d, shift if t == "shift" else t, r)
                for d, t, r in opts.pop("edits")])
    audio = opts.pop("audio", None)
    if audio:
        audio = (mk.aac_track(len(pk), 25, first=not audio.endswith("after"))
                 if audio.startswith("aac") else
                 mk.audio_track(len(pk), 25, 8000,
                                first=not audio.endswith("after")))
    moov = opts.pop("moov_samples", 0)
    starts = [k for k in keys if k >= moov] + [len(pk)]
    frags = [1] * (len(pk) - moov) if opts.pop("per_sample", False) else \
        [b - a for a, b in zip(starts, starts[1:])]
    data = mk.mp4_file(pk, w, h, 25, entry, esds, sync=keys, audio=audio,
                       fragments=frags, moov_samples=moov, **extra, **opts)
    path = tmp_path / "x.mp4"
    path.write_bytes(patch(data) if patch else data)
    track, info, dec, load = _held(str(path))
    print(f"{case}: count {track.count} of {len(pk)} samples")
    assert dec == 0 and load == 0.0


def test_fragments_that_overlap_are_broken(tmp_path):
    pk, keys, (w, h), esds, _ = mk.container_packets("mpeg4")
    data = mk.mp4_file(pk, w, h, 25, b"mp4v", esds, sync=keys,
                       fragments=[12, 12, 6])
    out = bytearray(data)
    t = out.find(b"tfdt", out.find(b"tfdt") + 1)     # the second fragment's
    struct.pack_into(">Q", out, t + 8, 6)
    path = tmp_path / "x.mp4"
    path.write_bytes(bytes(out))
    with pytest.raises(ValueError, match="begins before the one before"):
        native.video_track(str(path))


def _fragments_patched(tmp_path, fn) -> str:
    pk, keys, (w, h), esds, _ = mk.container_packets("mpeg4")
    data = mk.mp4_file(pk, w, h, 25, b"mp4v", esds, sync=keys,
                       fragments=[12, 12, 6])
    path = tmp_path / "x.mp4"
    path.write_bytes(fn(bytearray(data)))
    return str(path)


def test_fragment_features_not_read_raise(tmp_path):
    """A second trun without its data offset: libavformat starts it at the
    base again (the standard: after the run before), and the port's
    packets are those bytes, as cv2's, while decoding raises; a fragment
    of a sample description the file lacks raises; a fragmented file with
    a timecode track beside the video counts as cv2 counts it."""
    def two_runs(d):
        # The first fragment's trun split into two of 6, the second
        # without its data offset.
        at = d.find(b"trun")
        size = struct.unpack_from(">I", d, at - 4)[0]
        flags = struct.unpack_from(">I", d, at + 4)[0]
        body = bytes(d[at + 8:at - 4 + size])
        n = struct.unpack_from(">I", body)[0]
        off = body[4:8]
        rest = body[8:]
        first = rest[:4] if flags & 0x004 else b""
        entries = rest[len(first):]
        w = len(entries) // n
        run1 = struct.pack(">II", flags, 6) + off + first + entries[:6 * w]
        run2 = struct.pack(">II", flags & ~0x005, n - 6) + entries[6 * w:]
        new = mk._box(b"trun", run1) + mk._box(b"trun", run2)
        grow = len(new) - size
        d[at - 4:at - 4 + size] = new
        # the traf's and moof's sizes, and the data offset
        for box in (b"traf", b"moof"):
            b = d.rfind(box, 0, at)
            struct.pack_into(">I", d, b - 4,
                             struct.unpack_from(">I", d, b - 4)[0] + grow)
        struct.pack_into(">i", d, at + 12,
                         struct.unpack_from(">i", d, at + 12)[0] + grow)
        return bytes(d)

    path = _fragments_patched(tmp_path, two_runs)
    track = native.video_track(path)
    assert [p for p, _ in track.packets] == mk.cv2_packets(path)
    with pytest.raises(NotImplementedError,
                       match="without its data offset after another"):
        native.decode_video(path)

    def description(d):
        at = d.find(b"tfhd")
        flags = struct.unpack_from(">I", d, at + 4)[0]
        body = d[at + 8:at + 12] + struct.pack(">I", 2) + d[at + 12:
                                                            at + 20]
        d[at - 4:at + 20] = mk._full_box(b"tfhd", flags | 0x02, bytes(body))
        for box in (b"traf", b"moof"):
            b = d.rfind(box, 0, at)
            struct.pack_into(">I", d, b - 4,
                             struct.unpack_from(">I", d, b - 4)[0] + 4)
        t = d.find(b"trun", at)
        struct.pack_into(">i", d, t + 12,
                         struct.unpack_from(">i", d, t + 12)[0] + 4)
        return bytes(d)

    with pytest.raises(NotImplementedError, match="sample description 2"):
        native.video_track(_fragments_patched(tmp_path, description))

    pk, keys, (w, h), esds, _ = mk.container_packets("mpeg4")
    data = mk.mp4_file(pk, w, h, 25, b"mp4v", esds, sync=keys,
                       fragments=[12, 12, 6],
                       audio=mk.audio_track(len(pk), 25, 8000, first=False))
    path = tmp_path / "tmcd.mp4"
    path.write_bytes(data.replace(b"soun", b"tmcd", 1))
    assert native.video_track(str(path)).count == \
        _cv2_info(str(path))["FRAME_COUNT"]


# ---- Matroska without DefaultDuration ---------------------------------------

def _nodd(tmp_path, times, codec="vp8", duration=None):
    if codec == "vp8":
        pk = mk.cv2_packets(mk.path_of("vp8_long_webm"))
        cid, private = "V_VP8", b""
    elif codec == "vp9":
        pk = mk.cv2_packets(mk.path_of("vp9_webm"))
        cid, private = "V_VP9", b""
    elif codec == "mjpeg":
        pk = mk.cv2_packets(mk.path_of("mjpeg_avi"))
        cid, private = "V_MJPEG", b""
    elif codec == "h264":
        pk, keys, _, avcc, _, _, _ = _h264()
        cid, private = "V_MPEG4/ISO/AVC", avcc[8:]
    else:
        pk = mk.cv2_packets(mk.path_of("mpeg4_avi"))
        cid, private = "V_MPEG4/ISO/ASP", mk.mpeg4_headers(pk[0])
    path = tmp_path / f"{codec}.mkv"
    path.write_bytes(mk.mkv_file(
        pk[:len(times)], mk.W, mk.H, 25, cid, private, default_duration=False,
        times=times, cluster=10,
        duration=float(times[-1] + 40) if duration is None else duration))
    return str(path)


@pytest.mark.parametrize("seed", range(24))
def test_matroska_rates_without_default_duration_match_cv2(tmp_path, seed):
    """libavformat's rate from block times (ff_rfps_add_frame over the
    first 40 durations, then ff_rfps_calculate): constant rates, rounded
    to 1 ms, with jitter, dropped frames or an offset start, each gives
    cv2's count and frames; where cv2 falls back to the time base (1000
    fps), the port raises."""
    rng = np.random.default_rng(seed)
    rates = [25, 30000 / 1001, 30, 24000 / 1001, 15, 24, 60, 50, 12.5, 10,
             5, 8, 60000 / 1001, 20, 23.5, 7.5]
    fps = rates[seed % len(rates)]
    n = int(rng.integers(8, 41))
    t = np.arange(n) * 1000 / fps
    kind = seed % 4
    if kind == 1:
        t = t + rng.integers(-2, 3, n)
    if kind == 2:
        keep = rng.random(n) > 0.15
        keep[0] = True
        t = t[keep]
    t = np.maximum.accumulate(np.maximum(np.round(t), 0).astype(int))
    start = int(rng.integers(1, 400)) if kind == 3 else 0
    t = [int(x) + start for x in t]
    path = _nodd(tmp_path, t, duration=float(t[-1] + 1000 / fps))
    info = _cv2_info(path)
    if info["FPS"] == 1000:
        with pytest.raises(NotImplementedError, match="variable frame rate"):
            native.video_track(path)
        return
    track, info, dec, load = _held(path)
    print(f"fps {fps:.3f}: cv2 {info['FPS']}, count {track.count} of {len(t)}")
    assert dec == 0 and load == 0.0


def test_matroska_rate_is_read_from_the_first_40_durations(tmp_path):
    """Regular 29.97 fps block times for 41 frames, irregular after them:
    libavformat stops counting at 40 durations, so cv2 settles on 29.97
    and the port with it."""
    rng = np.random.default_rng(3)
    t = [int(round(i * 1000 / (30000 / 1001))) for i in range(41)]
    while len(t) < 40 + 19:
        t.append(t[-1] + int(rng.integers(20, 90)))
    pk = mk.cv2_packets(mk.path_of("vp8_long_webm")) * 2
    path = tmp_path / "x.mkv"
    path.write_bytes(mk.mkv_file(pk[:len(t)], mk.W, mk.H, 25, "V_VP8",
                                 default_duration=False, times=t,
                                 duration=float(t[-1] + 33), cluster=15))
    info = _cv2_info(str(path))
    assert abs(info["FPS"] - 30000 / 1001) < 1e-9
    assert native.video_track(str(path)).count == int(info["FRAME_COUNT"])


@pytest.mark.parametrize("codec", ["vp9", "mjpeg"])
def test_matroska_without_default_duration_other_codecs(tmp_path, codec):
    """VP9 and MJPEG carry no rate of their own either: the blocks' times
    give it, as for VP8."""
    t = [int(round(i * 1000 / (30000 / 1001))) for i in range(20)]
    track, info, dec, load = _held(_nodd(tmp_path, t, codec))
    assert abs(info["FPS"] - 30000 / 1001) < 1e-9
    assert dec <= TOL[codec] and load <= TOL[codec] / 255


def test_variable_rate_without_default_duration_raises(tmp_path):
    """Trap (m): at a variable rate libavformat settles on no standard
    rate and falls back to the time base, so cv2 counts ~1000 frames a
    second and the JAX package reads frame 0 for every pick. The port
    raises naming it."""
    rng = np.random.default_rng(1)
    t = [0]
    for _ in range(19):
        t.append(t[-1] + int(rng.integers(33, 67)))
    path = _nodd(tmp_path, t)
    info = _cv2_info(path)
    assert info["FPS"] == 1000 and info["FRAME_COUNT"] > 500
    frames = j_av._load_frames_video(path, 8, 32, None)
    assert np.abs(frames - frames[:1]).max() == 0      # frame 0 eight times
    for fn in (native.video_track, native.decode_video):
        with pytest.raises(NotImplementedError,
                           match="without DefaultDuration at a variable "
                                 "frame rate"):
            fn(path)
    with pytest.raises(NotImplementedError, match="variable frame rate"):
        native.load_video_frames(path, 8, 32)


@pytest.mark.parametrize("codec,name", [("h264", "H.264"),
                                        ("mpeg4", "MPEG-4 Part 2")])
def test_matroska_codecs_timing_their_own_rate_raise(tmp_path, codec, name):
    """H.264 (its VUI timing) and MPEG-4 Part 2 (its VOL's) give cv2 their
    own rate when the container gives none: at 30 fps block times cv2
    reads these streams' 25 and counts 25 of 30 frames. The port counts
    as cv2 does."""
    t = [int(round(i * 1000 / 30)) for i in range(30)]
    path = _nodd(tmp_path, t, codec)
    info = _cv2_info(path)
    assert info["FPS"] == 25 and int(info["FRAME_COUNT"]) == 25
    assert native.video_track(path).count == 25, name


def test_matroska_without_duration_still_raises(tmp_path):
    """Trap (j): without the segment's Duration cv2 counts nonsense and the
    JAX package reads frame 0 only; the port raises, DefaultDuration or
    not."""
    pk = mk.cv2_packets(mk.path_of("vp8_webm"))
    data = mk.mkv_file(pk, mk.W, mk.H, 25, "V_VP8", default_duration=False)
    dur = mk._ebml(0x4489, struct.pack(">d", float(20 * 40)))
    path = tmp_path / "x.mkv"
    path.write_bytes(data.replace(dur, mk._ebml(0xEC, bytes(len(dur) - 2))))
    with pytest.raises(NotImplementedError, match="without a Duration"):
        native.video_track(str(path))


# ---- the fixture script and the folder datasets -----------------------------

def test_fixture_script_rewrites_the_committed_files(tmp_path):
    """The muxers and encoders write the same bytes again (libx264 and
    libavcodec's aac on one thread; the Matroska files carry no UID)."""
    for name in ("mpeg4_rot270_mp4", "vp8_roll90_mkv", "mpeg4_fragbase_mp4",
                 "h264_fragneg_mp4", "vp8_nodd2997_mkv",
                 "mjpeg_odmlaudioafter_avi", "mpeg4_audio_mp4",
                 "vp8_audioafter_mkv", "clip_phone_mp4", "clip_frag_mp4"):
        path = mk.write_case(name, str(tmp_path))
        with open(path, "rb") as f, open(FILES[name], "rb") as g:
            assert f.read() == g.read(), name


@pytest.mark.parametrize("case", ["clip_phone_mp4", "clip_frag_mp4",
                                  "vp8_roll90_mkv", "mpeg4_audio_avi"])
def test_folder_datasets_read_video(tmp_path, case):
    """AVFolderDataset reads a clip's frames from its video file, turned
    and fragmented ones too."""
    from viai_tpu_torch.utils.visualizer import write_wav

    write_wav(str(tmp_path / "a.wav"),
              np.sin(np.arange(8000) / 5.0).astype(np.float32) * 0.3, 16000)
    ext = os.path.splitext(FILES[case])[1]
    shutil.copy(FILES[case], tmp_path / ("a" + ext))
    ds = av.AVFolderDataset(str(tmp_path), clip_samples=4000, n_frames=16,
                            frame_size=32)
    item, start, total = ds.load_cropped(0)
    got = ds[0]["frames"]
    ref = j_av.load_frames_for(str(tmp_path / "a"), 16, 32,
                               av._crop_window(start, 4000, total))
    np.testing.assert_array_equal(got, ref)
