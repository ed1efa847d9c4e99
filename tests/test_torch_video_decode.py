"""The port's compressed video reader (csrc/videodec.cpp, csrc/mpeg4.cpp,
csrc/vp8.cpp, csrc/vp9.cpp, csrc/h264.cpp through native.py) against cv2
and the JAX package's `_load_frames_video`.

The clips of tests/_torch_make_videos.py (committed in tests/torch_videos/:
MJPEG, MPEG-4 Part 2, VP8 and VP9 written by cv2's ffmpeg in AVI, MP4,
MOV, Matroska and WebM, at 72x56, 8, 25 and 29.97 fps; MJPEG hand-muxed
in MP4 under the mjpa and MJPG sample entries and VP8 under vp08; an AVI
of MJPEG without Huffman tables; an AVI whose headers count 17 of its 12
frames; cv2's VP8 with a hidden frame, versions 1-3 and an odd width
patched in; VP8 from libvpx's API with token partitions, sharpness,
segmentation, no entropy refresh, hidden alt-ref frames and profile 1;
VP9 from libvpx's API with backward adaptation, two-pass alt-ref
superframes and compound prediction, 2x2 tiles, AQ and ROI segmentation,
error-resilient frame-parallel coding, realtime speed 8, lossless, an
odd width, full range and BT.709; H.264 from libx264's API: Baseline
CAVLC in AVI, Main CAVLC with B-frames and temporal direct in Matroska,
High CABAC with B-pyramid, weighted prediction and the 8x8 transform in
MP4 (ctts and ffmpeg's edit list), the slower preset with 8 references
and 4x4 partitions, custom scaling matrices, 4 slices with deblocking
offsets and constrained intra, open GOP, intra refresh (High CAVLC),
full range with BT.709, I_PCM in CABAC and in CAVLC; MJPEG in the other
layouts libavcodec decodes (4:2:2, 4:4:4, 4:4:0, grey, limited range
under a CS=ITU601 comment) and at 72x55, libvpx's VP8 and VP9 at odd
heights (swscale's scaler), MJPEG 4:2:2 in an OpenDML AVI with a RIFF
AVIX, H.264 in MP4 under an edit that trims its first frames and under
an empty edit before one; MPEG-4 Advanced Simple Profile from libxvid
and libavcodec's mpeg4 encoder (B-VOPs packed and not, quarter-pel, GMC
by both of libavcodec's routes, 4MV, AC prediction, MPEG quantisation
with default and loaded matrices, video packets, data partitioning, XviD
and DivX user data; in AVI, MP4 and Matroska); the 224-wide clips
chip_smoke.py trains from or times) go through:

  * `native.video_track` against cv2's demuxed packets
    (`CAP_PROP_FORMAT = -1`), byte for byte (H.264 in MP4 and Matroska
    through the test's copy of libavcodec's h264_mp4toannexb, which cv2
    applies), its frame count against
    `CAP_PROP_FRAME_COUNT`, and its codec against the one the case's
    name says;
  * `native.decode_video` against `cap.read()`: the bound is 0 levels
    over every byte of every frame, for VP8 (exact by RFC 6386), VP9 and
    H.264 (exact by their specifications) and for MJPEG and MPEG-4, whose
    decoders compute what libavcodec and swscale compute (0 on every
    committed clip here, on the card and on random MPEG-4 streams:
    tests/_torch_video_sweep.py);
  * `native.load_video_frames` and the port's `data.av.load_frames_for`
    against the JAX package's over several windows at 16 frames and at
    40 (more than any clip has: the `set` case), sizes 64 and 32: the
    bound over 255 on the [0, 1] frames; measured maximum 0 (MPEG-4
    with B-VOPs read from its first packet, in output order);
  * the committed `<case>.npz` (what chip_smoke.py holds the card's
    build against) against cv2 now;
  * a stem with both `.mp4` and `.avi` reads the `.mp4`, as the JAX
    package does;
  * against cv2 live: MJPEG of each layout, VP8 and VP9 keyframes
    patched to an odd height, OpenDML files whose strh, avih and dmlh
    counts disagree (cv2 takes strh's), and MP4 edits that drop frames
    at either end, after an empty edit or at media times before the
    first presented sample;
  * MPEG-4 features that used to raise, decoded against cv2 on the same
    patched stream (MPEG quantisation, quarter-pel and video packets in
    the VOL, AC prediction, XviD and DivX user data, two VOPs in one
    packet) or the encoders' own (B-VOPs, GMC, data partitioning);
  * NotImplementedError naming the codec for AV1 and FFV1 in MP4 (their
    fourccs put into a clip's header; FFV1 in AVI, which is read, raises
    ValueError for the MPEG-4 bytes under its tag) and HEVC's 4:2:2 (x265's SPS
    patched; what else HEVC leaves unread:
    tests/test_torch_video_hevc.py), naming each MPEG-4 feature
    not read that a patched header or macroblock flag can show (interlace
    also from libavcodec's own interlaced stream; RVLC), each VP8 feature
    libvpx does not write (frame headers written here by a boolean
    encoder), each VP9 colour config libavcodec refuses (sRGB in
    profiles 0 and 2, 4:2:0 signalled in profiles 1 and 3 at 8 and 12
    bits, also in an intra-only frame) and
    a reference outside the scaling range (patched or written headers;
    what browsers write is read: test_torch_video_browser.py), a VP8
    vpcC box of another bit depth, and each H.264
    feature the decoder does not read (libx264's own MBAFF streams in
    every format, and frames its picture timing SEI flags interlaced;
    parameter sets, slice headers and NAL units patched bit by bit for
    the rest; what cameras write beside them is read and held in
    test_torch_video_camera.py, what ffmpeg writes from images and
    screens in test_torch_video_screen.py), MJPEG field pairs and mixed sampling
    ratios, and MP4 edit
    lists of several edits, another rate or a zero duration; ValueError
    for a broken file and for a window past the clip's last frame, as the
    JAX package raises.
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

# levels of 255 at full size: VP8, VP9 and H.264 are exact by
# specification, MJPEG and MPEG-4 by copying libavcodec's arithmetic
TOL = {"mjpeg": 0, "mpeg4": 0, "vp8": 0, "vp9": 0, "h264": 0}
CASES = list(mk.DECODED)
FILES = {c: mk.path_of(c) for c in (*CASES, *mk.CLIP_CASES)}
ALL = [*CASES, *mk.CLIP_CASES]
WINDOWS = (None, (0.25, 0.75), (0.1, 0.9), (0.0, 0.3), (0.6, 1.0))


def _codec(name):
    return native.video_track(FILES[name], packets=False).codec


_mp4toannexb = mk.mp4toannexb


@pytest.mark.parametrize("name", ALL)
def test_packets_and_count_match_cv2(name):
    path = FILES[name]
    track = native.video_track(path)
    got = [p for p, _ in track.packets]
    if track.codec == "h264" and track.config:
        got = _mp4toannexb(track)
    assert got == mk.cv2_packets(path)
    cap = cv2.VideoCapture(path)
    assert track.count == int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    assert (track.width, track.height) == (
        int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
        int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)))
    assert track.codec == mk.codec_of(name)    # the one its name says
    assert track.packets[0][1]                 # the first is a keyframe


@pytest.mark.parametrize("name", ALL)
def test_decode_video_matches_cv2(name):
    path = FILES[name]
    got = native.decode_video(path)
    ref = np.stack(mk.cv2_view(path)[0])
    assert got.shape == ref.shape and got.dtype == np.uint8
    err = int(np.abs(got.astype(int) - ref).max())
    print(f"{name}: max |Δ| {err} over {ref.shape}")
    assert err <= TOL[_codec(name)]


@pytest.mark.parametrize("name", ALL)
def test_load_frames_match_jax(name):
    path = FILES[name]
    tol = TOL[_codec(name)] / 255
    stem, ext = os.path.splitext(path)
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
    if ext != ".mov":                   # load_frames_for does not look for .mov
        for window in WINDOWS[:3]:
            ref = j_av.load_frames_for(stem, 16, 64, window)
            got = av.load_frames_for(stem, 16, 64, window)
            worst = max(worst, float(np.abs(got - ref).max()))
    print(f"{name}: max |Δ| {worst * 255:.3f} / 255")
    assert worst <= tol


@pytest.mark.parametrize("name", CASES)
def test_committed_decodes_are_cv2s(name):
    ref = np.load(os.path.join(mk.FIXTURES, name + ".npz"))
    frames, count = mk.cv2_view(FILES[name])
    assert int(ref["n"]) == len(frames) and int(ref["count"]) == count
    np.testing.assert_array_equal(ref["frames"], frames[ref["index"]])
    got = native.decode_video(FILES[name])
    assert got.shape[0] == int(ref["n"])
    assert np.abs(got[ref["index"]].astype(int) - ref["frames"]).max() <= \
        TOL[_codec(name)]


def test_layout_order_reads_mp4_before_avi(tmp_path):
    stem = str(tmp_path / "clip")
    shutil.copy(FILES["mpeg4_mp4"], stem + ".mp4")
    shutil.copy(FILES["mjpeg_avi"], stem + ".avi")
    ref = j_av.load_frames_for(stem, 16, 64, (0.2, 0.8))
    got = av.load_frames_for(stem, 16, 64, (0.2, 0.8))
    np.testing.assert_array_equal(got, ref)
    avi = native.load_video_frames(stem + ".avi", 16, 64, (0.2, 0.8))
    assert np.abs(avi - got).max() > 0.1       # the two files differ


@pytest.mark.parametrize("case", ["mpeg4_mkv", "vp8_webm", "vp9_mp4",
                                  "h264_high_mp4", "mjpeg_odml_avi",
                                  "h264_trim_mp4"])
def test_folder_datasets_read_video(tmp_path, case):
    """AVFolderDataset reads a clip's frames from its video file."""
    from viai_tpu_torch.data.audio import AudioFolderDataset
    from viai_tpu_torch.utils.visualizer import write_wav

    write_wav(str(tmp_path / "a.wav"),
              np.sin(np.arange(8000) / 5.0).astype(np.float32) * 0.3, 16000)
    ext = os.path.splitext(FILES[case])[1]
    shutil.copy(FILES[case], tmp_path / ("a" + ext))
    ds = av.AVFolderDataset(str(tmp_path), clip_samples=4000, n_frames=16,
                            frame_size=32)
    assert isinstance(ds, AudioFolderDataset)
    item, start, total = ds.load_cropped(0)
    got = ds[0]["frames"]
    ref = j_av.load_frames_for(str(tmp_path / "a"), 16, 32,
                               av._crop_window(start, 4000, total))
    np.testing.assert_array_equal(got, ref)


# ---- what is not read ---------------------------------------------------

def _patched(src, dst, old: bytes, new: bytes, count=1):
    data = open(src, "rb").read()
    assert data.count(old) >= 1
    with open(dst, "wb") as f:
        f.write(data.replace(old, new, count))
    return str(dst)


def _hevc_422(path: str) -> tuple[bytes, bytes]:
    """The SPS of an x265 file and the same with chroma_format_idc 2
    (4:2:2, a RExt sampling) for its 1: ue(1) "010" becomes ue(2) "011"
    after sps_seq_parameter_set_id ue(0) (same length, no new emulation
    prevention)."""
    data = open(path, "rb").read()
    at = data.index(b"\x42\x01")                # nal_unit_type 33, TID 0
    sps = mk.nal_units(b"\0\0\1" + data[at:at + 64])[0][:40]
    bits = "".join(f"{b:08b}" for b in mk.hevc_rbsp(sps))
    k = 4 + 3 + 1 + 96                           # after profile_tier_level
    assert bits[k:k + 4] == "1010"
    bits = bits[:k + 3] + "1" + bits[k + 4:]
    new = sps[:1] + mk.nal_unit(sps[1], bits)[:len(sps) - 1]
    assert len(new) == len(sps) and new != sps
    return sps, new


@pytest.mark.parametrize("fourcc,name", [
    (b"HEVC", "HEVC"), (b"AV01", "AV1"), (b"FFV1", "FFV1")])
def test_unread_codecs_raise_naming_them(tmp_path, fourcc, name):
    """Codecs that are not read, and HEVC as it is not read (4:2:2, a RExt
    sampling: x265's SPS patched, in AVI and in an hvc1 MP4's hvcC)."""
    if fourcc == b"HEVC":
        avi, mp4 = (mk.path_of(c) for c in ("hevc_slices_avi",
                                            "hevc_default_mp4"))
        avi = _patched(avi, tmp_path / "x.avi", *_hevc_422(avi))
        mp4 = _patched(mp4, tmp_path / "x.mp4", *_hevc_422(mp4))
        name = "HEVC 4:2:2"
    else:
        tag = native.video_track(FILES["mpeg4_avi"],
                                 packets=False).tag.encode()
        avi = _patched(FILES["mpeg4_avi"], tmp_path / "x.avi", tag, fourcc,
                       count=2)
        mp4 = _patched(FILES["mpeg4_mp4"], tmp_path / "x.mp4", b"mp4v",
                       {b"AV01": b"av01", b"FFV1": b"FFV1"}[fourcc])
    for path in (avi, mp4):
        # FFV1 is read (csrc/ffv1.cpp; in MP4 under its FFV1 sample entry
        # since cv2's writer stores it there): MPEG-4 bytes under its tag
        # are a broken FFV1 stream.
        error = ValueError if fourcc == b"FFV1" else NotImplementedError
        with pytest.raises(error, match=re.escape(name)):
            native.decode_video(path)
        with pytest.raises(error, match=re.escape(name)):
            native.load_video_frames(path, 16, 64)


def test_vp9_webm_raises_naming_vp9(tmp_path):
    """cv2's VP9 webm with its keyframes' colour space patched to sRGB,
    which profile 0 cannot carry (libavcodec refuses it; every profile
    is read since the VP9 of browsers): the feature is named."""
    data = bytearray(open(FILES["vp9_webm"], "rb").read())
    for p, key in native.video_track(FILES["vp9_webm"]).packets:
        if key:
            at = bytes(data).index(p)
            data[at:at + len(p)] = _set_bits(p, 32, 3, 7)
    path = tmp_path / "x.webm"
    path.write_bytes(bytes(data))
    assert native.video_track(str(path)).tag == "V_VP9"
    with pytest.raises(NotImplementedError,
                       match="VP9 colour space sRGB in profile 0"):
        native.decode_video(str(path))
    with pytest.raises(NotImplementedError,
                       match="VP9 colour space sRGB in profile 0"):
        av.load_frames_for(str(tmp_path / "x"), 16, 64)


def test_vp8_in_mp4_raises_naming_it(tmp_path):
    """VP8 in MP4 is read (the vp8_mp4 case); a vpcC box of another bit
    depth raises naming the codec and the depth."""
    mp4 = _patched(FILES["vp8_mp4"], tmp_path / "x.mp4",
                   bytes(mk.vpcc_box()), bytes(mk.vpcc_box(depth=10)))
    with pytest.raises(NotImplementedError, match="VP8 profile 0 .10-bit"):
        native.decode_video(mp4)
    assert native.decode_video(FILES["vp8_mp4"]).shape[0] == 20


@pytest.mark.parametrize("entry", ["avi vp90", "mp4 vp09"])
def test_vp9_sample_entries_decode_as_cv2(tmp_path, entry):
    """cv2's VP9 packets under a lower-case AVI fourcc (libavformat
    upper-cases riff tags) and hand-muxed under an MP4 vp09 entry with
    its vpcC box: cv2's frames, exactly."""
    pk = _vp9_packets("vp9_avi")
    if entry.startswith("avi"):
        path = tmp_path / "x.avi"
        path.write_bytes(mk.avi_file(pk, mk.W, mk.H, 25, len(pk), b"vp90"))
    else:
        path = tmp_path / "x.mp4"
        path.write_bytes(mk.mp4_file(pk, mk.W, mk.H, 25, b"vp09",
                                     mk.vpcc_box()))
    ref, count = mk.cv2_view(str(path))
    assert native.video_track(str(path)).count == count == len(pk)
    np.testing.assert_array_equal(native.decode_video(str(path)), ref)


# ---- VP9 features that are not read, and show_existing_frame ------------

def _vp9_packets(name):
    return [p for p, _ in native.video_track(FILES[name]).packets]


_set_bits = mk.set_bits
_vp9_header = mk.vp9_header


def _vp9_avi(tmp_path, packets, h=mk.H):
    path = tmp_path / "vp9.avi"
    path.write_bytes(mk.avi_file(packets, mk.W, h, 25, len(packets), b"VP90"))
    return str(path)


def _vp9_colour(packet: bytes, profile: int, fields) -> bytes:
    """A profile 0 keyframe's header with its profile and colour config
    (bits 32-35) rewritten: `fields`, (value, bits) pairs written after
    the sync code, then the original header from its frame size on
    (what follows no longer lines up: the decoder raises first)."""
    bits = "".join(f"{b:08b}" for b in packet)
    head = "10" + format(profile & 1, "b") + format(profile >> 1, "b")
    head += "0" if profile == 3 else ""              # reserved
    head += bits[4:32] + "".join(format(v, f"0{n}b") for v, n in fields)
    bits = head + bits[36:]
    bits += "0" * (-len(bits) % 8)
    return bytes(int(bits[k:k + 8], 2) for k in range(0, len(bits), 8))


# A keyframe's header bits: marker 2, profile 2, show_existing 1, type,
# show, error_resilient 3, sync code 24, then the colour config at bit 32
# (profiles 2 and 3: a bit depth bit first; 1 and 3: sampling after the
# range, sRGB with a reserved bit): what every profile carries is read,
# what libavcodec refuses raises.
@pytest.mark.parametrize("feature,profile,patch", [
    ("VP9 profile 1 with 4:2:0 sampling", 1,
     [(0, 3), (0, 1), (1, 1), (1, 1), (0, 1)]),
    ("VP9 profile 3 with 4:2:0 sampling", 3,
     [(0, 1), (2, 3), (0, 1), (1, 1), (1, 1), (0, 1)]),
    ("4:2:0 sampling (libavcodec refuses it)", 3,
     [(1, 1), (0, 3), (0, 1), (1, 1), (1, 1), (0, 1)]),
    ("VP9 colour space sRGB in profile 2", 2, [(0, 1), (7, 3)]),
    ("VP9 colour space sRGB in profile 0", 0, [(7, 3), (0, 1)]),
])
def test_vp9_keyframe_features_raise_naming_them(tmp_path, feature, profile,
                                                 patch):
    pk = _vp9_packets("vp9_avi")
    pk[0] = _vp9_colour(pk[0], profile, patch)
    path = _vp9_avi(tmp_path, pk)
    with pytest.raises(NotImplementedError, match=re.escape(feature)):
        native.decode_video(path)
    with pytest.raises(NotImplementedError, match=re.escape(feature)):
        native.load_video_frames(path, 4, 32)


def test_vp9_odd_height_matches_cv2(tmp_path):
    """cv2's VP9 keyframes (frame_type 0) patched to 55 of their 56
    lines: the odd height goes through swscale's scaler, as cv2 converts
    it."""
    pk = [_set_bits(p, 52, 16, mk.H - 2) if not (p[0] >> 2) & 1 else p
          for p in _vp9_packets("vp9_avi")]
    assert sum(not (p[0] >> 2) & 1 for p in pk) == 2
    path = _vp9_avi(tmp_path, pk, mk.H - 1)
    ref, count = mk.cv2_view(path)
    assert ref.shape[1:3] == (mk.H - 1, mk.W)
    np.testing.assert_array_equal(native.decode_video(path), ref)
    np.testing.assert_array_equal(native.load_video_frames(path, 4, 32),
                                  j_av._load_frames_video(path, 4, 32, None))


@pytest.mark.parametrize("feature", [
    "VP9 reference scaling beyond its range",
    "VP9 profile 1 with 4:2:0 sampling"])
def test_vp9_inter_header_features_raise_naming_them(tmp_path, feature):
    """A frame written after cv2's keyframe: an inter frame a third of
    its references' size (reference scaling reaches half of it), and a
    hidden intra-only frame of profile 1 whose colour config signals
    4:2:0 (libavcodec refuses both; reference scaling and intra-only
    frames are read: tests/test_torch_video_browser.py)."""
    if "scaling" in feature:
        frame = _vp9_header((2, 2), (0, 2), (0, 1), (1, 1), (1, 1), (0, 1),
                            (0, 2), (0, 8), *[(0, 4)] * 3, (0, 3),
                            (mk.W // 3 - 1, 16), (mk.H // 3 - 1, 16))
    else:
        frame = _vp9_header((2, 2), (1, 1), (0, 1), (0, 1), (1, 1), (0, 1),
                            (0, 1), (1, 1), (0, 2), (0x49, 8), (0x83, 8),
                            (0x42, 8), (0, 3), (0, 1), (1, 1), (1, 1),
                            (0, 1))
    path = _vp9_avi(tmp_path, [_vp9_packets("vp9_avi")[0], frame])
    with pytest.raises(NotImplementedError, match=re.escape(feature)):
        native.decode_video(path)


def test_vp9_show_existing_frame_matches_cv2(tmp_path):
    """One-byte packets with show_existing_frame (slots 0 and 7) put into
    cv2's stream: each shows its slot's frame again, as libavcodec does."""
    pk = _vp9_packets("vp9_avi")
    pk[5:5] = [bytes([0x88 | 0])]
    pk[12:12] = [bytes([0x88 | 7])]
    path = _vp9_avi(tmp_path, pk)
    ref, count = mk.cv2_view(path)
    assert len(ref) == count == len(pk)
    got = native.decode_video(path)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        native.load_video_frames(path, 8, 32),
        j_av._load_frames_video(path, 8, 32, None))


# ---- VP8 features libvpx does not write ----------------------------------

class _BoolEncoder:
    """RFC 6386 §7.3's boolean encoder."""

    def __init__(self):
        self.out, self.range, self.bottom, self.count = bytearray(), 255, 0, 24

    def put(self, bit, prob=128):
        split = 1 + (((self.range - 1) * prob) >> 8)
        if bit:
            self.bottom += split
            self.range -= split
        else:
            self.range = split
        while self.range < 128:
            self.range <<= 1
            if self.bottom & (1 << 31):             # carry
                i = len(self.out) - 1
                while self.out[i] == 255:
                    self.out[i] = 0
                    i -= 1
                self.out[i] += 1
            self.bottom = (self.bottom << 1) & 0xFFFFFFFF
            self.count -= 1
            if not self.count:
                self.out.append(self.bottom >> 24)
                self.bottom &= 0xFFFFFF
                self.count = 8

    def literal(self, v, n):
        for i in reversed(range(n)):
            self.put((v >> i) & 1)

    def flush(self) -> bytes:
        for _ in range(32):
            self.put(0)
        return bytes(self.out)


def _vp8_table(name: str) -> list[int]:
    """A probability table of vp8.cpp (RFC 6386's), flattened."""
    src = open(os.path.join(os.path.dirname(native.__file__), "csrc",
                            "vp8.cpp")).read()
    body = src.split(f" {name}[", 1)[1].split("= {", 1)[1].split("};")[0]
    return [int(v) for v in re.findall(r"\d+", re.sub(r"//.*", "", body))]


def _vp8_frame(key, color_space=0, clamping=0, segmentation=None,
               copy_golden=0, copy_alt=0, sign_golden=0, skip_flags=1):
    """A 72x56 VP8 frame whose header has the given fields (a keyframe or
    an inter frame refreshing nothing), each macroblock skipped and
    predicted DC_PRED (intra in an inter frame too)."""
    e = _BoolEncoder()
    if key:
        e.put(color_space)
        e.put(clamping)
    e.put(segmentation is not None)
    if segmentation is not None:
        update_map, absolute = segmentation
        e.put(update_map)
        e.put(1)                                    # update_segment_data
        e.put(absolute)
        for _ in range(8):
            e.put(0)
        for _ in range(3 * update_map):
            e.put(0)
    e.put(0)                                        # filter_type
    e.literal(20, 6)                                # loop_filter_level
    e.literal(0, 3)                                 # sharpness
    e.put(0)                                        # no mode/ref deltas
    e.literal(0, 2)                                 # one token partition
    e.literal(40, 7)                                # y_ac_qi
    for _ in range(5):
        e.put(0)                                    # no quantiser deltas
    if key:
        e.put(1)                                    # refresh_entropy_probs
    else:
        e.put(0)                                    # refresh_golden_frame
        e.put(0)                                    # refresh_alternate
        e.literal(copy_golden, 2)
        e.literal(copy_alt, 2)
        e.put(sign_golden)
        e.put(0)                                    # sign_bias_alternate
        e.put(1)                                    # refresh_entropy_probs
        e.put(1)                                    # refresh_last
    for p in _vp8_table("kCoefUpdate"):
        e.put(0, p)
    e.put(skip_flags)                               # mb_no_coeff_skip
    if skip_flags:
        e.literal(200, 8)
    if not key:
        for v in (100, 128, 128):                   # intra, last, golden
            e.literal(v, 8)
        e.put(0)                                    # no 16x16 mode update
        e.put(0)                                    # no chroma mode update
        for p in _vp8_table("kMvUpdate"):
            e.put(0, p)
    for _ in range(((mk.W + 15) // 16) * ((mk.H + 15) // 16)):
        if skip_flags:
            e.put(1, 200)                           # skipped
        if key:
            for bit, p in ((1, 145), (0, 156), (0, 163), (0, 142)):
                e.put(bit, p)                       # DC_PRED, chroma DC
        else:
            for bit, p in ((0, 100), (0, 112), (0, 162)):
                e.put(bit, p)                       # intra, DC, chroma DC
    first = e.flush()
    tag = (0 if key else 1) | (1 << 4) | (len(first) << 5)
    head = struct.pack("<I", tag)[:3]
    if key:
        head += b"\x9d\x01\x2a" + struct.pack("<HH", mk.W, mk.H)
    return head + first + bytes(64)


def _vp8_avi(tmp_path, packets):
    path = tmp_path / "vp8.avi"
    path.write_bytes(mk.avi_file(packets, mk.W, mk.H, 25, len(packets),
                                 b"VP80"))
    return str(path)


def test_vp8_frame_writer_makes_frames_the_decoder_reads(tmp_path):
    """The header writer of the tests below: its plain keyframe and inter
    frame decode, to cv2's frames."""
    path = _vp8_avi(tmp_path, [_vp8_frame(True), _vp8_frame(False)])
    got = native.decode_video(path)
    ref = np.stack(mk.cv2_view(path)[0])
    assert got.shape == ref.shape == (2, mk.H, mk.W, 3)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("feature,key,fields", [
    ("VP8 colour space 1", True, dict(color_space=1)),
    ("VP8 clamping type 1", True, dict(clamping=1)),
    ("VP8 segment data in absolute values", True,
     dict(segmentation=(1, 1))),
    ("VP8 keyframe with segmentation that keeps an earlier frame's segment "
     "map", True, dict(segmentation=(0, 0))),
    ("VP8 golden frame copied from another reference", False,
     dict(copy_golden=1)),
    ("VP8 altref frame copied from the last frame", False, dict(copy_alt=1)),
    ("VP8 sign bias on the golden frame", False, dict(sign_golden=1)),
    ("VP8 without mb_no_coeff_skip", True, dict(skip_flags=0)),
])
def test_vp8_header_features_raise_naming_them(tmp_path, feature, key,
                                               fields):
    packets = [_vp8_frame(True)] * (not key) + [_vp8_frame(key, **fields)]
    path = _vp8_avi(tmp_path, packets)
    with pytest.raises(NotImplementedError, match=re.escape(feature)):
        native.decode_video(path)
    with pytest.raises(NotImplementedError, match=re.escape(feature)):
        native.load_video_frames(path, 4, 32)


def _vp8_packets(name):
    return [p for p, _ in native.video_track(FILES[name]).packets]


def test_vp8_reserved_version_raises(tmp_path):
    pk = [bytes([(p[0] & ~0x0E) | (4 << 1)]) + p[1:]
          for p in _vp8_packets("vp8_avi")]
    with pytest.raises(NotImplementedError, match="VP8 version 4"):
        native.decode_video(_vp8_avi(tmp_path, pk))


def test_vp8_odd_height_raises(tmp_path):
    """An odd coded height (55 of the 56 lines) patched into cv2's
    keyframes: no longer raised, but read through swscale's scaler as cv2
    converts it (libvpx's own odd-height stream: the vp8_oddh_avi
    case)."""
    pk = [p[:8] + struct.pack("<H", mk.H - 1) + p[10:] if not p[0] & 1
          else p for p in _vp8_packets("vp8_avi")]
    assert sum(not p[0] & 1 for p in pk) == 2
    path = str(tmp_path / "vp8.avi")
    with open(path, "wb") as f:         # the container's height too
        f.write(mk.avi_file(pk, mk.W, mk.H - 1, 25, len(pk), b"VP80"))
    ref, _ = mk.cv2_view(path)
    assert ref.shape[1:3] == (mk.H - 1, mk.W)
    np.testing.assert_array_equal(native.decode_video(path), ref)


def test_vp8_broken_frames_raise_value_error(tmp_path):
    pk = _vp8_packets("vp8_avi")
    for bad, why in ((pk[1:], "before the first keyframe"),
                     ([pk[0][:3] + b"\0\0\0" + pk[0][6:]], "start code"),
                     ([pk[0][:20]], "first partition runs past")):
        with pytest.raises(ValueError, match=why):
            native.decode_video(_vp8_avi(tmp_path, bad))


class _BitWriter:
    def __init__(self):
        self.bits = []

    def put(self, v, n):
        self.bits += [(v >> (n - 1 - i)) & 1 for i in range(n)]

    def stuffed(self) -> bytes:
        self.put(0, 1)
        while len(self.bits) % 8:
            self.put(1, 1)
        return bytes(int("".join(map(str, self.bits[i:i + 8])), 2)
                     for i in range(0, len(self.bits), 8))


def vol_header(width, height, res=25, verid=1, interlaced=0, obmc_disable=1,
               sprite=0, quant_type=0, quarter=0, estimation_disable=1,
               resync_disable=1, partitioned=0, rvlc=0, scalability=0):
    """A video object layer header as ffmpeg's encoder writes it, with
    one field changed."""
    b = _BitWriter()
    b.put(0x00000120, 32)
    b.put(0, 1)
    b.put(1, 8)
    b.put(1, 1)
    b.put(verid, 4)
    b.put(1, 3)
    b.put(1, 4)
    b.put(1, 1)
    b.put(1, 2)
    b.put(1, 1)
    b.put(0, 1)
    b.put(0, 2)
    b.put(1, 1)
    b.put(res, 16)
    b.put(1, 1)
    b.put(0, 1)
    b.put(1, 1)
    b.put(width, 13)
    b.put(1, 1)
    b.put(height, 13)
    b.put(1, 1)
    b.put(interlaced, 1)
    b.put(obmc_disable, 1)
    b.put(sprite, 1 if verid == 1 else 2)
    b.put(0, 1)
    b.put(quant_type, 1)
    if quant_type:
        b.put(0, 2)
    if verid != 1:
        b.put(quarter, 1)
    b.put(estimation_disable, 1)
    b.put(resync_disable, 1)
    b.put(partitioned, 1)
    if partitioned:
        b.put(rvlc, 1)
    if verid != 1:
        b.put(0, 2)
    b.put(scalability, 1)
    return b.stuffed()


def _mpeg4_packets():
    return [p for p, _ in native.video_track(FILES["mpeg4_avi"]).packets]


def _with_vol(pkt: bytes, vol: bytes) -> bytes:
    i = pkt.index(b"\x00\x00\x01\x20")
    j = pkt.index(b"\x00\x00\x01", i + 4)
    return pkt[:i] + vol + pkt[j:]


def _write(tmp_path, packets, name="x.avi"):
    path = tmp_path / name
    path.write_bytes(mk.avi_file(packets, mk.W, mk.H, 25, len(packets),
                                 b"FMP4"))
    return str(path)


def test_rewritten_vol_decodes_as_the_original(tmp_path):
    pk = _mpeg4_packets()
    pk[0] = _with_vol(pk[0], vol_header(mk.W, mk.H))
    np.testing.assert_array_equal(native.decode_video(_write(tmp_path, pk)),
                                  native.decode_video(FILES["mpeg4_avi"]))


def _flip_vop_bits(pkt: bytes, value: int, n: int, offset: int) -> bytes:
    """`pkt` with the n bits at `offset` bits after its VOP start code
    set to `value`."""
    i = pkt.index(b"\x00\x00\x01\xb6") + 4
    bits = "".join(f"{x:08b}" for x in pkt[i:i + 8])
    bits = bits[:offset] + format(value, f"0{n}b") + bits[offset + n:]
    return pkt[:i] + bytes(int(bits[k:k + 8], 2)
                           for k in range(0, 64, 8)) + pkt[i + 8:]


def _ac_pred_offset(pkt: bytes, time_bits: int = 5) -> int:
    """The bit of the first macroblock's ac_pred_flag in an I-VOP."""
    i = pkt.index(b"\x00\x00\x01\xb6") + 4
    bits = "".join(f"{x:08b}" for x in pkt[i:i + 16])
    k = 2
    while bits[k] == "1":
        k += 1
    k += 1 + 1 + time_bits + 1 + 1 + 3 + 5      # marker…vop_coded, thr, q
    codes = {"1": 1, "001": 3, "010": 3, "011": 3, "0001": 4}
    for code, n in codes.items():
        if bits[k:k + n] == code:
            return k + n
    raise AssertionError("first MCBPC not one of the short codes")


def _against_cv2(path):
    """decode_video of `path` within TOL["mpeg4"] of cv2's frames, the
    same count."""
    ref, count = mk.cv2_view(path)
    got = native.decode_video(path)
    assert got.shape == ref.shape
    assert native.video_track(path, packets=False).count == count
    err = int(np.abs(got.astype(int) - ref).max())
    print(f"{os.path.basename(path)}: max |Δ| {err} over {ref.shape}")
    assert err <= TOL["mpeg4"]


# The features a patched VOL can show. Those the decoder reads since it
# reads Advanced Simple Profile (READ_HEADER) decode the patched stream as
# cv2 does; GMC, whose VOL fields the patch would leave out, decodes
# libxvid's GMC stream instead, and data partitioning (whose macroblock
# syntax differs) libavcodec's partitioned stream, RVLC still raising.
# The rest raise, naming the feature.
READ_HEADER = {"GMC (S-VOPs)", "MPEG quantisation matrices", "quarter-pel",
               "video packets (resync markers)", "data partitioning/RVLC"}


@pytest.mark.parametrize("feature,vol", [
    ("interlace", dict(interlaced=1)),
    ("OBMC", dict(obmc_disable=0)),
    ("GMC (S-VOPs)", dict(verid=2, sprite=2)),
    ("static sprites", dict(sprite=1)),
    ("MPEG quantisation matrices", dict(quant_type=1)),
    ("quarter-pel", dict(verid=2, quarter=1)),
    ("complexity estimation", dict(estimation_disable=0)),
    ("video packets (resync markers)", dict(resync_disable=0)),
    ("data partitioning/RVLC", dict(partitioned=1)),
    ("scalability", dict(scalability=1)),
])
def test_mpeg4_header_features_raise_naming_them(tmp_path, feature, vol):
    if feature == "GMC (S-VOPs)":
        _against_cv2(FILES["xvid_gmc_avi"])
        return
    pk = _mpeg4_packets()
    if feature == "data partitioning/RVLC":
        # libavcodec's partitioned stream decodes; RVLC (which it does not
        # write) raises.
        _against_cv2(FILES["mpeg4_partitioned_avi"])
        pk[0] = _with_vol(pk[0], vol_header(mk.W, mk.H, partitioned=1,
                                            rvlc=1))
        with pytest.raises(NotImplementedError, match="RVLC"):
            native.decode_video(_write(tmp_path, pk))
        return
    pk[0] = _with_vol(pk[0], vol_header(mk.W, mk.H, **vol))
    if feature in READ_HEADER:
        _against_cv2(_write(tmp_path, pk))
        return
    with pytest.raises(NotImplementedError, match=re.escape(feature)):
        native.decode_video(_write(tmp_path, pk))


# Stream features: B-VOPs and S-VOPs decode the encoders' streams (a
# P-VOP's type patched to B or S misreads its macroblocks); two VOPs in
# one packet of a stream without DivX's packed flag decode as libavcodec
# decodes them (the first VOP, the second dropped); the rest decode the
# patched stream. Short-header H.263 still raises.
@pytest.mark.parametrize("feature", [
    "B-VOPs", "S-VOPs (GMC)", "packed bitstreams", "AC prediction",
    "an XviD stream", "a DivX stream", "short-header (H.263)"])
def test_mpeg4_stream_features_raise_naming_them(tmp_path, feature):
    if feature == "B-VOPs":
        _against_cv2(FILES["mpeg4_bframes_avi"])
        return
    if feature == "S-VOPs (GMC)":
        _against_cv2(FILES["xvid_gmc_avi"])
        return
    pk = _mpeg4_packets()
    if feature == "packed bitstreams":
        pk[1:3] = [pk[1] + pk[2]]
    elif feature == "AC prediction":
        pk[0] = _flip_vop_bits(pk[0], 1, 1, _ac_pred_offset(pk[0]))
    elif feature == "an XviD stream":
        pk[0] = re.sub(rb"Lavc[0-9.]+", b"XviD0050", pk[0])
    elif feature == "a DivX stream":
        pk[0] = re.sub(rb"Lavc[0-9.]+", b"DivX503b1393p", pk[0])
    else:
        pk[0] = b"\x00\x00\x80\x02\x0a" + bytes(40)
        with pytest.raises(NotImplementedError, match=re.escape(feature)):
            native.decode_video(_write(tmp_path, pk))
        return
    _against_cv2(_write(tmp_path, pk))


@pytest.mark.parametrize("tag", [b"XVID", b"FMP4"])
def test_h263_pictures_under_mpeg4_tags_stay_refused(tmp_path, tag):
    """Real H.263 pictures (libavcodec 59's h263 encoder) under MPEG-4
    tags, where the short-header route would read them: cv2 reads no
    frame of them, the JAX package raises ValueError and the port
    NotImplementedError naming the short header."""
    pk = mk.lavc_encode(mk.moving_frames(5, 4, 144, 176), "h263")
    path = tmp_path / "sh.avi"
    path.write_bytes(mk.avi_file(pk, 176, 144, 25, len(pk), tag))
    cap = cv2.VideoCapture(str(path))
    assert not cap.read()[0]
    cap.release()
    with pytest.raises(NotImplementedError, match="short-header"):
        native.decode_video(str(path))
    with pytest.raises(ValueError, match="no frames"):
        j_av._load_frames_video(str(path), 4, 16)


@pytest.mark.parametrize("name,feature", [
    ("mpeg4_interlaced_avi", "interlace")])
def test_mpeg4_unread_tools_raise_naming_them(name, feature):
    """What libavcodec's mpeg4 encoder writes and the port does not read
    (mk.LAVC_UNREAD) raises NotImplementedError naming the tool; cv2
    reads it."""
    path = mk.path_of(name)
    assert len(mk.cv2_view(path)[0]) == 12
    with pytest.raises(NotImplementedError, match=re.escape(feature)):
        native.decode_video(path)
    with pytest.raises(NotImplementedError, match=re.escape(feature)):
        native.load_video_frames(path, 4, 32)


def test_broken_files_raise_value_error(tmp_path):
    junk = tmp_path / "junk.mp4"
    junk.write_bytes(b"\0" * 64)
    with pytest.raises(ValueError, match="not an AVI, MP4/MOV or Matroska"):
        native.decode_video(str(junk))
    data = open(FILES["mjpeg_avi"], "rb").read()
    cut = tmp_path / "cut.avi"
    cut.write_bytes(data[:len(data) // 2])
    with pytest.raises(ValueError):
        native.decode_video(str(cut))
    # A window past the frames the clip holds: the JAX package's
    # "no frames decoded".
    with pytest.raises(ValueError, match="no frames decoded"):
        j_av._load_frames_video(FILES["mjpeg_longhdr_avi"], 4, 64, (0.9, 1))
    with pytest.raises(ValueError, match="no frames decoded"):
        native.load_video_frames(FILES["mjpeg_longhdr_avi"], 4, 64, (0.9, 1))


@pytest.mark.parametrize("layout", ["odd height", "4:2:2", "4:4:4",
                                    "4:4:0", "grey", "4:2:2 odd width"])
def test_odd_height_and_other_sampling_raise(tmp_path, layout):
    """MJPEG that raised before swscale's other routes were copied, now
    read as cv2 reads it: the committed 4:2:0 stream's first frame with
    its SOF's height cut to 55 lines (the scaler), and frames JPEG-coded
    in the other layouts libavcodec decodes, at 72x56 or 71x56."""
    if layout == "odd height":
        pk = [p for p, _ in native.video_track(FILES["mjpeg_avi"]).packets]
        sof = pk[0].index(b"\xff\xc0")
        odd = bytearray(pk[0])
        struct.pack_into(">H", odd, sof + 5, mk.H - 1)
        jpegs, h, w = [bytes(odd)], mk.H - 1, mk.W
    else:
        h, w = mk.H, mk.W - ("odd" in layout)
        jpegs = mk.jpegs_of(mk.moving_frames(4, 3, h, w), layout.split()[0])
    path = tmp_path / "x.avi"
    path.write_bytes(mk.avi_file(jpegs, w, h, 25, len(jpegs)))
    ref, count = mk.cv2_view(str(path))
    got = native.decode_video(str(path))
    assert got.shape == ref.shape == (len(jpegs), h, w, 3)
    assert np.abs(got.astype(int) - ref).max() <= TOL["mjpeg"]


@pytest.mark.parametrize("feature", ["field pairs", "sampled 2x2, 1x2, 2x1"])
def test_mjpeg_out_of_scope_raises_naming_it(tmp_path, feature):
    """An AVI whose pictures are half its height (AVI1 field pairs) and a
    JPEG of mixed sampling ratios (which libavcodec upsamples to 4:4:4
    itself) raise NotImplementedError naming them."""
    if feature == "field pairs":
        jpegs = mk.pil_jpegs(mk.moving_frames(4, 2))
        h = 2 * mk.H
    else:
        import _torch_make_frames as mkf
        rng = np.random.default_rng(2)
        sampling = ((2, 2), (1, 2), (2, 1))
        coefs = [np.clip(np.rint(rng.normal(0, 4, (mk.H // 8 * v // 2 + 1,
                                                    mk.W // 8 * hh // 2 + 1,
                                                    64))), -60, 60)
                 .astype(int) for hh, v in sampling]
        for c in coefs:
            c[..., 0] = rng.integers(-20, 20, c.shape[:2])
        jpegs = [mkf.jpeg_from_coefficients(mk.W, mk.H, sampling, coefs,
                                            np.full(64, 4))]
        h = mk.H
    path = tmp_path / "x.avi"
    path.write_bytes(mk.avi_file(jpegs, mk.W, h, 25, len(jpegs)))
    with pytest.raises(NotImplementedError, match=re.escape(feature)):
        native.decode_video(str(path))
    with pytest.raises(NotImplementedError, match=re.escape(feature)):
        native.load_video_frames(str(path), 4, 32)


def test_opendml_frame_count_is_strh_length(tmp_path):
    """An OpenDML AVI's frame count is its strh dwLength, as cv2 reports
    it, whatever the odml list's dmlh and the avih say; its packets come
    from both RIFFs through the indx super-index, and without one from
    a scan of both movi lists."""
    jpegs = mk.pil_jpegs(mk.moving_frames(6, 9), subsampling=1)
    for length, total in ((9, 9), (5, 9), (9, 5), (14, 9)):
        data = mk.avi_odml_file(jpegs, mk.W, mk.H, 25, 5, length=length,
                                total=total)
        path = tmp_path / f"x{length}_{total}.avi"
        path.write_bytes(data)
        track = native.video_track(str(path))
        ref, count = mk.cv2_view(str(path))
        assert track.count == count == length
        assert [p for p, _ in track.packets] == mk.cv2_packets(str(path))
        np.testing.assert_array_equal(native.decode_video(str(path)), ref)
        noindx = tmp_path / f"y{length}_{total}.avi"
        noindx.write_bytes(data.replace(b"indx", b"JUNK", 1))
        assert [p for p, _ in native.video_track(str(noindx)).packets] \
            == mk.cv2_packets(str(noindx)) == jpegs


def test_fixture_script_rewrites_the_committed_avi_and_mp4(tmp_path):
    for name in ("mjpeg_avi", "mpeg4_mp4", "mjpeg_nodht_avi", "clip_avi",
                 "mjpeg_mjpa_mp4", "vp8_avi", "vp8_partitions_avi",
                 "vp8_altref_avi", "vp8_mp4", "vp9_avi", "vp9_mp4",
                 "vp9_good_avi", "vp9_twopass_avi", "vp9_tiles_avi",
                 "mjpeg_422_avi", "mjpeg_440_avi", "mjpeg_itu601_avi",
                 "mjpeg_odml_avi", "vp8_oddh_avi", "vp9_oddh_avi",
                 "clip_cam_avi", "clip_oddh_avi"):
        path = mk.write_case(name, str(tmp_path))
        with open(path, "rb") as f, open(FILES[name], "rb") as g:
            assert f.read() == g.read(), name


# ---- H.264 ---------------------------------------------------------------

def _x264():
    """Skip unless libx264 (build 164) is there to write streams."""
    import ctypes
    try:
        ctypes.CDLL("libx264.so.164")
    except OSError:
        pytest.skip("libx264.so.164 is not installed")


def test_x264_fixtures_rewrite_the_committed_files(tmp_path):
    """libx264 with one thread writes the same bytes again (AVI, MP4 and
    the Matroska files, which carry no random UID)."""
    _x264()
    for name in ("h264_baseline_avi", "h264_high_mp4", "h264_main_mkv",
                 "h264_pcm_avi", "clip_h264_mkv", "h264_trim_mp4",
                 "h264_emptyedit_mp4", "clip_cut_mp4"):
        path = mk.write_case(name, str(tmp_path))
        with open(path, "rb") as f, open(FILES[name], "rb") as g:
            assert f.read() == g.read(), name


def _patch_stream(tmp_path, name: str, kind: int, field: str, new: str,
                  old_bits=1, which=lambda i: True) -> str:
    """`name`'s packets (an AVI of Annex B packets) through
    mk.patch_h264, as an AVI."""
    pk = [p for p, _ in native.video_track(FILES[name]).packets]
    out = mk.patch_h264(pk, kind, field, new, old_bits, which)
    path = tmp_path / "x.avi"
    path.write_bytes(mk.avi_file(out, mk.W, mk.H, 25, len(out), b"H264"))
    return str(path)


# The fields the decoder reads since (POC type 1, left cropping, explicit
# B weights, gaps in frame_num, long-term references, MMCO 2-6) are held
# against cv2 by test_torch_video_h264tools.py, on the same bytes.
@pytest.mark.parametrize("feature,name,kind,field,new,old", [
    ("interlaced coding", "h264_baseline_avi", 7, "frame_mbs_only", "01", 1),
    ("different bit depths", "h264_opengop_avi", 7, "bit_depth_chroma",
     mk.ue_bits(2), 1),
    ("slice groups (FMO)", "h264_baseline_avi", 8, "num_slice_groups",
     mk.ue_bits(1), 1),
    ("redundant pictures", "h264_baseline_avi", 8,
     "redundant_pic_cnt_present", "1", 1),
    ("SP and SI slices", "h264_baseline_avi", 1, "slice_type", mk.ue_bits(3), 5),
])
def test_h264_header_features_raise_naming_them(tmp_path, feature, name,
                                                kind, field, new, old):
    """Parameter sets and slice headers of the committed streams with one
    field changed: each feature the decoder does not read is named."""
    path = _patch_stream(tmp_path, name, kind, field, new, old)
    with pytest.raises(NotImplementedError, match=re.escape(feature)):
        native.decode_video(path)
    with pytest.raises(NotImplementedError, match=re.escape(feature)):
        native.load_video_frames(path, 4, 32)


@pytest.mark.parametrize("feature,settings", [
    ("interlaced coding", dict(interlaced=1)),
    ("interlaced coding", dict(interlaced=1, csp=12, bitdepth=10,
                               profile="high444")),
    ("interlaced coding", dict(interlaced=1, csp=6, qp=0,
                               profile="high444")),
    ("flagged interlaced", dict(csp=12, fake_interlaced=1, pic_struct=1,
                                picture_struct=4, profile="high444")),
    ("flagged interlaced", dict(csp=1, fake_interlaced=1, pic_struct=1,
                                picture_struct=4)),
    ("interlaced coding", dict(interlaced=1, qp=0, profile="high444")),
])
def test_h264_x264_streams_out_of_scope_raise(tmp_path, feature, settings):
    """libx264's own streams of the interlace not read, in every format
    (10-bit, 4:2:2 and monochrome are read since: see
    test_torch_video_camera.py; 4:4:4 and lossless coding: see
    test_torch_video_screen.py)."""
    _x264()
    aus = mk.x264_encode(mk.moving_frames(1, 4), **settings)
    path = tmp_path / "x.avi"
    path.write_bytes(mk.h264_file(aus, mk.W, mk.H, "avi"))
    with pytest.raises(NotImplementedError, match=re.escape(feature)):
        native.decode_video(str(path))


def test_h264_nal_features_raise_naming_them(tmp_path):
    """A slice NAL unit relabelled as a data partition; the 4 slices of a
    picture put in another order (Baseline's ASO)."""
    pk = [p for p, _ in native.video_track(FILES["h264_baseline_avi"]).packets]
    units = mk.nal_units(pk[1])
    assert units[-1][0] & 31 == 1
    units[-1] = bytes([(units[-1][0] & 0xE0) | 2]) + units[-1][1:]
    path = tmp_path / "dp.avi"
    path.write_bytes(mk.avi_file(
        [pk[0], b"".join(b"\0\0\0\1" + u for u in units)], mk.W, mk.H, 25, 2,
        b"H264"))
    with pytest.raises(NotImplementedError, match="data partitioning"):
        native.decode_video(str(path))
    pk = [p for p, _ in native.video_track(FILES["h264_slices_avi"]).packets]
    units = mk.nal_units(pk[1])
    slices = [k for k, u in enumerate(units) if u[0] & 31 == 1]
    assert len(slices) == 4
    a, b = slices[1], slices[2]
    units[a], units[b] = units[b], units[a]
    path = tmp_path / "aso.avi"
    path.write_bytes(mk.avi_file(
        [pk[0], b"".join(b"\0\0\0\1" + u for u in units)], mk.W, mk.H, 25, 2,
        b"H264"))
    with pytest.raises(NotImplementedError, match=re.escape("(ASO)")):
        native.decode_video(str(path))


def test_h264_broken_streams_raise_value_error(tmp_path):
    """A picture cut short, a picture without its parameter sets, and an
    MP4 avc1 entry without its avcC box."""
    pk = [p for p, _ in native.video_track(FILES["h264_baseline_avi"]).packets]
    units = mk.nal_units(pk[0])
    no_sets = b"".join(b"\0\0\0\1" + u for u in units
                       if u[0] & 31 not in (7, 8))
    for bad in (pk[0][:len(pk[0]) // 2], no_sets):
        path = tmp_path / "x.avi"
        path.write_bytes(mk.avi_file([bad], mk.W, mk.H, 25, 1, b"H264"))
        with pytest.raises(ValueError):
            native.decode_video(str(path))
    data = open(FILES["h264_high_mp4"], "rb").read()
    path = tmp_path / "x.mp4"
    path.write_bytes(data.replace(b"avcC", b"xxxx", 1))
    with pytest.raises(ValueError, match="avcC"):
        native.decode_video(str(path))


@pytest.mark.parametrize("media_time", [0, 1, 3])
def test_h264_mp4_edit_lists_that_trim_raise(tmp_path, media_time):
    """The committed MP4's one edit (from the first presented sample's
    composition time, 2 frames, over 40) moved to 0, 1 and 3: read as
    cv2 reads it, which keeps the 38, 39 and 39 frames presented within
    the edit (libavformat's mov_fix_index marks the rest to be decoded
    and dropped)."""
    data = bytearray(open(FILES["h264_high_mp4"], "rb").read())
    at = data.index(b"elst") + 16                  # the edit's media_time
    assert struct.unpack_from(">i", data, at)[0] == 2
    struct.pack_into(">i", data, at, media_time)
    path = tmp_path / "x.mp4"
    path.write_bytes(bytes(data))
    ref, count = mk.cv2_view(str(path))
    assert len(ref) == {0: 38, 1: 39, 3: 39}[media_time]
    track = native.video_track(str(path))
    assert track.count == count
    assert _mp4toannexb(track) == mk.cv2_packets(str(path))
    np.testing.assert_array_equal(native.decode_video(str(path)), ref)
    np.testing.assert_array_equal(
        native.load_video_frames(str(path), 8, 32, (0.2, 0.9)),
        j_av._load_frames_video(str(path), 8, 32, (0.2, 0.9)))


@pytest.mark.parametrize("edits", [[(20, 3)], [(2, None), (15, 14)],
                                   [(10, 0)]])
def test_h264_mp4_edits_match_cv2(tmp_path, edits):
    """libx264's 30-frame High stream (keyframes 0, 12, 24) in MP4 under
    an edit that drops frames at both ends, an empty edit before one
    that starts past the second keyframe, and an edit that keeps the
    first 10 frames: cv2's packets, count and frames."""
    aus = mk.x264_encode(mk.moving_frames(12, 30), keyint=12)
    path = tmp_path / "x.mp4"
    path.write_bytes(mk.h264_file(aus, mk.W, mk.H, "mp4", edits=edits))
    ref, count = mk.cv2_view(str(path))
    track = native.video_track(str(path))
    assert track.count == count == 30
    assert _mp4toannexb(track) == mk.cv2_packets(str(path))
    np.testing.assert_array_equal(native.decode_video(str(path)), ref)
    np.testing.assert_array_equal(
        native.load_video_frames(str(path), 6, 32),
        j_av._load_frames_video(str(path), 6, 32, None))


@pytest.mark.parametrize("feature,edits", [
    ("rate 0.5000", [(40, 2, 0x8000)]),
    ("several edits", [(10, 2, 0x10000), (30, 12, 0x10000)]),
    ("duration 0", [(0, 5, 0x10000)]),
])
def test_h264_mp4_edit_lists_out_of_scope_raise(tmp_path, feature, edits):
    """The committed High stream's samples under edits the reader does
    not follow: another rate, several non-empty edits (libavformat's
    advanced edit lists), a zero duration. Each raises
    NotImplementedError naming it."""
    track = native.video_track(FILES["h264_high_mp4"])
    path = tmp_path / "x.mp4"
    path.write_bytes(mk.mp4_file(
        [p for p, _ in track.packets], mk.W, mk.H, 25, b"avc1",
        mk._box(b"avcC", track.config),
        sync=[i for i, (_, k) in enumerate(track.packets) if k],
        edits=edits))
    for read in (native.video_track, native.decode_video):
        with pytest.raises(NotImplementedError, match=re.escape(feature)):
            read(str(path))


def test_h264_corrupted_streams_raise_or_decode(tmp_path):
    """Seeded corruptions of the committed streams (flipped and replaced
    bytes, cut NAL units, packets dropped, swapped and repeated): each
    decodes or raises ValueError / NotImplementedError."""
    import random

    rng = random.Random(13)
    names = ("h264_baseline_avi", "h264_high_mp4", "h264_main_mkv",
             "h264_slices_avi", "h264_pcm_avi")
    streams = {n: [p for p, _ in native.video_track(FILES[n]).packets]
               for n in names}
    decoded = raised = 0
    for it in range(40):
        name = names[it % len(names)]
        pk = [bytearray(p) for p in streams[name]]
        for _ in range(rng.randint(1, 3)):
            i, j = rng.randrange(len(pk)), rng.randrange(len(pk))
            op = rng.randrange(4)
            if op == 0:
                pk[i], pk[j] = pk[j], pk[i]
            elif op == 1 and len(pk) > 1:
                del pk[i]
            elif op == 2:
                pk.insert(i, bytearray(pk[j]))
        for _ in range(rng.randint(1, 6)):
            p = pk[rng.randrange(len(pk))]
            at = rng.randrange(5, len(p)) if len(p) > 5 else 0
            if rng.random() < 0.7:
                p[at] ^= 1 << rng.randrange(8)
            else:
                del p[at:at + rng.randint(1, 40)]
        path = tmp_path / f"x{it}.mkv"
        track = native.video_track(FILES[name], packets=False)
        path.write_bytes(mk.mkv_file([bytes(p) for p in pk], mk.W, mk.H, 25,
                                     "V_MPEG4/ISO/AVC", track.config)
                         if track.config else b"")
        if not track.config:
            path = tmp_path / f"x{it}.avi"
            path.write_bytes(mk.avi_file([bytes(p) for p in pk], mk.W, mk.H,
                                         25, len(pk), b"H264"))
        try:
            frames = native.decode_video(str(path))
            assert frames.shape[1:] == (mk.H, mk.W, 3)
            decoded += 1
        except (ValueError, NotImplementedError):
            raised += 1
    assert decoded + raised == 40 and raised > 0


# libavformat's riff tags of MPEG-4 Part 2 (ff_codec_bmp_tags) beyond FMP4,
# DIVX, DX50, XVID, mp4v ...: XVIX (libavcodec's FF_BUG_XVID_ILACE, which
# acts on interlaced streams only), ZMP4 and SIPP (decoded as XviD's).
MPEG4_TAGS = ["WV1F", "SEDG", "XVIX", "BLZ0", "SIPP", "ZMP4", "DM4V", "EPHV",
              "M4CC", "VIDM"]


@pytest.mark.parametrize("tag", MPEG4_TAGS)
def test_mpeg4_riff_tags_read_as_cv2_reads_them(tmp_path, tag):
    """Each tag on libxvid's stream and on libavcodec's with B-VOPs."""
    for src in ("xvid_avi", "mpeg4_bframes_avi"):
        old = open(mk.path_of(src), "rb").read()[112:116]   # strh's fourcc
        path = mk.relabel(mk.path_of(src), str(tmp_path / f"{src}.avi"),
                          old, tag.encode())
        track = native.video_track(path, packets=False)
        assert track.codec == "mpeg4" and track.tag == tag
        got, (ref, _) = native.decode_video(path), mk.cv2_view(path)
        assert got.shape == ref.shape
        assert int(np.abs(got.astype(int) - ref).max()) == 0, src


def test_mpeg4_tag_workarounds_raise(tmp_path):
    """GEOV, whose pictures libavcodec hands over bottom-up (cv2's frames
    are the stream's flipped), and an interlaced XVIX stream (XviD's
    interlace workaround; interlace raises) raise by name."""
    path = mk.relabel(mk.path_of("xvid_avi"), str(tmp_path / "g.avi"),
                      b"XVID", b"GEOV")
    ref, _ = mk.cv2_view(path)
    plain = native.decode_video(mk.path_of("xvid_avi"))
    assert int(np.abs(plain[:, ::-1].astype(int) - ref).max()) == 0
    with pytest.raises(NotImplementedError, match="GEOV"):
        native.decode_video(path)
    src = mk.path_of("mpeg4_interlaced_avi")
    old = open(src, "rb").read()[112:116]           # strh's fourcc
    path = mk.relabel(src, str(tmp_path / "x.avi"), old, b"XVIX")
    with pytest.raises(NotImplementedError, match="interlace"):
        native.decode_video(path)
