"""The port's H.264 decoder (csrc/h264.cpp, through csrc/videodec.cpp and
native.py) on H.264 that does not start at an IDR picture or uses tools
libx264 never writes, against cv2 and the JAX package's
`_load_frames_video`.

The cases of tests/_torch_make_videos.py's H264_TOOLS and TOOLS_CLIPS
(committed in tests/torch_videos/ with cv2's decodes): `-c copy` cuts of
open-GOP streams at a recovery point (without leading pictures, with
leading B-pictures in a B-pyramid, without the recovery point SEI), of an
intra-refresh stream (21 of its 30 pictures output), among the B-pictures
before a recovery point and at a plain P picture of closed GOPs, in AVI,
Matroska and MP4 (times counted from the cut, MP4's edit list from the
first presented sample); libx264's left and top crops (4:2:0, 4:2:2,
4:4:4 at an odd left crop, 10 bits); and libx264's streams with headers
rewritten bit by bit (mk.rewrite_h264, CAVLC and CABAC slices): POC type
1, gaps in frame_num with and without the SPS's flag, explicit
bi-predictive weights, long-term references with every MMCO and list
modification idc 2 under temporal and spatial direct prediction (an
MMCO 5 whose later POCs run on from the reset picture's, as libavcodec
counts them); an open-GOP cut whose first P picture lists a grey gap
frame first (libavcodec's noref_gray takes the I picture instead); the
cuts folder's 224x224 clip.

Each goes through `native.video_track` (packets byte for byte against
cv2's `CAP_PROP_FORMAT = -1`, MP4 and Matroska through the test module's
copy of h264_mp4toannexb; the count against `CAP_PROP_FRAME_COUNT`),
`native.decode_video` against `cap.read()` (count and 0 levels), and
`load_video_frames`/`load_frames_for` against the JAX package on whole
clips and windows, one beginning among the pictures cv2 never reaches
(raises included). Cuts at every position of two streams are held live;
the header fields that raised before this decoder read them, patched one
at a time into the committed streams, decode as cv2 decodes the same
bytes; a cut at a first P picture decodes against cv2 from a grey gap
frame, and one whose references are all missing raises
NotImplementedError naming it.
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

CASES = list(mk.H264_TOOLS)
ALL = [*CASES, *mk.TOOLS_CLIPS]
FILES = {c: mk.path_of(c) for c in ALL}
# whole clips, windows, and one that begins past the pictures cv2 reads
# of a cut whose container counts those it drops
WINDOWS = (None, (0.3, 0.6), (0.9, 1.0), (0.75, 0.95))
# (pictures cv2 reads, the container's count)
COUNTS = {"h264_gopcut_avi": (30, 30), "h264_leadcut_mkv": (30, 31),
          "h264_noseicut_mkv": (28, 31), "h264_refcut_avi": (21, 30),
          "h264_refcut_mkv": (21, 30), "h264_refcut_mp4": (21, 30),
          "h264_midcut_mkv": (20, 27), "h264_pcut_avi": (20, 29),
          "h264_pcut_mkv": (20, 27), "clip_gopcut_mkv": (16, 19)}
# cv2's size (h, w) of libx264's crop_rect on 72x56
SIZES = {"h264_crop84_avi": (52, 64), "h264_crop2_avi": (52, 68),
         "h264_crop32_mkv": (40, 40), "h264_croptop_avi": (50, 72),
         "h264_crop444_avi": (56, 69), "h264_crop10_mkv": (54, 64),
         "h264_crop422_mp4": (56, 68)}


def _x264():
    """Skip unless libx264 (build 164) is there to write streams."""
    import ctypes
    try:
        ctypes.CDLL("libx264.so.164")
    except OSError:
        pytest.skip("libx264.so.164 is not installed")


def _cv2_frames(path: str) -> np.ndarray:
    """Every frame cv2 reads from `path` (none: an empty array)."""
    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    cap.release()
    return np.stack(frames) if frames else np.zeros((0, 1, 1, 3), np.uint8)


def _same_as_cv2(path: str):
    """The port decodes `path` as cv2 does: its frames at 0 levels, or,
    where cv2 reads none, a raise."""
    ref = _cv2_frames(path)
    if len(ref) == 0:
        with pytest.raises((ValueError, NotImplementedError)):
            native.decode_video(path)
        return 0
    got = native.decode_video(path)
    assert got.shape == ref.shape and got.dtype == np.uint8
    err = int(np.abs(got.astype(int) - ref).max())
    assert err == 0, err
    return len(ref)


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
    assert track.codec == "h264"


@pytest.mark.parametrize("name", ALL)
def test_decode_video_matches_cv2(name):
    got = native.decode_video(FILES[name])
    ref, count = mk.cv2_view(FILES[name])
    assert got.shape == ref.shape and got.dtype == np.uint8
    err = int(np.abs(got.astype(int) - ref).max())
    print(f"{name}: max |Δ| {err} over {ref.shape} (count {count})")
    assert err == 0
    if name in COUNTS:
        assert (len(ref), count) == COUNTS[name]
    if name in SIZES:
        assert ref.shape[1:3] == SIZES[name]


@pytest.mark.parametrize("name", ALL)
def test_load_frames_match_jax(name):
    """Both packages' picks over cv2's count, windows of a cut past the
    pictures it reads included: equal at 0.0, or both raise."""
    path = FILES[name]
    stem = os.path.splitext(path)[0]
    worst, raised = 0.0, 0
    for n in (16, 40):
        for window in WINDOWS:
            try:
                ref = j_av._load_frames_video(path, n, 32, window)
            except ValueError:
                with pytest.raises(ValueError):
                    native.load_video_frames(path, n, 32, window)
                raised += 1
                continue
            got = native.load_video_frames(path, n, 32, window)
            assert got.shape == ref.shape and got.dtype == np.float32
            worst = max(worst, float(np.abs(got - ref).max()))
    for window in WINDOWS[1::2]:
        try:
            ref = j_av.load_frames_for(stem, 16, 64, window)
        except ValueError:
            with pytest.raises(ValueError):
                av.load_frames_for(stem, 16, 64, window)
            continue
        got = av.load_frames_for(stem, 16, 64, window)
        worst = max(worst, float(np.abs(got - ref).max()))
    print(f"{name}: max |Δ| {worst * 255:.3f} / 255, {raised} raised")
    assert worst == 0.0
    read, count = COUNTS.get(name, (1, 1))
    if read < 0.75 * count:
        assert raised                       # picks past cv2's last frame


@pytest.mark.parametrize("name", ALL)
def test_committed_decodes_are_cv2s(name):
    ref = np.load(os.path.join(mk.FIXTURES, name + ".npz"))
    frames, count = mk.cv2_view(FILES[name])
    assert int(ref["n"]) == len(frames) and int(ref["count"]) == count
    np.testing.assert_array_equal(ref["frames"], frames[ref["index"]])
    got = native.decode_video(FILES[name])
    assert got.shape[0] == int(ref["n"])
    np.testing.assert_array_equal(got[ref["index"]], ref["frames"])


def test_fixtures_rewrite_the_committed_files(tmp_path):
    """libx264 with one thread and the rewriter write the same bytes
    again (AVI, MP4 and Matroska, which carry no random UID)."""
    _x264()
    for name in ("h264_leadcut_mp4", "h264_refcut_mkv", "h264_crop444_avi",
                 "h264_poc1b_mkv", "h264_bipred_avi", "h264_ltrt5_mkv"):
        path = mk.write_case(name, str(tmp_path))
        with open(path, "rb") as f, open(FILES[name], "rb") as g:
            assert f.read() == g.read(), name


def test_rewriter_round_trips_slice_headers():
    """mk.rewrite_h264 with no edit writes every NAL unit of CABAC, CAVLC
    and weighted streams back unchanged."""
    _x264()
    frames = mk.moving_frames(5, 12)
    for settings in (dict(), dict(cabac=0, weightp=2),
                     dict(profile="baseline"),
                     dict(weightb=1, direct="temporal", b_pyramid="none")):
        aus = mk.x264_encode(frames, **settings)
        again = mk.rewrite_h264(aus, slices=lambda *a: None)
        assert [mk.nal_units(a) for a, _, _ in aus] == \
            [mk.nal_units(a) for a, _, _ in again]


def test_patched_streams_use_their_tools():
    """The rewritten headers are what the names say: the committed
    streams' SPSs, PPSs and slice headers read back."""
    def firsts(name):
        return [f for f in mk._first_slices(_aus(name)) if f[0]]

    sps = firsts("h264_poc1d_avi")[0][1]
    assert sps.poc_type == 1 and sps.poc_offsets == (-3, 0, [1, 3])
    assert firsts("h264_poc1_avi")[0][1].delta_always_zero
    track = native.video_track(FILES["h264_bipred_avi"])
    pps = [u for p, _ in track.packets for u in mk.nal_units(p)
           if u[0] & 31 == 8][0]
    assert mk.pps_fields(mk.rbsp_bits(pps)).weighted_bipred_idc == 1
    assert all(h["weights"] for h, _ in firsts("h264_bipred_avi")
               if h["slice_type"] % 5 == 1)
    ops = {op[0] for h, _ in firsts("h264_ltrt5_mkv")
           for op in (h.get("mmco") or [])}
    assert ops == {1, 2, 3, 4, 5, 6}
    assert any(h.get("long_term") for h, _ in firsts("h264_ltrs_mp4"))
    mods = {m[0] for h, _ in firsts("h264_ltrs_mp4")
            for lst in h["mods"] if lst for m in lst}
    assert 2 in mods
    nums = [h["frame_num"] for h, _ in firsts("h264_gaps_avi")]
    assert any((b - a) % 16 > 1 for a, b in zip(nums, nums[1:]))


def _aus(name):
    """A committed file's access units as (Annex B bytes, 0, 0)."""
    track = native.video_track(FILES[name])
    packets = mk.mp4toannexb(track) if track.config else \
        [p for p, _ in track.packets]
    return [(p, 0, 0) for p in packets]


# ---- live streams --------------------------------------------------------

@pytest.mark.parametrize("stream", ["lead", "refresh"])
def test_cuts_at_every_packet_match_cv2(tmp_path, stream):
    """A cut at each of the first 16 packets (Matroska: the avcC's
    parameter sets reach every slice; the pictures before a recovery
    point or the next IDR picture dropped, grey gap frames and copies
    standing in for the references before the cut)."""
    _x264()
    settings = dict(mk.TOOLS_CUT_LEAD if stream == "lead"
                    else mk.TOOLS_CUT_REFRESH)
    frames = mk.moving_frames(3, settings.pop("frames"))
    aus = mk.x264_encode(frames, **settings)
    path = str(tmp_path / "x.mkv")
    read = []
    for k in range(1, 16):
        with open(path, "wb") as f:
            f.write(mk.h264_cut_file(aus[k:], mk.W, mk.H, "mkv"))
        read.append(_same_as_cv2(path))
    assert min(read) > 0 and len(set(read)) > 1


def test_recovery_point_without_sei_outputs_nothing(tmp_path):
    """An open GOP cut at its I picture with the recovery point SEI left
    out and PPSs of three references: libavcodec's heuristic does not
    take it for a recovery point and cv2 reads no frame; both packages
    raise ValueError."""
    _x264()
    settings = dict(mk.TOOLS_CUT_GOP)
    frames = mk.moving_frames(3, settings.pop("frames"))
    aus = mk.strip_sei(mk.x264_encode(frames, **settings)[10:])
    path = str(tmp_path / "x.avi")
    with open(path, "wb") as f:
        f.write(mk.h264_cut_file(aus, mk.W, mk.H, "avi"))
    assert _same_as_cv2(path) == 0
    with pytest.raises(ValueError):
        j_av._load_frames_video(path, 4, 32)
    with pytest.raises(ValueError, match="no frames"):
        native.load_video_frames(path, 4, 32)


@pytest.mark.parametrize("first", [1, 0])
def test_cut_at_the_first_p_picture(tmp_path, first):
    """A cut at the first P picture of a stream, given a recovery point
    SEI, so that it is output. Its frame_num 1 after a fresh decoder's −1
    is a gap: one mid-grey frame stands in for the IDR picture, and the
    picture and those after it decode as cv2 decodes them. Counted from
    0 instead, no gap is filled and its references are missing:
    libavcodec conceals its macroblocks, which the port does not copy:
    NotImplementedError naming it."""
    _x264()
    aus = mk.x264_encode(mk.moving_frames(4, 12), keyint=30, bframes=0)
    sets = [u for u in mk.nal_units(aus[0][0]) if u[0] & 31 in (7, 8)]
    sei = mk.nal_unit(6, "00000110" + "00000001" + "1" + "1000" + "100"
                      + "10000000")
    head = b"".join(b"\0\0\0\1" + u for u in (*sets, sei)) + aus[1][0]

    def renumber(i, h, sps, pps):
        h["frame_num"] += first - 1

    aus = mk.rewrite_h264([(head, *aus[1][1:]), *aus[2:]], slices=renumber)
    path = str(tmp_path / "x.mkv")
    with open(path, "wb") as f:
        f.write(mk.h264_cut_file(aus, mk.W, mk.H, "mkv"))
    assert len(_cv2_frames(path)) == len(aus)
    if first:
        assert _same_as_cv2(path) == len(aus)
        return
    with pytest.raises(NotImplementedError, match="references missing"):
        native.decode_video(path)


# ---- header fields that raised before this decoder read them ------------

def _patch_stream(tmp_path, name: str, kind: int, field: str, new: str,
                  old_bits=1, which=lambda i: True) -> str:
    """`name`'s packets (an AVI of Annex B packets) through
    mk.patch_h264, as an AVI."""
    path = mk.path_of(name)
    pk = [p for p, _ in native.video_track(path).packets]
    out = mk.patch_h264(pk, kind, field, new, old_bits, which)
    path = tmp_path / "x.avi"
    path.write_bytes(mk.avi_file(out, mk.W, mk.H, 25, len(out), b"H264"))
    return str(path)


@pytest.mark.parametrize("feature,name,kind,field,new,old", [
    ("pic_order_cnt_type 1", "h264_baseline_avi", 7, "poc_type",
     mk.ue_bits(1), 3),
    ("frame cropping on the left", "h264_baseline_avi", 7, "crop_left",
     mk.ue_bits(2), 1),
    ("weighted_bipred_idc 1", "h264_opengop_avi", 8, "weighted_bipred_idc",
     "01", 2),
    ("gaps in frame_num", "h264_baseline_avi", 1, "frame_num", None, None),
    ("long-term references", "h264_baseline_avi", 5,
     "long_term_reference_flag", "1", 1),
    ("memory_management_control_operation 2", "h264_baseline_avi", 1,
     "adaptive_ref_pic_marking", "1" + mk.ue_bits(2), 1),
    ("memory_management_control_operation 3", "h264_baseline_avi", 1,
     "adaptive_ref_pic_marking", "1" + mk.ue_bits(3), 1),
    ("memory_management_control_operation 4", "h264_baseline_avi", 1,
     "adaptive_ref_pic_marking", "1" + mk.ue_bits(4), 1),
    ("memory_management_control_operation 5", "h264_baseline_avi", 1,
     "adaptive_ref_pic_marking", "1" + mk.ue_bits(5), 1),
    ("memory_management_control_operation 6", "h264_baseline_avi", 1,
     "adaptive_ref_pic_marking", "1" + mk.ue_bits(6), 1),
])
def test_h264_header_features_read_as_cv2_reads_them(tmp_path, capfd,
                                                     feature, name, kind,
                                                     field, new, old):
    """The committed streams with one field changed (the bytes that
    test_torch_video_decode.py held raising before): each decodes as cv2
    decodes it, at 0 levels, and the window reader agrees with the JAX
    package. Most of these one-field patches leave the rest of the header
    misread: where libavcodec reports broken slices (it conceals them:
    cv2's frames are not the stream's) or cv2 reads no frame, the port
    raises naming what breaks."""
    if field == "frame_num":                    # the 5th P slice skips one
        sps = mk.sps_fields(mk.rbsp_bits(mk.nal_units(
            native.video_track(mk.path_of(name)).packets[0][0])[0]))
        n = sps.log2_max_frame_num
        path = _patch_stream(tmp_path, name, kind, field,
                             format(6, f"0{n}b"), n, which=lambda i: i == 4)
    else:
        path = _patch_stream(tmp_path, name, kind, field, new, old)
    capfd.readouterr()
    ref = _cv2_frames(path)
    broken = re.findall(r"error while decoding MB|no frame!|"
                        r"decode_slice_header error|concealing",
                        capfd.readouterr().err)
    print(f"{feature}: cv2 reads {len(ref)} frames, libavcodec reports "
          f"{len(broken)} broken slices")
    if broken or len(ref) == 0:
        with pytest.raises((ValueError, NotImplementedError),
                           match="H.264"):
            native.decode_video(path)
        return
    assert _same_as_cv2(path) == len(ref)
    try:
        ref = j_av._load_frames_video(path, 8, 32)
    except ValueError:
        with pytest.raises((ValueError, NotImplementedError)):
            native.load_video_frames(path, 8, 32)
        return
    got = native.load_video_frames(path, 8, 32)
    assert float(np.abs(got - ref).max()) == 0.0


# libavformat's riff tags of H.264 (ff_codec_bmp_tags) beyond H264, X264,
# avc1 and DAVC.
H264_TAGS = ["SMV2", "VSSH", "Q264", "V264", "GAVC", "UMSV", "tshd", "INMC",
             "ai55"]


@pytest.mark.parametrize("tag", H264_TAGS)
def test_h264_riff_tags_read_as_cv2_reads_them(tmp_path, tag):
    path = mk.relabel(mk.path_of("h264_baseline_avi"), str(tmp_path / "t.avi"),
                      b"H264", tag.encode())
    track = native.video_track(path, packets=False)
    assert track.codec == "h264" and track.tag == tag
    got, (ref, _) = native.decode_video(path), mk.cv2_view(path)
    assert got.shape == ref.shape
    assert int(np.abs(got.astype(int) - ref).max()) == 0
