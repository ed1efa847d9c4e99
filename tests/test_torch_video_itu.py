"""The port's ITU video telephony readers (csrc/msmpeg4.cpp's H.263 and
H.263+, csrc/h261.cpp's H.261, routed by csrc/videodec.cpp and
native.py) on video as OpenCV's writer and old phones store it, against
cv2 and the JAX package's `load_frames_for`.

The cases of tests/_torch_make_videos.py's ITU_CASES and ITU_CLIPS
(committed in tests/torch_videos/ with cv2's decode of the last frame):
H.263 baseline from the system's libavcodec 59 at sub-QCIF, QCIF and
CIF, with 4MV and OBMC (Annex F), GOB headers, DQUANT, quantisers 2 and
31 and Annex D's bit; H.263+ at custom sizes (124x100, 224x224,
224x160), with each of Annexes D, I, J, K, S and T alone and all of
them together, the rounding type, DQUANT, P pictures with UFEP 0 and
Annex T's DQUANT written into the headers; H.261 at QCIF and CIF and two
quantisers; in AVI under the riff tags, Matroska's V_MS/VFW/FOURCC and
MP4's s263 and h263 sample entries (with and without d263); and
cv2.VideoWriter's own files. Each goes through `native.video_track`
(packets byte for byte against cv2's `CAP_PROP_FORMAT = -1`, the count,
the size), `native.decode_video` against `cap.read()` and the committed
decode (0 levels), and both packages' `load_frames_for` (0.0) over three
windows. Beside them: the headers that make each case what it is named
for, the riff tags held against cv2, files cv2's writer writes live,
GFID changes, and what libavcodec refuses or ignores and no encoder here
writes (Annexes E, G, M, N, O, P, Q, R, Annex K's rectangular and
unordered slices, a new size; ZyGo's and Intel's H.263; DV) raising
NotImplementedError by name; GOBs lost (a picture cut at a GOB header, a
GOB header's start code broken), which cv2 conceals or leaves undecoded,
raising ValueError.
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

ALL = [*mk.ITU_CASES, *mk.ITU_CLIPS]
FILES = {c: mk.path_of(c) for c in ALL}
WINDOWS = ((0.0, 1.0), (0.3, 0.6), (0.9, 1.0))
GBSC = "0" * 16 + "1"           # H.263's GOB and slice start code


def _write(tmp_path, name: str, data: bytes) -> str:
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    return path


def _held(path: str) -> np.ndarray:
    """The port's track and frames against cv2's packets, count, size and
    frames; → the frames."""
    track = native.video_track(path)
    assert track.codec in ("h263", "h261")
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
    got = _held(FILES[name])
    assert native.video_track(FILES[name]).codec == mk.codec_of(name)
    ref = np.load(os.path.join(mk.FIXTURES, name + ".npz"))
    assert got.shape[0] == int(ref["n"])
    np.testing.assert_array_equal(got[ref["index"]], ref["frames"])
    assert int(ref["count"]) == native.video_track(FILES[name]).count


@pytest.mark.parametrize("name", ALL)
def test_load_frames_match_jax(name):
    stem = os.path.splitext(FILES[name])[0]
    for window in WINDOWS:
        ref = j_av.load_frames_for(stem, 16, 32, window)
        got = av.load_frames_for(stem, 16, 32, window)
        assert got.shape == ref.shape and got.dtype == np.float32
        assert float(np.abs(got - ref).max()) == 0.0, window


def _pictures(name: str) -> list[dict]:
    """Each picture's header fields (H.263's PTYPE or PLUSPTYPE, H.261's
    PTYPE) and its count of GOB or slice start codes."""
    out = []
    for pkt, _ in native.video_track(FILES[name]).packets:
        b = mk._bits(pkt)
        if name.startswith(("h261", "clip_h261")):
            out.append(dict(cif=b[28], gobs=b.count("0" * 15 + "1") - 1))
            continue
        h = dict(fmt=int(b[35:38], 2), gobs=b[22:].count(GBSC))
        if h["fmt"] != 7:
            h.update(plus=False, type="IP"[int(b[38])], umv=b[39], sac=b[40],
                     ap=b[41], pb=b[42])
        else:
            h.update(plus=True, ufep=int(b[38:41], 2))
            at = 41
            if h["ufep"] == 1:
                keys = ("pcf", "umv", "sac", "ap", "aic", "df", "ss", "rps",
                        "isd", "aiv", "mq")
                h["fmt"] = int(b[41:44], 2)
                h.update(zip(keys, b[44:55]))
                at = 59
            h.update(type="IP"[int(b[at:at + 3], 2)], rtype=b[at + 5])
            if h.get("fmt") == 6:
                h["size"] = ((int(b[73:82], 2) + 1) * 4, int(b[83:92], 2) * 4)
        out.append(h)
    return out


def test_fixtures_hold_what_they_are_named_for():
    """The modes each case is there for, from its picture headers: the
    baseline's source formats, OBMC's bit (AP), GOB headers, Annex D's
    bit; H.263+'s custom sizes and every annex bit of OPPTYPE, slices,
    the rounding type's flip-flop, UFEP 0 in P pictures, Annex T's DQUANT
    and extended escapes in the I pictures; H.261's formats and GOBs."""
    p = {n: _pictures(n) for n in ALL
         if not n.startswith(("h261", "clip_h261"))}
    for name, fmt in (("h263_sqcif_mkv", 1), ("h263_avi", 2),
                      ("h263_cif_avi", 3), ("clip_h263_avi", 3)):
        assert {h["fmt"] for h in p[name]} == {fmt}, name
    for name, hs in p.items():
        if not name.startswith(("h263p", "clip_h263p")):
            assert not any(h["plus"] for h in hs), name
            want = "1" if "obmc" in name or name in (
                "h263_longvec_avi", "clip_h263_avi") else "0"
            assert {h["ap"] for h in hs} == {want}, name
            assert {h["umv"] for h in hs} == {
                "1" if name == "h263_longvec_avi" else "0"}, name
    assert all(h["gobs"] > 0 for h in p["h263_gob_avi"])
    assert not any(h["gobs"] for h in p["h263_avi"])
    annexes = {"h263p_umv_avi": {"umv"}, "h263p_aiv_mkv": {"aiv"},
               "h263p_aic_avi": {"aic", "mq"}, "h263p_aicq1_avi": {"aic",
                                                                  "mq"},
               "h263p_loop_avi": {"df"}, "h263p_slices_avi": {"ss"},
               "h263p_mq_avi": {"aic", "mq", "df"},
               "h263p_odd_mp4": {"umv"}, "h263p_avi": set()}
    every = {"umv", "aiv", "aic", "mq", "df", "ss", "ap"}
    for name in ("h263p_all_avi", "h263p_all_mp4", "h263p_allq_mkv",
                 "clip_h263p_mp4"):
        annexes[name] = every
    for name, on in annexes.items():
        for h in p[name]:
            if h["ufep"]:
                got = {k for k in ("umv", "sac", "ap", "aic", "df", "ss",
                                   "rps", "isd", "aiv", "mq") if h[k] == "1"}
                assert got == on, (name, got)
        if "ps" in {**mk.ITU_CASES, **mk.ITU_CLIPS}[name][2]:
            assert all(h["gobs"] > 0 for h in p[name]), name  # slices
    assert {h["size"] for h in p["h263p_odd_mp4"]} == {(124, 100)}
    assert {h["size"] for h in p["h263p_avi"]} == {(224, 224)}
    assert {h["size"] for h in p["h263p_all_avi"]} == {(224, 160)}
    assert {h["rtype"] for h in p["h263p_avi"] if h["type"] == "P"} \
        == {"0", "1"}
    assert [h["ufep"] for h in p["h263p_ufep0_avi"]] == [
        1 if h["type"] == "I" else 0 for h in p["h263p_ufep0_avi"]]
    for name, forms in (("h263p_mq_avi", True), ("h263p_aic_avi", False)):
        for pkt, _ in native.video_track(FILES[name]).packets:
            bits = mk._bits(pkt)
            if bits[59:62] == "000":
                mbs = mk.h263_intra_mbs(bits, 99)
                assert any(m[2] >= 4 for m in mbs) == forms, name
    escapes = []
    mk.h263_intra_mbs(mk._bits(native.video_track(
        FILES["h263p_aicq1_avi"]).packets[0][0]), 99, escapes)
    assert -128 in escapes                     # Annex T's extended escape
    for name, cif in (("h261_avi", "0"), ("h261_q2_mkv", "0"),
                      ("h261_q31_avi", "0"), ("h261_cif_avi", "1"),
                      ("clip_h261_avi", "1")):
        hs = _pictures(name)
        assert {h["cif"] for h in hs} == {cif}, name
        assert {h["gobs"] for h in hs} == {12 if cif == "1" else 3}, name
    data = {n: open(FILES[n], "rb").read() for n in FILES if n.endswith("mp4")}
    for name, entry, d263 in (("h263_s263_mp4", b"s263", True),
                              ("h263_nod263_mp4", b"s263", False),
                              ("h263_h263_mp4", b"h263", True),
                              ("h263p_odd_mp4", b"s263", True),
                              ("clip_h263p_mp4", b"s263", True)):
        assert entry in data[name] and (b"d263" in data[name]) == d263, name


@pytest.mark.parametrize("fourcc", ["H263", "X263", "M263", "VX1K", "U263",
                                    "H261"])
def test_cv2_writes_itu_live(tmp_path, fourcc):
    """cv2.VideoWriter's own files under each fourcc, at QCIF and CIF, in
    AVI and Matroska."""
    for h, w in ((144, 176), (288, 352)):
        frames = mk.moving_frames(len(fourcc) + w, 4, h, w)
        for ext in ("avi", "mkv"):
            path = str(tmp_path / f"t{w}.{ext}")
            mk.write_cv2(path, fourcc, 25, frames)
            assert _held(path).shape == (4, h, w, 3)


@pytest.mark.parametrize("tag", ["X263", "T263", "L263", "VX1K", "M263",
                                 "lsvm", "LSVM", "U263", "h263", "u263"])
def test_riff_tags_read_as_cv2_reads_them(tmp_path, tag):
    """H.263's riff tags, matched as libavformat matches them (upper-cased
    too), on the H263 fixture relabelled."""
    path = mk.relabel(FILES["h263_avi"], str(tmp_path / "t.avi"), b"H263",
                      tag.encode())
    np.testing.assert_array_equal(_held(path),
                                  native.decode_video(FILES["h263_avi"]))


def test_sorenson_s263_tag_is_flv1(tmp_path):
    """S263 in an AVI is Sorenson's H.263 (FLV1) to libavformat: the FLV1
    fixture relabelled reads as cv2 reads it (s263 names H.263 only as an
    MP4 sample entry)."""
    src = mk.path_of("flv_avi")
    path = mk.relabel(src, str(tmp_path / "s.avi"), b"FLV1", b"S263")
    np.testing.assert_array_equal(_held(path), native.decode_video(src))


@pytest.mark.parametrize("tag,why", [("ZyGo", "ZyGo"), ("ZYGO", "ZyGo"),
                                     ("I263", "Intel H.263"),
                                     ("viv1", "not read")])
def test_unread_tags_raise(tmp_path, tag, why):
    """ZyGo's tag (libavcodec reads 759 bits of ZyGo's own after each I
    picture's header, so cv2 reads other pictures than under H263), Intel
    H.263 (I263) and viv1 (a QuickTime tag libavformat's AVI demuxer
    does not name, so cv2 reads no frame) raise."""
    path = mk.relabel(FILES["h263_avi"], str(tmp_path / "t.avi"), b"H263",
                      tag.encode())
    cap = cv2.VideoCapture(path)
    ok, frame = cap.read()
    cap.release()
    if tag == "viv1":
        assert not ok
    elif why == "ZyGo":
        first = mk.cv2_view(FILES["h263_avi"])[0][0]
        assert int(np.abs(frame.astype(int) - first).max()) > 64
    with pytest.raises(NotImplementedError, match=why):
        native.decode_video(path)


def test_gfid_changes_read_as_cv2(tmp_path):
    """GOB headers' GFID, which libavcodec skips: every GFID of the GOB
    fixture flipped reads as the fixture does."""
    packets = []
    for pkt, _ in native.video_track(FILES["h263_gob_avi"]).packets:
        bits = mk._bits(pkt)
        for m in re.finditer(GBSC, bits[22:]):
            at = 22 + m.end() + 5                    # past GN
            flipped = "".join("1" if c == "0" else "0" for c in
                              bits[at:at + 2])
            bits = bits[:at] + flipped + bits[at + 2:]
        packets.append(mk._bytes(bits)[:len(pkt)])
    assert packets != [p for p, _ in native.video_track(
        FILES["h263_gob_avi"]).packets]
    path = _write(tmp_path, "g.avi", mk.avi_file(packets, 176, 144, 25,
                                                 len(packets), b"T263"))
    np.testing.assert_array_equal(_held(path),
                                  native.decode_video(FILES["h263_gob_avi"]))


def _patched(packets: list[bytes], bit: int, value: str) -> list[bytes]:
    """The second picture's header with `value` written at `bit`."""
    bits = mk._bits(packets[1])
    packets = list(packets)
    packets[1] = mk._bytes(bits[:bit] + value + bits[bit + len(value):])
    return packets


# feature: (encoder or fixture, bit, value, what cv2 makes of it, the
# message); the fixture's second picture has a custom clock (CPCFC and
# ETR) before Annex K's two bits
UNREAD = {
    "Annex E": ("h263", 40, "1", "stops", "arithmetic coding"),
    "Annex G": ("h263", 42, "1", "misreads", "PB-frames"),
    "Annex E (H.263+)": ("h263p", 46, "1", "ignores", "arithmetic coding"),
    "Annex N": ("h263p", 51, "1", "ignores", "reference picture selection"),
    "Annex R": ("h263p", 52, "1", "ignores", "independent segment"),
    "Annex M": ("h263p", 59, "010", "misreads", "improved PB-frames"),
    "Annex O (B)": ("h263p", 59, "011", "misreads", "Annex O"),
    "Annex O (EI)": ("h263p", 59, "100", "stops", "Annex O"),
    "Annex P": ("h263p", 62, "1", "ignores", "resampling"),
    "Annex Q": ("h263p", 63, "1", "ignores", "reduced-resolution"),
    "Annex K (rectangular)": ("h263p_slices_avi", 79, "1", "ignores",
                              "rectangular slices"),
    "Annex K (unordered)": ("h263p_slices_avi", 80, "1", "ignores",
                            "arbitrarily ordered slices"),
}


@pytest.mark.parametrize("feature", list(UNREAD))
def test_unread_annexes_raise_naming_them(tmp_path, feature):
    """What no encoder here writes, in the second picture's header: cv2
    stops at the pictures libavcodec refuses (Annex E in baseline, EI
    pictures), misreads those whose macroblocks it reads as the annex
    has them (PB-frames, B pictures) and ignores the rest (the
    pictures read as if the bit were clear). The port raises for each,
    naming it."""
    enc, bit, value, cv2_does, message = UNREAD[feature]
    if enc in FILES:
        packets = [p for p, _ in native.video_track(FILES[enc]).packets]
        bits = mk._bits(packets[1])
        assert (bits[44], bits[50], bits[bit:bit + len(value)]) == (
            "1", "1", "0" * len(value))          # custom clock, Annex K
    else:
        packets = mk.lavc_encode(mk.moving_frames(5, 4, 144, 176), enc)
    tag = b"H263" if enc == "h263" else b"U263"
    n = len(packets)
    clean = _write(tmp_path, "c.avi", mk.avi_file(packets, 176, 144, 25, n,
                                                  tag))
    path = _write(tmp_path, "p.avi", mk.avi_file(
        _patched(packets, bit, value), 176, 144, 25, n, tag))
    ref, got = mk.cv2_view(clean)[0], mk.cv2_view(path)[0]
    if cv2_does == "stops":
        assert len(got) == 1
    elif cv2_does == "ignores":
        np.testing.assert_array_equal(got, ref)
    else:
        assert len(got) == 4 and int(np.abs(got[1].astype(int)
                                            - ref[1]).max()) > 64
    with pytest.raises(NotImplementedError, match=message):
        native.decode_video(path)


# case: (fixture, how its second picture is cut, the rows cv2 decodes
# before it conceals, the message)
LOST = {
    "H.263 cut at a GOB header": ("h263_gob_avi", "cut", 32,
                                  "no GOB or slice header where a slice"),
    "H.263 GOB header broken": ("h263_gob_avi", "break", 0,
                                "a GOB or slice header where macroblock"),
    "H.261 cut at a GOB header": ("h261_avi", "cut", 48, "a GOB is missing"),
}


@pytest.mark.parametrize("case", list(LOST))
def test_lost_gobs_raise(tmp_path, case):
    """A picture whose macroblocks after a GOB header are lost: cut at the
    header (no header where the slice ends) or with the header's start
    code broken (H.263 resyncs at another macroblock). cv2 reads every
    frame and shows the rows before the loss as decoded and the rest
    concealed (H.263) or left undecoded (H.261); the port raises."""
    name, how, rows, message = LOST[case]
    packets = [p for p, _ in native.video_track(FILES[name]).packets]
    bits = mk._bits(packets[1])
    start = GBSC if name.startswith("h263") else "0" * 15 + "1"
    at = [m.start() for m in re.finditer(start, bits[22:])][1] + 22
    edited = list(packets)
    if how == "cut":
        edited[1] = packets[1][:(at + 7) // 8]
    else:
        edited[1] = mk._bytes(bits[:at + 16] + "0" + bits[at + 17:])
    tag = b"T263" if name.startswith("h263") else b"H261"
    n = len(packets)
    clean = _write(tmp_path, "c.avi", mk.avi_file(packets, 176, 144, 25, n,
                                                  tag))
    path = _write(tmp_path, "l.avi", mk.avi_file(edited, 176, 144, 25, n,
                                                 tag))
    ref, got = mk.cv2_view(clean)[0], mk.cv2_view(path)[0]
    assert len(got) == len(ref)
    np.testing.assert_array_equal(got[1][:rows], ref[1][:rows])
    assert int(np.abs(got[1][rows:].astype(int) - ref[1][rows:]).max()) > 16
    with pytest.raises(ValueError, match=message):
        native.decode_video(path)


@pytest.mark.parametrize("enc", ["h263", "h261"])
def test_size_change_raises(tmp_path, enc):
    """A QCIF stream that goes on at CIF (libavcodec reinitialises)."""
    a = mk.lavc_encode(mk.moving_frames(1, 2, 144, 176), enc)
    b = mk.lavc_encode(mk.moving_frames(1, 2, 288, 352), enc)
    path = _write(tmp_path, "s.avi", mk.avi_file(
        a + b, 176, 144, 25, 4, b"H263" if enc == "h263" else b"H261"))
    with pytest.raises(NotImplementedError, match="another size"):
        native.decode_video(path)


def test_dv_raises_naming_dv(tmp_path):
    """cv2's own DV (dvsd) in Matroska at 720x576: its swscale converts
    none of the frames (what cv2 returns is not the picture), and the
    port names DV."""
    frames = mk.moving_frames(1, 3, 576, 720)
    path = str(tmp_path / "dv.mkv")
    mk.write_cv2(path, "dvsd", 25, frames)
    got = mk.cv2_view(path)[0]
    assert len(got) == 3
    assert float(np.abs(got.astype(int) - frames).mean()) > 20
    track = native.video_track(path, packets=False)
    assert track.codec == "other"
    with pytest.raises(NotImplementedError, match="DV, not read"):
        native.decode_video(path)
