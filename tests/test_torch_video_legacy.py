"""The port's H.263-family reader (csrc/msmpeg4.cpp, routed by
csrc/videodec.cpp and native.py) on video as old AVIs and OpenCV's writer
store it, against cv2 and the JAX package's `load_frames_for`.

The cases of tests/_torch_make_videos.py's LEGACY_CASES and LEGACY_CLIPS
(committed in tests/torch_videos/ with cv2's decodes): MS-MPEG4 v2 (MP42,
DIV2), MS-MPEG4 v3 (MP43, DIV3, MPG3, DIV4, DIV5, DIV6, AP41, COL1; and
Matroska's V_MPEG4/MS/V3), WMV1, WMV2 and Sorenson H.263 (FLV1) from the
system's libavcodec 59 at fine and coarse quantisers, on noise and at
odd sizes, with every run-level table v3's and WMV1's encoder picks, WMV1's
inter-intra prediction, WMV2's coded block pattern tables and loop
filter, FLV1's 8- and 16-bit picture sizes; slices, WMV2 skip maps,
pictures that skip every macroblock and disposable FLV1 pictures written
into the headers; pictures written symbol by symbol (mk.msmpeg4_syntax:
what the encoders never write, every table and escape, WMV2's mspel,
ABT, top-left prediction and partial skip maps); saturated colours (the
no-round half-pel averaging of zero chroma); and cv2.VideoWriter's own
files, in AVI and Matroska.
Each goes through `native.video_track` (packets byte for byte against
cv2's `CAP_PROP_FORMAT = -1`, the count, the size), `native.decode_video`
against `cap.read()` and the committed decode (0 levels), and both
packages' `load_frames_for` (0.0) over three windows. Beside them: the
headers that make each case what it is named for, every fourcc cv2
writes of the family written live, and the variants still unread
(MS-MPEG4 v1, WMV2's J-frames, a FLV1 picture of another size) raising
NotImplementedError by name.
"""

import os
import sys

import numpy as np
import pytest

from viai_tpu.data import av as j_av
from viai_tpu_torch import native
from viai_tpu_torch.data import av

cv2 = pytest.importorskip("cv2")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_make_videos as mk  # noqa: E402

ALL = [*mk.LEGACY_CASES, *mk.LEGACY_CLIPS]
FILES = {c: mk.path_of(c) for c in ALL}
WINDOWS = ((0.0, 1.0), (0.3, 0.6), (0.9, 1.0))


def _write(tmp_path, name: str, data: bytes) -> str:
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    return path


def _held(path: str) -> np.ndarray:
    """The port's track and frames against cv2's packets, count, size and
    frames; → the frames."""
    track = native.video_track(path)
    assert track.codec == "h263"
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
    ref = np.load(os.path.join(mk.FIXTURES, name + ".npz"))
    assert got.shape[0] == int(ref["n"])
    np.testing.assert_array_equal(got[ref["index"]], ref["frames"])
    assert int(ref["count"]) == native.video_track(FILES[name]).count


@pytest.mark.parametrize("name", ALL)
def test_load_frames_match_jax(name):
    """Both packages' windows; where cv2 reads fewer frames than it counts
    (pictures that give none) and a window lies past them, both raise."""
    stem = os.path.splitext(FILES[name])[0]
    for window in WINDOWS:
        try:
            ref = j_av.load_frames_for(stem, 16, 32, window)
        except ValueError:
            with pytest.raises(ValueError, match="no frames"):
                av.load_frames_for(stem, 16, 32, window)
            continue
        got = av.load_frames_for(stem, 16, 32, window)
        assert got.shape == ref.shape and got.dtype == np.float32
        assert float(np.abs(got - ref).max()) == 0.0, window


class _Bits:
    def __init__(self, data: bytes):
        self.bits, self.pos = "".join(f"{b:08b}" for b in data), 0

    def get(self, n: int) -> int:
        v = int(self.bits[self.pos:self.pos + n] or "0", 2)
        self.pos += n
        return v

    def get012(self) -> int:
        return self.get(1) and 1 + self.get(1)


def _pictures(name: str) -> list[dict]:
    """The picture headers of a v3, WMV1 or WMV2 case's packets."""
    enc, _, opts = mk.LEGACY_CASES[name]
    if enc == "syntax":
        enc = {"v3": "msmpeg4"}.get(opts["variant"], opts["variant"])
    track = native.video_track(FILES[name])
    out, rate = [], 0
    for pkt, _ in track.packets:
        b = _Bits(pkt)
        if enc == "wmv2":
            kind = "IP"[b.get(1)]
            if kind == "I":
                b.get(7)
            h = dict(kind=kind, q=b.get(5))
            if kind == "P":
                h["skip"] = b.get(2)
            out.append(h)
            continue
        kind, q = "IP"[b.get(2)], b.get(5)
        h = dict(kind=kind, q=q)
        if kind == "I":
            h["slices"] = b.get(5) - 0x16
            per_mb = False
            if enc == "wmv1":
                b.get(5)
                rate = b.get(11) * 1024
                b.get(1)
                per_mb = rate > 50 * 1024 and b.get(1)
            h["rl_chroma"], h["rl"] = (-1, -1) if per_mb else (b.get012(),
                                                               b.get012())
            h["dc"] = b.get(1)
        else:
            b.get(1)
            per_mb = enc == "wmv1" and rate > 50 * 1024 and b.get(1)
            h["rl"] = -1 if per_mb else b.get012()
            h["dc"], h["mv"] = b.get(1), b.get(1)
        h["rate"] = rate
        out.append(h)
    return out


def test_fixtures_hold_what_they_are_named_for():
    """The tables and modes each case is there for, from its headers:
    v3's and WMV1's P pictures pick each of the three run-level tables
    (so intra luma tables 0-2 and inter tables 3-5 are all read), WMV1's
    inter-intra case runs at 128 kbit/s or less, WMV2's quantisers pick
    each coded block pattern table, the slices, skip maps and disposable
    pictures written in."""
    for enc in ("msmpeg4", "wmv1"):
        rls = {h["rl"] for n, (e, _, _) in mk.LEGACY_CASES.items()
               if e == enc for h in _pictures(n) if h["kind"] == "P"}
        assert rls == {0, 1, 2}, enc            # no per-macroblock tables
    assert 0 < _pictures("wmv1_ii_avi")[0]["rate"] <= 128 * 1024
    assert {min(2, (h["q"] > 10) + (h["q"] > 20))
            for n in ("wmv2_avi", "wmv2_q15_mkv", "wmv2_q31_avi")
            for h in _pictures(n) if h["kind"] == "P"} == {0, 1, 2}
    assert {h["slices"] for h in _pictures("msmpeg4_slices_avi")
            if h["kind"] == "I"} == {3}
    assert {h["slices"] for h in _pictures("wmv1_slices_avi")
            if h["kind"] == "I"} == {2}
    for t in (1, 2, 3):
        name = [n for n in ALL if n.startswith(f"wmv2_skipmap{t}")][0]
        assert {h["skip"] for h in _pictures(name) if h["kind"] == "P"} \
            == {t}
    for name, loop, code in (("wmv2_avi", "0", 1), ("wmv2_loop_avi", "1", 1),
                             ("wmv2_slices_avi", "0", 3)):
        data = open(FILES[name], "rb").read()
        bits = mk._bits(data[data.index(b"strf") + 48:][:4])
        assert bits[17] == loop and int(bits[22:25], 2) == code, name
    assert len(mk.cv2_view(FILES["wmv2_skipall_avi"])[0]) == 8
    assert len(mk.cv2_view(FILES["flv_disposable_avi"])[0]) == 9
    # msmpeg4_syntax's pictures: what the encoders never write
    syntax = {n: _pictures(n) for n, (e, _, _) in mk.LEGACY_CASES.items()
              if e == "syntax"}
    for variant in ("v3", "wmv1"):
        hs = [h for n, p in syntax.items()
              if mk.LEGACY_CASES[n][2]["variant"] == variant for h in p]
        assert {h["dc"] for h in hs} == {0, 1}, variant
        assert {h["mv"] for h in hs if h["kind"] == "P"} == {0, 1}, variant
        # every picture table (−1: chosen a macroblock, WMV1 above 50
        # kbit/s)
        assert {h["rl"] for h in hs} == ({-1, 0, 1, 2} if variant == "wmv1"
                                         else {0, 1, 2}), variant
    assert {h["slices"] for h in syntax["msmpeg4_syntax_avi"]
            if h["kind"] == "I"} == {2}
    assert {h["skip"] for n in ("wmv2_syntax_avi", "wmv2_syntaxq_mkv",
                                "wmv2_syntaxnoabt_avi")
            for h in syntax[n] if h["kind"] == "P"} == {0, 1, 2, 3}


@pytest.mark.parametrize("variant,tag", [("v3", b"DIV3"), ("wmv1", b"WMV1"),
                                         ("wmv2", b"WMV2")])
@pytest.mark.parametrize("seed", range(4))
def test_syntax_streams_read_as_cv2_reads_them(tmp_path, variant, tag, seed):
    """msmpeg4_syntax's random pictures, written live (what the encoders
    never write: every table by picture, escapes of every kind, WMV1's
    per-macroblock tables and inter-intra prediction, WMV2's mspel, ABT,
    top-left prediction, skip maps and loop filter), at an odd number of
    macroblock rows and columns, against cv2."""
    modes = {"q": (3, 9, 17, 28)[seed], "slices": 1 + seed % 2,
             "loop": seed % 2}
    if variant == "wmv1":
        modes["bitrate"] = (30, 100, 200, 60)[seed] * 1024
    packets, extra = mk.msmpeg4_syntax(variant, 80, 48, 6, 100 + seed,
                                       gop=3, **modes)
    path = _write(tmp_path, "s.avi", mk.avi_file(
        packets, 80, 48, 25, len(packets), tag, extradata=extra))
    assert _held(path).shape == (6, 48, 80, 3)


@pytest.mark.parametrize("fourcc", ["MP42", "DIV2", "MP43", "DIV3",
                                    "DIV4", "WMV1", "WMV2", "FLV1"])
def test_cv2_writes_the_family_live(tmp_path, fourcc):
    """cv2.VideoWriter's own files of each fourcc of the family it
    writes, in AVI and Matroska, at an odd size (which it rounds to
    even for some)."""
    frames = mk.moving_frames(len(fourcc), 5, 37, 54)
    for ext in ("avi", "mkv"):
        path = str(tmp_path / f"t.{ext}")
        mk.write_cv2(path, fourcc, 25, frames)
        if len(mk.cv2_view(path)[0]) == 0:
            continue
        _held(path)


def _relabel(path: str, out: str, old: bytes, new: bytes) -> str:
    data = open(path, "rb").read()
    assert data.count(old) >= 2
    with open(out, "wb") as f:
        f.write(data.replace(old, new))
    return out


@pytest.mark.parametrize("tag", ["MPG4", "MP41", "DIV1"])
def test_msmpeg4_v1_raises(tmp_path, tag):
    """MS-MPEG4 v1, which no encoder here writes: its tags on a v2 AVI."""
    path = _relabel(FILES["msmpeg4v2_avi"], str(tmp_path / "v1.avi"),
                    b"MP42", tag.encode())
    with pytest.raises(NotImplementedError, match="MS-MPEG4 v1"):
        native.decode_video(path)
    with pytest.raises(NotImplementedError, match="MS-MPEG4 v1"):
        native.load_video_frames(path, 4, 16)


def test_wmv2_j_frame_raises(tmp_path):
    """A WMV2 I picture flagged a J-frame (IntraX8): the bit after its
    quantiser, which the encoder's extradata allows (j_type_bit)."""
    frames = mk.moving_frames(3, 3, 32, 48)
    info = {}
    packets = mk.lavc_encode(frames, "wmv2", info=info)
    bits = mk._bits(packets[0])
    assert bits[0] == "0" and bits[13] == "0"
    packets[0] = mk._bytes(bits[:13] + "1" + bits[14:])
    path = _write(tmp_path, "j.avi", mk.avi_file(
        packets, 48, 32, 25, 3, b"WMV2", extradata=info["extradata"]))
    with pytest.raises(NotImplementedError, match="J-frame"):
        native.decode_video(path)


def test_flv1_size_change_raises(tmp_path):
    """FLV1 pictures carry their size; one that changes it mid-stream
    raises (libavcodec reinitialises at the new size)."""
    a = mk.lavc_encode(mk.moving_frames(1, 2, 32, 48), "flv")
    b = mk.lavc_encode(mk.moving_frames(1, 2, 48, 64), "flv")
    path = _write(tmp_path, "s.avi", mk.avi_file(a + b, 48, 32, 25, 4,
                                                 b"FLV1"))
    with pytest.raises(NotImplementedError, match="another size"):
        native.decode_video(path)
