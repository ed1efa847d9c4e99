"""The port's HEVC decoder (csrc/hevc.cpp, through csrc/videodec.cpp and
native.py) on HEVC as phones, cameras and x265 write it, against cv2 and
the JAX package's `_load_frames_video`.

The cases of tests/_torch_make_videos.py's HEVC_CASES and HEVC_CLIPS
(committed in tests/torch_videos/ with cv2's decodes; libx265's streams,
one setting of its medium preset changed in each): Main at its defaults
(WPP, sign hiding, TMVP, SAO, deblocking, a b-pyramid, weightp) in MP4
`hvc1` with ctts and an edit list, in-band parameter sets under `hev1`,
WPP off, two slices under WPP, WPP over 16x16 CTUs, transform skip,
AMP, weighted bi-prediction, the
default scaling lists, CTUs of 32 and 16, open GOPs with RASL pictures,
RADL pictures, intra refresh, constrained intra prediction, temporal
layers, 8 B-frames, no sign hiding and no TMVP, 8x8 transforms, lossless
and CU-lossless coding, Main Still Picture, a conformance window (98x62),
Main 10 at its defaults and with open GOPs, and an `-c copy` cut that
starts at a CRA (its RASL pictures dropped, as libavcodec drops them), in
MP4, Matroska and AVI; the hevc folder's 224x224 clips (a phone's hvc1
MP4 turned 90 degrees beside AAC, and Matroska).

Each goes through `native.video_track` (packets byte for byte against
cv2's `CAP_PROP_FORMAT = -1`, hvcC records through the test's copy of
libavcodec's hevc_mp4toannexb; the count against
`CAP_PROP_FRAME_COUNT`), `native.decode_video` against `cap.read()` (0
levels: HEVC is exact by its specification), and
`load_video_frames`/`load_frames_for` against the JAX package on whole
clips and windows, one of them beginning among the RASL pictures of a
CRA. The 1080p clip chip_smoke.py times is held against cv2's committed
SHA-256 of each frame; three x265 streams written live (8x4 and 4x8
prediction blocks with B-frames, WPP across three slices) against cv2.
Streams written here (their headers bit by bit,
their slice data by the test's CABAC encoder) hold what stays unread:
NotImplementedError naming tiles, PCM samples, long-term references,
dependent slice segments, NAL units of nuh_layer_id 1, the RExt
samplings and depths, the SCC profile and field-coded pictures; the
same writer's plain stream decodes as cv2 decodes it.
"""

import hashlib
import json
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

CASES = list(mk.HEVC_CASES)
ALL = [*CASES, *mk.HEVC_CLIPS]
FILES = {c: mk.path_of(c) for c in ALL}
# whole clips, windows, and one that begins among the RASL pictures of
# the second CRA of a GOP of 8 (frames 5-7 of 16 precede it in output
# order)
WINDOWS = (None, (0.3, 0.6), (0.7, 1.0), (0.35, 0.5))


def hevc_mp4toannexb(track) -> list[bytes]:
    """The packets of an HEVC track in MP4 or Matroska (length-prefixed
    NAL units, hvcC record) as libavcodec's hevc_mp4toannexb gives them
    to cv2: every unit after a 4-byte start code; the record's parameter
    sets before the first parameter set or IRAP slice of a packet that
    holds an IRAP picture."""
    cfg = track.config
    n_len = (cfg[21] & 3) + 1
    extradata, p = b"", 23
    for _ in range(cfg[22]):
        count = int.from_bytes(cfg[p + 1:p + 3], "big")
        p += 3
        for _ in range(count):
            size = int.from_bytes(cfg[p:p + 2], "big")
            extradata += b"\0\0\0\1" + cfg[p + 2:p + 2 + size]
            p += 2 + size
    out = []
    for data, _ in track.packets:
        units, q = [], 0
        while q < len(data):
            size = int.from_bytes(data[q:q + n_len], "big")
            units.append(data[q + n_len:q + n_len + size])
            q += n_len + size
        kinds = [mk.hevc_type(u) for u in units]
        pending = any(16 <= k <= 23 for k in kinds)
        pkt = b""
        for unit, kind in zip(units, kinds):
            if pending and (32 <= kind <= 34 or 16 <= kind <= 23):
                pkt += extradata
                pending = False
            pkt += b"\0\0\0\1" + unit
        out.append(pkt)
    return out


@pytest.mark.parametrize("name", ALL)
def test_packets_and_count_match_cv2(name):
    path = FILES[name]
    track = native.video_track(path)
    got = [p for p, _ in track.packets]
    if track.config:
        got = hevc_mp4toannexb(track)
    assert got == mk.cv2_packets(path)
    cap = cv2.VideoCapture(path)
    assert track.count == int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    assert (track.width, track.height) == (
        int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
        int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)))
    assert track.codec == "hevc" and track.packets[0][1]


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
    for window in WINDOWS[1::2]:
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


@pytest.mark.parametrize("name", ["hevc_cracut_mp4", "hevc_cracut_mkv"])
def test_cra_cut_drops_its_rasl_pictures(name):
    """A cut that starts at a CRA: the container counts every packet,
    cv2 reads all but the RASL pictures, whose references precede the
    cut (libavcodec's NoRaslOutputFlag), and so does the port."""
    track = native.video_track(FILES[name])
    kinds = [mk.hevc_type(u) for p in hevc_mp4toannexb(track)
             for u in mk.nal_units(p) if mk.hevc_type(u) < 32]
    rasl = sum(k in (8, 9) for k in kinds[:kinds.index(21, 1)])
    assert kinds[0] == 21 and rasl == 3
    frames, count = mk.cv2_view(FILES[name])
    assert (len(frames), count) == (16, 19) == (len(track.packets) - rasl,
                                               track.count)
    assert native.decode_video(FILES[name]).shape[0] == 16


def test_1080p_frames_are_cv2s():
    """hevc_1080p.mp4 (4 frames at 1920x1080): the port's frames against
    cv2's SHA-256 committed beside it, and cv2's own."""
    path = os.path.join(mk.FIXTURES, mk.HEVC_1080P)
    with open(os.path.join(mk.FIXTURES, mk.HEVC_1080P_SHA)) as f:
        ref = json.load(f)
    got = native.decode_video(path)
    assert list(got.shape) == ref["shape"] == [4, 1080, 1920, 3]
    assert [hashlib.sha256(g.tobytes()).hexdigest() for g in got] == \
        ref["sha256"]
    frames, count = mk.cv2_view(path)
    assert count == ref["count"]
    assert [hashlib.sha256(g.tobytes()).hexdigest() for g in frames] == \
        ref["sha256"]


# x265 settings written live (libx265 through libavcodec 59): 8x4 and
# 4x8 prediction blocks with B-frames, where a bi-predictive merge
# candidate is cut to list 0 (rect and AMP partitions at 8x8 CUs), and
# WPP across three slices of 16x16 CTUs
LIVE = {"rectamp": dict(params="rect=1:amp=1:bframes=8:b-adapt=0:ref=4",
                        size=(128, 192)),
        "rect16": dict(params="rect=1:ctu=16:bframes=4:b-adapt=0",
                       size=(64, 96)),
        "wppslices": dict(params=mk.HEVC_WPP + ":ctu=16:slices=3",
                          size=(96, 128))}


@pytest.mark.parametrize("name", LIVE)
def test_live_x265_streams_match_cv2(tmp_path, name):
    try:
        import ctypes

        ctypes.CDLL("libx265.so.199")
    except OSError:
        pytest.skip("libx265.so.199 is not installed")
    settings = LIVE[name]
    aus = mk.hevc_stream(settings, seed=3)
    h, w = settings["size"]
    path = str(tmp_path / "x.avi")
    with open(path, "wb") as f:
        f.write(mk.hevc_file(aus, w, h, "avi"))
    ref, _ = mk.cv2_view(path)
    got = native.decode_video(path)
    assert got.shape == ref.shape == (16, h, w, 3)
    assert int(np.abs(got.astype(int) - ref).max()) == 0


def test_main10_streams_are_10_bit():
    """lavc_encode's yuv420p10le frames give libx265's Main 10: the
    SPS's bit depths are 10, general_profile_idc 2."""
    for name in ("hevc_main10_mp4", "hevc_main10gop_mkv"):
        cfg = native.video_track(FILES[name]).config
        assert cfg[1] & 31 == 2                 # general_profile_idc
        units, p = {}, 23
        for _ in range(cfg[22]):                # one unit an array
            size = int.from_bytes(cfg[p + 3:p + 5], "big")
            units[cfg[p] & 63] = cfg[p + 5:p + 5 + size]
            p += 5 + size
        r = mk.BitReader("".join(f"{b:08b}" for b in
                                 mk.hevc_rbsp(units[33])))
        r.u(4 + 3 + 1 + 96)
        r.ue()
        assert r.ue() == 1                      # 4:2:0
        r.ue()
        r.ue()
        if r.u(1):
            for _ in range(4):
                r.ue()
        assert (r.ue(), r.ue()) == (2, 2)


# ---- streams written here ------------------------------------------------

# rangeTabLps and the state transitions of the arithmetic coder (Tables
# 9-46 and 9-47 of ITU-T H.265, the same as H.264's)
RANGE_LPS = [
    (128, 176, 208, 240), (128, 167, 197, 227), (128, 158, 187, 216),
    (123, 150, 178, 205), (116, 142, 169, 195), (111, 135, 160, 185),
    (105, 128, 152, 175), (100, 122, 144, 166), (95, 116, 137, 158),
    (90, 110, 130, 150), (85, 104, 123, 142), (81, 99, 117, 135),
    (77, 94, 111, 128), (73, 89, 105, 122), (69, 85, 100, 116),
    (66, 80, 95, 110), (62, 76, 90, 104), (59, 72, 86, 99),
    (56, 69, 81, 94), (53, 65, 77, 89), (51, 62, 73, 85), (48, 59, 69, 80),
    (46, 56, 66, 76), (43, 53, 63, 72), (41, 50, 59, 69), (39, 48, 56, 65),
    (37, 45, 54, 62), (35, 43, 51, 59), (33, 41, 48, 56), (32, 39, 46, 53),
    (30, 37, 43, 50), (29, 35, 41, 48), (27, 33, 39, 45), (26, 31, 37, 43),
    (24, 30, 35, 41), (23, 28, 33, 39), (22, 27, 32, 37), (21, 26, 30, 35),
    (20, 24, 29, 33), (19, 23, 27, 31), (18, 22, 26, 30), (17, 21, 25, 28),
    (16, 20, 23, 27), (15, 19, 22, 25), (14, 18, 21, 24), (14, 17, 20, 23),
    (13, 16, 19, 22), (12, 15, 18, 21), (12, 14, 17, 20), (11, 14, 16, 19),
    (11, 13, 15, 18), (10, 12, 15, 17), (10, 12, 14, 16), (9, 11, 13, 15),
    (9, 11, 12, 14), (8, 10, 12, 14), (8, 9, 11, 13), (7, 9, 11, 12),
    (7, 9, 10, 12), (7, 8, 10, 11), (6, 8, 9, 11), (6, 7, 9, 10),
    (6, 7, 8, 9), (2, 2, 2, 2)]
TRANS_LPS = [0, 0, 1, 2, 2, 4, 4, 5, 6, 7, 8, 9, 9, 11, 11, 12, 13, 13, 15,
             15, 16, 16, 18, 18, 19, 19, 21, 21, 22, 22, 23, 24, 24, 25, 26,
             26, 27, 27, 28, 29, 29, 30, 30, 30, 31, 32, 32, 33, 33, 33, 34,
             34, 35, 35, 35, 36, 36, 36, 37, 37, 37, 38, 38, 63]
# initValue of the contexts an intra CTU of these streams codes, for I
# slices (Tables 9-5 to 9-37): split_cu_flag ctxInc 0,
# prev_intra_luma_pred_flag, intra_chroma_pred_mode, cbf_cb/cbf_cr ctxInc
# 0, cbf_luma ctxInc 1
INIT = {"split": 139, "prev_intra": 184, "chroma": 63, "cbf_c": 94,
        "cbf_y": 141}


class CabacWriter:
    """The arithmetic encoder of ITU-T H.265 9.3.5 (EncodeDecision,
    EncodeBypass, EncodeTerminate and EncodeFlush), bits as a string."""

    def __init__(self, qp: int = 26):
        self.low, self.range, self.outstanding = 0, 510, 0
        self.first, self.bits = True, []
        self.state = {}
        for k, v in INIT.items():
            m, n = (v >> 4) * 5 - 45, ((v & 15) << 3) - 16
            pre = min(max(((m * qp) >> 4) + n, 1), 126)
            self.state[k] = (63 - pre, 0) if pre <= 63 else (pre - 64, 1)

    def _put(self, b):
        if self.first:
            self.first = False
        else:
            self.bits.append(str(b))
        self.bits.extend(str(1 - b) * self.outstanding)
        self.outstanding = 0

    def _renorm(self):
        while self.range < 256:
            if self.low < 256:
                self._put(0)
            elif self.low >= 512:
                self.low -= 512
                self._put(1)
            else:
                self.low -= 256
                self.outstanding += 1
            self.range <<= 1
            self.low <<= 1

    def decision(self, ctx: str, b: int):
        p, mps = self.state[ctx]
        lps = RANGE_LPS[p][(self.range >> 6) & 3]
        self.range -= lps
        if b != mps:
            self.low += self.range
            self.range = lps
            if p == 0:
                mps = 1 - mps
            p = TRANS_LPS[p]
        else:
            p = min(p + 1, 62)
        self.state[ctx] = (p, mps)
        self._renorm()

    def bypass(self, b: int):
        self.low <<= 1
        if b:
            self.low += self.range
        if self.low >= 1024:
            self._put(1)
            self.low -= 1024
        elif self.low < 512:
            self._put(0)
        else:
            self.low -= 512
            self.outstanding += 1

    def terminate(self, b: int) -> str:
        self.range -= 2
        if not b:
            self._renorm()
            return ""
        self.low += self.range
        self.range = 2
        self._renorm()
        self._put((self.low >> 9) & 1)
        self.bits.append(format(((self.low >> 7) & 3) | 1, "02b"))
        out = "".join(self.bits)
        return out + "0" * (-len(out) % 8)


def intra_ctu(w: CabacWriter, pcm: bool | None = None):
    """One 16x16 CTU of an I slice: an intra 2Nx2N CU (planar, chroma as
    luma) without residual; where PCM is allowed (`pcm` not None), its
    pcm_flag, 1 for a PCM CU (its samples not written)."""
    w.decision("split", 0)                       # split_cu_flag
    if pcm is not None:
        w.terminate(int(pcm))                    # pcm_flag
    if pcm:
        return
    w.decision("prev_intra", 1)                  # prev_intra_luma_pred_flag
    w.bypass(0)                                  # mpm_idx 0
    w.decision("chroma", 0)                      # intra_chroma_pred_mode 4
    w.decision("cbf_c", 0)                       # cbf_cb
    w.decision("cbf_c", 0)                       # cbf_cr
    w.decision("cbf_y", 0)                       # cbf_luma


def hevc_nal(kind: int, bits: str, layer: int = 0) -> bytes:
    """An HEVC NAL unit of nal_unit_type `kind` (TemporalId 0) from RBSP
    bits with their trailing bits, emulation prevention put in."""
    bits += "1" + "0" * (-(len(bits) + 1) % 8)
    return bytes([kind << 1 | layer >> 5]) + mk.nal_unit(
        (layer & 31) << 3 | 1, bits)


def ptl(profile: int) -> str:
    """profile_tier_level of one sub-layer: Main tier, level 3.1."""
    compat = format(1 << (31 - profile) if profile < 32 else 0, "032b")
    return "000" + format(profile, "05b") + compat + "1000" + "0" * 44 + \
        format(93, "08b")


def vps() -> bytes:
    u = mk.ue_bits
    return hevc_nal(32, "0000" + "11" + "000000" + "000" + "1" + "1" * 16
                    + ptl(1) + "1" + u(0) + u(0) + u(0) + "000000" + u(0)
                    + "0" + "0")


def sps(w: int = 16, h: int = 16, chroma: int = 1, depth: int = 8,
        profile: int = 1, pcm: bool = False, long_term: bool = False,
        field: bool = False) -> bytes:
    """An SPS of 16x16 CTBs, 8x8 minimum CUs, transforms of 4 to 16, no
    SAO, AMP or scaling lists, no RPS of its own."""
    u = mk.ue_bits
    b = "0000" + "000" + "1" + ptl(profile) + u(0) + u(chroma)
    if chroma == 3:
        b += "0"
    b += u(w) + u(h) + "0" + u(depth - 8) + u(depth - 8) + u(4) + "1" + \
        u(0) + u(0) + u(0) + u(0) + u(1) + u(0) + u(2) + u(0) + u(0)
    b += "0" + "0" + "0"                         # scaling, amp, sao
    b += "1" + "0111" + "0111" + u(0) + u(1) + "1" if pcm else "0"
    b += u(0) + ("1" + u(0) if long_term else "0") + "0" + "0"
    if field:                                    # a VUI, field_seq_flag 1
        b += "1" + "0" * 5 + "1" + "0" * 4
    else:
        b += "0"
    return hevc_nal(33, b + "0")


def pps(tiles: bool = False, dependent: bool = False) -> bytes:
    u = mk.ue_bits
    b = u(0) + u(0) + ("1" if dependent else "0") + "0" + "000" + "0" + \
        "0" + u(0) + u(0) + mk.se_bits(0) + "0" + "0" + "0" + \
        mk.se_bits(0) + mk.se_bits(0) + "0" + "0" + "0" + "0"
    b += "1" if tiles else "0"
    b += "0"                                     # entropy_coding_sync
    if tiles:
        b += u(1) + u(0) + "1" + "1"
    b += "0" + "1" + "0" + "1"                   # deblocking disabled
    b += "0" + "0" + u(0) + "0" + "0"
    return hevc_nal(34, b)


def islice(kind: int = 19, first: bool = True, address: int = 0,
           ctbs: int = 1, dependent: bool = False, long_term: bool = False,
           pcm: bool | None = None, data: bool = True,
           layer: int = 0) -> bytes:
    """An I slice segment (IDR_W_RADL by default; a CRA with POC LSB 0 and
    an empty RPS, a long-term picture when `long_term`) of the first or a
    later segment at CTB `address` of a picture of `ctbs` CTBs; `pcm` as
    intra_ctu's."""
    u = mk.ue_bits
    b = ("1" if first else "0") + "0" + u(0)
    if not first:
        if dependent:
            return hevc_nal(kind, b + "1" + "0" * 8, layer)
        b += format(address, f"0{max((ctbs - 1).bit_length(), 1)}b")
    b += u(2)                                    # slice_type I
    if kind not in (19, 20):
        b += "0" * 8 + "0" + u(0) + u(0)         # POC LSB, st RPS
        if long_term:
            b += u(1)                            # num_long_term_pics
    b += mk.se_bits(0)                           # slice_qp_delta
    b += "1"
    b += "0" * (-len(b) % 8)
    if data:
        w = CabacWriter()
        intra_ctu(w, pcm)
        b += "".join(w.bits) if pcm else w.terminate(1)
    return _slice_nal(kind, b, layer)


def _slice_nal(kind: int, bits: str, layer: int) -> bytes:
    """A slice NAL unit from its bits (already byte-aligned: the slice
    data's CABAC flush wrote its stop bit)."""
    bits += "0" * (-len(bits) % 8)
    return bytes([kind << 1 | layer >> 5]) + mk.nal_unit(
        (layer & 31) << 3 | 1, bits)


def written(tmp_path, *units, w=16, h=16, name="x.avi") -> str:
    """An AVI (fourcc HEVC) of one packet: VPS and the units."""
    path = str(tmp_path / name)
    packet = b"".join(b"\0\0\0\1" + u for u in (vps(), *units))
    with open(path, "wb") as f:
        f.write(mk.avi_file([packet], w, h, 25, 1, b"HEVC"))
    return path


def test_written_stream_decodes_as_cv2_does(tmp_path):
    """The writer's plain stream (an IDR picture of one CTU, planar from
    absent neighbours) and a picture of two slices: the port's frames
    are cv2's."""
    for units, w in (((sps(), pps(), islice()), 16),
                     ((sps(32), pps(), islice(ctbs=2),
                       islice(first=False, address=1, ctbs=2)), 32)):
        path = written(tmp_path, *units, w=w)
        ref, _ = mk.cv2_view(path)
        got = native.decode_video(path)
        assert got.shape == ref.shape == (1, 16, w, 3)
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("what,units,w", [
    ("HEVC tiles", lambda: (sps(32), pps(tiles=True), islice(ctbs=2)), 32),
    ("HEVC PCM samples",
     lambda: (sps(pcm=True), pps(), islice(pcm=True)), 16),
    ("HEVC long-term reference pictures",
     lambda: (sps(long_term=True), pps(), islice(21, long_term=True)), 16),
    ("HEVC dependent slice segments",
     lambda: (sps(32), pps(dependent=True), islice(ctbs=2),
              islice(first=False, ctbs=2, dependent=True, data=False)), 32),
    ("HEVC NAL units of nuh_layer_id > 0",
     lambda: (sps(), pps(), islice(), islice(layer=1)), 16),
    ("HEVC 4:2:2", lambda: (sps(chroma=2, profile=4), pps(), islice()), 16),
    ("HEVC 4:4:4", lambda: (sps(chroma=3, profile=4), pps(), islice()), 16),
    ("HEVC 4:0:0", lambda: (sps(chroma=0, profile=4), pps(), islice()), 16),
    ("HEVC at 12 bits", lambda: (sps(depth=12, profile=4), pps(), islice()),
     16),
    ("HEVC profile_idc 9", lambda: (sps(profile=9), pps(), islice()), 16),
    ("HEVC field-coded pictures",
     lambda: (sps(field=True), pps(), islice()), 16),
])
def test_unread_tools_raise_naming_them(tmp_path, what, units, w):
    """What nothing here writes raises NotImplementedError naming it, at
    its first use (PCM at a CU's pcm_flag, long-term pictures at a slice
    that names one), never a fallback or a grey picture."""
    path = written(tmp_path, *units(), w=w)
    for read in (native.decode_video,
                 lambda p: native.load_video_frames(p, 4, 16)):
        with pytest.raises(NotImplementedError, match=re.escape(what)):
            read(path)


def test_tools_allowed_but_unused_are_read(tmp_path):
    """An SPS that allows PCM and long-term pictures, a RExt profile_idc
    at 4:2:0 8-bit without its tools (as libx265 labels intra-only
    streams): read as cv2 reads them."""
    for units in ((sps(pcm=True, long_term=True), pps(), islice(pcm=False)),
                  (sps(profile=4), pps(), islice())):
        path = written(tmp_path, *units)
        ref, _ = mk.cv2_view(path)
        np.testing.assert_array_equal(native.decode_video(path), ref)
