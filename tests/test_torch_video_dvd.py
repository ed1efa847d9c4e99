"""The port's MPEG-1/2 decoder (csrc/mpeg12.cpp, through csrc/videodec.cpp
and native.py) on MPEG-1 and MPEG-2 video as DVD rips, broadcast
captures and OpenCV's own writer store it, against cv2 and the JAX
package's `_load_frames_video`.

The cases of tests/_torch_make_videos.py's DVD_CASES and DVD_CLIPS
(committed in tests/torch_videos/ with cv2's decodes; the system's
libavcodec 59 mpeg2video and mpeg1video streams, their headers patched
where the encoder does not write a field), each in AVI, MP4 and
Matroska:

  * MPEG-2 Main Profile with and without B-pictures (low_delay 0: one
    picture held back), open and closed GOPs, intra_vlc_format, the
    non-linear quantiser scale, intra_dc_precision 9, 10 and 11, loaded
    matrices, a sequence display extension with BT.709 (whose matrix
    cv2's swscale follows), 4:2:2 with and without the chroma matrices
    of a quant matrix extension, odd sizes, soft telecine (3:2 pulldown
    flags on progressive_sequence 0), a second sequence at another size,
    a copy cut at an open GOP (its leading B-pictures skipped, as
    libavcodec skips them without their older reference),
    and frame_pred_frame_dct 0 in progressive frames (field and frame
    DCT and motion by macroblock; the alternate scan);
  * MPEG-1 with B-pictures and at an odd size;
  * the two clips chip_smoke.py's `dvd` folder trains from: MPEG-2 at
    720x480 as MakeMKV stores a DVD film title, MPEG-1 at 352x240 as
    cv2.VideoWriter writes it under PIM1.

Each goes through `native.video_track` (packets byte for byte against
cv2's `CAP_PROP_FORMAT = -1`, the count against `CAP_PROP_FRAME_COUNT`)
and `native.decode_video` against `cap.read()` and the committed decode
(0 levels); the ones with GOPs of several kinds through
`load_video_frames`/`load_frames_for` against the JAX package at the
same bound, for windows that start inside open and closed GOPs. Beside
them: the headers each fixture is named for, the riff and QuickTime tags
cv2 reads as MPEG-1/2, a sequence end code as a packet of its own and
at the end of the last one, sequence headers in the container alone,
an open GOP flagged broken_link (no starting point: libavcodec decodes
its B-pictures), and NotImplementedError naming what is not read
(interlaced pictures, field pictures, D-pictures, full-pel vectors,
scalable extensions, 4:4:4).
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

ALL = [*mk.DVD_CASES, *mk.DVD_CLIPS]
FILES = {c: mk.path_of(c) for c in ALL}
# Windows inside the GOPs (24 frames; mpeg2_bf's open GOPs show their
# I-pictures at 0, 9, 15 and 21, mpeg2_cgop's closed ones at 0, 7, 14
# and 21).
WINDOWS = (None, (0.3, 0.6), (0.45, 0.8), (0.7, 1.0), (0.35, 0.4))
GOPS = ["mpeg2_bf_avi", "mpeg2_bf_mp4", "mpeg2_bf_mkv", "mpeg2_cgop_avi",
        "mpeg2_cgop_mp4", "mpeg2_cgop_mkv", "mpeg2_newsize_avi",
        "mpeg2_telecine_mkv", "mpeg2_ip_mp4", "mpeg1_bf_avi",
        "mpeg2_cut_avi", "mpeg2_cut_mp4", "mpeg2_cut_mkv",
        *mk.DVD_CLIPS]
RIFF_TAGS = ("mpg1", "mpg2", "MPEG", "PIM1", "PIM2", "MPG2", "mpgv", "EM2V",
             "MMES")


def _stream(seed: int = 3, **settings):
    return mk.dvd_stream(settings, seed=seed)


def _write(tmp_path, name: str, data: bytes) -> str:
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    return path


def _held(path: str):
    """The port's track and frames against cv2's packets, count, size and
    frames; → the frames."""
    track = native.video_track(path)
    assert [p for p, _ in track.packets] == mk.cv2_packets(path)
    cap = cv2.VideoCapture(path)
    assert track.count == int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    assert (track.width, track.height) == (
        int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
        int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)))
    cap.release()
    assert track.codec == "mpeg12"
    got = native.decode_video(path)
    ref, _ = mk.cv2_view(path)
    assert got.shape == ref.shape and got.dtype == np.uint8
    err = int(np.abs(got.astype(int) - ref).max())
    print(f"{os.path.basename(path)}: {len(ref)} frames, max |Δ| {err}")
    assert err == 0
    return got


def _loads_as_jax(path: str, windows=WINDOWS) -> None:
    worst = 0.0
    for n in (4, 16, 40):
        for window in windows:
            ref = j_av._load_frames_video(path, n, 32, window)
            got = native.load_video_frames(path, n, 32, window)
            assert got.shape == ref.shape and got.dtype == np.float32
            worst = max(worst, float(np.abs(got - ref).max()))
    print(f"{os.path.basename(path)}: max |Δ| {worst * 255:.3f} / 255")
    assert worst == 0.0


@pytest.mark.parametrize("name", ALL)
def test_track_and_frames_match_cv2(name):
    got = _held(FILES[name])
    ref = np.load(os.path.join(mk.FIXTURES, name + ".npz"))
    assert got.shape[0] == int(ref["n"])
    np.testing.assert_array_equal(got[ref["index"]], ref["frames"])
    cap = cv2.VideoCapture(FILES[name])
    assert int(ref["count"]) == int(cap.get(cv2.CAP_PROP_FRAME_COUNT))


@pytest.mark.parametrize("name", GOPS)
def test_load_frames_match_jax(name):
    path = FILES[name]
    _loads_as_jax(path)
    stem = os.path.splitext(path)[0]
    for window in WINDOWS[:3]:
        ref = j_av.load_frames_for(stem, 16, 64, window)
        got = av.load_frames_for(stem, 16, 64, window)
        assert float(np.abs(got - ref).max()) == 0.0


def test_fixtures_hold_what_they_are_named_for():
    def fields(name):
        packets = mk.cv2_packets(FILES[name])
        heads = mk.mpeg12_headers(packets)
        kinds = {k for h in heads for k, _ in h}
        seq_ext, pic_ext, disp, quant = [], [], [], 0
        for p, h in zip(packets, heads):
            for k, at in h:
                bits = "".join(f"{x:08b}" for x in p[at:at + 12])
                if k == "seq_ext":
                    seq_ext.append(bits)
                elif k == "pic_ext":
                    pic_ext.append(bits)
                elif k == "disp_ext":
                    disp.append(bits)
                elif k == "ext3":
                    quant += 1
        return kinds, seq_ext, pic_ext, disp, quant

    pe = {"dc": (20, 22), "fpfd": (25, 26), "qtype": (27, 28),
          "vlc": (28, 29), "alt": (29, 30), "tff": (24, 25),
          "rff": (30, 31), "prog": (32, 33)}

    def pic(bits_list, key):
        a, b = pe[key]
        return {int(bits[a:b], 2) for bits in bits_list}

    _, s, p, _, _ = fields("mpeg2_vlc_avi")
    assert pic(p, "vlc") == {1} and pic(p, "dc") == {2}
    _, s, p, _, _ = fields("mpeg2_nlq_mp4")
    assert pic(p, "qtype") == {1} and pic(p, "dc") == {1}
    _, s, p, _, _ = fields("mpeg2_dc11_mkv")
    assert pic(p, "dc") == {3}
    _, s, p, _, _ = fields("mpeg2_altscan_avi")
    assert pic(p, "alt") == {1} and pic(p, "fpfd") == {0}
    assert pic(p, "prog") == {1} and {b[12] for b in s} == {"0"}
    _, s, p, _, _ = fields("mpeg2_fieldpred_mkv")
    assert pic(p, "fpfd") == {0} and pic(p, "prog") == {1}
    _, s, p, _, _ = fields("mpeg2_telecine_mp4")
    assert {b[12] for b in s} == {"0"} and pic(p, "prog") == {1}
    assert pic(p, "rff") == {0, 1} and pic(p, "tff") == {0, 1}
    _, s, p, d, _ = fields("mpeg2_bt709_avi")
    assert d and {int(b[7]) for b in d} == {1}
    assert {int(b[24:32], 2) for b in d} == {1}          # BT.709
    for name in ("mpeg2_422_avi", "mpeg2_422q_mkv"):
        _, s, p, _, q = fields(name)
        assert {int(b[13:15], 2) for b in s} == {2}
    assert fields("mpeg2_422q_mkv")[4] > 1
    kinds, s, p, _, _ = fields("mpeg1_bf_mp4")
    assert not s and not p and "picture" in kinds
    # closed_gop flags: the encoder's first GOP only, or every GOP
    for name, closed in (("mpeg2_bf_avi", [1, 0, 0, 0]),
                         ("mpeg2_cgop_avi", [1, 1, 1, 1])):
        packets = mk.cv2_packets(FILES[name])
        flags = [(p[at + 3] >> 6) & 1 for p, h in
                 zip(packets, mk.mpeg12_headers(packets))
                 for k, at in h if k == "gop"]
        assert flags == closed, name
    # a copy cut at an open GOP: its leading B-pictures are skipped
    for c in ("avi", "mkv"):
        track = native.video_track(FILES[f"mpeg2_cut_{c}"])
        assert len(native.decode_video(FILES[f"mpeg2_cut_{c}"])) == \
            track.count - 2
    # a second sequence at another size
    packets = mk.cv2_packets(FILES["mpeg2_newsize_mkv"])
    sizes = {(p[at] << 4 | p[at + 1] >> 4, (p[at + 1] & 15) << 8 | p[at + 2])
             for p, h in zip(packets, mk.mpeg12_headers(packets))
             for k, at in h if k == "seq"}
    assert sizes == {(96, 64), (80, 48)}


@pytest.mark.parametrize("tag", RIFF_TAGS)
def test_riff_tags_read_as_cv2(tmp_path, tag):
    packets, times, (w, h) = _stream(bf=2)
    path = _write(tmp_path, "t.avi",
                  mk.avi_file(packets, w, h, 25, len(packets), tag.encode()))
    _held(path)


def test_quicktime_tags_read_as_cv2(tmp_path):
    packets, times, (w, h) = _stream(bf=1)
    ref = None
    for tag in ("hdv2", "xdv4", "xd5c", "mx5p", "m2v1", "mp2v", "m1v ",
                "xdhd"):
        path = _write(tmp_path, "t.mp4", mk.mp4_file(
            packets, w, h, 25, tag.encode(),
            ctts=[p - d for p, d in times], media_time=-times[0][1]))
        got = _held(path)
        path = _write(tmp_path, "t.avi", mk.avi_file(
            packets, w, h, 25, len(packets), tag.encode()))
        np.testing.assert_array_equal(_held(path), got)
        if ref is not None:
            np.testing.assert_array_equal(got, ref)
        ref = got


def test_variants_with_their_own_quirks_raise(tmp_path):
    packets, _, (w, h) = _stream()
    for tag in ("VCR2", "SLIF"):
        path = _write(tmp_path, "t.avi",
                      mk.avi_file(packets, w, h, 25, len(packets),
                                  tag.encode()))
        with pytest.raises(NotImplementedError, match="MPEG-1/2 variant"):
            native.decode_video(path)


@pytest.mark.parametrize("alone", [True, False])
def test_sequence_end_code(tmp_path, alone):
    """A sequence end code as a packet of its own gives the reference
    held back (libavcodec's flush) and counts in the container; at the end
    of the last packet it is read past."""
    packets, times, (w, h) = _stream(bf=2)
    end = b"\0\0\1\xb7"
    if alone:
        packets = packets + [end]
        times = times + [(times[-1][0] + 1, times[-1][1] + 1)]
    else:
        packets = packets[:-1] + [packets[-1] + end]
    for c in ("avi", "mp4", "mkv"):
        path = _write(tmp_path, f"t.{c}",
                      mk.dvd_file(packets, times, w, h, c))
        got = _held(path)
        assert len(got) == 20
        _loads_as_jax(path, WINDOWS[:3])


def test_headers_in_the_container_alone(tmp_path):
    """The sequence header (and extension) only in the esds or the
    CodecPrivate, as extradata: libavcodec reads it before the first
    packet."""
    packets, times, (w, h) = _stream(bf=2, g=8, frames=24)
    config = mk.mpeg12_config(packets[0])
    bare = [p[len(config):] if p.startswith(config) else p
            for p in packets]
    assert sum(b != p for b, p in zip(bare, packets)) == 4     # 4 GOPs
    for c in ("mp4", "mkv"):
        data = (mk.mp4_file(bare, w, h, 25, b"mp4v", mk.esds_box(
            config, oti=0x61), ctts=[p - d for p, d in times],
            media_time=-times[0][1]) if c == "mp4" else
            mk.mkv_file(bare, w, h, 25, "V_MPEG2", config,
                        pts=[p for p, _ in times]))
        path = _write(tmp_path, f"t.{c}", data)
        _held(path)
        _loads_as_jax(path, WINDOWS[:3])


def test_broken_link_is_no_start(tmp_path):
    """An open GOP flagged broken_link: libavcodec decodes its leading
    B-pictures from the reference before it (24 of 24 frames), so a window
    inside it is decoded from the first packet, not from its I-picture."""
    packets, times, (w, h) = _stream(bf=2, g=8, frames=24)
    packets = mk.patch_mpeg12(packets, lambda i, k, f: 1 if (
        f == "broken_link" and k == 1) else None)
    path = _write(tmp_path, "t.avi", mk.dvd_file(packets, times, w, h, "avi"))
    assert len(_held(path)) == 24
    _loads_as_jax(path, (None, (0.3, 0.5), (0.32, 0.4)))


@pytest.mark.parametrize("name", list(mk.DVD_UNREAD))
def test_unread_raise_by_name(tmp_path, name):
    what = mk.DVD_UNREAD[name][1]
    path = mk.write_case(name, str(tmp_path))
    with pytest.raises(NotImplementedError, match=what):
        native.decode_video(path)
    with pytest.raises(NotImplementedError, match=what):
        native.load_video_frames(path, 4, 16, None)
