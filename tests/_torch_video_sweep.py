"""The port's MJPEG, MPEG-4 Part 2, H.264 and MPEG-1/2 decoders against
cv2, the reading behind the video reader's bounds (TOL in
tests/test_torch_video_decode.py, VIDEO_TOL in chip_smoke.py).

    python tests/_torch_video_sweep.py [streams [seed [screen [dvd [hevc
        [legacy [itu [magicyuv [asv [snow]]]]]]]]]]

prints, per codec, the largest |Δ| in levels of `native.decode_video`
against cv2's `cap.read()` over every frame of every committed clip in
tests/torch_videos/, then over `streams` (default 600) random MPEG-4
Part 2 streams: libavcodec 59's mpeg4 and libxvid encoders (through
`lavc_encode`) at random sizes (16..176 x 16..144, even), frame counts
(2..16), quantisers and tools (B-frames, quarter-pel, 4MV, GMC, AC
prediction, MPEG quantisation, video packets, data partitioning), each in
an AVI; then over `screen` (default 0) random H.264 streams as ffmpeg
writes them from images and screens: the system's libx264 (through
`x264_encode`) in 4:2:0, 4:2:2, 4:4:4 and GBR (packed BGR input), at 8
and 10 bits, lossy (qp 0..44) and lossless, with random presets,
B-frames, CAVLC, weighted prediction, scaling lists, slices, intra only,
no 8x8 transform, deblocking offsets, constrained intra and I_PCM (noise
on half the picture), at sizes 32..96 x 32..80, in AVI, MP4 or
Matroska, or as 12 or 14 bits (a lossy 10-bit stream without I_PCM, its
SPS patched) in AVI; then over `dvd` (default 0) random MPEG-1 and
MPEG-2 streams: libavcodec 59's mpeg1video and mpeg2video (through
`dvd_stream`) at random sizes (16..200 x 16..160, odd ones too), frame
counts, GOP sizes, B-pictures, closed GOPs, quantisers, loaded matrices,
intra_vlc_format, intra_dc_precision, the non-linear scale, 4:2:2 with
chroma matrices, soft telecine, frame_pred_frame_dct 0 in progressive
frames (the alternate scan, field DCT and motion) and BT.709, in AVI, MP4
or Matroska; then over `hevc` (default 0) random HEVC streams: the
system's libx265 (through `hevc_stream`) with constrained intra
prediction (csrc/hevc.cpp's cip_refs) under random CTU, CU and TU sizes,
GOPs, B-frames, quantisers and strong intra smoothing, 8 and 10-bit, on
smooth and noisy pictures at sizes 64..192 x 64..128, in AVI; then over
`legacy` (default 0) random H.263-family streams: libavcodec 59's
msmpeg4v2, msmpeg4 (v3), wmv1, wmv2 and flv encoders at random sizes
(16..176 x 16..144; odd where the encoder takes them), GOPs, quantisers
or rates, macroblock decisions, trellis and WMV2's loop filter, on
smooth and noisy pictures, in AVI or Matroska, and as many v3, WMV1 and
WMV2 streams written symbol by symbol (`msmpeg4_syntax`: random tables,
escapes, slices, WMV1's per-macroblock tables and inter-intra
prediction, WMV2's mspel, ABT, top-left prediction, skip maps and loop
filter) at sizes down to 14x14; then over `itu` (default 0) random
ITU streams: libavcodec 59's h263 at sub-QCIF, QCIF and CIF (4MV,
OBMC, GOB headers, quantisers, DQUANT), h263p at sizes 32..352 x
32..288 in steps of 4 (Annexes D, F, I with T, J, K with and without a
payload size, S, quantisers, DQUANT where Annex I is off: libavcodec
59 writes DQUANT with Annex I that cv2's libavcodec misreads) and h261
at QCIF and CIF, on smooth and noisy pictures, in AVI, Matroska or (H.263)
an s263 MP4; then over `magicyuv`, `asv` and `snow` (default 0 each)
random streams of the codecs OpenCV's writer writes: MagicYUV from
libavcodec 59's encoder (its 8-bit layouts, each predictor) and from
`magicyuv_packet` (every layout to 14 bits, slices of random even
height, raw slices, the interlace flag, full range, the colour matrix),
at sizes 1..160 x 1..120; ASV1 and ASV2 at every quantiser, on smooth
and noisy pictures, with and without extradata, at sizes 8..200 x
8..160; Snow in 4:2:0, 4:4:4, 4:1:0 and grey with either wavelet,
lossless, quantisers, quarter-pel, 4MV, 1-4 references and keyframe
intervals, at sizes 32..200 x 32..160; each in AVI or Matroska. Needs
cv2, the system's libavcodec 59, libx264 and libx265, which the card's
machine does not have.
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import _torch_make_videos as mk  # noqa: E402
from viai_tpu_torch import native  # noqa: E402


def worst(path: str) -> int:
    ref = mk.cv2_view(path)[0]
    got = native.decode_video(path)
    if got.shape != ref.shape:
        raise AssertionError(f"{path}: {got.shape} against cv2's {ref.shape}")
    return int(np.abs(got.astype(int) - ref).max())


def random_options(rng) -> tuple[str, dict]:
    encoder = "libxvid" if rng.random() < 0.4 else "mpeg4"
    opts = {"qmin": int(rng.integers(2, 8)), "qmax": int(rng.integers(8, 31))}
    flags = [f for f in ("+qpel", "+mv4", "+aic") if rng.random() < 0.4]
    if encoder == "libxvid":
        flags = [f for f in flags if f != "+aic"]
        if rng.random() < 0.3:
            opts["gmc"] = 1
    else:
        if rng.random() < 0.3:
            opts["ps"] = int(rng.integers(100, 600))
        if rng.random() < 0.2:
            opts["data_partitioning"] = 1
            opts.setdefault("ps", 300)
    if flags:
        opts["flags"] = "".join(flags)
    if rng.random() < 0.5:
        opts["bf"] = int(rng.integers(1, 3))
    if rng.random() < 0.3:
        opts["mpeg_quant"] = 1
    return encoder, opts


def random_screen_stream(rng) -> tuple[dict, int, int, int, int, bool]:
    """libx264's settings of a random stream as ffmpeg writes it from
    images and screens, the depth its SPS is patched to (0: none), its
    size, frame count and whether half of each picture is noise."""
    csp = int(rng.choice([2, 6, 12, 12, 14]))
    depth = 8 if csp == 14 else int(rng.choice([8, 10]))
    lossless = rng.random() < 0.35
    st = dict(csp=csp, bitdepth=depth, profile="high444",
              qp=0 if lossless else int(rng.integers(0, 45)),
              preset=str(rng.choice(["ultrafast", "veryfast", "medium",
                                     "slow"])))
    for key, p, value in (("bframes", 0.5, int(rng.integers(0, 4))),
                          ("cabac", 0.3, 0),
                          ("weightp", 0.3, int(rng.integers(0, 3))),
                          ("cqm", 0.2, "jvt"),
                          ("slices", 0.2, int(rng.integers(2, 4))),
                          ("keyint", 0.2, 1), ("8x8dct", 0.2, 0),
                          ("deblock", 0.2, f"{int(rng.integers(-3, 4))}:"
                                           f"{int(rng.integers(-3, 4))}"),
                          ("constrained_intra", 0.15, 1)):
        if rng.random() < p:
            st[key] = value
    if rng.random() < 0.2:
        st.update(psy_rd="0:0", subme=10)
    patch = 0
    if depth == 10 and not lossless and st["qp"] >= 10 and rng.random() < 0.4:
        patch = int(rng.choice([12, 14]))
    noisy = not patch and rng.random() < 0.4
    h = int(rng.choice([32, 48, 56, 64, 80]))
    w = int(rng.choice([32, 48, 64, 96]))
    return st, patch, h, w, int(rng.integers(4, 10)), noisy


def screen_sweep(streams: int, rng, tmp: str):
    top, refused = 0, 0
    for k in range(streams):
        st, patch, h, w, t, noisy = random_screen_stream(rng)
        frames = mk.moving_frames(int(rng.integers(1 << 30)), t, h, w)
        if noisy:
            grain = rng.uniform(-70, 70, frames.shape)
            grain[:, :, w // 2:] *= 0.05
            frames = np.clip(frames + grain, 0, 255).astype(np.uint8)
        try:
            aus = mk.x264_encode(frames, **st)
        except RuntimeError:
            refused += 1                 # a setting libx264 refuses
            continue
        if patch:
            packets = [a for a, _, _ in aus]
            for field in ("bit_depth_luma", "bit_depth_chroma"):
                packets = mk.patch_h264(packets, 7, field,
                                        mk.ue_bits(patch - 8), 3)
            ext = "avi"
            data = mk.avi_file(packets, w, h, 25, len(packets), b"H264")
        else:
            ext = str(rng.choice(["avi", "mp4", "mkv"]))
            data = mk.h264_file(aus, w, h, ext)
        path = os.path.join(tmp, f"h{k}.{ext}")
        with open(path, "wb") as f:
            f.write(data)
        err = worst(path)
        if err:
            print(f"stream {k}: {st} {w}x{h} depth {patch or st['bitdepth']}"
                  f": max |Δ| {err}")
        top = max(top, err)
    print(f"{streams - refused} random H.264 streams of images and screens "
          f"({refused} settings refused): max |Δ| {top}")


def random_dvd_stream(rng) -> tuple[str, dict]:
    """dvd_stream's settings of a random MPEG-1 or MPEG-2 stream and the
    container it goes in."""
    mpeg1 = rng.random() < 0.3
    h, w = int(rng.integers(16, 161)), int(rng.integers(16, 201))
    q = int(rng.integers(1, 20))
    st = dict(encoder="mpeg1video" if mpeg1 else "mpeg2video",
              size=(h, w), frames=int(rng.integers(2, 25)),
              g=int(rng.integers(1, 16)), bf=int(rng.integers(0, 4)),
              qmin=q, qmax=int(rng.integers(q, 29)))
    if rng.random() < 0.25:
        st["flags"] = "+cgop"
        st["sc_threshold"] = 1000000000
    if rng.random() < 0.25:
        st["matrices"] = (
            [8] + [int(v) for v in rng.integers(8, 120, 63)],
            [int(v) for v in rng.integers(8, 120, 64)])
    if not mpeg1:
        if rng.random() < 0.3:
            st["intra_vlc"] = 1
        if rng.random() < 0.5:
            st["dc"] = int(rng.integers(8, 12))
        if rng.random() < 0.25:
            st["non_linear_quant"] = 1
        if rng.random() < 0.25:
            st["pixel_format"] = "yuv422p"
            if rng.random() < 0.5:
                st["chroma"] = ([8] + [int(v) for v in rng.integers(
                    8, 90, 63)], [int(v) for v in rng.integers(8, 90, 64)])
        tool = rng.random()
        if tool < 0.2 and (h + 15) // 16 % 2 == 0:
            st["telecine"] = True        # rows of progressive_sequence 0
        elif tool < 0.45:
            st["edit"] = "frames"
            st["flags"] = st.get("flags", "") + str(rng.choice(
                ["+ildct+ilme", "+ildct", "+ilme"]))
            if rng.random() < 0.5:
                st["alternate_scan"] = 1
        if rng.random() < 0.2:
            st.update(seq_disp_ext=1, colorspace="bt709")
    return str(rng.choice(["avi", "mp4", "mkv"])), st


def dvd_sweep(streams: int, rng, tmp: str):
    top, refused = 0, 0
    for k in range(streams):
        ext, st = random_dvd_stream(rng)
        try:
            packets, times, (w, h) = mk.dvd_stream(
                st, seed=int(rng.integers(1 << 30)))
        except RuntimeError:
            refused += 1                 # a setting the encoder refuses
            continue
        path = os.path.join(tmp, f"m{k}.{ext}")
        with open(path, "wb") as f:
            f.write(mk.dvd_file(packets, times, w, h, ext,
                                mpeg1=st["encoder"] == "mpeg1video"))
        err = worst(path)
        if err:
            print(f"stream {k}: {st} in {ext}: max |Δ| {err}")
        top = max(top, err)
    print(f"{streams - refused} random MPEG-1/2 streams ({refused} settings "
          f"refused): max |Δ| {top}")


def hevc_sweep(streams: int, rng, tmp: str):
    top, refused = 0, 0
    for k in range(streams):
        ctu = int(rng.choice([16, 32, 64]))
        parts = ["constrained-intra=1", f"ctu={ctu}",
                 f"min-cu-size={min(ctu, int(rng.choice([8, 16, 32])))}",
                 f"max-tu-size={int(rng.choice([4, 8, 16, 32]))}",
                 f"tu-intra-depth={int(rng.integers(1, 5))}",
                 f"keyint={int(rng.choice([1, 4, 30]))}",
                 f"bframes={int(rng.choice([0, 2, 4]))}"]
        if rng.random() < 0.3:
            parts.append(f"qp={int(rng.choice([10, 22, 35, 45]))}")
        if rng.random() < 0.3:
            parts.append("no-strong-intra-smoothing=1")
        h, w = (int(v) for v in rng.choice(
            [(64, 96), (128, 192), (72, 88), (96, 64), (120, 136)]))
        frames = mk.moving_frames(int(rng.integers(1 << 30)),
                                  int(rng.choice([3, 6, 9])), h, w)
        if rng.random() < 0.4:
            frames = np.clip(frames.astype(int) + rng.integers(
                -30, 31, frames.shape), 0, 255).astype(np.uint8)
        settings = {"params": ":".join(parts)}
        if rng.random() < 0.25:
            settings["pixel_format"] = "yuv420p10le"
        try:
            aus = mk.hevc_stream(settings, frames)
        except RuntimeError:
            refused += 1                 # a setting libx265 refuses
            continue
        path = os.path.join(tmp, f"h{k}.avi")
        with open(path, "wb") as f:
            f.write(mk.hevc_file(aus, w, h, "avi"))
        err = worst(path)
        if err:
            print(f"stream {k}: {settings} {w}x{h}: max |Δ| {err}")
        top = max(top, err)
    print(f"{streams - refused} random constrained-intra HEVC streams "
          f"({refused} settings refused): max |Δ| {top}")


LEGACY_ENCODERS = (("msmpeg4v2", b"MP42"), ("msmpeg4", b"DIV3"),
                   ("wmv1", b"WMV1"), ("wmv2", b"WMV2"), ("flv", b"FLV1"))


def legacy_sweep(streams: int, rng, tmp: str):
    top, refused = 0, 0
    for k in range(streams):
        enc, tag = LEGACY_ENCODERS[int(rng.integers(len(LEGACY_ENCODERS)))]
        h, w = int(rng.integers(16, 145)), int(rng.integers(16, 177))
        frames = mk.moving_frames(int(rng.integers(1 << 30)),
                                  int(rng.integers(2, 17)), h, w)
        if rng.random() < 0.3:
            frames = np.clip(frames.astype(int) + rng.integers(
                -40, 41, frames.shape), 0, 255).astype(np.uint8)
        opts = {"g": int(rng.choice([1, 3, 12, 300]))}
        if rng.random() < 0.4:
            q = int(rng.integers(1, 32))
            opts.update(qmin=q, qmax=q)
        elif rng.random() < 0.6:
            opts["b"] = int(rng.choice([20000, 100000, 200000, 3000000]))
        if rng.random() < 0.3:
            opts["mbd"] = int(rng.integers(0, 3))
        if rng.random() < 0.2:
            opts["trellis"] = 1
        if enc == "wmv2" and rng.random() < 0.4:
            opts["flags"] = "+loop"
        info = {}
        try:
            packets = mk.lavc_encode(frames, enc, info=info, **opts)
        except RuntimeError:
            refused += 1                 # an odd size the encoder refuses
            continue
        ext = "avi" if rng.random() < 0.6 else "mkv"
        path = os.path.join(tmp, f"l{k}.{ext}")
        extra = info["extradata"]
        if ext == "avi":
            data = mk.avi_file(packets, w, h, 25, len(packets), tag,
                               extradata=extra)
        else:
            bih = mk.struct.pack("<IiiHH4sIiiII", 40 + len(extra), w, h, 1,
                                 24, tag, w * h * 3, 0, 0, 0, 0)
            data = mk.mkv_file(packets, w, h, 25, "V_MS/VFW/FOURCC",
                               codec_private=bih + extra)
        with open(path, "wb") as f:
            f.write(data)
        err = worst(path)
        if err:
            print(f"stream {k}: {enc} {opts} {w}x{h} {ext}: max |Δ| {err}")
        top = max(top, err)
    print(f"{streams - refused} random H.263-family streams ({refused} "
          f"sizes refused): max |Δ| {top}")
    top = 0
    for k in range(streams):
        variant, tag = (("v3", b"DIV3"), ("wmv1", b"WMV1"),
                        ("wmv2", b"WMV2"))[k % 3]
        w = 16 * int(rng.integers(1, 9)) - 2 * int(rng.integers(0, 4))
        h = 16 * int(rng.integers(1, 7)) - 2 * int(rng.integers(0, 4))
        modes = {"q": int(rng.integers(1, 32)),
                 "slices": int(rng.integers(1, (h + 15) // 16 + 1)),
                 "loop": int(rng.integers(2)),
                 "bitrate": int(rng.choice([30, 100, 200])) * 1024}
        for flag in ("mspel", "abt", "top_left", "per_mb_rl"):
            modes[flag] = int(rng.integers(2))
        packets, extra = mk.msmpeg4_syntax(
            variant, w, h, int(rng.integers(2, 9)), int(rng.integers(1 << 30)),
            gop=int(rng.integers(1, 5)), **modes)
        path = os.path.join(tmp, f"y{k}.avi")
        with open(path, "wb") as f:
            f.write(mk.avi_file(packets, w, h, 25, len(packets), tag,
                                extradata=extra))
        err = worst(path)
        if err:
            print(f"syntax stream {k}: {variant} {modes} {w}x{h}: max |Δ| "
                  f"{err}")
        top = max(top, err)
    print(f"{streams} random pictures written symbol by symbol "
          f"(msmpeg4_syntax: v3, WMV1, WMV2): max |Δ| {top}")


def itu_sweep(streams: int, rng, tmp: str):
    top, refused, exact = 0, 0, 0
    for k in range(streams):
        enc = ("h263", "h263p", "h261")[k % 3]
        if enc == "h263":
            h, w = ((96, 128), (144, 176), (288, 352))[int(rng.integers(3))]
        elif enc == "h261":
            h, w = ((144, 176), (288, 352))[int(rng.integers(2))]
        else:
            h, w = 4 * int(rng.integers(8, 73)), 4 * int(rng.integers(8, 89))
        frames = mk.moving_frames(int(rng.integers(1 << 30)),
                                  int(rng.integers(2, 11)), h, w)
        if rng.random() < 0.3:
            frames = np.clip(frames.astype(int) + rng.integers(
                -30, 31, frames.shape), 0, 255).astype(np.uint8)
        opts = {"g": int(rng.choice([1, 3, 12, 300]))}
        if rng.random() < 0.4:
            q = int(rng.integers(1 if enc == "h263p" else 2, 32))
            opts.update(qmin=q, qmax=q)
        flags = []
        if enc != "h261":
            if rng.random() < 0.5:
                flags.append("+mv4")
            if rng.random() < 0.4:
                opts["obmc"] = 1
            if rng.random() < 0.3:
                opts["ps"] = int(rng.integers(100, 1000))
        if enc == "h263p":
            for opt in ("umv", "aiv", "structured_slices"):
                if rng.random() < 0.5:
                    opts[opt] = 1
            for flag in ("+aic", "+loop"):
                if rng.random() < 0.5:
                    flags.append(flag)
        if "+aic" not in flags and "qmin" not in opts and rng.random() < 0.3:
            opts["scplx_mask"] = 0.5
        if flags:
            opts["flags"] = "".join(flags)
        try:
            packets = mk.lavc_encode(frames, enc, **opts)
        except RuntimeError:
            refused += 1
            continue
        kinds = ("avi", "mkv") if enc == "h261" else ("avi", "mkv", "mp4")
        ext = kinds[int(rng.integers(len(kinds)))]
        tag = {"h263": b"H263", "h263p": b"U263", "h261": b"H261"}[enc]
        path = os.path.join(tmp, f"i{k}.{ext}")
        if ext == "avi":
            data = mk.avi_file(packets, w, h, 25, len(packets), tag)
        elif ext == "mp4":
            data = mk.mp4_file(packets, w, h, 25, b"s263", mk.d263_box())
        else:
            bih = mk.struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 24, tag,
                                 w * h * 3, 0, 0, 0, 0)
            data = mk.mkv_file(packets, w, h, 25, "V_MS/VFW/FOURCC",
                               codec_private=bih)
        with open(path, "wb") as f:
            f.write(data)
        err = worst(path)
        if err:
            print(f"itu stream {k}: {enc} {opts} {w}x{h} {ext}: max |Δ| "
                  f"{err}")
        exact += err == 0
        top = max(top, err)
    print(f"{streams - refused} random ITU streams (H.263, H.263+, H.261; "
          f"{refused} option sets refused): {exact} exact, max |Δ| {top}")


def _mux(packets: list[bytes], w: int, h: int, tag: bytes, ext: str,
         path: str, extradata: bytes = b"", bits: int = 24) -> str:
    """Packets of a fourcc codec in an AVI or a Matroska V_MS/VFW/FOURCC
    track, written to `path`."""
    if ext == "avi":
        data = mk.avi_file(packets, w, h, 25, len(packets), tag, bits=bits,
                           extradata=extradata)
    else:
        bih = mk.struct.pack("<IiiHH4sIiiII", 40 + len(extradata), w, h, 1,
                             bits, tag, w * h * 3, 0, 0, 0, 0)
        data = mk.mkv_file(packets, w, h, 25, "V_MS/VFW/FOURCC",
                           codec_private=bih + extradata)
    with open(path, "wb") as f:
        f.write(data)
    return path


def opencv_sweep(kind: str, streams: int, rng, tmp: str):
    """Random MagicYUV, ASV or Snow streams against cv2."""
    top, refused, exact, unread = 0, 0, 0, 0
    for k in range(streams):
        ext = ("avi", "mkv")[int(rng.integers(2))]
        info, opts = {"extradata": b"", "bits": 24}, {}
        if kind == "magicyuv":
            h, w = int(rng.integers(1, 121)), int(rng.integers(1, 161))
        elif kind == "asv":
            h, w = int(rng.integers(8, 161)), int(rng.integers(8, 201))
        else:
            h, w = int(rng.integers(32, 161)), int(rng.integers(32, 201))
        frames = mk.moving_frames(int(rng.integers(1 << 30)),
                                  int(rng.integers(1, 11)), h, w)
        if rng.random() < 0.3:
            frames = np.clip(frames.astype(int) + rng.integers(
                -40, 41, frames.shape), 0, 255).astype(np.uint8)
        try:
            if kind == "magicyuv" and rng.random() < 0.5:
                fmt = str(rng.choice(list(mk.MAGY_LAYOUTS)))
                shifts = mk.MAGY_LAYOUTS[fmt][3]
                vs = shifts[1] if shifts else 0
                sh = h
                if rng.random() < 0.6:
                    sh = int(rng.integers(1, h + 1)) << vs
                interlaced = rng.random() < 0.2 and (sh >> vs) >= 2 and (
                    h % sh == 0 or ((h % sh) >> vs) >= 2)
                opts = dict(fmt=fmt, pred=int(rng.integers(1, 4)),
                            slice_height=sh, interlaced=interlaced,
                            full_range=bool(rng.random() < 0.3),
                            matrix=int(rng.integers(0, 3)),
                            raw={j for j in range(-(-h // sh))
                                 if rng.random() < 0.2})
                packets = [mk.magicyuv_packet(f, **opts) for f in frames]
                tag = mk.MAGY_TAGS[fmt].encode()
            elif kind == "magicyuv":
                opts = dict(pixel_format=str(rng.choice(
                    ["gbrp", "gbrap", "gray", "yuv420p", "yuv422p", "yuv444p",
                     "yuva444p"])), pred=str(rng.choice(
                         ["left", "gradient", "median"])))
                packets = mk.lavc_encode(frames, "magicyuv", info=info, **opts)
                tag = info["tag"]
            elif kind == "asv":
                enc = ("asv1", "asv2")[k % 2]
                opts = dict(global_quality=118 * int(rng.integers(1, 32)),
                            flags="+qscale")
                packets = mk.lavc_encode(frames, enc, info=info, **opts)
                if rng.random() < 0.2:
                    info["extradata"] = b""
                tag = enc.upper().encode()
            else:
                fmt = str(rng.choice(["yuv420p", "yuv444p", "yuv410p",
                                      "gray"]))
                opts = dict(pixel_format=fmt, pred=int(rng.integers(0, 2)),
                            g=int(rng.choice([1, 2, 3, 5, 12])),
                            refs=int(rng.integers(1, 5)))
                if rng.random() < 0.5:
                    q = int(rng.integers(0, 32))
                    if q == 0:
                        opts["pred"] = 1
                    opts.update(global_quality=118 * q, flags="+qscale")
                extra = [f for f in ("+qpel", "+mv4") if rng.random() < 0.4]
                if extra:
                    opts["flags"] = opts.get("flags", "") + "".join(extra)
                packets = mk.lavc_encode(frames, "snow", **opts)
                tag = b"SNOW"
        except RuntimeError:
            refused += 1
            continue
        path = _mux(packets, w, h, tag, ext, os.path.join(tmp, f"o{k}.{ext}"),
                    info["extradata"], info["bits"] or 24)
        try:
            err = worst(path)
        except NotImplementedError as e:
            print(f"{kind} stream {k}: {opts} {w}x{h} {ext}: {e}")
            unread += 1
            continue
        except ValueError:                 # cv2 reads no frame: nor the port
            try:
                native.decode_video(path)
                err = 256
            except ValueError:
                err = 0
        if err:
            print(f"{kind} stream {k}: {opts} {w}x{h} {ext}: max |Δ| {err}")
        exact += err == 0
        top = max(top, err)
    done = streams - refused
    print(f"{done} random {kind} streams ({refused} option sets refused, "
          f"{unread} raising NotImplementedError): {exact} exact, max |Δ| "
          f"{top}")


def main(streams: int = 600, seed: int = 0, screen: int = 0, dvd: int = 0,
         hevc: int = 0, legacy: int = 0, itu: int = 0, magicyuv: int = 0,
         asv: int = 0, snow: int = 0):
    per = {}
    for npz in sorted(os.listdir(mk.FIXTURES)):
        if not npz.endswith(".npz"):
            continue
        name = npz[:-4]
        path = mk.path_of(name)
        codec = native.video_track(path, packets=False).codec
        per[codec] = max(per.get(codec, 0), worst(path))
    for name in (*mk.CLIP_CASES, *mk.PHONE_CLIPS, *mk.CAMERA_CLIPS,
                 *mk.SCREEN_CLIPS, *mk.DVD_CLIPS):
        path = mk.path_of(name)
        codec = native.video_track(path, packets=False).codec
        per[codec] = max(per.get(codec, 0), worst(path))
    print("committed clips, max |Δ| per codec over every frame:", per)
    rng = np.random.default_rng(seed)
    top, failed = 0, 0
    with tempfile.TemporaryDirectory() as tmp:
        for k in range(streams):
            encoder, opts = random_options(rng)
            h = 2 * int(rng.integers(8, 73))
            w = 2 * int(rng.integers(8, 89))
            frames = mk.moving_frames(int(rng.integers(1 << 30)),
                                      int(rng.integers(2, 17)), h, w)
            try:
                packets = mk.lavc_encode(frames, encoder, **opts)
            except RuntimeError:
                failed += 1              # an option set the encoder refuses
                continue
            path = os.path.join(tmp, f"s{k}.avi")
            with open(path, "wb") as f:
                f.write(mk.avi_file(packets, w, h, 25, len(packets),
                                    b"XVID" if encoder == "libxvid"
                                    else b"DX50"))
            err = worst(path)
            if err:
                print(f"stream {k}: {encoder} {opts} {w}x{h}: max |Δ| {err}")
            top = max(top, err)
        print(f"{streams - failed} random MPEG-4 Part 2 streams (seed "
              f"{seed}; {failed} option sets refused): max |Δ| {top}")
        screen_sweep(screen, rng, tmp)
        dvd_sweep(dvd, rng, tmp)
        hevc_sweep(hevc, rng, tmp)
        legacy_sweep(legacy, rng, tmp)
        itu_sweep(itu, rng, tmp)
        opencv_sweep("magicyuv", magicyuv, rng, tmp)
        opencv_sweep("asv", asv, rng, tmp)
        opencv_sweep("snow", snow, rng, tmp)


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:]))
