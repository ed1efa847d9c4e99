"""Compressed video clips for the port's video reader, and cv2's decodes.

    python tests/_torch_make_videos.py [out_dir [case ...]]

writes `tests/torch_videos/` (every case, or the named ones; needs cv2,
which the card's machine does not have, so the fixtures are committed):
  * `<case>.<ext>`: every case of CASES, written by cv2's VideoWriter
    (ffmpeg's MJPEG and MPEG-4 Part 2 encoders and libvpx's VP8 and VP9,
    in AVI, MP4, MOV, Matroska and WebM); the AVIs of HAND_CASES, muxed here:
    MJPEG packets without their Huffman tables (the AVI1 convention: the
    decoder takes the standard tables of JPEG's annex K), and one whose
    headers count more frames than it holds; the MP4s of MP4_MJPEG_CASES,
    cv2's MJPEG packets muxed here under the `mjpa` and `MJPG` sample
    entries (cv2's writer puts MJPG in MP4 under an `mp4v` entry whose
    esds objectTypeIndication is 0x6C, JPEG: `mjpeg_mp4v_mp4`); the MP4 of
    VP8_MP4_CASES, cv2's VP8 packets muxed here under a `vp08` sample entry
    with its vpcC box (cv2's writer does not put VP8 in MP4);
    the VP8 Matroska files of VP8_PATCHED, cv2's stream with bits of its
    frame tags or keyframe sizes changed (a hidden frame, versions 1-3,
    an odd width with the scaling fields set), which cv2 still reads;
    the AVIs of LIBVPX_CASES, VP8 and VP9 written by libvpx's own API
    (the library cv2's wheel bundles, through ctypes, `libvpx_encode`)
    with the settings cv2's writer does not reach. VP8: token
    partitions, sharpness, error-resilient mode (segmentation, no
    entropy refresh), a region-of-interest map (segment quantiser and
    level deltas), two-pass alt-ref frames (hidden, sign-biased), profile
    1 (bilinear, simple loop filter). VP9: one-pass good quality with
    backward adaptation (switchable filters, every transform size),
    two-pass alt-ref (superframes, hidden frames, compound prediction),
    2x2 tiles at 512x128, cyclic-refresh AQ (segmentation with temporal
    map prediction), an ROI map (segment quantiser, level, reference and
    skip), error-resilient with frame-parallel decoding (no adaptation,
    contexts reset), realtime speed 8, lossless at 64x64 (WHT), an odd
    width, full colour range and BT.709 (which cv2's conversion applies);
    the files of X264_CASES, H.264 written by the system's libx264
    through ctypes (`x264_encode`) and muxed here (`h264_file`): Baseline
    CAVLC (POC type 2) in AVI, Main CAVLC with B-frames, temporal direct
    and implicit weights in Matroska, x264's medium High (CABAC,
    B-pyramid, weighted P prediction, the 8x8 transform) in MP4 with
    ctts and ffmpeg's edit list, the slower preset (8 references, 4x4
    partitions, direct auto), custom scaling matrices, 4 slices with
    deblocking offsets and constrained intra, open GOP, intra refresh
    (High CAVLC), full range with BT.709, and I_PCM at qp 1 over noise
    in CABAC and in CAVLC; the AVIs of X264_PATCHED, libx264's streams
    with a header field patched bit by bit (`patch_h264`):
    disable_deblocking_filter_idc 2 and direct_8x8_inference_flag 0;
    the AVIs of MJPEG_CASES, MJPEG in the other layouts libavcodec
    decodes (PIL's 4:2:2, 4:4:4 and grey, cv2's imencode for 4:4:0,
    ffmpeg's CS=ITU601 comment) and at an odd height; the OpenDML AVI of
    ODML_CASES (`avi_odml_file`: indx, ix00, dmlh, one RIFF AVIX); the
    MP4s of EDIT_CASES, libx264's High stream under an edit that trims
    its first frames, as a cut with `ffmpeg -ss ... -c copy` leaves it,
    alone and after an empty edit; the files of LAVC_CASES, MPEG-4 Part 2
    Advanced Simple Profile written by the system's libavcodec 59
    (`libavcodec.so.59`, `libavutil.so.57`) through ctypes
    (`lavc_encode`): libxvid (the real XviD, `libxvidcore.so.4`) at its
    defaults, with packed B-VOPs (in AVI and Matroska), quarter-pel, MPEG
    quantisation, GMC of 3 warping points and, its S-VOPs' warps made
    translations (`gmc_translation`), GMC's one-point route, and an early
    build's user data (XviD0001) at 88x56; libavcodec's mpeg4 with
    B-VOPs (in AVI and MP4), 4MV, AC prediction, MPEG quantisation with
    the default and with loaded matrices, video packets, data
    partitioning, quarter-pel B-VOPs, and DivX user data (DivX503b1393p);
    the AVI of LAVC_UNREAD, what the port does not read (interlace); the
    files of CONTAINER_CASES, video as phones and muxers write it, one
    stream re-muxed (`container_file`): MP4 display matrices in tkhd and
    mvhd (`display_matrix`), Matroska Projections, fragmented MP4 (moof,
    tfhd, tfdt, trun), Matroska without DefaultDuration, and a sound track
    beside the video (`audio_track`'s PCM in AVI, MP4 and Matroska;
    `aac_track`, AAC from the system's libavcodec 59 through ctypes, in
    MP4); the files of BROWSER_CASES, VP9 as YouTube and browsers write
    it (`libvpx_encode` at 10 and 12 bits, in 4:2:2, 4:4:0, 4:4:4 and
    sRGB, with a size schedule for reference scaling, two SVC layers
    with an intra-only frame) and pictures that change size mid-stream
    in VP9, MJPEG and H.264 (`browser_file`); the files of SCREEN_CASES,
    H.264 as ffmpeg writes it from images and screens (`camera_stream`:
    libx264's High 4:4:4 Predictive at 8 and 10 bits with CABAC, CAVLC,
    intra only, JVT and custom scaling lists, I_PCM and a crop; its GBR
    from packed BGR input, `x264_encode(csp=14)`; lossless transform
    bypass at 4:2:0, 4:2:2, 4:4:4 and 10 bits; 12 and 14 bits by a
    patched SPS); the files of RAW_CASES, uncompressed video
    (`raw_packets` hand-muxed by `avi_file` and `mkv_file`, and
    cv2.VideoWriter's own files for fourcc 0, I420, IYUV, YV12, NV12,
    Y800, GREY and RGBA); the files of MUXER_CASES, video as mkvmerge
    and other muxers store it (`muxer_file`: Matroska content encodings,
    `content_encodings`, LZO by `lzo1x_compress`; rates without
    DefaultDuration; laced blocks; fragmented MP4 with a timecode or text
    track and a second sample entry; MJPEG field pairs and 4:1:1; grey
    and GBR at a new size);
  * `<case>.npz`: cv2's view of it: `n`, the frames `cap.read()` gives;
    `frames`, the first, the middle and the last of them ((3, H, W, 3)
    BGR uint8, at `index`); `count`, `CAP_PROP_FRAME_COUNT`; and for
    CONTAINER_CASES `orientation`, `CAP_PROP_ORIENTATION_META`;
  * `clip.avi`, `clip.mp4`, `clip.mkv`, `clip.mov`, `clip.webm`,
    `clip_vp8.mkv`, `clip_vp9.webm`, `clip_vp9.mp4`, `clip_h264.mp4`
    (High), `clip_h264.mkv` (Main, CAVLC), `clip_cam.avi` (MJPEG 4:2:2
    in OpenDML), `clip_cut.mp4` (High, 4 of 20 frames cut by an edit),
    `clip_oddh.avi` (4:2:0 at 224x223), `clip_xvid.avi` (libxvid:
    packed B-VOPs, quarter-pel, 4MV, GMC), `clip_dx50.mp4` (libavcodec's
    mpeg4: B-VOPs, 4MV, AC prediction): the first frames of the
    committed 224x224 jpeg clip
    (tests/torch_frames/clip/) as video (CLIP_CASES), and `clip_phone.mp4`
    (a phone's: turned 90 degrees, AAC) and `clip_frag.mp4` (fragmented)
    of a 224x160 crop (PHONE_CLIPS), `clip_hdr.webm` and `clip_rtc.webm`
    (BROWSER_CLIPS, their .npz with the JAX package's picks),
    `clip_screen.mp4` (4:4:4, medium preset) and `clip_lossless.mkv`
    (lossless 4:2:0, ultrafast preset) (SCREEN_CLIPS), `clip_dvd.mkv`
    and `clip_pim1.avi` (DVD_CLIPS), `clip_i420.avi` (cv2's fourcc 0)
    and `clip_yuy2.avi` (RAW_CLIPS), `clip_strip.mkv` (H.264 High
    header-stripped) and `clip_nodd.mkv` (HEVC without DefaultDuration)
    (MUXER_CLIPS), the clips chip_smoke.py trains from and times.

The small cases are 72x56 (not a multiple of 16) with a textured square
that moves over a drifting background, so that the MPEG-4 and VP8 clips'
inter frames carry motion and, at 30 frames, a third I-VOP or keyframe
(ffmpeg's GOP is 12 for all three). The encoders are deterministic here, so a
rerun rewrites the same bytes, but for the Matroska and WebM files'
random segment UID (cv2's writer; `mkv_file` writes none).
tests/test_torch_video_decode.py and, for CONTAINER_CASES and PHONE_CLIPS,
tests/test_torch_video_containers.py hold the port against cv2 live and
against these files.
"""

from __future__ import annotations

import io
import os
import struct
import sys

import numpy as np

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "torch_videos")
CLIP_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "torch_frames", "clip")
H, W = 56, 72

# name: (ext, fourcc, fps, frames)
CASES = {
    "mjpeg_avi": ("avi", "MJPG", 25, 20),
    "mjpeg_mp4v_mp4": ("mp4", "MJPG", 25, 20),   # an mp4v entry, OTI 0x6C
    "mjpeg_mkv": ("mkv", "MJPG", 25, 20),
    "mjpeg_mov": ("mov", "MJPG", 25, 20),
    "mjpeg_8fps_mkv": ("mkv", "MJPG", 8, 13),
    "mpeg4_avi": ("avi", "mp4v", 25, 30),
    "mpeg4_mp4": ("mp4", "mp4v", 25, 30),
    "mpeg4_mkv": ("mkv", "mp4v", 25, 30),
    "mpeg4_mov": ("mov", "mp4v", 25, 30),
    "mpeg4_2997_mkv": ("mkv", "mp4v", 30000 / 1001, 25),
    "mpeg4_8fps_mkv": ("mkv", "mp4v", 8, 17),
    "xvid_avi": ("avi", "XVID", 25, 14),
    "vp8_webm": ("webm", "VP80", 25, 20),
    "vp8_mkv": ("mkv", "VP80", 25, 20),
    "vp8_avi": ("avi", "VP80", 25, 20),
    "vp8_8fps_mkv": ("mkv", "VP80", 8, 13),
    "vp8_2997_mkv": ("mkv", "VP80", 30000 / 1001, 25),
    "vp8_long_webm": ("webm", "VP80", 25, 40),        # keyframes 0, 12, 24, 36
    "vp9_webm": ("webm", "VP90", 25, 40),             # keyframes 0, 12, 24, 36
    "vp9_mkv": ("mkv", "VP90", 25, 20),
    "vp9_avi": ("avi", "VP90", 25, 20),
    "vp9_mp4": ("mp4", "vp09", 25, 20),
}
# name: the sample entry of cv2's MJPEG packets in a hand-muxed MP4
MP4_MJPEG_CASES = {"mjpeg_mjpa_mp4": b"mjpa", "mjpeg_mjpg_mp4": b"MJPG"}
# name: what is changed in cv2's 30-frame VP8 Matroska file
VP8_PATCHED = {
    "vp8_hidden_mkv": "show_frame cleared in packet 5",
    "vp8_v1_mkv": "version 1 in every frame tag",
    "vp8_v2_mkv": "version 2 in every frame tag",
    "vp8_v3_mkv": "version 3 in every frame tag",
    "vp8_odd_mkv": "width 71 (keyframes, PixelWidth), scaling fields 1, 2",
}
# name: the sample entry of cv2's VP8 packets in a hand-muxed MP4
VP8_MP4_CASES = {"vp8_mp4": b"vp08"}
# name: libvpx settings (see libvpx_encode; `size` (h, w), else 72x56;
# `zoom`, frames drawn at 1/zoom the size and enlarged, so that their
# decodes stay small in the .npz), 40 frames at 25 fps in AVI
LIBVPX_CASES = {
    "vp8_partitions_avi": dict(token_partitions=2, sharpness=5),
    "vp8_resilient_avi": dict(error_resilient=True),
    "vp8_roi_avi": dict(roi=True),
    "vp8_altref_avi": dict(two_pass=True),
    "vp8_profile1_avi": dict(profile=1),
    "vp9_good_avi": dict(frame_parallel=False, sharpness=3),
    "vp9_twopass_avi": dict(two_pass=True, frame_parallel=False,
                            size=(64, 96)),             # 21 compound blocks
    "vp9_tiles_avi": dict(tile_cols=1, tile_rows=1, frame_parallel=False,
                          size=(128, 512), zoom=4),
    "vp9_aq_avi": dict(aq_mode=3, frame_parallel=False),
    "vp9_roi_avi": dict(roi=True, frame_parallel=False, realtime_speed=5),
    "vp9_resilient_avi": dict(error_resilient=True, frame_parallel=True),
    "vp9_rt_avi": dict(realtime_speed=8, frame_parallel=False),
    "vp9_lossless_avi": dict(lossless=True, frame_parallel=False,
                             size=(64, 64)),
    "vp9_oddw_avi": dict(frame_parallel=False, size=(56, 71)),
    "vp9_range_avi": dict(color_range=1),
    "vp9_bt709_avi": dict(color_space=2),
    "vp8_oddh_avi": dict(size=(H - 1, W)),
    "vp9_oddh_avi": dict(frame_parallel=False, size=(H + 1, W - 1)),
}
# name: libx264 settings (see x264_encode; `frames`, else 30; `noise`,
# the amplitude of uniform noise added to the frames), 72x56 at 25 fps
# in the container its name ends with: AVI (fourcc H264, Annex B), MP4
# (avc1 with its avcC box, ctts, stss and ffmpeg's edit list) or
# Matroska (V_MPEG4/ISO/AVC, presentation times, keyframe flags).
X264_CASES = {
    "h264_baseline_avi": dict(profile="baseline"),          # POC type 2
    "h264_main_mkv": dict(profile="main", cabac=0, bframes=3,
                          b_pyramid="none", direct="temporal", weightb=1),
    "h264_high_mp4": dict(frames=40, keyint=12),   # medium: CABAC, B-pyramid
    "h264_slower_mkv": dict(preset="slower", ref=8, b_adapt=2,
                            partitions="all", direct="auto"),
    "h264_cqm_avi": dict(
        cqm4iy=",".join(str(6 + 2 * i) for i in range(16)),
        cqm4ic=",".join(str(20 - i) for i in range(16)),
        cqm4py=",".join(str(10 + i) for i in range(16)),
        cqm8i=",".join(str(8 + i // 2) for i in range(64)),
        cqm8p=",".join(str(40 - i // 4) for i in range(64))),
    "h264_slices_avi": dict(slices=4, deblock="-3:2", constrained_intra=1),
    "h264_opengop_avi": dict(frames=40, open_gop=1, keyint=10),
    "h264_refresh_avi": dict(intra_refresh=1, keyint=10, cabac=0),
    "h264_range_avi": dict(fullrange="on", colormatrix="bt709"),
    "h264_pcm_avi": dict(frames=24, qp=1, psy_rd="0:0", subme=10, noise=60),
    "h264_pcmcavlc_avi": dict(frames=24, qp=1, psy_rd="0:0", subme=10,
                              noise=60, cabac=0),
}
# name: (libx264 settings as X264_CASES, the NAL unit type, the field
# and its new bits for patch_h264): headers that libx264 does not write,
# patched into its AVI stream (cv2 the judge): every slice's
# disable_deblocking_filter_idc 0 made 2 (no filtering across slice
# edges) in 4 CAVLC slices, and direct_8x8_inference_flag cleared in
# the SPS of a CAVLC stream with B-frames, temporal direct and 4x4
# P partitions (direct motion of every 4x4 block from its own
# colocated block: 2 of its 30 frames differ from the unpatched
# stream's).
X264_PATCHED = {
    "h264_idc2_avi": (dict(profile="baseline", slices=4, deblock="1:-1"),
                      (1, 5), "deblocking_idc", "011"),
    "h264_nodirect8_avi": (dict(profile="main", cabac=0, bframes=3,
                                direct="temporal", preset="slower",
                                partitions="all"),
                           (7,), "direct_8x8_inference", "0"),
}
# name: (frames, frame count the headers give, fps)
HAND_CASES = {
    "mjpeg_nodht_avi": (12, 12, 25),
    "mjpeg_longhdr_avi": (12, 17, 25),
}
# name: (frames, (h, w), the JPEGs' layout, see jpegs_of): MJPEG in the
# layouts libavcodec decodes other than 4:2:0 at an even height, which
# swscale converts by routes of their own (4:2:2 unscaled, grey through
# its palette, the rest through its scaler), hand-muxed in AVI
MJPEG_CASES = {
    "mjpeg_422_avi": (8, (H, W), "4:2:2"),
    "mjpeg_444_avi": (8, (H, W), "4:4:4"),
    "mjpeg_440_avi": (8, (H, W), "4:4:0"),
    "mjpeg_grey_avi": (8, (H, W), "grey"),
    "mjpeg_oddh_avi": (8, (H - 1, W), "4:2:0"),
    "mjpeg_422oddh_avi": (8, (H - 1, W), "4:2:2"),
    "mjpeg_itu601_avi": (8, (H, W), "4:2:0 CS=ITU601"),
}
# name: (frames, frames in the first RIFF): 4:2:2 MJPEG (a webcam's) in an
# OpenDML AVI with one RIFF AVIX (avi_odml_file)
ODML_CASES = {"mjpeg_odml_avi": (12, 7)}
# name: the edit list of libx264's 40-frame High stream (keyframes every
# 12) in MP4, as (segment duration, media time) in frames, the media
# time counted from the first presented sample's composition time (None:
# an empty edit): a clip cut as `ffmpeg -ss ... -c copy` leaves it, the
# frames before the cut decoded and dropped
EDIT_CASES = {
    "h264_trim_mp4": [(35, 5)],
    "h264_emptyedit_mp4": [(3, None), (33, 7)],
}
# name: (encoder, its options, fourcc, user data): MPEG-4 Part 2 Advanced
# Simple Profile from the system's libavcodec 59 (lavc_encode): libxvid
# (the real XviD) and ffmpeg's own mpeg4 encoder, one tool each, 12
# frames at 96x64, in AVI under `fourcc` unless the name ends in mp4 (an
# mp4v sample entry with its esds) or mkv (V_MPEG4/ISO/ASP with the
# headers as CodecPrivate); `user data`, when given, replaces the
# encoder's own ("Lavc59.37.100"). libxvid with B-frames packs them
# (DivX503b1393p user data beside XviD0069: a P-VOP and the B-VOP before
# it in one packet, an N-VOP placeholder later; 10 packets of 12 frames).
# Custom quantisation matrices come from the encoder's intra_matrix and
# inter_matrix (LAVC_MATRICES).
LAVC_CASES = {
    "xvid_default_avi": ("libxvid", {}, b"XVID", None),
    "xvid_packed_avi": ("libxvid", {"bf": 2}, b"XVID", None),
    "xvid_qpel_avi": ("libxvid", {"flags": "+qpel"}, b"XVID", None),
    "xvid_mpegquant_avi": ("libxvid", {"mpeg_quant": 1}, b"XVID", None),
    "xvid_gmc_avi": ("libxvid", {"bf": 2, "flags": "+qpel+mv4", "gmc": 1,
                                 "mpeg_quant": 1}, b"XVID", None),
    "xvid_packed_mkv": ("libxvid", {"bf": 2, "flags": "+qpel+mv4"}, b"XVID",
                        None),
    "mpeg4_bframes_avi": ("mpeg4", {"bf": 2}, b"DIVX", None),
    "mpeg4_mv4_avi": ("mpeg4", {"flags": "+mv4"}, b"DX50", None),
    "mpeg4_aic_avi": ("mpeg4", {"flags": "+aic"}, b"DX50", None),
    "mpeg4_mpegquant_avi": ("mpeg4", {"mpeg_quant": 1}, b"DX50", None),
    "mpeg4_matrices_avi": ("mpeg4", {"mpeg_quant": 1, "bf": 1}, b"DX50",
                           None),
    "mpeg4_packets_avi": ("mpeg4", {"ps": 200}, b"DX50", None),
    "mpeg4_partitioned_avi": ("mpeg4", {"data_partitioning": 1, "ps": 300,
                                        "flags": "+mv4+aic"}, b"DX50", None),
    "mpeg4_qpelbf_avi": ("mpeg4", {"bf": 2, "flags": "+qpel"}, b"DX50", None),
    "mpeg4_divx_avi": ("mpeg4", {"bf": 2, "flags": "+qpel+mv4"}, b"DX50",
                       b"DivX503b1393p"),
    "mpeg4_bframes_mp4": ("mpeg4", {"bf": 2, "flags": "+mv4"}, b"DX50", None),
    "xvid_build1_avi": ("libxvid", {"bf": 1, "flags": "+qpel"}, b"XVID",
                        b"XviD0001"),
    "xvid_gmc1_avi": ("libxvid", {"bf": 2, "flags": "+qpel+mv4", "gmc": 1,
                                  "mpeg_quant": 1}, b"XVID", None),
    "mpeg4_saturated_avi": ("mpeg4", {"qmin": 31, "qmax": 31,
                                      "flags": "+mv4"}, b"DX50", None),
}
# the cases of LAVC_CASES at another size than 96x64, (h, w): an early
# XviD build's stream (user data XviD0001: libavcodec's quarter-pel chroma,
# edge and DC clipping workarounds) at a size that is not a multiple of 16
LAVC_SIZES = {"xvid_build1_avi": (56, 88)}
# the cases of LAVC_CASES whose S-VOPs get a translation for a warp
# (gmc_translation): libavcodec's one-point GMC route
LAVC_GMC1 = {"xvid_gmc1_avi"}
# the cases of LAVC_CASES that encode a 96x64 crop of the 224x224 clip's
# first frames (moving_frames' content gives libxvid no GMC macroblock)
LAVC_CROP = {"xvid_gmc_avi", "xvid_gmc1_avi"}
# the cases of LAVC_CASES of saturated colours (moving_frames' samples
# made 0 or 255): P-VOPs of rounding type 1 whose chroma references hold
# 0, where libavcodec's 8-wide no-round half-pel averaging is approximate
# (mpeg_bits.h's hpel)
LAVC_SATURATED = {"mpeg4_saturated_avi"}
# the cases of LAVC_CASES encoded with these intra and inter matrices
LAVC_MATRICES = {"mpeg4_matrices_avi": (
    [8] + [10 + i // 3 for i in range(1, 64)],
    [12 + (i * 5) % 23 for i in range(64)])}
# name: (encoder, options, fourcc): what libavcodec's mpeg4 encoder writes
# and the port does not read (LAVC_CASES' shape): interlaced coding
# (field DCT and field motion)
LAVC_UNREAD = {
    "mpeg4_interlaced_avi": ("mpeg4", {"flags": "+ildct+ilme"}, b"DX50"),
}
# the clips chip_smoke.py trains from: name: (ext, fourcc, frames), the
# first frames of the 32.
CLIP_CASES = {"clip_avi": ("avi", "MJPG", 16), "clip_mp4": ("mp4", "mp4v", 16),
              "clip_mkv": ("mkv", "mp4v", 8), "clip_mov": ("mov", "MJPG", 8),
              "clip_webm": ("webm", "VP80", 8),
              "clip_vp8_mkv": ("mkv", "VP80", 8),
              "clip_vp9_webm": ("webm", "VP90", 8),
              "clip_vp9_mp4": ("mp4", "vp09", 8),
              "clip_h264_mp4": ("mp4", "avc1", 16),    # High (medium)
              "clip_h264_mkv": ("mkv", "avc1", 8),     # Main, CAVLC
              "clip_cam_avi": ("avi", "MJPG", 16),     # 4:2:2, OpenDML
              "clip_cut_mp4": ("mp4", "avc1", 16),     # a trimming edit
              "clip_oddh_avi": ("avi", "MJPG", 8),     # 224x223, PIL's
              "clip_xvid_avi": ("avi", "XVID", 16),    # ASP, packed B
              "clip_dx50_mp4": ("mp4", "DX50", 16)}    # B-VOPs, 4MV, AC
# the libavcodec encoders and options of the ASP training clips
LAVC_CLIPS = {"clip_xvid_avi": ("libxvid", {"bf": 2, "flags": "+qpel+mv4",
                                            "gmc": 1}),
              "clip_dx50_mp4": ("mpeg4", {"bf": 2, "flags": "+mv4+aic"})}
# the libx264 settings of the H.264 training clips
X264_CLIPS = {"clip_h264_mp4": dict(),
              "clip_h264_mkv": dict(profile="main", cabac=0)}
# Every case held against cv2 (an .npz each), and the codec it holds.
DECODED = (*CASES, *HAND_CASES, *MP4_MJPEG_CASES, *VP8_PATCHED,
           *VP8_MP4_CASES, *LIBVPX_CASES, *X264_CASES, *X264_PATCHED,
           *MJPEG_CASES, *ODML_CASES, *EDIT_CASES, *LAVC_CASES)
# name: (the stream, the container's options): video as phones and
# muxers write it, held by tests/test_torch_video_containers.py. The
# streams (see container_packets): "mpeg4", mpeg4_avi's 30 packets (I-VOPs
# 0, 12, 24); "vp8", vp8_webm's 20; "h264", libx264's 30 at its medium
# preset (B-frames, keyframes every 12); "mjpeg", 12 JPEGs 4:2:2. The
# options: MP4 display matrices, tkhd's ("matrix") and mvhd's
# ("movie_matrix"), a clockwise turn in degrees or "scale2"; Matroska
# Projections ("projection", mkv_file's); fragmented MP4 ("fragments":
# "key", one a keyframe, or "sample", one a sample; with "negative", the
# composition offsets made negative (trun version 1) instead of ffmpeg's
# edit list); Matroska without DefaultDuration, its block times those of
# "rate" rounded to 1 ms; "audio", a sound track before the video, or
# after it ("... after"): "pcm" (audio_track at 8 kHz) or "aac"
# (aac_track, 16 kHz); the rest go to the muxer as they are (OpenDML
# with "split").
CONTAINER_CASES = {
    "mpeg4_rot90_mp4": ("mpeg4", dict(matrix=90)),
    "mpeg4_rot180_mp4": ("mpeg4", dict(matrix=180)),
    "mpeg4_rot270_mp4": ("mpeg4", dict(matrix=270, version=1)),
    "mpeg4_movie90_mp4": ("mpeg4", dict(movie_matrix=90)),
    "mpeg4_movie180_mp4": ("mpeg4", dict(movie_matrix=180)),
    "mpeg4_movie270_mp4": ("mpeg4", dict(movie_matrix=270, version=1)),
    "mpeg4_rot90x2_mp4": ("mpeg4", dict(matrix=90, movie_matrix=90)),
    "mpeg4_rot45_mp4": ("mpeg4", dict(matrix=45)),
    "mpeg4_scale2_mp4": ("mpeg4", dict(matrix="scale2")),
    "vp8_roll90_mkv": ("vp8", dict(projection=dict(roll=90))),
    "vp8_rollm90_mkv": ("vp8", dict(projection=dict(roll=-90))),
    "vp8_roll180_mkv": ("vp8", dict(projection=dict(roll=180))),
    "mpeg4_frag_mp4": ("mpeg4", dict(fragments="key")),
    "mpeg4_fragmehd_mp4": ("mpeg4", dict(fragments="key", mehd=True)),
    "mpeg4_fragsample_mp4": ("mpeg4", dict(fragments="sample")),
    "mpeg4_fragmoov_mp4": ("mpeg4", dict(fragments="key", moov_samples=12)),
    "mpeg4_fragaudio_mp4": ("mpeg4", dict(fragments="key", audio="pcm")),
    "mpeg4_fragbase_mp4": ("mpeg4", dict(fragments="key", base_offset=True,
                                         audio="pcm after")),
    "h264_fragneg_mp4": ("h264", dict(fragments="key", negative=True,
                                      audio="aac")),
    "h264_fragedit_mp4": ("h264", dict(fragments="key", audio="aac after")),
    "vp8_nodd25_mkv": ("vp8", dict(rate=25)),
    "vp8_nodd2997_mkv": ("vp8", dict(rate=30000 / 1001)),
    "vp8_nodd30_mkv": ("vp8", dict(rate=30)),
    "vp8_nodd23976_mkv": ("vp8", dict(rate=24000 / 1001)),
    "vp8_nodd15_mkv": ("vp8", dict(rate=15)),
    "mpeg4_audio_avi": ("mpeg4", dict(audio="pcm")),
    "mpeg4_audioafter_avi": ("mpeg4", dict(audio="pcm after")),
    "mjpeg_odmlaudio_avi": ("mjpeg", dict(audio="pcm", split=7)),
    "mjpeg_odmlaudioafter_avi": ("mjpeg", dict(audio="pcm after", split=7)),
    "mpeg4_audio_mp4": ("mpeg4", dict(audio="pcm", chunk=[4, 3])),
    "mpeg4_audioafter_mp4": ("mpeg4", dict(audio="pcm after", chunk=[5, 2])),
    "h264_aac_mp4": ("h264", dict(audio="aac", chunk=[4, 3])),
    "vp8_audio_mkv": ("vp8", dict(audio="pcm")),
    "vp8_audioafter_mkv": ("vp8", dict(audio="pcm after", cluster=7)),
}
# the clips chip_smoke.py's `phone` folder trains from, libx264's High
# (keyframes every 8) of a 224x160 crop of the committed clip's first 16
# frames: a phone held upright (a 90 degree tkhd matrix, AAC in chunks
# interleaved with the video's) and a fragmented file (one fragment a
# keyframe, AAC in trafs of its own), with CONTAINER_CASES' options
PHONE_CLIPS = {"clip_phone_mp4": dict(matrix=90, audio="aac", chunk=[5, 3]),
               "clip_frag_mp4": dict(fragments="key", audio="aac after")}
# name: libx264 settings (x264_encode's, with `frames`, else 12, and
# `size` (h, w), else 48x64, of moving_frames) for H.264 as cameras and
# other encoders write it, held by tests/test_torch_video_camera.py, in
# the container its name ends with (h264_file): High 4:2:2 and High 10
# at 10 bits (B-frames, intra only, CAVLC), 4:2:2 at 8 bits, monochrome
# at 8 and 10 bits (I_PCM at 10 bits), progressive frames of an
# interlace-capable stream (x264's fake-interlaced: frame_mbs_only_flag 0)
# with B-frames, at a height of 8 modulo 16 lines (cropped in 4-row
# units) and under picture timing SEI (pic_struct 0). `edit` rewrites
# the Annex B stream: "no restriction" clears the VUI's
# bitstream_restriction (patch_h264), "no vui" drops the VUI
# (strip_vui), "sub8x8" writes its B slices (sub8x8_b_slices); "deep",
# after `frames` P frames, appends an IDR picture and 16 frames of
# B-pyramid, so that the reorder depth grows past what libavformat's
# probe saw (cv2 drops a frame).
CAMERA_CASES = {
    "h264_42210_mp4": dict(csp=6, bitdepth=10, profile="high422",
                           bframes=3),
    "h264_42210intra_mkv": dict(csp=6, bitdepth=10, profile="high422",
                                keyint=1, frames=8),
    "h264_42210cavlc_avi": dict(csp=6, bitdepth=10, profile="high422",
                                cabac=0, bframes=2, weightp=2),
    "h264_42010_avi": dict(bitdepth=10, profile="high10", bframes=3),
    "h264_4228_mkv": dict(csp=6, profile="high422", bframes=2),
    "h264_mono8_avi": dict(csp=1),
    "h264_mono10_mp4": dict(csp=1, bitdepth=10, profile="high10",
                            cabac=0),
    "h264_pcm10_avi": dict(bitdepth=10, profile="high10", qp=1,
                           psy_rd="0:0", subme=10, noise=60, frames=6),
    "h264_psf_mp4": dict(fake_interlaced=1, bframes=3),
    "h264_psfcrop_mkv": dict(fake_interlaced=1, bframes=2, size=(56, 64)),
    "h264_psfsei_avi": dict(fake_interlaced=1, pic_struct=1,
                            picture_struct=1),
    "h264_norestrict_avi": dict(bframes=3, b_pyramid="normal", frames=30,
                                edit="no restriction"),
    "h264_norestrict_mp4": dict(bframes=3, b_pyramid="normal", frames=30,
                                edit="no restriction"),
    "h264_novui_mkv": dict(bframes=2, edit="no vui"),
    "h264_deep_avi": dict(bframes=0, frames=8, edit="deep"),
    "h264_sub8x8_avi": dict(cabac=0, bframes=1, b_adapt=0,
                            b_pyramid="none", weightb=0, direct="spatial",
                            edit="sub8x8"),
}
# the camera clips chip_smoke.py trains from, libx264 of the committed
# 224x224 clip's first 16 frames: High 4:2:2 at 10 bits with B-frames
# (an XAVC S 4:2:2 10-bit camera's long GOP) in MP4, and progressive
# frames of an interlace-capable High stream with B-frames and its
# bitstream_restriction cleared (AVCHD at 25p remuxed as `ffmpeg -c
# copy` leaves it) in Matroska; CAMERA_CASES' keys
CAMERA_CLIPS = {
    "clip_xavc_mp4": dict(csp=6, bitdepth=10, profile="high422",
                          bframes=3, keyint=12),
    "clip_avchd_mkv": dict(fake_interlaced=1, bframes=2, keyint=12,
                           edit="no restriction"),
}
# name: a stream of video as YouTube and browsers write it, held by
# tests/test_torch_video_browser.py, in the container its name ends with
# (browser_file: WebM/Matroska V_VP9, MP4 vp09 with its vpcC box, AVI
# VP90). VP9 from libvpx_encode (one thread) of moving_frames at 48x64,
# 10 frames, with these settings: profile 2 at 10 and 12 bits in BT.2020
# (YouTube's HDR), profiles 1 and 3 in 4:4:4, 4:2:2 and 4:4:0 at 8, 10
# and 12 bits, sRGB (GBR) in profiles 1 and 3; `sizes`, runs of (h, w, frames)
# of moving_frames at 64x96 resized (INTER_AREA) where smaller, realtime
# (libvpx codes a new size from the references it has: reference
# scaling down and back up, with `keyframes` forced); `svc`, two spatial
# layers (each packet a superframe that shows both pictures) with the
# base layer coded intra-only at frame 6. `kind` "streams": pictures
# that change size mid-stream (F4), two streams of `parts` (h, w, frames)
# one after the other: libvpx's VP9 (the second from a keyframe of its
# own size), PIL's JPEGs (MJPEG), libx264's H.264 (the second from an
# IDR with its own SPS; B-frames and a crop when `bframes`); `container`,
# the (w, h) the container declares instead of the first picture's.
BROWSER_CASES = {
    "vp9_hdr10_webm": dict(profile=2, bit_depth=10, color_space=5),
    "vp9_hdr12_mp4": dict(profile=2, bit_depth=12, color_space=5),
    "vp9_444_mkv": dict(profile=1, layout="444"),
    "vp9_422_webm": dict(profile=1, layout="422"),
    "vp9_440_avi": dict(profile=1, layout="440"),
    "vp9_44410_mp4": dict(profile=3, bit_depth=10, layout="444"),
    "vp9_44012_webm": dict(profile=3, bit_depth=12, layout="440"),
    "vp9_42210_mkv": dict(profile=3, bit_depth=10, layout="422"),
    "vp9_srgb_webm": dict(profile=1, layout="gbr", color_space=7),
    "vp9_srgb10_mkv": dict(profile=3, bit_depth=10, layout="gbr",
                           color_space=7),
    "vp9_srgb12_mp4": dict(profile=3, bit_depth=12, layout="gbr",
                           color_space=7),
    "vp9_scaled_webm": dict(sizes=[(64, 96, 6), (32, 48, 6), (64, 96, 6)],
                            realtime_speed=8),
    "vp9_scaledkf_mkv": dict(sizes=[(64, 96, 6), (32, 48, 6), (64, 96, 4)],
                             realtime_speed=8, keyframes={12}),
    "vp9_scaledaq_mp4": dict(sizes=[(64, 96, 5), (48, 72, 6), (64, 96, 4)],
                             realtime_speed=6, aq_mode=3,
                             frame_parallel=False),
    "vp9_scaledodd_avi": dict(sizes=[(64, 96, 5), (36, 60, 5), (50, 80, 4)],
                              realtime_speed=5, frame_parallel=False),
    "vp9_scaled10_webm": dict(sizes=[(64, 96, 5), (32, 48, 5), (64, 96, 4)],
                              realtime_speed=8, profile=2, bit_depth=10,
                              color_space=5),
    "vp9_svc_webm": dict(sizes=[(64, 96, 12)], svc=dict(layers=2,
                                                        intra_only=True),
                         keyframes={6}),
    "vp9_newsize_webm": dict(kind="streams", codec="vp9",
                             parts=[(64, 96, 10), (48, 64, 10)]),
    "vp9_container_webm": dict(kind="streams", codec="vp9",
                               parts=[(64, 96, 6), (48, 64, 6)],
                               container=(80, 60)),
    "mjpeg_newsize_avi": dict(kind="streams", codec="mjpeg",
                              parts=[(64, 96, 10), (48, 64, 10)]),
    "h264_newsize_avi": dict(kind="streams", codec="h264",
                             parts=[(64, 96, 8), (40, 56, 8)], bframes=2),
}
# the clips chip_smoke.py's `browser` folder trains from, of the committed
# 224x224 clip's first 16 frames: YouTube's HDR VP9 (profile 2, 10-bit
# 4:2:0, BT.2020, two-pass good quality with alt-refs) and a WebRTC or
# MediaRecorder recording (profile 0 realtime, down to 112x112 by
# reference scaling for frames 6-11, back at 224x224 from a keyframe);
# BROWSER_CASES' settings; held as BROWSER_CASES are, their .npz also
# holding the JAX package's picks of 16 frames at 64x64 for each of
# BROWSER_PICKS (`picks`, levels: the [0, 1] frames times 255;
# `picks_windows`, (-1, -1) for None)
BROWSER_CLIPS = {
    "clip_hdr_webm": dict(profile=2, bit_depth=10, color_space=5,
                          two_pass=True, frame_parallel=False),
    "clip_rtc_webm": dict(sizes=[(224, 224, 6), (112, 112, 6),
                                 (224, 224, 4)],
                          realtime_speed=8, keyframes={12}),
}
# the windows of BROWSER_CLIPS' committed picks (16 frames at 64x64)
BROWSER_PICKS = (None, (0.25, 0.75), (0.5, 1.0))
# libx264's scaling lists of its own (x264_param_parse's cqm4iy ...:
# 4x4 intra and inter of luma and chroma, 8x8 intra and inter shared by
# the three planes), 6 to 39 in a pattern of each list's own
X264_MATRICES = {
    opt: ",".join(str(6 + (7 * k + 11 * t) % 34)
                  for k in range(16 if opt.startswith("cqm4") else 64))
    for t, opt in enumerate(("cqm4iy", "cqm4py", "cqm4ic", "cqm4pc",
                             "cqm8i", "cqm8p"))}
# name: H.264 as ffmpeg writes it from images and screens, held by
# tests/test_torch_video_screen.py: camera_stream's settings, in the
# container its name ends with (h264_file). libx264 of moving_frames at
# 48x64, 12 frames, unless `size` and `frames` say otherwise: High 4:4:4
# Predictive (what `ffmpeg -i %05d.png -c:v libx264` writes from RGB
# images: yuv444p) with CABAC, B-frames and the 8x8 transform, with
# CAVLC and weighted P prediction, intra only (High 4:4:4 Intra), at 10
# bits, with the JVT scaling lists (twelve, the Cb and Cr 8x8 lists by
# fall-back) and with lists of its own (X264_MATRICES), with I_PCM beside
# 8x8 blocks (noise on the left half of each frame, `noise_cols`, at qp
# 2), cropped to 56x72, a height and width of 8 modulo 16 (crop units of
# 1); libx264rgb's GBR (csp 14, packed BGR input:
# matrix_coefficients 0), lossy and lossless; lossless transform bypass
# (`-qp 0`, OBS's lossless mode, screen captures) at 4:2:0 with the
# ultrafast preset (CAVLC, no deblocking) and with CABAC and B-frames,
# at 4:2:2, 4:4:4 and 10 bits; `edit` "12 bits" and "14 bits", libx264's
# 10-bit stream with its SPS's bit depths patched (patch_h264), which
# libavcodec reads as 12- and 14-bit samples.
SCREEN_CASES = {
    "h264_444_mp4": dict(csp=12, profile="high444", bframes=3),
    "h264_444cavlc_avi": dict(csp=12, profile="high444", cabac=0,
                              weightp=2, bframes=2),
    "h264_444intra_mkv": dict(csp=12, profile="high444", keyint=1,
                              frames=8),
    "h264_44410_mp4": dict(csp=12, bitdepth=10, profile="high444",
                           bframes=2),
    "h264_444cqm_avi": dict(csp=12, profile="high444", cqm="jvt",
                            bframes=2),
    "h264_444matrix_mkv": dict(csp=12, profile="high444", bframes=2,
                               **X264_MATRICES),
    "h264_444pcm_avi": dict(csp=12, profile="high444", qp=2,
                            psy_rd="0:0", subme=10, noise=80,
                            noise_cols=0.5, size=(64, 96), frames=6),
    "h264_444crop_mkv": dict(csp=12, profile="high444", bframes=2,
                             size=(56, 72)),
    "h264_gbr_mp4": dict(csp=14, profile="high444", bframes=2),
    "h264_gbrlossless_avi": dict(csp=14, profile="high444", qp=0),
    "h264_lossless_avi": dict(preset="ultrafast", profile="high444", qp=0),
    "h264_losslessb_mkv": dict(profile="high444", qp=0, bframes=3),
    "h264_lossless422_mp4": dict(csp=6, profile="high444", qp=0),
    "h264_lossless444_avi": dict(csp=12, profile="high444", qp=0,
                                 bframes=2),
    "h264_lossless10_mkv": dict(bitdepth=10, profile="high444", qp=0),
    "h264_12bit_avi": dict(bitdepth=10, profile="high10", bframes=2,
                           edit="12 bits"),
    "h264_14bit_mkv": dict(csp=12, bitdepth=10, profile="high444",
                           bframes=2, edit="14 bits"),
}
# the screen clips chip_smoke.py trains from, libx264 of the committed
# 224x224 clip's first 16 frames: 4:4:4 at 8 bits with the medium
# preset (a clip rebuilt from frame images by ffmpeg's defaults) in MP4,
# and lossless 4:2:0 with the ultrafast preset (a screen capture) in
# Matroska; SCREEN_CASES' settings
SCREEN_CLIPS = {
    "clip_screen_mp4": dict(csp=12, profile="high444", keyint=12),
    "clip_lossless_mkv": dict(preset="ultrafast", profile="high444", qp=0,
                              keyint=12),
}
# MPEG-1 and MPEG-2 video as DVD rips, broadcast captures, camcorders and
# OpenCV's own writer store it: streams of the system's libavcodec 59
# (`lavc_encode`'s mpeg2video and mpeg1video, 20 frames of moving_frames
# at 96x64 unless `frames` or `size` (h, w) say otherwise), each in AVI
# (fourcc mpg2 or mpg1), MP4 (mp4v; esds objectTypeIndication 0x61 Main,
# 0x65 4:2:2 or 0x6A MPEG-1, the sequence header as DecoderSpecificInfo)
# and Matroska (V_MPEG2 or V_MPEG1, the sequence header as CodecPrivate)
# (`dvd_file`). The rest of each dict is lavc_encode's options, but for
# `matrices` (its intra and inter matrices), `chroma` (chroma intra and
# inter matrices a quant matrix extension loads after each I-picture's
# coding extension, `mpeg12_quant_ext`), `telecine` (progressive_sequence
# patched to 0, top_field_first and repeat_first_field to 3:2 pulldown
# in display order, progressive_frame left at 1: soft telecine as DVDs
# of film carry it, `patch_mpeg12`), `sizes` (a second stream at another
# size after the first, from frame 12 on: a new sequence header
# mid-stream), `cut` (the packets from the second GOP on, as a copy cut
# from a title starts: an open GOP whose leading B-pictures lack their
# older reference, which libavcodec skips), `edit` "frames"
# (progressive_frame patched to 1 in a
# stream libavcodec codes as interlaced: frame_pred_frame_dct 0, field
# and frame DCT and motion by macroblock, in pictures libavcodec then
# marks progressive; libavcodec's encoder writes the alternate scan only
# so) and `encoder`. intra_dc_precision: `dc` 8 to 11.
DVD_STREAMS = {
    "mpeg2_ip": dict(),                          # I and P, low_delay 0
    "mpeg2_bf": dict(bf=2, g=8, frames=24),      # open GOPs
    "mpeg2_cgop": dict(bf=2, g=8, frames=24, flags="+cgop",
                       sc_threshold=1000000000),
    "mpeg2_vlc": dict(bf=2, intra_vlc=1, dc=10),
    "mpeg2_nlq": dict(bf=1, non_linear_quant=1, qmax=28, dc=9),
    "mpeg2_dc11": dict(bf=2, dc=11, qmin=1, qmax=3),
    "mpeg2_altscan": dict(bf=2, alternate_scan=1, edit="frames"),
    "mpeg2_fieldpred": dict(bf=2, flags="+ildct+ilme", edit="frames"),
    "mpeg2_matrix": dict(bf=2, matrices=(
        [8] + [9 + (i * 7) % 40 for i in range(1, 64)],
        [10 + (i * 11) % 37 for i in range(64)])),
    "mpeg2_bt709": dict(bf=2, seq_disp_ext=1, colorspace="bt709",
                        color_primaries="bt709", color_trc="bt709"),
    "mpeg2_422": dict(bf=2, pixel_format="yuv422p"),
    "mpeg2_422q": dict(bf=2, pixel_format="yuv422p", size=(47, 90), chroma=(
        [8] + [12 + (i * 5) % 31 for i in range(1, 64)],
        [14 + (i * 3) % 29 for i in range(64)])),
    "mpeg2_odd": dict(bf=2, size=(57, 89)),
    "mpeg2_telecine": dict(bf=2, g=12, frames=24, telecine=True),
    "mpeg2_newsize": dict(bf=2, g=6, frames=24, sizes=((64, 96), (48, 80))),
    "mpeg2_cut": dict(bf=2, g=8, frames=32, cut=True),
    "mpeg1_bf": dict(encoder="mpeg1video", bf=2),
    "mpeg1_odd": dict(encoder="mpeg1video", bf=1, size=(41, 71)),
}
DVD_CASES = {f"{k}_{c}": v for k, v in DVD_STREAMS.items()
             for c in ("avi", "mp4", "mkv")}
# The clips chip_smoke.py's `dvd` folder trains from, of the committed
# 224x224 clip's first 16 frames: MPEG-2 Main Profile at 720x480 as
# MakeMKV stores a DVD film title (V_MPEG2, the sequence header as
# CodecPrivate, soft telecine on progressive_sequence 0, open GOPs of 12
# with 2 B-pictures, a sequence display extension) and MPEG-1 at 352x240
# as cv2.VideoWriter writes it with fourcc PIM1 (in AVI).
DVD_CLIPS = {
    "clip_dvd_mkv": dict(bf=2, g=12, telecine=True, seq_disp_ext=1,
                         colorspace="smpte170m", color_primaries="smpte170m",
                         color_trc="smpte170m", b="6000000",
                         maxrate="9800000", bufsize="1835008",
                         size=(480, 720)),
    "clip_pim1_avi": dict(size=(240, 352)),
}
# What the port does not read, each raising NotImplementedError that
# names it (DVD_STREAMS' shape, in AVI): interlaced MPEG-2 (libavcodec's
# field DCT and field motion: progressive_frame 0, whose frames cv2's
# swscale refuses), field pictures (picture_structure patched to 1, a
# top field),
# MPEG-1 D-pictures (the second I-picture's coding type patched to 4),
# full_pel_forward_vector (patched on in the P-pictures), a sequence
# scalable extension, and 4:4:4 (chroma_format patched to 3).
DVD_UNREAD = {
    "mpeg2_interlaced_avi": (dict(bf=2, flags="+ildct+ilme"),
                             "progressive_frame 0"),
    "mpeg2_field_avi": (dict(edit="field"), "field pictures"),
    "mpeg1_dpicture_avi": (dict(encoder="mpeg1video", g=6,
                                edit="D-picture"), "D-pictures"),
    "mpeg1_fullpel_avi": (dict(encoder="mpeg1video", edit="full_pel"),
                          "full_pel"),
    "mpeg2_scalable_avi": (dict(edit="scalable"), "scalable"),
    "mpeg2_444_avi": (dict(edit="4:4:4"), "4:4:4"),
}
# Uncompressed video as OpenCV's writer, capture tools and ffmpeg store
# it. Hand-muxed here (`raw_packets` in `avi_file` or `mkv_file`), at
# 64x48 and at an odd 45x29 ("odd"), RAW_FRAMES frames of moving_frames:
# each AVI fourcc of RAW_AVI_TAGS (libavformat's raw layouts: planar,
# semi-planar and packed YUV, grey, v210), BI_RGB at 8 bits with a
# colour table and without one, 16 bits and 32 bits bottom-up and
# top-down (strf's height negative), and V_UNCOMPRESSED Matroska tracks
# by their ColourSpace; and written by cv2.VideoWriter at 64x48,
# RAW_CV2_FRAMES frames, for each fourcc it stores uncompressed, in AVI
# and Matroska ("" for fourcc 0, which stores I420; it stores yuv420p
# bytes under every YUV fourcc, and rounds odd sizes down, which is why
# odd sizes come from hand-muxed files only).
# name: (container or "cv2", fourcc or "BI_RGB", layout of the bytes or
# cv2's container, options)
RAW_AVI_TAGS = {
    "I420": "i420", "IYUV": "i420", "YV12": "yv12", "NV12": "nv12",
    "NV21": "nv21", "Y800": "grey", "GREY": "grey", "Y8  ": "grey",
    "YUY2": "yuyv", "YUYV": "yuyv", "YUNV": "yuyv", "V422": "yuyv",
    "Y422": "yuyv", "UYVY": "uyvy", "HDYC": "uyvy", "UYNV": "uyvy",
    "2vuy": "uyvy", "YVYU": "yvyu", "YV16": "yv16", "Y42B": "y42b",
    "YV24": "yv24", "Y41B": "y41b", "v210": "v210"}
RAW_DIBS = {"rgb8": dict(bits=8, palette=True),
            "rgb8nopal": dict(bits=8),
            "rgb16": dict(bits=16),
            "rgb32": dict(bits=32),
            "rgb32td": dict(bits=32, top_down=True)}
RAW_SIZES = {"": (48, 64), "odd": (29, 45)}
RAW_CASES = {
    **{f"raw_{t.strip().lower()}{k}_avi": ("avi", t, lay, dict(size=hw))
       for t, lay in RAW_AVI_TAGS.items() for k, hw in RAW_SIZES.items()},
    **{f"raw_{n}{k}_avi": ("avi", "BI_RGB", "dib", dict(o, size=hw))
       for n, o in RAW_DIBS.items() for k, hw in RAW_SIZES.items()},
    # a capture tool's bit count of 12 for YUY2: libavcodec scales each
    # 16-bit word x to x << 4 | x >> 8 (rawdec's is_lt_16bpp)
    "raw_yuy2b12_avi": ("avi", "YUY2", "yuyv", dict(size=(48, 64), bits=12)),
    "raw_i420odd_mkv": ("mkv", "I420", "i420", dict(size=(29, 45))),
    "raw_yuy2_mkv": ("mkv", "YUY2", "yuyv", dict(size=(48, 64))),
    "raw_uyvyodd_mkv": ("mkv", "UYVY", "uyvy", dict(size=(29, 45))),
    "raw_rgb24_mkv": ("mkv", "RGB\x18", "rgb24", dict(size=(48, 64))),
    "raw_bgr24odd_mkv": ("mkv", "BGR\x18", "bgr24", dict(size=(29, 45))),
    "raw_bgra_mkv": ("mkv", "BGRA", "bgra", dict(size=(48, 64))),
    **{f"raw_cv2{t.lower() or 'zero'}_{c}": ("cv2", t, c, {})
       for t in ("", "I420", "IYUV", "YV12", "NV12", "Y800", "GREY", "RGBA")
       for c in ("avi", "mkv")},
}
RAW_CV2_SIZE, RAW_FRAMES, RAW_CV2_FRAMES = (48, 64), 6, 8
# strf's bit count of each layout, as capture tools write it
RAW_BITS = {"i420": 12, "yv12": 12, "nv12": 12, "nv21": 12, "y41b": 12,
            "grey": 8, "yuyv": 16, "uyvy": 16, "yvyu": 16, "y42b": 16,
            "yv16": 16, "yv24": 24, "v210": 20}
# The clips chip_smoke.py's `raw` folder trains from, of the committed
# 224x224 clip's first 8 frames: cv2.VideoWriter's fourcc 0 (an I420
# AVI), and YUY2 as `ffmpeg -f v4l2 -c:v copy` stores a webcam's frames.
RAW_CLIPS = {"clip_i420_avi": ("cv2", "", "avi", {}),
             "clip_yuy2_avi": ("avi", "YUY2", "yuyv", {})}
# Lossless video as capture tools, archives and OpenCV's writer store it
# (tests/test_torch_video_lossless.py): LOSSLESS_FRAMES frames of
# moving_frames at LOSSLESS_SIZE (h, w) unless `size`/`frames` say
# otherwise, from the system's libavcodec 59 (lavc_encode with
# `pixel_format` and the encoder's options; its extradata and bit count
# into the strf), in the container the name ends with: AVI (avi_file),
# Matroska V_FFV1 with the configuration record as CodecPrivate, else
# V_MS/VFW/FOURCC with a BITMAPINFOHEADER and the extradata after it.
# name: (encoder, pixel format, options); "classic" is HuffYUV 1.x
# written here (classic_huffyuv: no extradata, the classic tables, the
# predictor in strf's bit count); "cv2" cv2.VideoWriter with that fourcc.
# `tag` the fourcc (PNG's three), `gradient` a UT Video stream of no
# prediction relabelled gradient (its encoder writes none); "flags"
# "+ilme" sets HuffYUV's interlace bit (libavcodec's encoder writes it
# clear otherwise, at any height).
LOSSLESS_FRAMES, LOSSLESS_SIZE = 5, (48, 64)
LOSSLESS_CASES = {
    "ffv1_v0_avi": ("ffv1", "yuv420p", dict(level=0, coder=0)),
    "ffv1_v0range_mkv": ("ffv1", "yuv420p", dict(level=0, coder=1)),
    "ffv1_v1gop_avi": ("ffv1", "yuv422p", dict(level=1, coder=1, g=3)),
    "ffv1_v1gray_avi": ("ffv1", "gray", dict(level=1)),
    "ffv1_v1rgb_avi": ("ffv1", "bgr0", dict(level=1, coder=0)),
    "ffv1_v2_avi": ("ffv1", "yuv420p", dict(level=2, strict=-2, slices=4)),
    "ffv1_v3_avi": ("ffv1", "yuv420p", dict(level=3, slices=4, slicecrc=1)),
    "ffv1_v3golomb_avi": ("ffv1", "yuv420p", dict(level=3, coder=0, slices=4,
                                                  g=2, size=(29, 45))),
    "ffv1_v3def_mkv": ("ffv1", "yuv444p", dict(level=3, coder=-2,
                                               slicecrc=1)),
    "ffv1_v3ctx_avi": ("ffv1", "yuv420p10le", dict(level=3, context=1,
                                                   slices=6, slicecrc=1)),
    "ffv1_v3p10_mkv": ("ffv1", "yuv422p10le", dict(level=3, slices=4,
                                                   slicecrc=1, g=4)),
    "ffv1_v3p444_avi": ("ffv1", "yuv444p10le", dict(level=3)),
    "ffv1_v3rgb10_avi": ("ffv1", "gbrp10le", dict(level=3, slicecrc=1)),
    "ffv1_v3rgb16_mkv": ("ffv1", "gbrp16le", dict(level=3, size=(29, 45))),
    "ffv1_v3rgba_avi": ("ffv1", "bgra", dict(level=3, slices=4,
                                              size=(29, 45))),
    "ffv1_v3yuva_avi": ("ffv1", "yuva420p", dict(level=3)),
    "ffv1_v3gray16_avi": ("ffv1", "gray16le", dict(level=3)),
    "ffv1_v3ya_mkv": ("ffv1", "ya8", dict(level=3)),
    "ffv1_v3p411_avi": ("ffv1", "yuv411p", dict(level=3)),
    "ffv1_v3p410_avi": ("ffv1", "yuv410p", dict(level=3, size=(29, 45))),
    "ffv1_v3odd_avi": ("ffv1", "yuv420p", dict(level=3, slices=4, slicecrc=1,
                                               size=(29, 45))),
    "ut_ulrg_avi": ("utvideo", "gbrp", dict(pred="left")),
    "ut_ulra_avi": ("utvideo", "gbrap", dict(pred="median")),
    "ut_uly0_avi": ("utvideo", "yuv420p", dict(pred="median", slices=3)),
    "ut_uly2_mkv": ("utvideo", "yuv422p", dict(pred="none")),
    "ut_uly4_avi": ("utvideo", "yuv444p", dict(pred="left")),
    "ut_ulh0_avi": ("utvideo", "yuv420p", dict(pred="median",
                                               colorspace="bt709")),
    "ut_ulh2_avi": ("utvideo", "yuv422p", dict(pred="left",
                                               colorspace="bt709")),
    "ut_ulh4_mkv": ("utvideo", "yuv444p", dict(pred="none", size=(29, 45),
                                               colorspace="bt709")),
    "ut_gradient_avi": ("utvideo", "yuv420p", dict(pred="none",
                                                   gradient=True)),
    "ut_rgbgrad_avi": ("utvideo", "gbrp", dict(pred="none", gradient=True,
                                               slices=2, size=(29, 46))),
    "hfyu_v1_avi": ("classic", "yuv422p", dict(bits=17)),
    "hfyu_v1plane_avi": ("classic", "yuv422p", dict(bits=19)),
    "hfyu_v1rgb_avi": ("classic", "bgr24", dict(bits=26)),
    "hfyu_v2_avi": ("huffyuv", "yuv422p", dict(pred="left")),
    "hfyu_median_mkv": ("huffyuv", "yuv422p", dict(pred="median")),
    "hfyu_rgb_avi": ("huffyuv", "rgb24", dict(pred="plane")),
    "hfyu_rgba_avi": ("huffyuv", "bgra", dict(pred="left", size=(29, 45))),
    "hfyu_tall_avi": ("huffyuv", "yuv422p", dict(pred="median", flags="+ilme",
                                                 size=(300, 64), frames=2)),
    "ffvh_420_avi": ("ffvhuff", "yuv420p", dict(pred="median")),
    "ffvh_ctx_avi": ("ffvhuff", "yuv420p", dict(pred="plane", context=1)),
    "ffvh_il_avi": ("ffvhuff", "yuv420p", dict(pred="median", flags="+ilme",
                                               size=(40, 64))),
    "ffvh_444_avi": ("ffvhuff", "yuv444p", dict(pred="plane")),
    "ffvh_p10_mkv": ("ffvhuff", "yuv422p10le", dict(pred="median")),
    "ffvh_p16_avi": ("ffvhuff", "yuv420p16le", dict(pred="left",
                                                    size=(30, 46))),
    "ffvh_gray_avi": ("ffvhuff", "gray", dict(pred="median")),
    # F8: alpha with 4:2:0 / 4:2:2 chroma at an odd width (a last chroma
    # column the bitstream does not code) and one row high (a 4:2:0 chroma
    # line coded for a plane of none); an odd height beside them.
    "ffvh_a420odd_avi": ("ffvhuff", "yuva420p", dict(pred="left",
                                                     size=(77, 77))),
    "ffvh_a420oddw_mkv": ("ffvhuff", "yuva420p", dict(pred="median",
                                                      size=(64, 77))),
    "ffvh_a420row_avi": ("ffvhuff", "yuva420p", dict(pred="left",
                                                     size=(1, 24))),
    "ffvh_a420rowmed_mkv": ("ffvhuff", "yuva420p", dict(pred="median",
                                                        size=(1, 24))),
    "ffvh_a420tall_avi": ("ffvhuff", "yuva420p", dict(pred="plane",
                                                      size=(77, 64))),
    "ffvh_a422odd_mkv": ("ffvhuff", "yuva422p", dict(pred="median",
                                                     size=(77, 77))),
    "ffvh_a422oddw_avi": ("ffvhuff", "yuva422p", dict(pred="left",
                                                      size=(64, 77))),
    "ffvh_a422row_avi": ("ffvhuff", "yuva422p", dict(pred="median",
                                                     size=(1, 24))),
    "ffvh_gbrap_avi": ("ffvhuff", "gbrap", dict(pred="median",
                                                size=(29, 45))),
    "png_rgb_avi": ("png", "rgb24", dict(tag="MPNG")),
    "png_rgba_mkv": ("png", "rgba", dict(tag="MPNG", pred="mixed")),
    "png_gray_avi": ("png", "gray", dict(tag="PNG1")),
    "png_ya8_avi": ("png", "ya8", dict(tag="png ")),
    "png_pal8_avi": ("png", "pal8", dict(tag="MPNG")),
    "png_rgb48_avi": ("png", "rgb48be", dict(tag="MPNG", size=(29, 45))),
    "png_rgba64_mkv": ("png", "rgba64be", dict(tag="MPNG", size=(29, 45))),
    "png_gray16_avi": ("png", "gray16be", dict(tag="MPNG")),
    "png_ya16_avi": ("png", "ya16be", dict(tag="MPNG", size=(29, 45))),
    **{f"lossless_cv2{t.strip().lower()}_{c}": ("cv2", t, {})
       for t in ("FFV1", "HFYU", "FFVH", "ULY0", "MPNG")
       for c in ("avi", "mkv")},
}
# The clips chip_smoke.py's `lossless` folder trains from, of the
# committed 224x224 clip's first 16 frames: FFV1 as archives keep it
# (`-level 3 -slices 4 -slicecrc 1`, 10-bit 4:2:2) and UT Video as OBS's
# lossless preset records it (ULY0, libavcodec's default left
# prediction).
LOSSLESS_CLIPS = {
    "clip_ffv1_mkv": ("ffv1", "yuv422p10le", dict(level=3, slices=4,
                                                  slicecrc=1)),
    "clip_utvideo_avi": ("utvideo", "yuv420p", dict(pred="left"))}
# HEVC as phones, cameras and x265 write it: streams of the system's
# libx265 (lavc_encode's "libx265", one thread; x265 turns WPP off
# without a thread pool, so the cases that keep its WPP, as its preset
# does, give it a pool of one, HEVC_WPP), HEVC_FRAMES frames of
# moving_frames at HEVC_SIZE (h, w) unless `size` or `frames` say
# otherwise, in the container the name ends with (hevc_file: MP4 `hvc1`
# with its hvcC, ctts and ffmpeg's edit list, or `hev1` with `entry`;
# Matroska V_MPEGH/ISO/HEVC; AVI `HEVC`, Annex B). `params`, the
# x265-params of one setting of the medium preset's defaults (WPP, sign
# hiding, TMVP, SAO, deblocking, a b-pyramid of 4 B-frames, 3 refs,
# weightp, strong intra smoothing); `pixel_format` yuv420p10le for Main
# 10 and `profile` libx265's; `cut`, the packets from the first CRA on
# (an `-c copy` cut of an open-GOP archive: its RASL picture's
# references are gone, so libavcodec drops it and cv2 reads one frame
# fewer than the container counts).
HEVC_FRAMES, HEVC_SIZE = 16, (64, 96)
HEVC_CRA = ("keyint=8:min-keyint=8:open-gop=1:bframes=3:b-adapt=0:"
            "scenecut=0")
HEVC_WPP = "pools=1:wpp=1"
HEVC_CASES = {
    "hevc_default_mp4": dict(params=HEVC_WPP, size=(128, 192)),
    "hevc_hev1_mp4": dict(params="repeat-headers=1", entry="hev1"),
    "hevc_nowpp_mkv": dict(params="no-wpp=1"),
    "hevc_slices_avi": dict(params=HEVC_WPP + ":slices=2",
                            size=(128, 192)),
    "hevc_wpp16_avi": dict(params=HEVC_WPP + ":ctu=16"),
    "hevc_tskip_mkv": dict(params="tskip=1"),
    "hevc_amp_mp4": dict(params="amp=1:rect=1"),
    "hevc_weightb_avi": dict(params="weightb=1"),
    "hevc_scaling_mkv": dict(params="scaling-list=default"),
    "hevc_ctu32_avi": dict(params="ctu=32:min-cu-size=8"),
    "hevc_ctu16_mp4": dict(params="ctu=16:no-sao=1:no-deblock=1"),
    "hevc_opengop_mkv": dict(params=HEVC_CRA),
    "hevc_radl_avi": dict(params="open-gop=0:radl=2"),
    "hevc_irefresh_mp4": dict(params="intra-refresh=1"),
    "hevc_cintra_mkv": dict(params="constrained-intra=1"),
    # F7: libavcodec's own reference samples under constrained intra
    # prediction (csrc/hevc.cpp's cip_refs), intra-only and with P and B
    # pictures, on moving_frames(13) (`seed`) at 192x128
    "hevc_cintra16_avi": dict(
        params="constrained-intra=1:ctu=16:min-cu-size=16:tu-intra-depth=3:"
        "keyint=1", size=(128, 192), frames=3, seed=13),
    "hevc_cintra4_mp4": dict(
        params="constrained-intra=1:min-cu-size=16:max-tu-size=4:keyint=1",
        size=(128, 192), frames=3, seed=13),
    "hevc_cintra32_mkv": dict(
        params="constrained-intra=1:min-cu-size=32:max-tu-size=4",
        size=(128, 192), frames=3, seed=13),
    "hevc_tlayers_avi": dict(params="temporal-layers=1"),
    "hevc_bframes8_mp4": dict(params="bframes=8:b-pyramid=1:ref=6"),
    "hevc_nosign_mkv": dict(params="signhide=0:temporal-mvp=0"),
    "hevc_tu8_avi": dict(params="max-tu-size=8"),
    "hevc_lossless_mp4": dict(params="lossless=1"),
    "hevc_culossless_mkv": dict(params="cu-lossless=1"),
    "hevc_still_avi": dict(params="keyint=1", profile="mainstillpicture"),
    "hevc_crop_mkv": dict(params="", size=(62, 98)),
    "hevc_main10_mp4": dict(params="", pixel_format="yuv420p10le"),
    "hevc_main10gop_mkv": dict(params=HEVC_CRA,
                               pixel_format="yuv420p10le"),
    "hevc_cracut_mp4": dict(params=HEVC_CRA + ":repeat-headers=1",
                            frames=24, cut=True),
    "hevc_cracut_mkv": dict(params=HEVC_CRA + ":repeat-headers=1",
                            frames=24, cut=True),
}
# the hevc folder's clips chip_smoke.py trains from, libx265 of the
# committed 224x224 clip's first 16 frames in open GOPs of 8: a phone's
# (hvc1 MP4 turned 90 degrees with AAC beside it) and its Matroska copy;
# HEVC_CASES' settings
HEVC_CLIPS = {
    "clip_hevc_mp4": dict(params=HEVC_WPP + ":" + HEVC_CRA, matrix=90,
                          audio=True),
    "clip_hevc_mkv": dict(params=HEVC_WPP + ":" + HEVC_CRA),
}
# 4 frames at 1920x1080 (a phone's record size; the committed clip's
# first frames resized), libx265's defaults (WPP too), in MP4:
# chip_smoke.py times
# a frame's decode and holds each frame against cv2's SHA-256 of its BGR
# bytes (HEVC_1080P_SHA, committed instead of the frames)
HEVC_1080P = "hevc_1080p.mp4"
HEVC_1080P_SHA = "hevc_1080p_sha256.json"
# H.264 that does not start at an IDR picture or uses tools libx264 never
# writes, 72x56 at 25 fps (moving_frames of the name's seed), each a
# libx264 stream (x264_encode's settings, `frames` of them) then:
#   * "cut": the packets from packet `cut` on (an `ffmpeg -ss ... -c
#     copy` cut), `strip_sei` leaving the recovery point SEI out
#     (`seed`: moving_frames' seed instead of the name's);
#   * "crop": libx264's own crop_rect (left, top, right, bottom);
#   * "patch": headers rewritten by rewrite_h264 (`poc1`: POC type 1 of
#     to_poc_type1's arguments; `gaps`: the reference P pictures at
#     those packets dropped under gaps_in_frame_num_value_allowed_flag
#     `flag`; `bipred`: explicit B weights (explicit_bipred); `ltr`: the
#     long-term plan of LTR_PLANS and its MMCO 5 packet);
# muxed by h264_cut_file in the container the name ends with.
TOOLS_CUT_GOP = dict(frames=40, open_gop=1, keyint=10)
TOOLS_CUT_LEAD = dict(frames=40, open_gop=1, keyint=10, b_adapt=0,
                      scenecut=0)
TOOLS_CUT_REFRESH = dict(frames=40, intra_refresh=1, keyint=10, cabac=0)
TOOLS_LTR_P = dict(frames=30, keyint=30, bframes=0, ref=3)
TOOLS_LTR_B = dict(frames=30, keyint=30, bframes=2, b_pyramid="none",
                   ref=3, weightb=1, b_adapt=0)
H264_TOOLS = {
    # open GOPs cut at a recovery point: no leading pictures (CABAC,
    # medium), then leading B-pictures in a B-pyramid (the first's
    # reference is gone: dropped); without the SEI (libavcodec's I-picture
    # heuristic, one reference); intra refresh (outputs from the SEI's
    # recovery frame on); a cut among B-pictures before a recovery point;
    # closed GOPs cut at a plain P picture (AVI: no parameter sets until
    # the next IDR picture)
    "h264_gopcut_avi": dict(kind="cut", x264=TOOLS_CUT_GOP, cut=10),
    "h264_gopcut_mkv": dict(kind="cut", x264=TOOLS_CUT_GOP, cut=10),
    "h264_gopcut_mp4": dict(kind="cut", x264=TOOLS_CUT_GOP, cut=10),
    "h264_leadcut_mkv": dict(kind="cut", x264=TOOLS_CUT_LEAD, cut=9),
    "h264_leadcut_mp4": dict(kind="cut", x264=TOOLS_CUT_LEAD, cut=9),
    "h264_noseicut_mkv": dict(kind="cut", x264={**TOOLS_CUT_LEAD, "ref": 1},
                              cut=9, strip_sei=True),
    "h264_refcut_avi": dict(kind="cut", x264=TOOLS_CUT_REFRESH, cut=10,
                           seed=3),
    "h264_refcut_mkv": dict(kind="cut", x264=TOOLS_CUT_REFRESH, cut=10,
                           seed=3),
    "h264_refcut_mp4": dict(kind="cut", x264=TOOLS_CUT_REFRESH, cut=10,
                           seed=3),
    "h264_midcut_mkv": dict(kind="cut", x264=TOOLS_CUT_LEAD, cut=13),
    "h264_pcut_mkv": dict(kind="cut", x264=dict(frames=40, keyint=10),
                          cut=13),
    "h264_pcut_avi": dict(kind="cut", x264=dict(frames=40, keyint=10),
                          cut=11),
    # left and top crops (cv2's picture is libavcodec's aligned crop,
    # scaled to the cropped size by its swscale)
    "h264_crop84_avi": dict(kind="crop", crop="8,4,0,0"),
    "h264_crop2_avi": dict(kind="crop", crop="2,2,2,2"),
    "h264_crop32_mkv": dict(kind="crop", crop="32,0,0,16"),
    "h264_croptop_avi": dict(kind="crop", crop="0,6,0,0"),
    "h264_crop444_avi": dict(kind="crop", crop="3,0,0,0",
                             x264=dict(csp=12, profile="high444")),
    "h264_crop10_mkv": dict(kind="crop", crop="8,2,0,0",
                            x264=dict(bitdepth=10, profile="high10")),
    "h264_crop422_mp4": dict(kind="crop", crop="4,0,0,0",
                             x264=dict(csp=6, profile="high422")),
    # POC type 1: Baseline (POC 2 a frame, delta_pic_order_always_zero)
    # and with its deltas; B-pyramids in CABAC and B-frames in CAVLC
    "h264_poc1_avi": dict(kind="patch", x264=dict(profile="baseline"),
                          poc1=dict(always_zero=True)),
    "h264_poc1d_avi": dict(kind="patch", x264=dict(profile="baseline"),
                           poc1=dict(non_ref=-3, cycle=(1, 3))),
    "h264_poc1b_mkv": dict(kind="patch", x264=dict(keyint=30), poc1={}),
    "h264_poc1c_mp4": dict(kind="patch", x264=dict(keyint=30, cabac=0,
                                                   b_pyramid="none"),
                           poc1=dict(non_ref=-1, cycle=(2, 2))),
    # gaps in frame_num: reference P pictures dropped, with the SPS's flag
    # and without it, Baseline and B-frames
    "h264_gaps_avi": dict(kind="patch", x264=dict(profile="baseline"),
                          gaps=((5, 11, 12), 1)),
    "h264_gapsoff_avi": dict(kind="patch", x264=dict(profile="baseline"),
                             gaps=((5, 11, 12), 0)),
    "h264_gapsb_mkv": dict(kind="patch", x264=dict(keyint=30),
                           gaps=((5, 7), 1)),
    "h264_gapsboff_mkv": dict(kind="patch", x264=dict(keyint=30),
                              gaps=((5, 7), 0)),
    # explicit bi-predictive weights (weighted_bipred_idc 1), CABAC and
    # CAVLC
    "h264_bipred_avi": dict(kind="patch", x264=dict(keyint=30, weightb=1),
                            bipred=0),
    "h264_bipredc_mkv": dict(kind="patch", x264=dict(
        keyint=30, weightb=1, cabac=0, b_pyramid="none"), bipred=1),
    # long-term references: an IDR picture's long_term_reference_flag,
    # MMCO 1-4 and 6, list modification idc 2; P pictures in CABAC and
    # CAVLC, B pictures (implicit weights) under temporal and spatial
    # direct prediction; each also with an MMCO 5
    "h264_ltr_avi": dict(kind="patch", x264=TOOLS_LTR_P, ltr="p"),
    "h264_ltr5_mkv": dict(kind="patch", x264=TOOLS_LTR_P, ltr="p", reset=20),
    "h264_ltrc5_avi": dict(kind="patch", x264={**TOOLS_LTR_P, "cabac": 0},
                           ltr="p", reset=18),
    "h264_ltrt_avi": dict(kind="patch", x264={**TOOLS_LTR_B,
                                              "direct": "temporal"},
                          ltr="b"),
    "h264_ltrt5_mkv": dict(kind="patch", x264={**TOOLS_LTR_B,
                                               "direct": "temporal"},
                           ltr="b", reset="P6"),
    "h264_ltrs_mp4": dict(kind="patch", x264={**TOOLS_LTR_B,
                                              "direct": "spatial"},
                          ltr="b"),
    "h264_ltrs5_avi": dict(kind="patch", x264={**TOOLS_LTR_B,
                                               "direct": "spatial"},
                           ltr="b", reset="P6"),
    "h264_ltrt5p_mp4": dict(kind="patch", x264={**TOOLS_LTR_B,
                                                "direct": "temporal"},
                            ltr="b", reset="P4", rebase_poc=False),
    # an open-GOP cut whose first P picture puts a grey gap frame first in
    # its list (modification idc 0): libavcodec's noref_gray takes the I
    # picture in its place
    "h264_graycut_mkv": dict(kind="cut", x264=TOOLS_CUT_GOP, cut=10,
                             ltr="gray"),
}
# the long-term plans of H264_TOOLS: picture (a packet, or "P<k>", "B<k>",
# "I<k>": the k-th of its kind) → slice header edits, each a valid
# marking (max_num_ref_frames 3 is never exceeded)
LTR_PLANS = {
    "p": {0: dict(long_term=1),
          3: dict(mmco=[(1, 1), (4, 2), (3, 0, 1)]),
          5: dict(mods0=[(2, 1), (2, 0)]),
          6: dict(mods0=[(0, 0), (2, 0)]),
          8: dict(mmco=[(2, 0)]),
          10: dict(mmco=[(1, 1), (6, 0)]),
          13: dict(mmco=[(4, 1)]),
          16: dict(mmco=[(6, 2)])},
    "b": {"I0": dict(long_term=1),
          "P2": dict(mmco=[(4, 2), (3, 0, 1)]),
          **{f"B{k}": dict(mods1=[(2, 0)]) for k in (2, 4, 6)},
          **{f"B{k}": dict(mods0=[(2, 1)], mods1=[(2, 1)]) for k in (3, 5, 7)},
          "P5": dict(mmco=[(2, 0)]),
          "P7": dict(mmco=[(1, 0), (6, 0)])},
    "gray": {"P0": dict(mods0=[(0, 1)])},
}
# the cuts folder's clip chip_smoke.py trains from: the committed 224x224
# clip's first 24 frames in open GOPs of 8 with leading B-pictures (CABAC,
# B-pyramid), cut at the first recovery point (packet 5: 19 packets, of
# which libavcodec outputs 16), with a sound track
TOOLS_CLIPS = {"clip_gopcut_mkv": dict(kind="cut", x264=dict(
    frames=24, open_gop=1, keyint=8, b_adapt=0, scenecut=0), cut=5)}
# Video as mkvmerge and other muxers store it, held by
# tests/test_torch_video_muxers.py; written by muxer_file from `stream`
# (muxer_stream): "h264", libx264's High with B-frames at `fps` (its
# VUI's rate; `vui` False drops the VUI); "h264gbr", libx264rgb's GBR of
# `sizes` (h, w) in turn (8 frames, then 4 each: libavformat's probe
# takes the size of the SPS active at the 7th picture it decodes), a new
# SPS at each; "hevc", libx265's Main at `fps` (`params`, its
# x265-params); "mpeg4", libavcodec's mpeg4 with B-VOPs (`bf`) at `fps`
# (its VOL's rate); "mpeg2"/"mpeg1", libavcodec's mpeg2video/mpeg1video
# at `fps` (frame_rate_code); "vp8", cv2's VP8; "mjpeg", PIL's JPEGs in
# `layout` ("fields ...": AVI1 field pairs, two JPEGs a packet at half
# the height; "4:1:1" from cv2's imencode; "grey resize": grey at
# `sizes` in turn); "raw", V_UNCOMPRESSED I420; "huffyuv", libavcodec's
# under V_MS/VFW/FOURCC. MUXER_FRAMES frames of moving_frames (or
# `frames`), in the container the name ends with: an AVI under `fourcc`
# (else MJPG or H264); Matroska with `enc`, mkv_file's content encodings
# ("strip", header stripping of up to 4 bytes every packet begins with;
# "zlib"; "lzo", by lzo1x_compress; on the frames, with "priv" on the
# CodecPrivate too), `rate`, the blocks' rate without DefaultDuration,
# `lace`, (frames a block, 1 Xiph, 2 fixed or 3 EBML lacing); MP4
# fragmented at every keyframe, with `data`, a tmcd or text track
# (mp4_file's), and `desc`, a second sample entry of the first's bytes
# that the fragments after the first name.
MUXER_FRAMES = 12
MUXER_CASES = {
    "h264_strip_mkv": dict(stream="h264", enc="strip"),
    "h264_zlib_mkv": dict(stream="h264", enc="zlib priv"),
    "h264_lzo_mkv": dict(stream="h264", enc="lzo"),
    "hevc_strip_mkv": dict(stream="hevc", enc="strip"),
    "hevc_zlib_mkv": dict(stream="hevc", enc="zlib priv"),
    "mpeg4_strip_mkv": dict(stream="mpeg4", enc="strip"),
    "mpeg2_strip_mkv": dict(stream="mpeg2", enc="strip priv"),
    "vp8_zlib_mkv": dict(stream="vp8", enc="zlib"),
    "mjpeg_strip_mkv": dict(stream="mjpeg", layout="4:2:2", enc="strip"),
    "raw_zlib_mkv": dict(stream="raw", enc="zlib"),
    "hfyu_zlib_mkv": dict(stream="huffyuv", enc="zlib priv"),
    "hfyu_lzo_mkv": dict(stream="huffyuv", enc="lzo"),
    "h264_nodd30_mkv": dict(stream="h264", rate=30),
    "h264_nodd50_mkv": dict(stream="h264", rate=50),
    "h264_vui2997_mkv": dict(stream="h264", fps="30000/1001", rate=25),
    "h264_vui60_mkv": dict(stream="h264", fps="60", rate=25),
    "hevc_nodd24_mkv": dict(stream="hevc", rate=24),
    "hevc_vui15_mkv": dict(stream="hevc", fps=15, rate=25),
    "mpeg4_vol30_mkv": dict(stream="mpeg4", fps=30, rate=25),
    "mpeg4_vol120_mkv": dict(stream="mpeg4", fps=120, rate=25),
    "mpeg4_vol1000_mkv": dict(stream="mpeg4", fps=1000, bf=0, rate=30),
    "mpeg2_nodd24_mkv": dict(stream="mpeg2", fps=24, rate=25),
    "mpeg1_nodd25_mkv": dict(stream="mpeg1", rate=25),
    "mpeg1_nodd60_mkv": dict(stream="mpeg1", fps=60, rate=30),
    "vp8_lace2_mkv": dict(stream="vp8", lace=(2, 1), rate=25),
    "vp8_lace3_mkv": dict(stream="vp8", lace=(3, 3), rate=30),
    "mjpeg_lace3_mkv": dict(stream="mjpeg", layout="4:2:0", lace=(3, 1),
                            rate=25),
    "raw_lace4_mkv": dict(stream="raw", lace=(4, 2), rate=25),
    "h264_lace2_mkv": dict(stream="h264", lace=(2, 3), rate=25),
    "h264_striplace_mkv": dict(stream="h264", enc="strip", lace=(3, 1)),
    "mpeg4_fragtmcd_mp4": dict(stream="mpeg4", data=dict(kind="tmcd")),
    "h264_fragtext_mp4": dict(stream="h264", data=dict(kind="text",
                                                       shift=5)),
    "h264_fragtmcd_mp4": dict(stream="h264", data=dict(kind="tmcd",
                                                       duration=40),
                              audio=True),
    "h264_fragdesc_mp4": dict(stream="h264", desc=True),
    "mjpeg_411_avi": dict(stream="mjpeg", layout="4:1:1"),
    "mjpeg_411odd_avi": dict(stream="mjpeg", layout="4:1:1",
                             size=(29, 45)),
    "mjpeg_fields_avi": dict(stream="mjpeg", layout="fields 4:2:2"),
    "mjpeg_fieldsodd_avi": dict(stream="mjpeg", layout="fields 4:2:0",
                                size=(30, 45)),
    "mjpeg_fields_mkv": dict(stream="mjpeg", layout="fields 4:2:0"),
    "mjpeg_fieldsavrn_avi": dict(stream="mjpeg", layout="fields 4:2:2",
                                 fourcc=b"AVRn"),
    "mjpeg_greyresize_avi": dict(stream="mjpeg", layout="grey resize",
                                 sizes=[(56, 72), (40, 100)]),
    "h264_gbrhalf_avi": dict(stream="h264gbr", sizes=[(32, 24), (56, 72)]),
}
# The clips chip_smoke.py's `phone` folder trains from beside the phone
# clips, of a 224x160 crop of the committed clip's first 16 frames: H.264
# High header-stripped as older mkvmerge wrote it, and HEVC Main without
# DefaultDuration (its rate from its VUI).
MUXER_CLIPS = {"clip_strip_mkv": dict(stream="h264", enc="strip"),
               "clip_nodd_mkv": dict(stream="hevc", rate=25)}
# The H.263 family as old AVIs and OpenCV's writer store it
# (tests/test_torch_video_legacy.py): LEGACY_FRAMES frames of
# moving_frames at LEGACY_SIZE (h, w) unless `size`/`frames` say
# otherwise (`noise`: uniform noise of that amplitude added, so that
# fine quantisers reach the escapes and the high-motion tables), from
# the system's libavcodec 59 (lavc_encode's "msmpeg4v2", "msmpeg4" (v3),
# "wmv1", "wmv2", "flv" with the options given; WMV2's 4-byte extradata
# into the strf), in the container the name ends with: AVI under `tag`
# (avi_file) or Matroska, V_MS/VFW/FOURCC with a BITMAPINFOHEADER (and
# the extradata after it), V_MPEG4/MS/V3 where `v3id`. "cv2" is
# cv2.VideoWriter under the fourcc `tag`. `edit` rewrites the stream
# (legacy_edit): "slices N" the I pictures' slice code (v3, WMV1: N
# slices) or WMV2's extradata's; "skipmap T" WMV2's P pictures with a
# skip map of type T that skips nothing; "skipall" WMV2's P pictures 4
# and 8 skipping every macroblock (no picture, as libavcodec's
# FRAME_SKIPPED); "disposable" FLV1's odd P pictures made disposable.
# The encoders write one slice, the DC and vector tables 1, WMV2's ABT
# type 0 and no mspel, skip map or top-left prediction; v3's and
# WMV1's run-level tables follow the quantiser and content (0: q 31,
# 1: the defaults, 2: noise at a high rate), WMV2's coded block pattern
# tables the quantiser (0 to 10, 11 to 20, 21 to 31); WMV1 codes
# inter-intra prediction below 320x240 at 128 kbit/s or less; "+loop"
# sets WMV2's loop filter; FLV1 at q 1 on noise reaches its 11-bit
# escape. `saturate`: moving_frames' samples made 0 or 255 (chroma
# references at 0, where libavcodec's 8-wide no-round averaging is
# approximate). "syntax" is msmpeg4_syntax's random pictures of `variant`
# (what the encoders never write: every run-level, DC and vector table
# by picture, escapes of every kind, per-macroblock tables, inter-intra
# prediction, WMV2's mspel, ABT, top-left prediction and skip maps),
# `frames` of them (an I picture every 4), seeded by the name.
LEGACY_FRAMES, LEGACY_SIZE = 10, (48, 64)
LEGACY_CASES = {
    "msmpeg4v2_avi": ("msmpeg4v2", "MP42", dict(g=4)),
    "msmpeg4v2_q2_mkv": ("msmpeg4v2", "DIV2", dict(g=5, qmin=2, qmax=2,
                                                    noise=40)),
    "msmpeg4v2_odd_avi": ("msmpeg4v2", "MP42", dict(g=4, size=(45, 77))),
    "msmpeg4_avi": ("msmpeg4", "MP43", dict(g=4)),
    "msmpeg4_div3_avi": ("msmpeg4", "DIV3", dict(g=12, b=3000000,
                                                  noise=120)),
    "msmpeg4_q31_avi": ("msmpeg4", "MPG3", dict(g=12, qmin=31, qmax=31)),
    "msmpeg4_q2_mkv": ("msmpeg4", "DIV4", dict(g=6, qmin=2, qmax=2,
                                                noise=60)),
    "msmpeg4_v3id_mkv": ("msmpeg4", "MP43", dict(g=5, v3id=True)),
    "msmpeg4_odd_avi": ("msmpeg4", "DIV5", dict(g=4, size=(45, 77))),
    "msmpeg4_slices_avi": ("msmpeg4", "DIV6", dict(
        g=4, size=(96, 64), edit="slices 3")),
    "msmpeg4_slices2_mkv": ("msmpeg4", "AP41", dict(
        g=6, size=(112, 48), edit="slices 2", noise=30)),
    "msmpeg4_col1_avi": ("msmpeg4", "COL1", dict(g=300, b=60000)),
    "wmv1_avi": ("wmv1", "WMV1", dict(g=4)),
    "wmv1_ii_avi": ("wmv1", "WMV1", dict(g=6, b=100000)),
    "wmv1_noise_mkv": ("wmv1", "WMV1", dict(g=12, b=3000000, noise=120)),
    "wmv1_q31_avi": ("wmv1", "WMV1", dict(g=12, qmin=31, qmax=31)),
    "wmv1_q2_avi": ("wmv1", "WMV1", dict(g=5, qmin=2, qmax=2, noise=60)),
    "wmv1_odd_avi": ("wmv1", "WMV1", dict(g=4, size=(45, 64))),
    "wmv1_slices_avi": ("wmv1", "WMV1", dict(g=4, size=(96, 64),
                                             edit="slices 2")),
    "wmv2_avi": ("wmv2", "WMV2", dict(g=4)),
    "wmv2_q15_mkv": ("wmv2", "WMV2", dict(g=6, qmin=15, qmax=15)),
    "wmv2_q31_avi": ("wmv2", "WMV2", dict(g=6, qmin=31, qmax=31)),
    "wmv2_noise_avi": ("wmv2", "WMV2", dict(g=12, qmin=2, qmax=2,
                                            noise=60)),
    "wmv2_loop_avi": ("wmv2", "WMV2", dict(g=5, flags="+loop", qmin=12,
                                           qmax=12)),
    "wmv2_loop_mkv": ("wmv2", "WMV2", dict(g=300, flags="+loop",
                                           size=(45, 64))),
    "wmv2_slices_avi": ("wmv2", "WMV2", dict(g=4, size=(96, 64),
                                             edit="slices 3")),
    "wmv2_skipmap1_avi": ("wmv2", "WMV2", dict(g=4, edit="skipmap 1")),
    "wmv2_skipmap2_avi": ("wmv2", "WMV2", dict(g=4, edit="skipmap 2")),
    "wmv2_skipmap3_mkv": ("wmv2", "WMV2", dict(g=4, edit="skipmap 3")),
    "wmv2_skipall_avi": ("wmv2", "WMV2", dict(g=12, edit="skipall")),
    "flv_avi": ("flv", "FLV1", dict(g=4)),
    "flv_q1_mkv": ("flv", "FLV1", dict(g=5, qmin=1, qmax=1, noise=120)),
    "flv_odd_avi": ("flv", "FLV1", dict(g=4, size=(45, 77))),
    "flv_large_avi": ("flv", "FLV1", dict(g=3, size=(16, 272))),
    "flv_disposable_avi": ("flv", "FLV1", dict(g=12, edit="disposable")),
    "msmpeg4_sat_avi": ("msmpeg4", "DIV3", dict(g=12, qmin=31, qmax=31,
                                                 saturate=True)),
    "wmv2_sat_mkv": ("wmv2", "WMV2", dict(g=12, qmin=31, qmax=31,
                                          saturate=True)),
    "msmpeg4_syntax_avi": ("syntax", "DIV3", dict(variant="v3", q=5,
                                                  slices=2, size=(64, 96))),
    "msmpeg4_syntaxq_mkv": ("syntax", "MP43", dict(variant="v3", q=20)),
    "wmv1_syntax_avi": ("syntax", "WMV1", dict(variant="wmv1", q=6)),
    "wmv1_syntaxii_avi": ("syntax", "WMV1", dict(variant="wmv1", q=12,
                                                 bitrate=100 * 1024)),
    "wmv1_syntaxlow_mkv": ("syntax", "WMV1", dict(variant="wmv1", q=9,
                                                  bitrate=30 * 1024)),
    "wmv2_syntax_avi": ("syntax", "WMV2", dict(variant="wmv2", q=4)),
    "wmv2_syntaxq_mkv": ("syntax", "WMV2", dict(variant="wmv2", q=16,
                                                loop=1, slices=2,
                                                size=(64, 96))),
    "wmv2_syntaxnoabt_avi": ("syntax", "WMV2", dict(variant="wmv2", q=24,
                                                    abt=0, top_left=0)),
    "cv2_mp42_avi": ("cv2", "MP42", {}),
    "cv2_mp43_avi": ("cv2", "MP43", {}),
    "cv2_div3_mkv": ("cv2", "DIV3", {}),
    "cv2_wmv1_avi": ("cv2", "WMV1", {}),
    "cv2_wmv2_avi": ("cv2", "WMV2", {}),
    "cv2_wmv2_mkv": ("cv2", "WMV2", {}),
    "cv2_flv1_avi": ("cv2", "FLV1", {}),
}
# The clips chip_smoke.py's `xvid` folder also trains from, of the
# committed 224x224 clip's first 16 frames: DivX 3 as its AVIs hold it,
# WMV8 as Windows Media's AVI exports do; and the family's other codecs
# at that size, which it times a frame of.
LEGACY_CLIPS = {"clip_div3_avi": ("msmpeg4", "DIV3", dict(g=12)),
                "clip_wmv2_avi": ("wmv2", "WMV2", dict(g=12)),
                "clip_mp42_avi": ("msmpeg4v2", "MP42", dict(g=12)),
                "clip_wmv1_avi": ("wmv1", "WMV1", dict(g=12)),
                "clip_flv1_avi": ("flv", "FLV1", dict(g=12))}
# ITU video telephony as OpenCV's writer and old phones store it
# (tests/test_torch_video_itu.py): ITU_FRAMES frames of moving_frames at
# the case's `size` (h, w; QCIF unless given) from the system's
# libavcodec 59 (lavc_encode's "h263", "h263p" and "h261" with the
# options given: "+mv4" 4MV and "obmc" OBMC (Annex F), "ps" a payload
# size that makes GOB headers (or, with "structured_slices", Annex K's
# slices), "umv" (Annex D), "aiv" (Annex S), "+aic" (Annex I, which
# turns on Annex T), "+loop" (Annex J; H.261's loop filter, FIL),
# "scplx_mask" DQUANT; `noise`
# as in LEGACY_CASES), in the container the name ends with: AVI under
# `tag`, Matroska V_MS/VFW/FOURCC with a BITMAPINFOHEADER, or MP4 under
# the sample entry `tag` (s263 or h263, with a d263 box where `d263`).
# "cv2" is cv2.VideoWriter under the fourcc `tag`. `edit` rewrites the
# stream (itu_edit): "longvec" sets baseline's Annex D bit in every
# picture header (the vectors stay in range, so the pictures read the
# same); "ufep0" drops the P pictures' OPPTYPE (UFEP 0: the I picture's
# modes kept); "mq" writes Annex T's DQUANT (a step and an absolute
# quantiser) into the I pictures' intra macroblocks. The baseline
# encoder writes no loop filter (Annex J is H.263+'s): "+loop" leaves
# its stream as it is. libavcodec 59's h263p writes Annex I with Annex T
# and DQUANT that cv2's libavcodec 62 misreads ("cbpy damaged"), so
# Annex T's DQUANT is written in by "mq".
ITU_FRAMES = 8
_CIF, _SQCIF = (288, 352), (96, 128)
ITU_CASES = {
    "h263_avi": ("h263", "H263", dict(g=4)),
    "h263_sqcif_mkv": ("h263", "X263", dict(g=5, size=_SQCIF)),
    "h263_cif_avi": ("h263", "M263", dict(g=8, size=_CIF, frames=4)),
    "h263_mv4_avi": ("h263", "H263", dict(g=8, flags="+mv4")),
    "h263_obmc_avi": ("h263", "H263", dict(g=8, flags="+mv4", obmc=1)),
    "h263_obmcq_mkv": ("h263", "VX1K", dict(g=8, flags="+mv4", obmc=1,
                                            qmin=20, qmax=20)),
    "h263_gob_avi": ("h263", "T263", dict(g=4, ps=200)),
    "h263_q2_avi": ("h263", "L263", dict(g=5, qmin=2, qmax=2, noise=20,
                                          frames=4)),
    "h263_q31_mkv": ("h263", "H263", dict(g=8, qmin=31, qmax=31)),
    "h263_dquant_avi": ("h263", "lsvm", dict(g=8, scplx_mask=0.5)),
    "h263_longvec_avi": ("h263", "H263", dict(g=4, flags="+mv4", obmc=1,
                                              edit="longvec")),
    "h263_loopflag_avi": ("h263", "H263", dict(g=4, flags="+loop")),
    "h263_s263_mp4": ("h263", "s263", dict(g=4, d263=True)),
    "h263_nod263_mp4": ("h263", "s263", dict(g=4)),
    "h263_h263_mp4": ("h263", "h263", dict(g=4, d263=True)),
    "h263p_avi": ("h263p", "U263", dict(g=4, size=(224, 224), frames=4)),
    "h263p_odd_mp4": ("h263p", "s263", dict(g=4, size=(100, 124), umv=1,
                                            d263=True)),
    "h263p_umv_avi": ("h263p", "U263", dict(g=8, umv=1)),
    "h263p_aiv_mkv": ("h263p", "U263", dict(g=8, aiv=1, qmin=4, qmax=4,
                                            noise=30, frames=4)),
    "h263p_aic_avi": ("h263p", "U263", dict(g=4, flags="+aic")),
    "h263p_aicq1_avi": ("h263p", "U263", dict(g=4, flags="+aic", qmin=1,
                                              qmax=1, noise=30, frames=2)),
    "h263p_loop_avi": ("h263p", "U263", dict(g=8, flags="+loop", qmin=12,
                                             qmax=12)),
    "h263p_slices_avi": ("h263p", "U263", dict(g=4, structured_slices=1,
                                               ps=300)),
    "h263p_mq_avi": ("h263p", "U263", dict(g=4, flags="+aic+loop",
                                           qmin=10, qmax=10, edit="mq")),
    "h263p_dquant_mkv": ("h263p", "U263", dict(g=8, scplx_mask=0.5,
                                               tcplx_mask=0.5)),
    "h263p_ufep0_avi": ("h263p", "U263", dict(g=8, edit="ufep0")),
    "h263p_all_avi": ("h263p", "U263", dict(
        g=8, size=(160, 224), umv=1, aiv=1, flags="+aic+loop+mv4", obmc=1,
        structured_slices=1)),
    "h263p_all_mp4": ("h263p", "s263", dict(
        g=8, size=(160, 224), umv=1, aiv=1, flags="+aic+loop+mv4", obmc=1,
        structured_slices=1, ps=400, d263=True)),
    "h263p_allq_mkv": ("h263p", "U263", dict(
        g=8, umv=1, aiv=1, flags="+aic+loop+mv4", obmc=1,
        structured_slices=1, qmin=3, qmax=3, noise=20, frames=4)),
    "h261_avi": ("h261", "H261", dict(g=4)),
    "h261_cif_avi": ("h261", "H261", dict(g=8, size=_CIF, frames=4,
                                          flags="+loop")),
    "h261_q2_mkv": ("h261", "H261", dict(g=8, qmin=2, qmax=2, noise=20,
                                         frames=4, flags="+loop")),
    "h261_q31_avi": ("h261", "H261", dict(g=8, qmin=31, qmax=31,
                                          flags="+loop")),
    "h263_cv2_avi": ("cv2", "H263", {}),
    "h263p_cv2_mkv": ("cv2", "U263", {}),
    "h261_cv2_avi": ("cv2", "H261", {}),
}
# The clips chip_smoke.py holds and times a frame of, of the committed
# 224x224 clip's first 16 frames (resized to CIF with cv2.INTER_AREA):
# H.263+ with every annex of the tentpole in an s263 MP4 as a phone's
# (trained from in chip_smoke.py's xvid folder), H.263 baseline with 4MV
# and OBMC, H.261 with its loop filter.
ITU_CLIPS = {"clip_h263p_mp4": ("h263p", "s263", dict(
                 g=12, umv=1, aiv=1, flags="+aic+loop+mv4", obmc=1,
                 structured_slices=1, d263=True)),
             "clip_h263_avi": ("h263", "H263", dict(g=12, flags="+mv4",
                                                    obmc=1, size=_CIF)),
             "clip_h261_avi": ("h261", "H261", dict(g=12, size=_CIF,
                                                    flags="+loop"))}
# The codecs OpenCV's writer writes that the port reads since
# csrc/magicyuv.cpp, csrc/asv.cpp and csrc/snow.cpp
# (tests/test_torch_video_opencv.py): OPENCV_FRAMES frames of
# moving_frames at OPENCV_SIZE (h, w) unless `size`/`frames` say
# otherwise, in the container the name ends with (AVI under `tag`, or
# Matroska V_MS/VFW/FOURCC with a BITMAPINFOHEADER, the extradata after
# it). "magicyuv", "asv1", "asv2", "snow": libavcodec 59's encoders
# through lavc_encode with the options given ("pixel_format", "pred", the
# quantiser as "global_quality" under "+qscale", "flags" "+qpel"/"+mv4",
# "refs", "g"); `noise` adds ±noise to the frames; `noextra` drops the
# extradata (ASV's quantiser). "magyhand": magicyuv_packet's packets in
# layout `fmt` (10, 12 and 14 bits, which libavcodec 59 does not write,
# several slices, raw slices, the interlace flag, full range, the colour
# matrix). "snowhand": snow_hand_packets' streams (SnowWriter: header
# fields libavcodec 59's encoder never writes: the half-pel filter's own
# taps, diag_mc 0, mv_scale 1 and 2 with them, spatial_scalability, up
# to 8 references, split blocks, grey with its own taps; `key` and
# `inter` its options). "cv2": cv2.VideoWriter under the fourcc `tag` (it
# stores MagicYUV as M8Y0).
OPENCV_FRAMES, OPENCV_SIZE, OPENCV_ODD = 8, (64, 96), (61, 97)
OPENCV_CASES = {
    "magy_rgleft_avi": ("magicyuv", "M8RG", dict(pixel_format="gbrp",
                                                 pred="left")),
    "magy_rggrad_mkv": ("magicyuv", "M8RG", dict(
        pixel_format="gbrp", pred="gradient", size=OPENCV_ODD)),
    "magy_ramedian_avi": ("magicyuv", "M8RA", dict(pixel_format="gbrap",
                                                   pred="median")),
    "magy_g0grad_avi": ("magicyuv", "M8G0", dict(
        pixel_format="gray", pred="gradient", size=OPENCV_ODD)),
    "magy_y0median_avi": ("magicyuv", "M8Y0", dict(pixel_format="yuv420p",
                                                   pred="median")),
    "magy_y0left_mkv": ("magicyuv", "M8Y0", dict(
        pixel_format="yuv420p", pred="left", size=OPENCV_ODD)),
    "magy_y2grad_avi": ("magicyuv", "M8Y2", dict(
        pixel_format="yuv422p", pred="gradient", size=OPENCV_ODD)),
    "magy_y4median_mkv": ("magicyuv", "M8Y4", dict(pixel_format="yuv444p",
                                                   pred="median")),
    "magy_yaleft_avi": ("magicyuv", "M8YA", dict(pixel_format="yuva444p",
                                                 pred="left")),
    "magy_magy_avi": ("magicyuv", "MAGY", dict(pixel_format="yuv420p",
                                               pred="gradient")),
    "magy10_rgmedian_avi": ("magyhand", "M0RG", dict(fmt="gbrp10le", pred=3)),
    "magy10_ragrad_mkv": ("magyhand", "M0RA", dict(
        fmt="gbrap10le", pred=2, size=OPENCV_ODD)),
    "magy10_g0left_avi": ("magyhand", "M0G0", dict(fmt="gray10le", pred=1)),
    "magy10_y0median_avi": ("magyhand", "M0Y0", dict(
        fmt="yuv420p10le", pred=3, size=OPENCV_ODD)),
    "magy10_y2grad_avi": ("magyhand", "M0Y2", dict(fmt="yuv422p10le",
                                                    pred=2)),
    "magy10_y4left_mkv": ("magyhand", "M0Y4", dict(fmt="yuv444p10le",
                                                    pred=1)),
    "magy12_rgmedian_avi": ("magyhand", "M2RG", dict(
        fmt="gbrp12le", pred=3, size=OPENCV_ODD)),
    "magy12_raleft_avi": ("magyhand", "M2RA", dict(fmt="gbrap12le", pred=1)),
    "magy14_rggrad_mkv": ("magyhand", "M2RG", dict(fmt="gbrp14le", pred=2)),
    "magy_slices_avi": ("magyhand", "M8Y0", dict(
        fmt="yuv420p", pred=3, slice_height=16, raw={1})),
    "magy_slices10_mkv": ("magyhand", "M0RG", dict(
        fmt="gbrp10le", pred=3, slice_height=8, raw={0, 2},
        size=OPENCV_ODD)),
    "magy_rows_avi": ("magyhand", "M8Y0", dict(fmt="yuv420p", pred=3,
                                                slice_height=2)),
    "magy_interlaced_avi": ("magyhand", "M8Y2", dict(
        fmt="yuv422p", pred=2, slice_height=32, interlaced=True)),
    "magy_interlaced10_avi": ("magyhand", "M0Y0", dict(
        fmt="yuv420p10le", pred=3, interlaced=True, size=OPENCV_ODD)),
    "magy_range_avi": ("magyhand", "M8Y0", dict(
        fmt="yuv420p", pred=1, full_range=True, matrix=2)),
    "magy_bt709_mkv": ("magyhand", "M0Y4", dict(fmt="yuv444p10le", pred=3,
                                                 matrix=2)),
    "asv1_avi": ("asv1", "ASV1", {}),
    "asv1_odd_mkv": ("asv1", "ASV1", dict(size=OPENCV_ODD)),
    "asv1_q1_avi": ("asv1", "ASV1", dict(global_quality=118, flags="+qscale",
                                         noise=40)),
    "asv1_q31_avi": ("asv1", "ASV1", dict(global_quality=118 * 31,
                                          flags="+qscale")),
    "asv1_noextra_avi": ("asv1", "ASV1", dict(noextra=True)),
    "asv2_avi": ("asv2", "ASV2", {}),
    "asv2_odd_avi": ("asv2", "ASV2", dict(size=OPENCV_ODD)),
    "asv2_q1_mkv": ("asv2", "ASV2", dict(global_quality=118, flags="+qscale",
                                         noise=40)),
    "asv2_q31_avi": ("asv2", "ASV2", dict(global_quality=118 * 31,
                                          flags="+qscale")),
    "asv2_noextra_mkv": ("asv2", "ASV2", dict(noextra=True,
                                              size=OPENCV_ODD)),
    "snow_avi": ("snow", "SNOW", {}),
    "snow_g3_avi": ("snow", "SNOW", dict(g=3)),
    "snow_53_mkv": ("snow", "SNOW", dict(pred=1, g=4)),
    "snow_lossless_avi": ("snow", "SNOW", dict(pred=1, global_quality=0,
                                               flags="+qscale", frames=4)),
    "snow_q_avi": ("snow", "SNOW", dict(global_quality=118 * 8,
                                        flags="+qscale")),
    "snow_qpel_avi": ("snow", "SNOW", dict(flags="+qpel")),
    "snow_mv4_mkv": ("snow", "SNOW", dict(flags="+mv4")),
    "snow_qpelmv4_avi": ("snow", "SNOW", dict(flags="+qpel+mv4",
                                              size=OPENCV_ODD)),
    "snow_refs2_avi": ("snow", "SNOW", dict(refs=2)),
    "snow_refs4_mkv": ("snow", "SNOW", dict(refs=4, flags="+qpel")),
    "snow_444_avi": ("snow", "SNOW", dict(pixel_format="yuv444p")),
    "snow_410_avi": ("snow", "SNOW", dict(pixel_format="yuv410p", g=4)),
    "snow_gray_mkv": ("snow", "SNOW", dict(pixel_format="gray")),
    "snow_odd_avi": ("snow", "SNOW", dict(size=OPENCV_ODD, g=5)),
    "snow_odd53_mkv": ("snow", "SNOW", dict(size=OPENCV_ODD, pred=1,
                                            flags="+mv4")),
    "snow_taps_avi": ("snowhand", "SNOW", dict(key={}, inter=dict(
        taps=[(1, 6, [0, -12, 3, 0]), (1, 4, [0, -6, 1, 0])], mv=4))),
    "snow_taps2_mkv": ("snowhand", "SNOW", dict(
        key=dict(wavelet=0), inter=dict(taps=[(1, 2, [0, -5, 0, 0]),
                                             (0, 6, [0, -10, 2, 0])], mv=4))),
    "snow_tapsqpel_avi": ("snowhand", "SNOW", dict(
        key=dict(mv_scale=2), keyint=4,
        inter=dict(taps=[(1, 6, [0, -12, 3, 0])] * 2, mv=5))),
    "snow_scal_avi": ("snowhand", "SNOW", dict(
        key=dict(spatial_scalability=1, depth=1, max_refs=3, count=3),
        inter=dict(taps=[(1, 6, [40, -10, 2, 0])] * 2, mv=4),
        size=OPENCV_ODD)),
    "snow_refs8_mkv": ("snowhand", "SNOW", dict(
        key=dict(max_refs=8, mv_scale=1), frames=10,
        inter=dict(taps=[(1, 6, [40, -10, 2, 0])] * 2, mv=7))),
    "snow_tapsgray_avi": ("snowhand", "SNOW", dict(
        key=dict(colorspace=1, shifts=(0, 0)), inter=dict(
            taps=[(0, 4, [0, -7, 2, 0])], mv=4))),
    **{f"{c}_cv2_{m}": ("cv2", t, {}) for c, t in (
        ("magy", "MAGY"), ("asv1", "ASV1"), ("asv2", "ASV2"),
        ("snow", "SNOW")) for m in ("avi", "mkv")},
}
# The clips chip_smoke.py holds, times a frame of and trains from, of the
# committed 224x224 clip's first 16 frames as cv2.VideoWriter writes
# them: MagicYUV (M8Y0; the `lossless` folder), Snow and ASV2 (the
# `xvid` folder).
OPENCV_CLIPS = {"clip_magy_avi": ("cv2", "MAGY", {}),
                "clip_snow_avi": ("cv2", "SNOW", {}),
                "clip_asv2_mkv": ("cv2", "ASV2", {})}
# Every case with an .npz of cv2's view
HELD = (*DECODED, *CONTAINER_CASES, *CAMERA_CASES, *BROWSER_CASES,
        *BROWSER_CLIPS, *SCREEN_CASES, *DVD_CASES, *DVD_CLIPS, *RAW_CASES,
        *RAW_CLIPS, *HEVC_CASES, *HEVC_CLIPS, *H264_TOOLS, *TOOLS_CLIPS,
        *LOSSLESS_CASES, *LOSSLESS_CLIPS, *MUXER_CASES, *MUXER_CLIPS,
        *LEGACY_CASES, *LEGACY_CLIPS, *ITU_CASES, *ITU_CLIPS,
        *OPENCV_CASES, *OPENCV_CLIPS)


def codec_of(name: str) -> str:
    """The codec a case holds, by its name."""
    if name in OPENCV_CASES or name in OPENCV_CLIPS:
        stem = name.split("_")[1] if name.startswith("clip_") else name
        return ("magicyuv" if stem.startswith("magy") else
                "asv" if stem.startswith("asv") else "snow")
    if name in LEGACY_CASES or name in LEGACY_CLIPS:
        return "h263"
    if name in ITU_CASES or name in ITU_CLIPS:
        return "h261" if name.startswith(("h261", "clip_h261")) else "h263"
    if name in MUXER_CASES or name in MUXER_CLIPS:
        kind = {**MUXER_CASES, **MUXER_CLIPS}[name]["stream"]
        return {"h264gbr": "h264", "mpeg2": "mpeg12", "mpeg1": "mpeg12",
                "hfyu": "huffyuv"}.get(kind, kind)
    if (name in PHONE_CLIPS or name in CAMERA_CLIPS or name in SCREEN_CLIPS
            or name in TOOLS_CLIPS):
        return "h264"
    if name in BROWSER_CLIPS:
        return "vp9"
    if name in DVD_CASES or name in DVD_CLIPS or name in DVD_UNREAD:
        return "mpeg12"
    if name in RAW_CLIPS:
        return "raw"
    if name in LOSSLESS_CASES or name in LOSSLESS_CLIPS:
        enc, kind, _ = {**LOSSLESS_CASES, **LOSSLESS_CLIPS}[name]
        if enc == "cv2":
            enc = {"FFV1": "ffv1", "ULY0": "utvideo", "MPNG": "png"}.get(
                kind, "huffyuv")
        return {"classic": "huffyuv", "ffvhuff": "huffyuv"}.get(enc, enc)
    if name in HEVC_CLIPS:
        return "hevc"
    if name in CLIP_CASES:
        return {"MJPG": "mjpeg", "mp4v": "mpeg4", "XVID": "mpeg4",
                "DX50": "mpeg4", "VP80": "vp8",
                "VP90": "vp9", "vp09": "vp9",
                "avc1": "h264"}[CLIP_CASES[name][1]]
    return {"xvid": "mpeg4"}.get(name.split("_")[0], name.split("_")[0])


def path_of(name: str) -> str:
    if (name in PHONE_CLIPS or name in CAMERA_CLIPS or name in BROWSER_CLIPS
            or name in SCREEN_CLIPS or name in DVD_CLIPS or name in RAW_CLIPS
            or name in HEVC_CLIPS or name in TOOLS_CLIPS
            or name in LOSSLESS_CLIPS or name in MUXER_CLIPS
            or name in LEGACY_CLIPS or name in ITU_CLIPS
            or name in OPENCV_CLIPS):
        return os.path.join(FIXTURES, ".".join(name.rsplit("_", 1)))
    if name in CLIP_CASES:
        return os.path.join(FIXTURES, name.rsplit("_", 1)[0] + "." +
                            CLIP_CASES[name][0])
    return os.path.join(FIXTURES, f"{name}.{name.rsplit('_', 1)[1]}")


def moving_frames(seed: int, t: int, h: int = H, w: int = W) -> np.ndarray:
    """(t, h, w, 3) uint8 BGR: drifting waves and a 24x24 smooth random
    texture moving 2 px right and 1 px down a frame."""
    rng = np.random.default_rng(seed)
    coarse = rng.uniform(0, 255, (5, 5, 3))
    u = np.linspace(0, 4, 24)
    i0 = np.minimum(u.astype(int), 3)
    a = (u - i0)[:, None, None]
    rows = coarse[i0] * (1 - a) + coarse[i0 + 1] * a         # (24, 5, 3)
    tex = rows[:, i0] * (1 - a[:, 0]) + rows[:, i0 + 1] * a[:, 0]
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    out = np.empty((t, h, w, 3), np.uint8)
    for k in range(t):
        f = np.stack([128 + 100 * np.sin((x + 3 * k) / 9.0),
                      128 + 90 * np.cos((y - k) / 7.0),
                      128 + 80 * np.sin((x + y + 2 * k) / 13.0)], -1)
        y0, x0 = 4 + k, 5 + 2 * k
        hh, ww = max(min(24, h - y0), 0), max(min(24, w - x0), 0)
        f[y0:y0 + hh, x0:x0 + ww] = tex[:hh, :ww]
        out[k] = np.clip(np.rint(f), 0, 255)
    return out


def write_cv2(path: str, fourcc: str, fps: float, frames) -> None:
    """cv2.VideoWriter with `fourcc` ("" for 0, OpenCV's "no compression"
    choice)."""
    import cv2

    h, w = frames[0].shape[:2]
    wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*fourcc) if fourcc
                         else 0, fps, (w, h))
    if not wr.isOpened():
        raise RuntimeError(f"cv2 cannot write {fourcc} to {path}")
    for f in frames:
        wr.write(np.ascontiguousarray(f))
    wr.release()


def strip_dht(jpeg: bytes) -> bytes:
    """A JPEG without its DHT segments (standard tables assumed)."""
    out, p = bytearray(jpeg[:2]), 2
    while p < len(jpeg):
        m = jpeg[p + 1]
        n = struct.unpack(">H", jpeg[p + 2:p + 4])[0]
        if m == 0xDA:
            out += jpeg[p:]
            break
        if m != 0xC4:
            out += jpeg[p:p + 2 + n]
        p += 2 + n
    return bytes(out)


def _chunk(tag: bytes, data: bytes) -> bytes:
    return tag + struct.pack("<I", len(data)) + data + b"\0" * (len(data) & 1)


def _list(tag: bytes, data: bytes) -> bytes:
    return _chunk(b"LIST", tag + data)


def _avi_audio_strl(audio: dict, extra: bytes = b"") -> bytes:
    """An `auds` stream's strl of audio_track's PCM: WAVE_FORMAT_PCM,
    mono, 16-bit; `extra`, its indx."""
    rate = audio["rate"]
    length = sum(len(a) for a in audio["frames"]) // 2
    strh = (b"auds" + bytes(4) + struct.pack(
        "<IHHIIIIIIIIhhhh", 0, 0, 0, 0, 2, 2 * rate, 0, length, 0,
        0xFFFFFFFF, 2, 0, 0, 0, 0))
    strf = struct.pack("<HHIIHHH", 1, 1, rate, 2 * rate, 2, 16, 0)
    return _list(b"strl", _chunk(b"strh", strh) + _chunk(b"strf", strf)
                 + extra)


def _avi_chunks(packets: list[bytes], audio: dict | None, lo: int, hi: int,
                vtag: bytes, atag: bytes) -> list[tuple[bytes, bytes]]:
    """The chunks of frames lo..hi in movi order: each video packet with
    its frame's audio before it (the audio stream first) or after it."""
    out = []
    for i in range(lo, hi):
        if audio and audio["first"]:
            out.append((atag, audio["frames"][i]))
        out.append((vtag, packets[i]))
        if audio and not audio["first"]:
            out.append((atag, audio["frames"][i]))
    return out


def avi_file(packets: list[bytes], w: int, h: int, fps: int, count: int,
             fourcc: bytes = b"MJPG", audio: dict | None = None,
             bits: int = 24, top_down: bool = False,
             extradata: bytes = b"") -> bytes:
    """An AVI of video packets (stream 0 'vids' `fourcc`, `00dc` chunks,
    an idx1 index with every packet a keyframe) whose avih and strh say
    `count` frames; `audio`, a sound track (audio_track) as a second
    stream, `auds` WAVE_FORMAT_PCM, stream 0 when its "first" is true
    (the video stream 1, `01dc`), its `##wb` chunks interleaved with the
    video's, one a frame, in movi and idx1. strf (BITMAPINFOHEADER): the
    bit count `bits`, the height negative when `top_down` (a top-down
    DIB), `extradata` after its 40 bytes (a BI_RGB colour table of B, G,
    R, 0 entries); fourcc b"\\0\\0\\0\\0" is BI_RGB."""
    vid = 1 if audio and audio["first"] else 0
    avih = struct.pack("<14I", 1000000 // fps, 0, 0, 0x10, count, 0,
                       2 if audio else 1, 0, w, h, 0, 0, 0, 0)
    strh = (b"vids" + fourcc + struct.pack(
        "<IHHIIIIIIIIhhhh", 0, 0, 0, 0, 1, fps, 0, count, 0, 0xFFFFFFFF, 0,
        0, 0, w, h))
    strf = struct.pack("<IiiHH4sIiiII", 40, w, -h if top_down else h, 1,
                       bits, fourcc, w * h * 3, 0, 0, 0, 0) + extradata
    strls = [_list(b"strl", _chunk(b"strh", strh) + _chunk(b"strf", strf))]
    if audio:
        strls.insert(1 - vid, _avi_audio_strl(audio))
    hdrl = _list(b"hdrl", _chunk(b"avih", avih) + b"".join(strls))
    movi, idx, off = b"", b"", 4
    for tag, p in _avi_chunks(packets, audio, 0, len(packets),
                              b"%02ddc" % vid, b"%02dwb" % (1 - vid)):
        c = _chunk(tag, p)
        idx += tag + struct.pack("<III", 0x10, off, len(p))
        movi += c
        off += len(c)
    body = hdrl + _list(b"movi", movi) + _chunk(b"idx1", idx)
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"AVI " + body


def avi_odml_file(packets: list[bytes], w: int, h: int, fps: int,
                  split: int, fourcc: bytes = b"MJPG",
                  length: int | None = None,
                  total: int | None = None,
                  audio: dict | None = None) -> bytes:
    """An OpenDML AVI of video packets, as ffmpeg's muxer writes one past
    its first RIFF: `packets[:split]` in the movi list of `RIFF AVI `,
    the rest in that of one `RIFF AVIX`, each movi list closed by its
    `ix00` standard index (keyframes only: every entry's bit 31 clear);
    an `indx` super-index over the two in the stream's strl; no idx1.
    The avih counts the first RIFF's frames, the strh `length` (None:
    all) and the odml list's dmlh `total` (None: all). `audio`, a sound
    track (audio_track) as a second stream as in avi_file, with its own
    `ix##` indexes and `indx`."""
    n = len(packets)
    length = n if length is None else length
    total = n if total is None else total
    vid = 1 if audio and audio["first"] else 0
    tags = [b"%02ddc" % vid] + ([b"%02dwb" % (1 - vid)] if audio else [])
    avih = struct.pack("<14I", 1000000 // fps, 0, 0, 0x10, split, 0,
                       len(tags), 0, w, h, 0, 0, 0, 0)
    strh = (b"vids" + fourcc + struct.pack(
        "<IHHIIIIIIIIhhhh", 0, 0, 0, 0, 1, fps, 0, length, 0, 0xFFFFFFFF,
        0, 0, 0, w, h))
    strf = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 24, fourcc, w * h * 3,
                       0, 0, 0, 0)
    parts = [_avi_chunks(packets, audio, a, b, tags[0], tags[-1])
             for a, b in ((0, split), (split, n))]

    def movi(chunks, at: int) -> tuple[bytes, list[bytes]]:
        """A movi list whose first byte lies at file offset `at`, and its
        ix## chunks (the list's last), one a stream."""
        body, entries, off = b"", {t: [] for t in tags}, at + 12
        for tag, p in chunks:
            entries[tag].append(struct.pack("<II", off + 8 - at, len(p)))
            c = _chunk(tag, p)
            body += c
            off += len(c)
        ixs = [_chunk(b"ix" + t[:2], struct.pack(
            "<HBBI4sQI", 2, 0, 1, len(entries[t]), t, at, 0)
            + b"".join(entries[t])) for t in tags]
        return _list(b"movi", body + b"".join(ixs)), ixs

    def layout(super_entries: list[bytes]):
        def indx(t: bytes, e: bytes) -> bytes:
            return _chunk(b"indx", struct.pack("<HBBI4s3I", 4, 0, 0, 2, t,
                                               0, 0, 0) + e)

        odml = _list(b"odml", _chunk(b"dmlh", struct.pack("<I", total)
                                     + bytes(244)))
        strls = [_list(b"strl", _chunk(b"strh", strh) + _chunk(b"strf", strf)
                       + indx(tags[0], super_entries[0]))]
        if audio:
            strls.insert(1 - vid, _avi_audio_strl(
                audio, indx(tags[1], super_entries[1])))
        hdrl = _list(b"hdrl", _chunk(b"avih", avih) + b"".join(strls)
                     + odml)
        ix_at = {t: [] for t in tags}
        ix_len = {t: [] for t in tags}
        out = b""
        for k, part in enumerate(parts):
            at = 12 + len(hdrl) if k == 0 else len(out) + 12
            m, ixs = movi(part, at)
            pos = at + len(m) - sum(len(ix) for ix in ixs)
            for t, ix in zip(tags, ixs):
                ix_at[t].append(pos)
                ix_len[t].append(len(ix))
                pos += len(ix)
            if k == 0:
                first = hdrl + m
                out = b"RIFF" + struct.pack("<I", 4 + len(first)) + b"AVI " \
                    + first
            else:
                out += b"RIFF" + struct.pack("<I", 4 + len(m)) + b"AVIX" + m
        return out, ix_at, ix_len

    def durations(t: bytes) -> list[int]:
        return [sum(len(p) // 2 if t != tags[0] else 1
                    for tag, p in part if tag == t) for part in parts]

    _, ix_at, ix_len = layout([struct.pack("<QII", 0, 0, 0) * 2] * len(tags))
    entries = [b"".join(struct.pack("<QII", a, s, d) for a, s, d in zip(
        ix_at[t], ix_len[t], durations(t))) for t in tags]
    return layout(entries)[0]


def _box(kind: bytes, *parts: bytes) -> bytes:
    body = b"".join(parts)
    return struct.pack(">I", 8 + len(body)) + kind + body


def _full_box(kind: bytes, flags: int, *parts: bytes) -> bytes:
    return _box(kind, struct.pack(">I", flags), *parts)


# The identity display matrix (a, b, u, c, d, v, x, y, w: 16.16 but u, v
# and w, 2.30), as mvhd and tkhd hold it.
IDENTITY = (0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)


def display_matrix(degrees: float = 0.0, scale: float = 1.0,
                   mirror: str = "", w: int = 0, h: int = 0) -> tuple:
    """The display matrix that turns the picture `degrees` clockwise, as
    phones and ffmpeg's muxer write it (90: (0, 1, -1, 0) with the
    picture's height as the x translation), scaled by `scale`; `mirror`
    "h" (-1, 0, 0, 1), "v" (1, 0, 0, -1) or "t" (the transpose, (0, 1, 1,
    0)) instead."""
    import math

    if mirror:
        a, b, c, d = {"h": (-1, 0, 0, 1), "v": (1, 0, 0, -1),
                      "t": (0, 1, 1, 0)}[mirror]
    else:
        r = math.radians(degrees)
        a, b, c, d = math.cos(r), math.sin(r), -math.sin(r), math.cos(r)
    tx, ty = {90: (h, 0), 180: (w, h), 270: (0, w)}.get(int(degrees) % 360,
                                                        (0, 0))
    return tuple(int(round(v * scale * 0x10000)) for v in (a, b)) + (0,) + \
        tuple(int(round(v * scale * 0x10000)) for v in (c, d)) + (0,) + \
        (tx << 16, ty << 16, 0x40000000)


# trun/tfhd sample flags: a sync sample, and one that is not (depends on
# others, sample_is_non_sync_sample), as ffmpeg's muxer writes them
SYNC_FLAGS, NON_SYNC_FLAGS = 0x02000000, 0x01010000


def mp4_file(packets: list[bytes], w: int, h: int, fps: int,
             entry: bytes, boxes: bytes = b"", ctts: list[int] | None = None,
             media_time: int | None = None,
             sync: list[int] | None = None,
             edits: list[tuple[int, int, int]] | None = None,
             matrix: tuple | None = None, movie_matrix: tuple | None = None,
             version: int = 0, chunk: list[int] | None = None,
             audio: dict | None = None,
             fragments: list[int] | None = None, moov_samples: int = 0,
             mehd: bool = False, base_offset: bool = False,
             data_track: dict | None = None, run_samples: int | None = None,
             entries: list[bytes] | None = None,
             descriptions: list[int] | None = None) -> bytes:
    """An MP4 of one video track: `packets` as its samples (one chunk,
    1/fps apart in decode order) under the visual sample entry `entry`
    (a fourcc) holding the extension `boxes`; `ctts`, each sample's
    composition offset in frames; `media_time`, an edit list of one
    edit over the whole track from that media time (in frames), as
    ffmpeg's muxer writes for streams with B-frames; `edits`, an edit
    list of (segment duration, media time, rate in 16.16) entries in
    frames instead (media time -1: an empty edit); `sync`, the sync
    samples (0-based; None: every sample, no stss box).

    `matrix` and `movie_matrix`, tkhd's and mvhd's display matrices (see
    display_matrix; None: the identity); `version` 1 writes mvhd, tkhd
    and mdhd with 64-bit times. `chunk`, the video samples of each chunk
    in turn (cycled: several stsc runs), each followed (or, with the
    audio track first, preceded) by a chunk of the audio of its frames;
    `audio`, a sound track (audio_track: PCM as `sowt`, one sample a PCM
    frame; aac_track: AAC as `mp4a` with its esds and the edit list that
    hides the encoder's priming, as ffmpeg's muxer writes it) whose trak
    comes before the video's when its "first" is true.

    `fragments`, the video samples of each movie fragment (a moof with
    mfhd, a traf per track with tfhd, tfdt and trun, then an mdat, as
    ffmpeg's `-movflags frag_keyframe` writes them) after the first
    `moov_samples`, which moov's own tables hold (0: `empty_moov`, every
    table empty); moov then holds mvex with a trex per track and, with
    `mehd`, the fragments' duration; a fragment's audio is one trun
    entry a PCM frame's block or an AAC packet. A fragment's tfhd bases
    its trun's data offsets at the moof (default-base-is-moof), or, with
    `base_offset`, gives the mdat's payload as its base-data-offset; a
    trun of version 1 when a composition offset is negative.

    With fragments, `data_track` adds a timecode or text track after the
    others ("kind" "tmcd": a QuickTime tmcd sample entry at `fps`, each
    sample the 4-byte frame number; "text": a tx3g entry under the
    `text` handler, each sample a 2-byte length and "t"): one sample a
    fragment spanning its video frames, its tfdt `shift` frames later
    (default 0), its mdhd duration `duration` frames (default 0), its
    bytes after the fragment's others in its mdat. `run_samples`, the
    video samples of each trun of a fragment's traf, the runs after the
    first without a data offset (their samples the standard places after
    the run before; libavformat reads them from the traf's base again).
    `entries`, more video sample entries after `entry`'s in stsd (whole
    boxes), and `descriptions`, each fragment's sample_description_index
    in its tfhd (1 is `entry`)."""
    n = len(packets)
    if media_time is not None:
        edits = [(n, media_time, 0x10000)]

    def pack_matrix(m):
        return struct.pack(">9i", *(IDENTITY if m is None else m))

    sample_entry = _box(entry, bytes(6), struct.pack(
        ">HHH12xHHIIIH32sHh", 1, 0, 0, w, h, 0x480000, 0x480000, 0, 1,
        b"", 24, -1), boxes)
    fragmented = fragments is not None
    in_moov = moov_samples if fragmented else n
    extra = b""
    if ctts is not None:
        runs: list[list[int]] = []
        for off in ctts[:in_moov]:
            if runs and runs[-1][1] == off:
                runs[-1][0] += 1
            else:
                runs.append([1, off])
        extra += _full_box(b"ctts", 0, struct.pack(">I", len(runs)),
                           *(struct.pack(">Ii", c, o) for c, o in runs))
    if sync is not None:
        s = [i for i in sync if i < in_moov]
        extra += _full_box(b"stss", 0, struct.pack(">I", len(s)),
                           *(struct.pack(">I", i + 1) for i in s))
    edts = b""
    if edits is not None:
        edts = _box(b"edts", _full_box(b"elst", 0, struct.pack(
            ">I", len(edits)), *(struct.pack(">IiI", d, t, r)
                                 for d, t, r in edits)))
    # Chunks of the video samples in moov's tables: (first, end).
    sizes = chunk or [max(in_moov, 1)]
    spans, at, k = [], 0, 0
    while at < in_moov:
        spans.append((at, min(at + sizes[k % len(sizes)], in_moov)))
        at, k = spans[-1][1], k + 1
    audio_first = bool(audio and audio["first"])
    aac = bool(audio and "aac" in audio)
    if aac:
        # Each AAC packet with the video frame its decode time falls in.
        rate = audio["rate"]
        frame_of = [min(1024 * i * fps // rate, n - 1)
                    for i in range(len(audio["aac"]))]

    def audio_samples(a: int, b: int) -> list[bytes]:
        """The audio of video frames a..b as MP4 samples: AAC packets, or
        each frame's PCM block."""
        if aac:
            last = b >= n
            return [p for p, f in zip(audio["aac"], frame_of)
                    if a <= f and (f < b or last)]
        return audio["frames"][a:b]

    def stsc(counts: list[int]) -> bytes:
        runs = []
        for i, c in enumerate(counts):
            if not runs or runs[-1][1] != c:
                runs.append((i + 1, c))
        return _full_box(b"stsc", 0, struct.pack(">I", len(runs)),
                         *(struct.pack(">III", f, c, 1) for f, c in runs))

    def times(kind: bytes, scale: int, duration: int, tail: bytes) -> bytes:
        if version == 1:
            return _full_box(kind, 1 << 24, struct.pack(
                ">QQIQ", 0, 0, scale, duration), tail)
        return _full_box(kind, 0, struct.pack(">IIII", 0, 0, scale,
                                              duration), tail)

    def video_trak(offsets: list[int]) -> bytes:
        counts = [b - a for a, b in spans]
        if len(spans) <= 1 and not fragmented:
            table = _full_box(b"stsc", 0, struct.pack(">IIII", 1, 1, n, 1))
        else:
            table = stsc(counts)
        stbl = _box(
            b"stbl",
            _full_box(b"stsd", 0, struct.pack(">I", 1 + len(entries or [])),
                      sample_entry, *(entries or [])),
            _full_box(b"stts", 0, *([struct.pack(">III", 1, in_moov, 1)]
                                    if in_moov else [struct.pack(">I", 0)])),
            extra, table,
            _full_box(b"stsz", 0, struct.pack(">II", 0, in_moov),
                      *(struct.pack(">I", len(p))
                        for p in packets[:in_moov])),
            _full_box(b"stco", 0, struct.pack(">I", len(offsets)),
                      *(struct.pack(">I", o) for o in offsets)))
        minf = _box(b"minf", _full_box(b"vmhd", 1, bytes(8)),
                    _box(b"dinf", _full_box(b"dref", 0, struct.pack(
                        ">I", 1), _full_box(b"url ", 1))), stbl)
        mdia = _box(
            b"mdia",
            times(b"mdhd", fps, in_moov, struct.pack(">HH", 0x55C4, 0)),
            _full_box(b"hdlr", 0, struct.pack(">I4s12x", 0, b"vide"),
                      b"VideoHandler\0"), minf)
        track_id = 2 if audio_first else 1
        if version == 1:
            head = struct.pack(">QQIIQ8xHHHH", 0, 0, track_id, 0, in_moov,
                               0, 0, 0, 0)
        else:
            head = struct.pack(">IIIII8xHHHH", 0, 0, track_id, 0, in_moov,
                               0, 0, 0, 0)
        tkhd = _full_box(b"tkhd", (version << 24) | 3, head,
                         pack_matrix(matrix),
                         struct.pack(">II", w << 16, h << 16))
        return _box(b"trak", tkhd, edts, mdia)

    def audio_trak(offsets: list[int]) -> bytes:
        rate = audio["rate"]
        chunks = [audio_samples(a, b) for a, b in spans]
        sound = struct.pack(">HHH4xHHHHI", 1, 0, 0, 1, 16, 0, 0, rate << 16)
        if aac:
            entry_box = _box(b"mp4a", bytes(6), sound,
                             esds_box(audio["config"], 0x40, 0x15))
            counts = [len(c) for c in chunks]
            total = sum(counts)
            table = _full_box(b"stsz", 0, struct.pack(">II", 0, total),
                              *(struct.pack(">I", len(p))
                                for c in chunks for p in c))
            media = total * 1024
            # ffmpeg's edit list for AAC: the priming samples hidden.
            shown = audio["samples"] * fps // rate
            edit = _box(b"edts", _full_box(b"elst", 0, struct.pack(
                ">IIiI", 1, shown, 1024, 0x10000)))
        else:
            entry_box = _box(b"sowt", bytes(6), sound)
            counts = [len(b"".join(c)) // 2 for c in chunks]
            total = sum(counts)
            table = _full_box(b"stsz", 0, struct.pack(">II", 2, total))
            media, edit = total, b""
        stbl = _box(
            b"stbl", _full_box(b"stsd", 0, struct.pack(">I", 1), entry_box),
            _full_box(b"stts", 0, *([struct.pack(
                ">III", 1, total, 1024 if aac else 1)]
                if total else [struct.pack(">I", 0)])),
            stsc(counts), table,
            _full_box(b"stco", 0, struct.pack(">I", len(offsets)),
                      *(struct.pack(">I", o) for o in offsets)))
        minf = _box(b"minf", _full_box(b"smhd", 0, bytes(4)),
                    _box(b"dinf", _full_box(b"dref", 0, struct.pack(
                        ">I", 1), _full_box(b"url ", 1))), stbl)
        mdia = _box(b"mdia", times(b"mdhd", rate, media,
                                   struct.pack(">HH", 0x55C4, 0)),
                    _full_box(b"hdlr", 0, struct.pack(">I4s12x", 0, b"soun"),
                              b"SoundHandler\0"), minf)
        track_id = 1 if audio_first else 2
        tkhd = _full_box(b"tkhd", 3, struct.pack(
            ">IIIII8xHHHH", 0, 0, track_id, 0, media * fps // rate, 0, 0,
            0x100, 0), pack_matrix(None), struct.pack(">II", 0, 0))
        return _box(b"trak", tkhd, edit, mdia)

    data_id = 3 if audio else 2

    def data_trak() -> bytes:
        if data_track["kind"] == "tmcd":
            entry_box = _box(b"tmcd", bytes(6), struct.pack(
                ">HIIIIBB", 1, 0, 0, fps, 1, fps, 0))
            head, handler = _box(b"gmhd"), b"tmcd"
        else:
            entry_box = _box(b"tx3g", bytes(6), struct.pack(">H", 1),
                             bytes(30))
            head, handler = _full_box(b"nmhd", 0), b"text"
        stbl = _box(
            b"stbl", _full_box(b"stsd", 0, struct.pack(">I", 1), entry_box),
            _full_box(b"stts", 0, struct.pack(">I", 0)),
            _full_box(b"stsc", 0, struct.pack(">I", 0)),
            _full_box(b"stsz", 0, struct.pack(">II", 0, 0)),
            _full_box(b"stco", 0, struct.pack(">I", 0)))
        minf = _box(b"minf", head, _box(b"dinf", _full_box(
            b"dref", 0, struct.pack(">I", 1), _full_box(b"url ", 1))), stbl)
        mdia = _box(b"mdia", times(b"mdhd", fps, data_track.get("duration", 0),
                                   struct.pack(">HH", 0x55C4, 0)),
                    _full_box(b"hdlr", 0, struct.pack(">I4s12x", 0, handler),
                              b"DataHandler\0"), minf)
        tkhd = _full_box(b"tkhd", 3, struct.pack(
            ">IIIII8xHHHH", 0, 0, data_id, 0, 0, 0, 0, 0, 0),
            pack_matrix(None), struct.pack(">II", 0, 0))
        return _box(b"trak", tkhd, mdia)

    def data_sample(first: int) -> bytes:
        if data_track["kind"] == "tmcd":
            return struct.pack(">I", first)
        return b"\0\1t"

    def moov(video_offsets: list[int], audio_offsets: list[int]) -> bytes:
        mvhd = times(b"mvhd", fps, in_moov, struct.pack(">IH10x", 0x10000,
                                                       0x100)
                     + pack_matrix(movie_matrix) + bytes(24)
                     + struct.pack(">I", 3 if audio else 2))
        traks = [video_trak(video_offsets)]
        if audio:
            traks.insert(0 if audio_first else 1, audio_trak(audio_offsets))
        if data_track:
            traks.append(data_trak())
        mvex = b""
        if fragmented:
            ids = ([1, 2] if audio else [1]) + (
                [data_id] if data_track else [])
            mvex = _box(b"mvex", *([_full_box(b"mehd", 0, struct.pack(
                ">I", n))] if mehd else []), *(_full_box(
                    b"trex", 0, struct.pack(">IIIII", i, 1, 0, 0, 0))
                    for i in ids))
        return _box(b"moov", mvhd, *traks, mvex)

    def payload(video_at: int) -> tuple[bytes, list[int], list[int]]:
        """moov's chunks from file offset `video_at`: the bytes and each
        chunk's offset, video and audio."""
        out, vo, ao = b"", [], []
        for a, b in spans:
            parts = [(b"v", b"".join(packets[a:b]))]
            if audio:
                parts.insert(0 if audio_first else 1,
                             (b"a", b"".join(audio_samples(a, b))))
            for kind, data in parts:
                (vo if kind == b"v" else ao).append(video_at + len(out))
                out += data
        return out, vo, ao

    ftyp = _box(b"ftyp", b"isom", struct.pack(">I", 0x200), b"isomiso2mp41")
    if not fragmented and not chunk and not audio:
        head = ftyp + moov([0], [])
        return ftyp + moov([len(head) + 8], []) + _box(b"mdat", *packets)
    data, vo, ao = payload(0)
    head = ftyp + moov(vo, ao)
    data, vo, ao = payload(len(head) + 8)
    out = ftyp + moov(vo, ao) + _box(b"mdat", data)
    if not fragmented:
        return out
    # The fragments: the video's, then the audio's samples in each mdat.
    first = in_moov
    for seq, count in enumerate(fragments):
        idx = range(first, first + count)
        vdata = b"".join(packets[i] for i in idx)
        asamples = audio_samples(first, first + count) if audio else []
        adata = b"".join(asamples)
        offs = ctts or [0] * n
        negative = any(offs[i] < 0 for i in idx)
        keys = [sync is None or i in sync for i in idx]
        first_only = keys[0] and not any(keys[1:])
        flags = 0x001 | 0x200 | (0x800 if ctts is not None else 0) | (
            0x004 if first_only else 0x400)

        def traf(moof_len: int, mdat_at: int) -> bytes:
            vbase = mdat_at + 8 if base_offset else 0
            vdo = 0 if base_offset else moof_len + 8
            tf = 0x08 | 0x20 | (0x01 if base_offset else 0x020000) | (
                0x02 if descriptions else 0)
            base = [struct.pack(">Q", vbase)] if base_offset else []
            desc = [struct.pack(">I", descriptions[seq])] \
                if descriptions else []
            step = run_samples or count
            truns = []
            for r in range(0, count, step):
                ridx = list(zip(idx, keys))[r:r + step]
                rf = flags & ~(0x001 if r else 0)
                if r and first_only:
                    rf = (rf & ~0x004) | 0x400
                one = rf & 0x004
                truns.append(_full_box(
                    b"trun", (int(negative) << 24) | rf,
                    struct.pack(">I", len(ridx)),
                    *([] if r else [struct.pack(">i", vdo)]),
                    *([struct.pack(">I", SYNC_FLAGS)] if one else []),
                    *(struct.pack(">I", len(packets[i]))
                      + (b"" if one else struct.pack(
                          ">I", SYNC_FLAGS if k else NON_SYNC_FLAGS))
                      + (struct.pack(">i", offs[i])
                         if ctts is not None else b"")
                      for i, k in ridx)))
            v = _box(b"traf", _full_box(
                b"tfhd", tf, struct.pack(">I", 2 if audio_first else 1),
                *base, *desc, struct.pack(">II", 1, NON_SYNC_FLAGS)),
                _full_box(b"tfdt", 1 << 24, struct.pack(">Q", first)),
                *truns)
            if data_track:
                sample = data_sample(first)
                d = _box(b"traf", _full_box(
                    b"tfhd", 0x020000, struct.pack(">I", data_id)),
                    _full_box(b"tfdt", 1 << 24, struct.pack(
                        ">Q", first + data_track.get("shift", 0))),
                    _full_box(b"trun", 0x001 | 0x100 | 0x200 | 0x400,
                              struct.pack(">Ii", 1, vdo + len(vdata)
                                          + len(adata)),
                              struct.pack(">III", count, len(sample),
                                          SYNC_FLAGS)))
                v += d
            if not audio:
                return v
            before = audio_samples(0, first)
            if aac:
                # Each packet its own size, 1024 samples long.
                t0 = 1024 * len(before)
                head = struct.pack(">II", 1024, SYNC_FLAGS)
                tf_a, run = 0x08 | 0x20, (0x201, b"".join(
                    struct.pack(">I", len(p)) for p in asamples))
            else:
                t0 = len(b"".join(before)) // 2
                per = len(audio["frames"][0])
                head = struct.pack(">III", per // 2, per, SYNC_FLAGS)
                tf_a, run = 0x08 | 0x10 | 0x20, (0x001, b"")
            a = _box(b"traf", _full_box(
                b"tfhd", tf_a | (0x01 if base_offset else 0x020000),
                struct.pack(">I", 1 if audio_first else 2), *base, head),
                _full_box(b"tfdt", 1 << 24, struct.pack(">Q", t0)),
                _full_box(b"trun", run[0], struct.pack(
                    ">Ii", len(asamples), vdo + len(vdata)), run[1]))
            return a + v if audio_first else v + a

        at = len(out)
        mfhd = _full_box(b"mfhd", 0, struct.pack(">I", seq + 1))
        probe = _box(b"moof", mfhd, traf(0, 0))
        moof = _box(b"moof", mfhd, traf(len(probe), at + len(probe)))
        out += moof + _box(b"mdat", vdata, adata,
                           data_sample(first) if data_track else b"")
        first += count
    return out


def audio_track(frames: int, fps: int, rate: int = 16000,
                first: bool = True, seed: int = 0) -> dict:
    """A mono 16-bit PCM sound track (little-endian: MP4 `sowt`, Matroska
    A_PCM/INT/LIT, AVI WAVE_FORMAT_PCM) of `frames` video frames at
    `fps`: a tone with a little noise, split into each frame's samples
    ("frames"); `first`, whether the muxers put it before the video."""
    rng = np.random.default_rng(seed)
    per = rate // fps
    t = np.arange(frames * per) / rate
    x = 0.3 * np.sin(2 * np.pi * 440 * t) + 0.01 * rng.standard_normal(t.size)
    pcm = np.round(x * 32767).astype("<i2").tobytes()
    return {"frames": [pcm[2 * per * i:2 * per * (i + 1)]
                       for i in range(frames)],
            "rate": rate, "first": first}


def aac_track(frames: int, fps: int, rate: int = 16000,
              first: bool = True) -> dict:
    """audio_track's tone as AAC-LC, mono, from the system's libavcodec 59
    through ctypes (its native `aac` encoder, 32 kb/s, one thread): the
    packets in decode order ("aac", 1024 samples each, the first the
    encoder's priming), its AudioSpecificConfig ("config") and the
    samples of the tone ("samples"), for mp4_file."""
    import ctypes

    av = ctypes.CDLL("libavcodec.so.59")
    au = ctypes.CDLL("libavutil.so.57")
    # The structure offsets below are libavutil 57's and libavcodec 59's.
    assert av.avcodec_version() >> 16 == 59 and au.avutil_version() >> 16 == 57
    vp = ctypes.c_void_p
    for lib, name, res, args in (
            (av, "avcodec_find_encoder_by_name", vp, [ctypes.c_char_p]),
            (av, "avcodec_alloc_context3", vp, [vp]),
            (av, "avcodec_open2", ctypes.c_int, [vp, vp, vp]),
            (av, "avcodec_send_frame", ctypes.c_int, [vp, vp]),
            (av, "avcodec_receive_packet", ctypes.c_int, [vp, vp]),
            (av, "avcodec_free_context", None, [vp]),
            (av, "av_packet_alloc", vp, []),
            (av, "av_packet_unref", None, [vp]),
            (av, "av_packet_free", None, [vp]),
            (au, "av_opt_set", ctypes.c_int,
             [vp, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int]),
            (au, "av_frame_alloc", vp, []),
            (au, "av_frame_get_buffer", ctypes.c_int, [vp, ctypes.c_int]),
            (au, "av_frame_make_writable", ctypes.c_int, [vp]),
            (au, "av_frame_free", None, [vp])):
        getattr(lib, name).restype = res
        getattr(lib, name).argtypes = args
    codec = av.avcodec_find_encoder_by_name(b"aac")
    if not codec:
        raise RuntimeError("libavcodec: no aac encoder")
    ctx = av.avcodec_alloc_context3(codec)
    for k, v in {"ar": str(rate), "ac": "1", "ch_layout": "mono",
                 "time_base": f"1/{rate}", "threads": "1",
                 "b": "32000"}.items():
        if au.av_opt_set(ctx, k.encode(), v.encode(), 1):
            raise RuntimeError(f"libavcodec: option {k}={v} refused")
    ctypes.c_int.from_address(ctx + 360).value = 8   # sample_fmt FLTP
    if av.avcodec_open2(ctx, codec, None) < 0:
        raise RuntimeError("libavcodec: aac does not open")
    frame = au.av_frame_alloc()
    # nb_samples, format; sample_rate, channel_layout, channels; ch_layout
    struct.pack_into("<ii", (ctypes.c_char * 8).from_address(frame + 112),
                     0, 1024, 8)
    ctypes.c_int.from_address(frame + 208).value = rate
    ctypes.c_uint64.from_address(frame + 216).value = 4   # front centre
    ctypes.c_int.from_address(frame + 380).value = 1
    struct.pack_into("<iiQ", (ctypes.c_char * 16).from_address(frame + 448),
                     0, 1, 1, 4)
    if au.av_frame_get_buffer(frame, 0) < 0:
        raise RuntimeError("libavutil: no frame buffer")
    pcm = np.frombuffer(b"".join(audio_track(frames, fps, rate)["frames"]),
                        "<i2").astype(np.float32) / 32767
    pcm = np.concatenate([pcm, np.zeros(-len(pcm) % 1024, np.float32)])
    pkt = av.av_packet_alloc()
    out = []

    def drain():
        while av.avcodec_receive_packet(ctx, pkt) == 0:
            out.append(ctypes.string_at(
                ctypes.c_void_p.from_address(pkt + 24).value,
                ctypes.c_int.from_address(pkt + 32).value))
            av.av_packet_unref(pkt)

    for i in range(len(pcm) // 1024):
        if au.av_frame_make_writable(frame) < 0:
            raise RuntimeError("libavutil: frame not writable")
        block = np.ascontiguousarray(pcm[1024 * i:1024 * (i + 1)])
        ctypes.memmove(ctypes.c_void_p.from_address(frame).value,
                       block.ctypes.data, 4096)
        ctypes.c_int64.from_address(frame + 136).value = 1024 * i   # pts
        if av.avcodec_send_frame(ctx, frame) < 0:
            raise RuntimeError(f"libavcodec: aac refused frame {i}")
        drain()
    av.avcodec_send_frame(ctx, None)
    drain()
    for p in (pkt, frame, ctx):
        box = ctypes.c_void_p(p)
        (av.av_packet_free if p == pkt else au.av_frame_free if p == frame
         else av.avcodec_free_context)(ctypes.byref(box))
    index = {96000: 0, 88200: 1, 64000: 2, 48000: 3, 44100: 4, 32000: 5,
             24000: 6, 22050: 7, 16000: 8, 12000: 9, 11025: 10, 8000: 11}
    config = struct.pack(">H", (2 << 11) | (index[rate] << 7) | (1 << 3))
    return {"aac": out, "config": config, "rate": rate, "first": first,
            "samples": frames * (rate // fps)}


def _ebml(eid: int, *parts: bytes) -> bytes:
    body = b"".join(parts)
    n = len(body)
    k = 1
    while n >= (1 << (7 * k)) - 1:
        k += 1
    size = ((1 << (7 * k)) | n).to_bytes(k, "big")
    return eid.to_bytes((eid.bit_length() + 7) // 8, "big") + size + body


def _ebml_uint(eid: int, v: int) -> bytes:
    return _ebml(eid, v.to_bytes(max(1, (v.bit_length() + 7) // 8), "big"))


def _lace(frames: list[bytes], kind: int) -> tuple[int, bytes]:
    """A block's lacing flags and its laced payload: `kind` 1 Xiph, 2
    fixed (equal sizes), 3 EBML (the first size, then signed
    differences)."""
    head = bytes([len(frames) - 1])
    if kind == 1:
        for f in frames[:-1]:
            head += b"\xff" * (len(f) // 255) + bytes([len(f) % 255])
    elif kind == 3:
        def vint(v: int, k: int) -> bytes:
            return ((1 << (7 * k)) | v).to_bytes(k, "big")

        head += vint(len(frames[0]), 3 if len(frames[0]) > 16382 else 2)
        for a, b in zip(frames, frames[1:-1]):
            d = len(b) - len(a)
            k = 1 if abs(d) < 63 else 2 if abs(d) < 8191 else 3
            head += vint(d + (1 << (7 * k - 1)) - 1, k)
    return kind << 1, head + b"".join(frames)


def mkv_file(packets: list[bytes], w: int, h: int, fps: int, codec_id: str,
             codec_private: bytes = b"", pts: list[int] | None = None,
             keys: list[int] | None = None, default_duration: bool = True,
             times: list[int] | None = None, duration: float | None = None,
             projection: dict | None = None, audio: dict | None = None,
             cluster: int | None = None,
             colour_space: bytes | None = None,
             encodings: list[dict] | None = None,
             lace: tuple[int, int] | None = None) -> bytes:
    """A Matroska file of one video track: `packets` as SimpleBlocks of
    one cluster in decode order, at the presentation times `pts` (in
    frames; None: decode order), keyframes at `keys` (None: every
    packet); the track's CodecID, CodecPrivate and DefaultDuration, a
    segment Duration of len(packets) frames, no SegmentUID (so a rerun
    writes the same bytes).

    `default_duration` False leaves DefaultDuration out; `times`, the
    blocks' timestamps in ms instead of pts · 1000 // fps, and
    `duration` the segment's Duration in ms; `cluster`, the blocks of
    each cluster (each with its own Timestamp) instead of one;
    `projection`, the Video element's Projection: "type"
    (ProjectionType), "yaw", "pitch", "roll" (ProjectionPose*, degrees);
    `audio`, a sound track (audio_track) as A_PCM/INT/LIT, track 1 with
    the video as track 2 (when its "first" is true, else after it): the
    audio of three frames a block before their first video block, laced
    in turn by Xiph, fixed and EBML lacing or unlaced in a BlockGroup;
    `colour_space`, the Video element's ColourSpace (a V_UNCOMPRESSED
    track's fourcc).

    `encodings`, the track's ContentEncodings (see content_encodings),
    applied to the packets and CodecPrivate of their scope; `lace`,
    (frames, kind): that many packets a SimpleBlock, laced by `kind` (1
    Xiph, 2 fixed, 3 EBML), each block at its first packet's timestamp
    and key flag."""
    n = len(packets)
    encoding = b""
    if encodings:
        packets, codec_private, encoding = content_encodings(
            encodings, packets, codec_private)
    pts = list(range(n)) if pts is None else pts
    keys = set(range(n)) if keys is None else set(keys)
    ms = 1000 // fps
    times = [p * ms for p in pts] if times is None else times
    header = _ebml(0x1A45DFA3, _ebml_uint(0x4286, 1), _ebml_uint(0x42F7, 1),
                   _ebml_uint(0x42F2, 4), _ebml_uint(0x42F3, 8),
                   _ebml(0x4282, b"matroska"), _ebml_uint(0x4287, 4),
                   _ebml_uint(0x4285, 2))
    info = _ebml(0x1549A966, _ebml_uint(0x2AD7B1, 1000000),
                 _ebml(0x4489, struct.pack(
                     ">d", float(n * ms) if duration is None else duration)),
                 _ebml(0x4D80, b"tests"), _ebml(0x5741, b"tests"))
    proj = b""
    if projection is not None:
        proj = _ebml(0x7670, _ebml_uint(0x7671, projection.get("type", 0)),
                     *(_ebml(eid, struct.pack(">f", projection[k]))
                       for eid, k in ((0x7673, "yaw"), (0x7674, "pitch"),
                                      (0x7675, "roll")) if k in projection))
    video = _ebml(0xE0, _ebml_uint(0xB0, w), _ebml_uint(0xBA, h), proj,
                  *([_ebml(0x2EB524, colour_space)] if colour_space else []))
    vnum = 2 if audio and audio["first"] else 1
    entry = _ebml(0xAE, _ebml_uint(0xD7, vnum), _ebml_uint(0x73C5, vnum),
                  _ebml_uint(0x83, 1), _ebml(0x86, codec_id.encode()),
                  *([_ebml(0x63A2, codec_private)] if codec_private else []),
                  *([_ebml_uint(0x23E383, 1000000000 // fps)]
                    if default_duration else []), video, encoding)
    entries = [entry]
    if audio:
        anum = 3 - vnum
        aentry = _ebml(0xAE, _ebml_uint(0xD7, anum), _ebml_uint(0x73C5, anum),
                       _ebml_uint(0x83, 2), _ebml(0x86, b"A_PCM/INT/LIT"),
                       _ebml(0xE1, _ebml(0xB5, struct.pack(
                           ">d", float(audio["rate"]))),
                           _ebml_uint(0x9F, 1), _ebml_uint(0x6264, 16)))
        entries.insert(0 if audio["first"] else 1, aentry)

    def blocks(lo: int, hi: int, base: int) -> bytes:
        out = b""
        for i in range(lo, hi):
            if audio and i % 3 == 0:
                group = audio["frames"][i:i + 3]
                kind = (i // 3) % 4
                stamp = struct.pack(">h", i * ms - base)
                if kind == 3:
                    out += _ebml(0xA0, _ebml(0xA1, bytes([0x80 | (3 - vnum)]),
                                             stamp, b"\0", b"".join(group)))
                else:
                    flags, body = _lace(group, kind + 1)
                    out += _ebml(0xA3, bytes([0x80 | (3 - vnum)]), stamp,
                                 bytes([0x80 | flags]), body)
            if lace is None:
                out += _ebml(0xA3, bytes([0x80 | vnum]), struct.pack(
                    ">hB", times[i] - base, 0x80 if i in keys else 0),
                    packets[i])
            elif (i - lo) % lace[0] == 0:
                group = packets[i:min(i + lace[0], hi)]
                flags, body = _lace(group, lace[1]) if len(group) > 1 \
                    else (0, group[0])
                out += _ebml(0xA3, bytes([0x80 | vnum]), struct.pack(
                    ">hB", times[i] - base,
                    (0x80 if i in keys else 0) | flags), body)
        return out

    step = cluster or max(n, 1)
    clusters = b""
    for lo in range(0, n, step):
        base = 0 if cluster is None else times[lo]
        clusters += _ebml(0x1F43B675, _ebml_uint(0xE7, base),
                          blocks(lo, min(lo + step, n), base))
    return header + _ebml(0x18538067, info, _ebml(0x1654AE6B, *entries),
                          clusters)


def content_encodings(specs: list[dict], packets: list[bytes],
                      private: bytes) -> tuple[list[bytes], bytes, bytes]:
    """A Matroska track's ContentEncodings element of `specs`, each a
    ContentEncoding's "algo" (ContentCompAlgo: 0 zlib, 1 bzlib, 2 LZO, 3
    header stripping; default 3), "settings" (ContentCompSettings: the
    stripped bytes), "scope" (ContentEncodingScope: 1 the frames, 2 the
    CodecPrivate; default 1), "order" (ContentEncodingOrder; default
    their place) and "type" (ContentEncodingType: 1 encryption, which
    leaves the bytes as they are); → the packets and the CodecPrivate
    encoded as a muxer writes them (lowest order first: a demuxer undoes
    the highest first), and the element. Header stripping asserts that
    each packet begins with its bytes; zlib and bzlib compress at their
    defaults."""
    import bz2
    import zlib

    def encode(data: bytes, spec: dict) -> bytes:
        if spec.get("type", 0):
            return data
        algo = spec.get("algo", 3)
        if algo == 3:
            head = spec.get("settings", b"")
            assert data.startswith(head)
            return data[len(head):]
        return {0: zlib.compress, 1: bz2.compress,
                2: lzo1x_compress}[algo](data)

    elements = []
    order = sorted(range(len(specs)),
                   key=lambda k: specs[k].get("order", k))
    for k in order:
        spec = specs[k]
        scope = spec.get("scope", 1)
        if scope & 1:
            packets = [encode(p, spec) for p in packets]
        if scope & 2 and private:
            private = encode(private, spec)
    for k, spec in enumerate(specs):
        if spec.get("type", 0):
            body = _ebml(0x5035, _ebml_uint(0x47E1, 5),
                         _ebml(0x47E2, b"key0"))
        else:
            body = _ebml(0x5034, _ebml_uint(0x4254, spec.get("algo", 3)),
                         *([_ebml(0x4255, spec["settings"])]
                           if "settings" in spec else []))
        elements.append(_ebml(
            0x6240, _ebml_uint(0x5031, spec.get("order", k)),
            _ebml_uint(0x5032, spec.get("scope", 1)),
            _ebml_uint(0x5033, spec.get("type", 0)), body))
    return packets, private, _ebml(0x6D80, *elements)


def libvpx_encode(frames, codec: str = "vp8", fps: int = 25,
                  profile: int = 0, error_resilient: bool = False,
                  token_partitions: int = 0, sharpness: int = 0,
                  roi: bool = False, two_pass: bool = False,
                  tile_cols: int | None = None, tile_rows: int = 0,
                  aq_mode: int | None = None, lossless: bool = False,
                  frame_parallel: bool | None = None,
                  color_range: int | None = None,
                  color_space: int | None = None,
                  realtime_speed: int | None = None, bit_depth: int = 8,
                  layout: str = "420", keyframes=(),
                  svc: dict | None = None) -> list[bytes]:
    """VP8 or VP9 packets of `frames` (BGR) from libvpx's encoder API,
    loaded from the libvpx that cv2's wheel bundles (1.15's structure
    layouts): one thread, good quality, the given profile,
    error-resilient mode, sharpness; VP8's log2 token partitions; with
    `roi`, a 4-segment map (each macroblock's, or VP9's 8x8 block's,
    segment its index mod 4) with quantiser deltas 0, -10, 10, 20 and
    level deltas 0, 5, -5, 10 (VP9: segment 3 skipped and segment 2 held
    to the last frame; libvpx applies a VP9 map in realtime mode only);
    with `two_pass`, a first pass for its
    statistics, then alt-ref frames from 16 frames of lag. VP9's controls:
    log2 tile columns (None: libvpx's default, as many as the width
    allows) and rows, the AQ mode, lossless, frame-parallel decoding
    (None: libvpx's default, on), colour range (1 full) and colour space
    (2 BT.709), and a realtime speed (one pass, no lag, the realtime
    deadline).

    VP9's other formats: `bit_depth` 10 or 12 (g_bit_depth and
    g_input_bit_depth, the high-bit-depth init flag and 16-bit images of
    `planes_of`'s samples shifted up) and `layout` "420", "422", "444",
    "440" (`vpx_planes`) or "gbr" (the frame's G, B and R planes as
    4:4:4, for colour space 7, sRGB). `frames` may change size: a frame
    of another size than the one before it reconfigures the encoder
    (vpx_codec_enc_config_set, g_w and g_h), which codes a smaller size
    from the references it has (reference scaling) and a size past the
    first with a keyframe; `keyframes`, the frames forced to be
    keyframes (VPX_EFLAG_FORCE_KF). `svc`: VP9's spatial layers
    ("layers", each a 1/2 step down; "intra_only", the base layer's
    frames at `keyframes` coded intra-only by VP9E_SET_SVC_SPATIAL_LAYER_
    SYNC), realtime mode; each packet a superframe of the layers'
    frames."""
    import ctypes
    import glob

    import cv2

    libs = os.path.join(os.path.dirname(os.path.dirname(cv2.__file__)),
                        "opencv_python.libs")
    lib = ctypes.CDLL(glob.glob(os.path.join(libs, "libvpx*.so*"))[0])
    vp = ctypes.c_void_p
    for name, res, args in (
            (f"vpx_codec_{codec}_cx", vp, []),
            ("vpx_codec_enc_config_default", ctypes.c_int,
             [vp, vp, ctypes.c_uint]),
            ("vpx_codec_enc_init_ver", ctypes.c_int,
             [vp, vp, vp, ctypes.c_long, ctypes.c_int]),
            ("vpx_codec_control_", ctypes.c_int, [vp, ctypes.c_int]),
            ("vpx_img_wrap", vp, [vp, ctypes.c_int, ctypes.c_uint,
                                  ctypes.c_uint, ctypes.c_uint, vp]),
            ("vpx_codec_encode", ctypes.c_int,
             [vp, vp, ctypes.c_int64, ctypes.c_ulong, ctypes.c_long,
              ctypes.c_ulong]),
            ("vpx_codec_get_cx_data", vp, [vp, vp]),
            ("vpx_codec_destroy", ctypes.c_int, [vp])):
        getattr(lib, name).restype = res
        getattr(lib, name).argtypes = args

    class RoiMap(ctypes.Structure):
        _fields_ = [("enabled", ctypes.c_uint8), ("roi_map", ctypes.c_void_p),
                    ("rows", ctypes.c_uint), ("cols", ctypes.c_uint),
                    ("delta_q", ctypes.c_int * 8),
                    ("delta_lf", ctypes.c_int * 8),
                    ("skip", ctypes.c_int * 8), ("ref_frame", ctypes.c_int * 8),
                    ("static_threshold", ctypes.c_uint * 4)]

    h, w = frames[0].shape[:2]
    vp9 = codec == "vp9"
    deadline = 1 if realtime_speed is not None or svc else 1000000
    high = bit_depth > 8
    fmt = {"420": 0x102, "422": 0x105, "444": 0x106, "440": 0x107,
           "gbr": 0x106}[layout] | (0x800 if high else 0)
    lib.vpx_codec_enc_config_set.restype = ctypes.c_int
    lib.vpx_codec_enc_config_set.argtypes = [vp, vp]

    def run(pass_no: int, stats: bytes = b"") -> list[bytes]:
        iface = getattr(lib, f"vpx_codec_{codec}_cx")()
        cfg = (ctypes.c_uint32 * 1024)()           # vpx_codec_enc_cfg_t
        if lib.vpx_codec_enc_config_default(iface, cfg, 0):
            raise RuntimeError("libvpx: no default configuration")
        cfg[1], cfg[2], cfg[3], cfg[4] = 1, profile, w, h
        cfg[7], cfg[8], cfg[9] = 1, fps, int(error_resilient)
        cfg[10] = pass_no
        if two_pass:
            cfg[11] = 16                           # g_lag_in_frames
        if realtime_speed is not None or svc:
            cfg[11] = 0
        if high:
            cfg[5] = cfg[6] = bit_depth            # g_(input_)bit_depth
        if svc:
            # CBR at 400 kb/s over `layers` spatial layers, one temporal
            # layer: rc_end_usage, rc_target_bitrate, ss_number_layers,
            # ts_number_layers, layer_target_bitrate (1.15's layout)
            n = svc["layers"]
            cfg[18], cfg[28], cfg[43], cfg[54] = 1, 400, n, 1
            for k in range(n):
                cfg[82 + k] = 400 * (k + 1) // n
        keep = ctypes.create_string_buffer(stats, len(stats) or 1)
        if pass_no == 2:                           # rc_twopass_stats_in
            ctypes.c_void_p.from_buffer(cfg, 80).value = \
                ctypes.addressof(keep)
            ctypes.c_size_t.from_buffer(cfg, 88).value = len(stats)
        ctx = (ctypes.c_uint8 * 256)()
        # The ABI version the library was built with: the one it accepts.
        flags = ctypes.c_long(0x40000 if high else 0)   # USE_HIGHBITDEPTH
        if not any(lib.vpx_codec_enc_init_ver(ctx, iface, cfg, flags,
                                              v) == 0
                   for v in range(1, 100)):
            raise RuntimeError("libvpx: the encoder does not initialise")
        controls = [(16, sharpness)]
        if not vp9:
            controls.append((18, token_partitions))
        if two_pass:
            controls.append((14, 1))               # ENABLEAUTOALTREF
        if vp9:
            for cid, val in ((33, tile_cols), (34, tile_rows or None),
                             (36, aq_mode), (32, int(lossless) or None),
                             (35, None if frame_parallel is None
                              else int(frame_parallel)),
                             (51, color_range), (46, color_space),
                             (13, realtime_speed)):
                if val is not None:
                    controls.append((cid, val))
        if svc:
            controls.append((39, 1))               # VP9E_SET_SVC
        for cid, val in controls:
            if lib.vpx_codec_control_(ctx, cid, ctypes.c_int(val)):
                raise RuntimeError(f"libvpx: control {cid} refused")
        if svc:
            # vpx_svc_extra_cfg_t: quantiser ranges, scaling factors (1/2
            # a layer down), speeds, temporal layering mode, loop filter
            n = svc["layers"]
            extra = (ctypes.c_int * (12 * 6 + 1))()
            for k in range(n):
                extra[k], extra[12 + k] = 56, 2
                extra[24 + k], extra[36 + k] = 1, 1 << (n - 1 - k)
                extra[48 + k] = 7
            if lib.vpx_codec_control_(ctx, 41, ctypes.byref(extra)):
                raise RuntimeError("libvpx: SVC parameters refused")
        if roi:
            blk = 8 if vp9 else 16
            rows, cols = (h + blk - 1) // blk, (w + blk - 1) // blk
            seg = (ctypes.c_uint8 * (rows * cols))(
                *[i % 4 for i in range(rows * cols)])
            m = RoiMap(1, ctypes.addressof(seg), rows, cols,
                       (ctypes.c_int * 8)(0, -10, 10, 20),
                       (ctypes.c_int * 8)(0, 5, -5, 10))
            if vp9:
                m.skip[3] = 1
                m.ref_frame[:] = [-1, -1, 1, -1, -1, -1, -1, -1]
            if lib.vpx_codec_control_(ctx, 40 if vp9 else 8,
                                      ctypes.byref(m)):
                raise RuntimeError("libvpx: ROI map refused")
        img = (ctypes.c_uint8 * 512)()             # vpx_image_t
        size = (h, w)
        out = []

        def drain():
            it = ctypes.c_void_p(0)
            while p := lib.vpx_codec_get_cx_data(ctx, ctypes.byref(it)):
                kind = ctypes.c_int.from_address(p).value
                data = ctypes.string_at(
                    ctypes.c_void_p.from_address(p + 8).value,
                    ctypes.c_size_t.from_address(p + 16).value)
                if kind == (1 if pass_no == 1 else 0):
                    out.append(data)

        for i, f in enumerate(frames):
            if f.shape[:2] != size:
                size = f.shape[:2]
                cfg[3], cfg[4] = size[1], size[0]
                if lib.vpx_codec_enc_config_set(ctx, cfg):
                    raise RuntimeError("libvpx: the new size is refused")
            data = b"".join(p.tobytes() for p in vpx_planes(
                f, layout, bit_depth))
            buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
            lib.vpx_img_wrap(img, fmt, size[1], size[0], 1, buf)
            force = 1 if i in keyframes else 0     # VPX_EFLAG_FORCE_KF
            if svc and i in keyframes and svc.get("intra_only"):
                # vpx_svc_spatial_layer_sync_t: the top layers resync,
                # the base layer intra-only
                sync = (ctypes.c_int * 6)(*([0] + [1] * 4), 1)
                if lib.vpx_codec_control_(ctx, 64, ctypes.byref(sync)):
                    raise RuntimeError("libvpx: layer sync refused")
                force = 0
            if lib.vpx_codec_encode(ctx, img, i, 1, force, deadline):
                raise RuntimeError("libvpx: a frame failed to encode")
            drain()
        while True:
            n = len(out)
            lib.vpx_codec_encode(ctx, None, -1, 1, 0, deadline)
            drain()
            if len(out) == n:
                break
        lib.vpx_codec_destroy(ctx)
        return out

    if two_pass:
        return run(2, b"".join(run(1)))
    return run(0)


def set_bits(data: bytes, pos: int, n: int, value: int) -> bytes:
    """`data` with the n bits from bit `pos` (most significant first)
    set to `value`."""
    bits = "".join(f"{b:08b}" for b in data)
    bits = bits[:pos] + format(value, f"0{n}b") + bits[pos + n:]
    return bytes(int(bits[k:k + 8], 2) for k in range(0, len(bits), 8))


def vp9_header(*fields) -> bytes:
    """A VP9 uncompressed header written from (value, bits) pairs, padded
    with zero bytes."""
    bits = "".join(format(v, f"0{n}b") for v, n in fields)
    bits += "0" * (-len(bits) % 8) + "0" * 64
    return bytes(int(bits[k:k + 8], 2) for k in range(0, len(bits), 8))


def vpx_planes(bgr: np.ndarray, layout: str = "420",
               bit_depth: int = 8) -> list[np.ndarray]:
    """A BGR frame's planes for libvpx_encode: YCbCr as `i420` converts it
    (at any size), 4:2:2, 4:4:4 and 4:4:0 from i420 of the frame with its
    rows, rows and columns, or columns doubled (as `planes_of`); or G, B
    and R ("gbr"); above 8 bits the samples shifted up, little-endian
    16-bit."""
    def i420_planes(f):
        h, w = f.shape[:2]
        cw, ch = (w + 1) // 2, (h + 1) // 2
        yuv = np.frombuffer(i420(f), np.uint8)
        return [yuv[:h * w].reshape(h, w),
                yuv[h * w:h * w + cw * ch].reshape(ch, cw),
                yuv[h * w + cw * ch:].reshape(ch, cw)]

    if layout == "gbr":
        planes = [bgr[..., 1], bgr[..., 0], bgr[..., 2]]
    else:
        ry, rx = {"420": (1, 1), "422": (2, 1), "444": (2, 2),
                  "440": (1, 2)}[layout]
        y, u, v = i420_planes(bgr.repeat(ry, axis=0).repeat(rx, axis=1))
        planes = [y[::ry, ::rx], u, v]
    if bit_depth == 8:
        return [np.ascontiguousarray(p) for p in planes]
    return [np.ascontiguousarray(p).astype("<u2") << (bit_depth - 8)
            for p in planes]


def planes_of(bgr: np.ndarray, csp: int = 2) -> list[np.ndarray]:
    """A BGR frame's YCbCr planes as `i420` converts it, for an x264
    colour space (1 I400, 2 I420, 6 I422, 12 I444): I422 and I444 are
    i420 of the frame with its rows (I422) or rows and columns (I444)
    doubled, whose chroma is then the frame's at that sampling; for 14
    (packed BGR, libx264rgb's input) the frame itself, (h, 3 w)."""
    h, w = bgr.shape[:2]
    if csp == 14:
        return [np.ascontiguousarray(bgr).reshape(h, 3 * w)]
    big = {1: (1, 1), 2: (1, 1), 6: (2, 1), 12: (2, 2)}[csp]
    f = bgr.repeat(big[0], axis=0).repeat(big[1], axis=1)
    yuv = np.frombuffer(i420(f), np.uint8)
    fh, fw = f.shape[:2]
    n0 = fh * fw
    y = yuv[:n0].reshape(fh, fw)[::big[0], ::big[1]]
    if csp == 1:
        return [y]
    c = [yuv[n0 + k * n0 // 4:n0 + (k + 1) * n0 // 4].reshape(fh // 2, fw // 2)
         for k in range(2)]
    return [y, *c]


def x264_encode(frames, fps: int = 25, preset: str = "medium",
                profile: str | None = "high", csp: int = 2,
                bitdepth: int = 8, picture_struct: int | None = None,
                **opts) -> list[tuple[bytes, int, int]]:
    """H.264 access units of `frames` (BGR) from libx264's API (the
    system's libx264, API build 164, through ctypes): the preset, then
    one thread and no macroblock tree, each of `opts` through
    x264_param_parse (`_` for `-` in the names, True for "1"), then the
    profile (None: the preset's);
    `csp` and `bitdepth` set x264_param_t's i_csp (1 I400, 2 I420, 6
    I422, 12 I444, 14 packed BGR: libx264rgb's, coded as 4:4:4 GBR) and
    i_bitdepth; the planes are `planes_of`'s (at 10 bits, the 8-bit
    samples shifted up by 2); `picture_struct`, when
    given, is each picture's i_pic_struct (x264's PIC_STRUCT_*: 1
    PROGRESSIVE, 4 TOP_BOTTOM; written with the option pic_struct=1).
    → (Annex B bytes, pts, dts) in decode order, SPS and PPS before
    every keyframe (x264's repeat-headers)."""
    import ctypes

    lib = ctypes.CDLL("libx264.so.164")
    vp = ctypes.c_void_p
    lib.x264_encoder_open_164.restype = vp
    lib.x264_encoder_open_164.argtypes = [vp]
    for name in ("x264_encoder_encode", "x264_encoder_delayed_frames",
                 "x264_encoder_close"):
        getattr(lib, name).argtypes = [vp] + [vp] * (
            4 if name.endswith("encode") else 0)
    h, w = frames[0].shape[:2]
    param = (ctypes.c_uint8 * 8192)()               # x264_param_t
    if lib.x264_param_default_preset(param, preset.encode(), None):
        raise RuntimeError(f"libx264: no preset {preset!r}")
    ints = np.frombuffer(param, np.int32)
    # i_csp, i_bitdepth, i_level_idc: build 164's layout.
    assert tuple(ints[9:12]) == (2, 8, -1), ints[9:12]
    ints[7], ints[8], ints[9], ints[10] = w, h, csp, bitdepth
    # No macroblock tree: with it, libx264's first B-frame encode in a
    # process reads memory it has not written, so its bytes vary.
    settings = {"threads": "1", "fps": str(fps), "repeat-headers": "1",
                "log": "-1", "mbtree": "0"}
    settings.update({k.replace("_", "-"): "1" if v is True else str(v)
                     for k, v in opts.items()})
    for k, v in settings.items():
        if lib.x264_param_parse(param, k.encode(), v.encode()):
            raise RuntimeError(f"libx264: {k}={v} refused")
    if profile and lib.x264_param_apply_profile(param, profile.encode()):
        raise RuntimeError(f"libx264: profile {profile!r} refused")
    enc = lib.x264_encoder_open_164(param)
    if not enc:
        raise RuntimeError("libx264: the encoder does not open")
    pic, pic_out = (ctypes.c_uint8 * 1024)(), (ctypes.c_uint8 * 1024)()
    lib.x264_picture_init(pic)
    shift = {1: None, 2: (1, 1), 6: (1, 0), 12: (0, 0), 14: None}[csp]
    wide = 2 if bitdepth > 8 else 1
    planes = [np.zeros((h >> (shift[1] if i else 0),
                        (w >> (shift[0] if i else 0)) * (3 if csp == 14 else 1)),
                       np.uint8 if wide == 1 else "<u2")
              for i in range(1 if shift is None else 3)]
    struct.pack_into("<i", pic, 40, csp | (0x2000 if wide > 1 else 0))
    struct.pack_into("<i", pic, 44, len(planes))
    for i, pl in enumerate(planes):
        struct.pack_into("<i", pic, 48 + 4 * i, pl.shape[1] * wide)
        struct.pack_into("<Q", pic, 64 + 8 * i, pl.ctypes.data)
    if picture_struct is not None:
        struct.pack_into("<i", pic, 8, picture_struct)
    nal, n_nal = ctypes.c_void_p(), ctypes.c_int()
    out = []

    def collect(size: int):
        if size <= 0:
            return
        base = nal.value
        au = b"".join(ctypes.string_at(
            ctypes.c_void_p.from_address(base + 40 * k + 24).value,
            ctypes.c_int.from_address(base + 40 * k + 20).value)
            for k in range(n_nal.value))
        pts, dts = struct.unpack_from("<qq", pic_out, 16)
        out.append((au, pts, dts))

    for i, f in enumerate(frames):
        for pl, src in zip(planes, planes_of(f, csp)):
            pl[:] = src if wide == 1 else src.astype("<u2") << (bitdepth - 8)
        struct.pack_into("<q", pic, 16, i)
        collect(lib.x264_encoder_encode(enc, ctypes.byref(nal),
                                        ctypes.byref(n_nal), pic, pic_out))
    while lib.x264_encoder_delayed_frames(enc) > 0:
        collect(lib.x264_encoder_encode(enc, ctypes.byref(nal),
                                        ctypes.byref(n_nal), None, pic_out))
    lib.x264_encoder_close(enc)
    return out


def lavc_frame_bytes(f: np.ndarray, fmt: str) -> bytes:
    """One BGR frame (h, w, 3) → libavutil's pixel format `fmt` laid out
    as av_image_fill_arrays lays it at alignment 1: planar YUV (yuv420p,
    yuv422p10le, yuva420p, yuv411p, yuv410p ...: BT.601 limited range,
    chroma averaged over the samples it covers, each 8-bit sample v at
    depth d as (v << (d − 8)) | (v >> (16 − d))), gray/grayNNle/grayNNbe,
    ya8, ya16be, planar G, B, R (gbrp, gbrap, gbrpNNle ...), packed bgr0,
    bgra, rgba, rgb24, rgb48be, rgba64be, and pal8 (G's top 6 bits
    as the index into a fixed palette whose alphas fall from 255, its
    1 KiB after the indices). Alpha planes hold a pattern of their own."""
    import re

    h, w = f.shape[:2]
    y, u, v = (p[0] for p in _yuv_planes(f[None]))
    alpha = ((y.astype(np.int64) * 7 + np.arange(w)[None]) % 256).astype(
        np.uint8)

    def deep(p, d, order="<"):
        if d == 8:
            return np.ascontiguousarray(p, np.uint8).tobytes()
        q = p.astype(np.uint16)
        return ((q << (d - 8)) | (q >> (16 - d))).astype(order + "u2").tobytes()

    def depth_of(tail: str) -> int:
        m = re.search(r"(\d+)(le|be)$", tail)
        return int(m.group(1)) if m else 8

    if fmt.startswith("yuv"):
        body = fmt[4:] if fmt.startswith("yuva") else fmt[3:]
        xs, ys = {"444": (0, 0), "422": (1, 0), "420": (1, 1), "440": (0, 1),
                  "411": (2, 0), "410": (2, 2)}[body[:3]]
        d = depth_of(body[4:])
        cu, cv = (_subsample(c[None], xs, ys)[0] for c in (u, v))
        out = deep(y, d) + deep(cu, d) + deep(cv, d)
        return out + deep(alpha, d) if fmt.startswith("yuva") else out
    if fmt.startswith("gbr"):
        d = depth_of(fmt)
        out = deep(f[..., 1], d) + deep(f[..., 0], d) + deep(f[..., 2], d)
        return out + deep(alpha, d) if fmt.startswith("gbrap") else out
    if fmt.startswith("gray"):
        return deep(y, depth_of(fmt), ">" if fmt.endswith("be") else "<")
    packed = {
        "ya8": lambda: np.stack([y, alpha], -1),
        "ya16be": lambda: (np.stack([y, alpha], -1).astype(np.uint16) *
                           257).astype(">u2"),
        "bgr0": lambda: np.concatenate([f, np.zeros_like(f[..., :1])], -1),
        "bgra": lambda: np.concatenate([f, alpha[..., None]], -1),
        "rgba": lambda: np.concatenate([f[..., ::-1], alpha[..., None]], -1),
        "rgb24": lambda: f[..., ::-1],
        "rgb48be": lambda: (f[..., ::-1].astype(np.uint16) * 257 +
                            np.arange(w)[None, :, None] % 7).astype(">u2"),
        "rgba64be": lambda: (np.concatenate(
            [f[..., ::-1], alpha[..., None]], -1).astype(np.uint16) *
            257).astype(">u2")}
    if fmt in packed:
        return np.ascontiguousarray(packed[fmt]()).tobytes()
    if fmt == "pal8":
        k = np.arange(256)
        pal = np.stack([k, 255 - k, (k * 3) % 256, 255 - k // 4], -1)
        return (f[..., 1] // 4 * 4).astype(np.uint8).tobytes() + \
            pal.astype(np.uint8).tobytes()             # B, G, R, A
    raise ValueError(f"no layout for {fmt}")


def lavc_encode(frames, encoder: str = "mpeg4", fps: int = 25,
                matrices: tuple[list[int], list[int]] | None = None,
                times: list[tuple[int, int]] | None = None,
                info: dict | None = None, **opts) -> list[bytes]:
    """Packets of `frames` (BGR) from the system's libavcodec 59
    (`libavcodec.so.59`, `libavutil.so.57`, through ctypes): the encoder
    `encoder` ("mpeg4", ffmpeg's own, or "libxvid", which wraps
    `libxvidcore.so.4`; "mpeg2video", "mpeg1video"; "libx265", which
    wraps `libx265.so.199`, always with its "x265-params"
    "pools=none:frame-threads=1": one thread, the same bytes on every
    run) opened on one thread with each of `opts` set by av_opt_set (`_`
    kept in the names: "bf", "flags", "mpeg_quant", "gmc", "ps",
    "data_partitioning", "x265-params", ...; "pixel_format" "yuv422p"
    feeds 4:2:2 planes, "yuv420p10le" 10-bit 4:2:0 planes, each 8-bit
    sample v as (v << 2) | (v >> 6)), and `matrices`, the
    intra and inter quantisation matrices (natural order) that the mpeg4
    encoder writes into its VOL with mpeg_quant 1 (and the MPEG-1/2
    encoders into their sequence header); fed I420 (or I422) frames with
    pts 0, 1, ..., then flushed. → the packets in decode order (an
    encoder's headers travel in its first packet); `times`, when given,
    gets each packet's (pts, dts) in frames. Any other "pixel_format" is
    fed as lavc_frame_bytes lays it out (the lossless encoders: "ffv1",
    "utvideo", "huffyuv", "ffvhuff", "png"; "strict" -2 lets ffv1 write
    its version 2); `info`, when given, gets the encoder's "extradata"
    (FFV1's configuration record, HuffYUV's tables, UT Video's 16 bytes),
    "bits" (bits_per_coded_sample, the AVI strf's bit count) and "tag"
    (its codec_tag as a fourcc) from avcodec_parameters_from_context."""
    import ctypes

    av = ctypes.CDLL("libavcodec.so.59")
    au = ctypes.CDLL("libavutil.so.57")
    # The structure offsets below are libavutil 57's and libavcodec 59's.
    assert av.avcodec_version() >> 16 == 59 and au.avutil_version() >> 16 == 57
    vp = ctypes.c_void_p
    for lib, name, res, args in (
            (av, "avcodec_find_encoder_by_name", vp, [ctypes.c_char_p]),
            (av, "avcodec_alloc_context3", vp, [vp]),
            (av, "avcodec_open2", ctypes.c_int, [vp, vp, vp]),
            (av, "avcodec_send_frame", ctypes.c_int, [vp, vp]),
            (av, "avcodec_receive_packet", ctypes.c_int, [vp, vp]),
            (av, "avcodec_free_context", None, [vp]),
            (av, "av_packet_alloc", vp, []),
            (av, "av_packet_unref", None, [vp]),
            (av, "av_packet_free", None, [vp]),
            (av, "avcodec_parameters_alloc", vp, []),
            (av, "avcodec_parameters_from_context", ctypes.c_int, [vp, vp]),
            (av, "avcodec_parameters_free", None, [vp]),
            (au, "av_image_fill_arrays", ctypes.c_int,
             [vp, vp, vp] + [ctypes.c_int] * 4),
            (au, "av_opt_set", ctypes.c_int,
             [vp, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int]),
            (au, "av_frame_alloc", vp, []),
            (au, "av_get_pix_fmt", ctypes.c_int, [ctypes.c_char_p]),
            (au, "av_mallocz", vp, [ctypes.c_size_t]),
            (au, "av_frame_get_buffer", ctypes.c_int, [vp, ctypes.c_int]),
            (au, "av_frame_make_writable", ctypes.c_int, [vp]),
            (au, "av_frame_free", None, [vp])):
        getattr(lib, name).restype = res
        getattr(lib, name).argtypes = args
    h, w = frames[0].shape[:2]
    codec = av.avcodec_find_encoder_by_name(encoder.encode())
    if not codec:
        raise RuntimeError(f"libavcodec: no encoder {encoder!r}")
    ctx = av.avcodec_alloc_context3(codec)
    settings = {"video_size": f"{w}x{h}", "pixel_format": "yuv420p",
                "time_base": f"1/{fps}", "threads": "1"}
    settings.update({k: str(v) for k, v in opts.items()})
    if encoder == "libx265":
        params = settings.get("x265-params", "")
        settings["x265-params"] = "pools=none:frame-threads=1" + (
            ":" + params if params else "")
    for k, v in settings.items():
        if au.av_opt_set(ctx, k.encode(), v.encode(), 1):  # SEARCH_CHILDREN
            raise RuntimeError(f"libavcodec: option {k}={v} refused")
    for at, m in zip((272, 280), matrices or ()):   # intra_, inter_matrix
        buf = au.av_mallocz(128)                 # the context frees them
        ctypes.memmove(buf, np.asarray(m, np.uint16).tobytes(), 128)
        ctypes.c_void_p.from_address(ctx + at).value = buf
    if av.avcodec_open2(ctx, codec, None) < 0:
        raise RuntimeError(f"libavcodec: {encoder} does not open")
    if info is not None:              # AVCodecParameters of libavcodec 59
        par = av.avcodec_parameters_alloc()
        av.avcodec_parameters_from_context(par, ctx)
        size = ctypes.c_int.from_address(par + 24).value
        info["extradata"] = ctypes.string_at(
            ctypes.c_void_p.from_address(par + 16).value, size) if size \
            else b""
        info["bits"] = ctypes.c_int.from_address(par + 40).value
        info["tag"] = struct.pack("<I", ctypes.c_uint.from_address(
            par + 8).value)
        av.avcodec_parameters_free(ctypes.byref(ctypes.c_void_p(par)))
    frame = au.av_frame_alloc()
    struct.pack_into("<ii", (ctypes.c_char * 8).from_address(frame + 104),
                     0, w, h)                        # width, height
    yuv422 = settings["pixel_format"] == "yuv422p"
    deep = settings["pixel_format"] == "yuv420p10le"
    generic = settings["pixel_format"] not in ("yuv420p", "yuv422p",
                                               "yuv420p10le")
    pix = au.av_get_pix_fmt(settings["pixel_format"].encode())
    ctypes.c_int.from_address(frame + 116).value = pix
    if au.av_frame_get_buffer(frame, 0) < 0:
        raise RuntimeError("libavutil: no frame buffer")
    pkt = av.av_packet_alloc()
    out = []

    def drain():
        while av.avcodec_receive_packet(ctx, pkt) == 0:
            out.append(ctypes.string_at(
                ctypes.c_void_p.from_address(pkt + 24).value,
                ctypes.c_int.from_address(pkt + 32).value))
            if times is not None:                # AVPacket pts, dts
                times.append(struct.unpack_from(
                    "<qq", (ctypes.c_char * 16).from_address(pkt + 8)))
            av.av_packet_unref(pkt)

    def feed_generic(f):
        raw = np.frombuffer(lavc_frame_bytes(f, settings["pixel_format"]),
                            np.uint8).copy()
        src, lines = (ctypes.c_void_p * 4)(), (ctypes.c_int * 4)()
        au.av_image_fill_arrays(src, lines, raw.ctypes.data, pix, w, h, 1)
        ends = [a for a in src[1:] if a] + [raw.ctypes.data + raw.size]
        for k in range(4):
            if not src[k]:
                break
            data = ctypes.c_void_p.from_address(frame + 8 * k).value
            stride = ctypes.c_int.from_address(frame + 64 + 4 * k).value
            if lines[k] == 0:                    # pal8's palette
                ctypes.memmove(data, src[k], ends[k] - src[k])
                continue
            for r in range((ends[k] - src[k]) // lines[k]):
                ctypes.memmove(data + r * stride, src[k] + r * lines[k],
                               lines[k])

    for i, f in enumerate(frames):
        if au.av_frame_make_writable(frame) < 0:
            raise RuntimeError("libavutil: frame not writable")
        if generic:
            feed_generic(f)
            ctypes.c_int64.from_address(frame + 136).value = i   # pts
            if av.avcodec_send_frame(ctx, frame) < 0:
                raise RuntimeError(f"libavcodec: {encoder} refused frame {i}")
            drain()
            continue
        # 4:2:2: i420 of the frame with its rows doubled, whose chroma is
        # the frame's at 4:2:2.
        src = f.repeat(2, axis=0) if yuv422 else f
        yuv = np.frombuffer(i420(src), np.uint8)
        sh = src.shape[0]
        ch, cw = (sh + 1) // 2, (w + 1) // 2
        planes = [yuv[:sh * w].reshape(sh, w)[::2 if yuv422 else 1],
                  yuv[sh * w:sh * w + ch * cw].reshape(ch, cw),
                  yuv[sh * w + ch * cw:].reshape(ch, cw)]
        for k, plane in enumerate(planes):
            if deep:
                plane = plane.astype(np.uint16)
                plane = (plane << 2) | (plane >> 6)
            plane = np.ascontiguousarray(plane)
            data = ctypes.c_void_p.from_address(frame + 8 * k).value
            stride = ctypes.c_int.from_address(frame + 64 + 4 * k).value
            for r in range(plane.shape[0]):
                ctypes.memmove(data + r * stride, plane[r].ctypes.data,
                               plane.nbytes // plane.shape[0])
        ctypes.c_int64.from_address(frame + 136).value = i       # pts
        if av.avcodec_send_frame(ctx, frame) < 0:
            raise RuntimeError(f"libavcodec: {encoder} refused frame {i}")
        drain()
    av.avcodec_send_frame(ctx, None)
    drain()
    for p in (pkt, frame, ctx):
        box = ctypes.c_void_p(p)
        (av.av_packet_free if p == pkt else au.av_frame_free if p == frame
         else av.avcodec_free_context)(ctypes.byref(box))
    return out


# MPEG-4's sprite trajectory dmv_length codes (table B-33), by length
_DMV_LENGTH = ["00", "010", "011", "100", "101", "110"] + [
    "1" * k + "0" for k in range(3, 11)] + ["111111111110"]


def gmc_translation(packet: bytes, time_bits: int = 5) -> bytes:
    """An MPEG-4 Part 2 packet whose S-VOPs (GMC, 3 warping points, a
    rectangular progressive VOL whose time increment takes `time_bits`)
    keep the first point of their sprite trajectory and get 0 for the
    other two: a translation, which libavcodec decodes by its one-point
    route (gmc1_motion); the rest of each VOP follows bit for bit, its
    stuffing redone."""
    out, starts = b"", [i for i in range(len(packet) - 3)
                        if packet[i:i + 4] == b"\0\0\1\xb6"]
    ends = starts[1:] + [len(packet)]
    out = packet[:starts[0]] if starts else packet
    for a, e in zip(starts, ends):
        body = packet[a + 4:e]
        bits = "".join(f"{x:08b}" for x in body)
        if bits[:2] != "11":
            out += packet[a:e]
            continue
        k = 2
        while bits[k] == "1":
            k += 1
        k += 1 + 1 + time_bits + 1               # … marker
        if bits[k] == "0":                       # not coded
            out += packet[a:e]
            continue
        k += 1 + 1 + 3                           # coded, rounding, dc_thr
        head, traj = bits[:k], ""
        for point in range(3):
            for _ in range(2):
                n = next(i for i, c in enumerate(_DMV_LENGTH)
                         if bits.startswith(c, k))
                code = bits[k:k + len(_DMV_LENGTH[n]) + n + 1]
                k += len(code)
                traj += code if point == 0 else _DMV_LENGTH[0] + "1"
        rest = bits[k:bits.rindex("0")]         # the stuffing taken off
        bits = head + traj + rest + "0"
        bits += "1" * (-len(bits) % 8)
        out += b"\0\0\1\xb6" + bytes(int(bits[i:i + 8], 2)
                                       for i in range(0, len(bits), 8))
    return out


def mpeg4_headers(packet: bytes) -> bytes:
    """The VOS, VO and VOL headers (and user data) that begin an MPEG-4
    Part 2 packet: its bytes before the first GOV or VOP start code."""
    ends = [i for i in (packet.find(b"\0\0\1\xb3"), packet.find(b"\0\0\1\xb6"))
            if i >= 0]
    return packet[:min(ends)]


def esds_box(config: bytes, oti: int = 0x20, stream: int = 0x11) -> bytes:
    """An esds box (ES_Descriptor, MPEG-4 Visual, objectTypeIndication
    0x20; `oti` 0x40 and `stream` 0x15 for AAC audio) whose
    DecoderSpecificInfo is `config`."""
    def desc(tag: int, body: bytes) -> bytes:
        n = len(body)
        return bytes([tag, 0x80 | (n >> 21) & 0x7F, 0x80 | (n >> 14) & 0x7F,
                      0x80 | (n >> 7) & 0x7F, n & 0x7F]) + body

    dsi = desc(5, config)
    dcd = desc(4, bytes([oti, stream]) + bytes(3) + struct.pack(
        ">II", 0, 0) + dsi)
    return _full_box(b"esds", 0, desc(3, struct.pack(">HB", 1, 0) + dcd
                                       + desc(6, b"\x02")))


def nal_units(annexb: bytes) -> list[bytes]:
    """The NAL units of an Annex B stream, start codes removed."""
    out, p, n = [], 0, len(annexb)
    starts = []
    while True:
        q = annexb.find(b"\0\0\1", p)
        if q < 0:
            break
        starts.append(q + 3)
        p = q + 3
    for i, s in enumerate(starts):
        e = starts[i + 1] - 3 if i + 1 < len(starts) else n
        while i + 1 < len(starts) and e > s and annexb[e - 1] == 0:
            e -= 1
        out.append(annexb[s:e])
    return out


def rbsp_bits(unit: bytes) -> str:
    """A NAL unit's RBSP (emulation prevention removed) as a bit string."""
    out, zeros = bytearray(), 0
    for b in unit[1:]:
        if zeros >= 2 and b == 3:
            zeros = 0
            continue
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return "".join(f"{b:08b}" for b in out)


def nal_unit(header: int, bits: str) -> bytes:
    """A NAL unit of `header` from RBSP bits (zero-padded to a byte),
    emulation prevention put back."""
    bits += "0" * (-len(bits) % 8)
    out, zeros = bytearray([header]), 0
    for k in range(0, len(bits), 8):
        b = int(bits[k:k + 8], 2)
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


def ue_bits(v: int) -> str:
    return "0" * ((v + 1).bit_length() - 1) + format(v + 1, "b")


def se_bits(v: int) -> str:
    return ue_bits(2 * v - 1 if v > 0 else -2 * v)


class BitReader:
    """Exp-Golomb reads over a bit string, noting where fields begin."""

    def __init__(self, bits: str):
        self.s, self.p, self.at = bits, 0, {}

    def mark(self, name):
        self.at[name] = self.p

    def u(self, n):
        v = int(self.s[self.p:self.p + n], 2) if n else 0
        self.p += n
        return v

    def ue(self):
        z = 0
        while self.s[self.p + z] == "0":
            z += 1
        self.p += z
        return self.u(z + 1) - 1

    def se(self):
        k = self.ue()
        return (k + 1) // 2 if k & 1 else -(k // 2)


def sps_fields(bits: str) -> BitReader:
    """Where an SPS's fields begin (x264's SPS: no scaling lists, no
    HRD), with `log2_max_frame_num`, `poc_type`, `log2_max_poc_lsb`,
    `frame_mbs_only`, `chroma_format_idc`, `bit_depth`, `bypass`
    (qpprime_y_zero_transform_bypass_flag) and `matrix`
    (matrix_coefficients, 2 without a colour description)."""
    r = BitReader(bits)
    profile = r.u(8)
    r.u(16)
    r.ue()
    r.chroma_format_idc, r.bit_depth, r.bypass, r.matrix = 1, 8, False, 2
    if profile in (100, 110, 122, 244):
        r.mark("chroma_format_idc")
        r.chroma_format_idc = r.ue()
        if r.chroma_format_idc == 3:
            r.mark("separate_colour_plane")
            r.u(1)
        r.mark("bit_depth_luma")
        r.bit_depth = r.ue() + 8
        r.mark("bit_depth_chroma")
        r.ue()
        r.bypass = bool(r.u(1))
        assert r.u(1) == 0                      # no scaling lists
    r.log2_max_frame_num = r.ue() + 4
    r.mark("poc_type")
    r.poc_type = r.ue()
    r.log2_max_poc_lsb = r.ue() + 4 if r.poc_type == 0 else 0
    r.delta_always_zero, r.poc_offsets = True, (0, 0, [])
    if r.poc_type == 1:
        r.delta_always_zero = bool(r.u(1))
        non_ref, top_bottom = r.se(), r.se()
        r.poc_offsets = (non_ref, top_bottom,
                         [r.se() for _ in range(r.ue())])
    assert r.poc_type in (0, 1, 2)
    r.mark("max_num_ref_frames")
    r.max_num_ref_frames = r.ue()
    r.mark("gaps")
    r.u(1)
    mb_w = r.ue() + 1
    map_units = r.ue() + 1
    r.mark("frame_mbs_only")
    r.frame_mbs_only = r.u(1)
    r.mbs = mb_w * map_units * (2 - r.frame_mbs_only)
    if not r.frame_mbs_only:
        r.u(1)                                  # mb_adaptive_frame_field
    r.mark("direct_8x8_inference")
    r.u(1)
    if r.u(1):                                  # frame cropping
        r.mark("crop_left")
        for _ in range(4):
            r.ue()
    r.mark("vui")
    if not r.u(1):                              # no VUI
        return r
    if r.u(1) and r.u(8) == 255:                # aspect ratio
        r.u(32)
    if r.u(1):
        r.u(1)
    if r.u(1):                                  # video signal type
        r.u(4)
        if r.u(1):
            r.u(16)
            r.matrix = r.u(8)
    if r.u(1):
        r.ue()
        r.ue()
    if r.u(1):                                  # timing
        r.u(65)
    assert r.u(1) == 0 and r.u(1) == 0          # no HRD
    r.u(1)
    r.mark("bitstream_restriction")
    r.u(1)
    return r


def pps_fields(bits: str) -> BitReader:
    """A PPS's fields, where those patch_h264 changes begin
    (`num_slice_groups`, `weighted_bipred_idc`,
    `redundant_pic_cnt_present`) and the values the slice header depends
    on: `pps_id`, `cabac`, `bottom_field_pic_order`, `num_ref_idx` (the
    defaults), `weighted_pred`, `weighted_bipred_idc`,
    `deblocking_control`, `redundant`."""
    r = BitReader(bits)
    r.pps_id, r.sps_id = r.ue(), r.ue()
    r.cabac, r.bottom_field_pic_order = bool(r.u(1)), bool(r.u(1))
    r.mark("num_slice_groups")
    r.slice_groups = r.ue() + 1
    r.num_ref_idx = [r.ue() + 1, r.ue() + 1]
    r.weighted_pred = bool(r.u(1))
    r.mark("weighted_bipred_idc")
    r.weighted_bipred_idc = r.u(2)
    r.se()
    r.se()
    r.se()
    r.deblocking_control = bool(r.u(1))
    r.u(1)
    r.mark("redundant_pic_cnt_present")
    r.redundant = bool(r.u(1))
    return r


def slice_fields(bits: str, sps: BitReader, idr: bool,
                 ref: bool) -> BitReader:
    """Where a Baseline I or P slice header's fields begin (no weights,
    deblocking control present)."""
    r = BitReader(bits)
    r.ue()
    r.mark("slice_type")
    kind = r.ue() % 5
    assert kind in (0, 2)
    r.ue()
    r.mark("frame_num")
    r.u(sps.log2_max_frame_num)
    r.mark("field_pic")
    if not sps.frame_mbs_only and r.u(1):
        r.u(1)
    if idr:
        r.ue()
    if sps.poc_type == 0:
        r.u(sps.log2_max_poc_lsb)
    if kind == 0:
        if r.u(1):
            r.ue()
        if r.u(1):                              # list modification
            while r.ue() != 3:
                r.ue()
    if ref:
        if idr:
            r.u(1)
            r.mark("long_term_reference_flag")
            r.u(1)
        else:
            r.mark("adaptive_ref_pic_marking")
            assert r.u(1) == 0
    r.se()
    r.mark("deblocking_idc")
    return r


def patch_h264(packets: list[bytes], kind: int, field: str, new: str,
               old_bits=1, which=lambda i: True) -> list[bytes]:
    """Annex B packets with one field of the NAL units of type `kind`
    (7 SPS, 8 PPS, 1 or 5 a Baseline slice) replaced: `old_bits` bits
    (or old_bits(reader)) at the field become the bit string `new`, the
    rest of the unit follows it; `which(i)` picks the i-th such unit."""
    sps = None
    out, n = [], 0
    for p in packets:
        units = []
        for u in nal_units(p):
            t = u[0] & 31
            bits = rbsp_bits(u)
            if t == 7:
                sps = sps_fields(bits)
            if t == kind and which(n):
                r = (sps_fields(bits) if t == 7 else pps_fields(bits)
                     if t == 8 else slice_fields(bits, sps, t == 5,
                                                 u[0] >> 5 != 0))
                at = r.at[field]
                width = old_bits(r) if callable(old_bits) else old_bits
                u = nal_unit(u[0], bits[:at] + new + bits[at + width:])
            if t == kind:
                n += 1
            units.append(u)
        out.append(b"".join(b"\0\0\0\1" + u for u in units))
    return out


def read_slice_header(bits: str, nal: int, sps: BitReader,
                      pps: BitReader) -> dict:
    """A slice header (7.3.3, frame pictures) as a dict of its fields,
    with `data`: the slice data's bits (CAVLC) or bytes as a bit string
    after the cabac_alignment_one_bits (CABAC)."""
    r = BitReader(bits)
    h = {"nal": nal, "first_mb": r.ue(), "slice_type": r.ue(),
         "pps_id": r.ue()}
    kind = h["slice_type"] % 5
    h["frame_num"] = r.u(sps.log2_max_frame_num)
    assert sps.frame_mbs_only and pps.slice_groups == 1
    idr = nal & 31 == 5
    if idr:
        h["idr_pic_id"] = r.ue()
    if sps.poc_type == 0:
        h["poc_lsb"] = r.u(sps.log2_max_poc_lsb)
        if pps.bottom_field_pic_order:
            h["delta_poc_bottom"] = r.se()
    if sps.poc_type == 1 and not sps.delta_always_zero:
        h["delta_poc"] = [r.se()]
        if pps.bottom_field_pic_order:
            h["delta_poc"].append(r.se())
    assert not pps.redundant
    if kind == 1:
        h["direct_spatial"] = r.u(1)
    h["num_ref_idx"] = None
    if kind in (0, 1) and r.u(1):
        h["num_ref_idx"] = [r.ue() + 1] + ([r.ue() + 1] if kind == 1 else [])
    h["mods"] = [None, None]
    for lst in range(2 if kind == 1 else 1 if kind == 0 else 0):
        if r.u(1):
            mods = []
            while True:
                idc = r.ue()
                if idc == 3:
                    break
                mods.append((idc, r.ue()))
            h["mods"][lst] = mods
    n_ref = h["num_ref_idx"] or pps.num_ref_idx
    h["weights"] = None
    if (pps.weighted_pred and kind == 0) or (pps.weighted_bipred_idc == 1
                                             and kind == 1):
        chroma = sps.chroma_format_idc != 0
        w = {"luma_log2": r.ue(), "chroma_log2": r.ue() if chroma else 0,
             "lists": []}
        for lst in range(2 if kind == 1 else 1):
            entries = []
            for _ in range(n_ref[lst]):
                luma = (r.se(), r.se()) if r.u(1) else None
                cw = None
                if chroma and r.u(1):
                    cw = [(r.se(), r.se()) for _ in range(2)]
                entries.append((luma, cw))
            w["lists"].append(entries)
        h["weights"] = w
    if nal >> 5:
        if idr:
            h["no_output"], h["long_term"] = r.u(1), r.u(1)
        else:
            h["mmco"] = None
            if r.u(1):
                ops = []
                while True:
                    op = r.ue()
                    if op == 0:
                        break
                    args = []
                    if op in (1, 3):
                        args.append(r.ue())
                    if op == 2:
                        args.append(r.ue())
                    if op in (3, 6, 4):
                        args.append(r.ue())
                    ops.append((op, *args))
                h["mmco"] = ops
    if pps.cabac and kind != 2:
        h["cabac_init_idc"] = r.ue()
    h["qp_delta"] = r.se()
    if pps.deblocking_control:
        h["deblock"] = [r.ue()]
        if h["deblock"][0] != 1:
            h["deblock"] += [r.se(), r.se()]
    if pps.cabac:
        while r.p % 8:
            assert r.u(1) == 1
    h["data"] = bits[r.p:]
    return h


def slice_header_bits(h: dict, sps: BitReader, pps: BitReader) -> str:
    """read_slice_header's dict → the slice's RBSP bits (its data after
    the header; CABAC's re-aligned with cabac_alignment_one_bits)."""
    kind = h["slice_type"] % 5
    idr = h["nal"] & 31 == 5
    b = ue_bits(h["first_mb"]) + ue_bits(h["slice_type"]) + ue_bits(
        h["pps_id"]) + format(h["frame_num"] % (1 << sps.log2_max_frame_num),
                              f"0{sps.log2_max_frame_num}b")
    if idr:
        b += ue_bits(h["idr_pic_id"])
    if sps.poc_type == 0:
        b += format(h["poc_lsb"] % (1 << sps.log2_max_poc_lsb),
                    f"0{sps.log2_max_poc_lsb}b")
        if pps.bottom_field_pic_order:
            b += se_bits(h.get("delta_poc_bottom", 0))
    if sps.poc_type == 1 and not sps.delta_always_zero:
        d = h.get("delta_poc", [0, 0])
        b += se_bits(d[0])
        if pps.bottom_field_pic_order:
            b += se_bits(d[1] if len(d) > 1 else 0)
    if kind == 1:
        b += str(h["direct_spatial"])
    if kind in (0, 1):
        if h["num_ref_idx"]:
            b += "1" + "".join(ue_bits(n - 1) for n in h["num_ref_idx"])
        else:
            b += "0"
    for lst in range(2 if kind == 1 else 1 if kind == 0 else 0):
        mods = h["mods"][lst]
        if mods is None:
            b += "0"
        else:
            b += "1" + "".join(ue_bits(i) + ue_bits(v) for i, v in mods) + \
                ue_bits(3)
    if (pps.weighted_pred and kind == 0) or (pps.weighted_bipred_idc == 1
                                             and kind == 1):
        w = h["weights"]
        b += ue_bits(w["luma_log2"])
        if sps.chroma_format_idc:
            b += ue_bits(w["chroma_log2"])
        for entries in w["lists"]:
            for luma, cw in entries:
                b += "0" if luma is None else "1" + se_bits(luma[0]) + \
                    se_bits(luma[1])
                if sps.chroma_format_idc:
                    b += "0" if cw is None else "1" + "".join(
                        se_bits(x) + se_bits(y) for x, y in cw)
    if h["nal"] >> 5:
        if idr:
            b += str(h["no_output"]) + str(h["long_term"])
        elif h["mmco"] is None:
            b += "0"
        else:
            b += "1" + "".join("".join(ue_bits(x) for x in op)
                               for op in h["mmco"]) + ue_bits(0)
    if pps.cabac and kind != 2:
        b += ue_bits(h["cabac_init_idc"])
    b += se_bits(h["qp_delta"])
    if pps.deblocking_control:
        b += ue_bits(h["deblock"][0])
        if h["deblock"][0] != 1:
            b += se_bits(h["deblock"][1]) + se_bits(h["deblock"][2])
    if pps.cabac:
        b += "1" * (-len(b) % 8)
    return b + h["data"]


def rewrite_h264(aus, slices=None, sps_edit=None, pps_edit=None,
                 drop=None):
    """x264_encode's access units with their headers rewritten:
    `sps_edit(bits, reader)` and `pps_edit(bits, reader)` → a parameter
    set's new RBSP bits; `slices(i, header, sps, pps)` edits packet i's
    slice headers (read_slice_header's dicts) in place, CAVLC or CABAC
    (the alignment bits are written anew); `drop(i)` leaves packet i
    out. → (Annex B bytes, pts, dts) as x264_encode gives them."""
    old, new, out = {}, {}, []          # parameter sets as read and written
    for i, (au, pts, dts) in enumerate(aus):
        if drop and drop(i):
            continue
        units = []
        for u in nal_units(au):
            t = u[0] & 31
            bits = rbsp_bits(u)
            if t == 7:
                old[7] = sps_fields(bits)
                if sps_edit:
                    u = nal_unit(u[0], sps_edit(bits, old[7]))
                new[7] = sps_fields(rbsp_bits(u))
            elif t == 8:
                r = pps_fields(bits)
                old[r.pps_id] = r
                if pps_edit:
                    u = nal_unit(u[0], pps_edit(bits, r))
                new[r.pps_id] = pps_fields(rbsp_bits(u))
            elif t in (1, 5) and slices:
                pid = _slice_pps(bits)
                h = read_slice_header(bits, u[0], old[7], old[pid])
                slices(i, h, new[7], new[pid])
                u = nal_unit(u[0], slice_header_bits(h, new[7], new[pid]))
            units.append(u)
        out.append((b"".join(b"\0\0\0\1" + u for u in units), pts, dts))
    return out


def _slice_pps(bits: str) -> int:
    r = BitReader(bits)
    r.ue()
    r.ue()
    return r.ue()


def _first_slices(aus):
    """Each access unit's first slice header (read_slice_header's dict,
    its SPS beside it); (None, None) for one without a slice or whose
    slices come before their parameter sets."""
    sps, ppss, out = None, {}, []
    for au, _, _ in aus:
        first = (None, None)
        for u in nal_units(au):
            t = u[0] & 31
            bits = rbsp_bits(u)
            if t == 7:
                sps = sps_fields(bits)
            elif t == 8:
                r = pps_fields(bits)
                ppss[r.pps_id] = r
            elif t in (1, 5) and first[0] is None and \
                    _slice_pps(bits) in ppss:
                first = (read_slice_header(bits, u[0], sps,
                                           ppss[_slice_pps(bits)]), sps)
        out.append(first)
    return out


def picture_orders(aus) -> list[int]:
    """Each access unit's picture order count: POC type 0's from its
    lsb (8.2.1.1), else 2 · (pts − the last IDR picture's pts) (what
    libx264 writes)."""
    prev_msb = prev_lsb = idr_pts = 0
    out = []
    for (au, pts, _), first in zip(aus, _first_slices(aus)):
        h, sps = first
        if h["nal"] & 31 == 5:
            prev_msb = prev_lsb = 0
            idr_pts = pts
        if sps.poc_type != 0:
            out.append(2 * (pts - idr_pts))
            continue
        mx, lsb = 1 << sps.log2_max_poc_lsb, h["poc_lsb"]
        if lsb < prev_lsb and prev_lsb - lsb >= mx // 2:
            msb = prev_msb + mx
        elif lsb > prev_lsb and lsb - prev_lsb > mx // 2:
            msb = prev_msb - mx
        else:
            msb = prev_msb
        out.append(msb + lsb)
        if h["nal"] >> 5:
            prev_msb, prev_lsb = msb, lsb
    return out


def to_poc_type1(aus, non_ref: int = -1, top_bottom: int = 0,
                 cycle=(2,), always_zero: bool = False):
    """The stream under POC type 1 (8.2.1.2): its SPS's POC fields
    replaced by offset_for_non_ref_pic `non_ref`,
    offset_for_top_to_bottom_field `top_bottom` and the cycle of
    offset_for_ref_frame; each slice's delta_pic_order_cnt[0] set so the
    pictures keep their order counts (none under `always_zero`:
    delta_pic_order_always_zero_flag, the counts the cycle gives)."""
    pocs = picture_orders(aus)

    def sps_edit(bits, r):
        return (bits[:r.at["poc_type"]] + ue_bits(1) +
                ("1" if always_zero else "0") + se_bits(non_ref) +
                se_bits(top_bottom) + ue_bits(len(cycle)) +
                "".join(se_bits(c) for c in cycle) +
                bits[r.at["max_num_ref_frames"]:])

    state = {"fn": 0, "offset": 0, "delta": 0}

    def slices(i, h, sps, pps):
        if h["first_mb"] == 0:
            idr = h["nal"] & 31 == 5
            offset = 0 if idr else state["offset"] + (
                1 << sps.log2_max_frame_num if h["frame_num"] < state["fn"]
                else 0)
            n = offset + h["frame_num"]
            ref = h["nal"] >> 5
            if not ref and n > 0:
                n -= 1
            expected = 0
            if n > 0:
                c, k = divmod(n - 1, len(cycle))
                expected = c * sum(cycle) + sum(cycle[:k + 1])
            if not ref:
                expected += non_ref
            state.update(fn=h["frame_num"], offset=offset,
                         delta=pocs[i] - expected)
        h.pop("poc_lsb", None)
        h.pop("delta_poc_bottom", None)
        if not always_zero:
            h["delta_poc"] = [state["delta"]]

    return rewrite_h264(aus, slices=slices, sps_edit=sps_edit)


def explicit_bipred(aus, seed: int = 0):
    """The stream with weighted_bipred_idc 1: each B slice given a
    pred_weight_table of random weights (denominators 2^5, most entries
    with luma weights, some with chroma ones) and offsets."""
    import random

    rng = random.Random(seed)

    def pps_edit(bits, r):
        at = r.at["weighted_bipred_idc"]
        return bits[:at] + "01" + bits[at + 2:]

    def slices(i, h, sps, pps):
        if h["slice_type"] % 5 != 1:
            return
        n = h["num_ref_idx"] or pps.num_ref_idx
        h["weights"] = {"luma_log2": 5, "chroma_log2": 5, "lists": [[(
            (rng.randint(20, 44), rng.randint(-6, 6))
            if rng.random() < 0.8 else None,
            [(rng.randint(20, 44), rng.randint(-4, 4)) for _ in range(2)]
            if rng.random() < 0.6 else None) for _ in range(n[lst])]
            for lst in range(2)]}

    return rewrite_h264(aus, slices=slices, pps_edit=pps_edit)


def long_term_refs(aus, plan: dict, reset: int | None = None,
                   rebase_poc: bool = True):
    """The stream with `plan`'s slice header edits (packet → dict of
    `long_term` an IDR picture's long_term_reference_flag, `mmco` the
    memory_management_control_operations as (op, args...), `mods0` and
    `mods1` the lists' modifications as (idc, value)); an MMCO 5 added
    at packet `reset`, the later pictures' frame_num and (unless not
    `rebase_poc`: libavcodec's POC then runs on from the reset picture's
    own) POC lsb counted from it (8.2.1)."""
    pocs = picture_orders(aus)
    first = _first_slices(aus)

    def slices(i, h, sps, pps):
        p = plan.get(i, {})
        if "long_term" in p:
            h["long_term"] = p["long_term"]
        if "mmco" in p:
            h["mmco"] = p["mmco"]
        if "mods0" in p:
            h["mods"][0] = p["mods0"]
        if "mods1" in p:
            h["mods"][1] = p["mods1"]
        if reset is not None and i == reset:
            h["mmco"] = (h["mmco"] or []) + [(5,)]
        if reset is not None and i > reset:
            h["frame_num"] -= first[reset][0]["frame_num"]
            if "poc_lsb" in h and rebase_poc:
                h["poc_lsb"] = (pocs[i] - pocs[reset]) % (
                    1 << sps.log2_max_poc_lsb)

    return rewrite_h264(aus, slices=slices)


def _packet_of(aus, key):
    """The packet of `key`: a packet number, or "P<k>", "B<k>" or "I<k>"
    the k-th P, B or I picture."""
    if isinstance(key, int):
        return key
    seen = {0: 0, 1: 0, 2: 0}
    for i, (h, _) in enumerate(_first_slices(aus)):
        kind = h["slice_type"] % 5
        if "PBI"[kind] + str(seen[kind]) == key:
            return i
        seen[kind] += 1
    raise KeyError(key)


def strip_sei(aus):
    """The access units without their SEI NAL units."""
    return [(b"".join(b"\0\0\0\1" + u for u in nal_units(au)
                      if u[0] & 31 != 6), pts, dts) for au, pts, dts in aus]


def tools_stream(name: str):
    """An H264_TOOLS or TOOLS_CLIPS stream: its access units and (h, w)."""
    spec = {**H264_TOOLS, **TOOLS_CLIPS}[name]
    x264 = dict(spec.get("x264", {}))
    t = x264.pop("frames", 30)
    if name in TOOLS_CLIPS:
        frames = clip_frames_bgr()[:t]
    else:
        frames = moving_frames(spec.get("seed", sum(map(ord, name))), t)
    if spec["kind"] == "crop":
        x264["crop_rect"] = spec["crop"]
    aus = x264_encode(frames, **x264)
    if spec["kind"] == "cut":
        aus = aus[spec["cut"]:]
        if spec.get("strip_sei"):
            aus = strip_sei(aus)
    if "poc1" in spec:
        aus = to_poc_type1(aus, **spec["poc1"])
    if "gaps" in spec:
        dropped, flag = spec["gaps"]

        def gaps(bits, r):
            return bits[:r.at["gaps"]] + str(flag) + bits[r.at["gaps"] + 1:]

        aus = rewrite_h264(aus, sps_edit=gaps, drop=lambda i: i in dropped)
    if "bipred" in spec:
        aus = explicit_bipred(aus, spec["bipred"])
    if "ltr" in spec:
        plan = {_packet_of(aus, k): v for k, v in LTR_PLANS[spec["ltr"]].items()}
        reset = spec.get("reset")
        aus = long_term_refs(aus, plan, None if reset is None else
                             _packet_of(aus, reset),
                             spec.get("rebase_poc", True))
    return aus, frames.shape[1:3]


def h264_cut_file(aus, w: int, h: int, container: str,
                  audio: bool = False) -> bytes:
    """Access units that may begin anywhere (a copy cut) muxed as
    h264_file muxes them, the times counted from the first: its
    keyframes the IDR pictures and the I pictures with a recovery point
    SEI (the first packet one too, as ffmpeg's cut starts at one), MP4's
    edit list from the first presented sample (ffmpeg's muxer after
    `-ss ... -c copy`), Matroska's times from 0; `audio`, audio_track's
    sound beside it (Matroska)."""
    packets = [a for a, _, _ in aus]
    if container == "avi":
        return avi_file(packets, w, h, 25, len(packets), b"H264")
    keys = [0] + [i for i, (f, _) in enumerate(_first_slices(aus))
                  if i and f and (f["nal"] & 31 == 5 or (
                      f["slice_type"] % 5 == 2 and any(
                          u[0] & 31 == 6 and u[1] == 6
                          for u in nal_units(packets[i]))))]
    samples, sps, pps = avc_samples(packets)
    dts0, pts0 = aus[0][2], min(p for _, p, _ in aus)
    if container == "mp4":
        return mp4_file(samples, w, h, 25, b"avc1", avcc_box(sps, pps),
                        ctts=[p - d for _, p, d in aus],
                        media_time=pts0 - dts0, sync=keys)
    return mkv_file(samples, w, h, 25, "V_MPEG4/ISO/AVC",
                    avcc_box(sps, pps)[8:], pts=[p - pts0 for _, p, _ in aus],
                    keys=keys, audio=audio_track(len(samples), 25)
                    if audio else None)


def strip_vui(packets: list[bytes]) -> list[bytes]:
    """Annex B packets whose SPSs have no VUI (vui_parameters_present_flag
    0): no colour description, timing or bitstream_restriction."""
    out = []
    for p in packets:
        units = []
        for u in nal_units(p):
            if u[0] & 31 == 7:
                bits = rbsp_bits(u)
                u = nal_unit(u[0], bits[:sps_fields(bits).at["vui"]] + "01")
            units.append(u)
        out.append(b"".join(b"\0\0\0\1" + u for u in units))
    return out


# B sub-macroblock types (table 7-18): the partitions of each and the
# lists they predict from (1 L0, 2 L1, 3 both; 0 direct)
SUB_B_PARTS = (4, 1, 1, 1, 2, 2, 2, 2, 2, 2, 4, 4, 4)
SUB_B_LISTS = (0, 1, 2, 3, 1, 1, 2, 2, 3, 3, 1, 2, 3)


def sub8x8_b_slices(packets: list[bytes], seed: int) -> list[bytes]:
    """Annex B packets of libx264's CAVLC stream with each B picture's one
    slice (nal_ref_idc 0, one reference a list) replaced by one written
    here: its macroblocks B_8x8 (mb_type 22), each sub-macroblock of a
    type 0-12 in turn (4-12 cut 8x8 into 8x4, 4x8 and 4x4 partitions,
    which libx264 never writes), random motion vector differences
    within 3 samples, coded_block_pattern 0; some B_Skip between them.
    The slice header keeps the picture's frame_num and POC, spatial
    direct prediction, the deblocking filter on."""
    import random

    rng = random.Random(seed)
    sps = None
    out, turn = [], 0
    for p in packets:
        units = []
        for u in nal_units(p):
            t = u[0] & 31
            if t == 7:
                sps = sps_fields(rbsp_bits(u))
                n_mbs = None
            if t == 1:
                r = BitReader(rbsp_bits(u))
                r.ue()
                kind = r.ue() % 5
                if kind == 1:
                    assert u[0] >> 5 == 0, "B pictures must not be references"
                    r.ue()
                    frame_num = r.u(sps.log2_max_frame_num)
                    poc = r.u(sps.log2_max_poc_lsb)
                    bits = (ue_bits(0) + ue_bits(1) + ue_bits(0) +
                            format(frame_num, f"0{sps.log2_max_frame_num}b")
                            + format(poc, f"0{sps.log2_max_poc_lsb}b") +
                            "1" + "1" + ue_bits(0) + ue_bits(0) + "00" +
                            se_bits(0) + ue_bits(0) + se_bits(0) +
                            se_bits(0))
                    run = 0
                    for _ in range(sps.mbs):
                        if rng.random() < 0.15:
                            run += 1
                            continue
                        bits += ue_bits(run) + ue_bits(22)
                        run = 0
                        subs = [(turn + j) % 13 for j in range(4)]
                        turn += 3
                        bits += "".join(ue_bits(s) for s in subs)
                        for lst in (1, 2):
                            for s in subs:
                                if SUB_B_LISTS[s] & lst:
                                    bits += "".join(
                                        se_bits(rng.randint(-12, 12))
                                        for _ in range(2 * SUB_B_PARTS[s]))
                        bits += ue_bits(0)
                    if run:
                        bits += ue_bits(run)
                    u = nal_unit(u[0], bits + "1")
            units.append(u)
        out.append(b"".join(b"\0\0\0\1" + u for u in units))
    return out


def avcc_box(sps: bytes, pps: bytes) -> bytes:
    """An avcC box (AVCDecoderConfigurationRecord) of one SPS and one
    PPS, 4-byte NAL lengths; for the High profiles, the SPS's chroma
    format and bit depths, no SPS extensions."""
    body = bytes([1, sps[1], sps[2], sps[3], 0xFF, 0xE1]) + struct.pack(
        ">H", len(sps)) + sps + b"\1" + struct.pack(">H", len(pps)) + pps
    if sps[1] in (100, 110, 122, 244):
        f = sps_fields(rbsp_bits(sps))
        depth = 0xF8 | (f.bit_depth - 8)
        body += bytes([0xFC | f.chroma_format_idc, depth, depth, 0])
    return _box(b"avcC", body)


def avc_samples(aus: list[bytes]) -> tuple[list[bytes], bytes, bytes]:
    """Annex B access units as 4-byte length-prefixed samples without
    their SPS and PPS, and the first SPS and PPS."""
    sps = pps = None
    samples = []
    for au in aus:
        s = b""
        for u in nal_units(au):
            kind = u[0] & 0x1F
            if kind == 7:
                sps = sps or u
            elif kind == 8:
                pps = pps or u
            else:
                s += struct.pack(">I", len(u)) + u
        samples.append(s)
    return samples, sps, pps


def i420(bgr: np.ndarray) -> bytes:
    """A BGR frame as I420 planes (cv2's conversion; odd sizes by edge
    replication to even and cropping the chroma back)."""
    import cv2

    h, w = bgr.shape[:2]
    if h % 2 == 0 and w % 2 == 0:
        return cv2.cvtColor(np.ascontiguousarray(bgr),
                            cv2.COLOR_BGR2YUV_I420).tobytes()
    even = np.pad(bgr, ((0, h % 2), (0, w % 2), (0, 0)), mode="edge")
    yuv = cv2.cvtColor(even, cv2.COLOR_BGR2YUV_I420)
    eh, ew = even.shape[:2]
    y = yuv[:eh][:h, :w]
    chroma = yuv[eh:].ravel()
    u = chroma[:eh * ew // 4].reshape(eh // 2, ew // 2)
    v = chroma[eh * ew // 4:].reshape(eh // 2, ew // 2)
    cw, ch = (w + 1) // 2, (h + 1) // 2
    return y.tobytes() + u[:ch, :cw].tobytes() + v[:ch, :cw].tobytes()


def vpcc_box(profile: int = 0, depth: int = 8, chroma: int = 1) -> bytes:
    """A vpcC box (VP codec configuration, version 1) as cv2's muxer
    writes it: level 1.0, limited range, unspecified colour."""
    return _full_box(b"vpcC", 0x01000000, bytes(
        [profile, 10, (depth << 4) | (chroma << 1), 2, 2, 2, 0, 0]))


def patch_vp8(data: bytes, packets: list[bytes], change: str) -> bytes:
    """A VP8 Matroska file's bytes with VP8_PATCHED's `change` made to
    its packets (found in the file by their bytes)."""
    out = bytearray(data)
    for i, p in enumerate(packets):
        at = data.index(p)
        tag = out[at]
        if change.startswith("show_frame") and i == 5:
            out[at] = tag & ~0x10
        elif change.startswith("version"):
            out[at] = (tag & ~0x0E) | (int(change.split()[1]) << 1)
        elif change.startswith("width") and not tag & 1:   # a keyframe
            w, h = struct.unpack_from("<HH", out, at + 6)
            struct.pack_into("<HH", out, at + 6, 71 | (1 << 14),
                             (h & 0x3FFF) | (2 << 14))
    if change.startswith("width"):
        at = data.index(b"\xb0\x81" + bytes([W]))        # PixelWidth
        out[at + 2] = 71
    return bytes(out)


def cv2_packets(path: str) -> list[bytes]:
    """The packets cv2 demuxes (CAP_PROP_FORMAT -1), in decode order (not
    turned: OpenCV turns a raw packet's 1×n row as it would a picture,
    which reverses it at 180 and 270 degrees)."""
    import cv2

    cap = cv2.VideoCapture(path)
    cap.set(cv2.CAP_PROP_FORMAT, -1)
    cap.set(cv2.CAP_PROP_ORIENTATION_AUTO, 0)
    out = []
    while True:
        ok, p = cap.read()
        if not ok:
            break
        out.append(p.ravel().tobytes())
    cap.release()
    return out


def mp4toannexb(track) -> list[bytes]:
    """The packets of an H.264 track in MP4 or Matroska (length-prefixed
    NAL units, avcC record) as libavcodec's h264_mp4toannexb gives them
    to cv2: start codes of 4 bytes before a parameter set or a packet's
    first unit, else 3; the record's SPS and PPS before the first IDR
    slice of each IDR picture that carries none."""
    cfg = track.config
    nal_len = (cfg[4] & 3) + 1
    sets, p = [], 5
    for count_mask in (31, 255):
        n = cfg[p] & count_mask
        p += 1
        for _ in range(n):
            size = int.from_bytes(cfg[p:p + 2], "big")
            sets.append(cfg[p + 2:p + 2 + size])
            p += 2 + size
    extradata = b"".join(b"\0\0\0\1" + u for u in sets)
    out, new_idr = [], True
    for data, _ in track.packets:
        pkt, sps_seen, pps_seen, q = b"", False, False, 0
        while q < len(data):
            size = int.from_bytes(data[q:q + nal_len], "big")
            unit = data[q + nal_len:q + nal_len + size]
            q += nal_len + size
            kind = unit[0] & 31
            if kind == 7:
                sps_seen = new_idr = True
            elif kind == 8:
                pps_seen = new_idr = True
            if kind == 5 and unit[1] & 0x80:        # first_mb_in_slice 0
                new_idr = True
            if new_idr and kind == 5 and not sps_seen and not pps_seen:
                pkt += extradata
                new_idr = False
            pkt += (b"\0\0\0\1" if kind in (7, 8) or not pkt else
                    b"\0\0\1") + unit
            if not new_idr and kind == 1:
                new_idr, sps_seen, pps_seen = True, False, False
        out.append(pkt)
    return out


def pil_jpegs(frames, quality: int = 75, subsampling: int = 2,
              grey: bool = False) -> list[bytes]:
    """PIL's JPEGs of BGR frames: `subsampling` 2 (4:2:0), 1 (4:2:2) or
    0 (4:4:4); `grey`, one component."""
    from PIL import Image

    out = []
    for f in frames:
        buf = io.BytesIO()
        img = Image.fromarray(f[..., ::-1])
        if grey:
            img.convert("L").save(buf, "JPEG", quality=quality)
        else:
            img.save(buf, "JPEG", quality=quality, subsampling=subsampling)
        out.append(buf.getvalue())
    return out


def jpegs_of(frames, layout: str) -> list[bytes]:
    """JPEGs of BGR frames in `layout`: "4:2:0", "4:2:2", "4:4:4" or
    "grey" from PIL; "4:4:0" (Y sampled 1x2) from cv2's imencode, as PIL
    writes none; " CS=ITU601" after a layout puts ffmpeg's comment for
    limited-range YCbCr after SOI."""
    import cv2

    kind = layout.split()[0]
    if kind == "4:4:0":
        out = [cv2.imencode(".jpg", np.ascontiguousarray(f), [
            cv2.IMWRITE_JPEG_QUALITY, 75,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR, 0x121111])[1].tobytes()
            for f in frames]
    else:
        out = pil_jpegs(frames, subsampling={"4:2:0": 2, "4:2:2": 1,
                                             "4:4:4": 0}.get(kind, 0),
                        grey=kind == "grey")
    if layout.endswith("CS=ITU601"):
        com = b"\xff\xfe" + struct.pack(">H", 12) + b"CS=ITU601\0"
        out = [j[:2] + com + j[2:] for j in out]
    return out


def clip_frames_bgr() -> np.ndarray:
    from PIL import Image

    files = sorted(os.listdir(CLIP_DIR))
    return np.stack([np.asarray(Image.open(os.path.join(CLIP_DIR, f))
                                .convert("RGB"))[..., ::-1] for f in files])


def cv2_view(path: str) -> tuple[np.ndarray, int]:
    """Every frame cv2 decodes, and the frame count it reports."""
    import cv2

    cap = cv2.VideoCapture(path)
    count = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f)
    cap.release()
    return np.stack(frames), count


def relabel(src: str, dst: str, old: bytes, new: bytes) -> str:
    """A copy of the AVI `src` at `dst` with its strh and strf fourccs
    `old` rewritten `new`."""
    data = open(src, "rb").read()
    assert data.count(old) >= 2, (src, old)
    with open(dst, "wb") as f:
        f.write(data.replace(old, new))
    return dst


def h264_file(aus: list[tuple[bytes, int, int]], w: int, h: int,
              container: str, fps: int = 25,
              edits: list[tuple[int, int | None]] | None = None) -> bytes:
    """x264_encode's access units muxed as a file: "avi" (Annex B under
    the fourcc H264), "mp4" (avc1 and avcC, ctts, stss and the edit list
    ffmpeg's muxer writes from the first presented sample, or `edits`:
    EDIT_CASES' (duration, media time after that sample's) entries) or
    "mkv" (V_MPEG4/ISO/AVC with its avcC CodecPrivate, presentation
    times)."""
    packets = [a for a, _, _ in aus]
    if container == "avi":
        return avi_file(packets, w, h, fps, len(packets), b"H264")
    samples, sps, pps = avc_samples(packets)
    keys = [i for i, a in enumerate(packets)
            if any(u[0] & 31 == 5 for u in nal_units(a))]
    dts0 = aus[0][2]
    if container == "mp4":
        elst = None if edits is None else [
            (d, -1 if t is None else t - dts0, 0x10000) for d, t in edits]
        return mp4_file(samples, w, h, fps, b"avc1", avcc_box(sps, pps),
                        ctts=[p - d for _, p, d in aus],
                        media_time=None if edits else -dts0, sync=keys,
                        edits=elst)
    return mkv_file(samples, w, h, fps, "V_MPEG4/ISO/AVC",
                    avcc_box(sps, pps)[8:], pts=[p for _, p, _ in aus],
                    keys=keys)


def hevc_rbsp(unit: bytes) -> bytes:
    """An HEVC NAL unit's payload after its 2-byte header, emulation
    prevention removed."""
    out, zeros = bytearray(), 0
    for b in unit[2:]:
        if zeros >= 2 and b == 3:
            zeros = 0
            continue
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


def hevc_type(unit: bytes) -> int:
    return (unit[0] >> 1) & 63


def hvcc_box(vps: bytes, sps: bytes, pps: bytes, depth: int = 8) -> bytes:
    """An hvcC box (HEVCDecoderConfigurationRecord) of one VPS, SPS and
    PPS (complete arrays), 4-byte NAL lengths: the SPS's general profile,
    tier, compatibility, constraint and level bytes, 4:2:0 at `depth`
    bits, its sub-layers, no frame rate."""
    r = hevc_rbsp(sps)
    layers = ((r[0] >> 1) & 7) + 1
    body = bytes([1]) + r[1:13] + struct.pack(
        ">HBBBBHB", 0xF000, 0xFC, 0xFD, 0xF8 | (depth - 8),
        0xF8 | (depth - 8), 0, (layers << 3) | (r[0] & 1) << 2 | 3)
    body += bytes([3])
    for unit in (vps, sps, pps):
        body += bytes([0x80 | hevc_type(unit)]) + struct.pack(
            ">HH", 1, len(unit)) + unit
    return _box(b"hvcC", body)


def hevc_stream(settings: dict, frames=None,
                seed: int = 0) -> list[tuple[bytes, int, int]]:
    """An HEVC_CASES or HEVC_CLIPS stream: libx265's access units of
    `frames` (else moving_frames(seed) of the settings' size and number)
    as (Annex B bytes, pts, dts) in frames; from the first CRA on when
    the settings `cut`."""
    settings = dict(settings)
    h, w = settings.pop("size", HEVC_SIZE)
    t = settings.pop("frames", HEVC_FRAMES)
    cut = settings.pop("cut", False)
    params = settings.pop("params", "")
    for k in ("entry", "matrix", "audio", "seed"):
        settings.pop(k, None)
    if frames is None:
        frames = moving_frames(seed, t, h, w)
    times = []
    packets = lavc_encode(frames, "libx265", times=times,
                          **{"x265-params": params}, **settings)
    aus = [(p, pts, dts) for p, (pts, dts) in zip(packets, times)]
    if cut:
        first = next(i for i, (p, _, _) in enumerate(aus)
                     if any(hevc_type(u) == 21 for u in nal_units(p)))
        aus = aus[first:]
    return aus


def hevc_file(aus: list[tuple[bytes, int, int]], w: int, h: int,
              container: str, entry: str = "hvc1", matrix: int = 0,
              audio: bool = False, depth: int = 8) -> bytes:
    """hevc_stream's access units muxed as a file: "avi" (Annex B under
    the fourcc HEVC), "mp4" (4-byte length-prefixed samples under the
    sample entry `entry`: "hvc1" with the parameter sets in its hvcC
    only, "hev1" with them in-band too; IRAP pictures as sync samples,
    ctts and the edit list ffmpeg's muxer writes from the first presented
    sample; `matrix`, tkhd's turn in degrees; `audio`, aac_track's AAC
    beside it) or "mkv" (V_MPEGH/ISO/HEVC with the hvcC record as its
    CodecPrivate, the parameter sets out of the blocks, presentation
    times)."""
    packets = [a for a, _, _ in aus]
    if container == "avi":
        return avi_file(packets, w, h, 25, len(packets), b"HEVC")
    sets, samples, keys = {}, [], []
    for i, au in enumerate(packets):
        sample = b""
        for u in nal_units(au):
            kind = hevc_type(u)
            if 32 <= kind <= 34:
                sets.setdefault(kind, u)
                if not (container == "mp4" and entry == "hev1"):
                    continue
            if 16 <= kind <= 23 and (not keys or keys[-1] != i):
                keys.append(i)
            sample += struct.pack(">I", len(u)) + u
        samples.append(sample)
    hvcc = hvcc_box(sets[32], sets[33], sets[34], depth)
    dts0 = aus[0][2]
    first = min(p for _, p, _ in aus) - dts0
    if container == "mp4":
        return mp4_file(samples, w, h, 25, entry.encode(), hvcc,
                        ctts=[p - d for _, p, d in aus], media_time=first,
                        sync=keys,
                        matrix=display_matrix(matrix) if matrix else None,
                        audio=aac_track(len(samples), 25) if audio else None)
    return mkv_file(samples, w, h, 25, "V_MPEGH/ISO/HEVC", hvcc[8:],
                    pts=[p - min(q for _, q, _ in aus) for _, p, _ in aus],
                    keys=keys)


def mpeg12_set(body: bytearray, bit: int, n: int, value: int) -> None:
    """Set `n` bits of `body` from bit `bit` on (MSB first) to `value`."""
    for k in range(n):
        i, m = divmod(bit + k, 8)
        if (value >> (n - 1 - k)) & 1:
            body[i] |= 0x80 >> m
        else:
            body[i] &= ~(0x80 >> m) & 0xFF


# The MPEG-1/2 header fields patch_mpeg12 changes: (the header, the bit
# after its start code (an extension's 4-bit id included), the width).
MPEG12_BITS = {
    "progressive_sequence": ("seq_ext", 12, 1),
    "chroma_format": ("seq_ext", 13, 2),
    "closed_gop": ("gop", 25, 1), "broken_link": ("gop", 26, 1),
    "picture_coding_type": ("picture", 10, 3),
    "full_pel_forward_vector": ("picture", 29, 1),
    "picture_structure": ("pic_ext", 22, 2),
    "top_field_first": ("pic_ext", 24, 1),
    "repeat_first_field": ("pic_ext", 30, 1),
    "progressive_frame": ("pic_ext", 32, 1),
}


def mpeg12_headers(packets: list[bytes]) -> list[list[tuple[str, int]]]:
    """Each packet's headers: (kind, offset of the byte after the start
    code), kind "seq", "seq_ext", "disp_ext", "gop", "picture",
    "pic_ext", "slice" or the start code's value in hex."""
    out = []
    for p in packets:
        found, i = [], p.find(b"\0\0\1")
        while i >= 0 and i + 3 < len(p):
            c, at = p[i + 3], i + 4
            kind = {0xB3: "seq", 0xB8: "gop", 0x00: "picture"}.get(c)
            if c == 0xB5 and at < len(p):
                kind = {1: "seq_ext", 2: "disp_ext", 8: "pic_ext"}.get(
                    p[at] >> 4, f"ext{p[at] >> 4}")
            elif kind is None:
                kind = "slice" if 1 <= c <= 0xAF else f"{c:02x}"
            found.append((kind, at))
            i = p.find(b"\0\0\1", at)
        out.append(found)
    return out


def patch_mpeg12(packets: list[bytes], edit) -> list[bytes]:
    """`packets` with header fields changed: `edit(packet index, header
    index among the headers of its kind, field name)` gives each field of
    MPEG12_BITS a new value, or None to keep it."""
    out, seen = [], {}
    for i, (p, heads) in enumerate(zip(packets, mpeg12_headers(packets))):
        body = bytearray(p)
        for kind, at in heads:
            k = seen.get(kind, 0)
            seen[kind] = k + 1
            for field, (where, bit, n) in MPEG12_BITS.items():
                if where != kind:
                    continue
                v = edit(i, k, field)
                if v is not None:
                    view = bytearray(body[at:at + 8])
                    mpeg12_set(view, bit, n, v)
                    body[at:at + 8] = view
        out.append(bytes(body))
    return out


def mpeg12_quant_ext(packets: list[bytes], chroma_intra: list[int],
                     chroma_inter: list[int]) -> list[bytes]:
    """`packets` with a quant matrix extension after the coding extension
    of each picture whose packet holds a sequence header: no luma
    matrices, the chroma intra and inter matrices `chroma_intra` and
    `chroma_inter` (natural order; 8 bits each in zigzag order)."""
    zz = [0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19,
          26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49,
          56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52,
          45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63]
    bits = "0011" + "0" + "0" + "1" + "".join(
        f"{chroma_intra[j]:08b}" for j in zz) + "1" + "".join(
        f"{chroma_inter[j]:08b}" for j in zz)
    bits += "0" * (-len(bits) % 8)
    ext = b"\0\0\1\xb5" + bytes(int(bits[i:i + 8], 2)
                                    for i in range(0, len(bits), 8))
    out = []
    for p, heads in zip(packets, mpeg12_headers(packets)):
        kinds = [k for k, _ in heads]
        if "seq" in kinds and "pic_ext" in kinds:
            at = heads[kinds.index("pic_ext") + 1][1] - 4
            p = p[:at] + ext + p[at:]
        out.append(p)
    return out


def mpeg12_config(packet: bytes) -> bytes:
    """The sequence header and its extensions that begin an MPEG-1/2
    packet: its bytes before the first GOP or picture start code."""
    ends = [i for i in (packet.find(b"\0\0\1\xb8"),
                        packet.find(b"\0\0\1\0")) if i >= 0]
    return packet[:min(ends)]


def dvd_stream(settings: dict, frames=None, seed: int = 0):
    """A DVD_STREAMS (or DVD_CLIPS, DVD_UNREAD) stream: (packets, their
    (pts, dts) in frames, (w, h) of the first picture)."""
    opts = dict(settings)
    enc = opts.pop("encoder", "mpeg2video")
    t = opts.pop("frames", 20)
    h, w = opts.pop("size", (64, 96))
    sizes = opts.pop("sizes", None)
    chroma = opts.pop("chroma", None)
    telecine = opts.pop("telecine", False)
    cut = opts.pop("cut", False)
    edit = opts.pop("edit", None)
    if frames is None:
        frames = moving_frames(seed, t, h, w)
    elif frames.shape[1:3] != (h, w):
        import cv2

        frames = np.stack([cv2.resize(f, (w, h), interpolation=cv2.INTER_AREA)
                           for f in frames])
    if edit in ("D-picture", "full_pel") and "bf" not in opts:
        opts["bf"] = 0
    times: list = []
    if sizes:
        packets = []
        for k, (sh, sw) in enumerate(sizes):
            part = moving_frames(seed + k, 12, sh, sw)
            tk: list = []
            packets += lavc_encode(part, enc, times=tk, **opts)
            times += [(p + 12 * k, d + 12 * k) for p, d in tk]
        h, w = sizes[0]
    else:
        packets = lavc_encode(frames, enc, times=times, **opts)
    if cut:
        at = [i for i, p in enumerate(packets) if b"\0\0\1\xb8" in p][1]
        d0 = times[at][1]
        packets = packets[at:]
        times = [(p - d0, d - d0) for p, d in times[at:]]
    if chroma:
        packets = mpeg12_quant_ext(packets, *chroma)
    if telecine:
        # 3:2 pulldown in display order: (top_field_first,
        # repeat_first_field) of each picture by its pts.
        cadence = [(1, 1), (0, 0), (0, 1), (1, 0)]
        pts = [p for p, _ in times]
        packets = patch_mpeg12(packets, lambda i, k, f: {
            "progressive_sequence": 0,
            "top_field_first": cadence[pts[i] % 4][0],
            "repeat_first_field": cadence[pts[i] % 4][1]}.get(f))
    if edit == "frames":
        packets = patch_mpeg12(packets, lambda i, k, f:
                               1 if f == "progressive_frame" else None)
    elif edit == "field":
        packets = patch_mpeg12(packets, lambda i, k, f: {
            "progressive_sequence": 0, "picture_structure": 1,
            "progressive_frame": 0}.get(f))
    elif edit == "D-picture":
        kinds = [(p[p.find(b"\0\0\1\0") + 5] >> 3) & 7 for p in packets]
        packets = patch_mpeg12(packets, lambda i, k, f: 4 if (
            f == "picture_coding_type" and kinds[i] == 1 and i) else None)
    elif edit == "full_pel":
        kinds = [(p[p.find(b"\0\0\1\0") + 5] >> 3) & 7 for p in packets]
        packets = patch_mpeg12(packets, lambda i, k, f: 1 if (
            f == "full_pel_forward_vector" and kinds[i] == 2) else None)
    elif edit == "scalable":
        packets = [p.replace(b"\0\0\1\xb8", b"\0\0\1\xb5\x50\0\0\0\0\1\xb8", 1)
                   for p in packets]
    elif edit == "4:4:4":
        packets = patch_mpeg12(packets, lambda i, k, f:
                               3 if f == "chroma_format" else None)
    return packets, times, (w, h)


def dvd_file(packets: list[bytes], times: list[tuple[int, int]], w: int,
             h: int, container: str, mpeg1: bool = False, oti: int = 0x61,
             fps: int = 25) -> bytes:
    """dvd_stream's packets muxed as "avi" (fourcc mpg2, or mpg1), "mp4"
    (mp4v with the first packet's sequence header as the esds's
    DecoderSpecificInfo, objectTypeIndication `oti` (0x6A for MPEG-1),
    ctts and the edit list from the first presented sample) or "mkv"
    (V_MPEG2 or V_MPEG1, the sequence header as CodecPrivate,
    presentation times); the packets keep their in-band headers."""
    if container == "avi":
        return avi_file(packets, w, h, fps, len(packets),
                        b"mpg1" if mpeg1 else b"mpg2")
    config = mpeg12_config(packets[0])
    if container == "mp4":
        return mp4_file(packets, w, h, fps, b"mp4v",
                        esds_box(config, oti=0x6A if mpeg1 else oti),
                        ctts=[p - d for p, d in times],
                        media_time=-times[0][1])
    return mkv_file(packets, w, h, fps, "V_MPEG1" if mpeg1 else "V_MPEG2",
                    config, pts=[p for p, _ in times])


def lavc_file(packets: list[bytes], times: list[tuple[int, int]], w: int,
              h: int, fourcc: bytes, container: str, fps: int = 25) -> bytes:
    """lavc_encode's MPEG-4 Part 2 packets and their (pts, dts) muxed as
    "avi" (under `fourcc`), "mp4" (mp4v with the first packet's headers
    in its esds; ctts and the edit list from the first presented sample,
    as ffmpeg's muxer writes them for B-VOPs) or "mkv" (V_MPEG4/ISO/ASP,
    the headers as CodecPrivate, presentation times); the packets keep
    their in-band headers."""
    if container == "avi":
        return avi_file(packets, w, h, fps, len(packets), fourcc)
    headers = mpeg4_headers(packets[0])
    if container == "mp4":
        return mp4_file(packets, w, h, fps, b"mp4v", esds_box(headers),
                        ctts=[p - d for p, d in times],
                        media_time=-times[0][1])
    return mkv_file(packets, w, h, fps, "V_MPEG4/ISO/ASP", headers,
                    pts=[p for p, _ in times])


def container_packets(stream: str, frames=None):
    """A CONTAINER_CASES stream (or libx264's of `frames`, BGR): (packets,
    keyframes, (w, h), the sample entry's box or CodecPrivate, and H.264's
    (pts, dts) in frames, else None)."""
    import tempfile

    if stream == "h264":
        if frames is None:
            frames = moving_frames(sum(map(ord, "h264_high_mp4")), 30)
        aus = x264_encode(frames, keyint=12 if len(frames) > 16 else 8)
        samples, sps, pps = avc_samples([a for a, _, _ in aus])
        keys = [i for i, (a, _, _) in enumerate(aus)
                if any(u[0] & 31 == 5 for u in nal_units(a))]
        h, w = frames.shape[1:3]
        return samples, keys, (w, h), avcc_box(sps, pps), \
            [(p, d) for _, p, d in aus]
    if stream == "mjpeg":
        frames = moving_frames(sum(map(ord, "mjpeg_odml_avi")), 12)
        return jpegs_of(frames, "4:2:2"), list(range(12)), (W, H), b"", None
    name = {"mpeg4": "mpeg4_avi", "vp8": "vp8_webm"}[stream]
    ext, fourcc, fps, t = CASES[name]
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "src." + ext)
        write_cv2(src, fourcc, fps, moving_frames(sum(map(ord, name)), t))
        packets = cv2_packets(src)
    if stream == "vp8":
        return packets, [i for i, p in enumerate(packets) if not p[0] & 1], \
            (W, H), b"", None
    keys = [i for i, p in enumerate(packets)
            if (p[p.index(b"\0\0\1\xb6") + 4] >> 6) == 0]
    return packets, keys, (W, H), esds_box(mpeg4_headers(packets[0])), None


def container_file(name: str, opts: dict, stream: str, frames=None) -> bytes:
    """A CONTAINER_CASES or PHONE_CLIPS file: `stream`'s packets under
    `opts` in the container the name ends with."""
    packets, keys, (w, h), config, times = container_packets(stream, frames)
    opts = dict(opts)
    ext = name.rsplit("_", 1)[1]
    n = len(packets)
    audio = opts.pop("audio", None)
    if audio:
        first = not audio.endswith("after")
        audio = aac_track(n, 25, first=first) if audio.startswith("aac") \
            else audio_track(n, 25, 8000, first=first)
    if ext == "avi":
        split = opts.pop("split", None)
        fourcc = {"mpeg4": b"FMP4", "mjpeg": b"MJPG"}[stream]
        if split:
            return avi_odml_file(packets, w, h, 25, split, fourcc,
                                 audio=audio)
        return avi_file(packets, w, h, 25, n, fourcc, audio=audio)
    if ext == "mkv":
        rate = opts.pop("rate", None)
        if rate:
            opts.update(default_duration=False, duration=n * 1000 / rate,
                        times=[int(round(i * 1000 / rate)) for i in range(n)])
        return mkv_file(packets, w, h, 25, "V_VP8", audio=audio, **opts)
    for k in ("matrix", "movie_matrix"):
        if k in opts:
            v = opts[k]
            opts[k] = display_matrix(0, 2.0) if v == "scale2" else \
                display_matrix(v, w=w, h=h)
    frag = opts.pop("fragments", None)
    if frag == "sample":
        opts["fragments"] = [1] * (n - opts.get("moov_samples", 0))
    elif frag == "key":
        starts = [k for k in keys if k >= opts.get("moov_samples", 0)] + [n]
        opts["fragments"] = [b - a for a, b in zip(starts, starts[1:])]
    if stream == "h264":
        dts0 = times[0][1]
        if opts.pop("negative", False):
            opts["ctts"] = [p - (d - dts0) for p, d in times]
        else:
            opts.update(ctts=[p - d for p, d in times], media_time=-dts0)
    entry = {"h264": b"avc1", "mpeg4": b"mp4v"}[stream]
    return mp4_file(packets, w, h, 25, entry, config, sync=keys, audio=audio,
                    **opts)


def camera_stream(settings: dict, frames=None,
                  seed: int = 0) -> list[tuple[bytes, int, int]]:
    """A CAMERA_CASES, CAMERA_CLIPS, SCREEN_CASES or SCREEN_CLIPS
    stream: x264_encode's access units of `frames` (else
    moving_frames(seed) of the settings' size and number), with uniform
    `noise` (on the left `noise_cols` of each frame's columns, else on
    all), rewritten by the settings' `edit`."""
    settings = dict(settings)
    edit = settings.pop("edit", None)
    h, w = settings.pop("size", (48, 64))
    t = settings.pop("frames", 12)
    noise = settings.pop("noise", 0)
    cols = settings.pop("noise_cols", 1.0)
    if frames is None:
        frames = moving_frames(seed, t + (16 if edit == "deep" else 0), h, w)
    if noise:
        rng = np.random.default_rng(noise)
        grain = rng.uniform(-noise, noise, frames.shape)
        grain[:, :, int(frames.shape[2] * cols):] = 0
        frames = np.clip(frames + grain, 0, 255).astype(np.uint8)
    if edit == "deep":
        aus = x264_encode(frames[:t], **settings)
        aus += [(a, p + t, d + t) for a, p, d in x264_encode(
            frames[t:], bframes=3, b_pyramid="normal", b_adapt=0)]
        edit = "no restriction"
    else:
        aus = x264_encode(frames, **settings)
    packets = [a for a, _, _ in aus]
    if edit == "no restriction":
        packets = patch_h264(packets, 7, "bitstream_restriction", "0")
    elif edit == "no vui":
        packets = strip_vui(packets)
    elif edit == "sub8x8":
        packets = sub8x8_b_slices(packets, len(packets))
    elif edit in ("12 bits", "14 bits"):
        depth = ue_bits(int(edit.split()[0]) - 8)
        for field in ("bit_depth_luma", "bit_depth_chroma"):
            packets = patch_h264(packets, 7, field, depth, 3)
    return [(p, a[1], a[2]) for p, a in zip(packets, aus)]


def scheduled_frames(runs, seed: int, source=None) -> list[np.ndarray]:
    """Frames in runs of (h, w, frames): `source` (BGR frames at the
    largest size; else moving_frames of it), resized (INTER_AREA) where a
    run is smaller."""
    import cv2

    n = sum(r[2] for r in runs)
    big_h, big_w = max(r[0] for r in runs), max(r[1] for r in runs)
    src = moving_frames(seed, n, big_h, big_w) if source is None \
        else source[:n]
    out = []
    for h, w, k in runs:
        for f in src[len(out):len(out) + k]:
            out.append(f if f.shape[:2] == (h, w) else cv2.resize(
                f, (w, h), interpolation=cv2.INTER_AREA))
    return out


def browser_file(name: str, settings: dict, seed: int,
                 source=None) -> bytes:
    """A BROWSER_CASES or BROWSER_CLIPS file, muxed as its name says."""
    import io

    from PIL import Image

    settings = dict(settings)
    ext = name.rsplit("_", 1)[1]
    kind = settings.pop("kind", "vp9")
    if kind == "streams":
        codec, parts = settings.pop("codec"), settings.pop("parts")
        runs = [scheduled_frames([p], seed + i) for i, p in enumerate(parts)]
        h, w = parts[0][:2]
        cw, ch = settings.pop("container", (w, h))
        if codec == "vp9":
            packets = [q for r in runs for q in libvpx_encode(r, "vp9")]
        elif codec == "mjpeg":
            packets = []
            for r in runs:
                for f in r:
                    b = io.BytesIO()
                    Image.fromarray(f[..., ::-1]).save(b, "JPEG", quality=75)
                    packets.append(b.getvalue())
            return avi_file(packets, cw, ch, 25, len(packets), b"MJPG")
        else:
            aus, t = [], 0
            for i, r in enumerate(runs):
                more = x264_encode(np.stack(r), bframes=i and
                                   settings.get("bframes", 0))
                aus += [(a, p + t, d + t) for a, p, d in more]
                t += len(r)
            return h264_file(aus, cw, ch, ext)
    else:
        runs = settings.pop("sizes", [(48, 64, 10)] if source is None else
                            [(*source.shape[1:3], len(source))])
        frames = scheduled_frames(runs, seed, source)
        packets = libvpx_encode(frames, "vp9", **settings)
        h, w = runs[0][:2]
        cw, ch = w, h
    if ext in ("webm", "mkv"):
        return mkv_file(packets, cw, ch, 25, "V_VP9")
    if ext == "avi":
        return avi_file(packets, cw, ch, 25, len(packets), b"VP90")
    chroma = {"420": 1, "422": 2, "440": 1, "444": 3, "gbr": 3}[
        settings.get("layout", "420")]
    return mp4_file(packets, cw, ch, 25, b"vp09", vpcc_box(
        settings.get("profile", 0), settings.get("bit_depth", 8), chroma))


def _yuv_planes(frames: np.ndarray) -> list[np.ndarray]:
    """BGR frames (t, h, w, 3) → Y, U, V (t, h, w) uint8 at BT.601's
    limited range."""
    f = frames.astype(np.float64)
    b, g, r = f[..., 0], f[..., 1], f[..., 2]
    y = 16 + (65.481 * r + 128.553 * g + 24.966 * b) / 255
    u = 128 + (-37.797 * r - 74.203 * g + 112.0 * b) / 255
    v = 128 + (112.0 * r - 93.786 * g - 18.214 * b) / 255
    return [np.clip(np.rint(p), 0, 255).astype(np.uint8) for p in (y, u, v)]


def _subsample(p: np.ndarray, xs: int, ys: int) -> np.ndarray:
    """(t, h, w) → (t, ⌈h / 2^ys⌉, ⌈w / 2^xs⌉), each sample the mean of
    the ones it covers."""
    t, h, w = p.shape
    hh, ww = -(-h // (1 << ys)), -(-w // (1 << xs))
    acc, n = np.zeros((t, hh, ww)), np.zeros((hh, ww))
    for dy in range(1 << ys):
        for dx in range(1 << xs):
            q = p[:, dy::1 << ys, dx::1 << xs]
            acc[:, :q.shape[1], :q.shape[2]] += q
            n[:q.shape[1], :q.shape[2]] += 1
    return np.rint(acc / n).astype(np.uint8)


def _v210_row(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> bytes:
    """One row of 10-bit 4:2:2 samples as v210: per 6 pixels four
    little-endian words of three samples (Cb Y Cr, Y Cb Y, Cr Y Cb,
    Y Cr Y), the row padded to ⌈w/48⌉·128 bytes."""
    w = len(y)
    n6 = -(-w // 6)
    yy = np.zeros(6 * n6, np.uint32)
    uu = np.zeros(3 * n6, np.uint32)
    vv = np.zeros(3 * n6, np.uint32)
    yy[:w], uu[:len(u)], vv[:len(v)] = y, u, v
    order = [(uu, 0, yy, 0, vv, 0), (yy, 1, uu, 1, yy, 2),
             (vv, 1, yy, 3, uu, 2), (yy, 4, vv, 2, yy, 5)]
    words = np.zeros((n6, 4), np.uint32)
    for k, (a, i, b, j, c, m) in enumerate(order):
        sa = 6 if a is yy else 3
        sb = 6 if b is yy else 3
        sc = 6 if c is yy else 3
        words[:, k] = (a[i::sa][:n6] | (b[j::sb][:n6] << 10)
                       | (c[m::sc][:n6] << 20))
    row = words.astype("<u4").tobytes()
    return row + bytes(((w + 47) // 48) * 128 - len(row))


def raw_packets(layout: str, frames: np.ndarray, seed: int = 0,
                bits: int = 24, top_down: bool = False) -> list[bytes]:
    """BGR frames as uncompressed video packets of `layout`: "i420",
    "yv12" (V before U), "nv12", "nv21", "grey", "yuyv", "uyvy", "yvyu",
    "y42b" / "yv16" (4:2:2 planar, U or V first), "i444" / "yv24"
    (4:4:4, U or V first), "i440" (4:4:0), "y41b" (4:1:1), "v210"
    (10-bit: the 8-bit samples · 4 plus random low bits), "rgb24",
    "bgr24", "rgba", "bgra"; "dib", a BI_RGB DIB of
    `bits` 8 (an index of the green and red levels), 16 (RGB555), 24 or
    32 (B, G, R, 0x7F), its rows padded to 4 bytes, bottom-up unless
    `top_down`. Planes at av_image_fill_arrays' sizes (chroma rounded up,
    rows unpadded)."""
    t, h, w = frames.shape[:3]
    y, u, v = _yuv_planes(frames)
    rng = np.random.default_rng(seed)
    out = []
    for k in range(t):
        f, yk = frames[k], y[k]
        if layout in ("i420", "yv12", "nv12", "nv21"):
            uk, vk = _subsample(u, 1, 1)[k], _subsample(v, 1, 1)[k]
            if layout == "nv12" or layout == "nv21":
                pair = [uk, vk] if layout == "nv12" else [vk, uk]
                d = yk.tobytes() + np.stack(pair, -1).tobytes()
            else:
                first, second = (uk, vk) if layout == "i420" else (vk, uk)
                d = yk.tobytes() + first.tobytes() + second.tobytes()
        elif layout == "grey":
            d = yk.tobytes()
        elif layout in ("yuyv", "uyvy", "yvyu"):
            uk, vk = _subsample(u, 1, 0)[k], _subsample(v, 1, 0)[k]
            ys = np.zeros((h, 2 * uk.shape[1]), np.uint8)
            ys[:, :w] = yk
            y0, y1 = ys[:, 0::2], ys[:, 1::2]
            d = np.stack({"yuyv": (y0, uk, y1, vk), "uyvy": (uk, y0, vk, y1),
                          "yvyu": (y0, vk, y1, uk)}[layout], -1).tobytes()
        elif layout in ("y42b", "yv16", "y41b", "i444", "yv24", "i440"):
            xs = {"y41b": 2, "yv24": 0, "i444": 0, "i440": 0}.get(layout, 1)
            ys = 1 if layout == "i440" else 0
            uk, vk = _subsample(u, xs, ys)[k], _subsample(v, xs, ys)[k]
            if layout in ("yv16", "yv24"):
                uk, vk = vk, uk
            d = yk.tobytes() + uk.tobytes() + vk.tobytes()
        elif layout == "v210":
            uk = _subsample(u, 1, 0)[k].astype(np.uint32) * 4
            vk = _subsample(v, 1, 0)[k].astype(np.uint32) * 4
            yl = yk.astype(np.uint32) * 4
            yl, uk, vk = (p + rng.integers(0, 4, p.shape, np.uint32)
                          for p in (yl, uk, vk))
            d = b"".join(_v210_row(yl[r], uk[r], vk[r]) for r in range(h))
        elif layout in ("rgb24", "bgr24", "rgba", "bgra"):
            px = f if layout[0] == "b" else f[..., ::-1]
            if layout.endswith("a"):
                px = np.concatenate([px, np.full((h, w, 1), 0x7F, np.uint8)],
                                    -1)
            d = np.ascontiguousarray(px).tobytes()
        elif layout == "dib":
            if bits == 8:
                rows = ((f[..., 1].astype(int) * 7 + f[..., 2] * 3) // 10
                        ).astype(np.uint8)
            elif bits == 16:
                c = (f >> 3).astype(np.uint16)
                rows = ((c[..., 2] << 10) | (c[..., 1] << 5) | c[..., 0]
                        | ((f[..., 0] & 1).astype(np.uint16) << 15))
                rows = rows.astype("<u2").view(np.uint8).reshape(h, 2 * w)
            elif bits == 24:
                rows = f
            else:
                rows = np.concatenate(
                    [f, np.full((h, w, 1), 0x7F, np.uint8)], -1)
            rows = rows.reshape(h, -1)
            rows = np.pad(rows, ((0, 0), (0, -rows.shape[1] % 4)))
            d = np.ascontiguousarray(rows if top_down else rows[::-1]
                                     ).tobytes()
        else:
            raise ValueError(f"no raw layout {layout!r}")
        out.append(d)
    return out


# A BI_RGB colour table of 256 entries (B, G, R, 0)
RAW_PALETTE = bytes(b for i in range(256) for b in (
    (37 * i) & 255, 255 - i, (i * i) & 255, 0))


def raw_file(name: str) -> bytes:
    """A hand-muxed case of RAW_CASES or RAW_CLIPS."""
    mux, tag, layout, opts = {**RAW_CASES, **RAW_CLIPS}[name]
    if name in RAW_CLIPS:
        frames = clip_frames_bgr()[:8]
    else:
        frames = moving_frames(sum(map(ord, name)), RAW_FRAMES,
                               *opts["size"])
    h, w = frames.shape[1:3]
    packets = raw_packets(layout, frames, seed=len(name),
                          bits=opts.get("bits", 24),
                          top_down=opts.get("top_down", False))
    if mux == "mkv":
        return mkv_file(packets, w, h, 25, "V_UNCOMPRESSED",
                        colour_space=tag.encode("latin-1"))
    fourcc = b"\0\0\0\0" if tag == "BI_RGB" else tag.encode()
    return avi_file(packets, w, h, 25, len(packets), fourcc,
                    bits=opts.get("bits", RAW_BITS.get(layout, 24)),
                    top_down=opts.get("top_down", False),
                    extradata=RAW_PALETTE if opts.get("palette") else b"")


def huffyuv_classic_tables() -> tuple[list[list[int]], list[list[int]]]:
    """HuffYUV 1.x's classic tables as csrc/huffyuv_tables.h holds them
    (libavcodec's): (code lengths, codes) of luma and chroma."""
    import re

    with open(os.path.join(os.path.dirname(FIXTURES), os.pardir,
                           "viai_tpu_torch", "csrc", "huffyuv_tables.h")) as f:
        text = f.read()
    tabs = {m.group(1): [int(x) for x in re.findall(r"\d+", m.group(2))]
            for m in re.finditer(r"const uint8_t (\w+)\[\d+\] = \{([^}]*)\}",
                                 text)}
    lens = []
    for name in ("kClassicShiftLuma", "kClassicShiftChroma"):
        bits = "".join(f"{b:08b}" for b in tabs[name])
        out, p = [], 0
        while len(out) < 256:
            rep, val = int(bits[p:p + 3], 2), int(bits[p + 3:p + 8], 2)
            p += 8
            if rep == 0:
                rep, p = int(bits[p:p + 8], 2), p + 8
            out += [val] * rep
        lens.append(out)
    return lens, [tabs["kClassicAddLuma"], tabs["kClassicAddChroma"]]


def _words(bits: list[str]) -> bytes:
    """Bits, padded to 32, as little-endian words read from their top."""
    s = "".join(bits)
    s += "0" * (-len(s) % 32)
    words = [int(s[k:k + 32], 2) for k in range(0, len(s), 32)]
    return struct.pack(f"<{len(words)}I", *words)


def classic_huffyuv(frames: np.ndarray, plane: bool,
                    rgb: bool = False) -> list[bytes]:
    """HuffYUV 1.x packets of BGR frames at 4:2:2 (yuv422p of
    lavc_frame_bytes; even width, at most 288 rows): the left predictor,
    or the plane predictor (`plane`: each row's difference from the row
    above, left-predicted), coded with the classic tables; 32-bit words
    little-endian, each read from its top bit. `rgb`: RGB24 instead,
    bottom-up, left-predicted with G, B − G and R − G coded (the luma
    table for all three)."""
    lens, codes = huffyuv_classic_tables()
    out = []
    for f in frames:
        h, w = f.shape[:2]
        if rgb:
            px = f[::-1].reshape(-1, 3).astype(int)      # bottom-up B, G, R
            bits = [f"{px[0, 2]:08b}{px[0, 1]:08b}{px[0, 0]:08b}00000000"]
            for k in range(1, len(px)):
                db, dg, dr = ((px[k] - px[k - 1]) % 256)
                for r in (dg, (db - dg) % 256, (dr - dg) % 256):
                    bits.append(format(codes[0][r], f"0{lens[0][r]}b"))
            out.append(_words(bits))
            continue
        raw = np.frombuffer(lavc_frame_bytes(f, "yuv422p"), np.uint8)
        y = raw[:h * w].reshape(h, w).astype(int)
        u = raw[h * w:h * w + h * w // 2].reshape(h, w // 2).astype(int)
        v = raw[h * w + h * w // 2:].reshape(h, w // 2).astype(int)
        if plane:                                 # rows less the row above
            for p in (y, u, v):
                p[1:] = (p[1:] - p[:-1]) % 256
        bits = [f"{v[0, 0]:08b}{y[0, 1]:08b}{u[0, 0]:08b}{y[0, 0]:08b}"]
        acc = {"y": y[0, 1], "u": u[0, 0], "v": v[0, 0]}

        def put(key, value, table):
            r = (int(value) - acc[key]) % 256
            acc[key] = int(value)
            bits.append(format(codes[table][r], f"0{lens[table][r]}b"))

        for r in range(h):
            for i in range(1 if r == 0 else 0, w // 2):
                put("y", y[r, 2 * i], 0)
                put("u", u[r, i], 1)
                put("y", y[r, 2 * i + 1], 0)
                put("v", v[r, i], 1)
        out.append(_words(bits))
    return out


def lossless_file(name: str) -> bytes:
    """A case of LOSSLESS_CASES or LOSSLESS_CLIPS muxed here."""
    enc, fmt, opts = {**LOSSLESS_CASES, **LOSSLESS_CLIPS}[name]
    opts = dict(opts)
    if name in LOSSLESS_CLIPS:
        frames = clip_frames_bgr()[:16]
    else:
        frames = moving_frames(sum(map(ord, name)),
                               opts.pop("frames", LOSSLESS_FRAMES),
                               *opts.pop("size", LOSSLESS_SIZE))
    h, w = frames.shape[1:3]
    tag, gradient = opts.pop("tag", None), opts.pop("gradient", False)
    info = {"extradata": b"", "bits": opts.get("bits", 24), "tag": b""}
    if enc == "classic":
        packets = classic_huffyuv(frames, plane=opts["bits"] & 7 == 3,
                                  rgb=fmt == "bgr24")
        tag = "HFYU"
    else:
        packets = lavc_encode(frames, enc, info=info, pixel_format=fmt,
                              **opts)
        tag = tag or {"ffv1": "FFV1", "huffyuv": "HFYU",
                      "ffvhuff": "FFVH"}.get(enc) or info["tag"].decode()
    if gradient:                       # the frame information's prediction
        packets = [p[:-4] + struct.pack("<I", struct.unpack(
            "<I", p[-4:])[0] | 0x200) for p in packets]
    bits = info["bits"] or 24
    mux = name.rsplit("_", 1)[1]
    if mux == "avi":
        return avi_file(packets, w, h, 25, len(packets), tag.encode(),
                        bits=bits, extradata=info["extradata"])
    if enc == "ffv1":
        return mkv_file(packets, w, h, 25, "V_FFV1",
                        codec_private=info["extradata"])
    bih = struct.pack("<IiiHH4sIiiII", 40 + len(info["extradata"]), w, h, 1,
                      bits, tag.encode(), w * h * 3, 0, 0, 0, 0)
    return mkv_file(packets, w, h, 25, "V_MS/VFW/FOURCC",
                    codec_private=bih + info["extradata"])


# MagicYUV's layouts as libavcodec's decoder names them: (the format
# byte, bits a sample, RGB, the chroma shifts, planes coded), and the
# riff tag of each.
MAGY_LAYOUTS = {
    "gbrp": (0x65, 8, True, (0, 0), 3), "gbrap": (0x66, 8, True, (0, 0), 4),
    "yuv444p": (0x67, 8, False, (0, 0), 3),
    "yuv422p": (0x68, 8, False, (1, 0), 3),
    "yuv420p": (0x69, 8, False, (1, 1), 3),
    "yuva444p": (0x6A, 8, False, (0, 0), 4), "gray": (0x6B, 8, False, None, 1),
    "yuv422p10le": (0x6C, 10, False, (1, 0), 3),
    "gbrp10le": (0x6D, 10, True, (0, 0), 3),
    "gbrap10le": (0x6E, 10, True, (0, 0), 4),
    "gbrp12le": (0x6F, 12, True, (0, 0), 3),
    "gbrap12le": (0x70, 12, True, (0, 0), 4),
    "gbrp14le": (0x71, 14, True, (0, 0), 3),
    "gbrap14le": (0x72, 14, True, (0, 0), 4),
    "gray10le": (0x73, 10, False, None, 1),
    "yuv444p10le": (0x76, 10, False, (0, 0), 3),
    "yuv420p10le": (0x7B, 10, False, (1, 1), 3)}
MAGY_TAGS = {"gbrp": "M8RG", "gbrap": "M8RA", "yuv444p": "M8Y4",
             "yuv422p": "M8Y2", "yuv420p": "M8Y0", "yuva444p": "M8YA",
             "gray": "M8G0", "yuv422p10le": "M0Y2", "gbrp10le": "M0RG",
             "gbrap10le": "M0RA", "gbrp12le": "M2RG", "gbrap12le": "M2RA",
             "gbrp14le": "M2RG", "gbrap14le": "M2RA", "gray10le": "M0G0",
             "yuv444p10le": "M0Y4", "yuv420p10le": "M0Y0"}


def magicyuv_planes(frame: np.ndarray, fmt: str) -> list[np.ndarray]:
    """One BGR frame → the planes of MagicYUV layout `fmt` in coded order
    (B, G, R and alpha for RGB; Y, U, V and alpha), as lavc_frame_bytes
    lays the pixel format out."""
    h, w = frame.shape[:2]
    _, bps, rgb, shifts, planes = MAGY_LAYOUTS[fmt]
    raw = np.frombuffer(lavc_frame_bytes(frame, fmt), np.uint8 if bps == 8
                        else "<u2")
    sizes = [(h, w)] * planes
    if shifts and not rgb:
        xs, ys = shifts
        c = (-(-h // (1 << ys)), -(-w // (1 << xs)))
        sizes = [(h, w), c, c] + [(h, w)] * (planes - 3)
    out, at = [], 0
    for ph, pw in sizes:
        out.append(raw[at:at + ph * pw].reshape(ph, pw).astype(np.int64))
        at += ph * pw
    if rgb:                                    # G, B, R → B, G, R
        out[0], out[1] = out[1], out[0]
    return out


def _huffman_lengths(counts: np.ndarray) -> np.ndarray:
    """Huffman code lengths of every symbol (each counted at least once)."""
    import heapq

    heap = [(int(c) + 1, i, [i]) for i, c in enumerate(counts)]
    heapq.heapify(heap)
    lengths = np.zeros(len(counts), np.int64)
    tie = len(counts)
    while len(heap) > 1:
        a, _, sa = heapq.heappop(heap)
        b, _, sb = heapq.heappop(heap)
        lengths[sa + sb] += 1
        heapq.heappush(heap, (a + b, tie, sa + sb))
        tie += 1
    assert lengths.max() <= 32
    return lengths


def magicyuv_packet(frame: np.ndarray, fmt: str, pred: int = 2,
                    slice_height: int | None = None, raw=(),
                    interlaced: bool = False, full_range: bool = False,
                    matrix: int = 0) -> bytes:
    """One MagicYUV packet (version 7) of a BGR frame in layout `fmt`,
    written as libavcodec's decoder reads it: the header (the format
    byte, `matrix`, the flags: 2 `interlaced`, 4 `full_range`), slices
    of `slice_height` rows (default: one), each plane's slices predicted
    by `pred` (1 left, 2 gradient, 3 median, whose gradient term libavcodec
    wraps at 8 bits only; each slice's first line, two when interlaced,
    from the left alone; RGB as B − G, G, R − G) and
    Huffman-coded under per-plane code lengths stored run-length coded,
    or stored raw for the slice numbers in `raw`."""
    h, w = frame.shape[:2]
    code, bps, rgb, shifts, nplanes = MAGY_LAYOUTS[fmt]
    mask = (1 << bps) - 1
    sh = slice_height or h
    nslices = -(-h // sh)
    planes = magicyuv_planes(frame, fmt)
    if rgb:
        planes[0] = (planes[0] - planes[1]) & mask
        planes[2] = (planes[2] - planes[1]) & mask
    step = 2 if interlaced else 1

    def residuals(p: np.ndarray) -> np.ndarray:
        r = np.empty_like(p)
        left = np.concatenate([np.zeros((p.shape[0], 1), np.int64),
                               p[:, :-1]], 1)
        r[:step] = p[:step] - left[:step]
        top, tl = p[:-step], np.concatenate(
            [np.zeros((p.shape[0] - step, 1), np.int64), p[:-step, :-1]], 1)
        cur, lf = p[step:], left[step:]
        if pred == 1:
            guess = lf.copy()
        elif pred == 2:
            guess = lf + top - tl
        else:                  # above 8 bits the gradient is not wrapped
            grad = lf + top - tl if bps > 8 else (lf + top - tl) & mask
            guess = np.maximum(np.minimum(lf, top),
                               np.minimum(np.maximum(lf, top), grad))
        guess[:, 0] = top[:, 0]
        r[step:] = cur - guess
        return r & mask

    coded = []                                 # per plane: slices' residuals
    for i, p in enumerate(planes):
        vs = shifts[1] if shifts and not rgb and i in (1, 2) else 0
        csh = -(-sh // (1 << vs))
        ph = p.shape[0]
        coded.append([residuals(p[j * csh:min((j + 1) * csh, ph)])
                      for j in range(nslices)])
    tables, codes = b"", []
    for sl in coded:
        counts = np.bincount(np.concatenate([r.ravel() for r in sl]),
                             minlength=1 << bps)
        lengths = _huffman_lengths(counts)
        order = sorted(range(1 << bps), key=lambda s: (-lengths[s], s))
        value, nxt = {}, 0
        for sym in order:
            value[sym] = nxt >> (32 - lengths[sym])
            nxt += 1 << (32 - lengths[sym])
        codes.append((lengths, value))
        k = 0
        while k < len(lengths):                # runs of one length
            run = 1
            while (k + run < len(lengths) and run < 256
                   and lengths[k + run] == lengths[k]):
                run += 1
            tables += bytes([lengths[k]]) if run == 1 else bytes(
                [0x80 | lengths[k], run - 1])
            k += run
    bodies = []
    for i, sl in enumerate(coded):
        lengths, value = codes[i]
        for j, r in enumerate(sl):
            if j in raw:
                bits = "".join(format(int(v), f"0{bps}b") for v in r.ravel())
            else:
                bits = "".join(format(value[int(v)], f"0{lengths[int(v)]}b")
                               for v in r.ravel())
            bits += "0" * (-len(bits) % 32)
            bodies.append(bytes([1 if j in raw else 0, pred]) +
                          int(bits or "0", 2).to_bytes(len(bits) // 8, "big")
                          + bytes(4))
    head_len = 36 + 4 * nplanes * nslices + 1 + nplanes * nslices
    first = head_len + len(tables) - 32
    offsets, at = [], first
    for body in bodies:
        offsets.append(at)
        at += len(body)
    flags = (2 if interlaced else 0) | (4 if full_range else 0)
    head = b"MAGY" + struct.pack("<IBBBBB3B4I4x", 32, 7, code, 12, matrix,
                                 flags, 0, 32, 0, w, h, w, sh)
    head += struct.pack(f"<{len(offsets)}I", *offsets)
    head += bytes([nplanes]) + bytes(i for i in range(nplanes)
                                     for _ in range(nslices))
    return head + tables + b"".join(bodies)


def _rac_states() -> tuple[list[int], list[int]]:
    """rangecoder.c's ff_build_rac_states(c, 0.05 · 2^32, 256 − 8): the
    zero and one state transitions FFV1 and Snow use."""
    one_, factor, max_p = 1 << 32, int(0.05 * (1 << 32)), 256 - 8
    zero, one = [0] * 256, [0] * 256
    last_p8, p = 0, one_ // 2
    for _ in range(128):
        p8 = (256 * p + one_ // 2) >> 32
        if p8 <= last_p8:
            p8 = last_p8 + 1
        if last_p8 and last_p8 < 256 and p8 <= max_p:
            one[last_p8] = p8
        p += ((one_ - p) * factor + one_ // 2) >> 32
        last_p8 = p8
    for i in range(256 - max_p, max_p + 1):
        if one[i]:
            continue
        p = (i * one_ + 128) >> 8
        p += ((one_ - p) * factor + one_ // 2) >> 32
        p8 = (256 * p + one_ // 2) >> 32
        p8 = min(max(p8, i + 1), max_p)
        one[i] = p8
    for i in range(1, 255):
        zero[i] = 256 - one[256 - i]
    return zero, one


class RangeWriter:
    """rangecoder.c's encoder (put_rac, renorm_encoder, ff_rac_terminate)
    with _rac_states' transitions; states are (bytearray, index)."""

    ZERO, ONE = _rac_states()

    def __init__(self):
        self.low, self.range = 0, 0xFF00
        self.outstanding_count, self.outstanding_byte = 0, -1
        self.out = bytearray()

    def _renorm(self):
        while self.range < 0x100:
            if self.outstanding_byte < 0:
                self.outstanding_byte = self.low >> 8
            elif self.low <= 0xFF00:
                self.out.append(self.outstanding_byte)
                self.out += b"\xff" * self.outstanding_count
                self.outstanding_count = 0
                self.outstanding_byte = self.low >> 8
            elif self.low >= 0x10000:
                self.out.append(self.outstanding_byte + 1)
                self.out += b"\x00" * self.outstanding_count
                self.outstanding_count = 0
                self.outstanding_byte = (self.low >> 8) - 0x100
            else:
                self.outstanding_count += 1
            self.low = (self.low & 0xFF) << 8
            self.range <<= 8

    def bit(self, st: bytearray, i: int, bit: int):
        r1 = (self.range * st[i]) >> 8
        if not bit:
            self.range -= r1
            st[i] = self.ZERO[st[i]]
        else:
            self.low += self.range - r1
            self.range = r1
            st[i] = self.ONE[st[i]]
        self._renorm()

    def symbol(self, st: bytearray, at: int, v: int, signed: bool):
        """put_symbol, as get_symbol reads it."""
        if not v:
            self.bit(st, at, 1)
            return
        a = abs(v)
        e = a.bit_length() - 1
        self.bit(st, at, 0)
        for i in range(e):
            self.bit(st, at + 1 + min(i, 9), 1)
        self.bit(st, at + 1 + min(e, 9), 0)
        for i in range(e - 1, -1, -1):
            self.bit(st, at + 22 + min(i, 9), (a >> i) & 1)
        if signed:
            self.bit(st, at + 11 + min(e, 10), int(v < 0))

    def symbol2(self, st: bytearray, at: int, v: int, log2: int):
        """put_symbol2 (snow.h's get_symbol2 reads it)."""
        r = 1 << log2 if log2 >= 0 else 1
        while v >= r:
            self.bit(st, at + 4 + log2, 1)
            v -= r
            log2 += 1
            if log2 > 0:
                r += r
        self.bit(st, at + 4 + log2, 0)
        for i in range(log2 - 1, -1, -1):
            self.bit(st, at + 31 - i, (v >> i) & 1)

    def terminate(self) -> bytes:
        self.range = 0xFF
        self.low += 0xFF
        self._renorm()
        self.range = 0xFF
        self._renorm()
        return bytes(self.out)


class SnowWriter:
    """Snow packets written field by field as libavcodec's snow decoder
    reads them, for what libavcodec 59's encoder never writes: a keyframe
    (the header with `colorspace`, `shifts`, `count` decompositions,
    `spatial_scalability`, `max_refs`, `wavelet` 0 9/7 or 1 5/3, `mv_scale`
    and `depth` (block_max_depth); the LL band of each plane given, DPCM
    coded as correlate undoes it, every other band zero; lossless qlog, so
    a plane's samples are 128 + its wavelet's output), then inter frames
    (the half-pel filter's `taps` (htaps and hcoeff, diag_mc) sent where
    given; each block's (intra colour, or vector and reference) chosen by
    a seeded generator; no residual). The context states carry across
    packets as the decoder's do; each packet is padded with 8 zero bytes
    (the decoder takes none of them)."""

    def __init__(self, w: int, h: int):
        self.w, self.h = w, h
        self.header = bytearray(b"\x80" * 32)
        self.block_state = bytearray(b"\x80" * (128 + 32 * 128))
        self.bands = {}
        self.refs_available = 0

    def _band_state(self, key) -> bytearray:
        return self.bands.setdefault(key, bytearray(b"\x80" * (519 * 32)))

    def _plane_size(self, pi: int) -> tuple[int, int]:
        if not pi:
            return self.w, self.h
        xs, ys = self.shifts
        return -(-self.w >> xs), -(-self.h >> ys)

    def _bands_of(self, pi: int) -> dict:
        """(level, orientation) → (width, height)."""
        pw, ph = self._plane_size(pi)
        out = {}
        for level in range(self.count - 1, -1, -1):
            for o in range(0 if level == 0 else 1, 4):
                out[level, o] = ((pw + (not o & 1)) >> 1,
                                 (ph + (not o > 1)) >> 1)
            pw, ph = (pw + 1) >> 1, (ph + 1) >> 1
        return out

    def _code_band(self, rc: RangeWriter, st: bytearray, vals: np.ndarray,
                   parent: np.ndarray | None):
        """unpack_coeffs' coding of a band's coefficients (v-form: 2·|q| +
        sign), contexts from the left, top-left, top, top-right and
        parent."""
        h, w = vals.shape

        def at(a, y, x):
            if a is None or y < 0 or x < 0 or y >= a.shape[0] or \
                    x >= a.shape[1]:
                return 0
            return int(a[y, x])

        q3 = [0, 0] + [1 if i % 2 == 0 else -1 for i in range(2, 256)]
        ctx, zero_pos = [], []
        for y in range(h):
            for x in range(w):
                n = (at(vals, y, x - 1), at(vals, y - 1, x - 1),
                     at(vals, y - 1, x), at(vals, y - 1, x + 1),
                     at(parent, y >> 1, x >> 1))
                ctx.append(n)
                if not any(n):
                    zero_pos.append(int(vals[y, x]))
        runs, run = [], 0
        for v in zero_pos:
            if v:
                runs.append(run)
                run = 0
            else:
                run += 1
        rc.symbol2(st, 30 * 32, len(runs), 0)
        ri = 0
        if runs:
            rc.symbol2(st, 32, runs[0], 3)
            ri = 1
        k = 0
        for y in range(h):
            for x in range(w):
                v = int(vals[y, x])
                l, lt, t, rt, p = ctx[k]
                k += 1
                if l | lt | t | rt | p:
                    c = (3 * (l >> 1) + (lt >> 1) + (t & ~1) + (rt >> 1) +
                         (p >> 1)).bit_length() - 1
                    c = max(c, 0)
                    rc.bit(st, c, int(v != 0))
                    if v:
                        rc.symbol2(st, (c + 2) * 32, (v >> 1) - 1, c - 4)
                        rc.bit(st, 20 + q3[l & 0xFF] + 3 * q3[t & 0xFF], v & 1)
                elif v:
                    if ri < len(runs):
                        rc.symbol2(st, 32, runs[ri], 3)
                        ri += 1
                    rc.symbol2(st, 2 * 32, (v >> 1) - 1, -4)
                    rc.bit(st, 20, v & 1)

    def _deltas(self, rc: RangeWriter, key: bool):
        hs = self.header
        rc.symbol(hs, 0, self.wavelet if key else 0, True)
        rc.symbol(hs, 0, -128 if key else 0, True)            # qlog
        rc.symbol(hs, 0, self.mv_scale if key else 0, True)
        rc.symbol(hs, 0, 0, True)                             # qbias
        rc.symbol(hs, 0, self.depth if key else 0, True)

    def keyframe(self, ll: list[np.ndarray], colorspace: int = 0,
                 shifts=(1, 1), count: int = 2, spatial_scalability: int = 0,
                 max_refs: int = 1, wavelet: int = 1, mv_scale: int = 4,
                 depth: int = 0) -> bytes:
        self.header = bytearray(b"\x80" * 32)
        self.block_state = bytearray(b"\x80" * (128 + 32 * 128))
        self.bands = {}
        self.shifts = (0, 0) if colorspace == 1 else shifts
        self.nb = 1 if colorspace == 1 else 3
        self.count, self.wavelet, self.mv_scale = count, wavelet, mv_scale
        self.depth, self.max_refs = depth, max_refs
        self.taps = [(1, 6, [40, -10, 2, 0])] * 3
        rc, hs = RangeWriter(), self.header
        rc.bit(bytearray(b"\x80"), 0, 1)                    # keyframe
        rc.symbol(hs, 0, 0, False)                          # version
        rc.bit(hs, 0, 0)                                    # always_reduce
        rc.symbol(hs, 0, 0, False)
        rc.symbol(hs, 0, 0, False)
        rc.symbol(hs, 0, count, False)
        rc.symbol(hs, 0, colorspace, False)
        if colorspace == 0:
            rc.symbol(hs, 0, shifts[0], False)
            rc.symbol(hs, 0, shifts[1], False)
        rc.bit(hs, 0, spatial_scalability)
        rc.symbol(hs, 0, max_refs - 1, False)
        for pi in range(min(self.nb, 2)):                   # the qlogs
            for level in range(count):
                for o in range(0 if level == 0 else 1, 4):
                    if o != 2:
                        rc.symbol(hs, 0, 0, True)
        self._deltas(rc, True)
        for pi in range(self.nb):
            sizes = self._bands_of(pi)
            for (level, o), (bw, bh) in sorted(sizes.items()):
                vals = np.zeros((bh, bw), np.int64)
                if (level, o) == (0, 0):
                    band = np.asarray(ll[pi], np.int64)[:bh, :bw]
                    band = np.pad(band, ((0, bh - band.shape[0]),
                                         (0, bw - band.shape[1])), "edge")
                    res = band.copy()              # correlate's inverse
                    for y in range(bh):
                        for x in range(bw):
                            if x and y:
                                a, b = band[y, x - 1], band[y - 1, x]
                                c = a + b - band[y - 1, x - 1]
                                pred = sorted((a, b, c))[1]
                            elif x:
                                pred = band[y, x - 1]
                            elif y:
                                pred = band[y - 1, x]
                            else:
                                pred = 0
                            res[y, x] = band[y, x] - pred
                    vals = 2 * np.abs(res) + (res < 0)
                self._code_band(rc, self._band_state((pi, level, o)), vals,
                                None)
        self.refs_available = 1
        return rc.terminate() + bytes(8)

    def inter(self, seed: int, taps=None, intra: float = 0.1,
              mv: int = 6) -> bytes:
        """An inter frame: `taps` a (diag_mc, htaps, hcoeff) for planes 0
        and 1 (and 2, which copies 1) when sent."""
        rng = np.random.default_rng(seed)
        rc, hs = RangeWriter(), self.header
        rc.bit(bytearray(b"\x80"), 0, 0)                    # not a keyframe
        rc.bit(hs, 0, int(taps is not None))
        if taps is not None:
            for pi in range(min(self.nb, 2)):
                diag, htaps, hcoeff = taps[pi]
                rc.bit(hs, 0, diag)
                rc.symbol(hs, 0, htaps // 2 - 1, False)
                for i in range(htaps // 2, 0, -1):
                    rc.symbol(hs, 0, abs(hcoeff[i]), False)
        rc.bit(hs, 0, 0)                                    # same count
        self._deltas(rc, False)
        refs = min(self.refs_available, self.max_refs)
        bw0, bh0 = -(-self.w // 16), -(-self.h // 16)
        bw = bw0 << self.depth
        blocks = {}
        null = dict(mx=0, my=0, ref=0, color=(128, 128, 128), type=0,
                    level=0)
        scale = [[256 * (i + 1) // (j + 1) for j in range(8)]
                 for i in range(8)]

        def med(a, b, c):
            return sorted((a, b, c))[1]

        def pred_mv(ref, left, top, tr):
            if refs == 1:
                return (med(left["mx"], top["mx"], tr["mx"]),
                        med(left["my"], top["my"], tr["my"]))
            sc = scale[ref]
            f = [lambda n, k=k: (n[k] * sc[n["ref"]] + 128) >> 8
                 for k in ("mx", "my")]
            return (med(f[0](left), f[0](top), f[0](tr)),
                    med(f[1](left), f[1](top), f[1](tr)))

        def log2(v):
            return max(int(v).bit_length() - 1, 0)

        def branch(level, x, y):
            rem = self.depth - level
            index = (x + y * bw) << rem
            trx = (x + 1) << rem
            left = blocks[index - 1] if x else null
            top = blocks[index - bw] if y else null
            tl = blocks[index - bw - 1] if x and y else left
            tr = (blocks[index - bw + (1 << rem)]
                  if y and trx < bw and ((x & 1) == 0 or level == 0) else tl)
            s_ctx = 2 * left["level"] + 2 * top["level"] + tl["level"] + \
                tr["level"]
            if level != self.depth:
                split = int(rng.random() < 0.5)
                rc.bit(self.block_state, 4 + s_ctx, 1 - split)
                if split:
                    for dy in (0, 1):
                        for dx in (0, 1):
                            branch(level + 1, 2 * x + dx, 2 * y + dy)
                    return
            is_intra = rng.random() < intra
            rc.bit(self.block_state, 1 + left["type"] + top["type"],
                   int(is_intra))
            node = dict(level=level, type=int(is_intra), ref=0)
            if is_intra:
                mx, my = pred_mv(0, left, top, tr)
                col = [int(rng.integers(16, 240)) for _ in range(3)]
                for k, at in zip(range(3 if self.nb > 2 else 1),
                                 (32, 64, 96)):
                    rc.symbol(self.block_state, at,
                              col[k] - left["color"][k], True)
                if self.nb <= 2:
                    col[1:] = left["color"][1:]
                node.update(mx=mx, my=my, color=tuple(col))
            else:
                ref = int(rng.integers(refs))
                if refs > 1:
                    ctx = log2(2 * left["ref"]) + log2(2 * top["ref"])
                    rc.symbol(self.block_state, 128 + 1024 + 32 * ctx, ref,
                              False)
                px, py = pred_mv(ref, left, top, tr)
                mx = px + int(rng.integers(-mv, mv + 1))
                my = py + int(rng.integers(-mv, mv + 1))
                mxc = log2(2 * abs(left["mx"] - top["mx"]))
                myc = log2(2 * abs(left["my"] - top["my"]))
                rc.symbol(self.block_state, 128 + 32 * (mxc + 16 * (ref > 0)),
                          mx - px, True)
                rc.symbol(self.block_state, 128 + 32 * (myc + 16 * (ref > 0)),
                          my - py, True)
                node.update(mx=mx, my=my, ref=ref, color=left["color"])
            for j in range(1 << rem):
                for i in range(1 << rem):
                    blocks[index + i + j * bw] = node

        for y in range(bh0):
            for x in range(bw0):
                branch(0, x, y)
        for pi in range(self.nb):
            for key in sorted(self._bands_of(pi)):
                rc.symbol2(self._band_state((pi, *key)), 30 * 32, 0, 0)
        self.refs_available += 1
        return rc.terminate() + bytes(8)


def snow_hand_packets(frames: np.ndarray, key: dict, inter: dict,
                      keyint: int = 0) -> list[bytes]:
    """SnowWriter's packets for `frames`: a keyframe (every `keyint`
    frames when given) whose LL bands hold each frame's planes (BT.601,
    subsampled to its chroma shifts) sampled at the coarsest level, less
    128; inter frames with the options `inter` (each seeded by its index)."""
    h, w = frames.shape[1:3]
    sw = SnowWriter(w, h)
    count = key.get("count", 2)
    shifts = (0, 0) if key.get("colorspace") == 1 else key.get("shifts",
                                                                (1, 1))
    out = []
    for i, f in enumerate(frames):
        if i == 0 or (keyint and i % keyint == 0):
            planes = [p[0].astype(np.int64) for p in _yuv_planes(f[None])]
            ll = []
            for k, pl in enumerate(planes):
                if k and shifts != (0, 0):
                    pl = _subsample(pl[None], *shifts)[0].astype(np.int64)
                ll.append(pl[::1 << count, ::1 << count] - 128)
            out.append(sw.keyframe(ll, **key))
        else:
            out.append(sw.inter(i, **inter))
    return out


def opencv_file(name: str) -> bytes:
    """A case of OPENCV_CASES (not cv2's writer's) muxed here."""
    enc, tag, opts = OPENCV_CASES[name]
    opts = dict(opts)
    frames = moving_frames(sum(map(ord, name)),
                           opts.pop("frames", OPENCV_FRAMES),
                           *opts.pop("size", OPENCV_SIZE))
    noise = opts.pop("noise", 0)
    if noise:
        rng = np.random.default_rng(len(name))
        frames = np.clip(frames.astype(int) + rng.integers(
            -noise, noise + 1, frames.shape), 0, 255).astype(np.uint8)
    h, w = frames.shape[1:3]
    info = {"extradata": b"", "bits": 24}
    if enc == "magyhand":
        fmt = opts.pop("fmt")
        packets = [magicyuv_packet(f, fmt, **opts) for f in frames]
    elif enc == "snowhand":
        packets = snow_hand_packets(frames, **opts)
    else:
        noextra = opts.pop("noextra", False)
        packets = lavc_encode(frames, enc, info=info, **opts)
        if noextra:
            info["extradata"] = b""
    bits = info["bits"] or 24
    if name.endswith("_avi"):
        return avi_file(packets, w, h, 25, len(packets), tag.encode(),
                        bits=bits, extradata=info["extradata"])
    bih = struct.pack("<IiiHH4sIiiII", 40 + len(info["extradata"]), w, h, 1,
                      bits, tag.encode(), w * h * 3, 0, 0, 0, 0)
    return mkv_file(packets, w, h, 25, "V_MS/VFW/FOURCC",
                    codec_private=bih + info["extradata"])


def _bits(data: bytes) -> str:
    return "".join(f"{b:08b}" for b in data)


def _bytes(bits: str) -> bytes:
    bits += "0" * (-len(bits) % 8)
    return bytes(int(bits[i:i + 8], 2) for i in range(0, len(bits), 8))


def legacy_edit(edit: str, packets: list[bytes], extradata: bytes,
                enc: str, w: int, h: int) -> tuple[list[bytes], bytes]:
    """A LEGACY_CASES edit of an H.263-family stream (its packets and
    extradata), bit by bit at the picture headers."""
    kind, _, arg = edit.partition(" ")
    mbw, mbh = (w + 15) // 16, (h + 15) // 16
    out = []
    if kind == "slices" and enc == "wmv2":
        bits = _bits(extradata)                 # the 3-bit slice code
        return packets, _bytes(bits[:22] + f"{int(arg):03b}" + bits[25:])
    for k, p in enumerate(packets):
        bits = _bits(p)
        if kind == "slices" and bits[:2] == "00":
            # v3 / WMV1 I pictures: 2-bit type, 5-bit quantiser, then 0x16
            # plus the number of slices.
            bits = bits[:7] + f"{0x16 + int(arg):05b}" + bits[12:]
        elif kind == "skipmap" and bits[0] == "1":
            # WMV2 P pictures: type, quantiser, then skip type 0 → T and a
            # map that skips nothing.
            t = int(arg)
            skip = {1: "0" * (mbw * mbh), 2: ("0" + "0" * mbw) * mbh,
                    3: ("0" + "0" * mbh) * mbw}[t]
            bits = bits[:6] + f"{t:02b}" + skip + bits[8:]
        elif kind == "skipall" and k in (4, 8):
            assert bits[0] == "1"               # a P picture, skipped
            bits = bits[:6] + "10" + "1" * mbh
        elif kind == "disposable" and k % 2:
            f = int(bits[30:33], 2)             # FLV1's size format
            at = 33 + {0: 16, 1: 32}.get(f, 0)
            assert bits[at:at + 2] == "01"
            bits = bits[:at] + "10" + bits[at + 2:]
        out.append(_bytes(bits))
    return out, extradata


_MSMP4_TABLES: dict = {}


def msmpeg4_tables() -> dict:
    """The arrays of viai_tpu_torch/csrc/msmpeg4_tables.h (read from
    libavcodec's static library), by name, flattened."""
    import re

    if not _MSMP4_TABLES:
        path = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "viai_tpu_torch", "csrc",
            "msmpeg4_tables.h")
        text = open(path).read()
        for m in re.finditer(r"(?:const|constexpr) \w+ (k\w+)(?:\[\d+\])+ = "
                             r"\{([^}]*)\}", text):
            _MSMP4_TABLES[m.group(1)] = [int(v) for v in m.group(2).replace(
                "\n", " ").split(",") if v.strip()]
    return _MSMP4_TABLES


class _BitWriter:
    def __init__(self):
        self.bits = []

    def put(self, n: int, v: int):
        self.bits.append(format(v & ((1 << n) - 1), f"0{n}b") if n else "")

    def code(self, table: list[int], sym: int):
        """(code, length) pair `sym` of a flattened [n][2] table."""
        self.put(table[2 * sym + 1], table[2 * sym])

    def d012(self, v: int):
        self.put(*((1, 0) if v == 0 else (2, 1 + v)))

    def bytes(self) -> bytes:
        return _bytes("".join(self.bits))


def msmpeg4_syntax(variant: str, w: int, h: int, frames: int, seed: int,
                   q: int = 8, gop: int = 100, **modes) -> tuple[list[bytes],
                                                                 bytes]:
    """Random but valid MS-MPEG4 v3 ("v3"), WMV1 or WMV2 pictures of
    (w, h), `frames` of them (an I picture every `gop`), written symbol by
    symbol with the tables of csrc/msmpeg4_tables.h: every macroblock
    type, coded block pattern, DC difference (escapes too), vector
    (escapes too) and coefficient a seeded generator picks, each
    coefficient by a plain code, the first, second or third escape. What
    libavcodec 59's encoders never write is chosen per picture here: the
    run-level, DC and vector tables (`tables`: fixed (rl, rl_chroma, dc,
    mv), else random), `slices`, the skip code, WMV1's per-macroblock
    tables (`bitrate` over 50 kbit/s) and inter-intra prediction
    (`bitrate` up to 128 kbit/s), WMV2's extradata flags (`mspel`,
    `abt`, `top_left`, `per_mb_rl`, `loop`), skip maps (random partial
    maps of the four types) and ABT block types. → (packets, WMV2's
    extradata)."""
    rng = np.random.default_rng(seed)
    T = msmpeg4_tables()
    mbw, mbh = (w + 15) // 16, (h + 15) // 16
    wmv = variant in ("wmv1", "wmv2")
    bitrate = modes.get("bitrate", 200 * 1024)
    flags = {k: modes.get(k, 1) for k in ("mspel", "abt", "top_left",
                                          "per_mb_rl")}
    loop = modes.get("loop", 0)
    slices = modes.get("slices", 1)
    extradata = b""
    if variant == "wmv2":
        x = _BitWriter()
        x.put(5, 25)
        x.put(11, bitrate // 1024)
        for k in ("mspel",):
            x.put(1, flags[k])
        x.put(1, loop)
        x.put(1, flags["abt"])
        x.put(1, 1)                                   # j_type_bit
        x.put(1, flags["top_left"])
        x.put(1, flags["per_mb_rl"])
        x.put(3, slices)
        extradata = x.bytes()[:4]
    rl_tabs = [(T[f"kRl{k}Vlc"], T[f"kRl{k}Run"], T[f"kRl{k}Level"],
                T["kRlN"][k], T["kRlLast"][k]) for k in range(6)]

    def maxes(k):
        _, run, level, n, last = rl_tabs[k]
        ml = [[0] * 65 for _ in range(2)]
        mr = [[0] * 65 for _ in range(2)]
        for i in range(n):
            lst = int(i >= last)
            ml[lst][run[i]] = max(ml[lst][run[i]], level[i])
            mr[lst][level[i]] = max(mr[lst][level[i]], run[i])
        return ml, mr

    rl_max = [maxes(k) for k in range(6)]
    packets = []
    mvs = np.zeros((mbh, mbw, 2), int)          # WMV2's vector prediction
    for f in range(frames):
        b = _BitWriter()
        intra_pic = f % gop == 0
        tab = modes.get("tables") or (int(rng.integers(3)),
                                      int(rng.integers(3)),
                                      int(rng.integers(2)),
                                      int(rng.integers(2)))
        rl, rlc, dc_t, mv_t = tab
        per_mb_rl = False
        inter_intra = False
        use_skip = bool(rng.integers(2))
        skip = np.zeros((mbh, mbw), bool)
        cbp_t, mspel, per_mb_abt, abt_type = 3, 0, 0, 0
        if variant == "wmv2":
            b.put(1, 0 if intra_pic else 1)
            if intra_pic:
                b.put(7, 0)
            b.put(5, q)
            if intra_pic:
                b.put(1, 0)                           # j_type
                per_mb_rl = bool(flags["per_mb_rl"] and rng.integers(2))
                if flags["per_mb_rl"]:
                    b.put(1, per_mb_rl)
                if not per_mb_rl:
                    b.d012(rlc)
                    b.d012(rl)
                b.put(1, dc_t)
            else:
                stype = int(rng.integers(4))
                b.put(2, stype)
                if stype:
                    skip = rng.random((mbh, mbw)) < 0.3
                    if stype == 2:
                        skip[rng.random(mbh) < 0.2] = True
                    if stype == 3:
                        skip[:, rng.random(mbw) < 0.2] = True
                    skip[int(rng.integers(mbh)), int(rng.integers(mbw))] = \
                        False                  # a picture, not FRAME_SKIPPED
                    lines = {1: [skip.ravel()], 2: list(skip),
                             3: list(skip.T)}[stype]
                    for line in lines:
                        if stype > 1 and line.all():
                            b.put(1, 1)
                            continue
                        if stype > 1:
                            b.put(1, 0)
                        for v in line:
                            b.put(1, int(v))
                ci = int(rng.integers(3))
                b.d012(ci)
                cbp_t = [[0, 2, 1], [1, 0, 2], [2, 1, 0]][
                    (q > 10) + (q > 20)][ci]
                if flags["mspel"]:
                    mspel = int(rng.integers(2))
                    b.put(1, mspel)
                if flags["abt"]:
                    per_mb_abt = int(rng.integers(2))
                    b.put(1, per_mb_abt ^ 1)
                    if not per_mb_abt:
                        abt_type = int(rng.integers(3))
                        b.d012(abt_type)
                per_mb_rl = bool(flags["per_mb_rl"] and rng.integers(2))
                if flags["per_mb_rl"]:
                    b.put(1, per_mb_rl)
                if not per_mb_rl:
                    b.d012(rl)
                    rlc = rl
                b.put(1, dc_t)
                b.put(1, mv_t)
        else:
            b.put(2, 0 if intra_pic else 1)
            b.put(5, q)
            if intra_pic:
                b.put(5, 0x16 + slices)
                if variant == "v3":
                    b.d012(rlc)
                    b.d012(rl)
                else:
                    b.put(5, 25)
                    b.put(11, bitrate // 1024)
                    b.put(1, 1)                       # flip-flop rounding
                    if bitrate > 50 * 1024:
                        per_mb_rl = bool(rng.integers(2))
                        b.put(1, per_mb_rl)
                    if not per_mb_rl:
                        b.d012(rlc)
                        b.d012(rl)
                b.put(1, dc_t)
            else:
                b.put(1, use_skip)
                if variant == "wmv1" and bitrate > 50 * 1024:
                    per_mb_rl = bool(rng.integers(2))
                    b.put(1, per_mb_rl)
                if not per_mb_rl:
                    b.d012(rl)
                    rlc = rl
                b.put(1, dc_t)
                b.put(1, mv_t)
                inter_intra = (variant == "wmv1" and w * h < 320 * 240
                               and bitrate <= 128 * 1024)
        esc3 = {}                                     # WMV's lengths
        coded = np.zeros((2 * mbh + 1, 2 * mbw + 2), int)

        def coefficients(k: int, start: int, limit: int = 64):
            """One coded block's coefficients of run-level table k: at
            least one, positions from `start` below `limit` (a coefficient
            that is not the last below limit − 1: libavcodec ends a block
            at 63 otherwise)."""
            vlc, run, level, n, last = rl_tabs[k]
            ml, mr = rl_max[k]
            run_diff = 1 if wmv else (0 if start == 1 else 1)
            i = start - 1

            def esc3_code(final: bool, r: int, lvl: int):
                b.code(vlc, n)
                b.put(2, 0)
                b.put(1, int(final))
                if not wmv:
                    b.put(6, r)
                    b.put(8, lvl)
                    return
                if not esc3:
                    ll = int(rng.integers(6, 9))
                    rl_len = int(rng.integers(3, 7))
                    if q < 8:
                        b.put(3, ll if ll < 8 else 0)
                        if ll >= 8:
                            b.put(1, ll - 8)
                    else:
                        b.put(ll - 2, 0)
                        if ll < 8:
                            b.put(1, 1)
                    b.put(2, rl_len - 3)
                    esc3.update(ll=ll, run=rl_len)
                b.put(esc3["run"], r)
                b.put(1, int(lvl < 0))
                b.put(esc3["ll"], abs(lvl))

            # |level| · 2q + q at most 400: no row of the IDCT leaves 16
            # bits (cv2's SSE2 simple IDCT saturates there, libavcodec's C
            # one, which the port copies, wraps; encoders stay far below)
            top = max(1, (400 - q) // (2 * q))
            count = int(rng.integers(1, 8))
            for c in range(count):
                final = c == count - 1
                room = limit - (0 if final else 1)   # positions below it
                for _ in range(32):
                    mode = int(rng.choice(4, p=[0.55, 0.15, 0.15, 0.15]))
                    if mode == 3:
                        r = int(rng.integers(0, 4))
                        if i + r + 1 >= room:
                            continue
                        esc3_code(final, r, int(rng.integers(1, top + 1)) * (
                            1 if rng.integers(2) else -1))
                        i += r + 1
                        break
                    sym = int(rng.integers(n))
                    lst = int(sym >= last)
                    if lst != int(final) or level[sym] + (
                            ml[lst][run[sym]] if mode == 1 else 0) > top:
                        continue
                    adv = run[sym] + 1 + (mr[lst][level[sym]] + run_diff
                                          if mode == 2 else 0)
                    if i + adv >= room:
                        continue
                    b.code(vlc, n) if mode else None
                    if mode == 1:
                        b.put(1, 1)
                    elif mode == 2:
                        b.put(2, 1)
                    b.code(vlc, sym)
                    b.put(1, int(rng.integers(2)))
                    i += adv
                    break
                else:
                    # nothing else fits: end the block at the next position
                    esc3_code(True, 0, 1)
                    return

        # The DC predictors (level · scale; 1024 outside the picture and
        # where no intra block is), as ff_msmpeg4_pred_dc reads them, so
        # that each block's DC level stays in the picture's range.
        dcs = [np.full((2 * mbh + 1, 2 * mbw + 2), 1024),
               np.full((mbh + 1, mbw + 2), 1024),
               np.full((mbh + 1, mbw + 2), 1024)]
        qs = min(max(q, 1), 31)
        if variant == "v3":
            scales = (T["kOldYDcScale"][qs], T["kWmv1CDcScale"][qs])
        else:
            scales = (T["kWmv1YDcScale"][qs], T["kWmv1CDcScale"][qs])
        at = {}

        def dc(n: int, mx: int, my: int, first_line: bool, free: bool):
            """Block n's DC difference: a level near its prediction (now
            and then far from it, through the escape); 0 under
            inter-intra prediction (`free` False), whose prediction from
            decoded pixels is not simulated here."""
            tabdc = T[f"kDc{'Lum' if n < 4 else 'Chroma'}{dc_t}"]
            scale = scales[n >= 4]
            arr = dcs[0 if n < 4 else n - 3]
            y, x = ((2 * my + (n >> 1) + 1, 2 * mx + (n & 1) + 1) if n < 4
                    else (my + 1, mx + 1))
            a, bb, c = arr[y, x - 1], arr[y - 1, x - 1], arr[y - 1, x]
            if first_line and not n & 2 and not wmv:
                bb = c = 1024
            a, bb, c = ((v + (scale >> 1)) // scale for v in (a, bb, c))
            if wmv:
                pred = c if abs(a - bb) < abs(bb - c) else a
            else:
                pred = c if abs(a - bb) <= abs(bb - c) else a
            v = 0
            if free:
                top = 2000 // scale
                target = int(rng.integers(1, top)) if rng.random() < 0.1 \
                    else min(max(pred + int(rng.integers(-8, 9)), 1), top)
                v = target - pred
            arr[y, x] = (pred + v) * scale
            a_ = abs(v)
            if a_ >= 119:
                b.code(tabdc, 119)
                b.put(8, a_)
                b.put(1, int(v < 0))
            else:
                b.code(tabdc, a_)
                if a_:
                    b.put(1, int(v < 0))

        def no_intra(mx: int, my: int):
            """ff_clean_intra_table_entries: a macroblock not intra."""
            dcs[0][2 * my + 1:2 * my + 3, 2 * mx + 1:2 * mx + 3] = 1024
            dcs[1][my + 1, mx + 1] = dcs[2][my + 1, mx + 1] = 1024

        def intra_blocks(cbp: int, k_l: int, k_c: int, mx: int, my: int,
                         first_line: bool, free: bool = True):
            for n in range(6):
                dc(n, mx, my, first_line, free)
                if (cbp >> (5 - n)) & 1:
                    coefficients(k_l if n < 4 else 3 + k_c, 1)

        mb_rl = rl
        for my in range(mbh):
            first_line = my % max(1, mbh // slices) == 0
            for mx in range(mbw):
                if intra_pic:
                    sym = int(rng.integers(64))
                    b.code(T["kMbI"], sym)
                    cbp = 0
                    for n in range(6):
                        val = (sym >> (5 - n)) & 1
                        if n < 4:
                            y, x = 2 * my + (n >> 1) + 1, 2 * mx + (n & 1) + 1
                            a, bb, c = coded[y, x - 1], coded[y - 1, x - 1], \
                                coded[y - 1, x]
                            val ^= a if bb == c else c
                            coded[y, x] = val
                        cbp |= val << (5 - n)
                    b.put(1, int(rng.random() < 0.2))   # ac_pred
                    if per_mb_rl and cbp:
                        mb_rl = int(rng.integers(3))
                        b.d012(mb_rl)
                    intra_blocks(cbp, mb_rl if per_mb_rl else rl,
                                 mb_rl if per_mb_rl else rlc, mx, my,
                                 first_line)
                    mvs[my, mx] = 0
                    continue
                if variant == "wmv2" and skip[my, mx]:
                    mvs[my, mx] = 0
                    no_intra(mx, my)
                    continue
                if variant != "wmv2" and use_skip:
                    if rng.random() < 0.2:
                        b.put(1, 1)
                        no_intra(mx, my)
                        mvs[my, mx] = 0
                        continue
                    b.put(1, 0)
                zero = np.zeros(2, int)
                A = mvs[my, mx - 1] if mx else zero
                B = mvs[my - 1, mx] if my else zero
                C = mvs[my - 1, mx + 1] if my and mx + 1 < mbw else zero
                t_left = 2
                if variant == "wmv2":
                    # wmv2_pred_motion, with its top-left choice
                    d_tl = 0
                    if mx and not first_line and not mspel and \
                            flags["top_left"]:
                        d_tl = max(abs(A - B))
                    t_left = int(rng.integers(2)) if d_tl >= 8 else 2
                    pred = A if t_left == 0 else B if t_left == 1 else \
                        A if first_line else np.median([A, B, C], axis=0)
                else:                        # ff_h263_pred_motion
                    pred = A if first_line else np.median([A, B, C], axis=0)
                pred = [int(v) for v in pred]
                # a vector whose blocks stay inside the picture (1 sample
                # from its edges; libavcodec's reads past them depend on
                # its buffers' padding), reached from the prediction
                target = []
                for k, (pos, size) in enumerate(((mx, mbw), (my, mbh))):
                    lo = max(2 * (1 - 16 * pos), -63)
                    hi = min(2 * (16 * size - 18 - 16 * pos) + 1, 63)
                    opts = [v for v in range(pred[k] - 32, pred[k] + 32)
                            if lo <= v <= hi]
                    target.append(int(rng.choice(opts)) if opts else None)
                sym = int(rng.integers(128))
                if None in target:
                    sym &= 63                # intra: no vector to reach
                b.code(T[f"kMbNonIntra{cbp_t}"], sym)
                cbp, intra = sym & 63, not sym & 64
                if intra:
                    b.put(1, int(rng.random() < 0.2))   # ac_pred
                    if inter_intra:
                        b.code(T["kInterIntra"], int(rng.integers(4)))
                    if per_mb_rl and cbp:
                        mb_rl = int(rng.integers(3))
                        b.d012(mb_rl)
                    k = mb_rl if per_mb_rl else rl
                    intra_blocks(cbp, k, k, mx, my, first_line,
                                 not inter_intra)
                    mvs[my, mx] = 0
                    continue
                no_intra(mx, my)
                if variant == "wmv2":
                    if t_left < 2:
                        b.put(1, t_left)
                    if cbp:
                        if per_mb_rl:
                            mb_rl = int(rng.integers(3))
                            b.d012(mb_rl)
                        per_block = False
                        if flags["abt"] and per_mb_abt:
                            per_block = bool(rng.integers(2))
                            b.put(1, int(per_block))
                            if not per_block:
                                abt_type = int(rng.integers(3))
                                b.d012(abt_type)
                elif variant != "wmv2" and per_mb_rl and cbp:
                    mb_rl = int(rng.integers(3))
                    b.d012(mb_rl)
                dx, dy = target[0] - pred[0] + 32, target[1] - pred[1] + 32
                codes = [i for i in range(1099) if T[f"kMv{mv_t}X"][i] == dx
                         and T[f"kMv{mv_t}Y"][i] == dy]
                if codes and rng.random() < 0.9:
                    b.put(T[f"kMv{mv_t}Bits"][codes[0]],
                          T[f"kMv{mv_t}Code"][codes[0]])
                else:
                    b.put(T[f"kMv{mv_t}Bits"][1099], T[f"kMv{mv_t}Code"][1099])
                    b.put(6, dx)
                    b.put(6, dy)
                mvx, mvy = target
                mvs[my, mx] = (mvx, mvy)
                if variant == "wmv2" and mspel and (mvx | mvy) & 1:
                    b.put(1, int(rng.integers(2)))      # hshift
                k = mb_rl if per_mb_rl else rl
                for n in range(6):
                    if not (cbp >> (5 - n)) & 1:
                        continue
                    if variant == "wmv2" and flags["abt"]:
                        if per_mb_abt and per_block:
                            abt_type = int(rng.integers(3))
                            b.d012(abt_type)
                        if abt_type:
                            sub = int(rng.integers(3))
                            b.d012(sub)
                            for part in (1, 2):
                                if [2, 3, 1][sub] & part:
                                    coefficients(3 + k, 0, 32)
                            continue
                    coefficients(3 + k, 0)
        if intra_pic and variant == "v3":
            b.put(5, 25)
            b.put(11, bitrate // 1024)
            b.put(1, 1)                               # flip-flop rounding
        packets.append(b.bytes())
    return packets, extradata


def legacy_file(name: str) -> bytes:
    """A case of LEGACY_CASES or LEGACY_CLIPS muxed here."""
    enc, tag, opts = {**LEGACY_CASES, **LEGACY_CLIPS}[name]
    opts = dict(opts)
    if name in LEGACY_CLIPS:
        frames = clip_frames_bgr()[:16]
    else:
        frames = moving_frames(sum(map(ord, name)),
                               opts.pop("frames", LEGACY_FRAMES),
                               *opts.pop("size", LEGACY_SIZE))
    noise = opts.pop("noise", 0)
    if opts.pop("saturate", False):
        frames = np.where(frames > 128, 255, 0).astype(np.uint8)
    if enc == "syntax":
        h, w = frames.shape[1:3]
        packets, extra = msmpeg4_syntax(
            opts.pop("variant"), w, h, len(frames), sum(map(ord, name)),
            gop=4, **opts)
        if name.endswith("_avi"):
            return avi_file(packets, w, h, 25, len(packets), tag.encode(),
                            extradata=extra)
        bih = struct.pack("<IiiHH4sIiiII", 40 + len(extra), w, h, 1, 24,
                          tag.encode(), w * h * 3, 0, 0, 0, 0)
        return mkv_file(packets, w, h, 25, "V_MS/VFW/FOURCC",
                        codec_private=bih + extra)
    if noise:
        rng = np.random.default_rng(len(name))
        frames = np.clip(frames.astype(int) + rng.integers(
            -noise, noise + 1, frames.shape), 0, 255).astype(np.uint8)
    edit, v3id = opts.pop("edit", None), opts.pop("v3id", False)
    h, w = frames.shape[1:3]
    info = {"extradata": b""}
    packets = lavc_encode(frames, enc, info=info, **opts)
    extra = info["extradata"]
    if edit:
        packets, extra = legacy_edit(edit, packets, extra, enc, w, h)
    if name.endswith("_avi"):
        return avi_file(packets, w, h, 25, len(packets), tag.encode(),
                        extradata=extra)
    if v3id:
        return mkv_file(packets, w, h, 25, "V_MPEG4/MS/V3")
    bih = struct.pack("<IiiHH4sIiiII", 40 + len(extra), w, h, 1, 24,
                      tag.encode(), w * h * 3, 0, 0, 0, 0)
    return mkv_file(packets, w, h, 25, "V_MS/VFW/FOURCC",
                    codec_private=bih + extra)


def d263_box() -> bytes:
    """3GPP's H263SpecificBox as ffmpeg's muxer writes it: vendor,
    decoder version, level 10, profile 0."""
    return _box(b"d263", b"FFMP", bytes([0, 10, 0]))


def h263_picture_end(bits: str) -> int:
    """The bit after an H.263+ I picture's header (PQUANT and PEI; no CPM,
    no slices)."""
    assert bits[35:38] == "111" and bits[38:41] == "001"
    fmt, pcf, umv = int(bits[41:44], 2), bits[44] == "1", bits[45] == "1"
    assert bits[50] == "0" and bits[68] == "0"       # no slices, no CPM
    pos = 69 + (23 if fmt == 6 else 0) + (8 if pcf else 0) + (2 if pcf
                                                              else 0)
    if umv:
        pos += 1 if bits[pos] == "1" else 2
    pos += 5
    while bits[pos] == "1":
        pos += 9
    return pos + 1


def _vlc(pairs: list[int]) -> dict:
    return {(pairs[2 * i + 1], pairs[2 * i]): i for i in range(len(pairs) // 2)
            if pairs[2 * i + 1]}


def _read(bits: str, pos: int, table: dict) -> tuple[int, int]:
    for n in range(1, 17):
        sym = table.get((n, int(bits[pos:pos + n] or "0", 2)))
        if sym is not None:
            return sym, pos + n
    raise ValueError(f"no code at bit {pos}")


def h263_intra_mbs(bits: str, mbs: int,
                   escapes: list | None = None) -> list[tuple[int, int, int,
                                                             int]]:
    """The macroblocks of an H.263+ I picture with Annex I (and no GOB or
    slice headers): each one's MCBPC (start, end), its MCBPC symbol and
    the bit after its CBPY (where DQUANT goes); `escapes`, when given,
    gets each escape's level (−128: Annex T's extended escape)."""
    t = msmpeg4_tables()
    mcbpc = {(t["kIntraMcbpcBits"][i], t["kIntraMcbpcCode"][i]): i
             for i in range(9)}
    cbpy, aic = _vlc(t["kCbpyTab"]), _vlc(t["kAicVlc"])
    pos, out = h263_picture_end(bits), []
    for _ in range(mbs):
        while True:
            start = pos
            cbpc, pos = _read(bits, pos, mcbpc)
            if cbpc != 8:
                break
        end = pos
        pos += 2 if bits[pos] == "1" else 1          # AC prediction, dir
        y, pos = _read(bits, pos, cbpy)
        after = pos
        if cbpc & 4:
            pos += 2 if bits[pos] == "1" else 6
        cbp = (cbpc & 3) | (y << 2)
        for n in range(6):
            if not (cbp >> (5 - n)) & 1:
                continue
            while True:
                sym, pos = _read(bits, pos, aic)
                if sym == 102:                        # the escape
                    last = bits[pos] == "1"
                    level = int(bits[pos + 7:pos + 15], 2)
                    pos += 15 + (11 if level == 128 else 0)
                    if escapes is not None:
                        escapes.append(level - 256 if level > 127 else level)
                else:
                    last = sym >= 58
                    pos += 1
                if last:
                    break
        out.append((start, end, cbpc, after))
    return out


def itu_edit(edit: str, packets: list[bytes], w: int,
             h: int) -> list[bytes]:
    """An ITU_CASES edit of an H.263 stream, bit by bit at the picture
    headers (and, for "mq", at the I pictures' macroblocks)."""
    out = []
    t = msmpeg4_tables()
    for p in packets:
        bits = _bits(p)
        if edit == "longvec":                         # baseline's PTYPE
            assert bits[35:38] != "111"
            bits = bits[:39] + "1" + bits[40:]
        elif edit == "ufep0" and bits[59:62] == "001":
            # a P picture: OPPTYPE and the clock (CPCFC) dropped
            assert bits[38:41] == "001" and bits[41:44] != "110"
            assert bits[44] == "1" and bits[45] == "0" and bits[50] == "0"
            bits = bits[:38] + "000" + bits[59:69] + bits[77:]
        elif edit == "mq" and bits[59:62] == "000":
            mbs = h263_intra_mbs(bits, ((w + 15) // 16) * ((h + 15) // 16))
            # steps up and down and absolute quantisers near the
            # picture's 10 (the levels stay in the IDCT's range), chroma
            # at Annex T's quantisers
            forms = ["11", "10", "0" + f"{14:05b}", "10", "0" + f"{9:05b}"]
            picked = [m for m in mbs[3::7] if m[2] < 4]
            for k, (start, end, cbpc, after) in reversed(list(enumerate(
                    picked))):
                code = t["kIntraMcbpcCode"][cbpc + 4]
                length = t["kIntraMcbpcBits"][cbpc + 4]
                bits = (bits[:start] + f"{code:0{length}b}" + bits[end:after]
                        + forms[k % len(forms)] + bits[after:])
        out.append(_bytes(bits))
    return out


def itu_file(name: str) -> bytes:
    """A case of ITU_CASES or ITU_CLIPS muxed here."""
    enc, tag, opts = {**ITU_CASES, **ITU_CLIPS}[name]
    opts = dict(opts)
    size = opts.pop("size", None)
    if name in ITU_CLIPS:
        import cv2

        frames = clip_frames_bgr()[:16]
        if size:
            frames = np.stack([cv2.resize(f, size[::-1],
                                          interpolation=cv2.INTER_AREA)
                               for f in frames])
    else:
        frames = moving_frames(sum(map(ord, name)),
                               opts.pop("frames", ITU_FRAMES),
                               *(size or (144, 176)))
    noise = opts.pop("noise", 0)
    if noise:
        rng = np.random.default_rng(len(name))
        frames = np.clip(frames.astype(int) + rng.integers(
            -noise, noise + 1, frames.shape), 0, 255).astype(np.uint8)
    edit, d263 = opts.pop("edit", None), opts.pop("d263", False)
    h, w = frames.shape[1:3]
    packets = lavc_encode(frames, enc, **opts)
    if edit:
        packets = itu_edit(edit, packets, w, h)
    if name.endswith("_avi"):
        return avi_file(packets, w, h, 25, len(packets), tag.encode())
    if name.endswith("_mp4"):
        return mp4_file(packets, w, h, 25, tag.encode(),
                        d263_box() if d263 else b"")
    bih = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 24, tag.encode(),
                      w * h * 3, 0, 0, 0, 0)
    return mkv_file(packets, w, h, 25, "V_MS/VFW/FOURCC", codec_private=bih)


def lzo1x_compress(data: bytes) -> bytes:
    """An LZO1X stream of `data`, as libavutil's av_lzo1x_decode reads it:
    greedy matches of 3 bytes or more at most 16384 back (M3
    instructions, up to 3 literals after each in its state bits), runs of
    4 literals or more between them (the first run of up to 238 in its
    short form), then the end marker."""
    n, pos, start = len(data), 0, 0
    table: dict[bytes, int] = {}
    tokens: list[tuple[bytes, tuple[int, int] | None]] = []
    while pos + 3 <= n:
        key = data[pos:pos + 3]
        cand = table.get(key)
        table[key] = pos
        if cand is None or pos - cand > 16384 or pos == 0:
            pos += 1
            continue
        length = 3
        while pos + length < n and length < 1000 and \
                data[cand + length] == data[pos + length]:
            length += 1
        tokens.append((data[start:pos], (pos - cand, length)))
        for k in range(pos + 1, min(pos + length, n - 2)):
            table[data[k:k + 3]] = k
        pos += length
        start = pos
    tokens.append((data[start:], None))

    def length_bytes(cnt: int, mask: int, base: int) -> bytes:
        if cnt <= mask:
            return bytes([base | cnt])
        rest, out = cnt - mask, bytearray([base])
        while rest > 255:
            out.append(0)
            rest -= 255
        return bytes(out + bytes([rest]))

    out = bytearray()
    state_at = -1                      # the last match's state byte
    for i, (lits, match) in enumerate(tokens):
        if i == 0 and 0 < len(lits) <= 238:
            out.append(len(lits) + 17)
        elif 0 < len(lits) <= 3 and i:
            out[state_at] |= len(lits)
        elif lits:
            out += length_bytes(len(lits) - 3, 15, 0)
        out += lits
        if match is None:
            out += b"\x11\x00\x00"
            break
        back, length = match
        out += length_bytes(length - 2, 31, 32)
        state_at = len(out)
        out += bytes([((back - 1) & 63) << 2, (back - 1) >> 6])
    return bytes(out)


def _muxer_encodings(spec: dict, packets: list[bytes],
                     private: bytes) -> list[dict]:
    """mkv_file's content encodings for MUXER_CASES' `enc`."""
    kind = spec.get("enc", "")
    scope = 3 if "priv" in kind and private else 1
    if kind.startswith("strip"):
        head = packets[0]
        for p in packets[1:]:
            while not p.startswith(head):
                head = head[:-1]
        return [dict(algo=3, settings=head[:4], scope=scope)]
    if kind.startswith("zlib"):
        return [dict(algo=0, scope=scope)]
    return [dict(algo=2, scope=scope)]


def muxer_stream(spec: dict, frames: np.ndarray):
    """A MUXER_CASES stream of `frames` (BGR): (packets in decode order,
    their (pts, dts) in frames, keyframes, (w, h), the Matroska CodecID,
    its CodecPrivate, the MP4 sample entry and its boxes)."""
    kind = spec["stream"]
    h, w = frames.shape[1:3]
    fps = spec.get("fps", 25)
    plain = [(i, i) for i in range(len(frames))]
    if kind in ("h264", "h264gbr"):
        if kind == "h264gbr":
            import cv2

            aus = []
            for k, (sh, sw) in enumerate(spec["sizes"]):
                at = 8 * k - 4 * (k > 1)          # 8 frames, then 4 each
                part = [cv2.resize(f, (sw, sh), interpolation=cv2.INTER_AREA)
                        for f in frames[at:at + (8 if k == 0 else 4)]]
                aus += [(a, p + at, d + at) for a, p, d in x264_encode(
                    np.stack(part), csp=14, profile="high444", bframes=0,
                    keyint=8)]
            h, w = spec["sizes"][0]
        else:
            aus = x264_encode(frames, fps=str(fps), keyint=8)
        packets = [a for a, _, _ in aus]
        if spec.get("vui") is False:
            packets = strip_vui(packets)
        samples, sps, pps = avc_samples(packets)
        keys = [i for i, a in enumerate(packets)
                if any(u[0] & 31 == 5 for u in nal_units(a))]
        box = avcc_box(sps, pps)
        return (packets if kind == "h264gbr" else samples), \
            [(p, d) for _, p, d in aus], keys, (w, h), "V_MPEG4/ISO/AVC", \
            box[8:], b"avc1", box
    if kind == "hevc":
        aus = hevc_stream(dict(params=spec.get(
            "params", "keyint=8:min-keyint=8"), fps=fps), frames)
        sets, samples, keys = {}, [], []
        for i, (au, _, _) in enumerate(aus):
            sample = b""
            for u in nal_units(au):
                t = hevc_type(u)
                if 32 <= t <= 34:
                    sets.setdefault(t, u)
                    continue
                if 16 <= t <= 23 and (not keys or keys[-1] != i):
                    keys.append(i)
                sample += struct.pack(">I", len(u)) + u
            samples.append(sample)
        hvcc = hvcc_box(sets[32], sets[33], sets[34])
        return samples, [(p, d) for _, p, d in aus], keys, (w, h), \
            "V_MPEGH/ISO/HEVC", hvcc[8:], b"hvc1", hvcc
    if kind in ("mpeg4", "mpeg2", "mpeg1"):
        times: list = []
        enc = {"mpeg4": "mpeg4", "mpeg2": "mpeg2video",
               "mpeg1": "mpeg1video"}[kind]
        packets = lavc_encode(frames, enc, fps=fps, times=times,
                              bf=spec.get("bf", 2), g=8,
                              **({"strict": "-1"} if kind == "mpeg1" else {}))
        if kind == "mpeg4":
            keys = [i for i, p in enumerate(packets)
                    if (p[p.index(b"\0\0\1\xb6") + 4] >> 6) == 0]
            config = mpeg4_headers(packets[0])
            return packets, times, keys, (w, h), "V_MPEG4/ISO/ASP", config, \
                b"mp4v", esds_box(config)
        keys = [i for i, p in enumerate(packets) if b"\0\0\1\xb3" in p]
        return packets, times, keys, (w, h), \
            "V_MPEG2" if kind == "mpeg2" else "V_MPEG1", \
            mpeg12_config(packets[0]), b"mp4v", b""
    if kind == "vp8":
        packets, keys, (w, h), _, _ = container_packets("vp8")
        return packets, [(i, i) for i in range(len(packets))], keys, \
            (w, h), "V_VP8", b"", b"vp08", vpcc_box()
    every = list(range(len(frames)))
    if kind == "mjpeg":
        layout = spec["layout"]
        if layout == "4:1:1":
            import cv2

            packets = [cv2.imencode(".jpg", f, [
                cv2.IMWRITE_JPEG_QUALITY, 80,
                cv2.IMWRITE_JPEG_SAMPLING_FACTOR, 0x411111])[1].tobytes()
                for f in frames]
        elif layout.startswith("fields"):
            sub = 1 if layout.endswith("4:2:2") else 2

            def avi1(jpeg: bytes) -> bytes:   # AVI1 APP0, polarity 0
                return jpeg[:2] + b"\xff\xe0" + struct.pack(
                    ">H4sBBII", 16, b"AVI1", 0, 0, len(jpeg), len(jpeg)) + \
                    jpeg[2:]

            packets = [b"".join(avi1(pil_jpegs(
                [np.ascontiguousarray(f[k::2])], subsampling=sub)[0])
                for k in (0, 1)) for f in frames]
        elif layout == "grey resize":
            import cv2

            packets = []
            for k, (sh, sw) in enumerate(spec["sizes"]):
                part = [cv2.resize(f, (sw, sh), interpolation=cv2.INTER_AREA)
                        for f in frames[6 * k:6 * k + 6]]
                packets += pil_jpegs(part, grey=True)
            h, w = spec["sizes"][0]
        else:
            packets = jpegs_of(frames, layout)
        return packets, plain, every, (w, h), "V_MJPEG", b"", b"jpeg", b""
    if kind == "raw":
        return [i420(f) for f in frames], plain, every, (w, h), \
            "V_UNCOMPRESSED", b"", b"", b""
    info = {"extradata": b"", "bits": 16, "tag": b""}
    packets = lavc_encode(frames, "huffyuv", info=info,
                          pixel_format="yuv422p")
    bih = struct.pack("<IiiHH4sIiiII", 40 + len(info["extradata"]), w, h, 1,
                      info["bits"] or 16, b"HFYU", w * h * 2, 0, 0, 0, 0)
    return packets, plain, every, (w, h), "V_MS/VFW/FOURCC", \
        bih + info["extradata"], b"", b""


def muxer_file(name: str, spec: dict, frames=None) -> bytes:
    """A MUXER_CASES or MUXER_CLIPS file (see MUXER_CASES), of `frames`
    (BGR; None: moving_frames of the case's `size`)."""
    if frames is None:
        frames = moving_frames(sum(map(ord, name)), MUXER_FRAMES,
                               *spec.get("size", (H, W)))
    packets, times, keys, (w, h), codec_id, private, entry, boxes = \
        muxer_stream(spec, frames)
    n = len(packets)
    ext = name.rsplit("_", 1)[1]
    if ext == "avi":
        return avi_file(packets, w, h, 25, n, spec.get("fourcc") or {
            "mjpeg": b"MJPG", "h264gbr": b"H264"}[spec["stream"]])
    if ext == "mp4":
        # a fragment at each keyframe
        starts = [k for k in keys if k] + [n]
        frags = [b - a for a, b in zip([0] + starts[:-1], starts)]
        dts0 = times[0][1]
        opts = dict(ctts=[p - d for p, d in times], media_time=-dts0)
        if spec.get("desc"):
            sample_entry = _box(entry, bytes(6), struct.pack(
                ">HHH12xHHIIIH32sHh", 1, 0, 0, w, h, 0x480000, 0x480000, 0,
                1, b"", 24, -1), boxes)
            opts.update(entries=[sample_entry],
                        descriptions=[1] + [2] * (len(frags) - 1))
        return mp4_file(packets, w, h, 25, entry, boxes, sync=keys,
                        fragments=frags, data_track=spec.get("data"),
                        audio=audio_track(n, 25, 8000)
                        if spec.get("audio") else None, **opts)
    pts = [p - min(q for q, _ in times) for p, _ in times]
    rate = spec.get("rate")
    opts = {}
    if rate:
        opts = dict(default_duration=False, duration=n * 1000 / rate,
                    times=[int(round(p * 1000 / rate)) for p in pts])
    if spec.get("enc"):
        opts["encodings"] = _muxer_encodings(spec, packets, private)
    return mkv_file(packets, w, h, 25, codec_id, private, pts=pts,
                    keys=keys, lace=spec.get("lace"),
                    colour_space=b"I420" if spec["stream"] == "raw" else None,
                    **opts)


def write_case(name: str, out: str = FIXTURES) -> str:
    """Write one case (not its .npz) into `out`; return its path."""
    import re
    import tempfile

    path = os.path.join(out, os.path.basename(path_of(name)))
    if name in LEGACY_CASES or name in LEGACY_CLIPS:
        enc, tag, _ = {**LEGACY_CASES, **LEGACY_CLIPS}[name]
        if enc == "cv2":
            write_cv2(path, tag, 25, moving_frames(
                sum(map(ord, name)), LEGACY_FRAMES, *LEGACY_SIZE))
        else:
            with open(path, "wb") as f:
                f.write(legacy_file(name))
        return path
    if name in ITU_CASES or name in ITU_CLIPS:
        enc, tag, _ = {**ITU_CASES, **ITU_CLIPS}[name]
        if enc == "cv2":
            write_cv2(path, tag, 25, moving_frames(sum(map(ord, name)),
                                                   ITU_FRAMES, 144, 176))
        else:
            with open(path, "wb") as f:
                f.write(itu_file(name))
        return path
    if name in MUXER_CASES or name in MUXER_CLIPS:
        frames = clip_frames_bgr()[:16, 32:192] if name in MUXER_CLIPS \
            else None
        with open(path, "wb") as f:
            f.write(muxer_file(name, {**MUXER_CASES, **MUXER_CLIPS}[name],
                               frames))
        return path
    if name in OPENCV_CASES or name in OPENCV_CLIPS:
        enc, tag, _ = {**OPENCV_CASES, **OPENCV_CLIPS}[name]
        if name in OPENCV_CLIPS:
            write_cv2(path, tag, 25, clip_frames_bgr()[:16])
        elif enc == "cv2":
            write_cv2(path, tag, 25, moving_frames(
                sum(map(ord, name)), OPENCV_FRAMES, *OPENCV_SIZE))
        else:
            with open(path, "wb") as f:
                f.write(opencv_file(name))
        return path
    if name in LOSSLESS_CASES or name in LOSSLESS_CLIPS:
        enc, kind, _ = {**LOSSLESS_CASES, **LOSSLESS_CLIPS}[name]
        if enc == "cv2":
            write_cv2(path, kind, 25, moving_frames(
                sum(map(ord, name)), LOSSLESS_FRAMES, *LOSSLESS_SIZE))
        else:
            with open(path, "wb") as f:
                f.write(lossless_file(name))
        return path
    if name in RAW_CASES or name in RAW_CLIPS:
        mux, tag, container, _ = {**RAW_CASES, **RAW_CLIPS}[name]
        if mux == "cv2":
            frames = clip_frames_bgr()[:8] if name in RAW_CLIPS else \
                moving_frames(sum(map(ord, name)), RAW_CV2_FRAMES,
                              *RAW_CV2_SIZE)
            write_cv2(path, tag, 25, frames)
        else:
            with open(path, "wb") as f:
                f.write(raw_file(name))
        return path
    if name == "clip_pim1_avi":
        import cv2

        h, w = DVD_CLIPS[name]["size"]
        write_cv2(path, "PIM1", 25, [cv2.resize(f, (w, h), interpolation=cv2.
                                                INTER_AREA)
                                     for f in clip_frames_bgr()[:16]])
        return path
    if name in DVD_CASES or name in DVD_CLIPS or name in DVD_UNREAD:
        if name in DVD_CLIPS:
            settings = DVD_CLIPS[name]
            frames = clip_frames_bgr()[:16]
        else:
            settings = {**DVD_CASES, **DVD_UNREAD}[name]
            if name in DVD_UNREAD:
                settings = settings[0]
            frames = None
        packets, times, (w, h) = dvd_stream(settings, frames,
                                            seed=sum(map(ord, name[:-4])))
        with open(path, "wb") as f:
            f.write(dvd_file(packets, times, w, h, name.rsplit("_", 1)[1],
                             mpeg1=name.startswith("mpeg1"),
                             oti=0x65 if "_422" in name else 0x61))
        return path
    if name in BROWSER_CASES or name in BROWSER_CLIPS:
        if name in BROWSER_CLIPS:
            data = browser_file(name, BROWSER_CLIPS[name], 0,
                                clip_frames_bgr()[:16])
        else:
            data = browser_file(name, BROWSER_CASES[name],
                                sum(map(ord, name)))
        with open(path, "wb") as f:
            f.write(data)
        return path
    if (name in CAMERA_CASES or name in CAMERA_CLIPS or name in SCREEN_CASES
            or name in SCREEN_CLIPS):
        cases = {**CAMERA_CASES, **SCREEN_CASES}
        clips = {**CAMERA_CLIPS, **SCREEN_CLIPS}
        if name in clips:
            frames = clip_frames_bgr()[:16]
            aus = camera_stream(clips[name], frames)
        else:
            frames = None
            aus = camera_stream(cases[name], seed=sum(map(ord, name)))
        h, w = cases.get(name, {}).get("size", (48, 64)) \
            if frames is None else frames.shape[1:3]
        with open(path, "wb") as f:
            f.write(h264_file(aus, w, h, name.rsplit("_", 1)[1]))
        return path
    if name in HEVC_CASES or name in HEVC_CLIPS:
        settings = {**HEVC_CASES, **HEVC_CLIPS}[name]
        frames = clip_frames_bgr()[:16] if name in HEVC_CLIPS else None
        aus = hevc_stream(settings, frames, seed=settings.get(
            "seed", sum(map(ord, name))))
        h, w = settings.get("size", HEVC_SIZE) if frames is None else \
            frames.shape[1:3]
        with open(path, "wb") as f:
            f.write(hevc_file(
                aus, w, h, name.rsplit("_", 1)[1],
                entry=settings.get("entry", "hvc1"),
                matrix=settings.get("matrix", 0),
                audio=settings.get("audio", False),
                depth=10 if settings.get("pixel_format") == "yuv420p10le"
                else 8))
        return path
    if name in CONTAINER_CASES or name in PHONE_CLIPS:
        if name in PHONE_CLIPS:
            stream, opts = "h264", PHONE_CLIPS[name]
            data = container_file(name, opts, stream,
                                  clip_frames_bgr()[:16, 32:192])
        else:
            stream, opts = CONTAINER_CASES[name]
            data = container_file(name, opts, stream)
        with open(path, "wb") as f:
            f.write(data)
        return path
    if name in LAVC_CASES or name in LAVC_UNREAD or name in LAVC_CLIPS:
        if name in LAVC_CLIPS:
            (enc, opts), user = LAVC_CLIPS[name], None
            fourcc = CLIP_CASES[name][1].encode()
            frames = clip_frames_bgr()[:CLIP_CASES[name][2]]
        else:
            enc, opts, fourcc, *rest = (LAVC_CASES.get(name)
                                        or LAVC_UNREAD[name])
            user = rest[0] if rest else None
            frames = (clip_frames_bgr()[:12, 64:128, 32:128]
                      if name in LAVC_CROP else
                      moving_frames(sum(map(ord, name)), 12,
                                    *LAVC_SIZES.get(name, (64, 96))))
            if name in LAVC_SATURATED:
                frames = np.where(frames > 128, 255, 0).astype(np.uint8)
        times: list[tuple[int, int]] = []
        packets = lavc_encode(frames, enc, matrices=LAVC_MATRICES.get(name),
                              times=times, **opts)
        if user:
            packets[0] = re.sub(rb"Lavc[0-9.]+|XviD[0-9]+", user, packets[0])
        if name in LAVC_GMC1:
            packets = [gmc_translation(p) for p in packets]
        h, w = frames.shape[1:3]
        with open(path, "wb") as f:
            f.write(lavc_file(packets, times, w, h, fourcc,
                              name.rsplit("_", 1)[1]))
        return path
    if name in X264_PATCHED:
        settings, kinds, field, bits = X264_PATCHED[name]
        aus = x264_encode(moving_frames(sum(map(ord, name)), 30), **settings)
        packets = [a for a, _, _ in aus]
        for kind in kinds:
            packets = patch_h264(packets, kind, field, bits)
        with open(path, "wb") as f:
            f.write(avi_file(packets, W, H, 25, len(packets), b"H264"))
        return path
    if name in MJPEG_CASES or name == "clip_cam_avi" or name in ODML_CASES:
        if name in MJPEG_CASES:
            t, (h, w), layout = MJPEG_CASES[name]
            frames = moving_frames(sum(map(ord, name)), t, h, w)
            data = avi_file(jpegs_of(frames, layout), w, h, 25, t)
        else:
            if name in ODML_CASES:
                t, split = ODML_CASES[name]
                frames = moving_frames(sum(map(ord, name)), t)
            else:
                t = CLIP_CASES[name][2]
                split, frames = 10, clip_frames_bgr()[:t]
            h, w = frames.shape[1:3]
            data = avi_odml_file(jpegs_of(frames, "4:2:2"), w, h, 25, split)
        with open(path, "wb") as f:
            f.write(data)
        return path
    if name in EDIT_CASES or name == "clip_cut_mp4":
        if name in EDIT_CASES:
            frames, edits = moving_frames(sum(map(ord, name)), 40), \
                EDIT_CASES[name]
        else:                   # cut 4 frames into 20
            frames, edits = clip_frames_bgr()[:20], [(16, 4)]
        aus = x264_encode(frames, keyint=12)
        h, w = frames.shape[1:3]
        with open(path, "wb") as f:
            f.write(h264_file(aus, w, h, "mp4", edits=edits))
        return path
    if name in H264_TOOLS or name in TOOLS_CLIPS:
        aus, (h, w) = tools_stream(name)
        with open(path, "wb") as f:
            f.write(h264_cut_file(aus, w, h, name.rsplit("_", 1)[1],
                                  audio=name in TOOLS_CLIPS))
        return path
    if name in X264_CASES or name in X264_CLIPS:
        if name in X264_CLIPS:
            frames = clip_frames_bgr()[:CLIP_CASES[name][2]]
            settings = dict(X264_CLIPS[name])
        else:
            settings = dict(X264_CASES[name])
            frames = moving_frames(sum(map(ord, name)),
                                   settings.pop("frames", 30))
            noise = settings.pop("noise", 0)
            if noise:
                rng = np.random.default_rng(len(name))
                frames = np.clip(frames + rng.uniform(
                    -noise, noise, frames.shape), 0, 255).astype(np.uint8)
        aus = x264_encode(frames, **settings)
        h, w = frames.shape[1:3]
        with open(path, "wb") as f:
            f.write(h264_file(aus, w, h, name.rsplit("_", 1)[1]))
        return path
    if name in MP4_MJPEG_CASES:
        with tempfile.TemporaryDirectory() as tmp:
            src = os.path.join(tmp, "src.avi")
            write_cv2(src, "MJPG", 25, moving_frames(len(name), 12))
            packets = cv2_packets(src)
        with open(path, "wb") as f:
            f.write(mp4_file(packets, W, H, 25, MP4_MJPEG_CASES[name]))
        return path
    if name in VP8_MP4_CASES:
        with tempfile.TemporaryDirectory() as tmp:
            src = os.path.join(tmp, "src.avi")
            write_cv2(src, "VP80", 25, moving_frames(len(name), 20))
            packets = cv2_packets(src)
        with open(path, "wb") as f:
            f.write(mp4_file(packets, W, H, 25, VP8_MP4_CASES[name],
                             vpcc_box()))
        return path
    if name in VP8_PATCHED:
        with tempfile.TemporaryDirectory() as tmp:
            src = os.path.join(tmp, "src.mkv")
            write_cv2(src, "VP80", 25, moving_frames(11, 30))
            data = open(src, "rb").read()
            packets = cv2_packets(src)
        with open(path, "wb") as f:
            f.write(patch_vp8(data, packets, VP8_PATCHED[name]))
        return path
    if name in LIBVPX_CASES:
        settings = dict(LIBVPX_CASES[name])
        h, w = settings.pop("size", (H, W))
        z = settings.pop("zoom", 1)
        frames = moving_frames(sum(map(ord, name)), 40, h // z, w // z)
        frames = frames.repeat(z, axis=1).repeat(z, axis=2)
        codec = codec_of(name)
        packets = libvpx_encode(frames, codec=codec, **settings)
        with open(path, "wb") as f:
            f.write(avi_file(packets, w, h, 25, len(packets),
                             b"VP80" if codec == "vp8" else b"VP90"))
        return path
    if name in HAND_CASES:
        t, count, fps = HAND_CASES[name]
        frames = moving_frames(len(name), t)
        jpegs = pil_jpegs(frames)
        if "nodht" in name:
            jpegs = [strip_dht(j) for j in jpegs]
        with open(path, "wb") as f:
            f.write(avi_file(jpegs, W, H, fps, count))
        return path
    if name in CLIP_CASES:
        ext, fourcc, t = CLIP_CASES[name]
        frames = clip_frames_bgr()[:t]
        if name == "clip_oddh_avi":     # cv2's writer evens the height
            frames = frames[:, :-1]
            with open(path, "wb") as f:
                f.write(avi_file(jpegs_of(frames, "4:2:0"), frames.shape[2],
                                 frames.shape[1], 25, t))
            return path
        write_cv2(path, fourcc, 25, frames)
        return path
    ext, fourcc, fps, t = CASES[name]
    write_cv2(path, fourcc, fps, moving_frames(sum(map(ord, name)), t))
    return path


def write_1080p(out: str = FIXTURES):
    """HEVC_1080P and cv2's SHA-256 of each of its frames' BGR bytes
    (HEVC_1080P_SHA)."""
    import cv2
    import hashlib
    import json

    frames = np.stack([cv2.resize(f, (1920, 1080),
                                  interpolation=cv2.INTER_CUBIC)
                       for f in clip_frames_bgr()[:4]])
    path = os.path.join(out, HEVC_1080P)
    with open(path, "wb") as f:                  # libx265's defaults, MP4
        f.write(hevc_file(hevc_stream(dict(params=HEVC_WPP), frames),
                          1920, 1080, "mp4"))
    got, count = cv2_view(path)
    with open(os.path.join(out, HEVC_1080P_SHA), "w") as f:
        json.dump({"n": len(got), "count": count, "shape": list(got.shape),
                   "sha256": [hashlib.sha256(g.tobytes()).hexdigest()
                              for g in got]}, f, indent=1)


def main(out: str = FIXTURES, *names: str):
    os.makedirs(out, exist_ok=True)
    for name in names or (*HELD, *CLIP_CASES, *LAVC_UNREAD, *PHONE_CLIPS,
                          *CAMERA_CLIPS, *SCREEN_CLIPS, HEVC_1080P):
        if name in DVD_UNREAD:          # written by the test itself
            continue
        if name == HEVC_1080P:
            write_1080p(out)
            continue
        path = write_case(name, out)
        if name not in HELD:
            continue
        frames, count = cv2_view(path)
        index = np.array(sorted({0, len(frames) // 2, len(frames) - 1}))
        if (name == "clip_dvd_mkv" or name in RAW_CLIPS
                or name in LOSSLESS_CASES or name in LOSSLESS_CLIPS
                or name in MUXER_CASES or name in MUXER_CLIPS
                or name in LEGACY_CASES or name in LEGACY_CLIPS
                or name in OPENCV_CASES or name in OPENCV_CLIPS):
            index = np.array([0, len(frames) - 1])      # the first and last
        if name in ITU_CASES or name in ITU_CLIPS:
            index = np.array([len(frames) - 1])         # the last
        extra = {}
        if name in CONTAINER_CASES:
            import cv2

            cap = cv2.VideoCapture(path)
            extra["orientation"] = np.int64(
                cap.get(cv2.CAP_PROP_ORIENTATION_META))
            cap.release()
        if name in BROWSER_CLIPS:
            sys.path.insert(0, os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))))
            from viai_tpu.data import av as j_av

            picks = np.stack([j_av._load_frames_video(path, 16, 64, w)
                              for w in BROWSER_PICKS])
            # levels / 255 in float32: kept as the levels
            extra["picks"] = np.rint(picks * 255).astype(np.uint8)
            assert np.array_equal(extra["picks"] / np.float32(255), picks)
            extra["picks_windows"] = np.array(
                [(-1.0, -1.0) if w is None else w for w in BROWSER_PICKS])
        np.savez_compressed(os.path.join(out, name + ".npz"),
                            frames=frames[index], index=index,
                            n=np.int64(len(frames)), count=np.int64(count),
                            **extra)


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:]))
