"""Compressed video clips for the port's video reader, and cv2's decodes.

    python tests/_torch_make_videos.py

writes `tests/torch_videos/` (needs cv2, which the card's machine does
not have, so the fixtures are committed):
  * `<case>.<ext>`: every case of CASES, written by cv2's VideoWriter
    (ffmpeg's MJPEG and MPEG-4 Part 2 encoders, in AVI, MP4, MOV and
    Matroska), except the AVIs of HAND_CASES, muxed here: MJPEG packets
    without their Huffman tables (the AVI1 convention: the decoder
    takes the standard tables of JPEG's annex K), and one whose headers
    count more frames than it holds;
  * `<case>.npz`: cv2's view of it: `n`, the frames `cap.read()` gives;
    `frames`, the first, the middle and the last of them ((3, H, W, 3)
    BGR uint8, at `index`); and `count`, `CAP_PROP_FRAME_COUNT`;
  * `clip.avi`, `clip.mp4`, `clip.mkv`, `clip.mov`: the first frames
    of the committed 224x224 jpeg clip (tests/torch_frames/clip/) as
    video (CLIP_CASES), the clips chip_smoke.py trains from.

The small cases are 72x56 (not a multiple of 16) with a textured square
that moves over a drifting background, so that the MPEG-4 clips' P-VOPs
carry motion and, at 30 frames, a third I-VOP (ffmpeg's GOP is 12).
cv2's encoders are deterministic here, so a rerun rewrites the same
bytes, but for the Matroska files' random segment UID. tests/test_torch_video_decode.py holds the port against cv2
live and against these files.
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
    "mjpeg_mp4": ("mp4", "MJPG", 25, 20),
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
    "vp8_webm": ("webm", "VP80", 25, 6),
}
# name: (frames, frame count the headers give, fps)
HAND_CASES = {
    "mjpeg_nodht_avi": (12, 12, 25),
    "mjpeg_longhdr_avi": (12, 17, 25),
}
# the clip chip_smoke.py trains from: name: (ext, fourcc)
# (ext, fourcc, frames): the first frames of the 32.
CLIP_CASES = {"clip_avi": ("avi", "MJPG", 16), "clip_mp4": ("mp4", "mp4v", 16),
              "clip_mkv": ("mkv", "mp4v", 8), "clip_mov": ("mov", "MJPG", 8)}


def path_of(name: str) -> str:
    ext = (CASES.get(name) or CLIP_CASES.get(name) or ("avi",))[0]
    return os.path.join(FIXTURES, name.rsplit("_", 1)[0] + "." + ext) \
        if name in CLIP_CASES else os.path.join(FIXTURES, f"{name}.{ext}")


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
    import cv2

    h, w = frames[0].shape[:2]
    wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*fourcc), fps, (w, h))
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


def avi_file(packets: list[bytes], w: int, h: int, fps: int, count: int,
             fourcc: bytes = b"MJPG") -> bytes:
    """An AVI of video packets (stream 0 'vids' `fourcc`, `00dc` chunks,
    an idx1 index with every packet a keyframe) whose avih and strh say
    `count` frames."""
    avih = struct.pack("<14I", 1000000 // fps, 0, 0, 0x10, count, 0, 1, 0,
                       w, h, 0, 0, 0, 0)
    strh = (b"vids" + fourcc + struct.pack(
        "<IHHIIIIIIIIhhhh", 0, 0, 0, 0, 1, fps, 0, count, 0, 0xFFFFFFFF, 0,
        0, 0, w, h))
    strf = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 24, fourcc, w * h * 3,
                       0, 0, 0, 0)
    hdrl = _list(b"hdrl", _chunk(b"avih", avih) + _list(
        b"strl", _chunk(b"strh", strh) + _chunk(b"strf", strf)))
    movi, idx, off = b"", b"", 4
    for p in packets:
        c = _chunk(b"00dc", p)
        idx += b"00dc" + struct.pack("<III", 0x10, off, len(p))
        movi += c
        off += len(c)
    body = hdrl + _list(b"movi", movi) + _chunk(b"idx1", idx)
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"AVI " + body


def pil_jpegs(frames, quality: int = 75) -> list[bytes]:
    from PIL import Image

    out = []
    for f in frames:
        buf = io.BytesIO()
        Image.fromarray(f[..., ::-1]).save(buf, "JPEG", quality=quality,
                                           subsampling=2)
        out.append(buf.getvalue())
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


def write_case(name: str, out: str = FIXTURES) -> str:
    """Write one case (not its .npz) into `out`; return its path."""
    if name in HAND_CASES:
        t, count, fps = HAND_CASES[name]
        frames = moving_frames(len(name), t)
        path = os.path.join(out, name + ".avi")
        jpegs = pil_jpegs(frames)
        if "nodht" in name:
            jpegs = [strip_dht(j) for j in jpegs]
        with open(path, "wb") as f:
            f.write(avi_file(jpegs, W, H, fps, count))
        return path
    if name in CLIP_CASES:
        ext, fourcc, t = CLIP_CASES[name]
        path = os.path.join(out, "clip." + ext)
        write_cv2(path, fourcc, 25, clip_frames_bgr()[:t])
        return path
    ext, fourcc, fps, t = CASES[name]
    path = os.path.join(out, f"{name}.{ext}")
    write_cv2(path, fourcc, fps, moving_frames(sum(map(ord, name)), t))
    return path


def main(out: str = FIXTURES):
    os.makedirs(out, exist_ok=True)
    for name in (*CASES, *HAND_CASES):
        path = write_case(name, out)
        if name == "vp8_webm":
            continue                    # not read by the port
        frames, count = cv2_view(path)
        index = np.array(sorted({0, len(frames) // 2, len(frames) - 1}))
        np.savez_compressed(os.path.join(out, name + ".npz"),
                            frames=frames[index], index=index,
                            n=np.int64(len(frames)), count=np.int64(count))
    for name in CLIP_CASES:
        write_case(name, out)


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:]))
