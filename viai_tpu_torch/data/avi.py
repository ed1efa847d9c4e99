"""Minimal RIFF/AVI muxer and demuxer in numpy: the port's copy of
`viai_tpu/data/avi.py`.

  * write_avi: (T, H, W, 3) uint8 frames and mono PCM16 audio → .avi
    (stream 0 'vids' uncompressed 32-bit 'RGBA' top-down rawvideo,
    stream 1 'auds' PCM16), with an idx1 index;
  * read_avi: the inverse; reads the 'RGBA' profile above and classic
    BI_RGB 24-bit bottom-up DIB (what ffmpeg's `-c:v rawvideo -pix_fmt
    bgr24` writes), with PCM16 audio. Compressed video raises.

The tests and chip_smoke.py write their AVI files with write_avi; the
data loader reads frames through the native reader (native.py), which
parses the same two profiles.
"""

from __future__ import annotations

import struct

import numpy as np


def _pad_row(w: int) -> int:
    """DIB rows are padded to 4-byte boundaries (24-bit BGR)."""
    return (w * 3 + 3) // 4 * 4


def write_avi(path: str, frames: np.ndarray, fps: int,
              audio: np.ndarray | None = None, sr: int = 16000) -> None:
    """frames: (T, H, W, 3) uint8 RGB; audio: (S,) float32 in [-1, 1]."""
    frames = np.asarray(frames)
    if frames.ndim != 4 or frames.shape[-1] != 3 or frames.dtype != np.uint8:
        raise ValueError(f"frames must be (T, H, W, 3) uint8, got "
                         f"{frames.shape} {frames.dtype}")
    T, H, W, _ = frames.shape
    frame_bytes = W * H * 4                       # 32-bit RGBA, top-down

    pcm = b""
    n_samples = 0
    if audio is not None:
        a = np.clip(np.asarray(audio, np.float32), -1.0, 1.0)
        pcm = (a * 32767.0).astype("<i2").tobytes()
        n_samples = len(a)

    def chunk(tag: bytes, payload: bytes) -> bytes:
        pad = b"\x00" if len(payload) & 1 else b""
        return tag + struct.pack("<I", len(payload)) + payload + pad

    def lst(tag: bytes, payload: bytes) -> bytes:
        return chunk(b"LIST", tag + payload)

    # --- headers ---------------------------------------------------------
    n_streams = 2 if audio is not None else 1
    avih = struct.pack(
        "<IIIIIIIIIIIIII",
        1_000_000 // max(fps, 1),   # microseconds per frame
        frame_bytes * fps,          # max bytes per second (approx)
        0,                          # padding granularity
        0x10,                       # flags: AVIF_HASINDEX
        T, 0, n_streams, frame_bytes, W, H, 0, 0, 0, 0,
    )
    strh_v = struct.pack(
        "<4s4sIHHIIIIIIII4H",
        b"vids", b"RGBA", 0, 0, 0, 0, 1, fps, 0, T,
        frame_bytes, 0xFFFFFFFF, 0, 0, 0, W, H,
    )
    fourcc_rgba = struct.unpack("<I", b"RGBA")[0]
    strf_v = struct.pack(
        "<IiiHHIIiiII", 40, W, H, 1, 32, fourcc_rgba,
        frame_bytes, 0, 0, 0, 0,
    )
    strl_v = lst(b"strl", chunk(b"strh", strh_v) + chunk(b"strf", strf_v))
    strls = strl_v
    if audio is not None:
        strh_a = struct.pack(
            "<4s4sIHHIIIIIIII4H",
            b"auds", b"\x00\x00\x00\x00", 0, 0, 0, 0, 1, sr, 0, n_samples,
            sr * 2, 0xFFFFFFFF, 2, 0, 0, 0, 0,
        )
        strf_a = struct.pack("<HHIIHH", 1, 1, sr, sr * 2, 2, 16)  # PCM16 mono
        strls += lst(b"strl", chunk(b"strh", strh_a) + chunk(b"strf", strf_a))
    hdrl = lst(b"hdrl", chunk(b"avih", avih) + strls)

    # --- movi: interleave one video frame + its audio span ----------------
    movi_payload = b""
    idx_entries = []
    audio_pos = 0
    bytes_per_frame_audio = (n_samples * 2) // T if T else 0
    bytes_per_frame_audio -= bytes_per_frame_audio % 2
    rgba = np.empty((H, W, 4), np.uint8)
    for t in range(T):
        # 'RGBA' rawvideo: top-down R,G,B,A rows (measured profile).
        rgba[..., :3] = frames[t]
        rgba[..., 3] = 255
        raw = rgba.tobytes()
        off = len(movi_payload) + 4                    # offset after 'movi'
        idx_entries.append((b"00dc", 0x10, off, len(raw)))
        movi_payload += chunk(b"00dc", raw)
        if audio is not None:
            end = (n_samples * 2 if t == T - 1
                   else audio_pos + bytes_per_frame_audio)
            span = pcm[audio_pos:end]
            audio_pos = end
            if span:
                off = len(movi_payload) + 4
                idx_entries.append((b"01wb", 0x10, off, len(span)))
                movi_payload += chunk(b"01wb", span)
    movi = lst(b"movi", movi_payload)

    idx1 = b"".join(
        tag + struct.pack("<III", flags, off, size)
        for tag, flags, off, size in idx_entries
    )
    riff_payload = b"AVI " + hdrl + movi + chunk(b"idx1", idx1)
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(riff_payload)) + riff_payload)


def read_avi(path: str):
    """→ (frames (T,H,W,3) uint8 RGB, fps, audio float32 | None, sr).

    Supports BI_RGB 24-bit DIB video and PCM16 audio (the write_avi /
    `ffmpeg -c:v rawvideo -pix_fmt bgr24 -c:a pcm_s16le` profile).
    """
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:4] != b"RIFF" or buf[8:12] != b"AVI ":
        raise ValueError(f"{path}: not an AVI file")

    W = H = T = fps = 0
    sr = 16000
    have_audio = False
    vid_compression = None
    audio_fmt = None

    def walk(pos, end, stack):
        nonlocal W, H, T, fps, sr, have_audio, vid_compression, audio_fmt
        stream_types = stack.setdefault("streams", [])
        while pos + 8 <= end:
            tag = buf[pos:pos + 4]
            size = struct.unpack("<I", buf[pos + 4:pos + 8])[0]
            body = pos + 8
            if tag == b"LIST":
                walk(body + 4, body + size, stack)
            elif tag == b"strh":
                fcc = buf[body:body + 4]
                stream_types.append(fcc)
                if fcc == b"vids":
                    scale, rate = struct.unpack(
                        "<II", buf[body + 20:body + 28])
                    fps = rate // max(scale, 1)
                    T = struct.unpack("<I", buf[body + 32:body + 36])[0]
            elif tag == b"strf":
                if stream_types and stream_types[-1] == b"vids":
                    (_, W, H, _, bits, comp) = struct.unpack(
                        "<IiiHHI", buf[body:body + 20])
                    vid_compression = (bits, comp)
                elif stream_types and stream_types[-1] == b"auds":
                    audio_fmt = struct.unpack("<HHIIHH", buf[body:body + 16])
                    sr = audio_fmt[2]
                    have_audio = True
            pos = body + size + (size & 1)

    walk(12, len(buf), {})
    if vid_compression is None:
        raise ValueError(f"{path}: no video stream header")
    bits, comp = vid_compression
    fourcc_rgba = struct.unpack("<I", b"RGBA")[0]
    if (comp, bits) == (fourcc_rgba, 32):
        profile = "rgba"                 # top-down RGBA (write_avi)
    elif comp == 0 and bits == 24:
        profile = "dib24"                # bottom-up BGR, padded rows
    else:
        raise ValueError(
            f"{path}: unsupported video (biCompression={comp:#x}, "
            f"bits={bits}); only uncompressed RGBA-32/BI_RGB-24 AVIs are "
            "supported without ffmpeg — use cv2/ffmpeg for this file"
        )
    if have_audio and (audio_fmt[0] != 1 or audio_fmt[5] != 16):
        raise ValueError(
            f"{path}: non-PCM16 audio (fmt={audio_fmt[0]}, "
            f"bits={audio_fmt[5]}); only PCM16 is supported without ffmpeg"
        )

    # Second pass: collect movi chunks.
    frames = []
    pcm_parts = []
    row = _pad_row(W)

    def collect(pos, end):
        while pos + 8 <= end:
            tag = buf[pos:pos + 4]
            size = struct.unpack("<I", buf[pos + 4:pos + 8])[0]
            body = pos + 8
            if tag == b"LIST":
                collect(body + 4, body + size)
            elif tag[2:4] == b"db" or tag[2:4] == b"dc":
                arr = np.frombuffer(buf[body:body + size], np.uint8)
                if profile == "rgba" and len(arr) >= H * W * 4:
                    img = arr[: H * W * 4].reshape(H, W, 4)[..., :3]
                    frames.append(img.copy())
                elif profile == "dib24" and len(arr) >= row * H:
                    img = arr[: row * H].reshape(H, row)[:, : W * 3]
                    img = img.reshape(H, W, 3)[::-1, :, ::-1]  # →top RGB
                    frames.append(img.copy())
            elif tag[2:4] == b"wb":
                pcm_parts.append(buf[body:body + size])
            pos = body + size + (size & 1)

    collect(12, len(buf))
    if not frames:
        raise ValueError(f"{path}: no decodable DIB frames")
    audio = None
    if pcm_parts:
        pcm = b"".join(pcm_parts)
        audio = np.frombuffer(pcm, "<i2").astype(np.float32) / 32768.0
        nch = audio_fmt[1] if audio_fmt else 1
        if nch > 1:
            audio = audio.reshape(-1, nch).mean(axis=1)
    return np.stack(frames), fps, audio, sr
