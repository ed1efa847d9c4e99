"""Audio dataset: wav files under a dataroot, random crops.

The port's copy of `viai_tpu/data/audio.py`. `load_wav` decodes and
resamples through the native library (native.py, g++ at first use);
the spectrograms and masks are computed on the device by the train
step, so this layer hands over raw waveforms only. Beside it, a plain
numpy RIFF reader and linear resampler (`read_wav_numpy`,
`resample_linear_numpy`) compute what the native ones compute; the
tests and chip_smoke.py hold the native decoder against them, in place
of the JAX module's scipy fallback. `write_wav` writes the files they
read.
"""

from __future__ import annotations

import os
import struct

import numpy as np

from .. import native

# write_wav formats: (WAVE format code, bits, numpy dtype).
WAV_FORMATS = {"pcm8": (1, 8, "u1"), "pcm16": (1, 16, "<i2"),
               "pcm24": (1, 24, None), "pcm32": (1, 32, "<i4"),
               "float32": (3, 32, "<f4")}


def find_wavs(root: str) -> list[str]:
    out = []
    for dirpath, _, files in os.walk(root):
        for f in sorted(files):
            if f.lower().endswith(".wav"):
                out.append(os.path.join(dirpath, f))
    return sorted(out)


def load_wav(path: str, target_sr: int = 16000) -> np.ndarray:
    """Decode a wav file to mono float32 and resample it linearly to
    target_sr (the native decoder and resampler)."""
    with open(path, "rb") as f:
        data = f.read()
    wav, sr = native.decode_wav(data)
    if sr != target_sr:
        wav = native.resample_linear(wav, sr, target_sr)
    return wav


def read_wav_numpy(data: bytes, max_samples: int = native.MAX_WAV_SAMPLES
                   ) -> tuple[np.ndarray, int]:
    """native.decode_wav in numpy: RIFF/WAVE bytes (PCM 8/16/24/32 or
    float32, WAVE_FORMAT_EXTENSIBLE too) → (mono float32, sample rate);
    each sample in float64, channels summed in order, times 1/channels,
    rounded to float32, as the C++ decoder computes it."""
    if len(data) < 44 or data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("not a decodable WAV buffer")
    pos, fmt, channels, bits, sr, body = 12, 0, 0, 0, 0, None
    while pos + 8 <= len(data):
        tag = data[pos:pos + 4]
        size = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        if tag == b"fmt " and pos + 8 + 16 <= len(data):
            fmt, channels, sr = struct.unpack("<HHI", data[pos + 8:pos + 16])
            bits = struct.unpack("<H", data[pos + 22:pos + 24])[0]
            if fmt == 0xFFFE:   # WAVE_FORMAT_EXTENSIBLE: the SubFormat's code
                fmt = (struct.unpack("<H", data[pos + 32:pos + 34])[0]
                       if size >= 40 and pos + 8 + 26 <= len(data) else 1)
        elif tag == b"data":
            body = data[pos + 8:pos + 8 + size]
            break
        pos += 8 + size + (size & 1)
    if body is None or not channels or not sr or bits // 8 == 0:
        raise ValueError("not a decodable WAV buffer")
    width = bits // 8
    frames = min(len(body) // (width * channels), max_samples)
    raw = np.frombuffer(body[:frames * width * channels], np.uint8)
    if fmt == 3 and bits == 32:
        v = raw.view("<f4").astype(np.float64)
    elif bits == 16:
        v = raw.view("<i2") / 32768.0
    elif bits == 24:
        b = raw.reshape(-1, 3).astype(np.uint32)
        s = (b[:, 0] << 8 | b[:, 1] << 16 | b[:, 2] << 24).view(np.int32)
        v = (s >> 8) / 8388608.0
    elif bits == 32:
        v = raw.view("<i4") / 2147483648.0
    elif bits == 8:
        v = (raw.astype(np.int64) - 128) / 128.0
    else:
        raise ValueError(f"unsupported WAV sample width: {bits} bits")
    v = v.reshape(frames, channels)
    acc = np.zeros(frames)
    for c in range(channels):
        acc += v[:, c]
    return (acc * (1.0 / channels)).astype(np.float32), int(sr)


def resample_linear_numpy(x: np.ndarray, sr_in: int, sr_out: int
                          ) -> np.ndarray:
    """native.resample_linear in numpy (float64 arithmetic)."""
    x = np.asarray(x, np.float32)
    n_out = int(len(x) * sr_out / sr_in)
    if len(x) <= 1 or n_out <= 0:
        return np.zeros(max(n_out, 0), np.float32)
    t = np.arange(n_out, dtype=np.float64) * (sr_in / sr_out)
    i0 = np.minimum(t.astype(np.int64), len(x) - 2)
    frac = t - i0
    xd = x.astype(np.float64)
    return (xd[i0] * (1.0 - frac) + xd[i0 + 1] * frac).astype(np.float32)


def write_wav(path: str, wav: np.ndarray, sr: int,
              sample_format: str = "pcm16"):
    """Write (S,) or (S, channels) samples in [-1, 1] as a RIFF/WAVE file
    in one of WAV_FORMATS."""
    code, bits, dtype = WAV_FORMATS[sample_format]
    x = np.asarray(wav, np.float64)
    x = x[:, None] if x.ndim == 1 else x
    channels = x.shape[1]
    if sample_format == "float32":
        raw = x.astype(dtype).tobytes()
    else:
        q = np.round(np.clip(x, -1.0, 1.0) * (2.0 ** (bits - 1) - 1))
        if bits == 8:
            raw = (q + 128).astype(dtype).tobytes()
        elif bits == 24:
            raw = (q.astype("<i4").view(np.uint8).reshape(-1, 4)[:, :3]
                   .tobytes())
        else:
            raw = q.astype(dtype).tobytes()
    block = channels * bits // 8
    fmt = struct.pack("<HHIIHH", code, channels, sr, sr * block, block, bits)
    body = (b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt
            + b"data" + struct.pack("<I", len(raw)) + raw
            + (b"\0" if len(raw) & 1 else b""))
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(body)) + body)


def crop_with_info(wav: np.ndarray, clip_samples: int, rng
                   ) -> tuple[np.ndarray, int, int]:
    """Random crop → (clip, crop start, source length); a source shorter
    than the clip is zero-padded at the end. The (start, length) pair
    lets the av datasets pick the frames of exactly the cropped audio."""
    out = np.zeros(clip_samples, np.float32)
    total = len(wav)
    start = 0
    if total >= clip_samples:
        start = int(rng.integers(0, total - clip_samples + 1))
        out[:] = wav[start:start + clip_samples]
    else:
        out[:total] = wav
    return out, start, total


def crop_or_pad(wav: np.ndarray, clip_samples: int, rng) -> np.ndarray:
    """A random clip_samples crop (short signals zero-padded)."""
    return crop_with_info(wav, clip_samples, rng)[0]


class AudioFolderDataset:
    """Random-access dataset: idx → {'wav': (clip_samples,) float32}.

    The crop position is a function of (seed, idx) for the raw index
    (not idx % len), so loader.EpochSampler's indices, offset by one
    epoch's records each epoch, read fresh crops and stay replayable.
    """

    def __init__(self, root: str, clip_samples: int = 32000,
                 sample_rate: int = 16000, seed: int = 0):
        self.paths = find_wavs(root)
        if not self.paths:
            raise FileNotFoundError(f"no .wav files under {root}")
        self.clip_samples = clip_samples
        self.sample_rate = sample_rate
        self.seed = seed

    def __len__(self):
        return len(self.paths)

    def load_cropped(self, idx: int):
        """idx → ({'wav': clip}, crop start, source samples)."""
        idx = int(idx)
        wav = load_wav(self.paths[idx % len(self.paths)], self.sample_rate)
        rng = np.random.default_rng((self.seed, idx))
        clip, start, total = crop_with_info(wav, self.clip_samples, rng)
        return {"wav": clip}, start, total

    def __getitem__(self, idx: int):
        return self.load_cropped(idx)[0]
