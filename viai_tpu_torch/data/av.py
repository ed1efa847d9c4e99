"""Audio-visual datasets: wav files with their video frames.

The port's copy of `viai_tpu/data/av.py`. The frames of a clip
`<stem>.wav` are read from:
  * `<stem>.npy`, a (T, H, W, 3) stack: a C-ordered uint8 one through
    the native reader (native.py: window select, Pillow-style triangle
    resize in float, [0, 1] float32; `frames_numpy` is its plain numpy
    twin), any other (another dtype, Fortran order) through
    `resample_frames`, the JAX package's fallback for what its native
    reader refuses: uint8 scaled to [0, 1], other dtypes taken as
    [0, 1], and a resize through 8-bit frames with Pillow's bilinear
    filter in its fixed-point arithmetic;
  * `<stem>.avi`, uncompressed ('RGBA' 32-bit or BI_RGB 24-bit
    bottom-up, as data/avi.py writes and reads), through the native
    reader.
A directory of jpeg or png frames and compressed video (`.mp4`,
`.mkv`, `.webm`, compressed `.avi`) raise NotImplementedError naming
the layout: the JAX package reads them with PIL and cv2, which the port
does not import. A MUSICES-style JSON manifest {split: [{"audio": ...,
"frames": ...}]} is read by MusicesManifest.
"""

from __future__ import annotations

import json
import os

import numpy as np

from .. import native
from .audio import AudioFolderDataset, crop_with_info, load_wav

COMPRESSED_VIDEO = (".mp4", ".mkv", ".webm")


def _window_indices(total: int, n_frames: int, window) -> np.ndarray:
    """Frame indices spanning `window` = (t0_frac, t1_frac) of the
    source (None: all of it), as csrc/framestack.cpp computes them: the
    window's ends in float32, round((w0 + (w1 − w0)·i/(n − 1))·(T − 1))
    half to even, clipped to the source."""
    w0, w1 = (0.0, 1.0) if window is None else window
    w0, w1 = float(np.float32(w0)), float(np.float32(w1))
    f = np.arange(n_frames) / (n_frames - 1) if n_frames > 1 else \
        np.zeros(1)
    idx = np.rint((w0 + (w1 - w0) * f) * (total - 1)).astype(np.int64)
    return np.clip(idx, 0, total - 1)


def _resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) Pillow-style triangle-filter weights, each row
    normalized (the coefficients of csrc/framestack.cpp)."""
    scale = n_in / n_out
    support = max(scale, 1.0)
    w = np.zeros((n_out, n_in))
    for i in range(n_out):
        center = (i + 0.5) * scale
        lo = max(int(center - support + 0.5), 0)
        hi = min(int(center + support + 0.5), n_in)
        x = np.arange(lo, hi)
        tri = np.clip(1.0 - np.abs((x - center + 0.5) / support), 0.0, None)
        if tri.sum() > 0:
            w[i, lo:hi] = tri / tri.sum()
    return w.astype(np.float32)


def frames_numpy(arr: np.ndarray, n_frames: int, size: int,
                 window=None) -> np.ndarray:
    """native.load_frames on an in-memory (T, H, W, 3) stack: the frames
    of `window`, each resized to (size, size) by the triangle filter
    (horizontal pass, then vertical), uint8 scaled to [0, 1]."""
    arr = np.asarray(arr)
    sel = arr[_window_indices(arr.shape[0], n_frames, window)]
    x = sel.astype(np.float32)
    wy = _resize_weights(arr.shape[1], size)
    wx = _resize_weights(arr.shape[2], size)
    x = np.einsum("jw,twc->tjc", wx, x.reshape(-1, arr.shape[2], 3)
                  ).reshape(n_frames, arr.shape[1], size, 3)
    x = np.einsum("ih,thjc->tijc", wy, x)
    if arr.dtype == np.uint8:
        x = x * np.float32(1.0 / 255.0)
    return x.astype(np.float32)


_PILLOW_BITS = 22


def _pillow_coeffs(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) int64 coefficients of Pillow's 8-bit BILINEAR
    resample (libImaging/Resample.c), in its order of operations: the
    triangle filter's weights in double, normalized by their running
    sum, rounded to 22 fractional bits."""
    scale = n_in / n_out
    support = max(scale, 1.0)
    ss = 1.0 / support
    k = np.zeros((n_out, n_in), np.int64)
    for i in range(n_out):
        center = (i + 0.5) * scale
        lo = max(int(center - support + 0.5), 0)
        hi = min(int(center + support + 0.5), n_in)
        w = [max(1.0 - abs((x - center + 0.5) * ss), 0.0)
             for x in range(lo, hi)]
        ww = 0.0
        for v in w:
            ww += v
        for j, v in enumerate(w):
            v = v / ww if ww != 0.0 else v
            k[i, lo + j] = int(v * (1 << _PILLOW_BITS) + 0.5)  # v ≥ 0
    return k


def _pillow_pass(x: np.ndarray, k: np.ndarray, axis: int) -> np.ndarray:
    """One pass of Pillow's 8-bit resample along `axis` of uint8 `x`:
    Σ pixel·k from the rounding half, shifted, clipped to [0, 255]."""
    acc = np.tensordot(x.astype(np.int64), k, axes=([axis], [1]))
    acc = np.moveaxis(acc, -1, axis) + (1 << (_PILLOW_BITS - 1))
    return np.clip(acc >> _PILLOW_BITS, 0, 255).astype(np.uint8)


def resample_frames(arr: np.ndarray, n_frames: int, size: int,
                    window=None) -> np.ndarray:
    """A (T, H, W, 3) stack → (n_frames, size, size, 3) float32, as
    `viai_tpu/data/av.py::_resample_frames` computes it: uint8 / 255,
    the window's frames at round(linspace(w0·(T−1), w1·(T−1), n)), and,
    when the size differs, each frame as (x·255) cut to uint8, resized
    by Pillow's BILINEAR (horizontal pass, then vertical), / 255."""
    arr = np.asarray(arr)
    if arr.dtype == np.uint8:
        arr = arr.astype(np.float32) / 255.0
    arr = arr.astype(np.float32)
    w0, w1 = (0.0, 1.0) if window is None else window
    hi = max(arr.shape[0] - 1, 0)
    arr = arr[np.clip(np.linspace(w0 * hi, w1 * hi, n_frames).round()
                      .astype(int), 0, hi)]
    if arr.shape[1] == arr.shape[2] == size:
        return arr
    x = (arr * 255).astype(np.uint8)
    if arr.shape[2] != size:
        x = _pillow_pass(x, _pillow_coeffs(arr.shape[2], size), 2)
    if arr.shape[1] != size:
        x = _pillow_pass(x, _pillow_coeffs(arr.shape[1], size), 1)
    return x.astype(np.float32) / 255.0


def load_frames_for(stem: str, n_frames: int, size: int,
                    window: tuple[float, float] | None = None) -> np.ndarray:
    """The frames of `<stem>` in the layout found first: `.npy`, then a
    frame directory, then video. `window` = (t0_frac, t1_frac) of the
    source's duration picks the frames aligned with the audio crop."""
    if os.path.exists(stem + ".npy"):
        arr = np.load(stem + ".npy", mmap_mode="r")
        if arr.dtype == np.uint8 and arr.flags.c_contiguous:
            return native.load_frames(stem + ".npy", n_frames, size, window)
        return resample_frames(arr, n_frames, size, window)
    if os.path.isdir(stem):
        raise NotImplementedError(
            f"{stem}/: a directory of image frames is not read by "
            f"viai_tpu_torch (the JAX package decodes it with PIL); store "
            f"the clip's frames as {os.path.basename(stem)}.npy, a "
            f"(T, H, W, 3) uint8 stack, or as an uncompressed AVI")
    if os.path.exists(stem + ".avi"):
        return native.load_frames(stem + ".avi", n_frames, size, window)
    for ext in COMPRESSED_VIDEO:
        if os.path.exists(stem + ext):
            raise NotImplementedError(
                f"{stem}{ext}: compressed video is not read by "
                f"viai_tpu_torch (the JAX package decodes it with cv2); "
                f"store the clip's frames as {os.path.basename(stem)}.npy "
                f"or as an uncompressed AVI")
    raise FileNotFoundError(f"no frame source for {stem}")


def _crop_window(start: int, clip_samples: int, total: int):
    """Audio crop (start, clip_samples, source total) → frame-window
    fractions. Short sources (total ≤ clip) span the whole video."""
    if total <= 0 or total <= clip_samples:
        return (0.0, 1.0)
    return (start / total, min((start + clip_samples) / total, 1.0))


class AVFolderDataset(AudioFolderDataset):
    """idx → {'wav': (S,), 'frames': (T, H, W, 3) float32 in [0, 1]}, the
    frames those of the audio crop."""

    def __init__(self, root: str, clip_samples: int = 32000,
                 sample_rate: int = 16000, n_frames: int = 16,
                 frame_size: int = 64, seed: int = 0):
        super().__init__(root, clip_samples, sample_rate, seed)
        self.n_frames = n_frames
        self.frame_size = frame_size

    def __getitem__(self, idx: int):
        item, start, total = self.load_cropped(idx)
        stem = os.path.splitext(self.paths[int(idx) % len(self.paths)])[0]
        item["frames"] = load_frames_for(
            stem, self.n_frames, self.frame_size,
            window=_crop_window(start, self.clip_samples, total))
        return item


class MusicesManifest:
    """A MUSICES.json-style manifest: split → clip list.

    Schema: {"train": [{"audio": path, "frames": path}, ...], "test":
    [...]}, paths relative to the manifest's directory; "frames" is
    optional.
    """

    def __init__(self, manifest_path: str, split: str = "train",
                 clip_samples: int = 32000, sample_rate: int = 16000,
                 n_frames: int = 16, frame_size: int = 64, seed: int = 0):
        with open(manifest_path) as f:
            manifest = json.load(f)
        if split not in manifest:
            raise KeyError(f"split {split!r} not in manifest")
        base = os.path.dirname(os.path.abspath(manifest_path))
        self.entries = [
            {"audio": os.path.join(base, e["audio"]),
             "frames": (os.path.join(base, e["frames"]) if "frames" in e
                        else None)}
            for e in manifest[split]]
        self.clip_samples = clip_samples
        self.sample_rate = sample_rate
        self.n_frames = n_frames
        self.frame_size = frame_size
        self.seed = seed

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, idx: int):
        e = self.entries[int(idx) % len(self.entries)]
        wav = load_wav(e["audio"], self.sample_rate)
        rng = np.random.default_rng((self.seed, int(idx)))
        clip, start, total = crop_with_info(wav, self.clip_samples, rng)
        item = {"wav": clip}
        if e["frames"]:
            stem = os.path.splitext(e["frames"])[0]
            item["frames"] = load_frames_for(
                stem, self.n_frames, self.frame_size,
                window=_crop_window(start, self.clip_samples, total))
        return item
