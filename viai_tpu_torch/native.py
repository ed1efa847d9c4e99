"""ctypes bindings of the port's native host library (csrc/wavio.cpp,
csrc/framestack.cpp).

The port's copy of `viai_tpu/native/__init__.py`: WAV decode and linear
resampling, the frame-stack reader (npy uint8 stacks and uncompressed
AVI: window select, Pillow-style triangle resize, [0, 1] float32) and
the threaded random-crop clip loader. `_build.py` compiles the library
with g++ at first use; a failed build raises, and there is no flag to
go without it (the JAX module falls back to numpy quietly).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from . import _build

_F32P = ctypes.POINTER(ctypes.c_float)
MAX_WAV_SAMPLES = 16000 * 600


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The library, built if needed, with every function's types."""
    lib = _build.library("native")
    lib.viai_decode_wav.restype = ctypes.c_int64
    lib.viai_decode_wav.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, _F32P, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32)]
    lib.viai_resample_linear.restype = None
    lib.viai_resample_linear.argtypes = [
        _F32P, ctypes.c_int64, ctypes.c_int32, _F32P, ctypes.c_int64,
        ctypes.c_int32]
    lib.viai_loader_create.restype = ctypes.c_void_p
    lib.viai_loader_create.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int64, ctypes.c_uint64]
    lib.viai_loader_next.restype = ctypes.c_int32
    lib.viai_loader_next.argtypes = [ctypes.c_void_p, _F32P]
    lib.viai_loader_destroy.restype = None
    lib.viai_loader_destroy.argtypes = [ctypes.c_void_p]
    lib.viai_load_frames.restype = ctypes.c_int32
    lib.viai_load_frames.argtypes = [
        ctypes.c_char_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_float,
        ctypes.c_float, _F32P]
    return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_F32P)


def decode_wav(data: bytes, max_samples: int = MAX_WAV_SAMPLES
               ) -> tuple[np.ndarray, int]:
    """WAV bytes → (mono float32 samples, sample rate): PCM 8/16/24/32
    or float32, channels averaged, at most `max_samples`. Raises
    ValueError on a buffer it cannot decode."""
    out = np.empty(max_samples, np.float32)
    sr = ctypes.c_int32(0)
    n = library().viai_decode_wav(data, len(data), _ptr(out), max_samples,
                                  ctypes.byref(sr))
    if n < 0:
        raise ValueError("not a decodable WAV buffer")
    return out[:n].copy(), int(sr.value)


def resample_linear(x: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Linear interpolation of x at sr_in onto int(len·sr_out/sr_in)
    samples at sr_out."""
    x = np.ascontiguousarray(x, np.float32)
    out = np.empty(int(len(x) * sr_out / sr_in), np.float32)
    library().viai_resample_linear(_ptr(x), len(x), sr_in, _ptr(out),
                                   len(out), sr_out)
    return out


# viai_load_frames' codes for a container it does not read.
UNSUPPORTED = {-11: "npy stack of another dtype than uint8",
               -12: "Fortran-ordered npy stack",
               -13: "npy stack not shaped (T, H, W, 3)",
               -22: "compressed or top-down 24-bit AVI video"}


def load_frames(path: str, n_frames: int, size: int,
                window: tuple[float, float] | None = None) -> np.ndarray:
    """A `.npy` uint8 (T, H, W, 3) stack or an uncompressed AVI →
    (n_frames, size, size, 3) float32 in [0, 1]: frames at
    round(linspace(w0·(T−1), w1·(T−1), n_frames)) over the fractional
    `window` of the source (all of it by default), each resized with a
    Pillow-style triangle filter. Raises NotImplementedError, naming the
    layout, for a container it does not read, ValueError for a broken
    file."""
    w0, w1 = (0.0, 1.0) if window is None else window
    out = np.empty((n_frames, size, size, 3), np.float32)
    rc = library().viai_load_frames(path.encode(), n_frames, size,
                                    ctypes.c_float(w0), ctypes.c_float(w1),
                                    _ptr(out))
    if rc in UNSUPPORTED:
        raise NotImplementedError(f"{path}: {UNSUPPORTED[rc]} is not read "
                                  f"by viai_tpu_torch")
    if rc != 0:
        raise ValueError(f"native frame decode failed ({rc}) for {path}")
    return out


class NativeClipLoader:
    """Threaded random-crop WAV batch loader (a C++ worker pool).

    Each worker's file and crop stream is a function of (seed, worker),
    and each worker assembles whole batches: one worker gives a
    reproducible batch sequence; with more, the interleaving of the
    workers' batches depends on thread scheduling. Files are drawn with
    replacement, forever (no epochs).
    """

    def __init__(self, paths, clip_samples: int, target_sr: int = 16000,
                 batch: int = 16, n_workers: int = 4, queue_depth: int = 8,
                 seed: int = 0):
        lib = library()
        blob = "\n".join(str(p) for p in paths).encode()
        self._lib = lib
        self._handle = lib.viai_loader_create(
            blob, clip_samples, target_sr, batch, n_workers, queue_depth,
            seed)
        if not self._handle:
            raise ValueError("no usable paths given to NativeClipLoader")
        self.batch = batch
        self.clip_samples = clip_samples

    def next(self) -> np.ndarray:
        out = np.empty((self.batch, self.clip_samples), np.float32)
        if self._lib.viai_loader_next(self._handle, _ptr(out)) != 0:
            raise StopIteration
        return out

    def __iter__(self):
        return self

    def __next__(self):
        return self.next()

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.viai_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()
