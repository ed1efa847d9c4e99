"""STFT / iSTFT as DFT-basis matrix products, in PyTorch.

Port of `viai_tpu/signal/stft.py`. The bases are built in float64
numpy and stored as float32, exactly as the JAX package builds them, so
both packages multiply by the same numbers. The products are
`torch.matmul` in float32; on a CUDA card the caller keeps
`torch.backends.cuda.matmul.allow_tf32` False (PyTorch's default) so
they stay in full float32, as the JAX side runs at precision="highest".

Semantics (librosa / torch.stft compatible):
  * center=True → reflect-pad by n_fft//2
  * periodic Hann window of win_length, zero-centered in n_fft
  * n_fft=510 → exactly 256 = n_fft//2 + 1 frequency bins
  * istft uses window-sum-square normalization
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class STFTConfig:
    """Static STFT parameters (hashable, so usable as a cache key)."""

    n_fft: int = 510          # 510 → n_fft//2 + 1 == 256 bins
    hop_length: int = 128
    win_length: int | None = None  # defaults to n_fft
    center: bool = True
    pad_mode: str = "reflect"

    @property
    def win(self) -> int:
        return self.win_length if self.win_length is not None else self.n_fft

    @property
    def n_bins(self) -> int:
        return self.n_fft // 2 + 1

    def num_frames(self, n_samples: int) -> int:
        if self.center:
            return 1 + n_samples // self.hop_length
        return 1 + (n_samples - self.n_fft) // self.hop_length


def hann_window(win_length: int, dtype=np.float32) -> np.ndarray:
    """Periodic Hann, identical to torch.hann_window / librosa default."""
    n = np.arange(win_length, dtype=np.float64)
    w = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / win_length))
    return w.astype(dtype)


def _padded_window(cfg: STFTConfig) -> np.ndarray:
    """Window of win_length zero-centered inside n_fft (librosa util.pad_center)."""
    w = hann_window(cfg.win)
    if cfg.win < cfg.n_fft:
        lpad = (cfg.n_fft - cfg.win) // 2
        w = np.pad(w, (lpad, cfg.n_fft - cfg.win - lpad))
    return w


@functools.lru_cache(maxsize=8)
def _dft_bases(n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """Forward rDFT bases: frames @ cos_b → Re, frames @ sin_b → Im.

    cos_b[n, k] =  cos(2π k n / N);  sin_b[n, k] = -sin(2π k n / N)
    so that S[k] = Σ_n x[n] e^{-2πikn/N} matches np.fft.rfft exactly.
    """
    n = np.arange(n_fft, dtype=np.float64)[:, None]
    k = np.arange(n_fft // 2 + 1, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    return np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _idft_bases(n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """Inverse rDFT bases: Re @ icos + Im @ isin → frames (np.fft.irfft).

    Imag parts of DC/Nyquist are discarded, exactly as np.fft.irfft does.
    """
    if n_fft % 2:
        raise ValueError(f"n_fft must be even, got {n_fft}")
    n_bins = n_fft // 2 + 1
    k = np.arange(n_bins, dtype=np.float64)[:, None]
    n = np.arange(n_fft, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * k * n / n_fft
    coef = np.full((n_bins, 1), 2.0 / n_fft)
    coef[0] = coef[-1] = 1.0 / n_fft
    icos = coef * np.cos(ang)
    isin = -coef * np.sin(ang)
    isin[0] = 0.0   # DC imag ignored
    isin[-1] = 0.0  # Nyquist imag ignored
    return icos.astype(np.float32), isin.astype(np.float32)


@functools.lru_cache(maxsize=8)
def _window_sumsquare(cfg: STFTConfig, n_frames: int) -> np.ndarray:
    """Σ_f w²[t − f·hop] envelope for ISTFT normalization (librosa)."""
    w2 = _padded_window(cfg) ** 2
    total = cfg.n_fft + cfg.hop_length * (n_frames - 1)
    env = np.zeros(total, dtype=np.float64)
    for f in range(n_frames):
        env[f * cfg.hop_length : f * cfg.hop_length + cfg.n_fft] += w2
    return env.astype(np.float32)


@functools.lru_cache(maxsize=16)
def _device_consts(cfg: STFTConfig, device: torch.device) -> dict:
    """Window and DFT bases of `cfg` as float32 tensors on `device`."""
    cos_b, sin_b = _dft_bases(cfg.n_fft)
    icos, isin = _idft_bases(cfg.n_fft)
    arrs = {"win": _padded_window(cfg), "cos": cos_b, "sin": sin_b,
            "icos": icos, "isin": isin}
    return {k: torch.from_numpy(v).to(device) for k, v in arrs.items()}


@functools.lru_cache(maxsize=16)
def _device_env(cfg: STFTConfig, n_frames: int,
                device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_window_sumsquare(cfg, n_frames)).to(device)


def frame_signal(x: torch.Tensor, cfg: STFTConfig) -> torch.Tensor:
    """(..., T) → (..., F, n_fft) frames, with librosa center padding."""
    if cfg.center:
        pad = cfg.n_fft // 2
        lead = x.shape[:-1]
        # F.pad's reflect mode wants a (N, C, T) tensor.
        x = F.pad(x.reshape(-1, 1, x.shape[-1]), (pad, pad),
                  mode=cfg.pad_mode).reshape(*lead, -1)
    return x.unfold(-1, cfg.n_fft, cfg.hop_length)


def stft(x: torch.Tensor, cfg: STFTConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., T) float waveform → (Re, Im), each (..., F, n_bins)."""
    c = _device_consts(cfg, x.device)
    fw = frame_signal(x.float(), cfg) * c["win"]
    return torch.matmul(fw, c["cos"]), torch.matmul(fw, c["sin"])


def stft_magnitude(x: torch.Tensor, cfg: STFTConfig,
                   eps: float = 1e-9) -> torch.Tensor:
    re, im = stft(x, cfg)
    return torch.sqrt(re * re + im * im + eps)


def overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """(..., F, n_fft) → (..., hop·(F−1) + n_fft) via K shifted adds."""
    *lead, n_frames, n_fft = frames.shape
    k_chunks = math.ceil(n_fft / hop)
    padded = F.pad(frames, (0, k_chunks * hop - n_fft))
    # (..., F, K, hop): chunk c of frame f lands at output chunk f + c.
    chunks = padded.reshape(*lead, n_frames, k_chunks, hop)
    out_chunks = frames.new_zeros((*lead, n_frames + k_chunks - 1, hop))
    for c in range(k_chunks):
        out_chunks[..., c : c + n_frames, :] += chunks[..., :, c, :]
    out = out_chunks.reshape(*lead, (n_frames + k_chunks - 1) * hop)
    return out[..., : hop * (n_frames - 1) + n_fft]


def istft(
    re: torch.Tensor,
    im: torch.Tensor,
    cfg: STFTConfig,
    length: int | None = None,
) -> torch.Tensor:
    """(..., F, n_bins) Re/Im → (..., T) waveform (librosa.istft semantics)."""
    c = _device_consts(cfg, re.device)
    frames = torch.matmul(re, c["icos"]) + torch.matmul(im, c["isin"])
    y = overlap_add(frames * c["win"], cfg.hop_length)
    n_frames = re.shape[-2]
    env = _device_env(cfg, n_frames, re.device)
    y = y / torch.clamp(env, min=1e-10)
    if cfg.center:
        y = y[..., cfg.n_fft // 2 :]
        expected = cfg.hop_length * (n_frames - 1) - 2 * (cfg.n_fft // 2) + cfg.n_fft
        if length is None:
            length = expected
    if length is not None:
        y = y[..., :length]
    return y
