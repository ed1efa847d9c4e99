"""Mel filterbank and the magnitude ↔ network-image compressions, in
PyTorch.

Port of `viai_tpu/signal/mel.py`: the Slaney mel scale and filterbank
(numpy, as the JAX package builds it, so both packages multiply by the
same numbers), its application, log1p compression to the [-1, 1]
network range and its inverse, the complex compression that keeps the
phase, and the energy-preserving contrast sharpening applied before
Griffin-Lim.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def hz_to_mel(f, htk: bool = False):
    f = np.asarray(f, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    # Slaney: linear below 1 kHz, log above (librosa default).
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (f - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    safe_f = np.maximum(f, 1e-10)
    return np.where(
        f >= min_log_hz,
        min_log_mel + np.log(safe_f / min_log_hz) / logstep,
        mels,
    )


def mel_to_hz(m, htk: bool = False):
    m = np.asarray(m, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * m
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(
        m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs
    )


@functools.lru_cache(maxsize=8)
def mel_filterbank(
    sr: int,
    n_fft: int,
    n_mels: int = 80,
    fmin: float = 0.0,
    fmax: float | None = None,
    htk: bool = False,
) -> np.ndarray:
    """(n_fft//2+1, n_mels) triangular filterbank, Slaney-normalized."""
    fmax = fmax or sr / 2.0
    n_bins = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sr / 2.0, n_bins)
    mel_pts = mel_to_hz(
        np.linspace(hz_to_mel(fmin, htk), hz_to_mel(fmax, htk), n_mels + 2), htk
    )
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    fb = np.maximum(0.0, np.minimum(lower, upper))
    # Slaney area normalization.
    enorm = 2.0 / (mel_pts[2 : n_mels + 2] - mel_pts[:n_mels])
    fb *= enorm[:, None]
    return fb.T.astype(np.float32)


def apply_mel(mag: torch.Tensor, fb) -> torch.Tensor:
    """(..., n_frames, n_bins) magnitude → (..., n_frames, n_mels), in
    float32 (the caller keeps TF32 off on a card)."""
    fb = torch.as_tensor(np.asarray(fb), device=mag.device)
    return torch.matmul(mag, fb)


def compress(mag: torch.Tensor, ceiling: float = 6.0) -> torch.Tensor:
    """Magnitude → [-1, 1] image: log1p then affine. Invertible."""
    return torch.clamp(torch.log1p(mag) / ceiling, 0.0, 1.0) * 2.0 - 1.0


def decompress(img: torch.Tensor, ceiling: float = 6.0) -> torch.Tensor:
    """[-1, 1] image → magnitude (inverse of `compress`)."""
    return torch.expm1(torch.clamp((img + 1.0) * 0.5, 0.0, 1.0) * ceiling)


def complex_compress(re: torch.Tensor, im: torch.Tensor,
                     ceiling: float = 6.0) -> tuple[torch.Tensor, torch.Tensor]:
    """Complex STFT → magnitude-log-compressed complex channels: the
    phase is kept exactly and the magnitude goes through `compress`'s
    log1p/ceiling map without the [-1, 1] affine, so |output| ∈ [0, 1]
    with silence at 0. Inverse: `complex_decompress`."""
    mag = torch.sqrt(re * re + im * im)
    scale = torch.clamp(torch.log1p(mag) / ceiling, 0.0, 1.0) / torch.clamp(
        mag, min=1e-12)
    return re * scale, im * scale


def complex_decompress(cre: torch.Tensor, cim: torch.Tensor,
                       ceiling: float = 6.0) -> tuple[torch.Tensor, torch.Tensor]:
    """Inverse of `complex_compress` (phase preserved exactly)."""
    cmag = torch.sqrt(cre * cre + cim * cim)
    mag = torch.expm1(torch.clamp(cmag, 0.0, 1.0) * ceiling)
    scale = mag / torch.clamp(cmag, min=1e-12)
    return cre * scale, cim * scale


def sharpen_mag(mag: torch.Tensor, gamma: float,
                axis: int = -2) -> torch.Tensor:
    """Energy-preserving spectral contrast sharpening.

    Raises each magnitude to ``gamma`` then rescales every frame (the
    ``axis`` dimension holds the frequency bins) so its L2 energy is
    unchanged. gamma == 1 is the identity.
    """
    if gamma == 1.0:
        return mag
    p = torch.pow(torch.clamp(mag, min=0.0), gamma)
    e0 = torch.sum(mag * mag, dim=axis, keepdim=True)
    e1 = torch.sum(p * p, dim=axis, keepdim=True)
    return p * torch.sqrt(e0 / (e1 + 1e-12))
