"""Evaluation metrics — spectrogram PSNR, waveform SNR, spectral
convergence.

Port of `viai_tpu/utils/metrics.py`: batch-leading reductions over every
trailing axis, one value per clip, float32.
"""

from __future__ import annotations

import torch

from ..signal.stft import STFTConfig, stft_magnitude


def _trailing(x: torch.Tensor) -> tuple[int, ...]:
    return tuple(range(1, x.dim()))


def psnr(pred: torch.Tensor, target: torch.Tensor,
         data_range: float = 2.0) -> torch.Tensor:
    """Peak SNR in dB. Default range 2.0 = the [-1, 1] image convention."""
    mse = ((pred - target) ** 2).mean(_trailing(pred))
    return 10.0 * torch.log10(data_range**2 / mse.clamp_min(1e-12))


def snr(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Waveform SNR in dB over the batch's trailing axes."""
    axes = _trailing(pred)
    sig = (target**2).sum(axes)
    err = ((pred - target) ** 2).sum(axes)
    return 10.0 * torch.log10(sig.clamp_min(1e-12) / err.clamp_min(1e-12))


def masked_psnr(pred: torch.Tensor, target: torch.Tensor,
                keep_mask: torch.Tensor,
                data_range: float = 2.0) -> torch.Tensor:
    """PSNR restricted to the inpainted hole (keep_mask == 0)."""
    hole = 1.0 - keep_mask
    axes = _trailing(pred)
    mse = (((pred - target) ** 2) * hole).sum(axes) / hole.sum(
        axes).clamp_min(1.0)
    return 10.0 * torch.log10(data_range**2 / mse.clamp_min(1e-12))


def spectral_convergence(pred_wav: torch.Tensor, target_wav: torch.Tensor,
                         stft_cfg: STFTConfig) -> torch.Tensor:
    """‖|S_pred| − |S_tgt|‖_F / ‖|S_tgt|‖_F per clip (0 = magnitudes
    identical; phase differences do not count)."""
    mp = stft_magnitude(pred_wav, stft_cfg)
    mt = stft_magnitude(target_wav, stft_cfg)
    axes = _trailing(mp)
    num = torch.sqrt(((mp - mt) ** 2).sum(axes))
    den = torch.sqrt((mt**2).sum(axes))
    return num / den.clamp_min(1e-12)
