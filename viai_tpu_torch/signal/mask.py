"""Inpainting time masks, in PyTorch.

Port of `viai_tpu/signal/mask.py`'s mask algebra. Convention: 1.0 = KEEP
(observed), 0.0 = HOLE (to inpaint); `apply_mask` zeroes the hole.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class MaskConfig:
    """Gap sampling parameters, in spectrogram frames (time axis)."""

    min_gap_frames: int = 25    # ~0.2 s at hop 128 / 16 kHz
    max_gap_frames: int = 50    # ~0.4 s
    num_gaps: int = 1
    fixed_start: int | None = None


def apply_mask(spec: torch.Tensor, time_mask: torch.Tensor) -> torch.Tensor:
    """spec (..., n_bins, n_frames) × mask (..., n_frames) → masked spec."""
    return spec * time_mask[..., None, :]


def expand_to_image(time_mask: torch.Tensor, n_bins: int) -> torch.Tensor:
    """(..., n_frames) → (..., n_bins, n_frames) full-image mask channel."""
    return time_mask[..., None, :].expand(
        *time_mask.shape[:-1], n_bins, time_mask.shape[-1])
