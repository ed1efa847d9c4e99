"""Inpainting time masks, in PyTorch.

Port of `viai_tpu/signal/mask.py`. Convention: 1.0 = KEEP (observed),
0.0 = HOLE (to inpaint); `apply_mask` zeroes the hole.

The gaps are drawn from an explicit `torch.Generator` with the JAX
package's distribution: per gap a length uniform in [min, max], a start
uniform in [0, max(n − length, 1)) (or `fixed_start`), `num_gaps`
independent gaps per clip. The bits are not JAX's (threefry), so code
that must reproduce a JAX mask takes the mask itself (the train step's
`tmask=`).
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


def sample_batch_masks(generator: torch.Generator, batch: int, n_frames: int,
                       cfg: MaskConfig) -> torch.Tensor:
    """→ (batch, n_frames) float32 masks on the generator's device, one
    independent gap set per clip: 0 inside the gap(s), 1 elsewhere."""
    dev = generator.device
    shape = (batch, cfg.num_gaps)
    gap = torch.randint(cfg.min_gap_frames, cfg.max_gap_frames + 1, shape,
                        generator=generator, device=dev)
    if cfg.fixed_start is not None:
        start = torch.full(shape, cfg.fixed_start, device=dev)
    else:
        span = torch.clamp(n_frames - gap, min=1)
        u = torch.rand(shape, generator=generator, device=dev,
                       dtype=torch.float64)
        start = torch.minimum((u * span).long(), span - 1)
    t = torch.arange(n_frames, device=dev)[None, None, :]
    hole = (t >= start[..., None]) & (t < (start + gap)[..., None])
    return (~hole.any(dim=1)).float()


def sample_time_mask(generator: torch.Generator, n_frames: int,
                     cfg: MaskConfig) -> torch.Tensor:
    """→ (n_frames,) float32 mask; 0 inside the sampled gap(s)."""
    return sample_batch_masks(generator, 1, n_frames, cfg)[0]


def apply_mask(spec: torch.Tensor, time_mask: torch.Tensor) -> torch.Tensor:
    """spec (..., n_bins, n_frames) × mask (..., n_frames) → masked spec."""
    return spec * time_mask[..., None, :]


def expand_to_image(time_mask: torch.Tensor, n_bins: int) -> torch.Tensor:
    """(..., n_frames) → (..., n_bins, n_frames) full-image mask channel."""
    return time_mask[..., None, :].expand(
        *time_mask.shape[:-1], n_bins, time_mask.shape[-1])
