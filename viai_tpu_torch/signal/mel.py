"""Magnitude ↔ network-image compressions, in PyTorch.

Port of the image compressions of `viai_tpu/signal/mel.py`: log1p
compression to the [-1, 1] network range, its inverse, and the
energy-preserving contrast sharpening applied before Griffin-Lim.
"""

from __future__ import annotations

import torch


def compress(mag: torch.Tensor, ceiling: float = 6.0) -> torch.Tensor:
    """Magnitude → [-1, 1] image: log1p then affine. Invertible."""
    return torch.clamp(torch.log1p(mag) / ceiling, 0.0, 1.0) * 2.0 - 1.0


def decompress(img: torch.Tensor, ceiling: float = 6.0) -> torch.Tensor:
    """[-1, 1] image → magnitude (inverse of `compress`)."""
    return torch.expm1(torch.clamp((img + 1.0) * 0.5, 0.0, 1.0) * ceiling)


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
