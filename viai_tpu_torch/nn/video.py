"""3D-conv video feature extractor of the vision-infused branch.

Port of `viai_tpu/nn/video.py`: (B, T, H, W, 3) frames → (B, out_time,
out_features) features, aligned with G's bottleneck time axis. The
convs compute in NCDHW; frames and features keep the JAX package's
layouts. Per level: Conv3d(3x3x3, stride (t, h, w), flax SAME padding)
→ GroupNorm(min(8, C)) → ReLU; then the mean over H and W, a resize
of the time axis to `out_time`, and a linear projection; float32 out.

The resize is `jax.image.resize(..., "linear")`: half-pixel centres, a
triangle kernel that is widened by the scale when downsampling
(antialiasing), taps outside the input dropped and the rest
renormalised. `F.interpolate` agrees with it only when upsampling, so
the port builds the same (T′, out_time) weight matrix and multiplies.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .generator import (GroupNorm, Linear, compute_dtype, init_parameters,
                        same_pad)


@dataclasses.dataclass(frozen=True)
class VideoNetConfig:
    in_channels: int = 3
    base: int = 32
    # (t, h, w) strides per level; defaults eat 64x64 frames → 4x4.
    strides: tuple[tuple[int, int, int], ...] = (
        (1, 2, 2), (1, 2, 2), (2, 2, 2), (2, 2, 2)
    )
    mults: tuple[int, ...] = (1, 2, 4, 8)
    out_features: int = 256   # fusion channel width
    out_time: int = 16        # generator bottleneck time axis
    dtype: str = "float32"
    init_type: str = "normal"
    init_gain: float = 0.02


def linear_resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) float32 weights of `jax.image.resize` with method
    "linear" and antialias=True along one axis, computed as
    `jax._src.image.scale.compute_weight_mat` computes them
    (translation 0): column j holds the taps of output sample j."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample = (np.arange(n_out) + 0.5) * inv_scale - 0.5
    x = np.abs(sample[None, :] - np.arange(n_in)[:, None]) / kernel_scale
    w = np.maximum(0.0, 1.0 - x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0.0).astype(np.float32)


def resize_time(h: torch.Tensor, n_out: int) -> torch.Tensor:
    """(B, C, T′) → (B, C, n_out), the last axis resized as
    `jax.image.resize(..., "linear")` resizes it."""
    if h.shape[-1] == n_out:
        return h
    w = torch.from_numpy(linear_resize_weights(h.shape[-1], n_out))
    return torch.matmul(h, w.to(device=h.device, dtype=h.dtype))


class SameConv3d(nn.Conv3d):
    """Conv3d with flax SAME padding, in the input's dtype."""

    def __init__(self, cin, cout, k, stride):
        super().__init__(cin, cout, k, stride=stride, padding=0)

    def forward(self, x):
        return self._conv_forward(same_pad(x, self), self.weight.to(x.dtype),
                                  self.bias.to(x.dtype))


class VideoFeatureNet(nn.Module):
    """(B, T, H, W, in_channels) frames → (B, out_time, out_features),
    float32. Weights are drawn from `generator` (a torch.Generator)
    with the config's kernel init; biases zero, norm scales one."""

    def __init__(self, cfg: VideoNetConfig,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        self.dtype = compute_dtype(cfg.dtype)
        chans = [cfg.in_channels] + [m * cfg.base for m in cfg.mults]
        self.convs = nn.ModuleList(
            SameConv3d(chans[i], chans[i + 1], 3, s)
            for i, s in enumerate(cfg.strides))
        self.norms = nn.ModuleList(
            GroupNorm(c, min(8, c)) for c in chans[1:])
        self.proj = Linear(chans[-1], cfg.out_features)
        init_parameters(self, cfg.init_type, cfg.init_gain, generator)

    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        h = frames.to(self.dtype).permute(0, 4, 1, 2, 3)     # NCDHW
        for conv, norm in zip(self.convs, self.norms):
            h = F.relu(norm(conv(h)))
        h = resize_time(h.mean(dim=(3, 4)), self.cfg.out_time)  # (B, C, T)
        return self.proj(h.transpose(1, 2)).float()
