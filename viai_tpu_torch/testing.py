"""Tiny model and config builders shared by tests and chip_smoke.py.

The port's copy of `viai_tpu/testing.py`: miniature versions of the
real networks (the same code paths, ~1000x fewer FLOPs) for integration
tests and the multi-rank checks.
"""

from __future__ import annotations

import numpy as np
import torch

from ._device import resolve_device
from .nn import (DiscriminatorConfig, GeneratorConfig, PatchDiscriminator,
                 UNetGenerator, VideoFeatureNet, VideoNetConfig)
from .signal import MaskConfig, STFTConfig
from .train import TrainConfig

TINY_STFT = STFTConfig(n_fft=126, hop_length=64)  # 64 bins
TINY_CFG = TrainConfig(
    stft=TINY_STFT,
    mask=MaskConfig(min_gap_frames=8, max_gap_frames=16),
    image_frames=64,
    lambda_l1=100.0,
    n_bins=TINY_STFT.n_fft // 2 + 1,
)


def tiny_models(use_video: bool = False, seed: int = 0,
                device: str | torch.device = "cuda"):
    """(G, D, V) sized for 64x64 spectrogram images, weights drawn from
    `seed`, on `device`; V is None without `use_video`."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    gcfg = GeneratorConfig(ngf=8, strides=((2, 2), (2, 2), (2, 1)),
                           mults=(1, 2, 4))
    G = UNetGenerator(gcfg, gen, fusion_channels=16 if use_video else 0)
    D = PatchDiscriminator(
        DiscriminatorConfig(in_channels=3, ndf=8, n_layers=2), gen)
    V = None
    if use_video:
        V = VideoFeatureNet(
            VideoNetConfig(base=4, mults=(1, 2), strides=((1, 2, 2), (2, 2, 2)),
                           out_features=16, out_time=16),  # = G's bottleneck
            gen).to(dev)
    return G.to(dev), D.to(dev), V


def tone_batch(batch: int = 4, n: int = 4032, seed: int = 0) -> np.ndarray:
    """Batch of random-pitch sine clips (deterministic)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    f = rng.uniform(100, 1000, size=(batch, 1))
    return (0.3 * np.sin(2 * np.pi * f * t)).astype(np.float32)
