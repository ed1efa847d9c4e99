"""Network factories — the reference's `define_G`/`define_D`/`define_V`
surface and the refiner's `define_R`, in PyTorch.

Port of `viai_tpu/nn/factory.py`, with the same
defaults and a `device` (the card unless the caller asks for the CPU).
Weights are drawn on the CPU, so a seed gives the same weights on
every device.
"""

from __future__ import annotations

import torch

from .._device import resolve_device
from .discriminator import (DiscriminatorConfig, MultiScaleDiscriminator,
                            PatchDiscriminator)
from .generator import GeneratorConfig, UNetGenerator
from .refiner import DiffusionRefiner, RefinerConfig
from .video import VideoFeatureNet, VideoNetConfig


def define_G(
    input_nc: int = 2,
    output_nc: int = 1,
    ngf: int = 64,
    norm: str = "instance",
    dtype: str = "float32",
    fusion_channels: int = 0,
    seed: int = 0,
    upsample: str = "deconv",
    init_type: str = "normal",
    init_gain: float = 0.02,
    dropout: float = 0.0,
    bottleneck_dilation: tuple[int, ...] = (),
    bottleneck_attn: int = 0,
    attn_heads: int = 8,
    gated: bool = False,
    device: str | torch.device = "cuda",
) -> UNetGenerator:
    """A U-Net G with weights drawn from `seed`, in eval mode on `device`."""
    dev = resolve_device(device)
    cfg = GeneratorConfig(
        in_channels=input_nc, out_channels=output_nc, ngf=ngf,
        norm=norm, dtype=dtype, upsample=upsample,
        init_type=init_type, init_gain=init_gain, dropout=dropout,
        bottleneck_dilation=tuple(bottleneck_dilation),
        bottleneck_attn=bottleneck_attn, attn_heads=attn_heads,
        gated=gated,
    )
    G = UNetGenerator(cfg, torch.Generator().manual_seed(seed),
                      fusion_channels=fusion_channels)
    return G.to(dev).eval()


def define_D(
    input_nc: int = 1,
    ndf: int = 64,
    n_layers_D: int = 3,
    norm: str = "instance",
    dtype: str = "float32",
    seed: int = 1,
    init_type: str = "normal",
    init_gain: float = 0.02,
    num_D: int = 1,
    device: str | torch.device = "cuda",
) -> PatchDiscriminator | MultiScaleDiscriminator:
    """A PatchGAN D with weights drawn from `seed`, on `device`; num_D
    > 1 builds the multi-scale ensemble. VIAIModel seeds it with G's
    seed + 1."""
    dev = resolve_device(device)
    cfg = DiscriminatorConfig(
        in_channels=input_nc, ndf=ndf, n_layers=n_layers_D, norm=norm,
        dtype=dtype, init_type=init_type, init_gain=init_gain,
    )
    gen = torch.Generator().manual_seed(seed)
    D = (MultiScaleDiscriminator(cfg, num_D, gen) if num_D > 1
         else PatchDiscriminator(cfg, gen))
    return D.to(dev)


def define_V(
    out_features: int = 256,
    out_time: int = 16,
    base: int = 32,
    dtype: str = "float32",
    seed: int = 2,
    init_type: str = "normal",
    init_gain: float = 0.02,
    device: str | torch.device = "cuda",
) -> VideoFeatureNet:
    """The video feature net with weights drawn from `seed`, in eval
    mode on `device`. VIAIModel seeds it with G's seed + 2."""
    dev = resolve_device(device)
    cfg = VideoNetConfig(
        base=base, out_features=out_features, out_time=out_time,
        dtype=dtype, init_type=init_type, init_gain=init_gain,
    )
    V = VideoFeatureNet(cfg, torch.Generator().manual_seed(seed))
    return V.to(dev).eval()


def define_R(
    in_channels: int,
    ngf: int = 64,
    norm: str = "instance",
    dtype: str = "float32",
    seed: int = 0,
    init_type: str = "normal",
    init_gain: float = 0.02,
    out_channels: int = 1,
    device: str | torch.device = "cuda",
) -> DiffusionRefiner:
    """The diffusion refiner with weights drawn from `seed`, in eval mode
    on `device`. out_channels 1: the magnitude-domain v̂; 2: the
    complex-domain (re, im) v̂. VIAIModel seeds it with G's seed + 3."""
    dev = resolve_device(device)
    cfg = RefinerConfig(in_channels=in_channels, out_channels=out_channels,
                        ngf=ngf, norm=norm, dtype=dtype, init_type=init_type,
                        init_gain=init_gain)
    R = DiffusionRefiner(cfg, torch.Generator().manual_seed(seed))
    return R.to(dev).eval()
