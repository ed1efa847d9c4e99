"""PatchGAN discriminator D on spectrograms, in PyTorch.

Port of `viai_tpu/nn/discriminator.py`. NCHW in, raw logits out:
4x4 convs with flax SAME padding (stride 2, the last one stride 1),
the first without a norm, LeakyReLU(0.2), a 4x4 head to one channel in
float32. The module tree carries the flax names (`convs.{i}`,
`norms.{i}`, `head`; `nets.{k}.…` in the multi-scale ensemble) so the
weight bridge maps D as it maps G; `norms.0` is an `nn.Identity`
placeholder and carries no weights.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from .generator import _norm, _SameConv, compute_dtype, init_parameters


@dataclasses.dataclass(frozen=True)
class DiscriminatorConfig:
    in_channels: int = 1
    ndf: int = 64
    n_layers: int = 3
    norm: str = "instance"
    dtype: str = "float32"
    init_type: str = "normal"
    init_gain: float = 0.02


class PatchDiscriminator(nn.Module):
    """(B, in_channels, H, W) → (B, 1, H', W') patch logits, float32."""

    def __init__(self, cfg: DiscriminatorConfig,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        self.dtype = compute_dtype(cfg.dtype)
        cin, cout = cfg.in_channels, cfg.ndf
        convs = [_SameConv(cin, cout, 4, (2, 2))]
        norms = [nn.Identity()]
        for n in range(1, cfg.n_layers + 1):
            cin, cout = cout, cfg.ndf * min(2 ** n, 8)
            stride = (2, 2) if n < cfg.n_layers else (1, 1)
            convs.append(_SameConv(cin, cout, 4, stride))
            norms.append(_norm(cfg.norm, cout))
        self.convs = nn.ModuleList(convs)
        self.norms = nn.ModuleList(norms)
        self.head = _SameConv(cout, 1, 4)
        init_parameters(self, cfg.init_type, cfg.init_gain, generator)

    def forward(self, x: torch.Tensor, return_features: bool = False):
        """Patch logits; with return_features, also the per-layer
        post-activation feature maps (for the feature-matching loss)."""
        h = x.to(self.dtype)
        feats = []
        for conv, norm in zip(self.convs, self.norms):
            h = F.leaky_relu(norm(conv(h)), 0.2)
            feats.append(h)
        logits = self.head(h).float()
        if return_features:
            return logits, feats
        return logits


def avg_pool_same(x: torch.Tensor) -> torch.Tensor:
    """flax `avg_pool(x, (3, 3), strides=(2, 2), padding="SAME")` over
    NCHW: SAME pads each axis (ceil(n/2) − 1)·2 + 3 − n, split low/high
    as (total//2, rest) — (0, 1) at an even size — and the zero pads
    count in the mean."""
    pads = []
    for n in (x.shape[3], x.shape[2]):
        total = max((-(-n // 2) - 1) * 2 + 3 - n, 0)
        pads += [total // 2, total - total // 2]
    return F.avg_pool2d(F.pad(x, pads), 3, stride=2)


class MultiScaleDiscriminator(nn.Module):
    """num_D PatchDiscriminators over a 2× average-pooled pyramid (the
    pix2pixHD recipe): D_0 sees the input, D_i sees it pooled i times
    (window 3, stride 2). Returns the list of per-scale logits; with
    return_features, also every scale's per-layer features, flat."""

    def __init__(self, cfg: DiscriminatorConfig, num_D: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        if num_D < 1:
            raise ValueError(f"num_D must be ≥ 1, got {num_D}")
        self.cfg = cfg
        self.num_D = num_D
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.nets = nn.ModuleList(PatchDiscriminator(cfg, generator)
                                  for _ in range(num_D))

    def forward(self, x: torch.Tensor, return_features: bool = False):
        h = x
        logits, feats = [], []
        for i, net in enumerate(self.nets):
            if i > 0:
                h = avg_pool_same(h)
            if return_features:
                lg, fs = net(h, return_features=True)
                feats.extend(fs)
            else:
                lg = net(h)
            logits.append(lg)
        if return_features:
            return logits, feats
        return logits
