"""Inpainting generator G — U-Net encoder-decoder over spectrograms.

Port of `viai_tpu/nn/generator.py`. The modules compute in NCHW, the
PyTorch habit: the input is (B, in_channels, n_bins, n_frames). The
same layer plan as the JAX package: 4x4 convs with asymmetric strides
(frequency /64, time /16 at the defaults), so the bottleneck keeps a
time axis; instance norm; skip concat [h, skip], deep to shallow; tanh
in float32.

flax's padding is reproduced exactly:
  * Conv(padding="SAME") pads each axis by pad_total = max((ceil(i/s)−1)·s
    + k − i, 0), split (pad_total//2, rest): (1, 2) on a stride-1 axis
    with a 4x4 kernel. The conv itself runs unpadded.
  * ConvTranspose(padding="SAME") applies its (kh, kw, cin, cout) kernel
    UNFLIPPED as a forward conv over the zero-inserted input, padded per
    axis by (2, 2) for stride 2 and (2, 1) for stride 1. That equals
    torch's conv_transpose2d with the FLIPPED kernel, cropped by
    (k−1−lo, k−1−hi) per axis; the flip is done once, when the weight
    is made or loaded (`deconv_weight_from_hwio`).

Not on the serving path yet, and raising NotImplementedError: gated
convs, bottleneck dilation, bottleneck attention, the fusion conv,
decoder dropout, bf16 compute and the flax GroupNorm lowering.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from .initializers import kernel_init_for


@dataclasses.dataclass(frozen=True)
class GeneratorConfig:
    in_channels: int = 2        # masked log-mag + mask channel
    out_channels: int = 1
    ngf: int = 64
    # (freq_stride, time_stride) per encoder level, shallow → deep.
    strides: tuple[tuple[int, int], ...] = (
        (2, 2), (2, 2), (2, 2), (2, 2), (2, 1), (2, 1)
    )
    # channel multiplier per level (×ngf), capped at 8 like pix2pix.
    mults: tuple[int, ...] = (1, 2, 4, 8, 8, 8)
    norm: str = "instance"      # instance | batch | none
    dtype: str = "float32"      # compute dtype
    upsample: str = "deconv"    # deconv (4x4 transposed conv) | resize
    init_type: str = "normal"
    init_gain: float = 0.02
    dropout: float = 0.0
    bottleneck_dilation: tuple[int, ...] = ()
    bottleneck_attn: int = 0
    attn_heads: int = 8
    gated: bool = False


def conv_weight_from_hwio(k: torch.Tensor) -> torch.Tensor:
    """flax Conv kernel (kh, kw, cin, cout) → torch Conv2d (cout, cin, kh, kw)."""
    return k.permute(3, 2, 0, 1).contiguous()


def deconv_weight_from_hwio(k: torch.Tensor) -> torch.Tensor:
    """flax ConvTranspose kernel (kh, kw, cin, cout), applied unflipped
    → torch ConvTranspose2d weight (cin, cout, kh, kw), spatially flipped."""
    return k.permute(2, 3, 0, 1).flip(2, 3).contiguous()


def _same_pads(size: int, k: int, s: int) -> tuple[int, int]:
    """flax/XLA SAME padding of one axis (lax.padtype_to_pads)."""
    total = max((math.ceil(size / s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _conv_transpose_pads(k: int, s: int) -> tuple[int, int]:
    """flax ConvTranspose SAME padding of one axis
    (lax._conv_transpose_padding)."""
    pad_len = k + s - 2
    lo = k - 1 if s > k - 1 else math.ceil(pad_len / 2)
    return lo, pad_len - lo


class _SameConv(nn.Conv2d):
    """Conv2d with flax SAME padding, done explicitly (it may be
    asymmetric)."""

    def __init__(self, cin, cout, k, stride=(1, 1)):
        super().__init__(cin, cout, k, stride=stride, padding=0)

    def forward(self, x):
        (t, b), (l, r) = (_same_pads(x.shape[d], self.kernel_size[i],
                                     self.stride[i])
                          for i, d in enumerate((2, 3)))
        return super().forward(F.pad(x, (l, r, t, b)))


class _SameConvTranspose(nn.ConvTranspose2d):
    """flax ConvTranspose(padding="SAME"), with the flipped kernel
    (`deconv_weight_from_hwio`) in torch's conv_transpose2d."""

    def __init__(self, cin, cout, k, stride):
        crops = [tuple(k - 1 - p for p in _conv_transpose_pads(k, s))
                 for s in stride]
        # torch's padding crops both ends equally; the rest is sliced.
        pad = tuple(min(c) for c in crops)
        super().__init__(cin, cout, k, stride=stride, padding=pad)
        self.extra = [(c[0] - p, c[1] - p) for c, p in zip(crops, pad)]

    def forward(self, x):
        y = super().forward(x)
        (t, b), (l, r) = self.extra
        return y[..., t : y.shape[2] - b, l : y.shape[3] - r]


class InstanceNorm(nn.Module):
    """Per-(sample, channel) spatial normalization with affine params:
    eps 1e-6 inside the rsqrt, float32 moments, var = E[x²] − E[x]²."""

    def __init__(self, features: int, epsilon: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.epsilon = epsilon
        self.dims = (2, 3)

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(self.dims, keepdim=True)
        var = (xf * xf).mean(self.dims, keepdim=True) - mean * mean
        y = (xf - mean) * torch.rsqrt(var + self.epsilon)
        return y * self.weight.view(1, -1, 1, 1) + self.bias.view(1, -1, 1, 1)


class BatchNorm(InstanceNorm):
    """Per-channel normalization over (N, H, W) with live batch
    statistics and no running averages (the JAX package keeps none)."""

    def __init__(self, features: int, epsilon: float = 1e-5):
        super().__init__(features, epsilon)
        self.dims = (0, 2, 3)


def _norm(norm: str, features: int) -> nn.Module:
    if norm == "instance":
        return InstanceNorm(features)
    if norm == "batch":
        return BatchNorm(features)
    if norm == "none":
        return nn.Identity()
    raise NotImplementedError(f"norm {norm!r} is not ported")


class DownBlock(nn.Module):
    """conv(4x4, stride s) → norm → LeakyReLU(0.2)."""

    def __init__(self, cin, cout, stride, norm):
        super().__init__()
        self.conv = _SameConv(cin, cout, 4, stride)
        self.norm = _norm(norm, cout)

    def forward(self, x):
        return F.leaky_relu(self.norm(self.conv(x)), 0.2)


class UpBlock(nn.Module):
    """Upsample(stride) → norm → ReLU. mode="deconv": 4x4 transposed
    conv; mode="resize": nearest-resize then 3x3 conv."""

    def __init__(self, cin, cout, stride, norm, mode: str = "deconv"):
        super().__init__()
        if mode not in ("deconv", "resize"):
            raise ValueError(f"upsample mode {mode!r}")
        self.mode = mode
        self.stride = tuple(stride)
        self.conv = (_SameConv(cin, cout, 3) if mode == "resize"
                     else _SameConvTranspose(cin, cout, 4, self.stride))
        self.norm = _norm(norm, cout)

    def forward(self, x):
        if self.mode == "resize":
            x = F.interpolate(x, scale_factor=self.stride, mode="nearest")
        return F.relu(self.norm(self.conv(x)))


class UNetGenerator(nn.Module):
    """Spectrogram inpainting U-Net; forward(x) → completed image in
    [-1, 1] (tanh). x is NCHW: (B, in_channels, n_bins, n_frames).

    Weights are drawn from `generator` (a torch.Generator) with the
    config's kernel init; biases zero, norm scales one.
    """

    def __init__(self, cfg: GeneratorConfig,
                 generator: torch.Generator | None = None,
                 fusion_channels: int = 0):
        super().__init__()
        unported = {
            "gated": cfg.gated, "bottleneck_dilation": cfg.bottleneck_dilation,
            "bottleneck_attn": cfg.bottleneck_attn, "dropout": cfg.dropout,
            "fusion_channels": fusion_channels,
            "dtype": cfg.dtype != "float32",
        }
        for name, val in unported.items():
            if val:
                raise NotImplementedError(
                    f"generator option {name}={val!r} is not ported yet")
        self.cfg = cfg
        ngf = cfg.ngf
        chans = [cfg.in_channels] + [m * ngf for m in cfg.mults]
        self.downs = nn.ModuleList(
            # First block skips norm (pix2pix convention).
            DownBlock(chans[i], chans[i + 1], s, "none" if i == 0 else cfg.norm)
            for i, s in enumerate(cfg.strides)
        )
        self.ups = nn.ModuleList()
        up_in = chans[-1]
        for i, s in reversed(list(enumerate(cfg.strides))):
            cout = chans[i] if i > 0 else ngf
            self.ups.append(UpBlock(up_in, cout, s, cfg.norm, cfg.upsample))
            # Next up-block consumes skip concat.
            up_in = cout + chans[i] if i > 0 else cout
        self.head = _SameConv(ngf + cfg.in_channels, cfg.out_channels, 3)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        init = kernel_init_for(self.cfg.init_type, self.cfg.init_gain)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        for mod in self.modules():
            if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d)):
                transposed = isinstance(mod, nn.ConvTranspose2d)
                cin, cout = mod.in_channels, mod.out_channels
                k = mod.kernel_size
                hwio = init((k[0], k[1], cin, cout), generator)
                mod.weight.copy_(deconv_weight_from_hwio(hwio) if transposed
                                 else conv_weight_from_hwio(hwio))
                mod.bias.zero_()
            elif isinstance(mod, InstanceNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.float()
        skips = []
        for blk in self.downs:
            skips.append(h)
            h = blk(h)
        for i, blk in enumerate(self.ups):
            h = torch.cat([blk(h), skips[len(self.ups) - 1 - i]], dim=1)
        return torch.tanh(self.head(h).float())
