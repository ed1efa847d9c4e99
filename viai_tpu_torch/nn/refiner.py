"""Diffusion refiner R — the generative stage for hole magnitudes.

Port of `viai_tpu/nn/refiner.py`: a time-conditioned U-Net, (x_t ‖ cond,
t) → v̂, over the same compressed spectrogram image G predicts. It runs
as an SDEdit-style refinement of G's output (few DDIM steps from
t_start) or as a full generative inpainter (t_start = 1); the sampler is
`train/diffusion.py`.

The modules compute in NCHW, as G does: the input is (B, in_channels,
n_bins, n_frames), channel 0 x_t and the rest the conditioning. The
layer plan and the module names are the JAX package's, so its
`{epoch}_net_R.pth` files load through `io/checkpoint.py::state_from_flat`:
  * temb_in, temb_out: Linear(temb_dim, temb_dim) on the sinusoidal
    embedding of t (float32 whatever the compute dtype; t is scaled by
    1000, an odd dim padded with a zero);
  * downs.{i}: 4x4 stride-2 SAME conv → norm (none on the first) →
    FiLM → LeakyReLU(0.2); mid.{i}: x + ReLU(FiLM(norm(3x3 conv)));
    ups.{i}, deepest first: 4x4 SAME transposed conv → norm → FiLM →
    ReLU, then the skip concat [h, skip];
  * head: 3x3 conv over ngf + in_channels channels, linear, float32 out.
FiLM splits its projection into (scale, shift) in that order and acts on
the channel axis: h·(1 + scale) + shift. The FiLM projections and the
head's kernel are zero at init, so a fresh R predicts v̂ ≡ 0: a test of
R must move those weights first.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from .generator import (Linear, _norm, _SameConv, _SameConvTranspose,
                        compute_dtype, init_parameters)


@dataclasses.dataclass(frozen=True)
class RefinerConfig:
    # x_t + conditioning (masked_img, mask_img, g_pred, [masked_lo_img]).
    in_channels: int = 4
    out_channels: int = 1          # v-prediction
    ngf: int = 64
    strides: tuple[tuple[int, int], ...] = ((2, 2), (2, 2), (2, 2), (2, 2))
    mults: tuple[int, ...] = (1, 2, 4, 8)
    n_bottleneck: int = 2          # residual FiLM blocks at the bottom
    temb_dim: int = 256
    norm: str = "instance"
    dtype: str = "float32"         # compute dtype: float32 | bfloat16
    init_type: str = "normal"
    init_gain: float = 0.02


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """(B,) continuous t in [0, 1] → (B, dim) float32 sinusoidal
    embedding; frequencies 1..10^4, t scaled by 1000."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    ang = t.float()[:, None] * 1000.0 * freqs[None, :]
    emb = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
    if dim % 2:
        emb = F.pad(emb, (0, 1))
    return emb


class FiLM(nn.Module):
    """temb → per-channel (scale, shift); zero-init → identity at init."""

    def __init__(self, temb_dim: int, ch: int):
        super().__init__()
        self.proj = Linear(temb_dim, 2 * ch)
        self.proj.zero_init = True

    def forward(self, h: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        ss = self.proj(F.silu(temb.to(h.dtype)))[:, :, None, None]
        scale, shift = ss.chunk(2, dim=1)
        return h * (1.0 + scale) + shift


class RDown(nn.Module):
    """conv(4x4, stride s) → norm → FiLM(t) → LeakyReLU(0.2)."""

    def __init__(self, cin, cout, stride, norm, temb_dim):
        super().__init__()
        self.conv = _SameConv(cin, cout, 4, stride)
        self.norm = _norm(norm, cout)
        self.film = FiLM(temb_dim, cout)

    def forward(self, x, temb):
        return F.leaky_relu(self.film(self.norm(self.conv(x)), temb), 0.2)


class RUp(nn.Module):
    """deconv(4x4, stride s) → norm → FiLM(t) → ReLU (skip concat by
    the caller)."""

    def __init__(self, cin, cout, stride, norm, temb_dim):
        super().__init__()
        self.conv = _SameConvTranspose(cin, cout, 4, tuple(stride))
        self.norm = _norm(norm, cout)
        self.film = FiLM(temb_dim, cout)

    def forward(self, x, temb):
        return F.relu(self.film(self.norm(self.conv(x)), temb))


class RBottleneck(nn.Module):
    """Residual 3x3 conv block with FiLM: x + ReLU(FiLM(norm(conv(x))))."""

    def __init__(self, ch, norm, temb_dim):
        super().__init__()
        self.conv = _SameConv(ch, ch, 3)
        self.norm = _norm(norm, ch)
        self.film = FiLM(temb_dim, ch)

    def forward(self, x, temb):
        return x + F.relu(self.film(self.norm(self.conv(x)), temb))


class DiffusionRefiner(nn.Module):
    """Time-conditioned U-Net: forward(x (B, in_channels, H, W), t (B,))
    → v̂ (B, out_channels, H, W), float32 (linear head: v is unbounded).

    Weights are drawn from `generator` with the config's kernel init;
    biases zero, norm scales one, the FiLM projections and the head's
    kernel zero.
    """

    def __init__(self, cfg: RefinerConfig,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        self.dtype = compute_dtype(cfg.dtype)
        norm, td = cfg.norm, cfg.temb_dim
        self.temb_in = Linear(td, td)
        self.temb_out = Linear(td, td)
        chans = [cfg.in_channels] + [m * cfg.ngf for m in cfg.mults]
        self.downs = nn.ModuleList(
            RDown(chans[i], chans[i + 1], s, "none" if i == 0 else norm, td)
            for i, s in enumerate(cfg.strides))
        bott = chans[-1]
        self.mid = nn.ModuleList(RBottleneck(bott, norm, td)
                                 for _ in range(cfg.n_bottleneck))
        self.ups = nn.ModuleList()
        up_in = bott
        for i, s in reversed(list(enumerate(cfg.strides))):
            cout = chans[i] if i > 0 else cfg.ngf
            self.ups.append(RUp(up_in, cout, s, norm, td))
            up_in = cout + chans[i] if i > 0 else cout
        self.head = _SameConv(cfg.ngf + cfg.in_channels, cfg.out_channels, 3)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        init_parameters(self, self.cfg.init_type, self.cfg.init_gain,
                        generator)
        self.head.weight.zero_()

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        h = x.to(self.dtype)
        temb = timestep_embedding(t, self.cfg.temb_dim).to(self.dtype)
        temb = self.temb_out(F.silu(self.temb_in(temb)))
        skips = []
        for blk in self.downs:
            skips.append(h)
            h = blk(h, temb)
        for blk in self.mid:
            h = blk(h, temb)
        for i, blk in enumerate(self.ups):
            h = blk(h, temb)
            h = torch.cat([h, skips[len(self.ups) - 1 - i]], dim=1)
        return self.head(h).float()
