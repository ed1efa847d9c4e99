"""Inpainting generator G — U-Net encoder-decoder over spectrograms.

Port of `viai_tpu/nn/generator.py`. The modules compute in NCHW, the
PyTorch habit: the input is (B, in_channels, n_bins, n_frames). The
same layer plan as the JAX package: 4x4 convs with asymmetric strides
(frequency /64, time /16 at the defaults), so the bottleneck keeps a
time axis; instance norm; skip concat [h, skip], deep to shallow; tanh
in float32. Every option of the JAX package's G is here: gated convs,
the fusion conv of the video features, dilated time blocks and
attention blocks at the bottleneck, the flax GroupNorm lowering, and
bf16 compute (params float32, cast at each layer as flax promotes
them; norm moments, softmax and tanh in float32).

flax's padding is reproduced exactly:
  * Conv(padding="SAME") pads each axis by pad_total = max((ceil(i/s)−1)·s
    + k' − i, 0), k' = (k−1)·d + 1 for dilation d, split
    (pad_total//2, rest): (1, 2) on a stride-1 axis with a 4x4 kernel,
    (d, d) for a 3-tap kernel dilated by d. The conv itself runs unpadded.
  * ConvTranspose(padding="SAME") applies its (kh, kw, cin, cout) kernel
    UNFLIPPED as a forward conv over the zero-inserted input, padded per
    axis by (2, 2) for stride 2 and (2, 1) for stride 1. That equals
    torch's conv_transpose2d with the FLIPPED kernel, cropped by
    (k−1−lo, k−1−hi) per axis; the flip is done once, when the weight
    is made or loaded (`deconv_weight_from_hwio`).

Decoder dropout (`dropout` = p) acts, as in the JAX package, only
when the forward is given a dropout source (JAX: a key), which
inference never passes, so inference is deterministic whatever the
module's mode. The source is a `torch.Generator`, from which one
keep-mask per affected block is drawn, or the list of keep-masks
itself (`dropout_masks` draws them ahead, for a rematerialised forward
or to inject another package's draws). The first min(3, len(ups))
up-blocks (the deepest) are affected: h ← where(mask, h / (1 − p), 0)
with mask ~ Bernoulli(1 − p), before the skip concat.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from .initializers import kernel_init_for

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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
    norm: str = "instance"      # instance | groupnorm_instance | batch | none
    dtype: str = "float32"      # compute dtype: float32 | bfloat16
    upsample: str = "deconv"    # deconv (4x4 transposed conv) | resize
    init_type: str = "normal"
    init_gain: float = 0.02
    dropout: float = 0.0
    bottleneck_dilation: tuple[int, ...] = ()
    bottleneck_attn: int = 0
    attn_heads: int = 8
    gated: bool = False


def compute_dtype(name: str) -> torch.dtype:
    if name not in DTYPES:
        raise ValueError(f"dtype {name!r} not in {tuple(DTYPES)}")
    return DTYPES[name]


def conv_weight_from_hwio(k: torch.Tensor) -> torch.Tensor:
    """flax Conv kernel (*spatial, cin, cout) → torch ConvNd
    (cout, cin, *spatial); with no spatial axes, a flax Linear kernel
    (in, out) → torch Linear (out, in)."""
    n = k.dim()
    return k.permute(n - 1, n - 2, *range(n - 2)).contiguous()


def deconv_weight_from_hwio(k: torch.Tensor) -> torch.Tensor:
    """flax ConvTranspose kernel (kh, kw, cin, cout), applied unflipped
    → torch ConvTranspose2d weight (cin, cout, kh, kw), spatially flipped."""
    return k.permute(2, 3, 0, 1).flip(2, 3).contiguous()


def _same_pads(size: int, k: int, s: int, d: int = 1) -> tuple[int, int]:
    """flax/XLA SAME padding of one axis (lax.padtype_to_pads) for a
    k-tap kernel dilated by d."""
    k = (k - 1) * d + 1
    total = max((math.ceil(size / s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def same_pad(x: torch.Tensor, conv: nn.Module) -> torch.Tensor:
    """x padded as flax's SAME pads it for `conv` (a torch ConvNd)."""
    pads = []
    for i in reversed(range(len(conv.kernel_size))):
        pads += _same_pads(x.shape[2 + i], conv.kernel_size[i],
                           conv.stride[i], conv.dilation[i])
    return F.pad(x, pads)


def _conv_transpose_pads(k: int, s: int) -> tuple[int, int]:
    """flax ConvTranspose SAME padding of one axis
    (lax._conv_transpose_padding)."""
    pad_len = k + s - 2
    lo = k - 1 if s > k - 1 else math.ceil(pad_len / 2)
    return lo, pad_len - lo


class _SameConv(nn.Conv2d):
    """Conv2d with flax SAME padding, done explicitly (it may be
    asymmetric), in the input's dtype."""

    def __init__(self, cin, cout, k, stride=(1, 1), dilation=(1, 1)):
        super().__init__(cin, cout, k, stride=stride, dilation=dilation,
                         padding=0)

    def forward(self, x):
        return self._conv_forward(same_pad(x, self), self.weight.to(x.dtype),
                                  self.bias.to(x.dtype))


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
        y = F.conv_transpose2d(x, self.weight.to(x.dtype),
                               self.bias.to(x.dtype), self.stride,
                               self.padding)
        (t, b), (l, r) = self.extra
        return y[..., t : y.shape[2] - b, l : y.shape[3] - r]


class Linear(nn.Linear):
    """nn.Linear in the input's dtype (flax promotes kernel and bias to
    the compute dtype). `zero_init` marks the output projections that
    the JAX package initialises to zero."""

    zero_init = False

    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class InstanceNorm(nn.Module):
    """Per-(sample, channel) spatial normalization with affine params:
    eps 1e-6 inside the rsqrt, float32 moments, var = E[x²] − E[x]²;
    the result in the input's dtype."""

    def __init__(self, features: int, epsilon: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.epsilon = epsilon
        self.dims = (2, 3)

    def forward(self, x):
        xf = x.float()
        mean, sq = self.moments(xf)
        var = sq - mean * mean
        y = (xf - mean) * torch.rsqrt(var + self.epsilon)
        y = y * self.weight.view(1, -1, 1, 1) + self.bias.view(1, -1, 1, 1)
        return y.to(x.dtype)

    def moments(self, xf):
        """(E[x], E[x²]) over self.dims, float32, kept dims."""
        return (xf.mean(self.dims, keepdim=True),
                (xf * xf).mean(self.dims, keepdim=True))


class BatchNorm(InstanceNorm):
    """Per-channel normalization over (N, H, W) with live batch
    statistics and no running averages (the JAX package keeps none).
    `stats_mean`, when set (train/mesh.py::sync_batch_stats), maps the
    stacked moments of this rank's rows to the global batch's."""

    def __init__(self, features: int, epsilon: float = 1e-5):
        super().__init__(features, epsilon)
        self.dims = (0, 2, 3)
        self.stats_mean = None

    def moments(self, xf):
        mean, sq = super().moments(xf)
        if self.stats_mean is not None:
            mean, sq = self.stats_mean(torch.stack([mean, sq])).unbind(0)
        return mean, sq


class GroupNorm(nn.Module):
    """flax's nnx.GroupNorm over an N C ... tensor: float32 moments over
    each group's channels and every spatial position, var = max(0,
    E[x²] − E[x]²), eps 1e-6; scale and bias first rounded to the
    input's dtype (flax promotes them to the compute dtype), then
    y = (x − mean)·(rsqrt(var + eps)·scale) + bias, in the input's dtype."""

    def __init__(self, features: int, groups: int, epsilon: float = 1e-6):
        super().__init__()
        if features % groups:
            raise ValueError(f"{features} channels in {groups} groups")
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.groups = groups
        self.epsilon = epsilon

    def forward(self, x):
        B, C = x.shape[:2]
        per = C // self.groups
        view = (B, C) + (1,) * (x.dim() - 2)
        xf = x.float()
        g = xf.reshape(B, self.groups, -1)
        mean = g.mean(-1)
        var = ((g * g).mean(-1) - mean * mean).clamp_min(0.0)
        scale = self.weight.to(x.dtype).float()
        bias = self.bias.to(x.dtype).float()
        mul = torch.rsqrt(var + self.epsilon).repeat_interleave(per, 1) * scale
        y = (xf - mean.repeat_interleave(per, 1).view(view)) * mul.view(view)
        return (y + bias.view((1, C) + view[2:])).to(x.dtype)


class ChannelLayerNorm(nn.Module):
    """LayerNorm over the last (channel) axis of (B, N, C) tokens:
    eps 1e-6, float32 moments, var = E[x²] − E[x]²; the result in the
    input's dtype."""

    def __init__(self, features: int, epsilon: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.epsilon = epsilon

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = (xf * xf).mean(-1, keepdim=True) - mean * mean
        y = (xf - mean) * torch.rsqrt(var + self.epsilon)
        return (y * self.weight + self.bias).to(x.dtype)


NORM_TYPES = (InstanceNorm, GroupNorm, ChannelLayerNorm)


def _norm(norm: str, features: int) -> nn.Module:
    if norm == "instance":
        return InstanceNorm(features)
    if norm == "groupnorm_instance":      # the flax lowering, one group a channel
        return GroupNorm(features, features)
    if norm == "batch":
        return BatchNorm(features)
    if norm == "none":
        return nn.Identity()
    raise ValueError(f"unknown norm {norm!r}")


class DownBlock(nn.Module):
    """conv(4x4, stride s) → norm → LeakyReLU(0.2).

    gated=True (DeepFill-v2): the conv emits 2·cout channels; the
    second half is a sigmoid gate on the activated first half.
    """

    def __init__(self, cin, cout, stride, norm, gated: bool = False):
        super().__init__()
        self.gated = gated
        self.conv = _SameConv(cin, 2 * cout if gated else cout, 4, stride)
        self.norm = _norm(norm, cout)

    def forward(self, x):
        h = self.conv(x)
        if self.gated:
            feat, gate = h.chunk(2, dim=1)
            return F.leaky_relu(self.norm(feat), 0.2) * torch.sigmoid(gate)
        return F.leaky_relu(self.norm(h), 0.2)


class UpBlock(nn.Module):
    """Upsample(stride) → norm → ReLU. mode="deconv": 4x4 transposed
    conv; mode="resize": nearest-resize then 3x3 conv. gated as
    DownBlock."""

    def __init__(self, cin, cout, stride, norm, mode: str = "deconv",
                 gated: bool = False):
        super().__init__()
        if mode not in ("deconv", "resize"):
            raise ValueError(f"upsample mode {mode!r}")
        self.mode = mode
        self.stride = tuple(stride)
        self.gated = gated
        c_conv = 2 * cout if gated else cout
        self.conv = (_SameConv(cin, c_conv, 3) if mode == "resize"
                     else _SameConvTranspose(cin, c_conv, 4, self.stride))
        self.norm = _norm(norm, cout)

    def forward(self, x):
        if self.mode == "resize":
            x = F.interpolate(x, scale_factor=self.stride, mode="nearest")
        h = self.conv(x)
        if self.gated:
            feat, gate = h.chunk(2, dim=1)
            return F.relu(self.norm(feat)) * torch.sigmoid(gate)
        return F.relu(self.norm(h))


class DilatedTimeBlock(nn.Module):
    """Residual (1x3) conv dilated along time at the bottleneck:
    x + relu(norm(conv(x)))."""

    def __init__(self, ch, dilation, norm):
        super().__init__()
        self.conv = _SameConv(ch, ch, (1, 3), dilation=(1, dilation))
        self.norm = _norm(norm, ch)

    def forward(self, x):
        return x + F.relu(self.norm(self.conv(x)))


def sincos_pos_embed(n_freq: int, n_time: int, ch: int) -> torch.Tensor:
    """Fixed 2D sinusoidal position embedding, (n_freq·n_time, ch),
    float32. The first ch//2 channels encode the time index, the rest
    the frequency index; the grid is flattened frequency-major."""

    def axis_embed(n: int, dim: int) -> torch.Tensor:
        pos = torch.arange(n, dtype=torch.float32)[:, None]
        half = dim // 2
        freq = torch.exp(-math.log(10000.0)
                         * torch.arange(half, dtype=torch.float32)
                         / max(half, 1))
        ang = pos * freq[None, :]
        return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)

    ct = ch // 2
    t_emb = axis_embed(n_time, ct)                       # (T, ct)
    f_emb = axis_embed(n_freq, ch - ct)                  # (F, cf)
    grid = torch.cat([t_emb[None].expand(n_freq, -1, -1),
                      f_emb[:, None].expand(-1, n_time, -1)], dim=-1)
    return grid.reshape(n_freq * n_time, ch)


class AttentionBlock(nn.Module):
    """Pre-norm transformer block over the flattened bottleneck grid:
    h (B, C, F, T) → tokens (B, F·T, C), flattened frequency-major as
    the JAX package's NHWC grid → MHSA → MLP (tanh GELU), both
    residual → back to (B, C, F, T). Scores and softmax in float32;
    the output projections are zero-initialised (identity at init)."""

    def __init__(self, ch: int, heads: int):
        super().__init__()
        if ch % heads:
            raise ValueError(f"{ch} channels in {heads} heads")
        self.heads = heads
        self.head_dim = ch // heads
        self.norm1 = ChannelLayerNorm(ch)
        self.qkv = Linear(ch, 3 * ch)
        self.proj = Linear(ch, ch)
        self.norm2 = ChannelLayerNorm(ch)
        self.mlp_in = Linear(ch, 2 * ch)
        self.mlp_out = Linear(2 * ch, ch)
        self.proj.zero_init = self.mlp_out.zero_init = True

    def forward(self, h):
        B, C, Fb, T = h.shape
        N = Fb * T
        x = h.permute(0, 2, 3, 1).reshape(B, N, C)
        pe = sincos_pos_embed(Fb, T, C).to(device=h.device, dtype=h.dtype)
        y = self.norm1(x) + pe
        qkv = self.qkv(y).reshape(B, N, 3, self.heads, self.head_dim)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        scores = torch.matmul(q, k.transpose(-1, -2)).float()
        attn = torch.softmax(scores / math.sqrt(self.head_dim), dim=-1)
        o = torch.matmul(attn.to(h.dtype), v)
        x = x + self.proj(o.transpose(1, 2).reshape(B, N, C))
        x = x + self.mlp_out(F.gelu(self.mlp_in(self.norm2(x)),
                                    approximate="tanh"))
        return x.reshape(B, Fb, T, C).permute(0, 3, 1, 2)


@torch.no_grad()
def init_parameters(root: nn.Module, init_type: str, init_gain: float,
                    generator: torch.Generator | None = None):
    """Kernels of every conv and linear layer under `root` drawn from
    `generator` with the config's kernel init over flax's layouts (so
    the fans are flax's), biases zero, norm scales one; the layers
    marked `zero_init` get zero kernels, as in the JAX package."""
    init = kernel_init_for(init_type, init_gain)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    for mod in root.modules():
        if isinstance(mod, Linear):
            if mod.zero_init:
                mod.weight.zero_()
            else:
                mod.weight.copy_(conv_weight_from_hwio(
                    init((mod.in_features, mod.out_features), generator)))
            mod.bias.zero_()
        elif isinstance(mod, (nn.Conv2d, nn.Conv3d, nn.ConvTranspose2d)):
            cin, cout = mod.in_channels, mod.out_channels
            hwio = init((*mod.kernel_size, cin, cout), generator)
            mod.weight.copy_(deconv_weight_from_hwio(hwio)
                             if isinstance(mod, nn.ConvTranspose2d)
                             else conv_weight_from_hwio(hwio))
            mod.bias.zero_()
        elif isinstance(mod, NORM_TYPES):
            mod.weight.fill_(1.0)
            mod.bias.zero_()


class UNetGenerator(nn.Module):
    """Spectrogram inpainting U-Net; forward(x, fusion_features) →
    completed image in [-1, 1] (tanh, float32). x is NCHW:
    (B, in_channels, n_bins, n_frames). `fusion_features` (B,
    T_bottleneck, fusion_channels), required when fusion_channels > 0,
    is tiled over frequency and concatenated after the bottleneck
    features, ahead of a 1x1 conv.

    Weights are drawn from `generator` (a torch.Generator) with the
    config's kernel init; biases zero, norm scales one.
    """

    def __init__(self, cfg: GeneratorConfig,
                 generator: torch.Generator | None = None,
                 fusion_channels: int = 0):
        super().__init__()
        self.cfg = cfg
        self.dtype = compute_dtype(cfg.dtype)
        ngf, norm = cfg.ngf, cfg.norm
        chans = [cfg.in_channels] + [m * ngf for m in cfg.mults]
        self.downs = nn.ModuleList(
            # First block skips norm (pix2pix convention).
            DownBlock(chans[i], chans[i + 1], s, "none" if i == 0 else norm,
                      cfg.gated)
            for i, s in enumerate(cfg.strides)
        )
        bott = chans[-1]
        self.fusion_channels = fusion_channels
        if fusion_channels:
            self.fuse = _SameConv(bott + fusion_channels, bott, 1)
        self.bott_blocks = nn.ModuleList(
            DilatedTimeBlock(bott, d, norm) for d in cfg.bottleneck_dilation)
        self.attn_blocks = nn.ModuleList(
            AttentionBlock(bott, cfg.attn_heads)
            for _ in range(cfg.bottleneck_attn))
        self.ups = nn.ModuleList()
        up_in = bott
        for i, s in reversed(list(enumerate(cfg.strides))):
            cout = chans[i] if i > 0 else ngf
            self.ups.append(UpBlock(up_in, cout, s, norm, cfg.upsample,
                                    cfg.gated))
            # Next up-block consumes skip concat.
            up_in = cout + chans[i] if i > 0 else cout
        self.head = _SameConv(ngf + cfg.in_channels, cfg.out_channels, 3)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: torch.Generator | None = None):
        init_parameters(self, self.cfg.init_type, self.cfg.init_gain,
                        generator)

    @property
    def dropout_blocks(self) -> int:
        """Up-blocks under dropout: the deepest min(3, len(ups))."""
        return min(3, len(self.ups)) if self.cfg.dropout > 0.0 else 0

    def dropout_shapes(self, x_shape) -> list[tuple[int, ...]]:
        """NCHW shapes of the dropped up-block outputs for an input of
        `x_shape`: each is the shape of the skip it is concatenated with,
        at the up-block's width."""
        B, _, H, W = x_shape
        sizes = [(H, W)]
        for sf, st in self.cfg.strides:
            sizes.append((-(-sizes[-1][0] // sf), -(-sizes[-1][1] // st)))
        n = len(self.cfg.strides)
        shapes = []
        for i in range(self.dropout_blocks):
            lvl = n - 1 - i
            c = self.cfg.mults[lvl - 1] * self.cfg.ngf if lvl > 0 else \
                self.cfg.ngf
            shapes.append((B, c, *sizes[lvl]))
        return shapes

    def dropout_masks(self, x_shape, generator: torch.Generator
                      ) -> list[torch.Tensor]:
        """Keep-masks (bool, on the generator's device) for a forward on
        an input of `x_shape`, drawn from `generator`."""
        keep = 1.0 - self.cfg.dropout
        return [torch.rand(s, generator=generator,
                           device=generator.device) < keep
                for s in self.dropout_shapes(x_shape)]

    def forward(self, x: torch.Tensor,
                fusion_features: torch.Tensor | None = None,
                dropout: torch.Generator | list[torch.Tensor] | None = None
                ) -> torch.Tensor:
        """`dropout`: None (deterministic), a torch.Generator, or the
        keep-masks of `dropout_masks`."""
        masks = None
        if dropout is not None and self.dropout_blocks:
            masks = (self.dropout_masks(x.shape, dropout)
                     if isinstance(dropout, torch.Generator) else dropout)
            if len(masks) != self.dropout_blocks:
                raise ValueError(f"{len(masks)} dropout masks for "
                                 f"{self.dropout_blocks} blocks")
        keep = 1.0 - self.cfg.dropout
        h = x.to(self.dtype)
        skips = []
        for blk in self.downs:
            skips.append(h)
            h = blk(h)
        if self.fusion_channels:
            if fusion_features is None:
                raise ValueError("a generator built with fusion_channels "
                                 "needs fusion_features")
            f = fusion_features.to(h.dtype).transpose(1, 2)[:, :, None, :]
            h = self.fuse(torch.cat([h, f.expand(-1, -1, h.shape[2], -1)],
                                    dim=1))
        for blk in self.bott_blocks:
            h = blk(h)
        for blk in self.attn_blocks:
            h = blk(h)
        for i, blk in enumerate(self.ups):
            h = blk(h)
            if masks is not None and i < len(masks):
                h = torch.where(masks[i].to(h.device), h / keep,
                                torch.zeros((), dtype=h.dtype,
                                            device=h.device))
            h = torch.cat([h, skips[len(self.ups) - 1 - i]], dim=1)
        return torch.tanh(self.head(h).float())
