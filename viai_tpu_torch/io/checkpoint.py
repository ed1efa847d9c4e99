"""Checkpoints: the JAX package's `.pth` schema in both directions, and
the port's full train state.

`viai_tpu/io/checkpoint.py::save_networks` writes each net as a torch
state dict with flat keys and flax layouts, `{epoch}_net_{name}.pth`.
The keys follow the flax module tree, one `.kernel`/`.bias` pair per
conv or linear layer and one `.scale`/`.bias` pair per norm:
  G: downs.{i}.conv, downs.{i}.norm (i ≥ 1), fuse, bott_blocks.{i}.conv,
     bott_blocks.{i}.norm, attn_blocks.{i}.{norm1,qkv,proj,norm2,mlp_in,
     mlp_out}, ups.{i}.conv, ups.{i}.norm, head
  D: convs.{i}, norms.{i} (i ≥ 1), head; nets.{k}.… in the multi-scale D
  V: convs.{i}, norms.{i}, proj
Layouts: Conv (*spatial, cin, cout) → torch (cout, cin, *spatial);
ConvTranspose (kh, kw, cin, cout), applied unflipped → torch (cin,
cout, kh, kw), flipped; Linear (in, out) → torch (out, in). The gated
convs' kernels are 2·cout wide. `state_from_flat` maps that schema onto
the port's state dicts, strictly: a missing key, an extra key or a
wrong shape raises. `flat_from_state` is its inverse: the port's
`save_networks` writes files that the JAX package's `load_networks`
reads unchanged.

The full train state, which the `.pth` files cannot carry (both
optimizers with their plateau state, the step count, the pool, the RNG
state), is `{epoch}_state.pt`, a torch.save of plain dicts
(`save_train_state` / `load_train_state`); it takes the place of the
JAX package's orbax directory.
"""

from __future__ import annotations

import os
import re

import numpy as np
import torch
from torch import nn

from ..nn.generator import (NORM_TYPES, GeneratorConfig, UNetGenerator,
                            conv_weight_from_hwio, deconv_weight_from_hwio)
from ..nn.video import VideoFeatureNet, VideoNetConfig


def state_from_flat(flat: dict[str, np.ndarray],
                    model: nn.Module) -> dict[str, torch.Tensor]:
    """Flat JAX-package keys → `model`'s state dict. The key plan comes
    from the port's module tree (`model` may live on the meta device:
    only its shapes are read)."""
    # flat key → (port key, layout converter or None, expected shape)
    plan = {}
    for name, mod in model.named_modules():
        pre = f"{name}." if name else ""
        if isinstance(mod, NORM_TYPES):
            plan[f"{pre}scale"] = (f"{pre}weight", None, mod.weight.shape)
        elif isinstance(mod, (nn.Conv2d, nn.Conv3d, nn.ConvTranspose2d,
                              nn.Linear)):
            conv = (deconv_weight_from_hwio
                    if isinstance(mod, nn.ConvTranspose2d)
                    else conv_weight_from_hwio)
            plan[f"{pre}kernel"] = (f"{pre}weight", conv, mod.weight.shape)
        else:
            continue
        plan[f"{pre}bias"] = (f"{pre}bias", None, mod.bias.shape)

    missing = sorted(set(plan) - set(flat))
    extra = sorted(set(flat) - set(plan))
    if missing or extra:
        raise KeyError(f"{type(model).__name__} checkpoint does not match "
                       f"the config: missing {missing}, unexpected {extra}")
    out = {}
    for key, (port_key, conv, shape) in plan.items():
        t = torch.from_numpy(np.array(flat[key], dtype=np.float32))
        if conv is not None:
            t = conv(t)
        if t.shape != shape:
            raise ValueError(f"shape mismatch for {key!r}: checkpoint gives "
                             f"{tuple(t.shape)}, model wants {tuple(shape)}")
        out[port_key] = t
    return out


def _hwio_from_conv(w: torch.Tensor) -> torch.Tensor:
    """Inverse of conv_weight_from_hwio: torch (cout, cin, *spatial) →
    flax (*spatial, cin, cout); Linear (out, in) → (in, out)."""
    n = w.dim()
    return w.permute(*range(2, n), 1, 0).contiguous()


def _hwio_from_deconv(w: torch.Tensor) -> torch.Tensor:
    """Inverse of deconv_weight_from_hwio: torch (cin, cout, kh, kw),
    flipped → flax (kh, kw, cin, cout), unflipped."""
    return w.flip(2, 3).permute(2, 3, 0, 1).contiguous()


def flat_from_state(model: nn.Module) -> dict[str, torch.Tensor]:
    """`model`'s weights under the JAX package's flat keys and flax
    layouts, float32 on the CPU (the inverse of state_from_flat)."""
    out = {}
    for name, mod in model.named_modules():
        pre = f"{name}." if name else ""
        if isinstance(mod, NORM_TYPES):
            out[f"{pre}scale"] = mod.weight
        elif isinstance(mod, (nn.Conv2d, nn.Conv3d, nn.ConvTranspose2d,
                              nn.Linear)):
            conv = (_hwio_from_deconv if isinstance(mod, nn.ConvTranspose2d)
                    else _hwio_from_conv)
            out[f"{pre}kernel"] = conv(mod.weight)
        else:
            continue
        out[f"{pre}bias"] = mod.bias
    return {k: v.detach().float().cpu().contiguous().clone()
            for k, v in out.items()}


def generator_state_from_flat(flat: dict[str, np.ndarray],
                              cfg: GeneratorConfig,
                              fusion_channels: int = 0
                              ) -> dict[str, torch.Tensor]:
    """Flat JAX-package keys → the port's UNetGenerator state dict."""
    with torch.device("meta"):
        model = UNetGenerator(cfg, fusion_channels=fusion_channels)
    return state_from_flat(flat, model)


def video_state_from_flat(flat: dict[str, np.ndarray],
                          cfg: VideoNetConfig) -> dict[str, torch.Tensor]:
    """Flat JAX-package keys → the port's VideoFeatureNet state dict."""
    with torch.device("meta"):
        model = VideoFeatureNet(cfg)
    return state_from_flat(flat, model)


def _read_flat(path: str) -> dict[str, np.ndarray]:
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.numpy() for k, v in sd.items()}


def load_generator_pth(path: str, cfg: GeneratorConfig,
                       fusion_channels: int = 0) -> dict[str, torch.Tensor]:
    """The port's G state dict from a `.pth` file that the JAX package's
    `save_networks` wrote."""
    return generator_state_from_flat(_read_flat(path), cfg, fusion_channels)


def load_video_pth(path: str, cfg: VideoNetConfig) -> dict[str, torch.Tensor]:
    """The port's V state dict from a `.pth` file that the JAX package's
    `save_networks` wrote."""
    return video_state_from_flat(_read_flat(path), cfg)


def _net_path(expr_dir: str, which_epoch, net_name: str) -> str:
    return os.path.join(expr_dir, f"{which_epoch}_net_{net_name}.pth")


def save_networks(nets: dict[str, nn.Module], which_epoch, expr_dir: str):
    """Write each net (e.g. {"G": G, "D": D, "V": V}) to
    `{expr_dir}/{which_epoch}_net_{name}.pth` in the JAX package's
    schema, and to the `latest` alias unless `which_epoch` is latest."""
    os.makedirs(expr_dir, exist_ok=True)
    for name, net in nets.items():
        sd = flat_from_state(net)
        torch.save(sd, _net_path(expr_dir, which_epoch, name))
        if str(which_epoch) != "latest":
            torch.save(sd, _net_path(expr_dir, "latest", name))


def load_networks(nets: dict[str, nn.Module], which_epoch,
                  expr_dir: str) -> dict[str, nn.Module]:
    """Load each net (a UNetGenerator, a discriminator or a
    VideoFeatureNet, e.g. {"G": G, "D": D, "V": V}) in place from
    `{expr_dir}/{which_epoch}_net_{name}.pth`, the file scheme of the
    JAX package's save_networks and of save_networks here."""
    for name, net in nets.items():
        flat = _read_flat(_net_path(expr_dir, which_epoch, name))
        net.load_state_dict(state_from_flat(flat, net))
    return nets


def available_epochs(expr_dir: str, net_name: str = "G") -> list[str]:
    """Saved epoch tags of a net, numeric ones in order, then the rest
    ('latest')."""
    if not os.path.isdir(expr_dir):
        return []
    pat = re.compile(rf"^(.+)_net_{re.escape(net_name)}\.pth$")
    tags = [m.group(1) for f in os.listdir(expr_dir) if (m := pat.match(f))]
    nums = sorted((t for t in tags if t.isdigit()), key=int)
    return nums + [t for t in tags if not t.isdigit()]


def _state_path(expr_dir: str, which_epoch) -> str:
    return os.path.join(expr_dir, f"{which_epoch}_state.pt")


def save_train_state(state: dict, which_epoch, expr_dir: str):
    """torch.save `state` (a dict of state dicts, tensors and numbers)
    as `{expr_dir}/{which_epoch}_state.pt`."""
    os.makedirs(expr_dir, exist_ok=True)
    torch.save(state, _state_path(expr_dir, which_epoch))


def load_train_state(which_epoch, expr_dir: str) -> dict:
    """The dict save_train_state wrote, on the CPU; FileNotFoundError
    when there is none."""
    return torch.load(_state_path(expr_dir, which_epoch), map_location="cpu",
                      weights_only=True)
