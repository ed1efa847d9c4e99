"""Weight bridge: the JAX package's `.pth` files → the port's G.

`viai_tpu/io/checkpoint.py::save_networks` writes each net as a torch
state dict with flat keys and flax layouts, `{epoch}_net_{name}.pth`:
  downs.{i}.conv.kernel (kh, kw, cin, cout) / .bias
  downs.{i}.norm.scale / .bias            (i ≥ 1; block 0 has no norm)
  ups.{i}.conv.kernel   (kh, kw, cin, cout) / .bias   (ConvTranspose in
                                                       deconv mode)
  ups.{i}.norm.scale / .bias
  head.kernel / .bias
This module maps that schema onto `UNetGenerator`'s state dict,
strictly: a missing key, an extra key or a wrong shape raises.
"""

from __future__ import annotations

import os

import numpy as np
import torch
from torch import nn

from ..nn.generator import (GeneratorConfig, InstanceNorm, UNetGenerator,
                            conv_weight_from_hwio, deconv_weight_from_hwio)


def generator_state_from_flat(flat: dict[str, np.ndarray],
                              cfg: GeneratorConfig) -> dict[str, torch.Tensor]:
    """Flat JAX-package keys → the port's UNetGenerator state dict.

    The key plan comes from the port's own module tree (built on the
    meta device: shapes only, no weights), so it follows the config.
    """
    with torch.device("meta"):
        model = UNetGenerator(cfg)
    # flat key → (port key, layout converter or None, expected shape)
    plan = {}
    for name, mod in model.named_modules():
        if isinstance(mod, InstanceNorm):
            plan[f"{name}.scale"] = (f"{name}.weight", None, mod.weight.shape)
        elif isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d)):
            conv = (deconv_weight_from_hwio
                    if isinstance(mod, nn.ConvTranspose2d)
                    else conv_weight_from_hwio)
            plan[f"{name}.kernel"] = (f"{name}.weight", conv, mod.weight.shape)
        else:
            continue
        plan[f"{name}.bias"] = (f"{name}.bias", None, mod.bias.shape)

    missing = sorted(set(plan) - set(flat))
    extra = sorted(set(flat) - set(plan))
    if missing or extra:
        raise KeyError(f"generator checkpoint does not match the config: "
                       f"missing {missing}, unexpected {extra}")
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


def load_generator_pth(path: str, cfg: GeneratorConfig) -> dict[str, torch.Tensor]:
    """The port's G state dict from a `.pth` file that the JAX package's
    `save_networks` wrote."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return generator_state_from_flat(
        {k: v.numpy() for k, v in sd.items()}, cfg)


def _net_path(expr_dir: str, which_epoch, net_name: str) -> str:
    return os.path.join(expr_dir, f"{which_epoch}_net_{net_name}.pth")


def load_networks(nets: dict[str, UNetGenerator], which_epoch,
                  expr_dir: str) -> dict[str, UNetGenerator]:
    """Load each generator in place from `{expr_dir}/{which_epoch}_net_{name}.pth`,
    the file scheme of the JAX package's save_networks."""
    for name, net in nets.items():
        sd = load_generator_pth(_net_path(expr_dir, which_epoch, name), net.cfg)
        net.load_state_dict(sd)
    return nets
