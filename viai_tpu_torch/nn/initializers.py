"""Weight initializers — the pix2pix `init_weights` surface, in PyTorch.

Port of `viai_tpu/nn/initializers.py`. A kernel is drawn in the JAX
package's (kh, kw, cin, cout) layout, so every init type sees the same
fans as flax's, and the caller converts it to its torch layout:
  * normal:     N(0, gain²)                       (the default)
  * xavier:     N(0, gain²·2/(fan_in+fan_out))
  * kaiming:    N(0, 2/fan_in)
  * orthogonal: orthogonal matrix · gain
  * lecun:      truncated N(0, 1/fan_in) (flax's default)
Biases are zeros. The draws come from a `torch.Generator`, so they are
not the JAX package's numbers: weights cross between the packages
through the checkpoint bridge (viai_tpu_torch/io/checkpoint.py).
"""

from __future__ import annotations

import math
import typing as tp

import torch

INIT_TYPES = ("normal", "xavier", "kaiming", "orthogonal", "lecun")

KernelInit = tp.Callable[[tuple[int, ...], torch.Generator], torch.Tensor]

# Std of N(0, 1) truncated to ±2, as jax's variance_scaling corrects by.
_TRUNC_STD = 0.87962566103423978


def _fans(shape: tuple[int, ...]) -> tuple[int, int]:
    receptive = math.prod(shape[:-2])
    return shape[-2] * receptive, shape[-1] * receptive


def kernel_init_for(init_type: str, gain: float = 0.02) -> KernelInit:
    """init_type string → fn(hwio_shape, generator) → float32 kernel."""
    if init_type not in INIT_TYPES:
        raise ValueError(f"init_type {init_type!r} not in {INIT_TYPES}")

    def init(shape, generator):
        fan_in, fan_out = _fans(shape)
        w = torch.empty(shape, dtype=torch.float32)
        if init_type == "normal":
            return w.normal_(0.0, gain, generator=generator)
        if init_type == "xavier":
            std = gain * math.sqrt(2.0 / (fan_in + fan_out))
            return w.normal_(0.0, std, generator=generator)
        if init_type == "kaiming":
            return w.normal_(0.0, math.sqrt(2.0 / fan_in), generator=generator)
        if init_type == "orthogonal":
            mat = torch.empty(math.prod(shape[:-1]), shape[-1])
            torch.nn.init.orthogonal_(mat, gain, generator=generator)
            return mat.reshape(shape)
        std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
        return torch.nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                           generator=generator)

    return init
