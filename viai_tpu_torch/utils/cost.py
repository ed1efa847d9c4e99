"""Work counted from shapes: FLOPs of the nets, the Griffin-Lim
kernel's operations and bytes, and the bytes an eager program moves.

  * conv_gflop: the conv and linear layers of one forward, by hooks;
  * gl_ops, gl_bytes: what GL×n_iter must compute and move, the bound
    of the CUDA kernel (csrc/griffin_lim.cu), which no dispatch mode
    sees (it launches through ctypes);
  * ByteCounterMode: the bytes of every dispatched op's operands and
    results, views excluded — an unfused upper bound on the memory
    traffic (a fused program reads and writes less).

chip_smoke.py reads the first two for its rates and bounds, and
scripts/cost_analysis.py all of them beside FlopCounterMode.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten


def conv_gflop(model: torch.nn.Module, *inputs) -> float:
    """GFLOP (2 per multiply-add) of the conv and linear layers of one
    forward, counted from the shapes by forward hooks."""
    total = 0

    def hook(mod, inp, out):
        nonlocal total
        if isinstance(mod, torch.nn.Linear):
            total += out.numel() * mod.in_features
        elif isinstance(mod, torch.nn.ConvTranspose2d):
            total += (inp[0].numel() * mod.out_channels
                      * int(np.prod(mod.kernel_size)))
        else:
            total += (out.numel() * mod.in_channels
                      * int(np.prod(mod.kernel_size)))

    kinds = (torch.nn.Linear, torch.nn.Conv2d, torch.nn.Conv3d,
             torch.nn.ConvTranspose2d)
    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, kinds)]
    try:
        with torch.inference_mode():
            model(*inputs)
    finally:
        for h in hooks:
            h.remove()
    return 2 * total / 1e9


def gl_ops(batch: int, n_frames: int, n_bins: int, n_fft: int,
           n_iter: int) -> int:
    """Floating-point operations of GL×n_iter: per iteration 4 products
    of n_frames × n_bins × n_fft multiply-adds a clip (iDFT re and im,
    DFT cos and sin), plus the final iDFT."""
    return 2 * batch * n_frames * n_bins * n_fft * (4 * n_iter + 2)


def gl_bytes(batch: int, n_frames: int, n_bins: int, length: int) -> int:
    """Bytes GL must move: the magnitude, the observed spectrum (re, im)
    and the initial phase (re, im) read once, float32, and the
    `length`-sample waveform written once."""
    return 4 * (5 * batch * n_frames * n_bins + batch * length)


class ByteCounterMode(TorchDispatchMode):
    """Sums the bytes of each dispatched op's tensor operands and
    results (`nbytes`); view ops, which move nothing, are skipped."""

    def __init__(self):
        super().__init__()
        self.nbytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            # An in-place op's result is its operand: count it once.
            tensors = {id(t): t for t in tree_flatten((args, kwargs, out))[0]
                       if isinstance(t, torch.Tensor)}
            self.nbytes += sum(t.nbytes for t in tensors.values())
        return out
