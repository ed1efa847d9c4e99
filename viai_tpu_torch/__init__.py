"""viai_tpu_torch — the PyTorch / H100 port of viai_tpu.

A second package beside `viai_tpu/` (the JAX reference, unchanged). It
imports torch and numpy only. This slice holds the serving chain:
STFT → U-Net G → phase-aware Griffin-Lim, with Griffin-Lim in a
hand-written CUDA kernel for Hopper (csrc/griffin_lim.cu).
"""

from .io import generator_state_from_flat, load_generator_pth, load_networks
from .nn import GeneratorConfig, UNetGenerator, define_G
from .serving import InpaintService, ServiceStats
from .signal import (MaskConfig, STFTConfig, griffin_lim, griffin_lim_cuda,
                     istft, stft)
from .train import TrainConfig, make_infer_fn, preprocess_with_mask

__all__ = [
    "STFTConfig", "MaskConfig", "stft", "istft", "griffin_lim",
    "griffin_lim_cuda", "GeneratorConfig", "UNetGenerator", "define_G",
    "generator_state_from_flat", "load_generator_pth", "load_networks",
    "TrainConfig", "make_infer_fn", "preprocess_with_mask",
    "InpaintService", "ServiceStats",
]
