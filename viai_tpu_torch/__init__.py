"""viai_tpu_torch — the PyTorch / H100 port of viai_tpu.

A second package beside `viai_tpu/` (the JAX reference, unchanged). It
imports torch and numpy only. It holds the serving chain, audio-only
and vision-infused: STFT → (video net →) U-Net G → phase-aware
Griffin-Lim, with Griffin-Lim in a hand-written CUDA kernel for Hopper
(csrc/griffin_lim.cu).
"""

from .io import (generator_state_from_flat, load_generator_pth,
                 load_networks, load_video_pth, video_state_from_flat)
from .nn import (GeneratorConfig, UNetGenerator, VideoFeatureNet,
                 VideoNetConfig, define_G, define_V)
from .serving import InpaintService, ServiceStats
from .signal import (MaskConfig, STFTConfig, griffin_lim, griffin_lim_cuda,
                     istft, stft)
from .train import TrainConfig, make_infer_fn, preprocess_with_mask

__all__ = [
    "STFTConfig", "MaskConfig", "stft", "istft", "griffin_lim",
    "griffin_lim_cuda", "GeneratorConfig", "UNetGenerator", "define_G",
    "VideoNetConfig", "VideoFeatureNet", "define_V",
    "generator_state_from_flat", "load_generator_pth", "load_networks",
    "video_state_from_flat", "load_video_pth",
    "TrainConfig", "make_infer_fn", "preprocess_with_mask",
    "InpaintService", "ServiceStats",
]
