"""viai_tpu_torch — the PyTorch / H100 port of viai_tpu.

A second package beside `viai_tpu/` (the JAX reference, unchanged). It
imports torch and numpy only. It holds the serving chain, audio-only
and vision-infused: STFT → (video net →) U-Net G → phase-aware
Griffin-Lim, with Griffin-Lim in a hand-written CUDA kernel for Hopper
(csrc/griffin_lim.cu); and GAN training: D, the losses, the ImagePool,
the lr schedules and Adam, the train step, VIAIModel and the train CLI
(`python -m viai_tpu_torch.cli.train`) on the synthetic corpus; and
evaluation (`python -m viai_tpu_torch.cli.test`: the metrics, deep
ensembles, and the diffusion refiner R in the magnitude domain and in
the GL-free complex domain); R's training and folder data; the
throughput bench (`python -m viai_tpu_torch.bench`); multi-GPU
training and serving on torch.distributed (`train/mesh.py`); the
TensorBoard writer and the build cache's knobs (utils/); and the JAX
package's quality and data scripts (`python -m
viai_tpu_torch.scripts.<name>`).
"""

from .io import (generator_state_from_flat, load_generator_pth,
                 load_networks, load_video_pth, save_networks,
                 video_state_from_flat)
from .model import VIAIModel, create_model
from .nn import (DiscriminatorConfig, GeneratorConfig, MultiScaleDiscriminator,
                 PatchDiscriminator, UNetGenerator, VideoFeatureNet,
                 VideoNetConfig, define_D, define_G, define_R, define_V)
from .serving import InpaintService, ServiceStats
from .signal import (MaskConfig, STFTConfig, griffin_lim, griffin_lim_cuda,
                     istft, stft)
from .train import (TrainConfig, init_state, make_infer_fn, make_train_step,
                    preprocess, preprocess_with_mask)

__all__ = [
    "STFTConfig", "MaskConfig", "stft", "istft", "griffin_lim",
    "griffin_lim_cuda", "GeneratorConfig", "UNetGenerator", "define_G",
    "DiscriminatorConfig", "PatchDiscriminator", "MultiScaleDiscriminator",
    "define_D", "VideoNetConfig", "VideoFeatureNet", "define_V", "define_R",
    "generator_state_from_flat", "load_generator_pth", "load_networks",
    "save_networks", "video_state_from_flat", "load_video_pth",
    "TrainConfig", "make_infer_fn", "preprocess", "preprocess_with_mask",
    "init_state", "make_train_step", "VIAIModel", "create_model",
    "InpaintService", "ServiceStats",
]
