"""The training/inference configuration of the port.

Port of `viai_tpu/train/step.py::TrainConfig`, with the same field
names. The TPU-only `gl_backend` is gone: the chain always calls
`griffin_lim_cuda`, which dispatches on the tensor's device.
"""

from __future__ import annotations

import dataclasses

from ..signal.mask import MaskConfig
from ..signal.stft import STFTConfig


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    stft: STFTConfig = STFTConfig()
    mask: MaskConfig = MaskConfig()
    image_frames: int = 256      # spectrogram image time dim (pad target)
    gan_mode: str = "lsgan"
    lambda_l1: float = 100.0
    lambda_l2: float = 0.0
    hole_weight: float = 1.0
    lambda_sc: float = 0.0
    lambda_onset: float = 0.0
    lambda_fm: float = 0.0
    phase_head: bool = False
    lambda_phase: float = 1.0
    conditional_d: bool = True
    use_video: bool = False
    update_order: str = "simultaneous"
    compress_ceiling: float = 6.0
    pool_size: int = 0
    n_bins: int = 256            # spectrogram image freq dim
    multi_res: bool = False
    remat: bool = False
