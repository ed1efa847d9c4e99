"""Signal core of the port: STFT, compressions, masks, Griffin-Lim."""

from .gl_cuda import griffin_lim_cuda
from .griffin_lim import extrapolate_hole_phase, griffin_lim
from .mask import MaskConfig, apply_mask, expand_to_image
from .mel import compress, decompress, sharpen_mag
from .stft import STFTConfig, istft, overlap_add, stft, stft_magnitude

__all__ = [
    "STFTConfig", "stft", "stft_magnitude", "istft", "overlap_add",
    "compress", "decompress", "sharpen_mag",
    "MaskConfig", "apply_mask", "expand_to_image",
    "griffin_lim", "griffin_lim_cuda", "extrapolate_hole_phase",
]
