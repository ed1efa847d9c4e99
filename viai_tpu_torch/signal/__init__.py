"""Signal core of the port: STFT, compressions, masks, Griffin-Lim."""

from .gl_cuda import griffin_lim_cuda
from .griffin_lim import extrapolate_hole_phase, griffin_lim
from .mask import (MaskConfig, apply_mask, expand_to_image,
                   sample_batch_masks, sample_time_mask)
from .mel import (apply_mel, complex_compress, complex_decompress, compress,
                  decompress, hz_to_mel, mel_filterbank, mel_to_hz,
                  sharpen_mag)
from .stft import STFTConfig, istft, overlap_add, stft, stft_magnitude

__all__ = [
    "STFTConfig", "stft", "stft_magnitude", "istft", "overlap_add",
    "compress", "decompress", "sharpen_mag", "hz_to_mel", "mel_to_hz",
    "mel_filterbank", "apply_mel", "complex_compress", "complex_decompress",
    "MaskConfig", "apply_mask", "expand_to_image", "sample_time_mask",
    "sample_batch_masks",
    "griffin_lim", "griffin_lim_cuda", "extrapolate_hole_phase",
]
