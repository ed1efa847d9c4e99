"""The chain's preprocessing: wav → NHWC image dict, in PyTorch.

Port of `viai_tpu/train/step.py::preprocess`, `preprocess_with_mask` and
`_g_input`: STFT → log1p compression and a time mask (given, or drawn
from a torch.Generator), and G's NCHW input stack. The inference chains
(train/infer.py, train/diffusion.py) and the train step share it.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..signal.mask import sample_batch_masks
from ..signal.mel import compress
from ..signal.stft import stft
from .config import TrainConfig


def _stft_mag(wav, stft_cfg):
    re, im = stft(wav, stft_cfg)
    return re, im, torch.sqrt(re * re + im * im + 1e-9)


def preprocess(wav: torch.Tensor, generator: torch.Generator,
               cfg: TrainConfig) -> dict[str, torch.Tensor]:
    """(B, T) waveform → NHWC image dict, with gap masks drawn from
    `generator` (training and evaluation; cfg.mask's distribution).
    For real corrupted regions use `preprocess_with_mask`."""
    tmask = sample_batch_masks(generator, wav.shape[0], cfg.image_frames,
                               cfg.mask)
    return preprocess_with_mask(wav, tmask.to(wav.device), cfg)


def preprocess_with_mask(wav: torch.Tensor, tmask: torch.Tensor,
                         cfg: TrainConfig) -> dict[str, torch.Tensor]:
    """(B, T) waveform + (B, image_frames) time mask → NHWC image dict.

    Returns real_img/masked_img in [-1, 1] and mask_img with
    1 = observed, each (B, n_bins, image_frames, 1). The STFT's
    (B, frames, bins) is transposed and zero-padded along time to
    `image_frames`; padding columns count as observed. cfg.multi_res
    adds masked_lo_img, the masked magnitude of a second STFT at twice
    the hop, each of its frames repeated twice; cfg.phase_head adds
    phase_img (B, n_bins, image_frames, 2), the target's unit phasors.
    """
    return preprocess_with_stft(wav, tmask, cfg)[0]


def preprocess_with_stft(wav: torch.Tensor, tmask: torch.Tensor,
                         cfg: TrainConfig):
    """preprocess_with_mask, plus the complex STFT (re, im), each
    (B, frames, bins), that it computed."""
    if wav.dim() != 2 or tmask.dim() != 2 or wav.shape[0] != tmask.shape[0]:
        raise ValueError(f"wav (B, T) and tmask (B, frames) expected, got "
                         f"{tuple(wav.shape)} and {tuple(tmask.shape)}")
    re, im, mag = _stft_mag(wav, cfg.stft)
    mag = mag.transpose(-1, -2)                    # (B, n_bins, F)
    n_frames = mag.shape[-1]
    pad = cfg.image_frames - n_frames
    if pad < 0:
        raise ValueError("image_frames smaller than STFT frame count")
    mag = F.pad(mag, (0, pad))
    tmask = tmask.float()
    if pad:
        tmask = tmask.clone()
        tmask[:, n_frames:] = 1.0
    mask = tmask[:, None, :].expand(mag.shape)
    batch = {
        "real_img": compress(mag, cfg.compress_ceiling)[..., None],
        "masked_img": compress(mag * mask, cfg.compress_ceiling)[..., None],
        "mask_img": mask[..., None],
    }
    if cfg.multi_res:
        lo_cfg = dataclasses.replace(cfg.stft,
                                     hop_length=cfg.stft.hop_length * 2)
        lo = _stft_mag(wav, lo_cfg)[2].transpose(-1, -2)
        lo = lo.repeat_interleave(2, dim=-1)[..., : cfg.image_frames]
        lo = F.pad(lo, (0, cfg.image_frames - lo.shape[-1]))
        batch["masked_lo_img"] = compress(lo * mask,
                                          cfg.compress_ceiling)[..., None]
    if cfg.phase_head:
        re_t = F.pad(re.transpose(-1, -2), (0, pad))
        im_t = F.pad(im.transpose(-1, -2), (0, pad))
        inv = torch.rsqrt(re_t * re_t + im_t * im_t + 1e-12)
        batch["phase_img"] = torch.stack([re_t * inv, im_t * inv], dim=-1)
    return batch, (re, im)


def task_masks(mask, batch: int, cfg: TrainConfig, external_mask: bool,
               with_base: bool = True) -> tuple[torch.Tensor, int]:
    """An infer fn's mask argument → (time masks, base seed of the
    refiner's noise stream). external_mask: `mask` is the (B,
    image_frames) keep-mask and the stream is the fixed one, base 0.
    Else `mask` is a torch.Generator: the masks are drawn from it, then,
    when `with_base` (a chain with a refiner), the base seed. Read on
    the host, the seed makes a card generator's chain wait, so a chain
    without a refiner draws none (and can be captured in a CUDA graph)."""
    if external_mask:
        return mask, 0
    tmask = sample_batch_masks(mask, batch, cfg.image_frames, cfg.mask)
    if not with_base:
        return tmask, 0
    base = int(torch.randint(0, 2**62, (1,), generator=mask,
                             device=mask.device))
    return tmask, base


def g_input(batch: dict[str, torch.Tensor]) -> torch.Tensor:
    """G's input, NCHW: (B, 2 or 3, n_bins, image_frames) =
    [masked, mask] or [masked, mask, masked_lo]."""
    chans = [batch["masked_img"], batch["mask_img"]]
    if "masked_lo_img" in batch:
        chans.append(batch["masked_lo_img"])
    return torch.cat(chans, dim=-1).permute(0, 3, 1, 2)
