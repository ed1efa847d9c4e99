"""Inference chain: wav → inpainted wav, in PyTorch.

Port of `viai_tpu/train/step.py::preprocess_with_mask`, `_g_input` and
`make_infer_fn(external_mask=True)`: STFT → log1p compression and an
explicit time mask → U-Net G → composite (observed region kept, hole
from G) → phase-aware Griffin-Lim. The functions keep the JAX
package's layouts at their boundaries: (B, T) waveforms,
(B, image_frames) masks, NHWC images. G itself runs in NCHW.

Not ported yet, and raising NotImplementedError: cfg.multi_res,
cfg.phase_head / phase_init="model", cfg.use_video. The deep ensemble
(n_ensemble) and the diffusion refiner have no parameter here yet.
"""

from __future__ import annotations

import typing as tp

import torch

from ..signal.gl_cuda import griffin_lim_cuda
from ..signal.mel import compress, decompress, sharpen_mag
from ..signal.stft import stft
from .config import TrainConfig


def _check_ported(cfg: TrainConfig):
    for name in ("multi_res", "phase_head", "use_video"):
        if getattr(cfg, name):
            raise NotImplementedError(f"TrainConfig.{name} is not ported yet")


def _stft_mag(wav, cfg: TrainConfig):
    re, im = stft(wav, cfg.stft)
    return re, im, torch.sqrt(re * re + im * im + 1e-9)


def preprocess_with_mask(wav: torch.Tensor, tmask: torch.Tensor,
                         cfg: TrainConfig) -> dict[str, torch.Tensor]:
    """(B, T) waveform + (B, image_frames) time mask → NHWC image dict.

    Returns real_img/masked_img in [-1, 1] and mask_img with
    1 = observed, each (B, n_bins, image_frames, 1). The STFT's
    (B, frames, bins) is transposed and zero-padded along time to
    `image_frames`; padding columns count as observed.
    """
    return _preprocess(wav, tmask, cfg)[0]


def _preprocess(wav, tmask, cfg: TrainConfig):
    """preprocess_with_mask, plus the complex STFT it computed."""
    _check_ported(cfg)
    if wav.dim() != 2 or tmask.dim() != 2 or wav.shape[0] != tmask.shape[0]:
        raise ValueError(f"wav (B, T) and tmask (B, frames) expected, got "
                         f"{tuple(wav.shape)} and {tuple(tmask.shape)}")
    re, im, mag = _stft_mag(wav, cfg)
    mag = mag.transpose(-1, -2)                    # (B, n_bins, F)
    n_frames = mag.shape[-1]
    pad = cfg.image_frames - n_frames
    if pad < 0:
        raise ValueError("image_frames smaller than STFT frame count")
    mag = torch.nn.functional.pad(mag, (0, pad))
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
    return batch, (re, im)


def _g_input(batch: dict[str, torch.Tensor]) -> torch.Tensor:
    """G's input, NCHW: (B, 2, n_bins, image_frames) = [masked, mask]."""
    return torch.cat([batch["masked_img"], batch["mask_img"]],
                     dim=-1).permute(0, 3, 1, 2)


def make_infer_fn(G: torch.nn.Module, cfg: TrainConfig, n_gl_iter: int = 32,
                  length: int | None = None, phase_aware: bool = True,
                  phase_init: str = "auto", mag_sharpen: float = 1.0,
                  oracle_mag: bool = False,
                  ) -> tp.Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """Build infer(wav (B, T), tmask (B, image_frames)) → (B, length) wav.

    tmask marks the real corrupted region (1 = observed, 0 = hole); the
    chain runs on the device of its inputs. phase_aware=True keeps the
    observed frames' complex STFT verbatim in Griffin-Lim;
    phase_init="auto" resolves to "extrapolate" under phase_aware and to
    "zero" otherwise. mag_sharpen (gamma, 1 = off) sharpens the
    predicted magnitude; oracle_mag=True substitutes the true magnitude
    (the pipeline's ceiling, evaluation only).
    """
    _check_ported(cfg)
    if phase_init == "auto":
        phase_init = "extrapolate" if phase_aware else "zero"
    if phase_init == "model":
        raise NotImplementedError("phase_init='model' (the phase head) is "
                                  "not ported yet")
    if phase_init == "extrapolate" and not phase_aware:
        raise ValueError(f"phase_init={phase_init!r} requires phase_aware")

    @torch.inference_mode()
    def infer(wav: torch.Tensor, tmask: torch.Tensor) -> torch.Tensor:
        batch, (re_in, im_in) = _preprocess(wav, tmask, cfg)
        fake = G(_g_input(batch)).permute(0, 2, 3, 1)       # NHWC
        fake_mag = decompress(fake[..., 0], cfg.compress_ceiling)
        if oracle_mag:
            fake_mag = decompress(batch["real_img"][..., 0],
                                  cfg.compress_ceiling)
        if mag_sharpen != 1.0:
            fake_mag = sharpen_mag(fake_mag, mag_sharpen, axis=-2)
        real_masked = decompress(batch["masked_img"][..., 0],
                                 cfg.compress_ceiling)
        m = batch["mask_img"][..., 0]
        comp = real_masked * m + fake_mag * (1.0 - m)    # (B, bins, T_img)
        n_frames = cfg.stft.num_frames(wav.shape[-1])
        mag = comp[..., :n_frames].transpose(-1, -2).contiguous()
        observed = None
        if phase_aware:
            fmask = m[:, 0, :n_frames][..., None]
            observed = (fmask, re_in, im_in)
        out_len = length if length is not None else wav.shape[-1]
        return griffin_lim_cuda(mag, cfg.stft, n_iter=n_gl_iter,
                                length=out_len, observed=observed,
                                phase_init=phase_init)

    return infer
