"""Inference chain: wav → inpainted wav, in PyTorch.

Port of `viai_tpu/train/step.py::preprocess`, `preprocess_with_mask`,
`_g_input` and `make_infer_fn(external_mask=True)`: STFT → log1p
compression and a time mask (drawn, or given) → U-Net G (fed the video net's features under
cfg.use_video; a deep ensemble when given several Gs) → composite
(observed region kept, hole from G) → phase-aware Griffin-Lim, seeded
by G's phase head under phase_init="model". The functions keep the JAX
package's layouts at their boundaries: (B, T) waveforms,
(B, image_frames) masks, (B, T, H, W, 3) frames, NHWC images. G itself
runs in NCHW.

The diffusion refiner has no counterpart here yet.
"""

from __future__ import annotations

import dataclasses
import typing as tp

import torch
import torch.nn.functional as F

from ..signal.gl_cuda import griffin_lim_cuda
from ..signal.mask import sample_batch_masks
from ..signal.mel import compress, decompress, sharpen_mag
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
    return _preprocess(wav, tmask, cfg)[0]


def _preprocess(wav, tmask, cfg: TrainConfig):
    """preprocess_with_mask, plus the complex STFT it computed."""
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


def _g_input(batch: dict[str, torch.Tensor]) -> torch.Tensor:
    """G's input, NCHW: (B, 2 or 3, n_bins, image_frames) =
    [masked, mask] or [masked, mask, masked_lo]."""
    chans = [batch["masked_img"], batch["mask_img"]]
    if "masked_lo_img" in batch:
        chans.append(batch["masked_lo_img"])
    return torch.cat(chans, dim=-1).permute(0, 3, 1, 2)


def make_infer_fn(G: torch.nn.Module | tp.Sequence[torch.nn.Module],
                  cfg: TrainConfig, n_gl_iter: int = 32,
                  length: int | None = None, phase_aware: bool = True,
                  phase_init: str = "auto", mag_sharpen: float = 1.0,
                  oracle_mag: bool = False, V: torch.nn.Module | None = None,
                  ) -> tp.Callable[..., torch.Tensor]:
    """Build infer(wav (B, T), tmask (B, image_frames), frames=None) →
    (B, length) wav.

    tmask marks the real corrupted region (1 = observed, 0 = hole); the
    chain runs on the device of its inputs. G may be a sequence of K
    same-architecture generators: a deep ensemble, whose outputs are
    averaged in compressed-magnitude space (phase channels included).
    cfg.use_video needs `V` here and (B, T, H, W, 3) `frames` at each
    call: G then gets V(frames) as its fusion features.
    phase_aware=True keeps the observed frames' complex STFT verbatim
    in Griffin-Lim; phase_init="auto" resolves to "model" (G's phase
    head: channels 1 and 2 normalised to unit phasors seed GL) under
    cfg.phase_head and phase_aware, else to "extrapolate" under
    phase_aware and to "zero" otherwise. mag_sharpen (gamma, 1 = off)
    sharpens the predicted magnitude; oracle_mag=True substitutes the
    true magnitude (the pipeline's ceiling, evaluation only).
    """
    gens = list(G) if isinstance(G, (list, tuple)) else [G]
    if not gens:
        raise ValueError("no generator given")
    if cfg.use_video and V is None:
        raise ValueError("cfg.use_video requires V (a VideoFeatureNet)")
    if phase_init == "auto":
        phase_init = ("model" if cfg.phase_head and phase_aware
                      else "extrapolate" if phase_aware else "zero")
    if phase_init in ("extrapolate", "model") and not phase_aware:
        raise ValueError(f"phase_init={phase_init!r} requires phase_aware")
    if phase_init == "model" and not cfg.phase_head:
        raise ValueError("phase_init='model' requires cfg.phase_head "
                         "(a G trained with --phase_head)")

    @torch.inference_mode()
    def infer(wav: torch.Tensor, tmask: torch.Tensor,
              frames: torch.Tensor | None = None) -> torch.Tensor:
        batch, (re_in, im_in) = _preprocess(wav, tmask, cfg)
        feats = None
        if cfg.use_video:
            if frames is None:
                raise ValueError("cfg.use_video: infer needs frames")
            feats = V(frames)
        x = _g_input(batch)
        if len(gens) == 1:
            fake = gens[0](x, feats)
        else:
            fake = torch.stack([g(x, feats) for g in gens]).mean(0)
        fake = fake.permute(0, 2, 3, 1)                       # NHWC
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
        init = None
        gl_phase_init = phase_init
        if phase_init == "model":
            # The head's (cos, sin) channels as unit phasors in the STFT
            # layout; the observed clamp keeps the true phase outside
            # the hole, so only the hole uses the prediction.
            pc = fake[..., 1][..., :n_frames].transpose(-1, -2)
            ps = fake[..., 2][..., :n_frames].transpose(-1, -2)
            inv = torch.rsqrt(pc * pc + ps * ps + 1e-8)
            init = (pc * inv, ps * inv)
            gl_phase_init = "zero"   # ignored: init overrides
        out_len = length if length is not None else wav.shape[-1]
        return griffin_lim_cuda(mag, cfg.stft, n_iter=n_gl_iter,
                                length=out_len, observed=observed,
                                phase_init=gl_phase_init, init=init)

    return infer
