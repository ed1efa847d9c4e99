"""Inference chain: wav → inpainted wav, in PyTorch.

Port of `viai_tpu/train/step.py::make_infer_fn`: STFT → log1p
compression and a time mask (given, or drawn from a torch.Generator;
train/preprocess.py) → U-Net G (fed the video net's features under
cfg.use_video; a deep ensemble when given several Gs) → optionally the diffusion refiner R on G's magnitude image
(train/diffusion.py) → composite (observed region kept, hole from G or
R) → phase-aware Griffin-Lim, seeded by G's phase head under
phase_init="model". The functions keep the JAX package's layouts at
their boundaries: (B, T) waveforms, (B, image_frames) masks,
(B, T, H, W, 3) frames, NHWC images. G and R run in NCHW.
"""

from __future__ import annotations

import typing as tp

import torch

from ..signal.gl_cuda import griffin_lim_cuda
from ..signal.mel import decompress, sharpen_mag
from .config import TrainConfig
from .diffusion import (check_clamp_mode, chunked_mean, ddim_refine,
                        noise_source, tile, tile_batch)
from .preprocess import g_input, preprocess_with_stft, task_masks


def make_infer_fn(G: torch.nn.Module | tp.Sequence[torch.nn.Module],
                  cfg: TrainConfig, n_gl_iter: int = 32,
                  length: int | None = None, phase_aware: bool = True,
                  phase_init: str = "auto", mag_sharpen: float = 1.0,
                  oracle_mag: bool = False, V: torch.nn.Module | None = None,
                  refiner: torch.nn.Module | None = None,
                  refine_steps: int = 8, refine_t: float = 0.35,
                  refine_noise: float = 1.0, refine_guidance: float = 0.0,
                  refine_clamp: str = "x0", refine_resample: int = 0,
                  refine_avg: int = 1, refine_chunk: int = 8,
                  refine_mix: float = 0.0, refine_selfcond: bool = False,
                  external_mask: bool = True,
                  ) -> tp.Callable[..., torch.Tensor]:
    """Build infer(wav (B, T), mask, frames=None, fold=0, noise=None)
    → (B, length) wav.

    external_mask=True: `mask` is a (B, image_frames) keep-mask marking
    the real corrupted region (1 = observed, 0 = hole), the serving
    path. external_mask=False: `mask` is a torch.Generator from which
    the gaps are drawn (cfg.mask's distribution), evaluation. The chain
    runs on the device of its inputs. G may be a sequence of K
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

    refiner=R runs the diffusion refiner on G's magnitude image (the
    ensemble's mean) before the composite: `refine_steps` DDIM steps
    from t = `refine_t` (train/diffusion.py::ddim_refine with the
    refine_* options), the posterior mean of `refine_avg` samples
    computed `refine_chunk` at a time, then blended with G's image as
    refine_mix·G + (1 − refine_mix)·R; the phase-head channels pass
    through. Its noise: the fixed stream (base 0) for external masks,
    else a base seed drawn from the generator after the masks; the
    call's `fold` picks the stream (distinct folds: distinct posterior
    samples of the same task); `noise`, a list of refine_avg
    RefineNoise, stands in for the draws.
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
    if refiner is not None:
        check_clamp_mode(refine_clamp)
        refine_kw = dict(steps=refine_steps, t_start=refine_t,
                         noise_scale=refine_noise, guidance=refine_guidance,
                         clamp_mode=refine_clamp, resample=refine_resample,
                         self_cond=refine_selfcond)

    @torch.inference_mode()
    def infer(wav: torch.Tensor, mask, frames: torch.Tensor | None = None,
              fold: int = 0, noise=None) -> torch.Tensor:
        tmask, base = task_masks(mask, wav.shape[0], cfg, external_mask,
                                 with_base=refiner is not None)
        batch, (re_in, im_in) = preprocess_with_stft(
            wav, tmask.to(wav.device), cfg)
        feats = None
        if cfg.use_video:
            if frames is None:
                raise ValueError("cfg.use_video: infer needs frames")
            feats = V(frames)
        x = g_input(batch)
        if len(gens) == 1:
            fake = gens[0](x, feats)
        else:
            fake = torch.stack([g(x, feats) for g in gens]).mean(0)
        if refiner is not None:
            g_img = fake[:, :1]

            def sample_stats(nz, c):
                return {"x": ddim_refine(refiner, tile(g_img, c),
                                         tile_batch(batch, c), nz,
                                         **refine_kw)}

            refined = chunked_mean(
                sample_stats,
                noise_source(noise, base, fold, tuple(g_img.shape),
                             refine_steps, refine_resample, wav.device),
                max(refine_avg, 1), refine_chunk)["x"]
            if refine_mix > 0.0:
                refined = refine_mix * g_img + (1.0 - refine_mix) * refined
            fake = torch.cat([refined, fake[:, 1:]], dim=1)
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
