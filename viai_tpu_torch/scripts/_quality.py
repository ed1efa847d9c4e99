"""What the quality scripts share: the hole-PSNR of the chain, the
options' --gpu_ids of a device, and the name of the device a record was
measured on."""

from __future__ import annotations

import torch

from .._device import resolve_device
from ..signal.mel import compress
from ..signal.stft import stft_magnitude
from ..train import TrainConfig, make_infer_fn, preprocess_with_mask
from ..utils.metrics import masked_psnr


def hole_psnr(G: torch.nn.Module, V: torch.nn.Module | None,
              cfg: TrainConfig, eval_wav: torch.Tensor, tmask: torch.Tensor,
              frames: torch.Tensor | None = None, n_gl_iter: int = 8
              ) -> float:
    """Mean over the batch of the PSNR inside the gaps of `tmask`
    ((B, image_frames), 1 = observed), in the compressed-magnitude
    image: the chain (G, GL×n_gl_iter) inpaints `eval_wav` with those
    gaps, and its output's STFT is scored against the input's over the
    STFT's frames (`scripts/quality_report.py:77-87`)."""
    with torch.no_grad():
        pre = preprocess_with_mask(eval_wav, tmask, cfg)
        infer = make_infer_fn(G, cfg, n_gl_iter=n_gl_iter, V=V)
        out_wav = infer(eval_wav, tmask, frames)
        img = compress(stft_magnitude(out_wav, cfg.stft)
                       .transpose(-1, -2))[..., None]
        n_fr = img.shape[2]
        return float(masked_psnr(img, pre["real_img"][:, :, :n_fr],
                                 pre["mask_img"][:, :, :n_fr]).mean())


def device_name(dev: torch.device) -> str:
    """The card's name, or "cpu"."""
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def gpu_ids(device: str) -> str:
    """The options' --gpu_ids for `device` ("-1": the CPU); raises for
    a card when there is none."""
    dev = resolve_device(device)
    return "-1" if dev.type == "cpu" else str(dev.index or 0)
