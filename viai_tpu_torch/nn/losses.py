"""GAN and reconstruction losses, in PyTorch.

Port of `viai_tpu/nn/losses.py`: pure functions over tensors in the
JAX package's layouts — NHWC images (B, bins, T, C), (B, bins, T)
linear magnitudes — and over D's logits, a tensor or a list of
per-scale tensors (the multi-scale D), whose loss is the mean over
scales.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def gan_loss(logits, target_is_real: bool, mode: str = "lsgan"):
    """Patch logits → scalar adversarial loss. lsgan: MSE to 1/0
    targets; vanilla: sigmoid BCE; hinge: the D-side hinge."""
    if isinstance(logits, (list, tuple)):
        return sum(gan_loss(l, target_is_real, mode)
                   for l in logits) / len(logits)
    if mode == "lsgan":
        tgt = 1.0 if target_is_real else 0.0
        return torch.mean((logits - tgt) ** 2)
    if mode == "vanilla":
        tgt = (torch.ones_like(logits) if target_is_real
               else torch.zeros_like(logits))
        return F.binary_cross_entropy_with_logits(logits, tgt)
    if mode == "hinge":
        if target_is_real:
            return torch.mean(torch.clamp(1.0 - logits, min=0.0))
        return torch.mean(torch.clamp(1.0 + logits, min=0.0))
    raise ValueError(f"unknown gan mode: {mode}")


def generator_gan_loss(logits, mode: str = "lsgan"):
    """G's adversarial loss: hinge's is −mean(logits) (SA-GAN); the
    other modes use gan_loss with real targets."""
    if isinstance(logits, (list, tuple)):
        return sum(generator_gan_loss(l, mode)
                   for l in logits) / len(logits)
    if mode == "hinge":
        return -torch.mean(logits)
    return gan_loss(logits, True, mode)


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - target))


def _total(w, total):
    s = torch.sum(w)
    return s if total is None else total(s)


def masked_l1_loss(pred, target, keep_mask, hole_weight: float = 1.0,
                   context_weight: float = 1.0, total=None):
    """L1 weighted by region: keep_mask 1 = observed (context_weight),
    0 = hole (hole_weight). `total` (here and in the other weighted
    losses) maps the weight sum before the division: under data
    parallelism the data group's mean (train/mesh.py::data_mean), so
    that the ranks' mean loss is the global batch's."""
    err = torch.abs(pred - target)
    w = keep_mask * context_weight + (1.0 - keep_mask) * hole_weight
    return torch.sum(err * w) / (_total(w, total) + 1e-8)


def masked_l2_loss(pred, target, keep_mask, hole_weight: float = 1.0,
                   context_weight: float = 1.0, total=None):
    """The squared-error twin of masked_l1_loss."""
    err = (pred - target) ** 2
    w = keep_mask * context_weight + (1.0 - keep_mask) * hole_weight
    return torch.sum(err * w) / (_total(w, total) + 1e-8)


def hole_spectral_convergence_loss(pred_mag, target_mag, keep_mask):
    """‖(1−m)·(|S_pred| − |S_tgt|)‖_F / ‖(1−m)·|S_tgt|‖_F on linear
    magnitudes (B, bins, T), mean over the batch."""
    hole = 1.0 - keep_mask
    dims = tuple(range(1, pred_mag.dim()))
    num = torch.sqrt(torch.sum((hole * (pred_mag - target_mag)) ** 2, dim=dims))
    den = torch.sqrt(torch.sum((hole * target_mag) ** 2, dim=dims))
    return torch.mean(num / torch.clamp(den, min=1e-6))


def feature_matching_loss(feats_fake, feats_real):
    """Mean over layers of the L1 between D's features on fake and on
    real; the real features are detached, so the term shapes G only."""
    tot = 0.0
    for ff, fr in zip(feats_fake, feats_real):
        tot = tot + torch.mean(torch.abs(ff - fr.detach()))
    return tot / max(len(feats_fake), 1)


def phase_cosine_loss(pred_cos, pred_sin, true_re_unit, true_im_unit,
                      keep_mask, weight, total=None):
    """Magnitude-weighted 1 − cos(φ_pred − φ_true) over the hole, from
    unit phasors: the prediction (any magnitude) is normalised here;
    each bin is weighted by `weight` (the true linear magnitude) and
    only where keep_mask is 0."""
    inv = torch.rsqrt(pred_cos * pred_cos + pred_sin * pred_sin + 1e-8)
    cosd = (pred_cos * true_re_unit + pred_sin * true_im_unit) * inv
    w = (1.0 - keep_mask) * weight
    return torch.sum(w * (1.0 - cosd)) / (_total(w, total) + 1e-8)


def onset_l1_loss(pred, target, keep_mask, hole_weight: float = 1.0,
                  total=None):
    """L1 on the time derivative of (B, bins, T, C) compressed images;
    a frame pair straddling the hole boundary counts as hole."""
    dp = pred[..., 1:, :] - pred[..., :-1, :]
    dt = target[..., 1:, :] - target[..., :-1, :]
    m = torch.minimum(keep_mask[..., 1:, :], keep_mask[..., :-1, :])
    w = m + (1.0 - m) * hole_weight
    return torch.sum(torch.abs(dp - dt) * w) / (_total(w, total) + 1e-8)
