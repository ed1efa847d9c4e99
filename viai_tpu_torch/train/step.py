"""GAN train step, in PyTorch.

Port of `viai_tpu/train/step.py::make_train_step` and `init_state`.
One step: waveforms → STFT images with gap masks → (V →) G → D loss
and G loss → one update of D (by `d_opt`) and one of G and V jointly
(by `g_opt`). The optimizers are arguments, as the JAX package takes
its optax transforms: `schedules.Adam` for training (it takes the loss
for the plateau policy), any torch optimizer otherwise (the tests and
chip_smoke.py use SGD).

Update order (cfg.update_order):
  * "simultaneous": both gradients against the pre-update D; one G
    forward serves G's loss and (detached) D's;
  * "sequential": D steps first on the detached fake, then G's loss is
    taken against the updated D (the reference's order). The JAX
    package recomputes the same fake with the same dropout key; here
    the one G forward serves both, and D's forward for G's loss is
    built after D's step, so autograd never sees a parameter changed
    in place under a saved graph.

G's gradients come from `torch.autograd.grad` over G's and V's
parameters only: D's parameters sit in G's loss graph (G differentiates
through D) but get no gradient from it, as in the JAX package, which
differentiates the G loss with respect to (G, V) alone.

Randomness comes from one explicit `torch.Generator`, drawn in this
order: the gap masks, G's dropout keep-masks, the pool's draws. Each
can be given instead (`tmask=`, `dropout=`, `pool_draw=`), which is
how the tests feed the JAX package's draws. The dropout masks are
drawn before G's forward, so cfg.remat (G's forward under
torch.utils.checkpoint, recomputed in the backward pass) replays them.

Data parallelism (`mesh`, train/mesh.py): each rank is called with its
rows of the global batch. The draws are made (or given) for the global
batch and sliced; the weighted losses divide by the global weight sum,
batch norms take global moments, the pool is updated from every rank's
fakes, and both nets' gradients and the reported losses are averaged
over the data group before the updates: every rank takes the
single-device step of the global batch.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..nn.losses import (feature_matching_loss, gan_loss, generator_gan_loss,
                         hole_spectral_convergence_loss, masked_l1_loss,
                         masked_l2_loss, onset_l1_loss, phase_cosine_loss)
from ..signal.mask import sample_batch_masks
from ..signal.mel import decompress
from .config import TrainConfig
from .mesh import (Mesh, all_gather_rows, average_gradients, average_metrics,
                   data_mean, global_rows, local_rows, sync_batch_stats)
from .preprocess import g_input, preprocess_with_mask
from .pool import draw_pool, init_pool, query_pool
from .schedules import optimizer_step


def init_state(D: torch.nn.Module, cfg: TrainConfig | None = None) -> dict:
    """The train state besides the modules and optimizers: the step
    count and, with cfg.pool_size > 0, the ImagePool on D's device (its
    items are D inputs, (D.cfg.in_channels, n_bins, image_frames))."""
    state = {"step": 0}
    if cfg is not None and cfg.pool_size > 0:
        state["pool"] = init_pool(
            cfg.pool_size, (D.cfg.in_channels, cfg.n_bins, cfg.image_frames),
            device=next(D.parameters()).device)
    return state


def _nchw(img: torch.Tensor) -> torch.Tensor:
    return img.permute(0, 3, 1, 2)


def _set_grads(params, loss):
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    for p, g in zip(params, grads):
        p.grad = torch.zeros_like(p) if g is None else g


def make_train_step(G, D, V, g_opt: torch.optim.Optimizer,
                    d_opt: torch.optim.Optimizer, cfg: TrainConfig,
                    mesh: Mesh | None = None):
    """Build train_step(state, wav (B, T), frames (B, T, H, W, 3) or
    None, generator=None, frames_valid (B,) or None, *, tmask=None,
    dropout=None, pool_draw=None) → metrics.

    The modules and optimizers are updated in place; `state` (from
    init_state) gets the new step count and pool. `g_opt` must hold G's
    parameters and, with cfg.use_video, V's; `d_opt` D's. Metrics are
    0-dim tensors on the device (reading them waits for the step).
    With a `mesh`, wav, frames and frames_valid are this rank's rows and
    tmask, dropout and pool_draw are the global batch's; the modules
    are replicated (train/mesh.py::replicate) and the optimizers
    replicated or sharded (shard_params) by the caller.
    """
    if cfg.update_order not in ("simultaneous", "sequential"):
        raise ValueError(f"unknown update_order {cfg.update_order!r}")
    if cfg.use_video and V is None:
        raise ValueError("cfg.use_video requires V (a VideoFeatureNet)")
    gv_params = list(G.parameters()) + (
        list(V.parameters()) if cfg.use_video else [])
    d_params = list(D.parameters())
    sync_batch_stats(G, mesh)
    sync_batch_stats(D, mesh)
    total = None if mesh is None else (lambda x: data_mean(x, mesh))

    def d_input(x, img):
        return torch.cat([x, img], dim=1) if cfg.conditional_d else img

    def d_loss_fn(batch, x, fake_d_in):
        real_logits = D(d_input(x, _nchw(batch["real_img"])))
        fake_logits = D(fake_d_in)
        l_real = gan_loss(real_logits, True, cfg.gan_mode)
        l_fake = gan_loss(fake_logits, False, cfg.gan_mode)
        loss = 0.5 * (l_real + l_fake)
        return loss, {"loss_D_real": l_real, "loss_D_fake": l_fake,
                      "loss_D": loss}

    def g_loss_fn(batch, x, fake):
        # NHWC like the batch; D sees the magnitude channel only.
        fake = fake.permute(0, 2, 3, 1)
        fake_mag = fake[..., :1] if cfg.phase_head else fake
        fake_in = d_input(x, _nchw(fake_mag))
        if cfg.lambda_fm > 0.0:
            fake_logits, fake_feats = D(fake_in, return_features=True)
            with torch.no_grad():
                _, real_feats = D(d_input(x, _nchw(batch["real_img"])),
                                  return_features=True)
            l_gan = generator_gan_loss(fake_logits, cfg.gan_mode)
        else:
            l_gan = generator_gan_loss(D(fake_in), cfg.gan_mode)
        real, mask = batch["real_img"], batch["mask_img"]
        l_l1 = masked_l1_loss(fake_mag, real, mask,
                              hole_weight=cfg.hole_weight, total=total)
        loss = l_gan + cfg.lambda_l1 * l_l1
        metrics = {"loss_G_GAN": l_gan, "loss_G_L1": l_l1}
        if cfg.lambda_l2 > 0.0:
            l_l2 = masked_l2_loss(fake_mag, real, mask,
                                  hole_weight=cfg.hole_weight, total=total)
            loss = loss + cfg.lambda_l2 * l_l2
            metrics["loss_G_L2"] = l_l2
        if cfg.lambda_sc > 0.0:
            l_sc = hole_spectral_convergence_loss(
                decompress(fake_mag[..., 0], cfg.compress_ceiling),
                decompress(real[..., 0], cfg.compress_ceiling),
                mask[..., 0])
            loss = loss + cfg.lambda_sc * l_sc
            metrics["loss_G_SC"] = l_sc
        if cfg.lambda_onset > 0.0:
            l_on = onset_l1_loss(fake_mag, real, mask,
                                 hole_weight=cfg.hole_weight, total=total)
            loss = loss + cfg.lambda_onset * l_on
            metrics["loss_G_onset"] = l_on
        if cfg.phase_head and cfg.lambda_phase > 0.0:
            l_ph = phase_cosine_loss(
                fake[..., 1], fake[..., 2],
                batch["phase_img"][..., 0], batch["phase_img"][..., 1],
                mask[..., 0], decompress(real[..., 0], cfg.compress_ceiling),
                total=total)
            loss = loss + cfg.lambda_phase * l_ph
            metrics["loss_G_phase"] = l_ph
        if cfg.lambda_fm > 0.0:
            l_fm = feature_matching_loss(fake_feats, real_feats)
            loss = loss + cfg.lambda_fm * l_fm
            metrics["loss_G_FM"] = l_fm
        metrics["loss_G"] = loss
        return loss, metrics

    def train_step(state: dict, wav: torch.Tensor,
                   frames: torch.Tensor | None = None,
                   generator: torch.Generator | None = None,
                   frames_valid: torch.Tensor | None = None, *,
                   tmask: torch.Tensor | None = None,
                   dropout: list[torch.Tensor] | None = None,
                   pool_draw: tuple[torch.Tensor, torch.Tensor] | None = None
                   ) -> dict[str, torch.Tensor]:
        B = global_rows(wav.shape[0], mesh)
        need = [tmask is None, dropout is None and G.dropout_blocks > 0,
                pool_draw is None and cfg.pool_size > 0]
        if any(need) and generator is None:
            raise ValueError("train_step needs a generator for the draws "
                             "it is not given")
        if tmask is None:
            tmask = sample_batch_masks(generator, B, cfg.image_frames,
                                       cfg.mask)
        batch = preprocess_with_mask(
            wav, local_rows(tmask.to(wav.device), mesh), cfg)
        x = g_input(batch)
        if need[1]:
            dropout = G.dropout_masks((B, *x.shape[1:]), generator)
        if need[2]:
            pool_draw = draw_pool(generator, B, cfg.pool_size)
        if dropout is not None:
            dropout = [local_rows(d, mesh) for d in dropout]

        def g_forward(x):
            feats = None
            if cfg.use_video:
                feats = V(frames)
                if frames_valid is not None:
                    feats = feats * frames_valid[:, None, None]
            return G(x, feats, dropout)

        fake = (checkpoint(g_forward, x, use_reentrant=False) if cfg.remat
                else g_forward(x))

        def fake_for_d():
            mag = fake[:, :1] if cfg.phase_head else fake
            fake_in = d_input(x, mag.detach())
            if cfg.pool_size > 0:
                # The pool holds the global batch's fakes on every rank.
                state["pool"], fake_in = query_pool(
                    state["pool"], all_gather_rows(fake_in, mesh),
                    *pool_draw)
                fake_in = local_rows(fake_in, mesh)
            return fake_in

        if cfg.update_order == "sequential":
            loss_D, d_metrics = d_loss_fn(batch, x, fake_for_d())
            _set_grads(d_params, loss_D)
            average_gradients(d_params, mesh)
            optimizer_step(d_opt, data_mean(loss_D.detach(), mesh))
            loss_G, g_metrics = g_loss_fn(batch, x, fake)
            _set_grads(gv_params, loss_G)
        else:
            loss_G, g_metrics = g_loss_fn(batch, x, fake)
            _set_grads(gv_params, loss_G)
            loss_D, d_metrics = d_loss_fn(batch, x, fake_for_d())
            _set_grads(d_params, loss_D)
            average_gradients(d_params, mesh)
            optimizer_step(d_opt, data_mean(loss_D.detach(), mesh))
        average_gradients(gv_params, mesh)
        optimizer_step(g_opt, data_mean(loss_G.detach(), mesh))
        d_opt.zero_grad(set_to_none=True)
        g_opt.zero_grad(set_to_none=True)
        state["step"] += 1
        return average_metrics({k: v.detach() for k, v in
                                {**d_metrics, **g_metrics}.items()}, mesh)

    return train_step
