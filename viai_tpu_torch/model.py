"""Task model — the reference's `create_model(opt)` / BaseModel surface,
in PyTorch.

Port of `viai_tpu/model.py`: build G, D (and V for --model av) from the
options, take a batch (set_input), run one GAN step
(optimize_parameters), report losses, lr and visuals, save or load
checkpoints; and the evaluation surface: the inference chain of the
test options (`infer_fn`, `test()`), a deep ensemble of the Gs of
--ensemble_names, and the diffusion refiner R of --refiner in either
domain. The step and the chains are train/; this class owns the
modules, the optimizers, the train state, one torch.Generator for the
step's draws and the checkpoint naming. It runs on the device of
--gpu_ids (the card unless -1).

Multi-process (train/mesh.py): the mesh is (--n_data_devices,
--n_model_devices) over the process group's ranks (0 data devices = the
world's size over the model axis). Every rank is given the global batch
(set_input keeps its rows) and takes the single-device step of the
global batch; the nets are replicated from rank 0 and, over a model
axis, the optimizers sharded. Rank 0 writes the checkpoints.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from .config.options import device_from_opt
from .io import (load_networks, load_train_state, save_networks,
                 save_train_state)
from .nn import define_D, define_G, define_R, define_V
from .signal import MaskConfig, STFTConfig, sample_batch_masks
from .signal.mel import compress
from .signal.stft import stft_magnitude
from .train import (TrainConfig, adam, init_state, make_infer_fn,
                    make_schedule, make_train_step, plateau_kwargs,
                    plateau_scale, preprocess_with_mask)
from .train.diffusion import (complex_refiner_channels,
                              make_complex_refiner_infer_fn)
from .train.mesh import (all_gather_rows, batch_sharding, global_rows,
                         local_rows, make_mesh, shard_params)


def train_config_from_opt(opt) -> TrainConfig:
    long_gap = getattr(opt, "long_gap", False)
    min_gap, max_gap = opt.min_gap_frames, opt.max_gap_frames
    if long_gap and (min_gap, max_gap) == (25, 50):
        min_gap, max_gap = 75, 150  # long-gap defaults
    fixed_start = None
    if getattr(opt, "dataset_mode", "").endswith("_cue"):
        # av_cue corpus: the cue-dependent event lives at a fixed clip
        # position, so the mask covers exactly that span.
        from .data.synthetic import AV_CUE_GAP

        fixed_start = AV_CUE_GAP[0]
        min_gap = max_gap = AV_CUE_GAP[1] - AV_CUE_GAP[0]
    return TrainConfig(
        stft=STFTConfig(n_fft=opt.n_fft, hop_length=opt.hop_length),
        mask=MaskConfig(
            min_gap_frames=min_gap,
            max_gap_frames=max_gap,
            num_gaps=opt.num_gaps,
            fixed_start=fixed_start,
        ),
        multi_res=long_gap,
        image_frames=opt.image_frames,
        gan_mode="vanilla" if getattr(opt, "no_lsgan", False) else opt.gan_mode,
        lambda_l1=getattr(opt, "lambda_L1", 100.0),
        lambda_l2=getattr(opt, "lambda_L2", 0.0),
        hole_weight=getattr(opt, "hole_weight", 1.0),
        lambda_sc=getattr(opt, "lambda_sc", 0.0),
        lambda_onset=getattr(opt, "lambda_onset", 0.0),
        lambda_fm=getattr(opt, "lambda_fm", 0.0),
        phase_head=getattr(opt, "phase_head", False),
        lambda_phase=getattr(opt, "lambda_phase", 1.0),
        use_video=opt.model == "av",
        update_order=getattr(opt, "update_order", "simultaneous"),
        pool_size=getattr(opt, "pool_size", 0) if getattr(
            opt, "isTrain", True) else 0,
        n_bins=opt.n_fft // 2 + 1,
        remat=getattr(opt, "remat", False),
    )


class VIAIModel:
    """Audio-only or vision-infused inpainting model (opt.model)."""

    def __init__(self, opt, expr_dir: str | None = None):
        self.opt = opt
        self.isTrain = getattr(opt, "isTrain", True)
        self.cfg = train_config_from_opt(opt)
        self.expr_dir = expr_dir or f"{opt.checkpoints_dir}/{opt.name}"
        self.mesh = make_mesh(getattr(opt, "n_data_devices", 0) or None,
                              devices=device_from_opt(opt),
                              n_model=max(getattr(opt, "n_model_devices", 1),
                                          1))
        self.device = self.mesh.device

        use_video = opt.model == "av"
        fusion = opt.fusion_channels if use_video else 0
        # Bottleneck time axis = image_frames / prod(time strides) = /16.
        bott_time = opt.image_frames // 16
        input_nc = opt.input_nc
        if self.cfg.multi_res and input_nc == 2:
            input_nc = 3  # + coarse-hop spectrogram channel
        init_type = getattr(opt, "init_type", "normal")
        init_gain = getattr(opt, "init_gain", 0.02)
        dropout = 0.0 if getattr(opt, "no_dropout", False) else 0.5
        dil = getattr(opt, "bottleneck_dilation", "") or ""
        dilation = tuple(int(d) for d in str(dil).split(",") if d.strip())
        # Phase head: +2 G output channels (cos, sin); D judges the
        # magnitude only, so its candidate input stays opt.output_nc.
        g_out = opt.output_nc + (2 if self.cfg.phase_head else 0)
        g_kw = dict(fusion_channels=fusion,
                    upsample=getattr(opt, "upsample", "deconv"),
                    init_type=init_type, init_gain=init_gain,
                    dropout=dropout, bottleneck_dilation=dilation,
                    bottleneck_attn=getattr(opt, "bottleneck_attn", 0),
                    attn_heads=getattr(opt, "attn_heads", 8),
                    gated=getattr(opt, "gated", False), device=self.device)
        self.G = define_G(input_nc, g_out, opt.ngf, opt.norm, opt.dtype,
                          seed=opt.seed, **g_kw)
        self.D = define_D(input_nc + opt.output_nc, opt.ndf, opt.n_layers_D,
                          opt.norm, opt.dtype, seed=opt.seed + 1,
                          init_type=init_type, init_gain=init_gain,
                          num_D=getattr(opt, "num_D", 1), device=self.device)
        self.V = None
        if use_video:
            self.V = define_V(opt.fusion_channels, bott_time, dtype=opt.dtype,
                              seed=opt.seed + 2, init_type=init_type,
                              init_gain=init_gain, device=self.device)

        lr = getattr(opt, "lr", 2e-4)
        sched_kw = dict(
            niter=getattr(opt, "niter", 100),
            niter_decay=getattr(opt, "niter_decay", 100),
            lr_decay_iters=getattr(opt, "lr_decay_iters", 50),
            steps_per_epoch=max(getattr(opt, "steps_per_epoch", 1), 1),
        )
        policy = getattr(opt, "lr_policy", "constant")
        plateau_kw = (plateau_kwargs(sched_kw["steps_per_epoch"])
                      if policy == "plateau" else None)
        beta1 = getattr(opt, "beta1", 0.5)
        # The schedule the G optimizer reads, kept for get_current_lr.
        self._lr_schedule = make_schedule(policy, lr, **sched_kw)
        gv = list(self.G.parameters()) + (
            list(self.V.parameters()) if self.V is not None else [])
        self.g_opt = adam(gv, self._lr_schedule, beta1=beta1,
                          plateau=plateau_kw)
        self.d_opt = adam(self.D.parameters(),
                          make_schedule(policy, lr, **sched_kw),
                          beta1=beta1, plateau=plateau_kw)
        self.state = init_state(self.D, self.cfg)
        # Replicated from rank 0; over a model axis the optimizers are
        # sharded (the same placement the JAX package reapplies on load).
        placed = shard_params({**self._nets(), "g_opt": self.g_opt,
                               "d_opt": self.d_opt}, self.mesh)
        self.g_opt, self.d_opt = placed["g_opt"], placed["d_opt"]
        if self.isTrain:
            self.train_step = make_train_step(self.G, self.D, self.V,
                                              self.g_opt, self.d_opt,
                                              self.cfg, mesh=self.mesh)
        # Seed ensemble (--ensemble_names): the extra runs' Gs, of G's
        # architecture; load_networks fills them from their run dirs and
        # the chain averages all K predictions.
        self._ensemble_names = [
            n.strip() for n in
            str(getattr(opt, "ensemble_names", "") or "").split(",")
            if n.strip()]
        self._refiner_domain = getattr(opt, "refiner_domain", "mag")
        use_refiner = not self.isTrain and getattr(opt, "refiner", False)
        if (self._ensemble_names and self._refiner_domain == "complex"
                and getattr(opt, "refiner", False)):
            raise ValueError("--ensemble_names is not supported with "
                             "--refiner_domain complex")
        self.ensemble = [define_G(input_nc, g_out, opt.ngf, opt.norm,
                                  opt.dtype, seed=opt.seed, **g_kw)
                         for _ in self._ensemble_names]
        # The diffusion refiner (evaluation only); load_networks restores
        # {refiner_epoch}_net_{refiner_net}.pth.
        self.R = None
        if use_refiner:
            sc = getattr(opt, "refine_selfcond", False)
            if self._refiner_domain == "complex":
                r_in, r_out = complex_refiner_channels(input_nc, self_cond=sc)
            else:
                r_in, r_out = input_nc + 2 + (1 if sc else 0), 1
            self.R = define_R(r_in, getattr(opt, "rngf", 64), dtype=opt.dtype,
                              seed=opt.seed + 3, out_channels=r_out,
                              device=self.device)
        self.infer_fn = self._build_infer_fn()
        self.generator = torch.Generator(device=self.device).manual_seed(
            opt.seed)
        self._input = None
        self._losses: dict = {}
        self._last_tmask = None      # gap masks of the latest train step
        self._vis_infer = None       # external-mask chain for visuals

    def _build_infer_fn(self):
        """The evaluation chain, masks drawn from a torch.Generator:
        infer(wav, generator, frames=None, fold=0); fold s is another
        posterior sample of the refiner on the same task."""
        opt = self.opt
        common = dict(refine_avg=getattr(opt, "refine_avg", 1),
                      refine_chunk=getattr(opt, "refine_chunk", 8),
                      external_mask=False)
        if self.R is not None and self._refiner_domain == "complex":
            return make_complex_refiner_infer_fn(
                self.G, self.R, self.cfg,
                steps=getattr(opt, "refine_steps", 8),
                t_start=getattr(opt, "refine_t", 1.0),
                noise_scale=getattr(opt, "refine_noise", 1.0),
                guidance=getattr(opt, "refine_guidance", 0.0),
                clamp_mode=getattr(opt, "refine_clamp", "x0"),
                resample=getattr(opt, "refine_resample", 0),
                complex_mag=getattr(opt, "complex_mag", "sample"),
                self_cond=getattr(opt, "refine_selfcond", False), V=self.V,
                **common)
        return make_infer_fn(
            [self.G, *self.ensemble], self.cfg,
            n_gl_iter=getattr(opt, "gl_iters", 32),
            phase_aware=not getattr(opt, "no_phase_aware", False),
            phase_init=getattr(opt, "phase_init", "auto"),
            mag_sharpen=getattr(opt, "mag_sharpen", 1.0),
            oracle_mag=getattr(opt, "oracle_mag", False), V=self.V,
            refiner=self.R, refine_steps=getattr(opt, "refine_steps", 8),
            refine_t=getattr(opt, "refine_t", 0.35),
            refine_noise=getattr(opt, "refine_noise", 1.0),
            refine_guidance=getattr(opt, "refine_guidance", 0.0),
            refine_clamp=getattr(opt, "refine_clamp", "x0"),
            refine_resample=getattr(opt, "refine_resample", 0),
            refine_mix=getattr(opt, "refine_mix", 0.0),
            refine_selfcond=getattr(opt, "refine_selfcond", False), **common)

    # ---- reference BaseModel surface ------------------------------------

    def _to_device(self, x) -> torch.Tensor:
        """A host array, a host tensor or a tensor already on the device
        (data/prefetch.py) → float32 on the model's device."""
        t = (x if torch.is_tensor(x)
             else torch.as_tensor(np.asarray(x, np.float32))).float()
        if self.device.type == "cuda" and t.device.type == "cpu":
            # Pinned staging (the host allocator reuses a block only once
            # its copy is done), then a copy that does not block the host.
            return (t if t.is_pinned() else t.pin_memory()).to(
                self.device, non_blocking=True)
        return t.to(self.device)

    @property
    def batch_sharding(self):
        """The batch axis over the mesh's data axis (train/mesh.py)."""
        return batch_sharding(self.mesh)

    def set_input(self, batch: dict):
        """Global batch dict (host or device) → this rank's rows on the
        model's device."""
        n_data = self.mesh.shape["data"]
        if len(batch["wav"]) % n_data:
            raise ValueError(
                f"batchSize {len(batch['wav'])} must be divisible by the "
                f"data mesh axis ({n_data} devices); set --batchSize or "
                f"--n_data_devices accordingly")
        rows = self.batch_sharding.local

        def put(x):
            return None if x is None else rows(self._to_device(x))

        self._input = {"wav": put(batch["wav"]),
                       "frames": put(batch.get("frames")),
                       "frames_valid": put(batch.get("frames_valid"))}

    def optimize_parameters(self):
        wav = self._input["wav"]
        # The global batch's masks, drawn on every rank alike.
        tmask = sample_batch_masks(self.generator,
                                   global_rows(wav.shape[0], self.mesh),
                                   self.cfg.image_frames, self.cfg.mask)
        self._losses = self.train_step(
            self.state, wav, self._input["frames"], self.generator,
            self._input["frames_valid"], tmask=tmask)
        self._last_tmask = local_rows(tmask, self.mesh)

    def get_current_losses(self) -> dict[str, float]:
        return {k: float(v) for k, v in self._losses.items()}

    def get_current_lr(self) -> float:
        """The lr of the next G update: the schedule at the live step
        count, times the plateau scale under --lr_policy plateau."""
        lr = float(self._lr_schedule(self.state["step"]))
        scale = plateau_scale(self.g_opt)
        return lr * scale if scale is not None else lr

    def update_learning_rate(self):
        """Reference BaseModel API: the schedule is step-addressed inside
        the optimizer; this reports it, as the reference prints it."""
        print(f"learning rate = {self.get_current_lr():.7f}")

    def eval(self):
        """Reference BaseModel API. No-op: the chains run without
        gradients and without dropout whatever the modules' mode (G's
        dropout acts only when the step passes it a source), and the
        batch norm keeps no running statistics."""
        return self

    def train(self):
        """Reference BaseModel API counterpart of eval(); no-op."""
        return self

    def set_requires_grad(self, *args, **kwargs):
        """Reference BaseModel API. No-op: the train step takes each
        net's gradients explicitly (torch.autograd.grad over G's and
        V's parameters, D's loss on a detached fake), not by
        per-parameter flags."""

    def get_current_visuals(self) -> dict[str, np.ndarray]:
        """Real, masked and inpainted spectrograms of the first clip,
        (H, W) numpy in [0, 1]. The masks are those of the last train
        step, and the inpainting runs the external-mask chain (GL on the
        card) with them, so the three images belong together."""
        if self._input is None:
            return {}
        wav = self._input["wav"]
        tmask = self._last_tmask
        if tmask is None:
            tmask = sample_batch_masks(
                torch.Generator(device=self.device).manual_seed(
                    self.opt.seed), wav.shape[0], self.cfg.image_frames,
                self.cfg.mask)
        pre = preprocess_with_mask(wav, tmask, self.cfg)
        out = {
            "real": ((pre["real_img"][0, :, :, 0] + 1) / 2).cpu().numpy(),
            "masked": ((pre["masked_img"][0, :, :, 0] + 1) / 2).cpu().numpy(),
        }
        if self._vis_infer is None:
            self._vis_infer = make_infer_fn(
                self.G, self.cfg, n_gl_iter=getattr(self.opt, "gl_iters", 32),
                phase_aware=not getattr(self.opt, "no_phase_aware", False),
                phase_init=getattr(self.opt, "phase_init", "auto"), V=self.V)
        fake = self._vis_infer(wav, pre["mask_img"][:, 0, :, 0],
                               self._input["frames"])
        mag = stft_magnitude(fake[:1], self.cfg.stft)
        img = compress(mag.transpose(-1, -2))
        out["inpainted"] = ((img[0] + 1) / 2).cpu().numpy()
        return out

    def test(self, generator: torch.Generator | None = None) -> np.ndarray:
        """No-grad inference on the current input, gaps drawn from
        `generator` (default: a CPU generator seeded 0) → the inpainted
        waveform batch, host numpy. Under a data axis every rank runs
        the chain on the global batch (the ranks' rows gathered), whose
        masks are the generator's draws for the whole batch."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        frames = self._input["frames"]
        out = self.infer_fn(
            all_gather_rows(self._input["wav"], self.mesh), generator,
            None if frames is None else all_gather_rows(frames, self.mesh))
        return out.cpu().numpy()

    def _nets(self) -> dict:
        nets = {"G": self.G, "D": self.D}
        if self.V is not None:
            nets["V"] = self.V
        return nets

    def _train_state(self) -> dict:
        pool = self.state.get("pool")
        return {
            "nets": {k: v.state_dict() for k, v in self._nets().items()},
            "g_opt": self.g_opt.state_dict(),
            "d_opt": self.d_opt.state_dict(),
            "step": self.state["step"],
            "pool": None if pool is None else dict(pool),
            "rng": self.generator.get_state(),
        }

    def save_networks(self, which_epoch):
        """`{epoch}_net_{G,D,V}.pth` in the JAX package's schema, and the
        full train state `{epoch}_state.pt` for --continue_train. Every
        rank gathers the state (a sharded optimizer's is split over the
        model axis); rank 0 writes it."""
        state = self._train_state()
        if dist.is_initialized() and dist.get_rank() != 0:
            return
        save_networks(self._nets(), which_epoch, self.expr_dir)
        save_train_state(state, which_epoch, self.expr_dir)

    def load_networks(self, which_epoch):
        """Restore the full train state, strictly; a checkpoint with
        `.pth` files only (e.g. from the JAX package) restores the
        weights and leaves the rest as built. The ensemble's Gs and the
        refiner, when the options ask for them, load from their `.pth`
        files."""
        self._load_eval_nets(which_epoch)
        try:
            st = load_train_state(which_epoch, self.expr_dir)
        except FileNotFoundError:
            load_networks(self._nets(), which_epoch, self.expr_dir)
            return
        nets = self._nets()
        if set(st["nets"]) != set(nets):
            raise KeyError(f"checkpoint nets {sorted(st['nets'])} do not "
                           f"match the model's {sorted(nets)}")
        for name, net in nets.items():
            net.load_state_dict(st["nets"][name])
        self.g_opt.load_state_dict(st["g_opt"])
        self.d_opt.load_state_dict(st["d_opt"])
        self.state["step"] = int(st["step"])
        if (st["pool"] is None) != ("pool" not in self.state):
            raise ValueError("the checkpoint's pool does not match "
                             "--pool_size")
        if st["pool"] is not None:
            self.state["pool"] = {"buf": st["pool"]["buf"].to(self.device),
                                  "n": int(st["pool"]["n"])}
        self.generator.set_state(st["rng"])

    def _load_eval_nets(self, which_epoch):
        """The ensemble's Gs from `{checkpoints_dir}/{name}` at the same
        epoch, and R from `{refiner_epoch}_net_{refiner_net}.pth`."""
        for name, G in zip(self._ensemble_names, self.ensemble):
            load_networks({"G": G}, which_epoch,
                          f"{self.opt.checkpoints_dir}/{name}")
        if self.R is not None:
            load_networks({getattr(self.opt, "refiner_net", "R"): self.R},
                          getattr(self.opt, "refiner_epoch", "latest"),
                          self.expr_dir)


def create_model(opt) -> VIAIModel:
    """The reference's models.create_model(opt) entry."""
    return VIAIModel(opt)
