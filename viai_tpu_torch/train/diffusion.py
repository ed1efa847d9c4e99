"""Diffusion schedule, DDIM refinement of the hole and the refiner's
training, in PyTorch.

Port of `viai_tpu/train/diffusion.py`: the cosine ᾱ schedule with
v-prediction, DDIM refinement of G's compressed magnitude image
(`ddim_refine`) and of the hole's compressed complex STFT
(`ddim_refine_complex`), the chunked posterior mean (`chunked_mean`),
the GL-free complex-domain chain (`make_complex_refiner_infer_fn`), and
stage-2 training of R against a frozen G in both domains
(`make_refiner_train_step`, `make_complex_refiner_train_step`). The
magnitude-domain chain is `train/infer.py::make_infer_fn(refiner=R)`.

Layouts: images here are NCHW, (B, C, n_bins, image_frames), as R
computes; the preprocess dict (`batch`) keeps the chain's NHWC layout
and is converted where it is read. The JAX package's `lax.scan` over
the (t, u) ladder, `linspace(t_start, 0, steps + 1)` in float32, is a
Python loop; its schedule coefficients are computed once per step in
float32 on the host.

Randomness. jax.random's bits cannot be reproduced in torch, so every
sampler takes its standard-normal draws explicitly (`noise=`, a
`RefineNoise`: ε₀ and the (steps, resample) re-noise tensors) or draws
them from a `torch.Generator`, ε₀ first, then the re-noise tensors in
(step, round) order. The chains give posterior sample s of the mean
its own generator, seeded from (base, fold, s) (`sample_generator`):
sample 0 is the single-sample stream, and chunking cannot change the
noise a sample gets. The noise is scaled by `noise_scale` here, so
`noise=` carries unscaled draws. The train steps take theirs as
arguments (`tmask=`, `t=`, `eps=`, `keep=`, `sc_first_pass=`) or draw
them from one generator in that order; the JAX package's coin runs R's
extra pass when `bernoulli` is True, so `sc_first_pass` is that coin.
"""

from __future__ import annotations

import dataclasses
import math
import typing as tp

import numpy as np
import torch
import torch.nn.functional as F

from ..signal.mask import sample_batch_masks
from ..signal.mel import complex_compress, complex_decompress, decompress
from ..signal.stft import istft, stft
from .config import TrainConfig
from .mesh import (Mesh, average_gradients, average_metrics, data_mean,
                   global_rows, local_rows, sync_batch_stats)
from .preprocess import g_input, preprocess_with_stft, task_masks
from .schedules import optimizer_step

_COS_S = 0.008
CLAMP_MODES = ("x0", "q")
COMPLEX_MAGS = ("sample", "keep", "mean")


# ---------------------------------------------------------------------------
# Schedule and v-parameterization
# ---------------------------------------------------------------------------

def alpha_bar(t: torch.Tensor) -> torch.Tensor:
    """Cosine ᾱ(t), t ∈ [0, 1]; ᾱ(0) = 1, ᾱ(1) ≈ 0 (Nichol & Dhariwal)."""
    def f(u):
        return torch.cos(((u + _COS_S) / (1.0 + _COS_S)) * (math.pi / 2)) ** 2
    return f(t) / f(torch.zeros_like(t))


def ab_coeffs(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(a, σ) with a = √ᾱ(t), σ = √(1−ᾱ(t))."""
    ab = alpha_bar(t)
    return torch.sqrt(ab), torch.sqrt(torch.clamp(1.0 - ab, 0.0, 1.0))


def _per_sample(c: torch.Tensor, ndim: int) -> torch.Tensor:
    return c.reshape((-1,) + (1,) * (ndim - 1))


def q_sample(x0: torch.Tensor, t: torch.Tensor, eps: torch.Tensor):
    """Forward process: x_t = a·x0 + σ·ε; also returns the v target."""
    a, s = (_per_sample(c, x0.dim()) for c in ab_coeffs(t))
    return a * x0 + s * eps, a * eps - s * x0


def x0_eps_from_v(x_t: torch.Tensor, v: torch.Tensor, t: torch.Tensor):
    """Invert the v-parameterization: x̂0 = a·x_t − σ·v, ε̂ = σ·x_t + a·v."""
    a, s = (_per_sample(c, x_t.dim()) for c in ab_coeffs(t))
    return a * x_t - s * v, s * x_t + a * v


def _coeffs(t: float) -> tuple[float, float]:
    """ab_coeffs of one float32 time, as Python floats (exact)."""
    a, s = ab_coeffs(torch.tensor(t, dtype=torch.float32))
    return a.item(), s.item()


def _jump(t: float, u: float) -> tuple[float, float]:
    """√r and √(1−r), r = clip(ᾱ(t)/max(ᾱ(u), 1e-12), 0, 1): the
    RePaint jump back up from u to t."""
    ab_t, ab_u = alpha_bar(torch.tensor([t, u], dtype=torch.float32))
    r = torch.clamp(ab_t / torch.clamp(ab_u, min=1e-12), 0.0, 1.0)
    return torch.sqrt(r).item(), torch.sqrt(1.0 - r).item()


# ---------------------------------------------------------------------------
# Conditioning and noise
# ---------------------------------------------------------------------------

def refiner_cond(batch: dict, g_img: torch.Tensor) -> torch.Tensor:
    """Conditioning stack, NCHW: G's input channels (masked, mask[, lo])
    and G's magnitude output (B, 1, H, W). A refiner checkpoint is tied
    to its G config, as the G checkpoint is."""
    return torch.cat([g_input(batch), g_img], dim=1)


@dataclasses.dataclass(frozen=True)
class RefineNoise:
    """Unscaled standard-normal draws of one DDIM run: eps0 (B, C, H, W)
    and renoise (steps, resample, B, C, H, W), None without resampling."""

    eps0: torch.Tensor
    renoise: torch.Tensor | None = None

    def to(self, device) -> "RefineNoise":
        return RefineNoise(self.eps0.to(device),
                           None if self.renoise is None
                           else self.renoise.to(device))


def draw_noise(generator: torch.Generator, shape: tuple[int, ...],
               steps: int, resample: int) -> RefineNoise:
    """ε₀, then the re-noise tensors in (step, round) order, from
    `generator`, on its device."""
    dev = generator.device
    eps0 = torch.randn(shape, generator=generator, device=dev)
    renoise = (torch.randn((steps, resample, *shape), generator=generator,
                           device=dev) if resample > 0 else None)
    return RefineNoise(eps0, renoise)


def cat_noise(noises: tp.Sequence[RefineNoise]) -> RefineNoise:
    """Several runs' draws as one run at the summed batch."""
    if len(noises) == 1:
        return noises[0]
    ren = [n.renoise for n in noises]
    return RefineNoise(torch.cat([n.eps0 for n in noises]),
                       None if ren[0] is None else torch.cat(ren, dim=2))


def sample_generator(base: int, fold: int, s: int,
                     device: str | torch.device) -> torch.Generator:
    """The generator of posterior sample s of the noise stream (base,
    fold), on `device`; its seed mixes the three by numpy's SeedSequence."""
    seq = np.random.SeedSequence([base % 2**63, fold % 2**63, s])
    seed = int(seq.generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(seed)


def noise_source(noise: tp.Sequence[RefineNoise] | None, base: int,
                 fold: int, shape: tuple[int, ...], steps: int,
                 resample: int, device) -> tp.Callable[[int], RefineNoise]:
    """s → the draws of posterior sample s: noise[s] when the caller
    gave them, else drawn from sample_generator(base, fold, s)."""
    if noise is not None:
        return lambda s: noise[s].to(device)
    return lambda s: draw_noise(sample_generator(base, fold, s, device),
                                shape, steps, resample)


def tile(x: torch.Tensor, c: int) -> torch.Tensor:
    """x repeated c times along the batch (x itself for c = 1)."""
    return x if c == 1 else x.repeat(c, *(1,) * (x.dim() - 1))


def tile_batch(batch: dict, c: int) -> dict:
    """The preprocess dict repeated c times along the batch: the
    conditioning of c posterior samples run as one batch."""
    return {k: tile(v, c) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# DDIM
# ---------------------------------------------------------------------------

def check_clamp_mode(clamp_mode: str):
    if clamp_mode not in CLAMP_MODES:
        raise ValueError(f"unknown clamp_mode: {clamp_mode!r}")


def _noise(noise, generator, shape, steps, resample, device) -> RefineNoise:
    if noise is None:
        if generator is None:
            raise ValueError("pass noise= or a generator")
        noise = draw_noise(generator, shape, steps, resample)
    if noise.eps0.shape != shape or (resample > 0 and (
            noise.renoise is None
            or noise.renoise.shape != (steps, resample, *shape))):
        raise ValueError(f"noise does not fit a run of shape {shape}, "
                         f"{steps} steps, resample {resample}")
    return noise.to(device)


def _ddim(R, x, cond, obs, m, eps0, renoise, *, steps, t_start, noise_scale,
          guidance, uncond, clamp_mode, resample, self_cond):
    """The DDIM ladder t_start → 0 from x, the observed region clamped
    (clamp_mode 'x0') or re-noised to q(x_u | x0) ('q') at each step;
    `uncond` is the conditioning channel the guidance arm zeroes."""
    B = x.shape[0]
    ts = torch.linspace(t_start, 0.0, steps + 1, dtype=torch.float32).tolist()
    if guidance > 0.0:
        cond_u = cond.clone()
        cond_u[:, uncond] = 0.0
        cond2 = torch.cat([cond, cond_u])

    def predict_v(x, t, sc):
        tail = [sc] if self_cond else []
        tb = torch.full((B,), t, device=x.device)
        if guidance > 0.0:
            v2 = R(torch.cat([torch.cat([x, x]), cond2]
                             + [torch.cat([s, s]) for s in tail], dim=1),
                   torch.cat([tb, tb]))
            return (1.0 + guidance) * v2[:B] - guidance * v2[B:]
        return R(torch.cat([x, cond] + tail, dim=1), tb)

    def denoise(x, sc, t, u):
        v_hat = predict_v(x, t, sc)
        at, st = _coeffs(t)
        x0_hat, eps_hat = at * x - st * v_hat, st * x + at * v_hat
        au, su = _coeffs(u)
        if clamp_mode == "x0":
            x0_hat = m * obs + (1.0 - m) * x0_hat
            return au * x0_hat + su * eps_hat, x0_hat
        # 'q': the hole evolves by DDIM, the observed region is re-noised.
        x_hole = au * x0_hat + su * eps_hat
        x_obs = au * obs + su * eps0
        return (m * x_obs + (1.0 - m) * x_hole,
                m * obs + (1.0 - m) * x0_hat)

    sc = torch.zeros_like(x)
    for i in range(steps):
        t, u = ts[i], ts[i + 1]
        for j in range(resample):
            # RePaint: denoise t → u, then jump back up u → t.
            x, sc = denoise(x, sc, t, u)
            up, fresh = _jump(t, u)
            x = up * x + fresh * (noise_scale * renoise[i, j])
            if clamp_mode == "q":
                at, st = _coeffs(t)
                x = m * (at * obs + st * eps0) + (1.0 - m) * x
        x, sc = denoise(x, sc, t, u)
    return m * obs + (1.0 - m) * x


def ddim_refine(R: torch.nn.Module, g_img: torch.Tensor, batch: dict,
                noise: RefineNoise | None = None,
                generator: torch.Generator | None = None, steps: int = 8,
                t_start: float = 0.35, noise_scale: float = 1.0,
                guidance: float = 0.0, clamp_mode: str = "x0",
                resample: int = 0, self_cond: bool = False) -> torch.Tensor:
    """Refine G's compressed magnitude image g_img (B, 1, H, W) with
    truncated DDIM → (B, 1, H, W).

    SDEdit: diffuse g_img to t_start (x = a·g_img + σ·ε₀), then `steps`
    DDIM steps to t = 0, the observed region of x̂0 clamped to the known
    image at each step; t_start = 1 is full generation. noise_scale
    scales every draw (0: deterministic). guidance > 0: classifier-free
    guidance, R on a 2B batch whose second half has the g_pred channel
    (the conditioning's last) zeroed, v = (1+g)·v_cond − g·v_uncond.
    clamp_mode 'q' re-noises the observed region to q(x_u | x0) instead
    of clamping x̂0. resample > 0: that many RePaint rounds (denoise
    t → u, re-noise u → t) before each step's descent. self_cond: R
    gets the previous step's clamped x̂0 as a trailing channel (zeros at
    the first step).
    """
    check_clamp_mode(clamp_mode)
    obs = batch["masked_img"].permute(0, 3, 1, 2)
    m = batch["mask_img"].permute(0, 3, 1, 2)
    cond = refiner_cond(batch, g_img)
    noise = _noise(noise, generator, tuple(g_img.shape), steps, resample,
                   g_img.device)
    eps0 = noise_scale * noise.eps0
    a0, s0 = _coeffs(t_start)
    x = a0 * g_img + s0 * eps0
    if clamp_mode == "q":
        x = m * (a0 * obs + s0 * eps0) + (1.0 - m) * x
    return _ddim(R, x, cond, obs, m, eps0, noise.renoise, steps=steps,
                 t_start=t_start, noise_scale=noise_scale, guidance=guidance,
                 uncond=cond.shape[1] - 1, clamp_mode=clamp_mode,
                 resample=resample, self_cond=self_cond)


# ---------------------------------------------------------------------------
# Complex domain: the hole's compressed complex STFT, decoded by one iSTFT
# ---------------------------------------------------------------------------

def _complex_image(re: torch.Tensor, im: torch.Tensor,
                   cfg: TrainConfig) -> torch.Tensor:
    re, im = re.transpose(-1, -2), im.transpose(-1, -2)   # (B, bins, F)
    pad = cfg.image_frames - re.shape[-1]
    cre, cim = complex_compress(F.pad(re, (0, pad)), F.pad(im, (0, pad)),
                                cfg.compress_ceiling)
    return torch.stack([cre, cim], dim=1)


def complex_image(wav: torch.Tensor, cfg: TrainConfig) -> torch.Tensor:
    """(B, T) waveform → (B, 2, bins, image_frames) compressed complex
    STFT image (preprocess's layout and padding; magnitude
    log1p-compressed, phase exact)."""
    return _complex_image(*stft(wav, cfg.stft), cfg)


def complex_refiner_cond(batch: dict, g_img: torch.Tensor,
                         cplx: torch.Tensor) -> torch.Tensor:
    """Conditioning of the complex-domain refiner, NCHW: G's input
    channels, G's magnitude prediction, the masked compressed complex
    (re, im)."""
    m = batch["mask_img"].permute(0, 3, 1, 2)
    return torch.cat([g_input(batch), g_img, cplx * m], dim=1)


def complex_refiner_channels(input_nc: int,
                             self_cond: bool = False) -> tuple[int, int]:
    """(R in_channels, out_channels) for a G with `input_nc` input
    channels: x_t (2) + cond (input_nc + g_pred + masked complex 2)
    [+ 2 self-conditioning channels]."""
    return 2 + input_nc + 1 + 2 + (2 if self_cond else 0), 2


def _mag_only_complex(g_img: torch.Tensor) -> torch.Tensor:
    """G's [-1, 1] compressed magnitude image → zero-phase compressed
    complex channels (re = |c| in [0, 1], im = 0)."""
    cmag = torch.clamp((g_img[:, 0] + 1.0) * 0.5, 0.0, 1.0)
    return torch.stack([cmag, torch.zeros_like(cmag)], dim=1)


def ddim_refine_complex(R: torch.nn.Module, g_img: torch.Tensor, batch: dict,
                        cplx: torch.Tensor, noise: RefineNoise | None = None,
                        generator: torch.Generator | None = None,
                        steps: int = 8, t_start: float = 1.0,
                        noise_scale: float = 1.0, guidance: float = 0.0,
                        clamp_mode: str = "x0", resample: int = 0,
                        self_cond: bool = False) -> torch.Tensor:
    """DDIM over the compressed complex image cplx (B, 2, H, W) of the
    input waveform → the refined complex image. Its observed region is
    exact and kept; the hole starts from G's magnitude at zero phase
    (pure noise at t_start = 1). The guidance arm zeroes g_pred, the
    conditioning's third channel from the end. Otherwise as ddim_refine.
    """
    check_clamp_mode(clamp_mode)
    m = batch["mask_img"].permute(0, 3, 1, 2)
    obs = cplx * m
    cond = complex_refiner_cond(batch, g_img, cplx)
    noise = _noise(noise, generator, tuple(cplx.shape), steps, resample,
                   cplx.device)
    eps0 = noise_scale * noise.eps0
    a0, s0 = _coeffs(t_start)
    x = a0 * (obs + (1.0 - m) * _mag_only_complex(g_img)) + s0 * eps0
    return _ddim(R, x, cond, obs, m, eps0, noise.renoise, steps=steps,
                 t_start=t_start, noise_scale=noise_scale, guidance=guidance,
                 uncond=cond.shape[1] - 3, clamp_mode=clamp_mode,
                 resample=resample, self_cond=self_cond)


# ---------------------------------------------------------------------------
# Chunked posterior mean
# ---------------------------------------------------------------------------

def chunked_mean(sample_stats: tp.Callable[[RefineNoise, int], dict],
                 noise_for: tp.Callable[[int], RefineNoise], k: int,
                 chunk: int) -> dict:
    """Mean over posterior samples 0..k−1 of the dict of tensors that
    `sample_stats(noise, c)` returns for c samples run as one batch
    (their draws concatenated along the batch, leading c·B), at most
    `chunk` samples at a time: a running float32 sum over full chunks,
    then the remainder. Peak memory is that of chunk·B whatever k is;
    the result is the unchunked mean up to summation order."""
    chunk = max(1, min(chunk, k))
    total = None
    for lo in range(0, k, chunk):
        c = min(chunk, k - lo)
        stats = sample_stats(cat_noise([noise_for(s)
                                        for s in range(lo, lo + c)]), c)
        part = {n: v.reshape(c, -1, *v.shape[1:]).sum(0)
                for n, v in stats.items()}
        total = part if total is None else {n: total[n] + part[n]
                                            for n in total}
    return {n: v / k for n, v in total.items()}


# ---------------------------------------------------------------------------
# The GL-free serving chain
# ---------------------------------------------------------------------------

def make_complex_refiner_infer_fn(
    G: torch.nn.Module, R: torch.nn.Module, cfg: TrainConfig,
    steps: int = 8, t_start: float = 1.0, noise_scale: float = 1.0,
    guidance: float = 0.0, clamp_mode: str = "x0", resample: int = 0,
    refine_avg: int = 1, refine_chunk: int = 8, complex_mag: str = "sample",
    self_cond: bool = False, V: torch.nn.Module | None = None,
    external_mask: bool = True,
) -> tp.Callable[..., torch.Tensor]:
    """Build infer(wav (B, T), mask, frames=None, fold=0, noise=None)
    → (B, T) wav: STFT → mask → G (magnitude conditioning) →
    complex-domain DDIM of the hole → composite complex spectrogram
    (observed region verbatim) → one iSTFT. No Griffin-Lim.

    `mask` is a (B, image_frames) keep-mask (external_mask=True, the
    serving path; the noise stream is fixed per call, base 0) or a
    torch.Generator from which the masks, then the stream's base seed,
    are drawn (external_mask=False, evaluation). refine_avg > 1 decodes
    the posterior mean of that many samples, refine_chunk at a time
    (`chunked_mean`). complex_mag: 'sample' decodes the mean itself;
    'keep' puts G's magnitude, 'mean' E[|x|] over the samples, under the
    mean's phase in the hole. The call's `fold` picks the noise stream;
    distinct folds are distinct posterior samples of the same task.
    `noise`, a list of refine_avg RefineNoise, stands in for the draws.
    """
    if complex_mag not in COMPLEX_MAGS:
        raise ValueError(f"unknown complex_mag: {complex_mag!r}")
    check_clamp_mode(clamp_mode)
    if cfg.use_video and V is None:
        raise ValueError("cfg.use_video requires V (a VideoFeatureNet)")
    kw = dict(steps=steps, t_start=t_start, noise_scale=noise_scale,
              guidance=guidance, clamp_mode=clamp_mode, resample=resample,
              self_cond=self_cond)
    ceiling = cfg.compress_ceiling

    @torch.inference_mode()
    def infer(wav: torch.Tensor, mask, frames: torch.Tensor | None = None,
              fold: int = 0,
              noise: tp.Sequence[RefineNoise] | None = None) -> torch.Tensor:
        tmask, base = task_masks(mask, wav.shape[0], cfg, external_mask)
        batch, (re_in, im_in) = preprocess_with_stft(
            wav, tmask.to(wav.device), cfg)
        feats = None
        if cfg.use_video:
            if frames is None:
                raise ValueError("cfg.use_video: infer needs frames")
            feats = V(frames)
        g_img = G(g_input(batch), feats)[:, :1]
        cplx = _complex_image(re_in, im_in, cfg)

        def sample_stats(nz, c):
            x = ddim_refine_complex(R, tile(g_img, c), tile_batch(batch, c),
                                    tile(cplx, c), nz, **kw)
            stats = {"c": x}
            if complex_mag == "mean":
                sre, sim = complex_decompress(x[:, 0], x[:, 1], ceiling)
                stats["mag"] = torch.sqrt(sre * sre + sim * sim)
            return stats

        stats = chunked_mean(
            sample_stats,
            noise_source(noise, base, fold, tuple(cplx.shape), steps,
                         resample, wav.device),
            max(refine_avg, 1), refine_chunk)
        refined = stats["c"]
        re, im = complex_decompress(refined[:, 0], refined[:, 1], ceiling)
        if complex_mag != "sample":
            # The posterior mean's unit phasor × the chosen magnitude, in
            # the hole only.
            inv = 1.0 / torch.sqrt(re * re + im * im).clamp_min(1e-12)
            mag_new = (decompress(g_img[:, 0], ceiling)
                       if complex_mag == "keep" else stats["mag"])
            hole = batch["mask_img"][..., 0] < 1.0
            re = torch.where(hole, re * inv * mag_new, re)
            im = torch.where(hole, im * inv * mag_new, im)
        n_frames = cfg.stft.num_frames(wav.shape[-1])
        re = re[..., :n_frames].transpose(-1, -2)          # (B, F, bins)
        im = im[..., :n_frames].transpose(-1, -2)
        return istft(re, im, cfg.stft, length=wav.shape[-1])

    return infer


# ---------------------------------------------------------------------------
# Stage-2 training: G (and V) frozen, R gets the gradients
# ---------------------------------------------------------------------------

def make_refiner_train_step(G, V, R, R_ema, opt: torch.optim.Optimizer,
                            cfg: TrainConfig, hole_weight: float = 3.0,
                            observed_weight: float = 1.0,
                            cond_drop: float = 0.0, ema_decay: float = 0.999,
                            self_cond: bool = False,
                            mesh: Mesh | None = None):
    """Build train_step(wav (B, T), generator=None, frames=None, *,
    tmask=None, t=None, eps=None, keep=None, sc_first_pass=None) →
    {"loss_R": 0-dim tensor}: one update of the magnitude-domain R
    (x0 is the compressed magnitude image real_img).

    One step: the preprocess with gap masks → the frozen G's forward
    (V's under cfg.use_video; no gradient, no dropout) → g_img = G's
    magnitude channel, zeroed per sample where keep is 0 (cond_drop > 0,
    classifier-free-guidance training) → x_t = q_sample(x0, t, ε) →
    R(x_t, cond[, sc]) → the v-MSE weighted by observed_weight on
    observed bins and hole_weight in the hole, Σ w·(v̂ − v)² / Σ w →
    `opt`'s update of R (schedules.Adam, or any torch optimizer) → the
    EMA R_ema ← decay·R_ema + (1 − decay)·R, which the caller starts as
    a copy of R. self_cond: R takes one more input channel, its own
    previous x̂0; with sc_first_pass R runs once without gradient on a
    zero channel and its x̂0 fills it, else the channel stays zero.

    Randomness: whatever is not given is drawn from `generator`, in
    this order: the gap masks tmask (B, image_frames), t ~ U(0, 1) (B,),
    ε ~ N(0, 1) shaped as x0, keep = U(0, 1) ≥ cond_drop (B,) under
    cond_drop > 0, and under self_cond the coin sc_first_pass = U(0, 1)
    < ½ (read on the host: a card generator makes the step wait).

    With a `mesh` (train/mesh.py), wav and frames are this rank's rows;
    the draws are the global batch's (drawn, or given) and sliced, the
    loss divides by the global weight sum, and R's gradients and the
    reported loss are averaged over the data group: every rank takes
    the single-device step of the global batch.
    """
    return _refiner_train_step(G, V, R, R_ema, opt, cfg, False, hole_weight,
                               observed_weight, cond_drop, ema_decay,
                               self_cond, mesh)


def make_complex_refiner_train_step(G, V, R, R_ema,
                                    opt: torch.optim.Optimizer,
                                    cfg: TrainConfig,
                                    hole_weight: float = 3.0,
                                    observed_weight: float = 1.0,
                                    cond_drop: float = 0.0,
                                    ema_decay: float = 0.999,
                                    self_cond: bool = False,
                                    mesh: Mesh | None = None):
    """make_refiner_train_step for the complex-domain R: x0 is the
    2-channel compressed complex image (complex_image) and the
    conditioning complex_refiner_cond. The weight w has the mask's one
    channel and multiplies both channels of (v̂ − v)², so the loss is
    Σ over both channels of w·(v̂ − v)² over Σ w of one channel, as the
    JAX package computes it."""
    return _refiner_train_step(G, V, R, R_ema, opt, cfg, True, hole_weight,
                               observed_weight, cond_drop, ema_decay,
                               self_cond, mesh)


def _refiner_train_step(G, V, R, R_ema, opt, cfg, complex_domain,
                        hole_weight, observed_weight, cond_drop, ema_decay,
                        self_cond, mesh):
    if cfg.use_video and V is None:
        raise ValueError("cfg.use_video requires V (a VideoFeatureNet)")
    params = list(R.parameters())
    ema = list(R_ema.parameters())
    if [p.shape for p in ema] != [p.shape for p in params]:
        raise ValueError("R_ema must have R's architecture")
    n_ch = 2 if complex_domain else 1
    for m in (G, R):
        sync_batch_stats(m, mesh)

    def train_step(wav: torch.Tensor, generator: torch.Generator | None = None,
                   frames: torch.Tensor | None = None, *,
                   tmask: torch.Tensor | None = None,
                   t: torch.Tensor | None = None,
                   eps: torch.Tensor | None = None,
                   keep: torch.Tensor | None = None,
                   sc_first_pass: bool | None = None
                   ) -> dict[str, torch.Tensor]:
        B, dev = global_rows(wav.shape[0], mesh), wav.device
        need = [tmask is None, t is None, eps is None,
                keep is None and cond_drop > 0.0,
                sc_first_pass is None and self_cond]
        if any(need) and generator is None:
            raise ValueError("train_step needs a generator for the draws "
                             "it is not given")
        if tmask is None:
            tmask = sample_batch_masks(generator, B, cfg.image_frames,
                                       cfg.mask)
        gdev = generator.device if generator is not None else dev
        if t is None:
            t = torch.rand((B,), generator=generator, device=gdev)
        if eps is None:
            eps = torch.randn((B, n_ch, cfg.n_bins, cfg.image_frames),
                              generator=generator, device=gdev)
        if need[3]:
            keep = torch.rand((B,), generator=generator, device=gdev) \
                >= cond_drop
        if need[4]:
            sc_first_pass = bool(torch.rand((), generator=generator,
                                            device=gdev) < 0.5)
        t, eps = local_rows(t.to(dev), mesh), local_rows(eps.to(dev), mesh)
        if keep is not None:
            keep = local_rows(keep, mesh)
        b = wav.shape[0]

        batch, (re, im) = preprocess_with_stft(
            wav, local_rows(tmask.to(dev), mesh), cfg)
        with torch.no_grad():
            feats = V(frames) if cfg.use_video else None
            g_img = G(g_input(batch), feats)[:, :1].float()
            if cond_drop > 0.0:
                g_img = g_img * keep.to(dev, g_img.dtype).reshape(b, 1, 1, 1)
        m = batch["mask_img"].permute(0, 3, 1, 2)
        if complex_domain:
            x0 = _complex_image(re, im, cfg)
            cond = complex_refiner_cond(batch, g_img, x0)
        else:
            x0 = batch["real_img"].permute(0, 3, 1, 2)
            cond = refiner_cond(batch, g_img)
        x_t, v_target = q_sample(x0, t, eps)
        inputs = [x_t, cond]
        if self_cond:
            sc = torch.zeros_like(x_t)
            if sc_first_pass:
                with torch.no_grad():
                    v0 = R(torch.cat([x_t, cond, sc], dim=1), t)
                    sc = x0_eps_from_v(x_t, v0, t)[0]
            inputs.append(sc)
        v_hat = R(torch.cat(inputs, dim=1), t)
        w = observed_weight * m + hole_weight * (1.0 - m)
        loss = (torch.sum(w * torch.square(v_hat - v_target))
                / data_mean(torch.sum(w), mesh))
        loss.backward()
        average_gradients(params, mesh)
        optimizer_step(opt, data_mean(loss.detach(), mesh))
        opt.zero_grad(set_to_none=True)
        with torch.no_grad():
            torch._foreach_mul_(ema, ema_decay)
            torch._foreach_add_(ema, params, alpha=1.0 - ema_decay)
        return average_metrics({"loss_R": loss.detach()}, mesh)

    return train_step
