"""Griffin-Lim phase recovery — the plain PyTorch version.

Port of `viai_tpu/signal/griffin_lim.py`. Phase is carried as a
unit-norm (Re, Im) pair, so the loop needs no angle/exp, only the DFT
products and a normalization. Momentum follows librosa.griffinlim
(fast Griffin-Lim, momentum=0.99).

Phase-aware mode (`observed=`): the complex STFT of the OBSERVED region
is known, so observed bins are clamped to it on every synthesis
(S = fmask·S_in + (1−fmask)·mag·e^{jφ}) and only the hole's phase is
recovered.

`griffin_lim` here is the plain version of the Hopper kernel in
`csrc/griffin_lim.cu`: the CPU tests hold it against the JAX package,
and `chip_smoke.py` holds the kernel against it on the card.
"""

from __future__ import annotations

import math

import torch

from .stft import STFTConfig, istft, stft


def _unit(re, im, eps=1e-16):
    inv = torch.rsqrt(re * re + im * im + eps)
    return re * inv, im * inv


def _last_valid(val: torch.Tensor, valid: torch.Tensor):
    """Per frame t (axis -2): `val` at the last frame ≤ t where
    valid > 0 (else 0), and whether such a frame exists (0/1 float).

    A cummax over masked frame indices; the JAX package computes the
    same take-last-valid with `lax.associative_scan`.
    """
    n = val.shape[-2]
    t = torch.arange(n, device=val.device).view(n, 1)
    idx = torch.where(valid > 0, t, -1)
    last = torch.cummax(idx, dim=-2).values
    ok = last >= 0
    out = torch.gather(val, -2, last.clamp(min=0))
    return torch.where(ok, out, 0.0), ok.to(val.dtype)


def extrapolate_hole_phase(
    fmask: torch.Tensor,
    re_in: torch.Tensor,
    im_in: torch.Tensor,
    shape: tuple[int, ...],
    bidirectional: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Phase-vocoder init for the hole: (re0, im0) unit phasors.

    Frame t inside the hole starts at phase(S[t0]) + (t−t0)·angle(ρ),
    where t0 is the last observed frame before the hole and
    ρ = S[t0]·conj(S[t0−1]) the per-bin rotor measured there. Frames
    with no observed predecessor keep the zero-phase init.

    bidirectional=True (default): also extrapolate backward from the
    hole's right boundary (the time-flip of the forward pass) and blend
    the two unit phasors weighted by proximity to each boundary,
    renormalized; one-sided where only one anchor exists.

    fmask: (..., F, 1) or (..., F, n_bins), 1 = observed; re_in/im_in:
    the input's complex STFT, broadcastable to `shape` = (..., F, n_bins).
    """
    shape = tuple(shape)
    if bidirectional:
        def flip(x):
            return torch.flip(x, dims=(-2,))

        fre, fim = extrapolate_hole_phase(fmask, re_in, im_in, shape,
                                          bidirectional=False)
        bre, bim = extrapolate_hole_phase(
            flip(fmask.expand(shape)), flip(re_in.expand(shape)),
            flip(im_in.expand(shape)), shape, bidirectional=False,
        )
        bre, bim = flip(bre), flip(bim)
        obs = fmask.float().expand(shape)
        n = shape[-2]
        t_idx = torch.arange(n, dtype=torch.float32,
                             device=obs.device).view(n, 1).expand(shape)
        t0, ok_f = _last_valid(t_idx, obs)
        t1r, ok_b = _last_valid(flip((n - 1.0 - t_idx) * obs), flip(obs))
        t1 = n - 1.0 - flip(t1r)
        ok_b = flip(ok_b)
        d_f = torch.clamp(t_idx - t0, min=0.0)      # dist from left obs
        d_b = torch.clamp(t1 - t_idx, min=0.0)      # dist to right obs
        # Closer boundary gets the larger weight; one-sided where the
        # other anchor is missing.
        w_f = torch.where(ok_f > 0, d_b + 1.0, 0.0)
        w_b = torch.where(ok_b > 0, d_f + 1.0, 0.0)
        tot = w_f + w_b
        w_f = torch.where(tot > 0, w_f / torch.clamp(tot, min=1e-6), 0.0)
        w_b = torch.where(tot > 0, w_b / torch.clamp(tot, min=1e-6), 0.0)
        zre = w_f * fre + w_b * bre
        zim = w_f * fim + w_b * bim
        # Antiphase cancellation → keep the nearer side instead of a
        # degenerate near-zero blend.
        small = (zre * zre + zim * zim) < 1e-4
        nearer_f = w_f >= w_b
        zre = torch.where(small, torch.where(nearer_f, fre, bre), zre)
        zim = torch.where(small, torch.where(nearer_f, fim, bim), zim)
        re0, im0 = _unit(zre, zim)
        re0 = torch.where(tot > 0, re0, 1.0)
        im0 = torch.where(tot > 0, im0, 0.0)
        return re0, im0
    obs = fmask.float().expand(shape)
    ure, uim = _unit(re_in.float().expand(shape), im_in.float().expand(shape))
    n = shape[-2]
    t_idx = torch.arange(n, dtype=torch.float32,
                         device=obs.device).view(n, 1)

    # Boundary phasor p(t0) and its frame index t0, carried forward.
    pre, _ = _last_valid(ure, obs)
    pim, _ = _last_valid(uim, obs)
    t0, ok = _last_valid(t_idx.expand(shape), obs)

    # Measured rotor at observed frames: ρ[t] = S[t]·conj(S[t−1]),
    # valid where both frames are observed; carried forward like p.
    ure1 = torch.roll(ure, 1, dims=-2)
    uim1 = torch.roll(uim, 1, dims=-2)
    rre = ure * ure1 + uim * uim1
    rim = uim * ure1 - ure * uim1
    pair = obs * torch.roll(obs, 1, dims=-2)
    pair[..., 0, :] = 0.0
    rho_re, _ = _last_valid(rre, pair)
    rho_im, rho_ok = _last_valid(rim, pair)

    # init = p(t0) rotated by (t − t0)·angle(ρ); transcendentals run
    # once at init time, not inside the GL loop.
    theta = torch.atan2(rho_im, rho_re) * rho_ok
    ang = torch.clamp(t_idx - t0, min=0.0) * theta
    c, s = torch.cos(ang), torch.sin(ang)
    ire = pre * c - pim * s
    iim = pre * s + pim * c
    # No observed predecessor (hole at clip start) → zero phase.
    re0 = torch.where(ok > 0, ire, 1.0)
    im0 = torch.where(ok > 0, iim, 0.0)
    return re0, im0


def prepare_gl(
    mag: torch.Tensor,
    observed: tuple[torch.Tensor, torch.Tensor, torch.Tensor] | None,
    phase_init: str,
    init: tuple[torch.Tensor, torch.Tensor] | None,
    generator: torch.Generator | None = None,
):
    """The observed pre-fold and the initial phase, shared by the plain
    version and the kernel's wrapper.

    → (mag', obs, re0, im0): mag' = (1−fmask)·mag, obs = (fmask·re_in,
    fmask·im_in) or None, (re0, im0) the initial unit phasors.
    """
    mag = mag.float()
    obs = None
    if observed is not None:
        fmask, re_in, im_in = observed
        fmask = fmask.float()
        # Pre-fold: synthesis S = obs + mag_hole · e^{jφ}.
        obs = ((fmask * re_in.float()).expand(mag.shape),
               (fmask * im_in.float()).expand(mag.shape))
        mag = (1.0 - fmask) * mag
    if init is not None:
        re = init[0].float().expand(mag.shape)
        im = init[1].float().expand(mag.shape)
    elif phase_init == "extrapolate":
        if observed is None:
            raise ValueError("phase_init='extrapolate' requires observed=")
        re, im = extrapolate_hole_phase(fmask, re_in, im_in, mag.shape)
    elif phase_init != "zero":
        raise ValueError(f"unknown phase_init {phase_init!r}")
    elif generator is None:
        re = torch.ones_like(mag)
        im = torch.zeros_like(mag)
    else:
        ang = torch.rand(mag.shape, generator=generator, device=mag.device,
                         dtype=torch.float32) * (2.0 * math.pi)
        re, im = torch.cos(ang), torch.sin(ang)
    return mag, obs, re, im


def griffin_lim(
    mag: torch.Tensor,
    cfg: STFTConfig,
    n_iter: int = 32,
    length: int | None = None,
    momentum: float = 0.99,
    generator: torch.Generator | None = None,
    observed: tuple[torch.Tensor, torch.Tensor, torch.Tensor] | None = None,
    phase_init: str = "zero",
    init: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> torch.Tensor:
    """(..., F, n_bins) magnitude → (..., T) waveform.

    Zero-phase init by default; pass a `generator` for random phase
    init (librosa `init='random'`). `observed=(fmask, re_in, im_in)`
    holds observed bins verbatim (fmask (..., F, 1) or broadcastable,
    1 = observed). phase_init="extrapolate" (requires `observed`) seeds
    the hole by phase-vocoder extrapolation; `init=(re0, im0)` overrides
    with an explicit unit-phasor field.
    """
    griffin_lim.calls += 1
    mag, obs, re, im = prepare_gl(mag, observed, phase_init, init, generator)

    def synth(re, im):
        sre, sim = mag * re, mag * im
        if obs is not None:
            sre = sre + obs[0]
            sim = sim + obs[1]
        return sre, sim

    # librosa.griffinlim fast-GL update:
    #   angles = rebuilt − (m / (1+m)) · rebuilt_prev, renormalized.
    beta = momentum / (1.0 + momentum)
    pre = torch.zeros_like(mag)
    pim = torch.zeros_like(mag)
    for _ in range(n_iter):
        wav = istft(*synth(re, im), cfg, length=length)
        nre, nim = stft(wav, cfg)
        re, im = _unit(nre - beta * pre, nim - beta * pim)
        pre, pim = nre, nim
    return istft(*synth(re, im), cfg, length=length)


griffin_lim.calls = 0
