"""Griffin-Lim on the card: the wrapper of the Hopper kernel.

Port of `viai_tpu/signal/pallas_gl.py::griffin_lim_pallas`. The kernel
is `csrc/griffin_lim.cu`; its plain version is `griffin_lim` (imported
here, so that the two sit side by side).

`griffin_lim_cuda` dispatches on the tensor's device: a CPU tensor runs
the plain version, a CUDA tensor launches the kernel or raises. There
is no fallback from the card to the plain version.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .._build import library
from .griffin_lim import griffin_lim, prepare_gl
from .stft import (STFTConfig, _dft_bases, _idft_bases, _padded_window,
                   _window_sumsquare)

__all__ = ["griffin_lim", "griffin_lim_cuda"]


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = library("griffin_lim")
    fn = lib.viai_griffin_lim
    fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=8)
def _constants(cfg: STFTConfig, n_frames: int, device: torch.device):
    """Window-folded bases and 1/env, as the TPU kernel folds them:
    (syn_basis (2·n_bins, n_fft), cosw, sinw (n_fft, n_bins), inv_env)."""
    win = _padded_window(cfg)
    cos_b, sin_b = _dft_bases(cfg.n_fft)
    icos, isin = _idft_bases(cfg.n_fft)
    cosw = (win[:, None] * cos_b).astype(np.float32)
    sinw = (win[:, None] * sin_b).astype(np.float32)
    syn = np.concatenate([icos * win[None, :], isin * win[None, :]])
    env = _window_sumsquare(cfg, n_frames).astype(np.float64)
    inv_env = (1.0 / np.maximum(env, 1e-10)).astype(np.float32)
    return tuple(torch.from_numpy(np.ascontiguousarray(a, np.float32))
                 .to(device) for a in (syn, cosw, sinw, inv_env))


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def griffin_lim_cuda(
    mag: torch.Tensor,
    cfg: STFTConfig,
    n_iter: int = 32,
    length: int | None = None,
    momentum: float = 0.99,
    observed: tuple[torch.Tensor, torch.Tensor, torch.Tensor] | None = None,
    phase_init: str = "zero",
    init: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> torch.Tensor:
    """(B, F, n_bins) magnitude → (B, length) waveform.

    Same function as `griffin_lim`. On a CUDA tensor it requires
    cfg.center and length == hop·(F−1), the exact inverse length of
    fixed-size clips (the serving path), and runs the whole loop in the
    Hopper kernel; the observed pre-fold and the phase init run in plain
    torch before it, as the JAX package computes them outside its
    Pallas kernel.
    """
    if mag.device.type == "cpu":
        return griffin_lim(mag, cfg, n_iter=n_iter, length=length,
                           momentum=momentum, observed=observed,
                           phase_init=phase_init, init=init)
    if mag.device.type != "cuda":
        raise ValueError(f"griffin_lim_cuda: unsupported device {mag.device}")
    if not cfg.center:
        raise ValueError("griffin_lim_cuda implements the center=True layout")
    if mag.dim() != 3 or mag.shape[-1] != cfg.n_bins:
        raise ValueError(f"mag must be (B, F, {cfg.n_bins}), got "
                         f"{tuple(mag.shape)}")
    if n_iter < 0:
        raise ValueError(f"n_iter must be >= 0, got {n_iter}")
    B, F, n_bins = mag.shape
    n, hop = cfg.n_fft, cfg.hop_length
    T = hop * (F - 1) + n - 2 * (n // 2)
    if length is None:
        length = T
    if length != T:
        raise ValueError(f"length must be {T} for {F} frames, got {length}")
    if T <= n // 2:
        raise ValueError(f"clip of {T} samples is too short to reflect-pad "
                         f"by {n // 2}")
    tensors = [mag] + list(observed or ()) + list(init or ())
    if any(t.device != mag.device for t in tensors):
        raise ValueError("griffin_lim_cuda: all inputs must be on one device")

    magp, obs, re0, im0 = prepare_gl(mag, observed, phase_init, init)
    magp = magp.contiguous()
    if obs is not None:
        obs = tuple(o.contiguous() for o in obs)
    # The kernel updates the phase in place: give it tensors of its own.
    re = torch.empty_like(magp).copy_(re0)
    im = torch.empty_like(magp).copy_(im0)
    pre = torch.zeros_like(magp)
    pim = torch.zeros_like(magp)
    frames = torch.empty((B * F, n), dtype=torch.float32, device=mag.device)
    out = torch.empty((B, T), dtype=torch.float32, device=mag.device)
    syn, cosw, sinw, inv_env = _constants(cfg, F, mag.device)
    stream = torch.cuda.current_stream(mag.device).cuda_stream
    with torch.cuda.device(mag.device):
        rc = _lib().viai_griffin_lim(
            _ptr(magp), _ptr(obs[0] if obs else None),
            _ptr(obs[1] if obs else None), _ptr(re), _ptr(im), _ptr(pre),
            _ptr(pim), _ptr(frames), _ptr(syn), _ptr(cosw), _ptr(sinw),
            _ptr(inv_env), _ptr(out), B, F, n_bins, n, hop, n_iter,
            momentum / (1.0 + momentum), stream)
    if rc != 0:
        raise RuntimeError(f"griffin_lim kernel launch failed: CUDA error {rc}")
    griffin_lim_cuda.launches += 1
    return out


griffin_lim_cuda.launches = 0
