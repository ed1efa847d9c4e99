"""Griffin-Lim on the card: the wrapper of the Hopper kernel.

Port of `viai_tpu/signal/pallas_gl.py::griffin_lim_pallas`. The kernel
is `csrc/griffin_lim.cu`; its plain version is `griffin_lim` (imported
here, so that the two sit side by side).

`griffin_lim_cuda` dispatches on the tensor's device: a CPU tensor runs
the plain version, a CUDA tensor launches the kernel or raises. There
is no fallback from the card to the plain version.

The kernel multiplies on the tensor cores in 3xTF32 (float32 accuracy
from three TF32 products). Its host-side layout lives here, where the
CPU tests reach it:
  * every row is `padded_width(n_fft)` = W floats (n_fft and the
    2·n_bins interleaved (re, im) columns rounded up to 128), zero in
    the pad;
  * the spectra are interleaved: column 2k is bin k's real part,
    2k + 1 its imaginary part;
  * the bases are K-major (N × K, K contiguous: `kernel_bases`), split
    into TF32 hi/lo halves (`tf32_split`) and stored as stage tiles
    (`stage_tiles`) once, cached by `_constants`.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as TF

from .._build import library
from .griffin_lim import griffin_lim, prepare_gl
from .stft import (STFTConfig, _dft_bases, _idft_bases, _padded_window,
                   _window_sumsquare)

__all__ = ["griffin_lim", "griffin_lim_cuda"]

ROW_ALIGN = 128          # the kernel's widest N tile; W is a multiple of it
TF32_DROP = 13           # float32 mantissa bits that TF32 drops (23 - 10)
STAGE_K = 16             # the kernel's depth per pipeline stage (BK)
BLOCK_ROWS = 128         # rows of every block tile (BM)
# The column widths of the kernel's block tiles, widest first.
TILES = (128, 64)


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = library("griffin_lim")
    fn = lib.viai_griffin_lim
    fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def pick_tile(rows: int, width: int, sms: int) -> int:
    """Column width of the block tile: the wider one when it still gives
    about one block per SM (the wider the tile, the fewer times the
    tiles re-read the A operand from L2), else the narrower one, whose
    twice as many blocks fill the card."""
    if 10 * (-(-rows // BLOCK_ROWS) * (width // TILES[0])) >= 9 * sms:
        return TILES[0]
    return TILES[1]


def padded_width(n_fft: int) -> int:
    """Row width W of every operand: n_fft and the 2·n_bins = n_fft + 2
    interleaved spectrum columns, rounded up to ROW_ALIGN."""
    return -(-(n_fft + 2) // ROW_ALIGN) * ROW_ALIGN


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 → nearest TF32 value (ties away from zero), as the
    card's `cvt.rna.tf32.f32`: add half a TF32 ulp to the magnitude
    bits, then clear the 13 mantissa bits TF32 drops."""
    bits = x.float().contiguous().view(torch.int32)
    half, low = 1 << (TF32_DROP - 1), (1 << TF32_DROP) - 1
    return ((bits + half) & ~low).view(torch.float32)


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x ≈ hi + lo with both halves TF32: hi keeps 11 significant bits,
    lo the next 11, so hi + lo is within 2⁻²² of x, relative."""
    hi = tf32_round(x)
    return hi, tf32_round(x.float() - hi)


def stage_tiles(b: torch.Tensor) -> torch.Tensor:
    """(N, K) K-major basis → the kernel's order, flat: for each
    STAGE_K-deep stage, for each group of 8 rows, its STAGE_K / 4
    core matrices of 8 rows × 4 columns (16 bytes a row), so that
    b[8·g + r, STAGE_K·s + 4·c + e] lands at
    (((s·N/8 + g)·STAGE_K/4 + c)·8 + r)·4 + e, as the shared-memory
    stage holds it and wgmma reads it."""
    n, k = b.shape
    t = b.reshape(n // 8, 8, k // STAGE_K, STAGE_K // 4, 4)
    return t.permute(2, 0, 3, 1, 4).contiguous().reshape(-1)


@dataclasses.dataclass(frozen=True)
class GLConstants:
    syn_hi: torch.Tensor   # stage tiles of syn (row n = sample, column
    syn_lo: torch.Tensor   # 2k | 2k+1 = bin k), W·W floats
    ana_hi: torch.Tensor   # stage tiles of ana (row 2k | 2k+1 = cos | sin
    ana_lo: torch.Tensor   # of bin k, column = sample), W·W floats
    inv_env: torch.Tensor  # (hop·(F−1) + n_fft,)


def _pad_square(x: torch.Tensor, w: int) -> torch.Tensor:
    return TF.pad(x, (0, w - x.shape[1], 0, w - x.shape[0])).contiguous()


def kernel_bases(cfg: STFTConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """The window-folded bases in the kernel's layout, float32 (before
    the TF32 split): (syn, ana), each (W, W), K-major.

    syn[n, 2k] = icos[k, n]·win[n], syn[n, 2k+1] = isin[k, n]·win[n];
    ana[2k, j] = win[j]·cos[j, k],  ana[2k+1, j] = win[j]·sin[j, k].
    """
    win = _padded_window(cfg)
    cos_b, sin_b = _dft_bases(cfg.n_fft)
    icos, isin = _idft_bases(cfg.n_fft)
    icosw = torch.from_numpy((icos * win[None, :]).astype(np.float32))
    isinw = torch.from_numpy((isin * win[None, :]).astype(np.float32))
    cosw = torch.from_numpy((win[:, None] * cos_b).astype(np.float32))
    sinw = torch.from_numpy((win[:, None] * sin_b).astype(np.float32))
    nb, n = icosw.shape
    w = padded_width(cfg.n_fft)
    syn = torch.stack((icosw.T, isinw.T), dim=-1).reshape(n, 2 * nb)
    ana = torch.stack((cosw.T, sinw.T), dim=1).reshape(2 * nb, n)
    return _pad_square(syn, w), _pad_square(ana, w)


@functools.lru_cache(maxsize=8)
def _constants(cfg: STFTConfig, n_frames: int,
               device: torch.device) -> GLConstants:
    """Split bases and 1/env on `device`, computed once per shape."""
    syn, ana = kernel_bases(cfg)
    env = _window_sumsquare(cfg, n_frames).astype(np.float64)
    inv_env = torch.from_numpy(
        (1.0 / np.maximum(env, 1e-10)).astype(np.float32))
    halves = (*tf32_split(syn), *tf32_split(ana))
    return GLConstants(*(stage_tiles(h).to(device) for h in halves),
                       inv_env.to(device))


def interleave(re: torch.Tensor, im: torch.Tensor, width: int) -> torch.Tensor:
    """(B, F, n_bins) pair → (B·F, width): (re, im) of bin k in columns
    2k and 2k + 1, zeros above 2·n_bins."""
    x = torch.stack((re, im), dim=-1).reshape(-1, 2 * re.shape[-1])
    return TF.pad(x, (0, width - x.shape[1])).contiguous()


@dataclasses.dataclass
class GLBuffers:
    """Inputs and scratch of one kernel call, in the kernel's layout."""
    mag: torch.Tensor            # (B·F, W/2): mag' = (1 − fmask)·mag, 0 pad
    obs: torch.Tensor | None     # (B·F, W): interleaved fmask·S_in
    a: torch.Tensor              # (B·F, W): synthesis operand, in place
    prev: torch.Tensor           # (B·F, W): previous rebuild, zero
    frames: torch.Tensor         # (B·F, W) scratch
    wav: torch.Tensor            # (B, hop·(F−1) + W) scratch
    out: torch.Tensor            # (B, hop·(F−1))
    cfg: STFTConfig


def prepare_buffers(mag, cfg: STFTConfig, observed=None,
                    phase_init: str = "zero", init=None) -> GLBuffers:
    """The observed pre-fold and the phase init (plain torch, as the
    JAX package prepares them outside its Pallas kernel), the first
    synthesis operand A = mag'·(re0, im0) + obs, and the scratch."""
    B, F, _ = mag.shape
    w = padded_width(cfg.n_fft)
    hop = cfg.hop_length
    magp, obs, re0, im0 = prepare_gl(mag, observed, phase_init, init)
    obs2 = None if obs is None else interleave(obs[0], obs[1], w)
    a = interleave(magp * re0, magp * im0, w)
    if obs2 is not None:
        a += obs2
    new = functools.partial(torch.empty, dtype=torch.float32,
                            device=mag.device)
    return GLBuffers(
        mag=TF.pad(magp.reshape(B * F, -1), (0, w // 2 - cfg.n_bins)),
        obs=obs2, a=a,
        prev=torch.zeros_like(a), frames=torch.empty_like(a),
        wav=new((B, hop * (F - 1) + w)), out=new((B, hop * (F - 1))),
        cfg=cfg)


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def launch(buf: GLBuffers, n_iter: int, momentum: float = 0.99
           ) -> torch.Tensor:
    """Run the kernel on `buf` (A and prev are updated in place) on the
    current stream, with the block tile `pick_tile` chooses; returns
    buf.out. Counts one launch."""
    cfg = buf.cfg
    B, (M, W) = buf.wav.shape[0], buf.a.shape
    c = _constants(cfg, M // B, buf.a.device)
    sms = torch.cuda.get_device_properties(buf.a.device).multi_processor_count
    stream = torch.cuda.current_stream(buf.a.device).cuda_stream
    with torch.cuda.device(buf.a.device):
        rc = _lib().viai_griffin_lim(
            _ptr(buf.mag), _ptr(buf.obs), _ptr(buf.a), _ptr(buf.prev),
            _ptr(buf.frames), _ptr(buf.wav), _ptr(c.syn_hi), _ptr(c.syn_lo),
            _ptr(c.ana_hi), _ptr(c.ana_lo), _ptr(c.inv_env), _ptr(buf.out),
            B, M // B, cfg.n_bins, cfg.n_fft, W, cfg.hop_length,
            n_iter, momentum / (1.0 + momentum), pick_tile(M, W, sms),
            stream)
    if rc != 0:
        raise RuntimeError(f"griffin_lim kernel launch failed: CUDA error {rc}")
    griffin_lim_cuda.launches += 1
    return buf.out


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
    cfg.center, a hop that is a multiple of 4 (16-byte rows) and
    length == hop·(F−1), the exact inverse length of fixed-size clips
    (the serving path), and runs the whole loop in the Hopper kernel;
    the observed pre-fold and the phase init run in plain torch before
    it, as the JAX package computes them outside its Pallas kernel.
    """
    if mag.device.type == "cpu":
        return griffin_lim(mag, cfg, n_iter=n_iter, length=length,
                           momentum=momentum, observed=observed,
                           phase_init=phase_init, init=init)
    if mag.device.type != "cuda":
        raise ValueError(f"griffin_lim_cuda: unsupported device {mag.device}")
    if not cfg.center:
        raise ValueError("griffin_lim_cuda implements the center=True layout")
    if cfg.hop_length % 4:
        raise ValueError(f"griffin_lim_cuda needs a hop that is a multiple "
                         f"of 4, got {cfg.hop_length}")
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
    buf = prepare_buffers(mag, cfg, observed, phase_init, init)
    return launch(buf, n_iter, momentum)


griffin_lim_cuda.launches = 0
