"""The Hopper Griffin-Lim kernel against its plain version, on the card.

Marked `gpu`: each test skips without a CUDA card. This file imports
torch, numpy and viai_tpu_torch only, so it runs on a machine without
JAX; there, skip the repository's conftest (which sets JAX up):

    python -m pytest --noconftest -m gpu tests/test_torch_gl_gpu.py

Bound atol = rtol = 1e-3 at n_iter ≤ 4, the bound of
tests/test_pallas_gl.py: float32 summation order (the kernel sums the
K dimension and the overlap-add in another order than cuBLAS and the
plain shifted adds, and its 3xTF32 products are within ~2⁻²¹ of float32
products), amplified where the window envelope is small.
"""

import numpy as np
import pytest
import torch

import viai_tpu_torch.signal as P
from viai_tpu_torch.signal import gl_cuda
from viai_tpu_torch.signal.gl_cuda import griffin_lim_cuda

pytestmark = pytest.mark.gpu

CONFIGS = {"small": (126, 32, 2048), "product": (510, 128, 1280)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _case(name, dev, seed=0, batch=3, n=None):
    n_fft, hop, n_default = CONFIGS[name]
    n = n or n_default
    cfg = P.STFTConfig(n_fft, hop)
    g = torch.Generator().manual_seed(seed)
    t = torch.arange(n) / 16000
    f = 200 + 1300 * torch.rand(batch, 2, 1, generator=g)
    x = (0.4 * torch.sin(2 * np.pi * f * t).sum(1)
         + 0.02 * torch.randn(batch, n, generator=g)).to(dev)
    re, im = P.stft(x, cfg)
    mag = torch.sqrt(re * re + im * im + 1e-12)
    F = re.shape[1]
    fmask = torch.ones(batch, F, 1, device=dev)
    fmask[:, F // 3 : F // 3 + max(F // 5, 2)] = 0.0
    return cfg, n, mag, (fmask, re, im)


@pytest.mark.parametrize("n_iter", [0, 1, 4])
@pytest.mark.parametrize("mode", ["zero", "observed", "observed_extrapolate"])
@pytest.mark.parametrize("cfg_name", sorted(CONFIGS))
def test_kernel_matches_plain(cuda, cfg_name, mode, n_iter):
    cfg, n, mag, obs = _case(cfg_name, cuda, seed=n_iter)
    kw = {}
    if mode != "zero":
        kw["observed"] = obs
    if mode == "observed_extrapolate":
        kw["phase_init"] = "extrapolate"
    launches = griffin_lim_cuda.launches
    out = griffin_lim_cuda(mag, cfg, n_iter=n_iter, length=n, **kw)
    torch.cuda.synchronize()
    assert griffin_lim_cuda.launches == launches + 1
    ref = P.griffin_lim(mag, cfg, n_iter=n_iter, length=n, **kw)
    assert out.shape == ref.shape == (mag.shape[0], n)
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(),
                               atol=1e-3, rtol=1e-3)


def test_kernel_leaves_explicit_init_untouched(cuda):
    cfg, n, mag, obs = _case("product", cuda, seed=4)
    init = (torch.ones_like(mag), torch.zeros_like(mag))
    out = griffin_lim_cuda(mag, cfg, n_iter=2, length=n, init=init)
    ref = P.griffin_lim(mag, cfg, n_iter=2, length=n, init=init)
    torch.cuda.synchronize()
    assert bool((init[0] == 1).all()) and bool((init[1] == 0).all())
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(),
                               atol=1e-3, rtol=1e-3)


def test_kernel_rejects_other_lengths(cuda):
    cfg, n, mag, _ = _case("product", cuda)
    with pytest.raises(ValueError):
        griffin_lim_cuda(mag, cfg, n_iter=1, length=n - 1)


def _check(cfg, n, mag, obs, n_iter):
    out = griffin_lim_cuda(mag, cfg, n_iter=n_iter, length=n, observed=obs,
                           phase_init="extrapolate")
    ref = P.griffin_lim(mag, cfg, n_iter=n_iter, length=n, observed=obs,
                        phase_init="extrapolate")
    torch.cuda.synchronize()
    assert out.shape == ref.shape == (mag.shape[0], n)
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(),
                               atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("batch", [1, 7])
@pytest.mark.parametrize("cfg_name", sorted(CONFIGS))
def test_kernel_ragged_batches(cuda, cfg_name, batch):
    """B = 1, and B·F a multiple of no tile (7·11 rows, 7·65 rows)."""
    cfg, n, mag, obs = _case(cfg_name, cuda, seed=batch, batch=batch)
    assert (mag.shape[0] * mag.shape[1]) % 64 != 0
    _check(cfg, n, mag, obs, 4)


@pytest.mark.parametrize("n_iter", [0, 4])
def test_kernel_serving_batch(cuda, n_iter):
    """B = 32 clips of 2 s at the product config: 8032 rows, ragged."""
    cfg, n, mag, obs = _case("product", cuda, seed=32, batch=32, n=32000)
    assert mag.shape[:2] == (32, 251)
    _check(cfg, n, mag, obs, n_iter)


@pytest.mark.parametrize("tile", gl_cuda.TILES)
@pytest.mark.parametrize("cfg_name", sorted(CONFIGS))
def test_kernel_every_tile(cuda, cfg_name, tile):
    """Each block tile, reached through the batch size: the smallest
    batch for which `pick_tile` chooses it, against the plain version."""
    n_fft, hop, n = CONFIGS[cfg_name]
    rows_per_clip = n // hop + 1
    width = gl_cuda.padded_width(n_fft)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    batch = next(b for b in range(1, 4096)
                 if gl_cuda.pick_tile(b * rows_per_clip, width, sms) == tile)
    cfg, n, mag, obs = _case(cfg_name, cuda, seed=tile, batch=batch)
    assert mag.shape[1] == rows_per_clip
    _check(cfg, n, mag, obs, 4)


def test_kernel_repeats_bit_identically(cuda):
    """No atomics: the same inputs give the same bits, call after call."""
    cfg, n, mag, obs = _case("product", cuda, seed=9, batch=8, n=32000)
    kw = dict(observed=obs, phase_init="extrapolate")
    first = griffin_lim_cuda(mag, cfg, n_iter=32, length=n, **kw)
    for _ in range(2):
        again = griffin_lim_cuda(mag, cfg, n_iter=32, length=n, **kw)
        torch.cuda.synchronize()
        assert torch.equal(first, again)
