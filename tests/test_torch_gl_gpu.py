"""The Hopper Griffin-Lim kernel against its plain version, on the card.

Marked `gpu`: each test skips without a CUDA card. This file imports
torch, numpy and viai_tpu_torch only, so it runs on a machine without
JAX; there, skip the repository's conftest (which sets JAX up):

    python -m pytest --noconftest -m gpu tests/test_torch_gl_gpu.py

Bound atol = rtol = 1e-3 at n_iter ≤ 4, the bound of
tests/test_pallas_gl.py: float32 summation order (the kernel sums the
K dimension and the overlap-add in another order than cuBLAS and the
plain shifted adds), amplified where the window envelope is small.
"""

import numpy as np
import pytest
import torch

import viai_tpu_torch.signal as P
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


def _case(name, dev, seed=0, batch=3):
    n_fft, hop, n = CONFIGS[name]
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
