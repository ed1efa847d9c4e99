"""The port's signal core (viai_tpu_torch.signal) against viai_tpu.

The same numpy inputs, made from a seed, go through the JAX function
and its PyTorch counterpart on the CPU. Both sides use the same float32
DFT bases (built in float64 numpy) and compute in float32; the
tolerance 1e-4 covers the two frameworks' summation orders.
"""

import numpy as np
import pytest
import torch

import viai_tpu.signal as J
from viai_tpu.signal.griffin_lim import extrapolate_hole_phase as j_extrap
import viai_tpu_torch.signal as P
from viai_tpu_torch.signal.griffin_lim import extrapolate_hole_phase

CONFIGS = [(126, 32), (510, 128)]


def _wav(batch=2, n=2048, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    f = rng.uniform(200, 2000, (batch, 3))
    x = (0.3 * np.sin(2 * np.pi * f[:, :, None] * t).sum(1)
         + 0.05 * rng.standard_normal((batch, n)))
    return x.astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


@pytest.mark.parametrize("n_fft,hop", CONFIGS)
def test_stft_istft_magnitude_match_jax(n_fft, hop):
    jc, pc = J.STFTConfig(n_fft, hop), P.STFTConfig(n_fft, hop)
    x = _wav(n=hop * 16)
    jre, jim = J.stft(x, jc)
    pre, pim = P.stft(_t(x), pc)
    np.testing.assert_allclose(pre.numpy(), np.asarray(jre), atol=1e-4)
    np.testing.assert_allclose(pim.numpy(), np.asarray(jim), atol=1e-4)
    np.testing.assert_allclose(P.stft_magnitude(_t(x), pc).numpy(),
                               np.asarray(J.stft_magnitude(x, jc)), atol=1e-4)
    # iSTFT of the same complex input, default and explicit length.
    re, im = np.asarray(jre), np.asarray(jim)
    for length in (None, x.shape[-1] - 7):
        a = J.istft(re, im, jc, length=length)
        b = P.istft(_t(re), _t(im), pc, length=length)
        assert b.shape == a.shape
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-4)


def test_frame_signal_and_overlap_add_match_jax():
    from viai_tpu.signal.stft import frame_signal as jf, overlap_add as jo
    from viai_tpu_torch.signal.stft import frame_signal as pf, overlap_add as po

    jc, pc = J.STFTConfig(126, 32), P.STFTConfig(126, 32)
    x = _wav(n=1024, seed=3)
    np.testing.assert_array_equal(pf(_t(x), pc).numpy(),
                                  np.asarray(jf(x, jc)))
    fr = np.random.default_rng(4).standard_normal((2, 9, 126)).astype(
        np.float32)
    np.testing.assert_allclose(po(_t(fr), 32).numpy(),
                               np.asarray(jo(fr, 32)), atol=1e-5)


def test_compressions_match_jax():
    rng = np.random.default_rng(5)
    mag = np.abs(rng.standard_normal((2, 40, 64)) * 30).astype(np.float32)
    img = rng.uniform(-1.2, 1.2, (2, 64, 40)).astype(np.float32)
    np.testing.assert_allclose(P.compress(_t(mag)).numpy(),
                               np.asarray(J.compress(mag)), atol=1e-6)
    np.testing.assert_allclose(P.decompress(_t(img)).numpy(),
                               np.asarray(J.decompress(img)), rtol=1e-5,
                               atol=1e-4)
    from viai_tpu.signal.mel import sharpen_mag as js

    for gamma in (1.0, 1.5):
        np.testing.assert_allclose(
            P.sharpen_mag(_t(mag), gamma, axis=-1).numpy(),
            np.asarray(js(mag, gamma, axis=-1)), rtol=1e-5, atol=1e-4)


def test_mask_algebra_matches_jax():
    from viai_tpu.signal.mask import apply_mask as ja, expand_to_image as je
    from viai_tpu_torch.signal.mask import apply_mask as pa, expand_to_image as pe

    rng = np.random.default_rng(6)
    spec = rng.standard_normal((2, 8, 12)).astype(np.float32)
    tm = (rng.uniform(size=(2, 12)) > 0.3).astype(np.float32)
    np.testing.assert_array_equal(pa(_t(spec), _t(tm)).numpy(),
                                  np.asarray(ja(spec, tm)))
    np.testing.assert_array_equal(pe(_t(tm), 8).numpy(), np.asarray(je(tm, 8)))


def _observed(seed, hole, n=2048, cfg=(126, 32)):
    jc = J.STFTConfig(*cfg)
    x = _wav(n=n, seed=seed)
    re, im = (np.asarray(a) for a in J.stft(x, jc))
    fmask = np.ones((x.shape[0], re.shape[1], 1), np.float32)
    fmask[:, hole[0]:hole[1]] = 0.0
    return fmask, re, im


@pytest.mark.parametrize("hole", [(30, 40), (0, 10)],
                         ids=["mid_clip", "clip_start"])
@pytest.mark.parametrize("bidirectional", [False, True])
def test_extrapolate_hole_phase_matches_jax(hole, bidirectional):
    """The cummax take-last-valid against lax.associative_scan; atol
    1e-5 covers atan2/cos/sin rounding in float32."""
    fmask, re, im = _observed(7, hole)
    a = j_extrap(fmask, re, im, re.shape, bidirectional=bidirectional)
    b = extrapolate_hole_phase(_t(fmask), _t(re), _t(im), re.shape,
                               bidirectional=bidirectional)
    for x, y in zip(a, b):
        np.testing.assert_allclose(y.numpy(), np.asarray(x), atol=1e-5)
        assert np.isfinite(y.numpy()).all()
