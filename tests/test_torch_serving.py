"""The port's inference chain and InpaintService against viai_tpu's.

The JAX side runs `make_infer_fn(external_mask=True)` with the jnp
Griffin-Lim (gl_backend="xla") on TINY_CFG and tiny_models(); the port
runs the same G, its weights carried across by the checkpoint bridge,
on the CPU (where the GL wrapper runs its plain version). GL is
chaotic, so n_gl_iter ≤ 4; bound atol = rtol = 1e-3, the bound of
tests/test_pallas_gl.py, for float32 summation order through G, the
exponential decompress and GL.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from viai_tpu.io import flatten_state
from viai_tpu.serving import InpaintService as JService
from viai_tpu.testing import TINY_CFG, tiny_models, tone_batch
from viai_tpu.train import make_infer_fn as j_make_infer_fn
from viai_tpu.train.step import preprocess_with_mask as j_preprocess
from viai_tpu_torch import InpaintService, TrainConfig
from viai_tpu_torch.io import generator_state_from_flat
from viai_tpu_torch.nn import GeneratorConfig, UNetGenerator
from viai_tpu_torch.signal import MaskConfig, STFTConfig
from viai_tpu_torch.train import make_infer_fn, preprocess_with_mask

CLIP = 4032
CFG = TrainConfig(
    stft=STFTConfig(n_fft=TINY_CFG.stft.n_fft,
                    hop_length=TINY_CFG.stft.hop_length),
    mask=MaskConfig(min_gap_frames=8, max_gap_frames=16),
    image_frames=TINY_CFG.image_frames,
)
TOL = dict(atol=1e-3, rtol=1e-3)


@pytest.fixture(scope="module")
def models():
    """The JAX tiny G and its port, with the same weights.

    The head bias is set to -2 so that the random G predicts hole
    magnitudes of the tones' scale (decompress(tanh(-2)) ≈ 0.1 per bin)
    instead of expm1(3) ≈ 19, which puts the hole waveform at ±35 and
    makes an absolute bound meaningless there.
    """
    G, _, _ = tiny_models()
    G.head.bias[...] = jnp.full_like(G.head.bias[...], -2.0)
    g_def, g_state = nnx.split(G)
    gc = G.cfg
    pcfg = GeneratorConfig(ngf=gc.ngf, strides=gc.strides, mults=gc.mults)
    PG = UNetGenerator(pcfg).eval()
    PG.load_state_dict(generator_state_from_flat(flatten_state(g_state), pcfg))
    return g_def, g_state, PG


def _clips(batch, seed=0):
    """tone_batch plus a little noise. A bare sine that starts at phase
    0 makes the reflect-padded first frame exactly symmetric: its
    analysis is real up to rounding, so the GL phasor of such bins is
    decided by rounding noise and differs between any two float32
    implementations."""
    noise = np.random.default_rng(seed + 100).standard_normal((batch, CLIP))
    return (tone_batch(batch, CLIP, seed=seed) + 0.01 * noise).astype(
        np.float32)


def _tmask(batch, hole=(20, 36)):
    m = np.ones((batch, CFG.image_frames), np.float32)
    m[:, hole[0]:hole[1]] = 0.0
    return m


def test_preprocess_with_mask_matches_jax():
    wav, m = _clips(2, seed=2), _tmask(2)
    a = j_preprocess(wav, m, TINY_CFG)
    b = preprocess_with_mask(torch.from_numpy(wav), torch.from_numpy(m), CFG)
    assert set(a) == set(b)
    for k in a:
        assert b[k].shape == a[k].shape
        np.testing.assert_allclose(b[k].numpy(), np.asarray(a[k]), atol=1e-5)


@pytest.mark.parametrize("kw", [
    dict(n_gl_iter=4),
    dict(n_gl_iter=2, phase_aware=False),
    dict(n_gl_iter=0, mag_sharpen=1.5),
    dict(n_gl_iter=1, oracle_mag=True),
], ids=["extrapolate", "zero_phase", "sharpen", "oracle"])
def test_infer_chain_matches_jax(models, kw):
    g_def, g_state, PG = models
    wav, m = _clips(3, seed=11), _tmask(3)
    ref = j_make_infer_fn(g_def, None, TINY_CFG, external_mask=True, **kw)(
        g_state, nnx.State({}), wav, m)
    out = make_infer_fn(PG, CFG, **kw)(torch.from_numpy(wav),
                                       torch.from_numpy(m))
    assert out.shape == ref.shape == wav.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_infer_rejects_unported_options(models):
    """Every option is ported; the combinations the JAX make_infer_fn
    refuses raise ValueError here too."""
    import dataclasses

    PG = models[2]
    with pytest.raises(ValueError, match="phase_head"):
        make_infer_fn(PG, CFG, phase_init="model")
    with pytest.raises(ValueError, match="phase_aware"):
        make_infer_fn(PG, CFG, phase_aware=False, phase_init="extrapolate")
    with pytest.raises(ValueError, match="V"):
        make_infer_fn(PG, dataclasses.replace(CFG, use_video=True))


def _services(models, buckets=(2, 4)):
    g_def, g_state, PG = models
    kw = dict(buckets=buckets, gl_iters=2, clip_samples=CLIP)
    return (JService(g_def, g_state, TINY_CFG, **kw),
            InpaintService(PG, CFG, device="cpu", **kw))


def test_service_odd_batch_through_buckets(models):
    js, ps = _services(models)
    wavs = _clips(5)            # 5 → buckets 4 + 2 (pad 1)
    a = js.inpaint(wavs, gap_start_s=0.08, gap_end_s=0.12)
    b = ps.inpaint(wavs, gap_start_s=0.08, gap_end_s=0.12)
    np.testing.assert_allclose(b, a, **TOL)
    assert (ps.stats.clips, ps.stats.batches, ps.stats.padded_clips) == (5, 2, 1)
    assert ps.stats.clips_per_sec > 0


def test_service_multi_gap_masks_and_output(models):
    js, ps = _services(models, buckets=(2,))
    for starts, ends in [(0.08, 0.12), ([0.02, 0.15], [0.05, 0.18])]:
        ma = js.time_mask_from_seconds(2, starts, ends)
        mb = ps.time_mask_from_seconds(2, starts, ends)
        np.testing.assert_array_equal(mb, ma)
    wavs = _clips(2, seed=3)
    np.testing.assert_allclose(ps.inpaint(wavs, masks=mb),
                               js.inpaint(wavs, masks=ma), **TOL)
    with pytest.raises(ValueError):
        ps.time_mask_from_seconds(1, [0.1, 0.2], [0.15])


def test_service_inpaint_long(models):
    js, ps = _services(models)
    t = np.arange(12000) / 16000.0
    wav = (0.4 * np.sin(2 * np.pi * 330 * t)).astype(np.float32)
    kw = dict(gap_start_s=0.30, gap_end_s=0.40, overlap_s=0.05)
    a, b = js.inpaint_long(wav, **kw), ps.inpaint_long(wav, **kw)
    np.testing.assert_allclose(b, a, **TOL)
    # Regions far from the gap are untouched.
    np.testing.assert_array_equal(b[:1000], wav[:1000])
    np.testing.assert_array_equal(b[-1000:], wav[-1000:])
    short = ps.inpaint_long(wav[:3000], gap_start_s=0.05, gap_end_s=0.08)
    assert short.shape == (3000,)


def test_service_submit_flush(models):
    js, ps = _services(models)
    mask = ps.time_mask_from_seconds(1, 0.08, 0.12)[0]
    clips = _clips(3, seed=4)
    futs = [ps.submit(c, mask) for c in clips]
    outs = ps.flush()
    assert len(outs) == 3 and all(f.done() for f in futs)
    ref = js.inpaint(clips, masks=np.stack([mask] * 3))
    np.testing.assert_allclose(np.stack(outs), ref, **TOL)
    np.testing.assert_array_equal(futs[1].result(), outs[1])
    assert ps.flush() == []


def test_service_auto_flush(models):
    _, ps = _services(models)
    ps.configure_streaming(max_queue=2)
    mask = ps.time_mask_from_seconds(1, 0.08, 0.12)[0]
    clips = _clips(3, seed=5)
    f0 = ps.submit(clips[0], mask)
    assert not f0.done()
    f1 = ps.submit(clips[1], mask)        # hits max_queue → flush
    assert f0.done() and f1.done()
    ps.configure_streaming(flush_deadline_s=0.2)
    f2 = ps.submit(clips[2], mask)
    assert f2.result(timeout=30).shape == (CLIP,)
