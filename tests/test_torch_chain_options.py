"""The chain's options in the port against viai_tpu's.

`make_infer_fn(external_mask=True)` and `InpaintService` of the JAX
package, with the jnp Griffin-Lim, against the port's on the CPU (where
the GL wrapper runs its plain version), for the options of this slice:
cfg.use_video (a video net V whose features enter G's fusion conv),
cfg.multi_res (a third G input channel from a 2×-hop STFT),
cfg.phase_head with phase_init="model" (G's cos/sin channels seed GL),
and a deep ensemble of two Gs. The same tiny networks (ngf 8,
viai_tpu.testing's V, n_fft 126) cross through the weight bridge.

GL is chaotic, so n_gl_iter ≤ 4; bound atol = rtol = 1e-3, as
tests/test_torch_serving.py, for float32 summation order through V, G,
the exponential decompress and GL. The clips carry a little noise and
G's head bias is lowered to -2, for the reasons that file gives.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from viai_tpu.io import flatten_state
from viai_tpu.nn import GeneratorConfig as JConfig
from viai_tpu.nn import UNetGenerator as JUNet
from viai_tpu.nn import VideoFeatureNet as JVideo
from viai_tpu.nn import VideoNetConfig as JVideoConfig
from viai_tpu.serving import InpaintService as JService
from viai_tpu.testing import TINY_CFG, tone_batch
from viai_tpu.train import make_infer_fn as j_make_infer_fn
from viai_tpu.train.step import preprocess_with_mask as j_preprocess
from viai_tpu_torch import InpaintService, TrainConfig
from viai_tpu_torch.io import generator_state_from_flat, video_state_from_flat
from viai_tpu_torch.nn import (GeneratorConfig, UNetGenerator,
                               VideoFeatureNet, VideoNetConfig)
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
G_SHAPE = dict(ngf=8, strides=((2, 2), (2, 2), (2, 1)), mults=(1, 2, 4))
V_SHAPE = dict(base=4, mults=(1, 2), strides=((1, 2, 2), (2, 2, 2)),
               out_features=16, out_time=16)
FRAMES = (8, 16, 16, 3)


def _configs(flags):
    return (dataclasses.replace(TINY_CFG, **flags),
            dataclasses.replace(CFG, **flags))


def _G(flags, seed):
    """A JAX G for the flags (3 inputs under multi_res, 3 outputs under
    phase_head, fusion 16 under use_video), head bias -2, and its port."""
    kw = dict(G_SHAPE, in_channels=3 if flags.get("multi_res") else 2,
              out_channels=3 if flags.get("phase_head") else 1)
    fusion = 16 if flags.get("use_video") else 0
    JG = JUNet(JConfig(**kw), nnx.Rngs(seed), fusion_channels=fusion)
    JG.head.bias[...] = jnp.full_like(JG.head.bias[...], -2.0)
    g_def, g_state = nnx.split(JG)
    pcfg = GeneratorConfig(**kw)
    PG = UNetGenerator(pcfg, fusion_channels=fusion).eval()
    PG.load_state_dict(generator_state_from_flat(flatten_state(g_state), pcfg,
                                                 fusion))
    return g_def, g_state, PG


def _V(seed):
    JV = JVideo(JVideoConfig(**V_SHAPE), nnx.Rngs(seed))
    v_def, v_state = nnx.split(JV)
    pcfg = VideoNetConfig(**V_SHAPE)
    PV = VideoFeatureNet(pcfg).eval()
    PV.load_state_dict(video_state_from_flat(flatten_state(v_state), pcfg))
    return v_def, v_state, PV


def _models(flags, n_ensemble=1):
    """JAX (g_def, g_state stacked when n_ensemble > 1, v_def, v_state)
    and the port's ([G, ...], V)."""
    gs = [_G(flags, seed) for seed in range(n_ensemble)]
    g_def = gs[0][0]
    states = [g[1] for g in gs]
    g_state = states[0] if n_ensemble == 1 else jax.tree.map(
        lambda *xs: jnp.stack(xs), *states)
    v_def, v_state, PV = (None, nnx.State({}), None)
    if flags.get("use_video"):
        v_def, v_state, PV = _V(10)
    return (g_def, g_state, v_def, v_state, states), ([g[2] for g in gs], PV)


def _clips(batch, seed=0):
    noise = np.random.default_rng(seed + 100).standard_normal((batch, CLIP))
    return (tone_batch(batch, CLIP, seed=seed) + 0.01 * noise).astype(
        np.float32)


def _frames(batch, seed=0):
    return np.random.default_rng(seed + 200).uniform(
        0, 1, (batch, *FRAMES)).astype(np.float32)


def _tmask(batch, hole=(20, 36)):
    m = np.ones((batch, CFG.image_frames), np.float32)
    m[:, hole[0]:hole[1]] = 0.0
    return m


@pytest.mark.parametrize("flags", [dict(multi_res=True),
                                   dict(phase_head=True),
                                   dict(multi_res=True, phase_head=True)],
                         ids=["multi_res", "phase_head", "both"])
def test_preprocess_option_keys_match_jax(flags):
    jcfg, pcfg = _configs(flags)
    wav, m = _clips(2, seed=2), _tmask(2)
    a = j_preprocess(wav, m, jcfg)
    b = preprocess_with_mask(torch.from_numpy(wav), torch.from_numpy(m), pcfg)
    assert set(a) == set(b)
    for k in a:
        assert b[k].shape == a[k].shape, k
        np.testing.assert_allclose(b[k].numpy(), np.asarray(a[k]), atol=1e-5,
                                   err_msg=k)


CASES = {
    "video": (dict(use_video=True), 1, dict(n_gl_iter=4)),
    "multi_res": (dict(multi_res=True), 1, dict(n_gl_iter=4)),
    "phase_head_model": (dict(phase_head=True), 1, dict(n_gl_iter=4)),
    "phase_head_model_gl0": (dict(phase_head=True), 1,
                             dict(n_gl_iter=0, phase_init="model")),
    "ensemble_2": ({}, 2, dict(n_gl_iter=4)),
    "video_ensemble_phase_multi_res": (
        dict(use_video=True, phase_head=True, multi_res=True), 2,
        dict(n_gl_iter=2)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_infer_option_matches_jax(name):
    flags, k, kw = CASES[name]
    jcfg, pcfg = _configs(flags)
    (g_def, g_state, v_def, v_state, _), (gens, PV) = _models(flags, k)
    wav, m = _clips(3, seed=11), _tmask(3)
    frames = _frames(3) if flags.get("use_video") else None
    ref = j_make_infer_fn(g_def, v_def, jcfg, external_mask=True,
                          n_ensemble=k, **kw)(g_state, v_state, wav, m, frames)
    out = make_infer_fn(gens if k > 1 else gens[0], pcfg, V=PV, **kw)(
        torch.from_numpy(wav), torch.from_numpy(m),
        None if frames is None else torch.from_numpy(frames))
    assert out.shape == ref.shape == wav.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_infer_video_needs_frames():
    flags = dict(use_video=True)
    _, (gens, PV) = _models(flags)
    infer = make_infer_fn(gens[0], _configs(flags)[1], V=PV, n_gl_iter=1)
    with pytest.raises(ValueError, match="frames"):
        infer(torch.from_numpy(_clips(1)), torch.from_numpy(_tmask(1)))


def _services(flags, n_ensemble, buckets=(2, 4)):
    jcfg, pcfg = _configs(flags)
    (g_def, _, v_def, v_state, states), (gens, PV) = _models(flags, n_ensemble)
    kw = dict(buckets=buckets, gl_iters=2, clip_samples=CLIP)
    js = JService(g_def, states[0], jcfg, v_def=v_def, v_state=v_state,
                  ensemble_states=states[1:], **kw)
    ps = InpaintService(gens[0], pcfg, V=PV, ensemble_states=gens[1:],
                        device="cpu", **kw)
    return js, ps


def test_service_video_frames_through_buckets():
    """5 clips with frames → buckets 4 + 2, the padding clip with zero
    frames, as the JAX service pads."""
    js, ps = _services(dict(use_video=True), 1)
    wavs, frames = _clips(5), _frames(5, seed=3)
    gap = dict(gap_start_s=0.08, gap_end_s=0.12)
    a = js.inpaint(wavs, frames=frames, **gap)
    b = ps.inpaint(wavs, frames=frames, **gap)
    np.testing.assert_allclose(b, a, **TOL)
    assert (ps.stats.clips, ps.stats.batches, ps.stats.padded_clips) == (5, 2, 1)
    with pytest.raises(ValueError, match="frame"):
        ps.inpaint(wavs, frames=frames[:4], **gap)


def test_service_ensemble_states():
    js, ps = _services({}, 2)
    wavs = _clips(3, seed=6)
    m = ps.time_mask_from_seconds(3, 0.08, 0.12)
    np.testing.assert_allclose(ps.inpaint(wavs, masks=m),
                               js.inpaint(wavs, masks=m), **TOL)
    assert len(ps.ensemble) == 1
