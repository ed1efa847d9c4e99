"""The diffusion refiner of the port against viai_tpu's.

Tiny shapes of tests/test_refiner.py (R ngf 8 on 64×64 images, n_fft
126, hop 64, clips of 0.252 s). The JAX nets are moved off their init
(every parameter by 0.02·N(0, 1), so the FiLM projections and the head,
zero at init, are not) and cross through the `.pth` schema. jax.random's
bits cannot be drawn in torch, so the port's samplers get JAX's own
draws (`noise=`): ε₀ = normal(key, shape), the re-noise of step i,
round j = normal(fold_in(fold_in(key, i), j + 1), shape), transposed
NHWC → NCHW, with the K keys of `avg_keys` for a posterior mean.

The JAX samplers and the complex chain run eagerly (`jax.disable_jit`).
Called outside jit, a JAX sampler compiles its `lax.scan` body alone,
and one DDIM step at t = 1 then differs from the eager run by 1e-3 of
the output's peak, while the whole sampler under `jax.jit` agrees with
the eager run to 6e-7; the port agrees with the eager run to 3e-7 (and
with its own float64 run to 2e-7). The magnitude chain, compiled whole,
holds its bound compiled.

Bounds: R's forward within 1e-4 of the output's peak in float32 and
2e-2 in bf16 (two bf16 roundings of one function); the schedule 1e-6;
the samplers 1e-5 of the output's peak (R's float32 summation order
through a few steps); the chains atol = rtol = 1e-3 at GL×1, as
tests/test_torch_chain_options.py (G's head bias lowered to -2 there
for the reason that file gives).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from viai_tpu.io import load_networks as j_load_networks
from viai_tpu.io import save_networks as j_save_networks
from viai_tpu.nn import define_R as j_define_R
from viai_tpu.testing import TINY_CFG, tone_batch
from viai_tpu.train import diffusion as jd
from viai_tpu.train import make_infer_fn as j_make_infer_fn
from viai_tpu.train.step import preprocess_with_mask as j_preprocess
from viai_tpu_torch import InpaintService
from viai_tpu_torch.io import load_networks, save_networks, state_from_flat
from viai_tpu_torch.nn import define_R, timestep_embedding
from viai_tpu_torch.train import diffusion as pd
from viai_tpu_torch.train import make_infer_fn, preprocess_with_mask

from _torch_train_util import make_G, nchw, nhwc, perturb, port_cfg

CLIP = 4032
CFG = port_cfg()
PEAK_TOL = 1e-4
SAMPLER_TOL = 1e-5
CHAIN_TOL = dict(atol=1e-3, rtol=1e-3)


def _R(in_ch=4, out_ch=1, seed=3, dtype="float32"):
    """A JAX R, perturbed, and the port's with its weights."""
    JR = j_define_R(in_ch, ngf=8, seed=seed, out_channels=out_ch,
                    dtype=jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    PR = define_R(in_ch, 8, dtype=dtype, out_channels=out_ch, device="cpu")
    PR.load_state_dict(state_from_flat(perturb(JR, 200 + seed), PR))
    return JR, PR


def _clips(batch, seed=0):
    noise = np.random.default_rng(seed + 100).standard_normal((batch, CLIP))
    return (tone_batch(batch, CLIP, seed=seed) + 0.01 * noise).astype(
        np.float32)


def _tmask(batch, hole=(20, 36)):
    m = np.ones((batch, CFG.image_frames), np.float32)
    m[:, hole[0]:hole[1]] = 0.0
    return m


def _batches(batch=2, seed=4):
    wav, m = _clips(batch, seed), _tmask(batch)
    return (wav, m, j_preprocess(wav, m, TINY_CFG),
            preprocess_with_mask(torch.from_numpy(wav), torch.from_numpy(m),
                                 CFG))


def _g_img(batch=2, seed=5):
    return np.random.default_rng(seed).uniform(
        -1, 0.5, (batch, 64, 64, 1)).astype(np.float32)


def _jax_noise(key, shape, steps, resample) -> pd.RefineNoise:
    """The draws ddim_refine(key) makes, NCHW."""
    eps0 = nchw(jax.random.normal(key, shape))
    ren = None
    if resample:
        ren = torch.stack([torch.stack([nchw(jax.random.normal(
            jax.random.fold_in(jax.random.fold_in(key, i), j + 1), shape))
            for j in range(resample)]) for i in range(steps)])
    return pd.RefineNoise(eps0, ren)


def _assert_peak(out: np.ndarray, ref: np.ndarray, tol: float = PEAK_TOL):
    assert out.shape == ref.shape
    err = np.abs(out - ref).max()
    assert err <= tol * np.abs(ref).max(), (err, np.abs(ref).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chans", [(4, 1), (5, 1), (7, 2)],
                         ids=["mag", "mag_selfcond", "complex"])
def test_refiner_forward_matches_jax(chans, dtype):
    JR, PR = _R(*chans, dtype=dtype)
    x = np.random.default_rng(0).standard_normal(
        (2, 64, 64, chans[0])).astype(np.float32)
    t = np.array([0.3, 0.9], np.float32)
    ref = np.asarray(JR(jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        out = nhwc(PR(nchw(x), torch.from_numpy(t)))
    assert out.dtype == np.float32
    _assert_peak(out, ref, PEAK_TOL if dtype == "float32" else 2e-2)


def test_fresh_refiner_predicts_zero():
    R = define_R(4, 8, device="cpu")
    with torch.no_grad():
        out = R(torch.randn(2, 4, 64, 64), torch.tensor([0.1, 0.9]))
    assert out.shape == (2, 1, 64, 64) and not out.any()
    assert not any(m.proj.weight.any() for m in R.modules()
                   if isinstance(m, type(R.downs[0].film)))


def test_refiner_checkpoints_both_ways(tmp_path):
    JR, _ = _R(seed=6)
    j_save_networks({"R": nnx.split(JR)[1]}, "latest", str(tmp_path),
                    also_latest=False)
    PR = define_R(4, 8, seed=9, device="cpu")
    load_networks({"R": PR}, "latest", str(tmp_path))
    x = np.random.default_rng(1).standard_normal((2, 64, 64, 4)).astype(
        np.float32)
    t = np.array([0.2, 0.7], np.float32)
    ref = np.asarray(JR(jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        _assert_peak(nhwc(PR(nchw(x), torch.from_numpy(t))), ref)
    # Port → JAX: a fresh JAX R loads the port's file.
    save_networks({"Rraw": PR}, 3, str(tmp_path))
    JR2 = j_define_R(4, ngf=8, seed=11)
    loaded = j_load_networks({"Rraw": nnx.split(JR2)[1]}, 3, str(tmp_path))
    nnx.update(JR2, loaded["Rraw"])
    _assert_peak(np.asarray(JR2(jnp.asarray(x), jnp.asarray(t))), ref)


def test_schedule_algebra_matches_jax():
    rng = np.random.default_rng(2)
    t = np.concatenate([[0.0, 1.0], rng.uniform(0, 1, 30)]).astype(np.float32)
    for jf, pf in ((jd.alpha_bar, pd.alpha_bar), (jd.ab_coeffs, pd.ab_coeffs)):
        a = jf(jnp.asarray(t))
        b = pf(torch.from_numpy(t))
        for x, y in zip(np.atleast_2d(a), np.atleast_2d(np.asarray(b))):
            np.testing.assert_allclose(y, np.asarray(x), atol=1e-6)
    x0, eps = rng.standard_normal((2, 4, 8, 8, 1)).astype(np.float32)
    tb = t[:4]
    for jf, pf, args in ((jd.q_sample, pd.q_sample, (x0, tb, eps)),
                         (jd.x0_eps_from_v, pd.x0_eps_from_v, (x0, eps, tb))):
        ja = jf(*(jnp.asarray(a) for a in args))
        pa = pf(*(torch.from_numpy(a) for a in args))
        for x, y in zip(ja, pa):
            np.testing.assert_allclose(y.numpy(), np.asarray(x), atol=1e-6)
    from viai_tpu.nn.refiner import timestep_embedding as j_temb

    for dim in (16, 17):
        np.testing.assert_allclose(
            timestep_embedding(torch.from_numpy(t), dim).numpy(),
            np.asarray(j_temb(jnp.asarray(t), dim)), atol=1e-5)


DDIM_CASES = {
    "x0": {},
    "q": dict(clamp_mode="q"),
    "x0_resample1": dict(resample=1),
    "q_resample1": dict(clamp_mode="q", resample=1),
    "guidance1.5": dict(guidance=1.5),
    "self_cond": dict(self_cond=True),
    "noise_scale0": dict(noise_scale=0.0, resample=1),
}


@pytest.mark.parametrize("name", list(DDIM_CASES))
def test_ddim_refine_matches_jax(name):
    kw = dict(steps=3, t_start=0.5, **DDIM_CASES[name])
    JR, PR = _R(5 if kw.get("self_cond") else 4)
    _, _, jb, pb = _batches()
    g = _g_img()
    key = jax.random.key(7)
    r_def, r_state = nnx.split(JR)
    with jax.disable_jit():
        ref = np.asarray(jd.ddim_refine(r_def, r_state, jnp.asarray(g), jb,
                                        key, **kw))
    noise = _jax_noise(key, g.shape, kw["steps"], kw.get("resample", 0))
    out = pd.ddim_refine(PR, nchw(g), pb, noise, **kw)
    _assert_peak(nhwc(out), ref, SAMPLER_TOL)
    m = pb["mask_img"].permute(0, 3, 1, 2)
    obs = pb["masked_img"].permute(0, 3, 1, 2)
    assert torch.equal(out * m, obs * m)


@pytest.mark.parametrize("kw", [
    {}, dict(guidance=1.5, clamp_mode="q", resample=1), dict(self_cond=True)],
    ids=["default", "guidance_q_resample", "self_cond"])
def test_ddim_refine_complex_matches_jax(kw):
    kw = dict(steps=3, **kw)
    r_in, r_out = pd.complex_refiner_channels(2, kw.get("self_cond", False))
    assert (r_in, r_out) == jd.complex_refiner_channels(
        2, kw.get("self_cond", False))
    JR, PR = _R(r_in, r_out)
    wav, _, jb, pb = _batches()
    jc = jd.complex_image(jnp.asarray(wav), TINY_CFG)
    pc = pd.complex_image(torch.from_numpy(wav), CFG)
    np.testing.assert_allclose(nhwc(pc), np.asarray(jc), atol=1e-5)
    g = _g_img()
    key = jax.random.key(8)
    r_def, r_state = nnx.split(JR)
    with jax.disable_jit():
        ref = np.asarray(jd.ddim_refine_complex(r_def, r_state,
                                                jnp.asarray(g), jb, jc, key,
                                                **kw))
    noise = _jax_noise(key, jc.shape, kw["steps"], kw.get("resample", 0))
    _assert_peak(nhwc(pd.ddim_refine_complex(PR, nchw(g), pb, pc, noise,
                                             **kw)), ref, SAMPLER_TOL)


def test_chunked_mean_matches_jax_and_is_chunk_invariant():
    # JAX's chunked_mean (full chunks, then the remainder, over /k) on
    # stats of its keys, against the port's on the same draws.
    k = 5
    keys = jd.avg_keys(jax.random.key(3), k)

    def key_stats(ks):          # a cheap sample that depends on the key
        d = jax.random.key_data(ks).astype(jnp.float32) / 4294967296.0 - 0.5
        return {"x": d, "y": jnp.abs(d)}

    ref = jd.chunked_mean(key_stats, keys, 2)
    draws = [torch.from_numpy(np.asarray(key_stats(ks)["x"]))[None]
             for ks in keys]
    out = pd.chunked_mean(lambda nz, c: {"x": nz.eps0, "y": nz.eps0.abs()},
                          lambda s: pd.RefineNoise(draws[s]), k, 2)
    for n in ("x", "y"):
        np.testing.assert_allclose(out[n][0].numpy(), np.asarray(ref[n]),
                                   atol=1e-6)
    # The posterior mean of the sampler over JAX's K keys, chunked in
    # every way, against the mean of JAX's K single runs (the DDIM
    # config of DDIM_CASES["x0_resample1"]).
    JR, PR = _R()
    _, _, jb, pb = _batches()
    g = _g_img()
    kw = dict(steps=3, t_start=0.5, resample=1)
    r_def, r_state = nnx.split(JR)
    with jax.disable_jit():
        ref = np.mean([np.asarray(jd.ddim_refine(
            r_def, r_state, jnp.asarray(g), jb, keys[s], **kw))
            for s in range(3)], axis=0)
    noises = [_jax_noise(keys[s], g.shape, 3, 1) for s in range(3)]

    def stats(nz, c):
        return {"x": pd.ddim_refine(PR, pd.tile(nchw(g), c),
                                    pd.tile_batch(pb, c), nz, **kw)}

    means = [pd.chunked_mean(stats, noises.__getitem__, 3, chunk)["x"]
             for chunk in (2, 1, 3)]
    _assert_peak(nhwc(means[0]), ref, SAMPLER_TOL)
    for m in means[1:]:
        torch.testing.assert_close(m, means[0], atol=1e-6, rtol=1e-6)
    one = pd.chunked_mean(stats, noises.__getitem__, 1, 8)["x"]
    assert torch.equal(one, pd.ddim_refine(PR, nchw(g), pb, noises[0], **kw))


def _G(seed):
    JG, PG = make_G(seed=seed)
    JG.head.bias[...] = jnp.full_like(JG.head.bias[...], -2.0)
    with torch.no_grad():
        PG.head.bias.fill_(-2.0)
    return nnx.split(JG), PG.eval()


REFINE_KW = dict(refine_steps=2, refine_t=0.35, refine_avg=2, refine_chunk=1)


@pytest.mark.parametrize("mix,n_g", [(0.0, 1), (0.7, 1), (0.0, 2)],
                         ids=["mix0", "mix0.7", "ensemble2"])
def test_infer_fn_refiner_matches_jax(mix, n_g):
    gs = [_G(s) for s in range(n_g)]
    g_def = gs[0][0][0]
    states = [g[0][1] for g in gs]
    g_state = states[0] if n_g == 1 else jax.tree.map(
        lambda *xs: jnp.stack(xs), *states)
    JR, PR = _R()
    wav, m = _clips(2, seed=9), _tmask(2)
    kw = dict(REFINE_KW, refine_mix=mix, n_gl_iter=1)
    ref = j_make_infer_fn(g_def, None, TINY_CFG, external_mask=True,
                          refiner=nnx.split(JR), n_ensemble=n_g, **kw)(
        g_state, nnx.State({}), wav, m, None)
    keys = jd.avg_keys(jax.random.key(0), kw["refine_avg"])
    shape = (2, 64, 64, 1)
    noise = [_jax_noise(keys[s], shape, 2, 0) for s in range(len(keys))]
    out = make_infer_fn([g[1] for g in gs], CFG, refiner=PR, **kw)(
        torch.from_numpy(wav), torch.from_numpy(m), noise=noise)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **CHAIN_TOL)


@pytest.mark.parametrize("complex_mag", ["sample", "keep", "mean"])
def test_complex_infer_fn_matches_jax(complex_mag):
    (g_def, g_state), PG = _G(0)
    JR, PR = _R(7, 2)
    wav, m = _clips(2, seed=12), _tmask(2)
    kw = dict(steps=2, t_start=1.0, refine_avg=2, refine_chunk=1,
              complex_mag=complex_mag)
    with jax.disable_jit():
        ref = jd.make_complex_refiner_infer_fn(
            g_def, None, *nnx.split(JR), TINY_CFG, external_mask=True, **kw)(
            g_state, nnx.State({}), wav, m, None)
    keys = jd.avg_keys(jax.random.key(0), 2)
    noise = [_jax_noise(k, (2, 64, 64, 2), 2, 0) for k in keys]
    out = pd.make_complex_refiner_infer_fn(PG, PR, CFG, **kw)(
        torch.from_numpy(wav), torch.from_numpy(m), noise=noise)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **CHAIN_TOL)


def test_refiner_errors_match_jax():
    _, PR = _R()
    _, _, _, pb = _batches()
    g = nchw(_g_img())
    with pytest.raises(ValueError, match="clamp_mode"):
        pd.ddim_refine(PR, g, pb, generator=torch.Generator(),
                       clamp_mode="bad")
    with pytest.raises(ValueError, match="complex_mag"):
        pd.make_complex_refiner_infer_fn(None, PR, CFG, complex_mag="bad")
    (_, _), PG = _G(0)
    with pytest.raises(ValueError, match="complex"):
        InpaintService(PG, CFG, refiner=PR, refiner_domain="complex",
                       ensemble_states=[PG], device="cpu")


@pytest.mark.parametrize("domain", ["mag", "complex"])
def test_service_refiner_is_deterministic_per_request(domain):
    """The service's fixed noise stream: one request gives one answer,
    and the observed region stays the input's."""
    (_, _), PG = _G(0)
    _, PR = _R(7, 2) if domain == "complex" else _R()
    svc = InpaintService(PG, CFG, refiner=PR, refiner_domain=domain,
                         buckets=(2, 4), gl_iters=1, clip_samples=CLIP,
                         refine_steps=2, refine_avg=2, device="cpu",
                         refine_t=1.0 if domain == "complex" else 0.35)
    wavs = _clips(3, seed=13)
    a = svc.inpaint(wavs, gap_start_s=0.08, gap_end_s=0.12)
    b = svc.inpaint(wavs, gap_start_s=0.08, gap_end_s=0.12)
    assert a.shape == wavs.shape and np.isfinite(a).all()
    np.testing.assert_array_equal(a, b)
