"""Stage-2 refiner training of the port against viai_tpu's.

Tiny shapes of tests/test_refiner.py (R ngf 8 on 64×64 images, n_fft
126, hop 64, clips of 0.252 s, batch 2). The JAX nets are moved off
their init (every parameter by 0.02·N(0, 1), so R's FiLM projections
and head, zero at init, are not) and cross through the `.pth` schema
(tests/_torch_train_util.py). One step of each domain runs in both
packages on the same waveforms, the port fed the draws JAX's step makes
from its key: kmask, kt, keps, kdrop = split(key, 4); the gap masks
sample_batch_masks(kmask), t = uniform(kt), ε = normal(keps) (NHWC →
NCHW), keep = uniform(kdrop) ≥ cond_drop, and the self-conditioning
coin bernoulli(fold_in(kdrop, 1)), on whose True side JAX runs R's
extra pass. The keys of the coin cases are picked to give each side, so
one compiled JAX step serves both.

Bounds, as tests/test_torch_train_step.py: the loss rtol 1e-4; every
parameter's update (new − old) within atol 1e-4 × the largest |update|
of the net plus rtol 1e-3 (float32 sums in other orders through
instance norms, FiLM and the backward pass); the EMA within (1 − decay)
of that atol plus rtol 1e-6 of its values (float32 rounding of
decay·e + (1 − decay)·p, ~8 ulp). The JAX
step runs under optax.sgd (Adam's first step, ~g/|g|, amplifies
rounding noise), and one case under the refiner script's Adam (β1 0.9,
β2 0.999) with the cosine decay to 0.1, its update of count 4 of 8 (so
the decay and α set the lr) from zero moments, at eps 0.1 rather than
1e-8: the update ∝ g/(|g| + eps) then stays linear in gradients of
rounding size, which at eps 1e-8 come out ±lr at random (measured, two
steps from count 0: 189 of temb_in's 65536 elements off by up to 0.011
at lr 0.05). One step only: a second one, taken from weights that
already differ by rounding, differs by 2.1e-4 of the largest update
under SGD (measured), twice the bound.

The av case runs at two frame inputs, drawn from their own seed (as
tests/test_torch_train_step.py draws them) and from the waveform
noise's generator after the noise, both at the bound above.
"""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import nnx

from viai_tpu.io import flatten_state
from viai_tpu.io import load_networks as j_load_networks
from viai_tpu.io.checkpoint import _key_str
from viai_tpu.nn import GeneratorConfig as JGConfig
from viai_tpu.nn import UNetGenerator as JUNet
from viai_tpu.nn import VideoFeatureNet as JVideo
from viai_tpu.nn import VideoNetConfig as JVConfig
from viai_tpu.nn import define_R as j_define_R
from viai_tpu.signal.mask import sample_batch_masks as j_sample_masks
from viai_tpu.testing import tone_batch
from viai_tpu.train import diffusion as jd
from viai_tpu_torch.cli.train_refiner import main as refiner_main
from viai_tpu_torch.config import TestOptions
from viai_tpu_torch.io import flat_from_state, load_networks
from viai_tpu_torch.model import VIAIModel
from viai_tpu_torch.nn import (GeneratorConfig, UNetGenerator,
                               VideoFeatureNet, VideoNetConfig, define_R)
from viai_tpu_torch.train import diffusion as pd
from viai_tpu_torch.train.schedules import Adam, cosine

from _torch_train_util import G_TINY, V_TINY, jax_cfg, nchw, port_cfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLIP, B = 4032, 2
LR, ADAM_STEPS, ADAM_COUNT, ADAM_EPS = 0.05, 8, 4, 0.1
LOSS_RTOL = 1e-4
UPD_ATOL, UPD_RTOL = 1e-4, 1e-3
EMA_DECAY, EMA_RTOL = 0.999, 1e-6

# name: (domain, make_*_train_step keywords, the coin's side or None,
# the frames' generator under av (None: no video), Adam)
CASES = {
    "mag_drop_sc_first_pass": ("mag", dict(cond_drop=0.5, self_cond=True),
                               True, None, False),
    "mag_drop_sc_zeros": ("mag", dict(cond_drop=0.5, self_cond=True), False,
                          None, False),
    "mag_av_hole_only": ("mag", dict(observed_weight=0.0), None,
                         "own_seed", False),
    "mag_av_hole_only_noise_generator": ("mag", dict(observed_weight=0.0),
                                         None, "noise_generator", False),
    "complex_drop_sc_first_pass": ("complex",
                                   dict(cond_drop=0.5, self_cond=True),
                                   True, None, False),
    "complex_drop_sc_zeros": ("complex", dict(cond_drop=0.5, self_cond=True),
                              False, None, False),
    "mag_adam_cosine": ("mag", {}, None, None, True),
}


def _twin(port_module, jax_ctor, seed):
    """Move every parameter of `port_module` by 0.02·N(0, 1) from a numpy
    seed (R's zero-init FiLM projections and head too); → the JAX module
    of `jax_ctor` holding the same values (built abstractly, so no JAX
    initializer runs) and the values under their flat keys."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in port_module.parameters():
            p.add_(torch.from_numpy(
                0.02 * rng.standard_normal(p.shape).astype(np.float32)))
    flat = {k: v.numpy() for k, v in flat_from_state(port_module).items()}
    graphdef, state = nnx.split(nnx.eval_shape(jax_ctor))
    state = jax.tree_util.tree_map_with_path(
        lambda path, leaf: jnp.asarray(flat[_key_str(path)], leaf.dtype),
        state)
    return nnx.merge(graphdef, state), flat


def _nets(av, r_in, r_out):
    """(JAX G, port G, JAX V, port V, JAX R, port R, R's flat values)."""
    fusion = 16 if av else 0
    gcfg = dict(in_channels=2, out_channels=1, **G_TINY)
    PG = UNetGenerator(GeneratorConfig(**gcfg), fusion_channels=fusion)
    JG, _ = _twin(PG, lambda: JUNet(JGConfig(**gcfg), nnx.Rngs(0),
                                    fusion_channels=fusion), 100)
    JV = PV = None
    if av:
        PV = VideoFeatureNet(VideoNetConfig(**V_TINY))
        JV, _ = _twin(PV, lambda: JVideo(JVConfig(**V_TINY), nnx.Rngs(0)),
                      102)
    PR = define_R(r_in, 8, out_channels=r_out, device="cpu")
    JR, flat = _twin(PR, lambda: j_define_R(r_in, ngf=8,
                                            out_channels=r_out), 203)
    return JG, PG, JV, PV, JR, PR, flat


def _r_channels(domain, self_cond):
    if domain == "complex":
        return pd.complex_refiner_channels(2, self_cond=self_cond)
    return 4 + self_cond, 1


def _coin(key):
    kdrop = jax.random.split(key, 4)[3]
    return bool(jax.random.bernoulli(jax.random.fold_in(kdrop, 1)))


def _key(coin, cond_drop):
    """The first key whose coin is `coin` (None: any) and whose keep
    draw, under cond_drop, drops one clip of the two and keeps one."""
    for seed in range(100):
        key = jax.random.key(seed)
        kdrop = jax.random.split(key, 4)[3]
        keep = np.asarray(jax.random.uniform(kdrop, (B, 1, 1, 1))) >= \
            cond_drop
        if (coin is None or _coin(key) == coin) and (
                cond_drop == 0.0 or keep.sum() == 1):
            return key
    raise AssertionError("no key found")


_JAX_STEPS = {}


def _jax_step(name, g_def, v_def, r_def, cfg):
    """The compiled JAX step of a case; the coin cases share one."""
    domain, kw, _, frames_from, use_adam = CASES[name]
    av = frames_from is not None
    cache = (domain, tuple(sorted(kw.items())), av, use_adam)
    if cache not in _JAX_STEPS:
        tx = (optax.adam(optax.cosine_decay_schedule(LR, ADAM_STEPS,
                                                     alpha=0.1),
                         b1=0.9, b2=0.999, eps=ADAM_EPS)
              if use_adam else optax.sgd(LR))
        make = (jd.make_complex_refiner_train_step if domain == "complex"
                else jd.make_refiner_train_step)
        _JAX_STEPS[cache] = (tx, make(g_def, v_def, r_def, tx, cfg, **kw))
    return _JAX_STEPS[cache]


def _jax_draws(key, domain, cond_drop, cfg):
    kmask, kt, keps, kdrop = jax.random.split(key, 4)
    n_ch = 2 if domain == "complex" else 1
    tmask = np.array(j_sample_masks(kmask, B, cfg.image_frames, cfg.mask))
    return dict(
        tmask=torch.from_numpy(tmask),
        t=torch.from_numpy(np.array(jax.random.uniform(kt, (B,)))),
        eps=nchw(jax.random.normal(
            keps, (B, cfg.stft.n_fft // 2 + 1, cfg.image_frames, n_ch))),
        keep=torch.from_numpy(np.array(
            jax.random.uniform(kdrop, (B, 1, 1, 1)) >= cond_drop
        ).reshape(B)))


def _assert_updates(new, old, ref_new):
    """Each tensor's update new − old against ref_new − old."""
    upd = {k: np.asarray(new[k]) - old[k] for k in old}
    ref = {k: np.asarray(ref_new[k]) - old[k] for k in old}
    top = max(np.abs(u).max() for u in ref.values())
    assert top > 0
    for k in old:
        np.testing.assert_allclose(upd[k], ref[k], rtol=UPD_RTOL,
                                   atol=UPD_ATOL * top, err_msg=k)
    return top


@pytest.mark.parametrize("name", list(CASES))
def test_refiner_train_step_matches_jax(name):
    domain, kw, coin, frames_from, use_adam = CASES[name]
    av = frames_from is not None
    cd, sc = kw.get("cond_drop", 0.0), kw.get("self_cond", False)
    pcfg = port_cfg(use_video=av)
    jcfg = jax_cfg(pcfg)
    JG, PG, JV, PV, JR, PR, before = _nets(av, *_r_channels(domain, sc))
    PR_ema = copy.deepcopy(PR)

    g_def, g_state = nnx.split(JG)
    v_def, v_state = nnx.split(JV) if av else (None, None)
    r_def, r_state = nnx.split(JR)
    r_ema = jax.tree.map(jnp.copy, r_state)
    tx, j_step = _jax_step(name, g_def, v_def, r_def, jcfg)
    r_opt = tx.init(r_state)
    if use_adam:
        opt = Adam(PR.parameters(), cosine(LR, ADAM_STEPS, 0, 1, alpha=0.1),
                   betas=(0.9, 0.999), eps=ADAM_EPS)
        # The update of count 4 (of 8): the decayed lr, bias corrections
        # at t = 5.
        opt.count = ADAM_COUNT
        r_opt = jax.tree.map(jnp.copy, optax.tree_utils.tree_set(
            r_opt, count=jnp.asarray(ADAM_COUNT, jnp.int32)))
    else:
        opt = torch.optim.SGD(PR.parameters(), lr=LR)
    make = (pd.make_complex_refiner_train_step if domain == "complex"
            else pd.make_refiner_train_step)
    p_step = make(PG, PV, PR, PR_ema, opt, pcfg, **kw)

    rng = np.random.default_rng(4)
    wav = (tone_batch(B, CLIP, seed=4) + 0.01 * rng.standard_normal(
        (B, CLIP))).astype(np.float32)
    if av:
        frames = (np.random.default_rng(5) if frames_from == "own_seed"
                  else rng).uniform(0, 1, (B, 8, 16, 16, 3)).astype(
                      np.float32)
    else:
        frames = None
    j_extra = (jnp.asarray(frames),) if av else ()
    key = _key(coin, cd)
    if coin is not None:
        assert _coin(key) == coin
    r_state, r_opt, r_ema, j_met = j_step(
        r_state, r_opt, r_ema, g_state, v_state, jnp.asarray(wav), key,
        *j_extra)
    p_met = p_step(torch.from_numpy(wav), None,
                   None if frames is None else torch.from_numpy(frames),
                   sc_first_pass=_coin(key) if sc else None,
                   **_jax_draws(key, domain, cd, jcfg))
    np.testing.assert_allclose(float(p_met["loss_R"]),
                               float(j_met["loss_R"]), rtol=LOSS_RTOL)
    top = _assert_updates(flat_from_state(PR), before,
                          flatten_state(r_state))
    # The EMA carries (1 − decay) of R's update error, beside float32
    # rounding of its values (which the two packages round in their own
    # order: decay·e + (1 − decay)·p has two or three roundings).
    ema, ref = flat_from_state(PR_ema), flatten_state(r_ema)
    for k in before:
        np.testing.assert_allclose(
            ema[k].numpy(), np.asarray(ref[k]), rtol=EMA_RTOL,
            atol=(1 - EMA_DECAY) * UPD_ATOL * top, err_msg=k)


def test_refiner_train_step_draws_from_its_generator():
    """Every draw comes from the generator in the documented order, so
    two runs from one seed take the same step, and a step given the
    draws equals one that made them."""
    PG = _nets(False, 4, 1)[1]
    cfg = port_cfg()
    wav = torch.from_numpy(tone_batch(B, CLIP, seed=1))
    out = []
    for given in (False, True):
        R = define_R(5, 8, seed=1, device="cpu")
        step = pd.make_refiner_train_step(
            PG, None, R, copy.deepcopy(R), torch.optim.SGD(R.parameters(),
                                                           lr=LR),
            cfg, cond_drop=0.5, self_cond=True)
        gen = torch.Generator().manual_seed(7)
        if given:
            from viai_tpu_torch.signal.mask import sample_batch_masks

            g = torch.Generator().manual_seed(7)
            kw = dict(tmask=sample_batch_masks(g, B, cfg.image_frames,
                                               cfg.mask),
                      t=torch.rand((B,), generator=g),
                      eps=torch.randn((B, 1, 64, 64), generator=g),
                      keep=torch.rand((B,), generator=g) >= 0.5,
                      sc_first_pass=bool(torch.rand((), generator=g) < 0.5))
            loss = step(wav, **kw)["loss_R"]
        else:
            loss = step(wav, gen)["loss_R"]
        out.append((float(loss), flat_from_state(R)))
    assert out[0][0] == out[1][0]
    for k, v in out[0][1].items():
        torch.testing.assert_close(v, out[1][1][k], rtol=0, atol=0)
    with pytest.raises(ValueError, match="generator"):
        step(wav)


def test_cosine_alpha_matches_optax():
    ref = optax.cosine_decay_schedule(2e-4, 100, alpha=0.1)
    sched = cosine(2e-4, 100, 0, 1, alpha=0.1)
    for s in (0, 1, 37, 99, 100, 150):
        np.testing.assert_allclose(sched(s), float(ref(s)), rtol=1e-6)
    assert sched(0) == 2e-4


# ---------------------------------------------------------------------------
# The CLI: checkpoints, resume, the record
# ---------------------------------------------------------------------------

TINY = [
    "--gpu_ids", "-1", "--ngf", "8", "--ndf", "8",
    "--clip_seconds", "0.252", "--n_fft", "126", "--hop_length", "64",
    "--image_frames", "64", "--min_gap_frames", "8",
    "--max_gap_frames", "16",
]


def _files(expr):
    return {f: torch.load(os.path.join(expr, f), weights_only=True)
            for f in os.listdir(expr) if "_net_R" in f}


def test_cli_trains_saves_and_resumes_exactly(tmp_path, monkeypatch):
    domain = "complex"
    monkeypatch.delenv("VIAI_RESULTS_JSONL", raising=False)
    ckpt, results = str(tmp_path / "ckpt"), str(tmp_path / "results")
    jax_record = os.path.join(ROOT, "scripts", "quality_results.jsonl")
    with open(jax_record, "rb") as f:
        jax_before = f.read()
    opt = TestOptions().parse(["--name", "g", "--checkpoints_dir", ckpt,
                               *TINY], save=False)
    VIAIModel(opt).save_networks("latest")           # the frozen G
    args = ["--name", "g", "--checkpoints_dir", ckpt, "--steps", "4",
            "--batch", "2", "--pool_batches", "3", "--milestone", "2",
            "--rngf", "8", "--domain", domain, "--cond_drop", "0.5",
            "--self_cond", "--results_dir", results, *TINY]
    rec = refiner_main(args)
    expr = os.path.join(ckpt, "g")
    first = _files(expr)
    assert sorted(first) == sorted(
        f"{tag}_net_{n}.pth" for tag in ("2", "4", "latest")
        for n in ("R", "Rraw"))
    assert os.path.exists(os.path.join(expr, "R2_state.pt"))
    assert np.isfinite(rec["final_v_mse"])
    # The EMA lags the raw weights.
    assert any(not torch.equal(first["4_net_R.pth"][k],
                               first["4_net_Rraw.pth"][k])
               for k in first["4_net_R.pth"])

    # Resumed from step 2: the same weights at step 4, to the bit.
    assert refiner_main(args + ["--resume_step", "4"]) is None
    again = refiner_main(args + ["--resume_step", "2"])
    second = _files(expr)
    for f in ("4_net_R.pth", "4_net_Rraw.pth", "latest_net_R.pth"):
        for k, v in first[f].items():
            assert torch.equal(v, second[f][k]), (f, k)
    assert again["final_v_mse"] == rec["final_v_mse"]

    # The record goes to {results_dir}, never to the JAX package's file.
    with open(os.path.join(results, "quality_results.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["resume_step"] for r in recs] == [0, 2]
    assert all(r["package"] == "viai_tpu_torch" and r["exp"] ==
               "train_refiner" and r["domain"] == domain for r in recs)
    with open(jax_record, "rb") as f:
        assert f.read() == jax_before

    # viai_tpu reads the port's R files into its own R: the same values.
    r_in, r_out = _r_channels(domain, True)
    shapes = nnx.split(nnx.eval_shape(
        lambda: j_define_R(r_in, ngf=8, out_channels=r_out)))[1]
    template = jax.tree.map(lambda x: np.zeros(x.shape, x.dtype), shapes)
    for net in ("R", "Rraw"):
        loaded = flatten_state(j_load_networks({net: template}, 4,
                                               expr)[net])
        PR = define_R(r_in, 8, out_channels=r_out, device="cpu")
        load_networks({net: PR}, 4, expr)
        ours = flat_from_state(PR)
        assert sorted(loaded) == sorted(ours)
        for k, v in ours.items():
            np.testing.assert_array_equal(loaded[k], v.numpy(), err_msg=k)
