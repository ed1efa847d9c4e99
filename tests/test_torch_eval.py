"""The evaluation surface of the port against viai_tpu's: the metrics,
TestOptions, VIAIModel's eval chain and the eval CLI.

  * psnr, snr, masked_psnr (an all-observed mask included) and
    spectral_convergence equal viai_tpu's to rtol 1e-5;
  * TestOptions has JAX's flags (less the TPU-only --gl_backend) with
    its defaults, and its choices;
  * VIAIModel.test draws its gaps from a torch.Generator: the JAX chain
    fed the same masks gives its output (atol = rtol = 1e-3 at GL×2, G's
    head bias lowered to -2 as tests/test_torch_chain_options.py does);
    the model's refiner chain with an ensemble, refine_mix and
    refine_avg, fed JAX's noise, gives JAX's;
  * the eval CLI on a checkpoint the port's train CLI wrote, with and
    without the refiner (both domains) and with --eval_samples 2: the
    summary has JAX's keys for the same flags, n == --how_many on a
    partial last batch, and the --log_results record has JAX's keys
    plus the package that wrote it;
  * without VIAI_RESULTS_JSONL the record goes under --results_dir and
    the JAX package's scripts/quality_results.jsonl is left as it was.
"""

import contextlib
import io
import json
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from viai_tpu.cli.test import main as j_test_main
from viai_tpu.config.options import TestOptions as JTestOptions
from viai_tpu.io.checkpoint import unflatten_into
from viai_tpu.nn import GeneratorConfig as JGConfig
from viai_tpu.nn import UNetGenerator as JUNet
from viai_tpu.nn import define_R as j_define_R
from viai_tpu.signal import STFTConfig as JSTFTConfig
from viai_tpu.testing import TINY_CFG, tone_batch
from viai_tpu.train import diffusion as jd
from viai_tpu.train import make_infer_fn as j_make_infer_fn
from viai_tpu.utils import metrics as jm
from viai_tpu_torch.cli.test import main as run_eval
from viai_tpu_torch.cli.train import main as train_main
from viai_tpu_torch.config import options as popts
from viai_tpu_torch.io import flat_from_state, save_networks, state_from_flat
from viai_tpu_torch.model import VIAIModel
from viai_tpu_torch.nn import define_R
from viai_tpu_torch.signal import STFTConfig, sample_batch_masks
from viai_tpu_torch.train import diffusion as pd
from viai_tpu_torch.utils import metrics as pm

from _torch_train_util import perturb

TOL = dict(atol=1e-3, rtol=1e-3)
TINY = [
    "--gpu_ids", "-1",
    "--dataset_mode", "synthetic",
    "--batchSize", "2",
    "--nThreads", "0",
    "--clip_seconds", "0.252",     # 4032 samples → 64 frames at hop 64
    "--n_fft", "126",              # 64 bins
    "--hop_length", "64",
    "--image_frames", "64",
    "--ngf", "8", "--ndf", "8",
    "--min_gap_frames", "8", "--max_gap_frames", "16",
    "--gl_iters", "2",
]
REFINE = ["--refiner", "--rngf", "8", "--refine_steps", "2",
          "--refine_t", "0.3"]


def test_metrics_match_jax():
    rng = np.random.default_rng(0)
    pred, target = rng.uniform(-1, 1, (2, 3, 16, 20, 1)).astype(np.float32)
    keep = np.ones_like(pred)
    keep[0, :, :, 5:9] = 0.0
    keep[1, :, :, 12:] = 0.0
    for jf, pf, args in (
            (jm.psnr, pm.psnr, (pred, target)),
            (jm.snr, pm.snr, (pred, target)),
            (jm.masked_psnr, pm.masked_psnr, (pred, target, keep)),
            (jm.masked_psnr, pm.masked_psnr,
             (pred, target, np.ones_like(pred)))):
        ref = np.asarray(jf(*(jnp.asarray(a) for a in args)))
        out = pf(*(torch.from_numpy(a) for a in args)).numpy()
        assert out.shape == ref.shape == (3,)
        np.testing.assert_allclose(out, ref, rtol=1e-5)
    wp, wt = rng.standard_normal((2, 3, 1000)).astype(np.float32)
    ref = jm.spectral_convergence(jnp.asarray(wp), jnp.asarray(wt),
                                  JSTFTConfig(n_fft=126, hop_length=64))
    out = pm.spectral_convergence(torch.from_numpy(wp), torch.from_numpy(wt),
                                  STFTConfig(n_fft=126, hop_length=64))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5)


def _parse(cls, args):
    with contextlib.redirect_stdout(io.StringIO()):
        return cls().parse(args, save=False)


@pytest.mark.parametrize("flags", [
    [], REFINE + ["--refiner_domain", "complex", "--complex_mag", "keep",
                  "--refine_avg", "4", "--refine_clamp", "q",
                  "--ensemble_names", "a,b", "--refiner_net", "Rraw",
                  "--eval_samples", "3", "--log_results", "x"]])
def test_test_options_match_jax(flags):
    j, p = _parse(JTestOptions, flags), _parse(popts.TestOptions, flags)
    assert set(vars(j)) - set(vars(p)) == {"gl_backend"}
    assert set(vars(p)) - set(vars(j)) == set()
    for k, v in vars(p).items():
        assert getattr(j, k) == v, k
    assert p.isTrain is False
    jp, pp = JTestOptions(), popts.TestOptions()
    jp.initialize()
    pp.initialize()
    choices = {a.dest: a.choices for a in pp.parser._actions}
    for a in jp.parser._actions:
        if a.dest in choices:
            assert choices[a.dest] == a.choices, a.dest


def _model(tmp_path, extra=()):
    opt = _parse(popts.TestOptions, TINY + ["--checkpoints_dir", str(tmp_path),
                                      "--name", "m", *extra])
    return VIAIModel(opt)


def _jax_G(model):
    """A JAX G holding the port model's G."""
    G = JUNet(JGConfig(ngf=8), nnx.Rngs(5))
    _, state = nnx.split(G)
    nnx.update(G, jax.tree.map(jnp.asarray, unflatten_into(
        state, {k: v.numpy() for k, v in flat_from_state(model.G).items()})))
    return nnx.split(G)


def _wav(batch, seed=1):
    noise = np.random.default_rng(seed + 100).standard_normal((batch, 4032))
    return (tone_batch(batch, 4032, seed=seed) + 0.01 * noise).astype(
        np.float32)


def test_model_test_matches_jax_chain(tmp_path):
    model = _model(tmp_path)
    with torch.no_grad():
        model.G.head.bias.fill_(-2.0)
    wav = _wav(2)
    model.set_input({"wav": wav})
    out = model.test(torch.Generator().manual_seed(4))
    masks = sample_batch_masks(torch.Generator().manual_seed(4), 2, 64,
                               model.cfg.mask).numpy()
    assert (masks == 0).any()
    g_def, g_state = _jax_G(model)
    ref = j_make_infer_fn(g_def, None, TINY_CFG, n_gl_iter=2,
                          external_mask=True)(g_state, nnx.State({}), wav,
                                              masks, None)
    assert out.shape == wav.shape
    np.testing.assert_allclose(out, np.asarray(ref), **TOL)


def test_model_refiner_ensemble_chain_matches_jax(tmp_path):
    """VIAIModel's wiring of --ensemble_names, --refiner and the refine_*
    flags: its chain, fed JAX's noise, gives the JAX chain's output."""
    # The extra run of the ensemble and R, written where load_networks
    # looks for them.
    other = _model(tmp_path, ["--seed", "1"])
    with torch.no_grad():
        other.G.head.bias.fill_(-2.0)
    save_networks({"G": other.G}, "latest", str(tmp_path / "run2"))
    JR = j_define_R(4, ngf=8, seed=3)
    flat = perturb(JR, 9)
    R = define_R(4, 8, device="cpu")
    R.load_state_dict(state_from_flat(flat, R))
    save_networks({"R": R}, "latest", str(tmp_path / "m"))
    model = _model(tmp_path, ["--ensemble_names", "run2", *REFINE,
                              "--refine_avg", "2", "--refine_chunk", "1",
                              "--refine_mix", "0.4"])
    with torch.no_grad():
        model.G.head.bias.fill_(-2.0)
    model._load_eval_nets("latest")
    assert len(model.ensemble) == 1
    torch.testing.assert_close(model.ensemble[0].head.weight,
                               other.G.head.weight)
    wav = _wav(2, seed=3)
    model.set_input({"wav": wav})
    masks = sample_batch_masks(torch.Generator().manual_seed(6), 2, 64,
                               model.cfg.mask).numpy()
    keys = jd.avg_keys(jax.random.key(0), 2)
    noise = [pd.RefineNoise(torch.from_numpy(np.asarray(
        jax.random.normal(k, (2, 64, 64, 1)))).permute(0, 3, 1, 2))
        for k in keys]
    out = model.infer_fn(torch.from_numpy(wav),
                         torch.Generator().manual_seed(6), noise=noise)
    (g_def, s1), (_, s2) = _jax_G(model), _jax_G(other)
    ref = j_make_infer_fn(
        g_def, None, TINY_CFG, n_gl_iter=2, external_mask=True,
        refiner=nnx.split(JR), refine_steps=2, refine_t=0.3, refine_avg=2,
        refine_chunk=1, refine_mix=0.4, n_ensemble=2)(
        jax.tree.map(lambda a, b: jnp.stack([a, b]), s1, s2),
        nnx.State({}), wav, masks, None)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_model_refuses_what_jax_refuses(tmp_path):
    with pytest.raises(ValueError, match="ensemble_names"):
        _model(tmp_path, ["--ensemble_names", "x", *REFINE,
                          "--refiner_domain", "complex"])


def _train(ckpt):
    with contextlib.redirect_stdout(io.StringIO()):
        train_main(TINY + [
            "--name", "ev", "--checkpoints_dir", ckpt, "--niter", "1",
            "--niter_decay", "0", "--steps_per_epoch", "2",
            "--save_epoch_freq", "1", "--lr_policy", "constant",
            "--print_freq", "1"])
    expr = os.path.join(ckpt, "ev")
    # The complex R first: an epoch tag also writes the latest alias.
    r_in, r_out = pd.complex_refiner_channels(2)
    save_networks({"R": define_R(r_in, 8, out_channels=r_out,
                                 device="cpu")}, "cplx", expr)
    save_networks({"R": define_R(4, 8, device="cpu")}, "latest", expr)


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_eval_cli_matches_jax_keys(tmp_path, monkeypatch):
    ckpt = str(tmp_path / "ckpts")
    _train(ckpt)
    jsonl = tmp_path / "q.jsonl"
    monkeypatch.setenv("VIAI_RESULTS_JSONL", str(jsonl))
    base = ["--name", "ev", "--checkpoints_dir", ckpt, "--how_many", "3",
            "--results_dir", str(tmp_path / "res")]
    arms = {"plain": [], "refiner_bok": REFINE + ["--eval_samples", "2"]}
    for tag, extra in arms.items():
        with contextlib.redirect_stdout(io.StringIO()):
            # The JAX batch must divide its data mesh (the tests' 8
            # virtual CPU devices).
            j = j_test_main(TINY[2:] + base + extra + [
                "--n_data_devices", "2", "--log_results", tag])
            p = run_eval(TINY + base + extra + ["--log_results", tag])
        assert set(p) == set(j), tag
        assert p["n"] == j["n"] == 3
        assert all(np.isfinite(v) for v in p.values()), tag
        assert ("eval_samples" in p) == (tag == "refiner_bok")
        if tag == "refiner_bok":
            assert p["hole_psnr_s1_mean"] == p["hole_psnr_mean"]
            assert p["hole_psnr_bok_mean"] >= p["hole_psnr_mean"] - 1e-6
    recs = _records(jsonl)
    assert len(recs) == 4
    for j, p in zip(recs[0::2], recs[1::2]):
        assert set(p) == set(j) | {"package"}
        assert p["package"] == "viai_tpu_torch"
        assert len(p["hole_psnr_clips"]) == 3
        for k in ("seed", "batchSize", "dataset_mode", "how_many", "tag"):
            assert p[k] == j[k], k
    # The complex domain and --eval_samples without a refiner (one sample,
    # as JAX falls back).
    with contextlib.redirect_stdout(io.StringIO()) as out:
        c = run_eval(TINY + base + REFINE + [
            "--refiner_domain", "complex", "--refiner_epoch", "cplx",
            "--refine_t", "1.0", "--complex_mag", "mean", "--refine_avg",
            "2"])
        one = run_eval(TINY + base + ["--eval_samples", "2"])
    assert set(c) == set(one) == set(recs[0]) - {
        "exp", "tag", "name", "which_epoch", "dataset_mode", "seed",
        "batchSize", "how_many", "t", "hole_psnr_clips"}
    assert c["n"] == 3 and np.isfinite(c["hole_psnr_mean"])
    assert "falling back to 1 sample" in out.getvalue()
    assert os.path.exists(tmp_path / "res" / "ev" / "test_latest" /
                          "index.html")


def test_eval_record_defaults_to_the_results_dir(tmp_path, monkeypatch):
    model = _model(tmp_path)
    save_networks({"G": model.G, "D": model.D}, "latest",
                  str(tmp_path / "m"))
    monkeypatch.delenv("VIAI_RESULTS_JSONL", raising=False)
    reference = (pathlib.Path(__file__).resolve().parents[1] / "scripts"
                 / "quality_results.jsonl")
    before = reference.read_bytes() if reference.exists() else None
    res = tmp_path / "res"
    with contextlib.redirect_stdout(io.StringIO()):
        summary = run_eval(TINY + [
            "--name", "m", "--checkpoints_dir", str(tmp_path),
            "--results_dir", str(res), "--how_many", "2",
            "--log_results", "default_path"])
    after = reference.read_bytes() if reference.exists() else None
    assert after == before
    (rec,) = _records(res / "quality_results.jsonl")
    assert rec["package"] == "viai_tpu_torch"
    assert rec["tag"] == "default_path" and rec["n"] == summary["n"] == 2
