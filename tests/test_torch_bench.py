"""The port's bench (viai_tpu_torch/bench.py) against bench.py's chains.

Each preset's chain, built by `build_infer` from the bench's own flags,
is held against the chain bench.py builds with the same arguments
(bench.py:92-118), at the tiny sizes of viai_tpu.testing (n_fft 126,
64×64 images, G ngf 8, R ngf 8) in float32 with GL×1: the nets are the
JAX package's, moved off their init and carried through the .pth bridge
(G's head bias lowered to −2, as tests/test_torch_refiner.py does);
the gaps are JAX's draws from the chain's key (the port's sampler is
given them), and the refiner's noise is JAX's draws from the chain's
keys (`noise=`). The refiner presets are held against eager JAX
(`jax.disable_jit`, ROADMAP queue 3 trap (c)). Bound atol = rtol = 1e-3,
that of tests/test_torch_refiner.py and test_torch_chain_options.py for
the same chains.

The entry point runs once on the CPU at full width (batch 2, two chained
calls a sample, GL×2) and its JSON line is checked field by field.
"""

import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from viai_tpu.nn import define_R as j_define_R
from viai_tpu.signal.mask import sample_batch_masks as j_sample_masks
from viai_tpu.testing import TINY_CFG as J_TINY
from viai_tpu.train import diffusion as jd
from viai_tpu.train import make_infer_fn as j_make_infer_fn
from viai_tpu_torch import bench
from viai_tpu_torch.io import state_from_flat
from viai_tpu_torch.nn import define_R
from viai_tpu_torch.testing import TINY_CFG, tone_batch
from viai_tpu_torch.train import diffusion as pd

from _torch_train_util import make_G, nchw, perturb

CHAIN_TOL = dict(atol=1e-3, rtol=1e-3)
B, CLIP = 2, 4032


def _jax_noise(key, shape) -> pd.RefineNoise:
    """The ε₀ ddim_refine(key) draws (no RePaint rounds), NCHW."""
    return pd.RefineNoise(nchw(jax.random.normal(key, shape)))


def _nets(preset):
    JG, PG = make_G(seed=0)
    JG.head.bias[...] = jnp.full_like(JG.head.bias[...], -2.0)
    with torch.no_grad():
        PG.head.bias.fill_(-2.0)
    JR = PR = None
    if preset != "default":
        r_in, r_out = ((4, 1) if preset == "refiner_mag"
                       else pd.complex_refiner_channels(2))
        JR = j_define_R(r_in, ngf=8, seed=3, out_channels=r_out)
        PR = define_R(r_in, 8, out_channels=r_out, device="cpu")
        PR.load_state_dict(state_from_flat(perturb(JR, 203), PR))
    return JG, PG.eval(), JR, PR


def _jax_chain(preset, JG, JR, args):
    """bench.py's chain for `preset` (its arguments, at TINY_CFG)."""
    g_def, _ = nnx.split(JG)
    if preset == "default":
        return j_make_infer_fn(g_def, None, J_TINY, n_gl_iter=args.gl_iters,
                               phase_aware=not args.no_phase_aware,
                               phase_init=args.phase_init)
    if preset == "refiner_mag":
        return j_make_infer_fn(g_def, None, J_TINY, n_gl_iter=args.gl_iters,
                               phase_aware=not args.no_phase_aware,
                               phase_init=args.phase_init,
                               refiner=nnx.split(JR), refine_steps=8,
                               refine_t=0.35)
    r_def, r_state = nnx.split(JR)
    return jd.make_complex_refiner_infer_fn(
        g_def, None, r_def, r_state, J_TINY, steps=16, t_start=1.0,
        refine_avg=8, refine_chunk=args.refine_chunk,
        complex_mag="keep" if preset == "hybrid" else "sample")


@pytest.mark.parametrize("preset", bench.PRESETS)
def test_preset_chain_matches_jax(preset, monkeypatch):
    args = bench.parse_args(["--preset", preset, "--dtype", "float32",
                             "--gl_iters", "1", "--device", "cpu"])
    JG, PG, JR, PR = _nets(preset)
    wav = tone_batch(B, CLIP, seed=4)
    wav += 0.01 * np.random.default_rng(104).standard_normal(wav.shape).astype(
        np.float32)
    key = jax.random.key(5)
    jfn = _jax_chain(preset, JG, JR, args)
    g_state = nnx.split(JG)[1]
    if preset == "default":
        ref = jfn(g_state, nnx.State({}), jnp.asarray(wav), key)
    else:
        with jax.disable_jit():
            ref = jfn(g_state, nnx.State({}), jnp.asarray(wav), key)
    # The gaps: JAX's draws from the chain's key, given to the port's
    # sampler in place of its own.
    jmask = torch.from_numpy(np.array(j_sample_masks(
        key, B, J_TINY.image_frames, J_TINY.mask)))
    monkeypatch.setattr(
        importlib.import_module("viai_tpu_torch.train.preprocess"),
        "sample_batch_masks", lambda gen, batch, n, cfg: jmask)
    noise = None
    if preset == "refiner_mag":
        knoise = jax.random.fold_in(key, 0x5EED)
        noise = [_jax_noise(knoise, (B, 64, 64, 1))]
    elif preset != "default":
        knoise = jax.random.fold_in(key, 0xC0)
        noise = [_jax_noise(k, (B, 64, 64, 2))
                 for k in jd.avg_keys(knoise, 8)]
    infer = bench.build_infer(preset, PG, PR, TINY_CFG, args)
    out = infer(torch.from_numpy(wav), torch.Generator().manual_seed(0),
                noise=noise)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **CHAIN_TOL)


def test_bench_entry_point_prints_its_json_line(capsys):
    res = bench.main(["--device", "cpu", "--batch", "2", "--inner", "2",
                      "--gl_iters", "2"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line) == res
    assert res["metric"] == ("clips_per_sec_cpu (2s inpaint + Griffin-Lim "
                             "x2)")
    assert res["unit"] == "clips/s (CPU)"
    assert np.isfinite(res["value"]) and res["value"] > 0
    n = res["n_samples"]
    assert 5 <= n <= 12 and len(res["samples_clips_per_sec"]) == n
    assert res["n_plateau"] + res["n_stall_samples"] == n
    assert res["n_plateau"] >= 1
    assert res["value"] == float(np.median(
        [s for s in res["samples_clips_per_sec"]
         if s >= 0.85 * np.median(res["samples_clips_per_sec"])]))
    assert res["plateau_spread_pct"] <= res["raw_spread_pct"]
    assert res["cold_discarded"] > 0
    assert {k: res[k] for k in ("preset", "batch", "dtype", "gl_iters",
                                "refine_chunk", "inner", "graph", "card",
                                "power_limit_w")} == {
        "preset": "default", "batch": 2, "dtype": "bfloat16", "gl_iters": 2,
        "refine_chunk": 4, "inner": 2, "graph": False, "card": "cpu",
        "power_limit_w": None}
