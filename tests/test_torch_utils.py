"""The port's profiling helpers, tiny builders and VIAIModel's reference
no-ops, against viai_tpu's.

  * StepTimer gives viai_tpu's averages and throughput on the same
    ticks (the host clock replaced by a fixed sequence);
  * `trace` writes a Chrome trace of the block;
  * debug mode (anomaly detection) raises at a backward op that makes a
    NaN, and off again lets it through;
  * VIAIModel has eval(), train() and set_requires_grad() as no-ops;
  * testing.py's TINY_CFG, tone_batch and tiny_models are viai_tpu's:
    the same config fields, clips bit for bit, and nets whose weights
    cross through the .pth bridge and then give viai_tpu's outputs
    (atol 5e-4, rtol 1e-3: float32 conv order, as
    tests/test_torch_train_io.py).
"""

import dataclasses
import glob
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from viai_tpu import testing as jt
from viai_tpu.io import flatten_state
from viai_tpu.utils import profiling as jprof
from viai_tpu_torch import testing as pt
from viai_tpu_torch.config import TrainOptions
from viai_tpu_torch.io import state_from_flat
from viai_tpu_torch.model import VIAIModel
from viai_tpu_torch.utils import profiling as pprof

TOL = dict(atol=5e-4, rtol=1e-3)
TICKS = [10.0, 10.5, 11.25, 11.5, 13.0, 13.1]


def _timed(timer_cls, monkeypatch, module):
    ticks = iter(TICKS)
    monkeypatch.setattr(module.time, "perf_counter", lambda: next(ticks))
    t = timer_cls(ema=0.9)
    dts = [t.tick() for _ in TICKS]
    return dts, t.avg, t.throughput(16)


def test_step_timer_matches_jax(monkeypatch):
    ours = _timed(pprof.StepTimer, monkeypatch, pprof)
    ref = _timed(jprof.StepTimer, monkeypatch, jprof)
    assert ours == ref
    assert ours[0][0] is None and ours[2] > 0
    assert pprof.StepTimer().throughput(8) == 0.0


def test_trace_writes_a_chrome_trace(tmp_path):
    with pprof.trace(str(tmp_path)) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = glob.glob(str(tmp_path / "trace_*.json"))
    assert len(files) == 1
    events = json.load(open(files[0]))["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert prof.key_averages()


def test_debug_mode_raises_on_a_nan_backward():
    def nan_grad():
        x = torch.zeros(3, requires_grad=True)
        (torch.sqrt(x) * 0.0).sum().backward()   # 0 · ∞ in SqrtBackward
        return x.grad

    pprof.enable_debug_mode()
    try:
        with pytest.raises(RuntimeError, match="nan"):
            nan_grad()
    finally:
        pprof.disable_debug_mode()
    assert torch.isnan(nan_grad()).all()


def test_model_reference_no_ops(tmp_path):
    opt = TrainOptions().parse([
        "--gpu_ids", "-1", "--dataset_mode", "synthetic", "--batchSize", "2",
        "--clip_seconds", "0.252", "--n_fft", "126", "--hop_length", "64",
        "--image_frames", "64", "--ngf", "8", "--ndf", "8",
        "--checkpoints_dir", str(tmp_path)], save=False)
    model = VIAIModel(opt)
    before = {k: v.clone() for k, v in model.G.state_dict().items()}
    assert model.eval() is model and model.train() is model
    assert model.set_requires_grad([model.G], False) is None
    assert all(p.requires_grad for p in model.G.parameters())
    assert all(torch.equal(v, model.G.state_dict()[k])
               for k, v in before.items())
    assert model.mesh.shape == {"data": 1, "model": 1}
    # set_input refuses a batch that does not divide over the data axis.
    model.mesh = dataclasses.replace(model.mesh, shape={"data": 2,
                                                        "model": 1})
    with pytest.raises(ValueError, match="divisible"):
        model.set_input({"wav": np.zeros((3, 4032), np.float32)})


def test_tiny_builders_match_jax():
    for f in ("image_frames", "lambda_l1"):
        assert getattr(pt.TINY_CFG, f) == getattr(jt.TINY_CFG, f)
    assert (pt.TINY_STFT.n_fft, pt.TINY_STFT.hop_length) == (
        jt.TINY_STFT.n_fft, jt.TINY_STFT.hop_length)
    assert (pt.TINY_CFG.mask.min_gap_frames, pt.TINY_CFG.mask.max_gap_frames
            ) == (jt.TINY_CFG.mask.min_gap_frames,
                  jt.TINY_CFG.mask.max_gap_frames)
    assert pt.TINY_CFG.n_bins == pt.TINY_STFT.n_bins == 64
    np.testing.assert_array_equal(pt.tone_batch(3, seed=2),
                                  jt.tone_batch(3, seed=2))
    jG, jD, jV = jt.tiny_models(use_video=True, seed=1)
    pG, pD, pV = pt.tiny_models(use_video=True, seed=1, device="cpu")
    for jm, pm in ((jG, pG), (jD, pD), (jV, pV)):
        pm.load_state_dict(state_from_flat(flatten_state(nnx.split(jm)[1]),
                                           pm))
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (2, 64, 64, 2)).astype(np.float32)
    fr = rng.uniform(0, 1, (2, 8, 16, 16, 3)).astype(np.float32)
    with torch.no_grad():
        feats = pV(torch.from_numpy(fr))
        np.testing.assert_allclose(feats.numpy(),
                                   np.asarray(jV(jnp.asarray(fr))), **TOL)
        y = pG(torch.from_numpy(x).permute(0, 3, 1, 2), feats)
    ref = jG(jnp.asarray(x), jV(jnp.asarray(fr)))
    np.testing.assert_allclose(y.permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref), **TOL)
    assert pt.tiny_models(seed=1, device="cpu")[2] is None
