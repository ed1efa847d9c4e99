"""Checkpoints, resume, data, options, visuals and the train CLI of the
port, against viai_tpu where it has the same surface.

  * save_networks writes the JAX package's schema: viai_tpu's
    load_networks reads the port's G and D files, and the JAX nets
    then give the port's outputs (atol 5e-4, rtol 1e-3: float32 conv
    order); files viai_tpu saved load into the port's D and V;
  * a full-state resume, 2 + 1 steps, equals 3 uninterrupted steps
    exactly on the CPU (weights, both Adams with their plateau state,
    the pool, the generator);
  * the synthetic loaders yield viai_tpu's batches bit for bit;
  * train_config_from_opt equals viai_tpu's for the same flags;
  * the visualizer's PNGs hold viai_tpu's pixels exactly, and with
    --tensorboard it writes event files (tests/test_torch_tensorboard.py
    holds them against the JAX writer);
  * the train CLI runs 2 steps on the CPU, then 2 more with
    --continue_train, as tests/test_cli_e2e.py does for viai_tpu.
"""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from viai_tpu.config.options import TrainOptions as JTrainOptions
from viai_tpu.data import synthetic as jsyn
from viai_tpu.io import available_epochs as j_available_epochs
from viai_tpu.io import load_networks as j_load_networks
from viai_tpu.io import save_networks as j_save_networks
from viai_tpu.model import train_config_from_opt as j_train_config
from viai_tpu.utils.visualizer import spec_to_png as j_spec_to_png
from viai_tpu_torch.cli.train import main as train_main
from viai_tpu_torch.config import TrainOptions, device_from_opt
from viai_tpu_torch.data import create_dataloader
from viai_tpu_torch.data import synthetic as psyn
from viai_tpu_torch.io import available_epochs, load_networks, save_networks
from viai_tpu_torch.model import VIAIModel, train_config_from_opt
from viai_tpu_torch.nn import (DiscriminatorConfig, MultiScaleDiscriminator,
                               VideoFeatureNet, VideoNetConfig)
from viai_tpu_torch.utils.tensorboard import read_scalars
from viai_tpu_torch.utils.visualizer import Visualizer, spec_to_png

from _torch_train_util import D_TINY, V_TINY, make_D, make_G, make_V, nchw, nhwc

TOL = dict(atol=5e-4, rtol=1e-3)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

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


def test_port_checkpoint_loads_into_jax(tmp_path):
    JG, PG = make_G(seed=3)
    JD, PD = make_D(seed=4, num_D=2)
    save_networks({"G": PG, "D": PD}, 5, str(tmp_path))
    assert available_epochs(str(tmp_path)) == ["5", "latest"] == \
        j_available_epochs(str(tmp_path))
    # Fresh JAX nets of the same config, loaded from the port's files.
    from viai_tpu.nn import DiscriminatorConfig as JDConfig
    from viai_tpu.nn import MultiScaleDiscriminator as JMultiD
    from viai_tpu.nn import UNetGenerator as JUNet

    G2 = JUNet(JG.cfg, nnx.Rngs(7))
    D2 = JMultiD(JDConfig(in_channels=3, **D_TINY), 2, nnx.Rngs(8))
    loaded = j_load_networks({"G": nnx.split(G2)[1], "D": nnx.split(D2)[1]},
                             5, str(tmp_path))
    nnx.update(G2, loaded["G"])
    nnx.update(D2, loaded["D"])
    x = np.random.default_rng(1).uniform(-1, 1, (2, 64, 64, 2)).astype(
        np.float32)
    with torch.no_grad():
        np.testing.assert_allclose(np.asarray(G2(jnp.asarray(x))),
                                   nhwc(PG(nchw(x))), **TOL)
        xd = np.concatenate([x, x[..., :1]], -1)
        for a, b in zip(D2(jnp.asarray(xd)), PD(nchw(xd))):
            np.testing.assert_allclose(np.asarray(a), nhwc(b), **TOL)


def test_jax_checkpoint_loads_into_the_port(tmp_path):
    JD, _ = make_D(seed=5, num_D=2)
    JV, _ = make_V(seed=6)
    j_save_networks({"D": nnx.split(JD)[1], "V": nnx.split(JV)[1]}, "latest",
                    str(tmp_path))
    PD = MultiScaleDiscriminator(DiscriminatorConfig(in_channels=3, **D_TINY),
                                 2)
    PV = VideoFeatureNet(VideoNetConfig(**V_TINY))
    load_networks({"D": PD, "V": PV}, "latest", str(tmp_path))
    xd = np.random.default_rng(2).uniform(-1, 1, (2, 64, 64, 3)).astype(
        np.float32)
    fr = np.random.default_rng(3).uniform(0, 1, (2, 8, 16, 16, 3)).astype(
        np.float32)
    with torch.no_grad():
        for a, b in zip(JD(jnp.asarray(xd)), PD(nchw(xd))):
            np.testing.assert_allclose(nhwc(b), np.asarray(a), **TOL)
        np.testing.assert_allclose(PV(torch.from_numpy(fr)).numpy(),
                                   np.asarray(JV(jnp.asarray(fr))), **TOL)


def _opt(tmp_path, extra=()):
    return TrainOptions().parse(TINY + [
        "--checkpoints_dir", str(tmp_path), "--name", "resume",
        "--lr_policy", "plateau", "--steps_per_epoch", "2",
        "--pool_size", "2", *extra], save=False)


def test_full_state_resume_is_exact(tmp_path):
    batches = [next(iter(create_dataloader(
        "synthetic", batch_size=2, clip_samples=4032, shuffle=False,
        num_epochs=1)))]
    rng = np.random.default_rng(0)
    batches += [{"wav": rng.uniform(-0.5, 0.5, (2, 4032)).astype(np.float32)}
                for _ in range(2)]

    def run(model, bs):
        for b in bs:
            model.set_input(b)
            model.optimize_parameters()

    full = VIAIModel(_opt(tmp_path))
    run(full, batches)
    part = VIAIModel(_opt(tmp_path))
    run(part, batches[:2])
    part.save_networks("latest")
    resumed = VIAIModel(_opt(tmp_path))
    resumed.load_networks("latest")
    assert resumed.state["step"] == 2
    run(resumed, batches[2:])
    assert resumed.state["step"] == full.state["step"] == 3
    for name in ("G", "D"):
        a = getattr(full, name).state_dict()
        b = getattr(resumed, name).state_dict()
        for k in a:
            assert torch.equal(a[k], b[k]), (name, k)
    for o1, o2 in ((full.g_opt, resumed.g_opt), (full.d_opt, resumed.d_opt)):
        assert o1.count == o2.count == 3
        for p1, p2 in zip(o1.state.values(), o2.state.values()):
            assert torch.equal(p1["mu"], p2["mu"])
            assert torch.equal(p1["nu"], p2["nu"])
        for k, v in o1.plateau.state.items():
            assert (torch.equal(v, o2.plateau.state[k]) if torch.is_tensor(v)
                    else v == o2.plateau.state[k])
    assert torch.equal(full.state["pool"]["buf"], resumed.state["pool"]["buf"])
    assert torch.equal(full.generator.get_state(),
                       resumed.generator.get_state())
    assert full.get_current_losses() == resumed.get_current_losses()
    # A .pth-only checkpoint (e.g. exported by viai_tpu) loads the nets.
    os.remove(tmp_path / "resume" / "latest_state.pt")
    fresh = VIAIModel(_opt(tmp_path))
    fresh.load_networks("latest")
    assert fresh.state["step"] == 0
    assert torch.equal(fresh.G.head.weight, part.G.head.weight)


@pytest.mark.parametrize("mode", ["synthetic", "synthetic_av",
                                  "synthetic_notes", "synthetic_av_cue"])
def test_synthetic_loaders_match_jax(mode):
    kw = dict(sample_rate=16000, clip_seconds=0.252, with_video="_av" in mode,
              video_frames=4, video_size=16,
              style=("av_cue" if mode.endswith("_cue") else
                     "notes" if mode.endswith("_notes") else "harmonic"))
    if kw["style"] == "av_cue":
        kw["clip_seconds"] = 2.0
    jit = jsyn.SyntheticBatchIterator(jsyn.SyntheticConfig(**kw), 2, seed=1)
    pit = psyn.SyntheticBatchIterator(psyn.SyntheticConfig(**kw), 2, seed=1)
    try:
        for _ in range(2):
            a, b = next(jit), next(pit)
            assert set(a) == set(b)
            for k in a:
                np.testing.assert_array_equal(b[k], a[k])
    finally:
        jit.close()
        pit.close()
    ds = jsyn.SyntheticAVDataset(jsyn.SyntheticConfig(**kw))
    loader = create_dataloader(mode, batch_size=2,
                               clip_samples=int(16000 * kw["clip_seconds"]),
                               n_frames=4, frame_size=16, shuffle=False,
                               num_epochs=1)
    first = next(iter(loader))
    for i in range(2):
        for k, v in ds[i].items():
            np.testing.assert_array_equal(first[k][i], v)


def test_loader_and_options_refuse_what_is_not_ported(tmp_path):
    for mode in ("audio", "av", "musices"):
        with pytest.raises(FileNotFoundError):
            create_dataloader(mode, "/nonexistent")
    # The multi-device flags parse; a 2-rank mesh needs a process group.
    for flag in ("--n_data_devices", "--n_model_devices"):
        opt = TrainOptions().parse(TINY + [flag, "2"], save=False)
        with pytest.raises(ValueError, match="process group"):
            VIAIModel(opt, expr_dir=str(tmp_path))
    vis = Visualizer(str(tmp_path / "tb_run"), tensorboard=True)
    vis.print_current_losses(1, 0, {"loss_G": 1.5})
    (events,) = os.listdir(tmp_path / "tb_run" / "tb")
    assert read_scalars(str(tmp_path / "tb_run" / "tb" / events)) == [
        ("loss_G", 1, 1.5)]
    opt = TrainOptions().parse(TINY, save=False)
    assert device_from_opt(opt) == torch.device("cpu")
    with pytest.raises(SystemExit):
        TrainOptions().parse(TINY + ["--gl_backend", "xla"], save=False)


@pytest.mark.parametrize("flags", [
    [], ["--long_gap", "--no_lsgan"],
    ["--dataset_mode", "synthetic_av_cue", "--model", "av", "--phase_head",
     "--lambda_fm", "2", "--update_order", "sequential", "--remat"],
    ["--gan_mode", "hinge", "--pool_size", "4", "--num_gaps", "2"],
])
def test_train_config_matches_jax(flags):
    args = TINY[2:] + flags           # the JAX options take no --gpu_ids -1
    jopt = JTrainOptions().parse(args, save=False)
    popt = TrainOptions().parse(args, save=False)
    jc, pc = j_train_config(jopt), train_config_from_opt(popt)
    for f in dataclasses.fields(pc):
        a, b = getattr(jc, f.name), getattr(pc, f.name)
        if dataclasses.is_dataclass(b):     # the port's fields of a
            sub = dataclasses.asdict(b)     # config (JAX's STFT has more)
            assert {k: getattr(a, k) for k in sub} == sub, f.name
        else:
            assert a == b, f.name
    assert set(vars(jopt)) - set(vars(popt)) == {"gl_backend"}


def test_spec_png_matches_jax(tmp_path):
    from PIL import Image

    spec = np.random.default_rng(0).uniform(-0.1, 1.1, (20, 33))
    j_spec_to_png(spec, str(tmp_path / "j.png"))
    spec_to_png(spec, str(tmp_path / "p.png"))
    a = np.asarray(Image.open(tmp_path / "j.png"))
    b = np.asarray(Image.open(tmp_path / "p.png"))
    assert b.shape == (20, 33, 3)
    np.testing.assert_array_equal(b, a)


def test_train_cli_then_continue(tmp_path):
    ckpt = str(tmp_path / "ckpts")
    base = TINY + [
        "--name", "e2e", "--checkpoints_dir", ckpt,
        "--niter", "1", "--niter_decay", "0", "--steps_per_epoch", "2",
        "--save_epoch_freq", "1", "--lr_policy", "constant",
        "--print_freq", "1", "--display_freq", "2",
    ]
    out = subprocess.run([sys.executable, "-m", "viai_tpu_torch.cli.train",
                          *base], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "loss_G_L1" in out.stdout
    expr = os.path.join(ckpt, "e2e")
    for f in ("opt.txt", "loss_log.txt", "loss_log.jsonl", "1_net_G.pth",
              "latest_net_G.pth", "latest_net_D.pth", "latest_state.pt",
              "web/index.html", "web/images/epoch001_inpainted.png"):
        assert os.path.exists(os.path.join(expr, f)), f
    m2 = train_main(base + ["--continue_train", "--which_epoch", "latest"])
    assert m2.state["step"] == 4
    assert np.isfinite(list(m2.get_current_losses().values())).all()
    vis = m2.get_current_visuals()
    assert set(vis) == {"real", "masked", "inpainted"}
    assert all(v.shape == (64, 64) for v in vis.values())
