"""The port's scripts (viai_tpu_torch/scripts/) against the JAX package's
(scripts/*.py, loaded with importlib) on the CPU, at tiny sizes.

  * `_quality.hole_psnr` against the computation of
    scripts/quality_report.py:77-87 in viai_tpu (preprocess with the
    mask, the external-mask chain, STFT magnitude, compress, masked_psnr
    over the STFT's frames, the batch mean), the same tiny G (and V)
    through the weight bridge, clips, masks and GL×8: |Δ| ≤ 1e-2 dB
    (float32 order through G and 8 iterations of a chaotic GL);
  * bayes_ceiling: hidden_window and posterior_resample equal the JAX
    script's exactly for the same numpy generator; `run` with the JAX
    run's gaps (jax.random) within 1e-3 dB of the JAX run in both styles
    (the STFT in float32 in another order), its note counts equal;
  * utils/cost.py: conv_gflop equals FlopCounterMode and a hand count;
    the byte counter counts operands and results, not views;
    cost_analysis reports G's FLOPs as conv_gflop counts them;
  * prepare_dataset: `synthetic` writes byte-equal files, `manifest`
    equal JSON, `download` the same plan and dry-run output, `extract`
    of a raw AVI (PCM at 22.05 kHz) an equal .npy and a byte-equal .wav
    (both resample through the same native source); a broken .mp4 is
    skipped with its reason and --require_audio then exits 1; `extract`
    and `frames` over mp4v, MJPEG, .mov and VP8 clips give the JAX
    script's stacks, the port listing the VP8 clip as skipped;
  * quality_report.run and quality_long write their records (with
    "package") under --results_dir, not to scripts/quality_results.jsonl;
    quality_long's nets load in cli.test and grid_diag, a resume loads
    the saved state, and the resume guard exits 0;
  * compile_cache relocates the build cache, reuses a build (0.0 s) and
    builds anew under VIAI_NO_CACHE (the g++ native target).
"""

import argparse
import dataclasses
import importlib.util
import json
import os
import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from viai_tpu.data import synthetic as j_syn
from viai_tpu.io import flatten_state
from viai_tpu.nn import GeneratorConfig as JGConfig
from viai_tpu.nn import UNetGenerator as JUNet
from viai_tpu.nn import VideoFeatureNet as JVideo
from viai_tpu.nn import VideoNetConfig as JVConfig
from viai_tpu.signal import stft_magnitude as j_stft_magnitude
from viai_tpu.signal.mask import MaskConfig as JMaskConfig
from viai_tpu.signal.mask import sample_time_mask as j_sample_time_mask
from viai_tpu.signal.mel import compress as j_compress
from viai_tpu.testing import TINY_CFG, tone_batch
from viai_tpu.train import make_infer_fn as j_make_infer_fn
from viai_tpu.train.step import preprocess_with_mask as j_preprocess
from viai_tpu.utils.metrics import masked_psnr as j_masked_psnr
from viai_tpu_torch import _build
from viai_tpu_torch.cli.test import main as eval_main
from viai_tpu_torch.data.avi import write_avi
from viai_tpu_torch.io import (generator_state_from_flat, load_networks,
                               video_state_from_flat)
from viai_tpu_torch.nn import (GeneratorConfig, UNetGenerator,
                               VideoFeatureNet, VideoNetConfig, define_G)
from viai_tpu_torch.scripts import (bayes_ceiling, cost_analysis, grid_diag,
                                    prepare_dataset, quality_long,
                                    quality_report)
from viai_tpu_torch.scripts._quality import hole_psnr
from viai_tpu_torch.signal import MaskConfig, STFTConfig
from viai_tpu_torch.testing import tiny_models
from viai_tpu_torch.train import TrainConfig
from viai_tpu_torch.utils import compile_cache
from viai_tpu_torch.utils.cost import ByteCounterMode, conv_gflop, gl_ops

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_RECORDS = os.path.join(ROOT, "scripts", "quality_results.jsonl")
CLIP = 4032
PSNR_TOL = 1e-2          # dB, hole_psnr against JAX
CEILING_TOL = 1e-3       # dB, bayes_ceiling.run against JAX
G_SHAPE = dict(ngf=8, strides=((2, 2), (2, 2), (2, 1)), mults=(1, 2, 4))
V_SHAPE = dict(base=4, mults=(1, 2), strides=((1, 2, 2), (2, 2, 2)),
               out_features=16, out_time=16)
# The tiny shapes as flags: TrainOptions/TestOptions of both CLIs.
TINY_FLAGS = ["--ngf", "8", "--ndf", "8", "--n_fft", "126",
              "--hop_length", "64", "--image_frames", "64",
              "--clip_seconds", "0.252", "--min_gap_frames", "8",
              "--max_gap_frames", "16"]


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _records(results_dir) -> list[dict]:
    with open(os.path.join(results_dir, "quality_results.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture
def jax_records_untouched():
    """The JAX package's record is never written by the port."""
    before = os.path.getsize(JAX_RECORDS)
    yield
    assert os.path.getsize(JAX_RECORDS) == before


# ---- _quality.hole_psnr ------------------------------------------------

def _tiny_pair(use_video):
    """A JAX G (head bias -2, fusion 16 with video) and V, and the port's
    with the same weights."""
    fusion = 16 if use_video else 0
    JG = JUNet(JGConfig(**G_SHAPE), nnx.Rngs(0), fusion_channels=fusion)
    JG.head.bias[...] = jnp.full_like(JG.head.bias[...], -2.0)
    g_def, g_state = nnx.split(JG)
    PG = UNetGenerator(GeneratorConfig(**G_SHAPE),
                       fusion_channels=fusion).eval()
    PG.load_state_dict(generator_state_from_flat(
        flatten_state(g_state), GeneratorConfig(**G_SHAPE), fusion))
    if not use_video:
        return (g_def, g_state, None, nnx.State({})), (PG, None)
    v_def, v_state = nnx.split(JVideo(JVConfig(**V_SHAPE), nnx.Rngs(1)))
    PV = VideoFeatureNet(VideoNetConfig(**V_SHAPE)).eval()
    PV.load_state_dict(video_state_from_flat(flatten_state(v_state),
                                             VideoNetConfig(**V_SHAPE)))
    return (g_def, g_state, v_def, v_state), (PG, PV)


@pytest.mark.parametrize("use_video", [False, True], ids=["audio", "av"])
def test_hole_psnr_matches_jax(use_video):
    jcfg = dataclasses.replace(TINY_CFG, use_video=use_video)
    pcfg = TrainConfig(
        stft=STFTConfig(n_fft=126, hop_length=64),
        mask=MaskConfig(min_gap_frames=8, max_gap_frames=16),
        image_frames=64, n_bins=64, use_video=use_video)
    (g_def, g_state, v_def, v_state), (PG, PV) = _tiny_pair(use_video)
    rng = np.random.default_rng(3)
    wav = (tone_batch(3, CLIP, seed=3)
           + 0.01 * rng.standard_normal((3, CLIP))).astype(np.float32)
    tmask = np.ones((3, 64), np.float32)
    for b, (lo, n) in enumerate([(10, 12), (30, 16), (44, 8)]):
        tmask[b, lo:lo + n] = 0.0
    frames = (rng.uniform(0, 1, (3, 8, 16, 16, 3)).astype(np.float32)
              if use_video else None)

    pre = j_preprocess(wav, tmask, jcfg)
    out = j_make_infer_fn(g_def, v_def, jcfg, n_gl_iter=8,
                          external_mask=True)(g_state, v_state, wav, tmask,
                                              frames)
    img = j_compress(jnp.swapaxes(j_stft_magnitude(out, jcfg.stft),
                                  -1, -2))[..., None]
    n_fr = img.shape[2]
    ref = float(jnp.mean(j_masked_psnr(img, pre["real_img"][:, :, :n_fr],
                                       pre["mask_img"][:, :, :n_fr])))
    got = hole_psnr(PG, PV, pcfg, torch.from_numpy(wav),
                    torch.from_numpy(tmask),
                    None if frames is None else torch.from_numpy(frames))
    assert np.isfinite(ref)
    assert abs(got - ref) <= PSNR_TOL, (got, ref)


# ---- bayes_ceiling -----------------------------------------------------

@pytest.fixture(scope="module")
def j_bc():
    return _jax_script("bayes_ceiling")


def test_hidden_window_matches_jax(j_bc):
    rng = np.random.default_rng(0)
    for _ in range(6):
        tmask = np.ones(256, np.float32)
        a = int(rng.integers(1, 200))
        tmask[a:a + int(rng.integers(25, 51))] = 0.0
        assert bayes_ceiling.hidden_window(tmask, 128, 510, 16000) == \
            j_bc.hidden_window(tmask, 128, 510, 16000)


@pytest.mark.parametrize("tau", [1e-3, 0.15, 0.6])
def test_posterior_resample_matches_jax(j_bc, tau):
    """Identified (small tau), family and invisible notes (larger tau):
    the same draws from the same generator, bit for bit."""
    scfg = j_syn.SyntheticConfig(style="notes")
    regimes = np.zeros(3, int)
    for clip in range(6):
        params = j_syn._draw_notes(np.random.default_rng(clip), scfg)
        H_lo, H_hi = 0.2 + 0.2 * clip, 0.55 + 0.2 * clip
        ours = bayes_ceiling.posterior_resample(
            np.random.default_rng(100 + clip), params, H_lo, H_hi, tau, 1.7)
        ref = j_bc.posterior_resample(
            np.random.default_rng(100 + clip), params, H_lo, H_hi, tau, 1.7)
        assert ours[1:] == ref[1:]
        regimes += np.asarray(ref[1:])
        for a, b in zip(ours[0], ref[0]):
            np.testing.assert_array_equal(a, b)
    assert regimes.sum() > 0           # some note was hidden


@pytest.mark.parametrize("style", ["notes", "notes_grid"])
def test_bayes_ceiling_run_matches_jax(j_bc, style):
    seed, n_clips, n_var = 5, 2, 3
    kmask, tmasks = jax.random.key(seed), []
    for _ in range(n_clips):                 # the JAX run's gaps
        kmask, ki = jax.random.split(kmask)
        tmasks.append(np.array(j_sample_time_mask(ki, 256, JMaskConfig())))
    ref = j_bc.run(n_clips, n_var, seed, style=style)
    got = bayes_ceiling.run(n_clips, n_var, seed, style=style,
                            tmasks=tmasks, device="cpu")
    for k in ("ceiling_hole_psnr_mean", "sample_hole_psnr_mean"):
        assert abs(got[k] - ref[k]) <= CEILING_TOL, (k, got[k], ref[k])
    for k in ("identified_hidden_notes_per_clip",
              "family_hidden_notes_per_clip",
              "invisible_hidden_notes_per_clip", "dataset_mode"):
        assert got[k] == ref[k], k
    assert got["package"] == "viai_tpu_torch"


# ---- utils/cost.py and cost_analysis -----------------------------------

def test_conv_gflop_matches_flop_counter_and_hand_count():
    from torch.utils.flop_counter import FlopCounterMode

    G, _, _ = tiny_models(device="cpu")
    x = torch.zeros(2, 2, 64, 64)
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        G(x)
    assert conv_gflop(G, x) * 1e9 == fc.get_total_flops()
    # By hand: a 3x3 conv 2→4 on 8x8, a stride-2 4x4 transposed conv 4→3
    # from 8x8, a linear 16→5 on 3·16·16/16 rows.
    net = torch.nn.Sequential(
        torch.nn.Conv2d(2, 4, 3, padding=1),
        torch.nn.ConvTranspose2d(4, 3, 4, stride=2, padding=1),
        torch.nn.Linear(16, 5))
    hand = 2 * (8 * 8 * 4 * 2 * 9 + 8 * 8 * 4 * 3 * 16 + 3 * 16 * 5 * 16)
    assert conv_gflop(net, torch.zeros(1, 2, 8, 8)) * 1e9 == hand
    assert gl_ops(32, 251, 256, 510, 32) == 2 * 32 * 251 * 256 * 510 * 130


def test_byte_counter_counts_operands_not_views():
    a, b = torch.zeros(4, 8), torch.zeros(4, 8)
    with ByteCounterMode() as bc:
        c = a + b                     # 2 operands + 1 result
        c.t()                         # a view: nothing moves
        c.add_(1.0)                   # operand and result are one tensor
    assert bc.nbytes == 3 * 128 + 128


def test_cost_analysis_programs(jax_records_untouched, tmp_path):
    G, D, _ = tiny_models(device="cpu")
    progs = cost_analysis.run(G, D, TrainConfig(), 2, torch.device("cpu"))
    assert [p["program"].split(" (")[0] for p in progs] == [
        "G forward + preprocess", "full inference chain", "train step"]
    g_fwd = conv_gflop(G, torch.zeros(2, 2, 256, 256))
    assert progs[0]["gflops_by_module"]["UNetGenerator"] == round(g_fwd, 4)
    for p in progs:
        assert p["gflops"] > 0 and p["gbytes"] > 0 and "unfused" in p["note"]
        assert p["gl_launches"] == 0          # the CPU runs the plain GL
    # On the CPU the plain GL's products are dispatched and counted.
    assert progs[1]["gflops"] > progs[0]["gflops"] + gl_ops(
        2, 251, 256, 510, 32) / 1e9 - 0.01


# ---- prepare_dataset ---------------------------------------------------

@pytest.fixture(scope="module")
def j_pd():
    return _jax_script("prepare_dataset")


def _files(root) -> dict[str, bytes]:
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def test_prepare_synthetic_and_manifest_match_jax(j_pd, tmp_path,
                                                  jax_records_untouched):
    res = str(tmp_path / "res")
    prepare_dataset.main(["synthetic", "--out", str(tmp_path / "p"), "-n",
                          "3", "--video", "--results_dir", res])
    j_pd.cmd_synthetic(argparse.Namespace(out=str(tmp_path / "j"), n=3,
                                          video=True, n_frames=16,
                                          frame_size=64))
    ours, ref = _files(tmp_path / "p"), _files(tmp_path / "j")
    assert sorted(ours) == sorted(ref) and len(ours) == 6
    assert ours == ref
    prepare_dataset.main(["manifest", "--root", str(tmp_path / "p"),
                          "--results_dir", res])
    j_pd.cmd_manifest(argparse.Namespace(root=str(tmp_path / "j"), out=None,
                                         train_frac=0.9))
    with open(tmp_path / "p" / "MUSICES.json") as f, \
            open(tmp_path / "j" / "MUSICES.json") as g:
        assert json.load(f) == json.load(g)
    recs = _records(res)
    assert [r["mode"] for r in recs] == ["synthetic", "manifest"]
    assert all(r["package"] == "viai_tpu_torch" for r in recs)


def test_prepare_download_plan_matches_jax(j_pd, tmp_path, capsys):
    manifest = {"train": ["abc", {"id": "xyz", "start": 1.5, "end": 4}],
                "test": [{"ytid": "q1"}, {"name": "no id"}]}
    for fmt in ("mp4", "webm"):
        assert prepare_dataset.download_commands(manifest, "o", fmt) == \
            j_pd.download_commands(manifest, "o", fmt)
    path = tmp_path / "m.json"
    path.write_text(json.dumps(manifest))
    out = str(tmp_path / "dl")
    prepare_dataset.main(["download", "--manifest", str(path), "--out", out,
                          "--dry_run", "--results_dir", str(tmp_path)])
    ours = capsys.readouterr().out
    j_pd.cmd_download(argparse.Namespace(manifest=str(path), out=out,
                                         format="mp4", dry_run=True))
    assert ours == capsys.readouterr().out
    assert ours.endswith("# 4 commands (dry run)\n")


def _raw_avi(path, sr=22050, seed=0):
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, (10, 24, 32, 3), dtype=np.uint8)
    t = np.arange(sr) / sr
    audio = (0.3 * np.sin(2 * np.pi * 440 * t)
             + 0.01 * rng.standard_normal(sr)).astype(np.float32)
    write_avi(str(path), frames, 10, audio, sr)


def test_prepare_extract_matches_jax(j_pd, tmp_path, jax_records_untouched):
    (tmp_path / "raw").mkdir()
    _raw_avi(tmp_path / "raw" / "clip.avi")
    args = dict(root=str(tmp_path / "raw"), sample_rate=16000, n_frames=16,
                frame_size=64, require_audio=True)
    prepare_dataset.main(["extract", "--root", args["root"], "--out",
                          str(tmp_path / "p"), "--require_audio",
                          "--results_dir", str(tmp_path / "res")])
    j_pd.cmd_extract(argparse.Namespace(out=str(tmp_path / "j"), **args))
    ours, ref = _files(tmp_path / "p"), _files(tmp_path / "j")
    assert sorted(ours) == sorted(ref) == ["clip.npy", "clip.wav"]
    np.testing.assert_array_equal(np.load(tmp_path / "p" / "clip.npy"),
                                  np.load(tmp_path / "j" / "clip.npy"))
    assert ours["clip.wav"] == ref["clip.wav"]
    rec = _records(tmp_path / "res")[-1]
    assert (rec["clips"], rec["skipped"]) == (1, 0)


def test_prepare_skips_compressed_video(tmp_path, capsys):
    (tmp_path / "raw").mkdir()
    _raw_avi(tmp_path / "raw" / "a.avi")
    (tmp_path / "raw" / "b.mp4").write_bytes(b"\0" * 64)
    argv = ["extract", "--root", str(tmp_path / "raw"), "--out",
            str(tmp_path / "out"), "--results_dir", str(tmp_path)]
    rec = prepare_dataset.main(argv)
    assert (rec["clips"], rec["skipped"]) == (1, 1)
    assert "b.mp4: " in capsys.readouterr().out
    with pytest.raises(SystemExit) as e:
        prepare_dataset.main(argv + ["--require_audio"])
    assert e.value.code == 1
    rec = prepare_dataset.main(["frames", "--root", str(tmp_path / "raw"),
                                "--results_dir", str(tmp_path)])
    assert (rec["clips"], rec["skipped"]) == (1, 1)
    assert (tmp_path / "raw" / "a.npy").exists()


VIDEOS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_videos")


def test_prepare_reads_compressed_video_as_jax(j_pd, tmp_path,
                                               jax_records_untouched,
                                               capsys):
    """frames and extract over mp4v, MJPEG, .mov, VP8, VP9 and H.264
    clips beside a raw AVI give the JAX script's .npy stacks and wavs; an
    MP4 whose sample entry names AV1 (an mp4v clip relabelled av01) the
    JAX script reads with cv2 (libavformat takes the codec from its
    esds), the port lists it as skipped with the reason."""
    pytest.importorskip("cv2")
    raw = tmp_path / "raw"
    (raw / "sub").mkdir(parents=True)
    _raw_avi(raw / "a.avi")
    for src, dst in (("mpeg4_mp4.mp4", "b.mp4"), ("mjpeg_avi.avi", "c.avi"),
                     ("mpeg4_mkv.mkv", "sub/d.mkv"),
                     ("mjpeg_mov.mov", "e.mov"), ("vp9_webm.webm", "f.webm"),
                     ("vp8_webm.webm", "g.webm"),
                     ("h264_high_mp4.mp4", "i.mp4")):
        shutil.copy(os.path.join(VIDEOS, src), raw / dst)
    data = open(os.path.join(VIDEOS, "mpeg4_mp4.mp4"), "rb").read()
    (raw / "h.mp4").write_bytes(data.replace(b"mp4v", b"av01", 1))
    args = dict(root=str(raw), sample_rate=16000, n_frames=16,
                frame_size=64, require_audio=False)
    rec = prepare_dataset.main(["extract", "--root", str(raw), "--out",
                                str(tmp_path / "p"), "--results_dir",
                                str(tmp_path / "res")])
    out = capsys.readouterr().out
    j_pd.cmd_extract(argparse.Namespace(out=str(tmp_path / "j"), **args))
    capsys.readouterr()
    ours, ref = _files(tmp_path / "p"), _files(tmp_path / "j")
    assert sorted(ref) == ["a.npy", "a.wav", "b.npy", "c.npy", "d.npy",
                           "e.npy", "f.npy", "g.npy", "h.npy", "i.npy"]
    assert sorted(ours) == sorted(set(ref) - {"h.npy"})
    for name in ours:
        if name.endswith(".npy"):
            np.testing.assert_array_equal(np.load(tmp_path / "p" / name),
                                          np.load(tmp_path / "j" / name))
        else:
            assert ours[name] == ref[name]
    assert (rec["clips"], rec["frames_only"], rec["skipped"]) == (1, 7, 1)
    assert re.search(r"skipped .*h\.mp4: .*AV1, not read", out)
    # frames: .mp4/.avi/.mkv/.webm beside the videos, .mov left alone.
    jraw = tmp_path / "jraw"
    shutil.copytree(raw, jraw)
    rec = prepare_dataset.main(["frames", "--root", str(raw),
                                "--results_dir", str(tmp_path / "res")])
    assert "AV1, not read" in capsys.readouterr().out
    (jraw / "h.mp4").unlink()           # cv2 reads it; the port does not
    j_pd.cmd_frames(argparse.Namespace(root=str(jraw), n_frames=16,
                                       frame_size=64))
    ours = {k for k in _files(raw) if k.endswith(".npy")}
    assert ours == {k for k in _files(jraw) if k.endswith(".npy")} == {
        "a.npy", "b.npy", "c.npy", "sub/d.npy", "f.npy", "g.npy", "i.npy"}
    for name in ours:
        np.testing.assert_array_equal(np.load(raw / name),
                                      np.load(jraw / name))
    assert (rec["clips"], rec["skipped"]) == (7, 1)


# ---- quality_report, quality_long, grid_diag ---------------------------

def test_quality_report_run_writes_its_record(tmp_path,
                                              jax_records_untouched):
    G, D, _ = tiny_models(device="cpu")
    args = quality_report.parse_args([
        "--steps", "1", "--batch", "2", "--eval_batch", "2", "--device",
        "cpu", "--results_dir", str(tmp_path)])
    rec = quality_report.run(args, G, D, TrainConfig(), torch.device("cpu"))
    assert np.isfinite(rec["hole_psnr_before"])
    assert np.isfinite(rec["hole_psnr_after"])
    assert _records(tmp_path) == [rec]
    assert rec["package"] == "viai_tpu_torch" and rec["device"] == "cpu"


def test_quality_long_nets_load_in_cli_test(tmp_path, jax_records_untouched):
    ckpt, res = str(tmp_path / "ckpt"), str(tmp_path / "res")
    base = ["--name", "ql", "--checkpoints_dir", ckpt, "--device", "cpu",
            "--batch", "2", "--pool_batches", "1", "--results_dir", res,
            *TINY_FLAGS]
    rec = quality_long.main(base + ["--steps", "2", "--milestone", "1"])
    assert rec["package"] == "viai_tpu_torch" and rec["resume_step"] == 0
    expr = os.path.join(ckpt, "ql")
    for f in ("1_net_G.pth", "1_net_D.pth", "1_state.pt", "2_net_G.pth"):
        assert os.path.exists(os.path.join(expr, f)), f

    # A resume loads the step-1 state: the weights the .pth files hold.
    args, extra = quality_long.parse_args(base + ["--steps", "2"])
    model = quality_long.build_model(args, extra)
    model.load_networks("1")
    assert model.state["step"] == 1
    saved = define_G(ngf=8, dtype="bfloat16", device="cpu")
    load_networks({"G": saved}, "1", expr)
    for a, b in zip(model.G.state_dict().values(),
                    saved.state_dict().values()):
        assert torch.equal(a, b)
    rec = quality_long.main(base + ["--steps", "2", "--milestone", "1",
                                    "--resume_step", "1"])
    assert rec["resume_step"] == 1 and np.isfinite(rec["final_l1"])
    with pytest.raises(SystemExit) as e:
        quality_long.main(base + ["--steps", "2", "--resume_step", "2"])
    assert e.value.code == 0
    assert [r["exp"] for r in _records(res)] == ["quality_long"] * 2

    summary = eval_main([
        "--name", "ql", "--checkpoints_dir", ckpt, "--which_epoch", "2",
        "--gpu_ids", "-1", "--dataset_mode", "synthetic", "--how_many", "2",
        "--batchSize", "2", "--nThreads", "0", "--results_dir", res,
        *TINY_FLAGS])
    assert summary["n"] == 2 and np.isfinite(summary["hole_psnr_mean"])
    rec = grid_diag.main(["ql", ckpt, "2", "", "harmonic", "0", "--device",
                          "cpu", "--results_dir", res, *TINY_FLAGS])
    for k in ("pre_gl_hole_psnr_eval_unseen", "pre_gl_hole_psnr_train_pool"):
        assert np.isfinite(rec[k])


def test_grid_diag_masks_are_the_eval_clis():
    """grid_diag scores the gaps cli.test draws for its first batch."""
    from viai_tpu_torch.train.preprocess import preprocess

    cfg = TrainConfig(stft=STFTConfig(n_fft=126, hop_length=64),
                      mask=MaskConfig(8, 16), image_frames=64, n_bins=64)
    masks_gen = torch.Generator().manual_seed(4)
    batch_seed = int(torch.randint(0, 2**62, (1,), generator=masks_gen))
    pre = preprocess(torch.zeros(16, CLIP),
                     torch.Generator().manual_seed(batch_seed), cfg)
    torch.testing.assert_close(grid_diag.eval_masks(4, 16, cfg),
                               pre["mask_img"][:, 0, :, 0], rtol=0, atol=0)


# ---- compile_cache -----------------------------------------------------

def test_compile_cache_relocates_reuses_and_disables(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "_cache_dir", None)
    monkeypatch.delenv("VIAI_NO_CACHE", raising=False)
    monkeypatch.setenv("VIAI_CACHE_DIR", str(tmp_path / "env"))
    assert compile_cache.enable() == tmp_path / "env"
    assert compile_cache.enable(str(tmp_path / "arg")) == tmp_path / "arg"
    first = _build.build(["native"])["native"]
    assert first.path.parent == tmp_path / "arg" and first.seconds > 0.0
    again = _build.build(["native"])["native"]
    assert again.path == first.path and again.seconds == 0.0

    monkeypatch.setenv("VIAI_NO_CACHE", "1")
    fresh = compile_cache.enable(str(tmp_path / "arg"))
    assert fresh.parent == _build.BUILD_DIR and fresh.is_dir()
    rebuilt = _build.build(["native"])["native"]
    assert rebuilt.path.parent == fresh and rebuilt.seconds > 0.0
    assert compile_cache.enable() == fresh        # one per process

    monkeypatch.delenv("VIAI_NO_CACHE")
    monkeypatch.delenv("VIAI_CACHE_DIR")
    assert compile_cache.enable() == _build.BUILD_DIR
