"""Drive the PyTorch port (viai_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
  1. device: a CUDA card must be present; TF32 is switched off for
     matmuls and cuDNN convolutions, so every product is full float32;
  2. build: nvcc builds the Griffin-Lim kernel and g++ the native data
     loader from csrc/, in parallel;
  3. the kernel against its plain PyTorch version at the serving
     shapes of both buckets, B = 8 and 32 clips of 2 s (F = 251 frames
     × 256 bins, 32000 samples), which run different block tiles, and
     at the bench's batch, B = 128;
  4. the serving chain: InpaintService with the define_G() defaults
     (ngf 64, six levels) and GL×32, requests of 3, 8 and 21 clips and
     five streamed clips, with the kernel's launches counted; and the
     chain on the card against the chain on the CPU on a small input;
  5. the vision-infused chain (--model av) at full width, the README's
     recipe: define_G(fusion_channels=256, gated, bottleneck dilation
     1,2,4, dropout 0.5) and define_V(), (16, 64, 64, 3) frames a clip,
     GL×32, requests of 3, 8 and 21 clips, launches counted; and the
     card against the CPU on 2 clips;
  6. the other serving options of G and the chain at full width, one
     bucket-8 request each at GL×1 (bottleneck attention, the phase
     head, multi_res, an ensemble of two, the flax GroupNorm, bf16),
     launches counted, each held against the CPU chain;
  7. times, with CUDA events after warm-up: GL×32 at B = 8, 32 and 128
     through the wrapper, the kernel alone (the C entry point on
     buffers prepared once), the plain version, and both bounds (3xTF32
     on the tensor cores, the kernel's own; float32 SIMT, for history);
     the audio-only and the av chain per bucket, with G's and V's
     forward and the frames' copy to the card;
     and the device time of one bucket-32 request of each chain by
     kernel (torch.profiler);
  8. training through the port's CLI (viai_tpu_torch.cli.train.main)
     at full width, batch 16, 20 steps, visuals twice (GL×32 on the
     card, launches counted): [train] the audio-only model at the
     define_G() defaults with define_D(3, 64, 3) on `synthetic`;
     [train av] the README's av recipe (gated G, bottleneck dilation
     1,2,4, fusion 256, dropout 0.5, define_V()) on `synthetic_av`.
     Losses finite; on one fixed batch and mask loss_G_L1 falls over 8
     steps; the saved latest checkpoint is loaded with the port's
     load_networks and served through InpaintService on the GL kernel
     (bucket 8); under av, V's weights moved. [train reference]: one
     full-width SGD step on the card (cuDNN's deterministic algorithms)
     against the same step on the CPU (weights, batch, gap and dropout
     masks shared): the losses'
     relative difference and each tensor's max|Δ update| / max|update|.
     [times train]: steps/s and clips/s of both models (CUDA events
     after warm-up), the loader's share of the wall time, peak memory,
     FLOPs per step from the shapes and the rate they give, the time
     to write a checkpoint; [profile train]: one step by kernel;
  9. the diffusion refiner at full width (define_R(4, 64), its zero-init
     FiLM projections and head moved off zero): [refiner] serves 3, 8
     and 21 clips through InpaintService(define_G(), refiner=R) at 8
     DDIM steps from t 0.35 and GL×32, then one bucket-8 request each
     for refine_avg 8 in chunks of 3, refine_mix 0.7, clamp q with one
     resample round, guidance 1.5 and self-conditioning (R with 5
     inputs), all on the GL kernel, and one complex-domain request (R
     of complex_refiner_channels(2), t 1.0, complex_mag mean, refine_avg
     2) that must launch no GL; [refiner reference]: R's forward and
     both chains on the card against the CPU, same weights and injected
     noise, 2 clips (the magnitude chain at GL×1), each run again with
     TF32 on as the control that R's float32 bound must catch;
 10. evaluation through the port's CLI (viai_tpu_torch.cli.test.main)
     on the card, on the audio-only checkpoint [train] wrote, a second
     G (seed 1) and two Rs saved beside it: [eval] runs G alone, the
     README's best recipe (ensemble of 2, refine_avg 8, refine_mix 0.7,
     eval_samples 2) and the complex-domain refiner, 40 clips of
     synthetic_notes at batch 16 each, and checks n, the means and SEMs
     and the GL launches of each arm; [times refiner]: one bucket-32
     request at refine_avg 1 and 8 (CUDA events after warm-up), R's
     GFLOP a clip, the rate, peak memory and clips/s; [profile
     refiner]: one bucket-32 request by kernel;
 11. folder data on the card ([data]): a corpus written from the
     synthetic corpus (24 wav files of 3 s, PCM16, one at 22.05 kHz, one
     stereo; 12 npy frame stacks and one uncompressed AVI; a musices
     manifest with train and test splits); the native wav decoder,
     resampler and frame reader against the numpy ones; a batch in
     every mode (the native clip loader, the DataLoader in order and
     with 4 workers, both musices splits); [train]'s two models trained
     20 steps at batch 16 from the folder through the train CLI with
     prefetch (visuals on the GL kernel); the eval CLI on the musices
     test split; the loader's wait share of a step;
 12. refiner training: [train refiner] runs the refiner CLI at its
     defaults (batch 32, bf16 G and R) for 40 steps in each domain on
     [train]'s audio checkpoint, resumes the magnitude run from
     R20_state.pt and checks it equals the uninterrupted one (cuDNN's
     deterministic algorithms), and checks the loss falls over 8 steps
     on one fixed batch; [eval] scores the trained Rs (net_R, net_Rraw,
     the complex R); [train refiner reference]: one float32 SGD step of
     each domain at batch 4 on the card against the CPU (cond_drop 0.5,
     self-conditioning on its first-pass side), and again with TF32 on;
     [times train refiner]: steps/s, clips/s and TFLOP/s at batch 32,
     both domains, bf16 and float32, self-conditioning off and on, and
     one step by kernel;
 13. the bench entry point: [bench] runs viai_tpu_torch.bench.main once
     per preset at its defaults (bf16 G and R, GL×32, batch 128) but
     --inner 8 for default (one CUDA graph of 8 chained calls) and
     --inner 1 for the refiner presets, batch 32 for the complex ones,
     launches counted; [bench reference] holds each preset's bf16 chain
     on the card against its float32 chain on the CPU (same weights,
     clips, masks and injected noise, GL×1; bucket 8, the complex
     presets 2 clips); [profile bench] profiles one default call at
     batch 128 (busy share, kernel rows, elementwise share);
 14. the mesh: [mesh] starts a 1-rank NCCL group from a file store;
     make_mesh() is 1x1, a tiny SGD step through make_train_step(mesh=)
     and a bucket-8 InpaintService(mesh=) request at full width equal
     their runs without a mesh bit for bit (launches counted), and the
     group is torn down;
 15. the scripts ([scripts]): viai_tpu_torch.scripts.<name>.main at
     full width, steps cut (SCRIPT_CUTS, printed): quality_report (and
     --long_gap) and av_ablation, their hole-PSNRs finite and train
     clips/s printed with the card; quality_long 20 steps with
     milestones at 10 and 20, its step-10 state loaded again and held
     equal to the save bit for bit, a resume from it, its step-20 nets
     served by the eval CLI (16 clips) and diagnosed by grid_diag;
     bayes_ceiling; cost_analysis at batch 128, where G's forward must
     read 128 x 18.40 GFLOP; prepare_dataset's synthetic, extract (an
     AVI with PCM at 22.05 kHz; a .mp4 skipped), manifest and download
     --dry_run, and 5 av train steps from the folder it prepared. Every
     record carries "package"; the GL launches are counted;
 16. [tensorboard]: the train CLI with --tensorboard, 10 steps; the
     event file read back with the port's CRC-checking reader equals
     loss_log.jsonl;
 17. [compile cache]: with VIAI_CACHE_DIR set, the GL kernel builds
     there and loads again in 0.0 s; with VIAI_NO_CACHE=1 a fresh
     process builds it anew.
The last two lines are the card's name and power limit (as nvidia-smi
prints them) and the JSON result; the line before them lists the
kernels with their launches (summed over every path that ran them,
`launches_by_path`), errors and times.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from viai_tpu_torch import (InpaintService, TrainConfig, define_D, define_G,
                            define_R, define_V, load_networks, make_infer_fn,
                            save_networks)
from viai_tpu_torch import _build
from viai_tpu_torch.nn.refiner import FiLM
from viai_tpu_torch.signal import gl_cuda, griffin_lim, stft
from viai_tpu_torch.signal.gl_cuda import griffin_lim_cuda
from viai_tpu_torch.signal.mask import sample_batch_masks
from viai_tpu_torch.train.diffusion import (complex_refiner_channels,
                                            draw_noise,
                                            make_complex_refiner_infer_fn)
from viai_tpu_torch.utils.cost import conv_gflop, gl_bytes, gl_ops

SR, CLIP = 16000, 32000
GAP_S = (0.8, 1.2)
HOLE = (100, 131)            # hole frames of the kernel checks
# Published float32 (non-tensor-core) and dense TF32 tensor-core peaks
# and memory rate of an H100 SXM at its 700 W limit (NVIDIA data sheet).
PEAK_FP32 = 67e12
PEAK_TF32 = 495e12
PEAK_BYTES = 3.35e12
GL_BATCHES = (8, 32, 128)    # the service's default buckets
# The kernel against plain: the slice's buckets, one per block tile, and
# the bench's batch, each at the GL depths checked to atol = rtol = 1e-3.
# GL is chaotic: at B 128 the zero-init GL×4 case's tail over 128 clips
# puts even the plain version on the card and on the CPU (two float32
# orders) 3.4e-3 apart (PERF.md), so B 128 is checked to GL×2 and
# its GL×4 distances are printed beside that spread.
KERNEL_BATCHES = {8: (0, 1, 4), 32: (0, 1, 4), 128: (0, 1, 2)}
# The README's best single-G recipe under --model av (VIAIModel builds
# G with dropout 0.5 unless --no_dropout, fusion = --fusion_channels).
AV_G = dict(fusion_channels=256, gated=True, bottleneck_dilation=(1, 2, 4),
            dropout=0.5)
FRAMES = (16, 64, 64, 3)     # a clip's frames at define_V()'s shapes
# The serving options held card against CPU, one bucket-8 request each:
# (name, define_G arguments, TrainConfig fields, ensemble of two, bound of
# max|Δ|/max|ref|). float32 options: 1e-3, float32 summation order, as
# [reference]. bf16: the card's cuDNN and the CPU's oneDNN round every
# activation to bf16 at their own places, so the two chains are two bf16
# roundings of one function, amplified by the exponential decompress
# (measured 7.3e-3 on an H100; bound 2e-2).
BF16_BOUND = 2e-2
# [bench reference]: each preset's bf16 chain against float32 on the CPU,
# max|Δ| over the CPU output's peak. BF16_BOUND, but for the magnitude
# refiner chain: there the first proposal, 2e-2, failed at 3.507e-2, and
# the phase's split shows bf16 G alone (float32 R) reads 3.6e-2 and bf16
# R alone 3.2e-2 (PERF.md): R refines G's bf16 image in the hole, where
# the exponential decompress amplifies it. Bound 5e-2 there. The phase
# prints the float32 chain on the card beside each (the floor).
BENCH_REF_BOUNDS = {"default": BF16_BOUND, "refiner_mag": 5e-2,
                    "refiner_complex": BF16_BOUND, "hybrid": BF16_BOUND}
OPTIONS = (
    ("bottleneck_attn=2", dict(bottleneck_attn=2), {}, False, 1e-3),
    ("phase_head (init=)", dict(output_nc=3), dict(phase_head=True), False,
     1e-3),
    ("multi_res", dict(input_nc=3), dict(multi_res=True), False, 1e-3),
    ("ensemble of 2", {}, {}, True, 1e-3),
    ("norm=groupnorm_instance", dict(norm="groupnorm_instance"), {}, False,
     1e-3),
    ("dtype=bfloat16", dict(dtype="bfloat16"), {}, False, BF16_BOUND),
)

# Training at full width through the CLI: TrainOptions defaults except
# these flags. Visuals (GL×32 on the batch) every TRAIN_DISPLAY steps.
TRAIN_BATCH, TRAIN_STEPS, TRAIN_DISPLAY = 16, 20, 10
TRAIN_MODELS = {
    "audio": ["--dataset_mode", "synthetic"],
    "av": ["--dataset_mode", "synthetic_av", "--model", "av", "--gated",
           "--bottleneck_dilation", "1,2,4"],
}
TRAIN_REF_BATCH = 4           # the card-vs-CPU step (the CPU's time)
TRAIN_REF_LR = 0.01           # SGD, G and D
# [train reference] bounds of the card's step against the CPU's. Each
# tensor's max|Δ update| / max|update| (for tensors whose updates reach
# 1e-3 of their net's largest): 1e-2; the first proposal, 1e-3, failed
# at 3.4e-3 in G's shallow layers (PERF.md, Findings), and the phase prints
# beside it the CPU against itself on one thread and the card with
# cuDNN off. Every tensor's max|Δ| over its net's largest update: 1e-3
# (biases ahead of an instance norm have gradients of rounding size
# only, so only this bound means anything for them). Losses: 1e-5.
TRAIN_REF_BOUND, TRAIN_REF_NET_BOUND, TRAIN_REF_LOSS_BOUND = 1e-2, 1e-3, 1e-5
TRAIN_TIMED_STEPS = 10
OUT_DIR = pathlib.Path(__file__).resolve().parent / "chiprun_out"
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "build"

# The refiner's serving settings: 8 DDIM steps from t 0.35 (the JAX
# package's defaults). One bucket-8 request per option: (name, service
# arguments, R's input channels).
REFINE = dict(refine_steps=8, refine_t=0.35)
REFINER_OPTIONS = (
    ("refine_avg=8 chunk 3", dict(refine_avg=8, refine_chunk=3), 4),
    ("refine_mix=0.7", dict(refine_mix=0.7), 4),
    ("clamp q + resample 1", dict(refine_clamp="q", refine_resample=1), 4),
    ("guidance 1.5", dict(refine_guidance=1.5), 4),
    ("self_cond", dict(refine_selfcond=True), 5),
)
# [refiner reference]: the bound of R's forward and of the complex chain,
# card against CPU; float32 readings 1.3e-6 to 1.5e-6 (PERF.md, PR 5).
REFINER_REF_BOUND = 1e-4
COMPLEX = dict(refiner_domain="complex", refine_steps=8, refine_t=1.0,
               complex_mag="mean", refine_avg=2)
# [eval]: the CLI's arms on `synthetic_notes`, 40 clips at batch 16 (the
# last batch partial): G alone, the README's best recipe, the complex
# domain.
EVAL_BASE = ["--dataset_mode", "synthetic_notes", "--batchSize", "16",
             "--how_many", "40"]
EVAL_RUN2 = "chip_audio_seed1"
EVAL_ARMS = {
    "a": [],
    "b": ["--ensemble_names", EVAL_RUN2, "--refiner", "--rngf", "64",
          "--refine_steps", "8", "--refine_t", "0.35", "--refine_avg", "8",
          "--refine_chunk", "8", "--refine_mix", "0.7", "--eval_samples",
          "2"],
    "c": ["--refiner", "--refiner_domain", "complex", "--refiner_epoch",
          "cplx", "--refine_t", "1.0", "--complex_mag", "mean",
          "--refine_avg", "2"],
}

# [data]: a folder corpus written from the port's synthetic corpus (seed
# DATA_SEED): DATA_CLIPS wav files of DATA_SECONDS, the first DATA_AV of
# them in av/ with (16, 64, 64, 3) uint8 .npy frame stacks, one more in
# av/ with an uncompressed AVI, the rest in audio_only/ (one at 22.05
# kHz, one stereo); musices.json splits av/ into train and test.
DATA_CLIPS, DATA_AV, DATA_SECONDS, DATA_SEED = 24, 12, 3.0, 7
DATA_TRAIN = {
    "audio": ["--dataset_mode", "audio"],
    "av": ["--dataset_mode", "av", "--model", "av", "--gated",
           "--bottleneck_dilation", "1,2,4"],
}
# [train refiner]: the refiner CLI at its defaults (batch 32, bf16 G and
# R, lr 2e-4, EMA 0.999), 40 steps with milestones at 20 and 40, a pool
# of 8 batches; a resume from R20_state.pt to 40 repeats the run.
REFINER_STEPS, REFINER_MILESTONE = 40, 20
REFINER_TRAIN = ["--steps", str(REFINER_STEPS), "--milestone",
                 str(REFINER_MILESTONE), "--pool_batches", "8",
                 "--gpu_ids", "0"]
REFINER_BATCH = 32            # the refiner CLI's default
# [bench]: viai_tpu_torch.bench.main per preset, bf16 and GL×32 (its
# defaults) but for these flags.
BENCH_RUNS = (
    ("default", ["--inner", "8"]),
    ("refiner_mag", ["--inner", "1"]),
    ("refiner_complex", ["--batch", "32", "--inner", "1"]),
    ("hybrid", ["--batch", "32", "--inner", "1"]),
)
# [scripts]: the ported scripts (viai_tpu_torch/scripts/) at their
# full-width defaults, steps cut to fit the run (each cut printed).
SCRIPT_CUTS = {
    "quality_report": ["--steps", "10"],             # default 300
    "quality_report long_gap": ["--long_gap", "--steps", "5"],
    "av_ablation": ["--steps", "5"],                 # default 600
    "quality_long": ["--steps", "20", "--milestone", "10",
                     "--pool_batches", "2"],         # 15000, 5000, 64
    "bayes_ceiling": ["--clips", "8", "--variants", "8"],   # 64, 48
}
SCRIPTS_EVAL_CLIPS = 16
# [scripts] cost_analysis: define_G()'s conv FLOPs a clip (PERF.md §4).
G_GFLOP_CLIP = 18.40
TB_STEPS = 10                 # [tensorboard]: train CLI steps, one record each
# [eval] on the Rs that [train refiner] wrote: (arm, run suffix, flags).
EVAL_TRAINED_ARMS = (
    ("R", "", ["--refiner", "--refiner_net", "R"]),
    ("Rraw", "", ["--refiner", "--refiner_net", "Rraw"]),
    ("complex", "_cplx", ["--refiner", "--refiner_domain", "complex",
                          "--refine_t", "1.0"]),
)


def log(msg: str):
    print(msg, flush=True)


def require(cond: bool, msg: str):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def tones(batch: int, seed: int, device) -> torch.Tensor:
    """Tone mixtures plus noise: (batch, CLIP) float32."""
    g = torch.Generator().manual_seed(seed)
    t = torch.arange(CLIP, dtype=torch.float64) / SR
    f = 100 + 1900 * torch.rand(batch, 4, 1, generator=g, dtype=torch.float64)
    ph = 2 * np.pi * torch.rand(batch, 4, 1, generator=g, dtype=torch.float64)
    x = 0.2 * torch.sin(2 * np.pi * f * t + ph).sum(1)
    x = x + 0.01 * torch.randn(batch, CLIP, generator=g, dtype=torch.float64)
    return x.float().to(device)


def observed_slices(hole, hop, n_fft, n):
    """Sample ranges influenced only by observed frames."""
    pad = n_fft // 2
    first = hole[0] * hop - pad
    last = (hole[1] - 1) * hop - pad + n_fft
    return [slice(0, max(first - n_fft, 0)), slice(min(last + n_fft, n), n)]


def rel_err(a: torch.Tensor, b: torch.Tensor, slices) -> float:
    num = sum(float(torch.linalg.norm(a[:, s] - b[:, s])) ** 2 for s in slices)
    den = sum(float(torch.linalg.norm(b[:, s])) ** 2 for s in slices)
    return (num / den) ** 0.5


def video_frames(batch: int, seed: int) -> np.ndarray:
    """(batch, 16, 64, 64, 3) float32 frames in [0, 1) from a seed."""
    return np.random.default_rng(seed).uniform(
        0, 1, (batch, *FRAMES)).astype(np.float32)


def unit_phasors(mag: torch.Tensor, seed: int):
    """Random unit phasors from a seed, as the phase head's init=."""
    g = torch.Generator().manual_seed(seed)
    ang = 2 * np.pi * torch.rand(mag.shape, generator=g)
    return torch.cos(ang).to(mag.device), torch.sin(ang).to(mag.device)


def card_copy(module: torch.nn.Module, dev) -> torch.nn.Module:
    """The same weights on the card (a model built once on the CPU)."""
    return copy.deepcopy(module).to(dev).eval()


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def gl_inputs(batch: int, dev, seed: int = 0):
    """(mag, observed) of `batch` clips with frames HOLE[0]..HOLE[1]-1
    marked as hole: the GL inputs of the serving path."""
    cfg = TrainConfig().stft
    x = tones(batch, seed, dev)
    re, im = stft(x, cfg)
    mag = torch.sqrt(re * re + im * im + 1e-9)
    fmask = torch.ones(batch, re.shape[1], 1, device=dev)
    fmask[:, HOLE[0]:HOLE[1]] = 0.0
    return cfg, x, mag, (fmask, re, im)


def gl_bound_ms(batch: int, n_frames: int, n_bins: int, n_fft: int,
                n_iter: int, T: int) -> dict:
    """Least times for GL×n_iter, in ms: by float32 operations outside
    the tensor cores (`ops`), by the same operations as 3xTF32 on the
    tensor cores (`ops_tc`: three TF32 products per product), by bytes.

    The counts are utils/cost.py's gl_ops and gl_bytes."""
    flop = gl_ops(batch, n_frames, n_bins, n_fft, n_iter)
    nbytes = gl_bytes(batch, n_frames, n_bins, T)
    return {"ops": flop / PEAK_FP32 * 1e3,
            "ops_tc": 3 * flop / PEAK_TF32 * 1e3,
            "bytes": nbytes / PEAK_BYTES * 1e3}


def phase_device() -> str:
    require(torch.cuda.is_available(), "no CUDA device is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"[device] {torch.cuda.get_device_name(0)} | {card} | "
        f"count {torch.cuda.device_count()} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | tf32 off")
    return card


def phase_build():
    t0 = time.perf_counter()
    res = _build.build()
    wall = time.perf_counter() - t0
    for r in res.values():
        log(f"[build] {r.name}: compiled in {r.seconds:.2f} s (wall "
            f"{wall:.2f} s, every target in parallel) -> {r.path.name}")
        for line in r.log.splitlines():
            if "Used" in line or "spill" in line or "Compiling entry" in line:
                log(f"[build]   {line.strip()}")


def phase_kernel(dev) -> float:
    """Kernel vs plain at the serving shapes of the slice's buckets,
    B = 8 and 32, which the kernel runs with different block tiles, and
    of the bench's batch, B = 128 (KERNEL_BATCHES gives the depths);
    returns the max abs error over those cases."""
    worst = 0.0
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tiles = set()
    for batch, depths in KERNEL_BATCHES.items():
        cfg, x, mag, obs = gl_inputs(batch, dev)
        n = x.shape[-1]
        tile = gl_cuda.pick_tile(batch * mag.shape[1],
                                 gl_cuda.padded_width(cfg.n_fft), sms)
        tiles.add(tile)
        tag = f"B={batch} (tile {gl_cuda.BLOCK_ROWS}x{tile})"
        cases = [("zero", {}), ("observed", {"observed": obs}),
                 ("observed+extrapolate",
                  {"observed": obs, "phase_init": "extrapolate"}),
                 ("observed+init",
                  {"observed": obs, "init": unit_phasors(mag, batch)})]
        for n_iter in depths:
            for name, kw in cases:
                out = griffin_lim_cuda(mag, cfg, n_iter=n_iter, length=n, **kw)
                ref = griffin_lim(mag, cfg, n_iter=n_iter, length=n, **kw)
                torch.cuda.synchronize()
                err = float((out - ref).abs().max())
                ok = bool(torch.allclose(out, ref, atol=1e-3, rtol=1e-3))
                log(f"[kernel] {tag} GL×{n_iter} {name}: max|Δ| {err:.3e} "
                    f"(bound atol=rtol=1e-3) {'ok' if ok else 'FAIL'}")
                require(ok, f"kernel disagrees with plain at B={batch} "
                        f"n_iter={n_iter} {name}")
                worst = max(worst, err)
        if 4 not in depths:
            for name, kw in cases[:2]:
                out = griffin_lim_cuda(mag, cfg, n_iter=4, length=n, **kw)
                ref = griffin_lim(mag, cfg, n_iter=4, length=n, **kw)
                cpu = griffin_lim(mag.cpu(), cfg, n_iter=4, length=n, **{
                    k: tuple(t.cpu() for t in v) for k, v in kw.items()})
                log(f"[kernel] {tag} GL×4 {name} (not bounded): max|Δ| "
                    f"kernel vs plain {float((out - ref).abs().max()):.3e}; "
                    f"plain on the card vs on the CPU "
                    f"{float((ref.cpu() - cpu).abs().max()):.3e}")
        kw = {"observed": obs, "phase_init": "extrapolate"}
        out = griffin_lim_cuda(mag, cfg, n_iter=32, length=n, **kw)
        ref = griffin_lim(mag, cfg, n_iter=32, length=n, **kw)
        sl = observed_slices(HOLE, cfg.hop_length, cfg.n_fft, n)
        e_obs = rel_err(out, ref, sl)
        hole = slice(sl[0].stop, sl[1].start)
        e_hole = rel_err(out, ref, [hole])
        log(f"[kernel] {tag} GL×32 observed+extrapolate: observed-region "
            f"rel err {e_obs:.3e} (bound 1e-3); hole rel err {e_hole:.3e} "
            f"(GL is chaotic in the hole; not bounded)")
        require(e_obs < 1e-3,
                f"kernel disagrees with plain at B={batch} GL×32 (observed)")
    require(tiles == set(gl_cuda.TILES),
            f"the checked batches ran tiles {sorted(tiles)}, not every one "
            f"of {gl_cuda.TILES}")
    return worst


def check_served(tag: str, svc: InpaintService, outs: dict):
    """Shapes, finite values and the observed region of served clips."""
    cfg = svc.cfg
    m = svc.time_mask_from_seconds(1, *GAP_S)[0]
    hole = np.nonzero(m == 0)[0]
    sl = observed_slices((hole[0], hole[-1] + 1), cfg.stft.hop_length,
                         cfg.stft.n_fft, CLIP)
    for n_req, (x, y) in outs.items():
        require(y.shape == x.shape == (n_req, CLIP), f"bad shape {y.shape}")
        require(bool(np.isfinite(y).all()), "non-finite output")
        err = rel_err(torch.from_numpy(y), torch.from_numpy(x), sl)
        log(f"[{tag}] {n_req} clips -> {y.shape}, finite, observed-region "
            f"rel err vs input {err:.3e} (bound 1e-2)")
        require(err < 1e-2, "observed region not reconstructed")


def read_launches(tag: str, svc: InpaintService, wall: float) -> int:
    """The GL kernel's launches since the counts were zeroed; fails if
    the path never launched it or ran the plain version."""
    launches, plain_calls = griffin_lim_cuda.launches, griffin_lim.calls
    log(f"[{tag}] {svc.stats.batches} batches, {svc.stats.padded_clips} "
        f"padded clips, {wall:.2f} s incl. first-call set-up; "
        f"griffin_lim_cuda launches {launches}, plain griffin_lim calls "
        f"{plain_calls}")
    require(launches > 0, f"[{tag}] never launched the GL kernel")
    require(plain_calls == 0, f"[{tag}] ran the plain griffin_lim")
    return launches


def zero_counts():
    griffin_lim_cuda.launches = 0
    griffin_lim.calls = 0


def phase_slice(dev) -> tuple[InpaintService, int]:
    """The serving chain at full width; returns the service and the
    kernel's launches during the main-path run."""
    cfg = TrainConfig()
    svc = InpaintService(define_G(), cfg, buckets=(8, 32), gl_iters=32)
    zero_counts()
    outs = {}
    t0 = time.perf_counter()
    for n_req in (3, 8, 21):
        wavs = tones(n_req, seed=n_req, device="cpu").numpy()
        outs[n_req] = (wavs, svc.inpaint(wavs, gap_start_s=GAP_S[0],
                                         gap_end_s=GAP_S[1]))
    wavs = tones(5, seed=5, device="cpu").numpy()
    mask = svc.time_mask_from_seconds(1, *GAP_S)[0]
    futs = [svc.submit(w, mask) for w in wavs]
    flushed = svc.flush()
    launches = read_launches("slice", svc, time.perf_counter() - t0)
    outs[5] = (wavs, np.stack([f.result(timeout=60) for f in futs]))
    require(len(flushed) == 5, "flush returned the wrong number of clips")
    check_served("slice", svc, outs)
    return svc, launches


def chain_error(tag: str, cfg: TrainConfig, gens, V, dev, wavs, masks,
                frames=None, y_card=None, bound: float = 1e-3) -> float:
    """The chain on the card against the chain on the CPU (plain GL),
    same weights (`gens`, `V` on the CPU) and clips, GL×1: max|Δ| over
    the CPU output's peak. y_card, when given, is the card's output for
    these clips from a served request; else the card runs make_infer_fn
    on copies of the CPU's networks."""
    x, m = torch.from_numpy(wavs), torch.from_numpy(masks)
    fr = None if frames is None else torch.from_numpy(frames)
    ref = make_infer_fn(gens, cfg, n_gl_iter=1, V=V)(x, m, fr)
    if y_card is None:
        cg = [card_copy(g, dev) for g in gens]
        cv = card_copy(V, dev) if V is not None else None
        y_card = make_infer_fn(cg, cfg, n_gl_iter=1, V=cv)(
            x.to(dev), m.to(dev), None if fr is None else fr.to(dev)).cpu()
    err = float((y_card - ref).abs().max()) / float(ref.abs().max())
    log(f"[{tag}] chain on {dev} vs CPU, {len(wavs)} clips GL×1: "
        f"max|Δ|/max|ref| {err:.3e} (bound {bound:g})")
    require(err < bound, f"[{tag}] the chain on the card disagrees with the "
            f"CPU")
    return err


def phase_reference(svc: InpaintService, dev):
    """The audio-only chain on the card against the CPU, 2 clips."""
    chain_error("reference", svc.cfg, [define_G(device="cpu")], None, dev,
                tones(2, seed=7, device="cpu").numpy(),
                svc.time_mask_from_seconds(2, *GAP_S))


def phase_av(dev) -> tuple[InpaintService, int]:
    """The vision-infused chain at full width (AV_G, define_V(),
    GL×32), requests of 3, 8 and 21 clips with frames; returns the
    service and the kernel's launches; then card against CPU."""
    cfg = TrainConfig(use_video=True)
    Gc, Vc = define_G(**AV_G, device="cpu"), define_V(device="cpu")
    svc = InpaintService(card_copy(Gc, dev), cfg, V=card_copy(Vc, dev),
                         buckets=(8, 32), gl_iters=32)
    zero_counts()
    outs = {}
    t0 = time.perf_counter()
    for n_req in (3, 8, 21):
        wavs = tones(n_req, seed=50 + n_req, device="cpu").numpy()
        outs[n_req] = (wavs, svc.inpaint(
            wavs, gap_start_s=GAP_S[0], gap_end_s=GAP_S[1],
            frames=video_frames(n_req, seed=n_req)))
    launches = read_launches("av", svc, time.perf_counter() - t0)
    check_served("av", svc, outs)
    chain_error("av", cfg, [Gc], Vc, dev, tones(2, seed=7, device="cpu").numpy(),
                svc.time_mask_from_seconds(2, *GAP_S),
                frames=video_frames(2, seed=7))
    return svc, launches


def phase_options(dev) -> int:
    """One bucket-8 request at GL×1 per serving option of OPTIONS, at
    full width; its first 2 clips held against the CPU chain on them.
    Returns the kernel's launches over the options' requests."""
    total = 0
    for name, gkw, ckw, ensemble, bound in OPTIONS:
        cfg = TrainConfig(**ckw)
        gens = [define_G(**gkw, seed=s, device="cpu")
                for s in ((0, 1) if ensemble else (0,))]
        svc = InpaintService(card_copy(gens[0], dev), cfg, buckets=(8,),
                             gl_iters=1,
                             ensemble_states=[card_copy(g, dev)
                                              for g in gens[1:]])
        wavs = tones(8, seed=7, device="cpu").numpy()
        masks = svc.time_mask_from_seconds(8, *GAP_S)
        zero_counts()
        t0 = time.perf_counter()
        y = svc.inpaint(wavs, masks=masks)
        tag = f"options] [{name}"
        total += read_launches(tag, svc, time.perf_counter() - t0)
        require(y.shape == wavs.shape and bool(np.isfinite(y).all()),
                f"[options] {name}: bad output")
        chain_error(tag, cfg, gens, None, dev, wavs[:2], masks[:2],
                    y_card=torch.from_numpy(y[:2]), bound=bound)
    return total


def phase_times(svc: InpaintService, dev, card: str) -> dict:
    tag = f"({torch.cuda.get_device_name(0)}, {card.split(',')[-1].strip()})"
    res = {}
    n_iter = 32
    for batch in GL_BATCHES:
        cfg, x, mag, obs = gl_inputs(batch, dev, seed=batch)
        n = x.shape[-1]
        kw = {"observed": obs, "phase_init": "extrapolate"}
        k_ms = time_ms(lambda: griffin_lim_cuda(mag, cfg, n_iter, n, **kw), 5)
        p_ms = time_ms(lambda: griffin_lim(mag, cfg, n_iter, n, **kw), 5)
        k0_ms = time_ms(lambda: griffin_lim_cuda(mag, cfg, n_iter, n), 5)
        # The kernel alone: the C entry point on buffers prepared once
        # (it updates A and prev in place; the time does not depend on it).
        buf = gl_cuda.prepare_buffers(mag, cfg, obs, "extrapolate")
        ko_ms = time_ms(lambda: gl_cuda.launch(buf, n_iter), 10)
        b = gl_bound_ms(batch, mag.shape[1], mag.shape[2], cfg.n_fft, n_iter,
                        n)
        M, W = batch * mag.shape[1], gl_cuda.padded_width(cfg.n_fft)
        tile = gl_cuda.pick_tile(M, W, torch.cuda.get_device_properties(
            dev).multi_processor_count)
        # The kernel computes in 3xTF32 on the tensor cores, so its bound
        # is that type's peak; the float32 SIMT bound is kept for history.
        bound = max(b["ops_tc"], b["bytes"])
        res[batch] = dict(kernel_ms=k_ms, kernel_only_ms=ko_ms, plain_ms=p_ms,
                          bound_ms=bound, bound_tc_ms=bound,
                          bound_simt_ms=max(b["ops"], b["bytes"]),
                          bound_by="operations" if b["ops_tc"] >= b["bytes"]
                          else "bytes")
        log(f"[times] GL×{n_iter} B={batch}: wrapper {k_ms:.3f} ms (zero "
            f"init, no observed: {k0_ms:.3f} ms), kernel alone {ko_ms:.3f} ms"
            f" ({3 * n_iter + 2} launches, tile {gl_cuda.BLOCK_ROWS}x{tile}),"
            f" plain {p_ms:.3f} ms {tag}")
        log(f"[times]   bounds: 3xTF32 tensor cores {b['ops_tc']:.3f} ms "
            f"(kernel alone at {b['ops_tc'] / ko_ms:.1%}, wrapper at "
            f"{b['ops_tc'] / k_ms:.1%}); float32 SIMT {b['ops']:.3f} ms "
            f"(kernel alone at {b['ops'] / ko_ms:.1%}); bytes "
            f"{b['bytes']:.3f} ms; kernel alone "
            f"{'faster' if ko_ms < p_ms else 'NOT faster'} than plain "
            f"({p_ms / ko_ms:.2f}x)")
        # Diagnostic only (the port never calls it): cuBLAS on the
        # kernel's product shape, float32 with TF32 off, times the
        # products of one call (two per iteration and the final one).
        a = torch.randn(M, W, device=dev)
        w = torch.randn(W, W, device=dev)
        mm_ms = time_ms(lambda: torch.matmul(a, w), 10)
        n_mm = 2 * n_iter + 1
        log(f"[times]   cuBLAS float32 ({M}, {W}) @ ({W}, {W}): {mm_ms:.4f} "
            f"ms x {n_mm} products = {mm_ms * n_mm:.3f} ms (diagnostic)")
        del buf, a, w
    G = svc.G
    for batch in svc.buckets:
        wavs = tones(batch, seed=100 + batch, device="cpu").numpy()
        svc.inpaint(wavs, gap_start_s=GAP_S[0], gap_end_s=GAP_S[1])
        reps = 3
        t0 = time.perf_counter()
        for _ in range(reps):
            svc.inpaint(wavs, gap_start_s=GAP_S[0], gap_end_s=GAP_S[1])
        dt = (time.perf_counter() - t0) / reps
        g_in = torch.zeros(batch, 2, 256, 256, device=dev)
        with torch.inference_mode():
            g_ms = time_ms(lambda: G(g_in), 3)
        log(f"[times] chain bucket {batch}: {batch / dt:.1f} clips/s "
            f"({dt * 1e3:.1f} ms per request, host clock incl. copies); "
            f"G forward {g_ms:.2f} ms {tag}")
        res[f"chain_{batch}"] = batch / dt
    return res


def phase_times_av(svc: InpaintService, dev, card: str) -> dict:
    """The av chain per bucket (host clock around a full request after
    warm-up), G's and V's forward (CUDA events), the frames' copy to
    the card (host clock to a synchronize), and the FLOPs of G and V
    per clip counted from the shapes."""
    tag = f"({torch.cuda.get_device_name(0)}, {card.split(',')[-1].strip()})"
    G, V, res = svc.G, svc.V, {}
    g_gf = conv_gflop(G, torch.zeros(1, 2, 256, 256, device=dev),
                      torch.zeros(1, 16, 256, device=dev))
    v_gf = conv_gflop(V, torch.zeros(1, *FRAMES, device=dev))
    log(f"[times] av: G {g_gf:.2f} GFLOP a clip, V {v_gf:.3f} GFLOP a clip "
        f"(conv and linear layers, counted from the shapes)")
    for batch in svc.buckets:
        wavs = tones(batch, seed=200 + batch, device="cpu").numpy()
        fr = video_frames(batch, seed=200 + batch)
        kw = dict(gap_start_s=GAP_S[0], gap_end_s=GAP_S[1], frames=fr)
        svc.inpaint(wavs, **kw)
        reps = 3
        t0 = time.perf_counter()
        for _ in range(reps):
            svc.inpaint(wavs, **kw)
        dt = (time.perf_counter() - t0) / reps
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fr_dev = torch.from_numpy(fr).to(dev)
            torch.cuda.synchronize()
        copy_ms = (time.perf_counter() - t0) / reps * 1e3
        g_in = torch.zeros(batch, 2, 256, 256, device=dev)
        with torch.inference_mode():
            feats = V(fr_dev)
            g_ms = time_ms(lambda: G(g_in, feats), 3)
            v_ms = time_ms(lambda: V(fr_dev), 3)
        log(f"[times] av chain bucket {batch}: {batch / dt:.1f} clips/s "
            f"({dt * 1e3:.1f} ms per request, host clock incl. copies); "
            f"G forward {g_ms:.2f} ms, V forward {v_ms:.2f} ms, frames "
            f"{fr.nbytes / 1e6:.1f} MB host->card {copy_ms:.2f} ms {tag}")
        res[batch] = dict(clips_per_s=batch / dt, ms=dt * 1e3, g_ms=g_ms,
                          v_ms=v_ms, copy_ms=copy_ms)
    return res


def phase_profile(svc: InpaintService, card: str, name: str = "profile"):
    """Device time by kernel for one bucket-32 request (torch.profiler),
    and the device's busy share of the request's wall time."""
    from torch.profiler import ProfilerActivity, profile

    batch = svc.buckets[-1]
    wavs = tones(batch, seed=300, device="cpu").numpy()
    kw = dict(gap_start_s=GAP_S[0], gap_end_s=GAP_S[1])
    if svc.V is not None:
        kw["frames"] = video_frames(batch, seed=300)
    svc.inpaint(wavs, **kw)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        svc.inpaint(wavs, **kw)
        wall_ms = (time.perf_counter() - t0) * 1e3
    # Kernel rows only: an operator's row repeats its kernels' time.
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    total_us = sum(e.self_device_time_total for e in rows)
    tag = f"({torch.cuda.get_device_name(0)}, {card.split(',')[-1].strip()})"
    if not rows:
        log(f"[{name}] no device time in the trace: not measured")
        return
    log(f"[{name}] bucket {batch} request: device busy {total_us / 1e3:.2f} "
        f"ms of {wall_ms:.2f} ms wall ({total_us / 1e3 / wall_ms:.1%}; "
        f"profiler on) {tag}")
    rows.sort(key=lambda e: -e.self_device_time_total)
    for e in rows[:12]:
        log(f"[{name}]   {e.self_device_time_total / 1e3:8.3f} ms "
            f"{e.self_device_time_total / total_us:6.1%} x{e.count:<4d} "
            f"{e.key[:90]}")


def train_args(kind: str, ckpt: str, name: str) -> list[str]:
    return ["--name", name, "--checkpoints_dir", ckpt, "--gpu_ids", "0",
            "--batchSize", str(TRAIN_BATCH), "--niter", "1",
            "--niter_decay", "0", "--steps_per_epoch", str(TRAIN_STEPS),
            "--save_epoch_freq", "1", "--display_freq", str(TRAIN_DISPLAY),
            "--print_freq", str(TRAIN_DISPLAY), *TRAIN_MODELS[kind]]


def fixed_batch(opt) -> dict:
    """The first batch of the dataset in order (no shuffling)."""
    from viai_tpu_torch.data import create_dataloader

    return next(iter(create_dataloader(
        opt.dataset_mode, None, opt.batchSize,
        int(opt.sample_rate * opt.clip_seconds), opt.sample_rate,
        opt.nThreads, opt.n_video_frames, opt.frame_size, seed=opt.seed,
        shuffle=False, num_epochs=1)))


def phase_train(dev, kind: str, ckpt: str) -> dict:
    """Train one model at full width through the port's CLI into `ckpt`
    (run chip_{kind}), check it, and serve its saved checkpoint on the GL
    kernel."""
    from viai_tpu_torch.cli.train import main as train_main
    from viai_tpu_torch.model import VIAIModel

    tag = "train" if kind == "audio" else "train av"
    av = kind == "av"
    res = {}
    name = f"chip_{kind}"
    args = train_args(kind, ckpt, name)
    zero_counts()
    t0 = time.perf_counter()
    model = train_main(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = griffin_lim_cuda.launches, griffin_lim.calls
    displays = TRAIN_STEPS // TRAIN_DISPLAY
    log(f"[{tag}] {TRAIN_STEPS} steps at batch {TRAIN_BATCH} through "
        f"viai_tpu_torch.cli.train in {wall:.1f} s (incl. building, 3 "
        f"checkpoint writes, {displays} visuals); griffin_lim_cuda "
        f"launches {launches}, plain griffin_lim calls {plain}")
    require(launches == displays, f"[{tag}] expected {displays} GL "
            f"launches from the visuals, got {launches}")
    require(plain == 0, f"[{tag}] ran the plain griffin_lim")
    res["launches"] = launches
    expr = os.path.join(ckpt, name)
    with open(os.path.join(expr, "loss_log.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    require(len(recs) == displays, f"[{tag}] {len(recs)} loss records")
    losses = model.get_current_losses()
    require(all(np.isfinite(v) for r in recs for k, v in r.items()
                if k.startswith("loss")) and
            all(np.isfinite(v) for v in losses.values()),
            f"[{tag}] non-finite loss")
    log(f"[{tag}] losses at step {TRAIN_STEPS}: " + " ".join(
        f"{k} {v:.4f}" for k, v in losses.items()) + " (finite)")
    require(os.path.exists(os.path.join(
        expr, "web", "images", "epoch001_inpainted.png")),
        f"[{tag}] no visuals written")
    v_kw = dict(out_features=model.opt.fusion_channels,
                out_time=model.opt.image_frames // 16)
    if av:
        V0 = define_V(**v_kw, seed=model.opt.seed + 2, device=dev)
        moved = max(float((a - b).abs().max()) for a, b in
                    zip(model.V.state_dict().values(),
                        V0.state_dict().values()))
        log(f"[{tag}] V moved: max|ΔV| {moved:.3e} after {TRAIN_STEPS} "
            f"steps")
        require(moved > 0, "[train av] V's weights did not move")
        del V0
    del model
    # One fixed batch and mask: loss_G_L1 falls over 8 steps.
    opt = parse_quietly(args)
    m = VIAIModel(opt)
    batch = fixed_batch(opt)
    dev_batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    tmask = sample_batch_masks(m.generator, TRAIN_BATCH,
                               m.cfg.image_frames, m.cfg.mask)
    l1 = []
    for _ in range(8):
        met = m.train_step(m.state, dev_batch["wav"],
                           dev_batch.get("frames"), m.generator,
                           dev_batch.get("frames_valid"), tmask=tmask)
        l1.append(float(met["loss_G_L1"]))
    log(f"[{tag}] fixed batch: loss_G_L1 step 1 {l1[0]:.4f} -> step 8 "
        f"{l1[-1]:.4f}")
    require(l1[-1] < l1[0], f"[{tag}] loss_G_L1 did not fall")
    del m
    # Serve the saved checkpoint.
    # Fresh nets of the trained architecture, other seeds: the
    # served weights can come only from the files.
    G = define_G(**(AV_G if av else {}), seed=123)
    nets = {"G": G}
    if av:
        nets["V"] = define_V(**v_kw, seed=124)
    load_networks(nets, "latest", expr)
    svc = InpaintService(G, TrainConfig(use_video=av), V=nets.get("V"),
                         buckets=(8,), gl_iters=32)
    wavs = tones(8, seed=400, device="cpu").numpy()
    kw = dict(gap_start_s=GAP_S[0], gap_end_s=GAP_S[1])
    if av:
        kw["frames"] = video_frames(8, seed=400)
    zero_counts()
    t0 = time.perf_counter()
    y = svc.inpaint(wavs, **kw)
    res["served"] = read_launches(tag, svc, time.perf_counter() - t0)
    check_served(tag, svc, {8: (wavs, y)})
    return res


def _update_errors(ref: dict, other: dict) -> tuple[list, float, float]:
    """Per tensor: max|upd| of `ref`, max|Δ| of `other` against it, their
    ratio and Δ over the net's largest update; the worst ratio over the
    tensors with updates ≥ 1e-3 of their net's largest, and the worst Δ
    over the net's largest update over all tensors."""
    table, worst, worst_net = [], 0.0, 0.0
    for n in ref:
        top = max(float(u.abs().max()) for u in ref[n].values())
        for k, u in ref[n].items():
            d = float((other[n][k] - u).abs().max())
            m = float(u.abs().max())
            bounded = m >= 1e-3 * top
            table.append(dict(net=n, tensor=k, max_upd=m, max_diff=d,
                              ratio=d / m if m > 0 else float("inf"),
                              of_net_max=d / top, bounded=bounded))
            if bounded:
                worst = max(worst, d / m)
            worst_net = max(worst_net, d / top)
    return table, worst, worst_net


def phase_train_reference(dev) -> dict:
    """One full-width simultaneous SGD step of the audio-only model on
    the card against the same step on the CPU: same weights, batch,
    gap masks and dropout masks. The card's step runs cuDNN's
    deterministic algorithms: with its default ones (atomic sums in the
    weight gradients) one run in twelve read 1.443e-3 of a net's largest
    update against 2.9e-4 to 3.5e-4 in the others (PERF.md, PR 5). Three
    diagnostics beside it: the card with cuDNN's default algorithms, the
    CPU step on one thread (another summation order), and the card's
    step with cuDNN off (PyTorch's own convolutions), which tell the
    float32 spread of the step itself from that of cuDNN's
    algorithms."""
    from viai_tpu_torch.train import init_state, make_train_step

    cfg = TrainConfig()
    B = TRAIN_REF_BATCH
    G0, D0 = define_G(dropout=0.5, device="cpu"), define_D(3, device="cpu")
    wav = tones(B, seed=9, device="cpu")
    gen = torch.Generator().manual_seed(0)
    tmask = sample_batch_masks(gen, B, cfg.image_frames, cfg.mask)
    masks = G0.dropout_masks((B, 2, cfg.n_bins, cfg.image_frames), gen)
    runs = {}
    threads = torch.get_num_threads()
    cpu = torch.device("cpu")
    for where, d, n_threads, cudnn, determ in (
            ("cpu", cpu, threads, True, False),
            ("cpu, 1 thread", cpu, 1, True, False),
            ("card", dev, threads, True, True),
            ("card, cuDNN default algorithms", dev, threads, True, False),
            ("card, cuDNN off", dev, threads, False, False)):
        torch.backends.cudnn.enabled = cudnn
        torch.backends.cudnn.deterministic = determ
        G, D = copy.deepcopy(G0).to(d), copy.deepcopy(D0).to(d)
        nets = {"G": G, "D": D}
        before = {n: {k: p.detach().clone() for k, p in net.named_parameters()}
                  for n, net in nets.items()}
        step = make_train_step(
            G, D, None, torch.optim.SGD(G.parameters(), lr=TRAIN_REF_LR),
            torch.optim.SGD(D.parameters(), lr=TRAIN_REF_LR), cfg)
        torch.set_num_threads(n_threads)
        t0 = time.perf_counter()
        met = step(init_state(D, cfg), wav.to(d), tmask=tmask.to(d),
                   dropout=[m.to(d) for m in masks])
        met = {k: float(v) for k, v in met.items()}
        secs = time.perf_counter() - t0
        torch.set_num_threads(threads)
        torch.backends.cudnn.enabled = True
        torch.backends.cudnn.deterministic = False
        upd = {n: {k: (p.detach() - before[n][k]).cpu()
                   for k, p in net.named_parameters()}
               for n, net in nets.items()}
        runs[where] = (met, upd, secs)
    mc, uc, sc = runs["cpu"]
    out = {}
    for other in ("card", "card, cuDNN default algorithms", "cpu, 1 thread",
                  "card, cuDNN off"):
        mo, uo, so = runs[other]
        loss_rel = {k: abs(mo[k] - mc[k]) / max(abs(mc[k]), 1e-12)
                    for k in mc}
        table, worst, worst_net = _update_errors(uc, uo)
        out[other] = dict(loss_rel=max(loss_rel.values()), upd=worst,
                          upd_net=worst_net)
        tag = f"[train reference] {other} vs cpu ({threads} threads)"
        log(f"{tag}: step {so:.2f} s; losses |Δ| / |cpu|: " + " ".join(
            f"{k} {v:.2e}" for k, v in loss_rel.items()))
        n_b = sum(t["bounded"] for t in table)
        w = max(table, key=lambda t: t["of_net_max"])
        log(f"{tag}: max|Δ update| / max|update| worst {worst:.3e} over "
            f"{n_b} tensors (bound {TRAIN_REF_BOUND:g} for the card); "
            f"max|Δ| / net's largest update worst {worst_net:.3e} over all "
            f"{len(table)} (bound {TRAIN_REF_NET_BOUND:g}), in "
            f"{w['net']}.{w['tensor']}")
        for t in sorted(table, key=lambda t: -t["ratio"] if t["bounded"]
                        else 0.0)[:3]:
            log(f"{tag}:   {t['net']}.{t['tensor']}: max|upd| "
                f"{t['max_upd']:.3e} max|Δ| {t['max_diff']:.3e} ratio "
                f"{t['ratio']:.3e}")
        if other == "card":
            OUT_DIR.mkdir(exist_ok=True)
            with open(OUT_DIR / "train_reference.json", "w") as f:
                json.dump({"losses_rel": loss_rel, "tensors": table}, f,
                          indent=1)
    log(f"[train reference] batch {B}, SGD lr {TRAIN_REF_LR}, CPU step "
        f"{sc:.2f} s; per tensor: chiprun_out/train_reference.json")
    card = out["card"]
    require(card["loss_rel"] < TRAIN_REF_LOSS_BOUND,
            "[train reference] losses disagree")
    require(card["upd"] < TRAIN_REF_BOUND
            and card["upd_net"] < TRAIN_REF_NET_BOUND,
            "[train reference] updates disagree")
    return out


def step_gflop(model) -> tuple[float, float, float, float]:
    """GFLOP of one train step counted from the shapes: G (and V) one
    forward and a backward at twice it; D three forwards (the fake for
    G's loss, real and fake for D's), each with a backward at twice."""
    b, o, c, dev = TRAIN_BATCH, model.opt, model.cfg, model.device
    img = (1, c.n_bins, c.image_frames)
    feats = ((torch.zeros(1, c.image_frames // 16, o.fusion_channels,
                          device=dev),) if model.V is not None else ())
    g = conv_gflop(model.G, torch.zeros(1, 2, *img[1:], device=dev), *feats)
    d = conv_gflop(model.D, torch.zeros(1, 3, *img[1:], device=dev))
    v = (conv_gflop(model.V, torch.zeros(
        1, o.n_video_frames, o.frame_size, o.frame_size, 3, device=dev))
         if model.V is not None else 0.0)
    return b * (3 * g + 9 * d + 3 * v), g, d, v


def parse_quietly(args: list[str]):
    """TrainOptions for `args`, without printing them again."""
    import contextlib
    import io

    from viai_tpu_torch.config import TrainOptions

    with contextlib.redirect_stdout(io.StringIO()):
        opt = TrainOptions().parse(args, save=False)
    opt.steps_per_epoch = TRAIN_STEPS
    return opt


def phase_times_train(dev, card: str, kind: str) -> dict:
    """Steps/s and clips/s at batch 16 (CUDA events over TRAIN_TIMED_STEPS
    steps after 3 of warm-up), the share of the window's wall time spent
    waiting on the loader, peak memory, FLOPs and rate, a checkpoint's
    write time; then one step under torch.profiler."""
    from viai_tpu_torch.data import create_dataloader
    from viai_tpu_torch.model import VIAIModel

    tag = f"({torch.cuda.get_device_name(0)}, {card.split(',')[-1].strip()})"
    with tempfile.TemporaryDirectory() as ckpt:
        opt = parse_quietly(train_args(kind, ckpt, f"times_{kind}"))
        model = VIAIModel(opt)
        loader = create_dataloader(
            opt.dataset_mode, None, opt.batchSize,
            int(opt.sample_rate * opt.clip_seconds), opt.sample_rate,
            opt.nThreads, opt.n_video_frames, opt.frame_size, seed=opt.seed)
        try:
            for _ in range(3):
                model.set_input(next(loader))
                model.optimize_parameters()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            wait = 0.0
            t0 = time.perf_counter()
            start.record()
            for _ in range(TRAIN_TIMED_STEPS):
                tw = time.perf_counter()
                batch = next(loader)
                wait += time.perf_counter() - tw
                model.set_input(batch)
                model.optimize_parameters()
            end.record()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            step_ms = start.elapsed_time(end) / TRAIN_TIMED_STEPS
            peak = torch.cuda.max_memory_allocated() / 2**30
            gf, g, d, v = step_gflop(model)
            t1 = time.perf_counter()
            model.save_networks("latest")
            save_s = time.perf_counter() - t1
            log(f"[times train] {kind}: {step_ms:.2f} ms a step, "
                f"{1e3 / step_ms:.2f} steps/s, {TRAIN_BATCH * 1e3 / step_ms:.1f}"
                f" clips/s at batch {TRAIN_BATCH} (CUDA events over "
                f"{TRAIN_TIMED_STEPS} steps); loader wait {wait * 1e3:.1f} ms "
                f"of {wall * 1e3:.1f} ms wall ({wait / wall:.1%}); peak "
                f"allocated {peak:.2f} GiB {tag}")
            log(f"[times train] {kind}: {gf / TRAIN_BATCH:.1f} GFLOP a clip a "
                f"step (G fwd {g:.2f}, D fwd {d:.2f}, V fwd {v:.3f}; G, V "
                f"×3, D ×9), {gf / 1e3:.2f} TFLOP a step -> "
                f"{gf / step_ms:.1f} TFLOP/s achieved, "
                f"{gf / step_ms / (PEAK_FP32 / 1e12):.1%} of the 67 TFLOP/s "
                f"float32 peak; checkpoint write (G, D{', V' if v else ''} "
                f".pth + state.pt) {save_s:.2f} s")
            res = dict(step_ms=step_ms, steps_per_s=1e3 / step_ms,
                       clips_per_s=TRAIN_BATCH * 1e3 / step_ms,
                       loader_share=wait / wall, peak_gib=peak,
                       tflop_step=gf / 1e3, save_s=save_s)
            profile_train_step(model, loader, kind, tag)
        finally:
            loader.close()
    return res


def profile_train_step(model, loader, kind: str, tag: str):
    """Device time by kernel of one train step, and the device's busy
    share of the step's wall time."""
    batch = next(loader)

    def step():
        model.set_input(batch)
        model.optimize_parameters()

    profile_step(step, f"profile train{' av' if kind == 'av' else ''}", tag)


def profile_step(step, name: str, tag: str):
    """Device time by kernel of one call of `step` (torch.profiler), and
    the device's busy share of its wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    if not rows:
        log(f"[{name}] no device time in the trace: not measured")
        return
    total_us = sum(e.self_device_time_total for e in rows)
    log(f"[{name}] one step: device busy {total_us / 1e3:.2f} ms of "
        f"{wall_ms:.2f} ms wall ({total_us / 1e3 / wall_ms:.1%}; profiler "
        f"on) {tag}")
    rows.sort(key=lambda e: -e.self_device_time_total)
    for e in rows[:10]:
        log(f"[{name}]   {e.self_device_time_total / 1e3:8.3f} ms "
            f"{e.self_device_time_total / total_us:6.1%} x{e.count:<4d} "
            f"{e.key[:90]}")


def perturbed_R(in_channels: int, out_channels: int = 1, seed: int = 3,
                device="cpu") -> torch.nn.Module:
    """define_R at full width with its zero-init layers (the FiLM
    projections and the head) drawn N(0, 0.02²) from a seed: a fresh R
    predicts v̂ ≡ 0, and a check of it would test nothing."""
    R = define_R(in_channels, 64, out_channels=out_channels, seed=seed,
                 device="cpu")
    g = torch.Generator().manual_seed(100 + seed)
    with torch.no_grad():
        for m in R.modules():
            if isinstance(m, FiLM):
                m.proj.weight.normal_(0.0, 0.02, generator=g)
        R.head.weight.normal_(0.0, 0.02, generator=g)
    return R.to(device).eval()


def phase_refiner(dev) -> tuple[InpaintService, int]:
    """The refiner chain at full width: requests of 3, 8 and 21 clips,
    then one bucket-8 request per option of REFINER_OPTIONS, each on the
    GL kernel, then one complex-domain request, which must launch no GL.
    Returns the service and the kernel's launches over the path."""
    cfg = TrainConfig()
    G = define_G()
    R = perturbed_R(4, device=dev)
    svc = InpaintService(G, cfg, refiner=R, buckets=(8, 32), gl_iters=32,
                         **REFINE)
    zero_counts()
    outs = {}
    t0 = time.perf_counter()
    for n_req in (3, 8, 21):
        wavs = tones(n_req, seed=500 + n_req, device="cpu").numpy()
        outs[n_req] = (wavs, svc.inpaint(wavs, gap_start_s=GAP_S[0],
                                         gap_end_s=GAP_S[1]))
    launches = read_launches("refiner", svc, time.perf_counter() - t0)
    check_served("refiner", svc, outs)
    wavs = tones(8, seed=508, device="cpu").numpy()
    gap = dict(gap_start_s=GAP_S[0], gap_end_s=GAP_S[1])
    for name, kw, r_in in REFINER_OPTIONS:
        R_o = R if r_in == 4 else perturbed_R(r_in, device=dev)
        svc_o = InpaintService(G, cfg, refiner=R_o, buckets=(8,),
                               gl_iters=32, **{**REFINE, **kw})
        zero_counts()
        t0 = time.perf_counter()
        y = svc_o.inpaint(wavs, **gap)
        tag = f"refiner] [{name}"
        launches += read_launches(tag, svc_o, time.perf_counter() - t0)
        check_served(tag, svc_o, {8: (wavs, y)})
    Rc = perturbed_R(*complex_refiner_channels(2), device=dev)
    svc_c = InpaintService(G, cfg, refiner=Rc, buckets=(8,), **COMPLEX)
    zero_counts()
    t0 = time.perf_counter()
    y = svc_c.inpaint(wavs, **gap)
    torch.cuda.synchronize()
    log(f"[refiner] [complex, complex_mag mean, refine_avg 2] 8 clips in "
        f"{time.perf_counter() - t0:.2f} s incl. first-call set-up; "
        f"griffin_lim_cuda launches {griffin_lim_cuda.launches}, plain "
        f"griffin_lim calls {griffin_lim.calls}")
    require(griffin_lim_cuda.launches == 0 and griffin_lim.calls == 0,
            "[refiner] the complex domain ran Griffin-Lim")
    check_served("refiner] [complex", svc_c, {8: (wavs, y)})
    return svc, launches


@contextlib.contextmanager
def tf32_on():
    """TF32 for cuDNN convolutions and matmuls inside the block: the
    control run that a float32 bound must fail."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def phase_refiner_reference(svc: InpaintService, dev):
    """R's forward and both refiner chains on the card against the CPU:
    same weights, inputs, clips, masks and injected noise (2 clips; the
    magnitude chain at GL×1); max|Δ| over the CPU output's peak. R alone
    (2 inputs, t 0.3 and 0.9) and the complex chain, which runs no GL,
    are held to REFINER_REF_BOUND; the magnitude chain, whose error is
    G's and GL's share as in [reference], to 1e-3. Each runs again on
    the card with TF32 on; R alone and the complex chain must then
    exceed their bound, or the bound could not see R's precision."""
    cfg = svc.cfg
    G = define_G(device="cpu")
    wavs = tones(2, seed=7, device="cpu")
    masks = torch.from_numpy(svc.time_mask_from_seconds(2, *GAP_S))
    gen = torch.Generator().manual_seed(12)
    x_r = torch.randn(2, 4, 256, 256, generator=gen)
    t_r = torch.tensor([0.3, 0.9])

    def forward(g, r):
        @torch.inference_mode()
        def run(w, m, noise):
            return r(x_r.to(w.device), t_r.to(w.device))
        return run

    chains = (
        ("R forward", 4, 1, REFINER_REF_BOUND, forward),
        ("magnitude chain, GL×1", 4, 1, 1e-3, lambda g, r: make_infer_fn(
            g, cfg, n_gl_iter=1, refiner=r, **REFINE)),
        ("complex chain", *complex_refiner_channels(2), REFINER_REF_BOUND,
         lambda g, r: make_complex_refiner_infer_fn(
             g, r, cfg, steps=8, t_start=1.0, complex_mag="mean",
             refine_avg=2)),
    )
    for name, r_in, r_out, bound, build in chains:
        R = perturbed_R(r_in, r_out)
        k = 2 if r_out == 2 else 1
        gen = torch.Generator().manual_seed(11)
        noise = [draw_noise(gen, (2, r_out, 256, 256), 8, 0)
                 for _ in range(k)]
        ref = build(G, R)(wavs, masks, noise=noise)
        card = build(card_copy(G, dev), card_copy(R, dev))
        out = card(wavs.to(dev), masks.to(dev), noise=noise).cpu()
        with tf32_on():
            out_tf32 = card(wavs.to(dev), masks.to(dev), noise=noise).cpu()
        require(bool(torch.isfinite(out).all()),
                f"[refiner reference] {name}: non-finite output")
        peak = float(ref.abs().max())
        err = float((out - ref).abs().max()) / peak
        err_tf32 = float((out_tf32 - ref).abs().max()) / peak
        log(f"[refiner reference] {name} on {dev} vs CPU, 2 clips (chains: "
            f"8 DDIM steps, injected noise): max|Δ|/max|ref| {err:.3e} "
            f"(bound {bound:g}); with TF32 on {err_tf32:.3e}")
        require(err < bound, f"[refiner reference] the {name} on the card "
                f"disagrees with the CPU")
        require(bound > 1e-3 or err_tf32 > bound,
                f"[refiner reference] the {name} with TF32 on passes the "
                f"float32 bound {bound:g}")


def eval_arm(label: str, args: list[str], n: int) -> tuple[dict, int]:
    """One run of the eval CLI: its summary and GL launches; n clips
    scored, every mean and SEM finite, no plain griffin_lim."""
    from viai_tpu_torch.cli.test import main as test_main

    zero_counts()
    t0 = time.perf_counter()
    summary = test_main(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = griffin_lim_cuda.launches, griffin_lim.calls
    stats = {k: v for k, v in summary.items() if k.endswith(("_mean", "_sem"))}
    bok = sorted(k for k in summary if "_bok_" in k)
    log(f"[eval] {label}: n {summary['n']}, hole-PSNR "
        f"{summary['hole_psnr_mean']:.3f} ± {summary['hole_psnr_sem']:.3f} "
        f"dB, PSNR {summary['psnr_mean']:.3f}, SNR {summary['snr_mean']:.3f} "
        f"dB, specConv {summary['spec_conv_mean']:.4f}; {len(bok)} *_bok_* "
        f"keys; {wall:.1f} s incl. loading; griffin_lim_cuda launches "
        f"{launches}, plain griffin_lim calls {plain}")
    require(summary["n"] == n, f"[eval] {label}: n {summary['n']} != {n}")
    require(all(np.isfinite(v) for v in stats.values()),
            f"[eval] {label}: a non-finite mean or SEM")
    require(plain == 0, f"[eval] {label}: ran the plain griffin_lim")
    return summary, launches


def phase_eval(dev, ckpt: str, name: str) -> int:
    """The eval CLI on the card: the arms of EVAL_ARMS on the checkpoint
    `name` that [train] wrote under `ckpt`, a second G (seed 1) in its
    own run directory, R as latest_net_R.pth and a complex-domain R as
    cplx_net_R.pth. Returns the GL kernel's launches over the arms."""
    expr = os.path.join(ckpt, name)
    save_networks({"G": define_G(seed=1)}, "latest",
                  os.path.join(ckpt, EVAL_RUN2))
    # Tag cplx first: saving an epoch tag also writes the latest alias.
    save_networks({"R": perturbed_R(*complex_refiner_channels(2))}, "cplx",
                  expr)
    save_networks({"R": perturbed_R(4)}, "latest", expr)
    BUILD_DIR.mkdir(exist_ok=True)
    records = BUILD_DIR / "eval_results.jsonl"
    os.environ["VIAI_RESULTS_JSONL"] = str(records)
    total = 0
    for arm, extra in EVAL_ARMS.items():
        args = ["--name", name, "--checkpoints_dir", ckpt, "--gpu_ids", "0",
                "--results_dir", os.path.join(ckpt, "results"), *EVAL_BASE,
                *extra, "--log_results", f"chip_eval_{arm}"]
        summary, launches = eval_arm(f"({arm}) {' '.join(extra) or 'G alone'}",
                                     args, 40)
        bok = sorted(k for k in summary if "_bok_" in k)
        require(bool(bok) == (arm == "b"),
                f"[eval] ({arm}) *_bok_* keys {bok}")
        require((launches > 0) == (arm != "c"),
                f"[eval] ({arm}) {launches} GL launches")
        total += launches
    with open(records) as f:
        recs = [json.loads(line) for line in f]
    require(len(recs) >= 3 and all(len(r["hole_psnr_clips"]) == 40
                                   and r["package"] == "viai_tpu_torch"
                                   for r in recs[-3:]),
            "[eval] --log_results records")
    log(f"[eval] records: {records.relative_to(BUILD_DIR.parent)}")
    return total


def phase_times_refiner(dev, card: str) -> dict:
    """One bucket-32 request at refine_avg 1 and 8 (chunk 8), CUDA events
    after warm-up, with R's GFLOP a clip counted from the shapes, the
    rate, peak memory and clips/s; R's forward alone at batch 32."""
    tag = f"({torch.cuda.get_device_name(0)}, {card.split(',')[-1].strip()})"
    cfg = TrainConfig()
    G, R = define_G(), perturbed_R(4, device=dev)
    r_gf = conv_gflop(R, torch.zeros(1, 4, 256, 256, device=dev),
                      torch.zeros(1, device=dev))
    g_gf = conv_gflop(G, torch.zeros(1, 2, 256, 256, device=dev))
    x = torch.zeros(32, 4, 256, 256, device=dev)
    t = torch.full((32,), 0.3, device=dev)
    with torch.inference_mode():
        r_ms = time_ms(lambda: R(x, t), 5)
    del x
    log(f"[times refiner] R {r_gf:.2f} GFLOP a clip a forward, G "
        f"{g_gf:.2f} (conv and linear layers, counted from the shapes); R "
        f"forward at batch 32 {r_ms:.2f} ms = {32 * r_gf / r_ms:.1f} TFLOP/s "
        f"{tag}")
    wavs = tones(32, seed=600, device="cpu").numpy()
    gap = dict(gap_start_s=GAP_S[0], gap_end_s=GAP_S[1])
    res = {"r_gflop": r_gf, "r_ms": r_ms}
    for avg in (1, 8):
        svc = InpaintService(G, cfg, refiner=R, buckets=(8, 32), gl_iters=32,
                             refine_avg=avg, refine_chunk=8, **REFINE)
        svc.inpaint(wavs, **gap)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = time_ms(lambda: svc.inpaint(wavs, **gap), 3 if avg == 1 else 2,
                     warmup=1)
        peak = torch.cuda.max_memory_allocated() / 2**30
        tflop = 32 * (g_gf + avg * REFINE["refine_steps"] * r_gf) / 1e3
        log(f"[times refiner] bucket 32, refine_avg {avg}: {ms:.1f} ms a "
            f"request, {32e3 / ms:.1f} clips/s; {tflop:.2f} TFLOP a request "
            f"(G + {avg}×{REFINE['refine_steps']} R forwards) -> "
            f"{tflop * 1e3 / ms:.1f} TFLOP/s; peak allocated {peak:.2f} GiB "
            f"{tag}")
        res[avg] = dict(ms=ms, clips_per_s=32e3 / ms, peak_gib=peak,
                        tflop=tflop)
    phase_profile(InpaintService(G, cfg, refiner=R, buckets=(8, 32),
                                 gl_iters=32, **REFINE), card,
                  "profile refiner")
    return res


# ---------------------------------------------------------------------------
# Folder data
# ---------------------------------------------------------------------------

def write_corpus(root: pathlib.Path) -> list[str]:
    """The [data] corpus under `root` (see DATA_CLIPS); → the stems of
    the clips with frames, in av/."""
    from viai_tpu_torch.data import SyntheticAVDataset, SyntheticConfig
    from viai_tpu_torch.data.audio import resample_linear_numpy, write_wav
    from viai_tpu_torch.data.avi import write_avi

    ds = SyntheticAVDataset(SyntheticConfig(
        clip_seconds=DATA_SECONDS, with_video=True, video_frames=FRAMES[0],
        video_size=FRAMES[1]))
    (root / "av").mkdir(parents=True)
    (root / "audio_only").mkdir()
    stems = []
    for i in range(DATA_CLIPS):
        item = ds[DATA_SEED * 1000 + i]
        wav, sr = item["wav"], SR
        if i <= DATA_AV:
            stem = root / "av" / f"clip{i:02d}"
            frames = np.round(item["frames"] * 255).astype(np.uint8)
            if i < DATA_AV:
                np.save(f"{stem}.npy", frames)
            else:
                write_avi(f"{stem}.avi", frames, 8)
            stems.append(str(stem))
        else:
            stem = root / "audio_only" / f"clip{i:02d}"
            if i == DATA_AV + 1:
                sr = 22050
                wav = resample_linear_numpy(wav, SR, sr)
            elif i == DATA_AV + 2:
                wav = np.stack([wav, 0.5 * wav], axis=1)
        write_wav(f"{stem}.wav", wav, sr)
    entries = [{"audio": os.path.relpath(f"{s}.wav", root),
                "frames": os.path.relpath(
                    s + (".npy" if os.path.exists(f"{s}.npy") else ".avi"),
                    root)} for s in stems]
    manifest = {"train": entries[:10], "test": entries[10:]}
    with open(root / "musices.json", "w") as f:
        json.dump(manifest, f)
    return stems


def data_train_args(kind: str, ckpt: str, root: pathlib.Path) -> list[str]:
    dataroot = root if kind == "audio" else root / "av"
    return ["--name", f"chip_data_{kind}", "--checkpoints_dir", ckpt,
            "--gpu_ids", "0", "--batchSize", str(TRAIN_BATCH), "--niter", "1",
            "--niter_decay", "0", "--steps_per_epoch", str(TRAIN_STEPS),
            "--save_epoch_freq", "1", "--display_freq", str(TRAIN_DISPLAY),
            "--print_freq", str(TRAIN_DISPLAY), "--dataroot", str(dataroot),
            *DATA_TRAIN[kind]]


def phase_data(dev, ckpt: str, card: str) -> int:
    """Folder data on the card: write the corpus; the native decoder and
    frame reader against the numpy ones; a batch in every mode; G
    trained 20 steps from the folder (audio, then av) through the train
    CLI with prefetch, the visuals on the GL kernel; the eval CLI on the
    musices test split; the loader's wait share of a step. Returns the
    GL kernel's launches."""
    from viai_tpu_torch import native
    from viai_tpu_torch.cli.train import main as train_main
    from viai_tpu_torch.data import create_dataloader, device_prefetch
    from viai_tpu_torch.data.audio import (find_wavs, read_wav_numpy,
                                           resample_linear_numpy)
    from viai_tpu_torch.data.av import frames_numpy
    from viai_tpu_torch.data.avi import read_avi
    from viai_tpu_torch.model import VIAIModel

    root = pathlib.Path(ckpt) / "corpus"
    t0 = time.perf_counter()
    stems = write_corpus(root)
    log(f"[data] corpus: {DATA_CLIPS} wav files of {DATA_SECONDS:g} s "
        f"(PCM16; one at 22.05 kHz, one stereo), {DATA_AV} npy stacks "
        f"{FRAMES} and one AVI, musices.json; written in "
        f"{time.perf_counter() - t0:.1f} s")
    wav_err = 0.0
    for path in find_wavs(str(root)):
        with open(path, "rb") as f:
            data = f.read()
        (w, sr), (r, sr_r) = native.decode_wav(data), read_wav_numpy(data)
        require(sr == sr_r and w.shape == r.shape, f"[data] {path}: decoders "
                f"disagree on the rate or length")
        wav_err = max(wav_err, float(np.abs(w - r).max()))
        if sr != SR:
            wav_err = max(wav_err, float(np.abs(
                native.resample_linear(w, sr, SR)
                - resample_linear_numpy(r, sr, SR)).max()))
    frames_err = 0.0
    for stem in stems:
        path = stem + (".npy" if os.path.exists(stem + ".npy") else ".avi")
        arr = np.load(path) if path.endswith(".npy") else read_avi(path)[0]
        for size, window in ((FRAMES[1], None), (48, (0.25, 0.75))):
            out = native.load_frames(path, FRAMES[0], size, window)
            ref = frames_numpy(arr, FRAMES[0], size, window)
            frames_err = max(frames_err, float(np.abs(out - ref).max()))
    log(f"[data] native vs numpy: wav decode and resample max|Δ| "
        f"{wav_err:.3e} (bound 0: the same float64 arithmetic); frames "
        f"(npy and AVI, full size and resized to 48, whole source and a "
        f"window) max|Δ| {frames_err:.3e} (bound 1e-6)")
    require(wav_err == 0.0, "[data] the native wav decoder disagrees")
    require(frames_err < 1e-6, "[data] the native frame reader disagrees")

    manifest = str(root / "musices.json")
    common = dict(clip_samples=CLIP, sample_rate=SR, n_frames=FRAMES[0],
                  frame_size=FRAMES[1], seed=0)
    for label, mode, dataroot, batch, kw in (
            ("audio, native loader", "audio", root, TRAIN_BATCH, {}),
            ("audio, in order", "audio", root, 8,
             dict(shuffle=False, num_epochs=1, prefer_native=False)),
            ("av", "av", root / "av", 8, {}),
            ("musices train", "musices", manifest, 8,
             dict(shuffle=False, num_epochs=1)),
            ("musices test", "musices", manifest, 3,
             dict(shuffle=False, num_epochs=1, split="test"))):
        t0 = time.perf_counter()
        loader = create_dataloader(mode, str(dataroot), batch,
                                   **{"n_threads": 0, **common, **kw})
        it = iter(loader)
        b = next(it)
        secs = time.perf_counter() - t0
        shapes = {k: tuple(v.shape) for k, v in b.items()}
        require(shapes["wav"] == (batch, CLIP) and all(
            bool(np.isfinite(np.asarray(v)).all()) for v in b.values()),
            f"[data] {label}: batch {shapes}")
        require(mode == "audio" or shapes["frames"] == (batch, *FRAMES),
                f"[data] {label}: frames {shapes}")
        log(f"[data] {label}: first batch {shapes} in {secs:.2f} s")
        del it
        if hasattr(loader, "close"):
            loader.close()

    total = 0
    for kind in DATA_TRAIN:
        args = data_train_args(kind, ckpt, root)
        zero_counts()
        t0 = time.perf_counter()
        model = train_main(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, plain = griffin_lim_cuda.launches, griffin_lim.calls
        losses = model.get_current_losses()
        log(f"[data] train {kind} from the folder: {TRAIN_STEPS} steps at "
            f"batch {TRAIN_BATCH} through viai_tpu_torch.cli.train (prefetch "
            f"depth 2) in {wall:.1f} s incl. building and the loader's "
            f"start; losses " + " ".join(f"{k} {v:.4f}"
                                         for k, v in losses.items())
            + f"; griffin_lim_cuda launches {launches}, plain {plain}")
        require(all(np.isfinite(v) for v in losses.values()),
                f"[data] train {kind}: non-finite loss")
        require(launches == TRAIN_STEPS // TRAIN_DISPLAY and plain == 0,
                f"[data] train {kind}: GL launches {launches}, plain {plain}")
        total += launches
        del model
    summary, launches = eval_arm(
        "(data) chip_data_audio on the musices test split",
        ["--name", "chip_data_audio", "--checkpoints_dir", ckpt, "--gpu_ids",
         "0", "--dataset_mode", "musices", "--dataroot", manifest, "--phase",
         "test", "--batchSize", "3", "--how_many", "3", "--results_dir",
         os.path.join(ckpt, "results")], 3)
    require(launches > 0, "[data] the eval CLI launched no GL")
    total += launches

    tag = f"({torch.cuda.get_device_name(0)}, {card.split(',')[-1].strip()})"
    for kind in DATA_TRAIN:
        opt = parse_quietly(data_train_args(kind, ckpt, root))
        model = VIAIModel(opt)
        loader = create_dataloader(
            opt.dataset_mode, opt.dataroot, opt.batchSize, CLIP, SR,
            opt.nThreads, opt.n_video_frames, opt.frame_size, seed=opt.seed)
        batches = device_prefetch(iter(loader), dev)
        for _ in range(3):
            model.set_input(next(batches))
            model.optimize_parameters()
        torch.cuda.synchronize()
        wait = 0.0
        t0 = time.perf_counter()
        for _ in range(TRAIN_TIMED_STEPS):
            tw = time.perf_counter()
            batch = next(batches)
            wait += time.perf_counter() - tw
            model.set_input(batch)
            model.optimize_parameters()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        log(f"[data] {kind} from the folder ({type(loader).__name__}, "
            f"{opt.nThreads} workers, prefetch depth 2): loader wait "
            f"{wait * 1e3:.1f} ms of {wall * 1e3:.1f} ms wall over "
            f"{TRAIN_TIMED_STEPS} steps ({wait / wall:.1%}), "
            f"{wall * 1e3 / TRAIN_TIMED_STEPS:.1f} ms a step {tag}")
        del batches, model
        if hasattr(loader, "close"):
            loader.close()
    return total


# ---------------------------------------------------------------------------
# Refiner training
# ---------------------------------------------------------------------------

def phase_train_refiner(dev, ckpt: str, name: str):
    """The refiner CLI at full width on [train]'s audio checkpoint, both
    domains (the complex R beside a copy of G in its own run directory),
    under cuDNN's deterministic algorithms; a run resumed from
    R20_state.pt to 40 gives the uninterrupted run's net_R; then 8 steps
    on one fixed batch with fixed draws, whose loss falls."""
    from viai_tpu_torch.cli.train_refiner import main as refiner_main
    from viai_tpu_torch.train.diffusion import make_refiner_train_step
    from viai_tpu_torch.train.schedules import adam, cosine

    expr = os.path.join(ckpt, name)
    os.makedirs(expr + "_cplx")
    for net in ("G", "D"):
        shutil.copy(os.path.join(expr, f"latest_net_{net}.pth"),
                    expr + "_cplx")
    torch.backends.cudnn.deterministic = True
    try:
        for domain, run in (("mag", name), ("complex", name + "_cplx")):
            args = ["--name", run, "--checkpoints_dir", ckpt, "--domain",
                    domain, "--results_dir", os.path.join(ckpt, "results"),
                    *REFINER_TRAIN]
            t0 = time.perf_counter()
            rec = refiner_main(args)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            log(f"[train refiner] {domain}: {REFINER_STEPS} steps at batch "
                f"{REFINER_BATCH} (bf16 G and R, Adam with the cosine decay "
                f"to 0.1, EMA 0.999) through viai_tpu_torch.cli.train_refiner"
                f" in {wall:.1f} s incl. loading G, the pool and 3 saves; "
                f"final v-MSE {rec['final_v_mse']:.5f}; "
                f"{rec['train_clips_per_s']:.1f} clips/s (host clock, saves "
                f"included)")
            require(np.isfinite(rec["final_v_mse"]),
                    f"[train refiner] {domain}: non-finite loss")
            out = os.path.join(ckpt, run)
            for f in (f"{REFINER_MILESTONE}_net_R.pth",
                      f"{REFINER_STEPS}_net_Rraw.pth", "latest_net_R.pth",
                      f"R{REFINER_MILESTONE}_state.pt"):
                require(os.path.exists(os.path.join(out, f)),
                        f"[train refiner] {domain}: no {f}")
            if domain != "mag":
                continue
            path = os.path.join(out, f"{REFINER_STEPS}_net_R.pth")
            first = torch.load(path, weights_only=True)
            rec2 = refiner_main(args + ["--resume_step",
                                        str(REFINER_MILESTONE)])
            second = torch.load(path, weights_only=True)
            diff = max(float((first[k] - second[k]).abs().max())
                       for k in first)
            log(f"[train refiner] {domain}: resumed from "
                f"R{REFINER_MILESTONE}_state.pt to {REFINER_STEPS}: net_R "
                f"max|Δ| {diff:.3e} from the uninterrupted run (bound 0, "
                f"cuDNN's deterministic algorithms); final v-MSE "
                f"{rec2['final_v_mse']:.5f}")
            require(diff == 0.0, "[train refiner] the resumed run differs")
    finally:
        torch.backends.cudnn.deterministic = False

    cfg = TrainConfig()
    G = define_G(dtype="bfloat16")
    load_networks({"G": G}, "latest", expr)
    R = define_R(4, 64, dtype="bfloat16", seed=3, device=dev)
    opt = adam(R.parameters(), cosine(2e-4, 8, 0, 1, alpha=0.1), beta1=0.9)
    step = make_refiner_train_step(G, None, R, copy.deepcopy(R), opt, cfg)
    gen = torch.Generator(device=dev).manual_seed(1)
    wav = tones(REFINER_BATCH, seed=800, device=dev)
    draws = dict(tmask=sample_batch_masks(gen, REFINER_BATCH,
                                          cfg.image_frames, cfg.mask),
                 t=torch.rand(REFINER_BATCH, generator=gen, device=dev),
                 eps=torch.randn(REFINER_BATCH, 1, cfg.n_bins,
                                 cfg.image_frames, generator=gen, device=dev))
    losses = [float(step(wav, **draws)["loss_R"]) for _ in range(8)]
    log(f"[train refiner] fixed batch and draws: v-MSE step 1 "
        f"{losses[0]:.5f} -> step 8 {losses[-1]:.5f}")
    require(losses[-1] < losses[0], "[train refiner] the loss did not fall")


def phase_train_refiner_reference(dev):
    """One float32 SGD step of each domain's R at full width, batch 4, on
    the card against the CPU: the same G and R (its zero-init layers
    moved), waveforms and draws (gap masks, t, ε, keep under cond_drop
    0.5, the self-conditioning coin on its first-pass side); cuDNN's
    deterministic algorithms; the bounds of [train reference]. Again on
    the card with TF32 on, printed beside it."""
    from viai_tpu_torch.train.diffusion import (
        make_complex_refiner_train_step, make_refiner_train_step)

    cfg = TrainConfig()
    B = TRAIN_REF_BATCH
    G0 = define_G(device="cpu")
    wav = tones(B, seed=19, device="cpu")
    gen = torch.Generator().manual_seed(5)
    tmask = sample_batch_masks(gen, B, cfg.image_frames, cfg.mask)
    t = torch.rand(B, generator=gen)
    keep = torch.rand(B, generator=gen) >= 0.5
    cpu = torch.device("cpu")
    for domain, (r_in, r_out), make in (
            ("mag", (5, 1), make_refiner_train_step),
            ("complex", complex_refiner_channels(2, self_cond=True),
             make_complex_refiner_train_step)):
        R0 = perturbed_R(r_in, r_out)
        eps = torch.randn(B, r_out, cfg.n_bins, cfg.image_frames,
                          generator=gen)
        runs = {}
        for where, d, tf32 in (("cpu", cpu, False), ("card", dev, False),
                               ("card, TF32 on", dev, True)):
            torch.backends.cudnn.deterministic = d.type == "cuda"
            G, R = copy.deepcopy(G0).to(d), copy.deepcopy(R0).to(d)
            before = {k: p.detach().clone() for k, p in R.named_parameters()}
            step = make(G, None, R, copy.deepcopy(R),
                        torch.optim.SGD(R.parameters(), lr=TRAIN_REF_LR),
                        cfg, cond_drop=0.5, self_cond=True)
            t0 = time.perf_counter()
            with tf32_on() if tf32 else contextlib.nullcontext():
                loss = float(step(wav.to(d), tmask=tmask, t=t, eps=eps,
                                  keep=keep, sc_first_pass=True)["loss_R"])
            secs = time.perf_counter() - t0
            torch.backends.cudnn.deterministic = False
            runs[where] = (loss, {"R": {k: (p.detach() - before[k]).cpu()
                                        for k, p in R.named_parameters()}},
                           secs)
        lc, uc, sc = runs["cpu"]
        for other in ("card", "card, TF32 on"):
            lo, uo, so = runs[other]
            loss_rel = abs(lo - lc) / abs(lc)
            table, worst, worst_net = _update_errors(uc, uo)
            ok = (loss_rel < TRAIN_REF_LOSS_BOUND and worst < TRAIN_REF_BOUND
                  and worst_net < TRAIN_REF_NET_BOUND)
            w = max(table, key=lambda r: r["of_net_max"])
            log(f"[train refiner reference] {domain}, {other} vs cpu: step "
                f"{so:.2f} s (cpu {sc:.2f} s); loss {lo:.6f} vs {lc:.6f}, "
                f"|Δ|/|cpu| {loss_rel:.2e} (bound {TRAIN_REF_LOSS_BOUND:g}); "
                f"max|Δ update| / max|update| worst {worst:.3e} over "
                f"{sum(r['bounded'] for r in table)} tensors (bound "
                f"{TRAIN_REF_BOUND:g}); max|Δ| / R's largest update worst "
                f"{worst_net:.3e} (bound {TRAIN_REF_NET_BOUND:g}) in "
                f"{w['tensor']}: {'within' if ok else 'outside'} the bounds")
            if other == "card":
                require(ok, f"[train refiner reference] {domain}: the card's "
                        f"step disagrees with the CPU's")


def phase_eval_trained(dev, ckpt: str, name: str) -> int:
    """The eval CLI on the Rs that [train refiner] trained: the EMA
    (net_R) and the raw weights (net_Rraw) in the magnitude domain, on
    the GL kernel, and the complex R. Returns the GL launches."""
    total = 0
    for arm, suffix, extra in EVAL_TRAINED_ARMS:
        args = ["--name", name + suffix, "--checkpoints_dir", ckpt,
                "--gpu_ids", "0", "--results_dir",
                os.path.join(ckpt, "results"), *EVAL_BASE, *extra,
                "--log_results", f"chip_eval_trained_{arm}"]
        _, launches = eval_arm(f"(port-trained {arm}) {' '.join(extra)}",
                               args, 40)
        require((launches > 0) == (arm != "complex"),
                f"[eval] (port-trained {arm}) {launches} GL launches")
        total += launches
    return total


def phase_times_train_refiner(dev, card: str) -> dict:
    """Steps/s and clips/s of the refiner's train step at batch 32 (CUDA
    events over TRAIN_TIMED_STEPS steps after 3 of warm-up), both
    domains, bf16 and float32, self-conditioning off and on (the coin
    on its first-pass side: one more R forward); the rate from the
    shapes' FLOPs: G's frozen forward and R's forward and backward
    (3 forwards), plus the first pass under self-conditioning; peak
    memory. One bf16 magnitude step under torch.profiler."""
    from viai_tpu_torch.train.diffusion import (
        make_complex_refiner_train_step, make_refiner_train_step)
    from viai_tpu_torch.train.schedules import adam, cosine

    tag = f"({torch.cuda.get_device_name(0)}, {card.split(',')[-1].strip()})"
    cfg, B = TrainConfig(), REFINER_BATCH
    wav = tones(B, seed=900, device=dev)
    res = {}
    for dtype in ("bfloat16", "float32"):
        G = define_G(dtype=dtype)
        g_gf = conv_gflop(G, torch.zeros(1, 2, 256, 256, device=dev))
        for domain, make in (("mag", make_refiner_train_step),
                             ("complex", make_complex_refiner_train_step)):
            for sc in (False, True):
                r_in, r_out = ((4 + sc, 1) if domain == "mag" else
                               complex_refiner_channels(2, self_cond=sc))
                R = define_R(r_in, 64, dtype=dtype, out_channels=r_out,
                             seed=3, device=dev)
                r_gf = conv_gflop(R, torch.zeros(1, r_in, 256, 256,
                                                 device=dev),
                                  torch.zeros(1, device=dev))
                opt = adam(R.parameters(), cosine(2e-4, 10000, 0, 1,
                                                  alpha=0.1), beta1=0.9)
                step = make(G, None, R, copy.deepcopy(R), opt, cfg,
                            self_cond=sc)
                gen = torch.Generator(device=dev).manual_seed(0)

                def run():
                    return step(wav, gen, sc_first_pass=True if sc else None)

                for _ in range(3):
                    run()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                ms = time_ms(run, TRAIN_TIMED_STEPS, warmup=0)
                peak = torch.cuda.max_memory_allocated() / 2**30
                gf = B * (g_gf + r_gf * (4 if sc else 3))
                log(f"[times train refiner] {domain} {dtype} self_cond "
                    f"{'on' if sc else 'off'}: {ms:.2f} ms a step, "
                    f"{1e3 / ms:.2f} steps/s, {B * 1e3 / ms:.1f} clips/s at "
                    f"batch {B}; R {r_gf:.2f} GFLOP a clip a forward, G "
                    f"{g_gf:.2f}; {gf / 1e3:.2f} TFLOP a step -> "
                    f"{gf / ms:.1f} TFLOP/s; peak allocated {peak:.2f} GiB "
                    f"{tag}")
                res[(domain, dtype, sc)] = dict(ms=ms, tflops=gf / ms,
                                                peak_gib=peak)
                if (domain, dtype, sc) == ("mag", "bfloat16", False):
                    profile_step(run, "profile train refiner", tag)
                del R, opt, step
        del G
    return res

# ---------------------------------------------------------------------------
# The bench entry point and the mesh
# ---------------------------------------------------------------------------

def phase_bench(dev) -> int:
    """`viai_tpu_torch.bench.main` once per preset (BENCH_RUNS), each
    JSON line checked; returns the GL kernel's launches over the runs
    (the default preset's CUDA graph counts its launches at each
    replay)."""
    from viai_tpu_torch import bench

    zero_counts()
    lines = []
    for preset, flags in BENCH_RUNS:
        t0 = time.perf_counter()
        res = bench.main(["--preset", preset, *flags])
        wall = time.perf_counter() - t0
        for k in ("value", "preset", "batch", "dtype", "gl_iters",
                  "refine_chunk", "inner", "graph", "card", "power_limit_w",
                  "samples_clips_per_sec", "plateau_spread_pct"):
            require(k in res, f"[bench] {preset}: no {k!r} in the JSON line")
        require(np.isfinite(res["value"]) and res["value"] > 0,
                f"[bench] {preset}: bad value {res['value']}")
        require(res["preset"] == preset and res["dtype"] == "bfloat16",
                f"[bench] {preset}: wrong preset or dtype")
        require(res["graph"] == (preset in bench.GRAPH_PRESETS
                                 and res["inner"] > 1),
                f"[bench] {preset}: graph {res['graph']}")
        log(f"[bench] {preset} batch {res['batch']} inner {res['inner']} "
            f"graph {res['graph']}: {res['value']:.2f} clips/s/card "
            f"(plateau {res['n_plateau']}/{res['n_samples']} samples, "
            f"spread {res['plateau_spread_pct']:.2f}%; {wall:.1f} s wall "
            f"incl. set-up) ({res['card']}, {res['power_limit_w']} W)")
        lines.append(res)
    OUT_DIR.mkdir(exist_ok=True)
    with open(OUT_DIR / "bench.jsonl", "w") as f:
        for res in lines:
            f.write(json.dumps(res) + "\n")
    launches, plain = griffin_lim_cuda.launches, griffin_lim.calls
    log(f"[bench] griffin_lim_cuda launches {launches}, plain griffin_lim "
        f"calls {plain}")
    require(launches > 0, "[bench] never launched the GL kernel")
    require(plain == 0, "[bench] ran the plain griffin_lim")
    return launches


def phase_bench_reference(dev):
    """Each preset's bf16 chain on the card against its float32 chain on
    the CPU: the same weights (R with its zero-init layers drawn), clips,
    gap masks (one CPU generator) and injected refiner noise, GL×1,
    bounded by BENCH_REF_BOUNDS. The complex presets (16 steps × 8
    samples of full-width R on the CPU) at 2 clips, the others at bucket
    8. The card also runs the float32 chain and, for the refiner
    presets, bf16 G with float32 R and float32 G with bf16 R, printed
    beside (not bounded)."""
    from viai_tpu_torch import bench
    from viai_tpu_torch.train.diffusion import RefineNoise

    cfg = TrainConfig()
    for preset in bench.PRESETS:
        n = 8 if preset in ("default", "refiner_mag") else 2
        args = bench.parse_args(["--preset", preset, "--gl_iters", "1",
                                 "--device", "cpu"])
        g32 = define_G(device="cpu")
        r32 = noise = None
        if preset != "default":
            r_in, r_out = ((4, 1) if preset == "refiner_mag"
                           else complex_refiner_channels(2))
            r32 = perturbed_R(r_in, r_out)
            k = 1 if preset == "refiner_mag" else 8
            g = torch.Generator().manual_seed(11)
            noise = [RefineNoise(torch.randn((n, r_out, 256, 256),
                                             generator=g))
                     for _ in range(k)]
        wav = tones(n, seed=21, device="cpu")

        def run(g_dtype, r_dtype, where):
            G = define_G(dtype=g_dtype, device=where)
            G.load_state_dict(g32.state_dict())
            R = None
            if r32 is not None:
                R = define_R(r_in, 64, dtype=r_dtype, out_channels=r_out,
                             device=where)
                R.load_state_dict(r32.state_dict())
            return bench.build_infer(preset, G, R, cfg, args)(
                wav.to(where), torch.Generator().manual_seed(0),
                noise=noise).cpu()

        ref = run("float32", "float32", "cpu")
        arms = [("bf16", "bfloat16", "bfloat16"),
                ("float32", "float32", "float32")]
        if r32 is not None:
            arms += [("bf16 G, float32 R", "bfloat16", "float32"),
                     ("float32 G, bf16 R", "float32", "bfloat16")]
        bound = BENCH_REF_BOUNDS[preset]
        for name, g_dtype, r_dtype in arms:
            out = run(g_dtype, r_dtype, dev)
            require(bool(torch.isfinite(out).all()), f"[bench reference] "
                    f"{preset}: non-finite output")
            err = float((out - ref).abs().max()) / float(ref.abs().max())
            if name == "bf16":
                log(f"[bench reference] {preset}: bf16 chain on the card vs "
                    f"float32 on the CPU, {n} clips GL×1: max|Δ|/max|ref| "
                    f"{err:.3e} (bound {bound:g})")
                require(err < bound, f"[bench reference] {preset}: the "
                        "bf16 chain disagrees with the CPU")
            else:
                log(f"[bench reference] {preset}:   {name} on the card: "
                    f"{err:.3e} (not bounded)")


def phase_profile_bench(dev, card: str):
    """One default-preset chain call at batch 128 in bf16 under
    utils/profiling.trace: the device's busy share of the call's wall
    time, the largest kernel rows, and the elementwise share (PyTorch's
    `elementwise_kernel` rows) of the device time."""
    from viai_tpu_torch import bench
    from viai_tpu_torch.utils.profiling import trace

    args = bench.parse_args(["--batch", "128"])
    G, _ = bench.build_nets("default", args.dtype, dev)
    infer = bench.build_infer("default", G, None, TrainConfig(), args)
    gen = torch.Generator(device=dev).manual_seed(0)
    wav = tones(128, seed=31, device=dev)
    infer(wav, gen)
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as logdir, trace(logdir) as prof:
        t0 = time.perf_counter()
        infer(wav, gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    tag = f"({torch.cuda.get_device_name(0)}, {card.split(',')[-1].strip()})"
    if not rows:
        log("[profile bench] no device time in the trace: not measured")
        return
    total = sum(e.self_device_time_total for e in rows)
    elem = sum(e.self_device_time_total for e in rows
               if "elementwise_kernel" in e.key)
    log(f"[profile bench] default, batch 128, bf16: device busy "
        f"{total / 1e3:.2f} ms of {wall_ms:.2f} ms wall "
        f"({total / 1e3 / wall_ms:.1%}; profiler on); elementwise kernels "
        f"{elem / 1e3:.2f} ms ({elem / total:.1%} of the device time) {tag}")
    rows.sort(key=lambda e: -e.self_device_time_total)
    for e in rows[:12]:
        log(f"[profile bench]   {e.self_device_time_total / 1e3:8.3f} ms "
            f"{e.self_device_time_total / total:6.1%} x{e.count:<4d} "
            f"{e.key[:90]}")


def phase_mesh(dev) -> int:
    """A 1-rank NCCL group from a file store: make_mesh() is 1x1; one
    tiny SGD GAN step through make_train_step(mesh=...) equals the step
    without a mesh, and InpaintService(mesh=...) at bucket 8 (full
    width, GL×32) the service without one, bit for bit; shard_params at
    n_model 1 is replicate. Returns the GL launches of the mesh
    service's request."""
    import torch.distributed as dist

    from viai_tpu_torch.testing import TINY_CFG, tiny_models, tone_batch
    from viai_tpu_torch.train import init_state, make_train_step
    from viai_tpu_torch.train.mesh import (global_batch_from_local,
                                           make_mesh,
                                           maybe_initialize_distributed,
                                           shard_params)

    with tempfile.TemporaryDirectory() as tmp:
        require(maybe_initialize_distributed(f"file://{tmp}/store", 1, 0,
                                             device="cuda"),
                "[mesh] no process group")
        try:
            mesh = make_mesh()
            require(mesh.shape == {"data": 1, "model": 1}
                    and mesh.distributed and mesh.device.type == "cuda",
                    f"[mesh] make_mesh() gave {mesh.shape} on {mesh.device}")
            # G's transposed convolutions run cuDNN's backward-data
            # algorithms, whose default ones sum with atomics.
            torch.backends.cudnn.deterministic = True
            wav = torch.from_numpy(tone_batch(4, seed=3))
            runs = []
            for m in (None, mesh):
                G, D, _ = tiny_models(seed=0, device=dev)
                g_opt = torch.optim.SGD(G.parameters(), lr=0.1)
                d_opt = torch.optim.SGD(D.parameters(), lr=0.05)
                if m is not None:
                    placed = shard_params({"G": G, "D": D, "g": g_opt,
                                           "d": d_opt}, m)
                    require(placed["g"] is g_opt and placed["d"] is d_opt,
                            "[mesh] shard_params at n_model 1 wrapped an "
                            "optimizer")
                    x = global_batch_from_local(wav, m)
                else:
                    x = wav.to(dev)
                step = make_train_step(G, D, None, g_opt, d_opt, TINY_CFG,
                                       mesh=m)
                met = step(init_state(D, TINY_CFG), x,
                           generator=torch.Generator(device=dev).manual_seed(1))
                runs.append(([p.detach().clone() for p in
                              [*G.parameters(), *D.parameters()]],
                             {k: float(v) for k, v in met.items()}))
            same = all(torch.equal(a, b) for a, b in zip(runs[0][0],
                                                          runs[1][0]))
            log(f"[mesh] 1-rank NCCL group, mesh {mesh.shape}: tiny SGD "
                f"step with the mesh == without: {same} (losses "
                f"{runs[1][1]['loss_G']:.6f} / {runs[0][1]['loss_G']:.6f})")
            require(same and runs[0][1] == runs[1][1],
                    "[mesh] the step under the mesh differs")
            G0 = define_G(device="cpu")
            wavs = tones(8, seed=41, device="cpu").numpy()
            outs = {}
            for m in (None, mesh):
                svc = InpaintService(card_copy(G0, dev), TrainConfig(),
                                     buckets=(8,), gl_iters=32, device=dev,
                                     mesh=m)
                zero_counts()
                t0 = time.perf_counter()
                outs[m is not None] = svc.inpaint(
                    wavs, gap_start_s=GAP_S[0], gap_end_s=GAP_S[1])
                if m is not None:
                    launches = read_launches("mesh", svc,
                                             time.perf_counter() - t0)
            same = np.array_equal(outs[True], outs[False])
            log(f"[mesh] InpaintService(mesh=...) bucket 8, GL×32 == "
                f"without: {same} (max|Δ| "
                f"{np.abs(outs[True] - outs[False]).max():.3e})")
            require(same, "[mesh] the service under the mesh differs")
        finally:
            torch.backends.cudnn.deterministic = False
            dist.destroy_process_group()
    require(not dist.is_initialized(), "[mesh] the group was not torn down")
    return launches


def _records(results_dir: str) -> list[dict]:
    with open(os.path.join(results_dir, "quality_results.jsonl")) as f:
        return [json.loads(line) for line in f]


def _state_equal(a, b) -> bool:
    """Nested dicts, lists and tensors equal to the bit."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_state_equal(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(_state_equal(x, y) for x, y in zip(a, b)))
    if torch.is_tensor(a):
        return (torch.is_tensor(b) and a.dtype == b.dtype
                and torch.equal(a.cpu(), b.cpu()))
    return a == b


def write_raw_avi(path: pathlib.Path, seconds: float, sr: int, seed: int):
    """An uncompressed AVI of `seconds` with PCM16 audio at `sr` (three
    tones) and 48x64 random frames at 10 fps."""
    from viai_tpu_torch.data.avi import write_avi

    rng = np.random.default_rng(seed)
    n = int(seconds * sr)
    t = np.arange(n) / sr
    audio = sum(0.2 * np.sin(2 * np.pi * f * t + p) for f, p in
                zip(rng.uniform(100, 2000, 3), rng.uniform(0, 6, 3)))
    frames = rng.integers(0, 256, (int(seconds * 10), 48, 64, 3),
                          dtype=np.uint8)
    write_avi(str(path), frames, 10, audio.astype(np.float32), sr)


def io_capture(fn) -> str:
    """What fn() prints."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
    return buf.getvalue()


def phase_scripts(dev, card: str) -> int:
    """The JAX package's scripts, ported, at full width through their
    entry points (viai_tpu_torch.scripts.<name>.main), steps cut
    (SCRIPT_CUTS): hole-PSNRs and losses finite, every record written
    with "package" under --results_dir; quality_long's step-10 state
    loaded bit for bit, its step-20 nets served by cli.test and
    diagnosed by grid_diag; define_G()'s FLOPs read by cost_analysis;
    prepare_dataset's modes, and 5 train steps from the folder it
    prepared. Returns the GL kernel's launches over the phase."""
    from viai_tpu_torch.cli.test import main as test_main
    from viai_tpu_torch.cli.train import main as train_main
    from viai_tpu_torch.io import load_networks, load_train_state
    from viai_tpu_torch.scripts import (av_ablation, bayes_ceiling,
                                        cost_analysis, grid_diag,
                                        prepare_dataset, quality_long,
                                        quality_report)

    # The eval phase points the port's records at its own file.
    os.environ.pop("VIAI_RESULTS_JSONL", None)
    zero_counts()
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        res = os.path.join(tmp, "results")
        for name, cut in SCRIPT_CUTS.items():
            log(f"[scripts] cut: {name} {' '.join(cut)} (its defaults "
                f"otherwise)")

        for name in ("quality_report", "quality_report long_gap"):
            t0 = time.perf_counter()
            rec = quality_report.main(SCRIPT_CUTS[name]
                                      + ["--results_dir", res])
            log(f"[scripts] {name}: hole-PSNR {rec['hole_psnr_before']:.3f} "
                f"-> {rec['hole_psnr_after']:.3f} dB, L1 {rec['final_l1']}, "
                f"{time.perf_counter() - t0:.1f} s; train "
                f"{rec['train_clips_per_s']} clips/s at batch {rec['batch']}, "
                f"bf16, first step included | {card}")
            require(np.isfinite(rec["hole_psnr_before"])
                    and np.isfinite(rec["hole_psnr_after"]),
                    f"[scripts] {name}: a non-finite hole-PSNR")

        t0 = time.perf_counter()
        rec = av_ablation.main(SCRIPT_CUTS["av_ablation"]
                               + ["--results_dir", res])
        for v in ("audio", "av"):
            log(f"[scripts] av_ablation {v}: hole-PSNR "
                f"{rec[f'{v}_hole_psnr']:.3f} dB, L1 {rec[f'{v}_final_l1']}; "
                f"train {rec[f'{v}_train_clips_per_s']} clips/s at batch "
                f"{rec['batch']}, bf16, first step included | {card}")
            require(np.isfinite(rec[f"{v}_hole_psnr"]),
                    f"[scripts] av_ablation {v}: a non-finite hole-PSNR")
        log(f"[scripts] av_ablation: {time.perf_counter() - t0:.1f} s")

        ckpt = os.path.join(tmp, "ckpt")
        ql = ["--name", "chip_ql", "--checkpoints_dir", ckpt,
              "--results_dir", res, *SCRIPT_CUTS["quality_long"]]
        t0 = time.perf_counter()
        rec = quality_long.main(ql)
        log(f"[scripts] quality_long: L1 {rec['final_l1']}, "
            f"{time.perf_counter() - t0:.1f} s; train "
            f"{rec['train_clips_per_s']} clips/s at batch {rec['batch']}, "
            f"bf16, pool {rec['pool_clips']} clips, two milestone saves and "
            f"the first step included | {card}")
        require(np.isfinite(rec["final_l1"]), "[scripts] quality_long L1")
        expr = rec["expr_dir"]
        args, extra = quality_long.parse_args(ql)
        model = quality_long.build_model(args, extra)
        model.load_networks("10")
        saved = load_train_state("10", expr)
        same = {name: _state_equal(net.state_dict(), saved["nets"][name])
                for name, net in model._nets().items()}
        for name, net in model._nets().items():       # the .pth schema
            twin = copy.deepcopy(net)
            load_networks({name: twin}, "10", expr)
            same[f"{name}.pth"] = _state_equal(net.state_dict(),
                                               twin.state_dict())
        same["g_opt"] = _state_equal(model.g_opt.state_dict(),
                                     saved["g_opt"])
        same["d_opt"] = _state_equal(model.d_opt.state_dict(),
                                     saved["d_opt"])
        same["step"] = model.state["step"] == saved["step"] == 10
        log(f"[scripts] quality_long --resume_step 10: the loaded state "
            f"equals the step-10 save to the bit: {same}")
        require(all(same.values()), "[scripts] the resumed state differs")
        del model
        rec = quality_long.main(ql + ["--resume_step", "10"])
        require(rec["resume_step"] == 10 and np.isfinite(rec["final_l1"]),
                "[scripts] quality_long resume")
        log(f"[scripts] quality_long resumed 10 -> 20: L1 {rec['final_l1']}")
        summary = test_main([
            "--name", "chip_ql", "--checkpoints_dir", ckpt, "--which_epoch",
            "20", "--gpu_ids", "0", "--dataset_mode", "synthetic",
            "--how_many", str(SCRIPTS_EVAL_CLIPS), "--batchSize",
            str(SCRIPTS_EVAL_CLIPS), "--results_dir", res])
        log(f"[scripts] cli.test on quality_long's 20_net_G: n "
            f"{summary['n']}, hole-PSNR {summary['hole_psnr_mean']:.3f} dB, "
            f"SNR {summary['snr_mean']:.3f} dB")
        require(summary["n"] == SCRIPTS_EVAL_CLIPS
                and np.isfinite(summary["hole_psnr_mean"]),
                "[scripts] cli.test on quality_long's nets")
        rec = grid_diag.main(["chip_ql", ckpt, "20", "", "harmonic", "0",
                              "--results_dir", res])
        require(all(np.isfinite(rec[k]) for k in (
            "pre_gl_hole_psnr_eval_unseen", "pre_gl_hole_psnr_train_pool")),
            "[scripts] grid_diag")

        t0 = time.perf_counter()
        rec = bayes_ceiling.main(SCRIPT_CUTS["bayes_ceiling"]
                                 + ["--log_results", "--results_dir", res])
        log(f"[scripts] bayes_ceiling: ceiling "
            f"{rec['ceiling_hole_psnr_mean']} dB, sample "
            f"{rec['sample_hole_psnr_mean']} dB, "
            f"{time.perf_counter() - t0:.1f} s")
        require(np.isfinite(rec["ceiling_hole_psnr_mean"]),
                "[scripts] bayes_ceiling")

        rec = cost_analysis.main(["--batch", "128", "--results_dir", res])
        g_fwd = rec["programs"][0]["gflops_by_module"]["UNetGenerator"]
        log(f"[scripts] cost_analysis --batch 128: G forward "
            f"{g_fwd:.2f} GFLOP = 128 x {g_fwd / 128:.4f}; the chain "
            f"{rec['programs'][1]['gflops']} GFLOP with "
            f"{rec['programs'][1]['gl_launches']} GL launch(es); the train "
            f"step {rec['programs'][2]['gflops']} GFLOP")
        require(abs(g_fwd / 128 - G_GFLOP_CLIP) < 0.01,
                f"[scripts] cost_analysis: G reads {g_fwd / 128:.4f} GFLOP "
                f"a clip, not {G_GFLOP_CLIP}")
        require(rec["programs"][1]["gl_launches"] == 1,
                "[scripts] cost_analysis: the chain's GL launch")

        data, raw = pathlib.Path(tmp) / "data", pathlib.Path(tmp) / "raw"
        raw.mkdir()
        write_raw_avi(raw / "clip_22k.avi", 3.0, 22050, seed=9)
        (raw / "clip.mp4").write_bytes(b"\0" * 64)
        pd = ["--results_dir", res]
        prepare_dataset.main(["synthetic", "--out", str(data), "-n",
                              str(TRAIN_BATCH), "--video", *pd])
        rec = prepare_dataset.main(["extract", "--root", str(raw), "--out",
                                    str(data), *pd])
        require((rec["clips"], rec["skipped"]) == (1, 1),
                f"[scripts] prepare_dataset extract: {rec}")
        require(os.path.exists(data / "clip_22k.wav")
                and np.load(data / "clip_22k.npy").shape == (16, 64, 64, 3),
                "[scripts] prepare_dataset extract's files")
        rec = prepare_dataset.main(["manifest", "--root", str(data), *pd])
        log(f"[scripts] prepare_dataset: synthetic {TRAIN_BATCH} clips with "
            f"frames, extract (AVI at 22.05 kHz read, .mp4 skipped), "
            f"manifest {rec['train']} train / {rec['test']} test")
        manifest = raw / "yt.json"
        manifest.write_text(json.dumps(
            {"train": ["vid0", {"id": "vid1", "start": 1, "end": 3}]}))
        out = io_capture(lambda: prepare_dataset.main([
            "download", "--manifest", str(manifest), "--out",
            str(raw / "dl"), "--dry_run", *pd]))
        log("[scripts] prepare_dataset download --dry_run: "
            + " | ".join(out.strip().splitlines()))
        require(out.strip().endswith("# 3 commands (dry run)"),
                "[scripts] the download plan")
        model = train_main([
            "--name", "chip_prepared", "--checkpoints_dir", ckpt,
            "--gpu_ids", "0", "--dataset_mode", "av", "--model", "av",
            "--dataroot", str(data), "--batchSize", str(TRAIN_BATCH),
            "--nThreads", "0", "--niter", "1", "--niter_decay", "0",
            "--steps_per_epoch", "5", "--print_freq", "5",
            "--display_freq", "1000"])
        losses = model.get_current_losses()
        log(f"[scripts] 5 av train steps from the prepared folder: "
            + " ".join(f"{k} {v:.4f}" for k, v in losses.items()))
        require(all(np.isfinite(v) for v in losses.values()),
                "[scripts] training from the prepared folder")

        recs = _records(res)
        exps = sorted({r.get("exp", "quality_report") for r in recs})
        log(f"[scripts] {len(recs)} records in results/quality_results.jsonl"
            f" ({', '.join(exps)}), each with package viai_tpu_torch")
        require(len(exps) == 7 and all(r["package"] == "viai_tpu_torch"
                                       for r in recs),
                "[scripts] the records")
    torch.cuda.synchronize()
    launches, plain = griffin_lim_cuda.launches, griffin_lim.calls
    log(f"[scripts] {time.perf_counter() - t_phase:.1f} s; griffin_lim_cuda "
        f"launches {launches}, plain griffin_lim calls {plain}")
    require(launches > 0, "[scripts] never launched the GL kernel")
    require(plain == 0, "[scripts] ran the plain griffin_lim")
    return launches


def phase_tensorboard():
    """[tensorboard]: the train CLI with --tensorboard, one loss record a
    step; the event files read back with the port's CRC-checking reader
    hold every loss tag at steps 1..TB_STEPS with loss_log.jsonl's
    values (float32)."""
    from viai_tpu_torch.cli.train import main as train_main
    from viai_tpu_torch.utils.tensorboard import read_scalars

    with tempfile.TemporaryDirectory() as ckpt:
        t0 = time.perf_counter()
        train_main(["--name", "chip_tb", "--checkpoints_dir", ckpt,
                    "--gpu_ids", "0", "--batchSize", str(TRAIN_BATCH),
                    "--niter", "1", "--niter_decay", "0",
                    "--steps_per_epoch", str(TB_STEPS), "--print_freq", "1",
                    "--display_freq", "1000", "--tensorboard"])
        expr = os.path.join(ckpt, "chip_tb")
        with open(os.path.join(expr, "loss_log.jsonl")) as f:
            want = sorted(
                (k, step, float(np.float32(v)))
                for step, r in enumerate(map(json.loads, f), start=1)
                for k, v in r.items() if k.startswith("loss"))
        files = os.listdir(os.path.join(expr, "tb"))
        got = sorted(t for name in files
                     for t in read_scalars(os.path.join(expr, "tb", name)))
        tags = sorted({t for t, _, _ in got})
        log(f"[tensorboard] {TB_STEPS} train steps with --tensorboard in "
            f"{time.perf_counter() - t0:.1f} s: {len(files)} event file, "
            f"{len(got)} scalars, tags {tags}, steps "
            f"{min(s for _, s, _ in got)}..{max(s for _, s, _ in got)}; "
            f"equal to loss_log.jsonl: {got == want}")
        require(len(files) == 1 and len(want) >= 4 * TB_STEPS and got == want,
                "[tensorboard] the event file differs from loss_log.jsonl")


_NO_CACHE_PROBE = """
import json
from viai_tpu_torch import _build
from viai_tpu_torch.utils import compile_cache
d = compile_cache.enable()
r = _build.build(["griffin_lim"])["griffin_lim"]
print(json.dumps({"dir": str(d), "path": str(r.path), "seconds": r.seconds}))
"""


def phase_compile_cache():
    """[compile cache]: VIAI_CACHE_DIR relocates the GL kernel's build
    (built there, then reused: 0.0 s); under VIAI_NO_CACHE=1 a fresh
    process builds it anew in a directory of its own."""
    from viai_tpu_torch.utils import compile_cache

    with tempfile.TemporaryDirectory() as d:
        os.environ["VIAI_CACHE_DIR"] = d
        try:
            where = compile_cache.enable()
            first = _build.build(["griffin_lim"])["griffin_lim"]
            again = _build.build(["griffin_lim"])["griffin_lim"]
        finally:
            del os.environ["VIAI_CACHE_DIR"]
            _build.set_cache_dir(None)
        log(f"[compile cache] VIAI_CACHE_DIR: enable() -> the temp dir: "
            f"{where == pathlib.Path(d)}; griffin_lim built there in "
            f"{first.seconds:.2f} s, loaded again in {again.seconds} s")
        require(where == pathlib.Path(d) and first.path.parent == where
                and first.seconds > 0.0 and again.seconds == 0.0
                and again.path == first.path, "[compile cache] relocation")
    root = pathlib.Path(__file__).resolve().parent
    out = subprocess.run(
        [sys.executable, "-c", _NO_CACHE_PROBE], cwd=root,
        env={**os.environ, "VIAI_NO_CACHE": "1"}, capture_output=True,
        text=True, timeout=600, check=True)
    probe = json.loads(out.stdout.strip().splitlines()[-1])
    fresh = pathlib.Path(probe["dir"])
    log(f"[compile cache] VIAI_NO_CACHE=1: a fresh process built "
        f"griffin_lim in {probe['seconds']:.2f} s into "
        f"{fresh.relative_to(root)} (removed at its exit: "
        f"{not fresh.exists()})")
    require(probe["seconds"] > 0.0 and fresh.parent == _build.BUILD_DIR
            and pathlib.Path(probe["path"]).parent == fresh
            and not fresh.exists(), "[compile cache] VIAI_NO_CACHE")


def main():
    card = phase_device()
    dev = torch.device("cuda")
    phase_build()
    max_err = phase_kernel(dev)
    svc, launches_slice = phase_slice(dev)
    phase_reference(svc, dev)
    av, launches_av = phase_av(dev)
    launches_options = phase_options(dev)
    refiner, launches_refiner = phase_refiner(dev)
    phase_refiner_reference(refiner, dev)
    with tempfile.TemporaryDirectory() as ckpt:
        trains = {kind: phase_train(dev, kind, ckpt) for kind in TRAIN_MODELS}
        launches_eval = phase_eval(dev, ckpt, "chip_audio")
        launches_data = phase_data(dev, ckpt, card)
        phase_train_refiner(dev, ckpt, "chip_audio")
        launches_trained = phase_eval_trained(dev, ckpt, "chip_audio")
    phase_train_reference(dev)
    phase_train_refiner_reference(dev)
    times = phase_times(svc, dev, card)
    phase_times_av(av, dev, card)
    for kind in TRAIN_MODELS:
        phase_times_train(dev, card, kind)
    phase_times_refiner(dev, card)
    phase_times_train_refiner(dev, card)
    phase_profile(svc, card)
    phase_profile(av, card, "profile av")
    launches_bench = phase_bench(dev)
    phase_bench_reference(dev)
    phase_profile_bench(dev, card)
    launches_mesh = phase_mesh(dev)
    t_new = time.perf_counter()
    launches_scripts = phase_scripts(dev, card)
    phase_tensorboard()
    phase_compile_cache()
    log(f"[scripts] [tensorboard] [compile cache] took "
        f"{time.perf_counter() - t_new:.1f} s together")
    t = times[32]
    launches_train = sum(r["launches"] for r in trains.values())
    launches_served = sum(r["served"] for r in trains.values())
    print(json.dumps({"kernels": [{
        "name": "griffin_lim", "route": "cuda",
        "source": "viai_tpu_torch/csrc/griffin_lim.cu",
        "replaces": "viai_tpu/signal/pallas_gl.py:632",
        "launches": (launches_slice + launches_av + launches_options
                     + launches_train + launches_served + launches_refiner
                     + launches_eval + launches_data + launches_trained
                     + launches_bench + launches_mesh + launches_scripts),
        "launches_by_path": {"slice": launches_slice, "av": launches_av,
                             "options": launches_options,
                             "train": launches_train,
                             "train_served": launches_served,
                             "refiner": launches_refiner,
                             "eval": launches_eval, "data": launches_data,
                             "refiner_trained": launches_trained,
                             "bench": launches_bench, "mesh": launches_mesh,
                             "scripts": launches_scripts},
        "max_abs_err": max_err,
        "ms": t["kernel_ms"], "kernel_ms": t["kernel_ms"],
        "kernel_only_ms": t["kernel_only_ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_tc_ms": t["bound_tc_ms"], "bound_simt_ms": t["bound_simt_ms"],
        "bound_by": t["bound_by"], "library_ms": None,
        "batch": 32, "n_iter": 32,
    }]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
