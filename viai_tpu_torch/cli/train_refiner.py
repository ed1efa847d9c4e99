"""Train the diffusion refiner R against a frozen G — stage 2.

Port of `scripts/train_refiner.py`, same flags, names and defaults:
load G exactly as the eval CLI builds it (TestOptions with --dtype
bfloat16, VIAIModel, load_networks), build R (define_R at seed + 3, in
G's dtype), and train it on a pool of --pool_batches synthetic batches
kept on the device, with Adam (β1 0.9, β2 0.999) over a cosine decay of
the lr to 0.1 of it in --steps updates and an EMA of R's weights.
Every --milestone steps: `{step}_net_R.pth` (the EMA, which serving
reads) and `{step}_net_Rraw.pth` (the raw weights) in the JAX package's
schema, into G's run directory, and `R{step}_state.pt` (R, Adam with
its count, the EMA) for --resume_step; at the end the `latest` pair.
Then one JSON record goes where the eval CLI writes its records.

    python -m viai_tpu_torch.cli.train_refiner --name exp \\
        --checkpoints_dir ckpt --steps 10000 --batch 32
    python -m viai_tpu_torch.cli.test --name exp --checkpoints_dir ckpt \\
        --refiner --refiner_net R

Flags this script does not define go to TestOptions and must match G's
training (e.g. --n_fft, --clip_seconds, --dtype); --gpu_ids -1 trains
on the CPU, otherwise the card. G is the audio-only model (--model
audio), as in the JAX script.

Step i draws its randomness from generators seeded from (seed + 2, i)
(`train/diffusion.py::sample_generator`): the gap masks, t, ε and the
cond_drop keep on the device, the self-conditioning coin on the host.
A run resumed from `R{k}_state.pt` therefore repeats the uninterrupted
run from step k on (the JAX script folds its key by the start step and
draws another stream).
"""

from __future__ import annotations

import argparse
import copy
import json
import time

import torch

from ..config.options import TestOptions
from ..data.synthetic import SyntheticBatchIterator, SyntheticConfig
from ..io import load_train_state, save_networks, save_train_state
from ..io.results import append_record
from ..model import VIAIModel
from ..nn import define_R
from ..train.diffusion import (complex_refiner_channels,
                               make_complex_refiner_train_step,
                               make_refiner_train_step, sample_generator)
from ..train.schedules import adam, cosine
from ..utils.compile_cache import enable as enable_build_cache


def parse_args(args=None) -> tuple[argparse.Namespace, list[str]]:
    """The script's own flags, and the rest (for TestOptions)."""
    ap = argparse.ArgumentParser(
        description="Stage-2 diffusion-refiner training against a frozen "
                    "G checkpoint; other flags go to TestOptions.")
    ap.add_argument("--steps", type=int, default=10000)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--pool_batches", type=int, default=64)
    ap.add_argument("--hole_weight", type=float, default=3.0)
    ap.add_argument("--name", type=str, required=True,
                    help="G experiment name (checkpoint to refine)")
    ap.add_argument("--checkpoints_dir", type=str, required=True)
    ap.add_argument("--which_epoch", type=str, default="latest",
                    help="G checkpoint tag to freeze")
    ap.add_argument("--milestone", type=int, default=5000)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--ema_decay", type=float, default=0.999)
    ap.add_argument("--domain", type=str, default="mag",
                    choices=["mag", "complex"],
                    help="mag: magnitude-image refiner; complex: (re, im) "
                         "compressed-complex refiner (eval with cli.test "
                         "--refiner --refiner_domain complex)")
    ap.add_argument("--observed_weight", type=float, default=1.0,
                    help="v-MSE weight on the observed region; 0 = "
                         "hole-only loss (pair eval with --refine_clamp q)")
    ap.add_argument("--cond_drop", type=float, default=0.0,
                    help="per-sample prob of zeroing the g_pred cond "
                         "channel (classifier-free-guidance training)")
    ap.add_argument("--self_cond", action="store_true",
                    help="self-conditioning: R carries its own previous "
                         "x̂0 as extra input channel(s); eval with cli.test "
                         "--refine_selfcond")
    ap.add_argument("--rngf", type=int, default=64, help="refiner width")
    ap.add_argument("--resume_step", type=int, default=0,
                    help="resume from R{N}_state.pt (R + Adam + EMA); "
                         "continues to --steps")
    ap.add_argument("--seed", type=int, default=0)
    # Corpus and G-architecture flags (must match the frozen G's training).
    ap.add_argument("--notes", action="store_true")
    ap.add_argument("--notes_grid", action="store_true")
    ap.add_argument("--long_gap", action="store_true")
    ap.add_argument("--bottleneck_dilation", type=str, default="")
    ap.add_argument("--bottleneck_attn", type=int, default=0)
    ap.add_argument("--gated", action="store_true")
    ap.add_argument("--phase_head", action="store_true")
    ap.add_argument("--ngf", type=int, default=64)
    return ap.parse_known_args(args)


def main(args=None) -> dict | None:
    """Train R; → the run's record, or None when --resume_step leaves
    nothing to train."""
    enable_build_cache()
    a, extra = parse_args(args)
    style = ("notes_grid" if a.notes_grid else "notes" if a.notes
             else "harmonic")
    opt = TestOptions().parse([
        "--name", a.name, "--checkpoints_dir", a.checkpoints_dir,
        "--dataset_mode",
        "synthetic" + ("" if style == "harmonic" else f"_{style}"),
        "--batchSize", str(a.batch), "--dtype", "bfloat16",
        "--which_epoch", a.which_epoch, "--seed", str(a.seed),
        "--bottleneck_dilation", a.bottleneck_dilation,
        "--bottleneck_attn", str(a.bottleneck_attn), "--ngf", str(a.ngf),
        *(["--gated"] if a.gated else []),
        *(["--phase_head"] if a.phase_head else []),
        *(["--long_gap"] if a.long_gap else []),
        *extra, "--model", "audio"])
    opt.isTrain = False
    model = VIAIModel(opt)
    model.load_networks(a.which_epoch)
    dev, expr_dir = model.device, model.expr_dir

    input_nc = 3 if model.cfg.multi_res else 2
    if a.domain == "complex":
        r_in, r_out = complex_refiner_channels(input_nc,
                                               self_cond=a.self_cond)
    else:
        r_in, r_out = input_nc + 2 + (1 if a.self_cond else 0), 1
    R = define_R(r_in, a.rngf, dtype=opt.dtype, seed=a.seed + 3,
                 out_channels=r_out, device=dev)
    R_ema = copy.deepcopy(R)
    r_opt = adam(R.parameters(), cosine(a.lr, a.steps, 0, 1, alpha=0.1),
                 beta1=0.9, beta2=0.999)
    start = 0
    if a.resume_step:
        if a.resume_step >= a.steps:
            print(f"resume_step {a.resume_step} >= steps {a.steps}: "
                  f"nothing to train", flush=True)
            return None
        st = load_train_state(f"R{a.resume_step}", expr_dir)
        R.load_state_dict(st["R"])
        r_opt.load_state_dict(st["opt"])
        R_ema.load_state_dict(st["ema"])
        start = a.resume_step
        print(f"resumed refiner train state @ {start}", flush=True)

    make_step = (make_complex_refiner_train_step if a.domain == "complex"
                 else make_refiner_train_step)
    step_fn = make_step(model.G, model.V, R, R_ema, r_opt, model.cfg,
                        hole_weight=a.hole_weight,
                        observed_weight=a.observed_weight,
                        cond_drop=a.cond_drop, ema_decay=a.ema_decay,
                        self_cond=a.self_cond)

    it = SyntheticBatchIterator(
        SyntheticConfig(sample_rate=opt.sample_rate,
                        clip_seconds=opt.clip_seconds, style=style),
        batch=a.batch, seed=a.seed + 1)
    try:
        pool = [torch.from_numpy(next(it)["wav"]).to(dev)
                for _ in range(a.pool_batches)]
    finally:
        it.close()
    print(f"pool: {a.pool_batches} x {a.batch} clips on {dev}", flush=True)

    t0 = time.perf_counter()
    losses = {}
    for i in range(start, a.steps):
        coin = None
        if a.self_cond:
            coin = bool(torch.rand((), generator=sample_generator(
                a.seed + 2, i, 1, "cpu")) < 0.5)
        losses = step_fn(pool[i % a.pool_batches],
                         sample_generator(a.seed + 2, i, 0, dev),
                         sc_first_pass=coin)
        step = i + 1
        if step % 500 == 0:
            rate = (step - start) / (time.perf_counter() - t0)
            print(f"step {step}/{a.steps}  v-MSE "
                  f"{float(losses['loss_R']):.5f}  {rate:.1f} steps/s",
                  flush=True)
        if step % a.milestone == 0:
            # The EMA is what serving reads (net_R); the raw weights go
            # beside it (net_Rraw) for an EMA-vs-raw comparison.
            save_networks({"R": R_ema, "Rraw": R}, step, expr_dir)
            save_train_state({"R": R.state_dict(), "opt": r_opt.state_dict(),
                              "ema": R_ema.state_dict(), "step": step},
                             f"R{step}", expr_dir)
            print(f"saved net_R/net_Rraw + R{step}_state @ {step}",
                  flush=True)
    save_networks({"R": R_ema, "Rraw": R}, "latest", expr_dir)
    final = float(losses["loss_R"])
    dt = time.perf_counter() - t0

    rec = {
        "exp": "train_refiner", "package": "viai_tpu_torch",
        "steps": a.steps, "batch": a.batch, "hole_weight": a.hole_weight,
        "notes": a.notes, "notes_grid": a.notes_grid,
        "long_gap": a.long_gap, "g_epoch": a.which_epoch, "rngf": a.rngf,
        "lr": a.lr, "ema_decay": a.ema_decay,
        "observed_weight": a.observed_weight, "cond_drop": a.cond_drop,
        "domain": a.domain, "resume_step": start,
        "final_v_mse": round(final, 6),
        "train_clips_per_s": round((a.steps - start) * a.batch / dt, 1),
        "expr_dir": expr_dir, "t": time.time(),
    }
    append_record(rec, opt.results_dir)
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
