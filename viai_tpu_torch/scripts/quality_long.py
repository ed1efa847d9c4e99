"""Long quality run on a pool of batches kept on the card, saving nets
that cli.test loads.

Port of `scripts/quality_long.py`. It keeps the train CLI's exact model
construction (TrainOptions → VIAIModel, so the saved
`{step}_net_*.pth` load in cli.test as they are) but drives the train
step over --pool_batches synthetic batches copied to the device once:
every step takes a pool batch and fresh gaps and dropout from one
generator (the masks are drawn inside the step, so the data's variety
per step matches the CLI's with a pool this large). Every --milestone
steps: `{step}_net_{G,D[,V]}.pth` and the full train state
`{step}_state.pt`, which --resume_step reads. At the end one JSON
record goes to {--results_dir}/quality_results.jsonl.

    python -m viai_tpu_torch.scripts.quality_long --steps 15000 \\
        --batch 32 --hole_weight 3.0 --name q15k --checkpoints_dir ckpt
    python -m viai_tpu_torch.cli.test --name q15k --checkpoints_dir ckpt \\
        --which_epoch 15000

Flags the script does not define go to TrainOptions (e.g. --ndf,
--n_fft, --clip_seconds; the pool's clips follow --clip_seconds and
--sample_rate). The step's generator is seeded from --seed + 2; a resumed run seeds it
from (--seed + 2, the start step), a stream of its own (the JAX script
folds its key by the start step): a resumed run continues the saved
state, not the uninterrupted run's draws.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..config.options import TrainOptions
from ..data.synthetic import SyntheticBatchIterator, SyntheticConfig
from ..io.results import append_record
from ..model import VIAIModel
from ..utils.compile_cache import enable as enable_build_cache
from ._quality import device_name, gpu_ids


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=15000)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--pool_batches", type=int, default=64,
                    help="device-resident pool size, in batches")
    ap.add_argument("--hole_weight", type=float, default=3.0)
    ap.add_argument("--name", type=str, default="qlong")
    ap.add_argument("--checkpoints_dir", type=str, default="./checkpoints")
    ap.add_argument("--milestone", type=int, default=5000,
                    help="save nets and the train state every N steps")
    ap.add_argument("--long_gap", action="store_true",
                    help="long-gap config: multi-res input, 75-150 frame "
                         "masks (BASELINE config 3)")
    ap.add_argument("--model", type=str, default="audio",
                    choices=["audio", "av"],
                    help="av: vision-infused (synthetic AV pool with "
                         "frames; ~25 MB/batch of frames on the device)")
    ap.add_argument("--notes", action="store_true",
                    help="polyphonic note-event corpus (onsets/decays/"
                         "chords) instead of the sustained-harmonic "
                         "default — the harder inpainting task")
    ap.add_argument("--notes_grid", action="store_true",
                    help="deterministic twin of --notes (beat grid + "
                         "repeating arpeggio): hole contents fully "
                         "inferable from context")
    ap.add_argument("--cue", action="store_true",
                    help="vision-necessary av_cue corpus: the hole is "
                         "audio-ambiguous and only the video "
                         "disambiguates; the mask is pinned to the "
                         "corpus gap. Use with --model av vs --model "
                         "audio for the fusion-edge comparison")
    ap.add_argument("--resume_step", type=int, default=0,
                    help="resume from the {N}_state.pt train state in "
                         "the experiment dir (weights, optimizers, step "
                         "count) and continue to --steps")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lambda_sc", type=float, default=0.0)
    ap.add_argument("--lambda_onset", type=float, default=0.0)
    ap.add_argument("--lambda_fm", type=float, default=0.0)
    ap.add_argument("--lambda_l1", type=float, default=100.0)
    ap.add_argument("--lambda_l2", type=float, default=0.0)
    ap.add_argument("--num_D", type=int, default=1)
    ap.add_argument("--gated", action="store_true")
    ap.add_argument("--phase_head", action="store_true")
    ap.add_argument("--lambda_phase", type=float, default=1.0)
    ap.add_argument("--bottleneck_dilation", type=str, default="")
    ap.add_argument("--bottleneck_attn", type=int, default=0)
    ap.add_argument("--ngf", type=int, default=64,
                    help="generator width; must be repeated at test time")
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--results_dir", type=str, default="results/")
    return ap.parse_known_args(argv)


def corpus_style(args) -> str:
    """The corpus of the flags; every corpus flag is covered (a style
    that fell through to "harmonic" once trained a run on the wrong
    corpus)."""
    return ("av_cue" if args.cue else "notes_grid" if args.notes_grid
            else "notes" if args.notes else "harmonic")


def build_model(args, extra: list[str] = ()) -> VIAIModel:
    """The train CLI's construction for these flags (`extra`: more
    TrainOptions flags)."""
    epochs_total = max(args.steps // args.milestone, 1)
    mode = ("synthetic_av_cue" if args.cue else
            ("synthetic_av" if args.model == "av" else "synthetic")
            + ("_notes_grid" if args.notes_grid else
               "_notes" if args.notes else ""))
    opt = TrainOptions().parse([
        "--name", args.name,
        "--checkpoints_dir", args.checkpoints_dir,
        "--gpu_ids", gpu_ids(args.device),
        "--model", args.model,
        "--dataset_mode", mode,
        "--batchSize", str(args.batch),
        "--dtype", "bfloat16",
        "--hole_weight", str(args.hole_weight),
        "--lr_policy", "lambda",
        "--niter", str(max(epochs_total - 1, 1)),
        "--niter_decay", "1",
        "--steps_per_epoch", str(args.milestone),
        "--seed", str(args.seed),
        "--lambda_sc", str(args.lambda_sc),
        "--lambda_onset", str(args.lambda_onset),
        "--lambda_fm", str(args.lambda_fm),
        "--lambda_L1", str(args.lambda_l1),
        "--lambda_L2", str(args.lambda_l2),
        "--num_D", str(args.num_D),
        "--bottleneck_dilation", args.bottleneck_dilation,
        "--bottleneck_attn", str(args.bottleneck_attn),
        "--ngf", str(args.ngf),
        "--lambda_phase", str(args.lambda_phase),
    ] + (["--gated"] if args.gated else [])
      + (["--phase_head"] if args.phase_head else [])
      + (["--long_gap"] if args.long_gap else []) + list(extra))
    return VIAIModel(opt)


def step_generator(args, start: int, device) -> torch.Generator:
    """The step's generator: seeded from seed + 2, and from (seed + 2,
    start) for a resumed run."""
    seed = args.seed + 2
    if start:
        seed = int(np.random.SeedSequence([seed, start]).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(seed)


def main(argv=None) -> dict:
    args, extra = parse_args(argv)
    if args.resume_step and args.resume_step >= args.steps:
        # A finished run probed again would skip the loop with no losses.
        print(f"resume_step {args.resume_step} >= steps {args.steps}: "
              f"nothing to train", flush=True)
        sys.exit(0)
    enable_build_cache()
    model = build_model(args, extra)
    dev, opt = model.device, model.opt
    start = 0
    if args.resume_step:
        model.load_networks(str(args.resume_step))
        start = args.resume_step
        print(f"resumed full train state @ {start}", flush=True)

    # The clip pool, copied to the device once.
    use_av = args.model == "av"
    it = SyntheticBatchIterator(
        SyntheticConfig(sample_rate=opt.sample_rate,
                        clip_seconds=opt.clip_seconds, with_video=use_av,
                        video_frames=opt.n_video_frames,
                        video_size=opt.frame_size,
                        style=corpus_style(args)),
        batch=args.batch, seed=args.seed + 1)
    pool = []
    try:
        for _ in range(args.pool_batches):
            b = next(it)
            pool.append((
                torch.from_numpy(np.asarray(b["wav"])).to(dev),
                torch.from_numpy(np.asarray(b["frames"])).to(dev)
                if use_av else None,
                torch.from_numpy(np.asarray(b["frames_valid"], np.float32))
                .to(dev) if use_av else None))
    finally:
        it.close()
    print(f"pool: {args.pool_batches} x {args.batch} clips on the device"
          f"{' (+frames)' if use_av else ''}", flush=True)

    gen = step_generator(args, start, dev)
    losses = {}
    t0 = time.perf_counter()
    for i in range(start, args.steps):
        wav_i, fr_i, fv_i = pool[i % args.pool_batches]
        losses = model.train_step(model.state, wav_i, fr_i, gen, fv_i)
        step = i + 1
        if step % 500 == 0:
            l1 = float(losses["loss_G_L1"])   # waits for the step
            rate = (step - start) / (time.perf_counter() - t0)
            print(f"step {step}/{args.steps}  L1 {l1:.5f}  "
                  f"{rate:.1f} steps/s", flush=True)
        if step % args.milestone == 0:
            model.save_networks(str(step))
            print(f"saved nets @ {step}", flush=True)
    final_l1 = float(losses["loss_G_L1"])     # waits for the last step
    dt = time.perf_counter() - t0

    rec = {
        "exp": "quality_long", "steps": args.steps, "batch": args.batch,
        "hole_weight": args.hole_weight, "long_gap": args.long_gap,
        "model": args.model, "notes": args.notes,
        "notes_grid": args.notes_grid, "cue": args.cue,
        "lambda_sc": args.lambda_sc, "lambda_onset": args.lambda_onset,
        "lambda_fm": args.lambda_fm, "num_D": args.num_D,
        "lambda_l1": args.lambda_l1, "lambda_l2": args.lambda_l2,
        "gated": args.gated, "phase_head": args.phase_head,
        "lambda_phase": args.lambda_phase,
        "bottleneck_dilation": args.bottleneck_dilation,
        "bottleneck_attn": args.bottleneck_attn,
        "ngf": args.ngf,
        "pool_clips": args.pool_batches * args.batch,
        "resume_step": start,
        "final_l1": round(final_l1, 6),
        "train_clips_per_s": round((args.steps - start) * args.batch / dt, 1),
        "expr_dir": model.expr_dir,
        "package": "viai_tpu_torch", "device": device_name(dev),
        "t": time.time(),
    }
    append_record(rec, args.results_dir)
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
