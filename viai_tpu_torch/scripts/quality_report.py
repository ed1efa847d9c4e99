"""Quality smoke report: train briefly, show inpainting quality improving.

Port of `scripts/quality_report.py`: the hole-PSNR of the inpainted
region on a held-out synthetic batch (clips 100000 onwards), before and
after --steps train steps of G and D (bf16 by default, Adam 2e-4) on
the clips 0 to 4·batch − 1, with the same gaps (a generator seeded 7)
at both readings, the chain at GL×8. Appends one JSON record to
{--results_dir}/quality_results.jsonl (io/results.py).

    python -m viai_tpu_torch.scripts.quality_report [--steps 300] \\
        [--batch 32] [--long_gap] [--device cpu]

The step's draws (gaps, dropout) come from a generator seeded 0 on the
device, not from JAX's threefry keys, so the numbers are of the same
protocol, not the same bits.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from .._device import resolve_device
from ..data.synthetic import SyntheticAVDataset, SyntheticConfig
from ..io.results import append_record
from ..nn import define_D, define_G
from ..signal import MaskConfig
from ..signal.mask import sample_batch_masks
from ..train import TrainConfig, adam, init_state, make_train_step
from ._quality import device_name, hole_psnr


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--eval_batch", type=int, default=32)
    ap.add_argument("--dtype", type=str, default="bfloat16")
    ap.add_argument("--lambda_l1", type=float, default=100.0)
    ap.add_argument("--long_gap", action="store_true",
                    help="long-gap config: multi-res input, 75-150 frame "
                         "masks, 3-channel G (BASELINE config 3)")
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--results_dir", type=str, default="results/")
    return ap.parse_args(argv)


def train_config(args) -> TrainConfig:
    cfg = TrainConfig(lambda_l1=args.lambda_l1)
    if args.long_gap:
        cfg = dataclasses.replace(
            cfg, multi_res=True,
            mask=MaskConfig(min_gap_frames=75, max_gap_frames=150))
    return cfg


def run(args, G, D, cfg: TrainConfig, device) -> dict:
    """Train G and D for args.steps on the synthetic corpus and score
    the chain before and after; → the record (also appended)."""
    g_opt, d_opt = adam(G.parameters(), 2e-4), adam(D.parameters(), 2e-4)
    state = init_state(D, cfg)
    step = make_train_step(G, D, None, g_opt, d_opt, cfg)

    ds = SyntheticAVDataset(SyntheticConfig())
    train_wavs = torch.from_numpy(np.stack(
        [ds[i]["wav"] for i in range(args.batch * 4)])).to(device)
    eval_wav = torch.from_numpy(np.stack(
        [ds[100000 + i]["wav"] for i in range(args.eval_batch)])).to(device)
    tmask = sample_batch_masks(
        torch.Generator(device=device).manual_seed(7), args.eval_batch,
        cfg.image_frames, cfg.mask)

    p0 = hole_psnr(G, None, cfg, eval_wav, tmask)
    print(f"hole-PSNR before training: {p0:.2f} dB", flush=True)

    gen = torch.Generator(device=device).manual_seed(0)
    n = len(train_wavs)
    losses = {}
    t0 = time.perf_counter()
    for i in range(args.steps):
        lo = (i * args.batch) % n
        if lo + args.batch > n:
            lo = 0
        losses = step(state, train_wavs[lo:lo + args.batch], None, gen)
    lg = float(losses["loss_G_L1"])          # waits for the last step
    dt = time.perf_counter() - t0
    p1 = hole_psnr(G, None, cfg, eval_wav, tmask)
    rate = args.steps * args.batch / dt
    print(f"hole-PSNR after {args.steps} steps: {p1:.2f} dB "
          f"(train {rate:.0f} clips/s)", flush=True)

    rec = {
        "steps": args.steps, "batch": args.batch,
        "long_gap": args.long_gap,
        "hole_psnr_before": round(p0, 3),
        "hole_psnr_after": round(p1, 3),
        "final_l1": round(lg, 5),
        "train_clips_per_s": round(rate, 1),
        "package": "viai_tpu_torch", "device": device_name(device),
        "t": time.time(),
    }
    append_record(rec, args.results_dir)
    print(json.dumps(rec))
    return rec


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = train_config(args)
    g_in = 3 if args.long_gap else 2
    G = define_G(input_nc=g_in, dtype=args.dtype, device=dev)
    D = define_D(input_nc=g_in + 1, dtype=args.dtype, device=dev)
    return run(args, G, D, cfg, dev)


if __name__ == "__main__":
    main()
