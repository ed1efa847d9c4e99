"""Vision-infused vs audio-only ablation — the paper's core claim.

Port of `scripts/av_ablation.py`. The synthetic AV corpus encodes pitch
and energy in the video (a blob whose position tracks the instantaneous
pitch and the envelope, data/synthetic.py), so a model that exploits
fusion must beat the audio-only model on hole-PSNR for long gaps
(75-150 frames), where the audio context alone underdetermines the
missing content.

Both variants train identically (bf16 G, D and V, Adam 2e-4, fusion
128, define_V(128, 16), seeds 0/1/2, clips 0 to 8·batch − 1 of
SyntheticConfig(with_video=True)) and are scored on 32 held-out clips
(200000 onwards) with the same gaps (a generator seeded 7), the chain
at GL×8. Appends one JSON record to {--results_dir}/quality_results.jsonl.

    python -m viai_tpu_torch.scripts.av_ablation [--steps 600] \\
        [--batch 32] [--device cpu]
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
from ..nn import define_D, define_G, define_V
from ..signal import MaskConfig
from ..signal.mask import sample_batch_masks
from ..train import TrainConfig, adam, init_state, make_train_step
from ._quality import device_name, hole_psnr

N_EVAL = 32


def run_variant(use_video: bool, steps: int, batch: int, cfg: TrainConfig,
                ds, eval_wav: torch.Tensor, eval_frames: torch.Tensor,
                device) -> tuple[float, float, float]:
    """Train one variant; → (hole-PSNR, final loss_G_L1, train clips/s)."""
    fusion = 128 if use_video else 0
    G = define_G(dtype="bfloat16", fusion_channels=fusion, seed=0,
                 device=device)
    D = define_D(input_nc=3, dtype="bfloat16", seed=1, device=device)
    V = (define_V(fusion, 16, dtype="bfloat16", seed=2, device=device)
         if use_video else None)
    params = list(G.parameters()) + (list(V.parameters()) if use_video
                                     else [])
    g_opt, d_opt = adam(params, 2e-4), adam(D.parameters(), 2e-4)
    state = init_state(D, cfg)
    step = make_train_step(G, D, V, g_opt, d_opt, cfg)

    n_train = batch * 8
    items = [ds[i] for i in range(n_train)]
    wavs = torch.from_numpy(np.stack([it["wav"] for it in items])).to(device)
    frames = (torch.from_numpy(np.stack([it["frames"] for it in items]))
              .to(device) if use_video else None)
    del items

    gen = torch.Generator(device=device).manual_seed(0)
    losses = {}
    t0 = time.perf_counter()
    for i in range(steps):
        lo = (i * batch) % n_train
        if lo + batch > n_train:
            lo = 0
        fb = frames[lo:lo + batch] if use_video else None
        losses = step(state, wavs[lo:lo + batch], fb, gen)
    l1 = float(losses["loss_G_L1"])          # waits for the last step
    dt = time.perf_counter() - t0

    tmask = sample_batch_masks(
        torch.Generator(device=device).manual_seed(7), len(eval_wav),
        cfg.image_frames, cfg.mask)
    hp = hole_psnr(G, V, cfg, eval_wav, tmask,
                   eval_frames if use_video else None)
    return hp, l1, steps * batch / dt


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--results_dir", type=str, default="results/")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # Long gaps (75-150 frames ≈ 0.6-1.2 s) — where fusion must matter.
    base = TrainConfig(mask=MaskConfig(min_gap_frames=75,
                                       max_gap_frames=150))
    ds = SyntheticAVDataset(SyntheticConfig(with_video=True))
    eval_items = [ds[200000 + i] for i in range(N_EVAL)]
    eval_wav = torch.from_numpy(
        np.stack([e["wav"] for e in eval_items])).to(dev)
    eval_frames = torch.from_numpy(
        np.stack([e["frames"] for e in eval_items])).to(dev)

    results = {}
    for use_video in (False, True):
        cfg = dataclasses.replace(base, use_video=use_video)
        hp, l1, tput = run_variant(use_video, args.steps, args.batch, cfg,
                                   ds, eval_wav, eval_frames, dev)
        name = "av" if use_video else "audio"
        results[name] = {"hole_psnr": round(hp, 3), "final_l1": round(l1, 5),
                         "train_clips_per_s": round(tput, 1)}
        print(f"{name}: hole-PSNR {hp:.2f} dB  (L1 {l1:.4f}, "
              f"{tput:.0f} clips/s)", flush=True)

    rec = {"exp": "av_ablation", "steps": args.steps, "batch": args.batch,
           **{f"{k}_{m}": v for k, r in results.items()
              for m, v in r.items()},
           "package": "viai_tpu_torch", "device": device_name(dev),
           "t": time.time()}
    append_record(rec, args.results_dir)
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
