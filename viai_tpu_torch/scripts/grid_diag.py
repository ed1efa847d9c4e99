"""Diagnose a train/eval gap: pre-Griffin-Lim hole-PSNR on unseen clips
against clips of the training pool.

Port of `scripts/grid_diag.py`, written for the notes_grid corpus,
whose post-GL eval hole-PSNR sat far below what its train L1 promised.
Two hypotheses:
  (a) GL amplification: G's magnitude prediction before GL is good on
      the eval clips and the post-GL metric is not;
  (b) pool memorization: G mispredicts unseen clips (eval indices
      0..15) but fits its training pool (indices 10000+).
It prints the composite's hole-PSNR before GL (the compressed-image
masked_psnr the eval uses, G's hole over the real observed region) on
both sets and appends one record to {--results_dir}/quality_results.jsonl.

    python -m viai_tpu_torch.scripts.grid_diag NAME CKPT_DIR EPOCH \\
        [DILATION] [STYLE] [ATTN_BLOCKS] [--device cpu]

Flags the script does not define go to TestOptions and must match the
checkpoint's training (e.g. --ngf, --n_fft; the clips follow
--clip_seconds and --sample_rate).

The gaps are those the port's eval CLI (cli/test.py) draws for its
first batch of 16 clips at the checkpoint's --seed: a generator seeded
with the seed gives the batch seed, whose generator draws the masks.
The JAX script's mask key (split(key(seed), 3)[1]) has no torch
counterpart, so the two scripts score different gaps of the same
distribution.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..config.options import TestOptions
from ..data.synthetic import SyntheticAVDataset, SyntheticConfig
from ..io.results import append_record
from ..model import create_model
from ..signal.mask import sample_batch_masks
from ..train.preprocess import g_input, preprocess_with_mask
from ..utils.metrics import masked_psnr
from ._quality import device_name, gpu_ids

N_CLIPS = 16
SETS = ((0, "eval-unseen"), (10000, "train-pool"))


def eval_masks(seed: int, batch: int, cfg) -> torch.Tensor:
    """The gap masks of the eval CLI's first batch for --seed."""
    masks_gen = torch.Generator().manual_seed(seed)
    batch_seed = int(torch.randint(0, 2**62, (1,), generator=masks_gen))
    return sample_batch_masks(torch.Generator().manual_seed(batch_seed),
                              batch, cfg.image_frames, cfg.mask)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("name")
    ap.add_argument("ckpt_dir")
    ap.add_argument("epoch")
    ap.add_argument("dilation", nargs="?", default="1,2,4")
    ap.add_argument("style", nargs="?", default="notes_grid")
    ap.add_argument("attn", nargs="?", default="0")
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--results_dir", type=str, default="results/")
    args, extra = ap.parse_known_args(argv)

    opt = TestOptions().parse([
        "--name", args.name, "--checkpoints_dir", args.ckpt_dir,
        "--dataset_mode", f"synthetic_{args.style}"
        if args.style != "harmonic" else "synthetic",
        "--bottleneck_dilation", args.dilation,
        "--bottleneck_attn", args.attn,
        "--gpu_ids", gpu_ids(args.device), *extra,
    ], save=False)
    opt.isTrain = False
    model = create_model(opt)
    model.load_networks(args.epoch)
    cfg, dev = model.cfg, model.device

    ds = SyntheticAVDataset(SyntheticConfig(
        sample_rate=opt.sample_rate, clip_seconds=opt.clip_seconds,
        style=args.style))
    tmask = eval_masks(opt.seed, N_CLIPS, cfg).to(dev)
    scores = {}
    with torch.no_grad():
        for idx0, tag in SETS:
            wav = torch.from_numpy(np.stack(
                [ds[idx0 + i]["wav"] for i in range(N_CLIPS)])).to(dev)
            pre = preprocess_with_mask(wav, tmask, cfg)
            fake = model.G(g_input(pre)).float().permute(0, 2, 3, 1)
            m = pre["mask_img"]
            comp = pre["real_img"] * m + fake * (1.0 - m)
            val = float(masked_psnr(comp, pre["real_img"], m).mean())
            scores[tag] = val
            print(f"pre-GL hole-PSNR [{tag}] (idx {idx0}..{idx0 + 15}): "
                  f"{val:.2f} dB", flush=True)

    rec = {"exp": "grid_diag", "name": args.name, "epoch": args.epoch,
           "style": args.style,
           **{f"pre_gl_hole_psnr_{t.replace('-', '_')}": round(v, 3)
              for t, v in scores.items()},
           "package": "viai_tpu_torch", "device": device_name(dev),
           "t": time.time()}
    append_record(rec, args.results_dir)
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
