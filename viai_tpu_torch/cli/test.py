"""Evaluate the port's model — the reference's inference entry point.

Port of `viai_tpu/cli/test.py`: parse the test options → the loader in
order, one pass (the --phase split of a musices manifest) →
create_model → load_networks → per batch: gaps drawn, the inpainting
chain (model.infer_fn: G, the ensemble, the refiner, GL or the complex
decode) → spectrogram PSNR (full and hole), waveform SNR and spectral
convergence against the input → the HTML gallery, the summary (mean
and standard error per metric) and, with --log_results,
one JSON record (to {results_dir}/quality_results.jsonl, or to the file
VIAI_RESULTS_JSONL names).

    python -m viai_tpu_torch.cli.test --name exp --which_epoch latest \\
        --dataset_mode synthetic_notes --how_many 64

--gpu_ids -1 evaluates on the CPU; otherwise the card.

The gaps of each batch come from one torch.Generator seeded by --seed:
it gives the batch a seed, and every use of the batch's masks (the
metrics, each posterior sample) rebuilds a generator from that seed. So
arms with the same --seed and --batchSize score the same masks. The
bits are not the JAX package's (threefry), so the two packages score
different masks of the same distribution.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..config.options import TestOptions
from ..data import create_dataloader
from ..io.results import append_record
from ..model import create_model
from ..signal.mel import compress
from ..signal.stft import stft_magnitude
from ..train.preprocess import preprocess
from ..utils.compile_cache import enable as enable_build_cache
from ..utils.metrics import masked_psnr, psnr, snr, spectral_convergence
from ..utils.visualizer import HTMLGallery


def _mean_sem(xs) -> tuple[float, float]:
    """(mean, standard error of the mean)."""
    if not xs:
        return float("nan"), float("nan")
    a = np.asarray(xs, np.float64)
    sem = float(a.std(ddof=1) / np.sqrt(len(a))) if len(a) > 1 else 0.0
    return float(a.mean()), sem


def main(args=None) -> dict:
    enable_build_cache()
    opt = TestOptions().parse(args)
    clip_samples = int(opt.sample_rate * opt.clip_seconds)
    loader = create_dataloader(
        opt.dataset_mode, opt.dataroot, opt.batchSize, clip_samples,
        opt.sample_rate, opt.nThreads, opt.n_video_frames, opt.frame_size,
        seed=opt.seed, shuffle=False, num_epochs=1, prefer_native=False,
        split=opt.phase,
    )
    opt.isTrain = False
    model = create_model(opt)
    model.load_networks(opt.which_epoch)
    cfg = model.cfg

    # --eval_samples K > 1: best-of-K posterior sampling (refiner only —
    # without it the chain is deterministic given the mask). Each sample
    # is the same task under its own noise fold. The best-of-K pick
    # maximizes the ground-truth hole-PSNR, an oracle diagnostic of
    # posterior coverage: its metrics are the *_bok_* keys, and the
    # headline keys stay those of the first sample.
    n_samples = int(opt.eval_samples)
    if n_samples > 1 and model.R is None:
        print("[test] --eval_samples needs --refiner (chain is "
              "deterministic without it); falling back to 1 sample")
        n_samples = 1
    bok_lbl = f" (best-of-{n_samples} oracle)" if n_samples > 1 else ""

    results_dir = os.path.join(opt.results_dir, opt.name,
                               f"{opt.phase}_{opt.which_epoch}")
    gallery = HTMLGallery(results_dir, f"{opt.name} — epoch {opt.which_epoch}")

    names = ("hole_psnr", "psnr", "snr", "spec_conv")
    head = {n: [] for n in names}        # first sample, every clip
    bok = {n: [] for n in names}         # best-of-K pick
    n_done = 0
    masks_gen = torch.Generator().manual_seed(opt.seed)
    for batch in loader:
        if n_done >= opt.how_many:
            break
        batch_seed = int(torch.randint(0, 2**62, (1,), generator=masks_gen))

        def task():
            return torch.Generator().manual_seed(batch_seed)

        model.set_input(batch)
        wav_in, frames = model._input["wav"], model._input["frames"]
        with torch.inference_mode():
            pre = preprocess(wav_in, task(), cfg)
            in_img = compress(stft_magnitude(wav_in, cfg.stft)
                              .transpose(-1, -2))[..., None]
            m = pre["mask_img"][:, :, :in_img.shape[2]]
            cand = []   # per sample: (hole, psnr, snr, sc) numpy, wav, img
            for s in range(n_samples):
                out_wav = model.infer_fn(wav_in, task(), frames, fold=s)
                out_img = compress(stft_magnitude(out_wav, cfg.stft)
                                   .transpose(-1, -2))[..., None]
                vals = (masked_psnr(out_img, in_img, m),
                        psnr(out_img, in_img), snr(out_wav, wav_in),
                        spectral_convergence(out_wav, wav_in, cfg.stft))
                cand.append(([v.cpu().numpy() for v in vals],
                             out_wav.cpu().numpy(), out_img.cpu().numpy()))
        # Headline metrics: the first sample, capped at --how_many (a
        # partial last batch must not leak clips into the means).
        take = max(0, opt.how_many - len(head["psnr"]))
        for n, v in zip(names, cand[0][0]):
            head[n] += list(v)[:take]
        if n_samples == 1:
            best_vals, out_wav, out_img = cand[0]
        else:
            best = np.stack([c[0][0] for c in cand]).argmax(0)   # (B,)
            rows = np.arange(len(best))
            best_vals = [np.stack([c[0][i] for c in cand])[best, rows]
                         for i in range(len(names))]
            out_wav = np.stack([c[1] for c in cand])[best, rows]
            out_img = np.stack([c[2] for c in cand])[best, rows]
            for n, v in zip(names, best_vals):
                bok[n] += list(v)[:take]
        b_hole, b_psnr, b_snr, b_sc = best_vals

        wav_np = wav_in.cpu().numpy()
        real_img = pre["real_img"].cpu().numpy()
        masked_img = pre["masked_img"].cpu().numpy()
        for b in range(min(wav_np.shape[0], opt.how_many - n_done)):
            gallery.add_result(
                n_done,
                specs={
                    "real": (real_img[b, :, :, 0] + 1) / 2,
                    "masked": (masked_img[b, :, :, 0] + 1) / 2,
                    "inpainted": (out_img[b, :, :, 0] + 1) / 2,
                },
                wavs={"real": wav_np[b], "inpainted": out_wav[b]},
                metrics={
                    f"PSNR{bok_lbl}": float(b_psnr[b]),
                    f"holePSNR{bok_lbl}": float(b_hole[b]),
                    f"SNR{bok_lbl}": float(b_snr[b]),
                    f"specConv{bok_lbl}": float(b_sc[b]),
                },
                sr=opt.sample_rate,
            )
            n_done += 1

    path = gallery.save()
    summary = {"n": n_done}
    for n in ("psnr", "hole_psnr", "snr", "spec_conv"):
        summary[f"{n}_mean"], summary[f"{n}_sem"] = _mean_sem(head[n])
    if n_samples > 1:
        summary["eval_samples"] = n_samples
        for n in ("psnr", "hole_psnr", "snr", "spec_conv"):
            summary[f"{n}_bok_mean"], summary[f"{n}_bok_sem"] = _mean_sem(
                bok[n])
        summary["hole_psnr_s1_mean"] = summary["hole_psnr_mean"]
    print(f"results → {path}")
    print(
        f"PSNR {summary['psnr_mean']:.2f}±{summary['psnr_sem']:.2f} dB | "
        f"hole-PSNR {summary['hole_psnr_mean']:.2f}"
        f"±{summary['hole_psnr_sem']:.2f} dB | "
        f"SNR {summary['snr_mean']:.2f}±{summary['snr_sem']:.2f} dB "
        f"| specConv {summary['spec_conv_mean']:.4f} ({n_done} clips)"
    )
    if n_samples > 1:
        print(
            f"best-of-{n_samples} (oracle pick): hole-PSNR "
            f"{summary['hole_psnr_bok_mean']:.2f}"
            f"±{summary['hole_psnr_bok_sem']:.2f} dB | SNR "
            f"{summary['snr_bok_mean']:.2f} dB"
        )
    if opt.log_results:
        # The eval record, the JAX package's keys plus the package that
        # scored it (the two draw different masks). Pairing provenance:
        # per-clip deltas between two arms are valid only when they share
        # the mask stream (seed) and clip order (batchSize, dataset_mode).
        rec = {"exp": "test_eval", "package": "viai_tpu_torch",
               "tag": opt.log_results, "name": opt.name,
               "which_epoch": opt.which_epoch,
               "dataset_mode": opt.dataset_mode, "seed": int(opt.seed),
               "batchSize": int(opt.batchSize),
               "how_many": int(opt.how_many), **summary, "t": time.time()}
        if len(head["hole_psnr"]) <= 256:
            rec["hole_psnr_clips"] = [round(float(x), 3)
                                      for x in head["hole_psnr"]]
        append_record(rec, opt.results_dir)
    return summary


if __name__ == "__main__":
    main()
