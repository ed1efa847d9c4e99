"""Monte-Carlo Bayes ceiling for hole-PSNR on the 'notes' corpus.

Port of `scripts/bayes_ceiling.py`. The oracle-magnitude eval knows the
notes inside the gap, content the corpus generator draws at random,
independent of the observable context; the ceiling for any predictor
is the score of the posterior mean under the true generative
posterior, computed here by Monte-Carlo, since we own the generator
(data/synthetic.py::_draw_notes, render_note_events).

For each clip and eval-protocol gap (MaskConfig's 25-50 frames at hop
128):
  1. the truly hidden sample window H is what no observed STFT frame's
     n_fft window sees: [(a-1)·hop + n_fft/2, b·hop − n_fft/2) for hole
     frames [a, b);
  2. notes with onset outside H are (at least partly) observed: the
     posterior pins them, the true parameters are kept;
  3. notes with onset inside H follow the renderer's identification
     hierarchy (harmonic h decays as (amp/h)·e^{−h·decay·(t−onset)}):
     ≥ 2 harmonics above the clip's noise floor at H's end date the
     note (kept); only the fundamental above it leaves the family
     amp' = amp·e^{−decay·(onset'−onset)}, sampled within the prior's
     amp support with harmonic 2 kept below the floor; none above it:
     a prior draw conditioned on onset in H and invisibility at H's end;
  4. the in-H slice of the clip's noise stream is drawn anew.
M such posterior re-renders are averaged in the compressed-magnitude
space (the metric's): the posterior-mean predictor, whose masked_psnr
against the true image, averaged over clips, is the ceiling. Every
approximation biases it up, so it bounds what any magnitude-domain
predictor can score under this protocol. Also reported: the mean score
of a single posterior sample (a perfect sampler's, the refiner's bound).

The parameter draws are numpy (the JAX script's arithmetic, bit for
bit); the STFT, compression and PSNR run in torch on the device. The
gaps come from a torch generator seeded --seed, one per clip (the JAX
script draws them from jax.random); `run(..., tmasks=)` takes them
instead.

    python -m viai_tpu_torch.scripts.bayes_ceiling [--clips 64] \\
        [--variants 48] [--style notes_grid] [--log_results] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .._device import resolve_device
from ..data.synthetic import (_INTERVALS, SyntheticConfig, _draw_notes,
                              _draw_notes_grid, render_note_events)
from ..io.results import append_record
from ..signal.mask import MaskConfig, sample_time_mask
from ..signal.mel import compress
from ..signal.stft import STFTConfig, stft_magnitude
from ..utils.metrics import masked_psnr
from ._quality import device_name

IMAGE_FRAMES = 256


def hidden_window(tmask: np.ndarray, hop: int, n_fft: int, sr: int):
    """Hole frames [a, b) → (a, b, H_lo, H_hi): the seconds of truly
    hidden samples."""
    hole = np.where(tmask < 0.5)[0]
    a, b = int(hole.min()), int(hole.max()) + 1
    lo_s = (a - 1) * hop + n_fft // 2 + 1
    hi_s = b * hop - n_fft // 2 - 1
    return a, b, lo_s / sr, hi_s / sr


def posterior_resample(rng, params, H_lo, H_hi, tau, onset_prior_hi):
    """One posterior-equivalent parameter set given phase-blind context.

    An in-H-onset note with ≥ 2 harmonics above the floor `tau` at H_hi
    is identified (kept); with only the fundamental above it, its onset
    and amp move along amp' = amp·e^{−d(o'−o)} (the identical
    fundamental tail) within amp' ∈ [0.2, 1] with harmonic 2 below the
    floor; with nothing above it, it is drawn from the prior
    conditioned on invisibility. → (params', n_identified, n_family,
    n_invisible).
    """
    onset, f0, decay, amp, inharm, namp = (x.copy() if hasattr(x, "copy")
                                           else x for x in params)
    hidden = (onset > H_lo) & (onset < H_hi) & (amp > 0)
    dt = np.maximum(H_hi - onset, 0.0)
    tail1 = amp * np.exp(-decay * dt)                 # fundamental @ H_hi
    tail2 = (amp / 2.0) * np.exp(-2.0 * decay * dt)   # 2nd harmonic @ H_hi
    ident = hidden & (tail2 > tau)
    fam = hidden & ~ident & (tail1 > tau)
    invis = hidden & ~ident & ~fam

    for j in np.where(fam)[0]:
        # amp' decreases in o': o' ≥ o + ln(amp)/d keeps amp' ≤ 1,
        # o' ≤ o + ln(amp/0.2)/d keeps amp' ≥ 0.2; harmonic 2 of the
        # draw must stay below the floor (rejection).
        lo = max(H_lo, onset[j] + np.log(amp[j]) / decay[j])
        hi = min(H_hi - 0.005, onset[j] + np.log(amp[j] / 0.2) / decay[j])
        if hi > lo:
            for _ in range(50):
                o2 = rng.uniform(lo, hi)
                a2 = amp[j] * np.exp(-decay[j] * (o2 - onset[j]))
                if (a2 / 2.0) * np.exp(
                        -2.0 * decay[j] * (H_hi - o2)) <= tau:
                    amp[j], onset[j] = a2, o2
                    break

    root = None
    if invis.any():
        # The chord root's lattice is identified by the visible notes.
        known = (amp > 0) & ~invis
        root = (np.min(f0[known]) / 2.0 if known.any() else
                float(rng.uniform(110.0, 440.0)))
    for j in np.where(invis)[0]:
        ok = False
        o_hi = min(H_hi, onset_prior_hi)
        for _ in range(300):
            o2 = rng.uniform(H_lo, o_hi)
            d2 = rng.uniform(1.5, 8.0)
            a2 = rng.uniform(0.2, 1.0)
            if a2 * np.exp(-d2 * (H_hi - o2)) < tau:
                ok = True
                break
        if not ok:     # corner: force a maximally decayed inaudible draw
            o2, d2, a2 = H_lo, 8.0, 0.2
        onset[j], decay[j], amp[j] = o2, d2, a2
        f0[j] = root * _INTERVALS[rng.integers(0, len(_INTERVALS))] * (
            2.0 ** rng.integers(-1, 2))
        inharm[j] = rng.uniform(0.0, 1e-3)
    return ((onset, f0, decay, amp, inharm, namp), int(ident.sum()),
            int(fam.sum()), int(invis.sum()))


def run(n_clips: int, n_variants: int, seed: int, style: str = "notes",
        tmasks=None, device: str | torch.device = "cuda") -> dict:
    """The ceiling over `n_clips` clips of `n_variants` posterior
    re-renders each; `tmasks` ((n_clips, 256) keep-masks) replaces the
    gaps drawn from the generator seeded `seed`."""
    dev = resolve_device(device)
    scfg = SyntheticConfig(style=style)
    stft_cfg = STFTConfig()             # n_fft 510, hop 128 (eval default)
    mcfg = MaskConfig()                 # 25-50 frames, random position
    sr, n = scfg.sample_rate, scfg.clip_samples
    t = np.arange(n) / sr
    n_frames = stft_cfg.num_frames(n)
    onset_prior_hi = 0.85 * scfg.clip_seconds
    kmask = torch.Generator().manual_seed(seed)

    def mag_img(wavs):                  # (B, n) → (B, bins, frames, 1)
        x = torch.from_numpy(np.stack(wavs).astype(np.float32)).to(dev)
        return compress(stft_magnitude(x, stft_cfg).transpose(-1, -2))[
            ..., None]

    ceil_psnr, samp_psnr = [], []
    n_ident_tot, n_fam_tot, n_invis_tot = 0, 0, 0
    draw = _draw_notes_grid if style == "notes_grid" else _draw_notes
    for i in range(n_clips):
        rng = np.random.default_rng(seed * 100003 + i)
        params = draw(rng, scfg)
        noise = rng.standard_normal(n)
        raw = render_note_events(params, noise, t, scfg.n_harmonics)
        scale = 0.5 / max(np.abs(raw).max(), 1e-6)
        wav_true = (raw * scale).astype(np.float32)

        tmask = (np.array(tmasks[i], np.float32) if tmasks is not None else
                 sample_time_mask(kmask, IMAGE_FRAMES, mcfg).numpy())
        tmask[n_frames:] = 1.0          # the pad region is observed
        a, b, H_lo, H_hi = hidden_window(tmask, stft_cfg.hop_length,
                                         stft_cfg.n_fft, sr)
        tau = max(params[5], 1e-3)      # the clip's noise floor
        lo_s, hi_s = int(H_lo * sr) + 1, int(H_hi * sr)

        vrng = np.random.default_rng(seed * 7919 + 31 * i + 7)
        variants = []
        for m in range(n_variants):
            if style == "notes_grid":
                # The deterministic twin: every in-H note continues the
                # observed grid, so only the in-gap noise is drawn — the
                # irreducible burst-noise term of 'notes'.
                p2 = params
                nid = int(((params[0] > H_lo) & (params[0] < H_hi)
                           & (params[3] > 0)).sum())
                nfa = ninv = 0
            else:
                p2, nid, nfa, ninv = posterior_resample(
                    vrng, params, H_lo, H_hi, tau, onset_prior_hi)
            if m == 0:
                n_ident_tot += nid
                n_fam_tot += nfa
                n_invis_tot += ninv
            noise2 = noise.copy()
            noise2[lo_s:hi_s] = vrng.standard_normal(max(hi_s - lo_s, 0))
            variants.append(render_note_events(
                p2, noise2, t, scfg.n_harmonics) * scale)

        imgs = mag_img([wav_true] + variants)       # (1+M, bins, F, 1)
        true_img, var_imgs = imgs[:1], imgs[1:]
        mask_img = torch.from_numpy(tmask[:n_frames]).to(dev)[
            None, None, :, None].expand(true_img.shape)
        post_mean = var_imgs.mean(dim=0, keepdim=True)
        ceil_psnr.append(float(masked_psnr(post_mean, true_img,
                                           mask_img)[0]))
        samp = masked_psnr(var_imgs, true_img.expand_as(var_imgs),
                           mask_img.expand_as(var_imgs))
        samp_psnr.append(float(samp.mean()))
        if (i + 1) % 8 == 0:
            print(f"clip {i+1}/{n_clips}: ceiling so far "
                  f"{np.mean(ceil_psnr):.2f} dB "
                  f"(sample {np.mean(samp_psnr):.2f})", flush=True)

    return {
        "exp": "bayes_ceiling",
        "dataset_mode": f"synthetic_{style}",
        "n_clips": n_clips,
        "n_variants": n_variants,
        "seed": seed,
        "ceiling_hole_psnr_mean": round(float(np.mean(ceil_psnr)), 3),
        "ceiling_hole_psnr_sem": round(
            float(np.std(ceil_psnr) / np.sqrt(len(ceil_psnr))), 3),
        "sample_hole_psnr_mean": round(float(np.mean(samp_psnr)), 3),
        "identified_hidden_notes_per_clip": round(n_ident_tot / n_clips, 2),
        "family_hidden_notes_per_clip": round(n_fam_tot / n_clips, 2),
        "invisible_hidden_notes_per_clip": round(n_invis_tot / n_clips, 2),
        "note": ("posterior-MEAN upper bound for ANY magnitude-domain "
                 "predictor under the eval protocol; 'sample' = what a "
                 "perfect posterior SAMPLER scores (refiner-family "
                 "bound). Optimistic approximations throughout "
                 "(identified notes keep exact true parameters, known "
                 "hidden-note count/root, noiseless harmonic-ratio "
                 "dating) - the true ceiling is lower."),
        "package": "viai_tpu_torch", "device": device_name(dev),
        "t": time.time(),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--clips", type=int, default=64)
    ap.add_argument("--variants", type=int, default=48)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--style", choices=["notes", "notes_grid"],
                    default="notes",
                    help="notes_grid = the deterministic twin: only "
                         "in-gap noise is random, so the ceiling "
                         "isolates the irreducible attack-burst cost")
    ap.add_argument("--log_results", action="store_true",
                    help="append to {results_dir}/quality_results.jsonl")
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--results_dir", type=str, default="results/")
    args = ap.parse_args(argv)
    rec = run(args.clips, args.variants, args.seed, style=args.style,
              device=args.device)
    print(json.dumps(rec))
    if args.log_results:
        append_record(rec, args.results_dir)
    return rec


if __name__ == "__main__":
    main()
