"""Options/CLI — the reference's argparse surface, for the port.

Port of `viai_tpu/config/options.py` (BaseOptions, TrainOptions,
TestOptions): the pix2pix flag names (--dataroot, --name, --batchSize,
--nThreads, --niter, --niter_decay, --lambda_L1, --which_epoch, ...),
printed to stdout and persisted as `opt.txt` (`opt_test.txt` for
TestOptions) in the experiment directory keyed by --name. The TPU-only
--gl_backend is gone (the chain always runs the CUDA Griffin-Lim on a
card). --gpu_ids -1 selects the CPU; any other value the card of its
first id (`device_from_opt`). What the port
cannot honour yet raises with the ROADMAP item that brings it: more
than one data or model device (multi-GPU) and the folder dataset modes
(data on CUDA, raised by the loader).
"""

from __future__ import annotations

import argparse
import os


class BaseOptions:
    def __init__(self):
        self.parser = argparse.ArgumentParser(
            formatter_class=argparse.ArgumentDefaultsHelpFormatter
        )
        self.initialized = False
        self.isTrain = True

    def initialize(self):
        p = self.parser
        # --- reference base options (pix2pix template names) ---
        p.add_argument("--dataroot", type=str, default=None,
                       help="path to wavs / manifest (dataset-dependent)")
        p.add_argument("--name", type=str, default="experiment",
                       help="experiment name; checkpoints go to "
                            "checkpoints_dir/name")
        p.add_argument("--gpu_ids", type=str, default="0",
                       help="comma-separated CUDA card ids; the port "
                            "runs on the first; -1 = CPU")
        p.add_argument("--model", type=str, default="audio",
                       choices=["audio", "av"],
                       help="audio-only or vision-infused model")
        p.add_argument("--batchSize", type=int, default=16)
        p.add_argument("--input_nc", type=int, default=2,
                       help="G input channels (masked spec + mask)")
        p.add_argument("--output_nc", type=int, default=1)
        p.add_argument("--ngf", type=int, default=64)
        p.add_argument("--ndf", type=int, default=64)
        p.add_argument("--n_layers_D", type=int, default=3)
        p.add_argument("--num_D", type=int, default=1,
                       help="discriminators in the multi-scale ensemble "
                            "(pix2pixHD): each sees the input 2x further "
                            "avg-pooled; 1 = single PatchGAN (reference)")
        p.add_argument("--dataset_mode", type=str, default="synthetic",
                       choices=["audio", "av", "musices", "synthetic",
                                "synthetic_av", "synthetic_notes",
                                "synthetic_notes_grid",
                                "synthetic_av_notes", "synthetic_av_cue"],
                       help="*_notes = polyphonic note-event corpus "
                            "(*_notes_grid = its deterministic twin: "
                            "beat grid + repeating arpeggio, hole fully "
                            "inferable from context — the ambiguity-"
                            "ceiling attribution corpus); "
                            "(onsets/decays/chords — harder than the "
                            "sine-mixture default); synthetic_av_cue = "
                            "vision-NECESSARY corpus (hole is audio-"
                            "ambiguous, video disambiguates; pins the "
                            "mask to the corpus' fixed gap)")
        p.add_argument("--nThreads", type=int, default=4)
        p.add_argument("--checkpoints_dir", type=str, default="./checkpoints")
        p.add_argument("--norm", type=str, default="instance",
                       choices=["instance", "batch", "none"],
                       help="batch = stats-free BatchNorm (global batch "
                            "stats under DP, live stats at test time — "
                            "matching the pix2pix template's effective "
                            "eval=False behavior; see nn/generator.py)")
        p.add_argument("--serial_batches", action="store_true",
                       help="no shuffling (sequential sampling)")
        p.add_argument("--no_html", action="store_true")
        p.add_argument("--init_type", type=str, default="normal",
                       choices=["normal", "xavier", "kaiming",
                                "orthogonal", "lecun"],
                       help="network weight init (pix2pix recipe; "
                            "normal = N(0, init_gain), the reference "
                            "default; lecun = flax default, non-parity)")
        p.add_argument("--init_gain", type=float, default=0.02,
                       help="scale for normal/xavier/orthogonal init")
        p.add_argument("--no_dropout", action="store_true",
                       help="disable the U-Net inner-decoder dropout "
                            "(0.5, pix2pix recipe; training only — "
                            "inference is always deterministic)")
        p.add_argument("--seed", type=int, default=0)
        p.add_argument("--bottleneck_dilation", type=str, default="",
                       help="comma-separated temporal dilation rates for "
                            "residual (1x3) convs at the U-Net bottleneck "
                            "(e.g. '1,2,4'); architecture flag — must "
                            "match between train and test")
        p.add_argument("--bottleneck_attn", type=int, default=0,
                       help="number of transformer blocks (self-attention "
                            "+ MLP over the flattened bottleneck grid); "
                            "0 = off; architecture flag — must match "
                            "between train and test")
        p.add_argument("--attn_heads", type=int, default=8,
                       help="attention heads per bottleneck_attn block")
        p.add_argument("--gated", action="store_true",
                       help="gated convolutions (DeepFill-v2) in every "
                            "G encoder/decoder block: conv emits 2x "
                            "channels, features x sigmoid(gate); "
                            "architecture flag — must match between "
                            "train and test")
        p.add_argument("--phase_head", action="store_true",
                       help="G also predicts hole phase as (cos, sin) "
                            "channels (Vocos-style); inference seeds "
                            "GL from the prediction (phase_init=model "
                            "under auto). Architecture flag — must "
                            "match between train and test")
        # --- additions of the rebuild ---
        p.add_argument("--sample_rate", type=int, default=16000)
        p.add_argument("--clip_seconds", type=float, default=2.0)
        p.add_argument("--n_fft", type=int, default=510)
        p.add_argument("--hop_length", type=int, default=128)
        p.add_argument("--image_frames", type=int, default=256,
                       help="spectrogram image time dim (pad target)")
        p.add_argument("--min_gap_frames", type=int, default=25)
        p.add_argument("--max_gap_frames", type=int, default=50)
        p.add_argument("--num_gaps", type=int, default=1)
        p.add_argument("--long_gap", action="store_true",
                       help="long-gap config [B:9]: multi-res STFT input "
                            "channel + larger default masks (75-150 frames)")
        p.add_argument("--gan_mode", type=str, default="lsgan",
                       choices=["lsgan", "vanilla", "hinge"])
        p.add_argument("--dtype", type=str, default="float32",
                       choices=["float32", "bfloat16"],
                       help="network compute dtype (params stay fp32)")
        p.add_argument("--n_video_frames", type=int, default=16)
        p.add_argument("--frame_size", type=int, default=64)
        p.add_argument("--fusion_channels", type=int, default=256)
        p.add_argument("--gl_iters", type=int, default=32,
                       help="Griffin-Lim iterations at test time")
        p.add_argument("--no_phase_aware", action="store_true",
                       help="reference-parity ablation: Griffin-Lim the "
                            "whole magnitude from zero phase instead of "
                            "keeping the observed frames' complex STFT "
                            "verbatim (phase-aware is the default and "
                            "strictly better on waveform SNR)")
        p.add_argument("--phase_init", type=str, default="auto",
                       choices=["auto", "zero", "extrapolate", "model"],
                       help="GL hole-phase init: 'extrapolate' seeds the "
                            "hole by phase-vocoder extrapolation from the "
                            "boundary (each bin's phasor keeps rotating at "
                            "its measured per-hop rotor) — +1.7 dB "
                            "hole-PSNR / +3.1 dB SNR with a trained G; "
                            "'auto' (default) = extrapolate under "
                            "phase-aware GL, zero with --no_phase_aware")
        p.add_argument("--mag_sharpen", type=float, default=1.0,
                       help="pre-GL spectral contrast exponent on the "
                            "PREDICTED hole magnitude (gamma; 1.0 = off). "
                            "Each hole frame is raised to gamma then "
                            "rescaled to its original frame energy — "
                            "sharpens G's over-smoothed long-gap "
                            "magnitudes so GL locks onto fewer, stronger "
                            "partials (SURVEY §3.5 long-gap lever)")
        p.add_argument("--upsample", type=str, default="deconv",
                       choices=["deconv", "resize"],
                       help="decoder upsampling: transposed conv or "
                            "nearest-resize+conv")
        p.add_argument("--remat", action="store_true",
                       help="rematerialize G forward in backward "
                            "(less activation memory, ~30%% more FLOPs)")
        p.add_argument("--n_data_devices", type=int, default=0,
                       help="data-parallel size over the process group's "
                            "ranks, one process a card (python -m "
                            "torch.distributed.run); 0 = the world's size "
                            "over --n_model_devices")
        p.add_argument("--n_model_devices", type=int, default=1,
                       help="ranks to shard the optimizers of G/D/V over "
                            "(ZeRO-style; train/mesh.py::shard_params)")
        self.initialized = True

    def parse(self, args=None, save=True):
        if not self.initialized:
            self.initialize()
        opt = self.parser.parse_args(args)
        opt.isTrain = self.isTrain
        expr_dir = os.path.join(opt.checkpoints_dir, opt.name)
        if save:
            os.makedirs(expr_dir, exist_ok=True)
        lines = ["------------ Options -------------"]
        for k, v in sorted(vars(opt).items()):
            lines.append(f"{k}: {v}")
        lines.append("-------------- End ----------------")
        text = "\n".join(lines)
        print(text)
        if save:
            # Reference behavior: persist opt.txt into the experiment dir.
            fname = "opt.txt" if self.isTrain else "opt_test.txt"
            with open(os.path.join(expr_dir, fname), "w") as f:
                f.write(text + "\n")
        self.opt = opt
        return opt


class TrainOptions(BaseOptions):
    def initialize(self):
        super().initialize()
        p = self.parser
        p.add_argument("--display_freq", type=int, default=100)
        p.add_argument("--print_freq", type=int, default=100)
        p.add_argument("--save_latest_freq", type=int, default=5000)
        p.add_argument("--save_epoch_freq", type=int, default=5)
        p.add_argument("--continue_train", action="store_true")
        p.add_argument("--epoch_count", type=int, default=1)
        p.add_argument("--phase", type=str, default="train")
        p.add_argument("--which_epoch", type=str, default="latest")
        p.add_argument("--niter", type=int, default=100,
                       help="epochs at initial lr")
        p.add_argument("--niter_decay", type=int, default=100,
                       help="epochs of linear lr decay to zero")
        p.add_argument("--beta1", type=float, default=0.5)
        p.add_argument("--lr", type=float, default=2e-4)
        p.add_argument("--no_lsgan", action="store_true",
                       help="use vanilla GAN loss instead of LSGAN")
        p.add_argument("--lambda_L1", type=float, default=100.0)
        p.add_argument("--lambda_L2", type=float, default=0.0,
                       help="masked MSE weight in compressed-mag space "
                            "— the hole-PSNR metric's own space, whose "
                            "optimum is the posterior MEAN (L1's is the "
                            "median); swap in for --lambda_L1 to train "
                            "the metric-matched regression estimator")
        p.add_argument("--hole_weight", type=float, default=1.0)
        p.add_argument("--lambda_sc", type=float, default=0.0,
                       help="hole spectral-convergence weight (linear-"
                            "magnitude Frobenius; onset-energy term)")
        p.add_argument("--lambda_phase", type=float, default=1.0,
                       help="hole phase-cosine loss weight (only with "
                            "--phase_head): magnitude-weighted "
                            "1-cos(dphi) on the predicted hole phase")
        p.add_argument("--lambda_onset", type=float, default=0.0,
                       help="spectral-flux (time-derivative) L1 weight")
        p.add_argument("--lambda_fm", type=float, default=0.0,
                       help="discriminator feature-matching weight "
                            "(MelGAN/HiFi-GAN-style per-layer L1 on D "
                            "features, fake vs real)")
        p.add_argument("--pool_size", type=int, default=0)
        p.add_argument("--lr_policy", type=str, default="lambda",
                       choices=["lambda", "step", "plateau", "cosine",
                                "constant"])
        p.add_argument("--lr_decay_iters", type=int, default=50)
        p.add_argument("--update_order", type=str, default="simultaneous",
                       choices=["simultaneous", "sequential"])
        p.add_argument("--steps_per_epoch", type=int, default=0,
                       help="0 = derive from dataset length / batchSize")
        p.add_argument("--tensorboard", action="store_true",
                       help="also write the losses as TensorBoard event "
                            "files under <expr_dir>/tb")
        self.isTrain = True


class TestOptions(BaseOptions):
    def initialize(self):
        super().initialize()
        p = self.parser
        p.add_argument("--ntest", type=int, default=float("inf"))
        p.add_argument("--results_dir", type=str, default="./results/")
        p.add_argument("--phase", type=str, default="test")
        p.add_argument("--which_epoch", type=str, default="latest")
        p.add_argument("--how_many", type=int, default=50)
        p.add_argument("--oracle_mag", action="store_true",
                       help="evaluation-only attribution mode: use the "
                            "GROUND-TRUTH magnitude in the hole (after "
                            "the compress/decompress image round-trip) "
                            "instead of G's prediction — measures the "
                            "reconstruction ceiling of the phase-"
                            "recovery pipeline itself")
        p.add_argument("--refiner", action="store_true",
                       help="run the stage-2 diffusion refiner "
                            "(train/diffusion.py) between G and GL: "
                            "loads {refiner_epoch}_net_R.pth from the "
                            "checkpoint dir")
        p.add_argument("--refiner_epoch", type=str, default="latest",
                       help="epoch tag of the refiner checkpoint")
        p.add_argument("--rngf", type=int, default=64,
                       help="refiner width (must match the trained R)")
        p.add_argument("--refine_steps", type=int, default=8,
                       help="DDIM steps for the refinement")
        p.add_argument("--refine_t", type=float, default=0.35,
                       help="SDEdit truncation: diffuse G's output to "
                            "this t before denoising (1.0 = full "
                            "generation from noise)")
        p.add_argument("--refine_noise", type=float, default=1.0,
                       help="initial-noise scale for the refinement "
                            "(0.0 = fully deterministic corrector)")
        p.add_argument("--refine_guidance", type=float, default=0.0,
                       help="classifier-free guidance scale over the "
                            "g_pred conditioning channel (requires a "
                            "refiner trained with --cond_drop > 0); "
                            "0 = off")
        p.add_argument("--eval_samples", type=int, default=1,
                       help="best-of-K posterior sampling at eval "
                            "(refiner only): run K decoupled-noise "
                            "refinements per clip, keep the best "
                            "hole-PSNR one; logs hole_psnr_s1_mean "
                            "(first sample) beside the best-of-K mean "
                            "— the posterior-coverage diagnostic")
        p.add_argument("--refine_avg", type=int, default=1,
                       help="posterior-MEAN estimate: average K "
                            "independent-noise DDIM refinements of the "
                            "hole before the decode (one GL / one "
                            "iSTFT either way); 1 = off")
        p.add_argument("--refine_chunk", type=int, default=8,
                       help="posterior-mean memory chunking: run at "
                            "most this many refine_avg samples as one "
                            "batch (running sum); peak memory is "
                            "chunk×batch DDIM intermediates for any K")
        p.add_argument("--complex_mag", type=str, default="sample",
                       choices=["sample", "keep", "mean"],
                       help="complex-domain hybrid decode: phase always "
                            "from the refined complex estimate; hole "
                            "magnitude from the estimate itself "
                            "('sample'), from G's regression "
                            "prediction ('keep'), or from E[|x|] over "
                            "the refine_avg samples ('mean' — "
                            "shrinkage-free, unlike |E[x]|)")
        p.add_argument("--refine_selfcond", action="store_true",
                       help="the refiner was trained with "
                            "self-conditioning (R carries its previous "
                            "x̂0 as an extra input channel); each DDIM "
                            "step feeds the prior step's estimate "
                            "forward")
        p.add_argument("--ensemble_names", type=str, default="",
                       help="comma-separated extra checkpoint run "
                            "names (same architecture + --which_epoch)"
                            " whose Gs are averaged with this run's in "
                            "compressed-magnitude space — a deep "
                            "ensemble over training seeds")
        p.add_argument("--refine_mix", type=float, default=0.0,
                       help="convex ensemble weight on the regression "
                            "G's hole vs the refiner estimate "
                            "(mag-domain refiner only): x = mix*G + "
                            "(1-mix)*refined before the GL decode; "
                            "0 = off")
        p.add_argument("--refine_resample", type=int, default=0,
                       help="RePaint time-travel rounds per DDIM step "
                            "(each round re-noises u back to t and "
                            "re-denoises; (N+1)x network calls); 0 = "
                            "off")
        p.add_argument("--refine_clamp", type=str, default="x0",
                       choices=["x0", "q"],
                       help="observed-region handling inside DDIM: "
                            "'x0' clamps x0-hat each step; 'q' "
                            "re-noises the observed region to "
                            "q(x_u|x0) (RePaint-style; pair with "
                            "hole-only-trained refiners)")
        p.add_argument("--refiner_domain", type=str, default="mag",
                       choices=["mag", "complex"],
                       help="mag: SDEdit-refine G's magnitude image, "
                            "then Griffin-Lim (default). complex: DDIM "
                            "over the hole's compressed COMPLEX STFT, "
                            "decoded by one iSTFT (no GL); requires a "
                            "complex-domain refiner")
        p.add_argument("--log_results", type=str, default="",
                       help="when set, append the eval summary (tagged "
                            "with this string) to {results_dir}/"
                            "quality_results.jsonl, or to the file "
                            "VIAI_RESULTS_JSONL names")
        p.add_argument("--refiner_net", type=str, default="R",
                       choices=["R", "Rraw"],
                       help="which refiner checkpoint family to load: "
                            "R = EMA weights (default), Rraw = raw "
                            "(non-EMA) weights")
        self.isTrain = False


def device_from_opt(opt):
    """--gpu_ids → torch.device: -1 is the CPU, anything else the CUDA
    card of the first id (which must exist: resolve_device raises)."""
    from .._device import resolve_device

    ids = [i.strip() for i in str(opt.gpu_ids).split(",") if i.strip()]
    if not ids or ids[0] == "-1":
        return resolve_device("cpu")
    return resolve_device(f"cuda:{int(ids[0])}")
