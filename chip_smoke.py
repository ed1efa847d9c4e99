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
 12. frame directories ([frames]): the native JPEG/PNG decoder
     (csrc/imagedec.cpp) against PIL's decodes of the committed
     fixtures of tests/torch_frames/ (JPEG within 1 level, PNG exact)
     and against its plain twin data/image.py (exact), the directory
     reader against the twin on the committed 224x224 jpeg clip; the
     av model (the README's recipe) trained 20 steps at batch 16 from
     [data]'s av clips with frame directories (copies of the clip, one
     as PNG) through the train CLI, GL launches 2 and plain 0; the eval
     CLI on a musices split of them; the loader's wait share over 10
     steps, the decode time per frame and the host's cores;
 13. compressed and uncompressed video ([video]): the native demuxers
     and decoders (csrc/videodec.cpp, csrc/mpeg4.cpp, csrc/mpeg12.cpp,
     csrc/vp8.cpp, csrc/vp9.cpp, csrc/h264.cpp, csrc/hevc.cpp,
     csrc/rawvideo.cpp) on the committed fixtures of tests/torch_videos/
     against cv2's committed decodes, frame counts and, for video as
     phones and muxers write it (turned, fragmented, without
     DefaultDuration, with sound), orientations (every codec exact), a
     1080p HEVC clip against cv2's SHA-256 of each frame, an AV1 sample
     entry and HEVC 4:2:2 (x265's SPS patched) raising
     NotImplementedError; the av model (the
     README's recipe) trained 20 steps at batch 16 from [data]'s av clips
     given the committed 224x224 video files as frames, once from MJPEG
     and MPEG-4 files (.avi, .mp4, .mkv, and a MOV made a stack by
     prepare_dataset extract), once from VP8 files (.webm, .mkv), once
     from VP9 files (.webm, .mp4), once from H.264 files (.mp4 High,
     .mkv Main), once from camera and cut clips (MJPEG 4:2:2 in OpenDML
     AVI, H.264 under a trimming MP4 edit) and once from MPEG-4 Advanced
     Simple Profile files (XviD in AVI: packed B-VOPs, quarter-pel, 4MV,
     GMC; libavcodec's mpeg4 in MP4: B-VOPs, 4MV, AC prediction) and
     once from phone clips (H.264 turned 90 degrees with AAC,
     fragmented, and header-stripped in Matroska as mkvmerge wrote it;
     HEVC in Matroska without DefaultDuration), once from camera clips
     (High 4:2:2 10-bit, PsF),
     once from browser clips (VP9 profile 2 10-bit BT.2020, VP9
     realtime with reference scaling and a size change) and once from
     screen clips (H.264 High 4:4:4 Predictive 8-bit as ffmpeg writes it
     from images, lossless 4:2:0 as a screen capture), once from DVD
     clips (MPEG-2, MPEG-1), once from uncompressed clips (cv2's
     writer's I420, a capture tool's YUY2) and once from HEVC clips (a
     phone's hvc1 MP4 turned 90 degrees with AAC, open GOPs of 8; its
     Matroska copy), GL launches 2 and plain 0 each; the eval CLI on a
     musices split of each folder; each folder's time split (writing its
     corpus, the train CLI, the eval CLI) and its loader's wait share,
     measured in its training run;
     each MPEG-4 fixture's max |Δ|, each phone and muxer fixture's count
     and orientation, each camera, browser and screen fixture's count
     and max |Δ|, the browser clips' reads against the JAX package's
     committed picks, each uncompressed fixture's count and max |Δ|,
     each fixture of video as mkvmerge and other muxers store it
     (content encodings, rates without DefaultDuration, laced blocks,
     fragmented MP4's tails, MJPEG field pairs and 4:1:1, grey and GBR
     scaled) with its count and max |Δ|;
     the decode time per frame of each codec, a header-stripped frame's
     against its plain twin's, of a
     turned frame against the same file unturned, a 10-bit frame's
     conversion share, a 4:4:4 and a lossless frame's conversion share,
     a picture's upscale to the first one's size, a scaled-reference
     frame's read against an unscaled one's, a clip's read of 16 frames,
     a 224x224 I420 and a 720x480 YUY2 frame's read and conversion,
     a 224x224 and a 1920x1080 HEVC frame's decode (one thread), and the
     host's cores;
 14. refiner training: [train refiner] runs the refiner CLI at its
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
 15. the bench entry point: [bench] runs viai_tpu_torch.bench.main once
     per preset at its defaults (bf16 G and R, GL×32, batch 128) but
     --inner 8 for default (one CUDA graph of 8 chained calls) and
     --inner 1 for the refiner presets, batch 32 for the complex ones,
     launches counted; [bench reference] holds each preset's bf16 chain
     on the card against its float32 chain on the CPU (same weights,
     clips, masks and injected noise, GL×1; bucket 8, the complex
     presets 2 clips), the CPU chains computed by a process of the
     script's own started with it (no card, nice 19) and joined there;
     [profile bench] profiles one default call at
     batch 128 (busy share, kernel rows, elementwise share);
 16. the mesh: [mesh] starts a 1-rank NCCL group from a file store;
     make_mesh() is 1x1, a tiny SGD step through make_train_step(mesh=)
     and a bucket-8 InpaintService(mesh=) request at full width equal
     their runs without a mesh bit for bit (launches counted), and the
     group is torn down;
 17. the scripts ([scripts]): viai_tpu_torch.scripts.<name>.main at
     full width, steps cut (SCRIPT_CUTS, printed): quality_report (and
     --long_gap) and av_ablation, their hole-PSNRs finite and train
     clips/s printed with the card; quality_long 20 steps with
     milestones at 10 and 20, its step-10 state loaded again and held
     equal to the save bit for bit, a resume from it, its step-20 nets
     served by the eval CLI (16 clips) and diagnosed by grid_diag;
     bayes_ceiling; cost_analysis at batch 128, where G's forward must
     read 128 x 18.40 GFLOP; prepare_dataset's synthetic, extract (an
     AVI with PCM at 22.05 kHz; a broken .mp4 skipped), manifest and download
     --dry_run, and 5 av train steps from the folder it prepared. Every
     record carries "package"; the GL launches are counted;
 18. [tensorboard]: the train CLI with --tensorboard, 10 steps; the
     event file read back with the port's CRC-checking reader equals
     loss_log.jsonl;
 19. [compile cache]: with VIAI_CACHE_DIR set, the GL kernel builds
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
import hashlib
import json
import os
import pathlib
import shutil
import struct
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
from viai_tpu_torch.train.diffusion import (RefineNoise,
                                            complex_refiner_channels,
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
# [bench reference]'s float32 CPU chains (and the weights, clips and
# noise they share with the card) are computed by a process of their own,
# started with the script (bench_reference_cpu: no card, nice 19,
# BENCH_REF_THREADS torch threads, so that it takes cores the phases
# before leave idle) and joined in the phase, which took 98.0 s of PR
# 20's final run with them inline (NVIDIA H100 80GB HBM3, 700 W).
BENCH_REF_THREADS = 2
BENCH_REF_SEED = 5
BENCH_REF_FLAG = "--bench-reference-cpu"
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
# [frames]: the committed fixtures of tests/torch_frames/ (written with
# PIL by tests/_torch_make_frames.py, which the card's machine cannot
# run): small JPEG and PNG cases with PIL's decode of each (.npy) and a
# 32-frame 224x224 quality-75 4:2:0 clip. Decoded against PIL: JPEG
# within FRAMES_JPEG_TOL levels, PNG exact; against the plain twin
# (data/image.py): exact. [data]'s av clips get frame directories: each
# a copy of the clip, the last one the clip as PNG files.
FRAMES_FIXTURES = pathlib.Path(__file__).resolve().parent / "tests" / \
    "torch_frames"
FRAMES_JPEG_TOL = 1
FRAMES_TWIN = (8, 64, (0.25, 0.75))    # frames, size, window of the twin
FRAMES_WARMUP = 3
# [video]: the committed fixtures of tests/torch_videos/ (written with cv2,
# libvpx, libx264, libx265, and libavcodec 59's mpeg4 and libxvid
# encoders by
# tests/_torch_make_videos.py, which the card's machine cannot run): MJPEG,
# MPEG-4 Part 2 (Simple and Advanced Simple Profile: B-VOPs packed and
# not, quarter-pel, GMC, 4MV, AC prediction, MPEG quantisation, video
# packets, the XviD IDCT), VP8, VP9 and H.264 clips in
# AVI, MP4, MOV, Matroska and WebM, and video as phones and muxers write
# it (MP4 display matrices, Matroska projections, fragmented MP4,
# Matroska without DefaultDuration, PCM and AAC sound tracks), with
# cv2's decode of their first, middle and last frames, its frame count
# and, for the latter, its orientation (.npz), and the first frames
# of the 224x224 jpeg clip as clip.avi (MJPEG), clip.mp4 and clip.mkv
# (MPEG-4), clip.mov (MJPEG), clip.webm and clip_vp8.mkv (VP8),
# clip_vp9.webm and clip_vp9.mp4 (VP9), clip_h264.mp4 (High, CABAC,
# B-frames) and clip_h264.mkv (Main, CAVLC), clip_cam.avi (a webcam's
# MJPEG 4:2:2 in an OpenDML AVI with a RIFF AVIX), clip_cut.mp4 (High cut
# as `ffmpeg -ss ... -c copy` leaves it: an edit that drops the first 4 of
# 20 frames), clip_oddh.avi (MJPEG 4:2:0 at 224x223, swscale's scaler
# path; timed only), clip_xvid.avi (libxvid: packed B-VOPs, quarter-pel,
# 4MV, GMC of 3 warping points) and clip_dx50.mp4 (libavcodec's mpeg4:
# B-VOPs, 4MV, AC prediction), clip_phone.mp4 (High at 224x160 under a
# 90 degree tkhd matrix, AAC in interleaved chunks: a phone held upright)
# and clip_frag.mp4 (the same stream fragmented, one fragment a
# keyframe, AAC in trafs of its own), clip_xavc.mp4 (High 4:2:2 at 10
# bits with B-frames: an XAVC S 4:2:2 10-bit camera's long GOP) and
# clip_avchd.mkv (progressive frames of an interlace-capable High stream
# with B-frames, its bitstream_restriction cleared: AVCHD at 25p as
# `ffmpeg -c copy` remuxes it), clip_hdr.webm (VP9 profile 2, 10-bit
# 4:2:0, BT.2020, two-pass with alt-refs: YouTube's HDR VP9) and
# clip_rtc.webm (VP9 realtime that drops to 112x112 by reference scaling
# and comes back with a keyframe: a WebRTC or MediaRecorder recording;
# its small pictures converted up to the first picture's size as cv2's
# swscale converts them), clip_screen.mp4 (H.264 High 4:4:4 Predictive
# at 8 bits, the medium preset: a clip rebuilt from frame images by
# ffmpeg's defaults) and clip_lossless.mkv (lossless 4:2:0, the
# ultrafast preset: a screen capture), beside the H.264 that cameras and
# other encoders write (CAMERA_FIXTURES: 10-bit, 4:2:2, monochrome, PsF,
# reorder depths libavcodec guesses, B sub-8x8 partitions) and the VP9
# that YouTube and browsers write and pictures that change size
# mid-stream (BROWSER_FIXTURES: profiles 1-3 at 8, 10 and 12 bits in
# 4:2:0, 4:2:2, 4:4:0, 4:4:4 and sRGB, reference scaling, SVC superframes
# with an intra-only frame, new sizes in VP9, MJPEG and H.264) and the
# H.264 that ffmpeg writes from images and screens (SCREEN_FIXTURES:
# 4:4:4 at 8, 10 and 14 bits, GBR, lossless at every sampling, 12-bit
# 4:2:0) and the MPEG-1 and MPEG-2 that DVD rips, broadcast captures and
# OpenCV's own writer store (DVD_FIXTURES: low_delay 0, open and closed
# GOPs, B-15, the non-linear scale, intra_dc_precision 9-11, matrices,
# BT.709, 4:2:2 with chroma matrices, odd sizes, soft telecine, a new
# size, a copy cut at an open GOP, field DCT and motion in progressive
# frames; in AVI, MP4 and
# Matroska), beside clip_dvd.mkv (MPEG-2 at 720x480 as MakeMKV stores a
# DVD film title: soft telecine, open GOPs of 12) and clip_pim1.avi
# (MPEG-1 at 352x240, cv2.VideoWriter's PIM1), and the uncompressed video
# that OpenCV's writer, capture tools and ffmpeg store (raw_*: planar,
# semi-planar and packed YUV, grey, v210, BI_RGB at 8, 16 and 32 bits in
# AVI at 64x48 and 45x29, V_UNCOMPRESSED Matroska, cv2's own files for
# fourcc 0, I420, IYUV, YV12, NV12, Y800, GREY and RGBA), beside
# clip_i420.avi (cv2.VideoWriter's fourcc 0) and clip_yuy2.avi (YUY2 as
# `ffmpeg -f v4l2 -c:v copy` stores a webcam's frames), and the HEVC that
# phones, cameras and x265 write (HEVC_FIXTURES, libx265 through
# libavcodec 59), beside clip_hevc.mp4 (a phone's hvc1 turned 90 degrees
# with AAC, open GOPs of 8) and clip_hevc.mkv, and the H.264 that does
# not start at an IDR picture or uses tools libx264 never writes
# (TOOLS_FIXTURES), beside clip_gopcut.mkv (open GOPs cut at a recovery
# point, with a sound track), and the lossless video that capture tools,
# archives and OpenCV's writer store (LOSSLESS_PREFIXES: FFV1 versions 0
# to 3 with both coders, slices with CRCs, non-key frames, 4:2:0 to 4:1:0,
# 10 and 16 bits, grey, alpha and RGB; UT Video's eight classic layouts;
# HuffYUV 1.x with the classic tables, HuffYUV 2.x and FFVHuff up to 16
# bits; PNG at 8 and 16 bits and with a palette; in AVI and Matroska, and
# cv2's own files), beside clip_ffv1.mkv (FFV1 level 3, 10-bit 4:2:2, 4
# slices with CRCs, as archives keep it) and clip_utvideo.avi (UT Video
# ULY0 as OBS's lossless preset records it), and the codecs OpenCV's
# writer writes that the port reads (OPENCV_PREFIXES:
# MagicYUV at 8 to 14 bits, ASV1, ASV2, Snow) beside their clips
# (OPENCV_CLIPS: cv2's MAGY, ASV2 and SNOW at 224x224). Decoded
# against cv2 within VIDEO_TOL levels (measured 0 on the CPU). [data]'s
# av clips get these files as their frames (VIDEO_FOLDERS); the .mov,
# which load_frames_for does not look for (as in the JAX package),
# becomes a frame stack through prepare_dataset extract.
VIDEO_FIXTURES = pathlib.Path(__file__).resolve().parent / "tests" / \
    "torch_videos"
VIDEO_TOL = {"mjpeg": 0, "mpeg4": 0, "vp8": 0, "vp9": 0, "h264": 0,
             "mpeg12": 0, "raw": 0, "hevc": 0, "ffv1": 0, "utvideo": 0,
             "huffyuv": 0, "png": 0, "h263": 0, "h261": 0, "magicyuv": 0,
             "asv": 0, "snow": 0, "muxers": 0}
VIDEO_NAMES = {"mjpeg": "MJPEG", "mpeg4": "MPEG-4 Part 2", "vp8": "VP8",
               "vp9": "VP9", "h264": "H.264", "mpeg12": "MPEG-1/2",
               "raw": "uncompressed", "hevc": "HEVC", "ffv1": "FFV1",
               "utvideo": "UT Video", "huffyuv": "HuffYUV/FFVHuff",
               "png": "PNG",
               "h263": "H.263 family (MS-MPEG4 v2/v3, WMV1/2, FLV1, ITU "
                       "H.263 and H.263+)",
               "h261": "H.261", "magicyuv": "MagicYUV (8 to 14 bits)",
               "asv": "ASUS ASV1/ASV2", "snow": "Snow",
               "muxers": "muxers' tails (every codec)"}
# folder: the frame files of its clips in turn; "clip.mov" (last) through
# prepare_dataset extract, "clip.mkv" for the one before it.
VIDEO_FOLDERS = {"mjpeg_mpeg4": ("clip.avi", "clip.mp4"),
                 "vp8": ("clip.webm", "clip_vp8.mkv"),
                 "vp9": ("clip_vp9.webm", "clip_vp9.mp4"),
                 "h264": ("clip_h264.mp4", "clip_h264.mkv"),
                 "cam_cut": ("clip_cam.avi", "clip_cut.mp4"),
                 "xvid": ("clip_xvid.avi", "clip_dx50.mp4", "clip_div3.avi",
                          "clip_wmv2.avi", "clip_h263p.mp4", "clip_snow.avi",
                          "clip_asv2.mkv"),
                 "phone": ("clip_phone.mp4", "clip_frag.mp4",
                           "clip_strip.mkv", "clip_nodd.mkv"),
                 "camera": ("clip_xavc.mp4", "clip_avchd.mkv"),
                 "browser": ("clip_hdr.webm", "clip_rtc.webm"),
                 "screen": ("clip_screen.mp4", "clip_lossless.mkv"),
                 "dvd": ("clip_dvd.mkv", "clip_pim1.avi"),
                 "raw": ("clip_i420.avi", "clip_yuy2.avi"),
                 "hevc": ("clip_hevc.mp4", "clip_hevc.mkv"),
                 "cuts": ("clip_gopcut.mkv",),
                 "lossless": ("clip_ffv1.mkv", "clip_utvideo.avi",
                              "clip_magy.avi")}
# the committed fixtures of H.264 as cameras and other encoders write it
# (tests/_torch_make_videos.py's CAMERA_CASES), each held and printed
CAMERA_FIXTURES = (
    "h264_42210_mp4", "h264_42210intra_mkv", "h264_42210cavlc_avi",
    "h264_42010_avi", "h264_4228_mkv", "h264_mono8_avi", "h264_mono10_mp4",
    "h264_pcm10_avi", "h264_psf_mp4", "h264_psfcrop_mkv", "h264_psfsei_avi",
    "h264_norestrict_avi", "h264_norestrict_mp4", "h264_novui_mkv",
    "h264_deep_avi", "h264_sub8x8_avi")
# the committed fixtures of VP9 as YouTube and browsers write it and of
# pictures that change size mid-stream (tests/_torch_make_videos.py's
# BROWSER_CASES), each held and printed; and the browser folder's clips,
# whose .npz also hold the JAX package's picks of 16 frames at 64x64 for
# each window (levels; (-1, -1) for the whole clip)
BROWSER_FIXTURES = (
    "vp9_hdr10_webm", "vp9_hdr12_mp4", "vp9_444_mkv", "vp9_422_webm",
    "vp9_440_avi", "vp9_44410_mp4", "vp9_44012_webm", "vp9_42210_mkv",
    "vp9_srgb_webm", "vp9_srgb10_mkv", "vp9_srgb12_mp4",
    "vp9_scaled_webm", "vp9_scaledkf_mkv",
    "vp9_scaledaq_mp4", "vp9_scaledodd_avi", "vp9_scaled10_webm",
    "vp9_svc_webm", "vp9_newsize_webm", "vp9_container_webm",
    "mjpeg_newsize_avi", "h264_newsize_avi")
BROWSER_CLIPS = ("clip_hdr_webm", "clip_rtc_webm")
# the committed fixtures of H.264 as ffmpeg writes it from images and
# screens (tests/_torch_make_videos.py's SCREEN_CASES), each held and
# printed
SCREEN_FIXTURES = (
    "h264_444_mp4", "h264_444cavlc_avi", "h264_444intra_mkv",
    "h264_44410_mp4", "h264_444cqm_avi", "h264_444matrix_mkv",
    "h264_444pcm_avi", "h264_444crop_mkv", "h264_gbr_mp4",
    "h264_gbrlossless_avi", "h264_lossless_avi", "h264_losslessb_mkv",
    "h264_lossless422_mp4", "h264_lossless444_avi", "h264_lossless10_mkv",
    "h264_12bit_avi", "h264_14bit_mkv")
# the committed fixtures of MPEG-1 and MPEG-2 as DVD rips, broadcast
# captures and OpenCV's writer store them (tests/_torch_make_videos.py's
# DVD_CASES, each stream in AVI, MP4 and Matroska) and the dvd folder's
# clips, each held and printed
DVD_FIXTURES = tuple(
    f"{stream}_{c}" for stream in (
        "mpeg2_ip", "mpeg2_bf", "mpeg2_cgop", "mpeg2_vlc", "mpeg2_nlq",
        "mpeg2_dc11", "mpeg2_altscan", "mpeg2_fieldpred", "mpeg2_matrix",
        "mpeg2_bt709", "mpeg2_422", "mpeg2_422q", "mpeg2_odd",
        "mpeg2_telecine", "mpeg2_newsize", "mpeg2_cut", "mpeg1_bf",
        "mpeg1_odd")
    for c in ("avi", "mp4", "mkv"))
DVD_CLIPS = ("clip_dvd_mkv", "clip_pim1_avi")
# the uncompressed video of tests/_torch_make_videos.py's RAW_CASES (every
# committed raw_*.npz) and the raw folder's clips, each held and printed
RAW_CLIPS = ("clip_i420_avi", "clip_yuy2_avi")
# the committed fixtures of HEVC as phones, cameras and x265 write it
# (tests/_torch_make_videos.py's HEVC_CASES: x265's settings one by one,
# Main 10, a CRA cut; in MP4, Matroska and AVI) and the hevc folder's
# clips, each held and printed; and the 1080p clip (4 frames, libx265's
# defaults in MP4) whose frames are held against cv2's SHA-256 and timed
HEVC_FIXTURES = (
    "hevc_default_mp4", "hevc_hev1_mp4", "hevc_nowpp_mkv", "hevc_slices_avi",
    "hevc_wpp16_avi", "hevc_tskip_mkv", "hevc_amp_mp4", "hevc_weightb_avi", "hevc_scaling_mkv",
    "hevc_ctu32_avi", "hevc_ctu16_mp4", "hevc_opengop_mkv", "hevc_radl_avi",
    "hevc_irefresh_mp4", "hevc_cintra_mkv", "hevc_cintra16_avi",
    "hevc_cintra4_mp4", "hevc_cintra32_mkv", "hevc_tlayers_avi",
    "hevc_bframes8_mp4", "hevc_nosign_mkv", "hevc_tu8_avi",
    "hevc_lossless_mp4", "hevc_culossless_mkv", "hevc_still_avi",
    "hevc_crop_mkv", "hevc_main10_mp4", "hevc_main10gop_mkv",
    "hevc_cracut_mp4", "hevc_cracut_mkv")
HEVC_CLIPS = ("clip_hevc_mp4", "clip_hevc_mkv")
# the committed fixtures of H.264 that does not start at an IDR picture or
# uses tools libx264 never writes (tests/_torch_make_videos.py's
# H264_TOOLS: copy cuts at recovery points and P pictures, left and top
# crops, POC type 1, gaps in frame_num, explicit B weights, long-term
# references and MMCO 1-6) and the cuts folder's clip, each held and
# printed
TOOLS_FIXTURES = (
    "h264_gopcut_avi", "h264_gopcut_mkv", "h264_gopcut_mp4",
    "h264_leadcut_mkv", "h264_leadcut_mp4", "h264_noseicut_mkv",
    "h264_refcut_avi", "h264_refcut_mkv", "h264_refcut_mp4",
    "h264_midcut_mkv", "h264_pcut_mkv", "h264_pcut_avi", "h264_crop84_avi",
    "h264_crop2_avi", "h264_crop32_mkv", "h264_croptop_avi",
    "h264_crop444_avi", "h264_crop10_mkv", "h264_crop422_mp4",
    "h264_poc1_avi", "h264_poc1d_avi", "h264_poc1b_mkv", "h264_poc1c_mp4",
    "h264_gaps_avi", "h264_gapsoff_avi", "h264_gapsb_mkv",
    "h264_gapsboff_mkv", "h264_bipred_avi", "h264_bipredc_mkv",
    "h264_ltr_avi", "h264_ltr5_mkv", "h264_ltrc5_avi", "h264_ltrt_avi",
    "h264_ltrt5_mkv", "h264_ltrs_mp4", "h264_ltrs5_avi", "h264_ltrt5p_mp4",
    "h264_graycut_mkv")
TOOLS_CLIPS = ("clip_gopcut_mkv",)
# the committed fixtures of lossless video (tests/_torch_make_videos.py's
# LOSSLESS_CASES: every .npz of these prefixes) and the lossless folder's
# clips, each held and printed
LOSSLESS_PREFIXES = ("ffv1_", "ut_", "hfyu_", "ffvh_", "png_",
                     "lossless_cv2")
LOSSLESS_CLIPS = ("clip_ffv1_mkv", "clip_utvideo_avi")
# the committed fixtures of video as mkvmerge and other muxers store it
# (tests/_torch_make_videos.py's MUXER_CASES: Matroska header stripping,
# zlib and LZO; rates without DefaultDuration from the streams' own
# timing; laced blocks; fragmented MP4 with timecode and text tracks and a
# second sample entry; MJPEG field pairs and 4:1:1; grey and GBR scaled)
# and the phone folder's clip_strip.mkv and clip_nodd.mkv, each held and
# printed
MUXER_FIXTURES = (
    "h264_strip_mkv", "h264_zlib_mkv", "h264_lzo_mkv", "hevc_strip_mkv",
    "hevc_zlib_mkv", "mpeg4_strip_mkv", "mpeg2_strip_mkv", "vp8_zlib_mkv",
    "mjpeg_strip_mkv", "raw_zlib_mkv", "hfyu_zlib_mkv", "hfyu_lzo_mkv",
    "h264_nodd30_mkv", "h264_nodd50_mkv", "h264_vui2997_mkv",
    "h264_vui60_mkv", "hevc_nodd24_mkv", "hevc_vui15_mkv", "mpeg4_vol30_mkv",
    "mpeg4_vol120_mkv", "mpeg4_vol1000_mkv", "mpeg2_nodd24_mkv",
    "mpeg1_nodd25_mkv", "mpeg1_nodd60_mkv", "vp8_lace2_mkv", "vp8_lace3_mkv",
    "mjpeg_lace3_mkv", "raw_lace4_mkv", "h264_lace2_mkv",
    "h264_striplace_mkv", "mpeg4_fragtmcd_mp4", "h264_fragtext_mp4",
    "h264_fragtmcd_mp4", "h264_fragdesc_mp4", "mjpeg_411_avi",
    "mjpeg_411odd_avi", "mjpeg_fields_avi", "mjpeg_fieldsodd_avi",
    "mjpeg_fields_mkv", "mjpeg_fieldsavrn_avi", "mjpeg_greyresize_avi",
    "h264_gbrhalf_avi")
MUXER_CLIPS = ("clip_strip_mkv", "clip_nodd_mkv")
# the committed fixtures of the H.263 family as old AVIs and OpenCV's
# writer store it (tests/_torch_make_videos.py's LEGACY_CASES: MS-MPEG4 v2
# and v3 under their tags and Matroska's V_MPEG4/MS/V3, WMV1 with
# inter-intra prediction, WMV2 with its loop filter, coded block pattern
# tables and skip maps, FLV1 with disposable pictures, slices written in,
# cv2's own files) and of ITU video telephony as OpenCV's writer and old
# phones store it (ITU_CASES: H.263 baseline with 4MV, OBMC, GOB headers
# and DQUANT, H.263+ with Annexes D, I, J, K, S and T, H.261; AVI,
# Matroska and MP4's s263; every .npz of these prefixes) and their clips
# (224x224 but clip_h263.avi and clip_h261.avi at CIF; clip_div3.avi,
# clip_wmv2.avi and clip_h263p.mp4 train in the xvid folder), each held
# and printed, and a frame of each codec timed
LEGACY_PREFIXES = ("msmpeg4", "wmv1_", "wmv2_", "flv_", "cv2_", "h263_",
                   "h263p_", "h261_")
LEGACY_CLIPS = {"clip_div3.avi": "MS-MPEG4 v3 (DivX 3), GOPs of 12",
                "clip_mp42.avi": "MS-MPEG4 v2, GOPs of 12",
                "clip_wmv1.avi": "WMV1 (WMV7), GOPs of 12",
                "clip_wmv2.avi": "WMV2 (WMV8), GOPs of 12",
                "clip_flv1.avi": "Sorenson H.263 (FLV1), GOPs of 12",
                "clip_h263p.mp4": "H.263+ in an s263 MP4 (Annexes D, F, I, "
                                  "J, K, S, T), GOPs of 12",
                "clip_h263.avi": "H.263 baseline (4MV, OBMC), GOPs of 12",
                "clip_h261.avi": "H.261, GOPs of 12"}
# the committed fixtures of the codecs OpenCV's writer writes that the
# port reads since csrc/magicyuv.cpp, csrc/asv.cpp and csrc/snow.cpp
# (tests/_torch_make_videos.py's OPENCV_CASES: MagicYUV's 8-bit layouts
# from libavcodec's encoder under each predictor and its 10, 12 and
# 14-bit layouts, slices, raw slices and the interlace flag written by
# hand; ASV1 and ASV2 at every quantiser kind; Snow with both wavelets,
# lossless, qpel, 4MV, 2-4 references, 4:4:4, 4:1:0, grey; cv2's own
# files; every .npz of these prefixes) and their 224x224 clips as
# cv2.VideoWriter writes them (clip_magy.avi trains in the lossless
# folder, clip_snow.avi and clip_asv2.mkv in the xvid folder), each held
# and printed, and a frame of each codec timed
OPENCV_PREFIXES = ("magy", "asv1_", "asv2_", "snow_")
OPENCV_CLIPS = {"clip_magy.avi": "MagicYUV M8Y0 (cv2's writer, left "
                                 "prediction)",
                "clip_asv2.mkv": "ASUS ASV2 (cv2's writer)",
                "clip_snow.avi": "Snow 9/7, GOPs of 12 (cv2's writer)"}
HEVC_1080P, HEVC_1080P_SHA = "hevc_1080p.mp4", "hevc_1080p_sha256.json"
# [video]'s 720x480 YUY2 capture (random bytes, RAW_CAPTURE_FRAMES frames)
RAW_CAPTURE, RAW_CAPTURE_FRAMES = (480, 720), 8
# [video]'s repeats, cut to make room for the dvd folder (the script
# ran 1119.1 s of its 1200 s with them at 3 and 7, NVIDIA H100 80GB
# HBM3 at 700 W): decodes and reads timed as the best of VIDEO_REPS;
# turned and unturned decodes in TURN_ROUNDS turns; each folder's eval
# CLI reads its 3 test clips in the main process (VIDEO_EVAL_THREADS:
# --nThreads), not in 4 spawned workers
VIDEO_REPS = 2
TURN_ROUNDS = 4
VIDEO_EVAL_THREADS = 0
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
# Frame directories
# ---------------------------------------------------------------------------

def write_frame_dirs(root: pathlib.Path, wavs: list[str]) -> list[str]:
    """A folder of the av clips `wavs` (copied) whose frames are
    directories: the committed jpeg clip, the last one the clip as PNG
    files written by the port's own writer; musices.json over them.
    → the stems."""
    from viai_tpu_torch import native
    from viai_tpu_torch.utils.visualizer import _png_bytes

    root.mkdir(parents=True)
    clip = FRAMES_FIXTURES / "clip"
    stems = []
    for i, wav in enumerate(wavs):
        stem = root / pathlib.Path(wav).stem
        shutil.copy(wav, f"{stem}.wav")
        if i < len(wavs) - 1:
            shutil.copytree(clip, stem)
        else:
            stem.mkdir()
            for f in sorted(clip.iterdir()):
                (stem / f"{f.stem}.png").write_bytes(
                    _png_bytes(native.decode_image(f.read_bytes())))
        stems.append(str(stem))
    entries = [{"audio": f"{pathlib.Path(s).name}.wav",
                "frames": pathlib.Path(s).name} for s in stems]
    with open(root / "musices.json", "w") as f:
        json.dump({"train": entries[:10], "test": entries[10:]}, f)
    return stems


def phase_frames(dev, ckpt: str, card: str) -> int:
    """Frame directories on the card ([frames]): (a) the native JPEG/PNG
    decoder against PIL's committed decodes and against its plain twin,
    and the directory reader against the twin; (b) the av model trained
    20 steps at full width from jpeg/png frame directories through the
    train CLI; (c) the eval CLI on a musices split of them; (d) the
    loader's wait share of a step and the decode time per frame.
    Returns the GL kernel's launches."""
    from viai_tpu_torch import native
    from viai_tpu_torch.cli.train import main as train_main
    from viai_tpu_torch.data import create_dataloader, device_prefetch
    from viai_tpu_torch.data import image
    from viai_tpu_torch.model import VIAIModel

    # (a) the decoders
    worst = {".jpg": 0, ".png": 0}
    differ = {".jpg": [0, 0], ".png": [0, 0]}
    twin_equal = True
    cases = sorted(p for p in FRAMES_FIXTURES.iterdir()
                   if p.suffix in (".jpg", ".png"))
    for path in cases:
        data = path.read_bytes()
        got = native.decode_image(data)
        ref = np.load(path.with_suffix(".npy"))
        require(got.shape == ref.shape, f"[frames] {path.name}: shape "
                f"{got.shape}, PIL's {ref.shape}")
        worst[path.suffix] = max(worst[path.suffix], int(np.abs(
            got.astype(np.int64) - ref).max()))
        differ[path.suffix][0] += int((got != ref).sum())
        differ[path.suffix][1] += ref.size
        twin_equal &= np.array_equal(got, image.decode_image_numpy(data))
    clip = FRAMES_FIXTURES / "clip"
    frames = sorted(clip.iterdir())
    for path in (frames[0], frames[-1]):
        data = path.read_bytes()
        twin_equal &= np.array_equal(native.decode_image(data),
                                     image.decode_image_numpy(data))
    n, size, window = FRAMES_TWIN
    dir_err = float(np.abs(native.load_frame_dir(str(clip), n, size, window)
                           - image.frame_dir_numpy(str(clip), n, size,
                                                   window)).max())
    for ext, name in ((".jpg", "JPEG"), (".png", "PNG")):
        k, total = differ[ext]
        log(f"[frames] {name}: {sum(p.suffix == ext for p in cases)} "
            f"fixtures against PIL's committed decodes: {k} of {total} "
            f"bytes differ ({k / total:.3%}), max|Δ| {worst[ext]} levels "
            f"({'exact' if k == 0 else 'not exact'}; bound "
            f"{FRAMES_JPEG_TOL if ext == '.jpg' else 0})")
    log(f"[frames] native against the plain twin (data/image.py), every "
        f"fixture and clip frames 0 and {len(frames) - 1}: "
        f"{'equal' if twin_equal else 'DIFFERENT'}; the directory reader on "
        f"the clip ({n} frames of {window}, size {size}) max|Δ| "
        f"{dir_err:.3e} (bound 0)")
    require(worst[".jpg"] <= FRAMES_JPEG_TOL and worst[".png"] == 0,
            "[frames] the native decoder disagrees with PIL")
    require(twin_equal and dir_err == 0.0,
            "[frames] the native decoder disagrees with its plain twin")

    # (b) av training from frame directories
    corpus = pathlib.Path(ckpt) / "corpus"
    if not (corpus / "av").exists():
        write_corpus(corpus)
    root = pathlib.Path(ckpt) / "frames_corpus"
    stems = write_frame_dirs(
        root, sorted(str(p) for p in (corpus / "av").glob("*.wav")))
    log(f"[frames] corpus: {len(stems)} wav files of [data] with frame "
        f"directories ({len(stems) - 1} copies of the {len(frames)}-frame "
        f"224x224 jpeg clip, one of it as PNG), musices.json")
    args = data_train_args("av", ckpt, root)
    args[args.index("--name") + 1] = "chip_frames_av"
    args[args.index("--dataroot") + 1] = str(root)
    zero_counts()
    t0 = time.perf_counter()
    model = train_main(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = griffin_lim_cuda.launches, griffin_lim.calls
    losses = model.get_current_losses()
    log(f"[frames] train av from frame directories: {TRAIN_STEPS} steps at "
        f"batch {TRAIN_BATCH}, {FRAMES[0]} frames of {FRAMES[1]}x{FRAMES[2]} "
        f"a clip, through viai_tpu_torch.cli.train in {wall:.1f} s incl. the "
        f"loader's start; losses " + " ".join(f"{k} {v:.4f}"
                                             for k, v in losses.items())
        + f"; griffin_lim_cuda launches {launches}, plain {plain}")
    require(all(np.isfinite(v) for v in losses.values()),
            "[frames] train av: non-finite loss")
    require(launches == TRAIN_STEPS // TRAIN_DISPLAY and plain == 0,
            f"[frames] train av: GL launches {launches}, plain {plain}")
    total = launches
    del model

    # (c) the eval CLI on a musices split of frame directories
    _, launches = eval_arm(
        "(frames) chip_frames_av on the musices test split of frame "
        "directories",
        ["--name", "chip_frames_av", "--checkpoints_dir", ckpt, "--gpu_ids",
         "0", "--model", "av", "--gated", "--bottleneck_dilation", "1,2,4",
         "--dataset_mode", "musices", "--dataroot",
         str(root / "musices.json"), "--phase", "test", "--batchSize", "3",
         "--how_many", "3", "--results_dir", os.path.join(ckpt, "results")],
        3)
    require(launches > 0, "[frames] the eval CLI launched no GL")
    total += launches

    # (d) the loader's wait share and the decode time
    blobs = [p.read_bytes() for p in frames]
    t0 = time.perf_counter()
    for data in blobs:
        native.decode_image(data)
    decode_ms = (time.perf_counter() - t0) * 1e3 / len(blobs)
    t0 = time.perf_counter()
    native.load_frame_dir(str(clip), len(frames), FRAMES[1], threads=1)
    read_ms = (time.perf_counter() - t0) * 1e3 / len(frames)
    opt = parse_quietly(args)
    model = VIAIModel(opt)
    loader = create_dataloader(
        opt.dataset_mode, opt.dataroot, opt.batchSize, CLIP, SR,
        opt.nThreads, opt.n_video_frames, opt.frame_size, seed=opt.seed)
    batches = device_prefetch(iter(loader), dev)
    for _ in range(FRAMES_WARMUP):
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
    cores = len(os.sched_getaffinity(0))
    log(f"[frames] av from frame directories ({type(loader).__name__}, "
        f"{opt.nThreads} workers of {loader.dataset.frame_threads} decode "
        f"threads, prefetch depth 2): loader wait {wait * 1e3:.1f} ms "
        f"of {wall * 1e3:.1f} ms wall over {TRAIN_TIMED_STEPS} steps after "
        f"{FRAMES_WARMUP} ({wait / wall:.1%}), "
        f"{wall * 1e3 / TRAIN_TIMED_STEPS:.1f} ms a step; decode "
        f"{decode_ms:.3f} ms a 224x224 4:2:0 frame (native, one thread, "
        f"from memory), {read_ms:.3f} ms read + decode + resize to "
        f"{FRAMES[1]} (one thread); host {cores} cores (os.cpu_count "
        f"{os.cpu_count()}); {card}")
    del batches, model
    if hasattr(loader, "close"):
        loader.close()
    return total


# ---------------------------------------------------------------------------
# Compressed video
def video_clip_costs(best_ms, card: str, clips: dict, title: str):
    """[video] (d): a frame's decode of each clip of `clips` (file → what
    it holds: LEGACY_CLIPS, the H.263 family at 224x224 and H.263 and
    H.261 at 352x288, GOPs of 12; OPENCV_CLIPS, MagicYUV, ASV2 and Snow
    at 224x224 as cv2's writer writes them), each the best of VIDEO_REPS
    decodes of the whole file over its frames, on one thread."""
    from viai_tpu_torch import native

    res = []
    for src, what in clips.items():
        path = str(VIDEO_FIXTURES / src)
        n, h, w = native.decode_video(path).shape[:3]
        ms = best_ms(lambda: native.decode_video(path)) / n
        res.append(f"{what} ({src}) at {w}x{h}: {ms:.3f} ms a frame")
    log(f"[video] {title} decode (demux, decode, BGR; one thread): "
        + "; ".join(res) + f"; {card}")

# ---------------------------------------------------------------------------

def write_video_clips(root: pathlib.Path, wavs: list[str],
                      folder: str) -> list[str]:
    """A folder of the av clips `wavs` (copied) whose frames are the
    committed video files of VIDEO_FOLDERS[folder] in turn; for
    "mjpeg_mpeg4" clip.mkv (MPEG-4) for the second to last and for the
    last clip.mov made a frame stack by prepare_dataset extract;
    musices.json over them. → the frame file of each clip."""
    from viai_tpu_torch.scripts import prepare_dataset

    root.mkdir(parents=True)
    files = []
    turn = VIDEO_FOLDERS[folder]
    for i, wav in enumerate(wavs):
        stem = root / pathlib.Path(wav).stem
        shutil.copy(wav, f"{stem}.wav")
        if folder == "mjpeg_mpeg4" and i == len(wavs) - 1:
            raw = root.parent / "video_raw"
            raw.mkdir()
            shutil.copy(VIDEO_FIXTURES / "clip.mov", raw / f"{stem.name}.mov")
            rec = prepare_dataset.main([
                "extract", "--root", str(raw), "--out", str(root),
                "--results_dir", str(root.parent / "video_res")])
            require((rec["clips"], rec["frames_only"], rec["skipped"])
                    == (0, 1, 0), f"[video] prepare_dataset extract: {rec}")
            files.append(f"{stem}.npy")
            continue
        src = turn[i % len(turn)]
        if folder == "mjpeg_mpeg4" and i == len(wavs) - 2:
            src = "clip.mkv"
        ext = pathlib.Path(src).suffix
        shutil.copy(VIDEO_FIXTURES / src, f"{stem}{ext}")
        files.append(f"{stem}{ext}")
    entries = [{"audio": f"{pathlib.Path(f).stem}.wav",
                "frames": pathlib.Path(f).name} for f in files]
    with open(root / "musices.json", "w") as f:
        json.dump({"train": entries[:10], "test": entries[10:]}, f)
    return files


def video_fixtures():
    """[video] (a): native.decode_video on the committed fixtures against
    cv2's committed decodes, frame counts and orientations (a clip's
    .npz named <stem>_<ext>), the browser clips' reads against the JAX
    package's committed picks, an unread codec (HEVC: clip.mp4 relabelled
    hvc1) raising."""
    from viai_tpu_torch import native

    worst = {c: 0 for c in VIDEO_TOL}
    n_frames = {c: 0 for c in VIDEO_TOL}
    n_files = {c: 0 for c in VIDEO_TOL}
    cases = sorted(VIDEO_FIXTURES.glob("*.npz"))
    per_mpeg4, per_container, per_camera, turned = [], [], [], 0
    per_browser, per_screen, per_dvd, per_raw, per_hevc = [], [], [], [], []
    per_tools, per_lossless, per_muxers, per_legacy = [], [], [], []
    per_opencv = []
    for npz in cases:
        path = next((p for p in VIDEO_FIXTURES.glob(npz.stem + ".*")
                     if p.suffix != ".npz"),
                    VIDEO_FIXTURES / ".".join(npz.stem.rsplit("_", 1)))
        ref = np.load(npz)
        track = native.video_track(str(path), packets=False)
        got = native.decode_video(str(path))
        require(got.shape[0] == int(ref["n"]) and got.shape[1:] ==
                ref["frames"].shape[1:], f"[video] {path.name}: "
                f"{got.shape}, cv2's {int(ref['n'])} of "
                f"{ref['frames'].shape[1:]}")
        require(track.count == int(ref["count"]), f"[video] {path.name}: "
                f"count {track.count}, cv2's {int(ref['count'])}")
        err = int(np.abs(got[ref["index"]].astype(np.int64)
                         - ref["frames"]).max())
        worst[track.codec] = max(worst[track.codec], err)
        if track.codec == "mpeg4":
            per_mpeg4.append(f"{npz.stem} {err}")
        if npz.stem in CAMERA_FIXTURES:
            per_camera.append(
                f"{npz.stem} {got.shape[0]} of count {track.count} (cv2 "
                f"{int(ref['n'])} of {int(ref['count'])}) max|Δ| {err}")
        if npz.stem in SCREEN_FIXTURES:
            per_screen.append(
                f"{npz.stem} {got.shape[0]} of count {track.count} (cv2 "
                f"{int(ref['n'])} of {int(ref['count'])}) max|Δ| {err}")
        if npz.stem in DVD_FIXTURES or npz.stem in DVD_CLIPS:
            per_dvd.append(
                f"{npz.stem} {got.shape[0]} of count {track.count} at "
                f"{got.shape[2]}x{got.shape[1]} (cv2 {int(ref['n'])} of "
                f"{int(ref['count'])}) max|Δ| {err}")
        if npz.stem in TOOLS_FIXTURES or npz.stem in TOOLS_CLIPS:
            per_tools.append(
                f"{npz.stem} {got.shape[0]} of count {track.count} at "
                f"{got.shape[2]}x{got.shape[1]} (cv2 {int(ref['n'])} of "
                f"{int(ref['count'])}) max|Δ| {err}")
        if npz.stem in HEVC_FIXTURES or npz.stem in HEVC_CLIPS:
            per_hevc.append(
                f"{npz.stem} {got.shape[0]} of count {track.count} at "
                f"{got.shape[2]}x{got.shape[1]} (cv2 {int(ref['n'])} of "
                f"{int(ref['count'])}) max|Δ| {err}")
        if (npz.stem.startswith(LOSSLESS_PREFIXES)
                or npz.stem in LOSSLESS_CLIPS):
            per_lossless.append(
                f"{npz.stem} {got.shape[0]} of count {track.count} at "
                f"{got.shape[2]}x{got.shape[1]} (cv2 {int(ref['n'])} of "
                f"{int(ref['count'])}) max|Δ| {err}")
        if npz.stem in MUXER_FIXTURES or npz.stem in MUXER_CLIPS:
            per_muxers.append(
                f"{npz.stem} {got.shape[0]} of count {track.count} at "
                f"{got.shape[2]}x{got.shape[1]} (cv2 {int(ref['n'])} of "
                f"{int(ref['count'])}) max|Δ| {err}")
            worst["muxers"] = max(worst["muxers"], err)
            n_frames["muxers"] += len(ref["index"])
            n_files["muxers"] += 1
        if track.codec in ("h263", "h261"):
            require(npz.stem.startswith(LEGACY_PREFIXES) or
                    path.name in LEGACY_CLIPS,
                    f"[video] {path.name}: an H.263-family file unlisted")
            per_legacy.append(
                f"{npz.stem} {got.shape[0]} of count {track.count} at "
                f"{got.shape[2]}x{got.shape[1]} (cv2 {int(ref['n'])} of "
                f"{int(ref['count'])}) max|Δ| {err}")
        if track.codec in ("magicyuv", "asv", "snow"):
            require(npz.stem.startswith(OPENCV_PREFIXES) or
                    path.name in OPENCV_CLIPS,
                    f"[video] {path.name}: a MagicYUV, ASV or Snow file "
                    f"unlisted")
            per_opencv.append(
                f"{npz.stem} {got.shape[0]} of count {track.count} at "
                f"{got.shape[2]}x{got.shape[1]} (cv2 {int(ref['n'])} of "
                f"{int(ref['count'])}) max|Δ| {err}")
        if npz.stem.startswith("raw_") or npz.stem in RAW_CLIPS:
            per_raw.append(
                f"{npz.stem} {got.shape[0]} of count {track.count} at "
                f"{got.shape[2]}x{got.shape[1]} (cv2 {int(ref['n'])} of "
                f"{int(ref['count'])}) max|Δ| {err}")
        if npz.stem in BROWSER_FIXTURES or npz.stem in BROWSER_CLIPS:
            per_browser.append(
                f"{npz.stem} {got.shape[0]} of count {track.count} at "
                f"{got.shape[2]}x{got.shape[1]} (cv2 {int(ref['n'])} of "
                f"{int(ref['count'])}) max|Δ| {err}")
        if "orientation" in ref:
            require(track.orientation == int(ref["orientation"]),
                    f"[video] {path.name}: orientation {track.orientation}, "
                    f"cv2's {int(ref['orientation'])}")
            turned += track.orientation in (90, 180, 270)
            per_container.append(
                f"{npz.stem} count {track.count} (cv2 {int(ref['count'])}) "
                f"orientation {track.orientation} (cv2 "
                f"{int(ref['orientation'])}) max|Δ| {err}")
        n_frames[track.codec] += len(ref["index"])
        n_files[track.codec] += 1
    for codec, name in VIDEO_NAMES.items():
        log(f"[video] {name}: {n_frames[codec]} frames of {n_files[codec]} "
            f"committed fixtures against cv2's decodes: max|Δ| "
            f"{worst[codec]} levels (bound {VIDEO_TOL[codec]}); counts "
            f"equal cv2's")
    log("[video] MPEG-4 Part 2 max|Δ| per fixture: " + ", ".join(per_mpeg4))
    log(f"[video] phones and muxers ({len(per_container)} fixtures, "
        f"{turned} turned): " + "; ".join(per_container))
    require(per_container, "[video] no fixture of phones and muxers")
    log(f"[video] H.264 as cameras and encoders write it "
        f"({len(per_camera)} fixtures): " + "; ".join(per_camera))
    require(len(per_camera) == len(CAMERA_FIXTURES),
            f"[video] {len(per_camera)} camera fixtures of "
            f"{len(CAMERA_FIXTURES)}")
    log(f"[video] VP9 as YouTube and browsers write it, and new sizes "
        f"mid-stream ({len(per_browser)} fixtures): " + "; ".join(per_browser))
    require(len(per_browser) == len(BROWSER_FIXTURES) + len(BROWSER_CLIPS),
            f"[video] {len(per_browser)} browser fixtures of "
            f"{len(BROWSER_FIXTURES) + len(BROWSER_CLIPS)}")
    log(f"[video] H.264 as ffmpeg writes it from images and screens "
        f"({len(per_screen)} fixtures): " + "; ".join(per_screen))
    require(len(per_screen) == len(SCREEN_FIXTURES),
            f"[video] {len(per_screen)} screen fixtures of "
            f"{len(SCREEN_FIXTURES)}")
    log(f"[video] MPEG-1/2 as DVD rips, broadcast captures and cv2's writer "
        f"store it ({len(per_dvd)} fixtures): " + "; ".join(per_dvd))
    require(len(per_dvd) == len(DVD_FIXTURES) + len(DVD_CLIPS),
            f"[video] {len(per_dvd)} MPEG-1/2 fixtures of "
            f"{len(DVD_FIXTURES) + len(DVD_CLIPS)}")
    n_raw = len(list(VIDEO_FIXTURES.glob("raw_*.npz"))) + len(RAW_CLIPS)
    log(f"[video] uncompressed video as OpenCV's writer, capture tools and "
        f"ffmpeg store it ({len(per_raw)} fixtures): " + "; ".join(per_raw))
    require(len(per_raw) == n_raw and n_raw > len(RAW_CLIPS),
            f"[video] {len(per_raw)} uncompressed fixtures of {n_raw}")
    log(f"[video] HEVC as phones, cameras and x265 write it "
        f"({len(per_hevc)} fixtures): " + "; ".join(per_hevc))
    require(len(per_hevc) == len(HEVC_FIXTURES) + len(HEVC_CLIPS),
            f"[video] {len(per_hevc)} HEVC fixtures of "
            f"{len(HEVC_FIXTURES) + len(HEVC_CLIPS)}")
    log(f"[video] H.264 cut anywhere or with tools libx264 never writes "
        f"({len(per_tools)} fixtures): " + "; ".join(per_tools))
    require(len(per_tools) == len(TOOLS_FIXTURES) + len(TOOLS_CLIPS),
            f"[video] {len(per_tools)} H.264 tools fixtures of "
            f"{len(TOOLS_FIXTURES) + len(TOOLS_CLIPS)}")
    n_lossless = sum(len(list(VIDEO_FIXTURES.glob(f"{p}*.npz")))
                     for p in LOSSLESS_PREFIXES) + len(LOSSLESS_CLIPS)
    log(f"[video] lossless video as capture tools, archives and cv2's "
        f"writer store it ({len(per_lossless)} fixtures): "
        + "; ".join(per_lossless))
    require(len(per_lossless) == n_lossless
            and n_lossless > len(LOSSLESS_CLIPS),
            f"[video] {len(per_lossless)} lossless fixtures of {n_lossless}")
    log(f"[video] video as mkvmerge and other muxers store it "
        f"({len(per_muxers)} fixtures): " + "; ".join(per_muxers))
    require(len(per_muxers) == len(MUXER_FIXTURES) + len(MUXER_CLIPS),
            f"[video] {len(per_muxers)} muxer fixtures of "
            f"{len(MUXER_FIXTURES) + len(MUXER_CLIPS)}")
    n_legacy = sum(len(list(VIDEO_FIXTURES.glob(f"{p}*.npz")))
                   for p in LEGACY_PREFIXES) + len(LEGACY_CLIPS)
    log(f"[video] the H.263 family as old AVIs and cv2's writer store it, "
        f"ITU video telephony as cv2's writer and old phones store it "
        f"({len(per_legacy)} fixtures): " + "; ".join(per_legacy))
    require(len(per_legacy) == n_legacy and n_legacy > len(LEGACY_CLIPS),
            f"[video] {len(per_legacy)} H.263-family fixtures of "
            f"{n_legacy}")
    n_opencv = sum(len(list(VIDEO_FIXTURES.glob(f"{p}*.npz")))
                   for p in OPENCV_PREFIXES) + len(OPENCV_CLIPS)
    log(f"[video] MagicYUV, ASV and Snow as cv2's writer and capture tools "
        f"store them ({len(per_opencv)} fixtures): " + "; ".join(per_opencv))
    require(len(per_opencv) == n_opencv and n_opencv > len(OPENCV_CLIPS),
            f"[video] {len(per_opencv)} MagicYUV, ASV and Snow fixtures of "
            f"{n_opencv}")
    video_hevc_1080p()
    for name in BROWSER_CLIPS:
        ref = np.load(VIDEO_FIXTURES / f"{name}.npz")
        path = str(VIDEO_FIXTURES / ".".join(name.rsplit("_", 1)))
        picks = []
        for k, window in enumerate(ref["picks_windows"]):
            w = None if window[0] < 0 else tuple(float(x) for x in window)
            got = native.load_video_frames(path, FRAMES[0], FRAMES[1], w)
            err = float(np.abs(got - ref["picks"][k] / np.float32(255)).max())
            require(err == 0.0, f"[video] {name} {w}: load_video_frames "
                    f"max|Δ| {err * 255:.3f} / 255 against the committed "
                    f"picks")
            picks.append(f"{w}: {err * 255:.0f}")
        log(f"[video] {name}: load_video_frames of {FRAMES[0]} frames at "
            f"{FRAMES[1]}x{FRAMES[2]} against the JAX package's committed "
            f"picks, max|Δ| / 255 per window: " + ", ".join(picks))
    require(all(n_files.values()), f"[video] a codec without fixtures: "
            f"{n_files}")
    require(all(worst[c] <= VIDEO_TOL[c] for c in worst),
            "[video] the native decoders disagree with cv2")
    with tempfile.TemporaryDirectory() as tmp:
        av1 = pathlib.Path(tmp) / "clip_av01.mp4"
        av1.write_bytes((VIDEO_FIXTURES / "clip.mp4").read_bytes()
                        .replace(b"mp4v", b"av01", 1))
        # x265's SPS with chroma_format_idc 2 (4:2:2, RExt) for its 1:
        # ue(1) "010" becomes ue(2) "011" after sps_seq_parameter_set_id
        data = (VIDEO_FIXTURES / "hevc_slices_avi.avi").read_bytes()
        at, n, zeros = data.index(b"\x42\x01") + 2, 0, 0
        while n < 13 or (zeros >= 2 and data[at] == 3):
            if zeros >= 2 and data[at] == 3:     # emulation prevention
                zeros = 0
            else:
                zeros = zeros + 1 if data[at] == 0 else 0
                n += 1
            at += 1                              # → the RBSP's 14th byte
        require(data[at] >> 4 == 0b1010,
                f"[video] hevc_slices_avi.avi's SPS byte {data[at]:#x}")
        rext = pathlib.Path(tmp) / "hevc_422.avi"
        rext.write_bytes(data[:at] + bytes([data[at] | 0x10])
                         + data[at + 1:])
        for path, name in ((av1, "AV1"), (rext, "HEVC 4:2:2")):
            try:
                native.decode_video(str(path))
                require(False, f"[video] {path.name} decoded")
            except NotImplementedError as e:
                require(name in str(e),
                        f"[video] {path.name} raises without naming "
                        f"{name}: {e}")
                log(f"[video] {path.name} raises NotImplementedError: {e}")


def video_hevc_1080p():
    """[video] (a): the 1080p HEVC clip's frames against cv2's committed
    SHA-256 of each frame's BGR bytes."""
    from viai_tpu_torch import native

    with open(VIDEO_FIXTURES / HEVC_1080P_SHA) as f:
        ref = json.load(f)
    got = native.decode_video(str(VIDEO_FIXTURES / HEVC_1080P))
    sha = [hashlib.sha256(g.tobytes()).hexdigest() for g in got]
    require(list(got.shape) == ref["shape"] and sha == ref["sha256"],
            f"[video] {HEVC_1080P}: {got.shape}, SHA-256 "
            f"{sum(a == b for a, b in zip(sha, ref['sha256']))} of "
            f"{ref['n']} equal cv2's")
    log(f"[video] {HEVC_1080P} ({got.shape[0]} frames of {got.shape[2]}x"
        f"{got.shape[1]}, HEVC Main): every frame's SHA-256 equals cv2's "
        f"committed one")



def phase_video(dev, ckpt: str, card: str) -> int:
    """Compressed video on the card ([video]): (a) native.decode_video on
    the committed fixtures against cv2's committed decodes, frame counts
    and orientations, the 1080p HEVC clip against cv2's SHA-256 of each
    frame, an unread codec (AV1: clip.mp4 relabelled av01) and HEVC 4:2:2
    (x265's SPS patched) raising;
    (b) the av model trained 20 steps at full width through the train CLI
    from each folder of VIDEO_FOLDERS: MJPEG and MPEG-4 clips (AVI, MP4,
    Matroska, and a MOV through prepare_dataset extract), VP8 clips
    (WebM, Matroska), VP9 clips (WebM, MP4), H.264 clips (MP4,
    Matroska), then camera and cut clips (MJPEG 4:2:2 in OpenDML AVI,
    H.264 in MP4 under a trimming edit), then MPEG-4 Advanced Simple
    Profile clips (XviD in AVI, libavcodec's mpeg4 with B-VOPs in MP4)
    with DivX 3 and WMV8 AVIs and a phone's H.263+ s263 MP4 beside them,
    then phone clips (H.264 turned 90 degrees with AAC, fragmented, and
    header-stripped in Matroska; HEVC in Matroska without
    DefaultDuration), then camera clips (High 4:2:2 10-bit in MP4, PsF without
    bitstream_restriction in Matroska), then browser clips (VP9 profile
    2 10-bit BT.2020, VP9 realtime with reference scaling and a size
    change, in WebM), then screen clips (H.264 High 4:4:4 Predictive in
    MP4, lossless 4:2:0 in Matroska), then DVD clips (MPEG-2 at 720x480
    with soft telecine and open GOPs in Matroska, MPEG-1 at 352x240 from
    cv2's writer in AVI), then uncompressed clips (cv2's writer's I420,
    a capture tool's YUY2, in AVI), then HEVC clips (a phone's hvc1 MP4
    turned 90 degrees with AAC, open GOPs of 8; its Matroska copy), then
    a cut clip (H.264 open GOPs with leading B-pictures cut at a recovery
    point in Matroska with a sound track, its first leading pictures
    dropped), then lossless clips (FFV1 level 3 10-bit 4:2:2 with slice
    CRCs in Matroska, UT Video ULY0 in AVI);
    (c) the eval CLI on a musices split of each, each folder's time split
    (its corpus, the train CLI, the eval CLI); (d) the decode time per
    frame of each codec, a turned frame's against the same file's
    unturned, a 10-bit, a 4:4:4 and a lossless frame's conversion share,
    a 720x480 MPEG-2 frame's decode and conversion, a 224x224 I420 and a
    720x480 YUY2 frame's read and conversion, a clip's read, a 224x224
    and a 1920x1080 HEVC frame's decode, a 224x224 FFV1 and UT Video
    frame's decode, a frame's of each H.263-family codec and of H.261, the
    loader's wait share of a step from each folder
    (in its training run).
    Returns the GL kernel's launches."""
    from viai_tpu_torch import native

    t_video = time.perf_counter()
    log(f"[video] cut to make room for the dvd folder: decode and read "
        f"times the best of VIDEO_REPS {VIDEO_REPS} (was 3), TURN_ROUNDS "
        f"{TURN_ROUNDS} (was 7), each folder's eval CLI with --nThreads "
        f"{VIDEO_EVAL_THREADS} (was 4 spawned workers for its 3 clips); "
        f"cut to make room for the hevc folder: each folder's loader wait "
        f"measured in its training run (was a second loader run of "
        f"{FRAMES_WARMUP} + {TRAIN_TIMED_STEPS} steps a folder)")
    # (a) the decoders against cv2's committed decodes
    video_fixtures()

    # (b), (c) av training and evaluation from each folder of video files
    corpus = pathlib.Path(ckpt) / "corpus"
    if not (corpus / "av").exists():
        write_corpus(corpus)
    total = 0
    roots = {}
    for folder in VIDEO_FOLDERS:
        roots[folder] = root = \
            pathlib.Path(ckpt) / f"video_corpus_{folder}" / "av"
        total += video_train_eval(folder, root, corpus, ckpt, card)

    # (d) decode and read times, the loader's wait share
    def best_ms(fn) -> float:
        out = []
        for _ in range(VIDEO_REPS):
            t = time.perf_counter()
            fn()
            out.append((time.perf_counter() - t) * 1e3)
        return min(out)

    for src, codec in (("clip.avi", "MJPEG"), ("clip.mp4", "MPEG-4"),
                       ("clip.mkv", "MPEG-4"), ("clip.webm", "VP8"),
                       ("clip_vp8.mkv", "VP8"), ("clip_vp9.webm", "VP9"),
                       ("clip_vp9.mp4", "VP9"),
                       ("clip_h264.mp4", "H.264 High"),
                       ("clip_h264.mkv", "H.264 Main"),
                       ("clip_cam.avi", "MJPEG 4:2:2, OpenDML"),
                       ("clip_cut.mp4", "H.264 High, 4 of 20 frames cut"),
                       ("clip_oddh.avi", "MJPEG 4:2:0, odd height"),
                       ("clip_xvid.avi",
                        "MPEG-4 ASP: XviD, packed B, qpel, 4MV, GMC"),
                       ("clip_dx50.mp4",
                        "MPEG-4 ASP: B-VOPs, 4MV, AC prediction"),
                       ("clip_phone.mp4", "H.264 High, turned 90, AAC"),
                       ("clip_frag.mp4", "H.264 High, fragmented, AAC"),
                       ("clip_xavc.mp4", "H.264 High 4:2:2, 10-bit, B"),
                       ("clip_avchd.mkv",
                        "H.264 High, PsF, B, no bitstream_restriction"),
                       ("clip_hdr.webm",
                        "VP9 profile 2, 10-bit, BT.2020, alt-refs"),
                       ("clip_rtc.webm",
                        "VP9 realtime, 6 frames at 112x112 by reference "
                        "scaling, scaled up to 224x224"),
                       ("clip_screen.mp4",
                        "H.264 High 4:4:4 Predictive, 8-bit, B"),
                       ("clip_lossless.mkv",
                        "H.264 lossless 4:2:0, ultrafast"),
                       ("clip_dvd.mkv",
                        "MPEG-2 MP@ML, soft telecine, open GOPs of 12"),
                       ("clip_pim1.avi", "MPEG-1, cv2.VideoWriter's PIM1"),
                       ("clip_i420.avi",
                        "uncompressed I420, cv2.VideoWriter's fourcc 0"),
                       ("clip_yuy2.avi", "uncompressed YUY2, a capture"),
                       ("clip_hevc.mp4",
                        "HEVC Main, turned 90, AAC, open GOPs of 8"),
                       ("clip_hevc.mkv", "HEVC Main, open GOPs of 8"),
                       ("clip_gopcut.mkv",
                        "H.264 High, open GOPs cut at a recovery point"),
                       ("clip_ffv1.mkv",
                        "FFV1 level 3, 10-bit 4:2:2, 4 slices with CRCs"),
                       ("clip_utvideo.avi",
                        "UT Video ULY0, left prediction"),
                       ("clip_strip.mkv",
                        "H.264 High, header-stripped as mkvmerge wrote it"),
                       ("clip_nodd.mkv",
                        "HEVC Main without DefaultDuration"),
                       *LEGACY_CLIPS.items(), *OPENCV_CLIPS.items()):
        path = str(VIDEO_FIXTURES / src)
        n, h, w = native.decode_video(path).shape[:3]
        dec = best_ms(lambda: native.decode_video(path)) / n
        read = best_ms(lambda: native.load_video_frames(path, FRAMES[0],
                                                        FRAMES[1]))
        log(f"[video] {src} ({codec}, {n} frames of {w}x{h}): decode "
            f"{dec:.3f} ms a frame (demux, decode, BGR; one thread), "
            f"{read:.3f} ms to read {FRAMES[0]} frames at {FRAMES[1]}x"
            f"{FRAMES[2]} (load_video_frames, one thread); {card}")
    video_turn_cost(best_ms, card)
    video_conversion_cost(best_ms, card)
    video_browser_costs(best_ms, card)
    video_screen_costs(best_ms, card)
    video_dvd_costs(best_ms, card)
    video_raw_costs(best_ms, card)
    video_hevc_costs(best_ms, card)
    video_lossless_costs(best_ms, card)
    video_clip_costs(best_ms, card, LEGACY_CLIPS, "H.263-family and H.261")
    video_clip_costs(best_ms, card, OPENCV_CLIPS, "MagicYUV, ASV and Snow")
    video_strip_cost(best_ms, card)
    log(f"[video] took {time.perf_counter() - t_video:.1f} s ({len(roots)} "
        f"folders)")
    return total


def video_turn_cost(best_ms, card: str):
    """[video] (d): clip_phone.mp4's frames decoded turned (its 90 degree
    tkhd matrix) against the same file's with the identity written over
    that matrix, in turns, per frame; and the two reads."""
    from viai_tpu_torch import native

    data = (VIDEO_FIXTURES / "clip_phone.mp4").read_bytes()
    identity = struct.pack(">9i", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0,
                           0x40000000)
    # the video trak's tkhd (version 0): the one whose matrix turns
    at = next(i + 44 for i in range(len(data)) if data[i:i + 4] == b"tkhd"
              and data[i + 44:i + 80] != identity)
    with tempfile.TemporaryDirectory() as tmp:
        plain = pathlib.Path(tmp) / "clip_phone_unturned.mp4"
        plain.write_bytes(data[:at] + identity + data[at + 36:])
        paths = {"turned": str(VIDEO_FIXTURES / "clip_phone.mp4"),
                 "unturned": str(plain)}
        shapes = {k: native.decode_video(p).shape for k, p in paths.items()}
        require(shapes["turned"][1:3] == shapes["unturned"][2:0:-1] and
                native.video_track(paths["turned"]).orientation == 90,
                f"[video] clip_phone.mp4 turned {shapes}")
        ms = {k: [] for k in paths}
        for _ in range(TURN_ROUNDS):
            for k, p in paths.items():
                ms[k].append(best_ms(lambda: native.decode_video(p))
                             / shapes[k][0])
        read = {k: best_ms(lambda: native.load_video_frames(
            p, FRAMES[0], FRAMES[1])) for k, p in paths.items()}
    t, u = min(ms["turned"]), min(ms["unturned"])
    diff = float(np.median(np.subtract(ms["turned"], ms["unturned"])))
    log(f"[video] clip_phone.mp4 decode a frame turned "
        f"({shapes['turned'][2]}x{shapes['turned'][1]}) {t:.3f} ms, "
        f"unturned ({shapes['unturned'][2]}x{shapes['unturned'][1]}) "
        f"{u:.3f} ms (best of {TURN_ROUNDS} rounds of {VIDEO_REPS}, in "
        f"turns, one thread; the rounds' median difference {diff:+.3f} "
        f"ms, {diff / u:+.1%}); read {FRAMES[0]} frames "
        f"{read['turned']:.3f} / {read['unturned']:.3f} ms; {card}")


def video_conversion_cost(best_ms, card: str):
    """[video] (d): the share of a 10-bit frame's decode that its
    conversion to BGR takes (swscale's scaler with the 16-bit horizontal
    pass, H.264's left-sited chroma): clip_xavc.mp4's decode a frame
    against native.yuv_to_bgr of planes of its layout (yuv422p10)."""
    from viai_tpu_torch import native

    path = str(VIDEO_FIXTURES / "clip_xavc.mp4")
    n, h, w = native.decode_video(path).shape[:3]
    rng = np.random.default_rng(0)
    y = rng.integers(0, 1024, (h, w)).astype(np.uint16)
    u, v = (rng.integers(0, 1024, (h, w // 2)).astype(np.uint16)
            for _ in range(2))
    dec = best_ms(lambda: native.decode_video(path)) / n
    conv = best_ms(lambda: native.yuv_to_bgr(y, u, v, (1, 0), 10,
                                             chroma_loc=1))
    log(f"[video] clip_xavc.mp4 ({w}x{h} 4:2:2 10-bit): conversion to BGR "
        f"{conv:.3f} ms of the {dec:.3f} ms a frame's decode takes "
        f"({conv / dec:.1%}; swscale's scaler, one thread); {card}")


def video_browser_costs(best_ms, card: str):
    """[video] (d): the share of clip_hdr.webm's 10-bit frame that its
    conversion to BGR takes (swscale's scaler, yuv420p10, BT.2020), and
    what a picture of another size than the stream's first costs to
    convert (clip_rtc.webm's 112x112 pictures scaled to 224x224 by the
    bicubic scaler) against one at its own size."""
    from viai_tpu_torch import native

    path = str(VIDEO_FIXTURES / "clip_hdr.webm")
    n, h, w = native.decode_video(path).shape[:3]
    rng = np.random.default_rng(0)
    y = rng.integers(0, 1024, (h, w)).astype(np.uint16)
    u, v = (rng.integers(0, 1024, (h // 2, w // 2)).astype(np.uint16)
            for _ in range(2))
    dec = best_ms(lambda: native.decode_video(path)) / n
    conv = best_ms(lambda: native.yuv_to_bgr(y, u, v, (1, 1), 10,
                                             matrix=9))
    log(f"[video] clip_hdr.webm ({w}x{h} 4:2:0 10-bit): conversion to BGR "
        f"{conv:.3f} ms of the {dec:.3f} ms a frame's decode takes "
        f"({conv / dec:.1%}; swscale's scaler, one thread); {card}")
    small = [rng.integers(0, 256, s).astype(np.uint8)
             for s in ((112, 112), (56, 56), (56, 56))]
    full = [rng.integers(0, 256, s).astype(np.uint8)
            for s in ((224, 224), (112, 112), (112, 112))]
    up = best_ms(lambda: native.yuv_to_bgr(*small, size=(224, 224)))
    same = best_ms(lambda: native.yuv_to_bgr(*full))
    log(f"[video] clip_rtc.webm's pictures to BGR at 224x224: 112x112 "
        f"4:2:0 scaled up (swscale's bicubic scaler, as cv2 converts a "
        f"picture of another size than the first) {up:.3f} ms, 224x224 at "
        f"its own size (unscaled converter) {same:.3f} ms; {card}")
    # Reads from the keyframe: frames 0-5 (224x224), then 0-11, whose
    # frames 6-11 are 112x112 from scaled references, scaled up.
    path = str(VIDEO_FIXTURES / "clip_rtc.webm")
    early, both = (best_ms(lambda: native.load_video_frames(
        path, FRAMES[0], FRAMES[1], (0.0, w1))) for w1 in (0.35, 0.74))
    log(f"[video] clip_rtc.webm read from its keyframe: frames 0-5 "
        f"(224x224) {early:.3f} ms, {early / 6:.3f} ms a frame; frames "
        f"6-11 (112x112, scaled references, scaled up to 224x224) "
        f"{both - early:.3f} ms more, {(both - early) / 6:.3f} ms a frame "
        f"({(both - early) / early:.2f}x); {card}")


def video_screen_costs(best_ms, card: str):
    """[video] (d): clip_screen.mp4's (4:4:4, 8-bit) and
    clip_lossless.mkv's (lossless 4:2:0) decode a frame beside the same
    run's clip_xavc.mp4 (4:2:2 10-bit), and the share of each that its
    conversion to BGR takes (yuv444p through swscale's scaler with full
    chroma; yuv420p through its unscaled converter; planes of their
    layouts through native.yuv_to_bgr, H.264's left-sited chroma)."""
    from viai_tpu_torch import native

    rng = np.random.default_rng(0)
    dec, shapes = {}, {}
    for src in ("clip_xavc.mp4", "clip_screen.mp4", "clip_lossless.mkv"):
        path = str(VIDEO_FIXTURES / src)
        n, *shapes[src] = native.decode_video(path).shape[:3]
        dec[src] = best_ms(lambda: native.decode_video(path)) / n
    for src, shift, layout in (("clip_screen.mp4", (0, 0), "4:4:4"),
                               ("clip_lossless.mkv", (1, 1), "4:2:0")):
        h, w = shapes[src]
        y = rng.integers(0, 256, (h, w)).astype(np.uint8)
        u, v = (rng.integers(0, 256, (h >> shift[1], w >> shift[0]))
                .astype(np.uint8) for _ in range(2))
        conv = best_ms(lambda: native.yuv_to_bgr(y, u, v, shift,
                                                 chroma_loc=1))
        log(f"[video] {src} ({w}x{h} {layout} 8-bit): decode a frame "
            f"{dec[src]:.3f} ms ({dec[src] / dec['clip_xavc.mp4']:.2f}x "
            f"the same run's clip_xavc.mp4, {dec['clip_xavc.mp4']:.3f} "
            f"ms), its conversion to BGR {conv:.3f} ms "
            f"({conv / dec[src]:.1%}; one thread); {card}")


def video_dvd_costs(best_ms, card: str):
    """[video] (d): clip_dvd.mkv's 720x480 MPEG-2 frame: its decode, the
    share its conversion to BGR takes (yuv420p through swscale's unscaled
    converter; planes of its layout through native.yuv_to_bgr, MPEG-2's
    left-sited chroma), and a read of 16 frames from the second GOP (a
    window that starts inside an open GOP: decoded from the first
    packet) against one from the first."""
    from viai_tpu_torch import native

    path = str(VIDEO_FIXTURES / "clip_dvd.mkv")
    n, h, w = native.decode_video(path).shape[:3]
    rng = np.random.default_rng(0)
    y = rng.integers(0, 256, (h, w)).astype(np.uint8)
    u, v = (rng.integers(0, 256, (h // 2, w // 2)).astype(np.uint8)
            for _ in range(2))
    dec = best_ms(lambda: native.decode_video(path)) / n
    conv = best_ms(lambda: native.yuv_to_bgr(y, u, v, (1, 1), chroma_loc=1))
    first, second = (best_ms(lambda: native.load_video_frames(
        path, FRAMES[0], FRAMES[1], win)) for win in ((0.0, 0.5),
                                                     (0.75, 1.0)))
    log(f"[video] clip_dvd.mkv ({w}x{h} 4:2:0 MPEG-2, {n} pictures): decode "
        f"a frame {dec:.3f} ms, its conversion to BGR {conv:.3f} ms "
        f"({conv / dec:.1%}; one thread); read {FRAMES[0]} frames at "
        f"{FRAMES[1]}x{FRAMES[2]} of the first GOP {first:.3f} ms, of the "
        f"second (an open GOP: from the first packet) {second:.3f} ms; "
        f"{card}")


def video_raw_costs(best_ms, card: str):
    """[video] (d): the time to read and convert one frame of uncompressed
    video: clip_i420.avi's 224x224 I420 (swscale's unscaled yuv420p
    converter) and a 720x480 YUY2 capture written here (random bytes,
    hand-muxed as tests/_torch_make_videos.py's avi_file; swscale's
    scaler, for which it has no unscaled route), each the best of
    VIDEO_REPS decodes of the whole file over its frames."""
    from viai_tpu_torch import native

    sys.path.insert(0, str(VIDEO_FIXTURES.parent))
    import _torch_make_videos as mk

    h, w = RAW_CAPTURE
    rng = np.random.default_rng(0)
    packets = [rng.integers(0, 256, h * w * 2, np.uint8).tobytes()
               for _ in range(RAW_CAPTURE_FRAMES)]
    with tempfile.TemporaryDirectory() as tmp:
        capture = os.path.join(tmp, "capture_yuy2.avi")
        with open(capture, "wb") as f:
            f.write(mk.avi_file(packets, w, h, 30, len(packets), b"YUY2",
                                bits=16))
        res = []
        for path, what in ((str(VIDEO_FIXTURES / "clip_i420.avi"),
                            "clip_i420.avi (I420)"),
                           (capture, "a capture (YUY2)")):
            frames = native.decode_video(path)
            n, fh, fw = frames.shape[:3]
            ms = best_ms(lambda: native.decode_video(path)) / n
            res.append(f"{what} at {fw}x{fh}: {ms:.3f} ms a frame")
    log("[video] uncompressed, read and converted to BGR (demux, the raw "
        "decoder, swscale's route; one thread): " + "; ".join(res)
        + f"; {card}")


class TimedBatches:
    """The train CLI's batches (data/prefetch.py's device_prefetch) with
    the host's wait in each request and the time it returns."""

    def __init__(self, inner, record: list):
        self.inner, self.record = inner, record

    def __iter__(self):
        return self

    def __next__(self):
        t = time.perf_counter()
        batch = next(self.inner)
        done = time.perf_counter()
        self.record.append((done - t, done))
        return batch


def video_hevc_costs(best_ms, card: str):
    """[video] (d): a 224x224 HEVC frame's decode (clip_hevc.mkv, open
    GOPs of 8) and a 1920x1080 one's (the 1080p clip: 4 frames, libx265's
    defaults), each the best of VIDEO_REPS decodes of the whole file over
    its frames, on one thread."""
    from viai_tpu_torch import native

    res = []
    for src in ("clip_hevc.mkv", HEVC_1080P):
        path = str(VIDEO_FIXTURES / src)
        n, h, w = native.decode_video(path).shape[:3]
        ms = best_ms(lambda: native.decode_video(path)) / n
        res.append(f"{src} at {w}x{h}: {ms:.3f} ms a frame")
    log("[video] HEVC Main decode (demux, decode, BGR; one thread): "
        + "; ".join(res) + f"; {card}")


def video_lossless_costs(best_ms, card: str):
    """[video] (d): a 224x224 lossless frame's decode and conversion to
    BGR: clip_ffv1.mkv (FFV1 level 3, 10-bit 4:2:2: the range coder over 4
    slices with their CRCs, swscale's scaler) and clip_utvideo.avi (UT
    Video ULY0: Huffman codes, left prediction, swscale's unscaled
    yuv420p route), each the best of VIDEO_REPS decodes of the whole file
    over its frames, on one thread."""
    from viai_tpu_torch import native

    res = []
    for src in ("clip_ffv1.mkv", "clip_utvideo.avi"):
        path = str(VIDEO_FIXTURES / src)
        n, h, w = native.decode_video(path).shape[:3]
        ms = best_ms(lambda: native.decode_video(path)) / n
        res.append(f"{src} at {w}x{h}: {ms:.3f} ms a frame")
    log("[video] lossless decode (demux, decode, BGR; one thread): "
        + "; ".join(res) + f"; {card}")


def plain_mkv(track, fps: int = 25) -> bytes:
    """A Matroska file of a read track's packets as they are (no content
    encoding; blocks in decode order, DefaultDuration 1/fps, the
    segment's Duration of its count): what the port reads from it is the
    track's pictures again."""
    def element(eid: int, *parts: bytes) -> bytes:
        body = b"".join(parts)
        k = 1
        while len(body) >= (1 << (7 * k)) - 1:
            k += 1
        return (eid.to_bytes((eid.bit_length() + 7) // 8, "big")
                + ((1 << (7 * k)) | len(body)).to_bytes(k, "big") + body)

    def uint(eid: int, v: int) -> bytes:
        return element(eid, v.to_bytes(max(1, (v.bit_length() + 7) // 8),
                                       "big"))

    ms = 1000 // fps
    head = element(0x1A45DFA3, element(0x4282, b"matroska"))
    info = element(0x1549A966, uint(0x2AD7B1, 1000000), element(
        0x4489, struct.pack(">d", float(track.count * ms))))
    entry = element(0xAE, uint(0xD7, 1), uint(0x83, 1),
                    element(0x86, b"V_MPEG4/ISO/AVC"),
                    element(0x63A2, track.config),
                    uint(0x23E383, 1000000000 // fps),
                    element(0xE0, uint(0xB0, track.width),
                            uint(0xBA, track.height)))
    blocks = b"".join(element(0xA3, b"\x81", struct.pack(
        ">hB", i * ms, 0x80 if key else 0), data)
        for i, (data, key) in enumerate(track.packets))
    return head + element(0x18538067, info, element(0x1654AE6B, entry),
                          element(0x1F43B675, uint(0xE7, 0), blocks))


def video_strip_cost(best_ms, card: str):
    """[video] (d): what header stripping costs: clip_strip.mkv's 224x160
    frames (H.264 High, ContentCompSettings 00 00 before every frame)
    against the same packets written plain (plain_mkv), each decoded whole
    (the best of VIDEO_REPS; demux, decode, BGR) and demuxed alone
    (video_track), in turns, on one thread; both decodes equal."""
    from viai_tpu_torch import native

    src = str(VIDEO_FIXTURES / "clip_strip.mkv")
    with tempfile.TemporaryDirectory() as tmp:
        plain = os.path.join(tmp, "clip_plain.mkv")
        with open(plain, "wb") as f:
            f.write(plain_mkv(native.video_track(src)))
        a, b = native.decode_video(src), native.decode_video(plain)
        require(a.shape == b.shape and np.array_equal(a, b),
                "[video] clip_strip.mkv decodes unlike its plain twin")
        n = a.shape[0]
        dec = {src: [], plain: []}
        dmx = {src: [], plain: []}
        for _ in range(TURN_ROUNDS):
            for path in (src, plain):
                dec[path].append(best_ms(
                    lambda: native.decode_video(path)) / n)
                dmx[path].append(best_ms(
                    lambda: native.video_track(path)))
    d_s, d_p = min(dec[src]), min(dec[plain])
    m_s, m_p = min(dmx[src]), min(dmx[plain])
    log(f"[video] clip_strip.mkv ({n} frames of {a.shape[2]}x{a.shape[1]}, "
        f"header-stripped) against its plain twin: decode {d_s:.3f} and "
        f"{d_p:.3f} ms a frame ({(d_s - d_p) / d_p * 100:+.2f}%), demux "
        f"{m_s:.3f} and {m_p:.3f} ms the file (the stripped bytes put back: "
        f"{(m_s - m_p) / n * 1000:.1f} µs a frame); {card}")


def video_train_eval(folder: str, root: pathlib.Path, corpus: pathlib.Path,
                     ckpt: str, card: str) -> int:
    """[video] (b), (c) and the loader's wait for one folder of
    VIDEO_FOLDERS: 20 av steps through the train CLI from [data]'s clips
    with these frame files, the loader's wait share measured in that run
    (each batch request timed on the host's clock), then the eval CLI on
    their musices test split; the folder's time split. → GL launches."""
    from viai_tpu_torch.cli import train as train_cli

    t_write = time.perf_counter()
    files = write_video_clips(
        root, sorted(str(p) for p in (corpus / "av").glob("*.wav")), folder)
    t_write = time.perf_counter() - t_write
    kinds = {}
    for f in files:
        kinds[pathlib.Path(f).suffix] = kinds.get(pathlib.Path(f).suffix,
                                                  0) + 1
    log(f"[video] corpus {folder}: {len(files)} wav files of [data] with "
        f"video frames (" + ", ".join(f"{k} {v}" for k, v in
                                      sorted(kinds.items()))
        + (("; the .npy from clip.mov through prepare_dataset extract"
            if folder == "mjpeg_mpeg4" else "")) + "), musices.json")
    name = f"chip_video_{folder}"
    args = video_args(folder, root, ckpt)
    record = []
    prefetch = train_cli.device_prefetch
    train_cli.device_prefetch = \
        lambda it, device, depth=2: TimedBatches(prefetch(it, device, depth),
                                                 record)
    zero_counts()
    t0 = time.perf_counter()
    try:
        model = train_cli.main(args)
    finally:
        train_cli.device_prefetch = prefetch
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = griffin_lim_cuda.launches, griffin_lim.calls
    losses = model.get_current_losses()
    log(f"[video] train av from {folder} files: {TRAIN_STEPS} steps at "
        f"batch {TRAIN_BATCH}, {FRAMES[0]} frames of {FRAMES[1]}x"
        f"{FRAMES[2]} a clip, through viai_tpu_torch.cli.train in "
        f"{wall:.1f} s incl. the loader's start; losses "
        + " ".join(f"{k} {v:.4f}" for k, v in losses.items())
        + f"; griffin_lim_cuda launches {launches}, plain {plain}")
    require(all(np.isfinite(v) for v in losses.values()),
            f"[video] train av ({folder}): non-finite loss")
    require(launches == TRAIN_STEPS // TRAIN_DISPLAY and plain == 0,
            f"[video] train av ({folder}): GL launches {launches}, plain "
            f"{plain}")
    video_wait_share(folder, record, card)
    total = launches
    del model
    zero_counts()
    t_eval = time.perf_counter()
    _, launches = eval_arm(
        f"(video) {name} on the musices test split of {folder} clips",
        ["--name", name, "--checkpoints_dir", ckpt, "--gpu_ids",
         "0", "--model", "av", "--gated", "--bottleneck_dilation", "1,2,4",
         "--dataset_mode", "musices", "--dataroot",
         str(root / "musices.json"), "--phase", "test", "--batchSize", "3",
         "--how_many", "3", "--results_dir", os.path.join(ckpt, "results"),
         "--nThreads", str(VIDEO_EVAL_THREADS)],
        3)
    require(launches > 0 and griffin_lim.calls == 0,
            f"[video] the eval CLI ({folder}): GL launches {launches}, "
            f"plain {griffin_lim.calls}")
    t_eval = time.perf_counter() - t_eval
    log(f"[video] eval {folder}: griffin_lim_cuda launches {launches}, "
        f"plain {griffin_lim.calls}")
    log(f"[video] {folder} split: writing its corpus {t_write:.1f} s, the "
        f"train CLI {wall:.1f} s (its loader's wait share measured in "
        f"that run), the eval CLI {t_eval:.1f} s; {card}")
    return total + launches


def video_args(folder: str, root: pathlib.Path, ckpt: str) -> list[str]:
    """The train CLI's arguments for one folder of VIDEO_FOLDERS."""
    args = data_train_args("av", ckpt, root)
    args[args.index("--name") + 1] = f"chip_video_{folder}"
    args[args.index("--dataroot") + 1] = str(root)
    return args


def video_wait_share(folder: str, record: list, card: str):
    """[video] (d): the loader's wait share of a step in one folder's
    training run: the batch requests after FRAMES_WARMUP steps up to the
    last, but for those that follow a display step (GL on the batch),
    each step the host's time from one request's return to the next."""
    waits = [w for w, _ in record]
    ends = [t for _, t in record]
    steps = [k for k in range(FRAMES_WARMUP, len(record) - 1)
             if (k + 1) % TRAIN_DISPLAY]
    require(len(record) == TRAIN_STEPS and steps,
            f"[video] {folder}: {len(record)} batch requests")
    wait = sum(waits[k + 1] for k in steps)
    wall = sum(ends[k + 1] - ends[k] for k in steps)
    cores = len(os.sched_getaffinity(0))
    log(f"[video] av from {folder} files (the train CLI's loader, prefetch "
        f"depth 2): loader wait {wait * 1e3:.1f} ms of {wall * 1e3:.1f} ms "
        f"over {len(steps)} steps after {FRAMES_WARMUP} ({wait / wall:.1%}),"
        f" {wall * 1e3 / len(steps):.1f} ms a step, in its training run "
        f"(host clock); host {cores} cores (os.cpu_count "
        f"{os.cpu_count()}); {card}")


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


def bench_reference_cpu(out: str) -> int:
    """[bench reference]'s CPU half, run by a process of its own (the
    script with BENCH_REF_FLAG): for each preset the float32 weights (R
    with its zero-init layers drawn), clips and injected refiner noise,
    and the float32 chain on the CPU at GL×1, saved to out/<preset>.pt.
    The complex presets (16 steps × 8 samples of full-width R) at 2
    clips, the others at bucket 8."""
    from viai_tpu_torch import bench

    os.nice(19)
    torch.set_num_threads(BENCH_REF_THREADS)
    torch.manual_seed(BENCH_REF_SEED)
    cfg = TrainConfig()
    for preset in bench.PRESETS:
        t0 = time.perf_counter()
        n = 8 if preset in ("default", "refiner_mag") else 2
        args = bench.parse_args(["--preset", preset, "--gl_iters", "1",
                                 "--device", "cpu"])
        G = define_G(device="cpu")
        R, noise, (r_in, r_out) = None, None, (0, 0)
        if preset != "default":
            r_in, r_out = ((4, 1) if preset == "refiner_mag"
                           else complex_refiner_channels(2))
            R = perturbed_R(r_in, r_out)
            k = 1 if preset == "refiner_mag" else 8
            g = torch.Generator().manual_seed(11)
            noise = [torch.randn((n, r_out, 256, 256), generator=g)
                     for _ in range(k)]
        wav = tones(n, seed=21, device="cpu")
        ref = bench.build_infer(preset, G, R, cfg, args)(
            wav, torch.Generator().manual_seed(0),
            noise=None if noise is None else
            [RefineNoise(e) for e in noise]).cpu()
        torch.save({"G": G.state_dict(),
                    "R": None if R is None else R.state_dict(),
                    "r_channels": (r_in, r_out), "noise": noise,
                    "wav": wav, "ref": ref},
                   os.path.join(out, f"{preset}.pt"))
        print(f"[bench reference cpu] {preset}: {n} clips in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    return 0


def start_bench_reference() -> tuple[subprocess.Popen, str]:
    """Start bench_reference_cpu in a process that sees no card; → the
    process and its directory (its log in cpu.log)."""
    out = tempfile.mkdtemp(prefix="bench_reference_")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    with open(os.path.join(out, "cpu.log"), "w") as f:
        proc = subprocess.Popen(
            [sys.executable, str(pathlib.Path(__file__).resolve()),
             BENCH_REF_FLAG, out], env=env, stdout=f,
            stderr=subprocess.STDOUT)
    return proc, out


def phase_bench_reference(dev, proc: subprocess.Popen, out: str):
    """Each preset's bf16 chain on the card against its float32 chain on
    the CPU (bench_reference_cpu, joined here): the same weights (R with
    its zero-init layers drawn), clips, gap masks (one CPU generator) and
    injected refiner noise, GL×1, bounded by BENCH_REF_BOUNDS. The complex
    presets at 2 clips, the others at bucket 8. The card also runs the
    float32 chain and, for the refiner presets, bf16 G with float32 R and
    float32 G with bf16 R, printed beside (not bounded)."""
    from viai_tpu_torch import bench

    t0 = time.perf_counter()
    rc = proc.wait()
    with open(os.path.join(out, "cpu.log")) as f:
        cpu_log = f.read()
    log(f"[bench reference] joined the CPU references' process (started "
        f"with the script: no card, nice 19, {BENCH_REF_THREADS} threads) "
        f"after waiting {time.perf_counter() - t0:.1f} s; exit {rc}; "
        + "; ".join(line.split("] ", 1)[-1]
                    for line in cpu_log.splitlines()
                    if line.startswith("[bench reference cpu]")))
    require(rc == 0, f"[bench reference] the CPU process failed: "
            f"{cpu_log[-2000:]}")
    cfg = TrainConfig()
    for preset in bench.PRESETS:
        saved = torch.load(os.path.join(out, f"{preset}.pt"),
                           weights_only=True)
        args = bench.parse_args(["--preset", preset, "--gl_iters", "1",
                                 "--device", "cpu"])
        r_in, r_out = saved["r_channels"]
        wav, ref = saved["wav"], saved["ref"]
        n = wav.shape[0]
        noise = None if saved["noise"] is None else \
            [RefineNoise(e) for e in saved["noise"]]

        def run(g_dtype, r_dtype, where):
            G = define_G(dtype=g_dtype, device=where)
            G.load_state_dict(saved["G"])
            R = None
            if saved["R"] is not None:
                R = define_R(r_in, 64, dtype=r_dtype, out_channels=r_out,
                             device=where)
                R.load_state_dict(saved["R"])
            return bench.build_infer(preset, G, R, cfg, args)(
                wav.to(where), torch.Generator().manual_seed(0),
                noise=noise).cpu()

        arms = [("bf16", "bfloat16", "bfloat16"),
                ("float32", "float32", "float32")]
        if saved["R"] is not None:
            arms += [("bf16 G, float32 R", "bfloat16", "float32"),
                     ("float32 G, bf16 R", "float32", "bfloat16")]
        bound = BENCH_REF_BOUNDS[preset]
        for name, g_dtype, r_dtype in arms:
            out_card = run(g_dtype, r_dtype, dev)
            require(bool(torch.isfinite(out_card).all()),
                    f"[bench reference] {preset}: non-finite output")
            err = float((out_card - ref).abs().max()) / \
                float(ref.abs().max())
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


# Seconds each phase of main() took, printed before the result lines.
PHASE_SECONDS: dict[str, float] = {}
T_START = time.perf_counter()


def timed(name: str, fn, *args):
    """fn(*args), its seconds added to PHASE_SECONDS[name]."""
    t = time.perf_counter()
    out = fn(*args)
    PHASE_SECONDS[name] = PHASE_SECONDS.get(name, 0.0) + \
        time.perf_counter() - t
    return out


def main():
    card = phase_device()
    bench_ref, bench_ref_dir = start_bench_reference()
    try:
        return run_phases(card, bench_ref, bench_ref_dir)
    finally:
        if bench_ref.poll() is None:
            bench_ref.kill()
            bench_ref.wait()
        shutil.rmtree(bench_ref_dir, ignore_errors=True)


def run_phases(card: str, bench_ref: subprocess.Popen, bench_ref_dir: str):
    dev = torch.device("cuda")
    timed("build", phase_build)
    max_err = timed("kernel", phase_kernel, dev)
    svc, launches_slice = timed("slice", phase_slice, dev)
    timed("reference", phase_reference, svc, dev)
    av, launches_av = timed("av", phase_av, dev)
    launches_options = timed("options", phase_options, dev)
    refiner, launches_refiner = timed("refiner", phase_refiner, dev)
    timed("refiner_reference", phase_refiner_reference, refiner, dev)
    with tempfile.TemporaryDirectory() as ckpt:
        trains = {kind: timed(f"train {kind}", phase_train, dev, kind, ckpt)
                  for kind in TRAIN_MODELS}
        launches_eval = timed("eval", phase_eval, dev, ckpt, "chip_audio")
        launches_data = timed("data", phase_data, dev, ckpt, card)
        launches_frames = timed("frames", phase_frames, dev, ckpt, card)
        launches_video = timed("video", phase_video, dev, ckpt, card)
        timed("train_refiner", phase_train_refiner, dev, ckpt, "chip_audio")
        launches_trained = timed("eval_trained", phase_eval_trained, dev,
                                 ckpt, "chip_audio")
    timed("train_reference", phase_train_reference, dev)
    timed("train_refiner_reference", phase_train_refiner_reference, dev)
    times = timed("times", phase_times, svc, dev, card)
    timed("times_av", phase_times_av, av, dev, card)
    for kind in TRAIN_MODELS:
        timed("times_train", phase_times_train, dev, card, kind)
    timed("times_refiner", phase_times_refiner, dev, card)
    timed("times_train_refiner", phase_times_train_refiner, dev, card)
    timed("profile", phase_profile, svc, card)
    timed("profile_av", phase_profile, av, card, "profile av")
    launches_bench = timed("bench", phase_bench, dev)
    timed("bench_reference", phase_bench_reference, dev, bench_ref,
          bench_ref_dir)
    timed("profile_bench", phase_profile_bench, dev, card)
    launches_mesh = timed("mesh", phase_mesh, dev)
    t_new = time.perf_counter()
    launches_scripts = timed("scripts", phase_scripts, dev, card)
    timed("tensorboard", phase_tensorboard)
    timed("compile_cache", phase_compile_cache)
    log(f"[scripts] [tensorboard] [compile cache] took "
        f"{time.perf_counter() - t_new:.1f} s together")
    log("[phases] seconds: " + ", ".join(
        f"{k} {v:.1f}" for k, v in PHASE_SECONDS.items())
        + f"; total {time.perf_counter() - T_START:.1f}")
    t = times[32]
    launches_train = sum(r["launches"] for r in trains.values())
    launches_served = sum(r["served"] for r in trains.values())
    print(json.dumps({"kernels": [{
        "name": "griffin_lim", "route": "cuda",
        "source": "viai_tpu_torch/csrc/griffin_lim.cu",
        "replaces": "viai_tpu/signal/pallas_gl.py:632",
        "launches": (launches_slice + launches_av + launches_options
                     + launches_train + launches_served + launches_refiner
                     + launches_eval + launches_data + launches_frames
                     + launches_video + launches_trained
                     + launches_bench + launches_mesh + launches_scripts),
        "launches_by_path": {"slice": launches_slice, "av": launches_av,
                             "options": launches_options,
                             "train": launches_train,
                             "train_served": launches_served,
                             "refiner": launches_refiner,
                             "eval": launches_eval, "data": launches_data,
                             "frames": launches_frames,
                             "video": launches_video,
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
    if len(sys.argv) == 3 and sys.argv[1] == BENCH_REF_FLAG:
        sys.exit(bench_reference_cpu(sys.argv[2]))
    sys.exit(main())
