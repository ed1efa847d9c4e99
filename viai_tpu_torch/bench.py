"""Benchmark: throughput of a 2 s-clip inpainting chain on one card.

    python -m viai_tpu_torch.bench [--preset default] [--batch 128] ...

Port of the JAX package's `bench.py`: the same presets, flags and
defaults (batch 128, GL×32, G and R in bfloat16 with Griffin-Lim in
float32), without the TPU-only `--gl_backend`, with `--device` (the
card unless the caller asks for the CPU). Chains (`build_infer`), at
the flagship TrainConfig() (256×256 images, n_fft 510, hop 128):

  * default: STFT → gap mask → U-Net G → composite → phase-aware
    Griffin-Lim (the CUDA kernel on the card) → waveform;
  * refiner_mag: + 8 DDIM steps of the magnitude refiner R from t 0.35
    before Griffin-Lim;
  * refiner_complex: the GL-free complex-domain decode, 16 DDIM steps
    from t 1 and the posterior mean of 8 samples, `--refine_chunk` at a
    time, then one iSTFT; hybrid: the same with G's magnitude kept
    under the mean's phase (complex_mag "keep").

The gaps are drawn inside the chain from a generator seeded 0 (the
card's default generator). Weights are random from a seed: throughput
does not depend on them (a fresh R's zero-initialised FiLM and head run
the same program as trained ones).

Timing, as the JAX bench times it: one sample is `--iters` calls of a
step that chains `--inner` chain calls, each consuming the previous
call's output waveform; the host clock runs around the sample and one
copy of the result to the host ends it (its values must be finite).
With `--inner` > 1 on the card the default preset's step is one CUDA
graph of the `inner` chained calls, captured once after a warm-up: one
dispatch a sample, as the JAX bench's `lax.scan` in one jit. The
refiner presets run their chained calls eagerly (`graph` false): their
posterior samples' noise generators are seeded per call from a host
value, a wait on the card that a capture cannot hold. One cold sample
is discarded; then 5 to 12 samples are taken until the plateau (samples
≥ 0.85 × the median) has at least 5 members spread under 5%; the value
is the plateau's median.

Prints ONE JSON line: the metric, value and unit, the samples and their
spread, the preset, batch, dtype, gl_iters, refine_chunk, inner and
graph, and the card's name and power limit (nvidia-smi). The Griffin-
Lim wrapper's launch count (signal/gl_cuda.py) counts a graph's
launches at each replay, not at its capture.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from ._device import resolve_device
from .nn import define_G, define_R
from .signal.gl_cuda import griffin_lim_cuda
from .train import TrainConfig, make_infer_fn
from .train.diffusion import (complex_refiner_channels,
                              make_complex_refiner_infer_fn)
from .utils.compile_cache import enable as enable_build_cache

PRESETS = ("default", "refiner_mag", "refiner_complex", "hybrid")
GRAPH_PRESETS = ("default",)   # the presets whose step is a CUDA graph
CLIP = 32000


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--iters", type=int, default=1,
                    help="dispatched steps per timed sample")
    ap.add_argument("--inner", type=int, default=64,
                    help="chain calls chained inside one step (one CUDA "
                         "graph on the card for the default preset)")
    ap.add_argument("--gl_iters", type=int, default=32)
    ap.add_argument("--dtype", type=str, default="bfloat16",
                    choices=["float32", "bfloat16"],
                    help="G's and R's compute dtype (GL stays float32)")
    ap.add_argument("--phase_init", type=str, default="auto",
                    choices=["auto", "zero", "extrapolate"])
    ap.add_argument("--no_phase_aware", action="store_true",
                    help="zero-phase GL on the whole magnitude")
    ap.add_argument("--refine_chunk", type=int, default=4,
                    help="refiner_complex/hybrid posterior-mean chunk: "
                         "peak memory scales with batch x chunk")
    ap.add_argument("--preset", type=str, default="default",
                    choices=PRESETS)
    ap.add_argument("--device", type=str, default="cuda")
    return ap.parse_args(argv)


def build_nets(preset: str, dtype: str, device):
    """(G, R) at full width, weights from fixed seeds; R None for the
    default preset."""
    G = define_G(dtype=dtype, device=device)
    R = None
    if preset == "refiner_mag":
        R = define_R(4, dtype=dtype, device=device)
    elif preset != "default":
        r_in, r_out = complex_refiner_channels(2)
        R = define_R(r_in, dtype=dtype, out_channels=r_out, device=device)
    return G, R


def build_infer(preset: str, G, R, cfg: TrainConfig, args):
    """The preset's chain: infer(wav (B, T), generator, noise=None)
    → (B, T) wav, its gaps drawn from `generator` (`noise`, the refiner's
    draws, stands in for its own)."""
    if preset == "default":
        return make_infer_fn(G, cfg, n_gl_iter=args.gl_iters,
                             phase_aware=not args.no_phase_aware,
                             phase_init=args.phase_init,
                             external_mask=False)
    if preset == "refiner_mag":
        return make_infer_fn(G, cfg, n_gl_iter=args.gl_iters,
                             phase_aware=not args.no_phase_aware,
                             phase_init=args.phase_init, refiner=R,
                             refine_steps=8, refine_t=0.35,
                             external_mask=False)
    if preset not in PRESETS:
        raise ValueError(f"unknown preset {preset!r}")
    return make_complex_refiner_infer_fn(
        G, R, cfg, steps=16, t_start=1.0, refine_avg=8,
        refine_chunk=args.refine_chunk,
        complex_mag="keep" if preset == "hybrid" else "sample",
        external_mask=False)


def chain_name(args) -> str:
    if args.preset == "default":
        return f"2s inpaint + Griffin-Lim x{args.gl_iters}"
    if args.preset == "refiner_mag":
        return ("2s inpaint + 8-step DDIM refiner + Griffin-Lim "
                f"x{args.gl_iters}")
    return ("2s inpaint + complex DDIM x16 avg8 GL-free decode"
            + (" + mag-keep hybrid" if args.preset == "hybrid" else ""))


def card_info(dev: torch.device) -> tuple[str, float]:
    """(name, power limit in W) of the card, as nvidia-smi reads them."""
    idx = torch.cuda.current_device() if dev.index is None else dev.index
    out = subprocess.run(
        ["nvidia-smi", "-i", str(idx), "--query-gpu=name,power.limit",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    return torch.cuda.get_device_name(dev), float(out.split(",")[-1])


def make_step(infer, wav: torch.Tensor, generator, inner: int,
              graph: bool):
    """step(w) → the waveform after `inner` chained chain calls. With
    `graph`, the calls are captured once (after two eager warm-up
    calls) as one CUDA graph over a static input; each replay adds the
    captured Griffin-Lim launches to the wrapper's count."""
    def chained(w):
        for _ in range(inner):
            w = infer(w, generator)
        return w

    if not graph:
        return chained
    dev = wav.device
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        infer(infer(wav, generator), generator)
    torch.cuda.current_stream(dev).wait_stream(side)
    static_in = wav.clone()
    g = torch.cuda.CUDAGraph()
    before = griffin_lim_cuda.launches
    with torch.cuda.graph(g):
        static_out = chained(static_in)
    per_replay = griffin_lim_cuda.launches - before
    griffin_lim_cuda.launches = before    # the capture ran nothing

    def replay(w):
        static_in.copy_(w)
        g.replay()
        griffin_lim_cuda.launches += per_replay
        return static_out

    return replay


def split_plateau(xs):
    med = float(np.median(xs))
    return ([s for s in xs if s >= 0.85 * med],
            [s for s in xs if s < 0.85 * med])


def spread(xs) -> float:
    return (max(xs) - min(xs)) / float(np.median(xs))


def main(argv=None) -> dict:
    enable_build_cache()
    args = parse_args(argv)
    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    cfg = TrainConfig()
    G, R = build_nets(args.preset, args.dtype, dev)
    infer = build_infer(args.preset, G, R, cfg, args)
    if on_card:
        idx = torch.cuda.current_device() if dev.index is None else dev.index
        generator = torch.cuda.default_generators[idx]
    else:
        generator = torch.Generator()
    generator.manual_seed(0)
    rng = np.random.default_rng(0)
    wav = torch.from_numpy(
        rng.standard_normal((args.batch, CLIP)).astype(np.float32) * 0.1
    ).to(dev)
    graph = on_card and args.preset in GRAPH_PRESETS and args.inner > 1
    step = make_step(infer, wav, generator, max(args.inner, 1), graph)
    step(wav).cpu()                        # warm-up: builds, caches

    def one_sample() -> float:
        t0 = time.perf_counter()
        w = wav
        for _ in range(args.iters):
            w = step(w)
        host = w.cpu().numpy()
        dt = time.perf_counter() - t0
        if not np.isfinite(host).all():
            raise RuntimeError("the chain produced non-finite samples")
        return args.batch * args.iters * max(args.inner, 1) / dt

    cold = one_sample()                    # discarded
    samples = [one_sample() for _ in range(5)]
    while len(samples) < 12:
        plateau, _ = split_plateau(samples)
        if len(plateau) >= 5 and spread(plateau) < 0.05:
            break
        samples.append(one_sample())
    plateau, stalls = split_plateau(samples)
    print(f"cold (discarded): {cold:.1f}; samples (clips/s): "
          f"{[round(s, 1) for s in samples]}; {len(stalls)} stall(s): "
          f"{[round(s, 1) for s in stalls]}", file=sys.stderr)
    card, power = card_info(dev) if on_card else ("cpu", None)
    metric = "clips_per_sec_per_card" if on_card else "clips_per_sec_cpu"
    res = {
        "metric": f"{metric} ({chain_name(args)})",
        "value": float(np.median(plateau)),
        "unit": "clips/s/card" if on_card else "clips/s (CPU)",
        "n_samples": len(samples),
        "n_plateau": len(plateau),
        "n_stall_samples": len(stalls),
        "plateau_spread_pct": 100.0 * spread(plateau),
        "raw_spread_pct": 100.0 * spread(samples),
        "samples_clips_per_sec": samples,
        "cold_discarded": cold,
        "preset": args.preset,
        "batch": args.batch,
        "dtype": args.dtype,
        "gl_iters": args.gl_iters,
        "refine_chunk": args.refine_chunk,
        "inner": args.inner,
        "graph": graph,
        "card": card,
        "power_limit_w": power,
    }
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
