"""Cost report for the main programs: FLOPs, bytes and their ratio.

Port of `scripts/cost_analysis.py`, which reads XLA's compile-time cost
model. Eager PyTorch has none; the program runs once on the device
under two dispatch modes instead:

  * gflops: the conv and matmul FLOPs, from
    torch.utils.flop_counter.FlopCounterMode, per program and per top
    module; plus, for each launch of the Griffin-Lim CUDA kernel, which
    no dispatch mode sees (ctypes), utils/cost.py's gl_ops;
  * gbytes: the bytes of every dispatched op's operands and results
    (utils/cost.py::ByteCounterMode, views skipped) plus gl_bytes per
    kernel launch — an unfused upper bound on the memory traffic;
  * arithmetic_intensity: their ratio, FLOP per byte.

Programs, as the JAX script's: bf16 G forward with its preprocessing
at --batch, the full chain (G, GL×32 phase-aware) at --batch, one
train step (G and D in bf16, Adam) at min(batch, 32). Prints one JSON
line per program and appends one record to
{--results_dir}/quality_results.jsonl.

    python -m viai_tpu_torch.scripts.cost_analysis [--batch 128] \\
        [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import torch
from torch.utils.flop_counter import FlopCounterMode

from .._device import resolve_device
from ..io.results import append_record
from ..nn import define_D, define_G
from ..signal.gl_cuda import griffin_lim_cuda
from ..train import (TrainConfig, adam, init_state, make_infer_fn,
                     make_train_step, preprocess)
from ..train.preprocess import g_input
from ..utils.cost import ByteCounterMode, gl_bytes, gl_ops
from ._quality import device_name

CLIP = 32000
N_GL_ITER = 32
BYTES_NOTE = ("gbytes sums every dispatched op's operands and results: an "
              "unfused upper bound on the memory traffic")


def report(name: str, fn, gl_launch: tuple[int, int] = (0, 0)) -> dict:
    """Run fn() once under the counters; `gl_launch` is (operations,
    bytes) of one GL kernel launch, added for each launch made."""
    launches = griffin_lim_cuda.launches
    with FlopCounterMode(display=False) as flops, ByteCounterMode() as nbytes:
        fn()
    n_gl = griffin_lim_cuda.launches - launches
    total = flops.get_total_flops() + n_gl * gl_launch[0]
    moved = nbytes.nbytes + n_gl * gl_launch[1]
    by_module = {k: round(sum(v.values()) / 1e9, 4)
                 for k, v in flops.get_flop_counts().items()
                 if k != "Global" and "." not in k}
    rec = {"program": name, "gflops": round(total / 1e9, 2),
           "gbytes": round(moved / 1e9, 3),
           "arithmetic_intensity": round(total / max(moved, 1), 1),
           "gflops_by_module": by_module, "gl_launches": n_gl,
           "note": BYTES_NOTE}
    print(json.dumps(rec), flush=True)
    return rec


def run(G, D, cfg: TrainConfig, batch: int, device) -> list[dict]:
    """The three programs' reports for G and D (their dtype is the
    nets')."""
    wav = torch.zeros(batch, CLIP, device=device)
    gen = torch.Generator(device=device)
    n_frames = cfg.stft.num_frames(CLIP)
    per_launch = (gl_ops(batch, n_frames, cfg.n_bins, cfg.stft.n_fft,
                         N_GL_ITER),
                  gl_bytes(batch, n_frames, cfg.n_bins, CLIP))

    def g_fwd():
        with torch.no_grad():
            G(g_input(preprocess(wav, gen.manual_seed(0), cfg)))

    infer = make_infer_fn(G, cfg, n_gl_iter=N_GL_ITER, external_mask=False)
    tb = min(batch, 32)
    step = make_train_step(G, D, None, adam(G.parameters(), 2e-4),
                           adam(D.parameters(), 2e-4), cfg)
    state = init_state(D, cfg)
    return [
        report("G forward + preprocess", g_fwd),
        report(f"full inference chain (G + GL{N_GL_ITER})",
               lambda: infer(wav, gen.manual_seed(0)), per_launch),
        report(f"train step (batch {tb})",
               lambda: step(state, wav[:tb], None, gen.manual_seed(0))),
    ]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--results_dir", type=str, default="results/")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    G = define_G(dtype="bfloat16", device=dev)
    D = define_D(input_nc=3, dtype="bfloat16", device=dev)
    programs = run(G, D, TrainConfig(), args.batch, dev)
    rec = {"exp": "cost_analysis", "batch": args.batch,
           "programs": programs, "package": "viai_tpu_torch",
           "device": device_name(dev), "t": time.time()}
    append_record(rec, args.results_dir)
    return rec


if __name__ == "__main__":
    main()
