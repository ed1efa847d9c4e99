"""Drive the PyTorch port (viai_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
  1. device: a CUDA card must be present; TF32 is switched off for
     matmuls and cuDNN convolutions, so every product is full float32;
  2. build: nvcc builds the Griffin-Lim kernel from csrc/;
  3. the kernel against its plain PyTorch version at the serving
     shapes (B = 8 clips of 2 s: F = 251 frames × 256 bins, 32000
     samples);
  4. the serving chain: InpaintService with the define_G() defaults
     (ngf 64, six levels) and GL×32, requests of 3, 8 and 21 clips and
     five streamed clips, with the kernel's launches counted; and the
     chain on the card against the chain on the CPU on a small input;
  5. times, with CUDA events after warm-up, and the device time of one
     bucket-32 request by kernel (torch.profiler).
The last two lines are the card's name and power limit (as nvidia-smi
prints them) and the JSON result; the line before them lists the
kernels with their launches, errors and times.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from viai_tpu_torch import (InpaintService, TrainConfig, define_G,
                            make_infer_fn)
from viai_tpu_torch import _build
from viai_tpu_torch.signal import griffin_lim, stft
from viai_tpu_torch.signal.gl_cuda import griffin_lim_cuda

SR, CLIP = 16000, 32000
GAP_S = (0.8, 1.2)
HOLE = (100, 131)            # hole frames of the kernel checks
# Published float32 (non-tensor-core) peak and memory rate of an H100
# SXM at its 700 W limit (NVIDIA data sheet).
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12


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
                n_iter: int, T: int) -> tuple[float, float]:
    """Least time for GL×n_iter: (by operations, by bytes), in ms.

    Operations: per iteration 4 products of F×n_bins×n_fft
    multiply-adds (iDFT re/im, DFT cos/sin), plus the final iDFT.
    Bytes: mag, obs_re, obs_im, init_re, init_im read once, the
    waveform written once."""
    macs = batch * n_frames * n_bins * n_fft * (4 * n_iter + 2)
    nbytes = 4 * (5 * batch * n_frames * n_bins + batch * T)
    return 2 * macs / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3


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
        log(f"[build] {r.name}: nvcc {r.seconds:.2f} s (wall {wall:.2f} s) "
            f"-> {r.path.name}")
        for line in r.log.splitlines():
            if "Used" in line or "spill" in line or "Compiling entry" in line:
                log(f"[build]   {line.strip()}")


def phase_kernel(dev) -> float:
    """Kernel vs plain at the serving shapes; returns the max abs error
    over the n_iter ≤ 4 cases."""
    cfg, x, mag, obs = gl_inputs(8, dev)
    n = x.shape[-1]
    worst = 0.0
    cases = [("zero", {}), ("observed", {"observed": obs}),
             ("observed+extrapolate",
              {"observed": obs, "phase_init": "extrapolate"})]
    for n_iter in (0, 1, 4):
        for name, kw in cases:
            out = griffin_lim_cuda(mag, cfg, n_iter=n_iter, length=n, **kw)
            ref = griffin_lim(mag, cfg, n_iter=n_iter, length=n, **kw)
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            ok = bool(torch.allclose(out, ref, atol=1e-3, rtol=1e-3))
            log(f"[kernel] GL×{n_iter} {name}: max|Δ| {err:.3e} "
                f"(bound atol=rtol=1e-3) {'ok' if ok else 'FAIL'}")
            require(ok, f"kernel disagrees with plain at n_iter={n_iter} {name}")
            worst = max(worst, err)
    kw = {"observed": obs, "phase_init": "extrapolate"}
    out = griffin_lim_cuda(mag, cfg, n_iter=32, length=n, **kw)
    ref = griffin_lim(mag, cfg, n_iter=32, length=n, **kw)
    sl = observed_slices(HOLE, cfg.hop_length, cfg.n_fft, n)
    e_obs = rel_err(out, ref, sl)
    hole = slice(sl[0].stop, sl[1].start)
    e_hole = rel_err(out, ref, [hole])
    log(f"[kernel] GL×32 observed+extrapolate: observed-region rel err "
        f"{e_obs:.3e} (bound 1e-3); hole rel err {e_hole:.3e} (GL is "
        f"chaotic in the hole; not bounded)")
    require(e_obs < 1e-3, "kernel disagrees with plain at GL×32 (observed)")
    return worst


def phase_slice(dev) -> tuple[InpaintService, int]:
    """The serving chain at full width; returns the service and the
    kernel's launches during the main-path run."""
    cfg = TrainConfig()
    svc = InpaintService(define_G(), cfg, buckets=(8, 32), gl_iters=32)
    griffin_lim_cuda.launches = 0
    griffin_lim.calls = 0
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
    wall = time.perf_counter() - t0
    launches, plain_calls = griffin_lim_cuda.launches, griffin_lim.calls
    outs[5] = (wavs, np.stack([f.result(timeout=60) for f in futs]))
    require(len(flushed) == 5, "flush returned the wrong number of clips")
    m = svc.time_mask_from_seconds(1, *GAP_S)[0]
    hole = np.nonzero(m == 0)[0]
    sl = observed_slices((hole[0], hole[-1] + 1), cfg.stft.hop_length,
                         cfg.stft.n_fft, CLIP)
    for n_req, (x, y) in outs.items():
        require(y.shape == x.shape == (n_req, CLIP), f"bad shape {y.shape}")
        require(bool(np.isfinite(y).all()), "non-finite output")
        err = rel_err(torch.from_numpy(y), torch.from_numpy(x), sl)
        log(f"[slice] {n_req} clips -> {y.shape}, finite, observed-region "
            f"rel err vs input {err:.3e} (bound 1e-2)")
        require(err < 1e-2, "observed region not reconstructed")
    log(f"[slice] {svc.stats.batches} batches, {svc.stats.padded_clips} "
        f"padded clips, {wall:.2f} s incl. first-call set-up; "
        f"griffin_lim_cuda launches {launches}, plain griffin_lim calls "
        f"{plain_calls}")
    require(launches > 0, "the main path never launched the GL kernel")
    require(plain_calls == 0, "the main path ran the plain griffin_lim")
    return svc, launches


def phase_reference(svc: InpaintService, dev):
    """The chain on the card against the chain on the CPU (plain GL),
    same weights and input, 2 clips, GL×1."""
    cfg = svc.cfg
    x = tones(2, seed=7, device="cpu")
    m = torch.from_numpy(svc.time_mask_from_seconds(2, *GAP_S))
    ys = {}
    for d in ("cpu", dev):
        infer = make_infer_fn(define_G(device=d), cfg, n_gl_iter=1)
        ys[str(d)] = infer(x.to(d), m.to(d)).cpu()
    a, b = ys[str(dev)], ys["cpu"]
    err = float((a - b).abs().max()) / float(b.abs().max())
    log(f"[reference] chain on {dev} vs CPU, 2 clips GL×1: max|Δ|/max|ref| "
        f"{err:.3e} (bound 1e-3)")
    require(err < 1e-3, "the chain on the card disagrees with the CPU")


def phase_times(svc: InpaintService, dev, card: str) -> dict:
    tag = f"({torch.cuda.get_device_name(0)}, {card.split(',')[-1].strip()})"
    res = {}
    for batch in (8, 32):
        cfg, x, mag, obs = gl_inputs(batch, dev, seed=batch)
        n = x.shape[-1]
        kw = {"observed": obs, "phase_init": "extrapolate"}
        k_ms = time_ms(lambda: griffin_lim_cuda(mag, cfg, 32, n, **kw), 5)
        p_ms = time_ms(lambda: griffin_lim(mag, cfg, 32, n, **kw), 5)
        k0_ms = time_ms(lambda: griffin_lim_cuda(mag, cfg, 32, n), 5)
        ops_ms, bytes_ms = gl_bound_ms(batch, mag.shape[1], mag.shape[2],
                                       cfg.n_fft, 32, n)
        res[batch] = dict(kernel_ms=k_ms, plain_ms=p_ms, bound_ms=max(
            ops_ms, bytes_ms), bound_by="operations" if ops_ms >= bytes_ms
            else "bytes")
        log(f"[times] GL×32 B={batch}: kernel {k_ms:.3f} ms (zero init, no "
            f"observed: {k0_ms:.3f} ms), plain {p_ms:.3f} ms, bound "
            f"{max(ops_ms, bytes_ms):.3f} ms (operations {ops_ms:.3f}, bytes "
            f"{bytes_ms:.3f}) -> {max(ops_ms, bytes_ms) / k_ms:.1%} of the "
            f"fp32 roofline {tag}")
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


def phase_profile(svc: InpaintService, card: str):
    """Device time by kernel for one bucket-32 request (torch.profiler),
    and the device's busy share of the request's wall time."""
    from torch.profiler import ProfilerActivity, profile

    batch = svc.buckets[-1]
    wavs = tones(batch, seed=300, device="cpu").numpy()
    svc.inpaint(wavs, gap_start_s=GAP_S[0], gap_end_s=GAP_S[1])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        svc.inpaint(wavs, gap_start_s=GAP_S[0], gap_end_s=GAP_S[1])
        wall_ms = (time.perf_counter() - t0) * 1e3
    # Kernel rows only: an operator's row repeats its kernels' time.
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    total_us = sum(e.self_device_time_total for e in rows)
    tag = f"({torch.cuda.get_device_name(0)}, {card.split(',')[-1].strip()})"
    if not rows:
        log("[profile] no device time in the trace: not measured")
        return
    log(f"[profile] bucket {batch} request: device busy {total_us / 1e3:.2f} "
        f"ms of {wall_ms:.2f} ms wall ({total_us / 1e3 / wall_ms:.1%}; "
        f"profiler on) {tag}")
    rows.sort(key=lambda e: -e.self_device_time_total)
    for e in rows[:12]:
        log(f"[profile]   {e.self_device_time_total / 1e3:8.3f} ms "
            f"{e.self_device_time_total / total_us:6.1%} x{e.count:<4d} "
            f"{e.key[:90]}")


def main():
    card = phase_device()
    dev = torch.device("cuda")
    phase_build()
    max_err = phase_kernel(dev)
    svc, launches = phase_slice(dev)
    phase_reference(svc, dev)
    times = phase_times(svc, dev, card)
    phase_profile(svc, card)
    t = times[32]
    print(json.dumps({"kernels": [{
        "name": "griffin_lim", "route": "cuda",
        "source": "viai_tpu_torch/csrc/griffin_lim.cu",
        "replaces": "viai_tpu/signal/pallas_gl.py:632",
        "launches": launches, "max_abs_err": max_err,
        "ms": t["kernel_ms"], "kernel_ms": t["kernel_ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": None,
        "batch": 32, "n_iter": 32,
    }]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
