"""Tracing/profiling and debug-mode guards.

The port's counterpart of `viai_tpu/utils/profiling.py`:
  * `trace(logdir)`: a torch.profiler trace (host and CUDA activity)
    around a block, written into `logdir` as a Chrome/TensorBoard trace;
  * a step timer with EMA throughput;
  * a debug mode: autograd's anomaly mode, which raises at the first
    backward op that produces a NaN (the counterpart of jax_debug_nans)
    and names the forward op that made it.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block; yields the profiler (its `key_averages()`
    give the device time by kernel) and writes
    `{logdir}/trace_<pid>_<ns>.json` when the block ends."""
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def enable_debug_mode():
    """Anomaly detection: every backward op's output is checked for
    NaNs. Expensive; use on a small config when chasing loss blowups."""
    torch.autograd.set_detect_anomaly(True)


def disable_debug_mode():
    torch.autograd.set_detect_anomaly(False)


class StepTimer:
    """EMA step-time / throughput tracker for the train loop."""

    def __init__(self, ema: float = 0.98):
        self.ema = ema
        self.avg = None
        self._t = None

    def tick(self) -> float | None:
        now = time.perf_counter()
        dt = None
        if self._t is not None:
            dt = now - self._t
            self.avg = (
                dt if self.avg is None
                else self.ema * self.avg + (1 - self.ema) * dt
            )
        self._t = now
        return dt

    def throughput(self, items_per_step: int) -> float:
        return items_per_step / self.avg if self.avg else 0.0
