"""Loader factory — the reference's `CreateDataLoader(opt)` surface, for
the port.

Port of `viai_tpu/data/loader.py::create_dataloader` for the synthetic
dataset modes. A shuffled endless request (training) gets the
vectorized, threaded `SyntheticBatchIterator`; a non-shuffled or
finite-epoch request gets `InOrderLoader`, a plain iterator over the
dataset's indices in order (the JAX package uses grain there, which
the card's machine does not have). The folder datasets (`audio`, `av`,
`musices`) are not ported yet (ROADMAP "Data on CUDA").
"""

from __future__ import annotations

import typing as tp

import numpy as np

from .synthetic import (SyntheticAVDataset, SyntheticBatchIterator,
                        SyntheticConfig)

SYNTHETIC_MODES = ("synthetic", "synthetic_av", "synthetic_notes",
                   "synthetic_notes_grid", "synthetic_av_notes",
                   "synthetic_av_cue")


class InOrderLoader:
    """Batches of a random-access source in index order, `num_epochs`
    passes (None: endless); the last partial batch is dropped."""

    def __init__(self, source, batch_size: int,
                 num_epochs: int | None = None):
        self.source = source
        self.batch_size = batch_size
        self.num_epochs = num_epochs
        self.epoch_batches = max(len(source) // batch_size, 1)

    def __iter__(self) -> tp.Iterator[dict]:
        epoch = 0
        while self.num_epochs is None or epoch < self.num_epochs:
            for b in range(len(self.source) // self.batch_size):
                items = [self.source[b * self.batch_size + i]
                         for i in range(self.batch_size)]
                yield {k: np.stack([it[k] for it in items]) for k in items[0]}
            epoch += 1


def create_dataloader(
    dataset_mode: str,
    dataroot: str | None = None,
    batch_size: int = 16,
    clip_samples: int = 32000,
    sample_rate: int = 16000,
    n_threads: int = 4,
    n_frames: int = 16,
    frame_size: int = 64,
    seed: int = 0,
    shuffle: bool = True,
    num_epochs: int | None = None,
) -> tp.Iterable[dict]:
    """→ iterable of batch dicts {'wav': (B, S) [, 'frames': (B, T, H,
    W, 3), 'frames_valid': (B,)]}, numpy float32."""
    if dataset_mode in ("audio", "av", "musices"):
        raise NotImplementedError(
            f"dataset_mode {dataset_mode!r} is not ported yet (ROADMAP "
            f"'Data on CUDA'); the port reads the synthetic modes "
            f"{SYNTHETIC_MODES}")
    if dataset_mode not in SYNTHETIC_MODES:
        raise ValueError(f"unknown dataset_mode: {dataset_mode}")
    cfg = SyntheticConfig(
        sample_rate=sample_rate,
        clip_seconds=clip_samples / sample_rate,
        with_video="_av" in dataset_mode,
        video_frames=n_frames,
        video_size=frame_size,
        style=("av_cue" if dataset_mode.endswith("_cue")
               else "notes_grid" if dataset_mode.endswith("_notes_grid")
               else "notes" if dataset_mode.endswith("_notes")
               else "harmonic"),
    )
    if shuffle and num_epochs is None:
        return SyntheticBatchIterator(cfg, batch_size, seed=seed)
    return InOrderLoader(SyntheticAVDataset(cfg), batch_size, num_epochs)
