"""Loader factory — the reference's `CreateDataLoader(opt)` surface, for
the port.

Port of `viai_tpu/data/loader.py::create_dataloader`. The synthetic
modes: a shuffled endless request (training) gets the vectorized,
threaded `SyntheticBatchIterator`; any other gets `InOrderLoader`, the
dataset's indices in order. The folder modes (`audio`, `av`,
`musices`): a shuffled endless `audio` request gets the native C++
clip loader (`NativeAudioIterator`) unless prefer_native is False;
every other request a `torch.utils.data.DataLoader` over the dataset
(`nThreads` worker processes, started by spawn, and pinned batches on
a card's machine), where the JAX package uses grain. Item idx of a
dataset is a function of (seed, idx) and equals the JAX package's;
the order in which indices are drawn is the port's own, and each epoch
reads fresh crops (the JAX package varies them in endless shuffled
runs only).
"""

from __future__ import annotations

import multiprocessing
import typing as tp

import numpy as np
import torch

from .. import native
from .audio import AudioFolderDataset, find_wavs
from .av import AVFolderDataset, MusicesManifest
from .synthetic import (SyntheticAVDataset, SyntheticBatchIterator,
                        SyntheticConfig)

SYNTHETIC_MODES = ("synthetic", "synthetic_av", "synthetic_notes",
                   "synthetic_notes_grid", "synthetic_av_notes",
                   "synthetic_av_cue")
FOLDER_MODES = ("audio", "av", "musices")


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


class EpochSampler(torch.utils.data.Sampler):
    """Indices of `num_epochs` epochs (None: endless) of `epoch_records`
    each: epoch e is its records in order, or permuted by
    default_rng((seed, e)) under shuffle, offset by e·epoch_records
    modulo VIRTUAL_EPOCHS·epoch_records. A folder dataset picks the
    file by idx % len and seeds the crop with (seed, idx), so each epoch
    reads fresh crops, the JAX package's items for those raw indices."""

    VIRTUAL_EPOCHS = 1024    # the JAX package's EpochVariedSource length

    def __init__(self, epoch_records: int, shuffle: bool, seed: int,
                 num_epochs: int | None):
        self.epoch_records = epoch_records
        self.shuffle, self.seed, self.num_epochs = shuffle, seed, num_epochs

    def __iter__(self):
        e = 0
        while self.num_epochs is None or e < self.num_epochs:
            order = (np.random.default_rng((self.seed, e)).permutation(
                self.epoch_records) if self.shuffle
                else np.arange(self.epoch_records))
            base = (e % self.VIRTUAL_EPOCHS) * self.epoch_records
            yield from (base + order).tolist()
            e += 1

    def __len__(self):
        if self.num_epochs is None:
            raise TypeError("an endless sampler has no length")
        return self.epoch_records * self.num_epochs


def collate(items: list[dict]) -> dict[str, torch.Tensor]:
    """Items → a batch dict of float32 tensors, stacked by
    default_collate: inside a worker straight into shared memory, so the
    worker's queue thread only passes handles (a worker whose queue
    thread still copied a batch into shared memory when the loader shut
    down aborted as it exited)."""
    return torch.utils.data.default_collate(
        [{k: np.asarray(v, np.float32) for k, v in it.items()}
         for it in items])


def torch_loader(source, batch_size: int, n_workers: int, seed: int,
                 shuffle: bool = True, num_epochs: int | None = None
                 ) -> torch.utils.data.DataLoader:
    """A DataLoader of whole batches over `source` in EpochSampler's
    order, with `epoch_batches`, the batches in one pass."""
    sampler = EpochSampler(len(source), shuffle, seed, num_epochs)
    loader = torch.utils.data.DataLoader(
        source, batch_size=batch_size, sampler=sampler, drop_last=True,
        collate_fn=collate, num_workers=n_workers,
        pin_memory=torch.cuda.is_available(),
        multiprocessing_context=(multiprocessing.get_context("spawn")
                                 if n_workers > 0 else None))
    loader.epoch_batches = max(len(source) // batch_size, 1)
    return loader


class NativeAudioIterator:
    """The native clip loader as an endless iterator of {'wav': (B, S)}
    batches."""

    def __init__(self, root: str, batch_size: int, clip_samples: int,
                 sample_rate: int, n_workers: int, seed: int):
        paths = find_wavs(root)
        if not paths:
            raise FileNotFoundError(f"no .wav files under {root}")
        self._loader = native.NativeClipLoader(
            paths, clip_samples=clip_samples, target_sr=sample_rate,
            batch=batch_size, n_workers=max(n_workers, 1), seed=seed)
        self.epoch_batches = max(len(paths) // batch_size, 1)

    def __iter__(self):
        return self

    def __next__(self):
        return {"wav": self._loader.next()}

    def close(self):
        self._loader.close()


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
    prefer_native: bool = True,
    split: str = "train",
) -> tp.Iterable[dict]:
    """→ iterable of batch dicts {'wav': (B, S) [, 'frames': (B, T, H,
    W, 3), 'frames_valid': (B,)]}, float32: numpy arrays from the
    synthetic modes and the native loader, tensors (pinned on a card's
    machine) from a DataLoader. `split` picks the manifest's split
    under `musices`."""
    if dataset_mode in SYNTHETIC_MODES:
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
        if prefer_native and shuffle and num_epochs is None:
            return SyntheticBatchIterator(cfg, batch_size, seed=seed)
        return InOrderLoader(SyntheticAVDataset(cfg), batch_size, num_epochs)
    if dataset_mode not in FOLDER_MODES:
        raise ValueError(f"unknown dataset_mode: {dataset_mode}")
    if dataset_mode == "audio" and prefer_native and shuffle \
            and num_epochs is None:
        return NativeAudioIterator(dataroot, batch_size, clip_samples,
                                   sample_rate, n_threads, seed)
    if dataset_mode == "audio":
        src = AudioFolderDataset(dataroot, clip_samples, sample_rate, seed)
    elif dataset_mode == "av":
        src = AVFolderDataset(dataroot, clip_samples, sample_rate, n_frames,
                              frame_size, seed)
    else:
        src = MusicesManifest(dataroot, split, clip_samples, sample_rate,
                              n_frames, frame_size, seed)
    native.library()     # built here, once, before any worker starts
    return torch_loader(src, batch_size, n_threads, seed, shuffle=shuffle,
                        num_epochs=num_epochs)
