"""Batched inference service — streaming inpaint with batch buckets.

Port of `viai_tpu/serving.py::InpaintService`:
  * any request size is padded up to the nearest batch bucket (8/32/128
    by default), so the chain only ever sees a few batch shapes;
  * clip length is fixed per service (2 s at 16 kHz); masks are an
    explicit dense (B, image_frames) keep-mask;
  * `submit`/`flush` coalesce single clips into micro-batches, flushed
    on demand, at a queue size, or at a deadline.
  * `V` and `frames` serve the vision-infused model (cfg.use_video):
    each clip comes with its (T, H, W, 3) frames;
  * `ensemble_states`, K−1 extra generators of G's architecture, serve
    a deep ensemble (the K predictions averaged inside the chain);
  * `refiner` serves the diffusion refiner R: in the magnitude domain
    between G and Griffin-Lim, or in the complex domain as the GL-free
    chain (one iSTFT), with every refine_* option. Its noise stream is
    fixed per call, so the same request gets the same answer.
The chain runs on `device`, the card unless the caller asks for the
CPU. With a `mesh` (train/mesh.py) it serves data-parallel, one process
a card: every rank is called with the whole request, runs its rows of
each padded bucket, and returns the whole result (the outputs are
all-gathered over the data group); the nets are replicated from rank 0
and the refiner's noise is drawn for the whole bucket, so the result is
the single-device one.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import threading
import time
import typing as tp

import numpy as np
import torch

from ._device import resolve_device
from .train.config import TrainConfig
from .train.diffusion import (RefineNoise, draw_noise,
                              make_complex_refiner_infer_fn, sample_generator)
from .train.infer import make_infer_fn
from .train.mesh import (Mesh, all_gather_rows, local_rows, replicate,
                         sync_batch_stats)


@dataclasses.dataclass
class ServiceStats:
    clips: int = 0
    batches: int = 0
    padded_clips: int = 0
    total_s: float = 0.0

    @property
    def clips_per_sec(self) -> float:
        return self.clips / self.total_s if self.total_s else 0.0


class InpaintService:
    """Bucketed, streaming spectrogram-inpainting service.

    >>> svc = InpaintService(define_G(), TrainConfig())
    >>> out = svc.inpaint(wavs, gap_start_s=0.8, gap_end_s=1.2)
    >>> av = InpaintService(define_G(fusion_channels=256), TrainConfig(
    ...     use_video=True), V=define_V())
    >>> out = av.inpaint(wavs, gap_start_s=0.8, gap_end_s=1.2, frames=frames)
    >>> ref = InpaintService(define_G(), TrainConfig(), refiner=define_R(4))
    """

    def __init__(
        self,
        G: torch.nn.Module,
        cfg: TrainConfig,
        V: torch.nn.Module | None = None,
        buckets: tp.Sequence[int] = (8, 32, 128),
        gl_iters: int = 32,
        clip_samples: int = 32000,
        sample_rate: int = 16000,
        phase_aware: bool = True,
        phase_init: str = "auto",
        mag_sharpen: float = 1.0,
        ensemble_states: tp.Sequence[torch.nn.Module] = (),
        refiner: torch.nn.Module | None = None,
        refiner_domain: str = "mag",
        refine_steps: int = 8,
        refine_t: float = 0.35,
        refine_noise: float = 1.0,
        refine_guidance: float = 0.0,
        refine_clamp: str = "x0",
        refine_resample: int = 0,
        refine_avg: int = 1,
        refine_chunk: int = 8,
        refine_mix: float = 0.0,
        refine_selfcond: bool = False,
        complex_mag: str = "sample",
        device: str | torch.device = "cuda",
        mesh: Mesh | None = None,
    ):
        """refiner (a DiffusionRefiner): refiner_domain 'mag' runs it
        between G and Griffin-Lim; 'complex' swaps the decode for the
        GL-free complex-domain chain (prefer refine_t=1.0 there), which
        serves no ensemble. With a `mesh` the chain runs on the mesh's
        device and each bucket must divide by its data axis."""
        if (ensemble_states and refiner is not None
                and refiner_domain == "complex"):
            raise ValueError("ensemble_states is not supported with "
                             "refiner_domain='complex'")
        self.mesh = mesh
        if mesh is not None:
            n_data = mesh.shape["data"]
            if any(b % n_data for b in buckets):
                raise ValueError(f"bucket sizes {tuple(buckets)} must "
                                 f"divide the data axis ({n_data})")
            device = mesh.device
        self.device = resolve_device(device)
        self.cfg = cfg
        self.G = G.to(self.device).eval()
        self.V = V.to(self.device).eval() if V is not None else None
        self.ensemble = [g.to(self.device).eval() for g in ensemble_states]
        self.R = (refiner.to(self.device).eval() if refiner is not None
                  else None)
        if mesh is not None:
            replicate([self.G, self.V, *self.ensemble, self.R], mesh)
            for m in (self.G, *self.ensemble, self.R):
                sync_batch_stats(m, mesh)
        # The refiner's noise of a padded bucket, drawn whole under a
        # mesh (channels of its image, DDIM steps, RePaint rounds, K).
        self._noise_plan = None
        if mesh is not None and self.R is not None:
            self._noise_plan = (2 if refiner_domain == "complex" else 1,
                                refine_steps, refine_resample,
                                max(refine_avg, 1))
        self.buckets = tuple(sorted(buckets))
        self.clip_samples = clip_samples
        self.sample_rate = sample_rate
        if self.R is not None and refiner_domain == "complex":
            self._infer = make_complex_refiner_infer_fn(
                self.G, self.R, cfg, steps=refine_steps, t_start=refine_t,
                noise_scale=refine_noise, guidance=refine_guidance,
                clamp_mode=refine_clamp, resample=refine_resample,
                refine_avg=refine_avg, refine_chunk=refine_chunk,
                complex_mag=complex_mag, self_cond=refine_selfcond, V=self.V)
        else:
            self._infer = make_infer_fn(
                [self.G, *self.ensemble], cfg, n_gl_iter=gl_iters,
                phase_aware=phase_aware, phase_init=phase_init,
                mag_sharpen=mag_sharpen, V=self.V, refiner=self.R,
                refine_steps=refine_steps, refine_t=refine_t,
                refine_noise=refine_noise, refine_guidance=refine_guidance,
                refine_clamp=refine_clamp, refine_resample=refine_resample,
                refine_avg=refine_avg, refine_chunk=refine_chunk,
                refine_mix=refine_mix, refine_selfcond=refine_selfcond)
        self.stats = ServiceStats()
        self._queue: list = []
        self._lock = threading.Lock()
        self._flush_timer = None
        self._max_queue = 0
        self._deadline_s: float | None = None

    # -- mask helpers ------------------------------------------------------

    def time_mask_from_seconds(
        self, batch: int, gap_start_s, gap_end_s
    ) -> np.ndarray:
        """Gap interval(s) in seconds → dense (B, image_frames) keep-mask.

        Scalars mark one gap; equal-length lists mark several.
        """
        starts = np.atleast_1d(gap_start_s)
        ends = np.atleast_1d(gap_end_s)
        if len(starts) != len(ends):
            raise ValueError("gap start/end lists must pair up")
        hop = self.cfg.stft.hop_length
        m = np.ones((batch, self.cfg.image_frames), np.float32)
        for s, e in zip(starts, ends):
            f0 = int(s * self.sample_rate / hop)
            f1 = int(np.ceil(e * self.sample_rate / hop)) + 1
            m[:, max(f0, 0) : min(f1, self.cfg.image_frames)] = 0.0
        return m

    # -- direct batched API ------------------------------------------------

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def inpaint(
        self,
        wavs: np.ndarray,
        masks: np.ndarray | None = None,
        gap_start_s: float | None = None,
        gap_end_s: float | None = None,
        frames: np.ndarray | None = None,
    ) -> np.ndarray:
        """(N, clip_samples) wavs (+ masks or a gap interval, + (N, T,
        H, W, 3) frames under cfg.use_video) → inpainted.

        N may be anything; internally processed in padded buckets
        (padding clips get zero frames).
        """
        wavs = np.asarray(wavs, np.float32)
        n = wavs.shape[0]
        if frames is not None:
            frames = np.asarray(frames, np.float32)
            if frames.shape[0] != n:
                raise ValueError(f"{frames.shape[0]} frame stacks for {n} "
                                 f"clips")
        if masks is None:
            if gap_start_s is None or gap_end_s is None:
                raise ValueError("provide either dense masks or a gap interval")
            masks = self.time_mask_from_seconds(n, gap_start_s, gap_end_s)
        masks = np.asarray(masks, np.float32)
        out = np.empty_like(wavs)
        i = 0
        while i < n:
            remaining = n - i
            bucket = self._bucket_for(remaining)
            take = min(remaining, bucket)
            w = wavs[i : i + take]
            m = masks[i : i + take]
            fr = frames[i : i + take] if frames is not None else None
            if take < bucket:
                padn = bucket - take
                w = np.concatenate([w, np.zeros((padn, w.shape[1]), w.dtype)])
                m = np.concatenate([m, np.ones((padn, m.shape[1]), m.dtype)])
                if fr is not None:
                    fr = np.concatenate(
                        [fr, np.zeros((padn, *fr.shape[1:]), fr.dtype)])
                self.stats.padded_clips += padn
            t0 = time.perf_counter()
            y = self._run(w, m, fr)         # waits for the device
            self.stats.total_s += time.perf_counter() - t0
            self.stats.batches += 1
            self.stats.clips += take
            out[i : i + take] = y[:take]
            i += take
        return out

    def _run(self, w: np.ndarray, m: np.ndarray,
             fr: np.ndarray | None) -> np.ndarray:
        """One padded bucket through the chain → host outputs; under a
        mesh, this rank's rows, then every rank's gathered."""
        def rows(a):
            return local_rows(torch.from_numpy(a), self.mesh).to(self.device)

        noise = None
        if self._noise_plan is not None:
            ch, steps, resample, k = self._noise_plan
            shape = (w.shape[0], ch, self.cfg.stft.n_bins,
                     self.cfg.image_frames)
            noise = []
            for s in range(k):
                nz = draw_noise(sample_generator(0, 0, s, self.device),
                                shape, steps, resample)
                noise.append(RefineNoise(
                    local_rows(nz.eps0, self.mesh),
                    None if nz.renoise is None
                    else local_rows(nz.renoise, self.mesh, dim=2)))
        y = self._infer(rows(w), rows(m), None if fr is None else rows(fr),
                        noise=noise)
        return all_gather_rows(y, self.mesh).cpu().numpy()

    # -- long audio: host-side chunking + overlap-add ---------------------

    def inpaint_long(
        self,
        wav: np.ndarray,
        gap_start_s: float,
        gap_end_s: float,
        overlap_s: float = 0.25,
    ) -> np.ndarray:
        """Arbitrary-length (T,) waveform with one corrupted interval →
        inpainted waveform of the same length.

        Service-sized windows with `overlap_s` crossfade; only windows
        intersecting the gap run through the model, then linear-crossfade
        stitching.
        """
        wav = np.asarray(wav, np.float32)
        T = len(wav)
        cs = self.clip_samples
        if T <= cs:
            padded = np.zeros(cs, np.float32)
            padded[:T] = wav
            out = self.inpaint(padded[None], gap_start_s=gap_start_s,
                               gap_end_s=gap_end_s)[0]
            return out[:T]
        ov = int(overlap_s * self.sample_rate)
        step = cs - ov
        starts = list(range(0, max(T - cs, 0) + 1, step))
        if starts[-1] + cs < T:
            starts.append(T - cs)
        g0, g1 = int(gap_start_s * self.sample_rate), int(
            np.ceil(gap_end_s * self.sample_rate))

        todo, masks = [], []
        for s in starts:
            if s < g1 and s + cs > g0:   # window intersects the gap
                local0 = max(g0 - s, 0) / self.sample_rate
                local1 = min(g1 - s, cs) / self.sample_rate
                todo.append(s)
                masks.append(self.time_mask_from_seconds(
                    1, local0, local1)[0])
        out = wav.copy()
        if todo:
            wins = np.stack([wav[s : s + cs] for s in todo])
            fixed = self.inpaint(wins, masks=np.stack(masks))
            # Crossfade each fixed window into the output.
            ramp = np.ones(cs, np.float32)
            ramp[:ov] = np.linspace(0.0, 1.0, ov, dtype=np.float32)
            ramp[-ov:] = np.linspace(1.0, 0.0, ov, dtype=np.float32)
            acc = np.zeros(T, np.float64)
            wsum = np.zeros(T, np.float64)
            for s, fw in zip(todo, fixed):
                acc[s : s + cs] += fw * ramp
                wsum[s : s + cs] += ramp
            blended = np.where(wsum > 0, acc / np.maximum(wsum, 1e-9), out)
            # Only replace inside the touched windows.
            touched = wsum > 0
            out[touched] = blended[touched].astype(np.float32)
        return out

    # -- streaming / micro-batching API -------------------------------------
    #
    # submit() returns a Future; the queue auto-flushes when it reaches
    # `max_queue` clips or `flush_deadline_s` after the FIRST queued
    # clip (timer thread). flush() stays callable for manual draining.

    def configure_streaming(self, max_queue: int = 0,
                            flush_deadline_s: float | None = None):
        """Enable auto-flush: by queue size, deadline, or both."""
        self._max_queue = max_queue
        self._deadline_s = flush_deadline_s
        return self

    def submit(self, wav: np.ndarray, mask: np.ndarray
               ) -> "concurrent.futures.Future[np.ndarray]":
        """Queue one clip → Future resolving to the inpainted waveform
        (audio only, as in the JAX package)."""
        fut: concurrent.futures.Future = concurrent.futures.Future()
        run_now = False
        with self._lock:
            self._queue.append(
                (np.asarray(wav, np.float32),
                 np.asarray(mask, np.float32), fut)
            )
            if self._deadline_s and self._flush_timer is None:
                self._flush_timer = threading.Timer(self._deadline_s,
                                                    self.flush)
                self._flush_timer.daemon = True
                self._flush_timer.start()
            if self._max_queue and len(self._queue) >= self._max_queue:
                run_now = True
        if run_now:
            self.flush()
        return fut

    def flush(self) -> list[np.ndarray]:
        with self._lock:
            items = self._queue
            self._queue = []
            if self._flush_timer is not None:
                self._flush_timer.cancel()
                self._flush_timer = None
        if not items:
            return []
        wavs = np.stack([w for w, _, _ in items])
        masks = np.stack([m for _, m, _ in items])
        try:
            out = self.inpaint(wavs, masks)
        except Exception as e:
            for _, _, fut in items:
                if not fut.done():
                    fut.set_exception(e)
            raise
        results = [out[i] for i in range(out.shape[0])]
        for (_, _, fut), r in zip(items, results):
            if not fut.done():
                fut.set_result(r)
        return results
