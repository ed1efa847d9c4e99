"""Synthetic audio(+video) source — CI / bench / CPU-runnable config.

The port's own copy of `viai_tpu/data/synthetic.py` (numpy only, so it
is copied as it is: the same clips, bit for bit, for the same index).
Clips are deterministic functions of their index: harmonic stacks with
a random fundamental, AM/FM modulation, and (for the AV mode) frames
of a moving bright blob whose vertical position tracks the
instantaneous pitch — so vision genuinely carries information about
the audio, exercising the fusion path. The other styles: polyphonic
note events ("notes"), their deterministic beat-grid twin
("notes_grid"), and the vision-necessary corpus ("av_cue").
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class SyntheticConfig:
    sample_rate: int = 16000
    clip_seconds: float = 2.0
    n_harmonics: int = 4
    with_video: bool = False
    video_frames: int = 16
    video_size: int = 64
    # Mixed audio-visual batches [B:11]: fraction of clips whose video
    # is missing (frames zeroed, frames_valid=0).
    video_dropout: float = 0.0
    size: int = 10000   # virtual dataset length
    # "harmonic": one sustained AM/FM harmonic stack (round-1 corpus).
    # "notes": polyphonic plucked-note events — random onsets, chord
    #   pitches, exponentially decaying inharmonic partials, noise
    #   attack transients + a noise floor. Much harder inpainting:
    #   the hole can cover onsets/offsets, not just steady state
    #   (VERDICT.md round-1 missing #2: stress beyond sine mixtures).
    # "av_cue": VISION-NECESSARY corpus (round-2 VERDICT next-round
    #   #5): two instruments play outside a fixed hole; inside it
    #   exactly one continues, chosen at random. The dropout event is
    #   inset n_fft/2+hop from the hole edges so no OBSERVED STFT
    #   frame's window touches a cue-dependent sample — from audio
    #   alone the two continuations are exactly equally likely, and
    #   only the video (the silent instrument's blob vanishes during
    #   the gap) disambiguates. Train with mask fixed_start =
    #   AV_CUE_GAP[0], gap length pinned to AV_CUE_GAP width.
    # "notes_grid": the DETERMINISTIC twin of "notes" (round-3
    #   attribution corpus): onsets sit on a strict per-clip beat grid
    #   (period + offset observable from context) and pitches repeat a
    #   short arpeggio cycle, with one decay/inharmonicity per clip —
    #   every note inside a hole is fully inferable from the observed
    #   region. The score gap notes_grid − notes at matched training
    #   measures how much of the notes plateau is irreducible
    #   onset/pitch AMBIGUITY rather than model capacity (the
    #   --oracle_mag eval bounds phase; this bounds information).
    style: str = "harmonic"
    max_notes: int = 8

    @property
    def clip_samples(self) -> int:
        return int(self.sample_rate * self.clip_seconds)


# Just-intonation-ish interval set for chord pitches (style="notes").
_INTERVALS = np.array([1.0, 9 / 8, 5 / 4, 4 / 3, 3 / 2, 5 / 3, 15 / 8, 2.0])

# av_cue hole, in spectrogram frames (hop 128, image_frames 256):
# frames [103, 153) — a centered 50-frame (0.4 s) gap.
AV_CUE_GAP = (103, 153)
# Sample inset of the dropout event inside the hole: a frame at index f
# windows samples [f*hop - n_fft/2, f*hop + n_fft/2); with the default
# n_fft=510/hop=128 the last observed frame (102) sees up to sample
# 102*128+255. Insetting by n_fft/2 + hop = 383 samples guarantees no
# observed-frame window overlaps any cue-dependent sample.
AV_CUE_INSET = 510 // 2 + 128


def av_cue_dropout_span(sample_rate: int = 16000, hop: int = 128):
    """The cue-dependent sample interval [start, end) of av_cue clips."""
    return (AV_CUE_GAP[0] * hop + AV_CUE_INSET,
            AV_CUE_GAP[1] * hop - AV_CUE_INSET)


def _render_av_cue_clip(rng, cfg: SyntheticConfig, t: np.ndarray,
                        cue_override: int | None = None):
    """→ (wav, dict of per-instrument envelopes/pitches, cue).

    Two harmonic instruments A/B with independent AM envelopes; outside
    the dropout span both sound, inside only instrument `cue` continues
    (25 ms raised-cosine edges, entirely inside the span). The rng draw
    ORDER is fixed and cue is drawn LAST so cue_override reproduces the
    identical scene with the other continuation (pinned by test:
    audio-ambiguity = equality outside the span).
    """
    n = t.shape[0]
    f0a = rng.uniform(110.0, 330.0)
    ratio = rng.uniform(1.26, 1.78)
    f0b = f0a * ratio
    rate_a, rate_b = rng.uniform(0.5, 2.0, 2)
    ph_a, ph_b = rng.uniform(0.0, 2 * np.pi, 2)
    amps_a = rng.uniform(0.3, 1.0, cfg.n_harmonics) / np.arange(
        1, cfg.n_harmonics + 1)
    amps_b = rng.uniform(0.3, 1.0, cfg.n_harmonics) / np.arange(
        1, cfg.n_harmonics + 1)
    cue = int(rng.integers(0, 2))
    if cue_override is not None:
        cue = int(cue_override)

    def voice(f0, amps):
        w = np.zeros(n, np.float64)
        for h in range(1, cfg.n_harmonics + 1):
            w += amps[h - 1] * np.sin(2 * np.pi * h * f0 * t)
        return w

    env_a = 0.6 + 0.4 * np.sin(2 * np.pi * rate_a * t + ph_a)
    env_b = 0.6 + 0.4 * np.sin(2 * np.pi * rate_b * t + ph_b)
    wa = voice(f0a, amps_a) * env_a
    wb = voice(f0b, amps_b) * env_b

    s0, s1 = av_cue_dropout_span(cfg.sample_rate)
    fade = int(0.025 * cfg.sample_rate)          # 25 ms edges
    # gate: 1 outside the span, 0 inside, raised-cosine edges INSIDE it.
    gate = np.ones(n)
    idx = np.arange(n)
    ramp_in = 0.5 * (1 + np.cos(np.pi * (idx - s0) / fade))
    ramp_out = 0.5 * (1 - np.cos(np.pi * (idx - (s1 - fade)) / fade))
    gate = np.where((idx >= s0) & (idx < s0 + fade), ramp_in, gate)
    gate = np.where((idx >= s0 + fade) & (idx < s1 - fade), 0.0, gate)
    gate = np.where((idx >= s1 - fade) & (idx < s1), ramp_out, gate)
    keep_a = gate if cue == 1 else np.ones(n)    # cue=0 → A continues
    keep_b = gate if cue == 0 else np.ones(n)
    wav = (wa * keep_a + wb * keep_b).astype(np.float32)
    # FIXED normalization (scene-level, cue-independent): per-max would
    # leak the cue into the observed region's amplitude.
    wav *= np.float32(0.5 / 2.4)                 # max |wa+wb| ≤ ~2.4
    scene = {"f0a": f0a, "f0b": f0b, "env_a": env_a, "env_b": env_b,
             "gate": gate, "s0": s0, "s1": s1}
    return wav, scene, cue


def _render_av_cue_video(cfg: SyntheticConfig, scene, cue, n):
    """Two blobs (A left, B right), y = log-pitch, brightness = AM
    envelope; during the dropout span the silent blob goes dark."""
    T, S = cfg.video_frames, cfg.video_size
    fidx = np.linspace(0, n - 1, T).astype(int)
    in_gap = (fidx >= scene["s0"]) & (fidx < scene["s1"])
    yy, xx = np.mgrid[0:S, 0:S]
    frames = np.zeros((T, S, S, 3), np.float32)
    for inst, (f0, env, xpos) in enumerate(
            [(scene["f0a"], scene["env_a"], S // 4),
             (scene["f0b"], scene["env_b"], 3 * S // 4)]):
        y = np.clip(np.log2(f0 / 110.0) / 2.5 * (S - 8), 0, S - 8)
        bright = env[fidx].copy()
        bright[in_gap & (inst != cue)] = 0.0     # silent blob vanishes
        blob = np.exp(-(((yy - y) ** 2
                         + (xx - xpos) ** 2) / 18.0))[None]  # (1,S,S)
        frames[..., 0] += blob * np.where(
            in_gap & (inst != cue), 0.0, 1.0)[:, None, None]
        frames[..., 1] += blob * bright[:, None, None]
    frames[..., 2] = 0.2
    return {"frames": np.clip(frames, 0.0, 1.0),
            "frames_valid": np.float32(1.0)}


def _draw_notes(rng, cfg: SyntheticConfig):
    """Per-clip note-event parameters (single rng stream, fixed order)."""
    K = cfg.max_notes
    n_notes = int(rng.integers(3, K + 1))
    root = rng.uniform(110.0, 440.0)
    onset = rng.uniform(0.0, 0.85 * cfg.clip_seconds, K)
    f0 = root * _INTERVALS[rng.integers(0, len(_INTERVALS), K)] * (
        2.0 ** rng.integers(-1, 2, K))
    decay = rng.uniform(1.5, 8.0, K)           # 1/s amplitude decay
    amp = rng.uniform(0.2, 1.0, K)
    inharm = rng.uniform(0.0, 1e-3, K)         # stiffness coefficient
    noise_amp = rng.uniform(0.0, 0.02)
    amp[n_notes:] = 0.0
    return onset, f0, decay, amp, inharm, noise_amp


def _draw_notes_grid(rng, cfg: SyntheticConfig):
    """Deterministic-structure twin of _draw_notes (style="notes_grid").

    One beat grid per clip (period ~U(0.18,0.30) s, random offset), a
    repeating 3-5-pitch arpeggio cycle, a single decay/inharmonicity
    shared by every note and per-SLOT amplitudes — so the notes inside
    any hole are exactly the continuation of the observed pattern.
    Returns the same tuple shape as _draw_notes; K = #grid ticks.
    """
    period = rng.uniform(0.18, 0.30)
    offset = rng.uniform(0.0, period)
    cycle = int(rng.integers(3, 6))
    root = rng.uniform(110.0, 330.0)
    slot_f0 = root * _INTERVALS[rng.integers(0, len(_INTERVALS), cycle)] * (
        2.0 ** rng.integers(-1, 2, cycle))
    slot_amp = rng.uniform(0.4, 1.0, cycle)
    decay = rng.uniform(2.0, 5.0)
    inharm = rng.uniform(0.0, 1e-3)
    noise_amp = rng.uniform(0.0, 0.02)
    onset = offset + period * np.arange(
        int((0.98 * cfg.clip_seconds - offset) / period) + 1)
    K = onset.shape[0]
    slots = np.arange(K) % cycle
    return (onset, slot_f0[slots], np.full(K, decay), slot_amp[slots],
            np.full(K, inharm), noise_amp)


def render_note_events(params, noise: np.ndarray, t: np.ndarray,
                       n_harmonics: int) -> np.ndarray:
    """Pure renderer: note parameters + noise stream → UNNORMALIZED wav.

    params = (onset, f0, decay, amp, inharm, noise_amp) as produced by
    _draw_notes/_draw_notes_grid. Split out of _render_notes_clip so
    analysis tooling (scripts/bayes_ceiling.py) can re-render posterior-
    equivalent parameter sets against a fixed context; consumes no rng.
    """
    onset, f0, decay, amp, inharm, noise_amp = params
    tt = t[None, :] - onset[:, None]                # (K, n)
    gate = tt >= 0.0
    ttc = np.where(gate, tt, 0.0)
    ang = 2 * np.pi * f0[:, None] * ttc
    z = np.exp(-decay[:, None] * ttc) * (np.cos(ang) + 1j * np.sin(ang))
    per_note = np.zeros_like(ttc)
    zh = np.ones_like(z)
    for h in range(1, n_harmonics + 1):
        zh = zh * z
        detune = ang * inharm[:, None] * (h * h - h)
        per_note += (1.0 / h) * (
            zh.imag * np.cos(detune) + zh.real * np.sin(detune)
        )
    per_note *= amp[:, None] * gate
    per_note += 0.3 * amp[:, None] * (gate & (ttc < 0.005)) * noise[None, :]
    return per_note.sum(axis=0) + noise_amp * noise


def _render_notes_clip(rng, cfg: SyntheticConfig, t: np.ndarray):
    """One polyphonic clip → (wav float32 (n,), inst_f (n,) dominant Hz).

    Per-note complex-power trick: partial h of a note is Im(z^h) with
    z = e^{-λt} e^{i2πf₀t}, so each note costs one exp + one sincos
    regardless of harmonic count; a mild quadratic detune adds
    piano-like inharmonicity. Attack = 5 ms noise burst per onset.
    `inst_f` tracks the loudest currently-sounding note (drives the AV
    blob so vision stays informative in 'notes' style).
    """
    draw = _draw_notes_grid if cfg.style == "notes_grid" else _draw_notes
    params = draw(rng, cfg)
    onset, f0, decay, amp, inharm, noise_amp = params
    noise = rng.standard_normal(t.shape[0])         # drawn ONCE, fixed order
    wav = render_note_events(params, noise, t, cfg.n_harmonics)
    wav = wav.astype(np.float32)
    wav *= 0.5 / max(np.abs(wav).max(), 1e-6)
    tt = t[None, :] - onset[:, None]                # (K, n)
    gate = tt >= 0.0
    ttc = np.where(gate, tt, 0.0)
    # Dominant pitch = f0 of the loudest live note (envelope-weighted).
    live_env = amp[:, None] * np.where(gate, np.exp(-decay[:, None] * ttc),
                                       0.0)
    dom = np.argmax(live_env, axis=0)
    inst_f = f0[dom].astype(np.float64)
    inst_f[live_env.max(axis=0) < 1e-4] = f0[0]
    return wav, inst_f


class SyntheticBatchIterator:
    """Vectorized, background-threaded batch generator: the waveform
    and blob math runs over the whole batch in one worker thread that
    keeps `depth` batches ready ahead of the train loop. Item VALUES
    are identical to SyntheticAVDataset[idx] (same per-index rng draw
    order)."""

    def __init__(self, cfg: SyntheticConfig, batch: int, seed: int = 0,
                 depth: int = 2):
        import queue
        import threading

        self.cfg = cfg
        self.batch = batch
        self.epoch_batches = max(cfg.size // batch, 1)
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._idx = seed * cfg.size  # distinct streams per seed
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    # -- vectorized generation (values == SyntheticAVDataset) -------------
    def _gen(self, idx0: int) -> dict:
        cfg, B = self.cfg, self.batch
        if cfg.style in ("notes", "notes_grid", "av_cue"):
            # These styles render per clip, in this worker thread.
            ds = SyntheticAVDataset(cfg)
            items = [ds[idx0 + b] for b in range(B)]
            out = {"wav": np.stack([it["wav"] for it in items])}
            if cfg.with_video:
                out["frames"] = np.stack([it["frames"] for it in items])
                out["frames_valid"] = np.stack(
                    [it["frames_valid"] for it in items])
            return out
        n, H = cfg.clip_samples, cfg.n_harmonics
        f0 = np.empty(B)
        vib = np.empty(B)
        vib_depth = np.empty(B)
        amps = np.empty((B, H))
        env_f = np.empty(B)
        has_video = np.ones(B, bool)
        for b in range(B):
            rng = np.random.default_rng((0xA11D10, int(idx0 + b)))
            f0[b] = rng.uniform(110.0, 880.0)
            vib[b] = rng.uniform(0.0, 6.0)
            vib_depth[b] = rng.uniform(0.0, 0.02)
            for h in range(1, H + 1):
                amps[b, h - 1] = rng.uniform(0.1, 1.0) / h
            env_f[b] = rng.uniform(0.3, 2.0)
            if cfg.with_video:
                has_video[b] = rng.uniform() >= cfg.video_dropout
        t = np.arange(n) / cfg.sample_rate
        inst_f = f0[:, None] * (
            1.0 + vib_depth[:, None] * np.sin(2 * np.pi * vib[:, None] * t)
        )
        phase = 2 * np.pi * np.cumsum(inst_f, axis=1) / cfg.sample_rate
        wav = np.zeros((B, n), np.float64)
        for h in range(1, H + 1):
            wav += amps[:, h - 1 : h] * np.sin(h * phase)
        env = 0.5 + 0.5 * np.sin(2 * np.pi * env_f[:, None] * t)
        wav = (wav * env).astype(np.float32)
        wav *= (0.5 / np.maximum(np.abs(wav).max(axis=1, keepdims=True),
                                 1e-6)).astype(np.float32)
        item = {"wav": wav}
        if cfg.with_video:
            T, S = cfg.video_frames, cfg.video_size
            fidx = np.linspace(0, n - 1, T).astype(int)
            y = (np.log2(inst_f[:, fidx] / 110.0) / 3.0 * (S - 8)).clip(
                0, S - 8)                                     # (B, T)
            x = (env[:, fidx] * (S - 8)).clip(0, S - 8)
            yy, xx = np.mgrid[0:S, 0:S]
            d2 = ((yy[None, None] - y[..., None, None]) ** 2
                  + (xx[None, None] - x[..., None, None]) ** 2)
            blob = np.exp(-(d2 / 18.0)).astype(np.float32)    # (B, T, S, S)
            frames = np.zeros((B, T, S, S, 3), np.float32)
            frames[..., 0] = blob
            frames[..., 1] = blob * env[:, fidx, None, None]
            frames[..., 2] = 0.2
            frames[~has_video] = 0.0
            item["frames"] = frames
            item["frames_valid"] = has_video.astype(np.float32)
        return item

    def _worker(self):
        import queue

        while not self._stop.is_set():
            batch = self._gen(self._idx)
            self._idx += self.batch
            while not self._stop.is_set():
                try:
                    self._q.put(batch, timeout=0.2)
                    break
                except queue.Full:
                    continue

    def __iter__(self):
        return self

    def __next__(self):
        return self._q.get()

    def close(self):
        import queue

        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join()


def _amp_envelope(wav: np.ndarray, win: int = 512) -> np.ndarray:
    """Box-filtered |wav| scaled to [0, 1] (blob x-drive, rng-free)."""
    c = np.cumsum(np.abs(wav, dtype=np.float64))
    env = (c - np.concatenate([np.zeros(win), c[:-win]])) / win
    return (env / max(env.max(), 1e-9)).astype(np.float64)


def _render_video(rng, cfg: SyntheticConfig, inst_f, env, n) -> dict:
    """Pitch-tracking blob frames (shared by both synth styles)."""
    has_video = rng.uniform() >= cfg.video_dropout
    T, S = cfg.video_frames, cfg.video_size
    frames = np.zeros((T, S, S, 3), np.float32)
    # Blob y-position tracks log-pitch; x sweeps with the envelope.
    fidx = (np.linspace(0, n - 1, T)).astype(int)
    y = (np.log2(inst_f[fidx] / 110.0) / 3.0 * (S - 8)).clip(0, S - 8)
    x = (env[fidx] * (S - 8)).clip(0, S - 8)
    yy, xx = np.mgrid[0:S, 0:S]
    for k in range(T):
        blob = np.exp(-(((yy - y[k]) ** 2 + (xx - x[k]) ** 2) / 18.0))
        frames[k, :, :, 0] = blob
        frames[k, :, :, 1] = blob * env[fidx[k]]
        frames[k, :, :, 2] = 0.2
    if not has_video:
        frames[:] = 0.0
    return {"frames": frames,
            "frames_valid": np.float32(1.0 if has_video else 0.0)}


class SyntheticAVDataset:
    """Deterministic random-access source: idx → {'wav', 'frames'?}."""

    def __init__(self, cfg: SyntheticConfig = SyntheticConfig()):
        self.cfg = cfg

    def __len__(self):
        return self.cfg.size

    def __getitem__(self, idx: int):
        cfg = self.cfg
        rng = np.random.default_rng((0xA11D10, int(idx)))
        n = cfg.clip_samples
        t = np.arange(n) / cfg.sample_rate
        if cfg.style == "av_cue":
            wav, scene, cue = _render_av_cue_clip(rng, cfg, t)
            item = {"wav": wav}
            if cfg.with_video:
                item.update(_render_av_cue_video(cfg, scene, cue, n))
            return item
        if cfg.style in ("notes", "notes_grid"):
            wav, inst_f = _render_notes_clip(rng, cfg, t)
            env = _amp_envelope(wav)
            item = {"wav": wav}
            if cfg.with_video:
                item.update(_render_video(rng, cfg, inst_f, env, n))
            return item
        f0 = rng.uniform(110.0, 880.0)
        vib = rng.uniform(0.0, 6.0)          # vibrato Hz
        vib_depth = rng.uniform(0.0, 0.02)
        inst_f = f0 * (1.0 + vib_depth * np.sin(2 * np.pi * vib * t))
        phase = 2 * np.pi * np.cumsum(inst_f) / cfg.sample_rate
        wav = np.zeros(n, np.float64)
        for h in range(1, cfg.n_harmonics + 1):
            amp = rng.uniform(0.1, 1.0) / h
            wav += amp * np.sin(h * phase)
        env = 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(0.3, 2.0) * t)
        wav = (wav * env).astype(np.float32)
        wav *= 0.5 / max(np.abs(wav).max(), 1e-6)
        item = {"wav": wav}
        if cfg.with_video:
            item.update(_render_video(rng, cfg, inst_f, env, n))
        return item
