"""Observability — loss logging and HTML result galleries.

The port's own copy of `viai_tpu/utils/visualizer.py` (numpy only):
losses to stdout, loss_log.txt and loss_log.jsonl; the current
spectrogram images to a static web/ page; and a gallery writer with
spectrogram PNGs and wav files. PNGs are encoded with the standard
library (zlib), so the port needs no imaging package. With
`tensorboard=True` the losses also go to TensorBoard event files under
expr_dir/tb, one global step per print_current_losses call, written by
the port's own writer (utils/tensorboard.py); a write error raises.
"""

from __future__ import annotations

import json
import os
import struct
import time
import wave as wave_mod
import zlib

import numpy as np

from .tensorboard import SummaryWriter


class Visualizer:
    """print_current_losses → stdout + loss_log.txt + loss_log.jsonl."""

    def __init__(self, expr_dir: str, name: str = "experiment",
                 tensorboard: bool = False):
        self.expr_dir = expr_dir
        self.name = name
        os.makedirs(expr_dir, exist_ok=True)
        self.log_path = os.path.join(expr_dir, "loss_log.txt")
        self.jsonl_path = os.path.join(expr_dir, "loss_log.jsonl")
        with open(self.log_path, "a") as f:
            f.write(
                f"================ Training Loss ({time.strftime('%c')}) "
                "================\n"
            )
        self._tb = (SummaryWriter(os.path.join(expr_dir, "tb"))
                    if tensorboard else None)
        self._global_step = 0

    def display_current_results(self, visuals: dict, epoch: int):
        """Reference Visualizer API: write current spectrogram images to
        the experiment's web/ page (visdom replaced by static HTML)."""
        web_dir = os.path.join(self.expr_dir, "web")
        img_dir = os.path.join(web_dir, "images")
        os.makedirs(img_dir, exist_ok=True)
        for label, img in visuals.items():
            spec_to_png(
                np.asarray(img),
                os.path.join(img_dir, f"epoch{epoch:03d}_{label}.png"),
            )
        # Rebuild a simple latest-first index.
        rows = sorted(
            {f.split("_")[0] for f in os.listdir(img_dir)}, reverse=True
        )
        labels = sorted({f.split("_", 1)[1] for f in os.listdir(img_dir)})
        parts = [
            "<!doctype html><html><head><meta charset='utf-8'>",
            f"<title>{self.name}</title></head><body "
            "style='background:#111;color:#eee;font-family:sans-serif'>",
            f"<h1>{self.name}</h1>",
        ]
        for r in rows:
            parts.append(f"<h3>{r}</h3>")
            for lb in labels:
                if os.path.exists(os.path.join(img_dir, f"{r}_{lb}")):
                    parts.append(
                        f"<img src='images/{r}_{lb}' width=256 "
                        f"title='{lb}'> "
                    )
        parts.append("</body></html>")
        with open(os.path.join(web_dir, "index.html"), "w") as f:
            f.write("\n".join(parts))

    def print_current_losses(self, epoch, iters, losses: dict, t_step=None):
        msg = f"(epoch: {epoch}, iters: {iters}"
        if t_step is not None:
            msg += f", time: {t_step:.3f}s"
        msg += ") " + " ".join(f"{k}: {v:.4f}" for k, v in losses.items())
        print(msg, flush=True)
        with open(self.log_path, "a") as f:
            f.write(msg + "\n")
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps(
                {"epoch": epoch, "iters": iters, "t": time.time(), **{
                    k: float(v) for k, v in losses.items()}}
            ) + "\n")
        if self._tb is not None:
            self._global_step += 1
            self._tb.write_scalars(
                self._global_step, {k: float(v) for k, v in losses.items()})


def _png_bytes(rgb: np.ndarray) -> bytes:
    """(H, W, 3) uint8 → an 8-bit RGB PNG file's bytes."""
    h, w, _ = rgb.shape
    raw = b"".join(b"\x00" + rgb[r].tobytes() for r in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        body = tag + data
        return (struct.pack(">I", len(data)) + body
                + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6))
            + chunk(b"IEND", b""))


def spec_to_png(spec01: np.ndarray, path: str):
    """(H, W) array scaled to [0, 1] → magma-ish PNG."""
    x = np.clip(spec01, 0.0, 1.0)
    # Simple perceptual ramp: dark purple → orange → light yellow.
    r = np.clip(x * 3.0, 0, 1)
    g = np.clip(x * 3.0 - 1.0, 0, 1)
    b = np.clip(1.2 * (1.0 - np.abs(x - 0.25) * 3.0), 0, 1) * 0.6 + x * 0.4
    img = np.stack([r, g, b], -1)
    # Flip so low frequencies render at the bottom.
    img = np.ascontiguousarray((img[::-1] * 255).astype(np.uint8))
    with open(path, "wb") as f:
        f.write(_png_bytes(img))


def write_wav(path: str, wav: np.ndarray, sr: int = 16000):
    x = np.clip(wav, -1.0, 1.0)
    pcm = (x * 32767.0).astype("<i2")
    with wave_mod.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


class HTMLGallery:
    """Reference-style results page: one row per clip with images + wavs."""

    def __init__(self, results_dir: str, title: str):
        self.dir = results_dir
        self.img_dir = os.path.join(results_dir, "images")
        os.makedirs(self.img_dir, exist_ok=True)
        self.title = title
        self.rows: list[dict] = []

    def add_result(self, idx: int, specs: dict[str, np.ndarray],
                   wavs: dict[str, np.ndarray], metrics: dict | None = None,
                   sr: int = 16000):
        """specs: label → (H, W) in [0,1]; wavs: label → (T,) float."""
        row = {"idx": idx, "imgs": [], "wavs": [], "metrics": metrics or {}}
        for label, spec in specs.items():
            fn = f"{idx:05d}_{label}.png"
            spec_to_png(spec, os.path.join(self.img_dir, fn))
            row["imgs"].append((label, f"images/{fn}"))
        for label, wav in wavs.items():
            fn = f"{idx:05d}_{label}.wav"
            write_wav(os.path.join(self.img_dir, fn), wav, sr)
            row["wavs"].append((label, f"images/{fn}"))
        self.rows.append(row)

    def save(self):
        parts = [
            "<!doctype html><html><head><meta charset='utf-8'>",
            f"<title>{self.title}</title>",
            "<style>body{font-family:sans-serif;background:#111;color:#eee}"
            "td{padding:6px;text-align:center}img{image-rendering:pixelated;"
            "width:256px}audio{width:256px}</style></head><body>",
            f"<h1>{self.title}</h1><table>",
        ]
        for row in self.rows:
            parts.append("<tr>")
            for label, src in row["imgs"]:
                parts.append(
                    f"<td><img src='{src}'><br>{label}</td>"
                )
            parts.append("</tr><tr>")
            for label, src in row["wavs"]:
                parts.append(
                    f"<td><audio controls src='{src}'></audio><br>{label}</td>"
                )
            m = ", ".join(f"{k}={v:.2f}" for k, v in row["metrics"].items())
            parts.append(f"</tr><tr><td colspan=9 style='color:#9cf'>"
                         f"clip {row['idx']} — {m}</td></tr>")
        parts.append("</table></body></html>")
        path = os.path.join(self.dir, "index.html")
        with open(path, "w") as f:
            f.write("\n".join(parts))
        return path
