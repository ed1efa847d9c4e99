"""Dataset preparation — the reference's download and trim scripts,
rebuilt.

Port of `scripts/prepare_dataset.py`, with its modes and flags:

  download  — the yt-dlp (+ ffmpeg trim) plan of a MUSICES-style
              YouTube-ID manifest (download_commands); --dry_run prints
              it, otherwise each command runs and missing tools are
              named before any runs;
  extract   — video files → 16 kHz mono wav + (T, H, W, 3) uint8 frame
              stack .npy per clip, from uncompressed AVI (data/avi.py:
              RGBA-32 or BI_RGB-24 video, PCM16 audio), frames through
              data/av.py::resample_frames, audio through the native
              resampler;
  audio     — a tree of wav files → 16 kHz mono wavs;
  frames    — per-clip frame stacks <stem>.npy beside uncompressed AVIs;
  manifest  — a MUSICES.json-style manifest of a prepared tree;
  synthetic — N synthetic wav clips (+ frame stacks) for demos.

Compressed containers (.mp4, .mkv, .webm, .mov, compressed .avi), which
the JAX package decodes with cv2, are not read by the port: extract and
frames list such clips as skipped with the reason, and extract
--require_audio then exits 1. Each mode appends one record to
{--results_dir}/quality_results.jsonl. The work is on the host (numpy
and the native library), as in the JAX script.

    python -m viai_tpu_torch.scripts.prepare_dataset extract \\
        --root raw_videos --out data
    python -m viai_tpu_torch.scripts.prepare_dataset manifest --root data
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import struct
import subprocess
import sys
import time

import numpy as np

from .. import native
from ..data.audio import load_wav
from ..data.av import resample_frames
from ..data.avi import read_avi
from ..data.synthetic import SyntheticAVDataset, SyntheticConfig
from ..io.results import append_record
from ..utils.visualizer import write_wav

VIDEO_EXTS = (".avi", ".mp4", ".mkv", ".webm", ".mov")


def _raw_avi(path: str):
    """(frames uint8 (T, H, W, 3), audio float32 or None, sample rate)
    of an uncompressed AVI, or the reason the port cannot read `path`."""
    if not path.lower().endswith(".avi"):
        return (f"compressed video ({os.path.splitext(path)[1]}) is not "
                f"read by viai_tpu_torch (the JAX package decodes it with "
                f"cv2); convert it to an uncompressed AVI with PCM16 audio")
    try:
        frames, _fps, audio, sr = read_avi(path)
    except (ValueError, struct.error) as e:
        return (f"not an uncompressed AVI that viai_tpu_torch reads "
                f"({e}); convert it to RGBA-32 or BI_RGB-24 video with "
                f"PCM16 audio")
    return frames, audio, sr


def _to_uint8(frames: np.ndarray, n_frames: int, size: int) -> np.ndarray:
    return (resample_frames(frames, n_frames, size) * 255).astype(np.uint8)


def cmd_synthetic(args) -> dict:
    cfg = SyntheticConfig(with_video=args.video, video_frames=args.n_frames,
                          video_size=args.frame_size)
    ds = SyntheticAVDataset(cfg)
    os.makedirs(args.out, exist_ok=True)
    for i in range(args.n):
        item = ds[i]
        stem = os.path.join(args.out, f"clip{i:05d}")
        write_wav(stem + ".wav", item["wav"], cfg.sample_rate)
        if args.video:
            np.save(stem + ".npy",
                    (item["frames"] * 255).astype(np.uint8))
    print(f"wrote {args.n} clips to {args.out}")
    return {"clips": args.n, "video": args.video}


def cmd_audio(args) -> dict:
    os.makedirs(args.out, exist_ok=True)
    n = 0
    for dirpath, _, files in os.walk(args.root):
        for f in sorted(files):
            if not f.lower().endswith((".wav", ".wave")):
                continue
            wav = load_wav(os.path.join(dirpath, f), args.sample_rate)
            write_wav(os.path.join(args.out, f"{n:05d}.wav"), wav,
                      args.sample_rate)
            n += 1
    print(f"resampled {n} files to {args.out}")
    return {"clips": n}


def _report_skipped(skipped: list[tuple[str, str]]):
    for p, why in skipped:
        print(f"  skipped {p}: {why}")


def cmd_frames(args) -> dict:
    n, skipped = 0, []
    for dirpath, _, files in os.walk(args.root):
        for f in sorted(files):
            if not f.lower().endswith(VIDEO_EXTS):
                continue
            path = os.path.join(dirpath, f)
            got = _raw_avi(path)
            if isinstance(got, str):
                skipped.append((path, got))
                continue
            np.save(os.path.splitext(path)[0] + ".npy",
                    _to_uint8(got[0], args.n_frames, args.frame_size))
            n += 1
    print(f"extracted frames for {n} videos, {len(skipped)} skipped")
    _report_skipped(skipped)
    return {"clips": n, "skipped": len(skipped)}


def cmd_extract(args) -> dict:
    """Video tree → dataroot: per clip a wav at --sample_rate and a
    (T, H, W, 3) uint8 .npy. A clip without a PCM stream gets frames
    only, unless --require_audio (then it is skipped and the run exits
    1)."""
    os.makedirs(args.out, exist_ok=True)
    n_full, n_frames_only, skipped = 0, 0, []
    for dirpath, _, files in os.walk(args.root):
        for f in sorted(files):
            if not f.lower().endswith(VIDEO_EXTS):
                continue
            path = os.path.join(dirpath, f)
            stem = os.path.join(args.out, os.path.splitext(f)[0])
            got = _raw_avi(path)
            if isinstance(got, str):
                skipped.append((path, got))
                continue
            frames, audio, sr = got
            if audio is None and args.require_audio:
                skipped.append((path, "no PCM audio stream"))
                continue
            np.save(stem + ".npy",
                    _to_uint8(frames, args.n_frames, args.frame_size))
            if audio is None:
                n_frames_only += 1
                continue
            if sr != args.sample_rate:
                audio = native.resample_linear(audio, sr, args.sample_rate)
            write_wav(stem + ".wav", audio, args.sample_rate)
            n_full += 1
    print(f"extracted {n_full} clips (audio+frames), "
          f"{n_frames_only} frames-only, {len(skipped)} skipped")
    _report_skipped(skipped)
    return {"clips": n_full, "frames_only": n_frames_only,
            "skipped": len(skipped)}


def download_commands(manifest: dict | list, out: str,
                      fmt: str = "mp4") -> list[list[str]]:
    """YouTube-ID manifest → the yt-dlp (+ ffmpeg trim) command lines.

    Accepts the MUSICES layouts: a flat list or {"train": [...], "val":
    [...], "test": [...]}, each entry "VIDEO_ID" or {"id" (or "ytid",
    "video_id"): ..., "start": s, "end": s}."""
    entries = []
    if isinstance(manifest, dict):
        for split in ("train", "val", "test"):
            entries += list(manifest.get(split, []))
    else:
        entries = list(manifest)
    cmds = []
    for e in entries:
        if isinstance(e, str):
            vid, start, end = e, None, None
        else:
            vid = e.get("id") or e.get("ytid") or e.get("video_id")
            if vid is None:
                continue
            start, end = e.get("start"), e.get("end")
        dst = os.path.join(out, f"{vid}.{fmt}")
        cmds.append(["yt-dlp", "-f", f"bestvideo[ext={fmt}]+bestaudio/best",
                     "--merge-output-format", fmt, "-o", dst,
                     f"https://www.youtube.com/watch?v={vid}"])
        if start is not None and end is not None:
            trimmed = os.path.join(out, f"{vid}_trim.{fmt}")
            cmds.append(["ffmpeg", "-y", "-i", dst, "-ss", str(start),
                         "-to", str(end), "-c", "copy", trimmed])
    return cmds


def cmd_download(args) -> dict:
    """Print (--dry_run) or run the download plan of a manifest; exit
    naming the missing tools before running any."""
    with open(args.manifest) as f:
        manifest = json.load(f)
    os.makedirs(args.out, exist_ok=True)
    cmds = download_commands(manifest, args.out, fmt=args.format)
    if args.dry_run:
        for c in cmds:
            print(" ".join(c))
        print(f"# {len(cmds)} commands (dry run)")
        return {"commands": len(cmds), "dry_run": True}
    missing = {c[0] for c in cmds if shutil.which(c[0]) is None}
    if missing:
        sys.exit(f"missing tools: {', '.join(sorted(missing))} — install "
                 f"yt-dlp/ffmpeg or use --dry_run to export the plan")
    failures = sum(subprocess.run(c).returncode != 0 for c in cmds)
    print(f"{len(cmds) - failures}/{len(cmds)} commands succeeded")
    if failures:
        sys.exit(1)
    return {"commands": len(cmds), "dry_run": False}


def cmd_manifest(args) -> dict:
    entries = []
    for dirpath, _, files in os.walk(args.root):
        for f in sorted(files):
            if not f.lower().endswith(".wav"):
                continue
            wav = os.path.relpath(os.path.join(dirpath, f), args.root)
            stem = os.path.splitext(os.path.join(dirpath, f))[0]
            e = {"audio": wav}
            if os.path.exists(stem + ".npy"):
                e["frames"] = os.path.relpath(stem + ".npy", args.root)
            entries.append(e)
    k = max(int(len(entries) * args.train_frac), 1)
    manifest = {"train": entries[:k], "test": entries[k:] or entries[:1]}
    out = args.out or os.path.join(args.root, "MUSICES.json")
    with open(out, "w") as f:
        json.dump(manifest, f, indent=1)
    print(f"{len(manifest['train'])} train / {len(manifest['test'])} test "
          f"clips → {out}")
    return {"train": len(manifest["train"]), "test": len(manifest["test"])}


COMMANDS = {"synthetic": cmd_synthetic, "audio": cmd_audio,
            "frames": cmd_frames, "manifest": cmd_manifest,
            "extract": cmd_extract, "download": cmd_download}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--results_dir", type=str, default="results/")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("synthetic", parents=[common])
    p.add_argument("--out", required=True)
    p.add_argument("-n", type=int, default=64)
    p.add_argument("--video", action="store_true")
    p.add_argument("--n_frames", type=int, default=16)
    p.add_argument("--frame_size", type=int, default=64)
    p = sub.add_parser("audio", parents=[common])
    p.add_argument("--root", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--sample_rate", type=int, default=16000)
    p = sub.add_parser("frames", parents=[common])
    p.add_argument("--root", required=True)
    p.add_argument("--n_frames", type=int, default=16)
    p.add_argument("--frame_size", type=int, default=64)
    p = sub.add_parser("manifest", parents=[common])
    p.add_argument("--root", required=True)
    p.add_argument("--out", default=None)
    p.add_argument("--train_frac", type=float, default=0.9)
    p = sub.add_parser("download", parents=[common])
    p.add_argument("--manifest", required=True,
                   help="MUSICES.json-style YouTube-ID manifest")
    p.add_argument("--out", required=True)
    p.add_argument("--format", default="mp4")
    p.add_argument("--dry_run", action="store_true",
                   help="print the yt-dlp/ffmpeg command plan only")
    p = sub.add_parser("extract", parents=[common])
    p.add_argument("--root", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--sample_rate", type=int, default=16000)
    p.add_argument("--n_frames", type=int, default=16)
    p.add_argument("--frame_size", type=int, default=64)
    p.add_argument("--require_audio", action="store_true",
                   help="skip, and exit 1 for, clips whose audio the "
                        "port cannot extract")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    counts = COMMANDS[args.cmd](args)
    rec = {"exp": "prepare_dataset", "mode": args.cmd, **counts,
           "package": "viai_tpu_torch", "t": time.time()}
    append_record(rec, args.results_dir)
    if counts.get("skipped") and getattr(args, "require_audio", False):
        sys.exit(1)
    return rec


if __name__ == "__main__":
    main()
