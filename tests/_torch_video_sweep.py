"""The port's MJPEG and MPEG-4 Part 2 decoders against cv2, the reading
behind the video reader's bounds (TOL in tests/test_torch_video_decode.py,
VIDEO_TOL in chip_smoke.py).

    python tests/_torch_video_sweep.py [streams [seed]]

prints, per codec, the largest |Δ| in levels of `native.decode_video`
against cv2's `cap.read()` over every frame of every committed clip in
tests/torch_videos/, then over `streams` (default 600) random MPEG-4
Part 2 streams: libavcodec 59's mpeg4 and libxvid encoders (through
`lavc_encode`) at random sizes (16..176 x 16..144, even), frame counts
(2..16), quantisers and tools (B-frames, quarter-pel, 4MV, GMC, AC
prediction, MPEG quantisation, video packets, data partitioning), each in
an AVI. Needs cv2 and the system's libavcodec 59, which the card's machine
does not have.
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import _torch_make_videos as mk  # noqa: E402
from viai_tpu_torch import native  # noqa: E402


def worst(path: str) -> int:
    ref = mk.cv2_view(path)[0]
    got = native.decode_video(path)
    if got.shape != ref.shape:
        raise AssertionError(f"{path}: {got.shape} against cv2's {ref.shape}")
    return int(np.abs(got.astype(int) - ref).max())


def random_options(rng) -> tuple[str, dict]:
    encoder = "libxvid" if rng.random() < 0.4 else "mpeg4"
    opts = {"qmin": int(rng.integers(2, 8)), "qmax": int(rng.integers(8, 31))}
    flags = [f for f in ("+qpel", "+mv4", "+aic") if rng.random() < 0.4]
    if encoder == "libxvid":
        flags = [f for f in flags if f != "+aic"]
        if rng.random() < 0.3:
            opts["gmc"] = 1
    else:
        if rng.random() < 0.3:
            opts["ps"] = int(rng.integers(100, 600))
        if rng.random() < 0.2:
            opts["data_partitioning"] = 1
            opts.setdefault("ps", 300)
    if flags:
        opts["flags"] = "".join(flags)
    if rng.random() < 0.5:
        opts["bf"] = int(rng.integers(1, 3))
    if rng.random() < 0.3:
        opts["mpeg_quant"] = 1
    return encoder, opts


def main(streams: int = 600, seed: int = 0):
    per = {}
    for npz in sorted(os.listdir(mk.FIXTURES)):
        if not npz.endswith(".npz"):
            continue
        name = npz[:-4]
        path = mk.path_of(name)
        codec = native.video_track(path, packets=False).codec
        per[codec] = max(per.get(codec, 0), worst(path))
    for name in (*mk.CLIP_CASES, *mk.PHONE_CLIPS):
        path = mk.path_of(name)
        codec = native.video_track(path, packets=False).codec
        per[codec] = max(per.get(codec, 0), worst(path))
    print("committed clips, max |Δ| per codec over every frame:", per)
    rng = np.random.default_rng(seed)
    top, failed = 0, 0
    with tempfile.TemporaryDirectory() as tmp:
        for k in range(streams):
            encoder, opts = random_options(rng)
            h = 2 * int(rng.integers(8, 73))
            w = 2 * int(rng.integers(8, 89))
            frames = mk.moving_frames(int(rng.integers(1 << 30)),
                                      int(rng.integers(2, 17)), h, w)
            try:
                packets = mk.lavc_encode(frames, encoder, **opts)
            except RuntimeError:
                failed += 1              # an option set the encoder refuses
                continue
            path = os.path.join(tmp, f"s{k}.avi")
            with open(path, "wb") as f:
                f.write(mk.avi_file(packets, w, h, 25, len(packets),
                                    b"XVID" if encoder == "libxvid"
                                    else b"DX50"))
            err = worst(path)
            if err:
                print(f"stream {k}: {encoder} {opts} {w}x{h}: max |Δ| {err}")
            top = max(top, err)
    print(f"{streams - failed} random MPEG-4 Part 2 streams (seed {seed}; "
          f"{failed} option sets refused): max |Δ| {top}")


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:]))
