"""Images for the port's JPEG/PNG decoder, and the fixtures made of them.

    python tests/_torch_make_frames.py

writes `tests/torch_frames/` (needs PIL, which the card's machine does
not have, so the fixtures are committed):
  * `<case>.jpg` / `<case>.png`: every case of JPEG_CASES and PNG_CASES,
    drawn from a seed, and `<case>.npy`, PIL's decode of it
    (`Image.open(f).convert("RGB")`, (H, W, 3) uint8);
  * `clip/00000.jpg` … `clip/00031.jpg`: 32 frames of 224x224, quality
    75, 4:2:0, a moving pattern with noise drawn from CLIP_SEED.

The cases are written by PIL where PIL can write them (quality,
subsampling, grey, progressive, optimized tables, restart markers; PNG
modes 1, L, I;16, RGB, P, LA, RGBA, with transparency), and by hand
here where it cannot: PNG at 16 bits, 2/4-bit grey, Adam7 interlace, a
short palette (`png_bytes`, every row filter), and baseline JPEGs from
given coefficients (`jpeg_from_coefficients`: 4:4:0, mixed ratios,
samples far out of range, which PIL's encoder does not make).
tests/test_torch_frames.py makes the same cases in a temporary
directory and checks the committed files.
"""

from __future__ import annotations

import io
import os
import struct
import sys
import zlib

import numpy as np

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "torch_frames")
CLIP_SEED, CLIP_FRAMES, CLIP_SIZE, CLIP_QUALITY = 11, 32, 224, 75

# name: (height, width, grey, PIL save options)
JPEG_CASES = {
    "q50_444": (48, 64, False, dict(quality=50, subsampling=0)),
    "q95_444": (29, 37, False, dict(quality=95, subsampling=0)),
    "q50_422": (29, 37, False, dict(quality=50, subsampling=1)),
    "q95_422": (48, 64, False, dict(quality=95, subsampling=1)),
    "q50_420": (48, 64, False, dict(quality=50, subsampling=2)),
    "q95_420": (29, 37, False, dict(quality=95, subsampling=2)),
    "q75_420_1x1": (1, 1, False, dict(quality=75, subsampling=2)),
    "q75_422_1x1": (1, 1, False, dict(quality=75, subsampling=1)),
    "grey": (29, 37, True, dict(quality=75)),
    "grey_1x1": (1, 1, True, dict(quality=75)),
    "progressive_420": (48, 64, False, dict(quality=75, progressive=True)),
    "progressive_444": (29, 37, False, dict(quality=90, subsampling=0,
                                            progressive=True)),
    "progressive_grey": (48, 64, True, dict(quality=75, progressive=True)),
    "optimize_420": (29, 37, False, dict(quality=75, optimize=True)),
    "restart_420": (48, 64, False, dict(quality=75,
                                        restart_marker_blocks=3)),
    "restart_progressive": (29, 37, False, dict(quality=75, progressive=True,
                                                restart_marker_rows=1)),
    # By hand (jpeg_from_coefficients): sampling factors per component,
    # coefficient scale, restart interval.
    "coef_440": (29, 37, False, dict(coef=((1, 2), (1, 1), (1, 1)))),
    "coef_mixed": (29, 37, False, dict(coef=((2, 2), (1, 2), (2, 1)),
                                       restart=2)),
    "coef_range": (24, 19, False, dict(coef=((1, 1), (1, 1), (1, 1)),
                                       scale=4)),
    "coef_range_420": (17, 26, False, dict(coef=((2, 2), (1, 1), (1, 1)),
                                           scale=4)),
    # IDCT outputs beyond ±512 of the centre, where jidctint.c's table
    # wraps and libjpeg-turbo's SIMD IDCT, PIL's, saturates.
    "coef_saturate": (24, 19, False, dict(coef=((1, 1), (1, 1), (1, 1)),
                                          scale=12)),
}

# name: (height, width, how): how is ("pil", mode, save options) or
# ("hand", colour type, depth, interlace, palette size or None, tRNS).
PNG_CASES = {
    "png_1bit": (29, 37, ("pil", "1", {})),
    "png_L8": (48, 64, ("pil", "L", {})),
    "png_L8_trns": (29, 37, ("pil", "L", dict(transparency=7))),
    "png_I16": (29, 37, ("pil", "I;16", {})),
    "png_RGB8": (48, 64, ("pil", "RGB", {})),
    "png_RGB8_trns": (1, 1, ("pil", "RGB", dict(transparency=(1, 2, 3)))),
    "png_P1": (29, 37, ("pil", "P2", {})),
    "png_P2": (29, 37, ("pil", "P4", {})),
    "png_P4": (48, 64, ("pil", "P16", {})),
    "png_P8_trns": (29, 37, ("pil", "P256", dict(transparency=5))),
    "png_LA8": (29, 37, ("pil", "LA", {})),
    "png_RGBA8": (48, 64, ("pil", "RGBA", {})),
    "png_RGB16_adam7": (29, 37, ("hand", 2, 16, True, None, None)),
    "png_RGBA16": (29, 37, ("hand", 6, 16, False, None, None)),
    "png_LA16_adam7": (5, 7, ("hand", 4, 16, True, None, None)),
    "png_L16_adam7": (29, 37, ("hand", 0, 16, True, None, b"\x00\x05")),
    "png_L2_adam7": (29, 37, ("hand", 0, 2, True, None, None)),
    "png_L4": (3, 2, ("hand", 0, 4, False, None, None)),
    "png_L1_adam7_trns": (1, 1, ("hand", 0, 1, True, None, b"\x00\x01")),
    "png_P4_short_adam7": (29, 37, ("hand", 3, 4, True, 11, b"\x00\x80")),
    "png_P8_adam7": (48, 64, ("hand", 3, 8, True, 256, None)),
    "png_P2_adam7_narrow": (5, 3, ("hand", 3, 2, True, 3, None)),
}


def case_seed(name: str) -> int:
    return zlib.crc32(name.encode())


def picture(rng, h: int, w: int, channels: int = 3) -> np.ndarray:
    """(h, w, channels) uint8: gradients with noise."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    base = np.stack([x * 255 / max(w - 1, 1), y * 255 / max(h - 1, 1),
                     (x + y) * 6 % 256, 128 + 100 * np.sin(x / 3.0)],
                    axis=-1)[..., :channels]
    return np.clip(base + rng.normal(0, 30, (h, w, channels)), 0,
                   255).astype(np.uint8)


# ---------------------------------------------------------------------
# PNG by hand
# ---------------------------------------------------------------------

ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data)))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _pack(samples: np.ndarray, depth: int) -> list[bytes]:
    """(rows, n) samples → each row's bytes at `depth` bits."""
    if depth == 16:
        return [r.astype(">u2").tobytes() for r in samples]
    if depth == 8:
        return [r.astype(np.uint8).tobytes() for r in samples]
    bits = (samples[..., None] >> np.arange(depth - 1, -1, -1)) & 1
    return [np.packbits(r.reshape(-1).astype(np.uint8)).tobytes()
            for r in bits]


def _filter(rows: list[bytes], bpp: int, first: int) -> bytes:
    """Rows filtered with filter types first, first + 1, … (mod 5)."""
    out, prev = [], bytes(len(rows[0]))
    for y, r in enumerate(rows):
        ft = (first + y) % 5
        f = bytearray(len(r))
        for i in range(len(r)):
            a = r[i - bpp] if i >= bpp else 0
            b, c = prev[i], prev[i - bpp] if i >= bpp else 0
            f[i] = (r[i] - (0, a, b, (a + b) >> 1, _paeth(a, b, c))[ft]) & 255
        out.append(bytes([ft]) + bytes(f))
        prev = r
    return b"".join(out)


def png_bytes(samples: np.ndarray, ctype: int, depth: int,
              interlace: bool = False, palette: bytes | None = None,
              trns: bytes | None = None) -> bytes:
    """(H, W, channels) samples → a PNG file with every row filter, the
    image data split over two IDAT chunks."""
    h, w, ch = samples.shape
    bpp = max(1, ch * depth // 8)
    raw = b""
    for k, (x0, y0, dx, dy) in enumerate(ADAM7 if interlace
                                         else ((0, 0, 1, 1),)):
        sub = samples[y0::dy, x0::dx]
        if sub.size:
            raw += _filter(_pack(sub.reshape(sub.shape[0], -1), depth), bpp,
                           k)
    z = zlib.compress(raw, 6)
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0,
                                          0, int(interlace)))
            + (_chunk(b"PLTE", palette) if palette is not None else b"")
            + (_chunk(b"tRNS", trns) if trns is not None else b"")
            + _chunk(b"IDAT", z[:len(z) // 2])
            + _chunk(b"IDAT", z[len(z) // 2:]) + _chunk(b"IEND", b""))


# ---------------------------------------------------------------------
# Baseline JPEG from coefficients, by hand
# ---------------------------------------------------------------------

NATURAL = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
# Flat Huffman tables: DC categories 0..11 at 4 bits, the 162 AC symbols
# at 8 bits.
DC_SYMBOLS = list(range(12))
AC_SYMBOLS = [0x00, 0xF0] + [r << 4 | s for r in range(16)
                             for s in range(1, 11)]


class _BitWriter:
    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, value: int, n: int):
        self.acc = (self.acc << n) | (value & ((1 << n) - 1))
        self.n += n
        while self.n >= 8:
            self.n -= 8
            byte = (self.acc >> self.n) & 255
            self.out.append(byte)
            if byte == 0xFF:
                self.out.append(0)

    def flush(self):
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)


def _category(v: int) -> tuple[int, int]:
    s = abs(v).bit_length()
    return s, (v if v >= 0 else v + (1 << s) - 1)


def jpeg_from_coefficients(width: int, height: int, sampling, coefs,
                           qtable: np.ndarray, restart: int = 0) -> bytes:
    """A baseline JFIF file: components with `sampling` (h, v) each,
    their quantized coefficients `coefs` ((blocks_h, blocks_w, 64) in
    natural order, whole MCUs), one quantization table (natural
    order), flat Huffman tables, interleaved when there are several
    components, RSTn every `restart` MCUs."""
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    mcux, mcuy = -(-width // (8 * hmax)), -(-height // (8 * vmax))
    dc_code = {s: i for i, s in enumerate(DC_SYMBOLS)}
    ac_code = {s: i for i, s in enumerate(AC_SYMBOLS)}
    bw = _BitWriter()
    pred = [0] * len(sampling)

    def block(ci, blk):
        s, bits = _category(int(blk[0]) - pred[ci])
        pred[ci] = int(blk[0])
        bw.put(dc_code[s], 4)
        bw.put(bits, s)
        zz = blk[NATURAL]
        last = max((k for k in range(1, 64) if zz[k]), default=0)
        run = 0
        for k in range(1, last + 1):
            if zz[k] == 0:
                run += 1
                continue
            while run > 15:
                bw.put(ac_code[0xF0], 8)
                run -= 16
            s, bits = _category(int(zz[k]))
            bw.put(ac_code[run << 4 | s], 8)
            bw.put(bits, s)
            run = 0
        if last < 63:
            bw.put(ac_code[0x00], 8)

    if len(sampling) == 1:
        units = [(0, y, x) for y in range(-(-height // 8))
                 for x in range(-(-width // 8))]
        mcus = [[u] for u in units]
    else:
        mcus = [[(ci, my * v + by, mx * h + bx)
                 for ci, (h, v) in enumerate(sampling)
                 for by in range(v) for bx in range(h)]
                for my in range(mcuy) for mx in range(mcux)]
    for m, mcu in enumerate(mcus):
        if restart and m and m % restart == 0:
            bw.flush()
            bw.out += bytes([0xFF, 0xD0 + (m // restart - 1) % 8])
            pred = [0] * len(sampling)
        for ci, y, x in mcu:
            block(ci, coefs[ci][y, x])
    bw.flush()
    sof = struct.pack(">BHHB", 8, height, width, len(sampling)) + b"".join(
        bytes([i + 1, h << 4 | v, 0]) for i, (h, v) in enumerate(sampling))
    counts = np.zeros((2, 16), np.uint8)
    counts[0, 3], counts[1, 7] = len(DC_SYMBOLS), len(AC_SYMBOLS)
    dht = (bytes([0x00]) + counts[0].tobytes() + bytes(DC_SYMBOLS)
           + bytes([0x10]) + counts[1].tobytes() + bytes(AC_SYMBOLS))
    sos = bytes([len(sampling)]) + b"".join(
        bytes([i + 1, 0x00]) for i in range(len(sampling))) + bytes([0, 63,
                                                                     0])

    def seg(marker, data):
        return bytes([0xFF, marker]) + struct.pack(">H", len(data) + 2) + data

    return (b"\xff\xd8"
            + seg(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
            + seg(0xDB, bytes([0]) + bytes(qtable[NATURAL].astype(np.uint8)))
            + seg(0xC0, sof) + seg(0xC4, dht)
            + (seg(0xDD, struct.pack(">H", restart)) if restart else b"")
            + seg(0xDA, sos) + bytes(bw.out) + b"\xff\xd9")


def _coef_jpeg(rng, h: int, w: int, sampling, scale: int = 1,
               restart: int = 0) -> bytes:
    """Random sparse coefficients: DC a walk, a dozen AC terms a block;
    `scale` pushes samples far outside 0..255."""
    hmax = max(a for a, _ in sampling)
    vmax = max(b for _, b in sampling)
    mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    coefs = []
    for hs, vs in sampling:
        c = np.zeros((mcuy * vs, mcux * hs, 64), np.int64)
        c[..., 0] = np.cumsum(rng.integers(-6, 7, c.shape[:2]), axis=1)
        for _ in range(12):
            k = rng.integers(1, 64, c.shape[:2])
            v = rng.integers(-8 * scale, 8 * scale + 1, c.shape[:2])
            np.put_along_axis(c, NATURAL[k][..., None], v[..., None], axis=2)
        coefs.append(c)
    q = np.clip(np.arange(64) // 4 + 4, 1, 255)
    return jpeg_from_coefficients(w, h, sampling, coefs, q, restart)


# ---------------------------------------------------------------------
# The cases
# ---------------------------------------------------------------------

def jpeg_case(name: str) -> bytes:
    from PIL import Image

    h, w, grey, opts = JPEG_CASES[name]
    rng = np.random.default_rng(case_seed(name))
    if "coef" in opts:
        return _coef_jpeg(rng, h, w, opts["coef"], opts.get("scale", 1),
                          opts.get("restart", 0))
    img = picture(rng, h, w, 1 if grey else 3)
    buf = io.BytesIO()
    Image.fromarray(img[..., 0] if grey else img).save(buf, "JPEG", **opts)
    return buf.getvalue()


def png_case(name: str) -> bytes:
    from PIL import Image

    h, w, how = PNG_CASES[name]
    rng = np.random.default_rng(case_seed(name))
    if how[0] == "hand":
        _, ctype, depth, interlace, npal, trns = how
        ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
        top = npal if ctype == 3 else 1 << depth
        samples = rng.integers(0, top, (h, w, ch))
        if ctype == 0 and depth == 16:      # Pillow clips I;16 at 255
            samples = rng.integers(0, 600, (h, w, ch))
        palette = (rng.integers(0, 256, 3 * npal).astype(np.uint8).tobytes()
                   if ctype == 3 else None)
        return png_bytes(samples, ctype, depth, interlace, palette, trns)
    _, mode, opts = how
    if mode.startswith("P"):
        n = int(mode[1:])
        img = Image.frombytes("P", (w, h), rng.integers(0, n, (h, w),
                                                         np.uint8).tobytes())
        img.putpalette(rng.integers(0, 256, 3 * n).astype(np.uint8).tobytes())
    elif mode == "I;16":
        img = Image.fromarray(rng.integers(0, 700, (h, w)).astype(np.uint16))
    elif mode == "1":
        img = Image.fromarray(picture(rng, h, w, 1)[..., 0]).convert("1")
    else:
        ch = {"L": 1, "RGB": 3, "LA": 2, "RGBA": 4}[mode]
        pic = picture(rng, h, w, ch)
        img = Image.fromarray(pic[..., 0] if ch == 1 else pic)
    buf = io.BytesIO()
    img.save(buf, "PNG", **opts)
    return buf.getvalue()


def case_bytes(name: str) -> tuple[bytes, str]:
    """→ (the case's file bytes, its extension)."""
    if name in JPEG_CASES:
        return jpeg_case(name), ".jpg"
    return png_case(name), ".png"


def pil_decode(data: bytes) -> np.ndarray:
    import warnings

    from PIL import Image

    with warnings.catch_warnings():     # palettes with tRNS bytes warn
        warnings.simplefilter("ignore")
        return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def clip_frames() -> list[bytes]:
    """The 224x224 clip's JPEG files: a drifting pattern with noise."""
    from PIL import Image

    rng = np.random.default_rng(CLIP_SEED)
    y, x = np.mgrid[0:CLIP_SIZE, 0:CLIP_SIZE].astype(np.float64)
    out = []
    for t in range(CLIP_FRAMES):
        r = 128 + 90 * np.sin((x + 4 * t) / 17.0) * np.cos(y / 23.0)
        g = 128 + 90 * np.cos((x - y + 6 * t) / 29.0)
        b = 255.0 * (((x // 28 + y // 28 + t // 4) % 2))
        img = np.stack([r, g, b], -1) + rng.normal(0, 12, r.shape + (3,))
        buf = io.BytesIO()
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
            buf, "JPEG", quality=CLIP_QUALITY, subsampling=2)
        out.append(buf.getvalue())
    return out


def main(out: str = FIXTURES):
    os.makedirs(os.path.join(out, "clip"), exist_ok=True)
    for name in (*JPEG_CASES, *PNG_CASES):
        data, ext = case_bytes(name)
        with open(os.path.join(out, name + ext), "wb") as f:
            f.write(data)
        np.save(os.path.join(out, name + ".npy"), pil_decode(data))
    for t, data in enumerate(clip_frames()):
        with open(os.path.join(out, "clip", f"{t:05d}.jpg"), "wb") as f:
            f.write(data)


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:]))
