"""The plain twin of csrc/imagedec.cpp: JPEG and PNG decoding and the
frame-directory reader, step by step in numpy and Python.

`native.decode_image` and `native.load_frame_dir` are held against these
functions on the same bytes (tests/test_torch_frames.py, chip_smoke.py's
`[frames]`); nothing on the data path calls them. They compute what
`viai_tpu/data/av.py::_load_frames_dir` gets from PIL:

  * `decode_jpeg_numpy`: baseline, extended and progressive Huffman
    JPEG, 8-bit, 1 or 3 components, sampling ratios 1 or 2, restart
    intervals, as libjpeg-turbo decodes it at PIL's settings: the ISLOW
    integer IDCT (jidctint.c) saturated to 0..255 as libjpeg-turbo's
    SIMD IDCT saturates (the C table wraps beyond ±512), fancy
    upsampling (jdsample.c) and the fixed-point YCbCr->RGB tables
    (jdcolor.c); a progressive file whose scans leave coefficients 0..9
    incomplete (which libjpeg block-smooths) is refused;
  * `decode_png_numpy`: every PNG colour type and depth, Adam7, the five
    row filters (inflate by the standard library's zlib), converted as
    Pillow's `convert("RGB")` converts them;
  * `frame_dir_numpy`: the directory's .jpg/.jpeg/.png names sorted, the
    window's frames by the JAX package's float64 rule, each decoded,
    resized by Pillow's 8-bit BILINEAR (`av._pillow_coeffs`,
    `av._pillow_pass`) and / 255.

Errors are those of the native reader: ValueError for a broken file,
NotImplementedError for a variant that is not read, FileNotFoundError
for a directory without frames.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

from .av import _pillow_coeffs, _pillow_pass

FRAME_EXTENSIONS = (".jpg", ".jpeg", ".png")

# jpeg_natural_order: zigzag index → position in the 8x8 block.
NATURAL = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
_NAT = NATURAL.tolist()


# ---------------------------------------------------------------------
# JPEG: entropy decoding
# ---------------------------------------------------------------------

class _Huffman:
    """A JPEG Huffman table as two 16-bit lookahead lists: the code's
    length (0: no code) and its value."""

    def __init__(self, counts: bytes, vals: bytes):
        length = np.zeros(1 << 16, np.int64)
        value = np.zeros(1 << 16, np.int64)
        code = k = 0
        for n_bits in range(1, 17):
            if code + counts[n_bits - 1] > (1 << n_bits):
                raise ValueError("JPEG Huffman table is over-subscribed")
            for _ in range(counts[n_bits - 1]):
                lo = code << (16 - n_bits)
                hi = (code + 1) << (16 - n_bits)
                length[lo:hi] = n_bits
                value[lo:hi] = vals[k]
                code += 1
                k += 1
            code <<= 1
        self.length = length.tolist()
        self.value = value.tolist()


class _Bits:
    """MSB-first bits of one restart interval's entropy-coded bytes
    (stuffing removed), with zeros after them; `peek[i]` holds the 16
    bits from bit i."""

    def __init__(self, seg: bytes):
        self.n = 8 * len(seg)
        bits = np.unpackbits(np.frombuffer(seg + bytes(8), np.uint8))
        win = np.lib.stride_tricks.sliding_window_view(bits, 16)
        self.peek = (win.astype(np.int64) @ (1 << np.arange(15, -1, -1))
                     ).tolist()
        self.pos = 0

    def get(self, s: int) -> int:
        if s == 0:
            return 0
        v = self.peek[self.pos] >> (16 - s)
        self.pos += s
        return v

    def huff(self, t: _Huffman) -> int:
        v = self.peek[self.pos]
        n = t.length[v]
        if n == 0:
            raise ValueError("JPEG data holds a bad Huffman code")
        self.pos += n
        return t.value[v]


def _extend(v: int, s: int) -> int:
    return v - (1 << s) + 1 if v < (1 << (s - 1)) else v


def _segments(data: bytes, p: int) -> tuple[list[bytes], int]:
    """The scan's entropy-coded data from `p`, split at its restart
    markers, stuffing removed; → (intervals, offset of the next marker)."""
    segs, cur, n = [], bytearray(), len(data)
    while p < n:
        b = data[p]
        if b != 0xFF:
            cur.append(b)
            p += 1
            continue
        if p + 1 < n and data[p + 1] == 0x00:
            cur.append(0xFF)
            p += 2
            continue
        q = p
        while q + 1 < n and data[q + 1] == 0xFF:
            q += 1
        if q + 1 < n and 0xD0 <= data[q + 1] <= 0xD7:
            segs.append((bytes(cur), data[q + 1] - 0xD0))
            cur = bytearray()
            p = q + 2
            continue
        break
    segs.append((bytes(cur), None))
    return segs, p


class _Component:
    def __init__(self, cid, h, v, tq):
        self.id, self.h, self.v, self.tq = cid, h, v, tq
        self.q = None


def _decode_scan(j: dict, scan: dict, segs: list):
    comps, ss, se, ah, al = (scan[k] for k in ("comps", "ss", "se", "ah",
                                               "al"))
    prog = j["progressive"]
    if len(comps) == 1:
        c = comps[0]
        mx, total = c.cbw, c.cbw * c.cbh
    else:
        mx, total = j["mcux"], j["mcux"] * j["mcuy"]
    restart = j["restart"]
    n_intervals = -(-total // restart) if restart else 1
    if len(segs) < n_intervals or any(
            segs[i][1] != i % 8 for i in range(n_intervals - 1)):
        raise ValueError("JPEG restart marker missing")
    state = {"eobrun": 0}
    p1, m1 = 1 << al, -1 * (1 << al)

    def block(c, coef, base):
        if not prog:
            s = br.huff(j["dc"][c.dc_tbl])
            if s > 15:
                raise ValueError("JPEG DC difference too large")
            c.pred += _extend(br.get(s), s) if s else 0
            coef[base] = c.pred
            k = 1
            ac = j["ac"][c.ac_tbl]
            while k < 64:
                rs = br.huff(ac)
                r, s = rs >> 4, rs & 15
                if s:
                    k += r
                    if k > 63:
                        raise ValueError("JPEG coefficient index past the "
                                         "block")
                    coef[base + _NAT[k]] = _extend(br.get(s), s)
                elif r == 15:
                    k += 15
                else:
                    break
                k += 1
        elif ss == 0 and ah == 0:
            s = br.huff(j["dc"][c.dc_tbl])
            if s > 15:
                raise ValueError("JPEG DC difference too large")
            c.pred += _extend(br.get(s), s) if s else 0
            coef[base] = c.pred * (1 << al)
        elif ss == 0:
            if br.get(1):
                coef[base] |= p1
        elif ah == 0:
            if state["eobrun"] > 0:
                state["eobrun"] -= 1
                return
            ac = j["ac"][c.ac_tbl]
            k = ss
            while k <= se:
                rs = br.huff(ac)
                r, s = rs >> 4, rs & 15
                if s:
                    k += r
                    if k > 63:
                        raise ValueError("JPEG coefficient index past the "
                                         "block")
                    coef[base + _NAT[k]] = _extend(br.get(s), s) * (1 << al)
                elif r == 15:
                    k += 15
                else:
                    eob = 1 << r
                    if r:
                        eob += br.get(r)
                    state["eobrun"] = eob - 1
                    break
                k += 1
        else:
            k = ss

            def correct(pos):
                if br.get(1) and (coef[pos] & p1) == 0:
                    coef[pos] += p1 if coef[pos] >= 0 else m1

            if state["eobrun"] == 0:
                ac = j["ac"][c.ac_tbl]
                while k <= se:
                    rs = br.huff(ac)
                    r, s = rs >> 4, rs & 15
                    if s:
                        if s != 1:
                            raise ValueError("JPEG refinement coefficient of "
                                             "size > 1")
                        s = p1 if br.get(1) else m1
                    elif r != 15:
                        eob = 1 << r
                        if r:
                            eob += br.get(r)
                        state["eobrun"] = eob
                        break
                    while k <= se:
                        pos = base + _NAT[k]
                        if coef[pos] != 0:
                            correct(pos)
                        else:
                            r -= 1
                            if r < 0:
                                break
                        k += 1
                    if s:
                        if k > 63:
                            raise ValueError("JPEG coefficient index past "
                                             "the block")
                        coef[base + _NAT[k]] = s
                    k += 1
            if state["eobrun"] > 0:
                while k <= se:
                    pos = base + _NAT[k]
                    if coef[pos] != 0:
                        correct(pos)
                    k += 1
                state["eobrun"] -= 1

    br = None
    for m in range(total):
        if m == 0 or (restart and m % restart == 0):
            if br is not None and br.pos > br.n:
                raise ValueError("JPEG entropy-coded data ends early")
            br = _Bits(segs[m // restart if restart else 0][0])
            for c in comps:
                c.pred = 0
            state["eobrun"] = 0
        x, y = m % mx, m // mx
        try:
            if len(comps) == 1:
                c = comps[0]
                block(c, c.coef, (y * c.bw + x) * 64)
            else:
                for c in comps:
                    for by in range(c.v):
                        for bx in range(c.h):
                            block(c, c.coef,
                                  ((y * c.v + by) * c.bw + x * c.h + bx) * 64)
        except IndexError:
            raise ValueError("JPEG entropy-coded data ends early") from None
    if br.pos > br.n:
        raise ValueError("JPEG entropy-coded data ends early")


def _read_sof(j: dict, d: bytes, marker: int):
    if j.get("comps"):
        raise ValueError("JPEG holds two frames")
    if len(d) < 6:
        raise ValueError("JPEG frame header too short")
    if d[0] != 8:
        raise NotImplementedError(f"{d[0]}-bit JPEG (only 8-bit is read)")
    height, width, ncomp = struct.unpack(">HHB", d[1:6])
    if height == 0:
        raise NotImplementedError("JPEG whose height comes in a DNL marker")
    if width == 0:
        raise ValueError("image has no pixels")
    if width * height > 1 << 26:
        raise NotImplementedError("image larger than 2^26 pixels")
    if ncomp == 4:
        raise NotImplementedError("CMYK/YCCK JPEG (4 components)")
    if ncomp not in (1, 3):
        raise NotImplementedError(f"JPEG with {ncomp} components")
    if len(d) < 6 + 3 * ncomp:
        raise ValueError("JPEG frame header too short")
    comps = [_Component(d[6 + 3 * i], d[7 + 3 * i] >> 4, d[7 + 3 * i] & 15,
                        d[8 + 3 * i]) for i in range(ncomp)]
    for c in comps:
        if not (1 <= c.h <= 4 and 1 <= c.v <= 4 and c.tq <= 3):
            raise ValueError("JPEG component has bad sampling factors or "
                             "table")
    hmax, vmax = max(c.h for c in comps), max(c.v for c in comps)
    mcux, mcuy = -(-width // (8 * hmax)), -(-height // (8 * vmax))
    for c in comps:
        if ncomp > 1 and (hmax % c.h or vmax % c.v or hmax // c.h > 2
                          or vmax // c.v > 2):
            raise NotImplementedError("JPEG sampling ratio other than 1 or 2")
        c.dw, c.dh = -(-width * c.h // hmax), -(-height * c.v // vmax)
        c.cbw, c.cbh = -(-c.dw // 8), -(-c.dh // 8)
        c.bw, c.bh = mcux * c.h, mcuy * c.v
        c.coef = [0] * (c.bw * c.bh * 64)
        c.bits = [-1] * 64
    j.update(width=width, height=height, comps=comps, hmax=hmax, vmax=vmax,
             mcux=mcux, mcuy=mcuy, progressive=marker == 0xC2)


def _jpeg_coefficients(data: bytes) -> dict:
    """Parse and entropy-decode a JPEG: the frame's fields and each
    component's quantized coefficients (natural order, whole MCUs)."""
    j = {"restart": 0, "qt": {}, "dc": {}, "ac": {}, "jfif": False,
         "adobe": None, "comps": None}
    p, n, scans = 2, len(data), 0
    while True:
        while p < n and data[p] != 0xFF:
            p += 1
        while p < n and data[p] == 0xFF:
            p += 1
        if p >= n:
            raise ValueError("JPEG ends before EOI")
        m = data[p]
        p += 1
        if m == 0xD9:
            break
        if m in (0x00, 0xD8, 0x01) or 0xD0 <= m <= 0xD7:
            continue
        if n - p < 2:
            raise ValueError("JPEG marker segment cut short")
        seg_len = struct.unpack(">H", data[p:p + 2])[0]
        if seg_len < 2 or p + seg_len > n:
            raise ValueError("JPEG marker segment cut short")
        d = data[p + 2:p + seg_len]
        p += seg_len
        if m in (0xC0, 0xC1, 0xC2):
            _read_sof(j, d, m)
        elif m == 0xC3:
            raise NotImplementedError("lossless JPEG")
        elif m in (0xC5, 0xC6, 0xC7, 0xCD, 0xCE, 0xCF):
            raise NotImplementedError("hierarchical (differential) JPEG")
        elif m in (0xC9, 0xCA, 0xCB, 0xCC):
            raise NotImplementedError("arithmetic-coded JPEG")
        elif m == 0xC4:
            o = 0
            while o < len(d):
                if len(d) - o < 17:
                    raise ValueError("JPEG Huffman table cut short")
                tc, th = d[o] >> 4, d[o] & 15
                if tc > 1 or th > 3:
                    raise ValueError("JPEG Huffman table has a bad index")
                counts = d[o + 1:o + 17]
                total = sum(counts)
                if total > 256 or len(d) - o - 17 < total:
                    raise ValueError("JPEG Huffman table cut short")
                j["ac" if tc else "dc"][th] = _Huffman(
                    counts, d[o + 17:o + 17 + total])
                o += 17 + total
        elif m == 0xDB:
            o = 0
            while o < len(d):
                pq, tq = d[o] >> 4, d[o] & 15
                if pq > 1 or tq > 3:
                    raise ValueError("JPEG quantization table is bad")
                size = 128 if pq else 64
                if len(d) - o - 1 < size:
                    raise ValueError("JPEG quantization table cut short")
                vals = np.frombuffer(d[o + 1:o + 1 + size],
                                     ">u2" if pq else np.uint8)
                q = np.zeros(64, np.int64)
                q[NATURAL] = vals
                j["qt"][tq] = q
                o += 1 + size
        elif m == 0xDD:
            if len(d) < 2:
                raise ValueError("JPEG restart interval cut short")
            j["restart"] = struct.unpack(">H", d[:2])[0]
        elif m == 0xDC:
            raise NotImplementedError("JPEG with a DNL marker")
        elif m == 0xE0:
            j["jfif"] = j["jfif"] or d[:5] == b"JFIF\0"
        elif m == 0xEE:
            if len(d) >= 12 and d[:5] == b"Adobe":
                j["adobe"] = d[11]
        elif m == 0xDA:
            p = _read_scan(j, d, data, p)
            scans += 1
    if not j["comps"] or scans == 0:
        raise ValueError("JPEG holds no image")
    comps = j["comps"]
    if len(comps) == 3:
        if j["adobe"] == 0:
            raise NotImplementedError("Adobe-transform RGB JPEG (APP14 "
                                      "transform 0)")
        if j["adobe"] == 2:
            raise NotImplementedError("Adobe-transform YCCK JPEG")
        if (not j["jfif"] and j["adobe"] is None
                and [c.id for c in comps] == [ord("R"), ord("G"), ord("B")]):
            raise NotImplementedError("RGB-coded JPEG (components R, G, B)")
    if any(c.q is None for c in comps):
        raise ValueError("JPEG component never scanned")
    if j["progressive"] and any(b != 0 for c in comps for b in c.bits[:10]):
        raise NotImplementedError("progressive JPEG whose scans leave its "
                                  "first coefficients incomplete (libjpeg "
                                  "would smooth it)")
    return j


def _read_scan(j: dict, d: bytes, data: bytes, p: int) -> int:
    comps = j["comps"]
    if not comps:
        raise ValueError("JPEG scan before its frame header")
    if len(d) < 1:
        raise ValueError("JPEG scan header cut short")
    ns = d[0]
    if not 1 <= ns <= len(comps) or len(d) < 4 + 2 * ns:
        raise ValueError("JPEG scan header is bad")
    in_scan = []
    for i in range(ns):
        found = [c for c in comps if c.id == d[1 + 2 * i]]
        if not found:
            raise ValueError("JPEG scan names an unknown component")
        c = found[0]
        c.dc_tbl, c.ac_tbl = d[2 + 2 * i] >> 4, d[2 + 2 * i] & 15
        if c.dc_tbl > 3 or c.ac_tbl > 3:
            raise ValueError("JPEG scan table index")
        if c.q is None:                       # latch_quant_tables
            if c.tq not in j["qt"]:
                raise ValueError("JPEG quantization table missing")
            c.q = j["qt"][c.tq].copy()
        in_scan.append(c)
    t = d[1 + 2 * ns:]
    ss, se, ah, al = t[0], t[1], t[2] >> 4, t[2] & 15
    prog = j["progressive"]
    if prog and not (ss <= se <= 63 and al <= 13 and ah <= 13
                     and (se == 0 if ss == 0 else ns == 1)):
        raise ValueError("JPEG progressive scan parameters are bad")
    need_dc = not prog or (ss == 0 and ah == 0)
    need_ac = not prog or ss > 0
    for c in in_scan:
        if (need_dc and c.dc_tbl not in j["dc"]) or (
                need_ac and c.ac_tbl not in j["ac"]):
            raise ValueError("JPEG Huffman table missing")
    if ns > 1 and sum(c.h * c.v for c in in_scan) > 10:
        raise ValueError("JPEG MCU of more than 10 blocks")
    if prog:
        for c in in_scan:
            c.bits[ss:se + 1] = [al] * (se + 1 - ss)
    segs, p = _segments(data, p)
    _decode_scan(j, dict(comps=in_scan, ss=ss, se=se, ah=ah, al=al), segs)
    return p


# ---------------------------------------------------------------------
# JPEG: IDCT, upsampling, colour
# ---------------------------------------------------------------------

# jidctint.c's constants (CONST_BITS 13).
_F = dict(f0298=2446, f0390=3196, f0541=4433, f0765=6270, f0899=7373,
          f1175=9633, f1501=12299, f1847=15137, f1961=16069, f2053=16819,
          f2562=20995, f3072=25172)


def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


def _idct_1d(v, n):
    """One pass of jpeg_idct_islow over inputs v[0..7] (arrays); the 8
    outputs before their descale by n bits."""
    f = _F
    z1 = (v[2] + v[6]) * f["f0541"]
    tmp2 = z1 + v[6] * -f["f1847"]
    tmp3 = z1 + v[2] * f["f0765"]
    tmp0 = (v[0] + v[4]) * 8192
    tmp1 = (v[0] - v[4]) * 8192
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = v[7], v[5], v[3], v[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * f["f1175"]
    t0 = t0 * f["f0298"]
    t1 = t1 * f["f2053"]
    t2 = t2 * f["f3072"]
    t3 = t3 * f["f1501"]
    z1 = z1 * -f["f0899"]
    z2 = z2 * -f["f2562"]
    z3 = z3 * -f["f1961"] + z5
    z4 = z4 * -f["f0390"] + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4
    return [_descale(x, n) for x in (
        tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
        tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)]


def idct_islow(coef: np.ndarray, q: np.ndarray) -> np.ndarray:
    """(N, 64) quantized coefficients (natural order) and their (64,)
    table → (N, 8, 8) uint8 samples: columns, then rows, each output
    saturated to a sample."""
    x = (coef.astype(np.int64) * q).reshape(-1, 8, 8)
    ws = np.stack(_idct_1d([x[:, k, :] for k in range(8)], 11), axis=1)
    out = np.stack(_idct_1d([ws[:, :, k] for k in range(8)], 18), axis=2)
    return (np.clip(out, -128, 127) + 128).astype(np.uint8)


def _plane(c) -> np.ndarray:
    coef = np.asarray(c.coef, np.int64).reshape(c.bh, c.bw, 64)
    blocks = idct_islow(coef[:c.cbh, :c.cbw].reshape(-1, 64), c.q)
    plane = blocks.reshape(c.cbh, c.cbw, 8, 8).transpose(0, 2, 1, 3)
    return plane.reshape(c.cbh * 8, c.cbw * 8)[:c.dh, :c.dw]


def upsample(x: np.ndarray, rh: int, rv: int) -> np.ndarray:
    """jdsample.c on a (dh, dw) uint8 plane, rh, rv ∈ {1, 2}: box where
    rh is 2 and the plane is at most 2 wide, else fancy (triangle, 3/4
    near + 1/4 far with libjpeg's biases), edges replicated."""
    if rh == 1 and rv == 1:
        return x
    x = x.astype(np.int64)
    if rh == 2 and x.shape[1] <= 2:
        return np.repeat(np.repeat(x, rv, axis=0), 2, axis=1).astype(np.uint8)
    pad = np.pad(x, 1, mode="edge")
    if rv == 1:                                        # h2v1
        c = 3 * x
        left = (c + pad[1:-1, :-2] + 1) >> 2
        right = (c + pad[1:-1, 2:] + 2) >> 2
        return np.stack([left, right], axis=2).reshape(x.shape[0], -1
                                                       ).astype(np.uint8)
    near = 3 * pad[1:-1]
    if rh == 1:                                        # h1v2
        top = (near[:, 1:-1] + pad[:-2, 1:-1] + 1) >> 2
        bottom = (near[:, 1:-1] + pad[2:, 1:-1] + 2) >> 2
        return np.stack([top, bottom], axis=1).reshape(-1, x.shape[1]
                                                       ).astype(np.uint8)
    rows = []                                          # h2v2
    for far in (pad[:-2], pad[2:]):
        cs = near + far
        left = (3 * cs[:, 1:-1] + cs[:, :-2] + 8) >> 4
        right = (3 * cs[:, 1:-1] + cs[:, 2:] + 7) >> 4
        rows.append(np.stack([left, right], axis=2).reshape(x.shape[0], -1))
    return np.stack(rows, axis=1).reshape(2 * x.shape[0], -1).astype(np.uint8)


def _fix(x: float) -> int:
    return int(x * 65536.0 + 0.5)


_C = np.arange(256, dtype=np.int64) - 128
CR_R = (_fix(1.40200) * _C + 32768) >> 16
CB_B = (_fix(1.77200) * _C + 32768) >> 16
CR_G = -_fix(0.71414) * _C
CB_G = -_fix(0.34414) * _C + 32768
del _C


def ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """jdcolor.c's ycc_rgb_convert on uint8 planes → (H, W, 3) uint8."""
    y = y.astype(np.int64)
    rgb = np.stack([y + CR_R[cr], y + ((CB_G[cb] + CR_G[cr]) >> 16),
                    y + CB_B[cb]], axis=-1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def decode_jpeg_numpy(data: bytes) -> np.ndarray:
    """JPEG bytes → (H, W, 3) uint8, as `native.decode_image` decodes
    them."""
    j = _jpeg_coefficients(data)
    comps, w, h = j["comps"], j["width"], j["height"]
    if len(comps) == 1:
        y = _plane(comps[0])
        return np.repeat(y[..., None], 3, axis=2)
    planes = [upsample(_plane(c), j["hmax"] // c.h, j["vmax"] // c.v)
              [:h, :w] for c in comps]
    return ycc_to_rgb(*planes)


# ---------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------

_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def unfilter(raw: np.ndarray, rows: int, rowbytes: int, bpp: int
             ) -> np.ndarray:
    """(rows·(1 + rowbytes),) filtered bytes → (rows, rowbytes) uint8."""
    out = np.zeros((rows, rowbytes), np.uint8)
    prev = np.zeros(rowbytes, np.int64)
    for y in range(rows):
        line = raw[y * (rowbytes + 1):(y + 1) * (rowbytes + 1)]
        ft, cur = int(line[0]), line[1:].astype(np.int64)
        if ft == 1:
            pad = (-rowbytes) % bpp
            cur = np.cumsum(np.concatenate([cur, np.zeros(pad, np.int64)])
                            .reshape(-1, bpp), axis=0).reshape(-1)[:rowbytes]
        elif ft == 2:
            cur = cur + prev
        elif ft in (3, 4):
            c, pv = cur.tolist(), prev.tolist()
            for i in range(rowbytes):
                a = c[i - bpp] if i >= bpp else 0
                if ft == 3:
                    c[i] = (c[i] + ((a + pv[i]) >> 1)) & 255
                else:
                    c[i] = (c[i] + _paeth(a, pv[i], pv[i - bpp] if i >= bpp
                                          else 0)) & 255
            cur = np.array(c, np.int64)
        elif ft != 0:
            raise ValueError(f"PNG row filter {ft} is unknown")
        cur = cur & 255
        out[y] = cur
        prev = cur
    return out


def _samples(rows: np.ndarray, width: int, channels: int, depth: int
             ) -> np.ndarray:
    """(rows, rowbytes) unfiltered bytes → (rows, width, channels) ints."""
    if depth == 16:
        v = rows.view(">u2")
    elif depth == 8:
        v = rows
    else:
        bits = np.unpackbits(rows, axis=1)[:, :width * depth]
        v = bits.reshape(rows.shape[0], width, depth) @ (
            1 << np.arange(depth - 1, -1, -1))
    return v.reshape(rows.shape[0], width, channels).astype(np.int64)


def _to_rgb(s: np.ndarray, ctype: int, depth: int, palette) -> np.ndarray:
    """Samples → RGB as Pillow's convert("RGB") gives them."""
    if ctype == 3:
        pal = np.zeros((256, 3), np.int64)             # past it: black
        pal[:len(palette)] = palette
        return pal[s[..., 0]]
    if depth == 16:
        s = np.minimum(s, 255) if ctype == 0 else s >> 8
    elif depth < 8:
        s = s * {1: 255, 2: 0x55, 4: 0x11}[depth]
    if ctype in (0, 4):
        return np.repeat(s[..., :1], 3, axis=-1)
    return s[..., :3]


def decode_png_numpy(data: bytes) -> np.ndarray:
    """PNG bytes → (H, W, 3) uint8, as `native.decode_image` decodes
    them."""
    o, n = 8, len(data)
    hdr, palette, idat, iend = None, None, [], False
    while o + 12 <= n:
        length = struct.unpack(">I", data[o:o + 4])[0]
        if length > n - o - 12:
            raise ValueError("PNG chunk runs past the file")
        ctype, d = data[o + 4:o + 8], data[o + 8:o + 8 + length]
        crc = struct.unpack(">I", data[o + 8 + length:o + 12 + length])[0]
        if zlib.crc32(ctype + d) != crc:
            raise ValueError(f"PNG chunk {ctype.decode('latin-1')} fails its "
                             f"CRC")
        if hdr is None and ctype != b"IHDR":
            raise ValueError("PNG does not start with IHDR")
        if ctype == b"IHDR":
            if length != 13:
                raise ValueError("PNG IHDR has the wrong length")
            hdr = struct.unpack(">IIBBBBB", d)
            w, h, depth, color, comp, filt, interlace = hdr
            if w == 0 or h == 0:
                raise ValueError("image has no pixels")
            if w * h > 1 << 26:
                raise NotImplementedError("image larger than 2^26 pixels")
            if depth not in _DEPTHS.get(color, ()):
                raise ValueError("PNG colour type and depth do not go "
                                 "together")
            if comp or filt or interlace > 1:
                raise ValueError("PNG compression, filter or interlace "
                                 "method is unknown")
        elif ctype == b"PLTE":
            if length % 3 or length > 768:
                raise ValueError("PNG palette has a bad length")
            palette = np.frombuffer(d, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(d)
        elif ctype == b"IEND":
            iend = True
            break
        o += 12 + length
    if hdr is None or not iend:
        raise ValueError("PNG ends before IEND")
    w, h, depth, color, _, _, interlace = hdr
    if color == 3 and palette is None:
        raise ValueError("PNG palette missing")
    ch = _CHANNELS[color]
    bpp = max(1, ch * depth // 8)
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    try:
        raw = np.frombuffer(zlib.decompressobj().decompress(b"".join(idat)),
                            np.uint8)
    except zlib.error as e:
        raise ValueError(f"PNG image data: {e}") from None
    out = np.zeros((h, w, 3), np.uint8)
    off = 0
    for x0, y0, dx, dy in passes:
        pw = (w - x0 + dx - 1) // dx if w > x0 else 0
        ph = (h - y0 + dy - 1) // dy if h > y0 else 0
        if not pw or not ph:
            continue
        rowbytes = (pw * ch * depth + 7) // 8
        size = ph * (rowbytes + 1)
        if off + size > len(raw):
            raise ValueError("PNG image data ends early")
        rows = unfilter(raw[off:off + size], ph, rowbytes, bpp)
        off += size
        out[y0::dy, x0::dx] = _to_rgb(_samples(rows, pw, ch, depth), color,
                                      depth, palette)
    return out


_OTHER_FORMATS = ((b"GIF87a", "GIF"), (b"GIF89a", "GIF"), (b"RIFF", "WebP"),
                  (b"BM", "BMP"), (b"II*\0", "TIFF"), (b"MM\0*", "TIFF"))


def decode_image_numpy(data: bytes) -> np.ndarray:
    """JPEG or PNG bytes (told apart by their signature) → (H, W, 3)
    uint8."""
    if data[:3] == b"\xff\xd8\xff":
        return decode_jpeg_numpy(data)
    if data[:8] == b"\x89PNG\r\n\x1a\n":
        return decode_png_numpy(data)
    for magic, name in _OTHER_FORMATS:
        if data.startswith(magic) and (name != "WebP"
                                       or data[8:12] == b"WEBP"):
            raise NotImplementedError(f"{name} image (only JPEG and PNG are "
                                      f"read)")
    raise ValueError("not a JPEG or PNG image")


# ---------------------------------------------------------------------
# The directory reader
# ---------------------------------------------------------------------

def window_indices(total: int, n_frames: int, window=None) -> np.ndarray:
    """`viai_tpu/data/av.py::_window_indices`: round(linspace(w0·hi,
    w1·hi, n)) in float64, clipped to [0, hi], hi = total − 1."""
    w0, w1 = (0.0, 1.0) if window is None else window
    hi = max(total - 1, 0)
    return np.clip(np.linspace(w0 * hi, w1 * hi, n_frames).round()
                   .astype(int), 0, hi)


def pillow_resize(img: np.ndarray, size: int) -> np.ndarray:
    """Pillow's `resize((size, size), BILINEAR)` of an (H, W, 3) uint8
    image: horizontal pass, then vertical, each only where its axis
    changes size."""
    if img.shape[1] != size:
        img = _pillow_pass(img, _pillow_coeffs(img.shape[1], size), 1)
    if img.shape[0] != size:
        img = _pillow_pass(img, _pillow_coeffs(img.shape[0], size), 0)
    return img


def frame_dir_numpy(path: str, n_frames: int, size: int,
                    window=None) -> np.ndarray:
    """`native.load_frame_dir`, one file at a time: → (n_frames, size,
    size, 3) float32 in [0, 1]."""
    files = sorted(f for f in os.listdir(path)
                   if f.lower().endswith(FRAME_EXTENSIONS))
    if not files:
        raise FileNotFoundError(f"no frames in {path}")
    frames = []
    for i in window_indices(len(files), n_frames, window):
        with open(os.path.join(path, files[i]), "rb") as f:
            img = decode_image_numpy(f.read())
        frames.append(pillow_resize(img, size).astype(np.float32) / 255.0)
    return np.stack(frames)
