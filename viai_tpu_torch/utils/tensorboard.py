"""TensorBoard event files, written and read without TensorBoard.

The port's counterpart of the clu writer that `viai_tpu/utils/
visualizer.py` uses. An event file is a sequence of TFRecords:

    uint64 length | uint32 masked CRC-32C of the length
    bytes  data   | uint32 masked CRC-32C of the data

each record an `Event` proto, encoded here by hand: the first holds
`file_version: "brain.Event:2"`, every later one `wall_time`, `step`
and a `Summary` of `simple_value` scalars. CRC-32C is the Castagnoli
polynomial (`zlib.crc32` is the IEEE one), computed from a table.

    w = SummaryWriter(logdir)
    w.write_scalars(step, {"loss_G": 1.25})
    w.close()
    read_scalars(w.path)      # [("loss_G", step, 1.25)]

read_scalars checks both CRCs of every record and raises on a mismatch.
"""

from __future__ import annotations

import os
import socket
import struct
import time

_CRC32C_POLY = 0x82F63B78      # Castagnoli, reflected


def _crc32c_table() -> list[int]:
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ _CRC32C_POLY if c & 1 else c >> 1
        table.append(c)
    return table


_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    """The TFRecord mask of the CRC-32C of `data`."""
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _len_field(field: int, payload: bytes) -> bytes:
    return _key(field, 2) + _varint(len(payload)) + payload


def _event(wall_time: float, step: int = 0, *, file_version: str | None = None,
           scalars: dict[str, float] | None = None) -> bytes:
    """An Event: wall_time = 1 (double), step = 2 (int64), file_version
    = 3 (string) or summary = 5 (Summary: value = 1, each Value's tag =
    1 and simple_value = 2, a float)."""
    out = _key(1, 1) + struct.pack("<d", wall_time)
    if step:
        out += _key(2, 0) + _varint(step)
    if file_version is not None:
        out += _len_field(3, file_version.encode())
    if scalars is not None:
        values = b"".join(
            _len_field(1, _len_field(1, tag.encode())
                       + _key(2, 5) + struct.pack("<f", value))
            for tag, value in scalars.items())
        out += _len_field(5, values)
    return out


def _record(data: bytes) -> bytes:
    head = struct.pack("<Q", len(data))
    return (head + struct.pack("<I", masked_crc32c(head)) + data
            + struct.pack("<I", masked_crc32c(data)))


class SummaryWriter:
    """Scalars to `logdir/events.out.tfevents.<time>.<hostname>`. Every
    write_scalars is flushed, so the file is whole while training runs."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        now = time.time()
        self.path = os.path.join(
            logdir, f"events.out.tfevents.{int(now)}.{socket.gethostname()}")
        self._f = open(self.path, "ab")
        self._f.write(_record(_event(now, file_version="brain.Event:2")))
        self._f.flush()

    def write_scalars(self, step: int, scalars: dict[str, float]):
        self._f.write(_record(_event(
            time.time(), int(step),
            scalars={k: float(v) for k, v in scalars.items()})))
        self._f.flush()

    def flush(self):
        self._f.flush()

    def close(self):
        self._f.close()


def _fields(buf: bytes):
    """(field number, wire type, value) of one protobuf message: an int
    for varints, bytes for the other wire types."""
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _read_varint(buf, pos)
        elif wire == 1:
            value, pos = buf[pos:pos + 8], pos + 8
        elif wire == 2:
            n, pos = _read_varint(buf, pos)
            value, pos = buf[pos:pos + n], pos + n
        elif wire == 5:
            value, pos = buf[pos:pos + 4], pos + 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        yield field, wire, value


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    n = shift = 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated protobuf varint")
        b = buf[pos]
        pos += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, pos
        shift += 7


def read_records(path: str) -> list[bytes]:
    """The records of a TFRecord file; raise on a CRC mismatch or a
    truncated record."""
    with open(path, "rb") as f:
        buf = f.read()
    out, pos = [], 0
    while pos < len(buf):
        if pos + 12 > len(buf):
            raise ValueError(f"{path}: truncated record header at {pos}")
        head = buf[pos:pos + 8]
        (n,) = struct.unpack("<Q", head)
        (crc,) = struct.unpack("<I", buf[pos + 8:pos + 12])
        if crc != masked_crc32c(head):
            raise ValueError(f"{path}: length CRC mismatch at {pos}")
        data = buf[pos + 12:pos + 12 + n]
        if len(data) != n or pos + 16 + n > len(buf):
            raise ValueError(f"{path}: truncated record at {pos}")
        (crc,) = struct.unpack("<I", buf[pos + 12 + n:pos + 16 + n])
        if crc != masked_crc32c(data):
            raise ValueError(f"{path}: data CRC mismatch at {pos}")
        out.append(data)
        pos += 16 + n
    return out


def read_scalars(path: str) -> list[tuple[str, int, float]]:
    """(tag, step, value) of every simple_value scalar of an event
    file, in file order."""
    out = []
    for rec in read_records(path):
        step, summary = 0, None
        for field, _, value in _fields(rec):
            if field == 2:
                step = value
            elif field == 5:
                summary = value
        if summary is None:
            continue
        for field, _, value in _fields(summary):
            if field != 1:
                continue
            tag, scalar = None, None
            for f, _, v in _fields(value):
                if f == 1:
                    tag = v.decode()
                elif f == 2:
                    scalar = struct.unpack("<f", v)[0]
            if tag is not None and scalar is not None:
                out.append((tag, step, scalar))
    return out
