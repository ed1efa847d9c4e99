"""The port's TensorBoard event files against TensorBoard and the JAX
package's clu writer.

  * CRC-32C (Castagnoli) of b"123456789" is 0xE3069283, and the TFRecord
    mask equals tensorboard's `masked_crc32c` on any bytes;
  * `Visualizer(tensorboard=True)` of the port and of viai_tpu (clu over
    tf.summary), fed the same loss dicts, give the same (tag, step,
    value) triples read back with tensorboard's EventAccumulator (which
    migrates simple_value scalars to tensors), values equal as float32;
  * `read_scalars` reads a file tensorboard's own EventFileWriter wrote,
    and raises on a flipped byte of a record's length, its data or
    either CRC.
"""

import os

import numpy as np
import pytest
from tensorboard.backend.event_processing import event_file_loader
from tensorboard.backend.event_processing import plugin_event_accumulator
from tensorboard.compat.proto.event_pb2 import Event
from tensorboard.compat.proto.summary_pb2 import Summary
from tensorboard.summary.writer.event_file_writer import EventFileWriter
from tensorboard.summary.writer.record_writer import masked_crc32c as tb_crc
from tensorboard.util import tensor_util

from viai_tpu.utils.visualizer import Visualizer as JVisualizer
from viai_tpu_torch.utils.tensorboard import (SummaryWriter, crc32c,
                                              masked_crc32c, read_scalars)
from viai_tpu_torch.utils.visualizer import Visualizer

LOSSES = [{"loss_G": 1.25, "loss_D": 0.5, "loss_G_L1": 0.0312},
          {"loss_G": 1.0, "loss_D": 0.625, "loss_G_L1": 0.0299},
          {"loss_G": 0.875, "loss_D": 0.7, "loss_G_L1": 1e-7}]


def test_crc32c_known_value_and_tensorboard_mask():
    assert crc32c(b"123456789") == 0xE3069283
    assert crc32c(b"") == 0
    rng = np.random.default_rng(0)
    for n in (0, 1, 8, 12, 1000):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert masked_crc32c(data) == tb_crc(data)


def _triples(logdir) -> list[tuple[str, int, np.float32]]:
    acc = plugin_event_accumulator.EventAccumulator(str(logdir))
    acc.Reload()
    return sorted((tag, ev.step,
                   np.float32(tensor_util.make_ndarray(ev.tensor_proto)))
                  for tag in acc.Tags()["tensors"]
                  for ev in acc.Tensors(tag))


def test_visualizer_scalars_match_jax_writer(tmp_path):
    ours = Visualizer(str(tmp_path / "port"), "t", tensorboard=True)
    ref = JVisualizer(str(tmp_path / "jax"), "t", tensorboard=True)
    assert ref._tb is not None            # clu and tensorflow installed
    for i, losses in enumerate(LOSSES):
        ours.print_current_losses(1, i, losses, 0.1)
        ref.print_current_losses(1, i, losses, 0.1)
    ref._tb.close()
    got, want = _triples(tmp_path / "port" / "tb"), _triples(
        tmp_path / "jax" / "tb")
    assert len(got) == 3 * len(LOSSES)
    assert got == want
    (name,) = os.listdir(tmp_path / "port" / "tb")
    assert name.startswith("events.out.tfevents.")
    assert sorted(read_scalars(str(tmp_path / "port" / "tb" / name))) == [
        (tag, step, float(np.float32(v))) for tag, step, v in want]


def test_writer_events_read_by_tensorboard(tmp_path):
    w = SummaryWriter(str(tmp_path))
    w.write_scalars(3, {"a": 1.5, "b": -2.25})
    w.close()
    events = list(event_file_loader.LegacyEventFileLoader(w.path).Load())
    assert events[0].file_version == "brain.Event:2"
    assert events[1].step == 3
    assert [(v.tag, v.simple_value) for v in events[1].summary.value] == [
        ("a", 1.5), ("b", -2.25)]


def _tensorboard_file(logdir) -> str:
    w = EventFileWriter(str(logdir))
    for step, vals in enumerate(LOSSES, start=1):
        w.add_event(Event(step=step, wall_time=1.0, summary=Summary(value=[
            Summary.Value(tag=k, simple_value=v) for k, v in vals.items()])))
    w.close()
    (name,) = os.listdir(logdir)
    return os.path.join(logdir, name)


def test_read_scalars_reads_a_tensorboard_file(tmp_path):
    path = _tensorboard_file(tmp_path)
    assert read_scalars(path) == [
        (k, step, float(np.float32(v)))
        for step, vals in enumerate(LOSSES, start=1) for k, v in vals.items()]


# Offsets into the second record (the first is file_version): its length,
# the length's CRC, its data, the data's CRC (the record's last byte).
@pytest.mark.parametrize("where", ["length", "length_crc", "data", "data_crc"])
def test_read_scalars_raises_on_a_flipped_byte(tmp_path, where):
    path = _tensorboard_file(tmp_path)
    with open(path, "rb") as f:
        buf = bytearray(f.read())
    first = 16 + int.from_bytes(buf[:8], "little")
    n = int.from_bytes(buf[first:first + 8], "little")
    pos = {"length": first, "length_crc": first + 9, "data": first + 14,
           "data_crc": first + 15 + n}[where]
    buf[pos] ^= 0x40
    with open(path, "wb") as f:
        f.write(bytes(buf))
    with pytest.raises(ValueError):
        read_scalars(path)
