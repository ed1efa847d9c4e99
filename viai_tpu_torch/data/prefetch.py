"""Host→device prefetch of batches.

Port of `viai_tpu/data/prefetch.py::device_prefetch`. On a card, each
host batch is staged in pinned memory and copied on a side CUDA stream
`depth` batches ahead of the one the caller is using; the caller's
stream waits on the copy's event before a batch is handed over, and
each tensor is recorded on that stream, so the allocator does not reuse
its memory while the step that reads it may still run. On the CPU the
batches are tensors as they are.
"""

from __future__ import annotations

import collections
import typing as tp

import numpy as np
import torch


def _host(x) -> torch.Tensor:
    t = x if torch.is_tensor(x) else torch.from_numpy(
        np.asarray(x, np.float32))
    return t if t.is_pinned() else t.pin_memory()


def device_prefetch(iterator: tp.Iterable[dict],
                    device: str | torch.device,
                    depth: int = 2) -> tp.Iterator[dict]:
    """Yield the batches of `iterator` (dicts of arrays or tensors) as
    dicts of tensors on `device`, copied `depth` batches ahead."""
    device = torch.device(device)
    it = iter(iterator)
    if device.type != "cuda":
        for batch in it:
            yield {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
        return
    stream = torch.cuda.Stream(device)
    ahead: collections.deque = collections.deque()

    def put(batch):
        with torch.cuda.stream(stream):
            out = {k: _host(v).to(device, non_blocking=True)
                   for k, v in batch.items()}
            done = torch.cuda.Event()
            done.record(stream)
        return out, done

    for batch in it:
        ahead.append(put(batch))
        if len(ahead) >= depth:
            break
    while ahead:
        out, done = ahead.popleft()
        nxt = next(it, None)
        if nxt is not None:
            ahead.append(put(nxt))
        current = torch.cuda.current_stream(device)
        current.wait_event(done)
        for v in out.values():
            v.record_stream(current)
        yield out
