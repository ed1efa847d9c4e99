"""ImagePool — the fake-spectrogram history buffer for D, in PyTorch.

Port of `viai_tpu/train/pool.py`. The pool keeps the last `pool_size`
fake D inputs on the device: while it fills, each fake is stored and
returned as-is; once full, each fake is with p = 0.5 swapped for a
random stored one (which it replaces), else returned untouched.

The draw (`draw_pool`, from a torch.Generator) is split from the pure
update (`query_pool`), so the update can be fed another package's
draws. Items keep D's input layout, NCHW (C, n_bins, image_frames);
the JAX package keeps NHWC.
"""

from __future__ import annotations

import torch


def init_pool(pool_size: int, item_shape: tuple[int, ...],
              device: str | torch.device = "cpu") -> dict:
    """Pool state: the buffer and the count of filled slots."""
    return {
        "buf": torch.zeros((pool_size, *item_shape), device=device),
        "n": 0,
    }


def draw_pool(generator: torch.Generator, batch: int, pool_size: int):
    """(swap (B,) bool, rand_idx (B,) int64) on the generator's device."""
    dev = generator.device
    swap = torch.rand(batch, generator=generator, device=dev) < 0.5
    rand_idx = torch.randint(0, pool_size, (batch,), generator=generator,
                             device=dev)
    return swap, rand_idx


def query_pool(pool: dict, fakes: torch.Tensor, swap: torch.Tensor,
               rand_idx: torch.Tensor):
    """(pool, (B, ...) fakes, draws) → (new pool, (B, ...) D images).

    Item b fills slot n + b while the pool is filling; once full it
    reads slot rand_idx[b] when swap[b], and writes its fake there.
    Reads see the pool before this batch's writes; of two writes to one
    slot the later item's wins.
    """
    buf = pool["buf"]
    size, batch, dev = buf.shape[0], fakes.shape[0], buf.device
    swap, rand_idx = swap.to(dev), rand_idx.to(dev)
    fill_idx = pool["n"] + torch.arange(batch, device=dev)
    filling = fill_idx < size
    tgt = torch.where(filling, fill_idx.clamp(max=size - 1),
                      torch.where(swap, rand_idx, size))
    use_old = (~filling & swap).view(-1, *(1,) * (fakes.dim() - 1))
    out = torch.where(use_old, buf[rand_idx.clamp(0, size - 1)], fakes)
    # Writes: in range, and not overwritten by a later item of the batch.
    # The others go to a spare row past the end, which is dropped; so
    # the written slots are distinct and the device never waits on a
    # data-dependent count.
    later = torch.triu(tgt[:, None] == tgt[None, :], diagonal=1).any(dim=1)
    dest = torch.where((tgt < size) & ~later, tgt, size)
    ext = torch.cat([buf, buf.new_zeros((1, *buf.shape[1:]))])
    ext.index_copy_(0, dest, fakes.to(buf.dtype))
    return {"buf": ext[:size], "n": min(pool["n"] + batch, size)}, out
