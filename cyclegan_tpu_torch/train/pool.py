"""Image-pool replay (reference ``utils.Sample_from_Pool``).

Counterpart of ``cyclegan_tpu/train/pool.py``. Per incoming fake image:
while the pool holds fewer than ``max_size`` items, store it and return it;
once full, with p = 0.5 return it untouched, else swap it with a uniformly
drawn stored image (return the old one, store the new one). Items of a
batch go through one after another.

The buffer lives on the device in the compute type; unlike the JAX
package's functional ring buffer it is updated in place (one slot write per
item, no copy of the pool). The count and the decisions live on the host,
so a query makes no device round trip when the decisions come from a CPU
``torch.Generator``.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch


class PoolState(NamedTuple):
    buffer: torch.Tensor  # (max_size, H, W, C), on the device
    count: int            # valid items


def init_pool(max_size: int, item_shape: Sequence[int], dtype: torch.dtype = torch.float32,
              device: torch.device | str = "cpu") -> PoolState:
    return PoolState(torch.zeros((max_size, *item_shape), dtype=dtype, device=device), 0)


def pool_query_with_decisions(state: PoolState, items: torch.Tensor, use_new, rand_idx
                              ) -> tuple[PoolState, torch.Tensor]:
    """Push a batch ``items`` (B, H, W, C) through the pool with the swap
    decisions supplied: ``use_new`` (B,) bool and ``rand_idx`` (B,) int, one
    (keep-new?, swap-slot) pair per item, ignored while the pool fills. The
    single source of the pool's semantics; :func:`pool_query` draws the
    decisions and delegates here. Outputs have the buffer's type."""
    buffer, count = state
    max_size = buffer.shape[0]
    items = items.to(buffer.dtype)
    outs = []
    decisions = zip(torch.as_tensor(use_new).tolist(), torch.as_tensor(rand_idx).tolist())
    for item, (keep_new, idx) in zip(items, decisions):
        if count < max_size:
            buffer[count] = item
            count += 1
            outs.append(item)
        elif keep_new:
            outs.append(item)
        else:
            outs.append(buffer[idx].clone())
            buffer[idx] = item
    return PoolState(buffer, count), torch.stack(outs)


def pool_query(state: PoolState, items: torch.Tensor, generator: torch.Generator
               ) -> tuple[PoolState, torch.Tensor]:
    """Push a batch through the pool, drawing each item's decisions from
    ``generator`` (a uniform > 0.5 for keep-new, a uniform slot). The stream
    is not the JAX package's; parity runs through injected decisions."""
    b, max_size = items.shape[0], state.buffer.shape[0]
    use_new = torch.rand((b,), generator=generator) > 0.5
    rand_idx = torch.randint(0, max_size, (b,), generator=generator)
    return pool_query_with_decisions(state, items, use_new, rand_idx)
