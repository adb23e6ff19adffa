"""Depth-bounded inference pipeline: enqueue batch k+1 before fetching k.

Counterpart of ``cyclegan_tpu/utils/pipeline.py``. PyTorch launches CUDA
work asynchronously, so a prediction returns while the device still
computes; holding the device tensor and fetching it only after the next
batch is enqueued lets the card compute batch k+1 while the host writes
batch k's PNGs. Results are consumed strictly in submission order, so the
output equals the serial loop's; only the fetch point moves. The fetch is
``.cpu()``, which waits for that tensor alone; there is no per-batch
``synchronize``.

The depth (the most device results in flight) defaults to
``CYCLEGAN_TPU_INFER_DEPTH`` (1 when unset; 0 fetches each result as soon
as it is enqueued).
"""

from __future__ import annotations

import os
from typing import Any, Callable

import numpy as np
import torch


def infer_depth() -> int:
    """The configured pipeline depth (``CYCLEGAN_TPU_INFER_DEPTH``, default 1)."""
    return max(0, int(os.environ.get("CYCLEGAN_TPU_INFER_DEPTH", "1")))


class InferencePipeline:
    """Order-preserving bounded queue of in-flight device results.

    ``put(payload, device_result)`` enqueues a device tensor with its
    host-side payload; whenever more than ``depth`` results are pending the
    oldest is fetched to a numpy array and handed to
    ``consume(payload, fetched)``. ``flush()`` drains everything. ``depth``
    None means :func:`infer_depth`.
    """

    def __init__(self, consume: Callable[[Any, np.ndarray], None],
                 depth: int | None = None) -> None:
        self._consume = consume
        self.depth = infer_depth() if depth is None else max(0, depth)
        self._pending: list[tuple[Any, torch.Tensor]] = []

    def put(self, payload: Any, device_result: torch.Tensor) -> None:
        self._pending.append((payload, device_result))
        self._drain(self.depth)

    def flush(self) -> None:
        self._drain(0)

    def _drain(self, limit: int) -> None:
        while len(self._pending) > limit:
            payload, dev = self._pending.pop(0)
            self._consume(payload, dev.cpu().numpy())
